"""Device-mesh helpers.

The reference is a single-threaded single-host program (SURVEY.md §2);
everything here is new capability. One 1-D mesh axis ("dp") shards
the N training rows — the GP analogue of data parallelism; the N x N
kernel matrix is row-sharded over it. The mesh follows the algorithm
alone: the cards of one host reach each other at the same rate, so no
device layout is implied.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROW_AXIS = "dp"


def make_mesh(n_devices: Optional[int] = None, axis: str = ROW_AXIS) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(np.array(devs[:n]), (axis,))


def row_sharding(mesh: Mesh, ndim: int = 2, axis: str = ROW_AXIS):
    spec = [axis] + [None] * (ndim - 1)
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, P())


def pad_rows(n: int, n_devices: int, block: int) -> int:
    """Rows must tile evenly into (devices x blocks); pad with identity
    rows (unit diagonal, zero elsewhere, zero target) which leave the
    Cholesky, logdet and solves of A = K + sn2 I unchanged."""
    q = n_devices * block
    return ((n + q - 1) // q) * q

"""Multi-process initialization helpers.

Collectives go through jax.lax once `jax.distributed` has stitched the
processes together; XLA hands them to NCCL on GPUs (SURVEY.md §5
"communication backend": there is no transport layer to manage here).
These helpers wrap the boot sequence so the CLI and training scripts
stay one-liners.

Run ONE process per host, driving all of that host's cards: a JAX
process reserves most of every card it can see when it first uses it,
so a second process on the same host fails for want of memory.

Sharding guidance: keep the kernel row axis ("dp") within a host, where
the per-step all-gathers of the block-Cholesky panels ride the fast
links; put independent work — HMC chains, ensemble members — on the
cross-host axis, where only rare, small reductions cross hosts.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize with env-var fallbacks
    (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID); no-op when
    single-process. The process drives every local device (one
    process per host)."""
    addr = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if addr is None:
        return
    # NOTE: `process_id or env[...]` would be wrong — process 0 is
    # falsy and must not fall through to the env var
    if num_processes is None:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["PROCESS_ID"])
    jax.distributed.initialize(
        coordinator_address=addr,
        num_processes=num_processes,
        process_id=process_id,
    )


def two_level_mesh(rows_per_host: Optional[int] = None,
                   row_axis: str = "dp",
                   chain_axis: str = "chains") -> Mesh:
    """(chains, dp) mesh: the data/kernel axis spans each host's local
    devices, the chain/ensemble axis spans hosts."""
    devs = np.array(jax.devices())
    n_local = rows_per_host or jax.local_device_count()
    n_hosts = devs.size // n_local
    grid = devs.reshape(n_hosts, n_local)
    return Mesh(grid, (chain_axis, row_axis))

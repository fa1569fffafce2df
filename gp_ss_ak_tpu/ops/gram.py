"""Plain-XLA Gram build for the flagship ExpAns+Bias kernel.

The flagship model (Sum([ExpAns, Bias]) + Gaussian noise, the CLI
default, gp_ss_ak.cpp:146-190) reduces, after a metric map of the
points (`mapped_points`), to

    A = sigma^2 exp(-||xm_i - xm_j||) + bias [+ sn2 I].

With d <= 4 the squared distance is d FMAs per entry, so it is written
as a broadcast difference rather than the Gram expansion
|a|^2 + |b|^2 - 2 a.b: XLA compiles the whole tile into one loop fusion
that reads the points once and writes the output once, which is the
byte floor for a materialized Gram, and no matrix product (nor its
float32 precision mode) is involved. The difference form also has no
cancellation, so d2 is exactly 0 wherever two points coincide.

One tile function serves every materialized build: the chol/gemm
operator modes (inference/iterative.py), the dense serving operator
(ops/matvec.MaterializedOperator) and the ring/panel tiles
(parallel/ring.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gp_ss_ak_tpu.kernels.anisotropic import ExpAns
from gp_ss_ak_tpu.kernels.composite import Sum
from gp_ss_ak_tpu.kernels.distance import pad_to_3d
from gp_ss_ak_tpu.kernels.simple import Bias


def _is_flagship(kernel) -> bool:
    return (isinstance(kernel, Sum) and len(kernel.children) == 2
            and isinstance(kernel.children[0], ExpAns)
            and isinstance(kernel.children[1], Bias))


def mapped_points(expans: ExpAns, params, X):
    """Recentre + metric-map X so Euclidean distance equals the
    reference's MahaDist (Kernel.cpp:1391-1427)."""
    Xp = pad_to_3d(X)
    c = jnp.mean(Xp, axis=0)
    M = expans.metric(params, Xp.shape[-1])
    return jnp.matmul(Xp - c, M, precision=jax.lax.Precision.HIGHEST)


def sqdist(Xr, Xc):
    """||xr_i - xc_j||^2 as a broadcast difference, (rows, cols)."""
    diff = Xr[:, None, :] - Xc[None, :, :]
    return jnp.sum(diff * diff, axis=-1)


def expans_bias_tile(Xr, Xc, sigma, bias, gr=None, gc=None, mask=None):
    """One (rows, cols) tile of K = sigma^2 exp(-||xr - xc||) + bias.

    When the global ids gr/gc are given, diagonal entries are exactly
    sigma^2 + bias WITHOUT touching sqrt(0): d sqrt(d2)/d d2 is
    infinite at d2 = 0, so differentiating the tile build would NaN
    the metric parameters otherwise (the reference's 0/0 dodge,
    Kernel.cpp:670-672). `mask` (True = keep) is also applied before
    the sqrt: padding rows all map to one point, so masked-out entries
    can sit exactly at d2 = 0 off the diagonal, and a post-hoc zeroing
    would still propagate 0 * inf = NaN through the cotangent."""
    d2 = sqdist(Xr, Xc)
    if gr is None:
        return sigma * sigma * jnp.exp(-jnp.sqrt(d2)) + bias
    on_diag = gr[:, None] == gc[None, :]
    safe = on_diag if mask is None else (on_diag | ~mask)
    r = jnp.sqrt(jnp.where(safe, 1.0, d2))
    k = sigma * sigma * jnp.where(on_diag, 1.0, jnp.exp(-r)) + bias
    return k if mask is None else jnp.where(mask, k, 0.0)


def expans_bias_gram(Xm, sigma, bias, sn2=None, Xm2=None):
    """A = sigma^2 exp(-||xi - xj||) + bias [+ sn2 I] over mapped
    points (n, d). Pass Xm2 for a cross Gram (no diagonal terms)."""
    if Xm2 is not None:
        return expans_bias_tile(Xm, Xm2, sigma, bias)
    ids = jnp.arange(Xm.shape[0])
    K = expans_bias_tile(Xm, Xm, sigma, bias, gr=ids, gc=ids)
    if sn2 is None:
        return K
    return K + jnp.where(ids[:, None] == ids[None, :], sn2, 0.0)

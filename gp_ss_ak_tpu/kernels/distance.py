"""Pairwise-distance engines.

Re-design of the reference distance functions
(`EuclDist` Kernel.cpp:1343-1368, `MahaDist` Kernel.cpp:1370-1435,
`mlA` Kernel.cpp:1437-1441): recentre both point sets by their combined
mean (numerical conditioning only — distances are translation
invariant), optionally map through an anisotropic metric, then use the
Gram expansion ||a||^2 + ||b||^2 - 2 a.b with a clamp of tiny negative
values to zero.

All functions are pure and jit/vmap/grad-safe. The O(N^2) Gram
expansion maps onto one matmul; the flagship model's materialized and
streamed builds (`gp_ss_ak_tpu.ops.gram`, `gp_ss_ak_tpu.ops.matvec`)
compute the same quantity as a broadcast difference instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _recentre(X1: jnp.ndarray, X2: jnp.ndarray):
    """Subtract the combined mean of the stacked point sets from both.

    Mirrors the conditioning trick at Kernel.cpp:1354-1360 /
    1391-1397: m = (sum(X1) + sum(X2)) / (n + m) is removed from every
    point. Distances are unchanged in exact arithmetic; in float this
    keeps the Gram expansion well-conditioned when coordinates have a
    large common offset (e.g. UTM mining coordinates).
    """
    n = X1.shape[0]
    m = X2.shape[0]
    c = (jnp.sum(X1, axis=0) + jnp.sum(X2, axis=0)) / (n + m)
    return X1 - c, X2 - c


def gram_sqdist(A1: jnp.ndarray, A2: jnp.ndarray,
                same: bool = False) -> jnp.ndarray:
    """||a_i - b_j||^2 for every pair via the Gram expansion, clamped >= 0.

    The -2 A1 A2^T term is one matrix product; the clamp mirrors
    Kernel.cpp:1366-1367 (float cancellation can give tiny negatives).
    With ``same=True`` (X1 is X2) the diagonal is set to exactly zero:
    the Gram expansion leaves O(eps) round-off there, which sits on the
    kink of the downstream sqrt — zeroing it is exact and keeps both
    values and jax.grad clean.
    """
    s1 = jnp.sum(A1 * A1, axis=-1, keepdims=True)  # (n, 1)
    s2 = jnp.sum(A2 * A2, axis=-1, keepdims=True)  # (m, 1)
    # full-f32 precision: a reduced-precision product (TF32 on a GPU)
    # loses ~1e-3 relative here, enough to make the Gram matrix
    # indefinite and every downstream Cholesky NaN. d is tiny (3-4), so
    # the cost of the full-precision product is negligible.
    cross = jnp.matmul(A1, A2.T, precision=jax.lax.Precision.HIGHEST)
    d2 = s1 + s2.T - 2.0 * cross
    d2 = jnp.maximum(d2, 0.0)
    if same:
        n, m = d2.shape
        eye = jnp.eye(n, m, dtype=bool)
        d2 = jnp.where(eye, 0.0, d2)
    return d2


def sq_euclidean(X1: jnp.ndarray, X2: jnp.ndarray, hyp,
                 same: bool = False) -> jnp.ndarray:
    """Scaled squared Euclidean distance, hyp^-2 * ||x - y||^2.

    Reference: `EuclDist` (Kernel.cpp:1343-1368) scales by
    exp(-2 log hyp) = hyp^-2 through `mlA` and applies the scale to one
    factor of each product, so every term of the Gram expansion carries
    exactly one hyp^-2 factor.
    """
    X1c, X2c = _recentre(X1, X2)
    scale = jnp.exp(-2.0 * jnp.log(hyp))
    return scale * gram_sqdist(X1c, X2c, same)


def rotation_matrix_3d(alpha, beta, theta, dtype=None) -> jnp.ndarray:
    """The reference's 3-D rotation R(alpha, beta, theta).

    Element-for-element the matrix of Kernel.cpp:1402-1410 (a ZXZ-like
    Euler composition; the exact convention is what matters for parity,
    not its name).
    """
    ca, sa = jnp.cos(alpha), jnp.sin(alpha)
    cb, sb = jnp.cos(beta), jnp.sin(beta)
    ct, st = jnp.cos(theta), jnp.sin(theta)
    R = jnp.stack(
        [
            jnp.stack([ca * ct + sa * sb * st, -sa * ct + ca * sb * st, -cb * st]),
            jnp.stack([sa * cb, ca * cb, sb]),
            jnp.stack([ca * st - sa * sb * ct, -sa * st - ca * sb * ct, cb * ct]),
        ]
    )
    if dtype is not None:
        R = R.astype(dtype)
    return R


def anisotropic_metric(params: dict, input_dim: int) -> jnp.ndarray:
    """M = R diag(lambda) R^T for the ExpAns kernel.

    Reference: `MahaDist` builds sigInv = Rot * lambda * Rot^T and maps
    both point sets through it (Kernel.cpp:1425-1427), so the effective
    metric on distances is M^2 = R lambda^2 R^T.

    Dimension handling (a deliberate generalization — the reference
    only supports d in {3, 4}, Kernel.cpp:865-878):
      d <= 3 : inputs are zero-padded to 3 columns upstream; full 3-D
               rotation applies (this is what makes the 1-D synthetic
               config work at all).
      d == 4 : rock-type dimension gets lambda_3 = InversewidthR and an
               identity rotation block (Kernel.cpp:1411-1424).
      d > 4  : every extra dimension reuses InversewidthR with identity
               rotation (new capability).
    """
    d = max(int(input_dim), 3)
    dtype = jnp.result_type(params["AngleX"])
    R3 = rotation_matrix_3d(params["AngleX"], params["AngleY"], params["AngleZ"], dtype)
    lam3 = jnp.stack(
        [params["inverseWidthx"], params["inverseWidthy"], params["inverseWidthz"]]
    ).astype(dtype)
    M3 = jnp.matmul(R3 * lam3[None, :], R3.T,
                    precision=jax.lax.Precision.HIGHEST)
    if d == 3:
        return M3
    M = jnp.zeros((d, d), dtype)
    M = M.at[:3, :3].set(M3)
    extra = jnp.arange(3, d)
    M = M.at[extra, extra].set(params["inversewidthR"].astype(dtype))
    return M


def sq_mahalanobis(X1: jnp.ndarray, X2: jnp.ndarray, M: jnp.ndarray,
                   same: bool = False) -> jnp.ndarray:
    """Squared distance after mapping both sets through M (so metric M^2).

    Reference: `MahaDist` Kernel.cpp:1425-1434.
    """
    X1c, X2c = _recentre(X1, X2)
    # full f32: in TF32 the map's ~1e-3 rounding depends on the centre,
    # so row blocks mapped on different devices disagree and the
    # assembled Gram matrix is no longer positive definite
    A1 = jnp.matmul(X1c, M, precision=jax.lax.Precision.HIGHEST)
    A2 = jnp.matmul(X2c, M, precision=jax.lax.Precision.HIGHEST)
    return gram_sqdist(A1, A2, same)


def pad_to_3d(X: jnp.ndarray) -> jnp.ndarray:
    """Zero-pad trailing columns so the 3-D rotation metric applies to d < 3."""
    d = X.shape[-1]
    if d >= 3:
        return X
    pad = [(0, 0)] * (X.ndim - 1) + [(0, 3 - d)]
    return jnp.pad(X, pad)


def safe_sqrt(x: jnp.ndarray) -> jnp.ndarray:
    """sqrt with a zero gradient at x == 0.

    The exponential-family kernels differentiate k = s^2 exp(-sqrt(d2))
    through d2 = 0 on the Gram diagonal; the reference zeroes the
    diagonal of dk/d(d2) to dodge the 0/0 (Kernel.cpp:670-672). The
    double-where pattern gives jax.grad exactly that behavior.
    """
    positive = x > 0
    guarded = jnp.where(positive, x, 1.0)
    return jnp.where(positive, jnp.sqrt(guarded), 0.0)

"""Distributed block Cholesky + triangular solves over a 1-D device mesh.

The scale-out heart of the framework (SURVEY.md §2 "Distributed block
Cholesky"; no reference counterpart — GP_SS_AK calls arma::chol on one
core, GP_Utils.cpp:872-915). Layout: the padded N x N matrix is sharded
by CONTIGUOUS ROW BLOCKS over mesh axis "dp"; every function here is
the per-device body to run under jax.shard_map.

Right-looking algorithm per block-column j (block size nb):
  1. the diagonal block K[j,j] reaches every device via a masked psum
     (owner contributes, others zero) and all devices redundantly
     factor the tiny nb x nb block — cheaper than a broadcast tree;
  2. each device right-solves its local panel rows against D^T;
  3. one all-gather assembles the full column block L[:, j] (the only
     O(N nb) communication per step);
  4. the trailing update K -= L_panel @ L_col^T is a local matmul,
     masked to untouched columns; the panel overwrites K's column
     block in place, so L materializes inside the K buffer.

The forward/backward substitutions follow the same pattern (masked
psum of the diagonal block + local matmul updates); the backward sweep
additionally broadcasts the owner's row block of L.

All matmuls force full-f32 precision (a TF32 product keeps about three
decimal digits, which breaks positive-definiteness).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from gp_ss_ak_tpu.parallel.mesh import ROW_AXIS


from gp_ss_ak_tpu.utils.vma import pvary_like as _pvary_like

_PREC = lax.Precision.HIGHEST


def _globals(n_local: int, axis: str):
    p = lax.axis_index(axis)
    return p, p * n_local + jnp.arange(n_local)


def _bcast_from_owner(value, is_owner, axis):
    """All devices receive the owner's `value` (masked psum broadcast)."""
    contrib = jnp.where(is_owner, value, jnp.zeros_like(value))
    return lax.psum(contrib, axis)


def block_cholesky_local(A_local: jnp.ndarray, nb: int,
                         axis: str = ROW_AXIS):
    """Per-device body: factor row-sharded A into L (lower, in-place
    layout). Returns (L_local, half_logdet) with half_logdet replicated.
    Requires N % nb == 0 and n_local % nb == 0 (pad upstream,
    parallel/mesh.py pad_rows)."""
    n_local, N = A_local.shape
    n_blocks = N // nb
    p, g = _globals(n_local, axis)
    cols = jnp.arange(N)

    def body(j, K):
        jb = j * nb
        owner = jb // n_local
        off = jnp.clip(jb - owner * n_local, 0, n_local - nb)
        is_owner = jnp.equal(p, owner)

        blk = lax.dynamic_slice(K, (off, jb), (nb, nb))
        Kjj = _bcast_from_owner(blk, is_owner, axis)
        D = jnp.linalg.cholesky(Kjj)

        C = lax.dynamic_slice(K, (0, jb), (n_local, nb))
        # panel rows below the block: X D^T = C  ->  X = C D^-T
        Lp = lax.linalg.triangular_solve(D, C, left_side=False, lower=True,
                                         transpose_a=True)
        row_pos = g - jb
        in_block = (row_pos >= 0) & (row_pos < nb)
        below = g >= jb + nb
        Drows = D[jnp.clip(row_pos, 0, nb - 1), :]
        Lp = jnp.where(below[:, None], Lp,
                       jnp.where(in_block[:, None], Drows, 0.0))

        Lcol = lax.all_gather(Lp, axis, tiled=True)          # (N, nb)
        upd = jnp.matmul(Lp, Lcol.T, precision=_PREC)        # (n_local, N)
        colmask = (cols >= jb + nb)[None, :]
        K = K - jnp.where(colmask, upd, 0.0)
        K = lax.dynamic_update_slice(K, Lp, (0, jb))
        return K

    L = lax.fori_loop(0, n_blocks, body, A_local)
    L = jnp.where(cols[None, :] <= g[:, None], L, 0.0)
    diag = L[jnp.arange(n_local), g]
    half_logdet = lax.psum(jnp.sum(jnp.log(diag)), axis)
    return L, half_logdet


def tri_solve_lower_local(L_local: jnp.ndarray, B_local: jnp.ndarray,
                          nb: int, axis: str = ROW_AXIS) -> jnp.ndarray:
    """Forward substitution L Z = B, everything row-sharded."""
    n_local, N = L_local.shape
    M = B_local.shape[1]
    n_blocks = N // nb
    p, g = _globals(n_local, axis)
    B_local = _pvary_like(B_local, L_local)

    def body(j, B):
        jb = j * nb
        owner = jb // n_local
        off = jnp.clip(jb - owner * n_local, 0, n_local - nb)
        is_owner = jnp.equal(p, owner)

        Bj = _bcast_from_owner(lax.dynamic_slice(B, (off, 0), (nb, M)),
                               is_owner, axis)
        Dj = _bcast_from_owner(
            lax.dynamic_slice(L_local, (off, jb), (nb, nb)), is_owner, axis)
        Zj = lax.linalg.triangular_solve(Dj, Bj, left_side=True, lower=True)

        Lj = lax.dynamic_slice(L_local, (0, jb), (n_local, nb))
        upd = jnp.matmul(Lj, Zj, precision=_PREC)
        below = (g >= jb + nb)[:, None]
        B = B - jnp.where(below, upd, 0.0)

        row_pos = jnp.clip(g - jb, 0, nb - 1)
        in_block = ((g - jb) >= 0) & ((g - jb) < nb)
        B = jnp.where(in_block[:, None], Zj[row_pos, :], B)
        return B

    return lax.fori_loop(0, n_blocks, body, B_local)


def tri_solve_upper_local(L_local: jnp.ndarray, B_local: jnp.ndarray,
                          nb: int, axis: str = ROW_AXIS) -> jnp.ndarray:
    """Backward substitution L^T Z = B, everything row-sharded.

    Needs the owner's ROW block of L each step (columns of L^T), one
    (nb, N) broadcast — the transpose-free layout cost."""
    n_local, N = L_local.shape
    M = B_local.shape[1]
    n_blocks = N // nb
    p, g = _globals(n_local, axis)
    B_local = _pvary_like(B_local, L_local)

    def body(t, B):
        j = n_blocks - 1 - t
        jb = j * nb
        owner = jb // n_local
        off = jnp.clip(jb - owner * n_local, 0, n_local - nb)
        is_owner = jnp.equal(p, owner)

        Bj = _bcast_from_owner(lax.dynamic_slice(B, (off, 0), (nb, M)),
                               is_owner, axis)
        Dj = _bcast_from_owner(
            lax.dynamic_slice(L_local, (off, jb), (nb, nb)), is_owner, axis)
        Zj = lax.linalg.triangular_solve(Dj, Bj, left_side=True, lower=True,
                                         transpose_a=True)

        Lrows = _bcast_from_owner(
            lax.dynamic_slice(L_local, (off, 0), (nb, N)), is_owner, axis)
        col0 = (p * n_local).astype(jnp.int32)
        Lslice = lax.dynamic_slice(Lrows, (jnp.int32(0), col0),
                                   (nb, n_local))
        upd = jnp.matmul(Lslice.T, Zj, precision=_PREC)
        above = (g < jb)[:, None]
        B = B - jnp.where(above, upd, 0.0)

        row_pos = jnp.clip(g - jb, 0, nb - 1)
        in_block = ((g - jb) >= 0) & ((g - jb) < nb)
        B = jnp.where(in_block[:, None], Zj[row_pos, :], B)
        return B

    return lax.fori_loop(0, n_blocks, body, B_local)


def solve_chol_local(L_local, B_local, nb, axis: str = ROW_AXIS):
    """A^-1 B = L^-T (L^-1 B) — the distributed `solve_chol`
    (GP_Utils.cpp:841-845 equivalence)."""
    Z = tri_solve_lower_local(L_local, B_local, nb, axis)
    return tri_solve_upper_local(L_local, Z, nb, axis)

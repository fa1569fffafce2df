"""Ring-rotation distributed Gram matvec + CG — the long-context
analogue (SURVEY.md §5): structurally ring attention, with the N x N
kernel matrix in the role of the attention matrix.

The exact-NLML pipeline (parallel/nlml.py) materializes each device's
(n_local, N) ROW PANEL of A. At N ~ 10^5-10^6 even the panel is too
big (100k x 1M f32 = 400 GB/device at P=10). Here NOTHING bigger than
an (n_local, n_local) tile ever exists:

  each device holds an X block and a v block; blocks rotate around
  the mesh ring via lax.ppermute; at each of the P steps a device
  computes one tile K(X_local, X_visiting) @ v_visiting and
  accumulates — compute overlaps with the transfer of the next
  block, exactly the ring-attention schedule.

Built for the flagship Sum([ExpAns, Bias]) + Gaussian model (the same
restriction as the single-chip matrix-free engine,
optim/iterative_fit.py): A = sigma^2 exp(-||xm_i - xm_j||) + bias
+ sn2 I over metric-mapped points. Padding rows act as identity rows
(A_pad = blockdiag(A, I)), so CG and solves ignore them.

Reference surface being scaled: the mvmK hot path
(GP_Utils.cpp:180-227, 394) and posterior solves (GP_Utils.cpp:943-1004).
"""

from __future__ import annotations

import math
from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from gp_ss_ak_tpu.ops.gram import _is_flagship, expans_bias_tile as _tile
from gp_ss_ak_tpu.parallel.mesh import ROW_AXIS

_PREC = lax.Precision.HIGHEST


def _ring_perm(P_sz: int):
    # send to the next device, receive from the previous
    return [(i, (i + 1) % P_sz) for i in range(P_sz)]


def _mapped_local(kernel, params, X_local, n, axis):
    """Metric-map the LOCAL block with a globally consistent centre
    (mean over the true rows, psum-reduced — every device computes the
    same c, so cross-block distances agree)."""
    from gp_ss_ak_tpu.kernels.distance import pad_to_3d

    ep, _bp = params
    expans = kernel.children[0]
    Xp = pad_to_3d(X_local)
    n_local = Xp.shape[0]
    p = lax.axis_index(axis)
    g = p * n_local + jnp.arange(n_local)
    valid = (g < n)[:, None]
    csum = lax.psum(jnp.sum(jnp.where(valid, Xp, 0.0), axis=0), axis)
    c = csum / n
    M = expans.metric(ep, Xp.shape[-1])
    Xm = jnp.matmul(Xp - c, M, precision=_PREC)
    return Xm, g, valid[:, 0]


def make_ring_matvec(kernel, mesh: Mesh, n: int, n_devices: int = None,
                     axis: str = ROW_AXIS) -> Callable:
    """Returns jitted (flat, X_pad, v_pad) -> A v (row-sharded), where
    A = K + sn2 I with identity padding rows and K never exists —
    not even as a row panel."""
    if not _is_flagship(kernel):
        raise ValueError("ring matvec supports the flagship "
                         "Sum([ExpAns, Bias]) kernel only")
    P_sz = n_devices or len(mesh.devices)
    nk = kernel.n_params

    def body(flat, X_local, v_local):
        params = kernel.unpack(flat[:nk])
        ep, bp = params
        sn2 = flat[nk]
        sigma, bias = ep["Sigma"], bp["Sigma"]
        Xm, g, row_valid = _mapped_local(kernel, params, X_local, n, axis)
        n_local = Xm.shape[0]
        p = lax.axis_index(axis)

        vz = jnp.where((g < n), v_local, 0.0)
        q0 = jnp.zeros_like(v_local)
        perm = _ring_perm(P_sz)

        def step(k, carry):
            Xb, vb, src, q = carry
            # the visiting block's global column ids
            gc = src * n_local + jnp.arange(n_local)
            Kt = _tile(Xm, Xb, sigma, bias)
            Kt = jnp.where(row_valid[:, None] & (gc < n)[None, :], Kt, 0.0)
            q = q + jnp.matmul(Kt, vb, precision=_PREC)
            Xb = lax.ppermute(Xb, axis, perm)
            vb = lax.ppermute(vb, axis, perm)
            src = lax.ppermute(src, axis, perm)
            return (Xb, vb, src, q)

        _, _, _, q = lax.fori_loop(0, P_sz, step, (Xm, vz, p, q0))
        # diagonal: + sn2 v on true rows, identity on padding rows
        return jnp.where(g < n, q + sn2 * v_local, v_local)

    mapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=P(axis),
    )
    return jax.jit(mapped)


def make_ring_cg_solve(kernel, mesh: Mesh, n: int, n_devices: int = None,
                       axis: str = ROW_AXIS, tol: float = 1e-6,
                       maxiter: int = 1000) -> Callable:
    """Returns jitted (flat, X_pad, b_pad) -> (x, iters, residual):
    CG on A x = b where every matvec is one ring pass and every inner
    product is a psum — the kernel matrix never exists anywhere."""
    if not _is_flagship(kernel):
        raise ValueError("ring CG supports the flagship kernel only")
    P_sz = n_devices or len(mesh.devices)
    nk = kernel.n_params

    def body(flat, X_local, b_local):
        params = kernel.unpack(flat[:nk])
        ep, bp = params
        sn2 = flat[nk]
        sigma, bias = ep["Sigma"], bp["Sigma"]
        Xm, g, row_valid = _mapped_local(kernel, params, X_local, n, axis)
        n_local = Xm.shape[0]
        p = lax.axis_index(axis)
        perm = _ring_perm(P_sz)

        def matvec(v):
            vz = jnp.where(g < n, v, 0.0)

            def step(k, carry):
                Xb, vb, src, q = carry
                gc = src * n_local + jnp.arange(n_local)
                Kt = _tile(Xm, Xb, sigma, bias)
                Kt = jnp.where(row_valid[:, None] & (gc < n)[None, :],
                               Kt, 0.0)
                q = q + jnp.matmul(Kt, vb, precision=_PREC)
                Xb = lax.ppermute(Xb, axis, perm)
                vb = lax.ppermute(vb, axis, perm)
                src = lax.ppermute(src, axis, perm)
                return (Xb, vb, src, q)

            _, _, _, q = lax.fori_loop(
                0, P_sz, step, (Xm, vz, p, jnp.zeros_like(v)))
            return jnp.where(g < n, q + sn2 * v, v)

        def pdot(a, b):
            return lax.psum(jnp.dot(a, b, precision=_PREC), axis)

        b = jnp.where(g < n, b_local, 0.0)
        x = jnp.zeros_like(b)
        r = b
        pvec = r
        rs = pdot(r, r)
        thresh = (tol ** 2) * pdot(b, b)

        def cond(state):
            _x, _r, _p, rs, it = state
            return (rs > thresh) & (it < maxiter)

        def step(state):
            x, r, pv, rs, it = state
            Ap = matvec(pv)
            alpha = rs / pdot(pv, Ap)
            x = x + alpha * pv
            r = r - alpha * Ap
            rs_new = pdot(r, r)
            pv = r + (rs_new / rs) * pv
            return (x, r, pv, rs_new, it + 1)

        x, r, _pv, rs, it = lax.while_loop(
            cond, step, (x, r, pvec, rs, jnp.zeros((), jnp.int32)))
        return x, it, jnp.sqrt(rs)

    mapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=(P(axis), P(), P()),
    )
    return jax.jit(mapped)


#: default ceiling on the materialized tile's COLUMN count: one
#: (n_local, tile_chunk) panel instead of the full (n_local, n_local)
#: tile, so per-device memory is bounded by n_local * chunk however
#: large N/P gets (an (n_local)^2 tile is 17 GB at n_local = 65536)
TILE_CHUNK = 4096


def _pick_chunk(n_local: int, want: int) -> int:
    """Largest divisor of n_local that is <= want (tile panels must
    align exactly — a clamped tail slice would double-count rows)."""
    want = min(want, n_local)
    for c in range(want, 0, -1):
        if n_local % c == 0:
            return c
    return n_local


def _ring_matmat_fn(Xm, row_valid, g, n, sigma, bias, sn2, P_sz, axis,
                    tile_chunk: int = None):
    """Blocked ring matmat closure: (n_local, B) -> (A V)_local with
    all B columns riding one rotation of the ring (the per-step tile
    build dominates, exactly like the single-chip op.matmat).

    Within each ring step the visiting block is processed in
    `tile_chunk`-column panels (lax.scan, differentiable — the
    gradient surrogate runs through this same closure), so nothing
    larger than (n_local, tile_chunk) is ever materialized."""
    n_local = Xm.shape[0]
    p = lax.axis_index(axis)
    perm = _ring_perm(P_sz)
    chunk = _pick_chunk(n_local, tile_chunk or TILE_CHUNK)
    n_chunks = n_local // chunk

    def matmat(V_local):
        Vz = jnp.where(row_valid[:, None], V_local, 0.0)

        def step(carry, _):
            Xb, Vb, src, Q = carry
            gc_base = src * n_local

            # jax.checkpoint: the gradient surrogate differentiates
            # through this scan, and without remat the backward pass
            # stacks every (n_local, chunk) Kt panel — n_chunks x
            # panel = the full tile again. Rematerializing keeps
            # backward memory at ONE panel.
            @jax.checkpoint
            def panel(Qc, ci):
                s = ci * chunk
                Xc = lax.dynamic_slice_in_dim(Xb, s, chunk, 0)
                Vc = lax.dynamic_slice_in_dim(Vb, s, chunk, 0)
                gcc = gc_base + s + jnp.arange(chunk)
                Kt = _tile(Xm, Xc, sigma, bias, gr=g, gc=gcc,
                           mask=row_valid[:, None]
                           & (gcc < n)[None, :])
                return Qc + jnp.matmul(Kt, Vc, precision=_PREC), None

            if n_chunks == 1:
                Q, _ = panel(Q, jnp.asarray(0, jnp.int32))
            else:
                Q, _ = lax.scan(panel, Q, jnp.arange(n_chunks))
            Xb = lax.ppermute(Xb, axis, perm)
            Vb = lax.ppermute(Vb, axis, perm)
            src = lax.ppermute(src, axis, perm)
            return (Xb, Vb, src, Q), None

        (_, _, _, Q), _ = lax.scan(
            step, (Xm, Vz, p, jnp.zeros_like(Vz)), None, length=P_sz)
        return jnp.where(row_valid[:, None], Q + sn2 * V_local, V_local)

    return matmat


def _ring_pivoted_chol(Xm, row_valid, g, sigma, bias, rank, n_pad,
                       axis):
    """Distributed pivoted Cholesky of K (no noise): rank greedy
    max-diagonal steps, each ONE psum'd argmax + ONE O(n_local d)
    kernel-column build — L comes back ROW-SHARDED (n_local, rank).
    The column build shards trivially (each device computes its own
    segment against the broadcast pivot point), which is why the BBMM
    preconditioner scales to the ring regime."""
    from gp_ss_ak_tpu.utils.vma import pvary_like

    s2 = sigma * sigma
    n_local = Xm.shape[0]
    d0 = jnp.where(row_valid, s2 + bias, jnp.zeros_like(row_valid,
                                                        Xm.dtype))
    # the carry becomes device-varying after step 0 (l depends on the
    # local Xm); the initial zeros must match from iteration 0
    L0 = pvary_like(jnp.zeros((n_local, rank), Xm.dtype), Xm)
    d0 = pvary_like(d0, Xm)

    def body(j, carry):
        L, dvec = carry
        local_max = jnp.max(dvec)
        gmax = lax.pmax(local_max, axis)
        # owner = the attaining device with the smallest global row id
        cand = jnp.where(local_max >= gmax,
                         g[jnp.argmax(dvec)], n_pad)
        gidx = lax.pmin(cand, axis)
        owner_row = (g == gidx)
        xi = lax.psum(jnp.sum(
            jnp.where(owner_row[:, None], Xm, 0.0), axis=0), axis)
        Li = lax.psum(jnp.sum(
            jnp.where(owner_row[:, None], L, 0.0), axis=0), axis)
        dist = jnp.sqrt(jnp.maximum(
            jnp.sum((Xm - xi[None, :]) ** 2, axis=1), 0.0))
        c = s2 * jnp.exp(-dist) + bias
        c = jnp.where(owner_row, s2 + bias, c)       # exact diagonal
        l = (c - jnp.matmul(L, Li, precision=_PREC)) \
            / jnp.sqrt(jnp.maximum(gmax, 1e-30))
        l = jnp.where((gmax > 1e-30) & row_valid, l, 0.0)
        L = L.at[:, j].set(l)
        dvec = jnp.maximum(dvec - l * l, 0.0)
        dvec = jnp.where(owner_row, 0.0, dvec)
        return L, dvec

    L, _ = lax.fori_loop(0, rank, body, (L0, d0))
    return L


GATHERED_PIVCHOL_MAX_BYTES = 2 << 30  # full-L transient budget/device


def _ring_pivoted_chol_gathered(Xm, row_valid, g, sigma, bias, rank,
                                n_pad, axis):
    """Replicated-build pivoted Cholesky: all_gather the metric-mapped
    points (n_pad x d — ~1 MB at N=10^5, trivial next to one ring
    pass) and run the SAME greedy max-diagonal recursion as the
    single-chip `inference.iterative.pivoted_cholesky` identically on
    every device, then slice the local row block.

    Why this exists: the per-step distributed build
    (`_ring_pivoted_chol`) pays one pmax + pmin + two psums of
    LATENCY-bound collectives per rank step PLUS two full masked
    (n_local, rank) array sweeps for the owner-row extraction — at
    rank ~ n/48 that serial chain of small collectives dominates the
    whole evaluation. Here each step is one argmax + one
    O(n_pad d) column + one (n_pad, rank) matvec, all local; the
    P-fold compute redundancy is irrelevant because the build was
    never sharded-compute-bound, it was latency-bound.

    Transient cost: the full (n_pad, rank) L on every device during
    the build (sliced immediately after). Callers fall back to the
    distributed build past GATHERED_PIVCHOL_MAX_BYTES.
    """
    from gp_ss_ak_tpu.utils.vma import pvary_like

    s2 = sigma * sigma
    n_local = Xm.shape[0]
    X_all = lax.all_gather(Xm, axis, tiled=True)          # (n_pad, d)
    valid_all = lax.all_gather(row_valid, axis, tiled=True)
    d0 = jnp.where(valid_all, s2 + bias, jnp.zeros((), Xm.dtype))
    d0 = pvary_like(d0, X_all)

    def column(i):
        xi = lax.dynamic_slice_in_dim(X_all, i, 1, 0)
        r = jnp.sqrt(jnp.maximum(
            jnp.sum((X_all - xi) ** 2, axis=1), 0.0))
        c = s2 * jnp.exp(-r) + bias
        return c.at[i].set(s2 + bias)                     # exact diag

    def body(j, carry):
        L, d = carry
        i = jnp.argmax(d)
        c = column(i)
        Li = jnp.take(L, i, axis=0)
        # HIGHEST is load-bearing (see inference.iterative
        # .pivoted_cholesky): bf16 matmul error inside the c - L Li
        # cancellation poisons late columns at rank >= ~512
        l = (c - jnp.matmul(L, Li, precision=_PREC)) \
            / jnp.sqrt(jnp.maximum(d[i], 1e-30))
        l = jnp.where((d[i] > 1e-30) & valid_all, l, 0.0)
        L = L.at[:, j].set(l)
        d = jnp.maximum(d - l * l, 0.0)
        d = d.at[i].set(0.0)
        return (L, d)

    L0 = pvary_like(jnp.zeros((n_pad, rank), Xm.dtype), X_all)
    L, _ = lax.fori_loop(0, rank, body, (L0, d0))
    p = lax.axis_index(axis)
    return lax.dynamic_slice(
        L, (p * n_local, jnp.zeros((), p.dtype)), (n_local, rank))


def _ring_pivchol_dispatch(Xm, row_valid, g, sigma, bias, rank, n_pad,
                           axis):
    """Gathered (replicated) build when the full-L transient fits the
    per-device budget, else the per-step distributed build."""
    if n_pad * rank * Xm.dtype.itemsize <= GATHERED_PIVCHOL_MAX_BYTES:
        return _ring_pivoted_chol_gathered(Xm, row_valid, g, sigma,
                                           bias, rank, n_pad, axis)
    return _ring_pivoted_chol(Xm, row_valid, g, sigma, bias, rank,
                              n_pad, axis)


def _ring_precond(L_local, sn2, n_true, axis):
    """Distributed Woodbury P^-1, exact P^(-1/2), and logdet P for
    P = L L^T + sn2 I over the VALID n_true-dimensional subspace —
    the k x k core (L^T L) is one psum, everything else local GEMMs
    (inference/iterative.precond_sqrt, row-sharded)."""
    k = L_local.shape[1]
    LtL = lax.psum(jnp.matmul(L_local.T, L_local, precision=_PREC),
                   axis)
    S, U = jnp.linalg.eigh(LtL)
    S = jnp.maximum(S, 0.0)
    mask = S > 1e-10
    Q_local = jnp.matmul(
        L_local, U / jnp.sqrt(jnp.maximum(S, 1e-30))[None, :],
        precision=_PREC) * mask[None, :].astype(L_local.dtype)
    inv_sqrt_eig = jnp.where(mask, 1.0 / jnp.sqrt(S + sn2), 0.0)
    rsn = 1.0 / jnp.sqrt(sn2)
    logdet_P = (n_true - jnp.sum(mask)) * jnp.log(sn2) \
        + jnp.sum(jnp.where(mask, jnp.log(S + sn2), 0.0))

    M = sn2 * jnp.eye(k, dtype=L_local.dtype) + LtL
    cho = jax.scipy.linalg.cho_factor(M, lower=True)

    def pinv(V_local):
        LtV = lax.psum(jnp.matmul(L_local.T, V_local, precision=_PREC),
                       axis)
        W = jax.scipy.linalg.cho_solve(cho, LtV)
        return (V_local - jnp.matmul(L_local, W,
                                     precision=_PREC)) / sn2

    def inv_sqrt(V_local):
        QtV = lax.psum(jnp.matmul(Q_local.T, V_local, precision=_PREC),
                       axis)
        return (V_local - jnp.matmul(Q_local, QtV,
                                     precision=_PREC)) * rsn \
            + jnp.matmul(Q_local, inv_sqrt_eig[:, None] * QtV,
                         precision=_PREC)

    return pinv, inv_sqrt, logdet_P


def _ring_bcg(matmat, B_local, pinv, tol, maxiter, axis,
              uniform_axis=None):
    """Batched PCG with psum'd inner products and the same
    best-iterate / non-finite / stall hardening as inference.iterative
    .bcg_solve (frozen columns never poison the result; a tolerance
    below the f32 floor stops at the residual plateau instead of
    spinning every device to maxiter).

    `uniform_axis`: on a two-level mesh the body's ppermutes span only
    the ROW groups, but XLA schedules the collective-permute across
    the WHOLE mesh — a chain whose CG finishes earlier would stop
    issuing it and deadlock the others at the rendezvous. The
    continue predicate is therefore OR-reduced over the chain axis:
    every chain iterates until the slowest converges (frozen columns
    make the extra iterations no-ops)."""
    from gp_ss_ak_tpu.inference.iterative import BCG_STALL_ITERS

    def psum_cols(M):
        return lax.psum(jnp.sum(M, axis=0), axis)

    X = jnp.zeros_like(B_local)
    R = B_local
    Z = pinv(R) if pinv is not None else R
    Pv = Z
    rz = psum_cols(R * Z)
    rn0 = psum_cols(B_local * B_local)
    thresh = (tol ** 2) * rn0

    def _active(R):
        rn = psum_cols(R * R)
        return (rn > thresh) & jnp.isfinite(rn)

    def cond(state):
        _X, R, _Z, _P, _rz, it, _Xb, _rb, stall = state
        cont = jnp.any(_active(R)) & (it < maxiter) \
            & (stall < BCG_STALL_ITERS)
        if uniform_axis is not None:
            cont = lax.psum(cont.astype(jnp.int32), uniform_axis) > 0
        return cont

    def body(state):
        X, R, Z, Pv, rz, it, Xbest, rn_best, stall = state
        active = _active(R)
        AP = matmat(Pv)
        pAp = psum_cols(Pv * AP)
        ok = active & (pAp > 0) & jnp.isfinite(pAp) & jnp.isfinite(rz)
        a = jnp.where(ok, rz / jnp.where(pAp > 0, pAp, 1.0), 0.0)
        X = X + a[None, :] * Pv
        R = R - a[None, :] * AP
        rn = psum_cols(R * R)
        better = jnp.isfinite(rn) & (rn < rn_best)
        Xbest = jnp.where(better[None, :], X, Xbest)
        # psum'd quantities are replicated, so every device agrees on
        # the stall count and exits the while_loop in the same step;
        # only a meaningful (0.1%) improvement resets it — noise-level
        # creep near the f32 floor must not defer the cutoff
        meaningful = better & (rn < 0.999 * rn_best)
        rn_best = jnp.where(better, rn, rn_best)
        stall = jnp.where(jnp.any(meaningful & active), 0, stall + 1)
        Z = pinv(R) if pinv is not None else R
        rz_new = psum_cols(R * Z)
        beta = jnp.where(ok, rz_new / jnp.where(rz > 0, rz, 1.0), 0.0)
        Pv = Z + beta[None, :] * Pv
        return X, R, Z, Pv, rz_new, it + 1, Xbest, rn_best, stall

    from gp_ss_ak_tpu.utils.vma import pvary_like

    # the stall counter's update depends on the psum'd residuals, so
    # under a two-level mesh it is varying over the OUTER axis (each
    # chain stalls independently); the initial carry must match
    stall0 = pvary_like(jnp.asarray(0), rn0)
    state = (X, R, Z, Pv, rz, jnp.asarray(0), X, rn0, stall0)
    _X, _R, _Z, _P, _rz, it, Xbest, rn_best, _st = lax.while_loop(
        cond, body, state)
    # worst-column achieved relative residual ||r||/||b|| (psum'd, so
    # replicated) — the honest convergence record for ring eval rows
    rel = jnp.sqrt(jnp.max(jnp.where(
        rn0 > 0, rn_best / jnp.where(rn0 > 0, rn0, 1.0), 0.0)))
    return Xbest, it, rel


def _ring_slq_logdet(matmat, inv_sqrt, logdet_P, Z_local, n_true,
                     k_steps, axis):
    """Preconditioned SLQ with a DISTRIBUTED batched Lanczos: every
    reduction is a psum, every step one ring matmat shared by all
    probes; the quadrature on the replicated tridiagonals is local."""
    def whitened(V):
        return inv_sqrt(matmat(inv_sqrt(V)))

    from gp_ss_ak_tpu.utils.vma import pvary_like

    b = Z_local.shape[1]
    norms = jnp.sqrt(lax.psum(jnp.sum(Z_local * Z_local, axis=0), axis))
    V = Z_local / norms[None, :]

    def body(carry, _):
        V_prev, V_cur, beta_prev = carry
        W = whitened(V_cur) - beta_prev[None, :] * V_prev
        alpha = lax.psum(jnp.sum(W * V_cur, axis=0), axis)
        W = W - alpha[None, :] * V_cur
        beta = jnp.sqrt(lax.psum(jnp.sum(W * W, axis=0), axis))
        V_next = jnp.where(beta[None, :] > 1e-10,
                           W / jnp.where(beta > 0, beta, 1.0)[None, :],
                           jnp.zeros_like(W))
        return (V_cur, V_next, beta), (alpha, beta)

    # beta starts invariant but every later beta carries the psum'd
    # (chain-varying, on a two-level mesh) reduction's vma
    init = (jnp.zeros_like(V), V,
            pvary_like(jnp.zeros((b,), V.dtype), norms))
    _, (alphas, betas) = lax.scan(body, init, None, length=k_steps)
    betas = betas[:-1]

    def quad(a_col, b_col):
        T = (jnp.diag(a_col) + jnp.diag(b_col, 1) + jnp.diag(b_col, -1))
        w, Vq = jnp.linalg.eigh(T)
        w = jnp.maximum(w, 1e-12)
        return jnp.asarray(float(n_true), Z_local.dtype) * jnp.sum(
            (Vq[0, :] ** 2) * jnp.log(w))

    resid = jnp.mean(jax.vmap(quad, in_axes=(1, 1))(alphas, betas))
    return logdet_P + resid


def make_ring_nlml_and_grad(kernel, mesh: Mesh, n: int,
                            n_devices: int = None, axis: str = ROW_AXIS,
                            precond_rank: int = None, probes: int = 8,
                            slq_probes: int = 16,
                            lanczos_iters: int = 32,
                            cg_tol: float = 1e-4, cg_maxiter: int = 400,
                            probe_seed: int = 0,
                            with_stats: bool = False,
                            tile_chunk: int = None) -> Callable:
    """Ring-distributed matrix-free NLML + gradient — the training
    route past the row-panel wall: nothing larger than
    an (n_local, n_local) tile or an (n_local, probes) block ever
    exists on any device, so N is bounded by link bandwidth and wall
    clock, not by panel memory (parallel/nlml.py dies at N ~ 10^5 P).

    Per evaluation (the BBMM estimator, distributed):
      alpha + Hutchinson probe solves : ONE ring batched PCG on
          [y | Z] with a ring-built pivoted-Cholesky Woodbury
          preconditioner (rank `precond_rank`),
      logdet : exact logdet P + SLQ on the whitened residual operator
          via a psum'd batched Lanczos (`slq_probes` x
          `lanczos_iters`),
      gradient : d/dtheta [ mean_z w' A(theta) z / 2 - alpha' A alpha
          / 2 ] differentiated THROUGH the ring tile build (lax.scan
          of ppermute steps — reverse-mode transposes each rotation).

    Probe keys are FIXED, so optimizers see a deterministic
    self-consistent objective (same contract as optim/iterative_fit).
    Flagship Sum([ExpAns, Bias]) + Gaussian only. Returns jitted
    (flat, X_pad, y_pad) -> (value, grad).

    NOTE (since r3): `precond_rank=None` resolves to the N-scaled
    `auto_precond_rank(n)` = min(1024, n//48) — previously a fixed 64.
    The rank-k factor L and its spectral pieces are ~2 x 4 n k bytes of
    resident state per device group; on memory-tight meshes pass
    `precond_rank=64` explicitly to keep the old footprint (applies to
    the two-level and predict variants below as well)."""
    if not _is_flagship(kernel):
        raise ValueError("ring NLML supports the flagship kernel only")
    if precond_rank is None:
        from gp_ss_ak_tpu.inference.iterative import auto_precond_rank
        precond_rank = auto_precond_rank(n)
    P_sz = n_devices or len(mesh.devices)
    body = _make_ring_body(kernel, n, P_sz, axis, precond_rank, probes,
                           slq_probes, lanczos_iters, cg_tol,
                           cg_maxiter, probe_seed,
                           with_stats=with_stats,
                           tile_chunk=tile_chunk)
    out_specs = (P(), P(), P()) if with_stats else (P(), P())
    mapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=out_specs,
    )
    return jax.jit(mapped)


def _make_ring_body(kernel, n, P_sz, axis, precond_rank, probes,
                    slq_probes, lanczos_iters, cg_tol, cg_maxiter,
                    probe_seed, uniform_axis=None, with_stats=False,
                    tile_chunk=None):
    """Per-device ring NLML+grad body, reusable across the 1-D mesh
    and the two-level (chains x dp) mesh (mirrors parallel/nlml's
    _make_nlml_body split). `with_stats=True` additionally returns the
    replicated [cg_iters, achieved_rel_residual] vector — the honest
    convergence record for ring eval rows."""
    nk = kernel.n_params

    def body(flat, X_local, y_local):
        n_local = X_local.shape[0]
        n_pad = n_local * P_sz
        params = kernel.unpack(flat[:nk])
        ep, bp = params
        sigma, bias, sn2 = ep["Sigma"], bp["Sigma"], flat[nk]
        Xm, g, row_valid = _mapped_local(kernel, params, X_local, n,
                                         axis)
        matmat = _ring_matmat_fn(Xm, row_valid, g, n, sigma, bias, sn2,
                                 P_sz, axis, tile_chunk)
        L_local = _ring_pivchol_dispatch(Xm, row_valid, g, sigma, bias,
                                         precond_rank, n_pad, axis)
        pinv, inv_sqrt, logdet_P = _ring_precond(L_local, sn2, n, axis)

        # probes: replicated global draw, zeroed on padding, local slice
        dt = X_local.dtype
        key_tr, key_ld = jax.random.split(jax.random.PRNGKey(probe_seed))
        p = lax.axis_index(axis)
        Z_all = jax.random.rademacher(
            key_tr, (n_pad, probes), dt)
        Z_local = lax.dynamic_slice_in_dim(Z_all, p * n_local,
                                           n_local, 0)
        Z_local = jnp.where(row_valid[:, None], Z_local, 0.0)
        yz = jnp.where(row_valid, y_local, 0.0)
        rhs = jnp.concatenate([yz[:, None], Z_local], axis=1)
        # on a two-level mesh A (through flat) varies over the chain
        # axis while the data-derived rhs varies only over the row
        # axis; the CG/Lanczos carries must match from iteration 0
        from gp_ss_ak_tpu.utils.vma import pvary_like
        rhs = pvary_like(rhs, Xm)
        # whitened CG (plain CG on P^(-1/2) A P^(-1/2)) — the
        # f32-stable solve route; the implicit-PCG recurrence breaks
        # down at the flagship conditioning (see
        # inference.iterative.whitened_solve_info)
        sols_w, cg_it, cg_rel = _ring_bcg(
            lambda V: inv_sqrt(matmat(inv_sqrt(V))),
            inv_sqrt(rhs), None, cg_tol, cg_maxiter, axis,
            uniform_axis=uniform_axis)
        sols = inv_sqrt(sols_w)
        alpha, ws = sols[:, 0], sols[:, 1:]

        Zl_all = jax.random.rademacher(key_ld, (n_pad, slq_probes), dt)
        Zl_local = lax.dynamic_slice_in_dim(Zl_all, p * n_local,
                                            n_local, 0)
        Zl_local = jnp.where(row_valid[:, None], Zl_local, 0.0)
        Zl_local = pvary_like(Zl_local, Xm)
        logdet = _ring_slq_logdet(matmat, inv_sqrt, logdet_P, Zl_local,
                                  n, lanczos_iters, axis)
        fit = 0.5 * lax.psum(jnp.dot(yz, alpha, precision=_PREC), axis)
        value = fit + 0.5 * logdet + 0.5 * n * math.log(2.0 * math.pi)

        # --- gradient: contraction through the differentiable ring ---
        coef = jnp.concatenate([
            jnp.full((probes,), 1.0 / probes, dt),
            jnp.full((1,), -1.0, dt)])
        U = lax.stop_gradient(
            jnp.concatenate([ws, alpha[:, None]], axis=1)) \
            * coef[None, :]
        V = lax.stop_gradient(
            jnp.concatenate([Z_local, alpha[:, None]], axis=1))

        def surrogate(flat_):
            params_ = kernel.unpack(flat_[:nk])
            ep_, bp_ = params_
            sig_, b_, sn2_ = ep_["Sigma"], bp_["Sigma"], flat_[nk]
            Xm_, _, _ = _mapped_local(kernel, params_, X_local, n, axis)
            mm = _ring_matmat_fn(Xm_, row_valid, g, n, sig_, b_, sn2_,
                                 P_sz, axis, tile_chunk)
            AV = mm(V)
            AV = jnp.where(row_valid[:, None], AV, 0.0)
            return 0.5 * jnp.sum(U * AV)

        # the cross-device reduction of the replicated input's
        # cotangent is inserted by shard_map (same note as
        # parallel/nlml.py)
        grad = jax.grad(surrogate)(flat)
        if with_stats:
            stats = jnp.stack([cg_it.astype(value.dtype),
                               cg_rel.astype(value.dtype)])
            return value, grad, stats
        return value, grad

    return body


def make_two_level_ring_nlml_and_grad(kernel, mesh: Mesh, n: int,
                                      chain_axis: str = "chains",
                                      row_axis: str = ROW_AXIS,
                                      precond_rank: int = None,
                                      probes: int = 8,
                                      slq_probes: int = 16,
                                      lanczos_iters: int = 32,
                                      cg_tol: float = 1e-4,
                                      cg_maxiter: int = 400,
                                      probe_seed: int = 0) -> Callable:
    """Two-level ring: each CHAIN (HMC chain / ensemble member /
    restart) owns an independent hyper vector; within a chain the
    ring NLML+grad runs panel-free over `row_axis`. The Bayes backbone
    at N past the row-panel wall — pairs with bayes.api's
    distributed-NLML custom-VJP hook, whose (flat, X, y) -> (v, g)
    contract this matches per chain.

    Returns jitted (flats (C, p), X_pad, y_pad) -> (values (C,),
    grads (C, p)); X/y row-sharded, replicated across chains."""
    if not _is_flagship(kernel):
        raise ValueError("ring NLML supports the flagship kernel only")
    if precond_rank is None:
        from gp_ss_ak_tpu.inference.iterative import auto_precond_rank
        precond_rank = auto_precond_rank(n)
    ci = mesh.axis_names.index(chain_axis)
    ri = mesh.axis_names.index(row_axis)
    P_sz = mesh.devices.shape[ri]
    n_chains = mesh.devices.shape[ci]
    body = _make_ring_body(kernel, n, P_sz, row_axis, precond_rank,
                           probes, slq_probes, lanczos_iters, cg_tol,
                           cg_maxiter, probe_seed,
                           uniform_axis=chain_axis)

    def chain_body(flats_local, X_local, y_local):
        value, grad = body(flats_local[0], X_local, y_local)
        return value[None], grad[None]

    mapped = jax.shard_map(
        chain_body, mesh=mesh,
        in_specs=(P(chain_axis, None), P(row_axis, None), P(row_axis)),
        out_specs=(P(chain_axis), P(chain_axis, None)),
    )

    def run(flats, X_pad, y_pad):
        assert flats.shape[0] == n_chains
        return mapped(flats, X_pad, y_pad)

    return jax.jit(run)


def make_ring_predict(kernel, mesh: Mesh, n: int, n_devices: int = None,
                      axis: str = ROW_AXIS, tol: float = 1e-6,
                      maxiter: int = 1000,
                      precond_rank: int = None) -> Callable:
    """Panel-free posterior mean AND variance at Xstar (replicated,
    m queries): alpha and the m variance solves U = A^-1 kX ride ONE
    ring batched PCG ([y | kX], m+1 columns share every rotation);
    then mu = kX' alpha and var = kdiag - sum(kX * U) + sn2, both one
    psum. Mirrors posteriorMeanVar (GP_Utils.cpp:943-1043) — the
    whitened-solve variance identity k** - v'v with v = L^-1 kX equals
    k** - kX' A^-1 kX, which needs no factorization. Serve in chunks:
    cost is one ring PCG per chunk.

    Returns jitted (flat, X_pad, y_pad, Xstar) -> (mu, var)."""
    if not _is_flagship(kernel):
        raise ValueError("ring predict supports the flagship kernel "
                         "only")
    if precond_rank is None:
        from gp_ss_ak_tpu.inference.iterative import auto_precond_rank
        precond_rank = auto_precond_rank(n)
    P_sz = n_devices or len(mesh.devices)
    nk = kernel.n_params

    def body(flat, X_local, y_local, Xstar):
        from gp_ss_ak_tpu.kernels.distance import pad_to_3d

        n_local = X_local.shape[0]
        n_pad = n_local * P_sz
        params = kernel.unpack(flat[:nk])
        ep, bp = params
        sigma, bias, sn2 = ep["Sigma"], bp["Sigma"], flat[nk]
        Xm, g, row_valid = _mapped_local(kernel, params, X_local, n,
                                         axis)
        matmat = _ring_matmat_fn(Xm, row_valid, g, n, sigma, bias, sn2,
                                 P_sz, axis)
        # queries mapped with the same global centre as the rows
        Xp = pad_to_3d(X_local)
        csum = lax.psum(jnp.sum(
            jnp.where(row_valid[:, None], Xp, 0.0), axis=0), axis)
        M = kernel.children[0].metric(ep, Xp.shape[-1])
        Xsm = jnp.matmul(pad_to_3d(Xstar) - csum / n, M,
                         precision=_PREC)
        kX = _tile(Xm, Xsm, sigma, bias)               # (n_local, m)
        kX = jnp.where(row_valid[:, None], kX, 0.0)

        yz = jnp.where(row_valid, y_local, 0.0)
        rhs = jnp.concatenate([yz[:, None], kX], axis=1)
        if precond_rank:
            L_local = _ring_pivchol_dispatch(Xm, row_valid, g, sigma,
                                             bias, precond_rank, n_pad,
                                             axis)
            _pinv, inv_sqrt, _ld = _ring_precond(L_local, sn2, n, axis)
            # whitened CG — f32-stable (see make_ring_nlml_and_grad)
            sols_w, _it, _rel = _ring_bcg(
                lambda V: inv_sqrt(matmat(inv_sqrt(V))),
                inv_sqrt(rhs), None, tol, maxiter, axis)
            sols = inv_sqrt(sols_w)
        else:
            sols, _it, _rel = _ring_bcg(matmat, rhs, None, tol,
                                        maxiter, axis)
        alpha, U = sols[:, 0], sols[:, 1:]

        mu = lax.psum(jnp.matmul(kX.T, alpha[:, None],
                                 precision=_PREC)[:, 0], axis)
        quad = lax.psum(jnp.sum(kX * U, axis=0), axis)
        kdiag = sigma * sigma + bias
        var = jnp.maximum(kdiag - quad, 0.0) + sn2
        return mu, var

    mapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P()),
        out_specs=(P(), P()),
    )
    return jax.jit(mapped)


def make_ring_posterior_mean(kernel, mesh: Mesh, n: int,
                             n_devices: int = None,
                             axis: str = ROW_AXIS, tol: float = 1e-6,
                             maxiter: int = 1000) -> Callable:
    """Returns jitted (flat, X_pad, y_pad, Xstar) -> posterior mean at
    Xstar: alpha by ring CG, then mu = kX^T alpha accumulated by one
    psum over the devices' local cross-tiles (Xstar replicated).

    Mirrors _postMean (GP_Utils.cpp:958-972) at panel-free scale."""
    cg = make_ring_cg_solve(kernel, mesh, n, n_devices, axis, tol,
                            maxiter)
    P_sz = n_devices or len(mesh.devices)
    nk = kernel.n_params

    def body(flat, X_local, alpha_local, Xstar):
        from gp_ss_ak_tpu.kernels.distance import pad_to_3d

        params = kernel.unpack(flat[:nk])
        ep, bp = params
        Xm, g, row_valid = _mapped_local(kernel, params, X_local, n, axis)
        # map the queries with the same centre
        expans = kernel.children[0]
        Xp = pad_to_3d(X_local)
        n_local = Xp.shape[0]
        csum = lax.psum(
            jnp.sum(jnp.where(row_valid[:, None], Xp, 0.0), axis=0), axis)
        c = csum / n
        M = expans.metric(ep, Xp.shape[-1])
        Xsm = jnp.matmul(pad_to_3d(Xstar) - c, M, precision=_PREC)
        kX = _tile(Xm, Xsm, ep["Sigma"], bp["Sigma"])      # (n_local, m)
        kX = jnp.where(row_valid[:, None], kX, 0.0)
        mu = lax.psum(
            jnp.matmul(kX.T, alpha_local[:, None], precision=_PREC)[:, 0],
            axis)
        return mu

    mapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P()),
        out_specs=P(),
    )
    mapped = jax.jit(mapped)

    def run(flat, X_pad, y_pad, Xstar):
        alpha, it, res = cg(flat, X_pad, y_pad)
        return mapped(flat, X_pad, alpha, Xstar), it, res

    return run

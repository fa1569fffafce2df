"""Matrix-free iterative inference: CG solves + stochastic Lanczos
logdet — exact-GP NLML and gradients at N where the kernel matrix
cannot exist in memory (GPyTorch's BBMM recipe).

Compute structure per NLML evaluation:
  alpha    : CG on A v = y           (matvecs via the streamed Gram
                                      product, ops/matvec.py)
  logdet A : m-probe stochastic Lanczos quadrature — k Lanczos steps
             per Rademacher probe, logdet ~ mean_z ||z||^2 e1' log(T) e1
  gradient : Hutchinson trace + fit-term contractions,
             d/dtheta [ sum_z w_z' A(theta) z / m - alpha' A(theta)
             alpha / 2 ...] with w_z = A^-1 z held fixed — one
             jax.grad through a CHUNKED differentiable matvec
             (lax.map over row blocks, O(chunk x N) memory).

Everything is f32; CG tolerance and probe/step counts trade accuracy
for time explicitly. For N <= a few thousand prefer the dense path
(inference/gaussian.py) — this module exists for the 10^4..10^5+
single-device regime (BASELINE config 3 on one card).

Operator modes (`choose_mode`): the streamed operator pays one full
O(N^2) distance+exp pass per matvec, and a CG+SLQ evaluation makes
~50-70 of them. Whenever A fits in device memory it is materialized
ONCE per hyperparameter setting instead:
  chol      (N <= ~32k) exact Cholesky — exact alpha/logdet, exact
            Hutchinson probe solves; no CG, no SLQ bias.
  gemm      (N <= ~49k) A in f32; PCG + SLQ matvecs become GEMMs at
            the memory-bandwidth floor.
  stream    beyond — the original tile-streaming path (accurate).
  gemm_bf16 opt-in only (never auto): A in bf16 — solves are
            residual-corrected and usable, but the quantization noise
            dwarfs the flagship sn2 and biases the SLQ logdet; see
            choose_mode.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from gp_ss_ak_tpu.kernels.distance import gram_sqdist


# ---------------------------------------------------------------------------
# conjugate gradients
# ---------------------------------------------------------------------------

def cg_solve(matvec: Callable, b: jnp.ndarray, tol: float = 1e-5,
             maxiter: int = 500, x0=None):
    """Plain CG on SPD A. Returns (x, n_iters, final residual norm)."""
    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    p = r
    rs = jnp.dot(r, r)
    bnorm = jnp.sqrt(jnp.dot(b, b))
    thresh = (tol * bnorm) ** 2

    def cond(state):
        x, r, p, rs, it = state
        return (rs > thresh) & (it < maxiter)

    def body(state):
        x, r, p, rs, it = state
        Ap = matvec(p)
        alpha = rs / jnp.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = jnp.dot(r, r)
        p = r + (rs_new / rs) * p
        return x, r, p, rs_new, it + 1

    x, r, p, rs, it = lax.while_loop(
        cond, body, (x, r, p, rs, jnp.asarray(0)))
    return x, it, jnp.sqrt(rs)


# ---------------------------------------------------------------------------
# pivoted-Cholesky preconditioner (GPyTorch/BBMM recipe)
# ---------------------------------------------------------------------------

def pivoted_cholesky(Xm: jnp.ndarray, sigma, bias, rank: int):
    """Rank-`rank` pivoted Cholesky of K = sigma^2 exp(-||xi-xj||) + bias
    WITHOUT ever building K: greedy max-diagonal pivoting, one kernel
    COLUMN (O(n d)) per step. Returns L (n, rank) with L L^T ~ K.

    The flagship kernel has a constant diagonal (sigma^2 + bias), so
    the first pivot is arbitrary and convergence is governed by the
    eigendecay of K — fast for smooth kernels, which is exactly the
    ill-conditioned (small sn2) regime where CG needs the help.
    """
    n = Xm.shape[0]
    s2 = sigma * sigma

    def column(i):
        xi = lax.dynamic_slice_in_dim(Xm, i, 1, 0)         # (1, d)
        d2 = jnp.sum((Xm - xi) ** 2, axis=1)
        r = jnp.sqrt(jnp.maximum(d2, 0.0))
        c = s2 * jnp.exp(-r) + bias
        return c.at[i].set(s2 + bias)                       # exact diag

    def body(j, carry):
        L, d = carry
        i = jnp.argmax(d)
        c = column(i)
        Li = jnp.take(L, i, axis=0)                         # (rank,)
        # HIGHEST precision is load-bearing: a reduced-precision
        # product's absolute error (TF32 on a GPU keeps ~3 digits)
        # lands inside the cancellation c - L Li and is then amplified
        # by the shrinking pivot 1/sqrt(d_i) — at rank >= ~512 the
        # later columns come out garbage, and the resulting
        # P = L L^T + sn2 I (still SPD) has huge spurious eigenvalues
        # that floor PCG at 1e-1-ish relative residuals
        l = (c - jnp.matmul(L, Li, precision=jax.lax.Precision.HIGHEST)) \
            / jnp.sqrt(jnp.maximum(d[i], 1e-30))
        l = jnp.where(d[i] > 1e-30, l, jnp.zeros_like(l))
        L = L.at[:, j].set(l)
        d = jnp.maximum(d - l * l, 0.0)
        d = d.at[i].set(0.0)
        return (L, d)

    L0 = jnp.zeros((n, rank), Xm.dtype)
    d0 = jnp.full((n,), s2 + bias, Xm.dtype)
    L, _ = lax.fori_loop(0, rank, body, (L0, d0))
    return L


def woodbury_pieces(L: jnp.ndarray, sn2):
    """The k x k Cholesky factor of M = sn2 I_k + L^T L — the only
    precomputable piece of the Woodbury apply. Pure array in/out, so
    a segmented driver can compute it once per eval and ship it into
    pre-compiled segment programs."""
    k = L.shape[1]
    M = sn2 * jnp.eye(k, dtype=L.dtype) + jnp.matmul(
        L.T, L, precision=jax.lax.Precision.HIGHEST)
    return jnp.linalg.cholesky(M)


def woodbury_apply(L: jnp.ndarray, Mchol: jnp.ndarray, sn2, v):
    """P^-1 v = (v - L M^-1 L^T v) / sn2 for P = L L^T + sn2 I.
    Accepts a vector (n,) or a block of columns (n, B)."""
    vm = v if v.ndim == 2 else v[:, None]
    Ltv = jnp.matmul(L.T, vm, precision=jax.lax.Precision.HIGHEST)
    w = jax.scipy.linalg.cho_solve((Mchol, True), Ltv)
    out = (vm - jnp.matmul(L, w,
                           precision=jax.lax.Precision.HIGHEST)) / sn2
    return out if v.ndim == 2 else out[:, 0]


def woodbury_preconditioner(L: jnp.ndarray, sn2):
    """P^-1 for P = L L^T + sn2 I via the Woodbury identity:
    P^-1 v = (v - L M^-1 L^T v) / sn2,  M = sn2 I_k + L^T L.
    Accepts a vector (n,) or a block of columns (n, B)."""
    Mchol = woodbury_pieces(L, sn2)

    def pinv(v):
        return woodbury_apply(L, Mchol, sn2, v)

    return pinv


def precond_sqrt_pieces(L: jnp.ndarray, sn2):
    """The array pieces of P^(-1/2) and logdet P for P = L L^T + sn2 I
    (pure in/out — computable once per eval in a setup dispatch).
    Returns (Q (n, k), inv_sqrt_eig (k,), logdet_P ())."""
    n, k = L.shape
    LtL = jnp.matmul(L.T, L, precision=jax.lax.Precision.HIGHEST)
    S, U = jnp.linalg.eigh(LtL)
    S = jnp.maximum(S, 0.0)
    mask = S > 1e-10
    Q = jnp.matmul(L, U / jnp.sqrt(jnp.maximum(S, 1e-30))[None, :],
                   precision=jax.lax.Precision.HIGHEST)
    Q = Q * mask[None, :].astype(L.dtype)
    inv_sqrt_eig = jnp.where(mask, 1.0 / jnp.sqrt(S + sn2), 0.0)
    logdet_P = (n - jnp.sum(mask)) * jnp.log(sn2) \
        + jnp.sum(jnp.where(mask, jnp.log(S + sn2), 0.0))
    return Q, inv_sqrt_eig, logdet_P


def precond_sqrt_fwd_apply(Q: jnp.ndarray, inv_sqrt_eig: jnp.ndarray,
                           sn2, v):
    """P^(+1/2) v from the same pieces — the forward square root,
    used to carry an UNWHITENED warm start into a (new) whitened
    basis: x0_w = P^(1/2) x_prev. With mask m = inv_sqrt_eig > 0,
    sqrt(S+sn2) = 1/inv_sqrt_eig on masked columns."""
    rsn = jnp.sqrt(sn2)
    sqrt_eig = jnp.where(inv_sqrt_eig > 0, 1.0 / jnp.where(
        inv_sqrt_eig > 0, inv_sqrt_eig, 1.0), rsn)
    vm = v if v.ndim == 2 else v[:, None]
    Qtv = jnp.matmul(Q.T, vm, precision=jax.lax.Precision.HIGHEST)
    out = (vm - jnp.matmul(Q, Qtv,
                           precision=jax.lax.Precision.HIGHEST)) * rsn \
        + jnp.matmul(Q, sqrt_eig[:, None] * Qtv,
                     precision=jax.lax.Precision.HIGHEST)
    return out if v.ndim == 2 else out[:, 0]


def precond_sqrt_apply(Q: jnp.ndarray, inv_sqrt_eig: jnp.ndarray, sn2, v):
    """P^(-1/2) v from the pieces of `precond_sqrt_pieces`."""
    rsn = 1.0 / jnp.sqrt(sn2)
    vm = v if v.ndim == 2 else v[:, None]
    Qtv = jnp.matmul(Q.T, vm, precision=jax.lax.Precision.HIGHEST)
    out = (vm - jnp.matmul(Q, Qtv,
                           precision=jax.lax.Precision.HIGHEST)) * rsn \
        + jnp.matmul(Q, inv_sqrt_eig[:, None] * Qtv,
                     precision=jax.lax.Precision.HIGHEST)
    return out if v.ndim == 2 else out[:, 0]


def precond_sqrt(L: jnp.ndarray, sn2):
    """Exact P^(-1/2) apply and logdet P for P = L L^T + sn2 I.

    From the k x k eigendecomposition L^T L = U S U^T: with
    Q = L U S^(-1/2) (orthonormal columns where S > 0),
      P          = sn2 (I - Q Q^T) + Q diag(S + sn2) Q^T
      P^(-1/2) v = (v - Q Q^T v)/sqrt(sn2) + Q diag(1/sqrt(S+sn2)) Q^T v
      logdet P   = (n - k') log sn2 + sum_{S_i>0} log(S_i + sn2)
    All O(n k) GEMMs. Returns (apply_inv_sqrt, logdet_P)."""
    Q, inv_sqrt_eig, logdet_P = precond_sqrt_pieces(L, sn2)

    def apply_inv_sqrt(v):
        return precond_sqrt_apply(Q, inv_sqrt_eig, sn2, v)

    return apply_inv_sqrt, logdet_P


def pcg_solve(matvec: Callable, b: jnp.ndarray, pinv: Callable,
              tol: float = 1e-5, maxiter: int = 500, x0=None):
    """Preconditioned CG. Returns (x, n_iters, final residual norm)."""
    b = jnp.asarray(b)
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = pinv(r)
    p = z
    rz = jnp.dot(r, z)
    bnorm2 = jnp.dot(b, b)
    thresh = (tol ** 2) * bnorm2

    def cond(state):
        _x, r, _z, _p, _rz, it, _xb, _rb = state
        rn = jnp.dot(r, r)
        return (rn > thresh) & jnp.isfinite(rn) & (it < maxiter)

    def body(state):
        x, r, z, p, rz, it, xbest, rn_best = state
        Ap = matvec(p)
        a = rz / jnp.dot(p, Ap)
        x = x + a * p
        r = r - a * Ap
        rn = jnp.dot(r, r)
        better = jnp.isfinite(rn) & (rn < rn_best) \
            & jnp.all(jnp.isfinite(x))
        xbest = jnp.where(better, x, xbest)
        rn_best = jnp.where(better, rn, rn_best)
        z = pinv(r)
        rz_new = jnp.dot(r, z)
        p = z + (rz_new / rz) * p
        return x, r, z, p, rz_new, it + 1, xbest, rn_best

    _x, r, _z, _p, _rz, it, xbest, rn_best = lax.while_loop(
        cond, body, (x, r, z, p, rz, jnp.asarray(0), x, bnorm2))
    return xbest, it, jnp.sqrt(rn_best)


#: bcg stops after this many consecutive iterations in which NO
#: column improved its best residual: a column whose f32-achievable
#: residual floor sits above `tol` would otherwise spin the whole
#: lock-step solve to `maxiter` while Xbest no longer changes.
BCG_STALL_ITERS = 25


def bcg_init(B_rhs: jnp.ndarray, pinv=None, tol: float = 1e-5,
             X0=None, R0=None):
    """Initial (state, thresh) for the batched-PCG loop — see
    `bcg_segment`. State is a flat tuple of arrays, so it can cross
    dispatch boundaries (the segmented large-N driver carries it on
    the host between bounded jit segments).

    Warm start: pass BOTH X0 and its true residual R0 = B - A X0 (the
    caller owns the matmat). The convergence threshold stays relative
    to ||B|| — a warm start changes the path, not the contract — and
    the best-iterate tracking seeds from (X0, ||R0||^2), so a warm
    start can never return something worse than its own input."""
    B_rhs = jnp.asarray(B_rhs)
    if (X0 is None) != (R0 is None):
        raise ValueError("warm start needs both X0 and R0")
    X = jnp.zeros_like(B_rhs) if X0 is None else X0
    R = B_rhs if R0 is None else R0
    Z = pinv(R) if pinv is not None else R
    rz = jnp.sum(R * Z, axis=0)
    rn0 = jnp.sum(B_rhs * B_rhs, axis=0)
    rn_start = rn0 if R0 is None else jnp.sum(R0 * R0, axis=0)
    thresh = (tol ** 2) * rn0
    state = (X, R, Z, Z, rz, jnp.asarray(0), X, rn_start,
             jnp.asarray(0))
    return state, thresh


def _stall_iters(pinv) -> int:
    """Stall window: unpreconditioned CG residuals are non-monotone
    with plateau-then-drop phases that can exceed the preconditioned
    window (ADVICE r3, iterative.py:159) — give plain CG 4x the
    patience before declaring the f32 floor reached."""
    return BCG_STALL_ITERS if pinv is not None else 4 * BCG_STALL_ITERS


def bcg_segment(matmat: Callable, pinv, state, thresh, it_cap: int):
    """Advance the batched-PCG state until convergence/stall or the
    ABSOLUTE iteration count reaches `it_cap`. Returns the new state;
    pass it back in with a larger cap to resume — bit-identical to one
    uninterrupted loop, since the state tuple is the loop carry."""
    stall_cap = _stall_iters(pinv)
    def _active(R):
        # a column stays active while its residual is finite and above
        # tolerance; a non-finite residual (CG divergence over a noisy
        # bf16 matvec) freezes the column — a=0 below never lets NaN
        # reach X, and the BEST iterate (smallest residual seen) is
        # what gets returned, so a diverging column yields its most
        # accurate solution rather than a blown-up one
        rn = jnp.sum(R * R, axis=0)
        return (rn > thresh) & jnp.isfinite(rn)

    def cond(state):
        _X, R, _Z, _P, _rz, it, _Xb, _rb, stall = state
        return jnp.any(_active(R)) & (it < it_cap) \
            & (stall < stall_cap)

    def body(state):
        X, R, Z, P, rz, it, Xbest, rn_best, stall = state
        active = _active(R)
        AP = matmat(P)
        pAp = jnp.sum(P * AP, axis=0)
        ok = active & (pAp > 0) & jnp.isfinite(pAp) & jnp.isfinite(rz)
        a = jnp.where(ok, rz / jnp.where(pAp > 0, pAp, 1.0), 0.0)
        X = X + a[None, :] * P
        R = R - a[None, :] * AP
        rn = jnp.sum(R * R, axis=0)
        better = jnp.isfinite(rn) & (rn < rn_best) \
            & jnp.all(jnp.isfinite(X), axis=0)
        Xbest = jnp.where(better[None, :], X, Xbest)
        # only a MEANINGFUL improvement (0.1% in the squared residual)
        # resets the stall counter: near the f32 floor the best
        # residual keeps creeping down by noise-level amounts, which
        # would defer the cutoff for hundreds of wasted passes
        meaningful = better & (rn < 0.999 * rn_best)
        rn_best = jnp.where(better, rn, rn_best)
        stall = jnp.where(jnp.any(meaningful & active), 0, stall + 1)
        Z = pinv(R) if pinv is not None else R
        rz_new = jnp.sum(R * Z, axis=0)
        beta = jnp.where(ok, rz_new / jnp.where(rz > 0, rz, 1.0), 0.0)
        P = Z + beta[None, :] * P
        return X, R, Z, P, rz_new, it + 1, Xbest, rn_best, stall

    return lax.while_loop(cond, body, state)


def bcg_done(state, thresh, *, pinv) -> jnp.ndarray:
    """True when the PCG state has converged or stalled (resuming with
    a larger cap would do nothing). Matches bcg_segment's cond; pass
    the SAME pinv the segment loop uses (None for an unpreconditioned
    solve's 4x stall window) — `pinv` is keyword-required precisely so
    a host driver cannot silently pair the short preconditioned stall
    window with an unpreconditioned segment loop and declare the solve
    done up to 75 iterations early."""
    _X, R, _Z, _P, _rz, _it, _Xb, _rb, stall = state
    rn = jnp.sum(R * R, axis=0)
    still = jnp.any((rn > thresh) & jnp.isfinite(rn))
    return (~still) | (stall >= _stall_iters(pinv))


def bcg_rel_residual(state, thresh, tol: float) -> jnp.ndarray:
    """Worst-column achieved RELATIVE residual ||r||/||b|| of a
    batched-PCG state (thresh = tol^2 ||b||^2 per column, so the rhs
    norms are recoverable without carrying them separately). The
    honest convergence record for eval rows: cg_iters == maxiter alone
    cannot distinguish 'diverged' from 'one decade short'."""
    rn_best = state[7]
    rn0 = thresh / (tol * tol)
    rel2 = jnp.where(rn0 > 0, rn_best / jnp.where(rn0 > 0, rn0, 1.0), 0.0)
    return jnp.sqrt(jnp.max(rel2))


def bcg_solve_info(matmat: Callable, B_rhs: jnp.ndarray, pinv=None,
                   tol: float = 1e-5, maxiter: int = 500):
    """`bcg_solve` + the achieved worst-column relative residual.
    Returns (X (n,B), n_iters, rel_residual)."""
    state, thresh = bcg_init(B_rhs, pinv, tol)
    state = bcg_segment(matmat, pinv, state, thresh, maxiter)
    _X, R, _Z, _P, _rz, it, Xbest, _rb, _st = state
    return Xbest, it, bcg_rel_residual(state, thresh, tol)


def whitened_solve_info(op_matmat: Callable, L: jnp.ndarray, sn2,
                        B_rhs: jnp.ndarray, tol: float = 1e-4,
                        maxiter: int = 500):
    """Solve A X = B by PLAIN batched CG on the explicitly whitened
    operator A~ = P^(-1/2) A P^(-1/2), with P = L L^T + sn2 I the
    rank-k pivoted-Cholesky preconditioner.

    Mathematically identical to PCG with P — numerically NOT: the
    implicit PCG recurrence (cross inner products r'z with z = P^-1 r)
    breaks down in f32 at the flagship conditioning (kappa(A) ~
    lambda_1/sn2 ~ 10^6 at N ~ 10^5): it can oscillate at a large
    relative residual for hundreds of iterations on instances where
    this whitened solve converges in tens. CG here runs on kappa(A~) ~ (lambda_k + sn2)/sn2
    ~ O(100) — comfortably inside f32's stability envelope — and the
    whitened residual is the natural norm for the NLML quadratic form
    (value error ~ ||r~||^2 / lambda_min(A~)).

    Returns (X, iters, rel_whitened, logdet_P, wmm) — `wmm` is the
    whitened matmat closure, reusable for the variance-reduced SLQ
    (the same operator it always ran on)."""
    Q, ise, logdet_P = precond_sqrt_pieces(L, sn2)

    def wmm(V):
        return precond_sqrt_apply(
            Q, ise, sn2, op_matmat(precond_sqrt_apply(Q, ise, sn2, V)))

    Bt = precond_sqrt_apply(Q, ise, sn2, B_rhs)
    Xw, it, rel = bcg_solve_info(wmm, Bt, None, tol=tol,
                                 maxiter=maxiter)
    return precond_sqrt_apply(Q, ise, sn2, Xw), it, rel, logdet_P, wmm


def bcg_solve(matmat: Callable, B_rhs: jnp.ndarray, pinv=None,
              tol: float = 1e-5, maxiter: int = 500):
    """Batched (P)CG: B independent right-hand sides advanced in
    lock-step through ONE blocked matvec per iteration — all columns
    share each pass over the streamed Gram tiles, which is the entire
    cost of a matrix-free iteration. Converged columns freeze (their
    step sizes are masked to zero); the solve also stops once no
    column has improved its best residual for `BCG_STALL_ITERS`
    iterations (rounding floor reached — extra passes buy nothing).
    Returns (X (n,B), n_iters)."""
    state, thresh = bcg_init(B_rhs, pinv, tol)
    state = bcg_segment(matmat, pinv, state, thresh, maxiter)
    _X, R, _Z, _P, _rz, it, Xbest, _rb, _st = state
    return Xbest, it


# ---------------------------------------------------------------------------
# stochastic Lanczos quadrature for logdet
# ---------------------------------------------------------------------------

def _lanczos(matvec: Callable, v0: jnp.ndarray, k: int):
    """k-step Lanczos with full orthogonalization skipped (standard for
    SLQ). Returns (alphas (k,), betas (k-1,))."""
    n = v0.shape[0]
    v = v0 / jnp.linalg.norm(v0)

    def body(carry, _):
        v_prev, v_cur, beta_prev = carry
        w = matvec(v_cur) - beta_prev * v_prev
        alpha = jnp.dot(w, v_cur)
        w = w - alpha * v_cur
        beta = jnp.linalg.norm(w)
        v_next = jnp.where(beta > 1e-10, w / jnp.where(beta > 0, beta, 1.0),
                           jnp.zeros_like(w))
        return (v_cur, v_next, beta), (alpha, beta)

    (_, _, _), (alphas, betas) = lax.scan(
        body, (jnp.zeros_like(v), v, jnp.asarray(0.0, v.dtype)), None,
        length=k)
    return alphas, betas[:-1]


def slq_logdet(matvec: Callable, n: int, key, probes: int = 16,
               lanczos_iters: int = 32):
    """E_z [ z' log(A) z ] with Rademacher probes via Gauss quadrature
    on the Lanczos tridiagonal (eigendecomposition of the k x k T)."""
    keys = jax.random.split(key, probes)

    def one(kk):
        z = jax.random.rademacher(kk, (n,), jnp.float32).astype(jnp.float32)
        alphas, betas = _lanczos(matvec, z, lanczos_iters)
        T = (jnp.diag(alphas) + jnp.diag(betas, 1) + jnp.diag(betas, -1))
        w, V = jnp.linalg.eigh(T)
        w = jnp.maximum(w, 1e-12)
        # z' log(A) z ~ ||z||^2 * sum_i (V[0,i]^2 log w_i)
        return jnp.asarray(float(n), jnp.float32) * jnp.sum(
            (V[0, :] ** 2) * jnp.log(w))

    vals = lax.map(one, keys)
    return jnp.mean(vals)


def _lanczos_batched(matmat: Callable, V0: jnp.ndarray, k: int):
    """k-step Lanczos on B probes at once — every step is ONE blocked
    matvec. V0 (n, B); returns (alphas (k, B), betas (k-1, B))."""
    V = V0 / jnp.linalg.norm(V0, axis=0, keepdims=True)

    def body(carry, _):
        V_prev, V_cur, beta_prev = carry
        W = matmat(V_cur) - beta_prev[None, :] * V_prev
        alpha = jnp.sum(W * V_cur, axis=0)
        W = W - alpha[None, :] * V_cur
        beta = jnp.linalg.norm(W, axis=0)
        V_next = jnp.where(beta[None, :] > 1e-10,
                           W / jnp.where(beta > 0, beta, 1.0)[None, :],
                           jnp.zeros_like(W))
        return (V_cur, V_next, beta), (alpha, beta)

    b = V0.shape[1]
    init = (jnp.zeros_like(V), V, jnp.zeros((b,), V.dtype))
    _, (alphas, betas) = lax.scan(body, init, None, length=k)
    return alphas, betas[:-1]


def lanczos_batched_init(V0: jnp.ndarray):
    """Initial carry for a segmented batched Lanczos (see
    `lanczos_batched_segment`)."""
    V = V0 / jnp.linalg.norm(V0, axis=0, keepdims=True)
    b = V0.shape[1]
    return (jnp.zeros_like(V), V, jnp.zeros((b,), V.dtype))


def lanczos_batched_segment(matmat: Callable, carry, k_steps: int):
    """Advance the batched Lanczos by `k_steps` and emit that
    segment's (alphas (k_steps, B), betas (k_steps, B)) along with the
    new carry — concatenating segment outputs reproduces
    `_lanczos_batched` exactly (same recurrence, same carry)."""
    def body(carry, _):
        V_prev, V_cur, beta_prev = carry
        W = matmat(V_cur) - beta_prev[None, :] * V_prev
        alpha = jnp.sum(W * V_cur, axis=0)
        W = W - alpha[None, :] * V_cur
        beta = jnp.linalg.norm(W, axis=0)
        V_next = jnp.where(beta[None, :] > 1e-10,
                           W / jnp.where(beta > 0, beta, 1.0)[None, :],
                           jnp.zeros_like(W))
        return (V_cur, V_next, beta), (alpha, beta)

    carry, (alphas, betas) = lax.scan(body, carry, None, length=k_steps)
    return carry, alphas, betas


def slq_quadrature(alphas, betas, n: int):
    """Gauss quadrature on the (k, B) tridiagonal coefficient stacks:
    mean_z ||z||^2 e1' log(T_z) e1. `betas` is the (k, B) stack whose
    LAST row is unused (matches _lanczos_batched's betas[:-1])."""
    def quad(a_col, b_col):
        T = (jnp.diag(a_col) + jnp.diag(b_col, 1) + jnp.diag(b_col, -1))
        w, V = jnp.linalg.eigh(T)
        w = jnp.maximum(w, 1e-12)
        return jnp.asarray(float(n), jnp.float32) * jnp.sum(
            (V[0, :] ** 2) * jnp.log(w))

    vals = jax.vmap(quad, in_axes=(1, 1))(alphas, betas[:-1])
    return jnp.mean(vals)


def slq_logdet_batched(matmat: Callable, n: int, key, probes: int = 16,
                       lanczos_iters: int = 32):
    """Batched-probe SLQ: all probes ride the same blocked matvecs."""
    Z = jax.random.rademacher(
        key, (n, probes), jnp.float32).astype(jnp.float32)
    alphas, betas = _lanczos_batched(matmat, Z, lanczos_iters)

    def quad(a_col, b_col):
        T = (jnp.diag(a_col) + jnp.diag(b_col, 1) + jnp.diag(b_col, -1))
        w, V = jnp.linalg.eigh(T)
        w = jnp.maximum(w, 1e-12)
        return jnp.asarray(float(n), jnp.float32) * jnp.sum(
            (V[0, :] ** 2) * jnp.log(w))

    vals = jax.vmap(quad, in_axes=(1, 1))(alphas, betas)
    return jnp.mean(vals)


def slq_logdet_preconditioned(op_matmat: Callable, L: jnp.ndarray, sn2,
                              n: int, key, probes: int = 16,
                              lanczos_iters: int = 16):
    """logdet A = logdet P + tr log(P^-1/2 A P^-1/2), with P the
    rank-k pivoted-Cholesky preconditioner (exact logdet via the
    determinant lemma) and SLQ only on the whitened residual operator
    — whose spectrum is clustered at 1, so FEW Lanczos steps and low
    probe variance (Wenger et al. 2022's variance-reduced recipe; cf.
    the raw-A SLQ's large bias at the reference's sn2 = 0.016)."""
    inv_sqrt, logdet_P = precond_sqrt(L, sn2)

    def whitened(V):
        return inv_sqrt(op_matmat(inv_sqrt(V)))

    resid = slq_logdet_batched(whitened, n, key, probes, lanczos_iters)
    return logdet_P + resid


# ---------------------------------------------------------------------------
# chunked differentiable matvec (for gradient contractions)
# ---------------------------------------------------------------------------

def chunked_matvec(params_to_A_row_chunk: Callable, v: jnp.ndarray,
                   n_chunks: int):
    """y = A v with A produced chunk-of-rows at a time (differentiable;
    O(chunk x N) live memory under jax.remat)."""
    chunks = jnp.arange(n_chunks)

    def one(c):
        A_chunk = params_to_A_row_chunk(c)          # (chunk, n)
        return jnp.matmul(A_chunk, v,
                          precision=jax.lax.Precision.HIGHEST)

    ys = lax.map(jax.remat(one), chunks)
    return ys.reshape(-1)


class IterStats(NamedTuple):
    """Solve diagnostics + alpha from one fused NLML+grad evaluation."""

    cg_iters: jnp.ndarray
    rel_residual: jnp.ndarray
    alpha: jnp.ndarray


class IterativeGP(NamedTuple):
    """Factory bundle for the matrix-free flagship (ExpAns+Bias)."""

    Xm: jnp.ndarray        # metric-mapped recentred points (n, d)
    sigma: jnp.ndarray
    bias: jnp.ndarray
    sn2: jnp.ndarray


#: operator-mode size thresholds (auto selection) for a device with
#: 16 GB of memory, with headroom for solver state:
#:   chol : A + L both live in f32 during the factorization (8 N^2 B)
#:   gemm : A in f32 (4 N^2 B)  /  gemm_bf16 : A in bf16 (2 N^2 B)
#: When the local device reports its memory limit (memory_stats), the
#: thresholds are rescaled by sqrt(limit / 16 GB); devices that don't
#: report (CPU) keep the 16 GB values.
CHOL_MATERIALIZE_MAX_N = 32768
GEMM_MATERIALIZE_MAX_N_F32 = 49152
GEMM_MATERIALIZE_MAX_N_BF16 = 73728
_REFERENCE_MEM_BYTES = 16e9

#: the achievable relative residual of CG over a bf16-stored operator:
#: cg_tol below this just stalls PCG to cg_maxiter (ADVICE r2 medium)
BF16_CG_TOL_FLOOR = 1e-3


@functools.lru_cache(maxsize=1)
def _mode_thresholds():
    """(chol_max, gemm_max, bf16_max), memory-scaled when reported."""
    scale = 1.0
    try:
        stats = jax.local_devices()[0].memory_stats() or {}
        limit = stats.get("bytes_limit")
        if limit:
            scale = math.sqrt(limit / _REFERENCE_MEM_BYTES)
    except Exception:
        pass
    def rnd(x):
        return max(1024, int(x * scale) // 1024 * 1024)
    return (rnd(CHOL_MATERIALIZE_MAX_N),
            rnd(GEMM_MATERIALIZE_MAX_N_F32),
            rnd(GEMM_MATERIALIZE_MAX_N_BF16))


def choose_mode(n: int, mode: str = "auto") -> str:
    """Resolve the engine mode for problem size n.

    Modes:
      chol      — materialize A (plain Gram build), exact Cholesky:
                  exact alpha/logdet, Hutchinson gradient with EXACT
                  probe solves (no CG, no SLQ bias).
      gemm      — materialize A in f32; PCG + SLQ run as GEMMs.
      gemm_bf16 — OPT-IN ONLY (never picked by auto): A in bfloat16.
                  The ~0.4% entrywise quantization of K has spectral
                  norm ~ 0.002 sqrt(N) — at the flagship noise
                  (sn2 = 0.016) that swamps the smallest eigenvalues
                  of A beyond N ~ 10^3, pushing A_bf16 indefinite and
                  biasing the SLQ logdet by O(100s of nats). CG solves
                  remain residual-corrected and fit-grade; the VALUE
                  is not trustworthy. Use for gradient-only work.
      stream    — never materialize: streamed Gram tiles per matvec
                  (ops/matvec.py; the option past the gemm size).
    """
    if mode != "auto":
        valid = ("chol", "gemm", "gemm_bf16", "stream")
        if mode not in valid:
            raise ValueError(f"mode must be one of {valid} or 'auto'")
        return mode
    chol_max, gemm_max, _bf16_max = _mode_thresholds()
    if n <= chol_max:
        return "chol"
    if n <= gemm_max:
        return "gemm"
    return "stream"


def _effective_cg_tol(cg_tol: float, mode: str) -> float:
    return max(cg_tol, BF16_CG_TOL_FLOOR) if mode == "gemm_bf16" \
        else cg_tol


def _flagship_operator(it_gp: IterativeGP, mode: str = "stream"):
    from gp_ss_ak_tpu.ops.matvec import MaterializedOperator, MatvecOperator

    if mode in ("gemm", "gemm_bf16"):
        dt = jnp.float32 if mode == "gemm" else jnp.bfloat16
        return MaterializedOperator(it_gp.Xm, it_gp.sigma, it_gp.bias,
                                    it_gp.sn2, store_dtype=dt)
    return MatvecOperator(it_gp.Xm, it_gp.sigma, it_gp.bias, it_gp.sn2)


def make_preconditioner(it_gp: IterativeGP, rank=None):
    """rank-`rank` pivoted-Cholesky Woodbury preconditioner for
    A = K + sn2 I (None rank -> auto_precond_rank(n); 0 disables)."""
    L = _pivchol(it_gp, rank)
    if L is None:
        return None
    return woodbury_preconditioner(L, it_gp.sn2)


def auto_precond_rank(n: int) -> int:
    """N-scaled default preconditioner rank. The flagship ExpAns
    (Matern-1/2) kernel's eigenvalues decay only polynomially
    (lambda_k ~ k^(-4/3) for 3-D inputs), so a FIXED rank that works
    at N=4k leaves kappa ~ lambda_k/sn2 huge at 50k+: a rank-64 PCG
    can run to maxiter=800 at N ~ 50k, while a rank that keeps pace
    with N converges in a few hundred.

    The rank is cheap relative to what it saves: each doubling cuts
    whitened-CG iterations roughly 1.5x (kappa of the whitened
    operator is (lambda_k + sn2)/sn2), the pivoted build is
    O(n k (d + k)) once per hyperparameter setting, and each
    P^(-1/2) apply is O(n k) — noise next to the O(n^2) operator pass
    it replaces. So the rule leans high: every CG iteration saved is
    a full pass over the Gram tiles."""
    return max(64, min(1024, n // 48))


def _pivchol(it_gp: IterativeGP, rank):
    if rank is None:
        rank = auto_precond_rank(it_gp.Xm.shape[0])
    if not rank:
        return None
    return pivoted_cholesky(it_gp.Xm, it_gp.sigma, it_gp.bias, rank)


def nlml_iterative(it_gp: IterativeGP, y, key, cg_tol: float = 1e-4,
                   cg_maxiter: int = 800, probes: int = 16,
                   lanczos_iters: int = 32, precond_rank=None,
                   mode: str = "auto"):
    """Matrix-free NLML: 1/2 y'alpha + 1/2 slq_logdet + n/2 log 2pi.
    Returns (value, alpha, cg_iters).

    `mode` (see `choose_mode`; default "auto", same as the fused
    nlml_and_grad_iterative so both paths pick the same operator):
    "chol" computes the exact value via a materialized Cholesky;
    "gemm"/"gemm_bf16" materialize A and run the same PCG+SLQ estimate
    at GEMM speed; pass "stream" for the historical streamed path.

    `precond_rank` > 0 runs the solves as PCG with a rank-k
    pivoted-Cholesky Woodbury preconditioner (the BBMM recipe): at the
    reference's small default noise (sn2 = 0.016) plain CG needs
    O(sqrt(kappa)) ~ hundreds of iterations, the preconditioned solve
    tens. The logdet then uses the variance-reduced split
    logdet P + SLQ(P^-1/2 A P^-1/2) — the raw-A SLQ carries a large
    bias at small sn2. All probe work runs through blocked matvecs
    (op.matmat) so probes share the Gram-tile streaming."""
    y = jnp.asarray(y, jnp.float32)
    n = y.shape[0]
    mode = choose_mode(n, mode)
    if mode == "chol":
        Lc, half_logdet = _materialized_chol(it_gp)
        alpha = jax.scipy.linalg.cho_solve((Lc, True), y)
        val = 0.5 * jnp.dot(y, alpha) + half_logdet \
            + 0.5 * n * math.log(2.0 * math.pi)
        return val, alpha, jnp.asarray(0)
    op = _flagship_operator(it_gp, mode=mode)
    cg_tol = _effective_cg_tol(cg_tol, mode)
    L = _pivchol(it_gp, precond_rank)
    if L is None:
        alpha, it, _ = cg_solve(op, y, tol=cg_tol, maxiter=cg_maxiter)
        half_logdet = 0.5 * slq_logdet_batched(
            op.matmat, n, key, probes, lanczos_iters)
    else:
        sols, it, _rel, logdet_P, wmm = whitened_solve_info(
            op.matmat, L, it_gp.sn2, y[:, None], tol=cg_tol,
            maxiter=cg_maxiter)
        alpha = sols[:, 0]
        half_logdet = 0.5 * (logdet_P + slq_logdet_batched(
            wmm, n, key, probes, lanczos_iters))
    val = 0.5 * jnp.dot(y, alpha) + half_logdet \
        + 0.5 * n * math.log(2.0 * math.pi)
    return val, alpha, it


def grad_iterative(it_gp: IterativeGP, y, key, alpha=None,
                   probes: int = 8, cg_tol: float = 1e-4,
                   cg_maxiter: int = 800, chunk: int = 1024,
                   precond_rank=None, mode: str = "auto"):
    """d NLML / d (sigma, bias, sn2, Xm) via Hutchinson + fit term:

      grad = 1/2 E_z [ (A^-1 z)' dA z ]  -  1/2 alpha' dA alpha

    with the A-dependence differentiated through a chunked dense row
    build (kernel math identical to the streamed forward).

    `mode` follows `choose_mode` like the fused path: "chol" does exact
    cho_solve probe solves; "gemm"/"gemm_bf16" run the batched PCG over
    the materialized operator."""
    y = jnp.asarray(y, jnp.float32)
    n = y.shape[0]
    mode = choose_mode(n, mode)
    Z = jax.random.rademacher(
        key, (n, probes), jnp.float32).astype(jnp.float32)
    if mode == "chol":
        L, _ = _materialized_chol(it_gp)
        if alpha is None:
            sols = jax.scipy.linalg.cho_solve(
                (L, True), jnp.concatenate([y[:, None], Z], axis=1))
            alpha, ws = sols[:, 0], sols[:, 1:].T
        else:
            ws = jax.scipy.linalg.cho_solve((L, True), Z).T
        return _grad_contraction(it_gp, alpha, ws, Z.T, chunk)
    op = _flagship_operator(it_gp, mode=mode)
    cg_tol = _effective_cg_tol(cg_tol, mode)
    L = _pivchol(it_gp, precond_rank)

    def _solve(B):
        if L is None:
            return bcg_solve(op.matmat, B, None, tol=cg_tol,
                             maxiter=cg_maxiter)[0]
        return whitened_solve_info(op.matmat, L, it_gp.sn2, B,
                                   tol=cg_tol, maxiter=cg_maxiter)[0]

    if alpha is None:
        # alpha rides the same blocked solve as the probes
        sols = _solve(jnp.concatenate([y[:, None], Z], axis=1))
        alpha, ws = sols[:, 0], sols[:, 1:].T
    else:
        ws = _solve(Z).T
    return _grad_contraction(it_gp, alpha, ws, Z.T, chunk)


def _grad_contraction(it_gp: IterativeGP, alpha, ws, zs, chunk: int):
    """The differentiable part of the gradient: given the solved
    alpha = A^-1 y and probe pairs (w = A^-1 z, z), contract against
    dA/dtheta through a chunked dense row build (O(chunk x N) live
    memory under remat; kernel math identical to the streamed forward).

    grad = d/dtheta [ 1/2 mean_z w' A(theta) z - 1/2 alpha' A alpha ]
         = d/dtheta [ 1/2 sum_j c_j U[:,j]' (A V)[:,j] ]
    with U = [w_1..w_m, alpha], V = [z_1..z_m, alpha],
    c = [1/m.., -1] — ONE chunked pass over the Gram rows carries all
    m+1 contraction columns (the row build, not the GEMM, dominates)."""
    n = alpha.shape[0]
    m = ws.shape[0]
    U = lax.stop_gradient(
        jnp.concatenate([ws.T, alpha[:, None]], axis=1))    # (n, m+1)
    V = lax.stop_gradient(
        jnp.concatenate([zs.T, alpha[:, None]], axis=1))    # (n, m+1)
    coef = jnp.concatenate([jnp.full((m,), 1.0 / m, jnp.float32),
                            jnp.full((1,), -1.0, jnp.float32)])

    npad = ((n + chunk - 1) // chunk) * chunk
    Vp = jnp.zeros((npad, m + 1), jnp.float32).at[:n].set(V)
    Up = jnp.zeros((npad, m + 1), jnp.float32).at[:n].set(U)
    valid = (jnp.arange(npad) < n)

    def contraction(theta):
        sigma, bias, sn2, Xm_ = theta
        Xp_ = jnp.zeros((npad, Xm_.shape[1]), jnp.float32).at[:n].set(Xm_)

        def row_chunk(c):
            start = c * chunk
            rows = lax.dynamic_slice_in_dim(Xp_, start, chunk)  # (chunk, d)
            d2 = gram_sqdist(rows, Xp_)
            g0 = start + jnp.arange(chunk)
            on_diag = g0[:, None] == jnp.arange(npad)[None, :]
            r = jnp.sqrt(jnp.where(on_diag, 1.0, jnp.maximum(d2, 1e-30)))
            k = sigma * sigma * jnp.where(on_diag, 1.0, jnp.exp(-r))
            k = k + bias + sn2 * on_diag
            mask = lax.dynamic_slice_in_dim(valid, start, chunk)[:, None] \
                & valid[None, :]
            return jnp.where(mask, k, 0.0)

        def one(c):
            # (chunk, m+1) = rows of A V, contracted against U rows;
            # full f32 precision (no TF32) — the gradient pass is one
            # of ~100 operator passes per eval
            AVc = jnp.matmul(row_chunk(c), Vp,
                             precision=jax.lax.Precision.HIGHEST)
            Uc = lax.dynamic_slice_in_dim(Up, c * chunk, chunk)
            return jnp.sum(Uc * AVc, axis=0)                # (m+1,)

        per_col = lax.map(jax.remat(one), jnp.arange(npad // chunk))
        return 0.5 * jnp.dot(jnp.sum(per_col, axis=0), coef)

    theta0 = (it_gp.sigma, it_gp.bias, it_gp.sn2, it_gp.Xm)
    return jax.grad(contraction)(theta0)


def _materialized_chol(it_gp: IterativeGP):
    """Build A with the plain Gram (ops/gram.py) and factor it.
    Returns (L, half_logdet). A is dead after the factorization, so
    peak memory is A + L (8 N^2 bytes)."""
    from gp_ss_ak_tpu.ops.gram import expans_bias_gram

    A = expans_bias_gram(it_gp.Xm, it_gp.sigma, it_gp.bias, it_gp.sn2)
    L = jnp.linalg.cholesky(A)
    half_logdet = jnp.sum(jnp.log(jnp.diagonal(L)))
    return L, half_logdet


def nlml_and_grad_chol(it_gp: IterativeGP, y, key_trace,
                       probes: int = 16, chunk: int = 1024):
    """Materialized exact-Cholesky NLML + Hutchinson gradient.

    alpha and logdet are EXACT (dense factorization of the materialized
    A); the only stochastic piece is the Hutchinson estimate of
    tr(A^-1 dA) in the gradient, whose probe solves are exact
    triangular solves (cho_solve) instead of CG. Compared to the
    CG+SLQ path this removes the SLQ logdet bias entirely and replaces
    ~50-70 O(N^2) operator passes with one Gram build + one O(N^3/3)
    Cholesky — the most accurate option whenever A + L fit in device
    memory.

    Returns (value, (d_sigma, d_bias, d_sn2, d_Xm), alpha).
    A failed factorization propagates NaN into the value — the
    optimizers' NaN-rejection protocol (reference behavior,
    GP_Utils.cpp:884-887) handles it.
    """
    y = jnp.asarray(y, jnp.float32)
    n = y.shape[0]
    L, half_logdet = _materialized_chol(it_gp)
    Z = jax.random.rademacher(
        key_trace, (n, probes), jnp.float32).astype(jnp.float32)
    rhs = jnp.concatenate([y[:, None], Z], axis=1)
    sols = jax.scipy.linalg.cho_solve((L, True), rhs)
    alpha, ws = sols[:, 0], sols[:, 1:].T
    val = 0.5 * jnp.dot(y, alpha) + half_logdet \
        + 0.5 * n * math.log(2.0 * math.pi)
    grads = _grad_contraction(it_gp, alpha, ws, Z.T, chunk)
    return val, grads, alpha


def nlml_and_grad_iterative(it_gp: IterativeGP, y, key_logdet, key_trace,
                            cg_tol: float = 1e-4, cg_maxiter: int = 800,
                            probes: int = 8, lanczos_iters: int = 32,
                            chunk: int = 1024, precond_rank=None,
                            slq_probes: int = 64,
                            mode: str = "auto"):
    """Fused NLML + gradient, sharing every expensive intermediate:

      * the pivoted Cholesky L is built ONCE (nlml_iterative +
        grad_iterative each built their own),
      * alpha = A^-1 y rides the SAME batched PCG as the Hutchinson
        probe solves — [y | Z] in lock-step, so the y-solve costs no
        extra passes over the streamed Gram tiles.

    `slq_probes` sets the logdet probe count separately from the
    gradient's `probes`: the batched Lanczos cost is nearly flat in
    its probe count (the Gram-tile streaming dominates), so the logdet
    gets many probes cheaply while each gradient probe adds a column
    to the PCG solve.

    `mode` picks the operator strategy (see `choose_mode`): "chol"
    short-circuits to `nlml_and_grad_chol` (exact value, exact probe
    solves); "gemm"/"gemm_bf16" materialize A once and run the same
    CG+SLQ flow at GEMM speed; "stream" never materializes. "auto"
    resolves by N against the memory-scaled thresholds.

    Returns (value, (d_sigma, d_bias, d_sn2, d_Xm), stats) with
    stats = IterStats(cg_iters, rel_residual, alpha): rel_residual is
    the worst-column achieved ||r||/||b|| of the solve (0.0 on the
    exact chol path); alpha = A^-1 y is exposed for likelihood-level
    chain rules (the warped-Gaussian fit term's gradient is
    alpha' dgy/dw — optim/iterative_fit)."""
    y = jnp.asarray(y, jnp.float32)
    n = y.shape[0]
    mode = choose_mode(n, mode)
    if mode == "chol":
        val, grads, alpha = nlml_and_grad_chol(
            it_gp, y, key_trace, probes=probes, chunk=chunk)
        return val, grads, IterStats(jnp.asarray(0),
                                     jnp.asarray(0.0, jnp.float32),
                                     alpha)
    op = _flagship_operator(it_gp, mode=mode)
    cg_tol = _effective_cg_tol(cg_tol, mode)
    L = _pivchol(it_gp, precond_rank)
    Z = jax.random.rademacher(
        key_trace, (n, probes), jnp.float32).astype(jnp.float32)
    rhs = jnp.concatenate([y[:, None], Z], axis=1)
    if L is None:
        sols, it, rel = bcg_solve_info(op.matmat, rhs, None, tol=cg_tol,
                                       maxiter=cg_maxiter)
        half_logdet = 0.5 * slq_logdet_batched(
            op.matmat, n, key_logdet, slq_probes, lanczos_iters)
    else:
        # explicitly whitened CG (see whitened_solve_info): the
        # implicit-PCG recurrence is f32-unstable at this kappa; the
        # SLQ rides the same whitened operator (one shared Q/eig build)
        sols, it, rel, logdet_P, wmm = whitened_solve_info(
            op.matmat, L, it_gp.sn2, rhs, tol=cg_tol,
            maxiter=cg_maxiter)
        half_logdet = 0.5 * (logdet_P + slq_logdet_batched(
            wmm, n, key_logdet, slq_probes, lanczos_iters))
    alpha, ws = sols[:, 0], sols[:, 1:].T
    val = 0.5 * jnp.dot(y, alpha) + half_logdet \
        + 0.5 * n * math.log(2.0 * math.pi)
    grads = _grad_contraction(it_gp, alpha, ws, Z.T, chunk)
    return val, grads, IterStats(it, rel, alpha)

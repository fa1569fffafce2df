"""Segmented matrix-free NLML + gradient: bounded-time dispatches.

The fused evaluator (optim/iterative_fit.py) runs one NLML+grad as ONE
jitted program; in stream mode that single dispatch is an up to
800-iteration PCG while_loop of full O(N^2) Gram-tile passes, which
cannot be observed or checkpointed until it returns. This driver
computes the SAME estimator (same probe keys, same math — see
test_segmented_matches_fused) as a host loop over bounded jit
segments, carrying the solver state between dispatches, so each
dispatch has a bounded duration and the solver state can be inspected
or saved in the middle of an evaluation:

  setup     one dispatch: metric map (the streamed operator's state
            is the mapped points and s^2), pivoted Cholesky L,
            P^(-1/2) spectral pieces, whitened rhs.
  bcg       `seg_iters` whitened-CG iterations per dispatch on
            P^(-1/2)[y | Z_grad] (plain CG on P^(-1/2) A P^(-1/2) —
            the f32-stable route, inference.iterative
            .whitened_solve_info; the state tuple IS the while_loop
            carry, so resuming is bit-identical to an uninterrupted
            solve).
  slq       `seg_iters` whitened Lanczos steps per dispatch
            (lanczos_batched_init/segment), quadrature at the end.
  grad      one dispatch: the chunked Hutchinson/fit-term contraction
            (_grad_contraction) + metric-map pullback.

Segment programs take the operator state as ARGUMENTS, so they
compile once and are reused for every evaluation of a fit. Each
dispatch is O(seg_iters) Gram passes.

Scaled-up surface: the reference's NLML hot loop (GP_Utils.cpp:872-915,
1138-1162) at BASELINE config-3 N, on one device.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from gp_ss_ak_tpu.inference.iterative import (
    IterativeGP,
    _grad_contraction,
    auto_precond_rank,
    bcg_done,
    bcg_init,
    bcg_rel_residual,
    bcg_segment,
    lanczos_batched_init,
    lanczos_batched_segment,
    pivoted_cholesky,
    precond_sqrt_apply,
    precond_sqrt_fwd_apply,
    precond_sqrt_pieces,
    slq_quadrature,
)
from gp_ss_ak_tpu.model import GPModel
from gp_ss_ak_tpu.ops.gram import mapped_points
from gp_ss_ak_tpu.ops.matvec import streamed_matmat
from gp_ss_ak_tpu.optim.iterative_fit import supports_iterative


def make_segmented_value_and_grad(
    model: GPModel,
    X,
    y,
    seed: int = 0,
    probes: int = 8,
    lanczos_iters: int = 16,
    cg_tol: float = 1e-3,
    cg_maxiter: int = 800,
    chunk: int = 1024,
    jitter: float = 0.0,
    precond_rank=None,
    slq_probes: int = 32,
    seg_iters: int = 16,
    warm_start: bool = True,
):
    """Host-callable (f, g) with the fused stream evaluator's contract
    (same flagship restriction, same fixed probe keys → deterministic
    objective) but split into bounded dispatches. The defaults are
    the settings for the N >~ 10^5 stream regime.

    Determinism caveat: with `warm_start=True` (the default) each CG
    solve starts from the previous evaluation's solution, so
    re-evaluating the same hyper vector after a DIFFERENT one returns
    a value/gradient that differs at the CG-tolerance level (the
    converged solutions agree to `cg_tol`, not bitwise). The fixed
    probe keys keep the *estimator* deterministic; the warm start
    makes the *solver path* history-dependent. If an optimizer
    line-search anomaly needs ruling out, pass `warm_start=False` for
    a bitwise path-independent objective (each eval then pays full
    CG iterations from zero)."""
    from gp_ss_ak_tpu.inference.likelihoods import Gaussian

    if not (supports_iterative(model)
            and isinstance(model.likelihood, Gaussian)):
        raise ValueError(
            "segmented engine supports only Sum([ExpAns, Bias]) + "
            "plain Gaussian likelihood (the fused evaluator also "
            f"handles WarpedGaussian); got {model.kernel!r} / "
            f"{type(model.likelihood).__name__}")
    kernel = model.kernel
    expans = kernel.children[0]
    nk = kernel.n_params
    Xd = jnp.asarray(X, jnp.float32)
    yd = jnp.asarray(y, jnp.float32)
    n = Xd.shape[0]
    rank = auto_precond_rank(n) if precond_rank is None else precond_rank
    if not rank:
        raise ValueError("segmented driver requires precond_rank > 0")
    key_logdet, key_trace = jax.random.split(jax.random.PRNGKey(seed))
    # fixed probes, drawn once — same keys/shapes as the fused path
    Z_grad = jax.random.rademacher(
        key_trace, (n, probes), jnp.float32).astype(jnp.float32)
    Z_slq = jax.random.rademacher(
        key_logdet, (n, slq_probes), jnp.float32).astype(jnp.float32)

    def _wmm(Xm, s2, bias, sn2, Q, inv_eig, V):
        """Whitened operator P^(-1/2) A P^(-1/2) (the f32-stable solve
        route, inference.iterative.whitened_solve_info — the implicit
        PCG recurrence breaks down at the flagship conditioning)."""
        pv = precond_sqrt_apply(Q, inv_eig, sn2, V)
        av = streamed_matmat(Xm, s2, bias, sn2, pv)
        return precond_sqrt_apply(Q, inv_eig, sn2, av)

    @jax.jit
    def setup_fn(flat):
        ep, bp = kernel.unpack(flat[:nk])
        sn2 = flat[nk] + jnp.float32(jitter)
        sigma, bias = ep["Sigma"], bp["Sigma"]
        Xm = mapped_points(expans, ep, Xd)
        L = pivoted_cholesky(Xm, sigma, bias, rank)
        Q, inv_eig, logdet_P = precond_sqrt_pieces(L, sn2)
        rhs_w = precond_sqrt_apply(
            Q, inv_eig, sn2,
            jnp.concatenate([yd[:, None], Z_grad], axis=1))
        carry = lanczos_batched_init(Z_slq)
        return (Xm, sigma * sigma, bias, sn2, Q, inv_eig,
                logdet_P, rhs_w, carry)

    @jax.jit
    def cold_init_fn(rhs_w):
        return bcg_init(rhs_w, None, cg_tol)

    @jax.jit
    def warm_init_fn(Xm, s2, bias, sn2, Q, inv_eig, rhs_w, prev_sols):
        """Warm start from the PREVIOUS eval's (unwhitened) solutions:
        consecutive line-search hypers are nearby, so A^-1 b barely
        moves — carrying x_prev into the new whitening basis
        (x0_w = P^(1/2) x_prev) typically saves a large fraction of
        the CG passes, at the cost of ONE extra operator pass for the
        true residual. The convergence contract (relative to ||b||)
        and best-iterate guarantee are unchanged (bcg_init)."""
        X0 = precond_sqrt_fwd_apply(Q, inv_eig, sn2, prev_sols)
        R0 = rhs_w - _wmm(Xm, s2, bias, sn2, Q, inv_eig, X0)
        return bcg_init(rhs_w, None, cg_tol, X0=X0, R0=R0)

    @jax.jit
    def bcg_seg_fn(Xm, s2, bias, sn2, Q, inv_eig, state, thresh,
                   it_cap):
        wmm = functools.partial(_wmm, Xm, s2, bias, sn2, Q, inv_eig)
        return bcg_segment(wmm, None, state, thresh, it_cap)

    @jax.jit
    def bcg_status_fn(state, thresh):
        return (bcg_done(state, thresh, pinv=None), state[5],
                bcg_rel_residual(state, thresh, cg_tol))

    @jax.jit
    def unwhiten_fn(Q, inv_eig, sn2, Xbest):
        return precond_sqrt_apply(Q, inv_eig, sn2, Xbest)

    @functools.partial(jax.jit, static_argnums=(7,))
    def slq_seg_fn(Xm, s2, bias, sn2, Q, inv_eig, carry, k_steps):
        wmm = functools.partial(_wmm, Xm, s2, bias, sn2, Q, inv_eig)
        return lanczos_batched_segment(wmm, carry, k_steps)

    @jax.jit
    def value_fn(alpha, alphas, betas, logdet_P):
        resid = slq_quadrature(alphas, betas, n)
        half_logdet = 0.5 * (logdet_P + resid)
        return 0.5 * jnp.dot(yd, alpha) + half_logdet \
            + 0.5 * n * math.log(2.0 * math.pi)

    @jax.jit
    def grad_fn(flat, alpha, ws):
        ep, bp = kernel.unpack(flat[:nk])
        sn2 = flat[nk] + jnp.float32(jitter)
        Xm, pullback = jax.vjp(lambda e: mapped_points(expans, e, Xd),
                               ep)
        it_gp = IterativeGP(Xm=Xm, sigma=ep["Sigma"],
                            bias=bp["Sigma"], sn2=sn2)
        ds, db, dsn2, dXm = _grad_contraction(it_gp, alpha, ws,
                                              Z_grad.T, chunk)
        (d_ep,) = pullback(dXm)
        d_ep = dict(d_ep)
        d_ep["Sigma"] = d_ep["Sigma"] + ds
        g_kernel = kernel.pack((d_ep, {"Sigma": db}))
        return jnp.concatenate([g_kernel, jnp.reshape(dsn2, (1,))])

    def value_and_grad(x_np: np.ndarray):
        flat = jnp.asarray(x_np, jnp.float32)
        (Xm, s2, bias, sn2, Q, inv_eig,
         logdet_P, rhs_w, carry) = setup_fn(flat)
        prev = value_and_grad._prev_sols
        if prev is not None and warm_start:
            state, thresh = warm_init_fn(Xm, s2, bias, sn2, Q, inv_eig,
                                         rhs_w, prev)
        else:
            state, thresh = cold_init_fn(rhs_w)

        it = 0
        rel = None
        while it < cg_maxiter:
            cap = min(it + seg_iters, cg_maxiter)
            state = bcg_seg_fn(Xm, s2, bias, sn2, Q, inv_eig, state,
                               thresh, cap)
            done, it_arr, rel_arr = bcg_status_fn(state, thresh)
            it = int(it_arr)
            rel = float(rel_arr)
            if bool(done):
                break
        sols = unwhiten_fn(Q, inv_eig, sn2, state[6])  # best iterates
        value_and_grad._prev_sols = sols
        alpha, ws = sols[:, 0], sols[:, 1:].T

        alphas_parts, betas_parts = [], []
        k_left = lanczos_iters
        while k_left > 0:
            k_step = min(seg_iters, k_left)
            carry, a_seg, b_seg = slq_seg_fn(
                Xm, s2, bias, sn2, Q, inv_eig, carry, k_step)
            alphas_parts.append(a_seg)
            betas_parts.append(b_seg)
            k_left -= k_step
        alphas = jnp.concatenate(alphas_parts, axis=0)
        betas = jnp.concatenate(betas_parts, axis=0)

        v = value_fn(alpha, alphas, betas, logdet_P)
        g = grad_fn(flat, alpha, ws)
        value_and_grad.last_cg_iters = it
        value_and_grad.last_rel_residual = rel
        return float(v), np.asarray(g, np.float64)

    value_and_grad.last_cg_iters = None
    value_and_grad.last_rel_residual = None
    value_and_grad.precond_rank = rank
    value_and_grad._prev_sols = None
    return value_and_grad

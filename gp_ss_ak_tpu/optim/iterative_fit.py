"""Matrix-free fit engine: hyperparameter value_and_grad in the FLAT
space via CG + stochastic Lanczos (inference/iterative.py), chained
back through the metric map so the box-constrained optimizers
(optim/lbfgsb.py, optim/scg.py) can drive it unchanged.

This is the large-N training route (N ~ 10^4..10^5+ on one device) for
the CLI's flagship model — Sum([ExpAns, Bias]) with a Gaussian
likelihood (gp_ss_ak.cpp:146-190) — where the dense NLML
(inference/gaussian.py) cannot hold the N x N Gram matrix. The chain
rule split:

  flat = [8 ExpAns params, bias, sn2]
  Xm(angles, widths)  = (X - mean X) @ M            (ops/gram.py)
  NLML(Xm, sigma, bias, sn2)                        (iterative.py)
  d NLML/d angles,widths = vjp of Xm pullback of d NLML/d Xm
  d NLML/d sigma,bias,sn2 = direct from grad_iterative

The SLQ logdet and Hutchinson trace use a PRNG key FIXED per fit, so
the objective seen by the line search is deterministic (a biased but
self-consistent estimate — the standard BBMM/GPyTorch trick).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from gp_ss_ak_tpu.inference.iterative import (
    IterativeGP,
    nlml_and_grad_iterative,
)
from gp_ss_ak_tpu.inference.likelihoods import Gaussian, WarpedGaussian
from gp_ss_ak_tpu.model import GPModel
from gp_ss_ak_tpu.ops.gram import _is_flagship, mapped_points

#: above this N, fit(engine="auto") prefers the matrix-free route
#: (dense needs several N^2 f32 buffers, ~1 GB each at N=16k, and its
#: Cholesky time grows as N^3)
DENSE_MAX_N = 16384


def supports_iterative(model: GPModel) -> bool:
    # the engine assumes flat = [kernel params..., lik hypers] exactly:
    # a model carrying mean hypers would get a short gradient.
    # WarpedGaussian rides the same conjugate algebra on g(y) with an
    # alpha-based chain rule for the warp hypers — a capability the
    # reference EXITS on (GP_Utils.cpp:865-869, "not implemented")
    lik = model.likelihood
    return (_is_flagship(model.kernel)
            and isinstance(lik, (Gaussian, WarpedGaussian))
            and model.n_params == model.kernel.n_params + lik.n_hypers)


def make_iterative_value_and_grad(
    model: GPModel,
    X,
    y,
    seed: int = 0,
    probes: int = 8,
    lanczos_iters: int = 32,
    cg_tol: float = 1e-4,
    cg_maxiter: int = 800,
    chunk: int = 1024,
    jitter: float = 0.0,
    precond_rank=None,
    slq_probes: int = 64,
    mode: str = "auto",
):
    """Host-callable (f, g) over ONE jitted matrix-free program.

    `jitter` is folded into the operator's noise (sn2 + jitter), the
    matrix-free analogue of the dense engine adding jitter*I to A.
    `precond_rank` > 0 turns every CG solve into PCG with a rank-k
    pivoted-Cholesky Woodbury preconditioner (0 disables it; None
    picks the N-scaled auto rank, inference.iterative.auto_precond_rank).
    `mode` selects the operator strategy (inference.iterative.choose_mode):
    auto materializes A when it fits in device memory — exact Cholesky
    ("chol": exact value, exact probe solves), then GEMM-backed
    PCG+SLQ, and streamed Gram tiles (ops/matvec.py) beyond."""
    if not supports_iterative(model):
        raise ValueError(
            "iterative engine supports only Sum([ExpAns, Bias]) + "
            f"Gaussian likelihood; got {model.kernel!r} / "
            f"{type(model.likelihood).__name__}")
    kernel = model.kernel
    likelihood = model.likelihood
    expans = kernel.children[0]
    nk = kernel.n_params
    nl = likelihood.n_hypers
    warped = isinstance(likelihood, WarpedGaussian)
    Xd = jnp.asarray(X, jnp.float32)
    yd = jnp.asarray(y, jnp.float32)
    key_logdet, key_trace = jax.random.split(jax.random.PRNGKey(seed))

    def vg(flat):
        flat = flat.astype(jnp.float32)
        ep, bp = kernel.unpack(flat[:nk])
        lh = flat[nk : nk + nl]
        if warped:
            ymax = jnp.max(yd)
            gy, lgpy = likelihood.effective_target(lh, yd, ymax)
            sn2 = likelihood.noise_variance(lh) + jnp.float32(jitter)
        else:
            gy, lgpy = yd, jnp.zeros_like(yd)
            sn2 = lh[0] + jnp.float32(jitter)
        Xm, pullback = jax.vjp(lambda e: mapped_points(expans, e, Xd), ep)
        it_gp = IterativeGP(Xm=Xm, sigma=ep["Sigma"], bias=bp["Sigma"],
                            sn2=sn2)
        val, (ds, db, dsn2, dXm), stats = nlml_and_grad_iterative(
            it_gp, gy, key_logdet, key_trace, cg_tol=cg_tol,
            cg_maxiter=cg_maxiter, probes=probes,
            lanczos_iters=lanczos_iters, chunk=chunk,
            precond_rank=precond_rank,
            slq_probes=slq_probes, mode=mode)
        (d_ep,) = pullback(dXm)
        d_ep = dict(d_ep)
        d_ep["Sigma"] = d_ep["Sigma"] + ds
        g_kernel = kernel.pack((d_ep, {"Sigma": db}))
        if warped:
            # the warp term: NLML_w = NLML_gauss(gy(w); sn2(w))
            # - sum log g'(y; w), and d(fit)/dw = alpha' dgy/dw with
            # alpha = A^-1 gy held fixed (A independent of w); the
            # noise chain adds dNLML/dsn2 * dsn2/dw. One jax.grad of
            # this O(n) surrogate carries all three pieces.
            val = val - jnp.sum(lgpy)
            alpha_sg = jax.lax.stop_gradient(stats.alpha)
            dsn2_sg = jax.lax.stop_gradient(dsn2)

            def lik_surrogate(lh_):
                gy_, lgpy_ = likelihood.effective_target(lh_, yd, ymax)
                sn2_ = likelihood.noise_variance(lh_)
                return (jnp.dot(alpha_sg, gy_) - jnp.sum(lgpy_)
                        + dsn2_sg * sn2_)

            g_lik = jax.grad(lik_surrogate)(lh)
        else:
            g_lik = jnp.reshape(dsn2, (1,))
        g = jnp.concatenate([g_kernel, g_lik])
        return val, g, stats.cg_iters, stats.rel_residual

    jitted = jax.jit(vg)

    def value_and_grad(x_np: np.ndarray):
        v, g, it, rel = jitted(jnp.asarray(x_np, jnp.float32))
        value_and_grad.last_cg_iters = int(it)
        value_and_grad.last_rel_residual = float(rel)
        return float(v), np.asarray(g, np.float64)

    from gp_ss_ak_tpu.inference.iterative import auto_precond_rank

    # traceable (flat) -> (value, grad): the hook contract
    # bayes.sample_hyperposterior's nlml_value_and_grad expects — lets
    # HMC/NUTS run every leapfrog through the matrix-free engine
    value_and_grad.traceable = lambda flat: vg(flat)[:2]
    value_and_grad.last_cg_iters = None
    value_and_grad.last_rel_residual = None
    value_and_grad.precond_rank = (
        auto_precond_rank(Xd.shape[0]) if precond_rank is None
        else precond_rank)
    return value_and_grad

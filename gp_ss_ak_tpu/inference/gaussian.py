"""Exact Gaussian(-warped) GP regression: NLML, posterior, prediction.

The reference reaches these quantities through Laplace/IRLS Newton
iteration with a Brent line search (GP_Utils.cpp:180-381); for a
(warped-)Gaussian likelihood that machinery converges to exact GP
regression in one Newton step, so this module implements the closed
form directly: one jitted function of (params, X, y), gradient via
jax.grad.

Equivalence to the reference NLML (GP_Utils.cpp:1138-1162):
with W = 1/sn2, B = I + sqrt(W) K sqrt(W) and alpha solving
(K + sn2 I) alpha = g(y), the reference's
  L = 1/2 alpha^T K alpha - sum lp + sum log diag chol(B)
equals the standard
  L = 1/2 g(y)^T alpha + 1/2 log det(K + sn2 I) + N/2 log 2pi
      - sum log g'(y)
which is what we compute (single Cholesky of A = K + sn2 I).

A failed Cholesky surfaces as NaN in the objective, which the
optimizers reject (the reference's Chol_fail -> NaN protocol,
GP_Utils.cpp:884-887, 1145-1146).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from gp_ss_ak_tpu.inference import warping
from gp_ss_ak_tpu.inference.likelihoods import Gaussian, WarpedGaussian
from gp_ss_ak_tpu.inference.quadrature import gauss_hermite


class Posterior(NamedTuple):
    """Derived GP state (the reference recomputes this on model load —
    model files store only hyperparameters, GP_Utils.cpp:1360-1390)."""

    alpha: jnp.ndarray  # (n,)   (K + sn2 I)^-1 g(y)
    chol: jnp.ndarray   # (n, n) lower Cholesky of K + sn2 I
    gy: jnp.ndarray     # (n,)   effective (possibly warped) targets
    lgpy: jnp.ndarray   # (n,)   log g'(y) (zeros for plain Gaussian)
    y_max: jnp.ndarray = None  # max of RAW targets (rbf warp clamp)
    linv: jnp.ndarray = None   # optional (n, n) L^-1: serving fast path
    # (turns the per-batch O(n^2 m) triangular solve into one GEMM;
    # precomputed once by serve.Predictor)
    nugget: jnp.ndarray = None  # extra diagonal added by robust
    # factorization (utils/psd.py jitter-retry); None on the plain path


def _gram(kernel, params, X, jitter: float = 0.0):
    K = kernel.matrix(params, X, X, same=True)
    if jitter:
        K = K + jitter * jnp.eye(X.shape[0], dtype=K.dtype)
    return K


def factorize(kernel, params, lik_hypers, X, y, likelihood=Gaussian(),
              jitter: float = 0.0, robust: bool = False) -> Posterior:
    """Build alpha and the Cholesky factor of A = K + sn2 I.

    Wrapped in full-f32 matmul precision: a float32 product may
    otherwise run in TF32 on a GPU (about three decimal digits), which
    is enough to push the Gram matrix off positive-definiteness.

    `robust=True` swaps the plain Cholesky for the jitter-retry
    factorization (utils/psd.py): on failure the diagonal nugget is
    escalated geometrically instead of propagating NaN — the serving
    counterpart of the reference's Chol_fail -> NaN -> reject-step
    protocol (GP_Utils.cpp:884-887). The added nugget is reported in
    Posterior.nugget.
    """
    n = X.shape[0]
    if isinstance(likelihood, WarpedGaussian):
        gy, lgpy = likelihood.effective_target(lik_hypers, y)
        sn2 = likelihood.noise_variance(lik_hypers)
    else:
        gy, lgpy = y, jnp.zeros_like(y)
        sn2 = likelihood.noise_variance(lik_hypers)
    with jax.default_matmul_precision("highest"):
        K = _gram(kernel, params, X, jitter)
        A = K + sn2 * jnp.eye(n, dtype=K.dtype)
        if robust:
            from gp_ss_ak_tpu.utils.psd import robust_cholesky

            L, nugget = robust_cholesky(A)
        else:
            L = jnp.linalg.cholesky(A)  # NaN rows on failure -> NaN objective
            nugget = None
        alpha = jax.scipy.linalg.cho_solve((L, True), gy)
    return Posterior(alpha=alpha, chol=L, gy=gy, lgpy=lgpy,
                     y_max=jnp.max(y), nugget=nugget)


@jax.custom_vjp
def _quad_logdet(A, gy):
    """1/2 gy^T A^-1 gy + 1/2 log det A with the closed-form adjoint.

    Backward: dA = ghat * 1/2 (A^-1 - alpha alpha^T), dgy = ghat *
    alpha — the reference's QW algebra (GP_Utils.cpp:1164-1220) as a
    custom VJP. Replaces reverse-mode through the Cholesky (whose
    adjoint is panel-sequential) with one explicit A^-1 built from a
    multi-RHS triangular solve and one GEMM.
    """
    L = jnp.linalg.cholesky(A)
    alpha = jax.scipy.linalg.cho_solve((L, True), gy)
    return 0.5 * jnp.dot(gy, alpha) + jnp.sum(jnp.log(jnp.diagonal(L)))


def _quad_logdet_fwd(A, gy):
    L = jnp.linalg.cholesky(A)
    alpha = jax.scipy.linalg.cho_solve((L, True), gy)
    val = 0.5 * jnp.dot(gy, alpha) + jnp.sum(jnp.log(jnp.diagonal(L)))
    return val, (L, alpha)


def _quad_logdet_bwd(res, ghat):
    L, alpha = res
    n = L.shape[0]
    eye = jnp.eye(n, dtype=L.dtype)
    # A^-1 = L^-T L^-1 via ONE n-RHS triangular solve + one syrk GEMM
    # (instead of the second chained trsm that cho_solve(L, I) would
    # issue).
    Linv = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
    Ainv = jnp.matmul(Linv.T, Linv, precision=jax.lax.Precision.HIGHEST)
    Abar = (0.5 * ghat) * (Ainv - jnp.outer(alpha, alpha))
    return Abar, ghat * alpha


_quad_logdet.defvjp(_quad_logdet_fwd, _quad_logdet_bwd)


def nlml(kernel, params, lik_hypers, X, y, likelihood=Gaussian(),
         jitter: float = 0.0,
         grad_mode: str = "autodiff") -> jnp.ndarray:
    """Negative log marginal likelihood (the minimized objective; the
    reference prints it as "-logL", Opt_pars.cpp:282).

    grad_mode "autodiff": reverse-mode through the Cholesky (default).
    grad_mode "qw": the closed-form QW-contraction adjoint
    (_quad_logdet) — same values, a different backward schedule.
    """
    n = X.shape[0]
    const = 0.5 * n * math.log(2.0 * math.pi)
    if grad_mode == "qw":
        if isinstance(likelihood, WarpedGaussian):
            gy, lgpy = likelihood.effective_target(lik_hypers, y)
            sn2 = likelihood.noise_variance(lik_hypers)
        else:
            gy, lgpy = y, jnp.zeros_like(y)
            sn2 = likelihood.noise_variance(lik_hypers)
        with jax.default_matmul_precision("highest"):
            K = _gram(kernel, params, X, jitter)
            A = K + sn2 * jnp.eye(n, dtype=K.dtype)
            core = _quad_logdet(A, gy)
        return core + const - jnp.sum(lgpy)
    post = factorize(kernel, params, lik_hypers, X, y, likelihood, jitter)
    half_logdet = jnp.sum(jnp.log(jnp.diagonal(post.chol)))
    fit = 0.5 * jnp.dot(post.gy, post.alpha)
    return fit + half_logdet + const - jnp.sum(post.lgpy)


def warped_predictive_mix(likelihood, lik_hypers, mu, var, ymax):
    """20-node Gauss-Hermite push of the LATENT Gaussian through
    g^{-1}; the reference mixes with z = mu + sigma x_k and measures
    the spread around the latent mean (GP_Utils.cpp:1059-1077) —
    replicated exactly. `ymax` is the max of the RAW training targets
    (the rbf family's centre clamp, GP_Utils.cpp:591). Pure function of
    replicated arrays, so it composes with the distributed predictor
    (parallel/nlml.make_dist_predict) as well as the dense one."""
    nodes, weights = gauss_hermite(20)
    nodes = jnp.asarray(nodes, mu.dtype)
    weights = jnp.asarray(weights, mu.dtype)
    sig = jnp.sqrt(var)
    Z = mu[:, None] + sig[:, None] * nodes[None, :]
    G = warping.inverse(
        likelihood.family,
        likelihood.warp_hypers(lik_hypers),
        Z,
        y_train_max=ymax,
    )
    prec = jax.lax.Precision.HIGHEST
    mu_w = jnp.matmul(G, weights, precision=prec)
    var_w = jnp.matmul((G - mu[:, None]) ** 2, weights, precision=prec)
    return mu_w, var_w


def posterior_mean_var(kernel, params, lik_hypers, X, post: Posterior,
                       Xstar, likelihood=Gaussian(), full_cov: bool = False):
    """Latent+noise predictive mean/variance at Xstar.

    Mirrors posteriorMeanVar (GP_Utils.cpp:943-1080): cross-kernel,
    mu = kX^T alpha, whitened solve for the variance with a clamp at 0,
    then + observation noise; warped models push the Gaussian through
    g^{-1} with 20-node Gauss-Hermite quadrature.
    """
    with jax.default_matmul_precision("highest"):
        kX = kernel.matrix(params, X, Xstar, same=False)   # (n, m)
        mu = kX.T @ post.alpha
        kdiag = kernel.diag(params, Xstar)
        if post.linv is not None:
            v = jnp.matmul(post.linv, kX,
                           precision=jax.lax.Precision.HIGHEST)
        else:
            v = jax.scipy.linalg.solve_triangular(post.chol, kX,
                                                  lower=True)
        if full_cov:
            Kss = kernel.matrix(params, Xstar, Xstar, same=True)
            cov = Kss - v.T @ v
            var = jnp.maximum(jnp.diagonal(cov), 0.0)
        else:
            var = jnp.maximum(kdiag - jnp.sum(v * v, axis=0), 0.0)
    sn2 = likelihood.noise_variance(lik_hypers)
    var = var + sn2

    if isinstance(likelihood, WarpedGaussian):
        ymax = post.y_max if post.y_max is not None else jnp.max(post.gy)
        mu_w, var_w = warped_predictive_mix(likelihood, lik_hypers, mu,
                                            var, ymax)
        if full_cov:
            return mu_w, var_w, None
        return mu_w, var_w
    if full_cov:
        return mu, var, cov + sn2 * jnp.eye(cov.shape[0], dtype=cov.dtype)
    return mu, var


def predict(kernel, params, lik_hypers, X, y, Xstar, likelihood=Gaussian(),
            jitter: float = 0.0, full_cov: bool = False):
    """One-shot factorize + predict (the reference's test-mode flow,
    gp_ss_ak.cpp:382-409: load hypers, rebuild alpha/chol, predict)."""
    post = factorize(kernel, params, lik_hypers, X, y, likelihood, jitter)
    return posterior_mean_var(kernel, params, lik_hypers, X, post, Xstar,
                              likelihood, full_cov)

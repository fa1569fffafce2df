"""Laplace (IRLS) approximate inference for general likelihoods.

The reference's inference core is a GPML-style `infLaplace` Newton
iteration on the latent alpha with a Brent line search
(`irls`/`PSI`/`brentmin`, GP_Utils.cpp:180-397). For its shipped
(warped-)Gaussian likelihoods that fixed point is available in closed
form (see inference/gaussian.py), but the framework keeps the general
machinery so non-conjugate likelihoods (Student-t, Poisson, ...) can
ride the same jitted path.

Differences from the reference, by design:
- likelihood derivatives (dlp, d2lp) come from jax.grad of the
  likelihood's log_prob — no hand-derived updatelikelihood tables
  (GP_Utils.cpp:398-432);
- the Newton step uses the exact B-solve, and a *backtracking halving*
  line search on psi replaces Brent's method (golden-section +
  parabolic, GP_Utils.cpp:229-381): with exact Newton steps on a
  log-concave likelihood the unit step almost always wins, and a
  branch-free halving loop maps onto lax.while_loop cleanly;
- everything is a pure function compiled once; the dirty-flag cache
  protocol (GP_Utils.h:257-299) is unnecessary under jit.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class LaplaceState(NamedTuple):
    alpha: jnp.ndarray
    f: jnp.ndarray
    psi: jnp.ndarray
    it: jnp.ndarray


def _derivs(log_prob: Callable, y, f):
    """Per-point lp, dlp = d lp/df, d2lp = d^2 lp/df^2 via jax.grad."""
    lp = log_prob(y, f)
    dlp = jax.grad(lambda ff: jnp.sum(log_prob(y, ff)))(f)
    d2lp = jax.grad(lambda ff: jnp.sum(
        jax.grad(lambda g: jnp.sum(log_prob(y, g)))(ff)))(f)
    return lp, dlp, d2lp


def _psi(K, log_prob, y, alpha, mean):
    f = K @ alpha + mean
    lp = log_prob(y, f)
    return 0.5 * jnp.dot(alpha, K @ alpha) - jnp.sum(lp), f


def fit_latent(K: jnp.ndarray, y: jnp.ndarray, log_prob: Callable,
               mean: jnp.ndarray = None, maxit: int = 20,
               tol: float = 1e-6, max_halvings: int = 10):
    """Newton/IRLS for the Laplace mode. Returns (alpha, f_hat, psi).

    Mirrors the convergence policy of GP_Utils.cpp:199-227: maxit=20,
    stop when psi improves by less than tol.
    """
    n = K.shape[0]
    mean = jnp.zeros(n, K.dtype) if mean is None else mean
    alpha0 = jnp.zeros(n, K.dtype)
    psi0, f0 = _psi(K, log_prob, y, alpha0, mean)

    def newton_step(alpha, f):
        _, dlp, d2lp = _derivs(log_prob, y, f)
        W = jnp.maximum(-d2lp, 0.0)  # clamp, GP_Utils.cpp:210-213
        sw = jnp.sqrt(W)
        b = W * (f - mean) + dlp
        Kb = K @ b
        B = jnp.eye(n, dtype=K.dtype) + (sw[:, None] * sw[None, :]) * K
        L = jnp.linalg.cholesky(B)
        t = jax.scipy.linalg.cho_solve((L, True), sw * Kb)
        dalpha = b - sw * t - alpha
        return dalpha

    def body(state: LaplaceState):
        dalpha = newton_step(state.alpha, state.f)

        def ls_cond(carry):
            step, accepted, _, _, _ = carry
            return (~accepted) & (step > 2.0 ** (-max_halvings))

        def ls_body(carry):
            step, accepted, best_step, psi, f = carry
            cand = state.alpha + step * dalpha
            psi_c, f_c = _psi(K, log_prob, y, cand, mean)
            better = psi_c < psi
            return (
                step * 0.5,
                accepted | better,
                jnp.where(better, step, best_step),
                jnp.where(better, psi_c, psi),
                jnp.where(better, f_c, f),
            )

        init = (jnp.asarray(1.0, K.dtype), jnp.asarray(False),
                jnp.asarray(0.0, K.dtype), state.psi, state.f)
        _, _, best_step, psi_new, f_new = lax.while_loop(ls_cond, ls_body, init)
        alpha_new = state.alpha + best_step * dalpha
        return LaplaceState(alpha_new, f_new, psi_new, state.it + 1)

    def scan_body(state, _):
        psi_prev = state.psi
        state = lax.cond(state.it >= maxit, lambda s: s, body, state)
        converged = (psi_prev - state.psi) < tol
        state = LaplaceState(state.alpha, state.f, state.psi,
                             jnp.where(converged, maxit, state.it))
        return state, None

    state = LaplaceState(alpha0, f0, psi0, jnp.asarray(0))
    state, _ = lax.scan(scan_body, state, None, length=maxit)
    return state.alpha, state.f, state.psi


def predict_latent(kernel, params, X, y, log_prob: Callable, Xstar,
                   mean: jnp.ndarray = None, maxit: int = 20):
    """Laplace posterior over latents at Xstar: (mu, var).

    GPML predLaplace structure (mirrored from the reference's
    posteriorMeanVar shape, GP_Utils.cpp:943-1004): mu = kX^T alpha_hat
    with alpha_hat = grad lp(f_hat); var via the whitened B-solve.
    Observation-level moments for non-Gaussian likelihoods are the
    caller's quadrature (inference/quadrature.py has the nodes).
    """
    n = X.shape[0]
    K = kernel.matrix(params, X, X, same=True)
    alpha, f, _ = fit_latent(K, y, log_prob, mean, maxit)
    _, dlp, d2lp = _derivs(log_prob, y, f)
    W = jnp.maximum(-d2lp, 0.0)
    sw = jnp.sqrt(W)
    B = jnp.eye(n, dtype=K.dtype) + (sw[:, None] * sw[None, :]) * K
    L = jnp.linalg.cholesky(B)
    kX = kernel.matrix(params, X, Xstar, same=False)
    mu = kX.T @ dlp
    v = jax.scipy.linalg.solve_triangular(L, sw[:, None] * kX, lower=True)
    kdiag = kernel.diag(params, Xstar)
    var = jnp.maximum(kdiag - jnp.sum(v * v, axis=0), 0.0)
    return mu, var


def nlml(K: jnp.ndarray, y: jnp.ndarray, log_prob: Callable,
         mean: jnp.ndarray = None, maxit: int = 20) -> jnp.ndarray:
    """Laplace-approximate NLML: psi(alpha_hat) + 1/2 log det B
    (GP_Utils.cpp:1138-1162 composition)."""
    n = K.shape[0]
    mean = jnp.zeros(n, K.dtype) if mean is None else mean
    alpha, f, psi = fit_latent(K, y, log_prob, mean, maxit)
    _, _, d2lp = _derivs(log_prob, y, f)
    W = jnp.maximum(-d2lp, 0.0)
    sw = jnp.sqrt(W)
    B = jnp.eye(n, dtype=K.dtype) + (sw[:, None] * sw[None, :]) * K
    L = jnp.linalg.cholesky(B)
    return psi + jnp.sum(jnp.log(jnp.diagonal(L)))

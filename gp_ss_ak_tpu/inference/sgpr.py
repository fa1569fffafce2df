"""Sparse GP regression (Titsias variational inducing points).

Capability beyond the reference: the exact engine scales to large N
by sharding the N x N matrix over a mesh (gp_ss_ak_tpu.parallel); this
module is the complementary SINGLE-DEVICE route — O(n m^2) time and
O(n m) memory for m inducing points, all dense matmuls, vmap- and
shard-friendly (the n axis of Kmn can be row-sharded with a psum over
the two n-reductions).

Collapsed evidence lower bound (Titsias 2009):

  L = chol(Kmm + jitter I)
  A = L^-1 Kmn / sigma                      (m, n)
  B = I + A A^T,  LB = chol(B)
  c = LB^-1 A y / sigma
  ELBO = -n/2 log(2 pi sigma^2) - sum log diag LB
         - ||y||^2/(2 sigma^2) + ||c||^2 / 2
         - (sum kdiag(X) - tr(A A^T) sigma^2 ... ) / (2 sigma^2)

with the trace regularizer t = (sum_i k(x_i,x_i) - ||L^-1 Kmn||_F^2).
Gradients via jax.grad; inducing locations Z are free parameters and
can be optimized jointly with the kernel hypers.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

_PREC = jax.lax.Precision.HIGHEST


class SGPRState(NamedTuple):
    L: jnp.ndarray    # chol(Kmm)
    LB: jnp.ndarray   # chol(I + A A^T)
    A: jnp.ndarray    # whitened cross-cov (m, n)
    c: jnp.ndarray    # (m,)


def _factors(kernel, params, sn2, X, y, Z, jitter):
    m = Z.shape[0]
    with jax.default_matmul_precision("highest"):
        Kmm = kernel.matrix(params, Z, Z, same=True)
        Kmm = Kmm + jitter * jnp.eye(m, dtype=Kmm.dtype)
        Kmn = kernel.matrix(params, Z, X, same=False)
        L = jnp.linalg.cholesky(Kmm)
        sigma = jnp.sqrt(sn2)
        A = jax.scipy.linalg.solve_triangular(L, Kmn, lower=True) / sigma
        B = jnp.eye(m, dtype=A.dtype) + jnp.matmul(A, A.T, precision=_PREC)
        LB = jnp.linalg.cholesky(B)
        Ay = A @ y
        c = jax.scipy.linalg.solve_triangular(LB, Ay, lower=True) / sigma
    return SGPRState(L=L, LB=LB, A=A, c=c)


def elbo(kernel, params, lik_hypers, X, y, Z,
         jitter: float = 1e-6) -> jnp.ndarray:
    """The collapsed bound (to MAXIMIZE); `neg_elbo` is the objective
    for the box-constrained optimizers."""
    n = X.shape[0]
    sn2 = lik_hypers[0]
    st = _factors(kernel, params, sn2, X, y, Z, jitter)
    kdiag_sum = jnp.sum(kernel.diag(params, X))
    trace_term = kdiag_sum / sn2 - jnp.sum(st.A * st.A)
    bound = (
        -0.5 * n * jnp.log(2.0 * math.pi * sn2)
        - jnp.sum(jnp.log(jnp.diagonal(st.LB)))
        - 0.5 * jnp.dot(y, y) / sn2
        + 0.5 * jnp.dot(st.c, st.c)
        - 0.5 * trace_term
    )
    return bound


def neg_elbo(kernel, params, lik_hypers, X, y, Z, jitter: float = 1e-6):
    return -elbo(kernel, params, lik_hypers, X, y, Z, jitter)


def predict(kernel, params, lik_hypers, X, y, Z, Xstar,
            jitter: float = 1e-6, with_noise: bool = True):
    """Predictive mean/variance of the collapsed variational posterior."""
    sn2 = lik_hypers[0]
    st = _factors(kernel, params, sn2, X, y, Z, jitter)
    with jax.default_matmul_precision("highest"):
        Kms = kernel.matrix(params, Z, Xstar, same=False)   # (m, s)
        tmp1 = jax.scipy.linalg.solve_triangular(st.L, Kms, lower=True)
        tmp2 = jax.scipy.linalg.solve_triangular(st.LB, tmp1, lower=True)
        mu = tmp2.T @ st.c
        kdiag = kernel.diag(params, Xstar)
        var = (kdiag
               - jnp.sum(tmp1 * tmp1, axis=0)
               + jnp.sum(tmp2 * tmp2, axis=0))
        var = jnp.maximum(var, 0.0)
    if with_noise:
        var = var + sn2
    return mu, var


def init_inducing(X, m: int, seed: int = 0) -> jnp.ndarray:
    """m inducing locations sampled without replacement from X."""
    n = X.shape[0]
    idx = jax.random.choice(jax.random.PRNGKey(seed), n,
                            shape=(min(m, n),), replace=False)
    return jnp.asarray(X)[idx]


def fit_sgpr(model, X, y, m: int = 128, iters: int = 100, seed: int = 0,
             z_bound: float = None, jitter: float = 1e-6, verbose: int = 0,
             optimize_z: bool = True):
    """Joint bound-constrained L-BFGS over hypers AND inducing
    locations. Hypers keep the reference box [1e-4, 6]; inducing
    coordinates get +-z_bound (default: 2x the data range).
    `optimize_z=False` freezes Z at the k-means++-style subset init
    (init_inducing) and optimizes hypers only — the ablation arm of
    the m-sweep trade curve. Returns (fitted_model, Z, OptResult)."""
    from dataclasses import replace as _replace

    import jax as _jax

    from gp_ss_ak_tpu.optim.lbfgsb import (
        DEFAULT_LOWER,
        DEFAULT_UPPER,
        LBFGSB,
    )

    dtype = jnp.result_type(model.pack())
    Xd = jnp.asarray(X, dtype)
    yd = jnp.asarray(y, dtype)
    Z0 = init_inducing(Xd, m, seed)
    m_eff, d = Z0.shape
    kern = model.kernel
    nk = kern.n_params
    nl = int(np.size(model.lik_hypers))
    if z_bound is None:
        z_bound = 2.0 * float(jnp.max(jnp.abs(Xd)))

    def unpack(v):
        kp = kern.unpack(v[:nk])
        lh = v[nk : nk + nl]
        if optimize_z:
            Z = v[nk + nl :].reshape(m_eff, d)
        else:
            Z = Z0.astype(v.dtype)
        return kp, lh, Z

    def loss(v):
        kp, lh, Z = unpack(v)
        return neg_elbo(kern, kp, lh, Xd, yd, Z, jitter)

    vg = _jax.jit(_jax.value_and_grad(loss))

    def vgrad(x):
        val, g = vg(jnp.asarray(x, dtype))
        return float(val), np.asarray(g, np.float64)

    v0 = np.asarray(
        np.concatenate([
            np.asarray(kern.pack(model.kernel_params), np.float64),
            np.asarray(model.lik_hypers, np.float64),
        ]), np.float64)
    lb = np.full(nk + nl, DEFAULT_LOWER)
    ub = np.full(nk + nl, DEFAULT_UPPER)
    if optimize_z:
        v0 = np.concatenate([v0, np.asarray(Z0, np.float64).ravel()])
        lb = np.concatenate([lb, np.full(m_eff * d, -z_bound)])
        ub = np.concatenate([ub, np.full(m_eff * d, z_bound)])
    res = LBFGSB(maxiter=iters, verbose=verbose).minimize(vgrad, v0, lb, ub)
    kp, lh, Z = unpack(jnp.asarray(res.x, dtype))
    fitted = _replace(model, kernel_params=kp, lik_hypers=lh,
                      num_data=int(Xd.shape[0]), input_dim=int(d))
    return fitted, Z, res

"""Cholesky failure recovery.

The reference's entire numerical-failure strategy is Chol_fail ->
NLML = NaN -> the optimizer rejects the step (GP_Utils.cpp:884-887,
Opt_pars.cpp:748-752). That protocol is preserved by default (NaN
propagation through jnp.linalg.cholesky); this module adds the
recovery the reference lacks (SURVEY.md §5 "failure detection"):
retry the factorization with a geometrically growing diagonal nugget,
entirely inside jit (lax.while_loop), for serving/HMC paths where a
hard NaN is worse than a slightly-regularized posterior.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax



def robust_cholesky(A: jnp.ndarray, max_attempts: int = 4,
                    initial_rel: float = 1e-8):
    """chol(A + c_k I) with c_k = mean(diag A) * initial_rel * 100^k,
    retrying while the factor contains NaNs. Returns (L, nugget_used);
    L still NaN if every attempt failed."""
    n = A.shape[0]
    scale = jnp.mean(jnp.diagonal(A))
    eye = jnp.eye(n, dtype=A.dtype)

    def attempt(k):
        nug = jnp.where(k == 0, 0.0,
                        scale * initial_rel * (100.0 ** (k - 1)))
        return jnp.linalg.cholesky(A + nug * eye), nug

    L0, nug0 = attempt(jnp.asarray(0))

    def cond(c):
        k, L, _ = c
        return (k < max_attempts) & jnp.any(jnp.isnan(L))

    def body(c):
        k, _, _ = c
        L, nug = attempt(k + 1)
        return k + 1, L, nug

    _, L, nug = lax.while_loop(cond, body, (jnp.asarray(0), L0, nug0))
    return L, nug


def is_spd_cholesky(L: jnp.ndarray) -> jnp.ndarray:
    """True if the factorization succeeded (no NaNs anywhere)."""
    return ~jnp.any(jnp.isnan(L))

"""Serving: factor once, predict many (batched).

The reference's test mode rebuilds alpha/chol from scratch on every
invocation (gp_ss_ak.cpp:382-395). The Predictor here factors the
training posterior ONCE, keeps (alpha, L) on device, and serves
posterior mean/variance for arbitrary batches of query points — each
batch is one cross-Gram + one triangular solve (or one GEMM against a
precomputed L^-1).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gp_ss_ak_tpu.inference import gaussian
from gp_ss_ak_tpu.model import GPModel

def blocked_linv(chol, block: int = 1024):
    """L^-1 by block-row forward substitution — GEMMs, not big solves.

    A single n-RHS `solve_triangular` is the obvious spelling, but its
    lowering can materialize temporaries proportional to n x RHS.
    Block-row inversion avoids large solves entirely:

      Linv[i, :i] = -Lii^-1 (L[i, :i] @ Linv[:i, :i]),
      Linv[i, i]  = Lii^-1,

    one (block, n) x (n, n) GEMM + one block x block triangular
    solve per block row; peak memory is L + Linv + O(block x n). One
    compiled program serves every row (the row index is traced); the
    Linv carry is donated, so no second n x n buffer accumulates."""
    n = chol.shape[0]
    dtype = chol.dtype
    nb = -(-n // block)
    npad = nb * block
    if npad == n:
        Lp = chol          # no padded copy — saves an n^2 buffer
    else:
        # identity padding keeps trailing diagonal blocks invertible
        Lp = jnp.eye(npad, dtype=dtype).at[:n, :n].set(chol)
    eye_b = jnp.eye(block, dtype=dtype)
    prec = jax.lax.Precision.HIGHEST

    @functools.partial(jax.jit, donate_argnums=(1,))
    def row_step(Lp, Linv, i):
        start = i * block
        zero = jnp.zeros((), i.dtype)
        Lrow = jax.lax.dynamic_slice(Lp, (start, zero), (block, npad))
        Lii = jax.lax.dynamic_slice(Lp, (start, start), (block, block))
        Dinv = jax.scipy.linalg.solve_triangular(Lii, eye_b,
                                                 lower=True)
        colmask = (jnp.arange(npad) < start)[None, :]
        M = jnp.matmul(jnp.where(colmask, Lrow, 0.0), Linv,
                       precision=prec)
        row = -jnp.matmul(Dinv, M, precision=prec)
        row = jax.lax.dynamic_update_slice(row, Dinv, (zero, start))
        return jax.lax.dynamic_update_slice(Linv, row, (start, zero))

    Linv = jnp.zeros((npad, npad), dtype)
    for i in range(nb):
        Linv = row_step(Lp, Linv, jnp.asarray(i, jnp.int32))
    return Linv[:n, :n]


class Predictor:
    """Posterior server for one trained model + training set."""

    #: above this training size the one-time L^-1 (an n x n buffer) is
    #: not precomputed by default — pass precompute_inverse=True to
    #: override. The inverse is built block-by-block (`blocked_linv`):
    #: a single n-RHS triangular solve OOMs the XLA lowering at
    #: n = 16384.
    PRECOMPUTE_MAX_N = 16384
    #: single-dispatch solve is fine below this; blocked above
    SINGLE_SHOT_LINV_MAX_N = 8192

    def __init__(self, model: GPModel, X, y, jitter: float = 0.0,
                 robust: bool = False,
                 precompute_inverse: Optional[bool] = None):
        self.model = model
        dtype = jnp.result_type(model.pack())
        self.X = jnp.asarray(X, dtype)
        self.y = jnp.asarray(y, dtype)
        # single assembly path: gaussian.factorize owns the warp /
        # jitter-retry logic (robust=True adds the escalating diagonal
        # nugget instead of propagating NaN)
        self.post = gaussian.factorize(
            model.kernel, model.kernel_params, model.lik_hypers,
            self.X, self.y, model.likelihood, jitter, robust=robust)
        self.nugget = (self.post.nugget if self.post.nugget is not None
                       else jnp.zeros((), dtype))

        if precompute_inverse is None:
            precompute_inverse = self.X.shape[0] <= self.PRECOMPUTE_MAX_N
        if precompute_inverse:
            # one-time L^-1 so each serving batch's whitened solve is a
            # single GEMM instead of a triangular solve
            n = self.X.shape[0]
            if n <= self.SINGLE_SHOT_LINV_MAX_N:
                eye = jnp.eye(n, dtype=dtype)
                with jax.default_matmul_precision("highest"):
                    linv = jax.scipy.linalg.solve_triangular(
                        self.post.chol, eye, lower=True)
            else:
                linv = blocked_linv(self.post.chol)
            self.post = self.post._replace(linv=linv)

        self._predict = jax.jit(
            lambda Xs: gaussian.posterior_mean_var(
                model.kernel, model.kernel_params, model.lik_hypers,
                self.X, self.post, Xs, model.likelihood))

    def __call__(self, Xstar, batch_size: Optional[int] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        dtype = self.X.dtype
        Xs = np.asarray(Xstar)
        if batch_size is None or Xs.shape[0] <= batch_size:
            mu, var = self._predict(jnp.asarray(Xs, dtype))
            return np.asarray(mu), np.asarray(var)
        mus, vars_ = [], []
        # fixed-size batches (pad the tail) so one compiled program
        # serves every chunk
        m = Xs.shape[0]
        for start in range(0, m, batch_size):
            chunk = Xs[start : start + batch_size]
            pad = batch_size - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.repeat(
                    chunk[-1:], pad, axis=0)])
            mu, var = self._predict(jnp.asarray(chunk, dtype))
            take = batch_size - pad
            mus.append(np.asarray(mu)[:take])
            vars_.append(np.asarray(var)[:take])
        return np.concatenate(mus), np.concatenate(vars_)


class IterativePredictor:
    """Matrix-free posterior server: K(X, X) is NEVER materialized.

    The dense `Predictor` factorizes the full training Gram — its
    memory wall (A + L = 8 N^2 bytes) is exactly where the matrix-free
    training engine (optim/iterative_fit.py) starts to matter. This server extends the
    reference's posteriorMeanVar contract (GP_Utils.cpp:943-1043) past
    that wall with the same pieces the training engine runs on:

      setup  alpha = A^-1 y by whitened batched CG (plain CG on
             P^(-1/2) A P^(-1/2), P the rank-k pivoted-Cholesky
             preconditioner — the f32-stable route) over the streamed
             Gram operator (ops/matvec.py) — one-time cost,
             alpha stays on device.
      mean   mu = k*' alpha + bias * sum(alpha): one chunked
             cross-kernel pass per query batch, O(N M d) — no solves.
      var    sigma^2 = (s^2 + bias) - k*' A^-1 k* + sn2: one batched
             PCG solve per query batch (all M columns ride each
             streamed Gram pass), clamped >= 0 BEFORE the noise add —
             the reference's order (GP_Utils.cpp:1002-1041).

    Flagship kernel only (Sum([ExpAns, Bias])), like the training
    engine; both plain Gaussian AND WarpedGaussian likelihoods are
    served. For warped models the conjugate algebra runs on g(y)
    (alpha = (K + sn2 I)^-1 g(y), sn2 = exp(2 theta)) and the latent
    Gaussian (mu, var) at each query is pushed through g^{-1} with the
    same 20-node Gauss-Hermite mix as the dense path
    (gaussian.warped_predictive_mix; GP_Utils.cpp:1044-1078) — the
    reference's warped-prediction contract past the dense wall.
    `mean_only` callers (e.g. large-N MSE reports) skip the
    per-batch variance solves for plain Gaussian models; the warped
    predictive mean depends on the latent VARIANCE (the quadrature
    mixes over sigma), so warped `mean_only` still pays the solve.
    """

    def __init__(self, model: GPModel, X, y, precond_rank=None,
                 cg_tol: float = 1e-4, cg_maxiter: int = 800,
                 chunk: int = 4096):
        from gp_ss_ak_tpu.inference.iterative import (
            auto_precond_rank,
            bcg_solve,
            pivoted_cholesky,
            whitened_solve_info,
        )
        from gp_ss_ak_tpu.kernels.distance import pad_to_3d
        from gp_ss_ak_tpu.ops.matvec import _round_up, streamed_matmat
        from gp_ss_ak_tpu.inference.likelihoods import WarpedGaussian
        from gp_ss_ak_tpu.optim.iterative_fit import supports_iterative

        if not supports_iterative(model):
            raise ValueError(
                "IterativePredictor supports only Sum([ExpAns, Bias]) "
                "with a (Warped)Gaussian likelihood; got "
                f"{model.kernel!r} / {type(model.likelihood).__name__}")
        self.model = model
        ep, bp = model.kernel_params
        expans = model.kernel.children[0]
        Xd = jnp.asarray(X, jnp.float32)
        yraw = jnp.asarray(y, jnp.float32)
        lik = model.likelihood
        lh = jnp.asarray(model.lik_hypers, jnp.float32).reshape(-1)
        self.likelihood = lik
        self.lik_hypers = lh
        self.warped = isinstance(lik, WarpedGaussian)
        # rbf warp families clamp their centres at max(raw y)
        self.y_max = jnp.max(yraw)
        if self.warped:
            yd, _lgpy = lik.effective_target(lh, yraw, self.y_max)
        else:
            yd = yraw
        n = Xd.shape[0]
        self.n = n
        self.cg_tol = cg_tol
        self.cg_maxiter = cg_maxiter
        rank = auto_precond_rank(n) if precond_rank is None \
            else precond_rank
        self.precond_rank = rank

        # same mapping convention as training (ops/gram.mapped_points):
        # recentre by the TRAIN mean, map through M — distances are
        # translation invariant, so queries share c and M
        Xp = pad_to_3d(Xd)
        c = jnp.mean(Xp, axis=0)
        M = expans.metric(ep, Xp.shape[-1])
        prec = jax.lax.Precision.HIGHEST
        Xm = jnp.matmul(Xp - c, M, precision=prec)
        self._c, self._M = c, M
        self._pad_to_3d = pad_to_3d
        sigma, bias = ep["Sigma"], bp["Sigma"]
        sn2 = jnp.asarray(lik.noise_variance(lh), jnp.float32)
        self.s2 = sigma * sigma
        self.bias = bias
        self.sn2 = sn2

        s2 = self.s2

        def matmat(V):
            return streamed_matmat(Xm, s2, bias, sn2, V)

        self._matmat = matmat
        # whitened-CG solve route (f32-stable at the flagship
        # conditioning — inference.iterative.whitened_solve_info);
        # rank=0 falls back to plain CG
        if rank:
            L = pivoted_cholesky(Xm, sigma, bias, rank)

            def solve(B):
                sols, it, _rel, _ld, _wmm = whitened_solve_info(
                    matmat, L, sn2, B, tol=cg_tol, maxiter=cg_maxiter)
                return sols, it
        else:
            def solve(B):
                return bcg_solve(matmat, B, None, tol=cg_tol,
                                 maxiter=cg_maxiter)
        self._solve = solve
        alpha, it = solve(yd[:, None])
        self.alpha = jax.block_until_ready(alpha[:, 0])
        self.setup_cg_iters = int(it)

        # chunk-padded train points + alpha for the cross-kernel passes
        npad = _round_up(n, chunk)
        self._chunk = chunk
        self._Xm_pad = jnp.zeros((npad, Xm.shape[1]),
                                 jnp.float32).at[:n].set(Xm)
        self._alpha_pad = jnp.zeros((npad,),
                                    jnp.float32).at[:n].set(self.alpha)
        self._n_chunks = npad // chunk
        self.last_cg_iters = None

    def _map_queries(self, Xs):
        Xsp = self._pad_to_3d(jnp.asarray(Xs, jnp.float32))
        return jnp.matmul(Xsp - self._c, self._M,
                          precision=jax.lax.Precision.HIGHEST)

    @functools.cached_property
    def _mean_fn(self):
        from gp_ss_ak_tpu.kernels.distance import gram_sqdist

        chunk, n_chunks = self._chunk, self._n_chunks
        Xm_pad, alpha_pad = self._Xm_pad, self._alpha_pad
        s2 = self.s2

        @jax.jit
        def mean(Xsm):
            def one(ci):
                rows = jax.lax.dynamic_slice_in_dim(
                    Xm_pad, ci * chunk, chunk)
                a = jax.lax.dynamic_slice_in_dim(
                    alpha_pad, ci * chunk, chunk)
                d2 = gram_sqdist(rows, Xsm)
                k = s2 * jnp.exp(-jnp.sqrt(jnp.maximum(d2, 0.0)))
                return jnp.matmul(
                    k.T, a,
                    precision=jax.lax.Precision.HIGHEST)  # (B,)

            parts = jax.lax.map(one, jnp.arange(n_chunks))
            # bias is rank-1: bias * sum(alpha) per query
            return jnp.sum(parts, axis=0) \
                + self.bias * jnp.sum(alpha_pad)

        return mean

    @functools.cached_property
    def _cross_fn(self):
        """k*(X_train, X_batch) as a full (n, B) array, chunk-built."""
        from gp_ss_ak_tpu.kernels.distance import gram_sqdist

        chunk, n_chunks = self._chunk, self._n_chunks
        Xm_pad = self._Xm_pad
        s2, bias, n = self.s2, self.bias, self.n

        @jax.jit
        def cross(Xsm):
            def one(ci):
                rows = jax.lax.dynamic_slice_in_dim(
                    Xm_pad, ci * chunk, chunk)
                d2 = gram_sqdist(rows, Xsm)
                return s2 * jnp.exp(-jnp.sqrt(jnp.maximum(d2, 0.0))) \
                    + bias

            parts = jax.lax.map(one, jnp.arange(n_chunks))
            return parts.reshape(n_chunks * chunk, -1)[:n]

        return cross

    #: max RHS columns per whitened-CG solve: the solver carries
    #: several (n, B) float32 arrays, so the column block shrinks as n
    #: grows. Each block still amortizes one full O(N^2) operator pass
    #: across its columns. Not re-tuned for any particular device.
    SOLVE_COL_BLOCK = 1024
    SOLVE_COL_BLOCK_LARGE_N = 512
    LARGE_N_THRESHOLD = 80000

    def _solve_col_block(self) -> int:
        if self.n > self.LARGE_N_THRESHOLD:
            return self.SOLVE_COL_BLOCK_LARGE_N
        return self.SOLVE_COL_BLOCK

    def _var_batch(self, Xsm):
        kx = self._cross_fn(Xsm)                     # (n, B)
        B = kx.shape[1]
        blk = self._solve_col_block()
        if B <= blk:
            W, it = self._solve(kx)
            self.last_cg_iters = int(it)
        else:
            pad = (-B) % blk
            if pad:
                kx_p = jnp.concatenate(
                    [kx, jnp.zeros((kx.shape[0], pad), kx.dtype)], 1)
            else:
                kx_p = kx
            parts, iters = [], 0
            for s in range(0, B + pad, blk):
                Wb, it = self._solve(
                    jax.lax.dynamic_slice_in_dim(kx_p, s, blk, 1))
                parts.append(Wb)
                iters = max(iters, int(it))
            W = jnp.concatenate(parts, axis=1)[:, :B]
            self.last_cg_iters = iters
        kss = self.s2 + self.bias                    # k(x*, x*)
        var = kss - jnp.sum(kx * W, axis=0)
        # clamp BEFORE the noise add — reference order,
        # GP_Utils.cpp:1002-1041
        return jnp.maximum(var, 0.0) + self.sn2

    @functools.cached_property
    def _warp_mix_fn(self):
        """Jitted 20-node Gauss-Hermite push of the latent Gaussian
        through g^{-1} (gaussian.warped_predictive_mix), per batch."""
        lik, lh, ymax = self.likelihood, self.lik_hypers, self.y_max

        @jax.jit
        def mix(mu, var):
            return gaussian.warped_predictive_mix(lik, lh, mu, var,
                                                  ymax)

        return mix

    def __call__(self, Xstar, batch_size: int = 4096,
                 mean_only: bool = False, latent: bool = False
                 ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """`latent=True` returns the LATENT Gaussian (mu, var) —
        noise included, warp mix NOT applied — the quantities exact
        warped predictive densities and quantile-mapped intervals are
        built from (p(y*) = N(g(y*); mu, var) g'(y*) for monotone g).
        No-op for plain Gaussian models."""
        Xs = np.asarray(Xstar)
        m = Xs.shape[0]
        mus, vars_ = [], []
        # the warped predictive mean mixes over the latent sigma, so
        # warped mean_only still needs the variance solve
        need_var = (not mean_only) or (self.warped and not latent)
        for start in range(0, m, batch_size):
            chunk = Xs[start : start + batch_size]
            pad = batch_size - chunk.shape[0]
            if pad:     # fixed shapes: one compiled program per size
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], pad, axis=0)])
            Xsm = self._map_queries(chunk)
            take = batch_size - pad
            mu_b = self._mean_fn(Xsm)
            var_b = self._var_batch(Xsm) if need_var else None
            if self.warped and not latent:
                mu_b, var_b = self._warp_mix_fn(mu_b, var_b)
            mus.append(np.asarray(mu_b)[:take])
            if not mean_only:
                vars_.append(np.asarray(var_b)[:take])
        mu = np.concatenate(mus)
        return mu, (None if mean_only else np.concatenate(vars_))

"""Mesh-sharded exact GP: NLML + gradient + prediction at large N.

Composition (all per-device code under jax.shard_map over mesh axis
"dp", rows contiguous):

  X is row-sharded; one all-gather replicates it (N x d is tiny);
  each device builds its ROW BLOCK of A = K + sn2 I through the
  generic Gram — the N x N matrix never exists on one device;
  distributed block Cholesky + substitutions (parallel/pchol.py)
  produce alpha, the half log-determinant and posterior solves.

Gradients use the same algebra as the reference's `dhyp`/QW machinery
(GP_Utils.cpp:1164-1220) rather than differentiating through the
factorization:  dNLML/dtheta = 1/2 tr[(A^-1 - alpha alpha^T) dA/dtheta].
Each device materializes its row block of Q = A^-1 (distributed solves
against identity columns), forms QW = Q - alpha alpha^T, and contracts
it against dA/dtheta via jax.grad of the LOCAL Gram build — so the
650-line hand-derived kernel gradients of Kernel.cpp:886-1263 reduce
to one vjp of a 30-line function, and the O(N^3) path stays
fori_loop-based (no reverse-through-Cholesky memory blowup).

Padding: rows beyond the true N are identity rows (unit diagonal,
zero y), which leave logdet/solves unchanged (parallel/mesh.pad_rows).
"""

from __future__ import annotations

import math
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gp_ss_ak_tpu.parallel.mesh import ROW_AXIS, pad_rows
from gp_ss_ak_tpu.utils.vma import pvary_to, vma_of
from gp_ss_ak_tpu.parallel.pchol import (
    block_cholesky_local,
    solve_chol_local,
    tri_solve_lower_local,
)

_PREC = lax.Precision.HIGHEST

#: grad_mode="auto" switchover: at or below this N the exact N-RHS
#: Q = A^-1 gradient is used (about 6x the Cholesky's flops, but exact);
#: above it the Hutchinson probe estimator, whose cost grows with the
#: probe count instead of N. The crossover has not been measured on a
#: GPU.
EXACT_GRAD_MAX_N = 8192


def _build_A_local(kernel, params, sn2, X_local, X_all, g, n_valid):
    """Row block of A = K + sn2 I with identity padding rows."""
    N = X_all.shape[0]
    cols = jnp.arange(N)
    on_diag = cols[None, :] == g[:, None]
    # the cross form leaves a rounding residue in d2 on the global
    # diagonal, which the sqrt amplifies to ~1e-4 of K on a GPU — a
    # systematic shift against sn2; the exact value is the kernel's own
    # diagonal, as in the dense same=True build
    K_local = jnp.where(on_diag, kernel.diag(params, X_local)[:, None],
                        kernel.matrix(params, X_local, X_all, same=False))
    vr = (g < n_valid)[:, None]
    vc = (cols < n_valid)[None, :]
    eye_local = on_diag.astype(K_local.dtype)
    diag_val = jnp.where(g < n_valid, sn2, 1.0)[:, None]
    return jnp.where(vr & vc, K_local, 0.0) + eye_local * diag_val


def make_dist_nlml_and_grad(kernel, likelihood, mesh: Mesh, n: int,
                            n_devices: int = None, nb: int = 128,
                            axis: str = ROW_AXIS,
                            grad_mode: str = "auto",
                            probes: int = 32,
                            probe_seed: int = 0) -> Callable:
    """Returns jitted (flat_hypers, X_padded, y_padded) -> (nlml, grad).

    `n` is the true (unpadded) number of rows; inputs must be padded to
    pad_rows(n, P, nb) and sharded with P(axis) on rows. Pass the
    model's likelihood: WarpedGaussian is fully supported — targets are
    warped per-shard (elementwise), the global y-max for the rbf warp
    clamp comes from a pmax, the - sum log g'(y) Jacobian joins the
    objective, and sn2 = exp(2 theta_last) per the reference convention
    (GP_Utils.cpp:417-430).

    `grad_mode="hutchinson"` replaces the exact N-RHS Q = A^-1 build
    (~6x the Cholesky FLOPs per evaluation) with a
    `probes`-RHS stochastic trace estimator — see _make_nlml_body.
    The default "auto" picks exact for n <= EXACT_GRAD_MAX_N and
    hutchinson beyond, where the N-RHS solve dominates wall-clock."""
    if grad_mode == "auto":
        grad_mode = "exact" if n <= EXACT_GRAD_MAX_N else "hutchinson"
    P_sz = n_devices or len(mesh.devices)
    body = _make_nlml_body(kernel, n, P_sz, nb, axis,
                           grad_mode=grad_mode, probes=probes,
                           probe_seed=probe_seed, likelihood=likelihood)
    mapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(axis), P(axis)),
        out_specs=(P(), P()),
    )
    return jax.jit(mapped)


def _make_nlml_body(kernel, n, P_sz, nb, axis,
                    grad_mode: str = "exact", probes: int = 32,
                    probe_seed: int = 0, likelihood=None):
    """Per-device NLML+grad body, reusable across the 1-D ("dp") mesh
    and the two-level (chains x dp) mesh.

    grad_mode:
      "exact"      — materialize this device's row block of Q = A^-1
                     by a distributed N-RHS solve (N^3/P extra flops,
                     ~6x the factorization; exact gradient).
      "hutchinson" — estimate tr(A^-1 dA/dtheta) with `probes`
                     Rademacher probes: m distributed solves U = A^-1 Z
                     (m << N RHS), then each gradient contraction is
                     one (n_local x N)(N x m) GEMM instead of an
                     N x N elementwise pass. The probe key is FIXED, so
                     the optimizer sees a deterministic (biased but
                     self-consistent) objective — the same trick the
                     matrix-free engine uses (optim/iterative_fit.py).
                     The alpha^T dA alpha and diagonal (sn2) terms stay
                     exact; only the trace term is estimated.
    """
    from gp_ss_ak_tpu.inference.likelihoods import WarpedGaussian

    nk = kernel.n_params
    warped = isinstance(likelihood, WarpedGaussian)

    def body(flat, X_local, y_local):
        n_local = X_local.shape[0]
        p = lax.axis_index(axis)
        g = p * n_local + jnp.arange(n_local)
        N = n_local * P_sz

        params = kernel.unpack(flat[:nk])
        if warped:
            lik_h = flat[nk:]
            sn2 = likelihood.noise_variance(lik_h)
            # global max of the TRUE targets (rbf warp centre clamp,
            # GP_Utils.cpp:485) — padding rows masked to -inf
            ymax = lax.pmax(
                jnp.max(jnp.where(g < n, y_local, -jnp.inf)), axis)
            gy_l, lgpy_l = likelihood.effective_target(lik_h, y_local,
                                                       ymax)
            gy_local = jnp.where(g < n, gy_l, 0.0)
            lgpy_sum = lax.psum(
                jnp.sum(jnp.where(g < n, lgpy_l, 0.0)), axis)
        else:
            sn2 = flat[nk]
            gy_local = y_local
            lgpy_sum = 0.0
        X_all = lax.all_gather(X_local, axis, tiled=True)

        A_local = _build_A_local(kernel, params, sn2, X_local, X_all,
                                 g, n)
        L_local, half_logdet = block_cholesky_local(A_local, nb, axis)
        alpha = solve_chol_local(L_local, gy_local[:, None],
                                 nb, axis)[:, 0]
        fit = 0.5 * lax.psum(jnp.dot(gy_local, alpha), axis)
        value = (fit + half_logdet + 0.5 * n * math.log(2.0 * math.pi)
                 - lgpy_sum)

        # warped extra terms for the gradient: d/dw [1/2 gy' A^-1 gy]
        # = alpha' dgy/dw, plus the Jacobian - sum dlog g'(y)/dw;
        # both are local elementwise expressions of the lik hypers
        def _extra(flat_):
            if not warped:
                return 0.0
            gy_, lgpy_ = likelihood.effective_target(
                flat_[nk:], y_local, lax.stop_gradient(ymax))
            gy_ = jnp.where(g < n, gy_, 0.0)
            lgpy_s = jnp.sum(jnp.where(g < n, lgpy_, 0.0))
            return (jnp.dot(lax.stop_gradient(alpha), gy_) - lgpy_s)

        def _sn2_of(flat_):
            return (likelihood.noise_variance(flat_[nk:]) if warped
                    else flat_[nk])

        # --- gradient via the QW contraction --------------------------
        alpha_all = lax.all_gather(alpha, axis, tiled=True)
        if grad_mode == "exact":
            cols = jnp.arange(N)
            I_local = (cols[None, :] == g[:, None]).astype(A_local.dtype)
            Q_local = solve_chol_local(L_local, I_local, nb, axis)
            QW = lax.stop_gradient(Q_local - jnp.outer(alpha, alpha_all))

            def contraction(flat_):
                params_ = kernel.unpack(flat_[:nk])
                sn2_ = _sn2_of(flat_)
                A_ = _build_A_local(kernel, params_, sn2_, X_local,
                                    X_all, g, n)
                return 0.5 * jnp.sum(QW * A_) + _extra(flat_)
        else:
            # Hutchinson: Z (N, m) Rademacher, identical on every
            # device (replicated key); zero the padding rows so probes
            # never touch the identity padding block
            key = jax.random.PRNGKey(probe_seed)
            Z_all = jax.random.rademacher(
                key, (N, probes), dtype=A_local.dtype)
            rows_valid = (jnp.arange(N) < n)[:, None]
            Z_all = jnp.where(rows_valid, Z_all, 0.0)
            Z_local = lax.dynamic_slice_in_dim(Z_all, g[0], n_local, 0)
            Z_local = pvary_to(Z_local,
                               vma_of(L_local) - vma_of(Z_local))
            U_local = solve_chol_local(L_local, Z_local, nb, axis)
            U_local = lax.stop_gradient(U_local)
            Z_all = lax.stop_gradient(Z_all)
            a_l = lax.stop_gradient(alpha)
            a_all = lax.stop_gradient(alpha_all)

            def contraction(flat_):
                params_ = kernel.unpack(flat_[:nk])
                sn2_ = _sn2_of(flat_)
                A_ = _build_A_local(kernel, params_, sn2_, X_local,
                                    X_all, g, n)
                AZ = jnp.matmul(A_, Z_all, precision=_PREC)
                tr_est = jnp.sum(U_local * AZ) / probes
                quad = jnp.dot(a_l, jnp.matmul(A_, a_all[:, None],
                                               precision=_PREC)[:, 0])
                # the probe estimator has zero diagonal bias but the
                # sn2 (diagonal) derivative is cheap to keep exact:
                # replace the stochastic diagonal term with the true
                # one. tr(A^-1 d(sn2 I)) = tr(A^-1): estimated part is
                # sum_i U_ii Z_ii... both flow through AZ, so no
                # correction is applied here — the estimator is
                # unbiased for every component including sn2.
                return 0.5 * (tr_est - quad) + _extra(flat_)

        # NOTE: no explicit psum — flat is replicated (P()), and under
        # shard_map jax inserts the cross-device reduction for the
        # cotangent of an axis-invariant input automatically.
        grad = jax.grad(contraction)(flat)
        return value, grad

    return body


def make_two_level_nlml_and_grad(kernel, likelihood, mesh: Mesh, n: int,
                                 nb: int = 128,
                                 chain_axis: str = "chains",
                                 row_axis: str = ROW_AXIS,
                                 grad_mode: str = "auto",
                                 probes: int = 32,
                                 probe_seed: int = 0) -> Callable:
    """Two-level parallelism over a (chains, dp) mesh
    (parallel/multihost.two_level_mesh): each CHAIN (HMC chain /
    ensemble member / restart) owns an independent hyper vector and a
    full copy of the data; within a chain the kernel matrix and block
    Cholesky are row-sharded over `row_axis`, while `chain_axis`
    carries no per-step collectives at all.

    `likelihood` and `grad_mode` follow make_dist_nlml_and_grad exactly:
    WarpedGaussian chains get the warped objective (warp + Jacobian +
    exp(2 theta) noise, GP_Utils.cpp:417-430) and "auto" switches to the
    Hutchinson gradient above EXACT_GRAD_MAX_N rows.

    Returns jitted (flats (C, p), X_pad, y_pad) -> (values (C,),
    grads (C, p)); X/y are sharded on rows and replicated across
    chains.
    """
    if grad_mode == "auto":
        grad_mode = "exact" if n <= EXACT_GRAD_MAX_N else "hutchinson"
    ci = mesh.axis_names.index(chain_axis)
    ri = mesh.axis_names.index(row_axis)
    P_sz = mesh.devices.shape[ri]
    n_chains = mesh.devices.shape[ci]
    body = _make_nlml_body(kernel, n, P_sz, nb, row_axis,
                           grad_mode=grad_mode, probes=probes,
                           probe_seed=probe_seed, likelihood=likelihood)

    def chain_body(flats_local, X_local, y_local):
        # flats_local: (1, p) — this device's chain; X/y: row shard
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


def make_dist_predict(kernel, likelihood, mesh: Mesh, n: int,
                      n_devices: int = None, nb: int = 128,
                      axis: str = ROW_AXIS) -> Callable:
    """Returns jitted (flat, X_pad, y_pad, Xstar) -> (mu, var).

    Xstar is replicated (serve in chunks); mu/var come back replicated.
    Mirrors posteriorMeanVar (GP_Utils.cpp:943-1043): cross-kernel,
    kX^T alpha, whitened triangular solve, clamp, + sn2; WarpedGaussian
    models get the 20-node Gauss-Hermite g^{-1} push
    (gaussian.warped_predictive_mix) on the replicated latent moments.
    """
    from gp_ss_ak_tpu.inference.gaussian import warped_predictive_mix
    from gp_ss_ak_tpu.inference.likelihoods import WarpedGaussian

    P_sz = n_devices or len(mesh.devices)
    nk = kernel.n_params
    warped = isinstance(likelihood, WarpedGaussian)

    def body(flat, X_local, y_local, Xstar):
        n_local = X_local.shape[0]
        p = lax.axis_index(axis)
        g = p * n_local + jnp.arange(n_local)

        params = kernel.unpack(flat[:nk])
        if warped:
            lik_h = flat[nk:]
            sn2 = likelihood.noise_variance(lik_h)
            ymax = lax.pmax(
                jnp.max(jnp.where(g < n, y_local, -jnp.inf)), axis)
            gy_l, _ = likelihood.effective_target(lik_h, y_local, ymax)
            gy_local = jnp.where(g < n, gy_l, 0.0)
        else:
            sn2 = flat[nk]
            gy_local = y_local
        X_all = lax.all_gather(X_local, axis, tiled=True)

        A_local = _build_A_local(kernel, params, sn2, X_local, X_all,
                                 g, n)
        L_local, _ = block_cholesky_local(A_local, nb, axis)
        alpha = solve_chol_local(L_local, gy_local[:, None],
                                 nb, axis)[:, 0]

        kX_local = kernel.matrix(params, X_local, Xstar, same=False)
        kX_local = jnp.where((g < n)[:, None], kX_local, 0.0)
        mu = lax.psum(
            jnp.matmul(kX_local.T, alpha[:, None], precision=_PREC)[:, 0],
            axis)

        v_local = tri_solve_lower_local(L_local, kX_local, nb, axis)
        ssq = lax.psum(jnp.sum(v_local * v_local, axis=0), axis)
        kdiag = kernel.diag(params, Xstar)
        var = jnp.maximum(kdiag - ssq, 0.0) + sn2
        if warped:
            mu, var = warped_predictive_mix(likelihood, flat[nk:],
                                            mu, var, ymax)
        return mu, var

    mapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P()),
        out_specs=(P(), P()),
    )
    return jax.jit(mapped)


def shard_training_data(mesh: Mesh, X: np.ndarray, y: np.ndarray,
                        nb: int = 128, axis: str = ROW_AXIS):
    """Pad to (devices x nb) multiples and device_put with row sharding.
    Returns (X_sharded, y_sharded, n_true, n_padded)."""
    n, d = X.shape
    P_sz = len(mesh.devices)
    n_pad = pad_rows(n, P_sz, nb)
    Xp = np.zeros((n_pad, d), X.dtype)
    Xp[:n] = X
    yp = np.zeros((n_pad,), y.dtype)
    yp[:n] = y
    row = NamedSharding(mesh, P(axis))
    return (jax.device_put(Xp, row), jax.device_put(yp, row), n, n_pad)

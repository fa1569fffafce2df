"""Large-N training driver: host L-BFGS over the distributed NLML.

The same optimizer contract as optim.fit (box [1e-4, 6], NaN
rejection, best-so-far) with the objective+gradient evaluated by the
mesh-sharded pipeline — each evaluation is one distributed Gram build
+ block Cholesky + QW-contraction gradient across all devices.
WarpedGaussian models are supported end-to-end (warping is
elementwise per shard; see parallel/nlml._make_nlml_body).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from gp_ss_ak_tpu.model import GPModel
from gp_ss_ak_tpu.optim.lbfgsb import (
    DEFAULT_LOWER,
    DEFAULT_UPPER,
    LBFGSB,
    OptResult,
)
from gp_ss_ak_tpu.optim.scg import SCG
from gp_ss_ak_tpu.parallel.nlml import (
    make_dist_nlml_and_grad,
    shard_training_data,
)


def fit_distributed(
    model: GPModel,
    X,
    y,
    mesh,
    nb: int = 256,
    optimizer: str = "LBFGS",
    iters: int = 100,
    lower: Optional[np.ndarray] = None,
    upper: Optional[np.ndarray] = None,
    verbose: int = 0,
    callback=None,
    grad_mode: str = "auto",
    probes: int = 32,
) -> Tuple[GPModel, OptResult]:
    """Distributed fit over the row-sharded NLML.

    NOTE on `grad_mode="auto"` (the default): above
    parallel.nlml.EXACT_GRAD_MAX_N (= 8192) rows the gradient switches
    from the exact N-RHS Q-build to the `probes`-probe Hutchinson
    estimator — stochastic but deterministic per evaluation (fixed
    probe key), so the optimizer sees a self-consistent objective. Pass
    grad_mode="exact" to force the exact gradient at any size.
    """
    dtype = jnp.result_type(model.pack())
    Xs, ys, n, _ = shard_training_data(
        mesh, np.asarray(X, dtype), np.asarray(y, dtype), nb=nb)
    nlml_grad = make_dist_nlml_and_grad(model.kernel, model.likelihood,
                                        mesh, n=n, nb=nb,
                                        grad_mode=grad_mode,
                                        probes=probes)

    def value_and_grad(flat_np):
        v, g = nlml_grad(jnp.asarray(flat_np, dtype), Xs, ys)
        return float(v), np.asarray(g, np.float64)

    x0 = np.asarray(model.pack(), np.float64)
    p = x0.shape[0]
    lb = np.full(p, DEFAULT_LOWER) if lower is None else np.asarray(lower)
    ub = np.full(p, DEFAULT_UPPER) if upper is None else np.asarray(upper)
    name = optimizer.upper()
    if name in ("LBFGS", "LBFGSB", "L-BFGS-B"):
        opt = LBFGSB(maxiter=iters, verbose=verbose)
    elif name == "BFGS":
        from gp_ss_ak_tpu.optim.bfgs import DenseBFGS

        opt = DenseBFGS(maxiter=iters, verbose=verbose)
    elif name == "SCG":
        opt = SCG(maxiter=iters, verbose=verbose)
    else:
        raise ValueError(f"Unrecognised optimiser type: {optimizer}")
    res = opt.minimize(value_and_grad, x0, lb, ub, callback=callback)
    fitted = model.unpack(jnp.asarray(res.x, dtype))
    fitted = replace(fitted, num_data=int(np.shape(X)[0]),
                     input_dim=int(np.shape(X)[1]))
    return fitted, res


def fit_ring(
    model: GPModel,
    X,
    y,
    mesh,
    nb: int = 256,
    iters: int = 100,
    lower: Optional[np.ndarray] = None,
    upper: Optional[np.ndarray] = None,
    verbose: int = 0,
    callback=None,
    precond_rank: int = 64,
    probes: int = 8,
    slq_probes: int = 16,
    lanczos_iters: int = 32,
    cg_tol: float = 1e-4,
    cg_maxiter: int = 400,
    seed: int = 0,
) -> Tuple[GPModel, OptResult]:
    """Fit past the row-panel wall: L-BFGS-B over the ring-distributed
    matrix-free NLML (parallel.ring.make_ring_nlml_and_grad) — no
    device ever holds more than an (n_local, n_local) tile, so this is
    the multi-device route at N where even the row panels of
    fit_distributed would exceed device memory (ring.py module
    docstring).

    The probe keys are fixed per fit, so the optimizer sees a
    deterministic (biased but self-consistent) objective — the same
    contract as the single-chip matrix-free engine
    (optim/iterative_fit.py). Flagship Sum([ExpAns, Bias]) + Gaussian
    likelihood only."""
    from gp_ss_ak_tpu.parallel.ring import make_ring_nlml_and_grad

    dtype = jnp.result_type(model.pack())
    Xs, ys, n, _ = shard_training_data(
        mesh, np.asarray(X, dtype), np.asarray(y, dtype), nb=nb)
    nlml_grad = make_ring_nlml_and_grad(
        model.kernel, mesh, n=n, precond_rank=precond_rank,
        probes=probes, slq_probes=slq_probes,
        lanczos_iters=lanczos_iters, cg_tol=cg_tol,
        cg_maxiter=cg_maxiter, probe_seed=seed)

    def value_and_grad(flat_np):
        v, g = nlml_grad(jnp.asarray(flat_np, dtype), Xs, ys)
        return float(v), np.asarray(g, np.float64)

    x0 = np.asarray(model.pack(), np.float64)
    p = x0.shape[0]
    lb = np.full(p, DEFAULT_LOWER) if lower is None else np.asarray(lower)
    ub = np.full(p, DEFAULT_UPPER) if upper is None else np.asarray(upper)
    opt = LBFGSB(maxiter=iters, verbose=verbose)
    res = opt.minimize(value_and_grad, x0, lb, ub, callback=callback)
    fitted = model.unpack(jnp.asarray(res.x, dtype))
    fitted = replace(fitted, num_data=int(np.shape(X)[0]),
                     input_dim=int(np.shape(X)[1]))
    return fitted, res

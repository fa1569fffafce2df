"""Training driver: glue between GPModel, the jitted NLML and the
optimizers (the role of GP_utils::OptimisePars + Opt_Algs::Optimise,
GP_Utils.cpp:1288-1301 / Opt_pars.h:176-195).

The objective is ONE jitted function of the flat hyper vector; its
gradient is jax.grad of the exact NLML. Optimizer names mirror the CLI
("LBFGS", "BFGS", "SCG", gp_ss_ak.cpp:286-293); BFGS is the dense
inverse-Hessian update (optim/bfgs.py, reference Opt_pars.cpp:451-538),
LBFGS the limited-memory box driver (optim/lbfgsb.py).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gp_ss_ak_tpu.inference import gaussian
from gp_ss_ak_tpu.model import GPModel
from gp_ss_ak_tpu.optim import jax_lbfgs
from gp_ss_ak_tpu.optim.lbfgsb import (
    DEFAULT_LOWER,
    DEFAULT_UPPER,
    LBFGSB,
    OptResult,
)
from gp_ss_ak_tpu.optim.scg import SCG


def flat_nlml_fn(model: GPModel, jitter: float = 0.0,
                 grad_mode: str = "qw"):
    """Returns f(flat, X, y) -> NLML as a pure jax function
    (jit/grad-able); data is passed per call, nothing is bound.

    Defaults to the QW custom-VJP gradient (inference/gaussian.py
    _quad_logdet): identical values/gradients to reverse-mode through
    the Cholesky, with one explicit A^-1 in place of the
    panel-sequential Cholesky adjoint."""
    kernel = model.kernel
    likelihood = model.likelihood
    nk = kernel.n_params
    nl = int(np.size(model.lik_hypers))

    def f(flat, X, y):
        kp = kernel.unpack(flat[:nk])
        lh = flat[nk : nk + nl]
        return gaussian.nlml(kernel, kp, lh, X, y, likelihood, jitter,
                             grad_mode=grad_mode)

    return f


def make_value_and_grad(model: GPModel, X, y, jitter: float = 0.0,
                        dtype=None):
    """Host-callable (f, g) closure over a single jitted program."""
    dtype = dtype or jnp.result_type(model.pack())
    Xd = jnp.asarray(X, dtype)
    yd = jnp.asarray(y, dtype)
    f = flat_nlml_fn(model, jitter)
    vg = jax.jit(jax.value_and_grad(lambda flat: f(flat, Xd, yd)))

    def value_and_grad(x_np: np.ndarray):
        val, grad = vg(jnp.asarray(x_np, dtype))
        return float(val), np.asarray(grad, np.float64)

    return value_and_grad


def resolve_engine(engine: str, model: GPModel, n_data: int) -> str:
    """The engine `fit` runs: "auto" picks the matrix-free iterative
    engine when N > DENSE_MAX_N and the model supports it, dense
    otherwise; any other name is returned lower-cased."""
    from gp_ss_ak_tpu.optim.iterative_fit import (
        DENSE_MAX_N,
        supports_iterative,
    )

    eng = engine.lower()
    if eng != "auto":
        return eng
    return ("iterative" if n_data > DENSE_MAX_N
            and supports_iterative(model) else "dense")


def fit(
    model: GPModel,
    X,
    y,
    optimizer: str = "LBFGS",
    iters: int = 100,
    lower: Optional[np.ndarray] = None,
    upper: Optional[np.ndarray] = None,
    jitter: float = 0.0,
    verbose: int = 0,
    callback=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 10,
    resume: bool = True,
    engine: str = "auto",
    engine_opts: Optional[dict] = None,
    timing: Optional[dict] = None,
    opt_opts: Optional[dict] = None,
) -> Tuple[GPModel, OptResult]:
    """Maximize the marginal likelihood over the box [1e-4, 6]^p.

    `engine` selects how the objective is evaluated:
      - "dense":     exact Cholesky NLML (inference/gaussian.py)
      - "iterative": matrix-free CG + SLQ (optim/iterative_fit.py) —
                     the Gram matrix never exists; flagship model only
      - "auto":      iterative when N > DENSE_MAX_N and the model
                     supports it, dense otherwise
    `engine_opts` are forwarded to make_iterative_value_and_grad
    (probes, lanczos_iters, cg_tol, chunk, precond_rank, mode, seed).

    With `checkpoint_path`, the flat hyper vector is saved every
    `checkpoint_every` iterations and (if `resume`) restored as the
    starting point on the next call — the reference's hypers-only
    checkpoint philosophy applied mid-run (utils/checkpoint.py).

    Pass a dict as `timing` to receive a per-evaluation wall-clock
    breakdown: {"engine", "n_evals", "eval_s" (list, first entry
    includes compile), "eval_s_sum", "eval_s_steady_median"} — enough
    to attribute fit_wall = compile + evals x eval_ms + host overhead.
    "value" lists each evaluation's objective; the iterative engine
    also records its CG iterations and achieved relative residual
    ("cg_iters", "rel_residual").

    `opt_opts` forwards extra constructor options to the selected host
    optimizer (e.g. {"tol": 1e-5, "tol_iters": 2} for an explicit
    large-fit stopping rule); the result's `stop_reason` records which
    rule fired — the convergence contract for fit rows.
    """
    import time as _time

    _t_enter = _time.perf_counter()
    x0 = np.asarray(model.pack(), np.float64)
    if checkpoint_path:
        from gp_ss_ak_tpu.utils.checkpoint import (
            CheckpointCallback,
            load_fit_checkpoint,
        )

        if resume:
            ck = load_fit_checkpoint(checkpoint_path)
            if ck is not None and ck["x"].shape == x0.shape:
                x0 = ck["x"]
        callback = CheckpointCallback(checkpoint_path, checkpoint_every,
                                      inner=callback)
    p = x0.shape[0]
    lb = np.full(p, DEFAULT_LOWER) if lower is None else np.asarray(lower)
    ub = np.full(p, DEFAULT_UPPER) if upper is None else np.asarray(upper)

    from gp_ss_ak_tpu.optim.iterative_fit import (
        DENSE_MAX_N,
        make_iterative_value_and_grad,
    )

    n_data = int(np.shape(X)[0])
    eng = resolve_engine(engine, model, n_data)
    if (engine.lower() == "auto" and n_data > DENSE_MAX_N
            and eng == "dense" and verbose >= 0):
        import warnings

        warnings.warn(
            f"engine='auto' picked the dense path at N={n_data} "
            "(the model has no matrix-free route); expect large "
            "memory/compile cost", stacklevel=2)
    if eng != "iterative" and (engine_opts or {}).get("segmented"):
        import warnings

        warnings.warn(
            f"segmented=True is only honoured by the iterative engine; "
            f"the resolved engine is '{eng}' and the fit will run "
            "un-segmented (pass engine='iterative' to force it)",
            stacklevel=2)
    if eng == "iterative":
        opts = dict(engine_opts or {})
        opts.setdefault("jitter", jitter)
        if opts.pop("segmented", False):
            # bounded-dispatch variant (optim/segmented.py): identical
            # estimator, host-carried solver state
            from gp_ss_ak_tpu.optim.segmented import (
                make_segmented_value_and_grad,
            )

            mode = opts.pop("mode", None)   # segmented is stream-only
            if mode not in (None, "auto", "stream"):
                raise ValueError(
                    f"segmented=True is stream-only; drop mode={mode!r} "
                    "or run un-segmented")
            vgrad = make_segmented_value_and_grad(model, X, y, **opts)
        else:
            vgrad = make_iterative_value_and_grad(model, X, y, **opts)
    elif eng == "dense":
        vgrad = make_value_and_grad(model, X, y, jitter)
    else:
        raise ValueError(f"Unrecognised engine: {engine}")

    if timing is not None and eng in ("iterative", "dense"):
        import time as _time

        class _TimedVGrad:
            """Wall-clock wrap that stays transparent: unknown
            attribute reads (last_cg_iters, last_rel_residual,
            precond_rank, traceable, ...) forward to the inner
            closure, so diagnostics survive the instrumentation."""

            def __init__(self, inner, walls, spans):
                self.inner = inner
                self._walls = walls
                self._spans = spans

            def __call__(self, x):
                t0 = _time.perf_counter()
                out = self.inner(x)
                t1 = _time.perf_counter()
                self._walls.append(t1 - t0)
                # absolute spans let a caller attribute HOST overhead
                # to the specific gaps between evals
                self._spans.append((t0, t1))
                timing.setdefault("value", []).append(out[0])
                it = getattr(self.inner, "last_cg_iters", None)
                if it is not None:
                    timing.setdefault("cg_iters", []).append(it)
                    timing.setdefault("rel_residual", []).append(
                        self.inner.last_rel_residual)
                return out

            def __getattr__(self, name):  # missing attrs only
                return getattr(self.__dict__["inner"], name)

        walls: list = []
        spans: list = []
        vgrad = _TimedVGrad(vgrad, walls, spans)  # noqa: F811
        timing["eval_s"] = walls
        timing["eval_spans"] = spans
        timing["engine"] = eng

    name = optimizer.upper()
    if eng == "iterative" and name in ("JIT", "LBFGS-JIT", "DEVICE"):
        # the matrix-free objective is already one device program per
        # evaluation; drive it with the host L-BFGS-B
        name = "LBFGS"
    if name in ("JIT", "LBFGS-JIT", "DEVICE"):
        # whole fit compiled into ONE device program (optim/jax_lbfgs):
        # no host<->device round-trip per evaluation — the fast path
        # for many small fits
        import jax

        dtype = jnp.result_type(model.pack())
        Xd = jnp.asarray(X, dtype)
        yd = jnp.asarray(y, dtype)
        fobj = flat_nlml_fn(model, jitter)
        vg = jax.value_and_grad(lambda flat: fobj(flat, Xd, yd))
        import time as _time

        _t0 = _time.perf_counter()
        jres = jax_lbfgs.minimize(vg, jnp.asarray(x0, dtype),
                                  jnp.asarray(lb, dtype),
                                  jnp.asarray(ub, dtype), maxiter=iters)
        jax.block_until_ready(jres.x)
        if timing is not None:
            # the whole fit is ONE device program here — per-eval walls
            # don't exist; record the coarse total instead of leaving
            # the dict silently empty
            timing["total_wall_s"] = _time.perf_counter() - _t0
            timing["note"] = ("fused-jit optimizer path: per-eval "
                              "timing unavailable (single device "
                              "program); total_wall_s is the whole fit")
        res = OptResult(np.asarray(jres.x, np.float64),
                        float(jres.fun), int(jres.n_iters), -1,
                        bool(jres.converged), [float(jres.fun)],
                        ("device_loop_converged" if jres.converged
                         else "maxiter"))
    else:
        oo = dict(opt_opts or {})
        if name in ("LBFGS", "LBFGSB", "L-BFGS-B"):
            opt = LBFGSB(maxiter=iters, verbose=verbose, **oo)
        elif name == "BFGS":
            # genuinely distinct dense inverse-Hessian BFGS, matching
            # the reference's separate BFGSOptimize (Opt_pars.cpp:451)
            from gp_ss_ak_tpu.optim.bfgs import DenseBFGS

            opt = DenseBFGS(maxiter=iters, verbose=verbose, **oo)
        elif name == "SCG":
            opt = SCG(maxiter=iters, verbose=verbose, **oo)
        else:
            raise ValueError(f"Unrecognised optimiser type: {optimizer}")
        res = opt.minimize(vgrad, x0, lb, ub, callback=callback)
    if timing is not None and timing.get("eval_spans"):
        # timeline attribution for the host bucket: time from fit()
        # entry to the FIRST eval span (engine construction, first
        # device touch) and from the LAST span to
        # return — with the measured inter-eval gaps these three
        # buckets close the wall = evals + overhead accounting
        spans_ = timing["eval_spans"]
        timing["pre_first_eval_s"] = spans_[0][0] - _t_enter
        timing["post_last_eval_s"] = _time.perf_counter() - spans_[-1][1]
    if timing is not None and timing.get("eval_s"):
        walls = timing["eval_s"]
        steady = walls[1:] or walls
        timing["n_evals"] = len(walls)
        timing["eval_s_sum"] = float(np.sum(walls))
        timing["eval_s_first"] = float(walls[0])
        timing["eval_s_steady_median"] = float(np.median(steady))
    fitted = model.unpack(jnp.asarray(res.x, jnp.result_type(model.pack())))
    fitted = replace(fitted, num_data=int(np.shape(X)[0]),
                     input_dim=int(np.shape(X)[1]))
    return fitted, res

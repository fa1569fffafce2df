"""End-to-end smoke run of the GP engine on one NVIDIA GPU.

    python chip_smoke.py            # phases 1-4 on one card
    python chip_smoke.py --four     # phase 5 only, on four cards

Data: X ~ U(-1, 1)^3, y = sin(X . [3, 1, 2]) + 0.1 N(0, 1), drawn from
--seed. Phases, each checked against a reference; any failure raises
and the script exits non-zero:

  1  dense exactness: float32 NLML + 10-parameter gradient on the card
     at N=4096 against the NumPy float64 reference (bench.cpu_nlml_grad)
  2  CLI, dense: `train -k ExpAns -o LBFGS -# 20` on 16384 points, then
     `test` on 4096 held-out points, in process (cli.main)
  3  streamed Gram product at N=100,000, B in {9, 64}: 1024 random rows
     against NumPy float64; the Triton route is asserted compiled from
     the lowered module
  4  optim.fit(engine="auto") at N=100,000 for 3 L-BFGS iterations (must
     resolve to the iterative engine), IterativePredictor means on 4096
     held-out points and variances on 128 of them, and the stream NLML
     estimator against the exact materialized-Cholesky value at
     N=32768
  5  (--four) the panel route (dist NLML+grad, a 2-iteration
     fit_distributed, dist predict) at N=32768 against the single-card
     dense path, and the ring route at N=100,000 against the
     single-card stream estimator

There is no CPU fallback: without a GPU backend the script exits 2
before any phase. The last line of standard output is one JSON object
naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

#: problem sizes of each phase (a CPU rehearsal may shrink them)
SIZES = dict(dense=4096, cli_train=16384, cli_test=4096, stream=100_000,
             fit=100_000, queries=4096, var_queries=128, estimator=32768,
             panel=32768, ring=100_000, rows=1024)

# bench.py's parameter names, in the order cpu_nlml_grad returns them
BENCH_HYPERS = dict(AngleX=math.pi / 3.1, AngleY=math.pi / 3.1,
                    AngleZ=math.pi / 3.1, iwx=1.5, iwy=1.5, iwz=1.3,
                    sigma=0.9, iwr=0.6, bias=0.2, sn2=0.016)
# position of each bench gradient entry in the model's flat vector
# [AngleX, iwx, AngleY, iwy, AngleZ, iwz, Sigma, iwR, bias, sn2]
BENCH_TO_FLAT = [0, 2, 4, 1, 3, 5, 6, 7, 8, 9]


def log(**kw):
    print(json.dumps(kw, default=float), flush=True)


def field(rng, n, d=3):
    X = rng.uniform(-1.0, 1.0, size=(n, d))
    y = np.sin(X @ np.array([3.0, 1.0, 2.0])) + 0.1 * rng.standard_normal(n)
    return X, y


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip()


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def phase_dense_exactness(rng):
    import jax
    import jax.numpy as jnp

    import bench
    from gp_ss_ak_tpu.model import default_model
    from gp_ss_ak_tpu.optim import flat_nlml_fn

    n = SIZES["dense"]
    X, y = field(rng, n)
    model = default_model(input_dim=3, dtype=jnp.float32)
    f = flat_nlml_fn(model)
    Xd, yd = jnp.asarray(X, jnp.float32), jnp.asarray(y, jnp.float32)
    vg = jax.jit(jax.value_and_grad(lambda p: f(p, Xd, yd)))
    flat = model.pack()
    (v, g), t_first = timed(vg, flat)
    (v, g), t_steady = timed(vg, flat)
    v_ref, g_ref_b = bench.cpu_nlml_grad(X, y, BENCH_HYPERS)
    g_ref = np.zeros(10)
    g_ref[BENCH_TO_FLAT] = g_ref_b
    g = np.asarray(g, np.float64)
    rel_v = abs(float(v) - v_ref) / abs(v_ref)
    nr = np.linalg.norm(g_ref)
    rel_gnorm = abs(np.linalg.norm(g) - nr) / nr
    rel_gvec = np.linalg.norm(g - g_ref) / nr
    log(phase=1, n=n, nlml=float(v), nlml_ref=v_ref, rel_err_value=rel_v,
        rel_err_grad_norm=rel_gnorm, rel_err_grad_vector=rel_gvec,
        first_call_s=t_first, steady_s=t_steady)
    check(rel_v <= 1e-4, f"phase 1 value rel err {rel_v}")
    check(rel_gnorm <= 1e-4, f"phase 1 gradient-norm rel err {rel_gnorm}")


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def _cli(argv):
    from gp_ss_ak_tpu import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    out = buf.getvalue()
    check(rc == 0, f"cli {argv[:3]} exited {rc}: {out[-500:]}")
    return out, time.perf_counter() - t0


def phase_cli_dense(rng, tmp):
    from gp_ss_ak_tpu.data import write_data

    n, m = SIZES["cli_train"], SIZES["cli_test"]
    X, y = field(rng, n + m)
    train, test = os.path.join(tmp, "train.txt"), os.path.join(tmp,
                                                               "test.txt")
    write_data(train, X[:n], y[:n])
    write_data(test, X[n:], y[n:])
    model = os.path.join(tmp, "model")
    out, t_train = _cli(["-v", "1", "-pm", "1", "train", "-k", "ExpAns",
                         "-o", "LBFGS", "-#", "20", train, model])
    hit = re.search(r"-logL: (\S+) -> (\S+)", out)
    check(hit is not None, "train printed no -logL line")
    nlml0, nlml1 = float(hit.group(1)), float(hit.group(2))
    pred = os.path.join(tmp, "pred.txt")
    out, t_test = _cli(["test", "--no-plot", test, model, train, pred])
    mse, var_y = (float(v) for v in out.strip().splitlines()[-2:])
    with open(pred) as fh:
        header = fh.readline().rstrip("\n")
    table = np.loadtxt(pred, comments="#")
    log(phase=2, nlml_start=nlml0, nlml_end=nlml1, train_s=t_train,
        test_s=t_test, test_mse=mse, var_y=var_y, mse_over_var=mse / var_y)
    check(nlml1 < nlml0, "phase 2 NLML did not decrease")
    check(mse < 0.1 * var_y, f"phase 2 test MSE {mse} >= 0.1 var(y)")
    check(header == "# SampleNo, Y,  Yh, StdYh, Inputs",
          f"phase 2 header {header!r}")
    check(table.shape == (m, 7), f"phase 2 table {table.shape}")
    check(np.array_equal(table[:, 0], np.arange(1, m + 1)),
          "phase 2 sample numbers")
    check(bool(np.all(np.diff(table[:, 1]) >= 0)),
          "phase 2 rows not sorted by observed y")


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def triton_in_module(fn, *args) -> bool:
    """Whether the lowered module of `fn` calls a compiled Triton
    kernel (an interpreted Pallas call lowers to plain HLO instead)."""
    import jax

    text = jax.jit(fn).lower(*args).as_text()
    return re.search(r"custom_call[^\n]*triton", text) is not None


def phase_stream_kernel(rng):
    import jax
    import jax.numpy as jnp

    from gp_ss_ak_tpu.ops.matvec import stream_route, streamed_matmat

    n = SIZES["stream"]
    X, _ = field(rng, n)
    s2, bias, sn2 = 0.81, 0.2, 0.016
    Xm = jnp.asarray(X, jnp.float32)
    rows = rng.choice(n, SIZES["rows"], replace=False)
    diff = X[rows][:, None, :] - X[None, :, :]
    E = np.exp(-np.sqrt(np.sum(diff * diff, axis=-1)))
    del diff
    fn = jax.jit(lambda x, v: streamed_matmat(x, s2, bias, sn2, v))
    for b in (9, 64):
        V = rng.standard_normal((n, b))
        Vd = jnp.asarray(V, jnp.float32)
        out, t_first = timed(fn, Xm, Vd)
        _, t_steady = timed(fn, Xm, Vd)
        ref = s2 * (E @ V) + bias * V.sum(0)[None, :] + sn2 * V[rows]
        err = np.abs(np.asarray(out, np.float64)[rows] - ref).max(0) \
            / np.abs(ref).max(0)
        route = stream_route(b)
        compiled = triton_in_module(fn, Xm, Vd)
        log(phase=3, n=n, b=b, route=route, triton_call_in_module=compiled,
            max_col_rel_err=float(err.max()), first_call_s=t_first,
            steady_s=t_steady)
        check(float(err.max()) <= 1e-4, f"phase 3 B={b} rel err {err.max()}")
        check(compiled == (route == "triton"),
              f"phase 3 B={b}: route {route} but triton call "
              f"present={compiled}")


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------

def phase_large_fit(rng):
    import jax
    import jax.numpy as jnp

    from gp_ss_ak_tpu.inference.iterative import choose_mode
    from gp_ss_ak_tpu.model import default_model
    from gp_ss_ak_tpu.optim import fit
    from gp_ss_ak_tpu.serve import IterativePredictor

    n, n_test = SIZES["fit"], SIZES["queries"]
    X, y = field(rng, n + n_test)
    model = default_model(input_dim=3, dtype=jnp.float32)
    # the stream regime's tolerance: at N=100k the float32 whitened CG
    # stalls near 1.3e-4 even at the start point (H100 run, PR 1)
    cg_tol = 1e-3
    timing = {}
    t0 = time.perf_counter()
    fitted, res = fit(model, X[:n], y[:n], optimizer="LBFGS", iters=3,
                      engine="auto", engine_opts=dict(cg_tol=cg_tol),
                      timing=timing)
    t_fit = time.perf_counter() - t0
    log(phase=4, n=n, engine=timing.get("engine"), mode=choose_mode(n),
        fit_s=t_fit, n_iters=res.n_iters, n_evals=timing.get("n_evals"),
        nlml_start=res.trace[0], nlml_end=res.fun,
        eval_s=timing.get("eval_s"), cg_iters=timing.get("cg_iters"),
        rel_residual=timing.get("rel_residual"),
        bytes_limit=(jax.local_devices()[0].memory_stats()
                     or {}).get("bytes_limit"))
    check(timing.get("engine") == "iterative",
          f"phase 4 engine {timing.get('engine')}")
    # the start and the returned fit were solved to cg_tol. Trial points
    # of the first line searches can stall above it (the first step
    # moves the largest gradient component by 1 and clips sn2 to its
    # 1e-4 bound, where float32 whitened CG floors near 3e-3 at this
    # N); those are counted and printed, not failed (PERF.md, PR 1)
    rel = timing["rel_residual"]
    i_fit = timing["value"].index(res.fun)
    stalled = sum(r > cg_tol for r in rel)
    log(phase=4, start_rel_residual=rel[0], fit_rel_residual=rel[i_fit],
        evals_above_cg_tol=stalled)
    check(all(np.isfinite(rel)), "phase 4 non-finite CG residual")
    check(rel[0] <= cg_tol and rel[i_fit] <= cg_tol,
          f"phase 4 CG residual at start {rel[0]} or fit {rel[i_fit]} "
          f"> {cg_tol}")
    check(np.isfinite(res.fun) and res.fun <= res.trace[0],
          "phase 4 fit did not improve")

    # mean for every held-out point; variance for the first
    # SIZES["var_queries"] of them: each variance column rides a
    # whitened CG of several hundred passes over the full operator
    # (1024 queries took 483 s on the H100, PR 1), which bounds the
    # run time
    t0 = time.perf_counter()
    server = IterativePredictor(fitted, X[:n], y[:n], cg_tol=cg_tol)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    mu, _ = server(X[n:], mean_only=True)
    t_mean = time.perf_counter() - t0
    m = SIZES["var_queries"]
    t0 = time.perf_counter()
    _, var = server(X[n:n + m], batch_size=m)
    t_var = time.perf_counter() - t0
    mse = float(np.mean((mu - y[n:]) ** 2))
    var_y = float(np.var(y[n:]))
    log(phase=4, serve_setup_s=t_setup, setup_cg_iters=server.setup_cg_iters,
        mean_s=t_mean, n_queries=n_test, mean_var_s=t_var, n_var_queries=m,
        test_mse=mse, var_y=var_y, var_min=float(np.min(var)),
        var_max=float(np.max(var)), var_cg_iters=server.last_cg_iters)
    check(mse < 0.2 * var_y, f"phase 4 holdout MSE {mse} >= 0.2 var(y)")
    check(bool(np.all(np.isfinite(var)) and np.all(var > 0)),
          "phase 4 variances not finite and positive")
    phase_estimator(rng)


def phase_estimator(rng, keys=8):
    """Stream CG+SLQ NLML against the exact materialized Cholesky value
    at the same hypers. The stream value is a stochastic estimate; its
    spread over `keys` probe draws sets the tolerance: the mean must lie
    within 4 standard errors of the exact value (plus the float32
    Cholesky's own 1e-5 relative)."""
    import jax
    import jax.numpy as jnp

    from gp_ss_ak_tpu.inference.iterative import IterativeGP, nlml_iterative
    from gp_ss_ak_tpu.model import default_model
    from gp_ss_ak_tpu.ops.gram import mapped_points

    n = SIZES["estimator"]
    X, y = field(rng, n)
    model = default_model(input_dim=3, dtype=jnp.float32)
    ep, bp = model.kernel_params
    Xm = mapped_points(model.kernel.children[0], ep,
                       jnp.asarray(X, jnp.float32))
    it_gp = IterativeGP(Xm=Xm, sigma=ep["Sigma"], bias=bp["Sigma"],
                        sn2=model.lik_hypers[0])
    yd = jnp.asarray(y, jnp.float32)
    key0 = jax.random.PRNGKey(0)
    exact = jax.jit(lambda: nlml_iterative(it_gp, yd, key0,
                                           mode="chol")[0])
    stream = jax.jit(lambda k: nlml_iterative(it_gp, yd, k,
                                              mode="stream")[::2])
    v_chol, t_chol = timed(exact)
    vals, iters, t_stream = [], [], []
    for s in range(keys):
        (v, it), t = timed(stream, jax.random.PRNGKey(100 + s))
        vals.append(float(v))
        iters.append(int(it))
        t_stream.append(t)
    vals = np.asarray(vals)
    se = float(np.std(vals, ddof=1) / math.sqrt(keys))
    tol = 4.0 * se + 1e-5 * abs(float(v_chol))
    dev = abs(float(np.mean(vals)) - float(v_chol))
    log(phase=4, estimator_n=n, nlml_chol=float(v_chol),
        nlml_stream=vals.tolist(), stream_mean=float(np.mean(vals)),
        stream_std_err=se, tolerance=tol, deviation=dev, cg_iters=iters,
        chol_s=t_chol, stream_s=t_stream)
    check(dev <= tol, f"phase 4 estimator |{dev}| > {tol}")


# ---------------------------------------------------------------------------
# phase 5 (--four)
# ---------------------------------------------------------------------------

def phase_four(rng):
    import jax
    import jax.numpy as jnp

    from gp_ss_ak_tpu.inference import predict
    from gp_ss_ak_tpu.inference.iterative import IterativeGP, nlml_iterative
    from gp_ss_ak_tpu.model import default_model
    from gp_ss_ak_tpu.ops.gram import mapped_points
    from gp_ss_ak_tpu.optim import make_value_and_grad
    from gp_ss_ak_tpu.parallel import (
        fit_distributed,
        make_dist_nlml_and_grad,
        make_dist_predict,
        make_mesh,
        make_ring_nlml_and_grad,
        shard_training_data,
    )

    check(len(jax.devices()) == 4, f"--four needs 4 GPUs, have "
          f"{len(jax.devices())}")
    mesh = make_mesh(4)
    model = default_model(input_dim=3, dtype=jnp.float32)
    flat = model.pack()

    # panel route against the single-card dense path
    n, nb = SIZES["panel"], 256
    X, y = field(rng, n + SIZES["queries"])
    Xtr, ytr, Xq = X[:n], y[:n], X[n:]
    Xs, ys, n_true, _ = shard_training_data(
        mesh, Xtr.astype(np.float32), ytr.astype(np.float32), nb=nb)
    dist = make_dist_nlml_and_grad(model.kernel, model.likelihood, mesh,
                                   n=n_true, nb=nb, grad_mode="exact")
    (v4, g4), t_first = timed(dist, flat, Xs, ys)
    (v4, g4), t_steady = timed(dist, flat, Xs, ys)
    vg = make_value_and_grad(model, Xtr, ytr)
    t0 = time.perf_counter()
    v1, g1 = vg(np.asarray(flat))
    t_one = time.perf_counter() - t0
    g4 = np.asarray(g4, np.float64)
    rel_v = abs(float(v4) - v1) / abs(v1)
    rel_g = float(np.linalg.norm(g4 - g1) / np.linalg.norm(g1))
    log(phase=5, route="panel", n=n, nlml_4=float(v4), nlml_1=v1,
        rel_err_value=rel_v, rel_err_grad=rel_g, first_call_s=t_first,
        steady_s=t_steady, one_card_s=t_one)
    check(rel_v <= 1e-4 and rel_g <= 1e-4,
          f"phase 5 panel value/grad rel err {rel_v} / {rel_g}")

    t0 = time.perf_counter()
    fitted, res = fit_distributed(model, Xtr, ytr, mesh, nb=nb, iters=2)
    log(phase=5, route="fit_distributed", iters=res.n_iters,
        nlml_start=res.trace[0], nlml_end=res.fun,
        wall_s=time.perf_counter() - t0)
    check(np.isfinite(res.fun) and res.fun <= res.trace[0],
          "phase 5 fit_distributed did not improve")

    pred = make_dist_predict(fitted.kernel, fitted.likelihood, mesh,
                             n=n_true, nb=nb)
    Xqd = jnp.asarray(Xq, jnp.float32)
    (mu4, var4), t_pred = timed(pred, fitted.pack(), Xs, ys, Xqd)
    mu1, var1 = predict(fitted.kernel, fitted.kernel_params,
                        fitted.lik_hypers, jnp.asarray(Xtr, jnp.float32),
                        jnp.asarray(ytr, jnp.float32), Xqd,
                        fitted.likelihood)
    mu4, var4 = np.asarray(mu4, np.float64), np.asarray(var4, np.float64)
    mu1, var1 = np.asarray(mu1, np.float64), np.asarray(var1, np.float64)
    # the variance is the prior variance minus a nearly equal term, so
    # its float32 error is measured against the prior variance
    prior = np.asarray(fitted.kernel.diag(fitted.kernel_params, Xqd)) \
        + float(fitted.likelihood.noise_variance(fitted.lik_hypers))
    err_mu = float(np.max(np.abs(mu4 - mu1)) / np.max(np.abs(mu1)))
    err_var = float(np.max(np.abs(var4 - var1) / prior))
    log(phase=5, route="dist_predict", n_queries=len(Xq), rel_err_mu=err_mu,
        err_var_over_prior=err_var, predict_s=t_pred)
    check(err_mu <= 1e-3 and err_var <= 1e-4,
          f"phase 5 dist predict errors {err_mu} / {err_var}")

    # ring route at N=100,000 against the single-card stream estimator
    # with the same probe counts (both stochastic; the tolerance is the
    # spread phase 4 measures between probe draws)
    n = SIZES["ring"]
    X, y = field(rng, n)
    Xs, ys, n_true, _ = shard_training_data(
        mesh, X.astype(np.float32), y.astype(np.float32), nb=nb)
    ring = make_ring_nlml_and_grad(model.kernel, mesh, n=n_true,
                                   probes=8, slq_probes=64,
                                   lanczos_iters=32, cg_tol=1e-3,
                                   cg_maxiter=800, with_stats=True)
    (vr, gr, st), t_first = timed(ring, flat, Xs, ys)
    ep, bp = model.kernel_params
    Xm = mapped_points(model.kernel.children[0], ep,
                       jnp.asarray(X, jnp.float32))
    it_gp = IterativeGP(Xm=Xm, sigma=ep["Sigma"], bias=bp["Sigma"],
                        sn2=model.lik_hypers[0])
    one = jax.jit(lambda k: nlml_iterative(
        it_gp, jnp.asarray(y, jnp.float32), k, cg_tol=1e-3, probes=64,
        lanczos_iters=32, mode="stream")[0])
    keys = 4
    vals, t_one = [], []
    for s in range(keys):
        v, t = timed(one, jax.random.PRNGKey(1 + s))
        vals.append(float(v))
        t_one.append(t)
    # the ring value is one draw of the same estimator (other probes):
    # its difference from the mean of `keys` one-card draws has
    # standard deviation sd * sqrt(1 + 1/keys)
    sd = float(np.std(vals, ddof=1))
    tol = 4.0 * sd * math.sqrt(1.0 + 1.0 / keys)
    dev = abs(float(vr) - float(np.mean(vals)))
    log(phase=5, route="ring", n=n, nlml_ring=float(vr),
        nlml_one_card_stream=vals, one_card_sd=sd, tolerance=tol,
        deviation=dev, ring_cg_iters=int(st[0]),
        ring_rel_residual=float(st[1]),
        grad_finite=bool(np.all(np.isfinite(np.asarray(gr)))),
        first_call_s=t_first, one_card_s=t_one)
    check(bool(np.all(np.isfinite(np.asarray(gr)))),
          "phase 5 ring gradient not finite")
    check(dev <= tol, f"phase 5 ring vs stream |{dev}| > {tol}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    args = ap.parse_args(argv)

    import jax

    from gp_ss_ak_tpu.utils.compile_cache import enable_compile_cache

    if jax.default_backend() != "gpu":
        print(f"chip_smoke: no GPU backend (found "
              f"{jax.default_backend()!r}); refusing to run",
              file=sys.stderr)
        return 2
    cache = enable_compile_cache()
    print(card_line(), flush=True)
    print(jax.devices(), flush=True)
    log(compile_cache=cache, jax=jax.__version__)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    if args.four:
        phase_four(rng)
    else:
        phase_dense_exactness(rng)
        with tempfile.TemporaryDirectory(dir=HERE) as tmp:
            phase_cli_dense(rng, tmp)
        phase_stream_kernel(rng)
        phase_large_fit(rng)
    log(total_s=time.perf_counter() - t0)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

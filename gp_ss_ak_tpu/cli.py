"""Command-line interface mirroring the reference binary's surface.

Usage (gp_ss_ak.cpp:14-63, 511-557):

  python -m gp_ss_ak_tpu [-v N] [-pm N] train [-k NAME]... [-o OPT]
         [-# ITERS] [-kn 0|1] [-mf NAME] [-lf NAME]
         [--init-params CSV] TRAIN_FILE [MODEL_NAME]

  python -m gp_ss_ak_tpu [-v N] [-pm N] test TEST_FILE MODEL_FILE
         TRAIN_FILE [OUTPUT_FILE]

Differences from the reference, by design (SURVEY.md §5):
- the interactive stdin prompts for initial kernel/likelihood values
  (gp_ss_ak.cpp:241-283) are replaced by --init-params / --init-lik;
- gnuplot is replaced by matplotlib (same Observed-vs-Estimated plot
  with a 95% band, written next to the prediction file);
- `-kn` actually works (the reference's `bool Knoise = "true"` is
  always true regardless of the flag, gp_ss_ak.cpp:81).

Output parity: train/test print MSE and var(y) (two bare numbers at
verbose 0, labeled at verbose > 0 — gp_ss_ak.cpp:312-325, 417-430);
the prediction file format and sorting match gp_ss_ak.cpp:434-481.
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import replace

import numpy as np


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gp_ss_ak_tpu",
        description="JAX GP engine with the GP_SS_AK capability set",
    )
    p.add_argument("-v", "--verboseL", type=int, default=0, dest="verbose")
    p.add_argument("-pm", "--prepMethod", type=int, default=1, dest="prep",
                   help="0: mean/std, 1: symmetric (default), 2: zero-one")
    sub = p.add_subparsers(dest="command", required=True)

    tr = sub.add_parser("train", help="fit hyperparameters by "
                        "maximizing the marginal likelihood")
    tr.add_argument("-k", "--kernel", action="append", default=[],
                    help="kernel name (repeatable): ExpAns (default), "
                    "RBF, Exp, Bias, White")
    tr.add_argument("-o", "--optimiser", default="LBFGS",
                    help="LBFGS (default) | BFGS | SCG | JIT "
                    "(whole fit in one on-device program; no "
                    "per-iteration logging)")
    tr.add_argument("-#", "--iterations", type=int, default=100,
                    dest="iters")
    tr.add_argument("-kn", "--Knoise", type=int, default=1,
                    help="append a Bias noise kernel (default 1)")
    tr.add_argument("-mf", "--meanfunction", default="mean_zero")
    tr.add_argument("-lf", "--likefunction", default="Gauss")
    tr.add_argument("--init-params", default=None,
                    help="comma-separated initial kernel params "
                    "(replaces the reference's stdin prompts)")
    tr.add_argument("--init-lik", type=float, default=None,
                    help="initial likelihood noise variance sn2")
    tr.add_argument("--engine", default="auto",
                    choices=("auto", "dense", "iterative", "dist",
                             "ring"),
                    help="NLML engine: dense Cholesky; the large-N "
                         "iterative engine (float32-only; materializes "
                         "A and factors it exactly while A and L fit "
                         "in device memory, then GEMM-backed CG+SLQ, "
                         "then streamed Gram tiles); 'dist' = "
                         "row-sharded exact path over every visible "
                         "device; 'ring' = panel-free ppermute ring "
                         "route; or auto by data size")
    tr.add_argument("--segmented", action="store_true",
                    help="with --engine iterative: run the stream "
                         "evaluator as bounded dispatches "
                         "(optim/segmented.py), with the solver state "
                         "on the host between them")
    tr.add_argument("--float64", action="store_true",
                    help="fit in float64 (CPU backends; ignored by "
                         "the iterative engine, which is float32-only)")
    tr.add_argument("train_file")
    tr.add_argument("model_name", nargs="?", default="gp_model")

    te = sub.add_parser("test", help="predict a test set with a "
                        "trained model and plot the results")
    te.add_argument("test_file")
    te.add_argument("model_file")
    te.add_argument("train_file")
    te.add_argument("output_file", nargs="?", default=None)
    te.add_argument("--no-plot", action="store_true")
    te.add_argument("--float64", action="store_true")
    te.add_argument("--engine", default="auto",
                    choices=("auto", "dense", "iterative"),
                    help="serving path: dense factorize-and-predict "
                         "(gaussian.predict) or the matrix-free "
                         "IterativePredictor (flagship models only, "
                         "incl. WarpedGaussian); auto picks iterative "
                         "past the dense N~32k memory wall")
    return p


def _dtype(args):
    import jax

    if getattr(args, "float64", False):
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    return jnp.float64 if getattr(args, "float64", False) else jnp.float32


def cmd_train(args) -> int:
    import jax.numpy as jnp

    from gp_ss_ak_tpu.data import prepare, read_data, unapply_y
    from gp_ss_ak_tpu.inference import predict
    from gp_ss_ak_tpu.model import default_model, save_model
    from gp_ss_ak_tpu.optim import fit
    from gp_ss_ak_tpu.optim.api import resolve_engine

    dtype = _dtype(args)
    X, y = read_data(args.train_file)
    Xs, ys, stats = prepare(X, y, args.prep)
    stats.save(args.model_name + "_Statistics.txt")
    if args.verbose > 0:
        print(f"Read {X.shape[0]} points, {X.shape[1]} features")

    names = args.kernel or ["ExpAns"]
    model = default_model(input_dim=X.shape[1], kernel_names=names,
                          knoise=bool(args.Knoise), dtype=dtype)
    lf = args.likefunction
    if lf != "Gauss":
        # "WarpGauss[:family[:m]]" — the reference wires only Gauss in
        # its CLI (anything else leaves likeLtype=-1, gp_ss_ak.cpp:192)
        # and exits on WarpGauss gradients; here it trains end-to-end.
        from gp_ss_ak_tpu.inference import WarpedGaussian

        parts = lf.split(":")
        if parts[0] not in ("WarpGauss", "warpgauss"):
            print(f"Unknown likelihood function: {lf}", file=sys.stderr)
            return 1
        family = parts[1] if len(parts) > 1 else "tanh1"
        m = int(parts[2]) if len(parts) > 2 else 1
        wlik = WarpedGaussian(family=family, n_triplets=m)
        model = replace(model, likelihood=wlik,
                        lik_hypers=jnp.asarray(wlik.default_hypers(dtype)))
    if args.init_params:
        vals = [float(t) for t in args.init_params.split(",")]
        if len(vals) != model.kernel.n_params:
            print(f"--init-params needs {model.kernel.n_params} values",
                  file=sys.stderr)
            return 1
        model = replace(model, kernel_params=model.kernel.unpack(
            jnp.asarray(vals, dtype)))
    if args.init_lik is not None:
        from gp_ss_ak_tpu.inference import WarpedGaussian as _WG

        if isinstance(model.likelihood, _WG):
            # warped models parameterize noise as exp(2 theta_last):
            # write into the last hyper, keep the warp triplets
            import math as _math

            lh = model.lik_hypers.at[-1].set(
                0.5 * _math.log(max(args.init_lik, 1e-12)))
            model = replace(model, lik_hypers=lh)
        else:
            model = replace(model,
                            lik_hypers=jnp.asarray([args.init_lik], dtype))

    if args.verbose > 0:
        print(f"Optimizing {model.n_params} hyperparameters with "
              f"{args.optimiser} ({args.iters} iters)")
    from gp_ss_ak_tpu.utils import FitLogger

    if args.float64 and getattr(args, "engine", "auto") == "iterative":
        print("Warning: --float64 is ignored by the iterative engine "
              "(matrix-free CG/SLQ runs in float32)", file=sys.stderr)
    logger = FitLogger(verbose=max(0, args.verbose - 1),
                       path=args.model_name + "_metrics.json")
    engine = getattr(args, "engine", "auto")
    if engine in ("dist", "ring"):
        # mesh over every visible device: the row-sharded exact path
        # ("dist", parallel/fit.fit_distributed) or the panel-free
        # ring route ("ring", fit_ring) — same optimizer contract
        import jax

        from gp_ss_ak_tpu.parallel import (
            fit_distributed,
            fit_ring,
            make_mesh,
        )

        mesh = make_mesh(len(jax.devices()))
        if engine == "dist":
            fitted, res = fit_distributed(
                model, Xs, ys, mesh, optimizer=args.optimiser,
                iters=args.iters, callback=logger,
                verbose=max(0, args.verbose - 1))
        else:
            fitted, res = fit_ring(
                model, Xs, ys, mesh, iters=args.iters, callback=logger,
                verbose=max(0, args.verbose - 1))
    else:
        engine_opts = (dict(segmented=True)
                       if getattr(args, "segmented", False) else None)
        fitted, res = fit(model, Xs, ys, optimizer=args.optimiser,
                          iters=args.iters, callback=logger,
                          engine=engine, engine_opts=engine_opts)
    logger.save()
    if args.verbose > 0:
        print(f"-logL: {res.trace[0]:.6f} -> {res.fun:.6f} "
              f"({res.n_iters} iters, {res.n_evals} evals)")
    save_model(fitted, args.model_name)

    if resolve_engine(engine, fitted, Xs.shape[0]) == "iterative":
        # past the dense wall: the matrix-free predictor, mean only
        from gp_ss_ak_tpu.serve import IterativePredictor

        mu, _ = IterativePredictor(fitted, Xs, ys)(Xs, mean_only=True)
    else:
        mu, _ = predict(fitted.kernel, fitted.kernel_params,
                        fitted.lik_hypers, jnp.asarray(Xs, dtype),
                        jnp.asarray(ys, dtype), jnp.asarray(Xs, dtype),
                        fitted.likelihood)
    yh = unapply_y(stats, np.asarray(mu))
    mse = float(np.mean((y - yh) ** 2))
    var_y = float(np.mean((y - y.mean()) ** 2))
    if args.verbose > 0:
        print(f"Mean Square Error of training: {mse}")
        print(f"Var MSE Train: {var_y}")
    else:
        print(mse)
        print(var_y)
    return 0


def cmd_test(args) -> int:
    import jax.numpy as jnp

    from gp_ss_ak_tpu.data import (
        Statistics,
        apply,
        read_data,
        unapply_var,
        unapply_y,
        write_predictions,
    )
    from gp_ss_ak_tpu.inference import predict
    from gp_ss_ak_tpu.model import load_model

    dtype = _dtype(args)
    model = load_model(args.model_file)
    stats = Statistics.load(args.model_file + "_Statistics.txt")

    Xt, yt = read_data(args.test_file)
    Xtr, ytr = read_data(args.train_file)
    if Xt.shape[1] != model.input_dim:
        print("Incorrect dimension of input data.", file=sys.stderr)
        return 1
    Xts = apply(stats, Xt)
    Xtrs, ytrs = apply(stats, Xtr, ytr)

    # past the dense wall (K + chol = 8 N^2 bytes), serve through the
    # matrix-free predictor — the reference contract at scale
    # (gp_ss_ak.cpp:332-508 on GP_Utils.cpp:943-1043); warped models
    # ride the same route (Gauss-Hermite mix applied inside)
    from gp_ss_ak_tpu.optim.iterative_fit import supports_iterative

    engine = getattr(args, "engine", "auto")
    use_iter = (engine == "iterative"
                or (engine == "auto" and Xtr.shape[0] > 32768)) \
        and supports_iterative(model)
    if engine == "iterative" and not supports_iterative(model):
        print("--engine iterative requires the flagship "
              "Sum([ExpAns, Bias]) model; falling back to dense",
              file=sys.stderr)
    if use_iter:
        from gp_ss_ak_tpu.serve import IterativePredictor

        server = IterativePredictor(model, Xtrs, ytrs)
        mu, var = server(Xts, batch_size=4096)
    else:
        mu, var = predict(model.kernel, model.kernel_params,
                          model.lik_hypers, jnp.asarray(Xtrs, dtype),
                          jnp.asarray(ytrs, dtype),
                          jnp.asarray(Xts, dtype), model.likelihood)
    yh = unapply_y(stats, np.asarray(mu))
    std = unapply_var(stats, np.asarray(var))

    mse = float(np.mean((yt - yh) ** 2))
    var_y = float(np.mean((yt - yt.mean()) ** 2))
    if args.verbose > 0:
        print(f"Mean Square Error of testing: {mse}")
        print(f"Var MSE Test: {var_y}")
    else:
        print(mse)
        print(var_y)

    out = args.output_file or (args.model_file + "_predict.txt")
    write_predictions(out, yt, yh, std, Xt)
    if not args.no_plot:
        _plot(out, args.model_file, yt, yh, std)
    return 0


def _plot(pred_file: str, model_name: str, y, yh, std) -> None:
    """Observed vs Estimated with a 95% band — the gnuplot replacement
    (gp_ss_ak.cpp:482-505)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    order = np.argsort(np.asarray(y), kind="stable")
    ys = np.asarray(y)[order]
    yhs = np.asarray(yh)[order]
    stds = np.asarray(std)[order]
    xs = np.arange(1, len(ys) + 1)
    fig, ax = plt.subplots(figsize=(9, 4.5))
    ax.fill_between(xs, yhs - stds, yhs + stds, alpha=0.35,
                    color="green", label="95% CI")
    ax.plot(xs, yhs, color="red", lw=1, label="Estimated")
    ax.plot(xs, ys, color="blue", lw=1, label="Observed")
    ax.set_title("Observed vs Estimated")
    ax.set_xlabel("Sample")
    ax.set_ylabel("Grade")
    ax.legend(loc="upper left")
    fig.tight_layout()
    fig.savefig(model_name + "_predict.pdf")
    plt.close(fig)


def main(argv=None) -> int:
    from gp_ss_ak_tpu.utils.compile_cache import enable_compile_cache

    args = _build_parser().parse_args(argv)
    cmd = {"train": cmd_train, "test": cmd_test}.get(args.command)
    if cmd is None:
        return 2
    enable_compile_cache()
    # Clean termination on user errors — the reference's
    # ErrorTermination -> exit(1) (ModelInf.h:84-88, Control.cpp:331-337)
    # without a Python traceback. `-v 3` keeps the full traceback for
    # debugging.
    try:
        return cmd(args)
    except FileNotFoundError as e:
        print(f"Error: file not found: {e.filename or e}", file=sys.stderr)
    except (ValueError, KeyError) as e:
        if args.verbose >= 3:
            raise
        print(f"Error: {e}", file=sys.stderr)
    except KeyboardInterrupt:
        print("Interrupted.", file=sys.stderr)
        return 130
    except Exception as e:  # noqa: BLE001 - CLI boundary
        if args.verbose >= 3:
            raise
        print(f"Error ({type(e).__name__}): {e}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())

"""Exact-GP NLML + gradient on the GPU against the CPU baseline, and
the kernel-level timings behind the stream-route choice.

    python bench.py              # headline: NLML+grad at N=4096
    python bench.py --kernels    # stream product routes, Gram, potrf

The reference publishes no numbers (BASELINE.md), so the baseline is
measured in-process: the same NLML + analytic gradient computed with
NumPy/LAPACK in float64 on the host CPU — a *generous* stand-in for
the reference binary (the shipped make_linux builds -O0 debug
Armadillo; NumPy's OpenBLAS is faster).

Workload: one full hyperparameter-optimization unit of work — build
the ExpAns+Bias Gram matrix (N x N), factor it, solve for alpha, get
the NLML and the gradient w.r.t. all 10 hyperparameters. This is the
hot loop of training (SURVEY.md §3.1: Grad_Values).

Refuses to run without a GPU backend. Every result line is one JSON
object naming the device (platform, device_kind, count) and the card
(name and power limit, from nvidia-smi).
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

N = 4096
D = 3
REPS = 50


def _problem():
    rng = np.random.default_rng(0)
    X = rng.uniform(-1.0, 1.0, size=(N, D))
    y = np.sin(X @ np.array([3.0, 1.0, 2.0]))
    return X, y


def device_info() -> dict:
    """The JAX device and the card it runs on; raises off a GPU."""
    import jax

    if jax.default_backend() != "gpu":
        raise RuntimeError(
            f"bench.py measures the GPU; backend is {jax.default_backend()!r}")
    dev = jax.devices()[0]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card}


def median_time(fn, *args, reps: int = 5) -> float:
    """Median seconds of `fn(*args)` after one warm-up call, each call
    fenced with block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def gpu_time():
    """Seconds per NLML+grad evaluation, timed as ONE on-device program
    of REPS serially-dependent evaluations (each input depends on the
    previous result, so nothing can be cached or elided)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from gp_ss_ak_tpu.model import default_model
    from gp_ss_ak_tpu.optim import flat_nlml_fn

    X, y = _problem()
    dtype = jnp.float32
    Xd = jnp.asarray(X, dtype)
    yd = jnp.asarray(y, dtype)
    model = default_model(input_dim=D, dtype=dtype)
    f = flat_nlml_fn(model)
    vg = jax.value_and_grad(lambda p: f(p, Xd, yd))
    flat = model.pack().astype(dtype)

    val, _ = jax.jit(vg)(flat)
    assert np.isfinite(float(val)), "GPU NLML not finite"

    @jax.jit
    def chain(p):
        def body(_, carry):
            p, s = carry
            v, g = vg(p + s * 1e-25)
            return (p, s + v * 1e-6 + jnp.sum(g) * 1e-9)
        _, s = lax.fori_loop(0, REPS, body, (p, jnp.asarray(0.0, dtype)))
        return s

    return median_time(chain, flat, reps=3) / REPS, float(val)


def _rotation_and_derivs(a, b, t):
    """R(alpha, beta, teta) per Kernel.cpp:1402-1410 plus dR/dangle."""
    ca, sa, cb, sb, ct, st = (math.cos(a), math.sin(a), math.cos(b),
                              math.sin(b), math.cos(t), math.sin(t))
    R = np.array([
        [ca * ct + sa * sb * st, -sa * ct + ca * sb * st, -cb * st],
        [sa * cb, ca * cb, sb],
        [ca * st - sa * sb * ct, -sa * st - ca * sb * ct, cb * ct],
    ])
    dRa = np.array([
        [-sa * ct + ca * sb * st, -ca * ct - sa * sb * st, 0.0],
        [ca * cb, -sa * cb, 0.0],
        [-sa * st - ca * sb * ct, -ca * st + sa * sb * ct, 0.0],
    ])
    dRb = np.array([
        [sa * cb * st, ca * cb * st, sb * st],
        [-sa * sb, -ca * sb, cb],
        [-sa * cb * ct, -ca * cb * ct, -sb * ct],
    ])
    dRt = np.array([
        [-ca * st + sa * sb * ct, sa * st + ca * sb * ct, -cb * ct],
        [0.0, 0.0, 0.0],
        [ca * ct + sa * sb * st, -sa * ct + ca * sb * st, -cb * st],
    ])
    return R, (dRa, dRb, dRt)


def cpu_nlml_grad(X, y, p):
    """NumPy float64 NLML + the REAL analytic gradient for every one of
    the 10 hyperparameters of the flagship ExpAns+Bias model, via the
    reference's QW-contraction structure (GP_Utils.cpp:1164-1220 for
    QW; Kernel.cpp:1176-1257 for the per-parameter distance-derivative
    matrices Di2). Fully BLAS-backed; each metric parameter costs one
    N x N GEMM plus an N^2 contraction — the same asymptotic work the
    reference does per parameter."""
    n = X.shape[0]
    R, dRs = _rotation_and_derivs(p["AngleX"], p["AngleY"], p["AngleZ"])
    lam = np.diag([p["iwx"], p["iwy"], p["iwz"]])
    M = R @ lam @ R.T
    A1 = X @ M
    sq = (A1 * A1).sum(1)
    D2 = sq[:, None] + sq[None, :] - 2.0 * A1 @ A1.T
    np.maximum(D2, 0.0, out=D2)
    np.fill_diagonal(D2, 0.0)
    sqrtD = np.sqrt(D2)
    E = np.exp(-sqrtD)
    sig2 = p["sigma"] ** 2
    K = sig2 * E + p["bias"]
    A = K + p["sn2"] * np.eye(n)
    L = np.linalg.cholesky(A)
    alpha = np.linalg.solve(A, y)
    nl = (0.5 * y @ alpha + np.log(np.diag(L)).sum()
          + 0.5 * n * math.log(2 * math.pi))
    Ainv = np.linalg.inv(A)
    QW = Ainv - np.outer(alpha, alpha)

    # dK/dD2 = -sig2 E / (2 sqrt(D2)), diagonal zeroed (the reference's
    # 0/0 dodge, Kernel.cpp:670-672 / 1181)
    with np.errstate(divide="ignore", invalid="ignore"):
        dK_dD2 = np.where(sqrtD > 0.0, -sig2 * E / (2.0 * sqrtD), 0.0)
    W = QW * dK_dD2  # shared contraction weights for all metric params

    def metric_grad(dM):
        # dD2/dtheta = 2 (u 1^T + 1 u^T - A1 dA1^T - dA1 A1^T),
        # u_i = A1_i . dA1_i  — one N^2 GEMM per parameter
        dA1 = X @ dM
        u = (A1 * dA1).sum(1)
        cross = A1 @ dA1.T
        di2 = u[:, None] + u[None, :] - cross - cross.T
        return 0.5 * 2.0 * np.sum(W * di2)

    grads = []
    for dR in dRs:  # angles: dM = dR lam R^T + R lam dR^T
        dM = dR @ lam @ R.T + R @ lam @ dR.T
        grads.append(metric_grad(dM))
    for k in range(3):  # inverse widths: dM = R e_k e_k^T R^T
        dlam = np.zeros((3, 3))
        dlam[k, k] = 1.0
        grads.append(metric_grad(R @ dlam @ R.T))
    grads.append(0.5 * np.sum(QW * (2.0 * p["sigma"] * E)))  # sigma
    grads.append(0.0)                                        # iwr (3-D data)
    grads.append(0.5 * np.sum(QW))                           # bias
    grads.append(0.5 * np.trace(QW))                         # sn2
    return nl, np.asarray(grads)


def cpu_time(reps: int = 3):
    """Median of `reps` full NLML+gradient evaluations."""
    X, y = _problem()
    p = {
        "AngleX": math.pi / 3.1, "AngleY": math.pi / 3.1,
        "AngleZ": math.pi / 3.1, "iwx": 1.5, "iwy": 1.5, "iwz": 1.3,
        "sigma": 0.9, "iwr": 0.6, "bias": 0.2, "sn2": 0.016,
    }
    # warm BLAS/threads with a small factorization so the timed runs
    # measure steady-state LAPACK, not one-time init/page faults
    w = np.linalg.cholesky(np.eye(512) + 0.1)
    _ = np.linalg.inv(np.eye(512) + np.outer(w[:, 0], w[:, 0]))
    times = []
    nl = float("nan")
    for _ in range(reps):
        t0 = time.perf_counter()
        nl, _g = cpu_nlml_grad(X, y, p)
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), nl


def kernel_rows():
    """The measurements behind ops/matvec.stream_route and the plain
    Gram build, one dict per row: E @ V on both routes at N in
    {65536, 100000} and B in {1, 9, 16, 32, 64}, the flagship Gram at
    N=32768 against its write floor, and float32 potrf at N=16384."""
    import jax
    import jax.numpy as jnp

    from gp_ss_ak_tpu.ops.gram import expans_bias_gram
    from gp_ss_ak_tpu.ops.matvec import triton_matmat, xla_matmat

    rng = np.random.default_rng(0)
    for n in (65536, 100000):
        X = jnp.asarray(rng.uniform(-1, 1, (n, D)), jnp.float32)
        for b in (1, 9, 16, 32, 64):
            V = jnp.asarray(rng.standard_normal((n, b)), jnp.float32)
            yield {"op": "stream_matmat", "n": n, "b": b,
                   "triton_s": median_time(triton_matmat, X, V),
                   "xla_s": median_time(xla_matmat, X, V)}
    n = 32768
    X = jnp.asarray(rng.uniform(-1, 1, (n, D)), jnp.float32)
    gram = jax.jit(lambda x: expans_bias_gram(x, 0.9, 0.2, 0.016))
    yield {"op": "gram", "n": n, "s": median_time(gram, X),
           "write_floor_s_at_3.35TBps": 4.0 * n * n / 3.35e12}
    A = gram(X)[:16384, :16384]
    yield {"op": "potrf_f32", "n": 16384,
           "s": median_time(jax.jit(jnp.linalg.cholesky), A)}


def main(argv=None):
    import argparse

    from gp_ss_ak_tpu.utils.compile_cache import enable_compile_cache

    ap = argparse.ArgumentParser(description="GPU benchmark")
    ap.add_argument("--kernels", action="store_true",
                    help="time the stream product routes, the Gram "
                         "build and potrf instead of the headline")
    args = ap.parse_args(argv)
    enable_compile_cache()
    dev = device_info()
    if args.kernels:
        for row in kernel_rows():
            print(json.dumps({**row, "device": dev}), flush=True)
        return 0
    cpu_dt, cpu_val = cpu_time()
    gpu_dt, gpu_val = gpu_time()
    speedup = cpu_dt / gpu_dt
    import multiprocessing
    blas = "unknown"
    try:
        cfg = np.__config__.CONFIG["Build Dependencies"]["blas"]
        blas = f'{cfg.get("name")} {cfg.get("version")}'
    except Exception:  # noqa: BLE001 - cosmetic only
        pass
    print(json.dumps({
        "metric": f"nlml_grad_speedup_vs_cpu_f64_n{N}",
        "value": speedup,
        "unit": "x",
        "gpu_ms": gpu_dt * 1e3,
        "cpu_ms": cpu_dt * 1e3,
        "gpu_nlml": gpu_val,
        "cpu_nlml": cpu_val,
        "device": dev,
        "cpu_env": {"cores": multiprocessing.cpu_count(), "blas": blas},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

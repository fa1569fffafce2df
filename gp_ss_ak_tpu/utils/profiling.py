"""Profiling helpers (SURVEY.md §5 "tracing / profiling").

- `trace(dir)`: context manager around jax.profiler for Perfetto/
  TensorBoard traces of the device timeline.
- `timeit_fn`: wall-clock a jitted callable with proper
  block_until_ready fencing and warmup.
- flop estimators for the two hot phases (Gram build, Cholesky) so
  benchmarks report achieved vs speed-of-light TFLOP/s — the
  BASELINE.md headline metric.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def timeit_fn(fn: Callable, *args, reps: int = 10,
              warmup: int = 1) -> float:
    """Median-free simple average seconds per call, fenced."""
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def gram_flops(n: int, m: int, d: int) -> int:
    """2nmd matmul + ~8 VPU ops per element (sq-dist assembly, sqrt,
    exp, adds)."""
    return 2 * n * m * d + 8 * n * m


def cholesky_flops(n: int) -> int:
    return n ** 3 // 3


def solve_flops(n: int, rhs: int) -> int:
    return 2 * n * n * rhs


def achieved_tflops(flops: int, seconds: float) -> float:
    return flops / seconds / 1e12


def chain_timeit(step: Callable, init, reps: int = 10, args=()) -> float:
    """Elision-proof per-call seconds for `step(z, s, *args) -> f32
    scalar`.

    Runs `reps` serially-dependent evaluations inside ONE jitted
    fori_loop (each call's input is perturbed by the running scalar
    `s`, so no dispatch pipelining, result caching or dead-code
    elimination can shrink the measurement) and returns the median
    over three such chains divided by `reps`. Pass large device arrays
    through `args` rather than closing over them (closure constants
    are embedded in the compiled program). `init` must be a float
    array (the timed invocation uses a slightly different input than
    the compile one).
    """
    import jax.numpy as jnp
    from jax import lax

    @jax.jit
    def chain(z, *extra):
        def body(_, carry):
            z, s = carry
            return (z, s + step(z, s, *extra))
        _, s = lax.fori_loop(0, reps, body,
                             (z, jnp.asarray(0.0, jnp.float32)))
        return s
    jax.block_until_ready(chain(init, *args))  # compile

    totals = []
    for k in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(init + (k + 1) * 1e-7, *args))
        totals.append(time.perf_counter() - t0)
    totals.sort()
    return totals[1] / reps

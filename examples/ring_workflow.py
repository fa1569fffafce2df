"""Ring-distributed training walkthrough — the route past the
row-panel wall.

fit_distributed (examples/distributed_workflow.py) materializes each
device's (n_local, N) row panel of the kernel matrix; at N ~ 10^5+
even the panel exceeds HBM. The ring route never holds anything larger
than an (n_local, n_local) tile: X blocks rotate around the mesh via
ppermute (structurally ring attention, SURVEY.md §5), every solve is a
ring batched PCG with a ring-built pivoted-Cholesky preconditioner,
and the logdet comes from preconditioned stochastic Lanczos.

Runs on the simulated 8-device CPU mesh or a real slice unchanged:

  python examples/ring_workflow.py
"""

import os

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

if os.environ.get("GP_EXAMPLES_CPU") or jax.default_backend() != "gpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

from gp_ss_ak_tpu.model import default_model  # noqa: E402
from gp_ss_ak_tpu.parallel import (  # noqa: E402
    fit_ring,
    make_mesh,
    make_ring_posterior_mean,
    shard_training_data,
)

rng = np.random.default_rng(3)
n, d = 512, 3
X = rng.uniform(-2.0, 2.0, size=(n, d))
y = np.sin(2.0 * X[:, 0]) + 0.5 * np.cos(X[:, 1]) \
    + 0.05 * rng.standard_normal(n)

mesh = make_mesh(min(8, len(jax.devices())))
model = default_model(input_dim=d)

# --- train: L-BFGS-B over the ring matrix-free NLML ------------------
fitted, res = fit_ring(model, X, y, mesh, nb=16, iters=25,
                       precond_rank=48, probes=8, slq_probes=16,
                       lanczos_iters=24, verbose=0)
print(f"ring fit: NLML {res.trace[0]:.2f} -> {res.fun:.2f} "
      f"in {res.n_iters} iters / {res.n_evals} evals")

# --- predict: ring CG posterior mean ---------------------------------
Xq = rng.uniform(-2.0, 2.0, size=(64, d))
Xs, ys, ntrue, _ = shard_training_data(
    mesh, X.astype(np.asarray(fitted.pack()).dtype),
    y.astype(np.asarray(fitted.pack()).dtype), nb=16)
pm = make_ring_posterior_mean(fitted.kernel, mesh, n=ntrue, tol=1e-8)
mu, it, resid = pm(fitted.pack(), Xs, ys, np.asarray(Xq))
truth = np.sin(2.0 * Xq[:, 0]) + 0.5 * np.cos(Xq[:, 1])
mse = float(np.mean((np.asarray(mu) - truth) ** 2))
print(f"ring posterior mean on 64 held-out points: mse {mse:.4f} "
      f"(cg iters {int(it)})")
assert mse < 0.1, mse
print("ok")

"""Distributed training + serving walkthrough.

Runs on any device set: the GPUs of one host, or (as here, for a
laptop/CI) a simulated 8-device CPU mesh. The exact same shard_map programs run in
either case — that is the point.

  python examples/distributed_workflow.py
"""

import os

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

# GP_EXAMPLES_CPU=1 forces the simulated CPU mesh even when a GPU is
# present
if os.environ.get("GP_EXAMPLES_CPU") or jax.default_backend() != "gpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from gp_ss_ak_tpu.model import default_model  # noqa: E402
from gp_ss_ak_tpu.parallel import (  # noqa: E402
    fit_distributed,
    make_dist_predict,
    make_mesh,
    make_ring_posterior_mean,
    shard_training_data,
)

dtype = jnp.float32 if jax.default_backend() == "gpu" else jnp.float64

# synthetic 3-D ore-grade-like problem
rng = np.random.default_rng(0)
n = 512
X = rng.uniform(0, 10, (n, 3))
y = np.sin(0.7 * X[:, 0]) + 0.5 * np.cos(0.5 * X[:, 1]) + 0.1 * X[:, 2]

mesh = make_mesh()  # all local devices on axis "dp"
print(f"mesh: {mesh.devices.shape} {mesh.axis_names}")

# --- distributed fit: row-sharded Gram + block Cholesky per eval -----
model = default_model(input_dim=3, dtype=dtype)
fitted, res = fit_distributed(model, X, y, mesh, nb=64, iters=30,
                              grad_mode="exact")
print(f"fit: NLML {res.trace[0]:.2f} -> {res.fun:.2f} "
      f"({res.n_iters} iters)")

# --- distributed prediction ------------------------------------------
Xs, ys, ntrue, _ = shard_training_data(
    mesh, np.asarray(X, dtype), np.asarray(y, dtype), nb=64)
predict = make_dist_predict(fitted.kernel, fitted.likelihood, mesh,
                            n=ntrue, nb=64)
Xq = jnp.asarray(rng.uniform(0, 10, (8, 3)), dtype)
mu, var = predict(fitted.pack(), Xs, ys, Xq)
print("posterior mean:", np.round(np.asarray(mu), 3))

# --- ring path: K never exists, not even as a row panel --------------
ring_mean = make_ring_posterior_mean(fitted.kernel, mesh, n=ntrue,
                                     tol=1e-6)
mu_ring, cg_iters, resid = ring_mean(fitted.pack(), Xs, ys, Xq)
print(f"ring mean (CG {int(cg_iters)} iters): "
      f"{np.round(np.asarray(mu_ring), 3)}")
assert np.allclose(np.asarray(mu), np.asarray(mu_ring), atol=1e-3)
print("distributed == ring: OK")

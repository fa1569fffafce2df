"""Bayesian hyperposterior walkthrough: NUTS over the GP hypers,
convergence diagnostics, and predictive mixing.

  python examples/bayes_workflow.py
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

from gp_ss_ak_tpu.bayes import (  # noqa: E402
    predictive_mixture,
    sample_hyperposterior,
    summarize,
)
from gp_ss_ak_tpu.model import default_model  # noqa: E402
from gp_ss_ak_tpu.parallel import make_mesh  # noqa: E402

rng = np.random.default_rng(1)
n = 40
X = np.linspace(-1, 1, n).reshape(-1, 1)
y = np.sin(3 * X[:, 0]) + 0.1 * rng.standard_normal(n)

model = default_model(input_dim=1)

# chains sharded over the mesh (embarrassingly parallel axis)
mesh = make_mesh()
theta, accept = sample_hyperposterior(
    model, X, y, jax.random.PRNGKey(0), n_samples=150, n_warmup=150,
    n_chains=4, sampler="nuts", mesh=mesh)

diag = summarize(np.asarray(theta))
print("max R-hat:", float(np.max(diag["rhat"])))
print("min bulk ESS:", float(np.min(diag["ess"])),
      "| min tail ESS:", float(np.min(diag["ess_tail"])))

Xq = np.linspace(-1, 1, 9).reshape(-1, 1)
mu, var = predictive_mixture(model, X, y, Xq, theta, thin=5)
print("mixed predictive mean:", np.round(np.asarray(mu), 3))
print("mixed predictive sd:  ",
      np.round(np.sqrt(np.asarray(var)), 3))

"""End-to-end example: the reference's train/test workflow plus the
extensions (serving, Bayes, ensembles, distributed).

Run anywhere (CPU ok): python examples/full_workflow.py
"""

import numpy as np
import jax
import jax.numpy as jnp

from gp_ss_ak_tpu.data import (MODE_SYMMETRIC, prepare, read_data,
                               unapply_var, unapply_y, write_data, apply)
from gp_ss_ak_tpu.model import default_model, load_model, save_model
from gp_ss_ak_tpu.optim import fit
from gp_ss_ak_tpu.serve import Predictor

# --- synthetic ore body ----------------------------------------------------
rng = np.random.default_rng(0)
X = rng.uniform(0, 500, size=(300, 3))
y = 1.5 + np.sin(X @ np.array([0.01, 0.004, 0.02])) + 0.05 * rng.normal(size=300)
write_data("/tmp/ex_train.txt", X[:250], y[:250])
write_data("/tmp/ex_test.txt", X[250:], y[250:])

# --- train (symmetric standardization + ExpAns + Bias noise) ---------------
Xtr, ytr = read_data("/tmp/ex_train.txt")
Xs, ys, stats = prepare(Xtr, ytr, MODE_SYMMETRIC)
model, res = fit(default_model(input_dim=3), Xs, ys, iters=60)
save_model(model, "/tmp/ex_model")
stats.save("/tmp/ex_model_Statistics.txt")
print(f"trained: -logL {res.trace[0]:.2f} -> {res.fun:.2f}")

# --- serve -----------------------------------------------------------------
Xte, yte = read_data("/tmp/ex_test.txt")
server = Predictor(model, Xs, ys)
mu, var = server(apply(stats, Xte))
yh = unapply_y(stats, mu)
print(f"test MSE {np.mean((yh - yte)**2):.4f} (var {np.var(yte):.4f})")

# --- Bayesian hyperposterior ----------------------------------------------
from gp_ss_ak_tpu.bayes import predictive_mixture, sample_hyperposterior

theta, accept = sample_hyperposterior(model, Xs[:80], ys[:80],
                                      jax.random.PRNGKey(0), n_samples=80,
                                      n_warmup=120, n_chains=2)
mu_b, var_b = predictive_mixture(model, Xs[:80], ys[:80], Xs[:80],
                                 theta, thin=8)
fit_mse = float(np.mean((np.asarray(mu_b) - np.asarray(ys[:80]))**2))
print(f"bayes: mean accept {float(np.mean(np.asarray(accept))):.2f}, "
      f"posterior-mixed in-sample MSE {fit_mse:.4f}")

# --- distributed (simulated mesh works too) --------------------------------
if len(jax.devices()) > 1:
    from gp_ss_ak_tpu.parallel import fit_distributed, make_mesh

    mesh = make_mesh()
    dmodel, dres = fit_distributed(default_model(3), Xs, ys, mesh,
                                   nb=32, iters=30)
    print(f"distributed fit on {len(mesh.devices)} devices: "
          f"-logL -> {dres.fun:.2f}")

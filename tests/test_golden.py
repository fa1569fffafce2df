"""Golden regression suite.

Fixtures in tests/golden/ were generated by the float64 CPU path
(trained ExpAns+Bias model on a synthetic 3-D ore body) and committed.
These tests pin (a) the model/statistics file formats across rounds,
(b) the full load -> standardize -> factorize -> predict numerical
path against stored expectations, and (c) fit quality — the closest
available stand-in for the reference-binary parity tests SURVEY.md §4
prescribes (the reference needs Armadillo, absent in this image).
"""

import os

import jax.numpy as jnp
import numpy as np

from gp_ss_ak_tpu.data import (
    MODE_SYMMETRIC,
    Statistics,
    apply,
    read_data,
    unapply_var,
    unapply_y,
)
from gp_ss_ak_tpu.inference import nlml, predict
from gp_ss_ak_tpu.model import load_model

HERE = os.path.join(os.path.dirname(__file__), "golden")


class TestGolden:
    def setup_method(self):
        self.model = load_model(os.path.join(HERE, "model"))
        self.stats = Statistics.load(
            os.path.join(HERE, "model_Statistics.txt"))
        self.Xtr, self.ytr = read_data(os.path.join(HERE, "train.txt"))
        self.Xte, self.yte = read_data(os.path.join(HERE, "test.txt"))
        z = np.load(os.path.join(HERE, "expected.npz"))
        self.exp_mu, self.exp_std = z["mu"], z["std"]
        self.exp_nlml = float(z["nlml"])

    def _standardized(self):
        Xtrs, ytrs = apply(self.stats, self.Xtr, self.ytr)
        Xtes = apply(self.stats, self.Xte)
        return Xtrs, ytrs, Xtes

    def test_model_file_loads_with_expected_structure(self):
        m = self.model
        assert m.kernel.n_params == 9
        assert m.input_dim == 3
        flat = np.asarray(m.pack())
        assert (flat >= 1e-4 - 1e-12).all() and (flat <= 6.0 + 1e-12).all()

    def test_nlml_matches_stored_value(self):
        Xtrs, ytrs, _ = self._standardized()
        val = float(nlml(self.model.kernel, self.model.kernel_params,
                         self.model.lik_hypers, jnp.asarray(Xtrs),
                         jnp.asarray(ytrs), self.model.likelihood))
        np.testing.assert_allclose(val, self.exp_nlml, rtol=1e-8)

    def test_predictions_match_stored_values(self):
        Xtrs, ytrs, Xtes = self._standardized()
        mu, var = predict(self.model.kernel, self.model.kernel_params,
                          self.model.lik_hypers, jnp.asarray(Xtrs),
                          jnp.asarray(ytrs), jnp.asarray(Xtes),
                          self.model.likelihood)
        yh = unapply_y(self.stats, np.asarray(mu))
        std = unapply_var(self.stats, np.asarray(var))
        np.testing.assert_allclose(yh, self.exp_mu, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(std, self.exp_std, rtol=1e-7,
                                   atol=1e-10)

    def test_holdout_quality(self):
        mse = float(np.mean((self.exp_mu - self.yte) ** 2))
        assert mse < 0.05 * float(np.var(self.yte)) + 0.02

    def test_fused_path_matches_golden(self):
        """The flagship's own Gram build over metric-mapped points
        (ops/gram.py — what the materialized and streamed engines run)
        reproduces the golden predictive mean."""
        from gp_ss_ak_tpu.kernels.distance import pad_to_3d
        from gp_ss_ak_tpu.ops.gram import expans_bias_gram

        Xtrs, ytrs, Xtes = self._standardized()
        ep, bp = self.model.kernel_params
        expans = self.model.kernel.children[0]
        Xp, Xsp = pad_to_3d(jnp.asarray(Xtrs)), pad_to_3d(jnp.asarray(Xtes))
        c = jnp.mean(Xp, axis=0)
        M = expans.metric(ep, Xp.shape[-1])
        Xm, Xsm = (Xp - c) @ M, (Xsp - c) @ M
        sn2 = self.model.likelihood.noise_variance(self.model.lik_hypers)
        A = expans_bias_gram(Xm, ep["Sigma"], bp["Sigma"], sn2)
        kX = expans_bias_gram(Xm, ep["Sigma"], bp["Sigma"], Xm2=Xsm)
        mu_f = kX.T @ jnp.linalg.solve(A, jnp.asarray(ytrs))
        yh = unapply_y(self.stats, np.asarray(mu_f))
        np.testing.assert_allclose(yh, self.exp_mu, rtol=1e-7, atol=1e-9)

"""Exact-inference math: NLML, gradients, posterior, Laplace, warping."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gp_ss_ak_tpu.inference import (
    Gaussian,
    WarpedGaussian,
    factorize,
    laplace,
    nlml,
    posterior_mean_var,
    predict,
    warping,
)
from gp_ss_ak_tpu.kernels import Bias, ExpAns, RBF, Sum

import oracle

RNG = np.random.default_rng(7)


def make_problem(n=12, d=3):
    X = RNG.normal(size=(n, d))
    y = np.sin(X[:, 0]) + 0.1 * RNG.normal(size=n)
    kern = Sum([ExpAns(), Bias()])
    params = kern.init_params(jnp.float64)
    sn2 = 0.016
    return kern, params, jnp.asarray([sn2]), jnp.asarray(X), jnp.asarray(y)


class TestNLML:
    def test_matches_oracle_b_form(self):
        kern, params, lh, X, y = make_problem()
        got = float(nlml(kern, params, lh, X, y))
        K = np.asarray(kern.matrix(params, X, X, same=True))
        want = oracle.gauss_nlml(K, np.asarray(y), float(lh[0]))
        # our A-form and the reference B-form differ only in constants
        # folded together: B-form L lacks nothing — they are equal.
        assert got == pytest.approx(want, rel=1e-9)

    def test_three_point_hand_value(self):
        # closed-form check on a hand-computable 1-point problem
        kern = Bias()
        params = {"Sigma": jnp.asarray(0.5)}
        X = jnp.asarray([[0.0]])
        y = jnp.asarray([2.0])
        sn2 = 0.25
        got = float(nlml(kern, params, jnp.asarray([sn2]), X, y))
        var = 0.5 + sn2
        want = 0.5 * (4.0 / var) + 0.5 * math.log(var) + \
            0.5 * math.log(2 * math.pi)
        assert got == pytest.approx(want, rel=1e-12)

    def test_gradient_matches_finite_differences(self):
        kern, params, lh, X, y = make_problem(n=10)
        flat0 = np.concatenate([np.asarray(kern.pack(params)),
                                np.asarray(lh)])
        # move off the reference's degenerate init (equal x/y widths
        # make the metric AngleX-invariant with a zero true gradient)
        flat0 = flat0 * (1.0 + 0.17 * RNG.normal(size=flat0.shape))
        flat0 = np.abs(flat0) + 0.05

        def f_np(flat):
            kp = kern.unpack(jnp.asarray(flat[:-1]))
            return float(nlml(kern, kp, jnp.asarray(flat[-1:]), X, y))

        def f_jx(flat):
            kp = kern.unpack(flat[:-1])
            return nlml(kern, kp, flat[-1:], X, y)

        g_jax = np.asarray(jax.grad(f_jx)(jnp.asarray(flat0)))
        g_num = oracle.numeric_grad(f_np, flat0, eps=1e-6)
        np.testing.assert_allclose(g_jax, g_num, rtol=2e-5, atol=1e-7)

    def test_chol_failure_is_nan(self):
        kern = Bias()
        params = {"Sigma": jnp.asarray(-5.0)}  # K = -5 everywhere
        X = jnp.asarray(RNG.normal(size=(4, 1)))
        y = jnp.asarray(RNG.normal(size=4))
        val = float(nlml(kern, params, jnp.asarray([1e-6]), X, y))
        assert math.isnan(val)

    @pytest.mark.parametrize("grad_mode", ["autodiff", "qw"])
    def test_indefinite_flagship_A_is_nan(self, grad_mode):
        """The reference's Chol_fail protocol (GP_Utils.cpp:884-915):
        an indefinite A = K + sn2 I (here sn2 far below -lambda_min)
        surfaces as a NaN objective through the factorization, in both
        gradient schedules, instead of raising."""
        from gp_ss_ak_tpu.model import default_model

        m = default_model(3)
        X = jnp.asarray(RNG.uniform(-1, 1, size=(64, 3)))
        y = jnp.sin(X.sum(1))
        val = nlml(m.kernel, m.kernel_params, jnp.asarray([-50.0]), X, y,
                   grad_mode=grad_mode)
        assert math.isnan(float(val))


class TestPosterior:
    def test_matches_oracle(self):
        kern, params, lh, X, y = make_problem(n=15)
        Xs = jnp.asarray(RNG.normal(size=(7, 3)))
        mu, var = predict(kern, params, lh, X, y, Xs)
        K = np.asarray(kern.matrix(params, X, X, same=True))
        kX = np.asarray(kern.matrix(params, X, Xs))
        kdiag = np.asarray(kern.diag(params, Xs))
        mu_o, var_o = oracle.gauss_posterior(K, kX, kdiag, np.asarray(y),
                                             float(lh[0]))
        np.testing.assert_allclose(np.asarray(mu), mu_o, rtol=1e-8)
        np.testing.assert_allclose(np.asarray(var), var_o, rtol=1e-7)

    def test_interpolates_training_data_at_low_noise(self):
        kern = RBF()
        params = {"Hayper_Euc": jnp.asarray(1.0),
                  "inverseWidth": jnp.asarray(1.0),
                  "Sigma": jnp.asarray(1.0)}
        X = jnp.linspace(-2, 2, 9).reshape(-1, 1)
        y = jnp.sin(X[:, 0])
        mu, var = predict(kern, params, jnp.asarray([1e-8]), X, y, X)
        np.testing.assert_allclose(np.asarray(mu), np.asarray(y), atol=1e-4)

    def test_variance_positive_and_grows_off_data(self):
        kern, params, lh, X, y = make_problem()
        near = X[:3]
        far = jnp.asarray(RNG.normal(size=(3, 3)) + 50.0)
        _, var_near = predict(kern, params, lh, X, y, near)
        _, var_far = predict(kern, params, lh, X, y, far)
        assert (np.asarray(var_near) >= 0).all()
        assert np.asarray(var_far).min() > np.asarray(var_near).max()


class TestLaplace:
    def test_laplace_equals_exact_for_gaussian(self):
        kern, params, lh, X, y = make_problem(n=10)
        K = kern.matrix(params, X, X, same=True)
        sn2 = float(lh[0])

        def log_prob(yy, ff):
            return -((yy - ff) ** 2) / (2 * sn2) - 0.5 * jnp.log(
                2 * jnp.pi * sn2)

        got = float(laplace.nlml(K, y, log_prob))
        want = float(nlml(kern, params, lh, X, y))
        assert got == pytest.approx(want, rel=1e-6)


class TestWarping:
    def test_identityish_warp_matches_plain(self):
        kern, params, _, X, y = make_problem(n=10)
        # a ~ exp(-12) makes the tanh warp numerically the identity;
        # noise theta chosen so exp(2 theta) = 0.016
        theta_noise = 0.5 * math.log(0.016)
        lh_w = jnp.asarray([-12.0, 0.0, 0.0, theta_noise])
        wlik = WarpedGaussian(family=warping.TANH1, n_triplets=1)
        got = float(nlml(kern, params, lh_w, X, y, likelihood=wlik))
        want = float(nlml(kern, params, jnp.asarray([0.016]), X, y))
        assert got == pytest.approx(want, rel=1e-5)

    def test_warp_inverse_roundtrip_tanh(self):
        theta = jnp.asarray([0.3, -0.2, 0.5])
        y = jnp.linspace(-2.0, 2.0, 11)
        gy, _ = warping.warp(warping.TANH1, theta, y)
        back = warping.inverse(warping.TANH1, theta, gy)
        np.testing.assert_allclose(np.asarray(back), np.asarray(y),
                                   atol=1e-6)

    def test_warp_monotone(self):
        theta = jnp.asarray([0.5, 0.7, -0.1])
        y = jnp.linspace(-3, 3, 101)
        gy, lgpy = warping.warp(warping.TANH1, theta, y)
        assert (np.diff(np.asarray(gy)) > 0).all()
        assert np.isfinite(np.asarray(lgpy)).all()

    def test_warped_prediction_runs(self):
        kern, params, _, X, y = make_problem(n=10)
        lh_w = jnp.asarray([-2.0, 0.1, 0.2, 0.5 * math.log(0.05)])
        wlik = WarpedGaussian(family=warping.TANH1, n_triplets=1)
        Xs = X[:4]
        mu, var = predict(kern, params, lh_w, X, y, Xs, likelihood=wlik)
        assert np.isfinite(np.asarray(mu)).all()
        assert (np.asarray(var) >= 0).all()


class TestLaplacePredict:
    def test_matches_exact_for_gaussian(self):
        kern, params, lh, X, y = make_problem(n=12)
        sn2 = float(lh[0])

        def log_prob(yy, ff):
            return -((yy - ff) ** 2) / (2 * sn2) - 0.5 * jnp.log(
                2 * jnp.pi * sn2)

        Xs = X[:5]
        mu_l, var_l = laplace.predict_latent(kern, params, X, y,
                                             log_prob, Xs)
        mu_e, var_e = predict(kern, params, lh, X, y, Xs)
        np.testing.assert_allclose(np.asarray(mu_l), np.asarray(mu_e),
                                   rtol=1e-5, atol=1e-7)
        # exact path adds observation noise sn2; latent var excludes it
        np.testing.assert_allclose(np.asarray(var_l) + sn2,
                                   np.asarray(var_e), rtol=1e-4,
                                   atol=1e-6)


class TestWarpedTraining:
    def test_fitting_warped_model_improves_nlml(self):
        # the reference EXITS on WarpGauss gradients (GP_Utils.cpp:865-869);
        # jax.grad makes warped-likelihood training just work
        kern, params, _, X, y = make_problem(n=16)
        wlik = WarpedGaussian(family=warping.TANH1, n_triplets=1)
        lh0 = jnp.asarray([0.1, 0.1, 0.1, 0.5 * math.log(0.05)])

        def obj(lh):
            return nlml(kern, params, lh, X, y, likelihood=wlik)

        g = jax.grad(obj)(lh0)
        assert np.isfinite(np.asarray(g)).all()
        # one gradient step improves the objective
        lh1 = lh0 - 0.01 * g
        assert float(obj(lh1)) < float(obj(lh0))


class TestQWGradMode:
    def test_values_and_grads_match_autodiff(self):
        kern, params, lh, X, y = make_problem(n=14)
        flat0 = np.concatenate([np.asarray(kern.pack(params)),
                                np.asarray(lh)])
        flat0 = np.abs(flat0 * (1 + 0.15 * RNG.normal(size=flat0.shape))) \
            + 0.05

        def obj(flat, mode):
            kp = kern.unpack(flat[:-1])
            return nlml(kern, kp, flat[-1:], X, y, grad_mode=mode)

        v_a = float(obj(jnp.asarray(flat0), "autodiff"))
        v_q = float(obj(jnp.asarray(flat0), "qw"))
        assert v_a == pytest.approx(v_q, rel=1e-10)
        g_a = np.asarray(jax.grad(lambda f: obj(f, "autodiff"))(
            jnp.asarray(flat0)))
        g_q = np.asarray(jax.grad(lambda f: obj(f, "qw"))(
            jnp.asarray(flat0)))
        np.testing.assert_allclose(g_q, g_a, rtol=1e-7, atol=1e-10)

    def test_qw_with_warped_likelihood(self):
        kern, params, _, X, y = make_problem(n=12)
        wlik = WarpedGaussian(family=warping.TANH1, n_triplets=1)
        lh = jnp.asarray([0.2, 0.1, 0.0, 0.5 * math.log(0.05)])

        def obj(lhv, mode):
            return nlml(kern, params, lhv, X, y, likelihood=wlik,
                        grad_mode=mode)

        g_a = np.asarray(jax.grad(lambda v: obj(v, "autodiff"))(lh))
        g_q = np.asarray(jax.grad(lambda v: obj(v, "qw"))(lh))
        np.testing.assert_allclose(g_q, g_a, rtol=1e-6, atol=1e-9)


class TestRbfWarpFamily:
    def test_rbf_warp_nlml_and_predict(self):
        kern, params, _, X, y = make_problem(n=12)
        wlik = WarpedGaussian(family=warping.RBFW, n_triplets=1)
        lh = jnp.asarray([-1.0, 0.5, 0.3, 0.5 * math.log(0.05)])
        v = float(nlml(kern, params, lh, X, y, likelihood=wlik))
        assert np.isfinite(v)
        mu, var = predict(kern, params, lh, X, y, X[:4], likelihood=wlik)
        assert np.isfinite(np.asarray(mu)).all()
        assert (np.asarray(var) >= 0).all()

    def test_srbf_warp_nlml(self):
        kern, params, _, X, y = make_problem(n=10)
        wlik = WarpedGaussian(family=warping.SRBF, n_triplets=1)
        lh = jnp.asarray([0.3, 1.2, 0.1, 0.5 * math.log(0.05)])
        v = float(nlml(kern, params, lh, X, y, likelihood=wlik))
        assert np.isfinite(v)

    def test_inverse_handles_zero_z(self):
        # dz floor: all-zero z used to hang the bracketing loop
        theta = jnp.asarray([0.3, -0.2, 0.5])
        z = jnp.zeros(5)
        back = warping.inverse(warping.TANH1, theta, z)
        gy, _ = warping.warp(warping.TANH1, theta, back)
        np.testing.assert_allclose(np.asarray(gy), 0.0, atol=1e-6)

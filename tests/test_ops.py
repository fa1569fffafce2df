"""The streamed Gram product (ops/matvec.py) and the plain flagship Gram
build (ops/gram.py) against NumPy float64 and the generic kernel path.

The Triton kernel runs here in the Pallas interpreter (the same kernel
code the GPU compiles); the compiled kernel itself is checked on the
card by the `gpu`-marked test below and by chip_smoke.py phase 3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gp_ss_ak_tpu.model import default_model
from gp_ss_ak_tpu.ops import matvec
from gp_ss_ak_tpu.ops.gram import expans_bias_gram, mapped_points
from gp_ss_ak_tpu.ops.matvec import (
    MatvecOperator,
    stream_route,
    streamed_matmat,
    triton_matmat,
    xla_matmat,
)

RNG = np.random.default_rng(31)


def _points(n, d, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, (n, d)).astype(np.float32)


def _exp_gram_f64(X):
    X = np.asarray(X, np.float64)
    diff = X[:, None, :] - X[None, :, :]
    return np.exp(-np.sqrt(np.sum(diff * diff, axis=-1)))


# --- Triton kernel (interpret mode) against float64 -------------------------

@pytest.mark.parametrize("n,b,d", [
    (200, 1, 3),     # n not a tile multiple, single vector
    (200, 9, 3),     # y + 8 gradient probes
    (130, 40, 3),    # B past one 16-wide dot block
    (70, 1, 4),      # 4-D input (rock-type column)
    (150, 9, 4),
    (96, 40, 4),
])
def test_triton_matmat_matches_float64(n, b, d):
    X = _points(n, d, seed=n + b)
    V = RNG.standard_normal((n, b)).astype(np.float32)
    out = np.asarray(triton_matmat(X, V, interpret=True))
    ref = _exp_gram_f64(X) @ V.astype(np.float64)
    assert out.shape == (n, b)
    err = np.abs(out - ref).max(0) / np.abs(ref).max(0)
    assert err.max() < 1e-5


@pytest.mark.parametrize("route", ["triton", "xla"])
def test_exact_diagonal(route):
    """E_ii is exactly exp(-0) = 1: a unit vector e_i returns column i
    of E with its i-th entry exactly 1."""
    n, i = 90, 37
    X = _points(n, 3, seed=5)
    V = np.zeros((n, 1), np.float32)
    V[i, 0] = 1.0
    out = (triton_matmat(X, V, interpret=True) if route == "triton"
           else xla_matmat(X, V))
    assert float(out[i, 0]) == 1.0


@pytest.mark.parametrize("route", ["triton", "xla"])
def test_zero_padding_rows_contribute_nothing(route):
    """Points whose V rows are zero add nothing: the padded tail the
    kernel appends, or extra points appended by hand."""
    n = 70
    X = _points(n, 3, seed=7)
    V = RNG.standard_normal((n, 5)).astype(np.float32)
    Xx = np.concatenate([X, _points(30, 3, seed=8)])
    Vx = np.concatenate([V, np.zeros((30, 5), np.float32)])
    fn = ((lambda a, b: triton_matmat(a, b, interpret=True))
          if route == "triton" else xla_matmat)
    np.testing.assert_allclose(np.asarray(fn(Xx, Vx))[:n],
                               np.asarray(fn(X, V)), rtol=1e-6, atol=1e-6)


def test_operator_call_is_matmat_column():
    X = _points(120, 3, seed=9)
    op = MatvecOperator(X, 0.9, 0.2, 0.016)
    v = RNG.standard_normal(120).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(op(v)),
                                  np.asarray(op.matmat(v[:, None])[:, 0]))


def test_streamed_matmat_adds_bias_and_noise():
    n = 110
    X = _points(n, 3, seed=11)
    V = RNG.standard_normal((n, 3))
    A = 0.81 * _exp_gram_f64(X) + 0.2 + 0.016 * np.eye(n)
    out = np.asarray(streamed_matmat(X, 0.81, 0.2, 0.016, V))
    np.testing.assert_allclose(out, A @ V, rtol=1e-5, atol=1e-5)


# --- route choice -------------------------------------------------------------

@pytest.mark.parametrize("b", [1, 9, 64])
def test_route_off_gpu_is_plain_xla(b):
    assert jax.default_backend() != "gpu"
    assert stream_route(b) == "xla"


@pytest.mark.parametrize("b,want", [(1, "triton"), (2, "triton"),
                                    (9, "triton"), (16, "triton"),
                                    (17, "xla"), (64, "xla")])
def test_route_on_gpu_by_width(monkeypatch, b, want):
    monkeypatch.setattr(matvec.jax, "default_backend", lambda: "gpu")
    assert stream_route(b) == want


def test_gpu_route_is_compiled_never_interpreted(monkeypatch):
    """On a GPU the stream product calls the kernel without
    interpret=True (the interpreter is for tests only)."""
    calls = []

    def fake(Xm, V, interpret=False):
        calls.append(interpret)
        return xla_matmat(Xm, V)

    monkeypatch.setattr(matvec.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(matvec, "triton_matmat", fake)
    X = _points(40, 3)
    streamed_matmat(X, 1.0, 0.0, 0.0, np.ones((40, 9), np.float32))
    assert calls == [False]


@pytest.mark.gpu
def test_compiled_kernel_matches_xla_route(gpu):
    X = _points(5000, 3)
    V = RNG.standard_normal((5000, 9)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(triton_matmat(X, V)),
                               np.asarray(xla_matmat(X, V)),
                               rtol=1e-4, atol=1e-3)


# --- plain Gram build ---------------------------------------------------------

def _flagship(n=37, seed=3):
    model = default_model(input_dim=3, dtype=jnp.float64)
    X = jnp.asarray(np.random.default_rng(seed).normal(size=(n, 3)))
    return model, X


def _mapped(model, X):
    ep, bp = model.kernel_params
    return (mapped_points(model.kernel.children[0], ep, X), ep["Sigma"],
            bp["Sigma"])


@pytest.mark.parametrize("with_noise", [False, True])
def test_gram_same_matches_kernel_matrix(with_noise):
    model, X = _flagship()
    Xm, sigma, bias = _mapped(model, X)
    sn2 = 0.016 if with_noise else None
    A = expans_bias_gram(Xm, sigma, bias, sn2)
    K = model.kernel.matrix(model.kernel_params, X, X, same=True)
    if with_noise:
        K = K + 0.016 * jnp.eye(X.shape[0])
    np.testing.assert_allclose(np.asarray(A), np.asarray(K),
                               rtol=1e-10, atol=1e-12)


def test_gram_cross_matches_kernel_matrix():
    model, X = _flagship(n=33)
    Xs = jnp.asarray(RNG.normal(size=(17, 3)))
    ep, bp = model.kernel_params
    expans = model.kernel.children[0]
    c = jnp.mean(X, axis=0)
    M = expans.metric(ep, 3)
    kX = expans_bias_gram((X - c) @ M, ep["Sigma"], bp["Sigma"],
                          Xm2=(Xs - c) @ M)
    ref = model.kernel.matrix(model.kernel_params, X, Xs)
    np.testing.assert_allclose(np.asarray(kX), np.asarray(ref),
                               rtol=1e-10, atol=1e-12)


def test_gram_gradient_matches_kernel_matrix():
    """jax.grad through the mapped-points build equals the generic
    kernel path's gradient (finite: the diagonal never touches
    sqrt(0))."""
    model, X = _flagship(n=24)
    w = jnp.asarray(RNG.normal(size=(24, 24)))
    flat0 = model.kernel.pack(model.kernel_params)

    def via_gram(flat):
        kp = model.kernel.unpack(flat)
        ep, bp = kp
        Xm = mapped_points(model.kernel.children[0], ep, X)
        return jnp.sum(w * expans_bias_gram(Xm, ep["Sigma"], bp["Sigma"],
                                            0.016))

    def via_kernel(flat):
        K = model.kernel.matrix(model.kernel.unpack(flat), X, X, same=True)
        return jnp.sum(w * (K + 0.016 * jnp.eye(24)))

    g1 = np.asarray(jax.grad(via_gram)(flat0))
    g2 = np.asarray(jax.grad(via_kernel)(flat0))
    assert np.all(np.isfinite(g1))
    np.testing.assert_allclose(g1, g2, rtol=1e-8, atol=1e-10)

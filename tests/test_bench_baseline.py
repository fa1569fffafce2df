"""The bench.py CPU baseline must compute the REAL gradient.

VERDICT r1 flagged that the round-1 baseline's 'gradient' was 10 copies
of one QW*K reduction; this pins the honest version: every one of the
10 analytic hyper-gradients (ExpAns angles/widths/sigma + bias + sn2,
Kernel.cpp:1176-1257 structure) matches central finite differences.
"""

import importlib.util
import math
import os

import numpy as np

_spec = importlib.util.spec_from_file_location(
    "bench", os.path.join(os.path.dirname(__file__), "..", "bench.py"))
bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench)

NAMES = ["AngleX", "AngleY", "AngleZ", "iwx", "iwy", "iwz",
         "sigma", "iwr", "bias", "sn2"]


def test_cpu_baseline_gradient_matches_finite_differences():
    rng = np.random.default_rng(1)
    X = rng.uniform(-1, 1, (48, 3))
    y = np.sin(X @ np.array([3.0, 1.0, 2.0]))
    p = dict(AngleX=math.pi / 3.1, AngleY=math.pi / 3.1,
             AngleZ=math.pi / 3.1, iwx=1.5, iwy=1.5, iwz=1.3,
             sigma=0.9, iwr=0.6, bias=0.2, sn2=0.016)
    _, g = bench.cpu_nlml_grad(X, y, p)
    eps = 1e-6
    for i, nm in enumerate(NAMES):
        if nm == "iwr":  # inactive for 3-D inputs
            assert g[i] == 0.0
            continue
        q = dict(p)
        q[nm] += eps
        f1, _ = bench.cpu_nlml_grad(X, y, q)
        q = dict(p)
        q[nm] -= eps
        f0, _ = bench.cpu_nlml_grad(X, y, q)
        fd = (f1 - f0) / (2 * eps)
        assert abs(g[i] - fd) < 1e-5 * max(1.0, abs(fd)), (
            f"{nm}: analytic {g[i]} vs fd {fd}")


def test_cpu_baseline_gradients_are_distinct():
    # the r1 padding failure mode: identical values for every hyper
    rng = np.random.default_rng(2)
    X = rng.uniform(-1, 1, (32, 3))
    y = np.sin(X @ np.array([2.0, -1.0, 1.0]))
    p = dict(AngleX=0.8, AngleY=1.1, AngleZ=0.5, iwx=1.5, iwy=0.9,
             iwz=1.3, sigma=0.9, iwr=0.6, bias=0.2, sn2=0.016)
    _, g = bench.cpu_nlml_grad(X, y, p)
    assert len(np.unique(np.round(g, 10))) >= 8

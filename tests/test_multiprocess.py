"""2-process boot loopback test (SURVEY.md §4.3).

Spawns two fresh Python processes that stitch themselves together with
`parallel.multihost.initialize` (-> jax.distributed.initialize) over a
localhost coordinator, build one global 4-device CPU mesh (2 devices
per process), and evaluate the distributed NLML+grad across the
process boundary. Process 0 checks the value/gradient against the
single-process dense oracle on the same data.

This exercises the exact boot path a multi-host run hits first — the
coordinator handshake, cross-process device enumeration, and
collectives spanning processes — which no in-process simulated-mesh
test can reach. Skips cleanly when the runtime refuses multi-process
CPU (some builds disable the distributed service).
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

pid = int(sys.argv[1])
addr = sys.argv[2]

from gp_ss_ak_tpu.parallel import multihost
multihost.initialize(coordinator_address=addr, num_processes=2,
                     process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 4, jax.devices()

import numpy as np
import jax.numpy as jnp
from gp_ss_ak_tpu.model import default_model
from gp_ss_ak_tpu.parallel import (
    make_dist_nlml_and_grad, make_mesh, shard_training_data)

# identical data on every process (deterministic seed)
rng = np.random.default_rng(7)
n, d = 20, 3
X = rng.normal(size=(n, d))
y = np.sin(X[:, 0])
model = default_model(input_dim=d, dtype=jnp.float64)

mesh = make_mesh(4)
Xs, ys, ntrue, _ = shard_training_data(mesh, X, y, nb=4)
f = make_dist_nlml_and_grad(model.kernel, model.likelihood, mesh,
                            n=ntrue, nb=4)
# out_specs are P()/P(): value and gradient come back fully
# replicated, so every process can read them directly
v, g = f(model.pack(), Xs, ys)
v = float(v)
g = np.asarray(jax.device_get(g))

if pid == 0:
    from gp_ss_ak_tpu.optim import make_value_and_grad
    vg = make_value_and_grad(model, X, y)
    v_d, g_d = vg(np.asarray(model.pack()))
    assert abs(v - v_d) <= 1e-8 * abs(v_d), (v, v_d)
    np.testing.assert_allclose(g, g_d, rtol=1e-6, atol=1e-8)
    print("DIST_OK", v)
else:
    print("DIST_OK_WORKER", v)

# ring route across the process boundary: whitened batched CG +
# distributed SLQ with ppermutes spanning the two processes; the
# parent computed the same deterministic estimator on a 1-process
# 4-device mesh and passed it in argv[3]
from gp_ss_ak_tpu.parallel import make_ring_nlml_and_grad
fr = make_ring_nlml_and_grad(model.kernel, mesh, n=ntrue,
                             precond_rank=8, probes=4, slq_probes=4,
                             lanczos_iters=8, cg_tol=1e-10,
                             cg_maxiter=500)
vr, gr = fr(model.pack(), Xs, ys)
vr = float(vr)
expected = float(sys.argv[3])
assert abs(vr - expected) <= 1e-6 * abs(expected), (vr, expected)
print("RING_OK" if pid == 0 else "RING_OK_WORKER", vr)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _ring_expected():
    """The ring estimator on a 1-process 4-device mesh — deterministic
    (fixed probe seed, same mesh shape), so it must equal the
    2-process value."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gp_ss_ak_tpu.model import default_model
    from gp_ss_ak_tpu.parallel import (
        make_mesh,
        make_ring_nlml_and_grad,
        shard_training_data,
    )

    rng = np.random.default_rng(7)
    n, d = 20, 3
    X = rng.normal(size=(n, d))
    y = np.sin(X[:, 0])
    model = default_model(input_dim=d, dtype=jnp.float64)
    mesh = make_mesh(4)
    Xs, ys, ntrue, _ = shard_training_data(mesh, X, y, nb=4)
    fr = make_ring_nlml_and_grad(model.kernel, mesh, n=ntrue,
                                 precond_rank=8, probes=4,
                                 slq_probes=4, lanczos_iters=8,
                                 cg_tol=1e-10, cg_maxiter=500)
    v, _g = fr(model.pack(), Xs, ys)
    return float(v)


def test_two_process_loopback_dist_nlml(tmp_path):
    port = _free_port()
    addr = f"127.0.0.1:{port}"
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    ring_expected = _ring_expected()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid), addr,
             repr(ring_expected)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            text=True)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("2-process loopback timed out")

    blob = "\n".join(o[1] + o[2] for o in outs)
    if any(rc != 0 for rc, _, _ in outs):
        refusal_markers = (
            "distributed service is not available",
            "Unable to initialize backend",
            "UNIMPLEMENTED",
            "does not support multi-process",
        )
        if any(m.lower() in blob.lower() for m in refusal_markers):
            pytest.skip(f"runtime refuses multi-process CPU: "
                        f"{blob[-400:]}")
        pytest.fail(f"worker failed:\n{blob[-2000:]}")
    assert "DIST_OK" in outs[0][1], outs[0]
    assert "DIST_OK_WORKER" in outs[1][1], outs[1]
    assert "RING_OK" in outs[0][1], outs[0]
    assert "RING_OK_WORKER" in outs[1][1], outs[1]

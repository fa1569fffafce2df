"""Start-up discipline: where the compile cache lives, what the chip
smoke script does without a GPU, and the multichip dry run's refusal
to run on fewer devices than asked."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_defaults_to_fixed_checkout_dir(monkeypatch):
    import jax

    from gp_ss_ak_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_compile_cache_env_var_wins_and_sets_nothing(monkeypatch, tmp_path):
    import jax

    from gp_ss_ak_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def _run_smoke(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=240)


def _ok_line(stdout):
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok") is True:
                return True
        except (ValueError, AttributeError):
            pass
    return False


def test_chip_smoke_refuses_cpu_backend():
    out = _run_smoke(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert out.returncode != 0
    assert not _ok_line(out.stdout)
    assert "no GPU backend" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    script = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), script)
    out = _run_smoke(str(script), str(tmp_path))
    assert out.returncode != 0
    assert not _ok_line(out.stdout)


def test_dryrun_multichip_raises_with_too_few_devices():
    import jax

    sys.path.insert(0, REPO)
    import __graft_entry__

    with pytest.raises(RuntimeError, match="needs"):
        __graft_entry__.dryrun_multichip(len(jax.devices()) + 1)

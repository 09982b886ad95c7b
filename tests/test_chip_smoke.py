"""chip_smoke.py: refuses to run without a GPU, and its phases at tiny
sizes on the CPU (the device check lives only in ``main``)."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

import gfx_ocean_tpu as ot

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_cpu_without_ok_line():
    out = _run(ROOT, "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_fails_alone_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run(str(tmp_path), "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_phase_step_tiny():
    rec = cs.phase_step(32, rollout_steps=8, rollout_batch=4, field_frames=3,
                        repeats=1)
    for impl in ("matmul", "xla"):
        r = rec[impl]
        assert r["rel_linf"] <= cs.STEP_GATE
        assert r["field_rollout_rel_linf"] <= cs.ROLLOUT_GATE
        assert r["steps_per_sec"] > 0 and r["rollout_steps"] == 8


def test_phase_frame_tiny():
    cfg = ot.OceanConfig(resolution=64, mesh_resolution=32)
    rec = cs.phase_frame(96, 64, cfg, trace=False)
    assert rec["dropped"] == 0 and rec["pool_window_diff_px"] <= 64
    assert "device_ms" not in rec


def test_phase_serve_tiny():
    cfg = ot.OceanConfig(resolution=64, mesh_resolution=32)
    rec = cs.phase_serve(cfg, 96, 64, jax.devices()[0].platform, n_png=3)
    assert rec["requests"] >= 8 and rec["giant_dropped_max"] == 0


def test_phase_multi_tiny():
    rec = cs.phase_multi(jax.devices()[:4], 64, 96, 64, rollout_steps=4)
    assert rec["mesh"] == {"batch": 1, "row": 4}
    assert rec["frame"]["differing_px"] == 0


def test_check_raises_on_failure():
    cs.check(True, "fine")
    with pytest.raises(cs.SmokeFailure, match="broken"):
        cs.check(False, "broken")

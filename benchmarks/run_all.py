#!/usr/bin/env python
"""Run every BASELINE.json config and print a JSON report.

bench.py stays the single-line headline benchmark (config 2); this script
is the full matrix used to fill the README/BENCH tables:

  1. 256^2 height-only step (golden accuracy check)        [config 1]
  2. 512^2 full step, 600-frame scan rollout               [config 2]
  3. 1024^2 with runtime Phillips synthesis                [config 3]
  4. 3-cascade 3x512^2 with foam (vmap)                    [config 4]
  5. 4096^2 path + one rendered frame along a camera step  [config 5]
  9. 8192^2 grid ceiling (--ceiling only)

Measurement rules (same as bench.py / BASELINE.md): throughput is the
MEDIAN of repeats over a device-resident scan with a forcing transfer;
every throughput config also reports its accuracy (relative L-inf of one
full step vs the float64 CPU golden) — a rate with broken numerics is
meaningless.

Usage: python benchmarks/run_all.py [--quick]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

# Runnable from a checkout without installation.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def weak_scaling_sweep(env=None):
    """Weak-scaling record: steps/s at 1/2/4/8 row-sharded CPU devices,
    both FFT strategies — a RELATIVE scaling instrument (the virtual CPU
    mesh shares one socket, so absolute rates mean nothing; the shape of
    the curve and the collective-bytes model are what a multi-device user
    can check). Per-step interconnect bytes are analytic from the code:
    each explicit all_to_all moves (D-1)/D of its operand across devices;
    per 2-D transform the shard_map matmul body reshards (re, im) forward
    and the result back (parallel/distributed_fft.py:55-76 — 3 planes for
    a real-out transform, 4 for complex-out), so a packed step (height
    real-out + Z complex) wires 7 * N^2 * 4 * (D-1)/D bytes. GSPMD's
    collective choice is
    compiler-internal (all_gather or all_to_all per pass) — reported as
    None."""
    import os
    import subprocess
    import sys

    if env is None:
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=8")

    def a2a_gb(n, d):
        # hermitian_pack auto-on at N >= 1024: 2 transforms (3 + 4 wired
        # planes); below, 3 real-out transforms (3 planes each).
        planes = 7 if n >= 1024 else 9
        return round(planes * n * n * 4 * (d - 1) / d / 1e9, 4)

    scaling = {}
    for n in (512, 1024):
        for strat, extra in (("gspmd", []),
                             ("shard_map", ["--sharded-fft", "shard_map"])):
            curve = {}
            for d in (1, 2, 4, 8):
                try:
                    out = subprocess.run(
                        [sys.executable, "-m", "gfx_ocean_tpu", "bench",
                         "--resolution", str(n), "--steps", "8",
                         "--repeats", "1", "--time-batch", "1",
                         "--mesh", f"1,{d}",
                         *(["--phillips"] if n > 512 else []), *extra],
                        capture_output=True, text=True, timeout=900, env=env,
                        cwd=os.path.dirname(os.path.dirname(
                            os.path.abspath(__file__))), check=True)
                    rec = json.loads(out.stdout)
                    curve[f"d{d}"] = {
                        "steps_per_sec": round(rec["steps_per_sec"], 2),
                        "a2a_gb_per_step": (a2a_gb(n, d)
                                            if strat == "shard_map" else None),
                    }
                except Exception as e:  # noqa: BLE001
                    curve[f"d{d}"] = {"ok": False, "error": str(e)[:160]}
            scaling[f"{n}_{strat}"] = curve
    return scaling


def _throughput(rollout, state, ts, repeats=3):
    from gfx_ocean_tpu.utils.profiling import time_rollout

    return time_rollout(rollout, state, ts, repeats)["steps_per_sec"]


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true",
                        help="shorter rollouts (CI smoke)")
    parser.add_argument("--ceiling", action="store_true",
                        help="also measure the 8192^2 grid ceiling (config 9)")
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp

    import gfx_ocean_tpu as ot
    from gfx_ocean_tpu.utils.compile_cache import enable_default_cache

    enable_default_cache()
    from gfx_ocean_tpu.config import PhillipsConfig
    from gfx_ocean_tpu.golden.reference import golden_fields
    from gfx_ocean_tpu.models.ocean import (
        downsample_state, ocean_state_from_phillips)
    from gfx_ocean_tpu.utils.complexpair import from_pair_np

    def accuracy(cfg, state, t=11.25, field=None):
        """Relative L-inf of one step vs the float64 golden (height field
        when ``field=1``; all three displacement channels otherwise)."""
        import dataclasses

        cfg1 = dataclasses.replace(cfg, compute_normals=False,
                                   compute_foam=False)
        disp = np.asarray(ot.make_step(cfg1)(state, jnp.float32(t)).displacement)
        want = golden_fields(from_pair_np(np.asarray(state.h0)),
                             np.asarray(state.omega), t, cfg.domain_size,
                             cfg.compat)
        if field is not None:
            disp, want = disp[..., field], want[..., field]
        return float(np.abs(disp - want).max() / np.abs(want).max())

    report = {"device": str(jax.devices()[0]),
              "rules": "median of repeats; forcing transfer; accuracy = one "
                       "step rel L-inf vs float64 golden"}
    configs = report["configs"] = {}
    steps = 100 if args.quick else 600
    dt = jnp.float32(1.0 / 60.0)

    # config 1: 256^2 height-only, accuracy vs golden (the seeded sea)
    st512 = ocean_state_from_phillips(ot.OceanConfig(), PhillipsConfig(seed=0))
    st256 = downsample_state(st512, 256)
    cfg1 = ot.OceanConfig(resolution=256, compute_normals=False)
    disp = np.asarray(ot.make_step(cfg1)(st256, jnp.float32(11.25)).displacement)
    want = golden_fields(from_pair_np(np.asarray(st256.h0)), np.asarray(st256.omega),
                         11.25, cfg1.domain_size, cfg1.compat)
    configs["1_256_height_only"] = {
        "rel_linf_vs_golden": float(np.abs(disp - want).max() / np.abs(want).max()),
        "abs_linf_vs_golden": float(np.abs(disp - want).max()),
    }

    # config 2: 512^2 full step rollout (the headline; matches bench.py)
    cfg2 = ot.OceanConfig()
    ts = jnp.arange(steps, dtype=jnp.float32) * dt
    sps = _throughput(ot.make_rollout(cfg2, keep_fields=False, time_batch=4),
                      st512, ts)
    configs["2_512_full_step"] = {
        "steps_per_sec": round(sps, 1),
        "rel_linf_vs_golden": accuracy(cfg2, st512),
    }

    # config 3: 1024^2 Phillips synthesis (hermitian_pack auto-on at this N)
    cfg3 = ot.OceanConfig(resolution=1024, domain_size=1000.0)
    st1024 = ocean_state_from_phillips(cfg3, PhillipsConfig())
    ts3 = jnp.arange(min(steps, 200), dtype=jnp.float32) * dt
    sps = _throughput(ot.make_rollout(cfg3, keep_fields=False, time_batch=2),
                      st1024, ts3)
    configs["3_1024_phillips"] = {
        "steps_per_sec": round(sps, 1),
        "rel_linf_vs_golden": accuracy(cfg3, st1024),
        "hermitian_pack": cfg3.hermitian_pack,
    }

    # config 4: 3-cascade 512^2 with foam
    cfg4 = ot.OceanConfig(resolution=512, num_cascades=3, compute_foam=True)
    st_casc = ocean_state_from_phillips(cfg4, PhillipsConfig())
    ts4 = jnp.arange(min(steps, 200), dtype=jnp.float32) * dt
    sps = _throughput(ot.make_rollout(cfg4, keep_fields=False), st_casc, ts4)
    # accuracy: cascade 0 (its domain == cfg.domain_size) vs golden
    import dataclasses

    from gfx_ocean_tpu.models.ocean import OceanState

    casc0 = OceanState(h0=st_casc.h0[0], omega=st_casc.omega[0])
    cfg4a = dataclasses.replace(cfg4, num_cascades=1, compute_foam=False)
    configs["4_3cascade_512_foam"] = {
        "steps_per_sec": round(sps, 1),
        "rel_linf_vs_golden_cascade0": accuracy(cfg4a, casc0),
    }

    # config 5: 4096^2 + a rendered frame, uniform precision, Hermitian
    # field packing (auto at this N).
    cfg5 = ot.OceanConfig(resolution=4096, domain_size=2000.0,
                          matmul_precision="high")
    st4096 = ocean_state_from_phillips(cfg5, PhillipsConfig())
    ts5 = jnp.arange(30 if args.quick else 60, dtype=jnp.float32) * dt
    sps = _throughput(ot.make_rollout(cfg5, keep_fields=False), st4096, ts5,
                      repeats=2)
    entry = {"steps_per_sec": round(sps, 1),
             "hermitian_pack": cfg5.hermitian_pack,
             "uniform_precision": cfg5.choppy_precision is None}
    if not args.quick:
        entry["rel_linf_vs_golden_height"] = accuracy(cfg5, st4096, field=1)
    try:
        from gfx_ocean_tpu.render import Camera, render_frame

        fields = ot.make_step(ot.OceanConfig(resolution=4096, domain_size=2000.0,
                                             compute_normals=False))(
            st4096, jnp.float32(3.0))
        np.asarray(render_frame(fields.displacement, Camera(),
                                width=300, height=175))  # jit warmup
        t0 = time.perf_counter()
        img = np.asarray(render_frame(fields.displacement, Camera(),
                                      width=300, height=175))
        entry["render_frame_sec"] = round(time.perf_counter() - t0, 3)
        entry["render_finite"] = bool(np.all(np.isfinite(img)))
    except Exception as e:  # render is best-effort in this report
        entry["render_error"] = str(e)[:200]
    configs["5_4096_interactive"] = entry

    # config 8: interactive rendering at a 480x280 viewport (
    # 128^2 mesh, 4 patches): the pool rasterizer (f32 API path) and the
    # fused step->render->sRGB serving pipeline (one dispatch; what the
    # browser viewer runs). Coverage parity with the window golden is
    # enforced by tests/test_render.py.
    from gfx_ocean_tpu.render import Camera as _Cam, render_frame as _rf
    from gfx_ocean_tpu.render.camera import perspective as _persp
    from gfx_ocean_tpu.render.raster import make_frame_renderer as _mfr

    disp512 = ot.make_step(ot.OceanConfig(compute_normals=False))(
        st512, jnp.float32(11.25)).displacement
    render = {}

    def _median_ms(fn, n=7):
        fn()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return round(float(np.median(times)) * 1e3, 1)

    def _pipelined_ms(fn, depth=20, n=3):
        """Pipelined frame time: dispatch ``depth`` frames async, force
        completion with one transfer, divide. The serialized
        ``_median_ms`` rows additionally pay a dispatch + transfer per
        call (the serving-latency view)."""
        out = fn()
        np.asarray(out).reshape(-1)[:1]
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            for _ in range(depth):
                out = fn()
            jax.block_until_ready(out)
            np.asarray(out).reshape(-1)[:1]
            times.append((time.perf_counter() - t0) / depth)
        return round(float(np.median(times)) * 1e3, 1)

    render["pool_f32_ms"] = _median_ms(lambda: np.asarray(_rf(
        disp512, _Cam(), width=480, height=280, mesh_resolution=128)))
    fr = _mfr(ot.OceanConfig(), width=480, height=280)
    vp = jnp.asarray((_persp(480 / 280) @ _Cam().view()).astype(np.float32))
    cp = jnp.asarray(_Cam().position.astype(np.float32))
    render["fused_step_render_srgb8_ms"] = _median_ms(
        lambda: np.asarray(fr(st512, jnp.float32(11.25), vp, cp)))
    render["viewport"] = "480x280, 128^2 mesh, 4 patches"
    # Viewport scaling of the fused path, BOTH timings per size: serialized
    # wall and pipelined (the reference's own window is 1200x700).
    render["fused_480x280_pipelined_ms"] = _pipelined_ms(
        lambda: fr(st512, jnp.float32(11.25), vp, cp))
    for w2, h2 in ((960, 540), (1200, 700)):
        fr2 = _mfr(ot.OceanConfig(), width=w2, height=h2)
        vp2 = jnp.asarray((_persp(w2 / h2) @ _Cam().view()).astype(np.float32))
        render[f"fused_{w2}x{h2}_ms"] = _median_ms(
            lambda f=fr2, v=vp2: np.asarray(f(st512, jnp.float32(11.25),
                                              v, cp)))
        render[f"fused_{w2}x{h2}_pipelined_ms"] = _pipelined_ms(
            lambda f=fr2, v=vp2: f(st512, jnp.float32(11.25), v, cp))
    configs["8_render_interactive"] = render

    # config 7: sharded rollout (multi-device surface): a CORRECTNESS
    # record on the 8-device virtual CPU mesh (the gfx-backend-empty
    # analog), not a throughput claim: it proves the --mesh product path
    # runs the full rollout end-to-end under both FFT strategies.
    import subprocess

    sharded = {}
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    for label, mesh_args in (
            ("2x4_gspmd", ["--mesh", "2,4"]),
            ("1x8_shard_map", ["--mesh", "1,8", "--sharded-fft",
                               "shard_map", "--no-pack"])):
        try:
            out = subprocess.run(
                [sys.executable, "-m", "gfx_ocean_tpu", "bench",
                 "--resolution", "256", "--steps", "8", "--repeats", "1",
                 "--time-batch", "1", *mesh_args],
                capture_output=True, text=True, timeout=600, env=env,
                cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                check=True)
            rec = json.loads(out.stdout)
            sharded[label] = {"ok": True, "mesh": rec["mesh"],
                              "cpu_mesh_steps_per_sec": round(rec["steps_per_sec"], 1)}
        except Exception as e:  # noqa: BLE001
            sharded[label] = {"ok": False, "error": str(e)[:200]}
    sharded["note"] = ("virtual 8-device CPU mesh; correctness record, "
                       "rates are not device rates")

    sharded["weak_scaling"] = weak_scaling_sweep(env)
    configs["7_sharded_rollout"] = sharded

    # config 9 (--ceiling): the 8192^2 grid ceiling. Off by default:
    # synthesis + one-step compile + the float64 golden take minutes.
    if args.ceiling:
        cfg9 = ot.OceanConfig(resolution=8192, domain_size=2000.0,
                              matmul_precision="high")
        st8192 = ocean_state_from_phillips(cfg9, PhillipsConfig())
        ts9 = jnp.arange(16, dtype=jnp.float32) * dt
        sps = _throughput(ot.make_rollout(cfg9, keep_fields=False), st8192,
                          ts9, repeats=2)
        configs["9_8192_ceiling"] = {
            "steps_per_sec": round(sps, 1),
            "rel_linf_vs_golden_height": accuracy(cfg9, st8192, field=1),
        }

    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()

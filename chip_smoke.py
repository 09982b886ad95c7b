#!/usr/bin/env python
"""Smoke test of the main path on one GPU (``--multi``: the mesh on four).

Runs the normal entry points at the reference's full size, phase by phase,
and prints one line per phase with its numbers, tolerances and wall ms:

  step512   ``make_step`` on the seeded 512^2 sea vs the float64 golden
            (``golden/reference.py``) for fft_impl "matmul" and "xla";
            a 600-step checksum rollout per impl (finite, steps/s); a
            4-frame field rollout vs ``make_step`` at the same t.
  step4096  one 4096^2 step per impl vs the float64 golden, and a short
            checksum rollout per impl (steps/s).
  frame     the fused 1200x700 renderer (``make_frame_renderer``, diag):
            no dropped giants, device ms from a profiler trace; the pool
            rasterizer vs the window rasterizer within the near-tie
            bounds of ``tests/test_render.py::test_pool_window_near_tie_bound``.
  serve     ``serve()`` on a thread answering >= 8 requests: /health names
            the device, /frame equals ``make_step`` bit for bit, /frame.png
            decodes to 700x1200x3, /metrics shows no dropped giants.

``--multi`` runs only the four-device mesh path: the row-sharded 4096^2
step (gspmd and shard_map) and rollout against the single-device ones,
and the band-parallel 1200x700 frame bit-equal to the single-device frame.

Before the phases it prints the card's name and power limit as nvidia-smi
reports them; the last line is one JSON object naming the device JAX
reports. JAX must find a GPU: on any other platform, and on any failure,
the script exits non-zero without that line.

    python chip_smoke.py            # one GPU
    python chip_smoke.py --multi    # four GPUs of one host
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import statistics
import struct
import subprocess
import sys
import threading
import time
import urllib.request
import zlib

import jax.numpy as jnp
import numpy as np

import gfx_ocean_tpu as ot
from gfx_ocean_tpu.golden.reference import golden_fields
from gfx_ocean_tpu.utils.complexpair import from_pair_np

T_CHECK = 11.25
STEP_GATE = 1e-4       # relative L-inf vs the float64 golden (bench.py)
ROLLOUT_GATE = 1e-5    # field rollout vs make_step at the same t
MULTI_GATE = 1e-4      # sharded vs single-device step (graft dry run)


class SmokeFailure(RuntimeError):
    """A phase's result is outside its bound."""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def seeded_state(cfg: ot.OceanConfig) -> ot.OceanState:
    """The seeded Phillips sea ``tests/conftest.py`` builds."""
    return ot.ocean_state_from_phillips(cfg, ot.PhillipsConfig(seed=0))


def linf(got: np.ndarray, want: np.ndarray) -> tuple[float, float]:
    """(relative, absolute) L-inf of ``got`` against ``want``."""
    err = float(np.abs(got.astype(np.float64) - want).max())
    return err / float(np.abs(want).max()), err


def _ms(t0: float) -> float:
    return (time.perf_counter() - t0) * 1e3


def phase_step(resolution: int, rollout_steps: int, rollout_batch: int,
               field_frames: int, repeats: int = 3,
               impls=("matmul", "xla")) -> dict:
    """One step per impl vs the float64 golden, a checksum rollout per
    impl, and (``field_frames`` > 0) a field rollout vs ``make_step``."""
    from gfx_ocean_tpu.utils.profiling import time_rollout

    base = ot.OceanConfig(resolution=resolution)
    state = seeded_state(base)
    want = golden_fields(from_pair_np(np.asarray(state.h0)),
                         np.asarray(state.omega), T_CHECK, base.domain_size,
                         base.compat)
    rec = {"resolution": resolution, "hermitian_pack": base.hermitian_pack,
           "gate_rel_linf": STEP_GATE}
    ts = jnp.arange(rollout_steps, dtype=jnp.float32) / np.float32(60.0)
    for impl in impls:
        cfg = dataclasses.replace(base, fft_impl=impl)
        step = ot.make_step(cfg)
        t0 = time.perf_counter()
        disp = np.asarray(step(state, np.float32(T_CHECK)).displacement)
        r = {"first_step_ms": _ms(t0)}
        r["rel_linf"], r["abs_linf"] = linf(disp, want)
        r["height_rel_linf"], r["height_abs_linf"] = linf(disp[..., 1],
                                                          want[..., 1])
        check(np.isfinite(disp).all() and r["rel_linf"] <= STEP_GATE
              and r["height_rel_linf"] <= STEP_GATE,
              f"{impl} {resolution}^2 step vs golden: {r}")
        rollout = ot.make_rollout(cfg, keep_fields=False,
                                  time_batch=rollout_batch)
        cks = np.asarray(rollout(state, ts))
        check(cks.shape == (rollout_steps,) and np.isfinite(cks).all(),
              f"{impl} {rollout_steps}-step rollout checksums not finite")
        timed = time_rollout(rollout, state, ts, repeats=repeats)
        r["rollout_steps"] = rollout_steps
        r["time_batch"] = rollout_batch
        r["steps_per_sec"] = timed["steps_per_sec"]
        r["rollout_repeats_sec"] = timed["repeats_sec"]
        if field_frames:
            tf = (np.float32(T_CHECK)
                  + jnp.arange(field_frames, dtype=jnp.float32) * np.float32(0.5))
            traj = np.asarray(ot.make_rollout(cfg, keep_fields=True)(
                state, tf).displacement)
            worst = max(linf(traj[i], np.asarray(
                step(state, tf[i]).displacement))[0]
                for i in range(field_frames))
            r["field_rollout_rel_linf"] = worst
            check(worst <= ROLLOUT_GATE,
                  f"{impl} field rollout vs make_step: {worst:.3e} > "
                  f"{ROLLOUT_GATE}")
        rec[impl] = r
    return rec


def _camera(width: int, height: int):
    from gfx_ocean_tpu.render.camera import Camera, perspective

    cam = Camera()
    vp = jnp.asarray((perspective(width / height) @ cam.view()).astype(np.float32))
    return cam, vp, jnp.asarray(cam.position.astype(np.float32))


def phase_frame(width: int, height: int, config: ot.OceanConfig,
                trace: bool, window_samples: int = 32,
                giants: int = 2048) -> dict:
    """The fused frame (diag) at the default camera, and the pool vs the
    window rasterizer on the same displacement."""
    from gfx_ocean_tpu.render import raster as rr
    from gfx_ocean_tpu.utils.profiling import traced_device_ms

    state = seeded_state(config)
    cam, vp, cp = _camera(width, height)
    t = jnp.float32(T_CHECK)
    fr = rr.make_frame_renderer(config, width, height, diag=True)
    t0 = time.perf_counter()
    frame, dropped = fr(state, t, vp, cp)
    frame, dropped = np.asarray(frame), int(dropped)
    rec = {"viewport": f"{width}x{height}", "first_frame_ms": _ms(t0),
           "dropped": dropped}
    check(frame.shape == (height, width, 3) and frame.dtype == np.uint8,
          f"fused frame {frame.shape} {frame.dtype}")
    check(dropped == 0, f"fused frame dropped {dropped} giant candidates")
    depth = 20
    t0 = time.perf_counter()
    for _ in range(depth):
        out = fr(state, t, vp, cp)
    np.asarray(out[0])
    rec["pipelined_wall_ms"] = _ms(t0) / depth
    if trace:
        rec["device_ms"] = traced_device_ms(fr, (state, t, vp, cp), frames=10)

    disp = ot.make_step(dataclasses.replace(config, compute_normals=False))(
        state, t).displacement
    common = dict(width=width, height=height, giants=giants,
                  mesh_resolution=config.mesh_resolution,
                  num_patches=config.num_patches, return_depth=True)
    t0 = time.perf_counter()
    a, za = rr.render_frame(disp, cam, impl="pool", **common)
    a, za = np.asarray(a), np.asarray(za)
    rec["pool_first_ms"] = _ms(t0)
    t0 = time.perf_counter()
    b, zb = rr.render_frame(disp, cam, impl="window", samples=window_samples,
                            **common)
    b, zb = np.asarray(b), np.asarray(zb)
    rec["window_first_ms"] = _ms(t0)
    diff = np.argwhere((a != b).any(-1))
    one_sided = int(sum(np.isinf(za[y, x]) != np.isinf(zb[y, x])
                        for y, x in diff))
    t_count = 2 * (config.mesh_resolution - 1) ** 2 * config.num_patches
    quantum = 2.0 / (1 << (32 - rr._id_bits(t_count)))
    both = [(y, x) for y, x in diff if np.isfinite(za[y, x])
            and np.isfinite(zb[y, x])]
    worst_dz = max((abs(float(za[y, x] - zb[y, x])) for y, x in both),
                   default=0.0)
    rec.update(pool_window_diff_px=len(diff), pool_window_one_sided=one_sided,
               pool_window_worst_dz_quanta=worst_dz / quantum,
               bounds={"diff_px": 64, "one_sided": 8, "dz_quanta": 2})
    check(len(diff) <= 64 and one_sided <= 8 and worst_dz <= 2 * quantum,
          f"pool vs window outside the near-tie bounds: {rec}")
    srgb = (np.clip(a, 0.0, 1.0) ** (1 / 2.2) * 255).astype(np.uint8)
    off = float((np.abs(frame.astype(np.int32) - srgb) > 1).mean())
    rec["fused_vs_pool_frac_off_by_gt1"] = off
    check(off < 1e-3, f"fused frame vs pool render: {off:.2e} of pixels "
                      "off by more than 1")
    return rec


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit RGB, filter-0 rows — what ``serve.encode_png``
    writes) -> (H, W, 3) uint8, checking every chunk's CRC."""
    check(data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG")
    pos, idat, shape = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        check(zlib.crc32(tag + body) & 0xFFFFFFFF == crc, f"bad {tag} CRC")
        if tag == b"IHDR":
            w, h, bits, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
            check((bits, ctype, interlace) == (8, 2, 0), "not 8-bit RGB")
            shape = (h, w)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    h, w = shape
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    check(not raw[:, 0].any(), "filtered PNG rows")
    return raw[:, 1:].reshape(h, w, 3)


def phase_serve(config: ot.OceanConfig, width: int, height: int,
                platform: str, n_png: int = 4) -> dict:
    """``serve()`` on a thread; >= 8 requests through HTTP."""
    from gfx_ocean_tpu.serve import serve

    state = seeded_state(config)
    t0 = time.perf_counter()
    srv = serve(state, config, host="127.0.0.1", port=0)
    rec = {"startup_ms": _ms(t0)}
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    lat = []

    def get(path: str) -> tuple[bytes, str]:
        t1 = time.perf_counter()
        with urllib.request.urlopen(base + path, timeout=600) as r:
            body, ctype = r.read(), r.headers.get("Content-Type")
            check(r.status == 200, f"{path}: HTTP {r.status}")
        lat.append((path, _ms(t1)))
        return body, ctype

    try:
        health = json.loads(get("/health")[0])
        check(health["platform"] == platform,
              f"/health reports {health}, JAX has {platform}")
        rec["health_device"] = health["device"]
        check(json.loads(get("/config")[0])["resolution"] == config.resolution,
              "/config resolution")
        step = ot.make_step(config)
        for t in (1.5, 7.25):
            body, _ = get(f"/frame?t={t}")
            with np.load(io.BytesIO(body)) as z:
                served = z["displacement"]
            want = np.asarray(step(state, jnp.float32(t)).displacement)
            check(np.array_equal(served, want),
                  f"/frame?t={t} differs from make_step")
        for i in range(n_png):
            body, ctype = get(f"/frame.png?t={0.5 * i}&w={width}&h={height}")
            img = decode_png(body)
            check(ctype == "image/png" and img.shape == (height, width, 3),
                  f"/frame.png: {ctype} {img.shape}")
        metrics = json.loads(get("/metrics")[0])
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    check(metrics["giant_dropped_max"] == 0 and metrics["errors"] == 0,
          f"/metrics: {metrics}")
    ms = [m for _, m in lat]
    png = [m for p, m in lat if p.startswith("/frame.png")]
    rec.update(requests=len(lat), latency_median_ms=statistics.median(ms),
               latency_max_ms=max(ms), png_first_ms=png[0],
               png_rest_median_ms=statistics.median(png[1:]) if len(png) > 1
               else None,
               giant_dropped_max=metrics["giant_dropped_max"])
    check(len(lat) >= 8, f"only {len(lat)} requests")
    return rec


def phase_multi(devices, resolution: int, width: int, height: int,
                rollout_steps: int) -> dict:
    """Sharded step, rollout and band-parallel frame on a (1, D) mesh
    against the single-device ones."""
    from gfx_ocean_tpu.parallel import (make_mesh, make_sharded_rollout,
                                        make_sharded_step, shard_state)
    from gfx_ocean_tpu.parallel.render import make_sharded_frame_renderer
    from gfx_ocean_tpu.render.raster import make_frame_renderer

    mesh = make_mesh(devices, batch=1, row=len(devices))
    rec = {"mesh": dict(zip(mesh.axis_names, mesh.devices.shape)),
           "resolution": resolution, "gate_rel_linf": MULTI_GATE}
    cfg = ot.OceanConfig(resolution=resolution)
    state = seeded_state(cfg)
    t = jnp.float32(T_CHECK)
    single = np.asarray(ot.make_step(cfg)(state, t).displacement)
    sstate = shard_state(state, mesh)
    for fft in ("gspmd", "shard_map"):
        t0 = time.perf_counter()
        got = np.asarray(make_sharded_step(cfg, mesh, batched=False,
                                           fft=fft)(sstate, t).displacement)
        rel, err = linf(got, single)
        rec[f"step_{fft}"] = {"rel_linf": rel, "abs_linf": err,
                              "first_ms": _ms(t0)}
        check(rel <= MULTI_GATE, f"sharded step ({fft}) vs single: {rel:.3e}")
    ts = jnp.arange(rollout_steps, dtype=jnp.float32) / np.float32(60.0)
    one = np.asarray(ot.make_rollout(cfg, keep_fields=False)(state, ts))
    many = np.asarray(make_sharded_rollout(cfg, mesh, batched=False)(sstate, ts))
    rel = float(np.abs(many - one).max() / np.abs(one).max())
    rec["rollout"] = {"steps": rollout_steps, "rel_linf": rel}
    check(np.isfinite(many).all() and rel <= MULTI_GATE,
          f"sharded rollout checksums vs single: {rel:.3e}")

    fcfg = ot.OceanConfig()
    fstate = seeded_state(fcfg)
    _, vp, cp = _camera(width, height)
    want = np.asarray(make_frame_renderer(fcfg, width, height)(fstate, t, vp, cp))
    t0 = time.perf_counter()
    frame, dropped = make_sharded_frame_renderer(
        fcfg, mesh, width, height, axis="row", diag=True)(fstate, t, vp, cp)
    frame, dropped = np.asarray(frame), np.asarray(dropped)
    rec["frame"] = {"viewport": f"{width}x{height}", "bands": len(devices),
                    "dropped_per_band": dropped.tolist(),
                    "differing_px": int((frame != want).any(-1).sum()),
                    "first_ms": _ms(t0)}
    check(not dropped.any(), f"band renderer dropped giants: {dropped}")
    check(np.array_equal(frame, want),
          f"band-parallel frame differs from single-device: {rec['frame']}")
    return rec


def card_lines() -> list[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-device mesh path")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devices[0].platform!r}); nothing measured", file=sys.stderr)
        return 2
    need = 4 if args.multi else 1
    if len(devices) < need:
        print(f"chip_smoke: need {need} GPUs, JAX found {len(devices)}",
              file=sys.stderr)
        return 2
    for line in card_lines():
        print(line, flush=True)

    from gfx_ocean_tpu.utils.compile_cache import enable_default_cache

    enable_default_cache()
    if args.multi:
        phases = [("multi", lambda: phase_multi(devices[:4], 4096, 1200, 700,
                                                rollout_steps=8))]
    else:
        cfg = ot.OceanConfig()
        phases = [
            ("step512", lambda: phase_step(512, 600, 4, field_frames=4)),
            ("step4096", lambda: phase_step(4096, 60, 1, field_frames=0)),
            ("frame", lambda: phase_frame(1200, 700, cfg, trace=True)),
            ("serve", lambda: phase_serve(cfg, 1200, 700, "gpu")),
        ]
    for name, fn in phases:
        t0 = time.perf_counter()
        rec = fn()
        rec["wall_ms"] = _ms(t0)
        print(f"{name}: {json.dumps(rec)}", flush=True)
    dev = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

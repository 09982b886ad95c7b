"""Profiling and timing.

The reference's only instrumentation is an EMA of CPU frame time in the
window title (``src/lib.rs:146-148``), vsync-capped. Here:

- ``trace()``: context manager around ``jax.profiler`` — device traces
  viewable in TensorBoard / Perfetto, the real per-kernel cost breakdown.
- ``time_rollout()``: device-side throughput (BASELINE.md rules): jit
  warmup excluded, completion forced by a host transfer of the per-step
  checksums.
- ``traced_device_ms()``: device busy time per call, from a profiler
  trace of the GPU.
- ``Ema``: the reference's title-bar smoothing, for parity in the CLI
  (avg = avg*0.9 + dt*0.1).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, List

import numpy as np

# Perfetto process-name prefix of a GPU device plane in a jax.profiler trace.
GPU_PROCESS_PREFIX = "/device:GPU:"


@contextlib.contextmanager
def trace(log_dir: str):
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_rollout(rollout: Callable, state, ts, repeats: int = 3) -> dict:
    """Median steps/sec of a checksum-mode rollout (see make_rollout)."""
    np.asarray(rollout(state, ts))  # warmup: compile + force completion
    times: List[float] = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        np.asarray(rollout(state, ts))
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    steps = int(np.shape(ts)[0])
    return {
        "steps": steps,
        "repeats_sec": [round(t, 5) for t in times],
        "median_sec": dt,
        "steps_per_sec": steps / dt,
        "ms_per_step": dt / steps * 1e3,
    }


def device_busy_us(trace_events: list) -> float:
    """Device busy time (us) in a Perfetto trace's ``traceEvents``.

    Busy is the UNION of the complete ("X") events of every process whose
    name starts with ``GPU_PROCESS_PREFIX``: nested or duplicated timelines
    (module, op and kernel rows of one device) and concurrent streams
    count once. Raises ``RuntimeError`` when the trace holds no GPU event —
    an accelerator run without device events is a broken measurement,
    not a zero.
    """
    gpu_pids = {e["pid"] for e in trace_events
                if e.get("ph") == "M" and e.get("name") == "process_name"
                and str(e.get("args", {}).get("name", "")).startswith(
                    GPU_PROCESS_PREFIX)}
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in trace_events
                   if e.get("ph") == "X" and e.get("pid") in gpu_pids
                   and "dur" in e)
    if not spans:
        raise RuntimeError(
            f"profiler trace holds no GPU device events ({len(gpu_pids)} "
            f"process(es) named {GPU_PROCESS_PREFIX}*)")
    busy = 0.0
    start, end = spans[0]
    for s, e in spans[1:]:
        if s > end:
            busy += end - start
            start, end = s, e
        else:
            end = max(end, e)
    return busy + (end - start)


def traced_device_ms(fn: Callable, args: tuple, frames: int = 10) -> float:
    """Per-call device busy time (ms) of ``fn(*args)`` from a profiler
    trace of ``frames`` back-to-back dispatches (see ``device_busy_us``)."""
    import glob
    import gzip
    import json
    import os
    import tempfile

    import jax

    out = fn(*args)
    np.asarray(jax.tree.leaves(out)[0].ravel()[0:1])  # warm + force
    with tempfile.TemporaryDirectory() as log_dir:
        jax.profiler.start_trace(log_dir, create_perfetto_trace=True)
        try:
            for _ in range(frames):
                out = fn(*args)
            jax.block_until_ready(out)
        finally:
            jax.profiler.stop_trace()
        paths = glob.glob(os.path.join(log_dir, "**", "perfetto_trace.json.gz"),
                          recursive=True)
        if not paths:
            raise RuntimeError(f"profiler wrote no trace under {log_dir}")
        with gzip.open(sorted(paths)[-1]) as f:
            events = json.load(f)["traceEvents"]
    return device_busy_us(events) / 1e3 / frames


def frame_record(width: int = 1200, height: int = 700) -> dict:
    """The fused step->render->sRGB frame at the reference's 1200x700
    window (``src/lib.rs:48``) on the seeded 512^2 sea: pipelined wall
    ms per frame and trace-derived device ms per frame."""
    import jax
    import jax.numpy as jnp

    import gfx_ocean_tpu as ot
    from gfx_ocean_tpu.render.camera import Camera, perspective
    from gfx_ocean_tpu.render.raster import make_frame_renderer

    cfg = ot.OceanConfig()
    state = ot.ocean_state_from_phillips(cfg, ot.PhillipsConfig(seed=0))
    fr = make_frame_renderer(cfg, width=width, height=height)
    vp = jnp.asarray((perspective(width / height)
                      @ Camera().view()).astype(np.float32))
    cp = jnp.asarray(Camera().position.astype(np.float32))
    args = (state, jnp.float32(11.25), vp, cp)
    np.asarray(fr(*args)).reshape(-1)[:1]  # warm + force
    depth = 25
    t0 = time.perf_counter()
    for _ in range(depth):
        out = fr(*args)
    jax.block_until_ready(out)
    wall_ms = (time.perf_counter() - t0) / depth * 1e3
    return {
        "viewport": f"{width}x{height}",
        "pipelined_wall_ms": wall_ms,
        "device_ms": traced_device_ms(fr, args, frames=10),
        "vsync_budget_ms": 16.7,
    }


class Ema:
    """Title-bar EMA of the reference (``src/lib.rs:146-148``)."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.value = 0.0

    def update(self, dt: float) -> float:
        self.value = self.value * (1.0 - self.alpha) + dt * self.alpha
        return self.value

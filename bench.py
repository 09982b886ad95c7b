#!/usr/bin/env python
"""Headline benchmark: 512^2 full ocean steps/sec on one GPU.

Workload (BASELINE.json config 2): full step — propagate, 3x 2-D
unnormalized inverse FFT, correction (choppy displacement), normal map —
over a 600-frame ``lax.scan`` rollout on the seeded Phillips sea
(``ocean_state_from_phillips(OceanConfig(), PhillipsConfig(seed=0))``).

Measurement rules (BASELINE.md): device-resident scan with per-frame
full-field reductions (every output is computed and consumed on device),
jit warmup excluded, completion forced by a host transfer each repeat,
median of repeats. An accuracy gate (relative L-inf vs the float64 CPU
golden) runs first; a throughput number with broken numerics is
meaningless. The fused 1200x700 frame record runs in the same process.
Any failure fails the run; a host without a GPU fails before measuring.

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "detail": {...}}
"""

from __future__ import annotations

import json

import numpy as np


STEPS = 600
REPEATS = 5
TIME_BATCH = 4
ACCURACY_GATE = 1e-4   # relative L-inf of the displacement vs the golden


def main() -> None:
    import jax
    import jax.numpy as jnp

    import gfx_ocean_tpu as ot
    from gfx_ocean_tpu.golden.reference import golden_fields
    from gfx_ocean_tpu.ops.fft import effective_precision
    from gfx_ocean_tpu.utils.compile_cache import enable_default_cache
    from gfx_ocean_tpu.utils.complexpair import from_pair_np
    from gfx_ocean_tpu.utils.profiling import frame_record, time_rollout

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {dev.platform}")
    enable_default_cache()
    cfg = ot.OceanConfig()
    state = ot.ocean_state_from_phillips(cfg, ot.PhillipsConfig(seed=0))

    t_check = 11.25
    disp = np.asarray(
        ot.make_step(cfg)(state, jnp.float32(t_check)).displacement)
    want = golden_fields(from_pair_np(np.asarray(state.h0)),
                         np.asarray(state.omega), t_check, cfg.domain_size,
                         cfg.compat)
    abs_linf = float(np.abs(disp - want).max())
    rel_linf = abs_linf / float(np.abs(want).max())
    if not np.isfinite(rel_linf) or rel_linf > ACCURACY_GATE:
        raise SystemExit(f"accuracy gate failed: relative L-inf {rel_linf:.3e} "
                         f"> {ACCURACY_GATE}")

    rollout = ot.make_rollout(cfg, keep_fields=False, time_batch=TIME_BATCH)
    ts = jnp.arange(STEPS, dtype=jnp.float32) * jnp.float32(1.0 / 60.0)
    record = time_rollout(rollout, state, ts, repeats=REPEATS)

    print(json.dumps({
        "metric": "ocean_full_step_512_steps_per_sec",
        "value": record["steps_per_sec"],
        "unit": "steps/s",
        "detail": {
            "grid": cfg.resolution,
            "rollout_steps": STEPS,
            "time_batch": TIME_BATCH,
            "fft_impl": cfg.fft_impl,
            "matmul_precision": cfg.matmul_precision,
            "effective_precision": effective_precision(
                cfg.matmul_precision, cfg.fft_impl),
            "rel_linf_vs_golden": rel_linf,
            "abs_linf_vs_golden": abs_linf,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "repeats_sec": record["repeats_sec"],
            "fused_frame_1200x700": frame_record(),
        },
    }))


if __name__ == "__main__":
    main()

"""Generate the rasterizer's golden frame artifacts.

``tests/data/golden_frame_128.npy`` (always): the seeded synthesized sea
(``ocean_state_from_phillips(OceanConfig(), PhillipsConfig(seed=0))``,
the sea ``tests/conftest.py`` builds) cropped to 128^2, stepped to
t = 11.25 and rendered at 96x64 on a 64^2 mesh at the default camera.
``tests/test_render.py::test_golden_frame_regression`` asserts against it.

``tests/data/golden_frame_production_1200x700.npz`` (only when the
reference's shipped ``spectrum.bin``/``omega.bin`` are present): the full
fused pipeline (step -> rasterize -> deferred shade -> sRGB,
``render/raster.make_frame_renderer``) at the reference's 1200x700 window
on the shipped 512^2 assets. ``test_production_frame_golden`` asserts
against it and skips without the shipped bins.

Regenerate ONLY for an intended visual change:
    JAX_PLATFORMS=cpu python tools/make_golden_frame.py
"""
from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tests", "data")


def golden_128() -> np.ndarray:
    import gfx_ocean_tpu as ot
    from gfx_ocean_tpu.models.ocean import downsample_state
    from gfx_ocean_tpu.render import render_frame
    from gfx_ocean_tpu.render.camera import Camera

    state = downsample_state(ot.ocean_state_from_phillips(
        ot.OceanConfig(), ot.PhillipsConfig(seed=0)), 128)
    cfg = ot.OceanConfig(resolution=128, compute_normals=False)
    disp = ot.make_step(cfg)(state, jnp.float32(11.25)).displacement
    return np.asarray(render_frame(disp, Camera(), width=96, height=64,
                                   mesh_resolution=64, num_patches=4,
                                   samples=24))


def production() -> np.ndarray:
    import gfx_ocean_tpu as ot
    from gfx_ocean_tpu.render.camera import Camera, perspective
    from gfx_ocean_tpu.render.raster import make_frame_renderer

    w, h = 1200, 700
    state = ot.ocean_state_from_assets()
    fr = make_frame_renderer(ot.OceanConfig(), width=w, height=h)
    vp = jnp.asarray((perspective(w / h) @ Camera().view()).astype(np.float32))
    cp = jnp.asarray(Camera().position.astype(np.float32))
    return np.asarray(fr(state, jnp.float32(11.25), vp, cp))


def main() -> None:
    from gfx_ocean_tpu.assets.bincode import reference_data_dir

    t0 = time.time()
    out = os.path.join(DATA, "golden_frame_128.npy")
    np.save(out, golden_128())
    print(f"wrote {out} in {time.time() - t0:.1f}s")
    if not os.path.exists(os.path.join(reference_data_dir(), "spectrum.bin")):
        print("shipped bins absent: production golden left as it is")
        return
    t0 = time.time()
    frame = production()
    out = os.path.join(DATA, "golden_frame_production_1200x700.npz")
    np.savez_compressed(out, frame=frame,
                        meta=np.array([1200, 700, 512], dtype=np.int64))
    print(f"wrote {out} in {time.time() - t0:.1f}s")


if __name__ == "__main__":
    main()

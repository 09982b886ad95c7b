"""Multi-chip band-parallel rendering (shard_map over viewport rows).

The reference draws its whole 1200x700 window on the one GPU
(``src/render.rs:1312-1362``); this module is the scaling axis it lacks:
split the viewport into horizontal bands, one per device along a mesh
axis, and let each device run the UNMODIFIED pool rasterizer on its band
(``render/raster.py`` ``y_origin``/``full_height``). Band pixels sample
f32-identical NDC centers to the full-frame render, so the composited
image is BIT-equal to the single-device frame — the split is free of
seams by construction, not by tolerance. The sim step is replicated per
device (replicating it avoids an all_gather of the displacement map on
the frame's critical path).

For OFFLINE frame production, ``make_sharded_batch_renderer`` adds the
orthogonal axis: frames data-parallel over the mesh (the sim is stateless
in time, so frames are independent — the multi-chip generalization of the
reference's 3 frames in flight, ``src/lib.rs:86``), composable with the
band split on a 2-D mesh.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from gfx_ocean_tpu.config import OceanConfig
from gfx_ocean_tpu.models.ocean import OceanState
from gfx_ocean_tpu.render.raster import _fused_frame_fn


def _band_frame_fn(config: OceanConfig, width: int, height: int,
                   giants: int, pool: int | None, band_axis: str,
                   n_bands: int, diag: bool = False):
    """One fused step -> band rasterize -> sRGB body for the device's
    band (``jax.lax.axis_index(band_axis)`` picks the rows). This IS
    the single-chip ``render.raster._fused_frame_fn`` with the band
    parameters set — one body, so the sharded/single-chip BIT-equality
    contract can't drift."""
    return _fused_frame_fn(config, width, height, giants, pool,
                           band_axis=band_axis, n_bands=n_bands, diag=diag)


def make_sharded_frame_renderer(
    config: OceanConfig,
    mesh: Mesh,
    width: int,
    height: int,
    giants: int = 512,
    pool: int | None = None,
    axis: str = "row",
    diag: bool = False,
):
    """Jitted fused step -> band rasterize -> sRGB over a device mesh.

    Returns ``fn(state, t, view_proj, camera_pos) -> (height, width, 3)
    uint8`` whose output rows are sharded over ``mesh[axis]`` (device d
    renders rows ``[d*height/D, (d+1)*height/D)``); ``np.asarray`` on the
    result gathers the bands. The image is bit-equal to
    ``make_frame_renderer(config, width, height, giants)`` on one chip
    (asserted in tests and ``__graft_entry__.dryrun_multichip``).

    With ``diag=True`` returns ``(frame, dropped)`` where ``dropped`` is
    the per-band (n_bands,) count of giant-pass candidates past capacity
    — the in-graph tripwire for the band bit-equality contract (a band
    whose pool overflow out-runs ``giants`` silently loses coverage;
    any nonzero entry means this frame may differ from single-chip).

    ``view_proj`` must be built with the FULL viewport aspect
    (``perspective(width / height)``), exactly as for the single-chip
    renderer — bands crop the sample grid, not the projection.
    """
    band_fn = _band_frame_fn(config, width, height, giants, pool, axis,
                             mesh.shape[axis], diag=diag)
    rep = P()
    state_specs = OceanState(h0=rep, omega=rep)
    if diag:
        def body(state, t, vp, cp):
            frame, dropped = band_fn(state, t, vp, cp)
            return frame, dropped[None]          # (1,) per band -> (D,)
        out_specs = (P(axis), P(axis))
    else:
        body = band_fn
        out_specs = P(axis)
    # check_vma=False: the band body calls the jitted _rasterize_pool,
    # whose inner jit does not carry varying-mesh-axes metadata; the
    # out_specs contract (rows vary over ``axis`` only) is asserted
    # bit-exactly against the single-chip renderer in tests instead.
    fn = shard_map(body, mesh=mesh,
                   in_specs=(state_specs, rep, rep, rep),
                   out_specs=out_specs, check_vma=False)
    return jax.jit(fn)


def make_sharded_batch_renderer(
    config: OceanConfig,
    mesh: Mesh,
    width: int,
    height: int,
    giants: int = 512,
    pool: int | None = None,
    frame_axis: str = "batch",
    band_axis: str = "row",
):
    """Offline frame production over the WHOLE mesh: frames data-parallel
    over ``frame_axis`` x viewport bands over ``band_axis``.

    Returns ``fn(state, ts, view_projs, camera_pos) -> (F, height, width,
    3) uint8`` with F sharded over ``frame_axis`` and rows over
    ``band_axis``; F must divide by ``mesh[frame_axis]`` (the CLI pads
    its ragged tail chunk, ``cli.py cmd_render``). Bit-equal to
    ``render.raster.make_batch_renderer`` on one chip.
    """
    band_fn = _band_frame_fn(config, width, height, giants, pool, band_axis,
                             mesh.shape[band_axis])
    n_fp = mesh.shape[frame_axis]

    def local(state, ts, vps, cps):
        # Unrolled, not vmapped: vmap degrades the rasterizer's
        # while_loop/sort/scatter lowering ~6x on device (see
        # render.raster.make_batch_renderer). The local frame count
        # (F / mesh[frame_axis]) is static under jit.
        return jnp.stack([band_fn(state, ts[i], vps[i], cps[i])
                          for i in range(ts.shape[0])])

    rep = P()
    state_specs = OceanState(h0=rep, omega=rep)
    fspec = P(frame_axis)
    fn = shard_map(local, mesh=mesh,
                   in_specs=(state_specs, fspec, fspec, fspec),
                   out_specs=P(frame_axis, band_axis), check_vma=False)
    jfn = jax.jit(fn)

    def call(state, ts, vps, cps):
        if ts.shape[0] % n_fp:
            raise ValueError(
                f"frame count {ts.shape[0]} must divide by mesh axis "
                f"{frame_axis!r} ({n_fp}); pad the chunk")
        return jfn(state, ts, vps, cps)

    return call

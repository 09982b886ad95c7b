"""Multi-chip scaling over a ``jax.sharding.Mesh``.

The reference is strictly single-process single-GPU (one queue,
``src/render.rs:128-140``; SURVEY.md §2.5). This module is the capability it
lacks: pick a mesh, annotate shardings, let XLA insert the collectives.

Mesh axes:
    "batch" — data parallelism over independent ocean patches / cascades
              (the multi-chip generalization of the reference's 4-instance
              patch draw, ``src/render.rs:518-559``).
    "row"   — spatial parallelism over grid rows: each chip owns a
              contiguous band of the (N, N) spectrum. The 2-D FFT then
              needs exactly one resharding between the row-pass and the
              col-pass — the distributed-FFT transpose (SURVEY.md §5
              "long-context" analog). Under ``jit`` XLA inserts the
              all-to-all; ``distributed_fft.py`` is the explicit
              shard_map formulation of the same thing.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from gfx_ocean_tpu.config import OceanConfig
from gfx_ocean_tpu.models.ocean import OceanState, step


def make_mesh(
    devices: Optional[Sequence[jax.Device]] = None,
    batch: int = 1,
    row: Optional[int] = None,
) -> Mesh:
    """Build a ("batch", "row") mesh over the given (default: all) devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if row is None:
        row = n // batch
    if batch * row != n:
        raise ValueError(f"batch*row = {batch}*{row} != {n} devices")
    arr = np.asarray(devices).reshape(batch, row)
    return Mesh(arr, axis_names=("batch", "row"))


def state_specs(batched: bool) -> OceanState:
    """PartitionSpecs for an OceanState: rows sharded, batch (if any) DP."""
    if batched:
        return OceanState(h0=P("batch", None, "row", None),
                          omega=P("batch", "row", None))
    return OceanState(h0=P(None, "row", None), omega=P("row", None))


def shard_state(state: OceanState, mesh: Mesh) -> OceanState:
    """Place a (possibly batched) state onto the mesh."""
    batched = state.h0.ndim == 4
    specs = state_specs(batched)
    return OceanState(
        h0=jax.device_put(state.h0, NamedSharding(mesh, specs.h0)),
        omega=jax.device_put(state.omega, NamedSharding(mesh, specs.omega)),
    )


def _make_shard_map_ifft2(config: OceanConfig, mesh: Mesh, batched: bool):
    """The explicit-collective transforms as drop-in ``step(ifft2=...,
    ifft2_planes=...)`` hooks (real-output for the plain/height transform,
    complex-output for the packed choppy pair).

    Derives the leading-dim sharding per call: the dim immediately before
    the (N, N) grid dims is the batch dim when ``batched`` (present in both
    the (3, batch, N, N) stacked-spectra call and the (batch, N, N)
    height-only call of the choppy-precision split); any spectra-stack dim
    ahead of it is replicated.
    """
    from gfx_ocean_tpu.parallel.distributed_fft import (  # noqa: PLC0415
        ifft2_planes_unnorm_sharded, ifft2_real_unnorm_sharded)

    def lead_for(xr):
        lead = [None] * (xr.ndim - 2)
        if batched and lead:
            lead[-1] = "batch"
        return lead

    def ifft2(xr, xi, precision, centered):
        return ifft2_real_unnorm_sharded(
            xr, xi, mesh, axis_name="row",
            direct_max=config.direct_dft_max, precision=precision,
            centered=centered, leading_axes=lead_for(xr))

    def ifft2_planes(xr, xi, precision, centered):
        return ifft2_planes_unnorm_sharded(
            xr, xi, mesh, axis_name="row",
            direct_max=config.direct_dft_max, precision=precision,
            centered=centered, leading_axes=lead_for(xr))

    return ifft2, ifft2_planes


def _resolve_fft(config: OceanConfig, mesh: Mesh, batched: bool, fft: str):
    """Returns the ``(ifft2, ifft2_planes)`` hook pair (both None for
    GSPMD). The packed (``hermitian_pack``) configuration is fully
    supported under both strategies — the 4096^2-class setup runs on the
    explicit-collective transform too."""
    if fft == "gspmd":
        return None, None
    if fft == "shard_map":
        return _make_shard_map_ifft2(config, mesh, batched)
    raise ValueError(f"fft must be 'gspmd' or 'shard_map', got {fft!r}")


def make_sharded_step(config: OceanConfig, mesh: Mesh, batched: bool = True,
                      fft: str = "gspmd"):
    """Jitted ``step`` with mesh shardings on inputs and outputs.

    The step body is the same pure function as single-chip; XLA/GSPMD
    partitions the DFT matmuls (row pass local, one collective resharding,
    col pass local) and the elementwise passes for free. The spectrum flip
    ``h0[::-1, ::-1]`` (propagate pairing) becomes a ppermute across the
    "row" axis, inserted automatically.

    ``fft="shard_map"`` swaps the implicit GSPMD transform for the
    hand-scheduled distributed FFT (``parallel/distributed_fft.py``) —
    pinned all_to_all transposes, same numerics.
    """
    ifft2, ifft2_planes = _resolve_fft(config, mesh, batched, fft)
    specs = state_specs(batched)
    field_spec = (P("batch", "row", None, None) if batched
                  else P("row", None, None))
    out_field = NamedSharding(mesh, field_spec)

    in_shardings = (OceanState(h0=NamedSharding(mesh, specs.h0),
                               omega=NamedSharding(mesh, specs.omega)),
                    None)

    def fn(state: OceanState, t):
        return step(state, t, config, ifft2=ifft2, ifft2_planes=ifft2_planes)

    # Outputs: displacement (..., N, N, 3), normals (..., N, N, 3),
    # foam (..., N, N) — shard rows, replicate channels.
    def out_shardings():
        disp = out_field
        normals = out_field if config.compute_normals else None
        foam = (NamedSharding(mesh, P("batch", "row", None) if batched else P("row", None))
                if config.compute_foam else None)
        from gfx_ocean_tpu.models.ocean import OceanFields  # noqa: PLC0415

        return OceanFields(displacement=disp, normals=normals, foam=foam)

    return jax.jit(fn, in_shardings=in_shardings, out_shardings=out_shardings())


def make_sharded_rollout(config: OceanConfig, mesh: Mesh, batched: bool = True,
                         time_batch: int = 1, fft: str = "gspmd"):
    """Device-resident scan rollout with mesh-sharded state.

    The multi-chip counterpart of ``models.make_rollout`` (checksum mode):
    state stays sharded across the mesh for the whole rollout; each step's
    FFT reshards once over the "row" axis via XLA-inserted collectives.
    Returns per-frame scalar checksums (replicated).

    The time-invariant propagate combination planes are hoisted out of the
    scan exactly as in the single-chip rollout (``models/ocean.py``): the
    ``h0[::-1, ::-1]`` flip they contain is a cross-chip ppermute when
    row-sharded, so hoisting makes it once-per-rollout instead of
    once-per-frame (verified on the HLO: no ppermute inside the scan body).
    """
    from gfx_ocean_tpu.models.ocean import _precompute  # noqa: PLC0415

    ifft2, ifft2_planes = _resolve_fft(config, mesh, batched, fft)
    specs = state_specs(batched)
    state_sharding = OceanState(h0=NamedSharding(mesh, specs.h0),
                                omega=NamedSharding(mesh, specs.omega))

    def one(state, t, pre):
        fields = step(state, t, config, pre=pre, ifft2=ifft2,
                      ifft2_planes=ifft2_planes)
        out = jnp.sum(fields.displacement, dtype=jnp.float32)
        if fields.normals is not None:
            out = out + jnp.sum(fields.normals, dtype=jnp.float32)
        if fields.foam is not None:
            out = out + jnp.sum(fields.foam, dtype=jnp.float32)
        return out

    def body(carry, t):
        state, pre = carry
        if time_batch == 1:
            return carry, one(state, t, pre)
        return carry, jax.vmap(lambda tt: one(state, tt, pre))(t)

    def rollout(state: OceanState, ts):
        if time_batch > 1:
            if ts.shape[0] % time_batch:
                raise ValueError(  # same contract as models.make_rollout
                    f"len(ts)={ts.shape[0]} not a multiple of "
                    f"time_batch={time_batch}")
            ts = ts.reshape(ts.shape[0] // time_batch, time_batch)
        pre = _precompute(state, config)
        _, out = jax.lax.scan(body, (state, pre), ts)
        return out.reshape(-1)

    return jax.jit(rollout, in_shardings=(state_sharding, None))

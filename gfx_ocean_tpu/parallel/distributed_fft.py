"""Explicit-collective distributed 2-D inverse FFT (shard_map + all_to_all).

The reference decomposes its 2-D FFT into independent row FFTs, a barrier,
then column FFTs (``src/render.rs:1158-1231``) — exactly the transpose
decomposition every distributed FFT uses. On a device mesh this becomes:

    row pass   : each device DFTs its local band of rows (local matmuls)
    transpose  : one ``all_to_all`` over the "row" axis reshards from
                 row-bands to column-bands (NCCL over NVLink on GPUs)
    col pass   : each device DFTs its local band of columns (local matmuls)

``sharding.make_sharded_step`` gets the same schedule implicitly from
GSPMD; this module is the hand-scheduled formulation — it pins the
communication pattern (useful at scales where GSPMD's choice regresses).

The local passes are the SAME production kernels as the single-chip path
(``ops/fft.py``), so every capability carries over:

* four-step Cooley-Tukey above ``direct_max`` — table memory is
  O(N1^2 + N2^2 + N1*N2) ~ O(N) instead of a dense N x N W replicated
  per device (at 8192^2 a dense f32 table pair would be ~0.5 GB/device);
* the (-1)^(x+y) centering sign folded into the tables (``centered=``,
  zero runtime ops — the whole correction pass vanishes, reference or
  canonical Q2 convention);
* the full precision ladder including the explicit-split "bf16x3" /
  "bf16x4" tiers (resolved inside ``_mm``/``_einsum``, never handed raw
  to ``jnp.matmul``).

Layout note: inputs are row-sharded (re, im) planes; the output field comes
back **row-sharded** again (a second all_to_all) so downstream elementwise
passes see the same layout they were given.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from gfx_ocean_tpu.ops.fft import (
    col_pass_complex,
    col_pass_real,
    resolve_precision,
    row_pass_complex,
)


def _shard_body(xr, xi, *, axis_name: str, prec, direct_max: int,
                fold: bool, negate: bool) -> jnp.ndarray:
    """Per-shard schedule: row DFT -> all_to_all -> col DFT -> all_to_all.

    Shapes (per shard, P = axis size): xr/xi (..., N/P, N); returns
    (..., N/P, N) — the real field, row-sharded like the input."""
    # The SAME per-axis passes as the single-chip ifft2_real_unnorm
    # (ops/fft.py) — the shard body only adds the all_to_all transposes.
    ar, ai = row_pass_complex(xr, xi, prec, direct_max, fold)

    # Transpose: row-bands -> column-bands. tiled=True keeps the block
    # layout (split the last axis across chips, concat the row axis).
    a2r = jax.lax.all_to_all(ar, axis_name, split_axis=ar.ndim - 1,
                             concat_axis=ar.ndim - 2, tiled=True)
    a2i = jax.lax.all_to_all(ai, axis_name, split_axis=ai.ndim - 1,
                             concat_axis=ai.ndim - 2, tiled=True)

    fr = col_pass_real(a2r, a2i, prec, direct_max, fold, negate)

    # Back to row-sharded so the caller's layout is unchanged.
    return jax.lax.all_to_all(fr, axis_name, split_axis=fr.ndim - 2,
                              concat_axis=fr.ndim - 1, tiled=True)


def _shard_body_planes(xr, xi, *, axis_name: str, prec, direct_max: int,
                       fold: bool, negate: bool):
    """Complex-output twin of :func:`_shard_body` — the transform under
    Hermitian field packing (``models/ocean.py`` ``hermitian_pack``): the
    two packed fields are exactly (Re, Im) of the final transform, so BOTH
    planes ride back through the output all_to_all."""
    ar, ai = row_pass_complex(xr, xi, prec, direct_max, fold)

    def t(a, split, concat):
        return jax.lax.all_to_all(a, axis_name, split_axis=split,
                                  concat_axis=concat, tiled=True)

    a2r = t(ar, ar.ndim - 1, ar.ndim - 2)
    a2i = t(ai, ai.ndim - 1, ai.ndim - 2)
    yr, yi = col_pass_complex(a2r, a2i, prec, direct_max, fold, negate)
    return (t(yr, yr.ndim - 2, yr.ndim - 1),
            t(yi, yi.ndim - 2, yi.ndim - 1))


def ifft2_planes_unnorm_sharded(
    xr: jnp.ndarray,
    xi: jnp.ndarray,
    mesh: Mesh,
    axis_name: str = "row",
    direct_max: int = 1024,
    precision: str = "bf16x3",
    centered: Optional[str] = None,
    leading_axes: Optional[Sequence[Optional[str]]] = None,
):
    """Row-sharded complex-output unnormalized 2-D inverse DFT — the
    distributed twin of ``ops.fft.ifft2_planes_unnorm`` (the packed-field
    transform). Same schedule as :func:`ifft2_real_unnorm_sharded`; both
    output planes return row-sharded."""
    if centered not in (None, "ref", "canonical"):
        raise ValueError(f"centered must be None|'ref'|'canonical', got {centered!r}")
    prec = resolve_precision(precision)
    ndim = xr.ndim
    lead = list(leading_axes) if leading_axes is not None else [None] * (ndim - 2)
    if len(lead) != ndim - 2:
        raise ValueError(f"leading_axes has {len(lead)} entries for {ndim - 2} leading dims")
    spec = P(*lead, axis_name, None)
    body = functools.partial(
        _shard_body_planes, axis_name=axis_name, prec=prec,
        direct_max=direct_max, fold=centered is not None,
        negate=centered == "ref")
    fn = shard_map(body, mesh=mesh, in_specs=(spec, spec),
                   out_specs=(spec, spec))
    return fn(xr, xi)


def ifft2_real_unnorm_sharded(
    xr: jnp.ndarray,
    xi: jnp.ndarray,
    mesh: Mesh,
    axis_name: str = "row",
    direct_max: int = 1024,
    precision: str = "bf16x3",
    centered: Optional[str] = None,
    leading_axes: Optional[Sequence[Optional[str]]] = None,
) -> jnp.ndarray:
    """Row-sharded real-output unnormalized 2-D inverse DFT.

    The distributed twin of ``ops.fft.ifft2_real_unnorm`` — same math, same
    precision tiers, same ``centered`` sign folding; the only difference is
    the pinned all_to_all transpose between the two axis passes.

    Args:
        xr, xi: float32 (..., N, N) spectrum planes, sharded along the
            second-to-last axis over ``axis_name``.
        precision: any tier from ``ops.fft`` — including the explicit-split
            "bf16x3"/"bf16x4" (resolved in the local matmuls, not passed
            raw to XLA).
        centered: None for the plain transform; "ref" / "canonical" folds
            the (-1)^(x+y) centering fix-up (``shader/correction.comp:29``)
            into the DFT tables for free.
        leading_axes: mesh-axis names (or None) for each leading batch dim
            of ``xr`` (everything before the trailing (N, N)); defaults to
            fully replicated leading dims.
    Returns:
        float32 (..., N, N) real field, identically sharded.
    """
    if centered not in (None, "ref", "canonical"):
        raise ValueError(f"centered must be None|'ref'|'canonical', got {centered!r}")
    prec = resolve_precision(precision)
    ndim = xr.ndim
    lead = list(leading_axes) if leading_axes is not None else [None] * (ndim - 2)
    if len(lead) != ndim - 2:
        raise ValueError(f"leading_axes has {len(lead)} entries for {ndim - 2} leading dims")
    spec = P(*lead, axis_name, None)
    body = functools.partial(
        _shard_body, axis_name=axis_name, prec=prec, direct_max=direct_max,
        fold=centered is not None, negate=centered == "ref")
    fn = shard_map(body, mesh=mesh, in_specs=(spec, spec), out_specs=spec)
    return fn(xr, xi)

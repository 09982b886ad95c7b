"""The ocean model: a pure, jittable ``step`` and scanned rollouts.

This replaces the reference's entire host orchestration layer — descriptor
sets, command buffers, the 8-dispatch frame graph and its pipeline barriers
(``src/render.rs:1122-1362``), and the 3-frames-in-flight machinery
(``src/lib.rs:86``, ``src/render.rs:159-172``) — with:

    fields = step(state, t)                  # one frame, pure, jit-able
    traj   = rollout(state, ts)              # lax.scan = frames in flight
    multi  = vmap(step, (0, None))           # cascades / batched patches

State is time-invariant (h0, omega) exactly as in the reference (SURVEY.md
§5: the sim is stateless in time — h(t) is computed directly from h0 and
absolute t, ``src/render.rs:1107-1111``), which *is* the checkpoint system:
serialize (h0, omega, t) and resume anywhere.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from gfx_ocean_tpu.config import OceanConfig, PhillipsConfig
from gfx_ocean_tpu.ops.derived import (finite_difference_normals,
                                       jacobian_foam)
from gfx_ocean_tpu.ops.fft import ifft2_planes_unnorm, ifft2_real_unnorm
from gfx_ocean_tpu.ops.propagate import (
    precompute_propagate,
    precompute_propagate_packed,
    propagate_from_cs,
    propagate_packed_planes,
    propagate_planes_pre,
)
from gfx_ocean_tpu.utils.complexpair import to_pair


class OceanState(NamedTuple):
    """Time-invariant simulation state (the reference's uploaded buffers,
    ``src/render.rs:608-670``). Leading batch axes allowed (cascades).

    ``h0`` carries the complex spectrum as (re, im) float32 planes — complex
    dtypes never cross the jit boundary (see ``utils/complexpair.py``).
    """

    h0: jax.Array     # float32 (..., 2, N, N) initial height spectrum planes
    omega: jax.Array  # float32 (..., N, N) dispersion (rad/s)


class OceanFields(NamedTuple):
    """Per-frame outputs — the displacement texture of
    ``shader/correction.comp`` plus derived maps."""

    displacement: jax.Array          # f32 (..., N, N, 3): (disp_x, height, disp_z)
    normals: Optional[jax.Array]     # f32 (..., N, N, 3) or None
    foam: Optional[jax.Array]        # f32 (..., N, N) or None

    @property
    def height(self) -> jax.Array:
        return self.displacement[..., 1]


def _fields_from_specs(specs_r: jax.Array, specs_i: jax.Array,
                       config: OceanConfig, ifft2=None) -> jax.Array:
    """Evolved spectra planes -> (..., N, N, 3) displacement map.

    The centering sign (correction pass) is folded into the DFT tables —
    correction reduces to channel packing, in the (disp_x, height, disp_z)
    order of ``shader/correction.comp:31-34``.

    ``ifft2`` optionally overrides the transform with a drop-in twin taking
    ``(xr, xi, precision=, centered=)`` — the hook the explicit-collective
    distributed FFT (``parallel/distributed_fft.py``) plugs into.
    """
    if ifft2 is None:
        ifft2 = functools.partial(ifft2_real_unnorm, impl=config.fft_impl,
                                  direct_max=config.direct_dft_max)
    centered = "ref" if config.compat.ref_sign else "canonical"
    if (config.choppy_precision is not None
            and config.choppy_precision != config.matmul_precision):
        height = ifft2(specs_r[0], specs_i[0],
                       precision=config.matmul_precision, centered=centered)
        choppy = ifft2(specs_r[1:], specs_i[1:],
                       precision=config.choppy_precision, centered=centered)
        return jnp.stack([choppy[0], height, choppy[1]], axis=-1)
    fields = ifft2(specs_r, specs_i,
                   precision=config.matmul_precision, centered=centered)
    return jnp.stack([fields[1], fields[0], fields[2]], axis=-1)


def _precompute(state: OceanState, config: OceanConfig):
    """The rollout-hoistable time-invariant planes for the active path."""
    if config.hermitian_pack:
        return precompute_propagate_packed(state.h0, state.omega, config.compat)
    return precompute_propagate(state.h0, config.compat)


def _fields_packed(state: OceanState, t: jax.Array, config: OceanConfig,
                   pre, ifft2=None, ifft2_planes=None) -> jax.Array:
    """Packed-transform step body: 3 fields from 2 transforms.

    The height field rides its own real-output Hermitian transform (at
    ``matmul_precision``); the two choppy fields share one complex
    transform of Z = H_dx + i*H_dz (at ``choppy_precision`` when set) —
    see ``ops/propagate.propagate_packed_planes``.

    ``ifft2`` / ``ifft2_planes`` optionally override the two transforms
    with drop-in twins (same ``(xr, xi, precision=, centered=)``
    signature) — the hooks the explicit-collective distributed FFT plugs
    into (``parallel/sharding.make_sharded_step`` with
    ``fft="shard_map"``).
    """
    if ifft2 is None:
        ifft2 = functools.partial(ifft2_real_unnorm, impl=config.fft_impl,
                                  direct_max=config.direct_dft_max)
    if ifft2_planes is None:
        ifft2_planes = functools.partial(
            ifft2_planes_unnorm, impl=config.fft_impl,
            direct_max=config.direct_dft_max)
    pre_planes, pre_rho, omega_rho = pre
    h_r, h_i, z_r, z_i = propagate_packed_planes(
        pre_planes, pre_rho, state.omega, omega_rho, t,
        config.domain_size, config.compat)
    centered = "ref" if config.compat.ref_sign else "canonical"
    height = ifft2(h_r, h_i, precision=config.matmul_precision,
                   centered=centered)
    choppy_prec = config.choppy_precision or config.matmul_precision
    dxf, dzf = ifft2_planes(z_r, z_i, precision=choppy_prec,
                            centered=centered)
    return jnp.stack([dxf, height, dzf], axis=-1)


def step(state: OceanState, t: jax.Array, config: OceanConfig,
         pre: Optional[jax.Array] = None, ifft2=None,
         ifft2_planes=None) -> OceanFields:
    """One simulation frame: propagate -> 2D iFFT x3 -> correction (+ extras).

    The three spectra are batched into one leading axis so the FFT runs as a
    single batched op instead of the reference's six sequential dispatches
    (``src/render.rs:1158-1231``, SURVEY.md §2.5 "task parallelism").

    ``pre`` optionally passes the time-invariant propagate combination
    planes (``precompute_propagate``) so rollouts hoist them out of the
    scan — the flip gathers then happen once per rollout, not per frame.
    ``ifft2`` / ``ifft2_planes`` optionally override the 2-D transforms
    (see ``_fields_from_specs`` / ``_fields_packed``).
    """
    if config.hermitian_pack:
        if pre is None:
            pre = _precompute(state, config)
        disp = _fields_packed(state, t, config, pre, ifft2=ifft2,
                              ifft2_planes=ifft2_planes)
    else:
        if pre is None or not isinstance(pre, jax.Array):
            pre = precompute_propagate(state.h0, config.compat)
        specs_r, specs_i = propagate_planes_pre(
            pre, state.omega, t, config.domain_size, config.compat)
        disp = _fields_from_specs(specs_r, specs_i, config, ifft2=ifft2)

    normals = None
    if config.compute_normals:
        normals = finite_difference_normals(disp[..., 1], config.normal_height_scale)
    foam = None
    if config.compute_foam:
        if config.num_cascades > 1 and disp.ndim >= 4 and disp.shape[-4] == config.num_cascades:
            # Per-cascade grid spacing (each cascade has its own patch size;
            # the spectrum math itself is scale-invariant since k_hat is
            # normalized, so only foam needs the per-cascade domain).
            foam = jnp.stack([
                jacobian_foam(disp[..., c, :, :, :], config, domain_size=dom)
                for c, dom in enumerate(config.domains)
            ], axis=-3)
        else:
            foam = jacobian_foam(disp, config)
    return OceanFields(displacement=disp, normals=normals, foam=foam)


def make_step(config: OceanConfig, donate: bool = False):
    """Jitted ``step(state, t)`` closure over a static config."""
    fn = functools.partial(step, config=config)
    return jax.jit(fn, donate_argnums=(0,) if donate else ())


def make_rollout(config: OceanConfig, keep_fields: bool = True, time_batch: int = 1):
    """Jitted device-resident rollout over a time vector.

    ``rollout(state, ts) -> OceanFields`` with a leading time axis (or, with
    ``keep_fields=False``, a per-frame scalar checksum — the benchmark mode,
    which keeps the scan output O(steps) instead of O(steps * N^2) so HBM
    capacity never bounds the rollout length).

    ``time_batch > 1`` vmaps ``time_batch`` frames inside each scan
    iteration. Frames are independent (the sim is stateless in time,
    SURVEY.md §5), so this is a pure throughput optimization: the DFT
    matmuls grow a batch dimension. ``len(ts)`` must be a multiple of
    ``time_batch``.

    This is the analog of the reference's frames-in-flight pipelining
    (SURVEY.md §2.5): XLA overlaps the scan iterations' compute and memory
    traffic without any semaphores.
    """

    def one(state, t, pre=None):
        fields = step(state, t, config, pre=pre)
        if keep_fields:
            return fields
        # Cheap full-field reduction: forces every output to be computed.
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

    def rollout(state: OceanState, ts: jax.Array):
        if time_batch > 1:
            if ts.shape[0] % time_batch:
                raise ValueError(
                    f"len(ts)={ts.shape[0]} not a multiple of time_batch={time_batch}")
            ts = ts.reshape(ts.shape[0] // time_batch, time_batch)
        pre = _precompute(state, config)
        _, out = jax.lax.scan(body, (state, pre), ts)
        if time_batch > 1:
            # Flatten (chunks, batch, ...) back to a frame-major time axis.
            out = jax.tree.map(
                lambda x: x.reshape((-1,) + x.shape[2:]) if x is not None else None,
                out, is_leaf=lambda x: x is None)
        return out

    return jax.jit(rollout)


def make_uniform_rollout(config: OceanConfig, steps: int, dt: float,
                         keep_fields: bool = False,
                         phase_recurrence: bool = True,
                         resync_every: int = 32):
    """Rollout over uniformly spaced frames t0 + i*dt with phase recurrence.

    With uniform dt, ``e^{iw(t+dt)} = e^{iwt} * e^{iw dt}``: the (cos, sin)
    phase planes update by one complex multiply per frame instead of two
    full-grid transcendentals — the dominant propagate cost at large N. To
    bound drift, phases are recomputed exactly every ``resync_every`` frames
    (float32 unit-rotation drift is ~2^-24/frame; at the default resync the
    field error stays ~1e-6 relative, validated in tests). Exact-vs-
    recurrence differences vanish entirely at ``resync_every=1``.

    At large N the step is memory-bound and the carried (c, s) planes ADD
    traffic, so recurrence pays only where transcendentals dominate. The
    exact mode (``phase_recurrence=False``) is the plain uniform-grid
    rollout API.

    Returns ``rollout(state, t0) -> checksums (steps,)`` (or fields with
    ``keep_fields=True``).
    """
    if config.hermitian_pack:
        raise ValueError("uniform rollout does not support hermitian_pack; "
                         "use make_rollout (phase recurrence is a net loss "
                         "at large N anyway — see docstring)")

    def one_out(disp):
        normals = (finite_difference_normals(disp[..., 1], config.normal_height_scale)
                   if config.compute_normals else None)
        foam = jacobian_foam(disp, config) if config.compute_foam else None
        fields = OceanFields(displacement=disp, normals=normals, foam=foam)
        if keep_fields:
            return fields
        out = jnp.sum(disp, dtype=jnp.float32)
        if normals is not None:
            out = out + jnp.sum(normals, dtype=jnp.float32)
        if foam is not None:
            out = out + jnp.sum(foam, dtype=jnp.float32)
        return out

    def rollout(state: OceanState, t0):
        t0 = jnp.float32(t0)
        pre = precompute_propagate(state.h0, config.compat)
        phase_d = state.omega * jnp.float32(dt)
        cd = jnp.cos(phase_d)
        sd = jnp.sin(phase_d)

        def exact_cs(i):
            # Dekker-corrected phase, like every other propagate path: a
            # plain f32 product is ~3e-4 rad off at t ~ 1000 s, past the
            # 1e-4 field budget (ops/propagate._phase_mod_2pi docstring).
            from gfx_ocean_tpu.ops.propagate import _phase_mod_2pi  # noqa: PLC0415

            t = t0 + i.astype(jnp.float32) * jnp.float32(dt)
            ph = _phase_mod_2pi(state.omega, t)
            return jnp.cos(ph), jnp.sin(ph)

        def body(carry, i):
            c_prev, s_prev = carry
            if phase_recurrence:
                def recur(cs):
                    c, s = cs
                    return c * cd - s * sd, s * cd + c * sd

                c, s = jax.lax.cond(i % resync_every == 0,
                                    lambda _: exact_cs(i), recur,
                                    (c_prev, s_prev))
            else:
                c, s = exact_cs(i)
            specs_r, specs_i = propagate_from_cs(
                pre, c, s, config.domain_size, config.compat)
            return (c, s), one_out(_fields_from_specs(specs_r, specs_i, config))

        init = (jnp.ones_like(state.omega), jnp.zeros_like(state.omega))
        _, out = jax.lax.scan(body, init, jnp.arange(steps, dtype=jnp.int32))
        return out

    return jax.jit(rollout)


def ocean_state_from_assets(
    spectrum_path: str | None = None,
    omega_path: str | None = None,
    resolution: int = 512,
) -> OceanState:
    """Load the reference's shipped initial conditions as device arrays
    (replaces the staging-buffer upload of ``src/render.rs:742-924``)."""
    from gfx_ocean_tpu.assets import load_omega, load_spectrum  # noqa: PLC0415

    h0 = load_spectrum(spectrum_path, resolution)
    om = load_omega(omega_path, resolution)
    return OceanState(h0=jnp.asarray(to_pair(h0)), omega=jnp.asarray(om))


def ocean_state_from_phillips(
    config: OceanConfig,
    phillips: PhillipsConfig | None = None,
    key: jax.Array | None = None,
) -> OceanState:
    """Synthesize initial conditions at runtime (BASELINE.json config 3)."""
    from gfx_ocean_tpu.spectra.phillips import synthesize  # noqa: PLC0415

    phillips = phillips or PhillipsConfig()
    if key is None:
        key = jax.random.PRNGKey(phillips.seed)
    if config.num_cascades == 1:
        h0, om = synthesize(config.resolution, config.domain_size, phillips, key)
        return OceanState(h0=h0, omega=om)
    keys = jax.random.split(key, config.num_cascades)
    h0s, oms = [], []
    for domain, k in zip(config.domains, keys):
        h0, om = synthesize(config.resolution, domain, phillips, k)
        h0s.append(h0)
        oms.append(om)
    return OceanState(h0=jnp.stack(h0s), omega=jnp.stack(oms))


def downsample_state(state: OceanState, resolution: int) -> OceanState:
    """Crop a state's spectrum to a lower resolution by keeping the lowest
    wavenumbers of the *centered* layout.

    The reference's spectra are stored centered (DC at the grid middle —
    that is what the (-1)^(x+y) fix-up in ``shader/correction.comp``
    compensates), so the low-|k| block is the central crop. Used for the
    256^2 golden config (BASELINE.json config 1) from the shipped 512^2 bins.
    """
    n = state.h0.shape[-1]
    if resolution == n:
        return state
    if resolution > n:
        raise ValueError(f"cannot upsample {n} -> {resolution}")
    lo = (n - resolution) // 2
    hi = lo + resolution
    return OceanState(
        h0=state.h0[..., lo:hi, lo:hi],
        omega=state.omega[..., lo:hi, lo:hi],
    )

"""Configuration for the JAX ocean simulation framework.

Everything that is a compile-time constant or GLSL literal in the reference
(gfx-rs/gfx-ocean) becomes an explicit config field here:

- ``resolution`` / ``domain_size``: reference ``src/render.rs:42-46``
  (WORKGROUP_SIZE=16 * WORKGROUP_NUM=32 = RESOLUTION 512, DOMAIN_SIZE 1000.0).
- ``mesh_resolution``: reference HALF_RESOLUTION=128 (``src/render.rs:44``).
- visual scales: reference ``shader/ocean.vert:22-23`` (y /= 3.0, xz /= 3.5)
  and ``shader/ocean.frag:19`` (height_scale = 180).
- compat flags: behavioral quirks catalogued in SURVEY.md §2.4 (Q1/Q2 and the
  non-conjugated Hermitian pairing of ``shader/propagate.comp:55-62``).

The config is a frozen dataclass so it can be closed over by ``jax.jit``'d
functions as static data (hashable; shapes and branches are compile-time).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CompatFlags:
    """Bit-parity switches for reference quirks (SURVEY.md §2.4).

    wrap_k:
        Q1 — reference ``shader/propagate.comp:45-46`` computes the centered
        wavenumber ``2i - N - 1`` in *unsigned* 32-bit arithmetic, so texels
        with ``i <= N/2`` wrap to ~2**32 and the normalized choppy direction
        degenerates. ``False`` (default) uses the intended signed math;
        ``True`` replicates the wraparound bit-for-bit (uint32 mod 2**32,
        then float32 conversion).
    ref_sign:
        Q2 — reference ``shader/correction.comp:29`` applies ``-1`` when
        ``(x + y)`` is even (a global sign flip of the canonical
        ``(-1)**(x+y)`` centering fix-up). ``True`` (default) matches the
        reference; ``False`` uses the canonical convention.
    conj_neg:
        The reference's Hermitian pairing ``shader/propagate.comp:55-62``
        evolves ``h = h0[k]*e^{iwt} + h0[-k]*e^{-iwt}`` *without* conjugating
        ``h0[-k]`` (canonical Tessendorf uses ``conj(h0(-k))``, which makes
        the spectrum Hermitian and the field exactly real). ``False``
        (default) matches the reference; ``True`` uses the canonical form.
    frag_normal_x:
        Q8 — the reference's fragment shader builds its normal map from
        finite differences of texel channel ``.x``
        (``shader/ocean.frag:55-58``), but ``correction.comp:31`` packs
        ``vec3(disp_x, height, disp_z)`` — channel 0 is the CHOPPY X
        DISPLACEMENT, not the height the variable names (and
        ``height_scale``) clearly intend. ``False`` (default) differences
        the height channel (intended math, same stance as Q1);
        ``True`` replicates the reference's disp_x taps bit-for-bit.
    """

    wrap_k: bool = False
    ref_sign: bool = True
    conj_neg: bool = False
    frag_normal_x: bool = False


@dataclasses.dataclass(frozen=True)
class OceanConfig:
    """Static parameters of the ocean simulation.

    The reference hardcodes N=512 in four kernels (SURVEY.md §2.4 Q6); here
    the resolution is a first-class parameter and all kernels are generated
    for any power-of-two N.
    """

    # --- simulation grid (reference src/render.rs:42-46) ---
    resolution: int = 512
    domain_size: float = 1000.0

    # --- FFT implementation ---
    # "matmul": DFT as dense matmuls (direct W@X@W for N<=1024,
    #           four-step Cooley-Tukey decomposition above).
    # "xla":    jnp.fft (XLA's FFT op; cuFFT on the GPU).
    fft_impl: str = "matmul"
    # Largest N for which a direct dense DFT matrix is used by the matmul
    # path; above this the four-step N = N1*N2 split kicks in.
    direct_dft_max: int = 1024

    # --- numerics ---
    # Matmul precision tier of the "matmul" transform (ops/fft.py):
    #   "bf16x3" / "bf16x4"  explicit hi/lo operand split, 3 or 4 partial
    #                        dots at DEFAULT precision (the default tier)
    #   "highest" / "high" / "default"  XLA's own precision settings
    # The 1e-4 relative L-inf bound vs the float64 golden decides the tier.
    matmul_precision: str = "bf16x3"
    # Optional lower precision for the two choppy-displacement transforms
    # (disp_x/disp_z). The BASELINE accuracy bound is on the HEIGHT field;
    # the XZ offsets are a visual effect scaled by 1/3.5 (ocean.vert:23),
    # where bf16 error (~1e-2 relative) is far below perceptibility. At
    # 4096^2 setting this to "default" turns 2 of the 3 spectra's
    # transforms into single-pass work. None = use matmul_precision.
    choppy_precision: Optional[str] = None
    # Hermitian field packing: the step needs only Re(F(S)) per spectrum, so
    # each evolved spectrum is Hermitian-symmetrized (H = (S + conj(S o
    # rho))/2, exactly Re-preserving) and the two choppy fields then share
    # ONE complex transform (Z = H_dx + i*H_dz -> dx + i*dz). 14 instead of
    # 18 real matmul-stages per frame. The packed propagate needs a second
    # cos/sin plane pair, which outweighs the saved transform when the
    # transform is small. None (default) = auto: on for resolution >= 1024.
    hermitian_pack: Optional[bool] = None
    dtype: str = "float32"

    # --- quirk compatibility (SURVEY.md §2.4) ---
    compat: CompatFlags = dataclasses.field(default_factory=CompatFlags)

    # --- outputs ---
    compute_normals: bool = True
    compute_foam: bool = False
    # Foam/whitecap threshold on the Jacobian determinant of the horizontal
    # displacement map (BASELINE.json config 4).
    foam_threshold: float = 0.6
    # Horizontal displacement scale used in the Jacobian (choppiness).
    foam_lambda: float = 1.0

    # --- visual scales (reference shader/ocean.vert:22-23, ocean.frag:19) ---
    height_div: float = 3.0
    horiz_div: float = 3.5
    normal_height_scale: float = 180.0
    # Opt-in Cook-Torrance specular from the reference's defined-but-unused
    # GGX helpers (shader/ocean.frag:31-46); 0 = reference-faithful stylized
    # shading, > 0 = the GGX roughness of the added lobe.
    pbr_roughness: float = 0.0

    # --- render mesh (reference src/render.rs:44, :473-605) ---
    mesh_resolution: int = 128
    num_patches: int = 4

    # --- cascades (BASELINE.json config 4) ---
    num_cascades: int = 1
    # Per-cascade physical domain sizes; ``None`` derives a geometric ladder
    # from ``domain_size`` (L, L/4, L/16, ...).
    cascade_domains: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        n = self.resolution
        if n & (n - 1) != 0 or n < 16:
            raise ValueError(f"resolution must be a power of two >= 16, got {n}")
        if self.fft_impl not in ("matmul", "xla"):
            raise ValueError(f"unknown fft_impl {self.fft_impl!r} "
                             "(expected 'matmul' or 'xla')")
        if self.hermitian_pack is None:
            object.__setattr__(self, "hermitian_pack", self.resolution >= 1024)
        if self.cascade_domains is not None and len(self.cascade_domains) != self.num_cascades:
            raise ValueError("cascade_domains length must equal num_cascades")

    @property
    def domains(self) -> Tuple[float, ...]:
        if self.cascade_domains is not None:
            return self.cascade_domains
        return tuple(self.domain_size / (4.0 ** i) for i in range(self.num_cascades))


@dataclasses.dataclass(frozen=True)
class PhillipsConfig:
    """Runtime spectrum synthesis parameters (BASELINE.json config 3).

    The reference ships precomputed ``data/spectrum.bin`` / ``data/omega.bin``
    (generator not in the repo — SURVEY.md §3.4); these parameters drive our
    regeneration path: the Phillips spectrum
    ``P(k) = A * exp(-1/(k L_w)^2) / k^4 * |k_hat . w_hat|^2`` with
    ``L_w = V^2 / g`` and deep-water dispersion ``omega = sqrt(g |k|)``.
    """

    amplitude: float = 3.0e-7
    wind_speed: float = 31.0
    wind_direction: Tuple[float, float] = (1.0, 0.0)
    gravity: float = 9.81
    # Suppress waves shorter than this factor of the domain (stability).
    small_wave_cutoff: float = 1.0e-3
    # Exponent on the directional term |k_hat . w_hat|; 2 is classic Phillips.
    directional_power: float = 2.0
    seed: int = 0
    # Spectrum model: classic "phillips", or "jonswap" — the fetch-limited
    # Hasselmann et al. 1973 frequency spectrum converted to the wave-vector
    # domain (spectra/phillips.py:jonswap_spectrum), peak-normalized to the
    # Phillips scale so states drop into the same step()/render scalings.
    model: str = "phillips"
    # JONSWAP fetch length F in meters (distance the wind has blown over).
    fetch: float = 5.0e5
    # JONSWAP peak-enhancement factor gamma (1.0 = Pierson-Moskowitz shape).
    peak_enhancement: float = 3.3
    # Water depth in meters: finite values switch the dispersion to
    # w = sqrt(g k tanh(k h)) (intermediate/shallow water slows long
    # waves) and, under model="jonswap", apply the TMA Kitaigorodskii
    # depth attenuation to the spectrum (Bouws et al. 1985);
    # inf = the reference's deep-water w = sqrt(g k).
    depth: float = float("inf")
    # Multiplier on P(k) for waves moving AGAINST the wind
    # (k_hat . w_hat < 0): 1.0 keeps the classic symmetric |dot|^p,
    # smaller values damp opposing waves (Tessendorf's suppression of
    # waves traveling upwind; 0 removes them entirely).
    opposing_suppression: float = 1.0

    def __post_init__(self):
        if self.model not in ("phillips", "jonswap"):
            raise ValueError(f"unknown spectrum model {self.model!r} "
                             "(expected 'phillips' or 'jonswap')")
        import math

        if self.model == "jonswap" and not (
                math.isfinite(self.fetch) and self.fetch > 0):
            # fetch=inf silently zeroes the whole sea (alpha -> 0).
            raise ValueError("jonswap fetch must be finite and > 0, got "
                             f"{self.fetch}")
        if self.model == "jonswap" and not (
                math.isfinite(self.peak_enhancement)
                and self.peak_enhancement > 0):
            # gamma ** r with fractional r NaNs out for gamma < 0, zeroes
            # the sea for gamma == 0, and gamma = inf NaNs the peak
            # normalization — all silently.
            raise ValueError("jonswap peak_enhancement (gamma) must be "
                             f"finite and > 0, got {self.peak_enhancement}")
        if not (self.depth > 0):
            raise ValueError(f"depth must be > 0 (meters), got {self.depth}")
        if not (0.0 <= self.opposing_suppression <= 1.0):
            raise ValueError("opposing_suppression must be in [0, 1], got "
                             f"{self.opposing_suppression}")

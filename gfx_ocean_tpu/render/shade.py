"""Fragment shading: stylized water of ``shader/ocean.frag``.

Faithful port of the fragment math (all constants cited):

- finite-difference normals from +-1-texel height taps with
  height_scale = 180 and diff = 2/dim (``ocean.frag:19, 50-67``);
- depth ramp albedo ``mix(shallow, deep, 1 - clamp((y+10)/50, 0, 1.5)^1.2)``
  (``ocean.frag:22-24, 69-70``);
- Schlick Fresnel with f0 = (0.04, 0.04, 0.07), f90 = 1 (``ocean.frag:28-30,
  83``);
- final color ``max(0.7, NdotL) * albedo * (1 - F)``, fixed light direction
  (1, 0.2, 0) (``ocean.frag:72, 85``). The GGX D/G helpers are defined but
  unused in the reference's final color (SURVEY.md §2.2) — they are ported
  here (``d_ggx``/``g_schlick``, unit-tested against the GLSL formulas)
  and wired into an OPT-IN Cook-Torrance specular term
  (``pbr_roughness > 0``); the default output stays bit-identical to the
  reference-faithful stylized shading.

Everything is jnp and batch-friendly: inputs are (..., ) pixel arrays.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

SHALLOW = np.array([0.0, 0.86, 0.79], dtype=np.float32)
DEEP = np.array([0.03, 0.08, 0.18], dtype=np.float32)
F0 = np.array([0.04, 0.04, 0.07], dtype=np.float32)
LIGHT_DIR = np.array([1.0, 0.2, 0.0], dtype=np.float32) / np.linalg.norm([1.0, 0.2, 0.0])
HEIGHT_SCALE = 180.0
CLEAR_COLOR = np.array([0.6, 0.6, 0.6], dtype=np.float32)


def _normalize(v, axis=-1):
    return v / jnp.linalg.norm(v, axis=axis, keepdims=True)


def _sample_bilinear_wrap(tex: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Bilinear sample of tex[(y, x), C] at normalized (u, v), repeat wrap.

    Matches the reference sampler (linear filter, Tile wrap,
    ``src/render.rs:397-398``); GL-style texel centers at (i + 0.5) / N.
    """
    n_y, n_x = tex.shape[0], tex.shape[1]
    x = u * n_x - 0.5
    y = v * n_y - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = jnp.mod(x0.astype(jnp.int32), n_x)
    y0i = jnp.mod(y0.astype(jnp.int32), n_y)
    x1i = jnp.mod(x0i + 1, n_x)
    y1i = jnp.mod(y0i + 1, n_y)
    t00 = tex[y0i, x0i]
    t10 = tex[y0i, x1i]
    t01 = tex[y1i, x0i]
    t11 = tex[y1i, x1i]
    return ((t00 * (1 - fx) + t10 * fx) * (1 - fy)
            + (t01 * (1 - fx) + t11 * fx) * fy)


def sample_displacement(displacement: jnp.ndarray, u, v) -> jnp.ndarray:
    """(N, N, 3) displacement texture sampled at (u, v) — ``ocean.vert:21``."""
    return _sample_bilinear_wrap(displacement, u, v)


def _pack_f16_pair(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Two f32 planes -> one uint32 plane of (f16(a) | f16(b) << 16)."""
    import jax  # noqa: PLC0415

    lo = jax.lax.bitcast_convert_type(a.astype(jnp.float16), jnp.uint16)
    hi = jax.lax.bitcast_convert_type(b.astype(jnp.float16), jnp.uint16)
    return lo.astype(jnp.uint32) | (hi.astype(jnp.uint32) << 16)


def _unpack_f16_pair(p: jnp.ndarray):
    import jax  # noqa: PLC0415

    lo = jax.lax.bitcast_convert_type((p & 0xFFFF).astype(jnp.uint16),
                                      jnp.float16)
    hi = jax.lax.bitcast_convert_type((p >> 16).astype(jnp.uint16),
                                      jnp.float16)
    return lo.astype(jnp.float32), hi.astype(jnp.float32)


def _packed_table_bilerp(planes, u, v):
    """Bilinear-sample each (N, N) f32 plane at (u, v), repeat wrap, all
    planes through ONE packed table-row gather.

    Packs (plane[y, x], plane[y, x+1]) as the f16 lanes of a uint32 and
    bakes the +1-row shift into a second column per plane, so a
    (N^2, 2 * len(planes)) table gathered once at the flat (y0, x0)
    index yields all four bilinear corners of every plane — one
    contiguous-row table gather instead of four (1, 1) texture gathers.
    f16 lane precision bounds each plane to ~1e-3 relative of its own
    magnitude.
    Returns one lerped array per plane (shape of ``u``).
    """
    n_y, n_x = planes[0].shape
    cols = []
    for plane in planes:
        t0 = _pack_f16_pair(plane, jnp.roll(plane, -1, axis=1))
        cols += [t0, jnp.roll(t0, -1, axis=0)]
    n_cols = len(cols)
    tab = jnp.stack(cols, axis=-1).reshape(n_y * n_x, n_cols)

    # Fewer, wider rows: fold ``group`` texels into each row (adjacent
    # flat indices, so row r = texels [r*group, (r+1)*group)) so the table
    # keeps at most 2^17 rows, and select the right column group with the
    # fused elementwise bits of the flat index. The fold answers a
    # row-count gather cost of the earlier accelerator; whether it pays
    # on the GPU is not measured. Capped at 8 texels/row AND 32 total u32
    # columns (past them, e.g. a 4096^2 texture would need group=128 =>
    # 512-col rows + a 127-deep select chain per column).
    group = 1
    while ((n_y * n_x) // group > (1 << 17) and group < 8
           and 2 * group * n_cols <= 32):
        group *= 2
    if group > 1:
        tab = tab.reshape(n_y * n_x // group, group * n_cols)

    x = u * n_x - 0.5
    y = v * n_y - 0.5
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = jnp.mod(x0.astype(jnp.int32), n_x)
    y0i = jnp.mod(y0.astype(jnp.int32), n_y)
    flat = y0i * n_x + x0i
    grows = jnp.moveaxis(tab[flat // group], -1, 0)     # (group*n_cols, ...)
    if group > 1:
        sub = flat - (flat // group) * group            # texel within row
        rows = []
        for k in range(n_cols):
            r = grows[k]
            for g in range(1, group):
                r = jnp.where(sub == g, grows[g * n_cols + k], r)
            rows.append(r)
    else:
        rows = list(grows)

    out = []
    for k in range(len(planes)):
        a00, a10 = _unpack_f16_pair(rows[2 * k])
        a01, a11 = _unpack_f16_pair(rows[2 * k + 1])
        out.append((a00 * (1 - fx) + a10 * fx) * (1 - fy)
                   + (a01 * (1 - fx) + a11 * fx) * fy)
    return out


def fragment_normals(displacement: jnp.ndarray, u, v,
                     channel: int = 1,
                     height_scale: float = HEIGHT_SCALE,
                     tiles=None) -> jnp.ndarray:
    """textureOffset +-1 taps on one displacement channel (``ocean.frag:54-67``).

    ``channel``: which packed texel channel the taps difference. The
    reference frag taps ``.x`` — which is the CHOPPY X DISPLACEMENT, not
    height, because ``correction.comp:31`` packs (disp_x, height,
    disp_z); the variable names and ``height_scale`` clearly intend the
    height channel. Default 1 (height — the intended math); pass 0 for
    bit-parity with the reference's actual taps (CompatFlags Q8,
    ``frag_normal_x``).

    GLSL ``textureOffset`` shifts the sampled TEXEL by exactly one, keeping
    the bilinear fraction — so ``tap(u+du) - tap(u-du)`` equals the
    bilinear sample of the centered-difference map
    ``dxh[j, i] = h[j, i+1] - h[j, i-1]`` (both are the same weighted sum
    of texel differences), replacing the 16 gathers of the naive 4-tap
    form. The remaining 4-corner taps of dxh and dzh ride ONE packed
    table-row gather (``_packed_table_bilerp``; complex packing does NOT
    help — XLA lowers a complex gather to separate re/im gathers,
    measured). Slopes are pre-scaled by 1 / HEIGHT_SCALE before the f16
    lane round so the magnitude is O(1) (no overflow at any grid size);
    the f16 mantissa keeps slopes to ~1e-3 relative, well under
    visibility, and shading is clamped (``max(0.7, NdotL)``) over most
    of the field anyway.
    """
    inv_scale = 1.0 / height_scale

    def slope_maps(hc):
        dxh = (jnp.roll(hc, -1, axis=1) - jnp.roll(hc, 1, axis=1)) * inv_scale
        dzh = (jnp.roll(hc, -1, axis=0) - jnp.roll(hc, 1, axis=0)) * inv_scale
        return dxh, dzh

    if displacement.ndim == 4:
        # Cascade stack: the composite height is sum_c h_c(uv * tile_c),
        # so its texel-space slope is sum_c tile_c * slope_c (the chain
        # rule's tile factor — finer cascades are steeper per patch unit).
        c_count = displacement.shape[0]
        tiles = tiles or (1.0,) * c_count
        gx = gz = 0.0
        for c in range(c_count):
            dxh, dzh = slope_maps(displacement[c][..., channel])
            gxc, gzc = _packed_table_bilerp([dxh, dzh], u * tiles[c],
                                            v * tiles[c])
            gx = gx + gxc * tiles[c]
            gz = gz + gzc * tiles[c]
        n_y, n_x = displacement.shape[1:3]
    else:
        h = displacement[..., channel]
        dxh, dzh = slope_maps(h)
        n_y, n_x = h.shape
        gx, gz = _packed_table_bilerp([dxh, dzh], u, v)
    diff_x = 2.0 / n_x
    diff_y = 2.0 / n_y
    na = _normalize(jnp.stack([jnp.full_like(gx, -diff_x), gx, jnp.zeros_like(gx)], -1))
    nb = _normalize(jnp.stack([jnp.zeros_like(gz), gz, jnp.full_like(gz, diff_y)], -1))
    return _normalize(jnp.cross(na, nb))


def g1_schlick(no_x, k):
    """``ocean.frag:31-33``: NoX / (NoX * (1 - k) + k)."""
    return no_x / (no_x * (1.0 - k) + k)


def g_schlick(ndotl, ndotv, roughness):
    """``ocean.frag:35-38``: Smith-Schlick visibility, k = roughness / 2."""
    k = roughness / 2.0
    return g1_schlick(ndotl, k) * g1_schlick(ndotv, k)


def d_ggx(roughness, ndoth):
    """``ocean.frag:40-46``: GGX NDF, alpha = roughness^2 (Frostbite form)."""
    alpha = roughness * roughness
    f = (ndoth * alpha - ndoth) * ndoth + 1.0
    return alpha / (f * f * np.float32(np.pi))


FOAM_COLOR = np.array([0.92, 0.96, 0.98], dtype=np.float32)


def sample_mask_bilinear(mask: jnp.ndarray, u, v) -> jnp.ndarray:
    """Bilinear-sample an (N, N) scalar mask with repeat wrap, via the
    same packed table-row gather as the normal taps (one contiguous row
    gather instead of four (1, 1) texture gathers).
    f16 lane precision is ample for a [0, 1] coverage mask."""
    return _packed_table_bilerp([mask], u, v)[0]


def shade_fragments(displacement: jnp.ndarray, u, v, world_pos, camera_pos,
                    foam: jnp.ndarray | None = None,
                    frag_channel: int = 1,
                    height_scale: float = HEIGHT_SCALE,
                    pbr_roughness: float = 0.0,
                    tiles=None) -> jnp.ndarray:
    """Full ``ocean.frag`` color for pixel arrays. Returns (..., 3).

    ``foam`` (optional, BEYOND the reference — its fragment shader has no
    whitecaps): a (N, N) [0, 1] coverage mask (``ops/derived.jacobian_foam``).
    Bilinear-sampled and mixed into the albedo before lighting, so the
    Fresnel/NdotL terms still apply; ``foam=None`` (the default) is
    bit-identical to the reference-faithful path.

    ``pbr_roughness > 0`` (opt-in, beyond the reference) adds a
    Cook-Torrance specular lobe ``D_GGX * G_Schlick * F / (4 NoL NoV) *
    NoL`` built from the reference's own defined-but-unused BRDF helpers
    (``ocean.frag:31-46``); 0 (default) leaves the stylized color
    bit-unchanged.
    """
    n = fragment_normals(displacement, u, v, channel=frag_channel,
                         height_scale=height_scale, tiles=tiles)

    depth = 1.0 - jnp.clip((world_pos[..., 1] + 10.0) / 50.0, 0.0, 1.5) ** 1.2
    albedo = SHALLOW[None] * (1.0 - depth[..., None]) + DEEP[None] * depth[..., None]
    # NB: mix(shallow, deep, depth) == shallow*(1-depth) + deep*depth; with
    # the clamp to 1.5 the mix can extrapolate, exactly as in GLSL.
    if foam is not None:
        if foam.ndim == 3:      # per-cascade masks: union of coverage
            c_tiles = tiles or (1.0,) * foam.shape[0]
            f = sum(sample_mask_bilinear(foam[c], u * c_tiles[c],
                                         v * c_tiles[c])
                    for c in range(foam.shape[0]))
        else:
            f = sample_mask_bilinear(foam, u, v)
        f = jnp.clip(f, 0.0, 1.0)[..., None]
        albedo = albedo * (1.0 - f) + jnp.asarray(FOAM_COLOR)[None] * f

    light = jnp.asarray(LIGHT_DIR)
    view = _normalize(jnp.asarray(camera_pos) - world_pos)
    h_vec = _normalize(light + view)

    ndotl = jnp.clip(jnp.sum(n * light, axis=-1), 0.0001, 1.0)
    hdotv = jnp.clip(jnp.sum(h_vec * view, axis=-1), 0.0, 1.0)

    f = F0[None] + (1.0 - F0[None]) * (1.0 - hdotv[..., None]) ** 5.0
    color = jnp.maximum(0.7, ndotl)[..., None] * albedo * (1.0 - f)
    if pbr_roughness > 0.0:
        r = jnp.float32(pbr_roughness)
        ndoth = jnp.clip(jnp.sum(n * h_vec, axis=-1), 0.0, 1.0)
        ndotv = jnp.clip(jnp.sum(n * view, axis=-1), 0.0001, 1.0)
        spec = (d_ggx(r, ndoth) * g_schlick(ndotl, ndotv, r)
                / (4.0 * ndotv))[..., None] * f  # * NoL / NoL cancels
        color = color + spec
    return color

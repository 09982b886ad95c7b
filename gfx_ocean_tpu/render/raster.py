"""Vectorized JAX rasterizer for verification frames.

Stands in for the reference's graphics pipeline (``src/render.rs:264-395``
render pass + ``shader/ocean.vert``/``ocean.frag``): vertex displacement,
projection with the reference's clip-space y negation, z-buffered triangle
rasterization with perspective-correct varyings, and the stylized water
shading of ``shade.py``. Clear color (0.6, 0.6, 0.6) and depth-clear 1.0
match ``src/render.rs:1340-1350``.

Design: data-parallel rasterization in 2D homogeneous
coordinates (Olano & Greer 1997). Coverage and interpolation use
lambda_i(p) = (v_j x v_k) . p on clip-space (x, y, w) directly — no
near-plane clipping stage is ever needed, and triangles crossing the eye
plane rasterize their visible part correctly. Perspective-correct
interpolation of any vertex attribute is the normalized-lambda weighted
sum; z comes from the same weights applied to clip z.

Two implementations share the same coverage predicate (edge tests) and
therefore the same coverage/z output, plus common gather + deferred
varying passes:

``impl="pool"`` (default; the fast path). The window impl pays
    samples^2 sample slots for EVERY triangle even though most project to
    a few pixels. The pool impl spends exactly one slot per 4x2-pixel OCT
    TILE of each triangle's viewport-clamped bbox: triangles sort by slot
    count (ascending), a prefix sum assigns each a contiguous slot range
    in a static ``pool``, a segment-boundary scatter + cumsum maps each
    slot back to its triangle, and each slot edge-tests its 8 tile pixels
    from one packed row (the 15 sign-folded edge/z/w coefficients plus
    start/bbox/id). Every hit's packed key is then scatter-min'd into the
    key image. Triangles that don't fit (prefix sum past the pool end —
    the LARGEST areas, by the ascending sort) spill to the gather pass.
``impl="window"`` (the original; kept as the golden reference for the
    pool path). Every fully-in-front triangle gets samples^2 sample
    points snaking row-major through its own screen bbox; bboxes larger
    than the budget spill to the gather pass.

Shared passes:
 - gather: spilled triangles plus any triangle with a vertex behind the
   eye plane (unbounded projected bbox) are ranked by need and the top
   ``giants`` are edge-tested against every pixel, in groups, merging
   into the same packed visibility-key image as the scatter pass
   (``_pack_key``: quantized z in the high bits, id in the low — ONE
   uint32 channel; ties resolve to the lowest id, deterministically and
   identically in every pass).
 - deferred: one per-pixel reconstruction of uv/world varyings AND the
   exact f32 depth from the winning id (vertex ids and corner uvs are
   decoded arithmetically for the grid mesh, ``_decode_tri``).

Rendering is decoupled from the benchmarked sim loop (BASELINE.json),
but the pool impl is fast enough for interactive serving (serve.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from gfx_ocean_tpu.render import shade as sh
from gfx_ocean_tpu.render.camera import Camera, perspective
from gfx_ocean_tpu.render.mesh import build_grid, instantiate


def _vertex_stage(displacement, positions, uvs, view_proj, interp=None,
                  height_div: float = 3.0, horiz_div: float = 3.5,
                  tiles=None):
    """``shader/ocean.vert``: displace, offset, project, negate clip y.

    ``interp``: optional ``(Wy, Wx)`` bilinear-interpolation matrices from
    ``_interp_matrices`` (a tuple of per-cascade pairs when
    ``displacement`` is a (C, N, N, 3) cascade stack). The mesh UVs are
    STATIC (and identical across the 4 patch instances), so sampling the
    displacement texture at them is a fixed linear map: two small matmuls
    replace four texture-sized gathers. The einsum order is pinned (x-axis
    lerp first, then y) to match the gather form's association; the
    remaining difference is f32 product rounding at 'highest' precision
    (f32-ulp level — both rasterizer impls share this path, so their
    coverage stays identical).

    Cascade compositing (beyond the reference — it has no cascades): the
    displaced surface is the SUM of the per-cascade displacement fields,
    cascade c sampled at uv * tiles[c] with repeat wrap (its physical
    domain repeats domain_size / L_c times across the patch).
    """
    cascades = displacement.ndim == 4
    if interp is not None:
        pairs = interp if cascades else (interp,)
        stacks = displacement if cascades else displacement[None]
        grid = None
        for c, (w_y, w_x) in enumerate(pairs):
            h = w_y.shape[0]
            tmp = jnp.einsum("nmc,xm->nxc", stacks[c], w_x,
                             precision="highest")
            g = jnp.einsum("yn,nxc->yxc", w_y, tmp, precision="highest")
            grid = g if grid is None else grid + g
        disp = jnp.tile(grid.reshape(h * h, 3),
                        (positions.shape[0] // (h * h), 1))
    elif cascades:
        tiles = tiles or tuple(1.0 for _ in range(displacement.shape[0]))
        disp = sum(
            sh.sample_displacement(displacement[c], uvs[:, 0] * tiles[c],
                                   uvs[:, 1] * tiles[c])
            for c in range(displacement.shape[0]))
    else:
        disp = sh.sample_displacement(displacement, uvs[:, 0], uvs[:, 1])
    # the ocean.vert:22-23 visual scales, as OceanConfig fields
    disp = disp.at[:, 1].multiply(1.0 / height_div)
    disp = disp.at[:, 0].multiply(1.0 / horiz_div)
    disp = disp.at[:, 2].multiply(1.0 / horiz_div)
    world = positions + disp
    ones = jnp.ones((world.shape[0], 1), world.dtype)
    # precision='highest': a reduced-precision f32 matmul (TF32 on the
    # GPU) quantizes clip coords and breaks the homogeneous edge tests
    # (pixel-level speckle). Full f32 costs nothing at V x 4 x 4.
    clip = jnp.einsum("vi,ji->vj", jnp.concatenate([world, ones], axis=-1),
                      view_proj, precision="highest")
    clip = clip.at[:, 1].multiply(-1.0)  # ocean.vert:27
    return world, clip


_TRI_CHUNK = 4096   # scatter triangles per scan iteration — bounds memory
_GIANT_GROUP = 32   # gather triangles per scan iteration


@functools.lru_cache(maxsize=32)
def _interp_matrices(mesh_resolution: int, n_tex: int, tile: float = 1.0):
    """(Wy, Wx) bilinear sampling matrices for the static mesh UV grid.

    Row k holds the two wrap-mod-N texel weights of GL-style bilinear
    sampling at u = tile * k / (h - 1) (texel centers at (i + 0.5) / N,
    matching ``shade._sample_bilinear_wrap``; repeat wrap makes u > 1
    tile the texture). ``tile`` > 1 is the cascade compositing factor:
    cascade c with physical domain L_c repeats domain_size / L_c times
    across the patch. Built in float64 on host, shipped once per
    (mesh, texture, tile).
    """
    h = mesh_resolution
    # divide-then-multiply: tile == 1.0 is then bit-identical to the
    # untiled matrices (multiplying by a pre-divided factor rounds
    # differently in f64).
    u = np.arange(h, dtype=np.float64) / (h - 1) * float(tile)
    x = u * n_tex - 0.5
    x0 = np.floor(x)
    fx = (x - x0).astype(np.float32)
    x0i = np.mod(x0.astype(np.int64), n_tex)
    x1i = np.mod(x0i + 1, n_tex)
    w = np.zeros((h, n_tex), dtype=np.float32)
    rows = np.arange(h)
    w[rows, x0i] += 1.0 - fx
    w[rows, x1i] += fx
    wj = jnp.asarray(w)
    return wj, wj


@functools.lru_cache(maxsize=8)
def _mesh_constants(mesh_resolution: int, num_patches: int):
    """Host mesh build + device upload, once per mesh config, instead of
    rebuilding the 66K-vertex grid and re-shipping ~1.3 MB of constants
    per frame."""
    mesh = build_grid(mesh_resolution, num_patches)
    positions, uvs, tris = instantiate(mesh)
    return (jnp.asarray(positions), jnp.asarray(uvs),
            jnp.asarray(tris.astype(np.int32)))


_SCAN_LANES = 128


def _prefix_sum_mxu(x: jnp.ndarray) -> jnp.ndarray:
    """Inclusive prefix sum of a 1-D int32 array via triangular matmuls.

    A prefix sum is a matmul against a triangular ones matrix: reshape to
    (R, 128) rows, within-row inclusive cumsum = X @ U (upper-triangular
    ones, 128^2), then exclusive row offsets via the same trick over the
    R row totals, broadcast-added back. Whether this beats ``jnp.cumsum``
    on the GPU is not measured.

    EXACTNESS DOMAIN: results are exact while every partial sum stays
    below 2^24 (f32 integer range; 'highest' keeps products exact).
    Both call sites are safe past that: the slot machinery only consumes
    prefix values near or below ``pool`` (~2^18, exact) — entries whose
    running total exceeds 2^24 are already far past the pool and only
    feed the (cum > pool) overflow boolean and start >= pool masks,
    which an ulp of error cannot flip at that magnitude. segd sums are
    bounded by the triangle count (< 2^24). Exactness in the bounded
    domain is asserted by a direct unit test against ``jnp.cumsum`` and
    by the pool==window equality tests, which depend on exact slot
    arithmetic.
    """
    n = x.shape[0]
    rows = -(-n // _SCAN_LANES)
    xf = jnp.zeros((rows * _SCAN_LANES,), jnp.float32).at[:n].set(
        x.astype(jnp.float32)).reshape(rows, _SCAN_LANES)
    upper = jnp.triu(jnp.ones((_SCAN_LANES, _SCAN_LANES), jnp.float32))
    within = jnp.dot(xf, upper, precision="highest")     # (R, 128) inclusive
    totals = within[:, -1]                               # (R,)
    rows2 = -(-rows // _SCAN_LANES)
    tf = jnp.zeros((rows2 * _SCAN_LANES,), jnp.float32).at[:rows].set(
        totals).reshape(rows2, _SCAN_LANES)
    t_within = jnp.dot(tf, upper, precision="highest")
    t_tot = t_within[:, -1]
    # rows2 is tiny (<= ~16 for any realistic pool): close the recursion
    # with one more triangular matmul over the row2 totals.
    upper2 = jnp.triu(jnp.ones((rows2, rows2), jnp.float32))
    t2 = jnp.dot(t_tot[None, :], upper2, precision="highest")[0]
    t_incl = (t_within + (t2 - t_tot)[:, None]).reshape(-1)[:rows]
    offsets = t_incl - totals                            # exclusive
    out = (within + offsets[:, None]).reshape(-1)[:n]
    # Clamp before the int cast: totals beyond int32 (pathological giant
    # scenes) would hit implementation-defined f32->i32 conversion; every
    # consumer only compares against pool-magnitude values, so the clamp
    # is semantics-preserving.
    return jnp.minimum(out, jnp.float32(2 ** 31 - 65536)).astype(jnp.int32)


def _tri_corners(clip, tris, grid_shape=None):
    """``clip[tris]`` without the gather for the standard grid mesh.

    ``grid_shape=(num_patches, h)``: vertices are patch-major (h, h)
    grids and ``tris`` is ``build_grid``/``instantiate`` order — per
    patch, every cell's (a, b, c) triangle row-major, then every
    (c, b, d). Shifted slices of the (P, h, h, 4) clip grid reproduce
    ``clip[tris]`` exactly, in order, as bulk copies instead of a
    (T, 3, 4) gather.
    """
    if grid_shape is None:
        return clip[tris]
    p, h = grid_shape
    g = clip.reshape(p, h, h, clip.shape[-1])
    a = g[:, :-1, :-1]
    b = g[:, 1:, :-1]
    c = g[:, :-1, 1:]
    d = g[:, 1:, 1:]
    t1 = jnp.stack([a, b, c], axis=3).reshape(p, -1, 3, clip.shape[-1])
    t2 = jnp.stack([c, b, d], axis=3).reshape(p, -1, 3, clip.shape[-1])
    return jnp.concatenate([t1, t2], axis=1).reshape(-1, 3, clip.shape[-1])


def _lambdas(v_clip, pnx, pny, pix_dims):
    """Homogeneous edge functions at pixels, sign(det)-folded.

    Args:
        v_clip: (..., 3, 4) clip coords of a triangle batch.
        pnx, pny: pixel-center NDC coords with ``pix_dims`` trailing pixel
            dims, broadcastable against the triangle batch dims.
    Returns:
        (lam0, lam1, lam2, det): lam_i(p) = sign(det) * (v_j x v_k) .
        (pnx, pny, 1) over clip (x, y, w); det = (v1 x v2) . v0. The
        sign fold makes the hit test ``all lam_i >= 0 and
        (lam0+lam1+lam2) > 0`` (the last also enforces w(p) > 0 — in
        front of the eye) — the IDENTICAL predicate the pool impl's
        per-slot stage evaluates from its sign-folded table rows, so
        pool/window/giant coverage agrees even on the IEEE edge where
        ``lam * det`` underflows to -0.0 (an unfolded ``lam * det >= 0``
        would accept there while the folded form rejects). Sign flips
        are exact in f32 and cancel in every normalized-lambda ratio, so
        interpolated varyings and depth are bit-unchanged. det == 0
        degenerates (sign 0) zero every lam and are rejected by the
        denom > 0 test.
    """
    v = v_clip[..., (0, 1, 3)]                      # (..., 3, 3): x, y, w
    cr = jnp.cross(v[..., (1, 2, 0), :], v[..., (2, 0, 1), :])  # (...,3,3)
    det = jnp.sum(cr[..., 0, :] * v[..., 0, :], axis=-1)
    cr = cr * jnp.sign(det)[..., None, None]
    pix_axes = tuple(range(-pix_dims, 0))

    def ev(i):  # lam_i = cr_i . (pnx, pny, 1), broadcast over pixels
        c0 = jnp.expand_dims(cr[..., i, 0], pix_axes)
        c1 = jnp.expand_dims(cr[..., i, 1], pix_axes)
        c2 = jnp.expand_dims(cr[..., i, 2], pix_axes)
        return c0 * pnx + c1 * pny + c2

    return ev(0), ev(1), ev(2), det


def _pixel_ndc(width: int, height: int, y_origin=0, full_height: int | None = None):
    """Pixel-center NDC coordinate rows for a (height, width) image.

    With ``y_origin``/``full_height`` the image is a horizontal BAND of a
    ``full_height``-row viewport starting at global row ``y_origin`` (the
    multi-chip band renderer): local row j samples the f32-identical NDC
    the full-frame render uses for global row ``y_origin + j`` (integer
    adds are exact below 2^24, so band coverage is bit-equal to the full
    frame's rows, not merely close)."""
    full_height = height if full_height is None else full_height
    pnx = 2.0 * (jnp.arange(width, dtype=jnp.float32)[None, :] + 0.5) / width - 1.0
    gy = (jnp.arange(height, dtype=jnp.int32) + y_origin).astype(jnp.float32)
    pny = 2.0 * (gy[:, None] + 0.5) / full_height - 1.0
    return pnx, pny


# A numpy scalar, NOT jnp: a module-level jnp constant commits a device
# array at import time, initializing the backend on the default platform
# before entry points can honor JAX_PLATFORMS. numpy scalars trace
# identically inside jit.
_KEY_MAX = np.uint32(0xFFFFFFFF)


_MIN_Z_BITS = 12


def _id_bits(t_count: int) -> int:
    """Bits reserved for the triangle id in the packed visibility key.

    Raises for meshes whose id width would squeeze the quantized z below
    ``_MIN_Z_BITS`` (the production 128^2 x 4 mesh uses 17 id / 15 z
    bits, depth quantum 6e-5 NDC; at 12 z bits the quantum is 4.9e-4 and
    the near-tie band in which winners are id-ordered rather than
    z-ordered becomes visually plausible — refuse rather than degrade
    silently; render a mesh that big with multiple passes or a smaller
    patch count instead).
    """
    bits = max(int(t_count - 1).bit_length(), 1)
    if 32 - bits < _MIN_Z_BITS:
        raise ValueError(
            f"{t_count} triangles need {bits} id bits, leaving "
            f"{32 - bits} z bits in the packed visibility key "
            f"(minimum {_MIN_Z_BITS}); use a mesh with at most "
            f"2^{32 - _MIN_Z_BITS} triangles")
    return bits


def _pack_key(z, tri_id, hit, id_bits: int):
    """(z, id) -> one uint32 visibility key; min-reduction = z-buffer.

    The high ``32 - id_bits`` bits hold NDC z quantized linearly over
    (-1, 1) (15 bits at the production mesh — quantum 6e-5); the low
    bits hold the triangle id, so ties on the quantized z resolve to the
    SMALLEST id, deterministically and identically in the pool, window
    and giant passes. Exact per-pixel depth is recomputed from the
    winning id in the deferred pass, so z precision is NOT limited by
    the key — the quantization only widens the near-tie band in which
    the winner is id-ordered rather than z-ordered (adjacent mesh
    triangles interpolate the same continuous surface there, so the
    color impact is ~ulp). One uint32 scatter-min replaces the window
    impl's original scatter-min + gather + scatter triple.
    """
    z_bits = 32 - id_bits
    # Quantize with an INTEGER clamp to 2^z_bits - 2: a float clamp bound
    # of 2^z_bits - 1 rounds to 2^z_bits in f32 for z_bits >= 25 (small
    # meshes), overflowing the field; and capping one quantum below the
    # top keeps the max legitimate key strictly below _KEY_MAX, so a
    # max-id far-plane hit can never alias the no-hit sentinel.
    # Clip/min in f32/i32, convert to u32 LAST: the clipped value is in
    # [0, 2^z_bits - 2] which always fits int32 (z_bits <= 31).
    zq = jnp.minimum(
        jnp.clip((z * 0.5 + 0.5) * float(1 << z_bits), 0.0,
                 float((1 << z_bits) - 2)).astype(jnp.int32),
        jnp.int32((1 << z_bits) - 2)).astype(jnp.uint32)
    key = (zq << id_bits) | tri_id.astype(jnp.uint32)
    return jnp.where(hit, key, _KEY_MAX)


def _giant_pass(clip, tris_all, score, key_img, width: int,
                height: int, giants: int, id_bits: int,
                y_origin=0, full_height: int | None = None):
    """Edge-test the ``giants`` highest-scored triangles against every
    pixel, in groups of ``_GIANT_GROUP``, merging visibility keys into
    the scatter pass's key image. Non-positive scores are inert, and the
    group loop has a DYNAMIC trip count (``lax.while_loop``): the
    sorted-by-score group list stops at the last active group, so the
    common scene (camera above the water, nothing crossing, no overflow)
    pays ~zero here instead of ``giants/_GIANT_GROUP`` full-screen
    passes."""
    t_count = tris_all.shape[0]
    k_giants = min(giants, t_count)
    if k_giants == 0:
        return key_img
    _, giant_ix = jax.lax.top_k(score, k_giants)
    giant_ok = jnp.take(score, giant_ix) > 0
    groups = -(-k_giants // _GIANT_GROUP)
    gpad = groups * _GIANT_GROUP - k_giants
    giant_ix = jnp.concatenate([giant_ix, jnp.zeros(gpad, giant_ix.dtype)])
    giant_ok = jnp.concatenate([giant_ok, jnp.zeros(gpad, bool)])
    giant_ix = giant_ix.reshape(groups, _GIANT_GROUP)
    giant_ok = giant_ok.reshape(groups, _GIANT_GROUP)
    n_active = jnp.sum(giant_ok.astype(jnp.int32))      # descending scores
    groups_needed = (n_active + _GIANT_GROUP - 1) // _GIANT_GROUP
    pnx_f, pny_f = _pixel_ndc(width, height, y_origin, full_height)

    crossing_g = jnp.isinf(score)
    fh = height if full_height is None else full_height
    jx = jax.lax.broadcasted_iota(jnp.int32, (1, 1, width), 2)
    jy = (jax.lax.broadcasted_iota(jnp.int32, (1, height, 1), 1)
          + jnp.asarray(y_origin, jnp.int32))

    def giant_group(kb, ix, ok):
        v_clip = clip[tris_all[ix]]                     # (G, 3, 4)
        lam0, lam1, lam2, _ = _lambdas(v_clip, pnx_f[None], pny_f[None], 2)
        denom = lam0 + lam1 + lam2                      # (G, H, W)
        hit = ((lam0 >= 0) & (lam1 >= 0) & (lam2 >= 0)
               & (denom > 0)) & ok[:, None, None]
        # Finite-score giants (pool overflow / window over-budget) are
        # FULLY-FRONT triangles the slot/window walks would have masked
        # to their TIGHT pixel-center bbox — apply the same mask here,
        # or a pixel center an epsilon outside the projected extent can
        # round to a hit that the in-pool path (correctly) never
        # evaluates, making coverage depend on WHICH path absorbed the
        # triangle (measured as pool-vs-window diffs at 1200x700; also a
        # band/full hazard if overflow ever differs per band). Crossing
        # triangles (score inf) keep the unbounded test — their
        # projected extent wraps through infinity, so no finite bbox
        # exists and BOTH impls give them to this pass.
        # Same expressions as the pool bbox (sx/sy/ceil/floor), so an
        # overflow triangle's mask here is bit-identical to the mask the
        # slot walk would have applied. Crossing giants divide by w <= 0
        # here — the garbage bbox is ORed away by ``cross``.
        wv = v_clip[..., 3]
        sxg = (v_clip[..., 0] / wv * 0.5 + 0.5) * width
        syg = (v_clip[..., 1] / wv * 0.5 + 0.5) * fh
        x0g = jnp.ceil(sxg.min(-1) - 0.5)[:, None, None]
        x1g = jnp.floor(sxg.max(-1) - 0.5)[:, None, None]
        y0g = jnp.ceil(syg.min(-1) - 0.5)[:, None, None]
        y1g = jnp.floor(syg.max(-1) - 0.5)[:, None, None]
        cross = crossing_g[ix][:, None, None]
        jxf = jx.astype(jnp.float32)
        jyf = jy.astype(jnp.float32)
        in_box = ((jxf >= x0g) & (jxf <= x1g) & (jyf >= y0g) & (jyf <= y1g))
        hit = hit & (cross | in_box)
        lam_w = (lam0 * v_clip[:, None, None, 0, 3]
                 + lam1 * v_clip[:, None, None, 1, 3]
                 + lam2 * v_clip[:, None, None, 2, 3])
        z = (lam0 * v_clip[:, None, None, 0, 2]
             + lam1 * v_clip[:, None, None, 1, 2]
             + lam2 * v_clip[:, None, None, 2, 2]) / jnp.where(
                 lam_w == 0, 1.0, lam_w)
        hit = hit & (z > -1.0) & (z < 1.0)
        key = _pack_key(z, ix[:, None, None], hit, id_bits)  # (G, H, W)
        return jnp.minimum(kb, key.min(axis=0))

    def cond(carry):
        return carry[0] < groups_needed

    def body(carry):
        g, kb = carry
        ix = jax.lax.dynamic_index_in_dim(giant_ix, g, 0, keepdims=False)
        ok = jax.lax.dynamic_index_in_dim(giant_ok, g, 0, keepdims=False)
        return g + 1, giant_group(kb, ix, ok)

    _, key_img = jax.lax.while_loop(cond, body, (jnp.int32(0), key_img))
    return key_img


def _decode_tri(id_img, grid_shape):
    """Triangle id -> (vertex ids (..., 3), corner uvs (..., 3, 2)) for
    the standard grid mesh, by pure integer arithmetic (no table gather).

    Inverts the ``build_grid``/``instantiate`` layout: per patch, all
    (a, b, c) cell triangles row-major, then all (c, b, d); vertex
    ``z * h + x`` within a patch; uv = (x, z) / (h - 1), identical
    across patches. Guarded exact vs the index/uv tables by
    ``tests/test_render.py::test_decode_tri_matches_tables``.
    """
    p_count, h = grid_shape
    cells = (h - 1) * (h - 1)
    tp = 2 * cells
    patch = id_img // tp
    r = id_img - patch * tp
    s = r // cells                                      # 0: (a,b,c), 1: (c,b,d)
    cell = r - s * cells
    cz = cell // (h - 1)
    cx = cell - cz * (h - 1)
    base = patch * (h * h) + cz * h + cx
    # corner (x, z) offsets within the cell, per set
    sb = s.astype(jnp.int32)
    dx = jnp.stack([sb, jnp.zeros_like(sb), jnp.ones_like(sb)], axis=-1)
    dz = jnp.stack([jnp.zeros_like(sb), jnp.ones_like(sb), sb], axis=-1)
    vt = base[..., None] + dz * h + dx
    denom = np.float32(h - 1)
    u = (cx[..., None] + dx).astype(jnp.float32) / denom
    v = (cz[..., None] + dz).astype(jnp.float32) / denom
    return vt, jnp.stack([u, v], axis=-1)


def _gather_rows_t(tab, idx):
    """Gather rows of ``tab`` (T, C) at ``idx`` (...), emitting the
    TRANSPOSED (C, ...) result via gather dimension numbers (offset dim
    first): for image-shaped indices the (C, H, W) planes downstream read
    as contiguous leading-dim slices."""
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(0,), collapsed_slice_dims=(0,), start_index_map=(0,))
    return jax.lax.gather(tab, idx[..., None], dn,
                          slice_sizes=(1, tab.shape[1]))


def _edge_table(v_clip):
    """Per-triangle sign-folded homogeneous edge table, (T, 15) f32:
    columns [cr00..cr22 (9), z0 z1 z2, w0 w1 w2]. Shared by the pool
    impl's slot stage and the deferred pass of BOTH impls, so every
    stage evaluates lam/denom/z from literally the same coefficients.
    See ``_lambdas`` for the sign-fold semantics."""
    t_count = v_clip.shape[0]
    v3 = v_clip[..., (0, 1, 3)]                         # clip (x, y, w)
    cr = jnp.cross(v3[:, (1, 2, 0), :], v3[:, (2, 0, 1), :])   # (T, 3, 3)
    det = jnp.sum(cr[:, 0, :] * v3[:, 0, :], axis=-1)
    cr = cr * jnp.sign(det)[:, None, None]
    return jnp.concatenate([cr.reshape(t_count, 9), v_clip[..., 2],
                            v_clip[..., 3]], axis=1)    # (T, 15)


def _deferred_table(ftab, world, tris_all, uvs, grid_shape):
    """Pack everything the deferred pass needs into ONE per-triangle f32
    table: [edge table (15) | world corners (9) | uv corners (6, only
    when the mesh is not arithmetic-decodable)]. The deferred pass then
    costs a single (H*W)-row table gather instead of separate per-corner
    clip/world/uv gathers (3x the rows each) plus per-pixel cross
    products."""
    wc = _tri_corners(world, tris_all, grid_shape)      # (T, 3, 3)
    cols = [ftab, wc.reshape(wc.shape[0], 9)]
    if grid_shape is None:
        cols.append(uvs[tris_all].reshape(-1, 6))
    return jnp.concatenate(cols, axis=1)


def _deferred_shade(displacement, dtab, key_img,
                    camera_pos, width: int, height: int, id_bits: int,
                    grid_shape=None, foam=None, frag_channel: int = 1,
                    height_scale: float = 180.0,
                    pbr_roughness: float = 0.0, tiles=None,
                    y_origin=0, full_height: int | None = None):
    """Per-pixel varying reconstruction + fragment shading from the
    winning visibility-key image. Perspective-correct uv/world via the
    same lambda weights; the EXACT f32 depth is recomputed here from the
    winning triangle's packed row (the visibility passes min-reduce only
    the quantized key — see ``_pack_key``). Uncovered pixels compute
    garbage from id 0 and are masked by ``covered`` at the end. Returns
    ``(color, z_img)``."""
    covered = key_img != _KEY_MAX
    id_img = (key_img & jnp.uint32((1 << id_bits) - 1)).astype(jnp.int32)
    pnx_f, pny_f = _pixel_ndc(width, height, y_origin, full_height)
    # One transposed row gather: (C, H, W) planes. Plane reads are then
    # leading-dim slices (contiguous) instead of minor-dim slices of the
    # (H, W, C) form.
    tpl = _gather_rows_t(dtab, id_img)                  # (C, H, W)
    lam0 = tpl[0] * pnx_f + tpl[1] * pny_f + tpl[2]
    lam1 = tpl[3] * pnx_f + tpl[4] * pny_f + tpl[5]
    lam2 = tpl[6] * pnx_f + tpl[7] * pny_f + tpl[8]
    denom = lam0 + lam1 + lam2
    inv_denom = 1.0 / jnp.where(denom == 0, 1.0, denom)

    lam_w = lam0 * tpl[12] + lam1 * tpl[13] + lam2 * tpl[14]
    z_pix = (lam0 * tpl[9] + lam1 * tpl[10]
             + lam2 * tpl[11]) / jnp.where(lam_w == 0, 1.0, lam_w)
    z_img = jnp.where(covered, z_pix.astype(jnp.float32), jnp.inf)

    def interp_planes(corners):                         # 3 x A (H, W) planes
        return jnp.stack(
            [(lam0 * a0 + lam1 * a1 + lam2 * a2) * inv_denom
             for a0, a1, a2 in corners], axis=-1)

    if grid_shape is not None:
        _, uv_corners = _decode_tri(id_img, grid_shape)  # arithmetic decode
        uv_img = (lam0[..., None] * uv_corners[..., 0, :]
                  + lam1[..., None] * uv_corners[..., 1, :]
                  + lam2[..., None] * uv_corners[..., 2, :]
                  ) * inv_denom[..., None]
    else:
        # [u0 v0 u1 v1 u2 v2] columns 24..29
        uv_img = interp_planes([(tpl[24], tpl[26], tpl[28]),
                                (tpl[25], tpl[27], tpl[29])])
    # world corners at columns 15..23 as [x0 y0 z0 x1 y1 z1 x2 y2 z2]
    world_img = interp_planes([(tpl[15], tpl[18], tpl[21]),
                               (tpl[16], tpl[19], tpl[22]),
                               (tpl[17], tpl[20], tpl[23])])

    color = sh.shade_fragments(displacement, uv_img[..., 0], uv_img[..., 1],
                               world_img, camera_pos, foam=foam,
                               frag_channel=frag_channel,
                               height_scale=height_scale,
                               pbr_roughness=pbr_roughness, tiles=tiles)
    clear = jnp.asarray(sh.CLEAR_COLOR)
    return jnp.where(covered[..., None], color, clear[None, None]), z_img


_OCT_W = 4      # oct tile width in pixels
_OCT_H = 2      # oct tile height in pixels


def _slot_keys(crow, total_covered, width: int, height: int,
               full_height: int, bw_bits: int, id_bits: int, y_origin):
    """Per-slot stage: decode the packed slot rows, walk each triangle's
    bbox in 4x2-pixel OCT tiles, evaluate all 8 pixels' edge/denominator/z
    tests, and return ``(keys, flat)``: the (8, P) uint32 visibility keys
    and their (8, P) band-local flat pixel indices (``height * width``,
    one past the key image, for every pixel that is not a hit — the
    resolve drops those updates).

    ``crow`` is the (19, P) row table: 15 f32 edge rows bitcast to u32,
    then the start/xy/bwid/xy1 int rows. Pixels outside the triangle's
    TIGHT bbox are masked explicitly (not left to the edge tests): a
    pixel center an epsilon outside the projected extent could round to
    a hit in f32, and neither the window walk nor the giant pass
    evaluates such pixels (both share the tight-bbox semantics) —
    masking keeps the evaluated pixel set identical. In-bbox pixels
    evaluate the FULL edge expressions (the same symbolic mul/add
    sequence as the window impl, f32). Pool vs window at a large
    viewport are separately compiled programs, so f32 near-ties can flip
    (test_pool_window_near_tie_bound pins that envelope); band/full-frame
    equality is the contract that must be BIT-exact, and it rests on the
    single op stream below."""
    p = crow.shape[1]
    slot = jax.lax.broadcasted_iota(jnp.int32, (1, p), 1)
    valid = slot < total_covered
    st = crow[15:16].astype(jnp.int32)
    xy = crow[16:17]
    bwid = crow[17:18]
    xy1 = crow[18:19]
    px0 = (xy & jnp.uint32(0xFFFF)).astype(jnp.int32)
    py0 = ((xy >> 16) & jnp.uint32(0x7FFF)).astype(jnp.int32)
    px1 = (xy1 & jnp.uint32(0xFFFF)).astype(jnp.int32)
    py1 = ((xy1 >> 16) & jnp.uint32(0x7FFF)).astype(jnp.int32)
    qw = (bwid & jnp.uint32((1 << bw_bits) - 1)).astype(jnp.int32)
    tri_id = (bwid >> bw_bits).astype(jnp.int32)
    # Row-major walk of the oct-tile bbox. f32 divide instead of integer
    # div/mod: quotients are < 2^24 ints with >= 1/qw margin to the next
    # integer (way above f32 ulp), so floor is exact.
    k = slot - st
    kf = k.astype(jnp.float32)
    qwf = qw.astype(jnp.float32)
    q = jnp.floor(kf / qwf)
    colq = (kf - q * qwf).astype(jnp.int32)
    ox = (px0 >> 2) + colq                              # oct column
    oy = (py0 >> 1) + q.astype(jnp.int32)               # oct row (band-local)
    f = [jax.lax.bitcast_convert_type(crow[i:i + 1], jnp.float32)
         for i in range(15)]                            # 15 x (1, P)
    # The 8 oct pixels are evaluated by ONE set of (8, P) array ops — NOT
    # eight per-sub expressions. This is a CORRECTNESS requirement, not a
    # style choice: a pixel's sub row here is (y % 2, x % 4) relative to
    # the OCT grid, and the oct grid is anchored at ``py0 >> 1`` in
    # BAND-LOCAL rows — so the same global pixel lands in sub 0 in the
    # full frame and sub 4 in a band with an odd row origin. Eight
    # separate sub expressions are eight op sequences the compiler may
    # contract differently (1-ulp z differences flip quantized-z
    # near-ties on horizon pixels, breaking band/full bit-equality). One
    # array expression evaluates every sub lane with the same compiled
    # instructions, so a pixel's key is bit-identical whichever sub lane
    # evaluates it. The integer add of ``y_origin`` keeps band NDC
    # bit-identical to the full frame's.
    sub_i = jax.lax.broadcasted_iota(jnp.int32, (_OCT_W * _OCT_H, 1), 0)
    pxs = ox * _OCT_W + sub_i % _OCT_W                  # (8, P)
    pys = oy * _OCT_H + sub_i // _OCT_W
    live = (valid & (pxs >= px0) & (pxs <= px1)
            & (pys >= py0) & (pys <= py1))
    pnx = 2.0 * (pxs.astype(jnp.float32) + 0.5) / width - 1.0
    pny = 2.0 * ((pys + y_origin).astype(jnp.float32) + 0.5
                 ) / full_height - 1.0
    lam0 = f[0] * pnx + f[1] * pny + f[2]
    lam1 = f[3] * pnx + f[4] * pny + f[5]
    lam2 = f[6] * pnx + f[7] * pny + f[8]
    denom = lam0 + lam1 + lam2
    hit = ((lam0 >= 0) & (lam1 >= 0) & (lam2 >= 0) & (denom > 0)) & live
    lam_w = lam0 * f[12] + lam1 * f[13] + lam2 * f[14]
    z = (lam0 * f[9] + lam1 * f[10] + lam2 * f[11]
         ) / jnp.where(lam_w == 0, 1.0, lam_w)
    hit = hit & (z > -1.0) & (z < 1.0)
    key = _pack_key(z, tri_id, hit, id_bits)            # (8, P) u32
    flat = jnp.where(hit, pys * width + pxs, height * width)
    return key, flat


def _auto_pool(width: int, height: int, bands: int = 1) -> int:
    """Slot pool (one slot = a 4x2-pixel OCT tile) sized to ~0.75 slots
    per viewport pixel, floored at 2^18. The default 1200x700 pose
    demands 485K oct slots (counted on the CPU), so 0.75/px = 630K
    carries a ~30% margin; the overflow tail is by construction the few
    LARGEST triangles, which the ``giants`` gather pass absorbs exactly.
    Every per-slot op (and the resolve's scatter) scales with the pool,
    so oversizing costs time; undersizing only shifts work to the gather
    pass (never correctness, up to its ``giants`` capacity — see
    ``pool_overflow``). Rounded up to a multiple of 8192, NOT a power of
    two, which would put up to half of every per-slot op on dead slots.

    ``bands``: this is ONE horizontal band of a viewport split into
    that many (``height`` is then the BAND height). Hits are not
    spread uniformly over bands — distant triangles pile up in the
    band holding the horizon (the default pose at 1200x700 measured
    its horizon band at ~1.8x the uniform share, overflowing a
    proportionally-sized pool past what ``giants`` can absorb,
    silently degrading the band/full-frame bit-equality contract). A
    band pool therefore carries a 2x skew margin, capped at what the
    FULL frame would use (a band can never need more than the whole
    frame)."""
    want = (3 * width * height + 3) // 4
    if bands > 1:
        want = min(2 * want, (3 * width * height * bands + 3) // 4)
    return max(1 << 18, -(-want // 8192) * 8192)


@functools.partial(jax.jit,
                   static_argnames=("width", "height", "pool", "giants",
                                    "grid_shape", "frag_channel", "scales",
                                    "tiles", "full_height", "with_diag"))
def _rasterize_pool(displacement, positions, uvs, tris, view_proj, camera_pos,
                    width: int, height: int, pool: int = 1 << 20,
                    giants: int = 512, interp=None, grid_shape=None,
                    foam=None, frag_channel: int = 1,
                    scales=(3.0, 3.5, 180.0, 0.0), tiles=None,
                    y_origin=0, full_height: int | None = None,
                    with_diag: bool = False):
    """Exact-area pool rasterizer (see module docstring). Coverage and
    depth are identical to ``_rasterize`` (the window impl) by
    construction: both evaluate the same edge/denominator tests at the
    same pixel centers; only the slot->pixel assignment differs.

    ``y_origin``/``full_height`` render a horizontal BAND: the output is
    the (height, width) slice of a ``full_height``-row frame starting at
    global row ``y_origin`` (traced, so one executable serves every band
    of a multi-chip split). Band pixels sample f32-identical NDC centers
    to the full frame's, so stacking the bands reproduces the full-frame
    image BIT-exactly (each band's slot pool and giant pass only ever see
    band pixels; which triangles overflow to the giant pass may differ
    per band, but both passes evaluate the identical edge expressions)."""
    full_height = height if full_height is None else full_height
    y_origin = jnp.asarray(y_origin, jnp.int32)
    world, clip = _vertex_stage(displacement, positions, uvs, view_proj,
                                interp, scales[0], scales[1], tiles)
    t_count = tris.shape[0]

    v_clip = _tri_corners(clip, tris, grid_shape)       # (T, 3, 4)
    w = v_clip[..., 3]
    fully_front = jnp.all(w > 1e-6, axis=-1)
    crossing = jnp.any(w > 1e-6, axis=-1) & ~fully_front

    # Conservative frustum cull (valid for any w sign; see window impl).
    def all_outside(c):
        return jnp.all(c < -w, axis=-1) | jnp.all(c > w, axis=-1)

    outside = (all_outside(v_clip[..., 0]) | all_outside(v_clip[..., 1])
               | all_outside(v_clip[..., 2]))

    # Viewport-clamped TIGHT integer bbox: pixel x can only hit if its
    # center x+0.5 lies in [sx_min, sx_max] (the projected triangle is a
    # subset of its screen extent for fully-front triangles), i.e.
    # x in [ceil(sx_min - 0.5), floor(sx_max - 0.5)] — one pixel tighter
    # per axis than floor(min)..floor(max) on most subpixel triangles,
    # which dominate the slot total. Pixels excluded here fail the edge
    # test by construction, so coverage is unchanged (the window impl
    # snakes the looser unclamped bbox; offscreen/miss pixels are masked
    # there — on-screen coverage is the same).
    w_safe = jnp.where(fully_front[:, None], w, 1.0)
    sx = (v_clip[..., 0] / w_safe * 0.5 + 0.5) * width
    sy = (v_clip[..., 1] / w_safe * 0.5 + 0.5) * full_height
    # y bbox in BAND-LOCAL rows (global minus y_origin; the subtraction
    # is exact in f32 for anything near the viewport, and x - 0.0 == x
    # bit-exactly for the full-frame default).
    yof = y_origin.astype(jnp.float32)
    x0 = jnp.maximum(jnp.ceil(sx.min(-1) - 0.5), 0.0).astype(jnp.int32)
    x1 = jnp.minimum(jnp.floor(sx.max(-1) - 0.5), width - 1.0).astype(jnp.int32)
    y0 = jnp.maximum(jnp.ceil(sy.min(-1) - 0.5) - yof, 0.0).astype(jnp.int32)
    y1 = jnp.minimum(jnp.floor(sy.max(-1) - 0.5) - yof,
                     height - 1.0).astype(jnp.int32)
    # One slot serves a 4x2-pixel OCT tile of the clamped bbox: the
    # per-slot bookkeeping (cumsum, segment scatter, table gathers)
    # scales with the slot count, and the other 7 pixels reuse the slot's
    # table row (1200x700 default pose: 485K oct slots vs 2.36M pixels
    # of bbox coverage). ``area`` is in SLOT (oct) units.
    qw = jnp.maximum((x1 >> 2) - (x0 >> 2) + 1, 0)
    qh = jnp.maximum((y1 >> 1) - (y0 >> 1) + 1, 0)
    live_tri = fully_front & ~outside & (x1 >= x0) & (y1 >= y0)
    area = jnp.where(live_tri, qw * qh, 0)

    # Packed per-triangle payload columns, packed BEFORE the area sort:
    # ``lax.sort`` carries them with the key (one fused sort), replacing
    # the x0/y0/qw/area/crossing [order]-gathers of the argsort form.
    # [x0 | y0 << 16 | crossing << 31], [qw | tri_id << bw_bits] and
    # [x1 | y1 << 16] as uint32, with the id/qw split sized statically
    # from T and width. x0..y1 are the TIGHT pixel bbox: the slot stage
    # masks oct pixels outside it explicitly (a center epsilon outside
    # the projected extent could round to a hit in f32 — the window
    # impl never evaluates such pixels, so masking keeps coverage
    # equality exact).
    id_bits = _id_bits(t_count)
    bw_bits = 32 - id_bits
    if not (width < (1 << 16) and (width + 3) // 4 < (1 << bw_bits)
            and height < (1 << 15)):
        raise ValueError(
            f"viewport {width}x{height} too wide for the packed slot "
            f"table at this mesh size (enforced: width < {1 << 16}, "
            f"ceil(width/4) < {1 << bw_bits} at {id_bits} id bits, "
            f"height < {1 << 15})")
    crossing_visible = crossing & ~outside
    # Clamp the packed coords into the viewport: x0/y0 are only clamped
    # BELOW above, and a fully-front triangle with tiny w (just in front
    # of the eye plane, projecting far off-screen) can have y0 >= 2^15,
    # which would bleed into the crossing bit and spuriously score it
    # inf in the gather pass (junk giants evicting real ones). Live
    # (area > 0) triangles always satisfy x0 <= x1 < width etc., so the
    # clamp never changes a slot-pass value.
    x0c = jnp.clip(x0, 0, width - 1).astype(jnp.uint32)
    y0c = jnp.clip(y0, 0, height - 1).astype(jnp.uint32)
    x1c = jnp.clip(x1, 0, width - 1).astype(jnp.uint32)
    y1c = jnp.clip(y1, 0, height - 1).astype(jnp.uint32)
    pack_xy = (x0c | (y0c << 16)
               | (crossing_visible.astype(jnp.uint32) << 31))
    pack_bw = (jnp.maximum(qw, 1).astype(jnp.uint32)
               | (jnp.arange(t_count, dtype=jnp.uint32) << bw_bits))
    pack_xy1 = x1c | (y1c << 16)

    # Sign(det)-folded edge coefficients (shared helper): the hit test
    # becomes lam_i >= 0 & denom > 0 (sign flips are exact in f32, and
    # the sign cancels in z's ratio — coverage and depth are unchanged;
    # det == 0 degenerates zero out every lam, rejected by denom > 0
    # either way).
    ftab = _edge_table(v_clip)                          # (T, 15)

    # Ascending area sort + prefix sum = slot ranges. Overflow (cum >
    # pool) hits the LARGEST areas first — exactly the triangles the
    # gather pass is built for. (Tie order among equal areas is
    # irrelevant: every triangle gets its own slot range either way.)
    # The 15 edge-table columns RIDE THE SORT as payload operands: the
    # per-slot gather then reads ftab in SORTED order via the monotonic
    # segment index — a coherent gather, instead of gathering through the
    # area-scrambled original ids.
    area_s, xy_s, bwid_s, xy1_s, order, *fcols_s = jax.lax.sort(
        (area, pack_xy, pack_bw, pack_xy1,
         jnp.arange(t_count, dtype=jnp.int32),
         *[ftab[:, i] for i in range(15)]),
        num_keys=1)
    ftab_s = jnp.stack(fcols_s, axis=1)                 # (T, 15), sorted
    cum = _prefix_sum_mxu(area_s)
    start = cum - area_s
    n_zero = t_count - jnp.sum(area_s > 0)

    # Per-triangle row table, f32 edge columns bitcast to u32 and packed
    # WITH the int columns: the slot stage then costs ONE 19-column row
    # gather instead of an int + an f32 gather.
    itab = jnp.stack([start.astype(jnp.uint32), xy_s, bwid_s, xy1_s], axis=1)
    ctab = jnp.concatenate(
        [jax.lax.bitcast_convert_type(ftab_s, jnp.uint32), itab], axis=1)

    # Slot -> sorted triangle: scatter a 1 at every segment start, then
    # a running count. Zero-area triangles sort first and scatter
    # nothing, so slot 0 belongs to the first nonzero-area triangle.
    bmask = (area_s > 0) & (start < pool)
    bidx = jnp.where(bmask, start, pool)                # pool = spill row
    segd = jnp.zeros((pool + 1,), jnp.int32).at[bidx].add(1)
    sorted_idx = jnp.clip(n_zero + _prefix_sum_mxu(segd[:-1]) - 1, 0,
                          t_count - 1)

    # ONE packed-row gather per slot, read in SORTED-segment order
    # (monotonic indices — the cheap, coherent gather form). A slot is
    # live iff it is below the covered prefix (segments are contiguous
    # from 0).
    crow = _gather_rows_t(ctab, sorted_idx)             # (19, P) uint32
    total_covered = jnp.minimum(cum[-1] if t_count else 0, pool)
    keys, flat = _slot_keys(crow, total_covered, width, height, full_height,
                            bw_bits, id_bits, y_origin)
    # Visibility resolve: one uint32 scatter-min of every hit pixel's
    # packed key into the band's key image (a native atomic min on the
    # GPU). Integer min is order-independent, so the winner per pixel is
    # deterministic; non-hit pixels index one past the image and are
    # dropped.
    key_img = jnp.full((height * width,), _KEY_MAX, jnp.uint32).at[
        flat.reshape(-1)].min(keys.reshape(-1), mode="drop"
                              ).reshape(height, width)

    # Gather pass: eye-plane-crossing triangles (unbounded bbox, carried
    # through the sort in the xy column's top bit) + pool overflow.
    # Scores live in sorted space; map back via the sorted iota.
    cross_s = (xy_s >> 31) != 0
    score_s = jnp.where(cross_s, jnp.inf,
                        jnp.where((cum > pool) & (area_s > 0),
                                  area_s.astype(jnp.float32), -1.0))
    # Un-permute scores to original triangle-id order (``order`` is a
    # permutation).
    score = jnp.zeros_like(score_s).at[order].set(score_s,
                                                  unique_indices=True)
    key_img = _giant_pass(clip, tris, score, key_img, width, height,
                          giants, id_bits, y_origin, full_height)

    dtab = _deferred_table(ftab, world, tris, uvs, grid_shape)
    img, z_img = _deferred_shade(displacement, dtab,
                                 key_img, camera_pos, width, height, id_bits,
                                 grid_shape, foam, frag_channel,
                                 scales[2], scales[3] if len(scales) > 3 else 0.0,
                                 tiles, y_origin, full_height)
    if with_diag:
        # In-graph tripwire for the coverage contract: every eye-crossing
        # OR pool-overflowed triangle must win a giant slot for exact
        # coverage; any active candidate past the ``giants`` capacity is
        # SILENTLY dropped (e.g. a horizon band whose pool overflow
        # out-ran giants). This scalar makes that drop observable per
        # frame (serve /metrics, band fuzz tests) at the cost of one
        # T-sized reduction.
        dropped = jnp.maximum(
            jnp.sum((score > 0).astype(jnp.int32))
            - jnp.int32(min(giants, t_count)), 0)
        return img, z_img, dropped
    return img, z_img


def pool_overflow(displacement, positions, uvs, tris, view_proj,
                  width: int, height: int, pool: int | None = None,
                  y_origin: int = 0, full_height: int | None = None,
                  bands: int = 1, return_demand: bool = False):
    """Diagnostic: how many visible triangles spill past the pool (each
    must be absorbed by a gather-pass slot for exact coverage). Sized so
    this is 0 for realistic scenes; tests assert it.

    ``y_origin``/``full_height``/``bands`` check one horizontal BAND of
    a band-split render (``height`` = band height; ``bands`` feeds the
    band pool's skew-margin default, matching ``_fused_frame_fn``).
    Overflow beyond the ``giants`` capacity breaks the band/full-frame
    bit-equality contract — check every band of a custom pose/mesh
    combination here before trusting it.

    Diagnostic ONLY — it runs eagerly per call with jnp.sort/jnp.cumsum
    (not the production path's sort-carried tables / matmul prefix sums) and
    is meant for sizing/debugging, never inside a frame loop."""
    _, clip = _vertex_stage(jnp.asarray(displacement), jnp.asarray(positions),
                            jnp.asarray(uvs), jnp.asarray(view_proj))
    v_clip = clip[jnp.asarray(tris)]
    w = v_clip[..., 3]
    fully_front = jnp.all(w > 1e-6, axis=-1)

    def all_outside(c):
        return jnp.all(c < -w, axis=-1) | jnp.all(c > w, axis=-1)

    outside = (all_outside(v_clip[..., 0]) | all_outside(v_clip[..., 1])
               | all_outside(v_clip[..., 2]))
    w_safe = jnp.where(fully_front[:, None], w, 1.0)
    sx = (v_clip[..., 0] / w_safe * 0.5 + 0.5) * width
    sy = (v_clip[..., 1] / w_safe * 0.5 + 0.5) * (full_height or height)
    x0 = jnp.maximum(jnp.ceil(sx.min(-1) - 0.5), 0.0)
    x1 = jnp.minimum(jnp.floor(sx.max(-1) - 0.5), width - 1.0)
    y0 = jnp.maximum(jnp.ceil(sy.min(-1) - 0.5) - y_origin, 0.0)
    y1 = jnp.minimum(jnp.floor(sy.max(-1) - 0.5) - y_origin, height - 1.0)
    # slot units: 4x2-pixel OCT tiles of the clamped bbox (matches
    # _rasterize_pool's allocation exactly)
    qw = jnp.floor(x1 / 4) - jnp.floor(x0 / 4) + 1
    qh = jnp.floor(y1 / 2) - jnp.floor(y0 / 2) + 1
    area = jnp.where(fully_front & ~outside & (x1 >= x0) & (y1 >= y0),
                     qw * qh, 0.0)
    pool = pool or _auto_pool(width, height, bands)
    area_sorted = jnp.sort(area)
    cum = jnp.cumsum(area_sorted)
    overflow = int(jnp.sum((cum > pool) & (area_sorted > 0)))
    if return_demand:
        # total slot demand of the scene (``pool`` >= demand <=> overflow 0)
        return overflow, int(cum[-1])
    return overflow


@functools.partial(jax.jit,
                   static_argnames=("width", "height", "samples", "giants",
                                    "grid_shape", "frag_channel", "scales",
                                    "tiles"))
def _rasterize(displacement, positions, uvs, tris, view_proj, camera_pos,
               width: int, height: int, samples: int, giants: int = 512,
               interp=None, grid_shape=None, foam=None,
               frag_channel: int = 1, scales=(3.0, 3.5, 180.0, 0.0),
               tiles=None):
    world, clip = _vertex_stage(displacement, positions, uvs, view_proj,
                                interp, scales[0], scales[1], tiles)

    # Pad triangles to a chunk multiple; padding points at vertex 0 thrice
    # (degenerate -> rejected by the det/denom sign tests).
    t_count = tris.shape[0]
    tris_all = tris
    chunks = -(-t_count // _TRI_CHUNK)
    pad = chunks * _TRI_CHUNK - t_count
    tris = jnp.concatenate([tris, jnp.zeros((pad, 3), tris.dtype)], axis=0)
    tris = tris.reshape(chunks, _TRI_CHUNK, 3)

    budget = samples * samples   # scatter samples per triangle
    gk = jnp.arange(budget)
    spill = width * height  # one past the image: dropped updates

    def ndc_xy(cx, cy):
        return 2.0 * cx / width - 1.0, 2.0 * cy / height - 1.0

    id_bits = _id_bits(t_count)

    # --- pass 1+2: windowed scatter for fully-in-front triangles ----------
    # The ``budget`` samples per triangle snake row-major through the
    # triangle's own pixel bbox (not a fixed square), so any bbox of AREA
    # <= budget is fully covered — thin grazing slivers included. Bboxes
    # larger than the budget are the gather pass's job.
    #
    # Visibility is one packed-key scatter-min (``_pack_key``) — shared
    # with the pool impl so both resolve winners identically, ties
    # included; varyings AND exact depth are reconstructed once per
    # *pixel* at the end.
    def chunk_body(carry, chunk):
        keybuf = carry
        tri_chunk, tri_ids = chunk
        v_clip = clip[tri_chunk]          # (C, 3, 4)

        w = v_clip[..., 3]
        fully_front = jnp.all(w > 1e-6, axis=-1)  # else: gather pass owns it
        w_safe = jnp.where(fully_front[:, None], w, 1.0)
        sx = (v_clip[..., 0] / w_safe * 0.5 + 0.5) * width
        sy = (v_clip[..., 1] / w_safe * 0.5 + 0.5) * height

        # TIGHT pixel-center bbox (identical to the pool impl's): ceil
        # of (min - 0.5) .. floor of (max - 0.5). The earlier
        # floor(min)-anchored walk evaluated pixel centers an epsilon
        # OUTSIDE the projected extent, where the f32 edge test can
        # round to a hit the pool (correctly) never evaluates — measured
        # as 2/840000 spurious-coverage diffs at 1200x700.
        x_min = jnp.ceil(jnp.min(sx, axis=-1) - 0.5).astype(jnp.int32)
        y_min = jnp.ceil(jnp.min(sy, axis=-1) - 0.5).astype(jnp.int32)
        x_max = jnp.floor(jnp.max(sx, axis=-1) - 0.5).astype(jnp.int32)
        y_max = jnp.floor(jnp.max(sy, axis=-1) - 0.5).astype(jnp.int32)
        bw = (x_max - x_min + 1).clip(1)
        px = x_min[:, None] + gk[None] % bw[:, None]   # (C, K)
        py = y_min[:, None] + gk[None] // bw[:, None]
        on_screen = ((px >= 0) & (px < width) & (py >= 0) & (py < height)
                     & (px <= x_max[:, None]) & (py <= y_max[:, None]))
        pnx, pny = ndc_xy(px.astype(jnp.float32) + 0.5,
                          py.astype(jnp.float32) + 0.5)

        lam0, lam1, lam2, _ = _lambdas(v_clip, pnx, pny, 1)
        denom = lam0 + lam1 + lam2
        hit = ((lam0 >= 0) & (lam1 >= 0) & (lam2 >= 0) & (denom > 0))
        mask = hit & on_screen & fully_front[:, None]
        # z_ndc = z_clip(p) / w(p); both are linear varyings: sum(lam * .)
        lam_w = (lam0 * v_clip[:, None, 0, 3] + lam1 * v_clip[:, None, 1, 3]
                 + lam2 * v_clip[:, None, 2, 3])
        z = (lam0 * v_clip[:, None, 0, 2] + lam1 * v_clip[:, None, 1, 2]
             + lam2 * v_clip[:, None, 2, 2]) / jnp.where(lam_w == 0, 1.0,
                                                         lam_w)
        mask = mask & (z > -1.0) & (z < 1.0)
        ids = jnp.broadcast_to(tri_ids[:, None], mask.shape)
        key = _pack_key(z, ids, mask, id_bits)
        flat_ix = jnp.where(mask, py * width + px, spill)
        keybuf = keybuf.at[flat_ix.reshape(-1)].min(key.reshape(-1),
                                                    mode="drop")
        return keybuf, None

    all_ids = jnp.arange(chunks * _TRI_CHUNK,
                         dtype=jnp.int32).reshape(chunks, _TRI_CHUNK)
    init = jnp.full((spill,), _KEY_MAX, jnp.uint32)
    keybuf, _ = jax.lax.scan(chunk_body, init, (tris, all_ids))

    key_img = keybuf.reshape(height, width)

    # --- pass 3: gather for triangles the window cannot cover -------------
    # Need = screen bbox AREA above the sample budget, or any vertex
    # behind the eye plane (projected region unbounded — scored to the top
    # unconditionally). Lowering ``samples`` makes more triangles
    # qualify — raise ``giants`` with it.
    all_clip = clip[tris_all]                     # (T, 3, 4)
    aw = all_clip[..., 3]
    front = aw > 1e-6
    fully_front = jnp.all(front, axis=-1)
    crossing = jnp.any(front, axis=-1) & ~fully_front
    # Conservative frustum cull, valid for any w sign (clip-space plane
    # tests are linear): a triangle is invisible if all three vertices sit
    # outside the same frustum plane. Without this, the strip of triangles
    # straddling the camera *plane* — which spans the whole grid, mostly
    # far outside the view — would flood the gather ranking.
    def all_outside(c):
        return jnp.all(c < -aw, axis=-1) | jnp.all(c > aw, axis=-1)

    outside = (all_outside(all_clip[..., 0]) | all_outside(all_clip[..., 1])
               | all_outside(all_clip[..., 2]))
    aw_safe = jnp.where(fully_front[:, None], aw, 1.0)
    asx = (all_clip[..., 0] / aw_safe * 0.5 + 0.5) * width
    asy = (all_clip[..., 1] / aw_safe * 0.5 + 0.5) * height
    bbw = jnp.floor(asx.max(-1)) - jnp.floor(asx.min(-1)) + 1.0
    bbh = jnp.floor(asy.max(-1)) - jnp.floor(asy.min(-1)) + 1.0
    area = bbw * bbh
    overlaps = ((asx.max(-1) >= 0) & (asx.min(-1) < width)
                & (asy.max(-1) >= 0) & (asy.min(-1) < height))
    score = jnp.where(
        crossing & ~outside, jnp.inf,
        jnp.where(fully_front & ~outside & overlaps & (area > budget),
                  area, -1.0))
    key_img = _giant_pass(clip, tris_all, score, key_img, width, height,
                          giants, id_bits)
    dtab = _deferred_table(_edge_table(all_clip), world, tris_all, uvs,
                           grid_shape)
    img, z_img = _deferred_shade(displacement, dtab,
                                 key_img, camera_pos, width, height, id_bits,
                                 grid_shape, foam, frag_channel,
                                 scales[2], scales[3] if len(scales) > 3 else 0.0,
                                 tiles)
    return img, z_img


def _cascade_setup(displacement, cascade_domains, mesh_resolution: int):
    """(tiles, interp) for a plain field or a (C, N, N, 3) cascade stack.

    tiles[c] = domain[0] / domain[c] — how many times cascade c's physical
    domain repeats across the patch; interp is the matching per-cascade
    sampling-matrix tuple (``_interp_matrices``)."""
    n_tex = displacement.shape[-2]
    if displacement.ndim == 3:
        return None, _interp_matrices(mesh_resolution, n_tex)
    c_count = displacement.shape[0]
    if cascade_domains is None or len(cascade_domains) != c_count:
        raise ValueError(
            f"a (C, N, N, 3) cascade stack needs cascade_domains of "
            f"length {c_count}, got {cascade_domains!r}")
    tiles = tuple(float(cascade_domains[0] / d) for d in cascade_domains)
    interp = tuple(_interp_matrices(mesh_resolution, n_tex, t) for t in tiles)
    return tiles, interp


def render_frame(
    displacement: jnp.ndarray,
    camera: Camera,
    width: int = 300,
    height: int = 175,
    mesh_resolution: int = 128,
    num_patches: int = 4,
    samples: int = 16,
    giants: int = 512,
    return_depth: bool = False,
    impl: str = "pool",
    pool: int | None = None,
    foam: jnp.ndarray | None = None,
    frag_normal_x: bool = False,
    height_div: float = 3.0,
    horiz_div: float = 3.5,
    normal_height_scale: float = 180.0,
    pbr_roughness: float = 0.0,
    cascade_domains=None,
):
    """Render one frame from a displacement map along a camera.

    Args:
        displacement: (N, N, 3) field from ``step()`` (raw, unscaled — the
            /3.0 and /3.5 visual scales of ``ocean.vert:22-23`` are applied
            here, in the vertex stage) — or a (C, N, N, 3) CASCADE STACK,
            composited as the sum of per-cascade fields, cascade c tiled
            ``cascade_domains[0] / cascade_domains[c]`` times across the
            patch (``OceanConfig.domains``; beyond the reference).
        cascade_domains: per-cascade physical domain sizes; required shape
            C when ``displacement`` is a cascade stack. ``foam`` then takes
            the (C, N, N) per-cascade masks (coverage union).
        camera: a ``render.camera.Camera`` (numpy, host-side).
        foam: optional (N, N) whitecap coverage mask mixed into the albedo
            (``shade.shade_fragments``) — an extension beyond the
            reference's fragment shader; None renders reference-faithful.
        frag_normal_x: Q8 compat — tap the disp_x channel for the normal
            map, bit-matching the reference's ``.x`` taps
            (``config.CompatFlags.frag_normal_x``); default taps height.
        height_div / horiz_div / normal_height_scale: the GLSL visual
            scales (``ocean.vert:22-23`` /3.0 and /3.5,
            ``ocean.frag:19`` height_scale=180) — the same-named
            ``OceanConfig`` fields; defaults are the reference literals.
        pbr_roughness: > 0 enables the opt-in Cook-Torrance specular lobe
            built from the reference's unused GGX helpers
            (``shade.shade_fragments``); 0 (default) is reference-faithful.
        impl: "pool" (fast exact-area path, default) or "window" (the
            fixed-budget golden path; honors ``samples``).
        pool: sample-slot pool size for impl="pool" (default: sized from
            the viewport, ``_auto_pool``); must exceed the scene's total
            clamped-bbox area minus what ``giants`` can absorb (see
            ``pool_overflow``).
    Returns:
        (H, W, 3) float32 image (plus the depth buffer if requested).
    """
    positions, uvs, tris = _mesh_constants(mesh_resolution, num_patches)
    displacement = jnp.asarray(displacement)
    tiles, interp = _cascade_setup(displacement, cascade_domains,
                                   mesh_resolution)
    proj = perspective(width / height)
    view_proj = jnp.asarray((proj @ camera.view()).astype(np.float32))
    args = (displacement, positions, uvs, tris, view_proj,
            jnp.asarray(camera.position.astype(np.float32)))
    foam_dev = None if foam is None else jnp.asarray(foam)
    chan = 0 if frag_normal_x else 1
    scales = (float(height_div), float(horiz_div), float(normal_height_scale),
              float(pbr_roughness))
    if impl == "pool":
        img, depth = _rasterize_pool(*args, width, height,
                                     pool or _auto_pool(width, height),
                                     giants, interp,
                                     (num_patches, mesh_resolution), foam_dev,
                                     chan, scales, tiles)
    elif impl == "window":
        img, depth = _rasterize(*args, width, height, samples, giants,
                                interp, (num_patches, mesh_resolution),
                                foam_dev, chan, scales, tiles)
    else:
        raise ValueError(f"impl must be 'pool' or 'window', got {impl!r}")
    if return_depth:
        return img, depth
    return img


def make_frame_renderer(
    config,
    width: int = 480,
    height: int = 280,
    giants: int = 512,
    pool: int | None = None,
    diag: bool = False,
):
    """One-dispatch interactive frame pipeline: step -> rasterize -> sRGB.

    Fusing the sim step and the renderer into one jit removes the
    displacement download + re-upload (N^2 x 3 f32) and one dispatch, and
    returning sRGB uint8 shrinks the frame transfer 4x vs f32. This is the analog of the reference's
    single command-buffer submission per frame (``src/render.rs:1122-1372``
    records compute + draw into ONE submission).

    Returns ``fn(state, t, view_proj, camera_pos) -> (H, W, 3) uint8``
    where ``view_proj`` is the f32 (4, 4) projection @ view matrix
    (host-computed, as ``render_frame`` does). With ``diag=True`` the
    function instead returns ``(frame, dropped)`` where ``dropped`` is
    the in-graph count of giant-pass candidates past capacity (must be 0
    for the exact-coverage contract; surfaced in serve ``/metrics``).
    """
    return jax.jit(_fused_frame_fn(config, width, height, giants, pool,
                                   diag=diag))


def _fused_frame_fn(config, width: int, height: int, giants: int,
                    pool: int | None, band_axis: str | None = None,
                    n_bands: int = 1, diag: bool = False):
    """The unjitted fused step -> rasterize -> sRGB body shared by the
    interactive renderer (``make_frame_renderer``), the batched CLI
    renderer (``make_batch_renderer``), and — with ``band_axis`` set —
    the multi-chip band renderers (``parallel/render.py``), where each
    device rasterizes the ``height // n_bands``-row horizontal band
    selected by ``jax.lax.axis_index(band_axis)``. Band pixels sample
    f32-identical NDC centers to the full frame, so the single- and
    multi-chip outputs are BIT-equal by construction."""
    import dataclasses  # noqa: PLC0415

    from gfx_ocean_tpu.models.ocean import step as _ocean_step  # noqa: PLC0415

    if band_axis is not None and height % n_bands:
        raise ValueError(
            f"height {height} must divide into mesh axis {band_axis!r} "
            f"({n_bands} bands); pad the viewport or re-shape the mesh")
    band_h = height // n_bands if band_axis is not None else height
    # The rasterizer derives fragment normals from the displacement
    # texture itself (shade.fragment_normals); the sim step's vertex
    # normals are dead weight in this pipeline.
    config = dataclasses.replace(config, compute_normals=False)
    positions, uvs, tris = _mesh_constants(config.mesh_resolution,
                                           config.num_patches)
    if config.num_cascades > 1:
        tiles = tuple(float(config.domains[0] / d) for d in config.domains)
        interp = tuple(_interp_matrices(config.mesh_resolution,
                                        config.resolution, t) for t in tiles)
    else:
        tiles = None
        interp = _interp_matrices(config.mesh_resolution, config.resolution)

    def fn(state, t, view_proj, camera_pos):
        fields = _ocean_step(state, t, config)
        foam = fields.foam if config.compute_foam else None
        y0 = (0 if band_axis is None
              else jax.lax.axis_index(band_axis) * band_h)
        out = _rasterize_pool(fields.displacement, positions, uvs, tris,
                              view_proj, camera_pos, width, band_h,
                              pool or _auto_pool(width, band_h, n_bands),
                              giants,
                              interp,
                              (config.num_patches, config.mesh_resolution),
                              foam,
                              0 if config.compat.frag_normal_x else 1,
                              (float(config.height_div),
                               float(config.horiz_div),
                               float(config.normal_height_scale),
                               float(config.pbr_roughness)),
                              tiles, y_origin=y0, full_height=height,
                              with_diag=diag)
        img = out[0]
        # sRGB encode on device (matches the host-side conversion in
        # serve.py / cli.py render: gamma 1/2.2, truncating cast).
        srgb = (jnp.clip(img, 0.0, 1.0) ** (1.0 / 2.2) * 255.0
                ).astype(jnp.uint8)
        if diag:
            return srgb, out[2]          # (frame, dropped-giants tripwire)
        return srgb

    return fn


def make_batch_renderer(
    config,
    width: int,
    height: int,
    giants: int = 512,
    pool: int | None = None,
):
    """Batched fused pipeline: ``fn(state, ts, view_projs, camera_pos) ->
    (F, H, W, 3) uint8`` — an UNROLLED loop of single-frame bodies inside
    one jit (specialized per frame count). This is what ``cli.py render``
    chunks over and what serve's /session/strip.jpg dispatches: one
    dispatch + ONE uint8 transfer per chunk instead of one per frame (the
    sim is stateless in time, so frames are independent and batch freely
    — SURVEY.md §2.5 task parallelism).

    NOT a vmap: under vmap the rasterizer's dynamic-trip ``while_loop``
    (the inert giant pass) runs every frame to the longest trip count and
    the scatters grow a batch dimension. Unrolled, every frame lowers
    exactly like the single-frame program."""
    one = _fused_frame_fn(config, width, height, giants, pool)

    def strip(state, ts, view_projs, camera_pos):
        return jnp.stack([one(state, ts[i], view_projs[i], camera_pos[i])
                          for i in range(ts.shape[0])])

    return jax.jit(strip)


def render_frames(
    displacements: jnp.ndarray,
    cameras,
    width: int = 300,
    height: int = 175,
    mesh_resolution: int = 128,
    num_patches: int = 4,
    samples: int = 16,
    giants: int = 512,
    impl: str = "pool",
    pool: int | None = None,
) -> jnp.ndarray:
    """Batched frame generation (BASELINE config 5): vmap the rasterizer
    over per-frame displacement maps and cameras.

    Args:
        displacements: (F, N, N, 3) fields (e.g. a ``make_rollout(...,
            keep_fields=True)`` trajectory).
        cameras: sequence of F ``Camera``s (host-side; their matrices are
            stacked and shipped once).
    Returns:
        (F, H, W, 3) float32 images.
    """
    positions, uvs, tris = _mesh_constants(mesh_resolution, num_patches)
    interp = _interp_matrices(mesh_resolution, displacements.shape[-2])
    proj = perspective(width / height)
    view_projs = np.stack([(proj @ c.view()).astype(np.float32) for c in cameras])
    cam_pos = np.stack([c.position.astype(np.float32) for c in cameras])

    if impl == "pool":
        pool = pool or _auto_pool(width, height)

        def one(d, vp, cp):
            return _rasterize_pool(d, positions, uvs, tris, vp, cp,
                                   width, height, pool, giants, interp,
                                   (num_patches, mesh_resolution))[0]
    else:
        def one(d, vp, cp):
            return _rasterize(d, positions, uvs, tris, vp, cp,
                              width, height, samples, giants, interp,
                              (num_patches, mesh_resolution))[0]
    f = jax.vmap(one)
    return f(jnp.asarray(displacements), jnp.asarray(view_projs),
             jnp.asarray(cam_pos))

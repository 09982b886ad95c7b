"""Frame server: the deployment surface of the engine.

The reference is a windowed demo; the production analog of "present a
frame" is serving computed fields over HTTP. A deliberately dependency-free
stdlib server (ThreadingHTTPServer) wraps one jitted ``step``:

    GET /health            -> {"status": "ok", "device": ...}
    GET /config            -> the OceanConfig as JSON
    GET /frame?t=12.5      -> .npz of (displacement[, normals][, foam])
    GET /frame.png?t=12.5  -> rendered PNG along the default camera
                              (stdlib zlib encoder; no extra packages)
    GET /frame.jpg?t=12.5  -> same, JPEG (needs the optional ``png`` extra,
                              Pillow; 501 without it)
                              (&w=&h=&samples= override the viewport;
                              &px=&py=&pz=&rx=&ry=&rz= override the pose)
    GET /metrics           -> frames served, error count, latency EMA
                              (the reference's title-bar EMA, src/lib.rs:146-148)

Computation is serialized behind a lock (one device executable, in-order
device queue); the threaded server still overlaps request parsing and
response IO. The sim being stateless in time, every request is
independently addressable by absolute ``t`` — a cache-friendly,
horizontally scalable design: replicas need only (h0, omega).

An interactive session — the analog of the reference's winit window +
event loop (src/lib.rs:42-157) — layers a server-side ``Camera`` over the
stateless engine; the browser is the window and only forwards raw events:

    GET /                     -> HTML viewer (keyboard + touch -> /session/*)
    GET /session/input?press=w | release=left | touch=started&x=&width=
                              -> reference key/touch semantics (camera.py)
    GET /session/frame.png    -> advance camera+clock by dt (wall-clock, or
                              &dt= for determinism), render current pose
    GET /session/frame.jpg    -> same, JPEG
    GET /session/strip.jpg?n= -> advance n sub-frames and render them in ONE
                              batched dispatch, returned as one vertically
                              stacked JPEG (the viewer's format: one
                              request per n frames)
    GET /session/state        -> pose, sim time, frame-time EMA (title bar)
"""

from __future__ import annotations

import io
import json
import struct
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from gfx_ocean_tpu.config import OceanConfig
from gfx_ocean_tpu.models.ocean import OceanState, make_step
from gfx_ocean_tpu.utils.profiling import Ema

# Largest viewport served by the fused one-dispatch pipeline (1280x720).
# Anything bigger falls back to the f32 render_frame path: a hostile
# w=h=2048 request would otherwise force a multi-second compile AND pin a
# 2^23-slot pool buffer per cache entry.
_FUSED_MAX_AREA = 1280 * 720

# The viewport the start-up warm-up compiles (the browser viewer's canvas).
_WARM_VIEWPORT = (960, 540)


class MissingExtra(RuntimeError):
    """An endpoint needs an optional package that is not installed."""


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes with the standard library alone
    (8-bit truecolor, filter 0 on every row, one zlib IDAT chunk at the
    fastest compression level: the encode runs on every served frame)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got {rgb.shape}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)],
                         axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1))
            + chunk(b"IEND", b""))


def encode_jpeg(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> JPEG bytes through Pillow (the ``png`` extra)."""
    try:
        from PIL import Image  # noqa: PLC0415
    except ImportError as e:
        raise MissingExtra(
            "JPEG encoding needs Pillow: install the 'png' extra "
            "(pip install 'gfx-ocean-tpu[png]') or request the .png "
            "endpoint") from e
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG", quality=88)
    return buf.getvalue()


class FrameService:
    """Engine wrapper: jitted step + serialization + metrics."""

    def __init__(self, state: OceanState, config: OceanConfig, mesh=None,
                 sharded_fft: str = "gspmd"):
        import dataclasses

        self.state = state
        self.config = config
        self.config_json = json.dumps(dataclasses.asdict(config))
        self.mesh = mesh
        if mesh is not None:
            from gfx_ocean_tpu.parallel.sharding import (  # noqa: PLC0415
                make_sharded_step)

            self._step = make_sharded_step(config, mesh, batched=False,
                                           fft=sharded_fft)
            # The band renderers take a REPLICATED state (in_specs P());
            # feeding them the row-sharded simulation state would make
            # XLA all_gather h0/omega on EVERY frame dispatch. Replicate
            # once here instead — the state never changes between frames.
            import jax  # noqa: PLC0415
            from jax.sharding import NamedSharding, PartitionSpec  # noqa: PLC0415

            self._render_state = jax.device_put(
                state, NamedSharding(mesh, PartitionSpec()))
        else:
            self._step = make_step(config)
            self._render_state = state
        self._lock = threading.Lock()
        self._meter_lock = threading.Lock()   # counters/EMA: cheap, atomic
        # (w, h, giants) -> fused step+render+sRGB jit. Bounded: the key
        # is client-controlled, and each miss compiles a device executable
        # (seconds) and pins device buffers — evict the
        # least-recently-USED beyond a handful of live viewports, cap the
        # fused viewport area (_FUSED_MAX_AREA; bigger falls back to the
        # f32 render_frame path), and compile OUTSIDE the dispatch lock
        # under a per-key build lock so a new viewport's multi-second
        # compile never stalls other clients' frames.
        import collections

        self._renderers = collections.OrderedDict()
        self._renderers_max = 6
        self._builds = {}            # key -> per-key build lock
        self._cache_lock = threading.Lock()  # guards the two dicts above
        self.session = CameraSession()  # defined below; resolved at call time
        self.frames_served = 0
        self.errors = 0
        self.latency_ema = Ema()
        # Coverage-contract tripwire (raster._rasterize_pool with_diag):
        # giant-pass candidates dropped past capacity, per frame. Any
        # nonzero means the served frame may have lost exact coverage
        # (and, under --mesh, band/single-chip bit-equality).
        self.giant_dropped_last = 0
        self.giant_dropped_max = 0

    def fields(self, t: float):
        import jax.numpy as jnp

        t0 = time.perf_counter()
        with self._lock:
            out = self._step(self.state, jnp.float32(t))
            arrays = {"displacement": np.asarray(out.displacement), "t": np.float64(t)}
            if out.normals is not None:
                arrays["normals"] = np.asarray(out.normals)
            if out.foam is not None:
                arrays["foam"] = np.asarray(out.foam)
        with self._meter_lock:
            self.latency_ema.update(time.perf_counter() - t0)
            self.frames_served += 1
        return arrays

    def _renderer(self, key):
        """Fused-renderer cache: LRU on hit; on miss, build + warm up the
        executable under a PER-KEY lock (other keys' frames keep flowing
        through ``self._lock`` while this one compiles — JAX dispatch is
        thread-safe and the device queue is in-order, so the warmup call
        simply queues behind them)."""
        import jax.numpy as jnp  # noqa: PLC0415

        from gfx_ocean_tpu.render.camera import Camera, perspective  # noqa: PLC0415
        from gfx_ocean_tpu.render.raster import make_frame_renderer  # noqa: PLC0415

        while True:
            with self._cache_lock:
                fn = self._renderers.get(key)
                if fn is not None:
                    self._renderers.move_to_end(key)
                    return fn
                build = self._builds.get(key)
                if build is None:
                    build = self._builds[key] = threading.Lock()
                    build.acquire()      # we are the builder
                    building = True
                else:
                    building = False
            if not building:
                with build:              # wait for the builder, then re-check
                    continue
            try:
                width, height, giants = key[:3]
                batch = key[3] if len(key) == 4 else None
                if batch is not None:
                    # n-frame strip renderer: ONE dispatch + ONE transfer
                    # for n frames.
                    if self.mesh is not None:
                        from gfx_ocean_tpu.parallel.render import (  # noqa: PLC0415
                            make_sharded_batch_renderer)

                        fn = make_sharded_batch_renderer(
                            self.config, self.mesh, width=width,
                            height=height, giants=giants)
                    else:
                        from gfx_ocean_tpu.render.raster import (  # noqa: PLC0415
                            make_batch_renderer)

                        fn = make_batch_renderer(self.config, width=width,
                                                 height=height, giants=giants)
                elif self.mesh is not None:
                    # Band-parallel: each device rasterizes a horizontal
                    # band of the viewport (bit-equal to single-chip —
                    # parallel/render.py).
                    from gfx_ocean_tpu.parallel.render import (  # noqa: PLC0415
                        make_sharded_frame_renderer)

                    fn = make_sharded_frame_renderer(
                        self.config, self.mesh, width=width, height=height,
                        giants=giants, diag=True)
                else:
                    fn = make_frame_renderer(self.config, width=width,
                                             height=height, giants=giants,
                                             diag=True)
                cam = Camera()
                vp = (perspective(width / height) @ cam.view()).astype(
                    np.float32)
                if batch is not None:
                    fn(self._render_state,
                       jnp.zeros((batch,), jnp.float32),
                       jnp.asarray(np.stack([vp] * batch)),
                       jnp.asarray(np.stack(
                           [cam.position.astype(np.float32)] * batch)))
                else:
                    fn(self._render_state, jnp.float32(0.0), jnp.asarray(vp),
                       jnp.asarray(cam.position.astype(np.float32)))  # compile
                with self._cache_lock:
                    while len(self._renderers) >= self._renderers_max:
                        self._renderers.popitem(last=False)
                    self._renderers[key] = fn
                return fn
            finally:
                with self._cache_lock:
                    self._builds.pop(key, None)
                build.release()

    def fused_ok(self, width: int, height: int) -> bool:
        """Whether a viewport takes the fused one-dispatch pipeline."""
        return width * height <= _FUSED_MAX_AREA and (
            self.mesh is None or height % self.mesh.shape["row"] == 0)

    def record_error(self) -> None:
        with self._meter_lock:
            self.errors += 1

    def frame_npz(self, t: float) -> bytes:
        buf = io.BytesIO()
        np.savez(buf, **self.fields(t))
        return buf.getvalue()

    def frame_png(self, t: float, width: int, height: int, samples: int,
                  camera=None, giants: int = 512,
                  fmt: str = "PNG") -> bytes:
        """One rendered frame, PNG (stdlib) or JPEG (Pillow) encoded."""
        from gfx_ocean_tpu.render.camera import Camera, perspective  # noqa: PLC0415

        camera = camera if camera is not None else Camera()
        if self.fused_ok(width, height):
            # Fast path: ONE fused dispatch (step -> rasterize -> sRGB on
            # device) — the analog of the reference's single per-frame
            # command-buffer submission (src/render.rs:1122-1372).
            import jax  # noqa: PLC0415
            import jax.numpy as jnp  # noqa: PLC0415

            key = (width, height, giants)
            t0 = time.perf_counter()
            fn = self._renderer(key)
            with self._lock:
                view_proj = (perspective(width / height)
                             @ camera.view()).astype(np.float32)
                srgb_dev, dropped_dev = fn(
                    self._render_state, jnp.float32(t),
                    jnp.asarray(view_proj),
                    jnp.asarray(camera.position.astype(np.float32)))
            # Transfer OUTSIDE the lock: jax dispatch is async and the
            # device queue is in-order, so the next request's compute
            # overlaps this frame's download (the viewer keeps two frames
            # in flight to exploit this). One device_get for frame AND
            # tripwire counter.
            srgb, dropped_arr = jax.device_get((srgb_dev, dropped_dev))
            dropped = int(np.max(dropped_arr))
            with self._meter_lock:
                self.latency_ema.update(time.perf_counter() - t0)
                self.frames_served += 1
                self.giant_dropped_last = dropped
                self.giant_dropped_max = max(self.giant_dropped_max, dropped)
        else:
            from gfx_ocean_tpu.render import render_frame  # noqa: PLC0415

            arrays = self.fields(t)
            img = np.asarray(render_frame(
                arrays["displacement"], camera, width=width, height=height,
                mesh_resolution=self.config.mesh_resolution,
                num_patches=self.config.num_patches, samples=samples,
                giants=giants, foam=arrays.get("foam"),
                frag_normal_x=self.config.compat.frag_normal_x,
                height_div=self.config.height_div,
                horiz_div=self.config.horiz_div,
                normal_height_scale=self.config.normal_height_scale,
                pbr_roughness=self.config.pbr_roughness,
                cascade_domains=(self.config.domains
                                 if self.config.num_cascades > 1 else None)))
            srgb = (np.clip(img, 0.0, 1.0) ** (1 / 2.2) * 255).astype(np.uint8)
        if fmt.upper() in ("JPEG", "JPG"):
            return encode_jpeg(srgb)
        return encode_png(srgb)

    def strip_jpg(self, times, cameras, width: int, height: int,
                  giants: int = 512) -> bytes:
        """n session frames in ONE dispatch + ONE transfer, stacked
        vertically into a single JPEG (the viewer slices it back apart).

        One HTTP round trip and one dispatch per n frames, while the
        server-side camera integrates held keys over n sub-frame ticks —
        same trajectory as n single frames (src/lib.rs:139-148
        semantics). The strip renderer has no coverage tripwire (diag
        rides the single-frame path only).
        """
        import jax  # noqa: PLC0415
        import jax.numpy as jnp  # noqa: PLC0415

        from gfx_ocean_tpu.render.camera import perspective  # noqa: PLC0415

        n = len(times)
        t0 = time.perf_counter()
        fn = self._renderer((width, height, giants, n))
        proj = perspective(width / height)
        vps = np.stack([(proj @ c.view()).astype(np.float32)
                        for c in cameras])
        cps = np.stack([c.position.astype(np.float32) for c in cameras])
        with self._lock:
            frames_dev = fn(self._render_state,
                            jnp.asarray(np.asarray(times, np.float32)),
                            jnp.asarray(vps), jnp.asarray(cps))
        frames = jax.device_get(frames_dev)   # (n, H, W, 3) uint8
        with self._meter_lock:
            self.latency_ema.update((time.perf_counter() - t0) / n)
            self.frames_served += n
        return encode_jpeg(np.concatenate(list(frames), axis=0))

    def metrics(self) -> dict:
        import jax

        return {
            "frames_served": self.frames_served,
            "errors": self.errors,
            "giant_dropped_last": self.giant_dropped_last,
            "giant_dropped_max": self.giant_dropped_max,
            "latency_ema_sec": round(self.latency_ema.value, 6),
            "device": str(jax.devices()[0]),
            "resolution": self.config.resolution,
            "mesh": (None if self.mesh is None else
                     dict(zip(self.mesh.axis_names, self.mesh.devices.shape))),
        }


class CameraSession:
    """Server-side analog of the reference's app loop (src/lib.rs:42-157).

    Holds a ``Camera`` + ``InputState`` + a sim clock. Each rendered frame
    advances both by dt — wall-clock by default, exactly like the
    reference's ``Instant``-based elapsed time (src/lib.rs:139-142) — and
    feeds the frame-time EMA the reference shows in its title bar
    (src/lib.rs:146-148). Input events use the reference's key/touch
    semantics verbatim (render/camera.py).
    """

    def __init__(self):
        from gfx_ocean_tpu.render.camera import Camera  # noqa: PLC0415

        self.camera = Camera()
        self.sim_time = 0.0
        self.frame_ema = Ema()
        self._last = None  # wall-clock of the previous frame
        self._lock = threading.Lock()

    def input(self, action: str, value: str, x: float = 0.0,
              width: float = 1.0) -> None:
        with self._lock:
            if action == "press":
                self.camera.input.press(value)
            elif action == "release":
                self.camera.input.release(value)
            elif action == "touch":
                self.camera.input.touch(value, x, width)
            else:
                raise ValueError(f"unknown input action {action!r}")

    def advance(self, dt: Optional[float] = None):
        """Tick the loop: returns (sim time, camera snapshot) to render."""
        import dataclasses  # noqa: PLC0415

        with self._lock:
            now = time.perf_counter()
            if dt is None:
                dt = 0.0 if self._last is None else min(now - self._last, 0.25)
            self._last = now
            self.camera.update(dt)
            self.sim_time += dt
            self.frame_ema.update(dt)
            # Snapshot so the render (outside the lock) can't see a
            # concurrent input/advance mutate the pose mid-frame.
            snap = dataclasses.replace(self.camera,
                                       position=self.camera.position.copy(),
                                       rotation=self.camera.rotation.copy())
            return self.sim_time, snap

    def advance_batch(self, n: int, dt: Optional[float] = None):
        """Tick the loop n sub-frames for a strip render: the wall-clock
        (or explicit) dt is split evenly and the camera integrates held
        keys across the sub-ticks exactly as n single ``advance`` calls
        with dt/n would. Returns [(sim time, camera snapshot), ...]."""
        import dataclasses  # noqa: PLC0415

        with self._lock:
            now = time.perf_counter()
            if dt is None:
                dt = 0.0 if self._last is None else min(now - self._last, 0.25)
            self._last = now
            sub = dt / n
            out = []
            for _ in range(n):
                self.camera.update(sub)
                self.sim_time += sub
                self.frame_ema.update(sub)
                out.append((self.sim_time, dataclasses.replace(
                    self.camera,
                    position=self.camera.position.copy(),
                    rotation=self.camera.rotation.copy())))
            return out

    def state(self) -> dict:
        with self._lock:
            return {
                "position": [round(float(v), 4) for v in self.camera.position],
                "rotation": [round(float(v), 4) for v in self.camera.rotation],
                "sim_time": round(self.sim_time, 4),
                "frame_ema_sec": round(self.frame_ema.value, 6),
                "fps": (round(1.0 / self.frame_ema.value, 2)
                        if self.frame_ema.value > 0 else None),
                "input": {"forward": self.camera.input.forward,
                          "rot_x": self.camera.input.rot_x,
                          "rot_y": self.camera.input.rot_y},
            }


# The browser stands in for the winit window: it forwards raw key/touch
# events and displays frames; every piece of camera/timing logic stays
# server-side in the tested Python port of src/camera.rs.
_VIEWER_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>gfx_ocean_tpu</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
 body { margin:0; background:#111; color:#ccc; font:13px monospace;
        display:flex; flex-direction:column; align-items:center }
 canvas { width:100%; max-width:960px; image-rendering:auto; margin-top:8px }
 #hud { padding:6px }
</style></head><body>
<canvas id="v" width="960" height="540"></canvas>
<div id="hud">connecting…</div>
<script>
const v = document.getElementById('v'), hud = document.getElementById('hud');
const ctx = v.getContext('2d');
const KEYS = {KeyW:'w', KeyS:'s', ArrowLeft:'left', ArrowRight:'right',
              ArrowUp:'up', ArrowDown:'down'};
const held = new Set();
function send(q) { fetch('/session/input?' + q); }
addEventListener('keydown', e => {
  const k = KEYS[e.code];
  if (k && !held.has(k)) { held.add(k); send('press=' + k); e.preventDefault(); }
});
addEventListener('keyup', e => {
  const k = KEYS[e.code];
  if (k) { held.delete(k); send('release=' + k); e.preventDefault(); }
});
v.addEventListener('touchstart', e => {
  const r = v.getBoundingClientRect();
  send('touch=started&x=' + (e.touches[0].clientX - r.left) + '&width=' + r.width);
}, {passive: true});
addEventListener('touchend', () => send('touch=ended'), {passive: true});
let ema = null;
// Strip mode: each request renders STRIP frames in ONE device dispatch
// + ONE transfer (a vertically stacked JPEG the canvas slices); two
// strips stay in flight so the next strip renders while this one
// presents.
// Drop to ?w=480&h=280 on a slow link.
const STRIP = 4, W = 960, H = 540;
const sleep = ms => new Promise(r => setTimeout(r, ms));
const grab = () => fetch('/session/strip.jpg?w=' + W + '&h=' + H +
                         '&n=' + STRIP)
  .then(r => r.blob());
// Two strips in flight, sub-frames presented in order and paced over the
// measured strip interval: the server renders strip n+1 while strip n's
// pixels download and present.
async function loop() {
  let next = grab();
  let last = performance.now();
  for (;;) {
    const cur = next;
    next = grab();
    try {
      const bmp = await createImageBitmap(await cur);
      const now = performance.now();
      const ms = now - last;
      last = now;
      ema = ema === null ? ms : ema * 0.9 + ms * 0.1;   // src/lib.rs:146-148
      const per = ema / STRIP;
      hud.textContent = 'Ocean: ' + per.toFixed(2) + 'ms (' +
        (1000 / per).toFixed(1) + ' fps)  (W/S move, arrows look, touch to yaw)';
      for (let i = 0; i < STRIP; i++) {
        ctx.drawImage(bmp, 0, i * H, W, H, 0, 0, W, H);
        if (i < STRIP - 1) await sleep(per);
      }
      bmp.close();
    } catch (e) { hud.textContent = 'error: ' + e; await sleep(250); }
    await new Promise(requestAnimationFrame);
  }
}
loop();
</script></body></html>"""


def _viewport(q) -> tuple:
    w = int(q.get("w", ["300"])[0])
    h = int(q.get("h", ["175"])[0])
    s = int(q.get("samples", ["16"])[0])
    g = int(q.get("giants", ["512"])[0])
    if not (16 <= w <= 2048 and 16 <= h <= 2048 and 4 <= s <= 128
            and 32 <= g <= 4096):
        raise ValueError("viewport out of range")
    return w, h, s, g


def _make_handler(service: FrameService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet; metrics cover observability
            pass

        def _send(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):  # noqa: N802
            try:
                url = urlparse(self.path)
                q = parse_qs(url.query)
                if url.path == "/health":
                    import jax

                    dev = jax.devices()[0]
                    self._json(200, {"status": "ok", "device": str(dev),
                                     "platform": dev.platform,
                                     "device_kind": dev.device_kind})
                elif url.path == "/config":
                    self._send(200, service.config_json.encode(), "application/json")
                elif url.path == "/metrics":
                    self._json(200, service.metrics())
                elif url.path == "/frame":
                    t = float(q.get("t", ["0"])[0])
                    self._send(200, service.frame_npz(t), "application/octet-stream")
                elif url.path in ("/frame.png", "/frame.jpg"):
                    t = float(q.get("t", ["0"])[0])
                    fmt = "JPEG" if url.path.endswith(".jpg") else "PNG"
                    w, h, s, g = _viewport(q)
                    camera = None
                    if any(k in q for k in ("px", "py", "pz", "rx", "ry", "rz")):
                        from gfx_ocean_tpu.render.camera import (  # noqa: PLC0415
                            DEFAULT_POSITION, DEFAULT_ROTATION, Camera)

                        camera = Camera()
                        camera.position = np.array(
                            [float(q.get(k, [d])[0]) for k, d in
                             zip(("px", "py", "pz"), DEFAULT_POSITION)])
                        camera.rotation = np.array(
                            [float(q.get(k, [d])[0]) for k, d in
                             zip(("rx", "ry", "rz"), DEFAULT_ROTATION)])
                    self._send(200, service.frame_png(t, w, h, s, camera,
                                                      giants=g, fmt=fmt),
                               f"image/{fmt.lower()}")
                elif url.path == "/":
                    self._send(200, _VIEWER_HTML.encode(), "text/html")
                elif url.path == "/session/input":
                    if "press" in q:
                        service.session.input("press", q["press"][0])
                    elif "release" in q:
                        service.session.input("release", q["release"][0])
                    elif "touch" in q:
                        service.session.input(
                            "touch", q["touch"][0],
                            x=float(q.get("x", ["0"])[0]),
                            width=float(q.get("width", ["1"])[0]))
                    else:
                        raise ValueError("need press=, release=, or touch=")
                    self._json(200, {"ok": True})
                elif url.path in ("/session/frame.png", "/session/frame.jpg"):
                    fmt = "JPEG" if url.path.endswith(".jpg") else "PNG"
                    w, h, s, g = _viewport(q)
                    dt = float(q["dt"][0]) if "dt" in q else None
                    t, cam = service.session.advance(dt)
                    self._send(200, service.frame_png(t, w, h, s, cam,
                                                      giants=g, fmt=fmt),
                               f"image/{fmt.lower()}")
                elif url.path == "/session/strip.jpg":
                    w, h, _, g = _viewport(q)
                    n = int(q.get("n", ["4"])[0])
                    if not 2 <= n <= 16:
                        raise ValueError("strip n out of range [2, 16]")
                    if w * h > _FUSED_MAX_AREA:
                        raise ValueError(
                            "strip viewport exceeds the fused-path area cap")
                    if service.mesh is not None:
                        n_fp = dict(zip(service.mesh.axis_names,
                                        service.mesh.devices.shape)
                                    ).get("batch", 1)
                        if n % n_fp:
                            raise ValueError(
                                f"strip n={n} must divide by the mesh "
                                f"batch axis ({n_fp})")
                    dt = float(q["dt"][0]) if "dt" in q else None
                    ticks = service.session.advance_batch(n, dt)
                    self._send(200, service.strip_jpg(
                        [t for t, _ in ticks], [c for _, c in ticks],
                        w, h, giants=g), "image/jpeg")
                elif url.path == "/session/state":
                    self._json(200, service.session.state())
                else:
                    self._json(404, {"error": f"no route {url.path}"})
            except (ValueError, KeyError) as e:
                service.record_error()
                self._json(400, {"error": str(e)})
            except MissingExtra as e:
                self._json(501, {"error": str(e)})
            except Exception as e:  # noqa: BLE001
                service.record_error()
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(state: OceanState, config: OceanConfig, host: str = "127.0.0.1",
          port: int = 8807, mesh=None,
          sharded_fft: str = "gspmd") -> ThreadingHTTPServer:
    """Start the frame server (returns it; call ``serve_forever`` or use
    the CLI which does). The step and the fused frame renderer at the
    viewer's viewport are compiled and run once first, so the first
    requests do not pay the jit compile and a broken frame path fails
    here instead of in a "healthy" server. With ``mesh`` the step runs
    row-sharded across the mesh (fields gather to host for
    serialization)."""
    service = FrameService(state, config, mesh=mesh, sharded_fft=sharded_fft)
    service.fields(0.0)  # warmup: compile + first transfer
    if service.fused_ok(*_WARM_VIEWPORT):
        service._renderer((*_WARM_VIEWPORT, 512))  # giants: handler default
    server = ThreadingHTTPServer((host, port), _make_handler(service))
    server.service = service  # for tests/metrics access
    return server

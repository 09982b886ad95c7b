"""Frame server: routes, payloads, error paths (the serving surface)."""

import io
import json
import threading
import urllib.request
import urllib.error

import numpy as np
import pytest

pytest.importorskip("PIL", reason="the JPEG endpoints need Pillow")

import gfx_ocean_tpu as ot
from gfx_ocean_tpu.models.ocean import downsample_state
from gfx_ocean_tpu.serve import serve


@pytest.fixture(scope="module")
def server():
    state = downsample_state(ot.ocean_state_from_assets(), 64)
    cfg = ot.OceanConfig(resolution=64, compute_normals=True)
    srv = serve(state, cfg, host="127.0.0.1", port=0)  # ephemeral port
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", srv
    srv.shutdown()
    srv.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read(), r.headers.get("Content-Type")


def test_health_and_config(server):
    base, _ = server
    code, body, ctype = _get(base + "/health")
    assert code == 200 and json.loads(body)["status"] == "ok"
    code, body, _ = _get(base + "/config")
    assert json.loads(body)["resolution"] == 64


def test_frame_npz(server):
    base, srv = server
    code, body, ctype = _get(base + "/frame?t=2.5")
    assert code == 200 and ctype == "application/octet-stream"
    with np.load(io.BytesIO(body)) as z:
        assert z["displacement"].shape == (64, 64, 3)
        assert z["normals"].shape == (64, 64, 3)
        assert float(z["t"]) == 2.5
        assert np.isfinite(z["displacement"]).all()
    # statelessness: same t -> identical frame
    _, body2, _ = _get(base + "/frame?t=2.5")
    with np.load(io.BytesIO(body)) as a, np.load(io.BytesIO(body2)) as b:
        assert np.array_equal(a["displacement"], b["displacement"])


def test_frame_png(server):
    base, _ = server
    code, body, ctype = _get(base + "/frame.png?t=1.0&w=64&h=48&samples=8")
    assert code == 200 and ctype == "image/png"
    assert body[:8] == b"\x89PNG\r\n\x1a\n"


def test_metrics_progress(server):
    base, srv = server
    before = json.loads(_get(base + "/metrics")[1])["frames_served"]
    _get(base + "/frame?t=9.0")
    after = json.loads(_get(base + "/metrics")[1])["frames_served"]
    assert after == before + 1
    assert json.loads(_get(base + "/metrics")[1])["latency_ema_sec"] > 0


def test_viewer_page(server):
    base, _ = server
    code, body, ctype = _get(base + "/")
    assert code == 200 and ctype == "text/html"
    assert b"/session/strip.jpg" in body and b"/session/input" in body


def test_session_frame_jpg(server):
    base, _ = server
    code, body, ctype = _get(base + "/session/frame.jpg?w=64&h=48")
    assert code == 200 and ctype == "image/jpeg"
    assert body[:2] == b"\xff\xd8"  # JPEG SOI marker


def test_session_strip_jpg(server):
    """The strip endpoint renders n frames per dispatch, stacked
    vertically, and ticks the session clock by the full dt."""
    from PIL import Image

    base, srv = server
    t_before = srv.service.session.state()["sim_time"]
    served_before = json.loads(_get(base + "/metrics")[1])["frames_served"]
    code, body, ctype = _get(base + "/session/strip.jpg?w=64&h=48&n=3&dt=0.06")
    assert code == 200 and ctype == "image/jpeg"
    img = Image.open(io.BytesIO(body))
    assert img.size == (64, 48 * 3)
    state = srv.service.session.state()
    assert state["sim_time"] == pytest.approx(t_before + 0.06, abs=1e-6)
    assert (json.loads(_get(base + "/metrics")[1])["frames_served"]
            == served_before + 3)
    # out-of-range n is a client error, not a compile
    import urllib.error

    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(base + "/session/strip.jpg?w=64&h=48&n=50")
    assert exc.value.code == 400


def test_advance_batch_matches_single_ticks():
    """n strip sub-ticks integrate held keys exactly as n single
    ``advance`` calls with dt/n (same trajectory, src/lib.rs:139-148)."""
    from gfx_ocean_tpu.serve import CameraSession

    a, b = CameraSession(), CameraSession()
    for s in (a, b):
        s.input("press", "w")
        s.input("press", "left")
    ticks = a.advance_batch(4, dt=0.2)
    singles = [b.advance(0.05) for _ in range(4)]
    assert len(ticks) == 4
    for (ta, ca), (tb, cb) in zip(ticks, singles):
        assert ta == pytest.approx(tb)
        np.testing.assert_allclose(ca.position, cb.position, rtol=1e-6)
        np.testing.assert_allclose(ca.rotation, cb.rotation, rtol=1e-6)


def test_frame_jpg_stateless(server):
    base, _ = server
    code, body, ctype = _get(base + "/frame.jpg?t=1.5&w=64&h=48")
    assert code == 200 and ctype == "image/jpeg" and len(body) > 500


def test_frame_png_pose_override(server):
    base, _ = server
    code, body, _ = _get(base + "/frame.png?t=1&w=64&h=48&samples=8"
                               "&px=0&py=60&pz=200&rx=-0.8&ry=0")
    assert code == 200 and body[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.slow
def test_session_loop_reference_semantics(server):
    """The server-side session applies src/camera.rs math exactly."""
    from gfx_ocean_tpu.render.camera import Camera

    base, srv = server
    # Fresh, deterministic starting point regardless of test order —
    # restored afterwards so later tests see a clean session too.
    from gfx_ocean_tpu.serve import CameraSession
    prior = srv.service.session
    srv.service.session = CameraSession()

    st = json.loads(_get(base + "/session/state")[1])
    assert st["position"] == [-8.0, 32.0, 120.0]      # src/lib.rs:74-77
    assert st["rotation"] == [-0.6, -1.5, 0.0]

    # Hold W for one 0.1s frame: position += 90*dt*view_dir (camera.rs:126-133)
    _get(base + "/session/input?press=w")
    code, body, ctype = _get(base + "/session/frame.png?dt=0.1&w=32&h=32&samples=4")
    assert code == 200 and ctype == "image/png"
    want = Camera()
    want.input.forward = 1.0
    want.update(0.1)
    st = json.loads(_get(base + "/session/state")[1])
    np.testing.assert_allclose(st["position"], want.position, atol=1e-3)
    assert st["sim_time"] == 0.1

    # Release W, hold left arrow: yaw += 2*dt, position unchanged.
    _get(base + "/session/input?release=w")
    _get(base + "/session/input?press=left")
    _get(base + "/session/frame.png?dt=0.05&w=32&h=32&samples=4")
    st2 = json.loads(_get(base + "/session/state")[1])
    np.testing.assert_allclose(st2["rotation"][1], st["rotation"][1] + 0.1,
                               atol=1e-6)
    assert st2["position"] == st["position"]

    # Touch: left half of the screen yaws positive; end clears all input.
    _get(base + "/session/input?release=left")
    _get(base + "/session/input?touch=started&x=10&width=100")
    assert json.loads(_get(base + "/session/state")[1])["input"]["rot_y"] == 1.0
    _get(base + "/session/input?touch=ended")
    assert json.loads(_get(base + "/session/state")[1])["input"]["rot_y"] == 0.0

    # A/D are ignored, faithfully (SURVEY.md Q7).
    _get(base + "/session/input?press=a")
    assert json.loads(_get(base + "/session/state")[1])["input"] == {
        "forward": 0.0, "rot_x": 0.0, "rot_y": 0.0}

    srv.service.session = prior


def test_error_paths(server):
    base, _ = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base + "/frame?t=notanumber")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base + "/frame.png?t=1&w=99999")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(base + "/nope")
    assert e.value.code == 404


@pytest.mark.slow
def test_session_concurrent_requests(server):
    """The viewer keeps two frames in flight; concurrent session frame +
    input requests must not race (lock covers camera/pose mutation) and
    every response must be a valid image."""
    import concurrent.futures as cf

    base, _ = server

    def frame(_):
        code, body, ctype = _get(base + "/session/frame.jpg?w=48&h=32&dt=0.01")
        return code == 200 and body[:2] == b"\xff\xd8"

    def poke(i):
        _get(base + f"/session/input?{'press' if i % 2 else 'release'}=w")
        return True

    with cf.ThreadPoolExecutor(4) as ex:
        results = list(ex.map(frame, range(8))) + list(ex.map(poke, range(4)))
    assert all(results)
    st = json.loads(_get(base + "/session/state")[1])
    assert np.isfinite(st["position"]).all() and st["sim_time"] > 0


@pytest.mark.slow
def test_mixed_concurrent_requests(server):
    """Stateless frames, session frames, and metrics hit simultaneously
    across several viewports (exercising the per-key renderer build path
    concurrently): no 500s, the renderer cache stays bounded, and the
    error counter is untouched."""
    import concurrent.futures as cf

    base, srv = server
    errors_before = json.loads(_get(base + "/metrics")[1])["errors"]
    jobs = (["/frame.png?t=1.0&w=64&h=48&samples=8"] * 3
            + ["/session/frame.jpg?w=48&h=32&dt=0.01"] * 3
            + ["/frame.jpg?t=0.5&w=80&h=44"] * 3
            + ["/frame.jpg?t=0.5&w=72&h=40"] * 2
            + ["/metrics"] * 3)

    def hit(path):
        code, body, _ = _get(base + path)
        return code == 200 and len(body) > 0

    with cf.ThreadPoolExecutor(6) as ex:
        results = list(ex.map(hit, jobs))
    assert all(results)
    m = json.loads(_get(base + "/metrics")[1])
    assert m["errors"] == errors_before
    assert len(srv.service._renderers) <= srv.service._renderers_max
    assert not srv.service._builds          # no leaked build locks


def test_oversize_viewport_falls_back(server, monkeypatch):
    """Viewports above the fused-path area cap render via the f32
    render_frame path — no fused executable is compiled or cached."""
    from gfx_ocean_tpu import serve as serve_mod

    base, srv = server
    monkeypatch.setattr(serve_mod, "_FUSED_MAX_AREA", 64 * 48)
    code, body, _ = _get(base + "/frame.jpg?t=0.2&w=65&h=48&samples=8")
    assert code == 200 and body[:2] == b"\xff\xd8"
    assert (65, 48, 512) not in srv.service._renderers


@pytest.mark.slow
def test_serve_with_mesh_renders():
    """The sharded-service branch (mesh != None) of frame_png: band-height
    viewports render band-parallel over the mesh (one fused dispatch,
    bit-equal to single-chip — parallel/render.py); a height the row axis
    does not divide falls back to the host-gathered f32 path."""
    import jax

    from gfx_ocean_tpu.models.ocean import downsample_state
    from gfx_ocean_tpu.parallel import make_mesh
    from gfx_ocean_tpu.serve import serve

    mesh = make_mesh(jax.devices()[:4], batch=1, row=4)
    state = downsample_state(ot.ocean_state_from_assets(), 64)
    cfg = ot.OceanConfig(resolution=64, compute_normals=False)
    srv = serve(state, cfg, host="127.0.0.1", port=0, mesh=mesh)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        code, body, ctype = _get(base + "/frame.jpg?t=1.0&w=64&h=48")
        assert code == 200 and ctype == "image/jpeg" and body[:2] == b"\xff\xd8"
        assert (64, 48, 512) in srv.service._renderers  # band-parallel path
        code, body, ctype = _get(base + "/frame.jpg?t=1.0&w=64&h=47")
        assert code == 200 and body[:2] == b"\xff\xd8"  # 47 % 4 -> f32 path
        assert (64, 47, 512) not in srv.service._renderers
        m = json.loads(_get(base + "/metrics")[1])
        assert m["mesh"] == {"batch": 1, "row": 4}
    finally:
        srv.shutdown()
        srv.server_close()


@pytest.mark.slow
def test_renderer_cache_churn():
    """Cycling MORE viewports than the fused-renderer cache holds: a
    working set that fits compiles each key
    exactly once across repeat rounds (no thrash); evictions beyond the
    cap compile only the cold keys while the LRU protects a hot viewport;
    a slow cold-key build never stalls another client's cached frames;
    and the cache/build-lock tables stay bounded throughout."""
    import concurrent.futures as cf
    import time as _time

    import gfx_ocean_tpu.render.raster as raster_mod

    state = downsample_state(ot.ocean_state_from_assets(), 64)
    cfg = ot.OceanConfig(resolution=64, mesh_resolution=32,
                         compute_normals=False)
    srv = serve(state, cfg, host="127.0.0.1", port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    builds = []
    real = raster_mod.make_frame_renderer

    def counting(config, width=480, height=280, giants=512, pool=None,
                 **kw):
        builds.append(width)
        return real(config, width, height, giants, pool, **kw)

    raster_mod.make_frame_renderer = counting
    try:
        svc = srv.service
        maxn = svc._renderers_max
        widths = [32 + 8 * i for i in range(maxn + 2)]

        # Phase A: working set == cache capacity, cycled twice -> exactly
        # one compile per key (cache hits on the second round).
        for _ in range(2):
            for w in widths[:maxn]:
                assert _get(base + f"/frame.jpg?t=0.5&w={w}&h=24")[0] == 200
        assert builds == widths[:maxn]
        assert len(svc._renderers) <= maxn and not svc._builds

        # Phase B: two keys beyond capacity, interleaved with a HOT key
        # (the most recently used of phase A): only the cold keys compile;
        # the hot key stays cached through both evictions.
        hot = widths[maxn - 1]
        before = len(builds)
        for w in widths[maxn:]:
            assert _get(base + f"/frame.jpg?t=0.5&w={w}&h=24")[0] == 200
            assert _get(base + f"/frame.jpg?t=0.5&w={hot}&h=24")[0] == 200
        assert builds[before:] == widths[maxn:]
        assert len(svc._renderers) <= maxn and not svc._builds

        # Phase C: a cold key whose build stalls for 3 s (compile-time
        # stand-in) must not block a concurrent client on the hot key —
        # builds run outside the dispatch lock under a per-key lock.
        def slow_build(config, width=480, height=280, giants=512, pool=None,
                       **kw):
            builds.append(width)
            _time.sleep(3.0)
            return real(config, width, height, giants, pool, **kw)

        raster_mod.make_frame_renderer = slow_build
        with cf.ThreadPoolExecutor(2) as ex:
            cold = ex.submit(_get, base + "/frame.jpg?t=0.5&w=200&h=24")
            _time.sleep(0.3)          # let the cold build enter its sleep
            t0 = _time.perf_counter()
            code, body, _ = _get(base + f"/frame.jpg?t=0.5&w={hot}&h=24")
            hot_sec = _time.perf_counter() - t0
            assert code == 200 and body[:2] == b"\xff\xd8"
            assert hot_sec < 2.0, (
                f"cached-viewport frame took {hot_sec:.2f}s while a cold "
                f"key was compiling — cross-client stall")
            assert cold.result()[0] == 200
        assert len(svc._renderers) <= maxn and not svc._builds
    finally:
        raster_mod.make_frame_renderer = real
        srv.shutdown()
        srv.server_close()

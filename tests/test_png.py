"""Frame encoding without optional packages, and serve start-up."""

import builtins
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import gfx_ocean_tpu as ot
from gfx_ocean_tpu import serve as serve_mod


def test_stdlib_png_round_trip():
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import decode_png

    img = np.random.default_rng(0).integers(0, 256, (7, 13, 3), dtype=np.uint8)
    data = serve_mod.encode_png(img)
    np.testing.assert_array_equal(decode_png(data), img)
    PIL = pytest.importorskip("PIL.Image")
    import io
    np.testing.assert_array_equal(np.asarray(PIL.open(io.BytesIO(data))), img)


def test_serve_warmup_failure_propagates(monkeypatch):
    """A broken frame path fails serve() at start-up instead of leaving a
    'healthy' server behind."""
    def boom(*args, **kwargs):
        raise RuntimeError("renderer broke")

    monkeypatch.setattr("gfx_ocean_tpu.render.raster.make_frame_renderer", boom)
    cfg = ot.OceanConfig(resolution=32, mesh_resolution=16)
    state = ot.ocean_state_from_phillips(cfg, ot.PhillipsConfig(seed=0))
    with pytest.raises(RuntimeError, match="renderer broke"):
        serve_mod.serve(state, cfg, host="127.0.0.1", port=0)


def test_png_served_and_jpeg_501_without_pillow(monkeypatch):
    """/frame.png needs no Pillow; /frame.jpg answers 501 naming the
    extra when Pillow is absent."""
    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no Pillow here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    monkeypatch.setattr(serve_mod, "_WARM_VIEWPORT", (32, 32))
    cfg = ot.OceanConfig(resolution=32, mesh_resolution=16)
    state = ot.ocean_state_from_phillips(cfg, ot.PhillipsConfig(seed=0))
    srv = serve_mod.serve(state, cfg, host="127.0.0.1", port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/frame.png?t=1&w=32&h=32",
                                    timeout=120) as r:
            assert r.status == 200 and r.read()[:8] == b"\x89PNG\r\n\x1a\n"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/frame.jpg?t=1&w=32&h=32",
                                   timeout=120)
        assert e.value.code == 501
        assert b"'png' extra" in e.value.read()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()

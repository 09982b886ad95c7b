"""CLI driver + checkpoint round-trips (app-loop layer, SURVEY.md L4/L7)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import gfx_ocean_tpu as ot
from gfx_ocean_tpu.checkpoint import load_checkpoint, save_checkpoint, save_fields
from gfx_ocean_tpu.cli import main
from gfx_ocean_tpu.models.ocean import downsample_state


BASE = ["--resolution", "64", "--no-normals"]


def test_cli_info(capsys):
    assert main(["info", *BASE]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["config"]["resolution"] == 64
    assert out["state"]["h0"] == [2, 64, 64]


def test_cli_simulate_and_resume(tmp_path, capsys):
    ck = str(tmp_path / "state.npz")
    assert main(["simulate", *BASE, "--steps", "4", "--checkpoint", ck]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["frames"] == 4
    state, t, config = load_checkpoint(ck)
    assert t > 0 and config.resolution == 64
    assert main(["simulate", *BASE, "--steps", "2", "--resume", ck]) == 0


def test_cli_simulate_save_fields(tmp_path, capsys):
    d = str(tmp_path / "fields")
    assert main(["simulate", *BASE, "--steps", "2", "--save-fields", d]) == 0
    files = sorted(os.listdir(d))
    assert files == ["frame_00000.npz", "frame_00001.npz"]
    with np.load(os.path.join(d, files[0])) as z:
        assert z["displacement"].shape == (64, 64, 3)


def test_cli_bench(capsys):
    assert main(["bench", *BASE, "--steps", "8", "--repeats", "1",
                 "--time-batch", "2"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["steps_per_sec"] > 0
    assert out["resolution"] == 64


def test_cli_synth_roundtrip(tmp_path, capsys):
    sp = str(tmp_path / "s.bin")
    op = str(tmp_path / "o.bin")
    assert main(["synth", "--resolution", "64", "--out-spectrum", sp,
                 "--out-omega", op]) == 0
    from gfx_ocean_tpu.assets import load_omega, load_spectrum

    h0 = load_spectrum(sp, 64)
    om = load_omega(op, 64)
    assert h0.shape == (64, 64) and om.shape == (64, 64)
    assert np.isfinite(om).all() and om.max() > 0


@pytest.mark.slow
def test_cli_render(tmp_path, capsys):
    out = str(tmp_path / "frames")
    assert main(["render", *BASE, "--frames", "1", "--width", "64",
                 "--height", "48", "--samples", "8", "--keys", "w",
                 "--out", out]) == 0
    img = np.load(os.path.join(out, "frame_00000.npy"))
    assert img.shape == (48, 64, 3)
    assert np.isfinite(img).all()


@pytest.mark.slow
def test_cli_render_mesh(tmp_path, capsys):
    """render --mesh B,R: frames DP x viewport bands, same frames as the
    single-chip path (bit-equal renderers; tested in test_parallel)."""
    out1 = str(tmp_path / "f1")
    outm = str(tmp_path / "fm")
    common = ["render", *BASE, "--frames", "3", "--width", "64",
              "--height", "48", "--keys", "w"]
    assert main([*common, "--out", out1]) == 0
    assert main([*common, "--mesh", "2,4", "--out", outm]) == 0
    for j in range(3):
        a = np.load(os.path.join(out1, f"frame_{j:05d}.npy"))
        b = np.load(os.path.join(outm, f"frame_{j:05d}.npy"))
        assert np.array_equal(a, b)


@pytest.mark.slow
def test_cli_render_gif(tmp_path, capsys):
    """--gif writes one animated GIF whose frames decode back to the
    rendered frame shapes (PIL round trip)."""
    Image = pytest.importorskip("PIL.Image", reason="Pillow not installed")

    out = str(tmp_path / "frames")
    gif = str(tmp_path / "ocean.gif")
    assert main(["render", *BASE, "--frames", "3", "--width", "64",
                 "--height", "48", "--keys", "w", "--out", out,
                 "--gif", gif]) == 0
    with Image.open(gif) as im:
        assert im.n_frames == 3
        assert im.size == (64, 48)
        im.seek(2)
        frame = np.asarray(im.convert("RGB"))
    assert frame.shape == (48, 64, 3)
    # GIF is palettized (256 colors); require the decoded frame to be
    # close to the rendered one, not bit-equal.
    ref = np.load(os.path.join(out, "frame_00002.npy")).astype(np.int32)
    assert np.abs(frame.astype(np.int32) - ref).mean() < 8.0


def test_cli_render_zero_frames(tmp_path, capsys):
    """--frames 0 renders nothing and exits 0 (no np.stack of an empty
    camera path)."""
    out = str(tmp_path / "frames0")
    assert main(["render", *BASE, "--frames", "0", "--out", out]) == 0
    assert os.listdir(out) == []


def test_cli_render_pbr_roughness(tmp_path, capsys):
    """--pbr-roughness reaches the shader: the Cook-Torrance lobe only
    brightens pixels, and some specular pixel must actually change."""
    out0 = str(tmp_path / "f0")
    outr = str(tmp_path / "fr")
    common = ["render", *BASE, "--frames", "1", "--width", "64",
              "--height", "48", "--samples", "8"]
    assert main([*common, "--out", out0]) == 0
    assert main([*common, "--pbr-roughness", "0.3", "--out", outr]) == 0
    a = np.load(os.path.join(out0, "frame_00000.npy")).astype(np.int32)
    b = np.load(os.path.join(outr, "frame_00000.npy")).astype(np.int32)
    assert (b - a).min() >= 0 and (b != a).any()


def test_cli_phillips_flag(capsys):
    assert main(["simulate", *BASE, "--phillips", "--steps", "2",
                 "--wind-speed", "20"]) == 0


def test_checkpoint_roundtrip_preserves_bits(tmp_path):
    state = downsample_state(ot.ocean_state_from_assets(), 64)
    cfg = ot.OceanConfig(resolution=64, num_cascades=1)
    p = str(tmp_path / "c.npz")
    save_checkpoint(p, state, 12.5, cfg)
    state2, t2, cfg2 = load_checkpoint(p)
    assert t2 == 12.5 and cfg2 == cfg
    assert np.array_equal(np.asarray(state.h0), np.asarray(state2.h0))
    assert np.array_equal(np.asarray(state.omega), np.asarray(state2.omega))


def test_save_fields_npz(tmp_path):
    p = str(tmp_path / "f.npz")
    save_fields(p, np.zeros((4, 4, 3)), t=1.0)
    with np.load(p) as z:
        assert z["displacement"].shape == (4, 4, 3)
        assert float(z["t"]) == 1.0


def test_cli_bench_mesh(capsys):
    """`bench --mesh 2,4` runs on the 8-device CPU mesh."""
    assert main(["bench", *BASE, "--steps", "4", "--repeats", "1",
                 "--time-batch", "1", "--mesh", "2,4"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["steps_per_sec"] > 0
    assert out["mesh"] == {"batch": 2, "row": 4}


def test_cli_bench_mesh_shard_map(capsys):
    assert main(["bench", *BASE, "--no-pack", "--steps", "2", "--repeats",
                 "1", "--time-batch", "1", "--mesh", "1,8",
                 "--sharded-fft", "shard_map"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["steps_per_sec"] > 0 and out["sharded_fft"] == "shard_map"


def test_cli_simulate_mesh_matches_single_device(capsys):
    assert main(["simulate", *BASE, "--steps", "3"]) == 0
    single = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert main(["simulate", *BASE, "--steps", "3", "--mesh", "1,4"]) == 0
    sharded = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # f32 checksum of a near-cancelling field sum; sharding reassociates
    # the reduction, so agreement is order-of-reduction limited.
    np.testing.assert_allclose(single["checksums_head"],
                               sharded["checksums_head"], rtol=1e-3,
                               atol=5e-3)  # near-zero sums need an atol


def test_cli_simulate_mesh_save_fields(tmp_path, capsys):
    d = str(tmp_path / "fields")
    assert main(["simulate", *BASE, "--steps", "1", "--mesh", "1,4",
                 "--save-fields", d]) == 0
    with np.load(os.path.join(d, "frame_00000.npz")) as z:
        assert z["displacement"].shape == (64, 64, 3)
        assert np.isfinite(z["displacement"]).all()


def test_cli_mesh_rejects_bad_shapes():
    with pytest.raises(SystemExit):
        main(["bench", *BASE, "--steps", "2", "--mesh", "3,5"])
    with pytest.raises(SystemExit):
        main(["bench", *BASE, "--steps", "2", "--mesh", "nope"])


def test_compile_cache_respects_env(monkeypatch, tmp_path):
    """An explicit JAX_COMPILATION_CACHE_DIR wins over the package default."""
    from gfx_ocean_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/explicit/user/dir")
    assert compile_cache.enable_default_cache() == "/explicit/user/dir"


def test_compile_cache_returns_active_dir(monkeypatch, tmp_path):
    """Without the env var, returns the active (or newly set) cache dir."""
    from gfx_ocean_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = compile_cache.enable_default_cache()
    # conftest already activated the default cache for the suite; the
    # call must report whichever dir is live, never None, and never crash.
    assert isinstance(got, str) and got


def test_compile_cache_env_sets_no_other_dir(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, the code configures nothing:
    the jax config keeps whatever it had."""
    import jax

    from gfx_ocean_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/explicit/user/dir")
    compile_cache.enable_default_cache()
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    """Without the env var the cache is .jax_cache/ at the checkout root,
    a path that does not depend on HOME or the working directory, and
    .gitignore lists it."""
    import jax

    from gfx_ocean_tpu.utils import compile_cache

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache.DEFAULT_DIR == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setenv("HOME", "/nonexistent-home")
    monkeypatch.chdir("/")
    prev = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        assert compile_cache.enable_default_cache() == compile_cache.DEFAULT_DIR
        assert jax.config.jax_compilation_cache_dir == compile_cache.DEFAULT_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_cli_render_cascades(tmp_path, capsys):
    """render --cascades 3 --foam composites per-cascade fields
    (cascades are a first-class render config)."""
    out = str(tmp_path / "cframes")
    assert main(["render", *BASE, "--cascades", "3", "--foam",
                 "--frames", "1", "--width", "48", "--height", "32",
                 "--out", out]) == 0
    img = np.load(os.path.join(out, "frame_00000.npy"))
    assert img.shape == (32, 48, 3) and img.dtype == np.uint8


def test_cli_save_fields_batched(tmp_path, capsys):
    """--save-fields goes through the chunked keep_fields rollout."""
    out = str(tmp_path / "fields")
    assert main(["simulate", *BASE, "--steps", "3", "--dt", "0.05",
                 "--save-fields", out]) == 0
    files = sorted(os.listdir(out))
    assert files == [f"frame_{i:05d}.npz" for i in range(3)]
    with np.load(os.path.join(out, files[2])) as z:
        assert z["displacement"].shape == (64, 64, 3)
        assert abs(float(z["t"]) - 0.10) < 1e-6
        assert np.isfinite(z["displacement"]).all()


def test_cli_query(capsys):
    assert main(["query", "10.5,20", "100,30.25", *BASE, "-t", "3.5"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["t"] == 3.5 and len(out["samples"]) == 2
    s = out["samples"][0]
    assert s["x"] == 10.5 and s["z"] == 20.0
    assert np.isfinite(s["height"]) and len(s["normal"]) == 3
    assert abs(np.linalg.norm(s["normal"]) - 1.0) < 1e-5
    # agrees with the library API at the same config
    import jax.numpy as jnp
    from gfx_ocean_tpu.query import sample_surface
    state = downsample_state(ot.ocean_state_from_assets(), 64)
    cfg = ot.OceanConfig(resolution=64, compute_normals=False)
    fields = ot.make_step(cfg)(state, jnp.float32(3.5))
    want = sample_surface(fields.displacement, jnp.float32(10.5),
                          jnp.float32(20.0), iterations=8)
    assert abs(s["height"] - float(want.height)) < 1e-6


def test_cli_query_rejects_bad_point(capsys):
    with pytest.raises(SystemExit):
        main(["query", "10.5", *BASE])
    with pytest.raises(SystemExit):
        main(["query", "a,b", *BASE])


def test_import_does_not_initialize_jax_backend():
    """Importing the package must not commit a jax backend.

    ``python -m gfx_ocean_tpu`` honors ``JAX_PLATFORMS`` in ``main()``
    (cli.py ``_honor_platform_env``), which only works if nothing in the
    import chain created a device array first: a module-level ``jnp``
    constant (the old ``raster._KEY_MAX``) initialized the default
    platform at import and broke ``--mesh`` runs on the CPU mesh (the
    backend pinned to the single real chip). Subprocess because this
    process's conftest already initialized a backend.
    """
    code = (
        "import jax\n"
        "from jax._src import xla_bridge\n"
        "import gfx_ocean_tpu.cli\n"
        "import gfx_ocean_tpu.render.raster\n"
        "import gfx_ocean_tpu.serve\n"
        # Probe through whichever surface this JAX version exposes:
        # backends_are_initialized() is the stabler accessor; _backends is
        # the historical private dict. If BOTH are gone after an upgrade,
        # fail with a pointer instead of a bare AttributeError.
        "if hasattr(xla_bridge, 'backends_are_initialized'):\n"
        "    assert not xla_bridge.backends_are_initialized(), "
        "'backend initialized at import'\n"
        "elif hasattr(xla_bridge, '_backends'):\n"
        "    assert not xla_bridge._backends, list(xla_bridge._backends)\n"
        "else:\n"
        "    raise SystemExit('xla_bridge lost both backend-initialization "
        "probes; update test_import_does_not_initialize_jax_backend')\n"
    )
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # the real-platform path is the trap
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr

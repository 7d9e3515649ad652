"""Process set-up (utils/runtime.py), the no-GPU exits of the entry points,
and image output that needs no Pillow (utils/image.py)."""

import builtins
import os
import struct
import subprocess
import sys
import zlib

import jax
import numpy as np
import pytest

from cudaraytracer_tpu.utils import image, runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defers_to_env(monkeypatch, restore_cache_dir):
    monkeypatch.setenv(runtime.CACHE_ENV, "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert runtime.enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv(runtime.CACHE_ENV, raising=False)
    path = runtime.enable_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")  # fixed, not per run
    assert jax.config.jax_compilation_cache_dir == path
    assert runtime.enable_compile_cache() == path


def test_select_backend_requires_gpu():
    with pytest.raises(SystemExit) as e:
        runtime.select_backend()
    assert e.value.code and "--cpu" in str(e.value.code)
    assert runtime.select_backend(cpu=True) == "cpu"


@pytest.mark.parametrize("argv", [
    ["render", "--width", "8", "--height", "8", "-o", "never.png"],
    ["serve", "--port", "0"],
    ["bench"],
])
def test_cli_exits_without_gpu(argv, tmp_path, monkeypatch):
    """render, serve and bench refuse to run on the CPU unless asked."""
    from cudaraytracer_tpu.__main__ import main

    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code not in (0, None)
    assert not os.listdir(tmp_path)  # no output written


def _bench():
    sys.path.insert(0, REPO)
    try:
        import bench
    finally:
        sys.path.remove(REPO)
    return bench


def test_bench_exits_without_gpu(capsys):
    bench = _bench()
    with pytest.raises(SystemExit) as e:
        bench.main(["--width", "8", "--height", "8"])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""  # no result printed


def test_trace_breakdown_unions_overlapping_events():
    """Busy time is the union of the device intervals (streams overlap);
    per-op time sums every event of that name."""
    ms = 1_000_000
    events = [("k", 0, 4 * ms), ("copy", 2 * ms, 4 * ms),  # overlap 2 ms
              ("k", 10 * ms, 2 * ms),                     # gap 4 ms
              ("f", 10 * ms, 1 * ms)]                     # inside k
    out = _bench().trace_breakdown(events)
    assert out["device_busy_ms"] == pytest.approx(8.0)
    assert out["device_span_ms"] == pytest.approx(12.0)
    assert out["idle_share"] == pytest.approx(1 / 3)
    assert out["ops_ms"] == [["k", 6.0], ["copy", 4.0], ["f", 1.0]]


def test_bench_trace_needs_device_events(tmp_path):
    """A trace with no GPU plane (here, the CPU's) yields no device events,
    and the breakdown refuses it rather than report an idle device."""
    import jax
    import jax.numpy as jnp

    bench = _bench()
    f = jax.jit(lambda x: jnp.sin(x).sum())
    x = jnp.ones((16,))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(x).block_until_ready()
    assert bench.read_trace(str(tmp_path)) == []
    with pytest.raises(ValueError):
        bench.trace_breakdown([])
    with pytest.raises(FileNotFoundError):
        bench.read_trace(str(tmp_path / "none"))


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """chip_smoke.py prints no result and exits non-zero without a GPU,
    and also when it stands alone, without the package beside it."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=REPO)
    assert r.returncode != 0 and '"ok"' not in r.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env.pop("PYTHONPATH")
    r = subprocess.run([sys.executable, str(lone)], capture_output=True,
                       text=True, timeout=300, env=env, cwd=tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def _decode_png(data):
    """Minimal PNG reader for 8-bit RGB/RGBA, filter 0 (what encode_png
    writes) — the standard library only."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc, = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype = hdr[:4]
    c = {2: 3, 6: 4}[ctype]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    assert depth == 8 and (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, c)


@pytest.mark.parametrize("channels", [3, 4])
def test_png_roundtrip_stdlib(channels):
    img = (np.random.RandomState(channels).rand(9, 7, channels) * 255
           ).astype(np.uint8)
    np.testing.assert_array_equal(_decode_png(image.encode_png(img)), img)


def test_save_png_needs_no_pillow(tmp_path, monkeypatch):
    """`render -o x.png` always writes x.png, Pillow or not."""
    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name.split(".")[0] == "PIL":
            raise ImportError("no Pillow here")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    img = np.zeros((4, 6, 4), np.uint8)
    img[0, 0] = (255, 0, 0, 255)
    p = tmp_path / "x.png"
    image.save_png(str(p), img, flip_vertical=True)
    assert sorted(os.listdir(tmp_path)) == ["x.png"]
    back = _decode_png(p.read_bytes())
    np.testing.assert_array_equal(back, img[::-1])
    with pytest.raises(ImportError, match="Pillow"):
        image.load_rgb(str(p))


def test_viewer_polls_png_without_pillow(monkeypatch):
    """/state tells the page whether /frame.jpg works; without Pillow the
    page polls /frame.png, which the standard library encodes."""
    from cudaraytracer_tpu.config import RenderConfig
    from cudaraytracer_tpu.viewer import server as srv
    from cudaraytracer_tpu.viewer.app import Application

    app = Application(RenderConfig(width=8, height=8, spp=1, max_depth=1,
                                   accel="brute"))
    app.setup_default_layers()
    app.run(max_frames=1)
    v = srv.ViewerServer(app, port=0)
    monkeypatch.setattr(srv, "_HAVE_PILLOW", False)
    assert v.state_json()["options"]["jpeg"] is False
    assert "jpeg===false?'/frame.png'" in srv._PAGE
    png = _decode_png(v.frame_png())
    assert png.shape == (8, 8, 4)
    app.close()

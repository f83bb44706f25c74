"""Fixture configs roundtrip (tier-1 of the reference's test strategy) + IO."""

import numpy as np
import pytest

from metalhuffman.models import CodecConfig, ImageCodec
from metalhuffman.utils import fixtures, imageio


@pytest.mark.parametrize("config", fixtures.SMALL_CONFIGS)
def test_small_fixture_roundtrip(config):
    img = fixtures.render_frame(config)
    ImageCodec(CodecConfig(backend="xla")).roundtrip_verify(img)


@pytest.mark.parametrize("config", ["8x8_ident_2048", "large_random", "image3"])
@pytest.mark.slow
def test_large_fixture_roundtrip(config):
    img = fixtures.render_frame(config)
    codec = ImageCodec(CodecConfig(backend="xla"))
    stream = codec.roundtrip_verify(img)
    if config.startswith("image"):
        assert stream.compressed_size < img.size


@pytest.mark.parametrize("backend", ["xla", "pallas", "native"])
def test_real_photo_512_roundtrip(backend):
    # REAL photographic bits (content statistics matter: PERF.md shows
    # photo vs synthetic changes throughput) — not a synthetic generator.
    img = fixtures.render_frame("bridge_512")
    assert img.shape == (512, 512)
    ImageCodec(CodecConfig(
        backend=backend)).roundtrip_verify(img)


@pytest.mark.slow
def test_real_photo_roundtrip_and_size_parity():
    # The reference's default config decodes this exact 2048x1536 photo
    # (HuffRenderFrame.m:593-613); its verify path byte-compares every pixel
    # (AAPLRenderer.m:1849-1876). Compressed size in the reference wire
    # format (8B header + 256B table + code bytes + 2B pad) is fixed
    # accounting for this image — an encoder-parity regression gate.
    img = fixtures.render_frame("bridge")
    assert img.shape == (1536, 2048)
    stream = ImageCodec(CodecConfig(backend="native")).roundtrip_verify(img)
    assert stream.compressed_size == 1923654  # 61.2% of 3.1 MB


def test_unknown_config_raises():
    with pytest.raises(ValueError):
        fixtures.render_frame("nope")


def test_all_configs_enumerated():
    assert set(fixtures.SMALL_CONFIGS) | set(fixtures.LARGE_CONFIGS) == set(
        fixtures.CONFIGS
    )
    # capability parity: the reference enumerates 17 configs
    assert len(fixtures.CONFIGS) >= 16


def test_raw_gray_io(tmp_path):
    img = fixtures.render_frame("16x16_ident")
    p = tmp_path / "f.gray"
    imageio.save_grayscale(img, p)
    np.testing.assert_array_equal(imageio.load_grayscale(p), img)


def test_png_io(tmp_path):
    pytest.importorskip("PIL")
    img = fixtures.render_frame("8x8_ident")
    p = tmp_path / "f.png"
    imageio.save_grayscale(img, p)
    np.testing.assert_array_equal(imageio.load_grayscale(p), img)


def test_tga_reader(tmp_path):
    import struct

    img = fixtures.render_frame("16x16_ident")
    h, w = img.shape
    # 8-bit grayscale, origin top-left (descriptor 0x20)
    header = bytes([0, 0, 3]) + b"\0" * 9 + struct.pack("<HH", w, h) + bytes([8, 0x20])
    p = tmp_path / "f.tga"
    p.write_bytes(header + img.tobytes())
    np.testing.assert_array_equal(imageio.load_tga(p), img)
    # bottom-left origin variant round-flips
    header_bl = bytes([0, 0, 3]) + b"\0" * 9 + struct.pack("<HH", w, h) + bytes([8, 0])
    p.write_bytes(header_bl + img[::-1].tobytes())
    np.testing.assert_array_equal(imageio.load_tga(p), img)


def test_profiler_trace_context(tmp_path):
    import jax.numpy as jnp

    from metalhuffman.utils import profiling

    with profiling.trace(str(tmp_path / "trace")) as d:
        float(jnp.sum(jnp.ones((8, 8))))
    assert (tmp_path / "trace").exists()


def test_timer_and_time_fn():
    from metalhuffman.utils import profiling

    t = profiling.Timer("x")
    with t:
        pass
    t.add_bytes(1000)
    assert t.count == 1 and "GB/s" in t.report()

    dt, gbps = profiling.time_fn(lambda x: x + 1, np.float32(1), iters=2, warmup=1,
                                 payload_bytes=100)
    assert dt > 0 and gbps > 0


# -- PNG without PIL (the zlib reader/writer) ---------------------------------


def _png_with_filter(img, kind, path):
    """Write ``img`` as a PNG whose every row uses filter ``kind`` (0-4),
    so the reader's five unfilter paths are each exercised."""
    import struct
    import zlib

    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    rows = img.reshape(h, w * c).astype(np.int64)
    out = []
    for y in range(h):
        x = rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        ul = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = up
        elif kind == 3:
            pred = (left + up) >> 1
        else:
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up, ul))
        out.append(bytes([kind]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes())

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body)))

    path.write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(b"".join(out)))
        + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_png_reader_matches_pil(tmp_path, kind, channels):
    from PIL import Image

    rng = np.random.default_rng(10 * kind + channels)
    shape = (13, 17) if channels == 1 else (13, 17, channels)
    img = rng.integers(0, 256, shape, np.uint8)
    path = tmp_path / "f.png"
    _png_with_filter(img, kind, path)
    got = imageio.read_png(path)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))


@pytest.mark.parametrize("asset", ["bridge_512x512.png", "bridge_2048x1536.png"])
def test_png_fallback_loads_assets_like_pil(asset, monkeypatch):
    from pathlib import Path

    path = Path(__file__).parent / "assets" / asset
    ref = imageio.load_grayscale(path)  # through PIL
    monkeypatch.setattr(imageio, "_pil_image", lambda: None)
    np.testing.assert_array_equal(imageio.load_grayscale(path), ref)


def test_png_fallback_color_and_writer(tmp_path, monkeypatch):
    from PIL import Image

    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (9, 11, 3), np.uint8)
    gray_ref = np.asarray(Image.fromarray(rgb, mode="RGB").convert("L"))
    monkeypatch.setattr(imageio, "_pil_image", lambda: None)
    imageio.save_color(rgb, tmp_path / "c.png")
    np.testing.assert_array_equal(imageio.load_color(tmp_path / "c.png"), rgb)
    # PIL's own luma conversion, in the same integer arithmetic
    np.testing.assert_array_equal(
        imageio.load_grayscale(tmp_path / "c.png"), gray_ref)
    imageio.save_grayscale(gray_ref, tmp_path / "g.png")
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "g.png")), gray_ref)
    with pytest.raises(ImportError, match="Pillow"):
        imageio.load_grayscale(tmp_path / "x.jpg")

"""Planar color / 16-bit codec over the shared-table pipeline (MHTC)."""

import numpy as np
import pytest

from metalhuffman.models import CodecConfig, color, frame_stream


def _rgb(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    r = np.clip(120 + 80 * np.sin(xx / 11.0), 0, 255)
    g = np.clip(100 + 80 * np.cos(yy / 13.0), 0, 255)
    b = np.clip(90 + rng.normal(0, 10, (h, w)), 0, 255)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


@pytest.mark.parametrize("channels", [3, 4])
def test_color_roundtrip(channels):
    img = _rgb(32, 48)[:, :, :3]
    if channels == 4:
        img = np.concatenate([img, np.full((32, 48, 1), 255, np.uint8)], axis=-1)
    cfg = CodecConfig(backend="pallas")
    blob = color.encode_color_to_bytes(img, cfg)
    assert blob[:4] == color.COLOR_MAGIC
    out = color.decode_color_from_bytes(blob, cfg)
    np.testing.assert_array_equal(out, img)


def test_color_rejects_bad_input():
    with pytest.raises(ValueError):
        color.encode_color(np.zeros((8, 8), np.uint8))
    with pytest.raises(ValueError):
        color.encode_color(np.zeros((8, 8, 3), np.float32))


def test_legacy_bare_mhtv_still_decodes():
    # encode_color_to_bytes once wrote a bare MHTV whose frame count was the
    # channel count; decode_color_from_bytes keeps reading that form
    img = _rgb(16, 24, seed=3)
    cfg = CodecConfig()
    stream, c = color.encode_color(img, cfg)
    legacy = frame_stream.write_shared(stream, c, 16, 24, cfg)
    out = color.decode_color_from_bytes(legacy, cfg)
    np.testing.assert_array_equal(out, img)


def test_color_video_roundtrip():
    rng = np.random.default_rng(7)
    frames = np.stack([_rgb(24, 32, seed=i) for i in range(3)])
    frames[1] ^= rng.integers(0, 4, frames[1].shape, np.uint8)
    cfg = CodecConfig()
    blob = color.encode_color_video_to_bytes(frames, cfg)
    out = color.decode_color_video_from_bytes(blob, cfg)
    np.testing.assert_array_equal(out, frames)


def test_color_video_frame_random_access():
    frames = np.stack([_rgb(24, 32, seed=i) for i in range(4)])
    cfg = CodecConfig()
    blob = color.encode_color_video_to_bytes(frames, cfg)
    for n in (0, 2, 3):
        one = color.decode_color_frame(blob, n, cfg)
        np.testing.assert_array_equal(one, frames[n])
    with pytest.raises(ValueError):
        color.decode_color_frame(blob, 4, cfg)


def test_color_frame_access_across_mhv2_segments():
    # force a segmented inner container with tiny segments so one frame's
    # planes straddle a segment boundary (3 channels, 2 planes/segment)
    frames = np.stack([_rgb(16, 16, seed=i) for i in range(3)])
    t, h, w, c = frames.shape
    planes = frames.transpose(0, 3, 1, 2).reshape(t * c, h, w)
    cfg = CodecConfig()
    bits_two_planes = 2 * h * w * frame_stream._SEG_BITS_PER_SYMBOL
    segs = frame_stream.encode_frames_segmented(
        planes, cfg, max_segment_bits=bits_two_planes)
    assert len(segs) > 1
    inner = frame_stream.write_segmented(segs, h, w, cfg)
    blob = color.wrap(inner, c, color.LAYOUT_VIDEO)
    for n in range(t):
        np.testing.assert_array_equal(
            color.decode_color_frame(blob, n, cfg), frames[n])


def test_gray16_image_roundtrip():
    rng = np.random.default_rng(11)
    base = np.cumsum(rng.integers(-3, 4, (40, 48)), axis=1)
    img = (20000 + base * 7).astype(np.uint16)
    cfg = CodecConfig()
    blob = color.encode_gray16_to_bytes(img, cfg)
    out = color.decode_gray16_from_bytes(blob, cfg)
    assert out.dtype == np.uint16 and out.shape == img.shape
    np.testing.assert_array_equal(out, img)


def test_gray16_video_roundtrip_and_frame():
    rng = np.random.default_rng(13)
    frames = rng.integers(0, 1 << 16, (3, 16, 24), np.uint16)
    cfg = CodecConfig()
    blob = color.encode_gray16_to_bytes(frames, cfg)
    out = color.decode_gray16_from_bytes(blob, cfg)
    np.testing.assert_array_equal(out, frames)
    one = color.decode_color_frame(blob, 1, cfg)
    assert one.dtype == np.uint16
    np.testing.assert_array_equal(one, frames[1])


def test_mhtc_kind_mismatch_errors():
    img = _rgb(16, 16)
    cfg = CodecConfig()
    blob = color.encode_color_to_bytes(img, cfg)
    with pytest.raises(ValueError):
        color.decode_gray16_from_bytes(blob, cfg)
    with pytest.raises(ValueError):
        color.decode_color_video_from_bytes(blob, cfg)
    with pytest.raises(ValueError):
        color.decode_color_frame(blob, 0, cfg)  # image layout: no frame axis
    vid = color.encode_color_video_to_bytes(img[None], cfg)
    with pytest.raises(ValueError):
        color.decode_color_from_bytes(vid, cfg)


def test_mhtc_crc_detects_corruption():
    img = _rgb(16, 16, seed=5)
    blob = bytearray(color.encode_color_to_bytes(img, CodecConfig()))
    # flip a code byte: the inner MHTV tail is 4 CRC + 48 offset bytes
    # (12 blocks), so -62 lands inside the Huffman code stream
    blob[-62] ^= 0xFF
    with pytest.raises(ValueError):
        color.decode_color_from_bytes(bytes(blob), CodecConfig())


def test_describe():
    img = _rgb(8, 8)
    cfg = CodecConfig()
    assert "3-channel" in color.describe(color.encode_color_to_bytes(img, cfg))
    g16 = color.encode_gray16_to_bytes(
        np.zeros((8, 8), np.uint16), cfg)
    assert "u16" in color.describe(g16)


def test_subgreen_transform_inverts():
    rng = np.random.default_rng(21)
    img = rng.integers(0, 256, (16, 16, 4), np.uint8)  # incl. wraparound
    t = color.to_subgreen(img)
    np.testing.assert_array_equal(color.from_subgreen(t), img)
    np.testing.assert_array_equal(t[..., 1], img[..., 1])  # G untouched
    np.testing.assert_array_equal(t[..., 3], img[..., 3])  # alpha untouched


def _photo_like_rgb(h, w, seed=0):
    """Channels dominated by shared luma (natural-photo statistics)."""
    rng = np.random.default_rng(seed)
    luma = np.cumsum(rng.integers(-4, 5, (h, w)), axis=1) + 128
    img = np.stack([
        np.clip(luma + rng.integers(-3, 4, (h, w)), 0, 255),
        np.clip(luma, 0, 255),
        np.clip(luma + rng.integers(-3, 4, (h, w)), 0, 255),
    ], axis=-1)
    return img.astype(np.uint8)


def test_subgreen_image_roundtrip_and_wins_on_photo():
    img = _photo_like_rgb(48, 64)
    cfg = CodecConfig()
    ident = color.encode_color_to_bytes(img, cfg)
    sub = color.encode_color_to_bytes(img, cfg, colorspace=color.CS_SUBGREEN)
    np.testing.assert_array_equal(color.decode_color_from_bytes(sub, cfg), img)
    assert len(sub) < len(ident)  # decorrelation pays on luma-shared content
    assert "sub-green" in color.describe(sub)
    best = color.encode_color_best(img, cfg, search_precoders=False)
    assert len(best) == len(sub)
    np.testing.assert_array_equal(color.decode_color_from_bytes(best, cfg), img)


def test_subgreen_video_roundtrip_and_frame_access():
    frames = np.stack([_photo_like_rgb(24, 32, seed=i) for i in range(3)])
    cfg = CodecConfig()
    blob = color.encode_color_video_to_bytes(
        frames, cfg, colorspace=color.CS_SUBGREEN)
    np.testing.assert_array_equal(
        color.decode_color_video_from_bytes(blob, cfg), frames)
    np.testing.assert_array_equal(
        color.decode_color_frame(blob, 2, cfg), frames[2])


def test_encode_color_best_full_search_decodes():
    img = _photo_like_rgb(32, 32, seed=9)
    cfg = CodecConfig()
    blob = color.encode_color_best(img, cfg)
    np.testing.assert_array_equal(color.decode_color_from_bytes(blob, cfg), img)


def test_native_backend_on_mhtc_paths():
    # review finding: MHTC decode surfaces must honor backend="native"
    # (multithreaded host C++), like every grayscale surface
    img = _photo_like_rgb(24, 32, seed=31)
    enc = CodecConfig()
    native_cfg = CodecConfig(backend="native")
    blob = color.encode_color_to_bytes(img, enc, colorspace=color.CS_SUBGREEN)
    np.testing.assert_array_equal(
        color.decode_color_from_bytes(blob, native_cfg), img)
    frames = np.stack([_photo_like_rgb(16, 24, seed=i) for i in range(3)])
    vblob = color.encode_color_video_to_bytes(frames, enc)
    np.testing.assert_array_equal(
        color.decode_color_video_from_bytes(vblob, native_cfg), frames)
    np.testing.assert_array_equal(
        color.decode_color_frame(vblob, 1, native_cfg), frames[1])


def test_truncated_mhtc_header_is_valueerror():
    with pytest.raises(ValueError, match="truncated"):
        color.unwrap(b"MHTC\x03")


def test_gray16_plane_count_validation():
    # a kind=1 image wrapper over a 4-plane stream must not silently drop data
    frames = np.zeros((4, 8, 8), np.uint8)
    cfg = CodecConfig()
    inner = color._encode_planes(frames, cfg)
    bad = color.wrap(inner, 2, color.LAYOUT_IMAGE, color.KIND_U16)
    with pytest.raises(ValueError):
        color.decode_gray16_from_bytes(bad, cfg)
    odd = color.wrap(color._encode_planes(frames[:3], cfg), 2,
                     color.LAYOUT_VIDEO, color.KIND_U16)
    with pytest.raises(ValueError):
        color.decode_gray16_from_bytes(odd, cfg)

"""Shared-table video mode: one canonical table, one fused batch decode."""

import numpy as np
import pytest

from metalhuffman.models import CodecConfig, frame_stream


def _frames(t, h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = []
    for i in range(t):
        img = 100 + 60 * np.sin((xx + 5 * i) / 17.0) * np.cos(yy / 13.0)
        out.append(np.clip(img + rng.normal(0, 2, (h, w)), 0, 255).astype(np.uint8))
    return np.stack(out)


def test_shared_roundtrip_interpret():
    cfg = CodecConfig(backend="pallas")
    frames = _frames(4, 32, 48)
    stream = frame_stream.encode_frames_shared(frames, cfg)
    out = np.asarray(frame_stream.decode_frames_shared(stream, 4, 32, 48, cfg))
    np.testing.assert_array_equal(out, frames)


def test_shared_stream_is_one_table():
    cfg = CodecConfig(backend="pallas")
    frames = _frames(3, 24, 24, seed=5)
    stream = frame_stream.encode_frames_shared(frames, cfg)
    # 3 frames x (24x24 -> 3x3 blocks of 8x8) = 27 blocks in one stream
    assert stream.block_offsets.size == 27
    assert stream.widths.shape == (256,)


def test_shared_prepare_step_split():
    cfg = CodecConfig(backend="pallas")
    frames = _frames(2, 16, 32, seed=7)
    stream = frame_stream.encode_frames_shared(frames, cfg)
    prep = frame_stream.prepare_shared(stream, 2, 16, 32, cfg)
    out1 = np.asarray(frame_stream.decode_shared_step(prep, cfg))
    out2 = np.asarray(frame_stream.decode_shared_step(prep, cfg))
    np.testing.assert_array_equal(out1, frames)
    np.testing.assert_array_equal(out2, frames)


def test_shared_image_layout_path_interpret():
    # the kernel writes image words: the raw output is the frame as int32
    # words, viewed as bytes on the host
    cfg = CodecConfig(backend="pallas")
    frames = _frames(2, 16, 1024, seed=9)
    stream = frame_stream.encode_frames_shared(frames, cfg)
    prep = frame_stream.prepare_shared(stream, 2, 16, 1024, cfg)
    out = np.asarray(frame_stream.decode_shared_step(prep, cfg))
    np.testing.assert_array_equal(out, frames)
    raw = frame_stream.decode_shared_step(prep, cfg, raw=True)
    assert raw.shape == (2, 16, 256) and raw.dtype == np.int32
    view = frame_stream.frames_from_raw(raw, 2, 16, 1024)
    np.testing.assert_array_equal(view, frames)


def test_shared_image_layout_h2_2_interpret():
    cfg = CodecConfig(backend="pallas")
    frames = _frames(1, 8, 2048, seed=10)
    stream = frame_stream.encode_frames_shared(frames, cfg)
    prep = frame_stream.prepare_shared(stream, 1, 8, 2048, cfg)
    out = np.asarray(frame_stream.decode_shared_step(prep, cfg))
    np.testing.assert_array_equal(out, frames)


def test_shared_sharded_image_path():
    from metalhuffman.parallel import mesh as mesh_mod

    cfg = CodecConfig(backend="pallas")
    frames = _frames(2, 64, 1024, seed=11)
    stream = frame_stream.encode_frames_shared(frames, cfg)
    m = mesh_mod.make_mesh(2)
    out = frame_stream.decode_shared_sharded(
        stream, 2, 64, 1024, mesh=m, config=cfg)
    assert out.shape == (128, 256)
    # each device holds a contiguous range of image rows
    assert [s.data.shape for s in out.addressable_shards] == [(64, 256)] * 2
    view = frame_stream.frames_from_raw(out, 2, 64, 1024)
    np.testing.assert_array_equal(view, frames)


def test_shared_sharded_generic_path():
    from metalhuffman.parallel import mesh as mesh_mod

    cfg = CodecConfig(backend="pallas")
    frames = _frames(2, 40, 44, seed=12)  # 5x6 blocks, 10 rows over 4
    stream = frame_stream.encode_frames_shared(frames, cfg)
    m = mesh_mod.make_mesh(4)
    out = frame_stream.decode_shared_sharded(
        stream, 2, 40, 44, mesh=m, config=cfg)
    assert out.shape == (12 * 8, 12)  # rows padded to whole rows/device
    view = frame_stream.frames_from_raw(out, 2, 40, 44)
    np.testing.assert_array_equal(view, frames)


def test_shared_padded_image_path_1080p_interpret():
    # 1920 px = 240 blocks a row: image words need no padding beyond whole
    # blocks (1080 rows = 135 block rows exactly)
    cfg = CodecConfig(backend="pallas")
    frames = _frames(1, 48, 1920, seed=13)
    stream = frame_stream.encode_frames_shared(frames, cfg)
    prep = frame_stream.prepare_shared(stream, 1, 48, 1920, cfg)
    out = np.asarray(frame_stream.decode_shared_step(prep, cfg))
    np.testing.assert_array_equal(out, frames)
    raw = frame_stream.decode_shared_step(prep, cfg, raw=True)
    assert raw.shape == (1, 48, 480)
    view = frame_stream.frames_from_raw(raw, 1, 48, 1920)
    np.testing.assert_array_equal(view, frames)


def test_shared_padded_image_path_odd_geometry_interpret():
    # non-multiple-of-8 height AND width: row and column crop both engage
    cfg = CodecConfig(backend="pallas")
    frames = _frames(2, 20, 1212, seed=14)  # bh=3 (24 rows), bw=152
    stream = frame_stream.encode_frames_shared(frames, cfg)
    prep = frame_stream.prepare_shared(stream, 2, 20, 1212, cfg)
    out = np.asarray(frame_stream.decode_shared_step(prep, cfg))
    np.testing.assert_array_equal(out, frames)
    raw = frame_stream.decode_shared_step(prep, cfg, raw=True)
    assert raw.shape == (2, 24, 304)
    view = frame_stream.frames_from_raw(raw, 2, 20, 1212)
    np.testing.assert_array_equal(view, frames)


def test_shared_image_path_h2_3_g6_interpret():
    # 2560 px (320 blocks a row)
    cfg = CodecConfig(backend="pallas")
    frames = _frames(1, 16, 2560, seed=15)
    stream = frame_stream.encode_frames_shared(frames, cfg)
    prep = frame_stream.prepare_shared(stream, 1, 16, 2560, cfg)
    out = np.asarray(frame_stream.decode_shared_step(prep, cfg))
    np.testing.assert_array_equal(out, frames)


def test_padded_geometry():
    from metalhuffman.ops import decode_pallas as dp

    assert dp.padded_geometry(1536, 2048) == (1536, 2048)
    assert dp.padded_geometry(1080, 1920) == (1080, 1920)
    assert dp.padded_geometry(20, 1212) == (24, 1216)
    assert dp.padded_geometry(20, 1212, block_dim=16) == (32, 1216)


@pytest.mark.parametrize("raw", [False, True], ids=["frames", "raw"])
def test_xla_backend_matches_kernel(raw):
    """backend="xla" is the explicit plain-XLA decode through the same
    staging and step functions, with the same output contract."""
    frames = _frames(2, 24, 40, seed=16)
    outs = []
    for backend in ("pallas", "xla"):
        cfg = CodecConfig(backend=backend)
        stream = frame_stream.encode_frames_shared(frames, cfg)
        prep = frame_stream.prepare_shared(stream, 2, 24, 40, cfg)
        assert prep.backend == backend
        outs.append(np.asarray(
            frame_stream.decode_shared_step(prep, cfg, raw=raw)))
    np.testing.assert_array_equal(outs[0], outs[1])
    got = frame_stream.frames_from_raw(outs[1], 2, 24, 40) if raw else outs[1]
    np.testing.assert_array_equal(got, frames)


def test_raw_refused_for_2x2_blocks():
    cfg = CodecConfig(backend="pallas", block_dim=2)
    frames = _frames(1, 8, 12, seed=17)
    stream = frame_stream.encode_frames_shared(frames, cfg)
    prep = frame_stream.prepare_shared(stream, 1, 8, 12, cfg)
    with pytest.raises(ValueError, match="raw"):
        frame_stream.decode_shared_step(prep, cfg, raw=True)
    np.testing.assert_array_equal(
        np.asarray(frame_stream.decode_shared_step(prep, cfg)), frames)


def test_shared_rejects_bad_shapes():
    cfg = CodecConfig()
    with pytest.raises(ValueError):
        frame_stream.encode_frames_shared(np.zeros((4, 4), np.uint8), cfg)

"""Zero-init-delta variant (reference AAPLShaderTypes.h:110,
AAPLRenderer.m:449-473/1050-1068): block root bytes ship uncoded, their
stream slot is a zero delta, decode seeds prev with the root byte (realized
here as a mod-256 block add — kernel-agnostic)."""

import numpy as np
import pytest

from metalhuffman.core import delta
from metalhuffman.models import CodecConfig, ImageCodec
from metalhuffman.utils import fixtures


def test_split_apply_inverse():
    rng = np.random.default_rng(0)
    blocks = rng.integers(0, 256, (100, 64), dtype=np.uint8)
    deltas = delta.delta_encode_blocks(blocks)
    init, zeroed = delta.split_zero_init(deltas)
    assert (zeroed[:, 0] == 0).all()
    assert np.array_equal(init, deltas[:, 0])
    # decode-with-prev-0 then block add == decode-with-prev-init
    dec0 = delta.delta_decode_blocks(zeroed)
    assert np.array_equal(delta.apply_block_init(dec0, init), blocks)


@pytest.mark.parametrize("backend", ["native", "xla", "pallas"])
def test_roundtrip_zero_init(backend):
    img = fixtures.render_frame("bridge_512")
    cfg = CodecConfig(backend=backend, zero_init=True)
    codec = ImageCodec(cfg)
    stream = codec.encode(img)
    assert stream.block_init is not None
    assert stream.block_init.size == stream.block_offsets.size
    out = np.asarray(codec.decode(stream, *img.shape))
    assert np.array_equal(out, img)


def test_container_roundtrip_zero_init():
    img = fixtures.render_frame("bridge_512")
    cfg = CodecConfig(backend="native", zero_init=True)
    codec = ImageCodec(cfg)
    blob = codec.encode_to_bytes(img)
    # a plain-config codec decodes it: the container mode is authoritative
    out = ImageCodec(CodecConfig(backend="native")).decode(blob)
    assert np.array_equal(out, img)


def test_zero_init_boosts_zero_count():
    img = fixtures.render_frame("bridge_512")
    plain = ImageCodec(CodecConfig(backend="native")).encode(img)
    zi = ImageCodec(CodecConfig(backend="native", zero_init=True)).encode(img)
    # the stream itself must not grow (zero is the most common delta on
    # smooth content; adding one per block can only shorten its code)
    assert zi.compressed_size <= plain.compressed_size
    # width of the zero symbol can only shrink
    assert zi.widths[0] <= plain.widths[0]


def test_zero_init_requires_delta():
    img = fixtures.render_frame("bridge_512")
    codec = ImageCodec(CodecConfig(delta=False, zero_init=True))
    with pytest.raises(ValueError):
        codec.encode(img)


def test_region_decode_zero_init():
    img = fixtures.render_frame("bridge_512")
    cfg = CodecConfig(backend="xla", zero_init=True)
    codec = ImageCodec(cfg)
    stream = codec.encode(img)
    got = codec.decode_region(stream, *img.shape, 40, 24, 64, 80)
    assert np.array_equal(got, img[40:104, 24:104])


def _frames(t, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(128, 20, (t, h, w)).clip(0, 255).astype(np.uint8)


def test_shared_zero_init_mhtv_roundtrip():
    """Zero-init over a shared-table batch, serialized via MHTV mode byte 2."""
    import metalhuffman as mht
    from metalhuffman.models import frame_stream

    frames = _frames(4, 24, 40, seed=5)
    cfg = CodecConfig(zero_init=True)
    blob = mht.encode_video(frames, cfg)
    assert blob[:4] == frame_stream.SHARED_MAGIC
    stream, t, h, w, bd, delta = frame_stream.read_shared(blob)
    assert stream.block_init is not None and delta is True
    np.testing.assert_array_equal(mht.decode_video(blob, cfg), frames)
    # the raw-strips path cannot fold roots: it must refuse, not corrupt
    wide = _frames(2, 16, 1024, seed=6)
    s_w = frame_stream.encode_frames_shared(wide, cfg)
    prep = frame_stream.prepare_shared(s_w, 2, 16, 1024, cfg)
    assert prep.init_grid is not None
    with pytest.raises(ValueError, match="raw"):
        frame_stream.decode_shared_step(prep, cfg, raw=True)
    np.testing.assert_array_equal(
        np.asarray(frame_stream.decode_shared_step(prep, cfg)), wide)


def test_segmented_zero_init_mhv2_roundtrip():
    from metalhuffman.models import frame_stream

    frames = _frames(4, 24, 40, seed=7)
    cfg = CodecConfig(zero_init=True)
    segs = frame_stream.encode_frames_segmented(
        frames, cfg, max_segment_bits=24 * 40 * 16)
    assert len(segs) > 1
    blob = frame_stream.write_segmented(segs, 24, 40, cfg)
    segs2, t, h, w, bd, delta = frame_stream.read_segmented(blob)
    assert all(s.block_init is not None for s, _ in segs2)
    np.testing.assert_array_equal(
        frame_stream.decode_frames_segmented(segs2, 24, 40, cfg), frames)
    # native backend folds roots on the host path too
    np.testing.assert_array_equal(
        frame_stream.decode_frames_segmented(
            segs2, 24, 40, CodecConfig(zero_init=True, backend="native")),
        frames)


def test_batch_zero_init_xla():
    """MHTS batched XLA decode must fold block_init (round-2 review fix)."""
    from metalhuffman.models import frame_stream

    frames = _frames(4, 24, 40, seed=8)
    cfg = CodecConfig(zero_init=True, backend="xla")
    streams = frame_stream.encode_frames(frames, cfg)
    assert all(s.block_init is not None for s in streams)
    prep = frame_stream.prepare_batch(streams, 24, 40, cfg)
    np.testing.assert_array_equal(
        np.asarray(frame_stream.decode_batch(prep, cfg)), frames)


def test_checked_decode_zero_init_folds():
    from metalhuffman.models import frame_stream

    frames = _frames(3, 24, 40, seed=9)
    cfg = CodecConfig(zero_init=True)
    stream = frame_stream.encode_frames_shared(frames, cfg)
    prep = frame_stream.prepare_shared(stream, 3, 24, 40, cfg, check=True)
    out, err = frame_stream.decode_shared_step_checked(prep, cfg)
    assert not err.any()
    np.testing.assert_array_equal(np.asarray(out), frames)

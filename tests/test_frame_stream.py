"""Batched/sharded video decode + MHTS container."""

import numpy as np
import pytest

from metalhuffman.core import blocks
from metalhuffman.models import CodecConfig, frame_stream
from metalhuffman.parallel import mesh as mesh_mod


def _frames(t, h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = []
    for i in range(t):
        img = 100 + 60 * np.sin((xx + 5 * i) / 17.0) * np.cos(yy / 13.0)
        out.append(np.clip(img + rng.normal(0, 2, (h, w)), 0, 255).astype(np.uint8))
    return np.stack(out)


def test_batch_decode_matches_input():
    frames = _frames(5, 48, 64)
    cfg = CodecConfig(backend="xla")
    streams = frame_stream.encode_frames(frames, cfg)
    prep = frame_stream.prepare_batch(streams, 48, 64, cfg)
    out = np.asarray(frame_stream.decode_batch(prep, cfg))
    np.testing.assert_array_equal(out, frames)


def test_mhts_container_roundtrip():
    frames = _frames(3, 32, 40, seed=2)
    cfg = CodecConfig(backend="xla")
    streams = frame_stream.encode_frames(frames, cfg)
    blob = frame_stream.write_stream(streams, 32, 40, cfg)
    streams2, h, w, bd, delta = frame_stream.read_stream(blob)
    assert (h, w, bd, delta) == (32, 40, 8, True)
    assert len(streams2) == 3
    for a, b in zip(streams, streams2):
        np.testing.assert_array_equal(a.code_bytes, b.code_bytes)
        np.testing.assert_array_equal(a.block_offsets, b.block_offsets)
    prep = frame_stream.prepare_batch(streams2, h, w, cfg)
    out = np.asarray(frame_stream.decode_batch(prep, cfg))
    np.testing.assert_array_equal(out, frames)


def test_sharded_batch_decode():
    mesh = mesh_mod.make_mesh_2d(data_parallel=2)  # 2 x 4 on the CPU mesh
    frames = _frames(4, 40, 64, seed=3)
    cfg = CodecConfig(backend="xla")
    streams = frame_stream.encode_frames(frames, cfg)
    prep = frame_stream.prepare_batch(
        streams, 40, 64, cfg, pad_blocks_to=mesh.shape[mesh_mod.SEQ_AXIS]
    )
    out = np.asarray(frame_stream.decode_batch_sharded(prep, mesh, cfg))
    for i in range(4):
        blk = out[i, : prep.n_blocks]
        img = blocks.blocks_to_image(blk, 40, 64)
        np.testing.assert_array_equal(img, frames[i])


def test_empty_and_mismatched_streams_raise():
    with pytest.raises(ValueError):
        frame_stream.read_stream(b"MHTS" + b"\x00" * 4)
    frames = _frames(1, 16, 16)
    cfg = CodecConfig(backend="xla")
    s1 = frame_stream.encode_frames(frames, cfg)
    blob1 = frame_stream.write_stream(s1, 16, 16, cfg)
    blob2 = frame_stream.write_stream(s1, 24, 16, cfg)
    combined = b"MHTS" + (2).to_bytes(4, "little") + blob1[8:] + blob2[8:]
    with pytest.raises(ValueError):
        frame_stream.read_stream(combined)


def test_segmented_encode_splits_and_roundtrips():
    # a tiny max_segment_bits forces multiple segments at whole-frame
    # boundaries; decode pipelines them back together bit-exact
    frames = _frames(5, 16, 32, seed=21)
    cfg = CodecConfig(backend="pallas")
    frame_bits_cap = 16 * 32 * 10  # ~1 frame per segment at 10 bits/sym
    segs = frame_stream.encode_frames_segmented(
        frames, cfg, max_segment_bits=frame_bits_cap)
    assert len(segs) == 5 and all(t == 1 for _, t in segs)
    out = frame_stream.decode_frames_segmented(segs, 16, 32, cfg)
    np.testing.assert_array_equal(out, frames)


def test_segmented_container_roundtrip():
    frames = _frames(6, 16, 24, seed=22)
    cfg = CodecConfig(backend="xla")
    segs = frame_stream.encode_frames_segmented(
        frames, cfg, max_segment_bits=3 * 16 * 24 * 10)
    assert len(segs) >= 2
    blob = frame_stream.write_segmented(segs, 16, 24, cfg)
    segs2, t, h, w, bd, delta = frame_stream.read_segmented(blob)
    assert (t, h, w, bd, delta) == (6, 16, 24, 8, True)
    assert len(segs2) == len(segs)
    for (s1, t1), (s2, t2) in zip(segs, segs2):
        assert t1 == t2
        np.testing.assert_array_equal(s1.code_bytes, s2.code_bytes)
        np.testing.assert_array_equal(s1.block_offsets, s2.block_offsets)
    out = frame_stream.decode_frames_segmented(segs2, 16, 24,
                                               CodecConfig(backend="native"))
    np.testing.assert_array_equal(out, frames)


def test_segmented_single_segment_stays_mhtv():
    import metalhuffman as mht

    frames = _frames(3, 16, 16, seed=23)
    blob = mht.encode_video(frames, CodecConfig(backend="xla"))
    assert blob[:4] == frame_stream.SHARED_MAGIC  # small stream: plain MHTV
    out = mht.decode_video(blob, CodecConfig(backend="xla"))
    np.testing.assert_array_equal(out, frames)


def test_segment_frame_counts_estimator():
    # 10 bits/sym upper bound: segments must provably fit u32 offsets
    counts = frame_stream.segment_frame_counts(1000, 1536 * 2048)
    assert sum(counts) == 1000
    per = counts[0]
    assert per * 1536 * 2048 * 10 < 1 << 32
    assert (per + 1) * 1536 * 2048 * 10 >= 1 << 32  # maximal packing


@pytest.mark.slow
def test_segmented_over_u32_roundtrip_native():
    # VERDICT round-1 item 8 done-criterion: a > 2^32-bit (> 512 MB)
    # compressed stream roundtrips via segmenting. Incompressible noise
    # keeps compressed ~= raw; native host codec handles the volume.
    rng = np.random.default_rng(31)
    t, h, w = 180, 1536, 2048  # ~530 MB compressed (noise, ~8.2 bits/sym)
    frames = rng.integers(0, 256, (t, h, w), np.uint8)
    cfg = CodecConfig(backend="native", delta=False)
    segs = frame_stream.encode_frames_segmented(frames, cfg)
    total_bits = sum(8 * (s.code_bytes.size - 2) for s, _ in segs)
    assert total_bits > 1 << 32, "workload must actually exceed the u32 cap"
    assert len(segs) >= 2
    out = frame_stream.decode_frames_segmented(segs, h, w, cfg)
    np.testing.assert_array_equal(out, frames)


def test_sharded_batch_zero_init():
    """decode_batch_sharded folds block_init into the padded block batch."""
    mesh = mesh_mod.make_mesh_2d(data_parallel=2)
    frames = _frames(4, 40, 64, seed=41)
    cfg = CodecConfig(backend="xla", zero_init=True)
    streams = frame_stream.encode_frames(frames, cfg)
    prep = frame_stream.prepare_batch(
        streams, 40, 64, cfg, pad_blocks_to=mesh.shape[mesh_mod.SEQ_AXIS])
    out = np.asarray(frame_stream.decode_batch_sharded(prep, mesh, cfg))
    for i in range(4):
        img = blocks.blocks_to_image(out[i, : prep.n_blocks], 40, 64)
        np.testing.assert_array_equal(img, frames[i])


def test_empty_frame_stack_raises():
    with pytest.raises(ValueError, match="empty"):
        frame_stream.encode_frames_segmented(
            np.zeros((0, 16, 16), np.uint8), CodecConfig())


def test_segmented_checked_decode():
    """check=True verifies per segment and names the corrupt one."""
    import dataclasses

    frames = _frames(4, 16, 32, seed=42)
    cfg = CodecConfig(backend="pallas")
    segs = frame_stream.encode_frames_segmented(
        frames, cfg, max_segment_bits=2 * 16 * 32 * 16)
    assert len(segs) >= 2
    out = frame_stream.decode_frames_segmented(segs, 16, 32, cfg, check=True)
    np.testing.assert_array_equal(out, frames)

    s1, t1 = segs[1]
    code = s1.code_bytes.copy()
    code[int(s1.block_offsets[2]) // 8 + 2 :][:8] = 0xFF
    bad = dataclasses.replace(s1, code_bytes=code)
    with pytest.raises(ValueError, match="segment 1"):
        frame_stream.decode_frames_segmented(
            [segs[0], (bad, t1)] + segs[2:], 16, 32, cfg, check=True)
    with pytest.raises(ValueError, match="pallas"):
        frame_stream.decode_frames_segmented(
            segs, 16, 32, CodecConfig(backend="native"), check=True)


def test_pipeline_keeps_two_segments_in_flight(monkeypatch):
    """The segment pipeline drains at depth 2 (not 3 — review finding)."""
    frames = _frames(6, 16, 32, seed=43)
    cfg = CodecConfig(backend="pallas")
    segs = frame_stream.encode_frames_segmented(
        frames, cfg, max_segment_bits=16 * 32 * 10)
    assert len(segs) == 6
    depth = {"max": 0, "cur": 0}
    orig_submit = frame_stream.StreamingDecoder.submit
    orig_result = frame_stream.StreamingDecoder.result

    def submit(self, *a, **k):
        depth["cur"] += 1
        depth["max"] = max(depth["max"], depth["cur"])
        return orig_submit(self, *a, **k)

    def result(self, handle):
        depth["cur"] -= 1
        return orig_result(self, handle)

    monkeypatch.setattr(frame_stream.StreamingDecoder, "submit", submit)
    monkeypatch.setattr(frame_stream.StreamingDecoder, "result", result)
    out = frame_stream.decode_frames_segmented(segs, 16, 32, cfg)
    np.testing.assert_array_equal(out, frames)
    assert depth["max"] == 2

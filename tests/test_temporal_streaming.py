"""TemporalStreamingEncoder + the MHVT trailer layout (round-5 item 1).

The round-4 verdict's top gap: temporal (MHVT) encode could not stream —
the classic layout carries the motion table and inner length in its
header. The trailer layout (``temporal.FLAG_TRAILER``) moves those after
the inner, so the streaming writer holds ONE previous true frame and
back-patches a single u64. Contracts under test:

- the streamed file is byte-identical to ``temporal.wrap(batch_inner,
  ..., trailer=True)`` of the same content at the same segmentation,
  regardless of push() chunking, for gray / motion / color / u16;
- every existing decode surface reads the trailer layout through the
  layout-agnostic ``unwrap`` (full decode, random access, streaming
  decode, region, verify, surgery);
- truncation/corruption raise clean errors, and the no-torn-container
  contract holds for the new writer.
"""

import io
import zlib

import numpy as np
import pytest

from metalhuffman.models import CodecConfig, color, frame_stream, temporal
from metalhuffman.models.stream_writer import (
    ColorStreamingEncoder,
    StreamingEncoder,
    TemporalStreamingEncoder,
)

NATIVE = CodecConfig(backend="native")


def _frames(t, h, w, seed=0, pan=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = []
    for i in range(t):
        img = 100 + 60 * np.sin((xx + pan * i) / 17.0) * np.cos(yy / 13.0)
        out.append(np.clip(img + rng.normal(0, 2, (h, w)), 0,
                           255).astype(np.uint8))
    return np.stack(out)


def _stream_gray(frames, cfg, per, chunks, frame_crcs=False):
    sink = io.BytesIO()
    with TemporalStreamingEncoder(sink, frames.shape[1], frames.shape[2],
                                  cfg, max_segment_frames=per,
                                  frame_crcs=frame_crcs) as enc:
        start = 0
        for n in chunks:
            enc.push(frames[start : start + n])
            start += n
    return sink.getvalue(), enc.stats


def _batch_trailer_gray(frames, cfg, per, frame_crcs=False):
    """The batch machinery's bytes in the trailer layout at segment cap
    ``per`` — what the streamed file must equal."""
    if cfg.motion:
        res, mvs = temporal.temporal_encode_mc(frames, cfg.keyint)
    else:
        res, mvs = temporal.temporal_encode(frames, cfg.keyint), None
    inner = io.BytesIO()
    with StreamingEncoder(inner, frames.shape[1], frames.shape[2],
                          temporal._inner_config(cfg),
                          max_segment_frames=per) as ie:
        ie.push(res)
    fcrcs = (frame_stream.compute_frame_crcs(frames) if frame_crcs
             else None)
    return temporal.wrap(inner.getvalue(), cfg.keyint,
                         source_crc32=zlib.crc32(frames.tobytes()),
                         mvs=mvs, frame_crcs=fcrcs, trailer=True)


@pytest.mark.parametrize("chunks", [[11], [1] * 11, [4, 1, 3, 2, 1]])
@pytest.mark.parametrize("motion", [False, True], ids=["plain", "mc"])
def test_gray_byte_identical_to_batch_trailer(motion, chunks):
    frames = _frames(11, 48, 64, pan=5 if motion else 0)
    cfg = CodecConfig(backend="native", temporal=True, motion=motion,
                      keyint=4)
    streamed, stats = _stream_gray(frames, cfg, 3, chunks, frame_crcs=True)
    want = _batch_trailer_gray(frames, cfg, 3, frame_crcs=True)
    assert streamed == want
    assert stats.total_frames == 11
    assert stats.source_crc32 == zlib.crc32(frames.tobytes())


def test_trailer_and_header_layouts_unwrap_identically():
    frames = _frames(9, 32, 32, seed=2)
    cfg = CodecConfig(backend="native", temporal=True, motion=True,
                      keyint=3)
    res, mvs = temporal.temporal_encode_mc(frames, 3)
    from metalhuffman import encode_video

    inner = encode_video(res, temporal._inner_config(cfg))
    fcrcs = frame_stream.compute_frame_crcs(frames)
    crc = zlib.crc32(frames.tobytes())
    head = temporal.wrap(inner, 3, crc, mvs=mvs, frame_crcs=fcrcs)
    trail = temporal.wrap(inner, 3, crc, mvs=mvs, frame_crcs=fcrcs,
                          trailer=True)
    assert head != trail  # genuinely different byte layouts
    uh, ut = temporal.unwrap(head), temporal.unwrap(trail)
    assert uh[0] == ut[0] and uh[1] == ut[1] and uh[2] == ut[2]
    np.testing.assert_array_equal(uh[3], ut[3])
    np.testing.assert_array_equal(uh[4], ut[4])
    assert uh[5] == ut[5]
    # and both reconstruct
    np.testing.assert_array_equal(
        temporal.decode_temporal_video(trail, NATIVE), frames)


def test_every_decode_surface_reads_trailer_layout():
    frames = _frames(13, 40, 48, seed=5)
    cfg = CodecConfig(backend="native", temporal=True, keyint=4)
    blob, _ = _stream_gray(frames, cfg, 3, [13], frame_crcs=True)
    # full decode
    np.testing.assert_array_equal(
        temporal.decode_temporal_video(blob, NATIVE), frames)
    # random access (mid-group, straddling segments)
    np.testing.assert_array_equal(
        temporal.decode_temporal_frame(blob, 6, NATIVE), frames[6])
    np.testing.assert_array_equal(
        temporal.decode_temporal_range(blob, 5, 11, NATIVE), frames[5:11])
    # streaming decode
    chunks = [c for _, c in temporal.iter_temporal_video(
        blob, NATIVE, chunk_frames=5)]
    np.testing.assert_array_equal(np.concatenate(chunks), frames)
    # spatio-temporal ROI
    roi = temporal.decode_temporal_video_region(blob, 2, 9, 8, 16, 16, 24,
                                                NATIVE)
    np.testing.assert_array_equal(roi, frames[2:9, 8:24, 16:40])
    # describe flags the layout
    assert "trailer" in temporal.describe(blob)


def test_device_backend_reads_trailer_layout():
    frames = _frames(8, 32, 32, seed=7)
    cfg = CodecConfig(backend="native", temporal=True, motion=True,
                      keyint=4)
    blob, _ = _stream_gray(frames, cfg, 4, [8])
    out = temporal.decode_temporal_video(
        blob, CodecConfig(backend="pallas"))
    np.testing.assert_array_equal(out, frames)


def test_color_and_u16_byte_identity_and_roundtrip():
    rng = np.random.default_rng(11)
    # color, sub-green
    cframes = (rng.integers(0, 30, (7, 24, 24, 3))
               + np.arange(7)[:, None, None, None] * 2).astype(np.uint8)
    cfg = CodecConfig(backend="native", temporal=True, keyint=3)
    sink = io.BytesIO()
    with TemporalStreamingEncoder(sink, 24, 24, cfg, channels=3,
                                  colorspace=color.CS_SUBGREEN,
                                  max_segment_frames=2) as enc:
        enc.push(cframes[:4])
        enc.push(cframes[4:])
    streamed = sink.getvalue()
    res = temporal.temporal_encode(cframes, 3)
    inner = io.BytesIO()
    with ColorStreamingEncoder(inner, 24, 24, channels=3,
                               config=temporal._inner_config(cfg),
                               colorspace=color.CS_SUBGREEN,
                               max_segment_frames=2) as ie:
        ie.push(res)
    want = temporal.wrap(inner.getvalue(), 3,
                         source_crc32=zlib.crc32(cframes.tobytes()),
                         trailer=True)
    assert streamed == want
    np.testing.assert_array_equal(
        temporal.decode_temporal_video(streamed, NATIVE), cframes)

    # u16: residuals mod 65536 on the u16 values, then hi/lo planes
    uframes = (rng.integers(0, 2000, (6, 24, 24))
               + np.arange(6)[:, None, None] * 9).astype(np.uint16)
    sink = io.BytesIO()
    with TemporalStreamingEncoder(sink, 24, 24, cfg, u16=True,
                                  max_segment_frames=2) as enc:
        for f in uframes:
            enc.push(f)
    streamed = sink.getvalue()
    resu = temporal.temporal_encode(uframes, 3)
    inner = io.BytesIO()
    with ColorStreamingEncoder(inner, 24, 24, u16=True,
                               config=temporal._inner_config(cfg),
                               max_segment_frames=2) as ie:
        ie.push(resu)
    want = temporal.wrap(inner.getvalue(), 3,
                         source_crc32=zlib.crc32(uframes.tobytes()),
                         trailer=True)
    assert streamed == want
    out = temporal.decode_temporal_video(streamed, NATIVE)
    assert out.dtype == np.uint16
    np.testing.assert_array_equal(out, uframes)


def test_surgery_reads_trailer_layout():
    from metalhuffman.models import surgery

    frames = _frames(12, 32, 32, seed=13)
    cfg = CodecConfig(backend="native", temporal=True, keyint=4)
    blob, _ = _stream_gray(frames, cfg, 3, [12], frame_crcs=True)
    # keyframe-aligned extract is lossless; output normalizes to the
    # header layout (documented) but must reconstruct identically
    ext = surgery.extract_video(blob, 4, 12)
    np.testing.assert_array_equal(
        temporal.decode_temporal_video(ext, NATIVE), frames[4:12])
    # arbitrary-start extract (re-keys the first group)
    ext2 = surgery.extract_video(blob, 6, 11)
    np.testing.assert_array_equal(
        temporal.decode_temporal_video(ext2, NATIVE), frames[6:11])
    # concat of two trailer-layout files
    more = _frames(8, 32, 32, seed=14)
    blob2, _ = _stream_gray(more, cfg, 3, [8], frame_crcs=True)
    cat = surgery.concat_videos([blob, blob2])
    np.testing.assert_array_equal(
        temporal.decode_temporal_video(cat, NATIVE),
        np.concatenate([frames, more]))
    # resegment keeps reconstruction
    reseg = surgery.resegment_video(blob, 2)
    np.testing.assert_array_equal(
        temporal.decode_temporal_video(reseg, NATIVE), frames)


def test_trailer_layout_robustness():
    frames = _frames(6, 16, 16, seed=17)
    cfg = CodecConfig(backend="native", temporal=True, motion=True,
                      keyint=3)
    blob, _ = _stream_gray(frames, cfg, 2, [6], frame_crcs=True)
    # every truncation point raises a clean ValueError (or decodes fine
    # for the full length); never an IndexError/struct.error
    for cut in list(range(4, 40)) + [len(blob) - 5, len(blob) - 1]:
        with pytest.raises(ValueError):
            temporal.decode_temporal_video(blob[:cut], NATIVE)
    # INNER64 + TRAILER is rejected as corrupt
    import struct

    keyint, flags, il = struct.unpack_from("<HHI", blob, 4)
    bad = bytearray(blob)
    struct.pack_into("<HHI", bad, 4, keyint,
                     flags | temporal.FLAG_INNER64, il)
    with pytest.raises(ValueError, match="INNER64"):
        temporal.unwrap(bytes(bad))
    # unknown flag bits are rejected
    struct.pack_into("<HHI", bad, 4, keyint, flags | 0x8000, il)
    with pytest.raises(ValueError, match="unknown flags"):
        temporal.unwrap(bytes(bad))
    # single header bit flips either fail cleanly or decode to the truth
    rng = np.random.default_rng(19)
    for _ in range(40):
        pos = int(rng.integers(4, 30))
        bit = 1 << int(rng.integers(0, 8))
        mut = bytearray(blob)
        mut[pos] ^= bit
        try:
            out = temporal.decode_temporal_video(bytes(mut), NATIVE)
            np.testing.assert_array_equal(out, frames)
        except ValueError:
            pass  # clean rejection


def test_streamed_temporal_abort_and_failed_close(tmp_path):
    frames = _frames(5, 16, 16, seed=23)
    cfg = CodecConfig(backend="native", temporal=True, keyint=2)
    p = tmp_path / "aborted.mhvt"
    try:
        with TemporalStreamingEncoder(p, 16, 16, cfg,
                                      max_segment_frames=2) as enc:
            enc.push(frames)
            raise RuntimeError("producer failure")
    except RuntimeError:
        pass
    assert p.read_bytes() == b""
    # failed close (empty stream) truncates everything incl. MHVT header
    p2 = tmp_path / "empty.mhvt"
    enc = TemporalStreamingEncoder(p2, 16, 16, cfg)
    with pytest.raises(ValueError, match="empty"):
        enc.close()
    assert p2.read_bytes() == b""


def test_streamed_temporal_push_failure_truncates(tmp_path, monkeypatch):
    frames = _frames(4, 16, 16, seed=27)
    cfg = CodecConfig(backend="native", temporal=True, keyint=2)
    p = tmp_path / "torn.mhvt"
    enc = TemporalStreamingEncoder(p, 16, 16, cfg, max_segment_frames=1)
    enc.push(frames[:2])

    def boom(*_a, **_k):
        raise RuntimeError("simulated encode failure")

    monkeypatch.setattr(frame_stream, "encode_frames_shared", boom)
    with pytest.raises(RuntimeError, match="simulated"):
        enc.push(frames[2:])
    assert p.read_bytes() == b""
    with pytest.raises(ValueError, match="close"):
        enc.push(frames[:1])


def test_validation_before_state_change():
    cfg = CodecConfig(backend="native", temporal=True, keyint=2)
    sink = io.BytesIO()
    frames = _frames(4, 16, 16, seed=29)
    with TemporalStreamingEncoder(sink, 16, 16, cfg,
                                  max_segment_frames=2) as enc:
        enc.push(frames[:2])
        with pytest.raises(ValueError, match="expected"):
            enc.push(np.zeros((8, 8), np.uint8))
        with pytest.raises(ValueError, match="uint8"):
            enc.push(frames[2:].astype(np.uint16))
        enc.push(frames[2:])  # still alive
    np.testing.assert_array_equal(
        temporal.decode_temporal_video(sink.getvalue(), NATIVE), frames)


def test_cli_streaming_temporal_roundtrip_and_verify(tmp_path):
    from metalhuffman import cli

    frames = _frames(10, 32, 32, seed=31, pan=4)
    src = tmp_path / "f.npy"
    np.save(src, frames)
    out = tmp_path / "t.mhvt"
    assert cli.main(["encode-video", str(src), str(out), "--streaming",
                     "--temporal", "--motion", "--keyint", "4",
                     "--frame-crcs", "--segment-frames", "3",
                     "--backend", "native"]) == 0
    # streamed file == library writer at the same capacity
    sink = io.BytesIO()
    cfg = CodecConfig(backend="native", temporal=True, motion=True,
                      keyint=4)
    with TemporalStreamingEncoder(sink, 32, 32, cfg,
                                  max_segment_frames=3,
                                  frame_crcs=True) as enc:
        enc.push(frames)
    assert out.read_bytes() == sink.getvalue()
    # decode surfaces: batch, streamed, random access, verify (both)
    dec = tmp_path / "d.npy"
    assert cli.main(["decode-video", str(out), str(dec),
                     "--backend", "native"]) == 0
    np.testing.assert_array_equal(np.load(dec), frames)
    assert cli.main(["decode-video", str(out), str(dec), "--streaming",
                     "--backend", "native"]) == 0
    np.testing.assert_array_equal(np.load(dec), frames)
    assert cli.main(["decode-video", str(out), str(dec), "--frame", "7",
                     "--check", "--backend", "native"]) == 0
    np.testing.assert_array_equal(np.load(dec), frames[7])
    assert cli.main(["verify", str(out), "--backend", "native"]) == 0
    assert cli.main(["verify", str(out), "--streaming",
                     "--backend", "native"]) == 0
    # corrupt outer CRC: streamed verify must fail
    bad = tmp_path / "bad.mhvt"
    data = bytearray(out.read_bytes())
    data[-1] ^= 0x5A
    bad.write_bytes(bytes(data))
    with pytest.raises(SystemExit, match="CRC"):
        cli.main(["verify", str(bad), "--streaming",
                  "--backend", "native"])


def test_cli_streaming_temporal_color_u16(tmp_path):
    from metalhuffman import cli

    rng = np.random.default_rng(37)
    col = (rng.integers(0, 40, (8, 24, 24, 3))
           + np.arange(8, dtype=np.uint8)[:, None, None, None]
           ).astype(np.uint8)
    src = tmp_path / "c.npy"
    np.save(src, col)
    out = tmp_path / "c.mhvt"
    assert cli.main(["encode-video", str(src), str(out), "--streaming",
                     "--temporal", "--color", "--subgreen", "--keyint",
                     "3", "--segment-frames", "2",
                     "--backend", "native"]) == 0
    dec = tmp_path / "c_out.npy"
    assert cli.main(["decode-video", str(out), str(dec), "--streaming",
                     "--backend", "native"]) == 0
    np.testing.assert_array_equal(np.load(dec), col)

    u16 = (rng.integers(0, 3000, (6, 24, 24))).astype(np.uint16)
    src2 = tmp_path / "u.npy"
    np.save(src2, u16)
    out2 = tmp_path / "u.mhvt"
    assert cli.main(["encode-video", str(src2), str(out2), "--streaming",
                     "--temporal", "--gray16", "--keyint", "2",
                     "--segment-frames", "2", "--backend", "native"]) == 0
    dec2 = tmp_path / "u_out.npy"
    assert cli.main(["decode-video", str(out2), str(dec2), "--streaming",
                     "--backend", "native"]) == 0
    np.testing.assert_array_equal(np.load(dec2), u16)
    assert cli.main(["verify", str(out2), "--streaming",
                     "--backend", "native"]) == 0


def test_verify_streaming_refuses_checkless_mhvt(tmp_path):
    """Round-5 review finding: an MHVT recording neither CRC must not
    PASS a streamed verify that checked nothing."""
    from metalhuffman import cli
    from metalhuffman import encode_video

    frames = _frames(4, 16, 16, seed=41)
    cfg = CodecConfig(backend="native")
    inner = encode_video(temporal.temporal_encode(frames, 2),
                         temporal._inner_config(cfg))
    blob = temporal.wrap(inner, 2, source_crc32=0)  # no CRCs anywhere
    p = tmp_path / "nocrc.mhvt"
    p.write_bytes(blob)
    with pytest.raises(SystemExit, match="nothing to check"):
        cli.main(["verify", str(p), "--streaming", "--backend", "native"])
    # the batch verify still covers it
    assert cli.main(["verify", str(p), "--backend", "native"]) == 0

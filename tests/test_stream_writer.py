"""StreamingEncoder: push-frames MHV2 writer, byte-identical to batch.

The contract under test (stream_writer.py docstring): for the same frames,
config, and segment capacity, the streamed file equals the batch
``write_segmented(encode_frames_segmented(...))`` bytes exactly, no matter
how the frames were chunked across push() calls.
"""

import io
import zlib

import numpy as np
import pytest

from metalhuffman.models import CodecConfig, frame_stream
from metalhuffman.models.stream_writer import StreamingEncoder


def _frames(t, h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = []
    for i in range(t):
        img = 100 + 60 * np.sin((xx + 5 * i) / 17.0) * np.cos(yy / 13.0)
        out.append(np.clip(img + rng.normal(0, 2, (h, w)), 0,
                           255).astype(np.uint8))
    return np.stack(out)


def _batch_bytes(frames, cfg, max_segment_bits, frame_crcs=False):
    t, h, w = frames.shape
    segs = frame_stream.encode_frames_segmented(
        frames, cfg, max_segment_bits=max_segment_bits)
    crc = zlib.crc32(np.ascontiguousarray(frames).tobytes())
    fcrcs = frame_stream.compute_frame_crcs(frames) if frame_crcs else None
    return frame_stream.write_segmented(
        segs, h, w, cfg, source_crc32=crc, frame_crcs=fcrcs)


def _segment_bits_for(per, h, w, cfg):
    """max_segment_bits that yields exactly ``per`` frames per segment."""
    from metalhuffman.core import blocks

    bh, bw = blocks.block_grid(h, w, cfg.block_dim)
    fs = bh * bw * cfg.block_size
    return per * fs * frame_stream._SEG_BITS_PER_SYMBOL


@pytest.mark.parametrize("chunks", [[7], [1] * 7, [3, 1, 2, 1], [2, 5]])
@pytest.mark.parametrize(
    "cfg",
    [CodecConfig(), CodecConfig(delta=False),
     CodecConfig(delta2d=True), CodecConfig(zero_init=True)],
    ids=["delta", "plain", "delta2d", "zero_init"],
)
def test_byte_identical_to_batch(cfg, chunks):
    frames = _frames(7, 24, 40)
    bits = _segment_bits_for(3, 24, 40, cfg)  # -> segments of 3, 3, 1
    want = _batch_bytes(frames, cfg, bits)

    sink = io.BytesIO()
    enc = StreamingEncoder(sink, 24, 40, cfg, max_segment_bits=bits)
    start = 0
    for n in chunks:
        enc.push(frames[start : start + n])
        start += n
    stats = enc.close()
    assert sink.getvalue() == want
    assert stats.total_frames == 7
    assert stats.num_segments == 3
    assert stats.bytes_written == len(want)
    assert stats.source_crc32 == zlib.crc32(frames.tobytes())


def test_frame_crc_table_identical_and_readable():
    frames = _frames(5, 16, 16, seed=3)
    cfg = CodecConfig()
    bits = _segment_bits_for(2, 16, 16, cfg)
    want = _batch_bytes(frames, cfg, bits, frame_crcs=True)

    sink = io.BytesIO()
    with StreamingEncoder(sink, 16, 16, cfg, max_segment_bits=bits,
                          frame_crcs=True) as enc:
        for f in frames:
            enc.push(f)  # single (H, W) frame form
    data = sink.getvalue()
    assert data == want
    fcrcs = frame_stream.read_frame_crcs(data)
    np.testing.assert_array_equal(
        fcrcs, frame_stream.compute_frame_crcs(frames))


def test_max_segment_frames_matches_equivalent_batch():
    frames = _frames(6, 16, 16, seed=5)
    cfg = CodecConfig()
    # cap at 2 frames/segment; batch equivalent = bits for per=2
    want = _batch_bytes(frames, cfg, _segment_bits_for(2, 16, 16, cfg))
    sink = io.BytesIO()
    with StreamingEncoder(sink, 16, 16, cfg,
                          max_segment_frames=2) as enc:
        enc.push(frames)
    assert sink.getvalue() == want


def test_roundtrip_via_file_and_decode(tmp_path):
    frames = _frames(5, 24, 24, seed=9)
    cfg = CodecConfig(backend="native")
    path = tmp_path / "out.mhv2"
    with StreamingEncoder(path, 24, 24, cfg,
                          max_segment_frames=2) as enc:
        enc.push(frames[:4])
        enc.push(frames[4])
    data = path.read_bytes()
    segs, t, h, w, bd, delta = frame_stream.read_segmented(data)
    assert (t, h, w, len(segs)) == (5, 24, 24, 3)
    out = frame_stream.decode_frames_segmented(segs, h, w, cfg)
    np.testing.assert_array_equal(out, frames)
    assert frame_stream.source_crc32(data) == zlib.crc32(frames.tobytes())


def test_single_segment_is_one_segment_mhv2(tmp_path):
    # fits one segment: still a (valid, universally decodable) MHV2
    frames = _frames(3, 16, 16)
    cfg = CodecConfig(backend="native")
    path = tmp_path / "one.mhv2"
    with StreamingEncoder(path, 16, 16, cfg) as enc:
        enc.push(frames)
    segs, t, h, w, _, _ = frame_stream.read_segmented(path.read_bytes())
    assert len(segs) == 1 and t == 3
    out = frame_stream.decode_frames_segmented(segs, h, w, cfg)
    np.testing.assert_array_equal(out, frames)


def test_validation_errors():
    with pytest.raises(ValueError, match="temporal"):
        StreamingEncoder(io.BytesIO(), 16, 16, CodecConfig(temporal=True))
    with pytest.raises(ValueError, match="delta precoding"):
        StreamingEncoder(io.BytesIO(), 16, 16,
                         CodecConfig(delta=False, zero_init=True))
    with pytest.raises(ValueError, match="positive"):
        StreamingEncoder(io.BytesIO(), 0, 16)

    enc = StreamingEncoder(io.BytesIO(), 16, 16)
    with pytest.raises(ValueError, match="expected"):
        enc.push(np.zeros((8, 8), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        enc.push(np.zeros((16, 16), np.uint16))
    with pytest.raises(ValueError, match="empty"):
        enc.close()
    with pytest.raises(ValueError, match="after close"):
        enc.push(np.zeros((16, 16), np.uint8))
    # close() is idempotent once failed-closed? No: a failed close stays
    # closed; a *successful* close is idempotent:
    sink = io.BytesIO()
    enc2 = StreamingEncoder(sink, 16, 16)
    enc2.push(_frames(1, 16, 16))
    s1 = enc2.close()
    assert enc2.close() is s1


def test_failed_close_truncates_sink():
    sink = io.BytesIO()
    enc = StreamingEncoder(sink, 16, 16)
    with pytest.raises(ValueError, match="empty"):
        enc.close()
    assert sink.getvalue() == b""  # no zero-frame torn container


def test_failed_close_after_abort_raises_cleanly():
    sink = io.BytesIO()
    enc = StreamingEncoder(sink, 16, 16)
    with pytest.raises(ValueError, match="empty"):
        enc.close()
    with pytest.raises(ValueError, match="failed close"):
        enc.close()  # second close after failure: a real error, no assert


def test_color_failed_close_and_init_leave_no_torn_header(tmp_path):
    from metalhuffman.models.stream_writer import ColorStreamingEncoder

    p = tmp_path / "torn.mhtc"
    enc = ColorStreamingEncoder(p, 16, 16, channels=3)
    with pytest.raises(ValueError, match="empty"):
        enc.close()
    assert p.read_bytes() == b""  # not an 8-byte MHTC header

    p2 = tmp_path / "init.mhtc"
    with pytest.raises(ValueError, match="temporal"):
        ColorStreamingEncoder(p2, 16, 16, channels=3,
                              config=CodecConfig(temporal=True))
    assert p2.read_bytes() == b""  # inner ctor refused: header rolled back


def test_push_drains_at_segment_granularity():
    """One big push must never buffer more than one segment of frames."""

    class Probe(StreamingEncoder):
        max_buf = 0

        def _emit(self, take):
            self.max_buf = max(self.max_buf, len(self._buf))
            super()._emit(take)

    frames = _frames(20, 16, 16, seed=41)
    enc = Probe(io.BytesIO(), 16, 16, max_segment_frames=4)
    enc.push(frames)
    enc.close()
    assert enc.max_buf <= enc.segment_frames


def test_cli_streaming_decode_failure_leaves_no_output(tmp_path):
    from metalhuffman import cli

    frames = _frames(4, 16, 16, seed=43)
    src = tmp_path / "f.npy"
    np.save(src, frames)
    mhv2 = tmp_path / "s.mhv2"
    assert cli.main(["encode-video", str(src), str(mhv2), "--streaming",
                     "--segment-frames", "2"]) == 0
    data = bytearray(mhv2.read_bytes())
    data[frame_stream._trailer_offset(bytes(data))] ^= 0x5A  # recorded CRC
    bad = tmp_path / "bad.mhv2"
    bad.write_bytes(bytes(data))
    dec = tmp_path / "d.npy"
    with pytest.raises(SystemExit, match="CRC"):
        cli.main(["decode-video", str(bad), str(dec), "--streaming",
                  "--backend", "native"])
    assert not dec.exists()  # corrupt output not left behind
    outdir = tmp_path / "pngs"
    with pytest.raises(SystemExit, match="CRC"):
        cli.main(["decode-video", str(bad), str(outdir), "--streaming",
                  "--backend", "native"])
    assert not list(outdir.glob("frame_*.png"))


def test_cli_segment_frames_zero_is_clean_error(tmp_path):
    from metalhuffman import cli

    src = tmp_path / "f.npy"
    np.save(src, _frames(2, 16, 16))
    with pytest.raises(SystemExit, match="segment-frames"):
        cli.main(["encode-video", str(src), str(tmp_path / "o.mhv2"),
                  "--streaming", "--segment-frames", "0"])


def test_non_seekable_sink_refused():
    class NoSeek(io.BytesIO):
        def seekable(self):
            return False

    with pytest.raises(ValueError, match="seekable"):
        StreamingEncoder(NoSeek(), 16, 16)


def test_abort_truncates(tmp_path):
    frames = _frames(4, 16, 16)
    path = tmp_path / "aborted.mhv2"
    try:
        with StreamingEncoder(path, 16, 16,
                              max_segment_frames=2) as enc:
            enc.push(frames)  # two full segments written
            raise RuntimeError("simulated producer failure")
    except RuntimeError:
        pass
    assert path.read_bytes() == b""  # no torn container left behind


def test_cli_streaming_encode_roundtrip(tmp_path):
    from metalhuffman import cli

    frames = _frames(9, 32, 48, seed=4)
    src = tmp_path / "f.npy"
    np.save(src, frames)
    out = tmp_path / "s.mhv2"
    dec = tmp_path / "d.npy"
    assert cli.main([
        "encode-video", str(src), str(out), "--streaming",
        "--segment-frames", "4", "--frame-crcs"]) == 0
    assert cli.main(["verify", str(out), "--backend", "native"]) == 0
    assert cli.main(["decode-video", str(out), str(dec),
                     "--backend", "native"]) == 0
    np.testing.assert_array_equal(np.load(dec), frames)
    # byte-identity with the library writer at the same capacity
    sink = io.BytesIO()
    with StreamingEncoder(sink, 32, 48, CodecConfig(),
                          max_segment_frames=4, frame_crcs=True) as enc:
        enc.push(frames)
    assert out.read_bytes() == sink.getvalue()


def test_cli_streaming_directory_input(tmp_path):
    from metalhuffman import cli
    from metalhuffman.utils import imageio

    frames = _frames(3, 16, 24, seed=8)
    d = tmp_path / "imgs"
    d.mkdir()
    for i, f in enumerate(frames):
        imageio.save_grayscale(f, d / f"frame_{i:03d}.png")
    out = tmp_path / "dir.mhv2"
    assert cli.main(["encode-video", str(d), str(out), "--streaming"]) == 0
    cfg = CodecConfig(backend="native")
    decoded, h, w = frame_stream.decode_range(out.read_bytes(), 0, 3, cfg)
    np.testing.assert_array_equal(decoded, frames)


def test_cli_streaming_refuses_whole_sequence_flags(tmp_path):
    from metalhuffman import cli

    src = tmp_path / "f.npy"
    np.save(src, _frames(2, 16, 16))
    out = tmp_path / "x.mhv2"
    # (--temporal and --per-frame-tables stream since round 5)
    for extra in (["--best"], ["--best-fast"]):
        with pytest.raises(SystemExit, match="streaming"):
            cli.main(["encode-video", str(src), str(out),
                      "--streaming", *extra])
    # --motion still implies --temporal, streaming or not
    with pytest.raises(SystemExit, match="temporal"):
        cli.main(["encode-video", str(src), str(out),
                  "--streaming", "--motion"])
    with pytest.raises(SystemExit, match="streaming"):
        cli.main(["encode-video", str(src), str(out),
                  "--segment-frames", "2"])


def test_cli_streaming_decode_npy_and_dir(tmp_path):
    from metalhuffman import cli
    from metalhuffman.utils import imageio

    frames = _frames(7, 24, 32, seed=13)
    src = tmp_path / "f.npy"
    np.save(src, frames)
    mhv2 = tmp_path / "s.mhv2"
    assert cli.main(["encode-video", str(src), str(mhv2), "--streaming",
                     "--segment-frames", "3"]) == 0
    dec = tmp_path / "d.npy"
    assert cli.main(["decode-video", str(mhv2), str(dec), "--streaming",
                     "--backend", "native"]) == 0
    np.testing.assert_array_equal(np.load(dec), frames)
    outdir = tmp_path / "pngs"
    assert cli.main(["decode-video", str(mhv2), str(outdir), "--streaming",
                     "--backend", "native"]) == 0
    got = np.stack([imageio.load_grayscale(outdir / f"frame_{i:05d}.png")
                    for i in range(7)])
    np.testing.assert_array_equal(got, frames)


def test_cli_streaming_decode_checked_and_salvage(tmp_path):
    """--streaming composes with --check/--salvage (per-segment, on-device)."""
    from metalhuffman import cli

    frames = _frames(4, 16, 16, seed=15)
    src = tmp_path / "f.npy"
    np.save(src, frames)
    mhv2 = tmp_path / "s.mhv2"
    assert cli.main(["encode-video", str(src), str(mhv2), "--streaming",
                     "--segment-frames", "2"]) == 0
    dec = tmp_path / "d.npy"
    assert cli.main(["decode-video", str(mhv2), str(dec), "--streaming",
                     "--check", "--backend", "pallas", "--interpret"]) == 0
    np.testing.assert_array_equal(np.load(dec), frames)
    # flip the FIRST code byte of segment 0 (MHV2 header 4+18, segment
    # header 12, core blob header 8 + 256-byte width table): desyncs
    # block 0, so the on-device end-bit check flags it — --check fails,
    # --check --salvage zero-fills and completes
    data = bytearray(mhv2.read_bytes())
    data[4 + 18 + 12 + 8 + 256] ^= 0xFF
    bad = tmp_path / "bad.mhv2"
    bad.write_bytes(bytes(data))
    with pytest.raises(SystemExit):
        cli.main(["decode-video", str(bad), str(dec), "--streaming",
                  "--check", "--backend", "pallas", "--interpret"])
    assert cli.main(["decode-video", str(bad), str(dec), "--streaming",
                     "--check", "--salvage", "--backend", "pallas",
                     "--interpret"]) == 0


def test_cli_streaming_decode_refusals(tmp_path):
    from metalhuffman import cli

    frames = _frames(2, 16, 16)
    src = tmp_path / "f.npy"
    np.save(src, frames)
    mhtv = tmp_path / "x.mhtv"
    assert cli.main(["encode-video", str(src), str(mhtv)]) == 0
    with pytest.raises(SystemExit, match="segmented MHV2"):
        cli.main(["decode-video", str(mhtv), str(tmp_path / "o.npy"),
                  "--streaming", "--backend", "native"])
    mhv2 = tmp_path / "x.mhv2"
    assert cli.main(["encode-video", str(src), str(mhv2), "--streaming",
                     "--segment-frames", "1"]) == 0
    with pytest.raises(SystemExit, match="random access"):
        cli.main(["decode-video", str(mhv2), str(tmp_path / "o.npy"),
                  "--streaming", "--frame", "0", "--backend", "native"])


def test_cli_streaming_decode_crc_catches_silent_corruption(tmp_path):
    """The streamed chained CRC equals the recorded whole-payload CRC."""
    from metalhuffman import cli

    frames = _frames(4, 16, 16, seed=17)
    src = tmp_path / "f.npy"
    np.save(src, frames)
    mhv2 = tmp_path / "s.mhv2"
    assert cli.main(["encode-video", str(src), str(mhv2), "--streaming",
                     "--segment-frames", "2"]) == 0
    # corrupt the recorded source CRC itself -> decode output is fine but
    # the recorded value mismatches -> streamed verify must fail
    data = bytearray(mhv2.read_bytes())
    crc_off = frame_stream._trailer_offset(bytes(data))
    data[crc_off] ^= 0x5A
    bad = tmp_path / "bad.mhv2"
    bad.write_bytes(bytes(data))
    with pytest.raises(SystemExit, match="CRC"):
        cli.main(["decode-video", str(bad), str(tmp_path / "o.npy"),
                  "--streaming", "--backend", "native"])


def _color_frames(t, h, w, c=3, seed=0):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(128, 30, (t, h, w, c)), 0,
                   255).astype(np.uint8)


def test_color_streaming_matches_wrapped_plane_stream():
    """MHTC streamed = 8-byte header + the planes' StreamingEncoder bytes."""
    from metalhuffman.models import color
    from metalhuffman.models.stream_writer import ColorStreamingEncoder

    frames = _color_frames(5, 16, 16, seed=21)
    t, h, w, c = frames.shape
    planes = color.to_subgreen(frames).transpose(0, 3, 1, 2).reshape(
        t * c, h, w)
    want = io.BytesIO()
    with StreamingEncoder(want, h, w, CodecConfig(),
                          max_segment_frames=2 * c,
                          frame_crcs=True) as inner:
        inner.push(planes)
    got = io.BytesIO()
    with ColorStreamingEncoder(got, h, w, channels=c,
                               colorspace=color.CS_SUBGREEN,
                               max_segment_frames=2,
                               frame_crcs=True) as enc:
        for f in frames:
            enc.push(f)
    head = color.COLOR_MAGIC + bytes([c, color.LAYOUT_VIDEO, color.KIND_U8,
                                      color.CS_SUBGREEN])
    assert got.getvalue() == head + want.getvalue()
    assert enc.stats.total_frames == 5
    # and the batch color decoder reads it
    out = color.decode_color_video_from_bytes(
        got.getvalue(), CodecConfig(backend="native"))
    np.testing.assert_array_equal(out, frames)


def test_u16_streaming_roundtrip():
    from metalhuffman.models import color
    from metalhuffman.models.stream_writer import ColorStreamingEncoder

    rng = np.random.default_rng(23)
    frames = rng.integers(0, 65536, (4, 16, 24)).astype(np.uint16)
    sink = io.BytesIO()
    with ColorStreamingEncoder(sink, 16, 24, u16=True,
                               max_segment_frames=2) as enc:
        enc.push(frames[:3])
        enc.push(frames[3])  # single (H, W) u16 frame form
    out = color.decode_gray16_from_bytes(
        sink.getvalue(), CodecConfig(backend="native"))
    np.testing.assert_array_equal(out, frames)


def test_color_streaming_validation():
    from metalhuffman.models import color
    from metalhuffman.models.stream_writer import ColorStreamingEncoder

    with pytest.raises(ValueError, match="channels"):
        ColorStreamingEncoder(io.BytesIO(), 16, 16)
    with pytest.raises(ValueError, match="sub-green"):
        ColorStreamingEncoder(io.BytesIO(), 16, 16, channels=1,
                              colorspace=color.CS_SUBGREEN)
    with pytest.raises(ValueError, match="u16"):
        ColorStreamingEncoder(io.BytesIO(), 16, 16, u16=True, channels=3)
    enc = ColorStreamingEncoder(io.BytesIO(), 16, 16, channels=3)
    with pytest.raises(ValueError, match="expected"):
        enc.push(np.zeros((16, 16), np.uint8))  # missing channel axis
    enc.abort()


def test_cli_streaming_color_and_u16_roundtrip(tmp_path):
    from metalhuffman import cli

    cframes = _color_frames(7, 24, 32, seed=25)
    src = tmp_path / "c.npy"
    np.save(src, cframes)
    mhtc = tmp_path / "c.mhtc"
    dec = tmp_path / "c_dec.npy"
    assert cli.main(["encode-video", str(src), str(mhtc), "--streaming",
                     "--color", "--subgreen", "--segment-frames", "2",
                     "--frame-crcs"]) == 0
    assert cli.main(["verify", str(mhtc), "--backend", "native"]) == 0
    assert cli.main(["decode-video", str(mhtc), str(dec), "--streaming",
                     "--backend", "native"]) == 0
    np.testing.assert_array_equal(np.load(dec), cframes)

    rng = np.random.default_rng(27)
    uframes = rng.integers(0, 65536, (5, 16, 24)).astype(np.uint16)
    usrc = tmp_path / "u.npy"
    np.save(usrc, uframes)
    umhtc = tmp_path / "u.mhtc"
    udec = tmp_path / "u_dec.npy"
    assert cli.main(["encode-video", str(usrc), str(umhtc), "--streaming",
                     "--gray16", "--segment-frames", "2"]) == 0
    assert cli.main(["decode-video", str(umhtc), str(udec), "--streaming",
                     "--backend", "native"]) == 0
    np.testing.assert_array_equal(np.load(udec), uframes)
    # PNG-directory output folds/saves color frames too
    outdir = tmp_path / "pngs"
    assert cli.main(["decode-video", str(mhtc), str(outdir), "--streaming",
                     "--backend", "native"]) == 0
    from metalhuffman.utils import imageio

    got = np.stack([imageio.load_color(outdir / f"frame_{i:05d}.png")
                    for i in range(7)])
    np.testing.assert_array_equal(got, cframes)


def test_streaming_decode_carries_partial_frames_across_segments(tmp_path):
    """Inner segments NOT aligned to whole frames: the fold must carry.

    ColorStreamingEncoder always frame-aligns its segments, so build the
    misaligned case directly: stream the planes with a 4-plane segment cap
    (not a multiple of 3 channels) and wrap in the MHTC header by hand.
    """
    from metalhuffman import cli
    from metalhuffman.models import color

    frames = _color_frames(4, 16, 16, seed=29)  # 12 planes -> segs 4/4/4
    t, h, w, c = frames.shape
    planes = frames.transpose(0, 3, 1, 2).reshape(t * c, h, w)
    inner = io.BytesIO()
    with StreamingEncoder(inner, h, w, max_segment_frames=4) as enc:
        enc.push(planes)
    blob = color.wrap(inner.getvalue(), c, color.LAYOUT_VIDEO)
    p = tmp_path / "misaligned.mhtc"
    p.write_bytes(blob)
    dec = tmp_path / "d.npy"
    assert cli.main(["decode-video", str(p), str(dec), "--streaming",
                     "--backend", "native"]) == 0
    np.testing.assert_array_equal(np.load(dec), frames)


def test_iter_temporal_video_chunks_group_aligned():
    from metalhuffman.models import temporal

    frames = _frames(11, 16, 16, seed=31)
    cfg = CodecConfig(backend="native", temporal=True, keyint=4)
    blob = temporal.encode_temporal_video(frames, cfg)
    bases, chunks = [], []
    for base, chunk in temporal.iter_temporal_video(
            blob, CodecConfig(backend="native"), chunk_frames=3):
        bases.append(base)
        chunks.append(chunk)
    # chunk_frames=3 snaps up to the keyint-4 group boundary
    assert bases == [0, 4, 8]
    np.testing.assert_array_equal(np.concatenate(chunks), frames)


def test_iter_temporal_video_streamed_crc_detects_corruption():
    from metalhuffman.models import temporal

    frames = _frames(6, 16, 16, seed=33)
    cfg = CodecConfig(backend="native", temporal=True, keyint=3)
    blob = bytearray(temporal.encode_temporal_video(frames, cfg))
    # corrupt the recorded outer CRC (the MHVT trailer is its last 4
    # bytes): chunks still decode, but the streamed chained CRC must
    # mismatch after the last chunk
    blob[-1] ^= 0x5A
    it = temporal.iter_temporal_video(
        bytes(blob), CodecConfig(backend="native"), chunk_frames=3)
    with pytest.raises(ValueError, match="CRC"):
        for _ in it:
            pass


def test_cli_streaming_decode_mhvt(tmp_path):
    from metalhuffman import cli

    frames = _frames(10, 24, 24, seed=35)
    src = tmp_path / "f.npy"
    np.save(src, frames)
    mhvt = tmp_path / "t.mhvt"
    assert cli.main(["encode-video", str(src), str(mhvt), "--temporal",
                     "--motion", "--keyint", "4", "--frame-crcs",
                     "--backend", "native"]) == 0
    dec = tmp_path / "d.npy"
    assert cli.main(["decode-video", str(mhvt), str(dec), "--streaming",
                     "--backend", "native"]) == 0
    np.testing.assert_array_equal(np.load(dec), frames)
    outdir = tmp_path / "pngs"
    assert cli.main(["decode-video", str(mhvt), str(outdir), "--streaming",
                     "--backend", "native"]) == 0
    from metalhuffman.utils import imageio

    got = np.stack([imageio.load_grayscale(outdir / f"frame_{i:05d}.png")
                    for i in range(10)])
    np.testing.assert_array_equal(got, frames)
    with pytest.raises(SystemExit, match="streaming"):
        cli.main(["decode-video", str(mhvt), str(dec), "--streaming",
                  "--check", "--backend", "native"])


def test_cli_streaming_decode_mhvt_color_and_short_first_group(tmp_path):
    from metalhuffman import cli

    cframes = _color_frames(7, 16, 16, seed=37)
    src = tmp_path / "c.npy"
    np.save(src, cframes)
    mhvt = tmp_path / "c.mhvt"
    assert cli.main(["encode-video", str(src), str(mhvt), "--temporal",
                     "--color", "--keyint", "3", "--backend",
                     "native"]) == 0
    dec = tmp_path / "d.npy"
    assert cli.main(["decode-video", str(mhvt), str(dec), "--streaming",
                     "--backend", "native"]) == 0
    np.testing.assert_array_equal(np.load(dec), cframes)
    # arbitrary-start extract -> short first group; streaming must align
    # its chunks to the re-keyed group structure
    cut = tmp_path / "cut.mhvt"
    assert cli.main(["extract", str(mhvt), str(cut),
                     "--frames", "2", "7"]) == 0
    dec2 = tmp_path / "d2.npy"
    assert cli.main(["decode-video", str(cut), str(dec2), "--streaming",
                     "--backend", "native"]) == 0
    np.testing.assert_array_equal(np.load(dec2), cframes[2:7])


def test_streaming_iterators_on_device_backend():
    """The chunked readers ride the device (interpret) pipeline too —
    StreamingDecoder submit/result for MHV2 chunks, the jitted fold for
    MHVT chunks — not just the native path the other tests use."""
    from metalhuffman.models import temporal

    frames = _frames(6, 16, 24, seed=47)
    dcfg = CodecConfig(backend="pallas")
    sink = io.BytesIO()
    with StreamingEncoder(sink, 16, 24, CodecConfig(),
                          max_segment_frames=2) as enc:
        enc.push(frames)
    segs, t, h, w, bd, delta = frame_stream.read_segmented(sink.getvalue())
    chunks = list(frame_stream.iter_frames_segmented(segs, h, w, dcfg))
    assert [c.shape[0] for c in chunks] == [2, 2, 2]
    np.testing.assert_array_equal(np.concatenate(chunks), frames)

    tcfg = CodecConfig(backend="native", temporal=True, keyint=2,
                       motion=True)
    blob = temporal.encode_temporal_video(frames, tcfg)
    served = [c for _b, c in temporal.iter_temporal_video(
        blob, dcfg, chunk_frames=2)]
    np.testing.assert_array_equal(np.concatenate(served), frames)


def test_cli_verify_streaming(tmp_path):
    """verify --streaming: the full integrity chain at constant memory."""
    from metalhuffman import cli

    frames = _frames(6, 24, 32, seed=45)
    src = tmp_path / "f.npy"
    np.save(src, frames)
    mhv2 = tmp_path / "s.mhv2"
    assert cli.main(["encode-video", str(src), str(mhv2), "--streaming",
                     "--segment-frames", "2", "--frame-crcs"]) == 0
    assert cli.main(["verify", str(mhv2), "--streaming",
                     "--backend", "native"]) == 0
    assert cli.main(["verify", str(mhv2), "--streaming",
                     "--backend", "pallas", "--interpret"]) == 0

    # a desynced code byte fails the per-segment end-bit check
    data = bytearray(mhv2.read_bytes())
    data[4 + 18 + 12 + 8 + 256] ^= 0xFF
    bad = tmp_path / "bad.mhv2"
    bad.write_bytes(bytes(data))
    with pytest.raises(SystemExit, match="integrity|CRC"):
        cli.main(["verify", str(bad), "--streaming",
                  "--backend", "pallas", "--interpret"])

    # a corrupted recorded source CRC fails the chained check
    data2 = bytearray(mhv2.read_bytes())
    data2[frame_stream._trailer_offset(bytes(data2))] ^= 0x5A
    bad2 = tmp_path / "bad2.mhv2"
    bad2.write_bytes(bytes(data2))
    with pytest.raises(SystemExit, match="CRC"):
        cli.main(["verify", str(bad2), "--streaming",
                  "--backend", "native"])

    # MHTV needs resegmenting first (MHVT verifies streamed since round 5)
    mhtv = tmp_path / "x.mhtv"
    assert cli.main(["encode-video", str(src), str(mhtv)]) == 0
    with pytest.raises(SystemExit, match="resegment"):
        cli.main(["verify", str(mhtv), "--streaming",
                  "--backend", "native"])


def test_streamed_file_serves_every_reader_surface(tmp_path):
    """info/verify/random access treat a streamed MHV2 like any other."""
    from metalhuffman import cli

    frames = _frames(5, 24, 24, seed=11)
    path = tmp_path / "s.mhv2"
    with StreamingEncoder(path, 24, 24, CodecConfig(),
                          max_segment_frames=2, frame_crcs=True) as enc:
        enc.push(frames)
    rc = cli.main(["info", str(path)])
    assert rc == 0
    # random access on the streamed container, straddling a segment boundary
    data = path.read_bytes()
    cfg = CodecConfig(backend="native")
    out, h, w = frame_stream.decode_range(data, 1, 4, cfg)
    np.testing.assert_array_equal(out, frames[1:4])


def test_push_failure_truncates_sink(tmp_path, monkeypatch):
    """A push() whose segment encode fails must not leave a torn container
    even when the caller never uses the context manager (round-4 advice)."""
    frames = _frames(4, 16, 16)
    path = tmp_path / "torn.mhv2"
    enc = StreamingEncoder(path, 16, 16, max_segment_frames=2)
    enc.push(frames[:2])  # one full segment written cleanly
    enc._fh.flush()
    assert path.stat().st_size > 0

    def boom(*_a, **_k):
        raise RuntimeError("simulated encode failure")

    monkeypatch.setattr(frame_stream, "encode_frames_shared", boom)
    with pytest.raises(RuntimeError, match="simulated"):
        enc.push(frames[2:])  # fills the second segment -> _emit fails
    assert path.read_bytes() == b""  # aborted, truncated to the base
    with pytest.raises(ValueError, match="close"):
        enc.push(frames[:1])  # the stream is dead, not half-alive


def test_push_validation_error_keeps_stream_usable(tmp_path):
    """Shape/dtype rejection raises BEFORE any state change: the caller
    can drop the bad frame and keep pushing (no abort, no truncation)."""
    frames = _frames(3, 16, 16)
    path = tmp_path / "ok.mhv2"
    with StreamingEncoder(path, 16, 16, max_segment_frames=2) as enc:
        enc.push(frames[:1])
        with pytest.raises(ValueError, match="expected"):
            enc.push(np.zeros((8, 8), np.uint8))  # wrong geometry
        with pytest.raises(ValueError, match="uint8"):
            enc.push(frames[1:2].astype(np.uint16))
        enc.push(frames[1:])  # still alive
    data = path.read_bytes()
    cfg = CodecConfig(backend="native")
    out, _h, _w = frame_stream.decode_range(data, 0, 3, cfg)
    np.testing.assert_array_equal(out, frames)


def test_color_push_failure_removes_mhtc_header(tmp_path, monkeypatch):
    from metalhuffman.models.stream_writer import ColorStreamingEncoder

    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (4, 16, 16, 3), dtype=np.uint8)
    path = tmp_path / "torn.mhtc"
    enc = ColorStreamingEncoder(path, 16, 16, channels=3,
                                max_segment_frames=1)

    def boom(*_a, **_k):
        raise RuntimeError("simulated encode failure")

    monkeypatch.setattr(frame_stream, "encode_frames_shared", boom)
    with pytest.raises(RuntimeError, match="simulated"):
        enc.push(frames)
    assert path.read_bytes() == b""  # MHTC header gone too


def test_failed_streaming_decode_removes_stale_frames(tmp_path):
    """A failed streaming decode into an image directory must remove EVERY
    frame_*.png there — stale frames from a previous (longer) run would
    otherwise masquerade as a complete good decode (round-4 advice)."""
    from metalhuffman import cli
    from metalhuffman.utils import imageio

    frames = _frames(6, 16, 16, seed=37)
    src = tmp_path / "f.npy"
    np.save(src, frames)
    mhv2 = tmp_path / "s.mhv2"
    assert cli.main(["encode-video", str(src), str(mhv2), "--streaming",
                     "--segment-frames", "2"]) == 0
    outdir = tmp_path / "pngs"
    outdir.mkdir()
    # stale survivors from an imagined previous, longer run
    for i in (3, 9):
        imageio.save_grayscale(frames[0], outdir / f"frame_{i:05d}.png")
    data = bytearray(mhv2.read_bytes())
    # corrupt the recorded CRC trailer: every frame decodes and is saved,
    # then the streamed chained-CRC check fails — the worst case for
    # leaving a convincing-looking partial output behind
    data[-1] ^= 0x5A
    mhv2.write_bytes(bytes(data))
    with pytest.raises(SystemExit, match="CRC"):
        cli.main(["decode-video", str(mhv2), str(outdir), "--streaming",
                  "--backend", "native"])
    assert list(outdir.glob("frame_*.png")) == []


def test_color_push_after_close_preserves_container(tmp_path):
    """Round-5 review finding: a push() after a successful close() must
    raise WITHOUT tripping the abort wrapper (which would truncate the
    finalized container — silent data loss on file-object sinks)."""
    from metalhuffman.models.stream_writer import ColorStreamingEncoder

    rng = np.random.default_rng(5)
    frames = rng.integers(0, 200, (3, 16, 16, 3)).astype(np.uint8)
    sink = io.BytesIO()
    enc = ColorStreamingEncoder(sink, 16, 16, channels=3,
                                config=CodecConfig(backend="native"))
    enc.push(frames)
    enc.close()
    good = sink.getvalue()
    assert len(good) > 0
    with pytest.raises(ValueError, match="after close"):
        enc.push(frames)
    assert sink.getvalue() == good  # finalized container untouched

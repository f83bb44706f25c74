"""MHTS streaming family (round-5 item 4): push-frame writer, chunked reader.

MHTS (one self-contained MHT1 record per frame) is the most naturally
streamable container in the format — the only future-dependent header
field is the u32 frame count. Contracts:

- MHTSStreamingEncoder's file is byte-identical to the batch
  ``write_stream(encode_frames(...), source_crc32s=...)`` (the CLI's
  ``--per-frame-tables`` bytes), regardless of push() chunking;
- ``iter_stream_frames`` decodes one frame at a time, surfacing each
  frame's end-bit error vector (``check``, Pallas) and recorded CRC;
- CLI: ``encode-video --streaming --per-frame-tables``,
  ``decode-video --streaming``, ``verify --streaming`` all cover MHTS.
"""

import io
import zlib

import numpy as np
import pytest

from metalhuffman.models import CodecConfig, frame_stream
from metalhuffman.models.stream_writer import MHTSStreamingEncoder

NATIVE = CodecConfig(backend="native")


def _frames(t, h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([
        np.clip(100 + 60 * np.sin((xx + 5 * i) / 17.0) * np.cos(yy / 13.0)
                + rng.normal(0, 2, (h, w)), 0, 255).astype(np.uint8)
        for i in range(t)])


def _batch_bytes(frames, cfg):
    return frame_stream.write_stream(
        frame_stream.encode_frames(frames, cfg), frames.shape[1],
        frames.shape[2], cfg,
        source_crc32s=[zlib.crc32(np.ascontiguousarray(f).tobytes())
                       for f in frames])


@pytest.mark.parametrize("chunks", [[7], [1] * 7, [3, 1, 2, 1]])
@pytest.mark.parametrize(
    "cfg",
    [CodecConfig(backend="native"),
     CodecConfig(backend="native", delta=False),
     CodecConfig(backend="native", delta2d=True)],
    ids=["delta", "plain", "delta2d"],
)
def test_byte_identical_to_batch(cfg, chunks):
    frames = _frames(7, 24, 40)
    want = _batch_bytes(frames, cfg)
    sink = io.BytesIO()
    with MHTSStreamingEncoder(sink, 24, 40, cfg) as enc:
        start = 0
        for n in chunks:
            enc.push(frames[start : start + n])
            start += n
    assert sink.getvalue() == want
    assert enc.stats.total_frames == 7
    assert enc.stats.bytes_written == len(want)


def test_iter_stream_frames_matches_batch_and_verifies_crc():
    frames = _frames(5, 24, 24, seed=3)
    blob = _batch_bytes(frames, NATIVE)
    outs, crcs = [], []
    for i, f, err, crc in frame_stream.iter_stream_frames(blob, NATIVE):
        assert err is None
        outs.append(f)
        crcs.append(crc)
    np.testing.assert_array_equal(np.stack(outs), frames)
    assert crcs == [zlib.crc32(np.ascontiguousarray(f).tobytes())
                    for f in frames]
    assert frame_stream.stream_frame_count(blob) == 5


def test_iter_stream_frames_checked_interpret():
    frames = _frames(3, 16, 16, seed=5)
    blob = _batch_bytes(frames, NATIVE)
    cfg = CodecConfig(backend="pallas")
    outs = []
    for i, f, err, _crc in frame_stream.iter_stream_frames(blob, cfg,
                                                           check=True):
        assert err is not None and not err.any()
        outs.append(f)
    np.testing.assert_array_equal(np.stack(outs), frames)
    with pytest.raises(ValueError, match="Pallas"):
        next(frame_stream.iter_stream_frames(blob, NATIVE, check=True))


def test_mixed_predictor_records_stream():
    """An MHTS whose records mix delta2d and delta frames (e.g. from an
    append) decodes per record, like the batch path."""
    f = _frames(4, 16, 16, seed=7)
    s1 = frame_stream.encode_frames(f[:2], CodecConfig(backend="native"))
    s2 = frame_stream.encode_frames(
        f[2:], CodecConfig(backend="native", delta2d=True))
    blob = frame_stream.write_stream(s1 + s2, 16, 16,
                                     CodecConfig(backend="native"))
    outs = [fr for _, fr, _, _ in
            frame_stream.iter_stream_frames(blob, NATIVE)]
    np.testing.assert_array_equal(np.stack(outs), f)


def test_no_torn_container(tmp_path, monkeypatch):
    frames = _frames(4, 16, 16, seed=9)
    p = tmp_path / "torn.mhts"
    enc = MHTSStreamingEncoder(p, 16, 16, NATIVE)
    enc.push(frames[:2])

    from metalhuffman.models import image_codec

    def boom(*_a, **_k):
        raise RuntimeError("simulated encode failure")

    monkeypatch.setattr(image_codec.ImageCodec, "encode", boom)
    with pytest.raises(RuntimeError, match="simulated"):
        enc.push(frames[2:])
    assert p.read_bytes() == b""
    # failed close (empty) truncates too
    p2 = tmp_path / "empty.mhts"
    enc2 = MHTSStreamingEncoder(p2, 16, 16, NATIVE)
    with pytest.raises(ValueError, match="empty"):
        enc2.close()
    assert p2.read_bytes() == b""
    # temporal is refused (MHVT wraps shared-table streams)
    with pytest.raises(ValueError, match="temporal"):
        MHTSStreamingEncoder(io.BytesIO(), 16, 16,
                             CodecConfig(temporal=True))


def test_cli_mhts_streaming_roundtrip(tmp_path):
    from metalhuffman import cli

    frames = _frames(6, 24, 32, seed=11)
    src = tmp_path / "f.npy"
    np.save(src, frames)
    out = tmp_path / "s.mhts"
    assert cli.main(["encode-video", str(src), str(out), "--streaming",
                     "--per-frame-tables", "--backend", "native"]) == 0
    # byte-identical to the batch CLI
    batch = tmp_path / "b.mhts"
    assert cli.main(["encode-video", str(src), str(batch),
                     "--per-frame-tables", "--backend", "native"]) == 0
    assert out.read_bytes() == batch.read_bytes()
    # streamed decode, .npy and image-dir
    dec = tmp_path / "d.npy"
    assert cli.main(["decode-video", str(out), str(dec), "--streaming",
                     "--backend", "native"]) == 0
    np.testing.assert_array_equal(np.load(dec), frames)
    outdir = tmp_path / "pngs"
    assert cli.main(["decode-video", str(out), str(outdir), "--streaming",
                     "--backend", "native"]) == 0
    from metalhuffman.utils import imageio

    got = np.stack([imageio.load_grayscale(outdir / f"frame_{i:05d}.png")
                    for i in range(6)])
    np.testing.assert_array_equal(got, frames)
    # streamed verify, native + interpret-pallas (end-bit per frame)
    assert cli.main(["verify", str(out), "--streaming",
                     "--backend", "native"]) == 0
    assert cli.main(["verify", str(out), "--streaming",
                     "--backend", "pallas", "--interpret"]) == 0
    # batch decode still reads it (it IS a batch MHTS)
    assert cli.main(["decode-video", str(out), str(dec),
                     "--backend", "native"]) == 0
    np.testing.assert_array_equal(np.load(dec), frames)


def test_cli_mhts_streaming_corruption(tmp_path):
    from metalhuffman import cli

    frames = _frames(4, 16, 16, seed=13)
    src = tmp_path / "f.npy"
    np.save(src, frames)
    out = tmp_path / "s.mhts"
    assert cli.main(["encode-video", str(src), str(out), "--streaming",
                     "--per-frame-tables", "--backend", "native"]) == 0
    data = bytearray(out.read_bytes())
    # flip one bit in the LAST record's code bytes: earlier frames decode,
    # then either the native decoder detects the desync or the per-frame
    # CRC catches it — and the partial output must be cleaned up
    data[-3] ^= 0x10
    bad = tmp_path / "bad.mhts"
    bad.write_bytes(bytes(data))
    dec = tmp_path / "d.npy"
    with pytest.raises((SystemExit, RuntimeError)):
        cli.main(["decode-video", str(bad), str(dec), "--streaming",
                  "--backend", "native"])
    assert not dec.exists()
    with pytest.raises((SystemExit, RuntimeError)):
        cli.main(["verify", str(bad), "--streaming", "--backend",
                  "native"])
    # a corrupted recorded per-frame CRC decodes fine, then fails the
    # check cleanly (stands in for length-preserving payload corruption
    # the decode itself cannot see): the first record's CRC field sits at
    # file offset 12 (MHTS header + rec_len) + 18 (MHT1 geometry header)
    data2 = bytearray(out.read_bytes())
    data2[30] ^= 0x5A
    bad2 = tmp_path / "bad2.mhts"
    bad2.write_bytes(bytes(data2))
    with pytest.raises(SystemExit, match="CRC"):
        cli.main(["decode-video", str(bad2), str(dec), "--streaming",
                  "--backend", "native"])
    assert not dec.exists()
    with pytest.raises(SystemExit, match="CRC"):
        cli.main(["verify", str(bad2), "--streaming", "--backend",
                  "native"])
    # flag conflicts
    with pytest.raises(SystemExit, match="shared-table"):
        cli.main(["encode-video", str(src), str(out), "--streaming",
                  "--per-frame-tables", "--temporal"])
    with pytest.raises(SystemExit, match="grayscale"):
        cli.main(["encode-video", str(src), str(out), "--streaming",
                  "--per-frame-tables", "--color"])
    with pytest.raises(SystemExit, match="segments"):
        cli.main(["encode-video", str(src), str(out), "--streaming",
                  "--per-frame-tables", "--segment-frames", "2"])


def test_truncated_mhts_raises_clean_errors(tmp_path):
    """Round-5 review finding: every truncation of an MHTS must surface
    as ValueError (never struct.error) through the streaming readers,
    and the CLI must turn it into a clean exit."""
    from metalhuffman import cli

    frames = _frames(3, 16, 16, seed=21)
    blob = _batch_bytes(frames, NATIVE)
    for cut in [5, 6, 9, 11, len(blob) // 2, len(blob) - 1]:
        with pytest.raises(ValueError):
            list(frame_stream.iter_stream_frames(blob[:cut], NATIVE))
    with pytest.raises(ValueError):
        frame_stream.stream_frame_count(b"MHTS\x01")
    p = tmp_path / "cut.mhts"
    p.write_bytes(blob[: len(blob) // 2])
    with pytest.raises(SystemExit):
        cli.main(["decode-video", str(p), str(tmp_path / "o.npy"),
                  "--streaming", "--backend", "native"])
    with pytest.raises(SystemExit):
        cli.main(["verify", str(p), "--streaming", "--backend", "native"])
    # zero-frame-count header: clean refusal, not a NameError
    p0 = tmp_path / "empty.mhts"
    p0.write_bytes(b"MHTS" + b"\x00" * 4)
    with pytest.raises(SystemExit, match="empty"):
        cli.main(["verify", str(p0), "--streaming", "--backend",
                  "native"])


def test_mhts_surgery_and_region(tmp_path):
    """Round-5 completion: MHTS joins every surgery/random-access surface
    — extract/concat are verbatim record splices (the easiest surgery in
    the format), region decode loops per-frame decode_region."""
    from metalhuffman import cli
    from metalhuffman.models import surgery

    frames = _frames(6, 24, 32, seed=17)
    blob = _batch_bytes(frames, NATIVE)

    # extract: verbatim splice, lossless, info reports zero re-encodes
    info = {}
    part = surgery.extract_video(blob, 2, 5, info)
    assert info["reencoded_frames"] == 0
    outs = [f for _, f, _, _ in
            frame_stream.iter_stream_frames(part, NATIVE)]
    np.testing.assert_array_equal(np.stack(outs), frames[2:5])
    assert surgery.extract_video(blob, 0, 6) == blob  # full = verbatim

    # concat: record regions verbatim, count summed
    cat = surgery.concat_videos([blob, part])
    outs = [f for _, f, _, _ in
            frame_stream.iter_stream_frames(cat, NATIVE)]
    np.testing.assert_array_equal(
        np.stack(outs), np.concatenate([frames, frames[2:5]]))
    # geometry mismatch refused
    other = _batch_bytes(_frames(2, 16, 16, seed=19), NATIVE)
    with pytest.raises(ValueError, match="mismatch"):
        surgery.concat_videos([blob, other])

    # resegment: clean refusal (no segments to re-cut)
    with pytest.raises(ValueError, match="self-contained"):
        surgery.resegment_video(blob, 2)

    # region decode (library + per-frame CRC-independent)
    roi = frame_stream.decode_video_region(blob, 1, 4, 4, 8, 8, 16,
                                           NATIVE)
    np.testing.assert_array_equal(roi, frames[1:4, 4:12, 8:24])
    with pytest.raises(ValueError, match="out of bounds"):
        frame_stream.decode_video_region(blob, 0, 2, 20, 0, 8, 8, NATIVE)
    with pytest.raises(ValueError, match="out of range"):
        frame_stream.decode_video_region(blob, 4, 9, 0, 0, 8, 8, NATIVE)

    # CLI: extract/concat/region on MHTS files
    p = tmp_path / "s.mhts"
    p.write_bytes(blob)
    out = tmp_path / "part.mhts"
    assert cli.main(["extract", str(p), str(out), "--frames", "2",
                     "5"]) == 0
    assert out.read_bytes() == part
    cat_p = tmp_path / "cat.mhts"
    assert cli.main(["concat", str(cat_p), str(p), str(out)]) == 0
    assert cat_p.read_bytes() == cat
    dec = tmp_path / "roi.npy"
    assert cli.main(["decode-video", str(p), str(dec), "--frames", "1",
                     "4", "--region", "4", "8", "8", "16",
                     "--backend", "native"]) == 0
    np.testing.assert_array_equal(np.load(dec), frames[1:4, 4:12, 8:24])
    # region with on-device end-bit check (interpret)
    assert cli.main(["decode-video", str(p), str(dec), "--frames", "1",
                     "3", "--region", "4", "8", "8", "16", "--check",
                     "--backend", "pallas", "--interpret"]) == 0
    np.testing.assert_array_equal(np.load(dec), frames[1:3, 4:12, 8:24])

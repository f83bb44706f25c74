"""Temporal random access: decode one frame of a video container.

The per-block offset index makes any contiguous block range independently
decodable; ``frame_stream.frame_slice`` turns frames [t0, t0+n) of a
shared-table stream into a zero-copy view (shared code_bytes + canonical
table, sliced offsets/roots) that every decode path treats as an ordinary
stream. The reference always decodes the whole texture
(``AAPLRenderer.m:1178-1924``) — this is a beyond-reference capability,
the temporal analog of ``ImageCodec.decode_region``.
"""

import numpy as np
import pytest

import metalhuffman as mht
from metalhuffman.models import frame_stream
from metalhuffman.models.image_codec import CodecConfig


def _frames(t, h, w, seed=0):
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.normal(0, 5, (t, h, w)), axis=2)
    return (base - base.min()).clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize("backend", ["native", "pallas"])
@pytest.mark.parametrize("mode", ["delta", "zero_init", "delta2d"])
def test_decode_frame_matches_batch(backend, mode):
    frames = _frames(4, 24, 40, seed=1)
    cfg = CodecConfig(backend=backend,
                      zero_init=mode == "zero_init",
                      delta2d=mode == "delta2d")
    stream = frame_stream.encode_frames_shared(frames, cfg)
    for t in (0, 2, 3):
        img = frame_stream.decode_frame(stream, t, 24, 40, cfg)
        np.testing.assert_array_equal(np.asarray(img), frames[t])


def test_frame_slice_multi_frame_and_bounds():
    frames = _frames(5, 16, 24, seed=2)
    cfg = CodecConfig(backend="native")
    stream = frame_stream.encode_frames_shared(frames, cfg)
    view = frame_stream.frame_slice(stream, 1, 3, 16, 24, cfg)
    out = frame_stream.decode_frames_segmented([(view, 3)], 16, 24, cfg)
    np.testing.assert_array_equal(out, frames[1:4])
    with pytest.raises(ValueError, match="out of range"):
        frame_stream.frame_slice(stream, 3, 3, 16, 24, cfg)
    with pytest.raises(ValueError, match="out of range"):
        frame_stream.frame_slice(stream, -1, 1, 16, 24, cfg)


def test_cli_frame_mhtv_and_mhv2(tmp_path):
    from metalhuffman import cli
    from metalhuffman.utils import imageio

    frames = _frames(3, 16, 32, seed=3)
    src = tmp_path / "f.npy"
    np.save(src, frames)
    mhtv = tmp_path / "v.mhtv"
    assert cli.main(["encode-video", str(src), str(mhtv),
                     "--backend", "native"]) == 0
    out = tmp_path / "frame1.png"
    assert cli.main(["decode-video", str(mhtv), str(out), "--frame", "1",
                     "--backend", "native"]) == 0
    np.testing.assert_array_equal(imageio.load_grayscale(out), frames[1])

    # MHV2: frame index resolves across segments
    cfg = CodecConfig(backend="native")
    segs = frame_stream.encode_frames_segmented(
        frames, cfg, max_segment_bits=16 * 32 * 16)
    assert len(segs) >= 2
    (tmp_path / "v.mhv2").write_bytes(
        frame_stream.write_segmented(segs, 16, 32, cfg))
    out2 = tmp_path / "frame2.npy"
    assert cli.main(["decode-video", str(tmp_path / "v.mhv2"), str(out2),
                     "--frame", "2", "--backend", "native"]) == 0
    np.testing.assert_array_equal(np.load(out2), frames[2])

    with pytest.raises(SystemExit, match="out of range"):
        cli.main(["decode-video", str(mhtv), str(out), "--frame", "9",
                  "--backend", "native"])
    with pytest.raises(SystemExit, match="--check"):
        cli.main(["decode-video", str(mhtv), str(out), "--frame", "1",
                  "--check", "--backend", "pallas", "--interpret"])


def test_cli_frame_mhts_verifies_record_crc(tmp_path):
    import zlib

    from metalhuffman import cli

    frames = _frames(2, 16, 16, seed=4)
    cfg = CodecConfig(backend="native")
    streams = frame_stream.encode_frames(frames, cfg)
    crcs = [zlib.crc32(f.tobytes()) for f in frames]
    mhts = tmp_path / "v.mhts"
    mhts.write_bytes(
        frame_stream.write_stream(streams, 16, 16, cfg, source_crc32s=crcs))
    out = tmp_path / "f.npy"
    assert cli.main(["decode-video", str(mhts), str(out), "--frame", "1",
                     "--backend", "native"]) == 0
    np.testing.assert_array_equal(np.load(out), frames[1])

    # corrupt frame 1's record -> --frame 1 must fail its CRC
    bad = frame_stream.write_stream(
        [streams[0],
         __import__("dataclasses").replace(
             streams[1],
             code_bytes=np.bitwise_xor(streams[1].code_bytes,
                                       np.uint8(0xFF)))],
        16, 16, cfg, source_crc32s=crcs)
    (tmp_path / "bad.mhts").write_bytes(bad)
    with pytest.raises(SystemExit, match="CRC-32"):
        cli.main(["decode-video", str(tmp_path / "bad.mhts"), str(out),
                  "--frame", "1", "--backend", "native"])


def test_mixed_predictor_mhts_decodes_per_frame(tmp_path):
    """A crafted MHTS with different predictors per frame decodes correctly
    (the batched path refuses mixed batches; the CLI falls back per frame)."""
    import dataclasses

    from metalhuffman import cli
    from metalhuffman.models import ImageCodec

    frames = _frames(2, 16, 24, seed=9)
    s0 = ImageCodec(CodecConfig(backend="native")).encode(frames[0])
    s1 = ImageCodec(
        CodecConfig(backend="native", delta2d=True)).encode(frames[1])
    cfg = CodecConfig(backend="native")
    blob = frame_stream.write_stream([s0, s1], 16, 24, cfg)

    with pytest.raises(ValueError, match="one predictor"):
        frame_stream.prepare_batch([s0, s1], 16, 24, cfg)

    mhts = tmp_path / "mixed.mhts"
    mhts.write_bytes(blob)
    out = tmp_path / "o.npy"
    for backend in ("xla", "pallas"):
        assert cli.main(["decode-video", str(mhts), str(out),
                         "--backend", backend, "--interpret"]) == 0
        np.testing.assert_array_equal(np.load(out), frames)


# -- spatio-temporal ROI (round 3: crop x frame-range random access) -----------


def _region_frames(t=7, h=40, w=56, seed=3):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w), np.uint8)
    return np.stack([np.roll(base, (3 * i, 5 * i), (0, 1)) for i in range(t)])


@pytest.mark.parametrize("backend", ["native", "pallas", "xla"])
def test_video_region_gray(backend):
    frames = _region_frames()
    cfg = CodecConfig(backend=backend)
    blob = mht.encode_video(frames, CodecConfig(backend="native"))
    for a, b, y0, x0, rh, rw in [(0, 7, 0, 0, 40, 56), (2, 5, 11, 13, 17, 23),
                                 (6, 7, 32, 48, 8, 8)]:
        got = frame_stream.decode_video_region(blob, a, b, y0, x0, rh, rw, cfg)
        np.testing.assert_array_equal(
            got, frames[a:b, y0 : y0 + rh, x0 : x0 + rw])
    with pytest.raises(ValueError):
        frame_stream.decode_video_region(blob, 0, 2, 30, 0, 20, 8, cfg)
    with pytest.raises(ValueError):
        frame_stream.decode_video_region(blob, 5, 9, 0, 0, 8, 8, cfg)


def test_video_region_segmented_and_delta2d():
    frames = _region_frames(t=6, h=24, w=32)
    cfg = CodecConfig(backend="native", delta2d=True)
    segs = frame_stream.encode_frames_segmented(frames, cfg,
                                                max_segment_bits=16_000)
    assert len(segs) > 1
    blob = frame_stream.write_segmented(segs, 24, 32, cfg)
    got = frame_stream.decode_video_region(
        blob, 1, 5, 5, 9, 12, 15, CodecConfig(backend="native"))
    np.testing.assert_array_equal(got, frames[1:5, 5:17, 9:24])


def test_video_region_color_and_u16():
    from metalhuffman.models import color

    rng = np.random.default_rng(4)
    cframes = np.stack([np.roll(rng.integers(0, 256, (24, 32, 3), np.uint8),
                                i, 0) for i in range(5)])
    # sub-green: the crop must still invert correctly (per-pixel transform)
    blob = color.encode_color_video_to_bytes(
        cframes, CodecConfig(backend="native"),
        colorspace=color.CS_SUBGREEN)
    got = color.decode_color_video_region(
        blob, 1, 4, 3, 5, 10, 12, CodecConfig(backend="native"))
    np.testing.assert_array_equal(got, cframes[1:4, 3:13, 5:17])
    g16 = rng.integers(0, 1 << 16, (4, 16, 24)).astype(np.uint16)
    gblob = color.encode_gray16_to_bytes(g16, CodecConfig(backend="native"))
    got16 = color.decode_color_video_region(
        gblob, 0, 4, 2, 3, 8, 9, CodecConfig(backend="native"))
    assert got16.dtype == np.uint16
    np.testing.assert_array_equal(got16, g16[:, 2:10, 3:12])


def test_video_region_temporal_plain_and_mc():
    from metalhuffman.models import temporal

    frames = _region_frames(t=9)
    # plain temporal: only the region's blocks decode (pixel-wise fold)
    blob = mht.encode_video(frames, CodecConfig(
        backend="native", temporal=True, keyint=4))
    got = temporal.decode_temporal_video_region(
        blob, 3, 8, 9, 10, 14, 21, CodecConfig(backend="native"))
    np.testing.assert_array_equal(got, frames[3:8, 9:23, 10:31])
    # MC: falls back to full-frame range + crop, still exact
    mblob = mht.encode_video(frames, CodecConfig(
        backend="native", temporal=True, motion=True, keyint=4))
    got2 = temporal.decode_temporal_video_region(
        mblob, 2, 6, 0, 8, 16, 16, CodecConfig(backend="native"))
    np.testing.assert_array_equal(got2, frames[2:6, 0:16, 8:24])


def test_cli_region(tmp_path):
    from metalhuffman.cli import main

    frames = _region_frames(t=5)
    src = tmp_path / "v.npy"
    np.save(src, frames)
    out = tmp_path / "v.mhtv"
    main(["encode-video", str(src), str(out), "--backend", "native"])
    crop = tmp_path / "crop.npy"
    main(["decode-video", str(out), str(crop), "--region", "8", "8", "16",
          "24", "--frame", "3", "--backend", "native"])
    np.testing.assert_array_equal(np.load(crop), frames[3, 8:24, 8:32])
    allc = tmp_path / "all.npy"
    main(["decode-video", str(out), str(allc), "--region", "0", "0", "8",
          "8", "--backend", "native"])
    np.testing.assert_array_equal(np.load(allc), frames[:, :8, :8])


def test_cli_frames_range(tmp_path):
    from metalhuffman.cli import main
    from metalhuffman.models import temporal

    frames = _region_frames(t=7)
    src = tmp_path / "v.npy"
    np.save(src, frames)
    # plain MHTV range (with FCRC verification)
    out = tmp_path / "v.mhtv"
    main(["encode-video", str(src), str(out), "--frame-crcs",
          "--backend", "native"])
    got = tmp_path / "r.npy"
    main(["decode-video", str(out), str(got), "--frames", "2", "5",
          "--backend", "native"])
    np.testing.assert_array_equal(np.load(got), frames[2:5])
    # MHVT range
    outv = tmp_path / "v.mhvt"
    main(["encode-video", str(src), str(outv), "--temporal", "--keyint",
          "3", "--backend", "native"])
    main(["decode-video", str(outv), str(got), "--frames", "1", "6",
          "--backend", "native"])
    np.testing.assert_array_equal(np.load(got), frames[1:6])
    # range + region combined
    main(["decode-video", str(out), str(got), "--frames", "1", "4",
          "--region", "8", "8", "16", "24", "--backend", "native"])
    np.testing.assert_array_equal(np.load(got), frames[1:4, 8:24, 8:32])
    # --frame and --frames conflict
    with pytest.raises(SystemExit, match="mutually exclusive"):
        main(["decode-video", str(out), str(got), "--frames", "1", "4",
              "--frame", "2", "--region", "0", "0", "8", "8",
              "--backend", "native"])


def test_frames_range_mhts(tmp_path):
    # per-frame-table MHTS: decode_range loops single-frame decodes and
    # verifies each frame's recorded CRC (round-3 review finding)
    from metalhuffman.cli import main

    frames = _region_frames(t=5)
    src = tmp_path / "v.npy"
    np.save(src, frames)
    out = tmp_path / "v.mhts"
    main(["encode-video", str(src), str(out), "--per-frame-tables",
          "--backend", "native"])
    got, h, w = frame_stream.decode_range(
        out.read_bytes(), 1, 4, CodecConfig(backend="native"))
    np.testing.assert_array_equal(got, frames[1:4])
    dst = tmp_path / "r.npy"
    main(["decode-video", str(out), str(dst), "--frames", "1", "4",
          "--backend", "native"])
    np.testing.assert_array_equal(np.load(dst), frames[1:4])

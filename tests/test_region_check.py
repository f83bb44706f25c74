"""ROI/random-access end-bit integrity: verify exactly the touched blocks.

Whole-payload and per-frame CRCs cannot cover a crop; the kernel's end-bit
output can (``ops.decode_pallas`` integrity machinery), and round 4 wires it
through ``decode_blocks_selection`` into every ROI surface. The contract
matched here is the reference's verify-what-you-render assert
(``AAPLRenderer.m:1849-1876``): corruption INSIDE a touched block must fail
the check; corruption OUTSIDE the selection must not (the crop never reads
it) while the crop itself stays bit-exact.
"""

import numpy as np
import pytest

from metalhuffman.models import frame_stream, image_codec
from metalhuffman.models.image_codec import CodecConfig, ImageCodec


def _image(h, w, seed=0):
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.normal(0, 4, (h, w)), axis=1)
    return (base - base.min()).clip(0, 255).astype(np.uint8)


def _corrupt_block(stream, b):
    """Zero block ``b``'s interior bytes: a guaranteed-desync corruption.

    A SINGLE flipped byte often re-synchronizes (the corrupted stream is
    itself a valid encoding of wrong content with the same bit length —
    see test_resynced_flip_is_the_documented_blind_spot), which no
    redundancy-free check can detect; zeroing the block's span collapses
    its codes to the minimum width and slips the end position for any
    non-degenerate table, which IS what the end-bit check pins.
    """
    import dataclasses

    offs = stream.block_offsets.astype(np.int64)
    end_bit = (int(offs[b + 1]) if b + 1 < offs.size
               else 8 * (stream.code_bytes.size - 2))
    lo, hi = int(offs[b]) // 8 + 1, end_bit // 8 - 1
    code = stream.code_bytes.copy()
    code[lo:hi] = 0
    return dataclasses.replace(stream, code_bytes=code)


BACKENDS = ["native", "pallas", "xla"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_region_check_clean(backend):
    img = _image(48, 64, seed=1)
    codec = ImageCodec(CodecConfig(backend=backend))
    stream = codec.encode(img)
    out = codec.decode_region(stream, 48, 64, 10, 19, 21, 26, check=True)
    np.testing.assert_array_equal(out, img[10:31, 19:45])


@pytest.mark.parametrize("backend", BACKENDS)
def test_region_check_catches_inside_corruption(backend):
    img = _image(48, 64, seed=2)
    codec = ImageCodec(CodecConfig(backend=backend))
    stream = codec.encode(img)
    # region rows 16..32, cols 24..48 -> block rect rows 2..4, cols 3..6 of
    # the 6x8 grid; block (2, 4) = index 20 is inside the selection
    bad = _corrupt_block(stream, 2 * 8 + 4)
    with pytest.raises(ValueError, match="integrity"):
        codec.decode_region(bad, 48, 64, 16, 24, 16, 24, check=True)


@pytest.mark.parametrize("backend", BACKENDS)
def test_region_check_ignores_outside_corruption(backend):
    img = _image(48, 64, seed=3)
    codec = ImageCodec(CodecConfig(backend=backend))
    stream = codec.encode(img)
    # corrupt block (2, 7) — same block ROW as the region (so its bytes sit
    # inside the staged word range) but outside the selected columns
    bad = _corrupt_block(stream, 2 * 8 + 7)
    out = codec.decode_region(bad, 48, 64, 16, 24, 16, 24, check=True)
    np.testing.assert_array_equal(out, img[16:32, 24:48])


@pytest.mark.parametrize("backend", BACKENDS)
def test_region_check_last_block_window(backend):
    # a region touching the stream's LAST block exercises the byte-rounding
    # window check (the end is only known to within 7 bits) instead of the
    # exact next-offset target
    img = _image(32, 32, seed=4)
    codec = ImageCodec(CodecConfig(backend=backend))
    stream = codec.encode(img)
    out = codec.decode_region(stream, 32, 32, 24, 24, 8, 8, check=True)
    np.testing.assert_array_equal(out, img[24:, 24:])
    bad = _corrupt_block(stream, 15)  # the last block itself
    with pytest.raises(ValueError, match="integrity"):
        codec.decode_region(bad, 32, 32, 24, 24, 8, 8, check=True)


def test_resynced_flip_is_the_documented_blind_spot():
    # a single flipped byte that re-synchronizes yields a corrupted stream
    # that is ITSELF a valid encoding of wrong content with the same block
    # bit length — no redundancy-free check can catch it, and the end-bit
    # check documents exactly this caveat (ops/decode_pallas.py integrity
    # notes). Pin the behavior: content differs, check passes.
    import dataclasses

    img = _image(32, 32, seed=4)
    codec = ImageCodec(CodecConfig(backend="native"))
    stream = codec.encode(img)
    code = stream.code_bytes.copy()
    code[int(stream.block_offsets[15]) // 8 + 1] ^= 0xFF  # slips 0 bits
    bad = dataclasses.replace(stream, code_bytes=code)
    out = codec.decode_region(bad, 32, 32, 24, 24, 8, 8, check=True)
    assert (out != img[24:, 24:]).any()  # wrong content, same bit length


@pytest.mark.parametrize("mode", ["plain", "zero_init", "delta2d", "nodelta"])
def test_region_check_modes(mode):
    img = _image(40, 40, seed=5)
    cfg = CodecConfig(backend="native",
                      delta=mode != "nodelta",
                      zero_init=mode == "zero_init",
                      delta2d=mode == "delta2d")
    codec = ImageCodec(cfg)
    stream = codec.encode(img)
    out = codec.decode_region(stream, 40, 40, 8, 8, 16, 16, check=True)
    np.testing.assert_array_equal(out, img[8:24, 8:24])
    bad = _corrupt_block(stream, 1 * 5 + 1)
    with pytest.raises(ValueError, match="integrity"):
        codec.decode_region(bad, 40, 40, 8, 8, 16, 16, check=True)


def _frames(t, h, w, seed=0):
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.normal(0, 5, (t, h, w)), axis=2)
    return (base - base.min()).clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize("backend", ["native", "pallas"])
def test_video_region_check(backend):
    frames = _frames(4, 24, 40, seed=6)
    cfg = CodecConfig(backend=backend)
    stream = frame_stream.encode_frames_shared(frames, cfg)
    blob = frame_stream.write_shared(stream, 4, 24, 40, cfg)
    out = frame_stream.decode_video_region(
        blob, 1, 3, 8, 16, 8, 16, cfg, check=True)
    np.testing.assert_array_equal(out, frames[1:3, 8:16, 16:32])

    # corrupt a block of frame 1 inside the region: grid is 3x5 per frame;
    # region rows 8..16 cols 16..32 -> block rows 1..2, cols 2..4
    per = 3 * 5
    bad_stream = _corrupt_block(stream, per * 1 + 1 * 5 + 2)
    bad_blob = frame_stream.write_shared(bad_stream, 4, 24, 40, cfg)
    with pytest.raises(ValueError, match="frames \\[1\\]"):
        frame_stream.decode_video_region(
            bad_blob, 1, 3, 8, 16, 8, 16, cfg, check=True)

    # the same corruption is invisible to a region of frame 2 only
    out2 = frame_stream.decode_video_region(
        bad_blob, 2, 3, 8, 16, 8, 16, cfg, check=True)
    np.testing.assert_array_equal(out2, frames[2:3, 8:16, 16:32])


def test_cli_region_check(tmp_path):
    from metalhuffman import cli

    frames = _frames(3, 16, 32, seed=7)
    src = tmp_path / "f.npy"
    np.save(src, frames)
    vid = tmp_path / "v.mhtv"
    assert cli.main(["encode-video", str(src), str(vid),
                     "--backend", "native"]) == 0
    out = tmp_path / "r.npy"
    assert cli.main(["decode-video", str(vid), str(out),
                     "--region", "4", "8", "8", "16", "--frames", "0", "2",
                     "--check", "--backend", "native"]) == 0
    np.testing.assert_array_equal(np.load(out), frames[0:2, 4:12, 8:24])

    # corrupt the payload mid-file: --check must now fail, plain must not
    data = bytearray(vid.read_bytes())
    data[len(data) // 2 : len(data) // 2 + 16] = bytes(16)
    bad = tmp_path / "bad.mhtv"
    bad.write_bytes(bytes(data))
    with pytest.raises(SystemExit, match="integrity"):
        cli.main(["decode-video", str(bad), str(out),
                  "--region", "0", "0", "16", "32", "--frames", "0", "3",
                  "--check", "--backend", "native"])


def test_region_salvage_refused(tmp_path):
    from metalhuffman import cli

    frames = _frames(2, 16, 16, seed=8)
    src = tmp_path / "f.npy"
    np.save(src, frames)
    vid = tmp_path / "v.mhtv"
    assert cli.main(["encode-video", str(src), str(vid),
                     "--backend", "native"]) == 0
    with pytest.raises(SystemExit, match="salvage"):
        cli.main(["decode-video", str(vid), str(tmp_path / "o.npy"),
                  "--region", "0", "0", "8", "8", "--check", "--salvage",
                  "--backend", "native"])


def test_temporal_region_check(tmp_path):
    from metalhuffman.models import temporal

    frames = _frames(6, 16, 24, seed=9)
    cfg = CodecConfig(backend="native", temporal=True, keyint=3)
    blob = temporal.encode_temporal_video(frames, cfg)
    out = temporal.decode_temporal_video_region(
        blob, 2, 5, 4, 4, 8, 8, cfg, check=True)
    np.testing.assert_array_equal(out, frames[2:5, 4:12, 4:12])


def test_mc_region_check_requires_frame_crcs(tmp_path):
    """The MC region fallback cannot run the end-bit crop check; check=True
    must therefore refuse without a per-frame CRC table rather than
    silently decode unchecked (round-4 review finding), and verify via
    the table when one is recorded."""
    from metalhuffman.models import temporal

    frames = _frames(6, 16, 24, seed=11)
    cfg = CodecConfig(backend="native", temporal=True, keyint=3, motion=True)
    blob = temporal.encode_temporal_video(frames, cfg)
    with pytest.raises(ValueError, match="frame-crcs|per-frame CRC"):
        temporal.decode_temporal_video_region(
            blob, 1, 4, 4, 4, 8, 8, cfg, check=True)
    import dataclasses

    blob2 = temporal.encode_temporal_video(
        frames, dataclasses.replace(cfg, frame_crcs=True))
    out = temporal.decode_temporal_video_region(
        blob2, 1, 4, 4, 4, 8, 8, cfg, check=True)
    np.testing.assert_array_equal(out, frames[1:4, 4:12, 4:12])


def test_strips_available_predicts_raw_path():
    """The header-only probe must agree with the strips decode's own
    applicability (no discarded decodes). Geometry no longer gates it —
    round 5's padded roll lets MC ride any plannable strip layout."""
    from metalhuffman.models import temporal

    cfg = CodecConfig(backend="pallas")
    for h, w in [(16, 512), (16, 500), (12, 512)]:
        frames = _frames(2, h, w, seed=13)
        enc = frame_stream.encode_frames_shared(
            frames, CodecConfig(backend="native"))
        inner = frame_stream.write_shared(enc, 2, h, w,
                                          CodecConfig(backend="native"))
        raw = temporal._device_gray_strips(inner, cfg)
        assert temporal._strips_available(inner) == (raw is not None), (h, w)


def test_extract_reports_reencoded_frames():
    from metalhuffman.models import surgery, temporal

    frames = _frames(7, 16, 24, seed=15)
    cfg = CodecConfig(backend="native", temporal=True, keyint=3)
    blob = temporal.encode_temporal_video(frames, cfg)
    info = {}
    surgery.extract_video(blob, 3, 7, info)  # keyframe start
    assert info["reencoded_frames"] == 0
    info = {}
    surgery.extract_video(blob, 4, 7, info)  # mid-group: re-keys 4..6
    assert info["reencoded_frames"] == 2
    info = {}
    surgery.extract_video(blob, 4, 5, info)  # cut inside the group
    assert info["reencoded_frames"] == 1


def test_selection_end_targets_values():
    img = _image(16, 24, seed=10)
    codec = ImageCodec(CodecConfig(backend="native"))
    stream = codec.encode(img)
    offs = stream.block_offsets.astype(np.int64)
    sel = np.array([0, 3, offs.size - 1])
    t = image_codec.selection_end_targets(stream, sel)
    assert t[0] == (offs[0] & 31) + (offs[1] - offs[0])
    assert t[1] == (offs[3] & 31) + (offs[4] - offs[3])
    assert t[2] == -1  # last block: window-checked separately

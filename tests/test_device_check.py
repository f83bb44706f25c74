"""On-device stream-integrity check (decode_pallas emit_end_bits).

The kernel surfaces each block's final bit position; comparing against the
offset index flags corrupt/desynced blocks — the device analog of the
reference's decode-verify assert (AAPLRenderer.m:1849-1876), tested here on
the kernel's interpret path and on the plain-XLA path.
"""

import numpy as np
import pytest

from metalhuffman.core import encode_symbols
from metalhuffman.core.container import EncodedStream
from metalhuffman.models import CodecConfig, frame_stream
from metalhuffman.ops import decode_pallas


def _stream(n_blocks=300, seed=3):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, n_blocks * 64, dtype=np.uint8)
    # skewed histogram -> varied code widths
    data = np.minimum(data, rng.integers(0, 256, data.size, dtype=np.uint8))
    return data, encode_symbols(data, block_size=64)


def _corrupt(stream: EncodedStream, block: int) -> EncodedStream:
    """Overwrite bytes inside ``block`` so its bit consumption shifts.

    A run of 0xFF decodes as maximal-width codes, overshooting the block's
    bit budget — a persistent desync the end-position check must flag. (A
    single flipped bit often RE-syncs — canonical Huffman self-synchronizes
    — ending at the right position with wrong content; that case is what
    the container CRC is for.)
    """
    code = stream.code_bytes.copy()
    start = int(stream.block_offsets[block]) // 8 + 2
    code[start : start + 8] = 0xFF
    return EncodedStream(
        stream.num_symbols, stream.widths, code, stream.block_offsets)


def test_clean_stream_no_errors():
    _, enc = _stream()
    blocks, err = decode_pallas.decode_stream_checked(
        enc, delta=False)
    assert not err.any()


def test_corrupt_block_flagged_tile_path():
    data, enc = _stream()
    bad = 137
    blocks, err = decode_pallas.decode_stream_checked(
        _corrupt(enc, bad), delta=False)
    assert err[bad], "corrupted block must be flagged"
    # corruption is block-local: every other complete block still decodes
    others = np.ones(err.size, bool)
    others[bad] = False
    assert not err[others].any()
    exp = data.reshape(-1, 64)
    got = np.asarray(blocks)
    assert np.array_equal(got[others], exp[others])


def test_truncated_stream_flagged():
    _, enc = _stream()
    cut = int(enc.block_offsets[250]) // 8
    code = enc.code_bytes.copy()
    code[cut:] = 0
    _, err = decode_pallas.decode_stream_checked(
        EncodedStream(enc.num_symbols, enc.widths, code, enc.block_offsets),
        delta=False)
    assert err[250:-1].any(), "zeroed tail must desync some blocks"
    assert not err[:249].any()


@pytest.mark.parametrize("shape", [(64, 1024), (64, 520)])
def test_shared_checked_image_path(shape):
    h, w = shape
    rng = np.random.default_rng(11)
    # skewed histogram -> varied widths (a flat 8-bit table would make the
    # whole stream fixed-width and trivially end-synced)
    frames = np.minimum(rng.integers(0, 256, (2, h, w), dtype=np.uint8),
                        rng.integers(0, 256, (2, h, w), dtype=np.uint8))
    cfg = CodecConfig(backend="pallas", delta=False)
    stream = frame_stream.encode_frames_shared(frames, cfg)
    prep = frame_stream.prepare_shared(stream, 2, h, w, cfg, check=True)
    out, err = frame_stream.decode_shared_step_checked(prep, cfg)
    assert np.array_equal(np.asarray(out), frames)
    assert not err.any()

    bad = err.size // 2
    prep_bad = frame_stream.prepare_shared(
        _corrupt(stream, bad), 2, h, w, cfg, check=True)
    _, err2 = frame_stream.decode_shared_step_checked(prep_bad, cfg)
    assert err2[bad]
    others = np.ones(err2.size, bool)
    others[bad] = False
    assert not err2[others].any()


def test_shared_checked_generic_path():
    # block_dim=4: one image word per block row
    rng = np.random.default_rng(12)
    frames = rng.integers(0, 256, (2, 32, 144), dtype=np.uint8)
    cfg = CodecConfig(backend="pallas", block_dim=4)
    stream = frame_stream.encode_frames_shared(frames, cfg)
    prep = frame_stream.prepare_shared(stream, 2, 32, 144, cfg, check=True)
    out, err = frame_stream.decode_shared_step_checked(prep, cfg)
    assert np.array_equal(np.asarray(out), frames)
    assert not err.any()

    bad = 100
    prep_bad = frame_stream.prepare_shared(
        _corrupt(stream, bad), 2, 32, 144, cfg, check=True)
    _, err2 = frame_stream.decode_shared_step_checked(prep_bad, cfg)
    assert err2[bad]


def test_raw_strips_checked():
    rng = np.random.default_rng(13)
    frames = rng.integers(0, 256, (2, 64, 1024), dtype=np.uint8)
    cfg = CodecConfig(backend="pallas")
    stream = frame_stream.encode_frames_shared(frames, cfg)
    prep = frame_stream.prepare_shared(stream, 2, 64, 1024, cfg, check=True)
    raw, err = frame_stream.decode_shared_step_checked(prep, cfg, raw=True)
    got = frame_stream.frames_from_raw(raw, 2, 64, 1024)
    assert np.array_equal(got, frames)
    assert not err.any()


def test_last_block_window_checked():
    """The LAST block is verified via the byte-rounded window (review fix):
    zeroing its bytes must flag it even though its exact end is unindexed."""
    rng = np.random.default_rng(14)
    frames = np.minimum(rng.integers(0, 256, (2, 16, 32), dtype=np.uint8),
                        rng.integers(0, 256, (2, 16, 32), dtype=np.uint8))
    cfg = CodecConfig(backend="pallas", delta=False)
    stream = frame_stream.encode_frames_shared(frames, cfg)
    prep = frame_stream.prepare_shared(stream, 2, 16, 32, cfg, check=True)
    assert prep.last_window is not None
    _, err = frame_stream.decode_shared_step_checked(prep, cfg)
    assert not err.any()

    code = stream.code_bytes.copy()
    code[int(stream.block_offsets[-1]) // 8 + 1 :] = 0
    bad = EncodedStream(
        stream.num_symbols, stream.widths, code, stream.block_offsets)
    prep_bad = frame_stream.prepare_shared(bad, 2, 16, 32, cfg, check=True)
    _, err2 = frame_stream.decode_shared_step_checked(prep_bad, cfg)
    assert err2[-1], "last-block corruption must be flagged"


def test_last_block_window_image_path():
    rng = np.random.default_rng(15)
    frames = np.minimum(rng.integers(0, 256, (2, 16, 1024), dtype=np.uint8),
                        rng.integers(0, 256, (2, 16, 1024), dtype=np.uint8))
    cfg = CodecConfig(backend="pallas", delta=False)
    stream = frame_stream.encode_frames_shared(frames, cfg)
    prep = frame_stream.prepare_shared(stream, 2, 16, 1024, cfg, check=True)
    assert prep.last_window is not None
    _, err = frame_stream.decode_shared_step_checked(prep, cfg)
    assert not err.any()

    code = stream.code_bytes.copy()
    code[int(stream.block_offsets[-1]) // 8 + 1 :] = 0
    bad = EncodedStream(
        stream.num_symbols, stream.widths, code, stream.block_offsets)
    prep_bad = frame_stream.prepare_shared(bad, 2, 16, 1024, cfg, check=True)
    _, err2 = frame_stream.decode_shared_step_checked(prep_bad, cfg)
    assert err2[-1]


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_checked_2x2_blocks_and_xla_path(backend):
    """End bits from the kernel's block emission (2x2 blocks) and from the
    plain-XLA decode flag the same corrupt block."""
    rng = np.random.default_rng(16)
    frames = np.minimum(rng.integers(0, 256, (2, 16, 24), dtype=np.uint8),
                        rng.integers(0, 256, (2, 16, 24), dtype=np.uint8))
    cfg = CodecConfig(backend=backend, block_dim=2, delta=False)
    stream = frame_stream.encode_frames_shared(frames, cfg)
    prep = frame_stream.prepare_shared(stream, 2, 16, 24, cfg, check=True)
    out, err = frame_stream.decode_shared_step_checked(prep, cfg)
    assert np.array_equal(np.asarray(out), frames) and not err.any()
    bad = 60
    code = stream.code_bytes.copy()
    start = int(stream.block_offsets[bad]) // 8 + 1  # inside the 2x2 block
    code[start : start + 8] = 0xFF
    corrupt = EncodedStream(
        stream.num_symbols, stream.widths, code, stream.block_offsets)
    prep_bad = frame_stream.prepare_shared(corrupt, 2, 16, 24, cfg, check=True)
    _, err2 = frame_stream.decode_shared_step_checked(prep_bad, cfg)
    assert err2[bad]
    assert not err2[: bad - 1].any()


# -- salvage (round 3: best-effort serving decode) -------------------------------


def _corrupt_video_blob(frames, cfg, block=5):
    import metalhuffman as mh

    blob = bytearray(mh.encode_video(frames, cfg))
    # locate the code bytes inside the MHTV container and wreck one block
    stream, t, h, w, bd, delta = frame_stream.read_shared(bytes(blob))
    start_bit = int(stream.block_offsets[block])
    # core blob layout: 26-byte MHTV head + u32 core_len... find code start
    import struct

    (core_len,) = struct.unpack_from("<I", bytes(blob), 22)
    # core blob: 8-byte header + 256-byte table, then code bytes
    code_off = 26 + 8 + 256 + start_bit // 8 + 2
    blob[code_off : code_off + 8] = b"\xff" * 8
    return bytes(blob)


def test_cli_salvage(tmp_path, capsys):
    from metalhuffman.cli import main

    rng = np.random.default_rng(7)
    frames = np.minimum(
        rng.integers(0, 256, (3, 32, 64), np.uint8),
        rng.integers(0, 256, (3, 32, 64), np.uint8))
    cfg = CodecConfig(backend="native")
    blob = _corrupt_video_blob(frames, cfg)
    bad = tmp_path / "bad.mhtv"
    bad.write_bytes(blob)
    out = tmp_path / "out.npy"
    # without --salvage: the check fails loudly
    with pytest.raises(SystemExit, match="integrity check failed"):
        main(["decode-video", str(bad), str(out), "--check"])
    # with --salvage: decodes, zero-fills the flagged blocks, still exits 0
    main(["decode-video", str(bad), str(out), "--check", "--salvage"])
    got = np.load(out)
    assert got.shape == frames.shape
    # undamaged blocks are intact; at least one block was zero-filled
    diff_blocks = (got != frames).reshape(3, 4, 8, 8, 8).any((2, 4)).sum()
    assert 1 <= diff_blocks <= 8, diff_blocks
    # --salvage without --check refuses
    with pytest.raises(SystemExit, match="salvage needs --check"):
        main(["decode-video", str(bad), str(out), "--salvage"])


def test_salvage_blocks_inplace():
    frames = np.ones((2, 16, 24), np.uint8)
    err = np.zeros(2 * 2 * 3, bool)  # 8x8 blocks: 2x3 grid per frame
    err[[1, 7]] = True  # frame 0 block (0,1); frame 1 block (0,1)
    frames, n = frame_stream.salvage_blocks(frames, err, 8)
    assert n == 2
    assert (frames[0, 0:8, 8:16] == 0).all()
    assert (frames[1, 0:8, 8:16] == 0).all()
    assert frames.sum() == 2 * 16 * 24 - 2 * 64  # everything else untouched


def test_cli_salvage_segmented(tmp_path):
    from metalhuffman.cli import main

    rng = np.random.default_rng(9)
    frames = np.minimum(
        rng.integers(0, 256, (6, 24, 32), np.uint8),
        rng.integers(0, 256, (6, 24, 32), np.uint8))
    cfg = CodecConfig(backend="native")
    segs = frame_stream.encode_frames_segmented(frames, cfg,
                                                max_segment_bits=16_000)
    assert len(segs) > 1
    blob = bytearray(frame_stream.write_segmented(segs, 24, 32, cfg))
    # wreck one block inside the SECOND segment's code bytes
    import struct

    pos = 4 + 18  # MHV2 head
    ft0, nb0, cl0 = struct.unpack_from("<III", bytes(blob), pos)
    pos += 12 + cl0 + 4 * nb0  # past segment 0
    ft1, nb1, cl1 = struct.unpack_from("<III", bytes(blob), pos)
    seg1_stream = segs[1][0]
    code_off = pos + 12 + 8 + 256 + int(seg1_stream.block_offsets[2]) // 8 + 2
    blob[code_off : code_off + 6] = b"\xff" * 6
    bad = tmp_path / "bad.mhv2"
    bad.write_bytes(bytes(blob))
    out = tmp_path / "out.npy"
    with pytest.raises(SystemExit, match="segment 1"):
        main(["decode-video", str(bad), str(out), "--check"])
    main(["decode-video", str(bad), str(out), "--check", "--salvage"])
    got = np.load(out)
    assert got.shape == frames.shape
    # segment 0's frames are untouched
    assert np.array_equal(got[0], frames[0])

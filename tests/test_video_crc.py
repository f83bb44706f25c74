"""Source-payload CRC-32 in the video containers.

The on-device end-bit check verifies each block ends at its indexed bit
position, but corruption that substitutes codes of the SAME width preserves
every block's bit length and passes it (observed with a single flipped code
byte on real photo content). The container CRC is the backstop — the
streaming analog of the reference's byte-for-byte decode verify
(``AAPLRenderer.m:1849-1876``).
"""

import numpy as np
import pytest

import metalhuffman as mht
from metalhuffman.models import frame_stream
from metalhuffman.models.image_codec import CodecConfig


def _frames(t, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(128, 20, (t, h, w)).clip(0, 255).astype(np.uint8)


def _length_preserving_corruption(stream):
    """Flip code bits inside some block so its total bit length is preserved.

    Canonical codes of one width are consecutive integers left-justified in
    the window; toggling the lowest bit of a code whose symbol has an
    odd-index/even-index neighbor of the SAME width yields another valid
    code of that width. We brute-force a byte whose flip keeps every
    block boundary intact but changes decoded output.
    """
    from metalhuffman.core import tables, decode_ref

    sp, wp = tables.build_single_table(stream.widths)
    offs = stream.block_offsets.astype(np.int64)
    code = np.asarray(stream.code_bytes)

    def block_of(bit):
        return int(np.searchsorted(offs, bit, side="right") - 1)

    def block_end(buf, b):
        bits = int(offs[b])
        for _ in range(64):
            win = decode_ref._window16(buf, bits)
            bits += int(wp[win])
        return bits

    for byte_idx in range(8, code.size - 8):
        bit = (byte_idx - 0) * 8
        b = block_of(bit)
        if b < 0 or b + 1 >= offs.size:
            continue
        for flip in (0xFF, 0x0F, 0x03, 0x01):
            trial = code.copy()
            trial[byte_idx] ^= flip
            if block_end(trial, b) != block_end(code, b):
                continue
            # must also not damage the neighboring block sharing the byte
            if block_of(bit + 7) != b and block_end(trial, b + 1) != \
                    block_end(code, b + 1):
                continue
            a = decode_ref.decode_single_table(code, sp, wp, 64, int(offs[b]))
            c = decode_ref.decode_single_table(trial, sp, wp, 64, int(offs[b]))
            if not np.array_equal(a, c):
                return trial
    pytest.skip("no length-preserving corruption found for this table")


def test_mhtv_crc_recorded_and_verified():
    frames = _frames(3, 16, 32, seed=1)
    cfg = CodecConfig()
    blob = mht.encode_video(frames, cfg)
    assert blob[:4] == frame_stream.SHARED_MAGIC
    assert frame_stream.source_crc32(blob) != 0
    np.testing.assert_array_equal(mht.decode_video(blob, cfg), frames)


def test_mhtv_crc_catches_length_preserving_corruption():
    frames = _frames(3, 16, 32, seed=2)
    cfg = CodecConfig()
    blob = mht.encode_video(frames, cfg)
    stream, t, h, w, bd, delta = frame_stream.read_shared(blob)

    bad_code = _length_preserving_corruption(stream)
    import dataclasses
    bad_stream = dataclasses.replace(stream, code_bytes=bad_code)
    bad = frame_stream.write_shared(
        bad_stream, t, h, w, cfg, source_crc32=frame_stream.source_crc32(blob))

    # the end-bit check passes by construction — the CRC must catch it
    prep = frame_stream.prepare_shared(bad_stream, t, h, w, cfg, check=True)
    _, err = frame_stream.decode_shared_step_checked(prep, cfg)
    assert not err.any(), "corruption was not length-preserving (test bug)"
    with pytest.raises(ValueError, match="CRC-32 mismatch"):
        mht.decode_video(bad, cfg)


def test_mhtv_pre_trailer_container_parses_as_unrecorded():
    frames = _frames(2, 16, 16, seed=3)
    cfg = CodecConfig()
    stream = frame_stream.encode_frames_shared(frames, cfg)
    legacy = frame_stream.write_shared(stream, 2, 16, 16, cfg)[:-4]
    assert frame_stream.source_crc32(legacy) == 0
    s2, t, h, w, bd, delta = frame_stream.read_shared(legacy)
    out = frame_stream.decode_frames_segmented([(s2, t)], h, w,
                                               CodecConfig(backend="native"))
    np.testing.assert_array_equal(out, frames)


def test_mhv2_crc_trailer():
    frames = _frames(4, 16, 32, seed=4)
    cfg = CodecConfig()
    segs = frame_stream.encode_frames_segmented(
        frames, cfg, max_segment_bits=2 * 16 * 32 * 16)
    assert len(segs) >= 2
    import zlib
    crc = zlib.crc32(frames.tobytes())
    blob = frame_stream.write_segmented(segs, 16, 32, cfg, source_crc32=crc)
    assert frame_stream.source_crc32(blob) == crc
    np.testing.assert_array_equal(mht.decode_video(blob, cfg), frames)
    # corrupt a code byte in segment 0 -> toplevel decode raises
    bad = bytearray(blob)
    bad[4 + 18 + 12 + 8 + 256 + 5] ^= 0xFF
    with pytest.raises(ValueError):
        mht.decode_video(bytes(bad), cfg)


def test_mhts_per_frame_crcs():
    import zlib

    frames = _frames(3, 16, 16, seed=5)
    cfg = CodecConfig()
    streams = frame_stream.encode_frames(frames, cfg)
    crcs = [zlib.crc32(f.tobytes()) for f in frames]
    blob = frame_stream.write_stream(streams, 16, 16, cfg, source_crc32s=crcs)
    assert frame_stream.read_stream_crcs(blob) == [c & 0xFFFFFFFF for c in crcs]
    with pytest.raises(ValueError, match="one entry per frame"):
        frame_stream.write_stream(streams, 16, 16, cfg, source_crc32s=[1])


def test_cli_decode_video_verifies_crc(tmp_path):
    from metalhuffman import cli

    frames = _frames(2, 16, 16, seed=6)
    src = tmp_path / "f.npy"
    np.save(src, frames)
    mhtv = tmp_path / "v.mhtv"
    assert cli.main(["encode-video", str(src), str(mhtv),
                     "--backend", "pallas", "--interpret"]) == 0
    out = tmp_path / "o.npy"
    assert cli.main(["decode-video", str(mhtv), str(out),
                     "--backend", "pallas", "--interpret"]) == 0
    np.testing.assert_array_equal(np.load(out), frames)

    stream, t, h, w, bd, delta = frame_stream.read_shared(mhtv.read_bytes())
    bad_code = _length_preserving_corruption(stream)
    import dataclasses
    bad_stream = dataclasses.replace(stream, code_bytes=bad_code)
    crc = frame_stream.source_crc32(mhtv.read_bytes())
    (tmp_path / "bad.mhtv").write_bytes(frame_stream.write_shared(
        bad_stream, t, h, w, CodecConfig(), source_crc32=crc))
    with pytest.raises(SystemExit, match="CRC-32 mismatch"):
        cli.main(["decode-video", str(tmp_path / "bad.mhtv"),
                  str(tmp_path / "o2.npy"), "--check",
                  "--backend", "pallas", "--interpret"])


def test_color_roundtrip_crc():
    from metalhuffman.models import color

    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, (24, 32, 3), np.uint8)
    cfg = CodecConfig()
    blob = color.encode_color_to_bytes(img, cfg)
    # the CRC trailer lives in the inner plane container of the MHTC wrapper
    assert frame_stream.source_crc32(color.unwrap(blob)[0]) != 0
    np.testing.assert_array_equal(color.decode_color_from_bytes(blob, cfg), img)


# --- `verify` subcommand: one front door for every integrity check --------


def test_cli_verify_mht1(tmp_path, capsys):
    from metalhuffman import cli
    from metalhuffman.utils import imageio

    rng = np.random.default_rng(8)
    img = rng.normal(100, 30, (32, 48)).clip(0, 255).astype(np.uint8)
    src = tmp_path / "in.gray"
    imageio.save_grayscale(img, src)
    mht = tmp_path / "a.mht"
    assert cli.main(["encode", str(src), str(mht)]) == 0
    assert cli.main(["verify", str(mht), "--backend", "pallas",
                     "--interpret"]) == 0
    out = capsys.readouterr().out
    assert "PASS" in out and "end-bit check  ok" in out
    assert "source CRC-32  ok" in out

    # native backend: end-bit check is skipped but the CRC still gates
    assert cli.main(["verify", str(mht), "--backend", "native"]) == 0
    assert "skipped" in capsys.readouterr().out

    bad = bytearray(mht.read_bytes())
    bad[26 + 8 + 256 + 5] ^= 0xFF  # corrupt a code byte (header+table skipped)
    (tmp_path / "bad.mht").write_bytes(bytes(bad))
    with pytest.raises(SystemExit):
        cli.main(["verify", str(tmp_path / "bad.mht"), "--backend", "pallas",
                  "--interpret"])


def test_cli_verify_mhtv_and_corruption(tmp_path, capsys):
    from metalhuffman import cli

    frames = _frames(2, 16, 32, seed=9)
    src = tmp_path / "f.npy"
    np.save(src, frames)
    mhtv = tmp_path / "v.mhtv"
    assert cli.main(["encode-video", str(src), str(mhtv),
                     "--backend", "pallas", "--interpret"]) == 0
    capsys.readouterr()  # drain the encode-video status line
    assert cli.main(["verify", str(mhtv), "--backend", "pallas",
                     "--interpret"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("MHTV") and "PASS" in out

    # length-preserving corruption: end-bit check passes, CRC catches it
    stream, t, h, w, bd, delta = frame_stream.read_shared(mhtv.read_bytes())
    bad_code = _length_preserving_corruption(stream)
    import dataclasses
    bad_stream = dataclasses.replace(stream, code_bytes=bad_code)
    crc = frame_stream.source_crc32(mhtv.read_bytes())
    (tmp_path / "bad.mhtv").write_bytes(frame_stream.write_shared(
        bad_stream, t, h, w, CodecConfig(), source_crc32=crc))
    with pytest.raises(SystemExit, match="CRC-32 mismatch"):
        cli.main(["verify", str(tmp_path / "bad.mhtv"), "--backend", "pallas",
                  "--interpret"])


def test_cli_verify_mhts(tmp_path, capsys):
    from metalhuffman import cli

    frames = _frames(2, 16, 16, seed=10)
    src = tmp_path / "f.npy"
    np.save(src, frames)
    mhts = tmp_path / "v.mhts"
    assert cli.main(["encode-video", str(src), str(mhts), "--per-frame-tables",
                     "--backend", "pallas", "--interpret"]) == 0
    capsys.readouterr()  # drain the encode-video status line
    assert cli.main(["verify", str(mhts), "--backend", "pallas",
                     "--interpret"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("MHTS") and "PASS" in out


# -- per-frame CRC tables (round 3: random access verifies its slice) ----------


def test_fcrc_extension_roundtrip_and_random_access():
    frames = _frames(6, 24, 32)
    cfg = CodecConfig(backend="native", frame_crcs=True)
    blob = mht.encode_video(frames, cfg)
    fcrcs = frame_stream.read_frame_crcs(blob)
    assert fcrcs is not None and fcrcs.shape == (6,)
    # full decode still verifies the whole-payload CRC
    assert np.array_equal(mht.decode_video(blob, cfg), frames)
    # range decode verifies exactly its slice
    got, _h, _w = frame_stream.decode_range(blob, 2, 5, cfg)
    assert np.array_equal(got, frames[2:5])
    # a container without the extension parses as None (backward compat)
    plain = mht.encode_video(frames, CodecConfig(backend="native"))
    assert frame_stream.read_frame_crcs(plain) is None


def test_fcrc_tamper_caught_by_range_decode():
    frames = _frames(6, 24, 32)
    cfg = CodecConfig(backend="native", frame_crcs=True)
    blob = bytearray(mht.encode_video(frames, cfg))
    # flip one bit in frame 3's recorded CRC: the table itself is the
    # tamper target (equivalently, a corrupted frame mismatches its entry)
    pos = frame_stream._trailer_offset(bytes(blob)) + 4 + 8 + 4 * 3
    blob[pos] ^= 1
    with pytest.raises(ValueError, match="frame 3 fails"):
        frame_stream.decode_range(bytes(blob), 3, 4,
                                  CodecConfig(backend="native"))
    # frames outside the tampered entry still verify
    got, _h, _w = frame_stream.decode_range(bytes(blob), 0, 3,
                                            CodecConfig(backend="native"))
    assert np.array_equal(got, frames[:3])


def test_mhvt_frame_crcs_random_access():
    from metalhuffman.models import temporal

    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (24, 32), np.uint8)
    frames = np.stack([np.roll(base, (2 * i, 3 * i), (0, 1))
                       for i in range(7)])
    cfg = CodecConfig(backend="native", temporal=True, keyint=3,
                      motion=True, frame_crcs=True)
    blob = mht.encode_video(frames, cfg)
    _i, _k, _c, _m, fcrcs, _fl = temporal.unwrap(blob)
    assert fcrcs is not None and fcrcs.shape == (7,)
    dec = CodecConfig(backend="native")
    for n in (0, 3, 6):
        assert np.array_equal(
            temporal.decode_temporal_frame(blob, n, dec), frames[n])
    assert np.array_equal(
        temporal.decode_temporal_range(blob, 2, 6, dec), frames[2:6])
    # tamper with frame 4's entry: random access touching it must fail
    blob2 = bytearray(blob)
    # layout: magic+8 header | motion table (4 + 7*4) | fcrc (4 + 7*4)
    pos = 12 + 4 + 7 * 4 + 4 + 4 * 4
    blob2[pos] ^= 1
    with pytest.raises(ValueError, match="frame 4 fails"):
        temporal.decode_temporal_frame(bytes(blob2), 4, dec)
    with pytest.raises(ValueError, match="frame 4 fails"):
        temporal.decode_temporal_video(bytes(blob2), dec)
    # untouched frames still decode
    assert np.array_equal(
        temporal.decode_temporal_frame(bytes(blob2), 0, dec), frames[0])


def test_cli_frame_crcs_check(tmp_path):
    from metalhuffman.cli import main

    frames = _frames(5, 24, 32)
    src = tmp_path / "v.npy"
    np.save(src, frames)
    out = tmp_path / "v.mhvt"
    main(["encode-video", str(src), str(out), "--temporal", "--keyint", "2",
          "--frame-crcs", "--backend", "native"])
    f3 = tmp_path / "f3.npy"
    main(["decode-video", str(out), str(f3), "--frame", "3",
          "--check", "--backend", "native"])
    assert np.array_equal(np.load(f3), frames[3])
    # plain MHTV with the FCRC extension
    out2 = tmp_path / "v.mhtv"
    main(["encode-video", str(src), str(out2), "--frame-crcs",
          "--backend", "native"])
    f2 = tmp_path / "f2.npy"
    main(["decode-video", str(out2), str(f2), "--frame", "2",
          "--check", "--backend", "native"])
    assert np.array_equal(np.load(f2), frames[2])
    # without the table, --frame --check refuses with guidance
    out3 = tmp_path / "plain.mhtv"
    main(["encode-video", str(src), str(out3), "--backend", "native"])
    with pytest.raises(SystemExit, match="frame-crcs"):
        main(["decode-video", str(out3), str(f2), "--frame", "2",
              "--check", "--backend", "native"])

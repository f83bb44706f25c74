"""In-place append / capture resume (round-5 beyond-verdict capability).

SURVEY section 5's checkpoint/resume axis: a crashed capture leaves
either a finalized container (clean close) or — by the no-torn-container
contract — nothing; ``append=True`` resumes the finalized container IN
PLACE. Contracts:

- the appended file is byte-identical to
  ``surgery.concat_videos([first, second_standalone])`` — and to the
  ONE-SHOT capture when the first part ended on a segment boundary
  (MHTS always: records have no segmentation);
- CRCs chain (``zlib.crc32(new, old)`` IS the combined payload CRC) and
  FCRC/motion tables extend; a file recording no CRC stays unrecorded;
- temporal append continues the keyframe cadence and predicts the first
  appended residual from the last true frame (one random access);
- a FAILED append restores the original container untouched — the
  no-torn contract's append form.
"""

import io
import zlib

import numpy as np
import pytest

from metalhuffman.models import (CodecConfig, color, frame_stream,
                                     surgery, temporal)
from metalhuffman.models.stream_writer import (
    ColorStreamingEncoder,
    MHTSStreamingEncoder,
    StreamingEncoder,
    TemporalStreamingEncoder,
)

NATIVE = CodecConfig(backend="native")


def _frames(t, h, w, seed=0, pan=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([
        np.clip(100 + 60 * np.sin((xx + pan * i) / 13.0)
                * np.cos(yy / 11.0) + rng.normal(0, 2, (h, w)),
                0, 255).astype(np.uint8)
        for i in range(t)])


def test_mhv2_append_equals_concat_and_oneshot(tmp_path):
    f = _frames(11, 24, 32, seed=1)
    f1, f2 = f[:6], f[6:]  # 6 % cap(3) == 0: one-shot identity too
    p = tmp_path / "cap.mhv2"
    with StreamingEncoder(p, 24, 32, NATIVE, max_segment_frames=3,
                          frame_crcs=True) as enc:
        enc.push(f1)
    first = p.read_bytes()
    with StreamingEncoder(p, 24, 32, NATIVE, max_segment_frames=3,
                          append=True) as enc:
        enc.push(f2)
    got = p.read_bytes()
    q = tmp_path / "b.mhv2"
    with StreamingEncoder(q, 24, 32, NATIVE, max_segment_frames=3,
                          frame_crcs=True) as enc:
        enc.push(f2)
    assert got == surgery.concat_videos([first, q.read_bytes()])
    one = tmp_path / "one.mhv2"
    with StreamingEncoder(one, 24, 32, NATIVE, max_segment_frames=3,
                          frame_crcs=True) as enc:
        enc.push(f)
    assert got == one.read_bytes()  # boundary-aligned: one-shot identity
    # combined integrity metadata
    assert frame_stream.source_crc32(got) == zlib.crc32(f.tobytes())
    np.testing.assert_array_equal(
        frame_stream.read_frame_crcs(got),
        frame_stream.compute_frame_crcs(f))
    out, _h, _w = frame_stream.decode_range(got, 0, 11, NATIVE)
    np.testing.assert_array_equal(out, f)
    # stats count the WHOLE stream
    with StreamingEncoder(p, 24, 32, NATIVE, max_segment_frames=3,
                          append=True) as enc:
        enc.push(f1[:1])
    assert enc.stats.total_frames == 12


def test_append_failure_restores_original(tmp_path):
    f = _frames(5, 16, 16, seed=3)
    p = tmp_path / "cap.mhv2"
    with StreamingEncoder(p, 16, 16, NATIVE, max_segment_frames=2) as enc:
        enc.push(f)
    orig = p.read_bytes()

    class Boom(Exception):
        pass

    with pytest.raises(Boom):
        with StreamingEncoder(p, 16, 16, NATIVE, max_segment_frames=2,
                              append=True) as enc:
            enc.push(f[:3])  # a full segment lands on disk
            raise Boom()
    assert p.read_bytes() == orig  # bit-for-bit restoration
    # the restored file still appends cleanly afterwards
    with StreamingEncoder(p, 16, 16, NATIVE, max_segment_frames=2,
                          append=True) as enc:
        enc.push(f[:2])
    out, _h, _w = frame_stream.decode_range(p.read_bytes(), 0, 7, NATIVE)
    np.testing.assert_array_equal(out, np.concatenate([f, f[:2]]))


def test_append_validation(tmp_path):
    f = _frames(3, 16, 16, seed=5)
    p = tmp_path / "cap.mhv2"
    with StreamingEncoder(p, 16, 16, NATIVE) as enc:
        enc.push(f)
    with pytest.raises(ValueError, match="16x16"):
        StreamingEncoder(p, 24, 24, NATIVE, append=True)
    # unrecorded CRC stays unrecorded; cannot start FCRC mid-stream
    with pytest.raises(ValueError, match="mid-stream"):
        StreamingEncoder(p, 16, 16, NATIVE, append=True, frame_crcs=True)
    # appending to an MHTV (non-segmented) is refused with guidance
    mhtv = tmp_path / "x.mhtv"
    from metalhuffman import encode_video

    mhtv.write_bytes(encode_video(f, NATIVE))
    with pytest.raises(ValueError, match="resegment"):
        StreamingEncoder(mhtv, 16, 16, NATIVE, append=True)


def test_unrecorded_crc_append_stays_unrecorded(tmp_path):
    """Appending onto a CRC-less file must not invent a bogus CRC."""
    f = _frames(4, 16, 16, seed=7)
    import struct

    p = tmp_path / "cap.mhv2"
    with StreamingEncoder(p, 16, 16, NATIVE, max_segment_frames=2) as enc:
        enc.push(f[:2])
    data = bytearray(p.read_bytes())
    off = frame_stream._trailer_offset(bytes(data))
    struct.pack_into("<I", data, off, 0)  # blank the recorded CRC
    p.write_bytes(bytes(data))
    with StreamingEncoder(p, 16, 16, NATIVE, max_segment_frames=2,
                          append=True) as enc:
        enc.push(f[2:])
    assert frame_stream.source_crc32(p.read_bytes()) == 0
    out, _h, _w = frame_stream.decode_range(p.read_bytes(), 0, 4, NATIVE)
    np.testing.assert_array_equal(out, f)


def test_temporal_append_oneshot_identity_and_resume(tmp_path):
    cfg = CodecConfig(backend="native", temporal=True, motion=True,
                      keyint=4)
    f = _frames(12, 24, 32, seed=9, pan=5)
    f1, f2 = f[:6], f[6:]  # 6 % cap(3) == 0
    p = tmp_path / "cap.mhvt"
    with TemporalStreamingEncoder(p, 24, 32, cfg, max_segment_frames=3,
                                  frame_crcs=True) as enc:
        enc.push(f1)
    orig = p.read_bytes()
    with TemporalStreamingEncoder(p, 24, 32, cfg, max_segment_frames=3,
                                  append=True) as enc:
        enc.push(f2)
    got = p.read_bytes()
    one = tmp_path / "one.mhvt"
    with TemporalStreamingEncoder(one, 24, 32, cfg, max_segment_frames=3,
                                  frame_crcs=True) as enc:
        enc.push(f)
    # the whole point: residual cadence, motion table, FCRCs, and outer
    # CRC continue EXACTLY as if the capture never stopped
    assert got == one.read_bytes()
    np.testing.assert_array_equal(
        temporal.decode_temporal_video(got, NATIVE), f)
    # failed temporal append restores everything (outer header + inner
    # header/trailer + tables)
    class Boom(Exception):
        pass

    with pytest.raises(Boom):
        with TemporalStreamingEncoder(p, 24, 32, cfg,
                                      max_segment_frames=3,
                                      append=True) as enc:
            enc.push(f1)
            raise Boom()
    assert p.read_bytes() == got
    # cadence/misconfig validation
    bad = CodecConfig(backend="native", temporal=True, motion=False,
                      keyint=4)
    with pytest.raises(ValueError, match="motion"):
        TemporalStreamingEncoder(p, 24, 32, bad, append=True)
    bad2 = CodecConfig(backend="native", temporal=True, motion=True,
                       keyint=5)
    with pytest.raises(ValueError, match="keyint"):
        TemporalStreamingEncoder(p, 24, 32, bad2, append=True)
    # header-layout files are refused with guidance
    batch = tmp_path / "batch.mhvt"
    batch.write_bytes(temporal.encode_temporal_video(f1, cfg))
    with pytest.raises(ValueError, match="trailer"):
        TemporalStreamingEncoder(batch, 24, 32, cfg, append=True)


def test_temporal_append_short_first_group_cadence(tmp_path):
    """Appending to an arbitrary-start extract continues the SHORT first
    group's keyframe cadence (fl, fl+keyint, ...)."""
    cfg = CodecConfig(backend="native", temporal=True, keyint=4)
    f = _frames(10, 16, 16, seed=11)
    blob = temporal.encode_temporal_video(f, cfg)
    ext = surgery.extract_video(blob, 2, 10)  # mid-group: first_len = 2
    # convert to the trailer layout losslessly (re-wrap the same parts)
    inner, keyint, crc, mvs, fcrcs, fl = temporal.unwrap(ext)
    assert fl == 2
    # the trailer re-wrap needs a SEGMENTED inner for the inner append
    inner = surgery.resegment_video(inner, 3)
    p = tmp_path / "ext.mhvt"
    p.write_bytes(temporal.wrap(inner, keyint, crc, mvs=mvs,
                                frame_crcs=fcrcs, first_len=fl,
                                trailer=True))
    extra = _frames(5, 16, 16, seed=12)
    with TemporalStreamingEncoder(p, 16, 16, cfg, max_segment_frames=3,
                                  append=True) as enc:
        enc.push(extra)
    out = temporal.decode_temporal_video(p.read_bytes(), NATIVE)
    np.testing.assert_array_equal(out,
                                  np.concatenate([f[2:], extra]))


def test_mhts_append_always_oneshot_identical(tmp_path):
    f = _frames(7, 16, 24, seed=13)
    p = tmp_path / "cap.mhts"
    with MHTSStreamingEncoder(p, 16, 24, NATIVE) as enc:
        enc.push(f[:3])
    with MHTSStreamingEncoder(p, 16, 24, NATIVE, append=True) as enc:
        enc.push(f[3:])
    one = tmp_path / "one.mhts"
    with MHTSStreamingEncoder(one, 16, 24, NATIVE) as enc:
        enc.push(f)
    assert p.read_bytes() == one.read_bytes()
    # mixed precoder append: records are self-contained
    with MHTSStreamingEncoder(p, 16, 24,
                              CodecConfig(backend="native",
                                          delta2d=True),
                              append=True) as enc:
        enc.push(f[:2])
    outs = [fr for _i, fr, _e, _c in
            frame_stream.iter_stream_frames(p.read_bytes(), NATIVE)]
    np.testing.assert_array_equal(np.stack(outs),
                                  np.concatenate([f, f[:2]]))
    # failure restores
    class Boom(Exception):
        pass

    before = p.read_bytes()
    with pytest.raises(Boom):
        with MHTSStreamingEncoder(p, 16, 24, NATIVE, append=True) as enc:
            enc.push(f[:1])
            raise Boom()
    assert p.read_bytes() == before


def test_color_append_equals_concat(tmp_path):
    rng = np.random.default_rng(15)
    col = rng.integers(0, 200, (9, 24, 24, 3)).astype(np.uint8)
    p = tmp_path / "cap.mhtc"
    with ColorStreamingEncoder(p, 24, 24, channels=3, config=NATIVE,
                               max_segment_frames=2,
                               frame_crcs=True) as enc:
        enc.push(col[:5])
    first = p.read_bytes()
    with ColorStreamingEncoder(p, 24, 24, channels=3, config=NATIVE,
                               max_segment_frames=2, append=True) as enc:
        enc.push(col[5:])
    assert enc.stats.total_frames == 9
    q = tmp_path / "b.mhtc"
    with ColorStreamingEncoder(q, 24, 24, channels=3, config=NATIVE,
                               max_segment_frames=2,
                               frame_crcs=True) as enc:
        enc.push(col[5:])
    assert p.read_bytes() == surgery.concat_videos([first,
                                                    q.read_bytes()])
    np.testing.assert_array_equal(
        color.decode_color_video_from_bytes(p.read_bytes(), NATIVE), col)
    # colorspace mismatch refused
    with pytest.raises(ValueError, match="disagree"):
        ColorStreamingEncoder(p, 24, 24, channels=3, config=NATIVE,
                              colorspace=color.CS_SUBGREEN, append=True)


def test_cli_append_resume(tmp_path):
    from metalhuffman import cli

    f = _frames(10, 32, 32, seed=17, pan=4)
    np.save(tmp_path / "a1.npy", f[:6])
    np.save(tmp_path / "a2.npy", f[6:])
    np.save(tmp_path / "all.npy", f)
    out = tmp_path / "cap.mhvt"
    base_args = ["--streaming", "--temporal", "--motion", "--keyint", "3",
                 "--frame-crcs", "--segment-frames", "3",
                 "--backend", "native"]
    assert cli.main(["encode-video", str(tmp_path / "a1.npy"), str(out),
                     *base_args]) == 0
    assert cli.main(["encode-video", str(tmp_path / "a2.npy"), str(out),
                     "--append", "--streaming", "--temporal", "--motion",
                     "--keyint", "3", "--segment-frames", "3",
                     "--backend", "native"]) == 0
    one = tmp_path / "one.mhvt"
    assert cli.main(["encode-video", str(tmp_path / "all.npy"), str(one),
                     *base_args]) == 0
    assert out.read_bytes() == one.read_bytes()
    assert cli.main(["verify", str(out), "--streaming",
                     "--backend", "native"]) == 0
    # refusals: no --streaming / missing file
    with pytest.raises(SystemExit, match="streaming"):
        cli.main(["encode-video", str(tmp_path / "a2.npy"), str(out),
                  "--append"])
    with pytest.raises(SystemExit, match="does not exist"):
        cli.main(["encode-video", str(tmp_path / "a2.npy"),
                  str(tmp_path / "nope.mhv2"), "--streaming", "--append"])


def test_temporal_append_ctor_failure_restores(tmp_path):
    """Round-5 review finding: _open_for_append truncates the outer
    tables BEFORE the inner writer's constructor runs; a failure there
    (e.g. a coding-mode mismatch the inner walk detects) must restore
    the original file, not leave it torn."""
    cfg = CodecConfig(backend="native", temporal=True, keyint=3)
    f = _frames(6, 16, 16, seed=21)
    p = tmp_path / "cap.mhvt"
    with TemporalStreamingEncoder(p, 16, 16, cfg,
                                  max_segment_frames=3) as enc:
        enc.push(f)
    orig = p.read_bytes()
    bad = CodecConfig(backend="native", temporal=True, keyint=3,
                      delta=False)  # inner mode mismatch -> inner raises
    with pytest.raises(ValueError, match="coding mode|delta"):
        TemporalStreamingEncoder(p, 16, 16, bad, append=True)
    assert p.read_bytes() == orig  # bit-for-bit, tables intact
    np.testing.assert_array_equal(
        temporal.decode_temporal_video(p.read_bytes(), NATIVE), f)


def test_mhv2_append_mode_mismatch_fails_fast(tmp_path):
    f = _frames(3, 16, 16, seed=23)
    p = tmp_path / "cap.mhv2"
    with StreamingEncoder(p, 16, 16, NATIVE) as enc:
        enc.push(f)
    orig = p.read_bytes()
    with pytest.raises(ValueError, match="coding mode"):
        StreamingEncoder(p, 16, 16,
                         CodecConfig(backend="native", delta2d=True),
                         append=True)
    assert p.read_bytes() == orig


def test_mhts_append_truncated_payload_never_zero_extends(tmp_path):
    """Round-5 review finding: a truncated last record must be a clean
    error — never a truncate() past EOF that bakes zero bytes in."""
    f = _frames(3, 16, 16, seed=25)
    p = tmp_path / "cap.mhts"
    with MHTSStreamingEncoder(p, 16, 16, NATIVE) as enc:
        enc.push(f)
    data = p.read_bytes()
    cut = p.with_name("cut.mhts")
    cut.write_bytes(data[: len(data) - 10])  # last record loses 10 bytes
    size_before = cut.stat().st_size
    with pytest.raises(ValueError, match="truncated"):
        MHTSStreamingEncoder(cut, 16, 16, NATIVE, append=True)
    assert cut.stat().st_size == size_before  # untouched, not extended


def test_mhts_append_delta_ness_must_match(tmp_path):
    """Appending no-delta records onto a delta MHTS would produce a file
    every batch reader rejects — refuse it at open time instead."""
    f = _frames(3, 16, 16, seed=27)
    p = tmp_path / "cap.mhts"
    with MHTSStreamingEncoder(p, 16, 16, NATIVE) as enc:
        enc.push(f)
    with pytest.raises(ValueError, match="delta-ness"):
        MHTSStreamingEncoder(p, 16, 16,
                             CodecConfig(backend="native", delta=False),
                             append=True)
    # delta2d onto delta IS fine — and the result must stay readable by
    # the BATCH surfaces too (read_stream booleanizes the mode)
    with MHTSStreamingEncoder(p, 16, 16,
                              CodecConfig(backend="native",
                                          delta2d=True),
                              append=True) as enc:
        enc.push(f[:1])
    out, _h, _w = frame_stream.decode_range(p.read_bytes(), 0, 4, NATIVE)
    np.testing.assert_array_equal(out.reshape(4, 16, 16),
                                  np.concatenate([f, f[:1]]))


def test_cli_append_mismatch_is_clean_error(tmp_path):
    from metalhuffman import cli

    f = _frames(4, 16, 16, seed=29)
    np.save(tmp_path / "f.npy", f)
    out = tmp_path / "cap.mhvt"
    assert cli.main(["encode-video", str(tmp_path / "f.npy"), str(out),
                     "--streaming", "--temporal", "--keyint", "4",
                     "--backend", "native"]) == 0
    with pytest.raises(SystemExit, match="keyint"):
        cli.main(["encode-video", str(tmp_path / "f.npy"), str(out),
                  "--streaming", "--temporal", "--keyint", "5",
                  "--append", "--backend", "native"])


def test_append_bitflip_fuzz_never_crashes_or_tears(tmp_path):
    """Single-bit flips anywhere in an existing MHV2: opening it for
    append either raises a clean ValueError with the file UNTOUCHED, or
    the walk still lands consistently and the append completes without a
    crash. Never struct.error/IndexError, never a torn original."""
    f = _frames(5, 16, 16, seed=31)
    p = tmp_path / "cap.mhv2"
    with StreamingEncoder(p, 16, 16, NATIVE, max_segment_frames=2,
                          frame_crcs=True) as enc:
        enc.push(f)
    good = p.read_bytes()
    rng = np.random.default_rng(33)
    for _ in range(60):
        data = bytearray(good)
        pos = int(rng.integers(0, len(data)))
        data[pos] ^= 1 << int(rng.integers(0, 8))
        q = tmp_path / "mut.mhv2"
        q.write_bytes(bytes(data))
        before = q.read_bytes()
        try:
            with StreamingEncoder(q, 16, 16, NATIVE,
                                  max_segment_frames=2,
                                  append=True) as enc:
                enc.push(f[:1])
        except ValueError:
            assert q.read_bytes() == before, f"torn at byte {pos}"
        except Exception as e:  # noqa: BLE001
            raise AssertionError(
                f"uncontrolled {type(e).__name__} at byte {pos}: {e}")


def test_temporal_color_and_u16_append(tmp_path):
    """Round-5 completion: temporal append covers color and u16 inners
    too (the grayscale-only scope note is gone) — one-shot identity at
    segment boundaries, kind mismatches refused, failure restores."""
    rng = np.random.default_rng(35)
    cfg = CodecConfig(backend="native", temporal=True, keyint=3)
    col = (rng.integers(0, 40, (12, 24, 24, 3))
           + np.arange(12)[:, None, None, None] * 2).astype(np.uint8)
    p = tmp_path / "cap.mhvt"
    kw = dict(channels=3, colorspace=color.CS_SUBGREEN,
              max_segment_frames=3)
    with TemporalStreamingEncoder(p, 24, 24, cfg, frame_crcs=True,
                                  **kw) as enc:
        enc.push(col[:6])
    with TemporalStreamingEncoder(p, 24, 24, cfg, append=True,
                                  **kw) as enc:
        enc.push(col[6:])
    one = tmp_path / "one.mhvt"
    with TemporalStreamingEncoder(one, 24, 24, cfg, frame_crcs=True,
                                  **kw) as enc:
        enc.push(col)
    assert p.read_bytes() == one.read_bytes()
    np.testing.assert_array_equal(
        temporal.decode_temporal_video(p.read_bytes(), NATIVE), col)

    u16 = rng.integers(0, 3000, (10, 24, 24)).astype(np.uint16)
    cfgm = CodecConfig(backend="native", temporal=True, motion=True,
                      keyint=4)
    q = tmp_path / "cap16.mhvt"
    with TemporalStreamingEncoder(q, 24, 24, cfgm, u16=True,
                                  max_segment_frames=2,
                                  frame_crcs=True) as enc:
        enc.push(u16[:6])
    before = q.read_bytes()
    with TemporalStreamingEncoder(q, 24, 24, cfgm, u16=True,
                                  max_segment_frames=2,
                                  append=True) as enc:
        enc.push(u16[6:])
    one2 = tmp_path / "one16.mhvt"
    with TemporalStreamingEncoder(one2, 24, 24, cfgm, u16=True,
                                  max_segment_frames=2,
                                  frame_crcs=True) as enc:
        enc.push(u16)
    assert q.read_bytes() == one2.read_bytes()
    got = temporal.decode_temporal_video(q.read_bytes(), NATIVE)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, u16)
    # kind mismatches refused both ways; failure restores
    with pytest.raises(ValueError, match="MHTC"):
        TemporalStreamingEncoder(q, 24, 24, cfgm, append=True)
    gray_p = tmp_path / "gray.mhvt"
    with TemporalStreamingEncoder(gray_p, 24, 24,
                                  CodecConfig(backend="native",
                                              temporal=True,
                                              keyint=3)) as enc:
        enc.push(_frames(4, 24, 24, seed=37))
    with pytest.raises(ValueError, match="grayscale"):
        TemporalStreamingEncoder(gray_p, 24, 24, cfg, channels=3,
                                 append=True)

    class Boom(Exception):
        pass

    after = q.read_bytes()
    with pytest.raises(Boom):
        with TemporalStreamingEncoder(q, 24, 24, cfgm, u16=True,
                                      max_segment_frames=2,
                                      append=True) as enc:
            enc.push(u16[:3])
            raise Boom()
    assert q.read_bytes() == after


def test_cli_color_temporal_append(tmp_path):
    from metalhuffman import cli

    rng = np.random.default_rng(39)
    col = (rng.integers(0, 60, (8, 16, 16, 3))).astype(np.uint8)
    np.save(tmp_path / "c1.npy", col[:4])
    np.save(tmp_path / "c2.npy", col[4:])
    np.save(tmp_path / "all.npy", col)
    out = tmp_path / "cap.mhvt"
    args = ["--streaming", "--temporal", "--color", "--keyint", "2",
            "--segment-frames", "2", "--backend", "native"]
    assert cli.main(["encode-video", str(tmp_path / "c1.npy"), str(out),
                     *args]) == 0
    assert cli.main(["encode-video", str(tmp_path / "c2.npy"), str(out),
                     "--append", *args]) == 0
    one = tmp_path / "one.mhvt"
    assert cli.main(["encode-video", str(tmp_path / "all.npy"), str(one),
                     *args]) == 0
    assert out.read_bytes() == one.read_bytes()
    dec = tmp_path / "d.npy"
    assert cli.main(["decode-video", str(out), str(dec), "--streaming",
                     "--backend", "native"]) == 0
    np.testing.assert_array_equal(np.load(dec), col)


def test_temporal_color_append_header_mismatch_fails_early(tmp_path):
    rng = np.random.default_rng(41)
    col = rng.integers(0, 60, (4, 16, 16, 3)).astype(np.uint8)
    cfg = CodecConfig(backend="native", temporal=True, keyint=2)
    p = tmp_path / "cap.mhvt"
    with TemporalStreamingEncoder(p, 16, 16, cfg, channels=3,
                                  max_segment_frames=2) as enc:
        enc.push(col)
    orig = p.read_bytes()
    # wrong channel count / colorspace: clean early refusal, untouched
    for kw in (dict(channels=4),
               dict(channels=3, colorspace=color.CS_SUBGREEN)):
        with pytest.raises(ValueError, match="disagree"):
            TemporalStreamingEncoder(p, 16, 16, cfg, append=True, **kw)
        assert p.read_bytes() == orig


def test_temporal_append_abort_poisons_color_inner(tmp_path):
    """Round-5 review: abort() on a color/u16 temporal append must refuse
    later pushes for EVERY inner kind (a caller-owned handle stays open,
    so the guard must not rely on the file being closed) — a push after
    abort previously wrote over the restored trailer."""
    cfg = CodecConfig(backend="native", temporal=True, keyint=2)
    rng = np.random.default_rng(43)
    col = rng.integers(0, 60, (4, 16, 16, 3)).astype(np.uint8)
    buf = io.BytesIO()
    with TemporalStreamingEncoder(buf, 16, 16, cfg, channels=3,
                                  max_segment_frames=1) as enc:
        enc.push(col)
    good = buf.getvalue()
    buf.seek(0)
    enc = TemporalStreamingEncoder(buf, 16, 16, cfg, channels=3,
                                   max_segment_frames=1, append=True)
    enc.abort()
    with pytest.raises(ValueError, match="close"):
        enc.push(col[:1])
    assert buf.getvalue() == good


def test_temporal_append_one_channel_mhtc(tmp_path):
    """channels=1 MHTC temporal streams append like any other (the
    gray-vs-MHTC detection keys on the REQUESTED kind, not ppf==1)."""
    cfg = CodecConfig(backend="native", temporal=True, keyint=2)
    rng = np.random.default_rng(45)
    g1 = rng.integers(0, 60, (4, 16, 16, 1)).astype(np.uint8)
    p = tmp_path / "one_ch.mhvt"
    with TemporalStreamingEncoder(p, 16, 16, cfg, channels=1,
                                  max_segment_frames=2) as enc:
        enc.push(g1[:2])
    with TemporalStreamingEncoder(p, 16, 16, cfg, channels=1,
                                  max_segment_frames=2,
                                  append=True) as enc:
        enc.push(g1[2:])
    np.testing.assert_array_equal(
        temporal.decode_temporal_video(p.read_bytes(), NATIVE), g1)


def test_temporal_append_corrupt_tables_fail_before_decode(tmp_path):
    """Corrupt first_len / FCRC-count fields are clean refusals with the
    file untouched — validated BEFORE the predictor decode."""
    import struct

    cfg = CodecConfig(backend="native", temporal=True, keyint=4)
    f = _frames(6, 16, 16, seed=47)
    p = tmp_path / "cap.mhvt"
    with TemporalStreamingEncoder(p, 16, 16, cfg, max_segment_frames=3,
                                  frame_crcs=True) as enc:
        enc.push(f)
    good = p.read_bytes()
    # corrupt FCRC count (the u32 after the FCRC-table position): the
    # trailer layout puts tables after the inner — count sits at
    # inner_end (no motion table here) per FORMAT.md
    data = bytearray(good)
    keyint, flags, _ = struct.unpack_from("<HHI", data, 4)
    (inner_len,) = struct.unpack_from("<Q", data, 12)
    fc_at = 20 + inner_len
    (n,) = struct.unpack_from("<I", data, fc_at)
    assert n == 6
    struct.pack_into("<I", data, fc_at, 5)  # shrink the count: 5 != t,
    # and the table parse still succeeds (fewer bytes consumed)
    q = tmp_path / "bad_fc.mhvt"
    q.write_bytes(bytes(data))
    before = q.read_bytes()
    with pytest.raises(ValueError, match="frame CRC table|trailer|corrupt"):
        TemporalStreamingEncoder(q, 16, 16, cfg, append=True)
    assert q.read_bytes() == before

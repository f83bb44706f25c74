"""Lossless container surgery: extract / concat without re-encoding."""

import numpy as np
import pytest

import metalhuffman as mh
from metalhuffman.models import CodecConfig, frame_stream, surgery, temporal
from metalhuffman.models import color as color_mod

CPU = CodecConfig(backend="native")


def _frames(t=9, h=24, w=40, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w), np.uint8)
    return np.stack([np.roll(base, (2 * i, 3 * i), (0, 1)) for i in range(t)])


@pytest.mark.parametrize("frame_crcs", [False, True])
def test_extract_mhtv(frame_crcs):
    frames = _frames()
    cfg = CodecConfig(backend="native", frame_crcs=frame_crcs)
    blob = mh.encode_video(frames, cfg)
    for a, b in [(0, 9), (2, 7), (8, 9)]:
        out = surgery.extract_video(blob, a, b)
        got = mh.decode_video(out, CPU)
        np.testing.assert_array_equal(got, frames[a:b])
        if frame_crcs:
            # the combined whole-payload CRC must verify (it did: decode
            # checks it) and the sliced table must be present
            assert frame_stream.read_frame_crcs(out) is not None
            assert frame_stream.source_crc32(out) != 0
    with pytest.raises(ValueError):
        surgery.extract_video(blob, 5, 12)


def test_extract_mhv2_straddle_and_delta2d():
    frames = _frames(t=8)
    cfg = CodecConfig(backend="native", delta2d=True, frame_crcs=True)
    segs = frame_stream.encode_frames_segmented(frames, cfg,
                                                max_segment_bits=16_000)
    assert len(segs) > 1
    import zlib

    blob = frame_stream.write_segmented(
        segs, 24, 40, cfg,
        source_crc32=zlib.crc32(np.ascontiguousarray(frames).tobytes()),
        frame_crcs=np.array([zlib.crc32(f.tobytes()) for f in frames],
                            np.uint32))
    out = surgery.extract_video(blob, 1, 7)  # straddles segments
    got = mh.decode_video(out, CPU)
    np.testing.assert_array_equal(got, frames[1:7])


def test_extract_color_u16_temporal():
    rng = np.random.default_rng(1)
    # color
    cframes = np.stack([np.roll(rng.integers(0, 256, (16, 24, 3), np.uint8),
                                i, 0) for i in range(6)])
    cblob = color_mod.encode_color_video_to_bytes(
        cframes, CodecConfig(backend="native", frame_crcs=True),
        colorspace=color_mod.CS_SUBGREEN)
    out = surgery.extract_video(cblob, 2, 5)
    np.testing.assert_array_equal(
        color_mod.decode_color_video_from_bytes(out, CPU), cframes[2:5])
    # u16
    g16 = rng.integers(0, 1 << 16, (5, 16, 24)).astype(np.uint16)
    gblob = color_mod.encode_gray16_to_bytes(
        g16, CodecConfig(backend="native"))
    out16 = surgery.extract_video(gblob, 1, 4)
    np.testing.assert_array_equal(
        color_mod.decode_gray16_from_bytes(out16, CPU), g16[1:4])
    # temporal: keyframe-aligned start splices losslessly; a mid-group
    # start re-keys only the first group (test_extract_temporal_* below)
    frames = _frames(t=10)
    tblob = mh.encode_video(frames, CodecConfig(
        backend="native", temporal=True, motion=True, keyint=4,
        frame_crcs=True))
    out_t = surgery.extract_video(tblob, 4, 9)
    np.testing.assert_array_equal(mh.decode_video(out_t, CPU), frames[4:9])


def test_concat_roundtrip_and_crcs():
    a = _frames(t=4, seed=1)
    b = _frames(t=5, seed=2)
    c = _frames(t=3, seed=3)
    cfg = CodecConfig(backend="native", frame_crcs=True)
    spliced = surgery.concat_videos([mh.encode_video(x, cfg)
                                     for x in (a, b, c)])
    want = np.concatenate([a, b, c])
    got = mh.decode_video(spliced, CPU)  # verifies the COMBINED crc
    np.testing.assert_array_equal(got, want)
    assert frame_stream.source_crc32(spliced) != 0
    fc = frame_stream.read_frame_crcs(spliced)
    assert fc is not None and fc.shape == (12,)
    # range access on the splice (verifies sliced FCRC entries)
    got2, _h, _w = frame_stream.decode_range(spliced, 3, 10, CPU)
    np.testing.assert_array_equal(got2, want[3:10])
    # geometry mismatch refuses
    with pytest.raises(ValueError, match="mismatch"):
        surgery.concat_videos([mh.encode_video(a, cfg),
                               mh.encode_video(_frames(h=16), cfg)])


def test_concat_temporal():
    a = _frames(t=8, seed=4)   # whole keyframe groups (keyint 4)
    b = _frames(t=6, seed=5)
    cfg = CodecConfig(backend="native", temporal=True, keyint=4,
                      frame_crcs=True)
    spliced = surgery.concat_videos([mh.encode_video(a, cfg),
                                     mh.encode_video(b, cfg)])
    np.testing.assert_array_equal(
        mh.decode_video(spliced, CPU), np.concatenate([a, b]))
    # misaligned first input refuses
    bad = mh.encode_video(_frames(t=7, seed=6), cfg)
    with pytest.raises(ValueError, match="keyframe groups"):
        surgery.concat_videos([bad, mh.encode_video(b, cfg)])


def test_extract_equals_reencode_payload():
    # the extracted container's decoded output must equal a re-encode's —
    # but WITHOUT having touched the symbols (trim+rebase only)
    frames = _frames(t=6)
    blob = mh.encode_video(frames, CPU)
    out = surgery.extract_video(blob, 2, 5)
    assert out[:4] == frame_stream.SHARED_MAGIC
    stream, t, h, w, bd, delta = frame_stream.read_shared(out)
    assert t == 3 and (h, w) == (24, 40)
    # offsets were rebased to start within the first byte
    assert int(stream.block_offsets[0]) < 8
    np.testing.assert_array_equal(mh.decode_video(out, CPU), frames[2:5])


def test_cli_extract_concat(tmp_path):
    from metalhuffman.cli import main

    frames = _frames(t=6)
    src = tmp_path / "v.npy"
    np.save(src, frames)
    full = tmp_path / "v.mhtv"
    main(["encode-video", str(src), str(full), "--frame-crcs",
          "--backend", "native"])
    part = tmp_path / "part.mhtv"
    main(["extract", str(full), str(part), "--frames", "1", "4"])
    got = tmp_path / "got.npy"
    main(["decode-video", str(part), str(got), "--backend", "native"])
    np.testing.assert_array_equal(np.load(got), frames[1:4])
    joined = tmp_path / "joined.mhv2"
    main(["concat", str(joined), str(part), str(full)])
    main(["decode-video", str(joined), str(got), "--backend", "native"])
    np.testing.assert_array_equal(
        np.load(got), np.concatenate([frames[1:4], frames]))
    # verify passes on surgical outputs (all integrity metadata intact)
    main(["verify", str(joined), "--backend", "native"])


def test_extract_zero_init_and_no_delta():
    frames = _frames(t=6)
    # zero-init (mode 2): block_init root bytes must slice with the blocks
    zi = mh.encode_video(frames, CodecConfig(backend="native",
                                             zero_init=True))
    out = surgery.extract_video(zi, 1, 5)
    np.testing.assert_array_equal(mh.decode_video(out, CPU), frames[1:5])
    stream, _t, _h, _w, _bd, _d = frame_stream.read_shared(out)
    assert stream.block_init is not None
    # no-delta (mode 0)
    nd = mh.encode_video(frames, CodecConfig(backend="native", delta=False))
    out2 = surgery.extract_video(nd, 2, 6)
    np.testing.assert_array_equal(mh.decode_video(out2, CPU), frames[2:6])
    # extracted containers decode through the device path too
    np.testing.assert_array_equal(
        mh.decode_video(out, CodecConfig()), frames[1:5])


def test_concat_zero_init_and_mixed_mode_refused():
    frames_a = _frames(t=3, seed=7)
    frames_b = _frames(t=4, seed=8)
    zi = CodecConfig(backend="native", zero_init=True)
    spliced = surgery.concat_videos([mh.encode_video(frames_a, zi),
                                     mh.encode_video(frames_b, zi)])
    np.testing.assert_array_equal(
        mh.decode_video(spliced, CPU), np.concatenate([frames_a, frames_b]))
    # mixing precoder modes must refuse (write_segmented's mode gate)
    plain = mh.encode_video(frames_b, CPU)
    with pytest.raises(ValueError):
        surgery.concat_videos([mh.encode_video(frames_a, zi), plain])


# -- arbitrary-start MHVT extraction (re-keyed first group) -------------------


def _tblob(frames, keyint=4, motion=False, **kw):
    cfg = CodecConfig(backend="native", temporal=True, keyint=keyint,
                      motion=motion, **kw)
    return mh.encode_video(frames, cfg)


@pytest.mark.parametrize("motion", [False, True])
def test_extract_temporal_any_start(motion):
    frames = _frames(t=11)
    blob = _tblob(frames, keyint=4, motion=motion, frame_crcs=True)
    for a, b in [(3, 9), (1, 11), (5, 7), (6, 11), (2, 4), (4, 10), (0, 11)]:
        out = surgery.extract_video(blob, a, b)
        np.testing.assert_array_equal(mh.decode_video(out, CPU),
                                      frames[a:b]), (a, b)
        # random access must honor the recorded short first group
        for n in (0, (b - a) // 2, b - a - 1):
            np.testing.assert_array_equal(
                temporal.decode_temporal_frame(out, n, CPU), frames[a + n])
        # the phased container decodes through the DEVICE folds too
        np.testing.assert_array_equal(
            temporal.decode_temporal_video(out, CodecConfig()), frames[a:b])


def test_extract_temporal_only_first_group_reencodes():
    # later groups must be BYTE-IDENTICAL to an aligned lossless extract —
    # the proof that a mid-group start re-encodes only its first group
    frames = _frames(t=11)
    blob = _tblob(frames, keyint=4, frame_crcs=True)
    mis = surgery.extract_video(blob, 3, 11)   # re-keys [3, 4), splices [4, 11)
    ali = surgery.extract_video(blob, 4, 11)   # pure trim
    mi_segs, *_ = frame_stream.read_segmented(temporal.unwrap(mis)[0])
    al_inner = temporal.unwrap(ali)[0]
    if al_inner[:4] == frame_stream.SHARED_MAGIC:
        s, t, *_ = frame_stream.read_shared(al_inner)
        al_segs = [(s, t)]
    else:
        al_segs, *_ = frame_stream.read_segmented(al_inner)
    assert len(mi_segs) == 1 + len(al_segs)
    for (s1, t1), (s2, t2) in zip(mi_segs[1:], al_segs):
        assert t1 == t2
        np.testing.assert_array_equal(s1.code_bytes, s2.code_bytes)
        np.testing.assert_array_equal(s1.block_offsets, s2.block_offsets)
    # and the wrapper records the short first group
    assert temporal.unwrap(mis)[5] == 1
    assert "short first group (1)" in temporal.describe(mis)


def test_extract_temporal_region_and_range_on_phased():
    frames = _frames(t=11)
    out = surgery.extract_video(_tblob(frames, frame_crcs=True), 3, 11)
    reg = temporal.decode_temporal_video_region(out, 2, 6, 4, 8, 12, 16, CPU)
    np.testing.assert_array_equal(reg, frames[5:9, 4:16, 8:24])
    np.testing.assert_array_equal(
        temporal.decode_temporal_range(out, 3, 8, CPU), frames[6:11])


def test_extract_temporal_of_extract():
    # a phased container extracts again, from any start
    frames = _frames(t=11)
    out1 = surgery.extract_video(_tblob(frames, frame_crcs=True), 3, 11)
    out2 = surgery.extract_video(out1, 2, 7)  # frames 5..10 of the original
    np.testing.assert_array_equal(mh.decode_video(out2, CPU), frames[5:10])


def test_extract_temporal_color_u16_any_start():
    rng = np.random.default_rng(9)
    cframes = np.stack([np.roll(rng.integers(0, 256, (16, 24, 3), np.uint8),
                                i, 0) for i in range(7)])
    cblob = temporal.encode_temporal_color_video(
        cframes, CodecConfig(backend="native", temporal=True, keyint=3,
                             frame_crcs=True))
    out = surgery.extract_video(cblob, 2, 7)
    np.testing.assert_array_equal(
        temporal.decode_temporal_video(out, CPU), cframes[2:7])
    g16 = rng.integers(0, 1 << 16, (7, 16, 24)).astype(np.uint16)
    gblob = temporal.encode_temporal_gray16_video(
        g16, CodecConfig(backend="native", temporal=True, keyint=3))
    out16 = surgery.extract_video(gblob, 4, 7)
    np.testing.assert_array_equal(
        temporal.decode_temporal_video(out16, CPU), g16[4:7])


def test_concat_temporal_phased():
    frames = _frames(t=11)
    blob = _tblob(frames, keyint=4, frame_crcs=True)
    # phased first input ending on a group boundary splices
    out_a = surgery.extract_video(blob, 3, 8)   # 1 + 4 frames
    out_b = surgery.extract_video(blob, 8, 11)
    spliced = surgery.concat_videos([out_a, out_b])
    np.testing.assert_array_equal(mh.decode_video(spliced, CPU),
                                  frames[3:11])
    assert temporal.unwrap(spliced)[5] == 1  # phase survives the splice
    # phased NON-first input refused
    with pytest.raises(ValueError, match="short first keyframe group"):
        surgery.concat_videos([out_b, out_a])
    # phased first input ending mid-group refused
    out_c = surgery.extract_video(blob, 3, 9)   # 1 + 4 + 1 frames
    with pytest.raises(ValueError, match="keyframe groups"):
        surgery.concat_videos([out_c, out_b])


def test_concat_mhtv_with_mhv2():
    # single- and multi-segment plain videos are one payload family
    frames_a = _frames(t=3, seed=11)
    frames_b = _frames(t=5, seed=12)
    cfg = CodecConfig(backend="native", frame_crcs=True)
    import zlib

    segs = frame_stream.encode_frames_segmented(frames_b, cfg,
                                                max_segment_bits=16_000)
    assert len(segs) > 1
    v2 = frame_stream.write_segmented(
        segs, 24, 40, cfg,
        source_crc32=zlib.crc32(np.ascontiguousarray(frames_b).tobytes()),
        frame_crcs=np.array([zlib.crc32(f.tobytes()) for f in frames_b],
                            np.uint32))
    spliced = surgery.concat_videos([mh.encode_video(frames_a, cfg), v2])
    np.testing.assert_array_equal(
        mh.decode_video(spliced, CPU), np.concatenate([frames_a, frames_b]))


def test_cli_extract_midgroup_and_crc_note(tmp_path, capsys):
    from metalhuffman.cli import main

    frames = _frames(t=10)
    src = tmp_path / "v.npy"
    np.save(src, frames)
    full = tmp_path / "v.mhvt"
    main(["encode-video", str(src), str(full), "--temporal", "--keyint", "4",
          "--frame-crcs", "--backend", "native"])
    part = tmp_path / "part.mhvt"
    main(["extract", str(full), str(part), "--frames", "3", "9"])
    cap = capsys.readouterr()
    assert "re-keyed first group" in cap.out
    assert "note:" not in cap.err  # FCRC table present -> CRC recorded
    got = tmp_path / "got.npy"
    main(["decode-video", str(part), str(got), "--backend", "native"])
    np.testing.assert_array_equal(np.load(got), frames[3:9])
    main(["verify", str(part), "--backend", "native"])
    # without frame CRCs the extract output is unverifiable -> stderr note
    full2 = tmp_path / "v2.mhvt"
    main(["encode-video", str(src), str(full2), "--temporal", "--keyint",
          "4", "--backend", "native"])
    main(["extract", str(full2), str(tmp_path / "p2.mhvt"),
          "--frames", "4", "9"])
    cap = capsys.readouterr()
    assert "note:" in cap.err and "records no whole-payload CRC" in cap.err


# -- resegment (round 4) ------------------------------------------------------


def test_resegment_mhtv_roundtrip_and_metadata():
    frames = _frames(7)
    cfg = CodecConfig(backend="native", frame_crcs=True)
    blob = mh.encode_video(frames, cfg)
    out = surgery.resegment_video(blob, 3)
    segs, t, h, w, bd, delta = frame_stream.read_segmented(out)
    assert [ft for _, ft in segs] == [3, 3, 1]
    np.testing.assert_array_equal(
        mh.decode_video(out, CodecConfig(backend="native")), frames)
    # CRC + FCRC carry over verbatim (payload unchanged)
    assert frame_stream.source_crc32(out) == frame_stream.source_crc32(blob)
    np.testing.assert_array_equal(frame_stream.read_frame_crcs(out),
                                  frame_stream.read_frame_crcs(blob))


def test_resegment_splits_but_never_merges():
    frames = _frames(8)
    cfg = CodecConfig(backend="native")
    blob = mh.encode_video(frames, cfg)
    three = surgery.resegment_video(blob, 3)  # [3, 3, 2]
    again = surgery.resegment_video(three, 5)  # each splits independently
    segs, *_ = frame_stream.read_segmented(again)
    assert [ft for _, ft in segs] == [3, 3, 2]  # unchanged: split-only
    segs2, *_ = frame_stream.read_segmented(
        surgery.resegment_video(three, 2))
    assert [ft for _, ft in segs2] == [2, 1, 2, 1, 2]
    np.testing.assert_array_equal(
        mh.decode_video(again, CodecConfig(backend="native")), frames)


def test_resegment_color_u16_temporal():
    rng = np.random.default_rng(7)
    cframes = np.clip(rng.normal(128, 25, (5, 16, 24, 3)), 0,
                      255).astype(np.uint8)
    cblob = color_mod.encode_color_video_to_bytes(
        cframes, CodecConfig(backend="native"),
        colorspace=color_mod.CS_SUBGREEN)
    cout = surgery.resegment_video(cblob, 2)  # 2 frames = 6 planes/segment
    inner, ch, layout, kind, cs = color_mod.unwrap(cout)
    segs, *_ = frame_stream.read_segmented(inner)
    assert [ft for _, ft in segs] == [6, 6, 3]
    np.testing.assert_array_equal(
        color_mod.decode_color_video_from_bytes(
            cout, CodecConfig(backend="native")), cframes)

    uframes = rng.integers(0, 65536, (4, 16, 24)).astype(np.uint16)
    ublob = color_mod.encode_gray16_to_bytes(
        uframes, CodecConfig(backend="native"))
    uout = surgery.resegment_video(ublob, 2)
    np.testing.assert_array_equal(
        color_mod.decode_gray16_from_bytes(
            uout, CodecConfig(backend="native")), uframes)

    frames = _frames(7)
    tcfg = CodecConfig(backend="native", temporal=True, keyint=3,
                       motion=True, frame_crcs=True)
    tblob = temporal.encode_temporal_video(frames, tcfg)
    tout = surgery.resegment_video(tblob, 2)
    np.testing.assert_array_equal(
        temporal.decode_temporal_video(tout, CodecConfig(backend="native")),
        frames)
    # the wrapper survives: keyint, motion table, FCRC, short first group
    cut = surgery.extract_video(tblob, 1, 7)  # short first group (2)
    rcut = surgery.resegment_video(cut, 2)
    np.testing.assert_array_equal(
        temporal.decode_temporal_video(rcut, CodecConfig(backend="native")),
        frames[1:7])


def test_resegment_serves_streaming_decode(tmp_path):
    """The use-case: a monolithic archive becomes streamed-decodable."""
    from metalhuffman import cli

    frames = _frames(9)
    src = tmp_path / "f.npy"
    np.save(src, frames)
    mono = tmp_path / "mono.mhtv"
    assert cli.main(["encode-video", str(src), str(mono),
                     "--frame-crcs"]) == 0
    seg = tmp_path / "seg.mhv2"
    assert cli.main(["resegment", str(mono), str(seg),
                     "--segment-frames", "4"]) == 0
    assert cli.main(["verify", str(seg), "--backend", "native"]) == 0
    dec = tmp_path / "d.npy"
    assert cli.main(["decode-video", str(seg), str(dec), "--streaming",
                     "--backend", "native"]) == 0
    np.testing.assert_array_equal(np.load(dec), frames)


def test_resegment_errors():
    with pytest.raises(ValueError, match=">= 1"):
        surgery.resegment_video(b"MHTV" + b"\0" * 40, 0)
    with pytest.raises(ValueError, match="video container"):
        surgery.resegment_video(b"MHT1" + b"\0" * 40, 2)


# -- constant-memory file-to-file concat (round 4) ----------------------------


def test_streamed_concat_byte_identical(tmp_path):
    """concat_videos_streamed == concat_videos, for every input mix."""
    f1, f2 = _frames(5), _frames(4, seed=3)
    cfg = CodecConfig(backend="native", frame_crcs=True)
    b1 = mh.encode_video(f1, cfg)  # MHTV
    b2 = surgery.resegment_video(mh.encode_video(f2, cfg), 2)  # MHV2
    p1, p2 = tmp_path / "a.mhtv", tmp_path / "b.mhv2"
    p1.write_bytes(b1)
    p2.write_bytes(b2)
    out = tmp_path / "cat.mhv2"
    info = surgery.concat_videos_streamed([p1, p2], out)
    assert out.read_bytes() == surgery.concat_videos([b1, b2])
    assert (info["frames"], info["segments"]) == (9, 3)
    assert info["crc_recorded"]
    np.testing.assert_array_equal(
        mh.decode_video(out.read_bytes(), CodecConfig(backend="native")),
        np.concatenate([f1, f2]))
    # FCRC table concatenated and usable
    fc = frame_stream.read_frame_crcs(out.read_bytes())
    assert fc is not None and fc.shape[0] == 9


def test_streamed_concat_color_and_refusals(tmp_path):
    rng = np.random.default_rng(11)
    c1 = np.clip(rng.normal(128, 25, (3, 16, 24, 3)), 0,
                 255).astype(np.uint8)
    c2 = np.clip(rng.normal(90, 25, (2, 16, 24, 3)), 0,
                 255).astype(np.uint8)
    ncfg = CodecConfig(backend="native")
    cb1 = color_mod.encode_color_video_to_bytes(
        c1, ncfg, colorspace=color_mod.CS_SUBGREEN)
    cb2 = color_mod.encode_color_video_to_bytes(
        c2, ncfg, colorspace=color_mod.CS_SUBGREEN)
    p1, p2 = tmp_path / "a.mhtc", tmp_path / "b.mhtc"
    p1.write_bytes(cb1)
    p2.write_bytes(cb2)
    out = tmp_path / "cat.mhtc"
    surgery.concat_videos_streamed([p1, p2], out)
    assert out.read_bytes() == surgery.concat_videos([cb1, cb2])
    np.testing.assert_array_equal(
        color_mod.decode_color_video_from_bytes(out.read_bytes(), ncfg),
        np.concatenate([c1, c2]))
    # MHVT refused with guidance; mismatched headers refused
    tb = temporal.encode_temporal_video(
        _frames(4), CodecConfig(backend="native", temporal=True, keyint=2))
    pt = tmp_path / "t.mhvt"
    pt.write_bytes(tb)
    with pytest.raises(ValueError, match="MHVT"):
        surgery.concat_videos_streamed([pt, pt], tmp_path / "x")
    cb3 = color_mod.encode_color_video_to_bytes(c1, ncfg)  # identity cs
    p3 = tmp_path / "c.mhtc"
    p3.write_bytes(cb3)
    with pytest.raises(ValueError, match="share"):
        surgery.concat_videos_streamed([p1, p3], tmp_path / "x")


def test_streamed_concat_cli(tmp_path):
    from metalhuffman import cli

    frames = _frames(6)
    src = tmp_path / "f.npy"
    np.save(src, frames)
    a = tmp_path / "a.mhtv"
    assert cli.main(["encode-video", str(src), str(a),
                     "--frame-crcs"]) == 0
    out = tmp_path / "cat.mhv2"
    assert cli.main(["concat", str(out), str(a), str(a),
                     "--streaming"]) == 0
    assert cli.main(["verify", str(out), "--streaming",
                     "--backend", "native"]) == 0
    np.testing.assert_array_equal(
        mh.decode_video(out.read_bytes(), CodecConfig(backend="native")),
        np.concatenate([frames, frames]))

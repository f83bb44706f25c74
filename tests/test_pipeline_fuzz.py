"""Randomized pipeline composition fuzz: container kind x precoder x
temporal x surgery x random access, checked for end-to-end consistency.

Each trial builds a random clip, encodes it under a random configuration,
optionally performs lossless surgery, then cross-checks full decode,
range decode, single-frame access, and a random spatial crop against the
source. A fixed seed keeps failures reproducible; the native backend keeps
the loop fast (device paths are gated bit-exact against it elsewhere).
"""

import numpy as np

import metalhuffman as mh
from metalhuffman.models import CodecConfig, frame_stream, surgery, temporal
from metalhuffman.models import color as color_mod

BACK = dict(backend="native")


def _random_clip(rng):
    t = int(rng.integers(2, 9))
    h = int(rng.integers(9, 41))
    w = int(rng.integers(9, 49))
    kind = rng.choice(["gray", "color", "u16"])
    if kind == "gray":
        base = rng.integers(0, 256, (h, w), np.uint8)
    elif kind == "color":
        base = rng.integers(0, 256, (h, w, 3), np.uint8)
    else:
        base = rng.integers(0, 1 << 16, (h, w)).astype(np.uint16)
    frames = np.stack([np.roll(base, (int(rng.integers(-3, 4)) * i,
                                      int(rng.integers(-3, 4)) * i),
                               (0, 1)) for i in range(t)])
    return kind, frames


def _encode(kind, frames, rng):
    precoder = rng.choice(["none", "delta", "delta2d", "zero_init"])
    cfg = CodecConfig(
        **BACK,
        delta=precoder != "none",
        delta2d=precoder == "delta2d",
        zero_init=precoder == "zero_init",
        temporal=bool(rng.integers(0, 2)),
        motion=bool(rng.integers(0, 2)),
        keyint=int(rng.integers(1, 5)),
        frame_crcs=bool(rng.integers(0, 2)),
    )
    if kind == "gray":
        return mh.encode_video(frames, cfg), cfg
    if kind == "color":
        cs = (color_mod.CS_SUBGREEN if rng.integers(0, 2)
              else color_mod.CS_IDENTITY)
        if cfg.temporal:
            return temporal.encode_temporal_color_video(
                frames, cfg, colorspace=cs), cfg
        return color_mod.encode_color_video_to_bytes(
            frames, cfg, colorspace=cs), cfg
    if cfg.temporal:
        return temporal.encode_temporal_gray16_video(frames, cfg), cfg
    return color_mod.encode_gray16_to_bytes(frames, cfg), cfg


def _decode(kind, blob):
    dec = CodecConfig(**BACK)
    if blob[:4] == temporal.TEMPORAL_MAGIC:
        return temporal.decode_temporal_video(blob, dec)
    if kind == "gray":
        return mh.decode_video(blob, dec)
    if kind == "color":
        return color_mod.decode_color_video_from_bytes(blob, dec)
    return color_mod.decode_gray16_from_bytes(blob, dec)


def test_pipeline_fuzz(tmp_path):
    rng = np.random.default_rng(2026)
    for trial in range(60):
        kind, frames = _random_clip(rng)
        t, h, w = frames.shape[:3]
        blob, cfg = _encode(kind, frames, rng)
        ctx = f"trial {trial}: {kind} {frames.shape} cfg={cfg}"

        # full decode
        got = _decode(kind, blob)
        assert np.array_equal(got, frames), f"full decode, {ctx}"

        # random frame access
        n = int(rng.integers(0, t))
        if blob[:4] == temporal.TEMPORAL_MAGIC:
            one = temporal.decode_temporal_frame(blob, n, CodecConfig(**BACK))
        elif kind == "gray":
            one, _h, _w = frame_stream.decode_range(
                blob, n, n + 1, CodecConfig(**BACK))
            one = one[0]
        else:
            one = color_mod.decode_color_frame(blob, n, CodecConfig(**BACK))
        assert np.array_equal(one, frames[n]), f"frame access, {ctx}"

        # random spatial crop of a random frame range
        a = int(rng.integers(0, t))
        b = int(rng.integers(a + 1, t + 1))
        y0 = int(rng.integers(0, h))
        x0 = int(rng.integers(0, w))
        rh = int(rng.integers(1, h - y0 + 1))
        rw = int(rng.integers(1, w - x0 + 1))
        if blob[:4] == temporal.TEMPORAL_MAGIC:
            crop = temporal.decode_temporal_video_region(
                blob, a, b, y0, x0, rh, rw, CodecConfig(**BACK))
        elif kind == "gray":
            crop = frame_stream.decode_video_region(
                blob, a, b, y0, x0, rh, rw, CodecConfig(**BACK))
        else:
            crop = color_mod.decode_color_video_region(
                blob, a, b, y0, x0, rh, rw, CodecConfig(**BACK))
        assert np.array_equal(
            crop, frames[a:b, y0 : y0 + rh, x0 : x0 + rw]), f"region, {ctx}"

        # streaming writers/readers (round 4): a streamed re-encode with a
        # random segment cap + random push chunking must decode to the
        # same frames, and the chunked readers must serve the stream in
        # order
        if blob[:4] == temporal.TEMPORAL_MAGIC:
            ck = int(rng.integers(1, t + 1))
            served = [c for _b, c in temporal.iter_temporal_video(
                blob, CodecConfig(**BACK), chunk_frames=ck)]
            assert np.array_equal(np.concatenate(served), frames), \
                f"temporal streaming serve, {ctx}"
            # round 5: streamed temporal re-encode (MHVT trailer layout)
            # with a random cap + chunking decodes to the same frames
            # through the layout-agnostic surfaces
            import io

            from metalhuffman.models.stream_writer import (
                TemporalStreamingEncoder)

            sink = io.BytesIO()
            enc = TemporalStreamingEncoder(
                sink, h, w, cfg,
                channels=frames.shape[-1] if kind == "color" else None,
                u16=kind == "u16",
                max_segment_frames=int(rng.integers(1, t + 1)),
                frame_crcs=cfg.frame_crcs)
            i = 0
            while i < t:
                j = min(t, i + int(rng.integers(1, t + 1)))
                enc.push(frames[i:j])
                i = j
            enc.close()
            tblob = sink.getvalue()
            assert np.array_equal(_decode(kind, tblob), frames), \
                f"streamed temporal re-encode, {ctx}"
            n2 = int(rng.integers(0, t))
            assert np.array_equal(
                temporal.decode_temporal_frame(tblob, n2,
                                               CodecConfig(**BACK)),
                frames[n2]), f"trailer-layout frame access, {ctx}"
        else:
            import io

            from metalhuffman.models.stream_writer import (
                ColorStreamingEncoder, StreamingEncoder)

            cap = int(rng.integers(1, t + 1))
            sink = io.BytesIO()
            if kind == "gray":
                enc = StreamingEncoder(sink, h, w, cfg,
                                       max_segment_frames=cap,
                                       frame_crcs=cfg.frame_crcs)
            else:
                enc = ColorStreamingEncoder(
                    sink, h, w,
                    channels=None if kind == "u16" else frames.shape[-1],
                    u16=kind == "u16", config=cfg,
                    max_segment_frames=cap, frame_crcs=cfg.frame_crcs)
            i = 0
            while i < t:  # random push chunking
                j = min(t, i + int(rng.integers(1, t + 1)))
                enc.push(frames[i:j])
                i = j
            enc.close()
            sblob = sink.getvalue()
            assert np.array_equal(_decode(kind, sblob), frames), \
                f"streamed re-encode decode, {ctx} cap={cap}"
            if kind == "gray":
                import dataclasses

                segs2, _t2, _h2, _w2, bd2, d2 = \
                    frame_stream.read_segmented(sblob)
                rcfg = dataclasses.replace(  # container mode authoritative
                    CodecConfig(**BACK), block_dim=bd2, delta=d2,
                    delta2d=segs2[0][0].predictor == "2d")
                chunks = list(frame_stream.iter_frames_segmented(
                    segs2, h, w, rcfg))
                assert np.array_equal(np.concatenate(chunks), frames), \
                    f"streamed serve, {ctx} cap={cap}"
                # round 5: the MHTS streaming writer + one-frame-at-a-time
                # reader join the matrix (gray only, like the batch CLI)
                sink_m = io.BytesIO()
                from metalhuffman.models.stream_writer import (
                    MHTSStreamingEncoder)

                with MHTSStreamingEncoder(sink_m, h, w, cfg) as enc_m:
                    i = 0
                    while i < t:
                        j = min(t, i + int(rng.integers(1, t + 1)))
                        enc_m.push(frames[i:j])
                        i = j
                mhts_blob = sink_m.getvalue()
                served_m = [fr for _i, fr, _e, _c in
                            frame_stream.iter_stream_frames(
                                mhts_blob, CodecConfig(**BACK))]
                assert np.array_equal(np.stack(served_m), frames), \
                    f"MHTS streamed roundtrip, {ctx}"
                # truncations of the MHTS must raise controlled errors
                for _ in range(2):
                    cut = int(rng.integers(4, len(mhts_blob)))
                    try:
                        list(frame_stream.iter_stream_frames(
                            mhts_blob[:cut], CodecConfig(**BACK)))
                    except (ValueError, RuntimeError):
                        pass
                # MHTS surgery: verbatim record splices (round 5)
                ma = int(rng.integers(0, t))
                mb = int(rng.integers(ma + 1, t + 1))
                mpart = surgery.extract_video(mhts_blob, ma, mb)
                got_m = [fr for _i, fr, _e, _c in
                         frame_stream.iter_stream_frames(
                             mpart, CodecConfig(**BACK))]
                assert np.array_equal(np.stack(got_m), frames[ma:mb]), \
                    f"MHTS extract, {ctx}"
                mcat = surgery.concat_videos([mhts_blob, mpart])
                got_c = [fr for _i, fr, _e, _c in
                         frame_stream.iter_stream_frames(
                             mcat, CodecConfig(**BACK))]
                assert np.array_equal(
                    np.stack(got_c),
                    np.concatenate([frames, frames[ma:mb]])), \
                    f"MHTS concat, {ctx}"

        # lossless surgery when the container supports this range
        ki = cfg.keyint
        sa = (int(rng.integers(0, t // ki + 1)) * ki
              if blob[:4] == temporal.TEMPORAL_MAGIC else
              int(rng.integers(0, t)))
        if sa < t:
            sb = int(rng.integers(sa + 1, t + 1))
            part = surgery.extract_video(blob, sa, sb)
            assert np.array_equal(_decode(kind, part),
                                  frames[sa:sb]), f"extract, {ctx}"
            if blob[:4] != temporal.TEMPORAL_MAGIC or t % ki == 0:
                joined = surgery.concat_videos([blob, blob])
                assert np.array_equal(
                    _decode(kind, joined),
                    np.concatenate([frames, frames])), f"concat, {ctx}"

        # round 5: resegment (in-memory + streamed, byte-identical) and
        # streamed file-to-file concat join the composition matrix —
        # these splice at mmap/byte level, where an off-by-one survives
        # until a fuzzer finds it
        per = int(rng.integers(1, t + 2))
        reseg = surgery.resegment_video(blob, per)
        assert np.array_equal(_decode(kind, reseg), frames), \
            f"resegment, {ctx} per={per}"
        if blob[:4] != temporal.TEMPORAL_MAGIC:
            src_p = tmp_path / "in.bin"
            src_p.write_bytes(blob)
            dst_p = tmp_path / "reseg.bin"
            surgery.resegment_video_streamed(src_p, dst_p, per)
            assert dst_p.read_bytes() == reseg, \
                f"streamed resegment byte-identity, {ctx} per={per}"
            cat_p = tmp_path / "cat.bin"
            surgery.concat_videos_streamed([src_p, src_p], cat_p)
            assert cat_p.read_bytes() == surgery.concat_videos(
                [blob, blob]), f"streamed concat byte-identity, {ctx}"

        # truncation fuzz over the streamed readers: any cut must raise a
        # controlled error (never IndexError/struct.error), or — when the
        # cut only removes trailers — still serve correct frames
        for _ in range(3):
            cut = int(rng.integers(4, len(blob)))
            try:
                if blob[:4] == temporal.TEMPORAL_MAGIC:
                    for _b, _c in temporal.iter_temporal_video(
                            blob[:cut], CodecConfig(**BACK)):
                        pass
                elif kind == "gray" and \
                        blob[:4] == frame_stream.SEGMENTED_MAGIC:
                    segs3, _t3, h3, w3, bd3, d3 = \
                        frame_stream.read_segmented(blob[:cut])
                    import dataclasses as _dc

                    rcfg3 = _dc.replace(
                        CodecConfig(**BACK), block_dim=bd3, delta=d3)
                    for _c in frame_stream.iter_frames_segmented(
                            segs3, h3, w3, rcfg3):
                        pass
            except (ValueError, RuntimeError):
                pass  # controlled rejection

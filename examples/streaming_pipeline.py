"""Constant-memory capture -> serve loop: streaming encode and decode.

    python examples/streaming_pipeline.py

The batch writers hold a whole clip in memory; a capture pipeline cannot
(an hour of 2048x1536 video is ~340 GB raw). This example runs the
streaming family end to end with frames produced one at a time and
consumed chunk by chunk — peak memory is one MHV2 segment, independent of
clip length:

1. ``StreamingEncoder``      push frames -> MHV2 segments written as they fill
2. ``iter_frames_segmented`` streamed decode, source CRC chained per chunk
3. ``ColorStreamingEncoder`` the same for MHTC color (sub-green planes)
4. ``iter_temporal_video``   streamed MHVT serving, group-aligned chunks
5. ``TemporalStreamingEncoder`` + ``append=True``: a capture that STOPS
   (clean close) and RESUMES in place — byte-identical to never stopping

Uses the host (native C++) backend so it runs anywhere instantly; the
device backends stream identically (each chunk is a normal segment decode,
pipelined by ``StreamingDecoder`` under the hood).
"""

from __future__ import annotations

import io
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from metalhuffman.models import (CodecConfig, ColorStreamingEncoder,
                                     StreamingEncoder, frame_stream,
                                     temporal)
from metalhuffman.utils import fixtures


def camera(n, img):
    """A frame source that never holds more than one frame."""
    for t in range(n):
        yield np.roll(img, (3 * t, 16 * t), axis=(0, 1))


def main():
    img = fixtures.render_frame("bridge")
    h, w = img.shape
    n = 24
    cfg = CodecConfig(backend="native")

    # 1. streaming encode: frames pushed one at a time, segments written
    #    the moment they fill (here: capped at 6 frames/segment so the
    #    buffer never holds more than 6 raw frames of a 24-frame clip)
    sink = io.BytesIO()
    with StreamingEncoder(sink, h, w, cfg, max_segment_frames=6,
                          frame_crcs=True) as enc:
        for frame in camera(n, img):
            enc.push(frame)
    stats = enc.stats
    blob = sink.getvalue()
    print(f"streamed encode: {stats.total_frames} frames {h}x{w} -> "
          f"MHV2[{stats.num_segments} segments] {stats.bytes_written} bytes "
          f"({stats.bytes_written/(n*h*w):.1%} of raw), peak buffer "
          f"{min(enc.segment_frames, 6)} frames")

    # 2. streamed decode: chunks arrive per segment; chain their CRCs and
    #    compare with the recorded whole-payload CRC at the end
    import zlib

    segs, t, _h, _w, _bd, _delta = frame_stream.read_segmented(blob)
    crc, served = 0, 0
    for chunk in frame_stream.iter_frames_segmented(segs, h, w, cfg):
        crc = zlib.crc32(np.ascontiguousarray(chunk).tobytes(), crc)
        served += chunk.shape[0]  # a real consumer writes + drops here
        expect = np.stack(list(camera(n, img))[served - chunk.shape[0]:served])
        assert np.array_equal(chunk, expect)
    assert crc == frame_stream.source_crc32(blob)
    print(f"streamed decode: {served} frames served in "
          f"{len(segs)} chunks, bit-exact, chained CRC == recorded CRC")

    # 3. the same loop for color: MHTC wraps a streamed inner MHV2
    from metalhuffman.models import color

    cframes = np.stack([np.stack([f, np.roll(f, 9, 1), np.roll(f, 21, 0)],
                                 axis=-1)
                        for f in camera(4, img[:512, :512])])
    csink = io.BytesIO()
    with ColorStreamingEncoder(csink, 512, 512, channels=3, config=cfg,
                               colorspace=color.CS_SUBGREEN,
                               max_segment_frames=2) as cenc:
        for f in cframes:
            cenc.push(f)
    out = color.decode_color_video_from_bytes(csink.getvalue(), cfg)
    assert np.array_equal(out, cframes)
    print(f"streamed color encode: {cenc.stats.total_frames} frames -> MHTC "
          f"{cenc.stats.bytes_written} bytes "
          f"({cenc.stats.bytes_written/cframes.size:.1%}), decoded bit-exact")

    # 4. streamed temporal serving: an MHVT container decoded in
    #    keyframe-group-aligned chunks — each residual decodes exactly
    #    once, the outer CRC chains across chunks
    frames = np.stack(list(camera(12, img)))
    tcfg = CodecConfig(backend="native", temporal=True, keyint=4,
                       motion=True)
    tblob = temporal.encode_temporal_video(frames, tcfg)
    print(f"temporal: 12 frames -> MHVT[keyint 4, motion] {len(tblob)} "
          f"bytes ({len(tblob)/frames.size:.1%})")
    for base, chunk in temporal.iter_temporal_video(tblob, cfg,
                                                    chunk_frames=4):
        assert np.array_equal(chunk, frames[base : base + chunk.shape[0]])
    print("streamed temporal serving: 3 group chunks, bit-exact, "
          "chained CRC verified")

    # 5. capture resume: stop after 6 frames (finalized container), come
    #    back later and --append the rest — CRC/motion tables chain, the
    #    keyframe cadence continues, and the result is byte-identical to
    #    a capture that never stopped (SURVEY section 5 checkpoint/resume)
    import tempfile
    from pathlib import Path

    from metalhuffman.models import TemporalStreamingEncoder

    cap = Path(tempfile.mkdtemp()) / "capture.mhvt"
    scfg = CodecConfig(backend="native", temporal=True, keyint=3,
                       motion=True)
    with TemporalStreamingEncoder(cap, h, w, scfg, max_segment_frames=3,
                                  frame_crcs=True) as enc1:
        for f in frames[:6]:
            enc1.push(f)      # ... crash/stop here: file is finalized
    with TemporalStreamingEncoder(cap, h, w, scfg, max_segment_frames=3,
                                  append=True) as enc2:
        for f in frames[6:]:
            enc2.push(f)      # resumed in place
    one_shot = io.BytesIO()
    with TemporalStreamingEncoder(one_shot, h, w, scfg,
                                  max_segment_frames=3,
                                  frame_crcs=True) as enc3:
        enc3.push(frames)
    assert cap.read_bytes() == one_shot.getvalue()
    assert np.array_equal(temporal.decode_temporal_video(
        cap.read_bytes(), cfg), frames)
    print(f"capture resume: 6 + 6 frames appended in place == one-shot "
          f"capture bytes ({enc2.stats.bytes_written} B), bit-exact")
    print("OK")


if __name__ == "__main__":
    main()

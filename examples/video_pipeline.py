"""Video workflow end to end: encode -> stream-decode -> random access -> verify.

    python examples/video_pipeline.py          # on a GPU (or CPU via interpret)

Walks the production video surface: shared-table batch encode with the
delta2d precoder, pipelined streaming decode (staging of batch t+1 overlaps
decode of t), temporal random access (one frame's blocks only), the
on-device end-bit integrity check, and the recorded source CRC-32.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import metalhuffman as mht
from metalhuffman.models import CodecConfig, frame_stream
from metalhuffman.utils import fixtures


def main():
    # 1. a short photographic clip (the committed bridge asset, panned)
    img = fixtures.render_frame("bridge")
    frames = np.stack([np.roll(img, 16 * t, axis=1) for t in range(6)])
    t, h, w = frames.shape
    print(f"clip: {t} frames {h}x{w} ({frames.size/1e6:.1f} MB raw)")

    # 2. encode with the 2-D predictor (5-15% smaller on photos, decoded at
    #    full speed — the kernel reconstructs it in registers)
    cfg = CodecConfig(backend="pallas", delta2d=True)  # interpreted on CPU
    blob = mht.encode_video(frames, cfg)
    print(f"MHTV: {len(blob)} bytes ({len(blob)/frames.size:.1%} of raw), "
          f"mode=delta2d, CRC recorded")

    # 3. decode the whole batch (one fused kernel dispatch; decode_video
    #    verifies the recorded CRC automatically)
    out = mht.decode_video(blob, cfg)
    assert np.array_equal(out, frames)
    print("batch decode: bit-exact, CRC verified")

    # 4. streaming: batches pipeline through the device (t+1 stages while
    #    t decodes) — the pattern for long clips / MHV2 segments
    stream, _t, _h, _w, _bd, _delta = frame_stream.read_shared(blob)
    dec = frame_stream.StreamingDecoder(cfg)
    handle = dec.submit(stream, t, h, w)
    assert np.array_equal(dec.result(handle), frames)
    print("streaming decode: bit-exact")

    # 5. temporal random access: frame 4 alone, 1/T of the work
    one = frame_stream.decode_frame(stream, 4, h, w, cfg)
    assert np.array_equal(np.asarray(one), frames[4])
    print("random-access frame 4: bit-exact")

    # 6. integrity: the kernel emits each block's end-bit position for free;
    #    a corrupt stream fails here (and the CRC backstops code
    #    substitutions that preserve block lengths)
    prep = frame_stream.prepare_shared(stream, t, h, w, cfg, check=True)
    _, err = frame_stream.decode_shared_step_checked(prep, cfg)
    assert not err.any()
    print(f"on-device end-bit check: {err.size} blocks ok")

    # 7. temporal prediction with global motion compensation: this clip is
    #    a pan, so frame differencing alone would LOSE — the per-frame
    #    motion vector cancels the pan and --best style measurement keeps
    #    whichever coding is smallest (here: temporal+motion)
    from metalhuffman.models import temporal

    tblob, kind, _used = temporal.encode_video_best(
        frames, CodecConfig(**{**cfg.__dict__, "temporal": True,
                               "motion": True}))
    assert np.array_equal(mht.decode_video(tblob, cfg), frames)
    assert np.array_equal(
        temporal.decode_temporal_frame(tblob, 4, cfg), frames[4])
    print(f"temporal best: kept {kind}, {len(tblob)} bytes "
          f"({len(tblob)/frames.size:.1%} vs {len(blob)/frames.size:.1%} "
          f"plain) — bit-exact incl. random access")

    # 8. spatio-temporal ROI: a 256x256 crop of frames [2, 5) — neither
    #    the rest of each frame nor the other frames are ever decoded
    roi = frame_stream.decode_video_region(blob, 2, 5, 512, 512, 256, 256,
                                           cfg)
    assert np.array_equal(roi, frames[2:5, 512:768, 512:768])
    print("spatio-temporal ROI: bit-exact (region blocks only)")

    # 9. lossless container surgery: cut frames [1, 5) and splice — no
    #    re-encode, CRCs combine algebraically
    from metalhuffman.models import surgery

    part = surgery.extract_video(blob, 1, 5)
    assert np.array_equal(mht.decode_video(part, cfg), frames[1:5])
    joined = surgery.concat_videos([part, blob])
    assert np.array_equal(mht.decode_video(joined, cfg),
                          np.concatenate([frames[1:5], frames]))
    print(f"surgery: extract+concat bit-exact, zero re-encode "
          f"({len(part)} + {len(blob)} -> {len(joined)} bytes)")
    print("video pipeline OK")


if __name__ == "__main__":
    main()

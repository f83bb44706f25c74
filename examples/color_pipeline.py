"""Color / 16-bit workflow end to end: MHTC containers over the plane stream.

    python examples/color_pipeline.py          # on a GPU (or CPU via interpret)

The reference converts its RGB assets TO grayscale (CoreGraphics,
``HuffRenderFrame.m:93-127``); the MHTC wrapper is the beyond-reference path
that keeps the channels: planar RGB(A) images and video, plus uint16
grayscale (depth maps) as hi/lo byte planes. Every plane rides the
shared-table batch pipeline — one canonical table, one kernel dispatch for
all planes — and inherits CRC + end-bit integrity checks, MHV2 segmenting,
and temporal random access.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import metalhuffman as mht
from metalhuffman.models import CodecConfig, color
from metalhuffman.utils import fixtures


def main():
    # 1. a synthetic color photo: the committed bridge asset as luma, with
    #    smooth chroma ramps (natural-photo-like channel statistics)
    luma = fixtures.render_frame("bridge").astype(np.int32)
    h, w = luma.shape
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    cb = 30 * np.sin(xx / 97.0) + 10 * np.cos(yy / 61.0)
    cr = 25 * np.cos(xx / 83.0) - 12 * np.sin(yy / 53.0)
    img = np.stack([
        np.clip(luma + 1.4 * cr, 0, 255),
        np.clip(luma - 0.34 * cb - 0.71 * cr, 0, 255),
        np.clip(luma + 1.77 * cb, 0, 255),
    ], axis=-1).astype(np.uint8)
    print(f"color image: {h}x{w}x3 ({img.size / 1e6:.1f} MB raw)")

    # 2. color image roundtrip (delta2d precoder; 3 planes, one dispatch)
    cfg = CodecConfig(backend="pallas", delta2d=True)
    blob = mht.encode_color_image(img, cfg)
    out = mht.decode_color_image(blob, cfg)
    assert np.array_equal(out, img)
    print(f"MHTC image: {len(blob)} bytes ({len(blob)/img.size:.1%}), "
          f"bit-exact, CRC verified")

    # 3. color video + temporal random access (frame 2's planes only)
    frames = np.stack([np.roll(img, 24 * t, axis=1) for t in range(4)])
    vblob = mht.encode_color_video(frames, cfg)
    vout = mht.decode_color_video(vblob, cfg)
    assert np.array_equal(vout, frames)
    one = color.decode_color_frame(vblob, 2, cfg)
    assert np.array_equal(one, frames[2])
    print(f"MHTC video: {len(vblob)} bytes "
          f"({len(vblob)/frames.size:.1%}), batch + frame-2 random access "
          f"bit-exact")

    # 4. 16-bit depth map: hi/lo byte planes; the hi plane of smooth depth
    #    content is near-constant and compresses to almost nothing
    depth = (20000 + 40 * luma + 8 * yy).astype(np.uint16)
    dblob = color.encode_gray16_to_bytes(depth, cfg)
    dout = color.decode_gray16_from_bytes(dblob, cfg)
    assert np.array_equal(dout, depth)
    print(f"MHTC gray16: {len(dblob)} bytes "
          f"({len(dblob)/(depth.size*2):.1%} of the 16-bit raw), bit-exact")


if __name__ == "__main__":
    main()

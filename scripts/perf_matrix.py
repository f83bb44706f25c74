"""Reproducible performance matrix: geometries x content x paths.

    python scripts/perf_matrix.py [--frames 30] [--iters 20]

Measures decode throughput (bit-exact gated, distinct inputs per timed
iteration — bench.py methodology) for:
  - the decode kernel, shared-table video batch (the headline path), at
    2048x1536 (the reference geometry) and 1920x1080 (the common video
    geometry)
  - multithreaded C++ host decoder
on synthetic photo-like content and the committed real-photo asset.
Prints a markdown table to stdout.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--variants", type=int, default=2)
    args = ap.parse_args()

    import jax

    import bench
    from metalhuffman import native
    from metalhuffman.models import CodecConfig, frame_stream
    from metalhuffman.utils import runtime

    runtime.require_gpu()
    runtime.configure_compile_cache()

    rows = []
    for h, w in ((1536, 2048), (1080, 1920)):
        for content in ("synthetic", "photo"):
            gbps, _reps, _spread = bench.run_video(
                h, w, args.frames, args.iters, verbose=False,
                content=content, variants=args.variants,
            )
            rows.append((f"{w}x{h}", content, "decode kernel", gbps))

    # delta2d precoder (mode 3): in-register reconstruction — expect parity
    gbps, _reps, _spread = bench.run_video(
        1536, 2048, args.frames, args.iters, verbose=False,
        content="photo", variants=args.variants, precoder="delta2d",
    )
    rows.append(("2048x1536", "photo", "decode kernel, delta2d", gbps))

    # MHVT temporal reconstruction chains (decode + on-device fold), photo
    # content at the reference geometry — run_temporal is the plain-gray
    # production path (raw words + SWAR fold); run_temporal_ext covers the
    # MC roll+scan and the color/u16 plane-fold chains
    gbps, _reps, _spread = bench.run_temporal(
        1536, 2048, args.frames, args.iters, verbose=False,
        content="photo", variants=args.variants)
    rows.append(("2048x1536", "photo", "MHVT fold (plain gray)", gbps))
    for label, kw in (("MHVT fold (motion)", {"motion": True}),
                      ("MHVT fold (color)", {"inner": "color"}),
                      ("MHVT fold (u16)", {"inner": "u16"}),
                      ("MHVT fold (color+motion)",
                       {"inner": "color", "motion": True})):
        gbps, _reps, _spread = bench.run_temporal_ext(
            1536, 2048, args.frames, args.iters, verbose=False,
            content="photo", variants=args.variants, **kw)
        rows.append(("2048x1536", "photo", label, gbps))

    # host C++ decoder on the reference geometry, real-photo content
    cfg = CodecConfig(backend="native")
    frames = bench.photo_frames(1536, 2048, args.frames)
    T, H, W = frames.shape
    stream = frame_stream.encode_frames_shared(frames, cfg)
    t0 = time.perf_counter()
    blk = native.decode_blocks(stream, delta=cfg.delta)
    dt = time.perf_counter() - t0
    exp = frames.reshape(T, H // 8, 8, W // 8, 8).transpose(
        0, 1, 3, 2, 4).reshape(-1, 64)
    assert np.array_equal(blk, exp), "host mismatch"
    rows.append(("2048x1536", "photo", "C++ host (all cores)",
                 frames.size / dt / 1e9))

    dev = jax.devices()[0].device_kind
    print(f"\n## Decode throughput ({args.frames} frames/batch, device={dev})\n")
    print("| geometry | content | path | GB/s | vs 0.094 GB/s target |")
    print("|---|---|---|---|---|")
    for geom, content, path, gbps in rows:
        print(f"| {geom} | {content} | {path} | {gbps:.2f} | "
              f"{gbps/0.094:.0f}x |")


if __name__ == "__main__":
    main()

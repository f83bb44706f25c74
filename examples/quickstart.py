"""Quickstart: the full API surface in one runnable script.

    python examples/quickstart.py            # on a GPU (or CPU via interpret)
"""

from __future__ import annotations

import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import metalhuffman as mht
from metalhuffman.models import CodecConfig, ImageCodec, frame_stream
from metalhuffman.utils import debug, fixtures


def main():
    # 1. a test frame (the reference's fixture configs, rebuilt)
    img = fixtures.render_frame("image1")  # 512x512 photo-like
    print(f"frame: {img.shape}, {img.size} bytes")

    # 2. one-call container round trip (CRC-verified)
    cfg = CodecConfig(backend="pallas")  # interpreted when JAX runs on CPU
    blob = mht.encode_image(img, cfg)
    restored = mht.decode_image(blob, cfg)
    assert np.array_equal(restored, img)
    print(f"MHT1 container: {len(blob)} bytes ({len(blob)/img.size:.1%}), bit-exact")

    # 3. the explicit pipeline: encode once, stage once, decode per tick
    codec = ImageCodec(cfg)
    stream = codec.encode(img)
    prep = codec.prepare(stream, *img.shape)
    out = codec.decode_step(prep)  # jitted device step
    assert np.array_equal(np.asarray(out), img)
    print(debug.stream_summary(stream))

    # 4. video: shared canonical table, whole batch in one kernel dispatch
    frames = np.stack([fixtures.render_frame("16x16_ident"),
                       fixtures.render_frame("16x16_ident2")])
    vblob = mht.encode_video(frames, cfg)
    assert np.array_equal(mht.decode_video(vblob, cfg), frames)
    print(f"MHTV container: {len(vblob)} bytes for {len(frames)} frames")

    # 4b. the delta2d precoder (mode 3): smaller streams at full decode
    #     speed (the kernel reconstructs the 2-D predictor in registers)
    best, used = codec.encode_best(img)  # measures none/delta/delta2d
    print(f"encode_best: predictor={best.predictor!r} "
          f"{best.compressed_size} bytes (delta was {stream.compressed_size})")

    # 5. files via the CLI-equivalent API
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "frame.mht")
        open(path, "wb").write(blob)
        from metalhuffman.core import container

        s2, h, w, bd, delta, crc = container.read_frame(open(path, "rb").read())
        print(f"read back: {h}x{w} block_dim={bd} delta={delta} crc={'yes' if crc else 'no'}")

    # 6. inspect one block's decode, symbol by symbol
    tr = debug.trace_block(stream, 0, delta=cfg.delta)
    print(f"block 0, first 3 symbols: "
          + ", ".join(f"bits[{t.bit_offset}:{t.bit_offset+t.width}]='{t.pattern}'->{t.value}"
                      for t in tr[:3]))
    print("quickstart OK")


if __name__ == "__main__":
    main()

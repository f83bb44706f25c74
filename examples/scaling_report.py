"""Multi-device scaling report: sharded DECODE + ENCODE vs device count.

    python examples/scaling_report.py                 # all visible devices
    python examples/scaling_report.py --cpu-devices 8 # virtual CPU mesh

Benchmarks the production path — the decode kernel under shard_map
(``shard_decode.decode_grid_sharded``), block rows sharded over the mesh,
staged once per mesh size and timed with distinct inputs per iteration
(bench.py methodology). On GPUs it reports the scaling efficiency over one
device; on CPU it runs the kernel in interpret mode as a functional
demonstration at a small size (mechanics identical: contiguous row-range
sharding, replicated words and tables).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

_ap = argparse.ArgumentParser()
_ap.add_argument("--cpu-devices", type=int, default=0,
                 help="force a virtual N-device CPU platform")
_ap.add_argument("--frames", type=int, default=16)
_ap.add_argument("--iters", type=int, default=10)
_args = _ap.parse_args()

import jax

if _args.cpu_devices:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", _args.cpu_devices)
import jax.numpy as jnp
import numpy as np

from metalhuffman.models import CodecConfig, frame_stream
from metalhuffman.ops import decode_pallas
from metalhuffman.parallel import mesh as mesh_mod, shard_decode


def _frames(t, h, w):
    rng = np.random.default_rng(0)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = []
    for i in range(t):
        img = 96 + 80 * np.sin((xx + 3 * i) / 97.0) * np.cos(yy / 71.0)
        out.append(np.clip(img + rng.normal(0, 3, (h, w)), 0, 255)
                   .astype(np.uint8))
    return np.stack(out)


def main():
    on_gpu = not decode_pallas.interpret_mode()
    if on_gpu:
        T, H, W = _args.frames, 1536, 2048
    else:
        T, H, W = 2, 64, 1024  # interpret mode: keep it small
    cfg = CodecConfig(backend="pallas")
    base_frames = _frames(T, H, W)
    # two distinct staged batches, alternated in the timed loop (frame
    # rotation keeps one canonical table)
    variants = [base_frames, np.roll(base_frames, 1, axis=0)]
    streams = [frame_stream.encode_frames_shared(f, cfg) for f in variants]
    payload = base_frames.size
    bw = W // cfg.block_dim

    n_all = len(jax.devices())
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_all]
    base_gbps = None
    print(f"platform={jax.default_backend()} devices={n_all} "
          f"payload={payload/1e6:.0f} MB frame={W}x{H} path=decode-kernel")
    for n in counts:
        mesh = mesh_mod.make_mesh(n)
        staged = [tuple(jnp.asarray(a)
                        for a in decode_pallas.prepare_stream(s))
                  for s in streams]

        def step(v):
            return shard_decode.decode_grid_sharded(
                *staged[v], mesh=mesh, grid_bw=bw, delta=cfg.delta)

        out = step(0)
        got = frame_stream.frames_from_raw(np.asarray(out), T, H, W)
        ok = np.array_equal(got, base_frames)
        jax.block_until_ready(step(1))
        t0 = time.perf_counter()
        r = None
        for i in range(_args.iters):
            r = step(i % 2)
        jax.block_until_ready(r)
        dt = (time.perf_counter() - t0) / _args.iters
        gbps = payload / dt / 1e9
        if base_gbps is None:
            base_gbps = gbps
        eff = gbps / (base_gbps * n) * 100
        print(f"  {n:2d} device(s): {dt*1e3:8.2f} ms  {gbps:7.3f} GB/s  "
              f"scaling {eff:5.1f}%  bit-exact={ok}")
        if not ok:
            sys.exit(1)

    # ENCODE direction: the sharded stage-1 pack under shard_map +
    # per-shard merges, byte-identical to the host encoder (stage 2 is the
    # multithreaded host merge)
    from metalhuffman import native
    from metalhuffman.core import blocks as blocks_mod
    from metalhuffman.core import delta as delta_mod
    from metalhuffman.parallel import shard_encode

    blk = np.concatenate([blocks_mod.image_to_blocks(f)
                          for f in base_frames])
    syms = delta_mod.delta_encode_blocks(blk).reshape(-1)
    ref = native.encode_symbols(syms, 64)
    print("encode (sharded stage-1 + per-shard merge):")
    for n in counts:
        mesh = mesh_mod.make_mesh(n)
        t0 = time.perf_counter()
        enc = shard_encode.encode_symbols_sharded(syms, mesh=mesh)
        dt = time.perf_counter() - t0
        ok = (np.array_equal(enc.code_bytes, ref.code_bytes)
              and np.array_equal(enc.block_offsets, ref.block_offsets))
        print(f"  {n:2d} device(s): {dt*1e3:8.2f} ms end-to-end  "
              f"byte-identical={ok}")
        if not ok:
            sys.exit(1)


if __name__ == "__main__":
    main()

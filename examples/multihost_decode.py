"""Multi-host sharded codec demo / test worker (decode AND encode).

Run N processes (multi-host simulation on CPU, or one per GPU host):

    python examples/multihost_decode.py --coordinator localhost:9911 \
        --num-processes 2 --process-id {0,1} [--devices-per-host 4]

Each process: joins the jax.distributed cluster, encodes the same synthetic
frame (stands in for "the stream was broadcast"), builds the global mesh,
decodes its block ranges, all-gathers the decoded blocks across hosts, and
verifies bit-exactness. Then the ENCODE direction: per-host histograms
reduced across hosts, stage-1 pack on the global mesh, per-host merges over
addressable shards writing disjoint byte spans — asserted byte-identical to
the host encoder. Exit code 0 on success.

``--devices-per-host N`` runs the process on N virtual CPU devices, so the
simulation never claims a GPU another process holds.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--devices-per-host", type=int, default=0,
                    help="force N virtual CPU devices per process")
    args = ap.parse_args()

    if args.devices_per_host:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.devices_per_host)

    import jax
    import numpy as np

    from metalhuffman.core import blocks, delta, encode_symbols
    from metalhuffman.ops import decode_xla
    from metalhuffman.parallel import multihost

    pid, pcount = multihost.initialize(
        args.coordinator, args.num_processes, args.process_id
    )
    print(f"[p{pid}] joined: {pcount} processes, "
          f"{len(jax.devices())} global / {len(jax.local_devices())} local devices",
          flush=True)

    # every host has the stream (broadcast stand-in: deterministic encode)
    rng = np.random.default_rng(0)
    img = (np.add.outer(np.arange(256), np.arange(512)) % 241).astype(np.uint8)
    img = (img + rng.integers(0, 7, img.shape)).astype(np.uint8)
    blk = blocks.image_to_blocks(img)
    enc = encode_symbols(delta.delta_encode_blocks(blk).ravel(), block_size=64)
    t1, t2 = decode_xla.prepare_tables(enc.widths)
    words, offsets, width = decode_xla.prepare_stream(enc)

    mesh = multihost.global_mesh()
    g_words, g_offs, g_t1, g_t2 = multihost.shard_global_inputs(
        mesh, words, offsets, t1, t2
    )
    decoded = multihost.decode_blocks_multihost(
        g_words, g_offs, g_t1, g_t2, mesh=mesh, width=width
    )
    out = multihost.gather_blocks(decoded, enc.block_offsets.size)
    if not np.array_equal(out, blk):
        print(f"[p{pid}] MISMATCH", flush=True)
        sys.exit(1)
    print(f"[p{pid}] bit-exact across {pcount} hosts "
          f"({mesh.shape}) OK", flush=True)

    # ENCODE direction: the full distributed pipeline (per-host histogram
    # -> cross-host reduce, global-mesh stage-1 pack, per-host merges over
    # addressable shards) must be byte-identical to the host encoder —
    # including a partial tail block and shards that straddle hosts
    from metalhuffman import native

    data = delta.delta_encode_blocks(blk).ravel()
    data = np.concatenate([data, data[: 64 * 5 + 13]])  # uneven + tail
    enc_mh = multihost.encode_symbols_multihost(
        data, mesh=mesh)
    enc_host = native.encode_symbols(data, 64)
    if not (np.array_equal(enc_mh.code_bytes, enc_host.code_bytes)
            and np.array_equal(enc_mh.block_offsets, enc_host.block_offsets)
            and np.array_equal(enc_mh.widths, enc_host.widths)):
        print(f"[p{pid}] ENCODE MISMATCH", flush=True)
        sys.exit(1)
    print(f"[p{pid}] encode byte-identical across {pcount} hosts "
          f"({enc_host.compressed_size} B) OK", flush=True)


if __name__ == "__main__":
    main()

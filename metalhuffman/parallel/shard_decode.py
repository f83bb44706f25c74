"""Sharded (multi-device) Huffman decode via shard_map.

The reference's core parallelism idea — every 8x8 block independently decodable
via its bit-offset root (``HuffmanUtil.cpp:1102-1117``) — generalizes directly
to devices: a contiguous *range of blocks* goes to each device ("sequence
parallelism" over one bitstream, SURVEY.md section 2.6), while the code-word
stream and the decode tables are replicated on every device. The decoded
output is a global array sharded in stream order on the block axis, so
stream-order assembly is just the output sharding — no explicit gather
collective needed; devices or hosts fetch whichever spans they want.

Two levels of parallelism:

- ``decode_blocks_sharded`` — one frame, blocks sharded over one mesh axis
  (the multi-device analog of the reference's fragment-per-block grid);
  ``decode_grid_sharded`` is the same split for the decode kernel, emitting
  image rows.
- ``decode_frames_sharded`` — a batch of frames sharded over ``data`` with
  blocks sharded over ``seq`` on a 2-D mesh (the 30-FPS video stream case,
  scaled out).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

shard_map = jax.shard_map

from ..ops import decode_xla, layout as layout_mod
from .mesh import DATA_AXIS, SEQ_AXIS


def _pad_axis0(x, multiple: int):
    n = x.shape[0]
    pad = (-n) % multiple
    if pad:
        x = jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
    return x


@partial(
    jax.jit,
    static_argnames=("mesh", "num_steps", "delta", "width", "axis_name"),
)
def decode_blocks_sharded(
    words,
    offsets,
    t1,
    t2,
    *,
    mesh: Mesh,
    width: int,
    num_steps: int = 64,
    delta: bool = True,
    axis_name: str = SEQ_AXIS,
):
    """Decode one frame's blocks sharded over ``axis_name``.

    Args:
        words: (n_words,) uint32 big-endian code words (replicated; must
            include >= ``width`` trailing pad words).
        offsets: (n_blocks,) int32 per-block bit offsets (sharded).
        t1/t2: packed int32 split decode tables (replicated).
        width: words per block row (static; see ops.layout.words_per_block).

    Returns:
        (n_blocks_padded, num_steps) uint8, sharded on axis 0 in stream order.
        Rows past the original n_blocks are padding garbage — crop them.
    """
    n_shards = mesh.shape[axis_name]
    offsets = _pad_axis0(offsets.astype(jnp.int32), n_shards)

    def local_decode(words_l, offsets_l, t1_l, t2_l):
        rows, bit_init = layout_mod.build_layout_jax(words_l, offsets_l, width)
        return decode_xla.decode_blocks(
            rows, bit_init, t1_l, t2_l, num_steps=num_steps, delta=delta
        )

    fn = shard_map(
        local_decode,
        mesh=mesh,
        in_specs=(P(), P(axis_name), P(), P()),
        out_specs=P(axis_name, None),
    )
    return fn(words, offsets, t1, t2)


@partial(
    jax.jit,
    static_argnames=("mesh", "num_steps", "delta", "width", "data_axis", "seq_axis"),
)
def decode_frames_sharded(
    words_b,
    offsets_b,
    t1_b,
    t2_b,
    *,
    mesh: Mesh,
    width: int,
    num_steps: int = 64,
    delta: bool = True,
    data_axis: str = DATA_AXIS,
    seq_axis: str = SEQ_AXIS,
):
    """Decode a batch of frames on a 2-D ``data x seq`` mesh.

    Frames are sharded over ``data``; within each frame, block ranges are
    sharded over ``seq``. Per-frame streams/tables are padded to common static
    shapes by the caller (see models.frame_stream for the bucketing policy).

    Args:
        words_b: (B, n_words) uint32 — per-frame code words, sharded on B.
        offsets_b: (B, n_blocks) int32 — sharded on B and on the block axis.
        t1_b: (B, 2^k1) int32; t2_b: (B, t2_size) int32 — sharded on B.

    Returns:
        (B, n_blocks, num_steps) uint8 sharded (data, seq, None).
    """
    n_seq = mesh.shape[seq_axis]
    if offsets_b.shape[1] % n_seq:
        pad = (-offsets_b.shape[1]) % n_seq
        offsets_b = jnp.pad(offsets_b, ((0, 0), (0, pad)))

    def local_decode(words_l, offsets_l, t1_l, t2_l):
        def per_frame(words_f, offsets_f, t1_f, t2_f):
            rows, bit_init = layout_mod.build_layout_jax(words_f, offsets_f, width)
            return decode_xla.decode_blocks(
                rows, bit_init, t1_f, t2_f, num_steps=num_steps, delta=delta
            )

        return jax.vmap(per_frame)(words_l, offsets_l, t1_l, t2_l)

    fn = shard_map(
        local_decode,
        mesh=mesh,
        in_specs=(
            P(data_axis, None),
            P(data_axis, seq_axis),
            P(data_axis, None),
            P(data_axis, None),
        ),
        out_specs=P(data_axis, seq_axis, None),
    )
    return fn(words_b, offsets_b, t1_b, t2_b)


@partial(
    jax.jit,
    static_argnames=("mesh", "grid_bw", "block_dim", "delta", "delta2d",
                     "axis_name", "k1", "k2"),
)
def decode_grid_sharded(
    words,
    offsets,
    t1,
    t2,
    *,
    mesh: Mesh,
    grid_bw: int,
    block_dim: int = 8,
    delta: bool = True,
    delta2d: bool = False,
    axis_name: str = SEQ_AXIS,
    k1: int = 8,
    k2: int = 8,
):
    """Multi-device kernel decode: block rows sharded over ``axis_name``.

    The block grid (``grid_bw`` blocks a row, frames stacked as extra rows)
    is padded to a whole number of rows per device; each device runs the
    decode kernel (``ops.decode_pallas.decode``) on its contiguous row range
    and emits those image rows. The output is the image words sharded by
    row range: (rows, grid_bw * block_dim // 4) int32, rows past the real
    grid are padding. Words and tables are replicated; delta2d reconstructs
    per block in registers, so no state crosses devices.
    """
    from ..ops import decode_pallas

    n_shards = mesh.shape[axis_name]
    offsets = _pad_axis0(jnp.asarray(offsets).astype(jnp.uint32),
                         n_shards * grid_bw)

    def local_decode(words_l, offsets_l, t1_l, t2_l):
        return decode_pallas.decode(
            words_l, offsets_l, t1_l, t2_l, block_dim=block_dim, delta=delta,
            delta2d=delta2d, grid_bw=grid_bw, k1=k1, k2=k2)

    fn = shard_map(
        local_decode,
        mesh=mesh,
        in_specs=(P(), P(axis_name), P(), P()),
        out_specs=P(axis_name),
        check_vma=False,
    )
    return fn(words, offsets, t1, t2)


def shard_stream_inputs(mesh: Mesh, words, offsets, t1, t2, axis_name: str = SEQ_AXIS):
    """Device_put inputs with the shardings decode_blocks_sharded expects.

    Placing inputs explicitly avoids a surprise re-shard inside jit; the
    offsets land as contiguous block ranges per device (stable block-range ->
    chip mapping keeps multi-host output deterministic, SURVEY.md section 7).
    """
    n_shards = mesh.shape[axis_name]
    offsets = _pad_axis0(jnp.asarray(offsets, jnp.int32), n_shards)
    rep = NamedSharding(mesh, P())
    seq = NamedSharding(mesh, P(axis_name))
    return (
        jax.device_put(words, rep),
        jax.device_put(offsets, seq),
        jax.device_put(t1, rep),
        jax.device_put(t2, rep),
    )

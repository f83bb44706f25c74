"""Sharded decode on the virtual 8-device CPU mesh vs the single-device path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metalhuffman.core import blocks, delta, encode_symbols
from metalhuffman.ops import decode_xla
from metalhuffman.parallel import mesh as mesh_mod, shard_decode


def _encode_image(shape, seed=0):
    rng = np.random.default_rng(seed)
    img = (
        np.add.outer(np.arange(shape[0]), np.arange(shape[1])) % 251
        + rng.integers(0, 5, shape)
    ).astype(np.uint8)
    blk = blocks.image_to_blocks(img)
    enc = encode_symbols(delta.delta_encode_blocks(blk).ravel(), block_size=64)
    return img, blk, enc


def test_mesh_construction():
    assert len(jax.devices()) == 8
    m1 = mesh_mod.make_mesh()
    assert m1.shape[mesh_mod.SEQ_AXIS] == 8
    m2 = mesh_mod.make_mesh_2d()
    assert m2.shape[mesh_mod.DATA_AXIS] * m2.shape[mesh_mod.SEQ_AXIS] == 8
    m3 = mesh_mod.make_mesh_2d(data_parallel=4)
    assert m3.shape[mesh_mod.DATA_AXIS] == 4


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_matches_single_device(n_dev):
    _, blk, enc = _encode_image((96, 120), seed=1)
    t1, t2 = decode_xla.prepare_tables(enc.widths)
    words, offsets, width = decode_xla.prepare_stream(enc)

    m = mesh_mod.make_mesh(n_dev)
    w_d, off_d, t1_d, t2_d = shard_decode.shard_stream_inputs(
        m, jnp.asarray(words), jnp.asarray(offsets), jnp.asarray(t1), jnp.asarray(t2)
    )
    out = shard_decode.decode_blocks_sharded(
        w_d, off_d, t1_d, t2_d, mesh=m, width=width
    )
    nb = enc.block_offsets.size
    np.testing.assert_array_equal(np.asarray(out)[:nb], blk)


def test_sharded_nonmultiple_block_count():
    # 5x7 blocks of a 40x56 image -> 35 blocks, not divisible by 8.
    _, blk, enc = _encode_image((40, 56), seed=2)
    assert enc.block_offsets.size % 8 != 0
    t1, t2 = decode_xla.prepare_tables(enc.widths)
    words, offsets, width = decode_xla.prepare_stream(enc)
    m = mesh_mod.make_mesh(8)
    out = shard_decode.decode_blocks_sharded(
        jnp.asarray(words),
        jnp.asarray(offsets.astype(np.int32)),
        jnp.asarray(t1),
        jnp.asarray(t2),
        mesh=m,
        width=width,
    )
    np.testing.assert_array_equal(np.asarray(out)[: enc.block_offsets.size], blk)


def test_frames_sharded_2d_mesh():
    m = mesh_mod.make_mesh_2d(data_parallel=2)  # 2 x 4
    frames, encs = [], []
    for i in range(4):  # batch of 4 frames over data=2
        _, blk, enc = _encode_image((48, 64), seed=10 + i)
        frames.append(blk)
        encs.append(enc)

    prepared = [decode_xla.prepare_stream(e) for e in encs]
    width = max(p[2] for p in prepared)
    prepared = [decode_xla.prepare_stream(e, width=width) for e in encs]
    n_words = max(p[0].size for p in prepared)
    nb = max(e.block_offsets.size for e in encs)

    words_b = np.zeros((4, n_words), np.uint32)
    offs_b = np.zeros((4, nb), np.int32)
    t1_list, t2_list = [], []
    for i, (w, o, _) in enumerate(prepared):
        words_b[i, : w.size] = w
        offs_b[i, : o.size] = o
        t1, t2 = decode_xla.prepare_tables(encs[i].widths)
        t1_list.append(t1)
        t2_list.append(t2)
    t2_size = max(t.size for t in t2_list)
    t2_b = np.zeros((4, t2_size), np.int32)
    for i, t in enumerate(t2_list):
        t2_b[i, : t.size] = t
    t1_b = np.stack(t1_list)

    out = shard_decode.decode_frames_sharded(
        jnp.asarray(words_b),
        jnp.asarray(offs_b),
        jnp.asarray(t1_b),
        jnp.asarray(t2_b),
        mesh=m,
        width=width,
    )
    out = np.asarray(out)
    for i, blk in enumerate(frames):
        np.testing.assert_array_equal(out[i, : blk.shape[0]], blk)

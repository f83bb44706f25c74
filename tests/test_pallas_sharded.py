"""Decode kernel under shard_map on the 8-device CPU mesh (interpret mode)."""

import jax.numpy as jnp
import numpy as np

from metalhuffman.core import blocks, delta, encode_symbols
from metalhuffman.models import frame_stream
from metalhuffman.ops import decode_pallas
from metalhuffman.parallel import mesh as mesh_mod, shard_decode


def _image(h, w, mod, seed):
    rng = np.random.default_rng(seed)
    img = (np.add.outer(np.arange(h), np.arange(w)) % mod).astype(np.uint8)
    return (img + rng.integers(0, 5, img.shape)).astype(np.uint8)


def test_pallas_sharded_matches_input():
    # 128 block rows over 8 devices: 16 contiguous rows each
    img = _image(1024, 1024, 239, 0)
    blk = blocks.image_to_blocks(img)
    enc = encode_symbols(delta.delta_encode_blocks(blk).ravel(), block_size=64)

    words, offsets, t1, t2 = decode_pallas.prepare_stream(enc)
    m = mesh_mod.make_mesh(8)
    out = shard_decode.decode_grid_sharded(
        jnp.asarray(words), jnp.asarray(offsets), jnp.asarray(t1),
        jnp.asarray(t2), mesh=m, grid_bw=128)
    assert len({s.device for s in out.addressable_shards}) == 8
    got = np.asarray(out).view(np.uint8).reshape(1024, 1024)
    np.testing.assert_array_equal(got, img)


def test_pallas_image_strips_sharded():
    # 64 block rows over 8 devices; a ragged row count pads per device
    img = _image(504, 1024, 233, 1)  # 63 block rows -> 64
    blk = blocks.image_to_blocks(img)
    enc = encode_symbols(delta.delta_encode_blocks(blk).ravel(), block_size=64)

    words, offsets, t1, t2 = decode_pallas.prepare_stream(enc)
    m = mesh_mod.make_mesh(8)
    out = shard_decode.decode_grid_sharded(
        jnp.asarray(words), jnp.asarray(offsets), jnp.asarray(t1),
        jnp.asarray(t2), mesh=m, grid_bw=128)
    assert out.shape == (512, 256)
    got = frame_stream.frames_from_raw(out, 1, 504, 1024)[0]
    np.testing.assert_array_equal(got, img)


def test_pallas_sharded_delta2d():
    """delta2d under shard_map: in-kernel reconstruction per block needs no
    cross-device state, so the mode shards exactly like the 1-D delta."""
    from metalhuffman.models.image_codec import CodecConfig

    img = _image(512, 1024, 233, 2)
    cfg = CodecConfig(backend="pallas", delta2d=True)
    enc = frame_stream.encode_frames_shared(img[None], cfg)
    m = mesh_mod.make_mesh(8)
    out = frame_stream.decode_shared_sharded(
        enc, 1, 512, 1024, mesh=m, config=cfg)
    got = frame_stream.frames_from_raw(out, 1, 512, 1024)[0]
    np.testing.assert_array_equal(got, img)

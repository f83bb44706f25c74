"""Sharded multi-chip encoder: byte-identity vs the host encoder.

Runs on the virtual 8-device CPU mesh (conftest) with the stage-1 packer
(plain XLA) — the same path ``__graft_entry__.dryrun_multichip`` certifies
and the GPU compiles. Every test asserts full byte-identity of
(code_bytes, block_offsets, widths) against ``native.encode_symbols``: the
seam splice, the all_gather prefix, and the per-shard merges must reproduce
the serial stream exactly.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from metalhuffman import native
from metalhuffman.parallel import mesh as mesh_mod, shard_encode

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device CPU mesh")


def _skewed(rng, n):
    """Odd-width codes so shard seams land at arbitrary bit phases."""
    p = 0.82 ** np.arange(40)
    return rng.choice(np.arange(40), size=n, p=p / p.sum()).astype(np.uint8)


def _assert_identical(got, ref):
    assert got.num_symbols == ref.num_symbols
    np.testing.assert_array_equal(got.widths, ref.widths)
    np.testing.assert_array_equal(got.code_bytes, ref.code_bytes)
    np.testing.assert_array_equal(got.block_offsets, ref.block_offsets)


@pytest.mark.parametrize("n_blocks,tail", [
    (3000, 0),        # 375 blocks a shard
    (8 * 1024, 0),    # exactly 1024 blocks a shard
    (9 * 1024 + 123, 37),  # partial last shard, tail symbols
])
def test_sharded_matches_native(n_blocks, tail):
    rng = np.random.default_rng(n_blocks)
    data = _skewed(rng, n_blocks * 64 + tail)
    ref = native.encode_symbols(data, 64)
    mesh = mesh_mod.make_mesh(8)
    got = shard_encode.encode_symbols_sharded(
        data, mesh=mesh)
    _assert_identical(got, ref)


def test_sharded_roundtrips():
    rng = np.random.default_rng(5)
    data = _skewed(rng, 2500 * 64)
    mesh = mesh_mod.make_mesh(8)
    got = shard_encode.encode_symbols_sharded(data, mesh=mesh)
    dec = native.decode_blocks(got, delta=False).ravel()
    np.testing.assert_array_equal(dec, data)


def test_sharded_small_mesh():
    # a 2-shard mesh exercises a different block split than 8
    rng = np.random.default_rng(9)
    data = _skewed(rng, 1100 * 64 + 5)
    ref = native.encode_symbols(data, 64)
    mesh = mesh_mod.make_mesh(2)
    got = shard_encode.encode_symbols_sharded(data, mesh=mesh)
    _assert_identical(got, ref)


def test_sharded_sub_block_falls_back():
    data = np.arange(40, dtype=np.uint8)
    ref = native.encode_symbols(data, 64)
    mesh = mesh_mod.make_mesh(8)
    got = shard_encode.encode_symbols_sharded(data, mesh=mesh)
    _assert_identical(got, ref)


def test_sharded_rejects_non_64_block():
    mesh = mesh_mod.make_mesh(8)
    with pytest.raises(ValueError):
        shard_encode.encode_symbols_sharded(
            np.zeros(64, np.uint8), mesh=mesh, block_size=16)


def test_sharded_incompressible_wide_rows():
    # near-uniform bytes: 8-bit codes, byte-aligned seams (the easy phase)
    # plus maximum row width — the opposite regime from the skewed sets
    rng = np.random.default_rng(21)
    data = rng.integers(0, 256, 9 * 1024 * 64, np.uint8)
    ref = native.encode_symbols(data, 64)
    mesh = mesh_mod.make_mesh(8)
    got = shard_encode.encode_symbols_sharded(data, mesh=mesh)
    _assert_identical(got, ref)

"""Hybrid device encoder: differential vs the native/NumPy encoders.

Stage 1 (``encode_device.pack_rows``, plain jitted XLA) runs on the CPU
here, the same program the GPU compiles; stage 2 is the real C++ merge (or
its NumPy fallback). Output must be byte-identical to
``native.encode_symbols``.
"""

import numpy as np
import pytest

from metalhuffman import native
from metalhuffman.core import bitstream, canonical
from metalhuffman.ops import encode_device


def _datasets():
    rng = np.random.default_rng(7)
    yield "uniform", rng.integers(0, 256, 64 * 200, np.uint8)
    yield "skewed", rng.choice(
        np.arange(32), size=64 * 300 + 17, p=(p := 0.8 ** np.arange(32)) / p.sum()
    ).astype(np.uint8)
    yield "constant", np.full(64 * 10 + 5, 9, np.uint8)
    # width-1 codes: the shortest chains through the chunk builder
    yield "two-sym", rng.choice([7, 200], size=64 * 130, p=[0.93, 0.07]).astype(np.uint8)
    # adversarial frequencies force package-merge 16-bit-capped widths —
    # the longest codes the chunk/deposit path can see
    counts = [2 ** i for i in range(24)]
    adv = np.concatenate([np.full(c, i, np.uint8) for i, c in enumerate(counts)])
    rng.shuffle(adv)
    yield "longcodes", adv[: (adv.size // 64) * 64]


@pytest.mark.parametrize(
    "name,data", list(_datasets()), ids=[n for n, _ in _datasets()])
def test_hybrid_matches_native(name, data):
    ref = native.encode_symbols(data, 64)
    got = encode_device.encode_symbols_hybrid(data, 64)
    assert got.num_symbols == ref.num_symbols
    np.testing.assert_array_equal(got.widths, ref.widths)
    np.testing.assert_array_equal(got.code_bytes, ref.code_bytes)
    np.testing.assert_array_equal(got.block_offsets, ref.block_offsets)


def test_hybrid_rejects_non_64_block():
    with pytest.raises(ValueError):
        encode_device.encode_symbols_hybrid(
            np.zeros(32, np.uint8), block_size=16)


def test_hybrid_sub_block_input_falls_back():
    data = np.arange(40, dtype=np.uint8)  # < one block: host path
    ref = native.encode_symbols(data, 64)
    got = encode_device.encode_symbols_hybrid(data, 64)
    np.testing.assert_array_equal(got.code_bytes, ref.code_bytes)


def test_merge_rows_matches_encoder():
    # feed merge_rows rows packed by the NumPy reference packer directly
    rng = np.random.default_rng(11)
    data = rng.choice(np.arange(16), size=64 * 37,
                      p=(p := 0.7 ** np.arange(16)) / p.sum()).astype(np.uint8)
    ref = native.encode_symbols(data, 64)
    widths = ref.widths
    codes = canonical.canonical_codes(widths)
    n_blocks = data.size // 64
    bits_pb = widths[data].reshape(n_blocks, 64).astype(np.uint32).sum(
        axis=1, dtype=np.uint32)
    row_words = int(bits_pb.max()) // 32 + 2
    rows = np.zeros((n_blocks, row_words), np.uint32)
    for b in range(n_blocks):
        packed, _ = bitstream.pack_bits(data[b * 64:(b + 1) * 64], codes, widths)
        w = bitstream.bytes_to_be_words(packed, pad_words=2)[:row_words]
        rows[b, : w.size] = w
    code, offsets, total_bits = native.merge_rows(rows, bits_pb)
    np.testing.assert_array_equal(code, ref.code_bytes)
    np.testing.assert_array_equal(offsets, ref.block_offsets)
    assert total_bits == int(bits_pb.astype(np.int64).sum())


def test_pack_rows_matches_reference_packer():
    """Stage 1 alone: each row is the block's MSB-first packed bits (the
    NumPy packer's words) and word ``wmax`` its bit count."""
    rng = np.random.default_rng(19)
    data = rng.choice(np.arange(30), size=64 * 21,
                      p=(p := 0.75 ** np.arange(30)) / p.sum()).astype(np.uint8)
    widths = native.code_lengths(np.bincount(data, minlength=256).astype(np.int64))
    codes = canonical.canonical_codes(widths)
    bits_pb = widths[data].reshape(-1, 64).astype(np.int64).sum(axis=1)
    wmax = int(bits_pb.max()) // 32 + 2
    lo, hi = encode_device.used_width_band(widths)
    out = np.asarray(encode_device.pack_rows(
        data.reshape(-1, 64), codes.astype(np.int32), widths.astype(np.int32),
        wmax=wmax, min_w=lo, max_w=hi))
    assert out.shape == (21, wmax + 1)
    np.testing.assert_array_equal(out[:, wmax], bits_pb)
    for b in range(21):
        packed, _ = bitstream.pack_bits(data[b * 64:(b + 1) * 64], codes, widths)
        ref = bitstream.bytes_to_be_words(packed, pad_words=wmax)[:wmax]
        np.testing.assert_array_equal(out[b, :wmax].view(np.uint32), ref)


def test_merge_rows_thread_count_invariance():
    rng = np.random.default_rng(13)
    data = rng.integers(0, 256, 64 * 400, np.uint8)
    ref = native.encode_symbols(data, 64)
    got1 = encode_device.encode_symbols_hybrid(data, 64, n_threads=1)
    got8 = encode_device.encode_symbols_hybrid(data, 64, n_threads=8)
    np.testing.assert_array_equal(got1.code_bytes, ref.code_bytes)
    np.testing.assert_array_equal(got8.code_bytes, ref.code_bytes)


@pytest.mark.skipif(not native.available(), reason="needs the C++ library")
def test_merge_rows_numpy_fallback_matches_native(monkeypatch):
    rng = np.random.default_rng(17)
    data = rng.choice(np.arange(48), size=64 * 61,
                      p=(p := 0.8 ** np.arange(48)) / p.sum()).astype(np.uint8)
    widths = native.code_lengths(np.bincount(data, minlength=256).astype(np.int64))
    codes = canonical.canonical_codes(widths)
    n_blocks = data.size // 64
    bits_pb = widths[data].reshape(n_blocks, 64).astype(np.uint32).sum(
        axis=1, dtype=np.uint32)
    row_words = int(bits_pb.max()) // 32 + 2
    rows = np.zeros((n_blocks, row_words), np.uint32)
    for b in range(n_blocks):
        packed, _ = bitstream.pack_bits(data[b * 64:(b + 1) * 64], codes, widths)
        w = bitstream.bytes_to_be_words(packed, pad_words=2)[:row_words]
        rows[b, : w.size] = w
    native_out = native.merge_rows(rows, bits_pb)
    monkeypatch.setattr(native, "_lib", lambda: None)
    np_out = native.merge_rows(rows, bits_pb)
    np.testing.assert_array_equal(np_out[0], native_out[0])
    np.testing.assert_array_equal(np_out[1], native_out[1])
    assert np_out[2] == native_out[2]


@pytest.mark.skipif(not native.available(), reason="needs the C++ library")
def test_merge_rows_row_too_short():
    rows = np.zeros((2, 1), np.uint32)
    with pytest.raises(RuntimeError):
        native.merge_rows(rows, np.array([40, 40], np.uint32))

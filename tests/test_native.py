"""Differential tests: C++ native codec vs the NumPy mirror (bit-identical)."""

import numpy as np
import pytest

from metalhuffman import native
from metalhuffman.core import bitstream, canonical, decode_ref, delta, encode, tables

pytestmark = pytest.mark.skipif(
    not native.available(), reason=f"native build unavailable: {native.backend_name()}"
)


def _datasets():
    rng = np.random.default_rng(42)
    yield "uniform", rng.integers(0, 256, 64 * 200, np.uint8)
    yield "skewed", rng.choice(
        np.arange(200), size=64 * 300, p=(p := 0.6 ** np.arange(200)) / p.sum()
    ).astype(np.uint8)
    yield "constant", np.full(64 * 10, 9, np.uint8)
    yield "two", np.tile(np.array([3, 200], np.uint8), 64 * 8)
    yield "sparse", np.where(
        rng.random(64 * 100) < 0.97, 0, rng.integers(1, 256, 64 * 100)
    ).astype(np.uint8)
    # Adversarial: exponential frequencies force >16-bit optimal codes,
    # exercising package-merge length limiting in both implementations.
    counts = [2**i for i in range(24)]
    adv = np.concatenate([np.full(c, i, np.uint8) for i, c in enumerate(counts)])
    yield "adversarial", adv[: (adv.size // 64) * 64]


@pytest.mark.parametrize("name,data", list(_datasets()), ids=lambda v: v if isinstance(v, str) else "")
def test_code_lengths_match(name, data):
    freqs = canonical.symbol_frequencies(data)
    np.testing.assert_array_equal(
        native.code_lengths(freqs), canonical.huffman_code_lengths(freqs)
    )


@pytest.mark.parametrize("name,data", list(_datasets()), ids=lambda v: v if isinstance(v, str) else "")
def test_encode_streams_identical(name, data):
    enc_np = encode.encode_symbols(data, block_size=64)
    enc_cc = native.encode_symbols(data, block_size=64)
    np.testing.assert_array_equal(enc_cc.widths, enc_np.widths)
    np.testing.assert_array_equal(enc_cc.code_bytes, enc_np.code_bytes)
    np.testing.assert_array_equal(enc_cc.block_offsets, enc_np.block_offsets)
    assert enc_cc.num_symbols == enc_np.num_symbols


def test_canonical_codes_match():
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, 4096, np.uint8)
    w = canonical.huffman_code_lengths(canonical.symbol_frequencies(data))
    np.testing.assert_array_equal(
        native.canonical_codes(w), canonical.canonical_codes(w)
    )


def test_native_decode_serial_roundtrip():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, 64 * 64, np.uint8)
    enc = native.encode_symbols(data, block_size=64)
    out = native.decode_serial(enc.code_bytes, enc.widths, data.size)
    np.testing.assert_array_equal(out, data)
    # and from a mid-stream block offset
    b = 17
    out_b = native.decode_serial(
        enc.code_bytes, enc.widths, 64, start_bit=int(enc.block_offsets[b])
    )
    np.testing.assert_array_equal(out_b, data[b * 64 : (b + 1) * 64])


def test_native_decode_matches_numpy_oracle():
    rng = np.random.default_rng(6)
    data = rng.choice([0, 1, 2, 5, 250], size=2048, p=[0.6, 0.2, 0.1, 0.07, 0.03]).astype(np.uint8)
    enc = native.encode_symbols(data, block_size=64)
    sym, w = tables.build_single_table(enc.widths)
    oracle = decode_ref.decode_single_table(enc.code_bytes, sym, w, data.size)
    np.testing.assert_array_equal(
        native.decode_serial(enc.code_bytes, enc.widths, data.size), oracle
    )


def test_delta_match():
    rng = np.random.default_rng(7)
    data = rng.integers(0, 256, 64 * 33, np.uint8)
    enc_cc = native.delta_encode(data, 64)
    enc_np = delta.delta_encode_blocks(data.reshape(-1, 64)).ravel()
    np.testing.assert_array_equal(enc_cc, enc_np)
    np.testing.assert_array_equal(native.delta_decode(enc_cc, 64), data)


@pytest.mark.parametrize("n_threads", [2, 3, 4, 8])
def test_mt_encode_identical_to_serial(n_threads):
    rng = np.random.default_rng(100 + n_threads)
    data = rng.integers(0, 200, 64 * 513 + 17, np.uint8)  # odd tail
    enc1 = native.encode_symbols(data, 64, n_threads=1)
    encm = native.encode_symbols(data, 64, n_threads=n_threads)
    np.testing.assert_array_equal(encm.widths, enc1.widths)
    np.testing.assert_array_equal(encm.code_bytes, enc1.code_bytes)
    np.testing.assert_array_equal(encm.block_offsets, enc1.block_offsets)


@pytest.mark.parametrize("n_threads", [16, 32])
def test_mt_codec_many_threads_identical(n_threads):
    """Byte-identity far beyond this box's core count (threads > cores =
    more seams than parallelism): the chunking is thread-count-driven, so
    a 16/32-way run exercises every head-byte seam/range-split path a
    many-core host would take. Scaling itself is documented in PERF.md
    (~per-core GB/s; each thread owns a disjoint byte range)."""
    rng = np.random.default_rng(200 + n_threads)
    raw = rng.integers(0, 256, 64 * 2029, np.uint8)  # prime block count
    data = native.delta_encode(raw, 64)
    enc1 = native.encode_symbols(data, 64, n_threads=1)
    encm = native.encode_symbols(data, 64, n_threads=n_threads)
    np.testing.assert_array_equal(encm.widths, enc1.widths)
    np.testing.assert_array_equal(encm.code_bytes, enc1.code_bytes)
    np.testing.assert_array_equal(encm.block_offsets, enc1.block_offsets)
    out1 = native.decode_blocks(enc1, n_threads=1)
    outm = native.decode_blocks(encm, n_threads=n_threads)
    np.testing.assert_array_equal(outm, out1)
    np.testing.assert_array_equal(outm.ravel(), raw)


@pytest.mark.parametrize("n_threads", [2, 4, 16])
def test_fixed_table_encode_mt_identical(n_threads):
    """encode_symbols(widths=...) rides the MT machinery (round-3 advisor:
    the old serial-only path single-threaded width-clustered encodes);
    output must be byte-identical for any thread count AND identical to
    the default encoder when given that encoder's own table."""
    from metalhuffman.core import canonical

    rng = np.random.default_rng(300 + n_threads)
    syms = (rng.normal(0, 12, 64 * 1511) % 256).astype(np.uint8)
    freqs = np.bincount(syms, minlength=256).astype(np.int64)
    cw = canonical.cluster_widths(freqs, 6)
    f1 = native.encode_symbols(syms, widths=cw, n_threads=1)
    fm = native.encode_symbols(syms, widths=cw, n_threads=n_threads)
    np.testing.assert_array_equal(fm.code_bytes, f1.code_bytes)
    np.testing.assert_array_equal(fm.block_offsets, f1.block_offsets)
    np.testing.assert_array_equal(
        native.decode_blocks(fm, delta=False).ravel(), syms)
    # given the default path's own table, byte-identical to the default
    auto = native.encode_symbols(syms, n_threads=n_threads)
    fixed = native.encode_symbols(syms, widths=auto.widths,
                                  n_threads=n_threads)
    np.testing.assert_array_equal(fixed.code_bytes, auto.code_bytes)
    np.testing.assert_array_equal(fixed.block_offsets, auto.block_offsets)


def test_mt_encode_small_inputs():
    rng = np.random.default_rng(7)
    for n in (1, 63, 64, 65, 130):
        data = rng.integers(0, 8, n, np.uint8)
        enc1 = native.encode_symbols(data, 64, n_threads=1)
        encm = native.encode_symbols(data, 64, n_threads=8)
        np.testing.assert_array_equal(encm.code_bytes, enc1.code_bytes)


@pytest.mark.parametrize("use_delta", [True, False])
def test_parallel_host_decode(use_delta):
    rng = np.random.default_rng(9)
    raw = rng.integers(0, 256, 64 * 300, np.uint8)
    payload = native.delta_encode(raw, 64) if use_delta else raw
    enc = native.encode_symbols(payload, 64)
    out = native.decode_blocks(enc, delta=use_delta, n_threads=4)
    np.testing.assert_array_equal(out.ravel(), raw)


@pytest.mark.parametrize("name,data", list(_datasets()), ids=lambda v: v if isinstance(v, str) else "")
def test_split_tables_match_numpy(name, data):
    # native mirror of the reference's preferred table structure
    # (HuffmanUtil.cpp:338-667) vs core/tables.py, all planes bit-identical
    w = canonical.huffman_code_lengths(canonical.symbol_frequencies(data))
    t_np = tables.build_split_tables(w, 8, 8)
    t_cc = native.build_split_tables(w, 8, 8)
    np.testing.assert_array_equal(t_cc.t1_symbol, t_np.t1_symbol)
    np.testing.assert_array_equal(t_cc.t1_width, t_np.t1_width)
    np.testing.assert_array_equal(t_cc.t2_symbol, t_np.t2_symbol)
    np.testing.assert_array_equal(t_cc.t2_width, t_np.t2_width)
    assert t_cc.num_t2_tables == t_np.num_t2_tables


@pytest.mark.parametrize("name,data", list(_datasets()), ids=lambda v: v if isinstance(v, str) else "")
def test_native_split_decode_matches_oracle(name, data):
    # native mirror of decodeHuffmanBitsFromTables (HuffmanUtil.cpp:830-1046)
    # vs the NumPy split-table oracle, plus mid-stream block-offset entry
    enc = native.encode_symbols(data, block_size=64)
    t = tables.build_split_tables(enc.widths, 8, 8)
    oracle = decode_ref.decode_split_tables(enc.code_bytes, t, data.size)
    out = native.decode_serial_split(enc.code_bytes, enc.widths, data.size)
    np.testing.assert_array_equal(out, oracle)
    np.testing.assert_array_equal(out, data)
    if enc.block_offsets.size > 3:
        b = enc.block_offsets.size // 2
        out_b = native.decode_serial_split(
            enc.code_bytes, enc.widths, 64,
            start_bit=int(enc.block_offsets[b]))
        np.testing.assert_array_equal(out_b, data[b * 64 : (b + 1) * 64])


def test_native_split_decode_long_codes_escape():
    # skewed data guarantees widths > 8 -> the T2 escape path is exercised
    rng = np.random.default_rng(11)
    p = 0.6 ** np.arange(200)
    data = rng.choice(np.arange(200), size=64 * 64, p=p / p.sum()).astype(np.uint8)
    enc = native.encode_symbols(data, block_size=64)
    assert enc.widths.max() > 8
    out = native.decode_serial_split(enc.code_bytes, enc.widths, data.size)
    np.testing.assert_array_equal(out, data)


@pytest.mark.parametrize("name,data", list(_datasets()), ids=lambda v: v if isinstance(v, str) else "")
def test_symbol_bit_offsets_match(name, data):
    # native mirror of HuffmanEncoder::lookupBufferBitOffsets
    # (HuffmanEncoder.cpp:383-395): per-symbol offsets, not just block roots
    enc = native.encode_symbols(data, block_size=64)
    offs_cc = native.symbol_bit_offsets(data, enc.widths)
    offs_np = bitstream.symbol_bit_offsets(data, enc.widths)
    np.testing.assert_array_equal(offs_cc, offs_np)
    # block roots are every 64th per-symbol offset
    np.testing.assert_array_equal(
        offs_cc[: enc.block_offsets.size * 64 : 64].astype(np.uint32),
        enc.block_offsets,
    )


def test_encode_speed_sanity():
    # Native encode of ~3 MB must be far faster than the NumPy path.
    import time

    rng = np.random.default_rng(8)
    data = rng.integers(0, 64, 3_145_728, np.uint8)
    t0 = time.perf_counter()
    native.encode_symbols(data, block_size=64)
    dt = time.perf_counter() - t0
    assert dt < 2.0, f"native encode too slow: {dt:.2f}s"


def test_delta2d_transform_matches_numpy():
    # native mirror of core.delta.delta2d_* (container modes 3/4)
    rng = np.random.default_rng(21)
    for bd in (4, 8, 16):
        data = rng.integers(0, 256, bd * bd * 37, np.uint8)
        enc_cc = native.delta2d_encode(data, bd)
        enc_np = delta.delta2d_encode_blocks(
            data.reshape(-1, bd * bd), bd).ravel()
        np.testing.assert_array_equal(enc_cc, enc_np)
        np.testing.assert_array_equal(native.delta2d_decode(enc_cc, bd), data)
    with pytest.raises(ValueError):
        native.delta2d_encode(np.zeros(63, np.uint8), 8)


def test_decode_blocks_delta2d_mode():
    # mode 2: the 2-D reconstruction runs inside the C++ per-block loop
    rng = np.random.default_rng(22)
    img = np.cumsum(rng.normal(0, 6, (40, 48)), axis=0)
    img = (img - img.min()).clip(0, 255).astype(np.uint8)
    from metalhuffman.core import blocks as blocks_mod

    blk = blocks_mod.image_to_blocks(img)
    enc = native.encode_symbols(native.delta2d_encode(blk.ravel(), 8),
                                block_size=64)
    out = native.decode_blocks(enc, delta=False, delta2d=True)
    np.testing.assert_array_equal(out, blk)
    # non-square block_size must fail loudly
    enc36 = native.encode_symbols(
        rng.integers(0, 8, 36 * 4, np.uint8), block_size=36)
    try:
        got = native.decode_blocks(enc36, delta=False, delta2d=True,
                                   block_size=36)
        np.testing.assert_array_equal(  # 36 = 6x6 IS square — decodes fine
            got.shape, (4, 36))
    except RuntimeError:
        pytest.fail("6x6 blocks are square; mode 2 should decode")
    enc48 = native.encode_symbols(
        rng.integers(0, 8, 48 * 4, np.uint8), block_size=48)
    with pytest.raises(RuntimeError):
        native.decode_blocks(enc48, delta=False, delta2d=True, block_size=48)

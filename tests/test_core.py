"""Unit tests for the NumPy codec core.

Mirrors the reference's inline DEBUG oracles (SURVEY.md section 4 tier 2):
canonical-code uniqueness/prefix-freeness (``huff_util.hpp:179-190``), LUT
full-coverage and no-overlap invariants (``HuffmanUtil.cpp:215-219,234-262``),
delta roundtrip (``AAPLRenderer.m:477-497``), and encode->decode memcmp
(``AAPLRenderer.m:616-650``).
"""

import numpy as np
import pytest

from metalhuffman.core import (
    bitstream,
    blocks,
    canonical,
    container,
    decode_ref,
    delta,
    encode_symbols,
    tables,
)


def _streams():
    rng = np.random.default_rng(42)
    return {
        "two_symbol": rng.choice([0, 255], size=1000).astype(np.uint8),
        "single_symbol": np.full(500, 7, dtype=np.uint8),
        "uniform_random": rng.integers(0, 256, size=4096).astype(np.uint8),
        "skewed": rng.choice(
            [0, 1, 2, 3, 40, 200], size=5000, p=[0.7, 0.1, 0.1, 0.05, 0.03, 0.02]
        ).astype(np.uint8),
        "ascending": (np.arange(4096) % 256).astype(np.uint8),
        "sparse_zeros": np.where(
            rng.random(4096) < 0.99, 0, rng.integers(1, 256, 4096)
        ).astype(np.uint8),
    }


STREAMS = _streams()


@pytest.fixture(params=sorted(STREAMS), ids=sorted(STREAMS))
def stream(request):
    return STREAMS[request.param]


class TestCanonical:
    def test_lengths_are_optimal_for_known_case(self):
        freqs = np.zeros(256, dtype=np.int64)
        # classic example: a=45 b=13 c=12 d=16 e=9 f=5 -> lengths 1,3,3,3,4,4
        for s, f in enumerate([45, 13, 12, 16, 9, 5]):
            freqs[s] = f
        w = canonical.huffman_code_lengths(freqs)
        assert sorted(w[w > 0]) == [1, 3, 3, 3, 4, 4]

    def test_single_symbol_gets_one_bit(self):
        freqs = np.zeros(256, dtype=np.int64)
        freqs[7] = 1000
        w = canonical.huffman_code_lengths(freqs)
        assert w[7] == 1 and w.sum() == 1

    def test_total_bits_matches_entropy_bound(self, stream):
        freqs = canonical.symbol_frequencies(stream)
        w = canonical.huffman_code_lengths(freqs)
        total = int((freqs * w.astype(np.int64)).sum())
        p = freqs[freqs > 0] / freqs.sum()
        entropy_bits = float(-(p * np.log2(p)).sum() * freqs.sum())
        assert total >= entropy_bits - 1e-6
        assert total <= entropy_bits + freqs.sum()  # H <= L < H+1 per symbol

    def test_kraft_validity(self, stream):
        freqs = canonical.symbol_frequencies(stream)
        w = canonical.huffman_code_lengths(freqs)
        canonical.validate_widths(w)

    def test_length_limit_engages(self):
        # Fibonacci-like frequencies force a deep optimal tree (> 16 levels).
        freqs = np.zeros(256, dtype=np.int64)
        a, b = 1, 1
        for s in range(30):
            freqs[s] = a
            a, b = b, a + b
        w = canonical.huffman_code_lengths(freqs)
        assert 0 < w[w > 0].max() <= 16
        canonical.validate_widths(w)

    def test_codes_are_prefix_free_and_unique(self, stream):
        freqs = canonical.symbol_frequencies(stream)
        w = canonical.huffman_code_lengths(freqs)
        codes = canonical.canonical_codes(w)
        active = np.nonzero(w)[0]
        if len(active) < 2:
            return
        # mirror of huff_util.hpp:179-190 plus a full prefix-freeness check
        seen = set()
        for s in active:
            c = int(codes[s])
            assert c not in seen or c == 0
            seen.add(c)
        for s1 in active:
            for s2 in active:
                if s1 == s2:
                    continue
                w1, c1 = int(w[s1]), int(codes[s1])
                c2 = int(codes[s2])
                assert (c2 >> (16 - w1)) != (c1 >> (16 - w1)) or int(w[s2]) < w1

    def test_canonical_assignment_matches_reference_example(self):
        # Worked example from huff_util.hpp:78-92.
        w = np.zeros(256, dtype=np.uint8)
        w[97] = 1
        w[98] = w[100] = w[114] = 3
        w[10] = w[99] = 4
        codes = canonical.canonical_codes(w)
        # right-justified codes 0, 100, 101, 110, 1110, 1111 — left-justified
        assert codes[97] == 0b0000000000000000
        assert codes[98] == 0b1000000000000000  # "100" in the top 3 bits
        assert codes[100] == 0b1010000000000000
        assert codes[114] == 0b1100000000000000
        assert codes[10] == 0b1110000000000000
        assert codes[99] == 0b1111000000000000


class TestBitstream:
    def test_pack_known_pattern(self):
        w = np.zeros(256, dtype=np.uint8)
        w[0] = 1
        w[1] = 2
        w[2] = 2
        # canonical: 0->0, 1->10, 2->11
        codes = canonical.canonical_codes(w)
        packed, offs = bitstream.pack_bits(
            np.array([0, 1, 2, 0], dtype=np.uint8), codes, w
        )
        # bits: 0 10 11 0 -> 010110 -> byte 0b01011000
        assert packed[0] == 0b01011000
        assert list(offs) == [0, 1, 3, 5, 6]
        assert packed.size == 1 + bitstream.READ_AHEAD_PAD_BYTES

    def test_block_offsets(self, stream):
        enc = encode_symbols(stream, block_size=64)
        offs = enc.block_offsets
        assert offs.size == stream.size // 64
        assert offs[0] == 0
        assert np.all(np.diff(offs.astype(np.int64)) > 0)

    def test_be_words_roundtrip_bits(self):
        rng = np.random.default_rng(0)
        raw = rng.integers(0, 256, size=37, dtype=np.uint8)
        words = bitstream.bytes_to_be_words(raw)
        for bit in [0, 5, 8, 31, 32, 63, 100, 37 * 8 - 1]:
            wi, sh = bit >> 5, bit & 31
            got = (int(words[wi]) >> (31 - sh)) & 1
            assert got == bitstream.unpack_bit(raw, bit)


class TestTables:
    def test_single_table_full_coverage(self, stream):
        freqs = canonical.symbol_frequencies(stream)
        w = canonical.huffman_code_lengths(freqs)
        sym, wp = tables.build_single_table(w)
        if np.count_nonzero(w) > 1:
            # Full coverage (HuffmanUtil.cpp:234-262): every window decodes.
            assert np.all(wp > 0)
        assert sym.size == wp.size == 65536

    def test_split_tables_agree_with_single(self, stream):
        freqs = canonical.symbol_frequencies(stream)
        w = canonical.huffman_code_lengths(freqs)
        sym, wp = tables.build_single_table(w)
        st = tables.build_split_tables(w)
        # Every 16-bit window must resolve to the same (symbol, width).
        windows = np.arange(65536)
        hi = windows >> 8
        lo = windows & 0xFF
        t1s = st.t1_symbol[hi].astype(np.int64)
        t1w = st.t1_width[hi].astype(np.int64)
        esc = t1w == 0
        # non-escape lanes read T2 slot 0 (reserved all-zero table)
        t2_idx = np.where(esc, (t1s << 8) | lo, 0)
        s2 = st.t2_symbol[t2_idx]
        w2 = st.t2_width[t2_idx]
        got_s = np.where(esc, s2, t1s)
        got_w = np.where(esc, w2, t1w)
        active_windows = wp > 0
        assert np.array_equal(got_s[active_windows], sym[active_windows])
        assert np.array_equal(got_w[active_windows], wp[active_windows])

    def test_t2_slot0_reserved(self, stream):
        freqs = canonical.symbol_frequencies(stream)
        w = canonical.huffman_code_lengths(freqs)
        st = tables.build_split_tables(w)
        # Reference HuffmanUtil.cpp:550-556: first secondary table is all zeros.
        assert np.all(st.t2_symbol[:256] == 0)
        assert np.all(st.t2_width[:256] == 0)

    def test_pack_unpack_entries(self):
        s = np.array([0, 255, 17], dtype=np.uint8)
        w = np.array([1, 16, 9], dtype=np.uint8)
        packed = tables.pack_entries(s, w)
        s2, w2 = tables.unpack_entry(packed)
        assert np.array_equal(s2, s) and np.array_equal(w2, w)


class TestDecodeRef:
    def test_roundtrip_both_table_kinds(self, stream):
        enc = encode_symbols(stream)
        sym, wp = tables.build_single_table(enc.widths)
        out1 = decode_ref.decode_single_table(
            enc.code_bytes, sym, wp, enc.num_symbols
        )
        assert np.array_equal(out1, stream)
        st = tables.build_split_tables(enc.widths)
        out2 = decode_ref.decode_split_tables(enc.code_bytes, st, enc.num_symbols)
        assert np.array_equal(out2, stream)

    def test_decode_from_block_offset(self):
        data = STREAMS["skewed"][:256]
        enc = encode_symbols(data, block_size=64)
        st = tables.build_split_tables(enc.widths)
        for b, off in enumerate(enc.block_offsets):
            out = decode_ref.decode_split_tables(
                enc.code_bytes, st, 64, start_bit=int(off)
            )
            assert np.array_equal(out, data[b * 64 : (b + 1) * 64])


class TestDelta:
    def test_roundtrip(self, stream):
        n = (stream.size // 64) * 64
        b = stream[:n].reshape(-1, 64)
        assert np.array_equal(delta.delta_decode_blocks(delta.delta_encode_blocks(b)), b)

    def test_known_values(self):
        b = np.array([[10, 20, 15, 15]], dtype=np.uint8)
        d = delta.delta_encode_blocks(b)
        assert list(d[0]) == [10, 10, 251, 0]  # -5 wraps to 251


class TestBlocks:
    @pytest.mark.parametrize(
        "h,w", [(4, 4), (4, 8), (2, 8), (6, 4), (8, 8), (16, 16), (13, 17), (1, 1)]
    )
    def test_roundtrip(self, h, w):
        rng = np.random.default_rng(h * 100 + w)
        img = rng.integers(0, 256, size=(h, w), dtype=np.uint8)
        blk = blocks.image_to_blocks(img)
        assert blk.shape[1] == 64
        back = blocks.blocks_to_image(blk, h, w)
        assert np.array_equal(back, img)

    def test_zero_padding(self):
        img = np.full((3, 3), 9, dtype=np.uint8)
        blk = blocks.image_to_blocks(img)
        assert blk.shape == (1, 64)
        assert blk.sum() == 9 * 9  # everything else zero-padded

    def test_block_order_matches_raster(self):
        # 16x16 -> 4 blocks in raster block order, each row-major inside.
        img = np.arange(256, dtype=np.uint8).reshape(16, 16)
        blk = blocks.image_to_blocks(img)
        assert blk[0, 0] == img[0, 0]
        assert blk[1, 0] == img[0, 8]
        assert blk[2, 0] == img[8, 0]
        assert blk[0, 9] == img[1, 1]


class TestContainer:
    def test_core_blob_roundtrip(self, stream):
        enc = encode_symbols(stream)
        blob = enc.core_blob()
        assert blob[:4] == bytes([0xDD, 0xEE, 0xEE, 0xFF])  # LE magic
        n, widths, code_bytes = container.parse_core_blob(blob)
        assert n == stream.size
        assert np.array_equal(widths, enc.widths)
        assert np.array_equal(code_bytes, enc.code_bytes)
        assert enc.compressed_size == len(blob)

    def test_disk_frame_roundtrip(self, stream):
        enc = encode_symbols(stream)
        data = container.write_frame(enc, 32, 48, 8, True)
        s2, h, w, bd, d, _crc = container.read_frame(data)
        assert (h, w, bd, d) == (32, 48, 8, True)
        assert s2.num_symbols == enc.num_symbols
        assert np.array_equal(s2.code_bytes, enc.code_bytes)
        assert np.array_equal(s2.block_offsets, enc.block_offsets)

    def test_legacy_precrc_header_reads(self, stream):
        # Early round-1 containers used the same MHT1 magic but no CRC field
        # (core_len at offset 18). read_frame must detect and parse them.
        import struct

        enc = encode_symbols(stream)
        core = enc.core_blob()
        legacy = (
            container.DISK_MAGIC
            + struct.pack("<IIIBB", 32, 48, enc.block_offsets.size, 8, 1)
            + struct.pack("<I", len(core))
            + core
            + enc.block_offsets.astype("<u4").tobytes()
        )
        s2, h, w, bd, d, crc = container.read_frame(legacy)
        assert (h, w, bd, d, crc) == (32, 48, 8, True, 0)
        assert np.array_equal(s2.code_bytes, enc.code_bytes)
        assert np.array_equal(s2.block_offsets, enc.block_offsets)

    def test_unrecognized_header_layout_raises(self):
        bad = container.DISK_MAGIC + b"\x00" * 40
        with pytest.raises(ValueError, match="header layout"):
            container.read_frame(bad)

    def test_trailing_pad_bytes_present(self, stream):
        enc = encode_symbols(stream)
        assert enc.code_bytes[-1] == 0 and enc.code_bytes[-2] == 0


# -- width clustering (round 3: decode compare-chain length trade) --------------


def test_cluster_widths_complete_and_bounded():
    from metalhuffman.core import canonical

    rng = np.random.default_rng(0)
    # photo-like geometric delta distribution: many distinct widths
    syms = np.clip(rng.normal(0, 12, 200_000), -127, 127).astype(np.int16)
    freqs = np.bincount(syms.astype(np.uint8), minlength=256).astype(np.int64)
    opt = canonical.huffman_code_lengths(freqs)
    active = np.nonzero(freqs)[0]
    assert np.unique(opt[active]).size > 6  # the premise
    for k in (4, 5, 6):
        cw = canonical.cluster_widths(freqs, k)
        canonical.validate_widths(cw)  # complete prefix code (Kraft equality)
        assert np.unique(cw[active]).size <= k
        assert (cw[active] > 0).all()
        bits_o = int((freqs * opt.astype(np.int64)).sum())
        bits_c = int((freqs * cw.astype(np.int64)).sum())
        assert bits_c >= bits_o  # never better than optimal
        assert bits_c < 1.25 * bits_o, (k, bits_c / bits_o)
    # already-few-widths tables come back unchanged
    f2 = np.zeros(256, np.int64)
    f2[:4] = [100, 50, 25, 25]
    assert np.array_equal(canonical.cluster_widths(f2, 6),
                          canonical.huffman_code_lengths(f2))


def test_encode_with_fixed_widths_roundtrip():
    from metalhuffman import native
    from metalhuffman.core import canonical

    rng = np.random.default_rng(1)
    syms = (rng.normal(0, 10, 64 * 64) % 256).astype(np.uint8)
    freqs = np.bincount(syms, minlength=256).astype(np.int64)
    cw = canonical.cluster_widths(freqs, 5)
    enc = native.encode_symbols(syms, widths=cw)
    assert np.array_equal(enc.widths, cw)
    dec = native.decode_blocks(enc, delta=False)
    assert np.array_equal(dec.reshape(-1), syms)
    # the stream decodes through the standard device path too (the image
    # decoder reorders blocks into raster positions — compare against the
    # same reorder of the raw block payload)
    from metalhuffman.core import blocks as blocks_mod
    from metalhuffman.core.container import EncodedStream
    from metalhuffman.models import CodecConfig, ImageCodec

    stream = EncodedStream(enc.num_symbols, enc.widths, enc.code_bytes,
                           enc.block_offsets)
    codec = ImageCodec(CodecConfig(backend="xla", delta=False))
    out = np.asarray(codec.decode_step(codec.prepare(stream, 64, 64)))
    want = blocks_mod.blocks_to_image(syms.reshape(-1, 64), 64, 64, 8)
    assert np.array_equal(out, want)
    # a table not covering a present symbol errors cleanly
    bad = cw.copy()
    bad[int(syms[0])] = 0
    with pytest.raises(ValueError):
        native.encode_symbols(syms, widths=bad)


def test_cluster_widths_fuzz():
    # many random shapes of frequency distribution: the result must always
    # be a complete prefix code with <= k distinct lengths covering every
    # present symbol
    from metalhuffman.core import canonical

    rng = np.random.default_rng(42)
    for trial in range(30):
        n_sym = int(rng.integers(2, 257))
        kind = trial % 3
        if kind == 0:  # geometric-ish
            f = np.floor(1e6 * 0.7 ** np.arange(n_sym)).astype(np.int64) + 1
        elif kind == 1:  # uniform-ish with jitter
            f = rng.integers(1, 1000, n_sym).astype(np.int64)
        else:  # heavy head + long rare tail
            f = np.concatenate([[10**6], rng.integers(1, 5, n_sym - 1)])
        syms = rng.choice(256, size=n_sym, replace=False)
        freqs = np.zeros(256, np.int64)
        freqs[syms] = f
        k = int(rng.integers(3, 7))
        cw = canonical.cluster_widths(freqs, k)
        canonical.validate_widths(cw)
        assert (cw[syms] > 0).all(), trial
        assert np.unique(cw[syms]).size <= max(
            k, np.unique(canonical.huffman_code_lengths(freqs)[syms]).size)


def test_crc32_combine_matches_zlib():
    import zlib

    from metalhuffman.core.crc import crc32_combine, crc32_concat

    rng = np.random.default_rng(11)
    for _ in range(25):
        a = rng.integers(0, 256, int(rng.integers(0, 4000)), np.uint8).tobytes()
        b = rng.integers(0, 256, int(rng.integers(1, 4000)), np.uint8).tobytes()
        assert crc32_combine(zlib.crc32(a), zlib.crc32(b),
                             len(b)) == zlib.crc32(a + b)
    parts = [rng.integers(0, 256, 64 * (i + 1), np.uint8).tobytes()
             for i in range(6)]
    assert crc32_concat(
        [(zlib.crc32(p), len(p)) for p in parts]) == zlib.crc32(b"".join(parts))

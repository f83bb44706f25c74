"""Debug tooling + seeded fuzz sweep over random symbol distributions."""

import numpy as np
import pytest

from metalhuffman.core import blocks, delta, encode_symbols
from metalhuffman.ops import decode_xla
from metalhuffman.utils import debug


def test_trace_block_matches_decode():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 64, 64 * 8, np.uint8)
    enc = encode_symbols(data, block_size=64)
    tr = debug.trace_block(enc, 3, delta=False)
    assert len(tr) == 64
    assert [t.symbol for t in tr] == list(data[3 * 64 : 4 * 64])
    # offsets are strictly increasing by the reported widths
    for a, b in zip(tr, tr[1:]):
        assert b.bit_offset == a.bit_offset + a.width
    assert tr[0].bit_offset == int(enc.block_offsets[3])
    # patterns parse back to the right bit count
    assert all(len(t.pattern) == t.width for t in tr)


@pytest.mark.parametrize("mode", ["plain", "delta", "zero_init", "delta2d",
                                  "delta2d_zi"])
def test_trace_block_values_are_true_pixels(mode):
    """trace_block honors the full precoder state (1-D/2-D/zero-init):
    the value column equals the actual decoded pixel for every mode."""
    from metalhuffman.models import ImageCodec
    from metalhuffman.models.image_codec import CodecConfig

    rng = np.random.default_rng(99)
    img = np.cumsum(rng.normal(0, 5, (16, 24)), axis=1)
    img = (img - img.min()).clip(0, 255).astype(np.uint8)
    cfg = CodecConfig(
        backend="native",
        delta=mode != "plain",
        zero_init=mode in ("zero_init", "delta2d_zi"),
        delta2d=mode in ("delta2d", "delta2d_zi"),
    )
    stream = ImageCodec(cfg).encode(img)
    bw = 24 // 8
    for y, x in [(0, 0), (0, 8), (8, 16)]:
        b = (y // 8) * bw + x // 8
        tr = debug.trace_block(stream, b, 64, cfg.delta)
        got = np.array([t.value for t in tr], np.uint8).reshape(8, 8)
        np.testing.assert_array_equal(got, img[y:y + 8, x:x + 8])


def test_dump_table_and_summary():
    rng = np.random.default_rng(1)
    enc = encode_symbols(rng.integers(0, 16, 64 * 4, np.uint8))
    s = debug.dump_table(enc.widths)
    assert "sym" in s and "width" in s
    summary = debug.stream_summary(enc)
    assert "blocks=4" in summary


@pytest.mark.slow
def test_deep_fuzz_lengths_and_streams():
    """50 random frequency tables: native == NumPy lengths, streams, roundtrips."""
    from metalhuffman import native
    from metalhuffman.core import canonical, encode as encode_mod, tables

    rng = np.random.default_rng(777)
    for trial in range(50):
        kind = trial % 4
        freqs = np.zeros(256, np.int64)
        if kind == 0:
            sel = rng.choice(256, int(rng.integers(1, 257)), replace=False)
            freqs[sel] = rng.integers(1, 1_000_000, sel.size)
        elif kind == 1:
            n = int(rng.integers(2, 200))
            freqs[:n] = np.maximum(1, (2.0 ** np.arange(n) % 1e9).astype(np.int64))
        elif kind == 2:  # fibonacci: deep optimal trees -> package-merge
            a, b = 1, 1
            for s in range(int(rng.integers(2, 40))):
                freqs[s] = a
                a, b = b, a + b
        else:
            freqs = rng.integers(0, 100, 256).astype(np.int64)
            if freqs.sum() == 0:
                freqs[0] = 1
        w_np = canonical.huffman_code_lengths(freqs)
        np.testing.assert_array_equal(w_np, native.code_lengths(freqs))
        canonical.validate_widths(w_np)
        data = rng.choice(
            np.arange(256), size=640, p=freqs / freqs.sum()).astype(np.uint8)
        e1 = encode_mod.encode_symbols(data, 64)
        e2 = native.encode_symbols(data, 64)
        np.testing.assert_array_equal(e1.code_bytes, e2.code_bytes)
        sym, wp = tables.build_single_table(e1.widths)
        out = decode_ref_decode(e1.code_bytes, sym, wp, 640)
        np.testing.assert_array_equal(out, data)


def decode_ref_decode(code_bytes, sym, wp, n):
    from metalhuffman.core import decode_ref

    return decode_ref.decode_single_table(code_bytes, sym, wp, n)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_pallas_interpret_roundtrip(seed):
    """Random distributions through the Pallas kernel (interpret mode)."""
    from metalhuffman.ops import decode_pallas

    rng = np.random.default_rng(1000 + seed)
    alphabet = int(rng.integers(2, 257))
    p = rng.uniform(0.3, 1.0) ** np.arange(alphabet)
    p /= p.sum()
    data = rng.choice(np.arange(alphabet), size=64 * int(rng.integers(2, 20)),
                      p=p).astype(np.uint8)
    enc = encode_symbols(data, block_size=64)
    out = np.asarray(
        decode_pallas.decode_stream_pallas(enc, delta=False))
    np.testing.assert_array_equal(out.ravel(), data)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_delta2d_images_roundtrip(seed):
    """Random images through the full delta2d pipeline per backend.

    Covers the in-register kernel reconstruction (pallas) and the NumPy
    post-pass (native) against the same random geometry and statistics."""
    from metalhuffman.models import ImageCodec
    from metalhuffman.models.image_codec import CodecConfig

    rng = np.random.default_rng(2000 + seed)
    h = int(rng.integers(9, 120))
    w = int(rng.integers(9, 200))
    smooth = np.cumsum(rng.normal(0, 4, (h, w)), axis=1)
    img = (smooth - smooth.min()).clip(0, 255).astype(np.uint8)
    for backend in ("native", "pallas"):
        cfg = CodecConfig(backend=backend, delta2d=True,
                          zero_init=bool(seed % 2))
        codec = ImageCodec(cfg)
        out = np.asarray(codec.decode(codec.encode(img), h, w))
        np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_random_distributions_roundtrip(seed):
    """Random alphabet sizes/skews through encode -> XLA decode, bit-exact."""
    rng = np.random.default_rng(seed)
    alphabet = int(rng.integers(1, 257))
    skew = float(rng.uniform(0.3, 1.0))
    p = skew ** np.arange(alphabet)
    p /= p.sum()
    n_blocks = int(rng.integers(1, 40))
    data = rng.choice(np.arange(alphabet), size=64 * n_blocks, p=p).astype(np.uint8)
    use_delta = bool(rng.integers(0, 2))
    payload = (
        delta.delta_encode_blocks(data.reshape(-1, 64)).ravel()
        if use_delta else data
    )
    enc = encode_symbols(payload, block_size=64)
    out = np.asarray(decode_xla.decode_stream(enc, delta=use_delta))
    np.testing.assert_array_equal(out.ravel(), data)

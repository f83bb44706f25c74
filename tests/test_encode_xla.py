"""Device-side encoder vs the host encoders (bit-identical streams)."""

import numpy as np
import pytest

from metalhuffman import native
from metalhuffman.core import encode
from metalhuffman.ops import decode_xla, encode_xla


def _datasets():
    rng = np.random.default_rng(21)
    yield "uniform", rng.integers(0, 256, 64 * 100, np.uint8)
    yield "skewed", rng.choice(
        np.arange(100), size=64 * 200, p=(p := 0.7 ** np.arange(100)) / p.sum()
    ).astype(np.uint8)
    yield "constant", np.full(64 * 4, 3, np.uint8)
    yield "gradient", (np.arange(64 * 64) % 251).astype(np.uint8)


@pytest.mark.parametrize(
    "name,data", list(_datasets()), ids=[n for n, _ in _datasets()]
)
def test_device_encode_matches_host(name, data):
    enc_host = encode.encode_symbols(data, block_size=64)
    enc_dev = encode_xla.encode_symbols_device(data, block_size=64)
    np.testing.assert_array_equal(enc_dev.widths, enc_host.widths)
    np.testing.assert_array_equal(enc_dev.code_bytes, enc_host.code_bytes)
    np.testing.assert_array_equal(enc_dev.block_offsets, enc_host.block_offsets)


def test_device_encode_device_decode_roundtrip():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 200, 64 * 77, np.uint8)
    enc = encode_xla.encode_symbols_device(data, block_size=64)
    out = np.asarray(decode_xla.decode_stream(enc, delta=False))
    np.testing.assert_array_equal(out.ravel(), data)


def test_device_encode_matches_native():
    if not native.available():
        pytest.skip("native unavailable")
    rng = np.random.default_rng(4)
    data = rng.integers(0, 256, 64 * 123, np.uint8)
    enc_cc = native.encode_symbols(data, block_size=64)
    enc_dev = encode_xla.encode_symbols_device(data, block_size=64)
    np.testing.assert_array_equal(enc_dev.code_bytes, enc_cc.code_bytes)

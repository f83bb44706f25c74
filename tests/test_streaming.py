"""StreamingDecoder pipeline + native fallback paths."""

import numpy as np

from metalhuffman import native
from metalhuffman.models import CodecConfig, frame_stream


def _frames(t, h, w, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 200, (t, h, w), np.uint8)


def test_streaming_decoder_two_in_flight():
    cfg = CodecConfig(backend="pallas")
    dec = frame_stream.StreamingDecoder(cfg)
    batches = [_frames(2, 16, 1024, s) for s in range(3)]  # image-layout path
    streams = [frame_stream.encode_frames_shared(b, cfg) for b in batches]

    handles = [dec.submit(streams[0], 2, 16, 1024),
               dec.submit(streams[1], 2, 16, 1024)]
    out0 = dec.result(handles.pop(0))
    handles.append(dec.submit(streams[2], 2, 16, 1024))
    out1 = dec.result(handles.pop(0))
    out2 = dec.result(handles.pop(0))
    for out, b in zip([out0, out1, out2], batches):
        np.testing.assert_array_equal(out, b)


def test_streaming_decoder_generic_path():
    cfg = CodecConfig(backend="pallas")
    dec = frame_stream.StreamingDecoder(cfg)
    b = _frames(2, 24, 40, 9)  # width not a multiple of 1024 -> generic path
    s = frame_stream.encode_frames_shared(b, cfg)
    np.testing.assert_array_equal(dec.result(dec.submit(s, 2, 24, 40)), b)


def test_native_fallback_paths(monkeypatch):
    """Force the NumPy fallbacks (as if the C++ build were unavailable)."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_BUILD_ERROR", "forced by test")
    assert not native.available()
    assert "numpy" in native.backend_name()

    rng = np.random.default_rng(3)
    data = rng.integers(0, 64, 64 * 5, np.uint8)
    enc = native.encode_symbols(data, 64)  # numpy path
    out = native.decode_blocks(enc, delta=False)  # numpy oracle path
    np.testing.assert_array_equal(out.ravel(), data)
    np.testing.assert_array_equal(
        native.delta_decode(native.delta_encode(data, 64), 64), data
    )
    freqs = np.bincount(data, minlength=256).astype(np.int64)
    w = native.code_lengths(freqs)
    assert w[w > 0].size > 0
    assert native.canonical_codes(w).shape == (256,)
    out2 = native.decode_serial(enc.code_bytes, enc.widths, data.size)
    np.testing.assert_array_equal(out2, data)

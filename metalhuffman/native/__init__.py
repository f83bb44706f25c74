"""C++ native codec fast path with ctypes bindings.

The reference's codec core is native C++ (``HuffmanEncoder.cpp``,
``HuffmanUtil.cpp``); this package is its counterpart here. The shared
library builds lazily on first use (g++ -O3 into ``.cache/native`` in the
checkout, or ``MHT_CACHE_DIR``) and every entry point falls back to the
NumPy mirror in :mod:`metalhuffman.core` if the toolchain is unavailable — call
:func:`backend_name` to see which implementation is active.

The native and NumPy paths are bit-identical by construction (same tie-break
rules); ``tests/test_native.py`` enforces it differentially.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).parent / "src" / "mht_codec.cpp"
_LIB = None
_BUILD_ERROR: str | None = None


def _cache_dir() -> Path:
    from ..utils import runtime

    if os.environ.get("MHT_CACHE_DIR"):
        p = Path(os.environ["MHT_CACHE_DIR"])
        p.mkdir(parents=True, exist_ok=True)
        return p
    return runtime.cache_dir("native")


def _build() -> ctypes.CDLL | None:
    global _BUILD_ERROR
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = _cache_dir() / f"libmht_codec_{tag}.so"
    if not out.exists():
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [
            "g++", "-O3", "-std=c++17", "-shared", "-fPIC",
            "-o", str(tmp), str(_SRC),
        ]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, out)
        except Exception as e:  # missing g++, compile error, ...
            _BUILD_ERROR = f"{type(e).__name__}: {e}"
            return None
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as e:
        _BUILD_ERROR = str(e)
        return None

    i64 = ctypes.c_int64
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.mht_code_lengths.argtypes = [ctypes.POINTER(i64), u8p]
    lib.mht_canonical_codes.argtypes = [u8p, ctypes.POINTER(ctypes.c_uint16)]
    lib.mht_encode.argtypes = [
        u8p, i64, i64, u8p, u8p, i64, ctypes.POINTER(i64),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(i64),
    ]
    lib.mht_decode_serial.argtypes = [u8p, i64, u8p, i64, i64, u8p]
    lib.mht_delta_encode.argtypes = [u8p, i64, i64, u8p]
    lib.mht_delta_decode.argtypes = [u8p, i64, i64, u8p]
    lib.mht_delta2d_encode.argtypes = [u8p, i64, i64, u8p]
    lib.mht_delta2d_decode.argtypes = [u8p, i64, i64, u8p]
    lib.mht_encode_mt.argtypes = [
        u8p, i64, i64, u8p, u8p, i64, ctypes.POINTER(i64),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(i64), ctypes.c_int,
    ]
    lib.mht_encode_fixed.argtypes = [
        u8p, i64, i64, u8p, u8p, i64, ctypes.POINTER(i64),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(i64), ctypes.c_int,
    ]
    lib.mht_decode_blocks.argtypes = [
        u8p, i64, u8p, ctypes.POINTER(ctypes.c_uint32), i64, i64,
        ctypes.c_int, u8p, ctypes.c_int,
    ]
    lib.mht_build_split_tables.argtypes = [
        u8p, ctypes.c_int, u8p, u8p, u8p, u8p, i64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.mht_decode_serial_split.argtypes = [
        u8p, i64, u8p, i64, i64, ctypes.c_int, u8p,
    ]
    lib.mht_symbol_bit_offsets.argtypes = [
        u8p, i64, u8p, ctypes.POINTER(ctypes.c_uint64),
    ]
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.mht_merge_rows.argtypes = [
        u32p, u32p, i64, i64, u8p, i64, ctypes.POINTER(i64), u32p,
        ctypes.POINTER(i64), ctypes.c_int,
    ]
    for fn in (
        lib.mht_code_lengths, lib.mht_canonical_codes, lib.mht_encode,
        lib.mht_decode_serial, lib.mht_delta_encode, lib.mht_delta_decode,
        lib.mht_delta2d_encode, lib.mht_delta2d_decode,
        lib.mht_encode_mt, lib.mht_encode_fixed,
        lib.mht_decode_blocks, lib.mht_build_split_tables,
        lib.mht_decode_serial_split, lib.mht_symbol_bit_offsets,
        lib.mht_merge_rows,
    ):
        fn.restype = ctypes.c_int
    return lib


def _lib() -> ctypes.CDLL | None:
    global _LIB
    if _LIB is None and _BUILD_ERROR is None:
        _LIB = _build()
    return _LIB


def available() -> bool:
    return _lib() is not None


def backend_name() -> str:
    return "native" if available() else f"numpy (native unavailable: {_BUILD_ERROR})"


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def code_lengths(freqs: np.ndarray) -> np.ndarray:
    """Native Huffman code lengths; falls back to the NumPy mirror."""
    lib = _lib()
    freqs = np.ascontiguousarray(freqs, dtype=np.int64)
    if lib is None:
        from ..core import canonical

        return canonical.huffman_code_lengths(freqs)
    widths = np.zeros(256, dtype=np.uint8)
    rc = lib.mht_code_lengths(
        freqs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), _u8p(widths)
    )
    if rc:
        raise RuntimeError(f"mht_code_lengths failed: {rc}")
    return widths


def canonical_codes(widths: np.ndarray) -> np.ndarray:
    lib = _lib()
    widths = np.ascontiguousarray(widths, dtype=np.uint8)
    if lib is None:
        from ..core import canonical

        return canonical.canonical_codes(widths)
    codes = np.zeros(256, dtype=np.uint16)
    rc = lib.mht_canonical_codes(
        _u8p(widths), codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))
    )
    if rc:
        raise RuntimeError(f"mht_canonical_codes failed: {rc}")
    return codes


def encode_symbols(data: np.ndarray, block_size: int = 64,
                   n_threads: int = 0, widths: np.ndarray | None = None):
    """Native full encode -> EncodedStream; NumPy fallback otherwise.

    ``n_threads``: 0 = auto (hardware concurrency); 1 = the serial encoder.
    Output is identical for any thread count (two-pass deterministic pack).
    With ``widths`` (a Kraft-valid 256-entry canonical width table covering
    every present symbol) the tree build is skipped and the stream packs
    under the CALLER'S table — the fixed/shared-table entry used by the
    width-clustering encoder (``core.canonical.cluster_widths``).
    """
    from ..core.container import EncodedStream

    data = np.ascontiguousarray(data, dtype=np.uint8).ravel()
    if data.size == 0:
        raise ValueError("empty input")
    lib = _lib()
    if lib is None:
        from ..core import bitstream, canonical, encode

        if widths is None:
            return encode.encode_symbols(data, block_size)
        widths = np.ascontiguousarray(widths, np.uint8)
        canonical.validate_widths(widths)
        codes = canonical.canonical_codes(widths)
        packed, offs = bitstream.pack_bits(data, codes, widths)
        return EncodedStream(
            num_symbols=data.size, widths=widths, code_bytes=packed,
            block_offsets=bitstream.block_bit_offsets(offs, block_size))
    if widths is not None:
        return _encode_symbols_fixed(lib, data, block_size, widths, n_threads)

    widths = np.zeros(256, dtype=np.uint8)
    capacity = 2 * data.size + 16
    # np.empty, NOT np.zeros: the C encoder memsets exactly the bytes it
    # produces ([0, total_bytes)), so pre-zeroing the worst-case 2n buffer
    # here would just add a ~2n/(memset bandwidth) tax per call (~25% of
    # encode time measured on large payloads)
    code_bytes = np.empty(capacity, dtype=np.uint8)
    n_blocks = data.size // block_size
    offsets = np.empty(max(n_blocks, 1), dtype=np.uint32)
    code_len = ctypes.c_int64()
    total_bits = ctypes.c_int64()
    offs_p = offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    if n_threads == 1:
        rc = lib.mht_encode(
            _u8p(data), data.size, block_size, _u8p(widths), _u8p(code_bytes),
            capacity, ctypes.byref(code_len), offs_p, ctypes.byref(total_bits),
        )
    else:
        rc = lib.mht_encode_mt(
            _u8p(data), data.size, block_size, _u8p(widths), _u8p(code_bytes),
            capacity, ctypes.byref(code_len), offs_p, ctypes.byref(total_bits),
            n_threads,
        )
    if rc == -7:
        raise ValueError(
            "stream exceeds 2^32 bits — u32 block offsets overflow; "
            "split the input (e.g. per-frame or segmented MHTV)"
        )
    if rc:
        raise RuntimeError(f"mht_encode failed: {rc}")
    # in-place shrink (refcheck off): releases the 2n worst-case tail to the
    # allocator without copying the ~n-sized compressed stream the .copy()
    # here used to cost (~10% of encode time on large payloads)
    code_bytes.resize(code_len.value, refcheck=False)
    return EncodedStream(
        num_symbols=data.size,
        widths=widths,
        code_bytes=code_bytes,
        block_offsets=offsets[:n_blocks],
    )


def _encode_symbols_fixed(lib, data: np.ndarray, block_size: int,
                          widths: np.ndarray, n_threads: int = 0):
    """Pack under a caller-provided canonical width table (no tree build).

    Rides the same two-pass multithreaded machinery as the default path
    (deterministic output for any thread count) — round-3 advisor: the old
    serial-only entry single-threaded width-clustered encodes.
    """
    from ..core import canonical
    from ..core.container import EncodedStream

    widths = np.ascontiguousarray(widths, np.uint8)
    canonical.validate_widths(widths)
    capacity = 2 * data.size + 16
    code_bytes = np.empty(capacity, dtype=np.uint8)
    n_blocks = data.size // block_size
    offsets = np.empty(max(n_blocks, 1), dtype=np.uint32)
    code_len = ctypes.c_int64()
    total_bits = ctypes.c_int64()
    rc = lib.mht_encode_fixed(
        _u8p(data), data.size, block_size, _u8p(widths), _u8p(code_bytes),
        capacity, ctypes.byref(code_len),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.byref(total_bits), n_threads,
    )
    if rc == -8:
        raise ValueError(
            "width table does not cover every symbol present in the data")
    if rc == -7:
        raise ValueError(
            "stream exceeds 2^32 bits — u32 block offsets overflow; "
            "split the input (e.g. per-frame or segmented MHTV)")
    if rc:
        raise RuntimeError(f"mht_encode_fixed failed: {rc}")
    code_bytes.resize(code_len.value, refcheck=False)
    return EncodedStream(
        num_symbols=data.size, widths=widths, code_bytes=code_bytes,
        block_offsets=offsets[:n_blocks],
    )


def decode_blocks(stream, *, delta: bool = True, block_size: int = 64,
                  n_threads: int = 0, delta2d: bool = False) -> np.ndarray:
    """Parallel host decode of an EncodedStream -> (n_blocks, block_size).

    The CPU counterpart of the device kernels (threads over block ranges via
    the bit-offset index). ``delta2d`` inverts the 2-D within-block
    predictor (mode 3) in the same per-block C++ loop — no separate host
    post-pass. NumPy-oracle fallback when the library is absent.
    """
    lib = _lib()
    nb = int(stream.block_offsets.size)
    if nb == 0:  # stream shorter than one block: no decodable block units
        return np.zeros((0, block_size), dtype=np.uint8)
    mode = 2 if delta2d else int(delta)
    if lib is None:
        from ..core import decode_ref, delta as delta_mod, tables

        sym, w = tables.build_single_table(stream.widths)
        out = np.stack([
            decode_ref.decode_single_table(
                stream.code_bytes, sym, w, block_size,
                start_bit=int(stream.block_offsets[b]))
            for b in range(nb)
        ])
        if mode == 2:
            bd = 1
            while bd * bd < block_size:
                bd += 1
            return delta_mod.delta2d_decode_blocks(out, bd)
        return delta_mod.delta_decode_blocks(out) if delta else out

    code_bytes = np.ascontiguousarray(stream.code_bytes, dtype=np.uint8)
    widths = np.ascontiguousarray(stream.widths, dtype=np.uint8)
    offsets = np.ascontiguousarray(stream.block_offsets, dtype=np.uint32)
    # np.empty: the C decoder writes every output byte (or errors out), so
    # pre-zeroing the n-sized buffer is pure tax (as in encode_symbols)
    out = np.empty((nb, block_size), dtype=np.uint8)
    rc = lib.mht_decode_blocks(
        _u8p(code_bytes), code_bytes.size, _u8p(widths),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        nb, block_size, mode, _u8p(out), n_threads,
    )
    if rc:
        raise RuntimeError(f"mht_decode_blocks failed: {rc}")
    return out


def decode_serial(
    code_bytes: np.ndarray, widths: np.ndarray, num_symbols: int, start_bit: int = 0
) -> np.ndarray:
    """Native serial oracle decode; NumPy fallback otherwise."""
    lib = _lib()
    code_bytes = np.ascontiguousarray(code_bytes, dtype=np.uint8)
    widths = np.ascontiguousarray(widths, dtype=np.uint8)
    if lib is None:
        from ..core import decode_ref, tables

        sym, w = tables.build_single_table(widths)
        return decode_ref.decode_single_table(
            code_bytes, sym, w, num_symbols, start_bit
        )
    out = np.zeros(num_symbols, dtype=np.uint8)
    rc = lib.mht_decode_serial(
        _u8p(code_bytes), code_bytes.size, _u8p(widths), num_symbols, start_bit,
        _u8p(out),
    )
    if rc:
        raise RuntimeError(f"mht_decode_serial failed: {rc}")
    return out


def build_split_tables(widths: np.ndarray, k1: int = 8, k2: int = 8):
    """Native two-level split tables -> core.tables.SplitTables.

    Mirrors the reference's preferred decode-table structure
    (``HuffmanUtil.cpp:338-667``); NumPy fallback otherwise. Bit-identical to
    ``core.tables.build_split_tables`` (differential tests).
    """
    from ..core import tables

    if k1 + k2 != 16:
        raise ValueError("k1 + k2 must equal 16 (16-bit decode window)")
    lib = _lib()
    widths = np.ascontiguousarray(widths, dtype=np.uint8)
    if lib is None:
        return tables.build_split_tables(widths, k1, k2)
    n1, n2 = 1 << k1, 1 << k2
    t1_sym = np.zeros(n1, dtype=np.uint8)
    t1_w = np.zeros(n1, dtype=np.uint8)
    t2_sym = np.zeros(256 * n2, dtype=np.uint8)
    t2_w = np.zeros(256 * n2, dtype=np.uint8)
    num_tables = ctypes.c_int32()
    rc = lib.mht_build_split_tables(
        _u8p(widths), k1, _u8p(t1_sym), _u8p(t1_w), _u8p(t2_sym), _u8p(t2_w),
        t2_sym.size, ctypes.byref(num_tables),
    )
    if rc:
        raise RuntimeError(f"mht_build_split_tables failed: {rc}")
    n = num_tables.value * n2
    return tables.SplitTables(
        t1_sym, t1_w, t2_sym[:n].copy(), t2_w[:n].copy(), k1, k2
    )


def decode_serial_split(
    code_bytes: np.ndarray, widths: np.ndarray, num_symbols: int,
    start_bit: int = 0, k1: int = 8,
) -> np.ndarray:
    """Native serial split-table decode (``HuffmanUtil.cpp:830-1046`` mirror);
    NumPy fallback otherwise."""
    lib = _lib()
    code_bytes = np.ascontiguousarray(code_bytes, dtype=np.uint8)
    widths = np.ascontiguousarray(widths, dtype=np.uint8)
    if lib is None:
        from ..core import decode_ref, tables

        t = tables.build_split_tables(widths, k1, 16 - k1)
        return decode_ref.decode_split_tables(
            code_bytes, t, num_symbols, start_bit
        )
    out = np.zeros(num_symbols, dtype=np.uint8)
    rc = lib.mht_decode_serial_split(
        _u8p(code_bytes), code_bytes.size, _u8p(widths), num_symbols,
        start_bit, k1, _u8p(out),
    )
    if rc:
        raise RuntimeError(f"mht_decode_serial_split failed: {rc}")
    return out


def symbol_bit_offsets(data: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """Bit offset of every symbol, (n+1,) uint64 (last = total code bits).

    Native mirror of ``HuffmanEncoder::lookupBufferBitOffsets``
    (``HuffmanEncoder.cpp:383-395``) — the offset of ANY symbol, not just
    block roots; NumPy fallback otherwise.
    """
    lib = _lib()
    data = np.ascontiguousarray(data, dtype=np.uint8).ravel()
    widths = np.ascontiguousarray(widths, dtype=np.uint8)
    if lib is None:
        from ..core import bitstream

        return bitstream.symbol_bit_offsets(data, widths)
    out = np.zeros(data.size + 1, dtype=np.uint64)
    rc = lib.mht_symbol_bit_offsets(
        _u8p(data), data.size, _u8p(widths),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    if rc:
        raise RuntimeError(f"mht_symbol_bit_offsets failed: {rc}")
    return out


def merge_rows(rows: np.ndarray, block_bits: np.ndarray, n_threads: int = 0):
    """Stage-2 of the hybrid device encoder: padded per-block word rows ->
    (code_bytes incl. +2 pad, block_offsets u32, total_bits).

    ``rows`` is (n_blocks, row_words) uint32 — each block's MSB-first packed
    bits as big-endian-semantic words, zero-padded (the Pallas stage-1
    kernel's output, block-major). Multithreaded bit-shift memcpy on the
    host; output is byte-identical to :func:`encode_symbols` packing the
    same symbols (differential tests in tests/test_encode_pallas.py).
    NumPy fallback: an unpackbits/packbits merge (correctness path only).
    """
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    block_bits = np.ascontiguousarray(block_bits, dtype=np.uint32)
    n_blocks, row_words = rows.shape
    if block_bits.shape != (n_blocks,):
        raise ValueError("block_bits must be (n_blocks,)")
    lib = _lib()
    if lib is None:
        total_bits = int(block_bits.astype(np.int64).sum())
        if total_bits >= 1 << 32:
            raise ValueError("stream exceeds 2^32 bits — u32 offsets overflow")
        offsets = np.zeros(n_blocks, dtype=np.uint32)
        np.cumsum(block_bits[:-1], out=offsets[1:])
        bits = np.unpackbits(
            rows.byteswap().view(np.uint8).reshape(n_blocks, -1), axis=1)
        mask = np.arange(row_words * 32) < block_bits[:, None]
        stream_bits = bits[mask]
        pad = (-stream_bits.size) % 8
        packed = np.packbits(np.pad(stream_bits, (0, pad)))
        code = np.zeros((total_bits + 7) // 8 + 2, dtype=np.uint8)
        code[: packed.size] = packed
        return code, offsets, total_bits
    u32p = ctypes.POINTER(ctypes.c_uint32)
    capacity = (int(block_bits.astype(np.int64).sum()) + 7) // 8 + 16
    code_bytes = np.zeros(capacity, dtype=np.uint8)
    offsets = np.zeros(n_blocks, dtype=np.uint32)
    code_len = ctypes.c_int64()
    total_bits = ctypes.c_int64()
    rc = lib.mht_merge_rows(
        rows.ctypes.data_as(u32p), block_bits.ctypes.data_as(u32p),
        n_blocks, row_words, _u8p(code_bytes), capacity,
        ctypes.byref(code_len), offsets.ctypes.data_as(u32p),
        ctypes.byref(total_bits), n_threads,
    )
    if rc == -7:
        raise ValueError(
            "stream exceeds 2^32 bits — u32 block offsets overflow; "
            "split the input (e.g. per-frame or segmented MHTV)"
        )
    if rc:
        raise RuntimeError(f"mht_merge_rows failed: {rc}")
    return code_bytes[: code_len.value], offsets, total_bits.value


def delta_encode(data: np.ndarray, block_size: int = 64) -> np.ndarray:
    lib = _lib()
    data = np.ascontiguousarray(data, dtype=np.uint8).ravel()
    if lib is None:
        from ..core import delta

        n = data.size
        pad = (-n) % block_size
        padded = np.pad(data, (0, pad)).reshape(-1, block_size)
        return delta.delta_encode_blocks(padded).ravel()[:n]
    out = np.empty_like(data)  # C writes every byte
    lib.mht_delta_encode(_u8p(data), data.size, block_size, _u8p(out))
    return out


def delta_decode(deltas: np.ndarray, block_size: int = 64) -> np.ndarray:
    lib = _lib()
    deltas = np.ascontiguousarray(deltas, dtype=np.uint8).ravel()
    if lib is None:
        from ..core import delta

        n = deltas.size
        pad = (-n) % block_size
        padded = np.pad(deltas, (0, pad)).reshape(-1, block_size)
        return delta.delta_decode_blocks(padded).ravel()[:n]
    out = np.empty_like(deltas)  # C writes every byte
    lib.mht_delta_decode(_u8p(deltas), deltas.size, block_size, _u8p(out))
    return out


def delta2d_encode(data: np.ndarray, block_dim: int = 8) -> np.ndarray:
    """2-D within-block predictor (container mode 3/4); whole blocks only."""
    lib = _lib()
    data = np.ascontiguousarray(data, dtype=np.uint8).ravel()
    if lib is None:
        from ..core import delta

        return delta.delta2d_encode_blocks(
            data.reshape(-1, block_dim * block_dim), block_dim).ravel()
    out = np.empty_like(data)  # C validates, then writes every byte
    rc = lib.mht_delta2d_encode(_u8p(data), data.size, block_dim, _u8p(out))
    if rc:
        raise ValueError("delta2d needs a whole number of blocks")
    return out


def delta2d_decode(res: np.ndarray, block_dim: int = 8) -> np.ndarray:
    """Inverse of :func:`delta2d_encode`."""
    lib = _lib()
    res = np.ascontiguousarray(res, dtype=np.uint8).ravel()
    if lib is None:
        from ..core import delta

        return delta.delta2d_decode_blocks(
            res.reshape(-1, block_dim * block_dim), block_dim).ravel()
    out = np.empty_like(res)  # C validates, then writes every byte
    rc = lib.mht_delta2d_decode(_u8p(res), res.size, block_dim, _u8p(out))
    if rc:
        raise ValueError("delta2d needs a whole number of blocks")
    return out

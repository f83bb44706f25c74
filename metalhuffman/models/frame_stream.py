"""Multi-frame (video) codec: batched and sharded decode of frame sequences.

The reference exists to serve full-screen video — 2048x1536 @ 30 FPS was the
goal (``README.md:9-11``) — but only ever decodes a single frame per display
tick. This module is the device generalization: encode a sequence of
same-sized frames, stage the whole batch on device, and decode every frame in
one fused program (``vmap`` over the frame axis), optionally sharded over a
``data x seq`` mesh (frames x block-ranges; ``parallel.shard_decode``).

On-disk: the MHTS container is a frame count + concatenated per-frame MHT1
records (``core.container``).
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core import bitstream, blocks, container, delta as delta_mod
from ..ops import decode_xla, layout as layout_mod
from ..parallel import mesh as mesh_mod, shard_decode
from .image_codec import CodecConfig, ImageCodec

STREAM_MAGIC = b"MHTS"


# -- shared-table video mode --------------------------------------------------
#
# One canonical table across the whole sequence: all frames' blocked payloads
# concatenate into a single stream, so the entire batch decodes in ONE kernel
# dispatch (the per-dispatch overhead of chained per-frame decodes disappears;
# this is also how fixed-table video codecs amortize table cost). The u32
# per-block bit offsets cap a shared stream at 2^32 bits = 512 MB compressed.


def encode_frames_shared(
    frames: np.ndarray, config: CodecConfig | None = None
) -> container.EncodedStream:
    """(T, H, W) frames -> one EncodedStream with a shared canonical table.

    With ``config.zero_init`` every block's root byte moves to the stream's
    uncoded ``block_init`` side array (the reference's compile-time
    ``IMPL_DELTAS_AND_INIT_ZERO_DELTA`` variant, applied across the whole
    sequence); MHTV/MHV2 serialize it with mode byte 2.
    """
    from .. import native

    cfg = config or CodecConfig()
    frames = np.asarray(frames)
    if frames.ndim != 3:
        raise ValueError("frames must be (T, H, W)")
    if (cfg.zero_init or cfg.delta2d) and not cfg.delta:
        raise ValueError("zero_init/delta2d require delta precoding")
    predictor = "2d" if cfg.delta2d else "left"
    payloads = []
    for f in frames:
        blk = blocks.image_to_blocks(f, cfg.block_dim).ravel()
        if cfg.delta2d:
            payloads.append(native.delta2d_encode(blk, cfg.block_dim))
        elif cfg.delta:
            payloads.append(native.delta_encode(blk, cfg.block_size))
        else:
            payloads.append(blk)
    payload = np.concatenate(payloads)
    # no worst-case pre-check: the encoder verifies the *actual* total bits
    # against the u32 offset cap and raises cleanly on true overflow
    if not cfg.zero_init:
        stream = native.encode_symbols(payload, block_size=cfg.block_size)
        return container.EncodedStream(
            stream.num_symbols, stream.widths, stream.code_bytes,
            stream.block_offsets, predictor=predictor)
    init, zeroed = delta_mod.split_zero_init(
        payload.reshape(-1, cfg.block_size))
    stream = native.encode_symbols(
        zeroed.reshape(-1), block_size=cfg.block_size)
    return container.EncodedStream(
        stream.num_symbols, stream.widths, stream.code_bytes,
        stream.block_offsets, block_init=init, predictor=predictor)


SHARED_MAGIC = b"MHTV"


def _stream_mode(stream: container.EncodedStream, delta: bool) -> int:
    """Container mode byte: 0 = none, 1 = delta, 2 = delta + zero-init,
    3 = delta2d, 4 = delta2d + zero-init (same scheme as MHT1)."""
    two_d = stream.predictor == "2d"
    if (two_d or stream.block_init is not None) and not delta:
        raise ValueError("zero-init/delta2d are delta precoding modes")
    if stream.block_init is None:
        return 3 if two_d else int(delta)
    if stream.block_init.size != stream.block_offsets.size:
        raise ValueError("block_init must have one byte per block")
    return 4 if two_d else 2


def write_shared(stream: container.EncodedStream, num_frames: int, height: int,
                 width: int, config: CodecConfig | None = None,
                 source_crc32: int = 0, frame_crcs=None) -> bytes:
    """Serialize a shared-table frame sequence to the MHTV container.

    The delta byte is a MODE (same scheme as MHT1): 0 = none, 1 = delta,
    2 = delta + zero-init (``stream.block_init`` root bytes appended after
    the offset index), 3 = delta2d, 4 = delta2d + zero-init.
    ``source_crc32`` (CRC-32 of the raw (T, H, W) frame
    bytes, 0 = unrecorded) is appended as a 4-byte trailer; it catches
    corruption the on-device end-bit check cannot (a bit flip that maps
    codes to other same-width codes preserves every block's bit length).
    The reference's verify path compares every decoded byte
    (``AAPLRenderer.m:1849-1876``) — the CRC is the streaming analog.
    """
    cfg = config or CodecConfig()
    mode = _stream_mode(stream, cfg.delta)
    head = SHARED_MAGIC + struct.pack(
        "<IIIIBB", num_frames, height, width, stream.block_offsets.size,
        cfg.block_dim, mode,
    )
    core = stream.core_blob()
    tail = (b"" if mode not in (2, 4)
            else stream.block_init.astype(np.uint8).tobytes())
    return (head + struct.pack("<I", len(core)) + core
            + stream.block_offsets.astype("<u4").tobytes() + tail
            + struct.pack("<I", source_crc32 & 0xFFFFFFFF)
            + _frame_crc_blob(frame_crcs))


def read_shared(data: bytes):
    """Parse MHTV -> (stream, num_frames, height, width, block_dim, delta).

    Mode byte 2 (zero-init) yields ``delta=True`` and a stream carrying the
    uncoded ``block_init`` root bytes.
    """
    if data[:4] != SHARED_MAGIC:
        raise ValueError("not an MHTV container")
    t, h, w, n_blocks, bd, mode = struct.unpack_from("<IIIIBB", data, 4)
    (core_len,) = struct.unpack_from("<I", data, 22)
    core = data[26 : 26 + core_len]
    num_symbols, widths, code_bytes = container.parse_core_blob(core)
    offsets = np.frombuffer(
        data, dtype="<u4", count=n_blocks, offset=26 + core_len
    ).astype(np.uint32)
    if offsets.size != n_blocks:
        raise ValueError("truncated MHTV container (offset index incomplete)")
    block_init = None
    if mode in (2, 4):
        init_off = 26 + core_len + 4 * n_blocks
        block_init = np.frombuffer(
            data, dtype=np.uint8, count=n_blocks, offset=init_off).copy()
        if block_init.size != n_blocks:
            raise ValueError("truncated MHTV container (block_init missing)")
    stream = container.EncodedStream(
        num_symbols, widths, code_bytes, offsets, block_init,
        predictor="2d" if mode in (3, 4) else "left")
    return stream, t, h, w, bd, bool(mode)


def _trailer_offset(data: bytes) -> int:
    """Byte offset of the source-CRC trailer of an MHTV/MHV2 container."""
    if data[:4] == SHARED_MAGIC:
        _t, _h, _w, nb, _bd, mode = struct.unpack_from("<IIIIBB", data, 4)
        (core_len,) = struct.unpack_from("<I", data, 22)
        return 26 + core_len + 4 * nb + (nb if mode in (2, 4) else 0)
    if data[:4] == SEGMENTED_MAGIC:
        _t, _h, _w, _bd, mode, n_seg = struct.unpack_from("<IIIBBI", data, 4)
        end = 4 + 18
        for _ in range(n_seg):
            _ft, nb, core_len = struct.unpack_from("<III", data, end)
            end += 12 + core_len + 4 * nb + (nb if mode in (2, 4) else 0)
        return end
    raise ValueError("not an MHTV/MHV2 container")


def source_crc32(data: bytes) -> int:
    """Recorded source CRC-32 of an MHTV/MHV2 container (0 = unrecorded).

    The trailer is detected by length (containers written before the CRC
    trailer existed parse as unrecorded); verify with
    :func:`verify_source_crc32` after decoding.
    """
    end = _trailer_offset(data)
    if len(data) >= end + 4:
        return struct.unpack_from("<I", data, end)[0]
    return 0


FRAME_CRC_MAGIC = b"FCRC"


def _frame_crc_blob(frame_crcs) -> bytes:
    """Serialize the optional per-frame CRC extension (after the trailer)."""
    if frame_crcs is None:
        return b""
    fc = np.asarray(frame_crcs, np.uint32).reshape(-1)
    return (FRAME_CRC_MAGIC + struct.pack("<I", fc.shape[0])
            + fc.astype("<u4").tobytes())


def read_frame_crcs(data: bytes):
    """Per-frame CRC-32 table of an MHTV/MHV2 container, or None.

    The FCRC extension sits AFTER the source-CRC trailer, so readers that
    predate it (which parse by offset and ignore trailing bytes) are
    unaffected; with it, random access (``decode_range``) verifies exactly
    the frames it returns.
    """
    pos = _trailer_offset(data) + 4
    if len(data) < pos + 8 or data[pos : pos + 4] != FRAME_CRC_MAGIC:
        return None
    (t,) = struct.unpack_from("<I", data, pos + 4)
    if len(data) < pos + 8 + 4 * t:
        raise ValueError("truncated FCRC extension (table incomplete)")
    return np.frombuffer(data, dtype="<u4", count=t, offset=pos + 8).copy()


def compute_frame_crcs(frames) -> np.ndarray:
    """(T,) uint32 per-frame CRC-32 table of a frame stack — THE one
    recipe every writer (library encode_video, CLI, MHVT wrapper) shares,
    so tables written by any surface verify on any other."""
    return np.array([zlib.crc32(np.ascontiguousarray(f).tobytes())
                     for f in frames], np.uint32)


def verify_frame_crcs(frames, fcrcs, base: int = 0) -> None:
    """Check frames [base, base+len) against a per-frame CRC table."""
    if fcrcs is None:
        return
    if fcrcs.shape[0] < base + len(frames):
        raise ValueError(
            "corrupt container (frame CRC table shorter than the stream)")
    for i, f in enumerate(frames):
        if (zlib.crc32(np.ascontiguousarray(f).tobytes()) & 0xFFFFFFFF
                != int(fcrcs[base + i])):
            raise ValueError(
                f"decoded frame {base + i} fails its recorded CRC-32 — "
                "the stream is corrupt")


def verify_source_crc32(frames: np.ndarray, recorded: int) -> None:
    """Raise ValueError when decoded frames mismatch a recorded CRC-32."""
    if not recorded:
        return
    got = zlib.crc32(np.ascontiguousarray(frames).tobytes()) & 0xFFFFFFFF
    if got != recorded:
        raise ValueError(
            f"decoded payload CRC-32 mismatch (got {got:#010x}, container "
            f"records {recorded:#010x}) — the stream is corrupt")


@dataclass(frozen=True)
class PreparedShared:
    """Device-staged shared-table batch (stage once, decode every frame tick)."""

    num_frames: int
    height: int
    width: int
    nb_total: int
    backend: str  # "pallas" (the decode kernel) | "xla" (plain XLA)
    words: jnp.ndarray  # big-endian u32 code words
    offsets: jnp.ndarray  # per-block bit offsets, stream order
    t1: jnp.ndarray  # packed split decode tables (decode_xla.prepare_tables)
    t2: jnp.ndarray
    #: words per staged block row (the xla backend's layout); 0 otherwise
    wpr: int = 0
    #: stream-order expected end bits (-1 = unchecked); present only when
    #: prepared with check=True (decode_shared_step_checked)
    end_targets: np.ndarray | None = None
    #: byte-rounded (lo, hi) window for the LAST block's end bit (its exact
    #: end is not indexed); None when the stream has tail symbols
    last_window: tuple | None = None
    #: staged zero-init root bytes, (T, blocks_per_frame) uint8 on device;
    #: None unless the stream carries block_init (mode 2)
    init_grid: object = None


def prepare_shared(
    stream: container.EncodedStream,
    num_frames: int,
    height: int,
    width: int,
    config: CodecConfig | None = None,
    check: bool = False,
) -> PreparedShared:
    """Stage a shared-table stream's decode inputs on device.

    The decode kernel reads the packed word stream in place, so staging is
    the words, the offset index and the decode tables. ``backend="xla"``
    stages the same arrays for the plain-XLA decode (its block rows are
    gathered inside the decode step).
    """
    from ..ops import decode_pallas

    cfg = config or CodecConfig()
    if cfg.backend not in ("pallas", "xla"):
        raise ValueError(
            f"prepare_shared needs a device backend, not {cfg.backend!r}")
    words, offsets, t1, t2 = decode_pallas.prepare_stream(
        stream, cfg.table1_bits, cfg.table2_bits)
    wpr = 0
    if cfg.backend == "xla":
        words, _, wpr = decode_xla.prepare_stream(stream)
    init_grid = None
    if stream.block_init is not None:
        init_grid = jax.device_put(jnp.asarray(
            stream.block_init.astype(np.uint8).reshape(num_frames, -1)))
    end_targets = last_window = None
    if check:
        end_targets = decode_pallas.block_end_targets(offsets, None)
        last_window = decode_pallas.last_block_window(stream, cfg.block_size)
    return PreparedShared(
        num_frames, height, width, int(offsets.size), cfg.backend,
        *(jax.device_put(jnp.asarray(a)) for a in (words, offsets, t1, t2)),
        wpr, end_targets, last_window, init_grid,
    )


def _run_shared(prep: PreparedShared, cfg: CodecConfig, raw: bool,
                emit_end: bool):
    from ..ops import decode_pallas

    if raw and (prep.init_grid is not None
                or not decode_pallas.raw_words_ok(cfg.block_dim)):
        raise ValueError(
            "raw image words need block_dim % 4 == 0 and no zero-init root "
            "fold; decode with raw=False")
    return _decode_shared_jit(
        prep.words, prep.offsets, prep.t1, prep.t2, backend=prep.backend,
        num_frames=prep.num_frames, height=prep.height, width=prep.width,
        block_dim=cfg.block_dim, delta=cfg.delta and not cfg.delta2d,
        delta2d=cfg.delta2d, raw=raw, emit_end=emit_end, wpr=prep.wpr,
        k1=cfg.table1_bits, k2=cfg.table2_bits)


def _fold_init(prep: PreparedShared, cfg: CodecConfig, out):
    if prep.init_grid is None:
        return out
    return _apply_init_frames_jit(
        out, prep.init_grid, block_dim=cfg.block_dim, height=prep.height,
        width=prep.width)


def decode_shared_step(prep: PreparedShared, config: CodecConfig | None = None,
                       raw: bool = False):
    """Jitted device decode of a staged batch.

    Returns (T, H, W) uint8 — or, with ``raw=True``, (T, rows, W_pad//4)
    int32 image words, the frames padded to whole blocks
    (:func:`frames_from_raw` views them as bytes on the host for free; no
    device relayout pass). ``raw`` needs ``block_dim % 4 == 0`` and no
    zero-init roots.
    """
    cfg = config or CodecConfig()
    return _fold_init(prep, cfg, _run_shared(prep, cfg, raw, emit_end=False))


def decode_shared_step_checked(prep: PreparedShared,
                               config: CodecConfig | None = None,
                               raw: bool = False):
    """Decode + on-device integrity check of a staged batch.

    Requires ``prepare_shared(..., check=True)``. Returns
    ``(result, err_mask)`` where ``err_mask`` is a stream-order (nb,) bool
    array — True marks a block that did not end at its indexed bit position
    (corrupt/truncated stream; see decode_pallas ``emit_end_bits``). The
    check costs one extra int32 store per block in-kernel plus a small
    host fetch of the end-bit plane.
    """
    from ..ops import decode_pallas

    if prep.end_targets is None:
        raise ValueError("prepare_shared(..., check=True) required")
    cfg = config or CodecConfig()
    result, end = _run_shared(prep, cfg, raw, emit_end=True)
    err = decode_pallas.check_block_ends(end, prep.end_targets,
                                         prep.last_window)
    return _fold_init(prep, cfg, result), err


def decode_shared_sharded(
    stream: container.EncodedStream,
    num_frames: int,
    height: int,
    width: int,
    mesh=None,
    config: CodecConfig | None = None,
):
    """Multi-device shared-table batch decode (the decode kernel per device).

    Block rows are split into contiguous ranges, one per device; each
    device decodes its range straight to image words, so the output is the
    raw image words sharded by row range: (rows, W_pad//4) int32 with the
    frames stacked and padded to whole blocks (and to whole rows per
    device). View it with :func:`frames_from_raw`.
    """
    from ..ops import decode_pallas
    from ..parallel import mesh as mesh_mod, shard_decode

    cfg = config or CodecConfig()
    if stream.block_init is not None:
        raise ValueError(
            "sharded decode returns raw image words and cannot fold "
            "zero-init roots; apply core.delta.apply_block_init after "
            "reassembly, or use decode_frames_shared")
    if not decode_pallas.raw_words_ok(cfg.block_dim):
        raise ValueError("sharded decode emits image words: block_dim must "
                         "be a multiple of 4")
    if mesh is None:
        mesh = mesh_mod.make_mesh()
    words, offsets, t1, t2 = decode_pallas.prepare_stream(
        stream, cfg.table1_bits, cfg.table2_bits)
    bw = -(-width // cfg.block_dim)
    return shard_decode.decode_grid_sharded(
        jnp.asarray(words), jnp.asarray(offsets), jnp.asarray(t1),
        jnp.asarray(t2), mesh=mesh, grid_bw=bw, block_dim=cfg.block_dim,
        delta=cfg.delta and not cfg.delta2d, delta2d=cfg.delta2d,
        k1=cfg.table1_bits, k2=cfg.table2_bits)


# -- segmented shared-table video (MHV2) --------------------------------------
#
# u32 per-block bit offsets cap one shared stream at 2^32 bits (~512 MB
# compressed). Longer sequences are split into SEGMENTS of whole frames,
# each an independent shared-table stream with its own canonical table and
# offset index; decode pipelines segments through StreamingDecoder (staging
# of segment k+1 overlaps decode of segment k). This is the long-stream
# scaling mechanism the reference's blocked-bitstream design implies but
# never needed (its streams are one frame; SURVEY.md section 5).

SEGMENTED_MAGIC = b"MHV2"

#: per-symbol bit bound used to pick segment frame counts: Huffman expected
#: length <= H + 1 <= 9 for 8-bit symbols; 10 adds headroom for the 16-bit
#: length-limit penalty. The encoder's exact u32 check still guards.
_SEG_BITS_PER_SYMBOL = 10


def segment_frame_counts(num_frames: int, frame_symbols: int,
                         max_segment_bits: int = (1 << 32) - 1024) -> list[int]:
    """Frames per segment so each segment's bits provably fit u32 offsets."""
    per = max(1, int(max_segment_bits // (frame_symbols * _SEG_BITS_PER_SYMBOL)))
    counts = []
    left = num_frames
    while left > 0:
        take = min(per, left)
        counts.append(take)
        left -= take
    return counts


def encode_frames_segmented(
    frames: np.ndarray, config: CodecConfig | None = None,
    max_segment_bits: int = (1 << 32) - 1024,
) -> list[tuple[container.EncodedStream, int]]:
    """(T, H, W) frames -> [(EncodedStream, frames_in_segment), ...].

    Splits at whole-frame boundaries so every segment decodes independently
    (and in a pipeline). If a segment still overflows the exact u32 check
    (pathological content), it is halved and re-encoded.
    """
    cfg = config or CodecConfig()
    frames = np.asarray(frames)
    if frames.ndim != 3:
        raise ValueError("frames must be (T, H, W)")
    t, h, w = frames.shape
    if t == 0 or h == 0 or w == 0:
        raise ValueError("cannot encode an empty frame stack")
    if cfg.zero_init and not cfg.delta:
        # validate here: the overflow-halving retry below must only ever
        # see the encoder's u32-overflow ValueError
        raise ValueError("zero_init requires delta precoding")
    bh, bw = blocks.block_grid(h, w, cfg.block_dim)
    frame_symbols = bh * bw * cfg.block_size
    counts = segment_frame_counts(t, frame_symbols, max_segment_bits)
    segments: list[tuple[container.EncodedStream, int]] = []
    start = 0
    pending = list(counts)
    while pending:
        take = pending.pop(0)
        try:
            stream = encode_frames_shared(frames[start : start + take], cfg)
        except ValueError:
            if take == 1:
                raise  # single frame over 2^32 bits: nothing to split
            half = take // 2
            pending[0:0] = [half, take - half]
            continue
        segments.append((stream, take))
        start += take
    return segments


def write_segmented(
    segments: list[tuple[container.EncodedStream, int]], height: int,
    width: int, config: CodecConfig | None = None, source_crc32: int = 0,
    frame_crcs=None,
) -> bytes:
    """Serialize segments to the MHV2 container.

    The delta byte is a MODE (0/1/2 as MHT1/MHTV); mode 2 appends each
    segment's ``block_init`` root bytes after that segment's offset index.
    All segments must agree on the mode. ``source_crc32`` (CRC-32 of the
    full raw (T, H, W) payload, 0 = unrecorded) trails the last segment —
    see :func:`write_shared` for why the end-bit check alone is not enough.
    """
    cfg = config or CodecConfig()
    if not segments:
        raise ValueError("cannot serialize an empty segment list")
    modes = {_stream_mode(s, cfg.delta) for s, _ in segments}
    if len(modes) != 1:
        raise ValueError("MHV2 segments must share one delta/zero-init mode")
    mode = modes.pop()
    total_frames = sum(t for _, t in segments)
    out = [SEGMENTED_MAGIC, struct.pack(
        "<IIIBBI", total_frames, height, width, cfg.block_dim,
        mode, len(segments))]
    for stream, t in segments:
        core = stream.core_blob()
        out.append(struct.pack(
            "<III", t, stream.block_offsets.size, len(core)))
        out.append(core)
        out.append(stream.block_offsets.astype("<u4").tobytes())
        if mode in (2, 4):
            out.append(stream.block_init.astype(np.uint8).tobytes())
    out.append(struct.pack("<I", source_crc32 & 0xFFFFFFFF))
    out.append(_frame_crc_blob(frame_crcs))
    return b"".join(out)


def read_segmented(data: bytes):
    """Parse MHV2 -> (segments [(stream, t)], total_frames, h, w, bd, delta)."""
    if data[:4] != SEGMENTED_MAGIC:
        raise ValueError("not an MHV2 container")
    total, h, w, bd, mode, n_seg = struct.unpack_from("<IIIBBI", data, 4)
    pos = 4 + 18
    segments = []
    for _ in range(n_seg):
        t, n_blocks, core_len = struct.unpack_from("<III", data, pos)
        pos += 12
        num_symbols, widths, code_bytes = container.parse_core_blob(
            data[pos : pos + core_len])
        pos += core_len
        offsets = np.frombuffer(
            data, dtype="<u4", count=n_blocks, offset=pos).astype(np.uint32)
        pos += 4 * n_blocks
        block_init = None
        if mode in (2, 4):
            block_init = np.frombuffer(
                data, dtype=np.uint8, count=n_blocks, offset=pos).copy()
            if block_init.size != n_blocks:
                raise ValueError(
                    "truncated MHV2 container (block_init missing)")
            pos += n_blocks
        segments.append((
            container.EncodedStream(
                num_symbols, widths, code_bytes, offsets, block_init,
                predictor="2d" if mode in (3, 4) else "left"),
            t,
        ))
    if sum(t for _, t in segments) != total:
        raise ValueError("MHV2 segment frame counts do not sum to the header")
    return segments, total, h, w, bd, bool(mode)


def decode_frames_segmented(
    segments: list[tuple[container.EncodedStream, int]], height: int,
    width: int, config: CodecConfig | None = None, check: bool = False,
) -> np.ndarray:
    """Decode a segment list -> (T, H, W) uint8 (pipelined across segments).

    Device backends pipeline through StreamingDecoder (segment k+1 stages
    while k decodes); the native backend decodes per segment on the host.
    With ``check=True`` each segment runs the on-device integrity check
    (serially — the check's host fetch is a pipeline barrier) and a
    ``ValueError`` names the first corrupt segment/blocks.
    """
    cfg = config or CodecConfig()
    if not check:
        outs = list(iter_frames_segmented(segments, height, width, cfg))
        return np.concatenate(outs) if outs else np.zeros(
            (0, height, width), np.uint8)
    outs = []
    for si, frames, err in iter_frames_segmented_checked(
            segments, height, width, cfg):
        if err.any():
            idx = np.nonzero(err)[0]
            raise ValueError(
                f"stream integrity check failed in segment {si}: "
                f"{idx.size} corrupt block(s), first at {idx[:8].tolist()}")
        outs.append(frames)
    return np.concatenate(outs) if outs else np.zeros(
        (0, height, width), np.uint8)


def iter_frames_segmented_checked(
    segments: list[tuple[container.EncodedStream, int]], height: int,
    width: int, config: CodecConfig | None = None,
):
    """Per-segment CHECKED decode: yield ``(segment_index, frames, err)``.

    The on-device end-bit-check variant of :func:`iter_frames_segmented`;
    the one implementation behind every checked MHV2 surface — the caller
    decides fail-vs-salvage (the library decode raises on the first
    flagged segment, the CLI zero-fills under ``--salvage``). Serial: the
    check's host fetch is a pipeline barrier.
    """
    cfg = config or CodecConfig()
    if cfg.backend == "native":
        raise ValueError(
            "the stream-integrity check runs on the device decode path; "
            "use backend='pallas'")
    for si, (stream, t) in enumerate(segments):
        prep = prepare_shared(stream, t, height, width, cfg, check=True)
        frames, err = decode_shared_step_checked(prep, cfg)
        yield si, np.asarray(frames), np.asarray(err)


def iter_frames_segmented(
    segments: list[tuple[container.EncodedStream, int]], height: int,
    width: int, config: CodecConfig | None = None,
):
    """Yield each segment's decoded (t, H, W) uint8 frames, in order.

    The memory-bounded form of :func:`decode_frames_segmented` (which is
    now a concatenation of this iterator): a consumer that writes each
    chunk out and drops it holds one segment of frames at a time, so an
    arbitrarily long MHV2 decodes in constant memory. Device backends
    still pipeline — segment k+1's staging+decode is submitted before
    segment k's result is fetched, so the device never waits on the
    consumer unless the consumer is slower than the decode.
    """
    cfg = config or CodecConfig()
    if cfg.backend == "native":
        from .. import native

        bh, bw = blocks.block_grid(height, width, cfg.block_dim)
        per = bh * bw
        for stream, t in segments:
            # delta2d reconstructs inside the C++ per-block loop (mode 2)
            blk = native.decode_blocks(
                stream, delta=cfg.delta and not cfg.delta2d,
                block_size=cfg.block_size, delta2d=cfg.delta2d)
            if stream.block_init is not None:
                blk = delta_mod.apply_block_init(blk, stream.block_init)
            yield np.stack([
                blocks.blocks_to_image(
                    blk[i * per : (i + 1) * per], height, width,
                    cfg.block_dim)
                for i in range(t)
            ])
        return
    dec = StreamingDecoder(cfg)
    handles = []
    for stream, t in segments:
        handles.append(dec.submit(stream, t, height, width))
        if len(handles) >= 2:  # keep at most two segments in flight
            yield np.asarray(dec.result(handles.pop(0)))
    while handles:
        yield np.asarray(dec.result(handles.pop(0)))


class StreamingDecoder:
    """Pipelined batch decoding: staging of batch t+1 overlaps decode of t.

    JAX dispatch is asynchronous, so ``submit`` returns immediately after
    enqueueing the host->device staging and the decode; ``result`` blocks
    only on that batch. With two or more batches in flight the device never
    waits for the host (the reference decodes strictly serially per display
    tick). Typical loop::

        dec = StreamingDecoder(cfg)
        handles = [dec.submit(s, T, H, W) for s in first_two_batches]
        for next_stream in rest:
            frames = dec.result(handles.pop(0))
            handles.append(dec.submit(next_stream, T, H, W))
    """

    def __init__(self, config: CodecConfig | None = None):
        self.config = config or CodecConfig()

    def submit(self, stream: container.EncodedStream, num_frames: int,
               height: int, width: int):
        """Enqueue staging + decode; returns an opaque handle (non-blocking)."""
        from ..ops import decode_pallas

        prep = prepare_shared(stream, num_frames, height, width, self.config)
        # raw image words skip the device byte relayout, but cannot carry
        # the zero-init root fold — zero-init batches use the image path
        raw_mode = (decode_pallas.raw_words_ok(self.config.block_dim)
                    and prep.init_grid is None)
        out = decode_shared_step(prep, self.config, raw=raw_mode)
        return (prep, out, raw_mode)

    def result(self, handle) -> np.ndarray:
        """Block on one submitted batch; returns (T, H, W) uint8 frames."""
        prep, out, raw_mode = handle
        if raw_mode:
            return frames_from_raw(out, prep.num_frames, prep.height,
                                   prep.width, self.config.block_dim)
        return np.asarray(out)


def frames_from_raw(raw, num_frames: int, height: int, width: int,
                    block_dim: int = 8) -> np.ndarray:
    """Host-side zero-copy view: raw image words -> (T, H, W) uint8 frames.

    The words cover each frame padded to whole blocks (and, from sharded
    decode, extra rows past the last frame); the crop is a strided view —
    still no copy; callers needing contiguous bytes pay one memcpy via
    ``np.ascontiguousarray``.
    """
    from ..ops import decode_pallas

    rows_pf, wp = decode_pallas.padded_geometry(height, width, block_dim)
    flat = np.asarray(raw).reshape(-1, wp // 4)[: num_frames * rows_pf]
    frames = flat.view(np.uint8).reshape(num_frames, rows_pf, wp)
    if rows_pf == height and wp == width:
        return frames
    return frames[:, :height, :width]


@partial(jax.jit, static_argnames=("block_dim", "height", "width"))
def _apply_init_frames_jit(frames, init_grid, *, block_dim, height, width):
    """Fold zero-init root bytes into decoded frames (mod-256 add).

    ``init_grid`` is (T, bh*bw) uint8; decoding a zero-init stream with
    prev=0 then adding each block's root byte to the whole block is exactly
    equivalent to seeding the accumulator (core.delta.apply_block_init) —
    every decode kernel stays unchanged.
    """
    t = frames.shape[0]
    bh = -(-height // block_dim)
    bw = -(-width // block_dim)
    img = jnp.repeat(
        jnp.repeat(init_grid.reshape(t, bh, bw), block_dim, 1), block_dim, 2
    )[:, :height, :width]
    return frames + img.astype(frames.dtype)  # uint8 add wraps mod 256


def decode_frames_shared(
    stream: container.EncodedStream,
    num_frames: int,
    height: int,
    width: int,
    config: CodecConfig | None = None,
):
    """Decode a shared-table stream -> (T, H, W) uint8 array.

    One fused program: Pallas kernel over all T*nb blocks + image reassembly.
    ``backend="native"`` routes to the multithreaded host C++ decoder
    instead (no device is touched), matching every other decode surface.
    """
    cfg = config or CodecConfig()
    if cfg.backend == "native":
        return decode_frames_segmented(
            [(stream, num_frames)], height, width, cfg)
    prep = prepare_shared(stream, num_frames, height, width, config)
    return decode_shared_step(prep, config)


def parse_range_container(data: bytes):
    """Parse an MHTV/MHV2/MHTS blob ONCE for repeated range decodes.

    Returns an opaque handle for :func:`decode_range_parsed`. Parsing (and
    the byte copies it implies — per-segment core blobs, CRC tables) is the
    per-call overhead of :func:`decode_range`; a serving loop that decodes
    many ranges of one container (e.g. :func:`temporal.iter_temporal_video`)
    parses once and pays only the touched blocks per call.
    """
    if data[:4] == SHARED_MAGIC:
        stream, t, h, w, bd, delta = read_shared(data)
        return ("shared", (stream, t, h, w, bd, delta),
                read_frame_crcs(data))
    if data[:4] == SEGMENTED_MAGIC:
        segs, t, h, w, bd, delta = read_segmented(data)
        return ("segmented", (segs, t, h, w, bd, delta),
                read_frame_crcs(data))
    if data[:4] == STREAM_MAGIC:
        streams, h, w, bd, delta = read_stream(data)
        return ("stream", (streams, h, w, bd, delta),
                read_stream_crcs(data))
    raise ValueError("not an MHTV/MHV2/MHTS container")


def decode_range(data: bytes, a: int, b: int,
                 config: CodecConfig | None = None, to_host: bool = True):
    """Decode frames [a, b) of a shared-table container -> ((b-a, H, W), h, w).

    Works on MHTV and segmented MHV2 blobs; only those frames' blocks are
    decoded (per-block offset index random access via :func:`frame_slice`),
    and an MHV2 range may straddle segment boundaries. The container header
    is authoritative for block_dim/mode; config picks the backend. No CRC
    check — the recorded CRC covers the whole payload.

    ``to_host=False`` skips the host fetch and returns the decode output as
    the backend produced it (a device array on the device backends) so a
    caller can fuse further device work — e.g. the MHVT temporal fold —
    before paying one transfer.
    """
    return decode_range_parsed(parse_range_container(data), a, b,
                               config, to_host)


def decode_range_parsed(parsed, a: int, b: int,
                        config: CodecConfig | None = None,
                        to_host: bool = True):
    """:func:`decode_range` on a :func:`parse_range_container` handle."""
    import dataclasses

    kind, payload, fcrcs = parsed
    cfg = config or CodecConfig()
    fetch = np.asarray if to_host else (lambda x: x)

    def done(frames, h, w):
        # host results verify against any recorded per-frame CRC table
        # (FCRC extension) — exactly the frames this call returns
        if to_host:
            verify_frame_crcs(frames, fcrcs, base=a)
        return frames, h, w

    if kind == "shared":
        stream, t, h, w, bd, delta = payload
        if not 0 <= a < b <= t:
            raise ValueError(f"frames [{a}, {b}) out of range ({t} frames)")
        cfg = dataclasses.replace(cfg, block_dim=bd, delta=delta,
                                  delta2d=stream.predictor == "2d")
        view = frame_slice(stream, a, b - a, h, w, cfg)
        return done(fetch(decode_frames_shared(view, b - a, h, w, cfg)), h, w)
    if kind == "segmented":
        segs, t, h, w, bd, delta = payload
        if not 0 <= a < b <= t:
            raise ValueError(f"frames [{a}, {b}) out of range ({t} frames)")
        cfg = dataclasses.replace(
            cfg, block_dim=bd, delta=delta,
            delta2d=bool(segs) and segs[0][0].predictor == "2d")
        outs, base = [], 0
        for stream, ft in segs:  # a range may straddle segments
            lo, hi = max(a, base), min(b, base + ft)
            if lo < hi:
                view = frame_slice(stream, lo - base, hi - lo, h, w, cfg)
                outs.append(fetch(
                    decode_frames_shared(view, hi - lo, h, w, cfg)))
            base += ft
        if len(outs) == 1:
            return done(outs[0], h, w)
        cat = np.concatenate if to_host else jnp.concatenate
        return done(cat(outs), h, w)
    # per-frame-table MHTS: a range is a loop of single-frame decodes
    # (each stream has its own canonical table — no shared batch), each
    # verified against its MHT1 record's CRC when recorded
    streams, h, w, bd, delta = payload
    if not 0 <= a < b <= len(streams):
        raise ValueError(
            f"frames [{a}, {b}) out of range ({len(streams)} frames)")
    outs = []
    for i in range(a, b):
        scfg = dataclasses.replace(
            cfg, block_dim=bd, delta=delta,
            delta2d=streams[i].predictor == "2d")
        img = decode_frame(streams[i], 0, h, w, scfg)
        if fcrcs[i] and zlib.crc32(
                np.ascontiguousarray(img).tobytes()) != fcrcs[i]:
            raise ValueError(
                f"decoded frame {i} fails its recorded CRC-32 — the "
                "stream is corrupt")
        outs.append(np.asarray(img))
    return np.stack(outs), h, w


def salvage_blocks(frames: np.ndarray, err: np.ndarray, block_dim: int):
    """Zero-fill corrupt blocks (best-effort serving decode).

    ``err`` is the stream-order per-block mask from
    :func:`decode_shared_step_checked`. A production stream consumer would
    rather show a black 8x8 square than drop the whole batch. Returns
    ``(frames, n_corrupt)`` — the array is copied first when the input is
    read-only (device fetches are), else patched in place. The reference's
    verify path simply asserts on the first bad byte (``AAPLRenderer.m:1849``).
    """
    idx = np.nonzero(np.asarray(err))[0]
    if idx.size == 0:
        return frames, 0
    if not frames.flags.writeable:
        frames = frames.copy()
    t, h, w = frames.shape
    bd = block_dim
    bh, bw = -(-h // bd), -(-w // bd)
    per = bh * bw
    for i in idx:
        f, r = divmod(int(i), per)
        by, bx = divmod(r, bw)
        frames[f, by * bd : (by + 1) * bd, bx * bd : (bx + 1) * bd] = 0
    return frames, int(idx.size)


def decode_video_region(data: bytes, a: int, b: int, y0: int, x0: int,
                        rh: int, rw: int,
                        config: CodecConfig | None = None,
                        check: bool = False) -> np.ndarray:
    """Spatio-temporal ROI: the (rh, rw) crop of frames [a, b) of an
    MHTV/MHV2/MHTS container -> (b-a, rh, rw) uint8.

    Only the blocks covering the region IN THOSE FRAMES decode — the full
    random-access power of the per-block offset index (time via
    whole-frame slices, space via the block grid), in ONE decode dispatch
    per segment (the selection is frame-major, so the combined block grid
    is just a taller image). The reference re-crops a fully decoded
    texture every tick (``AAPLShaders.metal:108-123``); here neither the
    rest of the frame nor the other frames are ever touched.

    Per-frame CRCs cannot cover a crop, so with ``check`` the end-bit
    integrity check verifies exactly the touched blocks (raising
    ValueError naming the corrupt frames). Detection power: corruption
    outside the region never trips it; corruption inside is caught
    whenever it shifts the block's end position (truncation, burst
    damage, lost/inserted bits). A corruption that re-synchronizes at the
    same net bit length is itself a valid encoding of wrong content and
    is undetectable without stored redundancy — that is what the
    whole-stream CRC surfaces are for (``ops.decode_pallas`` integrity
    notes).
    """
    import dataclasses

    from .image_codec import decode_blocks_selection

    if data[:4] == STREAM_MAGIC:
        # MHTS: every record is a self-contained frame — the region is a
        # per-frame ImageCodec.decode_region loop over [a, b) (round 5;
        # previously the one container without an ROI surface)
        from .image_codec import ImageCodec

        cfg0 = config or CodecConfig()
        outs = []
        geom = None
        # the light span walk skips records before ``a`` WITHOUT parsing
        # their core blobs / offset indexes — an ROI deep into a long
        # MHTS pays O(records walked), not O(container parsed)
        for i, pos, rec_len in _iter_record_spans(data):
            if i >= b:
                break
            if geom is None:
                h0, w0 = struct.unpack_from("<II", data, pos + 4)
                geom = (h0, w0)
                if not (0 <= y0 and y0 + rh <= h0
                        and 0 <= x0 and x0 + rw <= w0):
                    raise ValueError("region out of bounds")
            if i < a:
                continue
            s, h, w, bd, delta, _crc = container.read_frame(
                data[pos : pos + rec_len])
            fcfg = dataclasses.replace(cfg0, block_dim=bd, delta=delta,
                                       delta2d=s.predictor == "2d")
            codec = ImageCodec(fcfg)
            outs.append(codec.decode_region(s, h, w, y0, x0, rh, rw,
                                            check=check))
        if len(outs) != b - a or not 0 <= a < b:
            raise ValueError(
                f"frames [{a}, {b}) out of range "
                f"({len(outs) + a} frames reachable)")
        return np.stack(outs)
    if data[:4] == SHARED_MAGIC:
        stream, t, h, w, bd, delta = read_shared(data)
        segs = [(stream, t)]
    elif data[:4] == SEGMENTED_MAGIC:
        segs, t, h, w, bd, delta = read_segmented(data)
    else:
        raise ValueError("not an MHTV/MHV2 container")
    if not 0 <= a < b <= t:
        raise ValueError(f"frames [{a}, {b}) out of range ({t} frames)")
    if not (0 <= y0 and y0 + rh <= h and 0 <= x0 and x0 + rw <= w):
        raise ValueError("region out of bounds")
    cfg = dataclasses.replace(
        config or CodecConfig(), block_dim=bd, delta=delta,
        delta2d=bool(segs) and segs[0][0].predictor == "2d")
    bh, bw = blocks.block_grid(h, w, bd)
    per = bh * bw
    by0, bx0 = y0 // bd, x0 // bd
    by1, bx1 = (y0 + rh - 1) // bd + 1, (x0 + rw - 1) // bd + 1
    frame_sel = (np.arange(by0, by1)[:, None] * bw
                 + np.arange(bx0, bx1)[None, :]).ravel()
    rbh, rbw = by1 - by0, bx1 - bx0
    oy, ox = y0 - by0 * bd, x0 - bx0 * bd
    outs, base = [], 0
    for stream, ft in segs:  # a range may straddle segments
        lo, hi = max(a, base), min(b, base + ft)
        if lo < hi:
            tt = hi - lo
            sel = (frame_sel[None, :]
                   + per * np.arange(lo - base, hi - base)[:, None]).ravel()
            if check:
                grid, err = decode_blocks_selection(
                    stream, sel, tt * rbh * bd, rbw * bd, cfg, check=True)
                if err.any():
                    bad_frames = lo + np.unique(
                        np.flatnonzero(err) // frame_sel.size)
                    raise ValueError(
                        f"region integrity check failed: {int(err.sum())} "
                        f"of {sel.size} touched blocks corrupt (frames "
                        f"{bad_frames.tolist()})")
            else:
                grid = decode_blocks_selection(
                    stream, sel, tt * rbh * bd, rbw * bd, cfg)
            outs.append(grid.reshape(tt, rbh * bd, rbw * bd))
        base += ft
    out = outs[0] if len(outs) == 1 else np.concatenate(outs)
    return out[:, oy : oy + rh, ox : ox + rw]


def decode_container_device(data: bytes, config: CodecConfig | None = None):
    """MHTV/MHV2 container bytes -> (T, H, W) uint8 DEVICE array.

    Same header-authoritative dispatch as the top-level ``decode_video``
    but WITHOUT the host fetch or CRC verification: consumers (the MHVT
    temporal fold, ``models.temporal``) fuse further device work onto the
    decode and verify integrity after their single fetch. Segments decode
    back-to-back (async dispatch overlaps segment k+1's staging with k's
    decode) and concatenate on device.
    """
    import dataclasses

    cfg = config or CodecConfig()
    if cfg.backend == "native":
        raise ValueError("decode_container_device needs a device backend")
    if data[:4] == SHARED_MAGIC:
        stream, t, h, w, bd, delta = read_shared(data)
        cfg = dataclasses.replace(cfg, block_dim=bd, delta=delta,
                                  delta2d=stream.predictor == "2d")
        return decode_frames_shared(stream, t, h, w, cfg)
    if data[:4] == SEGMENTED_MAGIC:
        segs, t, h, w, bd, delta = read_segmented(data)
        cfg = dataclasses.replace(
            cfg, block_dim=bd, delta=delta,
            delta2d=bool(segs) and segs[0][0].predictor == "2d")
        outs = [decode_frames_shared(s, ft, h, w, cfg) for s, ft in segs]
        return outs[0] if len(outs) == 1 else jnp.concatenate(outs)
    raise ValueError("not an MHTV/MHV2 container")


def frame_slice(
    stream: container.EncodedStream,
    t0: int,
    num: int,
    height: int,
    width: int,
    config: CodecConfig | None = None,
) -> container.EncodedStream:
    """View of frames [t0, t0+num) of a shared-table stream, zero copy.

    Temporal random access is exactly what the per-block offset index buys
    (the spatial analog is ``ImageCodec.decode_region``): the view shares
    ``code_bytes`` and the canonical table and carries only the selected
    frames' block offsets (+ zero-init roots), so any decode path treats it
    as an ordinary ``num``-frame stream and never touches the rest.
    """
    cfg = config or CodecConfig()
    bh, bw = blocks.block_grid(height, width, cfg.block_dim)
    per = bh * bw
    total = stream.block_offsets.size // per
    if not (0 <= t0 and t0 + num <= total):
        raise ValueError(
            f"frames [{t0}, {t0 + num}) out of range (stream has {total})")
    sel = slice(t0 * per, (t0 + num) * per)
    init = None if stream.block_init is None else stream.block_init[sel]
    return container.EncodedStream(
        num * per * cfg.block_size, stream.widths, stream.code_bytes,
        stream.block_offsets[sel], init, predictor=stream.predictor)


def decode_frame(
    stream: container.EncodedStream,
    t: int,
    height: int,
    width: int,
    config: CodecConfig | None = None,
) -> np.ndarray:
    """Decode ONE frame of a shared-table stream -> (H, W) uint8.

    Decodes only that frame's blocks (see :func:`frame_slice`); the work is
    1/T of the batch. The reference has no random access at all — it always
    decodes the whole texture (``AAPLRenderer.m:1178-1924``).
    """
    cfg = config or CodecConfig()
    view = frame_slice(stream, t, 1, height, width, cfg)
    return np.asarray(
        decode_frames_shared(view, 1, height, width, cfg)).reshape(
            height, width)


@partial(jax.jit, static_argnames=(
    "backend", "num_frames", "height", "width", "block_dim", "delta",
    "delta2d", "raw", "emit_end", "wpr", "k1", "k2"))
def _decode_shared_jit(words, offsets, t1, t2, *, backend, num_frames, height,
                       width, block_dim, delta, delta2d, raw, emit_end, wpr,
                       k1, k2):
    """Decode a staged batch -> (T, H, W) uint8, or raw image words
    (T, rows, W_pad//4) int32; with ``emit_end`` also stream-order end bits.

    ``backend="pallas"`` runs the decode kernel (image words straight from
    the kernel when ``block_dim % 4 == 0``); ``"xla"`` runs
    ``decode_xla.decode_blocks`` over staged block rows.
    """
    from ..ops import decode_pallas

    bd = block_dim
    block_size = bd * bd
    rows_pf, w_pad = decode_pallas.padded_geometry(height, width, bd)
    end = None
    if backend == "pallas" and decode_pallas.raw_words_ok(bd):
        out = decode_pallas.decode(
            words, offsets, t1, t2, block_dim=bd, delta=delta,
            delta2d=delta2d, grid_bw=w_pad // bd, emit_end_bits=emit_end,
            k1=k1, k2=k2)
        if emit_end:
            out, end = out
        if raw:
            img = out.reshape(num_frames, rows_pf, w_pad // 4)
        else:
            img = decode_pallas.images_from_words(
                out, num_frames, height, width, bd)
        return (img, end) if emit_end else img
    if backend == "pallas":  # block_dim 2: blocks out, relayout in XLA
        blk = decode_pallas.decode(
            words, offsets, t1, t2, block_dim=bd, delta=delta,
            emit_end_bits=emit_end, k1=k1, k2=k2)
        if emit_end:
            blk, end = blk
        blk = decode_pallas.blocks_from_words(blk, block_size)
    else:
        rows, bit_init = layout_mod.build_layout_jax(words, offsets, wpr)
        blk = decode_xla.decode_blocks(
            rows, bit_init, t1, t2, num_steps=block_size, delta=delta, k2=k2,
            emit_end_bits=emit_end)
        if emit_end:
            blk, end = blk
    if delta2d:
        blk = delta_mod.delta2d_decode_blocks_jax(blk, bd)
    blk = blk.reshape(num_frames, -1, block_size)
    if raw:
        img = jax.vmap(
            lambda b: blocks.blocks_to_image_jax(b, rows_pf, w_pad, bd))(blk)
        img = jax.lax.bitcast_convert_type(
            img.reshape(num_frames, rows_pf, w_pad // 4, 4), jnp.int32)
    else:
        img = jax.vmap(
            lambda b: blocks.blocks_to_image_jax(b, height, width, bd))(blk)
    return (img, end) if emit_end else img


def encode_frames(
    frames: np.ndarray | list[np.ndarray], config: CodecConfig | None = None
) -> list[container.EncodedStream]:
    """Encode a (T, H, W) stack (or list) of same-sized grayscale frames."""
    codec = ImageCodec(config)
    frames = np.asarray(frames)
    if frames.ndim != 3:
        raise ValueError("frames must be (T, H, W)")
    return [codec.encode(f) for f in frames]


def write_stream(streams: list[container.EncodedStream], height: int, width: int,
                 config: CodecConfig | None = None,
                 source_crc32s: list[int] | None = None) -> bytes:
    """Serialize a frame sequence to the MHTS container.

    ``source_crc32s`` records each frame's raw-byte CRC-32 in its MHT1
    record (0 / None = unrecorded); read back with :func:`read_stream_crcs`.
    """
    cfg = config or CodecConfig()
    if source_crc32s is not None and len(source_crc32s) != len(streams):
        raise ValueError("source_crc32s must have one entry per frame")
    out = [STREAM_MAGIC, struct.pack("<I", len(streams))]
    for i, s in enumerate(streams):
        rec = container.write_frame(
            s, height, width, cfg.block_dim, cfg.delta,
            source_crc32=source_crc32s[i] if source_crc32s else 0)
        out.append(struct.pack("<I", len(rec)))
        out.append(rec)
    return b"".join(out)


def _iter_record_spans(data: bytes):
    """The ONE light MHTS record walk: yields ``(i, offset, rec_len)`` per
    record (offset = start of the MHT1 blob, past the u32 length prefix)
    without parsing record bodies. Length-checked so truncation is a
    clean ValueError. Every MHTS consumer — the full parser, the
    one-frame-at-a-time reader, the region decode's skip, surgery's span
    splices, the append opener — walks through here (or mirrors its
    checks on a file handle), so the validation rules cannot diverge."""
    if data[:4] != STREAM_MAGIC:
        raise ValueError("not an MHTS container")
    if len(data) < 8:
        raise ValueError("truncated MHTS container (header incomplete)")
    (count,) = struct.unpack_from("<I", data, 4)
    pos = 8
    for i in range(count):
        if len(data) < pos + 4:
            raise ValueError(
                f"truncated MHTS container (record {i} length missing)")
        (rec_len,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if len(data) < pos + rec_len:
            raise ValueError(
                f"truncated MHTS container (record {i} incomplete)")
        yield i, pos, rec_len
        pos += rec_len


def _iter_stream_records(data: bytes):
    for _i, pos, rec_len in _iter_record_spans(data):
        yield container.read_frame(data[pos : pos + rec_len])


def read_stream(data: bytes):
    """Parse MHTS -> (streams, height, width, block_dim, delta)."""
    streams, geom = [], None
    for stream, h, w, bd, delta, _crc in _iter_stream_records(data):
        if geom is None:
            geom = (h, w, bd, delta)
        elif geom != (h, w, bd, delta):
            raise ValueError("MHTS frames must share geometry")
        streams.append(stream)
    if geom is None:
        raise ValueError("empty MHTS stream")
    return streams, *geom


def read_stream_crcs(data: bytes) -> list[int]:
    """Per-frame recorded source CRC-32s of an MHTS container (0 = absent)."""
    return [rec[5] for rec in _iter_stream_records(data)]


def stream_frame_count(data: bytes) -> int:
    """Frame count recorded in an MHTS header (no record parsing)."""
    if data[:4] != STREAM_MAGIC:
        raise ValueError("not an MHTS container")
    if len(data) < 8:
        raise ValueError("truncated MHTS container (header incomplete)")
    (count,) = struct.unpack_from("<I", data, 4)
    return count


def iter_stream_frames(data: bytes, config: CodecConfig | None = None,
                       check: bool = False):
    """Decode an MHTS container ONE FRAME AT A TIME (constant memory).

    Yields ``(i, frame, err, recorded_crc)`` per frame: ``err`` is the
    per-block end-bit error vector when ``check`` (Pallas backend), else
    ``None``; ``recorded_crc`` is the frame's recorded source CRC-32
    (0 = absent — the CALLER verifies, so a salvaging consumer can choose
    to skip it). MHTS is the most naturally streamable container in the
    format — every record is a self-contained MHT1 blob — so the reader
    is just this loop; peak memory is one decoded frame, independent of
    stream length. Mixed per-frame predictors (an append of delta2d and
    delta frames) decode per record, exactly like the batch path.

    Reference analog: per-frame self-contained encode,
    ``HuffmanUtil.cpp:1051-1131`` — which only ever decodes one frame
    into memory anyway; this keeps that property at container scale.
    """
    import dataclasses

    cfg = config or CodecConfig()
    geom = None
    for i, (s, h, w, bd, delta, crc) in enumerate(_iter_stream_records(data)):
        if geom is None:
            geom = (h, w, bd, delta)
        elif geom != (h, w, bd, delta):
            raise ValueError("MHTS frames must share geometry")
        fcfg = dataclasses.replace(cfg, block_dim=bd, delta=delta,
                                   delta2d=s.predictor == "2d")
        if check:
            if cfg.backend != "pallas":
                raise ValueError(
                    "the end-bit integrity check needs the Pallas backend")
            prep = prepare_shared(s, 1, h, w, fcfg, check=True)
            img, err = decode_shared_step_checked(prep, fcfg)
            yield i, np.asarray(img).reshape(h, w), np.asarray(err), crc
        elif cfg.backend == "native":
            img = decode_frames_segmented([(s, 1)], h, w, fcfg)
            yield i, img.reshape(h, w), None, crc
        else:
            codec = ImageCodec(fcfg)
            img = np.asarray(codec.decode_step(codec.prepare(s, h, w)))
            yield i, img, None, crc


@dataclass(frozen=True)
class PreparedBatch:
    """Device-resident batch decode inputs (frame axis leading)."""

    height: int
    width: int
    n_blocks: int  # per frame (unpadded)
    words_per_row: int
    words_b: jnp.ndarray  # (T, n_words) uint32
    offsets_b: jnp.ndarray  # (T, nb_padded) int32
    t1_b: jnp.ndarray  # (T, 2^k1) int32
    t2_b: jnp.ndarray  # (T, t2_size) int32
    #: (T, n_blocks) uint8 zero-init root bytes; None when no stream in the
    #: batch carries block_init
    init_b: jnp.ndarray | None = None


def prepare_batch(
    streams: list[container.EncodedStream],
    height: int,
    width: int,
    config: CodecConfig | None = None,
    pad_blocks_to: int = 1,
) -> PreparedBatch:
    """Stage a batch of same-geometry streams as stacked padded device arrays.

    Word counts and T2 sizes are padded to the batch max (rounded up to a
    power of two to bound recompiles across batches).
    """
    cfg = config or CodecConfig()
    if len({s.predictor for s in streams}) > 1:
        raise ValueError(
            "batched decode needs one predictor across the batch (the mode "
            "is a static kernel parameter); decode mixed-predictor frames "
            "individually (ImageCodec) or regroup by predictor")
    prepared = [decode_xla.prepare_stream(s) for s in streams]
    wpr = max(p[2] for p in prepared)
    prepared = [decode_xla.prepare_stream(s, width=wpr) for s in streams]

    def pow2(n: int) -> int:
        p = 1
        while p < n:
            p *= 2
        return p

    n_words = pow2(max(p[0].size for p in prepared))
    nb = max(s.block_offsets.size for s in streams)
    nb_padded = nb + ((-nb) % pad_blocks_to)

    tables = [
        decode_xla.prepare_tables(s.widths, cfg.table1_bits, cfg.table2_bits)
        for s in streams
    ]
    t2_size = pow2(max(t2.size for _, t2 in tables))

    T = len(streams)
    words_b = np.zeros((T, n_words), np.uint32)
    offs_b = np.zeros((T, nb_padded), np.int32)
    t1_b = np.stack([t1 for t1, _ in tables])
    t2_b = np.zeros((T, t2_size), np.int32)
    for i, (w, o, _) in enumerate(prepared):
        words_b[i, : w.size] = w
        offs_b[i, : o.size] = o
        t2_b[i, : tables[i][1].size] = tables[i][1]
    init_b = None
    if any(s.block_init is not None for s in streams):
        # zero-init streams: stage the uncoded root bytes for the decode
        # fold (a frame without block_init contributes zeros = no-op)
        init_b = np.zeros((T, nb), np.uint8)
        for i, s in enumerate(streams):
            if s.block_init is not None:
                init_b[i, : s.block_init.size] = s.block_init
        init_b = jnp.asarray(init_b)
    return PreparedBatch(
        height, width, nb, wpr,
        jnp.asarray(words_b), jnp.asarray(offs_b), jnp.asarray(t1_b),
        jnp.asarray(t2_b), init_b,
    )


@partial(jax.jit, static_argnames=("width", "num_steps", "delta", "delta2d", "height_px", "width_px", "n_blocks", "block_dim"))
def _decode_batch_jit(words_b, offsets_b, t1_b, t2_b, *, width, num_steps, delta,
                      height_px, width_px, n_blocks, block_dim, delta2d=False):
    def per_frame(words, offsets, t1, t2):
        rows, bit_init = layout_mod.build_layout_jax(words, offsets, width)
        blk = decode_xla.decode_blocks(
            rows, bit_init, t1, t2, num_steps=num_steps, delta=delta
        )[:n_blocks]
        if delta2d:
            blk = delta_mod.delta2d_decode_blocks_jax(blk, block_dim)
        return blocks.blocks_to_image_jax(blk, height_px, width_px, block_dim)

    return jax.vmap(per_frame)(words_b, offsets_b, t1_b, t2_b)


def decode_batch(prep: PreparedBatch, config: CodecConfig | None = None):
    """Single-device batched decode -> (T, H, W) uint8 device array."""
    cfg = config or CodecConfig()
    out = _decode_batch_jit(
        prep.words_b, prep.offsets_b, prep.t1_b, prep.t2_b,
        width=prep.words_per_row, num_steps=cfg.block_size,
        delta=cfg.delta and not cfg.delta2d, delta2d=cfg.delta2d,
        height_px=prep.height, width_px=prep.width, n_blocks=prep.n_blocks,
        block_dim=cfg.block_dim,
    )
    if prep.init_b is not None:
        out = _apply_init_frames_jit(
            out, prep.init_b, block_dim=cfg.block_dim,
            height=prep.height, width=prep.width)
    return out


def decode_batch_sharded(prep: PreparedBatch, mesh=None,
                         config: CodecConfig | None = None):
    """Sharded batched decode on a ``data x seq`` mesh -> (T, nb, 64) blocks.

    Frames shard over ``data``; block ranges over ``seq``. Returns decoded
    blocks (not images) sharded in stream order; crop to ``prep.n_blocks``
    and reassemble with ``core.blocks.blocks_to_image`` per frame.
    """
    cfg = config or CodecConfig()
    if mesh is None:
        mesh = mesh_mod.make_mesh_2d()
    out = shard_decode.decode_frames_sharded(
        prep.words_b, prep.offsets_b, prep.t1_b, prep.t2_b,
        mesh=mesh, width=prep.words_per_row, num_steps=cfg.block_size,
        delta=cfg.delta and not cfg.delta2d,
    )
    if cfg.delta2d:
        # invert the 2-D predictor on the (T, nb, 64) residual blocks before
        # the zero-init fold (root bytes propagate additively through both
        # prefix sums, so folding after reconstruction stays exact)
        out = delta_mod.delta2d_decode_blocks_jax(out, cfg.block_dim)
    if prep.init_b is not None:
        # fold zero-init roots into the padded block batch (pad blocks get 0)
        pad = out.shape[1] - prep.init_b.shape[1]
        init = jnp.pad(prep.init_b, ((0, 0), (0, pad))) if pad else prep.init_b
        out = out + init[:, :, None].astype(out.dtype)
    return out

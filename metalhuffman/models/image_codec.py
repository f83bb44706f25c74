"""Grayscale image codec: the flagship end-to-end pipeline.

Mirrors the reference's full data flow (SURVEY.md section 0): image -> zero
padded 8x8 blocks (``Util.m:233-323``) -> per-block signed-byte delta
(``AAPLRenderer.m:432-515``) -> canonical Huffman bitstream + per-block bit
offsets (``HuffmanUtil.cpp:1051-1131``) -> device decode -> inverse reorder ->
image, with the byte-exact verification the reference runs in its capture path
(``AAPLRenderer.m:1849-1876``).

The device decode is either the Hopper kernel (``ops.decode_pallas``) or the
plain XLA path (``ops.decode_xla``), selected by config. Decoding is
split into a host ``prepare`` step (done once per stream — the analog of the
reference's buffer upload, ``AAPLRenderer.m:577-667``) and a jitted device
step that can run every "frame".
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import native
from ..core import bitstream, blocks, container
from ..ops import decode_pallas, decode_xla, layout as layout_mod


@dataclass(frozen=True)
class CodecConfig:
    """Framework configuration (replaces the reference's compile-time #defines
    in ``AAPLShaderTypes.h:109-123`` and comment-toggled settings)."""

    block_dim: int = 8  # HUFF_BLOCK_DIM (reference: AAPLShaderTypes.h:112)
    delta: bool = True  # IMPL_DELTAS_BEFORE_HUFF_ENCODING (:109)
    #: IMPL_DELTAS_AND_INIT_ZERO_DELTA_BEFORE_HUFF_ENCODING (:110): each
    #: block's root byte ships uncoded in a side array and its stream slot
    #: becomes a zero delta (requires delta=True)
    zero_init: bool = False
    #: beyond-reference 2-D within-block predictor (row 0 delta-left,
    #: rows 1.. delta-up; ``core.delta.delta2d_encode_blocks``): ~3 entropy
    #: points smaller than the raster delta on photographic content, still
    #: block-parallel. Requires delta=True; composes with zero_init.
    delta2d: bool = False
    #: beyond-reference temporal (inter-frame) prediction for video: frames
    #: become mod-256 residuals vs the previous frame, with a literal
    #: keyframe every ``keyint`` (``models.temporal``, MHVT wrapper).
    #: Applies to the video encode surfaces only; decode auto-detects.
    temporal: bool = False
    keyint: int = 8  #: keyframe interval (bounds random-access decode work)
    #: with temporal: per-frame global motion compensation — the predictor
    #: is the previous frame circularly shifted by an estimated integer
    #: (dy, dx) (exactly invertible, so still lossless); cancels panning
    motion: bool = False
    #: record a per-frame CRC-32 table in video containers (MHVT flag bit 1;
    #: MHTV/MHV2 FCRC extension trailer) so RANDOM ACCESS (--frame / range
    #: decode) verifies exactly the frames it touches — the whole-payload
    #: CRC cannot cover a slice. Costs 4 bytes/frame.
    frame_crcs: bool = False
    table1_bits: int = 8  # HUFF_TABLE1_NUM_BITS (:120)
    table2_bits: int = 8  # HUFF_TABLE2_NUM_BITS (:121)
    #: 'pallas' (the decode kernel: compiled on a GPU, interpreted on a
    #: CPU) | 'xla' (plain XLA) | 'native' (host C++)
    backend: str = "pallas"

    @property
    def block_size(self) -> int:
        return self.block_dim * self.block_dim


@dataclass(frozen=True)
class PreparedFrame:
    """Device-resident decode inputs for one encoded frame."""

    height: int
    width: int
    n_blocks: int
    words_per_row: int
    device_args: tuple  # backend-specific jnp arrays
    stream: container.EncodedStream


class ImageCodec:
    """Encode/decode grayscale images with device-parallel Huffman decode."""

    def __init__(self, config: CodecConfig | None = None):
        self.config = config or CodecConfig()

    # -- encode (host) ------------------------------------------------------

    def encode(self, img: np.ndarray) -> container.EncodedStream:
        """Image -> blocked+delta'd canonical Huffman stream.

        With ``config.zero_init`` each block's root byte moves to the
        stream's uncoded ``block_init`` side array and its stream slot
        becomes a zero delta (the reference's compile-time
        ``IMPL_DELTAS_AND_INIT_ZERO_DELTA_BEFORE_HUFF_ENCODING`` variant).
        """
        cfg = self.config
        blk = blocks.image_to_blocks(img, cfg.block_dim).ravel()
        if not cfg.delta:
            if cfg.zero_init or cfg.delta2d:
                raise ValueError("zero_init/delta2d require delta precoding")
            return native.encode_symbols(blk, block_size=cfg.block_size)
        from ..core import delta as delta_mod

        predictor = "left"
        if cfg.delta2d:
            predictor = "2d"
            payload = native.delta2d_encode(blk, cfg.block_dim)
        else:
            payload = native.delta_encode(blk, cfg.block_size)
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

    def encode_best(self, img: np.ndarray):
        """Encode with and without delta precoding, keep the smaller stream.

        The reference fixes delta at compile time
        (``IMPL_DELTAS_BEFORE_HUFF_ENCODING``); delta helps smooth content
        and hurts noise-like content, so measuring both (encode is cheap)
        always wins. Returns (stream, delta_used) — pair with a codec whose
        config matches ``delta_used`` for decoding, or rely on the container
        flag.
        """
        from dataclasses import replace as dc_replace

        from ..core import delta as delta_mod

        cfg = self.config
        blk = blocks.image_to_blocks(img, cfg.block_dim).ravel()
        plain = native.encode_symbols(blk, block_size=cfg.block_size)
        deltas = native.encode_symbols(
            native.delta_encode(blk, cfg.block_size),
            block_size=cfg.block_size,
        )
        d2 = dc_replace(
            native.encode_symbols(
                native.delta2d_encode(blk, cfg.block_dim),
                block_size=cfg.block_size),
            predictor="2d")
        best = min((plain, deltas, d2), key=lambda s: s.compressed_size)
        return best, best is not plain

    def encode_to_bytes(self, img: np.ndarray) -> bytes:
        """Image -> on-disk MHT1 container (records a source CRC-32)."""
        import zlib

        h, w = img.shape
        return container.write_frame(
            self.encode(img), h, w, self.config.block_dim, self.config.delta,
            source_crc32=zlib.crc32(np.ascontiguousarray(img).tobytes()),
        )

    # -- decode (device) ----------------------------------------------------

    def prepare(
        self, stream: container.EncodedStream, height: int, width: int
    ) -> PreparedFrame:
        """Stage a stream's decode inputs on device (upload analog)."""
        cfg = self.config
        total_bits = 8 * (stream.code_bytes.size - bitstream.READ_AHEAD_PAD_BYTES)
        wpr = layout_mod.words_per_block(
            layout_mod.max_block_bits(stream.block_offsets, total_bits),
            symbols_per_block=cfg.block_size,
        )
        words = bitstream.bytes_to_be_words(stream.code_bytes, pad_words=wpr)
        nb = int(stream.block_offsets.size)
        if cfg.backend == "pallas":
            args = decode_pallas.prepare_stream(
                stream, cfg.table1_bits, cfg.table2_bits)
        elif cfg.backend == "xla":
            t1, t2 = decode_xla.prepare_tables(
                stream.widths, cfg.table1_bits, cfg.table2_bits
            )
            rows, bit_init = layout_mod.build_layout_jax(
                jnp.asarray(words),
                jnp.asarray(stream.block_offsets.astype(np.int32)),
                wpr,
            )
            args = (rows, bit_init, jnp.asarray(t1), jnp.asarray(t2))
        elif cfg.backend == "native":
            # host C++ decoder needs no device staging
            return PreparedFrame(height, width, nb, wpr, (), stream)
        else:
            raise ValueError(f"unknown backend {self.config.backend!r}")
        args = tuple(jax.device_put(jnp.asarray(a)) for a in args)
        return PreparedFrame(height, width, nb, wpr, args, stream)

    def decode_step(self, prep: PreparedFrame):
        """Jitted device decode: PreparedFrame -> (H, W) uint8 device image.

        This is the per-frame hot path (the analog of the reference's
        ``drawInMTKView:`` 7-pass chain, collapsed into one fused program).
        """
        cfg = self.config
        init = prep.stream.block_init
        if cfg.backend == "native":
            from ..core import delta as delta_mod

            # delta2d reconstructs inside the C++ per-block loop (mode 2)
            blk = native.decode_blocks(
                prep.stream, delta=cfg.delta and not cfg.delta2d,
                block_size=cfg.block_size, delta2d=cfg.delta2d,
            )
            if init is not None:
                blk = delta_mod.apply_block_init(blk, init)
            return blocks.blocks_to_image(
                blk, prep.height, prep.width, cfg.block_dim
            )
        out = _decode_step_jit(
            prep.device_args,
            backend=cfg.backend,
            height=prep.height,
            width=prep.width,
            n_blocks=prep.n_blocks,
            block_dim=cfg.block_dim,
            delta=cfg.delta and not cfg.delta2d,
            delta2d=cfg.delta2d,
            words_per_row=prep.words_per_row,
            k1=cfg.table1_bits,
            k2=cfg.table2_bits,
        )
        if init is not None:
            # prev-init equivalence: add each block's root byte to the whole
            # block mod 256 (one fused broadcast add on device)
            out = _apply_init_image_jit(
                out, jnp.asarray(init), block_dim=cfg.block_dim,
                height=prep.height, width=prep.width)
        return out

    def decode(self, data: bytes | container.EncodedStream, height=None, width=None):
        """Host convenience: container bytes (or stream) -> (H, W) uint8.

        For container input the header's recorded block_dim/delta are
        authoritative (they travel with the stream); the codec config only
        chooses the decode backend. Raw-stream input uses the config as-is.
        """
        crc = 0
        codec = self
        if isinstance(data, (bytes, bytearray, memoryview)):
            stream, height, width, block_dim, use_delta, crc = container.read_frame(
                bytes(data)
            )
            use_2d = stream.predictor == "2d"
            if (block_dim != self.config.block_dim
                    or use_delta != self.config.delta
                    or use_2d != self.config.delta2d):
                codec = ImageCodec(replace(
                    self.config, block_dim=block_dim, delta=use_delta,
                    delta2d=use_2d))
        else:
            stream = data
            if height is None or width is None:
                raise ValueError("height/width required when passing a raw stream")
        prep = codec.prepare(stream, height, width)
        out = np.asarray(codec.decode_step(prep))
        if crc:
            import zlib

            if zlib.crc32(out.tobytes()) != crc:
                raise ValueError(
                    "decoded image fails the container's source CRC-32 "
                    "(corrupt stream or decoder mismatch)"
                )
        return out

    def decode_region(
        self,
        stream: container.EncodedStream,
        height: int,
        width: int,
        y0: int,
        x0: int,
        rh: int,
        rw: int,
        check: bool = False,
    ) -> np.ndarray:
        """Decode only the blocks covering a region of interest.

        Random access is exactly what the per-block offset index buys
        (the reference's crop shaders re-crop a fully decoded texture,
        ``AAPLShaders.metal:108-123``; here we never decode the rest).
        The selected blocks ride the SAME decode path as a full frame —
        the decode kernel on the pallas backend (the selection is just a
        shorter offset index; the kernel never knows it's a crop), the
        multithreaded C++ decoder on native, the portable XLA path
        otherwise. Returns the (rh, rw) uint8 crop.

        With ``check`` the end-bit integrity check verifies exactly the
        touched blocks (the device analog of the reference's
        verify-what-you-render assert, ``AAPLRenderer.m:1849-1876``) and
        raises ValueError on corruption — whole-payload CRCs cannot cover
        a crop, so this is the ROI integrity surface.
        """
        cfg = self.config
        bd = cfg.block_dim
        bh, bw = blocks.block_grid(height, width, bd)
        by0, bx0 = y0 // bd, x0 // bd
        by1, bx1 = (y0 + rh - 1) // bd + 1, (x0 + rw - 1) // bd + 1
        if not (0 <= y0 and y0 + rh <= height and 0 <= x0 and x0 + rw <= width):
            raise ValueError("region out of bounds")
        sel = (
            np.arange(by0, by1)[:, None] * bw + np.arange(bx0, bx1)[None, :]
        ).ravel()
        gh, gw = (by1 - by0) * bd, (bx1 - bx0) * bd  # region block grid px
        oy, ox = y0 - by0 * bd, x0 - bx0 * bd
        if check:
            region, err = decode_blocks_selection(
                stream, sel, gh, gw, cfg, check=True)
            if err.any():
                bad = sel[err]
                raise ValueError(
                    f"region integrity check failed: {int(err.sum())} of "
                    f"{sel.size} touched blocks corrupt (first at block "
                    f"row {int(bad[0]) // bw}, col {int(bad[0]) % bw})")
        else:
            region = decode_blocks_selection(stream, sel, gh, gw, cfg)
        return region[oy : oy + rh, ox : ox + rw]

    def roundtrip_verify(self, img: np.ndarray) -> container.EncodedStream:
        """Encode+decode+byte-compare (reference: ``AAPLRenderer.m:1849-1876``)."""
        stream = self.encode(img)
        out = self.decode(stream, *img.shape)
        if not np.array_equal(out, img):
            diff = int(np.sum(out != img))
            raise AssertionError(f"roundtrip mismatch: {diff} bytes differ")
        return stream


def selection_end_targets(stream: container.EncodedStream,
                          sel: np.ndarray) -> np.ndarray:
    """Expected row-local end bit for each SELECTED block -> (n_sel,) int32.

    The offset index pins every block's bit length (next offset minus own
    offset), so a selection's integrity targets need no decode: target =
    ``(offset & 31) + length`` in the rebased row-local coordinates every
    decode path uses. The stream's LAST block has no successor offset; when
    the stream carries no tail symbols its end is window-checked by the
    caller (byte-rounding slack), otherwise it stays -1 = unchecked.
    """
    offs = np.asarray(stream.block_offsets, np.int64)
    nb = offs.size
    sel = np.asarray(sel, np.int64)
    t = np.full(sel.size, -1, np.int32)
    inner = sel < nb - 1
    si = sel[inner]
    t[inner] = ((offs[si] & 31) + (offs[si + 1] - offs[si])).astype(np.int32)
    return t


def _check_selection_ends(stream: container.EncodedStream, sel: np.ndarray,
                          end_bits: np.ndarray,
                          block_size: int) -> np.ndarray:
    """End bits (selection order) vs the offset index -> (n_sel,) bool err."""
    targets = selection_end_targets(stream, sel)
    end = np.asarray(end_bits, np.int64).reshape(-1)[: sel.size]
    err = (end != targets) & (targets >= 0)
    window = decode_pallas.last_block_window(stream, block_size)
    if window is not None:
        # the last block's end is known only up to byte rounding
        lo, hi = window
        last = stream.block_offsets.size - 1
        for p in np.flatnonzero(np.asarray(sel) == last):
            err[p] = not lo <= int(end[p]) <= hi
    return err


def decode_blocks_selection(stream: container.EncodedStream,
                            sel: np.ndarray, gh: int, gw: int,
                            cfg: CodecConfig, check: bool = False):
    """Decode an arbitrary SELECTION of a stream's blocks -> (gh, gw) uint8.

    ``sel`` indexes ``stream.block_offsets`` in the row-major order of the
    (gh//bd, gw//bd) output grid. The selection rides the SAME decode path
    as a full frame per backend (the Pallas kernel treats it as just a
    shorter offset index), and device staging uploads only the word range
    the selected blocks can touch. This is the engine under every
    random-access surface: spatial ROI (``ImageCodec.decode_region``) and
    the spatio-temporal video ROI (``frame_stream.decode_video_region``).

    With ``check`` the per-block end-bit integrity check covers exactly the
    touched blocks and the return becomes ``(image, err_mask)`` with
    ``err_mask`` (n_sel,) bool in selection order: on the device backends
    the kernel's end-bit output is compared against the offset index
    (``ops.decode_pallas`` integrity machinery); on the native backend the
    consumed bit count is re-derived on host by re-applying the forward
    precoder to the decoded blocks (the canonical code is prefix-free, so
    re-encoding the decoded symbols reproduces the decoder's exact end
    position — the same check, computed from the other side).
    """
    from ..core import delta as delta_mod

    bd = cfg.block_dim
    sub_offsets = stream.block_offsets[sel]
    sub_init = (None if stream.block_init is None
                else stream.block_init[sel])
    kdelta = cfg.delta and not cfg.delta2d

    if cfg.backend == "native":
        sub = container.EncodedStream(
            sel.size * cfg.block_size, stream.widths, stream.code_bytes,
            sub_offsets.astype(np.uint32), predictor=stream.predictor)
        blk = native.decode_blocks(
            sub, delta=kdelta, block_size=cfg.block_size,
            delta2d=cfg.delta2d)
        err = None
        if check:
            if kdelta:
                raw = native.delta_encode(blk.ravel(), cfg.block_size)
            elif cfg.delta2d:
                raw = native.delta2d_encode(blk.ravel(), bd)
            else:
                raw = blk.ravel()
            bits = (stream.widths[raw].reshape(sel.size, cfg.block_size)
                    .astype(np.int64).sum(axis=1))
            end = (sub_offsets.astype(np.int64) & 31) + bits
            err = _check_selection_ends(stream, sel, end, cfg.block_size)
        if sub_init is not None:
            blk = delta_mod.apply_block_init(blk, sub_init)
        img = blocks.blocks_to_image(blk, gh, gw, bd)
        return (img, err) if check else img

    total_bits = 8 * (stream.code_bytes.size - bitstream.READ_AHEAD_PAD_BYTES)
    wpr = layout_mod.words_per_block(
        layout_mod.max_block_bits(stream.block_offsets, total_bits),
        symbols_per_block=cfg.block_size,
    )
    # stage (and CONVERT) only the word range the selected blocks can
    # touch: a crop of a long stream pays neither the whole-stream word
    # conversion nor the upload (the slice is word-aligned, so rebasing
    # offsets by a multiple of 32 bits preserves all //32 and %32 math;
    # bytes_to_be_words zero-pads past the slice exactly as it pads past
    # the stream end)
    lo_word = int(sub_offsets.min()) // 32
    hi_word = int(sub_offsets.max()) // 32 + wpr + 1
    words = bitstream.bytes_to_be_words(
        stream.code_bytes[4 * lo_word : 4 * hi_word], pad_words=wpr)
    sub_offsets = (sub_offsets.astype(np.int64) - 32 * lo_word).astype(
        np.int32)
    t1, t2 = decode_xla.prepare_tables(
        stream.widths, cfg.table1_bits, cfg.table2_bits)
    if cfg.backend == "pallas":
        device_args = (jnp.asarray(words), jnp.asarray(sub_offsets),
                       jnp.asarray(t1), jnp.asarray(t2))
    else:
        rows, bit_init = layout_mod.build_layout_jax(
            jnp.asarray(words), jnp.asarray(sub_offsets), wpr)
        device_args = (rows, bit_init, jnp.asarray(t1), jnp.asarray(t2))
    out = _decode_step_jit(
        device_args, backend=cfg.backend, height=gh, width=gw,
        n_blocks=int(sel.size), block_dim=bd, delta=kdelta,
        delta2d=cfg.delta2d, words_per_row=wpr, emit_end=check,
        k1=cfg.table1_bits, k2=cfg.table2_bits,
    )
    err = None
    if check:
        out, end_bits = out
        err = _check_selection_ends(
            stream, sel, np.asarray(end_bits), cfg.block_size)
    if sub_init is not None:
        out = _apply_init_image_jit(
            out, jnp.asarray(sub_init), block_dim=bd, height=gh, width=gw)
    return (np.asarray(out), err) if check else np.asarray(out)


@partial(jax.jit, static_argnames=("block_dim", "height", "width"))
def _apply_init_image_jit(img, init, *, block_dim, height, width):
    """Fold zero-init root bytes into a decoded image (mod-256 add)."""
    bh = -(-height // block_dim)
    bw = -(-width // block_dim)
    init_img = jnp.repeat(
        jnp.repeat(init.reshape(bh, bw), block_dim, 0), block_dim, 1
    )[:height, :width]
    return ((img.astype(jnp.int32) + init_img.astype(jnp.int32)) & 0xFF
            ).astype(jnp.uint8)


@partial(
    jax.jit,
    static_argnames=(
        "backend", "height", "width", "n_blocks", "block_dim", "delta",
        "delta2d", "words_per_row", "emit_end", "k1", "k2",
    ),
)
def _decode_step_jit(
    device_args, *, backend, height, width, n_blocks, block_dim, delta,
    words_per_row=0, delta2d=False, emit_end=False, k1=8, k2=8
):
    """Device decode -> (H, W) image of a ``n_blocks`` block grid; with
    ``emit_end`` also the per-block row-local end bits ((n_blocks,) int32,
    stream order) for the integrity check."""
    block_size = block_dim * block_dim
    end_bits = None
    if backend == "pallas":
        words, offsets, t1, t2 = device_args
        if decode_pallas.raw_words_ok(block_dim):
            # the kernel writes image words and reconstructs delta2d in
            # registers: only a byte view and a crop remain
            rows_pf, w_pad = decode_pallas.padded_geometry(
                height, width, block_dim)
            out = decode_pallas.decode(
                words, offsets, t1, t2, block_dim=block_dim, delta=delta,
                delta2d=delta2d, grid_bw=w_pad // block_dim,
                emit_end_bits=emit_end, k1=k1, k2=k2)
            if emit_end:
                out, end_bits = out
            img = decode_pallas.images_from_words(
                out, 1, height, width, block_dim)[0]
            return (img, end_bits) if emit_end else img
        blk = decode_pallas.decode(
            words, offsets, t1, t2, block_dim=block_dim, delta=delta,
            emit_end_bits=emit_end, k1=k1, k2=k2)
        if emit_end:
            blk, end_bits = blk
        blk = decode_pallas.blocks_from_words(blk, block_size)
    else:
        rows, bit_init, t1, t2 = device_args
        blk = decode_xla.decode_blocks(
            rows, bit_init, t1, t2, num_steps=block_size, delta=delta,
            k2=k2, emit_end_bits=emit_end,
        )
        if emit_end:
            blk, end = blk
            end_bits = end[:n_blocks]
        blk = blk[:n_blocks]
    if delta2d:
        from ..core import delta as delta_mod

        blk = delta_mod.delta2d_decode_blocks_jax(blk, block_dim)
    img = blocks.blocks_to_image_jax(blk, height, width, block_dim)
    return (img, end_bits) if emit_end else img

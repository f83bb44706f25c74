"""Temporal (inter-frame) prediction for video: the MHVT wrapper container.

Every other video container codes each frame independently, but real video
is temporally redundant — consecutive frames differ in a few pixels. This
module adds the missing prediction axis: frame ``t`` is stored as its
byte-wise difference from frame ``t-1`` (mod 256/65536), with a literal
KEYFRAME every ``keyint`` frames so temporal random access stays bounded
(decoding frame ``n`` touches at most ``keyint`` residual frames — the
video-codec I-frame/P-frame structure, reduced to its lossless byte form).

The reference has no temporal model at all — its "video" story is decoding
the same still frame at 30 FPS (``AAPLRenderer.m:1178-1924``); this is a
beyond-reference capability like delta2d and the MHTC color planes.

Why a wrapper and not a new stream mode: the residual frames are ordinary
byte frames, so they ride the ENTIRE existing stack unchanged — shared-table
MHTV/MHV2 streams, the Pallas decode kernel, spatial precoders (delta /
delta2d compose with temporal residuals and ``--best`` measures them on the
actual residual payload), MHTC color/16-bit planes, segmenting, integrity
checks. On disk::

    "MHVT" | u16 keyint | u16 flags | u32 inner_len
           | [flags bit 2: u64 inner_len (the u32 field is 0) — >4 GiB]
           | [flags bit 3: u16 first_len — SHORT first keyframe group]
           | [flags bit 0: u32 T + T x (i16 dy, i16 dx) motion table]
           | [flags bit 1: u32 T + T x u32 per-TRUE-frame CRC-32 table]
           | inner video container (MHTV / MHV2 / MHTC video)
           | u32 source_crc32 of the TRUE frames (0 = unrecorded)

With flags bit 4 (STREAMING/trailer layout, written by
:class:`~.stream_writer.TemporalStreamingEncoder`) the u64 inner length
always follows the header (u32 field reads 0; INNER64 must not combine)
and the motion/frame-CRC tables move AFTER the inner, before the source
CRC — so the header can be laid down before the stream's length, vectors,
or CRCs exist and only the u64 is back-patched. Both layouts parse
through :func:`unwrap`.

Flags bit 0 marks global motion compensation (circular-shift predictors,
see below); bit 1 marks a per-frame CRC table that lets RANDOM ACCESS
(``decode_temporal_frame`` / ``decode_temporal_range``) verify exactly the
frames it reconstructs — the whole-payload CRCs cannot cover a slice.
Bit 2 stores the inner length as a u64 following the header (written only
when the inner exceeds the u32 field — MHV2 segmenting lifts the per-
segment cap, this lifts the wrapper's). Bit 3 records that the FIRST
keyframe group is shorter than ``keyint`` (``u16 first_len`` frames):
``surgery.extract_video`` starting mid-group re-encodes only that group
(frame ``a`` becomes a literal keyframe) and splices every later group
losslessly — the recorded first_len keeps the fold's group boundaries
aligned with the original keyframes. Files written without these flags
parse exactly as before.

The inner container's own CRC covers the residual payload (stream
integrity); the outer CRC additionally pins the reconstruction parameters
(a corrupted ``keyint`` would reconstruct wrong frames from valid
residuals).

Reconstruction is a per-group cumulative byte sum — mod-2^8/2^16 addition is
associative, so it vectorizes (``np.cumsum`` with a wrapping accumulator
dtype on the host, group-reshaped ``jnp.cumsum`` on device) and never
re-serializes the block-parallel Huffman decode.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

from .image_codec import CodecConfig

TEMPORAL_MAGIC = b"MHVT"

_HEADER = "<HHI"  # keyint, flags, inner_len
_HEADER_SIZE = 4 + struct.calcsize(_HEADER)

FLAG_MOTION = 1  #: header flag: per-frame global motion vectors present
#: header flag: per-TRUE-frame CRC-32 table present (lets random access
#: verify exactly the frames it reconstructs — the whole-payload CRCs
#: cannot cover a slice)
FLAG_FRAME_CRCS = 2
#: header flag: u64 inner length follows the header (u32 field is 0) —
#: written only for inners beyond 4 GiB, so older files are unchanged
FLAG_INNER64 = 4
#: header flag: u16 first-keyframe-group length follows (< keyint) —
#: written by arbitrary-start ``surgery.extract_video``, whose re-keyed
#: first group is shorter than keyint while later groups splice losslessly
FLAG_FIRST_LEN = 8
#: header flag: STREAMING (trailer) layout — a u64 inner length follows
#: the header (the u32 field reads 0, patched by the streaming writer on
#: close) and the motion / frame-CRC tables sit AFTER the inner, before
#: the source CRC. This is what lets ``TemporalStreamingEncoder`` lay the
#: header down before the stream's length, vectors, or CRCs exist: the
#: only field it back-patches is the u64. Mutually exclusive with
#: FLAG_INNER64 (the trailer layout always carries the u64).
FLAG_TRAILER = 16
_KNOWN_FLAGS = (FLAG_MOTION | FLAG_FRAME_CRCS | FLAG_INNER64
                | FLAG_FIRST_LEN | FLAG_TRAILER)


def _group_start(i: int, keyint: int, first_len: int) -> int:
    """Index of the keyframe opening the group containing frame ``i``
    (keyframes sit at 0, first_len, first_len + keyint, ...)."""
    if i < first_len:
        return 0
    return first_len + ((i - first_len) // keyint) * keyint


# -- the transform (container-independent) ------------------------------------


def temporal_encode(frames: np.ndarray, keyint: int = 8) -> np.ndarray:
    """(T, ...) unsigned frames -> residuals: keyframes literal, the rest
    byte-wise ``frame[t] - frame[t-1]`` (wrapping mod 2^bits).

    Works on any unsigned integer stack — (T, H, W) u8 grayscale,
    (T, H, W, C) u8 color, (T, H, W) u16 — because wrapping subtraction is
    exactly invertible per element regardless of layout.
    """
    frames = np.asarray(frames)
    if frames.ndim < 3:
        raise ValueError("frames must be (T, H, W[, C])")
    if frames.dtype not in (np.uint8, np.uint16):
        raise ValueError("temporal prediction needs uint8/uint16 frames")
    if keyint < 1:
        raise ValueError("keyint must be >= 1")
    res = frames.copy()
    res[1:] -= frames[:-1]  # unsigned wraparound IS the mod-2^bits residual
    res[keyint::keyint] = frames[keyint::keyint]  # literal keyframes
    return res


def temporal_decode(residuals: np.ndarray, keyint: int = 8,
                    first_len: int | None = None) -> np.ndarray:
    """Inverse of :func:`temporal_encode`: per-group cumulative wrapping sum.

    Accumulated frame-by-frame with vectorized wrapping adds — NOT
    ``np.cumsum``, whose uint8 accumulator path is ~10x slower (0.09 vs up
    to 2 GB/s measured on a 94 MB batch; in-place ``np.add(out=)`` into the
    destination views also measured several times slower than fresh temps).

    ``first_len`` (default ``keyint``) is the length of the FIRST keyframe
    group — arbitrary-start extraction re-keys only that group, so its
    keyframes sit at 0, first_len, first_len + keyint, ...
    """
    residuals = np.asarray(residuals)
    if keyint < 1:
        raise ValueError("keyint must be >= 1")
    fl = keyint if first_len is None else first_len
    out = np.empty_like(residuals)
    for i in range(residuals.shape[0]):
        key = i == 0 or (i >= fl and (i - fl) % keyint == 0)
        out[i] = residuals[i] if key else (out[i - 1] + residuals[i])
    return out


def temporal_decode_jax(residuals, keyint: int = 8,
                        first_len: int | None = None):
    """Device-resident reconstruction: group-reshaped ``jnp.cumsum``.

    Pads T to a keyint multiple, scans each (G, keyint, ...) group along the
    group axis in the wrapping dtype, and crops. This is the production fold
    for device decode (:func:`decode_temporal_video` routes through it when
    the inner decode lands on a device); :func:`temporal_decode` is the host
    fold the native backend uses. The reference folds its (spatial) delta
    prediction on the accelerator too (``AAPLShaders.metal:260-265``) —
    reconstruction belongs next to the decode, not across a host transfer.

    A short first group (``first_len < keyint``, from arbitrary-start
    extraction) is handled by FRONT-padding with zero frames: zeros
    accumulate to nothing, so the literal first frame lands where the
    standard group reshape expects a keyframe.
    """
    import jax
    import jax.numpy as jnp

    if keyint < 1:
        raise ValueError("keyint must be >= 1")
    t = residuals.shape[0]
    front = (keyint - first_len) % keyint if first_len else 0
    pad = (-(t + front)) % keyint
    x = jnp.pad(residuals,
                [(front, pad)] + [(0, 0)] * (residuals.ndim - 1))
    grp = x.reshape((x.shape[0] // keyint, keyint) + x.shape[1:])

    # fori over the group axis (keyint-1 single-slot wrapping adds) — the
    # same shape as the packed-word fold; dtype-generic, wraps in the
    # input dtype
    def body(i, acc):
        prev = jax.lax.dynamic_index_in_dim(acc, i - 1, 1, keepdims=False)
        cur = jax.lax.dynamic_index_in_dim(acc, i, 1, keepdims=False)
        return jax.lax.dynamic_update_index_in_dim(acc, prev + cur, i, 1)

    out = jax.lax.fori_loop(1, keyint, body, grp)
    return out.reshape((-1,) + x.shape[1:])[front : front + t]


def _swar_add8(a, b):
    """Per-byte mod-256 add of packed int32 image words (4 independent byte
    lanes, carries masked off — the classic SWAR add). Lets the temporal
    fold run directly on the kernel's RAW image-word strips, skipping the
    device byte relayout entirely."""
    import jax.numpy as jnp

    lo = jnp.int32(0x7F7F7F7F)
    return ((a & lo) + (b & lo)) ^ ((a ^ b) & ~lo)


def temporal_fold_words_jax(words, keyint: int,
                            first_len: int | None = None):
    """Group fold on PACKED image words: (T, rows, W//4) int32 -> same.

    A ``fori_loop`` of keyint-1 SWAR byte adds, each touching one frame
    slot per group — ~2x(keyint-1)/keyint total memory traffic, where a
    ``lax.associative_scan`` over the same add re-touches the whole array
    in each of its log-depth passes. Operates on the decode kernel's raw
    image words so reconstruction never leaves the packed layout the
    kernel emitted (the production zero-relayout path).
    """
    import jax
    import jax.numpy as jnp

    if keyint < 1:
        raise ValueError("keyint must be >= 1")
    t = words.shape[0]
    front = (keyint - first_len) % keyint if first_len else 0
    pad = (-(t + front)) % keyint
    x = jnp.pad(words, [(front, pad), (0, 0), (0, 0)])
    grp = x.reshape((x.shape[0] // keyint, keyint) + x.shape[1:])

    def body(i, acc):
        prev = jax.lax.dynamic_index_in_dim(acc, i - 1, 1, keepdims=False)
        cur = jax.lax.dynamic_index_in_dim(acc, i, 1, keepdims=False)
        return jax.lax.dynamic_update_index_in_dim(
            acc, _swar_add8(prev, cur), i, 1)

    out = jax.lax.fori_loop(1, keyint, body, grp)
    return out.reshape((-1,) + x.shape[1:])[front : front + t]


def _swar_add8_carry(a, b):
    """Per-byte mod-256 add PLUS the per-lane carry-out (0/1 per byte).

    The carry-out of bit 7 in each lane is ``(a&b) | ((a|b) & ~sum)`` at
    bit 7 (the classic full-adder majority form), shifted down to bit 0 —
    exactly what the u16 plane fold needs to propagate lo-plane overflow
    into the hi plane without ever leaving the packed int32 layout.
    """
    import jax.numpy as jnp
    from jax import lax

    s = _swar_add8(a, b)
    carry = (a & b) | ((a | b) & ~s)
    return s, lax.shift_right_logical(carry, 7) & jnp.int32(0x01010101)


def temporal_fold_plane_words_jax(words, keyint: int, planes_per_frame: int,
                                  first_len: int | None = None):
    """Group fold on PACKED PLANE words: (T*P, rows, W//4) int32 -> same.

    MHTC color streams are frame-major plane stacks (frame t's planes at
    ``[t*P, (t+1)*P)``), so the per-TRUE-frame group fold is the plain
    SWAR word fold with the P planes riding along as extra rows. This is
    sound for any colorspace whose inverse is LINEAR mod 256 (identity
    trivially; sub-green's inverse is ``R=r+G, B=b+G`` — a linear map),
    because a linear map commutes with the wrapping sum: folding the
    stored cs(residual) planes then inverting cs equals inverting cs per
    frame then folding. The payoff is the same as the grayscale words
    fold: 4 bytes per lane instead of one, and no byte relayout before
    the fold.
    """
    tp = words.shape[0]
    if planes_per_frame < 1 or tp % planes_per_frame:
        raise ValueError(
            f"plane stream length {tp} is not a multiple of "
            f"{planes_per_frame} planes per frame")
    t = tp // planes_per_frame
    x = words.reshape(t, planes_per_frame * words.shape[1], words.shape[2])
    out = temporal_fold_words_jax(x, keyint, first_len)
    return out.reshape(tp, words.shape[1], words.shape[2])


def temporal_fold_u16_words_jax(words, keyint: int,
                                first_len: int | None = None):
    """Group fold mod 65536 on hi/lo PACKED plane words: (T*2, rows, W//4).

    u16 residuals wrap mod 2^16, so the per-byte fold is NOT enough: a
    lo-plane overflow must carry into the hi plane. The fold stays in the
    packed int32 layout anyway — each group slot does one SWAR add with
    carry extraction on the lo words (:func:`_swar_add8_carry`) and two
    SWAR adds on the hi words (value + carry), ~3 ops per 8 pixels'
    worth of words. Plane order per frame is [hi, lo], matching
    ``color.encode_gray16_to_bytes``.
    """
    import jax
    import jax.numpy as jnp

    if keyint < 1:
        raise ValueError("keyint must be >= 1")
    tp = words.shape[0]
    if tp % 2:
        raise ValueError("u16 plane stream needs hi/lo pairs")
    t = tp // 2
    rows, wpw = words.shape[1], words.shape[2]
    front = (keyint - first_len) % keyint if first_len else 0
    pad = (-(t + front)) % keyint
    x = words.reshape(t, 2, rows, wpw)
    x = jnp.pad(x, [(front, pad), (0, 0), (0, 0), (0, 0)])
    grp = x.reshape((x.shape[0] // keyint, keyint, 2, rows, wpw))

    def body(i, acc):
        prev = jax.lax.dynamic_index_in_dim(acc, i - 1, 1, keepdims=False)
        cur = jax.lax.dynamic_index_in_dim(acc, i, 1, keepdims=False)
        lo, c = _swar_add8_carry(prev[:, 1], cur[:, 1])
        hi = _swar_add8(_swar_add8(prev[:, 0], cur[:, 0]), c)
        return jax.lax.dynamic_update_index_in_dim(
            acc, jnp.stack([hi, lo], axis=1), i, 1)

    out = jax.lax.fori_loop(1, keyint, body, grp)
    out = out.reshape((-1, 2, rows, wpw))[front : front + t]
    return out.reshape(tp, rows, wpw)


def _col_roll_words(z, s):
    """Circular roll of packed words along the column (word) axis by ``s``
    BYTES over the full packed width: a word roll (s>>2) plus a 0..3-byte
    rotate done with variable shifts against the left-neighbor word — no
    byte-granular relayout anywhere. The ``>>1 >>(31-8r)`` form makes the
    r=0 case a shift by 32 = contribute nothing (int32 shifts past 31 are
    undefined as single ops). Shared by the exact-geometry and padded
    rolls so the rotate logic can never silently diverge."""
    import jax.numpy as jnp
    from jax import lax

    a = jnp.roll(z, lax.shift_right_logical(s, 2), axis=1)
    r8 = (s & 3) << 3
    prev = jnp.roll(a, 1, axis=1)
    return lax.shift_left(a, r8) | lax.shift_right_logical(
        lax.shift_right_logical(prev, 1), 31 - r8)


def _roll_words(frame, dy, dx):
    """Circular (dy, dx) pixel roll of one PACKED frame: (rows, W//4) int32
    little-endian words (pixel 4i+k in bits 8k of word i) — valid when the
    packed extent IS the image extent (no padding)."""
    import jax.numpy as jnp

    return _col_roll_words(jnp.roll(frame, dy, axis=0), dx)


def _roll_words_general(frame, dy, dx, height: int, width: int):
    """``np.roll((H, W) image, (dy, dx))`` on its PADDED packed words.

    The padded generalization of :func:`_roll_words` (which needs the
    exact, unpadded geometry). A
    circular roll over the padded extent would wrap true pixels through
    pad garbage, so each axis composes TWO cheap rolls over the padded
    extent and selects per destination: positions ``>= shift`` read the
    plain roll (their sources are true pixels), positions ``< shift``
    read a second roll offset by the pad amount, which lands exactly the
    true wrap-around pixels there. Rows select with a row-index compare;
    columns select per BYTE lane with a packed 0xFF mask built from four
    lane compares — everything stays in int32 words. ``dy``/``dx`` must
    already be normalized into ``[0, height)`` / ``[0, width)``.

    Pad rows/columns end up holding garbage, which is fine: every true
    destination sources only true pixels (shown above), so garbage never
    crosses into the cropped view.
    """
    import jax.numpy as jnp

    rows_pf, wpw = frame.shape
    w_pad = wpw * 4
    if rows_pf == height and w_pad == width:
        return _roll_words(frame, dy, dx)
    a = jnp.roll(frame, dy, axis=0)
    if rows_pf != height:
        b = jnp.roll(frame, dy + rows_pf - height, axis=0)
        x = jnp.where(jnp.arange(rows_pf)[:, None] < dy, b, a)
    else:
        x = a
    ca = _col_roll_words(x, dx)
    if w_pad == width:
        return ca
    cb = _col_roll_words(x, dx + w_pad - width)
    lanes = jnp.arange(wpw)[:, None] * 4 + jnp.arange(4)[None, :]
    m = jnp.where(lanes < dx, jnp.int32(0xFF), jnp.int32(0))
    mask = m[:, 0] | (m[:, 1] << 8) | (m[:, 2] << 16) | (m[:, 3] << 24)
    return (cb & mask[None, :]) | (ca & ~mask[None, :])


def temporal_fold_words_mc_jax(words, keyint: int, mvs, height: int,
                               width: int, first_len: int | None = None,
                               planes_per_frame: int = 1,
                               carry_u16: bool = False):
    """Motion-compensated group fold on PACKED image words.

    The MC analog of :func:`temporal_fold_words_jax`: the kernel's raw
    strips feed the fold directly — the circular-shift predictor becomes
    a row roll + word roll + byte rotate on int32 words
    (:func:`_roll_words`, or its padded-geometry generalization
    :func:`_roll_words_general`) and the residual add is the SWAR byte
    add, so the whole reconstruction stays in the packed layout the
    kernel emits (no device byte relayout, no per-frame uint8 arrays).

    ``planes_per_frame > 1`` folds an MHTC plane stream (frame-major
    planes; the per-pixel roll applies to every plane identically, and a
    linear colorspace inverse commutes with both the roll and the add —
    see :func:`temporal_fold_plane_words_jax`). ``carry_u16`` treats the
    planes as [hi, lo] pairs and propagates the lo-plane carry into the
    hi plane (``planes_per_frame`` must be 2).

    ``dx`` is normalized mod ``width`` (and dy mod height) so negative or
    out-of-range vectors split into a non-negative word shift + 0..3-byte
    rotate exactly like ``np.roll``'s wrapping.
    """
    import jax
    import jax.numpy as jnp

    if keyint < 1:
        raise ValueError("keyint must be >= 1")
    if carry_u16 and planes_per_frame != 2:
        raise ValueError("carry_u16 needs [hi, lo] plane pairs")
    tp, rows, wpw = words.shape[0], words.shape[1], words.shape[2]
    p = planes_per_frame
    if p < 1 or tp % p:
        raise ValueError(
            f"plane stream length {tp} is not a multiple of {p} planes "
            "per frame")
    t = tp // p
    mvs = jnp.asarray(mvs, jnp.int32)
    if mvs.shape[0] != t:
        raise ValueError(
            "corrupt MHVT container (motion table length disagrees with "
            "the frame count)")
    front = (keyint - first_len) % keyint if first_len else 0
    pad = (-(t + front)) % keyint
    x = words.reshape(t, p, rows, wpw)
    x = jnp.pad(x, [(front, pad), (0, 0), (0, 0), (0, 0)])
    mv = jnp.pad(mvs, ((front, pad), (0, 0)))
    mv = jnp.stack([mv[:, 0] % height, mv[:, 1] % width], axis=1)
    g = x.shape[0] // keyint
    grp = x.reshape((g, keyint) + x.shape[1:])
    mvg = mv.reshape(g, keyint, 2)
    roll_planes = jax.vmap(_roll_words_general,
                           in_axes=(0, None, None, None, None))

    def fold_group(res_g, mv_g):
        def step(prev, inp):
            res_i, mv_i = inp
            pred = roll_planes(prev, mv_i[0], mv_i[1], height, width)
            if carry_u16:
                lo, c = _swar_add8_carry(res_i[1], pred[1])
                hi = _swar_add8(_swar_add8(res_i[0], pred[0]), c)
                cur = jnp.stack([hi, lo], axis=0)
            else:
                cur = _swar_add8(res_i, pred)
            return cur, cur

        _, rest = jax.lax.scan(step, res_g[0], (res_g[1:], mv_g[1:]))
        return jnp.concatenate([res_g[:1], rest], axis=0)

    out = jax.vmap(fold_group)(grp, mvg)
    out = out.reshape((-1, p, rows, wpw))[front : front + t]
    return out.reshape(tp, rows, wpw)


def temporal_decode_mc_jax(residuals, keyint: int, mvs,
                           first_len: int | None = None):
    """Device-resident inverse of :func:`temporal_encode_mc`.

    Groups are independent (keyframes are literal), so the sequential
    within-group recursion ``out[i] = res[i] + roll(out[i-1], mv[i])`` runs
    as a ``lax.scan`` of length keyint-1, vmapped over groups — the scan
    carry is one frame on the device, never a host array. Rolls use traced
    per-frame shifts (``jnp.roll`` lowers them to dynamic slices). A short
    first group front-pads zero frames + zero vectors (zeros predict
    nothing, so the literal first frame folds correctly in place).
    """
    import jax
    import jax.numpy as jnp

    if keyint < 1:
        raise ValueError("keyint must be >= 1")
    t = residuals.shape[0]
    if tuple(np.shape(mvs)) != (t, 2):  # np.shape: tracer-safe under jit
        raise ValueError(
            "corrupt MHVT container (motion table length disagrees with "
            "the frame count)")
    front = (keyint - first_len) % keyint if first_len else 0
    pad = (-(t + front)) % keyint
    x = jnp.pad(residuals,
                [(front, pad)] + [(0, 0)] * (residuals.ndim - 1))
    mv = jnp.pad(jnp.asarray(mvs, jnp.int32), ((front, pad), (0, 0)))
    g = x.shape[0] // keyint
    grp = x.reshape((g, keyint) + x.shape[1:])
    mvg = mv.reshape(g, keyint, 2)

    def fold_group(res_g, mv_g):
        def step(prev, inp):
            r, m = inp
            pred = jnp.roll(jnp.roll(prev, m[0], axis=0), m[1], axis=1)
            out = r + pred  # unsigned wraparound
            return out, out

        _, rest = jax.lax.scan(step, res_g[0], (res_g[1:], mv_g[1:]))
        return jnp.concatenate([res_g[:1], rest], axis=0)

    out = jax.vmap(fold_group)(grp, mvg)
    return out.reshape((-1,) + x.shape[1:])[front : front + t]


# -- global motion compensation ------------------------------------------------
#
# A lossless byte codec cannot cancel global motion (panning) with plain
# frame differencing: every pixel changes by the local spatial gradient and
# the residuals get NOISIER than the frames (PERF.md temporal study,
# x1.09). The fix is one integer motion vector per frame: the predictor
# becomes a CIRCULAR shift of the previous frame — np.roll is exactly
# invertible, so losslessness is free and only the wrapped border rows/
# columns mispredict (~(|dy|*W + |dx|*H) pixels per frame).


def _luma(frame: np.ndarray) -> np.ndarray:
    """Estimation field: float32 luma (channel mean for color stacks)."""
    f = frame.astype(np.float32)
    return f.mean(axis=-1) if f.ndim == 3 else f


def _mc_cost(prev: np.ndarray, cur: np.ndarray, mv: tuple, step: int = 4) -> int:
    """Wrapping-residual magnitude of predictor roll(prev, mv), subsampled."""
    pred = np.roll(prev, mv, axis=(0, 1)) if mv != (0, 0) else prev
    m = 65536 if prev.dtype == np.uint16 else 256
    r = (cur[::step, ::step].astype(np.int32)
         - pred[::step, ::step].astype(np.int32)) % m
    return int(np.minimum(r, m - r).sum())


def estimate_motion(prev: np.ndarray, cur: np.ndarray,
                    max_shift: int = 256) -> tuple[int, int]:
    """Integer global motion (dy, dx) with ``cur ~= roll(prev, (dy, dx))``.

    Phase correlation (normalized cross-power spectrum peak) on the luma
    field — one shot, no search loop, handles arbitrary shifts up to half
    the frame. Frames with even dimensions correlate on a 2x2-downsampled
    luma (4x fewer FFT FLOPs — estimation dominates MC encode cost) and
    refine the doubled peak over its +-1 px neighborhood with the exact
    wrapping-residual cost. The candidate is accepted only when it beats
    zero motion on that same cost, so hostile content degrades to plain
    temporal differencing, never below it.
    """
    a, b = _luma(prev), _luma(cur)
    down = a.shape[0] % 2 == 0 and a.shape[1] % 2 == 0 and min(a.shape) >= 64
    if down:
        a = a.reshape(a.shape[0] // 2, 2, a.shape[1] // 2, 2).mean((1, 3))
        b = b.reshape(b.shape[0] // 2, 2, b.shape[1] // 2, 2).mean((1, 3))
    fa = np.fft.rfft2(a)
    fb = np.fft.rfft2(b)
    cross = fb * np.conj(fa)
    cross /= np.abs(cross) + 1e-6
    corr = np.fft.irfft2(cross, a.shape)
    peak = np.unravel_index(int(np.argmax(corr)), corr.shape)
    dy = peak[0] - (a.shape[0] if peak[0] > a.shape[0] // 2 else 0)
    dx = peak[1] - (a.shape[1] if peak[1] > a.shape[1] // 2 else 0)
    if down:
        dy, dx = 2 * dy, 2 * dx
    if abs(dy) > max_shift or abs(dx) > max_shift or (
            not down and (dy, dx) == (0, 0)):
        return (0, 0)
    if down:
        # the downsampled peak is exact only to +-1 full-res px per axis:
        # refine over the 3x3 neighborhood with the true residual cost
        cands = [(dy + ey, dx + ex) for ey in (-1, 0, 1) for ex in (-1, 0, 1)]
        cands = [c for c in cands
                 if abs(c[0]) <= max_shift and abs(c[1]) <= max_shift]
        dy, dx = min(cands, key=lambda c: _mc_cost(prev, cur, c))
        if (dy, dx) == (0, 0):
            return (0, 0)
    if _mc_cost(prev, cur, (int(dy), int(dx))) < _mc_cost(prev, cur, (0, 0)):
        return (int(dy), int(dx))
    return (0, 0)


def temporal_encode_mc(frames: np.ndarray, keyint: int = 8,
                       mvs: np.ndarray | None = None):
    """Motion-compensated residuals: ``frame[t] - roll(frame[t-1], mv[t])``.

    Returns ``(residuals, mvs)`` with ``mvs`` a (T, 2) int16 array of
    per-frame (dy, dx) — estimated per non-key frame when not supplied;
    keyframes are literal and carry (0, 0).
    """
    frames = np.asarray(frames)
    if frames.ndim < 3:
        raise ValueError("frames must be (T, H, W[, C])")
    if frames.dtype not in (np.uint8, np.uint16):
        raise ValueError("temporal prediction needs uint8/uint16 frames")
    if keyint < 1:
        raise ValueError("keyint must be >= 1")
    t = frames.shape[0]
    if mvs is None:
        mvs = np.zeros((t, 2), np.int16)
        for i in range(1, t):
            if i % keyint:
                mvs[i] = estimate_motion(frames[i - 1], frames[i])
    else:
        mvs = np.asarray(mvs, np.int16).reshape(t, 2)
    res = frames.copy()
    for i in range(1, t):
        if i % keyint == 0:
            continue  # literal keyframe
        mv = (int(mvs[i, 0]), int(mvs[i, 1]))
        pred = (np.roll(frames[i - 1], mv, axis=(0, 1)) if mv != (0, 0)
                else frames[i - 1])
        res[i] = frames[i] - pred  # unsigned wraparound
    return res, mvs


def temporal_decode_mc(residuals: np.ndarray, keyint: int,
                       mvs: np.ndarray,
                       first_len: int | None = None) -> np.ndarray:
    """Inverse of :func:`temporal_encode_mc` (sequential within a group —
    each frame's predictor is the previous RECONSTRUCTED frame, rolled)."""
    residuals = np.asarray(residuals)
    mvs = np.asarray(mvs)
    if mvs.ndim != 2 or mvs.shape != (residuals.shape[0], 2):
        # validated here so EVERY fold site (library, CLI decode-video,
        # CLI verify) turns a truncated/corrupt motion table into the same
        # clean error instead of a raw IndexError
        raise ValueError(
            "corrupt MHVT container (motion table length disagrees with "
            "the frame count)")
    fl = keyint if first_len is None else first_len
    out = np.empty_like(residuals)
    for i in range(residuals.shape[0]):
        if i == 0 or (i >= fl and (i - fl) % keyint == 0):
            out[i] = residuals[i]
            continue
        mv = (int(mvs[i, 0]), int(mvs[i, 1]))
        pred = (np.roll(out[i - 1], mv, axis=(0, 1)) if mv != (0, 0)
                else out[i - 1])
        out[i] = residuals[i] + pred
    return out


_jits: dict = {}


def _jitted(name: str, fn, static=("keyint", "first_len")):
    """Lazily jit a fold so production calls are ONE device dispatch each
    (eager op-by-op dispatch pays a launch per op)."""
    import jax

    if name not in _jits:
        _jits[name] = jax.jit(fn, static_argnames=static)
    return _jits[name]


# -- container ------------------------------------------------------------------


def wrap(inner: bytes, keyint: int, source_crc32: int = 0,
         mvs: np.ndarray | None = None,
         frame_crcs: np.ndarray | None = None,
         first_len: int | None = None,
         trailer: bool = False) -> bytes:
    """Wrap an inner video container blob in the MHVT header + CRC trailer.

    With ``mvs`` (a (T, 2) int16 array of per-frame global motion vectors)
    the header flags bit 0 is set and ``u32 T`` + T x (i16 dy, i16 dx)
    follow the header before the inner blob. With ``frame_crcs`` (a (T,)
    uint32 array of per-TRUE-frame CRC-32s) flags bit 1 is set and
    ``u32 T`` + T x u32 follow the motion table — random access then
    verifies exactly the frames it reconstructs.

    An inner beyond 4 GiB sets flags bit 2 and stores its length as a u64
    after the header (the u32 field reads 0). ``first_len`` (1..keyint-1)
    sets flags bit 3 and records a SHORT first keyframe group — written by
    arbitrary-start extraction, which re-keys only the first group and
    splices the rest losslessly; ``first_len`` of ``None``/``keyint``
    writes the plain layout.

    ``trailer=True`` writes the STREAMING layout (flags bit 4): the inner
    length is always the u64 after the header and the motion/frame-CRC
    tables move AFTER the inner — the byte layout
    :class:`~.stream_writer.TemporalStreamingEncoder` produces
    incrementally, so the streamed file and this batch wrap of the same
    content are byte-identical (gated by test). Both layouts parse
    through :func:`unwrap` transparently.
    """
    if not 1 <= keyint <= 0xFFFF:
        raise ValueError("keyint must be in 1..65535")
    flags = FLAG_TRAILER if trailer else 0
    extra = b""
    inner_len32 = len(inner)
    if trailer:
        inner_len32 = 0
        extra += struct.pack("<Q", len(inner))
    elif len(inner) > 0xFFFFFFFF:
        flags |= FLAG_INNER64
        inner_len32 = 0
        extra += struct.pack("<Q", len(inner))
    if first_len is not None and first_len != keyint:
        if not 1 <= first_len < keyint:
            raise ValueError("first_len must be in 1..keyint")
        flags |= FLAG_FIRST_LEN
        extra += struct.pack("<H", first_len)
    mv_blob = b""
    if mvs is not None:
        mvs = np.asarray(mvs, np.int16).reshape(-1, 2)
        flags |= FLAG_MOTION
        mv_blob = struct.pack("<I", mvs.shape[0]) + mvs.astype("<i2").tobytes()
    fc_blob = b""
    if frame_crcs is not None:
        fc = np.asarray(frame_crcs, np.uint32).reshape(-1)
        flags |= FLAG_FRAME_CRCS
        fc_blob = struct.pack("<I", fc.shape[0]) + fc.astype("<u4").tobytes()
    tables = mv_blob + fc_blob
    head = TEMPORAL_MAGIC + struct.pack(_HEADER, keyint, flags, inner_len32)
    body = (head + extra + inner + tables if trailer
            else head + extra + tables + inner)
    return body + struct.pack("<I", source_crc32 & 0xFFFFFFFF)


def _parse_tables(blob: bytes, pos: int, flags: int):
    """Parse the motion / frame-CRC tables at ``pos`` -> (mvs, fcrcs, pos).

    The SAME two tables appear before the inner (header layout) or after
    it (trailer layout, flags bit 4) — one parser serves both."""
    mvs = None
    if flags & FLAG_MOTION:
        if len(blob) < pos + 4:
            raise ValueError("truncated MHVT container (motion table)")
        (t,) = struct.unpack_from("<I", blob, pos)
        pos += 4
        if len(blob) < pos + 4 * t:
            raise ValueError("truncated MHVT container (motion table)")
        mvs = np.frombuffer(blob, dtype="<i2", count=2 * t,
                            offset=pos).reshape(t, 2).copy()
        pos += 4 * t
    fcrcs = None
    if flags & FLAG_FRAME_CRCS:
        if len(blob) < pos + 4:
            raise ValueError("truncated MHVT container (frame CRC table)")
        (t,) = struct.unpack_from("<I", blob, pos)
        pos += 4
        if len(blob) < pos + 4 * t:
            raise ValueError("truncated MHVT container (frame CRC table)")
        fcrcs = np.frombuffer(blob, dtype="<u4", count=t, offset=pos).copy()
        pos += 4 * t
    return mvs, fcrcs, pos


def unwrap(blob: bytes):
    """MHVT blob -> (inner, keyint, source_crc32, mvs_or_None,
    frame_crcs_or_None, first_len).

    ``first_len`` is the length of the first keyframe group — ``keyint``
    unless the container records a short one (flags bit 3). Both the
    header-table layout and the streaming trailer layout (flags bit 4)
    parse here; every decode surface is layout-agnostic past this point.
    """
    if blob[:4] != TEMPORAL_MAGIC:
        raise ValueError("not an MHVT container")
    if len(blob) < _HEADER_SIZE:
        raise ValueError("truncated MHVT container (header incomplete)")
    keyint, flags, inner_len = struct.unpack_from(_HEADER, blob, 4)
    if keyint < 1:
        raise ValueError("corrupt MHVT container (keyint 0)")
    if flags & ~_KNOWN_FLAGS:
        raise ValueError(
            f"unsupported MHVT container (unknown flags 0x{flags:04x} — "
            "written by a newer format revision?)")
    trailer = bool(flags & FLAG_TRAILER)
    if trailer and flags & FLAG_INNER64:
        raise ValueError(
            "corrupt MHVT container (trailer layout carries its own u64 "
            "inner length; INNER64 must not combine with it)")
    pos = _HEADER_SIZE
    if trailer or flags & FLAG_INNER64:
        if len(blob) < pos + 8:
            raise ValueError("truncated MHVT container (u64 inner length)")
        (inner_len,) = struct.unpack_from("<Q", blob, pos)
        pos += 8
    first_len = keyint
    if flags & FLAG_FIRST_LEN:
        if len(blob) < pos + 2:
            raise ValueError("truncated MHVT container (first_len field)")
        (first_len,) = struct.unpack_from("<H", blob, pos)
        pos += 2
        if not 1 <= first_len <= keyint:
            raise ValueError(
                "corrupt MHVT container (first keyframe group length "
                f"{first_len} outside 1..keyint={keyint})")
    if trailer:
        end = pos + inner_len
        if len(blob) < end:
            raise ValueError(
                "truncated MHVT container (inner/trailer missing)")
        inner = blob[pos:end]
        mvs, fcrcs, tpos = _parse_tables(blob, end, flags)
        if len(blob) < tpos + 4:
            raise ValueError(
                "truncated MHVT container (inner/trailer missing)")
        (crc,) = struct.unpack_from("<I", blob, tpos)
        return inner, keyint, crc, mvs, fcrcs, first_len
    mvs, fcrcs, pos = _parse_tables(blob, pos, flags)
    end = pos + inner_len
    if len(blob) < end + 4:
        raise ValueError("truncated MHVT container (inner/trailer missing)")
    (crc,) = struct.unpack_from("<I", blob, end)
    return blob[pos:end], keyint, crc, mvs, fcrcs, first_len


def _inner_config(config: CodecConfig | None) -> CodecConfig:
    """The config the inner (residual) encode/decode runs under.

    ``frame_crcs`` is cleared too: the MHVT wrapper records the per-TRUE-
    frame table (the one random access verifies), so an inner per-RESIDUAL
    table would just double the cost the config documents (4 B/frame).
    """
    return dataclasses.replace(config or CodecConfig(), temporal=False,
                               motion=False, frame_crcs=False)


def _crc(frames: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(frames).tobytes()) & 0xFFFFFFFF


def _frame_crcs(frames: np.ndarray, cfg: CodecConfig):
    """(T,) uint32 per-TRUE-frame CRC table, or None unless cfg asks."""
    if not cfg.frame_crcs:
        return None
    from . import frame_stream

    return frame_stream.compute_frame_crcs(frames)


def _verify_frame_crcs(frames, fcrcs, base: int = 0) -> None:
    """Check reconstructed frames [base, base+len) against the CRC table
    (one shared implementation: ``frame_stream.verify_frame_crcs``)."""
    from . import frame_stream

    frame_stream.verify_frame_crcs(frames, fcrcs, base)


def _residuals(frames: np.ndarray, cfg: CodecConfig,
               mvs: np.ndarray | None = None):
    """(residual stack, mvs-or-None) per the config's motion flag.

    ``mvs`` (when given and ``cfg.motion``) supplies precomputed per-frame
    motion vectors so a caller that already estimated them — e.g. the
    ``--best`` search measuring precoders on the true MC payload — never
    pays (or risks diverging from) a second estimation pass.
    """
    if cfg.motion:
        return temporal_encode_mc(frames, cfg.keyint, mvs)
    return temporal_encode(frames, cfg.keyint), None


def encode_temporal_video(frames: np.ndarray,
                          config: CodecConfig | None = None,
                          mvs: np.ndarray | None = None) -> bytes:
    """(T, H, W) uint8 -> MHVT wrapping an MHTV/MHV2 residual stream.

    With ``config.motion`` each non-key frame's predictor is the previous
    frame circularly shifted by an estimated global motion vector
    (stored in the wrapper); pass ``mvs`` to reuse vectors estimated by an
    earlier search pass."""
    from .. import encode_video

    cfg = config or CodecConfig()
    frames = np.asarray(frames)
    res, mvs = _residuals(frames, cfg, mvs)
    return wrap(encode_video(res, _inner_config(cfg)), cfg.keyint,
                source_crc32=_crc(frames), mvs=mvs,
                frame_crcs=_frame_crcs(frames, cfg))


def encode_temporal_color_video(frames: np.ndarray,
                                config: CodecConfig | None = None,
                                colorspace: int | None = None,
                                mvs: np.ndarray | None = None) -> bytes:
    """(T, H, W, C) uint8 -> MHVT wrapping an MHTC residual video."""
    from . import color

    cfg = config or CodecConfig()
    frames = np.asarray(frames)
    res, mvs = _residuals(frames, cfg, mvs)
    cs = color.CS_IDENTITY if colorspace is None else colorspace
    inner = color.encode_color_video_to_bytes(res, _inner_config(cfg),
                                              colorspace=cs)
    return wrap(inner, cfg.keyint, source_crc32=_crc(frames), mvs=mvs,
                frame_crcs=_frame_crcs(frames, cfg))


def encode_temporal_gray16_video(frames: np.ndarray,
                                 config: CodecConfig | None = None,
                                 mvs: np.ndarray | None = None) -> bytes:
    """(T, H, W) uint16 -> MHVT wrapping an MHTC kind=1 residual video.

    The residual is computed mod 65536 on the u16 frames (NOT per byte
    plane), so a small depth change never rolls the hi plane unpredictably.
    """
    from . import color

    cfg = config or CodecConfig()
    frames = np.asarray(frames)
    if frames.ndim != 3 or frames.dtype != np.uint16:
        raise ValueError("expected (T, H, W) uint16")
    res, mvs = _residuals(frames, cfg, mvs)
    inner = color.encode_gray16_to_bytes(res, _inner_config(cfg))
    return wrap(inner, cfg.keyint, source_crc32=_crc(frames), mvs=mvs,
                frame_crcs=_frame_crcs(frames, cfg))


def _decode_inner(inner: bytes, config: CodecConfig | None) -> np.ndarray:
    """Decode any inner video container to its (T, ...) residual stack."""
    from .. import decode_video
    from . import color

    cfg = _inner_config(config)
    if inner[:4] == color.COLOR_MAGIC:
        _, _ch, layout, kind, _cs = color.unwrap(inner)
        if layout != color.LAYOUT_VIDEO:
            raise ValueError("MHVT inner MHTC container is not a video")
        if kind == color.KIND_U16:
            return color.decode_gray16_from_bytes(inner, cfg)
        return color.decode_color_video_from_bytes(inner, cfg)
    return decode_video(inner, cfg)


def _strips_available(inner: bytes) -> bool:
    """Header-only probe: will the raw-strips (packed words) path apply?

    True iff ``inner`` is a bare MHTV/MHV2 stream whose blocks decode to
    image words (``block_dim % 4 == 0``) with no zero-init root fold
    (mode 2/4 folds ``block_init`` on byte images). Reads only the fixed
    header bytes, so callers can pick the byte-image path WITHOUT first
    paying a full (discarded) strips decode. The packed folds handle
    padded geometries (:func:`_roll_words_general`).
    """
    import struct as struct_mod

    from ..ops import decode_pallas
    from . import frame_stream

    if inner[:4] == frame_stream.SHARED_MAGIC:
        _t, h, w, _nb, bd, mode = struct_mod.unpack_from("<IIIIBB", inner, 4)
    elif inner[:4] == frame_stream.SEGMENTED_MAGIC:
        _t, h, w, bd, mode, _n = struct_mod.unpack_from("<IIIBBI", inner, 4)
    else:
        return False
    if mode in (2, 4):  # zero-init: block_init root fold -> byte path
        return False
    return decode_pallas.raw_words_ok(bd)


def _device_gray_strips(inner: bytes, config: CodecConfig):
    """Raw-strips device decode of a plain grayscale MHTV/MHV2 inner stream.

    Returns ``(words (T, rows_pf, w_pad//4) int32 device, t, h, w, w_pad,
    rows_pf)`` when the kernel emits image words (``block_dim % 4 == 0``,
    no zero-init root fold), else None (callers take the byte-image
    path). Segments concatenate on device.
    """
    import dataclasses

    import jax.numpy as jnp

    from ..ops import decode_pallas
    from . import frame_stream

    if inner[:4] == frame_stream.SHARED_MAGIC:
        stream, t, h, w, bd, delta = frame_stream.read_shared(inner)
        segs = [(stream, t)]
    elif inner[:4] == frame_stream.SEGMENTED_MAGIC:
        segs, t, h, w, bd, delta = frame_stream.read_segmented(inner)
    else:
        return None
    if (not decode_pallas.raw_words_ok(bd)
            or any(s.block_init is not None for s, _ in segs)):
        return None
    cfg = dataclasses.replace(config, block_dim=bd, delta=delta,
                              delta2d=segs[0][0].predictor == "2d")
    rows_pf, w_pad = decode_pallas.padded_geometry(h, w, bd)
    parts = []
    for stream, ft in segs:
        prep = frame_stream.prepare_shared(stream, ft, h, w, cfg)
        parts.append(frame_stream.decode_shared_step(prep, cfg, raw=True))
    words = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
    return words, t, h, w, w_pad, rows_pf


def _device_frames(inner: bytes, config: CodecConfig):
    """Device decode of any inner video container -> (T, ...) device
    residual stack ((T, H, W) u8, (T, H, W, C) u8, or (T, H, W) u16)."""
    from . import color, frame_stream

    cfg = _inner_config(config)
    if inner[:4] == color.COLOR_MAGIC:
        inner2, ch, layout, kind, cs = color.unwrap(inner)
        if layout != color.LAYOUT_VIDEO:
            raise ValueError("MHVT inner MHTC container is not a video")
        planes = frame_stream.decode_container_device(inner2, cfg)
        return color.fold_video_planes_jax(planes, ch, kind, cs)
    return frame_stream.decode_container_device(inner, cfg)


def _plane_words_relayout_jax(words, *, channels: int, kind: int, cs: int,
                              height: int, width: int):
    """Folded PLANE words -> true frames, on device: bitcast to bytes,
    crop the strip padding, interleave channels / recombine hi-lo, invert
    the colorspace — one fused pass after the packed fold, so the host
    fetch is final frames exactly as on the grayscale path.

    This is the FALLBACK relayout (odd channel counts): the bitcast to
    bytes materializes a byte-granular layout change. Channel counts
    2/3/4 take :func:`_interleave_words_jax` instead — a word-domain
    shuffle."""
    import jax.numpy as jnp
    from jax import lax

    from . import color

    n, rows_pf, wpw = words.shape
    b = lax.bitcast_convert_type(words, jnp.uint8).reshape(
        n, rows_pf, wpw * 4)[:, :height, :width]
    return color.fold_video_planes_jax(b, channels, kind, cs)


def _interleave_words_jax(words, *, channels: int, u16: bool, cs: int):
    """Folded plane words -> words of the channel-INTERLEAVED byte image,
    never leaving int32: (T*C, rows, wpw) -> (T, rows, C*wpw).

    The chain avoids any byte-granular relayout (a bitcast + crop pass):
    each output word is 4 byte extracts + 3 ORs from the input plane
    words (out word ``C*w + m`` takes byte ``(4m+k)//C`` of plane
    ``(4m+k)%C``'s word ``w``), and the factor-C minor interleave is a
    word-level stack+reshape.

    For u16 the planes arrive [hi, lo] per frame and the output byte
    order is little-endian [lo, hi] — handled by reversing the plane
    order. The sub-green inverse (``R=r+G, B=b+G`` — linear, commutes
    with the fold) happens here in the word domain as two SWAR adds, so
    NO byte-granular pass exists anywhere: the host views the fetched
    words as (T, rows, w_pad[, C]) bytes / u16 for free, exactly like
    the grayscale path.
    """
    import jax.numpy as jnp
    from jax import lax

    from . import color

    tp, rows, wpw = words.shape
    c = channels
    t = tp // c
    x = words.reshape(t, c, rows, wpw)
    if u16:
        x = x[:, ::-1]  # [hi, lo] planes -> LE byte order [lo, hi]
    elif cs == color.CS_SUBGREEN:
        parts = [_swar_add8(x[:, 0], x[:, 1]), x[:, 1],
                 _swar_add8(x[:, 2], x[:, 1])]
        parts += [x[:, i] for i in range(3, c)]
        x = jnp.stack(parts, axis=1)
    planes = [x[:, i] for i in range(c)]
    outs = []
    for m in range(c):
        o = None
        for k in range(4):
            idx = 4 * m + k
            b = lax.shift_right_logical(
                planes[idx % c], 8 * (idx // c)) & 0xFF
            term = lax.shift_left(b, 8 * k)
            o = term if o is None else o | term
        outs.append(o)
    return jnp.stack(outs, axis=-1).reshape(t, rows, c * wpw)


def _decode_temporal_device(inner: bytes, keyint: int, mvs,
                            config: CodecConfig,
                            first_len: int | None = None) -> np.ndarray:
    """Decode + temporally reconstruct on DEVICE; one host fetch at the end.

    Every stream with image-word blocks and no zero-init root fold takes the
    raw-strips path: the kernel's packed image words feed the SWAR group
    fold directly. Since round 5 that includes EVERY production chain —
    color planes fold as extra rows (linear colorspace inverses commute
    with the wrapping sum, :func:`temporal_fold_plane_words_jax`), u16
    hi/lo pairs fold with SWAR carry propagation
    (:func:`temporal_fold_u16_words_jax`), and motion compensation runs
    on padded strip geometries via the double-roll + byte-mask select
    (:func:`_roll_words_general`). Gray
    output is a free host view of the fetched words; color/u16 relayout
    once on device after the fold (:func:`_plane_words_relayout_jax`).
    Zero-init streams and 2x2-block geometries keep the byte-image
    fallback.
    """
    from . import color

    cfg_i = _inner_config(config)
    cinfo = None
    plane_inner = inner
    if inner[:4] == color.COLOR_MAGIC:
        inner2, ch, layout, kind, cs = color.unwrap(inner)
        if layout != color.LAYOUT_VIDEO:
            raise ValueError("MHVT inner MHTC container is not a video")
        cinfo = (ch, kind, cs)
        plane_inner = inner2
    raw = (_device_gray_strips(plane_inner, cfg_i)
           if _strips_available(plane_inner) else None)
    if raw is None:
        # zero-init root fold or 2x2 blocks: byte-image fallback
        res = _device_frames(inner, config)
        if mvs is not None:
            return np.asarray(_jitted("fold_mc", temporal_decode_mc_jax)(
                res, keyint=keyint, mvs=np.asarray(mvs),
                first_len=first_len))
        return np.asarray(_jitted("fold", temporal_decode_jax)(
            res, keyint=keyint, first_len=first_len))
    words, tp, h, w, w_pad, rows_pf = raw
    if cinfo is None:
        ppf, u16 = 1, False
    else:
        ch, kind, cs = cinfo
        u16 = kind == color.KIND_U16
        ppf = 2 if u16 else ch
    if ppf < 1 or tp % ppf:
        raise ValueError(
            f"MHTC inner frame count ({tp}) is not a multiple of the "
            f"declared {ppf} planes per frame")
    if mvs is not None:
        folded = _jitted(
            "fold_words_mc", temporal_fold_words_mc_jax,
            static=("keyint", "height", "width", "first_len",
                    "planes_per_frame", "carry_u16"))(
                words, keyint=keyint, mvs=np.asarray(mvs, np.int32),
                height=h, width=w, first_len=first_len,
                planes_per_frame=ppf, carry_u16=u16)
    elif u16:
        folded = _jitted("fold_u16_words", temporal_fold_u16_words_jax)(
            words, keyint=keyint, first_len=first_len)
    elif ppf > 1:
        folded = _jitted(
            "fold_plane_words", temporal_fold_plane_words_jax,
            static=("keyint", "planes_per_frame", "first_len"))(
                words, keyint=keyint, planes_per_frame=ppf,
                first_len=first_len)
    else:
        folded = _jitted("fold_words", temporal_fold_words_jax)(
            words, keyint=keyint, first_len=first_len)
    if cinfo is None:
        out = np.asarray(folded).view(np.uint8).reshape(tp, rows_pf, w_pad)
        return out if (rows_pf, w_pad) == (h, w) else out[:, :h, :w]
    t = tp // ppf
    if u16:
        # word-domain [lo, hi] interleave; the host view IS the u16 frame
        iw = _jitted("interleave_u16", _interleave_words_jax,
                     static=("channels", "u16", "cs"))(
                         folded, channels=2, u16=True, cs=0)
        out = np.asarray(iw).view("<u2").reshape(t, rows_pf, w_pad)
        return out if (rows_pf, w_pad) == (h, w) else out[:, :h, :w]
    if ch in (2, 3, 4):
        # word-domain cs-invert + channel interleave; host views bytes
        iw = _jitted("interleave_color", _interleave_words_jax,
                     static=("channels", "u16", "cs"))(
                         folded, channels=ch, u16=False, cs=cs)
        out = np.asarray(iw).view(np.uint8).reshape(
            t, rows_pf, w_pad, ch)
        return (out if (rows_pf, w_pad) == (h, w)
                else out[:, :h, :w, :])
    frames = _jitted(
        "plane_relayout", _plane_words_relayout_jax,
        static=("channels", "kind", "cs", "height", "width"))(
            folded, channels=ch, kind=kind, cs=cs, height=h, width=w)
    return np.asarray(frames)


def decode_temporal_video(blob: bytes,
                          config: CodecConfig | None = None) -> np.ndarray:
    """MHVT container -> reconstructed frames (shape/dtype per inner kind:
    (T, H, W) u8, (T, H, W, C) u8, or (T, H, W) u16), CRC-verified.

    On the device backends the whole reconstruction — block decode AND
    temporal fold (SWAR scan on packed words, or roll+scan for motion
    compensation) — runs on-chip and the host fetches only the final true
    frames, which the outer MHVT CRC then pins end-to-end (it covers every
    inner bit, so nothing escapes unverified). The native backend keeps the
    host fold and verifies both CRCs (inner residual, then outer); a device
    decode that fails the outer CRC re-runs the host path once to localize
    the corruption (inner stream vs wrapper header).
    """
    inner, keyint, crc, mvs, fcrcs, first_len = unwrap(blob)
    cfg = config or CodecConfig()
    if cfg.backend != "native" and crc:
        if mvs is not None:
            # validate against the inner header before any device work
            t_header = _inner_frame_count(inner)
            if t_header is not None and mvs.shape[0] != t_header:
                raise ValueError(
                    "corrupt MHVT container (motion table length disagrees "
                    "with the frame count)")
        frames = _decode_temporal_device(inner, keyint, mvs, cfg, first_len)
        if _crc(frames) == crc:
            _verify_frame_crcs(frames, fcrcs)
            return frames
        # corrupt: fall through to the host path, whose inner-CRC check
        # localizes the failure (residual stream vs wrapper header)
    res = _decode_inner(inner, cfg)
    if mvs is not None:
        frames = temporal_decode_mc(res, keyint, mvs,
                                    first_len=first_len)  # validates table
    else:
        frames = temporal_decode(res, keyint, first_len=first_len)
    if crc and _crc(frames) != crc:
        raise ValueError(
            "reconstructed frames fail the MHVT source CRC-32 — corrupt "
            "container (the inner residual stream verified, so the wrapper "
            "header itself is suspect)")
    _verify_frame_crcs(frames, fcrcs)
    return frames


def _inner_frame_count(inner: bytes):
    """TRUE frame count recorded in the inner container header (or None).

    For MHTC inners this is planes/channels (u8 color) or planes/2 (u16).
    """
    from . import color, frame_stream

    div = 1
    if inner[:4] == color.COLOR_MAGIC:
        inner2, ch, layout, kind, _cs = color.unwrap(inner)
        div = 2 if kind == color.KIND_U16 else ch
        inner = inner2
    if inner[:4] in (frame_stream.SHARED_MAGIC, frame_stream.SEGMENTED_MAGIC):
        (t,) = struct.unpack_from("<I", inner, 4)
        return t // div if div else None
    return None


def decode_temporal_frame(blob: bytes, n: int,
                          config: CodecConfig | None = None) -> np.ndarray:
    """Random access: reconstruct frame ``n`` of an MHVT container.

    Decodes only the residual frames from the preceding keyframe through
    ``n`` — at most ``keyint`` frames' blocks (the per-block offset index
    gives the frame slices; ``frame_stream.decode_range``) — and folds the
    span once (on device for the device backends; see
    :func:`decode_temporal_range`, of which this is the length-1 case).
    """
    if n < 0:
        raise ValueError(f"frame {n} out of range")
    return decode_temporal_range(blob, n, n + 1, config)[0]


def _best_precoder(frames: np.ndarray, cfg: CodecConfig) -> CodecConfig:
    """Smallest of none/delta/delta2d measured on the actual payload."""
    from . import frame_stream

    candidates = [
        dataclasses.replace(cfg, delta=False, delta2d=False, zero_init=False),
        dataclasses.replace(cfg, delta=True, delta2d=False),
        dataclasses.replace(cfg, delta=True, delta2d=True),
    ]

    def total(c):
        return sum(s.compressed_size
                   for s, _ in frame_stream.encode_frames_segmented(frames, c))

    return min(candidates, key=total)


def _estimate_candidate_bits(blk: np.ndarray, cfg: CodecConfig) -> float:
    """Compressed size of a sampled BLOCKED payload under cfg's precoder.

    The estimator IS the production encoder run on the subsample (the
    pair-table packer measures >1 GB/s, so a real sampled encode costs
    less than any histogram-and-entropy shortcut while being exact by
    construction — integer code widths, table overhead, everything).
    """
    from .. import native

    if cfg.delta2d:
        payload = native.delta2d_encode(blk, cfg.block_dim)
    elif cfg.delta:
        payload = native.delta_encode(blk, cfg.block_size)
    else:
        payload = blk
    return float(native.encode_symbols(
        payload, block_size=cfg.block_size).compressed_size)


def _sample_indices(t: int, keyint: int, max_samples: int = 12) -> list[int]:
    """Strided frame indices preserving the keyframe/residual mixture.

    The stride is nudged COPRIME with keyint — a stride that is a multiple
    of keyint would sample (almost) only keyframes, estimating every
    candidate on literal content instead of the stream's true
    keyframe:residual mix (round-3 review finding).
    """
    import math

    stride = max(1, t // max_samples)
    while stride > 1 and math.gcd(stride, keyint) != 1:
        stride += 1
    idx = list(range(0, t, stride))
    if all(i % keyint == 0 for i in idx) and t > 1:
        idx.append(1)  # ensure at least one residual frame is sampled
    return idx


def encode_video_best_fast(frames: np.ndarray,
                           config: CodecConfig | None = None):
    """Subsampled ``encode_video_best``: estimate every (mode, precoder)
    candidate's size on a strided frame subsample, then FULLY encode only
    the two best-ranked candidates and keep the smaller container.

    The estimator applies each candidate's true payload law to ~12 sampled
    frames (keyframes literal, residuals vs the true predecessor, motion
    vectors estimated per sampled frame) and sizes it with exact canonical
    widths from the sampled histogram. Work: ~2 full encodes + cheap
    estimates, vs up to 12 full encodes for the exhaustive search — ≥5x
    less on long inputs, same winner on the PERF.md study content (gated
    by tests). Returns ``(blob, kind, used_config)`` like the full search.
    """
    from .. import encode_video

    cfg = config or CodecConfig()
    frames = np.asarray(frames)
    t = frames.shape[0]
    if t < 4:  # sampling cannot beat measuring on tiny inputs
        return encode_video_best(frames, cfg)
    idx = _sample_indices(t, cfg.keyint)
    modes: dict[str, list] = {}
    modes["plain"] = [frames[i] for i in idx]
    modes["temporal"] = [
        frames[i] if i % cfg.keyint == 0 else frames[i] - frames[i - 1]
        for i in idx]
    mvs_sampled = {}
    if cfg.motion:
        mc = []
        for i in idx:
            if i % cfg.keyint == 0:
                mc.append(frames[i])
                continue
            mv = estimate_motion(frames[i - 1], frames[i])
            mvs_sampled[i] = mv
            pred = (np.roll(frames[i - 1], mv, axis=(0, 1))
                    if mv != (0, 0) else frames[i - 1])
            mc.append(frames[i] - pred)
        modes["temporal+motion"] = mc
    precoders = [
        dataclasses.replace(cfg, delta=False, delta2d=False, zero_init=False),
        dataclasses.replace(cfg, delta=True, delta2d=False),
        dataclasses.replace(cfg, delta=True, delta2d=True),
    ]
    # block each mode's sample stack ONCE; the three precoder estimates
    # share it (the transforms differ, the blocking does not)
    from ..core import blocks as blocks_mod

    blocked = {
        kind: np.concatenate(
            [blocks_mod.image_to_blocks(np.ascontiguousarray(f),
                                        cfg.block_dim).ravel()
             for f in samples])
        for kind, samples in modes.items()}
    ranked = sorted(
        ((_estimate_candidate_bits(blocked[kind], pc), kind, pc)
         for kind in modes for pc in precoders),
        key=lambda r: r[0])

    def full_encode(kind: str, pc: CodecConfig):
        if kind == "plain":
            return encode_video(frames, dataclasses.replace(
                pc, temporal=False, motion=False))
        if kind == "temporal":
            return encode_temporal_video(frames, dataclasses.replace(
                pc, temporal=True, motion=False))
        # reuse the vectors the sampling pass already estimated (phase
        # correlation dominates MC search cost); estimate only the rest
        mvs = np.zeros((t, 2), np.int16)
        for i in range(1, t):
            if i % cfg.keyint:
                mvs[i] = (mvs_sampled[i] if i in mvs_sampled
                          else estimate_motion(frames[i - 1], frames[i]))
        res_mc, mvs = temporal_encode_mc(frames, cfg.keyint, mvs)
        return wrap(encode_video(res_mc, _inner_config(pc)), cfg.keyint,
                    source_crc32=_crc(frames), mvs=mvs,
                    frame_crcs=_frame_crcs(frames, pc))

    finalists = []
    seen = set()
    best_bits = ranked[0][0]
    for bits, kind, pc in ranked:
        if kind in seen:
            continue  # one finalist per coding mode (its best precoder)
        # the runner-up is only worth a full encode when the sampled
        # estimate puts it within 5% of the leader (sampling noise is well
        # under that on the study content); a clear win encodes once
        if finalists and bits > 1.05 * best_bits:
            break
        seen.add(kind)
        finalists.append((full_encode(kind, pc), kind, pc))
        if len(finalists) == 2:
            break
    return min(finalists, key=lambda c: len(c[0]))


def encode_video_best(frames: np.ndarray, config: CodecConfig | None = None):
    """Measure the coding modes — each with its best spatial precoder on
    its own payload — and keep the smallest container.

    Candidates: plain, temporal, and (with ``config.motion``) temporal with
    global motion compensation. Temporal prediction is content-dependent
    the same way sub-green is (PERF.md): a static camera with local motion
    shrinks 2-3x, but global motion (panning) makes plain frame residuals
    NOISIER than the frames themselves — the MC candidate cancels exactly
    that case with per-frame circular-shift predictors. Measuring is the
    only safe policy. Returns ``(blob, kind, used_config)`` with ``kind``
    one of ``"plain" | "temporal" | "temporal+motion"``.
    """
    from .. import encode_video

    cfg = config or CodecConfig()
    frames = np.asarray(frames)
    candidates = []
    cfg_p = _best_precoder(frames, _inner_config(cfg))
    candidates.append((encode_video(frames, cfg_p), "plain", cfg_p))
    plain_cfg = dataclasses.replace(cfg, motion=False)
    cfg_t = _best_precoder(temporal_encode(frames, cfg.keyint), plain_cfg)
    candidates.append(
        (encode_temporal_video(frames, cfg_t), "temporal", cfg_t))
    if cfg.motion:
        res_mc, mvs = temporal_encode_mc(frames, cfg.keyint)
        cfg_m = _best_precoder(res_mc, cfg)
        blob_m = wrap(encode_video(res_mc, _inner_config(cfg_m)), cfg.keyint,
                      source_crc32=_crc(frames), mvs=mvs,
                      frame_crcs=_frame_crcs(frames, cfg_m))
        candidates.append((blob_m, "temporal+motion", cfg_m))
    return min(candidates, key=lambda c: len(c[0]))


def _parse_temporal_range(blob: bytes):
    """Parse an MHVT container ONCE for repeated range reconstructions.

    Bundles the wrapper fields with the pre-parsed inner container
    (:func:`frame_stream.parse_range_container`) so a serving loop
    (:func:`iter_temporal_video`) pays the whole-container parse and its
    byte copies once, not per chunk.
    """
    from . import color, frame_stream

    inner, keyint, tcrc, mvs, fcrcs, first_len = unwrap(blob)
    cinfo = None
    if inner[:4] == color.COLOR_MAGIC:
        inner2, channels, layout, kind, cs = color.unwrap(inner)
        if layout != color.LAYOUT_VIDEO:
            raise ValueError("MHVT inner MHTC container is not a video")
        cinfo = (channels, kind, cs)
        parsed = frame_stream.parse_range_container(inner2)
    else:
        parsed = frame_stream.parse_range_container(inner)
    total = _inner_frame_count(inner)
    return (keyint, tcrc, mvs, fcrcs, first_len, parsed, cinfo, total)


def decode_temporal_range(blob: bytes, a: int, b: int,
                          config: CodecConfig | None = None) -> np.ndarray:
    """Reconstruct frames [a, b) of an MHVT container (range analog of
    ``frame_stream.decode_range``).

    Decodes residual frames from the keyframe preceding ``a`` through
    ``b-1`` — at most ``keyint - 1`` extra frames of work — folds the
    whole span once (on device for the device backends, mirroring
    :func:`decode_temporal_video`), and returns the requested slice.
    """
    return _decode_temporal_range_parsed(_parse_temporal_range(blob),
                                         a, b, config)


def _decode_temporal_range_parsed(parts, a: int, b: int,
                                  config: CodecConfig | None = None
                                  ) -> np.ndarray:
    from . import color, frame_stream

    if not 0 <= a < b:
        raise ValueError(f"invalid frame range [{a}, {b})")
    keyint, _tcrc, mvs, fcrcs, first_len, parsed, cinfo, _total = parts
    kf = _group_start(a, keyint, first_len)
    # the decoded span starts at a group boundary; it inherits the short
    # first group only when it starts at the very beginning of the stream
    span_fl = first_len if kf == 0 else None
    cfg = _inner_config(config)
    device = cfg.backend != "native"
    if cinfo is not None:
        channels, kind, cs = cinfo
        planes, _h, _w = frame_stream.decode_range_parsed(
            parsed, kf * channels, b * channels, cfg, to_host=not device)
        fold = color.fold_video_planes_jax if device else color.fold_video_planes
        res = fold(planes, channels, kind, cs)
    else:
        res, h, w = frame_stream.decode_range_parsed(
            parsed, kf, b, cfg, to_host=not device)
        res = res.reshape(-1, h, w)
    if mvs is not None:
        if mvs.shape[0] < b:
            raise ValueError(
                "corrupt MHVT container (motion table shorter than the "
                "stream)")
        out = (_jitted("fold_mc", temporal_decode_mc_jax)(
                   res, keyint=keyint, mvs=mvs[kf:b], first_len=span_fl)
               if device
               else temporal_decode_mc(res, keyint, mvs[kf:b],
                                       first_len=span_fl))
    else:
        # the span starts at a keyframe, so the plain group fold applies
        out = (_jitted("fold", temporal_decode_jax)(
                   res, keyint=keyint, first_len=span_fl)
               if device else temporal_decode(res, keyint,
                                              first_len=span_fl))
    out = np.asarray(out)[a - kf :]
    # with a recorded per-frame CRC table, random access verifies EXACTLY
    # the frames it returns (whole-payload CRCs cannot cover a slice)
    _verify_frame_crcs(out, fcrcs, base=a)
    return out


def iter_temporal_video(blob: bytes, config: CodecConfig | None = None,
                        chunk_frames: int = 32):
    """Yield (base, frames) chunks of an MHVT container, constant memory.

    The streaming analog of :func:`decode_temporal_video` for serving an
    arbitrarily long temporal container without holding it decoded in
    memory: frames are produced in order, in keyframe-group-aligned chunks
    of at least ``chunk_frames``, so no residual frame is ever decoded
    twice (each chunk starts at a keyframe and
    :func:`decode_temporal_range` decodes exactly the chunk's groups;
    chunks yield color/u16 frames per the inner kind). Any recorded
    per-frame CRC table verifies each chunk as it is produced; the outer
    whole-payload temporal CRC is verified streamed — chunk CRCs chain —
    and a mismatch raises ``ValueError`` after the last chunk (a consumer
    that must not emit unverified data should buffer or re-check, as with
    any streaming-integrity design).
    """
    parts = _parse_temporal_range(blob)  # whole-container parse, ONCE
    keyint, tcrc, _mvs, _fcrcs, first_len, _parsed, _cinfo, total = parts
    if total is None:
        raise ValueError("corrupt MHVT container (unrecognized inner stream)")
    cfg = config or CodecConfig()
    crc = 0
    base = 0
    while base < total:
        end = min(base + max(int(chunk_frames), 1), total)
        if end < total:
            # snap up to the next group boundary (0, first_len,
            # first_len + keyint, ...) so the next chunk starts on a
            # keyframe and re-decodes nothing
            if end <= first_len:
                end = first_len
            else:
                end = first_len - ((first_len - end) // keyint) * keyint
            end = min(end, total)
        out = _decode_temporal_range_parsed(parts, base, end, cfg)
        crc = zlib.crc32(np.ascontiguousarray(out).tobytes(), crc)
        yield base, out
        base = end
    if tcrc and crc != tcrc:
        raise ValueError(
            "reconstructed frames fail the MHVT source CRC-32 — corrupt "
            "container")


def decode_temporal_video_region(blob: bytes, a: int, b: int, y0: int,
                                 x0: int, rh: int, rw: int,
                                 config: CodecConfig | None = None,
                                 check: bool = False) -> np.ndarray:
    """Spatio-temporal ROI of an MHVT video: the (rh, rw) crop of frames
    [a, b), reconstructed.

    Plain temporal prediction is PIXEL-WISE, so cropping commutes with the
    group fold: only the region's blocks of frames [keyframe(a), b)
    decode, then the crop folds. Motion compensation rolls pixels across
    the crop boundary, so the MC path falls back to full-frame range
    reconstruction (still only frames [keyframe(a), b)) and crops.

    ``check`` verifies the touched residual blocks via the end-bit check
    (whole-frame/per-frame CRCs cannot cover a crop); the MC fallback
    instead verifies its full-frame range decode against the recorded
    per-frame CRC table (``decode_temporal_range``) — and REFUSES
    ``check=True`` when the container records none, rather than silently
    decoding unchecked.
    """
    from . import color, frame_stream

    if not 0 <= a < b:
        raise ValueError(f"invalid frame range [{a}, {b})")
    inner, keyint, _crc_, mvs, fcrcs, first_len = unwrap(blob)
    if mvs is not None:
        if check and fcrcs is None:
            raise ValueError(
                "motion compensation rolls pixels across the crop "
                "boundary, so an MC region decodes via full-frame "
                "reconstruction — which the end-bit crop check cannot "
                "cover; a checked MC region needs the per-frame CRC "
                "table (encode with --frame-crcs)")
        out = decode_temporal_range(blob, a, b, config)
        if not (0 <= y0 and y0 + rh <= out.shape[1]
                and 0 <= x0 and x0 + rw <= out.shape[2]):
            raise ValueError("region out of bounds")
        return out[:, y0 : y0 + rh, x0 : x0 + rw]
    kf = _group_start(a, keyint, first_len)
    span_fl = first_len if kf == 0 else None
    cfg = _inner_config(config)
    if inner[:4] == color.COLOR_MAGIC:
        res = color.decode_color_video_region(
            inner, kf, b, y0, x0, rh, rw, cfg, check=check)
    else:
        res = frame_stream.decode_video_region(
            inner, kf, b, y0, x0, rh, rw, cfg, check=check)
    return temporal_decode(res, keyint, first_len=span_fl)[a - kf :]


def _describe_parts(keyint: int, crc: int, mvs, fcrcs, first_len: int,
                    flags: int) -> str:
    """The :func:`describe` line from already-unwrapped fields — so a
    caller that parsed once (e.g. the streamed verify) never re-parses
    a whole-payload container just for its description."""
    motion = ""
    if mvs is not None:
        moving = int((mvs != 0).any(axis=1).sum())
        motion = f", motion-compensated ({moving}/{mvs.shape[0]} frames move)"
    fc = f", per-frame CRCs ({fcrcs.shape[0]})" if fcrcs is not None else ""
    fl = (f", short first group ({first_len})"
          if first_len != keyint else "")
    layout = ", streamed (trailer) layout" if flags & FLAG_TRAILER else ""
    return (f"MHVT: temporal prediction, keyframe every {keyint}{fl}"
            f"{motion}{fc}{layout}, crc32={'recorded' if crc else 'absent'}")


def describe(blob: bytes) -> str:
    """One-line human description of the MHVT wrapper (for CLI ``info``)."""
    _, keyint, crc, mvs, fcrcs, first_len = unwrap(blob)
    flags = struct.unpack_from(_HEADER, blob, 4)[1]
    return _describe_parts(keyint, crc, mvs, fcrcs, first_len, flags)

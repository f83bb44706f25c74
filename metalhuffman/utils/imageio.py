"""Grayscale image file IO.

The reference converts PNGs to 8-bit grayscale through CoreGraphics
(``HuffRenderFrame.m:67-127``) and carries a vestigial TGA parser
(``AAPLImage.m:14-160``). Here: PIL-based load/save when available, plus a
dependency-free raw ``.gray`` format, a minimal TGA reader (8-bit
grayscale / 24-bit BGR) for parity with the reference's loader, and a
standard-library (``zlib``) reader and writer for non-interlaced 8-bit gray
and RGB(A) PNGs, used when PIL is not installed.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def _pil_image():
    """PIL's ``Image`` module, or None when Pillow is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return None
    return Image


def _need_pil(path: Path):
    image = _pil_image()
    if image is None:
        raise ImportError(
            f"reading or writing {path.suffix or path.name} needs Pillow; "
            "without it only PNG (8-bit gray/RGB/RGBA), .gray, .tga and "
            ".npy are supported")
    return image


def _rgb_to_luma(rgb: np.ndarray) -> np.ndarray:
    """ITU-R 601-2 luma in PIL's integer arithmetic (``convert("L")``)."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def load_grayscale(path: str | Path) -> np.ndarray:
    """Load any PIL-supported image as (H, W) uint8 grayscale (BT.601 luma,
    matching the reference's CoreGraphics gray conversion)."""
    path = Path(path)
    if path.suffix == ".gray":
        return load_raw_gray(path)
    if path.suffix.lower() == ".tga":
        return tga_to_grayscale(load_tga(path))
    image = _pil_image()
    if image is None and path.suffix.lower() == ".png":
        img = read_png(path)
        if img.ndim == 2:
            return img
        return img[..., 0] if img.shape[2] == 2 else _rgb_to_luma(img)
    return np.asarray(_need_pil(path).open(path).convert("L"))


def save_grayscale(img: np.ndarray, path: str | Path) -> None:
    path = Path(path)
    img = np.asarray(img, dtype=np.uint8)
    if path.suffix == ".gray":
        save_raw_gray(img, path)
        return
    if _pil_image() is None and path.suffix.lower() == ".png":
        write_png(img, path)
        return
    _need_pil(path).fromarray(img, mode="L").save(path)


def load_color(path: str | Path) -> np.ndarray:
    """Load an image keeping color: (H, W, 3) RGB or (H, W, 4) RGBA uint8.

    Unlike the reference (which throws color away through its CoreGraphics
    gray conversion, ``HuffRenderFrame.m:93-127``), the color pipeline keeps
    every channel; alpha is preserved only when the file actually carries it.
    Grayscale files come back as (H, W, 3) via channel replication.
    """
    path = Path(path)
    if path.suffix == ".gray":
        g = load_raw_gray(path)
        return np.repeat(g[..., None], 3, axis=-1)
    if path.suffix.lower() == ".tga":
        img = load_tga(path)
        if img.ndim == 2:
            return np.repeat(img[..., None], 3, axis=-1)
        return img[..., ::-1].copy()  # BGR -> RGB
    if _pil_image() is None and path.suffix.lower() == ".png":
        img = read_png(path)
        if img.ndim == 2:
            return np.repeat(img[..., None], 3, axis=-1)
        if img.shape[2] == 2:  # gray + alpha
            return np.concatenate(
                [np.repeat(img[..., :1], 3, axis=-1), img[..., 1:]], axis=-1)
        return img
    im = _need_pil(path).open(path)
    has_alpha = (im.mode in ("RGBA", "LA", "PA")
                 or (im.mode == "P" and "transparency" in im.info))
    return np.asarray(im.convert("RGBA" if has_alpha else "RGB"))


def save_color(img: np.ndarray, path: str | Path) -> None:
    """Save (H, W, 3) RGB / (H, W, 4) RGBA uint8 to any PIL-supported format."""
    path = Path(path)
    img = np.asarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError("expected (H, W, 3) or (H, W, 4) uint8")
    if _pil_image() is None and path.suffix.lower() == ".png":
        write_png(img, path)
        return
    mode = "RGBA" if img.shape[2] == 4 else "RGB"
    _need_pil(path).fromarray(img, mode=mode).save(path)


def load_gray16(path: str | Path) -> np.ndarray:
    """Load a 16-bit grayscale image: .npy (uint16) or 16-bit PNG/TIFF."""
    path = Path(path)
    if path.suffix == ".npy":
        arr = np.load(path)
        if arr.dtype != np.uint16:
            raise ValueError("expected a uint16 .npy array")
        return arr
    arr = np.asarray(_need_pil(path).open(path))
    if arr.dtype == np.uint16:
        return arr
    if arr.dtype == np.int32:  # PIL mode "I" for 16-bit PNGs
        return arr.astype(np.uint16)
    raise ValueError(f"{path} is not a 16-bit grayscale image ({arr.dtype})")


def save_gray16(img: np.ndarray, path: str | Path) -> None:
    """Save (H, W) uint16 as .npy or a 16-bit PNG."""
    path = Path(path)
    img = np.asarray(img, dtype=np.uint16)
    if path.suffix == ".npy":
        np.save(path, img)
        return
    _need_pil(path).fromarray(img, mode="I;16").save(path)


# -- PNG without PIL: zlib + the five scanline filters ------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> samples a pixel


def _unfilter_serial(kind: int, line: bytes, prior: bytes, bpp: int):
    """Average (3) / Paeth (4) rows: each byte depends on the one to its
    left, so they are undone byte by byte."""
    cur = bytearray(line)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def read_png(path: str | Path) -> np.ndarray:
    """Read a non-interlaced 8-bit gray / gray+alpha / RGB / RGBA PNG:
    (H, W) or (H, W, C) uint8."""
    data = Path(path).read_bytes()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path} is not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        n, kind = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(
            f"{path}: only non-interlaced 8-bit gray/RGB(A) PNGs are read "
            "without Pillow")
    c = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[: h * (w * c + 1)].reshape(h, w * c + 1)
    out = np.empty((h, w * c), np.uint8)
    prior = np.zeros(w * c, np.uint8)
    for y in range(h):
        kind, line = int(raw[y, 0]), raw[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running byte sum per sample
            cur = np.cumsum(line.reshape(w, c), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):
            cur = _unfilter_serial(kind, line.tobytes(), prior.tobytes(), c)
        else:
            raise ValueError(f"{path}: bad PNG filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out.reshape(h, w) if c == 1 else out.reshape(h, w, c)


def write_png(img: np.ndarray, path: str | Path) -> None:
    """Write (H, W) gray or (H, W, 3/4) RGB(A) uint8 as an 8-bit PNG."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    Path(path).write_bytes(
        _PNG_SIG
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + chunk(b"IEND", b""))


# -- raw .gray: trivial dependency-free container -----------------------------

_GRAY_MAGIC = b"GRY1"


def save_raw_gray(img: np.ndarray, path: str | Path) -> None:
    h, w = img.shape
    Path(path).write_bytes(
        _GRAY_MAGIC + struct.pack("<II", h, w) + np.ascontiguousarray(img).tobytes()
    )


def load_raw_gray(path: str | Path) -> np.ndarray:
    data = Path(path).read_bytes()
    if data[:4] != _GRAY_MAGIC:
        raise ValueError("not a GRY1 file")
    h, w = struct.unpack_from("<II", data, 4)
    return np.frombuffer(data, np.uint8, h * w, 12).reshape(h, w).copy()


# -- minimal TGA reader (reference: AAPLImage.m:14-160) -----------------------


def load_tga(path: str | Path) -> np.ndarray:
    """Read an uncompressed TGA: returns (H, W) uint8 gray or (H, W, 3) BGR."""
    data = Path(path).read_bytes()
    if len(data) < 18:
        raise ValueError("truncated TGA header")
    id_len = data[0]
    cmap_type = data[1]
    img_type = data[2]
    w, h = struct.unpack_from("<HH", data, 12)
    bpp = data[16]
    descriptor = data[17]
    if cmap_type != 0:
        raise ValueError("color-mapped TGA not supported")
    if img_type not in (2, 3):
        raise ValueError(f"unsupported TGA image type {img_type} (no RLE)")
    off = 18 + id_len
    if bpp == 8:
        img = np.frombuffer(data, np.uint8, h * w, off).reshape(h, w).copy()
    elif bpp in (24, 32):
        c = bpp // 8
        img = np.frombuffer(data, np.uint8, h * w * c, off).reshape(h, w, c)[..., :3].copy()
    else:
        raise ValueError(f"unsupported TGA depth {bpp}")
    if not (descriptor & 0x20):  # origin at bottom-left -> flip vertically
        img = img[::-1].copy()
    return img


def tga_to_grayscale(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        return img
    b, g, r = img[..., 0].astype(np.float64), img[..., 1].astype(np.float64), img[..., 2].astype(np.float64)
    return np.clip(0.299 * r + 0.587 * g + 0.114 * b, 0, 255).astype(np.uint8)

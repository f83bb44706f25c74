"""Corruption / integrity handling: decoders terminate, CRC catches damage."""

import numpy as np
import pytest

from metalhuffman.core import container
from metalhuffman.models import CodecConfig, ImageCodec
from metalhuffman.ops import decode_xla


def _img(seed=0, shape=(32, 48)):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def test_crc_catches_corrupt_code_bytes():
    img = _img()
    codec = ImageCodec(CodecConfig(backend="xla"))
    blob = bytearray(codec.encode_to_bytes(img))
    # flip a bit in the code stream (past head 26 + core header 264)
    blob[26 + 264 + 10] ^= 0x40
    with pytest.raises(ValueError, match="CRC-32"):
        codec.decode(bytes(blob))


def test_device_decode_of_garbage_terminates():
    # A corrupt stream must never hang or index out of bounds — the interval
    # decoder always advances >= 1 bit/symbol and clamps its table indices.
    img = _img(1)
    codec = ImageCodec(CodecConfig(backend="xla"))
    stream = codec.encode(img)
    bad = container.EncodedStream(
        num_symbols=stream.num_symbols,
        widths=stream.widths,
        code_bytes=np.random.default_rng(2).integers(
            0, 256, stream.code_bytes.size, np.uint8
        ).astype(np.uint8),
        block_offsets=stream.block_offsets,
    )
    out = np.asarray(decode_xla.decode_stream(bad, delta=True))
    assert out.shape == (stream.block_offsets.size, 64)  # garbage but bounded


def test_truncated_container_raises():
    img = _img(3)
    blob = ImageCodec(CodecConfig(backend="xla")).encode_to_bytes(img)
    with pytest.raises(ValueError):
        container.read_frame(blob[: len(blob) // 2])
    with pytest.raises(ValueError):
        container.read_frame(b"XXXX" + blob[4:])


def test_decode_without_crc_still_works():
    img = _img(4)
    codec = ImageCodec(CodecConfig(backend="xla"))
    stream = codec.encode(img)
    blob = container.write_frame(stream, *img.shape, 8, True)  # crc=0
    out = codec.decode(blob)
    np.testing.assert_array_equal(out, img)


def test_parse_rejects_non_kraft_width_table():
    # round-4: the width table is validated on parse (Kraft completeness),
    # not just on the fixed-table encode path — a corrupt table must raise
    # a named error instead of building degenerate decode tables
    img = _img(7)
    codec = ImageCodec(CodecConfig(backend="xla"))
    blob = bytearray(codec.encode_to_bytes(img))
    widths_off = 26 + 8  # MHT1 header + core magic/size
    w = np.frombuffer(bytes(blob), np.uint8, 256, widths_off)
    sym = int(np.flatnonzero(w)[0])
    blob[widths_off + sym] = w[sym] + 1  # breaks the Kraft equality
    with pytest.raises(ValueError, match="corrupt canonical width table"):
        codec.decode(bytes(blob))
    blob[widths_off + sym] = 17  # > MAX_CODE_LENGTH
    with pytest.raises(ValueError, match="corrupt canonical width table"):
        codec.decode(bytes(blob))


def test_truncation_fuzz_every_container_kind():
    """Truncating ANY container at ANY point must raise a clean ValueError
    (or decode to a wrong payload that the CRC catches) — never a raw
    IndexError/struct.error/TypeError crash (round-3 robustness net across
    MHT1/MHTV/MHV2/MHTS/MHTC/MHVT incl. motion + FCRC tables)."""
    import metalhuffman as mh
    from metalhuffman.models import CodecConfig, color, frame_stream, temporal

    rng = np.random.default_rng(5)
    base = rng.integers(0, 256, (20, 24), np.uint8)
    frames = np.stack([np.roll(base, i, 0) for i in range(5)])
    cfg_n = CodecConfig(backend="native")
    blobs = {
        "MHT1": mh.encode_image(base, cfg_n),
        "MHTV": mh.encode_video(frames, CodecConfig(
            backend="native", frame_crcs=True)),
        "MHTS": frame_stream.write_stream(
            frame_stream.encode_frames(frames, cfg_n), 20, 24, cfg_n),
        "MHTC": color.encode_color_video_to_bytes(
            np.repeat(frames[..., None], 3, -1), cfg_n),
        "MHVT": mh.encode_video(frames, CodecConfig(
            backend="native", temporal=True, motion=True, keyint=2,
            frame_crcs=True)),
    }

    def try_decode(name, data):
        if name == "MHT1":
            return mh.decode_image(data, cfg_n)
        if name == "MHTC":
            return color.decode_color_video_from_bytes(data, cfg_n)
        if name == "MHVT":
            return temporal.decode_temporal_video(data, cfg_n)
        return mh.decode_video(data, cfg_n)

    want = {"MHT1": base, "MHTC": np.repeat(frames[..., None], 3, -1)}
    for name, blob in blobs.items():
        expected = want.get(name, frames)
        cuts = sorted({int(c) for c in rng.integers(0, len(blob), 25)})
        for cut in cuts:
            try:
                got = try_decode(name, blob[:cut])
            except (ValueError, RuntimeError):
                continue  # clean, expected
            except Exception as e:  # noqa: BLE001 — the point of the test
                raise AssertionError(
                    f"{name} truncated at {cut}/{len(blob)} raised "
                    f"{type(e).__name__}: {e}") from e
            # decoding "succeeded": only acceptable as GRACEFUL degradation
            # — the cut removed optional trailing metadata and the payload
            # still reconstructs exactly (e.g. a truncated FCRC extension
            # parses as absent; the mandatory CRC trailer still verified)
            assert np.array_equal(got, expected), (name, cut, len(blob))


def test_header_bitflip_fuzz_every_container_kind():
    """Flipping ANY single bit in the header region (outer container header
    + core blob header + 256-byte canonical width table) of every container
    kind must yield a clean ValueError/RuntimeError naming the problem, or a
    decode whose payload is still exact (benign flip caught nowhere because
    nothing depended on the bit) — never a crash and never silently wrong
    output. The width-table half exercises the round-4 Kraft validation in
    ``container.parse_core_blob``; the rest exercises geometry/flag/CRC
    handling across MHT1/MHTV/MHTS/MHTC/MHVT."""
    import metalhuffman as mh
    from metalhuffman.models import CodecConfig, color, frame_stream, temporal

    rng = np.random.default_rng(11)
    base = rng.integers(0, 256, (20, 24), np.uint8)
    frames = np.stack([np.roll(base, i, 0) for i in range(5)])
    cfg_n = CodecConfig(backend="native")
    blobs = {
        "MHT1": mh.encode_image(base, cfg_n),
        "MHTV": mh.encode_video(frames, CodecConfig(
            backend="native", frame_crcs=True)),
        "MHTS": frame_stream.write_stream(
            frame_stream.encode_frames(frames, cfg_n), 20, 24, cfg_n),
        "MHTC": color.encode_color_video_to_bytes(
            np.repeat(frames[..., None], 3, -1), cfg_n),
        "MHVT": mh.encode_video(frames, CodecConfig(
            backend="native", temporal=True, motion=True, keyint=2,
            frame_crcs=True)),
    }

    def try_decode(name, data):
        if name == "MHT1":
            return mh.decode_image(data, cfg_n)
        if name == "MHTC":
            return color.decode_color_video_from_bytes(data, cfg_n)
        if name == "MHVT":
            return temporal.decode_temporal_video(data, cfg_n)
        return mh.decode_video(data, cfg_n)

    want = {"MHT1": base, "MHTC": np.repeat(frames[..., None], 3, -1)}
    for name, blob in blobs.items():
        expected = want.get(name, frames)
        header_span = min(len(blob), 320)  # outer + core header + widths
        positions = sorted({int(p) for p in rng.integers(0, header_span, 48)})
        for pos in positions:
            bad = bytearray(blob)
            bad[pos] ^= 1 << int(rng.integers(0, 8))
            try:
                got = try_decode(name, bytes(bad))
            except (ValueError, RuntimeError):
                continue  # clean, expected
            except MemoryError as e:
                raise AssertionError(
                    f"{name} bit flip at {pos} caused unbounded allocation"
                ) from e
            except Exception as e:  # noqa: BLE001 — the point of the test
                raise AssertionError(
                    f"{name} bit flip at {pos}/{header_span} raised "
                    f"{type(e).__name__}: {e}") from e
            assert np.array_equal(got, expected), (name, pos)

"""Minimal pure-Python MP4 (ISO BMFF) muxer for Motion-JPEG video.

The port's copy of ``nope_nerf_tpu/utils/mp4.py`` (``write_mjpeg_mp4``,
``read_mjpeg_mp4``: the same bytes but the creation time), kept here so that
the port imports nothing of the JAX package. Each frame is JPEG-encoded with
PIL and wrapped in an ISO base-media container with an MPEG-4 visual sample
entry whose objectTypeIndication is 0x6C ("Visual ISO/IEC 10918-1", i.e.
JPEG: the registered way to carry Motion-JPEG in MP4); no ffmpeg needed.

Layout written (single video track, all samples in one chunk):

    ftyp                       brand isom/mp41
    mdat                       concatenated JPEG frames
    moov
      mvhd                     movie timescale/duration
      trak
        tkhd                   track id 1, visual width/height (16.16)
        mdia
          mdhd                 media timescale (1000) / duration
          hdlr 'vide'
          minf
            vmhd + dinf/dref   self-contained
            stbl
              stsd / mp4v+esds sample description (OTI 0x6C)
              stts             constant frame duration
              stsc, stsz, stco one chunk, per-sample sizes
(no stss box: in MJPEG every sample is a sync sample, which is exactly
what an absent stss declares.)
"""
from __future__ import annotations

import io
import struct
from datetime import datetime, timezone

import numpy as np

_MP4_EPOCH = datetime(1904, 1, 1, tzinfo=timezone.utc)


def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def _full_box(kind: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(kind, struct.pack(">B3s", version, flags.to_bytes(3, "big"))
                + payload)


def _descriptor(tag: int, payload: bytes) -> bytes:
    # MPEG-4 expandable-size descriptor header (ISO 14496-1 §8.3.3)
    size = len(payload)
    enc = bytes([size & 0x7F])
    size >>= 7
    while size:
        enc = bytes([0x80 | (size & 0x7F)]) + enc
        size >>= 7
    return bytes([tag]) + enc + payload


def _esds(avg_bitrate: int, max_sample: int) -> bytes:
    # DecoderConfigDescriptor: objectTypeIndication 0x6C = JPEG video,
    # streamType 0x04 (visual) << 2 | reserved 1
    dec_cfg = _descriptor(
        0x04,
        struct.pack(">BBBHII", 0x6C, (0x04 << 2) | 1,
                    (max_sample >> 16) & 0xFF, max_sample & 0xFFFF,
                    max(avg_bitrate, 1), max(avg_bitrate, 1)),
    )
    sl_cfg = _descriptor(0x06, b"\x02")  # SLConfig predefined: MP4
    es = _descriptor(0x03, struct.pack(">HB", 1, 0) + dec_cfg + sl_cfg)
    return _full_box(b"esds", 0, 0, es)


def _sample_entry(width: int, height: int, avg_bitrate: int,
                  max_sample: int) -> bytes:
    # VisualSampleEntry 'mp4v' (ISO 14496-14 §5.6)
    body = (
        b"\x00" * 6 + struct.pack(">H", 1)          # reserved, data_ref_index
        + b"\x00" * 16                               # pre_defined/reserved
        + struct.pack(">HH", width, height)
        + struct.pack(">II", 0x00480000, 0x00480000)  # 72 dpi
        + b"\x00" * 4 + struct.pack(">H", 1)         # reserved, frame_count
        + b"\x00" * 32                               # compressorname
        + struct.pack(">Hh", 24, -1)                 # depth, pre_defined
        + _esds(avg_bitrate, max_sample)
    )
    return _box(b"mp4v", body)


def _stbl(sizes, chunk_offset, width, height, delta, timescale) -> bytes:
    n = len(sizes)
    duration = n * delta
    avg_bitrate = int(8 * sum(sizes) * timescale / max(duration, 1))
    stsd = _full_box(
        b"stsd", 0, 0,
        struct.pack(">I", 1)
        + _sample_entry(width, height, avg_bitrate, max(sizes)))
    stts = _full_box(b"stts", 0, 0, struct.pack(">III", 1, n, delta))
    stsc = _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
    stsz = _full_box(b"stsz", 0, 0,
                     struct.pack(">II", 0, n)
                     + b"".join(struct.pack(">I", s) for s in sizes))
    stco = _full_box(b"stco", 0, 0, struct.pack(">II", 1, chunk_offset))
    return _box(b"stbl", stsd + stts + stsc + stsz + stco)


def _minf(stbl: bytes) -> bytes:
    vmhd = _full_box(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
    dref = _full_box(b"dref", 0, 0, struct.pack(">I", 1)
                     + _full_box(b"url ", 0, 1, b""))
    return _box(b"minf", vmhd + _box(b"dinf", dref) + stbl)


def _mdia(minf: bytes, timescale, duration, ctime) -> bytes:
    mdhd = _full_box(
        b"mdhd", 0, 0,
        struct.pack(">IIIIHH", ctime, ctime, timescale, duration,
                    0x55C4, 0))  # language 'und'
    hdlr = _full_box(b"hdlr", 0, 0,
                     struct.pack(">I4s", 0, b"vide") + b"\x00" * 12
                     + b"VideoHandler\x00")
    return _box(b"mdia", mdhd + hdlr + minf)


def _trak(mdia: bytes, width, height, duration_mv, ctime) -> bytes:
    tkhd = _full_box(
        b"tkhd", 0, 3,  # enabled | in movie
        struct.pack(">IIII", ctime, ctime, 1, 0)
        + struct.pack(">I", duration_mv) + b"\x00" * 8
        + struct.pack(">hhhh", 0, 0, 0, 0)
        + struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        + struct.pack(">II", width << 16, height << 16))
    return _box(b"trak", tkhd + mdia)


def _moov(trak: bytes, timescale, duration, ctime) -> bytes:
    mvhd = _full_box(
        b"mvhd", 0, 0,
        struct.pack(">IIII", ctime, ctime, timescale, duration)
        + struct.pack(">IH", 0x00010000, 0x0100) + b"\x00" * 10
        + struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
        + b"\x00" * 24 + struct.pack(">I", 2))  # next track id
    return _box(b"moov", mvhd + trak)


def encode_jpeg(frame: np.ndarray, quality: int = 90) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(frame)).save(
        buf, format="JPEG", quality=int(quality))
    return buf.getvalue()


def write_mjpeg_mp4(path: str, frames, fps: float = 30.0,
                    quality: int = 90) -> str:
    """Write (N, H, W, 3) uint8 frames as an MJPEG-in-MP4 video.

    Pure Python + PIL; no ffmpeg. Returns ``path``.
    """
    frames = np.asarray(frames)
    if frames.ndim == 3:
        frames = frames[None] if frames.shape[-1] == 3 else frames[..., None]
    if frames.ndim != 4 or frames.shape[-1] not in (1, 3):
        raise ValueError(f"expected (N, H, W, 3) frames, got {frames.shape}")
    if frames.shape[-1] == 1:
        frames = np.repeat(frames, 3, axis=-1)
    if frames.dtype != np.uint8:
        raise ValueError(f"expected uint8 frames, got {frames.dtype}")
    n, height, width = frames.shape[:3]
    if n == 0:
        raise ValueError("no frames")

    timescale = 1000
    delta = max(int(round(timescale / float(fps))), 1)
    duration = n * delta
    ctime = int((datetime.now(timezone.utc) - _MP4_EPOCH).total_seconds())

    jpegs = [encode_jpeg(f, quality) for f in frames]
    sizes = [len(j) for j in jpegs]

    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 0x200) + b"isommp41")
    # chunk data starts right after the ftyp box + the 8-byte mdat header
    chunk_offset = len(ftyp) + 8
    mdat = _box(b"mdat", b"".join(jpegs))
    stbl = _stbl(sizes, chunk_offset, width, height, delta, timescale)
    mdia = _mdia(_minf(stbl), timescale, duration, ctime)
    trak = _trak(mdia, width, height, duration, ctime)
    moov = _moov(trak, timescale, duration, ctime)

    with open(path, "wb") as f:
        f.write(ftyp)
        f.write(mdat)
        f.write(moov)
    return path


def parse_boxes(data: bytes, offset: int = 0, end: int | None = None):
    """Yield (kind, payload_start, payload_end) for top-level boxes.

    Test/debug helper — enough of a parser to verify our own output and
    to pull samples back out (`read_mjpeg_mp4`).
    """
    end = len(data) if end is None else end
    while offset + 8 <= end:
        size = struct.unpack(">I", data[offset:offset + 4])[0]
        kind = data[offset + 4:offset + 8]
        if size == 1:  # 64-bit largesize
            size = struct.unpack(">Q", data[offset + 8:offset + 16])[0]
            yield kind, offset + 16, offset + size
        else:
            if size == 0:
                size = end - offset
            yield kind, offset + 8, offset + size
        offset += size


def _find(data, path, offset=0, end=None):
    kind, rest = path[0], path[1:]
    for k, s, e in parse_boxes(data, offset, end):
        if k == kind:
            return (s, e) if not rest else _find(data, rest, s, e)
    raise KeyError(b"/".join(path).decode())


def read_mjpeg_mp4(path: str):
    """Decode an MP4 written by `write_mjpeg_mp4` back to frames + fps."""
    from PIL import Image

    with open(path, "rb") as f:
        data = f.read()
    stbl_s, stbl_e = _find(
        data, [b"moov", b"trak", b"mdia", b"minf", b"stbl"])
    boxes = {k: (s, e) for k, s, e in parse_boxes(data, stbl_s, stbl_e)}

    s, _ = boxes[b"stsz"]
    n = struct.unpack(">I", data[s + 8:s + 12])[0]
    sizes = struct.unpack(f">{n}I", data[s + 12:s + 12 + 4 * n])
    s, _ = boxes[b"stco"]
    offset = struct.unpack(">I", data[s + 8:s + 12])[0]
    s, _ = boxes[b"stts"]
    _, _, delta = struct.unpack(">III", data[s + 4:s + 16])

    mdhd_s, _ = _find(data, [b"moov", b"trak", b"mdia", b"mdhd"])
    timescale = struct.unpack(">I", data[mdhd_s + 12:mdhd_s + 16])[0]

    frames = []
    for size in sizes:
        jpeg = data[offset:offset + size]
        frames.append(np.asarray(Image.open(io.BytesIO(jpeg)).convert("RGB")))
        offset += size
    return np.stack(frames), timescale / delta

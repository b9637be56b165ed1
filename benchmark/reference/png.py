"""A small PNG reader and writer on ``zlib`` and numpy.

Covers what the scene directories hold: 8-bit, non-interlaced, greyscale
or RGB images. Anything else raises. Like OpenCV's ``imread``/``imwrite``,
colour arrays are in **BGR** order and ``read_png`` always returns
[H, W, 3] uint8 (a greyscale file is repeated over the three channels).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}  # colour type -> channels (grey, RGB)


def _unfilter_sequential(line: list, prev: list, c: int, ftype: int) -> list:
    """Average (3) and Paeth (4) depend on the reconstructed left byte, so
    they run byte by byte (on Python ints, faster than numpy scalars)."""
    cur = [0] * len(line)
    for x, v in enumerate(line):
        a = cur[x - c] if x >= c else 0
        b = prev[x]
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            cc = prev[x - c] if x >= c else 0
            p = a + b - cc
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cc)
        cur[x] = (v + pred) & 0xFF
    return cur


def _unfilter(raw: bytes, h: int, w: int, c: int) -> np.ndarray:
    stride = w * c
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        ftype, line = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum of each channel along the row
            cur = np.cumsum(line.reshape(w, c), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):
            cur = np.asarray(_unfilter_sequential(line.tolist(), prev.tolist(), c, ftype),
                             np.int64)
        else:
            raise ValueError(f"PNG: bad filter type {ftype}")
        out[y] = cur
        prev = cur
    return out.reshape(h, w, c)


def read_png(path: str) -> np.ndarray:
    """[H, W, 3] uint8 in BGR order."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        ctype = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey or RGB PNGs are supported "
                         f"(bit depth {depth}, colour type {color}, interlace {interlace})")
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w, _CHANNELS[color])
    if img.shape[2] == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img[:, :, ::-1])


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write [H, W] grey or [H, W, 3] BGR uint8 as an 8-bit PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png needs uint8, got {img.dtype}")
    if img.ndim == 2:
        color, rgb = 0, img[:, :, None]
    elif img.ndim == 3 and img.shape[2] == 3:
        color, rgb = 2, img[:, :, ::-1]
    else:
        raise ValueError(f"write_png needs [H,W] or [H,W,3], got {img.shape}")
    h, w, c = rgb.shape
    rows = np.zeros((h, w * c + 1), np.uint8)  # filter type 0 on every row
    rows[:, 1:] = rgb.reshape(h, w * c)
    with open(path, "wb") as f:
        f.write(_SIG)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))

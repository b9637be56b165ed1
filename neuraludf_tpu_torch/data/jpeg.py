"""A baseline JPEG decoder in numpy: what ``cv2.imread(path)`` returns for
the files a scene directory holds, without OpenCV.

``read_jpeg(path)`` returns [H, W, 3] uint8 in **BGR** order (a greyscale
file is repeated over the three channels), decoded as libjpeg-turbo
decodes by default, all in integer arithmetic:

* the entropy decode of a sequential Huffman file (SOF0, SOF1 at 8 bits)
  coded in one scan of every component, as encoders write baseline files,
  with restart intervals (DRI, RSTn), through a lookup table of the next 16
  bits that also holds the value bits where they fit;
* dequantisation and the ``JDCT_ISLOW`` inverse DCT of ``jidctint.c``
  (CONST_BITS 13, PASS1_BITS 2) over all blocks at once;
* "fancy" chroma upsampling, the triangle filters of ``jdsample.c``
  (``h2v1_fancy_upsample``, ``h1v2_fancy_upsample``, ``h2v2_fancy_upsample``
  with their alternating rounding biases; box replication for a plane two
  samples wide or less and for other integer ratios), edges replicated;
* the fixed-point YCbCr -> RGB tables of ``jdcolor.c`` (SCALEBITS 16).

Progressive (SOF2), lossless (SOF3), hierarchical and arithmetic-coded files,
files coded in several scans, precisions other than 8 bits, four-component
and RGB files and an EXIF
orientation other than 1 raise ``ValueError`` naming the file and the
marker, as does a corrupt or truncated entropy stream: the decoder never
returns an image it cannot vouch for.
"""

from __future__ import annotations

import struct

import numpy as np

# zigzag position -> natural (row-major) index of an 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

_SOF_NAMES = {0xC0: "SOF0 (baseline)", 0xC1: "SOF1 (extended sequential)",
              0xC2: "SOF2 (progressive)", 0xC3: "SOF3 (lossless)",
              0xC5: "SOF5 (differential sequential)", 0xC6: "SOF6 (differential progressive)",
              0xC7: "SOF7 (differential lossless)", 0xC9: "SOF9 (arithmetic sequential)",
              0xCA: "SOF10 (arithmetic progressive)", 0xCB: "SOF11 (arithmetic lossless)",
              0xCD: "SOF13 (arithmetic differential sequential)",
              0xCE: "SOF14 (arithmetic differential progressive)",
              0xCF: "SOF15 (arithmetic differential lossless)"}

# jidctint.c constants: FIX(x) = round(x * 2^13)
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100, FIX_0_765366865 = 2446, 3196, 4433, 6270
FIX_0_899976223, FIX_1_175875602, FIX_1_501321110, FIX_1_847759065 = 7373, 9633, 12299, 15137
FIX_1_961570560, FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16069, 16819, 20995, 25172


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.cid, self.h, self.v, self.tq = cid, h, v, tq
        self.qtable = None  # natural order, latched at the scan
        self.coefs = None  # flat list, 64 per block, natural order
        self.bw = self.bh = 0  # blocks a row, block rows (the interleaved, MCU-padded grid)
        self.dw = self.dh = 0  # the component's own samples (downsampled width, height)


def _huffman_table(counts, symbols, is_dc: bool) -> list:
    """A 65,536-entry lookup of the next 16 bits: (bits, run, value, extra).
    ``bits`` is the code's length plus, where they fit in the 16, its value
    bits; then ``value`` is the decoded coefficient (a DC difference) and
    ``extra`` 0, else ``extra`` value bits follow the code. ``run`` is -1 for
    an end of block (an AC symbol of size 0 and a run other than 15); a ZRL
    is a run of 15 with value 0. (0, ...) marks bits no code starts."""
    table = [(0, 0, 0, 0)] * 65536
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            sym = symbols[k]
            k += 1
            run, size = (0, sym) if is_dc else (sym >> 4, sym & 15)
            lo, span = code << (16 - length), 1 << (16 - length)
            code += 1
            if size > (11 if is_dc else 10):
                continue  # not a symbol of 8-bit data: decoding it raises
            if not is_dc and size == 0:
                table[lo:lo + span] = [(length, 15 if run == 15 else -1, 0, 0)] * span
            elif length + size > 16:
                table[lo:lo + span] = [(length, run, 0, size)] * span
            else:
                shift, mask, half = 16 - length - size, (1 << size) - 1, 1 << size >> 1
                for v in range(lo, lo + span):
                    x = (v >> shift) & mask
                    table[v] = (length + size, run, x - mask if x < half else x, 0)
        if counts[length - 1] and code >= (1 << length):
            raise ValueError("bad Huffman table (codes overflow their length)")
        code <<= 1
    return table


def _decode_segment(seg: bytes, blocks, preds: list) -> None:
    """The entropy-coded blocks of one restart interval into their
    components' coefficient lists."""
    buf = np.frombuffer(seg + b"\0" * 8, np.uint8).astype(np.uint32)
    W = ((buf[:-3] << 24) | (buf[1:-2] << 16) | (buf[2:-1] << 8) | buf[3:]).tolist()
    zz = ZIGZAG.tolist()
    p = 0
    for ci, out, base, dct, act in blocks:
        # DC: the category, then its bits, a difference to the predictor
        n, _, x, s = dct[(W[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
        if n == 0:
            raise ValueError("bad Huffman code")
        p += n
        if s:
            x = (W[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
            p += s
            if x < (1 << (s - 1)):
                x -= (1 << s) - 1
        preds[ci] += x
        out[base] = preds[ci]
        k = 1
        while k < 64:
            n, r, x, s = act[(W[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
            if n == 0:
                raise ValueError("bad Huffman code")
            p += n
            if r < 0:  # end of block
                break
            k += r
            if s:
                x = (W[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                p += s
                if x < (1 << (s - 1)):
                    x -= (1 << s) - 1
            if k > 63:
                raise ValueError("coefficient index past 63")
            out[base + zz[k]] = x
            k += 1
    if p > 8 * len(seg):
        raise ValueError("entropy-coded data ends early")


def _entropy_segments(data: bytes, pos: int):
    """The restart intervals of the scan starting at ``pos``, byte stuffing
    removed, and the position of the marker that ends the scan."""
    segments, start, i = [], pos, pos
    while True:
        j = data.find(b"\xff", i)
        e = j + 1
        while 0 < e < len(data) and data[e] == 0xFF:  # fill bytes
            e += 1
        if j < 0 or e >= len(data):
            raise ValueError("entropy-coded data without an ending marker")
        if data[e] == 0x00:  # a stuffed 0xFF
            i = e + 1
            continue
        segments.append(data[start:j].replace(b"\xff\x00", b"\xff"))
        if not 0xD0 <= data[e] <= 0xD7:
            return segments, e - 1
        i = start = e + 1


def _idct_1d(c0, c1, c2, c3, c4, c5, c6, c7):
    """jidctint.c's even and odd parts over arrays: the eight outputs,
    scaled by 2^CONST_BITS, undescaled."""
    z1 = (c2 + c6) * FIX_0_541196100
    tmp2 = z1 - c6 * FIX_1_847759065
    tmp3 = z1 + c2 * FIX_0_765366865
    tmp0 = (c0 + c4) << CONST_BITS
    tmp1 = (c0 - c4) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2

    t0, t1, t2, t3 = c7, c5, c3, c1
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


# jdmaster.c's post-IDCT range limit, indexed by (x & 1023): x + 128 clamped
# to [0, 255] for |x| < 512, and wrapping as libjpeg's table does beyond
_IDCT_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384),
                              np.arange(0, 128)]).astype(np.uint8)


def idct_islow(blocks: np.ndarray) -> np.ndarray:
    """Dequantised coefficients [..., 8, 8] (rows: vertical frequency) ->
    samples [..., 8, 8] uint8, as ``jpeg_idct_islow``. Its shortcuts for
    all-zero AC columns and rows give the same values as the full
    arithmetic, so there are none here."""
    c = blocks.astype(np.int64)
    ws = _idct_1d(*(c[..., k, :] for k in range(8)))  # pass 1: columns
    ws = np.stack([_descale(w, CONST_BITS - PASS1_BITS) for w in ws], axis=-2)
    out = _idct_1d(*(ws[..., k] for k in range(8)))  # pass 2: rows
    out = np.stack([_descale(o, CONST_BITS + PASS1_BITS + 3) for o in out], axis=-1)
    return _IDCT_LIMIT[out & 1023]


def _upsample(plane: np.ndarray, rh: int, rv: int) -> np.ndarray:
    """jdsample.c: a component's [dh, dw] samples to [dh * rv, dw * rh]."""
    dh, dw = plane.shape
    x = plane.astype(np.int32)
    if (rh, rv) == (1, 1):
        return plane
    if (rh, rv) == (2, 1) and dw > 2:  # h2v1_fancy_upsample
        left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
        right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
        out = np.empty((dh, 2 * dw), np.int32)
        out[:, 0::2] = (3 * x + left + 1) >> 2
        out[:, 1::2] = (3 * x + right + 2) >> 2
        return out.astype(np.uint8)
    if (rh, rv) == (1, 2):  # h1v2_fancy_upsample
        above = np.concatenate([x[:1], x[:-1]], axis=0)
        below = np.concatenate([x[1:], x[-1:]], axis=0)
        out = np.empty((2 * dh, dw), np.int32)
        out[0::2] = (3 * x + above + 1) >> 2
        out[1::2] = (3 * x + below + 2) >> 2
        return out.astype(np.uint8)
    if (rh, rv) == (2, 2) and dw > 2:  # h2v2_fancy_upsample
        out = np.empty((2 * dh, 2 * dw), np.int32)
        for v, near in ((0, np.concatenate([x[:1], x[:-1]], axis=0)),
                        (1, np.concatenate([x[1:], x[-1:]], axis=0))):
            cs = 3 * x + near  # column sums, 3 * nearer row + the further
            last = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
            nxt = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
            out[v::2, 0::2] = (3 * cs + last + 8) >> 4
            out[v::2, 1::2] = (3 * cs + nxt + 7) >> 4
        return out.astype(np.uint8)
    return np.repeat(np.repeat(plane, rv, axis=0), rh, axis=1)  # box (int_upsample)


def _ycc_to_bgr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c's ycc_rgb_convert: its SCALEBITS-16 tables, then the
    [0, 255] range limit; channels in BGR order."""
    fix = lambda v: int(v * 65536 + 0.5)
    half = 1 << 15
    xs = np.arange(256, dtype=np.int64) - 128
    cr_r = (fix(1.40200) * xs + half) >> 16
    cb_b = (fix(1.77200) * xs + half) >> 16
    cr_g = -fix(0.71414) * xs
    cb_g = -fix(0.34414) * xs + half
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([b, g, r], axis=-1), 0, 255).astype(np.uint8)


def _exif_orientation(body: bytes) -> int:
    """Tag 0x0112 of an APP1 Exif segment's first IFD, 1 where absent."""
    if body[:6] != b"Exif\0\0" or len(body) < 14:
        return 1
    tiff = body[6:]
    end = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if end is None:
        return 1
    (ifd,) = struct.unpack(end + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    (n,) = struct.unpack(end + "H", tiff[ifd:ifd + 2])
    for e in range(n):
        off = ifd + 2 + 12 * e
        if off + 12 > len(tiff):
            break
        tag, typ = struct.unpack(end + "HH", tiff[off:off + 4])
        if tag == 0x0112 and typ == 3:
            return struct.unpack(end + "H", tiff[off + 8:off + 10])[0]
    return 1


def _parse_and_decode(data: bytes):
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    qtables, dc_tables, ac_tables = {}, {}, {}
    comps, frame, restart, scanned = [], None, 0, False
    saw_jfif, adobe_transform = False, None
    pos = 2
    while True:
        while pos < len(data) and data[pos] == 0xFF and pos + 1 < len(data) \
                and data[pos + 1] == 0xFF:
            pos += 1  # fill bytes
        if pos + 1 >= len(data):
            if frame is None:
                raise ValueError("no frame before the end of the file")
            break  # no EOI: what was decoded is the image
        if data[pos] != 0xFF:
            raise ValueError(f"expected a marker at byte {pos}")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        pos += length
        if marker in _SOF_NAMES:
            if marker not in (0xC0, 0xC1):
                raise ValueError(f"marker {_SOF_NAMES[marker]} (0xFF{marker:02X}) is not "
                                 f"supported: only baseline and extended sequential Huffman "
                                 f"files decode")
            if frame is not None:
                raise ValueError("a second SOF marker")
            precision, H, W, nf = struct.unpack(">BHHB", body[:6])
            if precision != 8:
                raise ValueError(f"marker {_SOF_NAMES[marker]} with {precision}-bit samples: "
                                 f"only 8-bit files decode")
            if nf not in (1, 3):
                raise ValueError(f"marker {_SOF_NAMES[marker]} with {nf} components: only 1 "
                                 f"or 3 decode")
            if H == 0 or W == 0:
                raise ValueError("a zero image height (DNL) or width is not supported")
            for c in range(nf):
                cid, hv, tq = body[6 + 3 * c:9 + 3 * c]
                h, v = hv >> 4, hv & 15
                if not (1 <= h <= 4 and 1 <= v <= 4):
                    raise ValueError(f"bad sampling factors {h}x{v}")
                comps.append(_Component(cid, h, v, tq))
            frame = (H, W)
            max_h, max_v = max(c.h for c in comps), max(c.v for c in comps)
            mcux, mcuy = -(-W // (8 * max_h)), -(-H // (8 * max_v))
            for c in comps:
                c.bw, c.bh = mcux * c.h, mcuy * c.v
                c.dw, c.dh = -(-W * c.h // max_h), -(-H * c.v // max_v)
                c.coefs = [0] * (c.bw * c.bh * 64)
        elif marker == 0xDB:  # DQT
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq == 0:
                    vals = np.frombuffer(body[i + 1:i + 65], np.uint8).astype(np.int64)
                    i += 65
                elif pq == 1:
                    vals = np.frombuffer(body[i + 1:i + 129], ">u2").astype(np.int64)
                    i += 129
                else:
                    raise ValueError(f"bad DQT precision {pq}")
                if len(vals) != 64:
                    raise ValueError("short DQT segment")
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals
                qtables[tq] = table
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1:i + 17])
                n = sum(counts)
                symbols = list(body[i + 17:i + 17 + n])
                if tc > 1 or len(symbols) != n:
                    raise ValueError("bad DHT segment")
                (ac_tables if tc else dc_tables)[th] = _huffman_table(counts, symbols, tc == 0)
                i += 17 + n
        elif marker == 0xCC:
            raise ValueError("marker DAC (0xFFCC): arithmetic coding is not supported")
        elif marker == 0xDD:  # DRI
            (restart,) = struct.unpack(">H", body[:2])
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("SOS before SOF")
            ns = body[0]
            if scanned or ns != len(comps):
                raise ValueError(f"marker SOS (0xFFDA) with {ns} of the frame's {len(comps)} "
                                 f"components{' after another scan' if scanned else ''}: only "
                                 f"files coded in one scan of every component decode")
            scanned = True
            scan = []
            for c in range(ns):
                cs, t = body[1 + 2 * c], body[2 + 2 * c]
                comp = next((k for k in comps if k.cid == cs), None)
                if comp is None:
                    raise ValueError(f"SOS names an unknown component {cs}")
                if (t >> 4) not in dc_tables or (t & 15) not in ac_tables:
                    raise ValueError("SOS names a Huffman table not defined")
                if comp.tq not in qtables:
                    raise ValueError(f"component {cs} names an undefined quantisation table")
                comp.qtable = qtables[comp.tq]
                scan.append((comps.index(comp), comp, dc_tables[t >> 4], ac_tables[t & 15]))
            ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
            if (ss, se, a) != (0, 63, 0):
                raise ValueError(f"SOS with Ss={ss} Se={se} Ah/Al={a:#x}: not a sequential scan")
            segments, pos = _entropy_segments(data, pos)
            _decode_scan(scan, segments, restart, frame, comps)
        elif marker == 0xE0 and body[:5] == b"JFIF\0":
            saw_jfif = True
        elif marker == 0xE1 and _exif_orientation(body) != 1:
            raise ValueError(f"marker APP1 (0xFFE1): EXIF orientation "
                             f"{_exif_orientation(body)} is not supported")
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe_transform = body[11]
        # other APPn, COM and the rest: skipped
    if frame is None:
        raise ValueError("no frame")
    if not scanned:
        raise ValueError("no scan")
    _check_ycc(comps, saw_jfif, adobe_transform)
    return frame, comps


def _check_ycc(comps, saw_jfif: bool, adobe_transform) -> None:
    """jdapimin.c default_decompress_parms: a three-component file is
    YCbCr unless an Adobe marker says transform 0 or, with neither a JFIF
    nor an Adobe marker, its component ids spell R, G, B. Those RGB files
    are refused."""
    if len(comps) == 1 or saw_jfif:
        return
    rgb = (adobe_transform == 0 if adobe_transform is not None
           else tuple(c.cid for c in comps) == (82, 71, 66))
    if rgb:
        raise ValueError("an RGB (untransformed) three-component file is not supported")


def _decode_scan(scan, segments, restart: int, frame, comps) -> None:
    H, W = frame
    if len(scan) == 1:  # one component: non-interleaved, one block an MCU over its own samples
        ci, comp, dct, act = scan[0]
        bw, bh = -(-comp.dw // 8), -(-comp.dh // 8)
        order = [(ci, comp.coefs, (by * comp.bw + bx) * 64, dct, act)
                 for by in range(bh) for bx in range(bw)]
        per_mcu = 1
    else:
        max_h, max_v = max(c.h for c in comps), max(c.v for c in comps)
        mcux, mcuy = -(-W // (8 * max_h)), -(-H // (8 * max_v))
        per_mcu = sum(comp.h * comp.v for _, comp, _, _ in scan)
        order = []
        for my in range(mcuy):
            for mx in range(mcux):
                for ci, comp, dct, act in scan:
                    for v in range(comp.v):
                        row = (my * comp.v + v) * comp.bw + mx * comp.h
                        order.extend((ci, comp.coefs, (row + h) * 64, dct, act)
                                     for h in range(comp.h))
    n_mcu = len(order) // per_mcu
    per_segment = restart * per_mcu if restart else len(order)
    n_segments = -(-n_mcu // restart) if restart else 1
    if len(segments) < n_segments:
        raise ValueError(f"{len(segments)} restart intervals where {n_segments} are due")
    for s in range(n_segments):
        preds = [0] * len(comps)
        _decode_segment(segments[s], order[s * per_segment:(s + 1) * per_segment], preds)


def read_jpeg(path: str) -> np.ndarray:
    """[H, W, 3] uint8 in BGR order, as ``cv2.imread(path)``; raises
    ``ValueError`` naming the file for what it does not decode."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        (H, W), comps = _parse_and_decode(data)
    except (IndexError, struct.error) as e:
        raise ValueError(f"{path}: truncated or corrupt JPEG data ({e})") from e
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from e
    max_h, max_v = max(c.h for c in comps), max(c.v for c in comps)
    planes = []
    for c in comps:
        if max_h % c.h or max_v % c.v:
            raise ValueError(f"{path}: sampling factors {c.h}x{c.v} against {max_h}x{max_v}: "
                             f"not an integer ratio")
        coefs = np.asarray(c.coefs, np.int64).reshape(c.bh, c.bw, 8, 8) * c.qtable.reshape(8, 8)
        samples = idct_islow(coefs).transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
        planes.append(_upsample(samples[:c.dh, :c.dw], max_h // c.h, max_v // c.v)[:H, :W])
    if len(planes) == 1:
        return np.repeat(planes[0][:, :, None], 3, axis=2)
    return _ycc_to_bgr(*planes)

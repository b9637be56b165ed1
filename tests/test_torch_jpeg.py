"""The port's baseline JPEG decoder (``neuraludf_tpu_torch/data/jpeg.py``)
against ``cv2.imread`` on files ``cv2.imwrite`` writes: every quality,
chroma sampling, size, restart interval and Huffman table option the
BlendedMVS layout can hold, to within one 8-bit level (measured: 0, the same
integer arithmetic as libjpeg-turbo's default decode); the committed
BlendedMVS-layout scene against its manifest; and a refusal, naming the file
and the marker, for what the decoder does not decode."""

import hashlib
import json
import struct
from pathlib import Path

import cv2
import numpy as np
import pytest

from neuraludf_tpu_torch.data.jpeg import read_jpeg

TOL_LEVELS = 1  # max |read_jpeg - cv2.imread| in 8-bit levels; measured 0 in every case
FIXTURE = Path(__file__).resolve().parent / "data" / "bmvs_sphere"

SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def textured(h, w, seed=0, channels=3):
    """Smooth gradients, edges and noise: every coefficient band in use."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([128 + 100 * np.sin(x / 7.0 + y / 11.0),
                     128 + 90 * np.cos(x / 5.0 - y / 3.0),
                     (x * 3 + y * 5) % 256], -1)[..., :channels]
    img = base + rng.normal(0, 20, base.shape) + 60 * ((x // 9 + y // 7) % 2)[..., None]
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img[..., 0] if channels == 1 else img


CASES = ([(f"q{q}-{s}-37x53", (37, 53), [cv2.IMWRITE_JPEG_QUALITY, q,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[s]])
          for q in (50, 75, 95, 100) for s in ("444", "422", "420")]
         + [(f"q95-{s}-37x53", (37, 53), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[s]])
            for s in ("440", "411")]
         + [("q95-420-576x768", (576, 768), []),
            ("q95-420-3x2", (3, 2), []),
            ("grey-37x53", (37, 53, 1), []),
            ("grey-restart-100x70", (100, 70, 1), [cv2.IMWRITE_JPEG_RST_INTERVAL, 3]),
            ("restart-420-37x53", (37, 53), [cv2.IMWRITE_JPEG_RST_INTERVAL, 1]),
            ("restart-444-37x53", (37, 53), [cv2.IMWRITE_JPEG_RST_INTERVAL, 2,
                                             cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING["444"]]),
            ("optimised-37x53", (37, 53), [cv2.IMWRITE_JPEG_OPTIMIZE, 1]),
            ("optimised-restart-q100-64x48", (64, 48), [cv2.IMWRITE_JPEG_OPTIMIZE, 1,
                                                       cv2.IMWRITE_JPEG_RST_INTERVAL, 5,
                                                       cv2.IMWRITE_JPEG_QUALITY, 100])])


@pytest.mark.parametrize("name,shape,flags", CASES, ids=[c[0] for c in CASES])
def test_read_jpeg_matches_opencv(tmp_path, name, shape, flags):
    img = textured(*shape[:2], channels=shape[2] if len(shape) == 3 else 3)
    path = str(tmp_path / f"{name}.jpg")
    assert cv2.imwrite(path, img, flags)
    ref = cv2.imread(path)
    got = read_jpeg(path)
    assert got.dtype == np.uint8 and got.shape == ref.shape == shape[:2] + (3,)
    assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= TOL_LEVELS


def test_bmvs_fixture_matches_its_manifest():
    """Every file of the committed scene decodes to the sha256 of the array
    cv2.imread decodes (the manifest's and this machine's OpenCV's)."""
    manifest = json.loads((FIXTURE / "manifest.json").read_text())
    assert len(manifest["files"]) == 16
    for rel, ref in manifest["files"].items():
        got = read_jpeg(str(FIXTURE / rel))
        assert list(got.shape) == ref["shape"] == [576, 768, 3], rel
        assert hashlib.sha256(got.tobytes()).hexdigest() == ref["sha256"], rel
        np.testing.assert_array_equal(got, cv2.imread(str(FIXTURE / rel)), err_msg=rel)


def test_progressive_raises_naming_file_and_marker(tmp_path):
    path = str(tmp_path / "progressive.jpg")
    assert cv2.imwrite(path, textured(37, 53), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match=r"progressive\.jpg: marker SOF2 \(progressive\)"):
        read_jpeg(path)


def with_segment(data: bytes, marker: int, body: bytes) -> bytes:
    """``data`` with one more marker segment right after SOI."""
    return data[:2] + struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body + data[2:]


def exif(orientation: int) -> bytes:
    """An APP1 Exif body, big-endian TIFF, one IFD entry: the orientation."""
    return (b"Exif\0\0" + b"MM\0\x2a" + struct.pack(">I", 8) + struct.pack(">H", 1)
            + struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(">I", 0))


def test_refuses_what_it_cannot_decode(tmp_path):
    """An RGB (untransformed) frame, a file of two scans, a scan of one of
    three components, an arithmetic-coded frame, a 12-bit frame, an EXIF
    rotation and a truncated stream raise; the decoder never returns such an
    image."""
    src = tmp_path / "base.jpg"
    assert cv2.imwrite(str(src), textured(37, 53))
    data = src.read_bytes()
    sof = data.index(b"\xff\xc0")
    # no JFIF marker and component ids R, G, B: libjpeg reads the file as RGB
    assert data[2:4] == b"\xff\xe0"
    rgb = bytearray(data[:2] + data[4 + struct.unpack(">H", data[4:6])[0]:])
    rsof, rsos = rgb.index(b"\xff\xc0"), rgb.index(b"\xff\xda")
    for i, cid in enumerate(b"RGB"):
        rgb[rsof + 10 + 3 * i], rgb[rsos + 5 + 2 * i] = cid, cid
    # a second scan, and a scan of one of the three components
    sos, eoi = data.index(b"\xff\xda"), len(data) - 2
    assert data[eoi:] == b"\xff\xd9"
    n = struct.unpack(">H", data[sos + 2:sos + 4])[0]
    body = data[sos + 4:sos + 2 + n]
    one = bytes([1]) + body[1:3] + body[7:10]
    cases = {
        "rgb": (bytes(rgb), "RGB"),
        "two_scans": (data[:eoi] + data[sos:], "3 of the frame's 3 components after another scan"),
        "one_component_scan": (data[:sos] + b"\xff\xda" + struct.pack(">H", len(one) + 2) + one
                               + data[sos + 2 + n:], "1 of the frame's 3 components"),
        "arithmetic": (data[:sof + 1] + b"\xc9" + data[sof + 2:], "SOF9"),
        "twelve_bit": (data[:sof + 4] + b"\x0c" + data[sof + 5:], "12-bit"),
        "exif_rotated": (with_segment(data, 0xE1, exif(6)), "EXIF orientation 6"),
        "truncated": (data[:len(data) // 2], "truncated|ends early|without an ending marker"),
    }
    for name, (blob, message) in cases.items():
        path = tmp_path / f"{name}.jpg"
        path.write_bytes(blob)
        with pytest.raises(ValueError, match=message) as info:
            read_jpeg(str(path))
        assert str(path) in str(info.value)
    # an Exif block with orientation 1 is read through
    path = tmp_path / "exif_upright.jpg"
    path.write_bytes(with_segment(data, 0xE1, exif(1)))
    np.testing.assert_array_equal(read_jpeg(str(path)), cv2.imread(str(src)))

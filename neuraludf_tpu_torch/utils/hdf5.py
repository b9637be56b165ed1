"""A minimal HDF5 writer: one float32 dataset at the root of a new file
(the card has no h5py).

The file is what the HDF5 format calls the latest layout: a version 2
superblock, version 2 object headers with Jenkins lookup3 checksums, and a
root group whose one link is stored in its header (a "compact" group, no
B-tree or heap). The dataset's data is one contiguous block after the
headers. HDF5 1.8 and later (h5py, ``h5dump``) read such files.

Layout of the file: superblock, root group header, dataset header, data.
"""

from __future__ import annotations

import struct

import numpy as np

UNDEF = 0xFFFFFFFFFFFFFFFF  # an undefined address
_SUPERBLOCK_SIZE = 48


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' ``hashlittle`` (lookup3.c), the checksum of HDF5's
    metadata."""
    M = 0xFFFFFFFF
    rot = lambda x, k: ((x << k) | (x >> (32 - k))) & M
    length = len(data)
    a = b = c = (0xDEADBEEF + length + initval) & M

    def mix(a, b, c):
        a = (a - c) & M; a ^= rot(c, 4); c = (c + b) & M
        b = (b - a) & M; b ^= rot(a, 6); a = (a + c) & M
        c = (c - b) & M; c ^= rot(b, 8); b = (b + a) & M
        a = (a - c) & M; a ^= rot(c, 16); c = (c + b) & M
        b = (b - a) & M; b ^= rot(a, 19); a = (a + c) & M
        c = (c - b) & M; c ^= rot(b, 4); b = (b + a) & M
        return a, b, c

    def final(a, b, c):
        c ^= b; c = (c - rot(b, 14)) & M
        a ^= c; a = (a - rot(c, 11)) & M
        b ^= a; b = (b - rot(a, 25)) & M
        c ^= b; c = (c - rot(b, 16)) & M
        a ^= c; a = (a - rot(c, 4)) & M
        b ^= a; b = (b - rot(a, 14)) & M
        c ^= b; c = (c - rot(b, 24)) & M
        return c

    off = 0
    while length > 12:
        k0, k1, k2 = struct.unpack_from("<III", data, off)
        a, b, c = mix((a + k0) & M, (b + k1) & M, (c + k2) & M)
        off += 12
        length -= 12
    if length == 0:
        return c
    tail = data[off:] + b"\0" * (12 - length)
    k0, k1, k2 = struct.unpack("<III", tail)
    return final((a + k0) & M, (b + k1) & M, (c + k2) & M)


def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    return struct.pack("<BHB", mtype, len(body), flags) + body


def _object_header(messages: bytes) -> bytes:
    """Version 2 object header: no times, no attribute phase change, the
    size of chunk 0 in 4 bytes (flags bits 0-1 = 2)."""
    head = b"OHDR" + struct.pack("<BBI", 2, 0x02, len(messages)) + messages
    return head + struct.pack("<I", lookup3(head))


def _dataset_header(shape, data_addr: int, data_size: int) -> bytes:
    dataspace = struct.pack("<BBBB", 2, len(shape), 0, 1) + b"".join(
        struct.pack("<Q", d) for d in shape)
    # IEEE float32, little endian: class 1, version 1; bit field: mantissa
    # normalised with an implied leading bit, sign at bit 31; then offset 0,
    # precision 32, exponent at 23 of size 8, mantissa at 0 of size 23, bias 127
    datatype = (struct.pack("<B3BI", 0x11, 0x20, 31, 0, 4)
                + struct.pack("<HHBBBBI", 0, 32, 23, 8, 0, 23, 127))
    # fill value: version 3, allocated late, written if set, none set
    fill = struct.pack("<BB", 3, 0x0A)
    layout = struct.pack("<BBQQ", 3, 1, data_addr, data_size)  # contiguous
    return _object_header(_message(1, dataspace) + _message(3, datatype, flags=1)
                          + _message(5, fill) + _message(8, layout))


def _group_header(name: str, target: int) -> bytes:
    link_info = struct.pack("<BBQQ", 0, 0, UNDEF, UNDEF)  # no dense storage
    group_info = struct.pack("<BB", 0, 0)
    encoded = name.encode("utf-8")
    if len(encoded) > 255:
        raise ValueError("dataset name longer than 255 bytes")
    # version 1, flags 0: a hard link, name length in one byte
    link = struct.pack("<BBB", 1, 0, len(encoded)) + encoded + struct.pack("<Q", target)
    return _object_header(_message(2, link_info) + _message(10, group_info)
                          + _message(6, link))


def write_dataset(path: str, name: str, data: np.ndarray) -> None:
    """Write ``data`` as the float32 dataset ``name`` of a new HDF5 file."""
    arr = np.ascontiguousarray(data, dtype="<f4")
    if arr.ndim == 0:
        raise ValueError("write_dataset needs an array of rank 1 or more")
    # the root header's size does not depend on the dataset's address
    root_size = len(_group_header(name, 0))
    dset_addr = _SUPERBLOCK_SIZE + root_size
    dset_size = len(_dataset_header(arr.shape, 0, 0))
    data_addr = dset_addr + dset_size
    eof = data_addr + arr.nbytes
    root = _group_header(name, dset_addr)
    dset = _dataset_header(arr.shape, data_addr, arr.nbytes)
    # version 2 superblock: 8-byte offsets and lengths, no extension
    sb = (b"\x89HDF\r\n\x1a\n" + struct.pack("<BBBB", 2, 8, 8, 0)
          + struct.pack("<QQQQ", 0, UNDEF, eof, _SUPERBLOCK_SIZE))
    sb += struct.pack("<I", lookup3(sb))
    with open(path, "wb") as f:
        f.write(sb)
        f.write(root)
        f.write(dset)
        f.write(arr.tobytes())

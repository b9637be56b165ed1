"""Minimal binary PLY mesh I/O (a copy of ``neuraludf_tpu/mesh/ply.py``: the
bytes written are the same)."""

from __future__ import annotations

import numpy as np


def export_ply(path: str, verts: np.ndarray, faces: np.ndarray) -> str:
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int32)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\nend_header\n"
    )
    face_rec = np.empty(
        len(faces), dtype=[("n", "u1"), ("idx", "<i4", (3,))]
    )
    face_rec["n"] = 3
    face_rec["idx"] = faces
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(verts.astype("<f4").tobytes())
        f.write(face_rec.tobytes())
    return path


def load_ply(path: str):
    """Load ascii or binary-LE PLY with xyz vertices + triangular faces."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:head_end].decode("ascii", errors="replace")
    n_verts = n_faces = 0
    fmt = "ascii"
    vert_props = []
    cur_elem = None
    for line in header.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur_elem = parts[1]
            if parts[1] == "vertex":
                n_verts = int(parts[2])
            elif parts[1] == "face":
                n_faces = int(parts[2])
        elif parts[0] == "property" and cur_elem == "vertex" and parts[1] != "list":
            vert_props.append((parts[2], parts[1]))
    if fmt == "ascii":
        body = data[head_end:].decode("ascii").split()
        k = len(vert_props)
        verts = np.array(body[: n_verts * k], np.float32).reshape(n_verts, k)[:, :3]
        rest = body[n_verts * k:]
        faces = []
        i = 0
        for _ in range(n_faces):
            cnt = int(rest[i])
            faces.append([int(x) for x in rest[i + 1 : i + 1 + cnt]][:3])
            i += 1 + cnt
        return verts, np.array(faces, np.int32)
    # binary little endian
    type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "uchar": "u1", "uint8": "u1", "int": "<i4", "int32": "<i4"}
    vdt = np.dtype([(n, type_map[t]) for n, t in vert_props])
    off = head_end
    vraw = np.frombuffer(data, vdt, n_verts, off)
    verts = np.stack([vraw["x"], vraw["y"], vraw["z"]], -1).astype(np.float32)
    off += vdt.itemsize * n_verts
    fdt = np.dtype([("n", "u1"), ("idx", "<i4", (3,))])
    fraw = np.frombuffer(data, fdt, n_faces, off)
    return verts, fraw["idx"].astype(np.int32)

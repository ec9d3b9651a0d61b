"""Minimal PLY mesh I/O (port of ``vf_nerf_tpu/utils/ply.py``; the reference
used trimesh and plyfile).

Reads and writes triangle meshes: ascii and binary_little_endian formats,
vertex x/y/z (extra properties skipped) and face vertex-index lists, so a
``.ply`` written by either package loads in the other unchanged. Enough for
loading GT scene meshes (centroid, bounds, 3D metrics) and writing the
marching-cubes and TSDF meshes. Binary faces whose rows all have one length
are read in one ``frombuffer`` (the JAX package parses every row in Python:
minutes for the millions of faces of a res-256 quadrant merge); other
elements row by row, with the same result.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


@dataclass
class PlyElement:
    name: str
    count: int
    properties: List[Tuple[str, str, Optional[str]]]  # (name, dtype, list_count_dtype)


def _parse_header(f) -> Tuple[List[PlyElement], str]:
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    elements: List[PlyElement] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens or tokens[0] == "comment":
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            elements.append(PlyElement(tokens[1], int(tokens[2]), []))
        elif tokens[0] == "property":
            if tokens[1] == "list":
                elements[-1].properties.append(
                    (tokens[4], _DTYPES[tokens[3]], _DTYPES[tokens[2]]))
            else:
                elements[-1].properties.append(
                    (tokens[2], _DTYPES[tokens[1]], None))
        elif tokens[0] == "end_header":
            break
    if fmt not in ("ascii", "binary_little_endian"):
        raise ValueError(f"unsupported PLY format: {fmt}")
    return elements, fmt


def load_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load vertices (V, 3) float32 and faces (F, 3) int32 (faces may be
    empty for point clouds)."""
    with open(path, "rb") as f:
        elements, fmt = _parse_header(f)
        vertices = np.zeros((0, 3), np.float32)
        faces: List[np.ndarray] = []
        for elem in elements:
            if fmt == "binary_little_endian":
                data = _read_binary_element(f, elem)
            else:
                data = _read_ascii_element(f, elem)
            if elem.name == "vertex":
                vertices = np.stack([data["x"], data["y"], data["z"]],
                                    axis=1).astype(np.float32)
            elif elem.name == "face":
                key = next(k for k in data if "ind" in k.lower()
                           or k.lower() == "vertex_indices")
                faces = data[key]
    face_arr = (np.asarray(faces, np.int32) if len(faces)
                else np.zeros((0, 3), np.int32))
    return vertices, face_arr


def _read_binary_element(f, elem: PlyElement) -> dict:
    has_list = any(p[2] is not None for p in elem.properties)
    out: dict = {}
    if not has_list:
        dtype = np.dtype([(name, "<" + dt) for name, dt, _ in elem.properties])
        raw = np.frombuffer(f.read(dtype.itemsize * elem.count), dtype=dtype)
        for name, _, _ in elem.properties:
            out[name] = np.ascontiguousarray(raw[name])
        return out
    fixed = _read_fixed_lists(f, elem)
    if fixed is not None:
        return fixed
    # List properties of varying lengths (mixed polygons): row by row.
    rows: List[List[int]] = []
    for _ in range(elem.count):
        row_vals: List = []
        for name, dt, count_dt in elem.properties:
            if count_dt is None:
                size = np.dtype(dt).itemsize
                row_vals.append(
                    np.frombuffer(f.read(size), dtype="<" + dt)[0])
            else:
                csize = np.dtype(count_dt).itemsize
                n = int(np.frombuffer(f.read(csize), dtype="<" + count_dt)[0])
                vsize = np.dtype(dt).itemsize
                vals = np.frombuffer(f.read(vsize * n), dtype="<" + dt)
                row_vals.append(vals)
        rows.append(row_vals)
    for i, (name, _, count_dt) in enumerate(elem.properties):
        vals = [r[i] for r in rows]
        if count_dt is not None:
            tris: List[np.ndarray] = []
            for v in vals:
                v = np.asarray(v, np.int64)
                # fan-triangulate polygons
                for k in range(1, len(v) - 1):
                    tris.append(np.array([v[0], v[k], v[k + 1]]))
            out[name] = np.asarray(tris, np.int32) if tris else \
                np.zeros((0, 3), np.int32)
        else:
            out[name] = np.asarray(vals)
    return out


def _read_fixed_lists(f, elem: PlyElement) -> Optional[dict]:
    """An element of one list property whose rows all have the first row's
    length (every triangle or quad mesh) in one read, fan-triangulated as
    the row-by-row parser does; None, with the file where it was, when the
    element is not of that form."""
    if elem.count == 0 or len(elem.properties) != 1 or \
            elem.properties[0][2] is None:
        return None
    name, dt, count_dt = elem.properties[0]
    start = f.tell()
    first = np.frombuffer(f.read(np.dtype(count_dt).itemsize),
                          dtype="<" + count_dt)
    f.seek(start)
    n = int(first[0]) if len(first) else 0
    if n < 3:
        return None
    row = np.dtype([("n", "<" + count_dt), ("v", "<" + dt, (n,))])
    buf = f.read(row.itemsize * elem.count)
    if len(buf) == row.itemsize * elem.count:
        raw = np.frombuffer(buf, dtype=row)
        if (raw["n"] == n).all():
            v = raw["v"].astype(np.int64)
            tris = np.stack([v[:, [0, k, k + 1]] for k in range(1, n - 1)],
                            axis=1).reshape(-1, 3)
            return {name: tris.astype(np.int32)}
    f.seek(start)
    return None


def _read_ascii_element(f, elem: PlyElement) -> dict:
    out: dict = {name: [] for name, _, _ in elem.properties}
    for _ in range(elem.count):
        tokens = f.readline().split()
        idx = 0
        for name, dt, count_dt in elem.properties:
            if count_dt is None:
                out[name].append(float(tokens[idx]))
                idx += 1
            else:
                n = int(tokens[idx])
                idx += 1
                vals = np.asarray([float(t) for t in tokens[idx:idx + n]])
                idx += n
                out[name].append(vals)
    result: dict = {}
    for name, dt, count_dt in elem.properties:
        if count_dt is not None:
            tris: List[np.ndarray] = []
            for v in out[name]:
                v = np.asarray(v, np.int64)
                for k in range(1, len(v) - 1):
                    tris.append(np.array([v[0], v[k], v[k + 1]]))
            result[name] = np.asarray(tris, np.int32) if tris else \
                np.zeros((0, 3), np.int32)
        else:
            result[name] = np.asarray(out[name], np.float32)
    return result


def save_ply(path: str, vertices: np.ndarray, faces: np.ndarray,
             binary: bool = True) -> None:
    """Write a triangle mesh (or point cloud if faces is empty)."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    header = ["ply",
              "format binary_little_endian 1.0" if binary else
              "format ascii 1.0",
              f"element vertex {len(vertices)}",
              "property float x", "property float y", "property float z"]
    if len(faces):
        header += [f"element face {len(faces)}",
                   "property list uchar int vertex_indices"]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            f.write(vertices.astype("<f4").tobytes())
            if len(faces):
                rec = np.empty(len(faces),
                               dtype=[("n", "u1"), ("v", "<i4", (3,))])
                rec["n"] = 3
                rec["v"] = faces
                f.write(rec.tobytes())
        else:
            for v in vertices:
                f.write(f"{v[0]} {v[1]} {v[2]}\n".encode("ascii"))
            for face in faces:
                f.write(f"3 {face[0]} {face[1]} {face[2]}\n".encode("ascii"))

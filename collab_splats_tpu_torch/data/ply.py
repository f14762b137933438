"""Minimal PLY point-cloud / mesh I/O (numpy only).

The port's own copy of the JAX package's ``data/ply.py`` (which imports no
JAX; the port imports nothing of that package).  Supports ascii and
binary_little_endian, vertices with optional colors/normals and optional
triangle faces: the subset the splat/mesh pipeline uses.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

_DTYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "int8": "i1", "uint8": "u1", "int16": "i2", "uint16": "u2",
    "int32": "i4", "uint32": "u4", "float32": "f4", "float64": "f8",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read a PLY file.

    Returns a dict with ``points`` [N,3] float32 and optionally ``colors``
    [N,3] float32 in [0,1], ``normals`` [N,3], ``faces`` [F,3] int32.
    """
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # list of (name, count, [(prop_name, dtype_str or list-spec)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unexpected EOF in header")
            tokens = line.strip().decode("ascii", "replace").split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                cur = (tokens[1], int(tokens[2]), [])
                elements.append(cur)
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    cur[2].append((tokens[4], ("list", _DTYPES[tokens[2]],
                                               _DTYPES[tokens[3]])))
                else:
                    cur[2].append((tokens[2], _DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"unsupported PLY format {fmt}")

        data = {}
        for name, count, props in elements:
            if all(not isinstance(d, tuple) for _, d in props):
                dtype = np.dtype([(p, "<" + d) for p, d in props])
                if fmt == "ascii":
                    rows = np.loadtxt(
                        (f.readline() for _ in range(count)), dtype=np.float64,
                        ndmin=2,
                    )
                    arr = np.zeros(count, dtype)
                    for i, (p, _) in enumerate(props):
                        arr[p] = rows[:, i]
                else:
                    arr = np.frombuffer(f.read(dtype.itemsize * count), dtype)
                data[name] = arr
            else:
                # list properties (faces): parse row by row.
                faces = []
                if fmt == "ascii":
                    for _ in range(count):
                        vals = f.readline().split()
                        k = int(vals[0])
                        faces.append([int(v) for v in vals[1 : 1 + k]])
                else:
                    (pname, (_, cnt_d, idx_d)) = props[0]
                    cnt_size = np.dtype(cnt_d).itemsize
                    idx_size = np.dtype(idx_d).itemsize
                    for _ in range(count):
                        k = int(np.frombuffer(f.read(cnt_size), "<" + cnt_d)[0])
                        faces.append(
                            np.frombuffer(f.read(idx_size * k), "<" + idx_d)
                        )
                data[name] = np.asarray(faces)

    out: Dict[str, np.ndarray] = {}
    if "vertex" in data:
        v = data["vertex"]
        out["points"] = np.stack(
            [v["x"], v["y"], v["z"]], axis=-1
        ).astype(np.float32)
        names = v.dtype.names
        if all(c in names for c in ("red", "green", "blue")):
            cols = np.stack([v["red"], v["green"], v["blue"]], -1)
            if cols.dtype != np.float32:
                cols = cols.astype(np.float32) / 255.0
            out["colors"] = cols.astype(np.float32)
        if all(c in names for c in ("nx", "ny", "nz")):
            out["normals"] = np.stack(
                [v["nx"], v["ny"], v["nz"]], -1
            ).astype(np.float32)
    if "face" in data and len(data["face"]):
        out["faces"] = np.asarray(data["face"], np.int32)
    return out


def write_ply(
    path: str,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
    faces: Optional[np.ndarray] = None,
) -> None:
    """Write a binary_little_endian PLY (colors in [0,1] stored as uchar)."""
    n = len(points)
    props = [("x", "f4"), ("y", "f4"), ("z", "f4")]
    if normals is not None:
        props += [("nx", "f4"), ("ny", "f4"), ("nz", "f4")]
    if colors is not None:
        props += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    dtype = np.dtype([(p, "<" + d) for p, d in props])
    arr = np.zeros(n, dtype)
    arr["x"], arr["y"], arr["z"] = points[:, 0], points[:, 1], points[:, 2]
    if normals is not None:
        arr["nx"], arr["ny"], arr["nz"] = (
            normals[:, 0], normals[:, 1], normals[:, 2]
        )
    if colors is not None:
        c8 = np.clip(np.asarray(colors) * 255.0, 0, 255).astype(np.uint8)
        arr["red"], arr["green"], arr["blue"] = c8[:, 0], c8[:, 1], c8[:, 2]

    type_names = {"f4": "float", "u1": "uchar"}
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for p, d in props:
            f.write(f"property {type_names[d]} {p}\n".encode())
        if faces is not None:
            f.write(f"element face {len(faces)}\n".encode())
            f.write(b"property list uchar int vertex_indices\n")
        f.write(b"end_header\n")
        f.write(arr.tobytes())
        if faces is not None:
            # Each face is a uchar count and its int32 indices, packed: one
            # record array, the bytes of a per-face struct.pack loop.
            fa = np.asarray(faces, np.int32)
            rec = np.empty(len(fa), np.dtype(
                [("n", "u1"), ("v", "<i4", (fa.shape[1],))]))
            rec["n"] = fa.shape[1]
            rec["v"] = fa
            f.write(rec.tobytes())

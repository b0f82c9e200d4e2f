"""Minimal PLY point-cloud IO (self-contained; no open3d needed).

The port's own copy of holoagent_tpu/utils/ply.py: both write the same
bytes, so a graph saved by either package loads in the other.

Writes binary_little_endian with double xyz + uchar rgb — the layout open3d's
`write_point_cloud` emits — so graph artifacts stay drop-in compatible with
the reference's ply+json persistence (SURVEY.md §5.4). Reads ascii and binary,
float or double."""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np


def write_ply(path: str | Path, points: np.ndarray, colors: Optional[np.ndarray] = None):
    """points (N,3) float; colors (N,3) float in [0,1] or uint8."""
    points = np.asarray(points, np.float64)
    n = len(points)
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property double {a}" for a in "xyz"]
    if has_color:
        header += [f"property uchar {c}" for c in ("red", "green", "blue")]
    header += ["end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if has_color:
            dt = np.dtype([("xyz", "<f8", 3), ("rgb", "u1", 3)])
            rec = np.empty(n, dt)
            rec["xyz"] = points
            rec["rgb"] = colors
        else:
            dt = np.dtype([("xyz", "<f8", 3)])
            rec = np.empty(n, dt)
            rec["xyz"] = points
        f.write(rec.tobytes())


def read_ply(path: str | Path) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Returns (points (N,3) float64, colors (N,3) float32 in [0,1] or None)."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.find(b"end_header\n")
    if head_end < 0:
        raise ValueError(f"{path}: not a ply file")
    header = data[:head_end].decode("ascii", errors="replace").splitlines()
    body = data[head_end + len(b"end_header\n") :]
    fmt = "ascii"
    n = 0
    props = []  # (name, dtype)
    type_map = {
        "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
        "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
        "short": "<i2", "ushort": "<u2", "int": "<i4", "uint": "<u4",
    }
    in_vertex = False
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                n = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            if parts[1] == "list":
                raise ValueError("list properties unsupported in vertex element")
            props.append((parts[2], type_map[parts[1]]))
    names = [p[0] for p in props]
    if fmt == "ascii":
        rows = np.loadtxt(
            np.char.decode(np.array(body.split(b"\n")[:n], dtype=bytes)), ndmin=2
        )
        vals = {nm: rows[:, i] for i, nm in enumerate(names)}
    else:
        swap = fmt == "binary_big_endian"
        dt = np.dtype([(nm, t.replace("<", ">") if swap else t) for nm, t in props])
        rec = np.frombuffer(body[: dt.itemsize * n], dtype=dt)
        vals = {nm: rec[nm] for nm in names}
    pts = np.stack([vals["x"], vals["y"], vals["z"]], axis=-1).astype(np.float64)
    if all(c in vals for c in ("red", "green", "blue")):
        cols = np.stack([vals["red"], vals["green"], vals["blue"]], axis=-1)
        cols = cols.astype(np.float32)
        if cols.max(initial=0) > 1.0:
            cols = cols / 255.0
        return pts, cols
    return pts, None

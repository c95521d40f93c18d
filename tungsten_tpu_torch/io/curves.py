"""Curve IO: .hair, .fiber and OBJ curve import, plus normal generation
(port of tungsten_tpu/io/curves.py, host numpy, copied as it is so both
packages read and write the same bytes and make the same normals).

Host-side counterpart of the reference's CurveIO
(ref: src/core/io/CurveIO.cpp:100-454):
  * `.hair` — Cem Yuksel HAIR binary (CurveIO.cpp:118-208)
  * `.fiber` — Benedikt Bitterli's attribute-block binary
    (CurveIO.cpp:279-404)
  * OBJ with `l`/`curv` statements (ObjLoader::loadCurvesOnly)
Curves are piecewise quadratic uniform B-splines over the node list;
each curve contributes (count - 2) segments.

Output is CurveData: curve_ends (C,) uint32 prefix ends into the node
array, nodes (N, 4) float32 [x, y, z, width], normals (N, 3) float32.
Normals are random at the root then propagated with minimum torsion
(CurveIO.cpp:22-99) — needed only by ribbon mode.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

FIBER_MAGIC = bytes([0x80, 0xBF, 0x80, 0x46, 0x49, 0x42, 0x45, 0x52])
_FIBER_SIZES = [1, 1, 2, 2, 4, 4, 8, 8, 4, 8]
FIBER_UINT16 = 3
FIBER_FLOAT = 8


@dataclass
class CurveData:
    curve_ends: np.ndarray   # (C,) uint32 — exclusive prefix ends
    nodes: np.ndarray        # (N, 4) float32 — xyz + width
    normals: np.ndarray      # (N, 3) float32
    colors: np.ndarray | None = None  # (N, 3) or (1, 3)


def _curve_starts(curve_ends: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], curve_ends[:-1]]).astype(np.int64)


def init_normals(curve_ends: np.ndarray, nodes: np.ndarray,
                 seed: int = 0xC0FFEE) -> np.ndarray:
    """Random root normal per curve + parallel-transport propagation.

    The reference advances the normal with a minimum-torsion frame
    (CurveIO.cpp:31-61); we use double-reflection parallel transport
    along the polyline tangents, which produces the same
    minimally-twisting frame family.  Vectorized across curves,
    sequential over the (short) per-curve node axis.
    """
    n_nodes = nodes.shape[0]
    normals = np.zeros((n_nodes, 3), np.float32)
    starts = _curve_starts(curve_ends)
    ends = curve_ends.astype(np.int64)
    counts = ends - starts
    max_count = int(counts.max()) if len(counts) else 0

    rng = np.random.default_rng(seed)
    p = nodes[:, :3]

    # root tangent + random orthogonal root normal, all curves at once
    t0 = p[np.minimum(starts + 1, ends - 1)] - p[starts]
    t0 /= np.maximum(np.linalg.norm(t0, axis=-1, keepdims=True), 1e-20)
    r = rng.standard_normal((len(starts), 3)).astype(np.float32)
    n0 = r - t0 * np.sum(r * t0, axis=-1, keepdims=True)
    n0 /= np.maximum(np.linalg.norm(n0, axis=-1, keepdims=True), 1e-20)
    normals[starts] = n0

    # parallel transport: rotate the frame by the rotation taking
    # tangent_i to tangent_{i+1}
    cur_n = n0
    cur_t = t0
    for k in range(1, max_count):
        act = k < counts
        i = np.minimum(starts + k, ends - 1)
        j = np.minimum(i + 1, ends - 1)
        t1 = np.where((i < ends - 1)[:, None], p[j] - p[i], cur_t)
        t1 = t1 / np.maximum(np.linalg.norm(t1, axis=-1, keepdims=True), 1e-20)
        # Rodrigues rotation about cur_t x t1
        axis = np.cross(cur_t, t1)
        s = np.linalg.norm(axis, axis=-1, keepdims=True)
        c = np.sum(cur_t * t1, axis=-1, keepdims=True)
        safe = s[:, 0] > 1e-8
        a = axis / np.maximum(s, 1e-20)
        n_rot = (cur_n * c + np.cross(a, cur_n) * s
                 + a * np.sum(a * cur_n, axis=-1, keepdims=True) * (1.0 - c))
        new_n = np.where(safe[:, None], n_rot, cur_n)
        new_n -= t1 * np.sum(new_n * t1, axis=-1, keepdims=True)
        new_n /= np.maximum(np.linalg.norm(new_n, axis=-1, keepdims=True),
                            1e-20)
        normals[i] = np.where(act[:, None], new_n, normals[i])
        cur_n = np.where(act[:, None], new_n, cur_n)
        cur_t = np.where(act[:, None], t1, cur_t)
    return normals


def load_hair(path: str) -> CurveData:
    """Cem Yuksel HAIR format (ref CurveIO.cpp:118-208)."""
    with open(path, "rb") as f:
        if f.read(4) != b"HAIR":
            raise ValueError(f"{path}: bad HAIR magic")
        curve_count, node_count, descriptor = struct.unpack("<III", f.read(12))
        has_segments = bool(descriptor & 0x01)
        has_points = bool(descriptor & 0x02)
        has_thickness = bool(descriptor & 0x04)
        has_transparency = bool(descriptor & 0x08)
        has_color = bool(descriptor & 0x10)
        if not has_points:
            raise ValueError(f"{path}: HAIR file without points")
        default_segments, = struct.unpack("<I", f.read(4))
        default_thickness, = struct.unpack("<f", f.read(4))
        f.read(4)  # default transparency
        default_color = np.frombuffer(f.read(12), np.float32).copy()
        f.read(88)  # file info

        if has_segments:
            seg = np.frombuffer(f.read(2 * curve_count), np.uint16)
            curve_ends = np.cumsum(seg.astype(np.uint32) + 1)
        else:
            curve_ends = (np.arange(1, curve_count + 1, dtype=np.uint32)
                          * (default_segments + 1))
        pts = np.frombuffer(f.read(12 * node_count),
                            np.float32).reshape(node_count, 3)
        nodes = np.empty((node_count, 4), np.float32)
        nodes[:, :3] = pts
        nodes[:, 3] = default_thickness
        if has_thickness:
            nodes[:, 3] = np.frombuffer(f.read(4 * node_count), np.float32)
        if has_transparency:
            f.seek(4 * node_count, 1)
        colors = None
        if has_color:
            colors = np.frombuffer(f.read(12 * node_count),
                                   np.float32).reshape(node_count, 3).copy()
        else:
            colors = default_color.reshape(1, 3)
    normals = init_normals(curve_ends, nodes)
    return CurveData(curve_ends.astype(np.uint32), nodes, normals, colors)


def save_hair(path: str, data: CurveData) -> None:
    """Write the HAIR format the reference emits (CurveIO.cpp:210-251)."""
    curve_ends = np.asarray(data.curve_ends, np.uint32)
    nodes = np.asarray(data.nodes, np.float32)
    has_color = data.colors is not None and \
        len(data.colors) == len(nodes)
    descriptor = 0x1 | 0x2 | 0x4 | (0x10 if has_color else 0)
    with open(path, "wb") as f:
        f.write(b"HAIR")
        f.write(struct.pack("<III", len(curve_ends), len(nodes), descriptor))
        f.write(struct.pack("<Iff", 0, 0.0, 0.0))
        f.write(np.ones(3, np.float32).tobytes())
        info = b"Hair file written by tungsten_tpu"
        f.write(info + b"\0" * (88 - len(info)))
        counts = np.diff(np.concatenate([[0], curve_ends]))
        f.write((counts - 1).astype(np.uint16).tobytes())
        f.write(nodes[:, :3].astype(np.float32).tobytes())
        f.write(nodes[:, 3].astype(np.float32).tobytes())
        if has_color:
            f.write(np.asarray(data.colors, np.float32).tobytes())


def load_fiber(path: str) -> CurveData:
    """Bitterli .fiber attribute-block format (ref CurveIO.cpp:343-404)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:8] != FIBER_MAGIC:
        raise ValueError(f"{path}: bad FIBER magic")
    major, _minor = struct.unpack_from("<HH", raw, 8)
    if major != 1:
        raise ValueError(f"{path}: unsupported fiber version {major}")
    content_type, = struct.unpack_from("<I", raw, 12)
    if content_type != 0:
        raise ValueError(f"{path}: unsupported fiber content {content_type}")
    header_len, n_verts, n_curves = struct.unpack_from("<QQQ", raw, 16)

    curve_ends = None
    pos = None
    width = None
    off = header_len
    while off < len(raw):
        desc_len, = struct.unpack_from("<Q", raw, off)
        if desc_len == 0:
            break
        p = off + 8
        data_len, flags = struct.unpack_from("<QH", raw, p)
        vtype, vper = struct.unpack_from("<BB", raw, p + 10)
        name_end = raw.index(b"\0", p + 12)
        name = raw[p + 12:name_end].decode()
        data_off = off + desc_len
        per_curve = bool(flags & 1)
        n_elem = data_len // (_FIBER_SIZES[vtype] * vper) if \
            vtype < len(_FIBER_SIZES) else 0

        def _load(dtype, count, required):
            arr = np.frombuffer(raw, dtype, count=int(min(n_elem, required)),
                                offset=int(data_off)).copy()
            if len(arr) < required:  # copy-extend like the reference
                pad = np.repeat(arr[-1:], required - len(arr), axis=0)
                arr = np.concatenate([arr, pad])
            return arr

        if per_curve and name == "num_vertices" and vtype == FIBER_UINT16 \
                and vper == 1 and n_elem > 0:
            counts = _load(np.uint16, n_elem, n_curves)
            curve_ends = np.cumsum(counts.astype(np.uint32))
        elif not per_curve and name == "position" and vtype == FIBER_FLOAT \
                and vper == 3 and n_elem > 0:
            pos = _load(np.dtype((np.float32, 3)), n_elem, n_verts)
        elif not per_curve and name == "width" and vtype == FIBER_FLOAT \
                and vper == 1 and n_elem > 0:
            width = _load(np.float32, n_elem, n_verts)
        off = data_off + data_len

    if pos is None or curve_ends is None:
        raise ValueError(f"{path}: fiber file missing position/num_vertices")
    nodes = np.zeros((int(n_verts), 4), np.float32)
    nodes[:, :3] = pos
    nodes[:, 3] = width if width is not None else 0.0
    normals = init_normals(curve_ends, nodes)
    return CurveData(curve_ends.astype(np.uint32), nodes, normals)


def save_fiber(path: str, data: CurveData) -> None:
    """Write a minimal .fiber (num_vertices + position + width blocks)."""
    curve_ends = np.asarray(data.curve_ends, np.uint32)
    nodes = np.asarray(data.nodes, np.float32)
    counts = np.diff(np.concatenate([[0], curve_ends])).astype(np.uint16)

    def attr(name: bytes, flags: int, vtype: int, vper: int,
             payload: bytes) -> bytes:
        desc = struct.pack("<QHBB", len(payload), flags, vtype, vper) \
            + name + b"\0"
        return struct.pack("<Q", 8 + len(desc)) + desc + payload

    with open(path, "wb") as f:
        f.write(FIBER_MAGIC)
        f.write(struct.pack("<HHI", 1, 0, 0))
        f.write(struct.pack("<QQQ", 40, len(nodes), len(curve_ends)))
        f.write(attr(b"num_vertices", 1, FIBER_UINT16, 1, counts.tobytes()))
        f.write(attr(b"position", 0, FIBER_FLOAT, 3,
                     nodes[:, :3].tobytes()))
        f.write(attr(b"width", 0, FIBER_FLOAT, 1, nodes[:, 3].tobytes()))
        f.write(struct.pack("<Q", 0))


def load_obj_curves(path: str) -> CurveData:
    """OBJ `l` (polyline) curve import (ref ObjLoader::loadCurvesOnly)."""
    verts = []
    curves = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "l":
                idx = [int(x.split("/")[0]) for x in parts[1:]]
                curves.append([i - 1 if i > 0 else len(verts) + i
                               for i in idx])
    if not curves:
        raise ValueError(f"{path}: no curves ('l' statements) found")
    verts = np.asarray(verts, np.float32)
    nodes_list = []
    ends = []
    total = 0
    for c in curves:
        seg = verts[c]
        n4 = np.zeros((len(seg), 4), np.float32)
        n4[:, :3] = seg
        n4[:, 3] = 0.01
        nodes_list.append(n4)
        total += len(seg)
        ends.append(total)
    nodes = np.concatenate(nodes_list)
    curve_ends = np.asarray(ends, np.uint32)
    normals = init_normals(curve_ends, nodes)
    return CurveData(curve_ends, nodes, normals)


def load_curves(path: str) -> CurveData:
    """Extension dispatch (ref CurveIO::load)."""
    low = path.lower()
    if low.endswith(".hair"):
        return load_hair(path)
    if low.endswith(".fiber"):
        return load_fiber(path)
    if low.endswith(".obj"):
        return load_obj_curves(path)
    raise ValueError(f"unsupported curve format: {path}")

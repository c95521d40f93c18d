"""Host-side mesh IO: Tungsten's binary `.wo3` format and Wavefront OBJ.

Format parity (ref: src/core/io/MeshIO.cpp:12-42): a `.wo3` file is
  uint64 numVerts
  numVerts * Vertex{ float3 pos; float3 normal; float2 uv; }   (32 B each)
  uint64 numTris
  numTris  * TriangleI{ uint32 v0, v1, v2; int32 material; }   (16 B each)
Little-endian throughout.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class Mesh:
    """Indexed triangle mesh in host memory (numpy)."""
    pos: np.ndarray       # (V, 3) float32
    normal: np.ndarray    # (V, 3) float32
    uv: np.ndarray        # (V, 2) float32
    indices: np.ndarray   # (T, 3) int32
    material: np.ndarray  # (T,) int32, -1 if unused

    @property
    def num_tris(self) -> int:
        return int(self.indices.shape[0])


def load_wo3(path) -> Mesh:
    with open(path, "rb") as f:
        data = f.read()
    (nv,) = struct.unpack_from("<Q", data, 0)
    off = 8
    verts = np.frombuffer(data, dtype="<f4", count=nv * 8, offset=off).reshape(nv, 8)
    off += nv * 32
    (nt,) = struct.unpack_from("<Q", data, off)
    off += 8
    tris = np.frombuffer(data, dtype="<i4", count=nt * 4, offset=off).reshape(nt, 4)
    return Mesh(
        pos=np.ascontiguousarray(verts[:, 0:3], dtype=np.float32),
        normal=np.ascontiguousarray(verts[:, 3:6], dtype=np.float32),
        uv=np.ascontiguousarray(verts[:, 6:8], dtype=np.float32),
        indices=np.ascontiguousarray(tris[:, 0:3], dtype=np.int32),
        material=np.ascontiguousarray(tris[:, 3], dtype=np.int32),
    )


def save_wo3(path, mesh: Mesh) -> None:
    nv = mesh.pos.shape[0]
    nt = mesh.indices.shape[0]
    verts = np.concatenate(
        [mesh.pos.astype("<f4"), mesh.normal.astype("<f4"), mesh.uv.astype("<f4")],
        axis=1,
    )
    tris = np.concatenate(
        [mesh.indices.astype("<i4"), mesh.material.reshape(-1, 1).astype("<i4")],
        axis=1,
    )
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", nv))
        f.write(verts.tobytes())
        f.write(struct.pack("<Q", nt))
        f.write(tris.tobytes())


def load_obj(path) -> Mesh:
    """Minimal OBJ triangle loader (positions/normals/uvs, fan-triangulated
    faces, negative indices).  Geometry-only, mirroring what the reference's
    ObjLoader::loadGeometryOnly provides for mesh primitives."""
    vs, vts, vns = [], [], []
    # Each emitted vertex is the (v, vt, vn) triple of a face corner.
    corner_index: dict = {}
    out_pos, out_uv, out_nrm, faces = [], [], [], []

    def corner(tok: str) -> int:
        if tok in corner_index:
            return corner_index[tok]
        parts = tok.split("/")
        vi = int(parts[0])
        vi = vi - 1 if vi > 0 else len(vs) + vi
        ti = ni = None
        if len(parts) > 1 and parts[1]:
            ti = int(parts[1])
            ti = ti - 1 if ti > 0 else len(vts) + ti
        if len(parts) > 2 and parts[2]:
            ni = int(parts[2])
            ni = ni - 1 if ni > 0 else len(vns) + ni
        idx = len(out_pos)
        out_pos.append(vs[vi])
        out_uv.append(vts[ti] if ti is not None else (0.0, 0.0))
        out_nrm.append(vns[ni] if ni is not None else (0.0, 0.0, 0.0))
        corner_index[tok] = idx
        return idx

    with open(path, "r", errors="replace") as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                vs.append(tuple(float(x) for x in t[1:4]))
            elif t[0] == "vt":
                vts.append(tuple(float(x) for x in t[1:3]))
            elif t[0] == "vn":
                vns.append(tuple(float(x) for x in t[1:4]))
            elif t[0] == "f":
                ids = [corner(tok) for tok in t[1:]]
                for k in range(1, len(ids) - 1):
                    faces.append((ids[0], ids[k], ids[k + 1]))

    pos = np.asarray(out_pos, dtype=np.float32).reshape(-1, 3)
    nrm = np.asarray(out_nrm, dtype=np.float32).reshape(-1, 3)
    uv = np.asarray(out_uv, dtype=np.float32).reshape(-1, 2)
    idx = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
    if not len(vns):
        nrm = np.zeros_like(pos)
    return Mesh(pos=pos, normal=nrm, uv=uv, indices=idx,
                material=np.full((idx.shape[0],), -1, dtype=np.int32))


def load_mesh(path) -> Mesh:
    p = str(path)
    if p.lower().endswith(".wo3"):
        return load_wo3(p)
    if p.lower().endswith(".obj"):
        return load_obj(p)
    raise ValueError(f"unsupported mesh format: {p}")


def save_obj(path, mesh: Mesh) -> None:
    """Write a Wavefront OBJ (v/vn/vt + unified-index faces) — the
    wo3 -> obj export path (ref MeshIO::save + json2xml)."""
    with open(path, "w") as f:
        f.write("# exported by tungsten_tpu\n")
        for p in mesh.pos:
            f.write(f"v {p[0]:g} {p[1]:g} {p[2]:g}\n")
        for n in mesh.normal:
            f.write(f"vn {n[0]:g} {n[1]:g} {n[2]:g}\n")
        for t in mesh.uv:
            f.write(f"vt {t[0]:g} {t[1]:g}\n")
        for tri in mesh.indices:
            a, b, c = (int(i) + 1 for i in tri)
            f.write(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}\n")


def compute_smooth_normals(mesh: Mesh) -> np.ndarray:
    """Area-weighted vertex normals (used when `recompute_normals` is set or
    a mesh has no normals)."""
    v0 = mesh.pos[mesh.indices[:, 0]]
    v1 = mesh.pos[mesh.indices[:, 1]]
    v2 = mesh.pos[mesh.indices[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)
    out = np.zeros_like(mesh.pos)
    for k in range(3):
        np.add.at(out, mesh.indices[:, k], fn)
    n = np.linalg.norm(out, axis=1, keepdims=True)
    return (out / np.maximum(n, 1e-20)).astype(np.float32)

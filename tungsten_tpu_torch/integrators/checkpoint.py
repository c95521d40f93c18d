"""Checkpoint / resume state (ref: Integrator::saveRenderResumeData /
resumeRender, src/core/integrators/Integrator.cpp:92-162).  The port's
own copy of tungsten_tpu/integrators/checkpoint.py, in the same file
format: a resume file written by either package loads in the other.

State = JSON header {current_spp, scene_hash, per-buffer shapes/dtypes}
+ the raw named buffers (color accumulator, AOV sums/sumsq/counts,
adaptive-sampling tile statistics).  The scene hash covers the scene
JSON minus the renderer block, exactly like the reference, so stale
state is rejected.  Because the RNG is counter-based (pixel, sample)-
keyed, resuming at sample index `current_spp` reproduces the un-resumed
render bit-exactly — no sampler state needs saving (the reference has
to serialize every tile sampler, PathTraceIntegrator.cpp:158-172; our
counters are the serialization).
"""
from __future__ import annotations

import hashlib
import json
import struct

import numpy as np

MAGIC = b"TTPU_RESUME1"
MAGIC2 = b"TTPU_RESUME2"


def scene_hash(scene_json: dict) -> str:
    d = {k: v for k, v in scene_json.items() if k != "renderer"}
    return hashlib.sha256(
        json.dumps(d, sort_keys=True).encode()).hexdigest()


def save_resume_state(path, shash, framebuffer, current_spp,
                      buffers: dict | None = None) -> None:
    """v2 format: the main framebuffer plus any number of named extra
    buffers (AOV accumulators, variance sums, adaptive tile stats) —
    the analog of Camera::serializeOutputBuffers + integrator state."""
    fb = np.ascontiguousarray(framebuffer, np.float32)
    buffers = buffers or {}
    entries = [("framebuffer", fb)]
    for k in sorted(buffers):
        entries.append((k, np.ascontiguousarray(buffers[k])))
    header = json.dumps({
        "scene_hash": shash,
        "current_spp": int(current_spp),
        "buffers": [{"name": k, "shape": list(a.shape),
                     "dtype": str(a.dtype)} for k, a in entries],
    }).encode()
    with open(path, "wb") as f:
        f.write(MAGIC2)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        for _, a in entries:
            f.write(a.tobytes())


def load_resume_state(path, shash):
    """Returns {framebuffer, current_spp, buffers} or None on mismatch.
    Reads both the v2 multi-buffer format and round-1's v1 format."""
    try:
        with open(path, "rb") as f:
            magic = f.read(len(MAGIC))
            if magic == MAGIC2:
                (hlen,) = struct.unpack("<I", f.read(4))
                header = json.loads(f.read(hlen).decode())
                if header["scene_hash"] != shash:
                    return None
                buffers = {}
                for spec in header["buffers"]:
                    a = np.frombuffer(
                        f.read(int(np.prod(spec["shape"])
                                   * np.dtype(spec["dtype"]).itemsize)),
                        dtype=spec["dtype"]).reshape(spec["shape"]).copy()
                    buffers[spec["name"]] = a
                fb = buffers.pop("framebuffer")
                return {"framebuffer": fb,
                        "current_spp": header["current_spp"],
                        "buffers": buffers}
            if magic != MAGIC:
                return None
            (hlen,) = struct.unpack("<I", f.read(4))
            header = json.loads(f.read(hlen).decode())
            if header["scene_hash"] != shash:
                return None
            fb = np.frombuffer(f.read(), dtype=np.float32).reshape(
                header["shape"]).copy()
        return {"framebuffer": fb, "current_spp": header["current_spp"],
                "buffers": {}}
    except (OSError, ValueError, KeyError):
        return None

"""obj2json: convert an OBJ file (with materials) into a Tungsten scene
JSON + .wo3 meshes (ref: src/obj2json/obj2json.cpp).

The port's own copy of tungsten_tpu/tools/obj2json.py, on the port's io/
and scene/.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def load_mtl(path):
    mats = {}
    cur = None
    if not os.path.exists(path):
        return mats
    with open(path, errors="replace") as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "newmtl":
                cur = {"name": t[1]}
                mats[t[1]] = cur
            elif cur is not None:
                if t[0] == "Kd":
                    cur["albedo"] = [float(x) for x in t[1:4]]
                elif t[0] == "Ke":
                    e = [float(x) for x in t[1:4]]
                    if max(e) > 0:
                        cur["emission"] = e
                elif t[0] == "map_Kd":
                    cur["albedo_map"] = t[-1]
                elif t[0] == "Ns":
                    cur["exponent"] = float(t[1])
    return mats


def convert(obj_path, out_json=None):
    from tungsten_tpu_torch.io.mesh import load_obj, save_wo3, Mesh

    out_json = out_json or os.path.splitext(obj_path)[0] + ".json"
    out_dir = os.path.dirname(os.path.abspath(out_json)) or "."
    base = os.path.splitext(os.path.basename(obj_path))[0]

    mesh = load_obj(obj_path)
    wo3_name = base + ".wo3"
    save_wo3(os.path.join(out_dir, wo3_name), mesh)

    # materials from sibling .mtl (single-group conversion keeps it simple)
    mtl_path = os.path.splitext(obj_path)[0] + ".mtl"
    mats = load_mtl(mtl_path)
    bsdfs = [{"name": name, "type": "lambert",
              "albedo": m.get("albedo", [0.8, 0.8, 0.8])}
             for name, m in mats.items()] or [
        {"name": "default", "type": "lambert", "albedo": 0.8}]

    scene = {
        "media": [],
        "bsdfs": bsdfs,
        "primitives": [{
            "name": base, "type": "mesh", "file": wo3_name,
            "smooth": True, "bsdf": bsdfs[0]["name"],
        }],
        "camera": {
            "type": "pinhole", "fov": 60,
            "resolution": [1000, 563],
            "transform": {
                "position": [0, 1, 5], "look_at": [0, 0, 0], "up": [0, 1, 0],
            },
            "tonemap": "filmic",
        },
        "integrator": {"type": "path_tracer", "max_bounces": 64,
                       "min_bounces": 0, "enable_light_sampling": True},
        "renderer": {"spp": 64, "spp_step": 16,
                     "output_file": base + ".png"},
    }
    with open(out_json, "w") as f:
        json.dump(scene, f, indent=4)
    return out_json


def main(argv=None):
    p = argparse.ArgumentParser(prog="obj2json")
    p.add_argument("obj")
    p.add_argument("output", nargs="?")
    args = p.parse_args(argv)
    out = convert(args.obj, args.output)
    print(f"Wrote {out}")


if __name__ == "__main__":
    main()

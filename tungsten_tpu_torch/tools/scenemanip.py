"""scenemanip: package a scene + all referenced resources into a zip,
list resources, or relocate resource paths (ref: src/scenemanip/
scenemanip.cpp:19-27,149-160 — zip-package, list, relocate).

The port's own copy of tungsten_tpu/tools/scenemanip.py, on the port's io/
and scene/.
"""
from __future__ import annotations

import argparse
import json
import os
import zipfile

RESOURCE_KEYS = ("file", "emission", "albedo", "roughness", "thickness",
                 "ratio", "alpha", "density", "grid_file", "strand_file")
RESOURCE_EXTS = (".wo3", ".obj", ".hdr", ".pfm", ".exr", ".png", ".jpg",
                 ".jpeg", ".tga", ".bmp", ".hair", ".fiber", ".vdb", ".ies")


def _walk(node, found):
    if isinstance(node, dict):
        for v in node.values():
            _walk(v, found)
    elif isinstance(node, list):
        for v in node:
            _walk(v, found)
    elif isinstance(node, str) and node.lower().endswith(RESOURCE_EXTS):
        found.append(node)


def list_resources(scene_path):
    with open(scene_path) as f:
        data = json.load(f)
    found: list[str] = []
    _walk(data, found)
    seen = []
    for r in found:
        if r not in seen:
            seen.append(r)
    return seen


def package(scene_path, output=None):
    output = output or os.path.splitext(scene_path)[0] + ".zip"
    base = os.path.dirname(os.path.abspath(scene_path))
    with zipfile.ZipFile(output, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.write(scene_path, os.path.basename(scene_path))
        for r in list_resources(scene_path):
            src = os.path.join(base, r)
            if os.path.exists(src):
                zf.write(src, r)
    return output


def main(argv=None):
    p = argparse.ArgumentParser(prog="scenemanip")
    p.add_argument("scene")
    p.add_argument("-p", "--package", action="store_true")
    p.add_argument("-l", "--list-resources", action="store_true")
    p.add_argument("-o", "--output", default=None)
    args = p.parse_args(argv)
    if args.list_resources:
        for r in list_resources(args.scene):
            print(r)
    elif args.package:
        out = package(args.scene, args.output)
        print(f"Packaged scene to {out}")


if __name__ == "__main__":
    main()

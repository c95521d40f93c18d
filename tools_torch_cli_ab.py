#!/usr/bin/env python3
"""Wall time of the PyTorch port's renders on chip_smoke.py's scenes, to
compare two checkouts of the repo on one card.

    python3 tools_torch_cli_ab.py CHECKOUT [--reps 3] [--zoo]

Imports tungsten_tpu_torch and chip_smoke from CHECKOUT, writes the smoke
scene (256x256, 95,236 triangles) once, and renders it through
cli.render_scene on the card: with the five output buffers at 16 spp and
with adaptive sampling at 64 spp (spp_step 16), one warm-up and then
--reps timed renders of each.  With --zoo it also writes chip_smoke.py's
large scene (606,724 triangles, every ported BSDF, the paged walk) and
times render() on it as chip_smoke.py's phase 7c calls it (256x256, 16
spp, max_bounces 64), one warm-up and --reps timed renders.  Prints one
JSON line: the checkout, the card's name and power limit, and each timed
render's wall seconds and rays.  Run it on the two checkouts in turn
(A B B A ...) within one call: the host's speed varies between calls.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--zoo", action="store_true",
                    help="also time render() on the large zoo scene")
    args = ap.parse_args()
    root = os.path.abspath(args.checkout)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from tungsten_tpu_torch import cli
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    out = {"checkout": root, "card": card, "buffers": [], "adaptive": []}
    with tempfile.TemporaryDirectory(prefix="cli_ab_") as tmp:
        path = cs.write_scene(tmp)
        runs = {"buffers": cs.scene_variant(
                    path, "buffers.json", spp=cs.SPP,
                    output_file="buffers.png", hdr_output_file="buffers.pfm",
                    output_buffers=cs.BUFFER_SPECS),
                "adaptive": cs.scene_variant(
                    path, "adaptive.json", spp=64, spp_step=16,
                    output_file="adaptive.png",
                    hdr_output_file="adaptive.pfm")}
        for name, scene in runs.items():
            cli_args = cli.build_parser().parse_args(
                [scene, "-d", os.path.join(tmp, name)])
            for rep in range(args.reps + 1):
                res = cli.render_scene(scene, cli_args)
                if rep:
                    out[name].append({"s": res["seconds"],
                                      "rays": res["rays"]})
        if args.zoo:
            from tungsten_tpu_torch.render import render
            from tungsten_tpu_torch.scene.flatten import flatten_scene
            from tungsten_tpu_torch.scene.parse import load_scene
            scene, settings = flatten_scene(load_scene(
                cs.write_zoo_scene(tmp)))
            out["zoo"] = []
            for rep in range(args.reps + 1):
                _, stats = render(scene, settings, spp=cs.SPP, seed=cs.SEED,
                                  spp_chunk=cs.SPP, return_stats=True)
                if rep:
                    out["zoo"].append({"s": stats["time"],
                                       "rays": stats["rays"]})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

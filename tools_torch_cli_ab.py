#!/usr/bin/env python3
"""Wall time of the PyTorch port's CLI renders on chip_smoke.py's smoke
scene, to compare two checkouts of the repo on one card.

    python3 tools_torch_cli_ab.py CHECKOUT [--reps 3]

Imports tungsten_tpu_torch and chip_smoke from CHECKOUT, writes the smoke
scene (256x256, 95,236 triangles) once, and renders it through
cli.render_scene on the card: with the five output buffers at 16 spp and
with adaptive sampling at 64 spp (spp_step 16), one warm-up and then
--reps timed renders of each.  Prints one JSON line: the checkout, the
card's name and power limit, and each timed render's wall seconds and
rays.  Run it on the two checkouts in turn (A B B A ...) within one call:
the host's speed varies between calls.
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
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Device time of the curve-piece walk C1 on chip_smoke.py's hair scene,
to compare two checkouts of the repo on one card.

    python3 tools_torch_c1_ab.py CHECKOUT [--lanes]

Imports tungsten_tpu_torch and chip_smoke from CHECKOUT, writes the hair
scene (chip_smoke.py phase 10: 19,456 strands, 3,424,256 curve pieces)
and flattens it on the card, records the three traversals that phase
10(b) checks (the camera rays, body 1's shadow segments in any hit and
body 2's continuation rays, from two full-width bounce bodies), and
launches the checkout's C1 on each through ops/curve_trace.py::
curve_kernel with its own packed node rows: once with statistics (node
visits and piece tests a live ray, the distinct rows read and the bound
by the checkout's own chip_smoke.curve_bound_ms, from the child boxes
tested where its kernel counts them, else from the node visits, one box
each), then timed with CUDA
events (chip_smoke.cuda_ms: median of 5 after a warm-up) at full width
and on the first 1,024 and 16,384 rays.  Then one warm-up render (256x256,
16 spp, max_bounces 64) and one under torch.profiler
(chip_smoke.profile_render): C1's device ms over the render, by launch
width.  With --lanes (a checkout whose curve_kernel takes `lanes`) each
set is also timed with 1, 2 and 4 lanes a ray forced, at full width
and on its first 262,144, 131,072, 65,536, 16,384 and 1,024 rays.  Prints one JSON line
with the checkout, the card's name and power limit, and these numbers.  Run it on the two checkouts in turn
(A B B A) within one call.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout")
    ap.add_argument("--lanes", action="store_true",
                    help="also time each forced lanes a ray by width")
    args = ap.parse_args()
    root = os.path.abspath(args.checkout)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from tungsten_tpu_torch.integrators import path_tracer as tpt
    from tungsten_tpu_torch.ops import curve_trace as tct
    from tungsten_tpu_torch.render import render
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.parse import load_scene
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    out = {"checkout": root, "card": card, "sets": {}}
    with tempfile.TemporaryDirectory(prefix="c1_ab_") as tmp:
        scene, settings = flatten_scene(load_scene(cs.write_hair_scene(tmp)))
        rows = getattr(scene, "cwbvh_rows", None)
        if rows is None:
            rows = scene.cbvh_rows
        dev = scene.device
        n = settings.width * settings.height
        pix = torch.arange(n, dtype=torch.int32, device=dev).repeat(cs.SPP)
        smp = torch.arange(cs.SPP, dtype=torch.int32,
                           device=dev).repeat_interleave(n)
        calls = []
        orig = tpt.bvh_intersect

        def record(sc, o, d, t_min, t_max, any_hit=False, presorted=False):
            calls.append((o, d, t_min, t_max, any_hit))
            return orig(sc, o, d, t_min, t_max, any_hit=any_hit,
                        presorted=presorted)
        tpt.bvh_intersect = record
        try:
            body = tpt._make_bounce_body(scene, settings, cs.SEED)
            body(body(tpt.init_wave(scene, settings, pix, smp, cs.SEED)))
        finally:
            tpt.bvh_intersect = orig
        for name, c in (("camera", calls[0]), ("shadow", calls[1]),
                        ("continuation", calls[3])):
            o, d, t_min, t_max, any_hit = c
            tmin, far = cs.curve_inputs(scene, o, d, t_min, t_max, any_hit)
            live = far > tmin
            res = tct.curve_kernel(scene.crv_rows, rows, o, d, tmin, far,
                                   any_hit, stats=True)
            counts, nmark, pmark = res[5:8]
            visits, tests = int(counts[0].sum()), int(counts[1].sum())
            boxes = int(counts[3].sum()) if counts.shape[0] > 3 else visits
            R = o.shape[0]
            bound, by = cs.curve_bound_ms(scene, R, boxes, tests,
                                          int(nmark.sum()), int(pmark.sum()))

            def run(k, o=o, d=d, tmin=tmin, far=far, any_hit=any_hit,
                    **kw):
                return tct.curve_kernel(scene.crv_rows, rows, o[:k], d[:k],
                                        tmin[:k], far[:k], any_hit, **kw)
            nl = max(int(live.sum()), 1)
            out["sets"][name] = {
                "rays": R, "live": int(live.sum()),
                "hits": int(res[4].sum()),
                "ms": cs.cuda_ms(lambda: run(R)),
                "ms_1024": cs.cuda_ms(lambda: run(1024)),
                "ms_16384": cs.cuda_ms(lambda: run(16384)),
                "visits_per_live": visits / nl, "tests_per_live": tests / nl,
                "boxes_per_live": boxes / nl,
                "bound_ms": bound, "bound_by": by}
            if args.lanes:
                out["sets"][name]["lanes_ms"] = {
                    str(g): {str(k): cs.cuda_ms(lambda k=k, g=g: run(k,
                                                                  lanes=g))
                             for k in (R, 262144, 131072, 65536, 16384,
                                       1024)}
                    for g in tct.LANES}
        del calls
        render(scene, settings, spp=cs.SPP, seed=cs.SEED, spp_chunk=cs.SPP)
        summary: dict = {}
        t0 = time.time()
        prof = cs.profile_render(
            lambda: render(scene, settings, spp=cs.SPP, seed=cs.SEED,
                           spp_chunk=cs.SPP), summary=summary)
        out["render"] = {
            "wall_s": time.time() - t0,
            "launches": summary.get("launches"),
            "c1_ms": sum(prof[r]["ms"] for r in ("curve_closest",
                                                 "curve_anyhit")
                         if prof.get(r)) if prof else None,
            "c1_launches": sum(prof[r]["launches"] for r in (
                "curve_closest", "curve_anyhit") if prof.get(r))
            if prof else None,
            "c1_by_width": {r: prof[r]["by_width"] for r in (
                "curve_closest", "curve_anyhit") if prof.get(r)}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

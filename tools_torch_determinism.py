#!/usr/bin/env python3
"""Inventory of the operations without a deterministic implementation
that the PyTorch port's render paths run on the card.

    python3 tools_torch_determinism.py [CHECKOUT]

Imports tungsten_tpu_torch and chip_smoke from CHECKOUT (default: the
directory of this script), writes chip_smoke.py's smoke, media and
photon scenes, and runs every render path once at 64x64 on the card
under torch.use_deterministic_algorithms(True, warn_only=True): the path
tracer, adaptive sampling, the output buffers, the NFOR denoiser on
them, BDPT, the light tracer, the photon map, PPM, the fog's points,
beams and planes maps, kelemen_mlt on both tapes, multiplexed_mlt,
reversible_jump_mlt, the media scene (a voxel medium, raymarched) and
the path replay's forward and backward.  PyTorch warns once a call site
for each operation it has no deterministic version of; the tool records
every such warning with the path and the source line that raised it,
and prints one JSON line: the checkout, the card, and for each path the
distinct (operation, file:line) pairs.

The mode also swaps deterministic versions into index_add_, scatter_add_
and the other scatter-adds without a word, so this inventory cannot see
those: grep for them (tests/test_torch_segment_sum.py's static guard
does).  It is an inventory, not a render: the package itself never sets
the mode, and the images here are not checked.  Run it on two checkouts
in one call to see what a change removed.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import warnings
from dataclasses import replace

RES, SPP = 64, 4


def main() -> int:
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("tools_torch_determinism: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from tungsten_tpu_torch.integrators import path_tracer as tpt
    from tungsten_tpu_torch.render import (render, render_denoise_buffers,
                                          render_with_aovs)
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.parse import load_scene
    from tungsten_tpu_torch.tools.denoiser import nfor_denoise
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    found: dict = {}

    def run(name, fn):
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            fn()
            torch.cuda.synchronize()
        sites = sorted({(str(w.message).split(" does not have")[0][:120],
                         f"{os.path.relpath(w.filename, root)}:{w.lineno}")
                        for w in got
                        if "deterministic" in str(w.message)})
        found[name] = [list(s) for s in sites]
        print(f"{name}: {len(sites)} sites", file=sys.stderr, flush=True)

    torch.use_deterministic_algorithms(True, warn_only=True)
    with tempfile.TemporaryDirectory(prefix="determinism_") as tmp:
        path = cs.write_scene(tmp)
        scene, settings = flatten_scene(load_scene(path))
        small = replace(settings, width=RES, height=RES)

        def image(st, spp=SPP):
            return lambda: render(scene, st, spp=spp, seed=cs.SEED,
                                  spp_chunk=spp)

        run("path_tracer", image(small))
        run("adaptive", image(replace(small, adaptive_sampling=True), 32))
        run("output buffers", lambda: render_with_aovs(
            scene, small, spp=SPP, seed=cs.SEED))

        def denoise():
            d = render_denoise_buffers(scene, small, spp=SPP, seed=cs.SEED)
            nfor_denoise(d["color_a"], d["color_b"], d["color_var"],
                         d["feat_a"], d["feat_b"], d["feat_var"],
                         device="cuda")
        run("denoiser", denoise)
        for integ in cs.SPLATTING:
            run(integ, image(replace(cs.splat_settings(small, integ),
                                     max_bounces=4)))
        for tag, integ, bidir, _ in cs.MLT_RUNS:
            run(tag, image(cs.mlt_settings(small, integ, bidir,
                                           mlt_chains=2048,
                                           mlt_sample_pool=4096)))
        pix, smp = cs.wave_ids(small, SPP, scene.device)

        def replay():
            leaves = {k: getattr(scene, k).detach().clone()
                      .requires_grad_() for k in cs.REPLAY_PARAMS}
            L = tpt.trace_wave_replay(scene.replace(**leaves),
                                      replace(small, max_bounces=8), pix,
                                      smp, cs.SEED)
            L.mean().backward()
        run("replay", replay)
        del scene
        spath, fpath = cs.write_photon_scenes(os.path.join(tmp, "photon"))
        pscene, pset = flatten_scene(load_scene(spath))
        few = dict(width=RES, height=RES, max_bounces=8,
                   photon_count=1 << 16)
        for integ in ("photon_map", "progressive_photon_map"):
            run(integ, lambda: render(pscene, replace(
                pset, integrator_type=integ, **few), spp=SPP, seed=cs.SEED,
                spp_chunk=SPP))
        del pscene
        fscene, fset = flatten_scene(load_scene(fpath))
        for kind in cs.VOLUME_KINDS:
            run(f"fog {kind}", lambda: render(fscene, replace(
                fset, vol_photon_type=kind, vol_photon_count=2000, **few),
                spp=SPP, seed=cs.SEED, spp_chunk=SPP))
        del fscene
        mpath, _ = cs.write_media_scene(tmp)
        mscene, mset = flatten_scene(load_scene(mpath))
        run("media", lambda: render(mscene, replace(
            mset, width=RES, height=RES, max_bounces=4), spp=SPP,
            seed=cs.SEED, spp_chunk=SPP))
    print(json.dumps({"checkout": root, "card": card, "sites": found}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

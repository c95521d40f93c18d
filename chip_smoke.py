#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tungsten_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. card: the GPU's name and power limit, as nvidia-smi prints them;
  2. build: the CUDA wave kernels (csrc/wave_trace.cu, nvcc: the
     closest-hit, resident any-hit and paged any-hit kernels), the
     tensor-core leaf kernel (csrc/leaf_mma.cu, nvcc) and the host BVH
     library (g++), the three compiles started together;
  2b. leaf kernels (K4, K5): each of the five kernel rows (mma_loop,
     mma_loop_stores, leaf_variant_a/b/c) against its plain version,
     exactly on the TPU tool's all-ones inputs and within the stated
     tolerance on seeded random bf16 inputs over the whole last product
     (K4's scratch started random too, since its zeros would hide the
     product), and its launch held to one block bitwise equal to the full
     grid; then the tool's main path (tools/mxubench.py run_all: every K4
     shape, the store chain, the three variants, each on one block a
     64x64 tile) from zero launch counts, timed with CUDA events (median
     of 5 after a warm-up), and the check that nothing is dropped or
     hoisted (time per product growing with M*N on the one-block launch,
     with K on the tool's grid);
  3. scene: a deterministic lambert + mirror scene written with the
     port's IO (24 UV spheres of 64x32 segments, ~95k triangles, a
     lambert floor, one emissive quad, a procedural 512x256 sky), loaded
     with load_scene and flattened on the card;
  4. kernels: the closest-hit kernel (K1) and the resident any-hit
     kernel (K2) on the main path's shapes (the 1,048,576 camera rays of
     the 16-spp wave, one bounce's continuation rays, and NEE-style
     shadow segments) against the plain walk on the same inputs, with
     the gates of tests/test_torch_wave.py; each at splits=1 against
     list_walk (the kernels' schedule in plain PyTorch) on the first
     8,192 rays of each set (the triangle, or the occluded flag, equal
     on >= 0.9999 of live rays, the needed totals within 0.01 %),
     bitwise equal at the launcher's choice of CTAs a block and at 8,
     running at most 1.5x list_walk's needed count at full width (which
     the bound takes);
     timed with CUDA events (median of 5 after a warm-up), also on the
     first 1,024, 4,096, 8,192 and 65,536 rays and on a sparse tail wave
     (4,096 rays, the first 256 live), at splits=1 and at the launcher's
     choice;
  5. render: the main path, load_scene -> flatten_scene -> render at
     256x256, 16 spp, max_bounces 64, with the kernels' launch counts set
     to zero just before and read just after; then a second, warm render,
     and a third under torch.profiler (device busy share, top kernels,
     each traversal kernel's launches and device ms by rays a launch);
  6. cross-path: a 64x64 4-spp image from the kernel path against the
     port's plain path on the CPU;
  7. large scene: the same layout at production size (24 spheres of
     160x80 segments, 606,724 triangles, over 13 MiB of cluster tables,
     so it takes the paged walk) with the surface BSDF zoo (every ported
     type, glass spheres, a mixed and a coated BSDF with children, a
     null-BSDF light): (a) its size and walk; (b) the paged route's
     kernels on its camera, continuation and shadow rays as in phase 4
     (K3's closest hit and any hit, which are K1's and K2's kernels on
     the resident front); on the shadow segments also the paged any-hit
     walk, off the render path, against K2 on the same segments, against
     list_walk on the paged front, splits, by width, and the two any-hit
     routes' wrappers (the paged front and walk, the resident front and
     K2) timed in turns; (c)
     its full-width render (256x256, 16 spp, max_bounces 64) from zero
     launch counts, only the paged route launching, and one more under torch.profiler, as in phase 5; (d) a
     64x64 4-spp image of it against the plain path on the CPU;
  8. media: (a) the smoke scene's layout in a homogeneous fog that fills
     the view (bounded by a `forward` box; the camera sits in it through
     its medium_index), with a `forward` cube holding a voxel medium on a
     256^3 f32 density grid written with the port's write_vdb (ZIP) and
     read back through read_vdb, four thinsheet and four transparency
     spheres (opacity 0.5), the default renderer block (Sobol',
     raymarching); (b) the closest-hit kernel (K1) on the generalized
     shadow ray's first hop: segments from the camera hits toward the
     area light with t_min = EPSILON and the fudged far limit, held to
     phase 4's gates, and a full-width hop wave with one ray in 16 live
     timed against the all-live wave; (c) the full-width render (256x256,
     16 spp, max_bounces 64) from zero launch counts (K1 alone launches:
     the two-strategy NEE traces closest hits only), then one more under
     torch.profiler (launches per render, device busy share, K1's device
     ms by launch width); (d) a 64x64 4-spp image against the plain path
     on the CPU, with phase 6's gates;
  9. outdoor: (a) the smoke scene's layout under a skydome with an
     infinite_sphere_cap sun (2 degrees) along its up axis, a point
     light, an emissive analytic sphere, disk and capped cylinder, a
     non-emissive analytic disk floor (in place of the floor quad) and
     two cylinder pillars, a thinlens camera with an aperture bitmap
     written with the port's IO, cat eye 0.3, its focus on a sphere, the
     mitchell_netravali filter, the default renderer block; the cap sends
     it down the simple two-strategy NEE; (b) under phase 4's gates and
     by width: K1 on its camera rays with the far limits the analytic
     hits give them, K2 on the simple sub-branch's shadow segments of one
     full-width bounce body and K1 on that body's bsdf-strategy rays
     (dead lanes far limit 0; bvh_intersect's time beside the kernel's);
     (c) the full-width render (256x256, 16 spp, max_bounces 64) from
     zero launch counts, then one more under torch.profiler (launches
     per render, device busy share, K1's and K2's device ms by launch
     width); (d) images against the plain path on the CPU with phase 6's
     gates: the thinlens scene at 64x64, the same scene under an
     equirectangular camera at 32x32 and a cubemap camera
     (horizontal_cross) at 32x24, 4 spp each;
  10. the CLI (cli.render_scene) on the smoke scene at 256x256: (a) with
     the output buffers (color with sample variance and A/B halves,
     depth, normal, albedo, visibility) at 16 spp, its color held
     against phase 5's image of the same samples; (b) with adaptive
     sampling at 64 spp, spp_step 16 (render_adaptive); launch counts
     from zero for each, every written file loaded and checked;
  11. resume: the buffers render to 8 spp with enable_resume_render,
     then continued to 16, against 10a's uninterrupted 16-spp image;
  12. the HTTP server on a free port rendering the smoke scene at 64x64
     in two rounds: /status, /render (PNG) and /log;
  13. the kernels JSON line, then the result line.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0xBA5EBA11
RES, SPP, MAX_BOUNCES = 256, 16, 64
GRID_X, GRID_Z, SEG_U, SEG_V = 6, 4, 64, 32
ZOO_SEG = (160, 80)   # 25,280 triangles a sphere, 606,720 for the 24
ZOO_CROSS_BOUNCES = 16
SKY_W, SKY_H = 512, 256
MEDIA_GRID = 256      # the voxel medium's density grid, 256^3 f32
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s outside the
# tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
TIMED_RUNS = 5


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ scene

def uv_sphere(nu: int, nv: int):
    """Unit UV sphere: (pos, normal, uv, indices), outward winding."""
    import numpy as np
    th = np.pi * np.arange(nv + 1) / nv
    ph = 2.0 * np.pi * np.arange(nu + 1) / nu
    st, ct = np.sin(th)[:, None], np.cos(th)[:, None]
    pos = np.stack([st * np.cos(ph), np.broadcast_to(ct, (nv + 1, nu + 1)),
                    st * np.sin(ph)], -1).reshape(-1, 3).astype(np.float32)
    uv = np.stack(np.meshgrid(np.arange(nu + 1) / nu, np.arange(nv + 1) / nv),
                  -1).reshape(-1, 2).astype(np.float32)
    tris = []
    for i in range(nv):
        for j in range(nu):
            a = i * (nu + 1) + j
            b, c = a + 1, a + nu + 1
            if i > 0:
                tris.append((a, b, c))
            if i < nv - 1:
                tris.append((b, c + 1, c))
    return pos, pos.copy(), uv, np.asarray(tris, np.int32)


def write_scene(dirpath: str, res: int = RES, spp: int = SPP,
                grid=(GRID_X, GRID_Z), seg=(SEG_U, SEG_V),
                sky=(SKY_W, SKY_H)) -> str:
    """Write the smoke scene (meshes, sky, scene.json); returns its path."""
    import numpy as np
    from tungsten_tpu_torch.io import mesh
    pos, nrm, uv, idx = uv_sphere(*seg)
    m = mesh.Mesh(pos=pos, normal=nrm, uv=uv, indices=idx,
                  material=np.zeros(len(idx), np.int32))
    bsdfs = [{"name": "floor", "type": "lambert", "albedo": [0.55, 0.5, 0.45]},
             {"name": "mirror", "type": "mirror", "albedo": 0.9},
             {"name": "light", "type": "lambert", "albedo": 0.0}]
    prims = [{"type": "quad", "bsdf": "floor",
              "transform": {"position": [0, 0, 0], "scale": [20, 1, 20]}},
             {"type": "quad", "bsdf": "light", "emission": [12.0, 11.0, 10.0],
              "transform": {"position": [0.5, 4.0, 0.5], "scale": [2, 1, 2],
                            "rotation": [0, 0, 180]}}]
    gx, gz = grid
    for i in range(gx):
        for j in range(gz):
            name = f"sphere_{i}_{j}"
            mesh.save_wo3(os.path.join(dirpath, name + ".wo3"), m)
            if (i + j) % 2:
                bsdf = "mirror"
            else:
                bsdf = name
                bsdfs.append({"name": name, "type": "lambert", "albedo": [
                    0.25 + 0.6 * i / max(gx - 1, 1), 0.7,
                    0.25 + 0.6 * j / max(gz - 1, 1)]})
            prims.append({"type": "mesh", "file": name + ".wo3", "bsdf": bsdf,
                          "smooth": True,
                          "transform": {"position": [i - (gx - 1) / 2, 0.45,
                                                     j - (gz - 1) / 2],
                                        "scale": 0.45}})
    prims.append(write_sky(dirpath, sky))
    path = os.path.join(dirpath, "scene.json")
    with open(path, "w") as f:
        json.dump(scene_json(bsdfs, prims, res, spp), f, indent=1)
    return path


def write_sky(dirpath: str, sky) -> dict:
    """Write the procedural sky (horizon-to-zenith gradient plus a warm
    sun blob) as sky.pfm; returns its infinite_sphere primitive."""
    import numpy as np
    from tungsten_tpu_torch.io import image
    w, h = sky
    y = (np.arange(h)[:, None] + 0.5) / h
    x = (np.arange(w)[None, :] + 0.5) / w
    elev = np.clip(1.0 - 2.0 * y, 0.0, 1.0)
    base = np.stack([0.35 + 0.25 * elev, 0.45 + 0.3 * elev,
                     0.6 + 0.4 * elev], -1) * np.ones((h, w, 1))
    sun = np.exp(-(((x - 0.3) / 0.02) ** 2 + ((y - 0.25) / 0.03) ** 2))
    base = base + sun[..., None] * np.asarray([40.0, 36.0, 30.0])
    base[y[:, 0] > 0.5] *= 0.2     # darker below the horizon
    image.save_hdr(os.path.join(dirpath, "sky.pfm"), base.astype(np.float32))
    return {"type": "infinite_sphere", "emission": "sky.pfm",
            "transform": {"rotation": [0, 20, 0]}}


def scene_json(bsdfs, prims, res: int, spp: int) -> dict:
    """The scene file around `bsdfs` and `prims`: the pinhole camera and
    the path tracer both scenes share."""
    return {"bsdfs": bsdfs, "primitives": prims,
            "camera": {"type": "pinhole", "resolution": [res, res],
                       "fov": 50,
                       "transform": {"position": [0, 3.2, 5.5],
                                     "look_at": [0, 0.3, 0]}},
            "integrator": {"type": "path_tracer", "max_bounces": MAX_BOUNCES},
            "renderer": {"spp": spp}}


# the 24 spheres of the large scene: every surface BSDF the port shades
# (the light quad carries `null`; the floor is lambert), glass in
# several kinds, nested BSDFs with children of their own
ZOO_SPHERES = [
    {"type": "dielectric", "ior": 1.5},
    {"type": "rough_dielectric", "ior": 1.5, "roughness": 0.15},
    {"type": "conductor", "material": "Au"},
    {"type": "rough_conductor", "material": "Cu", "roughness": 0.25,
     "distribution": "beckmann"},
    {"type": "plastic", "albedo": [0.7, 0.15, 0.1], "ior": 1.5},
    {"type": "rough_plastic", "albedo": [0.1, 0.4, 0.7], "roughness": 0.2},
    {"type": "oren_nayar", "albedo": [0.8, 0.7, 0.5], "roughness": 0.6},
    {"type": "phong", "albedo": 0.8, "exponent": 40.0,
     "diffuse_ratio": 0.3},
    {"type": "diffuse_transmission", "albedo": [0.9, 0.8, 0.6],
     "transmittance": 0.5},
    {"type": "smooth_coat", "ior": 1.5, "sigma_a": [0.2, 0.4, 0.8],
     "thickness": 0.5, "substrate": "coat_metal"},
    {"type": "rough_coat", "ior": 1.4, "roughness": 0.1,
     "substrate": "coat_base"},
    {"type": "mixed", "ratio": 0.4, "bsdf0": "mix_diffuse",
     "bsdf1": "mix_mirror"},
    {"type": "mirror", "albedo": 0.95},
    {"type": "lambert", "albedo": [0.3, 0.7, 0.3]},
    {"type": "dielectric", "ior": 1.33},
    {"type": "rough_dielectric", "ior": 1.7, "roughness": 0.3,
     "distribution": "beckmann"},
    {"type": "conductor", "material": "Ag"},
    {"type": "rough_conductor", "material": "Al", "roughness": 0.1},
    {"type": "plastic", "albedo": 0.8, "ior": 1.6, "sigma_a": 0.5,
     "thickness": 0.3},
    {"type": "rough_plastic", "albedo": [0.8, 0.8, 0.2], "roughness": 0.35,
     "distribution": "phong"},
    {"type": "oren_nayar", "albedo": 0.6, "roughness": 0.9},
    {"type": "mixed", "ratio": 0.7, "bsdf0": "coat_metal",
     "bsdf1": "mix_diffuse"},
    {"type": "smooth_coat", "ior": 1.3, "substrate": "coat_base"},
    {"type": "lambert", "albedo": [0.7, 0.5, 0.3]},
]
ZOO_CHILDREN = [
    {"name": "coat_metal", "type": "rough_conductor", "material": "Cr",
     "roughness": 0.3},
    {"name": "coat_base", "type": "lambert", "albedo": [0.6, 0.1, 0.1]},
    {"name": "mix_diffuse", "type": "lambert", "albedo": [0.2, 0.3, 0.8]},
    {"name": "mix_mirror", "type": "mirror", "albedo": 0.9},
]


def write_zoo_scene(dirpath: str, res: int = RES, spp: int = SPP,
                    seg=ZOO_SEG, sky=(SKY_W, SKY_H)) -> str:
    """Write the large scene: the smoke scene's layout with 24 spheres of
    `seg` segments (one shared mesh file) in ZOO_SPHERES' materials, a
    lambert floor, an emissive quad with a null BSDF and the sky."""
    import numpy as np
    from tungsten_tpu_torch.io import mesh
    pos, nrm, uv, idx = uv_sphere(*seg)
    mesh.save_wo3(os.path.join(dirpath, "sphere.wo3"), mesh.Mesh(
        pos=pos, normal=nrm, uv=uv, indices=idx,
        material=np.zeros(len(idx), np.int32)))
    bsdfs = [{"name": "floor", "type": "lambert",
              "albedo": [0.55, 0.5, 0.45]},
             {"name": "light", "type": "null"}] + \
        [dict(b) for b in ZOO_CHILDREN]
    prims = [{"type": "quad", "bsdf": "floor",
              "transform": {"position": [0, 0, 0], "scale": [20, 1, 20]}},
             {"type": "quad", "bsdf": "light", "emission": [12.0, 11.0, 10.0],
              "transform": {"position": [0.5, 4.0, 0.5], "scale": [2, 1, 2],
                            "rotation": [0, 0, 180]}}]
    gx, gz = GRID_X, GRID_Z
    for k, b in enumerate(ZOO_SPHERES):
        i, j = k // gz, k % gz
        bsdfs.append(dict(b, name=f"zoo_{k}"))
        prims.append({"type": "mesh", "file": "sphere.wo3",
                      "bsdf": f"zoo_{k}", "smooth": True,
                      "transform": {"position": [i - (gx - 1) / 2, 0.45,
                                                 j - (gz - 1) / 2],
                                    "scale": 0.45}})
    prims.append(write_sky(dirpath, sky))
    path = os.path.join(dirpath, "zoo.json")
    with open(path, "w") as f:
        json.dump(scene_json(bsdfs, prims, res, spp), f, indent=1)
    return path


def smoke_density(n: int):
    """A seeded n^3 smoke density: a few soft puffs modulated by noise,
    with a floor of 0.01 so every voxel is active (the whole brick lives
    on the device)."""
    import numpy as np
    r = np.random.default_rng(SEED & 0xFFFF)
    x = (np.arange(n, dtype=np.float32) + 0.5) / n
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij", copy=False)
    dens = np.full((n, n, n), 0.01, np.float32)
    for _ in range(6):
        c = r.uniform(0.25, 0.75, 3).astype(np.float32)
        w = np.float32(r.uniform(0.08, 0.18))
        dens += 2.0 * np.exp(-((X - c[0]) ** 2 + (Y - c[1]) ** 2 +
                               (Z - c[2]) ** 2) / (w * w))
    dens *= 0.6 + 0.4 * r.random((n, n, n), dtype=np.float32)
    return dens


def write_media_scene(dirpath: str, res: int = RES, spp: int = SPP,
                      grid: int = MEDIA_GRID) -> tuple[str, float]:
    """Write the media scene: the smoke scene (the same sphere meshes and
    sky) in a homogeneous fog the camera sits in, bounded by a large
    `forward` box; a `forward` cube over the spheres holding a voxel
    medium on a grid^3 density written with the port's write_vdb (ZIP);
    four thinsheet and four transparency (opacity 0.5) spheres.
    Returns (scene path, seconds the .vdb write took)."""
    import numpy as np
    from tungsten_tpu_torch.io import vdb
    path = write_scene(dirpath, res, spp)
    with open(path) as f:
        sj = json.load(f)
    t0 = time.time()
    vdb.write_vdb(os.path.join(dirpath, "smoke.vdb"), {
        "density": vdb.VdbGridData("density", smoke_density(grid),
                                   (0, 0, 0), np.eye(4))})
    write_s = time.time() - t0
    sj["bsdfs"] += [{"name": "boundary", "type": "forward"},
                    {"name": "sheet", "type": "thinsheet", "ior": 1.5,
                     "sigma_a": [0.1, 0.3, 0.6], "thickness": 0.2}]
    sj["media"] = [
        {"name": "fog", "type": "homogeneous", "sigma_a": 0.01,
         "sigma_s": [0.03, 0.035, 0.04],
         "phase_function": {"type": "henyey_greenstein", "g": 0.5}},
        {"name": "smoke", "type": "voxel", "sigma_a": 0.3,
         "sigma_s": [1.6, 1.8, 2.0],
         "grid": {"type": "vdb", "file": "smoke.vdb",
                  "transform": {"position": [0, 1.1, 0], "scale": 1.6}}}]
    spheres = [p for p in sj["primitives"] if p["type"] == "mesh"]
    for k, p in enumerate(spheres):
        if k % 3 == 1 and k < 12:       # four thinsheet spheres
            p["bsdf"] = "sheet"
        elif k % 3 == 1:                # four transparency spheres
            sj["bsdfs"].append({"name": f"cutout_{k}", "type": "transparency",
                                "alpha": 0.5, "base": "floor"})
            p["bsdf"] = f"cutout_{k}"
    sj["primitives"] += [
        {"type": "cube", "bsdf": "boundary", "int_medium": "fog",
         "transform": {"position": [0, 5, 0], "scale": 26}},
        {"type": "cube", "bsdf": "boundary", "int_medium": "smoke",
         "ext_medium": "fog",
         "transform": {"position": [0, 1.9, 0], "scale": 1.6}}]
    sj["camera"]["medium"] = "fog"
    path = os.path.join(dirpath, "media.json")
    with open(path, "w") as f:
        json.dump(sj, f, indent=1)
    return path, write_s


def aperture_bitmap(n: int = 33):
    """A hexagonal aperture bitmap with a brighter rim, (n, n, 3)."""
    import numpy as np
    c = (np.arange(n) + 0.5) / n * 2.0 - 1.0
    X, Y = np.meshgrid(c, c)
    hexr = np.maximum(np.abs(X) * np.cos(np.pi / 6) + np.abs(Y) * 0.5,
                      np.abs(Y))
    img = np.where(hexr <= 0.95, 1.0, 0.0) + \
        np.where((hexr > 0.8) & (hexr <= 0.95), 0.5, 0.0)
    return np.repeat(img[..., None], 3, -1).astype(np.float32)


def write_outdoor_scene(dirpath: str, res: int = RES, spp: int = SPP) -> str:
    """Write the outdoor scene: the smoke scene's spheres and area light
    under a skydome and a 2-degree sun cap along the same axis (the sky
    .pfm env map goes), a point light, an emissive analytic sphere, disk
    and capped cylinder, an analytic disk floor in place of the floor
    quad, two cylinder pillars, a thinlens camera (an aperture bitmap
    written with the port's IO, cat eye 0.3, focus on the middle
    sphere, the mitchell_netravali filter).  Returns its path."""
    from tungsten_tpu_torch.io import image
    path = write_scene(dirpath, res, spp)
    with open(path) as f:
        sj = json.load(f)
    image.save_hdr(os.path.join(dirpath, "aperture.pfm"), aperture_bitmap())
    sun = {"rotation": [35, 0, 25]}
    prims = [p for p in sj["primitives"]
             if p["type"] not in ("infinite_sphere", "quad")
             or "emission" in p]
    for p in prims:
        if p.get("file") == "sphere_2_1.wo3":
            p["name"] = "focus"
    sj["bsdfs"] += [{"name": "stone", "type": "lambert",
                     "albedo": [0.5, 0.48, 0.45]},
                    {"name": "lamp", "type": "lambert", "albedo": 0.2}]
    prims += [
        {"type": "disk", "bsdf": "floor",
         "transform": {"position": [0, 0, 0], "scale": 12}},
        {"type": "cylinder", "bsdf": "stone", "capped": True,
         "transform": {"position": [-3.4, 1.2, -1.2],
                       "scale": [0.5, 2.4, 0.5]}},
        {"type": "cylinder", "bsdf": "stone", "capped": True,
         "transform": {"position": [3.4, 1.2, -1.2],
                       "scale": [0.5, 2.4, 0.5]}},
        {"type": "sphere", "bsdf": "lamp", "emission": [8.0, 5.0, 2.5],
         "transform": {"position": [0.0, 1.7, -2.2], "scale": 0.3}},
        {"type": "disk", "bsdf": "lamp", "power": [60.0, 60.0, 80.0],
         "transform": {"position": [-2.0, 3.0, 1.0], "scale": 0.6,
                       "rotation": [180, 0, 0]}},
        {"type": "cylinder", "bsdf": "lamp", "emission": [1.5, 4.0, 2.0],
         "capped": True,
         "transform": {"position": [2.6, 0.4, 1.8],
                       "scale": [0.25, 0.8, 0.25]}},
        {"type": "point", "emission": [6.0, 6.0, 5.0],
         "transform": {"position": [1.5, 2.5, 2.5]}},
        {"type": "skydome", "turbidity": 3.0, "intensity": 2.0,
         "transform": sun},
        {"type": "infinite_sphere_cap", "cap_angle": 2.0,
         "power": [6.0, 5.5, 4.5], "transform": sun}]
    sj["primitives"] = prims
    sj["camera"].update({
        "type": "thinlens", "aperture": "aperture.pfm",
        "aperture_size": 0.4, "cateye": 0.3, "focus_pivot": "focus",
        "reconstruction_filter": "mitchell_netravali"})
    path = os.path.join(dirpath, "outdoor.json")
    with open(path, "w") as f:
        json.dump(sj, f, indent=1)
    return path


# ---------------------------------------------------------------- timing

def event_ms(fn) -> float:
    """Milliseconds of one fn() bracketed by CUDA events."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def cuda_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median milliseconds of fn() over `runs` runs after one warm-up."""
    fn()
    return statistics.median(event_ms(fn) for _ in range(runs))


# ------------------------------------------------------------ kernel checks

def kernel_inputs(scene, o, d, t_max, t_min: float = 0.0):
    """What the dispatch hands a kernel: near limits t_min, far limits
    clipped at the geometry box (as bvh_intersect clips them), rays
    sorted and padded by the dispatch, ray features and the resident
    walk's per-warp super lists; for a paged scene also the paged walk's
    (page, entry) lists, page list and slot ranges."""
    import torch
    from tungsten_tpu_torch.ops import intersect as tis
    from tungsten_tpu_torch.ops import wave_trace as twt
    tmin = torch.full((o.shape[0],), t_min, dtype=torch.float32,
                      device=o.device)
    tmax = tis.geo_clip(scene, o, d, t_max)
    o, d, tmin, tmax, _ = tis.dispatch_rays(scene, o, d, tmin, tmax)
    f, sent, sids, _ = twt.kernel_inputs(scene, o, d, tmin, tmax)
    k = dict(o=o, d=d, tmin=tmin, tmax=tmax, f=f, sent=sent, sids=sids,
             paged=twt.traversal_kind(scene) == "paged")
    if k["paged"]:
        _, k["psent"], k["psids"], k["pages"], k["offs"], k["offe"], _ = \
            twt.paged_kernel_inputs(scene, o, d, tmin, tmax)
    return k


def launch(scene, k, kernel: str, splits=None):
    """One raw launch, `splits` CTAs a block (None: the launcher's
    choice), of `kernel`: "closest" or "anyhit", the resident kernels
    (K1's, K2's) counted as the scene's route, or "paged_walk", the paged
    any-hit walk on a paged scene's paged front.  Returns (t, tri
    cluster*128+slot, tests)."""
    from tungsten_tpu_torch.ops import wave_trace as twt
    if kernel == "paged_walk":
        return twt.paged_anyhit_kernel(k["f"], k["psent"], k["psids"],
                                       k["pages"], k["offs"], k["offe"],
                                       scene.wk_cbox, scene.wk_attr, splits)
    return twt.wave_kernel(k["f"], k["sent"], k["sids"], scene.wk_cbox,
                           scene.wk_attr, kernel == "anyhit", splits,
                           ("paged_" if k["paged"] else "") + kernel)


def wrapper(scene, k, any_hit: bool):
    """The scene's wrapper (front, kernel, remap, finalize)."""
    from tungsten_tpu_torch.ops import wave_trace as twt
    fn = twt.wave_intersect_paged if k["paged"] else twt.wave_intersect
    return fn(scene, k["o"], k["d"], k["tmin"], k["tmax"], any_hit=any_hit)


def bound_ms(scene, k, tests: int) -> tuple[float, str]:
    """Least time for a resident launch: its input and output bytes over
    the HBM rate vs the ray-triangle tests this data needs over the f32
    rate."""
    from tungsten_tpu_torch.ops import wave_trace as twt
    ins = [k["f"], k["sent"], k["sids"], scene.wk_cbox, scene.wk_attr]
    nbytes = sum(x.numel() * x.element_size() for x in ins)
    nbytes += k["f"].shape[0] * 8          # t and tri out
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = tests * twt.FLOPS_PER_TEST / PEAK_F32 * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def hit_gates(name, t, tri, u, v, pt, ptri, pu, pv, live) -> float:
    """tests/test_torch_wave.py's gates, kernel path vs plain walk; returns
    the max |t| difference over rays that agree on the triangle (after the
    wrapper's f32 finalize, which both paths share)."""
    import torch
    agree = ((tri >= 0) == (ptri >= 0))[live].float().mean().item()
    both = live & (tri >= 0) & (ptri >= 0)
    t_ok = torch.isclose(t[both], pt[both], rtol=2e-3).float().mean().item()
    same_tri = (tri[both] == ptri[both]).float().mean().item()
    same = both & (tri == ptri)
    uv_ok = bool(((u[same] - pu[same]).abs() <= 2e-3).all() and
                 ((v[same] - pv[same]).abs() <= 2e-3).all())
    dead_ok = bool((tri[~live] == -1).all())
    err = (t[same] - pt[same]).abs().max().item() if bool(same.any()) else 0.0
    log(f"  {name}: hit-set agreement {agree:.6f}, t within 2e-3 "
        f"{t_ok:.6f}, same triangle {same_tri:.6f}, u/v within 2e-3 "
        f"{uv_ok}, dead rays miss {dead_ok}, max |dt| {err:.3e}")
    if not (agree > 0.998 and t_ok > 0.999 and same_tri > 0.999 and uv_ok
            and dead_ok):
        raise AssertionError(f"{name}: kernel disagrees with the plain walk")
    return err


def raw_t_error(scene, name, t_raw, tri_raw, pt, ptri, live) -> float:
    """The kernel's own t (before the wrapper's finalize replaces it)
    against the plain walk's, on rays that agree on the triangle: within
    rtol 2e-3 on > 0.999 of them.  Returns the max |dt|."""
    import torch
    hit = tri_raw >= 0
    ids = scene.wk_remap[torch.clamp(tri_raw, 0,
                                     scene.wk_remap.shape[0] - 1).long()]
    same = live & hit & (ptri >= 0) & (torch.where(hit, ids, -1) == ptri)
    if not bool(same.any()):
        return 0.0
    ok = torch.isclose(t_raw[same], pt[same], rtol=2e-3).float().mean().item()
    err = (t_raw[same] - pt[same]).abs().max().item()
    rel = ((t_raw[same] - pt[same]).abs() / pt[same].abs()).max().item()
    log(f"  {name}: kernel t before the finalize within 2e-3 {ok:.6f}, max "
        f"|dt| {err:.3e}, max |dt|/t {rel:.3e}")
    if not ok > 0.999:
        raise AssertionError(f"{name}: the kernel's t disagrees")
    return err


def check_paged_walk(scene, k, o, d, t_max, tri2) -> dict:
    """The paged any-hit walk, off the render path, on the segments K2
    ran (`tri2`, K2's tri at splits=1): the occluded set equal to K2's,
    against list_walk on the paged front, splits bitwise equal, tests run
    at most 1.5x list_walk's needed count; its ms, tests, by width."""
    import torch
    name = "paged any-hit walk"
    t3, tri3, tests3 = launch(scene, k, "paged_walk", splits=1)
    torch.cuda.synchronize()
    same = bool(torch.equal(tri3 >= 0, tri2 >= 0))
    log(f"  {name}: occluded set equal to K2's on the same segments {same}")
    if not same:
        raise AssertionError(f"{name}: the paged and resident any-hit "
                             f"kernels disagree")
    out = vs_list_walk(scene, name, k, "paged_walk", t3, tri3, tests3)
    out.update(splits_equal(scene, name, k, "paged_walk", (t3, tri3)))
    n_tests, n_ran = tri_test_counts(tests3)
    ms = cuda_ms(lambda: launch(scene, k, "paged_walk"))
    log(f"  {name}: {n_tests} tests needed at splits=1, {n_ran} run "
        f"({n_ran / max(out['list_walk_tests'], 1):.4f} of list_walk's "
        f"needed); kernel {ms:.3f} ms")
    if n_ran > 1.5 * out["list_walk_tests"]:
        raise AssertionError(f"{name}: ran more than 1.5x the tests its "
                             f"rays need")
    out.update(ms=ms, tests=n_tests, tests_run=n_ran,
               by_width=by_width(scene, name, o, d, t_max, "paged_walk"))
    return out


def anyhit_routes(scene, k, occ) -> dict:
    """The large scene's two any-hit routes on the same segments, their
    wrappers (front, kernel, remap) timed in turns in this run, each the
    median of 5 after a warm-up with its range (max - min): "paged",
    paged_kernel_inputs + the paged any-hit walk + _finish; "resident",
    kernel_inputs + K2 + _finish (what wave_intersect_paged runs).  Both
    must give the occluded set `occ` of the scene's wrapper.  "winner"
    is the resident route where its median is below the paged one's by
    more than the wider range, else the paged route."""
    import torch
    from tungsten_tpu_torch.ops import wave_trace as twt
    args = (scene, k["o"], k["d"], k["tmin"], k["tmax"])

    def paged():
        f, sent, sids, pages, offs, offe, tmax_c = \
            twt.paged_kernel_inputs(*args)
        t, tri, _ = twt.paged_anyhit_kernel(f, sent, sids, pages, offs,
                                            offe, scene.wk_cbox,
                                            scene.wk_attr)
        return twt._finish(*args[:3], t, tri, tmax_c, True)

    def resident():
        f, sent, sids, tmax_c = twt.kernel_inputs(*args)
        t, tri, _ = twt.wave_kernel(f, sent, sids, scene.wk_cbox,
                                    scene.wk_attr, True,
                                    route="paged_anyhit")
        return twt._finish(*args[:3], t, tri, tmax_c, True)

    routes = {"paged": paged, "resident": resident}
    times = {name: [] for name in routes}
    for name, fn in routes.items():       # the warm-up, and the check
        if not bool(torch.equal(fn()[1] >= 0, occ)):
            raise AssertionError(f"any-hit route {name}: occluded set "
                                 f"differs from the wrapper's")
    for _ in range(TIMED_RUNS):
        for name, fn in routes.items():
            times[name].append(event_ms(fn))
    out = {name: {"wrapper_ms": statistics.median(x),
                  "wrapper_range_ms": max(x) - min(x)}
           for name, x in times.items()}
    p, r = out["paged"], out["resident"]
    spread = max(p["wrapper_range_ms"], r["wrapper_range_ms"])
    out["winner"] = "resident" if r["wrapper_ms"] + spread < \
        p["wrapper_ms"] else "paged"
    log(f"  shadow segments, any-hit routes (wrapper ms, median of "
        f"{TIMED_RUNS} in turns, range): paged {p['wrapper_ms']:.3f} "
        f"({p['wrapper_range_ms']:.3f}), resident {r['wrapper_ms']:.3f} "
        f"({r['wrapper_range_ms']:.3f}); occluded sets equal; faster by "
        f"more than the wider range: {out['winner']}")
    return out


def tri_test_counts(tests) -> tuple[int, int]:
    """(tests the data needs, tests the threads ran) of one launch."""
    import torch
    return (int(tests[0].sum(dtype=torch.int64)),
            int(tests[1].sum(dtype=torch.int64)))


LIST_WALK_RAYS = 8192   # the rays held against list_walk ray for ray


def list_front(k, kernel: str, n: int | None = None):
    """The launch's front (f, sent, sids), for the first n rays."""
    names = ("f", "psent", "psids") if kernel == "paged_walk" else \
        ("f", "sent", "sids")
    if n is None:
        return tuple(k[x] for x in names)
    return (k["f"][:n],) + tuple(k[x][:n // 128] for x in names[1:])


def vs_list_walk(scene, name, k, kernel: str, t, tri, tests) -> dict:
    """A splits=1 launch against list_walk (the kernels' schedule in plain
    PyTorch): on the first LIST_WALK_RAYS rays the triangle (closest
    hit) or the occluded flag (any hit) equal on >= 0.9999 of live rays
    (nvcc contracts the leaf's multiply-adds into FMAs, PyTorch does
    not, so a near-tie may part) and the needed totals within 0.01 %;
    at full width list_walk's needed count, which the bound and the
    run/needed gate take, and the kernel's beside it."""
    import torch
    from tungsten_tpu_torch.ops import wave_trace as twt
    any_hit = kernel != "closest"
    n = min(LIST_WALK_RAYS, k["f"].shape[0])
    t0 = time.time()
    lt, ltri, lneed = twt.list_walk(*list_front(k, kernel, n),
                                    scene.wk_cbox, scene.wk_attr, any_hit)
    live = k["tmax"][:n] > 0
    if any_hit:
        same = ((tri[:n] >= 0) == (ltri >= 0))[live]
    else:
        same = (tri[:n] == ltri)[live]
    same = same.float().mean().item()
    kn = int(tests[0][:n].sum(dtype=torch.int64))
    ln = int(lneed.sum(dtype=torch.int64))
    rel = abs(kn - ln) / max(ln, 1)
    _, _, fneed = twt.list_walk(*list_front(k, kernel), scene.wk_cbox,
                                scene.wk_attr, any_hit)
    full = int(fneed.sum(dtype=torch.int64))
    torch.cuda.synchronize()
    log(f"  {name}: vs list_walk on the first {n} rays: "
        f"{'occluded flag' if any_hit else 'triangle'} equal on {same:.6f}"
        f" of live rays, needed {kn} vs {ln} ({rel:.2e}); at full width "
        f"list_walk needs {full}, the kernel at splits=1 counts "
        f"{tri_test_counts(tests)[0]} ({time.time() - t0:.1f} s)")
    if not (same >= 0.9999 and rel <= 1e-4):
        raise AssertionError(f"{name}: the kernel disagrees with list_walk")
    return {"list_walk_tests": full, "list_walk_agreement": same,
            "list_walk_needed_rel": rel}


def result_of(t, tri, kernel: str):
    """What the CTA split must not change: t and tri (closest hit), the
    occluded flag (any hit)."""
    return (t, tri) if kernel == "closest" else (tri >= 0,)


def splits_equal(scene, name, k, kernel: str, one) -> dict:
    """The launcher's choice of splits and splits=8 against splits=1:
    bitwise equal results."""
    import torch
    from tungsten_tpu_torch.ops import wave_trace as twt
    want = result_of(*one[:2], kernel)
    S = twt.launch_splits(k["f"].shape[0] // 128, k["f"].device)
    for splits in (None, 8):
        got = result_of(*launch(scene, k, kernel, splits=splits)[:2],
                        kernel)
        if not all(bool(torch.equal(a, b)) for a, b in zip(want, got)):
            raise AssertionError(f"{name}: splits={splits} differs from "
                                 f"splits=1")
    log(f"  {name}: splits=1, the launcher's {S} and 8 bitwise equal")
    return {"splits": S}


WIDTHS = (1024, 4096, 8192, 65536)   # narrow waves, as late bounces leave
TAIL = (4096, 256)                   # a sparse tail wave: rays, live rays


def by_width(scene, name, o, d, t_max, kernel: str,
             t_min: float = 0.0) -> dict:
    """The kernel on the first w rays of a ray set, and on a sparse tail
    wave (the first 4,096 rays, 256 of them live, gathered to the front
    as compact_wave leaves them), at splits=1 and at the launcher's
    choice: bitwise equal, and their times, with the tests the launch
    needed and ran at splits=1."""
    import torch
    from tungsten_tpu_torch.ops import wave_trace as twt
    out = {}
    for w in WIDTHS + ("tail",):
        tm = t_max
        if w == "tail":
            w = TAIL[0]
            tm = t_max[:w].clone()
            tm[TAIL[1]:] = 0.0
        if w > o.shape[0]:
            break
        k = kernel_inputs(scene, o[:w], d[:w], tm[:w], t_min)
        one = launch(scene, k, kernel, splits=1)
        auto = launch(scene, k, kernel)
        if not all(bool(torch.equal(a, b)) for a, b in
                   zip(result_of(*one[:2], kernel),
                       result_of(*auto[:2], kernel))):
            raise AssertionError(f"{name}: splits change the result at "
                                 f"{w} rays")
        S = twt.launch_splits(w // 128, o.device)
        ms1 = cuda_ms(lambda: launch(scene, k, kernel, splits=1))
        ms = cuda_ms(lambda: launch(scene, k, kernel))
        live = int((k["tmax"] > 0).sum())
        need, ran = tri_test_counts(one[2])
        key = "tail" if tm is not t_max else str(w)
        out[key] = {"rays": w, "live": live, "splits": S, "ms": ms,
                    "ms_splits1": ms1, "tests": need, "tests_run": ran}
        log(f"  {name}, {key} ({w} rays, {live} live, {need} tests "
            f"needed): {ms:.4f} ms at the launcher's {S} CTAs a block, "
            f"{ms1:.4f} ms at 1 ({ms1 / ms:.2f}x), bitwise equal")
    return out


def check_closest(scene, name, o, d, t_max, t_min: float = 0.0):
    """The closest-hit kernel on one ray set (near limits t_min), as the
    scene's route: gates against the plain walk and against list_walk,
    splits bitwise equal, tests run against list_walk's needed count,
    and times, by width too."""
    import torch
    from tungsten_tpu_torch.ops import intersect as tis
    k = kernel_inputs(scene, o, d, t_max, t_min)
    live = k["tmax"] > 0
    t, tri, u, v = wrapper(scene, k, False)
    pt, ptri, pu, pv = tis.bvh_walk(scene, k["o"], k["d"], k["tmin"],
                                    k["tmax"])
    torch.cuda.synchronize()
    err_final = hit_gates(name, t, tri, u, v, pt, ptri, pu, pv, live)
    t_raw, tri_raw, tests = launch(scene, k, "closest", splits=1)
    err = raw_t_error(scene, name, t_raw, tri_raw, pt, ptri, live)
    out = vs_list_walk(scene, name, k, "closest", t_raw, tri_raw, tests)
    out.update(splits_equal(scene, name, k, "closest", (t_raw, tri_raw)))
    ms = cuda_ms(lambda: launch(scene, k, "closest"))
    wrap_ms = cuda_ms(lambda: wrapper(scene, k, False))
    plain_ms = cuda_ms(lambda: tis.bvh_walk(scene, k["o"], k["d"], k["tmin"],
                                            k["tmax"]))
    n_tests, n_ran = tri_test_counts(tests)
    need = out["list_walk_tests"]
    b, by = bound_ms(scene, k, need)
    log(f"  {name}: tests run / list_walk's needed "
        f"{n_ran / max(need, 1):.4f}")
    if n_ran > 1.5 * need:
        raise AssertionError(f"{name}: the kernel ran more than 1.5x the "
                             f"tests its rays need")
    hit_share = (tri >= 0).float().mean().item()
    log(f"  {name}: {o.shape[0]} rays ({int(live.sum())} live, hit share "
        f"{hit_share:.4f}), {n_tests} ray-triangle tests needed at "
        f"splits=1, {n_ran} run; kernel {ms:.3f} ms, wrapper (front + "
        f"kernel + finalize) {wrap_ms:.3f} ms, plain walk {plain_ms:.3f} "
        f"ms, bound {b:.4f} ms ({by})")
    out["by_width"] = by_width(scene, name, o, d, t_max, "closest", t_min)
    out.update(ms=ms, wrapper_ms=wrap_ms, plain_ms=plain_ms, bound_ms=b,
               bound_by=by, max_abs_err=err, max_abs_err_final=err_final,
               rays=int(o.shape[0]), tests=n_tests, tests_run=n_ran,
               hits=(t, tri, k))
    return out


def shadow_segments(scene, o, d, t, tri, seed: int):
    """NEE-style segments from the camera hits toward uniform points on the
    area light's triangles (t_max shy of the light, as _nee clips them);
    camera misses give dead segments."""
    import torch
    from tungsten_tpu_torch.integrators.path_tracer import (EPSILON,
                                                            SHADOW_FUDGE)
    g = torch.Generator(device=o.device).manual_seed(seed)
    R = o.shape[0]
    n_lt = int(scene.light_tri_cnt[0])
    pick = scene.lt_tri[torch.randint(0, n_lt, (R,), generator=g,
                                      device=o.device)].long()
    a = torch.rand((R,), generator=g, device=o.device)
    b = torch.rand((R,), generator=g, device=o.device)
    flip = a + b > 1.0
    a, b = torch.where(flip, 1.0 - a, a), torch.where(flip, 1.0 - b, b)
    target = scene.tri_v0[pick] + a[:, None] * scene.tri_e1[pick] + \
        b[:, None] * scene.tri_e2[pick]
    p = o + d * t[:, None]
    to = target - p
    dist = torch.linalg.vector_norm(to, dim=-1)
    sd = to / torch.clamp(dist, min=1e-20)[:, None]
    tmax = torch.where(tri >= 0, dist * SHADOW_FUDGE, 0.0)
    return p + sd * EPSILON, sd, tmax


def check_anyhit(scene, o, d, t_max):
    """The scene's any-hit route on shadow segments: its wrapper against
    the plain any-hit walk, its hit set against the closest hit's on the
    very same segments; its kernel (K2, on either scene) against
    list_walk, splits bitwise equal, tests run against list_walk's
    needed count, times, by width too; on a paged scene also the paged
    any-hit walk on the same segments (check_paged_walk) and the two
    any-hit routes' wrappers timed (anyhit_routes)."""
    import torch
    from tungsten_tpu_torch.ops import intersect as tis
    k = kernel_inputs(scene, o, d, t_max)
    live = k["tmax"] > 0
    _, tri_a, _, _ = wrapper(scene, k, True)
    _, tri_c, _, _ = wrapper(scene, k, False)
    _, ptri, _, _ = tis.bvh_walk(scene, k["o"], k["d"], k["tmin"], k["tmax"],
                                 any_hit=True)
    torch.cuda.synchronize()
    occ, pocc = tri_a >= 0, ptri >= 0
    agree = (occ == pocc)[live].float().mean().item()
    same_as_k1 = bool(torch.equal(occ, tri_c >= 0))
    err = (occ.float() - pocc.float()).abs().max().item()
    log(f"  shadow segments: {int(live.sum())} live of {o.shape[0]}, "
        f"occluded share {occ[live].float().mean().item():.4f}; any-hit vs "
        f"plain agreement {agree:.6f}; hit set equal to closest hit "
        f"{same_as_k1}")
    if not (agree > 0.998 and same_as_k1 and bool((tri_a[~live] == -1).all())):
        raise AssertionError("any-hit kernel disagrees")
    t_raw, tri_raw, tests = launch(scene, k, "anyhit", splits=1)
    out = vs_list_walk(scene, "shadow segments", k, "anyhit", t_raw,
                       tri_raw, tests)
    out.update(splits_equal(scene, "shadow segments", k, "anyhit",
                            (t_raw, tri_raw)))
    ms = cuda_ms(lambda: launch(scene, k, "anyhit"))
    wrap_ms = cuda_ms(lambda: wrapper(scene, k, True))
    plain_ms = cuda_ms(lambda: tis.bvh_walk(scene, k["o"], k["d"], k["tmin"],
                                            k["tmax"], any_hit=True))
    n_tests, n_ran = tri_test_counts(tests)
    need = out["list_walk_tests"]
    b, by = bound_ms(scene, k, need)
    log(f"  shadow segments: tests run / list_walk's needed "
        f"{n_ran / max(need, 1):.4f}")
    if n_ran > 1.5 * need:
        raise AssertionError("shadow segments: the kernel ran more than "
                             "1.5x the tests its rays need")
    log(f"  shadow segments: {n_tests} ray-triangle tests needed at "
        f"splits=1, {n_ran} run; kernel {ms:.3f} ms, wrapper {wrap_ms:.3f} "
        f"ms, plain walk {plain_ms:.3f} ms, bound {b:.4f} ms ({by})")
    out["by_width"] = by_width(scene, "shadow segments", o, d, t_max,
                               "anyhit")
    if k["paged"]:
        out["paged_walk"] = check_paged_walk(scene, k, o, d, t_max, tri_raw)
        out["routes"] = anyhit_routes(scene, k, occ)
    out.update(ms=ms, wrapper_ms=wrap_ms, plain_ms=plain_ms, bound_ms=b,
               bound_by=by, max_abs_err=err, agreement=agree,
               rays=int(o.shape[0]), tests=n_tests, tests_run=n_ran)
    return out


def check_scene_kernels(scene, settings):
    """Both modes of the scene's kernels on the 16-spp wave's camera rays,
    one bounce's continuation rays and NEE-style shadow segments from the
    camera hits.  Returns (camera, continuation, shadow) results."""
    import torch
    from tungsten_tpu_torch.integrators import path_tracer as tpt
    dev = scene.device
    n = settings.width * settings.height
    pix = torch.arange(n, dtype=torch.int32, device=dev).repeat(SPP)
    smp = torch.arange(SPP, dtype=torch.int32, device=dev).repeat_interleave(n)
    s0 = tpt.init_wave(scene, settings, pix, smp, SEED)
    inf = torch.full_like(s0["o"][:, 0], 3.0e38)
    prim = check_closest(scene, "camera rays", s0["o"], s0["d"],
                         torch.where(s0["alive"], inf, 0.0))
    s1 = tpt._make_bounce_body(scene, settings, SEED)(s0)
    cont = check_closest(scene, "continuation rays", s1["o"], s1["d"],
                         torch.where(s1["alive"], inf, 0.0))
    t_p, tri_p, kp = prim.pop("hits")
    cont.pop("hits")
    so, sd, stmax = shadow_segments(scene, kp["o"], kp["d"], t_p, tri_p,
                                    SEED)
    shadow = check_anyhit(scene, so, sd, stmax)
    torch.cuda.synchronize()
    return prim, cont, shadow


def check_media_hop(scene, settings) -> dict:
    """K1 on the generalized shadow ray's first hop, as _nee's walk traces
    it: segments from the camera hits toward the area light, near limit
    EPSILON (per ray in the kernel's rows), far limit the light distance
    times SHADOW_FUDGE, held to check_closest's gates (plain walk,
    list_walk, splits, by width); then the full-width hop wave with one
    ray in 16 live (as a late hop leaves it) timed against the all-live
    wave, kernel and wrapper."""
    import torch
    from tungsten_tpu_torch.integrators import path_tracer as tpt
    from tungsten_tpu_torch.ops import intersect as tis
    dev = scene.device
    n = settings.width * settings.height
    pix = torch.arange(n, dtype=torch.int32, device=dev).repeat(SPP)
    smp = torch.arange(SPP, dtype=torch.int32, device=dev).repeat_interleave(n)
    s0 = tpt.init_wave(scene, settings, pix, smp, SEED)
    res = tis.bvh_intersect(scene, s0["o"], s0["d"], 0.0,
                            torch.where(s0["alive"], 3.0e38, 0.0))
    so, sd, stmax = shadow_segments(scene, s0["o"], s0["d"], res["t"],
                                    res["tri"], SEED)
    out = check_closest(scene, "media shadow hop", so, sd, stmax,
                        t_min=tpt.EPSILON)
    out.pop("hits")
    every = torch.arange(so.shape[0], device=dev) % 16 == 0
    sparse = {}
    for key, tm in (("all_live", stmax),
                    ("one_in_16", torch.where(every, stmax, 0.0))):
        k = kernel_inputs(scene, so, sd, tm, tpt.EPSILON)
        sparse[key] = {
            "live": int((tm > 0).sum()),
            "ms": cuda_ms(lambda: launch(scene, k, "closest")),
            "wrapper_ms": cuda_ms(lambda: tis.bvh_intersect(
                scene, so, sd, tpt.EPSILON, tm))}
    a, b = sparse["all_live"], sparse["one_in_16"]
    log(f"  media shadow hop, full width: all live ({a['live']} rays) "
        f"kernel {a['ms']:.3f} ms, bvh_intersect {a['wrapper_ms']:.3f} ms; "
        f"one in 16 live ({b['live']}) kernel {b['ms']:.3f} ms, "
        f"bvh_intersect {b['wrapper_ms']:.3f} ms")
    out["sparse_wave"] = sparse
    return out


def analytic_far(scene, o, d, t_max):
    """The far limits bvh_intersect hands the triangle walk: clipped at
    the geometry box, then cut at the nearest analytic hit."""
    import torch
    from tungsten_tpu_torch.ops import intersect as tis
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device)
    best, sph, dsk, cyl = tis._analytic_prims(
        scene, o, d, torch.zeros_like(o[:, 0]), tis.geo_clip(scene, o, d,
                                                             t_max))
    return best, (sph >= 0) | (dsk >= 0) | (cyl >= 0)


def check_outdoor_kernels(scene, settings) -> tuple[dict, dict, dict]:
    """K1 on the camera rays with the far limits their analytic hits give
    them, and the traversals of one full-width bounce body through the
    simple two-strategy NEE, recorded as the body makes them: K2 on its
    shadow segments (far limit dist * SHADOW_FUDGE, INF toward the cap,
    0 where no shadow ray is traced) and K1 on its bsdf-strategy rays
    (far limit INF where the strategy sample is live, else 0), each
    with the analytic cut bvh_intersect applies, under phase 4's gates
    and by width.  bvh_intersect's own time on the strategy wave (the
    sort and the cull run over every ray) is timed beside the kernel.
    Returns (camera, shadow, strategy)."""
    import torch
    from tungsten_tpu_torch.integrators import path_tracer as tpt
    from tungsten_tpu_torch.ops import intersect as tis
    dev = scene.device
    n = settings.width * settings.height
    pix = torch.arange(n, dtype=torch.int32, device=dev).repeat(SPP)
    smp = torch.arange(SPP, dtype=torch.int32, device=dev).repeat_interleave(n)
    s0 = tpt.init_wave(scene, settings, pix, smp, SEED)
    far, ana = analytic_far(scene, s0["o"], s0["d"],
                            torch.where(s0["alive"], 3.0e38, 0.0))
    live = s0["alive"]
    log(f"  camera rays: {int(live.sum())} live of {live.shape[0]} (the "
        f"cat eye zeroes the rest); an analytic hit cuts the far limit of "
        f"{ana[live].float().mean().item():.4f} of the live ones")
    cam = check_closest(scene, "outdoor camera rays", s0["o"], s0["d"], far)
    cam.pop("hits")
    calls = []
    orig = tpt.bvh_intersect

    def record(sc, o, d, t_min, t_max, any_hit=False, presorted=False):
        calls.append((o, d, t_min, t_max, any_hit))
        return orig(sc, o, d, t_min, t_max, any_hit=any_hit,
                    presorted=presorted)
    tpt.bvh_intersect = record
    try:
        tpt._make_bounce_body(scene, settings, SEED)(s0)
    finally:
        tpt.bvh_intersect = orig
    kinds = [("anyhit" if c[4] else "closest") for c in calls]
    if kinds != ["closest", "anyhit", "closest"]:
        raise AssertionError(f"outdoor body: traversals {kinds}, not the "
                             f"simple sub-branch's three")
    so, sd, _, s_tmax, _ = calls[1]
    bo, bd, _, b_tmax, _ = calls[2]
    s_far, _ = analytic_far(scene, so, sd, s_tmax)
    log(f"  shadow segments: {int((s_tmax > 0).sum())} traced, "
        f"{int((s_tmax >= 3.0e38).sum())} toward the cap or the sky")
    shadow = check_anyhit(scene, so, sd, s_far)
    b_far, _ = analytic_far(scene, bo, bd, b_tmax)
    strat = check_closest(scene, "bsdf-strategy rays", bo, bd, b_far)
    strat.pop("hits")
    strat["live"] = int((b_tmax > 0).sum())
    strat["bvh_intersect_ms"] = cuda_ms(
        lambda: tis.bvh_intersect(scene, bo, bd, 0.0, b_tmax))
    log(f"  bsdf-strategy rays: {strat['live']} live of {bo.shape[0]}; "
        f"bvh_intersect {strat['bvh_intersect_ms']:.3f} ms beside the "
        f"kernel's {strat['ms']:.3f} ms")
    return cam, shadow, strat


def render_counted(scene, settings, twt):
    """The main path with every launch count set to 0 just before and
    read just after: (image, stats, launches)."""
    from tungsten_tpu_torch.render import render
    for key in twt.LAUNCHES:
        twt.LAUNCHES[key] = 0
    img, stats = render(scene, settings, spp=SPP, seed=SEED, spp_chunk=SPP,
                        return_stats=True)
    return img, stats, dict(twt.LAUNCHES)


def cross_path(scene, settings, max_bounces: int | None = None,
               res=(64, 64), **changes) -> None:
    """A res-sized 4-spp image from the kernel path against the port's
    plain path on the CPU (the gates: <= 1 % of pixels off by more than
    rtol 1e-3 / atol 1e-4, means within 0.5 %), at the scene's bounce
    limit or at `max_bounces`, with other settings `changes` (a camera
    type)."""
    import numpy as np
    from tungsten_tpu_torch.render import render
    small = replace(settings, width=res[0], height=res[1],
                    max_bounces=max_bounces or settings.max_bounces,
                    **changes)
    t0 = time.time()
    gpu = render(scene, small, spp=4, seed=SEED, spp_chunk=4)
    cpu = render(scene.to("cpu"), small, spp=4, seed=SEED, spp_chunk=4,
                 device="cpu")
    close = np.isclose(gpu, cpu, rtol=1e-3, atol=1e-4).all(-1)
    off = 1.0 - close.mean()
    rel_mean = abs(gpu.mean() / cpu.mean() - 1.0)
    log(f"cross-path {small.camera_type} {res[0]}x{res[1]} 4 spp "
        f"max_bounces {small.max_bounces}: "
        f"{off * 100:.3f}% of pixels off by more "
        f"than rtol 1e-3 (atol 1e-4), mean {gpu.mean():.6f} vs "
        f"{cpu.mean():.6f} ({rel_mean * 100:.4f}%), {time.time() - t0:.1f}"
        f" s")
    if not (off <= 0.01 and rel_mean <= 0.005):
        raise AssertionError("cross-path image check failed")


KERNEL_OF_ROUTE = {"closest": "wave_trace_closest_kernel",
                   "paged_closest": "wave_trace_closest_kernel",
                   "anyhit": "wave_trace_anyhit_kernel",
                   "paged_anyhit": "wave_trace_anyhit_kernel",
                   "paged_walk": "wave_trace_paged_anyhit_kernel"}


def profile_render(render_once, summary: dict | None = None) -> dict:
    """One more render under torch.profiler (device activity only): device
    busy time (the union of kernel intervals) against the profiled wall
    time, and the kernels that take the most device time.  The profiler's
    own host cost is in the wall time, so the idle share is an upper
    bound.  The raw device events are read directly: the profiler's
    per-event Python parse takes minutes at a million launches.  The
    wrappers log each traversal launch (route, rays, splits) meanwhile,
    and the traversal kernels' device events, in launch order, are
    tallied by route and width: returns {route: {"launches", "ms",
    "by_width": {rays: {"launches", "splits", "ms"}}}}, or {} where the
    events do not pair with the launches (then not measured).  A
    `summary` dict receives the profiled wall and device busy ms, the
    kernel launches and the idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tungsten_tpu_torch.ops import wave_trace as twt
    twt.LAUNCH_LOG = []
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            render_once()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        launched = twt.LAUNCH_LOG
    finally:
        twt.LAUNCH_LOG = None
    kern = [(e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]
    if not kern:
        log("profile: the profiler recorded no device activity (device "
            "busy share not measured)")
        return {}
    spans = sorted((s, e) for s, e, _ in kern)
    busy, (cs, ce) = 0, spans[0]
    for s, e in spans[1:]:
        if s > ce:
            busy += ce - cs
            cs, ce = s, e
        else:
            ce = max(ce, e)
    busy += ce - cs
    by_name: dict[str, list] = {}
    for s, e, name in kern:
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += e - s
        acc[1] += 1
    total = sum(v[0] for v in by_name.values())
    launches = sum(v[1] for v in by_name.values())
    wave = sum(v[0] for k, v in by_name.items() if "wave_trace" in k)
    if summary is not None:
        summary.update(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                       launches=launches, idle=1.0 - busy / wall_us)
    log(f"profile: wall {wall_us / 1e3:.1f} ms under the profiler, device "
        f"busy {busy / 1e3:.1f} ms ({busy / wall_us * 100:.1f} %, idle "
        f"{100 - busy / wall_us * 100:.1f} %), {launches} kernel launches; "
        f"wave kernels {wave / 1e3:.1f} ms ({wave / total * 100:.1f} % of "
        f"kernel time)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (us, n) in top:
        log(f"  {us / 1e3:9.2f} ms {n:6d}x {us / total * 100:5.1f} %  "
            f"{name[:90]}")
    trav = sorted((s, e, name) for s, e, name in kern
                  if "wave_trace" in name)
    if len(trav) != len(launched) or not all(
            KERNEL_OF_ROUTE[route] in name
            for (_, _, name), (route, _, _) in zip(trav, launched)):
        log(f"  traversal launches by width: not measured ({len(trav)} "
            f"device events, {len(launched)} launches logged)")
        return {}
    tally: dict[str, dict] = {}
    for (s, e, _), (route, rays, splits) in zip(trav, launched):
        r = tally.setdefault(route, {"launches": 0, "ms": 0.0,
                                     "by_width": {}})
        w = r["by_width"].setdefault(str(rays), {"launches": 0,
                                                 "splits": splits,
                                                 "ms": 0.0})
        for x in (r, w):
            x["launches"] += 1
            x["ms"] += (e - s) / 1e3
    for route, r in tally.items():
        log(f"  {route}: {r['launches']} launches, {r['ms']:.3f} ms device "
            f"time; by rays a launch (launches, CTAs a block, ms): " +
            ", ".join(f"{w}: {x['launches']}x{x['splits']} "
                      f"{x['ms']:.3f}" for w, x in sorted(
                          r["by_width"].items(), key=lambda i: -int(i[0]))))
    return tally


# ------------------------------------------------------------ leaf kernels

# (row name, its shape (M, K, N), the TPU kernel it replaces)
LEAF_ROWS = [("mma_loop", (512, 48, 128), "tools_mxubench.py:16"),
             ("mma_loop_stores", (512, 48, 128), "tools_mxubench.py:16"),
             ("leaf_variant_a", (2048, 48, 128), "tools_mxubench.py:86"),
             ("leaf_variant_b", (2048, 48, 128), "tools_mxubench.py:110"),
             ("leaf_variant_c", (2048, 48, 128), "tools_mxubench.py:122")]
LEAF_TOL = ("vs plain (torch.matmul in f32 on the bf16 values, in a Python "
            "loop): on the tool's all-ones inputs row and checksum exactly "
            "equal; on seeded random bf16 inputs in [-1, 1) (for K4 the "
            "scratch too starts random, as its zeros hide the product) the "
            "last product "
            "within 1e-5 x (max|P| + 1) per element, the row sums within "
            "1e-5 x iters x (max|P| + 1), the f64 checksum within 1e-6 of "
            "the l1 norm of what it sums; max_abs_err is the last product's")


def leaf_call(mxb, name, a, tbl, plain: bool, full: bool = False,
              blocks: int = 0):
    """One run of a leaf row's kernel (or its plain version) at the TPU
    tool's iteration count: (row, checksum, last product).  For K4 rows
    `tbl` is the scratch's initial value (None: zeros); blocks > 0 caps
    the kernel's grid."""
    if name.startswith("mma_loop"):
        stores = name.endswith("stores")
        if plain:
            return mxb.mma_loop_plain(a, 512, mxb.LOOP_ITERS, stores, tbl)
        return mxb.mma_loop(a, 512, mxb.LOOP_ITERS, stores, full=full,
                            b0=tbl, blocks=blocks)
    v = name[-1]
    if plain:
        return mxb.leaf_variant_plain(v, a, tbl)
    return mxb.leaf_variant(v, a, tbl, full=full, blocks=blocks)


def leaf_inputs(mxb, name, dev, seed=None):
    """The row's inputs: the tool's all-ones (seed None) or seeded random
    bf16 in [-1, 1): `a` and the variants' table at its full width, or
    for K4 rows a random initial scratch (K, 512)."""
    K, N = mxb.K_LEAF, mxb.N_LEAF
    rows = mxb.TABLE_ROWS[name[-1]] if name.startswith("leaf") else None
    if seed is None:
        return mxb.ones_inputs(K, N, dev, rows)
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(shape):
        return (torch.rand(shape, generator=g, device=dev) * 2 - 1) \
            .to(torch.bfloat16)
    if name.startswith("mma_loop"):
        return rnd((K, N)), rnd((K, 512))
    return rnd((K, N)), (rnd((rows, mxb.NCP * 512)) if rows else None)


def check_leaf(mxb, dev) -> dict:
    """Every leaf row against its plain version (exact on ones, the
    stated tolerance on random inputs, over the whole last product), the
    one-block launch bitwise equal to the tool's grid on the random
    inputs, and the plain version's ms per product.  Returns {row name:
    measurements}."""
    import torch
    out = {}
    for name, (M, K, N), _ in LEAF_ROWS:
        iters = mxb.LOOP_ITERS if name.startswith("mma") else \
            mxb.VARIANT_ITERS
        a1, t1 = leaf_inputs(mxb, name, dev)
        row, cs, _ = leaf_call(mxb, name, a1, t1, plain=False)
        prow, pcs, _ = leaf_call(mxb, name, a1, t1, plain=True)
        torch.cuda.synchronize()
        exact = bool(torch.equal(row, prow)) and cs.item() == pcs.item()
        ones_cs = pcs.item()
        a, t = leaf_inputs(mxb, name, dev, seed=17)
        row, cs, last = leaf_call(mxb, name, a, t, plain=False, full=True)
        one = leaf_call(mxb, name, a, t, plain=False, full=True, blocks=1)
        prow, pcs, plast = leaf_call(mxb, name, a, t, plain=True)
        torch.cuda.synchronize()
        same_grid = all(bool(torch.equal(x, y))
                        for x, y in zip((row, cs, last), one))
        scale = plast.abs().amax().item() + 1.0
        err = (last - plast).abs().amax().item()
        row_err = (row - prow).abs().amax().item()
        cs_err = abs(cs.item() - pcs.item())
        l1 = plast.abs().sum().item() * iters
        plain_ms = cuda_ms(lambda: leaf_call(mxb, name, a, t, plain=True)) \
            / iters
        log(f"  {name} ({M}, {K}, {N}) x {iters}: all-ones row and "
            f"checksum equal {exact} (checksum {ones_cs:.0f}); random: "
            f"max |dP| {err:.3e} (scale {scale:.2f}), max |d row| "
            f"{row_err:.3e}, |d checksum| {cs_err:.3e} (l1 {l1:.3e}); one "
            f"block equals the grid {same_grid}; plain "
            f"{plain_ms * 1e3:.1f} us a product")
        if not (exact and same_grid and err <= 1e-5 * scale and
                row_err <= 1e-5 * iters * scale and cs_err <= 1e-6 * l1 + 1e-6):
            raise AssertionError(f"{name}: the leaf kernel disagrees with "
                                 f"its plain version")
        out[name] = dict(max_abs_err=err, row_err=row_err,
                         checksum_err=cs_err, plain_ms=plain_ms)
    return out


# the anti-hoisting series: K 48, N 128, M from 128 to 2048
GUARD_M = (128, 256, 512, 1024, 2048)


def time_leaf(mxb, dev, checks) -> tuple[list, dict]:
    """The tool's main path from zero launch counts, every row on more
    than one block; then the check that nothing is dropped or hoisted.
    On the tool's grid (one 64x64 tile a block) the time per product is
    flat in M and N by design, so the M series and the N step run on a
    launch held to one block, which walks every tile: there the time must
    grow with M*N; the K steps (more wgmma a tile) must grow on the
    tool's grid.  Returns (kernels-line rows, launches)."""
    for k in mxb.LAUNCHES:
        mxb.LAUNCHES[k] = 0
    results = mxb.run_all(dev)
    launches = dict(mxb.LAUNCHES)
    log(f"  launches {launches}")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a leaf kernel never launched {launches}")
    if not all(r["blocks"] > 1 for r in results):
        raise AssertionError("a leaf row ran on one block")
    k4 = {(r["M"], r["K"], r["N"]): r["ns"] for r in results
          if r["name"] == "mma_loop"}
    one = {(m, 48, n): mxb.bench(m, 48, n, device=dev, blocks=1)["ns"]
           for m, n in [(m, 128) for m in GUARD_M] + [(512, 256)]}
    series = [one[(m, 48, 128)] for m in GUARD_M]
    grows = all(b > a for a, b in zip(series, series[1:])) and \
        one[(512, 48, 256)] > one[(512, 48, 128)] and \
        k4[(512, 128, 128)] > k4[(512, 48, 128)] > k4[(512, 16, 128)]
    log(f"  ns per product on one block, K 48 N 128, M {list(GUARD_M)}: "
        f"{[round(x, 1) for x in series]}, N 256 at M 512: "
        f"{one[(512, 48, 256)]:.1f}; on the tool's grid at (512, N 128), K "
        f"16 / 48 / 128: {k4[(512, 16, 128)]:.1f} / {k4[(512, 48, 128)]:.1f}"
        f" / {k4[(512, 128, 128)]:.1f}; grows with M*N and K {grows}")
    if not grows:
        raise AssertionError("leaf kernel time does not grow with the "
                             "product's size (dropped or hoisted work)")
    rows = []
    for name, (M, K, N), replaces in LEAF_ROWS:
        r = next(x for x in results if x["name"] == name and
                 (x["M"], x["K"], x["N"]) == (M, K, N))
        c = checks[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": "tungsten_tpu_torch/csrc/leaf_mma.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": c["max_abs_err"], "ms": r["ns"] * 1e-6,
            "plain_ms": c["plain_ms"], "bound_ms": r["bound_ns"] * 1e-6,
            "bound_by": r["bound_by"], "library_ms": r["library_ns"] * 1e-6,
            "blocks": r["blocks"], "sm_bound_ms": r["sm_bound_ns"] * 1e-6,
            "tolerance": LEAF_TOL, "shape": [M, K, N], "iters": r["iters"],
            "per": "product", "row_err": c["row_err"],
            "checksum_err": c["checksum_err"],
            "staged_bytes_per_iter": r.get("staged_bytes", 0)})
    return rows, launches


# -------------------------------------------------------- entry points

BUFFER_SPECS = [{"type": "color", "hdr_output_file": "color.pfm",
                 "sample_variance": True, "two_buffer_variance": True},
                {"type": "depth", "hdr_output_file": "depth.pfm"},
                {"type": "normal", "hdr_output_file": "normal.pfm"},
                {"type": "albedo", "hdr_output_file": "albedo.pfm"},
                {"type": "visibility", "hdr_output_file": "visibility.pfm"}]


def scene_variant(path: str, name: str, res: int | None = None,
                  **renderer) -> str:
    """The scene file at `path` with its renderer block replaced by
    `renderer` (and its resolution by `res`), written beside it."""
    with open(path) as f:
        sj = json.load(f)
    sj["renderer"] = renderer
    if res:
        sj["camera"]["resolution"] = [res, res]
    out = os.path.join(os.path.dirname(path), name)
    with open(out, "w") as f:
        json.dump(sj, f, indent=1)
    return out


def cli_run(path: str, out_dir: str, twt, res: int, spp=None) -> dict:
    """cli.render_scene on the card with the wave kernels' launch counts
    from zero; checks that the resident kernels launched and that every
    written file exists, loads, is finite and has the frame's shape."""
    import numpy as np
    from tungsten_tpu_torch import cli
    from tungsten_tpu_torch.integrators.checkpoint import (load_resume_state,
                                                           scene_hash)
    from tungsten_tpu_torch.io import image as im
    with open(path) as f:
        shash = scene_hash(json.load(f))
    args = cli.build_parser().parse_args([path, "-d", out_dir])
    args.spp = spp
    for key in twt.LAUNCHES:
        twt.LAUNCHES[key] = 0
    out = cli.render_scene(path, args)
    out["launches"] = dict(twt.LAUNCHES)
    if not (out["launches"]["closest"] > 0 and out["launches"]["anyhit"] > 0):
        raise AssertionError(f"cli: a kernel never launched {out['launches']}")
    for fn in out["files"]:
        if fn.endswith(".dat"):
            ok = load_resume_state(fn, shash) is not None
        elif fn.endswith(".png"):
            with open(fn, "rb") as f:
                ok = im.decode_png(f.read()).shape == (res, res, 3)
        else:
            img = im.load_hdr(fn)
            ok = img.shape == (res, res, 3) and bool(np.isfinite(img).all())
        if not ok:
            raise AssertionError(f"cli: {fn} missing, unreadable, not finite "
                                 f"or of the wrong shape")
    out["mrays_per_s"] = out["rays"] / max(out["seconds"], 1e-9) / 1e6
    log(f"  {os.path.basename(path)}: {out['spp']} spp, wall "
        f"{out['seconds']:.3f} s, {out['rays']} rays, "
        f"{out['mrays_per_s']:.3f} Mrays/s; launches {out['launches']}; "
        f"{len(out['files'])} files written and checked")
    return out


def images_agree(name, a, b, rtol, atol, share, mean_tol) -> None:
    """<= (1 - share) of pixels off by more than rtol/atol and the means
    within mean_tol (relative)."""
    import numpy as np
    close = np.isclose(a, b, rtol=rtol, atol=atol).all(-1).mean()
    rel = abs(a.mean() / b.mean() - 1.0)
    log(f"  {name}: {close * 100:.3f} % of pixels within rtol {rtol} / atol "
        f"{atol}, means {a.mean():.6f} vs {b.mean():.6f} ({rel:.2e})")
    if not (close >= share and rel <= mean_tol):
        raise AssertionError(f"{name}: images disagree")


def server_run(path: str) -> None:
    """The HTTP server on a free port rendering `path` in two rounds,
    then its three endpoints."""
    import socket
    import urllib.request
    from tungsten_tpu_torch import server
    from tungsten_tpu_torch.io import image as im
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.time()
    httpd = server.render_with_server([path], port=port, host="127.0.0.1")
    try:
        def get(what):
            return urllib.request.urlopen(f"http://127.0.0.1:{port}/{what}",
                                          timeout=60).read()
        st = json.loads(get("status"))
        png = get("render")
        logtxt = get("log").decode()
    finally:
        httpd.shutdown()
        httpd.server_close()
    img = im.decode_png(png)
    log(f"  server: {time.time() - t0:.2f} s; /status state {st['state']} "
        f"spp {st['current_spp']}/{st['total_spp']} n_chips {st['n_chips']} "
        f"{st['mrays_per_s']} Mrays/s; /render PNG {img.shape} max "
        f"{img.max()}; /log {logtxt.count('Completed')} rounds")
    if not (st["state"] == "done" and st["current_spp"] == st["total_spp"]
            and png[:4] == b"\x89PNG" and img.max() > 0 and
            logtxt.count("Completed") == 2 and st["rays_total"] > 0):
        raise AssertionError("server: endpoints report no finished render")


# -------------------------------------------------------------------- main

def kernel_row(name, mode, m, launches, replaces, tol, extra, prof):
    """One row of the kernels JSON line, with the route's device time in
    the profiled render (render_ms, render_by_width; None where not
    measured)."""
    row = {"name": name, "route": "cuda",
           "source": "tungsten_tpu_torch/csrc/wave_trace.cu",
           "replaces": replaces, "launches": launches[mode],
           "max_abs_err": m["max_abs_err"], "ms": m["ms"],
           "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
           "bound_by": m["bound_by"], "library_ms": None, "tolerance": tol}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
            "max_abs_err_final", "rays", "tests", "tests_run", "wrapper_ms",
            "list_walk_tests", "list_walk_agreement", "splits", "by_width",
            "paged_walk", "routes", "sparse_wave")
    row.update({x: m[x] for x in keys if x in m and x not in row})
    for k, v in extra.items():
        row[k] = {x: v[x] for x in keys if x in v}
    p = prof.get(mode)
    row["render_ms"] = p["ms"] if p else None
    row["render_by_width"] = p["by_width"] if p else None
    return row


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: the port's kernels need a GPU")
    if not os.path.isdir(os.path.join(ROOT, "tungsten_tpu_torch")):
        return fail("tungsten_tpu_torch/ is not beside this script")
    sys.path.insert(0, ROOT)
    import numpy as np
    from tungsten_tpu_torch import native
    from tungsten_tpu_torch.io import image
    from tungsten_tpu_torch.ops import wave_trace as twt
    from tungsten_tpu_torch.render import render
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.parse import load_scene
    from tungsten_tpu_torch.tools import mxubench as mxb

    t_start = time.time()
    t_mark = [t_start]

    def mark(phase: str) -> None:
        """The seconds a phase took and the run's total so far."""
        now = time.time()
        log(f"  [{phase}: {now - t_mark[0]:.1f} s, total {now - t_start:.1f}"
            f" s]")
        t_mark[0] = now

    kind = torch.cuda.get_device_name(0)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {kind}")

    # 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)

    # 2. build (both nvcc and g++ at once)
    t0 = time.time()
    with ThreadPoolExecutor(3) as ex:
        k_fut = ex.submit(twt.load_kernels)
        l_fut = ex.submit(mxb.load_kernels)
        b_fut = ex.submit(native.get_lib)
        lib = k_fut.result()
        leaf_lib = l_fut.result()
        bvh_lib = b_fut.result()
    log(f"build: {time.time() - t0:.2f} s (wave kernels {lib._name}; leaf "
        f"kernel {leaf_lib._name}; host BVH build "
        f"{'native' if bvh_lib is not None else 'numpy'})")
    for built in (lib, leaf_lib):
        with open(built._name + ".log") as f:
            for line in f.read().splitlines():
                if any(x in line for x in ("registers", "spill",
                                           "Function properties")):
                    log(f"  ptxas: {line.strip()}")
    mark("build")

    # 2b. the leaf kernels (K4, K5): checks, then the tool's main path
    dev = torch.device("cuda")
    log("leaf kernels vs plain:")
    leaf_checks = check_leaf(mxb, dev)
    log("leaf microbenchmark (tools/mxubench.py run_all):")
    leaf_rows, _ = time_leaf(mxb, dev, leaf_checks)
    mark("leaf kernels")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # 3. scene
        t0 = time.time()
        path = write_scene(tmp)
        scene, settings = flatten_scene(load_scene(path))
        torch.cuda.synchronize()
        n_tri = scene.tri_v0.shape[0]
        attr_mb = scene.wk_attr.numel() * 4 / 2**20
        log(f"scene: {n_tri} triangles, {scene.wk_cbox.shape[0]} cluster "
            f"slots, wk_attr {attr_mb:.2f} MiB, sampler "
            f"{'sobol' if settings.stratified_sampler else 'pcg4d'}, "
            f"{time.time() - t0:.2f} s")
        if not (90_000 <= n_tri <= 100_000 and
                twt.traversal_kind(scene) == "resident"):
            raise AssertionError("scene size off the resident-path range")
        mark("scene")

        # 4. kernel checks at the main path's shapes
        log("kernels vs plain walk:")
        prim, cont, shadow = check_scene_kernels(scene, settings)
        mark("kernels")

        # 5. the main path, counts from zero
        log("render:")
        scene, settings = flatten_scene(load_scene(path))
        img, stats, launches = render_counted(scene, settings, twt)
        log(f"  {settings.width}x{settings.height} {SPP} spp max_bounces "
            f"{settings.max_bounces}: {stats['time']:.3f} s, "
            f"{stats['rays']} rays, {stats['mrays_per_s']:.3f} Mrays/s on "
            f"{card}; launches {launches}")
        if not (np.isfinite(img).all() and img.mean() > 0):
            raise AssertionError("render: image not finite or black")
        if not (launches["closest"] > 0 and launches["anyhit"] > 0):
            raise AssertionError(f"render: a kernel never launched {launches}")
        img2, stats2 = render(scene, settings, spp=SPP, seed=SEED,
                              spp_chunk=SPP, return_stats=True)
        log(f"  second render: {stats2['time']:.3f} s, "
            f"{stats2['mrays_per_s']:.3f} Mrays/s; image mean {img.mean():.6f}"
            f" vs {img2.mean():.6f}")
        prof = profile_render(lambda: render(scene, settings, spp=SPP,
                                             seed=SEED, spp_chunk=SPP))
        mark("render")

        # 6. kernel path vs plain path on the CPU, small frame
        cross_path(scene, settings)
        mark("cross-path")
        del scene

        # 7. the large scene through the paged walk
        log("large scene:")
        t0 = time.time()
        zpath = write_zoo_scene(tmp)
        zscene, zsettings = flatten_scene(load_scene(zpath))
        torch.cuda.synchronize()
        z_tri = zscene.tri_v0.shape[0]
        z_mb = zscene.wk_attr.numel() * 4 / 2**20
        log(f"  (a) {z_tri} triangles, {zscene.wk_cbox.shape[0]} cluster "
            f"slots, wk_attr {z_mb:.2f} MiB, {twt.n_pages_of(zscene)} pages "
            f"of {twt.page_clusters()} clusters, walk "
            f"{twt.traversal_kind(zscene)}; bsdf types "
            f"{list(zsettings.present_bsdf_types)}; {time.time() - t0:.2f} s")
        from tungsten_tpu_torch.bsdf.types import (FORWARD_LOBE_TYPES,
                                                   PORTED_TYPES)
        if not (z_tri >= 600_000 and z_mb * 2**20 >= twt.PAGED_ATTR_BYTES and
                twt.traversal_kind(zscene) == "paged" and
                set(zsettings.present_bsdf_types) ==
                set(PORTED_TYPES) - set(FORWARD_LOBE_TYPES)):
            raise AssertionError("large scene off the paged-path range")
        mark("large scene (a)")
        log("  (b) paged kernels vs plain walk and resident kernels:")
        zprim, zcont, zshadow = check_scene_kernels(zscene, zsettings)
        mark("large scene (b)")
        log("  (c) render:")
        zimg, zstats, zlaunches = render_counted(zscene, zsettings, twt)
        log(f"  {zsettings.width}x{zsettings.height} {SPP} spp max_bounces "
            f"{zsettings.max_bounces}: {zstats['time']:.3f} s, "
            f"{zstats['rays']} rays, {zstats['mrays_per_s']:.3f} Mrays/s on "
            f"{card}; launches {zlaunches}; image mean {zimg.mean():.6f}")
        if not (np.isfinite(zimg).all() and zimg.mean() > 0):
            raise AssertionError("large render: image not finite or black")
        if not (zlaunches["paged_closest"] > 0 and
                zlaunches["paged_anyhit"] > 0 and
                zlaunches["closest"] == 0 and zlaunches["anyhit"] == 0 and
                zlaunches["paged_walk"] == 0):
            raise AssertionError(f"large render: not the paged walk alone "
                                 f"{zlaunches}")
        zprof = profile_render(lambda: render(zscene, zsettings, spp=SPP,
                                              seed=SEED, spp_chunk=SPP))
        mark("large scene (c)")
        # (d) at 16 bounces: the CPU plain walk of 606k triangles costs
        # seconds a bounce body, and glass keeps paths alive to the limit
        log("  (d)")
        cross_path(zscene, zsettings, max_bounces=ZOO_CROSS_BOUNCES)
        mark("large scene (d)")
        del zscene

        # 8. media and the forward-lobe surfaces, through K1 alone
        log("media scene:")
        t0 = time.time()
        mpath, vdb_s = write_media_scene(tmp)
        mscene, msettings = flatten_scene(load_scene(mpath))
        torch.cuda.synchronize()
        m_tri = mscene.tri_v0.shape[0]
        grid_mb = sum(g.numel() * g.element_size()
                      for g in mscene.grid_density) / 2**20
        media_mb = sum(g.numel() * g.element_size() for g in
                       mscene.grid_density + mscene.grid_super +
                       mscene.grid_emission) / 2**20
        from tungsten_tpu_torch.media.grid import (MED_HOMOGENEOUS,
                                                   MED_VOXEL)
        log(f"  (a) {m_tri} triangles, walk {twt.traversal_kind(mscene)}, "
            f"medium kinds {msettings.med_kinds}, density grid "
            f"{tuple(mscene.grid_density[0].shape)} "
            f"{grid_mb:.2f} MiB on the device ({media_mb:.2f} MiB with its "
            f"supergrid), .vdb written in {vdb_s:.2f} s, voxel integration "
            f"{msettings.voxel_integration} x {msettings.grid_steps} steps, "
            f"sampler {'sobol' if msettings.stratified_sampler else 'pcg4d'}"
            f", bsdf types {list(msettings.present_bsdf_types)}; "
            f"{time.time() - t0:.2f} s")
        if not (90_000 <= m_tri <= 100_000 and
                twt.traversal_kind(mscene) == "resident" and
                msettings.med_kinds == (MED_HOMOGENEOUS, MED_VOXEL) and
                tuple(mscene.grid_density[0].shape) ==
                (MEDIA_GRID + 2,) * 3 and
                set(FORWARD_LOBE_TYPES) <=
                set(msettings.present_bsdf_types) and
                int(mscene.cam_medium) == 0):
            raise AssertionError("media scene off its layout")
        mark("media (a)")
        log("  (b) K1 on the generalized shadow ray's first hop:")
        mhop = check_media_hop(mscene, msettings)
        mark("media (b)")
        log("  (c) render:")
        mimg, mstats, mlaunches = render_counted(mscene, msettings, twt)
        log(f"  {msettings.width}x{msettings.height} {SPP} spp max_bounces "
            f"{msettings.max_bounces}: {mstats['time']:.3f} s, "
            f"{mstats['rays']} rays, {mstats['mrays_per_s']:.3f} Mrays/s on "
            f"{card}; wave launches {mlaunches}; image mean "
            f"{mimg.mean():.6f}")
        if not (np.isfinite(mimg).all() and mimg.mean() > 0):
            raise AssertionError("media render: image not finite or black")
        if not (mlaunches["closest"] > 0 and mlaunches["anyhit"] == 0 and
                mlaunches["paged_closest"] == 0 and
                mlaunches["paged_anyhit"] == 0 and
                mlaunches["paged_walk"] == 0):
            raise AssertionError(f"media render: not K1 alone {mlaunches}")
        msum: dict = {}
        mprof = profile_render(lambda: render(mscene, msettings, spp=SPP,
                                              seed=SEED, spp_chunk=SPP),
                               summary=msum)
        log(f"  media render: {msum.get('launches')} kernel launches a "
            f"render beside {mstats['mrays_per_s']:.3f} Mrays/s")
        mark("media (c)")
        log("  (d)")
        cross_path(mscene, msettings)
        mark("media (d)")
        del mscene

        # 9. analytic prims, cap / point / sky lights, the thinlens camera
        log("outdoor scene:")
        t0 = time.time()
        opath = write_outdoor_scene(tmp)
        oscene, osettings = flatten_scene(load_scene(opath))
        torch.cuda.synchronize()
        o_tri = oscene.tri_v0.shape[0]
        from tungsten_tpu_torch.integrators.path_tracer import \
            _one_sample_mis
        log(f"  (a) {o_tri} triangles, walk {twt.traversal_kind(oscene)}; "
            f"{oscene.sph_radius.shape[0]} spheres, {oscene.dsk_r.shape[0]} "
            f"disks, {oscene.cyl_r.shape[0]} cylinders; {osettings.num_lights}"
            f" lights (caps {osettings.num_caps}, points "
            f"{osettings.has_points}), env {tuple(oscene.env_image.shape)} "
            f"baked sky; camera {osettings.camera_type} aperture bitmap "
            f"{oscene.cam_ap_hw.tolist()} focus {osettings.focus_distance:.3f}"
            f" cat eye {osettings.cat_eye}, filter {osettings.filter}; "
            f"one-sample MIS {_one_sample_mis(osettings)}; "
            f"{time.time() - t0:.2f} s")
        if not (90_000 <= o_tri <= 100_000 and
                twt.traversal_kind(oscene) == "resident" and
                osettings.num_caps == 1 and osettings.has_points and
                osettings.has_sphere_lights and osettings.has_disk_lights and
                osettings.has_cyl_lights and osettings.aperture_tex and
                osettings.camera_type == "thinlens" and
                not _one_sample_mis(osettings)):
            raise AssertionError("outdoor scene off its layout")
        mark("outdoor (a)")
        log("  (b) K1 and K2 under analytic far limits and the simple NEE:")
        ocam, oshadow, ostrat = check_outdoor_kernels(oscene, osettings)
        mark("outdoor (b)")
        log("  (c) render:")
        oimg, ostats, olaunches = render_counted(oscene, osettings, twt)
        log(f"  {osettings.width}x{osettings.height} {SPP} spp max_bounces "
            f"{osettings.max_bounces}: {ostats['time']:.3f} s, "
            f"{ostats['rays']} rays, {ostats['mrays_per_s']:.3f} Mrays/s on "
            f"{card}; wave launches {olaunches}; image mean "
            f"{oimg.mean():.6f}")
        if not (np.isfinite(oimg).all() and oimg.mean() > 0):
            raise AssertionError("outdoor render: image not finite or black")
        if not (olaunches["closest"] > 0 and olaunches["anyhit"] > 0 and
                olaunches["paged_closest"] == 0 and
                olaunches["paged_anyhit"] == 0 and
                olaunches["paged_walk"] == 0):
            raise AssertionError(f"outdoor render: not K1 and K2 "
                                 f"{olaunches}")
        osum: dict = {}
        oprof = profile_render(lambda: render(oscene, osettings, spp=SPP,
                                              seed=SEED, spp_chunk=SPP),
                               summary=osum)
        log(f"  outdoor render: {osum.get('launches')} kernel launches a "
            f"render beside {ostats['mrays_per_s']:.3f} Mrays/s")
        mark("outdoor (c)")
        log("  (d)")
        cross_path(oscene, osettings)
        cross_path(oscene, osettings, res=(32, 32),
                   camera_type="equirectangular")
        cross_path(oscene, osettings, res=(32, 24), camera_type="cubemap",
                   cubemap_mode="horizontal_cross")
        mark("outdoor (d)")
        del oscene

        # 10. the CLI at the bench size: output buffers, then adaptive
        log("cli:")
        bpath = scene_variant(path, "buffers.json", spp=SPP,
                              output_file="buffers.png",
                              hdr_output_file="buffers.pfm",
                              output_buffers=BUFFER_SPECS)
        cli_buf = cli_run(bpath, os.path.join(tmp, "cli_buffers"), twt, RES)
        buf_hdr = image.load_hdr(os.path.join(tmp, "cli_buffers",
                                              "buffers.pfm"))
        # the same 16 samples as phase 5's staged render: equal up to the
        # order of the sums (and ties the two traversal schedules break)
        images_agree("cli color buffer vs phase 5 image", buf_hdr, img,
                     1e-3, 1e-4, 0.99, 5e-3)
        apath = scene_variant(path, "adaptive.json", spp=64, spp_step=16,
                              output_file="adaptive.png",
                              hdr_output_file="adaptive.pfm")
        cli_ad = cli_run(apath, os.path.join(tmp, "cli_adaptive"), twt, RES)
        if cli_ad["spp"] != 64:
            raise AssertionError("cli: the adaptive render stopped early")
        ad_hdr = image.load_hdr(os.path.join(tmp, "cli_adaptive",
                                             "adaptive.pfm"))
        # another estimate of the same image (64 adaptive spp): the means
        images_agree("cli adaptive 64 spp vs phase 5 image (means)", ad_hdr,
                     img, 1.0, 1.0, 0.0, 0.05)
        mark("cli")

        # 11. resume: 8 spp, then continued to 16
        log("resume:")
        rpath = scene_variant(path, "resume.json", spp=SPP, spp_step=8,
                              output_file="resume.png",
                              hdr_output_file="resume.pfm",
                              enable_resume_render=True,
                              output_buffers=BUFFER_SPECS)
        rdir = os.path.join(tmp, "cli_resume")
        first = cli_run(rpath, rdir, twt, RES, spp=8)
        second = cli_run(rpath, rdir, twt, RES)
        if not (first["spp"] == 8 and second["spp"] == SPP):
            raise AssertionError("resume: wrong sample counts")
        res_hdr = image.load_hdr(os.path.join(rdir, "resume.pfm"))
        # the same rays as 10a's, summed in float64 atomics in another
        # order and traced in other waves (a tie between two triangles at
        # equal t may break another way)
        images_agree("resumed 8 + 8 spp vs uninterrupted 16 spp", res_hdr,
                     buf_hdr, 1e-4, 1e-5, 0.999, 1e-4)
        mark("resume")

        # 12. the server
        log("server:")
        server_run(scene_variant(path, "server.json", res=64, spp=8,
                                 spp_step=4))
        mark("server")

    # 13. kernels line and result
    closest_tol = ("vs plain walk: hit-set agreement > 0.998, same triangle "
                   "> 0.999, t within rtol 2e-3 on > 0.999 (the kernel's "
                   "own t and after the finalize), u/v atol 2e-3; "
                   "max_abs_err is the kernel's own t")
    anyhit_tol = ("vs plain walk: occlusion agreement > 0.998; hit set "
                  "equal to the closest-hit kernel's")
    split = ("; vs list_walk on the first 8192 rays: the result equal on "
             ">= 0.9999 of live rays, needed totals within 0.01 %; splits=1 "
             "bitwise equal to the launcher's choice and to 8; tests run <= "
             "1.5x list_walk's needed count")
    paged = ("; paged_walk (the paged any-hit walk, off the render path) "
             "on the same rays: occluded set equal to this kernel's, the "
             "list_walk, splits and tests-run gates on the paged front; "
             "routes: the paged and the resident wrapper timed in turns "
             "(median of 5 after a warm-up, range), occluded sets equal")
    media = ("; media_hop (the generalized shadow ray's first hop, near "
             "limit EPSILON per ray) under the same gates, and its "
             "full-width wave with one ray in 16 live timed (sparse_wave); "
             "media_launches: K1's launches in the media render")
    outdoor = ("; outdoor_*: the outdoor scene (analytic prims, the simple "
               "two-strategy NEE) under the same gates, far limits cut at "
               "the analytic hits; outdoor_launches / outdoor_render_ms: "
               "its render's")
    k1 = "tungsten_tpu/ops/wave_trace.py:300"
    k3 = "tungsten_tpu/ops/wave_trace.py:724"
    k1_row = kernel_row("wave_trace_closest", "closest", prim, launches, k1,
                        closest_tol + split + media + outdoor,
                        {"continuation": cont, "media_hop": mhop,
                         "outdoor_camera": ocam,
                         "outdoor_strategy": ostrat}, prof)
    k2_row = kernel_row("wave_trace_anyhit", "anyhit", shadow, launches, k1,
                        anyhit_tol + split + outdoor,
                        {"outdoor_shadow": oshadow}, prof)
    for row, mode in ((k1_row, "closest"), (k2_row, "anyhit")):
        for tag, lc, pr in (("media", mlaunches, mprof),
                            ("outdoor", olaunches, oprof)):
            if tag == "media" and mode == "anyhit":
                continue
            row[f"{tag}_launches"] = lc[mode]
            row[f"{tag}_render_ms"] = pr[mode]["ms"] if pr.get(mode) \
                else None
            row[f"{tag}_render_by_width"] = (pr[mode]["by_width"]
                                             if pr.get(mode) else None)
    k1_row["outdoor_strategy"].update(
        {k: ostrat[k] for k in ("live", "bvh_intersect_ms")})
    rows = [
        k1_row,
        k2_row,
        kernel_row("wave_trace_paged_closest", "paged_closest", zprim,
                   zlaunches, k3, closest_tol + split,
                   {"continuation": zcont}, zprof),
        kernel_row("wave_trace_paged_anyhit", "paged_anyhit", zshadow,
                   zlaunches, k3, anyhit_tol + split + paged, {}, zprof),
    ] + leaf_rows
    log(f"render_s {stats['time']:.3f} mrays_per_s "
        f"{stats['mrays_per_s']:.3f} large_render_s {zstats['time']:.3f} "
        f"large_mrays_per_s {zstats['mrays_per_s']:.3f} media_render_s "
        f"{mstats['time']:.3f} media_mrays_per_s {mstats['mrays_per_s']:.3f}"
        f" media_launches_per_render {msum.get('launches')} "
        f"media_idle {msum.get('idle')} outdoor_render_s "
        f"{ostats['time']:.3f} outdoor_mrays_per_s "
        f"{ostats['mrays_per_s']:.3f} outdoor_launches_per_render "
        f"{osum.get('launches')} outdoor_idle {osum.get('idle')} "
        f"cli_buffers_s "
        f"{cli_buf['seconds']:.3f} cli_buffers_mrays_per_s "
        f"{cli_buf['mrays_per_s']:.3f} cli_adaptive_s "
        f"{cli_ad['seconds']:.3f} cli_adaptive_mrays_per_s "
        f"{cli_ad['mrays_per_s']:.3f} total_s {time.time() - t_start:.1f}")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # any phase failing fails the run
        import traceback
        traceback.print_exc()
        sys.exit(fail(f"{type(e).__name__}: {e}"))

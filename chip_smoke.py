#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tungsten_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. card: the GPU's name and power limit, as nvidia-smi prints them;
  2. build: the CUDA wave kernels (csrc/wave_trace.cu, nvcc: the resident
     and the paged walk) and the host BVH library (g++), both compiles
     started together;
  3. scene: a deterministic lambert + mirror scene written with the
     port's IO (24 UV spheres of 64x32 segments, ~95k triangles, a
     lambert floor, one emissive quad, a procedural 512x256 sky), loaded
     with load_scene and flattened on the card;
  4. kernels: both resident kernel modes on the main path's shapes (the
     1,048,576 camera rays of the 16-spp wave, one bounce's continuation
     rays, and NEE-style shadow segments) against the plain walk on the
     same inputs, with the gates of tests/test_torch_wave.py, timed with
     CUDA events (median of 5 after a warm-up);
  5. render: the main path, load_scene -> flatten_scene -> render at
     256x256, 16 spp, max_bounces 64, with the kernels' launch counts set
     to zero just before and read just after; then a second, warm render,
     and a third under torch.profiler (device busy share, top kernels);
  6. cross-path: a 64x64 4-spp image from the kernel path against the
     port's plain path on the CPU;
  7. large scene: the same layout at production size (24 spheres of
     160x80 segments, 606,724 triangles, over 13 MiB of cluster tables,
     so it takes the paged walk) with the surface BSDF zoo (every ported
     type, glass spheres, a mixed and a coated BSDF with children, a
     null-BSDF light): (a) its size and walk; (b) both paged kernel modes
     on its camera, continuation and shadow rays against the plain walk
     and against the resident kernels on the same rays, all timed;
     (c) its full-width render (256x256, 16 spp, max_bounces 64) from
     zero launch counts, only the paged kernels launching, and one more
     under torch.profiler; (d) a 64x64 4-spp image of it against the
     plain path on the CPU;
  8. the kernels JSON line, then the result line.
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


# ---------------------------------------------------------------- timing

def cuda_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median milliseconds of fn() over `runs` runs after one warm-up,
    each bracketed by CUDA events."""
    import torch
    fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ------------------------------------------------------------ kernel checks

def kernel_inputs(scene, o, d, t_max):
    """What the dispatch hands a kernel: far limits clipped at the
    geometry box (as bvh_intersect clips them), rays sorted and padded by
    the dispatch, ray features and the resident walk's per-warp super
    lists; for a paged scene also the paged walk's (page, entry) lists,
    page list and slot ranges."""
    import torch
    from tungsten_tpu_torch.ops import intersect as tis
    from tungsten_tpu_torch.ops import wave_trace as twt
    tmin = torch.zeros((o.shape[0],), dtype=torch.float32, device=o.device)
    tmax = tis.geo_clip(scene, o, d, t_max)
    o, d, tmin, tmax, _ = tis.dispatch_rays(scene, o, d, tmin, tmax)
    f, sent, sids, _ = twt.kernel_inputs(scene, o, d, tmin, tmax)
    k = dict(o=o, d=d, tmin=tmin, tmax=tmax, f=f, sent=sent, sids=sids,
             paged=twt.traversal_kind(scene) == "paged")
    if k["paged"]:
        _, k["psent"], k["psids"], k["pages"], k["offs"], k["offe"], _ = \
            twt.paged_kernel_inputs(scene, o, d, tmin, tmax)
    return k


def launch(scene, k, any_hit: bool, resident: bool = False):
    """One raw launch of the scene's kernel (the resident one when asked):
    (t, tri cluster*128+slot, tests)."""
    from tungsten_tpu_torch.ops import wave_trace as twt
    if k["paged"] and not resident:
        return twt.paged_kernel(k["f"], k["psent"], k["psids"], k["pages"],
                                k["offs"], k["offe"], scene.wk_cbox,
                                scene.wk_attr, any_hit)
    return twt.wave_kernel(k["f"], k["sent"], k["sids"], scene.wk_cbox,
                           scene.wk_attr, any_hit)


def wrapper(scene, k, any_hit: bool):
    """The scene's wrapper (front, kernel, remap, finalize)."""
    from tungsten_tpu_torch.ops import wave_trace as twt
    fn = twt.wave_intersect_paged if k["paged"] else twt.wave_intersect
    return fn(scene, k["o"], k["d"], k["tmin"], k["tmax"], any_hit=any_hit)


def bound_ms(scene, k, tests: int) -> tuple[float, str]:
    """Least time for the launch: its input and output bytes over the HBM
    rate vs the ray-triangle tests this data needs over the f32 rate."""
    from tungsten_tpu_torch.ops import wave_trace as twt
    ins = [k["f"], scene.wk_cbox, scene.wk_attr]
    ins += [k[n] for n in (("psent", "psids", "pages", "offs", "offe")
                           if k["paged"] else ("sent", "sids"))]
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


def vs_resident(scene, name, k, any_hit: bool, t3, tri3) -> dict:
    """A paged launch against the resident kernel on the very same rays:
    the hit set equal, and the winning slot equal wherever the two t
    differ (equal t are ties the two walk orders may break apart).
    Returns the resident kernel's ms and the tests it needed and ran on
    these rays: a walk's needed count depends on its order (a super
    reached later is culled against a worse best t), so the bound takes
    the smaller of the two walks' counts."""
    import torch
    t1, tri1, tests1 = launch(scene, k, any_hit, resident=True)
    torch.cuda.synchronize()
    same_hits = bool(torch.equal(tri3 >= 0, tri1 >= 0))
    ties = int(((tri3 != tri1) & (t3 == t1)).sum())
    slots_ok = bool(((tri3 == tri1) | (t3 == t1)).all())
    log(f"  {name}: paged vs resident kernel on the same rays: hit set "
        f"equal {same_hits}, winning slot equal except at t ties "
        f"{slots_ok} ({ties} ties)")
    if not (same_hits and (any_hit or slots_ok)):
        raise AssertionError(f"{name}: the paged and resident kernels "
                             f"disagree")
    needed, ran = tri_test_counts(tests1)
    return {"resident_ms": cuda_ms(lambda: launch(scene, k, any_hit,
                                                  resident=True)),
            "resident_tests": needed, "resident_tests_run": ran}


def tri_test_counts(tests) -> tuple[int, int]:
    """(tests the data needs, tests the threads ran) of one launch."""
    import torch
    return (int(tests[0].sum(dtype=torch.int64)),
            int(tests[1].sum(dtype=torch.int64)))


def check_closest(scene, name, o, d, t_max):
    """The scene's closest-hit kernel on one ray set: gates against the
    plain walk (and, on a paged scene, against the resident kernel), and
    times."""
    import torch
    from tungsten_tpu_torch.ops import intersect as tis
    k = kernel_inputs(scene, o, d, t_max)
    live = k["tmax"] > 0
    t, tri, u, v = wrapper(scene, k, False)
    pt, ptri, pu, pv = tis.bvh_walk(scene, k["o"], k["d"], k["tmin"],
                                    k["tmax"])
    torch.cuda.synchronize()
    err_final = hit_gates(name, t, tri, u, v, pt, ptri, pu, pv, live)
    t_raw, tri_raw, tests = launch(scene, k, False)
    err = raw_t_error(scene, name, t_raw, tri_raw, pt, ptri, live)
    out = {}
    if k["paged"]:
        out = vs_resident(scene, name, k, False, t_raw, tri_raw)
    ms = cuda_ms(lambda: launch(scene, k, False))
    wrap_ms = cuda_ms(lambda: wrapper(scene, k, False))
    plain_ms = cuda_ms(lambda: tis.bvh_walk(scene, k["o"], k["d"], k["tmin"],
                                            k["tmax"]))
    n_tests, n_ran = tri_test_counts(tests)
    b, by = bound_ms(scene, k, min(n_tests, out.get("resident_tests",
                                                     n_tests)))
    hit_share = (tri >= 0).float().mean().item()
    log(f"  {name}: {o.shape[0]} rays ({int(live.sum())} live, hit share "
        f"{hit_share:.4f}), {n_tests} ray-triangle tests needed, {n_ran} run"
        f"; kernel {ms:.3f} ms"
        + (f" (resident kernel {out['resident_ms']:.3f} ms, "
           f"{out['resident_tests']} tests needed, "
           f"{out['resident_tests_run']} run)" if out else "")
        + f", wrapper (front + kernel + finalize) {wrap_ms:.3f} ms, plain "
        f"walk {plain_ms:.3f} ms, bound {b:.4f} ms ({by})")
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
    """The scene's any-hit kernel on shadow segments: against the plain
    any-hit walk, its hit set against the closest-hit kernel's on the very
    same segments (and, on a paged scene, the resident any-hit kernel's);
    times."""
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
    t_raw, tri_raw, tests = launch(scene, k, True)
    out = {}
    if k["paged"]:
        out = vs_resident(scene, "shadow segments", k, True, t_raw,
                          tri_raw)
    ms = cuda_ms(lambda: launch(scene, k, True))
    wrap_ms = cuda_ms(lambda: wrapper(scene, k, True))
    plain_ms = cuda_ms(lambda: tis.bvh_walk(scene, k["o"], k["d"], k["tmin"],
                                            k["tmax"], any_hit=True))
    n_tests, n_ran = tri_test_counts(tests)
    b, by = bound_ms(scene, k, min(n_tests, out.get("resident_tests",
                                                     n_tests)))
    log(f"  shadow segments: {n_tests} ray-triangle tests needed, {n_ran} "
        f"run; kernel {ms:.3f} ms"
        + (f" (resident kernel {out['resident_ms']:.3f} ms, "
           f"{out['resident_tests']} tests needed, "
           f"{out['resident_tests_run']} run)" if out else "")
        + f", wrapper {wrap_ms:.3f} ms, plain walk {plain_ms:.3f} ms, bound "
        f"{b:.4f} ms ({by})")
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


def render_counted(scene, settings, twt):
    """The main path with every launch count set to 0 just before and
    read just after: (image, stats, launches)."""
    from tungsten_tpu_torch.render import render
    for key in twt.LAUNCHES:
        twt.LAUNCHES[key] = 0
    img, stats = render(scene, settings, spp=SPP, seed=SEED, spp_chunk=SPP,
                        return_stats=True)
    return img, stats, dict(twt.LAUNCHES)


def cross_path(scene, settings, max_bounces: int | None = None) -> None:
    """A 64x64 4-spp image from the kernel path against the port's plain
    path on the CPU (the gates: <= 1 % of pixels off by more than
    rtol 1e-3 / atol 1e-4, means within 0.5 %), at the scene's bounce
    limit or at `max_bounces`."""
    import numpy as np
    from tungsten_tpu_torch.render import render
    small = replace(settings, width=64, height=64,
                    max_bounces=max_bounces or settings.max_bounces)
    t0 = time.time()
    gpu = render(scene, small, spp=4, seed=SEED, spp_chunk=4)
    cpu = render(scene.to("cpu"), small, spp=4, seed=SEED, spp_chunk=4,
                 device="cpu")
    close = np.isclose(gpu, cpu, rtol=1e-3, atol=1e-4).all(-1)
    off = 1.0 - close.mean()
    rel_mean = abs(gpu.mean() / cpu.mean() - 1.0)
    log(f"cross-path 64x64 4 spp max_bounces {small.max_bounces}: "
        f"{off * 100:.3f}% of pixels off by more "
        f"than rtol 1e-3 (atol 1e-4), mean {gpu.mean():.6f} vs "
        f"{cpu.mean():.6f} ({rel_mean * 100:.4f}%), {time.time() - t0:.1f}"
        f" s")
    if not (off <= 0.01 and rel_mean <= 0.005):
        raise AssertionError("cross-path image check failed")


def profile_render(render_once) -> None:
    """One more render under torch.profiler (device activity only): device
    busy time (the union of kernel intervals) against the profiled wall
    time, and the kernels that take the most device time.  The profiler's
    own host cost is in the wall time, so the idle share is an upper
    bound.  The raw device events are read directly: the profiler's
    per-event Python parse takes minutes at a million launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_once()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [(e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]
    if not kern:
        log("profile: the profiler recorded no device activity (device "
            "busy share not measured)")
        return
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
    log(f"profile: wall {wall_us / 1e3:.1f} ms under the profiler, device "
        f"busy {busy / 1e3:.1f} ms ({busy / wall_us * 100:.1f} %, idle "
        f"{100 - busy / wall_us * 100:.1f} %), {launches} kernel launches; "
        f"wave kernels {wave / 1e3:.1f} ms ({wave / total * 100:.1f} % of "
        f"kernel time)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (us, n) in top:
        log(f"  {us / 1e3:9.2f} ms {n:6d}x {us / total * 100:5.1f} %  "
            f"{name[:90]}")


# -------------------------------------------------------------------- main

def kernel_row(name, mode, m, launches, replaces, tol, extra):
    """One row of the kernels JSON line."""
    row = {"name": name, "route": "cuda",
           "source": "tungsten_tpu_torch/csrc/wave_trace.cu",
           "replaces": replaces, "launches": launches[mode],
           "max_abs_err": m["max_abs_err"], "ms": m["ms"],
           "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
           "bound_by": m["bound_by"], "library_ms": None, "tolerance": tol}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
            "max_abs_err_final", "rays", "tests", "tests_run", "wrapper_ms",
            "resident_ms", "resident_tests", "resident_tests_run")
    row.update({x: m[x] for x in keys if x in m and x not in row})
    for k, v in extra.items():
        row[k] = {x: v[x] for x in keys if x in v}
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
    from tungsten_tpu_torch.ops import wave_trace as twt
    from tungsten_tpu_torch.render import render
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.parse import load_scene

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

    # 2. build (nvcc and g++ at once)
    t0 = time.time()
    with ThreadPoolExecutor(2) as ex:
        k_fut = ex.submit(twt.load_kernels)
        b_fut = ex.submit(native.get_lib)
        lib = k_fut.result()
        bvh_lib = b_fut.result()
    log(f"build: {time.time() - t0:.2f} s (wave kernels {lib._name}; host "
        f"BVH build {'native' if bvh_lib is not None else 'numpy'})")
    with open(lib._name + ".log") as f:
        for line in f.read().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    mark("build")

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
        profile_render(lambda: render(scene, settings, spp=SPP, seed=SEED,
                                      spp_chunk=SPP))
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
        from tungsten_tpu_torch.bsdf.types import PORTED_TYPES
        if not (z_tri >= 600_000 and z_mb * 2**20 >= twt.PAGED_ATTR_BYTES and
                twt.traversal_kind(zscene) == "paged" and
                set(zsettings.present_bsdf_types) == set(PORTED_TYPES)):
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
                zlaunches["closest"] == 0 and zlaunches["anyhit"] == 0):
            raise AssertionError(f"large render: not the paged walk alone "
                                 f"{zlaunches}")
        profile_render(lambda: render(zscene, zsettings, spp=SPP, seed=SEED,
                                      spp_chunk=SPP))
        mark("large scene (c)")
        # (d) at 16 bounces: the CPU plain walk of 606k triangles costs
        # seconds a bounce body, and glass keeps paths alive to the limit
        log("  (d)")
        cross_path(zscene, zsettings, max_bounces=ZOO_CROSS_BOUNCES)
        mark("large scene (d)")

    # 8. kernels line and result
    closest_tol = ("vs plain walk: hit-set agreement > 0.998, same triangle "
                   "> 0.999, t within rtol 2e-3 on > 0.999 (the kernel's "
                   "own t and after the finalize), u/v atol 2e-3; "
                   "max_abs_err is the kernel's own t")
    anyhit_tol = ("vs plain walk: occlusion agreement > 0.998; hit set "
                  "equal to the closest-hit kernel's")
    paged = ("; vs the resident kernel on the same rays: hit set equal, "
             "winning slot equal except at equal t")
    k1 = "tungsten_tpu/ops/wave_trace.py:300"
    k3 = "tungsten_tpu/ops/wave_trace.py:724"
    rows = [
        kernel_row("wave_trace_closest", "closest", prim, launches, k1,
                   closest_tol, {"continuation": cont}),
        kernel_row("wave_trace_anyhit", "anyhit", shadow, launches, k1,
                   anyhit_tol, {}),
        kernel_row("wave_trace_paged_closest", "paged_closest", zprim,
                   zlaunches, k3, closest_tol + paged,
                   {"continuation": zcont}),
        kernel_row("wave_trace_paged_anyhit", "paged_anyhit", zshadow,
                   zlaunches, k3, anyhit_tol + paged, {}),
    ]
    log(f"render_s {stats['time']:.3f} mrays_per_s "
        f"{stats['mrays_per_s']:.3f} large_render_s {zstats['time']:.3f} "
        f"large_mrays_per_s {zstats['mrays_per_s']:.3f} total_s "
        f"{time.time() - t_start:.1f}")
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

#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tungsten_tpu_torch) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase 2c   # phases 1, 2 (S1 alone) and 2c

Phases (any failure exits non-zero):
  1. card: the GPU's name and power limit, as nvidia-smi prints them;
  2. build: the CUDA wave kernels (csrc/wave_trace.cu, nvcc: the
     closest-hit, resident any-hit and paged any-hit kernels), the
     tensor-core leaf kernel (csrc/leaf_mma.cu, nvcc), the curve-piece
     walk C1 (csrc/curve_trace.cu, nvcc), the ordered sums S1
     (csrc/segment_sum.cu, nvcc) and the host BVH library (g++), the
     five compiles started together (the host library holds the OBJ
     parser too, native/objloader.cpp);
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
  2c. ordered sums: S1 (ops/segment_sum.py::ordered_index_add) on
     seeded inputs against its plain version run on the CPU, bitwise:
     the bank's shape (1,048,576 f32 rows x 3, 16 a pixel, shuffled and
     keyed by (pixel, sample)), f64 tile sums on unsorted ids, sorted ids
     with most outputs empty and one 200,000-row segment (f32 and f64),
     unique unsorted lanes; each case S1 alone, with its sort,
     index_add_ on the same card tensors (the library column), its bytes
     bound and the plain version's CPU time; the scan entry
     (ordered_cumsum) bitwise torch.cumsum on the CPU at choose_light's,
     the MLT pool's and a raymarch's shapes, f32 and f64, and at
     choose_light's past 256 lights (1,048,576 rows of 300, f32), left
     to right and right to left, its backward too, timed against
     torch.cumsum on the card and its bytes bound, the MLT pool's shape
     on a narrow-span input (the long path's exact parallel scan) and a
     wide-span one (its refold in order), the path each chunk took
     counted.  Every time is device ms a call (device_ms: 20 calls
     queued behind a spin kernel between two CUDA events, median of 5);
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
     timed with CUDA events (median of 5 after a warm-up; the plain
     walk once, after the comparison's call), also on the
     first 1,024, 4,096, 8,192 and 65,536 rays and on a sparse tail wave
     (4,096 rays, the first 256 live), at splits=1 and at the launcher's
     choice;
  5. render: the main path, load_scene -> flatten_scene -> render at
     256x256, 16 spp, max_bounces 64, with the kernels' launch counts set
     to zero just before and read just after (S1 and its scan launched);
     then a second, warm render, bitwise the first, and a third under
     torch.profiler, bitwise too (device busy share, top kernels, each
     traversal kernel's launches and device ms by rays a launch, S1's
     device ms); then the ordered sums of one more render (the banks'
     index_sums and choose_light's scans) captured and replayed against
     index_add_ and torch.cumsum on the same inputs: the added device ms
     at most 3 % of the render's wall;
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
     its full-width render (256x256, 16 spp, cut to max_bounces 8) from
     zero launch counts, only the paged route launching, and one more
     under torch.profiler, as in phase 5; (d) a 64x64 4-spp image of it
     at 4 bounces against the plain path on the CPU;
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
     16 spp, cut to max_bounces 8) from zero launch counts (K1 alone
     launches:
     the two-strategy NEE traces closest hits only), then one more under
     torch.profiler (launches per render, device busy share, K1's device
     ms by launch width); (d) a 64x64 4-spp image at 4 bounces against
     the plain path on the CPU, with phase 6's gates;
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
     (horizontal_cross) at 32x24, 4 spp and 4 bounces each;
  10. hair: (a) a groom of 16,384 seeded random-walk strands of 24 nodes
     in bcsdf_cylinder mode with the hair BCSDF (melanin ratio 1.0,
     concentration 1.3, roughness 0.3, scale angle 2.5), 2,048 ribbon
     strands with rough_wire and 1,024 half_cylinder strands with
     lambertian_fiber (curve files written with the port's io/curves.py:
     .fiber, .hair), an `instances` primitive stamping a 16x8 UV-sphere
     mesh 64 times, a lambert floor, an area light and an
     infinite_sphere_cap sun (the simple two-strategy NEE); its strand,
     segment, piece and node counts, the curve tables' MiB on the card
     and the host flatten seconds; the wide piece BVH's node count, MiB,
     the seconds its collapse adds to the flatten and the most stack
     entries its walk could hold;
     (b) the curve-piece walk C1
     (ops/curve_trace.py) against the plain curve walk on the first
     65,536 rays of the camera rays (far limits from K1 and the analytic
     test, as bvh_intersect forms them), body 1's shadow segments (any
     hit) and body 2's continuation rays: hit set and segment equal on
     >= 0.9999, t within rtol 1e-5 / atol 1e-6; 1, 2 and 4 lanes a ray
     and a 16-entry stack (restarts forced) bitwise equal to the
     launcher's choice on each whole set and on 1,024 of its rays; node
     visits (total; mean, p99 and max a live ray), child boxes and pieces
     tested, stack spills and restarts, the distinct rows read and the
     bound; times at full width and on 1,024
     and 65,536 rays, the plain walk's, bvh_intersect's; (c) the
     full-width render (256x256, 16 spp, cut to max_bounces 8) from zero
     launch counts, C1 (both modes), K1 and K2 all launching, then one
     more under torch.profiler (launches per render, device busy share,
     C1's device ms by launch width); (d) the scene cut to 256 + 32 + 16
     strands at 32x32, 4 spp, 8 bounces against the plain path on the
     CPU with phase 6's gates;
  11. the CLI (cli.render_scene) on the smoke scene at 256x256: (a) with
     the output buffers (color with sample variance and A/B halves,
     depth, normal, albedo, visibility) at 16 spp, its color held
     against phase 5's image of the same samples; (b) with adaptive
     sampling at 64 spp, spp_step 16 (render_adaptive); launch counts
     from zero for each, every written file loaded and checked;
  12. resume: the buffers render to 8 spp with enable_resume_render,
     then continued to 16, against 11a's uninterrupted 16-spp image
     (within a tolerance: other waves, another association of the
     float64 sums; phase 20 holds a resumed render against itself
     bitwise);
  13. the HTTP server on a free port rendering the smoke scene at 64x64
     in two rounds: /status, /render (PNG) and /log;
  14. replay: path-replay gradients (trace_wave_replay) of the smoke
     scene's mean radiance w.r.t. tex_const, light_emission and
     bsdf_params: (a) one 1,048,576-ray wave (256x256, 16 spp),
     max_bounces 64, forward and backward each timed from zero launch
     counts (K1 and K2 launch in both), every gradient finite, the
     backward's final re-traced emission equal to the forward's L
     bitwise; (b) the peak device memory at max_bounces 8 and 64 within
     1.25x of each other; then the replay once more with each pass under
     torch.profiler (device busy share, launches, top kernels), its L and
     gradients bitwise (a)'s; (c) at
     64x64, 4 spp, 8 bounces the card's
     gradients against the plain path's on the CPU, on the smoke scene
     and on a box with rough_conductor, rough_plastic and oren_nayar
     walls, where every parameter's gradient must be nonzero; (d) central
     differences of two card renders on the largest albedo entry and
     the largest light emission entry, within 5e-2;
  15. data-parallel (parallel/): (a) a one-rank NCCL group at 128x128,
     2 spp: render_pass_sharded bitwise equal to the per-sample
     trace_wave sum, render_pass_sharded_staged (rebalance_wave between
     segments) within rtol 1e-5 / atol 1e-6 of it, train_step_sharded's
     loss and gradients those of the replay on the same pixels; (b) two
     spawned ranks sharing the card over gloo: the image bitwise equal
     to (a)'s, the staged render and the gradients within the stated
     tolerances;
  16. bdpt and light tracer: (a) the smoke scene under
     bidirectional_path_tracer, 256x256, 16 spp, max_bounces 64,
     bdpt_vertices 8, in one 1,048,576-lane wave from zero launch counts
     (K1 and K2 launching: walks and lens rays on K1, connections on
     K2): rays, wall seconds, Mrays/s, peak device memory; then one more
     render under torch.profiler (launches per render, device busy
     share, K2's share of kernel time, top kernels); the image finite
     and its mean within 5 % of phase 5's path-tracer image; (b) the
     same under light_tracer, its splat sum > 0; (c) both at 64x64, 4
     spp, max_bounces 4 against the plain path on the CPU with phase 6's
     gates; (d) phase 8's media scene under BDPT likewise at
     max_bounces 2, K1 alone launching; (e) cli.render_scene on the
     smoke scene under BDPT at
     64x64, 16 spp with the output buffers: every file written loads,
     the feature and color buffers are the 8-spp path-traced post-pass's;
  17. photon maps: (a) the smoke scene without its sky (the quad light
     alone, so every light emits photons) under photon_map, 256x256, 16
     spp, max_bounces 64, photon_count 1,048,576, gather_photon_count 20,
     gather_radius 0.1, from zero launch counts (K1 alone): rays, wall,
     Mrays/s, paths and deposits a round, the wall split into photon
     pass, grid and camera pass (CUDA events), peak device memory (under
     16 GiB); one more render under torch.profiler with marker kernels
     around the stages (launches a render, device busy share, top
     kernels, device ms by stage, the grid builds' and gathers' share);
     the path tracer's image of the same scene and the photon image's
     mean over it; (b) the same under progressive_photon_map (alpha
     0.3, 16 iterations); (c) phase 8's layout with its homogeneous fog
     alone (no voxel cube, no sky; the light's and the surfaces' exterior
     medium the fog; volume gather radius 0.5) under the points, beams
     and planes volume maps at 4 spp and max_bounces 8, each as (a)
     (K1 launching, and K2
     in planes mode for the planes' shadow rays); phase 8's voxel scene
     asked for beams calls the points estimator's functions and no beam
     grid; (d) at 64x64, 4 spp, max_bounces 8: the first 16,384 photon
     paths of the surface scene and of the fog in planes mode traced on
     the card and on the CPU (flags equal on >= 0.999 of slots, the
     positions, directions, powers and beam and plane fields within
     rtol 1e-5 / atol 1e-6 on >= 0.95 and rtol 1e-3 / atol 1e-4 on >=
     0.995 of the slots valid on both), and
     the surface map, PPM and the three volume maps (the volume maps at
     32x32; 65,536 photon paths a round, volume_photon_count 2,000 as in
     tests/test_photon_volume.py)
     gathered on the card and on the CPU from the same photon
     lists with phase 6's gates (the three volume maps share the CPU's
     camera walk, which does not depend on the volume map), each card
     render twice, bitwise;
     (e) cli.render_scene of (a)'s scene at 64x64 with the output buffers
     (every file loaded), and one server /render of it;
  18. MLT (max_bounces 8, the smoke scene's sky and quad light, the
     uniform sampler the MLT integrators latch): (a) kelemen_mlt on its
     default bidirectional tape through render() at 256x256 with 8,192
     chains, a 10,000-sample bootstrap pool and 1 mutation a pixel (8
     steps), from zero launch and MLT counts (K1 and K2): wall, steps,
     tape traces, accepted proposals, Mrays/s by the JAX estimate beside
     the rays traced, launches, peak device memory, the image finite with
     its mean within 10 % of the path tracer's at the same bounces; the
     render once more under torch.profiler (launches a render, device
     busy share), bitwise the first; (b)-(d) profile one Metropolis step instead; (b) the
     same on the path tracer's tape ("bidirectional": false); (c)
     multiplexed_mlt likewise on the bidirectional tape, whose lengths
     miss the camera's direct view of an emitter (ROADMAP C-ref 9), so
     its mean is held to 0.905 +- 0.02 of the path tracer's (what the
     card measured), and one pass on the path tracer's tape at 64x64
     (the path-length restriction: b_k and steps by length, the mean
     within 10 % of the path tracer's); (d) reversible_jump_mlt
     likewise, with the share of technique exchanges proposed and of
     those whose inversions held; (e) the card against the CPU plain
     path at 4 bounces: trace_tape and trace_tape_rj of 8,192 chains (a
     wave the body sorts and the staged loop compacts, as the traversal
     launches' widths show) lane for lane (radiance within rtol 1e-4 /
     atol 1e-6, the rj flags equal, rj_dims / rj_nee within rtol 1e-4 /
     atol 1e-5, each on >= 0.999 of lanes), and kelemen_mlt at 64x64
     with 2,048 chains (one bootstrap batch, 5 subpath vertices): the
     bootstrap pool's luminances (rtol 1e-4 on >= 0.999) and b (rtol
     1e-4), the first step's proposal luminance and acceptance from the
     same chain states (>= 0.99 of chains), the share of chains in the
     same state after the last step (printed) and the images' means
     (within 2 %); (f) cli.render_scene of the smoke scene under
     kelemen_mlt at 64x64, 4 spp (a 4,096-sample pool) with the output
     buffers (every file loaded), and one server /render of it; each
     part's seconds printed; (g) every ordered scan of (a)-(f) counted
     (ScanCensus): its rows, length and path, and the long path's chunks
     taken exact and refolded;
  18b. denoiser: tools/denoiser.py::nfor_denoise on the card on the
     smoke scene's two-buffer outputs (256x256, 16 spp), the result
     finite and non-negative, its box filters' scans counted as in 18(g);
  19. OBJ meshes: (a) the smoke scene written again with its 24
     spheres as OBJ files in exporter style (each triangle's corners as
     v / vt / vn lines just before `f -3/-3/-3 -2/-2/-2 -1/-1/-1`, every
     float as repr of its f32 value); (b) every file through the native
     loader (native/objloader.cpp) and the Python parser
     (io/mesh.py::load_obj_python): the two Meshes bitwise equal, each
     triangle's corners the .wo3 mesh's, both loaders' host seconds;
     (c) load_scene -> flatten_scene on the card: 95,236 triangles, every
     FlatScene field (triangle tables, BVH, cluster tables) and the
     settings equal to phase 3's .wo3 scene's; (d) the main path's render
     (256x256, 16 spp, 64 bounces) from zero launch counts: K1's and K2's
     launches phase 5's, the image bitwise phase 5's, and the wave's
     1,048,576 lanes traced on both scenes bitwise equal too; (e)
     cli.render_scene of the OBJ scene at 64x64, 4 spp with the output
     buffers (every file loaded) and one server /render of it;
  20. repeat renders, each twice on the card, bitwise: at 64x64 BDPT and
     the light tracer (4 spp, 4 bounces), the output buffers' raw
     float64 sums (4 spp) and a render resumed from its 2-spp sums to 4
     spp; at 32x32 kelemen_mlt on the path tracer's tape, multiplexed_mlt
     and reversible_jump_mlt (1 mutation a pixel, 1,024 chains, a
     1,024-sample pool, 4 bounces; kelemen on its bidirectional tape
     repeats in phase 18(a)) and adaptive sampling (24 spp);
  21. wide frame: the main path at 1000x563 (3 pixel chunks x 4 sample
     batches, 12 waves), 16 spp, 64 bounces, twice from zero launch
     counts: the two frames bitwise equal, finite, the mean within 2 % of
     phase 5's frame's over the rows of phase 5's view that it sees (the
     pinhole's field of view spans the frame's width), rays, Mrays/s and
     peak device memory; then S1 on the largest photon-gather launch of
     phase 17's fog points render, captured (its ids and values), and at
     its shape on seeded uniform ids: bitwise the plain version, timed
     against index_add_;
  22. the kernels JSON line (twelve rows: K1, K2, K3 closest and any
     hit, the five leaf rows, C1, S1's segment sum and its scan; K1's
     and K2's with their launches in the replay's forward and backward,
     in the BDPT and light-tracer renders, in the photon-map renders, in
     the MLT renders and in the OBJ scene's render; S1's with its
     launches in phase 5's render, its device ms there and the added
     cost), then the result line.  A
     bitwise check that failed is reported when it happens and fails the
     run here, after every phase has printed.
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
# the depths the run is cut to, so that it ends well inside its time
# limit: the large, media and hair scenes' renders (their paths live to
# the limit: 1.6M, 466k and 420k launches a render at 64 bounces, and
# the profiler's stop takes tens of microseconds a launch) and the
# cross-paths,
# whose CPU side is mostly the plain walk's per-step overhead (seconds a
# walk, whatever the frame size); the zoo, media and hair renders and the
# zoo and outdoor cross-paths halved again when phases 20-21 came (the
# repeat renders and the 12-wave frame)
ZOO_BOUNCES = 8
ZOO_CROSS_BOUNCES = 4
MEDIA_BOUNCES = 8
HAIR_BOUNCES = 8
MEDIA_CROSS_BOUNCES = 4
OUTDOOR_CROSS_BOUNCES = 4
SKY_W, SKY_H = 512, 256
MEDIA_GRID = 256      # the voxel medium's density grid, 256^3 f32
# the hair scene: the groom's strands and nodes a strand, the ribbon and
# half-cylinder strands, the instanced spheres; its cross-path copy's
# strands (groom, ribbon, half-cylinder) and bounces
HAIR_STRANDS, HAIR_NODES = 16384, 24
HAIR_RIBBONS, HAIR_HALF, HAIR_SPHERES = 2048, 1024, 64
HAIR_CROSS = (256, 32, 16)
HAIR_CROSS_BOUNCES = 8
C1_CHECK = 65536      # rays of each set held against the plain curve walk
C1_NARROW = 4096      # where the 1,024-ray slice of the lanes check starts
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s outside the
# tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
TIMED_RUNS = 5
# torch.cuda._sleep's kernel: phase 17's stage markers in the profile,
# after SENTINELS of them that open it
MARKER = "spin_kernel"
SENTINELS = 64


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


def exporter_obj(pos, nrm, uv, idx) -> str:
    """A mesh as OBJ exporters write one: each triangle's three corners as
    v / vt / vn lines just before `f -3/-3/-3 -2/-2/-2 -1/-1/-1`, every
    float as repr of its f32 value, so that a loader reads it back
    exactly."""
    out = []
    for tri in idx.tolist():
        for arr, tag in ((pos, "v"), (uv, "vt"), (nrm, "vn")):
            rows = arr[tri].tolist()
            out += [tag + " " + " ".join(map(repr, r)) for r in rows]
        out.append("f -3/-3/-3 -2/-2/-2 -1/-1/-1")
    return "\n".join(out) + "\n"


def write_scene(dirpath: str, res: int = RES, spp: int = SPP,
                grid=(GRID_X, GRID_Z), seg=(SEG_U, SEG_V),
                sky=(SKY_W, SKY_H), mesh_ext: str = "wo3") -> str:
    """Write the smoke scene (meshes, sky, scene.json); returns its path.
    `mesh_ext` "obj" writes the spheres as exporter-style OBJ files."""
    import numpy as np
    from tungsten_tpu_torch.io import mesh
    pos, nrm, uv, idx = uv_sphere(*seg)
    m = mesh.Mesh(pos=pos, normal=nrm, uv=uv, indices=idx,
                  material=np.zeros(len(idx), np.int32))
    obj_text = exporter_obj(pos, nrm, uv, idx) if mesh_ext == "obj" else None
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
            if obj_text is None:
                mesh.save_wo3(os.path.join(dirpath, name + ".wo3"), m)
            else:
                with open(os.path.join(dirpath, name + ".obj"), "w") as f:
                    f.write(obj_text)
            if (i + j) % 2:
                bsdf = "mirror"
            else:
                bsdf = name
                bsdfs.append({"name": name, "type": "lambert", "albedo": [
                    0.25 + 0.6 * i / max(gx - 1, 1), 0.7,
                    0.25 + 0.6 * j / max(gz - 1, 1)]})
            prims.append({"type": "mesh", "file": f"{name}.{mesh_ext}",
                          "bsdf": bsdf, "smooth": True,
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


def write_replay_box(dirpath: str, res: int) -> str:
    """Write phase 14(c)'s second scene, whose loss depends on every
    replay parameter: a box of lambert walls, a back wall with an 8x8
    bitmap albedo, a rough_conductor block, a rough_plastic wall and an
    oren_nayar wall at roughness 1.0 (on its clip) under a quad light
    (tests/test_torch_replay.py's box)."""
    import numpy as np
    from tungsten_tpu_torch.io import image
    tex = np.full((8, 8, 3), 0.4, np.float32)
    tex[2:6, 2:6] = [0.8, 0.3, 0.2]
    image.save_hdr(os.path.join(dirpath, "box_wall.pfm"), tex)

    def quad(bsdf, pos, scale, rot=(0, 0, 0), **kw):
        return dict(type="quad", bsdf=bsdf, transform=dict(
            position=list(pos), scale=scale, rotation=list(rot)), **kw)
    bsdfs = [{"name": "white", "type": "lambert", "albedo": [0.7, 0.7, 0.7]},
             {"name": "wall", "type": "lambert", "albedo": "box_wall.pfm"},
             {"name": "copper", "type": "rough_conductor", "material": "Cu",
              "roughness": 0.3, "distribution": "ggx"},
             {"name": "plastic", "type": "rough_plastic",
              "albedo": [0.7, 0.2, 0.2], "roughness": 0.2},
             {"name": "oren", "type": "oren_nayar",
              "albedo": [0.3, 0.6, 0.3], "roughness": 1.0}]
    prims = [quad("white", (0, 0, 0), [4, 1, 4]),
             quad("white", (0, 3, 0), [4, 1, 4], (0, 0, 180)),
             quad("wall", (0, 1.5, -2), [4, 1, 3], (90, 0, 0)),
             quad("plastic", (-2, 1.5, 0), [3, 1, 4], (0, 0, -90)),
             quad("oren", (2, 1.5, 0), [3, 1, 4], (0, 0, 90)),
             {"type": "cube", "bsdf": "copper",
              "transform": {"position": [0.4, 0.5, -0.5],
                            "scale": [0.8, 1.0, 0.8], "rotation": [0, 25, 0]}},
             quad("white", (0, 2.98, 0), 1.0, (0, 0, 180),
                  emission=[6.0, 6.0, 6.0])]
    doc = {"bsdfs": bsdfs, "primitives": prims,
           "camera": {"type": "pinhole", "resolution": [res, res], "fov": 60,
                      "transform": {"position": [0, 1.5, 5.0],
                                    "look_at": [0, 1.2, 0]}},
           "integrator": {"type": "path_tracer", "max_bounces": 16},
           "renderer": {"spp": 1}}
    path = os.path.join(dirpath, "replay_box.json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
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


def fog_layout(sj: dict) -> None:
    """Phase 8's fog layout on the smoke scene's file `sj`: a homogeneous
    fog the camera sits in, bounded by a 26-unit `forward` box; four
    thinsheet and four transparency (opacity 0.5) spheres."""
    sj["bsdfs"] += [{"name": "boundary", "type": "forward"},
                    {"name": "sheet", "type": "thinsheet", "ior": 1.5,
                     "sigma_a": [0.1, 0.3, 0.6], "thickness": 0.2}]
    sj["media"] = [
        {"name": "fog", "type": "homogeneous", "sigma_a": 0.01,
         "sigma_s": [0.03, 0.035, 0.04],
         "phase_function": {"type": "henyey_greenstein", "g": 0.5}}]
    spheres = [p for p in sj["primitives"] if p["type"] == "mesh"]
    for k, p in enumerate(spheres):
        if k % 3 == 1 and k < 12:       # four thinsheet spheres
            p["bsdf"] = "sheet"
        elif k % 3 == 1:                # four transparency spheres
            sj["bsdfs"].append({"name": f"cutout_{k}", "type": "transparency",
                                "alpha": 0.5, "base": "floor"})
            p["bsdf"] = f"cutout_{k}"
    sj["primitives"].append(
        {"type": "cube", "bsdf": "boundary", "int_medium": "fog",
         "transform": {"position": [0, 5, 0], "scale": 26}})
    sj["camera"]["medium"] = "fog"


def write_media_scene(dirpath: str, res: int = RES, spp: int = SPP,
                      grid: int = MEDIA_GRID) -> tuple[str, float]:
    """Write the media scene: the smoke scene (the same sphere meshes and
    sky) in phase 8's fog layout (fog_layout), with a `forward` cube over
    the spheres holding a voxel medium on a grid^3 density written with
    the port's write_vdb (ZIP).  Returns (scene path, seconds the .vdb
    write took)."""
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
    fog_layout(sj)
    sj["media"].append(
        {"name": "smoke", "type": "voxel", "sigma_a": 0.3,
         "sigma_s": [1.6, 1.8, 2.0],
         "grid": {"type": "vdb", "file": "smoke.vdb",
                  "transform": {"position": [0, 1.1, 0], "scale": 1.6}}})
    sj["primitives"].append(
        {"type": "cube", "bsdf": "boundary", "int_medium": "smoke",
         "ext_medium": "fog",
         "transform": {"position": [0, 1.9, 0], "scale": 1.6}})
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


def hair_strands(n: int, n_nodes: int, seed: int, width: float, center,
                 radius: float, step: float):
    """n seeded random-walk strands of n_nodes nodes rising from a disk
    (the generator of tests/test_fiber.py::test_hair_scene_render,
    vectorized and scaled): the port's CurveData."""
    import numpy as np
    from tungsten_tpu_torch.io import curves
    r = np.random.default_rng(seed)
    ang = r.uniform(0.0, 2.0 * np.pi, n)
    rad = radius * np.sqrt(r.uniform(0.0, 1.0, n))
    base = np.asarray(center, np.float64)[None] + np.stack(
        [rad * np.cos(ang), np.zeros(n), rad * np.sin(ang)], 1)
    steps = step * np.stack([r.normal(0, 0.3, (n, n_nodes)),
                             np.ones((n, n_nodes)),
                             r.normal(0, 0.3, (n, n_nodes))], -1)
    pts = base[:, None] + np.cumsum(steps, 1)
    nodes = np.concatenate([pts, np.full((n, n_nodes, 1), width)],
                           -1).reshape(-1, 4).astype(np.float32)
    ends = (np.arange(1, n + 1) * n_nodes).astype(np.uint32)
    return curves.CurveData(ends, nodes, curves.init_normals(ends, nodes))


def write_hair_scene(dirpath: str, strands=(HAIR_STRANDS, HAIR_RIBBONS,
                                            HAIR_HALF),
                     res: int = RES, spp: int = SPP,
                     name: str = "hair.json") -> str:
    """Write the hair scene: a groom of seeded random-walk strands of
    HAIR_NODES nodes in bcsdf_cylinder mode with the hair BCSDF (a
    .fiber file), ribbon strands with rough_wire (a .hair file) and
    half-cylinder strands with lambertian_fiber (a .fiber file), an
    `instances` primitive stamping a 16x8 UV-sphere mesh HAIR_SPHERES
    times, a lambert floor quad, an area light and an
    infinite_sphere_cap sun (the simple two-strategy NEE).  Returns its
    path."""
    import numpy as np
    from tungsten_tpu_torch.io import curves, mesh
    n_groom, n_ribbon, n_half = strands
    curves.save_fiber(os.path.join(dirpath, "groom.fiber"), hair_strands(
        n_groom, HAIR_NODES, 21, 0.003, (0, 0, 0), 0.8, 0.05))
    curves.save_hair(os.path.join(dirpath, "ribbons.hair"), hair_strands(
        n_ribbon, HAIR_NODES, 22, 0.01, (1.5, 0, 0.2), 0.4, 0.04))
    curves.save_fiber(os.path.join(dirpath, "half.fiber"), hair_strands(
        n_half, HAIR_NODES, 23, 0.01, (-1.5, 0, 0.2), 0.4, 0.04))
    pos, nrm, uv, idx = uv_sphere(16, 8)
    mesh.save_wo3(os.path.join(dirpath, "ball.wo3"), mesh.Mesh(
        pos=pos, normal=nrm, uv=uv, indices=idx,
        material=np.zeros(len(idx), np.int32)))
    ring = 2.0 * np.pi * np.arange(HAIR_SPHERES) / HAIR_SPHERES
    bsdfs = [{"name": "hair", "type": "hair", "scale_angle": 2.5,
              "melanin_ratio": 1.0, "melanin_concentration": 1.3,
              "roughness": 0.3},
             {"name": "wire", "type": "rough_wire", "material": "Cu",
              "roughness": 0.2},
             {"name": "fiber", "type": "lambertian_fiber",
              "albedo": [0.6, 0.5, 0.35]},
             {"name": "floor", "type": "lambert", "albedo": [0.55, 0.5, 0.45]},
             {"name": "ball", "type": "lambert", "albedo": [0.3, 0.5, 0.7]},
             {"name": "light", "type": "lambert", "albedo": 0.0}]
    prims = [
        {"type": "curves", "file": "groom.fiber", "bsdf": "hair",
         "mode": "bcsdf_cylinder"},
        {"type": "curves", "file": "ribbons.hair", "bsdf": "wire",
         "mode": "ribbon"},
        {"type": "curves", "file": "half.fiber", "bsdf": "fiber",
         "mode": "half_cylinder"},
        {"type": "instances", "bsdf": "ball",
         "masters": [{"type": "mesh", "file": "ball.wo3", "smooth": True,
                      "transform": {"scale": 0.15}}],
         "instances": [{"id": 0, "transform": {"position": [
             2.6 * float(np.cos(a)), 0.15, 2.6 * float(np.sin(a))]}}
             for a in ring]},
        {"type": "quad", "bsdf": "floor",
         "transform": {"position": [0, 0, 0], "scale": [12, 1, 12]}},
        {"type": "quad", "bsdf": "light", "emission": [10.0, 9.5, 9.0],
         "transform": {"position": [-0.5, 3.5, -1.0], "scale": [2, 1, 2],
                       "rotation": [0, 0, 180]}},
        {"type": "infinite_sphere_cap", "cap_angle": 3.0,
         "power": [5.0, 4.6, 4.0], "transform": {"rotation": [40, 0, 30]}}]
    sj = scene_json(bsdfs, prims, res, spp)
    sj["camera"].update({"fov": 42, "transform": {
        "position": [0, 1.1, -3.9], "look_at": [0, 0.55, 0]}})
    path = os.path.join(dirpath, name)
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


# a spin kernel's cycles (about 11 ms at the H100's 1.755 GHz boost) that
# hides the host's enqueue of QUEUED_CALLS calls from device_ms
SPIN_CYCLES = 20_000_000
QUEUED_CALLS = 20


def device_ms(fn, runs: int = TIMED_RUNS) -> float:
    """Median device milliseconds of one fn() call: QUEUED_CALLS calls
    enqueued behind a spin kernel, so they run back to back whatever the
    host's enqueue costs, between two events, over `runs` runs after one
    warm-up.  cuda_ms times one call between two events, which for a
    call of tens of microseconds also holds the host's enqueue time."""
    import torch
    fn()
    torch.cuda.synchronize()
    res = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        for _ in range(QUEUED_CALLS):
            fn()
        b.record()
        torch.cuda.synchronize()
        res.append(a.elapsed_time(b) / QUEUED_CALLS)
    return statistics.median(res)


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
    # one run: the plain walk is seconds a call, and the comparison's call
    # above was its warm-up
    plain_ms = event_ms(lambda: tis.bvh_walk(scene, k["o"], k["d"],
                                             k["tmin"], k["tmax"]))
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
    plain_ms = event_ms(lambda: tis.bvh_walk(scene, k["o"], k["d"],
                                             k["tmin"], k["tmax"],
                                             any_hit=True))
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


def curve_inputs(scene, o, d, t_min, t_max, any_hit: bool):
    """The curve walk's inputs as bvh_intersect forms them: per-ray near
    limits, and far limits that are the best t of the triangles (K1, or
    K2's occlusion) and the analytic prims where they hit, else t_max
    clipped at the geometry box; for any hit t_min where they occlude."""
    import torch
    from tungsten_tpu_torch.ops import intersect as tis
    R = o.shape[0]
    tmin = torch.broadcast_to(torch.as_tensor(
        t_min, dtype=torch.float32, device=o.device), (R,)).contiguous()
    t_clip = tis.geo_clip(scene, o, d, t_max)
    front = tis._tri_analytic(scene, o, d, tmin, t_clip, any_hit, False)
    far = torch.where(front["hit"], tmin if any_hit else front["t"], t_clip)
    return tmin, far.contiguous()


def curve_bound_ms(scene, R: int, boxes: int, tests: int, nodes: int,
                   pieces: int) -> tuple[float, str]:
    """Least time for a C1 launch: the bytes it must move (the distinct
    node and piece rows this run's rays read, each once, the rays in and
    the results out) over the HBM rate vs its f32 operations (a slab test
    for each child box tested, the occupied slots of the nodes visited,
    and a half-cylinder test a piece test) over the f32 rate.  A ray reads o, d, t_min and t_max (32 B) and writes t,
    seg, u, v and hit (17 B); the walk's counts are statistics that a
    render does not store."""
    from tungsten_tpu_torch.ops import curve_trace as tct
    from tungsten_tpu_torch.scene.flatten import CRV_ROW, CWBVH_ROW
    nbytes = nodes * CWBVH_ROW * 4 + pieces * CRV_ROW * 4 + R * (32 + 17)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = (boxes * tct.FLOPS_PER_BOX + tests * tct.FLOPS_PER_PIECE) \
        / PEAK_F32 * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def lanes_equal(scene, name, o, d, tmin, far, any_hit: bool) -> dict:
    """C1 with 1, 2 and 4 lanes a ray against the launcher's choice on the
    same rays: t, seg, u, v, hit and the statistics bitwise equal; and
    with a stack of 2 * SHORT entries, so that deep rays drop entries and
    restart: t, seg, u, v, hit bitwise equal in closest hit, hit in any
    hit (a restart changes which hit an any-hit ray meets first).  Else
    AssertionError.
    Returns {"launcher": lanes, "forced": [...], "stack": entries,
    "restarts": restarts with that stack}."""
    import torch
    from tungsten_tpu_torch.ops import curve_trace as tct
    args = (scene.crv_rows, scene.cwbvh_rows, o, d, tmin, far, any_hit)
    ref = tct.curve_kernel(*args, stats=True)[:6]
    for g in tct.LANES:
        got = tct.curve_kernel(*args, stats=True, lanes=g)[:6]
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"{name}: C1 with {g} lanes a ray differs "
                                 f"from the launcher's choice")
    small = 2 * tct.SHORT
    got = tct.curve_kernel(*args, stats=True, stack=small)[:6]
    keep = slice(4, 5) if any_hit else slice(0, 5)
    if not all(torch.equal(a, b) for a, b in zip(got[keep], ref[keep])):
        raise AssertionError(f"{name}: C1 with a {small}-entry stack differs "
                             f"from the full stack")
    return {"launcher": tct.curve_lanes(o.shape[0], o.device, any_hit),
            "forced": list(tct.LANES), "stack": small,
            "restarts": int(got[5][4].sum())}


def check_curves(scene, name, o, d, t_min, t_max, any_hit: bool) -> dict:
    """C1 on one ray set at full width against the plain curve walk on the
    first C1_CHECK rays, on the same device and inputs (curve_inputs):
    the hit set equal on >= 0.9999 of the live rays (far limit above the
    near limit); in closest hit the segment on >= 0.9999 of the rays
    both hit, t within rtol 1e-5 / atol 1e-6 where the segments agree;
    dead rays visit no node.  In any hit the hit set also equals C1's closest
    hit's on the same inputs.  Every forced lanes a ray bitwise equal to
    the launcher's choice on the whole set and on its 1,024 rays from
    C1_NARROW, and a 16-entry stack equal to the full one (lanes_equal).
    Node visits a live ray (mean, p99, max), the child boxes tested, the
    stack spills and restarts.
    Times with CUDA events (median of 5 after a warm-up) at full width
    and on the first 1,024 and 65,536 rays, the plain walk's checking
    run (once), and bvh_intersect on the whole set."""
    import torch
    from tungsten_tpu_torch.ops import curve_trace as tct
    from tungsten_tpu_torch.ops import intersect as tis
    R = o.shape[0]
    tmin, far = curve_inputs(scene, o, d, t_min, t_max, any_hit)
    live = far > tmin
    t, seg, u, v, hit, counts, nmark, pmark = tct.curve_kernel(
        scene.crv_rows, scene.cwbvh_rows, o, d, tmin, far, any_hit,
        stats=True)
    n = min(C1_CHECK, R)
    plain = []
    plain_ms = event_ms(lambda: plain.extend(tis.curve_walk_plain(
        scene, o[:n], d[:n], tmin[:n], far[:n], any_hit)))
    pt, pseg, pu, pv, phit = plain
    lv = live[:n]
    agree = (hit[:n] == phit)[lv].float().mean().item()
    both = hit[:n] & phit
    seg_eq = (seg[:n] == pseg)[both].float().mean().item() \
        if bool(both.any()) else 1.0
    err = abs_err = 0.0
    if not any_hit:
        s = both & (seg[:n] == pseg)
        dt = (t[:n] - pt).abs()
        err = float(dt[s].max()) if bool(s.any()) else 0.0
        # rtol 1e-5, and atol 1e-6 for a ray that leaves a strand and
        # meets a strand again at t of 1e-4 to 1e-2: there t's difference
        # is the rounding of its hit point, a few ulps of the scene's unit
        # scale (an ulp of 1 is 1.2e-7; up to 3.9e-7 seen on the H100).
        # abs_err: the largest |dt| beyond the rtol part, what atol covers
        abs_err = float((dt - 1e-5 * pt.abs())[s].clamp(min=0.0).max()) \
            if bool(s.any()) else 0.0
        bad = s & (dt > 1e-5 * pt.abs() + 1e-6)
        if bool(bad.any()):
            raise AssertionError(
                f"{name}: C1 t off the plain walk's on {int(bad.sum())} of "
                f"{int(s.sum())} rays: t {t[:n][bad][:8].tolist()} vs "
                f"{pt[bad][:8].tolist()}")
    else:
        ch = tct.curve_kernel(scene.crv_rows, scene.cwbvh_rows, o, d, tmin,
                              far, False)[4]
        if not torch.equal(ch, hit):
            raise AssertionError(f"{name}: any-hit set differs from C1's "
                                 f"closest hit set")
    if bool((counts[0][~live] != 0).any()):
        raise AssertionError(f"{name}: a dead ray visited nodes")
    stat = dict(zip(tct.COUNTS, (int(c) for c in counts.sum(dim=1))))
    visits, tests = stat["visits"], stat["piece_tests"]
    spills, boxes = stat["spills"], stat["box_tests"]
    lv_visits = counts[0][live].float()
    v_mean = lv_visits.mean().item() if bool(live.any()) else 0.0
    v_p99 = lv_visits.quantile(0.99).item() if bool(live.any()) else 0.0
    v_max = int(counts[0].max())
    nodes, pieces = int(nmark.sum()), int(pmark.sum())
    log(f"  {name}: {R} rays ({int(live.sum())} live, hit share "
        f"{hit.float().mean().item():.4f}); vs plain on {n}: hit set "
        f"{agree:.6f}, segment {seg_eq:.6f}, max |dt| {err:.3g} "
        f"(beyond rtol 1e-5: {abs_err:.3g}); node visits {visits} (a live "
        f"ray: mean {v_mean:.2f}, p99 {v_p99:.0f}, max {v_max}), child "
        f"boxes tested {boxes}, piece tests {tests}, stack spills {spills}, "
        f"restarts {stat['restarts']}; distinct rows read: {nodes} nodes, "
        f"{pieces} pieces")
    # an any-hit walk stops at its first hit, the plain walk after its
    # leaf: only the hit set is theirs to share
    if not (agree >= 0.9999 and (any_hit or seg_eq >= 0.9999)):
        raise AssertionError(f"{name}: C1 vs the plain curve walk: hit set "
                             f"{agree}, segment {seg_eq}")
    k = min(1024, R - C1_NARROW)
    nar = slice(C1_NARROW, C1_NARROW + k)
    lanes = {"full": lanes_equal(scene, name, o, d, tmin, far, any_hit),
             str(k): lanes_equal(scene, name, o[nar], d[nar], tmin[nar],
                                 far[nar], any_hit)}
    log(f"  {name}: lanes a ray {lanes['full']['launcher']} at full width, "
        f"{lanes[str(k)]['launcher']} on {k} rays; 1, 2 and 4 bitwise "
        f"equal to them; a {lanes['full']['stack']}-entry stack equal too "
        f"({lanes['full']['restarts']} restarts on the whole set)")

    def run(k):
        return tct.curve_kernel(scene.crv_rows, scene.cwbvh_rows, o[:k],
                                d[:k], tmin[:k], far[:k], any_hit)
    ms = cuda_ms(lambda: run(R))
    widths = {str(k): cuda_ms(lambda k=k: run(k)) for k in (1024, 65536)
              if k < R}
    wrap_ms = cuda_ms(lambda: tis.bvh_intersect(scene, o, d, t_min, t_max,
                                                any_hit=any_hit))
    b, by = curve_bound_ms(scene, R, boxes, tests, nodes, pieces)
    log(f"  {name}: C1 {ms:.3f} ms at full width ("
        + ", ".join(f"{k} rays {x:.3f} ms" for k, x in widths.items())
        + f"), plain walk {plain_ms:.1f} ms on {n} rays, bound {b:.4f} ms "
        f"({by}); bvh_intersect {wrap_ms:.3f} ms")
    return dict(ms=ms, plain_ms=plain_ms, plain_rays=n, bound_ms=b,
                bound_by=by, max_abs_err=err, t_abs_err=abs_err,
                rays=R, live=int(live.sum()),
                node_visits=visits, box_tests=boxes, piece_tests=tests,
                restarts=stat["restarts"], distinct_nodes=nodes,
                distinct_pieces=pieces, by_width=widths,
                bvh_intersect_ms=wrap_ms, hit_agreement=agree,
                segment_agreement=seg_eq, visits_mean=v_mean,
                visits_p99=v_p99, visits_max=v_max, stack_spills=spills,
                lanes=lanes)


def check_hair_kernels(scene, settings) -> tuple[dict, dict, dict]:
    """C1 on the traversals of the first two full-width bounce bodies,
    recorded as the bodies make them (the simple two-strategy NEE: a
    closest hit, an any-hit shadow segment, a closest-hit strategy ray a
    body): the camera rays (body 1's top trace), the shadow segments of
    body 1 in any hit, and the continuation rays (body 2's top trace).
    Returns (camera, shadow, continuation)."""
    import torch
    from tungsten_tpu_torch.integrators import path_tracer as tpt
    dev = scene.device
    n = settings.width * settings.height
    pix = torch.arange(n, dtype=torch.int32, device=dev).repeat(SPP)
    smp = torch.arange(SPP, dtype=torch.int32, device=dev).repeat_interleave(n)
    s = tpt.init_wave(scene, settings, pix, smp, SEED)
    calls = []
    orig = tpt.bvh_intersect

    def record(sc, o, d, t_min, t_max, any_hit=False, presorted=False):
        calls.append((o, d, t_min, t_max, any_hit))
        return orig(sc, o, d, t_min, t_max, any_hit=any_hit,
                    presorted=presorted)
    tpt.bvh_intersect = record
    try:
        body = tpt._make_bounce_body(scene, settings, SEED)
        body(body(s))
    finally:
        tpt.bvh_intersect = orig
    kinds = [("anyhit" if c[4] else "closest") for c in calls]
    if kinds != ["closest", "anyhit", "closest"] * 2:
        raise AssertionError(f"hair bodies: traversals {kinds}, not the "
                             f"simple sub-branch's")
    out = []
    for name, c in (("hair camera rays", calls[0]),
                    ("hair shadow segments", calls[1]),
                    ("hair continuation rays", calls[3])):
        o, d, t_min, t_max, any_hit = c
        out.append(check_curves(scene, name, o, d, t_min, t_max, any_hit))
    return tuple(out)


def render_counted(scene, settings, twt, spp: int = SPP):
    """The main path with every launch count (the wave kernels' and C1's)
    set to 0 just before and read just after: (image, stats, launches)."""
    from tungsten_tpu_torch.ops import curve_trace as tct
    from tungsten_tpu_torch.render import render
    zero_counts()
    img, stats = render(scene, settings, spp=spp, seed=SEED, spp_chunk=spp,
                        return_stats=True)
    return img, stats, dict(twt.LAUNCHES, **tct.LAUNCHES)


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
                   "curve_closest": "curve_trace_kernel",
                   "curve_anyhit": "curve_trace_kernel",
                   "paged_closest": "wave_trace_closest_kernel",
                   "anyhit": "wave_trace_anyhit_kernel",
                   "paged_anyhit": "wave_trace_anyhit_kernel",
                   "paged_walk": "wave_trace_paged_anyhit_kernel"}


def stage_tally(kern, stages) -> dict | None:
    """Device ms by stage: `stages` is the host's log of (stage, "b" or
    "e") for each marker kernel (MARKER) launched around a stage, in
    launch order, after up to SENTINELS markers that open the profile
    (the profiler may drop its first events); the last len(stages)
    marker events pair with the log, and each other kernel after the
    first of them counts to the innermost stage open when it started
    ("other" outside every stage).  None where the marker events cannot
    pair with the log."""
    marks = sorted(s for s, _, name in kern if MARKER in name)
    if len(marks) < len(stages) or len(marks) > len(stages) + SENTINELS:
        return None
    cut = marks[len(marks) - len(stages)] if stages else None
    marks = marks[len(marks) - len(stages):]
    kern = [k for k in kern if MARKER in k[2] or cut is None or
            k[0] > cut]
    events = sorted([(s, 0, i) for i, s in enumerate(marks)] +
                    [(s, 1, e - s) for s, e, name in kern
                     if MARKER not in name])
    open_, out = [], {}
    for _, kind, v in events:
        if kind == 0:
            stage, edge = stages[v]
            if edge == "b":
                open_.append(stage)
            else:
                open_.pop()
        else:
            key = open_[-1] if open_ else "other"
            out[key] = out.get(key, 0.0) + v / 1e3
    return out


def profile_render(render_once, summary: dict | None = None,
                   stages: list | None = None) -> dict:
    """One more render under torch.profiler (device activity only): device
    busy time (the union of kernel intervals) against the profiled wall
    time, and the kernels that take the most device time; with `stages`
    (stage_tally's log), the device ms by stage into summary["stages"]
    (the marker kernels left out of every other figure).  The profiler's
    own host cost is in the wall time, so the idle share is an upper
    bound.  The raw device events are read directly: the profiler's
    per-event Python parse takes minutes at a million launches.  Its stop
    and the read still take tens of microseconds an event, which the log
    gives in seconds.  The
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
    from tungsten_tpu_torch.ops import curve_trace as tct
    from tungsten_tpu_torch.ops import wave_trace as twt
    twt.LAUNCH_LOG = []
    tct.LAUNCH_LOG = []
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            render_once()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            wall_us = (t1 - t0) * 1e6
        launched = twt.LAUNCH_LOG
        curve_launched = tct.LAUNCH_LOG
    finally:
        twt.LAUNCH_LOG = None
        tct.LAUNCH_LOG = None
    kern = [(e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]
    read_s = time.perf_counter() - t1
    if stages is not None:
        tally = stage_tally(kern, stages)
        n_kern = len(kern)
        kern = [k for k in kern if MARKER not in k[2]]
        if summary is not None:
            summary["stages"] = tally
            summary["markers"] = n_kern - len(kern)
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
    curve = sum(v[0] for k, v in by_name.items() if "curve_trace" in k)
    if summary is not None:
        anyhit = sum(v[0] for k, v in by_name.items()
                     if "wave_trace_anyhit" in k)
        summary.update(wall_ms=wall_us / 1e3, busy_ms=busy / 1e3,
                       launches=launches, idle=1.0 - busy / wall_us,
                       curve_share=curve / total,
                       anyhit_share=anyhit / total,
                       s1_ms=sum(v[0] for k, v in by_name.items()
                                 if "segment_sum_kernel" in k) / 1e3,
                       s1_launches=sum(v[1] for k, v in by_name.items()
                                       if "segment_sum_kernel" in k),
                       scan_ms=sum(v[0] for k, v in by_name.items()
                                   if "ordered_scan" in k) / 1e3)
    log(f"profile: wall {wall_us / 1e3:.1f} ms under the profiler, device "
        f"busy {busy / 1e3:.1f} ms ({busy / wall_us * 100:.1f} %, idle "
        f"{100 - busy / wall_us * 100:.1f} %), {launches} kernel launches; "
        f"wave kernels {wave / 1e3:.1f} ms ({wave / total * 100:.1f} % of "
        f"kernel time)" + (f"; C1 {curve / 1e3:.1f} ms "
                           f"({curve / total * 100:.1f} %)"
                           if curve_launched else "")
        + f"; stopped and read in {read_s:.1f} s")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    for name, (us, n) in top:
        log(f"  {us / 1e3:9.2f} ms {n:6d}x {us / total * 100:5.1f} %  "
            f"{name[:90]}")
    trav = sorted((s, e, name) for s, e, name in kern
                  if "wave_trace" in name)
    ctrav = sorted((s, e, name) for s, e, name in kern
                   if "curve_trace" in name)
    if len(trav) != len(launched) or not all(
            KERNEL_OF_ROUTE[route] in name
            for (_, _, name), (route, _, _) in zip(trav, launched)) or \
            len(ctrav) != len(curve_launched):
        log(f"  traversal launches by width: not measured ({len(trav)} + "
            f"{len(ctrav)} device events, {len(launched)} + "
            f"{len(curve_launched)} launches logged)")
        return {}
    tally: dict[str, dict] = {}
    for (s, e, _), (route, rays, splits) in zip(
            trav + ctrav, launched + curve_launched):
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
            f"time; by rays a launch (launches, CTAs a block or C1's lanes "
            f"a ray, ms): " +
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
                  integrator: dict | None = None, **renderer) -> str:
    """The scene file at `path` with its renderer block replaced by
    `renderer` (and its resolution by `res`, its integrator block by
    `integrator`), written beside it."""
    with open(path) as f:
        sj = json.load(f)
    sj["renderer"] = renderer
    if integrator:
        sj["integrator"] = integrator
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


# ----------------------------------------------------- replay, parallel

REPLAY_PARAMS = ("tex_const", "light_emission", "bsdf_params")
REPLAY_SMALL = (64, 4, 8)     # phase 14(c)-(d): resolution, spp, bounces
DP_RES, DP_SPP = 128, 2       # phase 15: the data-parallel frame
GRAD_TOL = ("rtol 1e-3 on entries above 1e-2 * max|g|, the rest within "
            "1e-3 * max|g| (card against CPU: a lane may part where the "
            "kernel and the plain walk round a grazing hit differently, and "
            "the two devices' reductions sum in other orders); card against "
            "card the replay's L and gradients are bitwise (phase 14(a))")


def zero_counts() -> None:
    from tungsten_tpu_torch.ops import curve_trace as tct
    from tungsten_tpu_torch.ops import segment_sum as tss
    from tungsten_tpu_torch.ops import wave_trace as twt
    for counts in (twt.LAUNCHES, tct.LAUNCHES, tss.LAUNCHES):
        for key in counts:
            counts[key] = 0


def read_counts() -> dict:
    from tungsten_tpu_torch.ops import curve_trace as tct
    from tungsten_tpu_torch.ops import wave_trace as twt
    return {k: v for k, v in dict(twt.LAUNCHES, **tct.LAUNCHES).items() if v}


def wave_ids(settings, spp: int, device, first_sample: int = 0):
    """(pixel, sample) int32 ids of every pixel for `spp` samples,
    sample-major (render.py's wave layout)."""
    import torch
    n = settings.width * settings.height
    pixel = torch.arange(n, dtype=torch.int32, device=device).repeat(spp)
    sample = torch.arange(first_sample, first_sample + spp,
                          dtype=torch.int32,
                          device=device).repeat_interleave(n)
    return pixel, sample


def replay_run(scene, settings, pixel, sample) -> dict:
    """trace_wave_replay of the mean radiance w.r.t. REPLAY_PARAMS, the
    forward and the backward each timed (ending in a synchronize) and
    each from zero launch counts; the backward's final re-traced
    emission from the replay's ReplayStats."""
    import torch
    from tungsten_tpu_torch.integrators import path_tracer as tpt
    cuda = scene.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()
    leaves = {k: getattr(scene, k).detach().clone().requires_grad_()
              for k in REPLAY_PARAMS}
    sync()
    zero_counts()
    t0 = time.perf_counter()
    L, stats = tpt.trace_wave_replay(scene.replace(**leaves), settings,
                                     pixel, sample, SEED, with_stats=True)
    loss = L.mean()
    sync()
    t1 = time.perf_counter()
    fwd = read_counts()
    zero_counts()
    t2 = time.perf_counter()
    loss.backward()
    sync()
    t3 = time.perf_counter()
    bwd = read_counts()
    return dict(L=L.detach(), loss=float(loss.detach()), rays=int(stats.rays),
                grads={k: v.grad for k, v in leaves.items()},
                forward_s=t1 - t0, backward_s=t3 - t2, forward_launches=fwd,
                backward_launches=bwd, final=stats.emission,
                bodies=stats.bodies)


def grads_agree(name, got, want, big=1e-2, rtol=1e-3, atol=1e-3,
                nonzero=False) -> float:
    """Every field's gradient: rtol on entries above big * max|g|, the
    rest within atol * max|g|; a field the loss does not depend on (the
    smoke scene's bsdf_params: lambert albedo is a texture, a mirror has
    no parameter) is zero in both, unless `nonzero` asks every field to
    carry a gradient.  Returns the largest relative deviation on the
    large entries."""
    import numpy as np
    worst = 0.0
    for k in want:
        a = got[k].detach().cpu().numpy()
        b = want[k].detach().cpu().numpy()
        m = np.abs(b).max()
        sel = np.abs(b) > big * m
        if not np.isfinite(a).all():
            raise AssertionError(f"{name}: {k} gradient not finite")
        if m == 0:
            if nonzero:
                raise AssertionError(f"{name}: {k} gradient vanished")
            if np.abs(a).max() != 0:
                raise AssertionError(f"{name}: {k} gradient zero in one")
            log(f"  {name} {k}: zero in both")
            continue
        dev = np.abs(a - b)
        rel = float((dev[sel] / np.abs(b[sel])).max())
        ok = rel <= rtol and float(dev[~sel].max(initial=0.0)) <= atol * m
        log(f"  {name} {k}: max|g| {m:.6g}, largest relative deviation "
            f"{rel:.3e} on {int(sel.sum())} entries, largest absolute "
            f"{float(dev.max()):.3e}")
        if not ok:
            raise AssertionError(f"{name}: {k} gradients disagree")
        worst = max(worst, rel)
    return worst


def check_replay(path, card) -> dict:
    """Phase 14: trace_wave_replay at full width, flat memory, the card
    against the plain path, finite differences."""
    import numpy as np
    import torch
    from tungsten_tpu_torch.integrators import path_tracer as tpt
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.parse import load_scene
    scene, settings = flatten_scene(load_scene(path))
    dev = scene.device
    pixel, sample = wave_ids(settings, SPP, dev)
    out = {}
    # (b) at 8 bounces first (it also warms the replay's code paths up),
    # then (a) at max_bounces 64, on the same 1,048,576-ray wave
    for bounces in (8, settings.max_bounces):
        s = replace(settings, max_bounces=bounces)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        r = replay_run(scene, s, pixel, sample)
        r["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
        out[bounces] = r
    a = out[settings.max_bounces]
    for part in ("forward", "backward"):
        c = a[f"{part}_launches"]
        if not (c.get("closest", 0) > 0 and c.get("anyhit", 0) > 0):
            raise AssertionError(f"replay {part}: K1/K2 did not launch {c}")
    if not all(bool(torch.isfinite(g).all()) for g in a["grads"].values()):
        raise AssertionError("replay: a gradient is not finite")
    if not torch.equal(a["final"], a["L"]):
        raise AssertionError("replay: the backward's final emission is not "
                             "the forward's L")
    wall = a["forward_s"] + a["backward_s"]
    a["mrays_per_s"] = a["rays"] / wall / 1e6
    log(f"  (a) {settings.width}x{settings.height} {SPP} spp "
        f"({pixel.shape[0]} rays) max_bounces {settings.max_bounces}: "
        f"forward {a['forward_s']:.3f} s, backward {a['backward_s']:.3f} s "
        f"({a['backward_s'] / a['forward_s']:.2f}x), {a['bodies']} bodies, "
        f"{a['rays']} rays, {a['mrays_per_s']:.3f} replay Mrays/s on {card}; "
        f"launches forward {a['forward_launches']} backward "
        f"{a['backward_launches']}; peak {a['peak_mib']:.1f} MiB; final "
        f"emission == L bitwise; loss {a['loss']:.6f}")
    b8 = out[8]
    ratio = a["peak_mib"] / b8["peak_mib"]
    log(f"  (b) peak memory {b8['peak_mib']:.1f} MiB at 8 bounces, "
        f"{a['peak_mib']:.1f} MiB at {settings.max_bounces} ({ratio:.3f}x); "
        f"8 bounces: forward {b8['forward_s']:.3f} s, backward "
        f"{b8['backward_s']:.3f} s")
    if not 1 / 1.25 <= ratio <= 1.25:
        raise AssertionError("replay: memory grows with depth")
    # (a') the same replay once more, each pass under torch.profiler
    leaves = {k: getattr(scene, k).detach().clone().requires_grad_()
              for k in REPLAY_PARAMS}
    held, prof = {}, {"forward": {}, "backward": {}}

    def forward():
        held["L"] = tpt.trace_wave_replay(scene.replace(**leaves), settings,
                                          pixel, sample, SEED)

    for part, run in (("forward", forward),
                      ("backward", lambda: held["L"].mean().backward())):
        log(f"  (a) the replay's {part} profiled:")
        profile_render(run, prof[part])
    # the profiled replay is the timed one again: L and every gradient
    # bitwise
    a["repeat_equal"] = soft(same_bits, "replay L", a["L"].cpu().numpy(),
                             held["L"].detach().cpu().numpy()) and all(
        soft(same_bits, f"replay {k} gradient",
             a["grads"][k].cpu().numpy(), leaves[k].grad.cpu().numpy())
        for k in REPLAY_PARAMS)
    log(f"  (a) the replay twice on the card: L and the gradients of "
        f"{', '.join(REPLAY_PARAMS)} bitwise equal: {a['repeat_equal']}; "
        f"take's ordered backward: {prof['backward'].get('s1_launches')} "
        f"S1 launches, {prof['backward'].get('s1_ms')} ms device time")
    # (c) the card against the plain path on the CPU
    res, spp, bounces = REPLAY_SMALL
    small = replace(settings, width=res, height=res, max_bounces=bounces)
    pix, smp = wave_ids(small, spp, dev)
    t0 = time.time()
    gpu = replay_run(scene, small, pix, smp)
    cpu = replay_run(scene.to("cpu"), small, pix.cpu(), smp.cpu())
    log(f"  (c) {res}x{res} {spp} spp max_bounces {bounces}: loss "
        f"{gpu['loss']:.6f} (card) vs {cpu['loss']:.6f} (CPU), CPU "
        f"forward + backward {cpu['forward_s'] + cpu['backward_s']:.1f} s")
    if abs(gpu["loss"] / cpu["loss"] - 1.0) > 1e-4:
        raise AssertionError("replay: card and CPU losses disagree")
    worst = grads_agree("card vs CPU", gpu["grads"], cpu["grads"])
    # (c') the same on a box whose loss depends on every parameter
    # (rough_conductor, rough_plastic and oren_nayar roughness in
    # bsdf_params), each field's gradient required nonzero
    box, box_set = flatten_scene(load_scene(write_replay_box(
        os.path.dirname(path), res)))
    box_set = replace(box_set, max_bounces=bounces)
    bpix, bsmp = wave_ids(box_set, spp, dev)
    bgpu = replay_run(box, box_set, bpix, bsmp)
    bcpu = replay_run(box.to("cpu"), box_set, bpix.cpu(), bsmp.cpu())
    for part in ("forward", "backward"):
        c = bgpu[f"{part}_launches"]
        if not (c.get("closest", 0) > 0 and c.get("anyhit", 0) > 0):
            raise AssertionError(f"replay box {part}: K1/K2 did not launch "
                                 f"{c}")
    log(f"  (c') the box, {res}x{res} {spp} spp max_bounces {bounces}: loss "
        f"{bgpu['loss']:.6f} (card) vs {bcpu['loss']:.6f} (CPU), CPU "
        f"forward + backward {bcpu['forward_s'] + bcpu['backward_s']:.1f} s")
    if abs(bgpu["loss"] / bcpu["loss"] - 1.0) > 1e-4:
        raise AssertionError("replay box: card and CPU losses disagree")
    worst = max(worst, grads_agree("box card vs CPU", bgpu["grads"],
                                   bcpu["grads"], nonzero=True))
    log(f"  [(c): {time.time() - t0:.1f} s]")
    # (d) central differences of two card renders
    fd_rows = {}
    for field, eps in (("tex_const", 1e-3), ("light_emission", 1e-2)):
        g = gpu["grads"][field].cpu().numpy()
        idx = np.unravel_index(int(np.argmax(np.abs(g))), g.shape)
        vals = []
        for sgn in (1.0, -1.0):
            t = getattr(scene, field).clone()
            t[idx] += sgn * eps
            L, _ = tpt.replay_forward(scene.replace(**{field: t}), small,
                                      pix, smp, SEED)
            vals.append(float(L.double().mean()))
        fd = (vals[0] - vals[1]) / (2 * eps)
        rel = abs(fd - g[idx]) / max(abs(fd), 1e-6)
        fd_rows[field] = dict(index=[int(i) for i in idx], ad=float(g[idx]),
                              fd=fd, rel=rel)
        log(f"  (d) {field}{list(idx)}: gradient {g[idx]:.6g}, central "
            f"difference (eps {eps}) {fd:.6g}, relative {rel:.3e}")
        if not rel < 5e-2:
            raise AssertionError(f"replay: {field} gradient vs finite "
                                 f"differences")
    return dict(full=a, shallow=b8, peak_ratio=ratio, card_vs_cpu=worst,
                fd=fd_rows, profile=prof)


def per_sample_sum(scene, settings, spp: int):
    """The per-sample trace_wave radiance of every pixel at full width,
    non-finite samples dropped, summed over samples: what
    render_pass_sharded gives."""
    import torch
    from tungsten_tpu_torch.integrators.path_tracer import trace_wave
    n = settings.width * settings.height
    pixel = torch.arange(n, dtype=torch.int32, device=scene.device)
    acc = torch.zeros((n, 3), device=scene.device)
    for s in range(spp):
        rad = trace_wave(scene, settings, pixel, torch.full_like(pixel, s),
                         SEED, min_wave=n + 1)
        acc = acc + torch.where(torch.isfinite(rad), rad, 0.0)
    return acc.reshape(settings.height, settings.width, 3)


def dp_loss(n: int):
    """The data-parallel loss: the mean radiance of the frame (padded ids
    masked), each rank's part."""
    import torch

    def loss_fn(rad, pix):
        return torch.sum(torch.where((pix < n)[:, None], rad, 0.0)) / (3 * n)
    return loss_fn


def dp_cases(scene, settings, mesh) -> dict:
    """render_pass_sharded, the staged render with rebalance, and a train
    step on `mesh`, each timed; their results on the CPU."""
    import torch
    from tungsten_tpu_torch.parallel import sharded as S
    out = {}
    t0 = time.perf_counter()
    img, rays = S.render_pass_sharded(scene, settings, mesh,
                                      spp_chunk=DP_SPP, seed=SEED)
    t1 = time.perf_counter()
    simg, srays = S.render_pass_sharded_staged(scene, settings, mesh,
                                               spp_chunk=DP_SPP, seed=SEED)
    t2 = time.perf_counter()
    loss, grads = S.train_step_sharded(
        scene, settings, mesh, lambda sc, p: sc.replace(**p),
        dp_loss(settings.width * settings.height),
        {k: getattr(scene, k) for k in REPLAY_PARAMS}, seed=SEED)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    out.update(image=img.cpu(), rays=rays, staged=simg.cpu(),
               staged_rays=srays, loss=float(loss),
               grads={k: v.cpu() for k, v in grads.items()},
               render_s=t1 - t0, staged_s=t2 - t1, train_s=t3 - t2)
    return out


def dp_rank(rank: int, world: int, port: int, tmp: str, path: str) -> None:
    """One spawned rank of phase 15(b): gloo on the shared card."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    from tungsten_tpu_torch.parallel import distributed as D
    from tungsten_tpu_torch.parallel import sharded as S
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.parse import load_scene
    D.init_distributed(backend="gloo", timeout_s=300)
    try:
        scene, settings = flatten_scene(load_scene(path))
        mesh = S.make_mesh()
        D.device_put_replicated(scene, mesh)
        out = dp_cases(scene, settings, mesh)
        if rank == 0:
            torch.save(out, os.path.join(tmp, "dp_gloo.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def check_data_parallel(path, card) -> dict:
    """Phase 15: (a) a one-rank NCCL group; (b) two spawned gloo ranks
    sharing the card."""
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from tungsten_tpu_torch.parallel import distributed as D
    from tungsten_tpu_torch.parallel import sharded as S
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.parse import load_scene
    dpath = scene_variant(path, "dp.json", res=DP_RES, spp=DP_SPP)
    scene, settings = flatten_scene(load_scene(dpath))
    n = settings.width * settings.height
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(D.free_port()),
                      WORLD_SIZE="1", RANK="0", LOCAL_RANK="0")
    if not D.init_distributed() or dist.get_backend() != "nccl":
        raise AssertionError("data-parallel: no one-rank NCCL group")
    try:
        a = dp_cases(scene, settings, S.make_mesh())
    finally:
        dist.destroy_process_group()
        for k in D.ENV + ("LOCAL_RANK",):
            os.environ.pop(k, None)
    ref = per_sample_sum(scene, settings, DP_SPP).cpu()
    if not torch.equal(a["image"], ref):
        raise AssertionError("data-parallel: the sharded image is not the "
                             "per-sample trace_wave sum")
    np.testing.assert_allclose(a["staged"].numpy(), a["image"].numpy(),
                               rtol=1e-5, atol=1e-6)
    pix, smp = wave_ids(settings, 1, scene.device)
    single = replay_run(scene, settings, pix, smp)
    if abs(a["loss"] / single["loss"] - 1.0) > 1e-6:
        raise AssertionError("data-parallel: the train step's loss is not "
                             "the replay's")
    train_dev = grads_agree("one-rank train step vs replay", a["grads"],
                            single["grads"], big=1e-3, rtol=1e-5, atol=1e-6)
    log(f"  (a) one NCCL rank, {DP_RES}x{DP_RES} {DP_SPP} spp: "
        f"render_pass_sharded {a['render_s']:.3f} s ({a['rays']} rays), "
        f"bitwise the per-sample trace_wave sum; staged with rebalance "
        f"{a['staged_s']:.3f} s, within rtol 1e-5 / atol 1e-6; train step "
        f"{a['train_s']:.3f} s, loss {a['loss']:.6f}")
    # (b) two ranks spawned over gloo, sharing the one card
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        t0 = time.time()
        mp.spawn(dp_rank, args=(2, D.free_port(), tmp, dpath), nprocs=2,
                 join=True)
        b = torch.load(os.path.join(tmp, "dp_gloo.pt"), weights_only=False)
        spawn_s = time.time() - t0
    if not torch.equal(b["image"], a["image"]) or b["rays"] != a["rays"]:
        diff = (b["image"] - a["image"]).abs().max().item()
        raise AssertionError(f"data-parallel: the 2-rank image is not the "
                             f"1-rank image bitwise (max |diff| {diff})")
    np.testing.assert_allclose(b["staged"].numpy(), a["image"].numpy(),
                               rtol=1e-5, atol=1e-6)
    if abs(b["loss"] / a["loss"] - 1.0) > 1e-6:
        raise AssertionError("data-parallel: 2-rank loss differs")
    gloo_dev = grads_agree("2 gloo ranks vs one NCCL rank", b["grads"],
                           a["grads"], big=1e-3, rtol=1e-5, atol=1e-6)
    log(f"  (b) two gloo ranks on the card: render_pass_sharded "
        f"{b['render_s']:.3f} s, image bitwise the one rank's; staged "
        f"{b['staged_s']:.3f} s; train step {b['train_s']:.3f} s; "
        f"{spawn_s:.1f} s with the spawn")
    return dict(nccl={k: a[k] for k in ("render_s", "staged_s", "train_s",
                                        "rays", "loss")},
                gloo={k: b[k] for k in ("render_s", "staged_s", "train_s")},
                train_vs_replay=train_dev, gloo_vs_nccl=gloo_dev,
                spawn_s=spawn_s)


# ------------------------------------------------- BDPT, the light tracer

BDPT_VERTICES = 8
BDPT_SMALL = (64, 4, 4)      # phase 16(c)-(e): resolution, spp, bounces
# phase 16(d)'s bounces: the media scene's BDPT on the CPU is the run's
# slowest check (111 s at 8 bounces, 43 s at 4), cut to keep the run
# well inside its time limit
BDPT_MEDIA_BOUNCES = 2
SPLATTING = ("bidirectional_path_tracer", "light_tracer")


def splat_settings(settings, integrator: str):
    return replace(settings, integrator_type=integrator,
                   bdpt_vertices=BDPT_VERTICES)


def splat_render(scene, settings, card, twt) -> dict:
    """The full-width wave (256x256, 16 spp, one 1,048,576-lane wave) from
    zero launch counts with the peak device memory, then one more render
    under torch.profiler."""
    import numpy as np
    import torch
    from tungsten_tpu_torch.render import render
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mib = torch.cuda.memory_allocated() / 2**20
    img, stats, launches = render_counted(scene, settings, twt)
    peak = torch.cuda.max_memory_allocated() / 2**20
    log(f"  {settings.integrator_type} {settings.width}x{settings.height} "
        f"{SPP} spp max_bounces {settings.max_bounces} bdpt_vertices "
        f"{settings.bdpt_vertices}: {stats['time']:.3f} s, {stats['rays']} "
        f"rays, {stats['mrays_per_s']:.3f} Mrays/s on {card}; launches "
        f"{ {k: v for k, v in launches.items() if v} }; peak device memory "
        f"{peak:.1f} MiB ({base_mib:.1f} MiB held before the render); image "
        f"mean {img.mean():.6f}")
    if not (np.isfinite(img).all() and img.mean() > 0):
        raise AssertionError(f"{settings.integrator_type}: image not finite "
                             f"or black")
    if not (launches["closest"] > 0 and launches["anyhit"] > 0):
        raise AssertionError(f"{settings.integrator_type}: K1 or K2 never "
                             f"launched {launches}")
    summ: dict = {}
    prof = profile_render(lambda: render(scene, settings, spp=SPP, seed=SEED,
                                         spp_chunk=SPP), summary=summ)
    log(f"  {settings.integrator_type}: {summ.get('launches')} kernel "
        f"launches a render, K2 {summ.get('anyhit_share', 0) * 100:.2f} % of "
        f"kernel time, beside {stats['mrays_per_s']:.3f} Mrays/s")
    return dict(img=img, stats=stats, launches=launches, peak_mib=peak,
                prof=prof, summary=summ)


def check_splat(path, mpath, pt_img, card, twt) -> dict:
    """Phase 16: the bidirectional path tracer and the light tracer on the
    smoke scene at full width (a, b), against the plain path on the CPU
    (c), on the media scene (d), and through the CLI with output buffers
    (e)."""
    import numpy as np
    from tungsten_tpu_torch.io import image as im
    from tungsten_tpu_torch.render import render_with_aovs
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.parse import load_scene
    out = {}
    scene, settings = flatten_scene(load_scene(path))
    log("  (a) bidirectional_path_tracer:")
    bd = splat_render(scene, splat_settings(settings, SPLATTING[0]), card,
                      twt)
    rel = abs(bd["img"].mean() / pt_img.mean() - 1.0)
    log(f"  image mean {bd['img'].mean():.6f} against the path tracer's "
        f"{pt_img.mean():.6f} (phase 5): {rel * 100:.3f} % apart")
    if rel > 0.05:
        raise AssertionError("bdpt: image mean more than 5 % off the path "
                             "tracer's")
    bd["vs_path_tracer"] = rel
    out["bdpt"] = bd
    log("  (b) light_tracer:")
    lt = splat_render(scene, splat_settings(settings, SPLATTING[1]), card,
                      twt)
    log(f"  light tracer splat sum {lt['img'].sum():.3f}, mean "
        f"{lt['img'].mean():.6f} ({lt['img'].mean() / pt_img.mean():.4f} of "
        f"the path tracer's: the env reaches the camera only through "
        f"camera paths)")
    out["light"] = lt
    res, spp, bounces = BDPT_SMALL
    log(f"  (c) {res}x{res} {spp} spp max_bounces {bounces} against the "
        f"plain path on the CPU:")
    for integ in SPLATTING:
        cross_path(scene, splat_settings(settings, integ),
                   max_bounces=bounces, res=(res, res))
    del scene
    log("  (d) the media scene under bidirectional_path_tracer:")
    mscene, msettings = flatten_scene(load_scene(mpath))
    zero_counts()
    cross_path(mscene, splat_settings(msettings, SPLATTING[0]),
               max_bounces=BDPT_MEDIA_BOUNCES, res=(res, res))
    out["media_launches"] = read_counts()
    log(f"  media scene launches (card side): {out['media_launches']}")
    if not (out["media_launches"].get("closest", 0) > 0 and
            set(out["media_launches"]) == {"closest"}):
        raise AssertionError("bdpt media: not K1 alone")
    del mscene
    log(f"  (e) the CLI, {res}x{res} {SPP} spp with output buffers:")
    bpath = scene_variant(path, "bdpt_buffers.json", res=res, spp=SPP,
                          output_file="bdpt.png", hdr_output_file="bdpt.pfm",
                          output_buffers=BUFFER_SPECS,
                          integrator={"type": SPLATTING[0],
                                      "max_bounces": MAX_BOUNCES})
    bdir = os.path.join(os.path.dirname(path), "cli_bdpt")
    cli = cli_run(bpath, bdir, twt, res)
    names = sorted(os.path.basename(f) for f in cli["files"])
    want = sorted(["bdpt.png", "bdpt.pfm", "color.pfm", "colorVariance.pfm",
                   "colorA.pfm", "colorB.pfm", "depth.pfm", "normal.pfm",
                   "albedo.pfm", "visibility.pfm"])
    if names != want:
        raise AssertionError(f"bdpt cli: wrote {names}")
    cscene, csettings = flatten_scene(load_scene(bpath))
    post, _ = render_with_aovs(
        cscene, replace(csettings, integrator_type="path_tracer"),
        spp=min(SPP, 8), seed=csettings.seed)
    for name in ("normal", "albedo", "depth", "color"):
        got = im.load_hdr(os.path.join(bdir, f"{name}.pfm"))
        ref = post[name]
        ref = np.repeat(ref[..., None], 3, -1) if ref.ndim == 2 else ref
        images_agree(f"cli {name} buffer vs the 8-spp path-traced post-pass",
                     got, ref, 1e-4, 1e-5, 0.999, 1e-4)
    out["cli"] = cli
    return out


# ------------------------------------------------------------ photon maps

PHOTON_INTEGRATOR = {"type": "photon_map", "max_bounces": MAX_BOUNCES,
                     "photon_count": 1 << 20, "gather_photon_count": 20,
                     "gather_radius": 0.1}
# the fog's volume gather radius: at 65,536 paths a round the fog holds
# about 4 volume photons a cubic unit, so a 0.1 sphere would hold almost
# none; 0.5 holds a few
PHOTON_FOG_RADIUS = 0.5
PHOTON_VOL_SPP = 4                # phase 17(c)
PHOTON_VOL_BOUNCES = 8            # phase 17(c)'s depth (the fog's long tail)
PHOTON_SMALL = (64, 4, 8)         # phase 17(d)-(e): resolution, spp, bounces
PHOTON_LIST_PATHS = 16384         # phase 17(d): the paths held against the CPU
PHOTON_SMALL_PATHS = 1 << 16      # phase 17(d)'s images: photon paths a round
PHOTON_SMALL_VOL = 2000           # and the paths the beam / plane maps keep
# phase 17(d)'s volume-map images: the CPU's beam and plane gathers, the
# phase's slowest checks (27 s and 55 s at 64x64), grow with the camera
# rays
PHOTON_FOG_CROSS_RES = 32
VOLUME_KINDS = ("points", "beams", "planes")
PEAK_LIMIT_MIB = 16 * 1024
# the kernels line's tag for each of check_photon's renders
PHOTON_TAGS = (("photon_map", "photon"), ("ppm", "ppm"),
               ("photon_points", "fog_points"),
               ("photon_beams", "fog_beams"),
               ("photon_planes", "fog_planes"))
# the photon module's stages: its functions by the stage each is timed in
PHOTON_STAGES = {"trace_photons": "photon pass", "build_photon_grid": "grid",
                 "build_beam_grid": "grid", "build_plane_grid": "grid",
                 "camera_walk": "camera pass", "gather_walk": "camera pass",
                 "beam_pass": "camera pass", "plane_pass": "camera pass",
                 "_gather_estimate": "gather", "_volume_march": "gather",
                 "_beam_eval": "gather", "_plane_eval": "gather"}


def write_photon_scenes(dirpath: str) -> tuple[str, str]:
    """The smoke scene without its sky (the 24 spheres and the floor lit by
    the quad light alone, so every light emits photons) under photon_map,
    and the same in phase 8's fog layout (no voxel cube) with the light's
    and the surfaces' exterior medium the fog (photons enter a medium
    only through their emitter's).  Returns (surface path, fog path)."""
    os.makedirs(dirpath, exist_ok=True)
    path = write_scene(dirpath)
    with open(path) as f:
        sj = json.load(f)
    sj["primitives"] = [p for p in sj["primitives"]
                        if p["type"] != "infinite_sphere"]
    sj["integrator"] = dict(PHOTON_INTEGRATOR)
    spath = os.path.join(dirpath, "photon.json")
    with open(spath, "w") as f:
        json.dump(sj, f, indent=1)
    for p in sj["primitives"]:
        p["ext_medium"] = "fog"
    fog_layout(sj)
    sj["integrator"]["volume_gather_radius"] = PHOTON_FOG_RADIUS
    fpath = os.path.join(dirpath, "photon_fog.json")
    with open(fpath, "w") as f:
        json.dump(sj, f, indent=1)
    return spath, fpath


class photon_stages:
    """Wraps the photon module's stages (PHOTON_STAGES) while open.  In
    "events" mode CUDA events time the outer stages (photon pass, grid,
    camera pass) and each photon wave's rounds, paths, deposits, beams
    and planes are counted (one host read a wave); in "markers" mode a
    marker kernel is launched before and after every stage and logged
    for stage_tally.  `calls` counts each function's calls."""

    def __init__(self, mode: str):
        self.mode = mode
        self.events, self.log, self.waves = [], [], []
        self.calls = {n: 0 for n in PHOTON_STAGES}

    def __enter__(self):
        from tungsten_tpu_torch.integrators import photon_map as pm
        self.pm = pm
        self.orig = {n: getattr(pm, n) for n in PHOTON_STAGES}
        for n, stage in PHOTON_STAGES.items():
            setattr(pm, n, self._wrap(n, stage))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.pm, n, fn)

    def _wrap(self, name, stage):
        import torch
        fn = self.orig[name]

        def f(*a, **k):
            self.calls[name] += 1
            if self.mode == "markers":
                torch.cuda._sleep(1)
                self.log.append((stage, "b"))
                out = fn(*a, **k)
                torch.cuda._sleep(1)
                self.log.append((stage, "e"))
                return out
            if stage == "gather":
                return fn(*a, **k)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            out = fn(*a, **k)
            t1.record()
            self.events.append((stage, t0, t1))
            if name == "trace_photons":
                rounds = len(a[3]) if isinstance(a[3], (list, tuple)) else 1
                self.waves.append(
                    {"rounds": rounds, "paths": int(a[2]) * rounds,
                     "deposits": int(out["valid"].sum()),
                     "volume": int((out["valid"] & out["vol"]).sum()),
                     "beams": int(out["b_valid"].sum()),
                     "planes": int(out["pl_valid"].sum())
                     if "pl_valid" in out else 0})
            return out
        return f

    def split(self) -> dict:
        import torch
        torch.cuda.synchronize()
        out = {}
        for stage, t0, t1 in self.events:
            out[stage] = out.get(stage, 0.0) + t0.elapsed_time(t1)
        return out


def photon_render(scene, settings, card, twt, spp: int, tag: str) -> dict:
    """A photon-map render from zero launch counts: rays, wall, Mrays/s,
    launches, paths and deposits a round, the wall split into photon
    pass, grid and camera pass (CUDA events), the peak device memory;
    then one more under torch.profiler with stage markers: launches a
    render, device busy share, top kernels, device ms by stage and the
    gather's share (grid builds plus the gathers)."""
    import numpy as np
    import torch
    from tungsten_tpu_torch.render import render
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**20
    with photon_stages("events") as st:
        img, stats, launches = render_counted(scene, settings, twt, spp)
        split = st.split()
    peak = torch.cuda.max_memory_allocated() / 2**20
    w0 = st.waves[0]
    log(f"  {tag}: {settings.integrator_type} {settings.width}x"
        f"{settings.height} {spp} spp max_bounces {settings.max_bounces} "
        f"photon_count {settings.photon_count} (gather {settings.gather_count}"
        f" within {settings.gather_radius}, volume {settings.vol_photon_type} "
        f"within {settings.vol_gather_radius}): {stats['time']:.3f} s, "
        f"{stats['rays']} rays, {stats['mrays_per_s']:.3f} Mrays/s on {card}; "
        f"launches { {k: v for k, v in launches.items() if v} }; "
        f"{len(st.waves)} photon waves, the first of {w0['rounds']} rounds "
        f"and {w0['paths']} paths: {w0['deposits']} deposits "
        f"({w0['volume']} in the volume), {w0['beams']} beams, "
        f"{w0['planes']} planes; wall split "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items())
        + f"; peak device memory {peak:.1f} MiB ({base:.1f} held before); "
        f"image mean {img.mean():.6f}")
    if not (np.isfinite(img).all() and img.mean() > 0):
        raise AssertionError(f"{tag}: image not finite or black")
    if peak > PEAK_LIMIT_MIB:
        raise AssertionError(f"{tag}: peak device memory {peak:.0f} MiB")
    summ: dict = {}

    def once():
        # sentinel markers open the profile, after a short wait: the
        # profiler drops its first events (9 of the first 108 in a late
        # profile of a long run), and stage_tally pairs the last markers
        torch.cuda.synchronize()
        time.sleep(0.2)
        for _ in range(SENTINELS):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        render(scene, settings, spp=spp, seed=SEED, spp_chunk=spp)

    with photon_stages("markers") as mk:
        prof = profile_render(once, summary=summ, stages=mk.log)
    stages = summ.get("stages")
    if stages is None:
        log(f"  {tag}: {len(mk.log)} stage markers and {SENTINELS} "
            f"sentinels launched, {summ.get('markers')} marker events in "
            f"the profile")
    total = sum(stages.values()) if stages else 0.0
    gather = (stages.get("grid", 0.0) + stages.get("gather", 0.0)) / total \
        if total else None
    summ["gather_share"] = gather
    log(f"  {tag}: {summ.get('launches')} kernel launches a render, device "
        f"idle {summ.get('idle')}; S1 {summ.get('s1_launches')} launches, "
        f"{summ.get('s1_ms')} ms device time; device ms by stage "
        + (", ".join(f"{k} {v:.1f}" for k, v in stages.items())
           if stages else "not measured (markers did not pair)")
        + (f"; grid + gather {gather * 100:.1f} % of kernel time"
           if gather is not None else ""))
    return dict(img=img, stats=stats, launches=launches, split=split,
                waves=st.waves, peak_mib=peak, prof=prof, summary=summ)


def photon_lists_agree(name, scene, settings) -> dict:
    """The first round's photon list (its first PHOTON_LIST_PATHS paths)
    traced on the card and on the CPU: the flags equal on >= 0.999 of
    slots, positions, directions and powers (and the beam and plane
    fields) within rtol 1e-5 / atol 1e-6 on >= 0.95 and within rtol
    1e-3 / atol 1e-4 on >= 0.995 of the slots valid on both (K1's t is
    an ulp off the plain walk's; a photon reflected off a chain of
    curved mirrors after such a hit drifts further, and the shading
    normal's asymmetry factor grows without bound at grazing hits), rays
    within 0.1 %."""
    import numpy as np
    from tungsten_tpu_torch.integrators import photon_map as pm
    from tungsten_tpu_torch.render import PHOTON_CHUNK
    B = max(settings.max_bounces - 1, 1)
    n_paths = min(max(settings.photon_count // B, PHOTON_CHUNK),
                  PHOTON_LIST_PATHS)
    t0 = time.time()
    g = {k: v.cpu().numpy() for k, v in pm.trace_photons(
        scene, settings, n_paths, SEED).items()}
    w = {k: v.numpy() for k, v in pm.trace_photons(
        scene.to("cpu"), settings, n_paths, SEED).items()}
    flags, close, loose, err = {}, {}, {}, {}
    for k in ("valid", "vol", "bounce", "b_valid", "pl_valid"):
        if k in g:
            flags[k] = float((g[k] == w[k]).mean())
    for k, v in (("pos", "valid"), ("dir", "valid"), ("power", "valid"),
                 ("b_o", "b_valid"), ("b_pow", "b_valid"),
                 ("pl_p1", "pl_valid"), ("pl_pow", "pl_valid")):
        m = g[v] & w[v] if k in g else None
        if m is None or not m.any():
            continue
        for d, rtol, atol in ((close, 1e-5, 1e-6), (loose, 1e-3, 1e-4)):
            ok = np.isclose(g[k], w[k], rtol=rtol, atol=atol)
            d[k] = float(ok.reshape(len(ok), -1).all(-1)[m].mean())
        gk, wk = g[k].reshape(len(g[k]), -1), w[k].reshape(len(w[k]), -1)
        rel = np.abs(gk - wk).max(-1) / np.maximum(np.abs(wk).max(-1), 1e-6)
        rel = rel[m]
        err[k] = [float(x) for x in np.quantile(rel, [0.99, 0.999, 1.0])]
    log(f"  {name} photon list ({n_paths} paths x {B} slots, "
        f"{int(w['valid'].sum())} deposits, rays {int(g['rays'])} vs "
        f"{int(w['rays'])}), card vs CPU: flags equal "
        + ", ".join(f"{k} {v:.5f}" for k, v in flags.items())
        + "; within rtol 1e-5 / atol 1e-6 "
        + ", ".join(f"{k} {v:.5f}" for k, v in close.items())
        + "; within rtol 1e-3 / atol 1e-4 "
        + ", ".join(f"{k} {v:.5f}" for k, v in loose.items())
        + "; error over the slot's largest entry, p99 / p99.9 / max "
        + ", ".join(f"{k} {a:.2e} / {b:.2e} / {c:.2e}"
                    for k, (a, b, c) in err.items())
        + f"; {time.time() - t0:.1f} s")
    if not (all(v >= 0.999 for v in flags.values()) and
            all(v >= 0.95 for v in close.values()) and
            all(v >= 0.995 for v in loose.values()) and
            abs(int(g["rays"]) / int(w["rays"]) - 1.0) <= 1e-3):
        raise AssertionError(f"{name}: photon lists disagree")
    return dict(flags=flags, close=close, loose=loose, rel_err=err)


def photon_images_agree(name, scene, settings, walks=None) -> dict:
    """A render on the card and one on the CPU gathered from the same
    photon lists (the card's, copied to the CPU), under phase 6's gates;
    returns the share of pixels off and the means.  `walks`, a list,
    carries the CPU's camera walks from one call to the next (the walk
    does not depend on the volume map): empty, it is filled; else its
    walks are taken in order."""
    import numpy as np
    from tungsten_tpu_torch.integrators import photon_map as pm
    from tungsten_tpu_torch.render import render
    _, spp, _ = PHOTON_SMALL
    orig, orig_walk = pm.trace_photons, pm.camera_walk
    kept = []
    replay_walks = list(walks) if walks else None

    def card(*a, **k):
        out = orig(*a, **k)
        kept.append({x: v.cpu() for x, v in out.items()})
        return out

    def replay(*a, **k):
        return dict(kept.pop(0))

    def cpu_walk(*a, **k):
        if replay_walks is not None:
            return replay_walks.pop(0)
        out = orig_walk(*a, **k)
        if walks is not None:
            walks.append(out)
        return out

    t0 = time.time()
    try:
        pm.trace_photons = card
        gpu = render(scene, settings, spp=spp, seed=SEED, spp_chunk=spp)
        pm.trace_photons = orig
        gpu2 = render(scene, settings, spp=spp, seed=SEED, spp_chunk=spp)
        repeat = soft(same_bits, f"{name} on the card", gpu, gpu2)
        pm.trace_photons, pm.camera_walk = replay, cpu_walk
        cpu = render(scene.to("cpu"), settings, spp=spp, seed=SEED,
                     spp_chunk=spp, device="cpu")
    finally:
        pm.trace_photons, pm.camera_walk = orig, orig_walk
    close = np.isclose(gpu, cpu, rtol=1e-3, atol=1e-4).all(-1)
    off = 1.0 - close.mean()
    rel = abs(gpu.mean() / cpu.mean() - 1.0)
    whole = 1.0 - np.isclose(gpu, cpu, rtol=1e-5, atol=1e-6).all(-1).mean()
    log(f"  {name} {settings.width}x{settings.height} {spp} spp "
        f"max_bounces {settings.max_bounces} from the same photons: "
        f"{off * 100:.3f} % of pixels off by more than rtol 1e-3 (atol "
        f"1e-4), {whole * 100:.3f} % by more than rtol 1e-5, mean "
        f"{gpu.mean():.6f} vs {cpu.mean():.6f} ({rel * 100:.4f} %); a "
        f"second card render bitwise the first: {repeat}; "
        f"{time.time() - t0:.1f} s")
    if not (off <= 0.01 and rel <= 0.005 and gpu.mean() > 0):
        raise AssertionError(f"{name}: card and CPU images disagree")
    return dict(off=off, off_1e5=whole, rel_mean=rel, repeat=repeat)


def check_photon(path, card, twt) -> dict:
    """Phase 17: the photon maps.  (a) the surface map at full width with
    its profile and the path tracer's image of the same scene; (b) PPM;
    (c) the three volume maps on the fog scene, and phase 8's voxel scene
    asked for beams taking the points estimator; (d) the card against
    the CPU on photon lists and on images gathered from one photon list;
    (e) the CLI and the server."""
    import numpy as np
    from tungsten_tpu_torch.ops import segment_sum as tss
    from tungsten_tpu_torch.render import render
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.parse import load_scene
    out = {}
    spath, fpath = write_photon_scenes(
        os.path.join(os.path.dirname(path), "photon"))
    scene, settings = flatten_scene(load_scene(spath))
    if not (settings.integrator_type == "photon_map" and
            not settings.has_env and settings.num_lights == 1 and
            settings.photon_count == 1 << 20):
        raise AssertionError("photon scene off its layout")
    log("  (a) the surface map:")
    a = photon_render(scene, settings, card, twt, SPP, "photon_map")
    if not (a["launches"]["closest"] > 0 and
            set(k for k, v in a["launches"].items() if v) == {"closest"}):
        raise AssertionError(f"photon_map: not K1 alone {a['launches']}")
    pt = render(scene, replace(settings, integrator_type="path_tracer"),
                spp=SPP, seed=SEED, spp_chunk=SPP)
    a["vs_path_tracer"] = a["img"].mean() / pt.mean()
    log(f"  photon map mean {a['img'].mean():.6f} over the path tracer's "
        f"{pt.mean():.6f} (same scene, {SPP} spp): "
        f"{a['vs_path_tracer']:.4f}")
    if not 0.25 < a["vs_path_tracer"] < 4.0:
        raise AssertionError("photon_map: mean far off the path tracer's")
    out["photon"] = a
    log("  (b) progressive photon map:")
    ppm_settings = replace(settings, integrator_type="progressive_photon_map",
                           ppm_alpha=0.3)
    b = photon_render(scene, ppm_settings, card, twt, SPP, "ppm")
    if not (b["launches"]["closest"] > 0 and
            set(k for k, v in b["launches"].items() if v) == {"closest"}):
        raise AssertionError(f"ppm: not K1 alone {b['launches']}")
    b["vs_path_tracer"] = b["img"].mean() / pt.mean()
    log(f"  PPM mean over the path tracer's: {b['vs_path_tracer']:.4f}")
    out["ppm"] = b
    del pt

    log(f"  (c) the volume maps, {PHOTON_VOL_SPP} spp:")
    fscene, fsettings = flatten_scene(load_scene(fpath))
    if not (fsettings.has_media and int(fscene.cam_medium) == 0 and
            fsettings.vol_gather_radius == PHOTON_FOG_RADIUS):
        raise AssertionError("photon fog scene off its layout")
    fsettings = replace(fsettings, max_bounces=PHOTON_VOL_BOUNCES)
    fpt = render(fscene, replace(fsettings, integrator_type="path_tracer"),
                 spp=PHOTON_VOL_SPP, seed=SEED, spp_chunk=PHOTON_VOL_SPP)
    for kind in VOLUME_KINDS:
        tss.LAUNCH_LOG = []   # the volume gathers' S1 launches
        c = photon_render(fscene, replace(fsettings, vol_photon_type=kind),
                          card, twt, PHOTON_VOL_SPP, f"fog {kind}")
        c["s1_log"], tss.LAUNCH_LOG = tss.LAUNCH_LOG, None
        if kind == "points":   # one more render, its largest gather kept
            with LargestGather(tss) as cap:
                render(fscene, replace(fsettings, vol_photon_type=kind),
                       spp=PHOTON_VOL_SPP, seed=SEED,
                       spp_chunk=PHOTON_VOL_SPP)
            c["s1_real"] = cap.best
        ran = set(k for k, v in c["launches"].items() if v)
        want = {"closest", "anyhit"} if kind == "planes" else {"closest"}
        if ran != want:
            raise AssertionError(f"fog {kind}: launched {c['launches']}")
        c["vs_path_tracer"] = c["img"].mean() / fpt.mean()
        out[f"fog_{kind}"] = c
    log("  fog: " + "; ".join(
        f"{k} {out['fog_' + k]['stats']['time']:.3f} s, launches "
        f"{out['fog_' + k]['summary'].get('launches')}, peak "
        f"{out['fog_' + k]['peak_mib']:.0f} MiB, mean "
        f"{out['fog_' + k]['img'].mean():.6f} "
        f"({out['fog_' + k]['vs_path_tracer']:.4f} of the path tracer's "
        f"{fpt.mean():.6f})" for k in VOLUME_KINDS))
    del fpt
    mpath = os.path.join(os.path.dirname(path), "media.json")
    mscene, msettings = flatten_scene(load_scene(mpath))
    res, spp, bounces = PHOTON_SMALL
    vox = replace(msettings, integrator_type="photon_map", width=res,
                  height=res, max_bounces=bounces, gather_radius=0.1,
                  vol_gather_radius=PHOTON_FOG_RADIUS)
    imgs, calls = {}, {}
    for kind in ("beams", "points"):
        with photon_stages("events") as st:
            imgs[kind] = render(mscene, replace(vox, vol_photon_type=kind),
                                spp=1, seed=SEED)
        calls[kind] = {n: c for n, c in st.calls.items() if c}
    log(f"  phase 8's scene (medium kinds {msettings.med_kinds}) asked for "
        f"beams calls {calls['beams']}, asked for points {calls['points']};"
        f" means {imgs['beams'].mean():.6f} vs {imgs['points'].mean():.6f}")
    if not (calls["beams"] == calls["points"] and
            calls["beams"].get("_volume_march", 0) > 0 and
            "build_beam_grid" not in calls["beams"]):
        raise AssertionError("voxel scene asked for beams: not the points "
                             "estimator")
    images_agree("voxel scene, beams vs points", imgs["beams"],
                 imgs["points"], 1e-4, 1e-5, 0.999, 1e-4)
    del mscene

    log(f"  (d) {res}x{res} {spp} spp max_bounces {bounces} (the volume "
        f"maps' images {PHOTON_FOG_CROSS_RES}x{PHOTON_FOG_CROSS_RES}) "
        f"against the CPU:")
    small = dict(width=res, height=res, max_bounces=bounces)
    out["lists"] = {
        "surface": photon_lists_agree("surface", scene,
                                      replace(settings, **small)),
        "fog planes": photon_lists_agree(
            "fog planes", fscene,
            replace(fsettings, vol_photon_type="planes", **small))}
    out["images"] = {}
    walks: list = []
    fog_small = dict(small, width=PHOTON_FOG_CROSS_RES,
                     height=PHOTON_FOG_CROSS_RES)
    for name, sc, st, sm in (
            ("photon_map", scene, settings, small),
            ("ppm", scene, ppm_settings, small),
            *((f"fog {k}", fscene, replace(fsettings, vol_photon_type=k),
               fog_small) for k in VOLUME_KINDS)):
        out["images"][name] = photon_images_agree(
            name, sc, replace(st, photon_count=PHOTON_SMALL_PATHS
                              * (bounces - 1),
                              vol_photon_count=PHOTON_SMALL_VOL, **sm),
            walks if name.startswith("fog") else None)
    del scene, fscene

    log(f"  (e) the CLI ({res}x{res}, {SPP} spp, output buffers) and the "
        f"server:")
    cpath = scene_variant(spath, "photon_cli.json", res=res, spp=SPP,
                          integrator=dict(PHOTON_INTEGRATOR),
                          output_file="photon.png",
                          hdr_output_file="photon.pfm",
                          output_buffers=BUFFER_SPECS)
    out["cli"] = cli_run(cpath, os.path.join(os.path.dirname(spath),
                                             "cli_photon"), twt, res)
    names = sorted(os.path.basename(f) for f in out["cli"]["files"])
    want = sorted(["photon.png", "photon.pfm", "color.pfm",
                   "colorVariance.pfm", "colorA.pfm", "colorB.pfm",
                   "depth.pfm", "normal.pfm", "albedo.pfm", "visibility.pfm"])
    if names != want:
        raise AssertionError(f"photon cli: wrote {names}")
    server_run(scene_variant(spath, "photon_server.json", res=res, spp=2,
                             spp_step=1, integrator=dict(PHOTON_INTEGRATOR)))
    return out


# ------------------------------------------------------------------- MLT

MLT_BOUNCES = 8        # phase 18's depth (the JAX ray estimate's own cap)
MLT_GATE = 0.10        # (a)-(d): image mean against the path tracer's
# (c) on the bidirectional tape: its lengths never measure the camera's
# direct view of an emitter (ROADMAP C-ref 9), and its image sits at
# 0.9053 of the path tracer's on this scene (an H100 at 700 W, 1 and 2
# spp alike; without the direct view, min_bounces 1, the path tracer's
# is 0.9647 of the whole); held to that ratio within MLT_MMLT_BAND
MLT_MMLT_RATIO = 0.905
MLT_MMLT_BAND = 0.02
MLT_SMALL = (64, 2048)  # (e): resolution and chains (one bootstrap batch)
# (e)'s subpath vertices: 5 hold every strategy of a 4-edge path
MLT_CROSS_VERTICES = 5
MLT_CLI_POOL = 4096    # (f): one bootstrap batch of 4,096 chains at 64x64
# (e)'s depth: the card and the CPU part where a hit's rounding picks
# another triangle, which grows with the segments a path has (at 8
# bounces 13 of 8,192 tape traces parted, on the mirror spheres)
MLT_CROSS_BOUNCES = 4
MLT_CLI_SPP = 4        # (f): the CLI's mutations a pixel
# (tag, integrator, bidirectional, mutations a pixel): 8 steps of 8,192
# chains a pass at 256x256
MLT_RUNS = (("mlt_kelemen", "kelemen_mlt", True, 1),
            ("mlt_kelemen_pt", "kelemen_mlt", False, 1),
            ("mlt_multiplexed", "multiplexed_mlt", True, 1),
            ("mlt_rj", "reversible_jump_mlt", False, 1))


def mlt_settings(settings, integ: str, bidirectional: bool, **changes):
    return replace(settings, **dict(dict(
        integrator_type=integ, max_bounces=MLT_BOUNCES,
        mlt_bidirectional=bidirectional), **changes))


def mlt_step(scene, settings):
    """One Metropolis step of the settings' chains from a bootstrap state
    (the work a step repeats), as a function for profile_render."""
    from tungsten_tpu_torch.integrators import mlt
    s = replace(settings, stratified_sampler=False)
    R = mlt._chains(s)
    if s.integrator_type == "multiplexed_mlt":
        s = replace(s, mlt_path_length=2)
    bidi = s.mlt_bidirectional and s.integrator_type != "reversible_jump_mlt"
    if bidi:
        init = mlt._bootstrap_batch_bdpt(scene, s, SEED, 0, R,
                                         mlt.tape_dims_bdpt(s)[1])
        return lambda: mlt._mlt_batch_bdpt(scene, s, SEED, 0, R, 1, *init)
    init = mlt._bootstrap_batch(scene, s, SEED, 0, R, mlt.tape_dims(s))
    prob = s.mlt_strategy_prob \
        if s.integrator_type == "reversible_jump_mlt" else 0.0
    return lambda: mlt._mlt_batch(scene, s, SEED, 0, R, 1, *init,
                                  strategy_prob=prob)


def mlt_render(scene, settings, card, twt, tag: str, spp: int,
               pt_mean: float, whole: bool, expect: float = 1.0,
               gate: float = MLT_GATE) -> dict:
    """An MLT render through render() from zero launch and MLT counts:
    wall, steps, traces, Mrays/s by the JAX estimate beside the rays
    traced, launches, peak device memory, the image mean over the path
    tracer's (`pt_mean`) within `gate` of `expect`; then the render once
    more (`whole`) or one Metropolis step under torch.profiler
    (launches, device busy share)."""
    from tungsten_tpu_torch.render import render
    import numpy as np
    import torch
    from tungsten_tpu_torch.integrators import mlt
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**20
    mlt.zero_counts()
    img, stats, launches = render_counted(scene, settings, twt, spp)
    counts = mlt.read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**20
    ratio = float(img.mean() / pt_mean)
    rel = abs(ratio - 1.0)
    traced = counts["rays"] / max(stats["time"], 1e-9) / 1e6
    log(f"  {tag}: {settings.integrator_type} (bidirectional "
        f"{settings.mlt_bidirectional}) {settings.width}x{settings.height} "
        f"{spp} spp max_bounces {settings.max_bounces} chains "
        f"{min(settings.mlt_chains, settings.width * settings.height)}: "
        f"{stats['time']:.3f} s, {counts['steps']} steps, {counts['traces']}"
        f" tape traces (+{counts['rj_traces']} rj re-traces), "
        f"{counts['accepted']} proposals accepted; {stats['rays']} rays by "
        f"the JAX estimate ({stats['mrays_per_s']:.3f} Mrays/s), "
        f"{counts['rays']} rays traced ({traced:.3f} Mrays/s) on {card}; "
        f"launches { {k: v for k, v in launches.items() if v} }; peak device "
        f"memory {peak:.1f} MiB ({base:.1f} held before); image mean "
        f"{img.mean():.6f}, {ratio:.4f} of the path tracer's {pt_mean:.6f}"
        f" (held to {expect} +- {gate})")
    if counts["rj_traces"]:
        log(f"  {tag}: exchanges proposed on {counts['rj_proposed']} of "
            f"{counts['steps'] * mlt._chains(settings)} chain steps "
            f"({counts['rj_proposed'] / max(counts['steps'] * mlt._chains(settings), 1) * 100:.2f} %), "
            f"both inversions valid on {counts['rj_valid']} "
            f"({counts['rj_valid'] / max(counts['rj_proposed'], 1) * 100:.2f}"
            f" % of those proposed)")
    if not (np.isfinite(img).all() and img.mean() > 0):
        raise AssertionError(f"{tag}: image not finite or black")
    if not (launches["closest"] > 0 and launches["anyhit"] > 0):
        raise AssertionError(f"{tag}: K1 or K2 never launched {launches}")
    if abs(ratio - expect) > gate:
        raise AssertionError(f"{tag}: image mean {ratio:.4f} of the path "
                             f"tracer's, not {expect} +- {gate}")
    summ: dict = {}
    if whole:
        what = "the render"
        held: dict = {}
        prof = profile_render(lambda: held.update(img=render(
            scene, settings, spp=spp, seed=SEED, spp_chunk=spp)),
            summary=summ)
        summ["repeat"] = soft(same_bits, tag, img, held["img"])
        log(f"  {tag}: the profiled render bitwise the first: "
            f"{summ['repeat']}")
    else:
        what = "one step"
        prof = profile_render(mlt_step(scene, settings), summary=summ)
    log(f"  {tag}: {what} under the profiler: {summ.get('launches')} "
        f"kernel launches, device idle {summ.get('idle')}")
    summ["profiled"] = what
    return dict(img=img, stats=stats, counts=counts, launches=launches,
                peak_mib=peak, prof=prof, summary=summ, vs_path_tracer=rel,
                traced_mrays_per_s=traced)


def share_close(a, b, rtol=1e-4, atol=1e-6) -> float:
    """The share of leading-index entries of a (card) within the tolerance
    of b (CPU) over all their trailing entries (ints and bools equal)."""
    import numpy as np
    a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
    b = b.cpu().numpy() if hasattr(b, "cpu") else np.asarray(b)
    if a.dtype.kind in "biu":
        ok = a.astype(np.int64) == b.astype(np.int64)
    else:
        ok = np.isclose(a, b, rtol=rtol, atol=atol)
    return float(ok.reshape(ok.shape[0], -1).all(-1).mean())


def mlt_lanes_agree(scene, settings) -> dict:
    """The lane-identity check: trace_tape and trace_tape_rj of 8,192
    chains (256x256, the path tracer's tape, MLT_CROSS_BOUNCES) on the
    card, whose body sorts its rays and whose staged loop compacts (the
    traversal launches' widths show it), against the CPU, lane for lane;
    beside it the same card lanes against the CPU's lanes shifted by one
    (what a lane reading another chain's row would give)."""
    import torch
    from tungsten_tpu_torch.integrators import mlt
    from tungsten_tpu_torch.ops import wave_trace as twt
    s = mlt_settings(settings, "reversible_jump_mlt", False,
                     stratified_sampler=False, max_bounces=MLT_CROSS_BOUNCES)
    R = mlt._chains(s)
    tape = mlt._uniform_tape(SEED ^ 0x1A4E, 0, 0, R, mlt.tape_dims(s),
                             scene.device)
    b_pick = torch.clamp(
        (mlt._uniform_tape(SEED ^ 0xB1C, 0, 0, R, 1, scene.device)[:, 0]
         * s.max_bounces).to(torch.int32), max=s.max_bounces - 1)
    cpu = scene.to("cpu")
    out = {}
    t0 = time.time()
    twt.LAUNCH_LOG = []
    try:
        gpu = mlt.trace_tape(scene, s, tape, SEED)
        widths = sorted({rays for _, rays, _ in twt.LAUNCH_LOG}, reverse=True)
    finally:
        twt.LAUNCH_LOG = None
    ref = mlt.trace_tape(cpu, s, tape.cpu(), SEED)
    out["trace_tape"] = min(share_close(gpu[0], ref[0]),
                            share_close(gpu[1], ref[1]))
    out["trace_tape_1e-3"] = share_close(gpu[0], ref[0], 1e-3, 1e-4)
    out["shifted"] = share_close(gpu[0], torch.roll(ref[0], 1, 0))
    out["widths"] = widths
    gpu = mlt.trace_tape_rj(scene, s, tape, b_pick, SEED)
    ref = mlt.trace_tape_rj(cpu, s, tape.cpu(), b_pick.cpu(), SEED)
    out["rj_flags"] = min(share_close(gpu[1], ref[1]),
                          share_close(gpu[3], ref[3]))
    out["rj_dims"] = min(share_close(gpu[0], ref[0], 1e-4, 1e-5),
                         share_close(gpu[2], ref[2], 1e-4, 1e-5))
    out["rj_valid_share"] = float(gpu[1].float().mean())
    out["rj_rev_valid_share"] = float(gpu[3].float().mean())
    log(f"  lane identity, {R} chains at max_bounces {s.max_bounces}, "
        f"traversal launch widths {widths}: trace_tape radiance and pixel "
        f"within rtol 1e-4 / atol 1e-6 on {out['trace_tape'] * 100:.3f} % of "
        f"lanes (rtol 1e-3 / atol 1e-4: {out['trace_tape_1e-3'] * 100:.3f} "
        f"%; against the CPU's lanes shifted by one: "
        f"{out['shifted'] * 100:.3f} %); "
        f"trace_tape_rj flags equal on {out['rj_flags'] * 100:.3f} %, "
        f"rj_dims / rj_nee within rtol 1e-4 / atol 1e-5 on "
        f"{out['rj_dims'] * 100:.3f} % (forward inversion valid on "
        f"{out['rj_valid_share'] * 100:.2f} %, reverse on "
        f"{out['rj_rev_valid_share'] * 100:.2f} %), {time.time() - t0:.1f} s")
    if not (out["trace_tape"] >= 0.999 and out["rj_flags"] >= 0.999 and
            out["rj_dims"] >= 0.999 and min(widths) < R):
        raise AssertionError("mlt: card lanes disagree with the CPU's")
    return out


def mlt_chains_agree(scene, settings) -> dict:
    """kelemen_mlt at MLT_SMALL on the card against the CPU plain path:
    the bootstrap pool's luminances and b, the first step's proposal
    luminances and acceptances from the same chain states, the chains'
    states after the last step, and the images from those steps."""
    import numpy as np
    import torch
    from tungsten_tpu_torch.integrators import mlt
    res, chains = MLT_SMALL
    s = mlt_settings(settings, "kelemen_mlt", True, width=res, height=res,
                     mlt_chains=chains, mlt_sample_pool=chains,
                     stratified_sampler=False, max_bounces=MLT_CROSS_BOUNCES,
                     bdpt_vertices=MLT_CROSS_VERTICES)
    R = mlt._chains(s)
    n = res * res
    D = mlt.tape_dims_bdpt(s)[1]
    cpu = scene.to("cpu")
    t0 = time.time()
    pool_b = max(1, min(s.mlt_sample_pool, 4 * R) // R)
    pools = {}
    for name, sc in (("card", scene), ("cpu", cpu)):
        pools[name] = [mlt._bootstrap_batch_bdpt(sc, s, SEED, pb, R, D)
                       for pb in range(pool_b)]
    lum = {k: torch.cat([p[-1] for p in v]).cpu() for k, v in pools.items()}
    pool_share = share_close(lum["card"], lum["cpu"])
    b = {k: float(torch.mean(v)) for k, v in lum.items()}
    idx = mlt._resample(lum["cpu"], (SEED & 0xFFFFFFFF) ^ 0x5EED, 0, R)
    init = tuple(torch.cat([p[k] for p in pools["cpu"]])[idx]
                 for k in range(len(pools["cpu"][0])))
    n_steps = max(1, n // R)
    first, final, fbs = {}, {}, {}
    for name, sc in (("card", scene), ("cpu", cpu)):
        def rec(i, prop_lum, accept, name=name):
            if i == 0:
                first[name] = (prop_lum.cpu(), accept.cpu())
        fb, tape, lum_end = mlt._mlt_batch_bdpt(
            sc, s, SEED, 0, R, n_steps,
            *(v.to(sc.device) for v in init), on_step=rec)
        final[name] = (tape.cpu(), lum_end.cpu())
        fbs[name] = fb.cpu().numpy() * b[name] * n / (R * n_steps)
    prop_ok = np.isclose(first["card"][0].numpy(), first["cpu"][0].numpy(),
                         rtol=1e-4, atol=1e-6) & \
        (first["card"][1].numpy() == first["cpu"][1].numpy())
    same = (np.abs(final["card"][0].numpy() - final["cpu"][0].numpy())
            .max(-1) <= 1e-6) & np.isclose(final["card"][1].numpy(),
                                           final["cpu"][1].numpy(),
                                           rtol=1e-4, atol=1e-6)
    rel_b = abs(b["card"] / b["cpu"] - 1.0)
    rel_img = abs(fbs["card"].mean() / fbs["cpu"].mean() - 1.0)
    out = dict(pool=pool_share, b_card=b["card"], b_cpu=b["cpu"], b_rel=rel_b,
               first_step=float(prop_ok.mean()),
               same_state=float(same.mean()), steps=n_steps,
               image_rel=rel_img,
               accepted_first=float(first["cpu"][1].float().mean()))
    log(f"  kelemen_mlt {res}x{res} max_bounces {s.max_bounces}, {R} chains, "
        f"{pool_b} bootstrap batches,"
        f" {n_steps} steps, card against the CPU: pool luminance within rtol"
        f" 1e-4 on {pool_share * 100:.3f} % of samples; b {b['card']:.6f} "
        f"vs {b['cpu']:.6f} ({rel_b:.2e}); first step's proposal luminance "
        f"and acceptance agree on {prop_ok.mean() * 100:.3f} % of chains "
        f"({out['accepted_first'] * 100:.1f} % accepted); chains in the "
        f"same state after step {n_steps}: {same.mean() * 100:.3f} %; image "
        f"means {fbs['card'].mean():.6f} vs {fbs['cpu'].mean():.6f} "
        f"({rel_img * 100:.3f} %), {time.time() - t0:.1f} s")
    if not (pool_share >= 0.999 and rel_b <= 1e-4 and prop_ok.mean() >= 0.99
            and rel_img <= 0.02):
        raise AssertionError("mlt: the card's chains disagree with the CPU's")
    return out


def check_mlt(path, card, twt) -> dict:
    """Phase 18: the MLT family on the smoke scene through render() at
    256x256 with 8,192 chains (a-d), the card against the CPU (e), the
    CLI and the server (f)."""
    import numpy as np
    from tungsten_tpu_torch.integrators import mlt
    from tungsten_tpu_torch.render import render
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.parse import load_scene
    out = {}
    t0 = time.time()
    scene, settings = flatten_scene(load_scene(path))
    pt = render(scene, replace(settings, max_bounces=MLT_BOUNCES),
                spp=SPP, seed=SEED, spp_chunk=SPP)
    log(f"  the path tracer at max_bounces {MLT_BOUNCES}: image mean "
        f"{pt.mean():.6f} ({time.time() - t0:.1f} s)")
    for part, (tag, integ, bidi, spp) in zip("abcd", MLT_RUNS):
        t1 = time.time()
        log(f"  ({part}) {integ}, bidirectional {bidi}:")
        c_ref9 = integ == "multiplexed_mlt" and bidi
        out[tag] = mlt_render(
            scene, mlt_settings(settings, integ, bidi), card, twt, tag, spp,
            float(pt.mean()), whole=part == "a",
            expect=MLT_MMLT_RATIO if c_ref9 else 1.0,
            gate=MLT_MMLT_BAND if c_ref9 else MLT_GATE)
        if integ == "multiplexed_mlt":
            res, _ = MLT_SMALL
            small = mlt_settings(settings, integ, False, width=res,
                                 height=res)
            st: dict = {}
            zero_counts()
            img, rays = mlt.render_pass_mmlt(scene, small, 0, SEED,
                                             stats=st)
            got = read_counts()
            img = img.cpu().numpy()
            rel = abs(img.mean() / pt.mean() - 1.0)
            log(f"  (c) multiplexed_mlt on the path tracer's tape, {res}x"
                f"{res}: b_k {[round(x, 6) for x in st['b_k']]}, steps by "
                f"length {st['steps_k']}, {st['traces']} traces, image mean "
                f"{img.mean():.6f} against the path tracer's {pt.mean():.6f}"
                f": {rel * 100:.3f} % apart, launches {got}")
            if not (np.isfinite(img).all() and img.mean() > 0 and
                    sum(1 for x in st["steps_k"] if x) >= 2 and
                    rel <= MLT_GATE):
                raise AssertionError("mmlt on the path tracer's tape")
            out["mlt_multiplexed_pt"] = dict(b_k=st["b_k"],
                                             steps_k=st["steps_k"],
                                             launches=got,
                                             vs_path_tracer=rel)
        log(f"  [({part}): {time.time() - t1:.1f} s]")
    t1 = time.time()
    log(f"  (e) the card against the CPU plain path:")
    out["lanes"] = mlt_lanes_agree(scene, settings)
    out["chains"] = mlt_chains_agree(scene, settings)
    del scene
    log(f"  [(e): {time.time() - t1:.1f} s]")
    t1 = time.time()
    res, _ = MLT_SMALL
    integ = {"type": "kelemen_mlt", "max_bounces": MLT_BOUNCES,
             "initial_sample_pool": MLT_CLI_POOL}
    log(f"  (f) the CLI ({res}x{res}, {MLT_CLI_SPP} spp, output buffers) and"
        f" the server:")
    cpath = scene_variant(path, "mlt_cli.json", res=res, spp=MLT_CLI_SPP,
                          integrator=integ, output_file="mlt.png",
                          hdr_output_file="mlt.pfm",
                          output_buffers=BUFFER_SPECS)
    out["cli"] = cli_run(cpath, os.path.join(os.path.dirname(path),
                                             "cli_mlt"), twt, res)
    names = sorted(os.path.basename(f) for f in out["cli"]["files"])
    want = sorted(["mlt.png", "mlt.pfm", "color.pfm", "colorVariance.pfm",
                   "colorA.pfm", "colorB.pfm", "depth.pfm", "normal.pfm",
                   "albedo.pfm", "visibility.pfm"])
    if names != want:
        raise AssertionError(f"mlt cli: wrote {names}")
    server_run(scene_variant(path, "mlt_server.json", res=res, spp=2,
                             spp_step=1, integrator=integ))
    log(f"  [(f): {time.time() - t1:.1f} s]")
    return out


# -------------------------------------------------------------------- main

# ------------------------------------------------------------ OBJ meshes

OBJ_SMALL = (64, 4)    # phase 19(d): the CLI's resolution and spp


def same_scene(a, b) -> list:
    """The FlatScene fields where two scenes differ (tensors bitwise)."""
    import torch
    from dataclasses import fields
    from tungsten_tpu_torch.scene.flatten import FlatScene
    off = []
    for f in fields(FlatScene):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            ok = x.dtype == y.dtype and torch.equal(x, y)
        elif isinstance(x, (list, tuple)):
            ok = len(x) == len(y) and all(torch.equal(p, q)
                                          for p, q in zip(x, y))
        else:
            ok = x == y
        if not ok:
            off.append(f.name)
    return off


def check_obj(tmp, path, img, img2, launches, card, twt) -> dict:
    """Phase 19: the smoke scene with its spheres as exporter-style OBJ
    files, through both loaders, flatten, render, the CLI and the
    server, against phase 3's .wo3 scene and phase 5's render."""
    import numpy as np
    import torch
    from tungsten_tpu_torch.integrators.path_tracer import trace_wave
    from tungsten_tpu_torch.io import mesh as tmesh
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.parse import load_scene
    t0 = time.time()
    odir = os.path.join(tmp, "obj_scene")
    os.makedirs(odir)
    opath = write_scene(odir, mesh_ext="obj")
    files = sorted(f for f in os.listdir(odir) if f.endswith(".obj"))
    mb = sum(os.path.getsize(os.path.join(odir, f)) for f in files) / 2**20
    log(f"  (a) {len(files)} OBJ files written ({mb:.1f} MiB) in "
        f"{time.time() - t0:.2f} s")
    # (b) the two loaders on every file, against the sphere's arrays
    pos, nrm, uv, idx = uv_sphere(SEG_U, SEG_V)
    t_nat = t_py = 0.0
    for fn in files:
        t0 = time.time()
        nat = tmesh.load_obj(os.path.join(odir, fn))
        t_nat += time.time() - t0
        t0 = time.time()
        py = tmesh.load_obj_python(os.path.join(odir, fn))
        t_py += time.time() - t0
        for k in ("pos", "normal", "uv", "indices", "material"):
            if getattr(nat, k).tobytes() != getattr(py, k).tobytes():
                raise AssertionError(f"OBJ: {fn}: the loaders' {k} differ")
        if not (np.array_equal(nat.pos[nat.indices], pos[idx]) and
                np.array_equal(nat.normal[nat.indices], nrm[idx]) and
                np.array_equal(nat.uv[nat.indices], uv[idx]) and
                not nat.material.any()):
            raise AssertionError(f"OBJ: {fn}: triangles off the mesh's")
    log(f"  (b) native loader {t_nat:.3f} s, Python loader {t_py:.3f} s "
        f"for the {len(files)} files (host CPU); both Meshes equal "
        f"bitwise, {nat.pos.shape[0]} vertices and {nat.num_tris} "
        f"triangles a file, each triangle's corners the .wo3 mesh's")
    # (c) flatten on the card, against phase 3's scene field for field
    t0 = time.time()
    oscene, osettings = flatten_scene(load_scene(opath))
    torch.cuda.synchronize()
    t_flat = time.time() - t0
    scene, settings = flatten_scene(load_scene(path))
    n_tri = int(oscene.tri_v0.shape[0])
    off = same_scene(oscene, scene)
    log(f"  (c) flatten {t_flat:.2f} s: {n_tri} triangles, walk "
        f"{twt.traversal_kind(oscene)}; fields off the .wo3 scene's: "
        f"{off or 'none'}; settings equal {osettings == settings}")
    if off or osettings != settings or n_tri != 95_236:
        raise AssertionError("OBJ: the flattened scene is not the .wo3 "
                             "scene's")
    # (d) the main path's render, counts from zero
    oimg, ostats, olaunches = render_counted(oscene, osettings, twt)
    equal = bool(np.array_equal(oimg, img))
    repeat = bool(np.array_equal(img2, img))
    log(f"  (d) {osettings.width}x{osettings.height} {SPP} spp max_bounces "
        f"{osettings.max_bounces}: {ostats['time']:.3f} s, "
        f"{ostats['rays']} rays, {ostats['mrays_per_s']:.3f} Mrays/s on "
        f"{card}; launches {olaunches} (phase 5: {launches}); image "
        f"bitwise equal to phase 5's: {equal} (max |diff| "
        f"{float(np.abs(oimg - img).max()):.3e}); phase 5's second render "
        f"bitwise equal to its first: {repeat} (max |diff| "
        f"{float(np.abs(img2 - img).max()):.3e})")
    if not (olaunches["closest"] > 0 and olaunches["anyhit"] > 0):
        raise AssertionError(f"OBJ render: a kernel never launched "
                             f"{olaunches}")
    if any(olaunches[k] != launches[k] for k in launches):
        raise AssertionError("OBJ render: launches differ from phase 5's")
    # the lanes the frame sums: both scenes' bitwise too
    pixel, sample = wave_ids(settings, SPP, oscene.device)
    t0 = time.time()
    lanes = [trace_wave(s, settings, pixel, sample, SEED)
             for s in (oscene, scene)]
    lanes_equal = bool(torch.equal(lanes[0], lanes[1]))
    log(f"  (d) the wave's {pixel.shape[0]} lanes traced on both scenes "
        f"({time.time() - t0:.2f} s): radiance bitwise equal "
        f"{lanes_equal}")
    if not lanes_equal:
        raise AssertionError("OBJ render: lanes differ from the .wo3 "
                             "scene's")
    soft(same_bits, "OBJ render against phase 5's", img, oimg)
    del lanes, oscene, scene
    # (e) the entry points
    res, spp = OBJ_SMALL
    bpath = scene_variant(opath, "obj_buffers.json", res=res, spp=spp,
                          output_file="obj.png", hdr_output_file="obj.pfm",
                          output_buffers=BUFFER_SPECS)
    cli = cli_run(bpath, os.path.join(tmp, "cli_obj"), twt, res)
    server_run(scene_variant(opath, "obj_server.json", res=res, spp=8,
                             spp_step=4))
    return {"launches": olaunches, "stats": ostats, "image_equal": equal,
            "phase5_repeatable": repeat, "lanes_equal": lanes_equal,
            "load_native_s": t_nat, "load_python_s": t_py,
            "flatten_s": t_flat, "cli": cli}


# ------------------------------------------------------ ordered sums (S1)

# the bank's shape: the smoke wave's 1,048,576 rays banked into its
# 65,536 pixels (16 samples a pixel), shuffled as the body sort leaves
# them; the tile sums' f64 outputs (256x256 in 4x4 tiles)
S1_PIXELS, S1_SAMPLES = RES * RES, SPP
S1_TILES = (RES // 4) ** 2
# the scans' shapes: choose_light's (lanes, lights) rows, the MLT pool's
# CDF over its 10,000 entries, a raymarch's (lanes, 96 steps) rows
S1_SCANS = (((1 << 20, 4), -1), ((10000,), 0), ((65536, 96), 1))
# choose_light's rows past 256 lights (f32): many rows longer than the
# rows path's 256, which the rows path still takes
S1_LONG_ROWS = (1 << 20, 300)
S1_TOL = ("vs the plain version (index_add_ of the rows in S1's order, "
          "on the CPU) on the same inputs: bitwise equal, f32 and f64, "
          "sorted, unsorted, keyed, grouped and unique ids, empty and "
          "long segments, the largest real fog-points gather; max_abs_err "
          "0")
SCAN_TOL = ("vs torch.cumsum on the CPU (float rows accumulated in double) "
            "on the same inputs: bitwise equal, f32 and f64, both paths, "
            "left to right and right to left (the backward vs the CPU's), "
            "narrow-span inputs on the long path's exact parallel scan and "
            "wide-span ones on its refold; max_abs_err 0")
# phase 5: the ordered accumulation may add at most this share of the
# render's wall (its device time against index_add_ / torch.cumsum on
# the same inputs)
S1_COST_SHARE = 0.03


def s1_bound_ms(P: int, C: int, N: int, item: int, perm: bool) -> float:
    """S1's least time: the ids (and perm) and values read once, the
    output rows read and written once, over the card's memory rate (its
    P * C adds are far below the f32 rate)."""
    return (P * 8 * (2 if perm else 1) + P * C * item
            + 2 * N * C * item) / PEAK_BYTES * 1e3


def s1_case(tss, name, idx, v, out0, key=None, grouped=False) -> dict:
    """ordered_index_add on the card against the plain version on the
    CPU (the rows in the order S1 adds them), bitwise; then S1 alone, the
    wrapper (sort + S1), index_add_ on the same card tensors (the
    library call) and the plain version on the CPU, timed, and the bytes
    bound."""
    import torch
    dev = torch.device("cuda")
    ci, cv, ck = idx.to(dev), v.to(dev), None if key is None else \
        key.to(dev)
    got = tss.ordered_index_add(out0.clone().to(dev), ci, cv, key=ck,
                                grouped=grouped).cpu()
    seg, perm = (idx, None) if grouped else tss.sort_rows(idx, key)
    t0 = time.perf_counter()
    want = tss.segment_sum_plain(out0.clone(), seg, v, perm)
    plain_ms = (time.perf_counter() - t0) * 1e3
    equal = bool(torch.equal(got, want))
    err = float((got.double() - want.double()).abs().max())
    nonempty = int(torch.unique(idx).numel())
    longest = int(torch.bincount(idx.clamp(min=0)).max())
    r = dict(rows=int(v.shape[0]), cols=int(v[0].numel()),
             outputs=int(out0.shape[0]), nonempty=nonempty,
             longest=longest, dtype=str(v.dtype).replace("torch.", ""),
             equal=equal, max_abs_err=err)
    if not equal:
        raise AssertionError(f"S1 {name}: not bitwise the plain version "
                             f"(max |diff| {err:.3e})")
    out = out0.clone().to(dev)
    sseg, sperm = (ci, None) if grouped else tss.sort_rows(ci, ck)

    def kernel():
        tss.segment_sum_kernel(out, sseg, cv, sperm)

    def library():
        out.index_add_(0, ci, cv)

    r["ms"] = device_ms(kernel)
    r["wrapper_ms"] = device_ms(lambda: tss.ordered_index_add(
        out, ci, cv, key=ck, grouped=grouped))
    r["library_ms"] = device_ms(library)
    r["plain_ms"] = plain_ms
    r["bound_ms"] = s1_bound_ms(r["rows"], r["cols"], r["outputs"],
                                v.element_size(), not grouped)
    log(f"  S1 {name}: {r['rows']} rows x {r['cols']} {r['dtype']} into "
        f"{r['outputs']} outputs ({nonempty} non-empty, the longest "
        f"{longest} rows): bitwise the plain version; device ms a call: S1 "
        f"{r['ms']:.4f}" + (f", with the sort {r['wrapper_ms']:.4f}"
                            if not grouped else "") +
        f", index_add_ {r['library_ms']:.4f}, bound {r['bound_ms']:.4f} "
        f"(bytes); plain (CPU) {plain_ms:.1f} ms")
    return r


def scan_case(tss, name, x, dim=-1, counted=False) -> dict:
    """The ordered scan on the card along `dim` of x (CPU), left to right
    and right to left, against torch.cumsum on the CPU (flip, cumsum,
    flip for the right to left), bitwise; then both directions,
    torch.cumsum on the same card tensor and the plain version (CPU)
    timed, and the bytes bound (x read once, y written once).  With
    `counted`, the long path's chunks taken exact and refolded."""
    import torch
    dev = torch.device("cuda")
    xl = x.movedim(dim, -1).contiguous()
    cx = xl.to(dev)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    got = tss.ordered_scan_kernel(cx, counts=counts if counted else None)
    back = tss.ordered_scan_kernel(cx, reverse=True)
    t0 = time.perf_counter()
    want = torch.cumsum(xl, -1)
    plain_ms = (time.perf_counter() - t0) * 1e3
    equal = (got.cpu().numpy().tobytes() == want.numpy().tobytes() and
             back.cpu().numpy().tobytes() ==
             torch.cumsum(xl.flip(-1), -1).flip(-1).numpy().tobytes())
    if not equal:
        raise AssertionError(f"S1 scan {name}: not bitwise torch.cumsum on "
                             f"the CPU")

    def kernel():
        tss.ordered_scan_kernel(cx)

    def library():
        torch.cumsum(cx, -1)

    r = dict(shape=list(x.shape), dim=dim, dtype=str(x.dtype).replace(
        "torch.", ""), path=tss.scan_path(cx), equal=equal,
        ms=device_ms(kernel),
        reverse_ms=device_ms(lambda: tss.ordered_scan_kernel(
            cx, reverse=True)),
        library_ms=device_ms(library), plain_ms=plain_ms,
        bound_ms=2 * x.numel() * x.element_size() / PEAK_BYTES * 1e3)
    if counted:
        r["chunks_exact"], r["chunks_refolded"] = counts.tolist()
    log(f"  S1 scan {name}: {tuple(x.shape)} {r['dtype']} along {dim} "
        f"({r['path']} path" + (
            f"; chunks exact {r['chunks_exact']}, refolded "
            f"{r['chunks_refolded']}" if counted else "") +
        f"): bitwise torch.cumsum on the CPU both ways; device ms a call "
        f"{r['ms']:.4f}, right to left {r['reverse_ms']:.4f}, torch.cumsum "
        f"{r['library_ms']:.4f}, bound {r['bound_ms']:.5f} (bytes); plain "
        f"(CPU) {plain_ms:.2f} ms")
    return r


def check_segment_sum(tss) -> dict:
    """Phase 2c: S1 and its scan entry on seeded inputs against their
    plain versions on the CPU, bitwise, and timed."""
    import numpy as np
    import torch
    g = np.random.default_rng(SEED & 0xFFFF)
    out = {}
    # (1) the bank: a pixel's 16 samples, rays shuffled, keyed by
    # (pixel, sample) as path_tracer.bank keys them on the card
    P = S1_PIXELS * S1_SAMPLES
    sh = torch.from_numpy(g.permutation(P))
    pixel = torch.arange(S1_PIXELS).repeat(S1_SAMPLES)[sh]
    sample = torch.arange(S1_SAMPLES).repeat_interleave(S1_PIXELS)[sh]
    v = torch.from_numpy((g.standard_normal((P, 3)) * 10.0 ** g.integers(
        -3, 3, size=(P, 1))).astype(np.float32))
    out["bank"] = s1_case(tss, "bank (pixel, sample keys)", pixel, v,
                          torch.zeros((S1_PIXELS, 3)),
                          key=(pixel << 31) | sample)
    # (2) f64 tile sums on unsorted tile ids
    tile = torch.from_numpy(g.integers(0, S1_TILES, P))
    out["tiles"] = s1_case(tss, "f64 tile sums", tile, v[:, :3].double(),
                           torch.zeros((S1_TILES, 3), dtype=torch.float64))
    # (3) sorted ids, most outputs empty, one segment of 200,000 rows,
    # into a non-zero output (the gathers add into a running sum)
    n_out = 100_000
    ids = torch.from_numpy(np.sort(np.concatenate([
        g.choice(np.arange(0, n_out, 3), P - 200_000),
        np.full(200_000, 4242)])))
    for dt in (torch.float32, torch.float64):
        out[f"sorted_{dt}"] = s1_case(
            tss, f"sorted ids, empty and long segments ({dt})", ids,
            v.to(dt), torch.from_numpy(g.standard_normal(
                (n_out, 3))).to(dt), grouped=True)
    # (4) unique lanes, unsorted (the lane banks), 7 columns
    lanes = torch.from_numpy(g.permutation(P))
    out["lanes"] = s1_case(tss, "unique unsorted lanes", lanes,
                           torch.cat([v, v, v[:, :1]], 1),
                           torch.zeros((P, 7)), grouped=True)
    # (5) the scan entry against torch.cumsum on the CPU, both ways, at
    # each shape in f32 and f64; the MLT pool's shape on a narrow-span
    # input (integers / 64: every partial sum exact) and a wide-span one
    scans = []
    for shape, dim in S1_SCANS:
        for dt in (torch.float32, torch.float64):
            x = torch.from_numpy(g.standard_normal(shape) * 1e3).to(dt)
            scans.append(scan_case(tss, f"{tuple(shape)}", x, dim))
    n = S1_SCANS[1][0][0]
    for kind, x in (("narrow", g.integers(-1000, 1000, n) / 64),
                    ("wide", g.standard_normal(n) *
                     10.0 ** g.uniform(-12, 12, n))):
        r = scan_case(tss, f"({n},) {kind}-span",
                      torch.from_numpy(x).float(), counted=True)
        r["span"] = kind
        if (r["chunks_exact"] == 0) != (kind == "wide") or (
                r["chunks_refolded"] == 0) != (kind == "narrow"):
            raise AssertionError(f"S1 scan {kind}-span: chunks exact / "
                                 f"refolded {r['chunks_exact']} / "
                                 f"{r['chunks_refolded']}")
        scans.append(r)
    x = torch.from_numpy(g.standard_normal(S1_LONG_ROWS, dtype=np.float32)
                         * np.float32(1e3))
    scans.append(scan_case(tss, f"{S1_LONG_ROWS}, rows past 256", x))
    del x
    x = torch.from_numpy(g.standard_normal((4096, 8))).float()
    xh = x.clone().requires_grad_()
    xc = x.clone().to("cuda").requires_grad_()
    w = torch.from_numpy(g.standard_normal((4096, 8))).float()
    (tss.ordered_cumsum(xc, -1) * w.to("cuda")).sum().backward()
    (torch.cumsum(xh, -1) * w).sum().backward()
    if not torch.equal(xc.grad.cpu(), xh.grad):
        raise AssertionError("S1 scan: backward not bitwise the CPU's")
    log("  S1 scan: the backward (one right-to-left launch) bitwise the "
        "CPU's")
    out["scans"] = scans
    return out


class LargestGather:
    """While active, keeps the inputs of the largest grouped S1 launch
    (rows x columns): its ids, values and output as the launch found
    them, on the CPU, and counts the grouped launches."""

    def __init__(self, tss):
        self.tss, self.best, self.launches = tss, None, 0

    def __enter__(self):
        self.kernel = self.tss.segment_sum_kernel

        def keep(out, seg, v, perm=None):
            if perm is None:
                self.launches += 1
                size = v.shape[0] * v[0].numel()
                if self.best is None or size > self.best["size"]:
                    self.best = dict(size=size, seg=seg.cpu(), v=v.cpu(),
                                     out=out.cpu())
            return self.kernel(out, seg, v, perm)

        self.tss.segment_sum_kernel = keep
        return self

    def __exit__(self, *exc):
        self.tss.segment_sum_kernel = self.kernel


class ScanCensus:
    """While active, every ordered scan on the card hands the kernel a
    counts tensor (the long path's chunks taken exact and refolded, summed
    over the launches) and is tallied by its rows, length, type and
    path."""

    def __init__(self, tss):
        self.tss, self.shapes = tss, {}

    def __enter__(self):
        import torch
        self.kernel = self.tss.ordered_scan_kernel
        self.counts = torch.zeros(2, dtype=torch.int64, device="cuda")

        def count(x, reverse=False, counts=None):
            L = x.shape[-1] if x.ndim else 1
            key = (x.numel() // max(L, 1), L,
                   str(x.dtype).replace("torch.", ""), self.tss.scan_path(x))
            self.shapes[key] = self.shapes.get(key, 0) + 1
            return self.kernel(x, reverse, counts=self.counts)

        self.tss.ordered_scan_kernel = count
        return self

    def __exit__(self, *exc):
        self.tss.ordered_scan_kernel = self.kernel

    def summary(self) -> dict:
        exact, refolded = self.counts.tolist()
        return dict(
            launches=sum(self.shapes.values()),
            long_launches=sum(n for k, n in self.shapes.items()
                              if k[3] == "long"),
            chunks_exact=exact, chunks_refolded=refolded,
            exact_share=exact / max(exact + refolded, 1),
            shapes=[list(k) + [n] for k, n in sorted(self.shapes.items())])


def log_census(tag, c) -> None:
    log(f"  {tag}: {c['launches']} scan launches, {c['long_launches']} on "
        f"the long path; its chunks exact {c['chunks_exact']}, refolded "
        f"{c['chunks_refolded']} (exact share {c['exact_share']:.4f}); "
        f"(rows, length, type, path, launches): {c['shapes']}")


def denoise_scans(path, card, tss) -> dict:
    """The denoiser (tools/denoiser.py::nfor_denoise) on the card on the
    smoke scene's two-buffer outputs (RES, SPP), under ScanCensus: its
    box filters' scans, the frame's rows plus the filter's pad.  The
    result finite, non-negative, the frame's shape."""
    import numpy as np
    from tungsten_tpu_torch.render import render_denoise_buffers
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.parse import load_scene
    from tungsten_tpu_torch.tools.denoiser import nfor_denoise
    scene, settings = flatten_scene(load_scene(path))
    d = render_denoise_buffers(scene, settings, spp=SPP, seed=SEED)
    t0 = time.time()
    with ScanCensus(tss) as c:
        img = nfor_denoise(d["color_a"], d["color_b"], d["color_var"],
                           d["feat_a"], d["feat_b"], d["feat_var"],
                           device="cuda")
    r = c.summary()
    r["s"] = time.time() - t0
    if not (img.shape == (RES, RES, 3) and np.isfinite(img).all() and
            img.min() >= 0 and img.mean() > 0):
        raise AssertionError("denoiser: output not finite, of the wrong "
                             "shape or black")
    log(f"  nfor_denoise at {RES}x{RES} on {card}: {r['s']:.2f} s, mean "
        f"{img.mean():.6f}")
    log_census("its scans", r)
    return r


def s1_gather_timing(tss, launch, real) -> dict:
    """S1 on the largest grouped launch of phase 17's fog points render
    as captured (`real`: its ids, values and output), and at that
    launch's shape (rows, columns, outputs) on seeded uniform sorted ids:
    each against the plain version (bitwise) and timed."""
    import numpy as np
    import torch
    _, P, C, N, _, _ = launch
    g = np.random.default_rng((SEED >> 8) & 0xFFFF)
    ids = torch.from_numpy(np.sort(g.integers(0, N, P)))
    v = torch.from_numpy(g.standard_normal((P, C)).astype(np.float32))
    r = s1_case(tss, "a photon gather's shape, uniform ids", ids, v,
                torch.zeros((N, C)), grouped=True)
    r["real"] = s1_case(tss, "the largest fog-points gather, captured",
                        real["seg"], real["v"], real["out"], grouped=True)
    return r


def ordered_cost(render_once) -> dict:
    """The main path's ordered sums (path_tracer.bank's index_sums and
    choose_light's ordered_cumsum) captured from one render and replayed:
    their device ms against index_add_ (one a bank field, as the bank
    summed before) and torch.cumsum on the same inputs."""
    import torch
    from tungsten_tpu_torch.integrators import lights
    from tungsten_tpu_torch.integrators import path_tracer as tpt
    banks, scans = [], []
    sums, scan = tpt.index_sums, lights.ordered_cumsum

    def keep_sums(idx, values, n, dtype=torch.float32, key=None,
                  grouped=False):
        banks.append((idx.clone(), {k: x.clone() for k, x in
                                    values.items()}, n, dtype,
                      None if key is None else key.clone(), grouped))
        return sums(idx, values, n, dtype, key=key, grouped=grouped)

    def keep_scan(x, dim):
        scans.append((x.detach().clone(), dim))
        return scan(x, dim)

    tpt.index_sums, lights.ordered_cumsum = keep_sums, keep_scan
    try:
        render_once()
    finally:
        tpt.index_sums, lights.ordered_cumsum = sums, scan

    def ordered():
        for idx, values, n, dtype, key, grouped in banks:
            sums(idx, values, n, dtype, key=key, grouped=grouped)
        for x, dim in scans:
            scan(x, dim)

    def library():
        for idx, values, n, dtype, _, _ in banks:
            for x in values.values():
                torch.zeros((n,) + tuple(x.shape[1:]), dtype=dtype,
                            device=x.device).index_add_(0, idx, x.to(dtype))
        for x, dim in scans:
            torch.cumsum(x, dim)

    r = dict(banks=len(banks), bank_rows=sum(b[0].shape[0] for b in banks),
             scans=len(scans), scan_rows=sum(x.shape[0] for x, _ in scans),
             ordered_ms=cuda_ms(ordered), library_ms=cuda_ms(library))
    r["added_ms"] = r["ordered_ms"] - r["library_ms"]
    del banks, scans
    return r


# ------------------------------------------------------ repeat renders

REPEAT_RES, REPEAT_SPP = 64, 4    # phase 20's frame
# its MLT and adaptive renders (each about as costly as the frame is
# large, whatever its samples): their frame, the MLT chains and pool and
# depth, and the adaptive spp (above render.ADAPTIVE_THRESHOLD)
REPEAT_SMALL_RES, REPEAT_MLT_CHAINS, REPEAT_MLT_BOUNCES = 32, 1024, 4
ADAPTIVE_REPEAT_SPP = 24
# phase 21: a frame larger than one wave (SURVEY.md §6's fixture size):
# 3 pixel chunks x 4 sample batches of 1,048,576 rays at 16 spp
WIDE = (1000, 563)
WIDE_MEAN_TOL = 0.02


# bitwise checks that failed; the run goes on to its end, then fails
DEFERRED: list = []


def soft(fn, *args) -> bool:
    """fn(*args); an AssertionError is logged and kept in DEFERRED (the
    run then fails at its end, after every phase has printed)."""
    try:
        fn(*args)
        return True
    except AssertionError as e:
        log(f"  FAILED (reported at the end): {e}")
        DEFERRED.append(str(e))
        return False


def same_bits(name, a, b) -> None:
    """a and b (arrays, or dicts of them) bitwise equal, else raise."""
    import numpy as np
    if isinstance(a, dict):
        for k in a:
            same_bits(f"{name} {k}", a[k], b[k])
        return
    a, b = np.asarray(a), np.asarray(b)
    if not (a.shape == b.shape and a.dtype == b.dtype and
            a.tobytes() == b.tobytes()):
        diff = float(np.abs(a.astype(np.float64) - b).max())
        raise AssertionError(f"{name}: the second render is not bitwise the "
                             f"first (max |diff| {diff:.3e})")


def twice(name, fn) -> dict:
    """fn() twice on the card: bitwise equal, S1's launches a render."""
    from tungsten_tpu_torch.ops import segment_sum as tss
    t0 = time.time()
    for k in tss.LAUNCHES:
        tss.LAUNCHES[k] = 0
    a = fn()
    s1 = dict(tss.LAUNCHES)
    b = fn()
    ok = soft(same_bits, name, a, b)
    log(f"  {name}: the second render bitwise the first: {ok} "
        f"({s1['segment_sum']} S1 and {s1['ordered_scan']} scan launches a "
        f"render; {time.time() - t0:.1f} s)")
    return dict(s1, equal=ok)


def check_repeats(path, card) -> dict:
    """Phase 20: the other render paths, each twice on the card at
    REPEAT_RES x REPEAT_RES, bitwise."""
    from tungsten_tpu_torch.render import render, render_with_aovs
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    from tungsten_tpu_torch.scene.parse import load_scene
    scene, settings = flatten_scene(load_scene(path))
    small = replace(settings, width=REPEAT_RES, height=REPEAT_RES)
    smaller = replace(settings, width=REPEAT_SMALL_RES,
                      height=REPEAT_SMALL_RES)
    res, spp, bounces = BDPT_SMALL
    out = {}

    def image(st, n=REPEAT_SPP):
        return lambda: render(scene, st, spp=n, seed=SEED, spp_chunk=n)

    for integ in SPLATTING:
        out[integ] = twice(integ, image(replace(
            splat_settings(small, integ), max_bounces=bounces)))
    mlt_small = dict(mlt_chains=REPEAT_MLT_CHAINS,
                     mlt_sample_pool=REPEAT_MLT_CHAINS,
                     max_bounces=REPEAT_MLT_BOUNCES)
    for tag, integ, bidir, _ in MLT_RUNS[1:]:   # kelemen's: phase 18(a)
        out[tag] = twice(tag, image(mlt_settings(smaller, integ, bidir,
                                                 **mlt_small), 1))
    out["adaptive"] = twice("adaptive sampling", image(
        replace(smaller, adaptive_sampling=True), ADAPTIVE_REPEAT_SPP))
    out["buffers"] = twice("output buffers", lambda: render_with_aovs(
        scene, small, spp=REPEAT_SPP, seed=SEED)[1])

    def resumed():
        half = render_with_aovs(scene, small, spp=REPEAT_SPP // 2,
                                seed=SEED)[1]
        return render_with_aovs(scene, small, spp=REPEAT_SPP, seed=SEED,
                                acc=half, sample_start=REPEAT_SPP // 2)[1]
    out["resumed"] = twice("resumed output buffers (2 + 2 spp)", resumed)
    return out


def check_wide(scene, settings, img, card, twt) -> dict:
    """Phase 21: the main path at WIDE, 16 spp, 64 bounces, more than one
    wave, twice: bitwise, finite, its mean within WIDE_MEAN_TOL of phase
    5's frame's over the part of phase 5's view it sees."""
    import numpy as np
    import torch
    from tungsten_tpu_torch import render as trender
    from tungsten_tpu_torch.ops import segment_sum as tss
    w, h = WIDE
    s = replace(settings, width=w, height=h)
    n = w * h
    C = min(trender.WAVEFRONT_CHUNK, n)
    chunks = -(-n // C)
    batches = -(-SPP // max(1, trender.WAVE_RAYS // C))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a, st, launches = render_counted(scene, s, twt, SPP)
    s1 = dict(tss.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**20
    b, st2 = trender.render(scene, s, spp=SPP, seed=SEED, spp_chunk=SPP,
                            return_stats=True)
    equal = soft(same_bits, f"{w}x{h}", a, b)
    # the pinhole's horizontal field of view is the frame's width, so the
    # wide frame sees the middle h / w of phase 5's rows
    rows = RES * h / w
    lo = int(round((RES - rows) / 2))
    crop = img[lo:lo + int(round(rows))]
    rel = float(a.mean() / crop.mean() - 1.0)
    log(f"  {w}x{h} {SPP} spp max_bounces {s.max_bounces}: {chunks} pixel "
        f"chunks x {batches} sample batches = {chunks * batches} waves; "
        f"{st['time']:.3f} s and {st2['time']:.3f} s, {st['rays']} rays, "
        f"{st['mrays_per_s']:.3f} / {st2['mrays_per_s']:.3f} Mrays/s on "
        f"{card}; peak device memory {peak:.1f} MiB; launches "
        f"{ {k: v for k, v in launches.items() if v} }, S1 {s1}; the two "
        f"frames bitwise equal: {equal}; mean {a.mean():.6f} vs phase 5's "
        f"{crop.mean():.6f} over rows {lo}-{lo + int(round(rows)) - 1} "
        f"({rel * 100:+.3f} %)")
    if not (np.isfinite(a).all() and a.mean() > 0):
        raise AssertionError("wide frame: not finite or black")
    if not (launches["closest"] > 0 and launches["anyhit"] > 0 and
            s1["segment_sum"] > 0):
        raise AssertionError(f"wide frame: a kernel never launched "
                             f"{launches} {s1}")
    if chunks * batches <= 1 or abs(rel) > WIDE_MEAN_TOL:
        raise AssertionError("wide frame: one wave, or its mean off phase "
                             "5's")
    return dict(stats=st, stats2=st2, peak_mib=peak, waves=chunks * batches,
                rel_mean=rel, s1=s1, equal=equal)


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
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of the port on "
                                 "one GPU")
    ap.add_argument("--phase", choices=["2c"],
                    help="run only the card line, S1's build and phase 2c")
    only = ap.parse_args().phase
    import numpy as np
    from tungsten_tpu_torch import native
    from tungsten_tpu_torch.io import image
    from tungsten_tpu_torch.ops import curve_trace as tct
    from tungsten_tpu_torch.ops import segment_sum as tss
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
        f"CUDA {torch.version.cuda}, device {kind}; host CPUs "
        f"{os.cpu_count()}, {len(os.sched_getaffinity(0))} usable, torch "
        f"CPU threads {torch.get_num_threads()}")

    # 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)

    if only == "2c":
        t0 = time.time()
        name = tss.load_kernel()._name
        log(f"build: {time.time() - t0:.2f} s (ordered sums {name})")
        log("ordered sums (S1) vs plain:")
        check_segment_sum(tss)
        mark("ordered sums")
        return 0

    # 2. build (the four nvcc and the g++ compiles at once)
    t0 = time.time()
    with ThreadPoolExecutor(5) as ex:
        k_fut = ex.submit(twt.load_kernels)
        l_fut = ex.submit(mxb.load_kernels)
        c_fut = ex.submit(tct.load_kernel)
        s_fut = ex.submit(tss.load_kernel)
        b_fut = ex.submit(native.get_lib)
        lib = k_fut.result()
        leaf_lib = l_fut.result()
        curve_lib = c_fut.result()
        sum_lib = s_fut.result()
        bvh_lib = b_fut.result()
    log(f"build: {time.time() - t0:.2f} s (wave kernels {lib._name}; leaf "
        f"kernel {leaf_lib._name}; curve kernel {curve_lib._name}; ordered "
        f"sums {sum_lib._name}; host runtime (BVH build, OBJ parser) "
        f"{bvh_lib._name if bvh_lib is not None else 'not built: numpy'})")
    for built in (lib, leaf_lib, curve_lib, sum_lib):
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

    # 2c. S1, the ordered sums, against its plain version
    log("ordered sums (S1) vs plain:")
    s1 = check_segment_sum(tss)
    mark("ordered sums")

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
        s1_launches = dict(tss.LAUNCHES)
        log(f"  {settings.width}x{settings.height} {SPP} spp max_bounces "
            f"{settings.max_bounces}: {stats['time']:.3f} s, "
            f"{stats['rays']} rays, {stats['mrays_per_s']:.3f} Mrays/s on "
            f"{card}; launches {launches}, S1 {s1_launches}")
        if not (np.isfinite(img).all() and img.mean() > 0):
            raise AssertionError("render: image not finite or black")
        if not (launches["closest"] > 0 and launches["anyhit"] > 0 and
                s1_launches["segment_sum"] > 0 and
                s1_launches["ordered_scan"] > 0):
            raise AssertionError(f"render: a kernel never launched "
                                 f"{launches} {s1_launches}")
        img2, stats2 = render(scene, settings, spp=SPP, seed=SEED,
                              spp_chunk=SPP, return_stats=True)
        repeat5 = soft(same_bits, "render", img, img2)
        log(f"  second render: {stats2['time']:.3f} s, "
            f"{stats2['mrays_per_s']:.3f} Mrays/s; image mean {img.mean():.6f}"
            f" vs {img2.mean():.6f}; bitwise equal: {repeat5}")
        held: dict = {}
        psum: dict = {}
        prof = profile_render(lambda: held.update(img=render(
            scene, settings, spp=SPP, seed=SEED, spp_chunk=SPP)),
            summary=psum)
        soft(same_bits, "render (profiled)", img, held.pop("img"))
        log(f"  S1 in the profiled render: {psum.get('s1_launches')} "
            f"launches, {psum.get('s1_ms')} ms device time; the scan "
            f"{psum.get('scan_ms')} ms")
        cost = ordered_cost(lambda: render(scene, settings, spp=SPP,
                                           seed=SEED, spp_chunk=SPP))
        cost["share"] = cost["added_ms"] / (stats["time"] * 1e3)
        log(f"  the ordered sums of one render ({cost['banks']} banks of "
            f"{cost['bank_rows']} rows, {cost['scans']} light-choice scans "
            f"of {cost['scan_rows']} rows) replayed: {cost['ordered_ms']:.3f}"
            f" ms against {cost['library_ms']:.3f} ms by index_add_ and "
            f"torch.cumsum on the same inputs: {cost['added_ms']:+.3f} ms, "
            f"{cost['share'] * 100:+.3f} % of the render's "
            f"{stats['time']:.3f} s (bound {S1_COST_SHARE * 100:.0f} %)")
        if cost["share"] > S1_COST_SHARE:
            raise AssertionError("render: the ordered sums cost too much")
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
                                                   HAIR, LAMBERTIAN_FIBER,
                                                   PORTED_TYPES, ROUGH_WIRE)
        # every surface type: not the forward lobes (phase 8) nor the
        # fiber BCSDFs, which shade curves (phase 10)
        if not (z_tri >= 600_000 and z_mb * 2**20 >= twt.PAGED_ATTR_BYTES and
                twt.traversal_kind(zscene) == "paged" and
                set(zsettings.present_bsdf_types) ==
                set(PORTED_TYPES) - set(FORWARD_LOBE_TYPES)
                - {HAIR, LAMBERTIAN_FIBER, ROUGH_WIRE}):
            raise AssertionError("large scene off the paged-path range")
        mark("large scene (a)")
        log("  (b) paged kernels vs plain walk and resident kernels:")
        zprim, zcont, zshadow = check_scene_kernels(zscene, zsettings)
        mark("large scene (b)")
        log("  (c) render:")
        zsettings = replace(zsettings, max_bounces=ZOO_BOUNCES)
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
        # (d) at 4 bounces: the CPU plain walk of 606k triangles costs
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
        msettings = replace(msettings, max_bounces=MEDIA_BOUNCES)
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
        cross_path(mscene, msettings, max_bounces=MEDIA_CROSS_BOUNCES)
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
        cross_path(oscene, osettings, max_bounces=OUTDOOR_CROSS_BOUNCES)
        cross_path(oscene, osettings, max_bounces=OUTDOOR_CROSS_BOUNCES,
                   res=(32, 32), camera_type="equirectangular")
        cross_path(oscene, osettings, max_bounces=OUTDOOR_CROSS_BOUNCES,
                   res=(32, 24), camera_type="cubemap",
                   cubemap_mode="horizontal_cross")
        mark("outdoor (d)")
        del oscene

        # 10. curves in three modes with the fiber BCSDFs, instances, C1
        log("hair scene:")
        t0 = time.time()
        hpath = write_hair_scene(tmp)
        t_write = time.time() - t0
        t0 = time.time()
        hscene, hsettings = flatten_scene(load_scene(hpath))
        torch.cuda.synchronize()
        t_flat = time.time() - t0
        h_tri = hscene.tri_v0.shape[0]
        crv_mb = sum(getattr(hscene, f).numel() * getattr(hscene, f)
                     .element_size() for f in vars(hscene)
                     if f.startswith(("crv_", "cbvh_", "cwbvh_"))) / 2**20
        hair_mb = sum(getattr(hscene, f).numel() * 4 for f in vars(hscene)
                      if f.startswith("hair_")) / 2**20
        n_seg = hscene.crv_seg_p0.shape[0]
        n_pc = hscene.crv_pc_q0.shape[0]
        # the wide rows C1 walks: packed again on the host to time the
        # collapse (part of the flatten above)
        from tungsten_tpu_torch.ops import curve_trace as tct
        from tungsten_tpu_torch.scene.bvh import collapse_wide
        from tungsten_tpu_torch.scene.flatten import wide_curve_rows
        bin_np = [getattr(hscene, f).cpu().numpy()
                  for f in ("cbvh_meta", "cbvh_min", "cbvh_max")]
        t0 = time.time()
        wide_np = wide_curve_rows(*bin_np)
        t_wide = time.time() - t0
        wide_stack = collapse_wide(*bin_np)[2]
        if not np.array_equal(wide_np, hscene.cwbvh_rows.cpu().numpy()):
            raise AssertionError("hair scene: the wide rows do not repack "
                                 "equal")
        del bin_np, wide_np
        wide_info = dict(nodes=int(hscene.cwbvh_rows.shape[0]),
                         mib=hscene.cwbvh_rows.numel() * 4 / 2**20,
                         binary_nodes=int(hscene.cbvh_meta.shape[0]),
                         collapse_s=t_wide, stack=wide_stack)
        log(f"  (a) the wide piece BVH C1 walks: {wide_info['nodes']} "
            f"nodes of 4 children ({wide_info['mib']:.1f} MiB, 128 B a "
            f"node) from {wide_info['binary_nodes']} binary nodes; the "
            f"collapse and packing take {t_wide:.2f} s of the flatten; its "
            f"walk holds at most {wide_stack} stack entries (a ray restarts "
            f"past {tct.STACK})")
        log(f"  (a) {sum((HAIR_STRANDS, HAIR_RIBBONS, HAIR_HALF))} strands "
            f"of {HAIR_NODES} nodes ({HAIR_STRANDS} groom bcsdf_cylinder "
            f"hair, {HAIR_RIBBONS} ribbon rough_wire, {HAIR_HALF} "
            f"half_cylinder lambertian_fiber), {n_seg} segments, {n_pc} "
            f"pieces, {hscene.cbvh_meta.shape[0]} piece-BVH nodes; curve "
            f"tables {crv_mb:.1f} MiB on the card (packed rows included), "
            f"hair tables {hair_mb:.2f} MiB; {h_tri} triangles "
            f"({HAIR_SPHERES} instanced spheres, floor, light), walk "
            f"{twt.traversal_kind(hscene)}; curve modes "
            f"{hsettings.curve_modes}, bsdf types "
            f"{list(hsettings.present_bsdf_types)}; one-sample MIS "
            f"{_one_sample_mis(hsettings)}; files written in {t_write:.2f} "
            f"s, flatten {t_flat:.2f} s")
        if not (n_seg == sum((HAIR_STRANDS, HAIR_RIBBONS, HAIR_HALF))
                * (HAIR_NODES - 2) and n_pc == 8 * n_seg and
                hsettings.curve_modes == (1, 2, 3) and
                twt.traversal_kind(hscene) == "resident" and
                10_000 <= h_tri <= 20_000 and hsettings.num_caps == 1 and
                not _one_sample_mis(hsettings)):
            raise AssertionError("hair scene off its layout")
        mark("hair (a)")
        log("  (b) C1 against the plain curve walk:")
        hcam, hshadow, hcont = check_hair_kernels(hscene, hsettings)
        mark("hair (b)")
        log("  (c) render:")
        hsettings = replace(hsettings, max_bounces=HAIR_BOUNCES)
        himg, hstats, hlaunches = render_counted(hscene, hsettings, twt)
        log(f"  {hsettings.width}x{hsettings.height} {SPP} spp max_bounces "
            f"{hsettings.max_bounces}: {hstats['time']:.3f} s, "
            f"{hstats['rays']} rays, {hstats['mrays_per_s']:.3f} Mrays/s on "
            f"{card}; launches {hlaunches}; image mean {himg.mean():.6f}")
        if not (np.isfinite(himg).all() and himg.mean() > 0):
            raise AssertionError("hair render: image not finite or black")
        if not (hlaunches["curve_closest"] > 0 and
                hlaunches["curve_anyhit"] > 0 and
                hlaunches["closest"] > 0 and hlaunches["anyhit"] > 0 and
                hlaunches["paged_closest"] == 0 and
                hlaunches["paged_walk"] == 0):
            raise AssertionError(f"hair render: C1, K1 and K2 do not all "
                                 f"launch {hlaunches}")
        hsum: dict = {}
        hprof = profile_render(lambda: render(hscene, hsettings, spp=SPP,
                                              seed=SEED, spp_chunk=SPP),
                               summary=hsum)
        log(f"  hair render: {hsum.get('launches')} kernel launches a "
            f"render beside {hstats['mrays_per_s']:.3f} Mrays/s")
        mark("hair (c)")
        del hscene
        log(f"  (d) the scene cut to {HAIR_CROSS} strands (groom, ribbon, "
            f"half-cylinder), 32x32, 4 spp, {HAIR_CROSS_BOUNCES} bounces:")
        spath = write_hair_scene(tmp, HAIR_CROSS, res=32, spp=4,
                                 name="hair_small.json")
        sscene, ssettings = flatten_scene(load_scene(spath))
        cross_path(sscene, ssettings, max_bounces=HAIR_CROSS_BOUNCES,
                   res=(32, 32))
        mark("hair (d)")
        del sscene

        # 11. the CLI at the bench size: output buffers, then adaptive
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

        # 12. resume: 8 spp, then continued to 16
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
        # the same rays as 11a's in other waves: each pixel's two 8-spp
        # float64 sums are added to each other, where 11a sums its 16
        # samples in one, an association that may round otherwise, and a
        # tie between two triangles at equal t may break another way in
        # another wave; so a tolerance here, and phase 20 holds a resumed
        # render against itself bitwise
        log(f"  resumed vs uninterrupted bitwise: "
            f"{bool(np.array_equal(res_hdr, buf_hdr))}")
        images_agree("resumed 8 + 8 spp vs uninterrupted 16 spp", res_hdr,
                     buf_hdr, 1e-4, 1e-5, 0.999, 1e-4)
        mark("resume")

        # 13. the server
        log("server:")
        server_run(scene_variant(path, "server.json", res=64, spp=8,
                                 spp_step=4))
        mark("server")

        # 14. path-replay gradients on the smoke scene
        log("replay:")
        rp = check_replay(path, card)
        mark("replay")

        # 15. the data-parallel render and train step
        log("data-parallel:")
        dpr = check_data_parallel(path, card)
        mark("data-parallel")

        # 16. BDPT and the light tracer: the splat path on K1 and K2
        log("bdpt and light tracer:")
        sp = check_splat(path, mpath, img, card, twt)
        mark("bdpt / light tracer")

        # 17. the photon maps: the surface map, PPM and the three volume
        # maps on K1 (and K2 for the planes' shadow rays)
        log("photon maps:")
        ph = check_photon(path, card, twt)
        mark("photon maps")

        # 18. the MLT family on tapes, through render, the CLI and the
        # server (K1 and K2)
        log("mlt:")
        with ScanCensus(tss) as census:
            ml = check_mlt(path, card, twt)
        scan_census = {"mlt": census.summary()}
        log_census("(g) the MLT phase's scans", scan_census["mlt"])
        mark("mlt")

        # 18b. the denoiser on the card: the scans it takes
        log("denoiser:")
        scan_census["denoiser"] = denoise_scans(path, card, tss)
        mark("denoiser")

        # 19. the smoke scene from exporter-style OBJ meshes (K1 and K2)
        log("OBJ meshes:")
        ob = check_obj(tmp, path, img, img2, launches, card, twt)
        mark("OBJ meshes")

        # 20. every other render path twice, bitwise
        log(f"repeat renders ({REPEAT_RES}x{REPEAT_RES}):")
        repeats = check_repeats(path, card)
        mark("repeat renders")

        # 21. a frame larger than one wave, twice
        log("wide frame:")
        scene, settings = flatten_scene(load_scene(path))
        wide = check_wide(scene, settings, img, card, twt)
        del scene
        mark("wide frame")

        # S1 on the largest grouped launch of phase 17, as captured, and
        # at its shape on uniform ids
        log("S1 on a photon gather:")
        gathers = [x for x in ph["fog_points"]["s1_log"]
                   if x[0] == "segment_sum"]
        s1_gather = s1_gather_timing(tss, max(gathers,
                                              key=lambda x: x[1] * x[2]),
                                     ph["fog_points"].pop("s1_real"))
        s1_gather["fog_points_launches"] = len(gathers)
        mark("S1 gather shape")

    # 22. kernels line and result
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
    splat = ("; bdpt_* / light_*: launches and device ms in the full-width "
             "bidirectional path tracer and light tracer renders (phase 16)"
             "; photon_map_* / ppm_* / photon_{points,beams,planes}_*: the "
             "same in the photon-map renders (phase 17); mlt_kelemen_* / "
             "mlt_kelemen_pt_* / mlt_multiplexed_* / mlt_rj_*: launches in "
             "the MLT renders (phase 18) and device ms in the profiled "
             "kelemen render and in one profiled Metropolis step of the "
             "others (profiled_ms); obj_launches: launches in the render of "
             "the smoke scene from exporter-style OBJ meshes (phase 19)")
    k1 = "tungsten_tpu/ops/wave_trace.py:300"
    k3 = "tungsten_tpu/ops/wave_trace.py:724"
    k1_row = kernel_row("wave_trace_closest", "closest", prim, launches, k1,
                        closest_tol + split + media + outdoor + splat,
                        {"continuation": cont, "media_hop": mhop,
                         "outdoor_camera": ocam,
                         "outdoor_strategy": ostrat}, prof)
    k2_row = kernel_row("wave_trace_anyhit", "anyhit", shadow, launches, k1,
                        anyhit_tol + split + outdoor + splat,
                        {"outdoor_shadow": oshadow}, prof)
    for row, mode in ((k1_row, "closest"), (k2_row, "anyhit")):
        for tag, lc, pr in (("media", mlaunches, mprof),
                            ("outdoor", olaunches, oprof),
                            ("bdpt", sp["bdpt"]["launches"],
                             sp["bdpt"]["prof"]),
                            ("light", sp["light"]["launches"],
                             sp["light"]["prof"])) + tuple(
                (tag, ph[key]["launches"], ph[key]["prof"])
                for tag, key in PHOTON_TAGS):
            if tag == "media" and mode == "anyhit":
                continue
            row[f"{tag}_launches"] = lc[mode]
            row[f"{tag}_render_ms"] = pr[mode]["ms"] if pr.get(mode) \
                else None
            row[f"{tag}_render_by_width"] = (pr[mode]["by_width"]
                                             if pr.get(mode) else None)
    for row, mode in ((k1_row, "closest"), (k2_row, "anyhit")):
        for tag, *_ in MLT_RUNS:
            row[f"{tag}_launches"] = ml[tag]["launches"][mode]
            pr = ml[tag]["prof"]
            row[f"{tag}_profiled_ms"] = pr[mode]["ms"] if pr.get(mode) \
                else None
    k1_row["outdoor_strategy"].update(
        {k: ostrat[k] for k in ("live", "bvh_intersect_ms")})
    for row, mode in ((k1_row, "closest"), (k2_row, "anyhit")):
        row["obj_launches"] = ob["launches"][mode]
        for part in ("forward", "backward"):
            row[f"replay_{part}_launches"] = \
                rp["full"][f"{part}_launches"].get(mode, 0)
        row["hair_launches"] = hlaunches[mode]
        row["hair_render_ms"] = hprof[mode]["ms"] if hprof.get(mode) \
            else None
    c1_tol = ("vs the plain curve walk (ops/intersect.py::curve_walk_plain, "
              "the JAX _curve_traverse step for step) on the first 65,536 "
              "rays of each set, on the card: hit set equal on >= 0.9999 "
              "of live rays; closest hit: segment equal on >= 0.9999 of the "
              "rays both hit, t within rtol 1e-5 / atol 1e-6 where the "
              "segments agree (atol: a ray leaving a strand meets a strand "
              "again at t of 1e-4 to 1e-2, where t differs by a few ulps of "
              "the scene's unit scale; nvcc "
              "contracts multiply-adds, so an edge hit may flip); any "
              "hit: the hit set also equal to C1's closest hit's (the first "
              "hit's segment is the walk's own); dead rays visit no node; "
              "max_abs_err the camera rays' max |dt|")
    c1_keys = ("ms", "plain_ms", "plain_rays", "bound_ms", "bound_by",
               "max_abs_err", "t_abs_err", "rays", "live", "node_visits",
               "box_tests", "restarts", "piece_tests", "distinct_nodes", "distinct_pieces", "by_width",
               "bvh_intersect_ms", "hit_agreement", "segment_agreement",
               "visits_mean", "visits_p99", "visits_max", "stack_spills")
    c1_row = {
        "name": "curve_trace", "route": "cuda",
        "source": "tungsten_tpu_torch/csrc/curve_trace.cu",
        "replaces": "tungsten_tpu/ops/intersect.py:175 (_curve_traverse, "
                    "an XLA while_loop, not a Pallas kernel)",
        "launches": hlaunches["curve_closest"] + hlaunches["curve_anyhit"],
        "launches_closest": hlaunches["curve_closest"],
        "launches_anyhit": hlaunches["curve_anyhit"],
        "max_abs_err": hcam["max_abs_err"], "ms": hcam["ms"],
        "plain_ms": hcam["plain_ms"], "bound_ms": hcam["bound_ms"],
        "bound_by": hcam["bound_by"], "library_ms": None,
        "tolerance": c1_tol,
        "camera": {k: hcam[k] for k in c1_keys},
        "continuation": {k: hcont[k] for k in c1_keys},
        "shadow": {k: hshadow[k] for k in c1_keys},
        "render_ms": sum(hprof[r]["ms"] for r in ("curve_closest",
                                                   "curve_anyhit")
                         if hprof.get(r)) if hprof else None,
        "render_by_width": {r: hprof[r]["by_width"] for r in (
            "curve_closest", "curve_anyhit") if hprof.get(r)} or None,
        "hair_render_curve_share": hsum.get("curve_share"),
        "lanes": {"camera": hcam["lanes"],
                  "continuation": hcont["lanes"],
                  "shadow": hshadow["lanes"]},
        "visits_p99": hcam["visits_p99"],
        "wide_bvh": wide_info}
    rows = [
        k1_row,
        k2_row,
        kernel_row("wave_trace_paged_closest", "paged_closest", zprim,
                   zlaunches, k3, closest_tol + split,
                   {"continuation": zcont}, zprof),
        kernel_row("wave_trace_paged_anyhit", "paged_anyhit", zshadow,
                   zlaunches, k3, anyhit_tol + split + paged, {}, zprof),
    ] + leaf_rows + [c1_row]
    rows.append({
        "name": "segment_sum", "route": "cuda",
        "source": "tungsten_tpu_torch/csrc/segment_sum.cu",
        "replaces": "no Pallas kernel: the JAX package's XLA scatter-adds "
                    "into the frame, e.g. tungsten_tpu/integrators/"
                    "path_tracer.py:1654 (bank_emission's .at[pix].add)",
        "launches": s1_launches["segment_sum"],
        "max_abs_err": max(x["max_abs_err"] for x in s1.values()
                           if isinstance(x, dict)),
        "ms": s1["bank"]["ms"], "plain_ms": s1["bank"]["plain_ms"],
        "bound_ms": s1["bank"]["bound_ms"], "bound_by": "bytes",
        "library_ms": s1["bank"]["library_ms"], "tolerance": S1_TOL,
        "cases": {k: x for k, x in s1.items() if k != "scans"},
        "photon_gather": s1_gather,
        "render_ms": psum.get("s1_ms"),
        "render_profiled_launches": psum.get("s1_launches"),
        "render_cost": cost,
        "wide_launches": wide["s1"]["segment_sum"],
        "repeat_launches": {k: v["segment_sum"]
                            for k, v in repeats.items()}})
    # the scan's row: choose_light's shape (the main path's) in f32
    lead = s1["scans"][0]
    rows.append({
        "name": "ordered_scan", "route": "cuda",
        "source": "tungsten_tpu_torch/csrc/segment_sum.cu",
        "replaces": "no Pallas kernel: the JAX package's XLA cumsums, e.g. "
                    "tungsten_tpu/integrators/lights.py:203 (choose_light's "
                    "jnp.cumsum)",
        "launches": s1_launches["ordered_scan"],
        "max_abs_err": 0.0,
        "ms": lead["ms"], "plain_ms": lead["plain_ms"],
        "bound_ms": lead["bound_ms"], "bound_by": "bytes",
        "library_ms": lead["library_ms"], "tolerance": SCAN_TOL,
        "shapes": s1["scans"], "render_ms": psum.get("scan_ms"),
        "wide_launches": wide["s1"]["ordered_scan"],
        "real_scans": scan_census})
    log(f"render_s {stats['time']:.3f} mrays_per_s "
        f"{stats['mrays_per_s']:.3f} large_render_s {zstats['time']:.3f} "
        f"large_mrays_per_s {zstats['mrays_per_s']:.3f} media_render_s "
        f"{mstats['time']:.3f} media_mrays_per_s {mstats['mrays_per_s']:.3f}"
        f" media_launches_per_render {msum.get('launches')} "
        f"media_idle {msum.get('idle')} outdoor_render_s "
        f"{ostats['time']:.3f} outdoor_mrays_per_s "
        f"{ostats['mrays_per_s']:.3f} outdoor_launches_per_render "
        f"{osum.get('launches')} outdoor_idle {osum.get('idle')} "
        f"hair_render_s {hstats['time']:.3f} hair_mrays_per_s "
        f"{hstats['mrays_per_s']:.3f} hair_launches_per_render "
        f"{hsum.get('launches')} hair_idle {hsum.get('idle')} "
        f"hair_c1_share {hsum.get('curve_share')} "
        f"cli_buffers_s "
        f"{cli_buf['seconds']:.3f} cli_buffers_mrays_per_s "
        f"{cli_buf['mrays_per_s']:.3f} cli_adaptive_s "
        f"{cli_ad['seconds']:.3f} cli_adaptive_mrays_per_s "
        f"{cli_ad['mrays_per_s']:.3f} replay_forward_s "
        f"{rp['full']['forward_s']:.3f} replay_backward_s "
        f"{rp['full']['backward_s']:.3f} replay_forward_idle "
        f"{rp['profile']['forward'].get('idle')} replay_backward_idle "
        f"{rp['profile']['backward'].get('idle')} replay_mrays_per_s "
        f"{rp['full']['mrays_per_s']:.3f} replay_peak_mib "
        f"{rp['full']['peak_mib']:.1f} replay_peak_mib_8 "
        f"{rp['shallow']['peak_mib']:.1f} dp_nccl_render_s "
        f"{dpr['nccl']['render_s']:.3f} dp_gloo_render_s "
        f"{dpr['gloo']['render_s']:.3f} " + " ".join(
            f"{tag}_render_s {r['stats']['time']:.3f} {tag}_mrays_per_s "
            f"{r['stats']['mrays_per_s']:.3f} {tag}_rays {r['stats']['rays']} "
            f"{tag}_launches_per_render {r['summary'].get('launches')} "
            f"{tag}_idle {r['summary'].get('idle')} {tag}_k2_share "
            f"{r['summary'].get('anyhit_share')} {tag}_peak_mib "
            f"{r['peak_mib']:.1f}"
            for tag, r in (("bdpt", sp["bdpt"]), ("light", sp["light"]))) +
        f" bdpt_vs_pt {sp['bdpt']['vs_path_tracer']:.5f} cli_bdpt_s "
        f"{sp['cli']['seconds']:.3f} " + " ".join(
            f"{tag}_render_s {ph[k]['stats']['time']:.3f} {tag}_mrays_per_s "
            f"{ph[k]['stats']['mrays_per_s']:.3f} {tag}_rays "
            f"{ph[k]['stats']['rays']} {tag}_launches_per_render "
            f"{ph[k]['summary'].get('launches')} {tag}_idle "
            f"{ph[k]['summary'].get('idle')} {tag}_gather_share "
            f"{ph[k]['summary'].get('gather_share')} {tag}_peak_mib "
            f"{ph[k]['peak_mib']:.1f} {tag}_vs_pt "
            f"{ph[k]['vs_path_tracer']:.5f}" for tag, k in PHOTON_TAGS) +
        f" cli_photon_s {ph['cli']['seconds']:.3f} " + " ".join(
            f"{tag}_render_s {ml[tag]['stats']['time']:.3f} "
            f"{tag}_mrays_per_s {ml[tag]['stats']['mrays_per_s']:.3f} "
            f"{tag}_traced_mrays_per_s {ml[tag]['traced_mrays_per_s']:.3f} "
            f"{tag}_traces {ml[tag]['counts']['traces']} "
            f"{tag}_profiled_launches {ml[tag]['summary'].get('launches')} "
            f"{tag}_idle "
            f"{ml[tag]['summary'].get('idle')} {tag}_peak_mib "
            f"{ml[tag]['peak_mib']:.1f} {tag}_vs_pt "
            f"{ml[tag]['vs_path_tracer']:.5f}" for tag, *_ in MLT_RUNS) +
        f" mlt_lanes {ml['lanes']['trace_tape']:.5f} mlt_same_state "
        f"{ml['chains']['same_state']:.5f} cli_mlt_s "
        f"{ml['cli']['seconds']:.3f} obj_render_s {ob['stats']['time']:.3f} "
        f"obj_mrays_per_s {ob['stats']['mrays_per_s']:.3f} obj_image_equal "
        f"{ob['image_equal']} obj_lanes_equal {ob['lanes_equal']} "
        f"obj_load_native_s {ob['load_native_s']:.3f} obj_load_python_s "
        f"{ob['load_python_s']:.3f} obj_flatten_s {ob['flatten_s']:.3f} "
        f"cli_obj_s {ob['cli']['seconds']:.3f} s1_bank_ms "
        f"{s1['bank']['ms']:.4f} s1_bank_index_add_ms "
        f"{s1['bank']['library_ms']:.4f} ordered_added_ms "
        f"{cost['added_ms']:.3f} ordered_added_share {cost['share']:.5f} "
        f"replay_repeat_equal {rp['full']['repeat_equal']} wide_s "
        f"{wide['stats']['time']:.3f} wide_mrays_per_s "
        f"{wide['stats']['mrays_per_s']:.3f} wide_peak_mib "
        f"{wide['peak_mib']:.1f} wide_waves {wide['waves']} wide_rel_mean "
        f"{wide['rel_mean']:.5f} total_s {time.time() - t_start:.1f}")
    print(json.dumps({"kernels": rows}), flush=True)
    if DEFERRED:
        return fail(f"{len(DEFERRED)} bitwise checks failed: "
                    + "; ".join(DEFERRED))
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

"""The port's bidirectional path tracer and light tracer against the JAX
package on the CPU, the simple branch (no media, no forward lobes: each
connection is one any-hit query).

The scene is tests/test_output_buffers.py::_scene with a mirror floor
(lambert walls, one emissive quad) and an env map written to tmp_path,
16x12, pinhole, the default (Sobol') sampler, 2 samples a pixel,
`bdpt_vertices` 3 and `max_bounces` 3 (trace_bdpt's max_vertices and
max_edges, as render() passes them).  JAX runs trace_bdpt and
trace_light eagerly (jax.disable_jit: about 26 s on one worker, against
about 58 s for one jit of both), and the subpaths and light root
trace_bdpt walked are captured while it traces; the port runs the same
scene carried across with flat_scene_from_numpy, with bit-equal random
numbers, so the comparison is lane for lane and vertex for vertex:

  * every vertex field of both subpaths per lane and slot, the light
    root, and root_rev within rtol 1e-4 / atol 1e-5 on >= 0.999 of lanes;
  * trace_bdpt's per-lane radiance likewise; splat pixels equal and
    splat values close on >= 0.999 of entries; rays equal; the same for
    trace_light;
  * render_pass's image (both integrators) against the image assembled
    from the JAX outputs as tests/test_bdpt.py does: >= 0.99 of pixels
    within rtol 1e-3 / atol 1e-4, means within 1e-4;
  * (port only) with WAVEFRONT_CHUNK cut so padded lanes occur, the image
    equals the unpadded one to the order of the sums.

Lanes can only part where float rounding decides a branch (a grazing hit:
XLA contracts the compiled walk's multiply-adds).
"""
import copy
import os
from dataclasses import replace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tungsten_tpu.integrators import bdpt as jb
from tungsten_tpu.scene.flatten import flatten_scene as jax_flatten
from tungsten_tpu.utils import rng as jrng
from tungsten_tpu_torch import render as trender
from tungsten_tpu_torch.integrators import bdpt as tb
from tungsten_tpu_torch.scene.flatten import (flat_scene_from_numpy,
                                              flatten_scene)
from test_torch_flatten import jax_fields, scene_with_env

W, H, SPP, NV, ME = 16, 12, 2, 3, 3
SEED = 0xBA5EBA11
RTOL, ATOL = 1e-4, 1e-5
VERTEX_FIELDS = ("p", "ns", "ng", "wi", "alpha", "pdf_fwd", "pdf_rev", "bsdf",
                 "uv", "spec", "valid", "prim", "dist_prev", "is_med",
                 "med_at", "edge_pb", "orig")
ROOT_FIELDS = ("q", "n", "Le", "li", "prim", "pdf_a", "d0", "pdf0_solid",
               "alpha_v0", "alpha_walk", "area", "med")


def bdpt_settings(settings, integrator="bidirectional_path_tracer"):
    return replace(settings, integrator_type=integrator, bdpt_vertices=NV,
                   max_bounces=ME)


def ids():
    n = W * H
    return (np.tile(np.arange(n, dtype=np.uint32), SPP),
            np.repeat(np.arange(SPP, dtype=np.uint32), n))


def capture(module):
    """Patch module._trace_subpath and module._sample_light_root to record
    what they return; returns (the record, a function restoring them)."""
    got = []
    orig = {k: getattr(module, k) for k in ("_trace_subpath",
                                            "_sample_light_root")}

    def wrap(fn):
        def f(*a, **k):
            out = fn(*a, **k)
            got.append(out)
            return out
        return f

    for k, fn in orig.items():
        setattr(module, k, wrap(fn))
    return got, lambda: [setattr(module, k, v) for k, v in orig.items()]


def jax_trace(js, jset, light_tracer=True, eager=False):
    """trace_bdpt (and trace_light) with the camera subpath, the light
    root and the light subpath trace_bdpt walked, as numpy: one jit, or
    with `eager` op by op under jax.disable_jit (each primitive compiled
    once for its shapes and cached), which costs less than the jit's
    compile where the walks have few steps."""
    pixel, sample = ids()

    def f(p, s):
        seed = jnp.uint32(SEED)
        got, restore = capture(jb)
        try:
            out = dict(bdpt=jb.trace_bdpt(js, jset, p, s, seed, NV, ME))
        finally:
            restore()
        out["cam"], out["root"], out["lig"] = got[:3]
        if light_tracer:
            out["light"] = jb.trace_light(js, jset, p, s, seed, NV, ME)
        return out

    prev = jrng._SAMPLER
    jrng.set_sampler(jset.stratified_sampler)
    try:
        args = jnp.asarray(pixel), jnp.asarray(sample)
        if eager:
            with jax.disable_jit():
                out = f(*args)
        else:
            out = jax.jit(f)(*args)
        return jax.tree_util.tree_map(np.asarray, out)
    finally:
        jrng._SAMPLER = prev


def port_trace(ts, tset, light_tracer=True):
    pixel, sample = ids()
    p = torch.from_numpy(pixel.astype(np.int32))
    s = torch.from_numpy(sample.astype(np.int32))
    got, restore = capture(tb)
    try:
        out = dict(bdpt=tb.trace_bdpt(ts, tset, p, s, SEED, NV, ME))
    finally:
        restore()
    out["cam"], out["root"], out["lig"] = got[:3]
    if light_tracer:
        out["light"] = tb.trace_light(ts, tset, p, s, SEED, NV, ME)
    return out


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    desc = scene_with_env(tmp_path_factory.mktemp("bdpt"), mirror_floor=True)
    desc.camera["resolution"] = [W, H]
    js, jset = jax_flatten(copy.deepcopy(desc))
    ts = flat_scene_from_numpy(jax_fields(js), "cpu")
    _, tset = flatten_scene(copy.deepcopy(desc), device="cpu")
    jset, tset = bdpt_settings(jset), bdpt_settings(tset)
    assert tset.stratified_sampler and tset.has_env and tset.num_lights == 2
    assert not tset.has_media and not tb._has_forward_types(tset)
    return dict(ts=ts, tset=tset, jset=jset,
                jax=jax_trace(js, jset, eager=True),
                port=port_trace(ts, tset))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(a, b):
    """Per leading index: every entry of b (port) within the tolerance of
    a (JAX), or equal for ints and bools."""
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype.kind in "biu":
        ok = a.astype(np.int64) == b.astype(np.int64)
    else:
        ok = np.isclose(b, a, rtol=RTOL, atol=ATOL)
    return ok.reshape(ok.shape[0], -1).all(axis=-1)


def assert_vertices_agree(j, t, share=0.999):
    lanes = close(j["root_rev"], t["root_rev"])
    for k in VERTEX_FIELDS:
        agree = close(j[k], t[k])
        assert agree.mean() >= share, (k, agree.mean())
        lanes &= agree
    assert lanes.mean() >= share, lanes.mean()
    assert int(j["rays"]) == int(t["rays"])


def test_subpath_vertices_match_jax(traced):
    """Both walks, every vertex field per lane and slot (the slots a walk
    never reached hold the initial values on both sides)."""
    j, t = traced["jax"], traced["port"]
    for side in ("cam", "lig"):
        assert_vertices_agree(j[side], t[side])
        # the comparison sees real work: vertices past the first
        assert _np(t[side]["valid"])[:, 1].mean() > 0.1, side
    for k in ("esc_d", "esc_alpha", "esc_edges", "esc_valid"):
        assert close(j["cam"][k], t["cam"][k]).mean() >= 0.999, k
    assert _np(t["cam"]["esc_valid"]).mean() > 0.1


def test_light_root_matches_jax(traced):
    j, t = traced["jax"]["root"], traced["port"]["root"]
    for k in ROOT_FIELDS:
        assert close(j[k], t[k]).all(), k
    assert j["pick_pdf"] == t["pick_pdf"] == 0.5


def _splats_agree(jpix, jval, tpix, tval):
    pix = close(jpix, tpix)
    assert pix.mean() >= 0.999, pix.mean()
    val = close(jval, tval)
    assert val.mean() >= 0.999, val.mean()
    assert (_np(tval).sum(-1) > 0).mean() > 0.02


def test_radiance_splats_and_rays_match_jax(traced):
    (jrad, jpix, jval, jrays) = traced["jax"]["bdpt"]
    (trad, tpix, tval, trays) = traced["port"]["bdpt"]
    lanes = close(jrad, trad)
    assert lanes.mean() >= 0.999, lanes.mean()
    assert (_np(trad).sum(-1) > 0).mean() > 0.3
    assert _np(tpix).shape == (NV * W * H * SPP,)
    _splats_agree(jpix, jval, tpix, tval)
    assert int(jrays) == int(trays)
    jpix, jval, jrays = traced["jax"]["light"]
    tpix, tval, trays = traced["port"]["light"]
    _splats_agree(jpix, jval, tpix, tval)
    assert int(jrays) == int(trays)


def jax_image(rad, spix, sval):
    """The image of the JAX outputs (tests/test_bdpt.py::_bdpt_image):
    radiance by pixel plus the splats, non-finite values dropped."""
    n = W * H
    acc = np.zeros((n, 3))
    if rad is not None:
        np.add.at(acc, ids()[0].astype(np.int64),
                  np.where(np.isfinite(rad), rad, 0.0))
    np.add.at(acc, spix.astype(np.int64), np.where(np.isfinite(sval), sval,
                                                   0.0))
    return (acc / SPP).reshape(H, W, 3)


def port_render(traced, integrator, **kw):
    return trender.render(traced["ts"], bdpt_settings(traced["tset"],
                                                      integrator),
                          spp=SPP, seed=SEED, spp_chunk=SPP, device="cpu",
                          **kw)


@pytest.mark.parametrize("integrator", ["bidirectional_path_tracer",
                                        "light_tracer"])
def test_render_pass_matches_jax_image(traced, integrator):
    if integrator == "light_tracer":
        want = jax_image(None, *traced["jax"]["light"][:2])
        rays = traced["jax"]["light"][2]
    else:
        want = jax_image(*traced["jax"]["bdpt"][:3])
        rays = traced["jax"]["bdpt"][3]
    img, stats = port_render(traced, integrator, return_stats=True)
    assert img.shape == want.shape == (H, W, 3)
    assert np.isfinite(img).all() and img.mean() > 0
    agree = np.isclose(img, want, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert agree.mean() >= 0.99, agree.mean()
    assert abs(img.mean() / want.mean() - 1.0) <= 1e-4
    # one wave of W * H * SPP lanes: its rays are the JAX call's
    assert stats["rays"] == int(rays)


def test_padded_lanes_splat_nothing(traced, monkeypatch):
    """With the chunk cut to 80 pixels, the last chunk of the 192-pixel
    frame carries 48 padded lanes (pixel >= W*H) a sample; their camera
    rays leave below the frame and their light paths do splat into it,
    so the mask is what keeps the image the unpadded one's (to the order
    of the sums)."""
    n = W * H
    pad = torch.arange(n, n + 48, dtype=torch.int32).repeat(SPP)
    smp = torch.arange(SPP, dtype=torch.int32).repeat_interleave(48)
    _, _, sval, _ = tb.trace_bdpt(traced["ts"], bdpt_settings(traced["tset"]),
                                  pad, smp, SEED, NV, ME)
    assert (sval.sum(-1) > 0).any()
    want = port_render(traced, "bidirectional_path_tracer")
    monkeypatch.setattr(trender, "WAVEFRONT_CHUNK", 80)
    monkeypatch.setattr(trender, "WAVE_RAYS", 160)
    img = port_render(traced, "bidirectional_path_tracer")
    assert np.allclose(img, want, rtol=1e-5, atol=1e-7)


# ------------------------------------------ the entry points (port only)

def bdpt_scene_file(d, **renderer):
    """tests/test_torch_entry.py's scene file cut to 8x8 under the
    bidirectional path tracer with max_bounces 3."""
    import json
    from test_torch_entry import write_scene
    path = write_scene(d, name="bdpt.json", **renderer)
    with open(path) as f:
        sj = json.load(f)
    sj["camera"]["resolution"] = [8, 8]
    sj["integrator"] = {"type": "bidirectional_path_tracer", "max_bounces": 3}
    with open(path, "w") as f:
        json.dump(sj, f)
    return path


def test_cli_renders_bdpt_with_buffers_from_the_post_pass(tmp_path):
    """cli.render_scene on a BDPT scene with a color and a normal buffer:
    the image is render()'s, and the buffers come from the path-traced
    post-pass at min(spp, 8) spp, as the JAX CLI writes them."""
    from tungsten_tpu_torch import cli
    from tungsten_tpu_torch.io import image as timage
    from tungsten_tpu_torch.scene.flatten import load_flat_scene
    from test_torch_entry import _cli_args
    path = bdpt_scene_file(str(tmp_path), output_file="out.png",
                           hdr_output_file="out.pfm", spp_step=2,
                           output_buffers=[
                               {"type": "color", "hdr_output_file": "c.pfm"},
                               {"type": "normal", "hdr_output_file": "n.pfm"}])
    out = cli.render_scene(path, _cli_args(spp=2))
    assert [os.path.basename(f) for f in out["files"]] == [
        "out.png", "out.pfm", "c.pfm", "n.pfm"]
    assert out["spp"] == 2 and out["rays"] > 0
    ts, tset = load_flat_scene(path, "cpu")
    assert tset.integrator_type == "bidirectional_path_tracer"
    img = trender.render(ts, tset, spp=2, seed=tset.seed, spp_chunk=2,
                         device="cpu")
    files = {os.path.basename(f): f for f in out["files"]}
    np.testing.assert_allclose(timage.load_hdr(files["out.pfm"]), img,
                               rtol=1e-6, atol=1e-7)
    bufs, _ = trender.render_with_aovs(
        ts, replace(tset, integrator_type="path_tracer"), spp=2,
        seed=tset.seed)
    normal = timage.load_hdr(files["n.pfm"])
    assert np.abs(normal).max() > 0.5
    np.testing.assert_allclose(normal, bufs["normal"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(timage.load_hdr(files["c.pfm"]), bufs["color"],
                               rtol=1e-6, atol=1e-7)


def test_server_renders_bdpt(tmp_path):
    """The server renders a BDPT scene through render_pass in spp_step
    rounds; its framebuffer is render()'s image."""
    import json
    from tungsten_tpu_torch import server as srv
    from tungsten_tpu_torch.scene.flatten import load_flat_scene
    from test_torch_entry import _free_port, _get
    path = bdpt_scene_file(str(tmp_path), spp_step=1)
    port = _free_port()
    httpd = srv.render_with_server([path], port=port, spp=2, device="cpu",
                                   host="127.0.0.1")
    try:
        st = json.loads(_get(port, "status"))
        assert st["state"] == "done" and st["current_spp"] == 2
        assert st["rays_total"] > 0
        fb = httpd.status.framebuffer
    finally:
        httpd.shutdown()
        httpd.server_close()
    ts, tset = load_flat_scene(path, "cpu")
    img = trender.render(ts, tset, spp=2, seed=tset.seed, device="cpu")
    assert img.mean() > 0
    np.testing.assert_allclose(fb, img, rtol=1e-5, atol=1e-6)

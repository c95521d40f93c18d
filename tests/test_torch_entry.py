"""The port's user entry points against the JAX package on the CPU: the
output buffers, adaptive sampling, checkpoint files, the CLI, the HTTP
server, the host tools, the NFOR denoiser and the debug checks.

The scene is tests/test_output_buffers.py::_scene's (lambert walls, a
mirror floor, one area light) plus an env map and a small mesh, written
as a scene file and loaded by both packages: 16x12, max_bounces 4.  The
RNG is bit-equal, so rays agree lane for lane except where a traversal
decides a grazing hit differently (XLA contracts the compiled walk's
multiply-adds, PyTorch's CPU kernels do not): per ray within rtol 1e-4 /
atol 1e-5 on >= 99 % of the lanes, per pixel on >= 98 % of the pixels.
"""
import copy
import json
import os
import socket
import urllib.request
import zipfile
from dataclasses import replace
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tungsten_tpu import render as jrender
from tungsten_tpu.scene.flatten import load_flat_scene as jax_load
from tungsten_tpu.utils import rng as jrng
from tungsten_tpu_torch import render as trender
from tungsten_tpu_torch.integrators import path_tracer as tpt
from tungsten_tpu_torch.io import image as timage
from tungsten_tpu_torch.io import mesh as tmesh
from tungsten_tpu_torch.scene.flatten import load_flat_scene

W, H, SEED = 16, 12, 7
N = W * H
RTOL, ATOL = 1e-4, 1e-5


def write_scene(d, name="scene.json", **renderer):
    """The test scene as a Tungsten scene file in `d` (sky.pfm and
    cube.wo3 beside it); `renderer` entries extend its renderer block."""
    r = np.random.default_rng(7)
    sky = r.uniform(0.2, 2.0, (16, 32, 3)).astype(np.float32)
    timage.save_hdr(os.path.join(d, "sky.pfm"), sky)
    pos = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                    for z in (-1, 1)], np.float32)
    idx = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                    [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                    [1, 5, 7], [1, 7, 3]], np.int32)
    tmesh.save_wo3(os.path.join(d, "cube.wo3"), tmesh.Mesh(
        pos=pos, normal=np.zeros_like(pos),
        uv=np.zeros((8, 2), np.float32), indices=idx,
        material=np.zeros(12, np.int32)))
    scene = {
        "bsdfs": [{"name": "diffuse", "type": "lambert",
                   "albedo": [0.6, 0.3, 0.2]},
                  {"name": "mirror", "type": "mirror", "albedo": 1.0}],
        "primitives": [
            {"type": "quad", "bsdf": "diffuse", "emission": [8.0, 8.0, 8.0],
             "transform": {"position": [0, 2.4, 0], "rotation": [0, 0, 180]}},
            {"type": "quad", "bsdf": "mirror",
             "transform": {"position": [0, -1, 0], "scale": [10, 1, 10]}},
            {"type": "quad", "bsdf": "diffuse",
             "transform": {"position": [0, 1, -3], "scale": [10, 1, 10],
                           "rotation": [90, 0, 0]}},
            {"type": "mesh", "file": "cube.wo3", "bsdf": "diffuse",
             "transform": {"position": [0.8, -0.6, -0.5], "scale": 0.3}},
            {"type": "infinite_sphere", "emission": "sky.pfm",
             "transform": {"rotation": [0, 30, 0]}}],
        "camera": {"type": "pinhole", "resolution": [W, H], "fov": 60,
                   "transform": {"position": [0, 0.6, 4.0],
                                 "look_at": [0, 0.0, 0]}},
        "integrator": {"type": "path_tracer", "max_bounces": 4},
        "renderer": dict({"spp": 4}, **renderer)}
    path = os.path.join(d, name)
    with open(path, "w") as f:
        json.dump(scene, f, indent=1)
    return path


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    return write_scene(str(tmp_path_factory.mktemp("entry")))


@pytest.fixture(scope="module")
def scenes(scene_path):
    js, jset = jax_load(scene_path)
    ts, tset = load_flat_scene(scene_path, "cpu")
    assert (tset.width, tset.height) == (W, H) and tset.adaptive_sampling
    return js, jset, ts, tset


@pytest.fixture(autouse=True)
def restore_jax_sampler():
    """The JAX renders latch their sampler in a module global."""
    prev = jrng._SAMPLER
    yield
    jrng._SAMPLER = prev


def _lanes_close(a, b):
    """(R,) bool: every channel of the lane within RTOL / ATOL."""
    a = np.asarray(a).reshape(len(a), -1)
    b = np.asarray(b).reshape(len(b), -1)
    return np.isclose(a, b, rtol=RTOL, atol=ATOL).all(axis=-1)


def _pixels_agree(a, b, share=0.98):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    ok = _lanes_close(a.reshape(N, -1), b.reshape(N, -1))
    assert ok.mean() >= share, ok.mean()


# ------------------------------------------------------ (i) trace_wave_aovs

def _jax_aov_wave(js, jset, sample):
    """JAX's jitted AOV wave (the program render_with_aovs runs), one
    sample of every pixel: per-pixel sums are per-ray values."""
    settings = replace(jset, spp=0, seed=0, track_aovs=True)
    jrng.set_sampler(settings.stratified_sampler)
    out = jrender._trace_chunk_aov(
        js, settings, jnp.arange(N, dtype=jnp.uint32),
        jnp.full((N,), sample, jnp.uint32), np.uint32(SEED), N)
    return {k: np.asarray(v) for k, v in out.items()}


def test_trace_wave_aovs_matches_jax(scenes):
    js, jset, ts, tset = scenes
    for sample in (0, 1):
        want = _jax_aov_wave(js, jset, sample)
        rad, aovs = tpt.trace_wave_aovs(
            ts, tset, torch.arange(N, dtype=torch.int32),
            torch.full((N,), sample, dtype=torch.int32), SEED)
        assert _lanes_close(rad.numpy(), want["color_sum"]).mean() >= 0.99
        for k, v in aovs.items():
            v = v.numpy()
            assert np.array_equal(v[:, -1] > 0, want[k + "_n"] > 0) or \
                (v[:, -1] == want[k + "_n"]).mean() >= 0.99, k
            ok = _lanes_close(v[:, :-1], want[k + "_sum"]) & \
                (v[:, -1] == want[k + "_n"])
            assert ok.mean() >= 0.99, (k, ok.mean())
        # real work: every path records depth/normal/albedo, most see the
        # light unoccluded, some do not
        assert (aovs["depth"][:, -1] == 1).all()
        vis = aovs["visibility"].numpy()
        assert 0 < vis[:, -1].sum() < N and vis[:, 0].max() == 1.0


def test_staged_lane_banking_equals_one_width(scenes):
    """trace_wave[_aovs] run the staged loop and bank by lane: with the
    wave compacted several times (768 lanes down to widths of 32) every
    sample and AOV equals the run at one width, up to the order of the
    radiance sums (rtol 1e-6); counts and rays equal exactly."""
    _, _, ts, tset = scenes
    pix = torch.arange(N, dtype=torch.int32).repeat(4)
    smp = torch.arange(4, dtype=torch.int32).repeat_interleave(N)
    one = tpt.trace_wave_aovs(ts, tset, pix, smp, SEED, with_stats=True,
                              min_wave=1 << 30)
    staged = tpt.trace_wave_aovs(ts, tset, pix, smp, SEED, with_stats=True,
                                 min_wave=32, step=2)
    assert int(staged[2]) == int(one[2]) > 0
    np.testing.assert_allclose(staged[0].numpy(), one[0].numpy(), rtol=1e-6,
                               atol=1e-7)
    for k, v in one[1].items():
        got = staged[1][k].numpy()
        assert np.array_equal(got[:, -1], v[:, -1].numpy()), k
        np.testing.assert_allclose(got, v.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    rad = tpt.trace_wave(ts, tset, pix, smp, SEED, min_wave=32, step=2)
    np.testing.assert_allclose(rad.numpy(), one[0].numpy(), rtol=1e-6,
                               atol=1e-7)


# ------------------------------------------------- (ii) render_with_aovs

def test_render_with_aovs_matches_jax_and_resumes(scenes):
    js, jset, ts, tset = scenes
    want, _ = jrender.render_with_aovs(js, jset, spp=4, seed=SEED)
    got, acc = trender.render_with_aovs(ts, tset, spp=4, seed=SEED)
    assert set(got) == set(want)
    for k in want:
        _pixels_agree(got[k], want[k])
    assert got["color"].mean() > 0 and (got["visibility_n"] > 0).any()
    # resume from sample 2 == the uninterrupted run (float64 sums of the
    # same rays in another order)
    _, acc2 = trender.render_with_aovs(ts, tset, spp=2, seed=SEED)
    resumed, acc4 = trender.render_with_aovs(ts, tset, spp=4, seed=SEED,
                                             acc=acc2, sample_start=2)
    for k in got:
        np.testing.assert_allclose(resumed[k], got[k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert set(acc4) == set(acc)


# --------------------------------------------------- (iii) render_adaptive

def test_render_adaptive_matches_jax(scenes, monkeypatch):
    js, jset, ts, tset = scenes
    # JAX compiles its adaptive wave once per wave length; in chunks of
    # one 4x4 variance tile every wave (192 pixels a warm-up spp, 16 a
    # tile sample) is cut into chunks of one length: one compile
    monkeypatch.setattr(jrender, "WAVEFRONT_CHUNK", 16)
    img_j, rays_j, _, st_j = jrender.render_adaptive(
        js, replace(jset, spp_step=8), 32, SEED)
    img_t, rays_t, _, st_t = trender.render_adaptive(
        ts, replace(tset, spp_step=8), 32, SEED)
    assert st_t["done"] == st_j["done"] == 32
    # the same tile budgets: per-tile cursors and per-pixel counts equal
    assert np.array_equal(st_t["tile_next_index"], st_j["tile_next_index"])
    assert np.array_equal(st_t["px_count"], st_j["px_count"])
    assert st_t["px_count"].max() > st_t["px_count"].min()
    assert np.array_equal(st_t["t_cnt"], st_j["t_cnt"])
    for k in ("t_sum", "t_sumsq"):
        assert _lanes_close(st_t[k][:, None], st_j[k][:, None]).mean() \
            >= 0.98, k
    _pixels_agree(st_t["fb"], st_j["fb"])
    _pixels_agree(img_t, img_j)
    assert abs(rays_t / rays_j - 1.0) < 1e-3
    # render() takes the adaptive branch above 16 spp
    img = trender.render(ts, replace(tset, spp_step=8), spp=32, seed=SEED,
                         device="cpu")
    np.testing.assert_allclose(img, img_t, rtol=1e-5, atol=1e-7)


# ------------------------------------------------ (iv) checkpoint files

def test_checkpoint_files_load_across_packages(tmp_path):
    from tungsten_tpu.integrators import checkpoint as jck
    from tungsten_tpu_torch.integrators import checkpoint as tck
    r = np.random.default_rng(4)
    fb = r.random((H, W, 3)).astype(np.float32)
    bufs = {"color_sum": r.random((N, 3)), "depth_n": r.random((N,)),
            "adaptive_tile_next_index": np.arange(12, dtype=np.int64),
            "adaptive_done": np.asarray([24], np.int64)}
    sjson = {"bsdfs": [{"type": "lambert"}], "renderer": {"spp": 3}}
    assert tck.scene_hash(sjson) == jck.scene_hash(sjson)
    h = tck.scene_hash(sjson)
    for save, load in ((tck.save_resume_state, jck.load_resume_state),
                       (jck.save_resume_state, tck.load_resume_state)):
        p = str(tmp_path / "state.dat")
        save(p, h, fb, 24, buffers=bufs)
        st = load(p, h)
        assert st["current_spp"] == 24
        assert np.array_equal(st["framebuffer"], fb)
        assert set(st["buffers"]) == set(bufs)
        for k, v in bufs.items():
            assert st["buffers"][k].dtype == v.dtype
            assert np.array_equal(st["buffers"][k], v), k
        assert load(p, "another scene") is None


# ------------------------------------------------------------- (v) the CLI

def _cli_args(**kw):
    from tungsten_tpu_torch.cli import build_parser
    args = build_parser().parse_args(["x.json", "--device", "cpu"])
    return SimpleNamespace(**dict(vars(args), **kw))


BUFFERS = [{"type": "color", "hdr_output_file": "color.pfm",
            "sample_variance": True, "two_buffer_variance": True},
           {"type": "depth", "hdr_output_file": "depth.pfm"},
           {"type": "normal", "hdr_output_file": "normal.pfm"},
           {"type": "albedo", "hdr_output_file": "albedo.pfm"},
           {"type": "visibility", "hdr_output_file": "visibility.pfm"}]


def test_cli_writes_buffers_resumes_and_matches_jax(tmp_path, scenes):
    from tungsten_tpu.cli import parse_duration as jax_parse
    from tungsten_tpu_torch import cli
    for s in ("0", "90s", "15m", "1h30m", "2.5m10"):
        assert cli.parse_duration(s) == jax_parse(s)
    path = write_scene(str(tmp_path), output_file="out.png",
                       hdr_output_file="out.pfm", spp_step=2,
                       enable_resume_render=True, output_buffers=BUFFERS)
    first = cli.render_scene(path, _cli_args(spp=2))
    assert first["spp"] == 2 and first["rays"] > 0
    second = cli.render_scene(path, _cli_args())        # resumes 2 -> 4
    assert second["spp"] == 4
    names = ["TungstenRenderState.dat", "out.png", "out.pfm", "color.pfm",
             "colorVariance.pfm", "colorA.pfm", "colorB.pfm", "depth.pfm",
             "normal.pfm", "albedo.pfm", "visibility.pfm"]
    assert [os.path.basename(f) for f in second["files"]] == names
    written = {f: timage.load_hdr(f) for f in second["files"][2:]}
    # resumed at the target spp: no round runs, the buffers come from the
    # state file's accumulators, unchanged
    third = cli.render_scene(path, _cli_args())
    assert third["spp"] == 4 and third["rays"] == 0
    assert third["files"] == second["files"]
    for f, img in written.items():
        assert np.array_equal(timage.load_hdr(f), img), f
    for f in second["files"][2:]:
        img = timage.load_hdr(f)
        assert img.shape == (H, W, 3) and np.isfinite(img).all(), f
    with open(second["files"][1], "rb") as f:
        assert timage.decode_png(f.read()).shape == (H, W, 3)
    hdr = timage.load_hdr(os.path.join(tmp_path, "out.pfm"))
    # the HDR output is the JAX package's 4-spp color buffer of this scene
    js, jset, ts, tset = scenes
    want, _ = jrender.render_with_aovs(js, jset, spp=4, seed=jset.seed)
    _pixels_agree(hdr, want["color"])
    # and the resumed run equals an uninterrupted one
    straight, _ = trender.render_with_aovs(ts, tset, spp=4, seed=tset.seed)
    np.testing.assert_allclose(hdr, straight["color"], rtol=1e-5, atol=1e-6)
    # more than 16 spp, adaptive sampling left at its default: the
    # adaptive branch
    apath = write_scene(str(tmp_path), name="adaptive.json", spp_step=8,
                        output_file="adaptive.png")
    res = cli.render_scene(apath, _cli_args(spp=24))
    assert res["spp"] == 24 and res["rays"] > 0
    assert [os.path.basename(f) for f in res["files"]] == ["adaptive.png"]


# ---------------------------------------------------------- (vi) the server

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, what):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}/{what}",
                                  timeout=30).read()


def test_server_endpoints(tmp_path):
    from tungsten_tpu_torch import server as srv
    port = _free_port()
    httpd = srv.serve(port, host="127.0.0.1")
    try:
        st = httpd.status
        st.framebuffer = np.ones((4, 4, 3), np.float32) * 0.5
        st.log("hello")
        st.record_round(1_000_000, 0.5)
        js = json.loads(_get(port, "status"))
        assert js["mrays_per_s"] == 2.0 and js["rays_total"] == 1_000_000
        assert js["mrays_per_s_per_chip"] > 0
        png = _get(port, "render")
        assert png[:4] == b"\x89PNG"
        assert timage.decode_png(png).shape == (4, 4, 3)
        assert b"hello" in _get(port, "log")
    finally:
        httpd.shutdown()
        httpd.server_close()
    # a render in two spp rounds, then the endpoints report it
    path = write_scene(str(tmp_path), spp_step=2)
    port = _free_port()
    httpd = srv.render_with_server([path], port=port, spp=4,
                                   device="cpu", host="127.0.0.1")
    try:
        js = json.loads(_get(port, "status"))
        assert js["state"] == "done" and js["current_spp"] == 4
        assert js["rays_total"] > 0 and js["n_chips"] == 1
        img = timage.decode_png(_get(port, "render"))
        assert img.shape == (H, W, 3) and img.max() > 0
        log = _get(port, "log")
        assert b"Completed 2/4 spp" in log and b"Completed 4/4 spp" in log
    finally:
        httpd.shutdown()
        httpd.server_close()


# ------------------------------------------------------- (vii) host tools

def test_hdrmanip_matches_jax(tmp_path):
    from PIL import Image
    from tungsten_tpu.tools import hdrmanip as jhm
    from tungsten_tpu_torch.tools import hdrmanip as thm
    r = np.random.default_rng(0)
    a = r.random((8, 8, 3)).astype(np.float32) * 2
    b = r.random((8, 8, 3)).astype(np.float32) * 2
    pa, pb = str(tmp_path / "a.pfm"), str(tmp_path / "b.pfm")
    timage.save_hdr(pa, a)
    timage.save_hdr(pb, b)
    for mod, tag in ((thm, "t"), (jhm, "j")):
        mod.main([pa, pb, "-m", "-w", "3,1", "-o",
                  str(tmp_path / f"m_{tag}.pfm")])
        mod.main([pa, "-o", str(tmp_path / f"c_{tag}.png"), "-t", "filmic"])
    with open(tmp_path / "m_t.pfm", "rb") as f1, \
            open(tmp_path / "m_j.pfm", "rb") as f2:
        assert f1.read() == f2.read()
    with open(tmp_path / "c_t.png", "rb") as f:
        got = timage.decode_png(f.read())
    assert np.array_equal(got, np.asarray(Image.open(tmp_path / "c_j.png")))
    A, B = thm.load(pa), thm.load(pb)
    assert thm.mse(A, B) == jhm.mse(A, B)
    assert thm.rmse(A, B) == jhm.rmse(A, B)
    assert thm.variance([A, B]) == jhm.variance([A, B])
    assert np.array_equal(thm.error_map(A, B, True), jhm.error_map(A, B, True))


def test_scene_tools_match_jax(tmp_path, scene_path):
    from tungsten_tpu.tools import json2xml as jjx
    from tungsten_tpu.tools import obj2json as joj
    from tungsten_tpu.tools import scenemanip as jsm
    from tungsten_tpu_torch.tools import json2xml as tjx
    from tungsten_tpu_torch.tools import obj2json as toj
    from tungsten_tpu_torch.tools import scenemanip as tsm
    # scenemanip: resources and the packaged zip
    assert tsm.list_resources(scene_path) == \
        jsm.list_resources(scene_path) == ["cube.wo3", "sky.pfm"]
    zips = [mod.package(scene_path, str(tmp_path / f"{t}.zip"))
            for mod, t in ((tsm, "t"), (jsm, "j"))]
    contents = []
    for z in zips:
        with zipfile.ZipFile(z) as zf:
            contents.append({n: zf.read(n) for n in zf.namelist()})
    assert contents[0] == contents[1]
    assert set(contents[0]) == {"scene.json", "cube.wo3", "sky.pfm"}
    # obj2json: the scene file and the .wo3 mesh
    outs = []
    for mod, t in ((toj, "t"), (joj, "j")):
        d = tmp_path / f"obj_{t}"
        d.mkdir()
        (d / "tri.obj").write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nvn 0 0 1\n"
                                   "f 1//1 2//1 3//1\n")
        (d / "tri.mtl").write_text("newmtl red\nKd 0.8 0.1 0.1\n")
        out = mod.convert(str(d / "tri.obj"))
        m = tmesh.load_wo3(str(d / "tri.wo3"))
        outs.append((open(out).read(), m))
    assert outs[0][0] == outs[1][0]
    # the mesh: equal geometry; the per-triangle material ids differ,
    # because the JAX package's native OBJ loader writes 0 where its own
    # Python loader, which the port copies, writes -1
    for k in ("pos", "normal", "uv", "indices"):
        assert np.array_equal(getattr(outs[0][1], k), getattr(outs[1][1], k))
    # json2xml: the XML and the .wo3 -> .obj re-export
    xml = []
    for mod, t in ((tjx, "t"), (jjx, "j")):
        d = tmp_path / f"xml_{t}"
        d.mkdir()
        mod.convert(scene_path, str(d / "scene.xml"))
        xml.append({f: open(d / f).read() for f in sorted(os.listdir(d))})
    assert xml[0] == xml[1]
    assert set(xml[0]) == {"scene.xml", "cube.obj"}
    assert "<shape" in xml[0]["scene.xml"]


# ---------------------------------------------------------- (viii) NFOR

def test_nfor_denoise_matches_jax():
    from tungsten_tpu.tools.denoiser import nfor_denoise as jax_nfor
    from tungsten_tpu_torch.tools.denoiser import nfor_denoise
    rng = np.random.default_rng(0)
    clean = rng.random((14, 18, 3)).astype(np.float32)
    a = clean + rng.normal(0, 0.2, clean.shape).astype(np.float32)
    b = clean + rng.normal(0, 0.2, clean.shape).astype(np.float32)
    var = np.full(clean.shape, 0.02, np.float32)
    f = clean[..., :2]
    fa = f + rng.normal(0, 0.05, f.shape).astype(np.float32)
    fb = f + rng.normal(0, 0.05, f.shape).astype(np.float32)
    fv = np.full(f.shape, 0.0025, np.float32)
    want = jax_nfor(a, b, var, fa, fb, fv)
    got = nfor_denoise(a, b, var, fa, fb, fv, device="cpu")
    assert got.shape == want.shape == (14, 18, 3)
    # float32 sums in another order through box filters, NL-means and a
    # batched solve: within 1e-4 absolute (outputs are O(1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# ------------------------------------------------------ (ix) debug checks

def test_checked_trace(scenes):
    from tungsten_tpu_torch.utils.debug import checked_trace
    _, _, ts, tset = scenes
    pix = torch.arange(N, dtype=torch.int32)
    smp = torch.zeros(N, dtype=torch.int32)
    err, rad = checked_trace(ts, tset, pix, smp, SEED)
    assert err is None and torch.isfinite(rad).all()
    # a NaN planted in the vertex data the hit expansion reads (edges and
    # vertex normals) reaches the radiance: the float check fires
    shade = ts.tri_shade.clone()
    shade[:, 0:15] = float("nan")
    err, _ = checked_trace(replace(ts, tri_shade=shade), tset, pix, smp,
                           SEED)
    assert err is not None and "non-finite" in err
    # a negative emitter breaks the transport invariant
    bad = replace(ts, light_emission=ts.light_emission - 1e6)
    err, _ = checked_trace(bad, tset, pix, smp, SEED, float_checks=False)
    assert err is not None and "negative radiance" in err


def test_render_file_writes_png(tmp_path, scene_path):
    out = str(tmp_path / "r.png")
    hdr = trender.render_file(scene_path, output=out, spp=2, device="cpu")
    with open(out, "rb") as f:
        assert timage.decode_png(f.read()).shape == (H, W, 3)
    assert hdr.shape == (H, W, 3) and hdr.mean() > 0
    bufs = trender.render_denoise_buffers(*load_flat_scene(scene_path, "cpu"),
                                          spp=2)
    assert bufs["feat_a"].shape == (H, W, 7)
    assert np.isfinite(bufs["color_var"]).all()

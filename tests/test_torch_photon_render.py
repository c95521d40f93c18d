"""The port's photon-map render path (render.py::_render_pass_photon and
the entry points) on the CPU.

  * One JAX render_pass under photon_map (the surface map on
    tests/test_torch_photon.py's caustic scene: 16x16, 1 spp,
    max_bounces 6, 65,536 photon paths, one compile of each of JAX's
    trace_photons and gather_pass) against the port's render_pass on the
    same scene carried across: <= 1 % of pixels off by more than rtol
    1e-3 / atol 1e-4, means within 0.5 %, rays equal.
  * Port-only checks anchored by the pieces tests/test_torch_photon.py
    holds to JAX:
      - progressive_photon_map at iteration 0 is photon_map bitwise;
      - at iteration 3 it is photon_map at iteration 3 with
        gather_radius and vol_gather_radius scaled by sqrt(gamma_3),
        bitwise (on the fog fixture, points map, max_bounces 3);
      - two rounds in one render_pass (one photon wave, one camera
        wave) equal the rounds one call each, bitwise;
      - on tests/test_photon_volume.py's fog fixture (one round each,
        where the JAX test takes two): beams / points within (0.6, 1.7)
        and planes / points within (0.5, 2.0) (volume_photon_count 2,000,
        as there), photon map / path tracer at 48 spp within (0.4, 2.5);
      - a voxel medium asked for beams renders as points, bitwise;
      - cli.render_scene and the server on a photon scene file.
"""
import copy
import json
import os
from dataclasses import replace

import numpy as np
import pytest

from tungsten_tpu import render as jrender
from tungsten_tpu.scene.flatten import flatten_scene as jax_flatten
from tungsten_tpu.utils import rng as jrng
from tungsten_tpu_torch import render as trender
from tungsten_tpu_torch.integrators import photon_map as tpm
from tungsten_tpu_torch.media.grid import MED_VOXEL
from tungsten_tpu_torch.scene.flatten import (flat_scene_from_numpy,
                                              flatten_scene)
from test_photon_volume import _fog_scene
from test_torch_flatten import jax_fields
from test_torch_photon import caustic_scene

SEED = 0xBA5EBA11


def images_agree(got, want):
    """phase 6's gates: <= 1 % of pixels off by more than rtol 1e-3 /
    atol 1e-4, means within 0.5 %."""
    close = np.isclose(got, want, rtol=1e-3, atol=1e-4).all(-1).mean()
    rel = abs(got.mean() / want.mean() - 1.0)
    assert close >= 0.99 and rel <= 0.005, (close, rel)


@pytest.fixture(scope="module")
def surface(tmp_path_factory):
    """The caustic scene's JAX render_pass (one round) and the port's."""
    desc = caustic_scene(str(tmp_path_factory.mktemp("photon_render")))
    js, jset = jax_flatten(copy.deepcopy(desc))
    ts = flat_scene_from_numpy(jax_fields(js), "cpu")
    _, tset = flatten_scene(copy.deepcopy(desc), device="cpu")
    prev = jrng._SAMPLER
    try:
        img, rays = jrender.render_pass(js, jset, 0, SEED, 1)
        want = (np.asarray(img), int(rays))
    finally:
        jrng._SAMPLER = prev
    img, rays = trender.render_pass(ts, tset, 0, SEED, 1)
    return dict(ts=ts, tset=tset, jax=want, port=(img.numpy(), int(rays)))


def test_render_pass_matches_jax(surface):
    want, jrays = surface["jax"]
    got, rays = surface["port"]
    assert got.shape == want.shape == (16, 16, 3)
    assert np.isfinite(got).all() and got.mean() > 0
    images_agree(got, want)
    assert rays == jrays


def test_ppm_iteration_zero_is_the_photon_map(surface):
    got, rays = trender.render_pass(
        surface["ts"], replace(surface["tset"],
                               integrator_type="progressive_photon_map"),
        0, SEED, 1)
    assert np.array_equal(got.numpy(), surface["port"][0])
    assert int(rays) == surface["port"][1]


def _fog(**integrator):
    desc = _fog_scene(w=12, h=8)
    desc.integrator.update(integrator)
    return flatten_scene(desc, device="cpu")


def test_ppm_iteration_three_shrinks_both_radii():
    ts, tset = _fog(max_bounces=3)
    assert tset.has_media and tset.vol_photon_type == "points"
    g = tpm.ppm_gamma(3, tset.ppm_alpha)
    assert g < 0.6
    ppm, r_ppm = trender.render_pass(
        ts, replace(tset, integrator_type="progressive_photon_map"), 3, SEED,
        1)
    k = float(np.sqrt(g))
    pm, r_pm = trender.render_pass(
        ts, replace(tset, gather_radius=tset.gather_radius * k,
                    vol_gather_radius=tset.vol_gather_radius * k), 3, SEED,
        1)
    assert np.array_equal(ppm.numpy(), pm.numpy()) and r_ppm == r_pm
    full, _ = trender.render_pass(ts, tset, 3, SEED, 1)
    assert not np.array_equal(full.numpy(), pm.numpy())


def test_rounds_in_one_wave_equal_rounds_one_by_one(monkeypatch):
    """render_pass traces the photon paths of its rounds in one wave and
    walks their camera lanes in one wave: two PPM rounds (each its own
    seed and radius) in one call equal the two rounds rendered one call
    each, bitwise, and so do waves cut to one round."""
    ts, tset = _fog(max_bounces=3)
    tset = replace(tset, integrator_type="progressive_photon_map")
    both, rays = trender.render_pass(ts, tset, 1, SEED, 2)
    one = [trender.render_pass(ts, tset, i, SEED, 1) for i in (1, 2)]
    assert np.array_equal(both.numpy(), (one[0][0] + one[1][0]).numpy())
    assert rays == one[0][1] + one[1][1]
    assert not np.array_equal(one[0][0].numpy(), one[1][0].numpy())
    monkeypatch.setattr(trender, "PHOTON_WAVE_BYTES", 1)
    cut, cut_rays = trender.render_pass(ts, tset, 1, SEED, 2)
    assert np.array_equal(cut.numpy(), both.numpy()) and cut_rays == rays


def test_volume_maps_hold_the_jax_brightness_bounds():
    """tests/test_photon_volume.py's bounds on the fog fixture, one
    photon round each: beams and planes against points, and the points
    map against the path tracer at 48 spp."""
    imgs = {}
    for kind in ("points", "beams", "planes"):
        kw = {} if kind == "points" else {"volume_photon_count": 2000}
        ts, tset = _fog(volume_photon_type=kind, **kw)
        assert tset.vol_photon_type == kind
        img = trender.render(ts, tset, spp=1, seed=SEED, device="cpu")
        assert np.isfinite(img).all() and img.mean() > 0
        imgs[kind] = img.mean()
    pt = trender.render(ts, replace(tset, integrator_type="path_tracer"),
                        spp=48, seed=SEED, device="cpu")
    assert 0.6 < imgs["beams"] / imgs["points"] < 1.7, imgs
    assert 0.5 < imgs["planes"] / imgs["points"] < 2.0, imgs
    assert 0.4 < imgs["points"] / pt.mean() < 2.5, (imgs, pt.mean())


def test_voxel_medium_asked_for_beams_renders_as_points(tmp_path):
    """The beams' and planes' analytic transmittance covers homogeneous
    media: a voxel medium takes the points estimator (the JAX package's
    choice, render.py:177-183), so the image and rays are the points
    map's."""
    r = np.random.default_rng(3)
    np.save(tmp_path / "fog.npy",
            r.uniform(0.5, 1.5, (6, 5, 6)).astype(np.float32))
    out = []
    for kind in ("beams", "points"):
        desc = _fog_scene(w=8, h=8)
        desc.path = str(tmp_path / "voxel.json")
        desc.media = [{"type": "voxel", "sigma_a": 0.02, "sigma_s": 0.25,
                       "grid": {"type": "dense", "file": "fog.npy",
                                "transform": {"position": [0, 0.5, 0],
                                              "scale": 6.0}}}]
        desc.integrator.update(max_bounces=2, volume_photon_type=kind)
        ts, tset = flatten_scene(desc, device="cpu")
        assert tset.vol_photon_type == kind and \
            tset.med_kinds == (MED_VOXEL,)
        img, rays = trender.render_pass(ts, tset, 0, SEED, 1)
        out.append((img.numpy(), rays))
    assert out[0][0].mean() > 0
    assert np.array_equal(out[0][0], out[1][0]) and out[0][1] == out[1][1]


def photon_scene_file(d, **renderer):
    """tests/test_torch_entry.py's scene file at 8x8 under photon_map
    with max_bounces 2 (one photon bounce) and 65,536 photon paths a
    round."""
    from test_torch_entry import write_scene
    path = write_scene(d, name="photon.json", **renderer)
    with open(path) as f:
        sj = json.load(f)
    sj["camera"]["resolution"] = [8, 8]
    sj["integrator"] = {"type": "photon_map", "max_bounces": 2,
                        "photon_count": 1 << 16, "gather_radius": 0.2,
                        "gather_photon_count": 8}
    with open(path, "w") as f:
        json.dump(sj, f)
    return path


def test_cli_and_server_render_a_photon_scene(tmp_path):
    """cli.render_scene writes render()'s image of the photon scene (and
    the path-traced post-pass's buffers); the server's framebuffer after
    two spp_step rounds is render()'s image."""
    from tungsten_tpu_torch import cli
    from tungsten_tpu_torch import server as srv
    from tungsten_tpu_torch.io import image as timage
    from tungsten_tpu_torch.scene.flatten import load_flat_scene
    from test_torch_entry import _cli_args, _free_port, _get
    path = photon_scene_file(str(tmp_path), output_file="out.png",
                             hdr_output_file="out.pfm", spp_step=1,
                             output_buffers=[{"type": "normal",
                                              "hdr_output_file": "n.pfm"}])
    out = cli.render_scene(path, _cli_args(spp=2))
    assert [os.path.basename(f) for f in out["files"]] == [
        "out.png", "out.pfm", "n.pfm"]
    assert out["spp"] == 2 and out["rays"] > 0
    ts, tset = load_flat_scene(path, "cpu")
    assert tset.integrator_type == "photon_map"
    img = trender.render(ts, tset, spp=2, seed=tset.seed, device="cpu")
    assert img.mean() > 0
    files = {os.path.basename(f): f for f in out["files"]}
    np.testing.assert_allclose(timage.load_hdr(files["out.pfm"]), img,
                               rtol=1e-6, atol=1e-7)
    assert np.abs(timage.load_hdr(files["n.pfm"])).max() > 0.5
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
    np.testing.assert_allclose(fb, img, rtol=1e-5, atol=1e-6)

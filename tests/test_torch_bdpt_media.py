"""The port's bidirectional path tracer against the JAX package on the
CPU, the general branch: media and forward-lobe surfaces, and the
thinlens camera.

The scene: a homogeneous HG fog inside a `forward` cube, a `thinsheet`
sphere, a mirror backdrop, a lambert floor and one emissive quad,
seen through a thinlens camera (aperture 0.3, cat eye 0.3, focused on
the cube), 16x12, 2 samples a pixel, the default (Sobol') sampler,
`bdpt_vertices` 3 and `max_bounces` 3.  The walks take the forward hop
budget, distance-sample the fog and collapse the forward crossings;
every connection runs the hop loop of _connection_walk (closest hits
through the forward and thinsheet surfaces, the fog's medium pdfs),
medium vertices connect through _vertex_conn_medium, and every lens
connection samples its aperture point and projects through
_thinlens_pixel.

One JAX compile of trace_bdpt (about 61 s on one worker; run eagerly,
its seven walk steps and hop loops take about 85 s), which also records
the subpaths and the light root it walked (see test_torch_bdpt.py);
against the port on the
same scene carried across, with the same tolerances: every vertex field,
the light root, radiance per lane, splats and rays, and render_pass's
image against the image of the JAX outputs.  The vertex fields agree on
>= 0.995 of lanes here, not 0.999: a lens ray that grazes the thinsheet
sphere crosses it in chords of 0.05 at a cosine near 0, where the
compiled JAX walk's transmittance parts from the eager JAX walk's by
4e-4 on one lane of the 384 (run eagerly, JAX gives the port's value to
the last bit), as tests/test_torch_media_render.py allows 0.995 for
its media scenes.
"""
import copy
import os

import numpy as np
import pytest
import torch

from tungsten_tpu.scene.flatten import flatten_scene as jax_flatten
from tungsten_tpu.scene.parse import SceneDesc
from tungsten_tpu_torch.integrators import bdpt as tb
from tungsten_tpu_torch.media.grid import MED_HOMOGENEOUS
from tungsten_tpu_torch.scene.flatten import (flat_scene_from_numpy,
                                              flatten_scene)
from test_torch_bdpt import (H, ROOT_FIELDS, SPP, W, _np, assert_vertices_agree,
                             bdpt_settings, close, jax_image, jax_trace,
                             port_render, port_trace)
from test_torch_flatten import jax_fields


def fog_box_desc(tmp):
    return SceneDesc(
        path=os.path.join(tmp, "scene.json"), json={},
        bsdfs=[{"name": "wall", "type": "lambert", "albedo": [0.7, 0.6, 0.5]},
               {"name": "boundary", "type": "forward"},
               {"name": "sheet", "type": "thinsheet", "ior": 1.45,
                "sigma_a": [0.3, 0.6, 1.2], "thickness": 0.4},
               {"name": "mirror", "type": "mirror", "albedo": 0.9}],
        media=[{"name": "fog", "type": "homogeneous", "sigma_a": 0.05,
                "sigma_s": [0.5, 0.6, 0.7],
                "phase_function": {"type": "henyey_greenstein", "g": 0.3}}],
        primitives=[
            {"type": "quad", "bsdf_index": 0, "emission": [7.0, 7.0, 7.0],
             "transform": {"position": [0, 2.4, 0], "scale": [1.2, 1, 1.2],
                           "rotation": [0, 0, 180]}},
            {"type": "quad", "bsdf_index": 0,
             "transform": {"position": [0, -1, 0], "scale": [8, 1, 8]}},
            {"type": "cube", "bsdf_index": 1, "int_medium_index": 0,
             "transform": {"position": [0.2, -0.1, 0], "scale": 1.6}},
            {"type": "sphere", "bsdf_index": 2,
             "transform": {"position": [-0.9, -0.3, 0.9], "scale": 0.45}},
            {"type": "quad", "bsdf_index": 3,
             "transform": {"position": [0, 0.5, -2.0], "scale": [3, 1, 2],
                           "rotation": [90, 0, 0]}}],
        camera={"type": "thinlens", "resolution": [W, H], "fov": 60,
                "aperture_size": 0.3, "cateye": 0.3, "focus_distance": 3.4,
                "transform": {"position": [0, 0.5, 3.4],
                              "look_at": [0, 0, 0]}},
        integrator={"type": "bidirectional_path_tracer"},
        renderer={"spp": SPP})


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    desc = fog_box_desc(str(tmp_path_factory.mktemp("bdpt_media")))
    js, jset = jax_flatten(copy.deepcopy(desc))
    ts = flat_scene_from_numpy(jax_fields(js), "cpu")
    _, tset = flatten_scene(copy.deepcopy(desc), device="cpu")
    jset, tset = bdpt_settings(jset), bdpt_settings(tset)
    assert tset.has_media and tset.med_kinds == (MED_HOMOGENEOUS,)
    assert tb._has_forward_types(tset) and tset.camera_type == "thinlens"
    assert tset.cat_eye == 0.3 and tset.stratified_sampler
    return dict(ts=ts, tset=tset,
                jax=jax_trace(js, jset, light_tracer=False),
                port=port_trace(ts, tset, light_tracer=False))


def test_subpaths_and_root_match_jax(traced):
    j, t = traced["jax"], traced["port"]
    for side in ("cam", "lig"):
        assert_vertices_agree(j[side], t[side], share=0.995)
        # real work: medium vertices and forward crossings (edges past
        # the recorded vertices)
        is_med = _np(t[side]["is_med"]) & _np(t[side]["valid"])
        assert is_med.mean() > 0.02, side
        orig = _np(t[side]["orig"])[:, 0]
        assert (orig > 1).mean() > 0.02, side
    for k in ROOT_FIELDS:
        assert close(j["root"][k], t["root"][k]).all(), k


def test_radiance_splats_and_rays_match_jax(traced):
    (jrad, jpix, jval, jrays) = traced["jax"]["bdpt"]
    (trad, tpix, tval, trays) = traced["port"]["bdpt"]
    lanes = close(jrad, trad)
    assert lanes.mean() >= 0.999, lanes.mean()
    assert (_np(trad).sum(-1) > 0).mean() > 0.1
    pix = close(jpix, tpix)
    assert pix.mean() >= 0.999, pix.mean()
    val = close(jval, tval)
    assert val.mean() >= 0.999, val.mean()
    assert (_np(tval).sum(-1) > 0).mean() > 0.01
    assert int(jrays) == int(trays)


def test_render_pass_matches_jax_image(traced):
    want = jax_image(*traced["jax"]["bdpt"][:3])
    img, stats = port_render(traced, "bidirectional_path_tracer",
                             return_stats=True)
    assert np.isfinite(img).all() and img.mean() > 0
    agree = np.isclose(img, want, rtol=1e-3, atol=1e-4).all(axis=-1)
    assert agree.mean() >= 0.99, agree.mean()
    assert abs(img.mean() / want.mean() - 1.0) <= 1e-4
    assert stats["rays"] == int(traced["jax"]["bdpt"][3])
    assert isinstance(traced["port"]["bdpt"][3], torch.Tensor)

"""The port's cameras and reconstruction filters against the JAX
package's on the CPU: generate_rays_w for every filter under the pinhole
camera, the thinlens camera (disk aperture, bitmap aperture, cat eye,
focus pivot), the equirectangular camera and the cubemap camera in all
four modes, on the same seeded pixels and samples under both samplers.
Origins and directions agree within rtol 1e-5 / atol 1e-6, weights
exactly; the filters' inverse-CDF tables are equal."""
import copy
import os
from dataclasses import replace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tungsten_tpu.cameras import camera as jcam
from tungsten_tpu.scene.flatten import flatten_scene as jax_flatten
from tungsten_tpu.scene.parse import SceneDesc
from tungsten_tpu.utils import rng as jrng
from tungsten_tpu_torch.cameras import camera as tcam
from tungsten_tpu_torch.io import image as timage
from tungsten_tpu_torch.scene.flatten import flatten_scene

W, H = 24, 18
SEED = 0xBA5EBA11
FILTERS = ["dirac", "box", "tent", "gaussian", "mitchell_netravali",
           "catmull_rom", "lanczos"]
CUBE_MODES = ["horizontal_cross", "vertical_cross", "row", "column"]


def _desc(tmp, camera):
    return SceneDesc(
        path=os.path.join(tmp, "scene.json"), json={},
        bsdfs=[{"type": "lambert", "albedo": 0.5}],
        primitives=[{"type": "quad", "bsdf_index": 0,
                     "emission": [1.0, 1.0, 1.0]},
                    {"type": "sphere", "name": "target", "bsdf_index": 0,
                     "transform": {"position": [0.4, 0.3, -1.1],
                                   "scale": 0.2}}],
        media=[], integrator={"type": "path_tracer"}, renderer={},
        camera=dict({"resolution": [W, H], "fov": 55,
                     "transform": {"position": [0.2, 1.0, 3.0],
                                   "look_at": [0, 0, 0]}}, **camera))


def _aperture(tmp):
    """A ring-and-bar aperture bitmap (uneven weights, dark texels)."""
    y, x = np.mgrid[0:11, 0:13]
    r = np.hypot((x - 6) / 6.0, (y - 5) / 5.0)
    img = np.where((r > 0.5) & (r < 0.95), 1.0, 0.0)
    img[5, :] = 0.3
    img = np.repeat(img[..., None], 3, -1).astype(np.float32)
    img[..., 0] *= 1.5
    timage.save_hdr(os.path.join(tmp, "aperture.pfm"), img)
    return "aperture.pfm"


def _rays_both(tmp, camera, sobol):
    desc = _desc(tmp, camera)
    js, jset = jax_flatten(copy.deepcopy(desc))
    ts, tset = flatten_scene(copy.deepcopy(desc), device="cpu")
    r = np.random.default_rng(5)
    n = 2048
    pixel = r.integers(0, W * H, n).astype(np.uint32)
    sample = r.integers(0, 64, n).astype(np.uint32)
    prev = jrng._SAMPLER
    jrng.set_sampler(sobol)
    try:
        jo, jd, jw = jcam.generate_rays_w(js, jset, jnp.asarray(pixel),
                                          jnp.asarray(sample),
                                          jnp.uint32(SEED))
    finally:
        jrng._SAMPLER = prev
    to, td, tw = tcam.generate_rays_w(
        ts, replace(tset, stratified_sampler=sobol),
        torch.from_numpy(pixel.astype(np.int32)),
        torch.from_numpy(sample.astype(np.int32)), SEED)
    return ((np.asarray(jo), np.asarray(jd), np.asarray(jw)),
            (to.numpy(), td.numpy(), tw.numpy()), tset)


def _assert_rays(j, t):
    (jo, jd, jw), (to, td, tw) = j, t
    assert to.shape == jo.shape and td.shape == jd.shape
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
    assert np.array_equal(tw, np.asarray(jw, np.float32))


@pytest.mark.parametrize("name", FILTERS)
def test_filter_tables_and_pinhole_rays(tmp_path, name):
    assert tcam.FILTER_WIDTHS == jcam.FILTER_WIDTHS
    if name in ("gaussian", "mitchell_netravali", "catmull_rom", "lanczos"):
        # the table-driven filters sample the same host table
        assert tcam._filter_invcdf(name) == jcam._filter_invcdf(name)
    x = np.linspace(-2.5, 2.5, 101)
    assert np.array_equal(tcam.filter_eval(name, x), jcam.filter_eval(name, x))
    j, t, _ = _rays_both(str(tmp_path), {"type": "pinhole",
                                         "reconstruction_filter": name},
                         sobol=name != "box")
    _assert_rays(j, t)


@pytest.mark.parametrize("case", ["disk", "bitmap", "cat_eye",
                                  "bitmap_cat_eye"])
@pytest.mark.parametrize("sobol", [False, True])
def test_thinlens_rays(tmp_path, case, sobol):
    cam = {"type": "thinlens", "aperture_size": 0.15,
           "focus_pivot": "target", "reconstruction_filter": "gaussian"}
    if "bitmap" in case:
        cam["aperture"] = _aperture(str(tmp_path))
    if "cat_eye" in case:
        cam["cateye"] = 0.08
    j, t, tset = _rays_both(str(tmp_path), cam, sobol)
    _assert_rays(j, t)
    assert tset.aperture_tex == ("bitmap" in case)
    # the focus distance is the pivot's distance from the camera
    assert abs(tset.focus_distance - np.linalg.norm(
        np.subtract([0.4, 0.3, -1.1], [0.2, 1.0, 3.0]))) < 1e-5
    w = t[2]
    if "cat_eye" in case:
        # cat-eye vignetted samples carry weight 0, the rest 1
        assert 0.02 < (w == 0).mean() < 0.9
    else:
        assert (w == 1).all()
    # the lens spreads the origins over the aperture
    spread = np.linalg.norm(t[0] - t[0].mean(0), axis=-1)
    assert 0 < spread.max() <= 0.15 * np.sqrt(2) + 1e-5


def test_equirectangular_rays(tmp_path):
    j, t, _ = _rays_both(str(tmp_path), {"type": "equirectangular",
                                         "reconstruction_filter": "tent"},
                         sobol=True)
    _assert_rays(j, t)
    np.testing.assert_allclose(np.linalg.norm(t[1], axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("mode", CUBE_MODES)
def test_cubemap_rays(tmp_path, mode):
    j, t, tset = _rays_both(str(tmp_path), {"type": "cubemap", "mode": mode,
                                            "reconstruction_filter": "box"},
                            sobol=True)
    assert tset.cubemap_mode == mode
    _assert_rays(j, t)
    # the cross layouts' dead zones get the degenerate (0, 1, 0) of the
    # JAX package; the strip layouts have none
    dead = np.all(t[1] == np.asarray([0.0, 1.0, 0.0], np.float32), axis=-1)
    if "cross" in mode:
        assert dead.any()
    else:
        assert not dead.any()

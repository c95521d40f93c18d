"""An unknown BSDF name in the port, against the JAX package on the CPU.

The JAX package maps a BSDF type name it does not know to ERROR (type
21), whose row evaluates to zero, so the surface renders black and ends
every path that reaches it.  The port does the same: its flattened BSDF
table equals JAX's flatten_scene bit for bit for a scene whose cube is
`{"type": "velvet"}`, bsdf_sample on the ERROR row gives what JAX's
gives (no valid flag, zero weight: the path ends there), and a CPU
render that sees only that cube is black where the same cube in lambert
is lit.  No JAX render or jit runs: the flatten and one eager
bsdf_sample are enough.
"""
import numpy as np
import jax.numpy as jnp
import torch

from tungsten_tpu.bsdf import eval as jev
from tungsten_tpu.scene.flatten import flatten_scene as jax_flatten
from tungsten_tpu.scene.parse import SceneDesc
from tungsten_tpu_torch.bsdf import eval as tev
from tungsten_tpu_torch.bsdf import types as tbt
from tungsten_tpu_torch.render import render
from tungsten_tpu_torch.scene.flatten import flatten_scene


def _scene(cube_bsdf: str):
    """tests/test_output_buffers.py's box (an overhead area light, a
    floor and a back wall) with a cube of `cube_bsdf` under the light and
    the camera close above it, so that the cube's top face fills the
    frame."""
    bsdfs = [{"type": "lambert", "albedo": [0.6, 0.3, 0.2]},
             {"type": "mirror", "albedo": 1.0},
             {"type": cube_bsdf, "albedo": 0.8}]
    prims = [
        {"type": "quad", "bsdf_index": 0, "emission": [8.0, 8.0, 8.0],
         "transform": {"position": [0, 2.4, 0], "scale": [1.0, 1.0, 1.0],
                       "rotation": [0, 0, 180]}},
        {"type": "quad", "bsdf_index": 0,
         "transform": {"position": [0, -1, 0], "scale": [10, 1, 10]}},
        {"type": "quad", "bsdf_index": 1,
         "transform": {"position": [0, 1, -3], "scale": [10, 1, 10],
                       "rotation": [90, 0, 0]}},
        {"type": "cube", "bsdf_index": 2,
         "transform": {"position": [0, 0, 0], "scale": [1.0, 1.0, 1.0]}},
    ]
    cam = {"type": "pinhole", "resolution": [8, 8], "fov": 20,
           "transform": {"position": [0, 1.8, 0.3], "look_at": [0, 0.5, 0]}}
    return SceneDesc(path="/tmp/dummy.json", json={}, bsdfs=bsdfs,
                     primitives=prims, media=[], camera=cam,
                     integrator={"max_bounces": 4}, renderer={"spp": 2})


def test_unknown_bsdf_flattens_to_error_as_jax():
    js, jset = jax_flatten(_scene("velvet"))
    ts, tset = flatten_scene(_scene("velvet"), device="cpu")
    assert int(ts.bsdf_type[2]) == tbt.ERROR == 21
    assert tset.present_bsdf_types == jset.present_bsdf_types
    for k in ("bsdf_type", "bsdf_albedo_tex", "bsdf_params", "bsdf_aux",
              "tex_type", "tex_const", "tex_params"):
        a = np.asarray(getattr(js, k))
        b = getattr(ts, k).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def test_error_row_samples_as_jax():
    """bsdf_sample on the ERROR row, eagerly in both packages on the same
    seeded inputs: flags 0 (not valid: the path ends) and zero weight
    and pdf on every lane, equal to JAX's."""
    js, jset = jax_flatten(_scene("velvet"))
    ts, tset = flatten_scene(_scene("velvet"), device="cpu")
    r = np.random.default_rng(21)
    n = 64
    wi = r.normal(size=(n, 3))
    wi[:, 2] = np.abs(wi[:, 2]) + 0.1
    wi = (wi / np.linalg.norm(wi, axis=1, keepdims=True)).astype(np.float32)
    uv = r.uniform(size=(n, 2)).astype(np.float32)
    u = r.uniform(size=(3, n)).astype(np.float32)
    bidx = np.full(n, 2, np.int32)
    types = jset.present_bsdf_types
    jout = [np.asarray(x) for x in jev.bsdf_sample(
        jev.ShadePoint(js, jnp.asarray(bidx), jnp.asarray(uv)),
        jnp.asarray(wi), *(jnp.asarray(x) for x in u), types)]
    tout = [x.numpy() for x in tev.bsdf_sample(
        tev.ShadePoint(ts, torch.from_numpy(bidx).long(),
                       torch.from_numpy(uv)),
        torch.from_numpy(wi), *(torch.from_numpy(x) for x in u),
        tset.present_bsdf_types)]
    for name, a, b in zip(("wo", "weight", "pdf", "flags"), jout, tout):
        assert np.array_equal(a, b), name
    assert (tout[3] & tev.FLAG_VALID == 0).all()
    assert (tout[1] == 0).all() and (tout[2] == 0).all()


def test_unknown_bsdf_renders_black():
    """A CPU render of the port whose every camera ray meets the velvet
    cube is black; the same frame with a lambert cube is lit."""
    out = {}
    for name in ("velvet", "lambert"):
        scene, settings = flatten_scene(_scene(name), device="cpu")
        out[name] = render(scene, settings, spp=2, seed=7, device="cpu")
    assert out["velvet"].shape == (8, 8, 3)
    assert (out["velvet"] == 0).all()
    assert np.isfinite(out["lambert"]).all()
    assert (out["lambert"].max(axis=-1) > 0).all()

"""The port's FlatScene against the JAX package's on the same scenes:
every field equal (bf16 env tables bit-equal), the wave-kernel cluster
tables byte-equal, and the carry-across function exact."""
import copy
from dataclasses import fields

import numpy as np
import pytest
import torch

from tungsten_tpu.scene.flatten import flatten_scene as jax_flatten
from tungsten_tpu_torch.io import image as timage
from tungsten_tpu_torch.scene.flatten import (TUPLE_FIELDS, FlatScene,
                                              RenderSettings,
                                              flat_scene_from_numpy,
                                              flatten_scene)
from test_output_buffers import _scene


def scene_with_env(tmp_path, mirror_floor):
    """tests/test_output_buffers.py::_scene plus an env map written with
    the port's image IO."""
    r = np.random.default_rng(7)
    sky = r.uniform(0.2, 2.0, (16, 32, 3)).astype(np.float32)
    sky[0] = 0.0   # a dark pole row exercises the distribution's floor
    timage.save_hdr(str(tmp_path / "sky.pfm"), sky)
    desc = _scene(mirror_floor=mirror_floor)
    desc.path = str(tmp_path / "scene.json")
    desc.primitives.append({"type": "infinite_sphere", "emission": "sky.pfm",
                            "transform": {"rotation": [0, 30, 0]}})
    return desc


def _numpy_bits(x):
    """Field -> numpy, bf16 held as its int16 bit pattern."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.name == "bfloat16" else x


def jax_fields(js):
    """A JAX FlatScene as numpy, keyed by the port's field names (the
    tuple fields, bitmaps and the media grids, as lists of arrays)."""
    out = {f.name: np.asarray(getattr(js, f.name))
           for f in fields(FlatScene)
           if f.name != "tri_fin" and f.name not in TUPLE_FIELDS}
    for name in TUPLE_FIELDS:
        out[name] = [np.asarray(b) for b in getattr(js, name)]
    return out


def _assert_same_scene(ts, ref):
    for f in fields(FlatScene):
        if f.name in TUPLE_FIELDS:
            got = getattr(ts, f.name)
            assert len(got) == len(ref[f.name]), f.name
            for a, b in zip(got, ref[f.name]):
                a, b = _numpy_bits(a), _numpy_bits(b)
                assert a.dtype == b.dtype and a.shape == b.shape, f.name
                assert np.array_equal(a, b), f.name
            continue
        if f.name == "tri_fin":
            want = np.concatenate([ref["tri_v0"], ref["tri_e1"],
                                   ref["tri_e2"]], axis=1)
        else:
            want = _numpy_bits(ref[f.name])
        got = _numpy_bits(getattr(ts, f.name))
        assert got.dtype == want.dtype, f.name
        assert got.shape == want.shape, f.name
        assert np.array_equal(got, want), f.name


@pytest.mark.parametrize("mirror_floor", [False, True])
@pytest.mark.parametrize("with_env", [False, True])
def test_flat_scene_equals_jax(tmp_path, mirror_floor, with_env):
    desc = scene_with_env(tmp_path, mirror_floor) if with_env else \
        _scene(mirror_floor=mirror_floor)
    js, jset = jax_flatten(copy.deepcopy(desc))
    ts, tset = flatten_scene(copy.deepcopy(desc), device="cpu")
    ref = jax_fields(js)
    _assert_same_scene(ts, ref)
    # the wave tables byte for byte
    for k in ("wk_boxes", "wk_cbox", "wk_sbox", "wk_attr", "wk_remap"):
        assert getattr(ts, k).numpy().tobytes() == ref[k].tobytes(), k
    assert ts.env_image.dtype == torch.bfloat16
    assert ts.env_quad.dtype == torch.bfloat16
    for f in fields(RenderSettings):
        assert getattr(tset, f.name) == getattr(jset, f.name), f.name
    # carry-across: the JAX scene's arrays rebuild the port's scene
    _assert_same_scene(flat_scene_from_numpy(ref, "cpu"), ref)


def test_mesh_scene_equals_jax(tmp_path):
    """A .wo3 mesh written with the port's mesh IO: BVH order, shading
    rows and the light tables equal the JAX build."""
    from tungsten_tpu_torch.io import mesh as tmesh
    r = np.random.default_rng(3)
    pos = r.uniform(-1, 1, (60, 3)).astype(np.float32)
    idx = r.integers(0, 60, (90, 3)).astype(np.int32)
    tmesh.save_wo3(str(tmp_path / "m.wo3"), tmesh.Mesh(
        pos=pos, normal=np.zeros_like(pos), uv=r.uniform(size=(60, 2))
        .astype(np.float32), indices=idx, material=np.zeros(90, np.int32)))
    desc = scene_with_env(tmp_path, False)
    desc.primitives.append({"type": "mesh", "file": "m.wo3", "bsdf_index": 1,
                            "transform": {"position": [0, 0.2, 0],
                                          "scale": 0.5}})
    desc.primitives.append({"type": "cube", "bsdf_index": 0, "power": 3.0,
                            "transform": {"position": [1, 0, 1]}})
    js, _ = jax_flatten(copy.deepcopy(desc))
    ts, _ = flatten_scene(copy.deepcopy(desc), device="cpu")
    _assert_same_scene(ts, jax_fields(js))


@pytest.mark.parametrize("key,what", [("crv_seg_p0", "curves"),
                                      ("dsk_r", "disks"),
                                      ("sph_radius", "spheres")])
def test_carry_across_refuses_unported_tables(key, what):
    """A JAX scene with curves or analytic primitives cannot be carried
    across silently: the port does not shade them yet."""
    js, _ = jax_flatten(_scene())
    flds = jax_fields(js)
    flds[key] = np.zeros((1, 4), np.float32)
    with pytest.raises(NotImplementedError, match=what):
        flat_scene_from_numpy(flds, "cpu")

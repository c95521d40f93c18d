"""The port's FlatScene against the JAX package's on the same scenes:
every field equal (bf16 env tables bit-equal), the wave-kernel cluster
tables byte-equal, and the carry-across function exact."""
import copy
import os
from dataclasses import fields

import numpy as np
import pytest
import torch

from tungsten_tpu.scene.flatten import flatten_scene as jax_flatten
from tungsten_tpu_torch.io import image as timage
from tungsten_tpu_torch.scene.flatten import (TUPLE_FIELDS, FlatScene,
                                              RenderSettings,
                                              flat_scene_from_numpy,
                                              flatten_scene, pack_curve_rows)
from test_output_buffers import _scene

# Under pytest-xdist each worker imports every test module while it
# collects, so this runs in every worker before its first test: PyTorch's
# intra-op pool gets the worker's share of the cores (1 thread for 6
# workers on 8 cores).  With PyTorch's default of a thread a core, the
# workers' pools contend, and the port's CPU tests ran 2-12x slower.
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _WORKERS:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))


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


# the port's packed fields, which the JAX FlatScene does not carry
PACKED = ("tri_fin", "crv_rows", "cwbvh_rows")


def jax_fields(js):
    """A JAX FlatScene as numpy, keyed by the port's field names (the
    tuple fields, bitmaps and the media grids, as lists of arrays)."""
    out = {f.name: np.asarray(getattr(js, f.name))
           for f in fields(FlatScene)
           if f.name not in PACKED and f.name not in TUPLE_FIELDS}
    for name in TUPLE_FIELDS:
        out[name] = [np.asarray(b) for b in getattr(js, name)]
    return out


def _assert_same_scene(ts, ref):
    rows = dict(zip(("crv_rows", "cwbvh_rows"), pack_curve_rows(
        {k: torch.from_numpy(np.array(ref[k])) for k in (
            "crv_pc_q0", "crv_pc_q1", "crv_pc_nmid", "crv_pc_t0",
            "crv_pc_t1", "crv_pc_seg", "crv_seg_mode", "cbvh_min",
            "cbvh_max", "cbvh_meta", "cbvh_skip")})))
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
        elif f.name in rows:
            want = rows[f.name].numpy()
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


@pytest.fixture(scope="module")
def curve_scene(tmp_path_factory):
    """A JAX scene with curves in all four modes and the three fiber
    BCSDFs (a hair row named and one by default), as numpy fields."""
    from test_torch_curves import FIBERS, desc_of, mixed_prims
    tmp = str(tmp_path_factory.mktemp("carry"))
    js, _ = jax_flatten(desc_of(tmp, copy.deepcopy(FIBERS),
                                mixed_prims(tmp)))
    return jax_fields(js)


@pytest.mark.parametrize("key", ["crv_seg_p0", "crv_pc_q0", "bsdf_type"])
def test_carry_across_curve_and_fiber_tables(curve_scene, key):
    """A JAX scene with curves and fiber BSDFs carries across exactly:
    the segment tables (crv_seg_*), the piece tables with the piece BVH
    (crv_pc_*, cbvh_*) and the packed rows the curve walk reads, and the
    BSDF table with the hair tables (bsdf_*, hair_*)."""
    from tungsten_tpu.bsdf import types as jbt
    ref = curve_scene
    ts = flat_scene_from_numpy(ref, "cpu")
    _assert_same_scene(ts, ref)
    family = {"crv_seg_p0": ("crv_seg_",), "crv_pc_q0": ("crv_pc_", "cbvh_"),
              "bsdf_type": ("bsdf_", "hair_")}[key]
    names = [f.name for f in fields(FlatScene)
             if f.name.startswith(family) and f.name not in PACKED]
    assert len(names) >= 4 and np.asarray(ref[key]).shape[0] > 0
    for name in names:
        assert np.array_equal(getattr(ts, name).numpy(), ref[name]), name
    if key == "crv_pc_q0":
        assert ts.crv_rows.shape == (ref[key].shape[0], 16)
        assert ts.cwbvh_rows.shape[1] == 32
        assert 0 < ts.cwbvh_rows.shape[0] < ref["cbvh_meta"].shape[0]
        assert np.array_equal(ts.crv_rows[:, :4].numpy(), ref[key])
    if key == "bsdf_type":
        types = set(ref[key].tolist())
        assert {jbt.HAIR, jbt.ROUGH_WIRE, jbt.LAMBERTIAN_FIBER} <= types
        assert ts.hair_values.shape[0] == 2

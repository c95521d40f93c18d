"""Import boundary of the PyTorch port: tungsten_tpu_torch (and
chip_smoke.py) import neither JAX nor anything of tungsten_tpu, and the
entry points refuse to run without CUDA unless asked for the CPU."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tungsten_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "tungsten_tpu")


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(PKG):
        for fn in sorted(files):
            if fn.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, fn), ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return out


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    assert len(mods) >= 15
    for m in ("bsdf.fresnel", "bsdf.microfacet", "bsdf.eval", "bsdf.types",
              "ops.wave_trace", "cli", "server", "integrators.checkpoint",
              "tools.mxubench", "tools.denoiser", "tools.hdrmanip",
              "tools.scenemanip", "tools.obj2json", "tools.json2xml",
              "utils.debug", "media.phase", "media.transmittance",
              "media.grid", "io.vdb", "scene.sky", "scene.hosek_data",
              "cameras.camera", "integrators.lights", "io.curves",
              "bsdf.fiber", "ops.curve_trace", "ops.intersect",
              "parallel.sharded", "parallel.distributed", "bsdf.invert",
              "integrators.invert_path", "integrators.mlt", "native",
              "io.mesh", "io.image", "scene.bvh", "utils.sobol"):
        assert "tungsten_tpu_torch." + m in mods
    # the sky bake reads the port's own copy of the Hosek-Wilkie data
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'tungsten_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "from tungsten_tpu_torch.scene import hosek_data, sky\n"
            "assert hosek_data.DATASET.startswith("
            f"{os.path.join(PKG, 'scene')!r})\n"
            "assert sky.generate_sky([0, 1, 0], width=8, height=4).max() > 0\n"
            "from tungsten_tpu_torch.bsdf import fiber\n"
            "t = fiber.precompute_hair_azimuthal([0.2, 0.3, 0.5], 0.3)\n"
            "assert t['values'].shape == (3, 64, 64, 3)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'tungsten_tpu') and sys.modules[m] is not None]\n"
            "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_import_statement(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_cuda_sources_stand_alone():
    """Every CUDA source of the port is built by its module's kernel build
    and has a plain C interface: no PyTorch, ATen or pybind header."""
    from tungsten_tpu_torch.ops import curve_trace, segment_sum, wave_trace
    from tungsten_tpu_torch.tools import mxubench
    csrc = os.path.join(PKG, "csrc")
    cus = sorted(f for f in os.listdir(csrc) if f.endswith((".cu", ".cuh")))
    assert cus == ["curve_trace.cu", "leaf_mma.cu", "segment_sum.cu",
                   "wave_trace.cu"]
    for fn, mod in (("wave_trace.cu", wave_trace), ("leaf_mma.cu", mxubench),
                    ("curve_trace.cu", curve_trace),
                    ("segment_sum.cu", segment_sum)):
        with open(mod.__file__) as f:
            assert f'"csrc/{fn}"' in f.read(), fn
        with open(os.path.join(csrc, fn)) as f:
            includes = [ln for ln in f if ln.lstrip().startswith("#include")]
        assert includes and not any(
            h in ln for ln in includes
            for h in ("torch", "ATen", "pybind", "Python.h")), includes


def _tiny_scene():
    from tungsten_tpu_torch.scene.parse import SceneDesc
    return SceneDesc(
        path="scene.json", json={},
        bsdfs=[{"type": "lambert", "albedo": 0.5}],
        primitives=[{"type": "quad", "bsdf_index": 0,
                     "emission": [1.0, 1.0, 1.0]}],
        media=[], camera={"type": "pinhole", "resolution": [8, 8]},
        integrator={"type": "path_tracer"}, renderer={})


def test_entry_points_raise_without_cuda(monkeypatch):
    from tungsten_tpu_torch.ops.wave_trace import (wave_intersect,
                                                   wave_intersect_paged)
    from tungsten_tpu_torch.render import render
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    scene, settings = flatten_scene(_tiny_scene(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        flatten_scene(_tiny_scene())
    with pytest.raises(RuntimeError, match="CUDA"):
        render(scene, settings, spp=1)
    from dataclasses import replace
    for integ in ("kelemen_mlt", "multiplexed_mlt", "reversible_jump_mlt"):
        with pytest.raises(RuntimeError, match="CUDA"):
            render(scene, replace(settings, integrator_type=integ), spp=1)
    o = torch.zeros((4, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        wave_intersect(scene, o, o + 1.0, 0.0, 1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        wave_intersect_paged(scene, o, o + 1.0, 0.0, 1.0)
    from tungsten_tpu_torch import cli, server
    from tungsten_tpu_torch.tools import denoiser, mxubench
    a = torch.ones((48, 128), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="CUDA"):
        mxubench.bench(128, 48, 128, iters=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        mxubench.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        server.render_with_server(["scene.json"], port=0)
    img3 = np.zeros((4, 4, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        denoiser.nfor_denoise(img3, img3, img3, None, None, None)
    from tungsten_tpu_torch.parallel.distributed import init_distributed
    for k, v in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", "29500"),
                 ("WORLD_SIZE", "1"), ("RANK", "0")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_distributed()
    args = cli.build_parser().parse_args(["scene.json"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.render_scene("scene.json", args)
    # asked for the CPU, the same entry points run
    img = render(scene, settings, spp=1, device="cpu")
    assert img.shape == (8, 8, 3) and (img >= 0).all()
    assert mxubench.mma_loop(a, 128, 1, True)[0].shape == (1, 128)


def test_unported_features_raise():
    """What the port does not run raises, naming it: a minecraft_map
    primitive (the JAX package refuses it too), an integrator neither
    package knows, at flatten time and in render_pass, and a camera type
    the port does not know (the JAX package renders it as a pinhole; the
    port refuses it by design)."""
    from tungsten_tpu_torch.render import render_pass
    from tungsten_tpu_torch.scene.flatten import flatten_scene
    desc = _tiny_scene()
    desc.primitives.append({"type": "minecraft_map", "bsdf_index": 0,
                            "file": "level.dat"})
    with pytest.raises(NotImplementedError, match="minecraft_map"):
        flatten_scene(desc, device="cpu")
    desc = _tiny_scene()
    desc.integrator = {"type": "vertex_connection_merging"}
    with pytest.raises(NotImplementedError,
                       match="vertex_connection_merging"):
        flatten_scene(desc, device="cpu")
    scene, settings = flatten_scene(_tiny_scene(), device="cpu")
    from dataclasses import replace
    with pytest.raises(NotImplementedError,
                       match="vertex_connection_merging"):
        render_pass(scene, replace(
            settings, integrator_type="vertex_connection_merging"),
            0, 0xBA5EBA11)
    desc = _tiny_scene()
    desc.camera = {"type": "orthographic", "resolution": [8, 8]}
    with pytest.raises(NotImplementedError, match="orthographic"):
        flatten_scene(desc, device="cpu")


@pytest.mark.parametrize("kernel", ["closest", "anyhit", "paged_walk",
                                    "curve_closest", "curve_anyhit"])
def test_kernel_wrappers_refuse_cpu_tensors(kernel):
    """A traversal kernel's wrapper launches on CUDA tensors only: given
    CPU tensors it raises before it builds or launches anything, and
    counts no launch (the plain walk is the wave_intersect* and
    curve_walk wrappers' CPU path, not the kernel wrappers')."""
    from tungsten_tpu_torch.ops import curve_trace as tct
    from tungsten_tpu_torch.ops import wave_trace as twt
    if kernel.startswith("curve"):
        o = torch.zeros((8, 3))
        t = torch.ones((8,))
        before = dict(tct.LAUNCHES)
        with pytest.raises(ValueError, match="CUDA tensor"):
            tct.curve_kernel(torch.zeros((8, 16)), torch.zeros((3, 8)), o,
                             o + 1.0, t * 0, t, kernel == "curve_anyhit")
        assert tct.LAUNCHES == before
        return
    nb = twt.BLOCK // twt.WARP
    f = torch.zeros((twt.BLOCK, twt.FCOLS))
    lists = torch.zeros((nb, 128))
    cbox = torch.zeros((256, 8))
    attr = torch.zeros((256 * twt.ATTR_ROWS, twt.CLUSTER))
    before = dict(twt.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        if kernel == "paged_walk":
            ranges = torch.zeros((nb, 1), dtype=torch.int32)
            twt.paged_anyhit_kernel(f, lists, lists.int(), ranges[:1],
                                    ranges, ranges, cbox, attr, splits=2)
        else:
            twt.wave_kernel(f, lists, lists.int(), cbox, attr,
                            kernel == "anyhit", splits=2)
    assert twt.LAUNCHES == before

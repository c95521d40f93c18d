"""The port's host runtime against the JAX package's: the OBJ loader
(native/objloader.cpp and io/mesh.py::load_obj_python) on seeded files,
an OBJ-mesh scene flattened and rendered, and the public helpers the
port copies (save_image, save_mesh, sah_cost, validate_matrix,
supported_types, the vecmath transforms).

The JAX package's native loader is the reference wherever it gives an
answer.  Where it does not, the port keeps its own behaviour, recorded
here: it keys a corner on its whole resolved (v, vt, vn) triple where
the JAX key packs three 21-bit fields that can collide, and a corner
that does not start with an integer ends its face where the JAX loader
loops forever.  The JAX package's Python fallback keys a corner on its
token, so a relative corner keeps the vertex it named the first time.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tungsten_tpu import native as jnative
from tungsten_tpu_torch import native as tnative
from tungsten_tpu_torch.io import mesh as tmesh

needs_jax_native = pytest.mark.skipif(
    not jnative.available(), reason="the JAX package's native library "
    "cannot be built here (no g++)")


def _write(tmp_path, name, text):
    path = tmp_path / name
    path.write_bytes(text.encode("latin-1") if isinstance(text, str)
                     else text)
    return str(path)


def _arrays(m):
    """A Mesh (of either package) or a loader's tuple as its 4 arrays."""
    if hasattr(m, "indices"):
        return (m.pos, m.normal, m.uv, m.indices)
    return tuple(m)


def _assert_bitwise(a, b):
    for x, y, name in zip(_arrays(a), _arrays(b), ("pos", "normal", "uv",
                                                   "indices")):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name


def _f(rng):
    return repr(float(np.float32(rng.uniform(-2, 2))))


def _obj_case(kind: str, seed: int = 0) -> str:
    """A seeded OBJ file of one corner / index style."""
    rng = np.random.default_rng(seed)
    nv, nt, nn = 24, 12, 8
    lines = ["# seeded test file", "o thing"]
    lines += [f"v {_f(rng)} {_f(rng)} {_f(rng)}" for _ in range(nv)]
    if kind != "absent":
        lines += [f"vt {_f(rng)} {_f(rng)}" for _ in range(nt)]
        lines += [f"vn {_f(rng)} {_f(rng)} {_f(rng)}" for _ in range(nn)]
    forms = {"positive": ["v/t/n"], "negative": ["v/t/n"],
             "mixed": ["v/t/n"], "forms": ["v", "v//n", "v/t", "v/t/n"],
             "absent": ["v"]}[kind]
    for _ in range(30):
        k = int(rng.choice([3, 3, 4, 5, 7]))
        corners = []
        for _ in range(k):
            ids = [int(rng.integers(0, nv)), int(rng.integers(0, nt)),
                   int(rng.integers(0, nn))]
            neg = kind == "negative" or (kind == "mixed" and
                                         rng.random() < 0.5)
            v, t, n = ((i - c if neg else i + 1)
                       for i, c in zip(ids, (nv, nt, nn)))
            form = forms[int(rng.integers(0, len(forms)))]
            corners.append(form.replace("v", str(v), 1)
                           .replace("t", str(t)).replace("n", str(n)))
        lines.append("f " + " ".join(corners))
    return "\n".join(lines) + "\n"


def exporter_obj(pos, nrm, uv, idx) -> str:
    """A mesh written as exporters write one: each triangle's three
    corners as v / vt / vn lines just before `f -3/-3/-3 -2/-2/-2
    -1/-1/-1`, every float as repr of its f32 value (read back exactly)."""
    out = []
    for tri in idx:
        for arr, tag in ((pos, "v"), (uv, "vt"), (nrm, "vn")):
            for k in tri:
                out.append(tag + " " + " ".join(repr(float(x))
                                                for x in arr[k]))
        out.append("f -3/-3/-3 -2/-2/-2 -1/-1/-1")
    return "\n".join(out) + "\n"


def _exporter_case() -> str:
    rng = np.random.default_rng(5)
    pos = rng.uniform(-1, 1, (10, 3)).astype(np.float32)
    nrm = rng.normal(size=(10, 3)).astype(np.float32)
    uv = rng.uniform(size=(10, 2)).astype(np.float32)
    idx = rng.integers(0, 10, (16, 3)).astype(np.int32)
    return exporter_obj(pos, nrm, uv, idx)


CASES = ["positive", "negative", "mixed", "forms", "absent", "exporter"]


def _case_text(case):
    return _exporter_case() if case == "exporter" else _obj_case(case)


@needs_jax_native
@pytest.mark.parametrize("case", CASES)
def test_native_loader_matches_jax_native(tmp_path, case):
    path = _write(tmp_path, "m.obj", _case_text(case))
    got = tnative.load_obj_native(path)
    want = jnative.load_obj_native(path)
    assert got is not None and want is not None
    assert got[3].shape[0] > 0
    _assert_bitwise(got, want)


@pytest.mark.parametrize("case", CASES)
def test_python_loader_matches_native(tmp_path, case):
    """The fallback gives the native loader's Mesh bitwise, and both
    write material 0."""
    path = _write(tmp_path, "m.obj", _case_text(case))
    nat = tmesh.load_obj(path)
    py = tmesh.load_obj_python(path)
    _assert_bitwise(nat, py)
    assert tnative.load_obj_native(path) is not None
    for m in (nat, py):
        assert m.material.dtype == np.int32
        assert np.array_equal(m.material, np.zeros(m.num_tris, np.int32))


INTERLEAVED = ("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n"
               "v 5 0 0\nv 6 0 0\nv 5 1 0\nf -3 -2 -1\n")


def test_interleaved_relative_corners(tmp_path):
    """Each face's relative corners name the vertices written just before
    it: the second triangle lies at x = 5..6 in both of the port's
    routes and in the JAX native loader.  The JAX package's Python
    fallback keys corners on their tokens, so it stacks the second
    triangle on the first, with material -1 (ROADMAP C-ref 10)."""
    path = _write(tmp_path, "i.obj", INTERLEAVED)
    want = np.array([[0, 1], [5, 6]], np.float32)
    for m in (tmesh.load_obj(path), tmesh.load_obj_python(path)):
        x = m.pos[m.indices][..., 0]
        assert np.array_equal(np.stack([x.min(1), x.max(1)], 1), want)
        assert m.pos.shape == (6, 3)
        assert np.array_equal(m.material, [0, 0])
    if jnative.available():
        _assert_bitwise(tmesh.load_obj(path), jnative.load_obj_native(path))
    from tungsten_tpu.io import mesh as jmesh
    os.environ["TUNGSTEN_TPU_NO_NATIVE"] = "1"
    jnative._lib = None
    jnative._tried = False
    try:
        old = jmesh.load_obj(path)
    finally:
        os.environ.pop("TUNGSTEN_TPU_NO_NATIVE")
        jnative._lib = None
        jnative._tried = False
    x = old.pos[old.indices][..., 0]
    assert np.array_equal(np.stack([x.min(1), x.max(1)], 1),
                          np.array([[0, 1], [0, 1]], np.float32))
    assert np.array_equal(old.material, [-1, -1])


# Two corners whose JAX keys, (v+1)<<42 ^ (t+1)<<21 ^ (n+1), are equal
# though their triples differ (ROADMAP C-ref 11): the vt field reaching
# into the v field, and the vn field into the vt field.  The large
# indices lie out of range, so the corner gets zero uv / normal, and the
# files stay a few lines long.
COLLISIONS = {
    "vt_into_v": ("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2/6291456 3\n", 2),
    "vn_into_vt": ("v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0.25 0.75\n"
                   "f 1/1 2 3\nf 1//2097152 3 2\n", 3),
}


@pytest.mark.parametrize("case", sorted(COLLISIONS))
def test_port_unifies_only_equal_triples(tmp_path, case):
    text, distinct = COLLISIONS[case]
    path = _write(tmp_path, "c.obj", text)
    nat = tmesh.load_obj(path)
    _assert_bitwise(nat, tmesh.load_obj_python(path))
    assert nat.pos.shape[0] == distinct + 1
    if case == "vt_into_v":
        assert np.array_equal(nat.indices, [[0, 1, 2]])
    else:
        # the second face's first corner is its own vertex, uv zero
        assert nat.indices[1, 0] == 3 and not nat.uv[3].any()
        assert np.array_equal(nat.uv[0], [0.25, 0.75])
    if jnative.available():
        old = jnative.load_obj_native(path)
        assert old[0].shape[0] == distinct      # the JAX key merged two
        assert not np.array_equal(old[3], nat.indices)


def _long_line_case():
    corners = " ".join(str(1 + k % 3) for k in range(5000))   # 10k bytes
    return ("v 0 0 0\nv 1 0 0\nv 0 1 0\nv " + "0" * 9000 + "1 2 3\n"
            "f " + corners + "\nf 1 2 3\n")


EDGES = {
    # fgets reads 8,191 bytes a piece: a longer line comes in pieces, its
    # tail parsed as lines of its own
    "long_lines": _long_line_case(),
    # an out-of-range corner is dropped (the JAX Python loader raises)
    "out_of_range": "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 9 3\nf 0 1 2 3\n"
                    "f -4 1 2 3\n",
    # sscanf fails on a one-coordinate vt: the line adds nothing, so the
    # following vt takes its index
    "vt_one_coordinate": "v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0.5\nvt 0.25 0.5\n"
                         "f 1/1 2/1 3/2\n",
    # glibc's %f: hex floats, inf / nan, an exponent without digits, a
    # number ending at a second '.', tabs, CRLF line ends
    "scanner": "v 0x1.8p1 -0X.4P-2 1e\nv inf -nan 1.5.\nv\t+.5\t-5.e-1 7E+\n"
               "vn 1ex 2 3\nvn 0x 1 2\nvn infinity 2 3e0\nvn 1 2 3\r\n"
               "f 1//1 2//1 3//1\r\nf\t3 2 1\n",
    # decimals whose f64 value is an f32 rounding tie: strtof rounds
    # once, float() then astype(float32) twice
    "rounding": "v 1.000000059604644775390625000001 "
                "1.00000005960464477539062499999 "
                "3.4028235677973366163753939545814256844e38\n"
                "v 1 0 0\nv 0 1 0\nf 1 2 3\n",
}


@pytest.mark.parametrize("case", sorted(EDGES))
def test_edge_cases_follow_the_native_loader(tmp_path, case):
    path = _write(tmp_path, "e.obj", EDGES[case])
    nat = tnative.load_obj_native(path)
    assert nat is not None
    _assert_bitwise(nat, tmesh.load_obj_python(path))
    if jnative.available():
        _assert_bitwise(nat, jnative.load_obj_native(path))
    pos, _, uv, idx = nat
    if case == "long_lines":
        assert 3 < idx.shape[0] < 4998
    elif case == "out_of_range":
        assert np.array_equal(idx, [[0, 1, 2]] * 3)
    elif case == "vt_one_coordinate":
        assert np.array_equal(uv[0], [0.25, 0.5])
    elif case == "scanner":
        assert pos.shape[0] == 6 and np.isinf(pos).any()
    elif case == "rounding":
        naive = np.float32(float("1.000000059604644775390625000001"))
        assert pos[idx[0, 0], 0] != naive      # once vs twice rounded
        assert pos[idx[0, 0], 0] == np.nextafter(np.float32(1), 2,
                                                 dtype=np.float32)
        assert pos[idx[0, 0], 1] == np.float32(1)
        assert pos[idx[0, 0], 2] == np.finfo(np.float32).max


def test_comment_after_a_face_ends_it(tmp_path):
    """A corner that does not start with an integer ends the face in both
    of the port's routes; the JAX native loader loops on it forever
    (ROADMAP C-ref 12), shown in a child process stopped after 1 s."""
    text = "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nf 1 2 3 # note\nf 2 4 3 x 1\n"
    path = _write(tmp_path, "h.obj", text)
    for m in (tmesh.load_obj(path), tmesh.load_obj_python(path)):
        assert np.array_equal(m.indices, [[0, 1, 2], [1, 3, 2]])
    if not jnative.available():
        return
    code = ("import ctypes, sys\n"
            "lib = ctypes.CDLL(sys.argv[1])\n"
            "n = ctypes.c_int64()\n"
            "lib.trt_load_obj(sys.argv[2].encode(), ctypes.byref(n), "
            "ctypes.byref(n))\n")
    with pytest.raises(subprocess.TimeoutExpired):
        subprocess.run([sys.executable, "-c", code, jnative._LIB_PATH, path],
                       timeout=1)


def test_concurrent_loads_keep_their_own_files(tmp_path):
    """trt_load_obj stages its result in a global until trt_obj_fetch
    frees it; the binding's lock keeps each thread's load and fetch
    together (ctypes lets the threads run the parser at once)."""
    import threading
    paths = [_write(tmp_path, f"{k}.obj", _obj_case(kind, k))
             for k, kind in enumerate(("positive", "negative", "forms",
                                       "mixed"))]
    want = [tnative.load_obj_native(p) for p in paths]
    bad, interval = [], sys.getswitchinterval()

    def worker(k):
        for i in range(25):
            j = (k + i) % len(paths)
            got = tnative.load_obj_native(paths[j])
            if any(a.tobytes() != b.tobytes() for a, b in zip(got, want[j])):
                bad.append(j)

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not bad


def _noise_file(rng) -> str:
    """A file of random, mostly malformed statements (no face corner that
    does not start with an integer, where the JAX loader would hang)."""
    alph = ["0", "1", "7", " ", "\t", ".", "e", "E", "+", "-", "x", "p",
            "a", "i", "n", "inf", "nan", "1e", "0x", "1.5", "#", "\r",
            "\v", "\0"]

    def noise(k):
        return "".join(alph[int(i)] for i in rng.integers(0, len(alph), k))
    lines = []
    for _ in range(int(rng.integers(5, 30))):
        r = rng.random()
        if r < 0.3:
            head = ["v ", "v\t", " v ", "vn", "vt ", "v"][int(rng.integers(6))]
            lines.append(head + " ".join(
                noise(int(rng.integers(1, 5))) if rng.random() < 0.4 else
                repr(float(np.float32(rng.uniform(-3, 3))))
                for _ in range(int(rng.integers(0, 4)))))
        elif r < 0.55:
            cs = []
            for _ in range(int(rng.integers(0, 6))):
                c = str(int(rng.integers(-6, 8)))
                m = rng.random()
                if m < 0.3:
                    c += f"/{int(rng.integers(-4, 5))}"
                elif m < 0.5:
                    c += f"//{int(rng.integers(-4, 5))}"
                elif m < 0.7:
                    c += f"/{int(rng.integers(-4, 5))}/{int(rng.integers(-4, 5))}"
                cs.append(c)
            lines.append("f " + " ".join(cs))
        elif r < 0.85:
            lines.append("v " + " ".join(
                repr(float(np.float32(rng.uniform(-5, 5)))) for _ in range(3)))
        else:
            lines.append(noise(int(rng.integers(0, 12))))
    return "\n".join(lines) + "\n"


def test_python_loader_matches_native_on_noise(tmp_path):
    rng = np.random.default_rng(11)
    path = str(tmp_path / "n.obj")
    for _ in range(80):
        with open(path, "wb") as f:
            f.write(_noise_file(rng).encode("latin-1"))
        py = tmesh.load_obj_python(path)
        nat = tnative.load_obj_native(path)
        if nat is None:
            assert py.pos.shape[0] == 0 or py.num_tris == 0
            continue
        _assert_bitwise(nat, py)
        if jnative.available():
            _assert_bitwise(nat, jnative.load_obj_native(path))


# --------------------------------------------------- an OBJ-mesh scene

def _uv_sphere(nu, nv):
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
            if i > 0:
                tris.append((a, a + 1, a + nu + 1))
            if i < nv - 1:
                tris.append((a + 1, a + nu + 2, a + nu + 1))
    return pos, pos.copy(), uv, np.asarray(tris, np.int32)


def _mesh_scene(tmp, ext: str) -> str:
    """Two UV spheres (one lambert, one mirror) stored as `ext`, a floor
    and a light quad, 16x16, 2 bounces."""
    pos, nrm, uv, idx = _uv_sphere(12, 6)
    if ext == "obj":
        with open(os.path.join(tmp, "ball.obj"), "w") as f:
            f.write(exporter_obj(pos, nrm, uv, idx))
    else:
        tmesh.save_wo3(os.path.join(tmp, "ball.wo3"), tmesh.Mesh(
            pos=pos, normal=nrm, uv=uv, indices=idx,
            material=np.zeros(len(idx), np.int32)))
    sj = {"bsdfs": [{"name": "d", "type": "lambert",
                     "albedo": [0.6, 0.5, 0.3]},
                    {"name": "m", "type": "mirror", "albedo": 0.9}],
          "primitives": [
              {"type": "quad", "bsdf": "d",
               "transform": {"position": [0, -0.5, 0], "scale": [8, 1, 8]}},
              {"type": "quad", "bsdf": "d", "emission": [9.0, 8.0, 7.0],
               "transform": {"position": [0, 2.5, 0], "scale": [2, 1, 2],
                             "rotation": [0, 0, 180]}},
              {"type": "mesh", "file": f"ball.{ext}", "bsdf": "d",
               "smooth": True, "transform": {"position": [-0.6, 0, 0],
                                             "scale": 0.5}},
              {"type": "mesh", "file": f"ball.{ext}", "bsdf": "m",
               "smooth": True, "transform": {"position": [0.6, 0.1, 0.2],
                                             "scale": 0.45}}],
          "camera": {"type": "pinhole", "resolution": [16, 16], "fov": 50,
                     "transform": {"position": [0, 1.5, 4],
                                   "look_at": [0, 0, 0]}},
          "integrator": {"type": "path_tracer", "max_bounces": 2},
          "renderer": {"spp": 1}}
    path = os.path.join(tmp, f"scene_{ext}.json")
    with open(path, "w") as f:
        json.dump(sj, f)
    return path


@pytest.fixture(scope="module")
def mesh_scenes(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("objscene"))
    return {ext: _mesh_scene(tmp, ext) for ext in ("obj", "wo3")}


def test_obj_scene_flattens_as_jax_and_as_wo3(mesh_scenes):
    """load_flat_scene of the OBJ-mesh scene: every field of the port's
    FlatScene (triangle tables, BVH, cluster tables) equals the JAX
    package's, and the port's own scene of the same mesh stored as .wo3
    field for field."""
    from dataclasses import fields

    from test_torch_flatten import _assert_same_scene, jax_fields
    from tungsten_tpu.scene.flatten import load_flat_scene as jax_load
    from tungsten_tpu_torch.scene.flatten import FlatScene, load_flat_scene
    obj, oset = load_flat_scene(mesh_scenes["obj"], "cpu")
    wo3, wset = load_flat_scene(mesh_scenes["wo3"], "cpu")
    assert obj.tri_v0.shape[0] == 2 * 12 * (2 * 6 - 2) + 4
    js, _ = jax_load(mesh_scenes["obj"])
    ref = jax_fields(js)
    _assert_same_scene(obj, ref)
    for k in ("wk_boxes", "wk_cbox", "wk_sbox", "wk_attr", "wk_remap"):
        assert getattr(obj, k).numpy().tobytes() == ref[k].tobytes(), k
    for f in fields(FlatScene):
        a, b = getattr(obj, f.name), getattr(wo3, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b), f.name
            assert all(torch.equal(x, y) for x, y in zip(a, b)), f.name
        else:
            assert a == b, f.name
    assert oset == wset


def test_obj_scene_renders_as_wo3(mesh_scenes):
    """The port's plain path on the CPU, 16x16, 1 spp, 2 bounces: the
    OBJ scene's image is the .wo3 scene's, bitwise."""
    from tungsten_tpu_torch.render import render
    from tungsten_tpu_torch.scene.flatten import load_flat_scene
    imgs = []
    for ext in ("obj", "wo3"):
        scene, settings = load_flat_scene(mesh_scenes[ext], "cpu")
        imgs.append(render(scene, settings, spp=1, seed=7, device="cpu"))
    assert imgs[0].shape == (16, 16, 3) and imgs[0].mean() > 0
    assert np.array_equal(imgs[0], imgs[1])


# ---------------------------------------------------------- the helpers

def test_supported_types_and_sobol_match_jax():
    from tungsten_tpu.bsdf import eval as jeval
    from tungsten_tpu.utils import sobol as jsobol
    from tungsten_tpu_torch.bsdf import eval as teval
    from tungsten_tpu_torch.utils import sobol as tsobol
    assert teval.supported_types() == jeval.supported_types()
    assert tsobol.validate_matrix() is True
    assert tsobol.validate_matrix(4, 64) == jsobol.validate_matrix(4, 64)


def test_sah_cost_matches_jax():
    from tungsten_tpu.scene import bvh as jbvh
    from tungsten_tpu_torch.scene import bvh as tbvh
    rng = np.random.default_rng(2)
    c = rng.uniform(-4, 4, (500, 3)).astype(np.float32)
    e = rng.uniform(0.01, 0.3, (500, 3)).astype(np.float32)
    tb = tbvh.build_bvh(c - e, c + e)
    jb = jbvh.BvhArrays(tb.bounds_min, tb.bounds_max, tb.meta, tb.skip,
                        tb.order)
    got = tbvh.sah_cost(tb)
    assert got == jbvh.sah_cost(jb) and got > 1.0


@pytest.mark.parametrize("ext", ["pfm", "hdr", "exr", "png"])
def test_save_image_matches_jax(tmp_path, ext):
    """HDR files byte-equal; PNG (the port's own encoder, the JAX package
    PIL's) equal pixels."""
    from tungsten_tpu.io import image as jimage
    from tungsten_tpu_torch.io import image as timage
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 1 if ext == "png" else 8, (6, 9, 3)) \
        .astype(np.float32)
    a, b = str(tmp_path / f"t.{ext}"), str(tmp_path / f"j.{ext}")
    timage.save_image(a, img)
    jimage.save_image(b, img)
    if ext == "png":
        with open(a, "rb") as f:
            got = timage.decode_png(f.read())
        with open(b, "rb") as f:
            want = timage.decode_png(f.read())
        assert np.array_equal(got, want)
    else:
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read()


@pytest.mark.parametrize("ext", ["wo3", "obj", "ply"])
def test_save_mesh_matches_jax(tmp_path, ext):
    from tungsten_tpu.io import mesh as jmesh
    rng = np.random.default_rng(6)
    pos = rng.uniform(-1, 1, (9, 3)).astype(np.float32)
    args = dict(pos=pos, normal=rng.normal(size=(9, 3)).astype(np.float32),
                uv=rng.uniform(size=(9, 2)).astype(np.float32),
                indices=rng.integers(0, 9, (7, 3)).astype(np.int32),
                material=np.arange(7, dtype=np.int32))
    a, b = str(tmp_path / f"t.{ext}"), str(tmp_path / f"j.{ext}")
    if ext == "ply":
        for mod, p in ((tmesh, a), (jmesh, b)):
            with pytest.raises(ValueError, match="unsupported mesh format"):
                mod.save_mesh(p, mod.Mesh(**args))
        return
    tmesh.save_mesh(a, tmesh.Mesh(**args))
    jmesh.save_mesh(b, jmesh.Mesh(**args))
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()


def test_vecmath_transforms_match_jax():
    """Within rtol 1e-6 of the summed magnitudes of each output's terms
    (the two einsums may add the three products in another order)."""
    import jax.numpy as jnp

    from tungsten_tpu.utils import vecmath as jvm
    from tungsten_tpu_torch.utils import vecmath as tvm
    rng = np.random.default_rng(8)
    mats = rng.normal(size=(5, 4, 4)).astype(np.float32)
    p = rng.normal(size=(5, 3)).astype(np.float32)
    for m in (mats, mats[0]):
        for name in ("transform_point", "transform_vector"):
            got = getattr(tvm, name)(torch.from_numpy(m), torch.from_numpy(p))
            want = getattr(jvm, name)(jnp.asarray(m), jnp.asarray(p))
            terms = np.einsum("...ij,...j->...i", np.abs(m[..., :3, :3]),
                              np.abs(p))
            if name == "transform_point":
                terms = terms + np.abs(m[..., :3, 3])
            assert got.shape == want.shape
            assert (np.abs(got.numpy() - np.asarray(want))
                    <= 1e-6 * terms).all()
    got = tvm.avg_component(torch.from_numpy(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jvm.avg_component(jnp.asarray(p))), rtol=1e-6)

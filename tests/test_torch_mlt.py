"""The port's MLT family (integrators/mlt.py), its tape (utils/rng.py Tape)
and the path tracer's MMLT restriction and reversible-jump bookkeeping
against the JAX package on the CPU.

The scene is tests/test_mlt.py::_scene (24x24: two lambert walls, an
emissive quad, a cube), carried across with flat_scene_from_numpy.  The
JAX side runs in one module fixture: a tape trace of each kind on 256
lanes at 3 bounces (bdpt_vertices 3), the path tracer restricted to each
path length k in {1, 2, 3}, and one reversible_jump_mlt _mlt_batch of 2
steps on 256 chains, with the integrators' loops (while_loop, fori_loop, scan) on the host,
their bodies op by op, and the traversal (bvh_intersect) one jit a ray
count and mode: the JAX computation as its CPU tests run it, without a
compile of each integrator (about 12 s each) or the traversal's own
loop op by op (about 80 s for these pieces).
Held:

  * tape reads bitwise against _tape_read, with and without light_cols
    and across the wrap; a lane reads the row `at` names;
  * _uniform_tape bitwise; _mutate within one ulp of its step: the port
    takes the exponential in f64 and rounds it (so the CPU and the card
    agree bit for bit), where XLA's f32 exp is an ulp off on about a
    tenth of the arguments;
  * trace_tape: pixels equal, radiance within rtol 1e-4 / atol 1e-6 on
    >= 0.99 of lanes; the same through the staged loop compacting, on
    lanes in chain order and shuffled; trace_tape_bdpt likewise
    with the splat pixels and values; trace_tape_rj: the rj flags equal
    and rj_dims / rj_nee within rtol 1e-5 / atol 1e-6 on >= 0.99 of
    lanes, also through compaction;
  * trace_wave with mlt_path_length k in {1, 2, 3} against JAX's
    (radiance as above, and the lengths' images sum to the unrestricted
    two-strategy image);
  * _mlt_batch of reversible_jump_mlt: 2 steps on 256 chains from the
    same states, half the small steps technique exchanges (the Kelemen
    small step, the large step, the exchange's swapped tape and its zero
    proposal weight where an inversion fails, and the acceptance);
    chains in the same state (tape within 1e-6, luminance within rtol
    1e-4) on >= 0.95, also among the chains whose first step exchanged
    with both inversions valid; the splat framebuffers' sums within 1 %.
    The chains start where the first step's exchanges can hold: each on
    a tape from a pool on which both inversions hold at the bounce its
    first step picks (uniform tapes hold both on about 1 % of lanes);
  * render(): kelemen_mlt on its bidirectional and its path-tracer tape,
    reversible_jump_mlt and multiplexed_mlt, each image finite with its
    mean within 12 % of the port's own path-tracer image (16 spp), as
    tests/test_mlt.py holds the JAX package's.  The scene at 48x48 with
    2,304 chains and a 9,216-sample bootstrap pool, 1 spp (one
    render_pass batch: 4 bootstrap traces and 1 step, where
    tests/test_mlt.py's 16 batches of 1,024 samples at 24x24 take 48
    traces).  The image mean is the bootstrap's mean luminance b, so the
    pool's size is what holds it to the path tracer's (one batch of 1,024
    put kelemen's path-tracer tape 35 % off).
"""
import contextlib
import copy
import os
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from tungsten_tpu.integrators import bdpt as jbdpt
from tungsten_tpu.integrators import mlt as jmlt
from tungsten_tpu.integrators import path_tracer as jpt
from tungsten_tpu.ops import intersect as jisect
from tungsten_tpu.scene.flatten import flatten_scene as jax_flatten
from tungsten_tpu.utils import rng as jrng
from tungsten_tpu_torch.integrators import mlt as tmlt
from tungsten_tpu_torch.integrators import path_tracer as tpt
from tungsten_tpu_torch.render import render
from tungsten_tpu_torch.scene.flatten import (flat_scene_from_numpy,
                                              flatten_scene)
from tungsten_tpu_torch.utils import rng as trng

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_mlt import _scene  # noqa: E402
from test_torch_flatten import jax_fields  # noqa: E402

R = 256
SEED = 7
BOUNCES = 3
BATCH = 3          # the _mlt_batch's batch index (its chains' rows)
RJ_PROB = 0.5      # the share of small steps that are technique exchanges
POOL = 4096        # the uniform tapes the exchange batch's start is taken from
RTOL, ATOL = 1e-4, 1e-6
RJ_RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def lanes_close(a, b, rtol=RTOL, atol=ATOL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype.kind in "biu":
        ok = a.astype(np.int64) == b.astype(np.int64)
    else:
        ok = np.isclose(b, a, rtol=rtol, atol=atol)
    return ok.reshape(ok.shape[0], -1).all(axis=-1)


# the modules whose loops run on the host; any other caller of the lax
# loops (the traversal among them) gets the lax loop
HOST_LOOPED = (jpt.__name__, jbdpt.__name__, jmlt.__name__)


def _on_host() -> bool:
    return sys._getframe(2).f_globals.get("__name__") in HOST_LOOPED


@contextlib.contextmanager
def host_loops_jitted_traversal(js):
    """While open: the integrators' lax loops run on the host and
    bvh_intersect (as the path tracer, BDPT and intersect.occluded call
    it) is one jax.jit a (ray count, mode) over the scene `js`."""
    lax = jax.lax
    loops = (lax.while_loop, lax.fori_loop, lax.scan)
    traversal = jisect.bvh_intersect
    jitted = {}

    def while_loop(cond, body, init):
        if not _on_host():
            return loops[0](cond, body, init)
        s = init
        while bool(cond(s)):
            s = body(s)
        return s

    def fori_loop(lo, hi, body, init):
        if not _on_host():
            return loops[1](lo, hi, body, init)
        s = init
        for i in range(int(lo), int(hi)):
            s = body(i, s)
        return s

    def scan(f, init, xs):      # the MLT steps' scans carry no outputs
        if not _on_host():
            return loops[2](f, init, xs)
        c = init
        for x in xs:
            c, _ = f(c, x)
        return c, None

    def bvh_intersect(scene, o, d, t_min, t_max, any_hit=False,
                      presorted=False):
        R = o.shape[0]
        key = (R, bool(any_hit))
        if key not in jitted:
            jitted[key] = jax.jit(lambda o, d, a, b, ah=bool(any_hit):
                                  traversal(js, o, d, a, b, any_hit=ah))
        return jitted[key](o, d, *(jnp.broadcast_to(
            jnp.asarray(t, jnp.float32), (R,)) for t in (t_min, t_max)))

    mods = (jpt, jbdpt, jisect)
    lax.while_loop, lax.fori_loop, lax.scan = while_loop, fori_loop, scan
    for m in mods:
        m.bvh_intersect = bvh_intersect
    try:
        yield
    finally:
        lax.while_loop, lax.fori_loop, lax.scan = loops
        for m in mods:
            m.bvh_intersect = traversal


def _jax_pieces(js, jset, jtape, jtape_b, b_pick, ids, start):
    """Every JAX piece the tests hold."""
    out = {}
    jset_rj = replace(jset, integrator_type="reversible_jump_mlt")
    prev = jrng._SAMPLER
    jrng.set_sampler(False)
    try:
        with host_loops_jitted_traversal(js):
            seed = jnp.uint32(SEED)
            out["tape"] = jmlt.trace_tape(js, jset, jnp.asarray(jtape), SEED)
            out["rj"] = jmlt.trace_tape_rj(js, jset_rj, jnp.asarray(jtape),
                                           jnp.asarray(b_pick), SEED)
            out["bdpt"] = jmlt.trace_tape_bdpt(js, jset, jnp.asarray(jtape_b),
                                               SEED)
            pix, smp = (jnp.asarray(v) for v in ids)
            pset = replace(jset, integrator_type="path_tracer")
            for k in (-1, 1, 2, 3):
                out[f"len{k}"] = jpt.trace_wave(
                    js, replace(pset, mlt_path_length=k), pix, smp, seed)
            out["batch"] = jmlt._mlt_batch.__wrapped__(
                js, jset_rj, np.uint32(SEED), np.uint32(BATCH), R, 2,
                *(jnp.asarray(v.numpy()) for v in start),
                strategy_prob=RJ_PROB)
    finally:
        jrng._SAMPLER = prev
    return jax.tree_util.tree_map(np.asarray, out)


def _exchange_start(ts, rset, tape):
    """The reversible-jump batch's start: chain r takes a tape from a
    pool of uniform tapes on which both inversions hold at the bounce
    its first step picks (a pick at the last bounce never holds), while
    the pool lasts, else `tape`'s row r.  Returns (start tape, the first
    step's bounce picks); the port picks them as JAX does, bit for bit
    (test_uniform_tape_and_mutation_match_jax holds the helper draws'
    pcg4d)."""
    D = tape.shape[1]
    pool = tmlt._uniform_tape(13, 0, 0, POOL, D, "cpu")
    (_, _, _, u_b), _ = tmlt._helper_draws(
        SEED, tmlt._rows(BATCH, R, "cpu"), 0, D, 4)
    b_first = torch.clamp((u_b * BOUNCES).to(torch.int32), max=BOUNCES - 1)
    start = tape.clone()
    for b in range(BOUNCES - 1):
        _, fwd, _, rev = tmlt.trace_tape_rj(
            ts, rset, pool, torch.full((POOL,), b, dtype=torch.int32), SEED)
        good = torch.nonzero(fwd & rev)[:, 0]
        want = torch.nonzero(b_first == b)[:, 0]
        n = min(good.shape[0], want.shape[0])
        start[want[:n]] = pool[good[:n]]
    return start, b_first


@pytest.fixture(scope="module")
def traced():
    desc = _scene({"type": "kelemen_mlt", "max_bounces": BOUNCES})
    js, jset = jax_flatten(copy.deepcopy(desc))
    ts = flat_scene_from_numpy(jax_fields(js), "cpu")
    _, tset = flatten_scene(copy.deepcopy(desc), device="cpu")
    jset = replace(jset, bdpt_vertices=3)
    tset = replace(tset, bdpt_vertices=3, stratified_sampler=False)
    rset = replace(tset, integrator_type="reversible_jump_mlt")
    jtape = np.asarray(jmlt._uniform_tape(jnp.uint32(11), 0, 0, R,
                                          jmlt.tape_dims(jset)))
    jtape_b = np.asarray(jmlt._uniform_tape(
        jnp.uint32(12), 0, 0, R, jmlt.tape_dims_bdpt(jset)[1]))
    b_pick = np.random.default_rng(3).integers(0, BOUNCES, R).astype(np.int32)
    n = tset.width * tset.height
    ids = ((np.arange(R, dtype=np.uint32) * 5) % n,
           np.arange(R, dtype=np.uint32) // n)
    start, b_first = _exchange_start(ts, rset, _t(jtape))
    start = (start,) + tmlt.trace_tape(ts, rset, start, SEED)
    return dict(js=js, jset=jset, ts=ts, tset=tset, rset=rset, tape=jtape,
                tape_b=jtape_b, b_pick=b_pick, ids=ids, start=start,
                b_first=b_first,
                jax=_jax_pieces(js, jset, jtape, jtape_b, b_pick, ids,
                                start))


# ------------------------------------------------------------ the tape

@pytest.mark.parametrize("light_cols", [None, 40])
def test_tape_reads_match_jax(light_cols):
    D = 64
    table = np.random.default_rng(0).random((R, D), dtype=np.float32)
    dims = [0, 1, 5, 39, 40, D - 1, D, D + 7, 3 * D + 2, 4096, 4097,
            4096 + D - 40, 4096 + 2 * D + 1]
    perm = np.random.default_rng(1).permutation(R)
    with jrng.tape_mode(jnp.asarray(table), light_cols=light_cols):
        for dim in dims:
            want = np.asarray(jrng.random_1d(jnp.uint32(SEED), 0, 0, dim))
            tape = trng.Tape(_t(table), light_cols=light_cols)
            for got in (tape.read(dim),
                        trng.random_1d(SEED, 0, 0, dim, tape)):
                assert (got.numpy() == want).all(), dim
            a, b = trng.random_2d(SEED, 0, 0, dim, tape)
            assert (b.numpy() == np.asarray(
                jrng.random_1d(jnp.uint32(SEED), 0, 0, dim + 1))).all()
            # a lane reads the row its `rows` entry names
            shuffled = tape.at(torch.from_numpy(perm))
            assert (shuffled.read(dim).numpy() == want[perm]).all()
    # untracked draws never read the tape
    with jrng.tape_mode(jnp.asarray(table)):
        want = np.stack([np.asarray(x) for x in jrng.untracked_4d(
            jnp.uint32(SEED), jnp.arange(R, dtype=jnp.uint32), 0, 9)])
    got = torch.stack(trng.untracked_4d(SEED, torch.arange(R), 0, 9))
    assert (got.numpy() == want).all()


def test_uniform_tape_and_mutation_match_jax():
    D = 97
    for seed, batch, step in ((11, 0, 0), (0xB007 ^ SEED, 5, 3)):
        want = np.asarray(jmlt._uniform_tape(jnp.uint32(seed), batch, step,
                                             R, D))
        got = tmlt._uniform_tape(seed, batch, step, R, D, "cpu").numpy()
        assert (got == want).all()
    rs = np.random.default_rng(4)
    tape = rs.random((R, D), dtype=np.float32)
    u = rs.random((R, D), dtype=np.float32)
    u[0, :4] = [0.0, 0.5, 0.4999999, 0.9999999]
    want = np.asarray(jmlt._mutate(jnp.asarray(tape), jnp.asarray(u)))
    got = tmlt._mutate(_t(tape), _t(u)).numpy()
    assert ((got >= 0.0) & (got < 1.0)).all()
    # one ulp of the step (at most 2^-6 * 16) moves the sum by at most
    # one ulp of a value below 1
    assert np.abs(got - want).max() <= 2.0 ** -24 * 1.01
    assert (got == want).mean() >= 0.99
    assert tmlt.S1 == jmlt.S1 and tmlt.S2 == jmlt.S2
    assert np.float32(tmlt.FACTOR) == np.float32(jmlt.FACTOR)


# --------------------------------------------------------- tape traces

def test_trace_tape_matches_jax(traced):
    j = traced["jax"]["tape"]
    ts, tset = traced["ts"], traced["tset"]
    rad, pixel, lum = tmlt.trace_tape(ts, tset, _t(traced["tape"]), SEED)
    assert (pixel.numpy() == j[1].astype(np.int64)).all()
    assert lanes_close(j[0], rad).mean() >= 0.99
    assert lanes_close(j[2], lum).mean() >= 0.99
    assert (lum.numpy() > 0).mean() > 0.3


def test_tape_rows_follow_lanes_through_compaction(traced):
    """The path tracer on a tape through the staged loop compacting to
    16 lanes, with the chains in order and shuffled: each lane's radiance
    is its own chain's (the row of its entry, which it carries as
    `lane`), as JAX's lane-ordered trace gives it."""
    j = traced["jax"]["tape"][0]
    ts, tset = traced["ts"], traced["tset"]
    pixel, t2 = tmlt._image_point(tset, _t(traced["tape"]))
    pset = tmlt._pt_settings(tset)
    zero = torch.zeros((R,), dtype=torch.int32)
    rad = tpt.trace_wave(ts, pset, pixel, zero, SEED,
                         tape=trng.Tape(t2), min_wave=16, step=2)
    assert lanes_close(j, rad).mean() >= 0.99
    perm = torch.from_numpy(np.random.default_rng(2).permutation(R))
    rad_p = tpt.trace_wave(ts, pset, pixel[perm], zero, SEED,
                           tape=trng.Tape(t2[perm]), min_wave=16, step=2)
    assert lanes_close(j[perm.numpy()], rad_p).mean() >= 0.99


def test_trace_tape_bdpt_matches_jax(traced):
    j = traced["jax"]["bdpt"]
    got = tmlt.trace_tape_bdpt(traced["ts"], traced["tset"],
                               _t(traced["tape_b"]), SEED)
    for k, (a, b) in enumerate(zip(j, got)):
        assert lanes_close(a, b).mean() >= 0.99, k
    assert got[2].shape[1] > 0 and (got[3].numpy() > 0).any()
    assert (got[4].numpy() > 0).mean() > 0.3


@pytest.mark.parametrize("compact", [False, True])
def test_trace_tape_rj_matches_jax(traced, compact):
    """rj_dims / rj_valid / rj_nee / rj_rev_valid per lane; with
    `compact` through trace_wave_rj's staged loop down to 16 lanes (the
    rj results bank by lane like the radiance).  The JAX package's
    C-ref 2 and 3 are reproduced: a pick at the last bounce never
    validates, a medium vertex never shades."""
    j = traced["jax"]["rj"]
    ts, tset = traced["ts"], traced["tset"]
    rset = replace(tset, integrator_type="reversible_jump_mlt")
    b_pick = _t(traced["b_pick"])
    if compact:
        pixel, t2 = tmlt._image_point(rset, _t(traced["tape"]))
        got = tpt.trace_wave_rj(ts, tmlt._pt_settings(rset), pixel,
                                torch.zeros((R,), dtype=torch.int32), SEED,
                                b_pick, tape=trng.Tape(t2), min_wave=16,
                                step=2)[1:]
    else:
        got = tmlt.trace_tape_rj(ts, rset, _t(traced["tape"]), b_pick, SEED)
    for k, (a, b) in enumerate(zip(j, got)):
        assert lanes_close(a, b, rtol=RJ_RTOL).mean() >= 0.99, k
    valid, rev = got[1].numpy(), got[3].numpy()
    assert valid.mean() > 0.1 and rev.any()
    assert not valid[traced["b_pick"] == BOUNCES - 1].any()


def test_path_length_restriction_matches_jax(traced):
    """The path tracer restricted to one path length (MMLT's chains):
    each k's radiance per lane against JAX's; the lengths together give
    the unrestricted two-strategy estimate of paths up to 3 edges."""
    ts = traced["ts"]
    pset = replace(traced["tset"], integrator_type="path_tracer")
    pix, smp = (torch.from_numpy(v.astype(np.int32)) for v in traced["ids"])
    total = 0.0
    for k in (1, 2, 3):
        s_k = replace(pset, mlt_path_length=k)
        assert not tpt._one_sample_mis(s_k)
        rad = tpt.trace_wave(ts, s_k, pix, smp, SEED)
        assert lanes_close(traced["jax"][f"len{k}"], rad).mean() >= 0.99, k
        assert (rad.numpy() > 0).any()
        total = total + rad.numpy()
    full = traced["jax"]["len-1"]
    assert tpt._one_sample_mis(pset)
    np.testing.assert_allclose(total.mean(), full.mean(), rtol=0.05)


def test_mlt_batch_matches_jax(traced):
    """Two reversible-jump Metropolis steps of 256 chains from the same
    states: kelemen small steps, large steps and technique exchanges."""
    j_fb, j_tape, j_rad, j_pix, j_lum = traced["jax"]["batch"]
    start, rad, pixel, lum = traced["start"]
    ts, rset = traced["ts"], traced["rset"]
    st = {}
    fb, tape, _, _, t_lum = tmlt._mlt_batch(
        ts, rset, SEED, BATCH, R, 2, start, rad, pixel, lum,
        strategy_prob=RJ_PROB, stats=st)
    same = (np.abs(tape.numpy() - j_tape).max(-1) <= 1e-6) & \
        np.isclose(t_lum.numpy(), j_lum, rtol=1e-4, atol=ATOL)
    assert same.mean() >= 0.95, same.mean()
    assert abs(fb.numpy().sum() / j_fb.sum() - 1.0) < 0.01
    # the chains moved
    assert (np.abs(j_tape - start.numpy()).max(-1) > 0).mean() > 0.5
    # exchanges proposed, with both inversions valid and with the zero
    # proposal weight of a failed one
    proposed, valid = int(st["rj_proposed"]), int(st["rj_valid"])
    assert valid >= 20 and proposed - valid >= 20, (proposed, valid)
    # the chains whose first step exchanged with both inversions valid
    (u_large, _, u_strat, _), _ = tmlt._helper_draws(
        SEED, tmlt._rows(BATCH, R, "cpu"), 0, start.shape[1], 4)
    _, fwd, _, rev = tmlt.trace_tape_rj(ts, rset, start, traced["b_first"],
                                        SEED)
    swapped = ((u_large >= rset.mlt_large_step_prob) & (u_strat < RJ_PROB) &
               fwd & rev).numpy()
    assert swapped.sum() >= 20, swapped.sum()
    assert same[swapped].mean() >= 0.95, same[swapped].mean()


# ---------------------------------------------------------------- render

RENDER_RES = 48
RENDER_CHAINS = RENDER_RES * RENDER_RES


def _render_scene(block):
    desc = _scene(block)
    desc.camera["resolution"] = [RENDER_RES, RENDER_RES]
    return flatten_scene(desc, device="cpu")


@pytest.fixture(scope="module")
def pt_image():
    flat, s = _render_scene({"type": "path_tracer", "max_bounces": 4})
    return render(flat, s, spp=16, spp_chunk=16, device="cpu")


@pytest.mark.parametrize("integ", ["kelemen_mlt", "kelemen_mlt_pt",
                                   "reversible_jump_mlt", "multiplexed_mlt"])
def test_mlt_render_converges_to_pt(pt_image, integ):
    block = {"type": integ.replace("_pt", ""), "max_bounces": 4,
             "initial_sample_pool": 4 * RENDER_CHAINS}
    if integ.endswith("_pt"):
        block["bidirectional"] = False
    flat, s = _render_scene(block)
    assert s.mlt_bidirectional == (not integ.endswith("_pt"))
    assert s.mlt_sample_pool == 4 * RENDER_CHAINS
    s = replace(s, mlt_chains=RENDER_CHAINS)
    img = render(flat, s, spp=1, device="cpu")
    assert np.isfinite(img).all()
    assert abs(img.mean() - pt_image.mean()) / pt_image.mean() < 0.12

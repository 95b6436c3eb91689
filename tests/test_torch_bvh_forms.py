"""The traversal kernels' probe forms (`ops.bvh_traverse.bvh_traverse_form`,
the counterparts of the TPU kernel's switches `_NOSWEEP` and `_NOATTR`,
`raysnail_tpu/ops/bvh_pallas.py:78-79`) on the CPU, through their plain
versions, and the probes' sweep as a source test:

  * against the JAX kernel `bvh_traverse(..., interpret=True)` run with
    `bvh_pallas._NOSWEEP` or `_NOATTR` set (monkeypatch; JAX's caches are
    cleared around the call so that the switch is traced, and nothing in
    the JAX package is edited): with no sweep every ray misses in both;
    with no attributes t is held as test_torch_bvh.py holds the full
    traversal's (hit/miss on all but MISS_SHARE of the rays, t within rtol
    1e-5 where both keep a hit);
  * the no-sweep counters against a numpy walk with cap admission, per ray
    and per warp, and that walk against test_torch_probes.np_walk;
  * the no-attributes sweeps and t against the deferred-walk Model of
    test_torch_bvh_deferred.py at depths 1, 8 and 32, bit for bit.

Tolerances other than the JAX kernel's: none (integers and t equal).
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

import test_torch_bvh as base
import test_torch_bvh_deferred as deferred
import test_torch_probes as probe_tests
from raysnail_tpu.ops import bvh_pallas
from raysnail_tpu_torch import probes
from raysnail_tpu_torch.ops import bvh_traverse as bt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "raysnail_tpu_torch", "csrc")
TMIN, TMAX, BIG = base.TMIN, base.TMAX, base.BIG
F32 = np.float32
SCENES = {"tri": ("knot-1440", "triangles", "pk_tri"), "box": ("boxes-144", "boxes", "pk_box"),
          "sphere": ("spheres-700", "spheres", "pk_sph")}
SHAPES = {"per-ray": False, "packet": True}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_switch(monkeypatch):
    """Set one of the TPU kernel's probe switches for this test only."""
    def set_switch(name):
        jax.clear_caches()
        monkeypatch.setattr(bvh_pallas, name, True)

    yield set_switch
    monkeypatch.undo()
    jax.clear_caches()


def _cols(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3))


# -- against the TPU kernel with its switch set --------------------------------------

@pytest.mark.parametrize("kind", list(SCENES))
@pytest.mark.parametrize("form", list(bt.FORMS))
def test_plain_forms_match_the_jax_kernel_switches(kind, form, jax_switch):
    scene, group, prim = SCENES[kind]
    _, tscene = base._compile_both(scene)
    g = getattr(tscene.arrays, group)
    pk = (g.pk_bb, g.pk_links, getattr(g, prim))
    n = 1000  # ragged: neither a multiple of 128 nor of the JAX tile
    o, d, cap = base._rays(kind, n, seed=len(scene))
    jax_switch("_NOSWEEP" if form == "nosweep" else "_NOATTR")
    jt, ja0, *_, jmat = base._jax_traverse(o, d, cap, [jax.numpy.asarray(a.numpy()) for a in pk],
                                           kind)
    ports = {shape: bt.bvh_traverse_form(form, _cols(o), _cols(d), torch.from_numpy(cap), *pk,
                                         TMIN, TMAX, kind=kind, packet=packet)
             for shape, packet in SHAPES.items()}
    dead = cap <= 0
    assert (jt[dead] == BIG).all() and (jmat == 0).all()
    for shape, out in ports.items():
        tt = out.t.numpy()
        assert (tt[dead] == BIG).all() and (out.sweeps.numpy()[dead] == 0).all(), shape
        if form == "nosweep":
            # the walk ran: rays admitted leaves their drain skipped
            assert (jt == BIG).all() and (tt == BIG).all()
            assert int((out.sweeps > 0).sum()) > n // 10 and int(out.steps.max()) > 0
            continue
        seen = lambda t: (t < BIG) & (t <= cap)  # a hit the caller keeps
        jh, th = seen(jt), seen(tt)
        assert (jh != th).mean() <= base.MISS_SHARE, (shape, (jh != th).sum())
        both = jh & th
        assert both.sum() > n // 10
        np.testing.assert_allclose(tt[both], jt[both], rtol=1e-5)
        # the TPU kernel's column 1 counts its packet's sweeps; a ray that
        # hits swept at least one leaf in both
        hit = tt < BIG
        assert (out.sweeps.numpy()[hit] >= 1).all() and (ja0[jt < BIG] >= 1).all()


# -- the no-sweep counters against numpy walks ------------------------------------

def np_capped_walk(o, d, t_cap, pk_bb, pk_links, octant, width):
    """The no-sweep form in numpy, written from csrc/bvh_traverse.cu and
    csrc/bvh_packet.cu: groups of `width` consecutive rays walk octant[0]'s
    order of each group; a group walks when any ray's root cap admits
    (cap >= t_min) and enters a node when any ray admits it (slab, far >=
    t_min, near <= min(BIG, cap)). -> per ray: sweeps (deferred leaves the
    ray admits), steps and leaves (its group's) and the cap."""
    n, m = o.shape[0], pk_bb.shape[1]
    eps = F32(1e-12)
    with np.errstate(all="ignore"):
        inv = F32(1.0) / np.where(np.abs(d) < eps, np.where(d < 0, -eps, eps), d)

    def slabs(bb, rows):  # (k, 8) bounds against rays `rows` -> near, far (k, r)
        lo = (bb[:, None, 0:3] - o[None, rows]) * inv[None, rows]
        hi = (bb[:, None, 3:6] - o[None, rows]) * inv[None, rows]
        return np.minimum(lo, hi).max(axis=2), np.maximum(lo, hi).min(axis=2)

    root = pk_bb[octant, 0]  # each ray's root bounds (n, 8)
    lo, hi = (root[:, 0:3] - o) * inv, (root[:, 3:6] - o) * inv
    near0, far0 = np.minimum(lo, hi).max(axis=1), np.maximum(lo, hi).min(axis=1)
    cap_in = np.minimum(t_cap, F32(TMAX))
    can_hit = (t_cap > 0) & (near0 <= far0) & (far0 >= F32(TMIN)) & (near0 <= cap_in)
    cap = np.where(can_hit, np.minimum(far0, cap_in) * F32(1.0001) + F32(1e-4),
                   F32(-BIG)).astype(F32)
    limit = np.minimum(cap, F32(BIG))
    out = {k: np.zeros(n, np.int64) for k in ("sweeps", "steps", "leaves")}
    for g0 in range(0, n, width):
        rows = np.arange(g0, min(g0 + width, n))
        bb, links = pk_bb[octant[g0]], pk_links[octant[g0]]
        node = 0 if (cap[rows] >= F32(TMIN)).any() else m
        steps = leaves = 0
        while node < m:
            near, far = slabs(bb[node:node + 1], rows)
            admit = (near[0] <= far[0]) & (far[0] >= F32(TMIN)) & (near[0] <= limit[rows])
            leaf = links[node, 1] > 0
            if admit.any() and leaf:
                leaves += 1
                out["sweeps"][rows] += admit
            node = node + 1 if (admit.any() and not leaf) else int(links[node, 2])
            steps += 1
        out["steps"][rows], out["leaves"][rows] = steps, leaves
    out["cap"] = cap
    return out


@pytest.fixture(scope="module")
def probe_case():
    return probes.build_case("knot-9600", "cpu", probe_tests.WIDTH, probe_tests.HEIGHT,
                             probe_tests.KNOT)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_nosweep_counters_equal_the_numpy_walks(probe_case, shape):
    """The probes' case, uncapped: the plain no-sweep form against the numpy
    walk here, and that walk against test_torch_probes.np_walk's "cap" walk
    (near <= BIG), on one node order for the packet shape (np_walk sums a
    32-ray group's directions for its order, the kernel its 128-ray
    packet's)."""
    tri = probe_case.tri
    o, d, pk_bb, pk_links, _ = probe_tests._np(probe_case)
    packet = SHAPES[shape]
    if packet:
        pk_bb, pk_links = pk_bb[:1], pk_links[:1]
    n = o.shape[0]
    cap_t = np.full(n, F32(BIG))
    octant = (bt.node_orders(probe_case.d, pk_bb.shape[0], packet).numpy())
    width = bt.WARP if packet else 1
    mine = np_capped_walk(o, d, cap_t, pk_bb, pk_links, octant, width)
    got = bt.bvh_traverse_form_plain(
        "nosweep", probe_case.o, probe_case.d, torch.from_numpy(cap_t),
        torch.from_numpy(pk_bb).contiguous(), torch.from_numpy(pk_links).contiguous(),
        tri.pk_tri, TMIN, TMAX, packet=packet)
    assert (got.t == BIG).all()
    np.testing.assert_array_equal(got.sweeps.numpy(), mine["sweeps"])
    np.testing.assert_array_equal(got.steps.numpy(), mine["steps"])
    warp_max = np.repeat(np.maximum.reduceat(mine["sweeps"], np.arange(0, n, 32)), 32)[:n]
    np.testing.assert_array_equal(got.rounds.numpy(), mine["leaves"] if packet else warp_max)
    # np_walk tests the root of a group that cannot hit; the kernels do not walk it
    ref = probe_tests.np_walk(o, d, pk_bb, pk_links, width, "cap")
    walks = np.repeat(np.logical_or.reduceat(mine["cap"] >= F32(TMIN),
                                             np.arange(0, n, width)), width)[:n]
    np.testing.assert_array_equal(mine["steps"], np.where(walks, ref["steps"], 0))
    np.testing.assert_array_equal(mine["leaves"], ref["leaves"])
    assert mine["leaves"].max() > 2 and walks.mean() > 0.3


@pytest.mark.parametrize("kind", list(SCENES))
@pytest.mark.parametrize("shape", list(SHAPES))
def test_nosweep_counters_with_caps_and_dead_lanes(kind, shape):
    """Finite caps on a third of the rays and dead lanes on a tenth, a
    ragged count, eight node orders."""
    scene, group, prim = SCENES[kind]
    _, tscene = base._compile_both(scene)
    g = getattr(tscene.arrays, group)
    o, d, cap_t = base._rays(kind, 300, seed=3)
    packet = SHAPES[shape]
    octant = bt.node_orders(_cols(d), g.pk_bb.shape[0], packet).numpy()
    mine = np_capped_walk(o, d, cap_t, g.pk_bb.numpy(), g.pk_links.numpy(), octant,
                          bt.WARP if packet else 1)
    got = bt.bvh_traverse_form_plain("nosweep", _cols(o), _cols(d), torch.from_numpy(cap_t),
                                     g.pk_bb, g.pk_links, getattr(g, prim), TMIN, TMAX,
                                     kind=kind, packet=packet)
    np.testing.assert_array_equal(got.sweeps.numpy(), mine["sweeps"])
    np.testing.assert_array_equal(got.steps.numpy(), mine["steps"])
    if packet:
        np.testing.assert_array_equal(got.rounds.numpy(), mine["leaves"])
    assert (got.sweeps.numpy()[cap_t <= 0] == 0).all() and mine["sweeps"].sum() > 50


# -- the no-attributes sweeps against the deferred-walk model -------------------------

class CountingModel(deferred.Model):
    """The Model, counting each ray's sweeps."""

    def __init__(self, tab, depth):
        super().__init__(tab, depth)
        self.ray_sweeps = np.zeros(tab.n, np.int64)

    def drain_one(self, r, node):
        before = self.sweeps
        super().drain_one(r, node)
        self.ray_sweeps[r] += self.sweeps - before


@pytest.mark.parametrize("depth", [1, 8, 32])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", list(SCENES))
def test_noattr_sweeps_equal_the_deferred_walk(kind, shape, depth):
    g, blocks, rays, tab = deferred._case(kind, shape)
    model = CountingModel(tab, depth)
    model = model.packet(False) if SHAPES[shape] else model.per_ray()
    got = bt.bvh_traverse_form_plain("noattr", *rays, g.pk_bb, g.pk_links, blocks, TMIN, TMAX,
                                     kind=kind, packet=SHAPES[shape])
    np.testing.assert_array_equal(got.t.numpy(), model.best_t)
    np.testing.assert_array_equal(got.sweeps.numpy(), model.ray_sweeps)
    assert model.ray_sweeps.sum() > 20
    if not SHAPES[shape]:  # a ray defers what it might sweep, and sweeps no more
        assert model.deferred >= model.sweeps


# -- the wrappers and the sources -----------------------------------------------------

def test_form_wrapper_refuses_what_the_kernels_do_not_take(probe_case):
    tri = probe_case.tri
    cap = torch.full_like(probe_case.o[0], BIG)
    args = (probe_case.o, probe_case.d, cap, tri.pk_bb, tri.pk_links, tri.pk_tri, TMIN, TMAX)
    with pytest.raises(ValueError, match="form must be one of"):
        bt.bvh_traverse_form("nothing", *args)
    with pytest.raises(ValueError, match="no probe form"):
        bt.bvh_traverse_form("noattr", *args, kind="tri_mxu")
    with pytest.raises(ValueError, match="contiguous"):
        bt.bvh_traverse_form("noattr", probe_case.o, probe_case.d, cap.double(), *args[3:])
    meta = lambda v: tuple(a.to("meta") for a in v)
    with pytest.raises(ValueError, match="unsupported device"):
        bt.bvh_traverse_form("nosweep", meta(probe_case.o), meta(probe_case.d), cap.to("meta"),
                             *(a.to("meta") for a in args[3:6]), TMIN, TMAX)
    out = bt.bvh_traverse_form("noattr", *args)
    assert out.steps is None and out.rounds is None and out.sweeps.dtype == torch.int32
    assert not any(bt.bvh_traverse_form.launches.values())  # CPU tensors launch nothing
    assert set(bt.bvh_traverse_form.launches) == {
        f"{f}/{p}{k}" for f in bt.FORMS for k in ("tri", "box", "sphere")
        for p in ("", "packet/")}


def _source(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def test_the_probes_sweep_through_the_shipped_sweep():
    """bvh_probes.cu has no sweep of its own: it includes bvh_sweep.cuh and
    calls its sweep_round; the staging helpers live in one header that the
    packet kernel and the probes share."""
    probes_cu, packet_cu = _source("bvh_probes.cu"), _source("bvh_packet.cu")
    assert '#include "bvh_sweep.cuh"' in probes_cu and '#include "bvh_stage.cuh"' in probes_cu
    assert not re.search(r"\b(tri_t|sweep_block)\b", probes_cu)
    assert "bvh::sweep_round<bvh::kTri" in probes_cu
    for fn in ("smem_addr", "bulk_copy", "stage", "mbar_wait", "mbar_init"):
        assert re.search(rf"__forceinline__ \w+ {fn}\(", _source("bvh_stage.cuh")), fn
        assert not re.search(rf"__forceinline__ \w+ {fn}\(", packet_cu + probes_cu), fn
    # the shipped entry points launch the full form only
    for name, entry in (("bvh_traverse.cu", "bvh_traverse_launch"),
                        ("bvh_packet.cu", "bvh_packet_launch")):
        body = _source(name).split(f'extern "C" int {entry}(')[1].split("\n}\n")[0]
        assert "kFullForm" in body and "kNoSweep" not in body and "kNoAttr" not in body, name

"""What the two CUDA traversal kernels' design rests on, held on the CPU.

The kernels (`csrc/bvh_traverse.cu`, `csrc/bvh_packet.cu`) run only on a
card. Both take the walk and the sweeps apart: a ray (or a warp of a packet)
walks on with a STALE best t and defers the leaves it admits, up to D; at
the drain each ray tests a deferred leaf's bounds again against its FRESH
best t and sweeps it only if it still admits it; the sweep runs
primitive-parallel, 32 lanes with 4 primitives each and a butterfly
min-reduction over (t, primitive index) in which the lower index wins a tie.
The claim is that none of this shows in a result: every D and both shapes
of the walk give `bvh_traverse_plain`'s outputs bit for bit.

This file holds that claim with a small model of the kernels' control flow
(plain Python over tables of the slab tests and primitive tests, which are
computed with the plain version's own torch formulas, so that every float
is the plain version's float). Tolerance: none; t, the four attributes and
mat are compared with array_equal. The cases have capped and dead lanes, a
ray count that is not a multiple of 32, and primitives duplicated inside a
leaf block, so that t ties exactly and the index decides.
"""

import numpy as np
import pytest
import torch

from raysnail_tpu_torch import ir
from raysnail_tpu_torch.ops import bvh_traverse as bt
from raysnail_tpu_torch.scene import SceneBuilder
from raysnail_tpu_torch.scenes.meshes import torus_knot

TMIN, TMAX = 1e-3, 1e30
BIG = np.float32(1e30)
NO_LANE = 1 << 30
COPIES = (32, 96)  # where a block's primitives 0-31 sit again
N_RAYS = 75  # two whole warps and a partial one; one partial packet


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _group(kind):
    """A packed group of the kind, compiled by the port on the CPU, with
    two primitives of its first blocks duplicated inside their block."""
    rng = np.random.default_rng(5)
    b = SceneBuilder()
    mat = ir.Lambertian(ir.Constant((0.5, 0.5, 0.5)))
    if kind in ("tri", "tri_mxu"):
        v, f, nrm = torus_knot(n_seg=60, n_ring=12)
        b.add(ir.Mesh(vertices=v, indices=f, normals=nrm, material=mat))
        name, prim = "triangles", "pk_tri"
    elif kind == "box":
        for i in range(12):
            for j in range(12):
                b.add(ir.Box((-6.0 + i, 0.0, -6.0 + j),
                             (-5.0 + i, 0.1 + 2.0 * rng.random(), -5.0 + j), mat))
        name, prim = "boxes", "pk_box"
    else:
        for i in range(700):
            b.add(ir.Sphere(tuple(rng.uniform(-4, 4, 3)), 0.15 + 0.05 * (i % 4), mat))
        name, prim = "spheres", "pk_sph"
    solver = "mxu" if kind == "tri_mxu" else "cramer"
    g = getattr(b.compile(device="cpu", mesh_solver=solver).arrays, name)
    blocks = getattr(g, prim).clone()
    # the ties: primitives 0-31 again at 32-63 and at 96-127, which other
    # lanes test; a leaf's bounds hold its copies
    for dst in COPIES:
        if kind == "tri_mxu":  # four solve columns and the attribute column
            for base in (0, 128, 256, 384, 512):
                blocks[:, :, base + dst: base + dst + 32] = blocks[:, :, base: base + 32]
        else:
            blocks[:, :, dst: dst + 32] = blocks[:, :, 0:32]
    return g, blocks


def _rays(kind, seed):
    rng = np.random.default_rng(seed)
    n = N_RAYS
    span = {"tri": 3.0, "tri_mxu": 3.0, "box": 8.0, "sphere": 6.0}[kind]
    o = rng.uniform(-span, span, (n, 3))
    d = rng.standard_normal((n, 3))
    if kind == "box":
        o[:, 1] = rng.uniform(0.5, 6.0, n)
        o[: n // 6] = rng.uniform(-5.9, -5.1, (n // 6, 3))  # inside box (0, 0)
        o[: n // 6, 1] = rng.uniform(0.01, 0.09, n // 6)
    if kind in ("tri", "tri_mxu"):  # half of them aimed at the knot
        o[: n // 2] = rng.uniform(-0.5, 0.5, (n // 2, 3)) + (0.0, 1.5, 4.0)
        d[: n // 2] = rng.uniform(-0.4, 0.4, (n // 2, 3)) - o[: n // 2] * 0.25
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cap = np.full(n, 1e30)
    order = rng.permutation(n)
    cap[order[: n // 3]] = rng.uniform(0.5, span, n // 3)  # a finite t_cap
    cap[order[n // 3: n // 3 + n // 10]] = -1.0            # dead lanes
    cols = lambda a: tuple(torch.from_numpy(np.ascontiguousarray(a[:, i], np.float32))
                           for i in range(3))
    return cols(o), cols(d), torch.from_numpy(cap.astype(np.float32))


class Tables:
    """Every float the model compares, from the plain version's formulas:
    near and far of every (ray, node) in the ray's node order and of every
    (ray, cut entry), the admission cap, and t (BIG where the primitive is
    no hit) with the two winner values of every (ray, block, primitive)."""

    def __init__(self, kind, rays, g, blocks, packet):
        o, d, cap_t = rays
        n, m = o[0].shape[0], g.pk_bb.shape[1]
        if g.pk_bb.shape[0] != 8:
            self.octant = torch.zeros(n, dtype=torch.long)
        elif packet:
            self.octant = bt.packet_octant(*d)
        else:
            self.octant = (d[0] < 0).long() * 4 + (d[1] < 0).long() * 2 + (d[2] < 0).long()
        inv = [bt.safe_inv(c) for c in d]

        def slabs(boxes):  # (n, k, 8) -> near, far (n, k)
            k = boxes.shape[1]
            rep = lambda v: [c.repeat_interleave(k) for c in v]
            near, far = bt.slab(boxes.reshape(n * k, 8), rep(o), rep(inv))
            return near.reshape(n, k).numpy(), far.reshape(n, k).numpy()

        self.near, self.far = slabs(g.pk_bb[self.octant])
        self.cnear, self.cfar = slabs(g.pk_cbb[self.octant])
        self.links = g.pk_links[self.octant].numpy()          # (n, m, 4)
        self.crange = g.pk_crange[self.octant].numpy()        # (n, 64, 4)
        self.n_cut = bt.cut_counts(g.pk_crange, m)[self.octant].numpy()
        near0, far0 = torch.from_numpy(self.near[:, 0]), torch.from_numpy(self.far[:, 0])
        cap_in = torch.minimum(cap_t, torch.full_like(cap_t, TMAX))
        can_hit = (cap_t > 0.0) & (near0 <= far0) & (far0 >= TMIN) & (near0 <= cap_in)
        self.cap = torch.where(can_hit, torch.minimum(far0, cap_in) * 1.0001 + 1e-4,
                               torch.full_like(far0, -1e30)).numpy()
        col = lambda v: [c[:, None] for c in v]
        inf = torch.full((n, 1), float("inf"))
        per_block = [bt._sweep(kind, blocks[b][None].expand(n, -1, -1), col(o), col(d),
                               col(inv), inf, TMIN, TMAX) for b in range(blocks.shape[0])]
        self.t, self.a, self.b = (np.stack([x[i].numpy() for x in per_block], 1)
                                  for i in range(3))          # (n, B, 128)
        self.n, self.m = n, m

    def admits(self, r, node, limit, cut=False):
        near, far = (self.cnear, self.cfar) if cut else (self.near, self.far)
        return bool(near[r, node] <= far[r, node] and far[r, node] >= np.float32(TMIN)
                    and near[r, node] <= limit)


def sweep_coop(t_row, bt_now):
    """The primitive-parallel sweep of one (ray, leaf): lane l keeps the
    first least t below `bt_now` among its primitives 4l..4l+3, in index order;
    five butterfly steps then order by (t, index). -> (t, index) as every
    lane holds it."""
    local = []
    for lane in range(32):
        ct, ci = bt_now, NO_LANE
        for i in range(4 * lane, 4 * lane + 4):
            if t_row[i] < ct:
                ct, ci = t_row[i], i
        local.append((ct, ci))
    for off in (16, 8, 4, 2, 1):
        nxt = []
        for lane in range(32):
            (ct, ci), (ot, oi) = local[lane], local[lane ^ off]
            nxt.append((ot, oi) if ot < ct or (ot == ct and oi < ci) else (ct, ci))
        local = nxt
    assert all(x == local[0] for x in local)
    return local[0]


class Model:
    """The kernels' control flow over `Tables`."""

    def __init__(self, tab, depth):
        self.tab, self.depth = tab, depth
        self.best_t = np.full(tab.n, BIG, np.float32)
        self.best_blk = np.zeros(tab.n, np.int64)
        self.best_lane = np.zeros(tab.n, np.int64)
        self.sweeps = 0
        self.deferred = 0

    def limit(self, r):
        return min(self.best_t[r], self.tab.cap[r])

    def drain_one(self, r, node):
        """Ray r at a deferred leaf: the fresh re-test, then the sweep."""
        tab = self.tab
        if not tab.admits(r, node, self.limit(r)):
            return
        blk = int(tab.links[r, node, 0])
        t, lane = sweep_coop(tab.t[r, blk], self.best_t[r])
        self.sweeps += 1
        if t < self.best_t[r]:
            self.best_t[r], self.best_blk[r], self.best_lane[r] = t, blk, lane

    def per_ray(self):
        """csrc/bvh_traverse.cu: each ray walks its own order and defers."""
        tab = self.tab
        for r in range(tab.n):
            node = 0 if tab.cap[r] >= np.float32(TMIN) else tab.m
            while True:
                buf = []
                while node < tab.m and len(buf) < self.depth:
                    admit = tab.admits(r, node, self.limit(r))  # stale within this walk
                    _, count, miss, _ = tab.links[r, node]
                    if admit and count > 0:
                        buf.append(node)
                        node = int(miss)
                    else:
                        node = node + 1 if admit else int(miss)
                if not buf:
                    break
                self.deferred += len(buf)
                for nd in buf:
                    self.drain_one(r, nd)
        return self

    def packet(self, two_level):
        """csrc/bvh_packet.cu: each warp of a packet walks the packet's
        order on its own, enters what any of its rays admits, and defers."""
        tab = self.tab
        for w0 in range(0, tab.n, 32):
            rays = range(w0, min(w0 + 32, tab.n))
            r0 = rays[0]  # the warp's rays share the packet's order and cut
            any_ray = any(tab.cap[r] >= np.float32(TMIN) for r in rays)
            n_cut = int(tab.n_cut[r0]) if two_level else 0
            node, end, cut = 0, (0 if two_level else tab.m), 0
            if not any_ray:
                end, cut = 0, n_cut
            while True:
                buf = []
                while len(buf) < self.depth:
                    if node >= end:
                        if cut >= n_cut:
                            break
                        if any(tab.admits(r, cut, self.limit(r), cut=True) for r in rays):
                            node, end = int(tab.crange[r0, cut, 0]), int(tab.crange[r0, cut, 1])
                        cut += 1
                        continue
                    vote = any(tab.admits(r, node, self.limit(r)) for r in rays)
                    _, count, miss, _ = tab.links[r0, node]
                    if vote and count > 0:
                        buf.append(node)
                        node = int(miss)
                    else:
                        node = node + 1 if vote else int(miss)
                if not buf:
                    break
                self.deferred += len(buf)
                for nd in buf:
                    for r in rays:
                        self.drain_one(r, nd)
        return self

    def outputs(self, kind, rays, blocks):
        """The six outputs, by the plain version's epilogue."""
        o, d, _ = rays
        tab = self.tab
        t = torch.from_numpy(self.best_t)
        out = [torch.zeros(tab.n) for _ in range(5)]
        hit = torch.nonzero(t < 1e30)[:, 0]
        if hit.numel():
            blk, lane = torch.from_numpy(self.best_blk)[hit], torch.from_numpy(self.best_lane)[hit]
            f = blocks[blk, :, (512 if kind == "tri_mxu" else 0) + lane]
            a = torch.from_numpy(tab.a[hit.numpy(), blk.numpy(), lane.numpy()])
            b = torch.from_numpy(tab.b[hit.numpy(), blk.numpy(), lane.numpy()])
            attrs = bt._epilogue(kind, f, [c[hit] for c in o], [c[hit] for c in d], t[hit], a, b)
            for dst, src in zip(out, attrs):
                dst[hit] = src
        return [t, *out[:4], torch.round(out[4]).to(torch.int32)]


# (kind, the kernel's shape, two_level)
FORMS = [("tri", "per-ray", False), ("box", "per-ray", False), ("sphere", "per-ray", False),
         ("tri_mxu", "packet", False), ("tri", "packet", True), ("box", "packet", False),
         ("sphere", "packet", True)]
_cache = {}


def _case(kind, shape):
    key = (kind, shape)
    if key not in _cache:
        g, blocks = _group(kind)
        rays = _rays(kind, seed=31)
        _cache[key] = (g, blocks, rays, Tables(kind, rays, g, blocks, shape == "packet"))
    return _cache[key]


@pytest.mark.parametrize("depth", [1, 2, 8])
@pytest.mark.parametrize("form", FORMS, ids=lambda f: f"{f[0]}-{f[1]}" + ("-two_level" * f[2]))
def test_deferred_pruned_cooperative_walk_equals_plain(form, depth):
    kind, shape, two_level = form
    g, blocks, rays, tab = _case(kind, shape)
    model = Model(tab, depth)
    model = model.packet(two_level) if shape == "packet" else model.per_ray()
    stats = {}
    ref = bt.bvh_traverse_plain(*rays, g.pk_bb, g.pk_links, blocks, TMIN, TMAX, kind=kind,
                                packet=shape == "packet", two_level=two_level,
                                cbb=g.pk_cbb, crange=g.pk_crange, stats=stats)
    got = model.outputs(kind, rays, blocks)
    for name, a, b in zip(("t", "a0", "a1", "a2", "a3", "mat"), got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
    # a ray sweeps exactly the leaves the plain walk sweeps, whatever was deferred
    assert model.sweeps == stats["sweeps"]
    if shape == "per-ray":
        assert model.deferred >= model.sweeps
    t, cap = ref[0].numpy(), rays[2].numpy()
    assert (t < 1e30).sum() >= 5 and (t[cap <= 0] == 1e30).all()


@pytest.mark.parametrize("kind", ["tri", "tri_mxu", "box", "sphere"])
def test_a_tie_inside_a_leaf_goes_to_the_lowest_index(kind):
    """Primitives 0-31 of every block sit again at 32-63 and 96-127: where
    one of them wins, the reduction and the plain version's argmin both
    name the original, never a copy."""
    g, blocks, rays, tab = _case(kind, "per-ray" if kind != "tri_mxu" else "packet")
    is_copy = lambda i: any(c <= i < c + 32 for c in COPIES)
    wins = 0
    for r in range(tab.n):
        for blk in range(blocks.shape[0]):
            row = tab.t[r, blk]
            for c in COPIES:
                np.testing.assert_array_equal(row[c: c + 32], row[:32])
            first = int(np.argmin(row))
            t, lane = sweep_coop(row, BIG)
            assert (t, lane) == ((row[first], first) if row[first] < BIG else (BIG, NO_LANE))
            assert not is_copy(lane)
            wins += int(row[first] < BIG and first < 32)
    assert wins > 0


def test_a_deeper_buffer_defers_more_and_sweeps_the_same():
    """The stale best t admits leaves that the fresh re-test then drops:
    more with a deeper buffer, and never one sweep more."""
    g, blocks, rays, tab = _case("tri", "per-ray")
    runs = {d: Model(tab, d).per_ray() for d in (1, 8)}
    assert runs[1].sweeps == runs[8].sweeps == runs[1].deferred
    assert runs[8].deferred > runs[8].sweeps

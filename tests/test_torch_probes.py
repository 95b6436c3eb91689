"""The traversal probes' plain versions (ops/bvh_probes.py) on the CPU.

P1 (ray I/O, walk only, sweep only) is held against the TPU probe script's
own kernel bodies: `scripts/kern_ab.py` exposes `make_kernels` and
`tri_sweep`, which run here through `pl.pallas_call(..., interpret=True)`
with block specs written in this file; the sweep also against the dense
`triangles.intersect_brute`. The kernel bodies of P2 (`scripts/kern_lat.py`)
and P3 (`scripts/kern_walkvar.py`) are closures inside their `main()` and
cannot be reached without compiling for a TPU, so their plain versions are
held against a numpy walk written here from kern_lat.py:108-126 and
kern_walkvar.py:93-206, packet by packet: integers exact, t within T_RTOL.

The scene is a 1,440-triangle knot (27 nodes in 8 octant orders, 14 leaf
blocks) under 768 primary rays in tile order.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from raysnail_tpu_torch import probes
from raysnail_tpu_torch.geometry import triangles
from raysnail_tpu_torch.camera import Ray
from raysnail_tpu_torch.ops import bvh_probes as bp
from raysnail_tpu_torch.prelude.vec import Vec3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIG = np.float32(1e30)
T_RTOL = 1e-5          # t against the TPU kernel bodies and the numpy walk
WIDTH, HEIGHT, KNOT = 32, 24, (60, 12)
F32 = np.float32


@pytest.fixture(scope="module")
def case():
    return probes.build_case("knot-9600", "cpu", WIDTH, HEIGHT, KNOT)


@pytest.fixture(scope="module")
def kern_ab():
    spec = importlib.util.spec_from_file_location(
        "kern_ab", os.path.join(REPO, "scripts", "kern_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np(case):
    o = np.stack([a.numpy() for a in case.o], 1)
    d = np.stack([a.numpy() for a in case.d], 1)
    tri = case.tri
    return o, d, tri.pk_bb.numpy(), tri.pk_links.numpy(), tri.pk_tri.numpy()


# -- a numpy walk, packet by packet ------------------------------------------------

def np_tri_sweep(blk, o, d, bt):
    """kern_walkvar.py:147-171 for rays o, d (n, 3) and one block (24, 128)."""
    fld = lambda i: blk[i][None, :]
    ox, oy, oz = (o[:, c:c + 1] for c in range(3))
    dx, dy, dz = (d[:, c:c + 1] for c in range(3))
    j, k, ll = fld(0) - ox, fld(1) - oy, fld(2) - oz
    ax, ay, az = fld(3), fld(4), fld(5)
    ddx, ddy, ddz = fld(6), fld(7), fld(8)
    eihf = ddy * dz - dy * ddz
    gfdi = dx * ddz - ddx * dz
    dheg = ddx * dy - ddy * dx
    denom = ax * eihf + ay * gfdi + az * dheg
    denom = np.where(np.abs(denom) < 1e-20, F32(1e-20), denom)
    with np.errstate(all="ignore"):
        beta = (j * eihf + k * gfdi + ll * dheg) / denom
        akjb = ax * k - j * ay
        jcal = j * az - ax * ll
        blkc = ay * ll - k * az
        gamma = (dz * akjb + dy * jcal + dx * blkc) / denom
        t = -(ddz * akjb + ddy * jcal + ddx * blkc) / denom
    ok = ((beta >= 0) & (beta < 1) & (gamma > 0) & (beta + gamma < 1) & (t >= F32(1e-3))
          & (t <= BIG) & (fld(9) > 0) & (t < bt[:, None]))
    return np.minimum(bt, np.where(ok, t, BIG).min(axis=1))


def np_walk(o, d, pk_bb, pk_links, width, mode="plain", pk_tri=None, sweep=None):
    """One packet of `width` rays after another: the walk of
    kern_lat.py:108-126 (mode "plain"; "cap" adds near <= cap, "bt" is
    kern_ab.py:110-130), with the take, chunk and sweep logic of
    kern_walkvar.py:175-234 when `sweep` is "buf" or "idx"."""
    n, m = o.shape[0], pk_bb.shape[1]
    out = {k: np.zeros(n, np.int64) for k in ("steps", "leaves", "last", "wins")}
    out["acc"] = np.zeros(n, F32)
    out["bt"] = np.full(n, BIG)
    out["tpu_acc"] = np.zeros(n, np.float64)   # the TPU probes' sum over the packet
    out["margin"] = np.inf
    eps = F32(1e-12)
    for p0 in range(0, n, width):
        sl = slice(p0, min(p0 + width, n))
        po, pd = o[sl], d[sl]
        with np.errstate(all="ignore"):
            inv = F32(1.0) / np.where(np.abs(pd) < eps, np.where(pd < 0, -eps, eps), pd)
        octant = 0
        if pk_bb.shape[0] == 8:
            s = pd.astype(np.float64).sum(axis=0)
            out["margin"] = min(out["margin"], np.abs(s).min())
            octant = int(s[0] < 0) * 4 + int(s[1] < 0) * 2 + int(s[2] < 0)
        bb, links = pk_bb[octant], pk_links[octant]
        node = steps = leaves = 0
        last = -1
        acc = np.zeros(po.shape[0], F32)
        bt = np.full(po.shape[0], BIG)
        walk_bt = np.full(po.shape[0], BIG)
        wins = np.zeros(po.shape[0], np.int64)
        tpu_acc = 0.0
        while node < m:
            lo = (bb[node, 0:3][None] - po) * inv
            hi = (bb[node, 3:6][None] - po) * inv
            near = np.minimum(lo, hi).max(axis=1)
            far = np.maximum(lo, hi).min(axis=1)
            admit = (near <= far) & (far >= F32(1e-3))
            if mode == "bt":
                admit &= near <= walk_bt
            if mode == "cap":
                admit &= near <= BIG
            any_hit = bool(admit.any())
            is_leaf = links[node, 1] > 0
            acc = acc + near * F32(1e-20)
            tpu_acc += float(near.astype(np.float64).sum()) * 1e-20
            if any_hit and is_leaf:
                if mode == "bt":
                    walk_bt = np.minimum(walk_bt, near)
                blk = int(links[node, 0])
                if sweep is not None:
                    swept = blk if sweep == "buf" else (leaves % bp.CHUNK) % pk_tri.shape[0]
                    new = np_tri_sweep(pk_tri[swept], po, pd, bt)
                    wins += new < bt
                    bt = new
                last = blk
                leaves += 1
            node = node + 1 if (any_hit and not is_leaf) else int(links[node, 2])
            steps += 1
        out["steps"][sl], out["leaves"][sl], out["last"][sl] = steps, leaves, last
        out["acc"][sl], out["wins"][sl] = acc, wins
        out["bt"][sl] = walk_bt if mode == "bt" else bt
        out["tpu_acc"][sl] = tpu_acc
    return out


def assert_t_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    hit = want < BIG
    np.testing.assert_array_equal(got < BIG, hit)
    np.testing.assert_allclose(got[hit], want[hit], rtol=T_RTOL)
    assert hit.sum() > 50


def assert_walk(res, ref, width):
    """Integers exact, the port's per-ray accumulator against the numpy walk,
    and its packet sums against the TPU probes' summed form."""
    np.testing.assert_array_equal(res.steps.numpy(), ref["steps"])
    np.testing.assert_array_equal(res.leaves.numpy(), ref["leaves"])
    np.testing.assert_array_equal(res.last.numpy(), ref["last"])
    # no packet's summed direction is near a sign change (a ray alone: exact)
    assert width == 1 or ref["margin"] > 1e-3
    assert ref["leaves"].max() > 0 and ref["steps"].max() > 3


# -- P1 against scripts/kern_ab.py's kernel bodies ------------------------------------

def _run_kern_ab(kern_ab, kernel, o, d, bb, links, prim):
    n = o.shape[0]
    col3 = lambda a: jnp.asarray(a).reshape(-1, kern_ab.PACKET, 1)
    row = pl.BlockSpec((1, kern_ab.PACKET, 1), lambda i: (i, 0, 0))
    whole = lambda a: pl.BlockSpec(a.shape, lambda i, nd=a.ndim: (0,) * nd)
    call = pl.pallas_call(
        kernel, grid=(n // kern_ab.PACKET,),
        in_specs=[row] * 6 + [whole(bb), whole(links), whole(prim)], out_specs=row,
        out_shape=jax.ShapeDtypeStruct((n // kern_ab.PACKET, kern_ab.PACKET, 1), jnp.float32),
        interpret=True)
    out = call(*(col3(o[:, c]) for c in range(3)), *(col3(d[:, c]) for c in range(3)),
               jnp.asarray(bb), jnp.asarray(links), jnp.asarray(prim))
    return np.asarray(out).reshape(-1)


@pytest.fixture(scope="module")
def ab_kernels(kern_ab, case):
    o, d, pk_bb, pk_links, pk_tri = _np(case)
    assert o.shape[0] % kern_ab.PACKET == 0
    # kern_ab.py binds one node order (a 2-D pk_bb): octant 0's
    kernels = kern_ab.make_kernels(pk_bb.shape[1], pk_tri.shape[0], pk_tri.shape[1])
    run = lambda k: _run_kern_ab(kern_ab, k, o, d, pk_bb[0], pk_links[0], pk_tri)
    return dict(zip(("io", "sweep", "walk"), (run(k) for k in kernels)))


@pytest.mark.parametrize("layout", bp.IO_LAYOUTS)
def test_probe_io_equals_the_tpu_probe(case, ab_kernels, layout):
    got = bp.probe_io(case.o, case.d, layout).numpy()
    np.testing.assert_allclose(got, ab_kernels["io"], rtol=1e-6)
    assert np.abs(got).max() > 1


def test_probe_walk_equals_the_tpu_probe(case, ab_kernels):
    """walk_kernel's leaf update is min(bt, near) for the whole packet when
    any ray admits; it walks octant 0's order."""
    tri = case.tri
    res = bp.probe_walk(case.o, case.d, tri.pk_bb[:1].contiguous(),
                        tri.pk_links[:1].contiguous(), "packet")
    want = ab_kernels["walk"]
    got = res.value.numpy()
    np.testing.assert_array_equal(got < BIG, want < BIG)
    np.testing.assert_allclose(got[want < BIG], want[want < BIG], rtol=T_RTOL, atol=1e-5)
    assert (want < BIG).sum() > 50


@pytest.mark.parametrize("shape", list(bp.SHAPES))
def test_probe_sweep_equals_the_tpu_probe_and_the_dense_sweep(case, ab_kernels, shape):
    res = bp.probe_sweep(case.o, case.d, case.tri.pk_tri, shape)
    assert_t_close(res.t.numpy(), ab_kernels["sweep"])
    ray = Ray(Vec3(*case.o), Vec3(*case.d), None)
    brute = triangles.intersect_brute(case.tri, ray, bp.T_MIN, float(BIG))
    assert_t_close(res.t.numpy(), brute.t.numpy())
    assert int(res.swept[0]) == case.tri.pk_tri.shape[0]
    part = bp.probe_sweep(case.o, case.d, case.tri.pk_tri, shape, n_blocks=3)
    assert int(part.swept[0]) == 3 and bool((part.t >= res.t).all())


def test_kern_ab_tri_sweep_equals_the_ports(kern_ab, case):
    """The script's `tri_sweep` on one block against the port's."""
    o, d, _, _, pk_tri = _np(case)
    col = lambda a: jnp.asarray(a)[:128, None]
    bt = jnp.full((128, 1), 1e30, jnp.float32)
    want = np.asarray(kern_ab.tri_sweep(jnp.asarray(pk_tri[5]), *(col(o[:, c]) for c in range(3)),
                                        *(col(d[:, c]) for c in range(3)), bt, 1e-3, 1e30))[:, 0]
    tcol = lambda v: [c[:128, None] for c in v]
    got = bp.tri_sweep(case.tri.pk_tri[5, :10], tcol(case.o), tcol(case.d),
                       torch.full((128,), 1e30)).numpy()
    np.testing.assert_array_equal(got < BIG, want < BIG)
    np.testing.assert_allclose(got, want, rtol=T_RTOL)


# -- P1 walk, P2, P3 against the numpy walk ---------------------------------------------

@pytest.mark.parametrize("shape", list(bp.SHAPES))
def test_probe_walk_equals_the_numpy_walk(case, shape):
    o, d, pk_bb, pk_links, _ = _np(case)
    ref = np_walk(o, d, pk_bb, pk_links, bp.SHAPES[shape], "bt")
    res = bp.probe_walk(case.o, case.d, case.tri.pk_bb, case.tri.pk_links, shape)
    assert_walk(res, ref, bp.SHAPES[shape])
    np.testing.assert_array_equal(res.value.numpy(), ref["bt"])


@pytest.mark.parametrize("variant", list(bp.LATENCY_VARIANTS))
def test_probe_walk_latency_equals_the_numpy_walk(case, variant):
    o, d, pk_bb, pk_links, _ = _np(case)
    width, mode = bp.LATENCY_VARIANTS[variant]
    ref = np_walk(o, d, pk_bb, pk_links, width, "cap" if mode == "buf" else mode)
    res = bp.probe_walk_latency(case.o, case.d, case.tri.pk_bb, case.tri.pk_links, variant)
    assert_walk(res, ref, width)
    np.testing.assert_allclose(res.value.numpy(), ref["acc"], rtol=1e-6, atol=1e-30)
    # the TPU probe adds the packet's summed near to every lane: the port's
    # per-ray sums add up to it
    mine = np.add.reduceat(res.value.numpy().astype(np.float64), np.arange(0, len(o), width))
    np.testing.assert_allclose(mine, ref["tpu_acc"][::width], rtol=1e-4)


@pytest.fixture(scope="module")
def variant_refs(case):
    o, d, pk_bb, pk_links, pk_tri = _np(case)
    cache = {}

    def get(shape, sweep):
        if (shape, sweep) not in cache:
            cache[shape, sweep] = np_walk(o, d, pk_bb, pk_links, bp.SHAPES[shape], "plain",
                                          pk_tri, sweep)
        return cache[shape, sweep]

    return get


@pytest.mark.parametrize("shape", list(bp.SHAPES))
@pytest.mark.parametrize("v", bp.VARIANTS)
def test_probe_walk_variant_equals_the_numpy_walk(case, variant_refs, v, shape):
    tri = case.tri
    ref = variant_refs(shape, bp.variant_sweep(v))
    res = bp.probe_walk_variant(v, case.o, case.d, tri.pk_bb, tri.pk_links, tri.pk_tri, shape)
    n = case.n
    np.testing.assert_array_equal(res.steps.numpy(), ref["steps"])
    np.testing.assert_allclose(res.acc.numpy(), ref["acc"], rtol=1e-6, atol=1e-30)
    np.testing.assert_array_equal(res.leaves.numpy(), ref["leaves"] if v >= 1 else np.zeros(n))
    np.testing.assert_array_equal(res.last.numpy(), ref["last"] if v >= 2 else np.full(n, -1))
    np.testing.assert_array_equal(res.swept.numpy(), ref["leaves"] if v >= 4 else np.zeros(n))
    np.testing.assert_array_equal(res.wins.numpy(), ref["wins"] if v >= 7 else np.zeros(n))
    if v >= 4:
        assert_t_close(res.t.numpy(), ref["bt"])
    else:
        assert bool((res.t == 1e30).all())
    if v == 8:
        assert res.rec.shape == (5, n) and torch.equal(res.rec[0], res.t)
        assert torch.equal(res.mat, res.wins)
        won = res.wins > 0
        assert torch.equal(res.rec[2][won], res.t[won])          # the last win's t
        assert bool((res.rec[3][won] > res.t[won]).all())        # t before it
        assert bool((res.rec[4] < bp.CHUNK).all())               # its slot in the chunk
    elif v == 7:
        assert res.rec.shape == (n,) and res.mat is None
    else:
        assert res.rec is None and res.mat is None


def test_v4_finds_the_dense_sweeps_hits(case):
    """The bisect's walk admits by the slab alone, so V4 (walk + sweep of the
    buffered leaves) finds the closest hit of the dense sweep, in both shapes."""
    tri = case.tri
    brute = triangles.intersect_brute(tri, Ray(Vec3(*case.o), Vec3(*case.d), None),
                                      bp.T_MIN, float(BIG)).t.numpy()
    for shape in bp.SHAPES:
        res = bp.probe_walk_variant(4, case.o, case.d, tri.pk_bb, tri.pk_links, tri.pk_tri,
                                    shape)
        assert_t_close(res.t.numpy(), brute)


# -- the wrappers and the entry point ------------------------------------------------------

def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    tri = case.tri
    with pytest.raises(ValueError, match="unknown layout"):
        bp.probe_io(case.o, case.d, "aos")
    with pytest.raises(ValueError, match="must be one of"):
        bp.probe_walk_variant(6, case.o, case.d, tri.pk_bb, tri.pk_links, tri.pk_tri)
    with pytest.raises(ValueError, match="n_blocks"):
        bp.probe_sweep(case.o, case.d, tri.pk_tri, n_blocks=10_000)
    with pytest.raises(ValueError, match="contiguous"):
        bp.probe_walk(case.o, case.d, tri.pk_bb.double(), tri.pk_links)
    meta = lambda v: tuple(a.to("meta") for a in v)
    with pytest.raises(ValueError, match="unsupported device"):
        bp.probe_io(meta(case.o), meta(case.d))
    assert set(bp.launches) == set(bp.launch_keys()) and not any(bp.launches.values())


@pytest.mark.parametrize("family", [*probes.FAMILIES, "all"])
def test_entry_point_runs_and_checks_every_probe(family, case, capsys):
    assert probes.main([family, "--device", "cpu"], case=case) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    # family ab also prints the two full traversal kernels beside its phases
    want = {"ab": 8 + 2, "lat": 5, "walkvar": 16, "all": 29 + 2}[family]
    assert len(lines) == 2 + want and "rays=768 nodes=27 orders=8 blocks=14" in lines[1]
    assert all("ms (" in ln and "Mrays/s)" in ln for ln in lines[2:])
    assert sum("equal True" in ln for ln in lines) == want - 2 * (family in ("ab", "all"))
    assert sum("t equals V4's: True" in ln for ln in lines) == 2 * (family in ("ab", "all"))


def test_compare_raises_on_a_disagreement(case):
    tri = case.tri
    ref = bp.probe_walk_latency(case.o, case.d, tri.pk_bb, tri.pk_links, "w128")
    assert probes.compare("latency/w128", ref, ref)["bit_equal"]
    with pytest.raises(AssertionError, match="steps"):
        probes.compare("latency/w128", ref._replace(steps=ref.steps + 1), ref)
    with pytest.raises(AssertionError, match="value"):
        probes.compare("latency/w128", ref._replace(value=ref.value * 1.001), ref)

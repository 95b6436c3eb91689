"""The traversal's remaining modes in the port against the JAX package's,
on the CPU: the "tri_mxu" kind, `two_level`, `stream`, and the per-packet
node order of the packet kernel, all through the plain PyTorch version.

  * the host packing: `_pack_mxu_blocks`' blocks, `pk_cbb` and `pk_crange`
    equal the JAX compile's exactly (RAYSNAIL_MESH_SOLVER is set around both
    compiles; nothing in the JAX package changes);
  * plain "tri_mxu" against the JAX kernel `bvh_traverse(kind="tri_mxu",
    interpret=True)`;
  * plain `two_level=True` against plain `two_level=False`, bit for bit, for
    all four kinds, per ray and per packet, on the JAX compile's arrays and
    on the port's own, and against the interpret-mode kernel given the cut;
  * the coarse cut's padding entries: never tested by the port, and of no
    effect on a result when they are.

Tolerances. tri_mxu and the JAX kernel evaluate the same feature product,
the kernel through XLA's dot at HIGHEST precision, the port as ten rounded
terms in a fixed order: t within rtol 1e-4 on rays that both keep, hit masks
equal on all but 0.5% of the rays (a ray on a triangle's edge, where beta or
gamma rounds across 0). Against the Cramer kind the port's tri_mxu is held to
rtol 1e-3. Everything between the port's own modes is exact.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_bvh as base
from raysnail_tpu.ops import bvh_pallas
from raysnail_tpu_torch import scene as tscene_mod
from raysnail_tpu_torch.convert import scene_arrays_from_numpy
from raysnail_tpu_torch.ops import bvh_traverse as bt

TMIN, TMAX, BIG = base.TMIN, base.TMAX, base.BIG
MXU_MISS_SHARE = 5e-3
PRIM = {"triangles": "pk_tri", "boxes": "pk_box", "spheres": "pk_sph"}
CASES = {"tri": ("knot-1440", "triangles"), "tri_mxu": ("knot-1440", "triangles"),
         "box": ("boxes-144", "boxes"), "sphere": ("spheres-700", "spheres")}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _compiled(kind, monkeypatch):
    """(JAX scene, port scene, group name) for `kind`, in its block format."""
    monkeypatch.setenv("RAYSNAIL_MESH_SOLVER", "mxu" if kind == "tri_mxu" else "cramer")
    scene, group = CASES[kind]
    return (*base._compile_both(scene), group)


def _packed(group, name):
    return (group.pk_bb, group.pk_links, getattr(group, PRIM[name]))


def _cols(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3))


def _plain(o, d, cap, group, name, kind, **kw):
    return bt.bvh_traverse_plain(_cols(o), _cols(d), torch.from_numpy(cap),
                                 *_packed(group, name), TMIN, TMAX, kind=kind,
                                 cbb=group.pk_cbb, crange=group.pk_crange, **kw)


# -- host packing -------------------------------------------------------------

@pytest.mark.parametrize("name", ["knot-1440", "knot-9600"])
def test_mxu_blocks_and_coarse_cut_equal_the_jax_compile(name, monkeypatch):
    monkeypatch.setenv("RAYSNAIL_MESH_SOLVER", "mxu")
    jscene, tscene = base._compile_both(name)
    expected = scene_arrays_from_numpy(jax.tree_util.tree_map(np.asarray, jscene.arrays), "cpu")
    got = tscene.arrays.triangles
    assert tuple(got.pk_tri.shape[1:]) == (bt.NF["tri_mxu"], bt.MXU_LANES)
    assert tuple(got.pk_cbb.shape) == (8, bt.COARSE_MAX, 8)
    assert got.pk_crange.dtype == torch.int32
    base._assert_same(got, expected.triangles, "triangles")


def test_solver_argument_overrides_the_environment(monkeypatch):
    monkeypatch.setenv("RAYSNAIL_MESH_SOLVER", "mxu")
    tb = base.TBuilder()
    for obj in base.SCENES["knot-1440"](base.tir):
        tb.add(obj)
    assert tb.compile(device="cpu").arrays.triangles.pk_tri.shape[2] == bt.MXU_LANES
    assert tb.compile(device="cpu", mesh_solver="cramer").arrays.triangles.pk_tri.shape[2] == bt.LANES


def test_single_order_tree_and_its_cut_equal_the_jax_compile(monkeypatch):
    """Above the node cap the tree keeps one order (K = 1), cut included."""
    monkeypatch.setenv("RAYSNAIL_BVH_OCT_CAP", "100")
    monkeypatch.setattr(tscene_mod, "OCTANT_CAP", 100)
    jscene, tscene = base._compile_both("knot-9600")
    expected = scene_arrays_from_numpy(jax.tree_util.tree_map(np.asarray, jscene.arrays), "cpu")
    got = tscene.arrays.triangles
    assert got.pk_bb.shape[0] == 1 and got.pk_cbb.shape[0] == 1
    base._assert_same(got, expected.triangles, "triangles")


@pytest.mark.parametrize("kind", ["tri", "box", "sphere"])
def test_leaf_tree_counts_the_real_cut_entries(kind):
    _, tscene = base._compile_both(CASES[kind][0])
    g = getattr(tscene.arrays, CASES[kind][1])
    m = g.pk_bb.shape[1]
    counts = bt.cut_counts(g.pk_crange, m)
    assert ((counts >= 1) & (counts <= bt.COARSE_MAX)).all()
    # the count that _leaf_tree returns is the count the walks derive
    lo = np.random.default_rng(1).uniform(-5, 5, (3000, 3))
    out = tscene_mod._leaf_tree(lo, lo + 0.1)
    assert out[4].tolist() == bt.cut_counts(torch.from_numpy(out[3]), out[0].shape[1]).tolist()
    for k in range(g.pk_bb.shape[0]):
        real = g.pk_crange[k, : int(counts[k])]
        # the real entries are disjoint ranges in DFS order that hold every
        # leaf (the nodes between them are interior nodes above the cut); the
        # padding starts at m
        assert (real[:, 0] < real[:, 1]).all() and int(real[-1, 1]) == m
        assert (real[1:, 0] >= real[:-1, 1]).all()
        leaves = torch.nonzero(g.pk_links[k, :, 1] > 0)[:, 0]
        inside = (leaves[:, None] >= real[None, :, 0]) & (leaves[:, None] < real[None, :, 1])
        assert (inside.sum(dim=1) == 1).all()
        assert (g.pk_crange[k, int(counts[k]):, 0] == m).all()


# -- tri_mxu -------------------------------------------------------------------

def _jax_traverse(o, d, cap, pk, kind, **kw):
    """The JAX kernel in interpret mode, the tail padded with dead lanes."""
    n = o.shape[0]
    pad = (-n) % bvh_pallas.TILE_R

    def col(a, fill=0.0):
        return jnp.asarray(np.concatenate([a, np.full(pad, fill, np.float32)]))

    out = bvh_pallas.bvh_traverse(
        tuple(col(o[:, i]) for i in range(3)), tuple(col(d[:, i]) for i in range(3)),
        col(cap, -1.0), *(jnp.asarray(a.numpy()) for a in pk), jnp.float32(TMIN),
        jnp.float32(TMAX), kind=kind, interpret=True, **kw)
    return [np.asarray(a)[:n] for a in out]


def test_plain_tri_mxu_matches_the_jax_kernel(monkeypatch):
    _, tscene, _ = _compiled("tri_mxu", monkeypatch)
    g = tscene.arrays.triangles
    n = 1000
    o, d, cap = base._rays("tri", n, seed=21)
    jt, *jattrs = _jax_traverse(o, d, cap, _packed(g, "triangles"), "tri_mxu")
    out = bt.bvh_traverse(_cols(o), _cols(d), torch.from_numpy(cap), *_packed(g, "triangles"),
                          TMIN, TMAX, kind="tri_mxu")
    tt, *tattrs = (a.numpy() for a in out)
    dead = cap <= 0
    assert (tt[dead] == BIG).all() and all((a[dead] == 0).all() for a in tattrs)
    seen = lambda t: (t < BIG) & (t <= cap)
    jh, th = seen(jt), seen(tt)
    assert (jh != th).mean() <= MXU_MISS_SHARE, (jh != th).sum()
    both = jh & th
    assert both.sum() > n // 10
    np.testing.assert_allclose(tt[both], jt[both], rtol=1e-4)
    np.testing.assert_array_equal(tattrs[4][both], jattrs[4][both])
    np.testing.assert_allclose(np.stack(tattrs[:3], 1)[both], np.stack(jattrs[:3], 1)[both],
                               atol=1e-3)
    assert (tattrs[3] == 0).all()


def test_plain_tri_mxu_agrees_with_the_cramer_kind(monkeypatch):
    _, cscene, _ = _compiled("tri", monkeypatch)
    _, xscene, _ = _compiled("tri_mxu", monkeypatch)
    o, d, cap = base._rays("tri", 1000, seed=22)
    tc = _plain(o, d, cap, cscene.arrays.triangles, "triangles", "tri", packet=True)[0].numpy()
    tx = _plain(o, d, cap, xscene.arrays.triangles, "triangles", "tri_mxu",
                packet=True)[0].numpy()
    assert ((tc < BIG) != (tx < BIG)).mean() <= MXU_MISS_SHARE
    both = (tc < BIG) & (tx < BIG)
    assert both.sum() > 100
    np.testing.assert_allclose(tx[both], tc[both], rtol=1e-3)


# -- two_level, stream, packet --------------------------------------------------

@pytest.mark.parametrize("arrays_from", ["port", "jax"])
@pytest.mark.parametrize("kind", ["tri", "tri_mxu", "box", "sphere"])
def test_plain_two_level_equals_one_level_bit_for_bit(kind, arrays_from, monkeypatch):
    jscene, tscene, name = _compiled(kind, monkeypatch)
    arrays = tscene.arrays if arrays_from == "port" else scene_arrays_from_numpy(
        jax.tree_util.tree_map(np.asarray, jscene.arrays), "cpu")
    g = getattr(arrays, name)
    o, d, cap = base._rays(kind[:3] if kind.startswith("tri") else kind, 700, seed=31)
    for packet in (False, True):
        one = _plain(o, d, cap, g, name, kind, packet=packet)
        two = _plain(o, d, cap, g, name, kind, packet=packet, two_level=True)
        streamed = _plain(o, d, cap, g, name, kind, packet=packet, two_level=True, stream=True)
        assert int((one[0] < BIG).sum()) > 50
        for a, b, c in zip(one, two, streamed):
            assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("kind", ["tri", "box", "sphere"])
def test_plain_two_level_matches_the_jax_kernel_given_the_cut(kind, monkeypatch):
    _, tscene, name = _compiled(kind, monkeypatch)
    g = getattr(tscene.arrays, name)
    n = 600
    o, d, cap = base._rays(kind, n, seed=41)
    jt = _jax_traverse(o, d, cap, _packed(g, name), kind, two_level=True,
                       cbb=jnp.asarray(g.pk_cbb.numpy()),
                       crange=jnp.asarray(g.pk_crange.numpy()))[0]
    tt = bt.bvh_traverse(_cols(o), _cols(d), torch.from_numpy(cap), *_packed(g, name), TMIN,
                         TMAX, kind=kind, two_level=True, cbb=g.pk_cbb,
                         crange=g.pk_crange)[0].numpy()
    seen = lambda t: (t < BIG) & (t <= cap)
    jh, th = seen(jt), seen(tt)
    assert (jh != th).mean() <= base.MISS_SHARE, (jh != th).sum()
    both = jh & th
    assert both.sum() > n // 10
    np.testing.assert_allclose(tt[both], jt[both], rtol=1e-5)


@pytest.mark.parametrize("two_level", [False, True], ids=["one-level", "two-level"])
@pytest.mark.parametrize("kind", ["tri", "tri_mxu"])
def test_single_order_walk_matches_the_jax_kernel(kind, two_level, monkeypatch):
    """A tree above the node cap keeps one node order (K = 1): every ray and
    every packet walks it in build order. The plain walk, per ray and per
    packet, against the interpret-mode kernel on the same arrays."""
    monkeypatch.setattr(tscene_mod, "OCTANT_CAP", 100)
    monkeypatch.setenv("RAYSNAIL_MESH_SOLVER", "mxu" if kind == "tri_mxu" else "cramer")
    _, tscene = base._compile_both("knot-9600")
    g = tscene.arrays.triangles
    assert g.pk_bb.shape[0] == 1 and g.pk_bb.shape[1] > 100
    n = 600
    o, d, cap = base._rays("tri", n, seed=45)
    cut = dict(cbb=jnp.asarray(g.pk_cbb.numpy()), crange=jnp.asarray(g.pk_crange.numpy()))
    jt = _jax_traverse(o, d, cap, _packed(g, "triangles"), kind, two_level=two_level,
                       **(cut if two_level else {}))[0]
    per_ray = _plain(o, d, cap, g, "triangles", kind, packet=False, two_level=two_level)
    packet = _plain(o, d, cap, g, "triangles", kind, packet=True, two_level=two_level)
    for a, b in zip(per_ray, packet):  # one order: the packet's is the ray's
        assert torch.equal(a, b)
    tt = packet[0].numpy()
    seen = lambda t: (t < BIG) & (t <= cap)
    jh, th = seen(jt), seen(tt)
    share = MXU_MISS_SHARE if kind == "tri_mxu" else base.MISS_SHARE
    assert (jh != th).mean() <= share, (jh != th).sum()
    both = jh & th
    assert both.sum() > n // 10
    np.testing.assert_allclose(tt[both], jt[both], rtol=1e-4 if kind == "tri_mxu" else 1e-5)


def test_padding_cut_entries_pass_the_slab_test_and_change_nothing(monkeypatch):
    """The JAX compile's padding entry [+1e30.., -1e30..] is admitted by
    every ray (min and max of its two products swap, so near <= far) and
    leads into an empty range. The port counts it out; walking it, as the
    TPU kernel does, gives the same results."""
    _, tscene, name = _compiled("tri", monkeypatch)
    g = tscene.arrays.triangles
    m = g.pk_bb.shape[1]
    counts = bt.cut_counts(g.pk_crange, m)
    assert int(counts.max()) < bt.COARSE_MAX  # there is padding to speak of
    o, d, cap = base._rays("tri", 500, seed=51)
    pad_box = g.pk_cbb[0, -1:, :]
    near, far = bt.slab(pad_box, _cols(o), [bt.safe_inv(c) for c in _cols(d)])
    assert bool((near <= far).all())
    # make the padding count as real entries with the empty range [m-1, m-1)
    walked = g.pk_crange.clone()
    walked[:, :, :2] = torch.where(walked[:, :, :1] >= m, torch.tensor(m - 1, dtype=torch.int32),
                                   walked[:, :, :2])
    assert (bt.cut_counts(walked, m) == bt.COARSE_MAX).all()
    ref = _plain(o, d, cap, g, name, "tri", two_level=True)
    got = bt.bvh_traverse_plain(_cols(o), _cols(d), torch.from_numpy(cap),
                                *_packed(g, name), TMIN, TMAX, kind="tri", two_level=True,
                                cbb=g.pk_cbb, crange=walked)
    for a, b in zip(ref, got):
        assert torch.equal(a, b)


def test_packet_octant_is_the_sign_of_the_packets_summed_directions():
    rng = np.random.default_rng(61)
    n = 3 * bt.PACKET + 17  # a last, partial packet
    d = rng.standard_normal((n, 3)).astype(np.float32)
    got = bt.packet_octant(*_cols(d)).numpy()
    for p in range(4):
        part = d[p * bt.PACKET:(p + 1) * bt.PACKET].astype(np.float64).sum(0)
        want = (part[0] < 0) * 4 + (part[1] < 0) * 2 + (part[2] < 0)
        assert (got[p * bt.PACKET:(p + 1) * bt.PACKET] == want).all()


@pytest.mark.parametrize("kind", ["tri", "box", "sphere"])
def test_packet_order_finds_the_same_hits_as_the_per_ray_order(kind, monkeypatch):
    """Another node order changes no closest hit, only which of two equal
    ones wins (boxes' shared faces)."""
    _, tscene, name = _compiled(kind, monkeypatch)
    g = getattr(tscene.arrays, name)
    o, d, cap = base._rays(kind, 700, seed=71)
    ray = _plain(o, d, cap, g, name, kind, packet=False)
    pkt = _plain(o, d, cap, g, name, kind, packet=True)
    keep = (cap > 0) & ~((ray[0].numpy() > cap) | (pkt[0].numpy() > cap))  # within the cap
    assert np.array_equal(ray[0].numpy()[keep], pkt[0].numpy()[keep])
    if kind != "box":
        for a, b in zip(ray[1:], pkt[1:]):
            assert np.array_equal(a.numpy()[keep], b.numpy()[keep])


def test_wrapper_routes_and_refuses(monkeypatch):
    _, tscene, name = _compiled("tri", monkeypatch)
    g = tscene.arrays.triangles
    o, d, cap = base._rays("tri", 200, seed=81)
    args = (_cols(o), _cols(d), torch.from_numpy(cap), *_packed(g, name), TMIN, TMAX)
    cut = dict(cbb=g.pk_cbb, crange=g.pk_crange)
    ref = bt.bvh_traverse(*args, kind="tri", packet=True)
    # the switches of the JAX package, read at call time
    monkeypatch.setenv("RAYSNAIL_BVH_TWO_LEVEL", "1")
    monkeypatch.setenv("RAYSNAIL_BVH_STREAM_BYTES", "0")
    for a, b in zip(ref, bt.bvh_traverse(*args, kind="tri", **cut)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="needs the packet kernel"):
        bt.bvh_traverse(*args, kind="tri", packet=False, **cut)
    monkeypatch.delenv("RAYSNAIL_BVH_TWO_LEVEL")
    monkeypatch.delenv("RAYSNAIL_BVH_STREAM_BYTES")
    with pytest.raises(ValueError, match="crange"):
        bt.bvh_traverse(*args, kind="tri", two_level=True, cbb=g.pk_cbb,
                        crange=g.pk_crange.long())
    with pytest.raises(ValueError, match="pk_prim"):  # a Cramer block is not an mxu block
        bt.bvh_traverse(*args, kind="tri_mxu")
    # two_level asked for by name needs the cut; the environment's switch
    # applies where a group has one
    with pytest.raises(ValueError, match="needs the coarse cut"):
        bt.bvh_traverse(*args, kind="tri", two_level=True, cbb=g.pk_cbb)
    monkeypatch.setenv("RAYSNAIL_BVH_TWO_LEVEL", "1")
    for a, b in zip(ref, bt.bvh_traverse(*args, kind="tri", packet=False)):
        assert torch.equal(a, b)
    monkeypatch.delenv("RAYSNAIL_BVH_TWO_LEVEL")
    assert set(bt.bvh_traverse.launches) == set(bt.launch_keys())
    assert not any(bt.bvh_traverse.launches.values())  # CPU tensors launch nothing


def test_traversal_env_sets_the_switches_and_restores_them(monkeypatch):
    from raysnail_tpu_torch.utils import golden

    monkeypatch.setenv("RAYSNAIL_BVH_TWO_LEVEL", "1")
    monkeypatch.delenv("RAYSNAIL_BVH_STREAM_BYTES", raising=False)
    default = bt.stream_bytes()
    with golden.traversal_env(stream=True, two_level=False):
        assert bt.stream_bytes() == 0 and os.environ["RAYSNAIL_BVH_TWO_LEVEL"] == "0"
        with golden.traversal_env(stream=False):
            assert bt.stream_bytes() > 1 << 40
        assert bt.stream_bytes() == 0
    assert bt.stream_bytes() == default and "RAYSNAIL_BVH_STREAM_BYTES" not in os.environ
    assert os.environ["RAYSNAIL_BVH_TWO_LEVEL"] == "1"

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips where no CUDA card is present.
The file imports torch, numpy and the port only, so it runs on a machine
without JAX; tests/conftest.py imports JAX, so run it there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerance: none. The kernels are built with -fmad=false, so they round
every product and sum as their plain versions' separate elementwise kernels
do: the sphere sweep's t bit-equal and idx equal; the BVH traversal's t and
every attribute bit-equal, so the same winner on every ray, ties included.
That holds for both traversal kernels, and for the packet kernel in every
kind (tri, tri_mxu, box, sphere), with `stream` and `two_level` on and off;
and for the Mandelbulb march: t, valid, normal, u, v and the step and
iteration counts bit-equal; and for the rows' select: K7 equal to
index_select, K7b bit-equal to its plain version and to itself on a second
call, so a train step run twice gives the same bits.
"""

import numpy as np
import pytest
import torch

from raysnail_tpu_torch import ir
from raysnail_tpu_torch import scene as scene_mod
from raysnail_tpu_torch.ops import bvh_traverse as bt
from raysnail_tpu_torch.ops import sphere_min_t as smt
from raysnail_tpu_torch.scene import SceneBuilder
from raysnail_tpu_torch.scenes.meshes import torus_knot

TMIN, TMAX = 1e-3, 1e30


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda")


def sphere_case(seed, n_rays, n_spheres, device, duplicate=False):
    """Rays in a 30^3 box with unit directions, spheres in a 20^3 box, every
    5th sphere inactive; duplicate=True lists each sphere twice in a row, so
    that t ties exactly."""
    rng = np.random.default_rng(seed)
    m = n_spheres // 2 if duplicate else n_spheres
    c = rng.uniform(-10, 10, (m, 3)).astype(np.float32)
    r = rng.uniform(0.3, 1.5, m).astype(np.float32)
    act = np.ones(m, bool)
    act[::5] = False
    if duplicate:
        c, r, act = (np.repeat(a, 2, axis=0) for a in (c, r, act))
    o = rng.uniform(-15, 15, (n_rays, 3)).astype(np.float32)
    d = rng.standard_normal((n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    def cols(a):
        return tuple(torch.from_numpy(np.ascontiguousarray(a[:, i])).to(device)
                     for i in range(3))

    r2 = torch.from_numpy(r * r).to(device)
    return cols(o), cols(d), cols(c), r2, torch.from_numpy(act).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,dup", [(400_000, 4, False), (100_003, 478, False),
                                     (65_537, 256, True)],
                         ids=["example-S4", "book1-S478-ragged", "ties"])
def test_sphere_kernel_matches_plain(cuda_device, n, s, dup):
    args = sphere_case(1, n, s, cuda_device, dup)
    before = smt.sphere_min_t.launches
    t, idx = smt.sphere_min_t(*args, TMIN, TMAX)
    assert smt.sphere_min_t.launches == before + 1
    pt, pidx = smt.sphere_min_t_plain(*args, TMIN, TMAX)
    torch.cuda.synchronize()
    assert torch.equal(t, pt) and torch.equal(idx, pidx)
    hit = t < 1e30
    assert int(hit.sum()) > 0
    if dup:
        assert not bool((idx[hit] % 2 == 1).any())  # ties go to the first copy


def sphere_motion(seed, n, s, device, duplicate=False):
    """Speeds in [-2, 2)^3 and shutter times in [0, 1); duplicate=True gives
    the two copies of each sphere of sphere_case(duplicate=True) one speed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    m = s // 2 if duplicate else s
    speed = tuple((torch.rand(m, generator=gen, device=device) - 0.5) * 4.0 for _ in range(3))
    if duplicate:
        speed = tuple(a.repeat_interleave(2) for a in speed)
    return {"speed_xyz": speed, "time": torch.rand(n, generator=gen, device=device)}


@pytest.mark.cuda
@pytest.mark.parametrize("s", [0, 1, 255, 256, 257])
@pytest.mark.parametrize("n", [1, 31, 33, 257])
@pytest.mark.parametrize("moving", [False, True], ids=["static", "moving"])
def test_sphere_kernel_matches_plain_on_ragged_counts(cuda_device, moving, n, s):
    """Ray and sphere counts off the kernel's ray tile, warp and sphere tile."""
    args = sphere_case(n + s, n, s, cuda_device)
    motion = sphere_motion(n + s, n, s, cuda_device) if moving else {}
    t, idx = smt.sphere_min_t(*args, TMIN, TMAX, **motion)
    pt, pidx = smt.sphere_min_t_plain(*args, TMIN, TMAX, **motion)
    torch.cuda.synchronize()
    assert torch.equal(t, pt) and torch.equal(idx, pidx)


@pytest.mark.cuda
def test_sphere_kernel_checks_its_inputs(cuda_device):
    o, d, c, r2, act = sphere_case(2, 1000, 8, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        smt.sphere_min_t((o[0][::2], o[1][::2], o[2][::2]), d, c, r2, act, TMIN, TMAX)
    with pytest.raises(ValueError):
        smt.sphere_min_t(o, d, c, r2.cpu(), act, TMIN, TMAX)  # mixed devices
    with pytest.raises(ValueError):
        smt.sphere_min_t(o, d, c, r2, act.float(), TMIN, TMAX)


def bvh_case(kind, seed, n_rays, device, with_cut=False):
    """A packed group of the kind, compiled by the port on `device`, and
    rays: random origins and directions, a finite t_cap on a third of them,
    dead lanes (t_cap = -1) on a tenth. "tri_mxu" is the "tri" mesh in the
    feature-product format; with_cut=True appends the coarse cut (pk_cbb,
    pk_crange)."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    mat = ir.Lambertian(ir.Constant((0.5, 0.5, 0.5)))
    if kind in ("tri", "tri_mxu"):
        v, f, nrm = torus_knot(n_seg=200, n_ring=24)
        b.add(ir.Mesh(vertices=v, indices=f, normals=nrm, material=mat))
        group, prim, span = "triangles", "pk_tri", 3.0
    elif kind == "box":
        for i in range(12):
            for j in range(12):
                b.add(ir.Box((-6.0 + i, 0.0, -6.0 + j),
                             (-5.0 + i, 0.1 + 2.0 * rng.random(), -5.0 + j), mat))
        group, prim, span = "boxes", "pk_box", 8.0
    else:
        for c in rng.uniform(-20, 20, (8192, 3)):
            b.add(ir.Sphere(tuple(c), float(rng.uniform(0.2, 0.6)), mat))
        group, prim, span = "spheres", "pk_sph", 25.0
    solver = "mxu" if kind == "tri_mxu" else "cramer"
    g = getattr(b.compile(device=device, mesh_solver=solver).arrays, group)
    o = rng.uniform(-span, span, (n_rays, 3)).astype(np.float32)
    if kind == "box":  # a sixth start inside box (0, 0) of the grid
        o[: n_rays // 6] = rng.uniform(-5.9, -5.1, (n_rays // 6, 3))
        o[: n_rays // 6, 1] = rng.uniform(0.01, 0.09, n_rays // 6)
    d = rng.standard_normal((n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cap = np.full(n_rays, 1e30, np.float32)
    cap[: n_rays // 3] = rng.uniform(0.5, span, n_rays // 3)
    cap[n_rays // 3: n_rays // 3 + n_rays // 10] = -1.0

    def cols(a):
        return tuple(torch.from_numpy(np.ascontiguousarray(a[:, i])).to(device)
                     for i in range(3))

    return (cols(o), cols(d), torch.from_numpy(cap).to(device), g.pk_bb, g.pk_links,
            getattr(g, prim), *((g.pk_cbb, g.pk_crange) if with_cut else ()))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tri", "box", "sphere"])
def test_bvh_kernel_matches_plain(cuda_device, kind):
    args = bvh_case(kind, 3, 20_011, cuda_device)
    before = dict(bt.bvh_traverse.launches)
    out = bt.bvh_traverse(*args, TMIN, TMAX, kind=kind)
    after = dict(bt.bvh_traverse.launches)
    ref = bt.bvh_traverse_plain(*args, TMIN, TMAX, kind=kind)
    torch.cuda.synchronize()
    assert after[kind] == before[kind] + 1
    assert bt.bvh_traverse.launches == after  # the plain version launches nothing
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    t, cap = out[0], args[2]
    assert int((t < 1e30).sum()) > 1000
    assert bool((t[cap <= 0] == 1e30).all())


@pytest.mark.cuda
def test_bvh_kernel_checks_its_inputs(cuda_device):
    o, d, cap, bb, links, prim = bvh_case("sphere", 4, 1000, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        bt.bvh_traverse(tuple(a[::2] for a in o), d, cap, bb, links, prim, TMIN, TMAX,
                        kind="sphere")
    with pytest.raises(ValueError):
        bt.bvh_traverse(o, d, cap.double(), bb, links, prim, TMIN, TMAX, kind="sphere")
    with pytest.raises(ValueError):
        bt.bvh_traverse(o, d, cap, bb, links.cpu(), prim, TMIN, TMAX, kind="sphere")
    with pytest.raises(ValueError, match="pk_prim"):
        bt.bvh_traverse(o, d, cap, bb, links, prim, TMIN, TMAX, kind="tri")


@pytest.mark.cuda
@pytest.mark.parametrize("two_level", [False, True], ids=["one-level", "two-level"])
@pytest.mark.parametrize("stream", [False, True], ids=["resident", "stream"])
@pytest.mark.parametrize("kind", ["tri", "tri_mxu", "box", "sphere"])
def test_packet_kernel_matches_plain(cuda_device, kind, stream, two_level):
    *args, cbb, crange = bvh_case(kind, 5, 20_011, cuda_device, with_cut=True)
    key = bt.launch_key(kind, True, stream, two_level)
    before = bt.bvh_traverse.launches[key]
    out = bt.bvh_traverse(*args, TMIN, TMAX, kind=kind, packet=True, stream=stream,
                          two_level=two_level, cbb=cbb, crange=crange)
    assert bt.bvh_traverse.launches[key] == before + 1
    ref = bt.bvh_traverse_plain(*args, TMIN, TMAX, kind=kind, packet=True,
                                two_level=two_level, cbb=cbb, crange=crange)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    t, cap = out[0], args[2]
    assert int((t < 1e30).sum()) > 1000
    assert bool((t[cap <= 0] == 1e30).all())


def _routes():
    """Every kernel route: (kind, packet, stream, two_level)."""
    return ([(k, False, False, False) for k in ("tri", "box", "sphere")]
            + [(k, True, s, t) for k in ("tri", "tri_mxu", "box", "sphere")
               for s in (False, True) for t in (False, True)])


_cases = {}


def cached_case(kind, device):
    if kind not in _cases:
        _cases[kind] = bvh_case(kind, 9, 6_029, device, with_cut=True)
    return _cases[kind]


def shaped_rays(shape, args, device):
    """The rays of `args` cut or rearranged into one of the shapes that a
    warp-cooperative kernel can get wrong -> (origin, direction, t_cap)."""
    o, d, cap = (torch.stack(args[0], 1), torch.stack(args[1], 1), args[2].clone())
    lo, hi = args[3][0, 0, :3], args[3][0, 0, 3:6]
    if shape == "n1":
        o, d, cap = o[40:41], d[40:41], torch.full((1,), 1e30, device=device)
    elif shape == "n33":
        o, d, cap = o[:33], d[:33], cap[-33:]
    elif shape == "dead-warp":  # the second warp of the second block holds no live ray
        o, d = o[:300], d[:300]
        cap = cap[-300:].clone()
        cap[160:192] = -1.0
    elif shape == "one-fills":
        # per warp one ray along the scene's long diagonal, which admits leaf
        # after leaf, and 31 rays that start outside and point away
        n = 256
        o = (hi + 1.0).repeat(n, 1)
        d = torch.ones(n, 3, device=device) / 3 ** 0.5
        cap = torch.full((n,), 1e30, device=device)
        for lane in range(5, n, 32):
            o[lane] = lo - 0.5
            d[lane] = (hi - lo) / (hi - lo).norm()
    elif shape == "shuffled":  # coherent rays from one point, in a random order
        gen = torch.Generator(device=device).manual_seed(3)
        n = 4_099
        eye = hi + (hi - lo)
        target = lo + torch.rand(n, 3, generator=gen, device=device) * (hi - lo)
        d = target - eye
        d = d / d.norm(dim=1, keepdim=True)
        perm = torch.randperm(n, generator=gen, device=device)
        o, d = eye.repeat(n, 1), d[perm]
        cap = torch.full((n,), 1e30, device=device)
    else:
        raise ValueError(shape)
    return (tuple(o[:, i].contiguous() for i in range(3)),
            tuple(d[:, i].contiguous() for i in range(3)), cap.contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["n1", "n33", "dead-warp", "one-fills", "shuffled"])
@pytest.mark.parametrize("route", _routes(), ids=lambda r: bt.launch_key(*r))
def test_kernels_match_plain_on_awkward_warps(cuda_device, route, shape):
    """One ray, a partial second warp, a warp of dead rays, a warp in which
    one ray defers leaf after leaf while 31 miss, and incoherent rays: every
    kind and mode bit-equal to the plain version."""
    kind, packet, stream, two_level = route
    *args, cbb, crange = cached_case(kind, cuda_device)
    rays = shaped_rays(shape, args, cuda_device)
    call = dict(kind=kind, packet=packet, two_level=two_level, cbb=cbb, crange=crange)
    out = bt.bvh_traverse(*rays, *args[3:], TMIN, TMAX, stream=stream, **call)
    stats = {}
    ref = bt.bvh_traverse_plain(*rays, *args[3:], TMIN, TMAX, stats=stats, **call)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert bool((out[0][rays[2] <= 0] == 1e30).all())
    if shape == "one-fills":  # only the eight long rays can hit
        assert stats["sweeps"] >= 1 and int((out[0] < 1e30).sum()) <= 8
    if shape == "shuffled":
        assert int((out[0] < 1e30).sum()) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("two_level", [False, True], ids=["one-level", "two-level"])
@pytest.mark.parametrize("stream", [False, True], ids=["resident", "stream"])
@pytest.mark.parametrize("kind", ["tri", "tri_mxu"])
def test_packet_kernel_matches_plain_on_a_single_order_tree(cuda_device, kind, stream,
                                                            two_level, monkeypatch):
    """Above the node cap a tree keeps one node order (K = 1), walked in
    build order by every packet."""
    monkeypatch.setattr(scene_mod, "OCTANT_CAP", 50)
    *args, cbb, crange = bvh_case(kind, 8, 10_007, cuda_device, with_cut=True)
    assert args[3].shape[0] == 1 and args[3].shape[1] > 50
    out = bt.bvh_traverse(*args, TMIN, TMAX, kind=kind, packet=True, stream=stream,
                          two_level=two_level, cbb=cbb, crange=crange)
    ref = bt.bvh_traverse_plain(*args, TMIN, TMAX, kind=kind, packet=True,
                                two_level=two_level, cbb=cbb, crange=crange)
    torch.cuda.synchronize()
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert int((out[0] < 1e30).sum()) > 500


@pytest.mark.cuda
def test_packet_kernel_is_picked_when_a_mode_needs_it(cuda_device):
    *args, cbb, crange = bvh_case("tri", 7, 5_000, cuda_device, with_cut=True)
    before = dict(bt.bvh_traverse.launches)
    bt.bvh_traverse(*args, TMIN, TMAX, kind="tri")                      # the per-ray kernel
    bt.bvh_traverse(*args, TMIN, TMAX, kind="tri", stream=True)         # needs the packet kernel
    bt.bvh_traverse(*args, TMIN, TMAX, kind="tri", two_level=True, cbb=cbb, crange=crange)
    grew = {k for k, v in bt.bvh_traverse.launches.items() if v == before[k] + 1}
    assert grew == {"tri", "packet/tri+stream", "packet/tri+two_level"}
    with pytest.raises(ValueError, match="needs the packet kernel"):
        bt.bvh_traverse(*args, TMIN, TMAX, kind="tri", stream=True, packet=False)
    with pytest.raises(ValueError, match="needs the coarse cut"):
        bt.bvh_traverse(*args, TMIN, TMAX, kind="tri", two_level=True)


# -- the sphere sweep's moving form -------------------------------------------------

@pytest.mark.cuda
def test_moving_sphere_kernel_ties_go_to_the_first_index(cuda_device):
    args = sphere_case(4, 65_537, 256, cuda_device, duplicate=True)
    motion = sphere_motion(6, 65_537, 256, cuda_device, duplicate=True)
    t, idx = smt.sphere_min_t(*args, TMIN, TMAX, **motion)
    pt, pidx = smt.sphere_min_t_plain(*args, TMIN, TMAX, **motion)
    torch.cuda.synchronize()
    assert torch.equal(t, pt) and torch.equal(idx, pidx)
    hit = t < 1e30
    assert int(hit.sum()) > 0 and not bool((idx[hit] % 2 == 1).any())


@pytest.mark.cuda
@pytest.mark.parametrize("n,s", [(800 * 500, 478), (100_003, 7), (65_537, 600)],
                         ids=["book1-frame", "ragged-S7", "three-tiles"])
def test_moving_sphere_kernel_matches_plain(cuda_device, n, s):
    """Centers move by speed * the ray's time: t bit-equal and idx equal to
    the plain version; zero speeds give the static form's result."""
    args = sphere_case(3, n, s, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    speed = tuple((torch.rand(s, generator=gen, device=cuda_device) - 0.5) * 4.0
                  for _ in range(3))
    time = torch.rand(n, generator=gen, device=cuda_device)
    before = (smt.sphere_min_t.launches, smt.sphere_min_t.moving_launches)
    t, idx = smt.sphere_min_t(*args, TMIN, TMAX, speed_xyz=speed, time=time)
    assert (smt.sphere_min_t.launches, smt.sphere_min_t.moving_launches) == (before[0] + 1,
                                                                             before[1] + 1)
    pt, pidx = smt.sphere_min_t_plain(*args, TMIN, TMAX, speed_xyz=speed, time=time)
    torch.cuda.synchronize()
    assert torch.equal(t, pt) and torch.equal(idx, pidx)
    static_t, static_idx = smt.sphere_min_t(*args, TMIN, TMAX)
    assert smt.sphere_min_t.moving_launches == before[1] + 1   # the static instantiation
    hit = (static_t < 1e30) | (t < 1e30)
    assert int(hit.sum()) > 0 and float((static_t != t)[hit].float().mean()) > 0.9  # it moves
    zero = tuple(torch.zeros_like(c) for c in speed)
    zt, zidx = smt.sphere_min_t(*args, TMIN, TMAX, speed_xyz=zero, time=time)
    assert torch.equal(zt, static_t) and torch.equal(zidx, static_idx)
    with pytest.raises(ValueError, match="contiguous"):
        smt.sphere_min_t(*args, TMIN, TMAX, speed_xyz=speed, time=time[::2])


# -- the traversal probes -------------------------------------------------------------

@pytest.fixture(scope="module")
def probe_case():
    """The probes' own case on the card: the 9,600-triangle knot under
    320x200 primary rays in tile order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    from raysnail_tpu_torch import probes
    return probes.build_case("knot-9600", "cuda")


def _probe_calls():
    from raysnail_tpu_torch.ops import bvh_probes as bp
    calls = {}
    for layout in bp.IO_LAYOUTS:
        calls[f"io/{layout}"] = (
            lambda c, layout=layout: bp.probe_io(c.o, c.d, layout),
            lambda c: bp.probe_io_plain(c.o, c.d))
    for shape in bp.SHAPES:
        calls[f"walk/{shape}"] = (
            lambda c, s=shape: bp.probe_walk(c.o, c.d, c.tri.pk_bb, c.tri.pk_links, s),
            lambda c, s=shape: bp.probe_walk_plain(c.o, c.d, c.tri.pk_bb, c.tri.pk_links, s))
        calls[f"sweep/{shape}"] = (
            lambda c, s=shape: bp.probe_sweep(c.o, c.d, c.tri.pk_tri, s, 16),
            lambda c: bp.probe_sweep_plain(c.o, c.d, c.tri.pk_tri, 16))
        for v in bp.VARIANTS:
            calls[f"variant/V{v}/{shape}"] = (
                lambda c, v=v, s=shape: bp.probe_walk_variant(
                    v, c.o, c.d, c.tri.pk_bb, c.tri.pk_links, c.tri.pk_tri, s),
                lambda c, v=v, s=shape: bp.probe_walk_variant_plain(
                    v, c.o, c.d, c.tri.pk_bb, c.tri.pk_links, c.tri.pk_tri, s))
    for variant in bp.LATENCY_VARIANTS:
        calls[f"latency/{variant}"] = (
            lambda c, v=variant: bp.probe_walk_latency(c.o, c.d, c.tri.pk_bb, c.tri.pk_links,
                                                       v, reps=3),
            lambda c, v=variant: bp.probe_walk_latency_plain(c.o, c.d, c.tri.pk_bb,
                                                             c.tri.pk_links, v))
    return calls


PROBE_KEYS = ([f"io/{x}" for x in ("soa", "rows", "transpose", "packed")]
              + [f"{f}/{s}" for f in ("walk", "sweep") for s in ("ray", "packet")]
              + [f"latency/{x}" for x in ("w32", "w128", "w1024", "cap", "buf")]
              + [f"variant/V{v}/{s}" for v in (0, 1, 2, 3, 4, 5, 7, 8) for s in ("ray", "packet")])


@pytest.mark.cuda
@pytest.mark.parametrize("key", PROBE_KEYS)
def test_probe_kernel_matches_plain(probe_case, key):
    """Every output of every probe, integers and floats, bit-equal to its
    plain version; the launch count moves by the launches made."""
    from raysnail_tpu_torch import probes
    from raysnail_tpu_torch.ops import bvh_probes as bp
    assert PROBE_KEYS == bp.launch_keys()
    kernel, plain = _probe_calls()[key]
    before = bp.launches[key]
    got = kernel(probe_case)
    torch.cuda.synchronize()
    assert bp.launches[key] == before + (3 if key.startswith("latency/") else 1)
    res = probes.compare(key, got, plain(probe_case))
    assert res["bit_equal"], res


@pytest.mark.cuda
def test_probe_kernels_mask_a_ragged_last_packet(probe_case):
    """63,937 rays: the last packet of every width is partial."""
    from raysnail_tpu_torch import probes
    from raysnail_tpu_torch.ops import bvh_probes as bp
    n = probe_case.n - 63
    cut = probes.Case("ragged", tuple(a[:n].contiguous() for a in probe_case.o),
                      tuple(a[:n].contiguous() for a in probe_case.d), probe_case.tri, 16)
    calls = _probe_calls()
    for key in ("io/rows", "io/transpose", "io/packed", "walk/packet", "latency/w32",
                "latency/w1024", "latency/buf", "variant/V8/packet", "variant/V8/ray"):
        kernel, plain = calls[key]
        assert probes.compare(key, kernel(cut), plain(cut))["bit_equal"], key
    with pytest.raises(ValueError, match="contiguous"):
        bp.probe_io(tuple(a[::2] for a in cut.o), tuple(a[::2] for a in cut.d))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["quadric.sdl", "csg.sdl"])
def test_csg_anchor_holds_on_the_card(cuda_device, name):
    from raysnail_tpu_torch.utils import golden

    golden.check_anchor(name, golden.load_golden(), "cuda")


@pytest.mark.cuda
def test_book2_launches_the_box_kernel_and_the_moving_sphere_form(cuda_device):
    """book 2 on the card: its 400 ground boxes go through the traversal
    kernel's box kind and its moving sphere through K1's moving form, on
    every shade iteration; its anchor's mean holds (its thumbnail pins one
    compiler's rounding, tests/test_torch_media.py)."""
    from raysnail_tpu_torch.render import make_frame_step
    from raysnail_tpu_torch.utils import golden

    scene, camera, cfg, seed = golden.golden_configs("cuda")["book2"]()
    smt.sphere_min_t.launches = smt.sphere_min_t.moving_launches = 0
    bt.bvh_traverse.launches = {k: 0 for k in bt.bvh_traverse.launches}
    _, iterations = make_frame_step(scene, cfg)(scene.arrays, camera, seed)
    assert iterations > 0
    assert bt.bvh_traverse.launches["box"] >= iterations
    assert smt.sphere_min_t.moving_launches >= iterations
    res = golden.anchor_drift("book2", golden.load_golden(), "cuda")
    assert res["dmean"] <= golden.MEAN_ATOL, res


def bulb_rays(seed, n, device, inside=False):
    """Seeded rays for the Mandelbulb march: from a shell of radius 2-4 aimed
    at points near the bulb, or (inside=True) from points inside the
    bounding sphere in random directions; a quarter of the lanes dead."""
    rng = np.random.default_rng(seed)
    if inside:
        o = rng.uniform(-1.2, 1.2, (n, 3))
        d = rng.standard_normal((n, 3))
    else:
        o = rng.standard_normal((n, 3))
        o *= rng.uniform(2.0, 4.0, (n, 1)) / np.linalg.norm(o, axis=1, keepdims=True)
        d = rng.uniform(-0.8, 0.8, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    active = rng.random(n) >= 0.25

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return dev(o.T.astype(np.float32)), dev(d.T.astype(np.float32)), dev(active)


@pytest.mark.cuda
@pytest.mark.parametrize("n,inside", [(1, False), (33, False), (100_003, False),
                                      (65_536, True), (600_000, False)],
                         ids=["one", "ragged-33", "shell-100003", "inside-65536",
                              "shell-600000"])
def test_mandelbulb_march_matches_plain(cuda_device, n, inside):
    """K6 against its plain version on the card, bit for bit in t, valid,
    normal, u, v and in the step and iteration counts, with dead lanes; at
    600,000 rays more threads than the card holds at once."""
    from raysnail_tpu_torch.ops import mandelbulb_march as mm

    o, d, active = bulb_rays(11, n, cuda_device, inside)
    for act in (active, None):
        before = mm.mandelbulb_march.launches
        got = mm.mandelbulb_march(o, d, TMIN, TMAX, act, stats=True)
        assert mm.mandelbulb_march.launches == before + 1
        want = mm.mandelbulb_march_plain(o, d, TMIN, TMAX, act, stats=True)
        torch.cuda.synchronize()
        for name, a, b in zip(("t", "valid", "normal", "u", "v", "counts"), got, want):
            assert torch.equal(a, b), name
        if act is not None:
            assert not bool(got[1][~act].any())
    if n > 1000:
        assert int(got[1].sum()) > n // 20


@pytest.mark.cuda
def test_mandelbulb_anchor_holds_on_the_card(cuda_device):
    """The anchor renders through K6: one launch per shade iteration of the
    sample-step path."""
    from raysnail_tpu_torch.ops import mandelbulb_march as mm
    from raysnail_tpu_torch.utils import golden

    mm.mandelbulb_march.launches = 0
    golden.check_anchor("mandelbulb", golden.load_golden(), "cuda")
    assert mm.mandelbulb_march.launches > 0


def _division_calls(name, device, monkeypatch):
    """Run one function that divides by a constant on seeded inputs on
    `device`, recording each call of `div_const` in the module that makes
    it -> [(dividend, constant, quotient)], tensors moved to the CPU."""
    from raysnail_tpu_torch import lights, materials
    from raysnail_tpu_torch.geometry import spheres
    from raysnail_tpu_torch.prelude import vec as vec_mod
    from raysnail_tpu_torch.prelude.vec import Vec3

    calls = []
    rng = np.random.default_rng(17)
    n = 100_003
    div_const = vec_mod.div_const

    def recording(a, c):
        q = div_const(a, c)
        calls.append((a.cpu(), c, q.cpu()))
        return q

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    def vec(a):
        return Vec3(*(dev(a[:, i]) for i in range(3)))

    module = {"sphere_uv": spheres, "lobe": materials, "light_pdf": lights,
              "vec_div": vec_mod}[name]
    monkeypatch.setattr(module, "div_const", recording)
    if name == "sphere_uv":
        spheres.sphere_uv(vec(rng.standard_normal((n, 3))))
    elif name == "lobe":
        materials._lobe(dev(rng.uniform(1.0, 500.0, n)), dev(rng.uniform(0.0, 1.0, n)))
    elif name == "light_pdf":
        kind = torch.from_numpy(np.asarray([lights.SPHERE, lights.RECT_XZ, lights.SPHERE],
                                           np.int32)).to(device)
        table = lights.LightArrays(
            kind=kind, center=vec(np.asarray([[300, 400, 100], [0, 0, 0], [0, 8, -2]])),
            radius=dev([12, 0, 1.5]), k=dev([0, 5, 0]), a0=dev([0, -1, 0]),
            a1=dev([0, 2, 0]), b0=dev([0, -3, 0]), b1=dev([0, 1, 0]))
        origin = vec(rng.uniform(-3, 3, (n, 3)))
        kinds = frozenset({lights.SPHERE, lights.RECT_XZ})
        d = lights.sample_proper(table, origin, *(dev(x) for x in rng.random((3, n))), kinds)
        lights.pdf_value(table, origin, d.unit(), kinds)
    else:
        v = vec(rng.standard_normal((n, 3)))
        for c in (3.0, 7):
            v / c
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("name,n_calls", [("sphere_uv", 2), ("lobe", 1), ("light_pdf", 1),
                                          ("vec_div", 6)])
def test_divisions_by_constants_round_as_on_the_cpu(cuda_device, monkeypatch, name, n_calls):
    """Each division of the render path by a Python constant goes through
    prelude.vec.div_const, whose quotient on the card is the CPU's quotient
    of the same dividend bit for bit; the same division by a Python number
    on the card multiplies by the reciprocal and moves some quotients by an
    ulp. The functions' whole results can differ between the two devices
    all the same: the CPU's torch.sqrt is not always correctly rounded (an
    ulp off numpy's on some float32 inputs) and atan2, asin and pow round
    otherwise on the card, so each division is held on its own dividend."""
    calls = _division_calls(name, cuda_device, monkeypatch)
    assert len(calls) == n_calls
    moved = 0
    for a, c, q in calls:
        assert torch.equal(q, a / c), (c, int((q != a / c).sum()))
        moved += int(((a.to(cuda_device) / c).cpu() != a / c).sum())
    assert moved > 0


@pytest.mark.cuda
def test_mandelbulb_march_edge_cases_and_the_callers_stream(cuda_device):
    """Calls back to back, rays along the axes, every lane dead, N = 0,
    N = 1 and a call on a stream of its own; bit for bit against the plain
    version each time."""
    from raysnail_tpu_torch.ops import mandelbulb_march as mm

    def check(o, d, act, stream=None):
        with torch.cuda.stream(stream):
            got = mm.mandelbulb_march(o, d, TMIN, TMAX, act, stats=True)
            want = mm.mandelbulb_march_plain(o, d, TMIN, TMAX, act, stats=True)
        torch.cuda.synchronize()
        for name, a, b in zip(("t", "valid", "normal", "u", "v", "counts"), got, want):
            assert torch.equal(a, b), name
        return got

    o, d, active = bulb_rays(23, 4_099, cuda_device)
    for _ in range(3):
        check(o, d, active)
    # rays along the axes and a hair off them: the DE meets rho^2 = 0 and
    # tiny and denormal rho^2 (the square root's scaled branch)
    axes = []
    for axis in range(3):
        for sign in (1.0, -1.0):
            for off in (0.0, 1e-20, 1e-30, 1e-39, -1e-25):
                p = [off, 0.0, 0.0] if axis != 0 else [0.0, off, 0.0]
                p[axis] = 3.0 * sign
                axes.append(p)
    ao = torch.tensor(axes, device=cuda_device).T.contiguous()
    ad = (-ao / ao.norm(dim=0, keepdim=True)).contiguous()
    assert int(check(ao, ad, None)[1].sum()) > 0
    assert not bool(check(o, d, torch.zeros_like(active))[1].any())
    check(o[:, :1].contiguous(), d[:, :1].contiguous(), None)
    empty = torch.empty((3, 0), device=cuda_device)
    assert check(empty, empty, None)[0].shape == (0,)
    check(o, d, active, torch.cuda.Stream())
    check(o, d, active)


# -- K1b, the backward of the sphere sweep, and the gradient step ------------

def bwd_case(seed, n, s, device, moving=False):
    """K1's inputs and outputs on `n` rays (origins in a 30^3 box, so some
    start inside a sphere and take the far root; most miss: dead lanes) and
    a seeded cotangent."""
    o, d, c, r2, act = sphere_case(seed, n, s, device)
    motion = sphere_motion(seed, n, s, device) if moving else {}
    t, idx = smt.sphere_min_t_plain(o, d, c, r2, act, TMIN, 40.0, **motion)
    g = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(n).astype(np.float32))
    return (o, d, t, idx, g.to(device), c, r2, TMIN, 40.0), motion


@pytest.mark.cuda
@pytest.mark.parametrize("moving", [False, True])
@pytest.mark.parametrize("n,s", [(0, 8), (1, 8), (33, 8), (100_003, 478), (4099, 0)])
def test_sphere_bwd_kernel_matches_plain(cuda_device, moving, n, s):
    args, motion = bwd_case(n + s + 5, n, s, cuda_device, moving)
    before = (smt.sphere_min_t_bwd.launches, smt.sphere_min_t_bwd.moving_launches)
    g_o, g_d = smt.sphere_min_t_bwd(*args, **motion)
    assert smt.sphere_min_t_bwd.launches == before[0] + 1
    assert smt.sphere_min_t_bwd.moving_launches == before[1] + moving
    p_o, p_d = smt.sphere_min_t_bwd_plain(*args, **motion)
    torch.cuda.synchronize()
    for a, b in zip((*g_o, *g_d), (*p_o, *p_d)):
        assert a.shape == (n,) and torch.equal(a, b)
    if n > 1000 and s > 0:
        hit = args[2] < smt.BIG
        assert 0 < int(hit.sum()) < n and bool((g_o[0][~hit] == 0).all())


@pytest.mark.cuda
def test_sphere_function_backward_launches_k1b(cuda_device):
    """On CUDA tensors SphereMinT's backward is the kernel: its launch count
    moves by one a backward pass, and the gradient equals the plain one."""
    o, d, c, r2, act = sphere_case(9, 5000, 40, cuda_device)
    xs = [a.clone().requires_grad_(True) for a in (*o, *d)]
    t, idx = smt.SphereMinT.apply(*xs, *c, r2, act, TMIN, 40.0, None, None, None, None)
    g = torch.linspace(-1, 1, 5000, device=cuda_device)
    before = smt.sphere_min_t_bwd.launches
    (t * g).sum().backward()
    assert smt.sphere_min_t_bwd.launches == before + 1
    p_o, p_d = smt.sphere_min_t_bwd_plain(o, d, t.detach(), idx, g, c, r2, TMIN, 40.0)
    for x, want in zip(xs, (*p_o, *p_d)):
        assert torch.equal(x.grad, want)


def _grad_step(scene, cam, cfg, weights=None):
    from raysnail_tpu_torch.diff import extract_params
    from raysnail_tpu_torch.diff.params import leaves
    from raysnail_tpu_torch.diff.train import render_image_diff

    p = extract_params(scene.arrays)
    img = render_image_diff(scene, cam, cfg, p, 0, np.arange(cfg.effective_samples))
    s = img.x + img.y + img.z
    if weights is not None:
        s = s * torch.as_tensor(weights, device=s.device)
    torch.mean(s).backward()
    return (img.to_array().detach().cpu().numpy(),
            [x.grad.cpu().numpy() if x.grad is not None else np.zeros(x.shape)
             for x in leaves(p)])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["example.sdl", "metal"])
def test_gradient_on_the_card_matches_the_cpu(cuda_device, name):
    """render_image_diff's gradient (the mean of R + G + B) at 32x20@4spp,
    depth 4, on the card against the CPU: each leaf within
    1e-3 * max|g_cpu| + 1e-6 (the rows' sums take one order on both, K7b's,
    but the card rounds some of the render's functions otherwise); pixels
    whose radiance differs beyond 1e-4 (a path flipped
    by an ulp) are left out of the scalar on both sides, at most 1%. The
    metal scene (a DiffuseMetal and a BlinnPhong sphere) sends its bounce
    rays' t through K1b."""
    import os

    from raysnail_tpu_torch.camera import build_camera
    from raysnail_tpu_torch.config import RenderConfig
    from raysnail_tpu_torch.sdl.driver import build_scene

    cfg = RenderConfig(width=32, height=20, samples=4, max_depth=4)
    if name == "example.sdl":
        path = os.path.join(os.path.dirname(os.path.dirname(__file__)), "sdl", "example.sdl")
        made = {dev: build_scene(path, cfg, dev) for dev in ("cpu", cuda_device)}
    else:
        made = {dev: (metal_scene(dev), build_camera(look_from=(0, 0, 1), look_at=(0, 0, -1),
                                                     fov=50, width=32, height=20, device=dev))
                for dev in ("cpu", cuda_device)}
    before = smt.sphere_min_t_bwd.launches
    img_c, g_c = _grad_step(*made["cpu"], cfg)
    img_g, g_g = _grad_step(*made[cuda_device], cfg)
    launched = smt.sphere_min_t_bwd.launches - before
    assert launched > 0 if name == "metal" else launched == 0
    d = np.abs(img_g - img_c).max(axis=1)
    flipped = d > 1e-4
    assert flipped.mean() <= 0.01, np.flatnonzero(flipped)
    if flipped.any():
        w = (~flipped).astype(np.float32)
        _, g_c = _grad_step(*made["cpu"], cfg, w)
        _, g_g = _grad_step(*made[cuda_device], cfg, w)
    for i, (a, b) in enumerate(zip(g_g, g_c)):
        assert np.isfinite(a).all() and np.isfinite(b).all(), i
        assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max() + 1e-6, (i, np.abs(a - b).max())


def metal_scene(device):
    """tests/test_torch_diff.py's metal scene: ground, a DiffuseMetal sphere,
    a BlinnPhong sphere, a sphere light."""
    b = SceneBuilder()
    b.add(ir.Sphere((0.0, -100.5, -1.0), 100.0, ir.Lambertian(ir.Constant((0.5, 0.5, 0.5)))))
    b.add(ir.Sphere((0.0, 0.0, -1.0), 0.5, ir.DiffuseMetal(30.0, ir.Constant((0.6, 0.3, 0.2)))))
    b.add(ir.Sphere((-1.0, 0.0, -1.5), 0.4, ir.BlinnPhong(0.4, 20.0, ir.Constant((0.2, 0.6, 0.3)))))
    b.add(ir.Sphere((2.0, 2.0, 0.0), 0.7, ir.DiffuseLight(ir.Constant((1.0, 1.0, 1.0)), 4.0)),
          light=True)
    b.set_background((0.1, 0.1, 0.1))
    return b.compile(device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,k", [(7, 400_000, 4), (6, 400_000, 3), (6, 400_000, 6),
                                      (481, 400_000, 4), (1024, 100_003, 6),
                                      (4096, 400_000, 6), (1, 1, 1), (5, 0, 3), (3, 2049, 8)])
def test_rows_select_kernels_match_plain(cuda_device, rows, n, k):
    """K7 equals index_select; K7b is bit-equal to its plain version and
    gives the same bits on two calls (no atomics); a NaN cotangent stays in
    its row on both."""
    from raysnail_tpu_torch.ops import rows_select as rs

    rng = np.random.default_rng(rows + n + k)
    table = torch.from_numpy(rng.standard_normal((rows, k)).astype(np.float32)).to(cuda_device)
    idx = torch.from_numpy(np.sort(rng.integers(0, rows, n))).to(cuda_device)
    g = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(cuda_device)
    if n > 100:
        g[50, 0] = float("nan")
    before = (rs.rows_select.launches, rs.rows_select_bwd.launches)
    out = rs.rows_select(table.unbind(1), idx).t()  # strided columns
    grads = [torch.stack(rs.rows_select_bwd(g.unbind(1), idx, rows), 1) for _ in range(2)]
    launched = n > 0
    assert (rs.rows_select.launches, rs.rows_select_bwd.launches) == (
        before[0] + launched, before[1] + 2 * launched)
    want = rs.rows_select_bwd_plain(g, idx, rows)
    torch.cuda.synchronize()
    assert out.shape == (n, k) and torch.equal(out, torch.index_select(table, 0, idx))
    for got in grads:
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.nan_to_num(got, nan=7.0), torch.nan_to_num(want, nan=7.0))
    if n > 100:
        assert int(torch.isnan(want).sum()) == 1 and bool(torch.isnan(want[idx[50], 0]))
    # contiguous cotangent columns read the same values as strided ones
    gc = [c.contiguous() for c in g.unbind(1)]
    assert torch.equal(torch.nan_to_num(torch.stack(rs.rows_select_bwd(gc, idx, rows), 1),
                                        nan=7.0), torch.nan_to_num(want, nan=7.0))


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["shuffled", "many"])
@pytest.mark.parametrize("rows,k", [(8, 4), (10, 6), (455, 4), (1024, 4)])
def test_rows_select_bwd_matches_plain_on_shuffled_and_many_row_segments(cuda_device, order,
                                                                          rows, k):
    """K7b bit-equal to its plain version where a segment holds many rows:
    a random permutation of sorted runs (the regen-shuffle integrator's
    bounce rays), and segments of 8 or more rows each; both routes (one
    launch at R x K <= 64, a second launch above) and the row tiles."""
    from raysnail_tpu_torch.ops import rows_select as rs

    n = 300_017
    rng = np.random.default_rng(rows * k)
    idx = rng.permutation(np.sort(rng.integers(0, rows, n)))
    if order == "many":
        seg = idx[: n - n % 32].reshape(-1, 32)
        seg[:] = np.repeat(rng.permuted(np.tile(np.arange(rows), (len(seg), 1)),
                                        axis=1)[:, :8], 4, axis=1)
    idx = torch.from_numpy(idx).to(cuda_device)
    g = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).to(cuda_device)
    got = [torch.stack(rs.rows_select_bwd(g.unbind(1), idx, rows), 1) for _ in range(2)]
    want = rs.rows_select_bwd_plain(g, idx, rows)
    torch.cuda.synchronize()
    assert all(torch.equal(x.view(torch.int32), want.view(torch.int32)) for x in got)


@pytest.mark.cuda
def test_rows_select_bwd_on_two_streams(cuda_device):
    """K7b launched on two streams at once (each stream its own ticket
    counter) gives each launch its plain version's bits."""
    from raysnail_tpu_torch.ops import rows_select as rs

    rng = np.random.default_rng(5)
    n, rows = 400_000, 8
    cases = []
    for _ in range(2):
        idx = torch.from_numpy(rng.permutation(np.sort(rng.integers(0, rows, n))))
        g = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32))
        cases.append((idx.to(cuda_device), g.to(cuda_device)))
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = [[], []]
    for _ in range(20):
        for j, st in enumerate(streams):
            with torch.cuda.stream(st):
                got[j].append(torch.stack(rs.rows_select_bwd(cases[j][1].unbind(1),
                                                             cases[j][0], rows), 1))
    torch.cuda.synchronize()
    for (idx, g), outs in zip(cases, got):
        want = rs.rows_select_bwd_plain(g, idx, rows)
        assert all(torch.equal(x, want) for x in outs)


@pytest.mark.cuda
def test_rows_select_function_launches_k7_and_k7b(cuda_device):
    from raysnail_tpu_torch.ops import rows_select as rs
    from raysnail_tpu_torch.prelude.vec import take_rows

    rng = np.random.default_rng(3)
    cols = [torch.from_numpy(rng.standard_normal(9).astype(np.float32)).to(cuda_device)
            .requires_grad_(True) for _ in range(4)]
    idx = torch.from_numpy(rng.integers(0, 9, 70_001)).to(cuda_device)
    before = (rs.rows_select.launches, rs.rows_select_bwd.launches)
    out = take_rows(cols, idx)
    assert all(o.is_contiguous() for o in out)
    sum(((j + 1) * o).sum() for j, o in enumerate(out)).backward()
    assert (rs.rows_select.launches, rs.rows_select_bwd.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    g = torch.stack([torch.full_like(out[0], float(j + 1)) for j in range(4)], dim=1)
    want = rs.rows_select_bwd_plain(g, idx, 9)
    assert all(torch.equal(c.grad, want[:, j]) for j, c in enumerate(cols))
    # an output with no gradient: K7b reads its column as zeros
    for c in cols:
        c.grad = None
    out = take_rows(cols, idx)
    (3 * out[2]).sum().backward()
    assert torch.equal(cols[2].grad, want[:, 2]) and all(
        not cols[j].grad.any() for j in (0, 1, 3))


@pytest.mark.cuda
def test_train_step_repeats_bit_for_bit(cuda_device):
    """The metal scene's train step, twice on the same inputs: the same bits
    in every leaf (NaN traps compared as bit patterns)."""
    from raysnail_tpu_torch.camera import build_camera
    from raysnail_tpu_torch.config import RenderConfig
    from raysnail_tpu_torch.diff import make_train_step
    from raysnail_tpu_torch.diff.params import leaves

    cfg = RenderConfig(width=64, height=40, samples=4, max_depth=4)
    scene = metal_scene(cuda_device)
    cam = build_camera(look_from=(0, 0, 1), look_at=(0, 0, -1), fov=50, width=64, height=40,
                       device=cuda_device)
    target = np.zeros((40, 64, 3), np.float32)
    runs = []
    for _ in range(2):
        step, state, p0 = make_train_step(scene, cam, cfg, target)
        p1, _, loss = step(p0, state, 1, np.arange(cfg.effective_samples))
        runs.append([x.detach().view(torch.int32).clone() for x in leaves(p1)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))

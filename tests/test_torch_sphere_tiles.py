"""The order of work of the ray x sphere kernel (`csrc/sphere_min_t.cu`),
held on the CPU.

The kernel runs only on a card. Its design reorders the dense sweep: a
thread holds RAYS rays (ray r of thread t of block b is ray
b * THREADS * RAYS + r * THREADS + t), the block stages the spheres TILE at
a time with an inactive sphere's r2 set to -inf, and a (ray, sphere) pair
takes the square root, the two roots and their range tests only when some
ray of its thread has delta > 0 and its own delta > 0.
The claim is that none of this shows in a result: t and idx equal
`sphere_min_t_plain`'s bit for bit, ties to the first index, in both forms.

This file holds that claim with a plain-torch model of the kernel's loops
(`tiled_min_t`), whose every float operation is the plain version's
operation on the same float32 values. Tolerance against the plain version:
none (torch.equal). Against the JAX package (`spheres.pair_t` and argmin
for both forms, the Pallas kernel in interpret mode for the static form)
the tolerances of tests/test_torch_sphere_kernel.py, for the reasons given
there: torch's and XLA's CPU results can differ by an ulp, which the
cancellation in t = -half_b - sqrt(delta) can magnify.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raysnail_tpu.geometry import spheres as jsph
from raysnail_tpu.prelude.vec import Vec3 as JVec3
from raysnail_tpu_torch.ops import sphere_min_t as smt
from test_torch_sphere_kernel import assert_close_t, jax_pallas, make_case, torch_args

TMIN, TMAX = 1e-3, 1e30
BIG = np.float32(1e30)
SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "raysnail_tpu_torch", "csrc", "sphere_min_t.cu")


def _kernel_constant(pattern):
    with open(SOURCE) as f:
        return int(re.search(pattern, f.read()).group(1))


# the kernel's launch shape (threads, rays, tile), read from its source, and
# a smaller shape, whose tiles the ragged cases below cross more often
KERNEL = (_kernel_constant(r"constexpr int kThreads = (\d+);"),
          _kernel_constant(r"constexpr int kRays = (\d+);"),
          _kernel_constant(r"constexpr int kTile = (\d+);"))
SHAPES = [pytest.param(KERNEL, id="kernel"), pytest.param((32, 3, 64), id="small")]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiled_min_t(origin_xyz, dir_xyz, center_xyz, r2, active, t_min, t_max, speed_xyz=None,
                time=None, shape=KERNEL, stats=None):
    """The kernel's loops in plain torch -> (t (N,) f32, idx (N,) i32).

    Every ray slot of the grid (dead slots past N hold a zero ray) runs
    through the spheres tile by tile in index order; the root and the
    range tests run for a slot's pair only when the slot's thread took the
    branch for the sphere, some ray of the thread having delta > 0, and the
    slot's own delta > 0. `stats`, a dict, receives the pairs, the pairs
    that took the root and the (thread, sphere) branches taken."""
    threads, rays, tile = shape
    n, s = origin_xyz[0].shape[0], r2.shape[0]
    per_block = threads * rays
    slots = -(-n // per_block) * per_block
    slot = torch.arange(slots)
    # ray `slot` is held by thread slot % threads of block slot // per_block
    thread = (slot // per_block) * threads + slot % threads

    def pad(a):
        return torch.cat([a, torch.zeros(slots - n, dtype=a.dtype)])

    ox, oy, oz = (pad(a) for a in origin_xyz)
    dx, dy, dz = (pad(a) for a in dir_xyz)
    moving = speed_xyz is not None
    tm = pad(time) if moving else None
    best_t = torch.full((slots,), float(BIG))
    best_i = torch.zeros(slots, dtype=torch.int32)
    counts = {"pairs": 0, "roots": 0, "branches": 0}
    for base in range(0, s, tile):
        m = min(tile, s - base)
        # the staged records: an inactive sphere's r2 is -inf
        staged_r2 = torch.where(active[base:base + m], r2[base:base + m],
                                torch.tensor(-float("inf")))
        for j in range(m):
            k = base + j
            cx, cy, cz = (c[k] for c in center_xyz)
            if moving:
                cx = cx + speed_xyz[0][k] * tm
                cy = cy + speed_xyz[1][k] * tm
                cz = cz + speed_xyz[2][k] * tm
            lx = ox - cx
            ly = oy - cy
            lz = oz - cz
            half_b = dx * lx + dy * ly + dz * lz
            c = lx * lx + ly * ly + lz * lz - staged_r2[j]
            delta = half_b * half_b - c
            ok = delta > 0.0
            taken = torch.zeros(slots // rays, dtype=torch.int64).index_add_(0, thread,
                                                                             ok.long()) > 0
            root = taken[thread] & ok
            counts["pairs"] += slots
            counts["roots"] += int(root.sum())
            counts["branches"] += int(taken.sum())
            sel = root.nonzero()[:, 0]
            hb = half_b[sel]
            sq = torch.sqrt(delta[sel])
            t1 = -hb - sq
            t2 = -hb + sq
            in1 = (t_min < t1) & (t1 < t_max)
            in2 = (t_min < t2) & (t2 < t_max)
            t = torch.where(in1, t1, torch.where(in2, t2, torch.full_like(t1, float(BIG))))
            better = t < best_t[sel]
            best_t[sel[better]] = t[better]
            best_i[sel[better]] = k
    if stats is not None:
        stats.update(counts)
    return best_t[:n], best_i[:n]


def motion_case(seed, n, s):
    """Speeds in [-2, 2)^3 (a third of the spheres at rest) and shutter
    times in [0, 1), with the first ray at time 0 and the second at 1."""
    rng = np.random.default_rng(seed)
    speed = rng.uniform(-2, 2, (s, 3)).astype(np.float32) * (rng.random((s, 1)) < 0.67)
    time = rng.random(n).astype(np.float32)
    time[:2] = (0.0, 1.0)[:n]
    return (tuple(torch.from_numpy(np.ascontiguousarray(speed[:, i])) for i in range(3)),
            torch.from_numpy(time))


def assert_bit_equal(args, motion=None, shape=KERNEL, t_min=TMIN, t_max=TMAX):
    """The model against the plain version: t and idx equal bit for bit.
    -> (t, idx, stats)."""
    motion = motion or {}
    stats = {}
    t, idx = tiled_min_t(*args, t_min, t_max, **motion, shape=shape, stats=stats)
    pt, pidx = smt.sphere_min_t_plain(*args, t_min, t_max, **motion)
    assert t.dtype == pt.dtype and idx.dtype == pidx.dtype
    assert torch.equal(t, pt) and torch.equal(idx, pidx)
    return t, idx, stats


def jax_min_t(case, motion=None):
    """spheres.pair_t of the JAX package, min and argmin, on make_case's
    numpy arrays (and the motion's speeds and times)."""
    o, d, c, r, act = case
    speed = (np.stack([a.numpy() for a in motion["speed_xyz"]], 1) if motion
             else np.zeros((len(r), 3), np.float32))
    g = jsph.SphereGroup(center=JVec3.from_array(jnp.asarray(c)), radius=jnp.asarray(r),
                         speed=JVec3.from_array(jnp.asarray(speed)),
                         mat_id=jnp.arange(len(r), dtype=jnp.int32), active=jnp.asarray(act))
    col = lambda a: JVec3(*(jnp.asarray(a[:, i])[:, None] for i in range(3)))
    tm = jnp.asarray(motion["time"].numpy())[:, None] if motion else 0.0
    t = jsph.pair_t(g, col(o), col(d), tm, jnp.float32(TMIN), jnp.float32(TMAX),
                    bool(motion))
    return np.asarray(jnp.min(t, axis=1)), np.asarray(jnp.argmin(t, axis=1))


# -- ragged ray and sphere counts -------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("s", [0, 1, 255, 256, 257])
@pytest.mark.parametrize("n", [1, 31, 33, 257])
@pytest.mark.parametrize("moving", [False, True], ids=["static", "moving"])
def test_ragged_counts_match_plain(moving, n, s, shape):
    args = torch_args(*make_case(1000 + n + s, n, s))
    motion = dict(zip(("speed_xyz", "time"), motion_case(n + s, n, s))) if moving else None
    t, idx, stats = assert_bit_equal(args, motion, shape)
    if s == 0:
        assert (t == BIG).all() and (idx == 0).all()
    if s >= 255 and n >= 33:
        assert (t < BIG).any()
        # the design's point: most pairs skip the root
        assert stats["roots"] < stats["pairs"] // 4


@pytest.mark.parametrize("moving", [False, True], ids=["static", "moving"])
@pytest.mark.parametrize("s", [255, 256, 257])
def test_model_matches_jax_pair_t(moving, s):
    n = 257
    case = make_case(2000 + s, n, s)
    motion = dict(zip(("speed_xyz", "time"), motion_case(s, n, s))) if moving else None
    t, idx = tiled_min_t(*torch_args(*case), TMIN, TMAX, **(motion or {}))
    jt, jidx = jax_min_t(case, motion)
    assert_close_t(t.numpy(), jt)
    assert (idx.numpy() != jidx).mean() <= 0.01
    assert (t.numpy() < BIG).sum() >= 10


@pytest.mark.parametrize("n,s", [(257, 257), (33, 130)])
def test_model_matches_jax_pallas_interpret(n, s):
    case = make_case(3000 + s, n, s)
    t, idx = tiled_min_t(*torch_args(*case), TMIN, TMAX)
    pt, pidx = jax_pallas(*case)
    hit = pt < BIG
    assert ((t.numpy() < BIG) == hit).mean() > 0.99
    both = hit & (t.numpy() < BIG)
    np.testing.assert_allclose(t.numpy()[both], pt[both], rtol=5e-4)
    assert (idx.numpy()[both] == pidx[both]).mean() > 0.99


# -- the cases the design must not change ----------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("moving", [False, True], ids=["static", "moving"])
def test_ties_go_to_the_first_index(moving, shape):
    n, s = 257, 258
    args = torch_args(*make_case(4, n, s, duplicate=True))
    motion = None
    if moving:  # the two copies of a sphere move alike
        speed, time = motion_case(5, n, s // 2)
        motion = {"speed_xyz": tuple(a.repeat_interleave(2) for a in speed), "time": time}
    t, idx, _ = assert_bit_equal(args, motion, shape)
    hit = t < BIG
    assert hit.sum() >= 10 and (idx[hit] % 2 == 0).all()


@pytest.mark.parametrize("moving", [False, True], ids=["static", "moving"])
def test_all_spheres_inactive(moving):
    n, s = 100, 300
    o, d, c, r2, act = torch_args(*make_case(6, n, s))
    # the rays start inside some of the spheres: an inactive sphere's staged
    # r2 = -inf must hide it all the same
    o = tuple(a.clone() for a in o)
    for i in range(3):
        o[i][:20] = c[i][:20]
    args = (o, d, c, r2, torch.zeros(s, dtype=torch.bool))
    motion = dict(zip(("speed_xyz", "time"), motion_case(7, n, s))) if moving else None
    t, idx, stats = assert_bit_equal(args, motion)
    assert (t == BIG).all() and (idx == 0).all() and stats["roots"] == 0


@pytest.mark.parametrize("shape", SHAPES)
def test_rays_starting_inside_take_the_far_root(shape):
    """Rays from inside a sphere (t1 < t_min < t2) hit its far side."""
    n, s = 70, 40
    o, d, c, r2, act = torch_args(*make_case(8, n, s))
    act = torch.ones(s, dtype=torch.bool)
    inside = torch.arange(n) % s
    o = tuple(c[i][inside] + 0.1 * d[i] for i in range(3))
    t, idx, _ = assert_bit_equal((o, d, c, r2, act), shape=shape)
    assert (t < BIG).all()
    # the far root of the ray's own sphere, or a nearer hit on another
    r = r2.sqrt()[inside]
    assert (t <= r + 0.1).all()
    assert (idx == inside).float().mean() > 0.8


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("moving", [False, True], ids=["static", "moving"])
def test_hits_at_t_max_and_t_min(moving, shape):
    """A unit sphere at x = 5 on the ray (0, 0, 0) + t (1, 0, 0): t1 = 4 and
    t2 = 6 exactly. The range is open, so t = t_max and t = t_min miss. A
    ray from (0, 1, 0) along x, held by the same thread as the first,
    touches the sphere at t = 5 with delta = 0 exactly: no
    hit, though its thread takes the root's branch."""
    threads = shape[0]
    n = threads + 1  # ray `threads` is thread 0's second ray
    f = lambda *v: torch.tensor(v, dtype=torch.float32)
    ox, oy, oz = torch.zeros(n), torch.zeros(n), torch.zeros(n)
    dx, dy, dz = torch.zeros(n), torch.zeros(n), torch.ones(n)  # the others miss
    dx[[0, 1, threads]], dz[[0, 1, threads]] = 1.0, 0.0
    oy[threads] = 1.0
    args = ((ox, oy, oz), (dx, dy, dz), (f(5.0), f(0.0), f(0.0)), f(1.0),
            torch.tensor([True]))
    motion = None
    if moving:  # at rest for the first ray, moved back 1 for the second
        time = torch.zeros(n)
        time[1] = 1.0
        motion = {"speed_xyz": (f(-1.0), f(0.0), f(0.0)), "time": time}
    up = np.nextafter(np.float32(4.0), np.float32(10.0))
    down = np.nextafter(np.float32(4.0), np.float32(0.0))
    t, _, _ = assert_bit_equal(args, motion, shape, t_max=4.0)  # t1 = t_max: t2 is out too
    assert t[0] == BIG and t[1] == (3.0 if moving else BIG)
    t, _, _ = assert_bit_equal(args, motion, shape, t_max=float(up))  # t1 just inside
    assert t[0] == 4.0
    t, _, stats = assert_bit_equal(args, motion, shape, t_min=4.0)  # t1 = t_min: far root
    assert t[0] == 6.0 and t[threads] == BIG and stats["branches"] >= 1
    t, _, _ = assert_bit_equal(args, motion, shape, t_min=float(down))
    assert t[0] == 4.0 and t[threads] == BIG
    assert (t[2:threads] == BIG).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_zero_speeds_give_the_static_result(shape):
    n, s = 257, 257
    args = torch_args(*make_case(9, n, s))
    _, time = motion_case(10, n, s)
    zero = tuple(torch.zeros(s) for _ in range(3))
    t, idx, _ = assert_bit_equal(args, {"speed_xyz": zero, "time": time}, shape)
    st, sidx, _ = assert_bit_equal(args, shape=shape)
    assert torch.equal(t, st) and torch.equal(idx, sidx)


@pytest.mark.parametrize("time", [0.0, 1.0])
def test_shutter_ends(time):
    """Every ray at time 0 sees the spheres where they stand; at time 1 where
    the static form sees spheres moved by their whole speed."""
    n, s = 257, 100
    o, d, c, r2, act = torch_args(*make_case(11, n, s))
    speed, _ = motion_case(12, n, s)
    t, idx, _ = assert_bit_equal((o, d, c, r2, act),
                                 {"speed_xyz": speed, "time": torch.full((n,), time)})
    moved = tuple(c[i] + speed[i] * np.float32(time) for i in range(3))
    st, sidx = smt.sphere_min_t_plain(o, d, moved, r2, act, TMIN, TMAX)
    assert torch.equal(t, st) and torch.equal(idx, sidx)
    assert (t < BIG).sum() >= 10

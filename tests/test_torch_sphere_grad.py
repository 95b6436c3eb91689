"""The gradient of the port's ray x sphere sweep: `ops.sphere_min_t`'s
autograd Function `SphereMinT` and its backward `sphere_min_t_bwd_plain`
(the plain version of the kernel K1b), on the CPU.

  * Against finite differences: `torch.autograd.gradcheck` of the sweep's
    t in float64 (forward `sphere_min_t_plain`, backward
    `sphere_min_t_bwd_plain`), gradcheck's own tolerances.
  * Against the JAX package: `jax.grad` of the t of its sphere sweep
    (`geometry/spheres.py` `intersect`, the dense route) with respect to
    the rays' origins and directions, static and moving. The JAX package's
    `pair_t` takes sqrt(max(delta, 0)) of every pair, whose derivative at 0
    is infinite, so any ray that misses a sphere gets a NaN gradient there
    (a fault of the reference, ROADMAP section 3); for this test only,
    `pair_t` is swapped for a NaN-safe copy (the square root of delta
    where the pair can hit, else of 1), which changes no value of t and no
    file of the JAX package. Tolerance: |g_port - g_jax| <= 1e-5 times the
    largest |g_jax| of the ray (per ray, over origin and direction): a
    component of dt/do = -n / (n.d) can be small beside the others, so a
    component-wise relative limit would measure cancellation, not the
    backward.
  * The rays: random origins and directions (most miss, a ray's winner
    takes the near root), rays started on a sphere's surface heading in
    (the near root falls below t_min, the far root wins), and a t_max that
    cuts some far hits (misses). A tie in t between two spheres has
    measure zero on these seeded rays; the sweep gives it to the first
    index, `jnp.min` would split it.
  * Grad mode: the sweep goes through the Function only when something
    requires grad, so the forward render is the plain call it was.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raysnail_tpu.camera import Ray as JRay
from raysnail_tpu.geometry import spheres as jsph
from raysnail_tpu.prelude.vec import Vec3 as JVec3
from raysnail_tpu_torch.camera import Ray as TRay
from raysnail_tpu_torch.geometry import spheres as tsph
from raysnail_tpu_torch.ops import sphere_min_t as smt
from raysnail_tpu_torch.prelude.vec import Vec3 as TVec3

TMIN = 1e-3
GRAD_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_case(seed, n_random, n_surface, n_spheres, moving=False):
    """Numpy rays and spheres: `n_random` rays in a 24^3 box with random unit
    directions, then `n_surface` rays started just outside a sphere's
    surface heading into it; spheres in a 16^3 box, every 5th inactive;
    moving: speeds in [-1, 1]^3 and ray times in [0, 1)."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-8, 8, (n_spheres, 3))
    r = rng.uniform(0.5, 2.0, n_spheres)
    active = np.ones(n_spheres, bool)
    active[::5] = False
    speed = rng.uniform(-1, 1, (n_spheres, 3)) if moving else np.zeros((n_spheres, 3))
    o = rng.uniform(-12, 12, (n_random, 3))
    d = rng.normal(size=(n_random, 3))
    time = rng.uniform(0, 1, n_random + n_surface)
    k = rng.choice(np.flatnonzero(active), n_surface)
    n = rng.normal(size=(n_surface, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    centers = c[k] + speed[k] * time[n_random:, None]
    o_s = centers + n * (r[k, None] + 2e-4)
    d_s = -n + 0.3 * rng.normal(size=(n_surface, 3))
    o = np.concatenate([o, o_s])
    d = np.concatenate([d, d_s])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f = np.float32
    return dict(o=o.astype(f), d=d.astype(f), c=c.astype(f), r=r.astype(f), active=active,
                speed=speed.astype(f), time=time.astype(f), g_t=rng.normal(size=len(o)).astype(f))


def torch_args(case, dtype=torch.float32, moving=False):
    def cols(a):
        return tuple(torch.tensor(a[:, i], dtype=dtype) for i in range(3))
    o, d = cols(case["o"]), cols(case["d"])
    r = torch.tensor(case["r"], dtype=dtype)
    args = (o, d, cols(case["c"]), r * r, torch.tensor(case["active"]))
    motion = dict(speed_xyz=cols(case["speed"]),
                  time=torch.tensor(case["time"], dtype=dtype)) if moving else {}
    return args, motion


class _Plain(torch.autograd.Function):
    """The sweep's t with the plain forward and backward, any dtype (the
    wrappers take float32 only)."""

    @staticmethod
    def forward(ctx, ox, oy, oz, dx, dy, dz, c, r2, active, t_max, speed, time):
        motion = dict(speed_xyz=speed, time=time) if time is not None else {}
        t, idx = smt.sphere_min_t_plain((ox, oy, oz), (dx, dy, dz), c, r2, active, TMIN,
                                        t_max, **motion)
        ctx.save_for_backward(ox, oy, oz, dx, dy, dz, t, idx)
        ctx.rest = (c, r2, t_max, motion)
        return t

    @staticmethod
    def backward(ctx, g_t):
        ox, oy, oz, dx, dy, dz, t, idx = ctx.saved_tensors
        c, r2, t_max, motion = ctx.rest
        g_o, g_d = smt.sphere_min_t_bwd_plain((ox, oy, oz), (dx, dy, dz), t, idx, g_t, c, r2,
                                              TMIN, t_max, **motion)
        return (*g_o, *g_d) + (None,) * 6


@pytest.mark.parametrize("moving", [False, True])
def test_backward_passes_gradcheck_in_float64(moving):
    case = make_case(11 + moving, 60, 20, 6, moving)
    (o, d, c, r2, active), motion = torch_args(case, torch.float64, moving)
    t_max = 14.0
    t, _ = smt.sphere_min_t_plain(o, d, c, r2, active, TMIN, t_max, **motion)
    hit = t < smt.BIG
    assert 20 <= int(hit.sum()) <= 70  # both hits and misses
    inputs = tuple(a.clone().requires_grad_(True) for a in (*o, *d))
    speed, time = (motion["speed_xyz"], motion["time"]) if moving else (None, None)
    assert torch.autograd.gradcheck(
        lambda *x: _Plain.apply(*x, c, r2, active, t_max, speed, time), inputs)


def _safe_pair_t(group, origin, direction, time, t_min, t_max, moving):
    """The JAX package's pair_t with the square root taken only where the
    pair can hit (sqrt(1) elsewhere): the same t, a finite gradient."""
    cx, cy, cz = group.center.x, group.center.y, group.center.z
    if moving:
        cx = cx + group.speed.x * time
        cy = cy + group.speed.y * time
        cz = cz + group.speed.z * time
    lx = origin.x - cx
    ly = origin.y - cy
    lz = origin.z - cz
    half_b = direction.x * lx + direction.y * ly + direction.z * lz
    c = lx * lx + ly * ly + lz * lz - group.radius * group.radius
    delta = half_b * half_b - c
    ok = (delta > 0.0) & group.active
    sq = jnp.sqrt(jnp.where(ok, delta, 1.0))
    t1 = -half_b - sq
    t2 = -half_b + sq
    in1 = ok & (t_min < t1) & (t1 < t_max)
    in2 = ok & (t_min < t2) & (t2 < t_max)
    return jnp.where(in1, t1, jnp.where(in2, t2, jsph.BIG))


def jax_grad(case, t_max, moving):
    n_s = len(case["r"])
    group = jsph.SphereGroup(
        center=JVec3(*(jnp.asarray(case["c"][:, i]) for i in range(3))),
        radius=jnp.asarray(case["r"]),
        speed=JVec3(*(jnp.asarray(case["speed"][:, i]) for i in range(3))),
        mat_id=jnp.zeros(n_s, jnp.int32), active=jnp.asarray(case["active"]))
    time = jnp.asarray(case["time"])
    g_t = jnp.asarray(case["g_t"])

    def f(o, d):
        ray = JRay(JVec3(*o), JVec3(*d), time)
        hit = jsph.intersect(group, ray, TMIN, t_max, moving=moving, need_uv=False)
        return jnp.sum(jnp.where(hit.valid, hit.t, 0.0) * g_t), hit.t

    cols = lambda a: tuple(jnp.asarray(a[:, i]) for i in range(3))
    (g_o, g_d), t = jax.grad(f, argnums=(0, 1), has_aux=True)(cols(case["o"]), cols(case["d"]))
    return np.stack([*g_o, *g_d], 1), np.asarray(t)


@pytest.mark.parametrize("moving", [False, True])
def test_backward_matches_jax_grad(monkeypatch, moving):
    monkeypatch.setattr(jsph, "pair_t", _safe_pair_t)
    case = make_case(3 + moving, 3000, 1000, 40, moving)
    t_max = 20.0
    ref, t_ref = jax_grad(case, t_max, moving)
    assert np.isfinite(ref).all()
    (o, d, c, r2, active), motion = torch_args(case, moving=moving)
    xs = [a.clone().requires_grad_(True) for a in (*o, *d)]
    speed = motion.get("speed_xyz", (None,) * 3)
    t, idx = smt.SphereMinT.apply(*xs, *c, r2, active, TMIN, t_max, *speed, motion.get("time"))
    assert not idx.requires_grad and t.grad_fn is not None
    (t * torch.tensor(case["g_t"])).sum().backward()
    got = torch.stack([x.grad for x in xs], 1).numpy()
    hit = t.detach().numpy() < smt.BIG
    assert np.array_equal(hit, t_ref < smt.BIG)
    assert hit.sum() > 1000 and (~hit).sum() > 500
    # both roots won: the surface rays' near root lies below t_min
    surf = slice(3000, None)
    l = case["o"][surf] - (case["c"][idx[surf]] + case["speed"][idx[surf]]
                           * case["time"][surf, None])
    near = -np.sum(case["d"][surf] * l, 1) - np.sqrt(
        np.sum(case["d"][surf] * l, 1) ** 2 - np.sum(l * l, 1) + case["r"][idx[surf]] ** 2)
    assert (hit[surf] & (near < TMIN)).sum() > 500
    assert (got[~hit] == 0).all()
    scale = np.abs(ref).max(1, keepdims=True)
    err = np.abs(got - ref)
    assert (err <= GRAD_RTOL * scale).all(), (err / np.maximum(scale, 1e-30)).max()


def test_sweep_takes_the_function_only_under_grad():
    case = make_case(5, 200, 50, 8)
    (o, d, c, r2, active), _ = torch_args(case)
    group = tsph.SphereGroup(center=TVec3(*c), radius=r2.sqrt(), mat_id=torch.zeros(8, dtype=torch.int32),
                             active=active)
    ray = TRay(TVec3(*o), TVec3(*d), torch.zeros(250))
    assert tsph.intersect(group, ray, TMIN, 20.0).t.grad_fn is None
    dg = TVec3(*(a.clone().requires_grad_(True) for a in d))
    hit = tsph.intersect(group, TRay(TVec3(*o), dg, torch.zeros(250)), TMIN, 20.0)
    assert hit.t.grad_fn is not None
    with torch.no_grad():
        assert tsph.intersect(group, TRay(TVec3(*o), dg, torch.zeros(250)), TMIN,
                              20.0).t.grad_fn is None

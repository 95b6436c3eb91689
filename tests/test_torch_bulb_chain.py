"""The Mandelbulb march kernel's shortened DE chain (`csrc/mandelbulb_march.cu`),
held on the CPU.

The kernel runs only on a card. It runs one thread a ray, each to its own
exit, as the plain version `mandelbulb_march_plain` runs each ray, but it
reorders the DE's work:
  * the first iteration starts from the origin (r = rho = 0), so its result
    is written in closed form: each coordinate 0 + p (the sum that turns a
    -0 into +0, as the iteration's own sum does), r = 0 and dr = 1, with
    the iteration counted;
  * the escape test's xn^2 + yn^2 and + zn^2 are the next iteration's rho2
    and r2: the same products summed in the same order.
The claim is that neither shows in a result: the DE and its iteration count
equal `ops.mandelbulb_march.distance_est`'s bit for bit, and the march's t,
valid, normal, u, v and three per-ray counts equal the plain version's.

This file holds that claim with a plain-torch model of the kernel's DE
(`chain_de`) and march (`chain_march`), whose every float operation is the
kernel's on the same float32 values. Tolerance against the plain version:
none (torch.equal). It also holds the identity that the kernel's
branch-free square root rests on for the inputs below 2^-96: the root of
x 2^64 times 2^-32 is the correctly rounded root of x. Against the JAX
package run op by op, on the `mandelbulb` anchor's rays, the tolerances of
tests/test_torch_mandelbulb.py, for the reasons given there.
"""

import os
import re

import numpy as np
import pytest
import torch

from raysnail_tpu_torch.geometry.hit import finalize
from raysnail_tpu_torch.ops import mandelbulb_march as mm
from raysnail_tpu_torch.prelude.vec import Vec3, div_const
from test_torch_mandelbulb import TMAX, TMIN, _anchor_rays, _compare, _jax_hit

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "raysnail_tpu_torch", "csrc", "mandelbulb_march.cu")


def _kernel_constant(name):
    with open(SOURCE) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);", f.read()).group(1))


THREADS = _kernel_constant("kThreads")
ITERATIONS, MAX_STEPS = _kernel_constant("kIterations"), _kernel_constant("kMaxSteps")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit(x, y, z):
    inv = torch.reciprocal(torch.sqrt(torch.clamp_min(x * x + y * y + z * z, 1e-20)))
    return x * inv, y * inv, z * inv


def chain_de(px, py, pz):
    """The kernel's distance_est on (N,) float32 points -> (de, iterations
    int32): the first iteration in closed form, then the loop on the
    carried rho2 and r2, each point to its own exit."""
    x, y, z = px + 0.0, py + 0.0, pz + 0.0
    r = torch.zeros_like(px)
    dr = torch.ones_like(px)
    rho2 = x * x + y * y
    r2 = rho2 + z * z
    it = torch.ones(px.shape, dtype=torch.int32)
    live = ~(r2 > mm.BAILOUT) & (it < ITERATIONS)
    while bool(live.any()):
        i = torch.nonzero(live).reshape(-1)
        r_new = torch.sqrt(r2[i])
        rho = torch.sqrt(rho2[i])
        inv_r = torch.reciprocal(torch.clamp_min(r_new, mm.TINY))
        inv_rho = torch.reciprocal(torch.clamp_min(rho, mm.TINY))
        ct = torch.where(r_new > mm.TINY, z[i] * inv_r, 1.0)
        st = torch.where(r_new > mm.TINY, rho * inv_r, 0.0)
        cp = torch.where(rho > mm.TINY, x[i] * inv_rho, 1.0)
        sp = torch.where(rho > mm.TINY, y[i] * inv_rho, 0.0)
        for _ in range(3):
            ct, st = ct * ct - st * st, 2.0 * ct * st
            cp, sp = cp * cp - sp * sp, 2.0 * cp * sp
        r4 = r2[i] * r2[i]
        rp = r4 * r4
        dr[i] = (r4 * r2[i] * r_new) * mm.POWER * dr[i] + 1.0
        x[i] = rp * st * cp + px[i]
        y[i] = rp * st * sp + py[i]
        z[i] = rp * ct + pz[i]
        r[i] = rp
        it[i] += 1
        rho2[i] = x[i] * x[i] + y[i] * y[i]
        r2[i] = rho2[i] + z[i] * z[i]
        live[i] = ~(r2[i] > mm.BAILOUT) & (it[i] < ITERATIONS)
    rc = torch.clamp_min(r, 1e-12)
    drc = torch.clamp_min(dr, 1e-12)
    de = 0.5 * torch.log(rc) * rc / drc
    return torch.where(torch.isnan(de), 0.1, de), it


def chain_march(origin, direction, t_min, t_max, active=None):
    """The kernel's march, one ray a thread, each ray to its own exit (the
    threads run side by side here: no thread reads another's state); the
    normal's six DEs one after another -> the plain version's (t, valid,
    normal, u, v, counts)."""
    ox, oy, oz = origin
    dx, dy, dz = direction
    n = ox.shape[0]
    out_t = torch.full((n,), mm.BIG, dtype=torch.float32)
    valid = torch.zeros(n, dtype=torch.bool)
    normal = torch.stack([torch.zeros(n), torch.zeros(n), torch.ones(n)])
    u, v = torch.zeros(n), torch.zeros(n)
    counts = torch.zeros((3, n), dtype=torch.int32)
    half_b = dx * ox + dy * oy + dz * oz
    c = (ox * ox + oy * oy + oz * oz) - mm.RADIUS * mm.RADIUS
    delta = half_b * half_b - c
    sq = torch.sqrt(torch.clamp_min(delta, 0.0))
    t_enter = torch.clamp_min(-half_b - sq, t_min)
    t_exit = -half_b + sq
    in_bbox = (delta > 0.0) & (t_exit > t_min) & (t_enter < t_max)
    if active is not None:
        in_bbox = in_bbox & active
    t = torch.where(in_bbox, t_enter, mm.BIG)
    hit = torch.zeros(n, dtype=torch.bool)
    steps = torch.zeros(n, dtype=torch.int32)
    m_it = torch.zeros_like(steps)
    lane = torch.nonzero(in_bbox).reshape(-1)
    while lane.numel():  # each thread's step loop, lanes leaving at their exits
        tl = t[lane]
        de, it = chain_de(ox[lane] + dx[lane] * tl, oy[lane] + dy[lane] * tl,
                          oz[lane] + dz[lane] * tl)
        hit_now = de < mm.SURF_EPS
        over = tl > t_exit[lane]
        t[lane] = tl + torch.clamp_min(de * mm.STEP_SCALE, 1e-5)
        steps[lane] += 1
        m_it[lane] += it
        hit[lane[hit_now]] = True
        lane = lane[~(hit_now | over) & (steps[lane] < MAX_STEPS)]
    ok = hit & (t > t_min) & (t < t_max)
    counts[0], counts[1] = steps, m_it
    lane = torch.nonzero(ok).reshape(-1)
    if lane.numel():
        tv = t[lane]
        px, py, pz = (ox[lane] + dx[lane] * tv, oy[lane] + dy[lane] * tv,
                      oz[lane] + dz[lane] * tv)
        des, n_it = [], torch.zeros(lane.numel(), dtype=torch.int32)
        for k in range(6):  # +x, -x, +y, -y, +z, -z
            q = [px, py, pz]
            q[k // 2] = q[k // 2] + mm.NORMAL_D if k % 2 == 0 else q[k // 2] - mm.NORMAL_D
            de, it = chain_de(*q)
            des.append(de)
            n_it += it
        g = _unit(des[0] - des[1], des[2] - des[3], des[4] - des[5])
        out_t[lane], valid[lane] = tv, True
        normal[:, lane] = torch.stack(g)
        counts[2, lane] = n_it
    # the uv of every hit, in index order as the plain version takes it:
    # torch's CPU atan2 rounds otherwise in its vector loop than in its tail
    idx = torch.nonzero(valid).reshape(-1)
    if idx.numel():
        tv = out_t[idx]
        qx, qy, qz = _unit(ox[idx] + dx[idx] * tv, oy[idx] + dy[idx] * tv,
                           oz[idx] + dz[idx] * tv)
        u[idx] = div_const(torch.atan2(-qz, qx), 2.0 * mm.PI) + 0.5
        v[idx] = div_const(torch.asin(torch.clamp(qy, -1.0, 1.0)), mm.PI) + 0.5
    return out_t, valid, normal, u, v, counts


def _cols(a):
    return torch.from_numpy(np.ascontiguousarray(a.T.astype(np.float32)))


def _points(kind, n=4096, seed=7):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    if kind == "axes-and-signed-zeros":
        p = rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
        p[: n // 2, rng.integers(0, 3, n // 2)] = 0.0
        p[n // 4: n // 2, 0:2] = -0.0
        p[0] = (0.0, 0.0, 0.0)
        p[1] = (-0.0, -0.0, -0.0)
        return p
    return rng.uniform(2.0, 4.0, (n, 3)).astype(np.float32) * rng.choice([-1, 1], (n, 3))


def test_launch_constants_are_the_plain_versions():
    assert (ITERATIONS, MAX_STEPS) == (mm.DE_ITERATIONS, mm.MAX_STEPS)
    assert THREADS % 32 == 0


@pytest.mark.parametrize("kind", ["random", "axes-and-signed-zeros", "outside-the-bailout"])
def test_chain_de_matches_the_plain_de(kind):
    pts = _cols(_points(kind))
    de, it = chain_de(*pts)
    want, _, want_it = mm.distance_est(*pts, counts=True)
    assert torch.equal(de, want) and torch.equal(it, want_it)
    if kind == "outside-the-bailout":  # the closed-form iteration alone escapes
        assert bool((it == 1).all())


def test_tiny_roots_scale_exactly():
    """sqrt_rn's branch for x < 2^-96: sqrt(x 2^64) 2^-32 is sqrtf(x),
    denormals included (numpy's float32 sqrt is correctly rounded)."""
    bits = np.random.default_rng(3).integers(1, 0x0F800000, 200_000).astype(np.uint32)
    x = bits.view(np.float32)
    x = x[x < np.float32(2.0 ** -96)]
    scaled = np.sqrt(x * np.float32(2.0 ** 64)) * np.float32(2.0 ** -32)
    assert x.size > 1000 and np.array_equal(scaled, np.sqrt(x))


@pytest.fixture(scope="module")
def anchor_case():
    """The `mandelbulb` anchor's primary rays and the model's march of them."""
    o, d = _anchor_rays()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = chain_march(_cols(o), _cols(d), TMIN, TMAX)
    finally:
        torch.set_num_threads(n)
    return o, d, out


def _mixed_rays(anchor_case, seed=5):
    """About 160 rays: of the anchor's, ones that ran all MAX_STEPS steps,
    hits, marched misses and rays that miss the bound; seeded rays that
    start inside the bound; a quarter of the lanes dead."""
    o, d, out = anchor_case
    steps, _, normal_iters = out[5].numpy()
    rng = np.random.default_rng(seed)
    pick = lambda mask, k: rng.permutation(np.flatnonzero(mask))[:k]
    full = pick(steps == MAX_STEPS, 6)
    assert full.size >= 1, "no anchor ray runs every step"
    idx = np.concatenate([full, pick(normal_iters > 0, 64),
                          pick((steps > 0) & (steps < MAX_STEPS) & (normal_iters == 0), 32),
                          pick(steps == 0, 20)])
    m = 40
    oi = rng.uniform(-1.2, 1.2, (m, 3))
    di = rng.standard_normal((m, 3))
    di /= np.linalg.norm(di, axis=1, keepdims=True)
    o_all = np.concatenate([o[idx], oi]).astype(np.float32)
    d_all = np.concatenate([d[idx], di]).astype(np.float32)
    perm = rng.permutation(o_all.shape[0])
    active = torch.from_numpy(rng.random(perm.size) >= 0.25)
    return _cols(o_all[perm]), _cols(d_all[perm]), active


def _assert_equal_to_plain(o3, d3, t_min, t_max, active):
    got = chain_march(o3, d3, t_min, t_max, active)
    want = mm.mandelbulb_march_plain(o3, d3, t_min, t_max, active, stats=True)
    for name, a, b in zip(("t", "valid", "normal", "u", "v", "counts"), got, want):
        assert torch.equal(a, b), name
    return got


@pytest.mark.parametrize("dead", [False, True], ids=["live", "quarter-dead"])
def test_chain_march_matches_plain(anchor_case, dead):
    o3, d3, active = _mixed_rays(anchor_case)
    got = _assert_equal_to_plain(o3, d3, TMIN, TMAX, active if dead else None)
    valid, counts = got[1], got[5]
    assert int(valid.sum()) > 40 and int((counts[0] == MAX_STEPS).sum()) >= 1
    if dead:
        assert not bool(valid[~active].any())


def test_chain_march_matches_plain_with_hits_outside_the_range(anchor_case):
    """t_min inside the bound and t_max below many hits: rays hit outside
    (t_min, t_max) and are written as misses after their march."""
    o3, d3, active = _mixed_rays(anchor_case, seed=6)
    t_all = mm.mandelbulb_march_plain(o3, d3, TMIN, TMAX)[0]
    t_max = float(t_all[t_all < mm.BIG].median())
    got = _assert_equal_to_plain(o3, d3, 0.5, t_max, active)
    steps, valid = got[5][0], got[1]
    assert int(((steps > 0) & ~valid & (got[5][1] > 0)).sum()) > 0


@pytest.mark.parametrize("n", [0, 1, 31, 33])
def test_chain_march_matches_plain_on_small_counts(anchor_case, n):
    o3, d3, active = _mixed_rays(anchor_case, seed=7)
    _assert_equal_to_plain(o3[:, :n].contiguous(), d3[:, :n].contiguous(), TMIN, TMAX,
                           active[:n].clone())


def test_chain_march_matches_jax_run_op_by_op(anchor_case):
    """The model on the anchor's rays against the JAX package's march run
    op by op, with tests/test_torch_mandelbulb.py's tolerances (every hit
    mask equal, t bit for bit on 0.99 of the hits, normals within 0.02, uv
    within 1e-4)."""
    o, d, (t, valid, normal, u, v, _) = anchor_case
    mid = torch.zeros(t.shape, dtype=torch.int32)
    th = finalize(Vec3(*_cols(d)), t, Vec3(*normal), u, v, mid, valid)
    agree, n_both, tt, jt, dn, duv = _compare(th, _jax_hit(o, d, eager=True))
    assert n_both > 500
    assert agree == 1.0 and (tt == jt).mean() >= 0.99, (agree, (tt == jt).mean())
    assert dn <= 0.02 and duv <= 1e-4, (dn, duv)

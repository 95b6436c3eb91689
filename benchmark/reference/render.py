"""The plain reference path tracer: one path per (pixel, sample), traced
bounce by bounce over a batch of paths with masked lanes, in plain PyTorch.

The estimator is the Rust renderer raysnail's compat path
(src/camera.rs:156-255): the emitted term every bounce, then a 50/50
branch between a direction toward a random light (denominator 1/pi) and a
sample of the material's density (weight 1); a miss adds the sky and ends
the path. Draws are keyed by (seed, pixel, sample, bounce, purpose), so
the reference traces the very paths the program traces, whatever order
the program schedules them in, and a pixel's sum over its samples is the
same sum. Hits are found by brute force over the spheres and boxes.

Only what the benchmark's configurations use is here: Lambertian and
DiffuseLight materials, constant and checker textures, spheres,
axis-aligned boxes and sphere lights.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import rng
from benchmark.reference.scene import CHECKER, DIFFUSE_LIGHT, Scene
from benchmark.reference.vec import V3

BIG = 1e30
PI = math.pi
INV_PI = 1.0 / math.pi
T_MIN, T_MAX, SHADOW_EPS, LIGHT_PROB = 1e-3, 3e4, 2e-3, 0.5


def _full(a, v):
    return torch.full_like(a, v)


def _div(a, c: float):
    """a / c for a number c, as one IEEE division."""
    return a / torch.full_like(a, c)


def camera_rays(scene: Scene, width: int, height: int, sqrt_spp: int, pixel, sample, keys):
    """Jittered thin-lens rays through the stratification cell `sample` of
    each pixel (painter.rs:131-187, camera.rs:77-85)."""
    dtype, cam = scene.dtype, scene.camera
    px, py = (pixel % width).to(dtype), (pixel // width).to(dtype)
    s_i, s_j = (sample % sqrt_spp).to(dtype), (sample // sqrt_spp).to(dtype)
    j1, j2 = rng.uniforms(rng.fold(keys, rng.RAYGEN), 2, dtype)
    inv_s = 1.0 / sqrt_spp
    u = _div(px + (s_i + j1) * inv_s, width)
    v = _div(height - 1.0 - (py + (s_j + j2) * inv_s), height)
    u1, u2, _ = rng.uniforms(rng.fold(keys, rng.LENS), 3, dtype)
    r, theta = torch.sqrt(u1), 2.0 * PI * u2
    half_ap = cam.aperture * 0.5
    offset = (cam.horizontal_unit * ((r * torch.cos(theta)) * half_ap)
              + cam.vertical_unit * ((r * torch.sin(theta)) * half_ap))
    origin = cam.origin + offset
    direction = (cam.lb + cam.horizontal_full * u + cam.vertical_full * v - origin).unit()
    return origin, direction


# -- hits -------------------------------------------------------------------

def _sphere_hit(scene: Scene, o: V3, d: V3):
    """Nearest sphere: the half-b quadratic, t1 else t2 in range; ties to
    the first sphere."""
    c = scene.sph_center
    lx, ly, lz = o.x[:, None] - c.x, o.y[:, None] - c.y, o.z[:, None] - c.z
    dx, dy, dz = d.x[:, None], d.y[:, None], d.z[:, None]
    half_b = dx * lx + dy * ly + dz * lz
    cc = lx * lx + ly * ly + lz * lz - scene.sph_r2
    delta = half_b * half_b - cc
    sq = torch.sqrt(torch.clamp_min(delta, 0.0))
    t1, t2 = -half_b - sq, -half_b + sq
    ok = delta > 0.0
    in1 = ok & (T_MIN < t1) & (t1 < T_MAX)
    in2 = ok & (T_MIN < t2) & (t2 < T_MAX)
    t = torch.where(in1, t1, torch.where(in2, t2, _full(t1, BIG)))
    idx = torch.argmin(t, dim=1)
    t = torch.gather(t, 1, idx[:, None])[:, 0]
    valid = t < BIG
    p = o + d * t
    radius = scene.sph_radius[idx]
    n = (p - c.at(idx)) * (1.0 / torch.where(valid, radius, torch.ones_like(radius)))
    return t, valid, n, scene.sph_mat[idx]


def _box_hit(scene: Scene, o: V3, d: V3):
    """Nearest axis-aligned box: the slab test, t_near if in range else
    t_far, with the face's outward normal; ties to the first box."""
    def inv(c):
        tiny = torch.where(c < 0, _full(c, -1e-12), _full(c, 1e-12))
        return 1.0 / torch.where(torch.abs(c) < 1e-12, tiny, c)

    lo, hi = scene.box_lo, scene.box_hi
    ta = V3(*((a - b[:, None]) * inv(e)[:, None] for a, b, e in zip(lo, o, d)))
    tb = V3(*((a - b[:, None]) * inv(e)[:, None] for a, b, e in zip(hi, o, d)))
    mn = V3(*(torch.minimum(a, b) for a, b in zip(ta, tb)))
    mx = V3(*(torch.maximum(a, b) for a, b in zip(ta, tb)))
    near = torch.maximum(mn.x, torch.maximum(mn.y, mn.z))
    far = torch.minimum(mx.x, torch.minimum(mx.y, mx.z))
    ax_near = torch.where(mn.x >= mn.y, torch.where(mn.x >= mn.z, 0, 2),
                          torch.where(mn.y >= mn.z, 1, 2))
    ax_far = torch.where(mx.x <= mx.y, torch.where(mx.x <= mx.z, 0, 2),
                         torch.where(mx.y <= mx.z, 1, 2))
    slab = near < far
    near_in = slab & (T_MIN < near) & (near < T_MAX)
    far_in = slab & (T_MIN < far) & (far < T_MAX)
    t = torch.where(near_in, near, torch.where(far_in, far, _full(near, BIG)))
    idx = torch.argmin(t, dim=1, keepdim=True)
    t_best = torch.gather(t, 1, idx)[:, 0]
    entry = torch.gather(near_in, 1, idx)[:, 0]
    axis = torch.gather(torch.where(near_in, ax_near, ax_far), 1, idx)[:, 0]
    d_axis = torch.where(axis == 0, d.x, torch.where(axis == 1, d.y, d.z))
    sign = torch.where(entry, -torch.sign(d_axis), torch.sign(d_axis))
    zero = torch.zeros_like(sign)
    n = V3(torch.where(axis == 0, sign, zero), torch.where(axis == 1, sign, zero),
           torch.where(axis == 2, sign, zero))
    return t_best, t_best < BIG, n, scene.box_mat[idx[:, 0]]


def intersect(scene: Scene, o: V3, d: V3):
    """-> (t, valid, normal facing the ray, material row, outside). Groups
    in order spheres, boxes; a later group takes a ray only where it is
    strictly nearer."""
    n_rays = o.x.shape[0]
    t = torch.full((n_rays,), BIG, dtype=scene.dtype, device=o.x.device)
    valid = torch.zeros(n_rays, dtype=torch.bool, device=o.x.device)
    zero = torch.zeros_like(t)
    normal = V3(zero, zero, torch.ones_like(t))
    mat = torch.zeros(n_rays, dtype=torch.int64, device=o.x.device)
    outside = torch.ones_like(valid)
    for group in (_sphere_hit if scene.sph_center is not None else None,
                  _box_hit if scene.box_lo is not None else None):
        if group is None:
            continue
        tg, vg, ng, mg = group(scene, o, d)
        out_g = d.dot(ng) < 0.0
        ng = V3.where(out_g, ng, -ng)
        take = tg < t
        t, valid = torch.where(take, tg, t), torch.where(take, vg, valid)
        normal = V3.where(take, ng, normal)
        mat, outside = torch.where(take, mg, mat), torch.where(take, out_g, outside)
    return t, valid, normal, mat, outside


# -- shading ------------------------------------------------------------------

def _onb(n: V3):
    """Orthonormal basis about n: u = unit(up x w), or unit(x x w) where w
    is (anti)parallel to up."""
    w = n.unit()
    zero, one = torch.zeros_like(w.x), torch.ones_like(w.x)
    uc = V3(zero, one, zero).cross(w)
    u = V3.where(uc.dot(uc) < 1e-8, V3(one, zero, zero).cross(w).unit(), uc.unit())
    return u, w.cross(u), w


def _local(onb, a: V3) -> V3:
    u, v, w = onb
    return u * a.x + v * a.y + w * a.z


def _cosine(u1, u2) -> V3:
    q2, phi = torch.sqrt(u2), 2.0 * PI * u1
    return V3(torch.cos(phi) * q2, torch.sin(phi) * q2, torch.sqrt(1.0 - u2))


def _n_uniforms(scene: Scene) -> int:
    """Uniform slots a bounce draws: light branch, pick and two for the
    light's point (when there are lights), and two for the cosine sample."""
    return (4 if scene.lights is not None else 0) + 2


def shade(scene: Scene, tables, o: V3, d: V3, T: V3, L: V3, alive, kb):
    """One bounce of every lane: (o, d, T, L, alive) after it. Dead lanes
    keep their state; `tables` holds the colors and multipliers (leaves of
    the gradient in a train step)."""
    t, valid, normal, mat, _ = intersect(scene, o, d)
    dtype = t.dtype
    zeros = V3(*(torch.zeros_like(t),) * 3)
    bg0, bg1 = scene.bg
    s = 0.5 * (d.y + 1.0)
    L = L + V3.where(alive & ~valid, T * (bg0 * (1.0 - s) + bg1 * s), zeros)
    u = rng.uniforms(rng.fold(kb, rng.SCATTER), _n_uniforms(scene), dtype)
    kind, tex = scene.mat_kind[mat], scene.mat_tex[mat]
    p = o + d * t
    color = tables.color1.at(tex)
    checker = scene.tex_kind[tex] == CHECKER
    if bool(checker.any()):
        sc = scene.tex_scale[tex]
        odd = torch.sin(sc * p.x) * torch.sin(sc * p.y) * torch.sin(sc * p.z) < 0.0
        color = V3.where(checker, V3.where(odd, color, tables.color2.at(tex)), color)
    active = alive & valid
    mult = torch.where(kind == DIFFUSE_LIGHT, tables.emit[mat], torch.zeros_like(t))
    L = L + V3.where(active, T * (color * mult), zeros)

    b0 = 4 if scene.lights is not None else 0
    bsdf = _local(_onb(normal), _cosine(u[b0], u[b0 + 1]))
    if scene.lights is not None:
        n_l = scene.lights.x.shape[0]
        li = torch.clamp_max((u[1] * n_l).to(torch.int64), n_l - 1)
        center = scene.lights.at(li)
        lu, lv, _ = _onb(center - p)
        r, th = torch.sqrt(u[2]), 0.5 * PI * u[3]
        to_light = ((lu * (r * torch.cos(th)) + lv * (r * torch.sin(th))) + center - p).unit()
        use_light = u[0] < LIGHT_PROB
    else:
        to_light, use_light = bsdf, torch.zeros_like(alive)
    new_d = V3.where(use_light, to_light, bsdf)
    cos_n = new_d.dot(normal)
    val = torch.clamp_min(cos_n, 0.0) * INV_PI
    den = torch.where(use_light, _full(val, 1.0 / PI), val)
    den = torch.where((den <= 0.0) | torch.isnan(den), _full(den, 1e-5), den)
    weight = val / den
    new_o = V3.where(use_light, o + d * (t - SHADOW_EPS), p)
    T = V3.where(active, T * color * weight, T)
    alive = active & (kind != DIFFUSE_LIGHT)
    return V3.where(alive, new_o, o), V3.where(alive, new_d, d), T, L, alive


def radiance(scene: Scene, tables, image: dict, seed: int, pixel, sample) -> V3:
    """Radiance of the paths (pixel, sample): up to max_depth bounces each."""
    keys = rng.fold(rng.streams(seed, pixel), sample)
    sqrt_spp = math.isqrt(image["samples"])
    o, d = camera_rays(scene, image["width"], image["height"], sqrt_spp, pixel, sample, keys)
    T = V3(*(torch.ones_like(o.x),) * 3)
    L = V3(*(torch.zeros_like(o.x),) * 3)
    alive = torch.ones(o.x.shape, dtype=torch.bool, device=o.x.device)
    for b in range(image["max_depth"]):
        o, d, T, L, alive = shade(scene, tables, o, d, T, L, alive, rng.fold(keys, b))
    return L


def pixel_sums(scene: Scene, image: dict, seed: int, pixels: torch.Tensor,
               block: int = 1 << 19) -> V3:
    """Each pixel's radiance summed over its samples 0, 1, ... in that
    order, as the frame's table adds them; in blocks of `block` paths."""
    spp = math.isqrt(image["samples"]) ** 2
    per = max(1, block // spp)
    out = []
    with torch.no_grad():
        for s in range(0, pixels.shape[0], per):
            pix = pixels[s:s + per]
            n = pix.shape[0]
            L = radiance(scene, scene.tables, image, seed, pix.repeat(spp),
                         torch.arange(spp, device=pix.device).repeat_interleave(n))
            acc = V3(*(torch.zeros(n, dtype=scene.dtype, device=pix.device),) * 3)
            for i in range(spp):
                acc = acc + L.map(lambda a: a[i * n:(i + 1) * n])
            out.append(acc)
    return V3(*(torch.cat([a[i] for a in out]) for i in range(3)))


def display(sums: V3, spp: int) -> torch.Tensor:
    """Sums -> display colors (P, 3): the mean, non-finite to 0, clamped
    at 0, square-root gamma."""
    c = sums * (1.0 / spp)
    finite = torch.isfinite(c.x) & torch.isfinite(c.y) & torch.isfinite(c.z)
    c = c.map(lambda a: torch.sqrt(torch.clamp_min(torch.where(finite, a, torch.zeros_like(a)),
                                                   0.0)))
    return torch.stack(list(c), -1)

"""The plain reference of the Mandelbulb configuration and of the CLI's
adaptive passes, in plain PyTorch (float32 unless a control asks for
less).

The scene is a power-8 Mandelbulb in BlinnPhong under one sphere light
(the upstream previewer's `render_raymarching_test`). A ray is clipped to
the bounding sphere r = RADIUS and sphere-traced with steps of
max(STEP_SCALE * DE, 1e-5) until DE < SURF_EPS (a hit), t passes the
sphere's exit (a miss) or MAX_STEPS steps. DE = 0.5 ln(r) r / dr over
DE_ITERATIONS iterations of the orbit that starts at the origin and adds
p each iteration, bailing out at |v|^2 > BAILOUT (raymarching.rs:195-241).
The power-8 step is taken as three double-angle steps from the cosines and
sines of theta and phi, with r^8 and r^7 by repeated squaring: the same
value as the trigonometric form up to rounding, and the order of
operations the program rounds in, so that the reference traces the very
rays the program traces. The normal is the central difference of the DE
with d = NORMAL_D (raymarching.rs:79-91), uv the spherical one
(sphere.rs:64-71).

Shading is the compat estimator of `reference/render.py` with
BlinnPhong's scatter: a k_specular mixture of a cos^e lobe about the
mirror direction (four tries against the horizon, the first kept if all
fail) and a cosine lobe about the normal, and its half-vector density
(pdf.rs:176-195) as the BSDF branch's weight. Draws are keyed by (seed,
pixel, sample, bounce, purpose) as there, with the uniform slots the
program allocates for these material kinds.

The passes (raysnail.rs:379-427, without the 5x5 window's x = y bug):
pass k renders a pixel's cells with seed + k and keeps the running
average (old * k + new) / (k + 1) of display colors; a later pass redoes
the pixels whose noise, the sum over the 5x5 window of squared RGB
distance to the center (neighbours outside the image count 0), reaches
the threshold. The reference decides the redo from the program's own
image of the pass before, the only full image a check has.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference import render as ref
from benchmark.reference import rng
from benchmark.reference.scene import Camera, _camera
from benchmark.reference.vec import V3

POWER = 8.0
BAILOUT = 8.0
RADIUS = 1.3
DE_ITERATIONS = 24
MAX_STEPS = 128
SURF_EPS = 1e-3
STEP_SCALE = 0.5
NORMAL_D = 0.01
TINY = 1e-30
BIG = ref.BIG
PI, INV_PI = ref.PI, ref.INV_PI
REJECT_TRIES = 4
# the uniform slots a bounce draws in a scene of BlinnPhong and a sphere
# light: branch, pick and two for the light's point; two for the cosine
# lobe, two for each try of the cos^e lobe, one for the specular pick
BRANCH, PICK, L1, L2, BSDF = 0, 1, 2, 3, 4
SPEC_PICK = BSDF + 2 + 2 * REJECT_TRIES
N_UNIFORMS = SPEC_PICK + 1
BLINN_PHONG, DIFFUSE_LIGHT = 4, 5

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class Materials(NamedTuple):
    kind: torch.Tensor       # (M,) int64
    color: V3                # (M,) constant texture colors
    k_specular: torch.Tensor
    exponent: torch.Tensor
    emit: torch.Tensor


class BulbScene(NamedTuple):
    """The bulb (material row `bulb_mat`), the sphere lights (their rows
    `sph_mat`, world and light list at once) and the camera; the field
    names `reference/render.py`'s sphere hit and camera read."""
    dtype: torch.dtype
    device: torch.device
    bulb_mat: int
    mats: Materials
    sph_center: V3
    sph_r2: torch.Tensor
    sph_radius: torch.Tensor
    sph_mat: torch.Tensor
    lights: V3
    bg: tuple
    camera: Camera
    iterations: int


def build(config: dict, width: int, height: int, dtype=torch.float32, device="cpu",
          iterations: int | None = None) -> BulbScene:
    """The reference's scene of a Mandelbulb configuration at an image
    size, in `dtype`; `iterations` (default DE_ITERATIONS, the program's)
    sets the DE's iteration count."""
    device = torch.device(device)
    scene = config["scene"]

    def f(a):
        return torch.as_tensor(a, dtype=torch.float64).to(dtype=dtype, device=device)

    kinds, colors, ks, es, emit = [], [], [], [], []
    spheres, bulb = [], None
    for obj in scene["objects"]:
        m = obj["material"]
        if m["texture"]["kind"] != "constant":
            raise NotImplementedError(f"the bulb reference has no {m['texture']['kind']}")
        row = len(kinds)
        colors.append(m["texture"]["color"])
        if m["kind"] == "blinn_phong":
            kinds.append(BLINN_PHONG)
            ks.append(m["k_specular"])
            es.append(m["exponent"])
            emit.append(0.0)
        elif m["kind"] == "diffuse_light":
            kinds.append(DIFFUSE_LIGHT)
            ks.append(0.0)
            es.append(0.0)
            emit.append(m["multiplier"])
        else:
            raise NotImplementedError(f"the bulb reference has no {m['kind']}")
        if obj["kind"] == "mandelbulb":
            bulb = row
        elif obj["kind"] == "sphere" and obj.get("light"):
            spheres.append((obj["center"], obj["radius"], row))
        else:
            raise NotImplementedError(f"the bulb reference has no {obj['kind']}")
    if bulb is None or not spheres:
        raise ValueError("a bulb configuration holds one Mandelbulb and a sphere light")

    def vec(rows):
        return V3(*(f([r[i] for r in rows]) for i in range(3)))

    radius = f([s[1] for s in spheres])
    centers = vec([s[0] for s in spheres])
    bg = scene["background"]
    return BulbScene(
        dtype=dtype, device=device, bulb_mat=bulb,
        mats=Materials(torch.as_tensor(kinds, device=device), vec(colors), f(ks), f(es), f(emit)),
        sph_center=centers, sph_r2=radius * radius, sph_radius=radius,
        sph_mat=torch.as_tensor([s[2] for s in spheres], device=device),
        lights=centers, bg=(vec([bg["bottom"]]).at(0), vec([bg["top"]]).at(0)),
        camera=_camera(scene["camera"], width, height, dtype, device),
        iterations=DE_ITERATIONS if iterations is None else int(iterations))


# -- the march ------------------------------------------------------------------

def distance_est(px, py, pz, iterations: int = DE_ITERATIONS):
    """-> (DE, the DE iterations each point ran) at the points (px, py,
    pz). A point stops at its own escape; the points still in the orbit
    are gathered after every iteration that lets some escape."""
    n = px.shape[0]
    r_out, dr_out = torch.zeros_like(px), torch.zeros_like(px)
    iters = torch.zeros(n, dtype=torch.int64, device=px.device)
    live = torch.arange(n, device=px.device)
    x = y = z = torch.zeros_like(px)
    for _ in range(iterations):
        if live.numel() == 0:
            break
        rho2 = x * x + y * y
        r2 = rho2 + z * z
        r = torch.sqrt(r2)
        rho = torch.sqrt(rho2)
        inv_r = torch.reciprocal(torch.clamp_min(r, TINY))
        inv_rho = torch.reciprocal(torch.clamp_min(rho, TINY))
        ct = torch.where(r > TINY, z * inv_r, 1.0)
        st = torch.where(r > TINY, rho * inv_r, 0.0)
        cp = torch.where(rho > TINY, x * inv_rho, 1.0)
        sp = torch.where(rho > TINY, y * inv_rho, 0.0)
        for _angle in range(3):  # (cos a, sin a) -> (cos 2a, sin 2a): 8a after three
            ct, st = ct * ct - st * st, 2.0 * ct * st
            cp, sp = cp * cp - sp * sp, 2.0 * cp * sp
        r4 = r2 * r2
        r8 = r4 * r4
        dr = (r4 * r2 * r) * POWER * dr_out[live] + 1.0
        xn = r8 * st * cp + px[live]
        yn = r8 * st * sp + py[live]
        zn = r8 * ct + pz[live]
        escaped = xn * xn + yn * yn + zn * zn > BAILOUT
        r_out[live] = r8
        dr_out[live] = dr
        iters[live] += 1
        if bool(escaped.any()):
            stay = ~escaped
            live, xn, yn, zn = live[stay], xn[stay], yn[stay], zn[stay]
        x, y, z = xn, yn, zn
    r = torch.clamp_min(r_out, 1e-12)
    dr = torch.clamp_min(dr_out, 1e-12)
    de = 0.5 * torch.log(r) * r / dr
    return torch.where(torch.isnan(de), 0.1, de), iters


def _unit(x, y, z):
    inv = torch.reciprocal(torch.sqrt(torch.clamp_min(x * x + y * y + z * z, 1e-20)))
    return x * inv, y * inv, z * inv


def march(o: V3, d: V3, t_min: float, t_max: float, active=None,
          iterations: int = DE_ITERATIONS, counts: bool = False):
    """Rays against the bulb -> (t, valid, geometric normal V3, u, v);
    misses get t = BIG, normal (0, 0, 1) and u = v = 0. With counts=True
    also (3, N) int64: each ray's march steps, the DE iterations of its
    march and those of its normal."""
    n = o.x.shape[0]
    device = o.x.device
    half_b = d.x * o.x + d.y * o.y + d.z * o.z
    c = (o.x * o.x + o.y * o.y + o.z * o.z) - RADIUS * RADIUS
    delta = half_b * half_b - c
    sq = torch.sqrt(torch.clamp_min(delta, 0.0))
    t_enter = torch.clamp_min(-half_b - sq, t_min)
    t_exit = -half_b + sq
    inside = (delta > 0.0) & (t_exit > t_min) & (t_enter < t_max)
    if active is not None:
        inside = inside & active
    t = torch.where(inside, t_enter, BIG)
    hit = torch.zeros(n, dtype=torch.bool, device=device)
    tally = torch.zeros((3, n), dtype=torch.int64, device=device)
    live = torch.nonzero(inside).reshape(-1)
    for _ in range(MAX_STEPS):
        if live.numel() == 0:
            break
        tl = t[live]
        de, it = distance_est(o.x[live] + d.x[live] * tl, o.y[live] + d.y[live] * tl,
                              o.z[live] + d.z[live] * tl, iterations)
        reached = de < SURF_EPS
        beyond = tl > t_exit[live]
        t[live] = tl + torch.clamp_min(de * STEP_SCALE, 1e-5)
        tally[0, live] += 1
        tally[1, live] += it
        hit[live[reached]] = True
        live = live[~(reached | beyond)]

    valid = hit & (t > t_min) & (t < t_max)
    t = torch.where(valid, t, BIG)
    nx, ny, u, v = (torch.zeros(n, dtype=t.dtype, device=device) for _ in range(4))
    nz = torch.ones_like(nx)
    at = torch.nonzero(valid).reshape(-1)
    if at.numel():
        tv = t[at]
        px, py, pz = o.x[at] + d.x[at] * tv, o.y[at] + d.y[at] * tv, o.z[at] + d.z[at] * tv
        m = at.numel()
        de, it = distance_est(
            torch.cat([px + NORMAL_D, px - NORMAL_D, px, px, px, px]),
            torch.cat([py, py, py + NORMAL_D, py - NORMAL_D, py, py]),
            torch.cat([pz, pz, pz, pz, pz + NORMAL_D, pz - NORMAL_D]), iterations)
        de = de.reshape(6, m)
        nx[at], ny[at], nz[at] = _unit(de[0] - de[1], de[2] - de[3], de[4] - de[5])
        tally[2, at] = it.reshape(6, m).sum(0)
        qx, qy, qz = _unit(px, py, pz)
        u[at] = torch.atan2(-qz, qx) / torch.full_like(qx, 2.0 * PI) + 0.5
        v[at] = torch.asin(torch.clamp(qy, -1.0, 1.0)) / torch.full_like(qy, PI) + 0.5
    out = (t, valid, V3(nx, ny, nz), u, v)
    return out + (tally,) if counts else out


# -- shading --------------------------------------------------------------------

def intersect(scene: BulbScene, o: V3, d: V3, alive):
    """-> (t, valid, normal facing the ray, material row): the sphere
    lights, then the bulb where it is strictly nearer; a dead lane's march
    is skipped."""
    t, valid, n, mat = ref._sphere_hit(scene, o, d)
    n = V3.where(d.dot(n) < 0.0, n, -n)
    tb, vb, nb, _, _ = march(o, d, ref.T_MIN, ref.T_MAX, alive, scene.iterations)
    nb = V3.where(d.dot(nb) < 0.0, nb, -nb)
    take = tb < t
    return (torch.where(take, tb, t), torch.where(take, vb, valid), V3.where(take, nb, n),
            torch.where(take, torch.full_like(mat, scene.bulb_mat), mat))


def _power_lobe(e, u1, u2) -> V3:
    """A cos^e lobe about +z (vec3.rs:114-126)."""
    z = torch.pow(u2, 1.0 / (e + 1.0))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * PI * u1
    return V3(torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, z)


def _blinn_phong_dir(d: V3, normal: V3, k, e, u) -> V3:
    """BlinnPhong's generated direction: the cos^e lobe about the mirror
    direction where u[SPEC_PICK] < k_specular, else the cosine lobe about
    the normal."""
    diffuse = ref._local(ref._onb(normal), ref._cosine(u[BSDF], u[BSDF + 1]))
    about = ref._onb(d - normal * (2.0 * d.dot(normal)))
    lobe = ref._local(about, _power_lobe(e, u[BSDF + 2], u[BSDF + 3]))
    kept = lobe.dot(normal) > 0.0
    for i in range(1, REJECT_TRIES):
        cand = ref._local(about, _power_lobe(e, u[BSDF + 2 + 2 * i], u[BSDF + 3 + 2 * i]))
        take = ~kept & (cand.dot(normal) > 0.0)
        lobe = V3.where(take, cand, lobe)
        kept = kept | take
    return V3.where(u[SPEC_PICK] < k, lobe, diffuse)


def _blinn_phong_pdf(d: V3, normal: V3, direction: V3, k, e):
    """The compat estimator's density of BlinnPhong (pdf.rs:176-195): the
    cosine term and the half-vector lobe over 4 (-d . h)."""
    cos_n = direction.dot(normal)
    h = (direction - d).unit()
    cos_h = torch.clamp_min(h.dot(normal), 0.0)
    lobe = ((e + 1.0) / torch.full_like(e, 2.0 * PI)) * torch.pow(
        torch.clamp_min(cos_h, 1e-12), e)
    den = (-d).dot(h)
    den = torch.where(torch.abs(den) < 1e-6, torch.full_like(den, 1e-6), den)
    return torch.clamp_min(cos_n * INV_PI, 0.0) * (1.0 - k) + lobe / (4.0 * den) * k


def shade(scene: BulbScene, o: V3, d: V3, T: V3, L: V3, alive, kb):
    """One bounce of every lane: (o, d, T, L, alive) after it."""
    t, valid, normal, mat = intersect(scene, o, d, alive)
    zeros = V3(*(torch.zeros_like(t),) * 3)
    bg0, bg1 = scene.bg
    s = 0.5 * (d.y + 1.0)
    L = L + V3.where(alive & ~valid, T * (bg0 * (1.0 - s) + bg1 * s), zeros)
    u = rng.uniforms(rng.fold(kb, rng.SCATTER), N_UNIFORMS, t.dtype)
    mats = scene.mats
    kind, color = mats.kind[mat], mats.color.at(mat)
    k, e = mats.k_specular[mat], mats.exponent[mat]
    p = o + d * t
    active = alive & valid
    mult = torch.where(kind == DIFFUSE_LIGHT, mats.emit[mat], torch.zeros_like(t))
    L = L + V3.where(active, T * (color * mult), zeros)

    bsdf = _blinn_phong_dir(d, normal, k, e, u)
    n_l = scene.lights.x.shape[0]
    li = torch.clamp_max((u[PICK] * n_l).to(torch.int64), n_l - 1)
    center = scene.lights.at(li)
    lu, lv, _ = ref._onb(center - p)
    r, th = torch.sqrt(u[L1]), 0.5 * PI * u[L2]
    to_light = ((lu * (r * torch.cos(th)) + lv * (r * torch.sin(th))) + center - p).unit()
    use_light = u[BRANCH] < ref.LIGHT_PROB
    new_d = V3.where(use_light, to_light, bsdf)
    lambert = torch.clamp_min(new_d.dot(normal), 0.0) * INV_PI
    val = torch.where(kind == BLINN_PHONG, _blinn_phong_pdf(d, normal, new_d, k, e), lambert)
    den = torch.where(use_light, torch.full_like(val, 1.0 / PI), val)
    den = torch.where((den <= 0.0) | torch.isnan(den), torch.full_like(den, 1e-5), den)
    weight = val / den
    new_o = V3.where(use_light, o + d * (t - ref.SHADOW_EPS), p)
    T = V3.where(active, T * color * weight, T)
    alive = active & (kind != DIFFUSE_LIGHT)
    return V3.where(alive, new_o, o), V3.where(alive, new_d, d), T, L, alive


def radiance(scene: BulbScene, image: dict, streams, pixel, sample) -> V3:
    """Radiance of the paths (pixel, sample) whose pixel streams (under
    their pass's seed) are `streams`: up to max_depth bounces each."""
    keys = rng.fold(streams, sample)
    sqrt_spp = math.isqrt(image["samples"])
    o, d = ref.camera_rays(scene, image["width"], image["height"], sqrt_spp, pixel, sample,
                           keys)
    T = V3(*(torch.ones_like(o.x),) * 3)
    L = V3(*(torch.zeros_like(o.x),) * 3)
    alive = torch.ones(o.x.shape, dtype=torch.bool, device=o.x.device)
    for b in range(image["max_depth"]):
        o, d, T, L, alive = shade(scene, o, d, T, L, alive, rng.fold(keys, b))
    return L


def effective_samples(image: dict) -> int:
    return math.isqrt(image["samples"]) ** 2


def cell_sums(scene: BulbScene, image: dict, seeds, pixels, block: int = 1 << 17) -> V3:
    """Each (seed, pixel) pair's radiance summed over its samples 0, 1, ...
    in that order; the paths of all pairs in blocks of `block`. `seeds`
    is a list of frame seeds in [0, 2^32), one a pixel."""
    spp = effective_samples(image)
    per = max(1, block // spp)
    device = scene.device
    bases = torch.as_tensor([(int(s) * rng.PHI) & rng.MASK for s in seeds], dtype=torch.int64,
                            device=device)
    pixels = torch.as_tensor(pixels, dtype=torch.int64, device=device)
    streams = rng.fmix32(bases ^ ((pixels * rng.PHI) & rng.MASK))
    out = []
    with torch.no_grad():
        for s in range(0, pixels.shape[0], per):
            pix, st = pixels[s:s + per], streams[s:s + per]
            n = pix.shape[0]
            L = radiance(scene, image, st.repeat(spp), pix.repeat(spp),
                         torch.arange(spp, device=device).repeat_interleave(n))
            acc = V3(*(torch.zeros(n, dtype=scene.dtype, device=device),) * 3)
            for i in range(spp):
                acc = acc + L.map(lambda a: a[i * n:(i + 1) * n])
            out.append(acc)
    return V3(*(torch.cat([a[i] for a in out]) for i in range(3)))


# -- the passes -----------------------------------------------------------------

def noise(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) display image -> (H, W) noise: the sum over the 5x5 window
    of the squared RGB distance to the center, in window order; a
    neighbour outside the image counts 0."""
    h, w, _ = img.shape
    out = torch.zeros((h, w), dtype=img.dtype, device=img.device)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            diff = torch.zeros_like(img)
            ys, yd = slice(max(0, dy), h + min(0, dy)), slice(max(0, -dy), h + min(0, -dy))
            xs, xd = slice(max(0, dx), w + min(0, dx)), slice(max(0, -dx), w + min(0, -dx))
            diff[yd, xd] = img[yd, xd] - img[ys, xs]
            sq = diff * diff
            out = out + ((sq[..., 0] + sq[..., 1]) + sq[..., 2])
    return out


def redo_masks(images, threshold: float, passes: int) -> list:
    """The pixels each later pass redoes, (H * W,) bools, from the noise of
    the program's image of the pass before; the list stops where a pass
    would redo none (the program then stops too) or where the program's
    images end."""
    masks = []
    for k in range(1, passes):
        if k > len(images):
            break
        redo = (noise(images[k - 1]) >= threshold).reshape(-1)
        if not bool(redo.any()):
            break
        masks.append(redo)
    return masks


def display_cells(scene: BulbScene, image: dict, cells) -> list:
    """[(seed, pixels)] -> the pixels' display colors (P, 3) in float32
    under each seed, all cells' paths in one batch."""
    if not cells:
        return []
    seeds = [int(seed) for seed, pix in cells for _ in range(pix.shape[0])]
    sizes = [pix.shape[0] for _, pix in cells]
    sums = cell_sums(scene, image, seeds, torch.cat([pix for _, pix in cells]))
    return list(torch.split(ref.display(sums, effective_samples(image)).float(), sizes))


def pass_cells(seed: int, pixels, masks, same_seed: bool = False):
    """-> (cells, where): the (seed, pixels) cells that the passes render
    of `pixels` (pass 0 every pixel, pass k those its mask holds, with seed
    + k, or the frame's seed with same_seed) and each pass's positions in
    `pixels`."""
    where = [torch.arange(pixels.shape[0], device=pixels.device)]
    where += [torch.nonzero(m[pixels]).reshape(-1) for m in masks]
    return [(seed if same_seed else seed + k, pixels[w]) for k, w in enumerate(where)], where


def running_average(news, where) -> torch.Tensor:
    """The passes' colors folded in pass order: (old * k + new) / (k + 1)."""
    avg = news[0].clone()
    for k, (w, new) in enumerate(zip(where[1:], news[1:]), start=1):
        avg[w] = (avg[w] * k + new) / torch.full_like(new, k + 1.0)
    return avg


def pass_averages(scene: BulbScene, image: dict, frames, same_seed: bool = False) -> list:
    """[(seed, pixels, masks)] -> each frame's (P, 3) display colors of its
    pixels after the passes, every frame's paths in one batch."""
    plans = [pass_cells(seed, pix, masks, same_seed) for seed, pix, masks in frames]
    news = display_cells(scene, image, [c for cells, _ in plans for c in cells])
    out, at = [], 0
    for cells, where in plans:
        out.append(running_average(news[at:at + len(cells)], where))
        at += len(cells)
    return out

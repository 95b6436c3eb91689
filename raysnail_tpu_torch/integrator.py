"""The wavefront path-tracing integrator.

The reference's recursive `ray_color` (src/camera.rs:156-255) as a bounce
body over a dense ray batch with masked lanes, driven by the shuffled
path-regeneration loop: when a lane's path dies it starts its next cell in
place, so the loop runs for about spp x the mean path length iterations
instead of spp x max_depth.

Estimator (compat path, the default — camera.rs:194-247):
  * emitted term added every bounce (before scattering);
  * skip_pdf materials (metal, dielectric): follow the specular ray,
    throughput *= albedo;
  * otherwise a 50/50 branch:
      - light branch: direction toward a random light, denominator pdf
        HARDCODED to 1/pi (camera.rs:199), shadow origin backed off along the
        incoming ray by shadow_eps (camera.rs:208-212), optional phong
        highlight multiplier (camera.rs:199-206);
      - BSDF branch: sample the material's pdf; numerator == denominator so
        the weight is exactly 1 (camera.rs:216-218, 240-242);
    weight = pdf.value(dir) / pdf_val with the reference's <=0/NaN clamp of
    the denominator to 1e-5 (camera.rs:236-238).
  * miss -> background gradient, ray dies (camera.rs:254).

cfg.proper_mis selects the physically-correct one-sample MIS estimator
(0.5*(p_light + p_bsdf) in the denominator with the true solid-angle light
pdf).
"""

from __future__ import annotations

import torch

from raysnail_tpu_torch import lights as lightslib
from raysnail_tpu_torch import materials as matlib
from raysnail_tpu_torch import scene as scenelib
from raysnail_tpu_torch import textures as texlib
from raysnail_tpu_torch.camera import Ray, generate_rays
from raysnail_tpu_torch.config import RenderConfig
from raysnail_tpu_torch.prelude import rng as prng
from raysnail_tpu_torch.prelude.sampling import PI
from raysnail_tpu_torch.prelude.vec import Vec3


def _slot_layout(kinds: frozenset, has_lights: bool, mix_depth: int = 1):
    """Per-bounce uniform slots, allocated only for the material/light kinds
    the scene contains (a pure Lambertian scene draws 6 uniforms per bounce
    instead of 17). Nested Mixed materials draw one uniform per level
    (mixed_material.rs:41-50)."""
    idx = {}
    n = 0
    if matlib.MIXED in kinds:
        idx["mix"] = n
        n += mix_depth
    if has_lights:
        idx["branch"], idx["pick"], idx["l1"], idx["l2"] = n, n + 1, n + 2, n + 3
        n += 4
    if matlib.DIELECTRIC in kinds:
        idx["refl"] = n
        n += 1
    idx["bsdf"] = n
    n += 2  # base cosine / sphere sample
    if (matlib.DIFFUSE_METAL in kinds) or (matlib.BLINN_PHONG in kinds):
        n += 2 * matlib.REJECT_TRIES
    if matlib.BLINN_PHONG in kinds:
        n += 1
    return idx, n


def _make_shade(scene: scenelib.Scene, cfg: RenderConfig):
    """One bounce of the estimator: (arrays, o, d, T, L, alive, kb) ->
    (new_o, new_d, T, L, alive). Dead lanes keep their incoming ray state."""
    static = scene.static
    kinds = static.mat_kinds
    slot, n_uniforms = _slot_layout(kinds, static.has_lights, static.mix_depth)

    def shade(arrays: scenelib.SceneArrays, o: Vec3, d: Vec3, T: Vec3, L: Vec3,
              alive, kb):
        zeros = Vec3.zeros(d.x.shape, T.x.dtype, T.x.device)
        hit = scenelib.intersect(scene, arrays, Ray(o, d, None), cfg.t_min, cfg.t_max)

        # miss -> background, die (camera.rs:254)
        bg = arrays.background.color(d)
        missed = alive & (~hit.valid)
        L = L + Vec3.where(missed, T * bg, zeros)

        u = prng.ray_uniforms(prng.fold_all(kb, prng.SCATTER), n_uniforms, T.x.dtype)

        if matlib.MIXED in kinds:
            mat_id = matlib.resolve(arrays.materials, hit.mat_id,
                                    u[slot["mix"]:slot["mix"] + static.mix_depth],
                                    depth=static.mix_depth)
        else:
            mat_id = torch.clamp_min(hit.mat_id, 0)
        rows = matlib.gather(arrays.materials, mat_id)
        p = o + d * hit.t
        tex_color = texlib.evaluate(arrays.textures, rows.tex_id, hit.u, hit.v, p,
                                    static.tex_modes)

        active = alive & hit.valid
        emit = matlib.emitted(rows, tex_color)
        L = L + Vec3.where(active, T * emit, zeros)

        if static.has_absorb:
            # EXTENSION (off unless a Dielectric sets `absorption`): the
            # segment that just ended INSIDE a dielectric (back-face hit)
            # attenuates by Beer-Lambert exp(-sigma * t)
            sigma = matlib.gather_absorb(arrays.materials, mat_id)
            interior = active & (~hit.outside) & (rows.mtype == matlib.DIELECTRIC)
            T = Vec3.where(interior, T * (sigma * (-hit.t)).map(torch.exp), T)

        # -- specular (skip_pdf) path ------------------------------------
        skip = matlib.is_skip_pdf(rows)
        u_refl = u[slot["refl"]] if "refl" in slot else hit.t  # unused if absent
        spec_dir, absorbed = matlib.specular_dir(rows, d, hit.normal, hit.outside,
                                                 u_refl, kinds)

        # -- pdf path ------------------------------------------------------
        bsdf_dir = matlib.bsdf_sample(rows, d, hit.normal, u[slot["bsdf"]:], kinds)
        if static.has_lights:
            sampler = lightslib.sample_proper if cfg.proper_mis else lightslib.sample
            light_raw = sampler(arrays.lights, p, u[slot["pick"]], u[slot["l1"]],
                                u[slot["l2"]], static.light_kinds)
            light_dir = light_raw.unit()
            use_light = u[slot["branch"]] < cfg.light_sample_prob
            light_multi = matlib.phong_highlight(light_dir, d, hit.normal, rows)
        else:
            light_dir = bsdf_dir
            use_light = torch.zeros_like(alive)
            light_multi = torch.ones_like(hit.t)

        pdf_dir = Vec3.where(use_light, light_dir, bsdf_dir)
        val = matlib.bsdf_pdf_value(rows, d, hit.normal, pdf_dir, kinds,
                                    proper=cfg.proper_mis)

        if cfg.proper_mis and static.has_lights:
            # one-sample MIS: denominator = the true mixture density of the
            # combined sampler, with the real solid-angle light pdf
            p_light = lightslib.pdf_value(arrays.lights, p, pdf_dir, static.light_kinds)
            denom = (cfg.light_sample_prob * p_light
                     + (1.0 - cfg.light_sample_prob) * val)
        else:
            # compat: light branch denominator hardcoded to 1/pi
            denom = torch.where(use_light, torch.full_like(val, 1.0 / PI), val)
        denom = torch.where((denom <= 0.0) | torch.isnan(denom),
                            torch.full_like(denom, 1e-5), denom)
        weight = val / denom
        multi = torch.where(use_light, light_multi, torch.ones_like(light_multi))

        # shadow back-off start for the light branch (camera.rs:208-212)
        pdf_origin = Vec3.where(use_light, o + d * (hit.t - cfg.shadow_eps), p)

        new_d = Vec3.where(skip, spec_dir, pdf_dir)
        new_o = Vec3.where(skip, p, pdf_origin)
        t_mult = torch.where(skip, torch.ones_like(weight), weight * multi)
        T = Vec3.where(active, T * tex_color * t_mult, T)

        scatters = rows.mtype != matlib.DIFFUSE_LIGHT
        alive = active & scatters & ~(skip & absorbed)

        o = Vec3.where(alive, new_o, o)
        d = Vec3.where(alive, new_d, d)
        return o, d, T, L, alive

    return shade


def chunk_width(spp: int, cap: int) -> int:
    """The largest divisor of spp that is <= cap."""
    return max(c for c in range(1, min(spp, cap) + 1) if spp % c == 0)


def radiance_regen_shuffle(scene: scenelib.Scene, arrays: scenelib.SceneArrays,
                           cfg: RenderConfig, camera, seed: int, spp: int, s0: int = 0):
    """Full-frame path regeneration with cross-pixel cell SHUFFLING:
    row-major radiance sums over stratification cells [s0, s0 + spp).

    Lane i's k-th cell of a chunk is pixel (i + k*S) mod N for a
    golden-ratio stride S, so a lane's total path length is a sum over C
    cells of different pixels, which concentrates and keeps the loop's trip
    count near C x the mean path length. Per-cell radiance lands in an
    (N, C) column table by an indexed add; the pixel sums come back with C
    rolls, added in the same order as the JAX package adds them. Draws are
    keyed by (seed, pixel, sample, bounce), so the estimate equals the JAX
    package's.

    The loop's condition is read on the host once per iteration.

    Returns (L_sums row-major (N,) Vec3, n_iterations)."""
    n_pix = cfg.width * cfg.height
    dtype = cfg.dtype
    device = scene.device
    sqrt_spp = cfg.sqrt_spp
    if cfg.max_depth <= 0 or spp <= 0:
        return Vec3.zeros((n_pix,), dtype, device), 0
    shade = _make_shade(scene, cfg)

    C = chunk_width(spp, cfg.chunk_cap)
    n_chunks = spp // C
    # golden-ratio stride: a lane's consecutive cells land on far-apart
    # pixels, decorrelating their path lengths
    S = (int(n_pix * 0.6180339887) | 1) % n_pix
    lanes = torch.arange(n_pix, dtype=torch.int64, device=device)

    def lane_pixel(k):
        """Rotated lane slot -> (pixel id, px, py)."""
        p = (lanes + k * S) % n_pix
        return p, (p % cfg.width).to(dtype), (p // cfg.width).to(dtype)

    def lane_keys(k, cs0):
        p, px, py = lane_pixel(k)
        return prng.fold_all(prng.fast_streams(seed, p), cs0 + k), px, py

    def new_ray(k, cs0):
        keys_s, px, py = lane_keys(k, cs0)
        sid = cs0 + k
        s_i = (sid % sqrt_spp).to(dtype)
        s_j = (sid // sqrt_spp).to(dtype)
        return generate_rays(camera, px, py, s_i, s_j, sqrt_spp, cfg.width,
                             cfg.height, keys_s)

    L_pix = Vec3.zeros((n_pix,), dtype, device)
    iterations = 0
    for chunk in range(n_chunks):
        cs0 = s0 + chunk * C
        k = torch.zeros(n_pix, dtype=torch.int64, device=device)
        b = torch.zeros(n_pix, dtype=torch.int64, device=device)
        r0 = new_ray(k, cs0)
        o, d = r0.origin, r0.direction
        T = Vec3.ones((n_pix,), dtype, device)
        table = torch.zeros((3, n_pix * C), dtype=dtype, device=device)
        alive = torch.ones(n_pix, dtype=torch.bool, device=device)
        zeros = Vec3.zeros((n_pix,), dtype, device)

        while bool((k < C).any()):
            keys_s, _, _ = lane_keys(k, cs0)
            kb = prng.fold_all(keys_s, b)
            o, d, T, L_add, alive2 = shade(arrays, o, d, T, zeros, alive, kb)
            # cell (lane, k) of the (N, C) table; a finished lane (k == C)
            # adds zero radiance, so its column is clamped
            cell = lanes * C + torch.clamp_max(k, C - 1)
            table.index_add_(1, cell, torch.stack([L_add.x, L_add.y, L_add.z]))
            # a path at its final bounce contributes nothing more
            # (camera.rs:161-163): it is done the moment it is shaded
            alive2 = alive2 & (b + 1 < cfg.max_depth)
            done = alive & (~alive2)
            k = k + done.to(torch.int64)
            regen = done & (k < C)
            rn = new_ray(k, cs0)
            o = Vec3.where(regen, rn.origin, o)
            d = Vec3.where(regen, rn.direction, d)
            T = Vec3.where(regen, Vec3.ones((n_pix,), dtype, device), T)
            b = torch.where(alive2, b + 1, torch.zeros_like(b))
            alive = alive2 | regen
            iterations += 1

        # regroup: column c's row i is lane slot (i + c*S) mod N -> roll
        # forward to pixel order
        table = table.view(3, n_pix, C)
        for c in range(C):
            shift = (c * S) % n_pix
            L_pix = L_pix + Vec3(*(torch.roll(table[a, :, c], shift) for a in range(3)))
    return L_pix, iterations

"""L2 material table: branch-free scatter over the whole ray batch.

Materials are rows of a SoA table; sampling and pdf evaluation compute
every material kind present in the scene for the full batch and select by
the per-ray material type. Rows are fetched with index gathers.

Material kinds and reference behavior:
  LAMBERTIAN    CosinePdf about the normal               lambertian.rs:39-50
  METAL         mirror reflect, skip_pdf, absorb if refl.n<=0  metal.rs:104-118
  DIFFUSE_METAL cos^e lobe about the reflected dir        metal.rs:54-68
  DIELECTRIC    Snell refract + TIR + optional Schlick, skip_pdf
                                                          dielectric.rs:55-93
  BLINN_PHONG   k_specular mixture of cos^e half-vector lobe and cosine
                                                          blinn_phong.rs:32-42
  DIFFUSE_LIGHT emissive only (both faces)                light.rs:31-40
  ISOTROPIC     uniform sphere scatter                    isotropic.rs:26-33
  MIXED         stochastic blend of two rows              mixed_material.rs:41-50
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raysnail_tpu_torch.prelude import sampling
from raysnail_tpu_torch.prelude.sampling import INV_PI, PI
from raysnail_tpu_torch.prelude.vec import Vec3, div_const, take

LAMBERTIAN = 0
METAL = 1
DIFFUSE_METAL = 2
DIELECTRIC = 3
BLINN_PHONG = 4
DIFFUSE_LIGHT = 5
ISOTROPIC = 6
MIXED = 7

# bounded replacement for the reference's unbounded hemisphere-rejection
# loops (pdf.rs:130-140, 196-207): tries with fresh uniforms, keep the first
# valid
REJECT_TRIES = 4


class MaterialTable(NamedTuple):
    mtype: torch.Tensor          # (M,) int32
    tex_id: torch.Tensor         # (M,) int32 albedo texture
    param0: torch.Tensor         # (M,) DiffuseMetal exponent | Dielectric ior | BlinnPhong k_specular
    param1: torch.Tensor         # (M,) BlinnPhong exponent | Dielectric use-Schlick flag
    emit_mult: torch.Tensor      # (M,) DiffuseLight multiplier
    phong_factor: torch.Tensor   # (M,) CommonMaterialSettings (mod.rs:41-54)
    phong_exponent: torch.Tensor # (M,) stored as float; reference powi
    mix_prob: torch.Tensor       # (M,) MixedMaterial probability of row mix_a
    mix_a: torch.Tensor          # (M,) int32
    mix_b: torch.Tensor          # (M,) int32
    # EXTENSION: Beer-Lambert absorption for dielectric interiors; None when
    # no material uses it (the integrator then skips the term)
    absorb: Vec3 | None = None


class Rows(NamedTuple):
    """Per-ray gathered material properties."""
    mtype: torch.Tensor
    tex_id: torch.Tensor
    param0: torch.Tensor
    param1: torch.Tensor
    emit_mult: torch.Tensor
    phong_factor: torch.Tensor
    phong_exponent: torch.Tensor


def resolve(table: MaterialTable, mat_id, u_mix, default_id: int = 0, depth: int = 1):
    """Map -1 (no material) to the world default row and resolve MIXED rows
    by sampling (mixed_material.rs:41-50), one uniform of `u_mix` per
    nesting level. -> int64 row ids."""
    m = torch.where(mat_id < 0, torch.full_like(mat_id, default_id), mat_id).long()
    for lvl in range(depth):
        is_mix = table.mtype[m] == MIXED
        picked = torch.where(u_mix[lvl] < table.mix_prob[m], table.mix_a[m],
                             table.mix_b[m]).long()
        m = torch.where(is_mix, picked, m)
    return m


def gather(table: MaterialTable, mat_id) -> Rows:
    """Per-ray material rows by index (the float rows by `take`, whose
    backward is the one the gradient step can afford)."""
    m = mat_id.long()
    return Rows(mtype=table.mtype[m], tex_id=table.tex_id[m], param0=take(table.param0, m),
                param1=take(table.param1, m), emit_mult=take(table.emit_mult, m),
                phong_factor=take(table.phong_factor, m),
                phong_exponent=table.phong_exponent[m])


def gather_absorb(table: MaterialTable, mat_id) -> Vec3:
    """Per-ray Beer-Lambert absorption coefficients (extension)."""
    return table.absorb[mat_id.long()]


def is_skip_pdf(rows: Rows):
    return (rows.mtype == METAL) | (rows.mtype == DIELECTRIC)


def emitted(rows: Rows, tex_color: Vec3) -> Vec3:
    """DiffuseLight emission (light.rs:31-40); zero for everything else."""
    mult = torch.where(rows.mtype == DIFFUSE_LIGHT, rows.emit_mult,
                       torch.zeros_like(rows.emit_mult))
    return tex_color * mult


def _reject_sample(axis_onb: sampling.Onb, normal: Vec3, exponent, uniforms):
    """cos^e lobe about `axis`, rejecting directions below the surface
    horizon — bounded K-try version of pdf.rs:130-140."""
    d = axis_onb.local(sampling.cosine_power_direction(exponent, uniforms[0], uniforms[1]))
    accepted = d.dot(normal) > 0.0
    for k in range(1, REJECT_TRIES):
        cand = axis_onb.local(
            sampling.cosine_power_direction(exponent, uniforms[2 * k], uniforms[2 * k + 1]))
        take = (~accepted) & (cand.dot(normal) > 0.0)
        d = Vec3.where(take, cand, d)
        accepted = accepted | take
    # every try failed: keep the first candidate (rare; the reference would
    # keep spinning)
    return d


def bsdf_sample(rows: Rows, ray_dir: Vec3, normal: Vec3, uniforms, kinds: frozenset) -> Vec3:
    """srec.pdf.generate for every pdf-driven material kind; `uniforms` is a
    sequence of >= 2*REJECT_TRIES + 3 U[0,1) tensors."""
    onb_n = sampling.onb_from_w(normal)
    d = onb_n.local(sampling.cosine_direction(uniforms[0], uniforms[1]))  # LAMBERTIAN

    if (DIFFUSE_METAL in kinds) or (BLINN_PHONG in kinds):
        reflected = ray_dir.reflect(normal)
        onb_r = sampling.onb_from_w(reflected)
        if DIFFUSE_METAL in kinds:
            lobe = _reject_sample(onb_r, normal, rows.param0, uniforms[2:])
            d = Vec3.where(rows.mtype == DIFFUSE_METAL, lobe, d)
        if BLINN_PHONG in kinds:
            lobe_bp = _reject_sample(onb_r, normal, rows.param1, uniforms[2:])
            u_spec = uniforms[2 + 2 * REJECT_TRIES]
            bp = Vec3.where(u_spec < rows.param0, lobe_bp, d)
            d = Vec3.where(rows.mtype == BLINN_PHONG, bp, d)

    if ISOTROPIC in kinds:
        sph = sampling.unit_sphere_direction(uniforms[0], uniforms[1])
        d = Vec3.where(rows.mtype == ISOTROPIC, sph, d)
    return d


def _lobe(e, cos_r):
    return div_const(e + 1.0, 2.0 * PI) * torch.pow(torch.clamp_min(cos_r, 1e-12), e)


def bsdf_pdf_value(rows: Rows, ray_dir: Vec3, normal: Vec3, direction: Vec3,
                   kinds: frozenset, proper: bool = False):
    """srec.pdf.value(direction) for every pdf-driven kind present.

    proper=False replicates the reference's densities (numerator and
    BSDF-branch denominator of the compat estimator): DiffuseMetal's
    ReflectionPdf.value ignores the exponent (pdf.rs:112-120) and
    BlinnPhong evaluates a half-vector density (pdf.rs:176-195).
    proper=True returns the true density of what bsdf_sample draws, for an
    unbiased one-sample-MIS denominator. The horizon-rejection
    renormalization of the lobe is ignored in both modes, as in the
    reference."""
    cos_n = direction.dot(normal)
    val = torch.clamp_min(cos_n, 0.0) * INV_PI  # LAMBERTIAN (pdf.rs:34-43)

    if (DIFFUSE_METAL in kinds) or (BLINN_PHONG in kinds):
        reflected = ray_dir.reflect(normal).unit()
        cos_r = torch.clamp_min(direction.dot(reflected), 0.0)
        if DIFFUSE_METAL in kinds:
            dm = _lobe(rows.param0, cos_r) if proper else cos_r * INV_PI
            val = torch.where(rows.mtype == DIFFUSE_METAL, dm, val)
        if BLINN_PHONG in kinds:
            e = rows.param1
            k = rows.param0
            if proper:
                bp = k * _lobe(e, cos_r) + (1.0 - k) * torch.clamp_min(cos_n, 0.0) * INV_PI
            else:
                h = (direction - ray_dir).unit()
                cos_spec = torch.clamp_min(h.dot(normal), 0.0)
                normal_pdf = _lobe(e, cos_spec)
                denom = (-ray_dir).dot(h)
                denom = torch.where(torch.abs(denom) < 1e-6, torch.full_like(denom, 1e-6),
                                    denom)
                bp = (torch.clamp_min(cos_n * INV_PI, 0.0) * (1.0 - k)
                      + normal_pdf / (4.0 * denom) * k)
            val = torch.where(rows.mtype == BLINN_PHONG, bp, val)

    if ISOTROPIC in kinds:
        val = torch.where(rows.mtype == ISOTROPIC, torch.full_like(val, 1.0 / (4.0 * PI)),
                          val)
    return val


def specular_dir(rows: Rows, ray_dir: Vec3, normal: Vec3, outside, u_reflect,
                 kinds: frozenset):
    """skip_pdf materials: (direction, absorbed).

    METAL: mirror reflection, absorbed when reflected.n <= 0 (metal.rs:104-118).
    DIELECTRIC: Snell refraction with TIR and optional Schlick reflection
    probability (dielectric.rs:17-25, 55-93)."""
    reflected = ray_dir.reflect(normal)
    d = reflected
    absorbed = torch.zeros(u_reflect.shape, dtype=torch.bool, device=u_reflect.device)

    if METAL in kinds:
        absorbed = torch.where(rows.mtype == METAL, reflected.dot(normal) <= 0.0, absorbed)

    if DIELECTRIC in kinds:
        ior = rows.param0
        refractive = torch.where(outside, 1.0 / ior, ior)
        cos_theta = (-ray_dir).dot(normal)
        sin_theta = torch.sqrt(torch.clamp_min(1.0 - cos_theta * cos_theta, 0.0))
        tir = refractive * sin_theta > 1.0

        r0 = (1.0 - refractive) / (1.0 + refractive)
        r0 = r0 * r0
        schlick = r0 + (1.0 - r0) * torch.pow(torch.clamp_min(1.0 - cos_theta, 0.0), 5.0)
        reflect_prob = torch.where(rows.param1 > 0.5, schlick, torch.zeros_like(schlick))
        do_reflect = tir | (u_reflect < reflect_prob)

        r_par = (ray_dir + normal * cos_theta) * refractive
        r_perp = normal * (-torch.sqrt(torch.clamp_min(1.0 - r_par.length_squared(), 0.0)))
        refracted = (r_par + r_perp).unit()
        diel = Vec3.where(do_reflect, reflected, refracted)
        d = Vec3.where(rows.mtype == DIELECTRIC, diel, d)
    return d, absorbed


def phong_highlight(dir_to_light: Vec3, ray_dir: Vec3, normal: Vec3, rows: Rows):
    """Direct-light phong highlight multiplier (camera.rs:94-100, applied at
    camera.rs:199-206 with the NEGATED dir-to-light)."""
    d = -dir_to_light
    reflected = d - normal * (2.0 * d.dot(normal))
    spec = torch.clamp_min(reflected.dot(-ray_dir), 0.0)
    term = torch.pow(spec, rows.phong_exponent) * rows.phong_factor
    return torch.where(rows.phong_factor > 0.0, 1.0 + term, torch.ones_like(term))

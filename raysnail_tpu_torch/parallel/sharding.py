"""Sharded render and train steps over a (tile, sample) mesh of ranks.

The JAX package's `parallel/sharding.py` on torch.distributed:
  * the scene, the camera and the parameters are on every rank whole;
  * the flat pixel list is split over "tile", the stratification cells over
    "sample": each rank renders its (pixel slice x cell slice) block, and
    the partial radiance sums meet in an all_reduce over the sample group;
    the tiles then meet in an all_gather over the tile group, so that every
    rank returns the whole result, as `shard_map`'s global outputs;
  * the train step computes the global L2 loss and sums the parameters'
    gradients over every rank.
The callers pass global arrays (the whole id range, the whole pixel list),
as `shard_map` takes them; each rank takes its own slice. A step is a
collective: every rank calls it with the same arguments. Every rank gets
the same bits back, so callers that branch on a result (the noise mask of
`render.render_passes`) branch alike on every rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from raysnail_tpu_torch import integrator
from raysnail_tpu_torch import render as renderlib
from raysnail_tpu_torch import scene as scenelib
from raysnail_tpu_torch.camera import Camera
from raysnail_tpu_torch.config import RenderConfig
from raysnail_tpu_torch.diff.params import extract_params, from_leaves, inject_params, leaves
from raysnail_tpu_torch.diff.train import _ids, _load_state, adam, render_image_diff
from raysnail_tpu_torch.parallel.distributed import gather_image
from raysnail_tpu_torch.parallel.mesh import Mesh
from raysnail_tpu_torch.prelude import color as colorlib
from raysnail_tpu_torch.prelude.vec import Vec3


def _columns(a: torch.Tensor) -> Vec3:
    """(P, 3) -> Vec3 of contiguous columns (`Vec3.to_array`'s inverse)."""
    return Vec3(*(a[:, c].contiguous() for c in range(3)))


def _check_device(scene: scenelib.Scene, mesh: Mesh):
    """The scene's tensors must lie where the group's backend moves them: no
    gloo group carries the card's tensors, and NCCL carries none of the CPU's."""
    dev = scene.device
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev != mesh.device:
        raise ValueError(f"the scene lies on {dev}, the mesh's group moves tensors of "
                         f"{mesh.device}")


def _split(n: int, parts: int, what: str) -> int:
    if n % parts:
        raise ValueError(f"{n} {what} do not split evenly over {parts} ranks")
    return n // parts


def make_sharded_sample_step(scene: scenelib.Scene, cfg: RenderConfig, mesh: Mesh):
    """step(arrays, camera, seed, sample_ids, px, py) -> (P,) Vec3 sums over
    every given cell, on every rank: pixels split over "tile", cells over
    "sample" (each in contiguous slices, so a rank's ids stay a contiguous
    range where the caller's are). P must divide by the tile axis and the
    number of ids by the sample axis (`make_padded_sharded_step` pads P)."""
    _check_device(scene, mesh)
    n_tile, n_sample = mesh.shape["tile"], mesh.shape["sample"]

    def step(arrays, camera, seed, sample_ids, px, py):
        ids = _ids(sample_ids)
        k = _split(ids.size, n_sample, "sample ids")
        px = torch.as_tensor(px, dtype=cfg.dtype, device=scene.device)
        py = torch.as_tensor(py, dtype=cfg.dtype, device=scene.device)
        p = _split(px.shape[0], n_tile, "pixels")
        pix = slice(mesh.tile * p, (mesh.tile + 1) * p)
        local = renderlib.sample_sums(scene, cfg, arrays, camera, seed,
                                      ids[mesh.sample * k:(mesh.sample + 1) * k],
                                      px[pix], py[pix])
        a = local.to_array()
        dist.all_reduce(a, group=mesh.sample_group)
        return _columns(gather_image(a, mesh))

    return step


def make_padded_sharded_step(scene: scenelib.Scene, cfg: RenderConfig, mesh: Mesh):
    """A sharded sample step that takes a pixel list of any length: it pads
    px and py (with pixel (0, 0)) up to a multiple of the tile axis and cuts
    the result back. It takes the place of `render.make_sample_step`, so that
    `render.render_passes` and `painter.RenderSession` run every pass on the
    ranks; pass them k_multiple = mesh.shape["sample"], so that every batch
    of cells splits evenly."""
    inner = make_sharded_sample_step(scene, cfg, mesh)
    n_tile = mesh.shape["tile"]

    def step(arrays, camera, seed, sample_ids, px, py):
        px = torch.as_tensor(px, dtype=cfg.dtype, device=scene.device)
        py = torch.as_tensor(py, dtype=cfg.dtype, device=scene.device)
        n = px.shape[0]
        pad = (-n) % n_tile
        if pad:
            px = torch.cat([px, px.new_zeros(pad)])
            py = torch.cat([py, py.new_zeros(pad)])
        sums = inner(arrays, camera, seed, sample_ids, px, py)
        return sums[:n] if pad else sums

    return step


def make_sharded_frame_step(scene: scenelib.Scene, cfg: RenderConfig, mesh: Mesh):
    """The sharded FULL-FRAME step through the shuffled path-regeneration
    integrator: step(arrays, camera, seed) -> ((W*H,) Vec3 row-major
    radiance sums over every effective sample, this rank's shade
    iterations). The cells are split evenly over every rank (both axes
    flattened): rank i renders cells [i*k, (i+1)*k) of the whole frame, and
    the partial sums meet in one all_reduce. Draws stay keyed by (seed,
    pixel, sample, bounce), so the sums equal the single-device frame step's
    up to the order of the sums; on one rank they are the same bits.

    None where `render.make_frame_step` is None (the threefry RNG,
    path_regen="never", a scene with a Mandelbulb: the JAX package's sharded
    frame step lacks the Mandelbulb rule) or where spp does not divide by
    the number of ranks."""
    _check_device(scene, mesh)
    spp = cfg.effective_samples
    if renderlib.make_frame_step(scene, cfg) is None or spp % mesh.size:
        return None
    local_spp = spp // mesh.size
    s0 = mesh.rank * local_spp

    def step(arrays, camera, seed):
        sums, iterations = integrator.radiance_regen_shuffle(scene, arrays, cfg, camera, seed,
                                                             local_spp, s0)
        a = sums.to_array()
        dist.all_reduce(a)
        return _columns(a), iterations

    return step


def _padded_tile_grid(cfg: RenderConfig, n_tile: int):
    """-> (px, py, inv, n_pix): the tile-ordered pixel list padded with
    pixel (0, 0) up to a multiple of the tile axis."""
    px, py, inv = renderlib._tile_grid(cfg)
    n_pix = px.shape[0]
    pad = (-n_pix) % n_tile
    if pad:
        px = np.concatenate([px, np.zeros(pad, px.dtype)])
        py = np.concatenate([py, np.zeros(pad, py.dtype)])
    return px, py, inv, n_pix


def _total_cells(cfg: RenderConfig, n_sample: int) -> int:
    """The effective spp padded up to a multiple of the sample axis: the
    extra cells are more RNG streams folded into the average, so padding
    adds samples, not bias."""
    spp = cfg.effective_samples
    return spp + (-spp) % n_sample


def render_sharded(scene: scenelib.Scene, camera: Camera, cfg: RenderConfig, mesh: Mesh,
                   seed: int = 0, arrays=None) -> np.ndarray:
    """Full-frame sharded render -> (H, W, 3) float32 display image (numpy),
    the same on every rank: one call of the sharded sample step over the
    tile-ordered pixel list, pixels padded to a multiple of the tile axis and
    cells to a multiple of the sample axis."""
    arrays = arrays if arrays is not None else scene.arrays
    px, py, inv, n_pix = _padded_tile_grid(cfg, mesh.shape["tile"])
    total_cells = _total_cells(cfg, mesh.shape["sample"])
    sums = make_sharded_sample_step(scene, cfg, mesh)(arrays, camera, seed,
                                                      np.arange(total_cells), px, py)
    img = colorlib.into_color(sums, float(total_cells), cfg.gamma).to_array().cpu().numpy()
    return img[:n_pix][inv].reshape(cfg.height, cfg.width, 3)


def make_sharded_train_step(scene: scenelib.Scene, camera: Camera, cfg: RenderConfig,
                            target, mesh: Mesh, optimizer=None):
    """The sharded inverse-rendering step -> (step, opt_state0, params0);
    step(params, opt_state, seed) -> (params, opt_state, loss), the same on
    every rank. opt_state and optimizer as in `diff.make_train_step`
    (default `adam(1e-2)`).

    The loss is the JAX package's: the L2 distance of the mean image over
    every cell (padded up to a multiple of the sample axis) to the LINEAR
    target, averaged over the pixels. The gradient is that loss's, built as
    `diff.make_train_step`'s two-pass step builds it: (1) under no_grad the
    rank renders its cells on its pixels; the partial sums meet over the
    sample group into the mean image, and so the cotangent
    d * w / (n_pix * total_cells) of a cell's radiance; (2) one backward pass
    per cell of the rank; (3) one all_reduce over every rank sums the
    leaves' gradients and the pixels' partial losses; (4) every rank takes
    the same optimizer step. The JAX package's sharded step differentiates
    a psum inside shard_map and then sums the gradients over the mesh again,
    which gives mesh.size times the gradient; this step gives the gradient."""
    # the gradient flows through the scan integrator on the dense sphere
    # route, as in render_image_diff
    cfg = cfg.replace(path_regen="never", use_pallas="never", sphere_bvh="never")
    _check_device(scene, mesh)
    optimizer = optimizer or adam(1e-2)
    n_tile, n_sample = mesh.shape["tile"], mesh.shape["sample"]
    total_cells = _total_cells(cfg, n_sample)
    px, py, inv, n_pix = _padded_tile_grid(cfg, n_tile)
    n_padded = px.shape[0]

    # the target's pixels in the pixel list's tile order; the padding weighs 0
    order = np.empty_like(inv)
    order[inv] = np.arange(inv.size)
    tgt = np.zeros((n_padded, 3), np.float32)
    tgt[:n_pix] = np.asarray(target, np.float32).reshape(-1, 3)[order]
    weight = np.zeros(n_padded, np.float32)
    weight[:n_pix] = 1.0

    # this rank's pixels and cells
    p = n_padded // n_tile
    pix = slice(mesh.tile * p, (mesh.tile + 1) * p)
    k = total_cells // n_sample
    ids = np.arange(mesh.sample * k, (mesh.sample + 1) * k)
    dev = scene.device
    px_l = torch.as_tensor(px[pix], dtype=cfg.dtype, device=dev)
    py_l = torch.as_tensor(py[pix], dtype=cfg.dtype, device=dev)
    tgt_l = _columns(torch.as_tensor(tgt[pix], dtype=cfg.dtype, device=dev))
    w_l = torch.as_tensor(weight[pix], dtype=cfg.dtype, device=dev)

    params0 = extract_params(scene.arrays)

    def step(params, opt_state: dict, seed: int):
        xs = [a.detach().clone().requires_grad_(True) for a in leaves(params)]
        prm = from_leaves(xs)
        opt = optimizer(xs)
        _load_state(opt, opt_state)
        with torch.no_grad():
            sums = renderlib.sample_sums(scene, cfg, inject_params(scene.arrays, prm), camera,
                                         seed, ids, px_l, py_l).to_array()
            dist.all_reduce(sums, group=mesh.sample_group)
            d = _columns(sums) * (1.0 / total_cells) - tgt_l
            partial = torch.sum(0.5 * d.dot(d) * w_l)
            # dL/d(mean image) = d * w / n_pix, and a cell's radiance enters
            # the mean image with 1 / total_cells
            cot = (d * w_l) * (1.0 / (n_pix * total_cells))
        for sid in ids.tolist():
            cell = render_image_diff(scene, camera, cfg, prm, seed, [sid], px_l, py_l)
            outs = [(a, g) for a, g in zip(cell, cot) if a.requires_grad]
            if outs:
                torch.autograd.backward([a for a, _ in outs], [g for _, g in outs])
        # one all_reduce: the partial losses (each tile's counted once on
        # each of its n_sample ranks, as in the JAX package) and the gradients
        grads = [x.grad if x.grad is not None else torch.zeros_like(x) for x in xs]
        flat = torch.cat([partial.reshape(1).to(grads[0].dtype)]
                         + [g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        loss = flat[0] / (n_pix * n_sample)
        offset = 1
        for x in xs:
            x.grad = flat[offset:offset + x.numel()].view_as(x).clone()
            offset += x.numel()
        opt.step()
        return from_leaves(x.detach() for x in xs), opt.state_dict()["state"], loss

    return step, {}, params0

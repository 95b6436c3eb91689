"""L6 execution: the frame step, the sample-step path and the multi-pass
adaptive loop.

A full frame is one call of the shuffled path-regeneration integrator over
every pixel and every effective sample (`make_frame_step`), then the color
transform. The sample-step path (`sample_sums`, `render_sums`) renders a
given pixel list instead, one lane per pixel through the plain
regeneration integrator, or, with rng="threefry" or path_regen="never",
through the per-sample scan integrator; with the list in 16x8 image-tile
order (`_tile_grid`), 128 consecutive lanes are one compact packet for the
traversal kernels and 32 consecutive lanes neighbouring rays of the
Mandelbulb's march. It carries the sparse passes of `render_passes`, and
the whole frame where the frame step does not apply: as in the JAX
package, that is a scene with a Mandelbulb (the shuffle would scatter a
warp's rays over the image), the threefry RNG and path_regen="never".

Adaptive passes: the reference computes a 5x5 noise metric and a redo map,
but its RedoController clones the map BEFORE the pass loop and never sees
updates (raysnail.rs:369-372 vs 405-424), so the reference re-renders every
pixel each pass. As in the JAX package, later passes re-render only pixels
whose noise reaches the threshold. The JAX package pads the active set to a
few fixed bucket sizes to spare XLA compiles; PyTorch compiles nothing per
shape, so the port dispatches the active set as it is (the kernels mask
their own ragged edge).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from raysnail_tpu_torch import integrator
from raysnail_tpu_torch import scene as scenelib
from raysnail_tpu_torch.camera import Camera, generate_rays
from raysnail_tpu_torch.config import RenderConfig
from raysnail_tpu_torch.prelude import color as colorlib
from raysnail_tpu_torch.prelude import rng as prng
from raysnail_tpu_torch.prelude.vec import Vec3, div_const
from raysnail_tpu_torch.utils.profiling import span


def _check(cfg: RenderConfig):
    problems = cfg.unsupported()
    if problems:
        raise NotImplementedError("not ported yet: " + "; ".join(problems))


def regenerates(cfg: RenderConfig) -> bool:
    """Whether a render takes a path-regeneration integrator: the fast RNG
    (rng "auto" or "fast") with path regeneration on. The one place that
    picks the integrator: `sample_sums` takes `integrator.radiance_regen`
    where it holds and the scan otherwise, `make_frame_step` the shuffled
    loop where it holds and the scene has no Mandelbulb, and a train step's
    pass 1 (`diff.train`) the shuffled loop where it holds and the ids are
    a contiguous range."""
    return ("fast" if cfg.rng == "auto" else cfg.rng) == "fast" and cfg.path_regen != "never"


def sample_sums(scene: scenelib.Scene, cfg: RenderConfig, arrays: scenelib.SceneArrays,
                camera: Camera, seed: int, sample_ids, px, py) -> Vec3:
    """Radiance sums over the given stratification cells for the given flat
    pixel coordinates -> (P,) Vec3.

    With the fast RNG and path regeneration on, one lane per pixel runs the
    regeneration integrator, which consumes sample_ids as [ids[0], ids[0] +
    len): they must be a contiguous ascending range (the JAX package reads
    any other id set silently as that range; here it is an error).
    Otherwise each sample id in turn runs the scan integrator
    (`integrator.radiance`) and the sums accumulate in id order, as the JAX
    package's scan does: with the fast RNG on fold_all(streams, sid), with
    threefry on per-ray keys fold_in(fold_in(key(seed), sid), pixel)."""
    _check(cfg)
    ids = np.asarray(sample_ids, np.int64).ravel()
    device = scene.device
    px = torch.as_tensor(px, dtype=cfg.dtype, device=device)
    py = torch.as_tensor(py, dtype=cfg.dtype, device=device)
    pixel_ids = py.to(torch.int64) * cfg.width + px.to(torch.int64)
    keys0 = None if cfg.rng == "threefry" else prng.fast_streams(seed, pixel_ids)
    if regenerates(cfg):
        if ids.size and not np.array_equal(ids, np.arange(ids[0], ids[0] + ids.size)):
            raise ValueError("sample_sums: sample_ids must be a contiguous ascending range, "
                             f"got {ids.tolist()}")
        sums, _ = integrator.radiance_regen(
            scene, arrays, cfg, camera, px, py, keys0, int(ids[0]) if ids.size else 0,
            int(ids.size))
        return sums

    sqrt_spp = cfg.sqrt_spp
    sums = Vec3.zeros(px.shape, cfg.dtype, device)
    for sid in ids.tolist():
        if keys0 is not None:
            keys = prng.fold_all(keys0, sid)
        else:
            keys = prng.per_ray_keys(prng.fold(prng.key(seed, device), sid), pixel_ids)
        ray = generate_rays(camera, px, py, torch.full_like(px, sid % sqrt_spp),
                            torch.full_like(py, sid // sqrt_spp), sqrt_spp, cfg.width,
                            cfg.height, keys)
        sums = sums + integrator.radiance(scene, arrays, cfg, ray, keys)
    return sums


def make_sample_step(scene: scenelib.Scene, cfg: RenderConfig):
    """The sample step: step(arrays, camera, seed, sample_ids, px, py) ->
    (P,) Vec3 sums."""
    _check(cfg)

    def step(arrays: scenelib.SceneArrays, camera: Camera, seed: int, sample_ids, px, py):
        return sample_sums(scene, cfg, arrays, camera, seed, sample_ids, px, py)

    return step


def make_frame_step(scene: scenelib.Scene, cfg: RenderConfig):
    """FULL-FRAME step through the shuffled path-regeneration integrator:
    step(arrays, camera, seed) -> ((W*H,) Vec3 radiance sums in row-major
    pixel order, iteration count). None where the shuffle does not apply,
    as in the JAX package: the threefry RNG, path_regen="never", or a scene
    with a Mandelbulb (the march wants a warp's rays to be neighbours,
    which the cross-pixel shuffle undoes). Callers then take the
    sample-step path in tile order."""
    _check(cfg)
    if not regenerates(cfg) or scene.mandelbulbs:
        return None

    def step(arrays: scenelib.SceneArrays, camera: Camera, seed: int):
        return integrator.radiance_regen_shuffle(scene, arrays, cfg, camera, seed,
                                                 cfg.effective_samples)

    return step


def _full_grid(cfg: RenderConfig):
    py, px = np.meshgrid(np.arange(cfg.height), np.arange(cfg.width), indexing="ij")
    return px.ravel().astype(np.float32), py.ravel().astype(np.float32)


TILE_W, TILE_H = 16, 8  # 16x8 = 128 pixels = one traversal packet


def _tile_rank(width: int, height: int, device=None) -> torch.Tensor:
    """-> (W*H,) int64: where each pixel, in row-major order, stands in the
    16x8 tile order (image tiles in row-major tile order, row-major within
    the tile; 128 consecutive rays = one compact-frustum packet for the
    packet traversal kernel instead of a strip of image rows). In closed
    form, elementwise: the pixels of the tile rows above, of the tiles to
    the left in the pixel's tile row, then its place in its tile, whose
    width and height are cut at the image's right and bottom edges. The
    tile keys are unique, so this is the rank of the JAX package's stable
    sort by `_tile_key`."""
    p = torch.arange(width * height, device=device)
    x, y = p % width, p // width
    x0, y0 = x - x % TILE_W, y - y % TILE_H  # the tile's corner
    tile_w = torch.clamp_max(width - x0, TILE_W)
    tile_h = torch.clamp_max(height - y0, TILE_H)
    return y0 * width + x0 * tile_h + (y - y0) * tile_w + (x - x0)


def _tile_order(width: int, height: int, device=None) -> torch.Tensor:
    """-> (W*H,) int64: the row-major pixel indices in tile order (the
    inverse of `_tile_rank`)."""
    rank = _tile_rank(width, height, device)
    order = torch.empty_like(rank)
    order[rank] = torch.arange(rank.numel(), device=device)
    return order


def _pixels(idx: torch.Tensor, width: int, dtype=torch.float32):
    """Row-major pixel indices -> their (px, py)."""
    return (idx % width).to(dtype), (idx // width).to(dtype)


def _tile_grid(cfg: RenderConfig):
    """-> (px, py, inv) (numpy): the full pixel list in tile-major order plus
    the inverse permutation back to row-major image order."""
    px, py = _pixels(_tile_order(cfg.width, cfg.height), cfg.width)
    return px.numpy(), py.numpy(), _tile_rank(cfg.width, cfg.height).numpy()


def _sample_chunks(cfg: RenderConfig, n_pix: int, multiple_of: int = 1,
                   budget: Optional[int] = None):
    """Chunk size k dividing spp, so that a dispatch holds at most `budget`
    (default cfg.ray_batch) rays; `multiple_of` constrains k to multiples of
    a sample-axis size (the JAX package's sharded steps)."""
    spp = cfg.effective_samples
    budget = cfg.ray_batch if budget is None else budget
    k_max = max(1, min(spp, budget // max(n_pix, 1)))
    good = [d for d in range(1, k_max + 1) if spp % d == 0 and d % multiple_of == 0]
    return max(good) if good else multiple_of


def render_sums(scene, camera, cfg, seed, px, py, step=None, arrays=None,
                k_multiple: int = 1) -> Vec3:
    """Radiance SUMS over all effective samples for the given pixel list.
    `k_multiple` (a sharded step's sample-axis size) makes every chunk of
    cells a multiple of it; spp must divide by it."""
    spp = cfg.effective_samples
    if spp % k_multiple:
        raise ValueError(f"effective spp {spp} must divide by the sample-axis size "
                         f"{k_multiple} for a sharded step")
    step = step or make_sample_step(scene, cfg)
    arrays = arrays if arrays is not None else scene.arrays
    px = torch.as_tensor(px, dtype=cfg.dtype, device=scene.device)
    py = torch.as_tensor(py, dtype=cfg.dtype, device=scene.device)
    k = _sample_chunks(cfg, px.shape[0], k_multiple)
    accum = None
    for start in range(0, spp, k):
        sums = step(arrays, camera, seed, np.arange(start, start + k), px, py)
        accum = sums if accum is None else accum + sums
    return accum


def _display(accum: Vec3, cfg: RenderConfig) -> torch.Tensor:
    """Radiance sums -> (P, 3) float32 display colors, on the sums' device."""
    return colorlib.into_color(accum, float(cfg.effective_samples), cfg.gamma).to_array()


def _host(img: torch.Tensor, cfg: RenderConfig) -> np.ndarray:
    """A (W*H, 3) row-major display image -> (H, W, 3) float32 numpy."""
    return img.reshape(cfg.height, cfg.width, 3).cpu().numpy()


def _first_pass(scene, camera, cfg, seed, arrays, frame, step=None,
                k_multiple: int = 1) -> torch.Tensor:
    """One full frame -> (W*H, 3) row-major display image on the scene's
    device: through `frame` (row-major sums) where it is given, else the
    sample step over every pixel in tile order, gathered back to row-major
    order on the device."""
    if frame is not None:
        accum, _ = frame(arrays if arrays is not None else scene.arrays, camera, seed)
        return _display(accum, cfg)
    px, py = _pixels(_tile_order(cfg.width, cfg.height, scene.device), cfg.width, cfg.dtype)
    accum = render_sums(scene, camera, cfg, seed, px, py, step=step, arrays=arrays,
                        k_multiple=k_multiple)
    # the rank is made again rather than held through the pass, whose peak
    # memory it would raise
    return _display(accum, cfg)[_tile_rank(cfg.width, cfg.height, scene.device)]


def render(scene: scenelib.Scene, camera: Camera, cfg: RenderConfig,
           seed: int = 0, arrays=None) -> np.ndarray:
    """Single-pass full frame -> (H, W, 3) float32 display image (numpy):
    the frame step, or where it does not apply the sample-step path over
    every pixel in tile order."""
    return _host(_first_pass(scene, camera, cfg, seed, arrays, make_frame_step(scene, cfg)), cfg)


# -- multi-pass adaptive oversampling ---------------------------------------

NOISE_RADIUS = 2  # the 5x5 window


def _square_sum(d: torch.Tensor) -> torch.Tensor:
    """(..., 3) differences -> (d0 * d0 + d1 * d1) + d2 * d2, numpy's order."""
    sq = d * d
    return (sq[..., 0] + sq[..., 1]) + sq[..., 2]


def calc_noise(img: torch.Tensor, compat_bug: bool = False) -> torch.Tensor:
    """Per-pixel noise of an (H, W, 3) float32 display image -> (H, W)
    float32 on the image's device: the sum over the 5x5 window of the
    squared RGB distance to the centre (raysnail.rs:138-173), a neighbour
    outside the image adding nothing. The offsets go `dy` outer and `dx`
    inner, and a term sums its channels as numpy does, so the map is the
    JAX package's numpy `calc_noise` bit for bit. compat_bug=True
    replicates `let x = y` (raysnail.rs:163): the window's columns follow
    the row, y + dx."""
    h, w, _ = img.shape
    noise = torch.zeros((h, w), dtype=img.dtype, device=img.device)
    for dy in range(-NOISE_RADIUS, NOISE_RADIUS + 1):
        for dx in range(-NOISE_RADIUS, NOISE_RADIUS + 1):
            if not compat_bug:
                # the centres [yd, xd] whose neighbour [ys, xs] lies inside
                ys, yd = slice(max(0, dy), h + min(0, dy)), slice(max(0, -dy), h + min(0, -dy))
                xs, xd = slice(max(0, dx), w + min(0, dx)), slice(max(0, -dx), w + min(0, -dx))
                noise[yd, xd] += _square_sum(img[yd, xd] - img[ys, xs])
                continue
            # the rows y whose one neighbour (y + dy, y + dx) lies inside
            lo, hi = max(0, -dy, -dx), min(h, h - dy, w - dx)
            if lo < hi:
                y = torch.arange(lo, hi, device=img.device)
                noise[lo:hi] += _square_sum(img[lo:hi] - img[y + dy, y + dx][:, None, :])
    return noise


def noise_mask(img: torch.Tensor, threshold: float, compat_bug: bool = False) -> torch.Tensor:
    """-> (H, W) bool, the pixels whose noise reaches `threshold`, rounded to
    float32 first as numpy compares a float32 map with a Python number."""
    return calc_noise(img, compat_bug) >= float(np.float32(threshold))


def _blend(old: torch.Tensor, new: torch.Tensor, k: int) -> torch.Tensor:
    """The running average of display colors after pass k, (old * k + new)
    / (k + 1): the divisor a tensor (`div_const`), so that it rounds as
    numpy's float32 division does on either device."""
    return div_const(old * k + new, k + 1.0)


def render_passes(scene: scenelib.Scene, camera: Camera, cfg: RenderConfig,
                  seed: int = 0, arrays=None,
                  progress: Optional[Callable] = None,
                  step=None, k_multiple: int = 1, frame_step=None) -> np.ndarray:
    """Multi-pass render with adaptive oversampling (raysnail.rs:379-427):
    pass k re-renders the pixels whose noise reaches cfg.noise_threshold, in
    tile order through the sample step, with seed + k, and running-averages
    display colors (old*k + new)/(k+1). `progress(done, total, img)` is
    called after each pass with the (H, W, 3) float32 numpy image; returning
    False cancels. -> that image.

    The image stays a (W*H, 3) tensor on the scene's device from the first
    pass to the last: the noise mask is `noise_mask`, the redo list the tile
    order filtered by the mask, the blend divides by a tensor
    (`prelude.vec.div_const`), so every pass has the bits of the JAX
    package's numpy passes. A later pass syncs with the host once, for
    the length of its redo list.

    `step` may be a sharded sample step (`parallel.make_padded_sharded_step`)
    with `k_multiple` = the mesh's sample-axis size, so that every pass runs
    on the ranks. The first pass is `frame_step`'s frame where it is given
    (`parallel.make_sharded_frame_step`); else, with a `step` or a
    k_multiple > 1, `render_sums` in tile order through that step; else
    `render`'s full frame, as in the JAX package. On several ranks every
    rank gets the same bits of every pass, so every rank reaches the same
    noise mask and the ranks' collectives stay in step.

    Under a running profiler the call is one `render.frame` span holding a
    `render.pass` span a pass, and each later pass a `render.noise` span
    (the noise mask and the redo list, whose length waits on the pass's
    queued device work) before its render. `render_passes.redone_pixels`
    counts the pixels the later passes re-render, over every call."""
    with span("render.frame"):
        spp = cfg.effective_samples
        frame = frame_step if frame_step is not None else (
            make_frame_step(scene, cfg) if step is None and k_multiple == 1 else None)
        step = step or make_sample_step(scene, cfg)
        with span("render.pass"):
            img = _first_pass(scene, camera, cfg, seed, arrays, frame, step, k_multiple)
        shown = None  # the numpy copy last handed to progress
        if progress is not None:
            shown = _host(img, cfg)
            if progress(spp, spp * cfg.passes, shown) is False:
                return shown
        order = _tile_order(cfg.width, cfg.height, img.device) if cfg.passes > 1 else None
        for k in range(1, cfg.passes):
            with span("render.pass"):
                with span("render.noise"):
                    redo = noise_mask(img.view(cfg.height, cfg.width, 3), cfg.noise_threshold,
                                      cfg.compat_noise_bug).view(-1)
                    idx = order[redo[order]]  # tile-coherent dispatch order
                if idx.numel() == 0:
                    break
                render_passes.redone_pixels += idx.numel()
                px, py = _pixels(idx, cfg.width, cfg.dtype)
                sums = render_sums(scene, camera, cfg, seed + k, px, py, step=step,
                                   arrays=arrays, k_multiple=k_multiple)
                img[idx] = _blend(img[idx], _display(sums, cfg), k)
            if progress is not None:
                shown = _host(img, cfg)
                if progress(spp * (k + 1), spp * cfg.passes, shown) is False:
                    break
        return shown if shown is not None else _host(img, cfg)


render_passes.redone_pixels = 0

"""Inverse rendering: a differentiable loss and the gradient train step.

The JAX package's `diff/train.py` on PyTorch. All draws are counter-based
and independent of the parameters; the discrete choices (light or BSDF
branch, light pick, mixed-material resolve, dielectric reflect or refract,
hit selection) are integers and booleans and carry no gradient; the
continuous maps stay attached, so the fuzz, IOR and lobe parameters get
pathwise gradients through the sampled directions and the hit points (the
sphere sweep's t through `ops.sphere_min_t.SphereMinT`, whose backward is
the kernel K1b on the card), and the albedo and emitter parameters through
the throughput weights. Mesh and Mandelbulb hits are detached: geometry
gradients are out of scope.

The bounce loop is the scan integrator (`integrator.radiance`); with
cfg.remat_bounces each bounce is recomputed in the backward pass
(`torch.utils.checkpoint`).

Not ported, by decision (ROADMAP "Not to port"): the length-bucketed pair
VJPs (`bucket_vjp`, `RAYSNAIL_BUCKET_VJP`, `batch_dot_cot`).
"""

from __future__ import annotations

import numpy as np
import torch

from raysnail_tpu_torch import integrator
from raysnail_tpu_torch import render as renderlib
from raysnail_tpu_torch import scene as scenelib
from raysnail_tpu_torch.camera import Camera
from raysnail_tpu_torch.config import RenderConfig
from raysnail_tpu_torch.diff.params import (SceneParams, extract_params, from_leaves,
                                            inject_params, leaves)
from raysnail_tpu_torch.prelude.vec import Vec3
from raysnail_tpu_torch.utils.profiling import span

# rays (cells x pixels) of the one-shot step: above it the step takes one
# backward pass per cell
GRAD_RAY_BUDGET = 1 << 21


def adam(lr: float = 1e-2):
    """The default optimizer factory: torch.optim.Adam over the given
    leaves (optax.adam(1e-2) in the JAX package)."""
    return lambda xs: torch.optim.Adam(xs, lr=lr)


def _ids(sample_ids) -> np.ndarray:
    if isinstance(sample_ids, torch.Tensor):
        sample_ids = sample_ids.cpu()
    return np.asarray(sample_ids, np.int64).ravel()


def _pixels(cfg: RenderConfig, device):
    py, px = torch.meshgrid(torch.arange(cfg.height, dtype=cfg.dtype, device=device),
                            torch.arange(cfg.width, dtype=cfg.dtype, device=device),
                            indexing="ij")
    return px.reshape(-1), py.reshape(-1)


def _target(target, cfg: RenderConfig, device) -> Vec3:
    t = torch.as_tensor(target, dtype=cfg.dtype, device=device).reshape(-1, 3)
    return Vec3(*(t[:, i].contiguous() for i in range(3)))


def render_image_diff(scene: scenelib.Scene, camera: Camera, cfg: RenderConfig,
                      params: SceneParams, seed: int, sample_ids, px=None,
                      py=None) -> Vec3:
    """Differentiable mean-radiance image (flat (H*W,) Vec3, row-major,
    linear: no gamma) over the given stratification cells; given a pixel
    list (px, py), the (P,) image of those pixels.

    As in the JAX package, the sphere sweep stays on the dense route (the
    BVH route is detached) and the bounces run the scan integrator, whose
    values the backward pass can reach: use_pallas="never",
    sphere_bvh="never", path_regen="never"."""
    cfg = cfg.replace(use_pallas="never", sphere_bvh="never", path_regen="never")
    arrays = inject_params(scene.arrays, params)
    if px is None:
        px, py = _pixels(cfg, scene.device)
    ids = _ids(sample_ids)
    sums = renderlib.sample_sums(scene, cfg, arrays, camera, seed, ids, px, py)
    return sums * (1.0 / ids.size)


def make_loss_fn(scene: scenelib.Scene, camera: Camera, cfg: RenderConfig, target):
    """L2 image loss against a target (H, W, 3) LINEAR-radiance image:
    loss_fn(params, seed, sample_ids) -> scalar tensor."""
    target_flat = _target(target, cfg, scene.device)

    def loss_fn(params: SceneParams, seed: int, sample_ids):
        img = render_image_diff(scene, camera, cfg, params, seed, sample_ids)
        d = img - target_flat
        return 0.5 * torch.mean(d.dot(d))

    return loss_fn


def _load_state(opt: torch.optim.Optimizer, state: dict):
    """Load per-leaf optimizer state (a copy, so the caller's is kept)."""
    if state:
        sd = opt.state_dict()
        sd["state"] = {i: {k: v.clone() if isinstance(v, torch.Tensor) else v
                           for k, v in st.items()} for i, st in state.items()}
        opt.load_state_dict(sd)


def make_train_step(scene: scenelib.Scene, camera: Camera, cfg: RenderConfig, target,
                    optimizer=None, one_shot_max: int | None = None):
    """-> (step, opt_state0, params0). step(params, opt_state, seed,
    sample_ids) -> (params, opt_state, loss), the JAX package's call shape:
    params a SceneParams, opt_state the optimizer's per-leaf state (its
    `state_dict()["state"]`, keyed by the index in `params.leaves`), loss a
    scalar tensor. Neither argument is changed in place.

    optimizer: a factory from a list of leaf tensors to a torch optimizer;
    default `adam(1e-2)`.

    one_shot_max: when len(sample_ids) <= one_shot_max the step is one
    backward pass of the loss; otherwise the two-pass scheme runs one
    backward pass PER CELL. The L2-of-mean loss is not separable across
    cells, so the two-pass scheme keeps the gradient exact: (1) a forward
    under no_grad computes the mean image and the loss (the shuffled
    regeneration integrator for a contiguous id range, else the scan,
    which takes the ids as they are); (2) each cell's image is rendered
    with the gradient on and backpropagated against the fixed cotangent
    dL/d(mean image) / S, the cells' gradients accumulating in the leaves.
    With cfg.remat_bounces the backward memory is one cell's bounce
    carries.

    Under a running profiler a step is a `train.step` span, holding the
    two-pass scheme's `train.pass1` and each cell's `train.cell_forward`
    and `train.cell_backward`."""
    if optimizer is None:
        optimizer = adam(1e-2)
    params0 = extract_params(scene.arrays)
    opt_state0 = {}
    target_flat = _target(target, cfg, scene.device)
    n_pix = cfg.width * cfg.height
    loss_fn = make_loss_fn(scene, camera, cfg, target)

    if one_shot_max is None:
        # backward memory is bounded by one pass's bounce carries: a fixed
        # budget of rays, whatever cfg.ray_batch says
        one_shot_max = max(1, GRAD_RAY_BUDGET // (4 * n_pix))

    def fast_mean_image(params: SceneParams, seed: int, ids: np.ndarray, contiguous: bool):
        """Pass 1, under no_grad: the mean image through the shuffled
        regeneration integrator (the full-frame fast path) for a contiguous
        ascending id range, else through the scan, which takes the ids as
        they are (the port's `sample_sums` refuses a non-contiguous set on
        the regeneration route). Both key draws by (seed, pixel, sample,
        bounce), so they agree up to the order of the sums."""
        arrays = inject_params(scene.arrays, params)
        # no Mandelbulb clause, unlike `make_frame_step`: as in the JAX
        # package, a Mandelbulb scene's pass 1 takes the shuffled loop too
        if contiguous and renderlib.regenerates(cfg):
            sums, _ = integrator.radiance_regen_shuffle(scene, arrays, cfg, camera, seed,
                                                        int(ids.size), int(ids[0]))
        else:
            px, py = _pixels(cfg, scene.device)
            sums = renderlib.sample_sums(scene, cfg.replace(path_regen="never"), arrays,
                                         camera, seed, ids, px, py)
        return sums * (1.0 / ids.size)

    def step(params: SceneParams, opt_state: dict, seed: int, sample_ids):
        with span("train.step"):
            ids = _ids(sample_ids)
            s = ids.size
            contiguous = bool(s == 0 or np.array_equal(ids, ids[0] + np.arange(s)))
            xs = [a.detach().clone().requires_grad_(True) for a in leaves(params)]
            p = from_leaves(xs)
            opt = optimizer(xs)
            _load_state(opt, opt_state)
            if one_shot_max >= s:
                loss = loss_fn(p, seed, ids)
                loss.backward()
            else:
                with span("train.pass1"), torch.no_grad():
                    img = fast_mean_image(p, seed, ids, contiguous)
                    d = img - target_flat
                    loss = 0.5 * torch.mean(d.dot(d))
                    # dL/d(mean image) = d / n_pix (d.dot(d) sums the channels,
                    # the mean is over pixels), then 1/S maps a cell's radiance
                    # to the mean image
                    cot = d * (1.0 / (n_pix * s))
                for sid in ids.tolist():
                    with span("train.cell_forward"):
                        cell = render_image_diff(scene, camera, cfg, p, seed, [sid])
                    outs = [(a, g) for a, g in zip(cell, cot) if a.requires_grad]
                    if outs:
                        # on the card autograd runs it on its device thread,
                        # which this span covers in time
                        with span("train.cell_backward"):
                            torch.autograd.backward([a for a, _ in outs],
                                                    [g for _, g in outs])
            for x in xs:  # a parameter the image does not reach has gradient 0
                if x.grad is None:
                    x.grad = torch.zeros_like(x)
            opt.step()
            return (from_leaves(x.detach() for x in xs), opt.state_dict()["state"],
                    loss.detach())

    return step, opt_state0, params0

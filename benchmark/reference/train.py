"""The plain reference of an inverse-rendering train step: the L2 loss of
the mean image over a step's samples against a target, its gradient with
respect to the texture colors and the emitters' multipliers by autograd
through `render.radiance`, and Adam written out.

The loss is 0.5 * the mean over pixels of the squared distance summed
over the channels. Its gradient is taken in two passes, which is the
chain rule and no approximation: the mean image without a gradient gives
the loss and dL/d(image); then each block of paths is backpropagated
against that cotangent over the samples.
"""

from __future__ import annotations

import statistics

import torch

from benchmark.reference import render
from benchmark.reference.scene import DIFFUSE_LIGHT, LAMBERTIAN, Scene, Tables
from benchmark.reference.vec import V3

SEVEN = (0, 1, 2, 3, 4, 5, 8)  # the program's leaves that the reference differentiates


class Adam:
    """torch.optim.Adam's update, written out (bias-corrected moments)."""

    def __init__(self, lr=1e-2, betas=(0.9, 0.999), eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, betas[0], betas[1], eps
        self.t, self.m, self.v = 0, None, None

    def step(self, xs, gs):
        self.t += 1
        if self.m is None:
            self.m = [torch.zeros_like(x) for x in xs]
            self.v = [torch.zeros_like(x) for x in xs]
        out = []
        for i, (x, g) in enumerate(zip(xs, gs)):
            self.m[i] = self.b1 * self.m[i] + (1 - self.b1) * g
            self.v[i] = self.b2 * self.v[i] + (1 - self.b2) * g * g
            m_hat = self.m[i] / (1 - self.b1 ** self.t)
            v_hat = self.v[i] / (1 - self.b2 ** self.t)
            out.append(x - self.lr * m_hat / (torch.sqrt(v_hat) + self.eps))
        return out


def mean_image(scene: Scene, tables: Tables, image: dict, seed: int, samples,
               block: int = 1 << 19) -> V3:
    """The (P,) mean image over the listed sample ids, without a gradient;
    the sums run over the ids in their order."""
    n_pix = image["width"] * image["height"]
    pix = torch.arange(n_pix, device=scene.device)
    with torch.no_grad():
        acc = V3(*(torch.zeros(n_pix, dtype=scene.dtype, device=scene.device),) * 3)
        per = max(1, block // n_pix)
        for s in range(0, len(samples), per):
            ids = list(samples[s:s + per])
            sid = torch.as_tensor(ids, device=scene.device).repeat_interleave(n_pix)
            L = render.radiance(scene, tables, image, seed, pix.repeat(len(ids)), sid)
            for i in range(len(ids)):
                acc = acc + L.map(lambda a: a[i * n_pix:(i + 1) * n_pix])
    return acc * (1.0 / len(samples))


def loss_and_grads(scene: Scene, leaves: list, image: dict, seed: int, samples, target: V3,
                   block: int = 1 << 19):
    """-> (loss, the gradients of the program's ten leaves, in its order:
    texture color1 x, y, z, color2 x, y, z, material param0, param1,
    emitter multiplier, phong factor). `leaves` are the seven float
    tensors the reference differentiates (color1 x, y, z, color2 x, y, z,
    emit); the program's param0, param1 and phong factor get exactly zero
    gradient from Lambertian and emitting materials."""
    if not scene.kinds <= {LAMBERTIAN, DIFFUSE_LIGHT}:
        raise NotImplementedError("the train reference covers Lambertian and emitters only")
    xs = [x.detach().requires_grad_(True) for x in leaves]
    tables = Tables(V3(*xs[0:3]), V3(*xs[3:6]), xs[6])
    img = mean_image(scene, tables, image, seed, samples, block)
    d = img - target
    loss = 0.5 * torch.mean(d.dot(d))
    n_pix = image["width"] * image["height"]
    cot = d * (1.0 / (n_pix * len(samples)))
    pix = torch.arange(n_pix, device=scene.device)
    per = max(1, block // n_pix)
    for s in range(0, len(samples), per):
        ids = list(samples[s:s + per])
        sid = torch.as_tensor(ids, device=scene.device).repeat_interleave(n_pix)
        L = render.radiance(scene, tables, image, seed, pix.repeat(len(ids)), sid)
        rep = cot.map(lambda a: a.repeat(len(ids)))
        (L.dot(rep)).sum().backward()
    g = [x.grad if x.grad is not None else torch.zeros_like(x) for x in xs]
    return float(loss), ten(g)


def ten(seven: list) -> list:
    """The reference's seven leaves in the program's ten, with zeros for
    the material param0, param1 and phong factor."""
    zero = torch.zeros(1, dtype=seven[0].dtype, device=seven[0].device)
    return seven[0:6] + [zero, zero, seven[6], zero]


def train(scene: Scene, image: dict, seeds, samples, target: V3, lr: float):
    """Follow the program's first len(seeds) steps from the scene's own
    parameters. -> (losses, first step's gradients (ten leaves), the ten
    leaves' change after the last step)."""
    t = scene.tables
    xs = [t.color1.x, t.color1.y, t.color1.z, t.color2.x, t.color2.y, t.color2.z, t.emit]
    x0 = [x.clone() for x in xs]
    opt = Adam(lr)
    losses, first = [], None
    for seed in seeds:
        loss, grads = loss_and_grads(scene, xs, image, seed, samples, target)
        losses.append(loss)
        first = first if first is not None else grads
        xs = [x.detach() for x in opt.step(xs, [grads[i] for i in SEVEN])]
    return losses, first, ten([x - x0_ for x, x0_ in zip(xs, x0)])


def step_from(scene: Scene, image: dict, seed: int, samples, target: V3, lr: float,
              xs: list, m: list, v: list, t: int):
    """One step from a given state: the seven leaves' values `xs` and
    Adam's moments `m`, `v` after `t` steps. -> (loss, the step's
    gradients (ten leaves), the ten leaves' change)."""
    opt = Adam(lr)
    opt.t, opt.m, opt.v = t, list(m), list(v)
    loss, grads = loss_and_grads(scene, xs, image, seed, samples, target)
    new = opt.step(xs, [grads[i] for i in SEVEN])
    return loss, grads, ten([a.detach() - b for a, b in zip(new, xs)])


def norms(tensors) -> list:
    return [float(torch.linalg.vector_norm(t.double())) for t in tensors]


def worst_leaf_gap(prog: list, ref: list) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    over the reference's norm of that leaf or the median leaf's, whichever
    is larger. Leaves whose reference norm is under a thousandth of the
    median leaf's are left out (they move by round-off alone)."""
    kept = [i for i, r in enumerate(ref) if r >= 1e-3 * statistics.median(ref)]
    med_kept = statistics.median(ref[i] for i in kept)
    return max(abs(prog[i] - ref[i]) / max(ref[i], med_kept) for i in kept)


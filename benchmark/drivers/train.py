"""Steps of an inverse-rendering job: the step of `diff.make_train_step`
(Adam), one whole step a unit over every pixel and every sample of the
traffic, each with a new seed drawn from the run's seed.

Set-up compiles the scene, renders the target from a copy of it whose
texture colors are scaled by factors drawn from the run's seed (through
the frame step), builds the one train step and drives it through its
first `compared_steps` steps, which build and warm everything; the window
goes on with that same step and state. The check has the plain reference
follow those first steps from the configuration, and take the last step
the run made (a step of the window) from the program's state before it;
it compares:
  loss_gap    the worst of those steps' |loss - reference| / reference;
  grad_gap    the gradient as Adam got it (the change of its first moment
              over 1 - beta1) of the first step and of the last, by the
              worst leaf: the gap of the two norms over the larger of the
              reference's norm of that leaf and of the median leaf
              (benchmark/reference/train.py);
  change_gap  the same of each leaf's change over the first steps and of
              the last step's.
The reference reads the program's state before the last step, its values
and Adam's moments, row by row where the configuration's objects lie in
the program's tables (`program_rows`); the first steps check that start.
"""

from __future__ import annotations

import functools
import math

import numpy as np

BETA1 = 0.9  # torch.optim.Adam's default, which `diff.train.adam` keeps


def target_config(run) -> dict:
    """The configuration with its texture colors scaled for the target,
    by factors drawn once from the run's seed."""
    from benchmark import inputs

    if "target_config" not in vars(run):
        cfg, width = run.cell.config, run.cell.traffic["target_scale"]
        scale = run.seeds.target.uniform(1.0 - width, 1.0 + width,
                                         (inputs.n_colors(cfg["scene"]), 3))
        run.target_config = dict(cfg, scene=inputs.scene_with_colors(cfg["scene"], scale))
    return run.target_config


def _snapshot(params, state):
    """Copies of the program's ten leaves and of Adam's per-leaf state."""
    from raysnail_tpu_torch.diff.params import leaves

    return ([x.detach().clone() for x in leaves(params)],
            {j: {k: v.clone() if hasattr(v, "clone") else v for k, v in st.items()}
             for j, st in state.items()})


class Driver:
    def __init__(self, run, fault=None):
        import torch

        from benchmark import scenes
        from raysnail_tpu_torch import render
        from raysnail_tpu_torch.diff import make_train_step
        from raysnail_tpu_torch.diff.params import leaves
        from raysnail_tpu_torch.diff.train import adam

        self.run, self.fault = run, fault
        t, config = run.cell.traffic, run.cell.config
        self.cfg = scenes.render_config(config, t)
        self.scene, self.camera, run.scene_compile_s = scenes.compile_scene(
            config, self.cfg, run.device)
        tscene, _, _ = scenes.compile_scene(target_config(run), self.cfg, run.device)
        self.target_seed = run.seeds.next_render_seed()
        sums, _ = render.make_frame_step(tscene, self.cfg)(tscene.arrays, self.camera,
                                                           self.target_seed)
        spp = self.cfg.effective_samples
        target = sums.to_array() * (1.0 / spp)
        del tscene, sums
        self.ids = np.arange(spp)
        self.work_per_unit = t["width"] * t["height"] * spp / 1e6
        self.step, self.state, self.params = make_train_step(
            self.scene, self.camera, self.cfg, target, optimizer=adam(t["lr"]))
        self.p0 = [x.detach().clone() for x in leaves(self.params)]
        self.seeds, self.losses = [], []
        for i in range(t["compared_steps"]):
            self.unit()
            if i == 0:  # the gradient Adam got: its first moment over 1 - beta1
                self.grads = [self.state[j]["exp_avg"] / (1.0 - BETA1) if j in self.state
                              else torch.zeros_like(x) for j, x in enumerate(self.p0)]
        self.change = [x.detach() - a for x, a in zip(leaves(self.params), self.p0)]
        if run.device.type == "cuda":
            torch.cuda.synchronize()

    def unit(self):
        seed = self.run.seeds.next_render_seed()
        step = self.step if self.fault is None else functools.partial(self.fault, self)
        before = _snapshot(self.params, self.state)
        self.params, self.state, loss = step(self.params, self.state, seed, self.ids)
        self.last = (seed, before, loss)
        if len(self.seeds) < self.run.cell.traffic["compared_steps"]:
            self.seeds.append(seed)
            self.losses.append(float(loss))

    def release(self):
        import torch

        self.after = _snapshot(self.params, self.state)
        self.step = self.state = self.params = self.scene = self.camera = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        import torch

        from benchmark.reference import train as rt

        seed, (p_before, s_before), loss = self.last
        p_after, s_after = self.after
        rows = program_rows(self.run.cell.config, self.p0)
        base = _initial_seven(self.run)
        zeros = [torch.zeros_like(x) for x in base]

        def moment(state, key):  # a leaf with no state yet has moments 0
            return [state[j][key] if j in state else torch.zeros_like(x)
                    for j, x in enumerate(p_before)]

        steps = [int(st["step"]) for st in s_before.values()]
        start = dict(xs=rows.seven(p_before, base), t=steps[0] if steps else 0,
                     m=rows.seven(moment(s_before, "exp_avg"), zeros),
                     v=rows.seven(moment(s_before, "exp_avg_sq"), zeros))
        grads = [(a - BETA1 * b) / (1.0 - BETA1) for a, b in
                 zip(moment(s_after, "exp_avg"), moment(s_before, "exp_avg"))]
        change = [a - b for a, b in zip(p_after, p_before)]
        last = (seed, start, (float(loss), rt.norms(rt.ten(rows.seven(grads, zeros))),
                              rt.norms(rt.ten(rows.seven(change, zeros)))))
        return compare(self.run, self.target_seed, self.seeds,
                       (self.losses, rt.norms(self.grads), rt.norms(self.change)), last)


class ProgramRows:
    """Where the configuration's objects lie in the program's tables: the
    texture row of each object, and the material row of each emitter."""

    def __init__(self, tex: list, checkers: list, emitters: list):
        self.tex, self.checkers, self.emitters = tex, checkers, emitters

    def seven(self, ten: list, base: list) -> list:
        """The program's ten leaves -> the reference's seven (texture color1
        x, y, z, color2 x, y, z, emitter multiplier; a row an object): each
        object's texture row of color1, a checker's of color2, an emitter's
        material row of the multiplier; `base` (seven) elsewhere."""
        import torch

        from benchmark.reference.train import SEVEN

        emitters = [o for o, _ in self.emitters]
        out = []
        for i, j in enumerate(SEVEN):
            if i < 3:
                objs, rows = list(range(len(self.tex))), self.tex
            elif i < 6:
                objs, rows = self.checkers, [self.tex[o] for o in self.checkers]
            else:
                objs, rows = emitters, [m for _, m in self.emitters]
            x = base[i].clone()
            if objs:
                src = ten[j].detach()
                x[torch.as_tensor(objs, device=x.device)] = \
                    src[torch.as_tensor(rows, device=src.device)].to(x.dtype)
            out.append(x)
        return out


def program_rows(config: dict, p0: list) -> ProgramRows:
    """Read from the program's initial leaves against the configuration:
    an object's texture row is the one row whose color1 (and, for a
    checker, color2) are its colors; an emitter's material row the one
    whose multiplier is its multiplier. Raises where a row is not one."""
    import torch

    def only(hits, what):
        idx = torch.nonzero(hits).flatten().tolist()
        if len(idx) != 1:
            raise ValueError(f"{what}: {len(idx)} rows of the program's tables match")
        return idx[0]

    c1 = torch.stack([x.detach().float().cpu() for x in p0[0:3]], 1)
    c2 = torch.stack([x.detach().float().cpu() for x in p0[3:6]], 1)
    em = p0[8].detach().float().cpu()
    tex, checkers, emitters = [], [], []
    for i, obj in enumerate(config["scene"]["objects"]):
        mat, t = obj["material"], obj["material"]["texture"]
        hits = (c1 == torch.tensor(t["color"] if t["kind"] == "constant" else t["odd"])).all(1)
        if t["kind"] == "checker":
            hits &= (c2 == torch.tensor(t["even"])).all(1)
            checkers.append(i)
        tex.append(only(hits, f"object {i}'s texture"))
        if mat["kind"] == "diffuse_light":
            emitters.append((i, only(em == torch.tensor(float(mat["multiplier"])),
                                     f"object {i}'s emitter")))
    return ProgramRows(tex, checkers, emitters)


def _initial_seven(run) -> list:
    """The reference's seven leaves as the configuration gives them."""
    from benchmark.reference import scene as refscene

    t = run.cell.traffic
    tb = refscene.build(run.cell.config, t["width"], t["height"], device=run.device).tables
    return [*tb.color1, *tb.color2, tb.emit]


def _reference_setup(run, target_seed: int, dtype):
    """-> (image, every sample id, the reference's target, its scene)."""
    from benchmark.reference import scene as refscene
    from benchmark.reference import train as rt

    t = run.cell.traffic
    image = dict(width=t["width"], height=t["height"], samples=t["samples"],
                 max_depth=run.cell.config["max_depth"])
    all_ids = list(range(math.isqrt(t["samples"]) ** 2))
    ts = refscene.build(target_config(run), t["width"], t["height"], dtype, run.device)
    target = rt.mean_image(ts, ts.tables, image, target_seed, all_ids)
    rs = refscene.build(run.cell.config, t["width"], t["height"], dtype, run.device)
    return image, all_ids, target, rs


def reference(run, target_seed: int, seeds, dtype=None, samples=None, setup=None):
    """The reference's (losses, first gradient's norms, change's norms) of
    the compared steps, in float32 or in `dtype` (the control), over the
    traffic's samples or the `samples` given (a planted fault)."""
    import torch

    from benchmark.reference import train as rt

    image, all_ids, target, rs = setup or _reference_setup(run, target_seed,
                                                           dtype or torch.float32)
    losses, first, change = rt.train(rs, image, seeds, samples or all_ids, target,
                                     run.cell.traffic["lr"])
    return losses, rt.norms(first), rt.norms(change)


def compare(run, target_seed: int, seeds, prog, last=None) -> tuple:
    """-> ({loss_gap, grad_gap, change_gap: {"value", "limit"}}, compared
    steps whose loss is off). `prog` is the program's (losses, first
    gradient's norms, change's norms), or the reference's in another
    precision or with a planted fault (`reference`). `last` is the last
    step's (seed, the state before it in the reference's seven leaves:
    {xs, m, v, t}, the program's (loss, gradient's norms, change's
    norms)), held against the reference's step from that state."""
    import torch

    from benchmark.reference import train as rt

    setup = _reference_setup(run, target_seed, torch.float32)
    losses, grads, change = prog
    ref_losses, ref_grads, ref_change = reference(run, target_seed, seeds, setup=setup)
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    grad_gap = rt.worst_leaf_gap(grads, ref_grads)
    change_gap = rt.worst_leaf_gap(change, ref_change)
    if last is not None:
        seed, start, (loss, l_grads, l_change) = last
        image, all_ids, target, rs = setup
        r_loss, r_grads, r_change = rt.step_from(rs, image, seed, all_ids, target,
                                                 run.cell.traffic["lr"], **start)
        gaps.append(abs(loss - r_loss) / abs(r_loss))
        grad_gap = max(grad_gap, rt.worst_leaf_gap(l_grads, rt.norms(r_grads)))
        change_gap = max(change_gap, rt.worst_leaf_gap(l_change, rt.norms(r_change)))
    lim = run.cell.limits
    checks = {"loss_gap": {"value": max(gaps), "limit": lim["loss_gap"]},
              "grad_gap": {"value": grad_gap, "limit": lim["grad_gap"]},
              "change_gap": {"value": change_gap, "limit": lim["change_gap"]}}
    return checks, sum(g > lim["loss_gap"] for g in gaps)

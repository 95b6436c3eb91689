"""The program's spans (`utils.profiling.span`) on the CPU, on example.sdl
at a toy size.

  * A frame under torch.profiler is one `render.frame` holding exactly as
    many `integrator.iteration` spans as `radiance_regen_shuffle` counts
    for the same call, each holding one `integrator.shade`; the sample
    step's loop (`radiance_regen`) reads alike.
  * A two-pass train step is one `train.step` holding one `train.pass1`
    and a `train.cell_forward` and a `train.cell_backward` per cell.
  * With no profiler running no span calls `record_function`, and the
    frame and the step give the same bits as before.
  * `device_trace`'s Chrome trace holds the frame's spans.
  * A Mandelbulb frame of three adaptive passes holds a `render.pass` span
    a pass, a `render.noise` span a later pass and a `geometry.march` span
    a march call; `render_passes.redone_pixels` and
    `mandelbulb_march.rays` count the redone pixels and the marched rays.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from raysnail_tpu_torch import integrator, render
from raysnail_tpu_torch.config import RenderConfig
from raysnail_tpu_torch.diff import make_train_step
from raysnail_tpu_torch.diff.params import leaves
from raysnail_tpu_torch.ops import mandelbulb_march as mm
from raysnail_tpu_torch.prelude import rng as prng
from raysnail_tpu_torch.sdl.driver import build_scene
from raysnail_tpu_torch.utils import golden, profiling

EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sdl",
                       "example.sdl")
CFG = RenderConfig(width=16, height=10, samples=4, max_depth=4)
SEED = 11
CELLS = 4
BULB_CFG = RenderConfig(width=16, height=10, samples=1, max_depth=1, passes=3)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    return build_scene(EXAMPLE, CFG, "cpu")


@pytest.fixture(scope="module")
def bulb():
    return golden.mandelbulb_scene(BULB_CFG, "cpu")


def profiled(fn):
    """-> (fn's result, {span name: [(start, end)] in start order}) of the
    program's spans under a CPU profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    got = {}
    # the profiler's own event records: building its Python event list
    # takes tens of seconds for a Mandelbulb frame's many small operations
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(("render.", "integrator.", "geometry.", "train.")):
            start = e.start_ns()
            got.setdefault(e.name(), []).append((start, start + e.duration_ns()))
    return out, {k: sorted(v) for k, v in got.items()}


def inside(span, outer):
    return any(s <= span[0] and span[1] <= e for s, e in outer)


def frame(scene):
    return render.render_passes(*scene, CFG, seed=SEED)


def train_step(scene):
    target = np.full((CFG.height, CFG.width, 3), 0.25, np.float32)
    step, state, params = make_train_step(*scene, CFG, target, one_shot_max=0)
    params, state, loss = step(params, state, SEED, np.arange(CELLS))
    return [x.detach().clone() for x in leaves(params)], float(loss)


def test_a_frame_is_one_span_holding_its_iterations(scene):
    _, n = integrator.radiance_regen_shuffle(scene[0], scene[0].arrays, CFG, scene[1], SEED,
                                             CFG.effective_samples)
    img, got = profiled(lambda: frame(scene))
    assert np.array_equal(img, frame(scene))
    frames, passes, its, shades = (got.get(k, []) for k in (
        "render.frame", "render.pass", "integrator.iteration", "integrator.shade"))
    assert len(frames) == 1 and n > 0 and len(its) == n and len(shades) == n
    assert len(passes) == 1 and all(inside(p, frames) for p in passes)
    assert all(inside(i, passes) for i in its)
    assert all(inside(s, its) for s in shades)
    assert set(got) == {"render.frame", "render.pass", "integrator.iteration",
                        "integrator.shade"}


def test_the_sample_step_loop_reads_alike(scene):
    cfg = CFG.replace(width=16, height=8)
    px = torch.arange(16.0).repeat(8)
    py = torch.arange(8.0).repeat_interleave(16)
    sc, cam = scene
    keys0 = prng.fast_streams(SEED, py.to(torch.int64) * 16 + px.to(torch.int64))
    (sums, n), got = profiled(lambda: integrator.radiance_regen(
        sc, sc.arrays, cfg, cam, px, py, keys0, 0, 4))
    its, shades = got["integrator.iteration"], got["integrator.shade"]
    assert n > 0 and len(its) == len(shades) == n
    assert all(inside(s, its) for s in shades)


def test_a_two_pass_step_holds_its_phases(scene):
    _, got = profiled(lambda: train_step(scene))
    steps = got["train.step"]
    assert len(steps) == 1
    for name, count in (("train.pass1", 1), ("train.cell_forward", CELLS),
                        ("train.cell_backward", CELLS)):
        assert len(got[name]) == count and all(inside(s, steps) for s in got[name])
    # pass 1 runs the shuffled regeneration loop; the cells run the scan
    assert all(inside(i, got["train.pass1"]) for i in got["integrator.iteration"])


def bulb_frame(bulb, images=None):
    keep = None if images is None else (lambda done, total, img: images.append(img.copy()))
    return render.render_passes(*bulb, BULB_CFG, seed=SEED, progress=keep)


def test_a_passes_frame_holds_its_passes_noise_and_marches(bulb, monkeypatch):
    march, lanes = mm.mandelbulb_march, []

    @functools.wraps(march)
    def counting(origin, *args, **kwargs):
        lanes.append(origin.shape[-1])
        return march(origin, *args, **kwargs)

    # the op bumps its counters on the function its module's name holds
    monkeypatch.setattr(mm, "mandelbulb_march", counting)
    redone, rays, images = render.render_passes.redone_pixels, counting.rays, []
    img, got = profiled(lambda: bulb_frame(bulb, images))
    marched = list(lanes)
    assert np.array_equal(img, bulb_frame(bulb))
    frames, passes, noise, its, marches = (got.get(k, []) for k in (
        "render.frame", "render.pass", "render.noise", "integrator.iteration",
        "geometry.march"))
    assert len(frames) == 1 and len(passes) == len(images) == BULB_CFG.passes
    assert all(inside(p, frames) for p in passes)
    assert len(noise) == BULB_CFG.passes - 1 and all(inside(z, passes[1:]) for z in noise)
    assert len(marches) == len(its) == len(marched) > 0
    assert all(inside(m, its) for m in marches)
    redo = [int(render.noise_mask(torch.from_numpy(a), BULB_CFG.noise_threshold).sum())
            for a in images[:-1]]
    n_pix = BULB_CFG.width * BULB_CFG.height
    assert all(0 < r < n_pix for r in redo) and set(marched) == {n_pix, *redo}
    assert render.render_passes.redone_pixels - redone == 2 * sum(redo)
    assert lanes == 2 * marched and counting.rays - rays == sum(lanes)


def test_no_profiler_no_record_function(scene, bulb, monkeypatch):
    img, (params, loss) = frame(scene), train_step(scene)
    bulb_img = bulb_frame(bulb)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("x") is profiling.span("y")
    assert np.array_equal(frame(scene), img)
    assert np.array_equal(bulb_frame(bulb), bulb_img)
    params2, loss2 = train_step(scene)
    assert loss2 == loss and all(torch.equal(a, b) for a, b in zip(params2, params))


def test_device_trace_holds_the_frame_spans(scene, tmp_path):
    with profiling.device_trace(str(tmp_path)) as prof:
        frame(scene)
    assert prof is not None
    (path,) = tmp_path.iterdir()
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert {"render.frame", "integrator.iteration", "integrator.shade"} <= names

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
"""

import json
import os

import numpy as np
import pytest
import torch

from raysnail_tpu_torch import integrator, render
from raysnail_tpu_torch.config import RenderConfig
from raysnail_tpu_torch.diff import make_train_step
from raysnail_tpu_torch.diff.params import leaves
from raysnail_tpu_torch.prelude import rng as prng
from raysnail_tpu_torch.sdl.driver import build_scene
from raysnail_tpu_torch.utils import profiling

EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sdl",
                       "example.sdl")
CFG = RenderConfig(width=16, height=10, samples=4, max_depth=4)
SEED = 11
CELLS = 4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    return build_scene(EXAMPLE, CFG, "cpu")


def profiled(fn):
    """-> (fn's result, {span name: [(start, end)] in start order}) of the
    program's spans under a CPU profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    got = {}
    for e in prof.events():
        if e.name.startswith(("render.", "integrator.", "train.")):
            got.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
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
    frames, its, shades = (got.get(k, []) for k in ("render.frame", "integrator.iteration",
                                                    "integrator.shade"))
    assert len(frames) == 1 and n > 0 and len(its) == n and len(shades) == n
    assert all(inside(i, frames) for i in its)
    assert all(inside(s, its) for s in shades)
    assert set(got) == {"render.frame", "integrator.iteration", "integrator.shade"}


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


def test_no_profiler_no_record_function(scene, monkeypatch):
    img, (params, loss) = frame(scene), train_step(scene)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("x") is profiling.span("y")
    assert np.array_equal(frame(scene), img)
    params2, loss2 = train_step(scene)
    assert loss2 == loss and all(torch.equal(a, b) for a, b in zip(params2, params))


def test_device_trace_holds_the_frame_spans(scene, tmp_path):
    with profiling.device_trace(str(tmp_path)) as prof:
        frame(scene)
    assert prof is not None
    (path,) = tmp_path.iterdir()
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert {"render.frame", "integrator.iteration", "integrator.shade"} <= names

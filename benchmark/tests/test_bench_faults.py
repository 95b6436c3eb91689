"""The check decides `correct`: sound runs of small cells on the CPU pass
it, and a run whose timed path is broken underneath fails it, once for
each fault the cell can have; so does the precision control (the
reference computed in bfloat16 in the program's place). The cells' limits
are the files' (benchmark/limits/)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import control
from benchmark.tests import helpers

FRAME_CELLS = ["example-frame"]


@pytest.mark.parametrize("cell", FRAME_CELLS + ["example-train"])
def test_a_sound_run_is_correct(cell):
    checks, failed, correct = helpers.drive(helpers.small_cell(cell))
    assert correct and failed == 0, checks


def _stale(driver, seed, img):
    """A frame that returns the state it had: the previous frame's image."""
    return driver.frames[-1][1] if driver.frames else img


def _half(driver, seed, img):
    """Half of the batch left out, the mean taken over the rest: each
    pixel's first half of its samples."""
    from raysnail_tpu_torch import integrator
    from raysnail_tpu_torch.prelude import color

    spp = driver.cfg.effective_samples // 2
    sums, _ = integrator.radiance_regen_shuffle(driver.scene, driver.scene.arrays, driver.cfg,
                                                driver.camera, seed, spp)
    return color.into_color(sums, float(spp)).to_array().numpy().reshape(img.shape)


def _altered(driver, seed, img):
    """The answer altered where it is produced: the frame of the next seed."""
    from raysnail_tpu_torch.render import render_passes

    return render_passes(driver.scene, driver.camera, driver.cfg, seed=seed + 1)


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
@pytest.mark.parametrize("cell", FRAME_CELLS)
def test_a_broken_frame_is_not_correct(cell, fault):
    checks, failed, correct = helpers.drive(helpers.small_cell(cell), units=5, fault=fault)
    assert not correct and failed >= 1, checks


def _unchanged(driver, params, state, seed, ids):
    """A step that returns its state unchanged."""
    loss = driver.step(params, state, seed, ids)[2]
    return params, state, loss


def _half_batch(driver, params, state, seed, ids):
    """Half of the batch (the samples) left out, the mean over the rest."""
    return driver.step(params, state, seed, ids[: len(ids) // 2])


def _next_rows(driver, params, state, seed, ids):
    """Each step fed the next step's rows."""
    return driver.step(params, state, seed + 1, ids)


def _late(fault):
    """The fault in the window's steps only: the set-up's compared steps
    run sound."""
    def late(driver, params, state, seed, ids):
        if len(driver.seeds) < driver.run.cell.traffic["compared_steps"]:
            return driver.step(params, state, seed, ids)
        return fault(driver, params, state, seed, ids)

    late.__name__ = f"late{fault.__name__}"
    return late


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _next_rows])
@pytest.mark.parametrize("when", ["every step", "window only"])
def test_a_broken_train_step_is_not_correct(fault, when):
    fault = fault if when == "every step" else _late(fault)
    checks, _, correct = helpers.drive(helpers.small_cell("example-train"), units=2, fault=fault)
    assert not correct, checks


@pytest.mark.parametrize("cell", FRAME_CELLS + ["example-train"])
def test_the_precision_control_is_not_correct(cell):
    c = helpers.small_cell(cell)
    checks = control.control(c, helpers.SEED, torch.device("cpu"), torch.bfloat16)
    assert any(v["value"] > v["limit"] for v in checks.values()), checks


def test_the_train_faults_in_the_reference_are_not_correct():
    out = control.faults(helpers.small_cell("example-train"), helpers.SEED, torch.device("cpu"))
    for name, checks in out.items():
        assert any(v["value"] > v["limit"] for v in checks.values()), (name, checks)


def test_same_seed_same_inputs():
    a, b = helpers.run_of(helpers.small_cell("example-frame")), \
        helpers.run_of(helpers.small_cell("example-frame"))
    assert [a.seeds.next_render_seed() for _ in range(3)] == \
        [b.seeds.next_render_seed() for _ in range(3)]
    assert np.all(np.array([a.seeds.next_render_seed() for _ in range(100)]) < 2**32)


"""The port's gradient train step (`raysnail_tpu_torch.diff.make_train_step`)
against the JAX package's and against itself, on the CPU, on
tests/test_diff.py's scene at 24x16@16spp depth 4 (the scene helpers of
tests/test_torch_diff.py).

  * One SGD step (lr 1e-2, a flat target) of the port, one-shot and
    two-pass per cell, equals one of the JAX package's one-shot step: loss
    rtol 1e-5, every parameter rtol 2e-4, atol 2e-6 (tests/test_diff.py's
    tolerances for its one-shot against its per-cell step).
  * The port's one-shot step equals its per-cell step, as tests/test_diff.py
    holds the JAX package's.
  * remat_bounces on (each bounce recomputed in the backward pass) equals
    off, bit for bit: the recompute draws the same counter-based numbers.
  * A non-contiguous id batch: pass 1 takes the scan, which reads the ids
    as they are, and the per-cell step equals the one-shot step on the same
    ids (the same tolerances).
  * State carried across: a JAX Adam step, carried by
    `convert.adam_state_from_numpy` and `scene_params_from_numpy` into a
    port Adam step, equals two JAX Adam steps (rtol 1e-5).
  * The port recovers a perturbed albedo in 40 Adam steps (tests/test_diff.py
    test_inverse_rendering_recovers_albedo's criteria).
  * The inverse-rendering example runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raysnail_tpu import ir as jir
from raysnail_tpu.camera import build_camera as jcamera
from raysnail_tpu.config import RenderConfig as JConfig
from raysnail_tpu.diff import make_train_step as jmake_train_step
from raysnail_tpu.prelude import rng as jrng
from raysnail_tpu.scene import SceneBuilder as JBuilder
from raysnail_tpu_torch import ir as tir
from raysnail_tpu_torch.camera import build_camera as tcamera
from raysnail_tpu_torch.config import RenderConfig as TConfig
from raysnail_tpu_torch.convert import adam_state_from_numpy, scene_params_from_numpy
from raysnail_tpu_torch.diff import extract_params, make_train_step
from raysnail_tpu_torch.diff.params import from_leaves, leaves
from raysnail_tpu_torch.diff.train import adam, render_image_diff
from raysnail_tpu_torch.scene import SceneBuilder as TBuilder
from test_torch_diff import SMALL, _albedo_row, small_scene

SPP = 16
IDS = np.arange(SPP)
SEED = 3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sgd(lr=1e-2):
    return lambda xs: torch.optim.SGD(xs, lr=lr)


def target():
    return np.zeros((SMALL["height"], SMALL["width"], 3), np.float32) + 0.25


def port_step(cfg=None, optimizer=None, one_shot_max=SPP, ids=IDS, params=None, state=None):
    scene, cam = small_scene(tir, TBuilder, tcamera, "cpu")
    step, s0, p0 = make_train_step(scene, cam, cfg or TConfig(**SMALL), target(),
                                   optimizer=optimizer or sgd(), one_shot_max=one_shot_max)
    p, s, loss = step(params if params is not None else p0, state if state is not None else s0,
                      SEED, ids)
    return [x.numpy() for x in leaves(p)], s, float(loss)


def assert_params_close(a, b, rtol=2e-4, atol=2e-6):
    assert len(a) == len(b) == 10
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def jax_sgd_step():
    scene, cam = small_scene(jir, JBuilder, jcamera)
    step, s0, p0 = jmake_train_step(scene, cam, JConfig(**SMALL), target(),
                                    optimizer=optax.sgd(1e-2), one_shot_max=SPP)
    p, _, loss = step(p0, s0, jrng.key(SEED), jnp.asarray(IDS, jnp.int32))
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(p)], float(loss)


@pytest.mark.parametrize("one_shot_max", [SPP, 4], ids=["one-shot", "per-cell"])
def test_sgd_step_matches_jax(jax_sgd_step, one_shot_max):
    ref, ref_loss = jax_sgd_step
    got, _, loss = port_step(one_shot_max=one_shot_max)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    assert_params_close(got, ref)
    moved = [np.abs(g - r0).max() for g, r0 in zip(
        got, (x.detach().numpy() for x in leaves(port_start())))]
    assert max(moved) > 1e-4  # the step moved the parameters


def port_start():
    return extract_params(small_scene(tir, TBuilder, tcamera, "cpu")[0].arrays)


def test_accumulated_grads_match_one_shot():
    one, _, l1 = port_step(one_shot_max=SPP)
    cells, _, ln = port_step(one_shot_max=4)
    np.testing.assert_allclose(l1, ln, rtol=1e-5)
    assert_params_close(one, cells)


def test_remat_changes_nothing():
    cfg = TConfig(**SMALL)
    on, _, l_on = port_step(cfg.replace(remat_bounces=True), one_shot_max=4)
    off, _, l_off = port_step(cfg.replace(remat_bounces=False), one_shot_max=4)
    assert l_on == l_off
    assert all(np.array_equal(a, b) for a, b in zip(on, off))


def test_noncontiguous_ids():
    ids = np.array([0, 2, 5, 7, 9, 12, 14, 15])
    one, _, l1 = port_step(one_shot_max=len(ids), ids=ids)
    cells, _, ln = port_step(one_shot_max=4, ids=ids)
    np.testing.assert_allclose(l1, ln, rtol=1e-5)
    assert_params_close(one, cells)
    _, _, lc = port_step(one_shot_max=len(ids), ids=np.arange(8))
    assert lc != l1  # other cells, another loss


def test_adam_state_carries_across_from_jax():
    scene, cam = small_scene(jir, JBuilder, jcamera)
    step, s0, p0 = jmake_train_step(scene, cam, JConfig(**SMALL), target(),
                                    optimizer=optax.adam(1e-2), one_shot_max=SPP)
    key, ids = jrng.key(SEED), jnp.asarray(IDS, jnp.int32)
    p1, s1, _ = step(p0, s0, key, ids)
    p2, _, _ = step(p1, s1, key, ids)
    p1n = jax.tree_util.tree_map(np.asarray, p1)
    params = scene_params_from_numpy(p1n, "cpu")
    state = adam_state_from_numpy(jax.tree_util.tree_map(np.asarray, s1), params)
    assert set(state) == set(range(10)) and float(state[0]["step"]) == 1.0
    got, new_state, _ = port_step(optimizer=adam(1e-2), params=params, state=state)
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(p2)]
    assert_params_close(got, ref, rtol=1e-5, atol=0)
    assert float(new_state[0]["step"]) == 2.0
    # the caller's state is not changed in place
    assert float(state[0]["step"]) == 1.0


def test_inverse_rendering_recovers_albedo():
    scene, cam = small_scene(tir, TBuilder, tcamera, "cpu")
    cfg = TConfig(**SMALL)
    step, opt_state, true_params = make_train_step(scene, cam, cfg, target())
    with torch.no_grad():
        tgt = render_image_diff(scene, cam, cfg, true_params, 0, IDS).to_array()
    step, opt_state, _ = make_train_step(
        scene, cam, cfg, tgt.numpy().reshape(cfg.height, cfg.width, 3), optimizer=adam(5e-2))
    row = _albedo_row(true_params)
    xs = [x.detach().clone() for x in leaves(true_params)]
    want = np.array([float(xs[i][row]) for i in range(3)])
    for i, v in enumerate((0.2, 0.7, 0.7)):
        xs[i][row] = v
    params = from_leaves(xs)
    losses = []
    for _ in range(40):  # the target's own draws: the loss's floor is 0
        params, opt_state, loss = step(params, opt_state, 0, IDS)
        losses.append(float(loss))
    got = np.array([float(leaves(params)[i][row]) for i in range(3)])
    assert losses[-1] < losses[0] * 0.2, (losses[0], losses[-1])
    np.testing.assert_allclose(got, want, atol=0.15)


def test_inverse_rendering_example_runs_on_cpu(capsys):
    from raysnail_tpu_torch.examples import inverse_rendering

    assert inverse_rendering.main(["--device", "cpu", "--steps", "3", "--no-check"]) == 0
    out = capsys.readouterr().out
    assert "step   0" in out and "step   2" in out

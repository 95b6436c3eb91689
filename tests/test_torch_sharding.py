"""The port's sharding (`raysnail_tpu_torch.parallel`) on gloo ranks on the
CPU, against the JAX package's `parallel/` on the 8 virtual CPU devices and
against the port's own single-device paths: tests/test_sharding.py's nine
tests, on its scene at 32x16@4-16spp, depth 3.

A module fixture starts two worlds once, of 2 ranks (meshes (2, 1) and
(1, 2)) and of 4 (meshes (2, 2) and (4, 1)); each rank runs
`parallel.dryrun.sharded_outputs`, so that the ranks import torch and the
port only. The JAX side and the port's single-device side run in this
process, on the matching `make_mesh(n_tile, n_sample, devices=...)`.

Tolerances:
  * against the JAX package's render_sharded: per pixel and channel
    |d| <= 1e-4 on at least 99% of the pixels and the mean within 1e-4
    (tests/test_torch_passes.py's render parity: an ulp can flip a path);
  * against the port's single-device render, across mesh shapes and the
    adaptive passes: atol 2e-5; the frame step: atol 3e-5 (the JAX
    package's own tests: the order of the sums differs);
  * the checkpoint resume: 1e-6;
  * the train step: the loss within rtol 1e-5 of the JAX package's sharded
    loss (padded cells included); one SGD step within rtol 2e-4, atol 2e-6
    of the port's single-device step and of jax.grad of the JAX package's
    loss (tests/test_torch_train.py's). The JAX package's sharded step
    gives mesh.size times the gradient (ROADMAP section 3): it is held for
    its loss only;
  * every rank returns the same bits.
"""

import functools
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from raysnail_tpu import ir as jir
from raysnail_tpu.camera import build_camera as jcamera
from raysnail_tpu.config import RenderConfig as JConfig
from raysnail_tpu.diff import make_loss_fn as jmake_loss_fn
from raysnail_tpu.diff.params import extract_params as jextract_params
from raysnail_tpu.parallel import make_mesh as jmake_mesh
from raysnail_tpu.parallel import make_sharded_train_step as jsharded_train_step
from raysnail_tpu.parallel import render_sharded as jrender_sharded
from raysnail_tpu.parallel.mesh import _factor as jfactor
from raysnail_tpu.prelude import rng as jrng
from raysnail_tpu.scene import SceneBuilder as JBuilder
from raysnail_tpu_torch import ir as tir
from raysnail_tpu_torch.camera import build_camera as tcamera
from raysnail_tpu_torch.config import RenderConfig as TConfig
from raysnail_tpu_torch.diff import make_train_step
from raysnail_tpu_torch.diff.params import leaves
from raysnail_tpu_torch.parallel import dryrun
from raysnail_tpu_torch.parallel import mesh as tmesh
from raysnail_tpu_torch.render import make_frame_step, render, render_passes
from raysnail_tpu_torch.scene import SceneBuilder as TBuilder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(width=32, height=16, samples=4, max_depth=3, ray_batch=1 << 14)
CAM = dict(look_from=(0, 0, 1), look_at=(0, 0, -1), fov=50)
WORLDS = {2: ((2, 1), (1, 2)), 4: ((2, 2), (4, 1))}
SHAPES = [s for shapes in WORLDS.values() for s in shapes]
SHAPE_IDS = [f"{t}x{s}" for t, s in SHAPES]
SEED = 3  # the train step's
PIXEL_ATOL, MEAN_ATOL = 1e-4, 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def builder(ir, new_builder):
    """tests/test_sharding.py's scene."""
    b = new_builder()
    b.add(ir.Sphere((0.0, -100.5, -1.0), 100.0, ir.Lambertian(ir.Constant((0.5, 0.5, 0.5)))))
    b.add(ir.Sphere((0.0, 0.0, -1.0), 0.5, ir.Metal(ir.Constant((0.8, 0.7, 0.6)))))
    b.add(ir.Sphere((2.0, 2.0, 0.0), 0.7, ir.DiffuseLight(ir.Constant((1, 1, 1)), 4.0)),
          light=True)
    return b


def target():
    return np.zeros((SMALL["height"], SMALL["width"], 3), np.float32) + 0.25


def sgd():
    """One SGD step of lr 1: p0 - p1 is the gradient."""
    return functools.partial(torch.optim.SGD, lr=1.0)


def port_scene(cfg=None):
    cfg = cfg or TConfig(**SMALL)
    return (builder(tir, TBuilder).compile(device="cpu"),
            tcamera(**CAM, width=cfg.width, height=cfg.height, device="cpu"))


def jax_scene():
    cfg = JConfig(**SMALL)
    return (builder(jir, JBuilder).compile(),
            jcamera(**CAM, width=cfg.width, height=cfg.height))


def jax_mesh(shape):
    return jmake_mesh(*shape, devices=jax.devices()[:shape[0] * shape[1]])


@pytest.fixture(scope="module")
def worlds():
    """{(n_tile, n_sample): [each rank's outputs]} of the two worlds."""
    out = {}
    with tempfile.TemporaryDirectory(prefix="raysnail_test_") as d:
        for n, shapes in WORLDS.items():
            ranks = dryrun.spawn(dryrun.sharded_outputs, n, "cpu", (
                shapes, builder(tir, TBuilder), CAM, TConfig(**SMALL), target(), sgd(),
                os.path.join(d, str(n))), timeout=300)
            for shape in shapes:
                out[shape] = [r[shape] for r in ranks]
    return out


def _assert_close(img, ref, share=0.99):
    assert img.shape == ref.shape and np.isfinite(img).all()
    d = np.abs(img - ref).max(axis=-1)
    assert (d <= PIXEL_ATOL).mean() >= share, ((d <= PIXEL_ATOL).mean(), d.max())
    dmean = np.abs(img.reshape(-1, 3).mean(0) - ref.reshape(-1, 3).mean(0)).max()
    assert dmean <= MEAN_ATOL, dmean


# -- the mesh --------------------------------------------------------------------

def test_factor_and_mesh_shapes_equal_jax():
    dev = jax.devices()[0]
    for n in range(1, 65):
        assert tmesh._factor(n) == jfactor(n)
        sizes = [(None, None)] + [(t, None) for t in range(1, n + 1) if n % t == 0] + [
            (None, s) for s in range(1, n + 1) if n % s == 0]
        for n_tile, n_sample in sizes:
            m = jmake_mesh(n_tile, n_sample, devices=[dev] * n)
            assert tmesh._shape(n, n_tile, n_sample) == (m.shape["tile"], m.shape["sample"])
    with pytest.raises(ValueError, match="does not cover"):
        tmesh._shape(8, 3, None)


def test_ranks_sit_where_jax_lays_the_devices_out(worlds):
    for shape, ranks in worlds.items():
        devices = jax_mesh(shape).devices
        for r, out in enumerate(ranks):
            t, s = out["coords"]
            assert devices[t, s] == jax.devices()[r], (shape, r)


# -- renders ---------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_render_sharded_matches_jax(worlds, shape):
    scene, cam = jax_scene()
    ref = jrender_sharded(scene, cam, JConfig(**SMALL), jax_mesh(shape), seed=0)
    img = worlds[shape][0]["render"]
    assert img.shape == (SMALL["height"], SMALL["width"], 3) and img.mean() > 0.01
    _assert_close(img, ref)


@pytest.fixture(scope="module")
def single_render():
    scene, cam = port_scene()
    return render(scene, cam, TConfig(**SMALL), seed=0)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_render_sharded_matches_single_device(worlds, single_render, shape):
    np.testing.assert_allclose(worlds[shape][0]["render"], single_render, atol=2e-5)


def test_render_sharded_consistent_across_mesh_shapes(worlds):
    first = worlds[SHAPES[0]][0]["render16"]
    for shape in SHAPES[1:]:
        np.testing.assert_allclose(worlds[shape][0]["render16"], first, atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_every_rank_returns_the_same_bits(worlds, shape):
    ranks = worlds[shape]
    for out in ranks[1:]:
        for key in ("render", "render16", "frame", "passes"):
            assert np.array_equal(out[key], ranks[0][key]), key
        for key in ("train", "train9"):
            assert out[key]["loss"] == ranks[0][key]["loss"]
            assert all(np.array_equal(a, b) for a, b in zip(out[key]["params"],
                                                            ranks[0][key]["params"]))
        assert np.array_equal(out["resume"]["resumed"], ranks[0]["resume"]["resumed"])


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_sharded_frame_step_matches_single_device(worlds, shape):
    cfg = TConfig(**SMALL).replace(samples=16)
    scene, cam = port_scene(cfg)
    sums, _ = make_frame_step(scene, cfg)(scene.arrays, cam, 5)
    np.testing.assert_allclose(worlds[shape][0]["frame"], sums.to_array().numpy(), atol=3e-5)


@pytest.fixture(scope="module")
def single_passes():
    cfg = TConfig(**SMALL).replace(passes=2, noise_threshold=1e-4)
    scene, cam = port_scene(cfg)
    return render_passes(scene, cam, cfg, seed=1)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_adaptive_passes_shard_invariant(worlds, single_passes, shape):
    np.testing.assert_allclose(worlds[shape][0]["passes"], single_passes, atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_sharded_checkpoint_resume_exact(worlds, shape):
    res = worlds[shape][0]["resume"]
    assert 0 < res["samples_done"] < 9
    np.testing.assert_allclose(res["resumed"], res["full"], atol=1e-6)


# -- the train step --------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_losses():
    """The JAX package's sharded loss at (2, 2) with 4 cells and at (1, 2)
    with 9 cells, padded to 10."""
    scene, cam = jax_scene()
    out = {}
    for shape, samples in (((2, 2), 4), ((1, 2), 9)):
        cfg = JConfig(**SMALL).replace(samples=samples)
        step, s0, p0 = jsharded_train_step(scene, cam, cfg, target(), jax_mesh(shape),
                                           optimizer=optax.sgd(1.0))
        out[shape, samples] = float(step(p0, s0, jrng.key(SEED))[2])
    return out


@pytest.mark.parametrize("shape,samples,key", [((2, 2), 4, "train"), ((1, 2), 9, "train9")],
                         ids=["2x2-4cells", "1x2-9cells-padded"])
def test_sharded_train_loss_matches_jax(worlds, jax_losses, shape, samples, key):
    np.testing.assert_allclose(worlds[shape][0][key]["loss"], jax_losses[shape, samples],
                               rtol=1e-5)


@pytest.fixture(scope="module")
def jax_gradient():
    """jax.grad of the JAX package's (single-device) loss over cells 0-3."""
    scene, cam = jax_scene()
    loss_fn = jmake_loss_fn(scene, cam, JConfig(**SMALL), target())
    p0 = jextract_params(scene.arrays)
    g = jax.jit(jax.grad(loss_fn))(p0, jrng.key(SEED), jnp.arange(SMALL["samples"]))
    return ([np.asarray(x) for x in jax.tree_util.tree_leaves(p0)],
            [np.asarray(x) for x in jax.tree_util.tree_leaves(g)])


@pytest.fixture(scope="module")
def single_sgd_step():
    """The port's single-device SGD step over cells 0-3 -> (params, loss)."""
    scene, cam = port_scene()
    step, s0, p0 = make_train_step(scene, cam, TConfig(**SMALL), target(), optimizer=sgd())
    p, _, loss = step(p0, s0, SEED, np.arange(SMALL["samples"]))
    return [x.numpy() for x in leaves(p)], float(loss)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_sharded_train_step_takes_the_true_gradient(worlds, single_sgd_step, jax_gradient,
                                                    shape):
    got = worlds[shape][0]["train"]
    want, loss = single_sgd_step
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    assert len(got["params"]) == len(want) == 10
    for a, b in zip(got["params"], want):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-6)
    p0, g = jax_gradient
    for a, x0, gx in zip(got["params"], p0, g):
        np.testing.assert_allclose(x0 - a, gx, rtol=2e-4, atol=2e-6)
    assert max(float(np.abs(gx).max()) for gx in g) > 1e-3  # the gradient is not 0


@pytest.mark.parametrize("shape", [(2, 1), (4, 1)], ids=["2x1", "4x1"])
def test_sharded_train_step_on_nine_cells_equals_single_device(worlds, shape):
    """No padding where the sample axis is 1: 9 cells, the single-device
    step's on the same cells."""
    scene, cam = port_scene()
    cfg = TConfig(**SMALL).replace(samples=9)
    step, s0, p0 = make_train_step(scene, cam, cfg, target(), optimizer=sgd())
    p, _, loss = step(p0, s0, SEED, np.arange(9))
    got = worlds[shape][0]["train9"]
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    for a, b in zip(got["params"], leaves(p)):
        np.testing.assert_allclose(a, b.numpy(), rtol=2e-4, atol=2e-6)


# -- the dry run and the group ---------------------------------------------------

def test_dryrun_multichip_on_two_gloo_ranks():
    ranks = dryrun.dryrun_multichip(2, "cpu")
    assert len(ranks) == 2
    for out in ranks:
        assert out["mesh"][0] == {"tile": 2, "sample": 1}
        assert np.isfinite(out["train"]["loss"]) and np.isfinite(out["mesh_kernel"]).all()
        assert np.array_equal(out["passes"], ranks[0]["passes"])


def test_initialize_raises_when_the_world_never_forms():
    """A world of 2 with only rank 0 ever started: the init raises after its
    timeout; nothing falls back to a single process."""
    with tempfile.TemporaryDirectory(prefix="raysnail_test_") as d:
        code = ("import datetime\n"
                "from raysnail_tpu_torch.parallel import distributed\n"
                f"distributed.initialize('file://{d}/store', 2, 0, 'cpu',\n"
                "                       timeout=datetime.timedelta(seconds=2))\n"
                "print('initialized')\n")
        run = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                             text=True, timeout=120,
                             env={**os.environ, "PYTHONPATH": REPO})
    assert run.returncode != 0 and "initialized" not in run.stdout, run.stdout
    assert "Error" in run.stderr, run.stderr[-2000:]

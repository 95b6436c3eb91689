"""The shuffled regeneration loop's trips as CUDA graphs (`graphs.py`,
`integrator.replays_trips`).

On the CPU: the rule that decides whether a call replays, read from the
call alone (the scene's device and routes, whether a tensor wants a
gradient), on scenes lowered to the CPU and then labelled as the card's,
which is all the rule reads; and a CPU frame, which never captures.

On the card (marked `cuda`): a replayed frame against the eager loop's, bit
for bit, with K1 and K7 called as often and through their module
attributes; a BVH-route scene that makes no capture; every SDL scene the
rule admits; the kernels' own launch counters over a replayed frame; and a
frame under torch.profiler, whose replayed kernels show
in the trace. The file imports no JAX, so on a machine without it run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs.py -q
"""

import dataclasses
import functools
import glob
import os

import numpy as np
import pytest
import torch

from raysnail_tpu_torch import graphs, integrator, render
from raysnail_tpu_torch import scene as scenelib
from raysnail_tpu_torch.config import RenderConfig
from raysnail_tpu_torch.diff.params import extract_params, inject_params
from raysnail_tpu_torch.geometry import spheres
from raysnail_tpu_torch.ops import rows_select
from raysnail_tpu_torch.ops import sphere_min_t as smt
from raysnail_tpu_torch.scenes import book1
from raysnail_tpu_torch.sdl.driver import build_scene
from raysnail_tpu_torch.utils import golden

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "sdl", "example.sdl")
SDL = sorted(glob.glob(os.path.join(ROOT, "sdl", "*.sdl")))
SMALL = RenderConfig(width=16, height=10, samples=4, max_depth=4)
SEED = 2**31 + 12_345


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def as_card(scene):
    """The CPU scene under the card's label: what the rule and the routes
    read of the device."""
    return dataclasses.replace(scene, device=torch.device("cuda"))


def rule(scene, camera, cfg, arrays=None):
    arrays = scene.arrays if arrays is None else arrays
    return integrator.replays_trips(scene, arrays, camera,
                                    integrator.kernel_routes(scene, arrays, cfg))


def cpu_case(name):
    """-> (scene, camera, cfg) on the CPU."""
    if name == "mesh":
        cfg = SMALL
        scene, camera = golden.mesh_scene(cfg, "cpu", n_seg=12, n_ring=4)
        return scene, camera, cfg
    if name == "book1":
        cfg = SMALL
        return (book1.balls_scene().compile(device="cpu"),
                book1.balls_camera(cfg.width, cfg.height, device="cpu"), cfg)
    return (*build_scene(EXAMPLE, SMALL, "cpu"), SMALL)


@pytest.mark.parametrize("name,options,replays", [
    ("example", {}, True),
    ("mesh", {}, False),                                  # the mesh takes the traversal
    ("mesh", {"mesh_pallas": "never"}, True),             # a small mesh swept densely
    ("book1", {}, True),                                  # 478 spheres through K1
    ("book1", {"sphere_bvh": "force"}, False),            # ... through the sphere traversal
], ids=["example", "mesh-kernel", "mesh-dense", "book1-K1", "book1-spherebvh"])
def test_the_rule_follows_the_routes(name, options, replays):
    scene, camera, cfg = cpu_case(name)
    cfg = cfg.replace(**options)
    card = as_card(scene)
    assert scenelib.walks_bvh(card, card.arrays, integrator.kernel_routes(
        card, card.arrays, cfg)) is not replays
    assert rule(card, camera, cfg) is replays


def test_the_rule_refuses_a_gradient_and_the_cpu():
    scene, camera, cfg = cpu_case("example")
    card = as_card(scene)
    arrays = inject_params(card.arrays, extract_params(card.arrays))
    assert rule(card, camera, cfg, arrays) is False  # grad mode on, leaves that want one
    with torch.no_grad():  # as a train step's pass 1
        assert rule(card, camera, cfg, arrays) is True
    assert rule(card, camera, cfg) is True
    assert rule(scene, camera, cfg) is False  # the CPU's scene


def test_a_cpu_frame_runs_eagerly_and_emits_no_graph_span(monkeypatch):
    scene, camera, cfg = cpu_case("example")

    def refuse(*a, **k):
        raise AssertionError("a CPU frame made graphs")

    monkeypatch.setattr(graphs, "TripGraphs", refuse)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sums, n = integrator.radiance_regen_shuffle(scene, scene.arrays, cfg, camera, SEED,
                                                    cfg.effective_samples)
    names = [e.name for e in prof.events()]
    assert names.count("integrator.iteration") == n > 0
    assert "integrator.graphed" not in names and "integrator.capture" not in names
    again, n2 = integrator.radiance_regen_shuffle(scene, scene.arrays, cfg, camera, SEED,
                                                  cfg.effective_samples)
    assert n2 == n and all(torch.equal(a, b) for a, b in zip(sums, again))


def test_a_csg_mesh_above_the_dense_size_walks_the_bvh():
    from raysnail_tpu_torch.geometry import csg

    leaf = csg.MeshLeaf(group=None, mat_id=0, brute=False)
    tree = csg.DifferenceNode(plus=csg.IntersectionNode(leaf, leaf, 0), minus=leaf, mat_id=0,
                              minus_mat_id=0)
    assert csg.walks_bvh(tree) and csg.walks_bvh(leaf)
    dense = leaf._replace(brute=True)
    assert not csg.walks_bvh(csg.IntersectionNode(dense, dense, 0))


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graphs capture only there")
    return torch.device("cuda")


class Counted:
    """Counting wrappers in place of K1's and K7's module attributes, the
    names a replay calls through."""

    def __init__(self, monkeypatch):
        self.calls = {"sphere_min_t": 0, "rows_select": 0}
        for owner, attr in ((spheres, "sphere_min_t"), (rows_select, "rows_select")):
            monkeypatch.setattr(owner, attr, self._wrap(attr, getattr(owner, attr)))

    def _wrap(self, attr, fn):
        @functools.wraps(fn)  # with the kernel's launch counter, which it bumps by name
        def counted(*args, **kwargs):
            self.calls[attr] += 1
            return fn(*args, **kwargs)

        return counted

    def take(self):
        out, self.calls = self.calls, dict.fromkeys(self.calls, 0)
        return out


def shuffled(scene, camera, cfg, seed=SEED):
    out = integrator.radiance_regen_shuffle(scene, scene.arrays, cfg, camera, seed,
                                            cfg.effective_samples)
    torch.cuda.synchronize()
    return out


def card_case(name, device):
    if name == "moving-book1":
        cfg = RenderConfig(width=400, height=250, samples=4)
        return (book1.balls_scene(need_speed=True).compile(device=device),
                book1.balls_camera(cfg.width, cfg.height, need_shutter=True, device=device), cfg)
    cfg = RenderConfig(width=800, height=500, samples=4)
    return (*build_scene(EXAMPLE, cfg, device), cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["example", "moving-book1"])
def test_a_replayed_frame_is_the_eager_frame(cuda_device, name, monkeypatch):
    scene, camera, cfg = card_case(name, cuda_device)
    assert rule(scene, camera, cfg)
    counted = Counted(monkeypatch)
    made = []
    monkeypatch.setattr(graphs.TripGraphs, "end_trip",
                        lambda self, f=graphs.TripGraphs.end_trip: (made.append(1), f(self)))
    sums, n = shuffled(scene, camera, cfg)
    graphed_calls = counted.take()
    assert made and len(made) == n  # every trip ran from the call's graphs
    with monkeypatch.context() as m:
        m.setattr(integrator, "replays_trips", lambda *a: False)
        want, n_eager = shuffled(scene, camera, cfg)
    assert counted.take() == graphed_calls
    assert n == n_eager and all(torch.equal(a, b) for a, b in zip(sums, want))
    if name == "example":  # one K1 and three K7 a trip
        assert graphed_calls == {"sphere_min_t": n, "rows_select": 3 * n}
    # a second call captures anew and gives the same bits
    again, n2 = shuffled(scene, camera, cfg)
    assert n2 == n and all(torch.equal(a, b) for a, b in zip(again, want))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["example", "moving-book1"])
def test_a_replayed_frame_counts_every_kernel_launch(cuda_device, name):
    """K1's counters, which it bumps under its own module's name, and K7's,
    which it bumps under the name a capture cuts: one K1 a trip (the moving
    form on the moving scene) and, on example.sdl, three K7."""
    scene, camera, cfg = card_case(name, cuda_device)
    assert rule(scene, camera, cfg)
    k1, k7 = smt.sphere_min_t, rows_select.rows_select

    def read():
        return k1.launches, k1.moving_launches, k7.launches

    before = read()
    _, n = shuffled(scene, camera, cfg)
    grew = tuple(a - b for a, b in zip(read(), before))
    assert grew[:2] == (n, n if name == "moving-book1" else 0), (grew, n)
    if name == "example":
        assert grew[2] == 3 * n, (grew, n)


@pytest.mark.cuda
def test_a_bvh_route_scene_makes_no_capture(cuda_device, monkeypatch):
    cfg = RenderConfig(width=64, height=40, samples=4)
    scene, camera = golden.mesh_scene(cfg, cuda_device, n_seg=24, n_ring=6)
    assert not rule(scene, camera, cfg)

    def refuse(*a, **k):
        raise AssertionError("a BVH-route scene made graphs")

    monkeypatch.setattr(graphs, "TripGraphs", refuse)
    sums, n = shuffled(scene, camera, cfg)
    assert n > 0 and torch.isfinite(sums.x).all()


@pytest.mark.cuda
@pytest.mark.parametrize("path", SDL, ids=os.path.basename)
def test_every_sdl_scene_the_rule_admits_replays_bit_equal(cuda_device, path, monkeypatch):
    cfg = RenderConfig(width=200, height=125, samples=4)
    scene, camera = build_scene(path, cfg, cuda_device)
    if not rule(scene, camera, cfg):
        pytest.skip(f"{os.path.basename(path)}: the rule keeps it eager")
    sums, n = shuffled(scene, camera, cfg)
    with monkeypatch.context() as m:
        m.setattr(integrator, "replays_trips", lambda *a: False)
        want, n_eager = shuffled(scene, camera, cfg)
    assert n == n_eager and all(torch.equal(a, b) for a, b in zip(sums, want))


def _profiled_frame(scene, camera, cfg):
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        img = render.render_passes(scene, camera, cfg, seed=SEED)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    kernels = sum(e.device_type() == torch.autograd.DeviceType.CUDA
                  and not e.name().startswith(("Memcpy", "Memset"))
                  and not getattr(e, "is_user_annotation", lambda: False)() for e in events)
    host = [e.name() for e in events if e.device_type() != torch.autograd.DeviceType.CUDA]
    return img, kernels, host


@pytest.mark.cuda
def test_a_profiled_frame_captures_and_its_replayed_kernels_show(cuda_device, monkeypatch):
    scene, camera, cfg = card_case("example", cuda_device)
    img, kernels, host = _profiled_frame(scene, camera, cfg)
    with monkeypatch.context() as m:
        m.setattr(integrator, "replays_trips", lambda *a: False)
        want, eager_kernels, eager_host = _profiled_frame(scene, camera, cfg)
    n = host.count("integrator.iteration")
    assert n == eager_host.count("integrator.iteration") > 0
    assert host.count("integrator.graphed") == n and host.count("integrator.capture") >= 5
    assert "integrator.graphed" not in eager_host
    assert np.array_equal(img, want)
    # the same kernels ran, though the host launched few of them
    assert abs(kernels - eager_kernels) <= 0.02 * eager_kernels, (kernels, eager_kernels)
    assert host.count("cudaLaunchKernel") < 0.25 * eager_host.count("cudaLaunchKernel")

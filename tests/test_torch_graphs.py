"""The regeneration loops' trips as CUDA graphs (`graphs.py`,
`integrator.replays_trips`): the shuffled loop of the frame step and the
sample step's loop, which the Mandelbulb and every later adaptive pass run.

On the CPU: the rule that decides whether a call replays, read from the
call alone (the scene's device and routes, whether a tensor wants a
gradient), on scenes lowered to the CPU and then labelled as the card's,
which is all the rule reads; a CPU frame and sample step, which never
capture; and the trip loop's buffer form (`integrator.run_trips` with a
pass-through stand-in for the graphs) against the eager loop, on a frame
of two chunks and on the sample step.

On the card (marked `cuda`): a replayed frame against the eager loop's, bit
for bit, with K1 and K7 called as often and through their module
attributes; a BVH-route scene that makes no capture; every SDL scene the
rule admits; the kernels' own launch counters over a replayed frame; a
frame under torch.profiler, whose replayed kernels show in the trace; and
the Mandelbulb's adaptive passes through the replayed sample step, each
pass's image and redo mask bit for bit against the eager loop's, with K1,
K6 and K7 launched and K6's rays counted as often, and a BVH-route scene's
later pass, which makes no capture. The file imports no JAX, so on a machine without it run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_graphs.py -q
"""

import contextlib
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
from raysnail_tpu_torch.ops import mandelbulb_march as mm
from raysnail_tpu_torch.ops import rows_select
from raysnail_tpu_torch.ops import sphere_min_t as smt
from raysnail_tpu_torch.prelude import rng as prng
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
    if name == "bulb":  # the upstream previewer's Mandelbulb: K6 is a hole
        return (*golden.mandelbulb_scene(SMALL, "cpu"), SMALL)
    return (*build_scene(EXAMPLE, SMALL, "cpu"), SMALL)


@pytest.mark.parametrize("name,options,replays", [
    ("example", {}, True),
    ("mesh", {}, False),                                  # the mesh takes the traversal
    ("mesh", {"mesh_pallas": "never"}, True),             # a small mesh swept densely
    ("book1", {}, True),                                  # 478 spheres through K1
    ("book1", {"sphere_bvh": "force"}, False),            # ... through the sphere traversal
    ("bulb", {}, True),                                   # the march K6 and K1
], ids=["example", "mesh-kernel", "mesh-dense", "book1-K1", "book1-spherebvh", "bulb"])
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


def test_the_sample_step_rule_refuses_a_gradient_and_the_cpu():
    """The predicate `radiance_regen` reads, on the Mandelbulb scene that
    only the sample step renders."""
    scene, camera, cfg = cpu_case("bulb")
    card = as_card(scene)
    arrays = inject_params(card.arrays, extract_params(card.arrays))
    assert rule(card, camera, cfg, arrays) is False  # grad mode on, leaves that want one
    with torch.no_grad():
        assert rule(card, camera, cfg, arrays) is True
    assert rule(card, camera, cfg) is True
    assert rule(scene, camera, cfg) is False  # the CPU's scene


def test_a_cpu_sample_step_runs_eagerly_and_emits_no_graph_span(monkeypatch):
    scene, camera, cfg = cpu_case("example")

    def refuse(*a, **k):
        raise AssertionError("a CPU sample step made graphs")

    monkeypatch.setattr(graphs, "TripGraphs", refuse)
    px, py, _ = render._tile_grid(cfg)
    px, py = torch.as_tensor(px), torch.as_tensor(py)
    keys0 = prng.fast_streams(SEED, py.to(torch.int64) * cfg.width + px.to(torch.int64))

    def sample_step():
        return integrator.radiance_regen(scene, scene.arrays, cfg, camera, px, py, keys0, 2,
                                         cfg.effective_samples - 2)

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        sums, n = sample_step()
    names = [e.name for e in prof.events()]
    assert names.count("integrator.iteration") == n > 0
    assert "integrator.graphed" not in names and "integrator.capture" not in names
    again, n2 = sample_step()
    assert n2 == n and all(torch.equal(a, b) for a, b in zip(sums, again))


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


class PassThrough:
    """A stand-in for `graphs.TripGraphs` on the CPU: each piece calls its
    function, and a trip's end only counts the trip."""

    def __init__(self):
        self.pieces = self.trips = 0

    def piece(self, fn, *args):
        self.pieces += 1
        return fn(*args)

    def end_trip(self):
        self.trips += 1


@pytest.mark.parametrize("loop", ["frame-chunks", "sample-step"])
def test_run_trips_buffer_form_is_the_eager_loop(loop, monkeypatch):
    """`run_trips` with graphs, the state in buffers that each trip writes
    in place (and that the frame step refills a chunk), against the eager
    loop: the same bits and the same trips, three pieces a trip."""
    scene, camera, cfg = cpu_case("example")
    if loop == "frame-chunks":
        cfg = cfg.replace(regen_chunk_cap=2)
        spp = cfg.effective_samples
        assert spp // integrator.chunk_width(spp, cfg.chunk_cap) >= 2

        def call():
            return integrator.radiance_regen_shuffle(scene, scene.arrays, cfg, camera, SEED, spp)
    else:
        px, py, _ = render._tile_grid(cfg)
        px, py = torch.as_tensor(px), torch.as_tensor(py)
        keys0 = prng.fast_streams(SEED, py.to(torch.int64) * cfg.width + px.to(torch.int64))

        def call():
            return integrator.radiance_regen(scene, scene.arrays, cfg, camera, px, py, keys0, 1,
                                             cfg.effective_samples - 1)

    want, n = call()
    stand_in = PassThrough()
    monkeypatch.setattr(integrator, "call_graphs",
                        lambda *a: contextlib.nullcontext(stand_in))
    got, n_graphed = call()
    assert n_graphed == n == stand_in.trips > 0 and stand_in.pieces == 3 * n
    assert all(torch.equal(a, b) for a, b in zip(got, want))


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
    """Counting wrappers in place of the holes' module attributes (K1's and
    K7's unless named), the names a replay calls through."""

    def __init__(self, monkeypatch, holes=((spheres, "sphere_min_t"),
                                          (rows_select, "rows_select"))):
        self.calls = {attr: 0 for _, attr in holes}
        for owner, attr in holes:
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


# -- the sample step on the card ---------------------------------------------

BULB_CFG = RenderConfig(width=96, height=60, samples=9, passes=3)


class Passes:
    """A `render_passes` call's passes as `render_sums` met them: each
    pass's pixels (the first pass's are every pixel, the later ones the
    redo mask in tile order) and its sums, and the image after each pass."""

    def __init__(self, monkeypatch, scene, camera, cfg):
        self.pixels, self.sums, self.images = [], [], []
        inner = render.render_sums

        def recording(scene, camera, cfg, seed, px, py, **kwargs):
            out = inner(scene, camera, cfg, seed, px, py, **kwargs)
            self.pixels.append((px.cpu().numpy(), py.cpu().numpy()))
            self.sums.append(torch.stack(tuple(out)).cpu())
            return out

        keep = lambda done, total, img: self.images.append(img.copy())  # noqa: E731
        with monkeypatch.context() as m:
            m.setattr(render, "render_sums", recording)
            render.render_passes(scene, camera, cfg, seed=SEED, progress=keep)
            torch.cuda.synchronize()

    def same(self, other) -> bool:
        return (len(self.pixels) == len(other.pixels) == len(self.images) > 1
                and all(np.array_equal(a, b) for p, q in zip(self.pixels, other.pixels)
                        for a, b in zip(p, q))
                and all(torch.equal(a, b) for a, b in zip(self.sums, other.sums))
                and all(np.array_equal(a, b) for a, b in zip(self.images, other.images)))


@pytest.mark.cuda
def test_a_replayed_bulb_passes_frame_is_the_eager_frame(cuda_device, monkeypatch):
    """Every pass of the Mandelbulb's adaptive frame through the replayed
    sample step: the same pixels redone (the redo masks), the same sums and
    images bit for bit, and K1, K6 and K7 called through their module
    attributes as often as the eager loop calls them, one K6 a trip."""
    scene, camera = golden.mandelbulb_scene(BULB_CFG, cuda_device)
    assert rule(scene, camera, BULB_CFG)
    counted = Counted(monkeypatch, graphs.HOLES)
    trips = []
    monkeypatch.setattr(graphs.TripGraphs, "end_trip",
                        lambda self, f=graphs.TripGraphs.end_trip: (trips.append(1), f(self)))
    made = []
    monkeypatch.setattr(graphs.TripGraphs, "release",
                        lambda self, f=graphs.TripGraphs.release: (made.append(1), f(self)))
    graphed = Passes(monkeypatch, scene, camera, BULB_CFG)
    graphed_calls = counted.take()
    assert len(made) == BULB_CFG.passes  # one capture a pass: a pass is one call
    assert len(trips) == graphed_calls["mandelbulb_march"] > 0  # every trip replayed
    with monkeypatch.context() as m:
        m.setattr(integrator, "replays_trips", lambda *a: False)
        eager = Passes(m, scene, camera, BULB_CFG)
    assert counted.take() == graphed_calls
    assert graphed.same(eager)
    redo = [p[0].size for p in graphed.pixels[1:]]
    assert all(0 < r < BULB_CFG.width * BULB_CFG.height for r in redo), redo


@pytest.mark.cuda
def test_a_replayed_bulb_frame_counts_every_launch_and_ray(cuda_device, monkeypatch):
    """The kernels' own counters over a replayed frame equal the eager
    frame's: K1's, which it bumps under its module's name, and K6's and
    K7's, which they bump under the name a capture cuts."""
    scene, camera = golden.mandelbulb_scene(BULB_CFG, cuda_device)
    assert rule(scene, camera, BULB_CFG)
    k1, k7 = smt.sphere_min_t, rows_select.rows_select

    def grew(frame):
        def read():
            k6 = mm.mandelbulb_march
            return k1.launches, k7.launches, k6.launches, k6.rays

        before = read()
        frame()
        torch.cuda.synchronize()
        return tuple(a - b for a, b in zip(read(), before))

    def bulb_frame():
        render.render_passes(scene, camera, BULB_CFG, seed=SEED)

    graphed = grew(bulb_frame)
    with monkeypatch.context() as m:
        m.setattr(integrator, "replays_trips", lambda *a: False)
        eager = grew(bulb_frame)
    assert graphed == eager and min(graphed) > 0, (graphed, eager)
    assert graphed[0] == graphed[2]  # the light's K1 and the march K6, once a trip each


@pytest.mark.cuda
def test_a_bvh_route_scene_later_pass_makes_no_capture(cuda_device, monkeypatch):
    cfg = RenderConfig(width=64, height=40, samples=4, passes=2, noise_threshold=0.0)
    scene, camera = golden.mesh_scene(cfg, cuda_device, n_seg=24, n_ring=6)
    assert not rule(scene, camera, cfg)

    def refuse(*a, **k):
        raise AssertionError("a BVH-route scene made graphs")

    monkeypatch.setattr(graphs, "TripGraphs", refuse)
    redone = render.render_passes.redone_pixels
    img = render.render_passes(scene, camera, cfg, seed=SEED)
    assert render.render_passes.redone_pixels - redone == cfg.width * cfg.height
    assert np.isfinite(img).all()

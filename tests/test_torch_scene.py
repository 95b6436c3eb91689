"""The port's host side against the JAX package's: the copied framework-free
modules, the SDL parser's IR, the scene compile, and the import boundary.

Tolerance: none. The parser and the compile run the same float64 numpy code
in both packages and round to float32 once, so IR and compiled tensors must
be equal exactly.
"""

import ast
import dataclasses
import glob
import os

import jax
import numpy as np
import pytest
import torch

from raysnail_tpu import ir as jir
from raysnail_tpu.config import RenderConfig as JConfig
from raysnail_tpu.scene import SceneBuilder as JBuilder
from raysnail_tpu.sdl import build_scene as jbuild
from raysnail_tpu.sdl.parser import SdlParser as JParser
from raysnail_tpu_torch import ir as tir
from raysnail_tpu_torch.config import RenderConfig as TConfig
from raysnail_tpu_torch.convert import scene_arrays_from_numpy
from raysnail_tpu_torch.prelude.vec import Vec3
from raysnail_tpu_torch.scene import SceneBuilder as TBuilder
from raysnail_tpu_torch.sdl.driver import build_scene as tbuild
from raysnail_tpu_torch.sdl.parser import SdlParser as TParser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "raysnail_tpu_torch")
SDL_FILES = sorted(glob.glob(os.path.join(REPO, "sdl", "*.sdl")))

# the framework-free host modules the port carries as copies
COPIES = ["ir.py", "geometry/transforms.py", "sdl/parser.py"]


@pytest.mark.parametrize("path", COPIES)
def test_copied_modules_equal_their_originals(path):
    """Each copy is its original with the package name in imports rewritten."""
    with open(os.path.join(REPO, "raysnail_tpu", path)) as f:
        original = f.read()
    with open(os.path.join(PORT, path)) as f:
        copy = f.read()
    assert copy.replace("raysnail_tpu_torch", "raysnail_tpu") == original


def _plain(x):
    """IR -> nested tuples of (class name, fields) and plain values, so the
    two packages' IR classes compare by content."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, _plain(getattr(x, f.name))) for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    return x


@pytest.mark.parametrize("path", SDL_FILES, ids=os.path.basename)
def test_parser_ir_equals_jax(path):
    j = JParser.parse(path)
    t = TParser.parse(path)
    assert len(t.objects) > 0
    assert _plain(t) == _plain(j)


def _assert_same(a, b, where="arrays"):
    """Port tensors `a` equal port tensors `b`, leaf by leaf and by name."""
    if a is None or b is None:
        assert a is None and b is None, where
    elif isinstance(a, Vec3):
        for axis in "xyz":
            _assert_same(getattr(a, axis), getattr(b, axis), f"{where}.{axis}")
    elif isinstance(a, tuple) and hasattr(a, "_fields"):
        assert a._fields == b._fields, where
        for name in a._fields:
            _assert_same(getattr(a, name), getattr(b, name), f"{where}.{name}")
    elif isinstance(a, tuple):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype,
                                                           a.shape, b.shape)
        assert torch.equal(a, b), where


def _mixed_scene(ir):
    """Builder input with what example.sdl lacks: oriented and axis-aligned
    boxes, a translated and scaled sphere, metal, glass with absorption, a
    mixed material, nested checkers, and a second sphere light."""
    rot = np.eye(4)
    c, s = np.cos(0.4), np.sin(0.4)
    rot[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    rot[:3, 3] = (1.0, 0.5, -2.0)
    scale = np.diag([2.0, 2.0, 2.0, 1.0])
    scale[:3, 3] = (0.0, 1.0, 0.0)
    checker = ir.Checker(ir.Checker(ir.Constant((1, 0, 0)), ir.Constant((0, 1, 0)), 3.0),
                         ir.Constant((0.2, 0.2, 0.2)), 10.0)
    matte = ir.Lambertian(ir.Constant((0.7, 0.6, 0.5)))
    return [
        (ir.Sphere((0.0, -1000.0, 0.0), 1000.0, ir.Lambertian(checker)), False),
        (ir.Sphere((0.0, 1.0, 0.0), 0.5, ir.Metal(ir.Constant((0.9, 0.9, 0.9))),
                   transform=ir.mat4(scale)), False),
        (ir.Sphere((3.0, 1.0, 1.0), 1.0, ir.Mixed(matte, ir.Metal(ir.Constant((1, 1, 1))),
                                                  0.3)), False),
        (ir.Box((-1.0, 0.0, -1.0), (1.0, 2.0, 1.0), matte, transform=ir.mat4(rot)), False),
        (ir.Box((2.0, 0.0, 2.0), (3.0, 1.0, 3.0),
             ir.BlinnPhong(0.4, 20.0, ir.Constant((0.3, 0.4, 0.5)))), False),
        (ir.Sphere((0.0, 8.0, 0.0), 2.0, ir.DiffuseLight(ir.Constant((1, 1, 1)), 4.0)), True),
        (ir.Sphere((-3.0, 1.0, 2.0), 0.8,
                   ir.Dielectric(ior=1.4, absorption=(0.1, 0.2, 0.3))), False),
        (ir.Sphere((-4.0, 6.0, 0.0), 1.0, ir.DiffuseLight(ir.Constant((1, 0.9, 0.8)), 2.0)),
         True),
    ]


def _compiled_pair(source):
    if source == "example.sdl":
        cfg = dict(width=32, height=20, samples=4)
        path = os.path.join(REPO, "sdl", "example.sdl")
        jscene, _ = jbuild(path, JConfig(**cfg))
        tscene, _ = tbuild(path, TConfig(**cfg), "cpu")
        return jscene, tscene
    jb, tb = JBuilder(), TBuilder()
    for (jobj, jlight), (tobj, tlight) in zip(_mixed_scene(jir), _mixed_scene(tir)):
        jb.add(jobj, light=jlight)
        tb.add(tobj, light=tlight)
    return jb.compile(), tb.compile()


@pytest.mark.parametrize("source", ["example.sdl", "builder"])
def test_compile_equals_converted_jax_compile(source):
    jscene, tscene = _compiled_pair(source)
    expected = scene_arrays_from_numpy(
        jax.tree_util.tree_map(np.asarray, jscene.arrays), "cpu")
    _assert_same(tscene.arrays, expected)
    for name in ("tex_modes", "mat_kinds", "light_kinds", "has_lights", "has_absorb",
                 "mix_depth"):
        assert getattr(tscene.static, name) == getattr(jscene.static, name), name


@pytest.mark.parametrize("obj", [
    tir.Rect(1, 0.0, 0.0, 1.0, 0.0, 1.0, None),
    tir.Quadric((1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, -1.0), None),
    tir.Sphere((0.0, 0.0, 0.0), 1.0, None, speed=(0.0, 1.0, 0.0)),
    tir.Sphere((0.0, 0.0, 0.0), 1.0, tir.Lambertian(tir.Noise(scale=4.0))),
], ids=["rect", "quadric", "moving-sphere", "perlin"])
def test_unported_features_raise_with_their_roadmap_item(obj):
    b = TBuilder().add(obj)
    with pytest.raises(NotImplementedError, match="ROADMAP M"):
        b.compile()


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def _port_sources():
    files = glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True)
    return sorted(files) + [os.path.join(REPO, "chip_smoke.py")]


def test_port_never_imports_jax_or_the_jax_package():
    """`import jax` cannot be checked through sys.modules in a process that
    has JAX loaded already, so the port's sources are scanned instead."""
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for name in _imports(tree):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "raysnail_tpu"):
                bad.append(f"{os.path.relpath(path, REPO)}: {name}")
    assert not bad, bad
    assert len(_port_sources()) > 20


def test_plain_sphere_sweep_is_reached_only_from_cpu_tensors():
    """The wrapper calls its plain version in one place, under the CPU branch,
    and nothing in the package catches an exception around the kernel."""
    calls, handlers = [], []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and getattr(node.func, "id", None) == \
                    "sphere_min_t_plain":
                calls.append((os.path.relpath(path, REPO), node.lineno))
            if isinstance(node, ast.ExceptHandler):
                handlers.append((os.path.relpath(path, REPO), node.lineno))
    ops = os.path.join("raysnail_tpu_torch", "ops", "sphere_min_t.py")
    port_calls = [c for c in calls if c[0] != "chip_smoke.py"]
    assert len(port_calls) == 1 and port_calls[0][0] == ops, calls
    assert not [h for h in handlers if h[0] == ops], handlers

"""What the benchmark makes itself and hands to both sides: the scene
description read from a configuration file and every seed a run draws
from `--seed`.

Nothing here imports the program: the port's scene builder
(`benchmark/scenes.py`) and the plain reference (`benchmark/reference/`)
both start from what these functions return.
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def config(entry: dict) -> dict:
    """The configuration file that a `configs` entry of BENCHMARK.json
    names, resolved against the checkout's root."""
    return load_json(os.path.join(os.path.dirname(ROOT), entry["file"]))


def scene_with_colors(scene: dict, scale) -> dict:
    """A copy of the scene whose texture colors of the non-emitting objects
    are multiplied, object by object, by the rows of `scale` ((n, 3), one a
    texture color in the objects' order, checker colors odd then even),
    clipped to [0, 1]."""
    out = copy.deepcopy(scene)
    rows = iter(np.asarray(scale, np.float64))
    for obj in out["objects"]:
        mat = obj["material"]
        if mat["kind"] == "diffuse_light":
            continue
        tex = mat["texture"]
        keys = ("color",) if tex["kind"] == "constant" else ("odd", "even")
        for k in keys:
            tex[k] = [float(v) for v in np.clip(np.asarray(tex[k]) * next(rows), 0.0, 1.0)]
    return out


def n_colors(scene: dict) -> int:
    """How many texture colors `scene_with_colors` scales."""
    n = 0
    for obj in scene["objects"]:
        mat = obj["material"]
        if mat["kind"] != "diffuse_light":
            n += 1 if mat["texture"]["kind"] == "constant" else 2
    return n


class Seeds:
    """Every number a run draws, from `--seed` alone: frame and step seeds
    (in [0, 2^32), what the renderer takes), the target's perturbation and
    the sample of outputs that the check compares."""

    def __init__(self, seed: int):
        self.seq = np.random.SeedSequence(int(seed))
        self.render_seeds = np.random.default_rng(self.seq.spawn(1)[0])
        self.check = np.random.default_rng(self.seq.spawn(1)[0])
        self.target = np.random.default_rng(self.seq.spawn(1)[0])

    def next_render_seed(self) -> int:
        return int(self.render_seeds.integers(0, 2**32 - 1))

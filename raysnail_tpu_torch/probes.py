"""Entry point of the traversal probes.

    python -m raysnail_tpu_torch.probes [ab|lat|walkvar|all]
        [--case knot-9600|mesh-200k] [--device cuda|cpu]

The counterpart of the TPU probe scripts `scripts/kern_ab.py` (family "ab":
ray I/O by layout, walk only, sweep only), `scripts/kern_lat.py` ("lat":
walk latency per node step by packet shape) and `scripts/kern_walkvar.py`
("walkvar": the V0-V8 bisect of the real kernel's walk). It builds the case,
runs every probe of the family through `ops.bvh_probes`, holds it against its
plain PyTorch version (integers and min-t bit for bit, the near accumulator
within ACC_RTOL) and prints one line per probe, `label: ms (Mrays/s)`, timed
by CUDA events (the median of TIMING_RUNS calls; and per launch over
LATENCY_REPS launches back to back inside the probe's C entry point, as the
TPU scripts time theirs), after the card's `nvidia-smi` name and power limit.
A probe that disagrees with its plain version raises. On the card the I/O
probes read the case's rays tiled IO_TILE times (16,384,000 rays, 393 MB in
six fields), so that a launch's device time stands above the launch rate.

Family "ab" also takes the traversal kernels apart: the per-ray and the
packet kernel in their three forms (`ops.bvh_traverse.bvh_traverse_form`:
full; "noattr", the TPU kernel's `_NOATTR`; "nosweep", its `_NOSWEEP`),
each held against its plain version, with their device ms a call
(`device_ms`) and the differences: walk and deferral (no sweep), sweep (no
attributes less no sweep), attributes (full less no attributes), and the
sweep's ns a (ray, leaf) sweep.

Cases: "knot-9600" is the scripts' own, the 9,600-triangle knot of
`scripts/mesh_profile.py` under 320x200 primary rays in 16x8 tile order with
`fast_streams(7, pixel)`; "mesh-200k" is the 204,800-triangle knot under the
same rays, the mesh whose frame the render paths are timed on. `probe_sweep`
sweeps every block of knot-9600 and the first 64 of mesh-200k (CASES).

--device cpu runs the plain versions (host-clock times; no device time).
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time

import torch

from raysnail_tpu_torch.geometry.hit import BIG

FAMILIES = ("ab", "lat", "walkvar")
# case -> (n_seg, n_ring) of its knot, and the blocks probe_sweep sweeps (None:
# all; 64,000 rays x mesh-200k's 1,600 blocks would be 7e11 triangle tests)
CASES = {"knot-9600": ((200, 24), None), "mesh-200k": ((1600, 64), 64)}
WIDTH, HEIGHT, SQRT_SPP, RAY_SEED = 320, 200, 4, 7
TIMING_RUNS = 10
PLAIN_RUNS = 1           # a plain lockstep walk takes up to seconds
BACK_TO_BACK_RUNS = 3    # timed windows of LATENCY_REPS launches each
DEVICE_RUNS = 20         # calls queued behind the spin kernel by device_ms
LATENCY_REPS = 32        # back-to-back launches inside one timed window (kern_lat.py REPS)
ACC_RTOL = 1e-5          # the near accumulator against its plain version
# FP32 operations of one (ray, node) slab test and of one (ray, triangle)
# Cramer test, counted from the kernels' sources (compares included)
NODE_FLOPS, TRI_FLOPS = 22, 55
IO_TILE = 256            # the I/O probes' rays on the card: the case's, tiled
SPIN_CYCLES = int(2e8)   # about 0.1 s at the H100's 1.98 GHz: longer than queuing the calls
L2_FLUSH_BYTES = 128 << 20  # written between calls by device_ms(cold=True): 2.5x the L2


class Case:
    """A compiled mesh and one frame of primary rays in tile order."""

    def __init__(self, name, origin, direction, tri, sweep_blocks):
        self.name, self.o, self.d, self.tri = name, origin, direction, tri
        self.sweep_blocks = sweep_blocks

    @property
    def n(self):
        return self.o[0].shape[0]


def build_case(name: str, device: str = "cuda", width: int = WIDTH, height: int = HEIGHT,
               knot=None) -> Case:
    """The probe case `name` on `device` (kern_ab.py:26-42): the knot scene
    compiled, and width x height primary rays of sample 0 in 16x8 tile order.
    knot = (n_seg, n_ring) overrides the case's knot."""
    from raysnail_tpu_torch.camera import generate_rays
    from raysnail_tpu_torch.config import RenderConfig
    from raysnail_tpu_torch.prelude import rng as prng
    from raysnail_tpu_torch.render import _tile_grid
    from raysnail_tpu_torch.utils import golden

    dev = torch.device(device)
    cfg = RenderConfig(width=width, height=height, samples=SQRT_SPP * SQRT_SPP, max_depth=6)
    case_knot, sweep_cap = CASES[name]
    scene, cam = golden.mesh_scene(cfg, dev, *(knot or case_knot))
    px, py, _ = _tile_grid(cfg)
    px = torch.as_tensor(px, dtype=cfg.dtype, device=dev)
    py = torch.as_tensor(py, dtype=cfg.dtype, device=dev)
    keys = prng.fast_streams(RAY_SEED, py.to(torch.int64) * width + px.to(torch.int64))
    zero = torch.zeros_like(px)
    ray = generate_rays(cam, px, py, zero, zero, SQRT_SPP, width, height, keys)
    tri = scene.arrays.triangles
    n_blocks = tri.pk_tri.shape[0]
    sweep_blocks = min(n_blocks, sweep_cap or n_blocks)
    cols = lambda v: tuple(c.contiguous() for c in v)
    return Case(name, cols(ray.origin), cols(ray.direction), tri, sweep_blocks)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, device, runs: int) -> float:
    """Median milliseconds of `fn` over `runs` calls after one warm-up: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(runs):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_ms(fn, runs: int = DEVICE_RUNS, cold: bool = False) -> float:
    """Device milliseconds per call of `fn`: after a warm-up, `runs` calls
    queued behind a spin kernel (torch.cuda._sleep), so that the card runs
    them back to back, timed between two CUDA events. Raises if queuing the
    calls outlasted the spin, when host time would have entered.
    cold=True writes L2_FLUSH_BYTES before each call, outside its events
    (a pair of events a call, their times summed), so that the call finds
    its inputs in device memory and not in the 50 MB L2 cache."""
    fn()
    torch.cuda.synchronize()
    flush = torch.empty(L2_FLUSH_BYTES // 4, device="cuda") if cold else None
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(runs if cold else 1)]
    start, end = pairs[0][0], pairs[-1][1]
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    if cold:
        for i, (a, b) in enumerate(pairs):
            flush.fill_(float(i))
            a.record()
            fn()
            b.record()
    else:
        start.record()
        for _ in range(runs):
            fn()
        end.record()
    queued = time.perf_counter() - t0
    end.synchronize()
    spin = torch.cuda.Event(enable_timing=True)
    spun = torch.cuda.Event(enable_timing=True)
    spin.record()
    torch.cuda._sleep(SPIN_CYCLES)
    spun.record()
    spun.synchronize()
    if queued * 1e3 >= spin.elapsed_time(spun):
        raise AssertionError(f"device_ms: queuing {runs} calls took {queued:.4f} s, longer "
                             f"than the spin kernel")
    if cold:
        return sum(a.elapsed_time(b) for a, b in pairs) / runs
    return start.elapsed_time(end) / runs


def _tensors(out) -> dict:
    """name -> tensor of a probe's result (a tensor or a NamedTuple of them)."""
    if isinstance(out, torch.Tensor):
        return {"value": out}
    return {k: v for k, v in out._asdict().items() if v is not None}


def compare(key: str, out, ref) -> dict:
    """A probe's result against its plain version's: integers and t bit for
    bit, the near accumulator within ACC_RTOL. -> {"max_abs_err", "acc_rel",
    "bit_equal"}; raises AssertionError on a disagreement."""
    got, want = _tensors(out), _tensors(ref)
    if got.keys() != want.keys():
        raise AssertionError(f"{key}: outputs {sorted(got)} vs plain {sorted(want)}")
    err, acc_rel, bit_equal, bad = 0.0, 0.0, True, []
    accumulates = key.startswith(("latency/", "variant/"))
    for name, a in got.items():
        b = want[name]
        same = bool(torch.equal(a, b))
        bit_equal &= same
        if a.dtype.is_floating_point:
            finite = (a < BIG) & (b < BIG)
            if bool(finite.any()):
                err = max(err, float((a - b)[finite].abs().max()))
        if accumulates and name in ("value", "acc"):
            scale = b.abs().clamp_min(1e-30)
            acc_rel = float(((a - b).abs() / scale).max()) if a.numel() else 0.0
            if acc_rel > ACC_RTOL:
                bad.append(f"{name} (rel {acc_rel})")
        elif not same:
            bad.append(name)
    if bad:
        raise AssertionError(f"{key}: kernel disagrees with its plain version in {bad}")
    return {"max_abs_err": err, "acc_rel": acc_rel, "bit_equal": bit_equal}


def _probes(family: str, case: Case, kept: dict):
    """(launch key, label, call(reps), plain(stats), rays, ray bytes in and
    out) of every probe of `family` on `case`. `kept` holds the bisect's
    lockstep runs: one serves every variant with the same sweep."""
    from raysnail_tpu_torch.ops import bvh_probes as bp

    o, d, tri = case.o, case.d, case.tri
    tree = (tri.pk_bb, tri.pk_links)
    n = case.n
    if family == "ab":
        tile = IO_TILE if o[0].is_cuda else 1
        oi, di = (tuple(c.repeat(tile) for c in v) for v in (o, d))
        packed = bp.pack_rays(oi, di)
        for layout in bp.IO_LAYOUTS:
            words = 9 if layout == "packed" else 7
            yield (f"io/{layout}", f"io-only ({layout}, {n * tile} rays)",
                   lambda reps, layout=layout: bp.probe_io(oi, di, layout, packed, reps),
                   lambda stats: bp.probe_io_plain(oi, di), n * tile, n * tile * words * 4)
        for shape in bp.SHAPES:
            yield (f"walk/{shape}", f"walk-only ({shape})",
                   lambda reps, shape=shape: bp.probe_walk(o, d, *tree, shape, reps),
                   lambda stats, shape=shape: bp.probe_walk_plain(o, d, *tree, shape, stats),
                   n, n * 10 * 4)
        for shape in bp.SHAPES:
            nb = case.sweep_blocks

            def sweep_plain(stats, nb=nb):
                stats.update(sweeps=n * nb, leaves=nb)
                return bp.probe_sweep_plain(o, d, tri.pk_tri, nb)

            yield (f"sweep/{shape}", f"sweep-all ({nb} blocks, {shape})",
                   lambda reps, shape=shape, nb=nb: bp.probe_sweep(o, d, tri.pk_tri, shape, nb,
                                                                   reps),
                   sweep_plain, n, n * 8 * 4)
    elif family == "lat":
        labels = {"w32": "walk, warp packet (32/pkt)", "w128": "walk, block packet (128/pkt)",
                  "w1024": "walk, block packet (1024/pkt)", "cap": "walk 128/pkt + cap",
                  "buf": "walk 128/pkt + cap + buf/chunks"}
        for variant in bp.LATENCY_VARIANTS:
            yield (f"latency/{variant}", labels[variant],
                   lambda reps, v=variant: bp.probe_walk_latency(o, d, *tree, v, reps=reps),
                   lambda stats, v=variant: bp.probe_walk_latency_plain(o, d, *tree, v,
                                                                        stats=stats),
                   n, n * 10 * 4)
    elif family == "walkvar":
        for shape in bp.SHAPES:
            for v in bp.VARIANTS:
                def plain(stats, v=v, shape=shape):
                    memo = kept.setdefault(("lockstep", shape, bp.variant_sweep(v)), {})
                    if not memo:
                        t0 = time.perf_counter()
                        stats_run = {}
                        memo["res"] = bp.lockstep(o, d, *tree, bp.SHAPES[shape],
                                                  sweep=bp.variant_sweep(v), pk_tri=tri.pk_tri,
                                                  stats=stats_run)
                        if o[0].is_cuda:
                            torch.cuda.synchronize()
                        memo["stats"] = {**stats_run,
                                         "plain_ms": (time.perf_counter() - t0) * 1e3}
                    stats.update(memo["stats"])
                    return bp.variant_view(v, memo["res"])

                yield (f"variant/V{v}/{shape}", f"V{v} ({shape})",
                       lambda reps, v=v, shape=shape: bp.probe_walk_variant(
                           v, o, d, *tree, tri.pk_tri, shape, reps),
                       plain, n, n * (13 + (5 if v >= 7 else 0)) * 4)
    else:
        raise ValueError(f"unknown probe family {family!r}")


def run(family: str, case: Case, out=print, plain=None) -> list:
    """Run, check and time every probe of `family` ("all": every family) on
    `case` -> one record per probe: name (the launch key), label, ms,
    plain_ms, max_abs_err, bit_equal, bytes and flops (what this case's rays
    needed, by the plain version's count) and, for the walks, steps; with
    family "ab" also one per traversal kernel and form (`traversal_forms`).
    `plain` is the caller's dict of the plain versions' results on this
    case: a result found there is not computed again, a new one is added."""
    from raysnail_tpu_torch.ops import bvh_probes as bp

    device = case.o[0].device
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    plain_kept = {} if plain is None else plain
    records = []
    for fam in (FAMILIES if family == "all" else (family,)):
        for key, label, call, plain_fn, rays, ray_bytes in _probes(fam, case, plain_kept):
            got = call(1)
            sync()
            if key not in plain_kept:
                stats = {}
                t0 = time.perf_counter()
                ref = plain_fn(stats)
                sync()
                # a lockstep run shared by several variants reports its own time
                plain_kept[key] = (ref, stats, stats.pop("plain_ms",
                                                         (time.perf_counter() - t0) * 1e3))
            ref, stats, plain_ms = plain_kept[key]
            rec = {"name": key, "label": label, "plain_ms": plain_ms,
                   **compare(key, got, ref)}
            runs = TIMING_RUNS if on_card else PLAIN_RUNS
            rec["ms"] = time_ms(lambda: call(1), device, runs)
            rec["bytes"] = (ray_bytes + stats.get("nodes", 0) * 48
                            + stats.get("leaves", 0) * 10 * bp.LANES * 4)
            rec["flops"] = (stats.get("node_tests", 0) * NODE_FLOPS
                            + stats.get("sweeps", 0) * bp.LANES * TRI_FLOPS
                            + (rays * 5 if key.startswith("io/") else 0))
            line = f"{label}: {rec['ms']:9.4f} ms ({rays / rec['ms'] / 1e3:9.2f} Mrays/s)"
            if fam != "ab" or key.startswith("walk/"):
                tail = key.rsplit("/", 1)[1]
                width = bp.SHAPES.get(tail) or bp.LATENCY_VARIANTS[tail][0]
                steps = _tensors(ref)["steps"].long()
                rec["steps"] = int(steps[::width].sum())       # summed over packets
                rec["longest"] = int(steps.max())
                line += (f" {rec['steps']} packet node steps (longest walk {rec['longest']}),"
                         f" {rec['ms'] * 1e6 / max(rec['steps'], 1):8.2f} ns each")
            if on_card:
                # the scripts' window, LATENCY_REPS launches back to back
                # inside the C entry point: a single call under about 0.1 ms
                # reads the wrapper's host time
                rec["ms_back_to_back"] = time_ms(lambda: call(LATENCY_REPS), device,
                                                 BACK_TO_BACK_RUNS) / LATENCY_REPS
                line += (f"; {rec['ms_back_to_back']:9.4f} ms/launch over {LATENCY_REPS} "
                         f"back-to-back launches")
                if "steps" in rec:
                    line += (f", {rec['ms_back_to_back'] * 1e6 / max(rec['steps'], 1):8.2f} "
                             f"ns/step")
            line += (f" [plain {plain_ms:.1f} ms; equal {rec['bit_equal']}, max|d| "
                     f"{rec['max_abs_err']!r}]")
            out(line)
            rec["launch_key"] = key
            records.append(rec)
        if fam == "ab":
            records += traversal_forms(case, out, plain_kept)
    return records


FORM_LABELS = {"full": "full", "noattr": "no attributes", "nosweep": "no sweep"}


def traversal_forms(case: Case, out=print, plain=None) -> list:
    """The whole traversal on the probe's rays, beside its phases (kern_ab.py
    prints the full kernel beside its io, walk and sweep lines), and taken
    apart: the per-ray and the packet kernel of `ops.bvh_traverse`, kind
    "tri", no cap, `stream` and `two_level` off, in their three forms. The
    full form's t must equal the bisect's V4, which sweeps every leaf a
    ray's slab admits; the no-attributes form's t the full form's; the
    no-sweep form must miss on every ray; each form must equal its plain
    version in every output. One line a kernel; -> one record a kernel and
    form: name "traversal/<form>/<per-ray|packet>", ms (a call), device_ms
    (on the card), plain_ms, bytes and flops (what the case's rays needed),
    sweeps and, beside the full form's, the split."""
    from raysnail_tpu_torch.ops import bvh_probes as bp
    from raysnail_tpu_torch.ops import bvh_traverse as bt

    device = case.o[0].device
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    kept = {} if plain is None else plain
    tri, n = case.tri, case.n
    args = (case.o, case.d, torch.full_like(case.o[0], BIG), tri.pk_bb, tri.pk_links,
            tri.pk_tri, bp.T_MIN, BIG)
    want = bp.probe_walk_variant(4, case.o, case.d, tri.pk_bb, tri.pk_links, tri.pk_tri, "ray").t
    records = []
    for packet in (False, True):
        shape = "packet" if packet else "per-ray"
        calls = {"full": lambda p=packet: bt.bvh_traverse(*args, kind="tri", packet=p,
                                                          stream=False, two_level=False),
                 **{f: (lambda f=f, p=packet: bt.bvh_traverse_form(f, *args, kind="tri",
                                                                   packet=p))
                    for f in bt.FORMS}}
        full_t = calls["full"]()[0]
        got = {f: calls[f]() for f in bt.FORMS}
        sync()
        for f in bt.FORMS:
            if (f, shape) not in kept:
                stats = {}
                t0 = time.perf_counter()
                ref = bt.bvh_traverse_form_plain(f, *args, kind="tri", packet=packet,
                                                 stats=stats)
                sync()
                kept[f, shape] = (ref, stats, (time.perf_counter() - t0) * 1e3)
        agree = {f: all(torch.equal(a, b) for a, b in zip(got[f], kept[f, shape][0])
                        if a is not None) for f in bt.FORMS}
        checks = {"t equals V4's": bool(torch.equal(full_t, want)),
                  "forms equal their plain versions": all(agree.values()),
                  "no-attributes t equals full's": bool(torch.equal(got["noattr"].t, full_t)),
                  "no-sweep misses": bool((got["nosweep"].t == BIG).all())}
        runs = TIMING_RUNS if on_card else PLAIN_RUNS
        ms = {f: time_ms(call, device, runs) for f, call in calls.items()}
        dev = {f: device_ms(call) for f, call in calls.items()} if on_card else {}
        full_stats, ns_stats = kept["noattr", shape][1], kept["nosweep", shape][1]
        sweeps = {f: int(got[f].sweeps.sum()) for f in bt.FORMS}
        sweeps["full"] = sweeps["noattr"]
        n_hit = int((full_t < BIG).sum())
        read = n * 7 * 4 + full_stats["nodes"] * 48 + full_stats["leaves"] * bt.STAGED_FLOATS[
            "tri"] * 4
        walk_flops = full_stats["node_tests"] * NODE_FLOPS
        work = {"full": (read + n * 6 * 4 + n_hit * bt.ATTR_WORDS["tri"] * 4,
                         walk_flops + full_stats["sweeps"] * bp.LANES * TRI_FLOPS),
                "noattr": (read + n * 2 * 4, walk_flops + full_stats["sweeps"] * bp.LANES
                           * TRI_FLOPS),
                "nosweep": (n * 11 * 4 + ns_stats["nodes"] * 48,
                            ns_stats["node_tests"] * NODE_FLOPS)}
        for f in calls:
            rec = {"name": f"traversal/{f}/{shape}", "ms": ms[f],
                   "plain_ms": kept["noattr" if f == "full" else f, shape][2],
                   "bytes": work[f][0], "flops": work[f][1], "sweeps": sweeps[f],
                   "max_abs_err": 0.0, "bit_equal": agree.get(f, True)}
            if on_card:
                rec["device_ms"] = dev[f]
            records.append(rec)
        same_v4 = checks.pop("t equals V4's")
        line = (f"full traversal ({shape} kernel): {ms['full']:9.4f} ms "
                f"({n / ms['full'] / 1e3:9.2f} Mrays/s) [t equals V4's: {same_v4}]")
        if on_card:
            split = {"walk + deferral": dev["nosweep"], "sweep": dev["noattr"] - dev["nosweep"],
                     "attributes": dev["full"] - dev["noattr"]}
            records[-len(calls)]["split"] = split  # beside the full form's
            line += ("; device ms a call: " + ", ".join(f"{FORM_LABELS[f]} {dev[f]!r}"
                                                        for f in calls)
                     + " = " + ", ".join(f"{k} {v!r}" for k, v in split.items())
                     + f"; {sweeps['full']} (ray, leaf) sweeps, "
                     f"{split['sweep'] * 1e6 / max(sweeps['full'], 1):.3f} ns a sweep")
        else:
            line += "; device ms: not measured on the cpu"
        line += ("; call ms: " + ", ".join(f"{FORM_LABELS[f]} {ms[f]!r}" for f in bt.FORMS)
                 + " [" + "; ".join(f"{k}: {v}" for k, v in checks.items()) + "]")
        out(line)
        if not (same_v4 and all(checks.values())):
            raise AssertionError(f"the {shape} traversal's forms fail their checks: {checks}")
    return records


def main(argv=None, case=None, plain=None) -> int:
    """The entry point. `case` is a Case built already for --case and
    --device (else it is built here), `plain` as for `run`."""
    ap = argparse.ArgumentParser(prog="raysnail_tpu_torch.probes",
                                 description="Phase probes of the BVH traversal kernels")
    ap.add_argument("family", nargs="?", default="all", choices=(*FAMILIES, "all"))
    ap.add_argument("--case", default="knot-9600", choices=tuple(CASES))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda: no CUDA device is available")
        print(card_line())
    else:
        print("cpu: the plain versions, host-clock times")
    if case is None:
        case = build_case(args.case, device)
    elif case.name != args.case or case.o[0].device.type != device.type:
        raise ValueError(f"the case given is {case.name} on {case.o[0].device}, not "
                         f"{args.case} on {device}")
    tri = case.tri
    print(f"case {case.name}: rays={case.n} nodes={tri.pk_bb.shape[1]} "
          f"orders={tri.pk_bb.shape[0]} blocks={tri.pk_tri.shape[0]}", flush=True)
    run(args.family, case, plain=plain)
    return 0


if __name__ == "__main__":
    sys.exit(main())

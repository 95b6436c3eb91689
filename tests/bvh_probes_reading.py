"""The probes' sweeps (P1c sweep-all and the bisect's V4-V8) and the
traversal kernels' full form against a parent commit's, on one card in one
process:

    python tests/bvh_probes_reading.py --parent DIR

DIR is an unpacked checkout of the parent commit (`git archive <commit> |
tar -x -C DIR`); its `raysnail_tpu_torch/csrc/bvh_probes.cu`,
`bvh_traverse.cu` and `bvh_packet.cu` are built beside this tree's with the
same flags and called through its own wrappers (its `ops/bvh_probes.py` and
`ops/bvh_traverse.py`, imported under other names). Every source is also
compiled once more with -Xptxas -v, whose registers, stack and shared
memory a kernel it prints. On the probes' cases (mesh-200k, knot-9600) it
prints:

  * each probe's and each full traversal kernel's outputs, the parent's and
    this tree's, bit for bit their plain version's (and so each other's);
  * their device ms a call (`probes.device_ms`) in the order parent,
    change, change, parent;
  * this tree's traversal forms and the split of the full kernels' device
    time (`probes.traversal_forms`);

and the SASS opcodes of each side's sweep-all kernels (cuobjdump), with
the instructions that one (ray, triangle) test issues. It needs a CUDA
card, nvcc and cuobjdump, and no JAX; the card's name and power limit come
first and last.
"""

import argparse
import collections
import concurrent.futures
import glob
import importlib.util
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from raysnail_tpu_torch import probes  # noqa: E402
from raysnail_tpu_torch.geometry.hit import BIG  # noqa: E402
from raysnail_tpu_torch.ops import _nvcc  # noqa: E402
from raysnail_tpu_torch.ops import bvh_probes as bp  # noqa: E402
from raysnail_tpu_torch.ops import bvh_traverse as bt  # noqa: E402

CSRC = os.path.join("raysnail_tpu_torch", "csrc")
SOURCES = ("bvh_probes.cu", "bvh_traverse.cu", "bvh_packet.cu")
ORDER = ("parent", "change", "change", "parent")
SWEEP_VARIANTS = (4, 5, 7, 8)
# the opcodes a (ray, triangle) test issues, and the sweep's plumbing
OPCODES = ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "MUFU.RCP", "FCHK", "SHFL",
           "LDG", "LDS", "ISETP", "BRA", "BAR")


def phase(msg: str):
    print(f"[reading] {msg}", flush=True)


def build(root: str, name: str, verbose: bool = False) -> str:
    csrc = os.path.join(root, CSRC)
    headers = sorted(glob.glob(os.path.join(csrc, "*.cuh")))
    return _nvcc.build(os.path.join(csrc, name), _nvcc.nvcc(), _nvcc.NVCC_FLAGS, verbose,
                       headers)


def ptxas(root: str, name: str, label: str) -> list:
    """Compile `name` of `root` once more with -Xptxas -v -> one line a
    kernel: its template arguments, registers, stack and shared memory."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_nvcc.nvcc(), *_nvcc.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               os.path.join(tmp, "lib.so"), os.path.join(root, CSRC, name)]
        text = subprocess.run(cmd, capture_output=True, text=True, check=True).stderr
    lines, kernel = [], None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function .*?([a-z][a-z_]+_kernel)I(\w*?)EEv", ln)
        if m:
            args = ",".join(v for _, v in re.findall(r"L([ib])(\d+)E", m.group(2)))
            kernel = f"{m.group(1)}<{args}>"
        elif "Used" in ln and kernel:
            lines.append(f"{label} {kernel}: {ln.split('Used', 1)[1].strip()}")
            kernel = None
    return lines


def sass_counts(lib: str, label: str):
    """The opcodes of the sweep-all kernels of one side's probe library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    for part in text.split("Function : ")[1:]:
        fn = part.split()[0]
        if "probe_sweep_kernel" not in fn:
            continue
        width = re.search(r"probe_sweep_kernelILi(\d+)E", fn).group(1)
        ops = [m.group(1) for m in re.finditer(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9.]+)",
                                               part)]
        counts = collections.Counter("MUFU.RCP" if op.startswith("MUFU.RCP") else
                                     op.split(".")[0] for op in ops)
        phase(f"sass {label} probe_sweep_kernel<{width}>: {len(ops)} instructions; "
              + ", ".join(f"{op} {counts.get(op, 0)}" for op in OPCODES))


def module(root: str, rel: str, name: str, libs: dict):
    """`rel` of `root` imported as `name`, its kernels' libraries `libs`."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(root, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for fn, lib in libs.items():
        setattr(mod, fn, lambda verbose=False, lib=lib: lib)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="an unpacked checkout of the parent")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bvh_probes_reading: needs a CUDA card")
    card = probes.card_line()
    phase(card)
    roots = {"parent": os.path.abspath(args.parent), "change": ROOT}
    jobs = [(side, name) for side in roots for name in SOURCES]
    with concurrent.futures.ThreadPoolExecutor(2 * len(jobs)) as pool:
        libs = {job: pool.submit(build, roots[job[0]], job[1]) for job in jobs}
        verbose = {job: pool.submit(ptxas, roots[job[0]], job[1], job[0]) for job in jobs}
        libs = {job: f.result() for job, f in libs.items()}
        for job in jobs:
            for ln in verbose[job].result():
                phase(f"ptxas {job[1]} {ln}")
    for side in roots:
        sass_counts(libs[side, "bvh_probes.cu"], side)
    mods = {"parent": {
        "bp": module(roots["parent"], "raysnail_tpu_torch/ops/bvh_probes.py",
                     "parent_bvh_probes", {"build": libs["parent", "bvh_probes.cu"]}),
        "bt": module(roots["parent"], "raysnail_tpu_torch/ops/bvh_traverse.py",
                     "parent_bvh_traverse", {"build": libs["parent", "bvh_traverse.cu"],
                                             "build_packet": libs["parent", "bvh_packet.cu"]})},
        "change": {"bp": bp, "bt": bt}}

    for case_name in probes.CASES:
        case = probes.build_case(case_name, "cuda")
        tri = case.tri
        tree = (tri.pk_bb, tri.pk_links)
        cap = torch.full_like(case.o[0], BIG)
        phase(f"case {case_name}: rays={case.n} nodes={tri.pk_bb.shape[1]} blocks="
              f"{tri.pk_tri.shape[0]}, sweep-all {case.sweep_blocks} blocks")
        calls = {}
        for shape in bp.SHAPES:
            calls[f"sweep/{shape}"] = (
                lambda m, s=shape: m["bp"].probe_sweep(case.o, case.d, tri.pk_tri, s,
                                                       case.sweep_blocks),
                lambda s=shape: bp.probe_sweep_plain(case.o, case.d, tri.pk_tri,
                                                     case.sweep_blocks))
            for v in SWEEP_VARIANTS:
                calls[f"variant/V{v}/{shape}"] = (
                    lambda m, v=v, s=shape: m["bp"].probe_walk_variant(v, case.o, case.d, *tree,
                                                                       tri.pk_tri, s),
                    lambda v=v, s=shape: bp.probe_walk_variant_plain(v, case.o, case.d, *tree,
                                                                     tri.pk_tri, s))
        for packet in (False, True):
            calls[f"traversal/{'packet' if packet else 'per-ray'}"] = (
                lambda m, p=packet: m["bt"].bvh_traverse(
                    case.o, case.d, cap, *tree, tri.pk_tri, bp.T_MIN, BIG, kind="tri", packet=p,
                    stream=False, two_level=False),
                lambda p=packet: bt.bvh_traverse_plain(case.o, case.d, cap, *tree, tri.pk_tri,
                                                       bp.T_MIN, BIG, kind="tri", packet=p))
        for key, (call, plain) in calls.items():
            ref = plain()
            equal = {}
            for side in roots:
                got = call(mods[side])
                torch.cuda.synchronize()
                if key.startswith("traversal/"):
                    equal[side] = all(bool(torch.equal(a, b)) for a, b in zip(got, ref))
                else:
                    equal[side] = probes.compare(key, got, ref)["bit_equal"]
            ms = {side: [] for side in roots}
            for side in ORDER:
                ms[side].append(probes.device_ms(lambda: call(mods[side])))
            phase(f"{case_name} {key}: equal to the plain version {equal}; device ms a call, "
                  f"P C C P: {ms['parent'][0]!r} {ms['change'][0]!r} {ms['change'][1]!r} "
                  f"{ms['parent'][1]!r}; change / parent "
                  f"{sum(ms['change']) / sum(ms['parent'])!r}")
            if not all(equal.values()):
                raise AssertionError(f"{case_name} {key}: a side disagrees with the plain version")
        probes.traversal_forms(case, out=lambda ln, c=case_name: phase(f"{c} {ln}"))
    phase(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())

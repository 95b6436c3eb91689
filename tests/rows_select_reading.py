"""K7 and K7b, the rows' select and its fixed-order transpose, against the
kernels of a parent commit, on one card in one process:

    python tests/rows_select_reading.py --parent DIR

DIR is an unpacked checkout of the parent commit (`git archive <commit> |
tar -x -C DIR`); its `raysnail_tpu_torch/csrc/rows_select.cu` is built
beside this tree's with the same flags and called through its own
wrappers (its `ops/rows_select.py`, imported under another name). Both
sources are
also compiled once with -Xptxas -v, whose registers and shared memory a
kernel it prints. On chip_smoke.py's K7/K7b cases (`chip_smoke.rows_cases`:
example.sdl's material and texture rows of its 400,000 primary rays' hits,
the same in a random order, the static book 1 frame's rows, and those
spread over 1,024 and 4,096 rows), each with a seeded table and cotangent,
it prints:

  * K7b's output bit for bit the parent's and the plain version's, and
    K7's equal to the parent's and to index_select;
  * K7b's and K7's device ms a call (chip_smoke.device_ms) in the order
    parent, change, change, parent, their bound, and index_select's call
    and device ms beside K7's call ms;
  * K7b's segments by the rows they hold, and its route (one launch, or a
    second for the chunks' sum; row tiles);
  * the host microseconds of K7's wrapper and of its pieces (the checks,
    the columns' pass, the output's allocation, the packing, the stream
    lookup, the launch, the split into rows) beside index_select's;

then one cell of the canonical train step (example.sdl 800x500, one
sample, depth 8) whose backward pass runs under torch.profiler through
each K7b in the same order, with K7b's device time and launches there.
It needs a CUDA card and nvcc, and no JAX; the card's name and power limit
come first and last.
"""

import argparse
import ctypes
import importlib.util
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from raysnail_tpu_torch.config import RenderConfig  # noqa: E402
from raysnail_tpu_torch.ops import _nvcc  # noqa: E402
from raysnail_tpu_torch.ops import rows_select as rs  # noqa: E402

SOURCE = os.path.join("raysnail_tpu_torch", "csrc", "rows_select.cu")
ORDER = ("parent", "change", "change", "parent")


def parent_module(parent_root: str, lib_path: str):
    """The parent's ops/rows_select.py, imported under another name, with
    its kernels' library the parent's."""
    path = os.path.join(parent_root, "raysnail_tpu_torch", "ops", "rows_select.py")
    spec = importlib.util.spec_from_file_location("parent_rows_select", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build = lambda verbose=False: lib_path
    mod._load()
    return mod


def ptxas(src: str, label: str):
    """Compile `src` once more with -Xptxas -v, into a file not kept, and
    print each kernel's registers, spills and shared memory."""
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [_nvcc.nvcc(), *_nvcc.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               os.path.join(tmp, "lib.so"), src]
        proc = subprocess.run(cmd, capture_output=True, text=True, check=True)
    lines = [ln.strip() for ln in proc.stderr.splitlines()
             if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
    for ln in lines:
        cs.phase("ptxas", f"{label}: {ln}")


# a timed copy of the change's source: thread 0 of each K7b block writes
# %globaltimer at its start, after each phase, after its ticket and after
# the last block's sum, and its %smid, to g_record[block][8]
TIMER = r'''
__device__ unsigned long long* g_record;
__device__ __forceinline__ unsigned long long stamp_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(i)                                                                  \
  do {                                                                            \
    if (threadIdx.x == 0 && g_record != nullptr) {                                \
      g_record[blockIdx.x * 8 + (i)] = stamp_now();                               \
      unsigned sm;                                                                \
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));                             \
      g_record[blockIdx.x * 8 + 7] = sm;                                          \
    }                                                                             \
  } while (0)
'''
SET_RECORD = r'''
extern "C" int rows_select_set_record(void* p) {
  return static_cast<int>(cudaMemcpyToSymbol(g_record, &p, sizeof(p)));
}
'''
STAMPS = (("#include <cassert>\n", "#include <cassert>\n" + TIMER),
          ("  extern __shared__ __align__(16) float smem[];\n",
           "  extern __shared__ __align__(16) float smem[];\n  STAMP(0);\n"),
          *(("  __syncthreads();\n\n  // (" + p, f"  __syncthreads();\n  STAMP({i});\n\n  // (" + p)
            for i, p in ((1, "B) the walk"), (2, "C) the run's"), (3, "D) the chunk's"))),
          ("  if (ticket == nullptr) return;", "  STAMP(4);\n  if (ticket == nullptr) return;"),
          ("  if (!last) return;\n", "  if (!last) return;\n  STAMP(5);\n"),
          ("smem, smem_floats, out);\n", "smem, smem_floats, out);\n  STAMP(6);\n"))


def timed_library(src: str, tmp: str) -> str:
    """The change's source with K7b's phase stamps, built; -> its path."""
    with open(src) as f:
        text = f.read()
    for old, new in STAMPS:
        if text.count(old) != 1:
            raise RuntimeError(f"{src}: no single {old!r} to stamp")
        text = text.replace(old, new)
    path = os.path.join(tmp, "rows_select_timed.cu")
    with open(path, "w") as f:
        f.write(text + SET_RECORD)
    return _nvcc.build(path, _nvcc.nvcc(), _nvcc.NVCC_FLAGS)


def phases(lib, name: str, idx, rows: int, k: int, gen):
    """One launch of the stamped K7b: each block's phases (us, median and
    max over the blocks), the spread of the blocks' starts, the last
    block's wait for its ticket and its sum, the kernel's span, and the
    blocks an SM."""
    n = idx.shape[0]
    g = torch.randn(n, k, generator=gen, device=idx.device)
    chunks = -(-n // rs.CHUNK)
    rec = torch.zeros(chunks * 8, dtype=torch.int64, device=idx.device)
    out = torch.empty((k, rows), device=idx.device)
    part = torch.empty(chunks * (-(-rows * k // 4) * 4), device=idx.device)
    ticket = torch.zeros(1, dtype=torch.int32, device=idx.device)
    cols = rs._columns("g", g.unbind(1), n, idx.get_device())
    args = rs._K7B_ARGS[k].pack(n, rows, k, idx.data_ptr(), part.data_ptr(), ticket.data_ptr(),
                                out.data_ptr(), *cols)
    stream = torch.cuda.current_stream().cuda_stream
    for record in (0, rec.data_ptr()):  # a warm-up launch, then the stamped one
        if lib.rows_select_set_record(record) or lib.rows_select_bwd_launch(args, stream):
            raise RuntimeError("the stamped K7b failed to launch")
        torch.cuda.synchronize()
    want = rs.rows_select_bwd_plain(g, idx, rows)
    if not torch.equal(out.t(), want):
        raise AssertionError(f"{name}: the stamped K7b disagrees with the plain version")
    t = rec.view(chunks, 8).cpu().numpy().astype(np.float64)
    t0 = t[:, 0].min()
    us = lambda a: np.round(a / 1e3, 3).tolist()  # noqa: E731
    one = rows * k <= 64
    last = int(np.argmax(t[:, 6]))  # the block that summed (one launch)
    ends = t[:, 4].copy()
    if one:
        ends[last] = t[last, 6]
    out_ = {f"phase {p}": [us(np.median(t[:, i + 1] - t[:, i])), us((t[:, i + 1] - t[:, i]).max())]
            for i, p in enumerate("ABCD")}
    out_.update({"starts spread": us(t[:, 0].max() - t0),
                 "last phase D ends": us(t[:, 4].max() - t0),
                 "span": us(ends.max() - t0),
                 "blocks an SM (max)": int(np.bincount(t[:, 7].astype(np.int64)).max())})
    if one:
        out_.update({"ticket wait (last block)": us(t[last, 5] - t[last, 4]),
                     "sum of the chunks (last block)": us(t[last, 6] - t[last, 5])})
    cs.phase("rows", f"{name}: stamped K7b, one launch of N={n} R={rows} K={k}, {chunks} "
             f"blocks: {out_}")


def host_us(fn, calls: int = 2000, block: int = 50) -> float:
    """Host microseconds a call of `fn` (perf_counter over blocks of
    `block` calls, the card synchronised between blocks, outside the
    clock), after a warm-up: what a call costs the host before the card
    sees it."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(calls // block):
        t0 = time.perf_counter()
        for _ in range(block):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total / (calls // block * block) * 1e6


def host_costs(cols, idx, table) -> dict:
    """K7's wrapper on the host, piece by piece, beside index_select's call."""
    k, rows, n = len(cols), cols[0].shape[0], idx.shape[0]
    dev = idx.get_device()
    out = torch.empty((k, n), device=idx.device)
    launch = rs._K7_ARGS[k].pack(n, rows, k, idx.data_ptr(), out.data_ptr(),
                                 *rs._columns("c", cols, rows, dev))
    lib = rs._load()
    with cs.counts_kept():
        return {
            "rows_select": host_us(lambda: rs.rows_select(cols, idx)),
            "index_select": host_us(lambda: torch.index_select(table, 0, idx)),
            "idx checks": host_us(lambda: rs._cuda_index(idx, rows, k)),
            "columns": host_us(lambda: rs._columns("a column", cols, rows, dev)),
            "empty": host_us(lambda: torch.empty((k, n), dtype=torch.float32, device=dev)),
            "idx.new_empty": host_us(lambda: idx.new_empty((k, n), dtype=torch.float32)),
            "column.new_empty": host_us(lambda: cols[0].new_empty((k, n))),
            "pack": host_us(lambda: rs._K7_ARGS[k].pack(n, rows, k, 1, 2, *range(2 * k))),
            "streams": host_us(lambda: (torch._C._cuda_getDevice(),
                                        torch._C._cuda_getCurrentRawStream(dev))),
            "launch": host_us(lambda: rs._launch("k7", lib.rows_select_launch, dev, launch)),
            "split": host_us(lambda: out.unbind(0)),
            "bytes": len(launch)}


def one_case(parent, name: str, idx, rows: int, k: int, gen, label: str):
    table = torch.randn(rows, k, generator=gen, device=idx.device)
    g = torch.randn(idx.shape[0], k, generator=gen, device=idx.device)
    cols, gs = table.unbind(1), g.unbind(1)
    # the parent's K7 returned the K rows (unbind); the change returns the
    # (K, N) tensor, and take_rows splits it: its call is read both ways
    fwd = {"parent": lambda: parent.rows_select(cols, idx),
           "change": lambda: rs.rows_select(cols, idx)}
    split = lambda: rs.rows_select(cols, idx).unbind(0)  # noqa: E731
    bwd = {"parent": lambda: parent.rows_select_bwd(gs, idx, rows),
           "change": lambda: rs.rows_select_bwd(gs, idx, rows)}
    select = lambda: torch.index_select(table, 0, idx)  # noqa: E731
    with cs.counts_kept():
        got = {side: torch.stack(fn(), 1) for side, fn in bwd.items()}
        out = {"parent": torch.stack(fwd["parent"](), 0), "change": fwd["change"]()}
        want = rs.rows_select_bwd_plain(g, idx, rows)
        torch.cuda.synchronize()
        bits = lambda x: x.view(torch.int32)  # noqa: E731
        bwd_same = torch.equal(bits(got["change"]), bits(got["parent"]))
        bwd_plain = torch.equal(bits(got["change"]), bits(want))
        fwd_same = torch.equal(out["change"], out["parent"]) and torch.equal(
            out["change"].t(), select())
        ms = {"K7b": {}, "K7": {}, "K7 call": {}}
        for side in ORDER:
            ms["K7b"].setdefault(side, []).append(cs.device_ms(bwd[side]))
            ms["K7"].setdefault(side, []).append(cs.device_ms(fwd[side]))
            ms["K7 call"].setdefault(side, []).append(cs.time_ms(fwd[side]))
        library = {"call": cs.time_ms(select), "device": cs.device_ms(select),
                   "split": cs.time_ms(split)}
        host = host_costs(cols, idx, table)
    n_bytes = idx.shape[0] * (8 + 4 * k) + rows * k * 4
    b = cs.bound(n_bytes, 0)["bound_ms"]
    cs.phase("rows", f"{name} ({label}): N={idx.shape[0]} R={rows} K={k}; K7b "
             f"({cs.k7b_route(rows, k)}) change == parent {bwd_same}, == plain {bwd_plain}; "
             f"K7 change == parent and index_select {fwd_same}; K7b device ms parent "
             f"{ms['K7b']['parent']}, change {ms['K7b']['change']}; K7 device ms parent "
             f"{ms['K7']['parent']}, change {ms['K7']['change']}; K7 call ms parent "
             f"{ms['K7 call']['parent']}, change {ms['K7 call']['change']} (with the split "
             f"into rows {library['split']!r}); index_select call {library['call']!r} device "
             f"{library['device']!r}; bound {b!r} ms (bytes); segments by rows "
             f"{cs.segment_rows(idx)}; host us a call {host}")
    if not (bwd_same and bwd_plain and fwd_same):
        raise AssertionError(f"{name}: a kernel disagrees")


def in_place(parent, device):
    """One cell of the canonical train step; its backward pass under the
    profiler through each K7b in turn."""
    from raysnail_tpu_torch.diff import extract_params
    from raysnail_tpu_torch.diff.train import render_image_diff
    from raysnail_tpu_torch.sdl.driver import build_scene

    ccfg = RenderConfig(width=cs.WIDTH, height=cs.HEIGHT, samples=cs.SAMPLES,
                        max_depth=cs.TRAIN_DEPTH)
    scene, cam = build_scene(cs.SCENE, ccfg, device)

    def loss():
        p = extract_params(scene.arrays)
        img = render_image_diff(scene, cam, ccfg, p, 1, [0])
        return torch.mean(img.x + img.y + img.z)

    loss().backward()  # warm-up
    change = rs.rows_select_bwd
    out = {}
    for side in ORDER:
        rs.rows_select_bwd = parent.rows_select_bwd if side == "parent" else change
        try:
            res = cs.profile_backward(loss, f"{side}: one cell of example-fwd+bwd-800x500",
                                      {"K7b": "rows_select_bwd"})
        finally:
            rs.rows_select_bwd = change
        out.setdefault(side, []).append(res["K7b"]["device_ms"])
        cs.phase("rows", f"in place, {side}: K7b {res['K7b']['launches']} launches, "
                 f"{res['K7b']['device_ms']!r} ms of device time, {res['K7b']['ms_a_launch']!r} "
                 f"ms a launch; the backward pass {res['device_ms']!r} ms of device time")
    cs.phase("rows", f"in place, K7b device ms of the cell's backward pass: parent "
             f"{out['parent']}, change {out['change']}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="unpacked checkout of the parent commit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("rows_select_reading: needs a CUDA card")
    device = torch.device("cuda", 0)
    cs.phase("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {cs.card_line()}")
    parent_src = os.path.join(os.path.abspath(args.parent), SOURCE)
    for label, src in (("parent", parent_src), ("change", os.path.join(ROOT, SOURCE))):
        ptxas(src, label)
    rs.build()
    parent = parent_module(os.path.abspath(args.parent),
                           _nvcc.build(parent_src, _nvcc.nvcc(), _nvcc.NVCC_FLAGS))

    from raysnail_tpu_torch.scenes import book1
    from raysnail_tpu_torch.sdl.driver import build_scene

    cfg = RenderConfig(width=cs.WIDTH, height=cs.HEIGHT, samples=cs.SAMPLES)
    scene, camera = build_scene(cs.SCENE, cfg, device)
    ray = cs.primary_rays(camera, cs.WIDTH, cs.HEIGHT, cfg.sqrt_spp, device)
    vcfg = RenderConfig(width=cs.WIDTH, height=cs.HEIGHT, samples=cs.SMALL_SPP)
    sscene = book1.balls_scene(7).compile(vcfg.dtype, device)
    sray = cs.primary_rays(book1.balls_camera(cs.WIDTH, cs.HEIGHT, device=device), cs.WIDTH,
                           cs.HEIGHT, vcfg.sqrt_spp, device)
    gen = torch.Generator(device=device).manual_seed(7)
    cases = cs.rows_cases(scene, ray, cfg, sscene, sray, vcfg, gen)
    with tempfile.TemporaryDirectory() as tmp:
        timed = ctypes.CDLL(timed_library(os.path.join(ROOT, SOURCE), tmp))
        timed.rows_select_set_record.argtypes = [ctypes.c_void_p]
        timed.rows_select_bwd_launch.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        for name in ("example.sdl", "textures3", "textures6", "shuffled", "book1"):
            idx, rows, k, _ = cases[name]
            phases(timed, name, idx, rows, k, gen)
    for name, (idx, rows, k, label) in cases.items():
        one_case(parent, name, idx, rows, k, gen, label)
    in_place(parent, device)
    cs.phase("done", f"on {cs.card_line()}; numpy {np.__version__}, torch {torch.__version__}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""K6, the Mandelbulb march kernel, against the kernel of a parent commit,
on one card in one process:

    python tests/mandelbulb_k6_reading.py --parent DIR [--out DIR]

DIR is an unpacked checkout of the parent commit (`git archive <commit> |
tar -x -C DIR`); its `raysnail_tpu_torch/csrc/mandelbulb_march.cu` is
built beside this tree's, with the same flags. On chip_smoke.py's three
K6 cases (the mandelbulb-passes4 camera's 150,000 primary rays in tile
order, their bounce rays, its 600,000 primary rays of 4 samples) it
prints:

  * both kernels' outputs bit for bit equal (and, on the first two cases,
    equal to the plain version's);
  * device ms a call (chip_smoke.device_ms) in the order parent, change,
    change, parent;
  * the chain floor of each kernel: the 32 rays with the most DE
    iterations (march plus normal) alone in one launch, and the ns a DE
    iteration of the longest of them;
  * for each kernel, on the first two cases, how its blocks spread over
    the SMs: a copy of its source whose kernel records each block's %smid
    and %globaltimer at its start and end, built here and not kept, with
    each SM's blocks, DE iterations and the time its last block ended;
  * the first pass of mandelbulb-passes4 under torch.profiler through each
    kernel (parent, change, change, parent): K6's ms a launch and share of
    the device time.

And, from each library, the registers and spills (-Xptxas -v) and
`cuobjdump -sass` written to --out with the counts of the opcodes on a DE
iteration's path (MUFU.RSQ, MUFU.RCP, MUFU.LG2), of calls and of local
memory loads and stores. It needs a CUDA card, nvcc and cuobjdump, and no
JAX.
"""

import argparse
import ctypes
import os
import re
import shutil
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
from raysnail_tpu_torch.ops import mandelbulb_march as mm  # noqa: E402
from raysnail_tpu_torch.render import render  # noqa: E402
from raysnail_tpu_torch.utils import golden  # noqa: E402

SOURCE = os.path.join("raysnail_tpu_torch", "csrc", "mandelbulb_march.cu")
OPCODES = ("MUFU.RSQ", "MUFU.RCP", "MUFU.LG2", "CALL", "LDL", "STL")

# a kernel's per-block record: start and end (%globaltimer, ns) and %smid,
# as three u64 after the (3, N) counts
TIMED_KERNEL = r'''
__global__ void __launch_bounds__(kThreads)
    mandelbulb_march_kernel(const float* __restrict__ origin, const float* __restrict__ direction,
                            const uint8_t* __restrict__ active, float t_min, float t_max,
                            float* __restrict__ t_out, uint8_t* __restrict__ valid_out,
                            float* __restrict__ normal_out, float* __restrict__ u_out,
                            float* __restrict__ v_out, int32_t* __restrict__ counts, int n) {
  unsigned long long* rec =
      reinterpret_cast<unsigned long long*>(counts + ((3 * n + 1) & ~1)) + 3 * blockIdx.x;
  if (threadIdx.x == 0) {
    unsigned long long t0;
    unsigned int sm;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    rec[0] = t0;
    rec[2] = sm;
  }
  march_body(origin, direction, active, t_min, t_max, t_out, valid_out, normal_out, u_out,
             v_out, counts, n);
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t1));
    rec[1] = t1;
  }
}

}  // namespace
'''


def timed_source(src: str, path: str) -> int:
    """A kernel with a per-block record of SM and times; -> its threads a
    block."""
    with open(src) as f:
        s = f.read()
    head = "__global__ void __launch_bounds__(kThreads)\n    mandelbulb_march_kernel("
    if s.count(head) != 1 or s.count("}  // namespace") != 1:
        raise RuntimeError(f"{src}: not a one-thread-a-ray kernel")
    s = s.replace(head, "__device__ __forceinline__ void march_body(")
    s = s.replace("}  // namespace", TIMED_KERNEL)
    with open(path, "w") as f:
        f.write(s)
    return int(re.search(r"constexpr int kThreads = (\d+);", s).group(1))


class Kernel:
    """A K6 library built from a given source (13-argument entry point)."""

    def __init__(self, lib_path: str):
        self.lib = ctypes.CDLL(lib_path)
        ptr = ctypes.c_void_p
        self.lib.mandelbulb_march_launch.argtypes = [
            ptr, ptr, ptr, ctypes.c_float, ctypes.c_float, ptr, ptr, ptr, ptr, ptr, ptr,
            ctypes.c_int, ptr]
        self.lib.mandelbulb_march_launch.restype = ctypes.c_int

    def __call__(self, origin, direction, t_min, t_max, active=None, stats=False,
                 extra_ints=0):
        n = origin.shape[-1]
        dev = origin.device
        t = torch.empty(n, dtype=torch.float32, device=dev)
        valid = torch.empty(n, dtype=torch.bool, device=dev)
        normal = torch.empty((3, n), dtype=torch.float32, device=dev)
        u = torch.empty(n, dtype=torch.float32, device=dev)
        v = torch.empty(n, dtype=torch.float32, device=dev)
        counts = (torch.empty(3 * n + extra_ints, dtype=torch.int32, device=dev)
                  if stats else None)
        err = self.lib.mandelbulb_march_launch(
            origin.data_ptr(), direction.data_ptr(),
            None if active is None else active.data_ptr(), float(t_min), float(t_max),
            t.data_ptr(), valid.data_ptr(), normal.data_ptr(), u.data_ptr(), v.data_ptr(),
            None if counts is None else counts.data_ptr(), n,
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"mandelbulb_march ({self.lib._name}): cudaError {err}")
        out = (t, valid, normal, u, v)
        self.last_counts = counts  # with the extra ints, for `spread`
        return out + (counts[:3 * n].view(3, n),) if stats else out


def sass_summary(lib_path: str, label: str, out_dir: str):
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    with open(os.path.join(out_dir, f"k6_{label}.sass"), "w") as f:
        f.write(text)
    functions = re.findall(r"Function : (\S+)", text)
    lines = [ln for ln in text.splitlines() if re.match(r"\s+/\*[0-9a-f]{4}\*/", ln)]
    counts = {op: sum(1 for ln in lines if re.search(rf"\b{re.escape(op)}\b", ln))
              for op in OPCODES}
    cs.phase("sass", f"{label}: functions {functions}; {len(lines)} instructions; {counts}")


def spread(kernel: "Kernel", threads: int, o3, d3, active, t_min, t_max, label: str):
    """A kernel's blocks over the SMs on one case (its timed build)."""
    n = o3.shape[1]
    blocks = -(-n // threads)
    off = (3 * n + 1) & ~1
    kernel(o3, d3, t_min, t_max, active, stats=True, extra_ints=off - 3 * n + 6 * blocks)
    torch.cuda.synchronize()
    counts = kernel.last_counts
    rec = counts[off:].view(torch.int64).reshape(blocks, 3).cpu().numpy()
    iters = (counts[n:2 * n] + counts[2 * n:3 * n]).to(torch.int64).cpu().numpy()
    iters = np.pad(iters, (0, blocks * threads - n)).reshape(blocks, threads)
    start, end, sm = rec[:, 0], rec[:, 1], rec[:, 2]
    t0 = start.min()
    sms = np.unique(sm)
    sm_end = np.array([end[sm == s].max() - t0 for s in sms]) / 1e3
    sm_iters = np.array([iters[sm == s].sum() for s in sms])
    sm_max_ray = np.array([iters[sm == s].max() for s in sms])
    block_us = (end - start) / 1e3
    slow = np.argsort(block_us)[-5:]
    cs.phase("spread", f"{label}: {blocks} blocks of {threads} on {sms.size} SMs, kernel "
             f"{(end.max() - t0) / 1e3:.1f} us; each SM's last block ended at mean "
             f"{sm_end.mean():.1f} us, min {sm_end.min():.1f}, max {sm_end.max():.1f}; DE "
             f"iterations per SM mean {sm_iters.mean():.0f}, max {sm_iters.max()}, "
             f"min {sm_iters.min()}; corr(SM iterations, SM end) "
             f"{np.corrcoef(sm_iters, sm_end)[0, 1]:.3f}, corr(SM's slowest ray, SM end) "
             f"{np.corrcoef(sm_max_ray, sm_end)[0, 1]:.3f}; the 5 longest blocks: "
             + "; ".join(f"block {b} on SM {sm[b]}: {block_us[b]:.1f} us, slowest ray "
                         f"{iters[b].max()} its, {iters[b].sum()} its in all, "
                         f"{block_us[b] * 1e3 / max(iters[b].max(), 1):.0f} ns an iteration "
                         f"of its slowest ray" for b in slow[::-1]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="unpacked checkout of the parent commit")
    ap.add_argument("--out", default=os.path.join(ROOT, "_archive", "k6_sass"),
                    help="where the SASS listings go")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mandelbulb_k6_reading: needs a CUDA card")
    os.makedirs(args.out, exist_ok=True)
    device = torch.device("cuda", 0)
    cs.phase("device", f"{torch.cuda.get_device_name(0)}; nvidia-smi: {cs.card_line()}")

    parent_src = os.path.join(os.path.abspath(args.parent), SOURCE)
    change_src = os.path.join(ROOT, SOURCE)
    with tempfile.TemporaryDirectory() as tmp:
        timed, threads = {}, {}
        for side, src in (("parent", parent_src), ("change", change_src)):
            path = os.path.join(tmp, f"mandelbulb_march_{side}_timed.cu")
            threads[side] = timed_source(src, path)
            timed[side] = Kernel(_nvcc.build(path, _nvcc.nvcc(), _nvcc.NVCC_FLAGS))
        libs = {"change": mm.build(verbose=True),
                "parent": _nvcc.build(parent_src, _nvcc.nvcc(), _nvcc.NVCC_FLAGS, verbose=True)}
        for label in ("parent", "change"):
            sass_summary(libs[label], label, args.out)
        parent = Kernel(libs["parent"])
        change = mm.mandelbulb_march

        bcfg = RenderConfig(width=cs.BULB_W, height=cs.BULB_H, samples=cs.BULB_SPP,
                            max_depth=cs.BULB_DEPTH, passes=cs.BULB_PASSES)
        scene, cam = golden.mandelbulb_scene(bcfg, device)
        gen = torch.Generator(device=device).manual_seed(7)
        o_p, d_p = cs.bulb_primary_rays(cam, bcfg, device)
        first = change(o_p, d_p, bcfg.t_min, bcfg.t_max)
        o_b, d_b, a_b = cs.bulb_bounce_rays(o_p, d_p, first, gen)
        o_m, d_m = cs.bulb_primary_rays(cam, bcfg, device, cs.BULB_MANY_SAMPLES)
        cases = {"primary": (o_p, d_p, None), "bounce": (o_b, d_b, a_b),
                 "samples4": (o_m, d_m, None)}
        tmin, tmax = bcfg.t_min, bcfg.t_max
        for label, (o, d, act) in cases.items():
            got_p = parent(o, d, tmin, tmax, act, stats=True)
            got_c = change(o, d, tmin, tmax, act, stats=True)
            same = all(torch.equal(a, b) for a, b in zip(got_p, got_c))
            plain = "not run"
            if label != "samples4":
                want = mm.mandelbulb_march_plain(o, d, tmin, tmax, act, stats=True)
                plain = all(torch.equal(a, b) for a, b in zip(got_c, want))
            if not same or plain is False:
                raise AssertionError(f"{label}: parent == change {same}, == plain {plain}")
            iterations = got_c[5][1] + got_c[5][2]
            ms = {}
            for side in ("parent", "change", "change", "parent"):
                fn = parent if side == "parent" else change
                ms.setdefault(side, []).append(
                    cs.device_ms(lambda: fn(o, d, tmin, tmax, act)))
            idx = torch.topk(iterations, cs.CHAIN_RAYS).indices
            o32, d32 = o[:, idx].contiguous(), d[:, idx].contiguous()
            a32 = None if act is None else act[idx].contiguous()
            chain = {side: cs.device_ms(lambda: fn(o32, d32, tmin, tmax, a32))
                     for side, fn in (("parent", parent), ("change", change))}
            longest = int(iterations.max())
            cs.phase("k6", f"{label}: N={o.shape[1]}, {int((got_c[5][0] > 0).sum())} marched, "
                     f"{int(got_c[1].sum())} hits; parent == change: {same}, == plain: "
                     f"{plain}; device ms a call parent {ms['parent']}, change {ms['change']} "
                     f"(order parent, change, change, parent); chain floor ({cs.CHAIN_RAYS} "
                     f"slowest rays alone, longest {longest} DE iterations): parent "
                     f"{chain['parent']!r} ms ({chain['parent'] * 1e6 / longest:.1f} ns an "
                     f"iteration), change {chain['change']!r} ms "
                     f"({chain['change'] * 1e6 / longest:.1f} ns)")
            if label != "samples4":
                for side in ("parent", "change"):
                    spread(timed[side], threads[side], o, d, act, tmin, tmax,
                           f"{side}, {label}")

        # the first pass of mandelbulb-passes4 through each kernel
        first_pass = bcfg.replace(passes=1)
        mm_module = sys.modules["raysnail_tpu_torch.ops.mandelbulb_march"]
        for side in ("parent", "change", "change", "parent"):
            mm_module.mandelbulb_march = parent if side == "parent" else change
            try:
                render(scene, cam, first_pass, seed=cs.BULB_SEED)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                render(scene, cam, first_pass, seed=cs.BULB_SEED)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                cs.profile_frame(scene, cam, first_pass, f"{side}: passes4 first pass", wall,
                                 kernel=("mandelbulb_march_kernel",), kernel_name="K6",
                                 run=lambda: render(scene, cam, first_pass,
                                                    seed=cs.BULB_SEED))
            finally:
                mm_module.mandelbulb_march = change
    cs.phase("done", f"on {cs.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

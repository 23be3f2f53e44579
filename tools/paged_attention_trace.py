"""Where a paged-attention launch spends its time, block by block.

Usage: python tools/paged_attention_trace.py [--threads N] [--group N]

Builds a copy of ``src/repro_torch/kernels/csrc/paged_attention.cu`` into
``build/paged_attention_trace/`` with time stamps added (thread 0 of each
block writes ``clock64()`` at each phase boundary and ``%globaltimer`` at
entry and exit into a device array), runs it through the port's wrapper at
the serving shapes of ``chip_smoke.py`` (8 rows of 80-272 tokens, bf16
pages of 16 tokens, L2 flushed before each launch) and prints, per case,
the launch's span and the mean and max duration of each phase over the
blocks that ran: reading the row's length, setting up (query rows, page
ids, the first loads), waiting for the first stage, the key loop (and,
for the first stage, its scores and probabilities steps, then its P.V step
to the loop's end), writing the partial, the ticket, the merge.
Durations are SM cycles over the card's maximum SM clock. ``--threads``
builds the copy with another block size (a multiple of 32 up to 256);
``--group`` fixes the query slots a block (16, 32 or 64) in place of the
launch's own choice. Needs ``nvcc`` and a GPU; the kernel the port builds
is not touched.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

SLOTS = 8192  # blocks stamped
# thread 0's stamps: clock64() into slots 0-9, %globaltimer at entry (10)
# and wherever the block ends (11)
ENTRY = "if (threadIdx.x == 0 && blk_ < {n}) g_trace[blk_][10] = gtime();"
EXIT = "if (threadIdx.x == 0 && blk_ < {n}) g_trace[blk_][11] = gtime();"
STAMPS = [  # (key, code, the unique line it goes before)
    ("entry", f"  TS(0) {ENTRY}\n", "  const int len = lengths[b];\n"),
    ("len", "  TS(1)\n", "  if (s >= S) return;  // (block-uniform)\n"),
    ("setup", "  TS(2)\n", "  for (int st = 0; st < n_stages; ++st) {\n"),
    ("first", "    if (st == 0) {{ TS(3) }}\n",
     "    if (st + 1 < n_stages) load_stage(st + 1, pid_nxt);\n"),
    ("scores", "    if (st == 0) {{ TS(8) }}\n",
     "    // (b) probabilities against the row's maximum over the whole "
     "stage:\n"),
    ("probs", "    if (st == 0) {{ TS(9) }}\n",
     "    // (c) O = alpha * O + P.V over the stage's slices, in slice "
     "order, on\n"),
    ("loop", "  TS(4)\n",
     "  cp_async_wait<0>();\n  if (tid < nrow) l_s[tid] = l_own;\n"),
    ("one", f"    {EXIT}\n", "    if (!pv_warp) return;\n"),
    ("partial", "  TS(5)\n",
     "  __threadfence();\n  __syncthreads();\n  int* ticket"),
    ("ticket", f"  TS(6) if (!is_last) {{{{ {EXIT} }}}}\n",
     "  if (!is_last) return;\n"),
    ("merge", f"  TS(7) {EXIT}\n",
     "}\n\ntemplate <typename TQ, typename T, int D, bool kAppend>\n"
     "int launch("),
]
HEADER = """
__device__ unsigned long long g_trace[{n}][12];
__device__ __forceinline__ unsigned long long gtime() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
#define TS(k) if (threadIdx.x == 0 && blk_ < {n}) g_trace[blk_][k] = clock64();
"""
FOOTER = """
extern "C" int pa_trace_read(void* dst) {{
  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));
}}
extern "C" int pa_trace_clear() {{
  static unsigned long long z[{n}][12];
  return (int)cudaMemcpyToSymbol(g_trace, z, sizeof(z));
}}
"""
PHASES = [("len", 0, 1), ("setup", 1, 2), ("first stage", 2, 3),
          ("loop", 3, 4), ("partial", 4, 5), ("ticket", 5, 6),
          ("merge", 6, 7), ("st0 scores", 3, 8), ("st0 probs", 8, 9),
          ("st0 P.V to loop end", 9, 4)]


def traced_source(threads: int, group: int | None) -> str:
    src = (ROOT / "src/repro_torch/kernels/csrc/paged_attention.cu").read_text()
    src = src.replace("constexpr int kThreads = 256;",
                      f"constexpr int kThreads = {threads};")
    if group is not None:
        src = src.replace("  int group = kMaxRows;\n",
                          f"  int group = {group};\n  if (false)\n")
    anchor = "template <typename TQ, typename T, int D, bool kAppend>\n__global__"
    src = src.replace(anchor, HEADER.format(n=SLOTS) + anchor, 1)
    body = src.index("  const int len = lengths[b];\n")
    src = (src[:body] + "  const int blk_ = blockIdx.x + gridDim.x * "
           "(blockIdx.y + gridDim.y * blockIdx.z);\n" + src[body:])
    for key, code, where in STAMPS:  # each stamp goes before its line
        if src.count(where) != 1:
            raise SystemExit(f"trace point {key!r}: its line is not unique")
        src = src.replace(where, code.format(n=SLOTS) + where)
    return src + FOOTER.format(n=SLOTS)


def build(threads: int, group: int | None) -> ctypes.CDLL:
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path
    out = ROOT / "build" / "paged_attention_trace"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "paged_attention_trace.cu"
    cu.write_text(traced_source(threads, group))
    so = out / "libpaged_attention_trace.so"
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(proc.stdout + proc.stderr)
    return ctypes.CDLL(str(so))


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=256)
    ap.add_argument("--group", type=int, choices=(16, 32, 64))
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke as cs
    pa = importlib.import_module("repro_torch.kernels.paged_attention")

    if not torch.cuda.is_available():
        print("paged_attention_trace: no CUDA device", file=sys.stderr)
        return 2
    lib = build(args.threads, args.group)
    fn = pa.typed_launch(lib.paged_attention_launch)
    pa._launcher = lambda: fn
    lib.pa_trace_read.argtypes = [ctypes.c_void_p]
    lib.pa_trace_read.restype = ctypes.c_int
    lib.pa_trace_clear.argtypes = []
    lib.pa_trace_clear.restype = ctypes.c_int
    ghz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.split()[0]) * 1e-3
    flush = torch.zeros(256 * 2**20, dtype=torch.uint8, device="cuda")
    lens = np.random.default_rng(7).integers(64, 257, 8) + 16
    buf = np.zeros((SLOTS, 12), np.uint64)
    print(f"{torch.cuda.get_device_name(0)}, {args.threads} threads a "
          f"block, query group {args.group or 'the launch’s'}; SM clock "
          f"{ghz:.2f} GHz")
    for name, Hq, Hkv, D, seed in (("paligemma-3b", 8, 1, 256, 11),
                                   ("paligemma-3b shard", 4, 1, 256, 11),
                                   ("granite-20b", 48, 1, 128, 14),
                                   ("olmo-1b", 16, 16, 128, 7)):
        for C in (1, 16):
            for splits in (None, 1):
                case = cs.attention_case(8, C, Hq, Hkv, D, 16, 512, 512,
                                         torch.bfloat16, seed=seed, lens=lens)
                case[5].fill_(C)
                for _ in range(3):  # the last launch's stamps are kept
                    flush.bitwise_not_()
                    lib.pa_trace_clear()
                    torch.cuda.synchronize()
                    pa.paged_attention_cuda(*case, _splits=splits)
                    torch.cuda.synchronize()
                lib.pa_trace_read(buf.ctypes.data)
                ran = buf[(buf[:, 10] > 0) & (buf[:, 2] > 0)].astype(float)
                span = (ran[:, 11].max() - ran[:, 10].min()) / 1e3
                cols = []
                for label, a, z in PHASES:
                    ok = (ran[:, a] > 0) & (ran[:, z] > 0)
                    d = (ran[ok, z] - ran[ok, a]) / ghz / 1e3
                    cols.append(f"{label} {d.mean():.2f}/{d.max():.2f}"
                                if ok.any() else f"{label} -")
                print(f"{name} Hq={Hq} D={D} C={C} splits="
                      f"{splits or 'rule'}: {len(ran)} blocks ran, span "
                      f"{span:.2f} us; mean/max us: " + ", ".join(cols),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

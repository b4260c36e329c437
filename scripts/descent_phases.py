"""Where a launch of the descent kernel spends its time, phase by phase, on
one NVIDIA GPU.

    python scripts/descent_phases.py [--out PHASES.json]

It writes a copy of ``alphazero_tpu_torch/ops/csrc/descent.cu`` with
``clock64()`` reads between the kernel's phases (text inserted at fixed
lines of the source; it stops if one is missing), builds it with ``nvcc``
into the port's build directory, and launches it on the trees that
``chip_smoke.py`` keeps from its searches at ``DESCENT_SHAPES``.  Thread 0
of every block records its SM clock cycles for: ``init`` (barrier set-up
up to the first level), per level summed over the board's levels
``scalars`` (the node's square roots and division, while the row's copy
is in flight), ``copy`` (waiting for the copy), ``list`` (the prior loads
and the valid column lists), ``score`` (the listed columns' scores),
``reduce`` (the warp reductions and the block's barrier), ``tail`` (the
winners, the next copy's issue and the path records), and ``total``; with
the global timer, the span from the first block's start to the last
block's end.  It prints the means over
blocks and launches beside the shipped kernel's device time per launch
(``chip_smoke._descent_times``' protocol), and the card's name, power
limit and SM clock.  The clock reads add some cycles to every phase.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("init", "copy", "list", "scalars", "score", "reduce", "tail",
          "total")

# (text of descent.cu, text that replaces it); each must occur once
_PATCHES = (
    ("int B, int* __restrict__ depth_out, int* __restrict__ paths) {\n",
     "int B, int* __restrict__ depth_out, int* __restrict__ paths,\n"
     "               long long* __restrict__ tm) {\n"
     "  const long long t_start = clock64();\n"
     "  unsigned long long g_start;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g_start));\n"
     "  long long cyc[8] = {}, t = 0;\n"
     "#define DESCENT_MARK(k) { const long long now = clock64(); "
     "cyc[k] += now - t; t = now; }\n"),
    ("  __syncthreads();\n\n",
     "  __syncthreads();\n  cyc[0] = clock64() - t_start;\n\n"),
    ("    const float* row = rows + set * 4 * C;\n",
     "    const float* row = rows + set * 4 * C;\n    t = clock64();\n"),
    ("    // the barrier of this set completes",
     "    DESCENT_MARK(3);\n    // the barrier of this set completes"),
    ("static_cast<uint32_t>(level >> 1) & 1u);\n",
     "static_cast<uint32_t>(level >> 1) & 1u);\n    DESCENT_MARK(1);\n"),
    ("      __syncwarp();\n      for (unsigned j = lane; j < n; j += kWarp) {",
     "      __syncwarp();\n      DESCENT_MARK(2);\n"
     "      for (unsigned j = lane; j < n; j += kWarp) {"),
    ("      __syncwarp();\n    }\n",
     "      __syncwarp();\n      DESCENT_MARK(4);\n    }\n"),
    ("    __syncthreads();\n    best_h = win_h",
     "    __syncthreads();\n    DESCENT_MARK(5);\n    best_h = win_h"),
    ("    ++level;\n    if (stop) break;",
     "    ++level;\n    DESCENT_MARK(6);\n    if (stop) break;"),
    ("    depth_out[b] = level;\n  }\n}",
     "    depth_out[b] = level;\n"
     "    unsigned long long g_end;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g_end));\n"
     "    cyc[7] = clock64() - t_start;\n"
     "    for (int k = 0; k < 8; ++k) tm[10LL * b + k] = cyc[k];\n"
     "    tm[10LL * b + 8] = static_cast<long long>(g_start);\n"
     "    tm[10LL * b + 9] = static_cast<long long>(g_end);\n"
     "  }\n}"),
    ("int* paths, int smem_bytes, void* stream) {",
     "int* paths, int smem_bytes, void* stream, long long* tm) {"),
    ("sim_f, out64, B, depth, paths);", "sim_f, out64, B, depth, paths, tm);"),
    ('extern "C" int descent_launch(', 'extern "C" int descent_phases_launch('),
)


def build():
    """The instrumented copy, built and loaded; its launch function."""
    from alphazero_tpu_torch.ops import _build
    src = (_build.CSRC / "descent.cu").read_text()
    for old, new in _PATCHES:
        if src.count(old) != 1:
            raise RuntimeError(f"descent.cu no longer has {old!r} once")
        src = src.replace(old, new)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "descent_phases.cu"
    lib = _build.BUILD_DIR / "libdescent_phases.so"
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(cu)], check=True)
    fn = ctypes.CDLL(str(lib)).descent_phases_launch
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [P, I, I, I, I, F, F, I, I, F, F, P, P, P, I, P, P]
    fn.restype = I
    return fn


def launch(fn, cfg, stats, sim_idx, depth_cap):
    """One launch of the instrumented kernel; returns the per-block record
    ``[B, 10]`` (the 8 phase counts, then the global timer at the block's
    start and end) and the eight outputs, as ``ops.descent.select``'s."""
    import torch
    from alphazero_tpu_torch.ops import descent as D
    B, M, _, C = stats.shape
    dev = stats.device
    out64 = torch.empty((4, B), dtype=torch.int64, device=dev)
    depth = torch.empty(B, dtype=torch.int32, device=dev)
    paths = torch.empty((3, B, depth_cap), dtype=torch.int32, device=dev)
    tm = torch.zeros((B, 10), dtype=torch.int64, device=dev)
    err = fn(stats.data_ptr(), B, M, C, depth_cap, float(cfg.cpuct),
             float(cfg.fpu), int(cfg.fpu > 0), int(bool(cfg.forced_playouts)),
             float(cfg.k_forced), float(sim_idx), out64.data_ptr(),
             depth.data_ptr(), paths.data_ptr(), D.smem_bytes(C),
             torch.cuda.current_stream().cuda_stream, tm.data_ptr())
    if err != 0:
        raise RuntimeError(f"instrumented descent failed: CUDA error {err}")
    p, a, e, r = out64
    return tm, (p, a, e, depth, r, paths[0], paths[1], paths[2])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the results to this JSON file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("descent_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from alphazero_tpu_torch.ops import descent as D
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    fn = build()
    res = {"card": smi, "shapes": {}}
    for B, S, kind, every in cs.DESCENT_SHAPES:
        kept, err = cs._check_descent_search(B, S, kind, every)
        recs = []
        for cfg, st, i, cap, lv, _ in kept:
            launch(fn, cfg, st, i, cap)                       # warm-up
            tm, got = launch(fn, cfg, st, i, cap)
            err = max(err, cs._outputs_diff(
                got, D.select_plain(cfg, st, i, cap, lv)))
            recs.append(tm.double().cpu())
        if err != 0:
            raise AssertionError(f"B={B}: instrumented kernel disagrees")
        tm = torch.cat(recs)
        row = dict(zip(PHASES, tm[:, :8].mean(0).tolist()))
        row.update(
            max_total=tm[:, 7].max().item(),
            span_ns=sorted((r[:, 9].max() - r[:, 8].min()).item()
                           for r in recs)[len(recs) // 2],
            levels=sum(int(k[5].sum()) for k in kept) / tm.shape[0],
            kernel_us=cs._descent_times(kept, 0.0)["ms"] * 1e3)
        res["shapes"][f"B{B}_M{kept[0][1].shape[1]}"] = row
        print(f"B={B} M={kept[0][1].shape[1]}: kernel "
              f"{row['kernel_us']:.3f} us/launch, mean levels "
              f"{row['levels']:.3f}; cycles per block (mean): "
              + ", ".join(f"{k} {row[k]:.0f}" for k in PHASES)
              + f"; slowest block {row['max_total']:.0f}; span "
              f"{row['span_ns']:.0f} ns", flush=True)
        del kept
        torch.cuda.empty_cache()
    sm = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                         "--format=csv,noheader"], capture_output=True,
                        text=True).stdout.strip()
    print(f"SM clock after the runs: {sm}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

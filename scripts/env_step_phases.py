"""Where a launch of the env-step kernel spends its time, phase by phase, on
one NVIDIA GPU.

    python scripts/env_step_phases.py [--source FILE.cu] [--out PHASES.json]

It writes a copy of the kernel source (``--source``, by default the
shipped ``alphazero_tpu_torch/ops/csrc/env_step.cu``) with ``clock64()``
reads between the kernel's phases (text inserted at fixed lines of the
source, one set of lines per kernel design; it stops if a line is
missing), builds it with ``nvcc`` into the port's build directory, and
launches it on the transitions that ``chip_smoke._env_step_search_inputs``
records from a main-path search (B=1024, S=64, every 8th simulation), at
B=1024 and at B=1 (the first board of each).  Lane 0 of every warp (one
warp per board) records its SM clock cycles for: ``load`` (the action,
the table words and the board's bytes, up to their first use), ``step``
(the action's branch), ``store`` (the seat swap and the child's stores),
``scalars`` (what the mask reads of the child, the same for every
action), ``mask`` (the 409 valid bits), ``terminal`` (the terminal vector
and the advance), and ``total``; with the global timer, the span from the
first warp's start to the last warp's end.  The instrumented copy is held
byte for byte to ``search_step_plain`` on every input.  It prints the
means over warps and launches beside the shipped kernel's device time per
launch (``chip_smoke._device_ms``' protocol), and the card's name, power
limit and SM clock.  The clock reads and the folds that make a phase wait
for its values add some cycles to every phase.

With ``--source`` naming another file (another version of the kernel with
the same C interface), it also builds that file as it is and times it and
the shipped kernel in turns (shipped, other, other, shipped) on the same
inputs at B=1024, 256, 64 and 1, and at B=1024 on 3- and 4-player
playout states with legal actions (``chip_smoke.
_env_step_players_inputs``), each held byte for byte to
``search_step_plain`` first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("load", "step", "store", "scalars", "mask", "terminal", "total")
STRIDE = 10         # per warp: 7 phase counts, global start and end, a fold

# inserted in the kernel's body: the clocks, the phase mark and the fold
_PROLOGUE = (
    "  const long long t_start = clock64();\n"
    "  unsigned long long g_start;\n"
    "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g_start));\n"
    "  long long cyc[7] = {}, t_mark = t_start;\n"
    "  int sink = 0;\n"
    "#define ENV_MARK(k) { const long long now = clock64(); "
    "cyc[k] += now - t_mark; t_mark = now; }\n"
    "#define ENV_SINK(x) asm volatile(\"add.s32 %0, %0, %1;\" : \"+r\"(sink) "
    ": \"r\"(static_cast<int>(x)))\n")
_EPILOGUE = (
    "  cyc[6] = clock64() - t_start;\n"
    "  unsigned long long g_end;\n"
    "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g_end));\n"
    "  if (lane == 0) {\n"
    "    for (int k = 0; k < 7; ++k) tm[10LL * b + k] = cyc[k];\n"
    "    tm[10LL * b + 7] = static_cast<long long>(g_start);\n"
    "    tm[10LL * b + 8] = static_cast<long long>(g_end);\n"
    "    tm[10LL * b + 9] = sink;\n"
    "  }\n")
# the launch function: the record's pointer added, the name changed
_LAUNCH = (
    ("long long* adv, void* stream) {", "long long* adv, void* stream, "
     "long long* tm) {"),
    ("child, term, valid, adv);", "child, term, valid, adv, tm);"),
    ('extern "C" int env_step_launch(',
     'extern "C" int env_step_phases_launch('),
)

# (text of the source, text that replaces it); each must occur once.  One
# set per kernel design: the board staged in shared memory with lane 0
# applying the branch, and the rows held in registers by the whole warp.
_PATCHES = {
    "staged": (
        ("long long* __restrict__ adv_out) {\n",
         "long long* __restrict__ adv_out, long long* __restrict__ tm) {\n"
         + _PROLOGUE),
        ("  __syncwarp();\n  int adv = 0;\n",
         "  __syncwarp();\n  ENV_MARK(0);\n  int adv = 0;\n"),
        ("  adv = __shfl_sync(kFull, adv, 0);\n",
         "  adv = __shfl_sync(kFull, adv, 0);\n  ENV_MARK(1);\n"),
        ("    child[off + i] = static_cast<int8_t>(v);\n  }\n  __syncwarp();\n",
         "    child[off + i] = static_cast<int8_t>(v);\n  }\n  __syncwarp();\n"
         "  ENV_MARK(2);\n"),
        ("  const Board k = board_scalars(t, c);\n",
         "  const Board k = board_scalars(t, c);\n"
         "  ENV_SINK(k.tokens + k.n_elig + k.slot_free + k.pc[0] + k.bank[0] "
         "+ k.pg[4] + k.xclass);\n  ENV_MARK(3);\n"),
        ("  any = __any_sync(kFull, any);\n",
         "  any = __any_sync(kFull, any);\n  ENV_MARK(4);\n"),
        ("    terminal(t, c, term + static_cast<long long>(b) * c.players);\n"
         "  }\n}\n",
         "    terminal(t, c, term + static_cast<long long>(b) * c.players);\n"
         "  }\n  ENV_MARK(5);\n" + _EPILOGUE + "}\n"),
    ) + _LAUNCH,
    "registers": (
        ("long long* __restrict__ adv_out) {\n",
         "long long* __restrict__ adv_out, long long* __restrict__ tm) {\n"
         + _PROLOGUE),
        ("  // phase: step\n",
         "  for (int k = 0; k < kSlots; ++k)\n"
         "    for (int col = 0; col < kCols; ++col) ENV_SINK(v[k][col]);\n"
         "  ENV_SINK(aw);\n  ENV_MARK(0);\n"),
        ("  // phase: store\n", "  ENV_SINK(adv + v[0][0]);\n  ENV_MARK(1);\n"),
        ("  // phase: scalars\n", "  ENV_MARK(2);\n"),
        ("  // phase: mask\n",
         "  ENV_SINK(k.levels + k.cond + k.buyable[0] + k.holds[0] "
         "+ k.slot_free);\n"
         "  ENV_MARK(3);\n"),
        ("  // phase: terminal\n", "  ENV_MARK(4);\n"),
        ("  // phase: end\n", "  ENV_MARK(5);\n" + _EPILOGUE),
    ) + _LAUNCH,
}


def patched(src: str) -> str:
    """``src`` with the clock reads of the one design whose lines it has."""
    fits = [name for name, patches in _PATCHES.items()
            if all(src.count(old) == 1 for old, _ in patches)]
    if len(fits) != 1:
        raise RuntimeError(f"the source fits {fits or 'no'} set of phase "
                           f"lines: {sorted(_PATCHES)}")
    for old, new in _PATCHES[fits[0]]:
        src = src.replace(old, new)
    return src


def _nvcc(cu, lib):
    from alphazero_tpu_torch.ops import _build
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(cu)], check=True)
    return ctypes.CDLL(str(lib))


def build(source):
    """The instrumented copy of ``source``, built and loaded; its launch
    function."""
    from alphazero_tpu_torch.ops import _build
    from alphazero_tpu_torch.ops import env_step as ES
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "env_step_phases.cu"
    cu.write_text(patched(open(source).read()))
    fn = _nvcc(cu, _build.BUILD_DIR / "libenv_step_phases.so")\
        .env_step_phases_launch
    fn.argtypes, fn.restype = ES._ARGTYPES + [ctypes.c_void_p], ctypes.c_int
    return fn


def build_plain_copy(source):
    """``source`` built as it is; its ``env_step_launch``."""
    from alphazero_tpu_torch.ops import _build
    from alphazero_tpu_torch.ops import env_step as ES
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "env_step_other.cu"
    cu.write_text(open(source).read())
    fn = _nvcc(cu, _build.BUILD_DIR / "libenv_step_other.so").env_step_launch
    fn.argtypes, fn.restype = ES._ARGTYPES, ctypes.c_int
    return fn


def launcher(fn):
    """``search_step`` on CUDA tensors through the launch function ``fn``
    (``env_step_launch``'s C interface); ``.launches`` counts its launches.
    """
    import torch
    from alphazero_tpu_torch.games.splendor import tables as T
    from alphazero_tpu_torch.ops import env_step as ES

    def step(cfg, states, actions, tm=None):
        dev = states.device
        B, P = states.shape[0], cfg.num_players
        child = torch.empty_like(states)
        term = torch.empty((B, P), dtype=torch.float32, device=dev)
        valid = torch.empty((B, T.NUM_ACTIONS), dtype=torch.bool, device=dev)
        adv = torch.empty(B, dtype=torch.int64, device=dev)
        extra = () if tm is None else (tm.data_ptr(),)
        err = fn(states.data_ptr(), actions.data_ptr(), B, P,
                 cfg.token_limit, int(cfg.enable_reserve),
                 int(cfg.enable_giveback), int(cfg.enable_noble_select),
                 cfg.score_win, ES._tables(dev).data_ptr(), child.data_ptr(),
                 term.data_ptr(), valid.data_ptr(), adv.data_ptr(),
                 torch.cuda.current_stream().cuda_stream, *extra)
        if err != 0:
            raise RuntimeError(f"env_step launch failed: CUDA error {err}")
        step.launches += 1
        return child, term, valid, adv
    step.launches = 0
    return step


def _kernel_us(cs, step, cfg, ins, launches=64):
    """Device µs per launch of ``step`` on ``ins`` (``_device_ms``: median
    of 5 profiled calls of 64+ launches)."""
    rounds = -(-launches // len(ins))

    def calls():
        for _ in range(rounds):
            for s, a in ins:
                step(cfg, s, a)
    return cs._device_ms(calls, "env_step_kernel", per_call=rounds * len(ins),
                         counter=step) * 1e3


def phases(cs, fn, cfg, ins):
    """The instrumented copy on ``ins`` (a warm-up, then one launch each):
    its records ``[n, STRIDE]`` and the largest |copy - plain|."""
    import torch
    from alphazero_tpu_torch.ops import env_step as ES
    step, recs, err = launcher(fn), [], 0.0
    for s, a in ins:
        tm = torch.zeros((s.shape[0], STRIDE), dtype=torch.int64,
                         device="cuda")
        step(cfg, s, a, tm)
        tm.zero_()
        got = step(cfg, s, a, tm)
        err = max(err, cs._step_diff(got, ES.search_step_plain(cfg, s, a)))
        recs.append(tm.double().cpu())
    return recs, err


def turns(cs, shipped, other, cfg, ins):
    """Device µs per launch of the shipped kernel and the other, in turns
    (shipped, other, other, shipped), each held to plain first."""
    from alphazero_tpu_torch.ops import env_step as ES
    for step in (shipped, other):
        for s, a in ins:
            if cs._step_diff(step(cfg, s, a),
                             ES.search_step_plain(cfg, s, a)) != 0.0:
                raise AssertionError("a kernel disagrees with plain")
    times = {"shipped": [], "other": []}
    for name in ("shipped", "other", "other", "shipped"):
        step = shipped if name == "shipped" else other
        times[name].append(_kernel_us(cs, step, cfg, ins))
    return {k: statistics.mean(v) for k, v in times.items()} | {
        "runs": times}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", help="the kernel source to instrument "
                    "(default: the shipped env_step.cu); another file is "
                    "also timed against the shipped kernel in turns")
    ap.add_argument("--out", help="also write the results to this JSON file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("env_step_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from alphazero_tpu_torch.ops import _build
    from alphazero_tpu_torch.ops import env_step as ES
    shipped_src = str(_build.CSRC / "env_step.cu")
    source = os.path.abspath(args.source or shipped_src)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    fn = build(source)
    other = (None if os.path.samefile(source, shipped_src)
             else launcher(build_plain_copy(source)))
    cfg, kept = cs._env_step_search_inputs()
    shipped = launcher(ES._launch())
    res = {"card": smi, "source": source, "shapes": {}, "turns": {}}
    for B in (1024, 1):
        ins = [(s[:B].contiguous(), a[:B].contiguous()) for s, a in kept]
        recs, err = phases(cs, fn, cfg, ins)
        if err != 0.0:
            raise AssertionError(f"B={B}: the instrumented copy disagrees "
                                 f"with plain: {err}")
        tm = torch.cat(recs)
        row = dict(zip(PHASES, tm[:, :7].mean(0).tolist()))
        row.update(
            max_total=tm[:, 6].max().item(),
            span_ns=sorted((r[:, 8].max() - r[:, 7].min()).item()
                           for r in recs)[len(recs) // 2],
            shipped_us=_kernel_us(cs, shipped, cfg, ins))
        res["shapes"][f"B{B}"] = row
        print(f"B={B}: shipped kernel {row['shipped_us']:.3f} us/launch; "
              "cycles per warp of the instrumented source (mean): "
              + ", ".join(f"{k} {row[k]:.0f}" for k in PHASES)
              + f"; slowest warp {row['max_total']:.0f}; span "
              f"{row['span_ns']:.0f} ns", flush=True)
    if other is not None:
        cases = [(f"B{B}", cfg, [(s[:B].contiguous(), a[:B].contiguous())
                                 for s, a in kept])
                 for B in (1024, 256, 64, 1)]
        g = torch.Generator(device="cuda").manual_seed(12)
        for p in (3, 4):
            pool = cs._env_step_playouts(p, g, per_ply=64)
            cases.append((f"P{p}_B1024",
                          *cs._env_step_players_inputs(pool, p, g)))
        for name, c, ins in cases:
            t = res["turns"][name] = turns(cs, shipped, other, c, ins)
            print(f"in turns, {name}: shipped {t['shipped']:.3f} us/launch, "
                  f"the source's {t['other']:.3f} (runs: shipped "
                  f"{t['runs']['shipped']}, source {t['runs']['other']})",
                  flush=True)
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

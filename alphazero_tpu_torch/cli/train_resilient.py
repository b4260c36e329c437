"""Resilient training driver: supervise the training CLI as a child process
and resume after crashes (failure detection / elastic recovery, SURVEY §5.3).

Port of ``alphazero_tpu/cli/train_resilient.py``: the child is the port's
``alphazero_tpu_torch.cli.main``, re-launched with ``-L temp.pt`` after a
crash (a lost device, an out-of-memory kill): the coach then restores
weights, Adam moments and the replay examples (``Coach.load_checkpoint``)
and continues.  Progress is tracked via metrics.jsonl (one line per
completed iteration), so the total iteration budget is preserved across
restarts.

Usage: same flags as cli.main (``--device`` included), plus
--max-restarts:
    python -m alphazero_tpu_torch.cli.train_resilient -n 20 -e 512 \
        -C ./runs/r1 ...
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def completed_iters(ckpt_dir: str) -> int:
    # highest recorded iteration (metrics numbering is monotone across
    # restarts since the start_iter resume wiring in cli.main)
    import json
    path = os.path.join(ckpt_dir, "metrics.jsonl")
    if not os.path.exists(path):
        return 0
    done = 0
    with open(path) as f:
        for line in f:
            if line.strip():
                try:
                    done = max(done, int(json.loads(line).get("iter", 0)))
                except (ValueError, TypeError, AttributeError):
                    # malformed line (null iter / non-dict JSON / truncated
                    # crash-time write) must not kill the supervisor
                    continue
    return done


def _flag_value(rest: list[str], names: tuple[str, ...], default=None):
    for i, tok in enumerate(rest):
        if tok in names and i + 1 < len(rest):
            return rest[i + 1]
    return default


def main(argv=None):
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--max-restarts", type=int, default=8)
    args, rest = p.parse_known_args(argv)

    total = int(_flag_value(rest, ("-n", "--numIters"), "50"))
    ckpt = _flag_value(rest, ("-C", "--checkpoint"), "./temp/")

    attempt = 0
    while True:
        done = completed_iters(ckpt)
        remaining = total - done
        if remaining <= 0:
            print(f"[driver] {done}/{total} iterations complete")
            return 0
        # -n stays the TOTAL budget: cli.main infers the continuation point
        # from metrics.jsonl itself, keeping one monotone iteration sequence
        cmd = [sys.executable, "-m", "alphazero_tpu_torch.cli.main", *rest]
        temp = os.path.join(ckpt, "temp.pt")
        if "-L" not in rest and "--load-folder-file" not in rest \
                and os.path.exists(temp):
            # crash-restart resume: sibling fallback is wanted here (a temp.pt
            # half-written at crash time should fall back to best.pt, not
            # dead-loop the supervisor)
            cmd += ["-L", temp, "--load-fallback"]
        print(f"[driver] attempt {attempt}: {remaining} iterations remain "
              f"(continuing at iter {done + 1})")
        rc = subprocess.call(cmd)
        if rc == 0 and completed_iters(ckpt) >= total:
            print(f"[driver] run complete ({total} iterations)")
            return 0
        attempt += 1
        if attempt > args.max_restarts:
            print(f"[driver] giving up after {attempt - 1} restarts (rc={rc})")
            return rc or 1
        print(f"[driver] child exited rc={rc}; restarting in 15 s")
        time.sleep(15)


if __name__ == "__main__":
    sys.exit(main())

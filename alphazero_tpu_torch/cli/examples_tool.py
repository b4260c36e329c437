"""Inspect / merge / transform saved replay-examples files.

Port of ``alphazero_tpu/cli/examples_tool.py`` on the port's own
``train/replay.py``, whose files are byte-equal to the JAX package's: the
counterpart of the reference's `Coach.__main__` examples tool
(Coach.py:211-263): merge several `.examples` files into one, optionally
binarize the policy targets (argmax one-hot), split off a testing slice,
and print size summaries.

Usage:
    python -m alphazero_tpu_torch.cli.examples_tool \
        runs/a/checkpoint.examples runs/b/checkpoint.examples -o merged \
        --binarize --test-stride 8
"""

from __future__ import annotations

import argparse

import numpy as np

from ..train.replay import Iteration, ReplayBuffer


def build_parser():
    p = argparse.ArgumentParser(description="examples loader/merger")
    p.add_argument("input", nargs="+", help=".examples files to load")
    p.add_argument("--output", "-o", default="./new",
                   help="prefix for output files")
    p.add_argument("--binarize", "-b", action="store_true",
                   help="replace each policy target with an argmax one-hot "
                        "(reference Coach.py:238-250)")
    p.add_argument("--test-stride", type=int, default=0,
                   help="carve every Nth example of the last iteration into "
                        "a separate _testing.examples file (reference "
                        "Coach.py:226 strides by 8 to drop symmetries)")
    p.add_argument("--info", action="store_true",
                   help="print per-iteration sizes and exit")
    return p


def binarize(it: Iteration) -> Iteration:
    pi = np.asarray(it.pi)
    one_hot = np.zeros_like(pi)
    rows = pi.sum(axis=1) > 0           # an all-zero target has no argmax;
    one_hot[rows, pi[rows].argmax(axis=1)] = 1   # keep it empty, don't
    return Iteration(it.boards, one_hot.astype(pi.dtype), it.winner,
                     it.scdiff, it.valids, it.surprise)  # one-hot action 0


def main(argv=None):
    args = build_parser().parse_args(argv)

    merged = ReplayBuffer(history=10 ** 9)
    testing = ReplayBuffer(history=10 ** 9)
    for filename in args.input:
        buf = ReplayBuffer.load(filename, history=10 ** 9)
        sizes = [len(it) for it in buf.iterations]
        print(f"{filename}: iterations={sizes}, total={sum(sizes)}")
        its = list(buf.iterations)
        if args.test_stride > 0 and its and not args.info:
            # the LAST iteration of EACH input file becomes (strided) test
            # data, excluded from training (reference Coach.py:226 per-file
            # new_input[:-1] / new_input[-1:][::8] carve)
            last = its.pop()
            s = slice(None, None, args.test_stride)
            testing.add_iteration(Iteration(
                last.boards[s], last.pi[s], last.winner[s], last.scdiff[s],
                last.valids[s], last.surprise[s]))
        for it in its:
            merged.add_iteration(it)
    if args.info:
        return 0

    if args.binarize:
        print("binarizing policies...")
        for buf in (merged, testing):
            buf.iterations = [binarize(it) for it in buf.iterations]

    out = args.output + "_training.examples"
    merged.save(out)
    print(f"total training = {len(merged)} -> {out}")
    if len(testing):
        out_t = args.output + "_testing.examples"
        testing.save(out_t)
        print(f"total testing = {len(testing)} -> {out_t}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Checkpoint -> serialized inference artifact (``torch.export`` or ONNX):
port of ``alphazero_tpu/cli/export.py``.

Two formats:
- ``--format pt2`` (default): the port's native artifact, in place of the
  JAX package's StableHLO.  ``apply_inference`` (probabilities, value,
  score-diff log-probabilities) is captured with ``torch.export`` with a
  dynamic batch dimension and saved with ``torch.export.save``, so any
  PyTorch runtime reloads and runs it without the Python model.  It is
  exported on ``--device``, the device it will run on (constants traced on
  one device do not follow ``.to()``).
- ``--format onnx``: the reference-ecosystem artifact
  (chkpt_to_onnx.py:20-41: inputs board/valid_actions, outputs
  pi/v/scdiffs, dynamic batch) for ORT consumers, emitted by the
  dependency-free writer in compat/onnx_export.py.

The net's version and width come from the checkpoint's meta (v1, width
128 without them).  The JAX CLI builds its StableHLO net from the default
config and its ONNX graph from the default width, whatever the meta says.

    python -m alphazero_tpu_torch.cli.export temp/best.pt -o best.pt2
    python -m alphazero_tpu_torch.cli.export temp/best.pt --format onnx -o best.onnx
    python -m alphazero_tpu_torch.cli.export temp/best.pt --check --device cpu
"""

from __future__ import annotations

import argparse
import os

import torch

from ..games.splendor import env as E
from ..models import splendor_net as N
from ..utils import checkpoint as CKPT
from ..utils.device import resolve_device

# torch.export specializes an example size of 0 or 1, so the batch
# dimension is traced at 2 and declared dynamic over [1, 65535]: on CUDA
# the traced program carries a guard of at most 65535 boards (a kernel's
# grid limit), which an unbounded range fails
_EXAMPLE_BATCH = 2
_MAX_BATCH = 65535


class _Inference(torch.nn.Module):
    """``apply_inference`` as a module: (pi probabilities, v, log_sdiff)."""

    def __init__(self, net):
        super().__init__()
        self.net = net

    def forward(self, boards, valid_actions):
        log_pi, v, log_sd = self.net(boards, valid_actions)
        return torch.exp(log_pi), v, log_sd


def _refuse_bt4(meta: dict):
    if int(meta.get("nn_version", 1)) == 3:
        raise ValueError("nn_version 3 (the BT4 transformer) is not "
                         "exported: export versions 0, 1 and 2 only")


def _load(checkpoint_path: str, num_players: int, device):
    """``(net, env_cfg)`` of a checkpoint, the net's shape from its meta."""
    env_cfg = E.SplendorConfig(num_players=num_players)
    net, meta = CKPT.load_net(checkpoint_path, env_cfg, device)
    _refuse_bt4(meta)
    return net.eval(), env_cfg


def export_net(net, env_cfg: E.SplendorConfig, out_path: str | None = None):
    """``torch.export`` of ``net``'s inference forward, with a dynamic batch
    dimension, on the net's device; saved to ``out_path`` when given.
    Returns the ``ExportedProgram``."""
    dev = next(net.parameters()).device
    boards = E.initial_state(env_cfg, _EXAMPLE_BATCH,
                             torch.Generator(device=dev).manual_seed(0), dev)
    valids = E.valid_moves(env_cfg, boards, 0)
    batch = torch.export.Dim("batch", min=1, max=_MAX_BATCH)
    prog = torch.export.export(
        _Inference(net.eval()), (boards.to(torch.float32), valids),
        dynamic_shapes=({0: batch}, {0: batch}))
    if out_path:
        torch.export.save(prog, out_path)
    return prog


def export_checkpoint(checkpoint_path: str, out_path: str | None = None,
                      num_players: int = 2, device="cuda"):
    """Export the checkpoint's inference forward on ``device``; returns the
    ``ExportedProgram``."""
    net, env_cfg = _load(checkpoint_path, num_players, resolve_device(device))
    return export_net(net, env_cfg, out_path)


def load_exported(path: str):
    """Reload a saved artifact; returns ``fn(boards, valids)``."""
    return torch.export.load(path).module()


def export_onnx_checkpoint(checkpoint_path: str, out_path: str,
                           num_players: int = 2,
                           nn_version: int | None = None) -> str:
    """ONNX-format export (reference chkpt_to_onnx.py contract).  The
    graph's version (unless ``nn_version``) and width come from the meta."""
    from ..compat.onnx_export import export_onnx
    from ..games.splendor import adapter as A

    ckpt = CKPT.load_checkpoint(os.path.dirname(checkpoint_path) or ".",
                                os.path.basename(checkpoint_path))
    meta = ckpt.get("meta", {})
    _refuse_bt4(meta if nn_version is None else {"nn_version": nn_version})
    env_cfg = E.SplendorConfig(
        num_players=int(meta.get("num_players", num_players)))
    net_cfg = A.net_config_for(
        env_cfg, nn_version=(nn_version if nn_version is not None
                             else int(meta.get("nn_version", 1))),
        width=int(meta.get("net_width", 128)))
    return export_onnx(net_cfg, ckpt["params"], ckpt["batch_stats"], out_path)


def check_roundtrip(fn, net, env_cfg, batches=(1, 4)) -> float:
    """Max |artifact - live net| over the three outputs, at each batch
    size of ``batches`` (boards from seeded initial states on the net's
    device)."""
    dev = next(net.parameters()).device
    worst = 0.0
    for B in batches:
        boards = E.initial_state(env_cfg, B,
                                 torch.Generator(device=dev).manual_seed(B),
                                 dev)
        valids = E.valid_moves(env_cfg, boards, 0)
        with torch.inference_mode():
            got = fn(boards.to(torch.float32), valids)
        want = N.apply_inference(net, boards.to(torch.float32), valids)
        for g, w in zip(got, want):
            if not torch.isfinite(g).all():
                raise AssertionError(f"non-finite artifact output at B={B}")
            worst = max(worst, float((g - w).abs().max()))
    return worst


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("checkpoint")
    p.add_argument("-o", "--out", default=None)
    p.add_argument("--numPlayers", "-np", type=int, default=2)
    p.add_argument("--format", choices=("pt2", "onnx"), default="pt2")
    p.add_argument("--device", default="cuda",
                   help="device the pt2 artifact is exported for and "
                        "checked on (cuda unless asked for cpu)")
    p.add_argument("--check", action="store_true",
                   help="reload the artifact and compare against the live net")
    args = p.parse_args(argv)

    if args.format == "onnx":
        out = args.out or (os.path.splitext(args.checkpoint)[0] + ".onnx")
        export_onnx_checkpoint(args.checkpoint, out, args.numPlayers)
        print(f"wrote {out} ({os.path.getsize(out)} bytes)")
        return 0

    out = args.out or (os.path.splitext(args.checkpoint)[0] + ".pt2")
    net, env_cfg = _load(args.checkpoint, args.numPlayers,
                         resolve_device(args.device))
    export_net(net, env_cfg, out)
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")
    if args.check:
        diff = check_roundtrip(load_exported(out), net, env_cfg)
        print(f"roundtrip ok at B=1 and B=4: max |artifact - net| = {diff:.3g}")
    return 0


if __name__ == "__main__":
    main()

"""What the benchmark takes from the program (``alphazero_tpu_torch``):
its env configuration, its net built through its public API from a
checkpoint's arrays, and its searches, wrapped so that every call's inputs
and outputs are kept for the check.  The reference's counterparts are
built from the same arrays."""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import torch

from .reference import ckpt as CK
from .reference import env as RE
from .reference import net as RN


def checkpoint(root: Path, config: dict) -> dict:
    """The configuration's checkpoint (its path relative to the checkout),
    held to its pinned sha256."""
    return CK.load(str(root / config["checkpoint"]), config["sha256"])


def env_config(config: dict):
    from alphazero_tpu_torch.games.splendor import env as E
    return E.SplendorConfig(num_players=config["num_players"],
                            score_win=config["score_win"])


def ref_env_config(config: dict) -> RE.SplendorConfig:
    return RE.SplendorConfig(num_players=config["num_players"],
                             score_win=config["score_win"])


def build_net(config: dict, ck: dict, device):
    """The program's ``SplendorNet`` for the configuration, in eval mode on
    ``device``, holding the checkpoint's weights; and its ``NetConfig``."""
    from alphazero_tpu_torch.games.splendor import adapter as A
    from alphazero_tpu_torch.models import splendor_net as N
    net_cfg = A.net_config_for(env_config(config), dropout=config["dropout"],
                               nn_version=config["nn_version"],
                               width=config["net_width"])
    net = N.build_net(net_cfg, device)
    net.load_state_dict(N.from_flax(ck["params"], ck["batch_stats"]))
    return net.eval(), net_cfg


def ref_net(config: dict, ck: dict, device, tf32: bool = False) -> RN.NetV1:
    if config["nn_version"] != 1:
        raise ValueError("the reference net is version 1")
    return RN.NetV1(ck["params"], ck["batch_stats"], config["net_width"],
                    device, tf32=tf32)


class Record(NamedTuple):
    """One search call: its kind, roots, generator state before and after,
    and the ``SearchResult`` fields the check reads."""
    kind: str
    roots: torch.Tensor
    state_in: torch.Tensor | None
    state_out: torch.Tensor | None
    counts: torch.Tensor
    raw_counts: torch.Tensor
    q: torch.Tensor
    root_value: torch.Tensor
    root_prior: torch.Tensor


class Recorder:
    """A search callable that keeps a ``Record`` of every call in ``log``
    (a list the caller may swap between calls).  It keeps references to
    the tensors and reads nothing back to the host."""

    def __init__(self, search, kind: str, log: list):
        self.search, self.kind, self.log = search, kind, log

    def __call__(self, params, roots, generator=None, noise_gamma=None):
        state_in = None if generator is None else generator.get_state()
        res = self.search(params, roots, generator=generator,
                          noise_gamma=noise_gamma)
        state_out = None if generator is None else generator.get_state()
        self.log.append(Record(self.kind, roots, state_in, state_out,
                               res.counts, res.raw_counts, res.q,
                               res.root_value, res.root_prior))
        return res


def compare_search(got: dict, ref: dict) -> dict:
    """The gaps between a search's outputs (a ``Record._asdict()``, or the
    reference's own dict) and the reference's search of the same roots:
    the largest gap of a root value, of a root prior and of a root Q, and
    the largest total-variation distance between two boards' visit
    distributions over the root's edges."""
    raw_p = got["raw_counts"].to(torch.float64)
    raw_r = ref["raw_counts"].to(torch.float64)
    tv = 0.5 * (raw_p / raw_p.sum(1, keepdim=True).clamp(min=1)
                - raw_r / raw_r.sum(1, keepdim=True).clamp(min=1)).abs().sum(1)

    def gap(a, b):
        return float((a.float() - b.float()).abs().max())
    return {"value_gap": gap(got["root_value"], ref["root_value"]),
            "prior_gap": gap(got["root_prior"], ref["root_prior"]),
            "q_gap": gap(got["q"], ref["q"]),
            "visits_tv": float(tv.max())}

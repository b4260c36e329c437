"""The leaf evaluator ``adapter.make_eval_fn`` over ``splendor_net.infer``
on the CPU:

- on CPU tensors it equals ``apply_inference`` bit for bit (int8 and
  float32 boards, float32 and bf16 trunks) and never touches the graph
  cache;
- it checks the net's config when a net first comes to it;
- the cache policy of ``_graphed``, with the CUDA graph replaced by a
  stand-in that runs the eager forward: eager at a key's first sight,
  captured at its second, replayed after; no capture while a profiler
  records; at most ``GRAPHS_PER_NET`` graphs per net, least recently used
  out first; a new key when a parameter is replaced by a new tensor, the
  same key after an update in place;
- ``net.eager_calls``, ``net.graph_captures`` and ``net.graph_replays``
  count under ``profiling.trace`` and nowhere else.

The graphs themselves run on the card only: ``chip_smoke.py``'s phase
``graphs`` holds them to the eager forward bit for bit.
"""

import pytest
import torch
from torch import nn

from alphazero_tpu_torch.games.splendor import adapter as A
from alphazero_tpu_torch.games.splendor import env as E
from alphazero_tpu_torch.models import splendor_net as N
from alphazero_tpu_torch.utils import profiling as PROF

CFG = E.SplendorConfig(num_players=2)


def _net(dtype="float32", width=48, seed=7):
    return N.build_net(A.net_config_for(CFG, width=width, dtype=dtype),
                       device="cpu",
                       generator=torch.Generator().manual_seed(seed))


def _inputs(B, seed=0):
    g = torch.Generator().manual_seed(seed)
    boards = E.initial_state(CFG, B, g, device="cpu")
    return boards, E.valid_moves(CFG, boards, 0)


class StandIn:
    """A captured graph that runs the eager forward and logs its life."""
    log: list = []

    def __init__(self, net, boards, valid_actions, cache):
        self.net, self.shape = net, tuple(boards.shape)
        self.log.append(("capture", self.shape))

    def __call__(self, boards, valid_actions):
        self.log.append(("replay", self.shape))
        probs, v, _ = N._forward(self.net, boards.to(torch.float32),
                                 valid_actions)
        return probs.clone(), v.clone()


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(N, "_Graph", StandIn)
    StandIn.log = []
    return StandIn.log


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("board_dtype", [torch.int8, torch.float32])
def test_cpu_evaluator_equals_apply_inference(dtype, board_dtype):
    net = _net(dtype)
    boards, valid = _inputs(5, seed=1)
    eval_fn = A.make_eval_fn(net.cfg)
    probs, v = eval_fn(net, boards.to(board_dtype), valid)
    want_p, want_v, _ = N.apply_inference(net, boards.to(torch.float32),
                                          valid)
    assert torch.equal(probs, want_p) and torch.equal(v, want_v)
    assert net not in N._GRAPHS
    # the net is left in eval mode, as apply_inference leaves it
    net.train()
    probs, v = eval_fn(net, boards.to(board_dtype), valid)
    assert not net.training
    assert torch.equal(probs, want_p) and torch.equal(v, want_v)


def test_config_checked_when_a_net_first_comes():
    boards, valid = _inputs(2, seed=2)
    eval_fn = A.make_eval_fn(A.net_config_for(CFG, width=48))
    other = _net(width=64)
    for _ in range(2):
        with pytest.raises(ValueError, match="built from"):
            eval_fn(other, boards, valid)
    net = _net()
    eval_fn(net, boards, valid)
    eval_fn(net, boards, valid)
    with pytest.raises(ValueError, match="built from"):
        eval_fn(other, boards, valid)


def test_eager_then_capture_then_replay(stand_in):
    net = _net()
    boards, valid = _inputs(4, seed=3)
    want_p, want_v, _ = N.apply_inference(net, boards.to(torch.float32),
                                          valid)
    for _ in range(4):
        probs, v = N._graphed(net, boards, valid)
        assert torch.equal(probs, want_p) and torch.equal(v, want_v)
    assert stand_in == [("capture", (4, CFG.rows, 7))] \
        + [("replay", (4, CFG.rows, 7))] * 3
    # another dtype or shape is another key
    N._graphed(net, boards.to(torch.float32), valid)
    N._graphed(net, boards[:3], valid[:3])
    assert len(stand_in) == 4
    assert len(N._GRAPHS[net].graphs) == 1


def test_no_capture_while_a_profiler_records(stand_in, tmp_path):
    net = _net()
    boards, valid = _inputs(3, seed=4)
    N._graphed(net, boards, valid)
    with PROF.trace(str(tmp_path)):
        for _ in range(3):
            N._graphed(net, boards, valid)
    assert stand_in == []
    N._graphed(net, boards, valid)
    assert stand_in == [("capture", (3, CFG.rows, 7)),
                        ("replay", (3, CFG.rows, 7))]
    # a graph captured before the profiler started replays under it
    with PROF.trace(str(tmp_path)):
        N._graphed(net, boards, valid)
    assert stand_in[-1] == ("replay", (3, CFG.rows, 7))


def test_graphs_per_net_least_recently_used_out(stand_in):
    net = _net()
    boards, valid = _inputs(N.GRAPHS_PER_NET + 1, seed=5)
    sizes = range(1, N.GRAPHS_PER_NET + 2)
    for b in sizes:
        for _ in range(2):
            N._graphed(net, boards[:b], valid[:b])
        if b == 2:
            N._graphed(net, boards[:1], valid[:1])  # size 1 used again
    graphs = N._GRAPHS[net].graphs
    assert len(graphs) == N.GRAPHS_PER_NET
    assert sorted(k[0][0] for k in graphs) == [1] + list(sizes)[2:]
    # the evicted size starts over: eager, then captured
    n = len(stand_in)
    N._graphed(net, boards[:2], valid[:2])
    assert len(stand_in) == n
    N._graphed(net, boards[:2], valid[:2])
    assert stand_in[n] == ("capture", (2, CFG.rows, 7))
    # the keys seen once are bounded too
    seen = N._GRAPHS[net].seen
    for b in range(1, 3 * N.GRAPHS_PER_NET):
        N._graphed(net, boards[:1].expand(b, -1, -1).to(torch.float32),
                   valid[:1].expand(b, -1))
    assert len(seen) == N.GRAPHS_PER_NET


def _keys(net):
    return list(N._GRAPHS[net].graphs)


@pytest.mark.parametrize("replace", ["parameter", "data", "load_assign"])
def test_new_tensor_new_key(stand_in, replace):
    net = _net()
    boards, valid = _inputs(2, seed=6)
    for _ in range(2):
        N._graphed(net, boards, valid)
    first = _keys(net)
    w = net.dense_0.weight
    if replace == "parameter":
        net.dense_0.weight = nn.Parameter(w.detach().clone())
    elif replace == "data":
        w.data = w.detach().clone()
    else:
        net.load_state_dict({k: v.clone() for k, v in
                             net.state_dict().items()}, assign=True)
    want_p, want_v, _ = N.apply_inference(net, boards.to(torch.float32),
                                          valid)
    for _ in range(2):
        probs, v = N._graphed(net, boards, valid)
        assert torch.equal(probs, want_p) and torch.equal(v, want_v)
    assert len(_keys(net)) == 2 and _keys(net)[0] == first[0]
    assert [e[0] for e in stand_in].count("capture") == 2


@pytest.mark.parametrize("update", ["adam", "load_state_dict", "bn_stats"])
def test_update_in_place_same_key(stand_in, update):
    net = _net()
    boards, valid = _inputs(4, seed=7)
    for _ in range(2):
        before, _ = N._graphed(net, boards, valid)
    first = _keys(net)
    if update == "adam":
        opt = torch.optim.Adam(net.parameters(), lr=1e-2)
        log_pi, v, _ = N.apply_train(net, boards.to(torch.float32), valid,
                                     torch.Generator().manual_seed(0))[0]
        (v.sum() - log_pi.clamp(min=-50).sum()).backward()
        opt.step()
    elif update == "load_state_dict":
        net.load_state_dict(_net(seed=8).state_dict())
    else:
        N.apply_train(net, boards.to(torch.float32), valid,
                      torch.Generator().manual_seed(1))
    net.eval()
    probs, v = N._graphed(net, boards, valid)
    assert _keys(net) == first
    assert stand_in[-1] == ("replay", (4, CFG.rows, 7))
    want_p, want_v, _ = N.apply_inference(net, boards.to(torch.float32),
                                          valid)
    assert torch.equal(probs, want_p) and torch.equal(v, want_v)
    assert not torch.equal(probs, before)


def test_counters_under_trace_only(stand_in, tmp_path):
    net = _net()
    boards, valid = _inputs(2, seed=8)
    names = ("net.eager_calls", "net.graph_captures", "net.graph_replays")

    def counted():
        c = PROF.counters()
        return tuple(c.get(n, 0) for n in names)
    before = counted()
    N._graphed(net, boards, valid)              # eager, first sight
    N._graphed(net, boards, valid)              # captured and replayed
    assert counted() == before
    with PROF.trace(str(tmp_path)):
        N._graphed(net, boards, valid)          # replayed
        N._graphed(net, boards[:1], valid[:1])  # eager, first sight
        N._graphed(net, boards[:1], valid[:1])  # eager: no capture here
        N._graphed(net, boards, valid)          # replayed
    after = counted()
    assert [a - b for a, b in zip(after, before)] == [2, 0, 2]

"""The port's fused train chunk against its own sequential steps, as
``tests/test_train_fused.py::test_train_chunk_matches_sequential_steps``
holds the JAX chunk: ``make_train_chunk`` over K=4 stacked minibatches at
the rates [1e-3, 8e-4, 6e-4, 4e-4] and K calls of ``make_train_step`` on
the same minibatches, from the same weights, with the same dropout masks
and symmetry choices (one generator from the same seed on each side,
drawn in the same order), agree within the JAX test's ``rtol=1e-5,
atol=1e-6``; both take K steps, and the chunk's metrics are the mean of
the steps' (its ``per_step`` series is the steps' metrics).
"""

import numpy as np
import torch

from alphazero_tpu_torch.games.splendor import adapter as A
from alphazero_tpu_torch.games.splendor import env as E
from alphazero_tpu_torch.train import trainer as TR
from tests.test_torch_port_fit import replay_buffer
from tests.test_torch_port_train import _one_thread  # noqa: F401

K = 4
LRS = [1e-3, 8e-4, 6e-4, 4e-4]


def _state(net_cfg):
    return TR.init_train_state(net_cfg, torch.Generator().manual_seed(0),
                               device="cpu")


def test_train_chunk_matches_sequential_steps():
    env_cfg = E.SplendorConfig(num_players=2)
    net_cfg = A.net_config_for(env_cfg)           # dropout 0.3
    cfg = TR.TrainConfig(batch_size=8, epochs=1)  # augmentation on
    state_a, state_b = _state(net_cfg), _state(net_cfg)
    batch_np = replay_buffer(0, tag=False).sample(K * cfg.batch_size,
                                                  np.random.default_rng(0))
    batches = {k: v.reshape((K, cfg.batch_size) + v.shape[1:])
               for k, v in batch_np.items()}

    chunk = TR.make_train_chunk(env_cfg, net_cfg, cfg)
    state_a, m_chunk = chunk(state_a, batches, LRS, 10.0,
                             torch.Generator().manual_seed(7))
    state_c, series = chunk(_state(net_cfg), batches, LRS, 10.0,
                            torch.Generator().manual_seed(7), per_step=True)

    step = TR.make_train_step(env_cfg, net_cfg, cfg)
    gen = torch.Generator().manual_seed(7)
    ms = []
    for i in range(K):
        state_b, m = step(state_b, {k: v[i] for k, v in batches.items()},
                          LRS[i], 10.0, gen)
        ms.append(m)

    pa, pb = state_a.net.state_dict(), state_b.net.state_dict()
    assert set(pa) == set(pb)
    for name in pa:
        np.testing.assert_allclose(pa[name].numpy(), pb[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert state_a.step == state_b.step == state_c.step == K
    # chunk metrics are the mean over the K steps
    for k in ms[0]:
        want = np.mean([float(m[k]) for m in ms])
        np.testing.assert_allclose(float(m_chunk[k]), want, rtol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(series[k].numpy(),
                                   [float(m[k]) for m in ms], rtol=1e-5,
                                   err_msg=k)
    # the steps moved the weights
    p0 = _state(net_cfg).net.state_dict()
    assert any(not torch.equal(pa[n], p0[n]) for n in pa)

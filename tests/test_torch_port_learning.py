"""Learning smoke of the port, the counterpart of
``tests/test_learning_smoke.py`` at its sizes and thresholds on the CPU:
one iteration of real self-play (width-64 v1 net, dropout 0, B=16, S=32,
PCR, forced playouts) gives more than 300 examples whose policy targets
lie on valid actions; 24 epochs of ``fit`` on them drive the policy loss
below 0.8 of the first epoch's, and teach the value head to predict the
game outcomes (train-mode value correlation with the winner above 0.5 and
above the untrained net's by 0.3)."""

import numpy as np
import torch

from alphazero_tpu_torch.games.splendor import adapter as A
from alphazero_tpu_torch.games.splendor import env as E
from alphazero_tpu_torch.models import splendor_net as N
from alphazero_tpu_torch.train import selfplay as SP
from alphazero_tpu_torch.train import trainer as TR
from alphazero_tpu_torch.train.replay import ReplayBuffer
from tests.test_torch_port_train import _one_thread  # noqa: F401


def test_policy_distillation_on_selfplay_data():
    env_cfg = E.SplendorConfig(num_players=2)
    net_cfg = A.net_config_for(env_cfg, width=64, dropout=0.0)
    net = N.build_net(net_cfg, "cpu", torch.Generator().manual_seed(0))

    sp_cfg = SP.SelfPlayConfig(batch_size=16, num_sims=32, ratio_full=4,
                               prob_full=0.5, temp_threshold=8,
                               forced_playouts=True)
    eng = SP.SelfPlayEngine(env_cfg, A.make_eval_fn(net_cfg), sp_cfg,
                            device="cpu")
    it, stats = eng.run_games(net, torch.Generator().manual_seed(1))
    assert stats["examples"] > 300

    # stored policy targets must sit entirely on valid actions
    pi = np.asarray(it.pi, np.float32)
    valids = np.asarray(it.valids)
    assert float((pi * ~valids).sum()) < 1e-4

    replay = ReplayBuffer(history=1)
    replay.add_iteration(it)
    train_cfg = TR.TrainConfig(learn_rate=1e-3, batch_size=64, epochs=24,
                               augment=True)
    state = TR.init_train_state(net_cfg, torch.Generator().manual_seed(2),
                                device="cpu")
    step = TR.make_train_step(env_cfg, net_cfg, train_cfg)
    epoch_pi = []
    state, _ = TR.fit(state, step, replay, train_cfg,
                      np.random.default_rng(1),
                      torch.Generator().manual_seed(3),
                      on_epoch_end=lambda e, st, m: epoch_pi.append(m["pi"]))

    # (a) the policy loss falls substantially over training
    assert len(epoch_pi) == 24
    assert epoch_pi[-1] < epoch_pi[0] * 0.8, epoch_pi

    # (b) the value head learned to predict outcomes, read with batch
    # statistics (train-mode forward, dropout 0), as the JAX test reads it
    boards = torch.from_numpy(np.asarray(it.boards, np.float32)[:256])
    v_mask = torch.from_numpy(valids[:256])
    winner = np.asarray(it.winner, np.float32)[:256]

    def value_corr(m):
        with torch.no_grad():
            (_, val, _), _ = N.apply_train(m, boards, v_mask)
        return float((val.numpy() * winner).mean())

    corr_trained = value_corr(state.net)
    corr_untrained = value_corr(net)
    assert corr_trained > 0.5, (corr_trained, corr_untrained)
    assert corr_trained > corr_untrained + 0.3, (corr_trained, corr_untrained)

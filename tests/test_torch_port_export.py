"""Port parity: checkpoint import, the ONNX writer and the ``torch.export``
artifact (``compat/torch_import.py``, ``compat/onnx_export.py``,
``cli/export.py``) against the JAX package.

- Reference import: a reference-layout checkpoint made here from seeded
  numpy weights (sized by the JAX ``_mapping`` from the JAX init shapes),
  saved with a ``full_model`` whose class no longer imports, with 409 and
  with 406 actions.  The port's ``load_as_bundle`` equals the JAX one
  exactly on every mapped tensor (for 406, the remapped PI head's 405
  moves and pass; its noble-select rows come from each package's own
  initializer).  The forward agrees with the JAX forward and with
  ``tests/test_torch_import.py``'s reference model at rtol 1e-5, atol 1e-6
  (float32 sums in other orders).
- ONNX: for the same weights the port's bytes equal the JAX writer's (v0,
  v1, v2), and ``tests/onnx_mini.py`` runs them to the port's forward
  within the JAX test's tolerances (``tests/test_onnx_export.py``).
- The export CLI reads ``nn_version`` and ``net_width`` from the meta.
  The JAX CLI does not (``alphazero_tpu/cli/export.py:40-41``, ``:82-86``):
  its ONNX graph of a width-64 v1 checkpoint is built for width 128 and
  does not run, and its StableHLO export of a v2 checkpoint raises.
- The ``.pt2`` artifact reloads and equals the live net at B=1 and B=4
  (rtol 1e-5, atol 1e-6, as ``tests/test_export.py`` holds JAX's).
"""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.errors import ScopeParamShapeError

from alphazero_tpu.cli import export as JX
from alphazero_tpu.compat import onnx_export as JOX
from alphazero_tpu.compat import torch_import as JTI
from alphazero_tpu.games.splendor import adapter as JA
from alphazero_tpu.games.splendor import env as JE
from alphazero_tpu.models import splendor_net as JN
from alphazero_tpu_torch.cli import export as X
from alphazero_tpu_torch.compat import onnx_export as OX
from alphazero_tpu_torch.compat import torch_import as TI
from alphazero_tpu_torch.games.splendor import adapter as A
from alphazero_tpu_torch.games.splendor import env as E
from alphazero_tpu_torch.models import splendor_net as N
from alphazero_tpu_torch.utils import checkpoint as C
from tests import onnx_mini
from tests.test_torch_import import _build_torch_model
from tests.test_torch_port_train import _one_thread  # noqa: F401
from tests.test_torch_port_train import positions

_jinit = jax.jit(JN.init_params, static_argnums=0)
_jinfer = jax.jit(JN.apply_inference, static_argnums=0)
TOL = dict(rtol=1e-5, atol=1e-6)


def _reference_state_dict(actions: int, seed: int = 0) -> dict:
    """Reference-layout tensors for every key of the JAX ``_mapping``,
    shaped from the JAX init (a Flax kernel ``(in, out)`` is a reference
    ``weight (out, in)``), from seeded numpy draws of an initialized
    net's scale."""
    jcfg = JA.net_config_for(JE.SplendorConfig())
    params, stats = _jinit(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    sd = {}
    for tkey, fpath, kind in JTI._mapping():
        node = stats if kind == "bn_stat" else params
        for p in fpath:
            node = node[p]
        shape = np.shape(node)[::-1] if kind == "linear_w" else np.shape(node)
        if tkey == "output_layers_PI.1.weight":
            shape = (actions, shape[1])
        elif tkey == "output_layers_PI.1.bias":
            shape = (actions,)
        u = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
        if kind == "linear_w":
            a = u * np.sqrt(3.0 / shape[1], dtype=np.float32)
        elif tkey.endswith("running_var"):
            a = 1.0 + 0.5 * np.abs(u)
        elif tkey.endswith(".weight"):                 # BatchNorm scale
            a = 1.0 + 0.2 * u
        else:
            a = 0.1 * u
        sd[tkey] = torch.from_numpy(a)
    return sd


def _save_reference(path, sd):
    """``{'state_dict', 'full_model', <training args>}`` as the reference
    saves it, the full model an instance of a class that no longer
    imports when the file is read."""
    mod = types.ModuleType("reference_splendor_nnet")
    mod.SplendorNNet = type("SplendorNNet", (), {"__module__": mod.__name__})
    model = mod.SplendorNNet()
    model.args = {"nn_version": 1}
    sys.modules[mod.__name__] = mod
    try:
        torch.save({"state_dict": sd, "full_model": model,
                    "numPlayers": 2, "numMCTSSims": 800, "cpuct": 1.25},
                   str(path))
    finally:
        del sys.modules[mod.__name__]


@pytest.mark.parametrize("actions", [409, 406])
def test_reference_import_equals_jax(tmp_path, actions):
    sd = _reference_state_dict(actions)
    path = tmp_path / "ref.pt"
    _save_reference(path, sd)
    jcfg = JA.net_config_for(JE.SplendorConfig())
    cfg = A.net_config_for(E.SplendorConfig())
    jparams, jstats, jmeta = JTI.load_as_bundle(str(path), jcfg)
    port_sd, meta = TI.load_as_bundle(str(path), cfg)
    assert meta == jmeta == {"numPlayers": 2, "numMCTSSims": 800,
                             "cpuct": 1.25}
    assert type(TI.torch_load_tolerant(str(path))["full_model"]).__name__ \
        == "SplendorNNet"

    params, stats = N.to_flax(port_sd)
    got = dict(C.tree_items(params)) | dict(C.tree_items(stats))
    want = dict(C.tree_items(jparams)) | dict(C.tree_items(jstats))
    assert set(got) == set(want)
    pi_moves = np.r_[0:405, 408]
    for k, w in want.items():
        w, g = np.asarray(w), got[k]
        if actions == 406 and k[0] == "Dense_7":
            w, g = w[..., pi_moves], g[..., pi_moves]
        np.testing.assert_array_equal(g, w, err_msg=str(k))

    net = N.build_net(cfg, "cpu")
    net.load_state_dict(port_sd)
    _, s, valids = positions(2, 6, seed=3)
    boards = s.to(torch.float32)
    probs, v, _ = N.apply_inference(net, boards, valids)
    jp, jv, _ = _jinfer(jcfg, jparams, jstats, jnp.asarray(boards.numpy()),
                        jnp.asarray(valids.numpy()))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jp), **TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)

    ref, _, ref_actions = _build_torch_model(sd)
    assert ref_actions == actions
    cols = pi_moves if actions == 406 else np.arange(409)
    with torch.no_grad():
        t_logpi, t_v, _ = ref(boards, valids[:, cols])
    np.testing.assert_allclose(probs[:, cols].numpy(),
                               np.exp(t_logpi.numpy()), **TOL)
    np.testing.assert_allclose(v.numpy(), t_v.numpy(), **TOL)


def _same_weights(version, width, seed=3):
    """JAX init weights, and a port net holding them."""
    jcfg = JA.net_config_for(JE.SplendorConfig(), nn_version=version,
                             width=width)
    params, bs = _jinit(jcfg, jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(np.asarray, params)
    bs = jax.tree_util.tree_map(np.asarray, bs)
    net = N.build_net(N.NetConfig(**jcfg.__dict__), "cpu")
    net.load_state_dict(N.from_flax(params, bs))
    return jcfg, params, bs, net


@pytest.mark.parametrize("version", [0, 1, 2])
def test_onnx_bytes_equal_jax_and_run(tmp_path, version):
    jcfg, params, bs, net = _same_weights(version, 48)
    JOX.export_onnx(jcfg, params, bs, str(tmp_path / "jax.onnx"))
    OX.export_net(net, str(tmp_path / "port.onnx"))
    blob = (tmp_path / "port.onnx").read_bytes()
    assert blob == (tmp_path / "jax.onnx").read_bytes()

    model = onnx_mini.load_model(str(tmp_path / "port.onnx"))
    assert model["inputs"] == ["board", "valid_actions"]
    assert model["outputs"] == ["pi", "v", "scdiffs"]
    _, s, valids = positions(2, 16, seed=version)
    boards = s.to(torch.float32)
    pi_o, v_o, sd_o = onnx_mini.run_model(
        model, {"board": boards.numpy(), "valid_actions": valids.numpy()})
    with torch.no_grad():
        log_pi, v, log_sd = net(boards, valids)
    np.testing.assert_allclose(pi_o, log_pi.numpy(), atol=1e-3)
    np.testing.assert_allclose(v_o, v.numpy(), atol=1e-4)
    np.testing.assert_allclose(sd_o, log_sd.numpy(), atol=1e-3)


def _save_port(folder, version, width, name="best.pt"):
    net = N.build_net(A.net_config_for(E.SplendorConfig(), nn_version=version,
                                       width=width), "cpu",
                      torch.Generator().manual_seed(version))
    params, bs = N.to_flax(net.state_dict())
    C.save_checkpoint(str(folder), name, params=params, batch_stats=bs,
                      meta={"num_players": 2, "nn_version": version,
                            "net_width": width})
    return str(folder / name), net


def test_onnx_cli_reads_width_from_meta(tmp_path):
    """A width-64 v1 checkpoint: the port's graph runs to the port's
    forward; the JAX CLI's graph, built for width 128, does not run."""
    ckpt, net = _save_port(tmp_path, 1, 64)
    assert X.main([ckpt, "-o", str(tmp_path / "port.onnx"),
                   "--format", "onnx"]) == 0
    JX.main([ckpt, "-o", str(tmp_path / "jax.onnx"), "--format", "onnx"])
    _, s, valids = positions(2, 4, seed=1)
    feeds = {"board": s.to(torch.float32).numpy(),
             "valid_actions": valids.numpy()}
    pi_o, v_o, _ = onnx_mini.run_model(
        onnx_mini.load_model(str(tmp_path / "port.onnx")), feeds)
    with torch.no_grad():
        log_pi, v, _ = net(s.to(torch.float32), valids)
    np.testing.assert_allclose(pi_o, log_pi.numpy(), atol=1e-3)
    np.testing.assert_allclose(v_o, v.numpy(), atol=1e-4)
    with pytest.raises(ValueError):
        onnx_mini.run_model(onnx_mini.load_model(str(tmp_path / "jax.onnx")),
                            feeds)


@pytest.mark.parametrize("version,width", [(1, 48), (2, 256)])
def test_pt2_roundtrip(tmp_path, version, width):
    """The artifact reloads and equals the live net at B=1 and B=4, for a
    v2 checkpoint too (the JAX StableHLO export builds a v1 net whatever
    the meta says, and raises on it)."""
    ckpt, net = _save_port(tmp_path, version, width)
    out = str(tmp_path / "m.pt2")
    X.export_checkpoint(ckpt, out, device="cpu")
    fn = X.load_exported(out)
    cfg = E.SplendorConfig()
    for B in (1, 4):
        _, s, valids = positions(2, B, seed=B)
        boards = s.to(torch.float32)
        got = fn(boards, valids)
        want = N.apply_inference(net, boards, valids)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.detach().numpy(), w.numpy(), **TOL)
    assert X.check_roundtrip(fn, net.eval(), cfg) <= 1e-6
    if version == 2:
        with pytest.raises(ScopeParamShapeError):
            JX.export_checkpoint(ckpt, None, platforms=("cpu",))


def test_pt2_cli_check(tmp_path, capsys):
    ckpt, _ = _save_port(tmp_path, 1, 48)
    assert X.main([ckpt, "--check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "roundtrip ok" in out
    assert (tmp_path / "best.pt2").exists()

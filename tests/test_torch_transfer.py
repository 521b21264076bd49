"""Transfer learning through the port (the config's ``transfer`` block;
``asr_apply(..., fix_enc_layers=, fix_dec=)``).

The port's twin of ``tests/test_train_infra.py::
test_transfer_learning_freezes_grads``: the frozen encoder layer, the
decoder, the attention, the embedding and the CTC head get exactly zero
gradient, the trainable layer does not. The freeze stops the gradient to
the frozen parameters only: a trainable layer BELOW a frozen one still
learns through its input (the planted fault, stopping the frozen layer's
input gradient, must be caught). Then a CLI run: train, ``--load`` the
checkpoint with ``transfer: {train_enc: [1], train_dec: False}``: the
frozen leaves stay bitwise what was loaded, the trainable ones move, the
optimizer state starts anew (count 2 after two steps), and the checkpoint
names carry JAX's ``_tune-1-0-sd<seed>``. As in JAX, the block freezes
rnn layers only: the frontend keeps training.
"""

import os

import pytest
import torch
import yaml

from e2e_asr_pytorch_tpu_torch import convert
from e2e_asr_pytorch_tpu_torch.models import asr as TM
from e2e_asr_pytorch_tpu_torch.models import encoder as TE
from e2e_asr_pytorch_tpu_torch.train import optim as TO
from test_torch_train import _write_configs

CFG = dict(
    ctc_weight=0.5,
    encoder=dict(vgg=6, vgg_freq=-1, vgg_low_filt=-1, module="LSTM",
                 bidirection=False, dim=[8, 8], dropout=[0.0, 0.0],
                 layer_norm=[False, False], proj=[False, False],
                 sample_rate=[1, 1], sample_style="drop"),
    attention=dict(mode="dot", dim=4, num_head=1, v_proj=False,
                   temperature=1.0),
    decoder=dict(module="LSTM", dim=8, layer=1, dropout=0))


def _grads(fix_enc_layers, fix_dec, vgg=6):
    spec = TM.build_spec(12, 7, **dict(CFG, encoder=dict(CFG["encoder"],
                                                         vgg=vgg)))
    params = TM.asr_init(torch.Generator().manual_seed(0), spec)
    leaves = convert.tree_map(lambda x: x.detach().requires_grad_(), params)
    feat = torch.ones(1, 16, 12) + 0.1 * torch.randn(
        1, 16, 12, generator=torch.Generator().manual_seed(1))
    ctc, _, att, _, _ = TM.asr_apply(
        leaves, spec, feat, torch.tensor([16]), 3,
        teacher=torch.tensor([[3, 4, 1]]), gen=torch.Generator(),
        train=True, sample_free=True, tf_rate=1.0,
        fix_enc_layers=fix_enc_layers, fix_dec=fix_dec)
    total = (att ** 2).sum() + (ctc ** 2).sum()
    flat = convert.tree_leaves(leaves)
    g = iter([torch.zeros_like(p) if x is None else x for p, x in zip(
        flat, torch.autograd.grad(total, flat, allow_unused=True))])
    return convert.tree_map(lambda _: next(g), params)


def _norm(tree):
    return float(TO.global_norm(tree))


def test_transfer_learning_freezes_grads():
    g = _grads((0,), True)
    assert _norm(g["encoder"]["layers"][0]) == 0.0
    assert _norm(g["decoder"]) == 0.0
    assert _norm(g["attention"]) == 0.0
    assert float(g["pre_embed"].abs().sum()) == 0.0
    assert _norm(g["ctc_layer"]) == 0.0
    assert _norm(g["encoder"]["layers"][1]) > 0.0


def test_frozen_layer_passes_the_gradient_to_the_layers_below():
    g = _grads((-1, 1), False, vgg=5)
    assert _norm(g["encoder"]["frontend"]) == 0.0
    assert _norm(g["encoder"]["layers"][1]) == 0.0
    assert _norm(g["encoder"]["layers"][0]) > 0.0
    assert _norm(g["decoder"]) > 0.0


def test_stopping_the_frozen_layers_input_gradient_is_caught(monkeypatch):
    """Twin: a freeze that cuts the graph at the frozen layer's input (as a
    stop-gradient on activations would) starves the layer below it."""
    real = TE._rnn_layer_apply

    def cut(p, spec, l, x, *a, **k):
        if not p["fw"]["w_h"].requires_grad:          # a frozen layer
            x = x.detach()
        return real(p, spec, l, x, *a, **k)
    monkeypatch.setattr(TE, "_rnn_layer_apply", cut)
    g = _grads((-1, 1), False, vgg=5)
    assert _norm(g["encoder"]["layers"][0]) == 0.0


def _leaf_map(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _leaf_map(v, prefix + "/" + k).items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _leaf_map(v, "{}/{}".format(prefix, i)).items()}
    return {prefix: tree}


def test_cli_transfer_keeps_the_frozen_leaves(tmp_path):
    from e2e_asr_pytorch_tpu_torch.main import main
    from e2e_asr_pytorch_tpu_torch.train import checkpoint as ckpt_lib
    paths = _write_configs(str(tmp_path))
    run = ["--cpu", "--njobs", "0", "--no-msg", "--logdir",
           str(tmp_path / "log"), "--ckpdir", str(tmp_path / "ckpt")]
    main(["--config", paths["train"], "--name", "tiny"] + run)
    src = str(tmp_path / "ckpt" / "tiny" / "last_att_dev.pth")
    with open(paths["train"]) as f:
        cfg = yaml.safe_load(f)
    cfg["transfer"] = {"train_enc": [1], "train_dec": False}
    cfg["hparas"].update(max_step=4, valid_step=2)
    tune = str(tmp_path / "tune.yaml")
    with open(tune, "w") as f:
        yaml.safe_dump(cfg, f)
    solver = main(["--config", tune, "--name", "tune", "--load", src,
                   "--seed", "3"] + run)
    assert solver.step == 4 and int(solver.opt_state["count"]) == 2
    loaded = _leaf_map(ckpt_lib.load_checkpoint(src)["model"])
    now = _leaf_map(solver.params)
    # as in JAX, ``transfer`` freezes rnn layers only: the VGG frontend
    # keeps training (its solver never lists -1 in fix_enc)
    trained = ("/encoder/layers/1/", "/encoder/frontend/")
    frozen = [k for k in now if not k.startswith(trained)]
    assert len(frozen) > 20
    assert [k for k in frozen if not torch.equal(loaded[k], now[k])] == []
    moved = [k for k in now if k.startswith("/encoder/layers/1/")
             and not torch.equal(loaded[k], now[k])]
    assert len(moved) >= 4, moved
    names = os.listdir(tmp_path / "ckpt" / "tune")
    assert "last_att_dev_tune-1-0-sd3.pth" in names, names


@pytest.mark.parametrize("seed,want", [(0, "_tune-02-1"),
                                       (5, "_tune-02-1-sd5")])
def test_save_name_follows_jax(tmp_path, seed, want):
    from e2e_asr_pytorch_tpu_torch.train.train_asr import Solver
    from e2e_asr_pytorch_tpu_torch.utils.config import parse_paras
    paths = _write_configs(str(tmp_path))
    with open(paths["train"]) as f:
        cfg = yaml.safe_load(f)
    cfg["transfer"] = {"train_enc": [0, 2], "train_dec": True}
    cfg["model"]["encoder"].update(dim=[16] * 3, dropout=[0.0] * 3,
                                   layer_norm=[False] * 3, proj=[True] * 3,
                                   sample_rate=[1] * 3)
    paras = parse_paras(["--config", paths["train"], "--cpu", "--seed",
                         str(seed), "--logdir", str(tmp_path / "log"),
                         "--ckpdir", str(tmp_path / "ckpt"), "--no-msg"])
    s = Solver(cfg, paras, "train")
    assert s.save_name == want and s.fix_enc == [1] and not s.fix_dec


def test_num_layers_runs_the_first_layers_only():
    """``encoder_apply(num_layers=1)`` is the stack cut after its first
    layer (JAX's probe API)."""
    spec = TM.build_spec(12, 7, **CFG)
    params = TM.asr_init(torch.Generator().manual_seed(0), spec)
    cut = TE.make_spec(12, **dict(CFG["encoder"], dim=[8], dropout=[0.0],
                                  layer_norm=[False], proj=[False],
                                  sample_rate=[1]))
    feat = torch.randn(2, 16, 12, generator=torch.Generator().manual_seed(2))
    lens = torch.tensor([16, 11])
    y, y_len = TE.encoder_apply(params["encoder"], spec.encoder, feat, lens,
                                num_layers=1)
    want, want_len = TE.encoder_apply(
        dict(params["encoder"], layers=params["encoder"]["layers"][:1]),
        cut, feat, lens)
    assert torch.equal(y, want) and torch.equal(y_len, want_len)
    full, _ = TE.encoder_apply(params["encoder"], spec.encoder, feat, lens)
    assert not torch.equal(full, y)

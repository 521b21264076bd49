"""The port's APC upstream (``models/apc.py``, ``data/upstream.py``,
``train_apc.py`` and ``--upstream`` in both solvers) against the JAX
package's on shared weights.

Tolerances: f32 encodes and losses atol 1e-5 and gradients 1e-4 of each
leaf's largest element (f32 sums in another order through a recurrence);
the bf16 upstream (``make_upstream``) 1e-2, the bf16 bound of the LSTM
tests (one bf16 ulp of |h| <= 1, fed back); three ``pretrain_apc`` steps
(bf16, bare Adam) hold each leaf's parameter change within 5e-2 in the L2
norm, as the LM step test does: Adam's first updates are +-lr whatever a
gradient's size, so noise-level gradient elements flip by a whole lr. Each
has a planted-fault twin (doubled w_h, doubled head weight, doubled lr)."""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from e2e_asr_pytorch_tpu.models import apc as JA
from e2e_asr_pytorch_tpu_torch import convert
from e2e_asr_pytorch_tpu_torch.data import upstream as TU
from e2e_asr_pytorch_tpu_torch.models import apc as TA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = dict(input_dim=20, hidden=24, n_layers=2, time_shift=2)
ATOL = 1e-5
GRAD_REL = 1e-4
BF16_ATOL = 1e-2
STEP_L2 = 5e-2


@pytest.fixture(scope="module")
def jparams():
    return JA.apc_init(jax.random.PRNGKey(0), JA.APCSpec(**SPEC))


def _port(jp, wh_scale=1.0, head_scale=1.0):
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    tp["layers"][-1]["w_h"] = tp["layers"][-1]["w_h"] * wh_scale
    tp["head"]["w"] = tp["head"]["w"] * head_scale
    return tp


def _feat(seed=0, b=3, t=23):
    rng = np.random.default_rng(seed)
    feat = rng.standard_normal((b, t, SPEC["input_dim"])).astype(np.float32)
    return feat, np.array([t, t - 5, t - 11], np.int32)


def _tones(n=6, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        m = int(rng.integers(5000, 9000))
        t = np.arange(m) / 16000.0
        out.append((0.3 * np.sin(2 * np.pi * (250 + 40 * i) * t)
                    + 0.01 * rng.standard_normal(m)).astype(np.float32))
    return out


def _batches(n, batch=3, n_s=6400, seed=0):
    rng = np.random.default_rng(seed)
    waves = _tones()
    out = []
    for _ in range(n):
        wav = np.zeros((batch, n_s), np.float32)
        lens = np.zeros((batch,), np.int32)
        for i in range(batch):
            w = waves[rng.integers(len(waves))][:n_s]
            wav[i, :len(w)] = w
            lens[i] = len(w)
        out.append((wav, lens))
    return out


def _encode_err(jp, **fault):
    feat, _ = _feat()
    jh = np.asarray(JA.apc_encode(jp, JA.APCSpec(**SPEC), jnp.asarray(feat)))
    th = TA.apc_encode(_port(jp, **fault), TA.APCSpec(**SPEC),
                       torch.from_numpy(feat))
    assert tuple(th.shape) == jh.shape == (3, 23, SPEC["hidden"])
    assert th.dtype == torch.float32
    return float(np.abs(jh - th.numpy()).max())


def test_apc_encode_matches_jax(jparams):
    assert _encode_err(jparams) <= ATOL


def test_apc_encode_fails_under_doubled_w_h(jparams):
    assert _encode_err(jparams, wh_scale=2.0) > 100 * ATOL


def _loss_both(jp, **fault):
    spec_j, spec_t = JA.APCSpec(**SPEC), TA.APCSpec(**SPEC)
    feat, feat_len = _feat(1)
    jl, jg = jax.value_and_grad(lambda p: JA.apc_loss(
        p, spec_j, jnp.asarray(feat), jnp.asarray(feat_len), train=False))(jp)
    jg = convert.tree_leaves(convert.from_jax_params(
        jax.tree.map(np.asarray, jg)))
    leaves = convert.tree_map(lambda x: x.clone().requires_grad_(),
                              _port(jp, **fault))
    tl = TA.apc_loss(leaves, spec_t, torch.from_numpy(feat),
                     torch.from_numpy(feat_len).long(), train=False)
    tg = torch.autograd.grad(tl, convert.tree_leaves(leaves))
    grad = max(float((a - g).abs().max() / a.abs().max())
               for a, g in zip(jg, tg))
    return abs(float(jl) - float(tl.detach())), grad


def test_apc_loss_and_gradients_match_jax(jparams):
    loss, grad = _loss_both(jparams)
    assert loss <= ATOL and grad <= GRAD_REL, (loss, grad)


def test_apc_loss_fails_under_doubled_head(jparams):
    loss, grad = _loss_both(jparams, head_scale=2.0)
    assert loss > 100 * ATOL and grad > 100 * GRAD_REL


def _upstream_err(jp, **fault):
    wav, wav_len = _batches(1)[0]
    jf, jl = JA.make_upstream(jp, JA.APCSpec(**SPEC))(jnp.asarray(wav),
                                                      jnp.asarray(wav_len))
    tf, tl = TA.make_upstream(_port(jp, **fault), TA.APCSpec(**SPEC))(
        torch.from_numpy(wav), torch.from_numpy(wav_len).long())
    assert tf.dtype == torch.float32 and tuple(tf.shape) == jf.shape
    assert not tf.requires_grad
    assert np.array_equal(np.asarray(jl), tl.numpy())
    return float(np.abs(np.asarray(jf) - tf.numpy()).max())


def test_make_upstream_matches_jax_at_bf16(jparams):
    assert _upstream_err(jparams) <= BF16_ATOL


def test_make_upstream_fails_under_doubled_w_h(jparams):
    assert _upstream_err(jparams, wh_scale=2.0) > 10 * BF16_ATOL


def test_jax_checkpoint_loads_in_the_port(jparams, tmp_path):
    path = str(tmp_path / "jax.npz")
    JA.save_apc(path, jparams, JA.APCSpec(**SPEC, dropout=0.1))
    tp, spec = TA.load_apc(path)
    assert spec == TA.APCSpec(**SPEC, dropout=0.1)
    feat, _ = _feat(2)
    jh = np.asarray(JA.apc_encode(jparams, JA.APCSpec(**SPEC),
                                  jnp.asarray(feat)))
    th = TA.apc_encode(tp, spec, torch.from_numpy(feat)).numpy()
    assert np.abs(jh - th).max() <= ATOL


def test_port_checkpoint_loads_in_jax(tmp_path):
    spec = TA.APCSpec(**SPEC)
    tp = TA.apc_init(torch.Generator().manual_seed(5), spec)
    path = str(tmp_path / "port.npz")
    TA.save_apc(path, tp, spec)
    jp, jspec = JA.load_apc(path)
    assert tuple(jspec) == tuple(spec)
    for l in range(spec.n_layers):
        for k in ("w_x", "w_h", "b"):
            np.testing.assert_array_equal(np.asarray(jp["layers"][l][k]),
                                          tp["layers"][l][k].numpy())
    feat, _ = _feat(3)
    jh = np.asarray(JA.apc_encode(jp, jspec, jnp.asarray(feat)))
    th = TA.apc_encode(tp, spec, torch.from_numpy(feat)).numpy()
    assert np.abs(jh - th).max() <= ATOL
    # a planted fault in the file is seen by the other side
    z = dict(np.load(path))
    z["layer1/w_h"] = 2 * z["layer1/w_h"]
    np.savez(path, **z)
    jp2, _ = JA.load_apc(path)
    jh2 = np.asarray(JA.apc_encode(jp2, jspec, jnp.asarray(feat)))
    assert np.abs(jh2 - th).max() > 100 * ATOL


def _pretrain_both(jparams, lr_scale=1.0):
    """Three bf16 steps of each package's pretrain_apc from the JAX init:
    max over leaves of ||dp_port - dp_jax|| / ||dp_jax||, and the first and
    last losses of each."""
    batches = _batches(3)
    jlog, tlog = [], []
    jp = JA.pretrain_apc(batches, JA.APCSpec(**SPEC), 3, lr=1e-3, seed=0,
                         log_every=1, verbose=jlog.append)
    init = _port(jparams)
    tp = TA.pretrain_apc(batches, TA.APCSpec(**SPEC), 3, lr=1e-3 * lr_scale,
                         seed=0, log_every=1, verbose=tlog.append,
                         device="cpu", params=init)
    jp = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    rel = max(float((t - i - (j - i)).norm() / (j - i).norm())
              for i, j, t in zip(convert.tree_leaves(init),
                                 convert.tree_leaves(jp),
                                 convert.tree_leaves(tp)))

    def losses(log):
        return [float(m.split("L1 ")[1]) for m in log if "step" in m]
    return rel, losses(jlog), losses(tlog)


def test_pretrain_apc_three_steps_match_jax(jparams):
    rel, jl, tl = _pretrain_both(jparams)
    assert len(jl) == len(tl) == 3
    assert rel <= STEP_L2, rel
    assert np.abs(np.array(jl) - np.array(tl)).max() <= 1e-3, (jl, tl)


def test_pretrain_apc_fails_under_doubled_lr(jparams):
    assert _pretrain_both(jparams, lr_scale=2.0)[0] > 10 * STEP_L2


def test_missing_checkpoint_auto_pretrains(monkeypatch, tmp_path):
    """A fresh checkout has no APC checkpoint: the factory pretrains one on
    the synthetic corpus (here for 2 steps of 2 crops), writes it where
    $APC_CKPT points, and serves the 512-wide 3-layer encoder from it."""
    path = tmp_path / "auto" / "apc.npz"
    monkeypatch.setenv("APC_CKPT", str(path))
    monkeypatch.setattr(TU, "_auto_pretrain_apc", functools.partial(
        TU._auto_pretrain_apc, steps=2, batch=2, seconds=0.5))
    monkeypatch.delitem(TU._REGISTRY, "apc", raising=False)
    try:
        fn, dim = TU.get_upstream("apc", "cpu")
        assert path.exists() and dim == 512
        _, spec = TA.load_apc(str(path))
        assert spec == TA.APCSpec()
        feat, feat_len = fn(torch.zeros(1, 3200), torch.tensor([3200]))
        assert tuple(feat.shape) == (1, 20, 512)
        assert bool(torch.isfinite(feat).all())
    finally:
        TU._REGISTRY.pop("apc", None)


def test_unregistered_upstream_raises_key_error_naming_the_builtins():
    with pytest.raises(KeyError, match=r"available: \['apc', 'fbank80'\]"):
        TU.get_upstream("fbank", "cpu")


def test_fbank80_upstream_is_the_80_mel_front_end():
    fn, dim = TU.get_upstream("fbank80", "cpu")
    wav, wav_len = _batches(1)[0]
    feat, feat_len = fn(torch.from_numpy(wav),
                        torch.from_numpy(wav_len).long())
    assert dim == 80 and feat.shape[-1] == 80


def _write_cli_configs(tmp_path):
    """The upstream recipe's blocks (vgg 7 Featemb, BLSTM, CTC only) at a
    debug width on the synthetic corpus, and a CTC-beam test config."""
    with open(os.path.join(ROOT, "config",
                           "librispeech_asr_upstream.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["data"]["corpus"] = {
        "name": "synthetic", "path": "", "train_split": ["train"],
        "dev_split": ["dev"], "bucketing": True, "batch_size": 2,
        "n_utts": 4, "min_tokens": 2, "max_tokens": 4}
    cfg["data"]["text"] = {"mode": "character", "vocab_file": os.path.join(
        ROOT, "corpus", "librispeech_char.txt")}
    cfg["hparas"].update(max_step=1, valid_step=1)
    enc = cfg["model"]["encoder"]
    enc["dim"] = [16]
    assert enc["vgg"] == 7 and cfg["model"]["ctc_weight"] == 1.0
    test = {"src": {"config": str(tmp_path / "train.yaml"),
                    "ckpt": str(tmp_path / "ckpt" / "train" /
                                "last_ctc_dev.pth")},
            "data": {"corpus": {"name": "synthetic", "path": "",
                                "dev_split": ["dev"], "test_split": ["test"],
                                "bucketing": False, "batch_size": 2,
                                "n_utts": 2, "min_tokens": 2,
                                "max_tokens": 3}},
            "decode": {"beam_size": 2, "ctc_weight": 1.0,
                       "min_len_ratio": 0.01, "max_len_ratio": 0.06}}
    for name, c in (("train", cfg), ("test", test)):
        with open(tmp_path / (name + ".yaml"), "w") as f:
            yaml.safe_dump(c, f)


@pytest.mark.parametrize("upstream", ["fbank80", "apc"])
def test_cli_trains_and_decodes_on_an_upstream_without_jax(tmp_path,
                                                           upstream):
    """One training step and a CTC-beam ``--test`` through the port's CLI
    with ``--upstream``, in a fresh process that imports no JAX; the
    upstream's weights stay out of the ASR parameters and checkpoint."""
    _write_cli_configs(tmp_path)
    spec = TA.APCSpec(input_dim=80, hidden=24, n_layers=1)
    TA.save_apc(str(tmp_path / "apc.npz"),
                TA.apc_init(torch.Generator().manual_seed(0), spec), spec)
    run = ["--cpu", "--njobs", "0", "--no-msg", "--upstream", upstream]
    code = (
        "import sys, torch\n"
        "from e2e_asr_pytorch_tpu_torch.main import main\n"
        "s = main({train!r})\n"
        "dim = {dim}\n"
        "assert s.feat_dim == dim and s.step == 1, (s.feat_dim, s.step)\n"
        "assert s.spec.encoder.frontend.vgg == 7\n"
        "assert tuple(s.params['encoder']['frontend']['dense']['w'].shape)"
        " == (dim, 256)\n"
        "assert sorted(s.params) == ['ctc_layer', 'encoder']\n"
        "ck = torch.load({ckpt!r}, weights_only=False)\n"
        "assert sorted(ck['model']) == ['ctc_layer', 'encoder']\n"
        "t = main({test!r})\n"
        "assert t.feat_dim == dim and t.n_utts == 4 and t.beam_size == 2\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                                    'optax', 'e2e_asr_pytorch_tpu'))\n"
        "assert not bad, bad\n"
        "print('NO_JAX_OK')\n").format(
            train=["--config", str(tmp_path / "train.yaml"), "--name",
                   "train", "--logdir", str(tmp_path / "log"), "--ckpdir",
                   str(tmp_path / "ckpt")] + run,
            test=["--test", "--config", str(tmp_path / "test.yaml"),
                  "--outdir", str(tmp_path / "out")] + run,
            dim=80 if upstream == "fbank80" else 24,
            ckpt=str(tmp_path / "ckpt" / "train" / "last_ctc_dev.pth"))
    env = dict(os.environ, PYTHONPATH=ROOT, APC_CKPT=str(tmp_path /
                                                         "apc.npz"))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO_JAX_OK" in res.stdout
    for split in ("dev", "test"):
        rows = (tmp_path / "out" / "test_sd0_{}_output.csv".format(
            split)).read_text().splitlines()
        assert rows[0] == "idx\thyp\ttruth" and len(rows) == 3


def test_train_apc_cli_writes_a_checkpoint_jax_loads(tmp_path):
    from e2e_asr_pytorch_tpu_torch import train_apc
    out = str(tmp_path / "apc.npz")
    params, spec = train_apc.main([
        "--corpus", "synthetic", "--out", out, "--steps", "2", "--batch",
        "2", "--seconds", "0.5", "--hidden", "16", "--layers", "2",
        "--n-utts", "4", "--cpu"])
    jp, jspec = JA.load_apc(out)
    assert tuple(jspec) == tuple(spec) == (80, 16, 2, 3, 0.0)
    np.testing.assert_array_equal(np.asarray(jp["head"]["w"]),
                                  params["head"]["w"].numpy())

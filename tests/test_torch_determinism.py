"""One seed, one result: the port's training is bit-reproducible, and a
one-rank mesh computes what the plain path computes, bit for bit.

* The one-rank gloo mesh (``--n-devices 1``) against the plain path
  through the CLI, ASR and LM, at bf16 compute (``--amp``) and at f32:
  every parameter leaf and every step loss bitwise. Gradient clipping is
  active in these runs, as it is in the flagship's first steps.
* The loss reductions (``ops/losses.py``) at bf16 against the JAX
  functions on the same numpy inputs, and through a one-rank mesh's
  ``global_sum`` bit for bit the plain path's; the denominator summed into
  f32 (what ``global_sum`` returned before) changes the loss's dtype and
  its gradient's bits.
* The two ops whose gradients were sums in no fixed order: the CTC loss's
  read of the log-probs at the extended labels (``ops/ctc.py
  _EmitGather``) and the location conv's band (``ops/attention.py
  loc_band_matrix``); and the solvers' cuDNN settings.
* ``cuda``-marked twins (skipped without a card): every recurrence kernel
  relaunched on the same operands gives the same bits.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from e2e_asr_pytorch_tpu.ops import attention as JA
from e2e_asr_pytorch_tpu.ops import losses as JL
from e2e_asr_pytorch_tpu_torch import main as TMain
from e2e_asr_pytorch_tpu_torch.convert import tree_leaves
from e2e_asr_pytorch_tpu_torch.ops import attention as TA
from e2e_asr_pytorch_tpu_torch.ops import ctc as TC
from e2e_asr_pytorch_tpu_torch.ops import losses as TL
from e2e_asr_pytorch_tpu_torch.parallel import mesh as tmesh
from e2e_asr_pytorch_tpu_torch.utils.config import DEFAULT_HPARAS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the global gradient norm of these runs' first steps is 2-100: a clip of
# 0.5 keeps clip_by_global_norm active on every step
CLIP = 0.5


def _write(d):
    text = {"mode": "character",
            "vocab_file": os.path.join(ROOT, "corpus", "librispeech_char.txt")}
    corpus = {"name": "synthetic", "path": "", "batch_size": 4, "n_utts": 12,
              "max_tokens": 6}
    audio = {"feat_type": "fbank", "feat_dim": 40, "apply_cmvn": False,
             "delta_order": 2, "frame_length": 25, "frame_shift": 10,
             "ref_level_db": 20, "min_level_db": -100,
             "preemphasis_coeff": 0.97, "augment": True, "time_aug": False}
    model = dict(
        ctc_weight=0.5,
        encoder=dict(vgg=5, vgg_freq=-1, vgg_low_filt=-1, module="LSTM",
                     bidirection=True, dim=[16], dropout=[0.3],
                     layer_norm=[False], proj=[True], sample_rate=[1],
                     sample_style="drop"),
        attention=dict(mode="loc", dim=8, num_head=1, v_proj=False,
                       temperature=0.5, loc_kernel_size=20, loc_kernel_num=4),
        decoder=dict(module="LSTM", dim=16, layer=2, dropout=0))
    train = {"data": {"corpus": dict(corpus, train_split=["train"],
                                     dev_split=["dev"], bucketing=True),
                      "audio": audio, "text": text},
             "hparas": {"valid_step": 3, "max_step": 3, "tf_start": 1.0,
                        "tf_end": 1.0, "tf_step": 10,
                        "optimizer": "Adadelta", "lr": 1.0, "eps": 1e-8,
                        "lr_scheduler": "fixed", "curriculum": 0,
                        "val_mode": "cer", "early_stopping": False,
                        "label_smoothing": True,
                        "optim_state_dtype": "bfloat16"},
             "model": model}
    lm = {"data": {"corpus": {"name": "synthetic", "path": "",
                              "train_split": ["lm-train"],
                              "dev_split": ["lm-dev"], "bucketing": True,
                              "batch_size": 4, "n_sents": 12,
                              "max_tokens": 12},
                   "text": text},
          "hparas": {"valid_step": 3, "max_step": 3, "optimizer": "Adam",
                     "lr": 1e-3, "eps": 1e-8, "lr_scheduler": "fixed"},
          "model": {"emb_tying": True, "emb_dim": 16, "module": "LSTM",
                    "dim": 16, "n_layers": 2, "dropout": 0.3}}
    for name, cfg in (("asr", train), ("lm", lm)):
        with open(os.path.join(d, name + ".yaml"), "w") as f:
            yaml.safe_dump(cfg, f)


def _run(d, task, name, amp, *extra):
    """A 3-step run through the CLI in this process, on one thread: the
    thread count a one-rank mesh sets when one core is visible (``one_core``),
    so the two paths differ only by the mesh."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return TMain.main(
            ["--config", os.path.join(d, task + ".yaml"), "--name", name,
             "--cpu", "--njobs", "0", "--no-msg", "--logdir",
             os.path.join(d, "log"), "--ckpdir", os.path.join(d, "ckpt")]
            + (["--lm"] if task == "lm" else [])
            + (["--amp"] if amp else []) + list(extra))
    finally:
        torch.set_num_threads(threads)


def _losses(solver):
    return [st["total"] if "total" in st else st["loss"]
            for st in solver.step_stats]


@pytest.fixture
def clipped(monkeypatch):
    monkeypatch.setitem(DEFAULT_HPARAS, "GRAD_CLIP", CLIP)


@pytest.fixture
def one_core(monkeypatch):
    """One visible core: a one-rank gloo mesh then runs one thread (it
    takes the visible cores / the ranks), as ``_run`` does."""
    monkeypatch.setattr(tmesh, "visible_devices", lambda cpu: 1)


@pytest.mark.parametrize("amp", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("task", ["asr", "lm"])
def test_one_rank_mesh_matches_the_plain_path_bitwise(tmp_path, clipped,
                                                      one_core, task, amp):
    d = str(tmp_path)
    _write(d)
    plain = _run(d, task, "plain", amp)
    ranked = _run(d, task, "mesh", amp, "--n-devices", "1")
    assert ranked.mesh is not None and tmesh.current() is None
    assert plain.compute_dtype == (torch.bfloat16 if amp else torch.float32)
    gnorms = [st["gnorm"] for st in plain.step_stats]
    assert len(gnorms) == 3 and min(gnorms) > CLIP
    assert _losses(plain) == _losses(ranked)
    a, b = tree_leaves(plain.params), tree_leaves(ranked.params)
    assert len(a) == len(b)
    off = [i for i, (x, y) in enumerate(zip(a, b)) if not torch.equal(x, y)]
    assert not off


@pytest.mark.parametrize("task", ["asr", "lm"])
def test_a_run_repeats_bitwise(tmp_path, clipped, task):
    d = str(tmp_path)
    _write(d)
    first = _run(d, task, "one", True)
    again = _run(d, task, "two", True)
    assert _losses(first) == _losses(again)
    assert all(torch.equal(x, y) for x, y in zip(
        tree_leaves(first.params), tree_leaves(again.params)))


# ----------------------------------------------------------- loss reductions
V, B, T = 31, 4, 9


def _loss_inputs(seed=0):
    rng = np.random.default_rng(seed)
    logits = (3.0 * rng.standard_normal((B, T, V))).astype(np.float32)
    targets = rng.integers(1, V, size=(B, T))
    targets[:, 6:] = 0                       # padding positions
    targets[1, 4:] = 0
    utt_w = np.array([1.0, 1.0, 1.0, 0.0], np.float32)
    return logits, targets, utt_w


# name -> (port call, JAX call), each (logits, targets, utt_w, **kw)
LOSSES = {
    "label_smoothing": (
        lambda x, t, w, **kw: TL.label_smoothing_loss(x, t, V, 0.1, **kw),
        lambda x, t, w: JL.label_smoothing_loss(x, t, V, 0.1)),
    "label_smoothing_mask_pad": (
        lambda x, t, w, **kw: TL.label_smoothing_loss(x, t, V, 0.1,
                                                      mask_pad=True, **kw),
        lambda x, t, w: JL.label_smoothing_loss(x, t, V, 0.1, mask_pad=True)),
    "label_smoothing_utt_w": (
        lambda x, t, w, **kw: TL.label_smoothing_loss(x, t, V, 0.1,
                                                      utt_w=w, **kw),
        lambda x, t, w: JL.label_smoothing_loss(x, t, V, 0.1, utt_w=w)),
    "cross_entropy": (
        lambda x, t, w, **kw: TL.cross_entropy_loss(x, t, **kw),
        lambda x, t, w: JL.cross_entropy_loss(x, t)),
    "cross_entropy_utt_w": (
        lambda x, t, w, **kw: TL.cross_entropy_loss(x, t, utt_w=w, **kw),
        lambda x, t, w: JL.cross_entropy_loss(x, t, utt_w=w)),
    "nll_utt_w": (
        lambda x, t, w, **kw: TL.nll_loss(x, t, utt_w=w, **kw),
        lambda x, t, w: JL.nll_loss(x, t, utt_w=w)),
}


def _inputs_of(name, logits):
    """The losses' input: logits, or for the NLL their f32 log-softmax."""
    if not name.startswith("nll"):
        return logits
    m = logits.max(-1, keepdims=True)
    z = logits - m
    return (z - np.log(np.exp(z).sum(-1, keepdims=True))).astype(np.float32)


def _port_loss(name, logits, targets, utt_w, **kw):
    x = torch.from_numpy(_inputs_of(name, logits)).to(
        torch.bfloat16).requires_grad_()
    with torch.enable_grad():
        loss = LOSSES[name][0](x, torch.from_numpy(targets),
                               torch.from_numpy(utt_w), **kw)
        grad, = torch.autograd.grad(loss, x)
    return loss.detach(), grad


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_reductions_match_jax_at_bf16(name):
    logits, targets, utt_w = _loss_inputs()
    loss, _ = _port_loss(name, logits, targets, utt_w)
    want = LOSSES[name][1](jnp.asarray(_inputs_of(name, logits),
                                       jnp.bfloat16),
                           jnp.asarray(targets), jnp.asarray(utt_w))
    assert loss.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # the same dtype; the value within two bf16 units in the last place of
    # the JAX one: torch rounds the log-softmax once from f32, JAX rounds
    # each of its bf16 steps, so the positions' values already differ by
    # a rounding (the means of these inputs are 0-1 unit apart)
    assert abs(float(loss) - float(want)) <= 2.0 ** -6 * abs(float(want))


@pytest.fixture
def one_rank(one_core):
    """A one-rank gloo mesh in this process (its thread count restored)."""
    threads = torch.get_num_threads()
    mesh = tmesh.init(1, 1, 0, "tcp://localhost:{}".format(
        tmesh.free_port()), True)
    try:
        yield mesh
    finally:
        tmesh.shutdown()
        torch.set_num_threads(threads)


def _same_bits(a, b):
    """The same dtype and the same values (``torch.equal`` alone compares
    across dtypes)."""
    return a.dtype == b.dtype and torch.equal(a, b)


def _f32_global_sum(mesh):
    """The denominator summed into f32, as ``global_sum`` returned it
    before: a bf16 loss then came out f32."""
    def gsum(x):
        return mesh._sum_data(x.detach().float().clone())
    return gsum


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_one_rank_global_sum_keeps_the_loss_bits_at_bf16(one_rank, name):
    logits, targets, utt_w = _loss_inputs(1)
    plain = _port_loss(name, logits, targets, utt_w)
    ranked = _port_loss(name, logits, targets, utt_w,
                        global_sum=one_rank.global_sum)
    assert _same_bits(plain[0], ranked[0])
    assert _same_bits(plain[1], ranked[1])


WEIGHTED = [n for n in sorted(LOSSES) if n not in ("label_smoothing",)]


@pytest.mark.parametrize("name", WEIGHTED)
def test_the_f32_denominator_breaks_the_bits(one_rank, name):
    logits, targets, utt_w = _loss_inputs(1)
    plain = _port_loss(name, logits, targets, utt_w)
    ranked = _port_loss(name, logits, targets, utt_w,
                        global_sum=_f32_global_sum(one_rank))
    assert ranked[0].dtype == torch.float32
    assert not _same_bits(plain[0], ranked[0])


# ------------------------------------------- gradients summed in a fixed order
def test_ctc_emit_gather_is_gather_and_its_gradient_scatter_add():
    rng = np.random.default_rng(2)
    b, t, v, s = 3, 11, 7, 9
    lp = torch.from_numpy(rng.standard_normal((b, t, v)).astype(np.float32))
    ext = torch.from_numpy(rng.integers(0, v, size=(b, s)))
    ext[:, ::2] = 0                           # blanks at every other place
    g = torch.from_numpy(rng.standard_normal((b, t, s)).astype(np.float32))
    x = lp.clone().requires_grad_()
    out = TC._EmitGather.apply(x, ext)
    ref = torch.gather(lp, 2, ext[:, None, :].expand(b, t, s))
    assert torch.equal(out, ref)
    grad, = torch.autograd.grad(out, x, g)
    want = torch.zeros_like(lp).scatter_add_(
        2, ext[:, None, :].expand(b, t, s), g)
    np.testing.assert_allclose(grad.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_ctc_loss_gradient_repeats_bitwise():
    rng = np.random.default_rng(3)
    b, t, v, l = 4, 40, 9, 6
    logits = torch.from_numpy(rng.standard_normal((b, t, v)).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(1, v, size=(b, l)))
    label_len = torch.tensor([6, 4, 1, 0])
    input_len = torch.tensor([40, 33, 20, 9])
    grads = []
    for _ in range(3):
        x = logits.clone().requires_grad_()
        loss = TC.ctc_loss(torch.log_softmax(x, -1), input_len, labels,
                           label_len, utt_w=torch.ones(b))
        grads.append(torch.autograd.grad(loss, x)[0])
    assert all(torch.equal(grads[0], g) for g in grads[1:])


@pytest.mark.parametrize("kw,n,kn,t", [(100, 1, 10, 400), (20, 1, 4, 3),
                                       (5, 2, 3, 7), (101, 3, 2, 50)])
def test_loc_band_matches_jax_and_its_gradient_repeats(kw, n, kn, t):
    rng = np.random.default_rng(kw + t)
    w = rng.standard_normal((kw, n, kn)).astype(np.float32)
    band = TA.loc_band_matrix(torch.from_numpy(w), t)
    assert np.array_equal(band.numpy(),
                          np.asarray(JA.loc_band_matrix(jnp.asarray(w), t)))
    g = torch.from_numpy(rng.standard_normal(tuple(band.shape)).astype(
        np.float32))
    threads = torch.get_num_threads()
    torch.set_num_threads(tmesh.visible_devices(True))
    try:
        grads = []
        for _ in range(3):
            x = torch.from_numpy(w).requires_grad_()
            grads.append(torch.autograd.grad(TA.loc_band_matrix(x, t), x,
                                             g)[0])
    finally:
        torch.set_num_threads(threads)
    assert all(torch.equal(grads[0], x) for x in grads[1:])
    # the gradient is the band's entries summed onto their taps
    src = np.arange(t)[:, None]
    tap = src - np.arange(t)[None, :] + kw // 2
    gm = g.numpy().reshape(n, t, t, kn)
    want = np.zeros((kw, n, kn), np.float64)
    for k in range(kw):
        want[k] = gm[:, tap == k, :].sum(axis=1)
    np.testing.assert_allclose(grads[0].numpy(), want, rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("task", ["asr", "lm"])
def test_solvers_keep_cudnn_to_deterministic_algorithms(tmp_path,
                                                        monkeypatch, task):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    d = str(tmp_path)
    _write(d)
    TMain.build_solver(["--config", os.path.join(d, task + ".yaml"),
                        "--name", "pin", "--cpu", "--njobs", "0", "--no-msg",
                        "--logdir", os.path.join(d, "log"), "--ckpdir",
                        os.path.join(d, "ckpt")]
                       + (["--lm"] if task == "lm" else []))
    assert torch.backends.cudnn.deterministic is True
    assert torch.backends.cudnn.benchmark is False
    # nothing process-wide beyond that: ops keep their own implementations
    assert not torch.are_deterministic_algorithms_enabled()


# ------------------------------------------- the card: ops and kernels again
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a kernel relaunched on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_ctc_loss_gradient_repeats_bitwise_on_card(cuda):
    # the flagship's shapes: 16 utterances, 400 encoder frames, 80 labels
    # (161 extended positions, every other one <blank>) over 31 tokens;
    # gather's own backward (atomic adds) drifts here from call to call
    rng = np.random.default_rng(4)
    b, t, v, l = 16, 400, 31, 80
    logits = torch.from_numpy(rng.standard_normal((b, t, v)).astype(
        np.float32)).to(cuda)
    labels = torch.from_numpy(rng.integers(1, v, size=(b, l))).to(cuda)
    label_len = torch.from_numpy(rng.integers(40, l + 1, size=b)).to(cuda)
    input_len = torch.full((b,), t, device=cuda)
    grads = []
    for _ in range(4):
        x = logits.clone().requires_grad_()
        loss = TC.ctc_loss(torch.log_softmax(x, -1), input_len, labels,
                           label_len, utt_w=torch.ones(b, device=cuda))
        grads.append(torch.autograd.grad(loss, x)[0])
    assert all(torch.equal(grads[0], g) for g in grads[1:])


@pytest.mark.cuda
def test_vgg_frontend_gradient_repeats_bitwise_on_card(tmp_path, cuda):
    from e2e_asr_pytorch_tpu_torch.convert import tree_map
    from e2e_asr_pytorch_tpu_torch.models import frontend as TF
    d = str(tmp_path)
    _write(d)
    # a solver sets the process's cuDNN settings
    TMain.build_solver(["--config", os.path.join(d, "lm.yaml"), "--lm",
                        "--name", "pin", "--cpu", "--njobs", "0", "--no-msg",
                        "--logdir", os.path.join(d, "log"), "--ckpdir",
                        os.path.join(d, "ckpt")])
    # the flagship's frontend (vgg 5 over fbank 40 + deltas) at batch 16,
    # 16 s of frames, bf16 compute
    spec = TF.make_spec(5, 120)
    params = tree_map(lambda x: x.to(cuda),
                      TF.frontend_init(torch.Generator().manual_seed(0),
                                       spec))
    gen = torch.Generator().manual_seed(1)
    feat = torch.randn(16, 1600, 120, generator=gen).to(cuda)
    feat_len = torch.full((16,), 1600, device=cuda)
    dy = None
    grads = []
    for _ in range(4):
        leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
        out, _ = TF.frontend_apply(leaves, spec, feat, feat_len,
                                   torch.bfloat16)
        if dy is None:
            dy = torch.randn(out.shape, generator=gen).to(cuda)
        flat = tree_leaves(leaves)
        grads.append(torch.autograd.grad(out, flat, dy))
    assert all(torch.equal(a, b) for g in grads[1:]
               for a, b in zip(grads[0], g))


def _rand(gen, shape, dev, dtype=torch.float32, scale=1.0):
    return (scale * torch.randn(*shape, generator=gen)).to(dev, dtype)


def _lstm_launches(dev, name):
    from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as K
    from e2e_asr_pytorch_tpu_torch.ops.kernels import lstm as KL
    gen = torch.Generator().manual_seed(11)
    t, b, h = 40, 16, 256
    bf = torch.bfloat16
    if name.startswith(("K1", "K2")):
        form = name.split("-")[1]
        xg_f, xg_b = (_rand(gen, (t, b, 4 * h), dev, bf) for _ in range(2))
        wh_f, wh_b = (_rand(gen, (h, 4 * h), dev, scale=h ** -0.5)
                      for _ in range(2))
        if name.startswith("K1"):
            return lambda: K.bilstm_recurrence(xg_f, xg_b, wh_f, wh_b,
                                               stash=True, form=form)
        _, _, cs_f, cs_b, g_f, g_b = K.bilstm_recurrence(
            xg_f, xg_b, wh_f, wh_b, stash=True, form=form)
        dy_f, dy_b = (_rand(gen, (t, b, h), dev, bf) for _ in range(2))
        return lambda: K.bilstm_recurrence_bwd(wh_f, wh_b, cs_f, cs_b, g_f,
                                               g_b, dy_f, dy_b, form=form)
    chunked = name.startswith("K6")
    if chunked:
        t, b, h = 20, 64, 2048
    xg = _rand(gen, (t, b, 4 * h), dev, bf)
    w_h = _rand(gen, (h, 4 * h), dev, scale=h ** -0.5)
    dy = _rand(gen, (t, b, h), dev, bf)
    if name == "K6f":
        return lambda: KL.lstm_fwd_chunked(xg, w_h, stash=True)
    if name == "K6b":
        _, cs, gs = KL.lstm_fwd_chunked(xg, w_h, stash=True)
        return lambda: KL.lstm_bwd_chunked(w_h, cs, gs, dy)
    if name.startswith("K5f"):
        form = name.split("-")[1]
        return lambda: KL._launch_fwd(xg, w_h, False, True, form)
    _, cs, gs = KL._launch_fwd(xg, w_h, False, True,
                               KL.form_for(h, b, dev))
    return lambda: KL.lstm_bwd(w_h, cs, gs, dy, False)


def _gru_launches(dev, name):
    from e2e_asr_pytorch_tpu_torch.ops.kernels import gru as KG
    from e2e_asr_pytorch_tpu_torch.ops.kernels import ligru as KLG
    gen = torch.Generator().manual_seed(12)
    t, b, h = 40, 16, 256
    bf = torch.bfloat16
    gru = name.startswith("K7")
    K, gates = (KG, 3) if gru else (KLG, 2)
    form = name.split("-")[1]
    xg_f, xg_b = (_rand(gen, (t, b, gates * h), dev, bf) for _ in range(2))
    wh_f, wh_b = (_rand(gen, (h, gates * h), dev, scale=h ** -0.5)
                  for _ in range(2))
    dy_f, dy_b = (_rand(gen, (t, b, h), dev, bf) for _ in range(2))
    if gru:
        small = [_rand(gen, (gates * h,), dev, scale=0.3) for _ in range(2)]
    else:
        small = [((torch.rand(b, h, generator=gen) < 0.7).float() / 0.7
                  ).to(dev)]
    forward = name[2] == "f"
    if form == "packed":
        def fwd():
            return K._launch_fwd_pair(xg_f, xg_b, wh_f, wh_b, *small, True,
                                      "packed")
        if forward:
            return fwd
        ys_f, ys_b, hgs_f, hgs_b = fwd()
        mask = [] if gru else small
        return lambda: K._launch_bwd_pair(
            xg_f, xg_b, wh_f, wh_b, *mask, hgs_f, hgs_b,
            ys_f.to(bf), ys_b.to(bf), dy_f, dy_b, "packed")
    fwd_fn = KG.gru_fwd if gru else KLG.ligru_fwd
    if forward:
        return lambda: fwd_fn(xg_f, wh_f, small[0], False, stash=True)
    ys, hgs = fwd_fn(xg_f, wh_f, small[0], False, stash=True)
    if gru:
        return lambda: KG.gru_bwd(xg_f, wh_f, hgs, ys.to(bf), dy_f, False)
    return lambda: KLG.ligru_bwd(xg_f, wh_f, small[0], hgs, ys.to(bf), dy_f,
                                 False)


RELAUNCHED = ["K1-resident", "K1-streamed", "K2-resident", "K2-streamed",
              "K5f-narrow", "K5f-wide", "K5b", "K6f", "K6b",
              "K7f-packed", "K7f-single", "K7b-packed", "K7b-single",
              "K8f-packed", "K8f-single", "K8b-packed", "K8b-single"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", RELAUNCHED)
def test_recurrence_kernel_relaunch_gives_the_same_bits(cuda, name):
    launch = (_gru_launches if name.startswith(("K7", "K8"))
              else _lstm_launches)(cuda, name)

    def flat(x):
        return [o for o in (x if isinstance(x, (tuple, list)) else (x,))
                if o is not None]
    first = flat(launch())
    for _ in range(4):
        again = flat(launch())
        torch.cuda.synchronize()
        assert len(again) == len(first)
        assert all(torch.equal(a, b) for a, b in zip(first, again))

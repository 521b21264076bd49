"""The kernels at the shapes of the example recipes and the APC upstream,
and those modules on the card against the CPU (every test needs a CUDA
device and skips without one; ``chip_smoke.py`` phases 3 and 10 make the
same checks).

K1 / K2 (the direction-packed BLSTM forward and backward) at
config/libri/asr_example.yaml's listener (T=400 B=16 H=512, padded to 560
units) and the upstream recipe's (vgg 7 keeps every frame: T=1600 B=16
H=256, padded to 320); K5f / K5b at the APC stack's (T=200 B=8 H=512 with
the f32 gate stream the APC layers feed, and K5f at B=16 over T=1600).
Bounds as the kernels' other card tests: ys 1.6e-2 on bf16 streams and 2e-3
on f32, the mean |err| over the walk's first 4 steps 1e-6 (K1/K2) and 3e-6
(K5), dxg 2^-6 of its range. Planted fault: a doubled w_h at the padded
widths."""

import numpy as np
import pytest
import torch

from e2e_asr_pytorch_tpu_torch.convert import tree_to
from e2e_asr_pytorch_tpu_torch.models import apc as TA
from e2e_asr_pytorch_tpu_torch.models import frontend as TF
from e2e_asr_pytorch_tpu_torch.ops import audio as TAU
from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as K
from e2e_asr_pytorch_tpu_torch.ops.kernels import lstm as KL

YS_ATOL = {torch.float32: 2e-3, torch.bfloat16: 1.6e-2}
K1_EARLY, K5_EARLY, DXG_REL, STEPS = 1e-6, 3e-6, 2.0 ** -6, 4
BLSTM_SHAPES = [(400, 16, 512), (1600, 16, 256)]
K5_SHAPES = [(200, 8, 512), (1600, 16, 512)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel vs plain version)")
    return torch.device("cuda")


def _rand(shape, seed, scale=1.0):
    return torch.from_numpy((scale * np.random.default_rng(seed)
                             .standard_normal(shape)).astype(np.float32))


def _errs(out, ref, first_at_end=False):
    d = (out.float() - ref.float()).abs()
    k = min(STEPS, d.shape[0])
    early = d[d.shape[0] - k:] if first_at_end else d[:k]
    return d.max().item(), early.mean().item()


def _blstm(cuda, shape, wh_scale=1.0):
    t, b, h = shape
    xf, xb = (_rand((t, b, 4 * h), i).to(cuda, torch.bfloat16)
              for i in (1, 2))
    wf, wb = (_rand((h, 4 * h), i, h ** -0.5).to(cuda) for i in (3, 4))
    dyf, dyb = (_rand((t, b, h), i).to(cuda, torch.bfloat16) for i in (5, 6))
    before = (K.LAUNCHES, K.BWD_LAUNCHES)
    ys_f, ys_b, cf, cb, gf, gb = K.bilstm_recurrence(xf, xb, wf, wb,
                                                     stash=True)
    dxf, dxb = K.bilstm_recurrence_bwd(wf, wb, cf, cb, gf, gb, dyf, dyb)
    torch.cuda.synchronize()
    assert (K.LAUNCHES, K.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert K.form_for(h, cuda) == "resident"
    rf, rb = K.bilstm_recurrence_ref(xf, xb, wh_scale * wf, wb)
    rdf, rdb = K.bilstm_recurrence_bwd_ref(wh_scale * wf, wb, cf, cb, gf, gb,
                                           dyf, dyb)
    fwd = [_errs(ys_f, rf), _errs(ys_b, rb, True)]
    mag = max(rdf.float().abs().max().item(), rdb.float().abs().max().item())
    bwd = [_errs(dxf, rdf, True), _errs(dxb, rdb)]
    return (max(e[0] for e in fwd), max(e[1] for e in fwd),
            max(e[0] for e in bwd) / mag, max(e[1] for e in bwd))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BLSTM_SHAPES)
def test_k1_k2_at_the_recipes_listeners_on_card(cuda, shape):
    full, early, rel, b_early = _blstm(cuda, shape)
    assert full <= YS_ATOL[torch.bfloat16] and early <= K1_EARLY
    assert rel <= DXG_REL and b_early <= K1_EARLY


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BLSTM_SHAPES)
def test_k1_k2_vs_plain_fail_under_doubled_w_h(cuda, shape):
    full, early, rel, b_early = _blstm(cuda, shape, wh_scale=2.0)
    assert full > YS_ATOL[torch.bfloat16] or early > K1_EARLY
    assert rel > DXG_REL or b_early > K1_EARLY


def _k5(cuda, shape, wh_scale=1.0, backward=True):
    t, b, h = shape
    xg = _rand((t, b, 4 * h), 7).to(cuda)            # APC's f32 stream
    w_h = _rand((h, 4 * h), 8, h ** -0.5).to(cuda)
    assert KL.form_for(h, b, cuda) == "narrow"
    before = (KL.FWD_NARROW_LAUNCHES, KL.BWD_LAUNCHES)
    ys, cs, gs = KL.lstm_fwd(xg, w_h, stash=True)
    out = [_errs(ys, KL.lstm_recurrence_ref(xg, wh_scale * w_h))]
    if backward:
        dy = _rand((t, b, h), 9).to(cuda)
        dxg = KL.lstm_bwd(w_h, cs, gs, dy)
        ref = KL.lstm_recurrence_bwd_ref(wh_scale * w_h, cs, gs, dy)
        full, early = _errs(dxg, ref, True)
        out.append((full / ref.float().abs().max().item(), early))
    torch.cuda.synchronize()
    assert (KL.FWD_NARROW_LAUNCHES - before[0],
            KL.BWD_LAUNCHES - before[1]) == (1, int(backward))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", K5_SHAPES)
def test_k5_at_the_apc_stack_on_card(cuda, shape):
    res = _k5(cuda, shape, backward=shape[1] == 8)
    assert res[0][0] <= YS_ATOL[torch.float32] and res[0][1] <= K5_EARLY
    if len(res) > 1:
        assert res[1][0] <= DXG_REL and res[1][1] <= K5_EARLY


@pytest.mark.cuda
def test_k5_vs_plain_fails_under_doubled_w_h(cuda):
    (f_full, f_early), (b_rel, b_early) = _k5(cuda, K5_SHAPES[0], 2.0)
    assert f_full > YS_ATOL[torch.float32] or f_early > K5_EARLY
    assert b_rel > DXG_REL or b_early > K5_EARLY


@pytest.mark.cuda
def test_apc_on_card_matches_cpu(cuda):
    """The APC stack at bf16: K5 on the card, its plain versions on the CPU.
    The encode within the bf16 bound; under one fixed cotangent each
    layer's gradient leaf within 2^-6 of its range; the L1 loss within 1e-3
    of itself. (Its gradient is not compared: the card's and the CPU's
    bf16 head products round apart, and each flipped sign of pred - target
    moves the L1 gradient by a whole 1/N.)"""
    spec = TA.APCSpec(input_dim=80, hidden=512, n_layers=3)
    params = TA.apc_init(torch.Generator().manual_seed(0), spec)
    feat = _rand((8, 200, 80), 10)
    feat_len = torch.tensor([200, 190, 180, 170, 160, 150, 140, 130])
    cot = _rand((8, 200, 512), 11)
    res = {}
    for where in ("cpu", cuda):
        p = tree_to(params, where)
        loss = float(TA.apc_loss(p, spec, feat.to(where), feat_len.to(where),
                                 compute_dtype=torch.bfloat16))
        layers = [{k: v.clone().requires_grad_() for k, v in l.items()}
                  for l in p["layers"]]
        before = KL.FWD_LAUNCHES
        h = TA.apc_encode({"layers": layers}, spec, feat.to(where),
                          compute_dtype=torch.bfloat16)
        launches = KL.FWD_LAUNCHES - before
        grads = torch.autograd.grad((h * cot.to(where)).sum(), [
            v for l in layers for v in l.values()])
        res[str(where)] = (loss, h.detach().cpu(), [g.cpu() for g in grads],
                           launches)
    (lc, hc, gc, nc), (lg, hg, gg, ng) = res["cpu"], res[str(cuda)]
    assert (nc, ng) == (0, 3)
    assert (hc - hg).abs().max() <= YS_ATOL[torch.bfloat16]
    assert abs(lc - lg) <= 1e-3 * abs(lc)
    for a, b in zip(gc, gg):
        assert (a - b).abs().max() <= DXG_REL * a.abs().max()


@pytest.mark.cuda
def test_apc_at_f32_on_card_takes_k5(cuda):
    """A CUDA tensor at f32 (``apc_encode``'s default) goes through K5f and,
    under autograd, K5b, one launch a layer each, as at bf16; K5's h and
    w_h operands are bf16 whatever the dtype. The encode within the f32
    stream's 2e-3 of the CPU's plain f32 loop and each layer's gradient
    leaf within 2^-6 of its range (the CPU's plain versions at these
    operands: 3e-4 and at most 3e-3 of the range)."""
    spec = TA.APCSpec(input_dim=80, hidden=512, n_layers=3)
    params = TA.apc_init(torch.Generator().manual_seed(0), spec)
    feat = _rand((8, 200, 80), 10)
    cot = _rand((8, 200, 512), 11)
    res = {}
    for where in ("cpu", cuda):
        layers = [{k: v.clone().requires_grad_() for k, v in l.items()}
                  for l in tree_to(params, where)["layers"]]
        before = (KL.FWD_LAUNCHES, KL.BWD_LAUNCHES)
        h = TA.apc_encode({"layers": layers}, spec, feat.to(where))
        grads = torch.autograd.grad((h * cot.to(where)).sum(), [
            v for l in layers for v in l.values()])
        res[str(where)] = (h.detach().cpu(), [g.cpu() for g in grads],
                           (KL.FWD_LAUNCHES - before[0],
                            KL.BWD_LAUNCHES - before[1]))
    (hc, gc, nc), (hg, gg, ng) = res["cpu"], res[str(cuda)]
    assert hg.dtype == torch.float32
    assert (nc, ng) == ((0, 0), (3, 3))
    assert (hc - hg).abs().max() <= YS_ATOL[torch.float32]
    for a, b in zip(gc, gg):
        assert (a - b).abs().max() <= DXG_REL * a.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("vgg,kw", [(1, {}), (2, dict(vgg_freq=16,
                                                       vgg_low_filt=8)),
                                    (3, {}), (4, dict(vgg_freq=24,
                                                      vgg_low_filt=4)),
                                    (7, {})])
def test_frontends_on_card_match_cpu(cuda, vgg, kw):
    """cuDNN's f32 convs (TF32 off) against the CPU's, atol 1e-4 as the CPU
    parity tests."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = TF.make_spec(vgg, 120, **kw)
    p = TF.frontend_init(torch.Generator().manual_seed(vgg), spec)
    feat = _rand((4, 81, 120), vgg).abs()
    feat_len = torch.tensor([81, 70, 60, 41])
    y_cpu, l_cpu = TF.frontend_apply(p, spec, feat, feat_len)
    y_gpu, l_gpu = TF.frontend_apply(tree_to(p, cuda), spec, feat.to(cuda),
                                     feat_len.to(cuda))
    assert torch.equal(l_cpu, l_gpu.cpu())
    assert (y_cpu - y_gpu.cpu()).abs().max() <= 1e-4


@pytest.mark.cuda
def test_feat_to_wave_on_card_matches_cpu(cuda):
    cfg = TAU.FeatureConfig(feat_dim=80)
    t = torch.arange(16000) / 16000
    wav = (0.5 * torch.sin(2 * np.pi * 440 * t))[None]
    feat, feat_len = TAU.extract_features(cfg, wav, torch.tensor([16000]))
    feat = feat[0, :int(feat_len[0])]
    phase = torch.rand(feat.shape[0], 513,
                       generator=torch.Generator().manual_seed(0)) * 6.2832
    a, _ = TAU.feat_to_wave(cfg, feat, n_iter=8, phase=phase)
    b, _ = TAU.feat_to_wave(cfg, feat.to(cuda), n_iter=8,
                            phase=phase.to(cuda))
    assert (a - b.cpu()).abs().max() <= 1e-4

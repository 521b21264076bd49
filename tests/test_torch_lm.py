"""The LM-training slice of the port against the JAX package: the stacked
LSTM and ``lm_apply`` on both routes, Adam against optax, the whole LM step
against ``train_lm.Solver``'s, and the CLI.

Routes. A stateless call takes the kernel route on both sides (the JAX
package forced onto its Pallas kernels in interpret mode, the port onto its
plain versions because the tensors lie on the CPU): the recurrent product
takes bf16 operands on both, so f32 results agree to 1e-4 through 2 layers
(f32 sums in another order, a rare flipped bf16 rounding of h). A stateful
call takes the loop on both sides, all f32: 1e-5.
"""

import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from e2e_asr_pytorch_tpu.models import lm as JLM
from e2e_asr_pytorch_tpu.ops import losses as JL
from e2e_asr_pytorch_tpu.ops import rnn as JR
from e2e_asr_pytorch_tpu.ops.pallas import lstm as PL
from e2e_asr_pytorch_tpu.train import optim as JO
from e2e_asr_pytorch_tpu.utils.config import Paras
from e2e_asr_pytorch_tpu_torch import convert
from e2e_asr_pytorch_tpu_torch.models import lm as TLM
from e2e_asr_pytorch_tpu_torch.ops import rnn as TR
from e2e_asr_pytorch_tpu_torch.ops.kernels import lstm as K
from e2e_asr_pytorch_tpu_torch.train import checkpoint as ckpt_lib
from e2e_asr_pytorch_tpu_torch.train import optim as TO
from e2e_asr_pytorch_tpu_torch.train import train_lm as TT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_ATOL = 1e-4
LOOP_ATOL = 1e-5


@pytest.fixture
def jax_kernel(monkeypatch):
    """Route the JAX package through its Pallas K5 in interpret mode."""
    monkeypatch.setenv("E2E_ASR_PALLAS", "force")
    monkeypatch.setattr(PL, "INTERPRET", True)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(a))), 1e-30))


def _stack_params(d, h, n_layers, seed):
    rng = np.random.default_rng(seed)
    layers = []
    for _ in range(n_layers):
        layers.append({
            "w_x": (rng.standard_normal((d, 4 * h)) / np.sqrt(d)
                    ).astype(np.float32),
            "w_h": (rng.standard_normal((h, 4 * h)) / np.sqrt(h)
                    ).astype(np.float32),
            "b": (0.1 * rng.standard_normal(4 * h)).astype(np.float32)})
        d = h
    return layers


# ------------------------------------------------------- stacked_sequence
def _stacked_both(stateful, train, wh_scale=1.0):
    layers = _stack_params(12, 32, 2, seed=3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 9, 12)).astype(np.float32)         # B,T,D
    state = None
    if stateful:
        state = tuple(rng.standard_normal((2, 3, 32)).astype(np.float32)
                      for _ in range(2))
    jy, jstate = JR.stacked_sequence(
        jax.tree.map(jnp.asarray, layers), "LSTM", jnp.asarray(x),
        None if state is None else tuple(jnp.asarray(s) for s in state),
        dropout=0.0, rng=jax.random.PRNGKey(0), train=train)
    tl = convert.from_jax_params(layers)
    tl[0]["w_h"] = tl[0]["w_h"] * wh_scale
    ty, tstate = TR.stacked_sequence(
        tl, "LSTM", torch.from_numpy(x),
        None if state is None else tuple(torch.from_numpy(s) for s in state),
        dropout=0.0, gen=torch.Generator().manual_seed(0), train=train)
    assert tuple(ty.shape) == jy.shape == (3, 9, 32)
    err = float(np.max(np.abs(np.asarray(jy) - ty.numpy())))
    if stateful:
        for j, t in zip(jstate, tstate):
            err = max(err, float(np.max(np.abs(np.asarray(j) - t.numpy()))))
    else:
        # the kernel route returns no state on either side
        assert jstate is None and tstate is None
    return err


@pytest.mark.parametrize("train", [False, True])
def test_stacked_sequence_kernel_route_matches_jax(jax_kernel, train):
    assert _stacked_both(False, train) <= KERNEL_ATOL


@pytest.mark.parametrize("train", [False, True])
def test_stacked_sequence_loop_route_matches_jax(train):
    assert _stacked_both(True, train) <= LOOP_ATOL


@pytest.mark.parametrize("stateful", [False, True])
def test_stacked_sequence_fails_under_doubled_w_h(jax_kernel, stateful):
    assert _stacked_both(stateful, False, wh_scale=2.0) > 100 * KERNEL_ATOL


def test_stacked_sequence_kernel_route_counts_no_launch_on_cpu():
    before = (K.FWD_LAUNCHES, K.FWD_CHUNKED_LAUNCHES)
    layers = convert.from_jax_params(_stack_params(8, 16, 2, seed=0))
    y, state = TR.stacked_sequence(layers, "LSTM", torch.zeros(2, 5, 8))
    assert state is None and tuple(y.shape) == (2, 5, 16)
    assert before == (K.FWD_LAUNCHES, K.FWD_CHUNKED_LAUNCHES)


def test_lstm_layer_kernel_reverse_flips_around_the_chunked_route(
        monkeypatch):
    """Where w_h is not resident the reversed layer flips its stream around
    the forward-only chunked recurrence, and gives what the resident one
    gives by indexing."""
    p = convert.from_jax_params(_stack_params(8, 16, 1, seed=6))[0]
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 6, 8)).astype(np.float32))
    resident = TR.lstm_layer_kernel(p, x, reverse=True)
    monkeypatch.setattr(TR.KL, "fits_resident", lambda h, dev=None: False)
    chunked = TR.lstm_layer_kernel(p, x, reverse=True)
    loop, _ = TR.lstm_layer(p, x, reverse=True)
    assert float((resident - chunked).abs().max()) <= 1e-6
    # the loop takes f32 operands, the kernel route bf16 ones
    assert float((resident - loop).abs().max()) <= 1e-2


# ---------------------------------------------------------------- lm_apply
LM_MODEL = dict(emb_tying=True, emb_dim=32, module="LSTM", dim=32,
                n_layers=2, dropout=0.0)


def _lm_both(train, stateful=False, emb_scale=1.0):
    jspec = JLM.build_spec(31, **LM_MODEL)
    tspec = TLM.build_spec(31, **LM_MODEL)
    jp = JLM.lm_init(jax.random.PRNGKey(5), jspec)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    tp["emb"] = tp["emb"] * emb_scale
    tok = np.random.default_rng(8).integers(0, 31, (3, 10)).astype(np.int32)
    jh = JLM.lm_zero_state(jspec, 3) if stateful else None
    th = TLM.lm_zero_state(tspec, 3) if stateful else None
    jl, _ = JLM.lm_apply(jp, jspec, jnp.asarray(tok), jh,
                         rng=jax.random.PRNGKey(1), train=train)
    tl, _ = TLM.lm_apply(tp, tspec, torch.from_numpy(tok).long(), th,
                         gen=torch.Generator().manual_seed(1), train=train)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (3, 10, 31)
    return float(np.max(np.abs(np.asarray(jl) - tl.numpy())))


@pytest.mark.parametrize("train", [False, True])
def test_lm_apply_kernel_route_matches_jax(jax_kernel, train):
    # logits are sums of 32 products of O(1) embeddings: atol 5e-4
    assert _lm_both(train) <= 5 * KERNEL_ATOL


def test_lm_apply_loop_route_matches_jax():
    assert _lm_both(False, stateful=True) <= 5 * LOOP_ATOL


def test_lm_apply_fails_under_doubled_embedding(jax_kernel):
    assert _lm_both(False, emb_scale=2.0) > 100 * KERNEL_ATOL


def test_lm_apply_equals_lm_step_unrolled():
    """The stateful (loop) route is the single-token step unrolled, exactly
    the same f32 ops; the stateless (kernel) route rounds the recurrent
    operands to bf16, so it agrees to 2e-2 on O(1)-O(10) logits."""
    spec = TLM.build_spec(31, **LM_MODEL)
    params = TLM.lm_init(torch.Generator().manual_seed(2), spec)
    tok = torch.from_numpy(np.random.default_rng(9).integers(0, 31, (2, 8)))
    hidden, steps = TLM.lm_zero_state(spec, 2), []
    for i in range(8):
        logit, hidden = TLM.lm_step(params, spec, tok[:, i], hidden)
        steps.append(logit)
    steps = torch.stack(steps, dim=1)
    loop, final = TLM.lm_apply(params, spec, tok, TLM.lm_zero_state(spec, 2))
    assert float((loop - steps).abs().max()) <= 1e-5
    assert float((final[0] - hidden[0]).abs().max()) <= 1e-6
    kernel, none = TLM.lm_apply(params, spec, tok)
    assert none is None
    assert float((kernel - steps).abs().max()) <= 2e-2
    assert float((kernel - 2 * steps).abs().max()) > 1.0


def test_lm_dropouts_draw_from_the_generator():
    spec = TLM.build_spec(31, **dict(LM_MODEL, dropout=0.5))
    params = TLM.lm_init(torch.Generator().manual_seed(2), spec)
    tok = torch.from_numpy(np.random.default_rng(9).integers(0, 31, (2, 8)))
    a, _ = TLM.lm_apply(params, spec, tok, train=True,
                        gen=torch.Generator().manual_seed(3))
    b, _ = TLM.lm_apply(params, spec, tok, train=True,
                        gen=torch.Generator().manual_seed(3))
    c, _ = TLM.lm_apply(params, spec, tok, train=True,
                        gen=torch.Generator().manual_seed(4))
    d, _ = TLM.lm_apply(params, spec, tok, train=False,
                        gen=torch.Generator().manual_seed(3))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, d)


# -------------------------------------------------------------------- Adam
# Both sides start from the same non-zero JAX state and take 3 updates on the
# same gradients, one of them clipped and one non-finite (skipped whole).
# Parameters: rel 1e-6 (the same f32 ops, the global norm summed in another
# order); bf16 moments: equal up to one bf16 ulp (rel 2^-7); the count: equal.
OPT_REL = 1e-6


def _opt_params(rng):
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32),
                  "d": [rng.standard_normal((2, 2)).astype(np.float32)]}}


def _grads(rng, kind):
    g = _opt_params(rng)
    scale = {"small": 0.1, "big": 10.0, "nan": 1.0}[kind]
    g = jax.tree.map(lambda x: x * scale, g)
    if kind == "nan":
        g["b"]["c"][2] = np.nan
    return g


def _adam_both(state_dtype, lr_scale=1.0):
    rng = np.random.default_rng(15)
    hp = dict(optimizer="Adam", lr=1e-2, eps=1e-8, lr_scheduler="fixed",
              optim_state_dtype=state_dtype)
    tx, _ = JO.build_optimizer(grad_clip=5.0, **hp)
    params = _opt_params(rng)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    for _ in range(2):                        # a non-zero starting state
        up, state = tx.update(jax.tree.map(jnp.asarray, _grads(rng, "small")),
                              state, jp)
        jp = optax.apply_updates(jp, up)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    tstate = convert.from_jax_opt_state(jax.tree.map(np.asarray, state))
    want = torch.bfloat16 if state_dtype else torch.float32
    assert sorted(tstate) == ["count", "mu", "nu"]
    assert tstate["mu"]["a"].dtype == want
    opt = TO.build_optimizer(grad_clip=5.0, **dict(hp, lr=1e-2 * lr_scale))
    assert isinstance(opt, TO.Adam)
    worst = 0.0
    for kind in ("big", "nan", "small"):
        g = _grads(rng, kind)
        jnorm = float(JO.global_norm(jax.tree.map(jnp.asarray, g)))
        up, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, up)
        tnorm = opt.step(tp, convert.from_jax_params(g), tstate)
        assert np.isnan(jnorm) == bool(torch.isnan(tnorm))
        if kind != "nan":
            assert abs(float(tnorm) - jnorm) <= 1e-6 * jnorm
        jstate = convert.from_jax_opt_state(jax.tree.map(np.asarray, state))
        assert int(jstate["count"]) == int(tstate["count"])
        for j, t in zip(convert.tree_leaves(jax.tree.map(np.asarray, jp)),
                        convert.tree_leaves(tp)):
            worst = max(worst, _rel(j, t))
        for tree in ("mu", "nu"):
            for j, t in zip(convert.tree_leaves(jstate[tree]),
                            convert.tree_leaves(tstate[tree])):
                assert t.dtype == want
                assert _rel(j.float(), t.float()) <= (
                    2.0 ** -7 if state_dtype else OPT_REL)
    return worst, int(tstate["count"])


@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
def test_adam_matches_optax(state_dtype):
    worst, count = _adam_both(state_dtype)
    assert worst <= OPT_REL
    assert count == 4  # 2 warm-up updates + 2 taken; the non-finite skipped


def test_adam_vs_optax_fails_under_doubled_lr():
    assert _adam_both(None, lr_scale=2.0)[0] > 100 * OPT_REL


def test_init_states_of_a_fresh_optimizer_agree():
    params = _opt_params(np.random.default_rng(0))
    tx, _ = JO.build_optimizer(optimizer="Adam", lr=1e-3, grad_clip=5.0)
    jstate = convert.from_jax_opt_state(jax.tree.map(
        np.asarray, tx.init(jax.tree.map(jnp.asarray, params))))
    tstate = TO.Adam().init(convert.from_jax_params(params))
    assert int(jstate["count"]) == int(tstate["count"]) == 0
    for tree in ("mu", "nu"):
        for j, t in zip(convert.tree_leaves(jstate[tree]),
                        convert.tree_leaves(tstate[tree])):
            assert torch.equal(j, t)


@pytest.mark.parametrize("name", ["AdamW", "SGD", "RMSprop"])
def test_unported_optimizers_still_raise(name):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TO.build_optimizer(optimizer=name)


# ------------------------------------------------------- the slice whole
# Two train steps of config/synthetic_lm.yaml's model (tied 64, 2x LSTM-64)
# with dropout 0, f32 compute, from the JAX solver's own seeded parameters
# and Adam state, on the solver's own first two batches. Both sides take the
# kernel route (bf16 recurrent operands). Each gradient leaf: max |err| <=
# 2e-3 of the leaf's range (f32 sums in other orders over bf16-rounded
# operands); the grad norm 1e-4. Adam's first updates are +-lr whatever the
# gradient's size, so an element whose gradient is at noise level moves by a
# whole lr one way or the other: the parameter change after two updates is
# held leaf by leaf in the L2 norm, |err|_2 <= 5e-2 * |change|_2 (a doubled
# lr gives 1.0), and the second step's loss, taken after such an update, to
# 1e-4.
LM_STEP = {"loss": 1e-4, "leaf": 2e-3, "gnorm": 1e-4, "change_l2": 5e-2}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _jax_lm_solver(tmp_path):
    from e2e_asr_pytorch_tpu.train.train_lm import Solver
    with open(os.path.join(ROOT, "config", "synthetic_lm.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["model"]["dropout"] = 0.0
    cfg["data"]["text"]["vocab_file"] = os.path.join(
        ROOT, cfg["data"]["text"]["vocab_file"])
    paras = Paras(config="synthetic_lm.yaml", name="lm",
                  logdir=str(tmp_path / "log"), ckpdir=str(tmp_path / "ckpt"),
                  outdir=str(tmp_path / "out"), njobs=0, cpu=True,
                  verbose=False)
    solver = Solver(cfg, paras, "train")
    solver.load_data()
    solver.set_model()
    return solver, cfg


def _lm_step_both(tmp_path, lr_scale=1.0):
    solver, cfg = _jax_lm_solver(tmp_path)
    spec = solver.lm_spec
    batches = [np.asarray(b["txt"]) for b, _ in zip(iter(solver.tr_set),
                                                    range(2))]
    tp = convert.from_jax_params(jax.tree.map(np.asarray, solver.params))
    p0 = convert.tree_map(lambda x: x.clone(), tp)
    tstate = convert.from_jax_opt_state(jax.tree.map(np.asarray,
                                                     solver.opt_state))
    tspec = TLM.build_spec(solver.vocab_size, **cfg["model"])
    hp = dict(cfg["hparas"], lr=cfg["hparas"]["lr"] * lr_scale)
    cfg_t = TT.StepConfig(tspec, TO.build_optimizer(grad_clip=5.0, **hp))
    gen = torch.Generator().manual_seed(0)

    def jax_grads(params, txt):
        inp, tgt = solver._shift_inputs(txt)
        return jax.grad(lambda p: JL.cross_entropy_loss(JLM.lm_apply(
            p, spec, inp, rng=jax.random.PRNGKey(0), train=True)[0],
            tgt))(params)

    out = {"loss": 0.0, "grad": 0.0, "gnorm": 0.0}
    jp, jstate = solver.params, solver.opt_state
    for i, txt in enumerate(batches):
        jtxt = jnp.asarray(txt)
        if i == 0:
            jg = jax.tree.map(np.asarray, jax_grads(jp, jtxt))
            _, tg = TT.loss_and_grads(cfg_t, tp, torch.from_numpy(txt).long(),
                                      gen)
            for j, t in zip(convert.tree_leaves(jg),
                            convert.tree_leaves(tg)):
                out["grad"] = max(out["grad"], _rel(j, t.numpy()))
        jp, jstate, jloss, jnorm = solver._train_step(
            jp, jstate, jtxt, jax.random.PRNGKey(i))
        _, _, tloss, tnorm = TT.train_step(
            cfg_t, tp, tstate, torch.from_numpy(txt).long(), gen)
        out["loss"] = max(out["loss"], abs(float(jloss) - float(tloss)))
        out["gnorm"] = max(out["gnorm"],
                           abs(float(jnorm) - float(tnorm)) / float(jnorm))
    jp = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    out["param"] = max(
        _rel_l2((j - a).numpy(), (t - a).numpy())
        for j, t, a in zip(convert.tree_leaves(jp), convert.tree_leaves(tp),
                           convert.tree_leaves(p0)))
    assert int(tstate["count"]) == 2
    return out


def test_lm_step_matches_jax_solver(jax_kernel, tmp_path):
    out = _lm_step_both(tmp_path)
    assert out["loss"] <= LM_STEP["loss"], out
    assert out["grad"] <= LM_STEP["leaf"], out
    assert out["gnorm"] <= LM_STEP["gnorm"], out
    assert out["param"] <= LM_STEP["change_l2"], out


def test_lm_step_vs_jax_fails_under_doubled_lr(jax_kernel, tmp_path):
    out = _lm_step_both(tmp_path, lr_scale=2.0)
    assert out["param"] > 10 * LM_STEP["change_l2"], out
    assert out["loss"] > 100 * LM_STEP["loss"], out


def test_shift_inputs_and_masked_loss_match_jax():
    from e2e_asr_pytorch_tpu.train.train_lm import Solver as JSolver
    from e2e_asr_pytorch_tpu_torch.ops import losses as TL
    rng = np.random.default_rng(3)
    txt = rng.integers(1, 31, (4, 9)).astype(np.int32)
    txt[1, 5:] = 0
    txt[3, 2:] = 0
    jin, jtgt = JSolver._shift_inputs(jnp.asarray(txt))
    tin, ttgt = TT.Solver._shift_inputs(torch.from_numpy(txt).long())
    assert np.array_equal(np.asarray(jin), tin.numpy())
    assert np.array_equal(np.asarray(jtgt), ttgt.numpy())
    logits = rng.standard_normal((4, 9, 31)).astype(np.float32)
    jl = float(JL.cross_entropy_loss(jnp.asarray(logits), jtgt))
    tl = float(TL.cross_entropy_loss(torch.from_numpy(logits), ttgt))
    assert abs(jl - tl) <= 1e-6 * abs(jl)
    # pads carry no weight: changing their logits changes nothing
    logits[1, 5:] += 3.0
    assert float(TL.cross_entropy_loss(torch.from_numpy(logits),
                                       ttgt)) == pytest.approx(tl, rel=1e-6)


# ---------------------------------------------------------------- the CLI
def _lm_config(tmp_path, steps, valid):
    with open(os.path.join(ROOT, "config", "synthetic_lm.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["data"]["text"]["vocab_file"] = os.path.join(
        ROOT, cfg["data"]["text"]["vocab_file"])
    cfg["hparas"].update(max_step=steps, valid_step=valid)
    path = str(tmp_path / "synthetic_lm.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, cfg


def _lm_argv(tmp_path, path):
    return ["--lm", "--cpu", "--config", path, "--name", "lm", "--njobs", "0",
            "--logdir", str(tmp_path / "log"), "--ckpdir",
            str(tmp_path / "ckpt"), "--no-msg"]


def test_cli_trains_lm_validates_resumes_and_feeds_the_decoder(tmp_path):
    from e2e_asr_pytorch_tpu_torch.main import main
    path, cfg = _lm_config(tmp_path, steps=6, valid=3)
    solver = main(_lm_argv(tmp_path, path))
    assert solver.step == 6 and len(solver.step_stats) == 6
    assert all(np.isfinite(list(s.values())).all() for s in solver.step_stats)
    # validation at steps 3 and 6, over the dev iterator each time
    assert solver.n_valid_batches == 2 * len(solver.dv_set)
    assert np.isfinite(solver.best_ppx)
    ckpdir = tmp_path / "ckpt" / "lm"
    assert sorted(os.listdir(ckpdir)) == ["best_ppx.pth", "last_ppx.pth"]
    last = ckpt_lib.load_checkpoint(str(ckpdir / "last_ppx.pth"))
    assert last["global_step"] == 6 and last["metric_name"] == "ppx"
    assert int(last["optimizer"]["count"]) == 6
    assert sorted(last["optimizer"]) == ["count", "mu", "nu"]
    for a, b in zip(convert.tree_leaves(last["model"]),
                    convert.tree_leaves(solver.params)):
        assert torch.equal(a, b)

    # --load resumes at step 6 with the Adam state and goes on to step 8
    path8, _ = _lm_config(tmp_path, steps=8, valid=4)
    resumed = main(_lm_argv(tmp_path, path8)
                   + ["--load", str(ckpdir / "last_ppx.pth")])
    assert resumed.step == 8 and len(resumed.step_stats) == 2
    assert int(resumed.opt_state["count"]) == 8
    moved = sum(not torch.equal(a, b) for a, b in zip(
        convert.tree_leaves(last["model"]),
        convert.tree_leaves(resumed.params)))
    assert moved == len(convert.tree_leaves(last["model"]))

    # the checkpoint loads as the decode path's LM: same tree as lm_init's,
    # and lm_step runs on it
    spec = TLM.build_spec(solver.vocab_size, **cfg["model"])
    fresh = TLM.lm_init(torch.Generator().manual_seed(0), spec)
    lm = convert.cast_matmul_weights(last["model"], torch.float32)
    assert [tuple(x.shape) for x in convert.tree_leaves(lm)] == \
        [tuple(x.shape) for x in convert.tree_leaves(fresh)]
    logits, _ = TLM.lm_step(lm, spec, torch.zeros(2, dtype=torch.long),
                            TLM.lm_zero_state(spec, 2))
    assert tuple(logits.shape) == (2, solver.vocab_size)
    assert bool(torch.isfinite(logits).all())


def _train_tests():
    """test_torch_train.py beside this file (another package named ``tests``
    may come first on the path), for its spy on a solver's steps."""
    spec = importlib.util.spec_from_file_location(
        "_torch_train_shared", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "test_torch_train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_resumed_lm_run_draws_what_an_uninterrupted_run_draws(tmp_path,
                                                             monkeypatch):
    """A run resumed with --load at step 2 draws its dropout masks at steps
    2 and 3 from what a run of four steps draws there (the JAX LM solver
    keys each step on the step), not from the draws of steps 0 and 1."""
    from e2e_asr_pytorch_tpu_torch.main import main
    draws = _train_tests().record_step_draws(monkeypatch, TT)
    two, _ = _lm_config(tmp_path, steps=2, valid=2)
    main(_lm_argv(tmp_path, two))
    (tmp_path / "four").mkdir()
    four, _ = _lm_config(tmp_path / "four", steps=4, valid=4)
    main(_lm_argv(tmp_path, four) + ["--load", str(
        tmp_path / "ckpt" / "lm" / "last_ppx.pth")])
    whole = _lm_argv(tmp_path, four)
    main(whole[:whole.index("--name") + 1] + ["whole"]
         + whole[whole.index("--name") + 2:])
    first, resumed, whole = draws[:2], draws[2:4], draws[4:]
    assert len(whole) == 4
    for a, b in zip(first + resumed, whole):
        assert torch.equal(a, b)
    assert not torch.equal(whole[0], whole[2])


def test_cli_lm_refuses_to_start_without_cuda_or_cpu_flag(tmp_path):
    from e2e_asr_pytorch_tpu_torch.main import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    path, _ = _lm_config(tmp_path, steps=2, valid=2)
    argv = [a for a in _lm_argv(tmp_path, path) if a != "--cpu"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)


def test_cli_lm_runs_without_jax_or_the_jax_package(tmp_path):
    """``main --lm`` in a fresh interpreter: neither jax nor any module of
    the JAX package is imported."""
    path, _ = _lm_config(tmp_path, steps=2, valid=2)
    code = (
        "import sys\n"
        "from e2e_asr_pytorch_tpu_torch.main import main\n"
        "s = main(sys.argv[1:])\n"
        "assert s.step == 2, s.step\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m.startswith('jaxlib') or "
        "m == 'e2e_asr_pytorch_tpu' or "
        "m.startswith('e2e_asr_pytorch_tpu.'))\n"
        "assert not bad, bad[:5]\n"
        "print('NO_JAX_OK')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code]
                         + _lm_argv(tmp_path, path), cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0 and "NO_JAX_OK" in res.stdout, (
        res.stdout[-2000:], res.stderr[-2000:])

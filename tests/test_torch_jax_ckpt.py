"""Checkpoints the JAX package wrote, read by the port
(``train/checkpoint.py load_checkpoint``) with no msgpack, flax or jax.

The JAX side writes them with its own ``save_checkpoint`` (flax msgpack of
the state-dict form) over ``asr_init`` / ``lm_init`` parameters and
optimizer states filled from a seed: Adadelta with bf16 accumulators (the
flagship's), Adam, AdamW and RMSprop. Held:

  * every parameter and optimizer-state leaf equals, bit for bit, what
    ``convert.from_jax_params`` / ``from_jax_opt_state`` make of the live
    JAX trees (the VGG convs HWIO -> OIHW), also when flax chunked the
    arrays;
  * ``--test`` on the JAX file decodes the same greedy tokens as on a port
    checkpoint of the converted parameters;
  * the hand msgpack decoder gives what the ``msgpack`` package gives on
    seeded payloads of every type flax writes.

The twin leaves a conv weight in HWIO: the bitwise check must catch it.
"""

import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from e2e_asr_pytorch_tpu.models import asr as JM
from e2e_asr_pytorch_tpu.models import lm as JLM
from e2e_asr_pytorch_tpu.train import checkpoint as JC
from e2e_asr_pytorch_tpu.train import optim as JO
from e2e_asr_pytorch_tpu_torch import convert
from e2e_asr_pytorch_tpu_torch.models import asr as TM
from e2e_asr_pytorch_tpu_torch.models import lm as TLM
from e2e_asr_pytorch_tpu_torch.train import checkpoint as TC
from e2e_asr_pytorch_tpu_torch.train import optim as TO
from test_torch_train import TINY_MODEL, _write_configs

FEAT, VOCAB = 120, 31
LM_ARGS = (VOCAB, True, 24, "LSTM", 24, 2, 0.0)
OPTIMIZERS = {"Adadelta": dict(optimizer="Adadelta", lr=1.0,
                               optim_state_dtype="bfloat16"),
              "Adam": dict(optimizer="Adam", lr=1e-3),
              "AdamW": dict(optimizer="AdamW", lr=1e-3, weight_decay=0.01),
              "RMSprop": dict(optimizer="RMSprop", lr=1e-3)}


def _filled(state, seed):
    """The optimizer state with every float leaf drawn from ``seed`` (in
    its own dtype) and every count set to 7."""
    r = np.random.default_rng(seed)

    def fill(x):
        if jnp.issubdtype(x.dtype, jnp.floating):
            return jnp.asarray(r.standard_normal(x.shape),
                               jnp.float32).astype(x.dtype)
        return jnp.full(x.shape, 7, x.dtype)
    return jax.tree.map(fill, state)


def _write(path, model, hp, seed=0):
    """A JAX checkpoint of ``model`` ('asr' or 'lm') and a filled ``hp``
    optimizer state; returns the port's expected trees and templates."""
    if model == "asr":
        jspec = JM.build_spec(FEAT, VOCAB, **TINY_MODEL)
        jp = JM.asr_init(jax.random.PRNGKey(seed), jspec)
        tp = TM.asr_init(torch.Generator(),
                         TM.build_spec(FEAT, VOCAB, **TINY_MODEL))
    else:
        jp = JLM.lm_init(jax.random.PRNGKey(seed), JLM.build_spec(*LM_ARGS))
        tp = TLM.lm_init(torch.Generator(), TLM.build_spec(*LM_ARGS))
    tx, _ = JO.build_optimizer(**hp)
    state = _filled(tx.init(jp), seed + 1)
    JC.save_checkpoint(path, jp, state, 5, "wer", 0.25)
    want = {"model": convert.from_jax_params(jax.tree.map(np.asarray, jp)),
            "optimizer": convert.from_jax_opt_state(
                jax.tree.map(np.asarray, state))}
    return want, tp, TO.build_optimizer(**hp).init(tp)


def _mismatches(want, got, path=""):
    """The paths where ``got`` differs from ``want`` in structure, dtype,
    shape or bits (dicts matched by key: jax.tree rebuilds them sorted)."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(want) != set(got):
            return [path]
        return [m for k in want
                for m in _mismatches(want[k], got[k], path + "/" + k)]
    if isinstance(want, (list, tuple)):
        if not isinstance(got, list) or len(want) != len(got):
            return [path]
        return [m for i, (a, b) in enumerate(zip(want, got))
                for m in _mismatches(a, b, "{}/{}".format(path, i))]
    if (want.dtype != got.dtype or want.shape != got.shape
            or not torch.equal(want.view(torch.int16) if want.dtype ==
                               torch.bfloat16 else want,
                               got.view(torch.int16) if got.dtype ==
                               torch.bfloat16 else got)):
        return [path]
    return []


@pytest.mark.parametrize("model,opt", [("asr", o) for o in OPTIMIZERS]
                         + [("lm", "Adam")])
def test_jax_checkpoint_loads_bitwise(tmp_path, model, opt):
    path = str(tmp_path / "jax.pth")
    want, tp, ts = _write(path, model, OPTIMIZERS[opt])
    assert TC.is_jax_checkpoint(path)
    got = TC.load_checkpoint(path, None, tp, ts)
    assert got["global_step"] == 5 and got["metric_name"] == "wer"
    assert _mismatches(want["model"], got["model"]) == []
    assert set(got["optimizer"]) == set(ts) == set(want["optimizer"])
    for k in ts:
        assert not _mismatches(want["optimizer"][k], got["optimizer"][k]), k
    assert int(got["optimizer"]["count"]) == 7
    if opt == "Adadelta":
        assert all(x.dtype == torch.bfloat16 for x in
                   convert.tree_leaves(got["optimizer"]["e_g"]))


def test_chunked_jax_checkpoint_loads_bitwise(tmp_path, monkeypatch):
    """flax splits an array above its chunk size into a chunked dict (1 GiB
    in use; 4 KiB here, so most leaves are chunked)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 4096)
    path = str(tmp_path / "jax.pth")
    want, tp, ts = _write(path, "asr", OPTIMIZERS["Adadelta"])
    with open(path, "rb") as f:
        assert b"__msgpack_chunked_array__" in f.read()
    got = TC.load_checkpoint(path, None, tp, ts)
    assert _mismatches(want["model"], got["model"]) == []
    assert not _mismatches(want["optimizer"]["e_x"],
                           got["optimizer"]["e_x"])


def test_conv_left_in_hwio_breaks_the_bitwise_check(tmp_path, monkeypatch):
    path = str(tmp_path / "jax.pth")
    want, tp, ts = _write(path, "asr", OPTIMIZERS["Adadelta"])
    monkeypatch.setattr(convert, "_hwio_to_oihw", lambda v: v)
    got = TC.load_checkpoint(path, None, tp, ts)
    assert _mismatches(want["model"], got["model"])


def test_a_template_is_needed_and_must_match(tmp_path):
    """The template gives the lists back: loading without one, or with the
    tree of another model, is refused, naming what to pass or the keys.
    With a template and no optimizer template the state is not read."""
    path = str(tmp_path / "jax.pth")
    want, tp, _ = _write(path, "asr", OPTIMIZERS["Adam"])
    with pytest.raises(ValueError, match="params_template"):
        TC.load_checkpoint(path)
    got = TC.load_checkpoint(path, None, tp)
    assert got["optimizer"] is None
    assert _mismatches(want["model"], got["model"]) == []
    other = TM.asr_init(torch.Generator(), TM.build_spec(
        FEAT, VOCAB, **dict(TINY_MODEL, ctc_weight=1.0)))
    with pytest.raises(ValueError, match="keys"):
        TC.load_checkpoint(path, None, other)


def test_test_mode_decodes_a_jax_checkpoint_as_its_conversion(tmp_path):
    from e2e_asr_pytorch_tpu_torch.main import main
    paths = _write_configs(str(tmp_path))
    jpath = str(tmp_path / "jax.ckpt")
    want, _, _ = _write(jpath, "asr", OPTIMIZERS["Adadelta"], seed=3)
    tpath = str(tmp_path / "port.pth")
    TC.save_checkpoint(tpath, want["model"])
    out = str(tmp_path / "out")
    rows = {}
    for name, ckpt in (("jx", jpath), ("pt", tpath)):
        main(["--test", "--config", paths["test"], "--name", name, "--cpu",
              "--njobs", "0", "--outdir", out, "--no-msg", "--override",
              "src.ckpt=" + ckpt])
        with open(os.path.join(out, name + "_dev_output.csv")) as f:
            rows[name] = f.read()
    assert rows["jx"] == rows["pt"] and len(rows["jx"].splitlines()) > 1


def _payload(r, depth=0):
    """A seeded msgpack object of the types flax writes."""
    kind = r.integers(0, 9 if depth < 3 else 7)
    if kind == 0:
        return int(r.choice([0, 1, 127, 128, 255, 256, 65535, 65536,
                             2 ** 32 - 1, 2 ** 32, 2 ** 63 - 1, -1, -32,
                             -33, -128, -129, -32768, -32769, -2 ** 31,
                             -2 ** 31 - 1, -2 ** 63]))
    if kind == 1:
        return float(r.standard_normal())
    if kind == 2:
        return [None, True, False][r.integers(0, 3)]
    if kind == 3:
        return "s" * int(r.choice([0, 5, 31, 32, 255, 256, 70000]))
    if kind == 4:
        return bytes(r.integers(0, 256, int(r.choice([0, 3, 255, 256,
                                                      70000])),
                                dtype=np.uint8))
    if kind == 5:
        return int(r.integers(-2 ** 40, 2 ** 40))
    if kind == 6:
        return "k%d" % r.integers(0, 1000)
    if kind == 7:
        return [_payload(r, depth + 1)
                for _ in range(int(r.choice([0, 2, 15, 16, 17])))]
    return {"k%d" % i: _payload(r, depth + 1)
            for i in range(int(r.choice([0, 3, 15, 16, 20])))}


def _plain(x):
    if isinstance(x, memoryview):
        return bytes(x)
    if isinstance(x, list):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


@pytest.mark.parametrize("seed", range(4))
def test_hand_decoder_matches_the_msgpack_package(seed):
    r = np.random.default_rng(seed)
    obj = {"payload": [_payload(r) for _ in range(12)],
           "big": list(range(70000)), "wide": {str(i): i for i in
                                               range(70000)}}
    for single in (False, True):
        buf = msgpack.packb(obj, use_bin_type=True, use_single_float=single)
        assert _plain(TC.unpackb(buf)) == msgpack.unpackb(buf, raw=False)


def test_hand_decoder_reads_flax_arrays():
    """flax's ndarray and numpy-scalar ext types, every dtype a checkpoint
    holds, bfloat16 as its bits."""
    r = np.random.default_rng(0)
    tree = {"f32": r.standard_normal((3, 4)).astype(np.float32),
            "i32": np.arange(6, dtype=np.int32).reshape(2, 3),
            "i64": np.array(5, np.int64), "scalar": np.float32(2.5),
            "bf16": np.asarray(jnp.asarray(r.standard_normal((2, 5)),
                                           jnp.bfloat16)),
            "empty": np.zeros((0, 3), np.float32)}
    got = TC.unpackb(serialization.msgpack_serialize(tree))
    for k in ("f32", "i32", "i64", "empty"):
        assert got[k].dtype == tree[k].dtype
        np.testing.assert_array_equal(got[k], tree[k])
    assert got["scalar"] == 2.5
    assert isinstance(got["bf16"], convert.BF16Bits)
    np.testing.assert_array_equal(got["bf16"].bits,
                                  tree["bf16"].view(np.int16))

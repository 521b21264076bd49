"""The port's data x model mesh (parallel/mesh.py) against its single-process
runs, on gloo CPU ranks: the twins of tests/test_parallel.py,
tests/test_solver_parallel.py and tests/test_multihost.py.

A 2 x 1 (dp) and a 2 x 2 (dp x tp) mesh run the real ASR solver for 3
steps, RNG-free, on batches of 3 utterances (over 2 data ranks: 2 real rows
and 1 real + 1 padding row), and every parameter leaf must match the
single-process run at the JAX tests' rtol=2e-4, atol=2e-5. Each rank and
the reference run one thread, so only the mesh differs. Planted faults that
must break that bound: gradients averaged over the ranks of per-rank means
(DDP's default), no gradient reduction, and the tp slices gathered in the
wrong order. Three process launches in all: tests/torch_mesh_ranks.py dp
and tp, and the CLI's own ``--lm --n-devices 2``.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

from e2e_asr_pytorch_tpu.models import asr as JM
from e2e_asr_pytorch_tpu.parallel import mesh as jmesh
from e2e_asr_pytorch_tpu_torch import convert
from e2e_asr_pytorch_tpu_torch import main as TMain
from e2e_asr_pytorch_tpu_torch.parallel import mesh as tmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.join(ROOT, "tests", "torch_mesh_ranks.py")
RTOL, ATOL = 2e-4, 2e-5


def _model(dim):
    return dict(
        ctc_weight=0.5,
        encoder=dict(vgg=6, vgg_freq=-1, vgg_low_filt=-1, module="LSTM",
                     bidirection=True, dim=[dim], dropout=[0.0],
                     layer_norm=[False], proj=[False], sample_rate=[1],
                     sample_style="drop"),
        attention=dict(mode="loc", dim=8, num_head=1, v_proj=False,
                       temperature=0.5, loc_kernel_size=5, loc_kernel_num=3),
        decoder=dict(module="LSTM", dim=dim, layer=1, dropout=0))


def _write(d, dim):
    text = {"mode": "character",
            "vocab_file": os.path.join(ROOT, "corpus", "librispeech_char.txt")}
    corpus = {"name": "synthetic", "path": "", "batch_size": 3, "n_utts": 9,
              "max_tokens": 5}
    audio = {"feat_type": "fbank", "feat_dim": 20, "apply_cmvn": False,
             "delta_order": 0, "frame_length": 25, "frame_shift": 10,
             "ref_level_db": 20, "min_level_db": -100,
             "preemphasis_coeff": 0.97, "augment": False, "time_aug": False}
    train = {"data": {"corpus": dict(corpus, train_split=["train"],
                                     dev_split=["dev"], bucketing=True),
                      "audio": audio, "text": text},
             "hparas": {"valid_step": 3, "max_step": 3, "tf_start": 1.0,
                        "tf_end": 1.0, "tf_step": 10,
                        "optimizer": "Adadelta", "lr": 1.0, "eps": 1e-8,
                        "lr_scheduler": "fixed", "curriculum": 0,
                        "val_mode": "cer", "early_stopping": False,
                        "label_smoothing": True},
             "model": _model(dim)}
    test = {"data": {"corpus": dict(corpus, dev_split=["dev"],
                                    test_split=["test"], bucketing=False)},
            "src": {"config": os.path.join(d, "train.yaml"),
                    "ckpt": os.path.join(d, "ckpt", "single",
                                         "last_att_dev.pth")},
            "decode": {"beam_size": 3, "ctc_weight": 0.3,
                       "min_len_ratio": 0.0, "max_len_ratio": 0.3,
                       "lm_weight": 0.0}}
    lm = {"data": {"corpus": {"name": "synthetic", "path": "",
                              "train_split": ["lm-train"],
                              "dev_split": ["lm-dev"], "bucketing": True,
                              "batch_size": 3, "n_sents": 9,
                              "max_tokens": 8},
                   "text": text},
          "hparas": {"valid_step": 2, "max_step": 2, "optimizer": "Adam",
                     "lr": 1e-3, "eps": 1e-8, "lr_scheduler": "fixed"},
          "model": {"emb_tying": True, "emb_dim": 16, "module": "LSTM",
                    "dim": 16, "n_layers": 1, "dropout": 0.0}}
    for name, cfg in (("train", train), ("test", test), ("lm", lm)):
        with open(os.path.join(d, name + ".yaml"), "w") as f:
            yaml.safe_dump(cfg, f)


def _single(d, name, *extra):
    """The single-process run, one thread as each rank has."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return TMain.main(["--config", os.path.join(d, name + ".yaml")]
                          + list(extra) + [
                              "--cpu", "--njobs", "0", "--no-msg",
                              "--logdir", os.path.join(d, "log"),
                              "--ckpdir", os.path.join(d, "ckpt"),
                              "--outdir", os.path.join(d, "out")])
    finally:
        torch.set_num_threads(threads)


def _drive(case, d):
    out = subprocess.run([sys.executable, RANKS, case, d], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-6000:]


def _csvs(d, tag):
    out = {}
    for split in ("dev", "test"):
        with open(os.path.join(d, "out", "{}_{}_output.csv".format(
                tag, split))) as f:
            out[split] = f.read()
    return out


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dp"))
    _write(d, 32)
    ref = _single(d, "train", "--name", "single")
    _single(d, "test", "--test", "--name", "dec_single")
    _drive("dp", d)
    return d, ref


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tp"))
    # 4H = 512: the LSTM gate matmuls reach the shard rule's min_dim
    _write(d, 128)
    ref = _single(d, "train", "--name", "single",
                  "--override", "hparas.valid_step=100")
    _drive("tp", d)
    return d, ref


def _excess(ref_params, path):
    """Per leaf, max(|port - ref| - (atol + rtol |ref|)) over its elements:
    > 0 where the bound is broken."""
    got = convert.tree_leaves(torch.load(path, weights_only=True))
    ref = convert.tree_leaves(ref_params)
    assert len(got) == len(ref)
    return [float(((g - r).abs() - (ATOL + RTOL * r.abs())).max())
            for g, r in zip(got, ref)]


@pytest.mark.parametrize("case", ["dp", "tp"])
def test_mesh_run_matches_single_process(case, request):
    d, ref = request.getfixturevalue(case)
    excess = _excess(ref.params, os.path.join(d, "params_{}.pt".format(case)))
    assert max(excess) <= 0, excess


@pytest.mark.parametrize("case,fault", [("dp", "avg"), ("dp", "noreduce"),
                                        ("tp", "order")])
def test_planted_mesh_faults_break_the_bound(case, fault, request):
    d, ref = request.getfixturevalue(case)
    excess = _excess(ref.params, os.path.join(
        d, "params_{}_{}.pt".format(case, fault)))
    assert max(excess) > 0, excess


def test_tp_rank_stores_only_its_slice(tp):
    """Under --n-model 2 each rank keeps half the columns of every wide
    leaf, and of its Adadelta accumulators; no rank holds a whole one."""
    d, ref = tp
    full = [list(x.shape) for x in convert.tree_leaves(ref.params)]
    specs = tmesh.tree_leaves_specs(tmesh.param_shardings(ref.params, 2))
    wide = [i for i, s in enumerate(specs) if s == tmesh.SHARDED]
    assert len(wide) >= 4
    for rank in range(4):
        with open(os.path.join(d, "shapes_tp_{}.json".format(rank))) as f:
            got = json.load(f)
        for trees in [[got["params"]]] + [[v] for v in got["opt"].values()]:
            shapes = trees[0]
            for i, (g, f_) in enumerate(zip(shapes, full)):
                want = f_[:-1] + [f_[-1] // 2] if i in wide else f_
                assert g == want, (rank, i, g, f_)


def test_dp_ckpt_and_decode_match_single_process(dp):
    """The mesh run's checkpoint (gathered by rank 0) holds the single run's
    parameters, and the test solver's CSVs on the mesh (batches padded to
    the data axis, padding rows dropped) equal the single-process CSVs."""
    d, ref = dp
    excess = _excess(ref.params, os.path.join(d, "params_dp.pt"))
    ck = torch.load(os.path.join(d, "ckpt", "dp", "last_att_dev.pth"),
                    weights_only=True)
    got = convert.tree_leaves(ck["model"])
    for g, r in zip(got, convert.tree_leaves(ref.params)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=RTOL,
                                   atol=ATOL)
    assert max(excess) <= 0
    one, mesh = _csvs(d, "dec_single"), _csvs(d, "dec_dp")
    for split in ("dev", "test"):
        assert mesh[split].splitlines()[0] == "idx\thyp\ttruth"
        assert len(mesh[split].splitlines()) == 1 + 9
        assert mesh[split] == one[split]


def test_lm_solver_runs_on_the_mesh_through_the_cli(dp):
    """``--lm --n-devices 2``: main() starts two gloo ranks; rank 0 writes
    the checkpoint, every leaf finite."""
    d, _ = dp
    assert TMain.main(["--lm", "--config", os.path.join(d, "lm.yaml"),
                       "--name", "lm2", "--cpu", "--njobs", "0", "--no-msg",
                       "--n-devices", "2", "--logdir",
                       os.path.join(d, "log"), "--ckpdir",
                       os.path.join(d, "ckpt")]) is None
    ck = torch.load(os.path.join(d, "ckpt", "lm2", "last_ppx.pth"),
                    weights_only=True)
    assert ck["global_step"] == 2 and np.isfinite(ck["metric_value"])
    assert all(torch.isfinite(x).all()
               for x in convert.tree_leaves(ck["model"]))


@pytest.mark.parametrize("min_dim", [32, 512])
def test_param_shardings_pick_the_jax_rule_leaves(min_dim):
    """The port's rule on the converted tree picks the leaves and the dim
    that the JAX rule picks on the JAX tree."""
    spec = JM.build_spec(40, 31, **_model(128))
    shapes = jax.eval_shape(lambda k: JM.asr_init(k, spec),
                            jax.random.PRNGKey(0))
    jp = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), shapes)
    jp["emb_plugin"] = {"net1": {"w": np.zeros((128, 600), np.float32),
                                 "b": np.zeros(600, np.float32)},
                        "fuse_lambda": np.zeros(31, np.float32)}
    mesh = jmesh.make_mesh(n_data=1, n_model=2)
    want = [s.spec for s in jax.tree.leaves(
        jmesh.param_shardings(jp, mesh, min_dim=min_dim))]
    tp = convert.from_jax_params(jax.tree.map(np.asarray, jp))
    got = tmesh.tree_leaves_specs(tmesh.param_shardings(tp, 2, min_dim))
    assert got == [tuple(s) for s in want]
    assert sum(s == tmesh.SHARDED for s in got) >= (1 if min_dim == 512
                                                     else 6)


def test_a_mesh_beyond_the_visible_devices_raises(monkeypatch):
    """Before any rank starts: more ranks than devices (CPU cores with
    --cpu) raise, as JAX asserts; so does an --n-model that does not divide
    the device count."""
    visible = tmesh.visible_devices(True)
    with pytest.raises(ValueError, match="mesh larger than device count"):
        TMain.main(["--config", "unused.yaml", "--cpu", "--n-devices",
                    str(visible + 1)])
    monkeypatch.setattr(tmesh, "visible_devices", lambda cpu: 8)
    with pytest.raises(ValueError, match="--n-model must divide"):
        TMain.main(["--config", "unused.yaml", "--cpu", "--n-devices", "3",
                    "--n-model", "2"])

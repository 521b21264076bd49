"""The port's own host modules (config, metrics, tokenizer, data loaders)
against the JAX package's, of which they are copies; and a guard that the
port imports neither JAX nor anything of the JAX package.

The copies share no state with the originals, so equal seeds must give equal
batches, array for array."""

import ast
import os

import numpy as np
import pytest

from e2e_asr_pytorch_tpu.data import batching as JB
from e2e_asr_pytorch_tpu.data import loaders as JD
from e2e_asr_pytorch_tpu.data import tokenizer as JT
from e2e_asr_pytorch_tpu.utils import config as JC
from e2e_asr_pytorch_tpu.utils import metrics as JM
from e2e_asr_pytorch_tpu.utils import timer as JTimer
from e2e_asr_pytorch_tpu_torch.data import batching as TB
from e2e_asr_pytorch_tpu_torch.data import loaders as TD
from e2e_asr_pytorch_tpu_torch.data import tokenizer as TT
from e2e_asr_pytorch_tpu_torch.utils import config as TC
from e2e_asr_pytorch_tpu_torch.utils import metrics as TM
from e2e_asr_pytorch_tpu_torch.utils import timer as TTimer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(ROOT, "corpus", "librispeech_char.txt")
TEXT = {"mode": "character", "vocab_file": VOCAB}
AUDIO = {"feat_type": "fbank", "feat_dim": 40, "delta_order": 2,
         "apply_cmvn": True}
CORPUS = {"name": "synthetic", "path": "", "train_split": ["train"],
          "dev_split": ["dev"], "test_split": ["test"], "bucketing": True,
          "batch_size": 4, "n_utts": 26, "min_tokens": 3, "max_tokens": 9}


def _same_batches(jit, tit, n=None):
    count = 0
    for jb, tb in zip(jit, tit):
        assert sorted(jb) == sorted(tb)
        for k in jb:
            ja, ta = np.asarray(jb[k]), np.asarray(tb[k])
            assert ja.dtype == ta.dtype and ja.shape == ta.shape, k
            assert np.array_equal(ja, ta), k
        count += 1
        if n is not None and count == n:
            break
    return count


@pytest.mark.parametrize("ascending", [False, True])
def test_load_dataset_train_gives_the_same_batches(monkeypatch, ascending):
    # the JAX loader asks jax.process_count() for its row split: one process
    monkeypatch.setattr(JD, "_host_rows", lambda: None)
    j = JD.load_dataset(0, False, False, ascending, CORPUS, AUDIO, TEXT,
                        seed=3)
    t = TD.load_dataset(0, False, False, ascending, CORPUS, AUDIO, TEXT,
                        seed=3)
    assert j[2:4] == t[2:4] and j[5] == t[5]          # dims and messages
    assert len(j[0]) == len(t[0]) and len(j[1]) == len(t[1])
    assert _same_batches(iter(j[0]), iter(t[0])) == len(j[0])
    assert _same_batches(iter(j[1]), iter(t[1])) == len(j[1])
    # the second epoch reshuffles the same way
    assert _same_batches(iter(j[0]), iter(t[0])) == len(j[0])


def test_load_dataset_eval_gives_the_same_batches():
    j = JD.load_dataset(0, False, False, False, CORPUS, AUDIO, TEXT,
                        mode="eval", seed=1)
    t = TD.load_dataset(0, False, False, False, CORPUS, AUDIO, TEXT,
                        mode="eval", seed=1)
    assert j[2:4] == t[2:4] and j[5] == t[5]
    for k in (0, 1):
        assert _same_batches(iter(j[k]), iter(t[k])) == len(j[k]) > 0


def test_load_dataset_differs_under_another_seed(monkeypatch):
    monkeypatch.setattr(JD, "_host_rows", lambda: None)
    j = JD.load_dataset(0, False, False, False, CORPUS, AUDIO, TEXT, seed=3)
    t = TD.load_dataset(0, False, False, False, CORPUS, AUDIO, TEXT, seed=4)
    with pytest.raises(AssertionError):
        for _ in range(3):  # the shuffles of three epochs cannot all agree
            _same_batches(iter(j[0]), iter(t[0]))


LM_CORPUS = {"name": "synthetic", "path": "", "train_split": ["lm-train"],
             "dev_split": ["lm-dev"], "bucketing": True, "batch_size": 8,
             "n_sents": 40, "min_tokens": 3, "max_tokens": 200}


def test_load_textset_gives_the_same_batches():
    j = JD.load_textset(0, False, False, LM_CORPUS, TEXT, seed=2)
    t = TD.load_textset(0, False, False, LM_CORPUS, TEXT, seed=2)
    assert j[2] == t[2] == 31 and j[4] == t[4]
    for k in (0, 1):
        assert len(j[k]) == len(t[k]) > 0
        assert _same_batches(iter(j[k]), iter(t[k])) == len(j[k])
    # texts over HALF_BATCHSIZE_TEXT_LEN tokens halve their batch on both
    assert TB.HALF_BATCHSIZE_TEXT_LEN == JB.HALF_BATCHSIZE_TEXT_LEN == 150
    assert TB.TextBatchIterator.TOKEN_BUCKETS == \
        JB.TextBatchIterator.TOKEN_BUCKETS
    rows = sorted({b["txt"].shape[0] for b in iter(t[0])})
    assert rows == [4, 8]


def test_load_textset_differs_under_another_seed():
    j = JD.load_textset(0, False, False, LM_CORPUS, TEXT, seed=2)
    t = TD.load_textset(0, False, False, LM_CORPUS, TEXT, seed=5)
    with pytest.raises(AssertionError):
        _same_batches(iter(j[1]), iter(t[1]))


def test_host_rows_is_none_until_multi_gpu(monkeypatch):
    """None in a single process and on a mesh with one data rank; on a
    mesh with n_data > 1, this rank's (place on the 'data' axis, n_data),
    as JAX's multi-host (process_index, process_count)."""
    from e2e_asr_pytorch_tpu_torch.parallel import mesh as tmesh
    assert TD._host_rows() is None
    for n_data, n_model, rank, want in ((1, 2, 1, None), (2, 2, 3, (1, 2)),
                                        (4, 1, 2, (2, 4))):
        monkeypatch.setattr(tmesh, "_CURRENT", tmesh.Mesh(
            n_data, n_model, rank, "cpu", None, None))
        assert TD._host_rows() == want


def test_constants_and_bucket_tables_are_unchanged():
    for name in ("HALF_BATCHSIZE_AUDIO_LEN", "HALF_BATCHSIZE_TEXT_LEN"):
        assert getattr(TB, name) == getattr(JB, name)
    consts = [n for n in dir(JB.AudioBatchIterator) if n.isupper()]
    for n in consts:
        assert getattr(TB.AudioBatchIterator, n) == \
            getattr(JB.AudioBatchIterator, n)
    assert TC.DEFAULT_HPARAS == JC.DEFAULT_HPARAS


def test_prefetch_keeps_order_and_raises_worker_errors():
    assert list(TB.prefetch(iter(range(7)), size=2)) == list(range(7))

    def boom():
        yield 1
        raise RuntimeError("worker failed")
    with pytest.raises(RuntimeError, match="worker failed"):
        list(TB.prefetch(boom(), size=2))


# ------------------------------------------------------------ utilities
@pytest.mark.parametrize("mode,ctc", [("wer", False), ("cer", False),
                                      ("cer", True), ("per", True)])
def test_cal_er_agrees(mode, ctc):
    jt, tt = JT.load_text_encoder(**TEXT), TT.load_text_encoder(**TEXT)
    rng = np.random.default_rng(11)
    pred = rng.standard_normal((5, 12, 31)).astype(np.float32)
    truth = rng.integers(3, 31, (5, 9))
    truth[2, 4:] = 0
    truth[4, 1:] = 0
    a = JM.cal_er(jt, pred, truth, mode=mode, ctc=ctc)
    b = TM.cal_er(tt, pred, truth, mode=mode, ctc=ctc)
    assert a == b and a > 0


def test_cal_er_is_not_blind():
    tt = TT.load_text_encoder(**TEXT)
    truth = np.array([[5, 6, 7, 8, 1]])
    right = np.eye(31, dtype=np.float32)[truth]
    wrong = np.eye(31, dtype=np.float32)[np.array([[9, 9, 9, 9, 1]])]
    assert TM.cal_er(tt, right, truth, mode="cer") == 0.0
    assert TM.cal_er(tt, wrong, truth, mode="cer") > 0.5


@pytest.mark.parametrize("text", ["HELLO WORLD", "A B  C", "IT'S", ""])
def test_tokenizer_agrees(text):
    jt, tt = JT.load_text_encoder(**TEXT), TT.load_text_encoder(**TEXT)
    assert jt.vocab_size == tt.vocab_size and jt.token_type == tt.token_type
    ids = tt.encode(text)
    assert ids == jt.encode(text)
    assert tt.decode(ids) == jt.decode(ids)
    assert tt.decode([5, 5, 0, 6, 6, 1, 7], ignore_repeat=True) == \
        jt.decode([5, 5, 0, 6, 6, 1, 7], ignore_repeat=True)


@pytest.mark.parametrize("name", ["synthetic_lm.yaml", "librispeech_lm.yaml",
                                  "librispeech_asr_best.yaml",
                                  "synthetic_test.yaml"])
def test_load_config_agrees(name):
    path = os.path.join(ROOT, "config", name)
    assert TC.load_config(path) == JC.load_config(path)


def test_overrides_paras_and_names_agree():
    path = os.path.join(ROOT, "config", "synthetic_lm.yaml")
    over = ["hparas.lr=0.5", "model.dim=128", "data.corpus.path=/x"]
    assert TC.apply_overrides(TC.load_config(path), over) == \
        JC.apply_overrides(JC.load_config(path), over)
    argv = ["--config", path, "--lm", "--cpu", "--seed", "7", "--njobs", "2"]
    jp, tp = JC.parse_paras(argv), TC.parse_paras(argv)
    assert vars(jp) == vars(tp)
    assert TC.exp_name(tp) == JC.exp_name(jp) == "synthetic_lm_sd7"
    assert TTimer.human_format(123456) == JTimer.human_format(123456)


# ---------------------------------------------------------------- the guard
FORBIDDEN = {"jax", "jaxlib", "optax", "flax", "e2e_asr_pytorch_tpu"}


def _port_sources():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(
            ROOT, "e2e_asr_pytorch_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith(".py")]
    return sorted(files)


def _imports(path):
    """Top-level package names of every import statement in the file, at any
    depth (lazy imports inside functions included)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [(a.name.split(".")[0], node.lineno) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.append(((node.module or "").split(".")[0], node.lineno))
    return found


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_sources()
    assert len(files) > 40
    bad = [(os.path.relpath(p, ROOT), line, name) for p in files
           for name, line in _imports(p) if name in FORBIDDEN]
    assert not bad, bad


def test_the_guard_sees_lazy_and_dotted_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\n"
                   "def f():\n"
                   "    from e2e_asr_pytorch_tpu.utils import timer\n"
                   "    import jax.numpy as jnp\n"
                   "import e2e_asr_pytorch_tpu_torch.main\n")
    found = sorted(_imports(str(src)), key=lambda x: x[1])
    assert found == [("os", 1), ("e2e_asr_pytorch_tpu", 3), ("jax", 4),
                     ("e2e_asr_pytorch_tpu_torch", 5)]
    assert [n for n, _ in found if n in FORBIDDEN] == [
        "e2e_asr_pytorch_tpu", "jax"]

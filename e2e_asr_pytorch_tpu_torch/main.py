"""CLI entry of the port: ASR training, decoding with ``--test``, or RNN-LM
training with ``--lm``.

    python -m e2e_asr_pytorch_tpu_torch.main --config X.yaml \\
        [--test | --lm] [--cpu] [--amp] [--seed N] [--load CKPT] \\
        [--override dotted.path=value ...]

The same flags and YAML schema as the JAX package's ``main.py``. Without
``--test`` it trains the ASR model of the config (train_asr.Solver); with
``--test`` the test config points at the training config (``src.config``)
and checkpoint (``src.ckpt``), and its ``data``/``decode`` blocks override.
With ``--lm`` it trains the language model of the config
(train_lm.Solver), whose checkpoints the decode path reads as its LM.
Without ``--cpu`` the program runs on CUDA and refuses to start without it.
"""

from __future__ import annotations

from e2e_asr_pytorch_tpu_torch.utils.config import (apply_overrides, load_config,
                                              parse_paras, set_seed)


def build_solver(argv=None):
    """Parse the flags, merge the configs and load the data: a train or test
    Solver ready for ``set_model`` (its ``vocab_size`` and ``feat_dim``
    known)."""
    paras = parse_paras(argv)
    if paras.n_devices not in (None, 1) or paras.n_model != 1:
        raise NotImplementedError(
            "--n-devices {} / --n-model {}: the data x model mesh is not "
            "ported yet, the port runs on one device (ROADMAP queue 1 item "
            "8: multi-GPU)".format(paras.n_devices, paras.n_model))
    config = apply_overrides(load_config(paras.config), paras.override)
    set_seed(paras.seed)
    if paras.lm:
        from e2e_asr_pytorch_tpu_torch.train.train_lm import Solver
        solver = Solver(config, paras, "train")
        solver.load_data()
        return solver
    if not paras.test:
        from e2e_asr_pytorch_tpu_torch.train.train_asr import Solver
        solver = Solver(config, paras, "train")
        solver.load_data()
        return solver
    from e2e_asr_pytorch_tpu_torch.train.test_asr import Solver
    # test configs point at the training config via src:
    if "src" in config:
        train_cfg = load_config(config["src"]["config"])
        train_cfg["data"].update(config.get("data", {}))
        for k in ("src", "decode"):
            if k in config:
                train_cfg[k] = config[k]
        config = train_cfg
    solver = Solver(config, paras, "test")
    solver.load_data()
    return solver


def main(argv=None):
    solver = build_solver(argv)
    solver.set_model()
    solver.exec()
    return solver


if __name__ == "__main__":
    main()

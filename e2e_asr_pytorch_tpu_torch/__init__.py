"""e2e_asr_pytorch_tpu_torch — the PyTorch/CUDA port of e2e_asr_pytorch_tpu.

Module and function names follow the JAX package so each counterpart is easy
to find; parameters are plain dicts of tensors with the JAX pytree's key
names and layouts. Every TPU kernel on a ported path is a hand-written CUDA
kernel for Hopper (``csrc/``), with a plain PyTorch version beside it that
the CPU runs.

- ``ops``     — features, LSTM ops, attention, CTC collapse, and the
                kernels (``ops/kernels``: build + ctypes wrappers).
- ``models``  — VGG frontend, BLSTM encoder, LAS decoder, RNN LM.
- ``decode``  — batched greedy and beam search with LM shallow fusion.
- ``train``   — checkpoint, solver base and the test (decode) solver.
- ``main``    — ``python -m e2e_asr_pytorch_tpu_torch.main --test ...``.
"""

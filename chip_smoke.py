#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases (each prints its lines; any failure raises and exits non-zero, and
no result line is printed):

1. device  -- the card's name and power limit (nvidia-smi) and
              torch.cuda.get_device_name(); refuses to run without CUDA.
2. build   -- compiles the seven CUDA sources for sm_90a, one nvcc each, all
              started together: bilstm_fwd.cu (K1), bilstm_bwd.cu (K2),
              int8_table.cu (K3, K4), lstm_fwd.cu (K5f's wide form, K6f),
              lstm_bwd.cu (K5b, K6b), gru.cu (K7f, K7b) and ligru.cu (K8f,
              K8b); K5f's narrow form is K1's resident kernel over one
              direction.
3. kernel  -- every kernel against its plain PyTorch version on the card,
              with the tolerances stated at the top of this file and
              CUDA-event times for both (device time alone: the stream is
              given a head start, then one event pair brackets the
              repetitions, ``_time_ms``):
              K1 in both its forms (resident: w_h in shared memory, tensor
              cores, both directions in one launch of 20-unit blocks;
              streamed: w_h from L2 every step) at the decode shapes (T=400/200 from the 16 s / 8 s
              buckets, B=8, H=1280), the training shape (T=400, B=16, bf16,
              stashes on), T=320 and a ragged T=37/B=3/H=200 (240 in the
              resident form), phase 9's shapes (T=1280, B=16, H=320, bf16:
              config/librispeech_asr.yaml's first layers; T=32, B=8, H=64:
              config/synthetic_debug.yaml's listener), and the streamed form
              alone, picked by the wrapper's rule, at T=200, B=16, H=1296;
              both forms are timed at the training shape and their
              microseconds per step printed, and the rule's form and the
              plain version at H=320 beside the card's name and power limit;
              phase 10's shapes (T=400, B=16, H=512:
              config/libri/asr_example.yaml's listener, 560 units; T=1600,
              B=16, H=256: the upstream recipe's over vgg 7, 320 units, the
              planted faults held there too), each timed beside its plain
              version, cuDNN's call and its bound;
              K2 in both its forms (resident: each block's 20 rows of w_h
              in shared memory, tensor cores; streamed: scalar, w_h from L2)
              at T=400/200, B=16, H=1280 (bf16, and f32 at T=200), the
              ragged shape and phase 9's two, the streamed form alone at
              H=1296;
              K3/K4 at B=16, T=400/200, D=2560, phase 5's median training
              batch (T=240), a shape whose T and D are multiples of
              neither their t-ranges and D-slices nor a 512-wide slice
              (T=333, D=2576)
              and two small ragged ones, a second launch bit for bit equal
              to the first, each beside the earlier reading (an event pair
              around each call, which spans the wrapper's host work) and,
              on a line of its own, the wrapper's host time a call; at the
              main shape also with a cold L2 (a 64 MiB buffer written
              before each launch, its own time taken off) and beside the
              library call: torch.einsum over the table widened to bf16
              beforehand, what the port's ``value_table: 'bf16'`` runs.
              K5f in both its forms (narrow: one m16 tile of rows, K1's
              resident kernel over one direction, 10 units a block; wide:
              K6f's wgmma kernel with K5's contract), each form at every
              shape, the form the rule takes printed, and K5b (K6b's kernel
              with K5's contract, one form) from the stashes of the rule's
              form: the 4x
              LSTM-1024 LM's shape (T=160, B=128, H=1024, bf16), forward and
              reversed, the single-direction listener's shapes (T=400, B=16
              and T=200, B=8, H=1280, bf16; T=200, B=16 in f32 for the
              planted faults), the APC stack's on the f32 streams it feeds
              (T=200, B=8, H=512: its pretraining, planted faults held
              there; T=1600, B=16: its encode of the longest bucket) and the
              ragged shape; K6f/K6b at
              the flagship LM's shapes (T=160, B=128 and T=320, B=64, H=2048,
              bf16) and the ragged shape.
              Every recurrence kernel (K1 and K2 in both forms, K5f in
              both, K5b, K6f, K6b, K7f / K7b and K8f / K8b in both) is
              relaunched RELAUNCHES times on the same operands at every
              shape and must give the same bits each time.
              Each is also shown to fail against a plain version with
              planted faults (K1 in both forms, at T=320, B=8, at the
              training shape and at H=320, K5f, K6f: doubled w_h, f32 h; K2
              in both forms at the training shape, at T=200 in f32 and at
              H=320, K5b, K6b: doubled w_h, f32 dgates; K5f in its narrow
              form and K5b at the listener's shapes, K5f in its wide form
              and K5b at the LM's; K3/K4: doubled table, f32 small operand;
              K3 without the table's last t row, K4 without its last D
              column, each with its margin).
              Beside the LSTM kernels one library call is timed and used
              nowhere else: torch.nn.LSTM on cuDNN in bf16 at the same T, B,
              H (forward for the forward kernels; forward + backward, and
              the backward alone, for the backward ones; it includes the
              input projection, so the xg matmul's own time is printed
              beside it).
              K7f/K7b (GRU) and K8f/K8b (light GRU) at the listener's shapes
              (T=400/200, B=16 and T=400, B=8, H=1280, bf16), forward and
              reversed, and the ragged shape in f32 and bf16, the backward
              from the forward kernel's own stash: K7f/K8f and K7b/K8b in
              their single forms (one direction a launch) at every shape,
              then every shape as a direction pair through the packed forms
              (both directions in one forward launch, then one backward
              launch from its stashes, each direction on operands of its
              own, the light GRU's mask shared), each direction held as the
              single forms are, a mirrored pair's halves bit for bit. The
              light GRU's whole-sequence bound on f32 streams is max(TOL,
              2 x its plain version's own spread on the same operands).
              Planted faults (at T=200, B=16, H=1280 with f32 streams), in
              both forms, each with its margin: doubled w_h, an f32 h / dhg
              / dxg operand, for K7b dxn and dxn*r swapped between its two
              outputs, for K8 a dropped mask, and for the packed backward
              the two directions' operands swapped. Both forms of each are
              timed over both directions at T=400, B=16, the forward with
              the packing of both w_h. The library call beside K7f and K7b
              is torch.nn.GRU on cuDNN in bf16, bidirectional, at the same
              T, B, H, fed the listener's 2H-wide input (forward; forward +
              backward, and the backward alone); K8 has no single PyTorch
              call (no light GRU in PyTorch).
4. slice   -- the port's own CLI (``main --test``) at the flagship's full
              width (VGG-LN + 5x BLSTM-1280, loc attention, 2x LSTM-1024
              decoder; 4x LSTM-2048 tied LM) with seeded weights written as
              port checkpoints, over the synthetic tone corpus (16 utts per
              split, 20-80 tokens = 3.2-12.8 s, batch 8): beam 8 + LM 0.3,
              then greedy. Checks the CSVs, the vocabulary, that every
              parameter is on the card, and that K1 launched exactly 5 times
              per encoded batch (counts reset just before the run). Then
              the beam 8 + LM decode runs again from the same checkpoints:
              every batch's tokens and scores and the CSVs bit for bit.
5. train   -- the port's own CLI in train mode with the flagship's model
              and hparas blocks verbatim (dropout 0.3, int8 value table,
              bf16 d_key, Adadelta with bf16 state, label smoothing,
              SpecAugment on), batch 16 on the synthetic corpus (96 utts,
              20-80 tokens), TRAIN_STEPS steps with validation at the first
              and the last. Checks finite losses and grad norms, that the
              parameters moved, bf16 optimizer state, exact launch counts
              (K1 = 5 x (steps + validation batches), K2 = 5 x steps, every
              one of them in the resident form,
              K3 = K4 = the sum of the steps' decode lengths; counts reset
              just before the run), then decodes last_att_dev.pth with the
              port's --test greedy path. Prints the median step time after
              the first, utts/s, audio seconds per second and the peak
              allocated memory, then one more step under torch.profiler
              (device time, busy share, the kernels with the most device
              time, and K3's and K4's rows: device time a launch at the
              training shapes).
6. lm      -- the port's own CLI with --lm: the model and hparas blocks of
              config/librispeech_lm_best.yaml verbatim (tied 2048, 4x
              LSTM-2048, dropout 0.5, Adam 1e-4), batch 128, synthetic text
              (2048 sentences of 40-300 tokens: buckets 48-320, batches over
              150 tokens halve to 64), LM_STEPS steps with validation every
              LM_VALID. Checks finite losses and grad norms, that every
              parameter leaf moved, parameters and Adam state on the card,
              exact launch counts (K6f = 4 x (steps + validation batches),
              K6b = 4 x steps; counts reset just before), last_ppx.pth; then
              holds lm_apply (K6f) against lm_step run token by token on one
              dev batch of the checkpoint, and traces two more steps with
              torch.profiler for the step's device-time breakdown and busy
              share. Then LM_K5_STEPS steps of
              config/librispeech_lm.yaml's 4x LSTM-1024 (K5f, every launch
              in the wide form, and K5b). Prints median step time after the
              first, tokens/s and peak memory, and traces two more steps of
              the 4x LSTM-1024 LM as the flagship's.
7. encoders -- the port's own CLI in train mode with the flagship's blocks
              and one key changed, ``encoder.module: 'GRU'``, then
              ``'liGRU'``: batch 16 on the synthetic corpus, ENC_STEPS steps
              with a validation at the last. Checks as phase 5, every
              listener leaf moved, and exact launch counts (K7f or K8f = 5 x
              (steps + validation batches): one packed launch walks both
              directions of a layer; K7b or K8b = 5 x steps, likewise; K3 =
              K4 = the decode lengths; everything else 0); then ``--test``
              greedy and beam 8 on the checkpoint (CSV checks of phase 4; 5
              forward launches per encoded batch); every K7f / K8f launch,
              training and decoding, and every K7b / K8b launch in the
              packed form; then one more step of each under
              torch.profiler.
              Then UNI_STEPS steps with ``bidirection: False`` on the LSTM
              listener: K5f = 5 x (steps + validation batches), K5b = 5 x
              steps, every K5f launch, training and decoding, in the narrow
              form, no K1 or K2 (H=1280 is K5's). Prints median step
              seconds, utts/s and peak allocated memory for each.
8. agree   -- a small model beam-decoded on the card (kernel, f32) and on
              the CPU (plain version, f32) gives the same tokens, with LM
              fusion, and with joint CTC 0.3 too; its encoder and CTC head as
              a CTC-only model (ctc_weight 1) through the CTC prefix beam +
              LM likewise.
9. chain   -- (a) the dataset-free chain verbatim: the port's CLI trains
              config/synthetic_debug.yaml (80 steps, a 1-layer decoder
              through the autodiff form, CTC 0.5; only the directories
              given), ``--test`` decodes a copy of config/synthetic_test.yaml
              with src.ckpt pointed at its checkpoint (beam 4, joint CTC
              0.3: the banner is checked), and the port's own scorer
              (``python -m e2e_asr_pytorch_tpu_torch.eval``) prints CER and
              WER of both CSVs; K1 = steps + validation batches and K2 =
              steps in training, K1 = encoded batches in the decode, each
              run with the counts reset just before, everything else 0, no
              jax in sys.modules. (b) config/librispeech_asr.yaml's model,
              hparas and data.audio blocks verbatim on the synthetic corpus
              (4x BLSTM-320, pyramid [1,2,1,1], vgg 0, 1-layer decoder 300),
              batch 16, CHAIN_STEPS steps with a validation at the last: the
              checks of phase 5, every decoder and CTC leaf moved, K1 = 4 x
              (steps + validation batches), K2 = 4 x steps, all resident,
              K3 = K4 = 0, its step seconds, utts/s and peak memory; then
              beam 8 + decode CTC 0.3 on its checkpoint (CSV checks). (c)
              phase 4's run again with decode.ctc_weight 0.3 (beam 8 + the
              4x LSTM-2048 LM 0.3 + CTC 0.3): RTF and utts/s beside phase
              4's, then one test batch under torch.profiler (busy share,
              top rows). (d) the flagship's blocks with model.ctc_weight 1
              and seeded weights: ``--test`` with the CTC prefix beam 8 +
              LM 0.3, the CSV checks, K1 = 5 per encoded batch.
10. frontends -- (a) config/libri/asr_example.yaml's model, hparas and
              data.audio blocks verbatim on the synthetic corpus (vgg 1 via
              ``prenet: 'vgg'``, fbank 40 + deltas, 5x BLSTM-512, a 1-layer
              decoder 512, attention only, the subword-256 vocabulary),
              batch 16, EXAMPLE_STEPS steps with a validation at the last:
              the checks of phase 5, K1 = 5 x (steps + validation batches),
              K2 = 5 x steps, all resident; then ``--test`` with
              config/libri/decode_example.yaml's decode block (beam 20, LM
              0.5 on config/libri/lm_example.yaml's untied 2x LSTM-1024,
              seeded) on its checkpoint: CSV checks, RTF. (b) ``--upstream
              apc`` with $APC_CKPT at a path in a temporary directory that
              does not exist: the factory pretrains APC on the card (150
              steps of 8 crops of 2 s, 3x LSTM-512; K5f = K5b = 450, all
              narrow, counts reset around it; first and last L1), then
              config/librispeech_asr_upstream.yaml's blocks (vgg 7, 1x
              BLSTM-256, CTC only, the phone set) train UPSTREAM_STEPS steps
              at batch 16 over it (K1 / K2 as in (a), K5f = 3 per batch the
              upstream encodes, no K5b), and ``--test --upstream apc``
              decodes the checkpoint through the CTC prefix beam (beam 8):
              CSV checks, RTF; nothing is written inside the repo. (c) vgg
              2, 3 and 4 over fbank, and vgg 1 over mfcc 13 + deltas, one
              training step each on the card at one BLSTM-512 layer (finite
              losses and gradients, every frontend leaf moved); each
              frontend's output on the card (cuDNN, f32) against the CPU's;
              feat_to_wave on one utterance on the card against the CPU.
11. runtime -- the rest of the training runtime at the flagship's blocks
              through the port's CLI (batch 16, RUNTIME_UTTS utterances):
              (a) the flagship verbatim but ``tf_end: 0.8`` over
              ``tf_step: 2``, SS_STEPS steps with a validation at the last:
              the generic decoder scan with scheduled sampling, tf_rate 1.0,
              0.9, 0.8 by step; the checks of phase 5, every decoder leaf
              moved, K1 = 5 x (steps + validation batches), K2 = 5 x steps,
              K3 = K4 = 0, JAX's value_table warning given. (b) a GRU
              decoder, 2 heads, ``decoder.dropout: 0.1``, pure teacher
              forcing, GRU_DEC_STEPS steps (the generic scan), then greedy
              and beam 8 + the flagship's 4x LSTM-2048 LM (seeded) at 0.3 on
              its checkpoint (CSV checks of phase 4, K1 = 5 per encoded
              batch). (c) ``--load`` (a)'s checkpoint with ``transfer:
              {train_enc: [3, 4], train_dec: False}``, TUNE_STEPS steps
              (Adadelta, weight_decay 0, the folded decoder: K3 / K4
              launch): layers 0-2, the decoder, attention, embedding and
              CTC head bitwise as loaded, layers 3-4 moved (and the VGG
              frontend: JAX's transfer block freezes rnn layers only), the
              optimizer count TUNE_STEPS, the checkpoint named
              ``last_att_dev_tune-34-0.pth``. (d) AdamW, SGD and RMSprop,
              OPT_STEPS steps each (bf16 accumulators as the flagship's
              hparas set): the checks of phase 5, every listener leaf
              moved.
12. plugin_mesh -- the embedding regularizer / fusion plugin and the mesh,
              through the port's CLI at the flagship's blocks (batch 16,
              RUNTIME_UTTS utterances) with an ``emb:`` block over a
              300-dim fasttext table of the vocabulary written from --seed
              into a temporary directory (CosEmb, weight 0.3, learnable
              lambda ``fuse: -1``): (a) PLUGIN_STEPS steps on the folded
              decoder (the checks of phase 5, K1 = 5 x (steps + validation
              batches), K2 = 5 x steps, K3 = K4 = the decode positions;
              the emb loss finite, lambda moved, the frozen table not),
              then beam 8 + the flagship's 4x LSTM-2048 LM (seeded) at 0.3
              and greedy decoding over the fused distribution of its
              checkpoint (CSV checks, K1 = 5 per encoded batch; RTF).
              (b) a 2x BLSTM-64 model with the plugin decoded (greedy and
              beam 4 + LM, fused) on the card (kernel, f32) and the CPU
              (plain, f32): tokens equal, scores within 1e-3. (c) the run
              of (a) again with ``--n-devices 1``: a one-rank NCCL process
              group, the gradients and the loss denominators through its
              collectives; its step losses and every parameter leaf equal
              to (a)'s bit for bit, the same launches; then ``--test
              --n-devices 1`` greedy on (a)'s checkpoint writes (a)'s CSVs
              byte for byte. (d) on-line BERT targets (MSE 0.1, no
              fusion) from a randomly initialised 2-layer BertForMaskedLM
              of width 768 written from --seed into a temporary
              directory: PLUGIN_STEPS flagship steps, the checks of (a)
              but the table's; if the card machine lacks
              ``transformers``, (d) is not run (a line says so).
13. determinism -- DET_STEPS steps of the flagship (batch 16) and of each
              LM (config/librispeech_lm_best.yaml and librispeech_lm.yaml,
              batch 128), each run twice from one seed and one copy of the
              state through the solvers' own ``train_step``: the losses,
              every parameter leaf and the optimizer state bit for bit
              (12(c) holds the fused plugin's steps so); and a line
              summing up phase 3's relaunches.

The kernels line gives each kernel's launches summed over the main paths
(phases 4, 5, 6, 7, 9, 10, 11 and 12; each driven with the counts reset just
before and read just after; split by path under ``launches_by_path``, whose
phase 10 paths are ``asr_example``, ``apc_pretrain`` and ``upstream``, phase
11's ``runtime_sampling``, ``runtime_gru_decoder``, ``runtime_transfer`` and
``runtime_optimizers``, phase 12's ``plugin``, K5f also by form), its worst
max |err|
against the plain version in phase 3, its kernel and plain times at its main
path's shape (for K5f/K5b, which two paths run, the LM's shape, K5f in the
form the rule takes there and each form's time under ``ms_by_form``, with
the single-direction listener's times under ``listener`` and the APC
stack's under ``apc`` and ``apc_upstream``; for K1/K2 also their time, the
plain version's, the bound and the library call at phase 9's H=320 shape
under ``at_h320`` and at phase 10's under ``at_h512`` and ``at_h256``), for
K7f/K8f
and K7b/K8b both directions of the listener's layer in the rule's form
(each form's under ``ms_by_form``, launches by form under
``launches_by_form``, one single launch under ``single_one_direction_ms``;
for K7b also the earlier event-pair reading, ``event_pair_ms``), for K3/K4
the time with a cold L2 (``cold_ms``), the earlier reading and the
wrapper's host time a call beside the device time (``event_pair_ms``,
``host_ms``), the least time
the card could take for the same work (bound_ms: the larger of operations /
989 TFLOP/s and bytes / 3.35 TB/s, each input read once and each output
written once) and the library call's time where there is one (for the backward
kernels also cuDNN's backward alone, library_bwd_ms). The line before the
last is the card as nvidia-smi names it; the last line is
{"ok": true, "device": {...}}.
"""

import argparse
import functools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))

# kernel vs plain: f32 streams differ by sum order, and a flipped rounding
# of bf16(h) feeds back through the recurrence, so the bound is a fraction
# of one bf16 ulp of h; bf16 streams: ~4 bf16 ulps at |h| <= 1. The bf16
# stashes may differ by one bf16 ulp of their value on top.
TOL = {"float32": 2e-3, "bfloat16": 1.6e-2}
STASH_REL = 2.0 ** -7
# Before the first flip of a bf16(h) rounding the two agree to f32 noise, so
# the mean |err| of ys over each direction's first EARLY_STEPS steps holds
# the bf16(h) @ bf16(w_h) contract that the whole-sequence bound cannot.
EARLY_STEPS = 4
EARLY_MEAN_TOL = 1e-6
FAULT_SHAPE = (320, 8, 1280)
SHAPES = [(400, 16, 1280, "bfloat16"), (400, 8, 1280, "bfloat16"),
          (200, 8, 1280, "bfloat16"), (320, 8, 1280, "float32"),
          (320, 8, 1280, "bfloat16"), (37, 3, 200, "float32"),
          (37, 3, 200, "bfloat16")]
MAIN_SHAPE = SHAPES[0]
# phase 9's K1/K2 shapes: config/librispeech_asr.yaml's first two layers
# (no frontend, so 12.8 s of audio is 1280 frames; B=16, H=320; its fault
# shape) and config/synthetic_debug.yaml's listener (1.28 s over the
# frame-dropping frontend's 4 is 32 frames; B=8, H=64, padded to 80 units)
H320_SHAPE = (1280, 16, 320, "bfloat16")
CHAIN_K12_SHAPES = [H320_SHAPE, (32, 8, 64, "bfloat16")]
# phase 10's K1/K2 shapes: config/libri/asr_example.yaml's listener (5x
# BLSTM-512 over the VGG frontend's time/4: 16 s is 400 frames; H pads to
# 560 units) and the upstream recipe's (1x BLSTM-256 over vgg 7, which keeps
# every frame: the phase's longest bucket, 16 s, is 1600 steps; H pads to
# 320); the planted faults are held at the second
EXAMPLE_SHAPE = (400, 16, 512, "bfloat16")
UPSTREAM_SHAPE = (1600, 16, 256, "bfloat16")
FRONTEND_K12_SHAPES = [EXAMPLE_SHAPE, UPSTREAM_SHAPE]
# the shapes whose kernel, plain, bound and library times the kernels line
# gives beside the main shape's, by key
K12_RECORDS = {"at_h320": H320_SHAPE, "at_h512": EXAMPLE_SHAPE,
               "at_h256": UPSTREAM_SHAPE}
# a width one tile above what the resident form of K1 holds on an H100: the
# wrapper's rule sends it to the streamed form
STREAMED_ONLY_SHAPE = (200, 16, 1296, "bfloat16")
# K2 vs plain, both from the same stashes: a flipped rounding of
# bf16(dgates) feeds back through dh, so the whole-sequence bound is a bf16
# ulp at the top of dxg's range (max |err| <= 2^-6 * max |dxg|); before the
# first flip the two agree to f32 noise, so the mean |err| of dxg over each
# direction's first EARLY_STEPS backward steps must stay under
# EARLY_MEAN_TOL, which holds the bf16(dgates) @ bf16(w_h)^T contract.
BWD_REL = 2.0 ** -6
BWD_SHAPES = [(400, 16, 1280, "bfloat16"), (200, 16, 1280, "bfloat16"),
              (200, 16, 1280, "float32"), (37, 3, 200, "float32"),
              (37, 3, 200, "bfloat16")]
BWD_FAULT_SHAPES = [(400, 16, 1280, "bfloat16"), (200, 16, 1280, "float32"),
                    H320_SHAPE, UPSTREAM_SHAPE]
# K3/K4 vs plain: the same bf16 small operand times int8 values, products
# exact in f32, only the order of the f32 sums differs: max |err| <= 1e-5 *
# max |ref| (an unrounded f32 operand moves the result by ~1e-3 of it).
INT8_REL = 1e-5
# (16, 333, 2576): T and D multiples of neither K4's t-ranges, K3's D-slices
# nor a 512-wide slice; (16, 240, 2560): phase 5's median training batch
# (9.6 s of audio, 960 frames over the VGG frontend's 4).
INT8_SHAPES = [(16, 400, 2560), (16, 200, 2560), (3, 37, 50), (5, 17, 48),
               (16, 333, 2576), (16, 240, 2560)]
TRAIN_STEPS = 6
# config/librispeech_asr.yaml's training steps in phase 9 (batch 16)
CHAIN_STEPS = 6
# K5/K6 vs plain: ys and the stashes as K1 (TOL, STASH_REL, the early mean
# over the walk's first EARLY_STEPS steps), dxg as K2 (BWD_REL of max |dxg|,
# the early mean over the first backward steps). The LM's products sum 1024
# to 8192 terms over 128 rows, so the early means of a sound kernel reach
# 1e-7 to 7e-7 where K1/K2 read 1e-7; the f32-operand fault reads 1.7e-5 to
# 3.6e-5: the bound sits between, at 3e-6. (T, B, H, dtype, reverse)
# K5f/K5b have two main paths: the 4x LSTM-1024 LM (the first shape) and the
# single-direction listener of phase 7 (LSTM_LISTENER_SHAPE, and its long
# utterances' T=200, B=8). Both are timed, and the planted faults are held at
# both and at an f32 shape of the listener's width (LSTM_FAULT_SHAPE).
# The "resident" shapes are K5's, K5f held in both its forms.
LSTM_EARLY_MEAN_TOL = 3e-6
LSTM_LISTENER_SHAPE = (400, 16, 1280, "bfloat16", False)
LSTM_FAULT_SHAPE = (200, 16, 1280, "float32", False)
# phase 10's APC stack (3x LSTM-512, one direction, fed f32 gate streams):
# its pretraining (2 s crops, T=200, B=8; the planted faults are held there)
# and its encode over the phase's longest bucket (T=1600, B=16)
APC_SHAPE = (200, 8, 512, "float32", False)
APC_LONG_SHAPE = (1600, 16, 512, "float32", False)
# the K5f/K5b shapes whose times the kernels line gives, by key
LSTM_RECORDS = {LSTM_LISTENER_SHAPE: "listener", APC_SHAPE: "apc",
                APC_LONG_SHAPE: "apc_upstream"}
LSTM_SHAPES = {
    "resident": [(160, 128, 1024, "bfloat16", False),
                 (160, 128, 1024, "bfloat16", True),
                 LSTM_LISTENER_SHAPE, (200, 8, 1280, "bfloat16", False),
                 LSTM_FAULT_SHAPE, APC_SHAPE, APC_LONG_SHAPE,
                 (37, 3, 200, "float32", False), (37, 3, 200, "float32", True),
                 (37, 3, 200, "bfloat16", False)],
    "chunked": [(160, 128, 2048, "bfloat16", False),
                (320, 64, 2048, "bfloat16", False),
                (37, 3, 200, "float32", False),
                (37, 3, 200, "bfloat16", False)]}
# K7/K8 vs plain: ys, the stash and the backward's outputs as K5/K6, each
# over the reference's range: the light GRU's relu candidates are not bounded
# by 1 as an LSTM's or a GRU's h is (|h| reaches 10 on these inputs), so ys
# and its early mean are divided by max(1, max |ys|) and the backward's by
# max |dxg|. The early mean holds the bf16-operand contract on f32 streams:
# sound kernels read 1e-9 to 3e-7 there (1.5e-6 at the ragged shape, where
# one flipped rounding weighs more) and an f32 operand 9e-6 to 1e-4, so the
# bound is 3e-6, as for K5/K6, and the planted faults are held at an f32
# shape of the listener's width (GRU_FAULT_SHAPE). On bf16 streams the outputs themselves
# are rounded, and one flipped rounding among the early steps' cells moves
# the early mean by some 1e-6 (sound kernels read up to 6e-6 on an H100):
# there the bound is 2e-5, which an f32 operand can pass.
GRU_EARLY_MEAN_TOL = {"float32": 3e-6, "bfloat16": 2e-5}
GRU_FAULT_SHAPE = (200, 16, 1280, "float32", False)
GRU_SHAPES = [(400, 16, 1280, "bfloat16", False),
              (400, 16, 1280, "bfloat16", True),
              (200, 16, 1280, "bfloat16", False),
              (400, 8, 1280, "bfloat16", False), GRU_FAULT_SHAPE,
              (37, 3, 200, "float32", False), (37, 3, 200, "float32", True),
              (37, 3, 200, "bfloat16", False), (37, 3, 200, "bfloat16", True)]
ENC_STEPS = 4
UNI_STEPS = 3
# phase 11's training steps at the flagship's blocks (batch 16): (a)
# scheduled sampling, (b) the GRU decoder with 2 heads and dropout, (c) the
# transfer run resumed from (a), (d) each other optimizer
SS_STEPS = 3
GRU_DEC_STEPS = 2
TUNE_STEPS = 2
OPT_STEPS = 2
RUNTIME_UTTS = 16
# phase 12: the plugin's training steps, its table's width
PLUGIN_STEPS = 3
PLUGIN_TABLE_DIM = 300
# the determinism phase: the launches of each recurrence kernel after the
# first on the same operands, each held bit for bit to the first, and the
# training steps run twice from one seed
RELAUNCHES = 2
DET_STEPS = 2
# the traced windows of the ASR steps (phases 5 and 7) and of the joint
# CTC decode (phase 9(c)): one step or batch each, as the profiler's
# averaging of their events takes 30-70 s a step on the card's host
ASR_TRACE_STEPS = 1
DECODE_TRACE_BATCHES = 1
# phase 10's training steps: config/libri/asr_example.yaml and the upstream
# recipe (batch 16 each)
EXAMPLE_STEPS = 4
UPSTREAM_STEPS = 4
# the steps of APC's auto-pretraining (data/upstream.py _auto_pretrain_apc)
APC_PRETRAIN_STEPS = 150
# phase 10(c): a frontend on the card against the CPU, f32 (the CPU parity
# tests' bound), and feat_to_wave likewise, at the Griffin-Lim iterations
# of the CPU test (tests/test_torch_audio.py): cuFFT and the CPU's FFT sum
# in another order, and the difference grows with the iterations (7.5e-5
# after 30 on a 3 s utterance)
FRONTEND_ATOL = 1e-4
WAVE_ATOL = 1e-4
GL_ITERS = 8
LM_STEPS = 6
LM_VALID = 3
LM_K5_STEPS = 3
# lm_apply (bf16 xg and hidden streams through K6f) against lm_step token by
# token (f32 streams, the same bf16 matmul operands) on one dev batch: the
# streams' bf16 roundings (2^-9 relative per layer) reach the logits, sums
# of 2048 products: max |err| <= 5% of max |logit|, mean |err| <= 0.5%.
LM_LOGIT_MAX_REL = 5e-2
LM_LOGIT_MEAN_REL = 5e-3
# published peaks of one H100 SXM: dense bf16 FLOP/s, HBM bytes/s
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12


def _say(phase, msg):
    print("[{}] {}".format(phase, msg), flush=True)


# seconds each phase took, by name, printed before the kernels line
PHASE_SECONDS = {}


def _timed(name, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + (
        time.perf_counter() - t0)
    return out


def _nvidia_smi():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def _sleep_cycles_per_ms():
    """Clock cycles of torch.cuda._sleep in one ms of device time, read once
    with an event pair around a sleep of 10^7 cycles."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    torch.cuda.synchronize()
    return 10 ** 7 / start.elapsed_time(end)


def _sleep_ms(ms):
    """Keeps the current stream busy for about ``ms`` of device time."""
    import torch
    torch.cuda._sleep(int(ms * _sleep_cycles_per_ms()))


def _time_ms(fn, reps):
    """Device time of one call of ``fn``, ms: the stream is given a head
    start (a device-side sleep longer than the host takes to enqueue all
    ``reps`` calls), then one event pair brackets the repetitions, so the
    events see the device's work and not the host's. The head start is
    checked (the start event must still be pending once every call is
    enqueued) and lengthened once if it fell short. A plain version, whose
    host loop of small operations no head start covers (over 100 ms of
    sleep), is timed without one: its reading is its pace."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()  # warm-up, and a first reading of the host's time a call
    head = 2.0 * (time.perf_counter() - t0) * 1e3 * reps + 1.0
    torch.cuda.synchronize()
    for sleep in ((head, 4.0 * head) if head <= 100.0 else (0.0,)):
        if sleep:
            _sleep_ms(sleep)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead:
            break
    return start.elapsed_time(end) / reps


def _event_pair_ms(fn, reps):
    """The earlier reading: the median over ``reps`` calls of one event pair
    around each call on an idle stream, which also spans the host's work
    before the launch. Kept to show how far the two readings differ."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()  # warm-up
    times = []
    for _ in range(reps):
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _host_ms(fn, reps):
    """The host's time a call of ``fn`` (a wrapper that only enqueues):
    ``reps`` calls on the host clock, without a sync between them."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return host


def _ys_errors(out, ref):
    """(max |err| of ys over the sequence, mean |err| of ys over each
    direction's first EARLY_STEPS steps)."""
    import torch
    t = out[0].shape[0]
    k = min(EARLY_STEPS, t)
    d_f = (out[0].float() - ref[0].float()).abs()
    d_b = (out[1].float() - ref[1].float()).abs()
    early = torch.cat([d_f[:k].flatten(), d_b[t - k:].flatten()]).mean()
    return max(d_f.max().item(), d_b.max().item()), early.item()


def _sound(dt, full, early):
    return full <= TOL[dt] and early <= EARLY_MEAN_TOL


# what the relaunches held: kernel name -> shapes (and forms) relaunched
RELAUNCHED = {}


def _same_bits(name, fn, out, where):
    """``fn()``, the launch that gave ``out`` (all of its outputs; computed
    here when None), relaunched RELAUNCHES times on the same operands,
    gives the same bits each time: a kernel whose result depends on the
    order its blocks meet (a race on a barrier, an unordered sum) would
    not."""
    import torch

    def flat(x):
        return [o for o in (x if isinstance(x, (tuple, list)) else (x,))
                if o is not None]
    first = flat(fn() if out is None else out)
    for i in range(RELAUNCHES):
        again = flat(fn())
        torch.cuda.synchronize()
        if len(again) != len(first) or not all(
                torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError("{} gave other bits on launch {} at "
                                 "{}".format(name, i + 2, where))
    RELAUNCHED.setdefault(name, []).append(where)


def check_planted_faults(K, out, args, dt, where):
    """The kernel's output held against a plain version with a planted
    fault must fail the checks that the sound plain version passes."""
    xg_f, xg_b, wh_f, wh_b = args
    faults = {"w_h x2": lambda: K.bilstm_recurrence_ref(xg_f, xg_b, 2 * wh_f,
                                                         wh_b)}

    def f32_h():
        sound_operand = K._h_operand
        K._h_operand = lambda h: h
        try:
            return K.bilstm_recurrence_ref(*args)
        finally:
            K._h_operand = sound_operand
    faults["f32 h"] = f32_h
    for name, ref_fn in faults.items():
        full, early = _ys_errors(out, ref_fn())
        if _sound(dt, full, early):
            raise AssertionError("planted fault '{}' passed the checks at {}: "
                                 "max {:.3e}, early mean {:.3e}".format(
                                     name, dt, full, early))
        _say("fault", "K1 {}, plain version with {}: max|err| ys {:.3e} (tol "
             "{}), early mean {:.3e} (tol {}) -> caught, {:.1f}x the "
             "bound".format(where, name, full, TOL[dt], early,
                            EARLY_MEAN_TOL, max(full / TOL[dt],
                                                early / EARLY_MEAN_TOL)))


def _record_key(shape):
    """The K12_RECORDS key of a K1/K2 shape, or None."""
    return next((k for k, v in K12_RECORDS.items() if v == shape), None)


def phase_kernel(dev):
    """K1 against its plain version, in both forms. Returns the worst max
    |err|, the form the wrapper's rule takes at the main shape, each form's
    ms there, the plain version's, and by K12_RECORDS key the rule's form's
    and the plain version's ms at that shape."""
    import torch
    from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as K
    gen = torch.Generator().manual_seed(0)
    worst, main_ms, main_plain_ms = 0.0, {}, None
    recs = {k: {} for k in K12_RECORDS}
    for t, b, h, dt in (SHAPES + CHAIN_K12_SHAPES + FRONTEND_K12_SHAPES
                        + [STREAMED_ONLY_SHAPE]):
        dtype = getattr(torch, dt)
        xg_f = torch.randn(t, b, 4 * h, generator=gen).to(dev, dtype)
        xg_b = torch.randn(t, b, 4 * h, generator=gen).to(dev, dtype)
        wh_f = (torch.randn(h, 4 * h, generator=gen) / h ** 0.5).to(dev)
        wh_b = (torch.randn(h, 4 * h, generator=gen) / h ** 0.5).to(dev)
        args = (xg_f, xg_b, wh_f, wh_b)
        ref = K.bilstm_recurrence_ref(*args, stash=True)
        main = (t, b, h, dt) == MAIN_SHAPE
        if main:
            main_plain_ms = _time_ms(lambda: K.bilstm_recurrence_ref(*args),
                                     3)
        rec = _record_key((t, b, h, dt))
        if rec is not None:
            recs[rec]["plain_ms"] = _time_ms(
                lambda: K.bilstm_recurrence_ref(*args), 2)
        ruled = K.form_for(h, dev)
        if (t, b, h, dt) == STREAMED_ONLY_SHAPE and ruled != "streamed":
            raise AssertionError("H={} was expected to take the streamed "
                                 "form, the rule says {}".format(h, ruled))
        # the form the rule takes goes through the wrapper as a caller's
        # tensors do (form=None); the other one is asked for by name
        for form in K.FORMS:
            if form == "resident" and ruled != "resident":
                continue
            counts = (K.RESIDENT_LAUNCHES, K.STREAMED_LAUNCHES)
            ask = None if form == ruled else form
            out = K.bilstm_recurrence(*args, stash=True, form=ask)
            torch.cuda.synchronize()
            took = (K.RESIDENT_LAUNCHES - counts[0],
                    K.STREAMED_LAUNCHES - counts[1])
            if took != ((1, 0) if form == "resident" else (0, 1)):
                raise AssertionError("K1 at H={} took {} where the {} form "
                                     "was expected".format(h, took, form))
            where = "{} form T={} B={} H={} {}".format(form, t, b, h, dt)
            _same_bits("K1 " + form, lambda: K.bilstm_recurrence(
                *args, stash=True, form=ask), out, where)
            errs = [(o.float() - r.float()).abs().max().item()
                    for o, r in zip(out, ref)]
            ys_err, early = _ys_errors(out, ref)
            if not _sound(dt, ys_err, early):
                raise AssertionError(
                    "K1 ys differ from the plain version, {}: max {:.3e} "
                    "(tol {}), early mean {:.3e} (tol {})".format(
                        where, ys_err, TOL[dt], early, EARLY_MEAN_TOL))
            for o, r in zip(out[2:], ref[2:]):
                bound = TOL[dt] + r.float().abs() * STASH_REL
                if not bool(((o.float() - r.float()).abs() <= bound).all()):
                    raise AssertionError("K1 stash differs, " + where)
            plain = K.bilstm_recurrence(*args, form=ask)
            if not all(torch.equal(a, o) for a, o in zip(plain, out[:2])):
                raise AssertionError("K1 without stashes gives other ys, "
                                     + where)
            worst = max(worst, ys_err)
            if ((t, b, h) == FAULT_SHAPE or main
                    or (t, b, h, dt) in (H320_SHAPE, UPSTREAM_SHAPE)):
                check_planted_faults(K, out[:2], args, dt, where)
            ms = _time_ms(lambda: K.bilstm_recurrence(*args, stash=True,
                                                      form=ask), 10)
            if main:
                main_ms[form] = ms
            if rec is not None and ask is None:
                recs[rec]["ms"], recs[rec]["form"] = ms, form
            _say("kernel", "K1 {}: max|err| ys {:.3e} (tol {}), early mean "
                 "{:.3e} (tol {}), cs {:.3e} gates {:.3e}; {:.3f} ms, {:.2f} "
                 "us a step of both directions".format(
                     where, ys_err, TOL[dt], early, EARLY_MEAN_TOL,
                     max(errs[2:4]), max(errs[4:]), ms, ms * 1e3 / t))
    t, b, h, dt = MAIN_SHAPE
    form = K.form_for(h, dev)
    _say("kernel", "K1 at T={} B={} H={} {} with stashes: the rule takes the "
         "{} form; resident {:.3f} ms ({:.2f} us a step of both directions, "
         "{} blocks of {} bytes of shared memory), streamed {:.3f} ms "
         "({:.2f} us), plain {:.3f} ms".format(
             t, b, h, dt, form, main_ms["resident"],
             main_ms["resident"] * 1e3 / t,
             2 * (K._padded(h) // K.TILE_UNITS), K.resident_smem_bytes(h),
             main_ms["streamed"], main_ms["streamed"] * 1e3 / t,
             main_plain_ms))
    for key, (t, b, h, dt) in K12_RECORDS.items():
        r = recs[key]
        _say("kernel", "K1 at T={} B={} H={} {} ({}) with stashes, card {}: "
             "the {} form {:.3f} ms ({:.2f} us a step of both directions), "
             "plain {:.3f} ms".format(
                 t, b, h, dt, key, _nvidia_smi(), r["form"], r["ms"],
                 r["ms"] * 1e3 / t, r["plain_ms"]))
    return worst, form, main_ms, main_plain_ms, recs


def _dxg_errors(out, ref):
    """(max |err| / max |ref| of dxg over the sequence, mean |err| over each
    direction's first EARLY_STEPS backward steps, max |err|)."""
    import torch
    t = out[0].shape[0]
    k = min(EARLY_STEPS, t)
    d_f = (out[0].float() - ref[0].float()).abs()
    d_b = (out[1].float() - ref[1].float()).abs()
    mag = max(ref[0].float().abs().max().item(),
              ref[1].float().abs().max().item())
    full = max(d_f.max().item(), d_b.max().item())
    early = torch.cat([d_f[t - k:].flatten(), d_b[:k].flatten()]).mean()
    return full / mag, early.item(), full


def _k2_planted_faults(K, args, out, where):
    """K2's output held against plain versions with a doubled w_h and with
    f32 dgates in place of the bf16 operand must fail the checks."""
    faults = {"w_h x2": lambda: K.bilstm_recurrence_bwd_ref(2 * args[0],
                                                            *args[1:])}

    def f32_dgates():
        sound_operand = K._dg_operand
        K._dg_operand = lambda d: d
        try:
            return K.bilstm_recurrence_bwd_ref(*args)
        finally:
            K._dg_operand = sound_operand
    faults["f32 dgates"] = f32_dgates
    for name, ref_fn in faults.items():
        f_rel, f_early, _ = _dxg_errors(out, ref_fn())
        if f_rel <= BWD_REL and f_early <= EARLY_MEAN_TOL:
            raise AssertionError("planted fault '{}' passed the K2 checks, "
                                 "{}".format(name, where))
        _say("fault", "K2 {}, plain version with {}: max rel {:.3e} (tol "
             "{:.3e}), early mean {:.3e} (tol {}) -> caught, {:.1f}x the "
             "bound".format(where, name, f_rel, BWD_REL, f_early,
                            EARLY_MEAN_TOL, max(f_rel / BWD_REL,
                                                f_early / EARLY_MEAN_TOL)))


def phase_bwd(dev):
    """K2 against its plain version in both forms, from stashes made by K1.
    Returns the worst max |err|, the form the rule takes at the main shape,
    each form's ms there, the plain version's, and by K12_RECORDS key the
    rule's form's and the plain version's ms at that shape."""
    import torch
    from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as K
    gen = torch.Generator().manual_seed(2)
    worst, main_ms, main_plain_ms = 0.0, {}, None
    recs = {k: {} for k in K12_RECORDS}
    for t, b, h, dt in (BWD_SHAPES + CHAIN_K12_SHAPES + FRONTEND_K12_SHAPES
                        + [STREAMED_ONLY_SHAPE]):
        dtype = getattr(torch, dt)
        xg_f = torch.randn(t, b, 4 * h, generator=gen).to(dev, dtype)
        xg_b = torch.randn(t, b, 4 * h, generator=gen).to(dev, dtype)
        wh_f = (torch.randn(h, 4 * h, generator=gen) / h ** 0.5).to(dev)
        wh_b = (torch.randn(h, 4 * h, generator=gen) / h ** 0.5).to(dev)
        _, _, cs_f, cs_b, g_f, g_b = K.bilstm_recurrence(xg_f, xg_b, wh_f,
                                                         wh_b, stash=True)
        dy_f = torch.randn(t, b, h, generator=gen).to(dev, dtype)
        dy_b = torch.randn(t, b, h, generator=gen).to(dev, dtype)
        args = [wh_f, wh_b, cs_f, cs_b, g_f, g_b, dy_f, dy_b]
        ref = K.bilstm_recurrence_bwd_ref(*args)
        main = (t, b, h, dt) == MAIN_SHAPE
        if main:
            main_plain_ms = _time_ms(lambda: K.bilstm_recurrence_bwd_ref(
                *args), 2)
        rec = _record_key((t, b, h, dt))
        if rec is not None:
            recs[rec]["plain_ms"] = _time_ms(
                lambda: K.bilstm_recurrence_bwd_ref(*args), 2)
        ruled = K.form_for(h, dev, backward=True)
        if (t, b, h, dt) == STREAMED_ONLY_SHAPE and ruled != "streamed":
            raise AssertionError("K2 at H={} was expected to take the "
                                 "streamed form, the rule says {}".format(
                                     h, ruled))
        # the form the rule takes goes through the wrapper as a caller's
        # tensors do (form=None); the other one is asked for by name
        for form in K.FORMS:
            if form == "resident" and ruled != "resident":
                continue
            ask = None if form == ruled else form
            counts = (K.BWD_RESIDENT_LAUNCHES, K.BWD_STREAMED_LAUNCHES)
            out = K.bilstm_recurrence_bwd(*args, form=ask)
            torch.cuda.synchronize()
            took = (K.BWD_RESIDENT_LAUNCHES - counts[0],
                    K.BWD_STREAMED_LAUNCHES - counts[1])
            if took != ((1, 0) if form == "resident" else (0, 1)):
                raise AssertionError("K2 at H={} took {} where the {} form "
                                     "was expected".format(h, took, form))
            where = "{} form T={} B={} H={} {}".format(form, t, b, h, dt)
            _same_bits("K2 " + form, lambda: K.bilstm_recurrence_bwd(
                *args, form=ask), out, where)
            rel, early, full = _dxg_errors(out, ref)
            if rel > BWD_REL or early > EARLY_MEAN_TOL:
                raise AssertionError(
                    "K2 dxg differs from the plain version, {}: max rel "
                    "{:.3e} (tol {:.3e}), early mean {:.3e} (tol {})".format(
                        where, rel, BWD_REL, early, EARLY_MEAN_TOL))
            worst = max(worst, full)
            if (t, b, h, dt) in BWD_FAULT_SHAPES:
                _k2_planted_faults(K, args, out, where)
            ms = _time_ms(lambda: K.bilstm_recurrence_bwd(*args, form=ask),
                          10)
            if main:
                main_ms[form] = ms
            if rec is not None and ask is None:
                recs[rec]["ms"], recs[rec]["form"] = ms, form
            _say("kernel", "K2 {}: max|err| dxg {:.3e} (rel {:.3e}, tol "
                 "{:.3e}), early mean {:.3e} (tol {}); kernel {:.3f} ms, "
                 "{:.2f} us a step of both directions".format(
                     where, full, rel, BWD_REL, early, EARLY_MEAN_TOL, ms,
                     ms * 1e3 / t))
    t, b, h, dt = MAIN_SHAPE
    form = K.form_for(h, dev, backward=True)
    _say("kernel", "K2 at T={} B={} H={} {}: the rule takes the {} form; "
         "resident {:.3f} ms ({:.2f} us a step of both directions, {} blocks "
         "of {} bytes of shared memory), streamed {:.3f} ms ({:.2f} us), "
         "plain {:.3f} ms".format(
             t, b, h, dt, form, main_ms["resident"],
             main_ms["resident"] * 1e3 / t,
             2 * (K._padded(h) // K.TILE_UNITS),
             K.resident_bwd_smem_bytes(h), main_ms["streamed"],
             main_ms["streamed"] * 1e3 / t, main_plain_ms))
    for key, (t, b, h, dt) in K12_RECORDS.items():
        r = recs[key]
        _say("kernel", "K2 at T={} B={} H={} {} ({}), card {}: the {} form "
             "{:.3f} ms ({:.2f} us a step of both directions), plain {:.3f} "
             "ms".format(t, b, h, dt, key, _nvidia_smi(), r["form"], r["ms"],
                         r["ms"] * 1e3 / t, r["plain_ms"]))
    return worst, form, main_ms, main_plain_ms, recs


def _cold_ms(fn, reps):
    """Device time of one call of ``fn`` with a cold L2: a 64 MiB buffer
    (more than the card's 50 MB L2) is written before each call, and the
    writes' own time, read the same way, is taken off."""
    import torch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    both = _time_ms(lambda: (flush.fill_(1), fn()), reps)
    return both - _time_ms(lambda: flush.fill_(1), reps)


def phase_int8(dev):
    """K3 and K4 against their plain versions at every INT8_SHAPES shape
    (and a second launch against the first, bit for bit). Each shape's
    kernel time is device time alone (``_time_ms``); beside it the earlier
    event-pair reading, which spans the wrapper's host work, and that host
    time a call. At the main shape also the planted faults, the time with a
    cold L2 (``_cold_ms``) and the library call: the einsum of the port's
    bf16 value table (``value_table: 'bf16'``) on the table widened to bf16
    beforehand. Returns per kernel the fields of the kernels line."""
    import torch
    from e2e_asr_pytorch_tpu_torch.ops.kernels import int8_table as Q
    gen = torch.Generator().manual_seed(3)
    res = {"context_int8": {"max_abs_err": 0.0},
           "dattn_int8": {"max_abs_err": 0.0}}
    for b, t, d in INT8_SHAPES:
        values = torch.tanh(1.2 * torch.randn(b, t, d, generator=gen)).to(dev)
        q, scale = Q.quantize_table(values)
        attn = torch.softmax(torch.randn(b, t, generator=gen), -1).to(dev)
        a2 = attn * scale
        dctx = (0.1 * torch.randn(b, d, generator=gen)).to(dev)
        cases = {"context_int8": (Q.context_int8, Q.context_int8_ref, a2,
                                  "bt,btd->bd"),
                 "dattn_int8": (Q.dattn_int8, Q.dattn_int8_ref, dctx,
                                "bd,btd->bt")}
        main = (b, t, d) == INT8_SHAPES[0]
        line, hosts = [], []
        for name, (fn, ref_fn, small, eq) in cases.items():
            out = fn(small, q)
            again = fn(small, q)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                raise AssertionError("{} gave other bits on a second launch "
                                     "at {}".format(name, (b, t, d)))
            ref = ref_fn(small, q)
            err = (out - ref).abs().max().item()
            mag = ref.abs().max().item()
            if err > INT8_REL * mag:
                raise AssertionError("{} differs from the plain version at "
                                     "{}: max|err| {:.3e} vs |ref| {:.3e}"
                                     .format(name, (b, t, d), err, mag))
            r = res[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if main:
                faults = {
                    "q x2": torch.einsum(eq, Q._small_operand(small),
                                         2 * q.float()),
                    "f32 operand": torch.einsum(eq, small, q.float())}
                if name == "context_int8":
                    faults["the last t row dropped"] = ref_fn(
                        small[:, :-1], q[:, :-1])
                else:
                    faults["the last D column dropped"] = ref_fn(
                        small[:, :-1], q[:, :, :-1])
                for fault, bad in faults.items():
                    f_err = (out - bad).abs().max().item()
                    f_tol = INT8_REL * bad.abs().max().item()
                    if f_err <= f_tol:
                        raise AssertionError("planted fault '{}' passed the "
                                             "{} check".format(fault, name))
                    _say("fault", "{} B={} T={} D={}, plain version with {}: "
                         "max|err| {:.3e} (tol {:.3e}, {:.1f}x) -> caught"
                         .format(name, b, t, d, fault, f_err, f_tol,
                                 f_err / f_tol))
            ms = _time_ms(lambda: fn(small, q), 200)
            plain_ms = _time_ms(lambda: ref_fn(small, q), 20)
            old_ms = _event_pair_ms(lambda: fn(small, q), 20)
            host_ms = _host_ms(lambda: fn(small, q), 200)
            extra = ""
            if main:
                wide = (small.to(torch.bfloat16), q.to(torch.bfloat16))
                lib_ms = _time_ms(lambda: torch.einsum(eq, *wide), 200)
                cold = _cold_ms(lambda: fn(small, q), 50)
                r.update(ms=ms, cold_ms=cold, plain_ms=plain_ms,
                         library_ms=lib_ms, event_pair_ms=old_ms,
                         host_ms=host_ms)
                extra = (", with a cold L2 {:.5f} ms; library call (einsum "
                         "of bf16 operands) {:.5f} ms".format(cold, lib_ms))
            line.append("{} max|err| {:.3e} (tol {:.3e}), same bits twice, "
                        "kernel {:.5f} ms of device time{} (an event pair "
                        "around each call, the earlier reading: {:.4f} ms), "
                        "plain {:.4f} ms".format(name, err, INT8_REL * mag,
                                                 ms, extra, old_ms, plain_ms))
            hosts.append("{} {:.4f} ms".format(name, host_ms))
        _say("kernel", "B={} T={} D={}: {}".format(b, t, d, "; ".join(line)))
        _say("host", "B={} T={} D={}: the wrappers' host time a call (checks, "
             "casts, allocation, the ctypes launch; paid once a decode "
             "position): {}".format(b, t, d, ", ".join(hosts)))
    return res


def _bound(flops, nbytes):
    """(the least ms the card could take, which of the two binds)."""
    by_ops, by_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(by_ops, by_bytes), ("operations" if by_ops >= by_bytes
                                   else "bytes")


def _lstm_bound(t, b, h, dirs, wide_bytes=4, narrow_bytes=4):
    """One direction's recurrence over its streams, forward or backward:
    2*T*B*H*4H operations; bytes = the (T,B,4H) streams (``wide_bytes`` an
    element over them all), the (T,B,H) streams (``narrow_bytes``) and the
    bf16 w_h. The forward reads xg and writes the gate stash, ys and cs; the
    backward reads the gate stash, cs and dy and writes dxg. The defaults
    are bf16 streams: 2 + 2 bytes each way."""
    flops = dirs * 2.0 * t * b * h * 4 * h
    nbytes = dirs * (t * b * (4 * h * wide_bytes + h * narrow_bytes)
                     + h * 4 * h * 2)
    return _bound(flops, nbytes)


def _library_lstm(dev, t, b, in_dim, h, bidirectional, cell="LSTM"):
    """torch.nn.LSTM (or, with ``cell="GRU"``, torch.nn.GRU) on cuDNN in
    bf16 at (T,B,in_dim) -> H: ms of the forward, of forward + backward, of
    the backward alone (the forward run once outside the timed region, then
    ``torch.autograd.backward(out, grad, retain_graph=True)`` timed: dx and
    the weight gradients, the input projection's included), and of the
    input-projection matmul. Timed only; the port never calls it."""
    import torch
    lstm = getattr(torch.nn, cell)(in_dim, h, 1, bidirectional=bidirectional
                                   ).to(dev, torch.bfloat16)
    x = torch.randn(t, b, in_dim, device=dev, dtype=torch.bfloat16)
    dirs = 2 if bidirectional else 1
    gates = {"LSTM": 4, "GRU": 3}[cell]
    dy = torch.randn(t, b, dirs * h, device=dev, dtype=torch.bfloat16)
    w_x = torch.randn(in_dim, dirs * gates * h, device=dev,
                      dtype=torch.bfloat16)

    def fwd():
        with torch.no_grad():
            lstm(x)

    def fwd_bwd():
        xr = x.detach().requires_grad_()
        out, _ = lstm(xr)
        out.backward(dy)
        lstm.zero_grad(set_to_none=True)

    xr = x.detach().requires_grad_()
    out, _ = lstm(xr)

    def bwd():
        lstm.zero_grad(set_to_none=True)
        xr.grad = None
        torch.autograd.backward(out, dy, retain_graph=True)
    times = (_time_ms(fwd, 5), _time_ms(fwd_bwd, 5), _time_ms(bwd, 5),
             _time_ms(lambda: torch.matmul(x, w_x), 5))
    lstm.zero_grad(set_to_none=True)
    return times


def phase_lstm(dev):
    """K5f in both its forms, K5b, and K6f/K6b against their plain
    versions, the backward from the stashes of the rule's forward. Returns
    per kernel its worst max |err| and, at its main path's shape (the first
    of its list), the kernel, plain, bound and library times; for K5f the
    times of the form the rule takes (each form's under ``ms_by_form``); for
    K5f/K5b the same at their other main paths' shapes under the
    LSTM_RECORDS keys (``listener``, ``apc``, ``apc_upstream``)."""
    import torch
    from e2e_asr_pytorch_tpu_torch.ops.kernels import lstm as K
    gen = torch.Generator().manual_seed(5)
    names = {"resident": ("lstm_fwd", "lstm_bwd"),
             "chunked": ("lstm_fwd_chunked", "lstm_bwd_chunked")}
    res = {n: {"max_abs_err": 0.0} for pair in names.values() for n in pair}
    lm_shape = LSTM_SHAPES["resident"][0]

    def errors(out, ref, first_at_end):
        t = out.shape[0]
        k = min(EARLY_STEPS, t)
        d = (out.float() - ref.float()).abs()
        return d.max().item(), (d[t - k:] if first_at_end else d[:k]
                                ).mean().item()

    for kind, shapes in LSTM_SHAPES.items():
        f_name, b_name = names[kind]
        for t, b, h, dt, reverse in shapes:
            xg = torch.randn(t, b, 4 * h, generator=gen).to(
                dev, getattr(torch, dt))
            w_h = (torch.randn(h, 4 * h, generator=gen) / h ** 0.5).to(dev)
            dy = torch.randn(t, b, h, generator=gen).to(dev,
                                                        getattr(torch, dt))
            shape = (t, b, h, dt, reverse)
            main_shape = shape == shapes[0]
            record = LSTM_RECORDS.get(shape) if kind == "resident" else None
            listener = record is not None
            if kind == "resident":
                fwd_ref = lambda w=w_h: K.lstm_recurrence_ref(
                    xg, w, reverse, stash=True)
                bwd_ref = lambda w=w_h: K.lstm_recurrence_bwd_ref(
                    w, cs, gs, dy, reverse)
                ruled = K.form_for(h, b, dev)
                # the rule's form first: its times are the shape's
                forms = [ruled] + [f for f in K.FORMS if f != ruled]
            else:
                fwd_ref = lambda w=w_h: K.lstm_recurrence_chunked_ref(
                    xg, w, stash=True)
                bwd_ref = lambda w=w_h: K.lstm_recurrence_chunked_bwd_ref(
                    w, cs, gs, dy)
                ruled, forms = None, [None]
            ref = fwd_ref()
            ms_by_form = {}
            for form in forms:
                if kind == "resident":
                    # each form of K5f launched whatever the rule would
                    # pick; K5b (one form) after the rule's
                    fwd = lambda w=w_h, f=form: K._launch_fwd(
                        xg, w, reverse, True, f)
                    bwd = lambda w=w_h: K.lstm_bwd(w, cs, gs, dy, reverse)
                else:
                    fwd = lambda w=w_h: K.lstm_fwd_chunked(xg, w, stash=True)
                    bwd = lambda w=w_h: K.lstm_bwd_chunked(w, cs, gs, dy)
                where = "T={} B={} H={} {}{}{}".format(
                    t, b, h, dt, " reversed" * reverse,
                    "" if form is None else ", {} form{}".format(
                        form, " (the rule's)" * (form == ruled)))
                out = fwd()
                torch.cuda.synchronize()
                _same_bits("K5f " + form if kind == "resident" else "K6f",
                           fwd, out, where)
                full, early = errors(out[0], ref[0], reverse)
                if full > TOL[dt] or early > LSTM_EARLY_MEAN_TOL:
                    raise AssertionError(
                        "{} ys differ from the plain version at {}: max "
                        "{:.3e} (tol {}), early mean {:.3e} (tol {})".format(
                            f_name, where, full, TOL[dt], early,
                            LSTM_EARLY_MEAN_TOL))
                for o, r in zip(out[1:], ref[1:]):
                    bound = TOL[dt] + r.float().abs() * STASH_REL
                    if not bool(((o.float() - r.float()).abs()
                                 <= bound).all()):
                        raise AssertionError("{} stash differs at {}".format(
                            f_name, where))
                res[f_name]["max_abs_err"] = max(res[f_name]["max_abs_err"],
                                                 full)
                ms_by_form[form] = _time_ms(fwd, 10)
                if form != ruled:
                    _say("kernel", "{} {}: max|err| ys {:.3e} (tol {}), early "
                         "mean {:.3e} (tol {}); kernel {:.3f} ms".format(
                             f_name, where, full, TOL[dt], early,
                             LSTM_EARLY_MEAN_TOL, ms_by_form[form]))
                    continue
                ys, cs, gs = out
                dxg = bwd()
                torch.cuda.synchronize()
                _same_bits("K5b" if kind == "resident" else "K6b", bwd, dxg,
                           where)
                rdxg = bwd_ref()
                b_full, b_early = errors(dxg, rdxg, not reverse)
                b_rel = b_full / rdxg.float().abs().max().item()
                if b_rel > BWD_REL or b_early > LSTM_EARLY_MEAN_TOL:
                    raise AssertionError(
                        "{} dxg differs from the plain version at {}: max rel "
                        "{:.3e} (tol {:.3e}), early mean {:.3e} (tol {})"
                        .format(b_name, where, b_rel, BWD_REL, b_early,
                                LSTM_EARLY_MEAN_TOL))
                res[b_name]["max_abs_err"] = max(res[b_name]["max_abs_err"],
                                                 b_full)
                # planted faults: K6 at its main shape, K5f's narrow form
                # and K5b at the listener's shapes, K5f's wide form and K5b
                # at the LM's (each the rule's form there)
                if ((kind == "chunked" and main_shape)
                        or (form == "narrow" and shape in (
                            LSTM_LISTENER_SHAPE, LSTM_FAULT_SHAPE,
                            APC_SHAPE))
                        or (form == "wide" and shape == lm_shape)):
                    _lstm_planted_faults(K, where, dt, reverse, ys, dxg, w_h,
                                         fwd_ref, bwd_ref, errors, f_name,
                                         b_name)
                b_ms = _time_ms(bwd, 10)
                plain_ms = _time_ms(fwd_ref, 2)
                b_plain_ms = _time_ms(bwd_ref, 2)
                _say("kernel", "{} {}: max|err| ys {:.3e} (tol {}), early "
                     "mean {:.3e} (tol {}); kernel {:.3f} ms, plain {:.3f} ms "
                     "| {}: max|err| dxg {:.3e} (rel {:.3e}, tol {:.3e}), "
                     "early mean {:.3e}; kernel {:.3f} ms, plain {:.3f} "
                     "ms".format(
                         f_name, where, full, TOL[dt], early,
                         LSTM_EARLY_MEAN_TOL, ms_by_form[form], plain_ms,
                         b_name, b_full, b_rel, BWD_REL, b_early, b_ms,
                         b_plain_ms))
            ms = ms_by_form[ruled]
            if main_shape and kind == "chunked":
                _k6f_extras(K, dev, w_h, t, b, h, ms)
                _k6b_extras(K, dev, w_h, t, b, h, b_ms)
            if main_shape or listener:
                lib_f, lib_fb, lib_b, lib_xg = _library_lstm(dev, t, b, h, h,
                                                             False)
                # the gate stash and cs are bf16; xg, ys and dy in the
                # stream's dtype, dxg in K5b's / K6b's
                nb = xg.element_size()
                f_bound = _lstm_bound(t, b, h, 1, nb + 2, nb + 2)
                b_bound = _lstm_bound(t, b, h, 1, 2 + dxg.element_size(),
                                      nb + 2)
                f_times = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_f,
                               library_xg_ms=lib_xg, bound_ms=f_bound[0],
                               bound_by=f_bound[1])
                b_times = dict(ms=b_ms, plain_ms=b_plain_ms,
                               library_ms=lib_fb, library_bwd_ms=lib_b,
                               library_xg_ms=lib_xg, bound_ms=b_bound[0],
                               bound_by=b_bound[1])
                if kind == "resident":
                    f_times.update(form=ruled, ms_by_form=ms_by_form)
                if listener:
                    label = "T={} B={} H={} {}".format(t, b, h, dt)
                    f_times = {record: dict(f_times, shape=label)}
                    b_times = {record: dict(b_times, shape=label)}
                res[f_name].update(f_times)
                res[b_name].update(b_times)
                _say("kernel", "{} / {} at T={} B={} H={}{}: bound {:.3f} ms "
                     "({}) / {:.3f} ms ({}); library call torch.nn.LSTM "
                     "(cuDNN, bf16, input projection included) forward "
                     "{:.3f} ms, forward + backward {:.3f} ms, backward alone "
                     "{:.3f} ms; the xg matmul alone {:.3f} ms".format(
                         f_name, b_name, t, b, h,
                         "" if ruled is None else " (the rule's form: {})"
                         .format(ruled), f_bound[0], f_bound[1], b_bound[0],
                         b_bound[1], lib_f, lib_fb, lib_b, lib_xg))
    return res


def _k6f_extras(K, dev, w_h, t, b, h, ms):
    """K6f at its main shape: its layout on this card and microseconds per
    step, and the wrapper's packing kernel against the plain packing."""
    import torch
    hp, tiles_per_block, resident = K.chunked_plan(h, dev)
    n_kt = hp // K._K_TILE
    if not 0 < resident < n_kt:
        raise AssertionError("K6f at H={}: {} of {} k-tiles resident".format(
            h, resident, n_kt))
    packed = K.pack_chunked_on_card(w_h, hp)
    torch.cuda.synchronize()
    if not torch.equal(packed, K.pack_chunked(w_h, hp)):
        raise AssertionError("K6f's packing kernel and the plain packing "
                             "differ at H={}".format(h))
    pack_ms = _time_ms(lambda: K.pack_chunked_on_card(w_h, hp), 10)
    _say("kernel", "lstm_fwd_chunked at T={} B={} H={}: {:.3f} ms, {:.2f} us "
         "a step; {} tile(s) a block, {} of {} k-tiles of w_h resident ({} "
         "bytes of shared memory a block); packing w_h {:.3f} ms of the "
         "launch, equal to the plain packing".format(
             t, b, h, ms, ms * 1e3 / t, tiles_per_block, resident, n_kt,
             K.chunked_smem_bytes(h, dev), pack_ms))


def _k6b_extras(K, dev, w_h, t, b, h, ms):
    """K6b at its main shape: its layout on this card, microseconds per step,
    and the wrapper's packing kernel against the plain packing."""
    import torch
    hp, tiles_per_block, resident = K.chunked_bwd_plan(h, b, dev)
    n_kt = 4 * hp // K._K_TILE
    if not 0 < resident < n_kt:
        raise AssertionError("K6b at H={}: {} of {} k-tiles resident".format(
            h, resident, n_kt))
    packed = K.pack_chunked_bwd_on_card(w_h, hp)
    torch.cuda.synchronize()
    if not torch.equal(packed, K.pack_chunked_bwd(w_h, hp)):
        raise AssertionError("K6b's packing kernel and the plain packing "
                             "differ at H={}".format(h))
    pack_ms = _time_ms(lambda: K.pack_chunked_bwd_on_card(w_h, hp), 10)
    _say("kernel", "lstm_bwd_chunked at T={} B={} H={}: {:.3f} ms, {:.2f} us "
         "a step; {} tile(s) of 32 units x 64 rows a block, {} of {} k-tiles "
         "of each slab resident ({} bytes of shared memory a block); packing "
         "w_h {:.3f} ms of the launch, equal to the plain packing".format(
             t, b, h, ms, ms * 1e3 / t, tiles_per_block, resident, n_kt,
             K.chunked_bwd_smem_bytes(h, b, dev), pack_ms))


def _lstm_planted_faults(K, where, dt, reverse, ys, dxg, w_h, fwd_ref,
                         bwd_ref, errors, f_name, b_name):
    """The kernels' outputs held against plain versions with a doubled w_h
    and with an f32 operand in place of the bf16 one must fail."""
    def unrounded(ref_fn):
        sound = K._h_operand, K._dg_operand
        K._h_operand = K._dg_operand = lambda x: x
        try:
            return ref_fn()
        finally:
            K._h_operand, K._dg_operand = sound
    faults = {"w_h x2": (lambda: fwd_ref(2 * w_h)[0],
                         lambda: bwd_ref(2 * w_h)),
              "f32 operand": (lambda: unrounded(fwd_ref)[0],
                              lambda: unrounded(bwd_ref))}
    for fault, (bad_fwd, bad_bwd) in faults.items():
        full, early = errors(ys, bad_fwd(), reverse)
        if full <= TOL[dt] and early <= LSTM_EARLY_MEAN_TOL:
            raise AssertionError("planted fault '{}' passed the {} checks at "
                                 "{}".format(fault, f_name, where))
        bad = bad_bwd()
        b_full, b_early = errors(dxg, bad, not reverse)
        b_rel = b_full / bad.float().abs().max().item()
        if b_rel <= BWD_REL and b_early <= LSTM_EARLY_MEAN_TOL:
            raise AssertionError("planted fault '{}' passed the {} checks at "
                                 "{}".format(fault, b_name, where))
        _say("fault", "{} at {}, plain version with {}: max|err| ys {:.3e} "
             "(tol {}), early mean {:.3e} (tol {}) -> caught | {}: max rel "
             "{:.3e} (tol {:.3e}), early mean {:.3e} -> caught".format(
                 f_name, where, fault, full, TOL[dt], early, LSTM_EARLY_MEAN_TOL,
                 b_name, b_rel, BWD_REL, b_early))


def _gru_bound(t, b, h, gates, stream_bytes, backward, dhg, small_bytes,
               dirs=1):
    """``dirs`` directions of a GRU (gates=3) or light-GRU (gates=2)
    recurrence: 2*T*B*H*gates*H operations each. The forward reads the
    (T,B,gates*H) xg stream and w_h in bf16, and writes ys and the bf16
    stash; the backward reads xg, the stash, bf16 ys, dy and the same
    weights and writes dxg (and, with ``dhg``, the f32 dhg). ``small_bytes``
    is what all directions read of b_h or the mask (the light GRU's pair
    shares one)."""
    flops = dirs * 2.0 * t * b * h * gates * h
    wide, narrow = t * b * gates * h, t * b * h
    nbytes = h * gates * h * 2
    if backward:
        nbytes += wide * (2 * stream_bytes + 2 + (4 if dhg else 0))
        nbytes += narrow * (2 + stream_bytes)
    else:
        nbytes += wide * (stream_bytes + 2) + narrow * stream_bytes
    return _bound(flops, dirs * nbytes + small_bytes)


def _gru_errors(out, ref, first_at_end, floor):
    """(max |err|, the same and the early steps' mean |err| over the
    reference's range, which counts as at least ``floor``)."""
    t = out.shape[0]
    k = min(EARLY_STEPS, t)
    d = (out.float() - ref.float()).abs()
    mag = max(ref.float().abs().max().item(), floor)
    early = (d[t - k:] if first_at_end else d[:k]).mean().item()
    return d.max().item(), d.max().item() / mag, early / mag


class _GruDirection:
    """One direction of a K7 (``kind`` "gru") or K8 ("ligru") walk on seeded
    operands, and the plain versions and kernels that hold it: the forward's
    ys and stash (from whichever form made them) against the plain forward,
    then the backward's outputs from that stash (from whichever form made
    them) against the plain backward. ``other`` is the pair's other
    direction, once the two are held as one launch."""

    def __init__(self, kind, K, xg, w_h, small, dy, reverse):
        self.kind, self.K = kind, K
        self.xg, self.w_h, self.small, self.dy = xg, w_h, small, dy
        self.reverse = reverse
        self.other = None

    def fwd_ref(self, w=None, m=None, k_halves=False):
        w = self.w_h if w is None else w
        m = self.small if m is None else m
        if self.kind == "gru":
            return self.K.gru_recurrence_ref(self.xg, w, m, self.reverse,
                                             stash=True)
        return self.K.ligru_recurrence_ref(self.xg, w, m, self.reverse,
                                           stash=True, k_halves=k_halves)

    def bwd(self, hgs, ys16):
        if self.kind == "gru":
            return self.K.gru_bwd(self.xg, self.w_h, hgs, ys16, self.dy,
                                  self.reverse)
        return (self.K.ligru_bwd(self.xg, self.w_h, self.small, hgs, ys16,
                                 self.dy, self.reverse),)

    def bwd_ref(self, hgs, ys16, w=None, m=None, **fault):
        w = self.w_h if w is None else w
        m = self.small if m is None else m
        if self.kind == "gru":
            return self.K.gru_recurrence_bwd_ref(self.xg, w, hgs, ys16,
                                                 self.dy, self.reverse,
                                                 **fault)
        return (self.K.ligru_recurrence_bwd_ref(self.xg, w, m, hgs, ys16,
                                                self.dy, self.reverse),)

    def ys_bound(self, rys, dt):
        """The whole-sequence bound of ys: TOL, and for the light GRU on f32
        streams max(TOL, 2 x the plain version's own spread on these
        operands: its walk with the recurrent product summed in two k
        halves against its one-product walk). Returns (bound, spread or
        None)."""
        if self.kind != "ligru" or dt != "float32":
            return TOL[dt], None
        spread = _gru_errors(self.fwd_ref(k_halves=True)[0], rys,
                             self.reverse, 1.0)[1]
        return max(TOL[dt], 2.0 * spread), spread

    def hold_fwd(self, ys, hgs, f_name, where, dt):
        """Raises unless the forward's ys and stash agree with the plain
        version under the ys bound, STASH_REL and GRU_EARLY_MEAN_TOL. Keeps
        what the backward and the planted faults are held against; returns
        the max |err| of ys."""
        import torch
        early_tol = GRU_EARLY_MEAN_TOL[dt]
        self.ys, self.hgs = ys, hgs
        rys, rhgs = self.fwd_ref()
        self.ys_tol, spread = self.ys_bound(rys, dt)
        full, rel, early = _gru_errors(ys, rys, self.reverse, 1.0)
        if (rel > self.ys_tol or early > early_tol
                or not bool(torch.isfinite(ys.float()).all())):
            raise AssertionError(
                "{} ys differ from the plain version at {}: max {:.3e} "
                "(rel {:.3e}, tol {:.3e}), early mean {:.3e} (tol {})".format(
                    f_name, where, full, rel, self.ys_tol, early, early_tol))
        # the stash is made of bf16(h): a flipped rounding of h moves it by
        # a bf16 ulp of h times w_h whatever the stream's dtype
        mag = max(rhgs.float().abs().max().item(), 1.0)
        bound = TOL["bfloat16"] * mag + rhgs.float().abs() * STASH_REL
        if not bool(((hgs.float() - rhgs.float()).abs() <= bound).all()):
            raise AssertionError("{} stash differs at {}".format(f_name,
                                                                 where))
        self.ys16 = ys.to(torch.bfloat16)
        self.line = ("max|err| ys {:.3e} (rel {:.3e}, tol {:.3e}{}), early "
                     "mean {:.3e} (tol {}), max |ys| {:.2f}".format(
                         full, rel, self.ys_tol, "" if spread is None else
                         ": the plain version's own spread {:.3e}".format(
                             spread),
                         early, early_tol, rys.float().abs().max().item()))
        return full

    def hold_bwd(self, douts, b_name, where, dt):
        """Raises unless the backward's outputs from this direction's stash
        agree with the plain backward under BWD_REL and GRU_EARLY_MEAN_TOL.
        Returns their max |err|."""
        import torch
        early_tol = GRU_EARLY_MEAN_TOL[dt]
        self.douts = douts
        b_full, b_rel, b_early = self.bwd_errors(self.bwd_ref(self.hgs,
                                                              self.ys16))
        if (b_rel > BWD_REL or b_early > early_tol or not all(
                bool(torch.isfinite(o.float()).all()) for o in douts)):
            raise AssertionError(
                "{} differs from the plain version at {}: max rel {:.3e} "
                "(tol {:.3e}), early mean {:.3e} (tol {})".format(
                    b_name, where, b_rel, BWD_REL, b_early, early_tol))
        self.line += " | {}: max|err| {:.3e} (rel {:.3e}, tol {:.3e}), " \
            "early mean {:.3e}".format(b_name, b_full, b_rel, BWD_REL,
                                       b_early)
        return b_full

    def hold(self, ys, hgs, f_name, b_name, where, dt):
        """The forward's ys and stash, then the single-form backward kernel
        run from that stash; returns the (forward, backward) max |err|."""
        import torch
        full = self.hold_fwd(ys, hgs, f_name, where, dt)
        douts = self.bwd(hgs, self.ys16)
        torch.cuda.synchronize()
        return full, self.hold_bwd(douts, b_name, where, dt)

    def fwd_errors(self, ref):
        return _gru_errors(self.ys, ref[0], self.reverse, 1.0)

    def bwd_errors(self, ref):
        """The worst of the backward's outputs (dxg; dhg too for the GRU),
        each over max |dxg| of the reference."""
        pairs = [_gru_errors(o, r, not self.reverse, 1e-30)
                 for o, r in zip(self.douts, ref)]
        return tuple(max(p[i] for p in pairs) for i in range(3))

    def faults(self):
        """name -> (plain forward with the fault or None, plain backward
        with it) against this direction's kernel outputs."""
        K, hgs, ys16 = self.K, self.hgs, self.ys16

        def unrounded(ref_fn):
            sound = K._h_operand, K._dg_operand
            K._h_operand = K._dg_operand = lambda x: x
            try:
                return ref_fn()
            finally:
                K._h_operand, K._dg_operand = sound
        w2 = 2 * self.w_h
        out = {"w_h x2": (lambda: self.fwd_ref(w=w2),
                          lambda: self.bwd_ref(hgs, ys16, w=w2)),
               "f32 operand": (lambda: unrounded(self.fwd_ref),
                               lambda: unrounded(
                                   lambda: self.bwd_ref(hgs, ys16)))}
        if self.other is not None:
            # the other direction's operands walked in this one's order
            o = self.other
            swapped = _GruDirection(self.kind, K, o.xg, o.w_h, o.small, o.dy,
                                    self.reverse)
            out["the two directions' operands swapped"] = (
                None, lambda: swapped.bwd_ref(o.hgs, o.ys16))
        if self.kind == "gru":
            out["dxn and dxn*r swapped"] = (
                None, lambda: self.bwd_ref(hgs, ys16, swap_n_slot=True))
        else:
            ones = self.small.new_ones(self.small.shape)
            out["no mask"] = (lambda: self.fwd_ref(m=ones),
                              lambda: self.bwd_ref(hgs, ys16, m=ones))
        return out

    def check_faults(self, f_name, b_name, where, dt):
        """Every planted fault must fail the checks the sound plain versions
        pass; each line gives the fault's margin, the largest of its
        readings over their bounds."""
        early_tol = GRU_EARLY_MEAN_TOL[dt]
        for fault, (bad_fwd, bad_bwd) in self.faults().items():
            line = []
            if bad_fwd is not None:
                _, f_rel, f_early = self.fwd_errors(bad_fwd())
                if f_rel <= self.ys_tol and f_early <= early_tol:
                    raise AssertionError(
                        "planted fault '{}' passed the {} checks at {}: max "
                        "rel {:.3e}, early mean {:.3e}".format(
                            fault, f_name, where, f_rel, f_early))
                line.append("{}: max rel {:.3e} (tol {:.3e}), early mean "
                            "{:.3e} (tol {}) -> caught, margin {:.3g}x"
                            .format(f_name, f_rel, self.ys_tol, f_early,
                                    early_tol, max(f_rel / self.ys_tol,
                                                   f_early / early_tol)))
            _, b_rel, b_early = self.bwd_errors(bad_bwd())
            if b_rel <= BWD_REL and b_early <= early_tol:
                raise AssertionError(
                    "planted fault '{}' passed the {} checks at {}: max rel "
                    "{:.3e}, early mean {:.3e}".format(fault, b_name, where,
                                                       b_rel, b_early))
            line.append("{}: max rel {:.3e} (tol {:.3e}), early mean {:.3e} "
                        "-> caught, margin {:.3g}x".format(
                            b_name, b_rel, BWD_REL, b_early,
                            max(b_rel / BWD_REL, b_early / early_tol)))
            _say("fault", "{}, plain version with {}: {}".format(
                where, fault, " | ".join(line)))


def phase_gru(dev):
    """K7f/K7b and K8f/K8b against their plain versions, the backward from
    the stash and the bf16 hidden stream its forward kernel made: at every
    shape of GRU_SHAPES the single forms over the shape's direction, then a
    direction pair through the packed forms (one forward launch, then one
    backward launch from its stashes; forward and backward directions on
    operands of their own, the light GRU's mask shared). Returns per kernel
    its worst max |err| and, at its main path's shape (the first of
    GRU_SHAPES), the kernel, plain, bound and library times over both
    directions of the layer in each form (``ms_by_form``), the rule's form
    under ``ms``."""
    import torch
    from e2e_asr_pytorch_tpu_torch.ops.kernels import gru as KG
    from e2e_asr_pytorch_tpu_torch.ops.kernels import ligru as KLG
    gen = torch.Generator().manual_seed(7)
    res = {n: {"max_abs_err": 0.0}
           for n in ("gru_fwd", "gru_bwd", "ligru_fwd", "ligru_bwd")}

    for kind, K, gates in (("gru", KG, 3), ("ligru", KLG, 2)):
        f_name, b_name = kind + "_fwd", kind + "_bwd"

        def direction(t, b, h, dt, reverse):
            """Seeded operands of one direction."""
            dtype = getattr(torch, dt)
            xg = torch.randn(t, b, gates * h, generator=gen).to(dev, dtype)
            w_h = (torch.randn(h, gates * h, generator=gen) / h ** 0.5
                   ).to(dev)
            dy = torch.randn(t, b, h, generator=gen).to(dev, dtype)
            if kind == "gru":
                small = (0.3 * torch.randn(3 * h, generator=gen)).to(dev)
            else:
                small = ((torch.rand(b, h, generator=gen) < 0.7).float()
                         / 0.7).to(dev)
            return _GruDirection(kind, K, xg, w_h, small, dy, reverse)

        def note_err(fwd_err, bwd_err):
            res[f_name]["max_abs_err"] = max(res[f_name]["max_abs_err"],
                                             fwd_err)
            res[b_name]["max_abs_err"] = max(res[b_name]["max_abs_err"],
                                             bwd_err)

        # the single forms, one direction a launch, at every shape
        singles = {}
        for t, b, h, dt, reverse in GRU_SHAPES:
            d = singles[(t, b, h, dt, reverse)] = direction(t, b, h, dt,
                                                            reverse)
            where = "T={} B={} H={} {}{}".format(t, b, h, dt,
                                                 " reversed" * reverse)
            fwd = (lambda: K.gru_fwd(d.xg, d.w_h, d.small, reverse,
                                     stash=True)) if kind == "gru" else (
                lambda: K.ligru_fwd(d.xg, d.w_h, d.small, reverse,
                                    stash=True))
            ys, hgs = fwd()
            torch.cuda.synchronize()
            k_label = "K7" if kind == "gru" else "K8"
            _same_bits(k_label + "f single", fwd, (ys, hgs), where)
            note_err(*d.hold(ys, hgs, f_name, b_name, where, dt))
            _same_bits(k_label + "b single", lambda: d.bwd(hgs, d.ys16), None,
                       where)
            if (t, b, h, dt, reverse) == GRU_FAULT_SHAPE:
                d.check_faults(f_name, b_name, where + " (single forms)", dt)
            ms = _time_ms(fwd, 10)
            b_ms = _time_ms(lambda: d.bwd(hgs, d.ys16), 10)
            plain_ms = _time_ms(d.fwd_ref, 2)
            b_plain_ms = _time_ms(lambda: d.bwd_ref(hgs, d.ys16), 2)
            _say("kernel", "{} (single forms) {}: {}; kernel {:.3f} ms, "
                 "plain {:.3f} ms, backward kernel {:.3f} ms, plain {:.3f} "
                 "ms".format(f_name, where, d.line, ms, plain_ms, b_ms,
                             b_plain_ms))
            if (t, b, h, dt, reverse) == GRU_SHAPES[0]:
                res[f_name].update(single_one_direction_ms=ms)
                res[b_name].update(single_one_direction_ms=b_ms)

        # the packed forms: each shape as a direction pair, one forward
        # launch and one backward launch from its stashes, on the single
        # forms' operands of the shape. Where GRU_SHAPES lists it both ways,
        # each direction has the operands of its single run (the light GRU's
        # mask the forward one's, shared). Where it lists it forward only,
        # the backward direction mirrors the forward one: its xg and dy
        # reversed in time, a copy of its weights; each launch's two halves
        # must then give mirror images, bit for bit.
        pairs = []
        for t, b, h, dt, _ in GRU_SHAPES:
            if (t, b, h, dt) not in pairs:
                pairs.append((t, b, h, dt))
        for t, b, h, dt in pairs:
            f1 = singles[(t, b, h, dt, False)]
            fw = _GruDirection(kind, K, f1.xg, f1.w_h, f1.small, f1.dy, False)
            b1 = singles.get((t, b, h, dt, True))
            mirrored = b1 is None
            if mirrored:
                bw = _GruDirection(
                    kind, K, f1.xg.flip(0).contiguous(), f1.w_h.clone(),
                    f1.small.clone() if kind == "gru" else fw.small,
                    f1.dy.flip(0).contiguous(), True)
            else:
                bw = _GruDirection(kind, K, b1.xg, b1.w_h,
                                   b1.small if kind == "gru" else fw.small,
                                   b1.dy, True)
            fw.other, bw.other = bw, fw
            where = "T={} B={} H={} {}, both directions".format(t, b, h, dt)
            bias = (fw.small, bw.small) if kind == "gru" else (fw.small,)
            mask = () if kind == "gru" else (fw.small,)

            def launch(form, stash=True):
                return K._launch_fwd_pair(fw.xg, bw.xg, fw.w_h, bw.w_h,
                                          *bias, stash, form)

            def launch_bwd(form):
                return K._launch_bwd_pair(fw.xg, bw.xg, fw.w_h, bw.w_h,
                                          *mask, fw.hgs, bw.hgs, fw.ys16,
                                          bw.ys16, fw.dy, bw.dy, form)

            def by_direction(outs):
                """(dxg_f, dxg_b[, dhg_f, dhg_b]) -> each direction's."""
                return ([(outs[0], outs[2]), (outs[1], outs[3])]
                        if kind == "gru" else [(outs[0],), (outs[1],)])
            ys_f, ys_b, hgs_f, hgs_b = launch("packed")
            torch.cuda.synchronize()
            k_label = "K7" if kind == "gru" else "K8"
            _same_bits(k_label + "f packed", lambda: launch("packed"),
                       (ys_f, ys_b, hgs_f, hgs_b), where)
            lines = []
            if mirrored:
                if not (torch.equal(ys_b.flip(0), ys_f)
                        and torch.equal(hgs_b.flip(0), hgs_f)):
                    raise AssertionError(
                        "{} at {}: the backward half of the packed launch "
                        "does not mirror the forward one".format(f_name,
                                                                 where))
            fwd_errs = [d.hold_fwd(ys, hgs, f_name, "{}, {} direction".format(
                            where, label), dt)
                        for d, ys, hgs, label in (
                            (fw, ys_f, hgs_f, "forward"),
                            (bw, ys_b, hgs_b, "backward"))]
            douts = by_direction(launch_bwd("packed"))
            torch.cuda.synchronize()
            _same_bits(k_label + "b packed", lambda: launch_bwd("packed"),
                       None, where)
            if mirrored:
                if not all(torch.equal(b_out.flip(0), f_out)
                           for f_out, b_out in zip(*douts)):
                    raise AssertionError(
                        "{} at {}: the backward half of the packed launch "
                        "does not mirror the forward one".format(b_name,
                                                                 where))
                lines.append("the backward halves of both packed launches "
                             "mirror the forward ones bit for bit")
            for d, outs, f_err, label in ((fw, douts[0], fwd_errs[0],
                                           "forward"),
                                          (bw, douts[1], fwd_errs[1],
                                           "backward")):
                note_err(f_err, d.hold_bwd(outs, b_name, "{}, {} direction"
                                           .format(where, label), dt))
                lines.append("{} direction: {}".format(label, d.line))
                if (t, b, h, dt, False) == GRU_FAULT_SHAPE:
                    d.check_faults(f_name, b_name, "{} (packed forms, {} "
                                   "direction)".format(where, label), dt)
            packed_ms = _time_ms(lambda: launch("packed"), 10)
            b_packed_ms = _time_ms(lambda: launch_bwd("packed"), 10)
            plain_ms = _time_ms(lambda: (fw.fwd_ref(), bw.fwd_ref()), 2)
            _say("kernel", "{} / {} (packed forms) {}: {}; one forward launch "
                 "{:.3f} ms, plain (both directions) {:.3f} ms; one backward "
                 "launch {:.3f} ms".format(f_name, b_name, where,
                                           " || ".join(lines), packed_ms,
                                           plain_ms, b_packed_ms))
            if (t, b, h, dt) != GRU_SHAPES[0][:4]:
                continue
            single_ms = _time_ms(lambda: launch("single"), 10)
            b_single_ms = _time_ms(lambda: launch_bwd("single"), 10)
            b_plain_ms = _time_ms(lambda: (fw.bwd_ref(fw.hgs, fw.ys16),
                                           bw.bwd_ref(bw.hgs, bw.ys16)), 2)
            small_bytes = sum(x.numel() * x.element_size() for x in bias)
            mask_bytes = sum(x.numel() * x.element_size() for x in mask)
            f_bound = _gru_bound(t, b, h, gates, 2, False, False,
                                 small_bytes, dirs=2)
            b_bound = _gru_bound(t, b, h, gates, 2, True, kind == "gru",
                                 mask_bytes, dirs=2)
            # the wrapper packs both w_h into the form's tiles on every
            # launch (inside ``ms``): what that costs
            pack_ms = _time_ms(lambda: KG.pack_w_pair(fw.w_h, bw.w_h,
                                                      gates), 10)
            form = K.form_for(h, True, dev)
            b_form = K.form_for(h, True, dev, backward=True)
            by_form = {"packed": packed_ms, "single": single_ms}
            b_by_form = {"packed": b_packed_ms, "single": b_single_ms}
            per = "both directions of one layer"
            res[f_name].update(
                ms=by_form[form], form=form, ms_by_form=by_form,
                plain_ms=plain_ms, bound_ms=f_bound[0], bound_by=f_bound[1],
                library_ms=None, pack_w_ms=pack_ms, per=per)
            res[b_name].update(
                ms=b_by_form[b_form], form=b_form, ms_by_form=b_by_form,
                plain_ms=b_plain_ms, bound_ms=b_bound[0],
                bound_by=b_bound[1], library_ms=None, per=per)
            note = ("no single PyTorch call computes a light GRU: no library "
                    "time")
            if kind == "gru":
                # the two readings of one ms-scale launch, once
                b_pair_ms = _event_pair_ms(lambda: launch_bwd("packed"), 10)
                lib_f, lib_fb, lib_b, lib_xg = _library_lstm(
                    dev, t, b, 2 * h, h, True, cell="GRU")
                res[f_name].update(library_ms=lib_f, library_xg_ms=lib_xg)
                res[b_name].update(library_ms=lib_fb, library_bwd_ms=lib_b,
                                   library_xg_ms=lib_xg,
                                   event_pair_ms=b_pair_ms)
                note = ("library call torch.nn.GRU (cuDNN, bf16, "
                        "bidirectional, 2H-wide input, projection included) "
                        "forward {:.3f} ms, forward + backward {:.3f} ms, "
                        "backward alone {:.3f} ms, the two xg matmuls alone "
                        "{:.3f} ms; the packed {} launch read with an event "
                        "pair around each call (the earlier helper) {:.3f} "
                        "ms against {:.3f} ms of device time".format(
                            lib_f, lib_fb, lib_b, lib_xg, b_name, b_pair_ms,
                            b_packed_ms))
            _say("kernel", "{} at {}: the rule's form {}; packed (one launch) "
                 "{:.3f} ms ({:.2f} us a step), single (two launches) {:.3f} "
                 "ms, one single launch {:.3f} ms; bound (both directions) "
                 "{:.3f} ms ({}); packing both w_h {:.3f} ms of the packed "
                 "launch".format(f_name, where, form, packed_ms,
                                 packed_ms / t * 1e3, single_ms,
                                 res[f_name]["single_one_direction_ms"],
                                 f_bound[0], f_bound[1], pack_ms))
            _say("kernel", "{} at {}: the rule's form {}; packed (one launch) "
                 "{:.3f} ms ({:.2f} us a step), single (two launches) {:.3f} "
                 "ms, one single launch {:.3f} ms; plain (both directions) "
                 "{:.3f} ms; bound (both directions) {:.3f} ms ({}); {}"
                 .format(b_name, where, b_form, b_packed_ms,
                         b_packed_ms / t * 1e3, b_single_ms,
                         res[b_name]["single_one_direction_ms"], b_plain_ms,
                         b_bound[0], b_bound[1], note))
    return res


def _write_slice_configs(tmp, model=None):
    """The flagship model block (or ``model``), the published decode block
    and the LM model block, over the synthetic corpus. Returns the test
    config's path and the ASR and LM model blocks; the checkpoints it names
    come from _write_checkpoints."""
    import yaml

    def load(name):
        with open(os.path.join(ROOT, "config", name)) as f:
            return yaml.safe_load(f)
    asr_cfg = load("librispeech_asr_best.yaml")
    test_cfg = load("librispeech_test.yaml")
    lm_cfg = load("librispeech_lm_best.yaml")
    text = dict(asr_cfg["data"]["text"])
    text["vocab_file"] = os.path.join(ROOT, text["vocab_file"])
    corpus = {"name": "synthetic", "path": "", "batch_size": 8,
              "n_utts": 16, "min_tokens": 20, "max_tokens": 80}
    train = {"data": {"corpus": dict(corpus, train_split=["train"],
                                     dev_split=["dev"], bucketing=True),
                      "audio": asr_cfg["data"]["audio"], "text": text},
             "model": model or asr_cfg["model"]}
    decode = dict(test_cfg["decode"],
                  lm_config=os.path.join(tmp, "lm.yaml"),
                  lm_path=os.path.join(tmp, "lm.pth"))
    test = {"data": {"corpus": dict(corpus, dev_split=["dev"],
                                    test_split=["test"], bucketing=False)},
            "src": {"config": os.path.join(tmp, "train.yaml"),
                    "ckpt": os.path.join(tmp, "asr.pth")},
            "decode": decode}
    for name, cfg in (("train", train), ("lm", {"model": lm_cfg["model"]}),
                      ("test", test)):
        with open(os.path.join(tmp, name + ".yaml"), "w") as f:
            yaml.safe_dump(cfg, f)
    return os.path.join(tmp, "test.yaml"), train["model"], lm_cfg["model"]


def _write_checkpoints(tmp, seed, feat_dim, vocab_size, model, lm_model):
    """Seeded ASR and LM weights as port checkpoints in ``tmp``."""
    import torch
    from e2e_asr_pytorch_tpu_torch.models import asr as M
    from e2e_asr_pytorch_tpu_torch.models import lm as LM
    from e2e_asr_pytorch_tpu_torch.train.checkpoint import save_checkpoint
    gen = torch.Generator().manual_seed(seed)
    spec = M.build_spec(feat_dim, vocab_size, **model)
    save_checkpoint(os.path.join(tmp, "asr.pth"), M.asr_init(gen, spec))
    lm_spec = LM.build_spec(vocab_size, **lm_model)
    save_checkpoint(os.path.join(tmp, "lm.pth"), LM.lm_init(gen, lm_spec))
    return spec, lm_spec


def _check_csvs(outdir, name, beam, vocab_chars):
    for split in ("dev", "test"):
        path = os.path.join(outdir, "{}_{}_output.csv".format(name, split))
        with open(path) as f:
            rows = f.read().splitlines()
        if rows[0] != "idx\thyp\ttruth" or len(rows) != 1 + 16:
            raise AssertionError("bad {}: {} rows".format(path, len(rows)))
        hyps = [r.split("\t") for r in rows[1:]]
        if any(len(r) != 3 for r in hyps):
            raise AssertionError("bad columns in " + path)
        for _, hyp, _ in hyps:
            extra = set(hyp.replace("<unk>", "")) - vocab_chars
            if extra:
                raise AssertionError("hyp outside the vocab: {!r}".format(
                    sorted(extra)))
        bpath = os.path.join(outdir, "{}_{}_beam.csv".format(name, split))
        if beam > 1:
            with open(bpath) as f:
                brows = f.read().splitlines()
            if (brows[0] != "idx\tbeam\thyp\ttruth"
                    or len(brows) != 1 + 16 * beam
                    or any(len(r.split("\t")) != 4 for r in brows[1:])):
                raise AssertionError("bad " + bpath)
        elif os.path.exists(bpath):
            raise AssertionError("greedy wrote " + bpath)


def _slice_setup(tmp, seed, phase, model=None):
    """Phase 4's decode configs and seeded checkpoints in ``tmp`` (the
    flagship's model block, or ``model``). Returns the ``--test`` argv and
    the output directory."""
    from e2e_asr_pytorch_tpu_torch.main import build_solver
    t0 = time.perf_counter()
    cfg, model, lm_model = _write_slice_configs(tmp, model=model)
    outdir = os.path.join(tmp, "out")
    argv = ["--test", "--config", cfg, "--outdir", outdir, "--njobs", "0",
            "--seed", str(seed), "--no-msg"]
    # the vocabulary and feature width, as the port's solver reads them
    data = build_solver(argv + ["--name", "data"])
    spec, lm_spec = _write_checkpoints(tmp, seed, data.feat_dim,
                                       data.vocab_size, model, lm_model)
    _say(phase, "seeded checkpoints written in {:.1f} s (ASR {} encoder "
         "layers x BLSTM-{}, ctc_weight {}, LM {}x LSTM-{})".format(
             time.perf_counter() - t0, len(spec.encoder.dim),
             spec.encoder.dim[0], spec.ctc_weight, lm_spec.n_layers,
             lm_spec.dim))
    return argv, outdir


class _beam_outputs:
    """Within the block, every ``beam_decode`` the test solver calls keeps
    its tokens and scores in the list the block is given."""

    def __enter__(self):
        from e2e_asr_pytorch_tpu_torch.train import test_asr
        self.mod, self.fn, self.outs = test_asr, test_asr.beam_decode, []

        def kept(*args, **kwargs):
            out = self.fn(*args, **kwargs)
            self.outs.append({k: out[k].clone() for k in ("tokens",
                                                          "avg_scores")})
            return out
        test_asr.beam_decode = kept
        return self.outs

    def __exit__(self, *exc):
        self.mod.beam_decode = self.fn


def _decode_again(argv, outdir, first):
    """Phase 4's beam 8 + LM decode run again from the same checkpoints:
    every batch's tokens and scores (``first``: the first run's, from
    ``_beam_outputs``) and the CSVs bit for bit the first run's."""
    import torch
    from e2e_asr_pytorch_tpu_torch.main import main
    with _beam_outputs() as again:
        main(argv + ["--name", "beam_again"])
    if len(first) != len(again) or not all(
            torch.equal(x[k], y[k]) for x, y in zip(first, again)
            for k in x):
        raise AssertionError("the beam 8 + LM decode run twice gave other "
                             "tokens or scores")
    for split in ("dev", "test"):
        for kind in ("output", "beam"):
            texts = []
            for name in ("beam", "beam_again"):
                with open(os.path.join(outdir, "{}_{}_{}.csv".format(
                        name, split, kind))) as f:
                    texts.append(f.read())
            if texts[0] != texts[1]:
                raise AssertionError("the beam decode run twice wrote other "
                                     "{} {} CSVs".format(split, kind))
    _say("determinism", "phase 4's beam 8 + LM decode run twice: the tokens "
         "and scores of all {} batches and the CSVs bit for bit".format(
             len(first)))


def phase_slice(seed):
    import torch
    from e2e_asr_pytorch_tpu_torch import convert
    from e2e_asr_pytorch_tpu_torch.main import main
    from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as K

    results = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        argv, outdir = _slice_setup(tmp, seed, "slice")
        # counts reset just before the main path
        K.LAUNCHES = K.RESIDENT_LAUNCHES = K.STREAMED_LAUNCHES = 0
        with _beam_outputs() as first:
            runs = [("beam", 8, main(argv + ["--name", "beam"]))]
        after_beam = K.LAUNCHES
        runs.append(("greedy", 1, main(argv + ["--name", "greedy",
                                               "--override",
                                               "decode.beam_size=1"])))
        launches = K.LAUNCHES  # read just after
        if (K.RESIDENT_LAUNCHES, K.STREAMED_LAUNCHES) != (launches, 0):
            raise AssertionError(
                "the flagship listener's K1 took the forms (resident, "
                "streamed) = {} in {} launches".format(
                    (K.RESIDENT_LAUNCHES, K.STREAMED_LAUNCHES), launches))
        per_mode = {"beam": after_beam, "greedy": launches - after_beam}
        for mode, beam, solver in runs:
            n_batches = len(solver.dv_set) + len(solver.tt_set)
            n_layers = len(solver.spec.encoder.dim)
            if per_mode[mode] != n_layers * n_batches:
                raise AssertionError(
                    "{}: kernel launched {} times for {} batches x {} "
                    "layers".format(mode, per_mode[mode], n_batches,
                                    n_layers))
            leaves = convert.tree_leaves(solver.params)
            if solver.lm_params is not None:
                leaves += convert.tree_leaves(solver.lm_params)
            if not all(x.is_cuda for x in leaves):
                raise AssertionError(mode + ": a parameter is not on cuda")
            if solver.compute_dtype != torch.bfloat16:
                raise AssertionError(mode + ": compute dtype is not bf16")
            _check_csvs(outdir, mode, beam, _vocab_chars(solver.tokenizer))
            rtf = solver.decode_seconds / solver.audio_seconds
            results[mode] = dict(
                utts=solver.n_utts, batches=n_batches,
                audio_s=solver.audio_seconds,
                decode_s=solver.decode_seconds,
                utts_per_s=solver.n_utts / solver.decode_seconds, rtf=rtf,
                launches=per_mode[mode])
            _say("slice", "{}: {} utts in {} batches, {:.1f} s of audio, "
                 "decoded in {:.3f} s -> {:.2f} utts/s, RTF {:.5f}; kernel "
                 "launches {} (= {} layers x {} batches); CSVs ok".format(
                     mode, solver.n_utts, n_batches, solver.audio_seconds,
                     solver.decode_seconds, results[mode]["utts_per_s"], rtf,
                     per_mode[mode], n_layers, n_batches))
        _decode_again(argv, outdir, first)
    _say("slice", "K1 took the resident form in all {} launches".format(
        launches))
    _say("slice", json.dumps(results))
    return launches, results


def _write_train_configs(tmp, model=None, steps=TRAIN_STEPS, utts=96,
                         batch=16, source="librispeech_asr_best.yaml",
                         hparas=None, extra=None):
    """The data.audio, hparas and model blocks of config/<source> (the
    flagship's by default) verbatim (or ``model``), over the synthetic
    corpus, with max_step and valid_step set to ``steps`` (then the entries
    of ``hparas``, and the top-level blocks of ``extra``); and a greedy test
    config that decodes the run's last_att_dev.pth (last_ctc_dev.pth for a
    CTC-only model). Returns (train config, test config, experiment
    name)."""
    import yaml
    with open(os.path.join(ROOT, "config", source)) as f:
        asr_cfg = yaml.safe_load(f)
    task = "ctc" if (model or asr_cfg["model"])["ctc_weight"] == 1 else "att"
    text = dict(asr_cfg["data"]["text"])
    text["vocab_file"] = os.path.join(ROOT, text["vocab_file"])
    corpus = {"name": "synthetic", "path": "", "batch_size": batch,
              "n_utts": utts, "min_tokens": 20, "max_tokens": 80}
    train = {"data": {"corpus": dict(corpus, train_split=["train"],
                                     dev_split=["dev"], bucketing=True),
                      "audio": asr_cfg["data"]["audio"], "text": text},
             "hparas": dict(asr_cfg["hparas"], max_step=steps,
                            valid_step=steps),
             "model": model or asr_cfg["model"]}
    train["hparas"].update(hparas or {})
    train.update(extra or {})
    name = "train"
    test = {"data": {"corpus": dict(corpus, n_utts=16, batch_size=8,
                                    dev_split=["dev"], test_split=["test"],
                                    bucketing=False)},
            "src": {"config": os.path.join(tmp, "train.yaml"),
                    "ckpt": os.path.join(tmp, "ckpt", name,
                                         "last_{}_dev.pth".format(task))},
            "decode": {"ctc_weight": 0.0, "beam_size": 1,
                       "min_len_ratio": 0.01, "max_len_ratio": 0.3,
                       "lm_weight": 0.0}}
    for fname, cfg in (("train", train), ("train_test", test)):
        with open(os.path.join(tmp, fname + ".yaml"), "w") as f:
            yaml.safe_dump(cfg, f)
    return (os.path.join(tmp, "train.yaml"),
            os.path.join(tmp, "train_test.yaml"), name)


def _counters():
    """(module, attribute) of every kernel's launch count, by kernel name."""
    from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as K
    from e2e_asr_pytorch_tpu_torch.ops.kernels import gru as KG
    from e2e_asr_pytorch_tpu_torch.ops.kernels import int8_table as Q
    from e2e_asr_pytorch_tpu_torch.ops.kernels import ligru as KLG
    from e2e_asr_pytorch_tpu_torch.ops.kernels import lstm as KL
    return {"bilstm_fwd": (K, "LAUNCHES"), "bilstm_bwd": (K, "BWD_LAUNCHES"),
            "context_int8": (Q, "CTX_LAUNCHES"),
            "dattn_int8": (Q, "DATTN_LAUNCHES"),
            "lstm_fwd": (KL, "FWD_LAUNCHES"), "lstm_bwd": (KL, "BWD_LAUNCHES"),
            "lstm_fwd_chunked": (KL, "FWD_CHUNKED_LAUNCHES"),
            "lstm_bwd_chunked": (KL, "BWD_CHUNKED_LAUNCHES"),
            "gru_fwd": (KG, "FWD_LAUNCHES"), "gru_bwd": (KG, "BWD_LAUNCHES"),
            "ligru_fwd": (KLG, "FWD_LAUNCHES"),
            "ligru_bwd": (KLG, "BWD_LAUNCHES")}


def _reset_counts():
    for mod, attr in _counters().values():
        setattr(mod, attr, 0)


def _read_counts():
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _counters().items()}


def _k12_forms(K):
    """K1's and K2's launches so far by form: (resident, streamed) each."""
    return tuple(getattr(K, n) for n in (
        "RESIDENT_LAUNCHES", "STREAMED_LAUNCHES", "BWD_RESIDENT_LAUNCHES",
        "BWD_STREAMED_LAUNCHES"))


def _resident_forms(K, before, counts, label):
    """Every K1/K2 launch counted in ``counts`` since ``before`` (the form
    counts then, ``_k12_forms``) took the resident form."""
    forms = tuple(a - b for a, b in zip(_k12_forms(K), before))
    if forms != (counts["bilstm_fwd"], 0, counts["bilstm_bwd"], 0):
        raise AssertionError("{}: K1 and K2 took the forms (resident, "
                             "streamed) = {} and {}".format(label, forms[:2],
                                                            forms[2:]))


def _k5_forms():
    """K5f's launches so far, by form."""
    from e2e_asr_pytorch_tpu_torch.ops.kernels import lstm as KL
    return {f: getattr(KL, "FWD_{}_LAUNCHES".format(f.upper()))
            for f in KL.FORMS}


def _k78_forms():
    """K7f's, K7b's, K8f's and K8b's launches so far, by form."""
    from e2e_asr_pytorch_tpu_torch.ops.kernels import gru as KG
    from e2e_asr_pytorch_tpu_torch.ops.kernels import ligru as KLG
    return {"{}_{}".format(kind, way): {
        f: getattr(mod, "{}_{}_LAUNCHES".format(way.upper(), f.upper()))
        for f in KG.FORMS}
        for kind, mod in (("gru", KG), ("ligru", KLG))
        for way in ("fwd", "bwd")}


def _check_k5_forms(before, counts, form, label):
    """Every K5f launch counted in ``counts`` since ``before`` (the form
    counts then) took ``form``, and no other launch did; K5b, which has one
    form, ran too. Returns K5f's launches by form."""
    after = _k5_forms()
    got = {f: after[f] - before[f] for f in after}
    want = {f: counts["lstm_fwd"] if f == form else 0 for f in got}
    if got != want or counts["lstm_fwd"] < 1 or counts["lstm_bwd"] < 1:
        raise AssertionError("{}: K5f launches by form {} where {} were "
                             "expected".format(label, got, want))
    return got


def _leaf_paths(tree, prefix=""):
    """{'/a/0/b': tensor} over a nested dict/list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    return {k: v for key, sub in items
            for k, v in _leaf_paths(sub, prefix + "/" + key).items()}


def _run_train(tmp, seed, dev, steps, expected, model=None,
               source="librispeech_asr_best.yaml", extra_argv=(),
               hparas=None, extra=None, utts=96, updates=None):
    """``main`` in train mode (with ``extra_argv``) on the blocks of
    config/<source>, the flagship's by default (or ``model`` in place of
    its model block; ``hparas`` and ``extra`` as _write_train_configs) with
    the counts reset just before and read just after, and the checks every
    training run must pass (the losses of the heads the model has finite;
    ``updates`` optimizer updates, ``steps`` unless the run resumed).
    ``expected(solver)``
    gives the launch counts that must be non-zero, exactly. Returns the
    solver, the counts, the result record (with the warnings the run gave
    and the leaves that did not move), the greedy test config and the
    listener's (moved, total) leaves."""
    import torch
    from e2e_asr_pytorch_tpu_torch import convert
    from e2e_asr_pytorch_tpu_torch.main import main
    from e2e_asr_pytorch_tpu_torch.models import asr as M
    from e2e_asr_pytorch_tpu_torch.train.checkpoint import load_checkpoint

    train_cfg, test_cfg, name = _write_train_configs(
        tmp, model=model, steps=steps, utts=utts, source=source,
        hparas=hparas, extra=extra)
    argv = ["--config", train_cfg, "--name", name, "--njobs", "0",
            "--seed", str(seed), "--logdir", os.path.join(tmp, "log"),
            "--ckpdir", os.path.join(tmp, "ckpt"), "--no-msg", *extra_argv]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    _reset_counts()  # counts reset just before the main path
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        solver = main(argv)
    counts = _read_counts()  # read just after
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)

    want = dict.fromkeys(counts, 0)
    want.update(expected(solver))
    if solver.step != steps or counts != want:
        raise AssertionError("train: {} steps, launches {} where {} were "
                             "expected".format(solver.step, counts, want))
    heads = ["total", "gnorm"] + ["ctc"] * solver.spec.enable_ctc + [
        "att"] * solver.spec.enable_att
    for i, st in enumerate(solver.step_stats):
        if not all(math.isfinite(st[k]) for k in heads):
            raise AssertionError("train step {}: {}".format(i + 1, st))
    if solver.compute_dtype != torch.bfloat16:
        raise AssertionError("train: compute dtype is not bf16")
    leaves = convert.tree_leaves(solver.params)
    if not all(x.is_cuda for x in leaves):
        raise AssertionError("train: a parameter is not on cuda")
    init = M.asr_init(torch.Generator().manual_seed(seed), solver.spec, dev)
    now = _leaf_paths(solver.params)
    unmoved = [k for k, a in _leaf_paths(init).items()
               if torch.equal(a, now[k])]
    moved = len(leaves) - len(unmoved)
    if moved < len(leaves) // 2:
        raise AssertionError("train: only {} of {} parameter leaves "
                             "moved".format(moved, len(leaves)))
    rnn = [not torch.equal(a, b) for a, b in zip(
        convert.tree_leaves(init["encoder"]["layers"]),
        convert.tree_leaves(solver.params["encoder"]["layers"]))]
    # the accumulators in the dtype the hparas block names (the flagship's
    # bf16), else in the parameters' f32
    acc = [x for k, v in solver.opt_state.items() if k != "count"
           for x in convert.tree_leaves(v)]
    want_dtype = getattr(torch, solver.config["hparas"].get(
        "optim_state_dtype") or "float32")
    if not all(x.dtype == want_dtype for x in acc):
        raise AssertionError("train: optimizer state is not {}".format(
            want_dtype))
    task = "att" if solver.spec.enable_att else "ctc"
    ckpt = load_checkpoint(os.path.join(
        tmp, "ckpt", name, "last_{}_dev{}.pth".format(task,
                                                      solver.save_name)), dev)
    if (ckpt["global_step"] != steps
            or int(ckpt["optimizer"]["count"]) != (updates or steps)):
        raise AssertionError("train: checkpoint at step {}, {} updates"
                             .format(ckpt["global_step"],
                                     int(ckpt["optimizer"]["count"])))
    secs = solver.step_seconds[1:]
    res = {"steps": steps, "valid_batches": solver.n_valid_batches,
           "first_step_s": solver.step_seconds[0],
           "median_step_s": statistics.median(secs),
           "utts_per_s": sum(solver.step_utts[1:]) / sum(secs),
           "audio_s_per_s": sum(solver.step_audio_seconds[1:]) / sum(secs),
           "peak_mem_gb": peak / 2 ** 30, "wall_s": wall,
           "decode_lengths": solver.decode_lengths,
           "losses": [round(st["total"], 4) for st in solver.step_stats],
           "gnorms": [round(st["gnorm"], 4) for st in solver.step_stats],
           "launches": counts, "moved_leaves": moved,
           "n_leaves": len(leaves), "unmoved": unmoved,
           "warnings": sorted({str(w.message)[:160] for w in caught})}
    return solver, counts, res, test_cfg, (sum(rnn), len(rnn))


def _vocab_chars(tokenizer):
    """The characters the tokenizer's tokens decode to, and the space."""
    return set("".join(tokenizer.decode([i])
                       for i in range(3, tokenizer.vocab_size))) | {" "}


def _decode_checkpoint(tmp, seed, test_cfg, mode, beam, overrides=(),
                       extra_argv=()):
    """``main --test`` (with ``extra_argv``) on the training run's last
    checkpoint (the decode block's beam size set to ``beam``, and
    ``overrides``) with the counts reset just before and read just after;
    the CSV checks of phase 4."""
    from e2e_asr_pytorch_tpu_torch.main import main
    outdir = os.path.join(tmp, "out")
    _reset_counts()
    tester = main(["--test", "--config", test_cfg, "--name", mode, "--njobs",
                   "0", "--seed", str(seed), "--outdir", outdir, "--no-msg",
                   *extra_argv, "--override",
                   "decode.beam_size={}".format(beam), *overrides])
    counts = _read_counts()
    _check_csvs(outdir, mode, beam, _vocab_chars(tester.tokenizer))
    return tester, counts


def phase_train(seed, dev):
    """The flagship training step through the port's CLI, then a greedy
    decode of the checkpoint it wrote."""
    def expected(solver):
        n_layers = len(solver.spec.encoder.dim)
        return {"bilstm_fwd": n_layers * (solver.step
                                          + solver.n_valid_batches),
                "bilstm_bwd": n_layers * solver.step,
                "context_int8": sum(solver.decode_lengths),
                "dattn_int8": sum(solver.decode_lengths)}

    from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as K
    forms = _k12_forms(K)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        solver, counts, res, test_cfg, _ = _run_train(tmp, seed, dev,
                                                      TRAIN_STEPS, expected)
        _resident_forms(K, forms, counts, "train")
        res["forms"] = {"bilstm_fwd": "resident", "bilstm_bwd": "resident"}
        res["breakdown"] = _step_breakdown(solver, dev, asr=True,
                                           n_steps=ASR_TRACE_STEPS,
                                           watch=("int8_kernel",))
        _decode_checkpoint(tmp, seed, test_cfg, "greedy", 1)
    _say("train", "{} steps at batch 16 of the flagship (5x BLSTM-1280, "
         "int8 table, bf16 d_key, Adadelta bf16 state, SpecAugment, dropout "
         "0.3): losses {}, grad norms {}; first step {:.3f} s, median step "
         "after it {:.4f} s -> {:.2f} utts/s, {:.2f} s of audio per s; peak "
         "allocated {:.2f} GiB; launches {} (= expected); {} of {} leaves "
         "moved; checkpoint at step {} decoded greedily, CSVs ok".format(
             res["steps"], res["losses"], res["gnorms"], res["first_step_s"],
             res["median_step_s"], res["utts_per_s"], res["audio_s_per_s"],
             res["peak_mem_gb"], {k: v for k, v in counts.items() if v},
             res["moved_leaves"], res["n_leaves"], res["steps"]))
    prof = res["breakdown"]
    _say("train", "{} more step(s) under torch.profiler: {:.4f} s per "
         "step, device time {:.1f} ms per step (busy share {:.2f}); most "
         "device time per step: {}".format(
             prof["steps"], prof["wall_s_per_step"], prof["device_ms_per_step"],
             prof["busy_share"], "; ".join(
                 "{} {:.2f} ms x{:.0f}".format(*row) for row in prof["top"])))
    _say("train", "K3 / K4 in those steps (device time a launch at the "
         "training shapes, B=16, T and D of each batch): {}".format("; ".join(
             "{} {:.3f} ms a step over {:.0f} launches = {:.2f} us a "
             "launch".format(n, ms, k, ms * 1e3 / k)
             for n, ms, k in prof["watch"]) or "no int8 kernel row"))
    _say("train", json.dumps(res))
    return counts, res


def phase_encoders(seed, dev):
    """The flagship with a GRU, a light-GRU and a single-direction LSTM
    listener: train through the port's CLI, then decode the checkpoint
    greedily and with beam 8. Returns the launch counts summed over these
    main paths and the results."""
    import yaml
    with open(os.path.join(ROOT, "config", "librispeech_asr_best.yaml")) as f:
        flagship = yaml.safe_load(f)["model"]

    def variant(**enc):
        return dict(flagship, encoder=dict(flagship["encoder"], **enc))

    def expected(fwd_key, bwd_key):
        # one forward launch a layer and batch, one backward launch a layer
        # and step (a bidirectional GRU or light-GRU layer walks both
        # directions in one packed launch, a single-direction layer its one)
        def fn(solver):
            n = len(solver.spec.encoder.dim)
            return {fwd_key: n * (solver.step + solver.n_valid_batches),
                    bwd_key: n * solver.step,
                    "context_int8": sum(solver.decode_lengths),
                    "dattn_int8": sum(solver.decode_lengths)}
        return fn

    runs = [("GRU", variant(module="GRU"), ENC_STEPS, "gru_fwd", "gru_bwd",
             2, True),
            ("liGRU", variant(module="liGRU"), ENC_STEPS, "ligru_fwd",
             "ligru_bwd", 2, True),
            ("LSTM, one direction", variant(bidirection=False), UNI_STEPS,
             "lstm_fwd", "lstm_bwd", 1, False)]
    total, results, gru_forms = None, {}, {}
    for label, model, steps, fwd_key, bwd_key, dirs, beam in runs:
        forms = _k5_forms()
        k78 = _k78_forms()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_enc_") as tmp:
            solver, counts, res, test_cfg, rnn = _run_train(
                tmp, seed, dev, steps, expected(fwd_key, bwd_key),
                model=model)
            if rnn[0] != rnn[1]:
                raise AssertionError("{}: only {} of {} listener leaves "
                                     "moved".format(label, *rnn))
            enc = solver.spec.encoder
            if enc.out_dim != dirs * enc.dim[-1]:
                raise AssertionError("{}: listener width {}".format(
                    label, enc.out_dim))
            decodes = [("greedy", 1)] + ([("beam", 8)] if beam else [])
            for mode, k in decodes:
                tester, dcounts = _decode_checkpoint(tmp, seed, test_cfg,
                                                     mode, k)
                n_batches = len(tester.dv_set) + len(tester.tt_set)
                want = dict.fromkeys(dcounts, 0)
                want[fwd_key] = len(enc.dim) * n_batches
                if dcounts != want:
                    raise AssertionError(
                        "{} {}: launches {} where {} were expected".format(
                            label, mode, dcounts, want))
                res[mode] = {"utts": tester.n_utts, "batches": n_batches,
                             "decode_s": tester.decode_seconds,
                             "rtf": (tester.decode_seconds
                                     / tester.audio_seconds),
                             "launches": dcounts[fwd_key]}
                counts = {n: counts[n] + dcounts[n] for n in counts}
            if fwd_key != "lstm_fwd":
                # every K7f / K8f launch, training and decoding, and every
                # K7b / K8b launch walked both directions of its layer in
                # the packed form
                after = _k78_forms()
                res["forms"] = {}
                for key in (fwd_key, bwd_key):
                    got = {f: after[key][f] - k78[key][f] for f in after[key]}
                    if got != {"packed": counts[key], "single": 0}:
                        raise AssertionError(
                            "{}: {} launches by form {} of {} in all".format(
                                label, key, got, counts[key]))
                    res["forms"][key] = gru_forms[key] = got
                res["breakdown"] = _step_breakdown(
                    solver, dev, asr=True, n_steps=ASR_TRACE_STEPS)
        if fwd_key == "lstm_fwd":
            # batches of 16 and 8 utterances: every K5f launch, training
            # and decoding, in the narrow form
            res["forms"] = _check_k5_forms(forms, counts, "narrow", label)
        total = counts if total is None else {n: total[n] + counts[n]
                                              for n in counts}
        results[label] = res
        _say("encoders", "{} listener, {} steps at batch 16 of the flagship "
             "otherwise verbatim: losses {}, grad norms {}; first step "
             "{:.3f} s, median step after it {:.4f} s -> {:.2f} utts/s, "
             "{:.2f} s of audio per s; peak allocated {:.2f} GiB; all {} "
             "listener leaves moved ({} of {} in all); checkpoint decoded: "
             "{}; launches over train and decode {} (= expected)".format(
                 label, steps, res["losses"], res["gnorms"],
                 res["first_step_s"], res["median_step_s"],
                 res["utts_per_s"], res["audio_s_per_s"], res["peak_mem_gb"],
                 rnn[1], res["moved_leaves"], res["n_leaves"], ", ".join(
                     "{} {:.3f} s (RTF {:.5f})".format(
                         m, res[m]["decode_s"], res[m]["rtf"])
                     for m, _ in decodes),
                 {k: v for k, v in counts.items() if v}))
        if "breakdown" in res:
            prof = res["breakdown"]
            _say("encoders", "{} listener, {} more step(s) under "
                 "torch.profiler: {:.4f} s per step, device time {:.1f} ms "
                 "per step (busy share {:.3f}); most device time per step: "
                 "{}".format(
                     label, prof["steps"], prof["wall_s_per_step"],
                     prof["device_ms_per_step"], prof["busy_share"],
                     "; ".join("{} {:.2f} ms x{:.0f}".format(*row)
                               for row in prof["top"])))
    _say("encoders", json.dumps(results))
    return (total, results, results["LSTM, one direction"]["forms"],
            gru_forms)


def _write_lm_config(tmp, source, steps, valid):
    """The model and hparas blocks of config/<source> verbatim over the
    synthetic text corpus at batch 128, with max_step and valid_step set.
    Returns the config's path and the model block."""
    import yaml
    with open(os.path.join(ROOT, "config", source)) as f:
        src = yaml.safe_load(f)
    text = dict(src["data"]["text"])
    text["vocab_file"] = os.path.join(ROOT, text["vocab_file"])
    cfg = {"data": {"corpus": {"name": "synthetic", "path": "",
                               "train_split": ["lm-train"],
                               "dev_split": ["lm-dev"], "bucketing": True,
                               "batch_size": 128, "n_sents": 2048,
                               "min_tokens": 40, "max_tokens": 300},
                    "text": text},
           "hparas": dict(src["hparas"], max_step=steps, valid_step=valid),
           "model": src["model"]}
    path = os.path.join(tmp, source)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, src["model"]


def _run_lm(tmp, seed, dev, source, name, steps, valid, fwd_key, bwd_key):
    """``main --lm`` on one config with the counts reset just before and
    read just after; the checks every LM run must pass."""
    import torch
    from e2e_asr_pytorch_tpu_torch import convert
    from e2e_asr_pytorch_tpu_torch.main import main
    from e2e_asr_pytorch_tpu_torch.models import lm as LM
    cfg, _ = _write_lm_config(tmp, source, steps, valid)
    argv = ["--lm", "--config", cfg, "--name", name, "--njobs", "0",
            "--seed", str(seed), "--logdir", os.path.join(tmp, "log"),
            "--ckpdir", os.path.join(tmp, "ckpt"), "--no-msg"]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    _reset_counts()  # counts reset just before the main path
    solver = main(argv)
    counts = _read_counts()  # read just after
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)

    n_layers = solver.lm_spec.n_layers
    want = dict.fromkeys(counts, 0)
    want[fwd_key] = n_layers * (solver.step + solver.n_valid_batches)
    want[bwd_key] = n_layers * solver.step
    if solver.step != steps or counts != want:
        raise AssertionError("{}: {} steps, launches {} where {} were "
                             "expected".format(name, solver.step, counts,
                                               want))
    if solver.n_valid_batches != (steps // valid) * len(solver.dv_set):
        raise AssertionError("{}: {} validation batches".format(
            name, solver.n_valid_batches))
    for i, st in enumerate(solver.step_stats):
        if not all(math.isfinite(v) for v in st.values()):
            raise AssertionError("{} step {}: {}".format(name, i + 1, st))
    if solver.compute_dtype != torch.bfloat16:
        raise AssertionError(name + ": compute dtype is not bf16")
    leaves = convert.tree_leaves(solver.params)
    state = (convert.tree_leaves(solver.opt_state["mu"])
             + convert.tree_leaves(solver.opt_state["nu"])
             + [solver.opt_state["count"]])
    if not all(x.is_cuda for x in leaves + state):
        raise AssertionError(name + ": a parameter or a piece of the Adam "
                             "state is not on cuda")
    init = convert.tree_leaves(LM.lm_init(
        torch.Generator().manual_seed(seed), solver.lm_spec, dev))
    moved = sum(not torch.equal(a, b) for a, b in zip(init, leaves))
    if moved != len(leaves) or int(solver.opt_state["count"]) != steps:
        raise AssertionError("{}: {} of {} parameter leaves moved, {} "
                             "updates".format(name, moved, len(leaves),
                                              int(solver.opt_state["count"])))
    ckpt = os.path.join(tmp, "ckpt", name, "last_ppx.pth")
    if not os.path.exists(ckpt):
        raise AssertionError(name + ": last_ppx.pth was not written")
    secs = solver.step_seconds[1:]
    res = {"steps": steps, "valid_batches": solver.n_valid_batches,
           "first_step_s": solver.step_seconds[0],
           "median_step_s": statistics.median(secs),
           "step_s": [round(x, 4) for x in solver.step_seconds],
           "step_tokens": solver.step_tokens,
           "tokens_per_s": sum(solver.step_tokens[1:]) / sum(secs),
           "peak_mem_gb": peak / 2 ** 30, "wall_s": wall,
           "losses": [round(st["loss"], 4) for st in solver.step_stats],
           "gnorms": [round(st["gnorm"], 4) for st in solver.step_stats],
           "dev_ppx": solver.best_ppx, "launches": counts,
           "moved_leaves": moved}
    return solver, counts, res, ckpt


def _step_breakdown(solver, dev, asr, n_steps=2, watch=()):
    """Where a training step's time goes: ``n_steps`` more steps of the
    solver's own ``train_step`` (the ASR one with ``asr``, else the LM one)
    under torch.profiler, after the counts were read. Returns the
    device-busy share of the window and the kernels with the most device
    time, as (name, ms per step, launches per step), and the same rows of
    every kernel whose name holds one of ``watch``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from e2e_asr_pytorch_tpu_torch.train import train_asr, train_lm
    batches = []
    for data, _ in zip(iter(solver.tr_set), range(n_steps)):
        batches.append(train_asr.to_device(data, dev) if asr else
                       torch.from_numpy(data["txt"]).to(dev).long())
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            if asr:
                train_asr.train_step(solver.step_cfg, solver.params,
                                     solver.opt_state, batch, solver.gen, 1.0,
                                     solver.spec.enable_ctc)
            else:
                train_lm.train_step(solver.step_cfg, solver.params,
                                    solver.opt_state, batch, solver.gen)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    res = _kernel_breakdown(prof, wall, n_steps, watch)
    res["steps"] = n_steps
    return res


def _decode_breakdown(solver, dev, n_batches=2):
    """Where a decode's time goes: the test solver's own ``_decode_batch``
    on ``n_batches`` more batches of its test set (CSVs into a scratch
    directory) under torch.profiler, device activity only: a beam batch
    runs ~700,000 host ops, whose events would take the profiler minutes
    to average. Returns what ``_kernel_breakdown`` does, per batch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    batches = [data for data, _ in zip(iter(solver.tt_set),
                                       range(n_batches))]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tmp:
        out = os.path.join(tmp, "output.csv")
        beam = None if solver.greedy else os.path.join(tmp, "beam.csv")
        torch.cuda.synchronize(dev)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for data in batches:
                solver._decode_batch(data, out, beam)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
    res = _kernel_breakdown(prof, wall, n_batches)
    res["batches"] = n_batches
    return res


def _kernel_breakdown(prof, wall, n, watch=()):
    """The device-busy share of a profiled window of ``wall`` seconds over
    ``n`` steps or batches, and the kernels with the most device time, as
    (name, ms per step, launches per step), and the same rows of every
    kernel whose name holds one of ``watch``."""
    import torch
    # a record_function span (the ASR step's "forward", "optimizer", ...) is
    # listed on the device too, over the kernels it encloses: count kernels
    # only, the device rows whose name is no host-side event's (the CUDA
    # runtime's calls are host-side events of a device-only trace)
    events = prof.key_averages()
    host = {e.key for e in events
            if e.device_type == torch.autograd.DeviceType.CPU}
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in host]
    total_us = sum(e.self_device_time_total for e in kernels)
    if total_us <= 0:
        raise AssertionError("the profiler saw no device time")
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]
    def row(e):
        return (e.key[:70], e.self_device_time_total / 1e3 / n,
                e.count / n)
    return {"wall_s_per_step": wall / n,
            "device_ms_per_step": total_us / 1e3 / n,
            "busy_share": total_us / 1e6 / wall,
            "top": [row(e) for e in top],
            "watch": [row(e) for e in kernels
                      if any(w in e.key for w in watch)]}


def phase_lm(seed, dev):
    """LM training through the port's CLI at the flagship LM's full width
    (K6f, K6b), its checkpoint's lm_apply against lm_step, then a few steps
    of the 4x LSTM-1024 LM (K5f, K5b)."""
    import torch
    from e2e_asr_pytorch_tpu_torch.convert import cast_matmul_weights
    from e2e_asr_pytorch_tpu_torch.models import lm as LM
    from e2e_asr_pytorch_tpu_torch.ops.kernels import lstm as KL
    from e2e_asr_pytorch_tpu_torch.train.checkpoint import load_checkpoint
    from e2e_asr_pytorch_tpu_torch.train.train_lm import shift_inputs

    results = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_lm_") as tmp:
        solver, counts, res, ckpt_path = _run_lm(
            tmp, seed, dev, "librispeech_lm_best.yaml", "lm_best", LM_STEPS,
            LM_VALID, "lstm_fwd_chunked", "lstm_bwd_chunked")
        results["lm_best"] = res
        spec = solver.lm_spec
        _say("lm", "{} steps at batch 128 of the flagship LM (tied {}, {}x "
             "LSTM-{}, dropout {}, Adam): losses {}, grad norms {}; first "
             "step {:.3f} s, median step after it {:.4f} s -> {:.0f} "
             "tokens/s; peak allocated {:.2f} GiB; dev ppx {:.2f}; launches "
             "{} (= expected); {} leaves moved; last_ppx.pth written".format(
                 res["steps"], spec.emb_dim, spec.n_layers, spec.dim,
                 spec.dropout, res["losses"], res["gnorms"],
                 res["first_step_s"], res["median_step_s"],
                 res["tokens_per_s"], res["peak_mem_gb"], res["dev_ppx"],
                 {k: v for k, v in counts.items() if v}, res["moved_leaves"]))

        # the checkpoint as the decode path loads it: lm_apply through K6f
        # against lm_step token by token (plain ops) on one dev batch
        ckpt = load_checkpoint(ckpt_path, dev)
        if (ckpt["global_step"] != LM_STEPS
                or sorted(ckpt["optimizer"]) != ["count", "mu", "nu"]):
            raise AssertionError("lm: checkpoint at step {} with state {}"
                                 .format(ckpt["global_step"],
                                         sorted(ckpt["optimizer"])))
        txt = torch.from_numpy(next(iter(solver.dv_set))["txt"]).to(dev).long()
        inp, _ = shift_inputs(txt)
        before = KL.FWD_CHUNKED_LAUNCHES
        with torch.no_grad():
            by_kernel, _ = LM.lm_apply(ckpt["model"], spec, inp,
                                       compute_dtype=solver.compute_dtype)
            if KL.FWD_CHUNKED_LAUNCHES != before + spec.n_layers:
                raise AssertionError("lm: lm_apply did not go through K6f")
            params = cast_matmul_weights(ckpt["model"], solver.compute_dtype)
            hidden = LM.lm_zero_state(spec, inp.shape[0], dev)
            by_step = []
            for i in range(inp.shape[1]):
                logit, hidden = LM.lm_step(params, spec, inp[:, i], hidden,
                                           compute_dtype=solver.compute_dtype)
                by_step.append(logit)
            by_step = torch.stack(by_step, dim=1)
        err = (by_kernel - by_step).abs()
        mag = by_step.abs().max().item()
        if (not bool(torch.isfinite(by_kernel).all())
                or tuple(by_kernel.shape) != (*inp.shape, spec.vocab_size)
                or err.max().item() > LM_LOGIT_MAX_REL * mag
                or err.mean().item() > LM_LOGIT_MEAN_REL * mag):
            raise AssertionError(
                "lm: lm_apply and lm_step disagree: max|err| {:.3e}, mean "
                "{:.3e} at max|logit| {:.3e}".format(
                    err.max().item(), err.mean().item(), mag))
        results["lm_best"]["logit_err"] = [err.max().item(),
                                           err.mean().item(), mag]
        _say("lm", "checkpoint of step {}: lm_apply (K6f, {} x {} tokens) "
             "against lm_step token by token: max|err| {:.3e} (tol {:.3e}), "
             "mean|err| {:.3e} (tol {:.3e}) at max|logit| {:.3f}".format(
                 LM_STEPS, *inp.shape, err.max().item(),
                 LM_LOGIT_MAX_REL * mag, err.mean().item(),
                 LM_LOGIT_MEAN_REL * mag, mag))
        prof = _step_breakdown(solver, dev, asr=False)
        results["lm_best"]["breakdown"] = prof
        _say("lm", "2 more steps under torch.profiler: {:.4f} s per step, "
             "device time {:.1f} ms per step (busy share {:.2f}); most device "
             "time per step: {}".format(
                 prof["wall_s_per_step"], prof["device_ms_per_step"],
                 prof["busy_share"], "; ".join(
                     "{} {:.2f} ms x{:.0f}".format(*row)
                     for row in prof["top"])))
        del ckpt, params, solver

        forms = _k5_forms()
        solver, counts5, res5, _ = _run_lm(
            tmp, seed, dev, "librispeech_lm.yaml", "lm", LM_K5_STEPS,
            LM_K5_STEPS, "lstm_fwd", "lstm_bwd")
        # batch 128: every K5f launch in the wide form
        res5["forms"] = _check_k5_forms(forms, counts5, "wide", "lm")
        results["lm"] = res5
        _say("lm", "{} steps of the 4x LSTM-{} LM: losses {}; median step "
             "after the first {:.4f} s -> {:.0f} tokens/s; peak allocated "
             "{:.2f} GiB; launches {} (= expected), K5f by form {}".format(
                 res5["steps"], solver.lm_spec.dim, res5["losses"],
                 res5["median_step_s"], res5["tokens_per_s"],
                 res5["peak_mem_gb"], {k: v for k, v in counts5.items() if v},
                 res5["forms"]))
        prof = _step_breakdown(solver, dev, asr=False)
        results["lm"]["breakdown"] = prof
        _say("lm", "4x LSTM-{} LM, 2 more steps under torch.profiler: {:.4f} "
             "s per step, device time {:.1f} ms per step (busy share {:.2f}); "
             "most device time per step: {}".format(
                 solver.lm_spec.dim, prof["wall_s_per_step"],
                 prof["device_ms_per_step"], prof["busy_share"], "; ".join(
                     "{} {:.2f} ms x{:.0f}".format(*row)
                     for row in prof["top"])))
    _say("lm", json.dumps(results))
    return ({k: counts[k] + counts5[k] for k in counts}, results,
            res5["forms"])


def _no_jax():
    """Fails if any module of JAX or of the JAX package was imported."""
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                        "e2e_asr_pytorch_tpu"))
    if bad:
        raise AssertionError("imported: {}".format(bad[:5]))


def _expect_counts(label, counts, nonzero):
    """The launch counts must be ``nonzero`` exactly and 0 elsewhere."""
    want = dict.fromkeys(counts, 0)
    want.update(nonzero)
    if counts != want:
        raise AssertionError("{}: launches {} where {} were expected".format(
            label, {k: v for k, v in counts.items() if v},
            {k: v for k, v in want.items() if v}))


def _chain_synthetic(seed):
    """9(a): config/synthetic_debug.yaml trained verbatim through the port's
    CLI (only the directories given), a copy of config/synthetic_test.yaml
    with src.ckpt pointed at its checkpoint decoded, and both CSVs scored
    with the port's own scorer."""
    import contextlib
    import io
    import yaml
    from e2e_asr_pytorch_tpu_torch import eval as scorer
    from e2e_asr_pytorch_tpu_torch.main import main
    res, total = {}, None
    with tempfile.TemporaryDirectory(prefix="chip_smoke_chain_") as tmp:
        # the configs' own relative paths (vocabulary, src.config) are the
        # repo's: run from its root
        os.chdir(ROOT)
        _reset_counts()
        solver = main(["--config", "config/synthetic_debug.yaml", "--name",
                       "smoke", "--njobs", "0", "--seed", str(seed),
                       "--logdir", os.path.join(tmp, "log"), "--ckpdir",
                       os.path.join(tmp, "ckpt"), "--no-msg"])
        counts = _read_counts()
        n = len(solver.spec.encoder.dim)
        _expect_counts("chain synthetic_debug train", counts, {
            "bilstm_fwd": n * (solver.step + solver.n_valid_batches),
            "bilstm_bwd": n * solver.step})
        if solver.step != 80 or solver.spec.decoder.layer != 1:
            raise AssertionError("chain: {} steps of a {}-layer decoder"
                                 .format(solver.step,
                                         solver.spec.decoder.layer))
        for i, st in enumerate(solver.step_stats):
            if not all(math.isfinite(st[k]) for k in ("total", "gnorm",
                                                      "ctc", "att")):
                raise AssertionError("chain step {}: {}".format(i + 1, st))
        secs = solver.step_seconds[1:]
        res["train"] = {
            "steps": solver.step, "valid_batches": solver.n_valid_batches,
            "median_step_s": statistics.median(secs),
            "losses": [round(solver.step_stats[i]["total"], 4)
                       for i in (0, 39, 79)], "launches": counts}
        total = counts

        with open(os.path.join(ROOT, "config", "synthetic_test.yaml")) as f:
            test = yaml.safe_load(f)
        test["src"]["ckpt"] = os.path.join(tmp, "ckpt", "smoke",
                                           "last_att_dev.pth")
        with open(os.path.join(tmp, "test.yaml"), "w") as f:
            yaml.safe_dump(test, f)
        outdir = os.path.join(tmp, "out")
        log = io.StringIO()
        _reset_counts()
        with contextlib.redirect_stdout(log):
            tester = main(["--test", "--config",
                           os.path.join(tmp, "test.yaml"), "--name", "smoke",
                           "--njobs", "0", "--seed", str(seed), "--outdir",
                           outdir])
        counts = _read_counts()
        banner = [" ".join(l.replace("[INFO]", "").split())
                  for l in log.getvalue().splitlines()
                  if "Joint CTC decoding enabled" in l]
        if not banner or tester.dec_ctc_weight != 0.3 \
                or tester.beam_size != 4:
            raise AssertionError("chain decode: no joint CTC banner")
        n_batches = len(tester.dv_set) + len(tester.tt_set)
        _expect_counts("chain synthetic_test decode", counts,
                       {"bilstm_fwd": n * n_batches})
        _check_csvs(outdir, "smoke", 4, _vocab_chars(tester.tokenizer))
        total = {k: total[k] + counts[k] for k in total}
        res["decode"] = {"utts": tester.n_utts, "batches": n_batches,
                         "decode_s": tester.decode_seconds,
                         "rtf": tester.decode_seconds / tester.audio_seconds,
                         "banner": banner[0]}
        for split in ("dev", "test"):
            stem = os.path.join(outdir, "smoke_{}_".format(split))
            wer, cer = scorer.main(["--file", stem + "output.csv"])
            o_wer, o_cer = scorer.main(["--beam", "--file",
                                        stem + "beam.csv"])
            res[split] = {"wer": wer, "cer": cer, "oracle_wer": o_wer,
                          "oracle_cer": o_cer}
    _no_jax()
    _say("chain", "(a) config/synthetic_debug.yaml: {} steps (1-layer "
         "decoder, CTC 0.5), median step after the first {:.4f} s, losses "
         "at steps 1/40/80 {}; config/synthetic_test.yaml on its checkpoint "
         "('{}'): {} utts in {:.3f} s (RTF {:.5f}); the port's scorer: dev "
         "CER {:.4f} WER {:.4f} (oracle {:.4f} / {:.4f}), test CER {:.4f} "
         "WER {:.4f} (oracle {:.4f} / {:.4f}); launches {} (= expected); no "
         "jax imported".format(
             res["train"]["steps"], res["train"]["median_step_s"],
             res["train"]["losses"], res["decode"]["banner"],
             res["decode"]["utts"], res["decode"]["decode_s"],
             res["decode"]["rtf"], res["dev"]["cer"], res["dev"]["wer"],
             res["dev"]["oracle_cer"], res["dev"]["oracle_wer"],
             res["test"]["cer"], res["test"]["wer"],
             res["test"]["oracle_cer"], res["test"]["oracle_wer"],
             {k: v for k, v in total.items() if v}))
    return total, res


def _chain_librispeech_asr(seed, dev):
    """9(b): config/librispeech_asr.yaml's model, hparas and data.audio
    blocks verbatim on the synthetic corpus at batch 16, CHAIN_STEPS steps
    with a validation at the last, then beam 8 + decode CTC 0.3 on its
    checkpoint."""
    import torch
    from e2e_asr_pytorch_tpu_torch import convert
    from e2e_asr_pytorch_tpu_torch.models import asr as M
    from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as K

    def expected(solver):
        n = len(solver.spec.encoder.dim)
        return {"bilstm_fwd": n * (solver.step + solver.n_valid_batches),
                "bilstm_bwd": n * solver.step}
    forms = _k12_forms(K)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_asr_") as tmp:
        solver, counts, res, test_cfg, _ = _run_train(
            tmp, seed, dev, CHAIN_STEPS, expected,
            source="librispeech_asr.yaml")
        _resident_forms(K, forms, counts, "librispeech_asr")
        spec = solver.spec
        if spec.decoder.layer != 1:
            raise AssertionError("librispeech_asr: a {}-layer decoder"
                                 .format(spec.decoder.layer))
        init = M.asr_init(torch.Generator().manual_seed(seed), spec, dev)
        for key in ("decoder", "ctc_layer"):
            still = [i for i, (a, b) in enumerate(zip(
                convert.tree_leaves(init[key]),
                convert.tree_leaves(solver.params[key])))
                if torch.equal(a, b)]
            if still:
                raise AssertionError("librispeech_asr: {} leaves {} did not "
                                     "move".format(key, still))
        tester, dcounts = _decode_checkpoint(
            tmp, seed, test_cfg, "beam", 8, ["decode.ctc_weight=0.3"])
        n_batches = len(tester.dv_set) + len(tester.tt_set)
        _expect_counts("librispeech_asr decode", dcounts,
                       {"bilstm_fwd": len(spec.encoder.dim) * n_batches})
        res["beam"] = {"utts": tester.n_utts, "batches": n_batches,
                       "decode_s": tester.decode_seconds,
                       "rtf": tester.decode_seconds / tester.audio_seconds}
        counts = {k: counts[k] + dcounts[k] for k in counts}
    _say("chain", "(b) config/librispeech_asr.yaml (4x BLSTM-320, pyramid "
         "[1,2,1,1], vgg 0, 1-layer decoder 300, CTC 0.5), {} steps at batch "
         "16: losses {}, grad norms {}; first step {:.3f} s, median step "
         "after it {:.4f} s -> {:.2f} utts/s, {:.2f} s of audio per s; peak "
         "allocated {:.2f} GiB; every K1/K2 launch resident; every decoder "
         "and CTC leaf moved; beam 8 + CTC 0.3 on its checkpoint: {} utts "
         "in {:.3f} s (RTF {:.5f}), CSVs ok; launches {} (= expected)".format(
             res["steps"], res["losses"], res["gnorms"], res["first_step_s"],
             res["median_step_s"], res["utts_per_s"], res["audio_s_per_s"],
             res["peak_mem_gb"], res["beam"]["utts"],
             res["beam"]["decode_s"], res["beam"]["rtf"],
             {k: v for k, v in counts.items() if v}))
    return counts, res


def _chain_decode(seed, dev, label, model=None, overrides=()):
    """Phase 4's beam-8 + LM decode through the port's CLI (the flagship's
    blocks, or ``model``), with ``overrides``: counts reset just before and
    read just after, K1 exactly 5 per encoded batch and nothing else, the
    CSV checks. Returns the solver (its data still loaded), the counts and
    the result record."""
    from e2e_asr_pytorch_tpu_torch.main import main
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        argv, outdir = _slice_setup(tmp, seed, "chain", model=model)
        _reset_counts()
        extra = ["--override", *overrides] if overrides else []
        solver = main(argv + ["--name", label] + extra)
        counts = _read_counts()
        n_batches = len(solver.dv_set) + len(solver.tt_set)
        _expect_counts(label, counts, {
            "bilstm_fwd": len(solver.spec.encoder.dim) * n_batches})
        _check_csvs(outdir, label, solver.beam_size,
                    _vocab_chars(solver.tokenizer))
    res = {"utts": solver.n_utts, "batches": n_batches,
           "audio_s": solver.audio_seconds, "decode_s": solver.decode_seconds,
           "utts_per_s": solver.n_utts / solver.decode_seconds,
           "rtf": solver.decode_seconds / solver.audio_seconds,
           "launches": counts["bilstm_fwd"]}
    return solver, counts, res


def phase_chain(seed, dev, slice_results):
    """Phase 9: the dataset-free chain, config/librispeech_asr.yaml at full
    width, the flagship's joint CTC decode and the pure-CTC beam. Returns
    the launch counts summed over its main paths and the results."""
    import yaml
    total, results = _timed("chain (a)", _chain_synthetic, seed)
    counts, results["librispeech_asr"] = _timed(
        "chain (b)", _chain_librispeech_asr, seed, dev)
    total = {k: total[k] + counts[k] for k in total}

    # (c) phase 4's run again with decode.ctc_weight 0.3
    solver, counts, res = _timed("chain (c)", _chain_decode, seed, dev,
                                 "joint", None, ["decode.ctc_weight=0.3"])
    if solver.dec_ctc_weight != 0.3 or solver.lm_weight != 0.3:
        raise AssertionError("joint: decode weights {} / {}".format(
            solver.dec_ctc_weight, solver.lm_weight))
    total = {k: total[k] + counts[k] for k in total}
    plain = slice_results["beam"]
    res["rtf_over_phase_4"] = res["rtf"] / plain["rtf"]
    res["breakdown"] = _timed("chain (c) trace", _decode_breakdown, solver,
                              dev, DECODE_TRACE_BATCHES)
    results["joint"] = res
    prof = res["breakdown"]
    _say("chain", "(c) the flagship, beam 8 + LM 0.3 + CTC 0.3: {} utts "
         "({:.1f} s of audio) in {:.3f} s -> {:.2f} utts/s, RTF {:.5f}; "
         "phase 4 without CTC: {:.2f} utts/s, RTF {:.5f} ({:.2f}x); K1 "
         "launches {} (= 5 x {} batches); CSVs ok".format(
             res["utts"], res["audio_s"], res["decode_s"], res["utts_per_s"],
             res["rtf"], plain["utts_per_s"], plain["rtf"],
             res["rtf_over_phase_4"], res["launches"], res["batches"]))
    _say("chain", "(c) {} more test batch(es) under torch.profiler: {:.3f} "
         "s per batch, device time {:.1f} ms per batch (busy share {:.3f}); "
         "most device time per batch: {}".format(
             prof["batches"], prof["wall_s_per_step"], prof["device_ms_per_step"],
             prof["busy_share"], "; ".join(
                 "{} {:.2f} ms x{:.0f}".format(*row) for row in prof["top"])))
    del solver

    # (d) the flagship's blocks with model.ctc_weight 1: the CTC prefix beam
    with open(os.path.join(ROOT, "config", "librispeech_asr_best.yaml")) as f:
        flagship = yaml.safe_load(f)["model"]
    solver, counts, res = _timed("chain (d)", _chain_decode, seed, dev,
                                 "ctc", dict(flagship, ctc_weight=1.0))
    if solver.spec.enable_att or solver.beam_size != 8:
        raise AssertionError("ctc: the model has an attention decoder or "
                             "the beam is {}".format(solver.beam_size))
    total = {k: total[k] + counts[k] for k in total}
    results["ctc"] = res
    _say("chain", "(d) the flagship with ctc_weight 1, CTC prefix beam 8 + "
         "LM 0.3: {} utts in {:.3f} s -> {:.2f} utts/s, RTF {:.5f}; K1 "
         "launches {} (= 5 x {} batches); CSVs ok".format(
             res["utts"], res["decode_s"], res["utts_per_s"], res["rtf"],
             res["launches"], res["batches"]))
    _no_jax()
    _say("chain", json.dumps(results))
    return total, results


def _frontends_example(seed, dev):
    """10(a): config/libri/asr_example.yaml's blocks verbatim on the
    synthetic corpus (vgg 1 via ``prenet: 'vgg'``, 5x BLSTM-512, a 1-layer
    decoder 512, attention only, the subword-256 vocabulary), batch 16,
    EXAMPLE_STEPS steps with a validation at the last; then ``--test`` with
    config/libri/decode_example.yaml's decode block (beam 20, LM 0.5 on
    config/libri/lm_example.yaml's untied 2x LSTM-1024 with seeded weights,
    CTC 0) on its checkpoint."""
    import torch
    import yaml
    from e2e_asr_pytorch_tpu_torch.main import main
    from e2e_asr_pytorch_tpu_torch.models import lm as LM
    from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as K
    from e2e_asr_pytorch_tpu_torch.train.checkpoint import save_checkpoint

    def expected(solver):
        n = len(solver.spec.encoder.dim)
        return {"bilstm_fwd": n * (solver.step + solver.n_valid_batches),
                "bilstm_bwd": n * solver.step}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_example_") as tmp:
        forms = _k12_forms(K)
        solver, counts, res, _, _ = _run_train(
            tmp, seed, dev, EXAMPLE_STEPS, expected,
            source="libri/asr_example.yaml")
        _resident_forms(K, forms, counts, "asr_example")
        spec = solver.spec
        if (spec.encoder.frontend.vgg != 1 or spec.decoder.layer != 1
                or spec.enable_ctc or spec.encoder.dim != (512,) * 5):
            raise AssertionError("asr_example: not vgg 1 + 5x BLSTM-512 + a "
                                 "1-layer attention-only decoder")
        with open(os.path.join(ROOT, "config", "libri",
                               "decode_example.yaml")) as f:
            test = yaml.safe_load(f)
        lm_config = os.path.join(ROOT, test["decode"]["lm_config"])
        with open(lm_config) as f:
            lm_model = yaml.safe_load(f)["model"]
        lm_spec = LM.build_spec(solver.vocab_size, **lm_model)
        save_checkpoint(os.path.join(tmp, "lm.pth"), LM.lm_init(
            torch.Generator().manual_seed(seed + 1), lm_spec))
        test["src"] = {"config": os.path.join(tmp, "train.yaml"),
                       "ckpt": os.path.join(tmp, "ckpt", "train",
                                            "last_att_dev.pth")}
        test["data"] = {"corpus": {
            "name": "synthetic", "path": "", "batch_size": 8, "n_utts": 16,
            "min_tokens": 20, "max_tokens": 80, "dev_split": ["dev"],
            "test_split": ["test"], "bucketing": False}}
        test["decode"].update(lm_path=os.path.join(tmp, "lm.pth"),
                              lm_config=lm_config)
        with open(os.path.join(tmp, "example_test.yaml"), "w") as f:
            yaml.safe_dump(test, f)
        outdir = os.path.join(tmp, "out")
        _reset_counts()
        tester = main(["--test", "--config",
                       os.path.join(tmp, "example_test.yaml"), "--name",
                       "example", "--njobs", "0", "--seed", str(seed),
                       "--outdir", outdir, "--no-msg"])
        dcounts = _read_counts()
        if (tester.beam_size, tester.lm_weight, tester.dec_ctc_weight,
                tester.lm_spec.n_layers, tester.lm_spec.emb_tying) != (
                    20, 0.5, 0.0, 2, False):
            raise AssertionError("asr_example decode: not beam 20 + the "
                                 "untied 2-layer LM 0.5")
        n_batches = len(tester.dv_set) + len(tester.tt_set)
        _expect_counts("asr_example decode", dcounts,
                       {"bilstm_fwd": 5 * n_batches})
        _check_csvs(outdir, "example", 20, _vocab_chars(tester.tokenizer))
        res["beam"] = {"utts": tester.n_utts, "batches": n_batches,
                       "decode_s": tester.decode_seconds,
                       "rtf": tester.decode_seconds / tester.audio_seconds}
    _say("frontends", "(a) config/libri/asr_example.yaml (vgg 1, 5x "
         "BLSTM-512, 1-layer decoder 512, attention only, subword-256), {} "
         "steps at batch 16: losses {}, grad norms {}; first step {:.3f} s, "
         "median step after it {:.4f} s -> {:.2f} utts/s, {:.2f} s of audio "
         "per s; peak allocated {:.2f} GiB; every K1/K2 launch resident; "
         "launches {} (= expected); config/libri/decode_example.yaml's beam "
         "20 + LM 0.5 (2x LSTM-1024, untied) on its checkpoint: {} utts in "
         "{:.3f} s (RTF {:.5f}), CSVs ok, K1 {} (= 5 x {} batches)".format(
             res["steps"], res["losses"], res["gnorms"], res["first_step_s"],
             res["median_step_s"], res["utts_per_s"], res["audio_s_per_s"],
             res["peak_mem_gb"], {k: v for k, v in counts.items() if v},
             res["beam"]["utts"], res["beam"]["decode_s"],
             res["beam"]["rtf"], dcounts["bilstm_fwd"], n_batches))
    return {"train": counts, "decode": dcounts}, res


def _frontends_upstream(seed, dev):
    """10(b): ``--upstream apc`` with $APC_CKPT at a path that does not
    exist yet: the factory pretrains APC on the card (APC_PRETRAIN_STEPS
    steps of 8 crops of 2 s, 3x LSTM-512; counts reset around it), then
    config/librispeech_asr_upstream.yaml's blocks (vgg 7, 1x BLSTM-256, CTC
    only, the phone set) train UPSTREAM_STEPS steps at batch 16 over it, and
    ``--test --upstream apc`` decodes the checkpoint through the CTC prefix
    beam (beam 8). Returns the counts by path and the results."""
    import contextlib
    import io
    from e2e_asr_pytorch_tpu_torch.data import upstream as U
    from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as K
    from e2e_asr_pytorch_tpu_torch.ops.kernels import lstm as KL
    old_ckpt = os.environ.get("APC_CKPT")
    res = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_apc_") as tmp:
        ckpt = os.path.join(tmp, "apc", "apc.npz")
        os.environ["APC_CKPT"] = ckpt
        U._REGISTRY.pop("apc", None)
        try:
            log = io.StringIO()
            k5 = _k5_forms()
            t0 = time.perf_counter()
            _reset_counts()
            with contextlib.redirect_stdout(log):
                fn, dim = U.get_upstream("apc", dev)
            pre = _read_counts()
            pre_s = time.perf_counter() - t0
            steps = APC_PRETRAIN_STEPS
            _expect_counts("apc pretraining", pre, {"lstm_fwd": 3 * steps,
                                                    "lstm_bwd": 3 * steps})
            _check_k5_forms(k5, pre, "narrow", "apc pretraining")
            done = [l for l in log.getvalue().splitlines()
                    if "APC pretrain done" in l]
            if not os.path.exists(ckpt) or dim != 512 or not done:
                raise AssertionError("apc: no checkpoint written, dim {}"
                                     .format(dim))
            l1 = [float(x) for x in done[0].split("L1 ")[1].split(" -> ")]
            if not all(math.isfinite(x) for x in l1):
                raise AssertionError("apc: L1 {}".format(l1))
            res["apc_pretrain"] = {"steps": steps, "seconds": pre_s,
                                   "first_l1": l1[0], "last_l1": l1[1],
                                   "launches": pre}

            def expected(solver):
                batches = solver.step + solver.n_valid_batches
                return {"bilstm_fwd": batches, "bilstm_bwd": solver.step,
                        "lstm_fwd": 3 * batches}
            forms = _k12_forms(K)
            solver, counts, tres, test_cfg, _ = _run_train(
                tmp, seed, dev, UPSTREAM_STEPS, expected,
                source="librispeech_asr_upstream.yaml",
                extra_argv=["--upstream", "apc"])
            _resident_forms(K, forms, counts, "upstream")
            spec = solver.spec
            if (solver.feat_dim != 512 or solver.step_cfg.upstream is not fn
                    or spec.encoder.frontend.vgg != 7 or spec.enable_att
                    or spec.encoder.dim != (256,)):
                raise AssertionError("upstream: not vgg 7 + 1x BLSTM-256, "
                                     "CTC only, over the 512-wide APC")
            if sorted(solver.params) != ["ctc_layer", "encoder"]:
                raise AssertionError("upstream: parameters {}".format(
                    sorted(solver.params)))
            res["train"] = tres
            before = KL.FWD_NARROW_LAUNCHES
            tester, dcounts = _decode_checkpoint(
                tmp, seed, test_cfg, "upstream", 8,
                extra_argv=["--upstream", "apc"])
            n_batches = len(tester.dv_set) + len(tester.tt_set)
            _expect_counts("upstream decode", dcounts, {
                "bilstm_fwd": n_batches, "lstm_fwd": 3 * n_batches})
            if KL.FWD_NARROW_LAUNCHES - before != 3 * n_batches:
                raise AssertionError("upstream decode: K5f not all narrow")
            res["decode"] = {"utts": tester.n_utts, "batches": n_batches,
                             "decode_s": tester.decode_seconds,
                             "rtf": tester.decode_seconds
                             / tester.audio_seconds}
        finally:
            U._REGISTRY.pop("apc", None)
            if old_ckpt is None:
                os.environ.pop("APC_CKPT", None)
            else:
                os.environ["APC_CKPT"] = old_ckpt
    p, t, d = res["apc_pretrain"], res["train"], res["decode"]
    _say("frontends", "(b) --upstream apc with no checkpoint: APC "
         "auto-pretrained on the card, {} steps in {:.1f} s, L1 {:.4f} -> "
         "{:.4f}, K5f = K5b = {} (all narrow); config/librispeech_asr_"
         "upstream.yaml (vgg 7, 1x BLSTM-256, CTC only) over it, {} steps at "
         "batch 16: losses {}, grad norms {}; first step {:.3f} s, median "
         "step after it {:.4f} s -> {:.2f} utts/s; peak allocated {:.2f} "
         "GiB; launches {} (= expected); --test --upstream apc, CTC prefix "
         "beam 8: {} utts in {:.3f} s (RTF {:.5f}), CSVs ok, launches {}"
         .format(p["steps"], p["seconds"], p["first_l1"], p["last_l1"],
                 p["launches"]["lstm_fwd"], t["steps"], t["losses"],
                 t["gnorms"], t["first_step_s"], t["median_step_s"],
                 t["utts_per_s"], t["peak_mem_gb"],
                 {k: v for k, v in counts.items() if v}, d["utts"],
                 d["decode_s"], d["rtf"],
                 {k: v for k, v in dcounts.items() if v}))
    paths = {"apc_pretrain": pre,
             "upstream": {k: counts[k] + dcounts[k] for k in counts}}
    return paths, res


def _frontends_codes(seed, dev):
    """10(c): vgg 2, 3 and 4 over fbank 40 + deltas, and vgg 1 over mfcc 13
    + deltas, each under asr_example's blocks cut to one BLSTM-512 layer:
    one train_step at batch 16 on the card (finite losses and gradients,
    every frontend leaf moved, K1 / K2 launched); each frontend's output on
    the card (cuDNN, f32, TF32 off) against the CPU's (FRONTEND_ATOL, the
    CPU parity tests' bound); feat_to_wave on one utterance on the card
    against the CPU (WAVE_ATOL)."""
    import torch
    import yaml
    from e2e_asr_pytorch_tpu_torch.convert import tree_leaves, tree_to
    from e2e_asr_pytorch_tpu_torch.models import asr as M
    from e2e_asr_pytorch_tpu_torch.models import frontend as F
    from e2e_asr_pytorch_tpu_torch.ops import audio as A
    from e2e_asr_pytorch_tpu_torch.train import optim as O
    from e2e_asr_pytorch_tpu_torch.train import train_asr as T
    with open(os.path.join(ROOT, "config", "libri", "asr_example.yaml")) as f:
        cfg = yaml.safe_load(f)
    enc = dict(cfg["model"]["encoder"], prenet="", dim=[512], dropout=[0],
               layer_norm=[False], proj=[True], sample_rate=[1])
    fbank = dict(cfg["data"]["audio"])
    mfcc = dict(fbank, feat_type="mfcc", feat_dim=13)
    cases = {"vgg 2": (dict(vgg=2, vgg_freq=20, vgg_low_filt=32), fbank),
             "vgg 3": (dict(vgg=3), fbank),
             "vgg 4": (dict(vgg=4, vgg_freq=20, vgg_low_filt=32), fbank),
             "mfcc, vgg 1": (dict(vgg=1), mfcc)}
    gen = torch.Generator().manual_seed(seed)
    b, n_s, vocab = 16, 96000, 64
    wav = (0.1 * torch.randn(b, n_s, generator=gen)).to(dev)
    wav_len = torch.linspace(n_s // 2, n_s, b).long().to(dev)
    txt = torch.randint(3, vocab, (b, 30), generator=gen).to(dev)
    txt_len = torch.full((b,), 30).to(dev)
    res = {}
    for label, (codes, audio) in cases.items():
        fcfg = A.FeatureConfig(**audio)
        model = dict(cfg["model"], encoder=dict(enc, **codes))
        spec = M.build_spec(fcfg.out_dim, vocab, **model)
        params = M.asr_init(torch.Generator().manual_seed(seed), spec, dev)
        before = [x.clone() for x in tree_leaves(
            params["encoder"]["frontend"])]
        opt = O.build_optimizer(**cfg["hparas"])
        step_cfg = T.StepConfig(spec, fcfg, opt, torch.bfloat16)
        _reset_counts()
        _, _, metrics, _, _ = T.train_step(
            step_cfg, params, opt.init(params),
            {"wav": wav, "wav_len": wav_len, "txt": txt, "txt_len": txt_len},
            torch.Generator(device=dev).manual_seed(seed), 1.0)
        counts = _read_counts()
        # (no CTC head, no emb plugin: their metrics are the nan sentinel)
        vals = {k: float(v) for k, v in metrics.items()
                if k not in ("ctc", "emb")}
        if not all(math.isfinite(v) for v in vals.values()):
            raise AssertionError("{}: metrics {}".format(label, vals))
        after = tree_leaves(params["encoder"]["frontend"])
        still = [i for i, (x, y) in enumerate(zip(before, after))
                 if torch.equal(x, y)]
        if still or counts["bilstm_fwd"] != 1 or counts["bilstm_bwd"] != 1:
            raise AssertionError("{}: frontend leaves {} did not move, "
                                 "launches {}".format(label, still, counts))
        # the frontend alone, f32, card against CPU
        feat, feat_len = A.extract_features(fcfg, wav[:2, :32000],
                                            wav_len[:2].clamp(max=32000))
        fp = params["encoder"]["frontend"]
        y_card, _ = F.frontend_apply(fp, spec.encoder.frontend, feat,
                                     feat_len)
        y_cpu, _ = F.frontend_apply(tree_to(fp, "cpu"),
                                    spec.encoder.frontend, feat.cpu(),
                                    feat_len.cpu())
        err = (y_card.cpu() - y_cpu).abs().max().item()
        if err > FRONTEND_ATOL:
            raise AssertionError("{}: frontend card vs CPU {:.3e}".format(
                label, err))
        res[label] = dict(vals, frontend_leaves=len(after),
                          card_vs_cpu=err, out_dim=spec.encoder.frontend
                          .out_dim)
        _say("frontends", "(c) {}: one step at batch 16, loss {:.4f}, grad "
             "norm {:.4f}, all {} frontend leaves moved, K1 = K2 = 1; the "
             "frontend (out {} wide) on the card vs the CPU, f32: max|err| "
             "{:.3e} (tol {})".format(label, vals["total"], vals["gnorm"],
                                      len(after), res[label]["out_dim"], err,
                                      FRONTEND_ATOL))
    fcfg = A.FeatureConfig(feat_dim=80)
    feat, feat_len = A.extract_features(fcfg, wav[:1], wav_len[:1])
    feat = feat[0, :int(feat_len[0])]
    phase = torch.rand(feat.shape[0], 1 + fcfg.n_fft // 2,
                       generator=gen) * 2 * math.pi
    w_card, _ = A.feat_to_wave(fcfg, feat, GL_ITERS, phase=phase.to(dev))
    w_cpu, _ = A.feat_to_wave(fcfg, feat.cpu(), GL_ITERS, phase=phase)
    err = (w_card.cpu() - w_cpu).abs().max().item()
    if err > WAVE_ATOL or not bool(torch.isfinite(w_card).all()):
        raise AssertionError("feat_to_wave card vs CPU {:.3e}".format(err))
    res["feat_to_wave"] = err
    _say("frontends", "(c) feat_to_wave ({} Griffin-Lim iterations) of a "
         "{:.1f} s utterance on the card vs the CPU: max|err| {:.3e} (tol "
         "{})".format(GL_ITERS, feat.shape[0] / 100, err, WAVE_ATOL))
    return res


def phase_frontends(seed, dev):
    """Phase 10: the example recipe, the APC upstream and the other
    frontends. Returns the launch counts by path and the results; fails if
    anything was written inside the repo."""
    top = set(os.listdir(ROOT))
    paths, results = {}, {}
    counts, results["asr_example"] = _timed("frontends (a)",
                                            _frontends_example, seed, dev)
    paths["asr_example"] = {k: counts["train"][k] + counts["decode"][k]
                            for k in counts["train"]}
    up_paths, results["upstream"] = _timed("frontends (b)",
                                           _frontends_upstream, seed, dev)
    paths.update(up_paths)
    results["codes"] = _timed("frontends (c)", _frontends_codes, seed, dev)
    if set(os.listdir(ROOT)) != top or os.path.exists(
            os.path.join(ROOT, "ckpt", "apc.npz")):
        raise AssertionError("phase 10 wrote inside the repo: {}".format(
            sorted(set(os.listdir(ROOT)) ^ top)))
    _no_jax()
    _say("frontends", json.dumps(results))
    return paths, results


def phase_agree(dev):
    """A small model decoded on the card (kernel, f32) and on the CPU
    (plain version, f32): beam 4 + LM, and with joint CTC 0.3 too, give the
    same tokens, scores within 1e-3; its encoder and CTC head as a CTC-only
    model (ctc_weight 1) through the CTC prefix beam + LM likewise."""
    import torch
    from e2e_asr_pytorch_tpu_torch.convert import tree_to
    from e2e_asr_pytorch_tpu_torch.decode.beam import BeamConfig, beam_decode
    from e2e_asr_pytorch_tpu_torch.decode.ctc_beam import (CTCBeamConfig,
                                                           ctc_beam_decode)
    from e2e_asr_pytorch_tpu_torch.models import asr as M
    from e2e_asr_pytorch_tpu_torch.models import encoder as E
    from e2e_asr_pytorch_tpu_torch.models import lm as LM
    from e2e_asr_pytorch_tpu_torch.ops.audio import (FeatureConfig,
                                                     extract_features)
    model = dict(
        ctc_weight=0.5,
        encoder=dict(vgg=5, dim=[64, 64], dropout=[0.0, 0.0],
                     layer_norm=[False, False], proj=[True, True],
                     sample_rate=[1, 1], sample_style="drop"),
        attention=dict(mode="loc", dim=32, num_head=1, v_proj=False,
                       temperature=0.5, loc_kernel_size=20,
                       loc_kernel_num=5),
        decoder=dict(module="LSTM", dim=64, layer=2, dropout=0.0))
    gen = torch.Generator().manual_seed(1)
    spec = M.build_spec(120, 31, **model)
    params = M.asr_init(gen, spec)
    ctc_spec = M.build_spec(120, 31, **dict(model, ctc_weight=1.0))
    ctc_params = {k: params[k] for k in ("encoder", "ctc_layer")}
    lm_spec = LM.build_spec(31, True, 64, "LSTM", 64, 2, 0.0)
    lm_params = LM.lm_init(gen, lm_spec)
    fcfg = FeatureConfig(feat_dim=40, delta_order=2)
    wav = 0.3 * torch.randn(4, 32000, generator=gen)
    wav_len = torch.tensor([32000, 30000, 21000, 16000])

    def beam(where, feat, feat_len, ctc_weight):
        cfg = BeamConfig(beam_size=4, min_len_ratio=0.01, max_len_ratio=0.1,
                         ctc_weight=ctc_weight, lm_weight=0.3, max_steps=20)
        return beam_decode(tree_to(params, where), spec, cfg, feat, feat_len,
                           tree_to(lm_params, where), lm_spec)

    def ctc_beam(where, feat, feat_len):
        p = tree_to(ctc_params, where)
        with torch.no_grad():
            enc, enc_len = E.encoder_apply(p["encoder"], ctc_spec.encoder,
                                           feat, feat_len)
            logp = M.ctc_log_probs(p, ctc_spec, enc)
        out = ctc_beam_decode(logp, enc_len, CTCBeamConfig(
            beam_size=4, cand_size=8, max_tokens=20, lm_weight=0.3),
            tree_to(lm_params, where), lm_spec)
        return dict(out, avg_scores=out["scores"])

    runs = {"beam-4 + LM": lambda *a: beam(*a, 0.0),
            "beam-4 + LM + CTC 0.3": lambda *a: beam(*a, 0.3),
            "CTC prefix beam-4 + LM (ctc_weight 1)": ctc_beam}
    for label, run in runs.items():
        outs = {}
        for where in ("cpu", dev):
            feat, feat_len = extract_features(fcfg, wav.to(where),
                                              wav_len.to(where))
            out = run(where, feat, feat_len)
            outs[str(where)] = {k: v.cpu() for k, v in out.items()}
        a, b = outs["cpu"], outs[str(dev)]
        score_err = (a["avg_scores"] - b["avg_scores"]).abs().max().item()
        if not torch.equal(a["tokens"], b["tokens"]) or score_err > 1e-3:
            raise AssertionError("{}: card and CPU decodes differ: score err "
                                 "{:.3e}".format(label, score_err))
        _say("agree", "{} on a 2x BLSTM-64 model: card (kernel) and CPU "
             "(plain) tokens equal, max|score err| {:.3e}".format(
                 label, score_err))


def _generic_expected(solver):
    """The launches of a run on the generic decoder scan: the listener's
    K1 a layer and batch, K2 a layer and step; the scan streams the bf16
    value table, so K3 / K4 do not launch."""
    n = len(solver.spec.encoder.dim)
    steps = len(solver.step_seconds)
    return {"bilstm_fwd": n * (steps + solver.n_valid_batches),
            "bilstm_bwd": n * steps}


def _folded_expected(solver):
    """The launches of a run on the folded decoder (as phase 5), counted
    over the steps this run took (a resumed run starts past step 0)."""
    return dict(_generic_expected(solver),
                context_int8=sum(solver.decode_lengths),
                dattn_int8=sum(solver.decode_lengths))


def _runtime_say(label, res, phase="runtime"):
    _say(phase, "{}: {} steps at batch 16: losses {}, grad norms {}; "
         "first step {:.3f} s, median step after it {:.4f} s -> {:.2f} "
         "utts/s; peak allocated {:.2f} GiB; launches {} (= expected); {} "
         "of {} leaves moved".format(
             label, len(res["losses"]), res["losses"], res["gnorms"],
             res["first_step_s"], res["median_step_s"], res["utts_per_s"],
             res["peak_mem_gb"],
             {k: v for k, v in res["launches"].items() if v},
             res["moved_leaves"], res["n_leaves"]))


def _runtime_sampling(seed, dev, tmp, flagship):
    """11(a): the flagship verbatim but tf_end 0.8 over tf_step 2: the
    generic scan, scheduled sampling falling inside the run."""
    solver, counts, res, _, _ = _run_train(
        tmp, seed, dev, SS_STEPS, _generic_expected, utts=RUNTIME_UTTS,
        hparas=dict(tf_end=0.8, tf_step=2))
    res["tf_rates"] = [st["tf_rate"] for st in solver.step_stats]
    if res["tf_rates"] != [1.0, 0.9, 0.8][:SS_STEPS]:
        raise AssertionError("(a): tf_rate by step {}".format(
            res["tf_rates"]))
    if any(k.startswith("/decoder/") for k in res["unmoved"]):
        raise AssertionError("(a): decoder leaves did not move: {}".format(
            [k for k in res["unmoved"] if k.startswith("/decoder/")]))
    if not any("folded decoder fast path not taken" in w
               for w in res["warnings"]):
        raise AssertionError("(a): no value_table warning: {}".format(
            res["warnings"]))
    _runtime_say("(a) scheduled sampling (tf_rate by step {})".format(
        res["tf_rates"]), res)
    return counts, res


def _runtime_gru(seed, dev, tmp, flagship):
    """11(b): a GRU decoder, 2 heads, decoder dropout 0.1, pure teacher
    forcing; then greedy and beam 8 + the flagship's LM at 0.3 on the
    checkpoint."""
    import yaml
    import torch
    from e2e_asr_pytorch_tpu_torch.models import lm as LM
    from e2e_asr_pytorch_tpu_torch.train.checkpoint import save_checkpoint
    model = dict(flagship,
                 attention=dict(flagship["attention"], num_head=2),
                 decoder=dict(flagship["decoder"], module="GRU",
                              dropout=0.1))
    solver, counts, res, test_cfg, _ = _run_train(
        tmp, seed, dev, GRU_DEC_STEPS, _generic_expected, model=model,
        utts=RUNTIME_UTTS)
    if any(k.startswith("/decoder/") for k in res["unmoved"]):
        raise AssertionError("(b): decoder leaves did not move")
    _runtime_say("(b) GRU decoder, 2 heads, dropout 0.1", res)
    with open(os.path.join(ROOT, "config", "librispeech_lm_best.yaml")) as f:
        lm_model = yaml.safe_load(f)["model"]
    with open(os.path.join(tmp, "lm.yaml"), "w") as f:
        yaml.safe_dump({"model": lm_model}, f)
    lm_spec = LM.build_spec(solver.vocab_size, **lm_model)
    save_checkpoint(os.path.join(tmp, "lm.pth"), LM.lm_init(
        torch.Generator().manual_seed(seed + 1), lm_spec))
    lm = ["decode.lm_weight=0.3",
          "decode.lm_config=" + os.path.join(tmp, "lm.yaml"),
          "decode.lm_path=" + os.path.join(tmp, "lm.pth")]
    for mode, beam in (("greedy", 1), ("beam", 8)):
        tester, dcounts = _decode_checkpoint(tmp, seed, test_cfg, mode,
                                             beam, overrides=lm)
        n_batches = len(tester.dv_set) + len(tester.tt_set)
        want = dict.fromkeys(dcounts, 0)
        want["bilstm_fwd"] = len(solver.spec.encoder.dim) * n_batches
        if dcounts != want:
            raise AssertionError("(b) {}: launches {} where {} were "
                                 "expected".format(mode, dcounts, want))
        res[mode] = {"utts": tester.n_utts, "batches": n_batches,
                     "decode_s": tester.decode_seconds,
                     "rtf": tester.decode_seconds / tester.audio_seconds}
        counts = {k: counts[k] + dcounts[k] for k in counts}
        _say("runtime", "(b) {} + LM 0.3 ({}x LSTM-{}) of the checkpoint: "
             "{} utts in {} batches, {:.3f} s, RTF {:.5f}; launches {}; "
             "CSVs ok".format(mode if beam == 1 else "beam 8",
                              lm_spec.n_layers, lm_spec.dim, tester.n_utts,
                              n_batches, tester.decode_seconds,
                              res[mode]["rtf"],
                              {k: v for k, v in dcounts.items() if v}))
    return counts, res


def _runtime_transfer(seed, dev, tmp, src):
    """11(c): ``--load`` (a)'s checkpoint with transfer: {train_enc: [3, 4],
    train_dec: False}, 2 steps of the flagship (Adadelta, weight_decay 0,
    the folded decoder: K3 / K4 launch)."""
    import torch
    from e2e_asr_pytorch_tpu_torch.train.checkpoint import load_checkpoint
    start = SS_STEPS
    solver, counts, res, _, _ = _run_train(
        tmp, seed, dev, start + TUNE_STEPS, _folded_expected,
        utts=RUNTIME_UTTS, hparas=dict(valid_step=start + TUNE_STEPS),
        extra={"transfer": {"train_enc": [3, 4], "train_dec": False}},
        extra_argv=("--load", src), updates=TUNE_STEPS)
    if solver.config["hparas"].get("weight_decay", 0.0) != 0.0:
        raise AssertionError("(c): weight decay is on")
    loaded = _leaf_paths(load_checkpoint(src, dev)["model"])
    now = _leaf_paths(solver.params)
    trained = ("/encoder/layers/3/", "/encoder/layers/4/",
               "/encoder/frontend/")
    changed = [k for k in now if not torch.equal(loaded[k], now[k])]
    frozen_moved = [k for k in changed if not k.startswith(trained)]
    still = [k for k in now if k.startswith(trained[:2])
             and k not in changed]
    if frozen_moved or still:
        raise AssertionError("(c): frozen leaves moved {}, trained leaves "
                             "did not {}".format(frozen_moved, still))
    names = os.listdir(os.path.join(tmp, "ckpt", "train"))
    if (solver.save_name != "_tune-34-0"
            or "last_att_dev_tune-34-0.pth" not in names
            or int(solver.opt_state["count"]) != TUNE_STEPS):
        raise AssertionError("(c): save name {!r}, files {}, {} updates"
                             .format(solver.save_name, names,
                                     int(solver.opt_state["count"])))
    res.update(frozen_leaves=len(now) - len(changed),
               moved_frontend=sum(k.startswith(trained[2]) for k in changed),
               checkpoint="last_att_dev_tune-34-0.pth")
    _runtime_say("(c) transfer, train_enc [3, 4], train_dec False, from "
                 "(a)'s step {}".format(start), res)
    _say("runtime", "(c) {} leaves bitwise as loaded (layers 0-2, decoder, "
         "attention, embedding, CTC head); layers 3-4 moved, and {} "
         "frontend leaves (JAX's transfer freezes rnn layers only); the "
         "optimizer started anew ({} updates); checkpoint {}".format(
             res["frozen_leaves"], res["moved_frontend"], TUNE_STEPS,
             res["checkpoint"]))
    return counts, res


def _runtime_optimizers(seed, dev, tmp_root):
    """11(d): AdamW, SGD and RMSprop, 2 steps each at the flagship's blocks
    (bf16 accumulators, as its hparas set)."""
    counts, results = None, {}
    for name, hp in (("AdamW", dict(lr=1e-3, weight_decay=0.01)),
                     ("SGD", dict(lr=0.05)), ("RMSprop", dict(lr=1e-4))):
        tmp = os.path.join(tmp_root, name)
        os.makedirs(tmp)
        _, c, res, _, rnn = _run_train(
            tmp, seed, dev, OPT_STEPS, _folded_expected, utts=RUNTIME_UTTS,
            hparas=dict(hp, optimizer=name))
        if rnn[0] != rnn[1]:
            raise AssertionError("(d) {}: {} of {} listener leaves moved"
                                 .format(name, *rnn))
        _runtime_say("(d) " + name, res)
        results[name] = res
        counts = c if counts is None else {k: counts[k] + c[k]
                                           for k in counts}
    return counts, results


def phase_runtime(seed, dev):
    """Phase 11: the rest of the training runtime at the flagship's blocks
    through the port's CLI: scheduled sampling, a GRU decoder with 2 heads
    and dropout (then decoded), transfer learning from (a)'s checkpoint,
    and the other optimizers. Returns the launch counts by path and the
    results."""
    import yaml
    with open(os.path.join(ROOT, "config", "librispeech_asr_best.yaml")) as f:
        flagship = yaml.safe_load(f)["model"]
    paths, results = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_rt_") as root:
        dirs = {k: os.path.join(root, k) for k in ("a", "b", "c", "d")}
        for d in dirs.values():
            os.makedirs(d)
        paths["runtime_sampling"], results["sampling"] = _timed(
            "runtime (a)", _runtime_sampling, seed, dev, dirs["a"], flagship)
        paths["runtime_gru_decoder"], results["gru_decoder"] = _timed(
            "runtime (b)", _runtime_gru, seed, dev, dirs["b"], flagship)
        src = os.path.join(dirs["a"], "ckpt", "train", "last_att_dev.pth")
        paths["runtime_transfer"], results["transfer"] = _timed(
            "runtime (c)", _runtime_transfer, seed, dev, dirs["c"], src)
        paths["runtime_optimizers"], results["optimizers"] = _timed(
            "runtime (d)", _runtime_optimizers, seed, dev, dirs["d"])
    _no_jax()
    _say("runtime", json.dumps(results))
    return paths, results


def _write_table(path, tokenizer, dim, seed):
    """A fasttext-format table of ``dim`` over the tokenizer's tokens (its
    specials as <pad>, </s>, <unk>), values drawn from ``seed``."""
    import numpy as np
    rng = np.random.default_rng(seed)
    names = ["<pad>", "</s>", "<unk>"] + [
        tokenizer.decode([i]) for i in range(3, tokenizer.vocab_size)]
    rows = [n for n in names if n and " " not in n]
    with open(path, "w") as f:
        f.write("{} {}\n".format(len(rows), dim))
        for n in rows:
            f.write(n + " " + " ".join("%.5f" % x for x in
                                       rng.standard_normal(dim)) + "\n")
    return path


def _plugin_emb(tmp, seed):
    from e2e_asr_pytorch_tpu_torch.data.tokenizer import load_text_encoder
    import yaml
    with open(os.path.join(ROOT, "config", "librispeech_asr_best.yaml")) as f:
        text = yaml.safe_load(f)["data"]["text"]
    tok = load_text_encoder(text["mode"], os.path.join(ROOT,
                                                       text["vocab_file"]))
    path = _write_table(os.path.join(tmp, "emb.vec"), tok, PLUGIN_TABLE_DIM,
                        seed)
    return {"enable": True, "src": path, "distance": "CosEmb",
            "weight": 0.3, "fuse": -1, "temperature": 1.0, "freeze": True,
            "fuse_normalize": False, "dropout": 0.0}


def _plugin_train(seed, dev, tmp, emb, extra_argv=()):
    """A fused flagship run of PLUGIN_STEPS steps (the folded decoder:
    training takes no fusion hook) with the checks of phase 5 and the
    plugin's own."""
    import torch
    solver, counts, res, test_cfg, _ = _run_train(
        tmp, seed, dev, PLUGIN_STEPS, _folded_expected, utts=RUNTIME_UTTS,
        extra={"emb": emb}, extra_argv=extra_argv)
    embs = [st["emb"] for st in solver.step_stats]
    if not all(math.isfinite(x) for x in embs):
        raise AssertionError("plugin: emb losses {}".format(embs))
    from e2e_asr_pytorch_tpu_torch.models.plugin import load_embedding_table
    plug = solver.full_params()["emb_plugin"]
    lam = plug["fuse_lambda"].float()
    if torch.equal(lam, torch.full_like(lam, 0.5)):
        raise AssertionError("plugin: the learnable lambda did not move")
    table = torch.from_numpy(load_embedding_table(solver.tokenizer,
                                                  emb["src"]))
    if not torch.equal(plug["emb_table"].cpu(), table):
        raise AssertionError("plugin: the frozen table moved")
    res.update(emb_losses=[round(x, 5) for x in embs],
               fuse_lambda=float(torch.sigmoid(lam).mean()),
               table_dim=int(plug["emb_table"].shape[1]))
    return solver, counts, res, test_cfg


def _plugin_decodes(seed, tmp, solver, test_cfg, res):
    """(a)'s decodes: beam 8 + LM 0.3, then greedy, both over the fused
    distribution."""
    import yaml
    import torch
    from e2e_asr_pytorch_tpu_torch.models import lm as LM
    from e2e_asr_pytorch_tpu_torch.train.checkpoint import save_checkpoint
    with open(os.path.join(ROOT, "config", "librispeech_lm_best.yaml")) as f:
        lm_model = yaml.safe_load(f)["model"]
    with open(os.path.join(tmp, "lm.yaml"), "w") as f:
        yaml.safe_dump({"model": lm_model}, f)
    lm_spec = LM.build_spec(solver.vocab_size, **lm_model)
    save_checkpoint(os.path.join(tmp, "lm.pth"), LM.lm_init(
        torch.Generator().manual_seed(seed + 1), lm_spec))
    lm = ["decode.lm_weight=0.3",
          "decode.lm_config=" + os.path.join(tmp, "lm.yaml"),
          "decode.lm_path=" + os.path.join(tmp, "lm.pth")]
    total = None
    for mode, beam, overrides in (("beam", 8, lm), ("greedy", 1, ())):
        tester, dcounts = _decode_checkpoint(tmp, seed, test_cfg, mode,
                                             beam, overrides=overrides)
        if tester.emb_reg is None or not tester.emb_reg.apply_fuse:
            raise AssertionError("plugin {}: no fusing plugin".format(mode))
        n_batches = len(tester.dv_set) + len(tester.tt_set)
        want = dict.fromkeys(dcounts, 0)
        want["bilstm_fwd"] = len(solver.spec.encoder.dim) * n_batches
        if dcounts != want:
            raise AssertionError("plugin {}: launches {} where {} were "
                                 "expected".format(mode, dcounts, want))
        res[mode] = {"utts": tester.n_utts, "batches": n_batches,
                     "decode_s": tester.decode_seconds,
                     "rtf": tester.decode_seconds / tester.audio_seconds}
        total = dcounts if total is None else {k: total[k] + dcounts[k]
                                               for k in total}
        _say("plugin_mesh", "(a) fused {}{} of the checkpoint: {} utts in "
             "{} batches, {:.3f} s, RTF {:.5f}; launches {}; CSVs ok".format(
                 "greedy" if beam == 1 else "beam 8",
                 " + LM 0.3 ({}x LSTM-{})".format(lm_spec.n_layers,
                                                  lm_spec.dim)
                 if overrides else "", tester.n_utts, n_batches,
                 tester.decode_seconds, res[mode]["rtf"],
                 {k: v for k, v in dcounts.items() if v}))
    return total


def _plugin_agree(dev, seed):
    """(b): a small model with a fusing plugin decoded on the card and the
    CPU (f32): greedy and beam 4 + LM give the same tokens."""
    import torch
    from e2e_asr_pytorch_tpu_torch.convert import tree_to
    from e2e_asr_pytorch_tpu_torch.decode.beam import BeamConfig, beam_decode
    from e2e_asr_pytorch_tpu_torch.decode.greedy import greedy_decode
    from e2e_asr_pytorch_tpu_torch.models import asr as M
    from e2e_asr_pytorch_tpu_torch.models import lm as LM
    from e2e_asr_pytorch_tpu_torch.models import plugin as P
    from e2e_asr_pytorch_tpu_torch.ops.audio import (FeatureConfig,
                                                     extract_features)
    model = dict(
        ctc_weight=0.5,
        encoder=dict(vgg=5, dim=[64, 64], dropout=[0.0, 0.0],
                     layer_norm=[False, False], proj=[True, True],
                     sample_rate=[1, 1], sample_style="drop"),
        attention=dict(mode="loc", dim=32, num_head=1, v_proj=False,
                       temperature=0.5, loc_kernel_size=20,
                       loc_kernel_num=5),
        decoder=dict(module="LSTM", dim=64, layer=2, dropout=0.0))
    gen = torch.Generator().manual_seed(seed + 12)
    spec = M.build_spec(120, 31, **model)
    params = M.asr_init(gen, spec)
    pspec = P.EmbPluginSpec(dim=PLUGIN_TABLE_DIM, dec_dim=64,
                            distance="CosEmb", weight=0.3, fuse=-1,
                            temperature=-1, freeze=True,
                            fuse_normalize=False, dropout=0.0,
                            vocab_size=31)
    params["emb_plugin"] = {
        "net1": {"w": torch.randn(64, 182, generator=gen) / 8,
                 "b": torch.zeros(182)},
        "net2": {"w": torch.randn(182, PLUGIN_TABLE_DIM, generator=gen) / 13,
                 "b": torch.zeros(PLUGIN_TABLE_DIM)},
        "fuse_lambda": torch.tensor([0.4]), "temp": torch.tensor([1.5]),
        "emb_table": torch.randn(31, PLUGIN_TABLE_DIM, generator=gen)}
    reg = P.EmbeddingRegularizer(pspec, params["emb_plugin"])
    lm_spec = LM.build_spec(31, True, 64, "LSTM", 64, 2, 0.0)
    lm_params = LM.lm_init(gen, lm_spec)
    fcfg = FeatureConfig(feat_dim=40, delta_order=2)
    wav = 0.3 * torch.randn(4, 32000, generator=gen)
    wav_len = torch.tensor([32000, 30000, 21000, 16000])
    outs = {}
    for where in ("cpu", dev):
        p = tree_to(params, where)
        feat, feat_len = extract_features(fcfg, wav.to(where),
                                          wav_len.to(where))
        g = greedy_decode(p, spec, feat, feat_len, 20, emb_reg=reg,
                          emb_params=p["emb_plugin"])
        b = beam_decode(p, spec, BeamConfig(
            beam_size=4, min_len_ratio=0.01, max_len_ratio=0.1,
            lm_weight=0.3, max_steps=20), feat, feat_len,
            tree_to(lm_params, where), lm_spec, emb_reg=reg,
            emb_params=p["emb_plugin"])
        outs[str(where)] = (g["att_tokens"].cpu(), b["tokens"].cpu(),
                            b["avg_scores"].cpu())
    a, c = outs["cpu"], outs[str(dev)]
    err = (a[2] - c[2]).abs().max().item()
    if not (torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])) \
            or err > 1e-3:
        raise AssertionError("(b): card and CPU fused decodes differ "
                             "(score err {:.3e})".format(err))
    _say("plugin_mesh", "(b) fused greedy and beam-4 + LM on a 2x BLSTM-64 "
         "model: card (kernel) and CPU (plain) tokens equal, max|score err| "
         "{:.3e}".format(err))


def _mesh_one_rank(seed, dev, tmp, emb, ref_solver, ref_counts, a_tmp,
                   test_cfg):
    """(c): (a)'s run with ``--n-devices 1`` (NCCL, one rank), held against
    (a)'s parameters; then a one-rank greedy decode of (a)'s checkpoint."""
    import torch
    from e2e_asr_pytorch_tpu_torch.parallel import mesh as mesh_lib
    solver, counts, res, _ = _plugin_train(seed, dev, tmp, emb,
                                           extra_argv=("--n-devices", "1"))
    if solver.mesh is None or solver.mesh.world_size != 1 \
            or mesh_lib.current() is not None:
        raise AssertionError("(c): the run did not take a one-rank group "
                             "or did not leave it")
    if counts != ref_counts:
        raise AssertionError("(c): launches {} where (a) had {}".format(
            counts, ref_counts))
    # a one-rank all-reduce is a copy, and a run is bit-reproducible: the
    # losses and every leaf bit for bit
    losses = [[st["total"] for st in x.step_stats]
              for x in (ref_solver, solver)]
    if losses[0] != losses[1]:
        raise AssertionError("(c): losses {} where (a) had {}".format(
            losses[1], losses[0]))
    ref, got = _leaf_paths(ref_solver.params), _leaf_paths(solver.params)
    off = {k: ((got[k].float() - a.float()).abs().max().item(),
               a.float().abs().max().item())
           for k, a in ref.items() if not torch.equal(a, got[k])}
    if off:
        raise AssertionError("(c): {} of {} leaves differ from the run "
                             "without --n-devices ((|err|, largest |value|)): "
                             "{}".format(len(off), len(ref), off))
    res["bitwise_leaves"] = len(ref)
    _runtime_say("(c) --n-devices 1 (NCCL)", res, "plugin_mesh")
    _say("plugin_mesh", "(c) the losses {} and all {} leaves equal (a)'s bit "
         "for bit".format(losses[1], len(ref)))
    _reset_counts()
    tester, dcounts = _decode_checkpoint(
        a_tmp, seed, test_cfg, "greedy_mesh", 1,
        extra_argv=("--n-devices", "1"))
    for split in ("dev", "test"):
        names = ["{}_{}_output.csv".format(m, split)
                 for m in ("greedy", "greedy_mesh")]
        texts = []
        for n in names:
            with open(os.path.join(a_tmp, "out", n)) as f:
                texts.append(f.read())
        if texts[0] != texts[1]:
            raise AssertionError("(c): {} differs from {}".format(*names))
    _say("plugin_mesh", "(c) --test --n-devices 1 greedy of (a)'s "
         "checkpoint: {} utts, CSVs equal (a)'s byte for byte; launches "
         "{}".format(tester.n_utts, {k: v for k, v in dcounts.items() if v}))
    counts = {k: counts[k] + dcounts[k] for k in counts}
    return counts, res


def _plugin_bert(seed, dev, tmp):
    """(d): on-line BERT targets (MSE, weight 0.1, no fusion) from a
    randomly initialised 2-layer BertForMaskedLM of BERT-base's width (768)
    written from ``seed`` into ``tmp``, PLUGIN_STEPS flagship steps."""
    import torch
    import yaml
    # keep transformers off its TensorFlow and JAX backends, as the port's
    # predictor does
    os.environ.setdefault("USE_TF", "0")
    os.environ.setdefault("USE_FLAX", "0")
    import transformers
    from e2e_asr_pytorch_tpu_torch.data.tokenizer import load_text_encoder
    with open(os.path.join(ROOT, "config", "librispeech_asr_best.yaml")) as f:
        text = yaml.safe_load(f)["data"]["text"]
    tok = load_text_encoder(text["mode"], os.path.join(ROOT,
                                                       text["vocab_file"]))
    torch.manual_seed(seed)
    bert_dir = os.path.join(tmp, "bert")
    transformers.BertForMaskedLM(transformers.BertConfig(
        vocab_size=tok.vocab_size, hidden_size=768, num_hidden_layers=2,
        num_attention_heads=12, intermediate_size=3072,
        max_position_embeddings=512)).save_pretrained(bert_dir)
    emb = {"enable": True, "bert": "local", "src": bert_dir,
           "distance": "MSE", "weight": 0.1, "fuse": 0,
           "temperature": 1.0}
    solver, counts, res, _, _ = _run_train(
        tmp, seed, dev, PLUGIN_STEPS, _folded_expected, utts=RUNTIME_UTTS,
        extra={"emb": emb})
    embs = [st["emb"] for st in solver.step_stats]
    if (solver.emb_decoder.predictor is None
            or "emb_table" in solver.params["emb_plugin"]
            or not all(math.isfinite(x) for x in embs)):
        raise AssertionError("(d): BERT targets: emb losses {}".format(embs))
    res["emb_losses"] = [round(x, 5) for x in embs]
    _runtime_say("(d) on-line BERT targets (2x 768, MSE 0.1)", res,
                 "plugin_mesh")
    return counts, res


def phase_plugin_mesh(seed, dev):
    """Phase 12: the emb plugin at the flagship's blocks (train, fused beam
    8 + LM and greedy), the card-vs-CPU fused decode, and the one-rank NCCL
    mesh. Returns the launch counts of its main paths and the results."""
    import importlib.util
    have_bert = importlib.util.find_spec("transformers") is not None
    if not have_bert:
        _say("plugin_mesh", "transformers is not installed on this machine: "
             "the on-line BERT-target mode is not run here (its tests run on "
             "the CPU)")
    results = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pm_") as root:
        a_tmp, c_tmp = os.path.join(root, "a"), os.path.join(root, "c")
        os.makedirs(a_tmp)
        os.makedirs(c_tmp)
        emb = _plugin_emb(root, seed)
        solver, counts, res, test_cfg = _timed(
            "plugin_mesh", _plugin_train, seed, dev, a_tmp, emb)
        _runtime_say("(a) emb plugin, CosEmb 0.3, learnable lambda", res,
                     "plugin_mesh")
        _say("plugin_mesh", "(a) emb losses {}, mean sigmoid(lambda) "
             "{:.5f} after {} steps, table dim {}".format(
                 res["emb_losses"], res["fuse_lambda"], PLUGIN_STEPS,
                 res["table_dim"]))
        dcounts = _timed("plugin_mesh", _plugin_decodes, seed, a_tmp, solver,
                         test_cfg, res)
        results["plugin"] = res
        total = {k: counts[k] + dcounts[k] for k in counts}
        _timed("plugin_mesh", _plugin_agree, dev, seed)
        mcounts, results["mesh_one_rank"] = _timed(
            "plugin_mesh", _mesh_one_rank, seed, dev, c_tmp, emb, solver,
            counts, a_tmp, test_cfg)
        total = {k: total[k] + mcounts[k] for k in total}
        if have_bert:
            d_tmp = os.path.join(root, "d")
            os.makedirs(d_tmp)
            bcounts, results["bert"] = _timed("plugin_mesh", _plugin_bert,
                                              seed, dev, d_tmp)
            total = {k: total[k] + bcounts[k] for k in total}
    _no_jax()
    for r in results.values():
        r.pop("unmoved", None)
    _say("plugin_mesh", json.dumps(results))
    return {"plugin": total}, results


def _det_steps(label, solver, batches, step):
    """DET_STEPS steps of ``step(params, opt_state, batch, gen)`` (-> the
    step's loss) from the solver's state, twice from one copy of it, each
    step's generator seeded alike: the losses, every parameter leaf and
    the optimizer state bit for bit. Returns the leaves held."""
    import torch
    from e2e_asr_pytorch_tpu_torch.convert import tree_map
    runs = []
    for _ in range(2):
        params = tree_map(lambda x: x.clone(), solver.params)
        opt_state = tree_map(lambda x: x.clone(), solver.opt_state)
        losses = []
        for i, batch in enumerate(batches):
            solver.step = i
            losses.append(step(params, opt_state, batch, solver.step_gen()))
        torch.cuda.synchronize()
        runs.append((_leaf_paths(params), _leaf_paths(opt_state),
                     torch.stack(losses)))
    (p1, s1, l1), (p2, s2, l2) = runs
    off = [k for k in p1 if not torch.equal(p1[k], p2[k])]
    off += ["opt" + k for k in s1 if not torch.equal(s1[k], s2[k])]
    if off or not torch.equal(l1, l2):
        raise AssertionError("{}: {} steps run twice from one seed: losses "
                             "{} and {}; {} of {} leaves differ: {}".format(
                                 label, len(batches), l1.tolist(),
                                 l2.tolist(), len(off), len(p1) + len(s1),
                                 off[:20]))
    _say("determinism", "{}: {} steps run twice from one seed: the losses "
         "{}, all {} parameter leaves and all {} optimizer-state leaves bit "
         "for bit".format(label, len(batches), l1.tolist(), len(p1),
                          len(s1)))
    return len(p1)


def phase_determinism(seed, dev):
    """DET_STEPS flagship ASR steps and DET_STEPS steps of each LM
    (config/librispeech_lm_best.yaml, config/librispeech_lm.yaml), each run
    twice from one seed through the solvers' own ``train_step``: every leaf
    and loss bit for bit (12(c) holds the fused plugin's steps so against
    12(a)'s). The recurrence kernels' relaunches (phase 3) are summed up
    here."""
    import torch
    from e2e_asr_pytorch_tpu_torch.main import build_solver
    from e2e_asr_pytorch_tpu_torch.train import train_asr, train_lm
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_det_") as root:
        common = ["--njobs", "0", "--seed", str(seed), "--no-msg",
                  "--logdir", os.path.join(root, "log"), "--ckpdir",
                  os.path.join(root, "ckpt")]
        cfg, _, name = _write_train_configs(root, steps=DET_STEPS, utts=32)
        solver = build_solver(["--config", cfg, "--name", name] + common)
        solver.set_model()
        batches = [train_asr.to_device(solver.put_batch(d), dev)
                   for d, _ in zip(iter(solver.tr_set), range(DET_STEPS))]

        def asr_step(params, opt_state, batch, gen):
            return train_asr.train_step(
                solver.step_cfg, params, opt_state, batch, gen, 1.0,
                solver.spec.enable_ctc)[2]["total"]
        out["flagship ASR"] = _det_steps("flagship ASR", solver, batches,
                                         asr_step)
        del solver, batches
        for source in ("librispeech_lm_best.yaml", "librispeech_lm.yaml"):
            cfg, _ = _write_lm_config(root, source, DET_STEPS, DET_STEPS)
            solver = build_solver(["--lm", "--config", cfg, "--name",
                                   source[:-5]] + common)
            solver.set_model()
            batches = [torch.from_numpy(d["txt"]).to(dev).long()
                       for d, _ in zip(iter(solver.tr_set), range(DET_STEPS))]

            def lm_step(params, opt_state, txt, gen, solver=solver):
                return train_lm.train_step(solver.step_cfg, params,
                                           opt_state, txt, gen)[2]
            out[source] = _det_steps(source, solver, batches, lm_step)
            del solver, batches
    _say("determinism", "every recurrence kernel relaunched {} times on the "
         "same operands gave the same bits: {}".format(
             RELAUNCHES, json.dumps({k: len(v)
                                     for k, v in RELAUNCHED.items()})))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from e2e_asr_pytorch_tpu_torch.ops.kernels import bilstm as K
    from e2e_asr_pytorch_tpu_torch.ops.kernels import build

    smi = _nvidia_smi()
    name = torch.cuda.get_device_name(0)
    _say("device", "nvidia-smi: {} | torch: {} (torch {}, CUDA {}), {} "
         "card(s)".format(smi, name, torch.__version__, torch.version.cuda,
                          torch.cuda.device_count()))
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from concurrent.futures import ThreadPoolExecutor
    from e2e_asr_pytorch_tpu_torch.ops.kernels import gru as KG
    from e2e_asr_pytorch_tpu_torch.ops.kernels import int8_table as Q
    from e2e_asr_pytorch_tpu_torch.ops.kernels import ligru as KLG
    from e2e_asr_pytorch_tpu_torch.ops.kernels import lstm as KL
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    loaders = (K._library, K._bwd_library, Q._library, KL._fwd_library,
               KL._bwd_library, KG._library, KLG._library)
    with ThreadPoolExecutor(len(loaders)) as pool:
        list(pool.map(lambda f: f(), loaders))
    _say("build", "{} built for sm_90a in {:.2f} s".format(
        ", ".join(build.library_path(n).name for n in (
            "bilstm_fwd", "bilstm_bwd", "int8_table", "lstm_fwd",
            "lstm_bwd", "gru", "ligru")),
        time.perf_counter() - t0))

    PHASE_SECONDS["build"] = time.perf_counter() - t0
    k1_err, k1_form, k1_forms, k1_plain, k1_recs = _timed(
        "kernel", phase_kernel, dev)
    k2_err, k2_form, k2_forms, k2_plain, k2_recs = _timed(
        "kernel", phase_bwd, dev)
    q8 = _timed("kernel", phase_int8, dev)
    k56 = _timed("kernel", phase_lstm, dev)
    k78 = _timed("kernel", phase_gru, dev)
    # the yardsticks of K1/K2 at their main path's shape: the bound from the
    # shapes, and the cuDNN BLSTM of the same T, B, H fed the encoder's
    # 2H-wide input (K3/K4's library call is timed in phase_int8)
    t, b, h, _ = MAIN_SHAPE
    bi_f, bi_fb, bi_b, bi_xg = _library_lstm(dev, t, b, 2 * h, h, True)
    bi_bound = _lstm_bound(t, b, h, 2)
    _say("kernel", "K1 / K2 at T={} B={} H={}: bound {:.3f} ms ({}); library "
         "call torch.nn.LSTM (cuDNN, bf16, bidirectional, input projection "
         "included) forward {:.3f} ms, forward + backward {:.3f} ms, backward "
         "alone {:.3f} ms; the two xg matmuls alone {:.3f} ms".format(
             t, b, h, *bi_bound, bi_f, bi_fb, bi_b, bi_xg))
    # the same at phase 9's H=320 shape, a 2H-wide input as layers 1-3 take,
    # and at phase 10's (asr_example's layers 1-4, the upstream recipe's
    # layer over vgg 7's 256)
    for key, (t, b, h, _) in K12_RECORDS.items():
        in_dim = 256 if key == "at_h256" else 2 * h
        lib = _library_lstm(dev, t, b, in_dim, h, True)
        bound = _lstm_bound(t, b, h, 2)
        for rec in (k1_recs[key], k2_recs[key]):
            rec.update(shape="T={} B={} H={} bf16".format(t, b, h),
                       bound_ms=bound[0], bound_by=bound[1],
                       library_ms=lib[0] if rec is k1_recs[key] else lib[1])
        k2_recs[key]["library_bwd_ms"] = lib[2]
        _say("kernel", "K1 / K2 at T={} B={} H={} ({}), card {}: bound "
             "{:.3f} ms ({}); torch.nn.LSTM forward {:.3f} ms, forward + "
             "backward {:.3f} ms, backward alone {:.3f} ms, the xg matmuls "
             "{:.3f} ms; K1 {:.3f} ms, K2 {:.3f} ms".format(
                 t, b, h, key, smi, *bound, *lib, k1_recs[key]["ms"],
                 k2_recs[key]["ms"]))
    # K3 and K4 alike: the table read once, both small operands' f32 bytes
    qb, qt, qd = INT8_SHAPES[0]
    q_bound = _bound(2.0 * qb * qt * qd, qb * qt * qd + 4 * qb * (qt + qd))
    decode_launches, slice_results = _timed("slice", phase_slice, args.seed)
    train_counts, _ = _timed("train", phase_train, args.seed, dev)
    lm_counts, _, lm_forms = _timed("lm", phase_lm, args.seed, dev)
    enc_counts, _, enc_forms, k78_forms = _timed("encoders", phase_encoders,
                                                 args.seed, dev)
    _timed("agree", phase_agree, dev)
    chain_counts, _ = _timed("chain", phase_chain, args.seed, dev,
                             slice_results)
    fe_paths, _ = _timed("frontends", phase_frontends, args.seed, dev)
    rt_paths, _ = phase_runtime(args.seed, dev)
    pm_paths, _ = phase_plugin_mesh(args.seed, dev)
    _timed("determinism", phase_determinism, args.seed, dev)
    by_path = {k: {"slice": decode_launches if k == "bilstm_fwd" else 0,
                   "train": train_counts[k], "lm": lm_counts[k],
                   "encoders": enc_counts[k], "chain": chain_counts[k],
                   **{p: c[k] for p, c in fe_paths.items()},
                   **{p: c[k] for p, c in rt_paths.items()},
                   **{p: c[k] for p, c in pm_paths.items()}}
               for k in chain_counts}

    src = "e2e_asr_pytorch_tpu_torch/csrc/"
    tpu = "e2e_asr_pytorch_tpu/ops/pallas/"
    kernels = [
        dict(name="bilstm_fwd", source=src + "bilstm_fwd.cu",
             replaces=tpu + "lstm.py:458",
             launches=sum(by_path["bilstm_fwd"].values()),
             max_abs_err=k1_err, ms=k1_forms[k1_form], form=k1_form,
             ms_by_form=k1_forms, plain_ms=k1_plain, bound_ms=bi_bound[0],
             bound_by=bi_bound[1], library_ms=bi_f, library_xg_ms=bi_xg,
             **k1_recs),
        dict(name="bilstm_bwd", source=src + "bilstm_bwd.cu",
             replaces=tpu + "lstm.py:536",
             launches=sum(by_path["bilstm_bwd"].values()),
             max_abs_err=k2_err,
             ms=k2_forms[k2_form], form=k2_form, ms_by_form=k2_forms,
             plain_ms=k2_plain, bound_ms=bi_bound[0], bound_by=bi_bound[1],
             library_ms=bi_fb, library_bwd_ms=bi_b, library_xg_ms=bi_xg,
             **k2_recs),
        dict(name="context_int8", source=src + "int8_table.cu",
             replaces=tpu + "int8_table.py:105",
             launches=sum(by_path["context_int8"].values()),
             bound_ms=q_bound[0], bound_by=q_bound[1], **q8["context_int8"]),
        dict(name="dattn_int8", source=src + "int8_table.cu",
             replaces=tpu + "int8_table.py:115",
             launches=sum(by_path["dattn_int8"].values()),
             bound_ms=q_bound[0], bound_by=q_bound[1], **q8["dattn_int8"])]
    # K5f in its two forms: the narrow one is K1's kernel over one
    # direction, the wide one (the form of the main path's shape, whose
    # times the line gives) K6f's kernel with K5's contract
    for kname, source, line in (("lstm_fwd", "lstm_fwd.cu", 76),
                               ("lstm_bwd", "lstm_bwd.cu", 106),
                               ("lstm_fwd_chunked", "lstm_fwd.cu", 278),
                               ("lstm_bwd_chunked", "lstm_bwd.cu", 347)):
        extra = {}
        if kname == "lstm_fwd":
            extra["source_by_form"] = {"narrow": src + "bilstm_fwd.cu",
                                       "wide": src + source}
            extra["launches_by_form"] = {f: lm_forms[f] + enc_forms[f]
                                         for f in lm_forms}
        kernels.append(dict(name=kname, source=src + source,
                            replaces="{}lstm.py:{}".format(tpu, line),
                            launches=sum(by_path[kname].values()),
                            **extra, **k56[kname]))
    for kname, source, line in (("gru_fwd", "gru.cu", "gru.py:38"),
                               ("gru_bwd", "gru.cu", "gru.py:59"),
                               ("ligru_fwd", "ligru.cu", "ligru.py:29"),
                               ("ligru_bwd", "ligru.cu", "ligru.py:52")):
        extra = ({"launches_by_form": k78_forms[kname]}
                 if kname in k78_forms else {})
        kernels.append(dict(name=kname, source=src + source,
                            replaces=tpu + line,
                            launches=sum(by_path[kname].values()), **extra,
                            **k78[kname]))
    for k in kernels:
        if k["launches"] < 1:
            raise AssertionError("{} was never launched by the main paths"
                                 .format(k["name"]))
    PHASE_SECONDS["all"] = time.perf_counter() - start
    _say("time", "seconds by phase: {}".format(json.dumps(
        {k: round(v, 1) for k, v in PHASE_SECONDS.items()})))
    print(json.dumps({"kernels": [
        dict(k, route="cuda", launches_by_path=by_path[k["name"]])
        for k in kernels]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

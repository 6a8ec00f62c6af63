#!/usr/bin/env python3
"""Smoke run of the deepblast_torch port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py          # from the root of a checkout

It imports nothing of JAX or of ``deepblast_tpu``, catches no phase's
failure, and exits non-zero without printing a result when there is no
CUDA device or no ``deepblast_torch`` package beside it.  Phases:

1. build   — nvcc builds ``deepblast_torch/csrc/dp_kernels.cu`` (sm_90a)
             and cc builds the C traceback walk, in parallel.
2. kernels — NW scores through the kernels against a float64 loop over
             cells (rtol 1e-5 / atol 1e-4, fp32 sums); then each CUDA
             kernel against its plain PyTorch version on the card, ragged
             (B, N, M) = (16, 200, 150), nw and sw x softmax / sparsemax /
             hardmax, outputs allocated over NaN-filled memory:
             skew, unskew, adjoint forward with and without Za (vtd, Dxd,
             Dmd) and adjoint backward (Ed, EdA) exact; forward (Vt, Dx,
             Dm), score-only forward (Vt), backward (E, and E with EA) to
             rtol 1e-4 / atol 1e-5 (fp32; they read 0.0, and are held
             exactly at the edge shapes below); tracebacks identical;
             autograd of
             ``alignment_score`` (two orders) and ``expected_alignment``
             through the kernels = through the plain passes on the card
             (same tolerance) and = on the CPU (each output to 1e-4 of its
             largest magnitude, see ``check_autograd``).  Then every
             storage form (``MENUS``: bf16 and int16 inputs, bf16
             residuals, bf16 and int16 expectations, bf16 cotangents) of
             every default kernel, and the pair skew, against the plain
             passes under the same menu (``check_menu_kernels``: the
             relayouts and the adjoint passes exactly, the pair = two
             single skews, stored values as float32 to the same
             tolerance).
   worker  — from here to the end of phase 4b a second process on the
             same card (``phase_worker``; its plain passes are host-bound,
             so it runs beside the model phases, and phase 4c waits for
             it): the redesigned kernels (skew, pair skew,
             unskew of every stream form, forward, score-only forward,
             backward, adjoint forward with and without Za, adjoint
             backward on the training E and on an E that is noise at
             every slot) bit for bit (0.0) against their plain versions at
             the shapes of their design's edges (``EDGE_SHAPES``, up to S
             = 20,480, where the reverse passes refuse and the forward
             passes run), in float32 and every storage menu
             (``check_edges``; the whole matrix is
             ``tests/test_torch_cuda.py``'s); one slot further the adjoint
             forward refuses, naming its limit.  Then phase 5's Q kernels
             at (16, 200, 150) and at their split edges (below).
3. serving — ProtT5-XL (24 x 1024, d_ff 16384, 32 heads) + CNN-1024 heads,
             seeded random weights, on the card: ``align`` 4 protein pairs
             of length 100-500, ``score_pairs`` on 32 pairs padded to 512,
             ``save_model`` and the search CLI on an 8 x 4 FASTA.  Kernel
             launch counters are zeroed just before and read just after;
             every kernel of the path must have run.  The default config
             runs bf16 residuals (``dp_bf16_residuals="auto"``).  Then
             every kernel is held against its plain version again at the
             potentials this path produced, in float32 and under the
             path's menu.
4. train   — ``python -m deepblast_torch.cli.train`` in-process, ProtT5-XL
             + CNN-1024 (the ``deepblast-train`` defaults: dropout 0.5, NW,
             softmax, cross entropy, cosine schedule, clip 10, lr 5e-5) on
             synthetic TM-align TSVs: 48 pairs of length 100-500 and 8 of
             600-1000 (one batch padded past 600 slots), 16 valid
             pairs, batch 16, 1 epoch.  Counters zeroed before, read
             after: every training kernel must have run.  Losses finite,
             aligner changed (against the config's seeded init), at most
             3 checkpoints, ``load_model`` serves ``align``.  Then every
             kernel, and autograd through them, is held against its plain
             version (and, for its longest pair, the CPU) at the trained
             model's potentials of the longest training batch (8, 992,
             1024), in float32 and under
             the run's menu (bf16 residuals: the default flags resolve
             ``--dp-bf16-residuals auto`` to on, as deepblast-train does;
             checked).  The whole run's
             time, the intervals between the ``train_loss`` records of
             its own ``metrics.jsonl``, and peak device memory.  The
             model directory stays for phase 4a.
4a. evaluate — the evaluation entry points on phase 4's model directory
             (``phase_evaluate``).  (a) ``python -m
             deepblast_torch.cli.evaluate`` in process on 16 synthetic
             TM-align rows of 100-500 residues with chain names: counters
             zeroed before, read after, the pair skew, the forward, the
             backward and the unskew must have run; the CSV has 16 rows,
             the JAX header and the names in batch order, and its
             statistics equal ``test()`` run with the plain passes on the
             card at the same weights; then every kernel = plain at the
             potentials of the evaluate batch, in float32 and under the
             run's menu.  (b) ``python -m deepblast_torch.cli.mali_align``
             on 4 homolog structure pairs of 100-300 residues
             (``dssp.build_backbone`` over a ``homolog_row`` alignment's
             columns, the two chains written as PDB files): counters as in
             (a), the pair skew, the forward and the backward must have
             run; each ``deepblast`` string = the in-memory model's
             ``align(s1.seq, s0.seq)``; ``process_alignment`` TM-scores of
             the predicted and the true state strings finite, in (0, 1],
             printed; then every kernel = plain at the potentials of the
             longest pair as ``align`` gives it (a batch of 1), in
             float32 and under the decode menu.  (c) ``python -m deepblast_torch.cli.tensorboard2csv``
             on phase 4's logdir: one row per scalar record of its
             ``metrics.jsonl``.  The seconds of each ``load_model``,
             ``test()`` and ``align``; the launches of (a) and (b) are the
             kernels line's eighth path.  (``hmm_simulate`` needs HMMER's
             ``hmmemit``, which the card's machine lacks: it is held on the
             CPU only, ``tests/test_torch_eval.py``.)
4b. options — the trainer options at ProtT5-XL + CNN-1024 width: (a)
             ``cli.train --precision bf16 --grad-accum 2
             --steps-per-dispatch 4``, batch 16, 1 epoch, on 128 pairs of
             481-496 residues (every batch (16, 496, 496), so chunks of 4
             form: ``cli.train`` has no pad-multiple flag) and 16
             validation pairs: losses finite, every training kernel ran,
             the optimizer and the schedule stepped once per two steps,
             no synchronizing CUDA operation inside a chunk's steps and
             copies (``torch.cuda.set_sync_debug_mode("warn")``) and one
             loss readback a chunk; the run's time, the seconds between
             the chunks' ``train_loss`` records and peak device memory;
             the kernels of the run's storage menu and autograd = plain
             at a training batch.  (b)
             ``cli.train --finetune True --precision bf16``, batch 4, 1
             epoch, 12 pairs of 100-300 residues: the LM changed,
             ``load_model`` serves ``align`` with it (the in-memory
             model's states), peak device memory.  ``--precision 16`` is
             held on the CPU only (``tests/test_torch_options.py``).
4d. parallel — data parallel training and search over
             ``torch.distributed``, after 4b and beside the worker; the card
             is one GPU, so two ranks share it over gloo, and NCCL runs at
             world size 1.  (a) two processes of this script (``--rank``,
             ``rank_main``) join a gloo group (a ``file://`` store) on
             ``cuda:0`` and run ``cli.train`` at ProtT5-XL width cut to 2
             of 24 blocks (``PARALLEL_BLOCKS``: seeded weights in a HF
             directory, ``--pretrain-path``) + CNN-1024 on 24 synthetic
             rows of 100-300 residues, batch 8 (4 rows a rank), 1 epoch,
             dropout 0, bf16 residuals (``--dp-bf16-residuals auto``):
             ``fit(mesh="auto")`` splits each batch over both and wraps the
             heads in ``DistributedDataParallel``; this process runs the
             same command alone.  Both ranks' histories and final aligner
             weights equal each other exactly, and this process's: the
             first step's loss to ``PARALLEL_FIRST_RTOL`` of scale, the
             later losses and the weights to ``PARALLEL_RTOL``, the
             validation statistics to ``PARALLEL_STATS_RTOL``, the
             training's update to ``PARALLEL_UPDATE_RTOL`` (why:
             ``PARALLEL_*``); every training kernel launched in each rank
             (counters zeroed before, read after, reported through each
             rank's result file); rank 0 then holds the kernels and
             autograd against their plain versions at its last shard's
             potentials.  (b) ``python -m deepblast_torch.cli.train
             --coordinator 127.0.0.1:<port> --nodes 1 --process-id 0``
             (NCCL) in a subprocess: its ``train_loss`` records equal this
             process's bit for bit.  (c) ``cli.search --mesh auto`` on the
             two ranks, on phase 3's FASTA files and rank 0's model, =
             ``--mesh none`` here to rtol 1e-4 / atol 1e-5, line for line;
             ``skew_pair`` and the score-only forward launched in each
             rank.  The phase's launches (both ranks, training and search)
             are the kernels line's seventh path.
4c. bilm   — the BiLM, the RNN head and offline LM weights (``BILM_SIZES``).
             (a) ``cli.train --lm-type bilstm --layer-type rnn`` at the
             ``deepblast-train`` defaults (embedding 1024, so the BiLM's
             hidden width is 256; hidden 1024, 2 layers, dropout 0.5),
             batch 16, 1 epoch on rows of up to ~1,000 residues: losses
             finite, torch's second LSTM bias still zero; ``load_model``
             -> ``align``, ``score_pairs`` and the search CLI; the same at
             ``--steps-per-dispatch 4`` on 64 rows of one batch shape: one
             chunk and no synchronizing operation in it
             (:class:`count_waits`); and so ``--finetune True`` at batch 8
             (cuDNN's LSTM backward through the BiLM): the BiLM changed.
             (b) a Bepler-geometry BiLM (nin 22,
             hidden 1,024, 2 layers: 4,096 features) with seeded weights
             in the ``lstm2x`` layout -> ``cli.convert_lm`` ->
             ``cli.train --pretrain-path`` (the Uniprot21 tokenizer, heads
             of 4,096 + 22 inputs) -> ``align``.  (c) a seeded HF-layout
             ProtT5-XL state dict cut to 2 blocks -> ``cli.convert_lm`` in
             float32 and bf16: the float32 artifact's encoder gives the
             features of the state dict loaded directly exactly, the bf16
             one's difference reported; ``cli.train --pretrain-path`` for 2
             steps.  Counters zeroed before each run, read after.  Then
             every default kernel = plain at a training batch's potentials
             (0.0, float32 and the run's menu), the BiLM's features and the
             RNN heads' outputs on the card = on the CPU to 1e-4 of scale,
             and by CUDA events a training step against its BiLM forward
             and its RNN heads' forward + backward.
5. long    — the long-sequence backend (``pallas_long``: the Q-stream
             kernels, each pair split across a thread-block cluster).
             In the worker: each Q kernel against its plain version at
             (16, 200, 150), nw and sw x softmax / sparsemax / hardmax,
             outputs over NaN, bit for bit, with float32 and with bf16 Q
             streams (the instances of ``ops.dp.Q_DTYPE`` bf16), and
             autograd through them (as phase 2, the CPU on the 4 largest
             pairs); the four Q kernels, every instance, bit for bit at
             every forced cluster size (the bf16 ones at
             ``BF16_CLUSTERS``) at ``SPLIT_EDGE_SLOTS``.  Here: the four
             Q kernels, every instance, at the wrapper's size at their
             limit S = 32,768 (one kernel's outputs live at a time), one
             slot past which each refuses;
             a ``pallas_long``
             training step on a pair of 19,800 x 40 (past the 19,370
             slots the first Q backward and adjoint forward held) bit for
             bit against the plain passes.  Then
             ``cli.train --backend pallas_long --max-len 4096`` at
             ProtT5-XL + CNN-1024 on 6 synthetic TM-align pairs of
             1,000-3,900 residues (batch 2, 1 epoch; the longest batch
             pads past S = 3,600 slots), ``load_model`` ->
             ``align`` of the ~3,900-residue pair and ``score_pairs``, and
             one ``expected_alignment`` + gradient with ``backend="pallas"``
             (the same skew and unskew kernels).  Counters zeroed before,
             read after: every Q kernel, the skew and the unskew must have
             run.  Then, at the trained model's potentials of the longest
             batch: the default backend trains it (S <= 6,144, its reverse
             passes' strips), its expected alignment and gradient as close
             to a float64 run of the plain passes as ``pallas_long``'s
             (at most twice its distance, plus 1e-4 of scale; float32
             storage; under bf16 residuals finite, the deviation
             reported); one slot past the strips it refuses, naming the
             limit; and every Q kernel and autograd through them equal
             their plain versions (and the CPU: the first-order
             outputs to phase 2's tolerance; the second-order ones,
             which two fp32 runs at this length do not share to 1e-4,
             are reported).  Times at 8 x 4096 x
             4096 (``scripts/bench_len4096.py``'s shape): each Q kernel and
             the ``pallas_long`` expected alignment (alignments/s), and
             peak device memory; then with bf16 Q: each Q kernel, the
             decode and the DP step in turns with float32 Q, the largest E
             and gradient differences from float32 Q, peak memory, and
             the bf16 instances' launches in one DP step (counters zeroed
             just before).
6. menu    — the storage menu's own path:
             ``cli.train --dp-i16-streams --dp-decode-menu fast`` at
             ProtT5-XL + CNN-1024, 32 + 8 pairs, batch 16, 1 epoch, then
             ``load_model`` -> ``align`` x2 and ``score_pairs``: launch
             counts show theta/A through ``skew_pair`` only (the single
             skew runs for the training cotangent alone), the menus are
             (int16 / bf16 / int16) and (-, bf16, int16); every kernel
             instance of both menus, and autograd, = plain at a training
             batch (and autograd = CPU to ``MENU_CPU_RTOL`` of scale).  Then the decode under bf16 residuals and under the
             fast menu against float32 storage on the card, on the JAX
             package's own data and at its own gates (``menu_accuracy``:
             tests/test_bf16_streams.py at (4, 48, 40), E error < 5e-3 and
             every pair's traceback agreement >= 0.97;
             scripts/bench_check.py on 16 pairs of (256, 512, 512), E
             error < 1e-2 and mean agreement > 0.97; the fast stream walk
             against the natural one, mean >= 0.995).
7. bench   — decode at B=256, N=M=512, fp32, nw, softmax: each kernel's
             time (CUDA events), the plain version's time, alignments/s,
             and each kernel's bound: the larger of its bytes over 3.35
             TB/s and its operations -- MUFU and fp32 instructions per
             cell, read off the instance's SASS (``kernel_report``), over
             16 and 128 a clock per SM at 1,980 MHz on 132 SMs -- counting
             the valid cells of the run's pairs, not the stream's padding
             slots; the registers, stack and spills of every instance
             (ptxas);
             the unskew's library time is one strided ``clone``, and the
             skew's and the pair skew's yardstick (not a library time: two
             calls a stream) ``torch.zeros`` + a strided ``copy_``; then the
             training kernels at the same shape and one whole
             differentiable DP step (``expected_alignment`` + ``backward()``
             of a cross entropy); the Q kernels at the same shape.  Then
             every kernel's storage forms (time, plain time, and the bound
             from the bytes each form's streams move: 2 bytes a bf16 or
             int16 value), and in turns the decode in float32 / bf16
             residuals / the fast menu, the DP step in float32 / bf16
             residuals, and the pair skew against two single skews.
8. cli_bench — ``python -m deepblast_torch.cli.benchmark`` in process
             (``main``), ``--iters 3``: (a) every depth (``fwd``,
             ``fwd+bwd``, ``decode``, ``train``) at the bench shape, nw,
             ``--dtype-menu d-bf16``, and ``--backend pallas --depth
             decode`` at 8 x 4096 x 4096 (its expected alignment), each
             JSON record printed (each shape drawn once); counters zeroed
             before each record and read after it: every kernel of the
             depth (``CLI_BENCH_RUNS``) must have launched; (b) its decode
             (``time_op``: CUDA events around windows of back-to-back
             calls) within 10% of phase 7's d_bf16 decode (``cuda_ms``);
             (c) ``utils.profiling.trace`` (``torch.profiler``; the Chrome
             trace goes to a temporary directory) of 3 ``train``-depth
             steps and of 3 of phase 7's DP steps (with a cross entropy)
             at the bench shape under d-bf16: each step's device time, the
             card's busy share of the host clock, the shares in
             ``csrc/dp_kernels.cu``'s kernels and in everything else, and
             the 10 device operations with the most time.

The line before the last is the kernels JSON, one entry per kernel and
per bf16 Q instance (``<name>_bf16``: its launches are those of the bf16
DP step of phase 5, its times and bound at the bench shape with 2-byte Q
values; a Q kernel's entry also gives its last split on the long path);
the last line is ``{"ok": true, "device": {...}}``.
"""

import contextlib
import copy
import dataclasses
import functools
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def _load_helpers():
    """``tests/synthetic_pairs.py`` of this checkout, by its path (a
    ``tests`` package installed elsewhere cannot shadow it)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "synthetic_pairs.py")
    spec = importlib.util.spec_from_file_location("synthetic_pairs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_pairs = _load_helpers()
RESIDUES, protein, homolog_row, write_structure_pair = (
    _pairs.RESIDUES, _pairs.protein, _pairs.homolog_row,
    _pairs.write_structure_pair)

RTOL, ATOL = 1e-4, 1e-5
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
SOURCE = "deepblast_torch/csrc/dp_kernels.cu"
KERNELS = ("skew", "skew_pair", "unskew", "forward", "forward_score",
           "backward", "adjoint_forward", "adjoint_backward")
Q_KERNELS = ("forward_q", "backward_q", "adjoint_forward_q",
             "adjoint_backward_q")
OPERATORS = ("softmax", "sparsemax", "hardmax")
LONG_LEN = 4096
SERVING_KERNELS = ("skew_pair", "forward", "forward_score", "backward")
TRAIN_KERNELS = ("skew", "skew_pair", "unskew", "forward", "backward",
                 "adjoint_forward", "adjoint_backward")
# card-vs-CPU limit (of each output's largest magnitude) under a storage
# menu that rounds: the card and the CPU round float32 values that can
# differ in the last bit, and now and then one to the neighbouring bf16
# value (2^-8 apart); 4.5e-7 and 1.9e-4 of scale were read on an H100
# under bf16 residuals and int16 inputs, and a lost menu or a wrong pass
# moves an output by more than 1e-2 of scale
MENU_CPU_RTOL = 2e-3
# every TPU pallas_call site each kernel stands for
REPLACES = {
    "skew": ["deepblast_tpu/ops/skew_bm.py:195",
             "deepblast_tpu/ops/skew_pallas.py:95"],
    "skew_pair": ["deepblast_tpu/ops/skew_bm.py:243"],
    "unskew": ["deepblast_tpu/ops/skew_bm.py:321",
               "deepblast_tpu/ops/skew_pallas.py:133"],
    "forward": ["deepblast_tpu/ops/dp_bm.py:1082",
                "deepblast_tpu/ops/dp_bm.py:423",
                "deepblast_tpu/ops/dp_bm_train.py:179"],
    "forward_score": ["deepblast_tpu/ops/dp_bm.py:509"],
    "backward": ["deepblast_tpu/ops/dp_bm.py:1116",
                 "deepblast_tpu/ops/dp_bm.py:617",
                 "deepblast_tpu/ops/dp_bm_train.py:303"],
    "adjoint_forward": ["deepblast_tpu/ops/dp_bm.py:709",
                        "deepblast_tpu/ops/dp_bm_train.py:442"],
    "adjoint_backward": ["deepblast_tpu/ops/dp_bm.py:827",
                         "deepblast_tpu/ops/dp_bm_train.py:595"],
    "forward_q": ["deepblast_tpu/ops/dp_pallas.py:223"],
    "backward_q": ["deepblast_tpu/ops/dp_pallas.py:328"],
    "adjoint_forward_q": ["deepblast_tpu/ops/dp_pallas.py:423"],
    "adjoint_backward_q": ["deepblast_tpu/ops/dp_pallas.py:548"],
}
# The operations side of each bound, counted from the compiled code: an
# H100 SXM has 132 SMs at up to 1,980 MHz, each issuing 16 MUFU operations
# (ex2, lg2, rcp: the transcendentals of max3) and 128 fp32 instructions
# (add, mul, fma, min/max, compare, select) a clock -- the data sheet's 67
# TFLOP/s counts an fma as two.  The two pipes run side by side, so a
# kernel's least time for its operations is the larger of the two.
MUFU_PER_S = 16 * 132 * 1.98e9
FP32_INSTR_PER_S = FP32_FLOPS_PER_S / 2
FP32_OPS = ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "FRND",
            "FCHK")
# the instance each bench name times (softmax = operator 0, float32
# storage, strip width 2 at S = 513); the relayouts do no arithmetic
BENCH_INSTANCES = {
    "forward": "forward_kernel<0, true, float, float, 2>",
    "forward_score": "forward_kernel<0, false, float, float, 2>",
    "backward": "backward_kernel<0, false, float, float, 2>",
    "backward_gap": "backward_kernel<0, true, float, float, 2>",
    "adjoint_forward": "adjoint_forward_kernel<0, false, float, float, 2>",
    "adjoint_forward_za": "adjoint_forward_kernel<0, true, float, float, 2>",
    "adjoint_backward": "adjoint_backward_kernel<0, float, float, 2>",
    "forward_q": "forward_q_kernel<0, false, float>",
    "backward_q": "backward_q_kernel<false, false, float>",
    "backward_q_gap": "backward_q_kernel<true, false, float>",
    "adjoint_forward_q": "adjoint_forward_q_kernel<0, false, false, float>",
    "adjoint_forward_q_za": "adjoint_forward_q_kernel<0, true, false, float>",
    "adjoint_backward_q": "adjoint_backward_q_kernel<false, float>",
}
# the bf16 Q instances (Q_DTYPE bf16), each under its float32 name + _bf16
BENCH_INSTANCES.update({
    k + "_bf16": v.replace("float>", "__nv_bfloat16>")
    for k, v in list(BENCH_INSTANCES.items()) if "_q" in k})
# cells one pass of a strip kernel's unrolled row loop computes: T slots x
# the D rows of its register ring (ring_for and, for the adjoint passes,
# afwd_ring_for and abwd_ring_for in csrc/dp_kernels.cu)
RING = {2: 4, 6: 2, 20: 1}
AFWD_RING = {2: 2, 6: 1, 20: 1}
ABWD_RING = {2: 2, 6: 1}
STRIP_KERNELS = ("forward_kernel<", "backward_kernel<",
                 "adjoint_forward_kernel<", "adjoint_backward_kernel<")
# the split Q kernels, kCluster their last template argument: strips of 2
# x D cells a pass too, D their ring (with one CTA a pair, with a cluster:
# Q_FWD_RING, Q_BWD_RING, Q_AFWD_RING, q_abwd_ring)
Q_RING = {"forward_q_kernel<": (2, 2), "backward_q_kernel<": (2, 2),
          "adjoint_forward_q_kernel<": (2, 2),
          "adjoint_backward_q_kernel<": (1, 2)}
SPLIT_KERNELS = tuple(Q_RING)
# the bf16 Q instances' names (chip_smoke.q_name), as dp_cuda.LAUNCHES
# counts them
Q_BF16 = tuple(k + "_bf16" for k in Q_KERNELS)


def split_args(instance):
    """A split Q kernel instance's kCluster (its second-to-last template
    argument) and Q storage type (its last)."""
    args = instance[instance.index("<") + 1:-1].split(", ")
    return args[-2] == "true", args[-1]
# the cluster sizes the bf16 Q instances are forced to at the split's
# edges (one CTA, the smallest cluster and the largest; the float32
# instances take every size)
BF16_CLUSTERS = (1, 2, 16)
# slots S at the split Q kernels' edges: a stream of one slot, one cell,
# one warp of strips of 2 (a CTA of the smaller splits) -1 (odd), 0 and
# +1, a CTA of 1,024 threads of strips of 2 -1, 0 and +1
SPLIT_EDGE_SLOTS = (1, 2, 63, 64, 65, 2047, 2048, 2049)
# (B, N, M, short): shapes at the strip kernels' (and the skew's tiles')
# edges, lengths ragged with pair 0 full and, with `short`, the last pair
# n = max(1, N // 50) (whole diagonals of padding): N = 1 and M = 1; S not
# a multiple of the strip or the tile; n < m and n > m; S past 1,024
# slots; the 6-slot strip; S at the reverse passes' limit (1,024 x 6) and
# at the forward passes' (1,024 x 20), where the reverse passes refuse
EDGE_SHAPES = [(1, 1, 1, False), (3, 1, 37, False), (3, 37, 1, False),
               (2, 67, 300, True), (2, 300, 67, True),
               (3, 1100, 60, True), (2, 2500, 40, True),
               (1, 6143, 3, False), (1, 20479, 2, False)]


# Storage menus (deepblast_torch/ops/menu.py) whose kernel instances the
# smoke holds against the plain passes: between them every storage form
# the kernels take (inputs float32/bf16/int16, residuals float32/bf16,
# E float32/bf16 and the decode's int16, cotangents float32/bf16).
MENUS = {
    "d_bf16": dict(d="bfloat16"),                    # the training default
    "fast": dict(d="bfloat16", e="int16"),           # --dp-decode-menu fast
    "i16": dict(stream="int16", e="int16"),          # --dp-i16-streams
    "i16_d_bf16": dict(stream="int16", d="bfloat16", e="int16"),
    "bf16": dict(stream="bfloat16", d="bfloat16", e="bfloat16"),
    "bf16_in_e": dict(stream="bfloat16", e="bfloat16"),
}


#: seconds spent in each check function (:func:`timed_check`) in each
#: phase, under ``"<phase>:<check>"``, printed at the end: where the
#: smoke's time goes, for budgeting its limit
CHECK_SECONDS = {}
#: the phase that runs (``main``'s ``timed``), the first part of the keys
#: of ``CHECK_SECONDS``
PHASE = ["build"]


def add_seconds(name, t0):
    """Add the seconds since ``t0`` to ``CHECK_SECONDS`` under ``name`` in
    the current phase."""
    key = f"{PHASE[0]}:{name}"
    CHECK_SECONDS[key] = round(CHECK_SECONDS.get(key, 0.0) + time.time() - t0,
                               1)


def timed_check(fn):
    """``fn`` adding the seconds of each call, synchronized, to
    ``CHECK_SECONDS`` (:func:`add_seconds`)."""
    @functools.wraps(fn)
    def wrapped(*args, **kw):
        t0 = time.time()
        try:
            return fn(*args, **kw)
        finally:
            torch.cuda.synchronize()
            add_seconds(fn.__name__, t0)
    return wrapped


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def dp_problem(g, B, N, M, ragged=True):
    """Potentials of the shape and scale of the JAX package's DP tests:
    theta ~ N(0, 1), A ~ N(0, 1) - 1, lengths ragged with pair 0 full."""
    dev = "cuda"
    theta = torch.randn((B, N, M), generator=g, device=dev)
    A = torch.randn((B, N, M), generator=g, device=dev) - 1.0
    if ragged:
        ln = torch.randint(N // 2, N + 1, (B,), generator=g, device=dev)
        lm = torch.randint(M // 2, M + 1, (B,), generator=g, device=dev)
        ln[0], lm[0] = N, M
    else:
        ln = torch.full((B,), N, device=dev)
        lm = torch.full((B,), M, device=dev)
    return theta, A, ln.to(torch.int32), lm.to(torch.int32)


def mutate(rng, x):
    """A homolog of ``x``: ~20% substitutions and a few short indels."""
    out = []
    for c in x:
        u = rng.random()
        if u < 0.03:
            continue
        out.append(rng.choice(list(RESIDUES)) if u < 0.2 else c)
        if rng.random() < 0.03:
            out.extend(rng.choice(list(RESIDUES), rng.integers(1, 4)))
    return "".join(out)


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build():
    from deepblast_torch import native
    from deepblast_torch.ops import dp_cuda
    t0 = time.time()
    with ThreadPoolExecutor(2) as ex:
        futs = [ex.submit(dp_cuda.build), ex.submit(native.build)]
        paths = [f.result() for f in futs]
    log(f"phase build: ok in {time.time() - t0:.1f} s -> "
        f"{', '.join(os.path.relpath(p) for p in paths)}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _poison(*tensors):
    """Fill freed allocator blocks of the outputs' sizes with NaN, so a
    kernel output allocated with torch.empty starts as NaN garbage (an
    int16 output as bf16 NaN bits, 32704)."""
    junk = [torch.full_like(t, float("nan"), dtype=t.dtype
                            if t.is_floating_point() else torch.bfloat16)
            for t in tensors]
    del junk


def _close(name, got, want, errs):
    err = (got - want).abs().max().item() if got.numel() else 0.0
    errs[name] = max(errs.get(name, 0.0), err)
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{name}: max abs diff {err} beyond "
                             f"rtol {RTOL} / atol {ATOL}")


@timed_check
def check_kernels(theta, A, ln, lm, mode, operator, errs):
    """Every kernel against its plain version on the same inputs."""
    from deepblast_torch.ops import dp as dp_ops
    from deepblast_torch.ops import dp_cuda, dp_ref
    from deepblast_torch.ops.skew import skew
    kw = dict(mode=mode, operator=operator)
    th_s, A_s = skew(theta), skew(A)
    _poison(th_s, A_s)
    th_k = dp_cuda.skew(theta)
    if not torch.equal(th_k, th_s):
        raise AssertionError("skew: kernel differs from the plain relayout")
    if not torch.equal(dp_cuda.skew(A), A_s):
        raise AssertionError("skew: kernel differs from the plain relayout")
    pair = dp_cuda.skew_pair(theta, A)
    if not (torch.equal(pair[0], th_s) and torch.equal(pair[1], A_s)):
        raise AssertionError("skew_pair: kernel differs from two skews")
    errs.setdefault("skew", 0.0)
    errs.setdefault("skew_pair", 0.0)
    del pair

    vt_p, dx_p, dm_p = dp_ref.forward(th_s, A_s, ln, lm, **kw)
    _poison(dx_p, dm_p)
    vt_k, dx_k, dm_k = dp_cuda.forward(th_s, A_s, ln, lm, **kw)
    _close("forward", vt_k, vt_p, errs)
    _close("forward", dx_k, dx_p, errs)
    _close("forward", dm_k, dm_p, errs)
    _close("forward_score", dp_cuda.forward_score(th_s, A_s, ln, lm, **kw),
           dp_ref.forward_score(th_s, A_s, ln, lm, **kw), errs)

    Et = torch.ones_like(vt_p)
    E_p, _ = dp_ref.backward(dx_p, dm_p, ln, lm, Et, **kw)
    _poison(E_p)
    E_k, _ = dp_cuda.backward(dx_p, dm_p, ln, lm, Et, **kw)
    _close("backward", E_k, E_p, errs)

    E_kh, E_ph = E_k.cpu().numpy(), E_p.cpu().numpy()
    for b, (n, m) in enumerate(zip(ln.tolist(), lm.tolist())):
        if dp_ops.traceback_stream(E_kh, n, m, b) != \
                dp_ops.traceback_stream(E_ph, n, m, b):
            raise AssertionError(f"traceback of pair {b} differs")
    check_train_kernels(theta, dx_p, dm_p, E_p, ln, lm, kw, errs)


@timed_check
def check_train_kernels(theta, dx, dm, E, ln, lm, kw, errs):
    """The training kernels against their plain versions: unskew exactly,
    backward with the gap output, the adjoint forward with and without a
    Za stream and the adjoint backward bit for bit; random cotangents."""
    from deepblast_torch.ops import dp_cuda, dp_ref
    from deepblast_torch.ops.skew import skew, unskew
    B, N, M = theta.shape
    u_p = unskew(E, N, M)
    _poison(u_p)
    if not torch.equal(dp_cuda.unskew(E, N, M), u_p):
        raise AssertionError("unskew: kernel differs from the plain relayout")
    errs.setdefault("unskew", 0.0)

    Et = torch.ones((B,), device=theta.device)
    E_p, EA_p = dp_ref.backward(dx, dm, ln, lm, Et, want_gap=True, **kw)
    _poison(E_p, EA_p)
    E_k, EA_k = dp_cuda.backward(dx, dm, ln, lm, Et, want_gap=True, **kw)
    _close("backward", E_k, E_p, errs)
    _close("backward", EA_k, EA_p, errs)

    g = torch.Generator(device=theta.device)
    g.manual_seed(B * N + M)
    zt_s = skew(torch.randn(theta.shape, generator=g, device=theta.device))
    za_s = skew(torch.randn(theta.shape, generator=g, device=theta.device))
    for za in (None, za_s):
        vtd_p, dxd_p, dmd_p = dp_ref.adjoint_forward(dx, dm, zt_s, za, ln,
                                                     lm, **kw)
        _poison(dxd_p, dmd_p)
        vtd_k, dxd_k, dmd_k = dp_cuda.adjoint_forward(dx, dm, zt_s, za, ln,
                                                      lm, **kw)
        for got, want in ((vtd_k, vtd_p), (dxd_k, dxd_p), (dmd_k, dmd_p)):
            _exact("adjoint_forward", got, want, errs)

    Ed_p, EdA_p = dp_ref.adjoint_backward(dx, dm, dxd_p, dmd_p, E, ln, lm,
                                          **kw)
    _poison(Ed_p, EdA_p)
    Ed_k, EdA_k = dp_cuda.adjoint_backward(dx, dm, dxd_p, dmd_p, E, ln, lm,
                                           **kw)
    _exact("adjoint_backward", Ed_k, Ed_p, errs)
    _exact("adjoint_backward", EdA_k, EdA_p, errs)


def _wide(t):
    """A stored stream as float32 values: bf16 widened, int16 E
    dequantized (the unskew's and the traceback's reading)."""
    if t.dtype == torch.int16:
        return t.float() / 32767.0
    return t.float()


@timed_check
def check_menu_kernels(theta, A, ln, lm, mode, operator, menu, errs):
    """Every kernel instance of one storage menu against its plain version
    on the same inputs, outputs over NaN-filled memory: the skew and the
    pair skew to the menu's stream type (exactly, and the pair = two
    singles), the forward (Vt, Dx, Dm) and the score-only forward, the
    backward with the gap output (training E) and without it (the decode's
    E, int16 under an int16 ``e``), the unskew of each E (exactly), the
    adjoint forward with and without Za on cotangents of the menu's
    cotangent type and the adjoint backward (bit for bit); tracebacks of
    the decode's E identical.  Stored values compared as float32 (int16 E in
    units of 1/32767), to RTOL / ATOL."""
    from deepblast_torch.ops import dp as dp_ops
    from deepblast_torch.ops import dp_cuda, dp_ref
    from deepblast_torch.ops.skew import skew, unskew
    B, N, M = theta.shape
    kw = dict(mode=mode, operator=operator, dtypes=menu)
    sdt, scale = menu.stream_dtype, menu.stream_scale
    th_s, A_s = skew(theta, sdt, scale), skew(A, sdt, scale)
    _poison(th_s, A_s)
    th_k, A_k = dp_cuda.skew(theta, sdt, scale), dp_cuda.skew(A, sdt, scale)
    pair = dp_cuda.skew_pair(theta, A, sdt, scale)
    for got, want in ((th_k, th_s), (A_k, A_s), (pair[0], th_k),
                      (pair[1], A_k)):
        if not torch.equal(got, want):
            raise AssertionError(f"skew / skew_pair ({sdt}): kernel differs "
                                 "from the plain relayout")
    errs.setdefault("skew", 0.0)
    errs.setdefault("skew_pair", 0.0)
    del th_k, A_k, pair

    vt_p, dx_p, dm_p = dp_ref.forward(th_s, A_s, ln, lm, **kw)
    _poison(dx_p, dm_p)
    vt_k, dx_k, dm_k = dp_cuda.forward(th_s, A_s, ln, lm, **kw)
    for got, want in ((vt_k, vt_p), (dx_k, dx_p), (dm_k, dm_p)):
        if got.dtype != want.dtype:
            raise AssertionError(f"forward stores {got.dtype}, the plain "
                                 f"version {want.dtype}")
        _close("forward", _wide(got), _wide(want), errs)
    del dx_k, dm_k
    _close("forward_score", dp_cuda.forward_score(th_s, A_s, ln, lm, **kw),
           dp_ref.forward_score(th_s, A_s, ln, lm, **kw), errs)

    Et = torch.ones_like(vt_p)
    for decode in (False, True):
        E_p, EA_p = dp_ref.backward(dx_p, dm_p, ln, lm, Et,
                                    want_gap=not decode, decode=decode, **kw)
        _poison(E_p, *([] if decode else [EA_p]))
        E_k, EA_k = dp_cuda.backward(dx_p, dm_p, ln, lm, Et,
                                     want_gap=not decode, decode=decode,
                                     **kw)
        if E_k.dtype != E_p.dtype:
            raise AssertionError(f"backward stores {E_k.dtype}, the plain "
                                 f"version {E_p.dtype}")
        _close("backward", _wide(E_k), _wide(E_p), errs)
        if not decode:
            _close("backward", _wide(EA_k), _wide(EA_p), errs)
            E_train = E_p
        u_p = unskew(E_p, N, M)
        _poison(u_p)
        if not torch.equal(dp_cuda.unskew(E_p, N, M), u_p):
            raise AssertionError(f"unskew of a {E_p.dtype} stream differs "
                                 "from the plain relayout")
        errs.setdefault("unskew", 0.0)
    E_kh, E_ph = E_k.cpu(), E_p.cpu()
    del E_k, EA_k, EA_p
    for b, (n, m) in enumerate(zip(ln.tolist(), lm.tolist())):
        if dp_ops.traceback_stream(E_kh, n, m, b) != \
                dp_ops.traceback_stream(E_ph, n, m, b):
            raise AssertionError(f"traceback of pair {b} differs")

    g = torch.Generator(device=theta.device)
    g.manual_seed(B * N + M)
    cdt = menu.cotangent_dtype
    zt_s = skew(torch.randn(theta.shape, generator=g, device=theta.device),
                cdt)
    za_s = skew(torch.randn(theta.shape, generator=g, device=theta.device),
                cdt)
    for za in (None, za_s):
        vtd_p, dxd_p, dmd_p = dp_ref.adjoint_forward(dx_p, dm_p, zt_s, za, ln,
                                                     lm, **kw)
        _poison(dxd_p, dmd_p)
        out_k = dp_cuda.adjoint_forward(dx_p, dm_p, zt_s, za, ln, lm, **kw)
        for got, want in zip(out_k, (vtd_p, dxd_p, dmd_p)):
            _exact("adjoint_forward", got, want, errs)
        del out_k
    Ed_p, EdA_p = dp_ref.adjoint_backward(dx_p, dm_p, dxd_p, dmd_p, E_train,
                                          ln, lm, **kw)
    _poison(Ed_p, EdA_p)
    Ed_k, EdA_k = dp_cuda.adjoint_backward(dx_p, dm_p, dxd_p, dmd_p, E_train,
                                           ln, lm, **kw)
    _exact("adjoint_backward", Ed_k, Ed_p, errs)
    _exact("adjoint_backward", EdA_k, EdA_p, errs)


def _exact(name, got, want, errs):
    if got.dtype != want.dtype:
        raise AssertionError(f"{name} stores {got.dtype}, the plain version "
                             f"{want.dtype}")
    err = (_wide(got) - _wide(want)).abs().max().item() if got.numel() \
        else 0.0
    errs[name] = max(errs.get(name, 0.0), err)
    if not torch.isfinite(_wide(got)).all():
        raise AssertionError(f"{name}: non-finite output")
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: max abs diff {err}, not bit-identical "
                             "to the plain version")


def _refuses(name, call):
    """``call`` must raise the ``ValueError`` that names the limit of
    ``name`` (``dp_cuda.MAX_SLOTS``, or ``dp_cuda.CLUSTER_SLOTS`` and then
    also the ``pallas_long`` step's and the ROADMAP item) before
    launching."""
    from deepblast_torch.ops import dp_cuda
    before = dict(dp_cuda.LAUNCHES)
    split = name in dp_cuda.CLUSTER_SLOTS
    most = (dp_cuda.CLUSTER_SLOTS if split else dp_cuda.MAX_SLOTS)[name]
    try:
        call()
    except ValueError as e:
        step = f"pallas_long training step, which runs all four Q kernels, " \
            f"holds S <= {most} slots"
        if f"S <= {most} " not in str(e) or dp_cuda.LAUNCHES != before or \
                split and (step not in str(e) or
                           "ROADMAP.md queue A item 4" not in str(e)):
            raise AssertionError(f"unclear refusal of {name}: {e}")
        return str(e)
    raise AssertionError(f"{name} took a pair past its limit")


@timed_check
def check_passes(theta, A, ln, lm, mode, operator, menu, errs):
    """The redesigned kernels under one storage menu (None: float32)
    against their plain versions bit for bit, outputs over NaN-filled
    memory: the skew and the pair skew to the menu's stream type; the
    unskew of the menu's input stream, its residual Dx and each of its E
    forms; the strip kernels -- the forward (Vt, Dx, Dm), the score-only
    forward, the adjoint forward (vtd, Dxd, Dmd) with and without Za on
    cotangents of the menu's type, the backward (training E with EA, E
    alone, the decode's E), the adjoint backward (Ed, EdA) on the training
    E and on an E that is noise at every slot; tracebacks of the decode's E
    identical.  Past the reverse passes' strips (S > ``MAX_SLOTS``) the
    backward and the adjoint backward must refuse, naming their limit."""
    from deepblast_torch.ops import dp as dp_ops
    from deepblast_torch.ops import dp_cuda, dp_ref
    from deepblast_torch.ops.menu import as_menu
    from deepblast_torch.ops.skew import skew, unskew

    def check_unskew(s):
        want = unskew(s, N, M)
        _poison(want)
        _exact("unskew", dp_cuda.unskew(s, N, M), want, errs)

    N, M = theta.shape[1:]
    kw = dict(mode=mode, operator=operator, dtypes=menu)
    m = as_menu(menu)
    th_s = skew(theta, m.stream_dtype, m.stream_scale)
    A_s = skew(A, m.stream_dtype, m.stream_scale)
    _poison(th_s, A_s)
    _exact("skew", dp_cuda.skew(theta, m.stream_dtype, m.stream_scale), th_s,
           errs)
    for got, want in zip(dp_cuda.skew_pair(theta, A, m.stream_dtype,
                                           m.stream_scale), (th_s, A_s)):
        _exact("skew_pair", got, want, errs)
    vt_p, dx_p, dm_p = dp_ref.forward(th_s, A_s, ln, lm, **kw)
    _poison(dx_p, dm_p)
    for got, want in zip(dp_cuda.forward(th_s, A_s, ln, lm, **kw),
                         (vt_p, dx_p, dm_p)):
        _exact("forward", got, want, errs)
    _exact("forward_score", dp_cuda.forward_score(th_s, A_s, ln, lm, **kw),
           dp_ref.forward_score(th_s, A_s, ln, lm, **kw), errs)
    check_unskew(th_s)
    check_unskew(dx_p)
    S = th_s.shape[2]
    g = torch.Generator(device=theta.device)
    g.manual_seed(S + theta.shape[2])
    zt_s = skew(torch.randn(theta.shape, generator=g, device=theta.device),
                m.cotangent_dtype)
    noise = torch.randn(dx_p.shape, generator=g, device=theta.device)
    za_s = skew(torch.randn(theta.shape, generator=g, device=theta.device),
                m.cotangent_dtype)
    for za in (za_s, None):
        vtd_p, dxd_p, dmd_p = dp_ref.adjoint_forward(dx_p, dm_p, zt_s, za, ln,
                                                     lm, **kw)
        _poison(dxd_p, dmd_p)
        for got, want in zip(dp_cuda.adjoint_forward(dx_p, dm_p, zt_s, za, ln,
                                                     lm, **kw),
                             (vtd_p, dxd_p, dmd_p)):
            _exact("adjoint_forward", got, want, errs)
    del za_s
    Et = torch.ones_like(vt_p)
    if S > dp_cuda.MAX_SLOTS["backward"]:
        _refuses("backward", lambda: dp_cuda.backward(dx_p, dm_p, ln, lm, Et,
                                                      **kw))
        E = torch.zeros(dx_p.shape, dtype=dp_cuda._train_e_dtype(m),
                        device=dx_p.device)
        _refuses("adjoint_backward", lambda: dp_cuda.adjoint_backward(
            dx_p, dm_p, dx_p, dm_p, E, ln, lm, **kw))
        return
    for gap, decode in ((True, False), (False, False), (False, True)):
        # E alone is the E of the gap run (the plain version's one code)
        E_p, EA_p = (E_train, None) if (gap, decode) == (False, False) \
            else dp_ref.backward(dx_p, dm_p, ln, lm, Et, want_gap=gap,
                                 decode=decode, **kw)
        _poison(E_p, *([EA_p] if gap else []))
        E_k, EA_k = dp_cuda.backward(dx_p, dm_p, ln, lm, Et, want_gap=gap,
                                     decode=decode, **kw)
        _exact("backward", E_k, E_p, errs)
        if gap:
            _exact("backward", EA_k, EA_p, errs)
            E_train = E_p
        if gap or decode:
            check_unskew(E_p)
    E_kh, E_ph = E_k.cpu(), E_p.cpu()
    del E_k, EA_k, E_p, EA_p
    for b, (n, mm) in enumerate(zip(ln.tolist(), lm.tolist())):
        if dp_ops.traceback_stream(E_kh, n, mm, b) != \
                dp_ops.traceback_stream(E_ph, n, mm, b):
            raise AssertionError(f"traceback of pair {b} differs")

    for E in (E_train, noise.to(E_train.dtype)):
        Ed_p, EdA_p = dp_ref.adjoint_backward(dx_p, dm_p, dxd_p, dmd_p, E, ln,
                                              lm, **kw)
        _poison(Ed_p, EdA_p)
        for got, want in zip(dp_cuda.adjoint_backward(
                dx_p, dm_p, dxd_p, dmd_p, E, ln, lm, **kw), (Ed_p, EdA_p)):
            _exact("adjoint_backward", got, want, errs)


def edge_problem(g, B, N, M, short):
    """``dp_problem`` with lengths from 1 up, pair 0 full and, with
    ``short``, the last pair ``n = max(1, N // 50)``."""
    theta, A, _, _ = dp_problem(g, B, N, M, ragged=False)
    ln = torch.randint(1, N + 1, (B,), generator=g, device=theta.device)
    lm = torch.randint(1, M + 1, (B,), generator=g, device=theta.device)
    ln[0], lm[0] = N, M
    if short:
        ln[-1] = max(1, N // 50)
    return theta, A, ln.to(torch.int32), lm.to(torch.int32)


@timed_check
def check_edges(g, errs):
    """``check_passes`` at every ``EDGE_SHAPES`` shape, in float32 for nw
    softmax and, below the limit shapes (whose plain passes walk 6,145
    and 20,480 diagonals), sw sparsemax; the storage menus, one (mode,
    operator) each in turn, at the shapes of at most 301 slots (the plain
    passes, a few hundred small launches a diagonal, set the smoke's
    time).  ``tests/test_torch_cuda.py`` runs the whole matrix."""
    from deepblast_torch.ops.menu import DTypeMenu
    pairs = [("nw", "softmax"), ("sw", "sparsemax"), ("nw", "hardmax")]
    for B, N, M, short in EDGE_SHAPES:
        theta, A, ln, lm = edge_problem(g, B, N, M, short)
        combos = [(*pairs[0], None)]
        if N + 1 < 1024 * 6:
            combos.append((*pairs[1], None))
        if N + 1 <= 301:
            combos += [(*pairs[i % 3], DTypeMenu.make(**kw))
                       for i, kw in enumerate(MENUS.values())]
        for mode, op, menu in combos:
            check_passes(theta, A, ln, lm, mode, op, menu, errs)
        del theta, A
    torch.cuda.empty_cache()
    from deepblast_torch.ops import dp_cuda
    S = dp_cuda.MAX_SLOTS["adjoint_forward"] + 1
    s = torch.zeros((1, 2, S), device="cuda")
    n = torch.tensor([S - 1], dtype=torch.int32, device="cuda")
    m = torch.tensor([2], dtype=torch.int32, device="cuda")
    _refuses("adjoint_forward",
             lambda: dp_cuda.adjoint_forward(s, s, s, s, n, m))


def q_name(name, q_dtype):
    """The name of a Q kernel's instance for Q streams of ``q_dtype``
    (None: float32), as ``dp_cuda.LAUNCHES`` counts it."""
    from deepblast_torch.ops import dp_cuda
    return name + dp_cuda.Q_DTYPES[q_dtype or torch.float32]


def q_splits(q_dtype):
    """The last split (``dp_cuda.SPLITS``) of each split Q kernel's
    instance for Q streams of ``q_dtype`` that has launched."""
    from deepblast_torch.ops import dp_cuda
    names = (q_name(k, q_dtype) for k in dp_cuda.CLUSTER_SLOTS)
    return {k: dict(dp_cuda.SPLITS[k]) for k in names if dp_cuda.SPLITS[k]}


@timed_check
def check_q_kernels(theta, A, ln, lm, mode, operator, errs, q_dtype=None):
    """Every Q-stream kernel against its plain version on the same inputs
    (outputs over NaN-filled memory), bit for bit, at the cluster size the
    wrapper picks: the forward (Vt, Qx, Qm, Qy), the backward with and
    without the gap output (E, EA), the adjoint forward with and without
    a Za stream (vtd, Qd) and the adjoint backward (Ed, EdA, on the
    backward's E and on an E that is noise at every slot); random
    cotangents; tracebacks of E identical.  ``q_dtype``: the Q streams'
    storage (None: float32; bf16: the instances of ``Q_DTYPE`` bf16,
    recorded in ``errs`` under ``<name>_bf16``)."""
    from deepblast_torch.ops import dp as dp_ops
    from deepblast_torch.ops import dp_cuda, dp_ref
    from deepblast_torch.ops.skew import skew
    kw = dict(mode=mode, operator=operator)
    name = lambda k: q_name(k, q_dtype)
    th_s, A_s = skew(theta), skew(A)
    vt_p, *qs = dp_ref.forward_q(th_s, A_s, ln, lm, q_dtype=q_dtype, **kw)
    _poison(*qs)
    vt_k, *qs_k = dp_cuda.forward_q(th_s, A_s, ln, lm, q_dtype=q_dtype,
                                    **kw)
    for got, want in zip((vt_k, *qs_k), (vt_p, *qs)):
        _exact(name("forward_q"), got, want, errs)
    del qs_k

    Et = torch.ones_like(vt_p)
    for gap in (False, True):
        E_p, EA_p = dp_ref.backward_q(*qs, ln, lm, Et, mode=mode,
                                      want_gap=gap)
        _poison(E_p, *([EA_p] if gap else []))
        E_k, EA_k = dp_cuda.backward_q(*qs, ln, lm, Et, mode=mode,
                                       want_gap=gap)
        _exact(name("backward_q"), E_k, E_p, errs)
        if gap:
            _exact(name("backward_q"), EA_k, EA_p, errs)
    E_kh, E_ph = E_k.cpu().numpy(), E_p.cpu().numpy()
    del E_k, EA_k, EA_p
    for b, (n, m) in enumerate(zip(ln.tolist(), lm.tolist())):
        if dp_ops.traceback_stream(E_kh, n, m, b) != \
                dp_ops.traceback_stream(E_ph, n, m, b):
            raise AssertionError(f"Q traceback of pair {b} differs")

    g = torch.Generator(device=theta.device)
    g.manual_seed(theta.shape[1] + theta.shape[2])
    zt_s = skew(torch.randn(theta.shape, generator=g, device=theta.device))
    za_s = skew(torch.randn(theta.shape, generator=g, device=theta.device))
    for za in (za_s, None):
        vtd_p, *qds = dp_ref.adjoint_forward_q(*qs, zt_s, za, ln, lm, **kw)
        _poison(*qds)
        vtd_k, *qds_k = dp_cuda.adjoint_forward_q(*qs, zt_s, za, ln, lm,
                                                  **kw)
        for got, want in zip((vtd_k, *qds_k), (vtd_p, *qds)):
            _exact(name("adjoint_forward_q"), got, want, errs)
        del qds_k
    del zt_s, za_s

    noise = torch.randn(E_p.shape, generator=g, device=theta.device)
    for E in (E_p, noise):
        Ed_p, EdA_p = dp_ref.adjoint_backward_q(*qs, *qds, E, ln, lm,
                                                mode=mode)
        _poison(Ed_p, EdA_p)
        Ed_k, EdA_k = dp_cuda.adjoint_backward_q(*qs, *qds, E, ln, lm,
                                                 mode=mode)
        _exact(name("adjoint_backward_q"), Ed_k, Ed_p, errs)
        _exact(name("adjoint_backward_q"), EdA_k, EdA_p, errs)


class forced_cluster:
    """Within the block the split Q kernels launch with clusters of C CTAs
    (``dp_cuda._cluster_size`` patched; the wrapper's checks that C CTAs
    hold the pair and that the device launches them still apply)."""

    def __init__(self, C):
        self.C = C

    def __enter__(self):
        from deepblast_torch.ops import dp_cuda
        self.rule = dp_cuda._cluster_size
        dp_cuda._cluster_size = lambda *args: self.C

    def __exit__(self, *exc):
        from deepblast_torch.ops import dp_cuda
        dp_cuda._cluster_size = self.rule


def split_problem(g, S, mode, operator, q_dtype=None):
    """The split kernels' inputs and their plain outputs at S slots: three
    pairs of (S - 1) x 3 (S = 1: streams of one slot, pairs of length 0),
    lengths ragged with pair 0 full and the last pair of
    ``max(1, (S - 1) // 50)`` rows; the backward with and without the gap
    output from a random Et, the adjoint forward with and without Za, the
    adjoint backward on the backward's E and on noise; the Q streams in
    ``q_dtype`` (None: float32)."""
    from deepblast_torch.ops import dp_ref
    from deepblast_torch.ops.skew import skew
    B, N, M = 3, S - 1, 3
    if N:
        theta, A, ln, lm = edge_problem(g, B, N, M, True)
        th_s, A_s = skew(theta), skew(A)
    else:
        th_s = torch.randn((B, M, 1), generator=g, device="cuda")
        A_s = torch.randn((B, M, 1), generator=g, device="cuda") - 1.0
        ln = torch.zeros((B,), dtype=torch.int32, device="cuda")
        lm = torch.full((B,), M, dtype=torch.int32, device="cuda")
    kw = dict(mode=mode, operator=operator)
    fwd = dp_ref.forward_q(th_s, A_s, ln, lm, q_dtype=q_dtype, **kw)
    qs = fwd[1:]
    Et = torch.randn((B,), generator=g, device="cuda")
    bwd = [(gap, dp_ref.backward_q(*qs, ln, lm, Et, mode=mode,
                                   want_gap=gap)) for gap in (False, True)]
    zt, za, noise = (torch.randn(th_s.shape, generator=g, device="cuda")
                     for _ in range(3))
    afwd = [(z, dp_ref.adjoint_forward_q(*qs, zt, z, ln, lm, **kw))
            for z in (None, za)]
    qds = afwd[0][1][1:]
    abwd = [(e, dp_ref.adjoint_backward_q(*qs, *qds, e, ln, lm, mode=mode))
            for e in (bwd[0][1][0], noise)]
    return dict(th_s=th_s, A_s=A_s, ln=ln, lm=lm, Et=Et, zt=zt, fwd=fwd,
                bwd=bwd, afwd=afwd, qds=qds, abwd=abwd, q_dtype=q_dtype)


def _check_launch(name, launch, want, errs):
    """One launch over NaN-filled memory against the plain outputs
    ``want``, bit for bit (a None output is not compared)."""
    _poison(*(w for w in want if w is not None))
    got = launch()
    for a, b in zip(got, want):
        if b is not None:
            _exact(name, a, b, errs)


def check_split(prob, mode, operator, C, errs):
    """The four split kernels with clusters of C CTAs (None: the wrapper's
    rule) against the plain outputs of ``prob`` (:func:`split_problem`) bit
    for bit, every instance (the backward with and without EA, the
    adjoint forward with and without Za), outputs over NaN-filled memory,
    the instances of ``prob``'s Q storage; returns the launches' splits
    (``dp_cuda.SPLITS``)."""
    from contextlib import nullcontext
    from deepblast_torch.ops import dp_cuda
    p = prob
    ln, lm, qs = p["ln"], p["lm"], p["fwd"][1:]
    kw = dict(mode=mode, operator=operator)
    name = lambda k: q_name(k, p["q_dtype"])
    with forced_cluster(C) if C else nullcontext():
        _check_launch(name("forward_q"), lambda: dp_cuda.forward_q(
            p["th_s"], p["A_s"], ln, lm, q_dtype=p["q_dtype"], **kw),
            p["fwd"], errs)
        for gap, want in p["bwd"]:
            _check_launch(name("backward_q"), lambda: dp_cuda.backward_q(
                *qs, ln, lm, p["Et"], mode=mode, want_gap=gap), want, errs)
        for za, want in p["afwd"]:
            _check_launch(
                name("adjoint_forward_q"), lambda: dp_cuda.adjoint_forward_q(
                    *qs, p["zt"], za, ln, lm, **kw), want, errs)
        for e, want in p["abwd"]:
            _check_launch(
                name("adjoint_backward_q"),
                lambda: dp_cuda.adjoint_backward_q(
                    *qs, *p["qds"], e, ln, lm, mode=mode), want, errs)
    return q_splits(p["q_dtype"])


@timed_check
def check_split_edges(g, errs, q_dtype=None, sizes=None):
    """The split kernels at every cluster size of ``dp_cuda.Q_CLUSTERS``
    (or of ``sizes``), each forced, at ``SPLIT_EDGE_SLOTS`` (nw softmax, sw
    sparsemax, nw hardmax in turn), Q streams of ``q_dtype``."""
    from deepblast_torch.ops import dp_cuda
    pairs = [("nw", "softmax"), ("sw", "sparsemax"), ("nw", "hardmax")]
    for i, S in enumerate(SPLIT_EDGE_SLOTS):
        mode, op = pairs[i % 3]
        prob = split_problem(g, S, mode, op, q_dtype)
        for C in sizes or dp_cuda.Q_CLUSTERS:
            if C * 1024 * dp_cuda.Q_STRIP >= S:
                check_split(prob, mode, op, C, errs)
        del prob


@timed_check
def check_split_limit(g, errs, q_dtype=None):
    """The four split kernels at the wrapper's own choice at their limit (S
    = ``dp_cuda.CLUSTER_SLOTS``: one pair of 32,767 x 1, nw softmax; the
    backward with and without EA, the adjoint forward without Za, the
    adjoint backward on the backward's E) bit for bit, Q streams of
    ``q_dtype``, one kernel's outputs live at a time (a float32 stream is
    4.3 GB); one slot past it each refuses, naming its limit and the
    ``pallas_long`` step's.  Returns the splits at the limit and the
    refusals."""
    from deepblast_torch.ops import dp_cuda, dp_ref
    from deepblast_torch.ops.skew import skew
    name = lambda k: q_name(k, q_dtype)
    most = dp_cuda.CLUSTER_SLOTS["forward_q"]
    x = torch.randn((1, most - 1, 1), generator=g, device="cuda")
    th_s, A_s = skew(x), skew(x - 1.0)
    del x
    n = torch.tensor([most - 1], dtype=torch.int32, device="cuda")
    m = torch.tensor([1], dtype=torch.int32, device="cuda")
    Et = torch.ones((1,), device="cuda")
    fwd = dp_ref.forward_q(th_s, A_s, n, m, q_dtype=q_dtype)
    _check_launch(name("forward_q"), lambda: dp_cuda.forward_q(
        th_s, A_s, n, m, q_dtype=q_dtype), fwd, errs)
    qs = fwd[1:]
    del th_s, A_s, fwd
    want = dp_ref.backward_q(*qs, n, m, Et, want_gap=True)
    for gap in (True, False):   # E alone is the E of the gap run
        _check_launch(name("backward_q"), lambda: dp_cuda.backward_q(
            *qs, n, m, Et, want_gap=gap), want if gap else (want[0], None),
            errs)
    E = want[0]
    zt = torch.randn(E.shape, generator=g, device="cuda")
    want = dp_ref.adjoint_forward_q(*qs, zt, None, n, m)
    _check_launch(name("adjoint_forward_q"),
                  lambda: dp_cuda.adjoint_forward_q(*qs, zt, None, n, m),
                  want, errs)
    qds = want[1:]
    del zt, want
    want = dp_ref.adjoint_backward_q(*qs, *qds, E, n, m)
    _check_launch(name("adjoint_backward_q"),
                  lambda: dp_cuda.adjoint_backward_q(*qs, *qds, E, n, m),
                  want, errs)
    split = q_splits(q_dtype)
    del qs, qds, E, want
    torch.cuda.empty_cache()
    s = torch.zeros((1, 2, most + 1), device="cuda")
    n = torch.tensor([most], dtype=torch.int32, device="cuda")
    calls = {
        "forward_q": lambda: dp_cuda.forward_q(s, s, n, m),
        "backward_q": lambda: dp_cuda.backward_q(s, s, s, n, m, Et),
        "adjoint_forward_q": lambda: dp_cuda.adjoint_forward_q(
            s, s, s, s, None, n, m),
        "adjoint_backward_q": lambda: dp_cuda.adjoint_backward_q(
            s, s, s, s, s, s, s, n, m)}
    msgs = [_refuses(k, call) for k, call in calls.items()]
    return split, msgs


# autograd outputs of check_autograd that only the forward and backward
# passes compute: vt, the gradient of vt (theta, A) and E, EA
FIRST_ORDER = (0, 1, 2, 5, 6)


@timed_check
def check_autograd(theta, A, ln, lm, mode, operator, errs, backend=None,
                   cpu_second_order=True, dtypes=None, cpu_pairs=None):
    """``torch.autograd.grad`` through the dispatcher on the card (the
    kernels of ``backend``) against the same calls with the plain passes,
    on the card and on CPU copies: ``alignment_score`` to first and second
    order, ``expected_alignment`` with and without the gap output.

    Against the plain passes on the card: rtol 1e-4 / atol 1e-5 per
    element, as every kernel.  Against the CPU, where exp and log round
    differently, each output to atol 1e-5 + rtol 1e-4 of its largest
    magnitude: the DP differences V[r-1] - V[r-2] cancel, so a last-bit
    change of V moves a small output by more than its own rtol.

    With ``cpu_second_order=False`` the outputs of the adjoint passes are
    held to the plain passes on the card only, and their CPU deviation
    (relative to scale) is recorded as ``autograd_cpu_second_order``: over
    thousands of dependent diagonals two correct fp32 runs part by more
    than 1e-4 of scale (fp32 against fp64 on the CPU, both backends:
    ~3e-4 of scale at length 1,000, scripts/torch_dp_fp32_error.py).

    Under a storage menu (``dtypes``) that rounds the residuals or the
    inputs, the card and the CPU round float32 values that differ in the
    last bit, and now and then one of them to the neighbouring bf16 value
    (2^-8 apart): the CPU deviation is then recorded as
    ``autograd_cpu_menu`` and held to ``MENU_CPU_RTOL`` of scale; the card
    = the plain passes on the card is held as without a menu.

    With ``cpu_pairs`` the CPU runs only that many of the longest pairs
    (by ``n * m``), held to the card's outputs of the same pairs (a pair's
    outputs depend on its own inputs only): the CPU's cost grows with the
    batch, the card's plain passes' with the diagonals."""
    from deepblast_torch.ops import dp as dp_ops
    from deepblast_torch.ops import dp_ref
    kw = dict(mode=mode, operator=operator, backend=backend, dtypes=dtypes)
    g = torch.Generator(device=theta.device)
    g.manual_seed(1)
    Zt = torch.randn(theta.shape, generator=g, device=theta.device)
    Za = torch.randn(theta.shape, generator=g, device=theta.device)

    pick = slice(None) if cpu_pairs is None else torch.argsort(
        (ln.long() * lm.long()).cpu(), descending=True)[:cpu_pairs]

    def grads(dev, rows=slice(None)):
        t = theta.detach()[rows].to(dev).requires_grad_()
        a = A.detach()[rows].to(dev).requires_grad_()
        lens = (ln[rows].to(dev), lm[rows].to(dev))
        zt, za = Zt[rows].to(dev), Za[rows].to(dev)
        vt = dp_ops.alignment_score(t, a, lens, **kw)
        g1 = torch.autograd.grad(vt.sum(), (t, a), create_graph=True)
        g2 = torch.autograd.grad((g1[0] * g1[0]).sum(), (t, a))
        E = dp_ops.expected_alignment(t, a, lens, **kw)
        g3 = torch.autograd.grad((E * zt).sum(), (t, a))
        E, EA = dp_ops.expected_alignment(t, a, lens, return_gap=True, **kw)
        g4 = torch.autograd.grad((E * zt).sum() + (EA * za).sum(), (t, a))
        return [x.detach() for x in (vt, *g1, *g2, E, EA, *g3, *g4)]

    kern = grads(theta.device)
    passes = dp_ops._passes
    dp_ops._passes = lambda t: dp_ref
    try:
        plain = grads(theta.device)
    finally:
        dp_ops._passes = passes
    t0 = time.time()
    cpu = grads("cpu", pick)
    add_seconds("check_autograd(cpu side)", t0)
    for i, (k, p, c) in enumerate(zip(kern, plain, cpu)):
        _close("autograd", k, p, errs)
        err = (k.cpu()[pick] - c).abs().max().item()
        scale = c.abs().max().item()
        if dtypes is not None:
            key, rtol = "autograd_cpu_menu", MENU_CPU_RTOL
        elif cpu_second_order or i in FIRST_ORDER:
            key, rtol = "autograd_cpu", RTOL
        else:
            key, rtol = "autograd_cpu_second_order", None
        errs[key] = max(errs.get(key, 0.0), err / max(scale, 1.0))
        if not torch.isfinite(k).all() or \
                (rtol is not None and err > ATOL + rtol * scale):
            raise AssertionError(f"autograd output {i}: card vs CPU max abs "
                                 f"diff {err} at scale {scale}")


def loop_score(theta, A, n, m, operator):
    """Terminal NW score by a plain loop over the cells of one pair, in
    float64 numpy — an oracle independent of the stream layout:
    ``V[i, j] = theta[i-1, j-1] + smax(A[i-1, j-1] + V[i-1, j], V[i-1, j-1],
    A[i-1, j-1] + V[i, j-1])`` with ``V = 0`` on the border."""
    V = np.zeros((n + 1, m + 1))
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            a = A[i - 1, j - 1]
            args = np.array([a + V[i - 1, j], V[i - 1, j - 1],
                             a + V[i, j - 1]])
            mx = args.max()
            smax = mx if operator == "hardmax" else \
                mx + np.log(np.exp(args - mx).sum())
            V[i, j] = theta[i - 1, j - 1] + smax
    return V[n, m]


def phase_kernels(seed):
    from deepblast_torch.ops import dp as dp_ops
    from deepblast_torch.ops.menu import DTypeMenu
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    errs = {}
    theta, A, ln, lm = dp_problem(g, 4, 9, 7)
    th, a = theta.double().cpu().numpy(), A.double().cpu().numpy()
    for op in ("softmax", "hardmax"):
        vt = dp_ops.alignment_score(theta, A, (ln, lm), operator=op).cpu()
        want = torch.tensor([loop_score(th[b], a[b], n, m, op) for b, (n, m)
                             in enumerate(zip(ln.tolist(), lm.tolist()))])
        if not torch.allclose(vt.double(), want, rtol=1e-5, atol=1e-4):
            raise AssertionError(f"{op} scores {vt} differ from the cell "
                                 f"loop's {want}")
    for mode in ("nw", "sw"):
        for op in OPERATORS:
            theta, A, ln, lm = dp_problem(g, 16, 200, 150)
            check_kernels(theta, A, ln, lm, mode, op, errs)
            check_autograd(theta, A, ln, lm, mode, op, errs)
            for kw in MENUS.values():
                check_menu_kernels(theta, A, ln, lm, mode, op,
                                   DTypeMenu.make(**kw), errs)
    torch.cuda.synchronize()
    log("phase kernels: nw scores = float64 cell loop at (4, 9, 7); kernels "
        "= plain at (16, 200, 150) nw/sw x softmax/sparsemax/hardmax, in "
        f"float32 and under the storage menus {sorted(MENUS)}, tracebacks "
        "identical; autograd on the card = on the CPU; max abs diff "
        f"{json.dumps(errs)}")
    return errs


# ---------------------------------------------------------------------------
# phase 3: the serving path at ProtT5-XL width
# ---------------------------------------------------------------------------

def _write_fasta(path, seqs, prefix):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">{prefix}{i}\n{s}\n")


def serving_data(seed):
    """Phase 3's draws: 4 pairs to align, 32 pairs to score, and the
    search's 8 queries and 4 database proteins."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(4):
        x = protein(rng, 100, 500)
        pairs.append((x, mutate(rng, x)[:500]))
    xs = [protein(rng, 100, 512) for _ in range(32)]
    ys = [mutate(rng, x)[:512] for x in xs]
    queries = [protein(rng, 50, 300) for _ in range(8)]
    db = [mutate(rng, q) for q in queries[:4]]
    return pairs, xs, ys, queries, db


def phase_serving(seed, card):
    from deepblast_torch.cli import search
    from deepblast_torch.data.state_utils import pad_sequences
    from deepblast_torch.ops import dp_cuda
    from deepblast_torch.train.checkpoint import save_model
    from deepblast_torch.train.trainer import DeepBLAST, DeepBLASTConfig

    cfg = DeepBLASTConfig(lm_type="prot_t5", embedding_dim=1024,
                          hidden_dim=1024, layers=2, k_size=5,
                          layer_type="cnn", alignment_mode="needleman-wunsch",
                          operator="softmax", seed=seed)
    t0 = time.time()
    model = DeepBLAST(cfg)
    model.init()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.lm.parameters()) + \
        sum(p.numel() for p in model.aligner.parameters())
    log(f"phase serving: ProtT5-XL + CNN-1024, {n_params} parameters, "
        f"built in {time.time() - t0:.1f} s")

    pairs, xs, ys, queries, db = serving_data(seed)
    tok = model.tokenizer
    xt, xl = pad_sequences([tok(s)[0] for s in xs])
    yt, yl = pad_sequences([tok(s)[0] for s in ys])
    xt = np.pad(xt, ((0, 0), (0, 512 - xt.shape[1])))
    yt = np.pad(yt, ((0, 0), (0, 512 - yt.shape[1])))
    batch = dict(x=xt, y=yt, x_len=xl, y_len=yl)

    with tempfile.TemporaryDirectory() as tmp:
        qf, dbf = os.path.join(tmp, "q.fa"), os.path.join(tmp, "db.fa")
        _write_fasta(qf, queries, "q")
        _write_fasta(dbf, db, "d")
        ckpt, hits = os.path.join(tmp, "model"), os.path.join(tmp, "hits")

        dp_cuda.reset_launches()
        t0 = time.time()
        states = [model.align(x, y) for x, y in pairs]
        t_align = time.time() - t0
        t0 = time.time()
        scores = model.score_pairs(batch)
        torch.cuda.synchronize()
        t_score = time.time() - t0
        t0 = time.time()
        save_model(model, ckpt)
        search.main(["--query-fasta", qf, "--db-fasta", dbf,
                     "--load-from-checkpoint", ckpt, "--output-file", hits,
                     "--batch-size", "16", "--pad-multiple", "64"])
        torch.cuda.synchronize()
        t_search = time.time() - t0
        launches = dict(dp_cuda.LAUNCHES)
        with open(hits) as f:
            rows = [line.rstrip("\n").split("\t") for line in f]

    for (x, y), s in zip(pairs, states):
        if s.count("1") + s.count(":") != len(x) or \
                s.count("2") + s.count(":") != len(y):
            raise AssertionError("align: states do not consume both strings")
    if scores.shape != (32,) or not torch.isfinite(scores).all():
        raise AssertionError("score_pairs: non-finite or misshapen scores")
    if len(rows) != 32 or any(len(r) != 4 for r in rows):
        raise AssertionError("search: expected 32 rows of 4 columns")
    # the CLI's scores against score_pairs of the same pairs in one batch
    qt, ql = pad_sequences([tok(queries[int(r[0][1:])])[0] for r in rows])
    dt, dl = pad_sequences([tok(db[int(r[1][1:])])[0] for r in rows])
    want = model.score_pairs(dict(x=qt, y=dt, x_len=ql, y_len=dl)).cpu()
    got = torch.tensor([float(r[2]) for r in rows])
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-3):
        raise AssertionError("search: CLI scores differ from score_pairs")
    if any(launches[k] == 0 for k in SERVING_KERNELS):
        raise AssertionError(f"a kernel did not run on the serving path: "
                             f"{launches}")
    log(f"phase serving: align x4 {t_align:.2f} s (state lengths "
        f"{[len(s) for s in states]}), score_pairs 32x512 {t_score:.2f} s, "
        f"save + search 32 pairs {t_search:.2f} s [{card}]; launches "
        f"{json.dumps(launches)}")

    # every kernel against its plain version at this path's own shapes
    errs = {}
    with torch.no_grad():
        b = model._as_batch(batch)
        hx, hy = model._embeddings(b)
        lengths = (b["x_len"].to(torch.int32), b["y_len"].to(torch.int32))
        theta, A = model.aligner.potentials(hx, hy, lengths)
        check_kernels(theta, A, *lengths, "nw", "softmax", errs)
        check_menu_kernels(theta, A, *lengths, "nw", "softmax",
                           model.dp_dtypes, errs)
        x, y = pairs[0]
        b = model._as_batch(dict(
            x=tok(x)[0][None], y=tok(y)[0][None],
            x_len=np.asarray([len(x)], np.int32),
            y_len=np.asarray([len(y)], np.int32)))
        hx, hy = model._embeddings(b)
        lengths = (b["x_len"], b["y_len"])
        theta, A = model.aligner.potentials(hx, hy, lengths)
        check_kernels(theta, A, *lengths, "nw", "softmax", errs)
        check_menu_kernels(theta, A, *lengths, "nw", "softmax",
                           model.dp_dtypes, errs)
    torch.cuda.synchronize()
    log(f"phase serving: the default config's storage menu "
        f"{model.dp_dtypes}")
    log(f"phase serving: kernels = plain at the path's shapes (32, 512, 512)"
        f" and (1, {len(x)}, {len(y)}); max abs diff {json.dumps(errs)}")
    del model
    torch.cuda.empty_cache()
    return launches, errs


# ---------------------------------------------------------------------------
# phase 4: training through the CLI at ProtT5-XL width
# ---------------------------------------------------------------------------

def _write_tsv(path, rows):
    with open(path, "w") as f:
        for r in rows:
            f.write("\t".join(r) + "\n")


def step_intervals(metrics):
    """Seconds between consecutive ``train_loss`` records of one epoch, by
    their ``wall_time``.  ``fit`` reads step i's loss back once step i+1
    is issued, and a step starts with a host-to-device copy of its batch
    that waits for the card, so these are host intervals of the user's
    own path, not per-step device times (PERF.md section 5)."""
    out, prev = [], None
    for m in metrics:
        if m["tag"] != "train_loss":
            prev = None
            continue
        if prev is not None:
            out.append(m["wall_time"] - prev)
        prev = m["wall_time"]
    return out


def train_rows(seed):
    """Phase ``train``'s TM-align rows: 48 training pairs of 100-500
    residues and 8 of 600-1,000, and 16 validation pairs of 100-500."""
    rng = np.random.default_rng(seed + 1)
    rows = [homolog_row(rng, f"s{i}", 100, 500) for i in range(48)]
    rows += [homolog_row(rng, f"l{i}", 600, 1000) for i in range(8)]
    valid = [homolog_row(rng, f"v{i}", 100, 500) for i in range(16)]
    return rows, valid


def phase_train(seed, card, out):
    """``cli.train`` into the model directory ``out``, which phase
    ``evaluate`` reads after it."""
    from deepblast_torch.cli import train as cli_train
    from deepblast_torch.ops import dp_cuda
    from deepblast_torch.train.checkpoint import load_model
    from deepblast_torch.train.trainer import DeepBLAST, DeepBLASTConfig

    rows, valid = train_rows(seed)
    errs = {}

    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, n) for n in ("train.tsv", "valid.tsv")]
        _write_tsv(paths[0], rows)
        _write_tsv(paths[1], valid)
        torch.cuda.reset_peak_memory_stats()
        dp_cuda.reset_launches()
        t0 = time.time()
        rc = cli_train.main([
            "--train-pairs", paths[0], "--valid-pairs", paths[1],
            "-o", out, "--lm-type", "prot_t5", "--batch-size", "16",
            "--epochs", "1", "--seed", str(seed)])
        torch.cuda.synchronize()
        t_train = time.time() - t0
        launches = dict(dp_cuda.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        if rc != 0:
            raise AssertionError(f"cli.train returned {rc}")
        metrics = read_metrics(out)
        losses = [(m["tag"], m["value"]) for m in metrics
                  if m["tag"] in ("train_loss", "validation_loss")]
        kept = os.listdir(os.path.join(out, "checkpoints"))

        # the aligner the run started from: the same config's seeded init
        with open(os.path.join(out, "config.json")) as f:
            config = DeepBLASTConfig.from_json(f.read())
        before = {k: v.clone() for k, v in
                  DeepBLAST(config).init().aligner.state_dict().items()}
        torch.cuda.empty_cache()

        t0 = time.time()
        model = load_model(out)
        pairs = [rows[0][5:7], rows[-1][5:7]]
        states = [model.align(x, y) for x, y in pairs]
        t_load = time.time() - t0
        changed = any(not torch.equal(v, before[k])
                      for k, v in model.aligner.state_dict().items())

        # every training kernel, and autograd through them, against the
        # plain versions at the potentials of the longest training batch
        batches = list(model._batches(model._dataset(paths[0]), True, seed))
        mode, operator = model.aligner.mode, model.config.operator
        batch = max(batches, key=lambda b: b["x"].shape[1])
        with torch.no_grad():
            b = model._as_batch(batch)
            hx, hy = model._embeddings(b)
            lengths = (b["x_len"].to(torch.int32), b["y_len"].to(torch.int32))
            theta, A = model.aligner.potentials(hx, hy, lengths)
            check_kernels(theta, A, *lengths, "nw", "softmax", errs)
            check_menu_kernels(theta, A, *lengths, "nw", "softmax",
                               model.dp_dtypes, errs)
        check_autograd(theta, A, *lengths, "nw", "softmax", errs,
                       cpu_pairs=1)
        check_autograd(theta, A, *lengths, "nw", "softmax", errs,
                       dtypes=model.dp_dtypes, cpu_pairs=1)
        torch.cuda.synchronize()
        checked = tuple(theta.shape)
        menu = model.dp_dtypes
        del model, hx, hy, theta, A
        torch.cuda.empty_cache()

    if any(launches[k] == 0 for k in TRAIN_KERNELS):
        raise AssertionError(f"a kernel did not run on the training path: "
                             f"{launches}")
    if menu is None or menu.d != "bfloat16":
        raise AssertionError(f"cli.train with default flags trained with "
                             f"the storage menu {menu}, not bf16 residuals")
    n_train = sum(t == "train_loss" for t, _ in losses)
    if n_train != len(batches) or \
            not all(np.isfinite(v) for _, v in losses):
        raise AssertionError(f"training losses {losses}")
    if batch["x"].shape[1] < 600:
        raise AssertionError("no training batch was padded past 600")
    if not changed:
        raise AssertionError("training left the aligner unchanged")
    if not 1 <= len(kept) <= 3:
        raise AssertionError(f"checkpoints/ holds {kept}")
    for (x, y), s in zip(pairs, states):
        if s.count("1") + s.count(":") != len(x) or \
                s.count("2") + s.count(":") != len(y):
            raise AssertionError("align: states do not consume both strings")
    shapes = [tuple(bt["x"].shape) + (bt["y"].shape[1],) for bt in batches]
    log(f"phase train: cli.train ProtT5-XL + CNN-1024, {len(rows)} train / "
        f"{len(valid)} valid pairs, batch 16, 1 epoch: {t_train:.2f} s; "
        f"batches (B, Lx, Ly) {shapes}; seconds between train_loss records "
        f"{[round(t, 4) for t in step_intervals(metrics)]}; peak device "
        f"memory {peak / 2**30:.2f} GiB; losses {losses}; checkpoints "
        f"{sorted(kept)}; load_model + align x2 {t_load:.2f} s [{card}]; "
        f"storage menu {menu}; launches {json.dumps(launches)}")
    log(f"phase train: kernels = plain and autograd = plain and CPU at the "
        f"longest training batch {checked}; max abs diff "
        f"{json.dumps(errs)}")
    return launches, errs


# ---------------------------------------------------------------------------
# phase 4a: the evaluation entry points on phase 4's model
# ---------------------------------------------------------------------------

#: the kernels of ``cli.evaluate``'s validation forward and of
#: ``cli.mali_align``'s stream decode
EVAL_KERNELS = ("skew_pair", "forward", "backward", "unskew")
MALI_KERNELS = ("skew_pair", "forward", "backward")
TEST_COLUMNS = [f"test_{c}" for c in ("tp", "fp", "fn", "perc_id", "ppv",
                                      "fnr", "fdr")] + ["query_name",
                                                        "key_name"]


def phase_evaluate(seed, card, out):
    """The evaluation CLIs on phase 4's model directory ``out``: (a)
    ``cli.evaluate`` on 16 TM-align rows = ``test()`` with the plain
    passes, then the kernels = plain at the batch's potentials; (b)
    ``cli.mali_align`` on 4 structure pairs = the in-memory ``align``, the
    TM-scores of the predicted and the true alignments, then the kernels =
    plain at the longest pair's potentials under the decode menu; (c)
    ``cli.tensorboard2csv`` on phase 4's logdir."""
    import csv

    from deepblast_torch.cli import evaluate as cli_evaluate
    from deepblast_torch.cli import mali_align as cli_mali
    from deepblast_torch.cli import tensorboard2csv as cli_tb
    from deepblast_torch.data.parse_pdb import readPDB
    from deepblast_torch.eval.metrics import process_alignment
    from deepblast_torch.ops import dp as dp_ops
    from deepblast_torch.ops import dp_cuda, dp_ref
    from deepblast_torch.train import checkpoint
    from deepblast_torch.train.trainer import DeepBLAST
    from deepblast_torch.utils.table import read_csv, write_csv

    rng = np.random.default_rng(seed + 14)
    rows = [homolog_row(rng, f"e{i}", 100, 500) for i in range(16)]
    pairs = [homolog_row(rng, f"m{i}", 100, 300) for i in range(4)]
    errs, seconds, loaded = {}, {}, []
    originals = checkpoint.load_model, DeepBLAST.test, DeepBLAST.align

    def timed_call(name, fn):
        """``fn`` adding the synchronized seconds of each call to
        ``seconds[name]``."""
        def wrapped(*a, **k):
            t0 = time.time()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            seconds.setdefault(name, []).append(round(time.time() - t0, 3))
            return r
        return wrapped

    def keep(*a, **k):
        loaded.append(originals[0](*a, **k))
        return loaded[-1]

    with tempfile.TemporaryDirectory() as tmp:
        tsv, res = os.path.join(tmp, "test.tsv"), os.path.join(tmp, "eval")
        _write_tsv(tsv, rows)
        mali, table = os.path.join(tmp, "mali"), os.path.join(tmp, "m.csv")
        os.makedirs(mali)
        for t, r in enumerate(pairs):
            write_structure_pair(rng, r, os.path.join(mali, f"p{t}_x.pdb"),
                                 os.path.join(mali, f"p{t}_y.pdb"))
        # column 0 the y chain, 1 the x chain: the CLI aligns (s1, s0)
        write_csv(os.path.join(tmp, "pairs.csv"),
                  [{"0": f"p{t}_y.pdb", "1": f"p{t}_x.pdb", "2": r[7]}
                   for t, r in enumerate(pairs)])
        checkpoint.load_model = timed_call("load_model", keep)
        DeepBLAST.test = timed_call("test", originals[1])
        DeepBLAST.align = timed_call("align", originals[2])
        try:
            dp_cuda.reset_launches()
            t0 = time.time()
            rc = cli_evaluate.main(["--load-from-checkpoint", out,
                                    "--test-pairs", tsv, "-o", res])
            torch.cuda.synchronize()
            seconds["cli.evaluate"] = round(time.time() - t0, 3)
            eval_launches = dict(dp_cuda.LAUNCHES)
            if rc != 0:
                raise AssertionError(f"cli.evaluate returned {rc}")
            dp_cuda.reset_launches()
            t0 = time.time()
            rc = cli_mali.main(["--mali-pairs", os.path.join(tmp,
                                                             "pairs.csv"),
                                "--input-mali-dir", mali,
                                "--load-from-checkpoint", out,
                                "--output-alignments", table])
            torch.cuda.synchronize()
            seconds["cli.mali_align"] = round(time.time() - t0, 3)
            mali_launches = dict(dp_cuda.LAUNCHES)
            if rc != 0:
                raise AssertionError(f"cli.mali_align returned {rc}")
        finally:
            checkpoint.load_model, DeepBLAST.test, DeepBLAST.align = \
                originals
        model = loaded.pop(0)
        loaded.clear()
        torch.cuda.empty_cache()

        # (a) the CSV against test() with the plain passes, same weights
        label, index, got = read_csv(os.path.join(res,
                                                  "test.tsv-results.csv"))
        ds = model._dataset(tsv, return_names=True)
        batches = list(model._batches(ds, False, 0))
        names = [n for b in batches for n in b["names"]]
        passes = dp_ops._passes
        dp_ops._passes = lambda t: dp_ref
        try:
            t0 = time.time()
            plain = model.test(ds)
            torch.cuda.synchronize()
            seconds["test (plain passes)"] = round(time.time() - t0, 3)
        finally:
            dp_ops._passes = passes
        if label != "" or index != list(range(16)) or len(got) != 16 or \
                any(list(r) != TEST_COLUMNS for r in got):
            raise AssertionError(f"cli.evaluate's CSV: index {label!r} "
                                 f"{index}, columns {list(got[0])}")
        if [(r["query_name"], r["key_name"]) for r in got] != names:
            raise AssertionError("cli.evaluate's CSV: names not in batch "
                                 "order")
        if [list(r.values()) for r in got] != \
                [list(r.values()) for r in plain]:
            raise AssertionError("cli.evaluate's statistics differ from "
                                 "test() with the plain passes")
        mode, operator = model.aligner.mode, model.config.operator
        batch = max(batches, key=lambda b: b["x"].shape[1])
        with torch.no_grad():
            b = model._as_batch(batch)
            hx, hy = model._embeddings(b)
            lengths = (b["x_len"].to(torch.int32), b["y_len"].to(torch.int32))
            theta, A = model.aligner.potentials(hx, hy, lengths)
            check_kernels(theta, A, *lengths, mode, operator, errs)
            check_menu_kernels(theta, A, *lengths, mode, operator,
                               model.dp_dtypes, errs)
        torch.cuda.synchronize()
        checked = tuple(theta.shape)
        del hx, hy, theta, A

        # (b) the alignments against the in-memory model's, and TM-scores
        _, _, aligned = read_csv(table)
        tm = []
        for t, (r, a) in enumerate(zip(pairs, aligned)):
            px, py = (os.path.join(mali, f"p{t}_{c}.pdb") for c in "xy")
            _, s0 = readPDB(py)
            _, s1 = readPDB(px)
            if (s1.seq, s0.seq) != (r[5], r[6]):
                raise AssertionError(f"pair {t}: readPDB's sequences are not "
                                     f"the row's")
            if list(a) != ["query_seq", "hit_seq", "manual", "deepblast"] \
                    or a["deepblast"] != model.align(s1.seq, s0.seq):
                raise AssertionError(f"cli.mali_align row {t}: {a}")
            scores = [process_alignment(s, pdb0=px, pdb1=py).TM
                      for s in (a["deepblast"], r[7])]
            if not all(math.isfinite(v) and 0 < v <= 1 for v in scores):
                raise AssertionError(f"pair {t}: TM-scores {scores}")
            tm.append([round(float(v), 4) for v in scores])
        if len(aligned) != 4:
            raise AssertionError(f"cli.mali_align wrote {len(aligned)} rows")
        # the kernels at the stream decode's own shape: the longest pair as
        # align gives it (s1 against s0, a batch of 1), the decode's menu
        x, y = max(((r[5], r[6]) for r in pairs),
                   key=lambda p: len(p[0]) * len(p[1]))
        tok = model.tokenizer
        mali_errs = {}
        with torch.no_grad():
            b = model._as_batch(dict(
                x=tok(x)[0][None], y=tok(y)[0][None],
                x_len=np.asarray([len(x)], np.int32),
                y_len=np.asarray([len(y)], np.int32)))
            hx, hy = model._embeddings(b)
            lengths = (b["x_len"].to(torch.int32), b["y_len"].to(torch.int32))
            theta, A = model.aligner.potentials(hx, hy, lengths)
            check_kernels(theta, A, *lengths, mode, operator, mali_errs)
            check_menu_kernels(theta, A, *lengths, mode, operator,
                               model.dp_decode_dtypes, mali_errs)
        torch.cuda.synchronize()
        checked_mali = tuple(theta.shape)
        del hx, hy, theta, A

        # (c) phase 4's metrics.jsonl as a CSV
        logdir = os.path.join(out, next(d for d in os.listdir(out)
                                        if d.startswith("logdir_")))
        with open(os.path.join(logdir, "metrics.jsonl")) as f:
            scalars = sum("value" in json.loads(line) for line in f)
        m_csv = os.path.join(tmp, "metrics.csv")
        if cli_tb.main(["--logdir", logdir, "--output-csv", m_csv]) != 0:
            raise AssertionError("cli.tensorboard2csv failed")
        with open(m_csv, newline="") as f:
            lines = list(csv.reader(f))
        if lines[0] != ["tag", "value", "step", "wall_time"] or \
                len(lines) - 1 != scalars:
            raise AssertionError(f"tensorboard2csv: header {lines[0]}, "
                                 f"{len(lines) - 1} rows of {scalars}")
    model_menus = model.dp_dtypes, model.dp_decode_dtypes
    del model
    torch.cuda.empty_cache()

    for name, launches, need in (("cli.evaluate", eval_launches,
                                  EVAL_KERNELS),
                                 ("cli.mali_align", mali_launches,
                                  MALI_KERNELS)):
        if any(launches[k] == 0 for k in need):
            raise AssertionError(f"a kernel did not run on {name}'s path: "
                                 f"{launches}")
    launches = {k: eval_launches[k] + mali_launches[k] for k in eval_launches}
    log(f"phase evaluate: cli.evaluate on 16 rows of 100-500 residues, "
        f"batches {[tuple(b['x'].shape) + (b['y'].shape[1],) for b in batches]}"
        f", = test() with the plain passes; cli.mali_align on 4 structure "
        f"pairs of 100-300 residues = align; TM-score (predicted, true) "
        f"{tm}; tensorboard2csv {scalars} rows; seconds "
        f"{json.dumps(seconds)} [{card}]; launches evaluate "
        f"{json.dumps(eval_launches)}, mali_align {json.dumps(mali_launches)}")
    log(f"phase evaluate: kernels = plain at the evaluate batch {checked}, "
        f"float32 and the menu {model_menus[0]}; max abs diff "
        f"{json.dumps(errs)}")
    log(f"phase evaluate: kernels = plain at mali_align's longest pair "
        f"{checked_mali}, float32 and the decode menu {model_menus[1]}; max "
        f"abs diff {json.dumps(mali_errs)}")
    for k, v in mali_errs.items():
        errs[k] = max(errs.get(k, 0.0), v)
    return launches, errs


# ---------------------------------------------------------------------------
# phase 4b: the trainer options at ProtT5-XL width
# ---------------------------------------------------------------------------

def uniform_rows(rng, n, lo, hi, prefix):
    """``n`` TM-align rows (:func:`homolog_row`) whose two sequences both
    have ``lo``..``hi`` residues, so that every batch pads to one shape
    and ``--steps-per-dispatch`` forms whole chunks (``cli.train`` pads to
    a multiple of 16 and has no flag for it)."""
    rows = []
    while len(rows) < n:
        r = homolog_row(rng, f"{prefix}{len(rows)}", lo, hi)
        if lo <= len(r[5]) <= hi and lo <= len(r[6]) <= hi:
            rows.append(r)
    return rows


class count_waits:
    """Within the block, the host's waits for the card inside the training
    loop of ``DeepBLAST.fit``: the synchronizing CUDA operations
    (``torch.cuda.set_sync_debug_mode("warn")``) inside its steps, its
    chunks' host-to-device copies and its losses' device-to-host copies,
    and its loss readbacks (each an event wait on one dispatch's losses);
    the chunks and steps it issued; and the host's seconds in each of
    those calls (``seconds``: issuing the steps, the copies, and waiting
    at the readbacks)."""

    HOOKS = ("_step", "_device_chunk", "_losses_to_host", "_consume_loss")

    def __enter__(self):
        import warnings
        from deepblast_torch.train.trainer import DeepBLAST
        self.n = dict(syncs=0, readbacks=0, chunks=0, steps=0,
                      seconds={h: 0.0 for h in self.HOOKS})
        self.caught = warnings.catch_warnings(record=True)
        seen = self.caught.__enter__()
        warnings.simplefilter("always")
        self.orig = {h: getattr(DeepBLAST, h) for h in self.HOOKS}
        n, orig = self.n, self.orig

        def hook(name, counter):
            def wrapped(*args):
                before = sum("synchronizing" in str(w.message) for w in seen)
                t0 = time.time()
                out = orig[name](*args)
                n["seconds"][name] += time.time() - t0
                n["syncs"] += sum("synchronizing" in str(w.message)
                                  for w in seen) - before
                if counter:
                    n[counter] += 1
                return out
            return wrapped

        for name, counter in zip(self.HOOKS, ("steps", "chunks", None,
                                              "readbacks")):
            setattr(DeepBLAST, name, hook(name, counter))
        torch.cuda.set_sync_debug_mode("warn")
        return self.n

    def __exit__(self, *exc):
        from deepblast_torch.train.trainer import DeepBLAST
        torch.cuda.set_sync_debug_mode("default")
        for name, fn in self.orig.items():
            setattr(DeepBLAST, name, fn)
        self.caught.__exit__(*exc)


def run_cli_train(argv, outputs=True):
    """``cli.train`` in-process; returns the run's seconds, peak device
    memory, the model ``fit`` trained (in memory), its aligner's weights
    before ``fit`` (on the CPU) and its history, and with ``outputs`` the
    ``metrics.jsonl`` records and the best checkpoint of the output
    directory."""
    from deepblast_torch.cli import train as cli_train
    from deepblast_torch.train.checkpoint import Checkpointer
    from deepblast_torch.train.trainer import DeepBLAST
    out = argv[argv.index("-o") + 1]
    fit, trained, histories = DeepBLAST.fit, [], []

    def keep(self, *a, **k):
        trained.append(self)
        trained.append({k: v.to("cpu", copy=True) for k, v in
                        self.aligner.state_dict().items()})
        out = fit(self, *a, **k)
        histories.append(out[1])
        return out

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    DeepBLAST.fit = keep
    try:
        t0 = time.time()
        rc = cli_train.main(argv)
        torch.cuda.synchronize()
    finally:
        DeepBLAST.fit = fit
    seconds = time.time() - t0
    if rc != 0:
        raise AssertionError(f"cli.train returned {rc}")
    run = dict(seconds=seconds, peak=torch.cuda.max_memory_allocated(),
               model=trained[0], before=trained[1], history=histories[0])
    if outputs:
        run.update(metrics=read_metrics(out), best=Checkpointer(
            os.path.join(out, "checkpoints")).restore())
    return run


def read_metrics(out):
    """The records of the ``metrics.jsonl`` that ``cli.train`` wrote in
    ``out``."""
    logs = [d for d in os.listdir(out) if d.startswith("logdir_")]
    with open(os.path.join(out, logs[0], "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_options(seed, card):
    """(a) ``cli.train --precision bf16 --grad-accum 2
    --steps-per-dispatch 4`` at ProtT5-XL + CNN-1024, batch 16, 1 epoch,
    on 128 pairs of 481-496 residues (one batch shape: two whole chunks) and 16 validation pairs of 100-500: losses finite, every
    training kernel ran (counters zeroed before, read after), the
    optimizer and the schedule stepped once per two steps, no wait for the
    card inside a chunk's steps or copies and one loss readback a chunk;
    then the kernels of the run's storage menu, and autograd through
    them, against the plain versions at the potentials of a training
    batch.  (b) ``cli.train
    --finetune True --precision bf16``, batch 4, 1 epoch, 12 pairs of
    100-300 residues: the LM's weights changed, and ``load_model`` of the
    output directory serves ``align`` with the trained LM, the states of
    the in-memory model.  Returns (a)'s launches and the kernels'
    errors."""
    from deepblast_torch.ops import dp_cuda
    from deepblast_torch.train.checkpoint import load_model
    from deepblast_torch.train.trainer import DeepBLAST, DeepBLASTConfig

    rng = np.random.default_rng(seed + 4)
    rows = uniform_rows(rng, 128, 481, 496, "u")
    valid = [homolog_row(rng, f"v{i}", 100, 500) for i in range(16)]
    errs = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, n) for n in ("train.tsv", "valid.tsv")]
        _write_tsv(paths[0], rows)
        _write_tsv(paths[1], valid)
        out = os.path.join(tmp, "a")
        dp_cuda.reset_launches()
        with count_waits() as waits:
            run = run_cli_train([
                "--train-pairs", paths[0], "--valid-pairs", paths[1],
                "-o", out, "--lm-type", "prot_t5", "--batch-size", "16",
                "--epochs", "1", "--precision", "bf16", "--grad-accum", "2",
                "--steps-per-dispatch", "4", "--seed", str(seed)])
        launches = dict(dp_cuda.LAUNCHES)
        model, best = run["model"], run["best"]
        losses = [(m["tag"], m["value"]) for m in run["metrics"]
                  if m["tag"] in ("train_loss", "validation_loss")]
        n_steps = sum(t == "train_loss" for t, _ in losses)
        opt_steps = {int(v["step"]) for v in
                     best["optimizer"]["state"].values()}
        sched_steps = best["scheduler"]["last_epoch"]
        if n_steps != 8 or not all(np.isfinite(v) for _, v in losses):
            raise AssertionError(f"training losses {losses}")
        if any(launches[k] == 0 for k in TRAIN_KERNELS):
            raise AssertionError(f"a kernel did not run on the options' "
                                 f"training path: {launches}")
        if opt_steps != {best["step"] // 2} or \
                sched_steps != best["step"] // 2 or model.step != 8 or \
                model._mini_step != 0:
            raise AssertionError(
                f"grad_accum 2: {best['step']} steps, optimizer steps "
                f"{opt_steps}, schedule {sched_steps}")
        if waits["chunks"] != 2 or waits["steps"] != 8 or \
                waits["syncs"] != 0 or waits["readbacks"] != 2:
            raise AssertionError(f"steps_per_dispatch 4: {waits}")
        if model.lm.cfg.dtype != "bfloat16" or \
                model.aligner.matmul_dtype != torch.bfloat16:
            raise AssertionError("--precision bf16 did not reach the model")

        # the kernels of the run's menu, and autograd through them, at a
        # training batch's potentials (every batch has one shape; phase 4
        # holds float32 storage, and the DP does not see the precision)
        batch = next(model._batches(model._dataset(paths[0]), True, seed))
        with torch.no_grad():
            b = model._as_batch(batch)
            hx, hy = model._embeddings(b)
            lengths = (b["x_len"].to(torch.int32), b["y_len"].to(torch.int32))
            theta, A = model.aligner.potentials(hx, hy, lengths)
            check_menu_kernels(theta, A, *lengths, "nw", "softmax",
                               model.dp_dtypes, errs)
        check_autograd(theta, A, *lengths, "nw", "softmax", errs,
                       dtypes=model.dp_dtypes, cpu_pairs=2)
        torch.cuda.synchronize()
        checked = tuple(theta.shape)
        # a chunk's losses are logged together, after the next chunk is
        # issued: the second chunk of an epoch is logged at its end
        walls = sorted({m["wall_time"] for m in run["metrics"]
                        if m["tag"] == "train_loss"})
        seconds, peak = run["seconds"], run["peak"]
        del model, run, best, hx, hy, theta, A
        torch.cuda.empty_cache()
        log(f"phase options: cli.train --precision bf16 --grad-accum 2 "
            f"--steps-per-dispatch 4, ProtT5-XL + CNN-1024, {len(rows)} "
            f"train / {len(valid)} valid pairs, batches (16, 496, 496), 1 "
            f"epoch: {seconds:.2f} s; {waits['steps']} steps in "
            f"{waits['chunks']} chunks of 4, {sched_steps} updates at the "
            f"best checkpoint's step {2 * sched_steps}; host waits in the "
            f"training loop: {waits['readbacks']} loss readbacks (one a "
            f"chunk), {waits['syncs']} synchronizing operations in the "
            f"steps and the chunks' copies; host seconds issuing the steps "
            f"{waits['seconds']['_step']:.4f}, copying the chunks "
            f"{waits['seconds']['_device_chunk']:.4f}, waiting at the "
            f"readbacks {waits['seconds']['_consume_loss']:.4f}; seconds "
            f"between the chunks' train_loss records "
            f"{[round(b - a, 4) for a, b in zip(walls, walls[1:])]}; peak "
            f"device memory {peak / 2**30:.2f} GiB; losses {losses} "
            f"[{card}]; launches {json.dumps(launches)}")
        log(f"phase options: kernels = plain and autograd = plain and CPU "
            f"at a training batch {checked}; max abs diff "
            f"{json.dumps(errs)}")

        # (b) finetune
        rows_b = [homolog_row(rng, f"f{i}", 100, 300) for i in range(12)]
        valid_b = [homolog_row(rng, f"w{i}", 100, 300) for i in range(4)]
        _write_tsv(paths[0], rows_b)
        _write_tsv(paths[1], valid_b)
        out = os.path.join(tmp, "b")
        run = run_cli_train([
            "--train-pairs", paths[0], "--valid-pairs", paths[1], "-o", out,
            "--lm-type", "prot_t5", "--batch-size", "4", "--epochs", "1",
            "--finetune", "True", "--precision", "bf16", "--seed",
            str(seed)])
        trained = run["model"]
        with open(os.path.join(out, "config.json")) as f:
            config = DeepBLASTConfig.from_json(f.read())
        if not (config.finetune and trained.config.finetune):
            raise AssertionError("--finetune True did not reach the config")
        init = DeepBLAST(config).init().lm.state_dict()
        lm = trained.lm.state_dict()
        changed = sum(not torch.equal(v, init[k]) for k, v in lm.items())
        del init
        torch.cuda.empty_cache()
        served = load_model(out)
        same_lm = all(torch.equal(v, lm[k])
                      for k, v in served.lm.state_dict().items())
        pairs = [r[5:7] for r in rows_b[:3]]
        states = [served.align(x, y) for x, y in pairs]
        want = [trained.align(x, y) for x, y in pairs]
        losses_b = [(m["tag"], m["value"]) for m in run["metrics"]
                    if m["tag"] in ("train_loss", "validation_loss")]
        seconds_b, peak_b = run["seconds"], run["peak"]
        del served, trained, run, lm
        torch.cuda.empty_cache()
    if not changed:
        raise AssertionError("--finetune left the LM unchanged")
    if not same_lm or states != want:
        raise AssertionError("load_model did not serve the finetuned LM")
    if not all(np.isfinite(v) for _, v in losses_b):
        raise AssertionError(f"finetune losses {losses_b}")
    log(f"phase options: cli.train --finetune True --precision bf16, "
        f"ProtT5-XL + CNN-1024, {len(rows_b)} train / {len(valid_b)} valid "
        f"pairs of 100-300, batch 4, 1 epoch: {seconds_b:.2f} s; {changed} "
        f"of the LM's tensors changed; load_model serves them (align x"
        f"{len(pairs)} = the in-memory model's states); peak device memory "
        f"{peak_b / 2**30:.2f} GiB; losses {losses_b} [{card}]")
    return launches, errs


# ---------------------------------------------------------------------------
# phase 4d: data parallel training and search (torch.distributed)
# ---------------------------------------------------------------------------

# the phase's training rows (count, shortest, longest) and validation rows
PARALLEL_ROWS = (24, 100, 300)
PARALLEL_VALID = 8
# two ranks against one process, each of a series' largest magnitude: the
# first step's loss (the same function of the same weights on the same
# rows, reduced in another order); the later losses and the final weights
# (of the aligner's largest), where AdamW has moved each weight whose
# gradient is near zero by up to the learning rate in the direction that
# rounding gave it (2.3e-4 and 9.2e-4 read on an H100; PERF.md); the
# validation traceback's statistics, where a step at a near tie flips
# (7.1e-3 read); and the training's update (final - initial weights) as a
# relative L2 distance (7.8e-4 read, 1.05e-2 at float32 residuals)
PARALLEL_FIRST_RTOL = 1e-4
PARALLEL_RTOL = 2e-3
PARALLEL_STATS_RTOL = 2e-2
PARALLEL_UPDATE_RTOL = 0.1
# the LM's blocks (of ProtT5-XL's 24): a shard's B = 4 rows and the whole
# B = 8 round differently in cuBLAS, and 24 blocks of seeded random weights
# amplify that to 8e-5 of the features' scale and 0.45% of a batch's loss
# (theta up to 265, a nearly hard DP), where 2 blocks give 2.5e-6 and
# 8.5e-6 (one process, halves against the whole: PERF.md,
# scripts/torch_batch_split.py)
PARALLEL_BLOCKS = 2


def parallel_argv(paths, lm, out, extra=()):
    """``cli.train`` at ProtT5-XL width (the HF directory ``lm``: seeded
    weights, ``PARALLEL_BLOCKS`` blocks) + CNN-1024, the
    ``deepblast-train`` defaults but dropout 0 (so that the shards and one
    process train the same function), batch 8, 1 epoch, then the flags
    ``extra``."""
    return ["--train-pairs", paths[0], "--valid-pairs", paths[1], "-o", out,
            "--pretrain-path", lm, "--batch-size", "8", "--epochs", "1",
            "--dropout", "0", "--seed", "0", *extra]


def parallel_inputs(tmp, seed, n=PARALLEL_ROWS[0]):
    """Phase ``parallel``'s inputs, written in ``tmp``: TM-align TSVs of
    ``n`` training rows and ``PARALLEL_VALID`` validation rows of
    ``PARALLEL_ROWS``' lengths, and the HF directory of a ProtT5-XL-width
    encoder of ``PARALLEL_BLOCKS`` seeded blocks; returns ``(paths,
    lm)``."""
    from deepblast_torch.models.convert import hf_t5_encoder_key_shapes
    from deepblast_torch.models.lm import T5Config
    rng = np.random.default_rng(seed + 9)
    _, lo, hi = PARALLEL_ROWS
    rows = [homolog_row(rng, f"p{i}", lo, hi) for i in range(n)]
    valid = [homolog_row(rng, f"pv{i}", lo, hi)
             for i in range(PARALLEL_VALID)]
    paths = [os.path.join(tmp, f) for f in ("train.tsv", "valid.tsv")]
    _write_tsv(paths[0], rows)
    _write_tsv(paths[1], valid)
    lm = os.path.join(tmp, "hf")
    os.makedirs(lm)
    g = torch.Generator().manual_seed(seed + 9)
    torch.save(seeded_state_dict(hf_t5_encoder_key_shapes(
        dataclasses.replace(T5Config.prot_t5_xl(),
                            num_layers=PARALLEL_BLOCKS)), g),
        os.path.join(lm, "pytorch_model.bin"))
    return paths, lm


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_main(spec_path, r):
    """One of phase ``parallel``'s two gloo ranks on the card
    (``chip_smoke.py --rank <spec> <r>``): ``cli.train`` in process
    (``fit(mesh="auto")``: dp 2), its launches; on rank 0 the kernels and
    autograd against their plain versions at its last shard's potentials;
    then ``cli.search --mesh auto`` on rank 0's model and its launches.
    The results go to ``<dir>/rank<r>.pt``."""
    import torch.distributed as dist
    from deepblast_torch import native
    from deepblast_torch.cli import search
    from deepblast_torch.ops import dp_cuda
    from deepblast_torch.parallel import mesh as mesh_lib
    PHASE[0] = f"parallel rank {r}"
    torch.set_num_threads(2)
    dp_cuda.build()
    native.build()
    with open(spec_path) as f:
        spec = json.load(f)
    mesh_lib.initialize_distributed(f"file://{spec['store']}", 2, r,
                                    backend="gloo")
    try:
        dp_cuda.reset_launches()
        run = run_cli_train(spec["train"], outputs=False)
        train_launches = dict(dp_cuda.LAUNCHES)
        model = run["model"]
        errs, checked = {}, None
        if r == 0:
            t0 = time.time()
            batches = list(model._batches(
                model._dataset(spec["train_pairs"]), True, 0))
            part = model._rows(batches[-1])
            with torch.no_grad():
                b = model._as_batch(part)
                hx, hy = model._embeddings(b)
                lengths = (b["x_len"].to(torch.int32),
                           b["y_len"].to(torch.int32))
                theta, A = model.aligner.potentials(hx, hy, lengths)
                check_kernels(theta, A, *lengths, "nw", "softmax", errs)
            check_autograd(theta, A, *lengths, "nw", "softmax", errs,
                           dtypes=model.dp_dtypes, cpu_pairs=1)
            checked = (tuple(theta.shape), round(time.time() - t0, 1))
            del hx, hy, theta, A
        dist.barrier()              # rank 0 has written model.pt
        dp_cuda.reset_launches()
        t0 = time.time()
        search.main(spec["search"])
        torch.cuda.synchronize()
        search_seconds = time.time() - t0
        search_launches = dict(dp_cuda.LAUNCHES)
        torch.save(dict(
            history=run["history"], seconds=run["seconds"],
            dp=model.mesh.size(0),
            aligner={k: v.cpu() for k, v in model.aligner.state_dict()
                     .items()},
            train_launches=train_launches, search_launches=search_launches,
            search_seconds=search_seconds, errs=errs, checked=checked,
            menu=str(model.dp_dtypes)),
            os.path.join(spec["dir"], f"rank{r}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def _relay(procs, timeout):
    """Wait for each ``(name, Popen, log)``, relay its log, raise if one
    failed; a process still running at the end is killed."""
    try:
        for name, p, log_f in procs:
            rc = p.wait(timeout=timeout)
            log_f.seek(0)
            for line in log_f.read().splitlines()[-40:]:
                log(f"[{name}] {line}")
            if rc != 0:
                raise AssertionError(f"phase parallel: {name} exited with "
                                     f"{rc}")
    finally:
        for _, p, log_f in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log_f.close()


def _of_scale(got, want):
    """The largest difference over the largest magnitude of ``want``."""
    got, want = torch.as_tensor(got, dtype=torch.float64), \
        torch.as_tensor(want, dtype=torch.float64)
    return ((got - want).abs().max() /
            want.abs().max().clamp_min(1e-30)).item()


def phase_parallel(seed, card, extra=()):
    """Data parallel training and search through ``torch.distributed``
    beside the worker, at ProtT5-XL width (``PARALLEL_BLOCKS`` blocks) +
    CNN-1024 (``parallel_argv``).  (a) two processes on the one card join a
    gloo group (``rank_main``) and run ``cli.train`` (``fit(mesh="auto")``:
    4 rows of each batch of 8 a rank) while this process runs the same
    command alone: both ranks' histories and final aligner weights equal
    each other exactly and this process's to the ``PARALLEL_*`` limits;
    every training kernel launched in each rank; rank 0's kernels and
    autograd = plain at its last shard.  (b) ``python -m
    deepblast_torch.cli.train --coordinator 127.0.0.1:<port> --nodes 1
    --process-id 0`` (NCCL, world size 1) in a subprocess: its
    ``train_loss`` records equal this process's bit for bit.  (c) the two
    ranks' ``cli.search --mesh auto`` on phase 3's FASTA files and rank
    0's model = ``--mesh none`` here to rtol 1e-4 / atol 1e-5, line for
    line; ``skew_pair`` and the score-only forward launched in each rank.
    ``extra``: flags added to every ``cli.train`` command (e.g. another
    storage menu; the smoke adds none).  Returns the phase's launches (both ranks, training and search) and
    rank 0's kernel errors."""
    import deepblast_torch
    from deepblast_torch.cli import search
    # the checkout's root, from which python -m finds the package
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        deepblast_torch.__file__)))
    n, lo, hi = PARALLEL_ROWS
    _, _, _, queries, db = serving_data(seed)
    with tempfile.TemporaryDirectory() as tmp:
        paths, lm = parallel_inputs(tmp, seed)
        qf, dbf = os.path.join(tmp, "q.fa"), os.path.join(tmp, "db.fa")
        _write_fasta(qf, queries, "q")
        _write_fasta(dbf, db, "d")
        out2, out1, outn = (os.path.join(tmp, d)
                            for d in ("ranks", "alone", "nccl"))
        hits = {m: os.path.join(tmp, f"hits_{m}") for m in ("auto", "none")}

        def search_argv(mesh):
            return ["--query-fasta", qf, "--db-fasta", dbf,
                    "--load-from-checkpoint", out2, "--output-file",
                    hits[mesh], "--batch-size", "16", "--pad-multiple", "64",
                    "--mesh", mesh]

        spec = os.path.join(tmp, "spec.json")
        with open(spec, "w") as f:
            json.dump(dict(store=os.path.join(tmp, "store"), dir=tmp,
                           train=parallel_argv(paths, lm, out2, extra),
                           train_pairs=paths[0],
                           search=search_argv("auto")), f)
        procs = []
        t0 = time.time()
        for r in range(2):
            log_f = open(os.path.join(tmp, f"rank{r}.log"), "w+")
            procs.append((f"rank {r}", subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", spec,
                 str(r)], stdout=log_f, stderr=subprocess.STDOUT), log_f))
        log_f = open(os.path.join(tmp, "nccl.log"), "w+")
        procs.append(("nccl", subprocess.Popen(
            [sys.executable, "-m", "deepblast_torch.cli.train",
             *parallel_argv(paths, lm, outn, extra), "--coordinator",
             f"127.0.0.1:{free_port()}", "--nodes", "1", "--process-id",
             "0"], cwd=root, stdout=log_f, stderr=subprocess.STDOUT),
            log_f))
        try:
            alone = run_cli_train(parallel_argv(paths, lm, out1, extra))
        finally:
            _relay(procs, timeout=600)
        t_ranks = time.time() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
        nccl = read_metrics(outn)
        t1 = time.time()
        search.main(search_argv("none"))
        t_none = time.time() - t1
        lines = {m: [ln.rstrip("\n").split("\t") for ln in open(hits[m])]
                 for m in hits}
        metrics2 = read_metrics(out2)

    # (a) two ranks = one process; (b) NCCL at world size 1 = no flags, bit
    # for bit; (c) search --mesh auto on the ranks = --mesh none here.
    # Everything is measured and logged, then the failures raise.
    bad = []
    errs = dict(ranks[0]["errs"])
    hist, hist1 = ranks[0]["history"], alone["history"]
    if ranks[1]["history"] != hist:
        bad.append("the ranks' histories differ")
    steps = {name: [m["value"] for m in ms if m["tag"] == "train_loss"]
             for name, ms in (("one process", alone["metrics"]),
                              ("2 ranks", metrics2), ("nccl", nccl))}
    worst = {key: _of_scale([h[key] for h in hist], [h[key] for h in hist1])
             for key in hist1[0] if key != "epoch"}
    worst["first step"] = _of_scale(steps["2 ranks"][:1],
                                    steps["one process"][:1])
    worst["train_loss records"] = _of_scale(steps["2 ranks"],
                                            steps["one process"])
    al1 = {k: v.cpu() for k, v in alone["model"].aligner.state_dict()
           .items()}
    scale = max(v.abs().max().item() for v in al1.values())
    tensors = {}
    for k, v in al1.items():
        if not torch.equal(ranks[1]["aligner"][k], ranks[0]["aligner"][k]):
            bad.append(f"the ranks' {k} differ")
        tensors[k] = (ranks[0]["aligner"][k] - v).abs().max().item() / scale
    worst["weights"] = max(tensors.values())
    d1, d2 = (torch.cat([(w[k] - v0).flatten()
                         for k, v0 in alone["before"].items()])
              for w in (al1, ranks[0]["aligner"]))
    worst["update"] = ((d2 - d1).norm() / d1.norm()).item()
    errs["parallel_vs_one_process"] = max(
        v for k, v in worst.items() if not k.startswith("val_"))
    limits = {k: PARALLEL_STATS_RTOL if k.startswith("val_") else
              PARALLEL_FIRST_RTOL if k == "first step" else
              PARALLEL_UPDATE_RTOL if k == "update" else PARALLEL_RTOL
              for k in worst}
    over = {k: v for k, v in worst.items() if v > limits[k]}
    if over:
        bad.append(f"2 ranks vs one process beyond their limits {limits}: "
                   f"{over}")
    for r, res in enumerate(ranks):
        if res["dp"] != 2 or any(res["train_launches"][k] == 0
                                 for k in TRAIN_KERNELS):
            bad.append(f"rank {r} (dp {res['dp']}) train launches "
                       f"{res['train_launches']}")
        if any(res["search_launches"][k] == 0
               for k in ("skew_pair", "forward_score")):
            bad.append(f"rank {r} search launches {res['search_launches']}")
    if steps["nccl"] != steps["one process"] or not steps["nccl"]:
        bad.append("NCCL world 1 train_loss differs from one process's")
    if len(lines["auto"]) != len(queries) * len(db) or \
            [ln[:2] for ln in lines["auto"]] != \
            [ln[:2] for ln in lines["none"]]:
        bad.append("search lines differ")
    sa = torch.tensor([[float(v) for v in ln[2:]] for ln in lines["auto"]])
    sn = torch.tensor([[float(v) for v in ln[2:]] for ln in lines["none"]])
    if sa.shape != sn.shape or not torch.allclose(sa, sn, rtol=1e-4,
                                                  atol=1e-5):
        bad.append("--mesh auto scores differ from --mesh none")
    search_err = (sa - sn).abs().max().item() if sa.shape == sn.shape \
        else math.inf
    launches = {k: sum(res["train_launches"][k] + res["search_launches"][k]
                       for res in ranks) for k in ranks[0]["train_launches"]}
    top = sorted(tensors.items(), key=lambda kv: -kv[1])[:3]
    log(f"phase parallel: cli.train ProtT5-XL width ({PARALLEL_BLOCKS} of "
        f"24 blocks) + CNN-1024, {n} train / "
        f"{PARALLEL_VALID} valid rows of {lo}-{hi}, batch 8, 1 epoch, dropout "
        f"0, storage menu {ranks[0]['menu']}: two gloo ranks on the card "
        f"(4 rows a rank) {ranks[0]['seconds']:.2f} / "
        f"{ranks[1]['seconds']:.2f} s, one process {alone['seconds']:.2f} "
        f"s; seconds between train_loss records: 2 ranks "
        f"{[round(t, 4) for t in step_intervals(metrics2)]}, one process "
        f"{[round(t, 4) for t in step_intervals(alone['metrics'])]}; "
        f"train_loss records {json.dumps(steps)}; largest differences of "
        f"scale {json.dumps(worst)} (weights: of the aligner's largest, "
        f"{scale:.4g}), weights' largest {top}; search --mesh "
        f"auto on 2 ranks {ranks[0]['search_seconds']:.2f} s, --mesh none "
        f"{t_none:.2f} s, max abs diff {search_err}; the ranks, the NCCL "
        f"run and this process's run {t_ranks:.1f} s [{card}]; launches "
        f"rank 0 train {json.dumps(ranks[0]['train_launches'])} search "
        f"{json.dumps(ranks[0]['search_launches'])}")
    log(f"phase parallel: rank 0's kernels = plain and autograd = plain and "
        f"CPU at its last shard {ranks[0]['checked']} (shape, seconds); max "
        f"abs diff {json.dumps(ranks[0]['errs'])}")
    if bad:
        raise AssertionError(f"phase parallel: {bad}")
    return launches, errs


# ---------------------------------------------------------------------------
# phase 4c: the BiLM, the RNN head and offline LM weights
# ---------------------------------------------------------------------------

# phase bilm's sizes: the deepblast-train defaults (embedding 1024, hidden
# 1024), rows of (count, shortest, longest) residues, the Bepler lstm2x
# geometry, ProtT5-XL width cut to 2 blocks (for time), and the batch the
# card is held to the CPU on
BILM_SIZES = dict(embedding=1024, hidden=1024, rows=[(24, 100, 500),
                                                     (8, 800, 1000)],
                  valid=(8, 100, 400), uniform=(64, 241, 256),
                  artifact_rows=(32, 100, 300),
                  bepler=dict(nin=22, nout=21, embedding_dim=21,
                              hidden_dim=1024, num_layers=2),
                  t5_blocks=2, cpu_batch=(2, 24, 64))


def seeded_state_dict(shapes, g):
    """A torch state dict of ``shapes`` (key -> shape, torch layouts) with
    seeded weights of ``init_weights``' scales: layer norms one, the
    relative-position bias normal(0.02), the token tables standard normal,
    every other matrix and vector normal with std ``1/sqrt(fan_in)`` (its
    last dimension)."""
    out = {}
    for k, shape in shapes.items():
        if "layer_norm" in k:
            out[k] = torch.ones(shape)
        elif "relative_attention_bias" in k:
            out[k] = torch.randn(shape, generator=g) * 0.02
        elif k in ("shared.weight", "embed.weight"):
            out[k] = torch.randn(shape, generator=g)
        else:
            out[k] = torch.randn(shape, generator=g) / math.sqrt(shape[-1])
    return out


def lstms(*modules):
    return [m for mod in modules for m in mod.modules()
            if isinstance(m, torch.nn.LSTM)]


@timed_check
def check_recurrent(model, seqs, errs):
    """The BiLM's features and the RNN heads' outputs (match and gap) of
    ``seqs`` on the card against CPU copies of the same modules, at true
    positions: each to 1e-4 of its largest magnitude (cuDNN's LSTM and
    the CPU's sum the same products in other orders).  The heads read
    the card's LM features on both sides."""
    from deepblast_torch.data.state_utils import pad_sequences
    tok, lens = pad_sequences([model.tokenizer(s)[0] for s in seqs])
    lm_cpu = copy.deepcopy(model.lm).cpu().eval()
    al_cpu = copy.deepcopy(model.aligner).cpu().eval()
    model.lm.eval()
    model.aligner.eval()
    t_card = torch.as_tensor(tok, device=model.device)
    l_card = torch.as_tensor(lens, device=model.device)
    mask = torch.arange(tok.shape[1])[None, :] < torch.as_tensor(lens)[:,
                                                                     None]
    with torch.no_grad():
        pairs = [("bilm", model.lm.encode(t_card, l_card),
                  lm_cpu.encode(torch.as_tensor(tok), torch.as_tensor(lens)))]
        h = model._lm_apply(t_card, l_card)
        for name, card, cpu in (
                ("rnn_head", model.aligner.match_embedding,
                 al_cpu.match_embedding),
                ("rnn_head", model.aligner.gap_embedding,
                 al_cpu.gap_embedding)):
            pairs.append((name, card(h, l_card),
                          cpu(h.cpu(), torch.as_tensor(lens))))
    for name, card, cpu in pairs:
        card, cpu = card.cpu()[mask], cpu[mask]
        err = (card - cpu).abs().max().item()
        scale = cpu.abs().max().item()
        errs[f"{name}_cpu"] = max(errs.get(f"{name}_cpu", 0.0), err / scale)
        if not torch.isfinite(card).all() or err > 1e-4 * scale:
            raise AssertionError(f"{name}: card vs CPU max abs diff {err} "
                                 f"at scale {scale}")


def step_shares(model, batch, reps=3):
    """CUDA-event ms (after a warm-up, ``reps`` each) of one training step
    on ``batch``, of its BiLM forward (the frozen LM: no backward) and of
    its RNN heads' forward + backward (match and gap, both sides, dropout
    on); the step updates the model's weights."""
    b = model._loss_batch(batch)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(0)
    step = cuda_ms(lambda: model._step(b, gen), reps)
    lm = cuda_ms(lambda: model._embeddings(b, train=True), reps)
    hx, hy = model._embeddings(b)
    al = model.aligner

    def heads():
        outs = [head(h, n, gen) for head in (al.match_embedding,
                                             al.gap_embedding)
                for h, n in ((hx, b["x_len"]), (hy, b["y_len"]))]
        torch.autograd.backward([o.sum() for o in outs])

    al.train()
    heads_ms = cuda_ms(heads, reps)
    model._opt.zero_grad(set_to_none=True)
    return dict(shape=tuple(b["x"].shape) + (b["y"].shape[1],),
                step_ms=round(step, 4), bilm_ms=round(lm, 4),
                rnn_heads_ms=round(heads_ms, 4),
                bilm_share=round(lm / step, 4),
                rnn_heads_share=round(heads_ms / step, 4))


def phase_bilm(seed, card):
    """(a) ``cli.train --lm-type bilstm --layer-type rnn`` at the
    ``deepblast-train`` defaults -> ``load_model`` -> ``align``,
    ``score_pairs``, the search CLI, and again at ``--steps-per-dispatch
    4``; (b) a Bepler-geometry BiLM artifact through ``cli.convert_lm`` and
    ``cli.train --pretrain-path`` -> ``align``; (c) a ProtT5-XL-width
    artifact (2 blocks), float32 and bf16, -> ``cli.train
    --pretrain-path``.  Then the default kernels = plain at a training
    batch's potentials (0.0), the BiLM and the RNN heads card = CPU, and
    a step's shares.  Returns the runs' launches and the errors."""
    from deepblast_torch.cli import convert_lm, search
    from deepblast_torch.data.alphabet import (ProtT5Tokenizer,
                                               UniprotPairTokenizer)
    from deepblast_torch.data.state_utils import pad_sequences
    from deepblast_torch.models.convert import (bilm_key_shapes,
                                                hf_t5_encoder_key_shapes,
                                                load_converted_lm)
    from deepblast_torch.models.heads import StackedRNN
    from deepblast_torch.models.lm import (BiLM, T5Config, T5Encoder,
                                           load_prot_t5)
    from deepblast_torch.ops import dp_cuda
    from deepblast_torch.train.checkpoint import load_model
    from deepblast_torch.train.trainer import DeepBLAST

    S = BILM_SIZES
    rng = np.random.default_rng(seed + 6)
    g = torch.Generator().manual_seed(seed + 6)
    errs, launches = {}, dict.fromkeys(dp_cuda.LAUNCHES, 0)
    widths = ["--embedding-dim", str(S["embedding"]), "--hidden-dim",
              str(S["hidden"])]

    def driven(fn, *args):
        """``fn(*args)`` with the counters zeroed just before and added to
        ``launches`` just after."""
        dp_cuda.reset_launches()
        out = fn(*args)
        torch.cuda.synchronize()
        for k, v in dp_cuda.LAUNCHES.items():
            launches[k] += v
        return out

    def train(tmp, name, rows, valid, *flags):
        paths = [os.path.join(tmp, f"{name}_{n}.tsv")
                 for n in ("train", "valid")]
        _write_tsv(paths[0], rows)
        _write_tsv(paths[1], valid)
        run = driven(run_cli_train, [
            "--train-pairs", paths[0], "--valid-pairs", paths[1], "-o",
            os.path.join(tmp, name), "--batch-size", "16", "--epochs", "1",
            "--seed", str(seed), *flags])
        losses = [m["value"] for m in run["metrics"]
                  if m["tag"] in ("train_loss", "validation_loss")]
        if not losses or not all(np.isfinite(v) for v in losses):
            raise AssertionError(f"{name}: losses {losses}")
        run["train_path"] = paths[0]
        return run

    def convert(*argv):
        """``cli.convert_lm`` with its printed manifest read back."""
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            convert_lm.main(list(argv))
        return json.loads(out.getvalue())

    def consumed(pairs, states):
        for (x, y), s in zip(pairs, states):
            if s.count("1") + s.count(":") != len(x) or \
                    s.count("2") + s.count(":") != len(y):
                raise AssertionError("align: states do not consume both "
                                     "strings")

    with tempfile.TemporaryDirectory() as tmp:
        # (a) BiLM + RNN heads through the CLI, then served
        rows = [homolog_row(rng, f"b{j}_{i}", lo, hi)
                for j, (n, lo, hi) in enumerate(S["rows"]) for i in range(n)]
        n, lo, hi = S["valid"]
        valid = [homolog_row(rng, f"v{i}", lo, hi) for i in range(n)]
        run_a = train(tmp, "a", rows, valid, "--lm-type", "bilstm",
                      "--layer-type", "rnn", *widths)
        model = run_a["model"]
        dev = model.device
        if not (isinstance(model.lm, BiLM) and
                model.lm.hidden_dim == S["embedding"] // 4 and
                isinstance(model.aligner.match_embedding, StackedRNN)):
            raise AssertionError("cli.train did not build the BiLM and the "
                                 "RNN heads")
        if any(m.bias_ih_l0.abs().max().item() != 0.0
               for m in lstms(model.lm, model.aligner)):
            raise AssertionError("training moved torch's second LSTM bias")
        longest = max(model._batches(model._dataset(run_a["train_path"]),
                                     True, seed),
                      key=lambda bt: bt["x"].shape[1])
        del model
        t0 = time.time()
        served = driven(load_model, os.path.join(tmp, "a"))
        pairs = [rows[0][5:7], rows[-1][5:7]]
        states = driven(lambda: [served.align(x, y) for x, y in pairs])
        t_align = time.time() - t0
        consumed(pairs, states)
        xt, xl = pad_sequences([served.tokenizer(r[5])[0] for r in valid])
        yt, yl = pad_sequences([served.tokenizer(r[6])[0] for r in valid])
        t0 = time.time()
        scores = driven(served.score_pairs, dict(x=xt, y=yt, x_len=xl,
                                                 y_len=yl))
        t_score = time.time() - t0
        if scores.shape != (len(valid),) or not torch.isfinite(scores).all():
            raise AssertionError("score_pairs: non-finite or misshapen")
        qf, dbf = os.path.join(tmp, "q.fa"), os.path.join(tmp, "db.fa")
        _write_fasta(qf, [r[5] for r in valid[:4]], "q")
        _write_fasta(dbf, [r[6] for r in valid[:4]], "d")
        hits = os.path.join(tmp, "hits")
        driven(search.main, ["--query-fasta", qf, "--db-fasta", dbf,
                             "--load-from-checkpoint", os.path.join(tmp, "a"),
                             "--output-file", hits, "--batch-size", "16"])
        with open(hits) as f:
            if len(f.readlines()) != 16:
                raise AssertionError("search: expected 16 rows")
        del served
        torch.cuda.empty_cache()

        # (a) at --steps-per-dispatch 4: one chunk of one batch shape
        n, lo, hi = S["uniform"]
        uniform = uniform_rows(rng, n, lo, hi, "u")
        with count_waits() as waits:
            run_d = train(tmp, "d", uniform, valid, "--lm-type", "bilstm",
                          "--layer-type", "rnn", "--steps-per-dispatch", "4",
                          *widths)
        if waits["chunks"] != 1 or waits["steps"] != 4 or \
                waits["syncs"] != 0 or waits["readbacks"] != 1:
            raise AssertionError(f"steps_per_dispatch 4: {waits}")

        # (a) finetuning the BiLM (cuDNN's LSTM backward) at
        # --steps-per-dispatch 4: one chunk of batch 8
        with count_waits() as waits_e:
            run_e = train(tmp, "e", uniform[:32], valid[:4], "--lm-type",
                          "bilstm", "--layer-type", "rnn", "--finetune",
                          "True", "--steps-per-dispatch", "4", *widths,
                          "--batch-size", "8")
        if waits_e["chunks"] != 1 or waits_e["steps"] != 4 or \
                waits_e["syncs"] != 0 or waits_e["readbacks"] != 1:
            raise AssertionError(f"finetune, steps_per_dispatch 4: {waits_e}")
        me = run_e["model"]
        init = DeepBLAST(me.config).init().lm.state_dict()
        tuned = sum(not torch.equal(v, init[k])
                    for k, v in me.lm.state_dict().items())
        if not me.config.finetune or not tuned or any(
                m.bias_ih_l0.abs().max().item() != 0.0 for m in lstms(me.lm)):
            raise AssertionError(f"--finetune True: {tuned} of the BiLM's "
                                 f"tensors changed, or its second LSTM "
                                 f"bias moved")
        seconds_e, peak_e = run_e["seconds"], run_e["peak"]
        del me, run_e, init
        torch.cuda.empty_cache()

        # (b) a Bepler-geometry BiLM artifact
        bepler = os.path.join(tmp, "lstm2x.pt")
        torch.save(seeded_state_dict(bilm_key_shapes(**S["bepler"]), g),
                   bepler)
        art_b = os.path.join(tmp, "bilm_artifact")
        if convert(bepler, "--output", art_b, "--kind", "bilstm")[
                "config"] != S["bepler"]:
            raise AssertionError("convert_lm: the BiLM artifact's geometry")
        n, lo, hi = S["artifact_rows"]
        rows_b = [homolog_row(rng, f"p{i}", lo, hi) for i in range(n)]
        run_b = train(tmp, "b", rows_b, valid[:4], "--pretrain-path", art_b,
                      "--hidden-dim", str(S["hidden"]))
        mb = run_b["model"]
        width = 4 * S["bepler"]["hidden_dim"] + S["bepler"]["nin"]
        if not isinstance(mb.tokenizer, UniprotPairTokenizer) or \
                mb.aligner.match_embedding.embed.in_features != width:
            raise AssertionError("the BiLM artifact did not set the "
                                 "tokenizer and the heads' width")
        pairs_b = [r[5:7] for r in rows_b[:2]]
        consumed(pairs_b, driven(lambda: [mb.align(x, y)
                                          for x, y in pairs_b]))
        del mb, run_b
        torch.cuda.empty_cache()

        # (c) a ProtT5-XL-width artifact, float32 and bf16
        t5 = dataclasses.replace(T5Config.prot_t5_xl(),
                                 num_layers=S["t5_blocks"])
        hf = os.path.join(tmp, "hf")
        os.makedirs(hf)
        torch.save(seeded_state_dict(hf_t5_encoder_key_shapes(t5), g),
                   os.path.join(hf, "pytorch_model.bin"))
        arts = {d: os.path.join(tmp, f"t5_{d}") for d in ("float32",
                                                           "bfloat16")}
        t0 = time.time()
        for d, art in arts.items():
            if convert(hf, "--output", art, "--dtype", d)[
                    "storage_dtype"] != d:
                raise AssertionError(f"convert_lm --dtype {d}")
        t_convert = time.time() - t0
        direct, sd = load_prot_t5(hf)
        encoders = [direct.to(dev)]
        direct.load_state_dict(sd)
        for art in arts.values():
            enc, sd = load_converted_lm(art, device=dev)
            enc.load_state_dict(sd)
            encoders.append(enc)
        if not all(isinstance(e, T5Encoder) and e.cfg == t5
                   for e in encoders):
            raise AssertionError("the ProtT5 artifacts' geometry")
        seqs = [r[5][:256] for r in rows_b[:4]]
        tok, lens = pad_sequences([ProtT5Tokenizer()(s)[0] for s in seqs])
        tok = torch.as_tensor(tok, device=dev)
        mask = torch.arange(tok.shape[1], device=dev)[None, :] < \
            torch.as_tensor(lens, device=dev)[:, None]
        with torch.no_grad():
            feats = [e(tok, mask) for e in encoders]
        if not torch.equal(feats[1], feats[0]):
            raise AssertionError("the float32 artifact's features differ "
                                 "from the state dict's")
        t5_bf16 = ((feats[2] - feats[0]).abs().max() /
                   feats[0].abs().max()).item()
        del encoders, feats, direct, sd, enc
        torch.cuda.empty_cache()
        run_c = train(tmp, "c", rows_b, valid[:4], "--pretrain-path",
                      arts["float32"])
        n_c = sum(m["tag"] == "train_loss" for m in run_c["metrics"])
        if n_c != 2 or run_c["model"].lm.cfg != t5:
            raise AssertionError(f"ProtT5 artifact run: {n_c} steps")
        seconds_c, peak_c = run_c["seconds"], run_c["peak"]
        del run_c
        torch.cuda.empty_cache()

        # the kernels at the path's potentials, the recurrent modules card
        # vs CPU, a step's shares
        model = run_d["model"]
        batch = next(model._batches(model._dataset(run_d["train_path"]),
                                    True, seed))
        with torch.no_grad():
            b = model._as_batch(batch)
            hx, hy = model._embeddings(b)
            lengths = (b["x_len"].to(torch.int32), b["y_len"].to(torch.int32))
            theta, A = model.aligner.potentials(hx, hy, lengths)
            check_kernels(theta, A, *lengths, "nw", "softmax", errs)
            check_menu_kernels(theta, A, *lengths, "nw", "softmax",
                               model.dp_dtypes, errs)
        if any(v != 0.0 for v in errs.values()):
            raise AssertionError(f"kernels differ from plain: {errs}")
        checked = tuple(theta.shape)
        del hx, hy, theta, A
        n, lo, hi = S["cpu_batch"]
        check_recurrent(model, [protein(rng, lo, hi) for _ in range(n)],
                        errs)
        shares = [step_shares(model, bt) for bt in (batch, longest)]
        seconds_d, peak_d = run_d["seconds"], run_d["peak"]
        del model, run_d
        torch.cuda.empty_cache()

    log(f"phase bilm: (a) cli.train --lm-type bilstm --layer-type rnn "
        f"(BiLM hidden {S['embedding'] // 4}, RNN heads {S['hidden']}), "
        f"{len(rows)} train / {len(valid)} valid pairs, batch 16, 1 epoch: "
        f"{run_a['seconds']:.2f} s; seconds between train_loss records "
        f"{[round(t, 4) for t in step_intervals(run_a['metrics'])]}; peak "
        f"device memory {run_a['peak'] / 2**30:.2f} GiB; load_model + align "
        f"x2 {t_align:.2f} s, score_pairs {len(valid)} pairs "
        f"{t_score:.4f} s; --steps-per-dispatch 4: {waits['steps']} steps "
        f"in {waits['chunks']} chunk, {waits['syncs']} synchronizing "
        f"operations, {seconds_d:.2f} s, peak {peak_d / 2**30:.2f} GiB; "
        f"--finetune True --steps-per-dispatch 4, batch 8: "
        f"{waits_e['steps']} steps in {waits_e['chunks']} chunk, "
        f"{waits_e['syncs']} synchronizing operations, {tuned} of the "
        f"BiLM's tensors changed, {seconds_e:.2f} s, peak "
        f"{peak_e / 2**30:.2f} GiB [{card}]")
    log(f"phase bilm: (b) Bepler-geometry artifact -> cli.train "
        f"--pretrain-path (Uniprot21 ids, heads of {width} inputs), "
        f"{len(rows_b)} pairs, align x2 ok; (c) ProtT5-XL width x "
        f"{S['t5_blocks']} blocks: convert_lm float32 + bf16 {t_convert:.2f}"
        f" s, float32 artifact's features = the state dict's exactly, bf16 "
        f"artifact's {t5_bf16:.3e} of scale; cli.train --pretrain-path 2 "
        f"steps {seconds_c:.2f} s, peak {peak_c / 2**30:.2f} GiB [{card}]")
    log(f"phase bilm: kernels = plain at a training batch {checked}, card "
        f"= CPU (BiLM, RNN heads; of scale); max abs diff "
        f"{json.dumps(errs)}; step shares by CUDA events "
        f"{json.dumps(shares)} [{card}]; launches {json.dumps(launches)}")
    return launches, errs


# ---------------------------------------------------------------------------
# the worker: checks that need no model, beside phases 2-4b
# ---------------------------------------------------------------------------

def phase_worker(seed):
    """The kernel checks that need no model, on the same card in a second
    process (:class:`Worker`) while phases kernels to options run: their
    plain passes walk one diagonal a step in a few hundred small launches,
    so the host, not the card, sets their time.  (1) ``check_edges``;
    (2) each Q kernel against its plain version at (16, 200, 150), nw and
    sw x softmax / sparsemax / hardmax, with float32 and with bf16 Q
    streams, and autograd through them (``pallas_long``; the CPU on the 4
    largest pairs); (3) the four split Q kernels at every forced cluster
    size at ``SPLIT_EDGE_SLOTS`` (the bf16 instances at
    ``BF16_CLUSTERS``).  Returns the errors."""
    from deepblast_torch.ops import dp_cuda
    errs = {}
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 7)
    t0 = time.time()
    check_edges(g, errs)
    torch.cuda.synchronize()
    log("phase worker: skew, skew_pair, unskew, forward, score-only "
        "forward, adjoint forward, backward and adjoint backward "
        "bit-identical to plain at the strip "
        f"edges {EDGE_SHAPES} in float32 (every storage menu up to 301 "
        "slots); the "
        "backward and the adjoint backward refuse S = 20,480 and the "
        "adjoint forward S = 20,481, naming their "
        f"limit; {time.time() - t0:.1f} s; max abs diff {json.dumps(errs)}")
    g.manual_seed(seed + 2)
    for mode in ("nw", "sw"):
        for op in OPERATORS:
            theta, A, ln, lm = dp_problem(g, 16, 200, 150)
            check_q_kernels(theta, A, ln, lm, mode, op, errs)
            check_q_kernels(theta, A, ln, lm, mode, op, errs,
                            q_dtype=torch.bfloat16)
            check_autograd(theta, A, ln, lm, mode, op, errs,
                           backend="pallas_long", cpu_pairs=4)
    torch.cuda.synchronize()
    log("phase worker: Q kernels, float32 and bf16 Q instances, = plain at "
        "(16, 200, 150) nw/sw x softmax/sparsemax/hardmax, tracebacks "
        "identical; autograd through them = plain and = CPU; max abs diff "
        f"{json.dumps(errs)}; {split_line()}")
    t0 = time.time()
    check_split_edges(g, errs, torch.bfloat16, BF16_CLUSTERS)
    check_split_edges(g, errs)
    torch.cuda.synchronize()
    log(f"phase worker: the four split Q kernels bit for bit = plain at "
        f"every cluster size {dp_cuda.Q_CLUSTERS} (forced; the bf16 Q "
        f"instances at {BF16_CLUSTERS}) at S = {SPLIT_EDGE_SLOTS} "
        f"({time.time() - t0:.1f} s)")
    return errs


def worker_main(out_path):
    """The worker's process: :func:`phase_worker` on the library the
    parent built, its errors and check seconds written to ``out_path``."""
    from deepblast_torch import native
    from deepblast_torch.ops import dp_cuda
    PHASE[0] = "worker"
    torch.set_num_threads(4)        # the parent's CPU checks run beside it
    dp_cuda.build()
    native.build()
    errs = phase_worker(0)
    with open(out_path, "w") as f:
        json.dump(dict(errs=errs, seconds=CHECK_SECONDS), f)
    return 0


class Worker:
    """:func:`worker_main` in a child process, started on entry; ``join``
    waits for it (at most ``timeout`` seconds), relays its output and
    returns its errors and check seconds, and raises if it failed.  On
    exit a worker still running is killed and reaped."""

    def __init__(self, tmp, timeout=900):
        self.tmp, self.timeout = tmp, timeout

    def __enter__(self):
        self.out = os.path.join(self.tmp, "worker.json")
        self.log = open(os.path.join(self.tmp, "worker.log"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             self.out], stdout=self.log, stderr=subprocess.STDOUT)
        return self

    def join(self):
        try:
            rc = self.proc.wait(timeout=self.timeout)
        finally:
            self.log.seek(0)
            for line in self.log.read().splitlines():
                log(line)
        if rc != 0:
            raise AssertionError(f"the worker exited with {rc}")
        with open(self.out) as f:
            return json.load(f)

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.log.close()


# ---------------------------------------------------------------------------
# phase 5: the long-sequence backend
# ---------------------------------------------------------------------------

def phase_long(seed, card):
    from deepblast_torch.cli import train as cli_train
    from deepblast_torch.data.state_utils import pad_sequences
    from deepblast_torch.ops import dp as dp_ops
    from deepblast_torch.ops import dp_cuda
    from deepblast_torch.train.checkpoint import load_model

    errs = {}
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 2)
    t0 = time.time()
    split_bf16, _ = check_split_limit(g, errs, torch.bfloat16)
    torch.cuda.synchronize()
    log(f"phase long: the bf16 Q instances of the four split kernels bit "
        f"for bit = plain at S = {dp_cuda.CLUSTER_SLOTS['forward_q']} "
        f"({split_line(split_bf16)}) ({time.time() - t0:.1f} s)")
    t0 = time.time()
    split, refusals = check_split_limit(g, errs)
    torch.cuda.synchronize()
    log(f"phase long: the four split Q kernels (forward_q, backward_q with "
        f"and without EA, adjoint_forward_q with and without Za, "
        f"adjoint_backward_q) bit for bit = plain at their limit S = "
        f"{dp_cuda.CLUSTER_SLOTS['forward_q']} ({split_line(split)}); one "
        f"slot further each refuses: {refusals[1]} "
        f"({time.time() - t0:.1f} s)")
    past = long_step_past(g, errs)
    log(f"phase long: a pallas_long training step past the first Q "
        f"backward's and adjoint forward's limit (S = 19,370): {past}")

    rng = np.random.default_rng(seed + 2)
    rows = [homolog_row(rng, f"s{i}", 1000, 1500, LONG_LEN) for i in range(2)]
    rows += [homolog_row(rng, f"m{i}", 2000, 2800, LONG_LEN)
             for i in range(2)]
    rows += [homolog_row(rng, f"l{i}", 3600, 3900, LONG_LEN)
             for i in range(2)]
    valid = [homolog_row(rng, f"v{i}", 1000, 1200, LONG_LEN)
             for i in range(2)]
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, n) for n in ("train.tsv", "valid.tsv")]
        _write_tsv(paths[0], rows)
        _write_tsv(paths[1], valid)
        out = os.path.join(tmp, "out")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        dp_cuda.reset_launches()
        t0 = time.time()
        rc = cli_train.main([
            "--train-pairs", paths[0], "--valid-pairs", paths[1],
            "-o", out, "--lm-type", "prot_t5", "--batch-size", "2",
            "--epochs", "1", "--max-len", str(LONG_LEN),
            "--backend", "pallas_long", "--seed", str(seed)])
        torch.cuda.synchronize()
        t_train = time.time() - t0
        peak_train = torch.cuda.max_memory_allocated()
        if rc != 0:
            raise AssertionError(f"cli.train returned {rc}")
        metrics = read_metrics(out)
        losses = [(m["tag"], m["value"]) for m in metrics
                  if m["tag"] in ("train_loss", "validation_loss")]

        # serving from the checkpoint: the longest pair, then a batch
        model = load_model(out)
        if model.config.backend != "pallas_long":
            raise AssertionError("config.json lost the backend")
        x, y = max((r[5:7] for r in rows), key=lambda p: len(p[0]))
        t0 = time.time()
        state = model.align(x, y)
        t_align = time.time() - t0
        tok = model.tokenizer
        xt, xl = pad_sequences([tok(r[5])[0] for r in rows[-2:]])
        yt, yl = pad_sequences([tok(r[6])[0] for r in rows[-2:]])
        t0 = time.time()
        scores = model.score_pairs(dict(x=xt, y=yt, x_len=xl, y_len=yl))
        torch.cuda.synchronize()
        t_score = time.time() - t0

        # the "pallas" name: the same Q kernels behind the same skew and
        # unskew kernels (TPU rows 19-20), at the longest batch
        batches = list(model._batches(model._dataset(paths[0]), True, seed))
        mode, operator = model.aligner.mode, model.config.operator
        batch = max(batches, key=lambda b: b["x"].shape[1])
        with torch.no_grad():
            b = model._as_batch(batch)
            hx, hy = model._embeddings(b)
            lengths = (b["x_len"].to(torch.int32), b["y_len"].to(torch.int32))
            theta, A = model.aligner.potentials(hx, hy, lengths)
        before = dict(dp_cuda.LAUNCHES)
        t = theta.clone().requires_grad_()
        E = dp_ops.expected_alignment(t, A, lengths, backend="pallas")
        (E * E).sum().backward()
        torch.cuda.synchronize()
        if not (torch.isfinite(E).all() and torch.isfinite(t.grad).all()):
            raise AssertionError('backend="pallas": non-finite output')
        pallas = {k: v - before[k] for k, v in dp_cuda.LAUNCHES.items()}
        launches = dict(dp_cuda.LAUNCHES)
        del model, hx, hy, t, E

    if any(launches[k] == 0 for k in ("skew", "unskew") + Q_KERNELS) or \
            pallas["skew"] == 0 or pallas["unskew"] == 0:
        raise AssertionError(f"a kernel did not run on the long path: "
                             f"{launches}, pallas call {pallas}")
    if any(launches[k] for k in ("forward", "backward", "adjoint_forward",
                                 "adjoint_backward", "forward_score")):
        raise AssertionError(f"the long path ran a default kernel: "
                             f"{launches}")
    # the default backend's reverse passes hold this batch in their strips
    S = theta.shape[1] + 1
    if S > dp_cuda.MAX_SLOTS["adjoint_backward"]:
        raise AssertionError(f"the longest batch pads to S = {S} slots, past "
                             "the default kernels' strips")
    if len(losses) != len(batches) + 1 or \
            not all(np.isfinite(v) for _, v in losses):
        raise AssertionError(f"training losses {losses}")
    if state.count("1") + state.count(":") != len(x) or \
            state.count("2") + state.count(":") != len(y):
        raise AssertionError("align: states do not consume both strings")
    if scores.shape != (2,) or not torch.isfinite(scores).all():
        raise AssertionError("score_pairs: non-finite or misshapen scores")
    shapes = [tuple(bt["x"].shape) + (bt["y"].shape[1],) for bt in batches]
    log(f"phase long: cli.train --backend pallas_long --max-len {LONG_LEN} "
        f"ProtT5-XL + CNN-1024, {len(rows)} train / {len(valid)} valid "
        f"pairs, batch 2, 1 epoch: {t_train:.2f} s; batches (B, Lx, Ly) "
        f"{shapes}; seconds between train_loss records "
        f"{[round(v, 4) for v in step_intervals(metrics)]}; peak device "
        f"memory {peak_train / 2**30:.2f} GiB; losses {losses}; align "
        f"({len(x)}, {len(y)}) {t_align:.2f} s; score_pairs "
        f"{tuple(xt.shape)} x {yt.shape[1]} {t_score:.2f} s [{card}]; "
        f"launches {json.dumps(launches)}; of which the pallas call "
        f"{json.dumps(pallas)}; last launches {split_line()}")

    default = default_vs_long(theta, A, lengths, seed, errs)
    refusal = refusal_past_strips()
    torch.cuda.empty_cache()
    check_q_kernels(theta, A, *lengths, "nw", "softmax", errs)
    check_autograd(theta, A, *lengths, "nw", "softmax", errs,
                   backend="pallas_long", cpu_second_order=False,
                   cpu_pairs=1)
    torch.cuda.synchronize()
    log(f"phase long: the default backend trains {tuple(theta.shape)} (S = "
        f"{S}): {default}; at S = "
        f"{dp_cuda.MAX_SLOTS['adjoint_backward'] + 1} it refuses: {refusal}")
    log(f"phase long: Q kernels = plain and autograd = plain and CPU at the "
        f"longest training batch {tuple(theta.shape)}; max abs diff "
        f"{json.dumps(errs)}")
    del theta, A
    torch.cuda.empty_cache()
    return launches, errs


def split_line(splits=None):
    """Each split Q kernel's last launch (``dp_cuda.SPLITS``): pairs,
    slots, cluster size, threads a CTA, CTAs (the SMs busy at one CTA an
    SM) and the clusters of that size the device holds at once."""
    from deepblast_torch.ops import dp_cuda
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for k, v in (splits or dp_cuda.SPLITS).items():
        if v:
            ctas = v["B"] * v["C"]
            out.append(f"{k} B={v['B']} S={v['S']}: C={v['C']}, "
                       f"{v['threads']} threads, {ctas} CTAs ("
                       f"{min(ctas, sms)} of {sms} SMs at one CTA an SM), "
                       f"{v['clusters']} clusters at once")
    return "; ".join(out)


@timed_check
def long_step_past(g, errs):
    """One ``pallas_long`` training step (``expected_alignment`` and the
    gradient of <E, Z> for a random Z) on a pair of 19,800 x 40 (S =
    19,801, past the 19,370 slots the first Q backward and Q adjoint
    forward held in shared memory) through the kernels, against the same
    step through the plain passes on the card: E and both gradients bit
    for bit."""
    from deepblast_torch.ops import dp as dp_ops
    from deepblast_torch.ops import dp_cuda, dp_ref
    N, M = 19800, 40
    theta, A, _, _ = dp_problem(g, 1, N, M, ragged=False)
    Z = torch.randn(theta.shape, generator=g, device="cuda")
    lens = (torch.tensor([N], dtype=torch.int32, device="cuda"),
            torch.tensor([M], dtype=torch.int32, device="cuda"))

    def step():
        t = theta.clone().requires_grad_()
        a = A.clone().requires_grad_()
        E = dp_ops.expected_alignment(t, a, lens, backend="pallas_long")
        (E * Z).sum().backward()
        return E.detach(), t.grad, a.grad

    t0 = time.time()
    before = dict(dp_cuda.LAUNCHES)
    kern = step()
    torch.cuda.synchronize()
    t_kern = time.time() - t0
    ran = {k: dp_cuda.LAUNCHES[k] - before[k] for k in Q_KERNELS}
    line = split_line()
    passes = dp_ops._passes
    dp_ops._passes = lambda t: dp_ref
    try:
        plain = step()
    finally:
        dp_ops._passes = passes
    for name, a, b in zip(("E", "dtheta", "dA"), kern, plain):
        _exact("pallas_long_step", a, b, errs)
    if any(v == 0 for v in ran.values()):
        raise AssertionError(f"the step past S = 19,370 skipped a Q kernel: "
                             f"{ran}")
    return (f"(1, {N}, {M}) E, dtheta, dA = the plain passes' bit for bit, "
            f"{t_kern:.2f} s; Q launches {json.dumps(ran)}; {line}")


@timed_check
def default_vs_long(theta, A, lengths, seed, errs):
    """The default backend's training step at the long batch against
    ``pallas_long``'s on the same inputs: ``expected_alignment`` and the
    gradient of ``<E, Z>`` for a random Z, float32 storage in both, and a
    float64 run of the plain passes on the card as the reference.  Two
    float32 formulations of the DP part by 1e-3 to 1e-2 of scale at this
    length (PERF.md), more than the autograd checks' 1e-4, so each output
    is held to the reference: the default's distance to it at most twice
    ``pallas_long``'s, plus ATOL + RTOL of scale; the distances and the
    default-vs-``pallas_long`` difference (of scale) are reported.  Then
    the trainer's bf16 residuals: finite, the deviation reported."""
    from deepblast_torch.ops import dp as dp_ops
    from deepblast_torch.ops import dp_ref
    from deepblast_torch.ops.menu import DTypeMenu
    g = torch.Generator(device=theta.device)
    g.manual_seed(seed + 5)
    Z = torch.randn(theta.shape, generator=g, device=theta.device)

    def step(dtype=torch.float32, **kw):
        t = theta.detach().to(dtype).requires_grad_()
        a = A.detach().to(dtype).requires_grad_()
        E = dp_ops.expected_alignment(t, a, lengths, **kw)
        (E * Z.to(dtype)).sum().backward()
        return [x.detach().double() for x in (E, t.grad, a.grad)]

    passes = dp_ops._passes
    dp_ops._passes = lambda t: dp_ref
    try:
        ref = step(torch.float64)
    finally:
        dp_ops._passes = passes
    runs = {"pallas_long": step(backend="pallas_long"), "default": step(),
            "default_bf16": step(dtypes=DTypeMenu.make(d="bfloat16"))}
    out = {}
    for i, name in enumerate(("E", "dtheta", "dA")):
        scale = ref[i].abs().max().item()
        dist = {k: (v[i] - ref[i]).abs().max().item() / scale
                for k, v in runs.items()}
        diff = (runs["default"][i] - runs["pallas_long"][i]).abs().max(
            ).item() / scale
        for k, v in (("default_vs_float64", dist["default"]),
                     ("pallas_long_vs_float64", dist["pallas_long"]),
                     ("default_bf16_vs_float64", dist["default_bf16"]),
                     ("default_vs_pallas_long", diff)):
            errs[k] = max(errs.get(k, 0.0), v)
        out[name] = dict(scale=scale, default_vs_pallas_long=diff,
                         **{f"{k}_vs_float64": v for k, v in dist.items()})
        if not all(torch.isfinite(v[i]).all() for v in runs.values()) or \
                dist["default"] > 2 * dist["pallas_long"] + RTOL + \
                ATOL / scale:
            raise AssertionError(f"default backend {name}: {out[name]}")
    return json.dumps(out)


def refusal_past_strips():
    """One slot past the reverse passes' strips the default backend refuses
    to train, and the adjoint backward refuses on its own, each naming
    its limit and ``pallas_long``."""
    from deepblast_torch.ops import dp as dp_ops
    from deepblast_torch.ops import dp_cuda
    most = dp_cuda.MAX_SLOTS["adjoint_backward"]
    x = torch.zeros((1, most, 2), device="cuda")
    n = torch.tensor([most], dtype=torch.int32, device="cuda")
    m = torch.tensor([2], dtype=torch.int32, device="cuda")
    t = x.clone().requires_grad_()
    try:
        dp_ops.expected_alignment(t, x, (n, m)).sum().backward()
    except ValueError as e:
        msg = str(e)
    else:
        raise AssertionError(f"the default backend trained S = {most + 1}")
    s = dp_cuda.skew(x)
    msg2 = _refuses("adjoint_backward", lambda: dp_cuda.adjoint_backward(
        s, s, s, s, s, n, m))
    for e in (msg, msg2):
        if f"S = {most + 1} " not in e or f"S <= {most} " not in e or \
                'backend="pallas_long"' not in e:
            raise AssertionError(f"unclear refusal: {e}")
    return msg2


def long_times(seed, card):
    """Each Q kernel and the ``pallas_long`` expected alignment at 8 x
    4096 x 4096, nw, softmax, fp32 (CUDA events, 3 launches after one
    warm-up), and the peak device memory of the decode.  Then the bf16 Q
    instances (``ops.dp.Q_DTYPE`` bf16) at the same shape: each kernel,
    and the decode and the DP step (``expected_alignment`` + the gradient
    of ``<E, Z>``) in turns with float32 Q, the largest E and gradient
    differences from the float32 run, and the bf16 instances' launches in
    one DP step, counters zeroed just before, and their splits in that
    step (the kernels line's ``launches`` and ``split`` of the bf16
    instances).  Returns ``(times, launches, splits)``."""
    from deepblast_torch.ops import dp as dp_ops
    from deepblast_torch.ops import dp_cuda
    B, N = 8, LONG_LEN
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 3)
    theta, A, ln, lm = dp_problem(g, B, N, N, ragged=False)
    kw = dict(mode="nw", operator="softmax")
    Et = torch.ones((B,), device="cuda")
    th_s, A_s = dp_cuda.skew(theta), dp_cuda.skew(A)
    _, *qs = dp_cuda.forward_q(th_s, A_s, ln, lm, **kw)
    E, _ = dp_cuda.backward_q(*qs, ln, lm, Et, mode="nw")
    zt = dp_cuda.skew(torch.randn((B, N, N), generator=g, device="cuda"))
    _, *qds = dp_cuda.adjoint_forward_q(*qs, zt, None, ln, lm, **kw)
    kern = {
        "forward_q": lambda: dp_cuda.forward_q(th_s, A_s, ln, lm, **kw),
        "backward_q": lambda: dp_cuda.backward_q(*qs, ln, lm, Et, mode="nw"),
        "backward_q_gap": lambda: dp_cuda.backward_q(
            *qs, ln, lm, Et, mode="nw", want_gap=True),
        "adjoint_forward_q": lambda: dp_cuda.adjoint_forward_q(
            *qs, zt, None, ln, lm, **kw),
        "adjoint_backward_q": lambda: dp_cuda.adjoint_backward_q(
            *qs, *qds, E, ln, lm, mode="nw"),
    }
    ms = {k: cuda_ms(fn, 3) for k, fn in kern.items()}
    bf16 = torch.bfloat16
    _, *qb = dp_cuda.forward_q(th_s, A_s, ln, lm, q_dtype=bf16, **kw)
    del qs
    kern = {
        "forward_q_bf16": lambda: dp_cuda.forward_q(th_s, A_s, ln, lm,
                                                    q_dtype=bf16, **kw),
        "backward_q_bf16": lambda: dp_cuda.backward_q(*qb, ln, lm, Et,
                                                      mode="nw"),
        "adjoint_forward_q_bf16": lambda: dp_cuda.adjoint_forward_q(
            *qb, zt, None, ln, lm, **kw),
        "adjoint_backward_q_bf16": lambda: dp_cuda.adjoint_backward_q(
            *qb, *qds, E, ln, lm, mode="nw"),
    }
    ms.update({k: cuda_ms(fn, 3) for k, fn in kern.items()})
    del th_s, A_s, qb, E, zt, qds, kern
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        E = dp_ops.expected_alignment(theta, A, (ln, lm),
                                      backend="pallas_long", **kw)
        if E.shape != (B, N, N) or not torch.isfinite(E).all():
            raise AssertionError("len-4096 expected alignment: non-finite "
                                 "or misshapen")
        del E
        decode_ms = cuda_ms(lambda: dp_ops.expected_alignment(
            theta, A, (ln, lm), backend="pallas_long", **kw), 3)
    peak = torch.cuda.max_memory_allocated()
    for k, v in ms.items():
        log(f"phase long: {k} at ({B}, {N}, {N}) {v:.4f} ms [{card}]")
    log(f"phase long: at ({B}, {N}, {N}) {split_line()}")
    log(f"phase long: expected_alignment pallas_long at ({B}, {N}, {N}) nw "
        f"softmax fp32 (skew x2 + forward_q + backward_q + unskew): "
        f"{decode_ms:.4f} ms = {B / decode_ms * 1e3:.2f} alignments/s; "
        f"peak device memory {peak / 2**30:.2f} GiB [{card}]")

    Z = torch.randn((B, N, N), generator=g, device="cuda")

    def decode():
        with torch.no_grad():
            return dp_ops.expected_alignment(theta, A, (ln, lm),
                                             backend="pallas_long", **kw)

    def step():
        t = theta.clone().requires_grad_()
        a = A.clone().requires_grad_()
        E = dp_ops.expected_alignment(t, a, (ln, lm), backend="pallas_long",
                                      **kw)
        (E * Z).sum().backward()
        return E.detach(), t.grad, a.grad

    def with_q(q_dtype, fn):
        keep, dp_ops.Q_DTYPE = dp_ops.Q_DTYPE, q_dtype
        try:
            return fn()
        finally:
            dp_ops.Q_DTYPE = keep

    dp_cuda.reset_launches()
    runs = {q: with_q(q, step) for q in (None, torch.bfloat16)}
    torch.cuda.synchronize()
    launches = {k: dp_cuda.LAUNCHES[k] for k in Q_BF16}
    splits = q_splits(torch.bfloat16)
    if any(v == 0 for v in launches.values()) or \
            any(dp_cuda.LAUNCHES[k] != 1 for k in Q_KERNELS):
        raise AssertionError(f"the DP steps did not run each float32 and "
                             f"bf16 Q instance: {dp_cuda.LAUNCHES}")
    diff = {}
    for name, f32, b16 in zip(("E", "dtheta", "dA"), runs[None],
                              runs[torch.bfloat16]):
        if not torch.isfinite(b16).all():
            raise AssertionError(f"bf16 Q: non-finite {name}")
        diff[name] = dict(max_abs=(b16 - f32).abs().max().item(),
                          scale=f32.abs().max().item())
    del runs
    turns = {}
    for _ in range(2):
        for q in (None, torch.bfloat16):
            tag = "bf16" if q else "float32"
            turns.setdefault(f"decode {tag}", []).append(
                with_q(q, lambda: cuda_ms(decode, 3)))
            turns.setdefault(f"dp_step {tag}", []).append(
                with_q(q, lambda: cuda_ms(step, 2)))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with_q(torch.bfloat16, step)
    peak_b16 = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with_q(None, step)
    peak_f32 = torch.cuda.max_memory_allocated()
    for k, v in turns.items():
        log(f"phase long: pallas_long {k.replace(' ', ' Q ')} at ({B}, {N}, "
            f"{N}) nw softmax: {min(v):.4f} ms (turns "
            f"{[round(x, 4) for x in v]}) = {B / min(v) * 1e3:.2f} "
            f"{'alignments' if k.startswith('decode') else 'pairs'}/s "
            f"[{card}]")
    log(f"phase long: pallas_long DP step at ({B}, {N}, {N}) with bf16 Q "
        f"against float32 Q: largest differences {json.dumps(diff)}; "
        f"peak device memory {peak_b16 / 2**30:.2f} GiB (float32 Q "
        f"{peak_f32 / 2**30:.2f} GiB); bf16 Q launches of one step "
        f"{json.dumps(launches)} [{card}]")
    del theta, A, Z
    torch.cuda.empty_cache()
    return dict(ms, decode=decode_ms,
                **{k: min(v) for k, v in turns.items()}), launches, splits


# ---------------------------------------------------------------------------
# phase 6: the storage menu (int16 streams, the fast decode, the pair skew)
# ---------------------------------------------------------------------------

def _agreement(s1, s2):
    return sum(a == b for a, b in zip(s1, s2)) / max(len(s1), len(s2))


@timed_check
def menu_accuracy(card):
    """The decode under bf16 residuals and under the fast menu against
    float32 storage on the card, on the JAX package's own data and at its
    own gates: ``tests/test_bf16_streams.py::
    test_bench_config_d_only_agreement`` ((4, 48, 40), numpy seed 2: max E
    error < 5e-3, every pair's traceback agreement >= 0.97) and
    ``scripts/bench_check.py`` (the first 16 pairs of (256, 512, 512),
    numpy seed 0: max E error < 1e-2, mean agreement > 0.97); in both,
    the fast menu's stream walk (int16 E) against the natural walk under
    bf16 residuals, mean agreement >= 0.995 (bench_check's stream gate),
    and the fast decode's E error against float32 storage under the same
    E gate (its agreement with the float32 stream walk reported).
    Random potentials at length 512 make near-tie posteriors, where a
    walk that parts once parts for good: the agreement of one pair can
    fall far while the E error stays ~4e-3."""
    from deepblast_torch.ops import dp as dp_ops
    from deepblast_torch.ops.menu import DTypeMenu
    bf16, fast = (DTypeMenu.make(**MENUS[k]) for k in ("d_bf16", "fast"))
    out = {}
    for seed, B, N, M, keep, err_gate in ((2, 4, 48, 40, 4, 5e-3),
                                          (0, 256, 512, 512, 16, 1e-2)):
        rng = np.random.default_rng(seed)
        theta = torch.tensor(rng.standard_normal((B, N, M))[:keep],
                             dtype=torch.float32, device="cuda")
        A = torch.tensor(rng.standard_normal((B, N, M))[:keep] - 1.0,
                         dtype=torch.float32, device="cuda")
        lens = (torch.full((keep,), N, dtype=torch.int32, device="cuda"),
                torch.full((keep,), M, dtype=torch.int32, device="cuda"))
        E32 = dp_ops.expected_alignment(theta, A, lens).cpu()
        E16 = dp_ops.expected_alignment(theta, A, lens, dtypes=bf16).cpu()
        Es = dp_ops.expected_alignment_stream(theta, A, lens,
                                              dtypes=fast).cpu()
        E32s = dp_ops.expected_alignment_stream(theta, A, lens).cpu()
        walks = [dp_ops.traceback(E16[b]) for b in range(keep)]
        agree = [_agreement(dp_ops.traceback(E32[b]), w)
                 for b, w in enumerate(walks)]
        stream = [_agreement(dp_ops.traceback_stream(Es, N, M, b), w)
                  for b, w in enumerate(walks)]
        fast_agree = [_agreement(dp_ops.traceback_stream(Es, N, M, b),
                                 dp_ops.traceback_stream(E32s, N, M, b))
                      for b in range(keep)]
        a = dict(max_E_err=float((E16 - E32).abs().max()),
                 mean_agreement=float(np.mean(agree)),
                 min_agreement=float(np.min(agree)),
                 stream_vs_natural=float(np.mean(stream)),
                 fast_max_E_err=float(np.abs(dp_ops._host(Es)
                                             - E32s.numpy()).max()),
                 fast_mean_agreement=float(np.mean(fast_agree)))
        out[f"({keep}, {N}, {M})"] = a
        log(f"phase menu: decode under bf16 residuals against float32 "
            f"storage, numpy seed {seed}, {keep} pairs of ({N}, {M}) nw "
            f"softmax: {json.dumps(a)} [{card}]")
        per_pair = keep == B
        if max(a["max_E_err"], a["fast_max_E_err"]) >= err_gate or \
                a["stream_vs_natural"] < 0.995 or \
                (a["min_agreement"] < 0.97 if per_pair
                 else a["mean_agreement"] <= 0.97):
            raise AssertionError(f"bf16-residual decode against float32 at "
                                 f"({keep}, {N}, {M}): {a}")
    return out


def phase_menu(seed, card):
    """The slice's own path: ``cli.train`` with ``--dp-i16-streams
    --dp-decode-menu fast`` at ProtT5-XL + CNN-1024 (1 epoch), then
    ``load_model`` -> ``align`` and ``score_pairs``, the launch counts of
    each, every kernel instance of the two menus against its plain
    version at the potentials of a training batch, and the menus' decode
    accuracy against float32 storage."""
    from deepblast_torch.cli import train as cli_train
    from deepblast_torch.data.state_utils import pad_sequences
    from deepblast_torch.ops import dp_cuda
    from deepblast_torch.train.checkpoint import load_model

    rng = np.random.default_rng(seed + 4)
    rows = [homolog_row(rng, f"s{i}", 100, 400) for i in range(32)]
    valid = [homolog_row(rng, f"v{i}", 100, 400) for i in range(8)]
    errs = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, n) for n in ("train.tsv", "valid.tsv")]
        _write_tsv(paths[0], rows)
        _write_tsv(paths[1], valid)
        run = os.path.join(tmp, "out")
        torch.cuda.reset_peak_memory_stats()
        dp_cuda.reset_launches()
        t0 = time.time()
        rc = cli_train.main([
            "--train-pairs", paths[0], "--valid-pairs", paths[1],
            "-o", run, "--lm-type", "prot_t5", "--batch-size", "16",
            "--epochs", "1", "--seed", str(seed), "--dp-i16-streams",
            "--dp-decode-menu", "fast"])
        torch.cuda.synchronize()
        t_train = time.time() - t0
        tr = dict(dp_cuda.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if rc != 0:
            raise AssertionError(f"cli.train returned {rc}")
        metrics = read_metrics(run)
        losses = [(m["tag"], m["value"]) for m in metrics
                  if m["tag"] in ("train_loss", "validation_loss")]

        model = load_model(run)
        menus = [str(model.dp_dtypes), str(model.dp_decode_dtypes)]
        pairs = [rows[0][5:7], rows[1][5:7]]
        dp_cuda.reset_launches()
        t0 = time.time()
        states = [model.align(x, y) for x, y in pairs]
        t_align = time.time() - t0
        al = dict(dp_cuda.LAUNCHES)
        tok = model.tokenizer
        xt, xl = pad_sequences([tok(r[5])[0] for r in rows[:16]])
        yt, yl = pad_sequences([tok(r[6])[0] for r in rows[:16]])
        dp_cuda.reset_launches()
        scores = model.score_pairs(dict(x=xt, y=yt, x_len=xl, y_len=yl))
        torch.cuda.synchronize()
        sc = dict(dp_cuda.LAUNCHES)
        steps, vbatches = (len(list(model._batches(model._dataset(p), False,
                                                   0))) for p in paths)

        # the two menus' kernel instances at a training batch's potentials
        batch = next(iter(model._batches(model._dataset(paths[0]), True,
                                         seed)))
        with torch.no_grad():
            b = model._as_batch(batch)
            hx, hy = model._embeddings(b)
            lengths = (b["x_len"].to(torch.int32), b["y_len"].to(torch.int32))
            theta, A = model.aligner.potentials(hx, hy, lengths)
            for menu in (model.dp_dtypes, model.dp_decode_dtypes):
                check_menu_kernels(theta, A, *lengths, "nw", "softmax", menu,
                                   errs)
        check_autograd(theta, A, *lengths, "nw", "softmax", errs,
                       dtypes=model.dp_dtypes)
        torch.cuda.synchronize()
        checked = tuple(theta.shape)
        del model, hx, hy, theta, A
        torch.cuda.empty_cache()

    # training: theta/A through the pair skew, only the cotangent Zt (no
    # Za on the training path) through the single skew; align and
    # score_pairs: the pair skew only
    if tr["skew_pair"] != steps + vbatches or tr["skew"] != steps:
        raise AssertionError(f"training launches {tr} for {steps} steps and "
                             f"{vbatches} validation batches")
    if al["skew_pair"] != len(states) or al["skew"] != 0 or \
            al["forward"] == 0 or al["backward"] == 0:
        raise AssertionError(f"align launches {al}")
    if sc["skew_pair"] != 1 or sc["skew"] != 0 or sc["forward_score"] != 1:
        raise AssertionError(f"score_pairs launches {sc}")
    if menus != ["DTypeMenu(stream='int16', d='bfloat16', e='int16', "
                 "stream_range=16.0)",
                 "DTypeMenu(stream=None, d='bfloat16', e='int16', "
                 "stream_range=16.0)"]:
        raise AssertionError(f"menus {menus}")
    if not torch.isfinite(scores).all() or \
            not all(np.isfinite(v) for _, v in losses):
        raise AssertionError(f"losses {losses}")
    for (x, y), st in zip(pairs, states):
        if st.count("1") + st.count(":") != len(x) or \
                st.count("2") + st.count(":") != len(y):
            raise AssertionError("align: states do not consume both strings")
    launches = {k: tr[k] + al[k] + sc[k] for k in tr}
    log(f"phase menu: cli.train --dp-i16-streams --dp-decode-menu fast, "
        f"ProtT5-XL + CNN-1024, 32 train / 8 valid pairs, batch 16, 1 epoch: "
        f"{t_train:.2f} s; seconds between train_loss records "
        f"{[round(v, 4) for v in step_intervals(metrics)]}; peak device "
        f"memory {peak:.2f} GiB; losses {losses}; menus (training, decode) "
        f"{menus}; align x2 {t_align:.2f} s [{card}]")
    log(f"phase menu: launches training {json.dumps(tr)}; align "
        f"{json.dumps(al)}; score_pairs {json.dumps(sc)}")
    log(f"phase menu: kernels of both menus = plain and autograd = plain at "
        f"a training batch {checked}; max abs diff {json.dumps(errs)}")

    menu_accuracy(card)
    return launches, errs


# ---------------------------------------------------------------------------
# phase 7: decode at the bench shape
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, ops_ms):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= ops_ms else (ops_ms, "operations")


def _cuda_tool(name):
    from deepblast_torch.ops import dp_cuda
    return os.path.join(os.path.dirname(dp_cuda._nvcc()), name)


def _demangle(names):
    """Demangled kernel names without their namespace or parameters,
    e.g. ``forward_kernel<0, true, float, float, 2>``."""
    import shutil
    tool = shutil.which("c++filt") or _cuda_tool("cu++filt")
    proc = subprocess.run([tool], input="\n".join(names),
                          capture_output=True, text=True, check=True,
                          timeout=120)
    out = proc.stdout.splitlines()
    if len(out) != len(names):
        raise AssertionError("cu++filt did not demangle every kernel name")
    # the first name followed by its parameter list (or the end), past any
    # namespace
    return {n: re.search(r"(\w+(<[^()]*>)?)(\(|$)", d.strip()).group(1)
            for n, d in zip(names, out)}


def kernel_report(so):
    """Every kernel instance of the library ``so``: registers, stack and
    spills from ptxas's report (``dp_cuda.build`` keeps it beside the
    library), and from its SASS (``cuobjdump -sass``) the count of MUFU and
    fp32 instructions and of all instructions of its body (up to the last
    EXIT before the first called subroutine, e.g. a division's slow path)."""
    rep, cur = {}, None
    with open(f"{so}.ptxas") as f:
        for line in f:
            if "Compiling entry function" in line:
                cur = rep.setdefault(line.split("'")[1], {})
            elif "bytes stack frame" in line and cur is not None:
                nums = [int(w) for w in line.split() if w.isdigit()]
                cur.update(stack=nums[0], spill_stores=nums[1],
                           spill_loads=nums[2])
            elif "Used" in line and "registers" in line and cur is not None:
                cur["regs"] = int(line.split("Used")[1].split()[0])
    sass = subprocess.run([_cuda_tool("cuobjdump"), "-sass", so],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    body = {}
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            ops = body.setdefault(line.split(":", 1)[1].strip(), [])
        elif line.startswith("/*") and "*/" in line and ";" in line:
            text = line.split("*/", 1)[1].split(";")[0].split()
            if text and text[0].startswith("@"):
                text = text[1:]
            if text and not text[0].startswith("0x"):
                ops.append(text[0].split(".")[0])
    for name, ops in body.items():
        if "RET" in ops:
            ops = ops[:ops.index("RET")]
            ops = ops[:len(ops) - ops[::-1].index("EXIT")]
        rep.setdefault(name, {}).update(
            mufu=ops.count("MUFU"), instr=len(ops),
            fp32=sum(ops.count(o) for o in FP32_OPS))
    names = _demangle(sorted(rep))
    return {names[k]: v for k, v in rep.items()}


def cells_per_body(instance):
    """Cells one copy of an instance's code computes: T x D for a strip
    kernel (T its last template argument), else 1."""
    if instance.startswith(SPLIT_KERNELS):
        ring = Q_RING[instance.split("<")[0] + "<"]
        return 2 * ring[split_args(instance)[0]]
    if instance.startswith(STRIP_KERNELS):
        T = int(instance.rsplit(",", 1)[1].rstrip("> "))
        ring = ABWD_RING if instance.startswith("adjoint_backward") else \
            AFWD_RING if instance.startswith("adjoint_forward") else RING
        return T * ring[T]
    return 1


def ops_ms(report, instance, cells):
    """The operations side of the bound for ``cells`` valid cells of
    ``instance``: its MUFU and fp32 instructions per cell (from the SASS)
    over their peak rates, the larger of the two, in ms; and the counts."""
    r = report[instance]
    per = cells_per_body(instance)
    mufu, fp32, instr = (r[k] / per for k in ("mufu", "fp32", "instr"))
    t = max(cells * mufu / MUFU_PER_S, cells * fp32 / FP32_INSTR_PER_S)
    return t * 1e3, dict(mufu=mufu, fp32=fp32, instr=instr)


def phase_bench(seed, card):
    from deepblast_torch.ops import dp as dp_ops
    from deepblast_torch.ops import dp_cuda, dp_ref
    from deepblast_torch.ops.menu import DTypeMenu
    from deepblast_torch.ops.skew import skew, skew_pair, unskew
    from deepblast_torch.train.losses import matrix_cross_entropy
    B, N, M = 256, 512, 512
    K, S = N + M - 1, N + 1
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    theta, A, ln, lm = dp_problem(g, B, N, M, ragged=False)
    kw = dict(mode="nw", operator="softmax")
    Et = torch.ones((B,), device="cuda")
    th_s, A_s = dp_cuda.skew(theta), dp_cuda.skew(A)
    _, dx, dm = dp_cuda.forward(th_s, A_s, ln, lm, **kw)
    E, _ = dp_cuda.backward(dx, dm, ln, lm, Et, **kw)
    zt = dp_cuda.skew(torch.randn((B, N, M), generator=g, device="cuda"))
    za = dp_cuda.skew(torch.randn((B, N, M), generator=g, device="cuda"))
    _, dxd, dmd = dp_cuda.adjoint_forward(dx, dm, zt, None, ln, lm, **kw)
    _, *qs = dp_cuda.forward_q(th_s, A_s, ln, lm, **kw)
    _, *qds = dp_cuda.adjoint_forward_q(*qs, zt, None, ln, lm, **kw)
    bf16 = torch.bfloat16
    _, *qb = dp_cuda.forward_q(th_s, A_s, ln, lm, q_dtype=bf16, **kw)
    _, *qdb = dp_cuda.adjoint_forward_q(*qb, zt, None, ln, lm, **kw)

    def decode():
        t, a = dp_cuda.skew_pair(theta, A)
        _, x, m = dp_cuda.forward(t, a, ln, lm, **kw)
        return dp_cuda.backward(x, m, ln, lm, Et, **kw)

    target = (torch.rand((B, N, M), generator=g, device="cuda")
              < 1.0 / N).float()
    gmask = torch.ones((B, N, M), dtype=torch.bool, device="cuda")
    t_req = theta.clone().requires_grad_()
    a_req = A.clone().requires_grad_()

    def dp_step():
        aln = dp_ops.expected_alignment(t_req, a_req, (ln, lm), **kw)
        matrix_cross_entropy(target, aln, ln, lm, gmask).backward()

    kern = {
        "skew": lambda: dp_cuda.skew(theta),
        "skew_pair": lambda: dp_cuda.skew_pair(theta, A),
        "unskew": lambda: dp_cuda.unskew(E, N, M),
        "forward": lambda: dp_cuda.forward(th_s, A_s, ln, lm, **kw),
        "forward_score": lambda: dp_cuda.forward_score(th_s, A_s, ln, lm,
                                                       **kw),
        "backward": lambda: dp_cuda.backward(dx, dm, ln, lm, Et, **kw),
        "backward_gap": lambda: dp_cuda.backward(dx, dm, ln, lm, Et,
                                                 want_gap=True, **kw),
        "adjoint_forward": lambda: dp_cuda.adjoint_forward(
            dx, dm, zt, None, ln, lm, **kw),
        "adjoint_forward_za": lambda: dp_cuda.adjoint_forward(
            dx, dm, zt, za, ln, lm, **kw),
        "adjoint_backward": lambda: dp_cuda.adjoint_backward(
            dx, dm, dxd, dmd, E, ln, lm, **kw),
        "forward_q": lambda: dp_cuda.forward_q(th_s, A_s, ln, lm, **kw),
        "backward_q": lambda: dp_cuda.backward_q(*qs, ln, lm, Et, mode="nw"),
        "backward_q_gap": lambda: dp_cuda.backward_q(
            *qs, ln, lm, Et, mode="nw", want_gap=True),
        "adjoint_forward_q": lambda: dp_cuda.adjoint_forward_q(
            *qs, zt, None, ln, lm, **kw),
        "adjoint_forward_q_za": lambda: dp_cuda.adjoint_forward_q(
            *qs, zt, za, ln, lm, **kw),
        "adjoint_backward_q": lambda: dp_cuda.adjoint_backward_q(
            *qs, *qds, E, ln, lm, mode="nw"),
        "forward_q_bf16": lambda: dp_cuda.forward_q(th_s, A_s, ln, lm,
                                                    q_dtype=bf16, **kw),
        "backward_q_bf16": lambda: dp_cuda.backward_q(*qb, ln, lm, Et,
                                                      mode="nw"),
        "backward_q_gap_bf16": lambda: dp_cuda.backward_q(
            *qb, ln, lm, Et, mode="nw", want_gap=True),
        "adjoint_forward_q_bf16": lambda: dp_cuda.adjoint_forward_q(
            *qb, zt, None, ln, lm, **kw),
        "adjoint_forward_q_za_bf16": lambda: dp_cuda.adjoint_forward_q(
            *qb, zt, za, ln, lm, **kw),
        "adjoint_backward_q_bf16": lambda: dp_cuda.adjoint_backward_q(
            *qb, *qdb, E, ln, lm, mode="nw"),
    }
    plain = {
        "skew": lambda: skew(theta),
        "skew_pair": lambda: skew_pair(theta, A),
        "unskew": lambda: unskew(E, N, M),
        "forward": lambda: dp_ref.forward(th_s, A_s, ln, lm, **kw),
        "forward_score": lambda: dp_ref.forward_score(th_s, A_s, ln, lm,
                                                      **kw),
        "backward": lambda: dp_ref.backward(dx, dm, ln, lm, Et, **kw),
        "backward_gap": lambda: dp_ref.backward(dx, dm, ln, lm, Et,
                                                want_gap=True, **kw),
        "adjoint_forward": lambda: dp_ref.adjoint_forward(
            dx, dm, zt, None, ln, lm, **kw),
        "adjoint_forward_za": lambda: dp_ref.adjoint_forward(
            dx, dm, zt, za, ln, lm, **kw),
        "adjoint_backward": lambda: dp_ref.adjoint_backward(
            dx, dm, dxd, dmd, E, ln, lm, **kw),
        "forward_q": lambda: dp_ref.forward_q(th_s, A_s, ln, lm, **kw),
        "backward_q": lambda: dp_ref.backward_q(*qs, ln, lm, Et, mode="nw"),
        "backward_q_gap": lambda: dp_ref.backward_q(
            *qs, ln, lm, Et, mode="nw", want_gap=True),
        "adjoint_forward_q": lambda: dp_ref.adjoint_forward_q(
            *qs, zt, None, ln, lm, **kw),
        "adjoint_forward_q_za": lambda: dp_ref.adjoint_forward_q(
            *qs, zt, za, ln, lm, **kw),
        "adjoint_backward_q": lambda: dp_ref.adjoint_backward_q(
            *qs, *qds, E, ln, lm, mode="nw"),
        "forward_q_bf16": lambda: dp_ref.forward_q(th_s, A_s, ln, lm,
                                                   q_dtype=bf16, **kw),
        "backward_q_bf16": lambda: dp_ref.backward_q(*qb, ln, lm, Et,
                                                     mode="nw"),
        "backward_q_gap_bf16": lambda: dp_ref.backward_q(
            *qb, ln, lm, Et, mode="nw", want_gap=True),
        "adjoint_forward_q_bf16": lambda: dp_ref.adjoint_forward_q(
            *qb, zt, None, ln, lm, **kw),
        "adjoint_forward_q_za_bf16": lambda: dp_ref.adjoint_forward_q(
            *qb, zt, za, ln, lm, **kw),
        "adjoint_backward_q_bf16": lambda: dp_ref.adjoint_backward_q(
            *qb, *qdb, E, ln, lm, mode="nw"),
    }
    # The least bytes each function must move: a DP pass reads and writes
    # only the valid band (ln x lm cells per pair) of each stream, plus the
    # lengths and Vt or Et; the skew reads the natural tensor and writes
    # every slot of the layout; the unskew reads and writes B x N x M.
    f = 4
    band = int((ln.long() * lm.long()).sum())
    per_pair = 2 * f * B + f * B
    streams = {"forward": 4, "forward_score": 2, "backward": 3,
               "backward_gap": 4, "adjoint_forward": 5,
               "adjoint_forward_za": 6, "adjoint_backward": 7,
               "forward_q": 5, "backward_q": 4, "backward_q_gap": 5,
               "adjoint_forward_q": 7, "adjoint_forward_q_za": 8,
               "adjoint_backward_q": 9}
    nbytes = {k: n * f * band + per_pair for k, n in streams.items()}
    # the bf16 Q instances move their three Q streams at 2 bytes a value
    nbytes.update({f"{k}_bf16": nbytes[k] - 3 * 2 * band
                   for k in streams if "_q" in k})
    nbytes["skew"] = f * B * N * M + f * B * K * S
    nbytes["skew_pair"] = 2 * nbytes["skew"]
    nbytes["unskew"] = 2 * f * B * N * M
    # One PyTorch call that computes the same function, where there is
    # one: the unskew is a strided copy, since cell (i, j) of pair b sits at
    # the affine offset b*K*S + 1 + i*(S+1) + j*S of the contiguous stream.
    # The skew also zero-fills the out-of-band slots (two calls), and no
    # library call runs a DP recurrence.
    library = {"unskew": lambda: torch.as_strided(
        E, (B, N, M), (K * S, S + 1, S), 1).clone(
            memory_format=torch.contiguous_format)}
    if not torch.equal(library["unskew"](), dp_cuda.unskew(E, N, M)):
        raise AssertionError("unskew: the strided copy differs")

    # The skew's yardstick, two PyTorch calls and so no library_ms: a
    # zeroed stream and a strided copy of the natural tensor into its band
    def strided_skew(x):
        out = torch.zeros((B, K, S), device=x.device)
        torch.as_strided(out, (B, N, M), (K * S, S + 1, S), 1).copy_(x)
        return out

    if not torch.equal(strided_skew(theta), dp_cuda.skew(theta)):
        raise AssertionError("skew: the strided copy differs")
    yardstick = {"skew": cuda_ms(lambda: strided_skew(theta), 10),
                 "skew_pair": cuda_ms(lambda: (strided_skew(theta),
                                               strided_skew(A)), 10)}
    ms = {k: cuda_ms(fn, 10) for k, fn in kern.items()}
    plain_ms = {k: cuda_ms(fn, 1) for k, fn in plain.items()}
    library_ms = {k: cuda_ms(fn, 10) for k, fn in library.items()}
    decode_ms = cuda_ms(decode, 10)
    step_ms = cuda_ms(dp_step, 5)
    report = kernel_report(dp_cuda.build())
    log_registers(report)
    menu_forms(theta, A, ln, lm, E, zt, za, band, per_pair, card, report)
    out = {}
    for k in kern:
        ops, per = ops_ms(report, BENCH_INSTANCES[k], band) \
            if k in BENCH_INSTANCES else (0.0, {})
        b_ms, by = bound(nbytes[k], ops)
        out[k] = dict(ms=ms[k], plain_ms=plain_ms[k], bound_ms=b_ms,
                      bound_by=by, library_ms=library_ms.get(k))
        lib = f", library {library_ms[k]:.4f} ms" if k in library_ms else ""
        if k in yardstick:
            lib = (f", torch.zeros + strided copy_ (two calls a stream) "
                   f"{yardstick[k]:.4f} ms")
        log(f"phase bench: {k} {ms[k]:.4f} ms (plain {plain_ms[k]:.2f} ms"
            f"{lib}, bound {b_ms:.4f} ms by {by}: {nbytes[k]} bytes "
            f"{nbytes[k] / HBM_BYTES_PER_S * 1e3:.4f} ms, operations "
            f"{ops:.4f} ms at {json.dumps(per)} per cell) [{card}]")
    log(f"phase bench: decode skew_pair + forward + backward at (256, 512, "
        f"512) nw softmax fp32: {decode_ms:.4f} ms = "
        f"{B / decode_ms * 1e3:.1f} alignments/s; score-only forward "
        f"{ms['forward_score']:.4f} ms [{card}]")
    log(f"phase bench: differentiable DP step (expected_alignment + "
        f"backward() of a cross entropy) at (256, 512, 512) nw softmax "
        f"fp32: {step_ms:.4f} ms = {B / step_ms * 1e3:.1f} pairs/s [{card}]")

    # the decode and the DP step under the storage menus, and the pair
    # skew against two skews, each form timed in turn with float32
    menus = {k: DTypeMenu.make(**MENUS[k]) for k in ("d_bf16", "fast")}

    def decode_menu(menu):
        t, a = dp_cuda.skew_pair(theta, A, menu.stream_dtype,
                                 menu.stream_scale)
        _, x, m = dp_cuda.forward(t, a, ln, lm, dtypes=menu, **kw)
        return dp_cuda.backward(x, m, ln, lm, Et, dtypes=menu, decode=True,
                                **kw)

    def dp_step_menu(menu):
        aln = dp_ops.expected_alignment(t_req, a_req, (ln, lm), dtypes=menu,
                                        **kw)
        matrix_cross_entropy(target, aln, ln, lm, gmask).backward()

    pair_forms = {"two skews": lambda: (dp_cuda.skew(theta),
                                        dp_cuda.skew(A)),
                  "skew_pair": lambda: dp_cuda.skew_pair(theta, A)}
    turns = {}
    for _ in range(2):
        for name, fn in [("decode f32", decode),
                         ("decode d_bf16", lambda: decode_menu(
                             menus["d_bf16"])),
                         ("decode fast", lambda: decode_menu(menus["fast"])),
                         ("dp_step f32", dp_step),
                         ("dp_step d_bf16", lambda: dp_step_menu(
                             menus["d_bf16"])),
                         *pair_forms.items()]:
            turns.setdefault(name, []).append(
                cuda_ms(fn, 5 if name.startswith("dp_step") else 10))
    for name, v in turns.items():
        per = "pairs/s" if name.startswith("dp_step") else "alignments/s"
        log(f"phase bench: {name} at (256, 512, 512) nw softmax: "
            f"{min(v):.4f} ms (turns {[round(x, 4) for x in v]}) = "
            f"{B / min(v) * 1e3:.1f} {per} [{card}]")
    return out, min(turns["decode d_bf16"])


def log_registers(report):
    """Registers, stack and spills (ptxas) of the strip kernels' instances,
    per kernel and strip width, of the relayouts, and the most of any
    other kernel."""
    groups = {}
    for name, r in report.items():
        if name.startswith(STRIP_KERNELS):
            key = f"{name.split('<')[0]} T={name.rsplit(',', 1)[1][:-1].strip()}"
        elif name.startswith(SPLIT_KERNELS):
            cluster, tq = split_args(name)
            key = (f"{name.split('<')[0]} "
                   f"{'cluster' if cluster else 'one CTA'} Q {tq}")
        elif name.startswith(("skew", "unskew")):
            key = name.split("<")[0]
        else:
            key = "other kernels"
        groups.setdefault(key, []).append(r)
    for key, rs in sorted(groups.items()):
        regs = [r["regs"] for r in rs]
        log(f"phase bench: ptxas {key}: {len(rs)} instances, registers "
            f"{min(regs)}-{max(regs)}, stack <= "
            f"{max(r['stack'] for r in rs)} bytes, spill stores <= "
            f"{max(r['spill_stores'] for r in rs)} bytes, spill loads <= "
            f"{max(r['spill_loads'] for r in rs)} bytes")


# the instance each storage form times (softmax, strip width 2)
FORM_INSTANCES = {
    "forward D bf16": "forward_kernel<0, true, float, __nv_bfloat16, 2>",
    "forward in int16": "forward_kernel<0, true, short, float, 2>",
    "forward in int16 D bf16":
        "forward_kernel<0, true, short, __nv_bfloat16, 2>",
    "forward_score in int16": "forward_kernel<0, false, short, float, 2>",
    "backward D bf16": "backward_kernel<0, false, __nv_bfloat16, float, 2>",
    "backward D bf16 gap": "backward_kernel<0, true, __nv_bfloat16, float, 2>",
    "backward D bf16 E int16 (fast decode)":
        "backward_kernel<0, false, __nv_bfloat16, short, 2>",
    "adjoint_forward D bf16":
        "adjoint_forward_kernel<0, false, __nv_bfloat16, float, 2>",
    "adjoint_forward D bf16 Za":
        "adjoint_forward_kernel<0, true, __nv_bfloat16, float, 2>",
    "adjoint_backward D bf16":
        "adjoint_backward_kernel<0, __nv_bfloat16, float, 2>",
}


def menu_forms(theta, A, ln, lm, E, zt, za, band, per_pair, card, report):
    """Each kernel's storage forms at the bench shape: time (CUDA events),
    the plain version's time, and the bound from the bytes each form's
    streams really move (a bf16 or int16 stream moves 2 bytes a value)."""
    from deepblast_torch.ops import dp_cuda, dp_ref
    from deepblast_torch.ops.menu import DTypeMenu
    from deepblast_torch.ops.skew import skew, skew_pair, unskew
    B, N, M = theta.shape
    K, S = N + M - 1, N + 1
    kw = dict(mode="nw", operator="softmax")
    bf, fast, i16, i16b = (DTypeMenu.make(**MENUS[k])
                           for k in ("d_bf16", "fast", "i16", "i16_d_bf16"))
    sc = i16.stream_scale
    Et = torch.ones((B,), device="cuda")
    th_i, A_i = dp_cuda.skew(theta, torch.int16, sc), dp_cuda.skew(
        A, torch.int16, sc)
    th_s, A_s = dp_cuda.skew(theta), dp_cuda.skew(A)
    _, dx, dm = dp_cuda.forward(th_s, A_s, ln, lm, dtypes=bf, **kw)
    _, dxd, dmd = dp_cuda.adjoint_forward(dx, dm, zt, None, ln, lm,
                                          dtypes=bf, **kw)
    E_b = dp_cuda.skew(dp_cuda.unskew(E, N, M), torch.bfloat16)
    E_q = dp_cuda.skew(dp_cuda.unskew(E, N, M), torch.int16, 32767.0)
    nat, strm = B * N * M, B * K * S
    # name: (kernel, plain, bytes)
    forms = {
        "skew bf16": (lambda: dp_cuda.skew(theta, torch.bfloat16),
                      lambda: skew(theta, torch.bfloat16), 4 * nat + 2 * strm),
        "skew int16": (lambda: dp_cuda.skew(theta, torch.int16, sc),
                       lambda: skew(theta, torch.int16, sc),
                       4 * nat + 2 * strm),
        "skew_pair bf16": (lambda: dp_cuda.skew_pair(theta, A, torch.bfloat16),
                           lambda: skew_pair(theta, A, torch.bfloat16),
                           2 * (4 * nat + 2 * strm)),
        "skew_pair int16": (lambda: dp_cuda.skew_pair(theta, A, torch.int16,
                                                      sc),
                            lambda: skew_pair(theta, A, torch.int16, sc),
                            2 * (4 * nat + 2 * strm)),
        "unskew bf16": (lambda: dp_cuda.unskew(E_b, N, M),
                        lambda: unskew(E_b, N, M), 6 * nat),
        "unskew int16": (lambda: dp_cuda.unskew(E_q, N, M),
                         lambda: unskew(E_q, N, M), 6 * nat),
        "forward D bf16": (
            lambda: dp_cuda.forward(th_s, A_s, ln, lm, dtypes=bf, **kw),
            lambda: dp_ref.forward(th_s, A_s, ln, lm, dtypes=bf, **kw),
            12 * band + per_pair),
        "forward in int16": (
            lambda: dp_cuda.forward(th_i, A_i, ln, lm, dtypes=i16, **kw),
            lambda: dp_ref.forward(th_i, A_i, ln, lm, dtypes=i16, **kw),
            12 * band + per_pair),
        "forward in int16 D bf16": (
            lambda: dp_cuda.forward(th_i, A_i, ln, lm, dtypes=i16b, **kw),
            lambda: dp_ref.forward(th_i, A_i, ln, lm, dtypes=i16b, **kw),
            8 * band + per_pair),
        "forward_score in int16": (
            lambda: dp_cuda.forward_score(th_i, A_i, ln, lm, dtypes=i16,
                                          **kw),
            lambda: dp_ref.forward_score(th_i, A_i, ln, lm, dtypes=i16, **kw),
            4 * band + per_pair),
        "backward D bf16": (
            lambda: dp_cuda.backward(dx, dm, ln, lm, Et, dtypes=bf, **kw),
            lambda: dp_ref.backward(dx, dm, ln, lm, Et, dtypes=bf, **kw),
            8 * band + per_pair),
        "backward D bf16 gap": (
            lambda: dp_cuda.backward(dx, dm, ln, lm, Et, dtypes=bf,
                                     want_gap=True, **kw),
            lambda: dp_ref.backward(dx, dm, ln, lm, Et, dtypes=bf,
                                    want_gap=True, **kw),
            12 * band + per_pair),
        "backward D bf16 E int16 (fast decode)": (
            lambda: dp_cuda.backward(dx, dm, ln, lm, Et, dtypes=fast,
                                     decode=True, **kw),
            lambda: dp_ref.backward(dx, dm, ln, lm, Et, dtypes=fast,
                                    decode=True, **kw),
            6 * band + per_pair),
        "adjoint_forward D bf16": (
            lambda: dp_cuda.adjoint_forward(dx, dm, zt, None, ln, lm,
                                            dtypes=bf, **kw),
            lambda: dp_ref.adjoint_forward(dx, dm, zt, None, ln, lm,
                                           dtypes=bf, **kw),
            12 * band + per_pair),
        "adjoint_forward D bf16 Za": (
            lambda: dp_cuda.adjoint_forward(dx, dm, zt, za, ln, lm,
                                            dtypes=bf, **kw),
            lambda: dp_ref.adjoint_forward(dx, dm, zt, za, ln, lm,
                                           dtypes=bf, **kw),
            16 * band + per_pair),
        "adjoint_backward D bf16": (
            lambda: dp_cuda.adjoint_backward(dx, dm, dxd, dmd, E, ln, lm,
                                             dtypes=bf, **kw),
            lambda: dp_ref.adjoint_backward(dx, dm, dxd, dmd, E, ln, lm,
                                            dtypes=bf, **kw),
            20 * band + per_pair),
    }
    for name, (kern, plain, nbytes) in forms.items():
        ms = cuda_ms(kern, 10)
        plain_ms = cuda_ms(plain, 1)
        ops = ops_ms(report, FORM_INSTANCES[name], band)[0] \
            if name in FORM_INSTANCES else 0.0
        b_ms, by = bound(nbytes, ops)
        log(f"phase bench: {name} {ms:.4f} ms (plain {plain_ms:.2f} ms, "
            f"bound {b_ms:.4f} ms by {by}: {nbytes} bytes, operations "
            f"{ops:.4f} ms) [{card}]")


# ---------------------------------------------------------------------------
# phase 8: the benchmark entry point
# ---------------------------------------------------------------------------

#: the kernels each record of phase ``cli_bench`` must launch
CLI_BENCH_RUNS = [
    (["--depth", "fwd"], ("skew_pair", "forward_score")),
    (["--depth", "fwd+bwd"], ("skew_pair", "forward", "backward", "unskew")),
    (["--depth", "decode"], ("skew_pair", "forward", "backward")),
    (["--depth", "train"], TRAIN_KERNELS),
    (["--backend", "pallas", "--depth", "decode", "--batch-size", "8",
      "--length", str(LONG_LEN)], ("skew", "forward_q", "backward_q",
                                   "unskew")),
]
#: kernel names of ``csrc/dp_kernels.cu`` in a profiler trace
DP_KERNEL_NAME = re.compile(r"\b(skew|skew_pair|unskew|forward|backward|"
                            r"adjoint_forward|adjoint_backward)(_q)?_kernel\b")


def trace_step(label, step, card, errs, top=10):
    """Trace 3 calls of ``step`` (after one untraced) with
    ``utils.profiling.trace`` into a temporary directory, and log the
    step's device time, the card's busy share of the host clock, the share
    of ``csrc/dp_kernels.cu``'s kernels and the ``top`` device operations
    with the most time."""
    from deepblast_torch.utils import profiling
    step()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        trace_bytes = os.path.getsize(os.path.join(tmp, "trace.json"))
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in dev) / 1e3 / 3   # ms
    if not total:
        errs.append(f"{label}: the profiler recorded no device time")
        return
    dp = sum(e.self_device_time_total for e in dev
             if DP_KERNEL_NAME.search(e.key)) / 1e3 / 3
    log(f"phase cli_bench: trace of {label}: a step {total:.4f} ms of "
        f"device time ({3 * total / wall:.1%} of {wall / 3:.4f} ms of host "
        f"clock): dp_kernels.cu {dp:.4f} ms ({dp / total:.1%}), everything "
        f"else {total - dp:.4f} ms ({1 - dp / total:.1%}); chrome trace "
        f"{trace_bytes} bytes [{card}]")
    dev.sort(key=lambda e: -e.self_device_time_total)
    for e in dev[:top]:
        ms = e.self_device_time_total / 1e3 / 3
        log(f"phase cli_bench: {label} top device op {ms:.4f} ms a step "
            f"({ms / total:.1%}, {e.count // 3} a step) "
            f"{'[dp] ' if DP_KERNEL_NAME.search(e.key) else ''}{e.key[:160]}")


def phase_cli_bench(card, decode_ms):
    """``python -m deepblast_torch.cli.benchmark`` in process: (a) every
    depth at the bench shape under d-bf16 and the ``pallas`` decode at 8 x
    4096 x 4096, each record's kernels launched (each shape's inputs drawn
    once: ``benchmark.inputs`` is cached here, records get copies); (b) its
    decode against phase 7's (``decode_ms``) within 10%; (c)
    ``torch.profiler`` traces of 3 ``train``-depth steps and of 3 of phase
    7's DP steps (``expected_alignment`` + ``backward()`` of a cross
    entropy) under d-bf16: the device operations with the most time and
    the DP kernels' share of each step's device time."""
    from deepblast_torch.cli import benchmark
    from deepblast_torch.ops import dp as dp_ops
    from deepblast_torch.ops import dp_cuda
    from deepblast_torch.train.losses import matrix_cross_entropy
    errs, records, drawn = [], {}, {}
    draw = benchmark.inputs

    def inputs(B, N, M, device):
        if (B, N, M) not in drawn:
            drawn[B, N, M] = draw(B, N, M, device)
        theta, A, (ln, lm) = drawn[B, N, M]
        return theta.clone(), A.clone(), (ln, lm)

    base = ["--batch-size", "256", "--length", "512", "--mode", "nw",
            "--dtype-menu", "d-bf16", "--iters", "3"]
    benchmark.inputs = inputs
    try:
        for extra, want in CLI_BENCH_RUNS:
            out = io.StringIO()
            dp_cuda.reset_launches()
            with contextlib.redirect_stdout(out):
                benchmark.main(base + extra)
            torch.cuda.synchronize()
            launches = {k: v for k, v in dp_cuda.LAUNCHES.items() if v}
            rec = json.loads(out.getvalue().splitlines()[-1])
            records[rec["backend"], rec["depth"]] = rec
            log(f"phase cli_bench: {json.dumps(rec)}")
            log(f"phase cli_bench: launches {json.dumps(launches)} [{card}]")
            missing = [k for k in want if not launches.get(k)]
            if missing:
                errs.append(f"{rec['backend']} {rec['depth']}: {missing} "
                            f"never launched")
    finally:
        benchmark.inputs = draw
    got = records[None, "decode"]["seconds"] * 1e3
    log(f"phase cli_bench: decode {got:.4f} ms (time_op) against phase "
        f"bench's {decode_ms:.4f} ms (cuda_ms), ratio {got / decode_ms:.4f} "
        f"[{card}]")
    if abs(got / decode_ms - 1) > 0.10:
        errs.append(f"decode {got:.4f} ms is not within 10% of phase bench's "
                    f"{decode_ms:.4f} ms")

    # (c) the DP step traced at the bench shape under d-bf16
    theta, A, lengths = drawn[256, 512, 512]
    del drawn
    theta.requires_grad_()
    A.requires_grad_()
    menu = benchmark.make_menu("d-bf16")
    train = benchmark.depth_op("train", lengths, "nw", None, menu)
    trace_step("3 train-depth steps (256, 512, 512) nw softmax d-bf16",
               lambda: train(theta, A), card, errs)
    g = torch.Generator(device=theta.device)
    g.manual_seed(0)
    target = (torch.rand(theta.shape, generator=g, device=theta.device)
              < 1.0 / 512).float()
    gmask = torch.ones(theta.shape, dtype=torch.bool, device=theta.device)

    def dp_step():
        aln = dp_ops.expected_alignment(theta, A, lengths, dtypes=menu)
        matrix_cross_entropy(target, aln, *lengths, gmask).backward()
    trace_step("3 DP steps with a cross entropy (phase bench's dp_step) "
               "(256, 512, 512) nw softmax d-bf16", dp_step, card, errs)
    return errs


def main(argv):
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import deepblast_torch  # noqa: F401  (fails outside a checkout)
    if argv[:1] == ["--worker"]:
        return worker_main(argv[1])
    if argv[:1] == ["--rank"]:
        return rank_main(argv[1], int(argv[2]))
    card = card_line()
    log(card)

    seed = 0
    seconds, t0 = {}, time.time()

    def timed(name, fn, *args):
        PHASE[0] = name
        out = fn(*args)
        seconds[name] = round(time.time() - t0 - sum(seconds.values()), 1)
        return out

    timed("build", phase_build)
    with tempfile.TemporaryDirectory() as tmp, Worker(tmp) as worker:
        errs = timed("kernels", phase_kernels, seed)
        serving, path_errs = timed("serving", phase_serving, seed, card)
        model_dir = os.path.join(tmp, "train")
        training, train_errs = timed("train", phase_train, seed, card,
                                     model_dir)
        evaluate, eval_errs = timed("evaluate", phase_evaluate, seed, card,
                                    model_dir)
        options, options_errs = timed("options", phase_options, seed, card)
        par, par_errs = timed("parallel", phase_parallel, seed, card)
        # the worker's card time would count in the phases timed below
        done = timed("worker", worker.join)
    worker_errs = done["errs"]
    for k, v in done["seconds"].items():
        CHECK_SECONDS[k] = v
    bilm, bilm_errs = timed("bilm", phase_bilm, seed, card)
    long_, long_errs = timed("long", phase_long, seed, card)
    # each split Q kernel's last split on the long path (its longest
    # batch); the bf16 instances' in long_times' bf16 DP step
    splits = q_splits(None)
    _, bf16_launches, bf16_splits = timed("long_times", long_times, seed,
                                          card)
    splits.update(bf16_splits)
    menu, menu_errs = timed("menu", phase_menu, seed, card)
    bench, bench_decode_ms = timed("bench", phase_bench, seed, card)
    cli_errs = timed("cli_bench", phase_cli_bench, card, bench_decode_ms)
    if cli_errs:
        raise AssertionError(f"phase cli_bench: {cli_errs}")
    log(f"seconds per phase {json.dumps(seconds)}")
    log(f"seconds per phase and check (all calls; nested checks count in "
        f"each) {json.dumps(CHECK_SECONDS)}")
    kernels = []
    for k in KERNELS + Q_KERNELS + Q_BF16:
        checked = [d[k] for d in (errs, path_errs, train_errs, eval_errs,
                                  options_errs, par_errs, worker_errs,
                                  bilm_errs, long_errs, menu_errs) if k in d]
        if not checked:
            raise AssertionError(f"{k} was never held to its plain version")
        launches = bf16_launches[k] if k in Q_BF16 else \
            serving[k] + training[k] + evaluate[k] + options[k] + par[k] + \
            bilm[k] + long_[k] + menu[k]
        kernels.append(dict(
            name=k, route="cuda", source=SOURCE,
            replaces=REPLACES[k.replace("_bf16", "")],
            launches=launches, max_abs_err=max(checked),
            ms=bench[k]["ms"], plain_ms=bench[k]["plain_ms"],
            bound_ms=bench[k]["bound_ms"], bound_by=bench[k]["bound_by"],
            library_ms=bench[k]["library_ms"],
            **({"split": splits[k]} if k in Q_KERNELS + Q_BF16 else {})))
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

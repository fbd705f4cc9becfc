#!/usr/bin/env python3
"""Quickest proof that the PyTorch port serves DiT-image, DiT-video and
the LM zoo (Mamba2, Zamba2, Whisper, Mixtral, DeepSeek-V2), trains
DiT-image, yi-6b, mamba2-1.3b, zamba2-7b, whisper-medium and
mixtral-8x7b, runs GF-DiT's group-free collectives and
sequence-parallel decoding, and runs the twins of ``benchmarks/``, on
one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):

1. device: the card's name and power limit (nvidia-smi); TF32 off.
2. build: the CUDA kernels of ``src/repro_torch/csrc`` with nvcc, before
   any engine starts (a first-use build inside a rank thread would
   outlast GFC's collective timeout); K2's forward kernels (the
   tensor-core tile kernel at every head dim in both dtypes, the
   split-key combine) and its backward kernels: registers, spills,
   shared memory and blocks an SM (backward: fp32 at every head dim,
   bf16 at 64 and 128); K1's backward row kernel's registers and spills at
   DIT_IMAGE's width, every variant, with its plan and blocks an SM; the
   registers and spills of K4's forward and backward tensor-core stage
   kernels at every (p, n, chunk) in both dtypes and of their other
   stages at (p, n, chunk) = (64, 128, 128) and (64, 64, 128), with
   every stage's threads, shared bytes and blocks an SM in both dtypes at
   mamba2-1.3b's and zamba2-7b's prefill and training shapes.
3. kernels: each kernel against its plain PyTorch version on the card at
   its path's full-width shapes (DIT_IMAGE for K1-K3, the mamba2-1.3b
   prefill for K4, timed at batch 4 and 1 in both dtypes, with the
   tensor-core and CUDA-core bounds and the four-stage design's floor;
   zamba2-7b's forward for K2
   causal at head dim 112 and its prefill for K4 at (p, n, chunk) =
   (64, 64, 128); yi-6b's causal GQA forward for K2; whisper-medium's
   encoder self-attention over 1500 frames and its cross-attention of a
   4-token prefill and of a decode step to them, at batch 4, with the
   kernel's occupancy and the key pieces it splits each case into), fp32
   and bf16 (each bound at its dtype's peak: bf16 at the tensor cores'
   989 TFLOP/s, fp32 as three TF32 products a product at their 494.7,
   with the CUDA-core bound beside it); the backward kernels of K2
   (DIT_IMAGE's self and cross attention at batch 2, yi-6b's causal GQA
   at 2 x 2048, whisper's encoder self; on the tensor cores, bf16
   products or fp32 ones as three TF32 products, each with its three
   kernels' device time; fp32 with both bounds, split-TF32's and the
   CUDA cores') and K1 (every
   variant at (2, 1024, 1536), each timed beside its bound and the
   library's backward, with its two kernels' device time), rel-L2 per
   output, and K2's forward with its log-sum-exp written; K1's forward
   gated residual beside ``residual + gate * x``; and K1-K3 at
   DIT_VIDEO's shapes in fp32 (K1 at D=3072, K2 self over 20,280 keys
   and cross at head dim 128, K3 at the video hit); K2 and K3 in fp32
   at the 512 px request's SP-4 shard (self over 1024 keys, cross to 77
   text tokens, the hit at three offsets), each timed on the route the
   library takes and on the tile kernel alone; with kernel,
   plain-version and one-PyTorch-call times from CUDA events; K4's device
   time by stage kernel (``torch.profiler``) and each stage's occupancy;
   K4's backward at the mamba2-1.3b and zamba2-7b training shapes (2 x
   2048 tokens), fp32 (split-TF32 on the tensor cores, within 2e-5) and
   bf16 (bf16 products on the tensor cores, within 3e-2), rel-L2 per
   output (dx, ddt, dA, dB, dC, each printed) against
   ``ref.ssd_bwd_ref``, timed as the other backward kernels with its
   four stage kernels' device time and occupancy; the fp32 products'
   split-TF32 GEMM (``ops.linear``, ``csrc/gemm.cu``) at video-l's three
   product shapes and image-interactive's two, each within 1e-5 rel-L2 of
   the fp32 and the fp64 product, timed beside its bound at 165 TFLOP/s
   (three TF32 products a product) and ``torch.matmul``'s fp32 (cuBLAS,
   which the port no longer calls there), the host cost of a product on
   either route, then the products of one denoise call of each benchmark
   cell's configuration (full width and depth) at each of its request
   classes' tokens by route: the kernel's launches and the fp32 products
   left to cuBLAS by reason, each equal to what the product rule gives
   the call's product shapes.  ``--phase gemm`` runs these alone.
4. serve: ``ServingEngine(DIT_IMAGE, SP-4, cache_interval=2)`` at full
   width serves two 512 px and one 1024 px request; every request must
   finish with finite pixels, through K1-K3, with both §11 refresh and
   hit steps; the fp32 products by route (the GEMM's launches and those
   left to cuBLAS by reason) must equal what the product rule gives the
   shapes of every DiT and text-encoder call the serve made, with the
   GEMM launched (the video phase's full-width serves are held the same).
5. sp: one 512 px request at SP1 and SP4 (cache_interval=1) agree.
6. cpu: on DIT_IMAGE.reduced() the card (kernels) and the CPU (plain
   versions) give the same pixels.
7. scenarios: the six cross-backend demos of ``repro_torch.serving``
   (elastic, packing, cache, topology, hybrid, failure) through their
   ``run_demo`` at DIT_IMAGE's full width and depth, each held to its own
   gates (wall vs sim ``trace_signature`` and telemetry identity, pixels
   within 1e-4 rel-L2, the elastic preempt/requeue/Reallocate and bg's
   pixels against SP-1, the failure demo's restore from its on-disk
   snapshot); then ``serve_image_dit --emit-trace``.  With the garbage
   collector off, every engine's ``shutdown()`` must leave no live
   tensor on the card; K1-K3 must launch.
8. video: the paper's video class, DIT_VIDEO (30 layers, d_model 3072,
   24 heads x 128, 7.39 B parameters) at full width and depth, one
   engine live at a time: (a) a 480x832x49-frame request (20,280 tokens)
   uncached at SP-4 and SP-1 on the same weights, pixels of (13, 480,
   832, 3) within 1e-4 rel-L2, K1 and K2 launched; (b) 480x832x17 frames
   (7,800 tokens) at SP-4 with cache_interval=2: a refresh step, then a
   §11 hit through K3; (c) DIT_VIDEO.reduced() card vs CPU; the
   positional embedding at 20,280 and 75,600 positions, card vs CPU.
   Host and card memory are printed first.
9. lm: mamba2-1.3b at full width (48 layers, d_model 2048, seeded random
   weights with Mamba2's published A/dt ranges) prefills 4 prompts of
   2048 tokens in bf16 and decodes 32 tokens greedily through the
   serve-loop steps: finite logits, K4 once per layer per prefill; the
   same with the ``ssd_bf16`` variant (``dryrun.apply_variant``:
   intra_dtype="bfloat16", K4 in bf16 on the tensor cores, counted by
   dtype in ``ops.kernel_launches``) on the same weights, its prefill
   tokens/s, decode ms a step and peak memory printed beside the
   fp32-intra leg's; then in fp32 prefill + decode reproduce the
   teacher-forced forward.
10. lm-cpu: on mamba2-1.3b.reduced() the card (K4) and the CPU (the
   sequential plain version) give the same logits.
11. hybrid: zamba2-7b at full width and depth (81 Mamba2 layers, d_model
   3584, 112 SSD heads, one shared attention block of 32 heads x 112
   applied 13 times; seeded random weights, A/dt in Mamba2's published
   ranges, 27.0 GB in fp32) prefills 4 prompts of 2048 tokens in bf16
   and decodes 32 tokens greedily through the serve-loop steps: finite
   logits, K4 81 times a prefill and never in a decode step, no DiT
   kernel; the same under ``ssd_bf16`` (K4 in bf16, 81 times a
   prefill); then in fp32 prefill + 32 teacher-forced decode steps
   reproduce ``hybrid.forward`` over the 2080 tokens (K2 causal 13
   times at d=112, K4 81 times at the ragged l=2080).
12. hybrid-cpu: zamba2-7b, yi-6b and gemma3-12b at ``.reduced()`` (the
   SWA ring past its wrap): the card and the CPU give the same forward
   and prefill + decode logits on the same weights.
13. zoo: one model live at a time, seeded random weights, a bf16 prefill
   and 32 greedy decode steps each, then fp32 prefill + decode against
   the teacher-forced forward (within 5e-4 of the largest logit):
   whisper-medium at full width and depth (24 + 24 layers, 1.01 B
   parameters; 4 x (1500 frames + 4 tokens); K2 48 times a prefill, 24 a
   decode step, 72 a forward; the bf16 serve's encoder self-attention on
   K2's tensor-core tile kernel, its cross-attention on split keys, each
   launch counted by route); mixtral-8x7b at full width, 4 of 32 layers
   (4 x 2048 tokens; SWA and MoE launch no kernel, as in the JAX package;
   fp32 check at 1000 + 32 tokens, where the MoE's capacity is exact);
   deepseek-v2-236b at full width, the dense prefix layer + 2 MoE layers
   of 60 (1 x 2048 tokens, naive and absorbed MLA decode, absorbed vs
   naive within 1e-5; fp32 check at 600 + 32 tokens).  The depth cuts
   keep the fp32 weights within the card's 80 GB.
14. zoo-cpu: mixtral-8x7b, deepseek-v2-236b (q_lora_rank 24, three
   layers, absorbed decode) and whisper-medium at ``.reduced()``, card
   vs CPU logits within 1e-4 rel-L2.
15. train: (a) DIT_IMAGE at full width and depth (1.73 B parameters,
   livened adaLN) on one synthetic batch of 2 x 1024 latent tokens + 64
   text tokens: first one fp32 gradient (``train_loop.grads_of``, K2's
   backward 56 times in split-TF32), whose loss, global gradient norm
   and gradient (its rel-L2 estimated by seeded random projections, over
   every leaf and over the q, k, v projections) must lie within 1e-5 of
   the CUDA-core kernels' (``CUDA_CORE_DIT_FP32``);
   then bf16, AdamW, 5 steps on that batch: the loss must fall at every
   step and stay within 3e-2 of the five losses of the CUDA-core
   backward kernels, K1 and K2 forward and backward launched every step;
   then ``remat="full"`` gradients whose every leaf, and a
   ``remat="full"`` step whose loss and grad_norm (taken as the
   optimizer takes it), must equal ``"none"``'s bit for bit (the
   recompute replays the same kernels on the same inputs); (b) yi-6b at
   full width, 4 of 32 layers (1.22 B parameters), 3 steps of 2 x 2048
   tokens from the TokenPipeline through K2's causal GQA backward; (c)
   mamba2-1.3b at full width and depth (48 layers, 1.44 B parameters, A
   and dt in Mamba2's published ranges), 3 bf16 AdamW steps of 2 x 2048
   tokens from the TokenPipeline, K4 and its backward 48 times a step;
   then the same steps under ``ssd_bf16`` from the same weights with a
   fresh AdamW on the same batches: K4 and its backward in bf16 (the
   ``_ssd_bwd_dtypes`` spy sees bfloat16), the same launches a step, its
   losses within 3e-2 of the fp32-intra leg's;
   (d) zamba2-7b at full width, 12 of 81 layers (two groups of six and
   the shared block), the same, K4 and its backward 12 times a step and
   K2 causal forward and backward twice at d=112; (c) and (d) print the
   dtype K4's backward ran at and their losses must stay within 3e-2 of
   those of the CUDA-core backward (``CUDA_CORE_SSD_LOSSES``); (f)
   whisper-medium at full width and depth, 3 bf16 steps of 2 x (2048
   tokens + 1500 frames), K2 and its backward 72 times a step, counted
   by site (encoder self, causal decoder self, cross: 24 each); (g)
   mixtral-8x7b at full width, 2 of 32 layers (MIXTRAL_TRAIN: the most
   whose dry-run peak at a 1x1 mesh stays under 70 GiB), the same
   steps, no kernel (SWA and the MoE are plain ops, as in JAX), its
   peak held within 10% of the dry run's prediction, which a CPU
   process makes meanwhile for 2 and 3 layers.  Prints the losses, step
   walls, samples or tokens/s, peak memory and the launches a step.
16. train-cpu: DIT_IMAGE, yi-6b, mamba2-1.3b, zamba2-7b,
   whisper-medium and deepseek-v2-236b at ``.reduced()`` (the SSD
   families livened, 60 tokens: a ragged last chunk), one fp32 step on
   the same weights and batch on the card and the CPU: loss and every
   gradient leaf within 1e-4 rel-L2; then on the card the reduced
   mamba2's ``remat="full"`` and the reduced yi-6b's and DIT_IMAGE's
   ``remat="selective"`` gradients equal to ``"none"``'s bit for bit;
   ``training/compression.py`` (int8, topk) on the reduced yi-6b's
   gradients, card vs CPU: equal payload bytes, leaves within 1e-4
   rel-L2 (each side's own gradients: the elements flipped across an
   int8 rounding or the top-k threshold counted and printed, the rest
   held); ``ResilientTrainer``'s crash at step 5 of 8 and restart,
   weights and AdamW moments equal to the uninterrupted run's.
17. gfc: the group-free collective realizations and the sharding layer:
   the group-setup twin's table (``repro_torch.benchmarks.group_setup``:
   cold capture, hit bind, GFC registration p50/p99, warm call, and
   ``dist.new_group([0])`` + the first all_reduce under nccl at world
   size 1); the executable cache's every op at group sizes 2, 4 and 8 on
   (1024,) fp32 and DIT_IMAGE's K/V shard (1, 1024, 24, 64) in fp32 and
   bf16, each a captured CUDA graph held to a loop over the shards
   (gather and all-to-all exact, reduce within 1e-6 rel-L2 in fp32 and
   one ulp in bf16); the grouped ops at world 8 over 50 memberships, one
   capture per op; ``flash_decode`` on 4 gloo processes sharing the card
   at yi-6b's width (cache (4, 32768, 4, 128) fp32) against the
   unsharded plain decode within 1e-5, cache shards equal; one
   ``make_serve_step(sp_decode=True)`` step of yi-6b (4 of 32 layers,
   fp32) under a 1x1 mesh against the plain step within 1e-5.
18. dryrun: the multi-pod dry run (``python -m
   repro_torch.launch.dryrun``, CPU processes, eight at a time, each a
   ``FakeStore`` process group of its mesh: nothing on the card): (a)
   every live arch x shape cell at 16x16 without extraction, each must
   trace ``ok``; its per-rank peak is printed beside the card's
   ``total_memory`` (a prediction, not a measurement); (b) the JAX
   harness's two cells, yi-6b train_4k and mixtral-8x7b decode_32k, at
   16x16 and 2x16x16 with extraction: the train cell's 16x16 FLOPs above
   1e15 and its collectives present, the decode cell's peak above 0;
   (c) at a 1x1 mesh the dry run predicts the peak of three steps that
   then run on the card (mamba2-1.3b train at full depth, yi-6b train at
   4 of 32 layers, both bf16 AdamW on 2 x 2048 tokens without remat;
   mamba2-1.3b's bf16 prefill of 4 x 2048): each prediction within 10%
   of ``torch.cuda.max_memory_allocated()`` over the step less what was
   allocated before its model was built, the ratio printed; (d) K4's
   backward scratch, ``ops.ssd_bwd_scratch``, equal to the library's
   ``gfdit_ssd_bwd_scratch`` at every K4 shape of the kernels phase.
   Each dry-run process's JSON is left in ``build/dryrun/``.
19. bench: the twins of ``benchmarks/`` (``repro_torch.benchmarks``),
   results in ``build/bench/``: (a) ``sim_fidelity``'s Fig. 11 leg at
   DIT_IMAGE's full width and depth, 12 requests of 4 steps (classes S
   and M at 512 and 1024 px) on one rank under fcfs-sp1, srtf-sp1 and
   edf, stage costs measured on the card, then replayed on the simulator
   with the costs the real run calibrated: every request completes on
   both, K1 and K2 launch; SLO attainment, its gap in pp and mean
   latencies printed; (b) ``policies_e2e``'s cache slice with its pixel
   probe on the card (K1-K3), held to ``check_cache``; (c) ``roofline``
   over the dryrun phase's 34 cells with the H100's constants; (d) the
   six host-only twins, each in a process of its own during (b) and (c).
   Every row prints with the card's name and power limit.

Kernel times (phase 3): ``ms`` is device time, from CUDA-event timing of
replays of a CUDA graph that holds ``iters`` calls, so it leaves out the
host cost of each launch; ``call_ms`` is the same calls made eagerly from
Python between two events, what a Python caller pays per call; ``host_us``
is the host's cost of one wrapper call (many calls, no synchronise).  The
library call is timed both ways too.

The line before the last is the ``kernels`` JSON summary (K1-K3 carry
their DIT_VIDEO case and its launches under ``video``, K2, K4 and K4's
backward their LM cases under the model's name; the backward kernels'
launches are the train phase's, K1's, K2's and K4's forward launches
there ``train_launches``; K2's forward is listed by dtype and route,
``attention fp32`` and ``attention bf16`` (the tensor-core tile kernel,
timed at DIT_IMAGE's self-attention) and ``attention fp32 split`` and
``attention bf16 split`` (split keys and the combine, timed at the 512
px self shard in fp32, whisper's decode step in bf16 and fp32 beside
it), counted by ``ops.kernel_launches``: fp32's routes in the serve,
scenarios and video phases' DiT serving and whisper's fp32 prefill +
decode in the zoo phase, bf16's from whisper's bf16 serve; K4's
forward and backward on bf16 operands are listed as ``ssd bf16`` and
``ssd_bwd bf16`` (the tensor-core stage kernels, timed at mamba2-1.3b's
prefill and training shapes), their launches those of the ``ssd_bf16``
legs of the lm, hybrid and train phases, counted by dtype in
``ops.kernel_launches``; the script fails if any listed kernel was
never launched);
the last line
is ``{"ok": true, "device": {...}}``.  Exits 2 without CUDA.

    python3 chip_smoke.py --kernels-only [--src DIR] [--json FILE]

runs phases 1-3 only, importing ``repro_torch`` from ``DIR`` (default:
``src`` beside this script; another checkout's ``src`` times that tree's
kernels with this script's timing) and writing every timed case to FILE.

    python3 chip_smoke.py --fp32-grad [--src DIR]

runs phases 1-2 and the train phase's fp32 DIT_IMAGE gradient through
DIR's kernels; it prints the values it gates before it gates them, so
run on the tree whose fp32 backward ran on the CUDA cores it records
``CUDA_CORE_DIT_FP32``, and thereafter reproduces it.

    python3 chip_smoke.py --phase bench [--phase train ...]

runs phases 1-2 and the named ones (serve, splits, scenarios, failure,
video, ssd, lm, hybrid, zoo, train, train-cpu, gfc, dryrun, bench), in
the order given,
and prints neither the kernels line nor the last line.  ``splits`` (run
by name only) times fp32 K2 and K3 at the main path's short query grids
in 1 to 8 key pieces, each held to its plain version: the measurement
behind the library's split rule.  ``ssd`` (run by name only) runs the
kernels phase's K4 forward and backward checks alone, both dtypes, and
prints, per dtype, a digest of the forward's outputs (y, the final
state) and one of the backward's five gradients on a scratch built by
the plain version, on fixed inputs, so that ``--phase ssd --src DIR``
times another tree's K4 beside this one's and shows which of the four
digests two trees share.  ``failure`` (run by name only) serves
the failure demo ten times as the scenarios phase does and prints, per
wall attempt, how far the host kill landed from the edges of denoise
step 3 (the scenarios phase prints the same for its one run).
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import re
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F


def _src_dir() -> Path:
    """``--src DIR`` if given (read before the imports below), else the
    ``src`` beside this script."""
    if "--src" in sys.argv[1:-1]:
        return Path(sys.argv[sys.argv.index("--src") + 1]).resolve()
    return Path(__file__).resolve().parent / "src"


sys.path.insert(0, str(_src_dir()))

from repro_torch.benchmarks import group_setup  # noqa: E402
from repro_torch.configs import ASSIGNED_ARCHS, get_config  # noqa: E402
from repro_torch.configs.dit_models import DIT_IMAGE, DIT_VIDEO  # noqa: E402
from repro_torch.core.executable_cache import (  # noqa: E402
    ExecutableCache, dtype_name)
from repro_torch.core.gfc import GroupFreeComm  # noqa: E402
from repro_torch.core.grouped import build_grouped_ops  # noqa: E402
from repro_torch.core.scheduler import Decision, Policy  # noqa: E402
from repro_torch.core.trajectory import ExecutionLayout, Request  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.models import (dit, get_model, hybrid, layers, ssm,  # noqa: E402
                                text_encoder)
from repro_torch.serving import serve_loop  # noqa: E402
from repro_torch.sharding import SERVE_RULES, activation_sharding  # noqa: E402
from repro_torch.training import (compression, fault_tolerance,  # noqa: E402
                                  optimizer, train_loop)
from repro_torch.training.data import TokenPipeline  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

def _own_module(name: str, rel: str):
    """A module of this script's own checkout, loaded by path, so that a
    ``--src`` run prices both trees with the same counts."""
    path = Path(__file__).resolve().parent / rel
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


#: the kernels' operation and byte counts (repro_torch.kernels.cost)
cost = _own_module("gfdit_cost", "src/repro_torch/kernels/cost.py")

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12           # CUDA cores (fp32 outside the tensor cores)
TF32_FLOPS_PER_S = 494.7e12        # tensor cores, TF32 inputs
BF16_FLOPS_PER_S = 989e12          # tensor cores, the peak for bf16 inputs
BUDGET = {torch.float32: 1e-5, torch.bfloat16: 3e-2}   # DESIGN.md §12
# K4 vs the sequential recurrence: two summation orders over 2048 steps,
# the JAX package's own kernel vs sequential bound (tests/test_kernels.py)
SSD_BUDGET = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# K4's backward: fp32 tightened below the forward's 1e-4, since one TF32
# product a product (not split) keeps dA within 9.9e-5 at mamba2-1.3b's
# (p, n, chunk); split-TF32 keeps every output under 2.3e-6 (both in
# closed form: tests/test_torch_ssd_grads.py, SSD_BWD_FP32_BUDGET)
SSD_BWD_BUDGET = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
SSD_BWD_OUTPUTS = ("dx", "ddt", "dA", "dB", "dC")
PIXEL_BUDGET = 1e-4                # rel-L2 on decoded pixels
MAMBA = get_config("mamba2-1.3b")
LM_BATCH, LM_PROMPT, LM_DECODE = 4, 2048, 32
LOGIT_BUDGET = 1e-3                # of the largest |logit|, fp32 decode
LM_CPU_BUDGET = 1e-4               # rel-L2 on logits, card vs CPU
ZAMBA = get_config("zamba2-7b")
YI = get_config("yi-6b")
# the zoo phase: whisper-medium at full width and depth; mixtral-8x7b and
# deepseek-v2-236b at full width, cut in depth to fit the card's 80 GB in
# fp32 (4 of 32 layers: 24.3 GB; the dense prefix layer + 2 MoE layers of
# 60: 37.3 GB)
WHISPER = get_config("whisper-medium")
MIXTRAL = get_config("mixtral-8x7b").with_(num_layers=4)
DEEPSEEK = get_config("deepseek-v2-236b").with_(num_layers=3)
ZOO_BATCH, ZOO_PROMPT = 4, 4          # whisper: 4 x (1500 frames + 4 tokens)
# fp32 decode vs forward where the forward's MoE capacity is exact
# (tokens x top_k <= 4096): mixtral 1032 x 2, deepseek 632 x 6
EXACT_PROMPT = {"mixtral-8x7b": 1000, "deepseek-v2-236b": 600}
ZOO_LOGIT_BUDGET = 5e-4            # of the largest |logit|, fp32 decode
MLA_BUDGET = 1e-5                  # absorbed vs naive decode, fp32
DIT_KERNELS = ("fused_adaln", "attention", "splice_attention")
# the fp32 products' GEMM at the benchmark cells' product shapes (m, n, k):
# video-l's (18,480 tokens; q/k/v/o and cross q/o, the SwiGLU's gate and
# up, its down) and image-interactive's at 512 px (q/k/v/o, gate and up)
GEMM_SHAPES = {"video q/k/v/o": (18480, 3072, 3072),
               "video gate/up": (18480, 14336, 3072),
               "video down": (18480, 3072, 14336),
               "image q/k/v/o": (1024, 1536, 1536),
               "image gate/up": (1024, 8960, 1536)}
TEXT_TOKENS = 77
# the video phase: the paper's class S (480x832, 49 frames: 13 latent
# frames, 20,280 tokens) and leg (b)'s 17 frames (5 latent frames, 7,800
# tokens), both at 2 denoise steps
VIDEO_S, VIDEO_HIT, VIDEO_STEPS = (480, 832, 49), (480, 832, 17), 2
# the train phase: DIT_IMAGE at full width and depth, flow matching on one
# synthetic batch (2 x 64x64 latents = 1024 tokens, 64 text tokens), bf16
# as JAX's loss_fn runs it; yi-6b at full width, 4 of 32 layers, 2 x 2048
# tokens from the TokenPipeline
TRAIN_LR = 3e-4                    # JAX's make_train_step default (yi-6b)
# the DiT's: at 3e-4 the full-width loss rises 2.34 -> 7.20 after the
# first AdamW step and oscillates; 3e-5 is the largest of 3e-4, 1e-4,
# 3e-5, 1e-5 at which it falls at every one of the five steps (measured
# on an H100, PERF.md section 6).  JAX's make_train_step rises alike at
# full width with the depth cut (tests/dit_lr_witness.py)
DIT_TRAIN_LR = 3e-5
DIT_TRAIN_BATCH, DIT_TRAIN_STEPS = 2, 5
YI_TRAIN = YI.with_(num_layers=4)
YI_TRAIN_BATCH, YI_TRAIN_SEQ, YI_TRAIN_STEPS = 2, 2048, 3
# the SSD families train as yi-6b does: mamba2-1.3b at full width and
# depth, zamba2-7b at full width, 12 of 81 layers (two groups of six, so
# the shared block's gradient sums two sites), cut as yi-6b so that fp32
# weights, gradients and AdamW's moments fit the card's 80 GB
ZAMBA_TRAIN = ZAMBA.with_(num_layers=12)
# the train paths the card had not run: whisper-medium at full width and
# depth (YI_TRAIN_BATCH x YI_TRAIN_SEQ decoder tokens from the
# TokenPipeline, each sequence with its 1500 frames); mixtral-8x7b at full
# width with the most layers whose dry-run peak at a 1x1 mesh stays under
# TRAIN_PEAK_LIMIT (launch/dryrun.py: 52.7 GiB at 2 layers, 74.3 GiB at 3;
# fp32 AdamW holds 16 bytes a parameter, ~1.41 B a layer in experts)
TRAIN_PEAK_LIMIT = 70 * 2**30
MIXTRAL_TRAIN = get_config("mixtral-8x7b").with_(num_layers=2)
# the dry run's predicted peaks for MIXTRAL_TRAIN and one layer more
# (the _DRYRUN_PEAKS cases)
MIXTRAL_PEAK_CASES = tuple(
    (f"mixtral-8x7b train {n} layers", "mixtral-8x7b", n, "train",
     YI_TRAIN_BATCH, YI_TRAIN_SEQ)
    for n in (MIXTRAL_TRAIN.num_layers, MIXTRAL_TRAIN.num_layers + 1))
COMPRESSIONS = ("int8", "topk")    # training/compression.py's methods
CRASH_STEPS, CRASH_AT, CRASH_SAVE_EVERY = 8, 5, 2   # ResilientTrainer leg
# the five DIT_IMAGE losses with K2's backward on the CUDA cores (fp32
# arithmetic on bf16 operands; PERF.md section 6); with the tensor-core
# kernels, which round P and dS to bf16, each must stay within the bf16
# budget of these
CUDA_CORE_DIT_LOSSES = (2.31661, 2.16704, 1.98995, 1.81137, 1.67245)
LOSS_BUDGET = 3e-2
# the three bf16 losses of mamba2-1.3b and of zamba2-7b at 12 layers with
# K4's backward on the CUDA cores (PERF.md section 6); with the
# split-TF32 kernels each must stay within LOSS_BUDGET of these
CUDA_CORE_SSD_LOSSES = {"mamba2-1.3b": (11.3036, 11.3350, 11.3332),
                        "zamba2-7b": (10.9003, 10.8589, 10.9267)}
# one fp32 DIT_IMAGE gradient on the train phase's livened weights and
# batch with K2's fp32 backward on the CUDA cores (``--fp32-grad --src``
# of that tree, on an H100 80GB HBM3; PERF.md section 6): its loss, and by
# group (``_grad_probes``) its norm and FP32_PROBES seeded projections;
# the split-TF32 kernels must give each within the fp32 budget
CUDA_CORE_DIT_FP32 = dict(loss=2.3167552947998047, probes={
    "all": (1.0618573512033176, (
        -0.5436788542289479, -0.42053053353220793, 2.000046497365971,
        2.1315536003133624, -0.0042045412456677145, -0.3988950094774549,
        0.6229518167868969, 0.7228904420411484)),
    "qkv": (0.46566527802847857, (
        0.8324628138519293, -0.1723280761095161, 0.7193572710069223,
        0.08646574567560353, 0.23783361394478286, -0.025197524184553996,
        0.9665144097781553, -0.3727531571245166))})
FP32_PROBES = 8
GRAD_CPU_BUDGET = 1e-4             # rel-L2 per gradient leaf, card vs CPU
BWD_KERNELS = ("attention_bwd", "fused_adaln_bwd", "ssd_bwd")
#: K2's forward routes (ops.kernel_launches) by dtype
FP32_ROUTES = ("attention fp32", "attention fp32 split")
BF16_ROUTES = ("attention bf16", "attention bf16 split")
SOURCES = {
    "fused_adaln": ("src/repro_torch/csrc/adaln.cu",
                    "src/repro/kernels/adaln.py:66"),
    "attention": ("src/repro_torch/csrc/attention.cu",
                  "src/repro/kernels/flash_attention.py:82"),
    "splice_attention": ("src/repro_torch/csrc/attention.cu",
                         "src/repro/kernels/splice.py:78"),
    # K2's (and K3's) forward on the tensor cores by dtype: the tile
    # kernel alone, and split keys (the tile kernel over key pieces + the
    # combine); their launches are ops.kernel_launches' routes
    "attention fp32": ("src/repro_torch/csrc/attention.cu",
                       "src/repro/kernels/flash_attention.py:82"),
    "attention fp32 split": ("src/repro_torch/csrc/attention.cu",
                             "src/repro/kernels/flash_attention.py:82"),
    "attention bf16": ("src/repro_torch/csrc/attention.cu",
                       "src/repro/kernels/flash_attention.py:82"),
    "attention bf16 split": ("src/repro_torch/csrc/attention.cu",
                             "src/repro/kernels/flash_attention.py:82"),
    "ssd": ("src/repro_torch/csrc/ssd.cu", "src/repro/kernels/ssd.py:65"),
    # K4's forward and backward on bf16 operands (intra_dtype="bfloat16",
    # the ssd_bf16 legs): the tensor-core stage kernels, counted by dtype
    # in ops.kernel_launches
    "ssd bf16": ("src/repro_torch/csrc/ssd.cu",
                 "src/repro/kernels/ssd.py:65"),
    # the backward kernels of K2, K1 and K4 (the TPU kernels have none)
    "attention_bwd": ("src/repro_torch/csrc/attention_bwd.cu",
                      "src/repro/kernels/flash_attention.py:82"),
    "fused_adaln_bwd": ("src/repro_torch/csrc/adaln.cu",
                        "src/repro/kernels/adaln.py:66"),
    "ssd_bwd": ("src/repro_torch/csrc/ssd_bwd.cu",
                "src/repro/kernels/ssd.py:65"),
    "ssd_bwd bf16": ("src/repro_torch/csrc/ssd_bwd.cu",
                     "src/repro/kernels/ssd.py:65"),
    # the fp32 products (the TPU package has no product kernel: XLA's)
    "linear": ("src/repro_torch/csrc/gemm.cu", "none: XLA's dot"),
}


class FixedSP(Policy):
    """Encode/decode on one rank, every denoise step on ``k`` ranks."""
    name = "fixed-sp"

    def __init__(self, k):
        self.k = k

    def schedule(self, view):
        out, free = [], list(view.free_ranks)
        for t, req, g in sorted(view.ready, key=lambda x: x[0].id):
            k = 1 if t.kind in ("encode", "decode") else self.k
            if len(free) < k:
                break
            out.append(Decision(t.id, ExecutionLayout(tuple(free[:k]))))
            free = free[k:]
        return out


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def call_ms(fn, iters: int = 20) -> float:
    """Mean time of ``iters`` eager Python calls of ``fn`` between two
    CUDA events, after warm-up: the device time, or the host's cost of
    enqueueing the calls where that is longer (inputs stay warm in L2, as
    on the serving path)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, replays: int = 10) -> float:
    """Device time of one call of ``fn``: ``iters`` calls are captured in
    one CUDA graph (after a warm-up on a side stream) and ``replays``
    back-to-back replays are timed with CUDA events, so no per-call host
    work is counted.  Fails unless a replay rewrites the captured output
    (a launch that escaped the capture would leave it as it was)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            out = fn()
    out = out[0] if isinstance(out, tuple) else out
    graph.replay()
    torch.cuda.synchronize()
    want = out.clone()
    out.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise AssertionError("a graph replay did not rewrite its output")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * iters)


def profiled_ms(fn, calls: int = 10) -> float:
    """Device ms of one call of ``fn``: every device activity (kernels,
    memsets, copies) of ``calls`` calls under ``torch.profiler``, after a
    warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages())
    return total / calls / 1e3


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds per call of ``fn`` over ``calls`` calls with no
    synchronise between them (the device runs behind; keep calls x device
    time short enough that the launch queue never fills)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def bound_ms(nbytes: float, flops: float,
             flops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, TF32 off", flush=True)
    return smi


# the fp32 serving paths' instantiations (DIT_IMAGE's d_model 1536 and
# head dim 64, zamba2-7b's head dim 112, DIT_VIDEO's 3072 and 128), by
# their mangled-name prefixes
WATCHED = {"attn_mma_kernel<float, 64>": "_ZN5gfdit15attn_mma_kernelIfLi64E",
           "attn_mma_kernel<float, 112>":
               "_ZN5gfdit15attn_mma_kernelIfLi112E",
           "attn_mma_kernel<float, 128>":
               "_ZN5gfdit15attn_mma_kernelIfLi128E",
           "adaln_kernel<float, float4 x 12>":
               "_ZN5gfdit12adaln_kernelIfLi4ELi12E",
           "adaln_kernel<float, float4 x 24>":
               "_ZN5gfdit12adaln_kernelIfLi4ELi24E"}


def ptxas_report(log: str) -> dict:
    """Per compiled kernel (mangled name): registers, spill bytes (stores
    + loads) and stack frame bytes, from ``nvcc -Xptxas -v``."""
    out, fn = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
            out[fn] = {"registers": None, "spill_bytes": 0, "stack": 0}
        elif fn and "bytes stack frame" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split()
                    if w.isdigit()]
            out[fn]["stack"], out[fn]["spill_bytes"] = nums[0], nums[1] + nums[2]
        elif fn and "Used" in ln and "registers" in ln:
            out[fn]["registers"] = int(ln.split("Used")[1].split()[0])
    return out


def phase_build() -> None:
    """Build and load the kernels; ptxas's full report (registers, shared
    memory, spills) is written beside the library as a ``.log`` file.
    Prints every kernel that spills and the DiT path's instantiations."""
    t0 = time.perf_counter()
    build.load()
    seconds = time.perf_counter() - t0
    # a library built by an earlier process: its report beside it
    log = build.library_path().with_suffix(".log")
    report = ptxas_report(build.build_info.get("ptxas") or (
        log.read_text() if log.exists() else ""))
    spills = sorted(f for f, r in report.items() if r["spill_bytes"])
    print(f"build: {seconds:.1f} s ({build.build_info.get('seconds', 0):.1f} s"
          f" nvcc), {len(report)} kernels, {len(spills)} spill (report in "
          f"{build.BUILD_DIR}/libgfdit-*.log)", flush=True)
    for f in spills:
        print(f"  spills: {f} {report[f]}", flush=True)
    for label, prefix in WATCHED.items():
        hits = [r for f, r in report.items() if f.startswith(prefix)]
        if hits:
            regs = sorted({r["registers"] for r in hits})
            spill = max(r["spill_bytes"] for r in hits)
            print(f"  {label}: {len(hits)} instantiation(s), registers "
                  f"{regs}, spill bytes {spill}", flush=True)
    _report_attention_fwd(report)
    _report_attention_bwd(report)
    _report_adaln_bwd(report)
    _report_ssd(report)
    _report_gemm(report, build.build_info.get("ptxas") or (
        log.read_text() if log.exists() else ""))


def _report_gemm(report: dict, log: str) -> None:
    """The GEMM kernel at each tile height: registers and spill bytes
    (ptxas); and every warning ptxas gave on ``gemm.cu`` (a serialized
    wgmma among them)."""
    for rows in ops.GEMM_TILE_ROWS:
        r = next((r for f, r in report.items()
                  if f"gemm_3xtf32_kernelILi{rows}E" in f), None)
        print(f"  gemm_3xtf32_kernel<{rows}>: "
              f"{'?' if r is None else r['registers']} registers, spill "
              f"bytes {'?' if r is None else r['spill_bytes']}", flush=True)
    section = log.split("== gemm.cu", 1)[-1].split("\n== ", 1)[0] \
        if "== gemm.cu" in log else ""
    for line in section.splitlines():
        if "arning" in line:
            print(f"  gemm.cu ptxas: {line.strip()}", flush=True)


def _report_ssd(report: dict) -> None:
    """K4's forward and backward stage kernels: registers and spill bytes
    (ptxas) of the tensor-core kernels (``*_mma``, both dtypes) at every
    (p, n, chunk) and of the others at (64, 128, 128) and (64, 64, 128);
    then, at mamba2-1.3b's and zamba2-7b's prefill and training shapes,
    every stage's threads, shared bytes and blocks an SM in both dtypes
    (the occupancy calculator)."""
    for f in sorted(report):
        m = re.match(r"_ZN5gfdit(\d+)", f)
        name = f[m.end():m.end() + int(m[1])] if m else f
        if not name.startswith("ssd"):
            continue
        dt = "bf16" if "bfloat" in f else "fp32"
        shape = tuple(int(v) for v in re.findall(r"Li(\d+)E", f))
        if name.endswith("_mma") or any(
                f"Li{n}ELi128E" in f and (f"Li64ELi{n}ELi128E" in f
                                          or name == "ssd_bwd_sum")
                for n in (128, 64)):
            print(f"  {name}<{dt}, {shape}>: {report[f]}", flush=True)
    for cfg in (MAMBA, ZAMBA):
        _, h, _ = ssm.ssm_dims(cfg)
        p, n, c = cfg.ssm.head_dim, cfg.ssm.state_dim, cfg.ssm.chunk
        for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            for what, occ in (
                    ("ssd", ops.ssd_occupancy(LM_BATCH, LM_PROMPT, h, p, n,
                                              c, dtype)),
                    ("ssd_bwd", ops.ssd_bwd_occupancy(
                        YI_TRAIN_BATCH, YI_TRAIN_SEQ, h, p, n, c, dtype))):
                print(f"  {what} {tag} {cfg.name}: " + "; ".join(
                    f"{k} {v[3] if len(v) > 3 else 256} threads, "
                    f"{v[1] / 1024:.2f} KiB shared, {v[0]} blocks an SM"
                    for k, v in occ.items()), flush=True)


def _report_attention_fwd(report: dict) -> None:
    """K2's forward kernels: the tensor-core tile kernel at every head
    dim in both dtypes (registers and spill bytes from ptxas, shared
    bytes and resident blocks an SM from the occupancy calculator) and
    the split-key combine kernels (registers, spill bytes)."""
    for dtype, code in ((torch.float32, "f"),
                        (torch.bfloat16, "13__nv_bfloat16")):
        for d in ops.HEAD_DIMS:
            blocks, smem = ops.attention_occupancy(d, dtype)
            r = next((r for f, r in report.items() if
                      f.startswith(f"_ZN5gfdit15attn_mma_kernelI{code}Li{d}E")),
                     None)
            regs = "?" if r is None else r["registers"]
            spill = "?" if r is None else r["spill_bytes"]
            print(f"  attn_mma_kernel<{str(dtype)[6:]}, {d}>: {regs} "
                  f"registers, spill bytes {spill}, {smem / 1024:.2f} KiB "
                  f"shared, {blocks} blocks an SM", flush=True)
    for f, r in sorted(report.items()):
        if f.startswith("_ZN5gfdit19attn_combine_kernel"):
            print(f"  {f}: {r['registers']} registers, spill bytes "
                  f"{r['spill_bytes']}", flush=True)


def _report_attention_bwd(report: dict) -> None:
    """K2's backward kernels: registers and spill bytes (ptxas), shared
    bytes and resident blocks an SM (the occupancy calculator), for every
    fp32 (split-TF32) instantiation and for bf16 at the training path's
    head dims (64: the DiT, 128: yi-6b)."""
    kernels = ("attn_bwd_dkdv_mma_kernel", "attn_bwd_dq_mma_kernel")
    for dtype, code, dims in ((torch.float32, "f", ops.HEAD_DIMS),
                              (torch.bfloat16, "13__nv_bfloat16", (64, 128))):
        for d in dims:
            occ = ops.attention_bwd_occupancy(d, dtype)
            parts = []
            for kernel, (blocks, smem) in zip(kernels, occ.values()):
                prefix = f"_ZN5gfdit{len(kernel)}{kernel}I{code}Li{d}E"
                r = next((r for f, r in report.items()
                          if f.startswith(prefix)), None)
                regs = "?" if r is None else r["registers"]
                spill = "?" if r is None else r["spill_bytes"]
                parts.append(f"{kernel}<{d}> {regs} registers, spill bytes "
                             f"{spill}, {smem / 1024:.2f} KiB shared, "
                             f"{blocks} blocks an SM")
            print(f"  attention_bwd {str(dtype)[6:]} d={d}: "
                  + "; ".join(parts), flush=True)


ADALN_BWD_VARIANTS = {"ln": (1, 0, 0), "mod_norm": (1, 1, 0),
                      "gated_residual": (0, 0, 1), "full": (1, 1, 1)}


def _report_adaln_bwd(report: dict) -> None:
    """K1's backward row kernel at DIT_IMAGE's width, every variant the
    kernels phase times: registers and spill bytes (ptxas) and its plan
    (``ops.adaln_bwd_plan``) at the training shape (2, 1024, 1536) with
    the resident blocks an SM (the occupancy calculator)."""
    pat = re.compile(r"_ZN5gfdit16adaln_bwd_kernelI(f|13__nv_bfloat16)"
                     r"((?:Li\d+E)+)Lb([01])ELb([01])ELb([01])E")
    d = DIT_IMAGE.d_model
    for dtype, code in ((torch.float32, "f"), (torch.bfloat16,
                                              "13__nv_bfloat16")):
        for vname, (ln, mod, gated) in ADALN_BWD_VARIANTS.items():
            plan = ops.adaln_bwd_plan(DIT_TRAIN_BATCH, 1024, d, ln=ln,
                                      mod=mod, gated=gated, dtype=dtype)
            want = (4 if dtype == torch.float32 else 8,
                    plan["vectors_a_lane"])
            hits = [(f, r) for f, r in report.items()
                    if (m := pat.match(f)) and m[1] == code
                    and tuple(int(i) for i in re.findall(r"\d+", m[2]))
                    == want and (int(m[3]), int(m[4]), int(m[5]))
                    == (ln, mod, gated)]
            regs = ", ".join(f"{r['registers']} registers, spill bytes "
                             f"{r['spill_bytes']}" for _, r in hits) or "?"
            print(f"  adaln_bwd {str(dtype)[6:]} {vname} d={d}: {regs}; "
                  f"plan {plan}", flush=True)


def _rand(shape, dtype, gen, scale=1.0):
    return (scale * torch.randn(shape, generator=gen, device="cuda")).to(dtype)


def _check(label, kernel, plain, dtype, results, timing=None, budget=BUDGET,
           l2=False, names=None):
    """Kernel against plain version: max abs error over max |plain| (or,
    with ``l2``, the rel-L2 error), per output (a kernel may return a
    tuple; None entries must match), within ``budget[dtype]``; with
    ``names`` (one a tuple output) each output's error is printed."""
    out_k, out_p = kernel(), plain()
    torch.cuda.synchronize()
    if not isinstance(out_k, tuple):
        out_k, out_p = (out_k,), (out_p,)
    diff = rel = 0.0
    each = []
    for k_, p_ in zip(out_k, out_p):
        if k_ is None or p_ is None:
            if (k_ is None) != (p_ is None):
                raise AssertionError(f"{label}: outputs present differ")
            continue
        d = (k_.float() - p_.float()).abs().max().item()
        diff = max(diff, d)
        if l2:
            r = ((k_.float() - p_.float()).norm()
                 / p_.float().norm().clamp_min(1e-30)).item()
        else:
            r = d / max(p_.float().abs().max().item(), 1e-30)
        rel = max(rel, r)
        each.append(r)
    ok = all(math.isfinite(r) for r in each) and rel <= budget[dtype]
    line = (f"  {label} {str(dtype)[6:]}: {'rel-L2' if l2 else 'max rel'} "
            f"err {rel:.2e} (budget {budget[dtype]:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
    if names is not None:
        line += " [" + ", ".join(f"{n_} {r:.2e}" for n_, r in
                                 zip(names, each)) + "]"
    if timing is not None:
        # a kernel of tens of ms is timed over fewer calls
        depth = dict(iters=timing.get("iters", 20),
                     replays=timing.get("replays", 10))
        ms, cms = device_ms(kernel, **depth), call_ms(kernel, depth["iters"])
        hus = host_us(kernel, timing.get("host_calls", 1000))
        plain_ms = call_ms(plain, timing.get("plain_iters", 20))
        lib = timing.get("library")
        fwd = timing.get("library_fwd")
        if fwd is not None:
            # a backward alone: (forward + backward) - forward, by the
            # profiler (autograd's backward escapes a CUDA-graph capture)
            lib_ms = profiled_ms(lib) - profiled_ms(fwd)
            lib_cms = call_ms(lib, depth["iters"]) \
                - call_ms(fwd, depth["iters"])
        else:
            lib_ms = device_ms(lib, **depth) if lib is not None else None
            lib_cms = call_ms(lib, depth["iters"]) if lib is not None \
                else None
        b_ms, b_by = bound_ms(timing["bytes"], timing["flops"],
                              timing.get("flops_per_s", FP32_FLOPS_PER_S))

        def fmt(t):
            return "-" if t is None else f"{t:.4f} ms"
        line += (f"; kernel {ms:.4f} ms device, {cms:.4f} ms a call, "
                 f"{hus:.1f} us host; plain {plain_ms:.4f} ms; library "
                 f"{fmt(lib_ms)} device, {fmt(lib_cms)} a call; bound "
                 f"{b_ms:.4f} ms ({b_by})")
        entry = {"max_abs_err": diff, "ms": ms, "call_ms": cms,
                 "host_us": hus, "plain_ms": plain_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": lib_ms,
                 "library_call_ms": lib_cms, "case": label,
                 "dtype": str(dtype)[6:]}
        cc = timing.get("cuda_core")
        if cc is not None:    # fp32 attention: the same work, CUDA cores
            cc_ms, cc_by = bound_ms(*cc)
            entry["cuda_core_bound_ms"] = cc_ms
            line += (f" 3xTF32, the kernel at {b_ms / ms:.3f} of it; "
                     f"CUDA-core bound {cc_ms:.4f} ms ({cc_by}; "
                     f"{cc_ms / ms:.3f})")
        results.setdefault("timed", []).append(entry)
        if timing.get("summary"):
            results[timing["summary"]] = entry
    print(line, flush=True)
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version ({rel:.2e} > {budget[dtype]:.0e})")


def phase_kernels() -> dict:
    """Every kernel against its plain version at the serving shapes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    results: dict = {}
    d_model, heads, hd = DIT_IMAGE.d_model, DIT_IMAGE.num_heads, \
        DIT_IMAGE.head_dim
    print("kernels:", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.finfo(dtype).bits // 8
        fp32 = dtype == torch.float32
        # K1: every adaLN variant at the SP-4 shard (1024) and SP-1 (4096)
        for n in (1024, 4096):
            x = _rand((1, n, d_model), dtype, gen)
            res = _rand((1, n, d_model), dtype, gen)
            sh, sc, g = (_rand((1, d_model), dtype, gen, 0.5)
                         for _ in range(3))
            variants = {
                "mod_norm": dict(shift=sh, scale=sc),
                "ln": dict(),
                "gated_residual": dict(gate=g, residual=res, ln=False),
                "full": dict(shift=sh, scale=sc, gate=g, residual=res),
            }
            for vname, kw in variants.items():
                timing = None
                if n == 1024 or vname == "mod_norm":
                    flops, nbytes = cost.adaln(
                        1, n, d_model, ln=kw.get("ln", True),
                        mod="shift" in kw, gated="gate" in kw, es=es)
                    timing = {"bytes": nbytes, "flops": flops}
                    if vname == "mod_norm":
                        w, b = (1.0 + sc[0]).contiguous(), sh[0].contiguous()
                        timing["library"] = (
                            lambda x=x, w=w, b=b: F.layer_norm(
                                x, (d_model,), w, b, eps=1e-6))
                        if fp32 and n == 1024:
                            timing["summary"] = "fused_adaln"
                    elif vname == "gated_residual":   # the DiT's residuals
                        timing["library"] = (
                            lambda x=x, g=g, res=res: res + g[:, None] * x)
                        timing["summary"] = ("fused_adaln gated_residual"
                                             + ("" if fp32 else " bf16"))
                _check(f"adaln {vname} N={n} D={d_model}",
                       lambda x=x, kw=kw: ops.fused_adaln(x, **kw),
                       lambda x=x, kw=kw: ref.adaln_ref(x, **kw),
                       dtype, results, timing)
        # K2: the SP-4 self-attention shard over the gathered K/V, the
        # cross-attention to 77 text tokens, the text encoder (d=256), a
        # causal case and a GQA case
        cases = [
            ("self", (1, 1024, heads, hd), (1, 4096, heads, hd), False),
            ("cross Lt=77", (1, 1024, heads, hd), (1, 77, heads, hd), False),
            ("text-encoder d=256", (1, 77, 4, 256), (1, 77, 4, 256), False),
            ("causal", (1, 1024, heads, hd), (1, 1024, heads, hd), True),
            ("gqa H=24 KV=6", (1, 1000, heads, hd), (1, 1000, 6, hd), False),
        ]
        blocks, smem = ops.attention_occupancy(hd, dtype)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        grid = -(-1024 // 64) * heads
        print(f"  attention{'' if fp32 else ' bf16'} occupancy d={hd}: "
              f"{grid} blocks of 128 threads at Sq=1024, {blocks} "
              f"resident per SM ({smem / 1024:.1f} KB shared memory "
              f"each), {sms} SMs: {grid / (blocks * sms):.2f} waves",
              flush=True)
        results["attention_occupancy" + ("" if fp32 else " bf16")] = {
            "blocks_per_sm": blocks, "smem_bytes": smem, "sms": sms,
            "grid": grid}
        for label, qs, ks, causal in cases:
            q, k, v = (_rand(s, dtype, gen) for s in (qs, ks, ks))
            b, sq, h, d = qs
            timing = None
            if label in ("self", "cross Lt=77", "text-encoder d=256"):
                # bound at the dtype's peak (bf16: the tensor cores')
                timing = _attn_timing(q, k, v, sq, ks[1], host_calls=200)
                if label == "self":
                    timing["summary"] = "attention" + ("" if fp32
                                                       else " bf16")
            _check(f"attention {label} q{qs} kv{ks}",
                   lambda q=q, k=k, v=v, c=causal: ops.attention(
                       q, k, v, causal=c),
                   lambda q=q, k=k, v=v, c=causal: ref.attention_ref(
                       q, k, v, causal=c),
                   dtype, results, timing)
        if fp32:      # the fp32 tile route's summary
            results[FP32_ROUTES[0]] = results["attention"]
        # K3: the §11 hit at SP-4 of a 4096-token request, first, a middle
        # and the last shard
        q = _rand((1, 1024, heads, hd), dtype, gen)
        ks_, vs_ = (_rand((1, 4096, heads, hd), dtype, gen) for _ in range(2))
        kf, vf = (_rand((1, 1024, heads, hd), dtype, gen) for _ in range(2))
        for offset in (0, 2048, 3072):
            timing = None
            if offset == 2048:
                flops, nbytes = cost.splice_attention(1, 1024, 4096, heads,
                                                      heads, hd, es)
                timing = {**_attn_bound(flops, nbytes, dtype),
                          "host_calls": 200}
                if fp32:
                    timing["summary"] = "splice_attention"
            _check(f"splice offset={offset} q(1,1024) stale(1,4096)",
                   lambda o=offset: ops.splice_attention(
                       q, ks_, vs_, kf, vf, offset=o),
                   lambda o=offset: ref.splice_attention_ref(
                       q, ks_, vs_, kf, vf, offset=o),
                   dtype, results, timing)
        if fp32:
            _check_dit_512(results, gen)
        _check_ssd(dtype, results)
        _check_ssd_bwd(dtype, results)
        _check_lm_attention(dtype, results, gen)
        _check_whisper_attention(dtype, results, gen)
        _check_backward(dtype, results, gen)
    _check_video(results, gen)
    _check_gemm(results)
    _gemm_counts()
    return results


def _check_gemm(results) -> None:
    """``ops.linear`` at GEMM_SHAPES against the fp32 product (cuBLAS,
    rel-L2 within 1e-5) and the fp64 one, timed beside its bound at 165
    TFLOP/s (the TF32 rate over three products) and ``torch.matmul``'s
    fp32, with the CUDA-core bound beside it."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for rows in ops.GEMM_TILE_ROWS:
        blocks, smem = ops.gemm_occupancy(rows)
        print(f"  gemm_3xtf32_kernel<{rows}>: {smem / 1024:.2f} KiB shared, "
              f"{blocks} blocks an SM", flush=True)
    for label, (m, n, k) in GEMM_SHAPES.items():
        x = _rand((m, k), torch.float32, gen)
        w = _rand((k, n), torch.float32, gen, k ** -0.5)
        flops, nbytes = cost.gemm(m, n, k)
        rows = ops.gemm_tile_rows(m, n, sms)
        big = m > 4096       # video: ~20-60 ms a call, 1-4 GB an output
        timing = {"bytes": nbytes, "flops": flops,
                  "flops_per_s": TF32_FLOPS_PER_S / 3,
                  "cuda_core": (nbytes, flops),
                  "library": lambda x=x, w=w: torch.matmul(x, w),
                  "iters": 3 if big else 20, "replays": 3 if big else 10,
                  "plain_iters": 3 if big else 20,
                  "host_calls": 10 if big else 200,
                  "summary": {"image q/k/v/o": "linear",
                              "video q/k/v/o": "video linear"}.get(
                                  label, f"linear {label}")}
        _check(f"gemm {label} ({m}x{k} @ {k}x{n}, {rows}-row tiles)",
               lambda x=x, w=w: ops.linear(x, w),
               lambda x=x, w=w: ref.linear_ref(x, w), torch.float32,
               results, timing, l2=True)
        exact = x.double() @ w.double()
        err = ((ops.linear(x, w).double() - exact).norm()
               / exact.norm()).item()
        lib = ((torch.matmul(x, w).double() - exact).norm()
               / exact.norm()).item()
        print(f"    against fp64: kernel rel-L2 {err:.2e}, cuBLAS fp32 "
              f"{lib:.2e}", flush=True)
        if not err <= BUDGET[torch.float32]:
            raise AssertionError(f"gemm {label}: {err:.2e} from fp64")
        del x, w, exact
        torch.cuda.empty_cache()
    _product_host_us(gen)


def _product_host_us(gen) -> None:
    """Host microseconds a call at image-interactive's q/k/v/o shape of
    ``sharding.ctx.product`` (the rule, then ``ops.linear``), of the rule
    and of ``ops.linear`` alone, and of ``x @ w`` (cuBLAS), and what the
    difference comes to over the products of one 512 px denoise call."""
    from repro_torch.sharding.ctx import product
    m, n, k = GEMM_SHAPES["image q/k/v/o"]
    x = _rand((1, m, k), torch.float32, gen)
    w = _rand((k, n), torch.float32, gen, k ** -0.5)
    us = {"product": host_us(lambda: product(x, w), 200),
          "route": host_us(lambda: ops.product_route(x, w), 1000),
          "linear": host_us(lambda: ops.linear(x, w), 200),
          "x @ w": host_us(lambda: x @ w, 200)}
    layers_ = json.loads((Path(__file__).resolve().parent / "perfbench"
                          / "configs" / "wan2.1-t2v-1.3b.json").read_text())[
        "model"]["num_layers"]
    calls = 12 * layers_ + 6        # dit.forward_sp_tokens' products
    print(f"  host us a call at {m}x{k} @ {k}x{n}: "
          + ", ".join(f"{name} {t:.1f}" for name, t in us.items())
          + f"; over one denoise call's {calls} products: "
          f"at most {(us['product'] - us['x @ w']) * calls / 1e3:.2f} ms "
          f"more host time than x @ w", flush=True)


def _dit_call_products(model, tok_shard, txt_embeds) -> list:
    """(m, k, n) of every product of one ``dit.forward_sp_tokens`` call,
    from the model's weights and the call's operands: the patch
    embedding, the timestep MLP and the text projection; per layer the
    modulation, q, k, v, o, cross q, k, v and o, gate, up and down; the
    final modulation and the output head."""
    b, n = tok_shard.shape[:2]
    rows, text = b * n, b * txt_embeds.shape[1]

    def kn(w, lead=1):
        return math.prod(w.shape[:lead]), math.prod(w.shape[lead:])
    out = [(rows, *kn(model.x_embed)), (b, *kn(model.t_mlp1)),
           (b, *kn(model.t_mlp2)), (text, *kn(model.txt_proj))]
    for blk in model.blocks:
        a, c, mlp = blk.attn, blk.cross, blk.mlp
        out += [(b, *kn(blk.ada_w))]
        out += [(rows, *kn(w)) for w in (a.wq, a.wk, a.wv, c.wq)]
        out += [(text, *kn(c.wk)), (text, *kn(c.wv))]
        out += [(rows, *kn(w, 2)) for w in (a.wo, c.wo)]
        out += [(rows, *kn(w)) for w in (mlp.w_gate, mlp.w_up, mlp.w_down)]
    return out + [(b, *kn(model.final_ada_w)), (rows, *kn(model.final_out))]


def _encoder_call_products(model, tokens) -> list:
    """(m, k, n) of every product of one ``text_encoder.encode`` call:
    per layer q, k, v, o, gate, up and down over the prompt's tokens."""
    rows = tokens.numel()
    out = []
    for blk in model.blocks:
        a, mlp = blk.attn, blk.mlp
        out += [(rows, *kn) for kn in (
            (a.wq.shape[0], math.prod(a.wq.shape[1:])),
            (a.wk.shape[0], math.prod(a.wk.shape[1:])),
            (a.wv.shape[0], math.prod(a.wv.shape[1:])),
            (math.prod(a.wo.shape[:2]), a.wo.shape[2]),
            tuple(mlp.w_gate.shape), tuple(mlp.w_up.shape),
            tuple(mlp.w_down.shape))]
    return out


@contextlib.contextmanager
def _expected_products():
    """While open, tallies the route the product rule gives each product
    of every fp32 ``dit.forward_sp_tokens`` and ``text_encoder.encode``
    call on the card, from the weights and the call's operands (not from
    what ``sharding.ctx.product`` saw): yields a Counter of routes, to
    hold the counters (:func:`_products_seen`) to."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want, lock = collections.Counter(), threading.Lock()
    forward, encode = dit.forward_sp_tokens, text_encoder.encode

    def tally(shapes):
        routes = collections.Counter(
            ops.gemm_route(torch.float32, "cuda", x_shape=(m, k),
                           w_shape=(k, n), sms=sms) for m, k, n in shapes)
        with lock:
            want.update(routes)

    def counted_forward(model, tok_shard, t, txt_embeds, *args, **kw):
        if tok_shard.is_cuda and kw.get("dtype",
                                        torch.float32) == torch.float32:
            tally(_dit_call_products(model, tok_shard, txt_embeds))
        return forward(model, tok_shard, t, txt_embeds, *args, **kw)

    def counted_encode(model, tokens, cfg, dtype=torch.bfloat16):
        if tokens.is_cuda and dtype == torch.float32:
            tally(_encoder_call_products(model, tokens))
        return encode(model, tokens, cfg, dtype=dtype)

    dit.forward_sp_tokens, text_encoder.encode = counted_forward, \
        counted_encode
    try:
        yield want
    finally:
        dit.forward_sp_tokens, text_encoder.encode = forward, encode


def _products_seen() -> dict:
    """The fp32 products on the card since the last reset, by route: the
    GEMM's launches and those left to cuBLAS by reason."""
    return {"gemm": ops.kernel_launches["gemm fp32"],
            **ops.library_products}


def _check_products(label: str, want) -> dict:
    """Holds the products seen since the last reset to ``want`` (from
    :func:`_expected_products`): every product of the DiT and its text
    encoder counted, each on the route the rule gives its shape, the
    GEMM launched at least once, one launch a ``linear`` call."""
    seen = _products_seen()
    expected = {r: want.get(r, 0) for r in seen}
    if seen != expected or seen["gemm"] <= 0 or \
            ops.launches["linear"] != seen["gemm"] or \
            set(want) - set(seen):
        raise AssertionError(f"{label}: fp32 products by route {seen} "
                             f"(linear {ops.launches['linear']}), expected "
                             f"{dict(want)}")
    return seen


def _gemm_counts() -> dict:
    """One denoise call (``dit.forward_sp_tokens``, one rank) of each
    benchmark cell's configuration at full width and depth, as the
    benchmark builds it (``perfbench.harness.port_config``), at the tokens
    of each request class of the cell's traffic: the GEMM's launches and
    the fp32 products left to cuBLAS by reason, printed and held to the
    rule (:func:`_check_products`); the output finite."""
    from perfbench import spec, traffic
    from perfbench.harness import port_config
    root = Path(__file__).resolve().parent
    out = {}
    for work in json.loads((root / "BENCHMARK.json").read_text())[
            "workloads"]:
        cell = spec.load(root, work["name"])
        cfg, m = port_config(cell.config), cell.config["model"]
        gen = torch.Generator(device="cuda").manual_seed(2)
        model = dit.init(cfg, generator=gen, device="cuda")
        dc = cfg.dit
        patch = dc.patch_size ** 2 * dc.in_channels
        txt = torch.randn((1, TEXT_TOKENS, dc.cond_dim), generator=gen,
                          device="cuda")
        t = torch.full((1,), 500.0, device="cuda")
        for tokens in sorted({traffic.token_count(m, c["height"], c["width"],
                                                  c["frames"])
                              for c in cell.mix["classes"].values()}):
            toks = torch.randn((1, tokens, patch), generator=gen,
                               device="cuda")
            ops.reset_launches()
            with _expected_products() as want, torch.inference_mode():
                y = dit.forward_sp_tokens(
                    model, toks, t, txt, cfg, pos_offset=0, n_total=tokens,
                    kv_gather=lambda k, v, i: (k, v))
            torch.cuda.synchronize()
            label = (f"{cell.name}: one denoise call of {cell.config_name} "
                     f"({cfg.num_layers} layers, d_model {cfg.d_model}) at "
                     f"{tokens} tokens")
            print(f"  gemm counts, {label}: {_products_seen()}", flush=True)
            out[f"{cell.name} {tokens}"] = _check_products(label, want)
            if not torch.isfinite(y).all():
                raise AssertionError(f"{label}: output not finite")
            del toks, y
        del model, txt
        torch.cuda.empty_cache()
    return out


def phase_gemm(smi: str) -> None:
    """The kernels phase's GEMM checks alone (``--phase gemm``)."""
    print(f"gemm: on {smi}", flush=True)
    _check_gemm({})
    _gemm_counts()


def _sdpa_backward(q, k, v, do, causal):
    """SDPA (heads first) on K2's inputs: (forward + backward through
    autograd, the forward alone), the library's backward being their
    difference."""
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    dot = do.transpose(1, 2)
    gqa = q.shape[2] != k.shape[2]

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=gqa)

    def both():
        return torch.autograd.grad(fwd(), (qt, kt, vt), dot)
    return both, fwd


def _check_backward(dtype, results, gen) -> None:
    """The backward kernels against their plain versions (rel-L2 per
    output) and timed, at the training path's shapes: K2 over DIT_IMAGE's
    self (2, 1024, 24, 64) and cross (64 text tokens) attention, yi-6b's
    causal GQA (2, 2048, 32 / 4, 128) and whisper-medium's encoder self
    (4, 1500, 16, 64); K1 at (2, 1024, 1536), every variant.  Each
    backward is bound by the five products of 2 d flops per (query, key)
    pair (S, dP, dV, dK, dQ) or by its bytes (q, k, v, o, dO and lse
    read, dq, dk, dv written); K2's at the bf16 tensor-core rate in bf16,
    and in fp32 at three TF32 products for each fp32 one on the tensor
    cores (its ``bound_ms``; the ratio printed beside it), with the
    CUDA-core bound of the five fp32 products printed beside it on the
    ``bounds:`` line; the library time is the backward alone of
    SDPA, or of F.layer_norm plus the modulate, in ``dtype``.  Each K2
    case first holds the forward with the log-sum-exp written (the
    training path's) to ``ref.attention_ref``/``attention_lse_ref``, and
    the plain backward reads those refs' o and lse, not the kernel's;
    then each backward call's three kernels are timed by the profiler.
    Also times that forward at the serving self shape."""
    fp32 = dtype == torch.float32
    es = torch.finfo(dtype).bits // 8
    tag = "" if fp32 else " bf16"
    # fp32: three TF32 products for each fp32 one on the tensor cores
    peak, passes = (TF32_FLOPS_PER_S, 3) if fp32 else (BF16_FLOPS_PER_S, 1)
    d_model, heads, hd = DIT_IMAGE.d_model, DIT_IMAGE.num_heads, \
        DIT_IMAGE.head_dim
    if fp32:     # the forward with lse, beside the serving self case
        q = _rand((1, 1024, heads, hd), dtype, gen)
        k, v = (_rand((1, 4096, heads, hd), dtype, gen) for _ in range(2))
        timing = _attn_timing(q, k, v, 1024, 4096, lse=True, host_calls=200,
                              summary="attention with lse")
        _check(f"attention self with lse q{tuple(q.shape)} kv"
               f"{tuple(k.shape)}",
               lambda: ops.attention_lse(q, k, v),
               lambda: (ref.attention_ref(q, k, v),
                        ref.attention_lse_ref(q, k)), dtype, results, timing)
        del q, k, v
    b = DIT_TRAIN_BATCH
    cases = [("dit self", (b, 1024, heads, hd), heads, 1024, False),
             ("dit cross", (b, 1024, heads, hd), heads, 64, False),
             ("yi-6b causal", (YI_TRAIN_BATCH, YI_TRAIN_SEQ, YI.num_heads,
                               YI.head_dim), YI.num_kv_heads, YI_TRAIN_SEQ,
              True),
             ("whisper-medium self", (ZOO_BATCH, WHISPER.frontend_seq,
                                      WHISPER.num_heads, WHISPER.head_dim),
              WHISPER.num_heads, WHISPER.frontend_seq, False)]
    for label, (bb, sq, h, d), kv, sk, causal in cases:
        q, do = (_rand((bb, sq, h, d), dtype, gen) for _ in range(2))
        k, v = (_rand((bb, sk, kv, d), dtype, gen) for _ in range(2))
        # the forward with lse at this case's shape, held to the refs; the
        # plain backward takes the refs' o and lse, so that the two sides
        # share no data the kernels made
        o_ref = ref.attention_ref(q, k, v, causal=causal)
        lse_ref = ref.attention_lse_ref(q, k, causal=causal)
        _check(f"attention with lse {label} q{(bb, sq, h, d)} "
               f"kv{(bb, sk, kv, d)}{' causal' if causal else ''}",
               lambda: ops.attention_lse(q, k, v, causal=causal),
               lambda: (o_ref, lse_ref), dtype, results)
        o, lse = ops.attention_lse(q, k, v, causal=causal)
        both, fwd = _sdpa_backward(q, k, v, do, causal)
        flops, nbytes = cost.attention_bwd(bb, sq, sk, h, kv, d, causal, es)
        timing = dict(bytes=nbytes, flops=passes * flops,
                      flops_per_s=peak, iters=10, replays=5, host_calls=50,
                      plain_iters=3, library=both, library_fwd=fwd)
        timing["summary"] = f"attention_bwd {label}{tag}"
        _check(f"attention_bwd {label} q{(bb, sq, h, d)} kv{(bb, sk, kv, d)}"
               f"{' causal' if causal else ''}",
               lambda: ops.attention_bwd(q, k, v, o, lse, do, causal=causal),
               lambda: ref.attention_bwd_ref(q, k, v, o_ref, lse_ref, do,
                                             causal=causal),
               dtype, results, timing, l2=True)
        if fp32:
            entry = results[timing["summary"]]
            cc_ms, cc_by = bound_ms(nbytes, flops)
            print(f"    bounds: 3xTF32 {entry['bound_ms']:.4f} ms "
                  f"({entry['bound_by']}; the kernel at "
                  f"{entry['bound_ms'] / entry['ms']:.3f} of it), CUDA-core "
                  f"fp32 {cc_ms:.4f} ms ({cc_by}; "
                  f"{cc_ms / entry['ms']:.3f})", flush=True)
        results.setdefault("attention_bwd_split", {})[f"{label}{tag}"] = \
            kernel_split_ms(lambda: ops.attention_bwd(
                q, k, v, o, lse, do, causal=causal),
                f"attention_bwd {label}{tag}", "attn_bwd")
        del q, k, v, o, lse, o_ref, lse_ref, do, both, fwd
    n = 1024
    x, dy, res = (_rand((b, n, d_model), dtype, gen) for _ in range(3))
    sh, sc, g = (_rand((b, d_model), dtype, gen, 0.5) for _ in range(3))
    xt, sht, sct, gt, rt = (t.detach().requires_grad_(True)
                            for t in (x, sh, sc, g, res))

    def norm(mod):
        y = F.layer_norm(xt, (d_model,), eps=1e-6)
        return y * (1.0 + sct[:, None]) + sht[:, None] if mod else y
    # variant: (kernel's keywords, library forward and its leaves)
    variants = {
        "mod_norm": (dict(shift=sh, scale=sc), lambda: norm(True),
                     (xt, sht, sct)),
        "ln": (dict(), lambda: norm(False), (xt,)),
        "gated_residual": (dict(gate=g, ln=False),
                           lambda: rt + gt[:, None] * xt, (xt, gt, rt)),
        "full": (dict(shift=sh, scale=sc, gate=g),
                 lambda: rt + gt[:, None] * norm(True),
                 (xt, sht, sct, gt, rt))}
    for vname, (kw, lib_fwd, leaves) in variants.items():
        def lib_both(lib_fwd=lib_fwd, leaves=leaves):
            return torch.autograd.grad(lib_fwd(), leaves, dy)
        # x and dy read, dx written, the (B, D) rows read and their
        # gradients written; dresidual is dy itself, so nothing for it
        label = "fused_adaln_bwd" + ("" if vname == "mod_norm"
                                     else f" {vname}") + tag
        # 200 calls of two launches stay within the launch queue, so the
        # host time is the host's
        flops, nbytes = cost.adaln_bwd(b, n, d_model, ln=kw.get("ln", True),
                                       mod="shift" in kw, gated="gate" in kw,
                                       es=es)
        timing = {"bytes": nbytes, "flops": flops, "host_calls": 200,
                  "library": lib_both, "library_fwd": lib_fwd,
                  "summary": label}
        kernel = (lambda kw=kw: ops.fused_adaln_bwd(x, dy=dy, **kw))
        _check(f"adaln_bwd {vname} ({b}, {n}, {d_model})", kernel,
               lambda kw=kw: ref.adaln_bwd_ref(x, dy=dy, **kw),
               dtype, results, timing, l2=True)
        results.setdefault("fused_adaln_bwd_split", {})[label] = \
            kernel_split_ms(kernel, label, "adaln_bwd")
    del x, dy, res, xt, sht, sct, gt, rt
    if fp32:
        results["attention_bwd"] = results["attention_bwd dit self"]


def _check_lm_attention(dtype, results, gen) -> None:
    """K2 causal at the decoder LMs' full-width forward shapes: zamba2-7b's
    shared block (q = k = v (4, 2080, 32, 112), the hybrid phase's
    forward) and yi-6b's causal GQA (1, 2048, 32 q / 4 kv heads, 128),
    each with SDPA (``is_causal=True``) in ``dtype`` timed beside it and
    bound at the dtype's peak; the plain version's (2080 x 2080) score
    matrices fit the card whole."""
    zb, zs = LM_BATCH, LM_PROMPT + LM_DECODE
    cases = [("zamba2-7b", (zb, zs, ZAMBA.num_heads, ZAMBA.head_dim),
              ZAMBA.num_kv_heads),
             ("yi-6b", (1, LM_PROMPT, YI.num_heads, YI.head_dim),
              YI.num_kv_heads)]
    es = torch.finfo(dtype).bits // 8
    for model, (b, sq, h, d), kv in cases:
        q = _rand((b, sq, h, d), dtype, gen)
        k, v = (_rand((b, sq, kv, d), dtype, gen) for _ in range(2))
        flops, nbytes = cost.attention(b, sq, sq, h, kv, d, True, es)
        timing = {
            **_attn_bound(flops, nbytes, dtype), "iters": 10,
            "replays": 5, "host_calls": 50, "plain_iters": 3,
            "summary": f"{model} attention"
            + ("" if dtype == torch.float32 else " bf16"),
            "library": lambda q=q, k=k, v=v, g=h != kv:
                F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2),
                    v.transpose(1, 2), is_causal=True, enable_gqa=g)}
        _check(f"attention {model} causal q{(b, sq, h, d)} kv{(b, sq, kv, d)}",
               lambda q=q, k=k, v=v: ops.attention(q, k, v, causal=True),
               lambda q=q, k=k, v=v: ref.attention_ref(q, k, v, causal=True),
               dtype, results, timing)
        del q, k, v
    if dtype == torch.float32 and ZAMBA.head_dim in ops.HEAD_DIMS:
        d = ZAMBA.head_dim
        blocks, smem = ops.attention_occupancy(d)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        grid = -(-zs // 64) * zb * ZAMBA.num_heads
        print(f"  attention occupancy d={d}: {grid} blocks of 128 threads "
              f"at q(4, {zs}), {blocks} resident per SM ({smem / 1024:.1f} "
              f"KB shared memory each), {sms} SMs: "
              f"{grid / (blocks * sms):.2f} waves", flush=True)
        results["zamba2_attention_occupancy"] = {
            "blocks_per_sm": blocks, "smem_bytes": smem, "sms": sms,
            "grid": grid}


def _check_whisper_attention(dtype, results, gen) -> None:
    """K2 at whisper-medium's three shapes at batch 4 (16 heads x 64, no
    GQA): the encoder's bidirectional self-attention over the 1500
    frames, the decoder's cross-attention of a 4-token prompt (prefill)
    and of one decode step (Sq = 1) to them; each against its plain
    version and timed against its bound and SDPA on the same inputs."""
    b, h, d, f = ZOO_BATCH, WHISPER.num_heads, WHISPER.head_dim, \
        WHISPER.frontend_seq
    k, v = (_rand((b, f, h, d), dtype, gen) for _ in range(2))
    tag = "" if dtype == torch.float32 else " bf16"
    blocks, smem = ops.attention_occupancy(d, dtype)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = {label: ops.attention_splits(b, sq, f, h, d, dtype)
              for label, sq in (("self", f), ("cross", ZOO_PROMPT),
                                ("decode", 1))}
    # the pieces' fp32 scratch, written once and read once: traffic
    # beside the bound, not counted in the function's bytes
    scratch = {label: 2 * 4 * n * b * sq * h * (d + 2) if n > 1 else 0
               for (label, n), sq in zip(splits.items(),
                                         (f, ZOO_PROMPT, 1))}
    print(f"  attention {str(dtype)[6:]} occupancy d={d}: {blocks} "
          f"resident blocks "
          f"per SM ({smem / 1024:.1f} KB shared memory each), {sms} SMs;"
          f" whisper-medium key pieces (1: the tile kernel alone) "
          f"{splits}, their scratch traffic in bytes {scratch}",
          flush=True)
    for label, sq in (("self", f), ("cross", ZOO_PROMPT), ("decode", 1)):
        q = _rand((b, sq, h, d), dtype, gen)
        _check(f"attention whisper-medium {label} q{(b, sq, h, d)} kv"
               f"{(b, f, h, d)}", lambda q=q: ops.attention(q, k, v),
               lambda q=q: ref.attention_ref(q, k, v), dtype, results,
               _attn_timing(q, k, v, sq, f, host_calls=200,
                            summary=f"whisper-medium {label}{tag} attention"))
        if label == "decode" and tag:   # bf16's split route's summary
            results[BF16_ROUTES[1]] = \
                results[f"whisper-medium {label}{tag} attention"]


#: the 512 px request's latent tokens and their SP-4 shard: 4 x 24 query
#: tiles, under the H100's 132 SMs
DIT_512_TOKENS, DIT_512_SHARD = 1024, 256


def _check_dit_512(results, gen) -> None:
    """K2 and K3 in fp32 at the 512 px request's SP-4 shard, the serve
    phase's most frequent calls: self-attention over the 1024 gathered
    keys, cross-attention to 77 text tokens and the §11 hit at the first,
    a middle and the last shard's offset.  Each is held to its plain
    version, timed on the route the library takes (its key pieces in
    the label) and on the tile kernel alone (one piece) beside it; the
    self case is the ``attention fp32 split`` summary."""
    dtype = torch.float32
    heads, hd = DIT_IMAGE.num_heads, DIT_IMAGE.head_dim
    n, shard = DIT_512_TOKENS, DIT_512_SHARD
    q = _rand((1, shard, heads, hd), dtype, gen)
    kv = {sk: tuple(_rand((1, sk, heads, hd), dtype, gen) for _ in range(2))
          for sk in (n, 77)}
    kf, vf = (_rand((1, shard, heads, hd), dtype, gen) for _ in range(2))
    cases = [(label, sk,
              lambda s=None, sk=sk: ops._attention_fwd(q, *kv[sk], False,
                                                       False, s)[0],
              lambda sk=sk: ref.attention_ref(q, *kv[sk]))
             for label, sk in (("self", n), ("cross Lt=77", 77))]
    cases += [(f"splice offset={o}", n,
               lambda s=None, o=o: ops._splice_fwd(q, *kv[n], kf, vf, o, s),
               lambda o=o: ref.splice_attention_ref(q, *kv[n], kf, vf,
                                                    offset=o))
              for o in (0, n // 2, n - shard)]
    for label, sk, kernel, plain in cases:
        pieces = ops.attention_splits(1, shard, sk, heads, hd, dtype)
        if label.startswith("splice"):
            timing = {**_attn_bound(*cost.splice_attention(
                1, shard, sk, heads, heads, hd, 4), dtype), "host_calls": 200}
        else:
            timing = _attn_timing(q, *kv[sk], shard, sk, host_calls=200)
        key = f"attention fp32 512px {label}"
        _check(f"attention 512px SP-4 shard {label} q(1,{shard}) kv(1,{sk})"
               f" in {pieces} key pieces", kernel, plain, dtype, results,
               {**timing, "summary": key})
        tile = device_ms(lambda: kernel(1))
        results[key].update(pieces=pieces, tile_ms=tile,
                            route=FP32_ROUTES[pieces > 1])
        print(f"    tile kernel alone (1 piece) {tile:.4f} ms device",
              flush=True)
    if results["attention fp32 512px self"]["pieces"] == 1:
        raise AssertionError("512 px self shard: the split-key summary "
                             "took the tile route")
    results[FP32_ROUTES[1]] = results["attention fp32 512px self"]


def phase_splits(smi: str) -> None:
    """fp32 K2 and K3 at the main path's short query grids in 1 to 8 key
    pieces and in the library's count: device ms and a Python caller's
    host µs a call, each count held to the plain version.  The crossover
    is what ``attn_split_rule`` in ``csrc/attention.cu`` encodes."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    dtype = torch.float32
    h, d = DIT_IMAGE.num_heads, DIT_IMAGE.head_dim
    whisper = (ZOO_BATCH, WHISPER.num_heads, WHISPER.head_dim)
    shard = DIT_512_SHARD
    shapes = [   # label, (b, sq, h, d), keys, the hit's offset (or None)
        ("dit 512px SP-4 self", (1, shard, h, d), DIT_512_TOKENS, None),
        ("dit 512px SP-4 cross", (1, shard, h, d), 77, None),
        ("dit 512px SP-4 hit", (1, shard, h, d), DIT_512_TOKENS,
         DIT_512_TOKENS // 2),
        ("dit 1024px SP-4 self", (1, 1024, h, d), 4096, None),
        ("dit 128px SP-4 self", (1, 16, h, d), 64, None),
        ("dit 128px SP-4 cross", (1, 16, h, d), 77, None),
        ("dit 128px SP-1 self", (1, 64, h, d), 64, None),
        ("text encoder", (1, 77, 4, 256), 77, None),
        ("whisper cross prefill", (whisper[0], ZOO_PROMPT, *whisper[1:]),
         WHISPER.frontend_seq, None),
        ("whisper decode", (whisper[0], 1, *whisper[1:]),
         WHISPER.frontend_seq, None),
    ]
    print(f"splits: fp32 K2/K3 by key pieces on {smi}", flush=True)
    for label, (b, sq, hh, dd), sk, offset in shapes:
        q = _rand((b, sq, hh, dd), dtype, gen)
        k, v = (_rand((b, sk, hh, dd), dtype, gen) for _ in range(2))
        if offset is None:
            def run(n, q=q, k=k, v=v):
                return ops._attention_fwd(q, k, v, False, False, n)[0]
            want = ref.attention_ref(q, k, v)
        else:
            kf, vf = (_rand((b, sq, hh, dd), dtype, gen) for _ in range(2))

            def run(n, q=q, k=k, v=v, kf=kf, vf=vf, o=offset):
                return ops._splice_fwd(q, k, v, kf, vf, o, n)
            want = ref.splice_attention_ref(q, k, v, kf, vf, offset=offset)
        rule = ops.attention_splits(b, sq, sk, hh, dd, dtype)
        ktiles = -(-sk // (64 if dd <= 32 else 32))   # fp32 key tiles
        cells = []
        for n in sorted(set(range(1, min(ktiles, 8) + 1)) | {rule}):
            err = ((run(n) - want).abs().max()
                   / want.abs().max().clamp_min(1e-30)).item()
            if not err <= BUDGET[dtype]:
                raise AssertionError(f"splits: {label} in {n} pieces "
                                     f"{err:.2e} from its plain version")
            cells.append(f"n={n} {device_ms(lambda n=n: run(n)):.4f} ms "
                         f"{host_us(lambda n=n: run(n), 200):.1f} us")
        print(f"  {label} q{(b, sq, hh, dd)} keys {sk}: library {rule} "
              f"pieces; " + ", ".join(cells), flush=True)


def _attn_bound(flops, nbytes, dtype) -> dict:
    """The bound of an attention timing: bf16 at the tensor cores' bf16
    peak; fp32 as the kernel computes it, three TF32 products for each
    fp32 one at their TF32 peak, with the same work's CUDA-core bound
    (``cuda_core``) printed beside it."""
    if dtype == torch.bfloat16:
        return dict(bytes=nbytes, flops=flops, flops_per_s=BF16_FLOPS_PER_S)
    return dict(bytes=nbytes, flops=3 * flops, flops_per_s=TF32_FLOPS_PER_S,
                cuda_core=(nbytes, flops))


def _attn_timing(q, k, v, sq, sk, lse=False, **extra) -> dict:
    """Timing of an attention case: bytes and operations of the
    function (the log-sum-exp written too with ``lse``), bound as
    :func:`_attn_bound` says, and SDPA (heads first) on the same inputs
    as the library call."""
    b, _, h, d = q.shape
    flops, nbytes = cost.attention(b, sq, sk, h, k.shape[2], d, False,
                                   q.element_size(), lse)
    return dict(**_attn_bound(flops, nbytes, q.dtype),
                library=lambda: F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)),
                **extra)


def _check_video(results, gen) -> None:
    """K1-K3 at DIT_VIDEO's shapes, fp32: K1 at the SP-4 shard of the
    class-S request (5,070 rows of 3072), K2 self over its 20,280 keys
    and cross to 77 text tokens at head dim 128, K3 at leg (b)'s hit
    (rank 2 of SP-4 over 7,800 keys, offset 3,900: off the 32-key tile).
    A K2/K3 call here takes tens of ms, so each is timed over fewer
    calls; the plain version's (5070 x 20280) score matrix per head fits
    the card (9.9 GB over 24 heads), so it runs whole."""
    dtype, d_model, heads, hd = (torch.float32, DIT_VIDEO.d_model,
                                 DIT_VIDEO.num_heads, DIT_VIDEO.head_dim)
    n_s = dit.token_count(DIT_VIDEO, *VIDEO_S)
    n_hit = dit.token_count(DIT_VIDEO, *VIDEO_HIT)
    shard, hit_shard = n_s // 4, n_hit // 4
    x = _rand((1, shard, d_model), dtype, gen)
    res = _rand((1, shard, d_model), dtype, gen)
    sh, sc, g = (_rand((1, d_model), dtype, gen, 0.5) for _ in range(3))
    for vname, kw in {
            "mod_norm": dict(shift=sh, scale=sc), "ln": dict(),
            "gated_residual": dict(gate=g, residual=res, ln=False),
            "full": dict(shift=sh, scale=sc, gate=g, residual=res)}.items():
        flops, nbytes = cost.adaln(1, shard, d_model, ln=kw.get("ln", True),
                                   mod="shift" in kw, gated="gate" in kw,
                                   es=4)
        timing = {"bytes": nbytes, "flops": flops}
        if vname == "mod_norm":
            w, b = (1.0 + sc[0]).contiguous(), sh[0].contiguous()
            timing["library"] = lambda w=w, b=b: F.layer_norm(
                x, (d_model,), w, b, eps=1e-6)
            timing["summary"] = "video fused_adaln"
        _check(f"video adaln {vname} N={shard} D={d_model}",
               lambda kw=kw: ops.fused_adaln(x, **kw),
               lambda kw=kw: ref.adaln_ref(x, **kw), dtype, results, timing)
    blocks, smem = ops.attention_occupancy(hd)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = -(-shard // 64) * heads
    print(f"  attention occupancy d={hd}: {grid} blocks of 128 threads at "
          f"Sq={shard}, {blocks} resident per SM ({smem / 1024:.1f} KB "
          f"shared memory each), {sms} SMs: {grid / (blocks * sms):.2f} "
          f"waves", flush=True)
    results["video_attention_occupancy"] = {
        "blocks_per_sm": blocks, "smem_bytes": smem, "sms": sms,
        "grid": grid}
    long = dict(iters=2, replays=3, host_calls=20, plain_iters=2)
    q = _rand((1, shard, heads, hd), dtype, gen)
    for label, sk, extra in (("self", n_s, dict(long, summary="video "
                                                "attention")),
                             ("cross Lt=77", 77, {"host_calls": 200})):
        k, v = (_rand((1, sk, heads, hd), dtype, gen) for _ in range(2))
        _check(f"video attention {label} q{tuple(q.shape)} kv(1, {sk}, "
               f"{heads}, {hd})", lambda k=k, v=v: ops.attention(q, k, v),
               lambda k=k, v=v: ref.attention_ref(q, k, v), dtype, results,
               _attn_timing(q, k, v, shard, sk, **extra))
        del k, v
    del q
    q = _rand((1, hit_shard, heads, hd), dtype, gen)
    ks_, vs_ = (_rand((1, n_hit, heads, hd), dtype, gen) for _ in range(2))
    kf, vf = (_rand((1, hit_shard, heads, hd), dtype, gen) for _ in range(2))
    offset = 2 * hit_shard
    timing = _attn_timing(q, ks_, vs_, hit_shard, n_hit, **long,
                          summary="video splice_attention")
    timing["library"] = None           # no single call splices
    _check(f"video splice offset={offset} q(1, {hit_shard}) stale(1, "
           f"{n_hit}) d={hd}",
           lambda: ops.splice_attention(q, ks_, vs_, kf, vf, offset=offset),
           lambda: ref.splice_attention_ref(q, ks_, vs_, kf, vf,
                                            offset=offset),
           dtype, results, timing)


def ssd_inputs(b, l, h, p, n, dtype, gen):
    """K4's inputs on the card, dt and A in Mamba2's published ranges.
    At the JAX init (A = -1, dt near 0.7) exp(cum) underflows within one
    128-row chunk, the carried-state term is exactly zero and a check
    proves nothing about the state carry."""
    dt, A = ssm.sample_dt_a((b, l, h), h, gen)
    x = _rand((b, l, h, p), dtype, gen)
    B, C = (_rand((b, l, n), dtype, gen) for _ in range(2))
    return x, dt, A, B, C


def kernel_split_ms(fn, label: str, family: str, calls: int = 10) -> dict:
    """Device ms a call of each kernel of ``csrc`` whose name holds
    ``family`` (K4's four stages, K2's three backward kernels), over
    ``calls`` calls of ``fn`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for avg in prof.key_averages():
        m = re.search(r"gfdit::(\w+)", avg.key)
        if m and family in m[1] and avg.self_device_time_total > 0:
            out[m[1]] = out.get(m[1], 0.0) + avg.self_device_time_total
    out = {k: v / calls / 1e3 for k, v in out.items()}
    print(f"  {label} device ms a call by kernel: "
          + ", ".join(f"{k} {v:.4f}" for k, v in out.items()), flush=True)
    return out


def _ssd_bounds(label, nbytes, flops, entry=None, floor_bytes=0) -> dict:
    """K4's bounds beside each other: the CUDA cores' (fp32 at 67
    TFLOP/s), the tensor cores' (fp32 as three TF32 products at 494.7,
    bf16 at 989; ``flops`` already counts the three TF32 products for
    fp32) and, with ``floor_bytes``, the four-stage design's floor: the
    function's bytes plus the fp32 chunk states that stage 1 writes,
    stage 2 reads and writes and stage 4 reads.  Printed with the
    kernel's share of each when ``entry`` holds its time."""
    out = {"cuda_core": bound_ms(nbytes, flops[0]),
           "tensor_core": bound_ms(nbytes, flops[1], flops[2])}
    if floor_bytes:
        out["design_floor"] = ((nbytes + floor_bytes) / HBM_BYTES_PER_S
                               * 1e3, "bytes")
    line = "; ".join(f"{k} {v:.4f} ms ({by}" + (
        f", the kernel at {v / entry['ms']:.3f} of it)" if entry else ")")
        for k, (v, by) in out.items())
    print(f"    {label} bounds: {line}", flush=True)
    if entry is not None:
        entry["bounds"] = {k: v for k, (v, _) in out.items()}
    return out


def _check_ssd(dtype, results) -> None:
    """K4 at the full-width mamba2-1.3b prefill (b=4, l=2048, h=64, p=64,
    n=128, chunk=128) and at batch 1, and at zamba2-7b's (b=4, l=2048,
    h=112, p=64, n=64, chunk=128), each timed with its stage kernels'
    device time and printed with its CUDA-core and tensor-core bounds and
    the four-stage design's floor; also at a ragged l (the forward's
    2080) and the reduced model's (16, 16, 16) with a ragged l, and in
    fp32 zamba2's held to the stage-wise twin too; then the occupancy of
    each stage kernel.  The bound in the kernels line is the tensor
    cores' (fp32: three TF32 products for each fp32 one), the CUDA
    cores' printed beside it."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    _, heads, _ = ssm.ssm_dims(MAMBA)
    s = MAMBA.ssm
    fp32 = dtype == torch.float32
    es = torch.finfo(dtype).bits // 8
    tag = "" if fp32 else " bf16"
    full = (heads, s.head_dim, s.state_dim, s.chunk)
    _, z_heads, _ = ssm.ssm_dims(ZAMBA)
    zamba = (LM_BATCH, LM_PROMPT, z_heads, ZAMBA.ssm.head_dim,
             ZAMBA.ssm.state_dim, ZAMBA.ssm.chunk)
    cases = [(LM_BATCH, LM_PROMPT) + full, zamba, (1, LM_PROMPT) + full,
             (LM_BATCH, LM_PROMPT + LM_DECODE) + full,
             (2, 40, 16, 16, 16, 16)]
    for i, case in enumerate(cases):
        b, l, h, p, n, c = case
        x, dt, A, B, C = ssd_inputs(b, l, h, p, n, dtype, gen)
        timing = None
        if l == LM_PROMPT:
            flops, nbytes = cost.ssd(b, l, h, p, n, c, es)
            timing = {
                "bytes": nbytes, "flops": (3 if fp32 else 1) * flops,
                "flops_per_s": TF32_FLOPS_PER_S if fp32 else
                BF16_FLOPS_PER_S, "plain_iters": 3, "host_calls": 200}
            if fp32:   # the same work on the CUDA cores, printed beside
                timing["cuda_core"] = (nbytes, flops)
            key = f"b={b}" if case != zamba else f"zamba2 b={b}"
            timing["summary"] = {0: "ssd", 1: "zamba2-7b ssd"}.get(
                i, f"ssd {key}") + tag
        args = (x, dt, A, B, C)
        _check(f"ssd b={b} l={l} h={h} (p, n, chunk)={(p, n, c)}",
               lambda a=args, c=c: ops.ssd(*a, chunk=c),
               lambda a=args: ref.ssd_ref(*a),
               dtype, results, timing, SSD_BUDGET)
        if case == zamba and fp32:   # and stage-wise
            _check(f"ssd b={b} l={l} h={h} (p, n, chunk)={(p, n, c)} vs "
                   f"the stage-wise twin",
                   lambda a=args, c=c: ops.ssd(*a, chunk=c),
                   lambda a=args, c=c: ref.ssd_chunked_ref(*a, chunk=c),
                   dtype, results, None, SSD_BUDGET)
        if timing is not None:
            states = 4 * b * -(-l // c) * h * n * p * 4
            _ssd_bounds(f"ssd{tag} {key}", nbytes,
                        (flops, (3 if fp32 else 1) * flops,
                         TF32_FLOPS_PER_S if fp32 else BF16_FLOPS_PER_S),
                        results[timing["summary"]], states)
            results.setdefault("ssd_stages", {})[key + tag] = \
                kernel_split_ms(lambda a=args, c=c: ops.ssd(*a, chunk=c),
                                f"ssd{tag} {key}", "ssd")
        del x, dt, A, B, C
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    occ = {}
    shapes = [("", LM_BATCH, full), ("", 1, full)]
    shapes.append(("zamba2 ", LM_BATCH, zamba[2:]))
    for label, b, shape in shapes:
        stages = ops.ssd_occupancy(b, LM_PROMPT, *shape, dtype=dtype)
        for name, (blocks, smem, grid, *threads) in stages.items():
            threads = threads[0] if threads else 256
            waves = grid / (blocks * sms)
            occ[f"{label}b={b} {name}"] = {
                "blocks_per_sm": blocks, "smem_bytes": smem, "sms": sms,
                "grid": grid, "threads": threads, "waves": waves}
            print(f"  ssd{tag} occupancy {label}b={b} {name}: {grid} blocks "
                  f"of {threads} threads, {blocks} resident per SM "
                  f"({smem / 1024:.1f} KB shared memory each), {sms} "
                  f"SMs: {waves:.2f} waves", flush=True)
    results["ssd_occupancy" + tag] = occ


def _check_ssd_bwd(dtype, results) -> None:
    """K4's backward at the train phase's shapes: mamba2-1.3b's (b=2,
    l=2048, h=64, p=64, n=128, chunk 128) and zamba2-7b's (h=112, n=64),
    each on the scratch of K4's forward on the same operands and without
    a final-state gradient (the training path drops the state), timed;
    also mamba2's with one, untimed.  rel-L2 per output (dx, ddt,
    dA, dB, dC) against ``ref.ssd_bwd_ref`` within the SSD's budget; the
    bound is operations (``cost.ssd_bwd_flops``) at the card's peak for the
    operands' type (bf16: the bf16 tensor-core rate; fp32: three TF32
    products for each fp32 one, as K2's fp32 backward, with the CUDA-core
    bound printed beside it) or bytes (x, dy, B, C, dt and A read once,
    their gradients written once); no single PyTorch call computes the
    SSD's gradient, so no library time.  Then each call's four stage
    kernels by the profiler, and each stage's occupancy."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    fp32 = dtype == torch.float32
    es = torch.finfo(dtype).bits // 8
    tag = "" if fp32 else " bf16"
    # fp32: three TF32 products for each fp32 one on the tensor cores
    peak, passes = (TF32_FLOPS_PER_S, 3) if fp32 else (BF16_FLOPS_PER_S, 1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for cfg in (MAMBA, ZAMBA):
        _, h, _ = ssm.ssm_dims(cfg)
        b, l = YI_TRAIN_BATCH, YI_TRAIN_SEQ
        p, n, c = cfg.ssm.head_dim, cfg.ssm.state_dim, cfg.ssm.chunk
        x, dt, A, B, C = ssd_inputs(b, l, h, p, n, dtype, gen)
        dy = _rand((b, l, h, p), dtype, gen)
        _, _, scratch = ops.ssd_for_grad(x, dt, A, B, C, chunk=c)
        label = "ssd_bwd" if cfg is MAMBA else f"{cfg.name} ssd_bwd"
        flops, nbytes = cost.ssd_bwd(b, l, h, p, n, c, es)
        timing = dict(bytes=nbytes, flops=passes * flops, flops_per_s=peak,
                      iters=10, replays=5, host_calls=50, plain_iters=2,
                      summary=label + tag)

        def kernel(x=x, dt=dt, A=A, B=B, C=C, dy=dy, c=c, scratch=scratch):
            return ops.ssd_bwd(x, dt, A, B, C, dy, chunk=c, scratch=scratch)
        case = f"{cfg.name} b={b} l={l} h={h} (p, n, chunk)={(p, n, c)}"
        _check(f"ssd_bwd {case}", kernel,
               lambda: ref.ssd_bwd_ref(x, dt, A, B, C, dy, chunk=c),
               dtype, results, timing, SSD_BWD_BUDGET, l2=True,
               names=SSD_BWD_OUTPUTS)
        _ssd_bounds(label + tag, nbytes, (flops, passes * flops, peak),
                    results[label + tag])
        results.setdefault("ssd_bwd_split", {})[label + tag] = \
            kernel_split_ms(kernel, label + tag, "ssd_bwd")
        if cfg is MAMBA:
            ds = torch.randn((b, h, p, n), generator=gen, device="cuda")
            _check(f"ssd_bwd {case} with a final-state gradient",
                   lambda: ops.ssd_bwd(x, dt, A, B, C, dy, ds, chunk=c,
                                       scratch=scratch),
                   lambda: ref.ssd_bwd_ref(x, dt, A, B, C, dy, ds, chunk=c),
                   dtype, results, None, SSD_BWD_BUDGET, l2=True,
                   names=SSD_BWD_OUTPUTS)
            del ds
        for name, (blocks, smem, grid, threads) in ops.ssd_bwd_occupancy(
                b, l, h, p, n, c, dtype).items():
            waves = grid / (blocks * sms)
            results.setdefault("ssd_bwd_occupancy", {})[
                f"{label}{tag} {name}"] = {
                "blocks_per_sm": blocks, "smem_bytes": smem, "sms": sms,
                "grid": grid, "threads": threads, "waves": waves}
            print(f"  ssd_bwd occupancy {cfg.name}{tag} {name}: {grid} "
                  f"blocks of {threads} threads, {blocks} resident per SM "
                  f"({smem / 1024:.1f} KB shared memory each), {sms} "
                  f"SMs: {waves:.2f} waves", flush=True)
        del x, dt, A, B, C, dy, scratch


def _plain_ssd_scratch(x, dt, A, B, C, chunk: int):
    """K4's forward scratch as the plain version computes it, on x's
    device, laid out as ``ops.ssd_for_grad``'s (the parts the backward
    reads: cum, the chunk states' slots holding S_in, C B^T in the (j, i)
    layout with zeros above the diagonal; any other part zero)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    _, _, Bc, Cc, _, cum, s_in, _ = ref._ssd_chunks(x, dt, A, B, C, (),
                                                   chunk)
    sizes = ops._ssd_scratch_sizes(b, l, h, p, n, chunk)
    scratch = torch.zeros(sum(sizes), dtype=torch.float32, device=x.device)
    parts = scratch.split(sizes)
    parts[0].copy_(cum.reshape(-1))
    parts[1].copy_(s_in.transpose(-1, -2).reshape(-1))     # (n x p) slots
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc).tril()      # j <= i
    parts[2].copy_(cb.transpose(-1, -2).reshape(-1))
    return scratch


def phase_ssd(smi: str) -> dict:
    """K4 alone (``--phase ssd``): the kernels phase's K4 forward and
    backward checks in both dtypes (timed, by stage, with occupancy and
    bounds), then, per dtype, on fixed inputs at mamba2-1.3b's and
    zamba2-7b's (p, n, chunk), b=2 and the ragged l=2080, a sha256 digest
    of the forward's outputs (y and the final state, held to the plain
    version within the SSD's budget) and one of the backward's five
    gradients (with a final-state gradient) on a scratch the plain version
    built (``_plain_ssd_scratch``), so that the backward's digest does not
    follow the forward's bits.  Equal digests show that two trees' kernels
    compute the same bits.  With ``--src``, another checkout's
    kernels."""
    import hashlib
    results: dict = {}
    for dtype in (torch.float32, torch.bfloat16):
        _check_ssd(dtype, results)
        _check_ssd_bwd(dtype, results)

    def digest(tensors) -> str:
        d = hashlib.sha256()
        for t in tensors:   # bf16 widened exactly to fp32
            d.update(t.float().cpu().numpy().tobytes())
        return d.hexdigest()
    digests = {}
    for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        for cfg in (MAMBA, ZAMBA):
            _, h, _ = ssm.ssm_dims(cfg)
            p, n, c = cfg.ssm.head_dim, cfg.ssm.state_dim, cfg.ssm.chunk
            gen = torch.Generator(device="cuda").manual_seed(21)
            x, dt, A, B, C = ssd_inputs(2, LM_PROMPT + LM_DECODE, h, p, n,
                                        dtype, gen)
            dy = _rand(x.shape, dtype, gen)
            ds = torch.randn((2, h, p, n), generator=gen, device="cuda")
            args = (x, dt, A, B, C)
            _check(f"ssd digest inputs {cfg.name} b=2 l={x.shape[1]}",
                   lambda a=args, c=c: ops.ssd(*a, chunk=c),
                   lambda a=args: ref.ssd_ref(*a), dtype, results, None,
                   SSD_BUDGET)
            digests[f"{cfg.name} {tag} forward"] = digest(
                ops.ssd(*args, chunk=c))
            grads = ops.ssd_bwd(*args, dy, ds, chunk=c,
                                scratch=_plain_ssd_scratch(*args, c))
            digests[f"{cfg.name} {tag} backward"] = digest(grads)
            del x, dt, A, B, C, dy, ds, args, grads
    for key, value in digests.items():
        print(f"ssd: digest {key} {value}", flush=True)
    print(f"ssd: digests on {smi}", flush=True)
    return {"timed": results["timed"], "digests": digests}


def _serve(cfg, policy, reqs, *, cache_interval, device="cuda", setup=None,
           during=contextlib.nullcontext):
    """Serve ``reqs`` on a fresh four-rank engine with livened weights.
    ``setup(engine)`` runs before serving; the timed serve runs inside the
    context manager ``during()`` (serve_profile.py passes a profiler)."""
    from repro_torch.serving.cache_demo import _liven
    eng = ServingEngine(cfg, policy, 4, cache_interval=cache_interval,
                        device=device)
    try:
        _liven(eng.pipeline)
        if setup is not None:
            setup(eng)
        if device == "cuda":
            torch.cuda.synchronize()
        with during():
            t0 = time.perf_counter()
            metrics = eng.serve(reqs, timeout=600)
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        pixels = {r.id: eng.result_pixels(r) for r in reqs}
        modes = [e.get("cache") for e in eng.cp.events
                 if e["ev"] == "dispatch" and e["kind"] == "denoise"]
        lat = {rid: req.done_time - req.arrival
               for rid, req in eng.cp.requests.items()
               if req.done_time is not None}
        return {"metrics": metrics, "wall": wall, "pixels": pixels,
                "modes": modes, "latency": lat, "engine": eng}
    finally:
        eng.shutdown()


def make_request(rid, res, steps=4):
    return Request(id=rid, model="dit-image", height=res, width=res,
                   frames=1, steps=steps, arrival=0.0)


def video_request(rid, shape, steps=VIDEO_STEPS):
    height, width, frames = shape
    return Request(id=rid, model="dit-video", height=height, width=width,
                   frames=frames, steps=steps, arrival=0.0)


def serve_requests() -> list:
    """The serve phase's traffic: two 512 px and one 1024 px request."""
    return [make_request("img512-a", 512), make_request("img512-b", 512),
            make_request("img1024", 1024)]


def _dit_counts() -> dict:
    """K1-K3's and the GEMM's launches since the last reset, with K2's
    and K3's fp32 launches by route."""
    return {**{k: ops.launches[k] for k in DIT_KERNELS + ("linear",)},
            **{r: ops.kernel_launches[r] for r in FP32_ROUTES}}


def phase_serve() -> dict:
    reqs = serve_requests()
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    with _expected_products() as want:
        run = _serve(DIT_IMAGE, FixedSP(4), reqs, cache_interval=2)
    counts = _dit_counts()
    products = _check_products("serve", want)
    # every fp32 K2 and K3 call on a tensor-core route of its own dtype
    routed = sum(counts[r] for r in FP32_ROUTES)
    if routed != counts["attention"] + counts["splice_attention"] or any(
            ops.kernel_launches[r] for r in BF16_ROUTES):
        raise AssertionError(f"serve: K2/K3 routes {ops.kernel_launches} "
                             f"for launches {counts}")
    del run["engine"]
    for r in reqs:
        px = run["pixels"][r.id]
        if px is None or px.shape != (1, r.height, r.width, 3) \
                or not np.isfinite(px).all():
            raise AssertionError(f"{r.id}: no finite pixels of the "
                                 f"expected shape")
    if run["metrics"]["completed"] != len(reqs):
        raise AssertionError(f"completed {run['metrics']['completed']} of "
                             f"{len(reqs)}")
    if not {"refresh", "hit"} <= set(run["modes"]):
        raise AssertionError(f"cache modes {run['modes']}: expected "
                             f"refresh and hit steps")
    if min(counts[k] for k in DIT_KERNELS) <= 0:
        raise AssertionError(f"a kernel never launched: {counts}")
    if any(ops.launches[k] for k in BWD_KERNELS):
        raise AssertionError(f"serve: a backward kernel launched: "
                             f"{dict(ops.launches)}")
    lat = ", ".join(f"{k} {v:.2f} s" for k, v in sorted(run["latency"].items()))
    print(f"serve: DIT_IMAGE full width ({DIT_IMAGE.num_layers} layers, "
          f"d={DIT_IMAGE.d_model}), SP-4, cache_interval=2, steps=4: "
          f"{len(reqs)} done; latency {lat}; wall {run['wall']:.2f} s; "
          f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"cache {run['modes'].count('refresh')} refresh / "
          f"{run['modes'].count('hit')} hit; launches {counts}; fp32 "
          f"products by route {products}", flush=True)
    return counts


def phase_sp() -> None:
    req = make_request("sp-check", 512)
    px = {}
    for k in (1, 4):
        run = _serve(DIT_IMAGE, FixedSP(k), [req], cache_interval=1)
        del run["engine"]
        px[k] = run["pixels"][req.id]
        torch.cuda.empty_cache()
    err = rel_l2(px[4], px[1])
    print(f"sp: 512 px at SP1 vs SP4 (cache_interval=1): pixel rel-L2 "
          f"{err:.2e} (budget {PIXEL_BUDGET:.0e})", flush=True)
    if not err <= PIXEL_BUDGET:
        raise AssertionError(f"SP1 vs SP4 rel-L2 {err:.2e}")


def _weight_hooks():
    """``setup`` hooks for :func:`_serve`: ``keep`` holds on to an
    engine's weights (``shutdown()`` releases its pipeline), ``copy``
    loads them into the next engine and lets go of them."""
    names, weights = ("dit", "text_encoder", "vae"), {}

    def keep(eng):
        weights.update({n: getattr(eng.pipeline, n).state_dict()
                        for n in names})

    def copy(eng):
        for n in names:
            getattr(eng.pipeline, n).load_state_dict(weights[n])
        weights.clear()
    return keep, copy


def card_vs_cpu(cfg, req) -> tuple[float, dict]:
    """Pixel rel-L2 of ``req`` served at SP-2 with cache_interval=2 on
    the card (kernels) against the CPU (plain versions), same weights;
    and the card's run."""
    keep, copy = _weight_hooks()
    cpu = _serve(cfg, FixedSP(2), [req], cache_interval=2, device="cpu",
                 setup=keep)
    card = _serve(cfg, FixedSP(2), [req], cache_interval=2, setup=copy)
    return rel_l2(card["pixels"][req.id], cpu["pixels"][req.id]), card


def phase_cpu() -> None:
    err, _ = card_vs_cpu(DIT_IMAGE.reduced(), make_request("cpu-check", 128,
                                                          steps=3))
    print(f"cpu: DIT_IMAGE.reduced() 128 px SP-2 cache_interval=2, card "
          f"(kernels) vs CPU (plain): pixel rel-L2 {err:.2e} (budget "
          f"{PIXEL_BUDGET:.0e})", flush=True)
    if not err <= PIXEL_BUDGET:
        raise AssertionError(f"CUDA vs CPU rel-L2 {err:.2e}")


def _settled_allocated() -> int:
    """Bytes of live tensors once the card is idle.  cuBLAS keeps one
    workspace per handle and stream inside the caching allocator; they
    are freed first, so that only the program's own tensors count."""
    torch.cuda.synchronize()
    if hasattr(torch._C, "_cuda_clearCublasWorkspaces"):
        torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated()


def _scenario_gates(name, gates: dict) -> None:
    bad = [k for k, ok in gates.items() if not ok]
    if bad:
        raise AssertionError(f"scenarios: {name} failed {bad}")


def _rank_tracks(path) -> list:
    trace = json.loads(Path(path).read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return sorted(e["args"]["name"] for e in events
                  if e.get("ph") == "M" and e.get("name") == "thread_name"
                  and e["args"]["name"].startswith("rank"))


def phase_scenarios(smi: str) -> dict:
    """The port's six cross-backend demos on the card through their
    ``run_demo``, every engine's DiT livened (the demos' own weights are
    zero-gated, which would make every pixel check one of two zero
    velocities), with the garbage collector off: all six at DIT_IMAGE's
    full width and depth (no cut: the phase takes ~20 s on an H100),
    then the serve_image_dit twin with ``--emit-trace``.  Every serve's
    wall and the device memory left after every engine's ``shutdown()``
    are recorded; returns K1-K3's launches over the phase."""
    import tempfile
    from unittest import mock

    from repro_torch.serving import (cache_demo, elastic_demo, failure_demo,
                                     hybrid_demo, packing_demo,
                                     serve_image_dit, topology_demo)
    from repro_torch.serving import engine as engine_mod
    from repro_torch.training import checkpoint

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    base = _settled_allocated()
    serves, held, restores = [], [], []
    real_serve, real_shutdown = ServingEngine.serve, ServingEngine.shutdown
    real_restore = checkpoint.CheckpointManager.restore

    class Livened(engine_mod.TorchDiTPipeline):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            cache_demo._liven(self)

    def serve(eng, *args, **kw):
        t0 = time.perf_counter()
        try:
            return real_serve(eng, *args, **kw)
        finally:
            torch.cuda.synchronize()
            serves.append((eng.cp.policy.name, time.perf_counter() - t0))

    def shutdown(eng):
        real_shutdown(eng)
        held.append(_settled_allocated() - base)

    def restore(mgr, template, step=None):
        tree, meta = real_restore(mgr, template, step)
        restores.append((mgr.dir.name, meta["step"]))
        return tree, meta

    def walls(start, stop=None):
        return "/".join(f"{t:.2f}" for _, t in serves[start:stop])

    ops.reset_launches()
    gc.disable()
    try:
        with contextlib.ExitStack() as stack:
            for obj, name, value in (
                    (engine_mod, "TorchDiTPipeline", Livened),
                    (ServingEngine, "serve", serve),
                    (ServingEngine, "shutdown", shutdown),
                    (checkpoint.CheckpointManager, "restore", restore)):
                stack.enter_context(mock.patch.object(obj, name, value))
            failure_legs = stack.enter_context(_failure_legs())
            # -- elastic: preempt, requeue, Reallocate at full width ------
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = elastic_demo.run_demo(DIT_IMAGE, device="cuda")
            n_cal = 6                       # calibrate: 3 cells x 2 passes
            sp1 = elastic_demo.sp1_pixels(DIT_IMAGE, device="cuda")
            t_el = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 2**30
            evs = res["wall"]["events"]
            bg = {len(e["ranks"]) for e in evs if e["ev"] == "dispatch"
                  and e["kind"] == "denoise" and e["req"] == "bg"}
            px = res["wall"]["pixels"]["bg"]
            err = rel_l2(px, sp1) if px is not None else float("inf")
            m = res["margins"]
            print(f"scenarios: elastic DIT_IMAGE full width and depth "
                  f"({DIT_IMAGE.num_layers} layers, d={DIT_IMAGE.d_model}): "
                  f"trace_match {res['trace_match']}, telemetry_match "
                  f"{res['telemetry_match']}, attempts {res['attempts']}; "
                  f"margins arrival {m['arrival_margin_s']:.3f} s, decode/"
                  f"denoise {m['decode_vs_denoise_ratio']:.3f}; bg degrees "
                  f"{sorted(bg)}, pixels vs SP-1 rel-L2 {err:.2e}; serve "
                  f"walls s: calibration {walls(0, n_cal)}, wall legs "
                  f"{walls(n_cal, -1)}, SP-1 {walls(-1)}; elastic "
                  f"{t_el:.1f} s; peak mem {peak:.2f} GiB; allocated after "
                  f"each shutdown vs phase start, MiB: "
                  + ", ".join(f"{h / 2**20:.1f}" for h in held), flush=True)
            kinds = {e["ev"] for e in evs}
            _scenario_gates("elastic", {
                "trace_match": res["trace_match"],
                "telemetry_match": res["telemetry_match"],
                "preempt/requeued/reallocate in the wall leg":
                    {"preempt", "requeued", "reallocate"} <= kinds,
                "bg on 4 ranks and on 1": {1, 4} <= bg,
                "bg pixels within the budget of SP-1": err <= PIXEL_BUDGET,
                "slo arrives mid-step": m["arrival_margin_s"] > 0,
                "slo decode before bg's denoise":
                    m["decode_before_denoise"]})

            # -- the other five, also at full width and depth ------------
            cfg = DIT_IMAGE
            for name, run, gates in (
                ("packing", packing_demo.run_demo, lambda r: {
                    "trace_match": r["trace_match"],
                    "one full pack a step": all(
                        len(r["packs"][leg]) == packing_demo.STEPS and all(
                            e["batch"] == packing_demo.N_REQS
                            for e in r["packs"][leg])
                        for leg in ("wall", "sim"))}),
                ("cache", cache_demo.run_demo, lambda r: {
                    "trace_match": r["trace_match"],
                    "modes": r["modes"] == [
                        (0, "refresh"), (1, "hit"), (2, "hit+mig"),
                        (3, "refresh"), (4, "hit"), (5, "hit")],
                    "interval 1 vs exact": r["interval1_exact"],
                    "stale reuse in (0, 5e-2]": 0 < r["rel_l2_err"] <= 5e-2,
                    "migration_bitexact": r["migration_bitexact"]}),
                ("topology", topology_demo.run_demo, lambda r: {
                    "trace_match": r["trace_match"],
                    "pixels_match": r["pixels_match"],
                    "hierarchical GFC on the wall leg":
                        r["wall"]["hierarchical_collectives"] > 0
                        and r["flat"]["hierarchical_collectives"] == 0}),
                ("hybrid", hybrid_demo.run_demo, lambda r: {
                    "trace_match": r["trace_match"],
                    "telemetry_match": r["telemetry_match"],
                    "pixels_match": r["pixels_match"],
                    "scalar_identical": r["scalar_identical"]}),
                ("failure", failure_demo.run_demo, lambda r: {
                    "trace_match": r["trace_match"],
                    "telemetry_match": r["telemetry_match"],
                    "pixels_match": r["pixels_match"],
                    "resumed at step 2 from the step-1 snapshot":
                        (r["snapshot_step"], r["resumed_step"]) == (1, 2),
                    "restored from the on-disk snapshot":
                        ("victim", 1) in restores}),
            ):
                first, n_held = len(serves), len(held)
                t0 = time.perf_counter()
                r = run(cfg, device="cuda")
                extra = {k: r[k] for k in (
                    "attempts", "pixels_rel_l2", "pixels_bitexact",
                    "interval1_rel_l2", "interval1_bitexact", "rel_l2_err")
                    if k in r}
                print(f"scenarios: {name} ({cfg.num_layers} layers, d="
                      f"{cfg.d_model}) {time.perf_counter() - t0:.1f} s: "
                      f"{json.dumps(gates(r), default=str)} "
                      f"{json.dumps(extra, default=str)}; serve walls s "
                      f"{walls(first)}; allocated after each shutdown, MiB"
                      f": " + ", ".join(f"{h / 2**20:.1f}"
                                        for h in held[n_held:]),
                      flush=True)
                if name == "failure":
                    for line, *_ in _failure_margins(failure_legs):
                        print(f"scenarios: failure attempt: {line}",
                              flush=True)
                if not all(gates(r).values()) and "recovery" in r:
                    print(f"scenarios: {name} recovery events, wall "
                          f"{r['recovery']}, sim {r['sim']['recovery']}; "
                          f"t_fail {r['t_fail']:.4f} s; wall dispatches "
                          + ", ".join(f"{e['kind'][:3]}{e.get('step')}@"
                                      f"{e['t']:.4f}"
                                      for e in r["wall"]["events"]
                                      if e["ev"] == "dispatch"), flush=True)
                _scenario_gates(name, gates(r))

            # -- the serve_image_dit twin with --emit-trace --------------
            with tempfile.TemporaryDirectory(prefix="gfdit-trace-") as tmp:
                trace = Path(tmp) / "trace.json"
                t0 = time.perf_counter()
                metrics = serve_image_dit.main(
                    ["--emit-trace", str(trace), "--device", "cuda"])
                tracks = _rank_tracks(trace)
            print(f"scenarios: serve_image_dit --emit-trace "
                  f"{time.perf_counter() - t0:.1f} s: completed "
                  f"{metrics['completed']}, rank tracks {tracks}",
                  flush=True)
            _scenario_gates("serve_image_dit", {
                "completed": metrics["completed"] == 6,
                "one track a rank": tracks == [f"rank{r}" for r in range(4)]})
    finally:
        gc.enable()
    counts = _dit_counts()
    seconds = time.perf_counter() - t_phase
    print(f"scenarios: {seconds:.1f} s, {len(held)} engines; launches "
          f"{counts}; largest allocation left after a shutdown "
          f"{max(held) / 2**20:.2f} MiB (garbage collector off); on {smi}",
          flush=True)
    if min(counts[k] for k in DIT_KERNELS) <= 0:
        raise AssertionError(f"scenarios: a kernel never launched: {counts}")
    if max(held) > 0:
        raise AssertionError(f"scenarios: a dropped engine left "
                             f"{max(held)} bytes on the card")
    return counts


def _stage_walls(run, rid) -> dict:
    """Encode, denoise and decode wall seconds of request ``rid``, from
    the plane's events: each stage ends where the next is dispatched."""
    evs = run["engine"].cp.events
    t = {}
    for e in evs:
        if e.get("req") == rid and e["ev"] == "dispatch":
            key = "denoise" if e["kind"] == "denoise" else e["kind"]
            t.setdefault(key, e["t"])
        elif e.get("req") == rid and e["ev"] == "request_done":
            t["done"] = e["t"]
    return {"encode": t["denoise"] - t["encode"],
            "denoise": t["decode"] - t["denoise"],
            "decode": t["done"] - t["decode"]}


def _host_memory() -> tuple[str, int]:
    """``free -g``'s output and the host's available bytes."""
    free = subprocess.run(["free", "-g"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    avail = next(int(ln.split()[1]) * 1024 for ln in
                 Path("/proc/meminfo").read_text().splitlines()
                 if ln.startswith("MemAvailable:"))
    return free, avail


def _video_serve(label, k, shape, *, cache_interval, setup=None) -> dict:
    """One DIT_VIDEO request on a fresh four-rank engine at FixedSP(k),
    with the launches of K1-K3 counted for this engine alone; checks
    completion and finite pixels of (F_lat, H, W, 3) and prints the
    latency, the stage walls and the peak memory."""
    req = video_request(label, shape)
    want = dit.latent_shape(DIT_VIDEO, *shape)[:1] + shape[:2] + (3,)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    with _expected_products() as routes:
        run = _serve(DIT_VIDEO, FixedSP(k), [req],
                     cache_interval=cache_interval, setup=setup)
    run["counts"] = _dit_counts()
    run["products"] = _check_products(f"video {label} SP-{k}", routes)
    run["peak"] = torch.cuda.max_memory_allocated() / 2**30
    px = run["pixels"][req.id]
    if run["metrics"]["completed"] != 1 or px is None or px.shape != want \
            or not np.isfinite(px).all():
        raise AssertionError(f"video {label}: completed "
                             f"{run['metrics']['completed']}, pixels "
                             f"{None if px is None else px.shape} (want "
                             f"{want}, finite)")
    walls = _stage_walls(run, req.id)
    del run["engine"]
    n = dit.token_count(DIT_VIDEO, *shape)
    print(f"video: {label} {shape[0]}x{shape[1]}x{shape[2]}f ({n} tokens) "
          f"SP-{k}, cache_interval={cache_interval}, {VIDEO_STEPS} steps: "
          f"latency {run['latency'][req.id]:.2f} s, wall {run['wall']:.2f} "
          f"s; encode {walls['encode']:.2f} s, denoise {walls['denoise']:.2f}"
          f" s ({walls['denoise'] / VIDEO_STEPS:.2f} s a step), decode "
          f"{walls['decode']:.2f} s; peak mem {run['peak']:.2f} GiB; cache "
          f"{run['modes']}; launches {run['counts']}; fp32 products by "
          f"route {run['products']}", flush=True)
    return run


def pos_embedding_drift(n: int, d: int, device="cuda") -> None:
    """``dit.pos_embedding(n, d)`` on ``device`` against the CPU's, with
    the frequencies computed on the host (as ``dit.pos_embedding`` does)
    and, for comparison, on ``device``."""
    want = dit.pos_embedding(n, d)
    host = dit.pos_embedding(n, d, device).cpu()
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        d // 2, dtype=torch.float32, device=device) / (d // 2))
    args = torch.arange(n, dtype=torch.float32, device=device)[:, None] \
        * freqs[None]
    on_dev = torch.cat([torch.cos(args), torch.sin(args)], -1).cpu()
    del args
    print(f"video: pos_embedding({n}, {d}) card vs CPU max abs: "
          f"frequencies from the host {(host - want).abs().max():.3e}, "
          f"from the card {(on_dev - want).abs().max():.3e}; rel-L2 "
          f"{rel_l2(host, want):.3e} / {rel_l2(on_dev, want):.3e}",
          flush=True)


@contextlib.contextmanager
def _failure_legs():
    """Keeps each failure-demo attempt's sim leg, then its wall leg (not
    the control leg), in the list it yields."""
    from unittest import mock

    from repro_torch.serving import failure_demo
    legs = []
    real_sim, real_wall = failure_demo.run_sim, failure_demo.run_wall

    def run_sim(*args, **kw):
        legs.append(real_sim(*args, **kw))
        return legs[-1]

    def run_wall(cfg, cost, reqs, t_fail=None, **kw):
        out = real_wall(cfg, cost, reqs, t_fail, **kw)
        if t_fail is not None:          # not the control leg
            legs.append(out)
        return out

    with mock.patch.object(failure_demo, "run_sim", run_sim), \
            mock.patch.object(failure_demo, "run_wall", run_wall):
        yield legs


def _failure_margins(legs) -> list:
    """One line per attempt of ``_failure_legs``: the kill time, the
    calibrated denoise period, how far the wall leg's step 3 started
    behind the sim leg's, and the kill's distance from that step's start
    and end (the gate's margins, half a step each; a negative one is a
    miss).  Returns ``(line, after start, before end)`` tuples."""
    def start(events, step):
        return next((e["t"] for e in events if e["ev"] == "dispatch"
                     and e["kind"] == "denoise" and e.get("step") == step),
                    float("nan"))

    out = []
    for sim, wall in zip(legs[::2], legs[1::2]):
        t_fail = next(e["t"] for e in sim["events"]
                      if e["ev"] == "host_down")
        s3 = start(sim["events"], 3)
        period = s3 - start(sim["events"], 2)
        w3 = start(wall["events"], 3)
        after, before = t_fail - w3, w3 + period - t_fail
        out.append((f"t_fail {t_fail:.4f} s, denoise period "
                    f"{period * 1e3:.1f} ms, wall step 3 "
                    f"{(w3 - s3) * 1e3:+.1f} ms behind the sim's, kill "
                    f"{after * 1e3:.1f} ms after its start and "
                    f"{before * 1e3:.1f} before its end, match "
                    f"{wall['signature'] == sim['signature']}",
                    after, before))
    return out


def phase_failure(smi: str, runs: int = 10) -> None:
    """The failure demo ``runs`` times at DIT_IMAGE's full width and
    depth, its DiT livened and the garbage collector off, as the
    scenarios phase runs it, with ``_failure_margins`` for every
    attempt.  Fails if a run used up its attempts."""
    from unittest import mock

    from repro_torch.serving import cache_demo, failure_demo
    from repro_torch.serving import engine as engine_mod

    class Livened(engine_mod.TorchDiTPipeline):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            cache_demo._liven(self)

    margins, used, missed = [], [], []
    gc.disable()
    try:
        with mock.patch.object(engine_mod, "TorchDiTPipeline", Livened), \
                _failure_legs() as legs:
            for i in range(runs):
                legs.clear()
                before = torch.cuda.memory_stats()
                r = failure_demo.run_demo(DIT_IMAGE, device="cuda")
                after = torch.cuda.memory_stats()
                used.append(r["attempts"])
                if not (r["trace_match"] and r["telemetry_match"]):
                    missed.append(i)
                for line, *m in _failure_margins(legs):
                    margins.append(m)
                    print(f"failure: run {i} {line}", flush=True)
                # the caching allocator's cudaMalloc retries (each frees
                # the cache and synchronizes) and cudaMalloc/cudaFree calls
                print(f"failure: run {i} allocator: " + ", ".join(
                    f"{k} +{after.get(k, 0) - before.get(k, 0)}"
                    for k in ("num_alloc_retries", "num_device_alloc",
                              "num_device_free"))
                    + f", reserved {torch.cuda.memory_reserved() / 2**30:.1f}"
                    f" GiB", flush=True)
    finally:
        gc.enable()
    print(f"failure: {runs} runs, attempts {used}; closest margins "
          f"{min(m[0] for m in margins) * 1e3:.1f} ms after step 3's "
          f"start, {min(m[1] for m in margins) * 1e3:.1f} ms before its "
          f"end; on {smi}", flush=True)
    if missed:
        raise AssertionError(f"failure: runs {missed} used up their "
                             f"attempts")


def phase_video(smi: str) -> dict:
    """The paper's video class on the card: DIT_VIDEO at full width and
    depth (30 layers, d_model 3072, 24 heads x 128, d_ff 12288, 7.39 B
    parameters, 29.6 GB in fp32), one engine live at a time.
    (a) class S (20,280 tokens) uncached at SP-4, then at SP-1 on the same
        weights (copied by ``state_dict``): pixels within PIXEL_BUDGET;
    (b) the §11 hit path at head dim 128: 17 frames (7,800 tokens) at
        SP-4, ``cache_interval=2``: a refresh step, then a hit through K3;
    (c) DIT_VIDEO.reduced() at 64x64x9 frames, SP-2, cache_interval=2,
        on the card (kernels) and on the CPU (plain versions);
    and the positional embedding at video positions, card vs CPU, with
    the frequencies computed on the host (as ``dit.pos_embedding`` does)
    and on the card.  Returns K1-K3's launches over the phase."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    free, avail = _host_memory()
    dev_free, dev_total = torch.cuda.mem_get_info()
    n_s, n_hit = (dit.token_count(DIT_VIDEO, *s) for s in (VIDEO_S, VIDEO_HIT))
    snap = {n: 4 * DIT_VIDEO.num_layers * 2 * n * DIT_VIDEO.d_model * 4
            for n in (n_s, n_hit)}
    print(f"video: host available {avail / 1e9:.1f} GB; §11 snapshots of "
          f"an SP-4 refresh take {snap[n_hit] / 1e9:.1f} GB at "
          f"{n_hit} tokens, {snap[n_s] / 1e9:.1f} GB at {n_s}; card free "
          f"{dev_free / 2**30:.2f} of {dev_total / 2**30:.2f} GiB; free -g:"
          f"\n{free}", flush=True)
    totals = dict.fromkeys(DIT_KERNELS + FP32_ROUTES + ("linear",), 0)

    def add(run):
        for name in totals:
            totals[name] += run["counts"][name]

    # (a) class S at SP-4, then SP-1 on the same weights
    px = {}
    for k, setup in zip((4, 1), _weight_hooks()):
        run = _video_serve("S", k, VIDEO_S, cache_interval=None, setup=setup)
        add(run)
        px[k] = run["pixels"]["S"]
        if min(run["counts"][n] for n in ("fused_adaln", "attention")) <= 0:
            raise AssertionError(f"video S SP-{k}: K1 or K2 never "
                                 f"launched: {run['counts']}")
        del run
        torch.cuda.empty_cache()
    err = rel_l2(px[4], px[1])
    print(f"video: S SP-1 vs SP-4 pixel rel-L2 {err:.2e} (budget "
          f"{PIXEL_BUDGET:.0e})", flush=True)
    if not err <= PIXEL_BUDGET:
        raise AssertionError(f"video S: SP-1 vs SP-4 rel-L2 {err:.2e}")
    del px

    # (b) the §11 hit at head dim 128
    run = _video_serve("hit", 4, VIDEO_HIT, cache_interval=2)
    add(run)
    if run["modes"] != ["refresh", "hit"] or \
            run["counts"]["splice_attention"] <= 0:
        raise AssertionError(f"video hit: modes {run['modes']}, launches "
                             f"{run['counts']}")
    del run
    torch.cuda.empty_cache()

    # (c) card vs CPU on the reduced model
    ops.reset_launches()
    err, card = card_vs_cpu(DIT_VIDEO.reduced(),
                            video_request("video-cpu-check", (64, 64, 9),
                                          steps=3))
    for name, n in _dit_counts().items():
        totals[name] += n
    print(f"video: DIT_VIDEO.reduced() 64x64x9f SP-2 cache_interval=2, "
          f"modes {card['modes']}, card (kernels) vs CPU (plain): pixel "
          f"rel-L2 {err:.2e} (budget {PIXEL_BUDGET:.0e})", flush=True)
    if not err <= PIXEL_BUDGET:
        raise AssertionError(f"video: CUDA vs CPU rel-L2 {err:.2e}")

    # the positional embedding, card vs CPU, host or card frequencies
    for n in (n_s, dit.token_count(DIT_VIDEO, 720, 1280, 81)):
        pos_embedding_drift(n, DIT_VIDEO.d_model)
    seconds = time.perf_counter() - t_phase
    print(f"video: {seconds:.1f} s; launches {totals}; on {smi}", flush=True)
    return totals


#: K2 launches by the ``attention_apply`` call that made them, counted
#: while :func:`_k2_sites` is open: ``self`` (bidirectional: whisper's
#: encoder), ``cross`` (keys from ``kv_x`` or a cross cache) or ``causal``
K2_SITES = {"self": 0, "cross": 0, "causal": 0}


@contextlib.contextmanager
def _k2_sites():
    """Count K2 launches into :data:`K2_SITES` by attention site."""
    apply = layers.attention_apply

    def counted(*args, causal=True, kv_x=None, **kw):
        before = ops.launches["attention"]
        try:
            return apply(*args, causal=causal, kv_x=kv_x, **kw)
        finally:
            site = ("cross" if kv_x is not None else
                    "causal" if causal else "self")
            K2_SITES[site] += ops.launches["attention"] - before
    layers.attention_apply = counted
    try:
        yield
    finally:
        layers.attention_apply = apply


def _reset_counts() -> None:
    ops.reset_launches()
    for site in K2_SITES:
        K2_SITES[site] = 0


def _lm_run(model, cfg, prompt, steps, dtype, feed=None, extra=(),
            mla_absorbed=False) -> dict:
    """Prefill ``prompt`` (after ``extra``'s frontend inputs: whisper's
    frames) and decode ``steps`` tokens through the serve-loop steps, on
    a cache from the family's ``init_cache``: greedily, or teacher-forced
    on ``feed``'s columns.  Returns the logits (b, 1 + steps, vocab), the
    tokens fed to decode (b, steps), the prefill and decode wall times,
    and the kernel launches of each, also by K2 site."""
    prefill = serve_loop.make_prefill_step(cfg, dtype=dtype)
    step = serve_loop.make_serve_step(cfg, dtype=dtype,
                                      mla_absorbed=mla_absorbed)
    b, s = prompt.shape
    cache = get_model(cfg).init_cache(cfg, b, s + steps, dtype=dtype,
                                      device=prompt.device)
    sync = torch.cuda.synchronize if prompt.is_cuda else (lambda: None)
    sync()
    before = dict(ops.launches), dict(K2_SITES)
    routes = dict(ops.kernel_launches)
    t0 = time.perf_counter()
    lg, cache = prefill(model, prompt, *extra, cache)
    sync()
    t_prefill = time.perf_counter() - t0
    mid = dict(ops.launches), dict(K2_SITES)
    logits, fed = [lg[:, 0]], []
    t0 = time.perf_counter()
    for i in range(steps):
        tok = (lg[:, -1].argmax(-1, keepdim=True) if feed is None
               else feed[:, i:i + 1])
        fed.append(tok)
        pos = torch.full((b,), s + i, device=prompt.device)
        lg, cache = step(model, tok, cache, pos)
        logits.append(lg[:, 0])
    sync()
    t_decode = time.perf_counter() - t0
    after = ops.launches, K2_SITES

    def diff(a, b):
        return {k: b[k] - a[k] for k in a}
    return {"logits": torch.stack(logits, 1), "fed": torch.cat(fed, 1),
            "t_prefill": t_prefill, "t_decode": t_decode,
            "prefill_launches": diff(before[0], mid[0]),
            "decode_launches": diff(mid[0], after[0]),
            "prefill_sites": diff(before[1], mid[1]),
            "decode_sites": diff(mid[1], after[1]),
            "routes": diff(routes, ops.kernel_launches)}


def _ssd_bf16_leg(model, cfg, prompt, phase: str, smi: str, base) -> dict:
    """The serve path of ``cfg`` under ``dryrun.apply_variant(cfg,
    "ssd_bf16")`` (intra_dtype="bfloat16", the JAX package's variant of
    that name) on the same model: a warm-up, then a bf16 prefill of
    ``prompt`` and LM_DECODE greedy decode steps.  K4 must launch once a
    Mamba2 layer in the prefill, in bf16 only, and never in a decode
    step; the logits finite.  Prints prefill tokens/s, decode ms a step,
    peak memory, the launches and the prefill logits' rel-L2 from
    ``base``'s (the fp32-intra leg's on the same weights and prompt).
    Returns the prefill's launches, with K4's by dtype."""
    vcfg = dryrun.apply_variant(cfg, "ssd_bf16")
    _lm_run(model, vcfg, prompt, 1, torch.bfloat16)     # warm-up, uncounted
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    run = _lm_run(model, vcfg, prompt, LM_DECODE, torch.bfloat16)
    peak = torch.cuda.max_memory_allocated() / 2**30
    pre, dec, routes = (run[k] for k in ("prefill_launches",
                                         "decode_launches", "routes"))
    logits = run["logits"]
    if not torch.isfinite(logits).all() or logits.shape != (
            LM_BATCH, LM_DECODE + 1, cfg.vocab_size):
        raise AssertionError(f"{phase}: ssd_bf16 logits "
                             f"{tuple(logits.shape)} not all finite")
    if (pre["ssd"] != cfg.num_layers or dec["ssd"]
            or routes["ssd bf16"] != cfg.num_layers or routes["ssd fp32"]):
        raise AssertionError(f"{phase}: ssd_bf16 launches prefill {pre}, "
                             f"decode {dec}, K4 by dtype {routes}")
    drift = rel_l2(logits[:, 0].float().cpu(), base[:, 0].float().cpu())
    t_prefill, t_decode = run["t_prefill"], run["t_decode"]
    print(f"{phase}: {cfg.name} ssd_bf16 (intra_dtype bfloat16: K4 in "
          f"bf16), bf16, batch {LM_BATCH}: prefill {LM_PROMPT} tokens "
          f"{LM_BATCH * LM_PROMPT / t_prefill:.0f} tokens/s "
          f"({t_prefill * 1e3:.1f} ms); decode {LM_DECODE} tokens "
          f"{t_decode / LM_DECODE * 1e3:.2f} ms/step; peak mem {peak:.2f} "
          f"GiB; launches prefill {pre}, K4 by dtype "
          f"{ {k: v for k, v in routes.items() if k.startswith('ssd')} }; "
          f"prefill logits vs the intra_dtype float32 leg's: rel-L2 "
          f"{drift:.2e}; on {smi}", flush=True)
    return {**pre, "ssd bf16": routes["ssd bf16"]}


def phase_lm(smi: str) -> dict:
    """The Mamba2 serving path at full width through K4; returns the
    launch counts of its bf16 prefill + decode."""
    cfg = MAMBA
    held = torch.cuda.memory_allocated() / 2**30      # left by earlier phases
    model = ssm.Mamba2(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0))
    ssm.init_published_a_dt(model)
    weights = torch.cuda.memory_allocated() / 2**30 - held
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=torch.Generator().manual_seed(1)).cuda()
    _lm_run(model, cfg, prompt, 1, torch.bfloat16)     # warm-up, uncounted
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    run = _lm_run(model, cfg, prompt, LM_DECODE, torch.bfloat16)
    logits, fed, t_prefill, t_decode = (run[k] for k in (
        "logits", "fed", "t_prefill", "t_decode"))
    counts = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not torch.isfinite(logits).all() or logits.shape != (
            LM_BATCH, LM_DECODE + 1, cfg.vocab_size):
        raise AssertionError(f"lm: logits {tuple(logits.shape)} not all "
                             f"finite")
    if counts["ssd"] != cfg.num_layers or any(counts[k] for k in DIT_KERNELS):
        raise AssertionError(f"lm: launches {counts}, expected ssd = "
                             f"{cfg.num_layers} (one per layer, prefill)")
    d_inner, heads, _ = ssm.ssm_dims(cfg)
    print(f"lm: mamba2-1.3b full width ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {heads} SSD heads), bf16, batch {LM_BATCH}: "
          f"prefill {LM_PROMPT} tokens {LM_BATCH * LM_PROMPT / t_prefill:.0f}"
          f" tokens/s ({t_prefill * 1e3:.1f} ms); decode {LM_DECODE} tokens "
          f"{t_decode / LM_DECODE * 1e3:.2f} ms/token (one step of "
          f"{LM_BATCH} sequences); peak mem {peak:.2f} GiB ({held:.2f} "
          f"held before the phase, {weights:.2f} of weights); launches "
          f"{counts}, K4 by dtype {run['routes']['ssd fp32']} fp32; on "
          f"{smi}", flush=True)
    variant = _ssd_bf16_leg(model, cfg, prompt, "lm", smi, logits)

    # fp32: prefill + decode (teacher-forced on the bf16 run's tokens)
    # against the forward over the same 2080 tokens
    before = ops.launches["ssd"]
    got = _lm_run(model, cfg, prompt, LM_DECODE, torch.float32,
                  feed=fed)["logits"]
    with torch.inference_mode():
        full, _ = ssm.forward(model, torch.cat([prompt, fed], 1), cfg,
                              dtype=torch.float32)
    want = full[:, LM_PROMPT - 1:]
    del full
    launched = ops.launches["ssd"] - before
    err = ((got - want).abs().max() / want.abs().max()).item()
    print(f"lm: fp32 prefill + {LM_DECODE} decode steps vs the "
          f"teacher-forced forward ({LM_PROMPT + LM_DECODE} tokens, K4 at "
          f"l={LM_PROMPT} and at the ragged l={LM_PROMPT + LM_DECODE}, "
          f"{launched} launches): max |diff| / max |logit| {err:.2e} "
          f"(budget {LOGIT_BUDGET:.0e})", flush=True)
    if not err <= LOGIT_BUDGET or launched != 2 * cfg.num_layers:
        raise AssertionError(f"lm: decode vs forward {err:.2e}, "
                             f"{launched} K4 launches")
    del model, got, want
    torch.cuda.empty_cache()
    return {"ssd": counts["ssd"] + variant["ssd"],
            "ssd bf16": variant["ssd bf16"]}


def phase_lm_cpu() -> None:
    """mamba2-1.3b.reduced() with the same weights on the card (K4) and
    on the CPU (plain versions): forward, prefill and decode logits."""
    cfg = MAMBA.reduced()
    cpu = ssm.Mamba2(cfg, device="cpu")
    ssm.init_published_a_dt(cpu)
    card = ssm.Mamba2(cfg)
    card.load_state_dict(cpu.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(2))
    out = {}
    for name, model in (("cpu", cpu), ("card", card)):
        dev = next(model.parameters()).device
        t = toks.to(dev)
        with torch.inference_mode():
            full, _ = ssm.forward(model, t, cfg, dtype=torch.float32)
        steps = _lm_run(model, cfg, t[:, :32], 8, torch.float32,
                        feed=t[:, 32:])["logits"]
        out[name] = [full.cpu(), steps.cpu()]
    err = max(rel_l2(a, b) for a, b in zip(out["card"], out["cpu"]))
    print(f"lm-cpu: mamba2-1.3b.reduced() forward (40 tokens) and prefill "
          f"32 + decode 8, card (K4) vs CPU (plain): logit rel-L2 "
          f"{err:.2e} (budget {LM_CPU_BUDGET:.0e})", flush=True)
    if not err <= LM_CPU_BUDGET:
        raise AssertionError(f"lm-cpu: card vs CPU rel-L2 {err:.2e}")


def phase_hybrid(smi: str) -> dict:
    """zamba2-7b at full width and depth through K4 (every Mamba2 layer of
    a prefill) and K2 causal at head dim 112 (the shared block in the
    forward); returns the launches of its bf16 prefill and of the fp32
    forward."""
    cfg = ZAMBA
    t_phase = time.perf_counter()
    k, n_groups, tail = hybrid._group_plan(cfg)
    held = torch.cuda.memory_allocated() / 2**30      # left by earlier phases
    model = hybrid.Hybrid(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0))
    ssm.init_published_a_dt(model)
    weights = torch.cuda.memory_allocated() / 2**30 - held
    n_params = sum(p.numel() for p in model.parameters())
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                           generator=torch.Generator().manual_seed(1)).cuda()
    _lm_run(model, cfg, prompt, 1, torch.bfloat16)     # warm-up, uncounted
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    run = _lm_run(model, cfg, prompt, LM_DECODE, torch.bfloat16)
    peak = torch.cuda.max_memory_allocated() / 2**30
    logits, pre, dec = run["logits"], run["prefill_launches"], \
        run["decode_launches"]
    if {n: pre[n] + dec[n] for n in pre} != ops.launches:
        raise AssertionError(f"hybrid: launches {ops.launches} outside the "
                             f"prefill and decode steps")
    if not torch.isfinite(logits).all() or logits.shape != (
            LM_BATCH, LM_DECODE + 1, cfg.vocab_size):
        raise AssertionError(f"hybrid: logits {tuple(logits.shape)} not all "
                             f"finite")
    if (pre["ssd"] != cfg.num_layers or dec["ssd"]
            or any(pre[n] + dec[n] for n in DIT_KERNELS)):
        raise AssertionError(f"hybrid: launches prefill {pre}, decode {dec}"
                             f"; expected ssd = {cfg.num_layers} a prefill, "
                             f"none in decode, no DiT kernel")
    _, heads, _ = ssm.ssm_dims(cfg)
    t_prefill, t_decode = run["t_prefill"], run["t_decode"]
    print(f"hybrid: zamba2-7b full width ({cfg.num_layers} Mamba2 layers in "
          f"{n_groups} groups of {k} + {tail}, d_model {cfg.d_model}, "
          f"{heads} SSD heads; shared block {cfg.num_heads} x "
          f"{cfg.head_dim} applied {n_groups} times; {n_params / 1e9:.2f} B "
          f"parameters), bf16, batch {LM_BATCH}: prefill {LM_PROMPT} tokens "
          f"{LM_BATCH * LM_PROMPT / t_prefill:.0f} tokens/s "
          f"({t_prefill * 1e3:.1f} ms); decode {LM_DECODE} tokens "
          f"{t_decode / LM_DECODE * 1e3:.2f} ms/step (one step of "
          f"{LM_BATCH} sequences); peak mem {peak:.2f} GiB ({held:.2f} held "
          f"before the phase, {weights:.2f} of fp32 weights); launches "
          f"prefill {pre}, decode {dec}; on {smi}", flush=True)
    variant = _ssd_bf16_leg(model, cfg, prompt, "hybrid", smi, logits)

    # fp32: prefill + decode (teacher-forced on the bf16 run's tokens)
    # against the forward over the same 2080 tokens
    got = _lm_run(model, cfg, prompt, LM_DECODE, torch.float32,
                  feed=run["fed"])["logits"]
    ops.reset_launches()
    with torch.inference_mode():
        full, _ = hybrid.forward(model, torch.cat([prompt, run["fed"]], 1),
                                 cfg, dtype=torch.float32)
    fwd = dict(ops.launches)
    want = full[:, LM_PROMPT - 1:]
    del full
    err = ((got - want).abs().max() / want.abs().max()).item()
    print(f"hybrid: fp32 prefill + {LM_DECODE} decode steps vs the "
          f"teacher-forced forward ({LM_PROMPT + LM_DECODE} tokens: K2 causal"
          f" at d={cfg.head_dim}, K4 at the ragged l="
          f"{LM_PROMPT + LM_DECODE}; forward launches {fwd}): max |diff| / "
          f"max |logit| {err:.2e} (budget {LOGIT_BUDGET:.0e})", flush=True)
    if (not err <= LOGIT_BUDGET or fwd["attention"] != n_groups
            or fwd["ssd"] != cfg.num_layers):
        raise AssertionError(f"hybrid: decode vs forward {err:.2e}, "
                             f"forward launches {fwd}")
    del model, got, want
    torch.cuda.empty_cache()
    print(f"hybrid: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return {"prefill": pre, "forward": fwd, "ssd_bf16": variant}


def _reduced_card_vs_cpu(cfg, toks, n_prefill, mla_absorbed=False,
                         frames=None) -> float:
    """``cfg`` (reduced) with the same weights on the card (kernels) and
    on the CPU (plain versions): the largest logit rel-L2 between them,
    over the forward on ``toks`` and a prefill of ``n_prefill`` tokens
    plus teacher-forced decode steps to the end (after ``frames``, the
    encoder's stub input, where the family takes them)."""
    family = get_model(cfg)
    cpu = family.init(cfg, device="cpu")
    ssm.init_published_a_dt(cpu)
    card = family.init(cfg)
    card.load_state_dict(cpu.state_dict())
    out = {}
    for name, model in (("cpu", cpu), ("card", card)):
        dev = next(model.parameters()).device
        t = toks.to(dev)
        extra = () if frames is None else (frames.to(dev),)
        with torch.inference_mode():
            full, _ = family.forward(model, t, *extra, cfg,
                                     dtype=torch.float32)
        steps = _lm_run(model, cfg, t[:, :n_prefill], t.shape[1] - n_prefill,
                        torch.float32, feed=t[:, n_prefill:], extra=extra,
                        mla_absorbed=mla_absorbed)["logits"]
        out[name] = [full.cpu(), steps.cpu()]
    return max(rel_l2(a, b) for a, b in zip(out["card"], out["cpu"]))


def phase_hybrid_cpu() -> None:
    """zamba2-7b, yi-6b and gemma3-12b at ``.reduced()`` with the same
    weights on the card (K2 at d=32, K4 at (16, 16, 16)) and on the CPU
    (plain versions): forward over 80 tokens, and a 72-token prefill
    (past gemma3's 64-key SWA ring) plus 8 decode steps."""
    t_phase = time.perf_counter()
    toks = torch.randint(0, 512, (2, 80),
                         generator=torch.Generator().manual_seed(3))
    errs = {arch: _reduced_card_vs_cpu(get_config(arch).reduced(), toks, 72)
            for arch in ("zamba2-7b", "yi-6b", "gemma3-12b")}
    print(f"hybrid-cpu: .reduced() forward (80 tokens) and prefill 72 + "
          f"decode 8, card vs CPU, logit rel-L2: "
          + ", ".join(f"{a} {e:.2e}" for a, e in errs.items())
          + f" (budget {LM_CPU_BUDGET:.0e}); "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if not max(errs.values()) <= LM_CPU_BUDGET:
        raise AssertionError(f"hybrid-cpu: card vs CPU rel-L2 {errs}")


def _zoo_model(cfg):
    """``cfg``'s model at full width on the card from seed 0, with its
    parameter count and the GiB its fp32 weights take."""
    held = torch.cuda.memory_allocated()
    model = get_model(cfg).init(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    return model, n_params, (torch.cuda.memory_allocated() - held) / 2**30


def _zoo_serve(model, cfg, prompt, extra=(), mla_absorbed=False) -> dict:
    """The bf16 serve of one zoo model: a warm-up (one decode step), then
    a prefill of ``prompt`` and 32 greedy decode steps with the launches
    counted from zero.  Checks finite logits of the expected shape and
    that every launch fell in a prefill or a decode step; prints tokens/s,
    ms a step, peak memory and the launches.  Returns the run."""
    b, s = prompt.shape
    _lm_run(model, cfg, prompt, 1, torch.bfloat16, extra=extra,
            mla_absorbed=mla_absorbed)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    run = _lm_run(model, cfg, prompt, LM_DECODE, torch.bfloat16,
                  extra=extra, mla_absorbed=mla_absorbed)
    peak = torch.cuda.max_memory_allocated() / 2**30
    pre, dec = run["prefill_launches"], run["decode_launches"]
    if {n: pre[n] + dec[n] for n in pre} != ops.launches:
        raise AssertionError(f"zoo: {cfg.name}: launches {ops.launches} "
                             f"outside the prefill and decode steps")
    if not torch.isfinite(run["logits"]).all() or run["logits"].shape \
            != (b, LM_DECODE + 1, cfg.vocab_size):
        raise AssertionError(f"zoo: {cfg.name}: logits "
                             f"{tuple(run['logits'].shape)} not all finite")
    mode = "" if cfg.mla is None else (
        " absorbed" if mla_absorbed else " naive")
    n_in = b * (s + sum(x.shape[1] for x in extra))
    print(f"zoo: {cfg.name}{mode} bf16, batch {b}: prefill {s} tokens"
          f"{f' + {extra[0].shape[1]} frames' if extra else ''} "
          f"{n_in / run['t_prefill']:.0f} inputs/s "
          f"({run['t_prefill'] * 1e3:.1f} ms); decode {LM_DECODE} "
          f"steps {run['t_decode'] / LM_DECODE * 1e3:.2f} ms/step; peak "
          f"mem {peak:.2f} GiB; launches prefill {pre}, decode {dec}",
          flush=True)
    return run


def _zoo_exact(model, cfg, prompt, feed, extra=(), mla_absorbed=False):
    """fp32 prefill of ``prompt`` + teacher-forced decode on ``feed``
    against ``forward`` over the same tokens: max |diff| / max |logit|,
    the run (:func:`_lm_run`'s dict) and the forward's launches, with its
    K2 launches by site."""
    _reset_counts()
    with torch.inference_mode():
        full, _ = get_model(cfg).forward(
            model, torch.cat([prompt, feed], 1), *extra, cfg,
            dtype=torch.float32)
    fwd = {**ops.launches, "sites": dict(K2_SITES)}
    want = full[:, prompt.shape[1] - 1:]
    del full
    run = _lm_run(model, cfg, prompt, feed.shape[1], torch.float32,
                  feed=feed, extra=extra, mla_absorbed=mla_absorbed)
    err = ((run["logits"] - want).abs().max() / want.abs().max()).item()
    return err, run, fwd


def _whisper_k2(run) -> dict:
    """A whisper prefill + decode run's K2 launches as the kernels line
    reports them: the prefill's encoder self-attentions and its cross-
    attentions, and the decode steps' cross-attentions, each counted at
    its site.  Fails unless every launch was counted at a site and they
    are one a layer: encoder self and cross in a prefill, cross in each
    decode step, no causal (cached decoder self runs the plain path)."""
    pre, dec = run["prefill_sites"], run["decode_sites"]
    got = {"self": pre["self"], "cross": pre["cross"],
           "decode": dec["cross"]}
    want = {"self": WHISPER.num_encoder_layers, "cross": WHISPER.num_layers,
            "decode": WHISPER.num_layers * LM_DECODE}
    launched = (run["prefill_launches"]["attention"]
                + run["decode_launches"]["attention"])
    if (got != want or pre["causal"] or dec["self"] or dec["causal"]
            or sum(pre.values()) + sum(dec.values()) != launched):
        raise AssertionError(f"zoo: whisper K2 launches prefill {pre}, "
                             f"decode {dec} ({launched} in all); expected "
                             f"{want}")
    return got


def _whisper_routes(sites: dict, routes: dict, dtype) -> dict:
    """The routes K2's ``dtype`` kernel took in a whisper prefill +
    decode run: each site's launches on the route its shape calls for
    (the encoder's 1500 queries on the tile kernel; the cross-attention
    of the 4-token prompt and of each decode step to the 1500 frames on
    split keys, where its 64 tiles cannot fill the SMs), none on the
    other dtype's.  Fails on any other count.  (The fp32 products'
    GEMM launches, also in ``ops.kernel_launches``, are not K2's.)"""
    routes = {k: v for k, v in routes.items() if k != "gemm fp32"}
    b, h, d, f = ZOO_BATCH, WHISPER.num_heads, WHISPER.head_dim, \
        WHISPER.frontend_seq
    mine = FP32_ROUTES if dtype == torch.float32 else BF16_ROUTES
    want = dict.fromkeys(routes, 0)
    for site, sq in (("self", f), ("cross", ZOO_PROMPT), ("decode", 1)):
        split = ops.attention_splits(b, sq, f, h, d, dtype) > 1
        want[mine[split]] += sites[site]
    if routes != want:
        raise AssertionError(f"zoo: whisper {str(dtype)[6:]} routes "
                             f"{routes}, expected {want}")
    return {r: routes[r] for r in mine}


def phase_zoo(smi: str) -> dict:
    """The rest of the LM zoo on the card, one model live at a time:
    whisper-medium at full width and depth through K2 (encoder self,
    cross at prefill and decode, the forward's causal decoder self),
    mixtral-8x7b (SWA + MoE; no kernel, as in the JAX package) and
    deepseek-v2-236b (MLA, naive and absorbed decode; no kernel) at full
    width with depth cut to fit the card in fp32.  Each serves a bf16
    prefill + 32 greedy decode steps, then an fp32 prefill + decode
    against its forward.  Returns whisper's K2 launches by site, of the
    bf16 serve and of the fp32 prefill + decode."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(11)

    # -- whisper-medium: 24 + 24 layers, K2 at head dim 64 ------------------
    cfg = WHISPER
    model, n_params, gib = _zoo_model(cfg)
    frames = torch.randn((ZOO_BATCH, cfg.frontend_seq, cfg.d_model),
                         generator=gen).cuda()
    prompt = torch.randint(0, cfg.vocab_size, (ZOO_BATCH, ZOO_PROMPT),
                           generator=gen).cuda()
    print(f"zoo: whisper-medium full width and depth ({cfg.num_encoder_layers}"
          f" encoder + {cfg.num_layers} decoder layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads x {cfg.head_dim}; "
          f"{n_params / 1e9:.3f} B parameters, {gib:.2f} GiB fp32)",
          flush=True)
    with _k2_sites():
        run = _zoo_serve(model, cfg, prompt, (frames,))
        others = {k: run["prefill_launches"][k] + run["decode_launches"][k]
                  for k in ops.launches if k != "attention"}
        if any(others.values()):
            raise AssertionError(f"zoo: whisper launched {others}")
        whisper = {"bf16": _whisper_k2(run), "routes": {}}
        if run["routes"]:
            whisper["routes"].update(_whisper_routes(
                whisper["bf16"], run["routes"], torch.bfloat16))
        err, exact, fwd = _zoo_exact(model, cfg, prompt, run["fed"],
                                     (frames,))
        whisper["fp32"] = _whisper_k2(exact)
        if FP32_ROUTES[0] in exact["routes"]:
            whisper["routes"].update(_whisper_routes(
                whisper["fp32"], exact["routes"], torch.float32))
    n = cfg.num_layers
    print(f"zoo: whisper-medium fp32 prefill + {LM_DECODE} decode steps vs "
          f"the teacher-forced forward (forward launches {fwd}): max |diff|"
          f" / max |logit| {err:.2e} (budget {ZOO_LOGIT_BUDGET:.0e}); K2 "
          f"launches by site {whisper}", flush=True)
    if not err <= ZOO_LOGIT_BUDGET or fwd["attention"] != \
            cfg.num_encoder_layers + 2 * n or fwd["sites"] != {
                "self": cfg.num_encoder_layers, "cross": n, "causal": n}:
        raise AssertionError(f"zoo: whisper decode vs forward {err:.2e}, "
                             f"forward launches {fwd}")
    del model, frames, run, exact
    torch.cuda.empty_cache()

    # -- mixtral-8x7b and deepseek-v2-236b: no kernel on the path but the
    # fp32 products' GEMM -------------------------------------------------
    for cfg, batch in ((MIXTRAL, LM_BATCH), (DEEPSEEK, 1)):
        t0 = time.perf_counter()
        model, n_params, gib = _zoo_model(cfg)
        print(f"zoo: {cfg.name} full width, {cfg.num_layers} of "
              f"{get_config(cfg.name).num_layers} layers "
              f"({cfg.moe.num_experts} experts top-{cfg.moe.top_k}, "
              f"{cfg.attention} attention; "
              f"{n_params / 1e9:.3f} B parameters, {gib:.2f} GiB fp32)",
              flush=True)
        prompt = torch.randint(0, cfg.vocab_size, (batch, LM_PROMPT),
                               generator=gen).cuda()
        # fp32 against the forward where its MoE capacity is exact, on the
        # first serve's tokens
        short, feed = prompt[:1, :EXACT_PROMPT[cfg.name]], None
        tokens = (short.shape[1] + LM_DECODE) * cfg.moe.top_k
        errs, steps, launched, products = {}, {}, 0, 0
        for absorbed in ((False, True) if cfg.mla is not None else (False,)):
            run = _zoo_serve(model, cfg, prompt, mla_absorbed=absorbed)
            if any(run["prefill_launches"].values()) or any(
                    run["decode_launches"].values()):
                raise AssertionError(f"zoo: {cfg.name} launched a kernel")
            feed = run["fed"][:1] if feed is None else feed
            errs[absorbed], exact, _ = _zoo_exact(
                model, cfg, short, feed, mla_absorbed=absorbed)
            steps[absorbed] = exact["logits"]
            launched += sum(n for k, n in ops.launches.items()
                            if k != "linear")
            products += ops.launches["linear"]
            del run, exact
        line = (f"zoo: {cfg.name} fp32 prefill {short.shape[1]} + "
                f"{LM_DECODE} decode steps vs the teacher-forced forward "
                f"({tokens} routed copies <= 4096: exact capacity; "
                f"{launched} kernel launches, {products} fp32 products on "
                f"the GEMM): max |diff| / max |logit| "
                + ", ".join(f"{'absorbed' if a else 'naive'} {e:.2e}"
                            for a, e in errs.items())
                + f" (budget {ZOO_LOGIT_BUDGET:.0e})")
        ok = (max(errs.values()) <= ZOO_LOGIT_BUDGET and tokens <= 4096
              and not launched)
        if True in steps:
            want = steps[False]
            mla = ((steps[True] - want).abs().max()
                   / want.abs().max()).item()
            line += (f"; absorbed vs naive decode {mla:.2e} (budget "
                     f"{MLA_BUDGET:.0e})")
            ok = ok and mla <= MLA_BUDGET
        print(line + f"; {time.perf_counter() - t0:.1f} s", flush=True)
        if not ok:
            raise AssertionError(f"zoo: {cfg.name} fp32 checks failed")
        del model, steps, prompt, feed
        torch.cuda.empty_cache()
    print(f"zoo: {time.perf_counter() - t_phase:.1f} s; whisper K2 launches "
          f"{whisper} (routes: the bf16 serve's, by kernel); on {smi}",
          flush=True)
    return whisper


def phase_zoo_cpu() -> None:
    """mixtral-8x7b, deepseek-v2-236b (q_lora_rank 24, which .reduced()
    turns off, and three layers: a dense prefix + two MoE super-blocks;
    absorbed decode) and whisper-medium at ``.reduced()``, with the same
    weights on the card and the CPU: forward over 40 tokens and a 32-token
    prefill + 8 decode steps."""
    t_phase = time.perf_counter()
    gen = torch.Generator().manual_seed(12)
    toks = torch.randint(0, 512, (2, 40), generator=gen)
    errs = {}
    for arch in ("mixtral-8x7b", "deepseek-v2-236b", "whisper-medium"):
        cfg = get_config(arch).reduced()
        if cfg.mla is not None:
            cfg = cfg.with_(num_layers=3, mla=dataclasses.replace(
                cfg.mla, q_lora_rank=24))
        frames = None
        if cfg.family == "encdec":
            frames = torch.randn((2, cfg.frontend_seq, cfg.d_model),
                                 generator=gen)
        errs[arch] = _reduced_card_vs_cpu(cfg, toks, 32, cfg.mla is not None,
                                          frames)
    print(f"zoo-cpu: .reduced() forward (40 tokens) and prefill 32 + decode "
          f"8, card vs CPU, logit rel-L2: "
          + ", ".join(f"{a} {e:.2e}" for a, e in errs.items())
          + f" (budget {LM_CPU_BUDGET:.0e}); "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    if not max(errs.values()) <= LM_CPU_BUDGET:
        raise AssertionError(f"zoo-cpu: card vs CPU rel-L2 {errs}")


def _step_launches(before: dict) -> dict:
    return {k: ops.launches[k] - before[k] for k in
            ("fused_adaln", "attention", "ssd") + BWD_KERNELS}


def _global_norm(grads: dict) -> float:
    """The global gradient norm as ``optimizer.adamw_update`` takes it
    (``torch._foreach_norm``, then the root of the summed squares), so it
    can be held bit for bit against a train step's ``grad_norm``: another
    formula for the same norm rounds differently in the last bit."""
    norms = torch._foreach_norm([g.float() for g in grads.values()])
    return float(torch.stack(norms).square().sum().sqrt())


def _dit_train_setup():
    """DIT_IMAGE at full width and depth with livened adaLN, and its one
    synthetic batch: (cfg, model, batch)."""
    cfg = DIT_IMAGE
    model = dit.init(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0))
    dit.liven_adaln(model, cfg.d_model)
    batch = train_loop.synth_batch(
        cfg, DIT_TRAIN_BATCH, 0, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(1))
    return cfg, model, batch


def _grad_probes(grads: dict) -> dict:
    """By group, the gradient's norm and FP32_PROBES seeded projections
    sum(g * r_j), r_j standard normal from seed j, leaf by leaf in name
    order (summed in fp64): over every leaf ("all") and over the
    attention's q, k and v projections ("qkv", whose gradients come
    straight out of K2's backward).  A difference e between two gradients
    moves a projection by e . r_j, of variance |e|^2, so the RMS of the
    projections' differences over the norm estimates e's rel-L2, which
    the norm itself (moved by g . e + |e|^2 / 2 only) does not."""
    groups = {"all": lambda n: True,
              "qkv": lambda n: n.rsplit(".", 1)[-1] in ("wq", "wk", "wv")}
    names = sorted(grads)
    out = {}
    for group, keep in groups.items():
        leaves = [grads[n] for n in names if keep(n)]
        out[group] = (float(torch.stack([g.double().norm()
                                         for g in leaves]).norm()), [])
    for j in range(FP32_PROBES):
        gen = torch.Generator(device="cuda").manual_seed(j)
        sums = dict.fromkeys(groups, 0.0)
        for n in names:
            g = grads[n].reshape(-1)
            dot = float(torch.dot(g.double(), torch.randn(
                g.numel(), generator=gen, device="cuda").double()))
            for group, keep in groups.items():
                sums[group] += dot if keep(n) else 0.0
        for group in groups:
            out[group][1].append(sums[group])
    return out


def _dit_fp32_grad(cfg, model, batch, smi: str) -> None:
    """One fp32 gradient of the livened DIT_IMAGE on its batch
    (``train_loop.grads_of``, remat "none"): K2's backward twice a layer
    (self and cross).  Prints the wall (to the loss on the host), the
    peak memory, the launches, the loss and ``_grad_probes``, then gates:
    the loss, and by group the norm and the probes' estimate of the
    gradient's rel-L2 from ``CUDA_CORE_DIT_FP32``, within the fp32
    budget."""
    before = dict(ops.launches)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _, grads = train_loop.grads_of(model, batch, cfg, "none",
                                         torch.float32)
    loss = float(loss)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = _step_launches(before)
    probes = _grad_probes(grads)
    del grads
    print(f"train: DiT fp32 gradient (grads_of, remat \"none\"): loss "
          f"{loss!r}; wall {wall * 1e3:.1f} ms; peak mem {peak:.2f} GiB; "
          f"launches {launches}; on {smi}; norm and probes by group "
          f"{probes!r}", flush=True)
    if not math.isfinite(loss) or not all(
            math.isfinite(x) for norm, ps in probes.values()
            for x in [norm] + ps) \
            or launches["attention_bwd"] != 2 * cfg.num_layers:
        raise AssertionError(f"train: DiT fp32 gradient: loss {loss}, "
                             f"probes {probes}, launches {launches}")
    want = CUDA_CORE_DIT_FP32
    errs = {"loss": abs(loss - want["loss"]) / abs(want["loss"])}
    for group, (norm, ps) in probes.items():
        want_norm, want_ps = want["probes"][group]
        errs[f"{group} norm"] = abs(norm - want_norm) / want_norm
        errs[f"{group} rel-L2"] = math.sqrt(sum(
            (p - q) ** 2 for p, q in zip(ps, want_ps)) / FP32_PROBES) \
            / want_norm
    budget = BUDGET[torch.float32]
    print("train: DiT fp32 gradient against the CUDA-core kernels': rel "
          "diff " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (budget {budget:.0e})", flush=True)
    if not max(errs.values()) <= budget:
        raise AssertionError(f"train: DiT fp32 gradient off the CUDA-core "
                             f"kernels': {errs}")


def _train_dit(smi: str) -> None:
    """(a) of the train phase: DIT_IMAGE at full width and depth, one
    fp32 gradient, then the bf16 steps."""
    cfg, model, batch = _dit_train_setup()
    _dit_fp32_grad(cfg, model, batch, smi)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = DIT_TRAIN_BATCH * dit.token_count(cfg, 512, 512)
    opt = optimizer.adamw_init(dict(model.named_parameters()))
    step = train_loop.make_train_step(cfg, remat="none", lr=DIT_TRAIN_LR)
    torch.cuda.reset_peak_memory_stats()
    losses, walls, per_step = [], [], []
    for _ in range(DIT_TRAIN_STEPS):
        before = dict(ops.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt, m = step(model, opt, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        walls.append(time.perf_counter() - t0)
        per_step.append(_step_launches(before))
        losses.append(loss)
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"train: DiT loss {loss}, grad_norm {gnorm}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = per_step[-1]
    dit_kernels = ("fused_adaln", "attention", "attention_bwd",
                   "fused_adaln_bwd")
    if any(p != launches for p in per_step) or min(
            launches[k] for k in dit_kernels) <= 0 or launches["ssd"] or \
            launches["ssd_bwd"]:
        raise AssertionError(f"train: DiT launches a step {per_step}")
    warm = sorted(walls[1:])[len(walls[1:]) // 2]
    print(f"train: DIT_IMAGE full width and depth ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {n_params / 1e9:.3f} B parameters), "
          f"livened adaLN, bf16, AdamW lr {DIT_TRAIN_LR:g}, batch "
          f"{DIT_TRAIN_BATCH} x {tokens // DIT_TRAIN_BATCH} latent tokens + "
          f"64 text tokens, {DIT_TRAIN_STEPS} steps on one batch: loss "
          + ", ".join(f"{v:.5f}" for v in losses)
          + "; step wall " + ", ".join(f"{w * 1e3:.1f}" for w in walls)
          + f" ms (median after the first {warm * 1e3:.1f} ms: "
          f"{DIT_TRAIN_BATCH / warm:.2f} samples/s, {tokens / warm:.0f} "
          f"tokens/s); peak mem {peak:.2f} GiB; launches a step {launches};"
          f" on {smi}", flush=True)
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"train: DiT loss did not fall at every step: "
                             f"{losses}")
    drift = max(abs(a - b) / b for a, b in zip(losses, CUDA_CORE_DIT_LOSSES))
    print("train: DiT losses " + ", ".join(f"{v:.5f}" for v in losses)
          + " against the CUDA-core backward's " + ", ".join(
              f"{v:.5f}" for v in CUDA_CORE_DIT_LOSSES)
          + f": worst rel diff {drift:.2e} (budget {LOSS_BUDGET:.0e})",
          flush=True)
    if not drift <= LOSS_BUDGET:
        raise AssertionError(f"train: DiT losses {losses} drift {drift:.2e} "
                             f"from {CUDA_CORE_DIT_LOSSES}")

    # remat="full" against "none" from the same weights and state: every
    # gradient leaf, then the remat train step's loss and grad_norm
    loss_n, _, grads = train_loop.grads_of(model, batch, cfg, "none")
    _, _, grads_f = train_loop.grads_of(model, batch, cfg, "full")
    differ = [k for k in grads if not torch.equal(grads[k], grads_f[k])]
    gnorm_n = _global_norm(grads)
    del grads, grads_f
    step_full = train_loop.make_train_step(cfg, remat="full",
                                           lr=DIT_TRAIN_LR)
    before = dict(ops.launches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, opt, m = step_full(model, opt, batch)
    loss_f, gnorm_f = float(m["loss"]), float(m["grad_norm"])
    wall_f = time.perf_counter() - t0
    remat = _step_launches(before)
    err = max(abs(loss_f - float(loss_n)) / abs(float(loss_n)),
              abs(gnorm_f - gnorm_n) / gnorm_n)
    bitwise = (not differ and loss_f == float(loss_n)
               and gnorm_f == gnorm_n)
    print(f"train: DiT remat=\"full\" step: loss {loss_f:.6f} vs "
          f"{float(loss_n):.6f}, grad_norm {gnorm_f:.5f} vs {gnorm_n:.5f} "
          f"(remat=\"none\", same weights): rel err {err:.2e}, gradient "
          f"leaves differing {len(differ)} {differ[:4]}, bitwise equal "
          f"{bitwise} (required); wall {wall_f * 1e3:.1f} ms (the first "
          f"remat call); launches {remat}", flush=True)
    if not bitwise or remat["attention"] != 2 * launches["attention"]:
        raise AssertionError(f"train: remat step {err:.2e}, {remat}")
    del model, opt, batch
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _ssd_bwd_dtypes():
    """The operand dtypes of every call of K4's backward inside the block:
    ``ops.ssd_bwd``, which ``ops.ssd``'s autograd Function calls, wrapped
    (its launch counter is untouched)."""
    seen, real = set(), ops.ssd_bwd

    def spy(x, *args, **kwargs):
        seen.add(str(x.dtype)[6:])
        return real(x, *args, **kwargs)
    ops.ssd_bwd = spy
    try:
        yield seen
    finally:
        ops.ssd_bwd = real


def _train_attention(cfg) -> int:
    """K2's launches (forward, and backward) a train step of ``cfg``:
    causal once an attention layer (dense) or shared-block site (hybrid);
    whisper's encoder self-attention, decoder self-attention and
    cross-attention once a layer each; none for the moe family, whose
    SWA and MLA run the plain attention, as the JAX package's do."""
    if cfg.family == "dense":
        return cfg.num_layers
    if cfg.family == "hybrid":
        return hybrid._group_plan(cfg)[1]
    if cfg.family == "encdec":
        return cfg.num_encoder_layers + 2 * cfg.num_layers
    return 0


SSD_ROUTES = ("ssd fp32", "ssd bf16", "ssd_bwd fp32", "ssd_bwd bf16")


def _train_lm(smi: str, cfg, full: int, variant: str | None = None) -> dict:
    """(b)-(d), (f) and (g) of the train phase: the LM ``cfg`` (of
    ``full`` layers at full depth) at full width, bf16, AdamW at
    TRAIN_LR, YI_TRAIN_STEPS steps of YI_TRAIN_BATCH x YI_TRAIN_SEQ
    tokens from the TokenPipeline (whisper's with their frames); the SSD
    families with A and dt in Mamba2's published ranges.  Every step
    must launch K2 and its backward ``_train_attention(cfg)`` times, K4
    and its backward once a Mamba2 layer, and nothing else; the SSD
    families' losses must stay within LOSS_BUDGET of
    CUDA_CORE_SSD_LOSSES, and the dtype K4's backward ran at is printed.
    With ``variant`` (``ssd_bf16``), a second leg trains the same model
    from the same weights, with a fresh AdamW, on the same batches under
    ``dryrun.apply_variant(cfg, variant)``: K4 and its backward in bf16
    (the spy must see bfloat16), the same launches a step, its losses
    finite and within LOSS_BUDGET of the first leg's.  Returns the
    launches a step, and (under "peak") the allocator's peak over the
    first leg's steps less what was allocated before the model was
    built."""
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    model = get_model(cfg).init(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0))
    if cfg.ssm is not None:
        ssm.init_published_a_dt(model)
    n_params = sum(p.numel() for p in model.parameters())
    # the starting weights for the variant's leg, on the host, so that
    # the first leg's peak is the step's own
    start = None if variant is None else {
        k: p.detach().to("cpu", copy=True)
        for k, p in model.named_parameters()}
    attn = _train_attention(cfg)
    mamba = 0 if cfg.ssm is None else cfg.num_layers
    want = {"fused_adaln": 0, "attention": attn, "ssd": mamba,
            "attention_bwd": attn, "fused_adaln_bwd": 0, "ssd_bwd": mamba}
    # K2 by site: whisper's encoder self (non-causal), decoder self
    # (causal) and cross-attention once a layer each, the others causal
    want_sites = ({"self": cfg.num_encoder_layers, "causal": cfg.num_layers,
                   "cross": cfg.num_layers} if cfg.family == "encdec" else
                  {"self": 0, "causal": attn, "cross": 0})
    tokens = YI_TRAIN_BATCH * YI_TRAIN_SEQ

    def leg(run_cfg, label: str) -> dict:
        opt = optimizer.adamw_init(dict(model.named_parameters()))
        step = train_loop.make_train_step(run_cfg, remat="none", lr=TRAIN_LR)
        pipe = TokenPipeline(run_cfg, YI_TRAIN_BATCH, YI_TRAIN_SEQ, seed=0)
        torch.cuda.reset_peak_memory_stats()
        losses, walls, per_step, sites, routes = [], [], [], [], []
        with contextlib.ExitStack() as stack:
            bwd_dtypes = stack.enter_context(_ssd_bwd_dtypes())
            stack.enter_context(_k2_sites())
            stack.callback(pipe.close)
            for _ in range(YI_TRAIN_STEPS):
                batch = {k: torch.from_numpy(v).cuda() for k, v in
                         next(pipe).items()}
                before = dict(ops.launches)
                routed = {k: ops.kernel_launches[k] for k in SSD_ROUTES}
                K2_SITES.update(dict.fromkeys(K2_SITES, 0))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _, opt, m = step(model, opt, batch)
                loss, gnorm = float(m["loss"]), float(m["grad_norm"])
                walls.append(time.perf_counter() - t0)
                per_step.append(_step_launches(before))
                routes.append({k: ops.kernel_launches[k] - routed[k]
                               for k in SSD_ROUTES})
                sites.append(dict(K2_SITES))
                losses.append(loss)
                if not (math.isfinite(loss) and math.isfinite(gnorm)):
                    raise AssertionError(f"train: {label} loss {loss}, "
                                         f"grad_norm {gnorm}")
        peak_bytes = torch.cuda.max_memory_allocated() - base
        peak = torch.cuda.max_memory_allocated() / 2**30
        intra = "" if run_cfg.ssm is None else run_cfg.ssm.intra_dtype
        sd = {"float32": "fp32", "bfloat16": "bf16"}.get(intra)
        want_routes = dict.fromkeys(SSD_ROUTES, 0)
        if sd is not None and mamba:
            want_routes.update({f"ssd {sd}": mamba, f"ssd_bwd {sd}": mamba})
        if any(p != want for p in per_step) or any(
                k != want_sites for k in sites) or any(
                r != want_routes for r in routes):
            raise AssertionError(f"train: {label} launches a step "
                                 f"{per_step}, K2 by site {sites}, K4 by "
                                 f"dtype {routes}, expected {want}, "
                                 f"{want_sites}, {want_routes}")
        warm = min(walls[1:])
        print(f"train: {label} full width, {cfg.num_layers} of {full} "
              f"layers ({n_params / 1e9:.3f} B parameters"
              + ("" if cfg.ssm is None else
                 f", A/dt in Mamba2's published ranges, intra_dtype {intra}")
              + f"), bf16, AdamW lr {TRAIN_LR:g}, {YI_TRAIN_BATCH} x "
              f"{YI_TRAIN_SEQ} tokens"
              + (f" + {cfg.frontend_seq} frames" if cfg.family == "encdec"
                 else "")
              + f" from the TokenPipeline, {YI_TRAIN_STEPS} "
              "steps: loss " + ", ".join(f"{v:.4f}" for v in losses)
              + "; step wall " + ", ".join(f"{w * 1e3:.1f}" for w in walls)
              + f" ms ({tokens / warm:.0f} tokens/s after the first); peak "
              f"mem {peak:.2f} GiB ({peak_bytes / 2**30:.3f} GiB over what "
              f"was allocated before the model); launches a step "
              f"{per_step[-1]}, K2 by site {sites[-1]}"
              + (f", K4 by dtype {routes[-1]}; K4's backward ran in "
                 f"{', '.join(sorted(bwd_dtypes))}" if mamba else "")
              + f"; on {smi}", flush=True)
        if mamba and bwd_dtypes != {str(run_cfg.ssm.intra_dtype)}:
            raise AssertionError(f"train: {label} K4's backward ran in "
                                 f"{bwd_dtypes}")
        del opt
        return {"losses": losses, "per_step": per_step[-1],
                "routes": routes[-1], "peak": peak_bytes}

    first = leg(cfg, cfg.name)
    losses = first["losses"]
    recorded = CUDA_CORE_SSD_LOSSES.get(cfg.name)
    if recorded is not None:
        drift = max(abs(a - b) / b for a, b in zip(losses, recorded))
        print(f"train: {cfg.name} losses vs the CUDA-core backward's "
              + ", ".join(f"{v:.4f}" for v in recorded)
              + f": worst rel diff {drift:.2e} (budget {LOSS_BUDGET:.0e})",
              flush=True)
        if not drift <= LOSS_BUDGET:
            raise AssertionError(f"train: {cfg.name} losses {losses} drift "
                                 f"from {recorded}")
    out = {**first["per_step"], **first["routes"], "peak": first["peak"]}
    if variant is not None:
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(start[k])
        del start
        second = leg(dryrun.apply_variant(cfg, variant),
                     f"{cfg.name} {variant}")
        drift = max(abs(a - b) / b for a, b in zip(second["losses"], losses))
        print(f"train: {cfg.name} {variant} losses vs the intra_dtype "
              f"{cfg.ssm.intra_dtype} leg's on the same batches: worst rel "
              f"diff {drift:.2e} (budget {LOSS_BUDGET:.0e})", flush=True)
        if not drift <= LOSS_BUDGET:
            raise AssertionError(f"train: {cfg.name} {variant} losses "
                                 f"{second['losses']} drift from {losses}")
        out[variant] = {**second["per_step"], **second["routes"]}
    del model
    torch.cuda.empty_cache()
    return out


def _mixtral_peaks(predicted: dict, measured: int, smi: str) -> None:
    """(g)'s memory check: the dry run's predicted peak at a 1x1 mesh for
    MIXTRAL_TRAIN under TRAIN_PEAK_LIMIT and for one layer more over it
    (so the depth is the most that fits), and the prediction within
    MEMORY_BUDGET of the allocator's peak over the steps."""
    fit, over = (predicted[case[0]] for case in MIXTRAL_PEAK_CASES)
    ratio = fit["per_device_memory_bytes"] / measured
    print(f"train: mixtral-8x7b dry-run peak at 1x1: "
          f"{fit['per_device_memory_bytes'] / 2**30:.3f} GiB at "
          f"{MIXTRAL_TRAIN.num_layers} layers, "
          f"{over['per_device_memory_bytes'] / 2**30:.3f} GiB at "
          f"{MIXTRAL_TRAIN.num_layers + 1} (limit "
          f"{TRAIN_PEAK_LIMIT / 2**30:.0f} GiB); measured "
          f"{measured / 2**30:.3f} GiB at {MIXTRAL_TRAIN.num_layers}, "
          f"predicted / measured {ratio:.4f} (budget {MEMORY_BUDGET:.0%}); "
          f"on {smi}", flush=True)
    if not (fit["ok"] and over["ok"]
            and fit["per_device_memory_bytes"] < TRAIN_PEAK_LIMIT
            <= over["per_device_memory_bytes"]
            and abs(ratio - 1) <= MEMORY_BUDGET):
        raise AssertionError(f"train: mixtral peaks {predicted}, measured "
                             f"{measured}")


def phase_train(smi: str) -> tuple[dict, dict]:
    """The training path on the card: (a) DIT_IMAGE at full width and
    depth through K1 and K2 forward and backward, (b) yi-6b at full
    width through K2's causal GQA backward, (c) mamba2-1.3b at full width
    and depth and (d) zamba2-7b at 12 layers through K4's backward, (f)
    whisper-medium at full width and depth through K2's backward at its
    three sites, (g) mixtral-8x7b at full width and MIXTRAL_TRAIN's
    depth, its dry-run peak against the allocator's.  Returns the
    phase's launch counts, and the launches a step of (b)-(g) by model
    name."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    ops.reset_launches()
    # the dry run's predictions for (g), in a CPU process meanwhile
    peaks = subprocess.Popen(
        [sys.executable, "-c", _DRYRUN_PEAKS,
         json.dumps(MIXTRAL_PEAK_CASES)],
        env=dict(os.environ, PYTHONPATH=str(_src_dir())),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _train_dit(smi)
        steps = {cfg.name: _train_lm(smi, cfg, full, variant)
                 for cfg, full, variant in (
                     (YI_TRAIN, YI.num_layers, None),
                     (MAMBA, MAMBA.num_layers, "ssd_bf16"),
                     (ZAMBA_TRAIN, ZAMBA.num_layers, None),
                     (WHISPER, WHISPER.num_layers, None),
                     (MIXTRAL_TRAIN,
                      get_config("mixtral-8x7b").num_layers, None))}
        out, err = peaks.communicate(timeout=DRYRUN_TIMEOUT)
    finally:
        if peaks.poll() is None:
            peaks.kill()
            peaks.wait()
    if peaks.returncode:
        raise AssertionError(f"train: mixtral dry run failed: {err[-2000:]}")
    _mixtral_peaks(json.loads(out.strip().splitlines()[-1]),
                   steps[MIXTRAL_TRAIN.name]["peak"], smi)
    counts = {**ops.launches, **ops.kernel_launches}
    if min(counts[k] for k in BWD_KERNELS + (
            "ssd", "ssd bf16", "ssd_bwd bf16")) <= 0 or \
            counts["splice_attention"] or counts["attention bf16"] == 0:
        raise AssertionError(f"train: launches {counts}")
    print(f"train: {time.perf_counter() - t_phase:.1f} s; launches "
          f"{counts}", flush=True)
    return counts, steps


def _remat_selective(cards: dict) -> None:
    """(e): on the card, ``remat="selective"`` gradients of the reduced
    yi-6b and DIT_IMAGE equal ``"none"``'s bit for bit, as
    ``remat="full"``'s are held."""
    report = {}
    for name in (YI.name, DIT_IMAGE.name):
        cfg, model, batch = cards[name]
        batch = {k: v.cuda() for k, v in batch.items()}
        got = {}
        for remat in ("none", "selective"):
            before = dict(ops.launches)
            loss, _, grads = train_loop.grads_of(model, batch, cfg, remat,
                                                 dtype=torch.float32)
            got[remat] = (float(loss), grads, _step_launches(before))
        (ln, gn, kn), (ls, gs, ks) = got["none"], got["selective"]
        differ = [k for k in gn if not torch.equal(gn[k], gs[k])]
        report[name] = (ls == ln, len(differ), len(gn), ks, kn)
        if differ or ls != ln or ks["attention_bwd"] != kn["attention_bwd"]:
            raise AssertionError(f"train-cpu: {name} selective remat: "
                                 f"{differ[:4]}, loss {ls} vs {ln}, "
                                 f"launches {ks} vs {kn}")
    print("train-cpu: reduced yi-6b and DIT_IMAGE on the card, "
          "remat=\"selective\" vs \"none\" (loss equal, gradient leaves "
          "differing of all, launches selective / none): " + "; ".join(
              f"{n} {r[0]}, {r[1]} of {r[2]}, {r[3]} / {r[4]}"
              for n, r in report.items()) + " (bitwise equality required)",
          flush=True)


def _compression(grads_cpu: dict, grads_card: dict) -> None:
    """(e): ``training/compression.py`` on reduced yi-6b's fp32 gradients
    of one step, card against CPU, ``compressed_bytes`` equal and every
    compressed leaf within GRAD_CPU_BUDGET rel-L2: the card compresses
    the CPU's gradients (the same inputs), and each side its own.  Own
    gradients 1e-6 apart may cross an int8 rounding boundary or the
    top-k threshold, and such a flip moves its element by a whole
    quantum (3.3e-4 of a leaf's norm on the card, more than the budget):
    the flips are counted and printed, and the rest of each leaf is held
    to the budget."""
    same = {k: g.cuda() for k, g in grads_cpu.items()}
    problems = []
    for method in COMPRESSIONS:
        cpu = compression.compress_decompress(grads_cpu, method)
        legs = {"same gradients": compression.compress_decompress(
                    same, method),
                "own gradients": compression.compress_decompress(
                    grads_card, method)}
        for leg, card in legs.items():
            card = {k: g.cpu() for k, g in card.items()}
            flipped = {k: _flipped(card[k], cpu[k], method) for k in cpu}
            leaf = {k: rel_l2(card[k], cpu[k]) for k in cpu}
            kept = {k: rel_l2(card[k][~flipped[k]], cpu[k][~flipped[k]])
                    for k in cpu}
            worst, worst_kept = (max(d, key=d.get) for d in (leaf, kept))
            flips = {k: int(f.sum()) for k, f in flipped.items() if f.any()}
            nbytes = (compression.compressed_bytes(card, method),
                      compression.compressed_bytes(cpu, method))
            print(f"train-cpu: reduced yi-6b gradients, {method}, {leg}, "
                  f"card vs CPU: compressed bytes {nbytes[0]} vs "
                  f"{nbytes[1]}; elements flipped {sum(flips.values())} of "
                  f"{sum(g.numel() for g in cpu.values())} {flips}; worst "
                  f"leaf rel-L2 {leaf[worst]:.2e} ({worst}), without the "
                  f"flipped elements {kept[worst_kept]:.2e} ({worst_kept}; "
                  f"budget {GRAD_CPU_BUDGET:.0e})", flush=True)
            if nbytes[0] != nbytes[1] or not (
                    kept[worst_kept] <= GRAD_CPU_BUDGET and (
                        leg == "own gradients"
                        or leaf[worst] <= GRAD_CPU_BUDGET)):
                problems.append(f"{method} ({leg}): bytes {nbytes}, "
                                f"{worst} {leaf[worst]:.2e}, flips {flips}")
    if problems:
        raise AssertionError("train-cpu: compression: " + "; ".join(problems))


def _flipped(card, cpu, method: str):
    """Elements of two compressed leaves on either side of a boundary: an
    int8 code (``compression._int8_qdq``'s) that differs, or a top-k
    membership that differs."""
    if method == "topk":
        return (card != 0) != (cpu != 0)
    if card.ndim == 0:
        return torch.zeros((), dtype=torch.bool)

    def codes(q):
        scale = q.abs().max() / 127.0
        return torch.round(q / scale) if scale > 0 else q
    return codes(card) != codes(cpu)


def _resilient_trainer() -> None:
    """(e): ``ResilientTrainer`` on the card, the crash/restart scenario
    of tests/test_torch_training.py with reduced yi-6b: a crash at step
    CRASH_AT of CRASH_STEPS, a restart from the last snapshot and the data
    cursor; the final weights and AdamW moments equal the uninterrupted
    run's bit for bit."""
    cfg = YI.reduced()
    step_fn = train_loop.make_train_step(cfg, remat="none", lr=1e-3)

    def init_state():
        m = get_model(cfg).init(cfg, generator=torch.Generator(
            device="cuda").manual_seed(0))
        return m, optimizer.adamw_init(dict(m.named_parameters()))

    class Batches:                    # the TokenPipeline's batches on the card
        def __init__(self):
            self.p = TokenPipeline(cfg, 2, 16, seed=9)

        def __next__(self):
            return {k: torch.from_numpy(v).cuda()
                    for k, v in next(self.p).items()}

        def seek(self, s):
            self.p.seek(s)

        def cursor(self):
            return self.p.cursor()

        def close(self):
            self.p.close()

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        def trainer(sub, save_every):
            return fault_tolerance.ResilientTrainer(
                Path(tmp) / sub, step_fn, init_state,
                save_every=save_every, async_save=False)
        runs = []
        for sub, save_every, crash_at in (("ref", 100, None),
                                          ("crash", CRASH_SAVE_EVERY,
                                           CRASH_AT),
                                          ("crash", CRASH_SAVE_EVERY, None)):
            batches = Batches()
            try:
                runs.append(trainer(sub, save_every).run(
                    batches, CRASH_STEPS, crash_at=crash_at))
            except RuntimeError as e:
                if "simulated crash" not in str(e):
                    raise
                runs.append(None)
            finally:
                batches.close()
    ref, crashed, out = runs
    (m1, o1), (m2, o2) = ref["state"], out["state"]
    p1, p2 = dict(m1.named_parameters()), dict(m2.named_parameters())
    differ = [n for n in p1 if not (torch.equal(p1[n], p2[n])
                                    and torch.equal(o1.m[n], o2.m[n])
                                    and torch.equal(o1.v[n], o2.v[n]))]
    on_card = all(p.is_cuda for p in p2.values())
    loss1, loss2 = (float(r["metrics"]["loss"]) for r in (ref, out))
    print(f"train-cpu: ResilientTrainer on the card, reduced yi-6b, crash "
          f"at step {CRASH_AT} of {CRASH_STEPS} (snapshot every "
          f"{CRASH_SAVE_EVERY}), restart: crashed {crashed is None}; final "
          f"step {int(o2.step)}; leaves whose weight or moments differ from "
          f"the uninterrupted run {len(differ)} of {len(p1)} {differ[:4]} "
          f"(bitwise equality required); last loss {loss2!r} vs {loss1!r}; "
          f"weights on the card {on_card}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if crashed is not None or differ or not on_card or loss1 != loss2 or \
            not int(o1.step) == int(o2.step) == CRASH_STEPS:
        raise AssertionError(f"train-cpu: ResilientTrainer restart: "
                             f"{differ}, losses {loss1} vs {loss2}")


def phase_train_cpu() -> None:
    """(e) of the train phase: DIT_IMAGE.reduced() (livened),
    yi-6b.reduced(), mamba2-1.3b.reduced(), zamba2-7b.reduced() (A and dt
    in Mamba2's published ranges, 60 tokens: a ragged last chunk of 16),
    whisper-medium.reduced() and deepseek-v2-236b.reduced() (MLA and its
    MoE) with the same weights and batch on the card (kernels, backward
    kernels) and on the CPU (plain versions, closed-form backward): one
    fp32 step's loss and gradient per parameter leaf.  (The updated
    weights are not compared: a first AdamW step moves each weight by
    about lr * sign(g), so a weight whose gradient is near zero may move
    by +-lr on the two sides.)  Then on the card: the reduced mamba2's
    ``remat="full"`` gradients, K4's forward recomputed in the backward,
    and the reduced yi-6b's and DIT_IMAGE's ``remat="selective"`` ones
    must equal ``"none"``'s bit for bit; ``training/compression.py`` on
    the yi-6b gradients, card against CPU; and ``ResilientTrainer``'s
    crash/restart."""
    t_phase = time.perf_counter()
    errs, cards, yi_grads = {}, {}, None
    for cfg in (DIT_IMAGE.reduced(), YI.reduced(), MAMBA.reduced(),
                ZAMBA.reduced(), WHISPER.reduced(),
                get_config("deepseek-v2-236b").reduced()):
        family = get_model(cfg)
        cpu = family.init(cfg, device="cpu")
        if cfg.family == "dit":
            dit.liven_adaln(cpu, cfg.d_model)
        if cfg.ssm is not None:
            ssm.init_published_a_dt(cpu, seed=3)
        card = family.init(cfg)
        card.load_state_dict(cpu.state_dict())
        batch = train_loop.synth_batch(
            cfg, 2, 64 if cfg.ssm is None else 60, device="cpu",
            generator=torch.Generator().manual_seed(5))
        out = {}
        for name, model in (("cpu", cpu), ("card", card)):
            dev = next(model.parameters()).device
            loss, _, grads = train_loop.grads_of(
                model, {k: v.to(dev) for k, v in batch.items()}, cfg,
                "none", dtype=torch.float32)
            out[name] = (float(loss), grads)
        (lc, gc), (lg, gg) = out["cpu"], out["card"]
        leaf = {k: rel_l2(gg[k].cpu(), gc[k]) for k in gc}
        worst = max(leaf, key=leaf.get)
        errs[cfg.name] = (abs(lg - lc) / abs(lc), leaf[worst], worst)
        cards[cfg.name] = (cfg, card, batch)
        if cfg.name == YI.name:
            yi_grads = (gc, gg)
    print("train-cpu: .reduced() fp32 step, card vs CPU, loss rel err / "
          "worst gradient leaf rel-L2: "
          + ", ".join(f"{a} {e[0]:.2e} / {e[1]:.2e} ({e[2]})"
                      for a, e in errs.items())
          + f" (budget {GRAD_CPU_BUDGET:.0e})", flush=True)
    if not max(max(e[0], e[1]) for e in errs.values()) <= GRAD_CPU_BUDGET:
        raise AssertionError(f"train-cpu: card vs CPU {errs}")
    cfg, model, batch = cards[MAMBA.name]
    batch = {k: v.cuda() for k, v in batch.items()}
    got = {}
    for remat in ("none", "full"):
        before = dict(ops.launches)
        loss, _, grads = train_loop.grads_of(model, batch, cfg, remat,
                                             dtype=torch.float32)
        got[remat] = (float(loss), grads, _step_launches(before))
    (ln, gn, kn), (lf, gf, kf) = got["none"], got["full"]
    differ = [k for k in gn if not torch.equal(gn[k], gf[k])]
    print(f"train-cpu: reduced mamba2 on the card, remat=\"full\" vs "
          f"\"none\": loss {lf!r} vs {ln!r}, gradient leaves differing "
          f"{len(differ)} of {len(gn)} {differ[:4]} (bitwise equality "
          f"required); launches {kf} vs {kn}", flush=True)
    if differ or lf != ln or kf["ssd"] != 2 * kn["ssd"] or \
            kf["ssd_bwd"] != kn["ssd_bwd"]:
        raise AssertionError(f"train-cpu: mamba2 remat: {differ}, loss {lf}"
                             f" vs {ln}, launches {kf} vs {kn}")
    del got, gn, gf
    _remat_selective(cards)
    _compression(*yi_grads)
    _resilient_trainer()
    print(f"train-cpu: {time.perf_counter() - t_phase:.1f} s", flush=True)


# the gfc phase: GF-DiT's group-free collective realizations and the
# sharding layer on the card
GFC_OPS = ("all_gather", "all_reduce", "all_to_all")
# the reduce against the plain fp32 sum over the shards: fp32 within 1e-6
# rel-L2; bf16 within one bf16 ulp (2^-8), the rounding of that sum
GFC_REDUCE_BUDGET = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -8}
GROUPED_WORLD = 8
GROUPED_MEMBERSHIPS = 50
FD_WORLD = 4
# yi-6b's decode shape: q (4, 1, 32, 128), a cache of (4, 32768, 4, 128)
FD_BATCH, FD_SEQ = 4, 32768
# the write position: in shard 0, a middle shard, on a shard's last row
# and in the last shard (shards of 8192 rows)
FD_POSITIONS = {"shard0": 100, "middle": 13192, "last_row": 24575,
                "last_shard": 32760}
FD_BUDGET = 1e-5                   # rel-L2, fp32, against the plain decode
YI_SP = YI.with_(num_layers=4)
SP_PROMPT = (4, 512)

_FD_RANK = r"""
import json, sys, time
import torch, torch.distributed as dist
rank, world, store, out_dir = int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:5]
c = json.loads(sys.argv[5])
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=world)
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.sharding.sp import flash_decode
mesh = make_local_mesh(1, world)
gen = torch.Generator(device="cuda").manual_seed(c["seed"])
shapes = [(c["b"], 1, c["h"], c["hd"])] + [(c["b"], 1, c["kv"], c["hd"])] * 2 \
    + [(c["b"], c["s"], c["kv"], c["hd"])] * 2
q, k_new, v_new, cache_k, cache_v = (
    torch.randn(sh, generator=gen, device="cuda") for sh in shapes)
s_loc = c["s"] // world
mine = slice(rank * s_loc, (rank + 1) * s_loc)
for case, pos in c["positions"].items():
    lens = torch.full((c["b"],), pos, dtype=torch.int32, device="cuda")
    ck, cv = cache_k[:, mine].clone(), cache_v[:, mine].clone()
    out, ck2, cv2 = flash_decode(q, k_new, v_new, ck, cv, lens, mesh=mesh)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        flash_decode(q, k_new, v_new, ck, cv, lens, mesh=mesh)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 5 * 1e3
    equal = ck2 is ck and cv2 is cv
    for got, full, new in ((ck, cache_k, k_new), (cv, cache_v, v_new)):
        want = full[:, mine].clone()
        if mine.start <= pos < mine.stop:
            want[:, pos - mine.start] = new[:, 0]
        equal = equal and torch.equal(got, want)
    torch.save({"out": out.cpu(), "cache_equal": equal, "ms": ms},
               f"{out_dir}/rank{rank}-{case}.pt")
dist.destroy_process_group()
"""


def _plain_collective(op: str, size: int, x):
    """The group collective by a loop over the shards (sums in fp32)."""
    shards = list(x.chunk(size))
    if op == "all_gather":
        return torch.cat([s.clone() for s in shards])
    if op == "all_reduce":
        acc = shards[0].float()
        for s in shards[1:]:
            acc = acc + s.float()
        return acc.to(x.dtype)
    parts = [s.chunk(size) for s in shards]
    return torch.cat([parts[i][j] for j in range(size) for i in range(size)])


def _plain_grouped(x, gids):
    """Grouped all-reduce and all-gather by loops over the ranks."""
    g = gids[:, 0].tolist()
    w = len(g)
    red = torch.stack([sum(x[s].double() for s in range(w) if g[s] == g[r])
                       .to(x.dtype) for r in range(w)])
    gat = torch.stack([torch.stack([x[s] if g[s] == g[r] else
                                    torch.zeros_like(x[s])
                                    for s in range(w)]) for r in range(w)])
    return red, gat


def _gfc_cache(comm) -> None:
    """Every op at group sizes 2, 4 and 8 for each of the twin's
    payloads: a cold capture (a new key), a hit bind of a same-size group
    of other members, the replay against the plain version (exact for
    the gather and the all-to-all, GFC_REDUCE_BUDGET for the reduce;
    after a later call, so the result is not overwritten) and a warm
    call by CUDA events.  An all-to-all whose shard rows do not split
    over the group must be refused, as JAX refuses it."""
    cache = ExecutableCache()
    gen = torch.Generator(device="cuda").manual_seed(11)
    for shape, dtype in group_setup.PAYLOADS.values():
        for op in GFC_OPS:
            for size in group_setup.SIZES:
                label = (f"{op} size {size} shard {tuple(shape)} "
                         f"{dtype_name(dtype)}")
                if op == "all_to_all" and shape[0] % size:
                    try:
                        cache.get(op, size, shape, dtype)
                    except ValueError:
                        print(f"gfc: {label}: refused (a shard of "
                              f"{shape[0]} row(s) does not split over "
                              f"{size} ranks)", flush=True)
                        continue
                    raise AssertionError(f"gfc: {label} was accepted")
                compiles = cache.stats["compiles"]
                t0 = time.perf_counter()
                cache.bind(op, comm.register_group(tuple(range(size))),
                           shape, dtype)
                cold = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
                run = cache.bind(op, comm.register_group(tuple(
                    range(GROUPED_WORLD - size, GROUPED_WORLD))), shape,
                    dtype)
                hit = (time.perf_counter() - t0) * 1e6
                prog = cache.get(op, size, shape, dtype)
                if cache.stats["compiles"] != compiles + 1 or \
                        not isinstance(prog.graph, torch.cuda.CUDAGraph):
                    raise AssertionError(f"gfc: {label}: {cache.stats}")
                x = torch.randn((size * shape[0],) + tuple(shape[1:]),
                                generator=gen, device="cuda").to(dtype)
                got = run(x)
                run(torch.zeros_like(x))
                want = _plain_collective(op, size, x)
                if op == "all_reduce":
                    err = rel_l2(got.float().cpu(), want.float().cpu())
                    ok = err <= GFC_REDUCE_BUDGET[dtype]
                    check = f"rel-L2 {err:.2e} (budget " \
                            f"{GFC_REDUCE_BUDGET[dtype]:.1e})"
                else:
                    ok = torch.equal(got, want)
                    check = "equal" if ok else "DIFFERS"
                warm = group_setup.warm_us(run, x)
                print(f"gfc: {label}: capture {cold:.3f} ms, hit bind "
                      f"{hit:.2f} us, warm call {warm:.2f} us, {check}",
                      flush=True)
                if not ok:
                    raise AssertionError(f"gfc: {label}: {check}")


def _gfc_grouped() -> None:
    """Membership-as-data at world 8: 50 random memberships, each op's
    result equal to the plain loops (int32 exactly; fp32 reduce within
    1e-6 rel-L2), one capture per op."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    for dtype in (torch.int32, torch.float32):
        grouped = build_grouped_ops(GROUPED_WORLD)
        x = (torch.randint(-1000, 1000, (GROUPED_WORLD, 1024), generator=gen,
                           device="cuda", dtype=dtype)
             if dtype == torch.int32 else
             torch.randn((GROUPED_WORLD, 1024), generator=gen, device="cuda"))
        worst = 0.0
        for _ in range(GROUPED_MEMBERSHIPS):
            gids = torch.randint(0, GROUPED_WORLD, (GROUPED_WORLD, 1),
                                 generator=gen, device="cuda",
                                 dtype=torch.int32)
            red = grouped["all_reduce"](x, gids)
            gat = grouped["all_gather"](x, gids)
            want_red, want_gat = _plain_grouped(x, gids)
            err = 0.0 if torch.equal(red, want_red) else rel_l2(
                red.double().cpu(), want_red.double().cpu())
            worst = max(worst, err)
            if not torch.equal(gat, want_gat) or (
                    err > (0 if dtype == torch.int32 else 1e-6)):
                raise AssertionError(f"gfc: grouped {dtype}: gather equal "
                                     f"{torch.equal(gat, want_gat)}, reduce "
                                     f"rel-L2 {err}")
        us = {op: group_setup.warm_us(grouped[op], x, gids)
              for op in ("all_reduce", "all_gather")}
        caps = {op: grouped["stats"][op]["captures"] for op in us}
        print(f"gfc: grouped ops, world {GROUPED_WORLD}, "
              f"{dtype_name(dtype)} x (8, 1024), {GROUPED_MEMBERSHIPS} "
              f"memberships: gather equal, reduce worst rel-L2 {worst:.2e}; "
              f"captures {caps}; warm call all_reduce "
              f"{us['all_reduce']:.2f} us, all_gather "
              f"{us['all_gather']:.2f} us", flush=True)
        if caps != {"all_reduce": 1, "all_gather": 1}:
            raise AssertionError(f"gfc: grouped captures {caps}")


def _gfc_flash_decode() -> None:
    """flash_decode at yi-6b's full width on FD_WORLD processes sharing
    the card (gloo, whose all-reduce takes CUDA tensors), each holding
    its 8192-row shard of the (4, 32768, 4, 128) fp32 cache, against the
    unsharded plain decode (``layers.sdpa`` over the whole cache with the
    new row written): every rank's output within FD_BUDGET, every rank's
    cache shard equal to the plain update's."""
    c = {"seed": 21, "b": FD_BATCH, "s": FD_SEQ, "h": YI.num_heads,
         "kv": YI.num_kv_heads, "hd": YI.head_dim,
         "positions": FD_POSITIONS}
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(_src_dir()))
        procs = [subprocess.Popen(
            [sys.executable, "-c", _FD_RANK, str(r), str(FD_WORLD),
             f"{tmp}/store", tmp, json.dumps(c)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(FD_WORLD)]
        errors = []
        try:
            for r, p in enumerate(procs):
                _, err = p.communicate(timeout=240)
                if p.returncode:
                    errors.append(f"rank {r}: {err[-1500:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if errors:
            raise AssertionError(f"gfc: flash_decode ranks failed: {errors}")
        results = {(r, case): torch.load(f"{tmp}/rank{r}-{case}.pt")
                   for r in range(FD_WORLD) for case in FD_POSITIONS}
    wall = time.perf_counter() - t_start
    gen = torch.Generator(device="cuda").manual_seed(c["seed"])
    shapes = [(FD_BATCH, 1, c["h"], c["hd"])] + \
        [(FD_BATCH, 1, c["kv"], c["hd"])] * 2 + \
        [(FD_BATCH, FD_SEQ, c["kv"], c["hd"])] * 2
    q, k_new, v_new, cache_k, cache_v = (
        torch.randn(sh, generator=gen, device="cuda") for sh in shapes)
    for case, pos in FD_POSITIONS.items():
        fk, fv = cache_k.clone(), cache_v.clone()
        fk[:, pos], fv[:, pos] = k_new[:, 0], v_new[:, 0]
        lens = torch.full((FD_BATCH,), pos, dtype=torch.int32, device="cuda")
        want = layers.sdpa(q, fk, fv, causal=True, q_offset=pos,
                           kv_len=lens + 1).cpu()
        del fk, fv
        errs = [rel_l2(results[r, case]["out"], want)
                for r in range(FD_WORLD)]
        equal = all(results[r, case]["cache_equal"] for r in range(FD_WORLD))
        print(f"gfc: flash_decode yi-6b q {tuple(q.shape)}, cache "
              f"{tuple(cache_k.shape)} fp32 over {FD_WORLD} gloo ranks on "
              f"one card, write at {pos} ({case}): out rel-L2 per rank "
              + ", ".join(f"{e:.2e}" for e in errs)
              + f" (budget {FD_BUDGET:.0e}), cache shards equal {equal}, "
              f"rank 0 {results[0, case]['ms']:.2f} ms a call", flush=True)
        if not (max(errs) <= FD_BUDGET and equal):
            raise AssertionError(f"gfc: flash_decode {case}: {errs}, cache "
                                 f"equal {equal}")
    print(f"gfc: flash_decode: {wall:.1f} s for the {FD_WORLD} processes",
          flush=True)


def _gfc_sp_step() -> None:
    """One ``make_serve_step(sp_decode=True)`` step of yi-6b at full
    width, 4 of 32 layers, fp32, after a 4 x 512 prefill, under a 1x1
    mesh (nccl, world size 1): flash_decode once a layer, the logits and
    the caches within FD_BUDGET rel-L2 of the plain decode step's on the
    same cache, the first layer's new rows and the lengths equal."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(
            f"{tmp}/store", 1), rank=0, world_size=1)
        try:
            mesh = make_local_mesh(1, 1)
            model = get_model(YI_SP).init(YI_SP, generator=torch.Generator(
                device="cuda").manual_seed(0))
            gen = torch.Generator(device="cuda").manual_seed(5)
            toks = torch.randint(0, YI_SP.vocab_size, (SP_PROMPT[0],
                                 SP_PROMPT[1] + 1), generator=gen,
                                 device="cuda")
            cache = get_model(YI_SP).init_cache(YI_SP, SP_PROMPT[0], 1024,
                                                dtype=torch.float32)
            _, cache = serve_loop.make_prefill_step(
                YI_SP, dtype=torch.float32)(model, toks[:, :-1], cache)
            plain_cache = {"blocks": {"pos0": {
                k: v.clone() for k, v in cache["blocks"]["pos0"].items()}}}
            pos = torch.full((SP_PROMPT[0],), SP_PROMPT[1], device="cuda")
            calls = []
            real = layers.flash_decode

            def counted(*args, **kw):
                calls.append(1)
                return real(*args, **kw)
            layers.flash_decode = counted
            try:
                with activation_sharding(mesh, SERVE_RULES):
                    lg, cache = serve_loop.make_serve_step(
                        YI_SP, dtype=torch.float32, sp_decode=True)(
                        model, toks[:, -1:], cache, pos)
            finally:
                layers.flash_decode = real
            want, plain_cache = serve_loop.make_serve_step(
                YI_SP, dtype=torch.float32)(model, toks[:, -1:],
                                            plain_cache, pos)
            err = rel_l2(lg.cpu(), want.cpu())
            got, ref_ = cache["blocks"]["pos0"], plain_cache["blocks"]["pos0"]
            # the first layer's rows are written from the same input; a
            # later layer's input carries the attention's last bits
            equal = torch.equal(got["len"], ref_["len"]) and all(
                torch.equal(got[k][0], ref_[k][0]) for k in ("k", "v"))
            cache_err = max(rel_l2(got[k].cpu(), ref_[k].cpu())
                            for k in ("k", "v"))
        finally:
            dist.destroy_process_group()
    print(f"gfc: yi-6b {YI_SP.num_layers} of {YI.num_layers} layers, fp32, "
          f"{SP_PROMPT[0]} x {SP_PROMPT[1]} prefill, make_serve_step("
          f"sp_decode=True) under a 1x1 mesh: flash_decode {len(calls)} "
          f"times, logits rel-L2 {err:.2e} vs the plain step, caches "
          f"rel-L2 {cache_err:.2e} (budget {FD_BUDGET:.0e}), the first "
          f"layer's rows and len equal {equal}", flush=True)
    del model
    torch.cuda.empty_cache()
    if len(calls) != YI_SP.num_layers or not max(err, cache_err) <= \
            FD_BUDGET or not equal:
        raise AssertionError(f"gfc: sp_decode step: {len(calls)} calls, "
                             f"rel-L2 {err}, {cache_err}, equal {equal}")


def phase_gfc(smi: str) -> None:
    """The group-free collective realizations and the sharding layer on
    the card: the group-setup twin's table, the executable cache and the
    grouped ops against their plain versions, flash decoding over a
    sequence-sharded cache on four processes, and one sp_decode serve
    step."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    before = dict(ops.launches)
    data = group_setup.run("cuda")
    print(f"gfc: group_setup on {smi}:", flush=True)
    for name, us, note in group_setup.rows(data):
        print(f"gfc:   {name},{us:.3f},{note}", flush=True)
    comm = GroupFreeComm(GROUPED_WORLD)
    _gfc_cache(comm)
    _gfc_grouped()
    _gfc_flash_decode()
    _gfc_sp_step()
    launched = {k: v - before.get(k, 0) for k, v in ops.launches.items()
                if v != before.get(k, 0)}
    print(f"gfc: {time.perf_counter() - t_phase:.1f} s; kernel launches "
          f"{launched}", flush=True)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

DRYRUN_DIR = Path(__file__).resolve().parent / "build" / "dryrun"
DRYRUN_WORKERS = 8                 # dry-run processes at a time (CPU only)
DRYRUN_TIMEOUT = 900               # seconds, a process
DRYRUN_HARNESS = (("yi-6b", "train_4k"), ("mixtral-8x7b", "decode_32k"))
MEMORY_BUDGET = 0.10               # predicted peak vs measured, relative
# (label, arch, layers (0: all), kind, batch, sequence): steps that the
# train and lm phases run and measure
MEMORY_CASES = (("mamba2-1.3b train", "mamba2-1.3b", 0, "train", 2, 2048),
                ("yi-6b train", "yi-6b", 4, "train", 2, 2048),
                ("mamba2-1.3b prefill", "mamba2-1.3b", 0, "prefill", 4,
                 2048))

_DRYRUN_PEAKS = r"""
import dataclasses, json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun
out = {}
for label, arch, layers, kind, b, s in json.loads(sys.argv[1]):
    cfg = get_config(arch)
    cfg = cfg.with_(num_layers=layers) if layers else cfg
    r = dryrun.run_cell(arch, label, False, remat="none", extrapolate=False,
                        mesh_shape=(1, 1), cfg=cfg,
                        cell=ShapeCell(label, s, b, kind))
    out[label] = dataclasses.asdict(r)
print(json.dumps(out))
"""


def _dryrun_job(name: str, cmd: list) -> tuple:
    """(return code, seconds, stdout) of one dry-run process; its output
    is also kept in ``build/dryrun/<name>.log``."""
    env = dict(os.environ, PYTHONPATH=str(_src_dir()))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=DRYRUN_TIMEOUT)
    (DRYRUN_DIR / f"{name}.log").write_text(proc.stdout + proc.stderr)
    return proc.returncode, time.perf_counter() - t0, proc.stdout


def _measured_peak(case) -> int:
    """Bytes the caching allocator held at most over one step of ``case``
    on the card, less what was allocated before its model was built."""
    _, arch, layers, kind, b, s = case
    cfg = get_config(arch)
    cfg = cfg.with_(num_layers=layers) if layers else cfg
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    family = get_model(cfg)
    model = family.init(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0))
    if cfg.ssm is not None:
        ssm.init_published_a_dt(model)
    if kind == "train":
        step = train_loop.make_train_step(cfg, remat="none", lr=TRAIN_LR)
        args = (model, optimizer.adamw_init(dict(model.named_parameters())),
                train_loop.synth_batch(cfg, b, s, device="cuda"))
    else:
        step = serve_loop.make_prefill_step(cfg)
        args = (model, torch.randint(0, cfg.vocab_size, (b, s),
                                     dtype=torch.int32, device="cuda"),
                family.init_cache(cfg, b, s, dtype=torch.bfloat16,
                                  device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = step(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del model, args, out
    gc.collect()
    torch.cuda.empty_cache()
    return peak


def _ssd_bwd_scratch_check() -> int:
    """(d): K4's backward scratch formula against the library's at every
    K4 shape of the kernels phase; returns the shapes checked."""
    _, mh, _ = ssm.ssm_dims(MAMBA)
    _, zh, _ = ssm.ssm_dims(ZAMBA)
    m = (mh, MAMBA.ssm.head_dim, MAMBA.ssm.state_dim, MAMBA.ssm.chunk)
    z = (zh, ZAMBA.ssm.head_dim, ZAMBA.ssm.state_dim, ZAMBA.ssm.chunk)
    shapes = [(LM_BATCH, LM_PROMPT) + m, (1, LM_PROMPT) + m,
              (LM_BATCH, LM_PROMPT + LM_DECODE) + m, (LM_BATCH, LM_PROMPT) + z,
              (YI_TRAIN_BATCH, YI_TRAIN_SEQ) + m,
              (YI_TRAIN_BATCH, YI_TRAIN_SEQ) + z, (2, 40, 16, 16, 16, 16)]
    shapes += [(2, 300, 4) + shape for shape in ops.SSD_SHAPES]
    for shape in shapes:
        py = ops.ssd_bwd_scratch(*shape)
        lib = ops._fn("gfdit_ssd_bwd_scratch")(*shape)
        if py != lib:
            raise AssertionError(f"dryrun: K4 backward scratch at {shape}: "
                                 f"formula {py}, library {lib}")
    return len(shapes)


def phase_dryrun(smi: str) -> None:
    """The multi-pod dry run in CPU processes beside two checks on the
    card: the dry run's predicted peaks against the allocator's, and K4's
    backward scratch formula against the library's."""
    from concurrent.futures import ThreadPoolExecutor
    t_phase = time.perf_counter()
    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    module = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    jobs = {f"cells {arch}": module + [
        "--all", "--arch", arch, "--no-extract",
        "--out", str(DRYRUN_DIR / f"cells-{arch}.json")]
        for arch in ASSIGNED_ARCHS}
    for arch, shape in DRYRUN_HARNESS:
        jobs[f"harness {arch}"] = module + [
            "--arch", arch, "--shape", shape, "--multi-pod", "both",
            "--out", str(DRYRUN_DIR / f"harness-{arch}.json")]
    jobs["peaks"] = [sys.executable, "-c", _DRYRUN_PEAKS,
                     json.dumps(MEMORY_CASES)]
    first = ("peaks", "cells deepseek-v2-236b", "cells mistral-large-123b",
             "harness yi-6b")           # the longest first
    order = sorted(jobs, key=lambda n: (first.index(n) if n in first
                                        else len(first), n))
    with ThreadPoolExecutor(DRYRUN_WORKERS) as pool:
        futures = {name: pool.submit(_dryrun_job, name.replace(" ", "-"),
                                     jobs[name]) for name in order}
        # meanwhile, on the card
        n_shapes = _ssd_bwd_scratch_check()
        print(f"dryrun: (d) K4's backward scratch formula equals "
              f"gfdit_ssd_bwd_scratch at {n_shapes} shapes", flush=True)
        measured = {case[0]: _measured_peak(case) for case in MEMORY_CASES}
        done = {name: f.result() for name, f in futures.items()}
    failed = [n for n, (rc, _, _) in done.items() if rc != 0]
    total = torch.cuda.get_device_properties(0).total_memory
    rows = [r for arch in ASSIGNED_ARCHS
            if (DRYRUN_DIR / f"cells-{arch}.json").exists()
            for r in json.loads((DRYRUN_DIR / f"cells-{arch}.json")
                                .read_text())]
    print(f"dryrun: (a) {len(rows)} live cells at 16x16, per-rank peak "
          f"predicted by the dry run beside the card's total_memory "
          f"{total / 2**30:.2f} GiB ({smi}):", flush=True)
    for r in rows:
        peak = r["per_device_memory_bytes"]
        print(f"dryrun:   {r['arch']} x {r['shape']} x {r['mesh']}: "
              f"{'ok' if r['ok'] else 'FAIL ' + r['error'][:200]}, peak "
              f"{peak / 2**30:.2f} GiB ({peak / total:.2f} of the card), "
              f"flops {r['flops']:.4g}, trace {r['compile_s']:.1f} s",
              flush=True)
    problems = []               # raised after every part has printed
    if failed:
        problems.append(f"processes failed: {failed} (logs in {DRYRUN_DIR})")
    if len(rows) != 34 or not all(r["ok"] for r in rows):
        problems.append("(a) a live cell failed to trace")
    for arch, shape in DRYRUN_HARNESS:
        path = DRYRUN_DIR / f"harness-{arch}.json"
        got = json.loads(path.read_text()) if path.exists() else []
        for r in got:
            print(f"dryrun: (b) {arch} x {shape} x {r['mesh']}: ok "
                  f"{r['ok']}, flops {r['flops']:.4g}, hlo_bytes "
                  f"{r['hlo_bytes']:.4g}, collectives "
                  f"{r['collective_bytes']}, peak "
                  f"{r['per_device_memory_bytes'] / 2**30:.2f} GiB, output "
                  f"{r['output_bytes'] / 2**30:.2f} GiB, trace "
                  f"{r['compile_s']:.1f} s", flush=True)
        single = [r for r in got if r["mesh"] == "16x16"]
        if len(got) != 2 or not all(r["ok"] for r in got) or (
                shape == "train_4k" and not (
                    single[0]["flops"] > 1e15
                    and all(r["collective_bytes"] for r in got))) or (
                shape == "decode_32k" and not all(
                    r["per_device_memory_bytes"] > 0 for r in got)):
            problems.append(f"(b) {arch} x {shape}: {got}")
    predicted = json.loads(done["peaks"][2].strip().splitlines()[-1])
    worst = 0.0
    for label, meas in measured.items():
        r = predicted[label]
        ratio = r["per_device_memory_bytes"] / meas
        worst = max(worst, abs(ratio - 1))
        print(f"dryrun: (c) {label} at 1x1: predicted peak "
              f"{r['per_device_memory_bytes'] / 2**30:.3f} GiB, measured "
              f"{meas / 2**30:.3f} GiB, ratio {ratio:.4f} (budget "
              f"{MEMORY_BUDGET:.0%}); on {smi}", flush=True)
        if not (r["ok"] and abs(ratio - 1) <= MEMORY_BUDGET):
            problems.append(f"(c) {label}: predicted "
                            f"{r['per_device_memory_bytes']}, measured {meas}")
    walls = {name: round(sec, 1) for name, (_, sec, _) in done.items()}
    print(f"dryrun: {time.perf_counter() - t_phase:.1f} s; process walls "
          f"{walls}; worst (c) miss {worst:.2%}", flush=True)
    if problems:
        raise AssertionError("dryrun: " + "; ".join(problems))


# the bench phase: the twins of benchmarks/ (repro_torch.benchmarks)
BENCH_DIR = Path(__file__).resolve().parent / "build" / "bench"
# the simulator-only twins and the two that time GFC's host plane: each
# in a process of its own on the host, beside the cache slice
BENCH_HOST = ("arrival_scaling", "overhead_fcfs_sp4", "stage_scaling",
              "telemetry_scale", "gfc_collectives", "migration_overhead")
BENCH_TIMEOUT = 600                # seconds, a host suite's process


def _bench_rows(rows, smi: str) -> None:
    for name, us, derived in rows:
        print(f"bench: {name},{us:.1f},{derived} (on {smi})", flush=True)


def phase_bench(smi: str) -> dict:
    """The twins of ``benchmarks/`` on the card and its host, results in
    ``build/bench/``: (a) ``sim_fidelity``'s real-runtime leg at
    DIT_IMAGE's full width and depth under fcfs-sp1, srtf-sp1 and edf
    (12 requests of 4 steps, one rank), replayed on the simulator with
    the costs the real run calibrated; every request must complete on
    both, K1 and K2 launch, and the card's stage costs print beside the
    analytical model's; (b) ``policies_e2e``'s cache slice, its pixel
    probe on the card through K1-K3, held to the slice's own gate
    (``check_cache``: cached >= 1.2x throughput, stale-reuse error within
    5e-2, ``interval1_exact``); (c) ``roofline`` over the dryrun phase's
    34 cells with the H100's constants, and its kernel-traffic gate; (d)
    the host suites (BENCH_HOST), each in a process of its own during
    (b) and (c).  Any suite that raises fails the phase.  Returns the
    kernels' launches over (a) and (b)."""
    import importlib
    mods = {name: importlib.import_module(f"repro_torch.benchmarks.{name}")
            for name in ("sim_fidelity", "policies_e2e", "roofline")}
    t_phase = time.perf_counter()
    BENCH_DIR.mkdir(parents=True, exist_ok=True)
    problems, walls = [], {}
    ops.reset_launches()
    t0 = time.perf_counter()
    fid = mods["sim_fidelity"].run("cuda", BENCH_DIR, demos=False)
    walls["sim_fidelity"] = time.perf_counter() - t0
    a_launches = dict(ops.launches)
    _bench_rows(mods["sim_fidelity"].rows(fid), smi)
    for cls, stages in fid["stage_costs"].items():
        print(f"bench: (a) class {cls} ({stages['tokens']} tokens) stage "
              f"costs on the card vs the analytical model: " + ", ".join(
                  f"{k} {stages[k]['measured_s'] * 1e3:.3f} ms vs "
                  f"{stages[k]['analytic_s'] * 1e3:.3f} ms"
                  for k in mods["sim_fidelity"].STAGES)
              + f" (on {smi})", flush=True)
    for pol in mods["sim_fidelity"].POLICIES:
        m = fid[pol]
        print(f"bench: (a) {pol}: SLO attainment real {m['real_slo']:.4f} "
              f"sim {m['sim_slo']:.4f}, gap {m['gap_pp']:.2f} pp (paper <= "
              f"4.7); mean latency real {m['real_mean_lat']:.4f} s sim "
              f"{m['sim_mean_lat']:.4f} s; completed real "
              f"{m['real_completed']} sim {m['sim_completed']} of "
              f"{m['requests']}; calibrated stage costs (s) "
              f"{m['calibrated_s']} (on {smi})", flush=True)
        if not m["real_completed"] == m["sim_completed"] == m["requests"]:
            problems.append(f"(a) {pol}: completed {m['real_completed']} "
                            f"real, {m['sim_completed']} sim of "
                            f"{m['requests']}")
    if min(a_launches[k] for k in ("fused_adaln", "attention")) <= 0:
        problems.append(f"(a) launches {a_launches}")
    env = dict(os.environ, PYTHONPATH=str(_src_dir()))
    host = {name: subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.benchmarks.{name}", "--out",
         str(BENCH_DIR)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name in BENCH_HOST}
    t_host = time.perf_counter()
    try:
        ops.reset_launches()
        t0 = time.perf_counter()
        pe = mods["policies_e2e"].run(only="cache", device="cuda",
                                      out_dir=BENCH_DIR)
        walls["policies_e2e cache"] = time.perf_counter() - t0
        b_launches = dict(ops.launches)
        _bench_rows(mods["policies_e2e"].cache_rows(pe), smi)
        err = pe["cache|error"]
        print(f"bench: (b) cache probe on the card (DIT_IMAGE.reduced(), "
              f"interval {err['cache_interval']}): hits {err['hits']}, "
              f"refreshes {err['refreshes']}, stale-reuse rel-L2 "
              f"{err['rel_l2_err']:.3e}, interval-1 within the pixel budget "
              f"{err['interval1_exact']} (rel-L2 "
              f"{err['interval1_rel_l2']:.3e}, bit-equal "
              f"{err['interval1_bitexact']}); launches {b_launches}",
              flush=True)
        problems += [f"(b) {p}" for p in mods["policies_e2e"].check_cache(pe)]
        if min(b_launches[k] for k in DIT_KERNELS) <= 0:
            problems.append(f"(b) launches {b_launches}")
        t0 = time.perf_counter()
        rf = mods["roofline"].run(out_dir=BENCH_DIR, cells=DRYRUN_DIR)
        walls["roofline"] = time.perf_counter() - t0
        _bench_rows(mods["roofline"].rows(rf), smi)
        if len(rf["table"]) != 34:
            problems.append(f"(c) roofline over {len(rf['table'])} cells "
                            f"of {DRYRUN_DIR}, not the 34 live ones")
        for name, proc in host.items():
            out, err = proc.communicate(timeout=BENCH_TIMEOUT)
            walls[name] = time.perf_counter() - t_host
            for line in out.splitlines():
                print(f"bench: {line} (host; on {smi})", flush=True)
            if proc.returncode:
                problems.append(f"(d) {name} exited {proc.returncode}: "
                                f"{err[-2000:]}")
    finally:
        for proc in host.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"bench: {time.perf_counter() - t_phase:.1f} s; suite walls (s, "
          f"the host suites' from their start) "
          + ", ".join(f"{k} {v:.1f}" for k, v in walls.items()), flush=True)
    if problems:
        raise AssertionError("bench: " + "; ".join(problems))
    return {k: a_launches[k] + b_launches[k] for k in DIT_KERNELS}


#: the phases ``--phase`` runs after the device and build phases
PHASES = {"serve": lambda smi: phase_serve(), "splits": phase_splits,
          "scenarios": phase_scenarios, "failure": phase_failure,
          "video": phase_video, "ssd": phase_ssd, "lm": phase_lm,
          "hybrid": phase_hybrid,
          "zoo": phase_zoo, "train": phase_train,
          "train-cpu": lambda smi: phase_train_cpu(),
          "gfc": phase_gfc, "dryrun": phase_dryrun, "bench": phase_bench,
          "gemm": phase_gemm}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="run the device, build and kernels phases only")
    parser.add_argument("--src", help="import repro_torch from this src "
                        "directory (default: the one beside this script)")
    parser.add_argument("--json", help="write every timed kernel case here")
    parser.add_argument("--fp32-grad", action="store_true",
                        help="run the device and build phases and the "
                        "train phase's fp32 DIT_IMAGE gradient")
    parser.add_argument("--phase", action="append", choices=PHASES,
                        help="run the device and build phases and this one "
                        "(repeatable, in the order given); prints neither "
                        "the kernels line nor the last line")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA device", file=sys.stderr)
        return 2
    smi = phase_device()
    phase_build()
    if args.fp32_grad:
        _dit_fp32_grad(*_dit_train_setup(), smi)
        return 0
    if args.phase:
        for name in args.phase:
            PHASES[name](smi)
        print(f"chip_smoke: phases {args.phase} passed", flush=True)
        return 0
    results = phase_kernels()
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(
            {"card": smi, "src": str(_src_dir()),
             "timed": results["timed"]}, indent=1))
    if args.kernels_only:
        return 0
    counts = phase_serve()
    phase_sp()
    phase_cpu()
    for name, n in phase_scenarios(smi).items():
        counts[name] += n
    video = phase_video(smi)
    for name, n in video.items():
        counts[name] += n
    torch.cuda.empty_cache()
    counts.update(phase_lm(smi))
    phase_lm_cpu()
    zamba = phase_hybrid(smi)
    phase_hybrid_cpu()
    whisper = phase_zoo(smi)
    phase_zoo_cpu()
    train, train_steps = phase_train(smi)
    phase_train_cpu()
    phase_gfc(smi)
    phase_dryrun(smi)
    bench = phase_bench(smi)
    counts.update({k: train[k] for k in BWD_KERNELS + ("ssd_bwd bf16",)})
    counts["ssd bf16"] += zamba["ssd_bf16"]["ssd bf16"]
    for route, n in whisper["routes"].items():   # whisper's, both dtypes
        counts[route] = counts.get(route, 0) + n
    lm_launches = {"zamba2-7b attention": zamba["forward"]["attention"],
                   "zamba2-7b ssd": zamba["prefill"]["ssd"],
                   "zamba2-7b ssd bf16": zamba["ssd_bf16"]["ssd bf16"],
                   "zamba2-7b ssd_bwd":
                       train_steps[ZAMBA_TRAIN.name]["ssd_bwd"],
                   "yi-6b attention": None}
    # whisper-medium's K2, counted at its sites: the fp32 entries from the
    # fp32 prefill + decode, the bf16 ones from the bf16 serve
    for tag, dtype in (("", "fp32"), (" bf16", "bf16")):
        for label, launched in whisper[dtype].items():
            lm_launches[f"whisper-medium {label}{tag} attention"] = launched
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = results[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "call_ms": r["call_ms"], "host_us": r["host_us"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"],
                        "library_call_ms": r["library_call_ms"]})
        if name in ("fused_adaln", "attention", "ssd", "ssd bf16") + \
                FP32_ROUTES + BF16_ROUTES:
            kernels[-1]["train_launches"] = train[name]   # the train phase's
        if name in ("attention", "attention_bwd"):   # a whisper train step's
            kernels[-1]["whisper-medium train_launches_a_step"] = \
                train_steps[WHISPER.name][name]
        if name in bench:                            # the bench phase's
            kernels[-1]["bench_launches"] = bench[name]
        if name in BWD_KERNELS + ("ssd_bwd bf16",):
            kernels[-1]["note"] = ("backward kernel; the TPU kernel it "
                                   "differentiates has none")
        # the same kernel at DIT_VIDEO's shape and at the decoder LMs'
        # (launches: a zamba2-7b forward's K2, a prefill's K4; yi-6b's
        # full-width forward is timed only)
        for key, label, launched in (
                [("video", f"video {name}", video.get(name))]
                + [(m, f"{m} {name}", lm_launches.get(f"{m} {name}"))
                   for m in ("zamba2-7b", "yi-6b") + tuple(
                       f"whisper-medium {c}{t}" for c in ("self", "cross",
                                                          "decode")
                       for t in ("", " bf16"))]):
            v = results.get(label)
            if v is not None:
                kernels[-1][key] = {
                    "case": v["case"], "launches": launched,
                    **{k: v[k] for k in ("max_abs_err", "ms", "call_ms",
                                         "host_us", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")}}
        # the backward kernels' other timed cases, and K2's forward with
        # the log-sum-exp written (launched in the train phase only)
        extra = {"fused_adaln": ["fused_adaln gated_residual",
                                 "fused_adaln gated_residual bf16"],
                 # fp32 K2/K3 at the 512 px shard, by the route taken,
                 # and whisper's decode step beside the split summary
                 **{r: [k for k, v in results.items()
                        if k.startswith("attention fp32 512px ")
                        and v["route"] == r and v is not results[r]]
                    + (["whisper-medium decode attention"]
                       if r == FP32_ROUTES[1] else [])
                    for r in FP32_ROUTES},
                 "attention": ["attention with lse"],
                 "attention_bwd": [k for k in results if k.startswith(
                     "attention_bwd ") and k != "attention_bwd dit self"],
                 "fused_adaln_bwd": [k for k in results if k.startswith(
                     "fused_adaln_bwd ")],
                 "ssd": ["ssd b=1"], "ssd bf16": ["ssd b=1 bf16"]}
        for label in extra.get(name, ()):
            v = results[label]
            kernels[-1][label] = {k: v[k] for k in (
                "case", "dtype", "max_abs_err", "ms", "call_ms", "host_us",
                "plain_ms", "bound_ms", "bound_by", "library_ms", "pieces",
                "tile_ms") if k in v}
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"kernels the main path never launched: {idle}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

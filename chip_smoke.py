#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the root of a checkout: ``python3 chip_smoke.py``.  In order it

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` each,
   all at once) into ``build/kernels``;
3. fits the bucket curvefit model on the card;
4. compiles the fpca_cnn model at full width (120x120x3 frames, 8 channels,
   4608 -> 64 -> 2 head) with random weights from a seeded generator;
5. serves requests through ``CompiledModel.run``: batches of 1, 64 and 256
   frames, one region-skip request keeping ~10% of the blocks, one
   all-skipped request; counts the kernel launches of that run, and checks
   that every one took the kernel's tensor-core design;
6. holds each kernel of the path against its plain PyTorch version on the
   card (both designs of the fpca kernel, with their flip shares), and the
   served counts and logits against the dense oracle;
7. times each kernel, its plain version and its bound: the fpca kernel's
   two designs at the windows of batch 1, 64 and 256, beside a bound of
   four parts (bytes, tensor-core, fp32 and MUFU operations);

then, through the same kernel, the model zoo and int8 head serving:

7a. builds fpca_resnet (residual graph head: width 16, hidden 32, 2
   classes) and fpca_detect (detection head: trunk 16, 2 classes, per-cell
   scores and boxes) with ``build_model`` at full width, serves each the
   five requests above with the counts set to 0 before and read after,
   checks one launch per request that is not all skipped, every one on the
   tensor-core design, the output shapes, ``run`` == head(frontend counts)
   bit for bit, counts against the dense oracle, compact == masked dense
   and a head rewrite that builds nothing; times each request and profiles
   one at batch 256;
7b. serves fpca_cnn and fpca_resnet with ``precision="int8"`` (heads
   calibrated on the counts of the batch-64 frames) the same way, and checks
   every quantised stage's int32 accumulators on the card against the
   host's on the same inputs, bit for bit, and the int8 logits against the
   host's int8 head; prints the int8-vs-f32 parity;
7c. streams the moving-object video (120x120x3, seed 0, speed 0.17) through
   fpca_cnn and fpca_detect at full width under the default gate (threshold
   0.02, hysteresis 1, keyframe every 30): 128 ticks per tick through
   ``stream()`` (launches counted by the wrapper) and as four chained
   ``run_segment`` calls of 32 ticks, each replayed as one CUDA graph whose
   fpca launches (one per tick, all on the tensor-core design) are counted
   from the profiler; checks segments == ``stream()`` bit for bit (counts,
   masks, logits or detections), an early-exit segment on a static scene
   stopping where the per-tick loop goes quiet, a dense segment, the basis
   backend's segments within the fpca limit, and a reprogram and threshold
   changes between segments that capture nothing; prints per-tick times of
   both routes, capture time, a replay's device time and busy share, the
   rows the kernel walked beside ``rows_executed``, and the kernel's time at
   M = 576 with device row counts 576, 58 and 0;

7d. serves multi-camera traffic through ``repro_torch.serving``: an
   ``FPCAPipeline`` with dense_5x5 (the fpca_cnn frontend, twice, under two
   weight draws), overlap_3x3 (N = 27), binned_lowpower, fpca_cnn and
   fpca_detect serves a seeded mix of 256 requests (10% with a block mask)
   with cross-config batching off and on: one fpca launch per group or
   merged group, every result against its config's own handle bit for bit,
   merged against unmerged (the merged C = 32 group takes the SIMT design:
   bit for bit against SIMT launches, within the fpca limit against the
   tensor-core ones); then 16 fpca_cnn cameras (12 moving) and two fan-out
   cameras (C = 16: per-config gates; an event tap) on a ``StreamServer``,
   64 ticks at depth 1 and 2, each camera against its own ``stream()`` bit
   for bit, ms per tick and the busy share; the stacked C = 16 launch
   against its plain version and timed beside two C = 8 launches; and the
   same cameras under a ``FleetController`` (budget 2.4, floor 0.02,
   target 0.15), 64 ticks through ``run`` and 64 through ``serve_segments``
   (K = 32) interleaved on one shared graph, each segment against the
   camera's own ``run_segment`` bit for bit, the allocation gauges summing
   to the budget, ``assert_reconciled`` and ``render_fleet_report``;

7e. trains the FPCA training example (``examples/train_fpca_cnn_torch.py``
   at its defaults: 60x60x3 frames, 8 channels of 5x5 at stride 5, 4-bit
   ADC, 8 NVM levels, batch 32, 200 AdamW steps) on the card twice: through
   ``FPCAFrontend.apply(train=True)`` (the differentiable bucket model with
   STEs, ``hw_aware``) and through an ideal convolution (``naive``); first
   holds one hw-aware loss and its gradients against the host's at 20x20
   frames; checks finite losses and grad norms and no fpca launch in
   training; scores both networks on the circuit oracle (512 images) and
   the hw-aware one through the fpca kernel (``backend="cuda"``, one
   launch per batch of 128), checking hw-aware >= 80% and above naive;
   compiles the exported bundle and checks its counts equal the layer's
   kernel counts bit for bit; holds the kernel against its plain version
   at M = 18,432; prints step times, a step's device time, busy share and
   peak memory, evaluation times and the calibration;
7f. imports each example twin (``examples/*_torch.py``) and calls its
   ``main`` at its defaults on the card, the kernel counts set to 0 just
   before and read just after: quickstart (the oracle, no kernel),
   region_skipping, serve_frontend, serve_fpca_cnn (with ``--weights``, the
   bundle 7e exported, and with ``--precision int8``), stream_video and
   adaptive_stream each reach the fpca kernel, every launch on the
   tensor-core design but adaptive_stream's channel-stacked C = 12 ones
   (SIMT); serve_lm at its smoke default launches the flash kernel once a
   layer; prints each run's seconds and launches; then runs each twin
   again on the host (``--device cpu``: the plain path, on the bucket
   model the card run fitted) and holds the card's numbers against the
   host's: counts within the fpca limit, logits within the bound their
   counts give (int8: equal counts, equal logits within 1%), kept windows,
   cache and pipeline stats, fan-out counts, servo thresholds, cycles and
   energies equal; serve_lm's greedy tokens against the host's prefill of
   the same weights and tokens, teacher-forced, where the margin is clear;

then the language-model serving path (``repro_torch.launch.serve``):

8. initialises zamba2-7b at full width (d_model 3584, 81 Mamba2 layers, one
   shared attention block applied 13 times) in bf16 on the card from a
   seeded CUDA generator;
9. serves 8 requests of 4096 random tokens in waves of 4, 32 greedy tokens
   each, and checks the launch counts: 13 flash-attention and 81 SSD
   launches per prefill, none in decode, every flash and every SSD launch
   on its kernel's tensor-core design; tokens in range, logits finite;
10. holds the port's kernel path against its plain versions on the host on
   the narrow smoke config (f32), and each LM kernel against its plain
   version at the served shapes, on inputs captured from a served prefill;
11. times each LM kernel, its plain version, its bound and the library call
   that computes the same function (and the SSD kernel's SIMT design beside
   its tensor-core design), and profiles one prefill;

then dense serving (``repro_torch.launch.serve``), each model's weights
freed before the next:

11a. smoke qwen3-1.7b and h2o-danube-1.8b (f32, 2 layers, danube's window
   cut to 32 under a 200-token prompt): card kernels against the host's
   plain path, prefill and decode;
11b. qwen3-1.7b at full width and depth (28 layers, d_model 2048, 16 heads
   over 8 KV heads of 128, tied embeddings, qk-norm) in bf16 from a seeded
   CUDA generator: 8 requests of 4096 tokens in waves of 4, 32 greedy
   tokens each; h2o-danube-1.8b at full width and depth (24 layers,
   d_model 2560, 32 heads over 8 KV heads of 80, sliding window 4096): one
   wave of 2 prompts of 8192 tokens, 16 greedy tokens, its decode cache a
   4096-slot ring; checks one flash launch per layer per prefill, all on
   the tensor-core design, none in decode, and decode teacher-forced on the
   served tokens against a fresh prefill of the prompt plus the tokens so
   far (bf16 bound; greedy tokens where the margin is clear), the decode's
   K/V cache (the ring past the window) against the fresh prefill's, and a
   control: a decode step at a position off by one must fail that cache
   check; holds the flash kernel against its plain version on inputs
   captured from a served prefill, times it beside its bound and the
   library call that also skips the masked blocks (SDPA's causal GQA form;
   ``flex_attention`` with a sliding-window block mask under a window), and
   profiles one prefill and one decode step;

then, with the served weights freed, the training path
(``repro_torch.training.train_step``):

12. holds dense training through the kernels on the card against the plain
   path on the host on the narrow qwen3 smoke config (f32): loss and every
   gradient;
13. initialises qwen3-1.7b at full width and depth (28 layers, d_model
   2048, 16 heads over 8 KV heads of 128, vocab 151936) in bf16 on the card
   from a seeded CUDA generator, and takes 4 AdamW steps on synthetic data
   at 8 x 4096 tokens (2 microbatches, full remat), checking finite loss
   and grad norm and the exact launch counts of the three flash kernels
   on every step;
14. holds the forward kernel (output within one bf16 ulp, LSE) and the dQ
   and dK/dV kernels against their plain versions on inputs captured from
   a training step, prints how far the forward's SIMT design lies from its
   tensor-core design there, times the backward kernels
   beside their bounds, their plain version and the SDPA backward, prints
   their achieved TFLOP/s, times the forward kernel and SDPA's forward at
   that shape with its achieved TFLOP/s, and profiles one step.  Every bf16
   forward, dQ and dK/dV launch of a step must take the tensor-core design,
   and ptxas must report no spill for any tensor-core kernel, flash, SSD or
   fpca (printed after the build), and no serialised wgmma in the SSD or
   fpca one;

then the remaining families, each model's weights freed before the next:

15. serves granite-moe-3b-a800m (8 requests of 2048 tokens in waves of 4),
   qwen2-moe-a2.7b (4 x 2048, shared experts), mamba2-2.7b (4 x 4096, SSD
   at N = 128), seamless-m4t-medium (4 requests of 1500 source frames and
   1024-token prompts) and internvl2-76b at full width cut to 12 of its 80
   layers (2 requests of 256 patch embeddings and 1792 tokens), 16 greedy
   tokens each, through ``launch.serve`` (``family_serving_phase``): the
   narrow config's card kernels against the host first; one flash launch
   per attention call and one SSD launch per Mamba2 layer a prefill, all
   on the tensor-core designs, none in decode; moe_drop_frac at prefill;
   decode against a fresh prefill with its control, in f32 on the served
   weights (moe with a lossless capacity, leaving out what a top-k routing
   flip between the two paths reached); the flash forward against its plain version at each
   captured kind (causal D = 64, bidirectional, cross-attention with
   Sq != Sk and a ragged Sk, and there the dQ and dK/dV kernels too) and
   the SSD kernel at N = 128, each timed beside its bound and SDPA; a
   profiled prefill and decode step;
16. trains granite-moe-3b-a800m and mamba2-2.7b (8 x 2048, 4 microbatches,
   remat ``dots``) and seamless-m4t-medium (8 x 1024, 2, ``dots``) at full
   width, and zamba2-7b cut to 27 of its 81 layers (4 x 2048, 2, ``full``),
   two AdamW steps each (``family_train_phase``): finite loss and grad
   norm, the first loss within 0.5 of ln(vocab) + sigma^2 / 2, the exact
   flash forward, dQ, dK/dV and SSD launches of every step (all on the
   tensor-core designs), no plain version on the path; the backward
   kernels against their plain version at the captured bidirectional and
   causal D = 64 shapes, timed; one step profiled;
17. narrow (f32) internvl2-76b and qwen2-moe-a2.7b training, card kernels
   against the host's plain path (remat none and dots), and
   ``SSDIntraChunk``'s gradients on the card against the host's.

It prints one JSON line ``{"kernels": [...]}`` and, last,
``{"ok": true, "device": {...}}``; a failed phase exits non-zero before
that line, as does a host with no CUDA device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import fpca  # noqa: E402
from repro_torch.configs import fpca_cnn  # noqa: E402
from repro_torch.core.curvefit import fit_bucket_model  # noqa: E402
from repro_torch.core.fpca_sim import encode_weights, extract_windows, fpca_forward  # noqa: E402
from repro_torch.core.frontend import FPCAFrontend  # noqa: E402
from repro_torch.core.mapping import active_window_mask, output_dims  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.fpca_conv import kernel as fpca_kernel  # noqa: E402
from repro_torch.kernels.fpca_conv.kernel import (  # noqa: E402
    conv_tables,
    fpca_conv_basis,
    fpca_conv_cuda,
    weight_planes,
)
from repro_torch.configs import ARCHS, reduce_for_smoke  # noqa: E402
from repro_torch.data.pipeline import LMStreamConfig, SyntheticLM, SyntheticMovingObject, SyntheticVWW  # noqa: E402
from repro_torch.kernels.flash_attention import bwd as flash_bwd  # noqa: E402
from repro_torch.kernels.flash_attention.bwd import (  # noqa: E402
    flash_attention_dkdv_cuda,
    flash_attention_dq_cuda,
)
from repro_torch.kernels.flash_attention.bwd_ref import attention_delta, flash_attention_bwd_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash_fwd  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd.kernel import ssd_intra_chunk_cuda  # noqa: E402
from repro_torch.kernels.ssd.ref import ssd_intra_chunk_ref  # noqa: E402
from repro_torch.launch.serve import frontend_inputs, serve  # noqa: E402
from repro_torch.launch.train import frontend_batch  # noqa: E402
from repro_torch.models import ssm as ssm_module  # noqa: E402
from repro_torch.models.attention import attend_blockwise  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.transformer import forward_decode, forward_prefill, forward_train, init_model  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig, init_adamw  # noqa: E402
from repro_torch.training.train_step import make_train_step  # noqa: E402
from repro_torch.training.tree import tree_leaves  # noqa: E402

SEED = 0
BATCHES = (1, 64, 256)
# NVIDIA H100 SXM data-sheet peaks: HBM3 bandwidth, non-tensor fp32 rate,
# dense bf16 tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
# MUFU (ex2, rcp) results: 16 a clock per SM (the CUDA C++ Programming
# Guide's throughput table, compute capability 9.0) x 132 SMs x the 1.98 GHz
# boost clock
PEAK_MUFU_PER_S = 16 * 132 * 1.98e9
# bf16 wgmma passes of the SSD and fpca kernels' tensor-core designs per
# product: each f32 operand split into three bf16 parts, six products of parts
SSD_PASSES = FPCA_PASSES = 6
# the fpca gate bank as the tensor-core design computes it, counted from
# csrc/fpca_conv.cu per (window, channel, phase): the f_avg estimate (T
# FMAs); per bucket edge (NB + 1, shared by neighbouring buckets) the
# sigmoid's argument and 1 + e (3 FLOP), an expf (ex2) and a reciprocal (2
# MUFU); per bucket the gate (1), the 10-term combine (10 FMAs) and its
# accumulation (1 FMA), 23 FLOP; 2 more MUFU: the division of xg and half
# of the two ADC divisions of a (window, channel).  Per window: x^2, x^3 and
# the three sums, 5 N FLOP.
FPCA_FLOP_PER_EDGE, FPCA_FLOP_PER_BUCKET, FPCA_MUFU_PER_EDGE, FPCA_MUFU_EXTRA = 3, 23, 2, 2
COUNT_TOL, FLIP_TOL = 1.0, 0.05   # <= 1 ADC count, < 5% of counts off
# the zoo's graph-head archs, and the archs served with an int8 head
ZOO_ARCHS, INT8_ARCHS = ("fpca_resnet", "fpca_detect"), ("fpca_cnn", "fpca_resnet")
# streaming: four chained segments of K = 32 ticks over the moving-object
# video, then K static frames (the early-exit segment, patience 4), for
# fpca_cnn and fpca_detect under the program's default gate
STREAM_ARCHS, STREAM_K, STREAM_SEGMENTS, STREAM_EARLY_EXIT = ("fpca_cnn", "fpca_detect"), 32, 4, 4
# the fpca kernel's rows at M = 576 (a batch-1 tick), timed with these
# device row counts: all, a tick keeping ~10%, none
STREAM_N_ROWS = (576, 58, 0)
# multi-camera serving: a seeded mix of PIPE_REQUESTS requests over six
# registered names, PIPE_MASKED of them with a block mask, serve timed over
# PIPE_TIMED runs; FLEET_CAMERAS fpca_cnn cameras (the first FLEET_MOVING
# moving) and two fan-out cameras, FLEET_TICKS ticks through run() and as
# many through segments of FLEET_SEGMENT ticks, under one fleet budget
PIPE_REQUESTS, PIPE_MASKED, PIPE_TIMED = 256, 0.10, 10
FLEET_CAMERAS, FLEET_MOVING, FLEET_TICKS, FLEET_SEGMENT = 16, 12, 64, 32
FLEET_CONFIG, FLEET_TARGET = {"budget": 2.4, "floor": 0.02, "rebalance_ticks": 8}, 0.15
# the server's warm-up ticks (a keyframe and deltas), and the ticks over
# which the fan-out is held against each config served alone (a keyframe
# period and a refresh)
SERVER_WARM, FAN_SOLO_TICKS = 4, 32
# the FPCA training path (examples/train_fpca_cnn_torch.py at its defaults,
# read from the example: STEPS AdamW steps of BATCH per mode, ADC_BITS,
# NVM_LEVELS); the card-vs-host check at 20x20 frames, 4 channels, batch 4;
# the hw-aware network must reach FPCA_TRAIN_MIN_ACC on the circuit oracle
# and beat the naive one
FPCA_TRAIN_SMOKE = dict(image_h=20, image_w=20, out_channels=4, kernel=5, stride=5)
FPCA_TRAIN_SMOKE_BATCH, FPCA_TRAIN_MIN_ACC = 4, 0.80
# int8 logits card vs host from the same counts and quantised parameters,
# as a share of max|logit|: every stage's int32 accumulators agree exactly;
# the f32 ops between stages (an avg-pool summed in another order) can move
# a value by an ulp, and where that crosses a rounding point a later stage's
# requantised input moves one step, its output by s_x * s_w * |w_q| (about
# max|x| * max|w| / 127)
INT8_LOGIT_RTOL = 1e-2

# LM serving path: zamba2-7b at full width, 8 requests of 4096 tokens in
# waves of 4, 32 greedy tokens each
LM_ARCH, LM_REQUESTS, LM_BATCH, LM_PROMPT, LM_TOKENS = "zamba2-7b", 8, 4, 4096, 32
# Kernel vs plain version on the card.  Flash (bf16): both sides compute in
# f32 and round the output once to bf16, so they may differ by one bf16 ulp
# (<= 2**-7 of the value) plus f32 noise.  SSD (f32): sums of up to 128
# products in another order, max|diff| <= 2e-5 of max|value|.
FLASH_RTOL, FLASH_ATOL, SSD_NORMWISE = 2.0**-7, 1e-4, 2e-5
# port on the card vs port on the host, smoke config in f32 (sums in
# another order through 3 layers)
SMOKE_TOL = 1e-4

# Dense LM serving at full width and depth, arch -> (requests, batch, prompt,
# greedy tokens): qwen3-1.7b 8 x 4096 tokens in waves of 4 (D = 128,
# 16:8 GQA); h2o-danube-1.8b one wave of 2 x 8192, past its 4096-token
# sliding window (D = 80, 32:8 GQA)
DENSE_SERVING = {"qwen3-1.7b": (8, 4, 4096, 32), "h2o-danube-1.8b": (2, 2, 8192, 16)}
# decode against a fresh prefill of the prompt plus the generated tokens
# (bf16): logits within DECODE_ULPS bf16 ulps of max|logit|, and the greedy
# token equal wherever the prefill's top-2 margin exceeds twice that; every
# K/V slot of the decode's cache within CACHE_ULPS bf16 ulps of the layer's
# max|value| in the prefill's
DECODE_ULPS, CACHE_ULPS = 4, 8

# The remaining families served at full width, arch -> (requests, batch,
# prompt tokens, greedy tokens, encdec source frames, depth cut): moe
# granite-moe-3b-a800m (a 8192-token prefill group, capacity 2048 an
# expert: drops possible; decode groups keep every token) and qwen2-moe-a2.7b
# (shared experts), the ssm mamba2-2.7b (SSD at N = 128, 32 chunks), the
# encdec seamless-m4t-medium (1500 frames: no multiple of a key tile) and the
# vlm internvl2-76b (256 patch embeddings 3200 wide, then 1792 text tokens)
FAMILY_SERVING = {
    "granite-moe-3b-a800m": (8, 4, 2048, 16, None, None),
    "qwen2-moe-a2.7b": (4, 4, 2048, 16, None, None),
    "mamba2-2.7b": (4, 4, 4096, 16, None, None),
    "seamless-m4t-medium": (4, 4, 1024, 16, 1500, None),
    "internvl2-76b": (2, 2, 1792, 16, None, 12),
}
# trained at full width, arch -> (global batch, tokens a sequence,
# microbatches, remat, depth cut), FAMILY_TRAIN_STEPS AdamW steps each;
# seamless's 2 microbatches keep its f32 logits (256,206 wide) at 4.2 GB
# a microbatch, granite's and mamba2's 4 keep the train step within the
# card (66.2 and 70.1 GiB at the peak)
FAMILY_TRAINING = {
    "granite-moe-3b-a800m": (8, 2048, 4, "dots", None),
    "mamba2-2.7b": (8, 2048, 4, "dots", None),
    "seamless-m4t-medium": (8, 1024, 2, "dots", None),
    "zamba2-7b": (4, 2048, 2, "full", 27),
}
FAMILY_TRAIN_STEPS = 2
# narrow (reduce_for_smoke, f32) training, card kernels against the host's
# plain path, for the families too wide to train on one card
NARROW_TRAINING = ("internvl2-76b", "qwen2-moe-a2.7b")
DEPTH_CUTS = {
    "internvl2-76b": "its 80 layers hold 141 GB of bf16 weights, more than the card's 80 GB; 12 layers at "
                     "full width hold 25 GB (sharding over four cards comes with the launch tooling)",
    "zamba2-7b": "81 layers need 94.5 GB of train state (bf16 params, f32 gradient accumulators and AdamW "
                 "moments), more than the card's 80 GB; 39 layers (49 GB) ran out of memory in AdamW's f32 "
                 "temporaries of the 7 GB stacked in_proj leaf; 27 layers (4 groups of 6, a tail of 3) fit",
}
# These families' decode against a fresh prefill runs twice.  In bf16, as
# served (weights, depth, the first wave's rows and served tokens), within
# BF16_DECODE's bounds (bf16 ulps of max|logit|, of each cache layer's
# max|value|; DECODE_ULPS and CACHE_ULPS where none is listed), set at
# 1.5-2x the card's readings (logits, cache; the control's): granite 7.75,
# 21 (20, 241); qwen2-moe 2.2, 15 (9.3, 140); mamba2 21, 67 (206, 468): its
# decode's bf16 roundings feed the f32 state every step, and the gap grows
# from 5.7 ulps at the first step to 21 at the 15th; internvl2 3, 1.5 (11,
# 136); seamless 1.75, 2.5.  moe runs it at a lossless capacity on
# CHECK_BATCH rows and does not compare the served tokens (the served
# 8192-token prefill groups drop 23-44% of the expert slots), and a bf16
# rounding of the router's input can flip a top-k choice.  A one-position
# RoPE shift moves seamless's logits by 2.5 ulps, inside any bound its
# readings allow, so there only the cache sees the bf16 control
# (BF16_BLIND_LOGITS).  And in f32 on copies of the served weights (moe with
# a lossless capacity), where the control leaves both bounds (seamless's
# logits by 5.6x, the rest by 80x or more); the f32 check's depth where the
# copy beside the served weights would not fit (qwen2-moe's 24 layers are 57
# GB in f32: its first 8; internvl2's 12 are 50 GB: 6), CHECK_BATCH rows.
BF16_DECODE = {"granite-moe-3b-a800m": (12, 32), "qwen2-moe-a2.7b": (4, 24), "mamba2-2.7b": (32, 128),
               "internvl2-76b": (6, 8)}
BF16_BLIND_LOGITS = ("seamless-m4t-medium",)
CHECK_LAYERS, CHECK_BATCH = {"qwen2-moe-a2.7b": 8, "internvl2-76b": 6}, 2
# f32 decode vs prefill: logits and cache within 1e-3 of max|value|.  The
# two paths sum in other orders (mamba2: a 4096-step recurrence against
# 32 chunked scans, through 64 layers; states stored in f32): on the host
# they differ by 1e-6 (16 layers, 1024 tokens) and by 3e-8 with all but
# the stored states in f64; at mamba2's full size the card read 4.6e-5
# (logits) and up to 2.4e-4 (states), and a wrong step moves them by 1 to
# 3 orders of magnitude more than the bound
F32_RTOL = 1e-3

# Training path: qwen3-1.7b at full width and depth, 4 AdamW steps of
# 8 x 4096 tokens in 2 microbatches of 4 sequences, full remat
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS, TRAIN_REMAT = "qwen3-1.7b", 8, 4096, 2, 4, "full"
# card vs host on the smoke config (f32): loss within 1e-5, each gradient
# leaf within 1e-4 of its max|value| (sums in another order through 2
# layers); dQ/dK/dV kernels vs plain at the trained shape (bf16): within two
# bf16 ulps of max|value| (both compute in f32 and round once); the LSE (f32)
# within 1e-5 of max|value|
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, LSE_TOL = 1e-5, 1e-4, 1e-5


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def count_diff(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    d = (a - b).abs()
    return float(d.max()), float((d > 0).float().mean())


def host_ms(fn, runs: int = 10, warmup: int = 1) -> float:
    """Median host milliseconds of a synchronised ``fn()``, after ``warmup``
    untimed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def time_cuda(fn, iters: int = 20, flush_bytes: int = 128 << 20) -> float:
    """Median device milliseconds of ``fn()``.  The 50 MB L2 is flushed
    before each timed call, so every call reads its inputs from device
    memory; everything is enqueued before one synchronise, so the card never
    waits on the host inside a timed interval (the flush and a ~0.5 ms spin
    after it cover the host's launch time of the next call: the flush alone,
    ~0.04 ms, did not cover a wrapper's checks before a 0.01 ms kernel)."""
    flush = torch.empty(flush_bytes, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


# the tensor-core kernels of each library, the template width they are
# instantiated over and the number of instantiations: the forward DP 64 /
# 128 x with and without the LSE, dQ and dK/dV DP 64 / 128, SSD N 64 / 128,
# fpca one (5 buckets, 15 f_avg terms)
WGMMA_KERNELS = {"flash_attention": (("flash_fwd_wgmma",), "D", 4),
                 "flash_attention_bwd": (("flash_bwd_dq_wgmma", "flash_bwd_dkdv_wgmma"), "D", 4),
                 "ssd_intra_chunk": (("ssd_tc_kernel",), "N", 2),
                 "fpca_conv": (("fpca_tc_kernel",), None, 1)}
# the libraries whose tensor-core kernels must not have their wgmma serialised
NO_SERIALISED_WGMMA = {"ssd_intra_chunk": "ssd_tc_kernel", "fpca_conv": "fpca_tc_kernel"}


def check_wgmma_ptxas(logs: dict[str, str]) -> None:
    """Print ptxas's register and spill lines of the tensor-core kernels;
    fail on a spill, and on a note that ptxas serialised the SSD or fpca
    kernel's wgmma (for want of registers: what 2 blocks an SM at 128
    registers did to the SSD kernel's first tensor-core build).  A library
    missing from ``logs`` was already built (nothing to read)."""
    for lib, (names, dim, count) in WGMMA_KERNELS.items():
        if lib not in logs:
            print(f"ptxas: the {lib} library was cached; no register report")
            continue
        kernel, seen = None, set()
        for line in logs[lib].splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
                kernel = next((k for k in names if k in name), None)
                if kernel and dim:
                    kernel += f"<{dim}=128" if "ILi128E" in name else f"<{dim}=64"
                    kernel += ", lse>" if "Lb1E" in name else ">"
            elif kernel and ("spill" in line or "registers" in line):
                print(f"  ptxas {kernel}: {line.replace('ptxas info    :', '').strip()}")
                if "spill" in line:
                    seen.add(kernel)
                    check(" 0 bytes spill stores, 0 bytes spill loads" in line, f"{kernel} spills: {line.strip()}")
            if lib in NO_SERIALISED_WGMMA and "serialized" in line and NO_SERIALISED_WGMMA[lib] in line:
                check(False, f"ptxas serialised the {lib} tensor-core kernel's wgmma: {line.strip()}")
        check(len(seen) == count,
              f"ptxas reported on {sorted(seen)} in {lib}, expected {count} tensor-core instantiations")


def logit_bound(head: list[dict], d_counts: torch.Tensor, scale: float) -> torch.Tensor:
    """Per-example bound on |Δlogits| of the Dense(relu) -> Dense head from
    count differences ``d_counts`` (relu is 1-Lipschitz, so
    |Δlogits| <= |W2|^T |W1|^T |Δx|)."""
    dx = d_counts.abs().reshape(d_counts.shape[0], -1) * scale
    return (dx @ head[0]["w"].abs()) @ head[1]["w"].abs()


def fpca_bound_ms(M: int, N: int, C: int, T: int, NB: int) -> tuple[float, dict, int, int]:
    """The fpca kernel's bound at M windows of N pixels, C channels, T f_avg
    terms and NB buckets: the largest of its four parts (bytes, six bf16
    tensor-core passes, the gate bank's fp32 and MUFU operations), in ms.
    Returns (bound, parts, bytes moved, dot-product FLOP)."""
    bytes_moved = 4 * (M * N + M * C)
    dot_flops = 2 * 3 * M * C * N * 2        # 2 phases x 3 dot products x M*C*N FMAs
    outs = M * C * 2                         # (window, channel, phase)
    parts = {
        "bytes": bytes_moved / PEAK_BYTES_PER_S * 1e3,
        "tensor": FPCA_PASSES * dot_flops / PEAK_BF16_FLOP_PER_S * 1e3,
        "fp32": (outs * (2 * T + (NB + 1) * FPCA_FLOP_PER_EDGE + NB * FPCA_FLOP_PER_BUCKET) + M * 5 * N)
        / PEAK_FP32_FLOP_PER_S * 1e3,
        "mufu": outs * ((NB + 1) * FPCA_MUFU_PER_EDGE + FPCA_MUFU_EXTRA) / PEAK_MUFU_PER_S * 1e3,
    }
    return max(parts.values()), parts, bytes_moved, dot_flops


def main() -> None:
    t_start = time.perf_counter()
    check(torch.cuda.is_available(), "no CUDA device is available")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    check(torch.get_float32_matmul_precision() == "highest", "fp32 matmuls must stay IEEE")

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s, built {sorted(logs) or 'nothing (cached)'}")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {src}: {line.strip()}")
    check_wgmma_ptxas(logs)

    # ---- 3. fit + 4. compile ----------------------------------------------
    t0 = time.perf_counter()
    bucket_model = fit_bucket_model(device=dev)
    print(f"fit_bucket_model on {name}: {time.perf_counter() - t0:.2f} s")
    prog = fpca_cnn.make_model_program()
    spec = prog.spec
    g = torch.Generator().manual_seed(SEED)
    kernel = torch.randn(prog.frontend.kernel_shape, generator=g) * 0.3
    bn = torch.randint(0, 24, (prog.out_channels,), generator=g).float()
    head = prog.init_head(g, device=dev)
    model = fpca.compile(prog, device=dev, weights=kernel, bn_offset=bn, head_params=head,
                         model=bucket_model)
    check(model.backend.name == "cuda", f"default backend on the card is {model.backend.name}")
    frames = {b: torch.rand((b, spec.image_h, spec.image_w, spec.in_channels), generator=g).to(dev)
              for b in BATCHES}
    bh, bw = -(-spec.eff_h // spec.skip_block), -(-spec.eff_w // spec.skip_block)
    rng = np.random.default_rng(SEED)
    sparse = np.zeros(bh * bw, bool)
    sparse[rng.choice(bh * bw, size=round(0.1 * bh * bw), replace=False)] = True
    sparse = sparse.reshape(bh, bw)
    requests = [(f"dense b={b}", frames[b], None) for b in BATCHES]
    requests += [("10% blocks b=64", frames[64], sparse),
                 ("all skipped b=64", frames[64], np.zeros((bh, bw), bool))]

    # ---- 5. the main path, with the launch counts ---------------------------
    served = {}

    def check_out(label, x, logits):
        served[label] = logits
        check(tuple(logits.shape) == (x.shape[0], prog.n_classes), f"{label}: logits {tuple(logits.shape)}")
        check(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")

    launches, designs, latency = serve_requests("fpca_cnn", model, requests, check_out)
    print(f"fpca_cnn stats {model.stats.as_dict()}")

    # ---- 6a. kernel vs plain version at the path's full shape ----------------
    w_pos, w_neg = encode_weights(kernel.to(dev), spec, prog.frontend.enc)
    tables = conv_tables(bucket_model, prog.frontend.adc, spec.n_active_pixels, dev)
    planes = weight_planes(w_pos.T, w_neg.T, tables)
    patches = extract_windows(frames[256], spec).reshape(-1, spec.n_active_pixels).contiguous()
    bn_dev = bn.to(dev)
    check(fpca_kernel.design(patches, tables, prog.out_channels) == "wgmma",
          "the served patch matrix must take the fpca tensor-core design")
    got = fpca_conv_cuda(patches, planes, tables, bn_dev)
    want = fpca_conv_basis(patches, planes, tables, bn_dev)
    got_s = simt_fpca(patches, planes, tables, bn_dev)
    torch.cuda.synchronize()
    max_err, flips = count_diff(got, want)
    err_s, flips_s = count_diff(got_s, want)
    print(f"fpca_conv kernel (tensor-core design) vs plain at M={patches.shape[0]}: max|Δcount| {max_err}, "
          f"flip share {flips:.3e}; the SIMT design there: max|Δcount| {err_s}, flip share {flips_s:.3e} "
          f"(limit: <= {COUNT_TOL} on < {FLIP_TOL} of counts)")
    check(max_err <= COUNT_TOL and flips < FLIP_TOL, "fpca_conv kernel disagrees with its plain version")
    check(err_s <= COUNT_TOL and flips_s < FLIP_TOL, "the fpca_conv kernel's SIMT design disagrees with its plain version")
    valid = (torch.arange(patches.shape[0], device=dev) % 3 != 0).float()
    got_v = fpca_conv_cuda(patches, planes, tables, bn_dev, row_valid=valid)
    check(bool((got_v[valid == 0] == 0).all()) and torch.equal(got_v[valid == 1], got[valid == 1]),
          "row_valid must zero padding rows and leave real rows bit-identical")

    # ---- 6b. served outputs vs the dense oracle and the in-port invariants ---
    ref = fpca.compile(prog, backend="reference", device=dev, weights=kernel, bn_offset=bn,
                       head_params=head, model=bucket_model)
    small = frames[64][:2]
    c_cuda = model.run_frontend_weighted(model.kernel, model.bn_offset, small)
    c_ref = ref.run_frontend_weighted(ref.kernel, ref.bn_offset, small)
    err_ref, flips_ref = count_diff(c_cuda, c_ref)
    print(f"served counts vs dense oracle (2 frames): max|Δcount| {err_ref}, flips {flips_ref:.2e}")
    check(err_ref <= COUNT_TOL and flips_ref < FLIP_TOL, "served counts disagree with the oracle")
    l_cuda, l_ref = model.run(small), ref.run(small)
    bound = logit_bound(head, c_cuda - c_ref, prog.input_scale) + 1e-4 * l_ref.abs() + 1e-4
    print(f"served logits vs oracle: max|Δlogit| {float((l_cuda - l_ref).abs().max()):.3e}")
    check(bool(((l_cuda - l_ref).abs() <= bound).all()), "logits differ by more than the count bound")
    label, x, mask = requests[3]
    logits = served[label]
    keep = torch.as_tensor(active_window_mask(spec, mask), device=dev)
    dense = model.run_frontend_weighted(model.kernel, model.bn_offset, x)
    compact = model.run_frontend_weighted(model.kernel, model.bn_offset, x,
                                          np.broadcast_to(keep.cpu().numpy(), dense.shape[:3]))
    check(torch.equal(compact, dense * keep[None, :, :, None]),
          "region-skip compacted counts must equal masked dense counts bit for bit")
    check(torch.equal(logits, model.head_logits(compact)), "masked logits must be head(compacted counts)")
    print(f"region skip: {int(keep.sum())}/{keep.numel()} windows kept per frame, compact == masked dense")

    # ---- 7. timings and bound ------------------------------------------------
    by_rows = {}
    for b in BATCHES:   # the tensor-core design (the wrapper) beside the SIMT one, in turns
        p = patches if b == 256 else extract_windows(frames[b], spec).reshape(-1, spec.n_active_pixels).contiguous()
        tc_ms = time_cuda(lambda: fpca_conv_cuda(p, planes, tables, bn_dev))
        simt_ms = time_cuda(lambda: simt_fpca(p, planes, tables, bn_dev))
        tc_ms2 = time_cuda(lambda: fpca_conv_cuda(p, planes, tables, bn_dev))
        by_rows[p.shape[0]] = {"ms": statistics.median([tc_ms, tc_ms2]), "simt_ms": simt_ms}
        print(f"fpca_conv at M={p.shape[0]} (batch {b}) on {smi}: tensor-core design {tc_ms:.4f} / {tc_ms2:.4f} ms, "
              f"SIMT design {simt_ms:.4f} ms")
    ms, simt_ms = by_rows[patches.shape[0]]["ms"], by_rows[patches.shape[0]]["simt_ms"]
    plain_ms = time_cuda(lambda: fpca_conv_basis(patches, planes, tables, bn_dev))
    M, N = patches.shape
    C, T, NB = prog.out_channels, planes["aw"].shape[1], bucket_model.n_buckets
    fpca_bound, parts, bytes_moved, dot_flops = fpca_bound_ms(M, N, C, T, NB)
    old_bound = max(parts["bytes"], dot_flops / PEAK_FP32_FLOP_PER_S * 1e3)
    print(f"fpca_conv at M={M}, N={N}, C={C} on {smi}: kernel {ms:.4f} ms (tensor-core design), SIMT design "
          f"{simt_ms:.4f} ms, plain {plain_ms:.4f} ms; bound {fpca_bound:.4f} ms, the largest of bytes "
          f"{bytes_moved / 1e6:.1f} MB {parts['bytes']:.4f}, {FPCA_PASSES} bf16 passes of {dot_flops:.3e} FLOP "
          f"{parts['tensor']:.4f}, gate-bank fp32 {parts['fp32']:.4f}, MUFU {parts['mufu']:.4f} (the dots as fp32 "
          f"FMAs alone, the bound stated for the SIMT design: {old_bound:.4f}); achieved {bytes_moved / ms / 1e6:.1f} GB/s, "
          f"{100 * fpca_bound / ms:.1f}% of the bound")

    for b in (1, 256):
        device_ms, rows = profile_request(model, frames[b])
        print(f"profile dense b={b}: device time {device_ms:.4f} ms per run, busy "
              f"{device_ms / latency[f'dense b={b}']:.1%} of the median request")
        for row in rows:
            print(f"  {row}")

    fpca_entry = {
        "name": "fpca_conv",
        "route": "cuda",
        "source": "src/repro_torch/csrc/fpca_conv.cu",
        "replaces": "src/repro/kernels/fpca_conv/kernel.py:90",
        "launches": launches,
        "designs": designs,
        "max_abs_err": max_err,
        "flip_share": flips,
        "ms": ms,
        "simt_ms": simt_ms,
        "plain_ms": plain_ms,
        "bound_ms": fpca_bound,
        "bound_by": "bytes" if parts["bytes"] >= fpca_bound else "operations",
        "bound_parts_ms": parts,
        "old_bound_ms": old_bound,
        "gb_per_s": bytes_moved / ms / 1e6,
        "ms_by_rows": by_rows,
        # no single PyTorch call computes the bucket-gated basis bank
        "library_ms": None,
    }
    by_path = {"fpca_cnn": launches}
    by_path.update(zoo_phase(dev, smi, bucket_model, requests))
    by_path.update(int8_phase(dev, smi, bucket_model, requests))
    streaming = stream_phase(dev, smi, bucket_model)
    by_path.update(streaming.pop("launches"))
    fpca_entry["streaming"] = streaming
    t_serving = time.perf_counter()
    step = Laps()
    models = {spec.n_active_pixels: bucket_model, 27: fit_bucket_model(n_pixels=27, device=dev)}
    step("N = 27 bucket model")
    serving = {"pipeline": pipeline_phase(dev, smi, models)}
    step("pipeline")
    cams = camera_frames(2 * FLEET_TICKS)
    step("camera frames")
    serving["server"] = server_phase(dev, smi, models, cams)
    step("server")
    serving["stacked_launch"] = stacked_launch_check(dev, smi, bucket_model, cams)
    step("stacked launch")
    serving["fleet"] = fleet_phase(dev, smi, models, cams)
    step("fleet")
    for part in ("pipeline", "server", "fleet"):
        by_path.update(serving[part].pop("launches"))
    fpca_entry["launches"] = sum(by_path.values())
    fpca_entry["launches_by_path"] = by_path
    fpca_entry["serving"] = serving
    del cams
    serving["seconds_by_step"] = step.report("multi-camera serving")
    print(f"multi-camera serving phases: {time.perf_counter() - t_serving:.1f} s (target: about 60 s more than "
          "the script without them)")
    fpca_entry["fpca_train"] = fpca_train_phase(dev, smi, bucket_model)
    by_path.update(fpca_entry["fpca_train"].pop("launches"))
    twins = twins_phase(dev, export=fpca_entry["fpca_train"].pop("export_bundle"))
    by_path["example twins"] = sum(t["fpca_launches"] for t in twins)
    fpca_entry["launches"] = sum(by_path.values())
    fpca_entry["example_twins"] = twins
    gc.collect()
    torch.cuda.empty_cache()
    flash_entry, ssd_entry = lm_phase(dev, smi)
    flash_by_path = {f"{LM_ARCH} serving": flash_entry["launches"],
                     "example twins": sum(t["flash_launches"] for t in twins)}
    flash_entry["served_dense"] = {}
    for arch, (requests, batch, prompt, tokens) in DENSE_SERVING.items():
        gc.collect()
        torch.cuda.empty_cache()
        flash_entry["served_dense"][arch] = dense_phase(dev, smi, arch, requests, batch, prompt, tokens)
        flash_by_path[f"{arch} serving"] = flash_entry["served_dense"][arch].pop("launches")
    flash_entry["launches"] = sum(flash_by_path.values())
    flash_entry["launches_by_path"] = flash_by_path
    gc.collect()
    torch.cuda.empty_cache()
    bwd_entries, flash_entry["trained"] = train_phase(dev, smi)
    t_families = time.perf_counter()
    families = {}
    for arch in FAMILY_SERVING:
        gc.collect()
        torch.cuda.empty_cache()
        families[f"{arch} serving"] = family_serving_phase(dev, smi, arch)
    for arch in FAMILY_TRAINING:
        gc.collect()
        torch.cuda.empty_cache()
        families[f"{arch} training"] = family_train_phase(dev, smi, arch)
    checks = {f"narrow {arch} training": narrow_train_vs_host(dev, arch) for arch in NARROW_TRAINING}
    checks["ssd function"] = ssd_function_vs_host(dev)
    print(f"remaining-families phases: {time.perf_counter() - t_families:.1f} s (target: about 150 s)")
    fold_families(flash_entry, ssd_entry, bwd_entries, families, checks)
    kernels = [fpca_entry, flash_entry, ssd_entry] + bwd_entries
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


def fold_families(flash_entry: dict, ssd_entry: dict, bwd_entries: list, families: dict, checks: dict) -> None:
    """Add the remaining families' paths to the kernels' entries: each
    path's launches under ``launches_by_path`` (the sums under
    ``launches``), the kernels' numbers at each new shape under
    ``new_shapes``, and the card-vs-host checks under ``checks``."""
    dq_entry, dkdv_entry = bwd_entries
    flash_by = flash_entry["launches_by_path"]
    flash_by["qwen3-1.7b training"] = flash_entry["trained"]["launches"]
    ssd_by = {f"{LM_ARCH} serving": ssd_entry["launches"]}
    dq_by, dkdv_by = ({"qwen3-1.7b training": e["launches"]} for e in bwd_entries)
    for entry in (flash_entry, ssd_entry, dq_entry, dkdv_entry):
        entry["new_shapes"] = {}
    for path, r in families.items():
        if path.endswith("serving"):
            flash_by[path] = r["launches"]["flash_attention"]
            ssd_by[path] = r["launches"]["ssd_intra_chunk"]
        else:
            flash_by[path], dq_by[path], dkdv_by[path], ssd_by[path] = (
                r["launches"][k] for k in ("flash_fwd", "dq", "dkdv", "ssd"))
        for kind, shape in r["shapes"].items():
            if kind == "ssd":
                ssd_entry["new_shapes"][path] = shape
            elif kind.startswith("bwd"):
                dq_entry["new_shapes"][f"{path} {kind}"] = {**shape["dq"], "shape": shape["shape"],
                                                            "causal": shape["causal"], "plain_ms": shape["plain_ms"],
                                                            "library_ms": shape["library_ms"]}
                dkdv_entry["new_shapes"][f"{path} {kind}"] = {**shape["dkdv"], "shape": shape["shape"],
                                                              "causal": shape["causal"], "plain_ms": shape["plain_ms"],
                                                              "library_ms": shape["library_ms"]}
            else:
                flash_entry["new_shapes"][f"{path} {kind}"] = shape
    for entry, by in ((flash_entry, flash_by), (ssd_entry, ssd_by), (dq_entry, dq_by), (dkdv_entry, dkdv_by)):
        entry["launches_by_path"] = {k: v for k, v in by.items() if v}
        entry["launches"] = sum(by.values())
    flash_entry["families"] = {p: {k: v for k, v in r.items() if k not in ("shapes", "launches")}
                               for p, r in families.items()}
    flash_entry["checks"] = checks


def profile_request(model, x: torch.Tensor) -> tuple[float, list[str]]:
    """Device milliseconds of one ``run`` and its split by kernel name
    (torch.profiler over 5 runs), top 8."""
    return profile_device(lambda: model.run(x), runs=5)


class DeviceOp(NamedTuple):
    """One device-side op name in a profile: its launches and its summed
    device time in microseconds (as ``key_averages()`` reports them)."""

    key: str
    count: int
    device_time_total: float


def device_events(fn, runs: int) -> list[DeviceOp]:
    """The device-side events (kernels, memcpy/memset; not the host ops that
    launch them) of ``runs`` calls of ``fn`` under torch.profiler, by name.
    They are summed straight from the profiler's raw events: building its
    Python event tree (``key_averages()``) takes tens of seconds over the
    ~10^5 kernels of a few hundred replayed segment ticks."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    by_name: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA") and not getattr(e, "is_hidden_event", lambda: False)():
            agg = by_name.setdefault(e.name(), [0, 0])
            agg[0] += 1
            agg[1] += e.duration_ns()
    return [DeviceOp(k, n, ns / 1e3) for k, (n, ns) in by_name.items() if ns > 0]


def profile_device(fn, runs: int) -> tuple[float, list[str]]:
    """Device milliseconds per call of ``fn`` and its split by kernel name
    (torch.profiler over ``runs`` calls), top 8."""
    events = device_events(fn, runs)
    if not events:
        return float("nan"), ["torch.profiler recorded no device time"]
    events.sort(key=lambda e: e.device_time_total, reverse=True)
    total = sum(e.device_time_total for e in events)
    return total / runs / 1e3, [f"{sum(e.count for e in events) / runs:.0f} device ops per run"] + [
        f"{e.key[:60]:60s} {e.device_time_total / runs / 1e3:.4f} ms/run "
        f"({100 * e.device_time_total / total:.1f}%) x{e.count // runs}" for e in events[:8]
    ]


# ---------------------------------------------------------------------------
# the model zoo (graph heads) and int8 head serving, through the fpca kernel
# ---------------------------------------------------------------------------


def _reset_fpca_counts() -> None:
    fpca_conv_cuda.launches = 0
    fpca_conv_cuda.designs = dict.fromkeys(fpca_conv_cuda.designs, 0)


def _raw(out) -> torch.Tensor:
    """A run's raw head output: the logits, or a detection map re-joined."""
    return torch.cat([out.scores, out.boxes], -1) if isinstance(out, fpca.Detections) else out


def serve_requests(label: str, model, requests: list, check_out) -> tuple[int, dict, dict]:
    """Serve ``requests`` once to warm up, then once with the fpca counts set
    to 0 just before and read just after; ``check_out(req, x, out)`` checks
    each output.  Returns the launches, the launches by design and the request
    latencies (host clock, median of 10)."""
    for _, x, mask in requests:              # warm-up: first-call costs out of the timing
        model.run(x, block_mask=mask)
    torch.cuda.synchronize()
    _reset_fpca_counts()
    for req, x, mask in requests:
        before = fpca_conv_cuda.launches
        t0 = time.perf_counter()
        out = model.run(x, block_mask=mask)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launched = fpca_conv_cuda.launches - before
        skipped = mask is not None and not mask.any()
        check(launched == (0 if skipped else 1), f"{label} {req}: {launched} fpca_conv launches")
        check_out(req, x, out)
        print(f"request {label} {req}: {ms:.3f} ms host clock, fpca_conv launches {launched}")
    launches, designs = fpca_conv_cuda.launches, dict(fpca_conv_cuda.designs)
    check(launches >= 1, f"{label}: the path never launched fpca_conv_cuda")
    check(designs["wgmma"] == launches, f"{label}: fpca launches by design {designs}, every one must take the "
          "tensor-core design")
    print(f"{label}: {len(requests)} requests, fpca_conv_cuda launches {launches} by design {designs}")
    latency = {}
    for req, x, mask in requests:
        latency[req] = host_ms(lambda: model.run(x, block_mask=mask), warmup=0)
        print(f"latency {label} {req}: median {latency[req]:.3f} ms ({x.shape[0] / latency[req] * 1e3:.1f} frames/s)")
    return launches, designs, latency


def zoo_phase(dev: torch.device, smi: str, bucket_model, requests: list) -> dict:
    """Serve fpca_resnet and fpca_detect at the zoo's defaults (full width:
    120x120x3 frames, 8 frontend channels) on the default backend; check
    shapes, launches and designs, run == head(frontend) bit for bit, counts
    against the dense oracle, compact == masked dense, and a head rewrite
    that builds nothing; time each request and profile one at batch 256."""
    launches = {}
    for i, arch in enumerate(ZOO_ARCHS):
        prog = fpca.build_model({"arch": arch})
        check(prog.arch == arch and prog.spec == fpca_cnn.FRONTEND_SPEC, f"{arch}: not the zoo's full-width default")
        g = torch.Generator().manual_seed(SEED + 1 + i)
        kernel = torch.randn(prog.frontend.kernel_shape, generator=g) * 0.3
        bn = torch.randint(0, 24, (prog.out_channels,), generator=g).float()
        head = prog.init_head(g, device=dev)
        model = fpca.compile(prog, device=dev, weights=kernel, bn_offset=bn, head_params=head, model=bucket_model)
        check(model.backend.name == "cuda", f"{arch}: default backend on the card is {model.backend.name}")

        def check_out(req, x, out, arch=arch, prog=prog):
            b = x.shape[0]
            if arch == "fpca_detect":
                check(isinstance(out, fpca.Detections), f"{arch} {req}: run returned {type(out).__name__}")
                check(tuple(out.scores.shape) == (b, 24, 24, 2) and tuple(out.boxes.shape) == (b, 24, 24, 4),
                      f"{arch} {req}: scores {tuple(out.scores.shape)}, boxes {tuple(out.boxes.shape)}")
            else:
                check(tuple(out.shape) == (b, prog.n_classes), f"{arch} {req}: logits {tuple(out.shape)}")
            check(bool(torch.isfinite(_raw(out)).all()), f"{arch} {req}: non-finite output")

        n, designs, latency = serve_requests(arch, model, requests, check_out)
        launches[arch] = n
        # run == head(frontend), dense and masked, bit for bit
        _, x, mask = requests[3]
        keep = np.broadcast_to(active_window_mask(prog.spec, mask), (x.shape[0],) + prog.frontend.out_shape[:2])
        for what, wk, bm in (("dense", None, None), ("10% blocks", keep, mask)):
            counts = model.run_frontend_weighted(model.kernel, model.bn_offset, x, wk)
            check(torch.equal(_raw(model.run(x, block_mask=bm)), model.head_logits(counts)),
                  f"{arch} {what}: run differs from head(frontend counts)")
        dense = model.run_frontend_weighted(model.kernel, model.bn_offset, x)
        compact = model.run_frontend_weighted(model.kernel, model.bn_offset, x, keep)
        check(torch.equal(compact, dense * torch.as_tensor(keep.copy(), device=dev)[..., None]),
              f"{arch}: compacted counts differ from masked dense")
        ref = fpca.compile(prog, backend="reference", device=dev, weights=kernel, bn_offset=bn, head_params=head,
                           model=bucket_model)
        err, flips = count_diff(dense[:2], ref.run_frontend_weighted(ref.kernel, ref.bn_offset, x[:2]))
        print(f"{arch}: served counts vs dense oracle (2 frames): max|Δcount| {err}, flips {flips:.2e}; "
              "run == head(frontend) and compact == masked dense, bit for bit")
        check(err <= COUNT_TOL and flips < FLIP_TOL, f"{arch}: served counts disagree with the oracle")
        misses = model.cache_info().misses
        model.reprogram(head_params=prog.init_head(g, device=dev))
        for _, x, mask in requests:
            model.run(x, block_mask=mask)
        check(model.cache_info().misses == misses, f"{arch}: reprogram(head_params=...) built an executable")
        device_ms, rows = profile_request(model, requests[2][1])
        print(f"profile {arch} dense b=256 on {smi}: device time {device_ms:.4f} ms per run, busy "
              f"{device_ms / latency['dense b=256']:.1%} of the median request")
        for row in rows:
            print(f"  {row}")
    return launches


def _stage_inputs(prog, qp: dict | list, counts: torch.Tensor) -> list:
    """(op, stage parameters, stage input) of every quantised stage of one
    int8 forward pass on ``counts``."""
    from repro_torch.fpca.program import _evaluate_chain
    from repro_torch.models import heads, quant

    seen = []
    x = counts.float() * float(prog.input_scale)
    if prog.is_graph_head:
        by_name = {n.name: n.op for n in prog.head.nodes}
        heads.evaluate(prog.head, x, conv=quant.conv2d_int8, linear=quant.linear_int8, params=qp,
                       on_stage=lambda name, v: seen.append((by_name[name], qp[name], v)))
    else:
        _evaluate_chain(prog.head, x, conv=quant.conv2d_int8, linear=quant.linear_int8, params=qp,
                        on_stage=lambda i, v: seen.append((prog.head[i], qp[i], v)))
    return seen


def _stage_acc(op, p: dict, x: torch.Tensor) -> torch.Tensor:
    from repro_torch.models import quant

    if p["w_q"].ndim == 4:
        stride, padding = (1, "SAME") if isinstance(op, fpca.DetectSpec) else (op.stride, op.padding)
        return quant.conv2d_int8_acc(p, x, stride, padding)
    return quant.linear_int8_acc(p, x)


def int8_phase(dev: torch.device, smi: str, bucket_model, requests: list) -> dict:
    """Serve fpca_cnn and fpca_resnet with precision="int8" on the default
    backend, head calibrated on the counts of the batch-64 frames; check
    launches and designs, every quantised stage's int32 accumulators on the
    card against the host's on the same inputs, the int8 logits against the
    host's, and print the int8-vs-f32 parity; time each request and
    profile one at batch 256."""
    from repro_torch.kernels.fpca_conv.ops import make_fpca_conv_executable
    from repro_torch.models import quant

    try:
        make_fpca_conv_executable(bucket_model, spec=fpca_cnn.FRONTEND_SPEC, impl="cuda", transfer="int8", device=dev)
        check(False, "a cuda executable took transfer='int8'")
    except ValueError as e:
        check("only lowered by the basis impl" in str(e), f"unexpected refusal: {e}")
    launches = {}
    for i, arch in enumerate(INT8_ARCHS):
        label = f"{arch} int8"
        prog = fpca.build_model({"arch": arch}).replace(precision="int8")
        f32 = prog.replace(precision="f32")
        g = torch.Generator().manual_seed(SEED + 11 + i)
        kernel = torch.randn(prog.frontend.kernel_shape, generator=g) * 0.3
        bn = torch.randint(0, 24, (prog.out_channels,), generator=g).float()
        head32 = f32.init_head(g, device=dev)
        model = fpca.compile(prog, device=dev, weights=kernel, bn_offset=bn, model=bucket_model)
        check(model.backend.name == "cuda" and model._frontend_transfer() == "f32",
              f"{label}: backend {model.backend.name}, transfer {model._frontend_transfer()}")
        x64 = requests[1][1]
        counts = model.run_frontend_weighted(model.kernel, model.bn_offset, x64)
        qp = quant.quantize_head_params(prog, head32, sample_counts=counts)
        model.reprogram(head_params=qp)

        def check_out(req, x, out, label=label, prog=prog):
            check(tuple(out.shape) == (x.shape[0], prog.n_classes), f"{label} {req}: logits {tuple(out.shape)}")
            check(bool(torch.isfinite(out).all()), f"{label} {req}: non-finite logits")

        launches[label], _, latency = serve_requests(label, model, requests, check_out)
        device_ms, rows = profile_request(model, requests[2][1])
        print(f"profile {label} dense b=256 on {smi}: device time {device_ms:.4f} ms per run, busy "
              f"{device_ms / latency['dense b=256']:.1%} of the median request")
        for row in rows:
            print(f"  {row}")
        # int32 accumulators, card vs host, on the same requantised inputs
        stages = _stage_inputs(prog, model.head_params, counts)
        for j, (op, p, v) in enumerate(stages):
            acc = _stage_acc(op, p, v)
            host = _stage_acc(op, {k: t.cpu() for k, t in p.items()}, v.cpu())
            check(acc.dtype == torch.int32 and torch.equal(acc.cpu(), host),
                  f"{label} stage {j} ({type(op).__name__}): int32 accumulators differ card vs host")
        print(f"{label}: {len(stages)} quantised stages, int32 accumulators on the card equal the host's bit for "
              f"bit (batch-64 counts; {[tuple(_stage_acc(op, p, v).shape) for op, p, v in stages]})")
        logits = model.head_logits(counts)
        host = prog.apply_head(quant.bind_quant_head_params(prog, model.head_params, device="cpu"), counts.cpu())
        d = float((logits.cpu() - host).abs().max())
        top = float(host.abs().max())
        print(f"{label}: int8 logits card vs host from the same counts and quantised parameters: max|Δ| {d:.3e} "
              f"(max|logit| {top:.3e}; limit {INT8_LOGIT_RTOL:g} of it)")
        check(d <= INT8_LOGIT_RTOL * top, f"{label}: int8 logits on the card disagree with the host")
        m32 = fpca.compile(f32, device=dev, weights=kernel, bn_offset=bn, head_params=head32, model=bucket_model)
        par = quant.logit_parity(m32.run(x64), model.run(x64))
        print(f"{label} vs f32 on {smi}, batch 64 (reported only): max divergence {par['max_abs_divergence']:.4f}, "
              f"top-1 agreement {par['top1_agreement']:.4f}")
    return launches


# ---------------------------------------------------------------------------
# streaming: per-tick stream() and K-tick segments replayed as CUDA graphs
# ---------------------------------------------------------------------------


def fpca_kernel_launches(events: list) -> dict:
    """Launches of the fpca kernel's two designs among profiler events."""
    return {"wgmma": sum(e.count for e in events if "fpca_tc_kernel" in e.key),
            "simt": sum(e.count for e in events if "fpca_conv_kernel" in e.key)}


def _chained(model, frames: np.ndarray, **kw) -> list:
    """STREAM_SEGMENTS segments of STREAM_K ticks, state (and with it the
    suggested bucket) threaded from one to the next."""
    segs, state = [], None
    for s in range(STREAM_SEGMENTS):
        seg = model.run_segment(frames[s * STREAM_K:(s + 1) * STREAM_K], state=state, **kw)
        segs.append(seg)
        state = seg.state
    return segs


def _same_tick(seg, t: int, r, what: str) -> None:
    """One segment tick against the per-tick loop's, bit for bit."""
    check(bool((seg.counts[t].cpu().numpy() == r.counts).all()), f"{what}: counts differ from stream()")
    check(r.block_mask is None or bool((seg.block_masks[t] == r.block_mask).all()),
          f"{what}: block mask differs from stream()")
    check(int(seg.kept_windows[t]) == r.kept_windows, f"{what}: kept windows differ from stream()")
    if r.detections is not None:
        det = seg.detections()[t]
        check(bool((det.scores == r.detections.scores).all() and (det.boxes == r.detections.boxes).all()),
              f"{what}: detections differ from stream()")
    elif r.logits is not None:
        check(bool((seg.logits[t].cpu().numpy() == r.logits).all()), f"{what}: logits differ from stream()")


def stream_phase(dev: torch.device, smi: str, bucket_model) -> dict:
    """Serve the moving-object video (120x120x3, seed SEED, speed 0.17) at
    full width through fpca_cnn and fpca_detect under the default gate
    (threshold 0.02, hysteresis 1, keyframe every 30): per tick through
    ``stream()``, and as four chained ``run_segment`` calls of 32 ticks,
    each replayed as one CUDA graph.  Checks segments == stream() bit for
    bit (counts, masks, kept windows, logits or detections), an early-exit
    segment on a static scene stopping where the per-tick loop goes quiet,
    and for fpca_cnn a dense segment, the basis backend within the fpca
    limit, and a reprogram between segments that captures nothing; prints
    per-tick times, capture time, device time and busy share of a replay,
    its fpca launches by design, and the kernel's time at M = 576 with the
    device row counts of STREAM_N_ROWS."""
    from repro_torch.fpca.backends import _CapturedSegment

    check(not torch.backends.cudnn.benchmark, "cuDNN benchmark mode must be off (it picks algorithms per run)")
    n = STREAM_K * STREAM_SEGMENTS
    video = SyntheticMovingObject((120, 120), seed=SEED, speed=0.17)
    moving = np.stack([video.frame_at(t) for t in range(n)])
    frames = np.concatenate([moving, np.repeat(moving[-1:], STREAM_K, axis=0)])   # then a static scene
    out: dict = {"launches": {}, "by_arch": {}}
    for i, arch in enumerate(STREAM_ARCHS):
        prog = fpca.build_model({"arch": arch, "frontend": {"gate": fpca.DeltaGateConfig()}})
        check(prog.spec == fpca_cnn.FRONTEND_SPEC and prog.frontend.gate == fpca.DeltaGateConfig(),
              f"{arch}: not the full-width program under the default gate")
        g = torch.Generator().manual_seed(SEED + 21 + i)
        kernel = torch.randn(prog.frontend.kernel_shape, generator=g) * 0.3
        bn = torch.randint(0, 24, (prog.out_channels,), generator=g).float()
        head = prog.init_head(g, device=dev)
        model = fpca.compile(prog, device=dev, weights=kernel, bn_offset=bn, head_params=head,
                             model=bucket_model, cache_capacity=64)
        label = f"{arch} stream"

        # -- the per-tick loop, launches counted by the wrapper -----------------
        _reset_fpca_counts()
        ticks, tick_ms = [], []
        t0 = time.perf_counter()
        for r in model.stream(frames, controller=None, depth=1):   # realised per tick: counts come to the host
            t1 = time.perf_counter()
            tick_ms.append((t1 - t0) * 1e3)
            t0 = t1
            ticks.append(r)
        launched, designs = fpca_conv_cuda.launches, dict(fpca_conv_cuda.designs)
        kept = np.array([r.kept_windows for r in ticks])
        check(launched == int((kept > 0).sum()) and designs["wgmma"] == launched,
              f"{label}: {launched} fpca launches by design {designs} for {int((kept > 0).sum())} ticks that keep windows")
        out["launches"][label] = launched

        # -- segments: the first pass captures, the second replays ----------------
        t0 = time.perf_counter()
        segs = _chained(model, frames)
        torch.cuda.synchronize()
        first_pass_ms = (time.perf_counter() - t0) * 1e3
        graphs = [model._cache._entries[k].__wrapped__ for k in model.cache_info(verbose=True).resident
                  if "segment" in k]
        check(graphs and all(isinstance(gr, _CapturedSegment) and gr.capture_ms is not None for gr in graphs),
              f"{arch}: segments on the card must be captured CUDA graphs")
        capture_ms = [gr.capture_ms for gr in graphs]
        misses = model.cache_info().misses
        _reset_fpca_counts()
        holder: dict = {}
        events = device_events(lambda: holder.setdefault("segs", _chained(model, frames)), runs=1)
        check(model.cache_info().misses == misses, f"{arch}: the second pass captured a new graph")
        check(fpca_conv_cuda.launches == 0, f"{arch}: a replay went through the wrapper")
        replay = fpca_kernel_launches(events)
        check(replay == {"wgmma": n, "simt": 0},
              f"{arch}: {replay} fpca kernels in {STREAM_SEGMENTS} replays, expected one tensor-core launch a tick ({n})")
        out["launches"][f"{arch} segment replays"] = replay["wgmma"]
        for a, b in zip(segs, holder["segs"]):
            check(torch.equal(a.counts, b.counts) and torch.equal(a.logits, b.logits), f"{arch}: replays differ")
        for s, seg in enumerate(segs):
            for t in range(STREAM_K):
                _same_tick(seg, t, ticks[s * STREAM_K + t], f"{arch} segment {s} tick {t}")
        walked = sum(int(seg.kept_windows[:seg.ticks].sum()) for seg in segs)
        billed = sum(int(seg.rows_executed.sum()) for seg in segs)
        buckets = [seg.state.suggested_bucket for seg in segs]
        print(f"{arch}: {n} ticks, {STREAM_SEGMENTS} segments == stream() bit for bit (counts, masks, "
              f"{'detections' if arch == 'fpca_detect' else 'logits'}); kept windows per tick min "
              f"{int(kept[:n].min())} median {float(np.median(kept[:n])):.0f} max {int(kept[:n].max())} of 576; "
              f"suggested buckets {buckets}; rows the kernel walked {walked} (device n_keep), rows the "
              f"reference's branches bill {billed} (rows_executed)")

        # -- early exit on the static scene ---------------------------------------
        rest = kept[n:]
        quiet = next((t + 1 for t in range(STREAM_EARLY_EXIT - 1, len(rest))
                      if not rest[t - STREAM_EARLY_EXIT + 1:t + 1].any()), STREAM_K)
        ee = model.run_segment(frames[n:], state=segs[-1].state, early_exit=STREAM_EARLY_EXIT)
        check(ee.ticks == quiet, f"{arch}: early exit after {ee.ticks} ticks, the per-tick loop goes quiet after {quiet}")
        for t in range(ee.ticks):
            _same_tick(ee, t, ticks[n + t], f"{arch} early-exit tick {t}")
        check(torch.equal(ee.counts[ee.ticks:], torch.zeros_like(ee.counts[ee.ticks:])),
              f"{arch}: ticks after the early exit must be zeros")
        print(f"{arch}: early exit (patience {STREAM_EARLY_EXIT}) on the static scene stopped after {ee.ticks} "
              f"ticks, where the per-tick loop goes quiet; its ticks are a bit-identical prefix")

        # -- times: stream() per tick, segment replay per tick, device share --------
        first = frames[:STREAM_K]
        model.run_segment(first)   # the first segment's graph (fresh state, bucket M) is captured
        replay_ms = host_ms(lambda: model.run_segment(first), warmup=0)
        events = device_events(lambda: model.run_segment(first), runs=1)
        device_ms = sum(e.device_time_total for e in events) / 1e3
        per_tick = statistics.median(tick_ms[1:n])
        res = {
            "stream_ms_per_tick": per_tick,
            "segment_ms_per_tick": replay_ms / STREAM_K,
            "capture_ms": capture_ms,
            "first_pass_ms": first_pass_ms,
            "replay_device_ms_per_tick": device_ms / STREAM_K,
            "replay_busy": device_ms / replay_ms,
            "replay_device_ops": sum(e.count for e in events),
            "fpca_launches_per_replay": replay["wgmma"] / STREAM_SEGMENTS,
            "rows_walked": walked,
            "rows_executed": billed,
            "early_exit_ticks": ee.ticks,
        }
        print(f"{arch} on {smi}: stream() {per_tick:.4f} ms per tick (host clock, median of {n - 1}); segment "
              f"replay {replay_ms / STREAM_K:.4f} ms per tick (median of 10 replays of {STREAM_K} ticks, "
              f"{replay_ms:.3f} ms each); capture {', '.join(f'{c:.1f}' for c in capture_ms)} ms per graph "
              f"(warm-up included); a replay: {device_ms / STREAM_K:.4f} ms device per tick, busy "
              f"{device_ms / replay_ms:.1%}, {res['replay_device_ops']} device ops, fpca launches "
              f"{replay['wgmma'] / STREAM_SEGMENTS:.0f} per replay (fpca_tc_kernel: the tensor-core design)")
        rows = sorted(events, key=lambda e: e.device_time_total, reverse=True)[:6]
        for e in rows:
            print(f"  {e.key[:60]:60s} {e.device_time_total / 1e3:.4f} ms x{e.count}")

        if arch == "fpca_cnn":
            res.update(_stream_cnn_checks(dev, smi, model, prog, kernel, bn, head, bucket_model, frames, segs))
        out["by_arch"][arch] = res
    return out


def _stream_cnn_checks(dev, smi, model, prog, kernel, bn, head, bucket_model, frames, segs) -> dict:
    """fpca_cnn only: a dense segment against dense stream(), the basis
    backend's segments on the card within the fpca limit, a reprogram and
    a threshold change between segments that capture nothing, and the
    kernel's time at M = 576 by device row count."""
    first = frames[:STREAM_K]
    dense = model.run_segment(first, gate=None)
    for t, r in enumerate(model.stream(first, gate=None, controller=None)):
        _same_tick(dense, t, r, f"fpca_cnn dense tick {t}")
    check(not dense.gated and bool((dense.kept_windows == 576).all()), "fpca_cnn: the dense segment is not dense")
    basis = fpca.compile(prog, backend="basis", device=dev, weights=kernel, bn_offset=bn, head_params=head,
                         model=bucket_model, cache_capacity=64)
    bsegs = _chained(basis, frames)
    got = torch.cat([seg.counts for seg in segs])
    want = torch.cat([seg.counts for seg in bsegs])
    err, flips = count_diff(got, want)
    check(all(bool((a.block_masks == b.block_masks).all()) for a, b in zip(segs, bsegs)),
          "fpca_cnn: the basis backend's segments gate differently")
    print(f"fpca_cnn segments, cuda vs basis backend on the card ({got.shape[0]} ticks): max|Δcount| {err}, "
          f"flip share {flips:.3e} (limit: <= {COUNT_TOL} on < {FLIP_TOL} of counts); masks equal")
    check(err <= COUNT_TOL and flips < FLIP_TOL, "fpca_cnn: segments on the cuda and basis backends disagree")
    misses = model.cache_info().misses
    g = torch.Generator().manual_seed(SEED + 31)
    model.reprogram(torch.randn(prog.frontend.kernel_shape, generator=g) * 0.3, head_params=prog.init_head(g, device=dev))
    for s in range(STREAM_SEGMENTS):
        gate = fpca.DeltaGateConfig(threshold=0.02 * (1 + s))   # a servo step between segments: data, not a graph
        model.run_segment(frames[s * STREAM_K:(s + 1) * STREAM_K], state=segs[s - 1].state if s else None,
                          m_bucket=segs[s - 1].state.suggested_bucket if s else None, gate=gate)
    check(model.cache_info().misses == misses, "fpca_cnn: reprogram or a threshold change captured a new graph")
    print(f"fpca_cnn: reprogram and four threshold changes between segments: cache misses {misses} before and after")
    # the kernel at M = 576 by device row count
    spec = prog.spec
    patches = extract_windows(torch.as_tensor(frames[:1], device=dev), spec).reshape(-1, spec.n_active_pixels).contiguous()
    w_pos, w_neg = encode_weights(kernel.to(dev), spec, prog.frontend.enc)
    tables = conv_tables(bucket_model, prog.frontend.adc, spec.n_active_pixels, dev)
    planes = weight_planes(w_pos.T, w_neg.T, tables)
    bn_dev = bn.to(dev)
    full = fpca_conv_cuda(patches, planes, tables, bn_dev)
    by_count = {}
    for n_rows in STREAM_N_ROWS:
        count = torch.tensor([n_rows], dtype=torch.int32, device=dev)
        got = fpca_conv_cuda(patches, planes, tables, bn_dev, n_rows=count)
        check(torch.equal(got[:n_rows], full[:n_rows]) and not bool(got[n_rows:].any()),
              f"fpca_conv with n_rows={n_rows}: rows below the count must equal the full launch, the rest zeros")
        by_count[n_rows] = time_cuda(lambda: fpca_conv_cuda(patches, planes, tables, bn_dev, n_rows=count))
    print(f"fpca_conv at M={patches.shape[0]} on {smi}, by device row count: "
          + ", ".join(f"n_rows={k} {v:.4f} ms" for k, v in by_count.items()))
    return {"n_rows_ms": by_count, "cuda_vs_basis_max_err": err, "cuda_vs_basis_flip_share": flips}


# ---------------------------------------------------------------------------
# multi-camera serving: the batch pipeline, the stream server and the fleet
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def simt_only():
    """Every fpca launch inside takes the SIMT design (the check a stacked
    launch of more than TC_MAX_CHANNELS channels is held to: the two designs
    round differently, so a stacked SIMT launch equals solo launches bit for
    bit only when those take the SIMT design too)."""
    saved = fpca_kernel.TC_MAX_CHANNELS
    fpca_kernel.TC_MAX_CHANNELS = 0
    try:
        yield
    finally:
        fpca_kernel.TC_MAX_CHANNELS = saved


def _weights(prog, seed: int, dev: torch.device) -> tuple:
    """Seeded NVM planes and BN offsets (and head parameters for a model)."""
    model = isinstance(prog, fpca.FPCAModelProgram)
    g = torch.Generator().manual_seed(seed)
    kernel = torch.randn((prog.frontend if model else prog).kernel_shape, generator=g) * 0.3
    bn = torch.randint(0, 24, (prog.out_channels,), generator=g).float()
    return kernel, bn, (prog.init_head(g, device=dev) if model else None)


def pipeline_configs(dev: torch.device) -> list[tuple]:
    """The registered configurations: (name, program, kernel, bn, head)."""
    from repro_torch.core.mapping import FPCASpec

    overlap = FPCASpec(image_h=120, image_w=120, out_channels=8, kernel=3, stride=2, max_kernel=3)
    binned = FPCASpec(image_h=120, image_w=120, out_channels=8, kernel=5, stride=5, binning=2)
    out = []
    for i, (name, spec) in enumerate((("dense_5x5", fpca_cnn.FRONTEND_SPEC), ("dense_5x5_b", fpca_cnn.FRONTEND_SPEC),
                                      ("overlap_3x3", overlap), ("binned_lowpower", binned))):
        prog = fpca.FPCAProgram(spec=spec)
        out.append((name, prog) + _weights(prog, SEED + 40 + i, dev))
    for i, arch in enumerate(("fpca_cnn", "fpca_detect")):
        prog = fpca.build_model({"arch": arch})
        out.append((arch, prog) + _weights(prog, SEED + 50 + i, dev))
    return out


def make_pipeline(dev: torch.device, models: dict, configs: list, **kw):
    from repro_torch.serving import FPCAPipeline

    pipe = FPCAPipeline(models, device=dev, cache_capacity=64, **kw)
    for name, prog, kernel, bn, head in configs:
        pipe.register(name, prog, kernel, bn, head_params=head)
    check(pipe.backend == "cuda", f"the pipeline's default backend on the card is {pipe.backend}")
    return pipe


def _host_out(x) -> torch.Tensor:
    return _raw(x).detach()


def pipeline_phase(dev: torch.device, smi: str, models: dict) -> dict:
    """Serve a seeded mix of PIPE_REQUESTS requests over the six registered
    names through ``FPCAPipeline.serve``, with cross-config batching off and
    on; check launches and designs per group, every result against its
    config's own ``fpca.compile`` handle on the same group batch (bit for
    bit), merged against unmerged (bit for bit where the designs agree; the
    merged group's stacked SIMT launch against unmerged SIMT launches bit
    for bit and against the served tensor-core ones within the fpca limit);
    time serve (median of PIPE_TIMED)."""
    from repro_torch.serving import FrontendRequest

    configs = pipeline_configs(dev)
    by_name = {c[0]: c for c in configs}
    rng = np.random.default_rng(SEED + 60)
    g = torch.Generator().manual_seed(SEED + 61)
    frames = torch.rand((PIPE_REQUESTS, 120, 120, 3), generator=g).to(dev)
    names = [c[0] for c in configs]
    reqs = []
    for i in range(PIPE_REQUESTS):
        name = names[int(rng.integers(len(names)))]
        spec = by_name[name][1].spec
        mask = None
        if rng.random() < PIPE_MASKED:
            bh, bw = -(-spec.eff_h // spec.skip_block), -(-spec.eff_w // spec.skip_block)
            mask = rng.random((bh, bw)) < 0.4
        reqs.append(FrontendRequest(name, frames[i], mask))
    out: dict = {"launches": {}}
    served = {}
    for cross in (False, True):
        pipe = make_pipeline(dev, models, configs, cross_config_batching=cross)
        pipe.serve(reqs)                     # warm-up: builds, first-call costs
        torch.cuda.synchronize()
        groups = pipe.group_requests(reqs)
        _reset_fpca_counts()
        results = pipe.serve(reqs)
        torch.cuda.synchronize()
        launched, designs = fpca_conv_cuda.launches, dict(fpca_conv_cuda.designs)
        n_launches = 3 if cross else len(groups)
        want_designs = {"wgmma": 2, "simt": 1} if cross else {"wgmma": len(groups), "simt": 0}
        check(launched == n_launches and designs == want_designs,
              f"pipeline (cross_config_batching={cross}): {launched} fpca launches by design {designs}, expected "
              f"one a group or merged group, {want_designs}")
        label = "merged" if cross else "unmerged"
        out[f"serve_ms_{label}"] = host_ms(lambda: pipe.serve(reqs), runs=PIPE_TIMED, warmup=0)
        out[f"designs_{label}"] = designs
        out["launches"][f"pipeline serve ({label})"] = launched
        served[cross] = results
        print(f"pipeline serve ({label}) on {smi}: {PIPE_REQUESTS} requests in {len(groups)} config groups, "
              f"{launched} fpca launches by design {designs}; stats {pipe.stats.as_dict()}; "
              f"serve {out[f'serve_ms_{label}']:.3f} ms (host clock, median of {PIPE_TIMED}), "
              f"{PIPE_REQUESTS / out[f'serve_ms_{label}'] * 1e3:.0f} requests/s")
        if not cross:
            # every result against the config's own handle on the same batch
            cache = fpca.ExecutableCache(64)
            for name, idxs in groups.items():
                _, prog, kernel, bn, head = by_name[name]
                own = fpca.compile(prog, device=dev, weights=kernel, bn_offset=bn, head_params=head, cache=cache,
                                   model=models[prog.spec.n_active_pixels])
                wk = None
                if any(reqs[i].block_mask is not None for i in idxs):
                    wk = np.stack([active_window_mask(prog.spec, reqs[i].block_mask) if reqs[i].block_mask is not None
                                   else np.ones(output_dims(prog.spec), bool) for i in idxs])
                want = _host_out(own.run(frames[idxs], window_keep=wk))
                for j, i in enumerate(idxs):
                    check(torch.equal(_host_out(results[i]), want[j]),
                          f"pipeline {name} request {i}: differs from its own compiled handle")
            print(f"pipeline (unmerged): all {PIPE_REQUESTS} results == their configs' own fpca.compile handles "
                  "on the same group batches, bit for bit")
    # merged against unmerged
    pipe = make_pipeline(dev, models, configs)
    merged_names = {n for n, c in by_name.items() if c[1].spec == fpca_cnn.FRONTEND_SPEC}
    with simt_only():
        simt_results = pipe.serve(reqs)
    merged_counts, unmerged_counts = [], []
    for i, r in enumerate(reqs):
        a, b = _host_out(served[True][i]), _host_out(served[False][i])
        if r.config in merged_names:
            check(torch.equal(a, _host_out(simt_results[i])),
                  f"pipeline request {i} ({r.config}): merged differs from unmerged SIMT serving")
            if not isinstance(by_name[r.config][1], fpca.FPCAModelProgram):
                merged_counts.append(a)
                unmerged_counts.append(b)
        else:
            check(torch.equal(a, b), f"pipeline request {i} ({r.config}): merged differs from unmerged")
    err, flips = count_diff(torch.stack(merged_counts), torch.stack(unmerged_counts))
    check(err <= COUNT_TOL and flips < FLIP_TOL,
          f"pipeline: merged (SIMT) counts {err} off the unmerged tensor-core ones, flip share {flips}")
    out["merged_vs_unmerged_max_err"], out["merged_vs_unmerged_flip_share"] = err, flips
    print(f"pipeline merged == unmerged bit for bit for overlap_3x3 and binned_lowpower; the merged group "
          f"({sorted(merged_names)}, C = 32, SIMT design) == unmerged SIMT serving bit for bit, and its counts "
          f"vs the unmerged tensor-core ones: max|Δcount| {err}, flip share {flips:.3e} (fpca limit "
          f"{COUNT_TOL}, {FLIP_TOL})")
    return out


def camera_frames(n_ticks: int) -> dict:
    """FLEET_CAMERAS fpca_cnn cameras (the first FLEET_MOVING moving, the
    rest static) and the two fan-out cameras: ``{stream_id: (T, 120, 120,
    3)}`` on the host."""
    cams = {}
    for i in range(FLEET_CAMERAS):
        video = SyntheticMovingObject((120, 120), seed=i, speed=0.17)
        if i < FLEET_MOVING:
            cams[f"cam{i}"] = np.stack([video.frame_at(t) for t in range(n_ticks)])
        else:
            cams[f"cam{i}"] = np.repeat(video.frame_at(0)[None], n_ticks, axis=0)
    for j, sid in enumerate(("fan", "fan_ev")):
        video = SyntheticMovingObject((120, 120), seed=FLEET_CAMERAS + j, speed=0.17)
        cams[sid] = np.stack([video.frame_at(t) for t in range(n_ticks)])
    return cams


FAN = ("dense_5x5", "dense_5x5_b")


def attach_cameras(target, server) -> None:
    """The cameras on a server (``target`` is the server or a
    FleetController over it): fpca_cnn cameras, one fan-out camera with
    per-config gates (and per-config servos on a servoed server), one
    shared-gate fan-out camera with an event tap."""
    gate = fpca.DeltaGateConfig()
    for i in range(FLEET_CAMERAS):
        target.add_stream(f"cam{i}", "fpca_cnn")
    ctl = None if server.controller is None else {n: server.controller for n in FAN}
    target.add_stream("fan", FAN, gate={n: gate for n in FAN}, controller=ctl)
    target.add_stream("fan_ev", FAN, events=True)


def _run_ticks(target, cams: dict, ticks: range) -> tuple[list, float]:
    """Serve ``ticks`` of every camera through ``target.run``; returns the
    flat results and the wall milliseconds (host clock, ends synchronised)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = [r for rs in target.run({sid: f[t] for sid, f in cams.items()} for t in ticks) for r in rs]
    torch.cuda.synchronize()
    return results, (time.perf_counter() - t0) * 1e3


def _same_results(a: list, b: list, what: str) -> None:
    check(len(a) == len(b), f"{what}: {len(a)} results against {len(b)}")
    for x, y in zip(a, b):
        check((x.stream_id, x.frame_idx, x.config, x.kept_windows) == (y.stream_id, y.frame_idx, y.config, y.kept_windows)
              and bool((x.counts == y.counts).all())
              and (x.block_mask is None) == (y.block_mask is None)
              and (x.block_mask is None or bool((x.block_mask == y.block_mask).all()))
              and (x.logits is None) == (y.logits is None)
              and (x.logits is None or bool((x.logits == y.logits).all())),
              f"{what}: {x.stream_id}/{x.config} tick {x.frame_idx} differs")
        if x.events is not None or y.events is not None:
            check(x.events is not None and y.events is not None
                  and bool((x.events.coords == y.events.coords).all())
                  and bool((x.events.polarity == y.events.polarity).all()),
                  f"{what}: {x.stream_id} tick {x.frame_idx}: event packets differ")


def server_phase(dev: torch.device, smi: str, models: dict, cams: dict) -> dict:
    """The cameras on a plain StreamServer (default gate, no servo): a
    SERVER_WARM-tick warm-up, then FLEET_TICKS ticks through ``run`` at depth
    1 and 2 (bit for bit the same; the depth-2 run also splits its host time
    by part), each under the profiler once more for the busy share; each
    fpca_cnn camera against its own handle's ``stream()`` bit for bit, the
    fan-out's per-config results over FAN_SOLO_TICKS ticks against each
    config served alone (SIMT: bit for bit; tensor-core: within the fpca
    limit); launches per tick per group; the gate's batched call against
    the solo one on the card."""
    from repro_torch.serving import StreamServer

    configs = pipeline_configs(dev)
    by_name = {c[0]: c for c in configs}
    pipe = make_pipeline(dev, models, configs)
    ticks = range(FLEET_TICKS)
    n_streams = len(cams)
    out: dict = {"launches": {}}
    step = Laps()
    warm = StreamServer(pipe)               # builds the executables and first-call costs
    attach_cameras(warm, warm)
    _run_ticks(warm, cams, range(SERVER_WARM))
    step("warm-up")
    runs = {}
    for depth in (1, 2):
        server = StreamServer(pipe, depth=depth)
        attach_cameras(server, server)
        b0, s0 = pipe.stats.batches, pipe.stats.launches_skipped
        if depth == 2:
            spent = split_host_time(pipe, server)
        _reset_fpca_counts()
        results, wall = _run_ticks(server, cams, ticks)
        launched, designs = fpca_conv_cuda.launches, dict(fpca_conv_cuda.designs)
        if depth == 2:
            del pipe.run_config_batch           # the class's method again
            spent["dispatch"] -= spent["launch"] + spent["heads"]
            out["host_ms_per_tick"] = {k: v * 1e3 / len(ticks) for k, v in spent.items()}
        batches, skipped = pipe.stats.batches - b0, pipe.stats.launches_skipped - s0
        check(launched == batches and batches + skipped == 2 * len(ticks),
              f"server depth {depth}: {launched} fpca launches, {batches} batches and {skipped} skipped "
              f"for {len(ticks)} ticks of 2 config groups")
        runs[depth] = results
        out["launches"][f"server depth {depth}"] = launched
        step(f"depth {depth}")
        # the device's busy share: device time of the same ticks on a fresh
        # server under the profiler over the wall time of the unprofiled run
        def profiled(depth=depth):
            srv = StreamServer(pipe, depth=depth)
            attach_cameras(srv, srv)
            _run_ticks(srv, cams, ticks)

        _reset_fpca_counts()
        events = device_events(profiled, runs=1)
        device_ms = sum(e.device_time_total for e in events) / 1e3
        by_design = fpca_kernel_launches(events)
        check(by_design["wgmma"] + by_design["simt"] == fpca_conv_cuda.launches == launched,
              f"server depth {depth}: the profiler saw {by_design} fpca kernels, the wrapper counted "
              f"{fpca_conv_cuda.launches} there and {launched} in the timed run")
        step(f"depth {depth} profiled")
        out[f"depth{depth}"] = {
            "ms_per_tick": wall / len(ticks),
            "ms_per_stream_tick": wall / len(ticks) / n_streams,
            "device_ms_per_tick": device_ms / len(ticks),
            "busy": device_ms / wall,
            "designs": designs,
        }
        print(f"server depth {depth} on {smi}: {len(ticks)} ticks of {n_streams} streams, {wall / len(ticks):.3f} ms "
              f"per tick, {wall / len(ticks) / n_streams:.4f} ms per stream-tick (host clock); device "
              f"{device_ms / len(ticks):.3f} ms per tick, busy {device_ms / wall:.1%}; fpca launches {launched} "
              f"by design {designs} (the fpca_cnn group on wgmma, the C = 16 fan-out group on SIMT)")
        for e in sorted(events, key=lambda e: e.device_time_total, reverse=True)[:6]:
            print(f"  {e.key[:60]:60s} {e.device_time_total / 1e3 / len(ticks):.4f} ms/tick x{e.count // len(ticks)}")
    _same_results(runs[2], runs[1], "server depth 2 vs depth 1")
    print(f"server depth 2 on {smi}, host time a tick by part (host clock, the timed run): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in out["host_ms_per_tick"].items()))
    # each fpca_cnn camera against its own handle's stream()
    _, prog, kernel, bn, head = by_name["fpca_cnn"]
    cache = fpca.ExecutableCache(64)
    own = fpca.compile(prog, device=dev, weights=kernel, bn_offset=bn, head_params=head, cache=cache,
                       model=models[75])
    for i in range(FLEET_CAMERAS):
        sid = f"cam{i}"
        solo = list(own.stream(cams[sid][: len(ticks)], gate=fpca.DeltaGateConfig(), controller=None))
        mine = [r for r in runs[2] if r.stream_id == sid]
        for a, b in zip(mine, solo):
            b.stream_id, b.config = a.stream_id, a.config
        _same_results(mine, solo, f"server {sid} vs its own stream()")
    step("solo stream()")
    # the fan-out's per-config results against each config served alone
    solo_ticks = range(FAN_SOLO_TICKS)
    worst, fan_counts, solo_counts = 0.0, [], []
    for design_ctx, exact in ((simt_only, True), (contextlib.nullcontext, False)):
        for name in FAN:
            with design_ctx():
                srv = StreamServer(pipe)
                srv.add_stream("fan", name)
                srv.add_stream("fan_ev", name)
                solo, _ = _run_ticks(srv, {k: cams[k] for k in ("fan", "fan_ev")}, solo_ticks)
            mine = [r for r in runs[2] if r.stream_id in ("fan", "fan_ev") and r.config == name
                    and r.frame_idx < len(solo_ticks)]
            if exact:
                for a, b in zip(mine, solo):
                    b.events = a.events
                _same_results(mine, solo, f"fan-out {name} vs {name} alone (SIMT)")
            else:
                check(len(mine) == len(solo), f"fan-out {name}: {len(mine)} results against {len(solo)} alone")
                fan_counts += [torch.as_tensor(r.counts) for r in mine]
                solo_counts += [torch.as_tensor(r.counts) for r in solo]
                check(all(bool((a.block_mask == b.block_mask).all()) for a, b in zip(mine, solo)),
                      f"fan-out {name}: masks differ from {name} alone")
    worst, flips = count_diff(torch.stack(fan_counts), torch.stack(solo_counts))
    check(worst <= COUNT_TOL and flips < FLIP_TOL,
          f"fan-out: {worst} counts off the tensor-core solo launches, flip share {flips}")
    out["fanout_vs_wgmma_solo_max_err"], out["fanout_vs_wgmma_solo_flip_share"] = worst, flips
    step("fan-out solos")
    print(f"server: the {FLEET_CAMERAS} fpca_cnn cameras == their own handle's stream() bit for bit (counts, masks, "
          f"logits); depth 1 == depth 2 bit for bit; over {len(solo_ticks)} ticks the fan-out's per-config results "
          f"== each config alone on SIMT bit for bit, and {worst} counts at most off the tensor-core solo launches, "
          f"flip share {flips:.3e}")
    # the gate's batched call against the solo one, on the card
    from repro_torch.core import gating

    kern = gating.host_gate_kernels(fpca_cnn.FRONTEND_SPEC, dev)
    prev = torch.as_tensor(np.stack([cams[f"cam{i}"][0] for i in range(FLEET_CAMERAS)]), device=dev)
    cur = torch.as_tensor(np.stack([cams[f"cam{i}"][1] for i in range(FLEET_CAMERAS)]), device=dev)
    prev_eff = gating.effective_frame(prev, fpca_cnn.FRONTEND_SPEC)
    effs, deltas = kern.step_batch(prev_eff, cur)
    for i in range(FLEET_CAMERAS):
        e, d = kern.step(prev_eff[i], cur[i])
        check(torch.equal(e, effs[i]) and torch.equal(d, deltas[i]), "the batched gate differs from the solo gate")
    print(f"gate: step_batch over {FLEET_CAMERAS} cameras == step per camera, bit for bit, on the card")
    out["seconds_by_step"] = step.report("server phase")
    return out


class Laps:
    """Host seconds each step of a phase took: ``laps(name)`` closes the
    step that ran since the last call."""

    def __init__(self):
        self.seconds: dict = {}
        self._t = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now

    def report(self, phase: str) -> dict:
        print(f"{phase} seconds by step: " + ", ".join(f"{k} {v:.1f}" for k, v in self.seconds.items()))
        return self.seconds


def split_host_time(pipe, server) -> dict:
    """Wrap the pipeline call (the fused launch and its host work), the
    model heads, the realisation of results and the dispatch of ``server``
    so that each adds its host seconds to the returned dict; the caller
    deletes ``pipe.run_config_batch`` after the run and takes launch and
    heads out of dispatch."""
    spent = dict.fromkeys(("launch", "heads", "finalize", "dispatch"), 0.0)

    def timed(part, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[part] += time.perf_counter() - t0
        return call

    pipe.run_config_batch = timed("launch", pipe.run_config_batch)
    server._model_head_pass = timed("heads", server._model_head_pass)
    server._finalize = timed("finalize", server._finalize)
    server._dispatch = timed("dispatch", server._dispatch)
    return spent


def stacked_launch_check(dev: torch.device, smi: str, bucket_model, cams: dict) -> dict:
    """The fan-out's stacked C = 16 launch (SIMT design) against its plain
    version, and timed beside two C = 8 tensor-core launches of the same
    windows, at the windows of 2, 16 and 256 frames."""
    configs = {c[0]: c for c in pipeline_configs(dev)}
    spec = fpca_cnn.FRONTEND_SPEC
    tables = conv_tables(bucket_model, fpca.ADCConfig(), spec.n_active_pixels, dev)
    planes = {}
    for name in FAN:
        w_pos, w_neg = encode_weights(configs[name][2].to(dev), spec, fpca.WeightEncoding())
        planes[name] = (weight_planes(w_pos.T, w_neg.T, tables), configs[name][3].to(dev))
    kernel = torch.cat([configs[n][2] for n in FAN]).to(dev)
    w_pos, w_neg = encode_weights(kernel, spec, fpca.WeightEncoding())
    stacked = weight_planes(w_pos.T, w_neg.T, tables)
    bn = torch.cat([configs[n][3] for n in FAN]).to(dev)
    frames = torch.as_tensor(np.concatenate([f[:16] for f in cams.values()]), device=dev)
    out = {}
    for b in (2, 16, 256):
        p = extract_windows(frames[:b], spec).reshape(-1, spec.n_active_pixels).contiguous()
        check(fpca_kernel.design(p, tables, 16) == "simt" and fpca_kernel.design(p, tables, 8) == "wgmma",
              "the stacked launch must take SIMT and each half wgmma")
        got = fpca_conv_cuda(p, stacked, tables, bn)
        want = fpca_conv_basis(p, stacked, tables, bn)
        halves = [fpca_conv_cuda(p, planes[n][0], tables, planes[n][1]) for n in FAN]
        torch.cuda.synchronize()
        err, flips = count_diff(got, want)
        err_h, _ = count_diff(got, torch.cat(halves, -1))
        check(err <= COUNT_TOL and flips < FLIP_TOL, f"stacked C = 16 launch at M={p.shape[0]}: {err} counts, "
              f"flips {flips} off its plain version")
        check(err_h <= COUNT_TOL, f"stacked C = 16 launch at M={p.shape[0]}: {err_h} counts off the two wgmma launches")
        simt_ms = time_cuda(lambda: fpca_conv_cuda(p, stacked, tables, bn))
        two_ms = time_cuda(lambda: [fpca_conv_cuda(p, planes[n][0], tables, planes[n][1]) for n in FAN])
        plain_ms = time_cuda(lambda: fpca_conv_basis(p, stacked, tables, bn))
        out[int(p.shape[0])] = {"simt_stacked_ms": simt_ms, "two_wgmma_ms": two_ms, "plain_ms": plain_ms,
                                "max_abs_err": err, "flip_share": flips, "vs_two_wgmma_max_err": err_h}
        print(f"stacked C = 16 launch at M={p.shape[0]} ({b} frames) on {smi}: SIMT {simt_ms:.4f} ms, two C = 8 "
              f"tensor-core launches {two_ms:.4f} ms, plain {plain_ms:.4f} ms; vs plain max|Δcount| {err}, flip "
              f"share {flips:.3e}; vs the two tensor-core launches max|Δcount| {err_h}")
    return out


def fleet_phase(dev: torch.device, smi: str, models: dict, cams: dict) -> dict:
    """The cameras under a FleetController (FLEET_CONFIG, GateControllerConfig
    target FLEET_TARGET): FLEET_TICKS ticks through ``run`` (depth 2), then
    FLEET_TICKS more of the fpca_cnn cameras through ``serve_segments``
    (segments of FLEET_SEGMENT ticks, the cameras' segments interleaved on
    the one shared handle and captured graph), each segment against the
    camera's own handle's ``run_segment`` on the same input carry and gate,
    bit for bit; checks launches per tick per group (for the segments, the
    profiler over the interleaved ``serve_segments`` run itself), the
    allocation gauges summing to the budget and ``assert_reconciled``;
    times the interleaving again unprofiled; prints
    ``render_fleet_report``."""
    from repro_torch.fpca import telemetry
    from repro_torch.serving import (
        FleetConfig,
        FleetController,
        StreamServer,
        assert_reconciled,
        fleet_report,
        render_fleet_report,
    )

    configs = pipeline_configs(dev)
    by_name = {c[0]: c for c in configs}
    pipe = make_pipeline(dev, models, configs)
    server = StreamServer(pipe, depth=2, controller=fpca.GateControllerConfig(target=FLEET_TARGET))
    fc = FleetController(server, FleetConfig(**FLEET_CONFIG))
    attach_cameras(fc, server)
    out: dict = {"launches": {}}
    step = Laps()
    b0, s0 = pipe.stats.batches, pipe.stats.launches_skipped
    _reset_fpca_counts()
    results, wall = _run_ticks(fc, cams, range(FLEET_TICKS))
    launched, designs = fpca_conv_cuda.launches, dict(fpca_conv_cuda.designs)
    batches, skipped = pipe.stats.batches - b0, pipe.stats.launches_skipped - s0
    check(launched == batches and batches + skipped == 2 * FLEET_TICKS,
          f"fleet run: {launched} fpca launches, {batches} batches, {skipped} skipped for {FLEET_TICKS} ticks "
          "of 2 config groups")
    check(len(results) == FLEET_TICKS * (FLEET_CAMERAS + 2 * len(FAN)), f"fleet run: {len(results)} results")
    out["launches"]["fleet run"] = launched
    out["run_ms_per_tick"] = wall / FLEET_TICKS
    alloc = {labels["stream"]: value for name, _k, labels, value in telemetry.registry().collect()
             if name == "fpca_fleet_allocation" and labels.get("stream") in server.sessions}
    check(len(alloc) == len(server.sessions) and abs(sum(alloc.values()) - FLEET_CONFIG["budget"]) < 1e-9,
          f"fleet: allocation gauges {alloc} sum to {sum(alloc.values())}, the budget is {FLEET_CONFIG['budget']}")
    assert_reconciled(pipe, server)
    print(f"fleet run on {smi}: {FLEET_TICKS} ticks, {wall / FLEET_TICKS:.3f} ms per tick (host clock); fpca launches "
          f"{launched} by design {designs}; allocation gauges sum to {sum(alloc.values()):.12f} (budget "
          f"{FLEET_CONFIG['budget']}); {fc.rebalances} rebalances; assert_reconciled passed")
    step("run")
    # segments of the fpca_cnn cameras, interleaved on the shared handle,
    # under the profiler: a replayed graph's kernels do not pass through the
    # wrapper, so the profiler counts the fpca kernels this run launched
    calls = []
    serve_segment = pipe.run_config_segment

    def recorded(name, frames, **kw):
        calls.append((frames, kw))
        return serve_segment(name, frames, **kw)

    fpca_ids = [f"cam{i}" for i in range(FLEET_CAMERAS)]
    seg_frames = {sid: cams[sid][FLEET_TICKS:2 * FLEET_TICKS] for sid in fpca_ids}
    n_rounds = FLEET_TICKS // FLEET_SEGMENT

    def interleaved(results: dict, order: list) -> None:
        gens = {sid: fc.serve_segments(sid, seg_frames[sid], segment_length=FLEET_SEGMENT) for sid in fpca_ids}
        for _ in range(n_rounds):
            for sid in fpca_ids:
                order.append(sid)
                results.setdefault(sid, []).extend(next(gens[sid]) for _ in range(FLEET_SEGMENT))

    def graphs() -> set:
        return {k for k in pipe.cache_info(verbose=True).resident if "segment" in k}

    order: list = []
    seg_results: dict = {}
    before = graphs()
    pipe.run_config_segment = recorded
    _reset_fpca_counts()
    events = device_events(lambda: interleaved(seg_results, order), runs=1)
    pipe.run_config_segment = serve_segment
    new_graphs = len(graphs() - before)
    n_calls, seg_ticks = len(calls), len(calls) * FLEET_SEGMENT
    on_card = fpca_kernel_launches(events)
    # every call replays its graph once (K kernels); a new graph's first
    # call also warms its body up eagerly (K more) before the capture,
    # whose launches the wrapper counts but the device does not run
    check(n_calls == len(order) == n_rounds * len(fpca_ids)
          and fpca_conv_cuda.launches == 2 * FLEET_SEGMENT * new_graphs
          and on_card == {"wgmma": seg_ticks + FLEET_SEGMENT * new_graphs, "simt": 0},
          f"fleet segments: {n_calls} segments, {new_graphs} new graphs; the device ran {on_card} fpca kernels and "
          f"the wrapper counted {fpca_conv_cuda.launches}, expected one replay of {FLEET_SEGMENT} tensor-core "
          f"kernels a segment and a warm-up and a capture of {FLEET_SEGMENT} ticks a new graph")
    out["launches"]["fleet segments"] = on_card["wgmma"] + on_card["simt"]
    out["segment_graphs_captured"] = new_graphs
    out["segment_device_ms_per_stream_tick"] = sum(e.device_time_total for e in events) / 1e3 / seg_ticks
    assert_reconciled(pipe, server)
    step("segments profiled")
    # the same interleaving again, unprofiled, for the host clock (the
    # fleet's cameras carry on from the first pass)
    before = graphs()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    interleaved({}, [])
    torch.cuda.synchronize()
    out["segment_ms_per_stream_tick"] = (time.perf_counter() - t0) * 1e3 / seg_ticks
    out["segment_graphs_captured_timed"] = len(graphs() - before)
    assert_reconciled(pipe, server)
    step("segments timed")
    # each segment of the profiled pass against the camera's own handle on
    # the same carry and gate
    _, prog, kernel, bn, head = by_name["fpca_cnn"]
    own = fpca.compile(prog, device=dev, weights=kernel, bn_offset=bn, head_params=head,
                       cache=fpca.ExecutableCache(64), model=models[75])
    solo_state: dict = {}
    done = {sid: 0 for sid in fpca_ids}
    for sid, (frames, kw) in zip(order, calls):
        state = solo_state.get(sid, kw["state"])
        seg = own.run_segment(frames, state=state, gate=kw["gate"], m_bucket=kw["m_bucket"])
        solo_state[sid] = seg.state
        k = done[sid]
        for t in range(seg.ticks):
            r = seg_results[sid][k + t]
            check(bool((seg.counts[t].cpu().numpy() == r.counts).all())
                  and bool((seg.block_masks[t] == r.block_mask).all())
                  and bool((seg.logits[t].cpu().numpy() == r.logits).all()),
                  f"fleet segment {sid} tick {r.frame_idx}: differs from the camera's own run_segment")
        done[sid] += seg.ticks
    step("solo run_segment")
    print(f"fleet segments on {smi}: {n_calls} segments of {FLEET_SEGMENT} ticks ({len(fpca_ids)} cameras "
          f"interleaved on one handle through FleetController.serve_segments), {new_graphs} graphs captured; "
          f"under the profiler the device ran fpca kernels {on_card} (one a replayed tick, plus the warm-up of each "
          f"new graph), {out['segment_device_ms_per_stream_tick']:.4f} ms device per stream-tick; the same "
          f"interleaving again unprofiled {out['segment_ms_per_stream_tick']:.4f} ms per stream-tick (host clock, "
          f"{out['segment_graphs_captured_timed']} new graphs captured in it); each segment == the camera's own "
          "run_segment on the same carry and gate, bit for bit")
    report = fleet_report(server, fleet=fc)
    print(render_fleet_report(report))
    out["report_fleet"] = report["fleet"]
    out["seconds_by_step"] = step.report("fleet phase")
    return out


# ---------------------------------------------------------------------------
# the FPCA training path: examples/train_fpca_cnn_torch.py on the card
# ---------------------------------------------------------------------------


def load_example(name: str):
    """``examples/<name>.py`` as a module (the examples are scripts, not a
    package)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fpca_train_phase(dev: torch.device, smi: str, bucket_model) -> dict:
    """Train the example's network (60x60x3 frames, 8 channels of 5x5,
    stride 5, 4-bit ADC, 8 NVM levels, batch 32, 200 AdamW steps) on the
    card twice, through the bucket model (``hw_aware``) and through an ideal
    convolution (``naive``), and deploy both on the circuit oracle and the
    hw-aware one through the fpca kernel.  Checks, in order: one hw-aware
    loss and its gradients card vs host at smoke size; finite losses and
    grad norms and no fpca launch in training; hw-aware >= 80% on the oracle
    and above naive; one kernel launch per deployed batch, on ``wgmma``;
    the kernel against its plain version at the path's M = 18,432; the
    export rebuilt and compiled, its counts equal to the layer's kernel
    counts bit for bit.  Returns the numbers and ``launches``."""
    t_phase = time.perf_counter()
    step = Laps()
    ex = load_example("train_fpca_cnn_torch")
    cpu = torch.device("cpu")
    adc, enc = fpca.ADCConfig(bits=ex.ADC_BITS), fpca.WeightEncoding(n_levels=ex.NVM_LEVELS)

    # ---- card vs host: one hw-aware loss and its gradients, smoke size ----
    smoke = fpca.FPCAProgram(spec=fpca.FPCASpec(**FPCA_TRAIN_SMOKE), adc=adc, enc=enc)
    batch = SyntheticVWW((smoke.spec.image_h, smoke.spec.image_w)).batch_at(0, FPCA_TRAIN_SMOKE_BATCH)
    got = []
    for d in (dev, cpu):
        layer = FPCAFrontend(smoke, model=bucket_model, device=d)
        p = {"frontend": layer.init(torch.Generator().manual_seed(SEED)),
             "head": ex.init_head(torch.Generator().manual_seed(SEED + 1), *layer.out_shape, device=d)}
        leaves = [t.requires_grad_() for t in tree_leaves(p)]
        images = torch.as_tensor(batch["images"], device=d)
        labels = torch.as_tensor(batch["labels"], dtype=torch.int64, device=d)
        loss = ex.loss_fn("hw_aware", layer, p, images, labels)
        grads = torch.autograd.grad(loss, leaves)
        got.append((float(loss.detach()), [g.cpu() for g in grads]))
    (loss_d, g_d), (loss_h, g_h) = got
    grad_err = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30)) for a, b in zip(g_d, g_h))
    print(f"fpca training, card vs host at {FPCA_TRAIN_SMOKE} batch {FPCA_TRAIN_SMOKE_BATCH}: loss {loss_d:.7f} / "
          f"{loss_h:.7f}, max gradient diff {grad_err:.2e} of max|grad| (limits {TRAIN_LOSS_TOL}, {TRAIN_GRAD_TOL})")
    check(abs(loss_d - loss_h) <= TRAIN_LOSS_TOL, "fpca hw-aware loss differs between card and host")
    check(grad_err <= TRAIN_GRAD_TOL, "fpca hw-aware gradients differ between card and host")
    step("card vs host")

    # ---- two full trainings --------------------------------------------------
    spec = ex.SPEC
    prog = fpca.FPCAProgram(spec=spec, circuit=fpca.CircuitParams(), adc=adc, enc=enc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    layer = FPCAFrontend(prog, model=bucket_model, device=dev)
    calib_s = time.perf_counter() - t0
    print(f"fpca frontend {spec.image_h}x{spec.image_w}x3 -> {layer.out_shape} on {smi}: calibrate_gain "
          f"{calib_s:.3f} s, gain {layer.gain:.4f}, r2 {layer.calibration_r2:.4f}")
    data = SyntheticVWW((spec.image_h, spec.image_w))
    _reset_fpca_counts()
    trained, step_ms = {}, {}
    for mode in ("hw_aware", "naive"):
        trained[mode], hist = ex.train(mode, layer, data, ex.STEPS, ex.BATCH, seed=SEED)
        check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist),
              f"fpca {mode} training: a non-finite loss or grad norm")
        step_ms[mode] = statistics.median(h["ms"] for h in hist[10:])
        print(f"fpca {mode} training: {ex.STEPS} steps of batch {ex.BATCH}, loss "
              f"{hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, last grad norm {hist[-1]['grad_norm']:.4f}; "
              f"{step_ms[mode]:.3f} ms a step (host clock, median after 10 warm-up steps) on {smi}")
    check(fpca_conv_cuda.launches == 0, f"training launched fpca_conv_cuda {fpca_conv_cuda.launches} times: "
          "it runs the dense differentiable path")
    step("training")

    # ---- deployed accuracy: the oracle, and the fpca kernel -----------------
    acc = {mode: ex.deployed_accuracy(layer, trained[mode], data) for mode in trained}
    acc_kernel = ex.deployed_accuracy(layer, trained["hw_aware"], data, backend="cuda")
    n_batches = 512 // 128
    check(fpca_conv_cuda.launches == n_batches,
          f"deployment through the kernel: {fpca_conv_cuda.launches} fpca launches for {n_batches} batches")
    gap = acc["hw_aware"] - acc["naive"]
    print(f"fpca deployed accuracy on the circuit oracle (512 images): hw-aware {100 * acc['hw_aware']:.1f}%, "
          f"naive {100 * acc['naive']:.1f}%, gap {100 * gap:+.1f} points; hw-aware through the fpca kernel "
          f"{100 * acc_kernel:.1f}%")
    check(acc["hw_aware"] >= FPCA_TRAIN_MIN_ACC, f"hw-aware accuracy on the oracle {acc['hw_aware']:.3f} < "
          f"{FPCA_TRAIN_MIN_ACC}")
    check(gap > 0, "the hw-aware network must beat the naive one on the oracle")
    step("deployed accuracy")

    # ---- the export, rebuilt and compiled --------------------------------------
    hw = trained["hw_aware"]
    x = torch.as_tensor(data.batch_at(10_000, 128)["images"], device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fpca_cnn.npz")
        ex.save_export(path, layer, hw, calib_images=data.batch_at(0, ex.BATCH)["images"])
        bundle = dict(np.load(path))
    meta = json.loads(bytes(bundle["meta"]).decode())
    mprog = fpca_cnn.make_model_program(
        fpca.FPCASpec(image_h=meta["image_h"], image_w=meta["image_w"], out_channels=meta["out_channels"],
                      kernel=meta["kernel"], stride=meta["stride"], max_kernel=meta["max_kernel"]),
        adc=fpca.ADCConfig(bits=meta["adc_bits"]), enc=fpca.WeightEncoding(n_levels=meta["nvm_levels"]),
        input_scale=meta["input_scale"],
    )
    head_params = [{"w": bundle[f"head{i}_w"], "b": bundle[f"head{i}_b"]} for i in range(len(mprog.head))]
    compiled = fpca.compile(mprog, backend="cuda", device=dev, weights=bundle["kernel"],
                            bn_offset=bundle["bn_offset"], head_params=head_params, model=bucket_model)
    logits = compiled.run(x)
    counts = compiled.run_frontend_weighted(compiled.kernel, compiled.bn_offset, x)
    with torch.no_grad():
        acts = layer.apply(hw["frontend"], x, train=False, backend="cuda")
        want_logits = ex.head_apply(hw["head"], acts)
    torch.cuda.synchronize()
    check(torch.equal(acts, counts * (adc.lsb * layer.gain)),
          "the compiled export's counts must equal FPCAFrontend.apply(backend='cuda') counts bit for bit")
    # the same counts on both sides (logit_bound's count term is 0): the
    # logits differ by the head's f32 rounding alone
    bound = 1e-4 * want_logits.abs() + 1e-4
    print(f"fpca export: compiled run vs the trained head on the same counts, max|Δlogit| "
          f"{float((logits - want_logits).abs().max()):.3e}")
    check(bool(((logits - want_logits).abs() <= bound).all()), "the compiled export's logits leave the bound")
    launches, designs = fpca_conv_cuda.launches, dict(fpca_conv_cuda.designs)
    check(designs["wgmma"] == launches, f"fpca training path launches by design {designs}: every one on wgmma")
    print(f"fpca training path: fpca_conv_cuda launches {launches} by design {designs} (0 in training, "
          f"{n_batches} deploying, 3 for the export)")
    step("export")

    # ---- the kernel against its plain version at this path's shape ----------
    kernel, bn = hw["frontend"]["kernel"], hw["frontend"]["bn_offset"].contiguous()
    w_pos, w_neg = encode_weights(kernel, spec, enc)
    tables = conv_tables(bucket_model, adc, spec.n_active_pixels, dev)
    planes = weight_planes(w_pos.T, w_neg.T, tables)
    patches = extract_windows(x, spec).reshape(-1, spec.n_active_pixels).contiguous()
    check(fpca_kernel.design(patches, tables, spec.out_channels) == "wgmma",
          "the deployed patch matrix must take the fpca tensor-core design")
    got_c = fpca_conv_cuda(patches, planes, tables, bn)
    want_c = fpca_conv_basis(patches, planes, tables, bn)
    oracle = fpca_forward(x, kernel, spec, circuit=prog.circuit, adc=adc, enc=enc, bn_offset_counts=bn,
                          mode="oracle")["counts"].reshape(got_c.shape)
    torch.cuda.synchronize()
    max_err, flips = count_diff(got_c, want_c)
    err_o, flips_o = count_diff(got_c, oracle)
    M = patches.shape[0]
    print(f"fpca_conv kernel vs plain at the training path's M={M} (4-bit ADC, trained kernel): max|Δcount| "
          f"{max_err}, flip share {flips:.3e} (limit: <= {COUNT_TOL} on < {FLIP_TOL}); deployed counts vs the "
          f"circuit oracle's: max|Δcount| {err_o}, share off {flips_o:.3e}")
    check(max_err <= COUNT_TOL and flips < FLIP_TOL, "fpca_conv kernel disagrees with its plain version at M=18432")
    ms = time_cuda(lambda: fpca_conv_cuda(patches, planes, tables, bn))
    plain_ms = time_cuda(lambda: fpca_conv_basis(patches, planes, tables, bn), iters=5)
    bound_ms, parts, bytes_moved, _ = fpca_bound_ms(M, spec.n_active_pixels, spec.out_channels,
                                                   planes["aw"].shape[1], bucket_model.n_buckets)
    print(f"fpca_conv at M={M} (training path, 4-bit ADC) on {smi}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms (bytes {parts['bytes']:.4f}, bf16 passes {parts['tensor']:.4f}, fp32 "
          f"{parts['fp32']:.4f}, MUFU {parts['mufu']:.4f})")
    step("kernel check")

    # ---- times ----------------------------------------------------------------
    oracle_ms = host_ms(lambda: layer.apply(hw["frontend"], x, train=False))
    kernel_eval_ms = host_ms(lambda: layer.apply(hw["frontend"], x, train=False, backend="cuda"))
    synth_ms = host_ms(lambda: data.batch_at(0, ex.BATCH))
    print(f"fpca evaluation of 128 frames on {smi} (host clock, median of 10): circuit oracle {oracle_ms:.3f} ms, "
          f"through the fpca kernel {kernel_eval_ms:.3f} ms; SyntheticVWW batch of {ex.BATCH} (numpy, in "
          f"every step) {synth_ms:.3f} ms")
    profiles = {}
    for mode in ("hw_aware", "naive"):
        torch.cuda.reset_peak_memory_stats(dev)
        device_ms, rows = profile_device(
            lambda: ex.train(mode, layer, data, 1, ex.BATCH, params=trained[mode]), runs=1)
        peak = torch.cuda.max_memory_allocated(dev)
        profiles[mode] = {"device_ms": device_ms, "busy": device_ms / step_ms[mode], "peak_bytes": peak}
        print(f"profile fpca {mode} step on {smi}: device time {device_ms:.4f} ms, busy "
              f"{device_ms / step_ms[mode]:.1%} of the median step, peak memory {peak / 2**30:.2f} GiB")
        for row in rows:
            print(f"  {row}")
    step("times")
    seconds = step.report("fpca training phase")
    wall = time.perf_counter() - t_phase
    print(f"fpca training phase: {wall:.1f} s (target: under 60 s)")
    return {
        "launches": {"fpca_train": launches},
        "accuracy": {**acc, "hw_aware_kernel": acc_kernel, "gap": gap},
        "step_ms": step_ms,
        "step_profile": profiles,
        "calibration": {"seconds": calib_s, "gain": layer.gain, "r2": layer.calibration_r2},
        "eval_128_ms": {"oracle": oracle_ms, "kernel": kernel_eval_ms},
        "batch_synthesis_ms": synth_ms,
        "kernel_at_18432": {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "max_abs_err": max_err,
                            "flip_share": flips, "oracle_share_off": flips_o},
        "card_vs_host": {"loss_diff": abs(loss_d - loss_h), "grad_err": grad_err},
        "seconds_by_step": seconds,
        "seconds": wall,
        "export_bundle": bundle,
    }


# ---------------------------------------------------------------------------
# the example twins (examples/*_torch.py), each at its defaults on the card
# ---------------------------------------------------------------------------


def _twin_checks(name: str, res: dict, fpca_launches: int, designs: dict, flash: int) -> None:
    """What each twin must show on the card: twins 2-6 reach the fpca
    kernel, every launch on the tensor-core design but adaptive_stream's
    channel-stacked C = 12 ones (SIMT takes more than 8 channels);
    quickstart runs the oracle and no kernel; serve_lm launches the flash
    kernel once per layer in its prefill."""
    if name == "quickstart":
        check(fpca_launches == 0, f"quickstart launched the fpca kernel {fpca_launches} times")
        check(res["max_err"] < 0.03 and np.isfinite(res["counts"]).all(), "quickstart: model error or counts")
        return
    if name == "serve_lm":
        check(res["prefill_launches"] == (2, 0) and flash == 2 and res["finite"],
              f"serve_lm: launches (flash, ssd) per prefill {res['prefill_launches']}, finite {res['finite']}")
        return
    check(fpca_launches >= 1, f"{name}: the twin never launched fpca_conv_cuda")
    if name == "adaptive_stream":
        check(designs["simt"] == fpca_launches == res["fanout_batches"],
              f"adaptive_stream: {fpca_launches} launches by design {designs}, {res['fanout_batches']} stacked calls")
        return
    check(designs["wgmma"] == fpca_launches, f"{name}: fpca launches by design {designs}, every one must take the "
          "tensor-core design")
    if name == "region_skipping":
        for img in res["images"]:
            check(img["zeroed"] and img["max_count_diff"] <= COUNT_TOL,
                  f"region_skipping: kept region off the oracle by {img['max_count_diff']} or skipped not zeroed")
    elif name == "serve_frontend":
        check((res["requests"], res["batches"], res["cache_misses"]) == (96, 6, 3), "serve_frontend: pipeline stats")
    elif name == "serve_fpca_cnn":
        check(res["backend"] == "cuda" and np.isfinite(res["logits"]).all(), "serve_fpca_cnn: backend or logits")


# what a twin returns that is not compared with its host run: times, the
# backend's name, kernel launch counts, the kept region against the oracle
# on the same device (checked in _twin_checks), the int8-vs-f32 parity, and
# telemetry counts that depend on the process (the registry's lines) or the
# device (spans); logits and classes are compared in _cnn_logits_vs_host
TWIN_UNCOMPARED = {"cold_s", "warm_s", "gated_s", "dense_s", "prefill_s", "decode_s", "backend",
                   "prefill_launches", "identical", "max_count_diff", "parity", "events", "spans",
                   "snapshot_lines", "threshold_line", "logits", "pipeline_logits", "classes", "class"}
# keys under which a twin returns SS-ADC counts, and floats it computes on
# its device (within 1e-4 of their value)
TWIN_COUNT_KEYS, TWIN_DEVICE_FLOATS = {"counts", "handle_counts", "results"}, {"max_err"}


@contextlib.contextmanager
def shared_fits():
    """Route the bucket-model fits of the compiler and the pipeline, and of
    every twin module the caller points at the yielded function, through
    one cache keyed by the fit's arguments (the device aside): a twin's
    host run reuses the model its card run fitted, so the two runs compare
    the kernel with its plain version on one model."""
    from repro_torch.fpca import executable
    from repro_torch.serving import fpca_pipeline

    cache: dict = {}

    def fit(*args, device=None, **kw):
        key = repr((args, sorted(kw.items())))
        if key not in cache:
            cache[key] = fit_bucket_model(*args, device=device, **kw)
        return cache[key]

    modules = (executable, fpca_pipeline)
    real = [m.fit_bucket_model for m in modules]
    for m in modules:
        m.fit_bucket_model = fit
    try:
        yield fit
    finally:
        for m, f in zip(modules, real):
            m.fit_bucket_model = f


def _twin_leaves(card, host, path: tuple = ()):
    """(path, card leaf, host leaf) of two returned trees of one shape."""
    if isinstance(card, dict):
        check(isinstance(host, dict) and card.keys() == host.keys(), f"twin result keys differ at {path}")
        for k in card:
            if k not in TWIN_UNCOMPARED:
                yield from _twin_leaves(card[k], host[k], path + (k,))
    elif isinstance(card, (list, tuple)):
        check(isinstance(host, (list, tuple)) and len(card) == len(host), f"twin result lengths differ at {path}")
        for i, (a, b) in enumerate(zip(card, host)):
            yield from _twin_leaves(a, b, path + (i,))
    else:
        yield path, card, host


def twin_vs_host(name: str, card: dict, host: dict) -> dict:
    """A twin's card run against its host run: counts within COUNT_TOL on
    fewer than FLIP_TOL of them (pooled over the run), device-computed
    floats within 1e-4 of their value, every other number (kept windows,
    cache and pipeline stats, fan-out counts, servo thresholds and EMAs,
    cycles and energies) equal."""
    n_counts, flipped, worst, exact = 0, 0, 0.0, 0
    for path, a, b in _twin_leaves(card, host):
        where = f"{name}: {'/'.join(map(str, path))}"
        if isinstance(a, (np.ndarray, torch.Tensor)) and any(k in TWIN_COUNT_KEYS for k in path):
            a, b = torch.as_tensor(np.asarray(_host_np(a))), torch.as_tensor(np.asarray(_host_np(b)))
            check(a.shape == b.shape, f"{where}: counts {tuple(a.shape)} vs {tuple(b.shape)}")
            d = (a.float() - b.float()).abs()
            n_counts, flipped = n_counts + d.numel(), flipped + int((d > 0).sum())
            worst = max(worst, float(d.max()) if d.numel() else 0.0)
        elif path and path[-1] in TWIN_DEVICE_FLOATS:
            check(abs(a - b) <= 1e-4 * abs(b), f"{where}: {a} on the card, {b} on the host")
        else:
            same = np.array_equal(_host_np(a), _host_np(b)) if isinstance(a, (np.ndarray, torch.Tensor)) else a == b
            check(bool(same), f"{where}: {a!r} on the card, {b!r} on the host")
            exact += 1
    flips = flipped / max(n_counts, 1)
    check(worst <= COUNT_TOL and flips < FLIP_TOL, f"{name}: counts on the card vs the host: max|Δcount| {worst}, "
          f"flip share {flips:.3e} (limit: <= {COUNT_TOL} on < {FLIP_TOL})")
    return {"counts": n_counts, "max_count_diff": worst, "flip_share": flips, "exact": exact}


def _host_np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _cnn_logits_vs_host(card: dict, host: dict, spec, head: list[dict] | None, scale: float) -> dict:
    """serve_fpca_cnn's logits (the batch, the pipeline's frame 0, every
    stream tick) on the card against the host's.  The head reads a batch
    row's counts, and a tick's effective map: its kept windows' counts
    patched over the map of the tick before, so a count flipped on an
    earlier tick stays in the map until its window is read again.  f32:
    within the bound those count differences give (``logit_bound``, as the
    fpca serving phase holds served logits against the oracle), plus 1e-4
    of the value.  int8 (``head`` None): within INT8_LOGIT_RTOL of
    max|logit| wherever the head's input is equal on both (a flipped count
    may move a requantised input a step: those rows are counted, not
    compared).  Classes equal wherever the host's top-2 margin exceeds
    twice the bound."""
    def diff(a, b) -> torch.Tensor:
        return torch.as_tensor(a).float() - torch.as_tensor(b).float()

    rows = [(diff(card["counts"], host["counts"]), card["logits"], host["logits"]),
            (diff(card["counts"][:1], host["counts"][:1]), card["pipeline_logits"][None], host["pipeline_logits"][None])]
    d_eff = None
    for c, h in zip(card["stream"]["ticks"], host["stream"]["ticks"]):
        keep = torch.as_tensor(active_window_mask(spec, c["block_mask"]))[..., None]
        dc = diff(c["counts"], h["counts"])
        d_eff = dc if d_eff is None else torch.where(keep, dc, d_eff)
        rows.append((d_eff[None], c["logits"][None], h["logits"][None]))
    worst, frames, skipped = 0.0, 0, 0
    for dc, cl, hl in rows:
        cl, hl = torch.as_tensor(cl), torch.as_tensor(hl)
        if head is None:
            same = (dc == 0).reshape(dc.shape[0], -1).all(1)
            bound = torch.full_like(hl, INT8_LOGIT_RTOL * float(hl.abs().max()))
            skipped += int((~same).sum())
            cl, hl, bound = cl[same], hl[same], bound[same]
        else:
            bound = logit_bound(head, dc, scale) + 1e-4 * hl.abs() + 1e-4
        d = (cl - hl).abs()
        worst, frames = max(worst, float(d.max()) if d.numel() else 0.0), frames + hl.shape[0]
        check(bool((d <= bound).all()), f"serve_fpca_cnn: logits on the card off the host's by {worst}")
        top2 = hl.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * bound.max(-1).values
        check(bool((cl.argmax(-1) == hl.argmax(-1))[clear].all()), "serve_fpca_cnn: a class with a clear margin "
              "differs between the card and the host")
    return {"logit_rows": frames, "logit_rows_flipped": skipped, "max_logit_diff": worst}


def _lm_vs_host(res: dict, cfg, params: dict, prompts: np.ndarray) -> dict:
    """serve_lm's greedy tokens on the card (the flash kernel in its
    prefill) against the host's plain path, teacher-forced: a prefill on
    the host of the prompts plus the card's first t tokens must pick the
    card's token t, wherever its top-2 margin exceeds 2 SMOKE_TOL."""
    host = _to(params, torch.device("cpu"))
    seqs = torch.as_tensor(res["sequences"]).long()
    toks = torch.as_tensor(prompts).long()
    ties = 0
    for t in range(seqs.shape[1]):
        logits, _ = forward_prefill(host, cfg, torch.cat([toks, seqs[:, :t]], 1))
        top2 = logits.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * SMOKE_TOL
        check(bool((logits.argmax(-1) == seqs[:, t])[clear].all()),
              f"serve_lm: greedy token {t} on the card differs from the host's on the same prefix")
        ties += int((~clear).sum())
    return {"tokens": seqs.numel(), "ties": ties}


def twins_phase(dev: torch.device, export: dict) -> list[dict]:
    """Import each example twin and call its ``main`` at its defaults on
    the card, with the kernel counts set to 0 just before and read just
    after: ``serve_fpca_cnn_torch.py`` twice, with ``--weights`` (the
    bundle ``fpca_train_phase`` exported) and with ``--precision int8``;
    adaptive_stream's telemetry files go to a temporary directory.  Then
    run each twin again on the host (``--device cpu``, the plain path, one
    bucket-model fit shared with the card run) and hold the card's numbers
    against the host's; serve_lm's greedy tokens are held against the
    host's plain prefill of the same weights, teacher-forced.  Returns one
    row per run: seconds, launches and the comparison."""
    t_phase = time.perf_counter()
    rows = []
    with tempfile.TemporaryDirectory() as tmp, shared_fits() as fit:
        bundle = os.path.join(tmp, "fpca_cnn_export.npz")
        np.savez(bundle, **export)
        runs = [("quickstart", []), ("region_skipping", []), ("serve_frontend", []),
                ("serve_fpca_cnn", ["--weights", bundle]), ("serve_fpca_cnn", ["--precision", "int8"]),
                ("stream_video", []), ("adaptive_stream", ["--telemetry", os.path.join(tmp, "telemetry.jsonl")]),
                ("serve_lm", [])]
        for name, argv in runs:
            mod = load_example(f"{name}_torch")
            if hasattr(mod, "fit_bucket_model"):
                mod.fit_bucket_model = fit
            lm: dict = {}
            if name == "serve_lm":
                init, prompts = mod.init_params, mod.make_prompts
                mod.init_params = lambda cfg, d, seed: lm.setdefault("params", init(cfg, d, seed))
                mod.make_prompts = lambda cfg, *a: lm.setdefault("prompts", (cfg, prompts(cfg, *a)))[1]
            torch.cuda.synchronize()
            _reset_fpca_counts()
            _zero_launch_counts()
            t0 = time.perf_counter()
            res = mod.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches, designs, flash = fpca_conv_cuda.launches, dict(fpca_conv_cuda.designs), flash_attention_cuda.launches
            label = " ".join([f"{name}_torch.py"] + [a if a.startswith("--") else Path(a).name for a in argv])
            print(f"example twin {label}: {seconds:.2f} s, fpca_conv_cuda launches {launches} by design {designs}, "
                  f"flash_attention_cuda launches {flash}")
            _twin_checks(name, res, launches, designs, flash)

            t0 = time.perf_counter()
            if name == "serve_lm":
                cfg, prompts = lm["prompts"]
                cmp = _lm_vs_host(res, cfg, lm["params"], prompts)
            else:
                host_mod = load_example(f"{name}_torch")
                if hasattr(host_mod, "fit_bucket_model"):
                    host_mod.fit_bucket_model = fit
                host_argv = [a.replace("telemetry.jsonl", "telemetry_host.jsonl") for a in argv]
                host = host_mod.main(host_argv + ["--device", "cpu"])
                cmp = twin_vs_host(name, res, host)
                if name == "serve_fpca_cnn":
                    cpu = torch.device("cpu")
                    prog, params = (host_mod.load_export(bundle, cpu) if "--weights" in argv
                                    else host_mod.fresh_network(60, cpu))   # the twin at its default --image-h
                    int8 = "--precision" in argv
                    cmp.update(_cnn_logits_vs_host(res, host, prog.spec, None if int8 else params["head_params"],
                                                   prog.input_scale))
            print(f"  vs its host run ({time.perf_counter() - t0:.1f} s): {cmp}")
            rows.append({"run": label, "seconds": seconds, "fpca_launches": launches, "fpca_designs": designs,
                         "flash_launches": flash, "vs_host": cmp})
    print(f"example twins phase: {time.perf_counter() - t_phase:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# the language-model serving path
# ---------------------------------------------------------------------------


def attention_kind(causal: bool, q: torch.Tensor, k: torch.Tensor) -> str:
    """``flash`` (causal self-attention), ``flash_bidir`` (non-causal, the
    encoder's) or ``flash_cross`` (non-causal, Sq != Sk)."""
    if causal:
        return "flash"
    return "flash_cross" if q.shape[1] != k.shape[1] else "flash_bidir"


@contextlib.contextmanager
def capture_first_calls():
    """Record the inputs of the first flash-attention call of each kind
    (``attention_kind``) and the first SSD intra-chunk call of a run
    (through the module attributes the model looks up at call time); yields
    the dict they land in."""
    seen: dict = {}
    chunked, flash = ssd_ops.ssd_chunked, transformer.flash_attention

    def flash_hook(q, k, v, **kw):
        kw = {"causal": kw.get("causal", True), "window": kw.get("window")}
        seen.setdefault(attention_kind(kw["causal"], q, k), (q, k, v, kw))
        return flash(q, k, v, **kw)

    def intra_hook(xbar, Bh, Ch, cum):
        seen.setdefault("ssd", (xbar, Bh, Ch, cum))
        return ssd_intra_chunk_cuda(xbar, Bh, Ch, cum)

    def chunked_hook(*args, **kw):
        return chunked(*args, intra_chunk=intra_hook, **kw)

    transformer.flash_attention, ssd_ops.ssd_chunked = flash_hook, chunked_hook
    try:
        yield seen
    finally:
        transformer.flash_attention, ssd_ops.ssd_chunked = flash, chunked


def _to(tree: dict, dev: torch.device) -> dict:
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


def live_pairs(sq: int, sk: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the attention mask keeps."""
    i = np.arange(sq)
    hi = np.minimum(i, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(i - window + 1, 0) if window is not None else np.zeros(sq, np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def smoke_vs_host(dev: torch.device, arch: str) -> tuple[float, float]:
    """The kernel path on the card against the host's plain path on the
    narrow smoke config of ``arch`` (f32): a 200-token prefill (past a
    smoke window of 32) and one decode step; returns their max|Δlogit|."""
    small = reduce_for_smoke(ARCHS[arch])
    host = init_model(small, generator=torch.Generator().manual_seed(SEED), device="cpu")
    card = _to(host, dev)
    toks = torch.as_tensor(np.random.default_rng(SEED).integers(0, small.vocab_size, (2, 200)))
    fe = frontend_inputs(small, 2, 150, torch.Generator().manual_seed(SEED), torch.device("cpu"))
    fe_card = None if fe is None else fe.to(dev)
    pos = 200 + (small.frontend_tokens if small.family == "vlm" else 0)
    l_card, c_card = forward_prefill(card, small, toks.to(dev), frontend_embeds=fe_card, max_len=pos + 8)
    l_host, c_host = forward_prefill(host, small, toks, frontend_embeds=fe, max_len=pos + 8)
    nxt = l_host.argmax(-1, keepdim=True)
    d_card, _ = forward_decode(card, small, nxt.to(dev), c_card, pos)
    d_host, _ = forward_decode(host, small, nxt, c_host, pos)
    err_p = float((l_card.cpu() - l_host).abs().max())
    err_d = float((d_card.cpu() - d_host).abs().max())
    print(f"smoke {arch} (f32, {small.n_layers} layers, window {small.window}) card kernels vs host plain: "
          f"prefill max|Δlogit| {err_p:.2e}, decode {err_d:.2e}")
    check(err_p <= SMOKE_TOL and err_d <= SMOKE_TOL, f"smoke {arch} on the card disagrees with the host")
    return err_p, err_d


def profile_serving(arch: str, params: dict, cfg, prompts: torch.Tensor, res: dict, tokens: int,
                    frontend: torch.Tensor | None = None) -> tuple[float, float]:
    """Device time and busy share of one prefill of ``prompts`` (with the
    ``frontend`` embeddings; against the median served prefill of ``res``)
    and of one decode step (against the mean served step), with their split
    by kernel; returns both device times in ms."""
    S = prompts.shape[1] + (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    out: list = []
    prefill_dev, rows = profile_device(lambda: out.append(
        forward_prefill(params, cfg, prompts, frontend_embeds=frontend, max_len=S + tokens + 8)), runs=1)
    prefill_ms = statistics.median(res["prefill_ms"])
    print(f"profile one {arch} prefill: device time {prefill_dev:.1f} ms, busy {prefill_dev / prefill_ms:.1%} of the "
          f"median served prefill ({prefill_ms:.1f} ms)")
    for row in rows:
        print(f"  {row}")
    logits, cache = out.pop()
    nxt = logits.argmax(-1, keepdim=True)
    decode_dev, rows = profile_device(lambda: forward_decode(params, cfg, nxt, cache, S), runs=3)
    step_ms = statistics.median(res["decode_ms"]) / (tokens - 1)
    print(f"profile one {arch} decode step: device time {decode_dev:.2f} ms, busy {decode_dev / step_ms:.1%} of the "
          f"mean served decode step ({step_ms:.2f} ms)")
    for row in rows:
        print(f"  {row}")
    return prefill_dev, decode_dev


def lm_phase(dev: torch.device, smi: str) -> list[dict]:
    """Serve zamba2-7b at full width; check and time its two kernels."""
    # ---- 10a. the kernel path against the host's plain path, smoke config ----
    smoke_vs_host(dev, LM_ARCH)

    # ---- 8. init at full width ---------------------------------------------
    cfg = ARCHS[LM_ARCH]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_model(cfg, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{LM_ARCH} init on the card: {time.perf_counter() - t0:.2f} s, {n_params:,} parameters "
          f"(analytic count without norms and biases {cfg.param_count():,}), {cfg.dtype}, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    check(cfg.d_model == 3584 and cfg.n_layers == 81, "zamba2-7b is served at full width")
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (LM_REQUESTS, LM_PROMPT))

    # warm-up prefill (first-call costs out of the timing) that captures one
    # attention application's q/k/v and one Mamba2 layer's SSD inputs
    with capture_first_calls() as seen:
        logits, _cache = forward_prefill(params, cfg, torch.as_tensor(prompts[:LM_BATCH], device=dev))
        torch.cuda.synchronize()
    del logits, _cache

    # ---- 9. the main path, with the launch counts ----------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    flash_attention_cuda.launches = 0
    flash_attention_cuda.designs = dict.fromkeys(flash_attention_cuda.designs, 0)
    ssd_intra_chunk_cuda.launches = 0
    ssd_intra_chunk_cuda.designs = dict.fromkeys(ssd_intra_chunk_cuda.designs, 0)
    res = serve(params, cfg, prompts, batch=LM_BATCH, tokens=LM_TOKENS, device=dev)
    launches = {"flash_attention": flash_attention_cuda.launches,
                "ssd_intra_chunk": ssd_intra_chunk_cuda.launches}
    fwd_designs, ssd_designs = dict(flash_attention_cuda.designs), dict(ssd_intra_chunk_cuda.designs)
    for i, p_ms in enumerate(res["prefill_ms"]):
        print(f"wave {i}: prefill {p_ms:.1f} ms ({LM_BATCH}x{LM_PROMPT} tokens), {LM_TOKENS - 1} decode steps "
              f"{res['decode_ms'][i]:.1f} ms, launches (flash, ssd) per prefill {res['prefill_launches'][i]}, "
              f"in decode {res['decode_launches'][i]}")
    print(f"served {LM_REQUESTS} requests x {LM_TOKENS} tokens on {smi}: decode {res['decode_tok_s']:.1f} tok/s, "
          f"end to end {res['e2e_tok_s']:.1f} tok/s, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; launches {launches}, flash designs {fwd_designs}, "
          f"ssd designs {ssd_designs}")
    check(fwd_designs["wgmma"] == launches["flash_attention"],
          f"flash launches by design {fwd_designs}: every served (bf16) launch must take the tensor-core design")
    check(ssd_designs["wgmma"] == launches["ssd_intra_chunk"],
          f"ssd launches by design {ssd_designs}: every served launch (q=128, p=n=64) must take the tensor-core design")
    n_groups = cfg.n_layers // cfg.hybrid_attn_period
    for i in range(len(res["prefill_ms"])):
        check(res["prefill_launches"][i] == (n_groups, cfg.n_layers),
              f"wave {i}: (flash, ssd) launches per prefill {res['prefill_launches'][i]}, "
              f"expected ({n_groups}, {cfg.n_layers})")
        check(res["decode_launches"][i] == (0, 0), f"wave {i}: kernel launches in decode")
    seqs = res["sequences"]
    check(seqs.shape == (LM_REQUESTS, LM_TOKENS), f"sequences {seqs.shape}")
    check(int(seqs.min()) >= 0 and int(seqs.max()) < cfg.vocab_size, "generated tokens out of range")
    check(res["finite"], "non-finite logits")

    # ---- 10b. each kernel against its plain version at the served shapes ----
    q, k, v, kw = seen["flash"]
    got = flash_attention_cuda(q, k, v, causal=kw["causal"], window=kw["window"])
    want = attend_blockwise(q, k, v, causal=kw["causal"], window=kw["window"])
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    flash_err = float(diff.max())
    flash_ok = bool((diff <= FLASH_ATOL + FLASH_RTOL * want.float().abs()).all())
    print(f"flash kernel vs plain blockwise at q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}: "
          f"max|Δ| {flash_err:.3e}")
    check(flash_ok, "flash kernel disagrees with its plain version beyond one bf16 ulp")
    del got, want, diff
    xbar, Bh, Ch, cum = seen["ssd"]
    y, st, dec = ssd_intra_chunk_cuda(xbar, Bh, Ch, cum)
    y_r, st_r, dec_r = ssd_intra_chunk_ref(xbar, Bh, Ch, cum)
    torch.cuda.synchronize()
    ssd_err = max(float((y - y_r).abs().max()), float((st - st_r).abs().max()))
    rel = max(float((y - y_r).abs().max()) / float(y_r.abs().max()),
              float((st - st_r).abs().max()) / float(st_r.abs().max()))
    y_s, st_s = simt_ssd(xbar, Bh, Ch, cum)
    torch.cuda.synchronize()
    rel_s = max(float((y_s - y_r).abs().max()) / float(y_r.abs().max()),
                float((st_s - st_r).abs().max()) / float(st_r.abs().max()))
    print(f"ssd kernel ({ssd_kernel.design(xbar, Bh, Ch)} design) vs plain at xbar {tuple(xbar.shape)}, B/C head "
          f"stride {Bh.stride(3)}: max|Δ| {ssd_err:.3e}, normwise {rel:.2e} (limit {SSD_NORMWISE}); the SIMT design "
          f"there: normwise {rel_s:.2e}; chunk_decay bit-equal {torch.equal(dec, dec_r)}")
    check(ssd_kernel.design(xbar, Bh, Ch) == "wgmma", "the served SSD inputs must take the tensor-core design")
    check(rel <= SSD_NORMWISE and torch.equal(dec, dec_r), "ssd kernel disagrees with its plain version")
    check(rel_s <= SSD_NORMWISE, "the SSD kernel's SIMT design disagrees with its plain version")
    del y, st, dec, y_r, st_r, dec_r, y_s, st_s

    # ---- 11. timings, bounds, library yardstick, profile ----------------------
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    flash_ms = time_cuda(lambda: flash_attention_cuda(q, k, v, causal=kw["causal"], window=kw["window"]))
    flash_plain_ms = time_cuda(lambda: attend_blockwise(q, k, v, causal=kw["causal"], window=kw["window"]),
                               iters=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa_ms = time_cuda(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=H != KV))
    f_bytes = q.element_size() * (2 * B * Sq * H * D + 2 * B * Sk * KV * D)
    f_pairs = B * H * live_pairs(Sq, Sk, kw["causal"], kw["window"])
    f_ops = 4 * D * f_pairs
    f_tb, f_to = f_bytes / PEAK_BYTES_PER_S * 1e3, f_ops / PEAK_BF16_FLOP_PER_S * 1e3
    f_rate = flash_rates(flash_ms, f_ops, f_pairs, D)
    print(f"flash at B={B} S={Sq} H={H} KV={KV} D={D} {q.dtype} on {smi}: kernel {flash_ms:.4f} ms, plain "
          f"{flash_plain_ms:.4f} ms, sdpa {sdpa_ms:.4f} ms, bound {max(f_tb, f_to):.4f} ms "
          f"(bytes {f_tb:.4f}, bf16 ops {f_to:.4f}); achieved {f_rate[0]:.1f} TFLOP/s on the required FLOP, "
          f"{f_rate[1]:.1f} on the executed FLOP")

    b, nc, Q, Hs, P = xbar.shape
    N, G = Bh.shape[-1], cfg.ssm_groups
    ssd_ms = time_cuda(lambda: ssd_intra_chunk_cuda(xbar, Bh, Ch, cum))
    ssd_simt_ms = time_cuda(lambda: simt_ssd(xbar, Bh, Ch, cum))
    ssd_plain_ms = time_cuda(lambda: ssd_intra_chunk_ref(xbar, Bh, Ch, cum), iters=5)
    s_bytes = 4 * (2 * b * nc * Q * Hs * P + b * nc * Q * Hs + 2 * b * nc * Q * G * N + b * nc * Hs * P * N)
    # cb = C Bᵀ and (cb∘L) xbar need only the causal j <= i half (Q(Q+1)/2
    # pairs, 2 flops each per N or P); the chunk state is a full Q-term product
    s_ops = b * nc * Hs * (Q * (Q + 1) * N + Q * (Q + 1) * P + 2 * Q * N * P)
    # the tensor-core design runs those products as six bf16 passes at the
    # bf16 peak; the f32 CUDA-core figure is the bound PRs 12-15 stated
    s_tb = s_bytes / PEAK_BYTES_PER_S * 1e3
    s_tt = SSD_PASSES * s_ops / PEAK_BF16_FLOP_PER_S * 1e3
    s_tf = s_ops / PEAK_FP32_FLOP_PER_S * 1e3
    print(f"ssd at b={b} nc={nc} Q={Q} H={Hs} P={P} N={N} G={G} on {smi}: kernel "
          f"({ssd_kernel.design(xbar, Bh, Ch)}) {ssd_ms:.4f} ms, SIMT design {ssd_simt_ms:.4f} ms, plain "
          f"{ssd_plain_ms:.4f} ms, bound {max(s_tb, s_tt):.4f} ms (bytes {s_bytes / 1e9:.3f} GB: {s_tb:.4f}; "
          f"{SSD_PASSES} bf16 passes of {s_ops:.3e} FLOP: {s_tt:.4f}; as f32 on CUDA cores: {s_tf:.4f}); "
          f"achieved {s_bytes / ssd_ms / 1e6:.1f} GB/s, {100 * max(s_tb, s_tt) / ssd_ms:.1f}% of the bound")
    del seen, q, k, v, qt, kt, vt, xbar, Bh, Ch, cum

    profile_serving(LM_ARCH, params, cfg, torch.as_tensor(prompts[:LM_BATCH], device=dev), res, LM_TOKENS)
    del params   # zamba2's weights: the dense serving and training phases need the room

    return [
        {
            "name": "flash_attention",
            "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:33",
            "launches": launches["flash_attention"],
            "max_abs_err": flash_err,
            "ms": flash_ms,
            "plain_ms": flash_plain_ms,
            "bound_ms": max(f_tb, f_to),
            "bound_by": "bytes" if f_tb >= f_to else "operations",
            "library_ms": sdpa_ms,
            "tflops_required": f_rate[0],
            "tflops_executed": f_rate[1],
        },
        {
            "name": "ssd_intra_chunk",
            "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_intra_chunk.cu",
            "replaces": "src/repro/kernels/ssd/kernel.py:29",
            "launches": launches["ssd_intra_chunk"],
            "max_abs_err": ssd_err,
            "ms": ssd_ms,
            "plain_ms": ssd_plain_ms,
            "bound_ms": max(s_tb, s_tt),
            "bound_by": "bytes" if s_tb >= s_tt else "operations",
            "simt_ms": ssd_simt_ms,
            "gb_per_s": s_bytes / ssd_ms / 1e6,
            # no single PyTorch call computes the masked intra-chunk contraction
            "library_ms": None,
        },
    ]


# ---------------------------------------------------------------------------
# dense LM serving (qwen3-1.7b, h2o-danube-1.8b) through the flash kernel
# ---------------------------------------------------------------------------


def library_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None) -> tuple:
    """One PyTorch call computing the causal (windowed) GQA attention of
    ``q``/``k``/``v`` (B, S, H, D) that, like the kernel, skips the masked
    blocks; returns (its name, the call).  Without a window, SDPA's causal
    GQA form (its flash backend skips the blocks above the diagonal).  With
    one, ``flex_attention`` compiled with a sliding-window block mask: SDPA
    takes no window, and a dense band mask makes it compute every pair.  The
    block mask is built and the call compiled here, outside the timed call."""
    F = torch.nn.functional
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    H, KV, S = q.shape[2], k.shape[2], q.shape[1]
    if window is None:
        return "sdpa", lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=H != KV)
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    def band(b, h, qi, ki):
        return (qi >= ki) & (qi - ki < window)

    mask = create_block_mask(band, None, None, S, k.shape[1], device=q.device)
    flex = torch.compile(flex_attention, dynamic=False)
    flex(qt, kt, vt, block_mask=mask, enable_gqa=H != KV)
    return "flex_attention", lambda: flex(qt, kt, vt, block_mask=mask, enable_gqa=H != KV)


def cache_ulps(cache: dict, ref: dict) -> float:
    """The largest difference between a decode's cache and a fresh
    prefill's of the same tokens and layout (every leaf of ``layers``: K/V,
    or Mamba2's conv and SSM states), in bf16 ulps of the prefill layer's
    max|value| (each layer and leaf apart)."""
    worst = 0.0
    for name, stack in ref["layers"].items():
        for a, b in zip(cache["layers"][name], stack):
            worst = max(worst, float((a.float() - b.float()).abs().max()) / bf16_ulps(float(b.float().abs().max()), 1))
    return worst


@contextlib.contextmanager
def moe_calls():
    """Record each MoE FFN call of a run (through the module attribute the
    model looks up at call time): its (batch, tokens) and its drop
    fraction; yields the list."""
    calls: list = []
    real = transformer.moe

    def hook(p, x, cfg, **kw):
        y, aux = real(p, x, cfg, **kw)
        calls.append({"shape": tuple(x.shape[:2]), "drop": aux["moe_drop_frac"]})
        return y, aux

    transformer.moe = hook
    try:
        yield calls
    finally:
        transformer.moe = real


def decode_vs_prefill(params: dict, cfg, prompts: torch.Tensor, gen: torch.Tensor, steps: tuple, *,
                      frontend: torch.Tensor | None = None, served: bool = True,
                      ulps: tuple[float, float] = (DECODE_ULPS, CACHE_ULPS), control_logits: bool = True) -> dict:
    """Prefill ``prompts`` (B, S) (with ``frontend``'s patches or frames),
    then decode the served greedy tokens ``gen`` (B, T) teacher-forced; at
    each step in ``steps`` hold the decode logits against a fresh prefill of
    the prompt plus ``gen[:, :step + 1]`` (within ``ulps[0]`` bf16 ulps of
    its max|logit| in bf16, F32_RTOL of it in f32; its greedy token wherever
    the top-2 margin exceeds twice that).  With ``served`` (the params,
    config and rows the tokens were served with) every greedy token of the
    prefill and of each decode step must equal the served one.  After the
    last step, the decode's cache (every K/V slot it wrote, the ring past a
    window; Mamba2's states) against the fresh prefill's, within ``ulps[1]``
    bf16 ulps (F32_RTOL in f32); and a control that must leave the cache
    bound and, with ``control_logits``, the logit bound: a decode step at a
    position off by one (its RoPE and its cache slot), or for an ssm, which
    has no position, a step fed the next token."""
    S, T = prompts.shape[1], gen.shape[1]
    off = cfg.frontend_tokens if cfg.family == "vlm" else 0
    max_len = off + S + T + 8
    f32 = cfg.dtype == "float32"

    def prefill(toks):
        return forward_prefill(params, cfg, toks, frontend_embeds=frontend, max_len=max_len)

    def bound(top: float) -> float:
        return F32_RTOL * top if f32 else bf16_ulps(top, ulps[0])

    logits, cache = prefill(prompts)
    check(not served or torch.equal(logits.argmax(-1), gen[:, 0].long()),
          "the prefill's greedy tokens differ from the served ones")
    kept, out = {}, {}
    for i in range(T - 1):
        logits, cache = forward_decode(params, cfg, gen[:, i : i + 1].long(), cache, off + S + i)
        check(not served or torch.equal(logits.argmax(-1), gen[:, i + 1].long()),
              f"decode step {i}: greedy tokens differ from the served ones")
        if i in steps:
            kept[i] = logits.clone()
    for i in steps:
        ref, ref_cache = prefill(torch.cat([prompts, gen[:, : i + 1].long()], 1))
        top = float(ref.abs().max())
        tol = bound(top)
        err = float((kept[i] - ref).abs().max())
        top2 = ref.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
        same = kept[i].argmax(-1) == ref.argmax(-1)
        print(f"decode step {i} (position {off + S + i + 1}) vs a fresh prefill of {off + S + i + 1} positions "
              f"({'f32' if f32 else 'bf16'}): max|Δlogit| {err:.4g} (limit {tol:.4g}: "
              f"{'F32_RTOL' if f32 else f'{ulps[0]:g} bf16 ulps'} of max|logit| {top:.3f}); "
              f"greedy tokens equal in {int(same.sum())}/{same.numel()}, margin > {2 * tol:.4g} in {int(clear.sum())}")
        check(err <= tol, f"decode step {i} leaves the bound against a fresh prefill")
        check(bool(same[clear].all()), f"decode step {i}: a greedy token with a clear margin differs from the prefill's")
        out[i] = {"max_abs_err": err, "tol": tol, "greedy_equal": int(same.sum()), "clear_margin": int(clear.sum())}
        if i == T - 2:
            out["cache_err"] = cache_ulps(cache, ref_cache)
            del cache
        if i == 0:
            _, ctl = prefill(prompts)
            if cfg.family == "ssm":
                ctl_logits, ctl = forward_decode(params, cfg, gen[:, 1:2].long(), ctl, off + S)
            else:
                ctl_logits, ctl = forward_decode(params, cfg, gen[:, :1].long(), ctl, off + S + 1)
            out["control"] = {"cache_err": cache_ulps(ctl, ref_cache),
                              "max_abs_err": float((ctl_logits - ref).abs().max())}
            del ctl, ctl_logits
        del ref_cache
    ctl = out["control"]
    cache_tol = F32_RTOL / 2.0**-7 if f32 else ulps[1]
    what = "a step fed the next token" if cfg.family == "ssm" else f"one decode step at position {off + S + 1}"
    print(f"decode's cache after {T - 1} steps vs a fresh prefill's: {out['cache_err']:.3g} bf16 ulps of each layer's "
          f"max|value| (limit {cache_tol:.3g}); control, {what}: cache {ctl['cache_err']:.1f} ulps, max|Δlogit| "
          f"{ctl['max_abs_err']:.4g} (logit limit {out[steps[0]]['tol']:.4g}"
          f"{'' if control_logits else ', which this check cannot hold the control to'})")
    check(out["cache_err"] <= cache_tol, "the decode's cache leaves the bound against a fresh prefill's")
    check(ctl["cache_err"] > cache_tol and (ctl["max_abs_err"] > out[steps[0]]["tol"] or not control_logits),
          "the cache or the logit check cannot see a wrong decode step")
    out["cache_ulps"] = out["cache_err"]
    return out


def dense_phase(dev: torch.device, smi: str, arch: str, n_requests: int, batch: int, prompt: int,
                tokens: int) -> dict:
    """Serve a dense decoder at full width and depth through
    ``launch.serve``; check one flash launch per layer per prefill, all on
    the tensor-core design, none in decode; decode against a fresh prefill;
    the flash kernel against its plain version on inputs captured from a
    served prefill; time it beside its bound and the library call, and profile a
    prefill and a decode step."""
    t_phase = time.perf_counter()
    step = Laps()
    smoke_err = smoke_vs_host(dev, arch)
    step("smoke")

    # ---- init at full width and depth, warm-up prefill capturing q/k/v ----
    cfg = ARCHS[arch]
    params = init_model(cfg, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{arch} on the card: {n_params:,} parameters ({cfg.dtype}), {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}:{cfg.n_kv_heads} heads of {cfg.head_dim}, window {cfg.window}")
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (n_requests, prompt))
    with capture_first_calls() as seen:
        logits, _cache = forward_prefill(params, cfg, torch.as_tensor(prompts[:batch], device=dev))
        torch.cuda.synchronize()
    del logits, _cache
    step("init")

    # ---- the main path, with the launch counts -------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_launch_counts()
    ssd_intra_chunk_cuda.launches = 0
    res = serve(params, cfg, prompts, batch=batch, tokens=tokens, device=dev)
    launches, designs = flash_attention_cuda.launches, dict(flash_attention_cuda.designs)
    peak = torch.cuda.max_memory_allocated(dev)
    for i, p_ms in enumerate(res["prefill_ms"]):
        print(f"{arch} wave {i}: prefill {p_ms:.1f} ms ({batch}x{prompt} tokens), {tokens - 1} decode steps "
              f"{res['decode_ms'][i]:.1f} ms, launches (flash, ssd) per prefill {res['prefill_launches'][i]}, "
              f"in decode {res['decode_launches'][i]}")
    print(f"served {arch}: {n_requests} requests x {tokens} tokens on {smi}: decode {res['decode_tok_s']:.1f} tok/s, "
          f"end to end {res['e2e_tok_s']:.1f} tok/s, max_memory_allocated {peak / 2**30:.2f} GiB; flash launches "
          f"{launches} by design {designs}")
    check(designs["wgmma"] == launches, f"{arch}: flash launches by design {designs}, every served (bf16) launch "
          "must take the tensor-core design")
    for i in range(len(res["prefill_ms"])):
        check(res["prefill_launches"][i] == (cfg.n_layers, 0),
              f"{arch} wave {i}: (flash, ssd) launches per prefill {res['prefill_launches'][i]}, "
              f"expected ({cfg.n_layers}, 0)")
        check(res["decode_launches"][i] == (0, 0), f"{arch} wave {i}: kernel launches in decode")
    seqs = res["sequences"]
    check(seqs.shape == (n_requests, tokens), f"{arch}: sequences {seqs.shape}")
    check(int(seqs.min()) >= 0 and int(seqs.max()) < cfg.vocab_size, f"{arch}: generated tokens out of range")
    check(res["finite"], f"{arch}: non-finite logits")
    step("serve")

    # ---- decode against a fresh prefill (one wave) ---------------------------
    dvp = decode_vs_prefill(params, cfg, torch.as_tensor(prompts[:batch], device=dev),
                            torch.as_tensor(seqs[:batch], device=dev), steps=(0, tokens - 2))
    step("decode vs prefill")

    # ---- the kernel against its plain version, timed beside its bound --------
    q, k, v, kw = seen.pop("flash")
    check(kw["window"] == cfg.window and kw["causal"], f"{arch}: captured flash call {kw}")
    check(flash_fwd.design(q, k, v) == "wgmma", f"{arch}: the served q/k/v must take the tensor-core design")
    got = flash_attention_cuda(q, k, v, causal=True, window=cfg.window)
    want = attend_blockwise(q, k, v, causal=True, window=cfg.window)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    flash_err = float(diff.max())
    print(f"flash kernel vs plain blockwise at q {tuple(q.shape)} k {tuple(k.shape)} window {cfg.window}: "
          f"max|Δ| {flash_err:.3e}")
    check(bool((diff <= FLASH_ATOL + FLASH_RTOL * want.float().abs()).all()),
          f"{arch}: flash kernel disagrees with its plain version beyond one bf16 ulp")
    lib_name, lib = library_attention(q, k, v, cfg.window)
    lib_err = float((lib().transpose(1, 2).float() - want.float()).abs().max())
    del got, want, diff
    B, S, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    ms = time_cuda(lambda: flash_attention_cuda(q, k, v, causal=True, window=cfg.window))
    plain_ms = time_cuda(lambda: attend_blockwise(q, k, v, causal=True, window=cfg.window), iters=5)
    lib_ms = time_cuda(lib)
    ms2 = time_cuda(lambda: flash_attention_cuda(q, k, v, causal=True, window=cfg.window))
    f_bytes = q.element_size() * (2 * B * S * H * D + 2 * B * Sk * KV * D)
    pairs = B * H * live_pairs(S, Sk, True, cfg.window)
    f_ops = 4 * D * pairs
    f_tb, f_to = f_bytes / PEAK_BYTES_PER_S * 1e3, f_ops / PEAK_BF16_FLOP_PER_S * 1e3
    rate = flash_rates(statistics.median([ms, ms2]), f_ops, pairs, D)
    print(f"flash at {arch}'s served shape B={B} S={S} H={H} KV={KV} D={D} window {cfg.window} {q.dtype} on {smi}: "
          f"kernel {ms:.4f} / {ms2:.4f} ms, plain {plain_ms:.4f} ms, {lib_name} {lib_ms:.4f} ms (max|Δ| vs plain "
          f"{lib_err:.3e}), bound {max(f_tb, f_to):.4f} ms (bytes {f_tb:.4f}, bf16 ops {f_to:.4f}); achieved "
          f"{rate[0]:.1f} TFLOP/s on the required FLOP, {rate[1]:.1f} on the executed FLOP (head dim padded to "
          f"{64 if D <= 64 else 128})")
    del q, k, v, lib, seen
    step("kernel")

    device_ms, dec_ms = profile_serving(arch, params, cfg, torch.as_tensor(prompts[:batch], device=dev), res, tokens)
    del params
    step("profile")
    seconds = step.report(f"{arch} serving phase")
    print(f"{arch} serving phase: {time.perf_counter() - t_phase:.1f} s")
    return {
        "launches": launches,
        "designs": designs,
        "shape": {"B": B, "S": S, "H": H, "KV": KV, "D": D, "window": cfg.window},
        "max_abs_err": flash_err,
        "ms": statistics.median([ms, ms2]),
        "plain_ms": plain_ms,
        "bound_ms": max(f_tb, f_to),
        "bound_by": "bytes" if f_tb >= f_to else "operations",
        "library_ms": lib_ms,
        "library": lib_name,
        "tflops_required": rate[0],
        "tflops_executed": rate[1],
        "prefill_ms": res["prefill_ms"],
        "decode_tok_s": res["decode_tok_s"],
        "e2e_tok_s": res["e2e_tok_s"],
        "peak_bytes": peak,
        "prefill_device_ms": device_ms,
        "decode_step_device_ms": dec_ms,
        "decode_vs_prefill": dvp,
        "smoke_err": smoke_err,
        "seconds_by_step": seconds,
    }


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def capture_first_backward():
    """Record the inputs ``(q, k, v, out, lse, dO)`` of the first causal
    flash backward of a run (``bwd``) and of the first of each non-causal
    kind (``bwd_flash_bidir``, ``bwd_flash_cross``: ``attention_kind``),
    through the module attribute ``FlashAttention`` looks up at call time;
    yields the dict they land in."""
    seen: dict = {}
    real = flash_bwd.flash_attention_bwd_cuda

    def hook(q, k, v, out, lse, do, **kw):
        key = "bwd" if kw["causal"] else f"bwd_{attention_kind(False, q, k)}"
        seen.setdefault(key, (q, k, v, out, lse, do, kw))
        return real(q, k, v, out, lse, do, **kw)

    flash_bwd.flash_attention_bwd_cuda = hook
    try:
        yield seen
    finally:
        flash_bwd.flash_attention_bwd_cuda = real


FLASH_KERNELS = (flash_attention_cuda, flash_attention_dq_cuda, flash_attention_dkdv_cuda)


def _launch_counts() -> tuple[int, int, int]:
    return tuple(fn.launches for fn in FLASH_KERNELS)


def _wgmma_counts() -> tuple[int, int, int]:
    """Launches of the forward, dQ and dK/dV kernels that took the tensor-core design."""
    return tuple(fn.designs["wgmma"] for fn in FLASH_KERNELS)


def _zero_launch_counts() -> None:
    for fn in FLASH_KERNELS:
        fn.launches = 0
        fn.designs = dict.fromkeys(fn.designs, 0)


def flash_rates(ms: float, required: float, pairs: int, d: int) -> tuple[float, float]:
    """TFLOP/s of a flash forward on the required FLOP and on the FLOP its
    tensor-core design executes: 3 passes (s, p_hi v, p_lo v) of 2 DP a
    live pair, the head dim padded to DP = 64 or 128."""
    dp = 64 if d <= 64 else 128
    return required / ms / 1e9, 6 * dp * pairs / ms / 1e9


def bf16_ulps(top: float, n: int = 2) -> float:
    return n * 2.0 ** (np.floor(np.log2(top)) - 7)


def train_phase(dev: torch.device, smi: str) -> tuple[list[dict], dict]:
    """Train qwen3-1.7b at full width; check and time the backward kernels
    (their ``kernels`` entries) and the forward at the trained shape (the
    flash entry's ``trained`` numbers)."""
    # ---- 12. the kernel path against the host's plain path, smoke config ----
    small = reduce_for_smoke(ARCHS[TRAIN_ARCH])
    host = init_model(small, generator=torch.Generator().manual_seed(SEED), device="cpu")
    card = _to(host, dev)
    rng = np.random.default_rng(SEED)
    batch = {k: torch.as_tensor(rng.integers(0, small.vocab_size, (2, 200))) for k in ("tokens", "labels")}
    host_leaves = [p.requires_grad_() for p in tree_leaves(host)]
    card_leaves = [p.requires_grad_() for p in tree_leaves(card)]
    for remat in ("none", "full"):
        want_loss, _ = forward_train(host, small, batch, remat=remat)
        want = torch.autograd.grad(want_loss, host_leaves)
        loss, _ = forward_train(card, small, {k: v.to(dev) for k, v in batch.items()}, remat=remat)
        got = torch.autograd.grad(loss, card_leaves)
        loss_err = abs(float(loss.detach()) - float(want_loss.detach()))
        grad_err = max(float((x.cpu() - w).abs().max()) / float(w.abs().max()) for x, w in zip(got, want))
        print(f"smoke {TRAIN_ARCH} (f32, 2 layers) training, remat {remat}, card kernels vs host plain: "
              f"|Δloss| {loss_err:.2e}, gradients max|Δ|/max|value| {grad_err:.2e}")
        check(loss_err <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL,
              f"smoke training (remat {remat}) on the card disagrees with the host")
    del host, card, host_leaves, card_leaves, got, want, loss, want_loss

    # ---- 13. init at full width, 4 steps ----------------------------------
    cfg = ARCHS[TRAIN_ARCH]
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.vocab_size)
          == (28, 2048, 16, 8, 128, 151936), f"{TRAIN_ARCH} is trained at full width and depth")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_model(cfg, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    opt_state = init_adamw(params)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"{TRAIN_ARCH} init on the card: {time.perf_counter() - t0:.2f} s, {n_params:,} parameters "
          f"(analytic count without norms {cfg.param_count():,}), {cfg.dtype}, AdamW state f32; "
          f"max_memory_allocated {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    step_fn = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=TRAIN_STEPS),
                              n_micro=TRAIN_MICRO, remat=TRAIN_REMAT)
    stream = SyntheticLM(LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH, seed=SEED))
    batches = [{k: torch.as_tensor(v, dtype=torch.long, device=dev) for k, v in stream.batch_at(i).items()}
               for i in range(TRAIN_STEPS + 1)]
    # per step: every layer's flash forward runs twice per microbatch (once
    # in the forward, once when full remat recomputes the block inside the
    # backward), dQ and dK/dV once each per layer and microbatch
    per_step = (2 * cfg.n_layers * TRAIN_MICRO, cfg.n_layers * TRAIN_MICRO, cfg.n_layers * TRAIN_MICRO)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    step_ms = []
    _zero_launch_counts()
    with capture_first_backward() as seen:
        for i in range(TRAIN_STEPS):
            before, wgmma_before = _launch_counts(), _wgmma_counts()
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batches[i])
            loss, gnorm, lr = (float(metrics[k]) for k in ("loss", "grad_norm", "lr"))   # synchronises
            step_ms.append((time.perf_counter() - t0) * 1e3)
            launched = tuple(a - b for a, b in zip(_launch_counts(), before))
            on_tensor_cores = tuple(a - b for a, b in zip(_wgmma_counts(), wgmma_before))
            print(f"train step {i + 1}: loss {loss:.4f} grad_norm {gnorm:.4f} lr {lr:.2e} "
                  f"{step_ms[-1]:.1f} ms/step {tokens / step_ms[-1] * 1e3:.0f} tokens/s, "
                  f"launches (flash fwd, dq, dkdv) {launched}, of which wgmma {on_tensor_cores}")
            check(np.isfinite(loss) and np.isfinite(gnorm), f"step {i + 1}: loss {loss}, grad_norm {gnorm}")
            check(launched == per_step, f"step {i + 1}: launches {launched}, expected {per_step}")
            check(on_tensor_cores == per_step,
                  f"step {i + 1}: {on_tensor_cores} fwd / dq / dkdv launches took the tensor-core design, "
                  f"expected all")
    launches = dict(zip(("flash_fwd", "dq", "dkdv"), _launch_counts()))
    steady_ms = statistics.median(step_ms[1:])
    mfu = 6 * n_params * tokens / (steady_ms / 1e3) / PEAK_BF16_FLOP_PER_S
    print(f"trained {TRAIN_ARCH} {TRAIN_STEPS} steps of {TRAIN_BATCH}x{TRAIN_SEQ} tokens (n_micro {TRAIN_MICRO}, "
          f"remat {TRAIN_REMAT}) on {smi}: median of steps 2-{TRAIN_STEPS} {steady_ms:.1f} ms/step, "
          f"{tokens / steady_ms * 1e3:.0f} tokens/s, mfu {mfu:.4f} (6 N tokens / step time / 989 TFLOP/s), "
          f"max_memory_allocated {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; launches {launches}")

    # ---- 14e. profile one step ---------------------------------------------
    device_ms, rows = profile_device(lambda: float(step_fn(params, opt_state, batches[TRAIN_STEPS])[2]["loss"]),
                                     runs=1)
    print(f"profile one train step: device time {device_ms:.1f} ms, busy {device_ms / steady_ms:.1%} of the "
          f"median step ({steady_ms:.1f} ms)")
    for row in rows:
        print(f"  {row}")
    del params, opt_state, metrics, batches, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 14c. the kernels against the plain version at the trained shape ---
    *captured, kw = seen["bwd"]
    q, k, v, out, lse, do = (t.detach() for t in captured)   # no graph for the checks and timings
    causal, window = kw["causal"], kw["window"]
    del seen, captured
    out2, lse2 = flash_attention_cuda(q, k, v, causal=causal, window=window, return_lse=True)
    out_r, lse_r = attend_blockwise(q, k, v, causal=causal, window=window, return_lse=True)
    torch.cuda.synchronize()
    diff = (out2.float() - out_r.float()).abs()
    fwd_err = float(diff.max())
    fwd_ok = bool((diff <= FLASH_ATOL + FLASH_RTOL * out_r.float().abs()).all())
    lse_err = float((lse2 - lse_r).abs().max())
    print(f"forward kernel vs plain blockwise at the trained shape q {tuple(q.shape)} k {tuple(k.shape)} "
          f"{q.dtype}: out max|Δ| {fwd_err:.3e} (max|value| {float(out_r.float().abs().max()):.3e}), "
          f"lse max|Δ| {lse_err:.3e}")
    check(torch.equal(out2, out), "two forward launches on the same inputs differ")
    # how far the design change alone moves the trained path's forward
    out_s, lse_s = simt_forward(q, k, v, causal=causal, window=window)
    print(f"forward SIMT design vs tensor-core design at the trained shape: out differs in "
          f"{int((out_s != out2).sum())} of {out2.numel()} elements, max|Δ| "
          f"{float((out_s.float() - out2.float()).abs().max()):.3e}; lse max|Δ| "
          f"{float((lse_s - lse2).abs().max()):.3e}")
    del out_s, lse_s
    check(fwd_ok, "forward kernel disagrees with its plain version beyond one bf16 ulp at the trained shape")
    check(lse_err <= LSE_TOL * float(lse_r.abs().max()),
          f"forward LSE disagrees with its plain version (max|Δ| {lse_err:.3e})")
    del out2, lse2, out_r, lse_r, diff
    delta = attention_delta(out, do)
    dq = flash_attention_dq_cuda(q, k, v, do, lse, delta, causal=causal, window=window)
    dk, dv = flash_attention_dkdv_cuda(q, k, v, do, lse, delta, causal=causal, window=window)
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    errs = {}
    for name, x, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        top = float(w.float().abs().max())
        errs[name] = float((x.float() - w.float()).abs().max())
        print(f"{name} kernel vs plain at q {tuple(q.shape)} k {tuple(k.shape)} {q.dtype}: max|Δ| "
              f"{errs[name]:.3e}, max|value| {top:.3e}, two bf16 ulps {bf16_ulps(top):.3e}")
        check(x.dtype == w.dtype and errs[name] <= bf16_ulps(top),
              f"{name} kernel disagrees with its plain version beyond two bf16 ulps of max|value|")
    del dq, dk, dv, want

    # ---- 14d. timings, bounds, library yardstick ----------------------------
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dq_ms = time_cuda(lambda: flash_attention_dq_cuda(q, k, v, do, lse, delta, causal=causal, window=window))
    dkdv_ms = time_cuda(lambda: flash_attention_dkdv_cuda(q, k, v, do, lse, delta, causal=causal, window=window))
    plain_ms = time_cuda(lambda: flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal, window=window),
                         iters=5)
    fwd_ms = time_cuda(lambda: flash_attention_cuda(q, k, v, causal=causal, window=window, return_lse=True))
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=H != KV)
    dot = do.transpose(1, 2)
    sdpa_bwd_ms = time_cuda(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot, retain_graph=True))
    with torch.no_grad():
        sdpa_fwd_ms = time_cuda(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=H != KV))
    pairs = B * H * live_pairs(Sq, Sk, causal, window)
    el = q.element_size()
    in_bytes = el * (2 * B * Sq * H * D + 2 * B * Sk * KV * D) + 4 * 2 * B * H * Sq   # q, dO, k, v, lse, delta
    bounds = {}
    for name, ops, out_bytes in (("dq", 6 * D * pairs, el * B * Sq * H * D),
                                 ("dkdv", 8 * D * pairs, el * 2 * B * Sk * KV * D)):
        tb = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
        to = ops / PEAK_BF16_FLOP_PER_S * 1e3
        bounds[name] = (max(tb, to), "bytes" if tb >= to else "operations", tb, to, ops)
    print(f"flash backward at B={B} S={Sq} H={H} KV={KV} D={D} {q.dtype} causal on {smi}: dq kernel {dq_ms:.4f} ms "
          f"(bound {bounds['dq'][0]:.4f}: bytes {bounds['dq'][2]:.4f}, bf16 ops {bounds['dq'][3]:.4f}, "
          f"{bounds['dq'][4]:.3e} FLOP), dkdv kernel {dkdv_ms:.4f} ms (bound {bounds['dkdv'][0]:.4f}: bytes "
          f"{bounds['dkdv'][2]:.4f}, bf16 ops {bounds['dkdv'][3]:.4f}, {bounds['dkdv'][4]:.3e} FLOP), plain "
          f"backward (dq, dk, dv together) {plain_ms:.4f} ms, sdpa backward (dq, dk, dv together) "
          f"{sdpa_bwd_ms:.4f} ms")
    # the tensor-core kernels execute 4 passes of 2 D FLOP a live pair (dq:
    # s, dp, ds_hi k, ds_lo k) and 6 (dkdv: s, dp and the hi and lo passes of
    # p^T dO and ds^T q); the bound counts the algorithm's 6 D and 8 D
    for name, kernel_ms, executed in (("dq", dq_ms, 8 * D * pairs), ("dkdv", dkdv_ms, 12 * D * pairs)):
        print(f"{name} kernel achieved {bounds[name][4] / kernel_ms / 1e9:.1f} TFLOP/s on the required FLOP, "
              f"{executed / kernel_ms / 1e9:.1f} TFLOP/s on the executed FLOP ({executed:.3e}), on {smi}")
    # the forward at the trained shape: q, k, v read, out and the lse written
    fwd_ops = 4 * D * pairs
    fwd_tb = (el * (2 * B * Sq * H * D + 2 * B * Sk * KV * D) + 4 * B * H * Sq) / PEAK_BYTES_PER_S * 1e3
    fwd_to = fwd_ops / PEAK_BF16_FLOP_PER_S * 1e3
    fwd_rate = flash_rates(fwd_ms, fwd_ops, pairs, D)
    print(f"forward kernel with LSE at B={B} S={Sq} H={H} KV={KV} D={D}: {fwd_ms:.4f} ms, bound "
          f"{max(fwd_tb, fwd_to):.4f} ms (bytes {fwd_tb:.4f}, bf16 ops {fwd_to:.4f}), sdpa forward {sdpa_fwd_ms:.4f} "
          f"ms; achieved {fwd_rate[0]:.1f} TFLOP/s on the required FLOP, {fwd_rate[1]:.1f} on the executed FLOP, "
          f"on {smi}")
    trained_fwd = {
        "shape": [B, Sq, H, KV, D],
        "launches": launches["flash_fwd"],
        "max_abs_err": fwd_err,
        "ms": fwd_ms,
        "bound_ms": max(fwd_tb, fwd_to),
        "library_ms": sdpa_fwd_ms,
        "tflops_required": fwd_rate[0],
        "tflops_executed": fwd_rate[1],
    }

    def entry(name, kernel_ms, err, line):
        bound, by = bounds[name][:2]
        return {
            "name": f"flash_attention_{name}",
            "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": f"src/repro/kernels/flash_attention/bwd_kernel.py:{line}",
            "launches": launches[name],
            "max_abs_err": err,
            "ms": kernel_ms,
            # the plain version and SDPA's backward compute dq, dk and dv
            # together: the same time stands in both rows
            "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": by,
            "library_ms": sdpa_bwd_ms,
        }

    return [entry("dq", dq_ms, errs["dq"], 46), entry("dkdv", dkdv_ms, max(errs["dk"], errs["dv"]), 87)], trained_fwd


# ---------------------------------------------------------------------------
# the remaining families: moe, ssm, encdec and vlm served; moe, ssm, encdec
# and hybrid trained (narrow vlm and qwen2-moe training card vs host)
# ---------------------------------------------------------------------------


def attention_calls(cfg) -> int:
    """Flash-attention calls of one forward pass over a sequence."""
    if cfg.family == "encdec":
        return cfg.n_enc_layers + 2 * cfg.n_layers    # encoder self, decoder self and cross
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_period
    return 0 if cfg.family == "ssm" else cfg.n_layers


def ssd_calls(cfg, remat: str | None = None) -> int:
    """SSD intra-chunk calls of one forward pass, and with ``remat`` of one
    training step's microbatch (the remat units recompute theirs: an ssm's
    every layer, a hybrid's groups but not its tail)."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0
    if remat is None or remat == "none":
        return cfg.n_layers
    period = cfg.hybrid_attn_period
    return cfg.n_layers + (cfg.n_layers // period * period if cfg.family == "hybrid" else cfg.n_layers)


def _reset_lm_counts() -> None:
    _zero_launch_counts()
    ssd_intra_chunk_cuda.launches = 0
    ssd_intra_chunk_cuda.designs = dict.fromkeys(ssd_intra_chunk_cuda.designs, 0)


@contextlib.contextmanager
def forbid_plain_versions():
    """Make every plain version the card's path could fall back to raise:
    the flash forward's and backward's, the SSD intra-chunk's (the kernel
    wrapper's and ``models/ssm.py``'s).  A wrapper takes its plain version
    only on CPU tensors, so inside this block nothing may run on the host."""
    targets = [(flash_fwd, "flash_attention_ref"), (flash_bwd, "flash_attention_bwd_ref"),
               (ssd_kernel, "ssd_intra_chunk_ref"), (ssm_module, "ssd_intra_chunk")]
    saved = [getattr(m, n) for m, n in targets]

    def refuse(name):
        def call(*a, **kw):
            raise RuntimeError(f"chip_smoke: the plain version {name} ran on the card's path")
        return call

    for m, n in targets:
        setattr(m, n, refuse(n))
    try:
        yield
    finally:
        for (m, n), fn in zip(targets, saved):
            setattr(m, n, fn)


def flash_at(label: str, q, k, v, kw: dict, smi: str) -> dict:
    """The forward kernel against its plain version on captured inputs
    (within one bf16 ulp), timed behind an L2 flush beside the plain
    version, SDPA on the same work and the bound (4 D FLOP a live pair)."""
    causal, window = kw["causal"], kw["window"]
    check(flash_fwd.design(q, k, v) == "wgmma", f"{label}: the q/k/v must take the tensor-core design")
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    want = attend_blockwise(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    check(bool((diff <= FLASH_ATOL + FLASH_RTOL * want.float().abs()).all()),
          f"{label}: flash kernel disagrees with its plain version beyond one bf16 ulp")
    del got, want, diff
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ms = time_cuda(lambda: flash_attention_cuda(q, k, v, causal=causal, window=window))
    plain_ms = time_cuda(lambda: attend_blockwise(q, k, v, causal=causal, window=window), iters=5)
    lib_ms = time_cuda(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=H != KV))
    ms2 = time_cuda(lambda: flash_attention_cuda(q, k, v, causal=causal, window=window))
    pairs = B * H * live_pairs(Sq, Sk, causal, window)
    tb = q.element_size() * (2 * B * Sq * H * D + 2 * B * Sk * KV * D) / PEAK_BYTES_PER_S * 1e3
    to = 4 * D * pairs / PEAK_BF16_FLOP_PER_S * 1e3
    rate = flash_rates(statistics.median([ms, ms2]), 4 * D * pairs, pairs, D)
    print(f"flash {label} at B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} D={D} causal={causal} on {smi}: kernel vs plain "
          f"max|Δ| {err:.3e}; kernel {ms:.4f} / {ms2:.4f} ms, plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
          f"{max(tb, to):.4f} ms (bytes {tb:.4f}, bf16 ops {to:.4f}); achieved {rate[0]:.1f} TFLOP/s required, "
          f"{rate[1]:.1f} executed")
    return {"shape": [B, Sq, Sk, H, KV, D], "causal": causal, "max_abs_err": err, "ms": statistics.median([ms, ms2]),
            "plain_ms": plain_ms, "bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to else "operations",
            "library_ms": lib_ms, "tflops_required": rate[0]}


def ssd_at(label: str, xbar, Bh, Ch, cum, groups: int, smi: str) -> dict:
    """The SSD kernel against its plain version on captured inputs (within
    SSD_NORMWISE; chunk_decay bit-equal; the SIMT design too), timed beside
    its SIMT design, the plain version and the bound."""
    check(ssd_kernel.design(xbar, Bh, Ch) == "wgmma", f"{label}: the SSD inputs must take the tensor-core design")
    y, st, dec = ssd_intra_chunk_cuda(xbar, Bh, Ch, cum)
    y_r, st_r, dec_r = ssd_intra_chunk_ref(xbar, Bh, Ch, cum)
    y_s, st_s = simt_ssd(xbar, Bh, Ch, cum)
    torch.cuda.synchronize()
    err = max(float((y - y_r).abs().max()), float((st - st_r).abs().max()))

    def normwise(a, b):
        return float((a - b).abs().max()) / float(b.abs().max())

    rel, rel_s = max(normwise(y, y_r), normwise(st, st_r)), max(normwise(y_s, y_r), normwise(st_s, st_r))
    check(rel <= SSD_NORMWISE and torch.equal(dec, dec_r), f"{label}: ssd kernel disagrees with its plain version")
    check(rel_s <= SSD_NORMWISE, f"{label}: the SSD kernel's SIMT design disagrees with its plain version")
    del y, st, dec, y_r, st_r, dec_r, y_s, st_s
    b, nc, Q, Hs, P = xbar.shape
    N = Bh.shape[-1]
    ms = time_cuda(lambda: ssd_intra_chunk_cuda(xbar, Bh, Ch, cum))
    simt_ms = time_cuda(lambda: simt_ssd(xbar, Bh, Ch, cum))
    plain_ms = time_cuda(lambda: ssd_intra_chunk_ref(xbar, Bh, Ch, cum), iters=5)
    s_bytes = 4 * (2 * b * nc * Q * Hs * P + b * nc * Q * Hs + 2 * b * nc * Q * groups * N + b * nc * Hs * P * N)
    s_ops = b * nc * Hs * (Q * (Q + 1) * N + Q * (Q + 1) * P + 2 * Q * N * P)
    tb, tt = s_bytes / PEAK_BYTES_PER_S * 1e3, SSD_PASSES * s_ops / PEAK_BF16_FLOP_PER_S * 1e3
    print(f"ssd {label} at b={b} nc={nc} Q={Q} H={Hs} P={P} N={N} G={groups} on {smi}: kernel vs plain max|Δ| "
          f"{err:.3e}, normwise {rel:.2e} (SIMT design {rel_s:.2e}, limit {SSD_NORMWISE}); kernel {ms:.4f} ms, SIMT "
          f"design {simt_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {max(tb, tt):.4f} ms (bytes {s_bytes / 1e9:.3f} GB: "
          f"{tb:.4f}; {SSD_PASSES} bf16 passes: {tt:.4f}); {100 * max(tb, tt) / ms:.1f}% of the bound")
    return {"shape": [b, nc, Q, Hs, P, N, groups], "max_abs_err": err, "ms": ms, "simt_ms": simt_ms,
            "plain_ms": plain_ms, "bound_ms": max(tb, tt), "bound_by": "bytes" if tb >= tt else "operations",
            "library_ms": None}


def flash_bwd_at(label: str, captured: tuple, smi: str) -> dict:
    """The dQ and dK/dV kernels against their plain version on captured
    backward inputs (within two bf16 ulps of max|value|), timed beside their
    bounds (6 D and 8 D FLOP a live pair), the plain backward and SDPA's."""
    *tensors, kw = captured
    q, k, v, out, lse, do = (t.detach() for t in tensors)
    causal, window = kw["causal"], kw["window"]
    delta = attention_delta(out, do)
    dq = flash_attention_dq_cuda(q, k, v, do, lse, delta, causal=causal, window=window)
    dk, dv = flash_attention_dkdv_cuda(q, k, v, do, lse, delta, causal=causal, window=window)
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    errs = {}
    for name, x, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        top = float(w.float().abs().max())
        errs[name] = float((x.float() - w.float()).abs().max())
        check(errs[name] <= bf16_ulps(top), f"{label}: {name} kernel disagrees with its plain version beyond two "
              f"bf16 ulps of max|value| ({errs[name]:.3e} against {bf16_ulps(top):.3e})")
    del dq, dk, dv, want
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    dq_ms = time_cuda(lambda: flash_attention_dq_cuda(q, k, v, do, lse, delta, causal=causal, window=window))
    dkdv_ms = time_cuda(lambda: flash_attention_dkdv_cuda(q, k, v, do, lse, delta, causal=causal, window=window))
    plain_ms = time_cuda(lambda: flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal, window=window), iters=5)
    qt, kt, vt = (t.transpose(1, 2).requires_grad_() for t in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=H != KV)
    dot = do.transpose(1, 2)
    sdpa_ms = time_cuda(lambda: torch.autograd.grad(sdpa_out, (qt, kt, vt), dot, retain_graph=True))
    pairs = B * H * live_pairs(Sq, Sk, causal, window)
    el = q.element_size()
    in_bytes = el * (2 * B * Sq * H * D + 2 * B * Sk * KV * D) + 4 * 2 * B * H * Sq
    res = {"shape": [B, Sq, Sk, H, KV, D], "causal": causal, "plain_ms": plain_ms, "library_ms": sdpa_ms}
    for name, kernel_ms, ops, out_bytes, err in (
            ("dq", dq_ms, 6 * D * pairs, el * B * Sq * H * D, errs["dq"]),
            ("dkdv", dkdv_ms, 8 * D * pairs, el * 2 * B * Sk * KV * D, max(errs["dk"], errs["dv"]))):
        tb, to = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3, ops / PEAK_BF16_FLOP_PER_S * 1e3
        res[name] = {"ms": kernel_ms, "max_abs_err": err, "bound_ms": max(tb, to),
                     "bound_by": "bytes" if tb >= to else "operations"}
    print(f"flash backward {label} at B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} D={D} causal={causal} on {smi}: dq max|Δ| "
          f"{errs['dq']:.3e}, dk {errs['dk']:.3e}, dv {errs['dv']:.3e}; dq kernel {dq_ms:.4f} ms (bound "
          f"{res['dq']['bound_ms']:.4f}), dkdv kernel {dkdv_ms:.4f} ms (bound {res['dkdv']['bound_ms']:.4f}), plain "
          f"backward {plain_ms:.4f} ms, sdpa backward {sdpa_ms:.4f} ms")
    return res


def _check_params(params: dict, cfg) -> tuple[dict, object]:
    """f32 copies of the first CHECK_LAYERS layers of a model (its
    ``blocks``), and its config in f32; a moe config with a capacity factor
    of E / k (capacity = group: nothing dropped)."""
    n = min(CHECK_LAYERS.get(cfg.name, cfg.n_layers), cfg.n_layers)
    small = dataclasses.replace(cfg, dtype="float32", n_layers=n)
    if cfg.family == "moe":
        small = dataclasses.replace(small, moe_capacity_factor=cfg.n_experts / cfg.top_k)

    def cast(tree: dict, stacked: bool) -> dict:
        return {k: cast(v, stacked) if isinstance(v, dict) else (v[:n] if stacked else v).float()
                for k, v in tree.items()}

    return {k: cast(v, k == "blocks") if isinstance(v, dict) else v.float() for k, v in params.items()}, small


def family_serving_phase(dev: torch.device, smi: str, arch: str) -> dict:
    """Serve one of the remaining families at full width through
    ``launch.serve`` (a depth cut where one card cannot hold it); check its
    launches per prefill (every flash and SSD launch on the tensor-core
    design, none in decode), decode against a fresh prefill, each kernel
    against its plain version on inputs captured from a served prefill,
    timed beside its bound and SDPA; profile a prefill and a decode step."""
    requests, batch, prompt, tokens, src_len, cut = FAMILY_SERVING[arch]
    t_phase = time.perf_counter()
    step = Laps()
    smoke_err = smoke_vs_host(dev, arch)
    step("smoke")
    cfg = ARCHS[arch]
    if cut:
        print(f"{arch}: depth cut {cfg.n_layers} -> {cut} layers at full width: {DEPTH_CUTS[arch]}")
        cfg = dataclasses.replace(cfg, n_layers=cut)
    params = init_model(cfg, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"{arch} on the card: {n_params:,} parameters ({cfg.dtype}), {cfg.family}, {cfg.n_layers} layers"
          f"{f' + {cfg.n_enc_layers} encoder layers' if cfg.n_enc_layers else ''}, d_model {cfg.d_model}")
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size, (requests, prompt))
    frontend = frontend_inputs(cfg, requests, src_len or prompt, torch.Generator(device=dev).manual_seed(SEED + 1), dev)
    fe_wave = None if frontend is None else frontend[:batch]
    toks = torch.as_tensor(prompts[:batch], device=dev)
    with capture_first_calls() as seen:
        logits, _cache = forward_prefill(params, cfg, toks, frontend_embeds=fe_wave)
        torch.cuda.synchronize()
    del logits, _cache
    step("init")

    torch.cuda.reset_peak_memory_stats(dev)
    _reset_lm_counts()
    with moe_calls() as calls:
        res = serve(params, cfg, prompts, batch=batch, tokens=tokens, device=dev, frontend=frontend)
    launches = {"flash_attention": flash_attention_cuda.launches, "ssd_intra_chunk": ssd_intra_chunk_cuda.launches}
    designs = {"flash_attention": dict(flash_attention_cuda.designs),
               "ssd_intra_chunk": dict(ssd_intra_chunk_cuda.designs)}
    peak = torch.cuda.max_memory_allocated(dev)
    want = (attention_calls(cfg), ssd_calls(cfg))
    for i, p_ms in enumerate(res["prefill_ms"]):
        print(f"{arch} wave {i}: prefill {p_ms:.1f} ms, {tokens - 1} decode steps {res['decode_ms'][i]:.1f} ms, "
              f"launches (flash, ssd) per prefill {res['prefill_launches'][i]}, in decode {res['decode_launches'][i]}")
        check(res["prefill_launches"][i] == want,
              f"{arch} wave {i}: (flash, ssd) launches per prefill {res['prefill_launches'][i]}, expected {want}")
        check(res["decode_launches"][i] == (0, 0), f"{arch} wave {i}: kernel launches in decode")
    for name, d in designs.items():
        check(d["wgmma"] == launches[name], f"{arch}: {name} launches by design {d}: every served launch must take "
              "the tensor-core design")
    drops = None
    if cfg.family == "moe":
        prefill_calls = [c for c in calls if c["shape"][1] > 1]
        drops = [float(c["drop"]) for c in prefill_calls]
        print(f"{arch} moe_drop_frac at prefill ({len(drops)} layer calls, groups of {batch * prompt} tokens, "
              f"capacity factor {cfg.moe_capacity_factor}): mean {statistics.mean(drops):.4g}, max {max(drops):.4g}; "
              f"decode groups of {batch} keep every token: max {max(float(c['drop']) for c in calls if c['shape'][1] == 1)}")
    seqs = res["sequences"]
    check(seqs.shape == (requests, tokens), f"{arch}: sequences {seqs.shape}")
    check(int(seqs.min()) >= 0 and int(seqs.max()) < cfg.vocab_size, f"{arch}: generated tokens out of range")
    check(res["finite"], f"{arch}: non-finite logits")
    print(f"served {arch}: {requests} requests x {tokens} tokens on {smi}: decode {res['decode_tok_s']:.1f} tok/s, end "
          f"to end {res['e2e_tok_s']:.1f} tok/s, max_memory_allocated {peak / 2**30:.2f} GiB; launches {launches}")
    step("serve")

    # in bf16 as served (moe: lossless, CHECK_BATCH rows), then in f32 on the
    # served weights (CHECK_LAYERS, moe lossless); the served tokens teacher-forced
    is_moe = cfg.family == "moe"
    rows = CHECK_BATCH if is_moe else batch
    lossless = dataclasses.replace(cfg, moe_capacity_factor=cfg.n_experts / cfg.top_k) if is_moe else cfg
    print(f"{arch} decode check in bf16 on the served weights, {cfg.n_layers} layers, {rows} rows"
          + (f", capacity factor {lossless.moe_capacity_factor:g} (lossless), served tokens not compared" if is_moe
             else ", the served tokens compared"))
    dvp_bf16 = decode_vs_prefill(params, lossless, toks[:rows], torch.as_tensor(seqs[:rows], device=dev),
                                 steps=(0, tokens - 2), frontend=None if fe_wave is None else fe_wave[:rows],
                                 served=not is_moe, ulps=BF16_DECODE.get(arch, (DECODE_ULPS, CACHE_ULPS)),
                                 control_logits=arch not in BF16_BLIND_LOGITS)
    step("decode vs prefill, bf16")
    check_params, check_cfg = _check_params(params, cfg)
    print(f"{arch} decode check in f32 on the served weights, {check_cfg.n_layers} of {cfg.n_layers} layers, "
          f"{CHECK_BATCH} rows" + (f", capacity factor {check_cfg.moe_capacity_factor:g} (lossless)"
                                   if cfg.family == "moe" else ""))
    dvp = decode_vs_prefill(check_params, check_cfg, toks[:CHECK_BATCH],
                            torch.as_tensor(seqs[:CHECK_BATCH], device=dev), steps=(0, tokens - 2),
                            frontend=None if fe_wave is None else fe_wave[:CHECK_BATCH], served=False)
    del check_params
    step("decode vs prefill, f32")

    shapes = {}
    for kind in ("flash", "flash_bidir", "flash_cross"):
        if kind in seen:
            q, k, v, kw = seen.pop(kind)
            shapes[kind] = flash_at(f"{arch} {kind}", q, k, v, kw, smi)
            if kind == "flash_cross":   # the backward kernels at Sq != Sk, a ragged Sk: dO drawn from the seed
                out, lse = flash_attention_cuda(q, k, v, causal=False, return_lse=True)
                do = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev,
                                 dtype=out.dtype)
                shapes["bwd_flash_cross"] = flash_bwd_at(f"{arch} cross", (q, k, v, out, lse, do, kw), smi)
                del out, lse, do
            del q, k, v
    if "ssd" in seen:
        shapes["ssd"] = ssd_at(arch, *seen.pop("ssd"), cfg.ssm_groups, smi)
    del seen
    step("kernels")
    device_ms, dec_ms = profile_serving(arch, params, cfg, toks, res, tokens, fe_wave)
    del params
    step("profile")
    seconds = step.report(f"{arch} serving phase")
    wall = time.perf_counter() - t_phase
    print(f"{arch} serving phase: {wall:.1f} s")
    return {"launches": launches, "designs": designs, "shapes": shapes, "prefill_ms": res["prefill_ms"],
            "decode_tok_s": res["decode_tok_s"], "e2e_tok_s": res["e2e_tok_s"], "peak_bytes": peak,
            "prefill_device_ms": device_ms, "decode_step_device_ms": dec_ms,
            "decode_vs_prefill": {"bf16": dvp_bf16, "f32": dvp},
            "moe_drop_frac": drops, "smoke_err": smoke_err, "seconds_by_step": seconds, "seconds": wall}


def narrow_train_vs_host(dev: torch.device, arch: str) -> dict:
    """Training through the kernels on the card against the plain path on
    the host on the narrow config of ``arch`` (f32, its frontend): loss and
    every gradient under remat none and dots, and the launches it made."""
    small = reduce_for_smoke(ARCHS[arch])
    host = init_model(small, generator=torch.Generator().manual_seed(SEED), device="cpu")
    card = _to(host, dev)
    rng = np.random.default_rng(SEED)
    text = 200 - (small.frontend_tokens if small.family == "vlm" else 0)
    batch = {k: torch.as_tensor(rng.integers(0, small.vocab_size, (2, text))) for k in ("tokens", "labels")}
    fe = frontend_batch(small, 2, 200, SEED, 0)
    if fe is not None:
        batch["frontend"] = fe
    host_leaves = [p.requires_grad_() for p in tree_leaves(host)]
    card_leaves = [p.requires_grad_() for p in tree_leaves(card)]
    out = {}
    for remat in ("none", "dots"):
        want_loss, _ = forward_train(host, small, batch, remat=remat)
        want = torch.autograd.grad(want_loss, host_leaves)
        before = _launch_counts()
        with forbid_plain_versions():
            loss, _ = forward_train(card, small, {k: v.to(dev) for k, v in batch.items()}, remat=remat)
            got = torch.autograd.grad(loss, card_leaves)
        launched = tuple(a - b for a, b in zip(_launch_counts(), before))
        loss_err = abs(float(loss.detach()) - float(want_loss.detach()))
        grad_err = max(float((x.cpu() - w).abs().max()) / max(float(w.abs().max()), 1e-30) for x, w in zip(got, want))
        per = attention_calls(small)
        print(f"narrow {arch} (f32, {small.n_layers} layers) training, remat {remat}, card kernels vs host plain: "
              f"|Δloss| {loss_err:.2e}, gradients max|Δ|/max|value| {grad_err:.2e}; launches (flash fwd, dq, dkdv) "
              f"{launched}")
        check(loss_err <= TRAIN_LOSS_TOL and grad_err <= TRAIN_GRAD_TOL,
              f"narrow {arch} training (remat {remat}) on the card disagrees with the host")
        check(launched == ((2 if remat != "none" else 1) * per, per, per),
              f"narrow {arch} training (remat {remat}): launches {launched}")
        out[remat] = {"loss_err": loss_err, "grad_err": grad_err, "launches": launched}
    return out


def ssd_function_vs_host(dev: torch.device) -> dict:
    """``SSDIntraChunk`` (the kernel forward, the closed-form backward) on
    the card against the host, through ``ssd_chunked`` at a narrow size
    whose chunks take the tensor-core design (q = 128, p = 64, n = 128, one
    group): outputs and the gradients of x, dt, A, B and C within 1e-4 of
    their max|value| (the tensor-core forward's split products, f32 sums in
    another order)."""
    g = torch.Generator().manual_seed(SEED)
    b, l, h, p, n = 1, 300, 4, 64, 128
    host = [torch.randn((b, l, h, p), generator=g), 0.3 * torch.rand((b, l, h), generator=g),
            -torch.rand(h, generator=g) - 0.5, torch.randn((b, l, 1, n), generator=g),
            torch.randn((b, l, 1, n), generator=g)]
    wy, ws = torch.randn((b, l, h, p), generator=g), torch.randn((b, h, p, n), generator=g)
    grads, outs = [], []
    before = ssd_intra_chunk_cuda.launches
    for where in ("cpu", dev):
        ts = [t.to(where).requires_grad_() for t in host]
        with contextlib.nullcontext() if where == "cpu" else forbid_plain_versions():
            y, s = ssd_ops.ssd_chunked(*ts, chunk=128)
            grads.append([x.cpu() for x in torch.autograd.grad((y * wy.to(where)).sum() + (s * ws.to(where)).sum(), ts)])
        outs.append((y.detach().cpu(), s.detach().cpu()))
    errs = [float((a - w).abs().max()) / float(w.abs().max()) for a, w in zip(outs[1] + tuple(grads[1]),
                                                                              outs[0] + tuple(grads[0]))]
    print(f"SSDIntraChunk through ssd_chunked (b={b}, l={l}, h={h}, p={p}, n={n}), card vs host: y, state, dx, ddt, "
          f"dA, dB, dC max|Δ|/max|value| {', '.join(f'{e:.2e}' for e in errs)} (limit 1e-4); "
          f"{ssd_intra_chunk_cuda.launches - before} kernel launch")
    check(max(errs) <= 1e-4, "SSDIntraChunk's gradients on the card disagree with the host's")
    check(ssd_intra_chunk_cuda.launches == before + 1, "the SSD Function did not launch the kernel once")
    return {"max_rel_err": max(errs)}


def family_train_phase(dev: torch.device, smi: str, arch: str) -> dict:
    """Train one family at full width (a depth cut where one card cannot
    hold its train state) for FAMILY_TRAIN_STEPS AdamW steps: finite loss
    and grad norm, the first loss near ln(vocab), the exact launches of the
    flash and SSD kernels on every step (all tensor-core), no plain version
    on the path; the non-causal backward kernels against their plain
    version on captured inputs, timed; one step profiled."""
    batch, seq, n_micro, remat, cut = FAMILY_TRAINING[arch]
    t_phase = time.perf_counter()
    cfg = ARCHS[arch]
    if cut:
        print(f"{arch} training: depth cut {cfg.n_layers} -> {cut} layers at full width: {DEPTH_CUTS[arch]}")
        cfg = dataclasses.replace(cfg, n_layers=cut)
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_model(cfg, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    opt_state = init_adamw(params)
    n_params = sum(t.numel() for t in tree_leaves(params))
    step_fn = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=FAMILY_TRAIN_STEPS),
                              n_micro=n_micro, remat=remat)
    text = seq - (cfg.frontend_tokens if cfg.family == "vlm" else 0)
    stream = SyntheticLM(LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=text, global_batch=batch, seed=SEED))
    batches = []
    for i in range(FAMILY_TRAIN_STEPS + 1):
        bt = {k: torch.as_tensor(v, dtype=torch.long, device=dev) for k, v in stream.batch_at(i).items()}
        fe = frontend_batch(cfg, batch, seq, SEED, i)
        if fe is not None:
            bt["frontend"] = fe.to(dev)
        batches.append(bt)
    per_micro = attention_calls(cfg)
    want = (n_micro * per_micro * (2 if remat != "none" else 1), n_micro * per_micro, n_micro * per_micro,
            n_micro * ssd_calls(cfg, remat))
    _reset_lm_counts()
    step_ms, first_loss = [], None
    counts = lambda: _launch_counts() + (ssd_intra_chunk_cuda.launches,)   # noqa: E731
    wgmma = lambda: _wgmma_counts() + (ssd_intra_chunk_cuda.designs["wgmma"],)   # noqa: E731
    with capture_first_backward() as seen, forbid_plain_versions():
        for i in range(FAMILY_TRAIN_STEPS):
            before, wg_before = counts(), wgmma()
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batches[i])
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])   # synchronises
            step_ms.append((time.perf_counter() - t0) * 1e3)
            launched = tuple(a - b for a, b in zip(counts(), before))
            on_tc = tuple(a - b for a, b in zip(wgmma(), wg_before))
            extra = {k: round(float(v), 5) for k, v in metrics.items() if k.startswith("moe_") and cfg.n_experts}
            print(f"{arch} train step {i + 1}: loss {loss:.4f} grad_norm {gnorm:.4f} {step_ms[-1]:.1f} ms/step "
                  f"{batch * seq / step_ms[-1] * 1e3:.0f} tokens/s, launches (flash fwd, dq, dkdv, ssd) {launched}, "
                  f"of which wgmma {on_tc}{f', {extra}' if extra else ''}")
            check(np.isfinite(loss) and np.isfinite(gnorm), f"{arch} step {i + 1}: loss {loss}, grad_norm {gnorm}")
            check(launched == want, f"{arch} step {i + 1}: launches {launched}, expected {want}")
            check(on_tc == want, f"{arch} step {i + 1}: {on_tc} launches took the tensor-core design, expected all")
            first_loss = loss if first_loss is None else first_loss
    # random logits of std sigma = 0.02 sqrt(d) (unit-RMS hidden states, a
    # table drawn at 0.02): cross-entropy ln(vocab) + sigma^2 / 2
    ln_v = float(np.log(cfg.vocab_size))
    expect = ln_v + 0.5 * 0.02**2 * cfg.d_model
    print(f"{arch} first loss {first_loss:.4f}: ln(vocab) {ln_v:.4f} + sigma^2/2 = {expect:.4f} (limit +-0.5)")
    check(abs(first_loss - expect) <= 0.5, f"{arch}: the first loss {first_loss:.4f} is far from {expect:.4f}")
    active = cfg.active_param_count() if cfg.family == "moe" else cfg.param_count()
    mfu = 6 * active * batch * seq / (step_ms[-1] / 1e3) / PEAK_BF16_FLOP_PER_S
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"trained {arch} {FAMILY_TRAIN_STEPS} steps of {batch}x{seq} tokens (n_micro {n_micro}, remat {remat}) on "
          f"{smi}: {n_params:,} parameters, step 2 {step_ms[-1]:.1f} ms, {batch * seq / step_ms[-1] * 1e3:.0f} tokens/s, "
          f"mfu {mfu:.4f} (6 N_active tokens / step time / 989 TFLOP/s), max_memory_allocated {peak / 2**30:.2f} GiB")
    launches = dict(zip(("flash_fwd", "dq", "dkdv", "ssd"), counts()))
    device_ms, rows = profile_device(lambda: float(step_fn(params, opt_state, batches[-1])[2]["loss"]), runs=1)
    print(f"profile one {arch} train step: device time {device_ms:.1f} ms, busy {device_ms / step_ms[-1]:.1%} of step 2")
    for row in rows:
        print(f"  {row}")
    del params, opt_state, metrics, batches, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    shapes = {}
    for kind in ("bwd_flash_bidir", "bwd_flash_cross"):
        if kind in seen:
            shapes[kind] = flash_bwd_at(f"{arch} {kind[4:]}", seen.pop(kind), smi)
    if "bwd" in seen:
        shapes["bwd_flash"] = flash_bwd_at(f"{arch} causal", seen.pop("bwd"), smi)
    del seen
    wall = time.perf_counter() - t_phase
    print(f"{arch} training phase: {wall:.1f} s")
    return {"launches": launches, "step_ms": step_ms,
            "first_loss": first_loss, "mfu": mfu, "peak_bytes": peak, "step_device_ms": device_ms,
            "shapes": shapes, "seconds": wall}


def simt_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                 window: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's SIMT design (the bf16 path before the tensor-core
    design) with LSE, launched through the C entry point so that no launch
    counter moves: it shows how the two designs' roundings differ and is no
    part of the main path."""
    B, Sq, H, D = q.shape
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    err = flash_fwd._launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        flash_fwd._DTYPES[q.dtype], B, Sq, k.shape[1], H, k.shape[2], D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), 0 if window is None else int(window), D**-0.5, 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    check(err == 0, f"SIMT forward launch failed with CUDA error {err}")
    return out, lse


def simt_fpca(patches: torch.Tensor, planes: dict, tables, bn: torch.Tensor) -> torch.Tensor:
    """The fpca kernel's SIMT design (the served path before the tensor-core
    design), launched through the C entry point so that no launch counter
    moves: it checks and times the old design beside the new one in the
    same run and is no part of the main path."""
    out = torch.empty((patches.shape[0], bn.shape[0]), dtype=torch.float32, device=patches.device)
    err = fpca_kernel._launch(patches, planes, tables, bn, None, out, tensor_cores=False)
    check(err == 0, f"SIMT fpca launch failed with CUDA error {err}")
    return out


def simt_ssd(xbar: torch.Tensor, Bh: torch.Tensor, Ch: torch.Tensor,
             cum: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD kernel's SIMT design (the served path before the tensor-core
    design), launched through the C entry point so that no launch counter
    moves: it times the old design beside the new one in the same run and
    is no part of the main path."""
    b, nc, q, h, p = xbar.shape
    n = Bh.shape[-1]
    y = torch.empty_like(xbar)
    states = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=xbar.device)
    err = ssd_kernel._launcher()(
        xbar.data_ptr(), Bh.data_ptr(), Ch.data_ptr(), cum.data_ptr(), y.data_ptr(), states.data_ptr(),
        b, nc, q, h, p, n, *Bh.stride()[:4], *Ch.stride()[:4], 0,
        torch.cuda.current_stream(xbar.device).cuda_stream,
    )
    check(err == 0, f"SIMT SSD launch failed with CUDA error {err}")
    return y, states


def _leaves(tree: dict):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


if __name__ == "__main__":
    main()

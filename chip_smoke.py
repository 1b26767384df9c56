#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA device, ``nvcc`` (on PATH or under /usr/local/cuda/bin) and
the ``src/`` tree of this checkout; it imports nothing of JAX or of the JAX
package ``repro``. Phases, each printing lines before the last:

  1. device: card name and power limit, torch and CUDA versions, TF32 flags
     (both set to False, so float32 convolutions and matmuls are full
     float32);
  2. build: the seven kernels of ``src/repro_torch/csrc``, one nvcc each,
     all started together;
  3. kernels against their plain torch versions on the card: the BaF
     kernels at the slice's shapes (B=8, R=64*64, P=256, C=64, bits=8) plus
     edge cases (quantize: NaN, 12 bits, signed zeros against the plain
     version on the CPU, R=1 and 7 (also under a cluster of 16 blocks),
     R=4095, R=65536 beyond what the blocks hold, C=1, 8 and 33,
     sel_idx=None, a channel-table entry out of range skipped; histogram: one symbol everywhere, K=3 (also under a
     cluster of 16 blocks), C=5 peaked; consolidate: NaN in the estimate,
     NaN side info and both, NaN where the plain version has NaN and the
     same bits elsewhere, with and without the plan's channel table); cdf
     at 1, 8 and 12 bits, row-major and through the (S, C) view of a
     (C, S) buffer as the cdf path reads and writes it; flash
     attention (f32 and bf16, causal or not, window, Sq < Sk, GQA 7 and 1,
     hd 8, 16, 64 and 128, ragged S, the qwen2-7b prefill's shape, the detect
     head's (8, 4096, 2, 16) float32 and the 15B prefills' GQA 48/4 and
     48/8 bf16, the zoo's prefills (olmoe 16/16, arctic 56/8, pixtral
     32/8, zamba2's shared block 32/32 at hd 64) and whisper's encoder
     (1500 frames, not causal), decoder (448, causal) and cross-attention
     (448 against 1500); bf16 q, k, v sliced from one fused qkv tensor);
     the linear scan (rwkv with
     bonus, ssm, per-channel and scalar decay, with and without an initial
     state, the rwkv6-3b prefill's and ingest's shapes, zamba2's prefill
     and ingest block at chunk 128 with a (B, S, H, 1) decay, a
     per-channel decay at chunk 128 in both modes; chunk 32 and zamba2's
     chunk of 128 at the decay clamp, NaN where the plain version has
     NaN); the served restore's conv kernel (``baf_conv``) at the five
     conv shapes of both configurations at B=8 (the x2 transposed ``up`` at
     C=64 and 96, ``c2``/``c3``, ``c4``, the split conv with BN) against
     its plain version (nn.py's ops on cuDNN, TF32 off);
  4. the BaF main path at the paper's full width (YOLO front at 512x512,
     split tensor 64x64x256, C=64, 8 bits, static rANS, fused restore):
     eight one-image requests through edge -> plan.encode ->
     plan.decode_batch -> plan.restore -> cloud, with the kernels' launch
     counts read over this phase alone; the histogram kernel held exact
     against its plain version on the path's own codes, and the
     consolidate kernel bit for bit on the path's own estimate; the restore
     (five ``baf_conv`` launches, counted by shape) checked against the
     plan compiled with
     fused=False (cuDNN's convolutions), bit for bit against itself rerun,
     and against the same path run on the CPU for the first request; then ``channel_histogram_cdf`` on each request's
     decoded codes (the cdf kernel's path), exact against numpy, and its
     device operations per request from the profiler: the histogram and
     cdf kernels and three copies, nothing else;
  5. the offline side of the BaF path at the paper's full width
     (``pretrain_cnn`` 4 steps on batches of 8 at 512x512,
     ``compute_channel_order`` over 2 batches, ``train_baf`` 4 steps at
     C=64, then eight requests through ``SplitInferenceEngine`` with the
     trained weights), each with the kernels' counts read over it alone:
     the quantize kernel once per BaF step and bit-identical to its plain
     version on the first step's z, the frozen CNN bit-identical before and
     after, losses finite, logits finite; the steps' times, the selection
     time and the phase's peak memory; at smoke scale one pretraining step
     and one BaF step on the card against the same steps on the CPU;
  6. the BaF serving gateway at the paper's full width (the same
     full_config, float32, TF32 off, a bank of seeded BaF predictors for
     C in {16, 32, 64}, hidden 64, each selecting the first C of one channel
     order): the RD table from ``build_rd_table`` over 2 calibration images
     at C x bits {4, 8}, rans, through ``load_or_build_rd_table`` in a
     temporary directory (its launches printed apart); a ``ServingGateway``
     with a ``RateController``, a metered ``SimulatedChannel`` and
     max_batch 8 serving 16 requests: wall time and requests/s, the hooked
     stage times, telemetry p50/p99, peak memory, the kernels' launches
     over the serve alone (quantize and histogram once a request,
     consolidate once a micro-batch of the telemetry), every response its
     micro-batch's own row with the padding rows dropped, the most padded
     micro-batch's fused restore against fused=False and its consolidate
     bit for bit against the plain version, quantize and histogram on a
     served z; the device's busy share of a profiled serve; then
     ``gateway_demo`` part 7 at full width (gold/silver/bronze, a
     48-request burst, two queues under ``LinearCostModel``, queue-depth
     admission): served + shed = 48, the scheduler's grants equal the
     containers' bits, a second run and a traced run give identical
     telemetry, the spans sum to each latency within 1e-9 s and the Chrome
     trace is valid; at smoke scale the gateway on the card against the
     CPU with both edges given the CPU's z: wire bytes and RequestRecords
     identical, logits within 1e-4;
  7. streaming sessions and multi-task heads at the paper's full width
     (the same full_config and bank as phase 6): a 16-frame clip of
     ``correlated_frames`` at 512 with the JAX session benchmark's
     sub-pixel jitter (0.128 px a frame) through SessionEncoder ->
     SessionDecoder at C=64, 8 bits, keyframe interval 8: codes
     bit-identical to plan.quantize on the same z, the mean wire bits of
     I- and P-frames, quantize and histogram once a frame; a SessionManager
     run of 4 sessions x 16 frames at 20 fps (ladder (64, 8), (32, 4) with
     keyframe interval 8, (16, 4) with interval 8 and stride 2; links with
     loss 0.05 and corruption 0.02 a frame; two queues under
     ``LinearCostModel``, max_batch 8): outcomes sum to the frames offered,
     every session ends in sync, the longest recovery within twice
     ``recovery_bound_s``, quantize and histogram once per encoded frame,
     consolidate once per micro-batch and bit for bit on one, a replay's
     signature identical, wall time per frame and peak memory; the task RD
     sweep (heads classify, detect, embed with ``HeadConfig(split_p=256,
     num_classes=80)``, weights 1, 3, 0.5) through
     ``load_or_build_task_tables`` in a temporary directory; a
     ``MultiTaskGateway`` with a full-set and a classify-only tenant, 16
     requests under ``MeasuredCost``: decode calls = micro-batches, each
     head at most once a decoded batch, flash launches = detect-head calls,
     the classify-only tenant pays fewer wire bits, the detect head's flash
     at the path's (N, 4096, 2, 16) float32 against its plain version; at
     smoke scale the session codec (8 and 12 bits) and the task gateway on
     the card against the CPU, both given the CPU's z;
  8. qwen2-7b, starcoder2-15b and nemotron-4-15b at their full published
     configs (28, 40 and 32 layers, bf16, random weights from a seed), one
     after the other: B=2, a 512-token prefill (flash kernel, one launch a
     layer), the KV cache filled token by token, 16 greedy decode steps;
     prefill against the cache fill's last logits and against the same
     model with plain attention on the card, in bf16 and, after the weights
     are upcast in place, in float32;
  9. rwkv6-3b at its full published config (32 layers): B=2, a 512-token
     prefill (32 scan launches), a 4096-token long ingest in blocks of 1024
     (128 launches) held against one 4096-token prefill, 16 decode steps
     from the ingest state; the top kernels of a prefill, of the ingest
     and of a decode step;
  9b. the rest of the LM zoo at full width, one arch after another:
     olmoe-1b-7b (16 layers, 64 experts top-8) and arctic-480b (full width,
     1 of its 35 layers): B=2, a 512-token prefill (flash once a layer),
     the cache filled token by token, 16 greedy decode steps; the routings
     that differ between flash and plain attention counted; in float32
     (the weights upcast in place) flash against plain attention, and
     prefill against cache fill at a 16-token prompt where no slot drops,
     each at the positions before the first routing difference of its row;
     pixtral-12b (40 layers) as the dense LMs, prefilled from 512 seeded
     embeddings and its cache filled with them; zamba2-1.2b (38 Mamba-2
     layers in 7 segments): a 512-token prefill (38 scan and 7 flash
     launches), cache fill, 16 decode steps, an 8192-token ingest in
     blocks of 4096 (76 scan launches, no flash) held against one
     8192-token prefill with window 4096, 16 decode steps from the
     ingest's state; whisper-tiny: 1500 seeded frame embeddings, a
     448-token teacher-forced decoder pass (flash 4 + 4 + 4), the cache
     filled over the 448 tokens against the teacher-forced logits at every
     position, 16 decode steps; each with its times and peak memory;
 10. every arch at smoke scale in float32 from the same seeded weights
     (whisper through its encoder, decoder pass and decode, pixtral from
     embeddings, the ssm and hybrid ingests and their states): the kernels
     on the card against the plain versions on the CPU;
 10a. LM training: flash and the scan under autograd at the training
     runs' shapes, head dim 8 and a window (outputs with a graph, one
     launch a call and none in the backward, the gradients against
     autograd through the plain versions); every arch at smoke scale, one
     training step of 2 microbatches in float32 on the card against the
     CPU (the loss and every gradient, then AdamW from the same
     gradients), and qwen2-72b's smoke config as published (bf16, head
     dim 8) one step on the card; then zamba2-1.2b (38 layers, B=4 x
     1024), whisper-tiny (B=2, 1500 frames, 448 tokens), qwen2-7b (4 of
     28 layers, B=2 x 512) and rwkv6-3b (8 of 32, B=2 x 512) at full width,
     bf16 over float32 master weights, 2 microbatches, full remat: step 1's
     loss and named gradient leaves with the kernels against the same step
     with the plain versions swapped in (float32 and bf16), the bf16 loss
     the same over two runs, 3 steps with their times, tokens/s, peak
     memory, launches in the forward and in the backward against the
     config's count, and one more step profiled: its busy time split into
     the forward, the backward (remat recompute included) and the rest;
 10b/10c. distributed training and the pod pipeline, over a world-size-1
     NCCL mesh (pod, data, model) = (1, 1, 1): (a) zamba2-1.2b whole at
     phase 10a's shape, weights and batches with the 8-bit compressed
     cross-pod exchange, error feedback and ``multi_pod=True``, 3 steps:
     step 1's loss bit-equal to phase 10a's uncompressed step 1, step 1's
     exchanged gradients and residuals bit-identical to the plain-torch
     formula on the same gradients, ms a step, the exchange's ms (CUDA
     events), peak memory, flash and scan launches a step; (c) qwen2-7b at
     full width, phase 8's 512-token prompt fed token by token and its 16
     greedy steps' tokens under ``flash_decode_ctx``, each step's bf16
     logits against phase 8's unsharded decode within 2x the plain path's
     distance from float32; (d) qwen2-7b's hidden stream after 14 of its
     layers, (2, 4096, 3584) bf16, through ``compressed_pod_transfer`` at 8
     and 4 bits (codes and side info of the kernel, of ``quantize_plain``
     and of the CPU bit-identical, the bytes handed to ppermute exactly
     ``wire_bytes()``, one quantize launch) and ``subset_pod_transfer`` of
     896 channels with a stream BaF predictor of width 512 and layer 14 as
     the receiving block (quantize, consolidate and flash once each, the
     output the plain consolidate's on the same estimate bit for bit, in
     float32 within 1e-3 of the CPU's largest entry); then two gloo ranks
     sharing the card: (b) qwen2-7b's smoke config in float32 with the
     compressed exchange for 3 steps, the ranks' exchanged gradients and
     weights bit-identical after each step, the losses against the same
     two ranks on the CPU (1e-4 relative at step 1, 1e-3 after), and (c)
     the sequence-sharded decode at (B, H, K, hd) = (2, 28, 4, 128) over
     32,768 slots, half a rank, against the unsharded decode at 1e-5;
 10d. the sharded cloud tier at the paper's full width (phase 6's system,
     images and submit times, one operating point: C=64, 8 bits, rans;
     cuDNN deterministic): (d) ``analyze_program`` of the restore + cloud
     body at B=8 (flops, bytes, the consolidate kernel's charge) and
     ``seed_cost_from_program``'s roofline per item beside the body's
     measured time per item; (a) a ``ServingGateway`` on
     ``MeshExecutor(make_dev_mesh(prefer="data"))`` (data=1, model=1)
     serving the 16 requests under a ``CalibratedCostModel`` fitted on a
     ``SerialExecutor`` serve and frozen: every response's logits
     bit-identical to the serial serve's, quantize and histogram once a
     request and consolidate once a micro-batch, wall time, requests/s,
     peak memory; (b) a micro-batch of 8 on two shards of cuda:0: each
     shard bit-identical to the serial path at 4 rows, the batch within
     1e-5 of the serial bucket's largest logit, consolidate once a shard;
     (c) two federated ``MultiTenantGateway``s on one shared
     ``MeshExecutor``: a replay identical (records and logits) and equal to
     the same federation on a ``SerialExecutor``; (e) ``MultiTaskGateway``
     refusing a mesh executor; (f) ``launch/quickstart.py`` on the card
     against the CPU (the CPU's z): selection, codes, side info, wire bits
     and the container identical, quantize and consolidate once each;
 11. times: each kernel's device time and device operations per call at
     its path's shapes (torch.profiler) beside its bound, its plain version
     and, where one PyTorch call computes the same function, that call; the
     histogram also on the path's own codes; cdf through the cdf path's
     (C, S) views, row-major, and at S=4096; flash at the qwen2-7b prefill's
     shape and at the detect head's, the two 15B prefills', the zoo's
     prefills' and whisper's three attentions' (``flash_attention/<path>``,
     each with its launches on its path); the linear scan at rwkv6-3b's
     prefill (its launches in the prefill) and ingest block
     (``linear_scan/ingest_block``, its launches in the ingest), and at
     zamba2-1.2b's (``linear_scan/zamba2_prefill``,
     ``linear_scan/zamba2_ingest_block``; the prefill's shape with a
     per-channel decay printed beside them); flash at head dim 8 in both
     dtypes (``flash_attention/hd8_f32``, ``hd8_bf16``), flash in float32
     at the qwen2-7b prefill's shape (``flash_attention/qwen2_7b_f32``, its
     launches in qwen2-7b's float32 prefill), and flash and the
     scan at the training runs' shapes (``*/train_<arch>``, their launches
     a training step, forward and recompute) with their plain-torch
     backward's time (``backward_ms``), and in the compressed step
     (``*/train_zamba2_1p2b_compressed``); quantize at the pod boundary's
     (1, 8192, 3584) with all channels and with 896
     (``quantize/pod_stream``, ``quantize/pod_subset``), consolidate at the
     subset's shape (``consolidate/pod_subset``); the rows ``quantize/mesh``,
     ``histogram/mesh`` and ``consolidate/mesh`` carry phase 10d's launches
     beside the main path's times (the same shapes); ``baf_conv`` at its
     five conv shapes for B=8 and 32 (``baf_conv/<conv>_b<B>``), each
     checked against its plain version at that shape, with its launches in
     phase 4's restore (0 where no phase runs the shape) and one cuDNN call
     beside it, timed between CUDA events.

Then one JSON line with every kernel's numbers, the ``nvidia-smi`` name and
power-limit line, and last ``{"ok": true, "device": {...}}``. Any failed
check raises, and the script exits non-zero without that last line. With no
CUDA device it exits 1 at once.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak, same sheet
TF32_FLOPS = 495e12              # dense TF32 tensor-core peak, same sheet
F32_FLOPS = 67e12                # float32 outside the tensor cores
B, R, P, C, BITS = 8, 64 * 64, 256, 64, 8
HIDDEN = 64                      # width of the BaF predictor
# The fused restore runs its convolutions on the baf_conv kernel (3xTF32),
# the fused=False restore on cuDNN (float32, TF32 off): the two are held at
# the CPU parity tests' 1e-4, and the kernel's restore bit for bit against
# itself rerun (it has no atomics). Card against CPU: 1e-3. Relative and
# absolute.
RESTORE_TOL = 1e-4
CPU_TOL = 1e-3
# The restore's convolutions at the path's shapes, (label, H = W of the
# input, Cin, Cout, stride, transposed, epilogue): c3 has c2's shape, C=96
# changes only up. The baf_conv kernel against its plain version (nn.py's
# ops on cuDNN, float32, TF32 off): 2e-5 relative and absolute, the float32
# flash kernel's tolerance (3xTF32 keeps each product within ~2^-20).
BAF_CONVS = (("up_c64", 64, 64, HIDDEN, 2, True, "prelu"),
             ("up_c96", 64, 96, HIDDEN, 2, True, "prelu"),
             ("c2_c3", 128, HIDDEN, HIDDEN, 1, False, "prelu"),
             ("c4", 128, HIDDEN, 128, 1, False, "bias"),
             ("split", 128, 128, P, 2, False, "bn"))
BAF_CONV_TOL = 2e-5
# Kernel against plain version: flash 2e-5 (f32) and 3e-2 (bf16), the JAX
# kernel tests' tolerances; the linear scan 1e-4 (float32 sums in another
# order over 16-step chunks); cdf exact; consolidate bit for bit, NaN where
# the plain version has NaN. Relative and absolute.
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SCAN_TOL = 1e-4
# Full-width LMs. Each check runs twice. In float32 (the same weights
# upcast) two orders of the same arithmetic must agree to LM_F32_RTOL of
# the largest |logit|: these are the checks that test the algorithms. In
# bf16 no fixed bound is principled at 28-32 layers of random weights, so
# the bound is measured in the same run: two bf16 evaluations of one
# function (kernel and plain attention, prefill and cache fill, ingest and
# prefill) may lie at most as far apart as the plain bf16 evaluation lies
# from float32. That catches only a fault larger than bf16 rounding carried
# through the stack; the kernels' own bf16 cases above are held at 3e-2.
LM_F32_RTOL = 1e-3
LM_CPU_TOL = 1e-4                # smoke LMs in float32, card against CPU
QWEN_B, QWEN_PROMPT, GEN = 2, 512, 16
# The offline side: steps of each trainer, batches of the selection, the
# batch, and the steps timed after it.
TRAIN_STEPS, SELECT_BATCHES, OFFLINE_BATCH, TIMED_STEPS = 4, 2, 8, 5
RWKV_B, RWKV_PROMPT, RWKV_LONG, RWKV_BLOCK = 2, 512, 4096, 1024
# The serving gateway: the bank's C, the RD sweep's calibration images and
# bits, the single-tenant requests and micro-batch cap, the overload burst.
SERVE_BANK, SERVE_CALIB, SERVE_BITS = (16, 32, 64), 2, (4, 8)
SERVE_N, SERVE_MAX_BATCH, BURST = 16, 8, 48
GATEWAY_CPU_TOL = 1e-4           # smoke-scale gateway logits, card vs CPU
# Sessions: frames a clip, the keyframe interval, the JAX session
# benchmark's sub-pixel jitter (drift 0.002 at 64 px) and noise, the
# sessions of the manager run, their frame rate and link rate (a full-width
# I-frame is ~2 Mbit). Tasks: the allocation weights and the requests.
SESSION_FRAMES, SESSION_KEYFRAME = 16, 8
SESSION_JITTER_PX, SESSION_NOISE = 0.128, 0.003
SESSIONS, SESSION_FPS, SESSION_LINK_BPS = 4, 20.0, 1e9
TASK_WEIGHTS = (("classify", 1.0), ("detect", 3.0), ("embed", 0.5))
TASK_N = 16
# Dense LMs after qwen2-7b: (arch, weight seed, token seed). Their bf16
# pairs are held to twice the plain bf16 path's distance from float32: if
# each of two bf16 evaluations lies within that distance of float32, they
# lie within twice it of each other. At 40 layers of random weights the
# two evaluations round independently enough that one such distance does
# not bound their gap (starcoder2-15b: flash vs plain 0.172, the plain
# path 0.155 from float32, H100 80GB HBM3, 700 W); qwen2-7b keeps the
# tighter bound (0.281 against 0.389).
BIG_LMS = (("starcoder2_15b", 2, 12), ("nemotron4_15b", 3, 13))
BIG_LM_BF16_SPREAD = 2.0
# The rest of the zoo (phase 9b), one after another: the MoE LMs as (arch,
# weight seed, token seed, layers kept: None for all; arctic-480b's 35
# layers are ~954 GB in bf16, so one layer at full width), pixtral-12b
# (dense, prompts of precomputed embeddings), zamba2-1.2b (a 512-token
# prefill, and an ingest of ZAMBA_LONG tokens in blocks of ZAMBA_BLOCK, its
# long-context window), whisper-tiny (Whisper's 30-s window of 1500 frames,
# a 448-token decoder pass). MoE prefill and cache fill route differently
# by design (a row of S tokens against the B tokens of a step), so they
# are held against each other at MOE_FILL_PROMPT tokens, where no slot can
# drop (capacity is at least 8, and a token takes an expert once). At 16
# tokens olmoe-1b-7b's random weights dropped 1176 of 4096 slots (H100
# 80GB HBM3, 700 W): they route most tokens of a row alike.
ZOO_MOE = (("olmoe_1b_7b", 4, 14, None), ("arctic_480b", 5, 15, 1))
MOE_FILL_PROMPT = 8
PIXTRAL = ("pixtral_12b", 6, 16)
ZAMBA_SEED, ZAMBA_LONG, ZAMBA_BLOCK = 7, 8192, 4096
WHISPER_SEED, WHISPER_FRAMES, WHISPER_TOKENS = 8, 1500, 448
# Flash at the paths' shapes, (B, Sq, Sk, H, KH, hd, causal): the detect
# head over a micro-batch of 8 restored 64x64 grids (4096 tokens), the 15B
# prefills, the zoo's prefills (zamba2's shared block), whisper's encoder,
# decoder self-attention and cross-attention, and qwen2-7b's prefill in
# float32 (the full-width float32 check's, head dim 128).
DETECT_FLASH = (8, 64 * 64, 64 * 64, 2, 2, 16, False)
FLASH_PATH_SHAPES = (
    ("detect_head", "float32", DETECT_FLASH),
    ("starcoder2_15b", "bfloat16", (QWEN_B, QWEN_PROMPT, QWEN_PROMPT, 48, 4,
                                    128, True)),
    ("nemotron4_15b", "bfloat16", (QWEN_B, QWEN_PROMPT, QWEN_PROMPT, 48, 8,
                                   128, True)),
    ("olmoe_1b_7b", "bfloat16", (QWEN_B, QWEN_PROMPT, QWEN_PROMPT, 16, 16,
                                 128, True)),
    ("arctic_480b", "bfloat16", (QWEN_B, QWEN_PROMPT, QWEN_PROMPT, 56, 8,
                                 128, True)),
    ("pixtral_12b", "bfloat16", (QWEN_B, QWEN_PROMPT, QWEN_PROMPT, 32, 8,
                                 128, True)),
    ("zamba2_1p2b", "bfloat16", (QWEN_B, QWEN_PROMPT, QWEN_PROMPT, 32, 32,
                                 64, True)),
    ("whisper_encoder", "bfloat16", (QWEN_B, WHISPER_FRAMES, WHISPER_FRAMES,
                                     6, 6, 64, False)),
    ("whisper_decoder", "bfloat16", (QWEN_B, WHISPER_TOKENS, WHISPER_TOKENS,
                                     6, 6, 64, True)),
    ("whisper_cross", "bfloat16", (QWEN_B, WHISPER_TOKENS, WHISPER_FRAMES,
                                   6, 6, 64, False)),
    ("qwen2_7b_f32", "float32", (QWEN_B, QWEN_PROMPT, QWEN_PROMPT, 28, 4,
                                 128, True)))
# LM training (phase 10a): LM_TRAIN_STEPS steps of TRAIN_MB microbatches
# at full width, bf16 over float32 master weights, as (arch, layers kept:
# None for all, B, S, weight seed, token seed). zamba2-1.2b (1.2 B) and
# whisper-tiny train whole; qwen2-7b keeps 4 of 28 layers (its embedding
# and head, 1.09 B, at full width: ~2.0 B) and rwkv6-3b 8 of 32 (~0.9 B),
# so that the master weights, AdamW's moments and the gradients (~20 B a
# parameter) fit one card. Whisper also takes WHISPER_FRAMES frames.
LM_TRAIN_STEPS, TRAIN_MB = 3, 2
# the schedule launch/train.py gives a short run: peak 3e-4 after
# max(steps // 20, 5) warm-up steps
TRAIN_PEAK_LR, TRAIN_WARMUP = 3e-4, 5
# the smoke-scale training step: B=4 rows of SMOKE_TRAIN_S tokens, 2
# microbatches (qwen2-72b's smoke flash: (2, 64, 8/2, hd 8) a microbatch)
SMOKE_TRAIN_S = 64
TRAIN_FULL = (("zamba2_1p2b", None, 4, 1024, 9, 19),
              ("whisper_tiny", None, 2, WHISPER_TOKENS, 10, 20),
              ("qwen2_7b", 4, 2, 512, 11, 21),
              ("rwkv6_3b", 8, 2, 512, 12, 22))
# The gradient leaves held at step 1, by family: the embedding, one layer's
# attention (or its in-projection) and the final norm.
GATE_LEAVES = {
    "dense": ("embed", "layers.0.attn.wq", "final_norm.scale"),
    "ssm": ("embed", "layers.0.wr", "final_norm.scale"),
    "hybrid": ("embed", "layers.0.in_proj", "shared.attn.wq",
               "final_norm.scale"),
    "audio": ("dec_embed", "enc_layers.0.attn.wq", "dec_layers.0.xattn.wq",
              "dec_norm.scale")}
# Step 1 with the kernels against the plain versions in float32: 1e-3 of
# the largest entry (10 to 40 layers of float32 sums in another order).
# The kernels' own gradients against autograd through the plain versions:
# 1e-4 of the largest entry (the plain-torch backward, float32 sums in
# another order).
TRAIN_F32_RTOL = 1e-3
TRAIN_KERNEL_RTOL = 1e-4
# Flash and the scan under autograd at the training runs' shapes (one
# microbatch), (label, (B, Sq, Sk, H, KH, hd, causal, window)) and (label,
# (B, S, H, dk, dv, chunk, mode)); the "train_" labels are rows of the
# JSON line.
FLASH_TRAIN_SHAPES = (
    ("train_zamba2_1p2b", (2, 1024, 1024, 32, 32, 64, True, None)),
    ("train_qwen2_7b", (1, 512, 512, 28, 4, 128, True, None)),
    ("train_whisper_encoder", (1, WHISPER_FRAMES, WHISPER_FRAMES, 6, 6, 64,
                               False, None)),
    ("train_whisper_decoder", (1, WHISPER_TOKENS, WHISPER_TOKENS, 6, 6, 64,
                               True, None)),
    ("train_whisper_cross", (1, WHISPER_TOKENS, WHISPER_FRAMES, 6, 6, 64,
                             False, None)),
    ("hd8", (2, SMOKE_TRAIN_S, SMOKE_TRAIN_S, 8, 2, 8, True, None)),
    ("window", (1, 300, 300, 8, 2, 64, True, 100)))
SCAN_TRAIN_SHAPES = (
    ("train_zamba2_1p2b", (2, 1024, 64, 64, 64, 128, "ssm")),
    ("train_rwkv6_3b", (1, 512, 40, 64, 64, 16, "rwkv")))
# The scan at zamba2's shapes, (label, S, initial state): its 512-token
# prefill and its ingest block; B = 2, 64 heads, dk = dv = 64, chunk 128,
# ssm mode, a (B, S, H, 1) decay.
ZAMBA_SCAN = (("zamba2_prefill", QWEN_PROMPT, False),
              ("zamba2_ingest_block", ZAMBA_BLOCK, True))


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def event_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time per call between CUDA events around ``iters`` back-to-back
    calls. For a call whose kernels take less time than the host needs to
    launch them, this is the host's launch time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


PROFILER_SESSIONS = 5


def _device_rows(run, activities):
    """Run ``run()`` under ``torch.profiler`` -> ([(device us, kernel
    name, count)], run's result). A session that records no device activity
    at all (seen in a few percent of sessions on the card, in this script
    and in its earlier versions alike) is run again, up to
    PROFILER_SESSIONS; then it raises."""
    from torch.autograd import DeviceType
    from torch.profiler import profile
    for attempt in range(PROFILER_SESSIONS):
        with profile(activities=activities) as prof:
            out = run()
        rows = [(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0)), e.key,
                 e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        if sum(r[0] for r in rows) > 0:
            return rows, out
        print(f"torch.profiler recorded no CUDA device time (session "
              f"{attempt + 1} of {PROFILER_SESSIONS})")
    raise RuntimeError("torch.profiler recorded no CUDA device time")


def device_ms(fn, iters: int = 20) -> tuple[float, int]:
    """(device ms per call, device operations per call): the kernels,
    copies and memsets ``fn`` puts on the card, from ``torch.profiler``;
    host launch time is not in it. Each operation counts as its mean
    duration times the times it ran per call (its count over ``iters``,
    rounded): a session sometimes records one event fewer than ran (a
    count of 19 for 20 calls), which a plain sum over ``iters`` would
    read as a call 5% shorter."""
    import torch
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    for attempt in range(PROFILER_SESSIONS):
        rows, _ = _device_rows(run, [ProfilerActivity.CUDA])
        per_call = [(us / n, round(n / iters)) for us, _, n in rows if n]
        ops = sum(k for _, k in per_call)
        if ops:
            return sum(us * k for us, k in per_call) / 1e3, ops
        print(f"torch.profiler recorded too few device operations for "
              f"{iters} calls (session {attempt + 1} of {PROFILER_SESSIONS})")
    raise RuntimeError("torch.profiler recorded too few device operations")


def _numeric(t):
    """A tensor torch can subtract: uint16 codes widened through int32."""
    import torch
    if t.dtype == torch.uint16:
        return t.view(torch.int16).to(torch.int32) & 0xFFFF
    return t


def bits_equal(a, b) -> bool:
    import torch
    if a.dtype in (torch.float16, torch.uint16):
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.shape == b.shape and bool(torch.equal(a, b))


def max_abs_diff(pairs) -> float:
    """Largest |a - b| over (kernel, plain) tensor pairs, in float64; NaN
    where both are NaN counts as equal."""
    import torch
    out = 0.0
    for a, b in pairs:
        d = (_numeric(a).double() - _numeric(b).double()).abs()
        both_nan = torch.isnan(a.double()) & torch.isnan(b.double()) \
            if a.is_floating_point() else None
        if both_nan is not None:
            d = torch.where(both_nan, torch.zeros_like(d), d)
        out = max(out, float(d.max()))
    return out


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(dev) -> dict:
    import torch
    from repro_torch.kernels.consolidate import (consolidate_fused,
                                                 consolidate_plain)
    from repro_torch.kernels.histogram import _plan as histogram_plan_of
    from repro_torch.kernels.quantize import (QuantizePlan, _launch,
                                              channel_order, quantize_fused,
                                              quantize_plain, quantize_plan)

    gen = torch.Generator().manual_seed(0)
    errs = {}

    def quantize_case(b, r, p, c, scale, offset, bits=BITS, every=False,
                      plan=None):
        """``plan``: one the wrapper would not pick, through _launch."""
        x = (torch.randn((b, r, p), generator=gen) * scale + offset).to(dev)
        x[0, :, 3] = offset                          # a constant channel
        sel = None if every else \
            torch.randperm(p, generator=gen)[:c].to(torch.int32).to(dev)
        got = quantize_fused(x, bits, sel) if plan is None else \
            _launch(x, bits, None if every else channel_order(sel), plan)
        want = quantize_plain(x, bits, None if every else sel.long())
        sync(dev)
        ok = all(bits_equal(g, w) for g, w in zip(got, want))
        plan = plan or quantize_plan(b, r, c)
        print(f"quantize B={b} R={r} P={p} C={c} scale={scale:g} "
              f"offset={offset:g} bits={bits}"
              f"{' sel_idx=None' if every else ''} (plan {tuple(plan)}): "
              f"{'bit-identical' if ok else 'DIFFERS'}")
        if not ok:
            raise AssertionError("quantize kernel differs from plain version")
        return got, max_abs_diff(zip(got, want))

    (codes, _, _), err = quantize_case(1, R, P, C, 1.0, 0.0)   # main path
    errs["quantize"] = max(
        err,
        quantize_case(B, R, P, C, 1.0, 0.0)[1],               # slice shape
        quantize_case(B, R, P, C, 1e5, -1.0)[1],              # beyond fp16
        quantize_case(2, R, P, C, 1e-7, 0.5)[1],              # fp16 subnormal
        quantize_case(3, 1000, P, 40, 3.0, 0.5, bits=5)[1],   # ragged R, C
        quantize_case(B, R, P, C, 1.0, 0.0, bits=12)[1],      # uint16 codes
        quantize_case(1, 1, P, C, 1.0, 0.0)[1],
        quantize_case(1, 7, P, C, 1.0, 0.0)[1],
        quantize_case(1, 1, P, C, 1.0, 0.0,                    # R < cluster
                      plan=QuantizePlan(8, 16, 1, True))[1],
        quantize_case(1, 7, P, C, 1.0, 0.0,
                      plan=QuantizePlan(8, 16, 1, True))[1],
        quantize_case(1, R - 1, P, C, 1.0, 0.0)[1],  # R not a multiple
        quantize_case(1, 65536, P, C, 1.0, 0.0)[1],  # rows read twice
        quantize_case(2, R, P, 1, 1.0, 0.0)[1],               # C = 1
        quantize_case(2, R, P, 33, 1.0, 0.0, bits=12)[1],     # C=33
        quantize_case(2, R, P, 8, 1.0, 0.0)[1],               # C=8
        quantize_case(2, R, P, P, 1.0, 0.0, every=True)[1],   # sel_idx=None
        quantize_nan_case(dev, gen),
        quantize_zeros_case(dev, gen),
        quantize_table_out_of_range_case(dev, gen))

    big = torch.randint(0, 256, (B * R, C), generator=gen, dtype=torch.uint8)
    wide = torch.randint(-2, 4098, (4096, 64), generator=gen,
                         dtype=torch.int32)
    wide[::5] = 4096                                        # padding sentinel
    peaked = torch.from_numpy(np.minimum(
        np.random.default_rng(0).geometric(0.6, size=(1000, 5)) + 99, 4095)
        .astype(np.uint16))
    errs["histogram"] = max(
        histogram_case(dev, codes.view(R, C), 1 << BITS, "u8 main shape"),
        histogram_case(dev, big.to(dev), 256, "u8 slice"),
        histogram_case(dev, wide.to(dev), 4096, "i32 bits=12 with sentinels"),
        histogram_case(dev, torch.full((R, C), 17, dtype=torch.uint8,
                                       device=dev), 256, "u8 one symbol"),
        histogram_case(dev, torch.full((R, C), 4000, dtype=torch.int32,
                                       device=dev), 4096, "i32 one symbol"),
        histogram_case(dev, big[:3].to(dev), 256, "u8 few rows"),
        histogram_case(dev, big[:3].to(dev), 256, "u8 K < cluster",
                       plan=histogram_plan_of(3, 256, 4, 16)),
        histogram_case(dev, peaked.to(dev), 4096, "u16 peaked, C=5"))

    def consolidate_case(b, r, p, c, bits, nan=None, table=False):
        """``nan``: "z" puts NaN in the estimate (selected and unselected
        channels), "side" makes one (example, channel)'s min and max NaN,
        "both" does both. ``table``: the plan's channel table given."""
        z = torch.randn((b, r, p), generator=gen).to(dev)
        sel = torch.randperm(p, generator=gen)[:c].to(torch.int32).to(dev)
        codes, mins, maxs = quantize_plain(z, bits, sel.long())
        est = z + 0.3 * torch.randn((b, r, p), generator=gen).to(dev)
        if nan in ("z", "both"):
            est[0, 11, sel[2]] = float("nan")
            est[b - 1, :4, sel[c - 1]] = float("nan")
            est[0, 3, :] = float("nan")        # a whole row, all channels
        if nan in ("side", "both"):
            mins[b - 1, c // 2] = maxs[b - 1, c // 2] = float("nan")
        want = consolidate_plain(est.clone(), codes, mins, maxs, bits,
                                 sel.long())
        kw = {"order": channel_order(sel)} if table else {}
        got = consolidate_fused(est.clone(), codes, mins, maxs, bits, sel,
                                **kw)
        sync(dev)
        nans = torch.isnan(want)
        ok = bool(torch.equal(torch.isnan(got), nans)) and \
            bits_equal(got[~nans].view(torch.int32),
                       want[~nans].view(torch.int32)) and \
            (nan is None) == (int(nans.sum()) == 0)
        err = max_abs_diff([(got, want)])
        print(f"consolidate B={b} R={r} P={p} C={c} bits={bits}"
              f"{f' NaN in {nan}' if nan else ''}"
              f"{' with the channel table' if table else ''}: "
              f"{int(nans.sum())} NaN in the plain version, the kernel's at "
              f"the same places and the same bits elsewhere: "
              f"{'yes' if ok else 'NO'} (max abs diff {err!r})")
        if not ok:
            raise AssertionError("consolidate kernel differs from plain")
        return err

    errs["baf_conv"] = check_baf_conv(dev)
    errs["consolidate"] = max(consolidate_case(B, R, P, C, BITS),
                              consolidate_case(B, R, P, C, BITS, table=True),
                              consolidate_case(3, 1000, 40, 40, 3),
                              consolidate_case(2, R, P, C, 12),
                              consolidate_case(2, R, P, C, BITS, nan="z"),
                              consolidate_case(2, R, P, C, BITS, nan="side"),
                              consolidate_case(2, R, P, C, 12, nan="both",
                                               table=True))
    return errs


def baf_conv_inputs(dev, b, conv, gen):
    """x (b, H, H, Cin) ~ N(0, 1), a He-normal weight and the epilogue's
    vectors (PReLU slopes in [0, 0.5), BN statistics off identity) of one
    of BAF_CONVS -> (x, weight, keyword arguments of ``baf_conv``)."""
    import torch
    from repro_torch.nn import he_normal

    _, h, cin, cout, stride, transposed, kind = conv
    x = torch.randn((b, h, h, cin), generator=gen).to(dev)
    w = he_normal((cout, cin, 3, 3), 9 * cin, gen).to(dev)
    kw = dict(stride=stride, transposed=transposed, bias=None, alpha=None,
              bn=None)
    if kind != "bn":
        kw["bias"] = (0.1 * torch.randn((cout,), generator=gen)).to(dev)
    if kind == "prelu":
        kw["alpha"] = (0.5 * torch.rand((cout,), generator=gen)).to(dev)
    if kind == "bn":
        kw["bn"] = {k: v.to(dev) for k, v in {
            "mean": 0.1 * torch.randn((cout,), generator=gen),
            "var": torch.rand((cout,), generator=gen) + 0.5,
            "scale": torch.rand((cout,), generator=gen) + 0.5,
            "bias": 0.1 * torch.randn((cout,), generator=gen)}.items()}
    return x, w, kw


def check_baf_conv(dev) -> float:
    """The baf_conv kernel against its plain version at BAF_CONVS, B=8:
    one launch a call, BAF_CONV_TOL."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.baf_conv import baf_conv, baf_conv_plain

    gen = torch.Generator().manual_seed(30)
    err = 0.0
    for conv in BAF_CONVS:
        x, w, kw = baf_conv_inputs(dev, B, conv, gen)
        before = _build.BAF_CONV.launches
        with torch.no_grad():
            got = baf_conv(x, w, **kw)
            sync(dev)
            want = baf_conv_plain(x, w, **kw)
        ok = _build.BAF_CONV.launches - before == 1 and torch.allclose(
            got, want, rtol=BAF_CONV_TOL, atol=BAF_CONV_TOL)
        diff = max_abs_diff([(got, want)])
        err = max(err, diff)
        print(f"baf_conv {conv[0]} B={B} {tuple(x.shape)} -> "
              f"{tuple(got.shape)} ({conv[6]}): kernel vs plain max abs diff "
              f"{diff!r}, max |plain| {float(want.abs().max())!r} "
              f"(tolerance {BAF_CONV_TOL} relative and absolute): "
              f"{'yes' if ok else 'NO'}")
        if not ok:
            raise AssertionError("baf_conv kernel differs from plain version")
    return err


def histogram_case(dev, codes, nsym, label, plan=None) -> float:
    """The histogram kernel against its plain version: counts exact.
    ``plan``: one the wrapper would not pick, through _launch."""
    import torch
    from repro_torch.kernels.histogram import (_launch, histogram,
                                               histogram_plain, histogram_plan)
    got = histogram(codes, nsym) if plan is None else \
        _launch(codes, nsym, plan)
    want = histogram_plain(codes, nsym)
    sync(dev)
    ok = bool(torch.equal(got, want))
    k, c = codes.shape
    plan = plan or histogram_plan(k, c, nsym)
    print(f"histogram {label} K={k} C={c} nsym={nsym} (plan {tuple(plan)}): "
          f"{'exact' if ok else 'DIFFERS'}")
    if not ok:
        raise AssertionError("histogram kernel differs from plain version")
    return max_abs_diff([(got, want)])


def quantize_zeros_case(dev, gen) -> float:
    """Exact zeros of both signs in both orders: the kernel's side info and
    codes bit-identical to the plain version on the CPU (held to jnp.min /
    jnp.max by the CPU tests); -0.0 wins the min (fp16 0x8000)."""
    import torch
    from repro_torch.kernels.quantize import quantize_fused, quantize_plain
    x = torch.randn((2, R, P), generator=gen)
    x[:, :, 0] = 0.0
    x[:, 5::2, 0] = -0.0                          # +0 first, then -0
    x[:, :, 1] = -0.0
    x[:, 3::4, 1] = 0.0                           # -0 first
    x[:, :, 2] = 0.0                              # all +0
    x[:, :, 3] = -0.0                             # all -0
    sel = torch.tensor([0, 1, 2, 3] + list(range(100, 160)), dtype=torch.int32)
    got = quantize_fused(x.to(dev), BITS, sel.to(dev))
    want = quantize_plain(x, BITS, sel.long())
    sync(dev)
    mins = got[1].cpu().view(torch.int16).to(torch.int32) & 0xFFFF
    ok = all(bits_equal(g.cpu(), w) for g, w in zip(got, want)) and \
        bool((mins[:, :2] == 0x8000).all()) and \
        bool((mins[:, 2] == 0).all()) and bool((mins[:, 3] == 0x8000).all())
    print(f"quantize with signed zeros (+0 then -0, -0 then +0, all +0, all "
          f"-0): kernel vs plain on the CPU "
          f"{'bit-identical' if ok else 'DIFFERS'}; fp16 mins of those "
          f"channels {[hex(int(v)) for v in mins[0, :4]]}")
    if not ok:
        raise AssertionError("quantize kernel orders the zeros unlike jnp")
    return max_abs_diff(zip((g.cpu() for g in got), want))


def quantize_table_out_of_range_case(dev, gen) -> float:
    """The plan's channel table with one entry's output column (C, -1) or
    column of x (P, -1) out of range, at the main path's shape: the kernel
    skips that entry, and every other output column's codes and side info
    are bit-identical to the plain version's."""
    import torch
    from repro_torch.kernels.quantize import (channel_order, quantize_fused,
                                              quantize_plain)
    x = torch.randn((2, R, P), generator=gen).to(dev)
    sel = torch.randperm(P, generator=gen)[:C].to(torch.int32).to(dev)
    want = quantize_plain(x, BITS, sel.long())
    err = 0.0
    for field, value in ((0, C), (0, -1), (1, P), (1, -1)):
        order = channel_order(sel).clone()
        j0 = int(order[5, 0])
        order[5, field] = value
        got = quantize_fused(x, BITS, sel, order=order)
        sync(dev)
        keep = [j for j in range(C) if j != j0]
        pairs = [(g[..., keep], w[..., keep]) for g, w in zip(got, want)]
        ok = all(bits_equal(g, w) for g, w in pairs)
        print(f"quantize with table entry 5's "
              f"{('output column', 'column of x')[field]} set to {value}: "
              f"the other {C - 1} columns "
              f"{'bit-identical' if ok else 'DIFFER'}")
        if not ok:
            raise AssertionError("quantize kernel follows a table entry out "
                                 "of range")
        err = max(err, max_abs_diff(pairs))
    return err


def quantize_nan_case(dev, gen) -> float:
    """One NaN: its (example, channel) gets NaN fp16 side info and zero
    codes, as the plain version (torch.amin/amax, like jnp.min/max) gives;
    every other value bit-identical."""
    import torch
    from repro_torch.kernels.quantize import quantize_fused, quantize_plain
    x = torch.randn((2, R, P), generator=gen).to(dev)
    x[1, 77, 5] = float("nan")
    got = quantize_fused(x, BITS)
    want = quantize_plain(x, BITS)
    sync(dev)
    ok = bits_equal(got[0], want[0]) and not bool(got[0][1, :, 5].any())
    for g, w in zip(got[1:], want[1:]):
        nan = torch.isnan(w)
        ok = ok and torch.equal(torch.isnan(g), nan) and int(nan.sum()) == 1 \
            and bool(nan[1, 5]) and bits_equal(g[~nan], w[~nan])
    print(f"quantize with one NaN at (1, 77, 5): NaN side info at (1, 5) "
          f"only, zero codes there, the rest bit-identical: "
          f"{'yes' if ok else 'NO'}")
    if not ok:
        raise AssertionError("quantize kernel differs on NaN input")
    return max_abs_diff(zip(got, want))


def check_lm_kernels(dev) -> dict:
    """cdf, flash attention and the linear scan against their plain
    versions on the card."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels import _build
    from repro_torch.kernels.histogram import cdf, cdf_plain
    from repro_torch.kernels.linear_scan import linear_scan, linear_scan_plain

    gen = torch.Generator(device=dev).manual_seed(7)
    errs = {"cdf": 0.0, "flash_attention": 0.0, "linear_scan": 0.0}
    for bits, c in ((8, C), (12, C), (12, 5), (1, 3)):
        counts = torch.randint(0, 1 << 20, (1 << bits, c), generator=gen,
                               device=dev, dtype=torch.int32)
        want = cdf_plain(counts)
        # row-major (S, C) as the TPU kernel; the (S, C) view of a (C, S)
        # buffer as the histogram writes it, into a (C, S) buffer as
        # channel_histogram_cdf does
        cols = counts.t().contiguous().t()
        ok = bool(torch.equal(cdf(counts), want)) and bool(torch.equal(
            cdf(cols, out=torch.empty((c, 1 << bits), dtype=torch.int32,
                                      device=dev).t()), want))
        print(f"cdf S={1 << bits} C={c}, row-major and through (C, S) "
              f"views: {'exact' if ok else 'DIFFERS'}")
        if not ok:
            raise AssertionError("cdf kernel differs from plain version")

    flash_cases = [
        # B, Sq, Sk, H, KH, hd, causal, window
        (QWEN_B, QWEN_PROMPT, QWEN_PROMPT, 28, 4, 128, True, None),  # path
        (1, 256, 256, 4, 4, 64, True, None),      # GQA g = 1, hd 64
        (2, 200, 200, 8, 2, 64, True, None),      # ragged S
        (1, 128, 128, 4, 2, 128, False, None),    # not causal
        (1, 300, 300, 14, 2, 128, True, 100),     # window, GQA 7
        (1, 64, 256, 7, 1, 128, True, None),      # Sq < Sk
        (2, 77, 131, 4, 2, 16, True, 33),         # ragged, window, Sq < Sk
        (2, 200, 200, 8, 2, 8, True, None),       # hd 8 (qwen2-72b smoke)
        (1, 77, 131, 4, 4, 8, True, 33),          # hd 8, ragged, window
    ]
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for b, sq, sk, h, kh, hd, causal, window in flash_cases:
            q = torch.randn((b, sq, h, hd), generator=gen, device=dev)
            k = torch.randn((b, sk, kh, hd), generator=gen, device=dev)
            v = torch.randn((b, sk, kh, hd), generator=gen, device=dev)
            q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
            got = flash_attention(q, k, v, causal=causal, window=window)
            want = flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
            sync(dev)
            err = max_abs_diff([(got, want)])
            tol = FLASH_TOL[name]
            ok = bool(torch.allclose(got.float(), want.float(), atol=tol,
                                     rtol=tol))
            print(f"flash {name} B={b} Sq={sq} Sk={sk} H={h} KH={kh} hd={hd} "
                  f"causal={causal} window={window}: max abs diff {err!r} "
                  f"(tolerance {tol})")
            if not ok:
                raise AssertionError("flash kernel differs from plain")
            errs["flash_attention"] = max(errs["flash_attention"], err)
    # the shapes of this slice's paths, each its own row of the JSON line:
    # the detect head (float32, not causal), the two 15B prefills (bf16)
    for label, name, (b, sq, sk, h, kh, hd, causal) in FLASH_PATH_SHAPES:
        dtype = getattr(torch, name)
        q = torch.randn((b, sq, h, hd), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, sk, kh, hd), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, sk, kh, hd), generator=gen, device=dev).to(dtype)
        got = flash_attention(q, k, v, causal=causal)
        want = flash_attention_plain(q, k, v, causal=causal)
        sync(dev)
        err = max_abs_diff([(got, want)])
        tol = FLASH_TOL[name]
        print(f"flash {name} at the {label} shape B={b} Sq={sq} Sk={sk} "
              f"H={h} KH={kh} hd={hd} causal={causal}: max abs diff {err!r} "
              f"(tolerance {tol})")
        if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
            raise AssertionError(f"flash kernel differs at the {label} shape")
        errs[f"flash_attention/{label}"] = err
        del q, k, v, got, want
    # bf16 q, k, v sliced from one fused qkv tensor: read through strides
    qkv = torch.randn((2, 130, 8 + 2 + 2, 128), generator=gen,
                      device=dev).to(torch.bfloat16)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention_plain(q, k, v, causal=True)
    sync(dev)
    err = max_abs_diff([(got, want)])
    tol = FLASH_TOL["bfloat16"]
    print(f"flash bfloat16 strided q, k, v from one (2, 130, 12, 128) qkv "
          f"tensor, strides {q.stride()}: max abs diff {err!r} (tolerance "
          f"{tol})")
    if not torch.allclose(got.float(), want.float(), atol=tol, rtol=tol):
        raise AssertionError("flash kernel differs on strided inputs")
    errs["flash_attention"] = max(errs["flash_attention"], err)

    scan_cases = [
        # label, B, S, H, dk, dv, chunk, mode, per-channel, bonus, initial
        ("", RWKV_B, RWKV_PROMPT, 40, 64, 64, 16, "rwkv", True, True, False),
        ("", RWKV_B, RWKV_BLOCK, 40, 64, 64, 16, "rwkv", True, True, True),
        ("", 2, 128, 4, 64, 64, 16, "ssm", False, False, True),
        ("", 2, 128, 4, 64, 64, 16, "ssm", True, False, False),
        ("", 1, 96, 3, 32, 48, 16, "rwkv", False, True, False),
        ("", 1, 256, 2, 32, 32, 128, "ssm", False, False, True),
    ] + [(label, QWEN_B, s_, 64, 64, 64, 128, "ssm", False, False, init)
         for label, s_, init in ZAMBA_SCAN] + [
        # a per-channel decay at chunk 128, both modes
        ("", QWEN_B, QWEN_PROMPT, 64, 64, 64, 128, "ssm", True, False, False),
        ("", QWEN_B, QWEN_PROMPT, 64, 64, 64, 128, "rwkv", True, True, True),
    ]
    for label, *_ in scan_cases:
        if label:
            errs[f"linear_scan/{label}"] = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for (label, b, s_, h, dk, dv, chunk, mode, per_ch, bonus,
             init) in scan_cases:
            def rnd(*shape, scale=0.5):
                return torch.randn(shape, generator=gen, device=dev) * scale
            q, k = rnd(b, s_, h, dk).to(dtype), rnd(b, s_, h, dk).to(dtype)
            v = rnd(b, s_, h, dv, scale=1.0).to(dtype)
            ld = -torch.exp(rnd(b, s_, h, dk if per_ch else 1) - 1.0)
            u = rnd(h, dk) if bonus else None
            s0 = rnd(b, h, dk, dv) if init else None
            got = linear_scan(q, k, v, ld, bonus=u, initial_state=s0,
                              chunk=chunk, mode=mode)
            want = linear_scan_plain(q, k, v, ld, bonus=u, initial_state=s0,
                                     chunk=chunk, mode=mode)
            sync(dev)
            err = max_abs_diff(zip(got, want))
            ok = all(torch.allclose(g, w, atol=SCAN_TOL, rtol=SCAN_TOL)
                     for g, w in zip(got, want))
            print(f"linear scan {str(dtype).split('.')[1]} B={b} S={s_} "
                  f"H={h} dk={dk} dv={dv} chunk={chunk} {mode} "
                  f"per-channel={per_ch} bonus={bonus} initial={init}: max "
                  f"abs diff {err!r} (tolerance {SCAN_TOL})")
            if not ok:
                raise AssertionError("linear-scan kernel differs from plain")
            key = f"linear_scan/{label}" if label else "linear_scan"
            errs[key] = max(errs[key], err)
    errs["linear_scan"] = max(errs["linear_scan"], scan_overflow_case(dev))
    return errs


# the overflow cases: (label, B, S, H, dk, dv, chunk, mode, per-channel
# decay, bonus), every decay at the clamp
SCAN_OVERFLOW = (
    ("chunk 32", 2, 128, 4, 64, 64, 32, "rwkv", True, True),
    ("chunk 128 at zamba2's layout", QWEN_B, QWEN_PROMPT, 64, 64, 64, 128,
     "ssm", False, False),
)


def scan_overflow_case(dev) -> float:
    """Every decay at the clamp (-4): exp(-la) overflows and exp(la)
    underflows, at chunk 32 (rwkv, a bonus) and at zamba2's chunk of 128
    ((B, S, H, 1) decay, ssm: 128 x -4, far past the ~88.7 that exp
    takes). The factorisation is kept, so the kernel's NaNs stand exactly
    where the plain version's do (at chunk 128 a masked inf * 0 makes
    every row NaN there: the tensor-core pass forms the tiles above the
    diagonal of such a chunk); the rest within SCAN_TOL."""
    import torch
    from repro_torch.kernels.linear_scan import linear_scan, linear_scan_plain
    gen = torch.Generator(device=dev).manual_seed(8)
    worst = 0.0
    for label, b, s_, h, dk, dv, chunk, mode, per_ch, bonus in SCAN_OVERFLOW:
        q, k = (torch.randn((b, s_, h, dk), generator=gen, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        v = torch.randn((b, s_, h, dv), generator=gen, device=dev) \
            .to(torch.bfloat16)
        ld = torch.full((b, s_, h, dk if per_ch else 1), -4.0, device=dev)
        u = torch.randn((h, dk), generator=gen, device=dev) * 0.5 \
            if bonus else None
        got = linear_scan(q, k, v, ld, bonus=u, chunk=chunk, mode=mode)
        want = linear_scan_plain(q, k, v, ld, bonus=u, chunk=chunk,
                                 mode=mode)
        sync(dev)
        nan = torch.isnan(want[0])
        same_nan = bool(torch.equal(torch.isnan(got[0]), nan))
        ok = same_nan and int(nan.sum()) > 0 and all(
            torch.allclose(g, w, atol=SCAN_TOL, rtol=SCAN_TOL,
                           equal_nan=True)
            for g, w in zip(got, want))
        err = max_abs_diff(zip(got, want))
        print(f"linear scan {label} at the decay clamp ({mode}, "
              f"{'per-channel' if per_ch else '(B, S, H, 1)'} decay): "
              f"{int(nan.sum())} NaN of {nan.numel()} outputs in the plain "
              f"version, kernel's NaN at the same positions: {same_nan}; "
              f"max abs diff elsewhere {err!r} (tolerance {SCAN_TOL})")
        if not ok:
            raise AssertionError(f"linear-scan kernel differs on overflow "
                                 f"({label})")
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# Phase 4: the main path at full width
# ---------------------------------------------------------------------------

def build_system(dev, cfg, seed: int = 0):
    import torch
    from repro_torch import pipeline
    from repro_torch.core.baf import BaFConv, BaFConvConfig
    from repro_torch.models.cnn import CNN

    model = CNN(cfg, seed=seed, device=dev).eval()
    baf = BaFConv(BaFConvConfig(c=C, q=cfg.split_q, hidden=HIDDEN),
                  seed=seed + 1, device=dev).eval()
    sel = np.random.default_rng(seed + 2).permutation(cfg.split_p)[:C]
    spec = pipeline.ModelSpec(sel_idx=sel, params=model, baf_params=baf)
    op = pipeline.OperatingPoint(c=C, bits=BITS, backend="rans")
    gen = torch.Generator().manual_seed(seed + 3)
    imgs = torch.randn((8, cfg.input_size, cfg.input_size, 3), generator=gen)
    return model, baf, spec, op, imgs


def run_requests(dev, model, plan, imgs, registry):
    """Eight one-image requests -> (blobs, decoded, z_tilde, logits, times)."""
    from repro_torch.obs import hooks

    t = {"edge": 0.0, "quantize_histogram_copy": 0.0, "host_rans_encode": 0.0}
    blobs = []
    host_enc = registry.histogram("stage_seconds", stage="pipeline.encode",
                                  backend=plan.op.wire_backend)
    with hooks.active(registry):
        for i in range(imgs.shape[0]):
            img = imgs[i:i + 1].to(dev)
            sync(dev)
            t0 = time.perf_counter()
            z = model.edge(img)[1]
            sync(dev)
            t1 = time.perf_counter()
            before = host_enc.total
            blobs.append(plan.encode(z))
            t2 = time.perf_counter()
            host = host_enc.total - before
            t["edge"] += t1 - t0
            t["host_rans_encode"] += host
            t["quantize_histogram_copy"] += (t2 - t1) - host
        t0 = time.perf_counter()
        decoded = plan.decode_batch(blobs)
        t1 = time.perf_counter()
        z_tilde = plan.restore(decoded)
        sync(dev)
        t2 = time.perf_counter()
        logits = model.cloud(z_tilde)
        sync(dev)
        t3 = time.perf_counter()
    n = imgs.shape[0]
    times = {k: v / n for k, v in t.items()}
    times.update(host_decode_batch=(t1 - t0) / n, restore=(t2 - t1) / n,
                 cloud=(t3 - t2) / n)
    return blobs, decoded, z_tilde, logits, times


@contextlib.contextmanager
def baf_conv_calls():
    """{``baf_conv/<conv>_b<B>``: the served restore's calls of the baf_conv
    wrapper at that shape of BAF_CONVS and batch} while the block runs,
    counted where ``core/split`` calls the wrapper. A call at a shape
    BAF_CONVS lacks raises."""
    from repro_torch.core import split

    counts = {f"baf_conv/{c[0]}_b{b}": 0 for b in (B, 32) for c in BAF_CONVS}
    wrapped = split.baf_conv

    def counted(x, weight, bias=None, *, stride=1, transposed=False, **kw):
        b, h, _, cin = x.shape
        key = (h, cin, weight.shape[0], stride, transposed)
        label = [c[0] for c in BAF_CONVS if c[1:6] == key]
        if not label:
            raise AssertionError(f"baf_conv call at {key}, not in BAF_CONVS")
        name = f"baf_conv/{label[0]}_b{b}"
        counts[name] = counts.get(name, 0) + 1
        return wrapped(x, weight, bias, stride=stride, transposed=transposed,
                       **kw)

    split.baf_conv = counted
    try:
        yield counts
    finally:
        split.baf_conv = wrapped


def check_consolidate_on_path(dev, model, baf, sel_idx, decoded, *,
                              bits: int = BITS) -> float:
    """The consolidate kernel against its plain version on a path's own
    estimate: one z~ of the decoded batch, before eq. (6), clipped by each
    on its own copy. Bit for bit."""
    import torch
    from repro_torch.core.split import restore_codes
    from repro_torch.kernels.consolidate import (consolidate_fused,
                                                 consolidate_plain)
    from repro_torch.kernels.quantize import channel_order

    sel = torch.as_tensor(np.asarray(sel_idx, np.int32), device=dev)
    order = channel_order(sel)                  # as the plan holds it
    codes = torch.from_numpy(np.ascontiguousarray(decoded.codes)).to(dev)
    mins = torch.from_numpy(decoded.mins).to(dev)
    maxs = torch.from_numpy(decoded.maxs).to(dev)
    est = restore_codes(baf, model.split, sel, codes, mins, maxs, bits=bits,
                        consolidation=False).contiguous()
    n, h, w, p = est.shape
    c = codes.shape[-1]
    flat = est.view(n, h * w, p)
    args = (codes.view(n, h * w, c), mins.view(n, c), maxs.view(n, c), bits)
    got = consolidate_fused(flat.clone(), *args, sel, order=order)
    want = consolidate_plain(flat.clone(), *args, sel.long())
    sync(dev)
    ok = bits_equal(got, want)
    err = max_abs_diff([(got, want)])
    print(f"consolidate on the path's z~ {tuple(est.shape)}, C={c}, {bits} "
          f"bits: kernel vs plain {'bit-identical' if ok else 'DIFFERS'} "
          f"(max abs diff {err!r})")
    if not ok:
        raise AssertionError("consolidate kernel differs on the path")
    return err


def main_path(dev, cfg) -> dict:
    import torch
    from repro_torch import pipeline
    from repro_torch.kernels import _build
    from repro_torch.obs import MetricsRegistry

    model, baf, spec, op, imgs = build_system(dev, cfg)
    plan = pipeline.compile(op, spec, fused=True, device=dev)
    plan_ref = pipeline.compile(op, spec, fused=False, device=dev)
    # warm-up at the same shapes, so cuDNN's choices and the caching
    # allocator are settled before the counted, timed pass
    run_requests(dev, model, plan, imgs, MetricsRegistry())

    _build.reset_launches()
    with baf_conv_calls() as by_shape:
        blobs, decoded, z_tilde, logits, times = run_requests(
            dev, model, plan, imgs, MetricsRegistry())
    launches = {k.name: k.launches for k in _build.KERNELS}
    print(f"main path launches: {launches}; baf_conv by shape: {by_shape}")
    n = imgs.shape[0]
    if not (launches["quantize"] == n and launches["histogram"] == n
            and launches["consolidate"] >= 1 and launches["baf_conv"] == 5
            and sum(by_shape.values()) == launches["baf_conv"]):
        raise AssertionError(f"main path did not run its kernels: {launches}, "
                             f"baf_conv by shape {by_shape}")
    launches.update(by_shape)

    # checks, after the counts were read
    for i, blob in enumerate(blobs):
        z = model.edge(imgs[i:i + 1].to(dev))[1]
        codes, mins, maxs = plan.quantize(z)
        if not (np.array_equal(decoded.codes[i:i + 1], codes)
                and np.array_equal(decoded.mins[i:i + 1].view(np.uint16),
                                   mins.view(np.uint16))
                and np.array_equal(decoded.maxs[i:i + 1].view(np.uint16),
                                   maxs.view(np.uint16))):
            raise AssertionError(f"request {i}: decoded codes differ")
    print("decoded codes and side info equal the encoder's: yes")
    path_codes, hist_err = histogram_on_path_codes(dev, model, spec, imgs)
    cons_err = check_consolidate_on_path(dev, model, baf, spec.sel_idx,
                                         decoded)
    ref = plan_ref.restore(decoded)
    diff = float((z_tilde - ref).abs().max())
    print(f"fused restore vs fused=False restore: max abs diff {diff!r}, "
          f"max |z~| {float(ref.abs().max())!r} (tolerance {RESTORE_TOL} "
          f"relative and absolute)")
    if not torch.allclose(z_tilde, ref, rtol=RESTORE_TOL, atol=RESTORE_TOL):
        raise AssertionError("fused and plain restore disagree")
    again = plan.restore(decoded)
    same = bits_equal(again, z_tilde)
    print(f"fused restore rerun: {'bit-identical' if same else 'DIFFERS'} "
          f"(max abs diff {max_abs_diff([(again, z_tilde)])!r})")
    if not same:
        raise AssertionError("the baf_conv restore differs when rerun")
    if tuple(logits.shape) != (n, cfg.num_classes) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"bad logits {tuple(logits.shape)}")
    print(f"logits {tuple(logits.shape)} finite: yes; z_tilde "
          f"{tuple(z_tilde.shape)}")
    wire = [b.nbytes for b in blobs]
    print(f"wire bytes per request: {wire} (mean {float(np.mean(wire))!r}, raw "
          f"fp32 split tensor {blobs[0].stats.raw_bits // 8} bytes)")

    # the same path on the CPU with the plain versions, first request:
    # the same seeds give the same weights on the CPU
    cpu = torch.device("cpu")
    cmodel, cbaf, _, _, _ = build_system(cpu, cfg)
    cspec = pipeline.ModelSpec(sel_idx=spec.sel_idx, params=cmodel,
                               baf_params=cbaf)
    cplan = pipeline.compile(op, cspec, fused=True, device=cpu)
    z0 = model.edge(imgs[:1].to(dev))[1].cpu()
    same = cplan.encode(z0).data == blobs[0].data
    crest = cplan.restore(cplan.decode(blobs[0]))
    clog = cmodel.cloud(crest)
    rd = float((crest - z_tilde[:1].cpu()).abs().max())
    ld = float((clog - logits[:1].cpu()).abs().max())
    print(f"card vs CPU, request 0: wire bytes identical {same}; restore "
          f"max abs diff {rd!r}; logits max abs diff {ld!r}, max |logit| "
          f"{float(clog.abs().max())!r} (tolerance {CPU_TOL} relative "
          f"and absolute)")
    if not (same and torch.allclose(crest, z_tilde[:1].cpu(), rtol=CPU_TOL,
                                    atol=CPU_TOL)
            and torch.allclose(clog, logits[:1].cpu(), rtol=CPU_TOL,
                               atol=CPU_TOL)):
        raise AssertionError("card and CPU paths disagree")
    return dict(launches=launches, times=times, wire=wire, z=z_tilde,
                consolidate_err=cons_err, decoded=decoded,
                path_codes=path_codes, histogram_err=hist_err)


def histogram_on_path_codes(dev, model, spec, imgs):
    """The quantize kernel's codes of request 0's z, as the plan hands them
    to the histogram -> ((K, C) codes on the card, the histogram kernel's
    error against its plain version on them). Printed beside: the mean
    share of a channel's codes on its most frequent symbol, how peaked they
    are (1/256 for uniform codes)."""
    import torch
    from repro_torch.kernels.quantize import quantize_fused
    z = model.edge(imgs[:1].to(dev))[1].contiguous()
    n, h, w, p = z.shape
    sel = torch.as_tensor(np.asarray(spec.sel_idx, np.int32), device=dev)
    codes = quantize_fused(z.view(n, h * w, p), BITS, sel)[0].view(h * w, C)
    err = histogram_case(dev, codes, 1 << BITS, "u8 the path's own codes")
    counts = codes.cpu().numpy()
    top = np.mean([np.bincount(counts[:, c]).max() / counts.shape[0]
                   for c in range(C)])
    print(f"the path's codes: mean share of a channel's most frequent "
          f"symbol {float(top)!r}")
    return codes, err


def cdf_path(dev, decoded) -> dict:
    """``channel_histogram_cdf`` on each request's decoded codes, on the
    card: the histogram and cdf kernels, exact against numpy. Then the
    device operations of one request, from the profiler: the two kernels
    and the copies (codes up, counts and CDF down), nothing else."""
    from torch.profiler import ProfilerActivity

    from repro_torch.kernels import _build
    from repro_torch.kernels.histogram import channel_histogram_cdf

    _build.reset_launches()
    n = decoded.codes.shape[0]
    outs = [channel_histogram_cdf(decoded.codes[i], BITS, device=dev)
            for i in range(n)]
    launches = {k.name: k.launches for k in _build.KERNELS}
    print(f"cdf path launches ({n} requests): {launches}")
    if launches["cdf"] != n or launches["histogram"] != n:
        raise AssertionError(f"cdf path did not run its kernels: {launches}")
    for i, (counts, cum) in enumerate(outs):
        flat = decoded.codes[i].reshape(-1, C).astype(np.int64)
        want = np.stack([np.bincount(flat[:, c], minlength=1 << BITS)
                         for c in range(C)])
        if not (np.array_equal(counts, want)
                and np.array_equal(cum, np.cumsum(want, 1) - want)):
            raise AssertionError(f"request {i}: counts or CDF differ")
    print("cdf path: counts and exclusive CDF equal numpy's for every "
          "request: yes")

    def one():
        channel_histogram_cdf(decoded.codes[0], BITS, device=dev)
        sync(dev)
    one()
    rows, _ = _device_rows(one, [ProfilerActivity.CUDA])
    copies = [(k, n) for _, k, n in rows if k.startswith("Memcpy")]
    others = [(k, n) for _, k, n in rows if not k.startswith("Memcpy")]
    n_ops = sum(n for _, _, n in rows)
    print(f"cdf path device operations per request: {n_ops} (kernels "
          f"{others}; copies {copies})")
    kernels_ok = sorted(n for _, n in others) == [1, 1] and \
        any("hist" in k for k, _ in others) and \
        any("cdf" in k for k, _ in others)
    if not (kernels_ok and sum(n for _, n in copies) == 3):
        raise AssertionError("the cdf path is not two kernels and three "
                             f"copies a request: {rows}")
    return launches


# ---------------------------------------------------------------------------
# Phase 5: the offline side of the BaF path at full width
# ---------------------------------------------------------------------------

def launch_counts() -> dict:
    from repro_torch.kernels import _build
    return {k.name: k.launches for k in _build.KERNELS}


def offline_path(dev, smi: str) -> None:
    """pretrain_cnn -> compute_channel_order -> train_baf -> eight requests
    through SplitInferenceEngine, at the paper's full width, each with the
    kernels' counts read over it alone; then the steps' times, the
    selection time and the phase's peak memory."""
    import torch
    from torch.profiler import ProfilerActivity

    from repro_torch.configs.yolo_baf import full_config
    from repro_torch.core.split import SplitInferenceEngine
    from repro_torch.data.synthetic import ShapesDatasetConfig, shapes_batch
    from repro_torch.kernels import _build
    from repro_torch.kernels.quantize import (channel_order, quantize_fused,
                                              quantize_plain)
    from repro_torch.optim import adamw_init
    from repro_torch.train import baf_trainer as bt

    cfg = full_config()
    data = ShapesDatasetConfig(image_size=cfg.input_size, num_classes=8,
                               batch_size=OFFLINE_BATCH)
    print(f"offline side: {cfg}, {data}, {TRAIN_STEPS} pretrain steps, "
          f"selection over {SELECT_BATCHES} batches, {TRAIN_STEPS} BaF "
          f"steps at C={C}, {BITS} bits, hidden {HIDDEN}")
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)

    _build.reset_launches()
    model, hist = bt.pretrain_cnn(cfg, data, steps=TRAIN_STEPS, log_every=1,
                                  verbose=False, device=dev)
    sync(dev)
    counts = {"pretrain_cnn": launch_counts()}

    _build.reset_launches()
    t0 = time.perf_counter()
    sel = bt.compute_channel_order(model, data, batches=SELECT_BATCHES,
                                   device=dev)          # ends on the host
    select_s = time.perf_counter() - t0
    counts["compute_channel_order"] = launch_counts()
    order = sel.order[:C]
    print(f"channel order (best-first): {order[:10].tolist()}...; rho "
          f"{sel.rho.shape}, top score {float(sel.scores[0])!r}")

    before = {k: v.clone() for k, v in model.state_dict().items()}
    _build.reset_launches()
    res = bt.train_baf(model, cfg, data, order, bits=BITS, hidden=HIDDEN,
                       steps=TRAIN_STEPS, log_every=1, verbose=False,
                       device=dev)
    sync(dev)
    counts["train_baf"] = launch_counts()

    _build.reset_launches()
    eng = SplitInferenceEngine(model, res.baf_params, res.sel_idx, bits=BITS,
                               backend="rans", device=dev)
    imgs, labels = shapes_batch(data._replace(batch_size=8), 10_000, 0, dev)
    logits = torch.cat([eng(imgs[i:i + 1])[0] for i in range(8)])
    sync(dev)
    counts["serve"] = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    for name, c in counts.items():
        print(f"offline side launches, {name}: {c}")

    # checks, after the counts were read
    losses = [v for _, v, _ in hist] + [v for _, v in res.losses]
    print(f"pretrain losses {[v for _, v, _ in hist]!r}, BaF losses "
          f"{[v for _, v in res.losses]!r}")
    if not all(np.isfinite(losses)) or len(losses) != 2 * TRAIN_STEPS:
        raise AssertionError(f"offline losses not finite: {losses}")
    frozen = all(torch.equal(v, before[k])
                 for k, v in model.state_dict().items()) and \
        all(q.grad is None for q in model.parameters())
    print(f"the CNN's weights and BN stats bit-identical before and after "
          f"train_baf, no gradient on them: {'yes' if frozen else 'NO'}")
    if not frozen:
        raise AssertionError("train_baf changed the frozen CNN")
    want = {"pretrain_cnn": {}, "compute_channel_order": {},
            "train_baf": {"quantize": TRAIN_STEPS},
            "serve": {"quantize": 8, "histogram": 8}}
    for name, c in counts.items():
        if {k: v for k, v in c.items() if v} != want[name]:
            raise AssertionError(f"{name} launched {c}, not {want[name]}")
    # the first BaF step's z: train_baf's stream is seed + 7, its step 0
    img0, _ = shapes_batch(data, 42 + 7, 0, dev)
    z = model.edge(img0)[1].contiguous()
    b, h, w, p = z.shape
    sel_t = torch.as_tensor(order.astype(np.int32), device=dev)
    got = quantize_fused(z.view(b, h * w, p), BITS, sel_t,
                         order=channel_order(sel_t))
    plain = quantize_plain(z.view(b, h * w, p), BITS, sel_t.long())
    sync(dev)
    same = all(bits_equal(g, q) for g, q in zip(got, plain))
    print(f"quantize kernel on the first BaF step's z {tuple(z.shape)}: "
          f"codes and side info vs plain {'bit-identical' if same else 'DIFFER'}")
    if not same:
        raise AssertionError("quantize kernel differs on the training path")
    if tuple(logits.shape) != (8, cfg.num_classes) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"bad logits {tuple(logits.shape)}")
    print(f"eight requests through SplitInferenceEngine with the trained "
          f"weights: logits {tuple(logits.shape)} finite: yes")

    # times: the trainers' own steps, on the trained weights
    img, lbl = shapes_batch(data, 1, 0, dev)
    model.requires_grad_(True)
    opt = adamw_init(bt.trainable(model))
    lr = torch.tensor(3e-3)

    def pre():
        nonlocal opt
        opt = bt.pretrain_step(model, opt, lr, img, lbl, bt.PRETRAIN_ADAMW)[0]
        sync(dev)
    baf = res.baf_params.requires_grad_(True)
    bopt = adamw_init(bt.trainable(baf))
    loss_fn = bt.make_baf_loss(model, order, BITS, device=dev)
    zb = model.edge(img)[1]

    def baf_one():
        nonlocal bopt
        bopt = bt.baf_step(baf, bopt, lr, zb, loss_fn, bt.BAF_ADAMW)[0]
        sync(dev)
    pre_ms, baf_ms = host_ms(pre), host_ms(baf_one)
    t0 = time.perf_counter()
    bt.compute_channel_order(model, data, batches=SELECT_BATCHES, device=dev)
    select_warm_s = time.perf_counter() - t0
    profile_top(dev, "pretrain step", pre)
    profile_top(dev, "BaF step", baf_one)
    profile_top(dev, "selection", lambda: bt.compute_channel_order(
        model, data, batches=SELECT_BATCHES, device=dev))
    rows, _ = _device_rows(baf_one, [ProfilerActivity.CUDA])
    quant = [(us, n) for us, k, n in rows if "quantize_kernel" in k]
    if [n for _, n in quant] != [1]:
        raise AssertionError(f"a BaF step ran the quantize kernel "
                             f"{quant} times")
    quant_ms = quant[0][0] / 1e3
    busy_ms = sum(us for us, _, _ in rows) / 1e3
    model.requires_grad_(False)
    baf.requires_grad_(False)
    print(f"offline times ({smi}): pretrain step {pre_ms!r} ms, BaF step "
          f"{baf_ms!r} ms (host clock around synchronised steps, mean of "
          f"{TIMED_STEPS}); the quantize kernel {quant_ms!r} ms of device "
          f"time within a BaF step (device busy {busy_ms!r} ms); selection "
          f"over {SELECT_BATCHES} batches {select_s * 1e3!r} ms, again "
          f"{select_warm_s * 1e3!r} ms; peak memory {peak / 1e9!r} GB")
    train_card_vs_cpu(dev)


def host_ms(fn) -> float:
    """Mean ms of ``fn`` (which ends in a sync) over TIMED_STEPS calls
    after one warm-up, on the host clock."""
    fn()
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        fn()
    return (time.perf_counter() - t0) / TIMED_STEPS * 1e3


def train_card_vs_cpu(dev) -> None:
    """At smoke scale, one pretraining step and one BaF step on the card
    against the same steps on the CPU, from the same weights (the seeded
    initialisers draw on the CPU), the same batch and, for the BaF step,
    the same z (so the same codes), at the trainers' peak learning rates.
    Gradients and the optimizer are held apart: Adam's first step is about
    lr * sign(g), so a last-bit difference in a gradient near 0 can move a
    weight by up to 2 lr. Held within CPU_TOL, relative and absolute: the
    losses, the BN running stats the step leaves, the gradients (absolute
    tolerance CPU_TOL times the leaf's largest |g|), and the weights
    AdamW's step on the card gives from the CPU's gradients against the
    CPU's step. The weights after the whole step on each are printed."""
    import torch
    from repro_torch.configs.yolo_baf import smoke_config, smoke_data_config
    from repro_torch.core.baf import BaFConv, BaFConvConfig
    from repro_torch.data.synthetic import shapes_batch
    from repro_torch.models.cnn import CNN
    from repro_torch.optim import adamw_init
    from repro_torch.train import baf_trainer as bt

    cpu = torch.device("cpu")
    cfg = smoke_config()
    c = cfg.split_p // 4
    img, lbl = shapes_batch(smoke_data_config()._replace(batch_size=8), 0, 0,
                            cpu)
    z = CNN(cfg, seed=0, device=cpu).edge(img)[1]
    sel = np.random.default_rng(5).permutation(cfg.split_p)[:c]

    def grads(d):
        """-> the two steps' halves on ``d``: (losses, gradients, BN
        stats, the modules)."""
        model = CNN(cfg, seed=0, device=d).requires_grad_(True)
        loss, _, g = bt.cnn_grads(model, img.to(d), lbl.to(d))
        baf = BaFConv(BaFConvConfig(c=c, q=cfg.split_q, hidden=16), seed=1,
                      device=d).requires_grad_(True)
        frozen = CNN(cfg, seed=0, device=d)
        bloss, bg = bt.baf_grads(baf, z.to(d), bt.make_baf_loss(
            frozen, sel, BITS, device=d))
        return [loss, bloss], [g, bg], list(model.buffers()), [model, baf]

    def steps(mods, gs, lrs):
        """AdamW's first step of both modules from gradients ``gs``."""
        for mod, g, lr, ocfg in zip(mods, gs, lrs,
                                    (bt.PRETRAIN_ADAMW, bt.BAF_ADAMW)):
            params = bt.trainable(mod)
            bt.apply_adamw(params, {k: v.to(next(iter(params.values()))
                                              .device) for k, v in g.items()},
                           adamw_init(params), lr, ocfg)
        return [q.detach().cpu() for m in mods for q in m.parameters()]

    lrs = (torch.tensor(3e-3), torch.tensor(2e-3))
    card_loss, card_g, card_bn, card_mods = grads(dev)
    cpu_loss, cpu_g, cpu_bn, cpu_mods = grads(cpu)
    ok = all(torch.allclose(a.cpu(), b, rtol=CPU_TOL, atol=CPU_TOL)
             for a, b in zip(card_loss + card_bn, cpu_loss + cpu_bn))
    worst_g = 0.0
    for ga, gb in zip(card_g, cpu_g):
        for k, b in gb.items():
            a, scale = ga[k].cpu(), float(b.abs().max())
            ok = ok and torch.allclose(a, b, rtol=CPU_TOL,
                                       atol=CPU_TOL * scale)
            worst_g = max(worst_g, float((a - b).abs().max()) / scale)
    # the optimizer: card and CPU from the CPU's gradients
    card_w = steps(card_mods, cpu_g, lrs)
    cpu_w = steps(cpu_mods, cpu_g, lrs)
    opt_err = max_abs_diff(zip(card_w, cpu_w))
    ok = ok and all(torch.allclose(a, b, rtol=CPU_TOL, atol=CPU_TOL)
                    for a, b in zip(card_w, cpu_w))
    # the whole steps, each device from its own gradients
    whole = [steps(r[3], r[1], lrs) for r in (grads(dev), grads(cpu))]
    moved = [(a - b).abs() for a, b in zip(*whole)]
    far = sum(int((m > CPU_TOL).sum()) for m in moved)
    print(f"smoke scale, one pretraining step and one BaF step, card vs CPU "
          f"(tolerance {CPU_TOL} relative and absolute): losses "
          f"{[float(v) for v in card_loss]!r} vs "
          f"{[float(v) for v in cpu_loss]!r}; largest gradient difference "
          f"{worst_g!r} of the leaf's largest |g|; BN stats max abs diff "
          f"{max_abs_diff(zip((b.cpu() for b in card_bn), cpu_bn))!r}; "
          f"AdamW on the card vs the CPU from the same gradients: max abs "
          f"diff {opt_err!r}; whole steps, each from its own gradients: max "
          f"abs diff {max(float(m.max()) for m in moved)!r}, {far} of "
          f"{sum(m.numel() for m in moved)} weights beyond the tolerance "
          f"(Adam's first step on a gradient near 0)")
    if not ok:
        raise AssertionError("training steps disagree between card and CPU")


# ---------------------------------------------------------------------------
# Phase 6: the serving gateway at full width
# ---------------------------------------------------------------------------

def serving_system(dev, cfg, bank_c, hidden: int, seed: int = 0):
    """The CNN and a BaF bank {c: (BaFConv, first c of one channel order)},
    seeded (the initialisers draw on the CPU, so every device gets the same
    weights)."""
    from repro_torch.core.baf import BaFConv, BaFConvConfig
    from repro_torch.models.cnn import CNN

    model = CNN(cfg, seed=seed, device=dev).eval()
    order = np.random.default_rng(seed + 2).permutation(cfg.split_p)
    bank = {c: (BaFConv(BaFConvConfig(c=c, q=cfg.split_q, hidden=hidden),
                        seed=seed + 1 + k, device=dev).eval(), order[:c])
            for k, c in enumerate(bank_c)}
    return model, bank


def serving_images(cfg, n: int, seed: int) -> np.ndarray:
    """n synthetic-shapes images at the config's size, as host numpy (the
    gateway's input)."""
    import torch
    from repro_torch.data.synthetic import ShapesDatasetConfig, shapes_batch
    data = ShapesDatasetConfig(image_size=cfg.input_size,
                               num_classes=cfg.num_classes, batch_size=n)
    return shapes_batch(data, seed, 0, torch.device("cpu"))[0].numpy()


def watch_batches(executor) -> list:
    """Record each micro-batch the executor runs: (batch, padded logits)."""
    seen = []
    submit = executor.submit

    def watched(batch, t_ready, *, run_fn=None):
        ticket = submit(batch, t_ready, run_fn=run_fn)
        seen.append((batch, np.asarray(ticket.logits)))
        return ticket
    executor.submit = watched
    return seen


def serving_path(dev, smi: str) -> None:
    """The BaF serving gateway at the paper's full width: the RD sweep, a
    single-tenant ServingGateway under rate control, the multi-tenant
    overload of gateway_demo part 7, then the gateway on the card against
    the CPU at smoke scale."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity

    from repro_torch.configs.yolo_baf import full_config
    from repro_torch.kernels import _build
    from repro_torch.obs import MetricsRegistry, hooks
    from repro_torch.serve import (ChannelConfig, RateController,
                                   ServingGateway, SimulatedChannel,
                                   build_rd_table, load_or_build_rd_table,
                                   rd_grid, rd_table_to_json)

    cfg = full_config()
    model, bank = serving_system(dev, cfg, SERVE_BANK, HIDDEN)
    print(f"serving: {cfg}, bank C={SERVE_BANK} (hidden {HIDDEN}), RD sweep "
          f"over {SERVE_CALIB} calibration images at bits {SERVE_BITS}, rans; "
          f"{SERVE_N} requests, max_batch {SERVE_MAX_BATCH}")
    calib = serving_images(cfg, SERVE_CALIB, 31)
    ops = rd_grid(bank, SERVE_BITS, "rans")
    key = {"calib": SERVE_CALIB, "input": cfg.input_size}
    with tempfile.TemporaryDirectory() as tmp:
        cache = Path(tmp) / "rd_cache.json"
        _build.reset_launches()
        t0 = time.perf_counter()
        table = load_or_build_rd_table(
            cache, key,
            lambda: build_rd_table(model, bank, calib, ops=ops, device=dev),
            ops=ops)
        sweep_s = time.perf_counter() - t0
        sweep = launch_counts()
        hit = json.dumps(rd_table_to_json(load_or_build_rd_table(
            cache, key, lambda: None, ops=ops))) == \
            json.dumps(rd_table_to_json(table))
    print(f"RD sweep: {sweep_s!r} s, launches {sweep} (apart from the "
          f"serve's); the cache read back gives the same table: {hit}")
    for p in table:
        print(f"  C={p.op.c:<3} bits={p.op.bits}: {p.bits_per_example!r} "
              f"wire bits/image, PSNR {p.psnr_db!r} dB, KL {p.kl!r}")
    if len(table) != len(ops) or not hit or not all(
            np.isfinite([p.psnr_db, p.kl, p.bits_per_example]).all()
            for p in table):
        raise AssertionError("RD sweep failed")
    if sweep["quantize"] < len(ops) * SERVE_CALIB or \
            sweep["histogram"] != sweep["quantize"]:
        raise AssertionError(f"the RD sweep's encodes skipped a kernel: "
                             f"{sweep}")

    floor = float(np.median([p.psnr_db for p in table]))
    budget = int(np.median([p.bits_per_example for p in table]) * 3)
    imgs = serving_images(cfg, SERVE_N, 41)
    times = [0.01 * i for i in range(SERVE_N)]
    gw = ServingGateway(
        model, bank, controller=RateController(table, quality_floor_db=floor),
        channel=SimulatedChannel(ChannelConfig(
            bandwidth_bps=100e6, base_latency_s=0.01, tick_s=0.05,
            budget_bits_per_tick=budget)),
        max_batch=SERVE_MAX_BATCH, device=dev)
    gw.serve(imgs, submit_times=times)           # warm-up, same shapes
    gw.channel.reset()
    seen = watch_batches(gw.executor)
    registry = MetricsRegistry()
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    _build.reset_launches()
    with hooks.active(registry):
        t0 = time.perf_counter()
        resp, tel = gw.serve(imgs, submit_times=times)
        wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n_batches = round(sum(1.0 / r.batch_size for r in tel.records))
    print(f"single-tenant serve launches: {launches}; micro-batches in the "
          f"telemetry {n_batches}, executor tickets {len(seen)}, sizes "
          f"{[(len(b.requests), b.padded_size) for b, _ in seen]}")
    want = {"quantize": SERVE_N, "histogram": SERVE_N,
            "consolidate": n_batches, "baf_conv": 5 * n_batches}
    if {k: v for k, v in launches.items() if v} != want or \
            n_batches != len(seen):
        raise AssertionError(f"the serve launched {launches}, not {want}")

    # checks, after the counts were read
    summ = tel.summary(wall_s=wall)
    stages = {}
    for name, labels, m in registry.collect():
        if name == "stage_seconds":
            stages[labels["stage"]] = (m.count, m.total)
    print(f"single tenant ({smi}): {SERVE_N} requests in {wall!r} s wall, "
          f"{SERVE_N / wall!r} requests/s; telemetry p50 "
          f"{summ['p50_latency_s'] * 1e3!r} ms, p99 "
          f"{summ['p99_latency_s'] * 1e3!r} ms (virtual clock: channel plus "
          f"measured compute), p50 compute {summ['p50_compute_s'] * 1e3!r} "
          f"ms; operating points {summ['operating_points']}; mean wire "
          f"bits {summ['mean_bits_on_wire']!r}; peak memory "
          f"{peak / 1e9!r} GB, of which {(peak - held) / 1e9!r} GB above "
          f"what earlier phases still held")
    for stage, (count, total) in sorted(stages.items()):
        print(f"  hooked stage {stage}: {count} calls, {total * 1e3!r} ms "
              f"host clock in all, {total / count * 1e3!r} ms a call")
    check_served(resp, seen, cfg.num_classes, SERVE_N)
    check_batch_on_path(dev, gw, seen, imgs)

    def run():
        t0 = time.perf_counter()
        gw.serve(imgs, submit_times=times)
        sync(dev)
        return time.perf_counter() - t0
    gw.channel.reset()
    rows, pwall = _device_rows(run, [ProfilerActivity.CUDA])
    busy = sum(r[0] for r in rows) / 1e6
    rows.sort(reverse=True)
    print(f"single-tenant serve under the profiler: device busy {busy * 1e3!r}"
          f" ms of {pwall * 1e3!r} ms wall (busy share {busy / pwall!r}); "
          f"top: " + "; ".join(f"{k[:50]} {us / 1e3!r} ms"
                               for us, k, _ in rows[:6]))
    overload_path(dev, model, bank, cfg)
    gateway_card_vs_cpu(dev)


def check_served(resp, seen, num_classes: int, n: int) -> None:
    """Every request answered once, with its own row of its micro-batch's
    logits (padding rows dropped), finite, of the model's width."""
    rows = {}
    for batch, logits in seen:
        if logits.shape[0] != batch.padded_size:
            raise AssertionError(f"batch of {len(batch.requests)} padded to "
                                 f"{batch.padded_size} gave {logits.shape}")
        for i, r in enumerate(batch.requests):
            rows[r.req_id] = logits[i]
    if len(resp) != n or sorted(rows) != list(range(n)):
        raise AssertionError("a request was not answered exactly once")
    for r in resp:
        if r.logits.shape != (num_classes,) or \
                not np.isfinite(r.logits).all() or \
                not np.array_equal(r.logits, rows[r.req_id]):
            raise AssertionError(f"request {r.req_id}: bad logits")
    print(f"{n} responses, one each, logits ({num_classes},) finite, each its "
          f"micro-batch's own row; padded rows dropped: yes")


def check_batch_on_path(dev, gw, seen, imgs) -> None:
    """The most padded micro-batch of the serve, again: its fused restore
    against the fused=False plan's (RESTORE_TOL), the consolidate kernel
    bit for bit against its plain version on its own estimate, and the
    quantize and histogram kernels on its first request's z."""
    import torch
    from repro_torch import pipeline
    from repro_torch.kernels.histogram import histogram, histogram_plain
    from repro_torch.kernels.quantize import quantize_fused, quantize_plain

    batch = max((b for b, _ in seen), key=lambda b: b.pad)
    op = batch.key.op
    plan = gw.plan_for(op)
    spec = gw._specs[op.c]
    ref = pipeline.compile(op, spec, fused=False, device=dev)
    decoded = plan.decode_batch([r.blob for r in batch.requests]) \
        .pad_to(batch.padded_size)
    got, want = plan.restore(decoded), ref.restore(decoded)
    diff = float((got - want).abs().max())
    baf, sel = gw.baf_bank[op.c]
    err = check_consolidate_on_path(dev, gw.params, baf, sel, decoded,
                                    bits=op.bits)
    print(f"micro-batch of {len(batch.requests)} padded to "
          f"{batch.padded_size} at {op}: fused vs fused=False restore max abs "
          f"diff {diff!r}; consolidate kernel vs plain max abs diff {err!r}")
    if not torch.allclose(got, want, rtol=RESTORE_TOL, atol=RESTORE_TOL):
        raise AssertionError("fused and plain restore disagree")
    z = gw._edge_fn(gw._to_device(imgs[batch.requests[0].req_id]))
    n, h, w, p = z.shape
    sel_t = torch.as_tensor(np.asarray(sel, np.int32), device=dev)
    q = quantize_fused(z.contiguous().view(n, h * w, p), op.bits, sel_t)
    qp = quantize_plain(z.contiguous().view(n, h * w, p), op.bits,
                        sel_t.long())
    codes = q[0].view(h * w, op.c)
    hk, hp = histogram(codes, 1 << op.bits), histogram_plain(codes,
                                                             1 << op.bits)
    sync(dev)
    same = all(bits_equal(a, b) for a, b in zip(q, qp)) and \
        bool(torch.equal(hk, hp))
    print(f"quantize and histogram kernels on a served request's z at {op}: "
          f"{'identical to' if same else 'DIFFER from'} their plain versions")
    if not same:
        raise AssertionError("kernels differ on the serving path")


def overload_path(dev, model, bank, cfg) -> None:
    """gateway_demo part 7 at full width: gold/silver/bronze, a 3x burst
    against two queues on a deterministic cost model, queue-depth admission
    by priority. Every request ends served or shed; the scheduler's grants
    are the containers' bits; a second run replays the telemetry; a traced
    run gives the same telemetry, spans that sum to each latency and a
    valid Chrome trace. A full-width container is ~300x the demo's 32x32
    one, so each tenant's link runs at 1 Gbit/s, not the demo's 50 Mbit/s:
    the burst then overloads the cloud, as in the demo, and not the
    links."""
    from repro_torch.obs import Tracer, reconcile_trace, validate_chrome_trace
    from repro_torch.pipeline import OperatingPoint
    from repro_torch.serve import (ChannelConfig, LinearCostModel,
                                   MultiQueueExecutor, MultiTenantGateway,
                                   QueueDepthAdmission, TenantRequest,
                                   TenantSpec, priority_depth_limits)

    tiers = [TenantSpec("gold", weight=2.0, priority=2),
             TenantSpec("silver", priority=1),
             TenantSpec("bronze", priority=0)]
    gw = MultiTenantGateway(
        model, bank, tenants=tiers,
        channel_cfg=ChannelConfig(bandwidth_bps=1e9, base_latency_s=0.001),
        default_op=OperatingPoint(c=min(bank), bits=8, backend="rans"),
        max_batch=4, batch_window_s=0.002,
        executor=MultiQueueExecutor(2, cost=LinearCostModel(
            base_s=0.004, per_item_s=0.001)),
        admission=QueueDepthAdmission(2, per_priority=priority_depth_limits(
            2, [0, 1, 2], headroom=2)), device=dev)
    stream = serving_images(cfg, 8, 7)
    burst = [TenantRequest(("gold", "silver", "bronze")[i % 3],
                           stream[i % len(stream)], t_submit=i / 3000.0)
             for i in range(BURST)]
    t0 = time.perf_counter()
    resp, tel = gw.serve_tenants(burst)
    wall = time.perf_counter() - t0
    served = {t: sum(not r.shed for r in rs) for t, rs in resp.items()}
    shed = tel.shed_by_tenant()
    sched = gw.last_scheduler
    grants = {t: q.granted_bits for t, q in sched.tenants.items()}
    wire = {t: sum(r.bits_on_wire for r in tel.records if r.tenant == t)
            for t in grants}
    print(f"overload ({BURST}-request burst, {wall!r} s wall): served "
          f"{served}, shed {shed}; scheduler grants {grants} bits, the "
          f"served containers {wire} bits")
    print(tel.format_summary())
    if sum(served.values()) + len(tel.shed) != BURST or grants != wire or \
            shed.get("bronze", 0) < shed.get("gold", 0) or not tel.shed:
        raise AssertionError("overload: a silent drop, a grant that is not "
                             "the container's bits, or no brown-out")
    again = gw.serve_tenants(burst)[1]
    gw.tracer = Tracer()
    traced = gw.serve_tenants(burst)[1]
    err = reconcile_trace(gw.tracer, traced)
    events = validate_chrome_trace(gw.tracer.to_chrome())
    gw.tracer.validate()
    same = again.records == tel.records and again.shed == tel.shed and \
        traced.records == tel.records and traced.shed == tel.shed
    print(f"overload replayed: telemetry identical {same}; traced run: "
          f"{len(gw.tracer)} spans, {events} Chrome trace events (valid), "
          f"span sums against latencies max error {err!r} s")
    if not same or err > 1e-9:
        raise AssertionError("overload replay or trace check failed")


def gateway_card_vs_cpu(dev) -> None:
    """At smoke scale the same gateway on the card and on the CPU: both
    edges pinned to the CPU's z, LinearCostModel, a rate controller over
    a table swept on the CPU. Wire bytes and RequestRecords identical,
    logits within GATEWAY_CPU_TOL."""
    import torch
    from repro_torch.configs.yolo_baf import smoke_config
    from repro_torch.serve import (ChannelConfig, LinearCostModel,
                                   RateController, SerialExecutor,
                                   ServingGateway, SimulatedChannel,
                                   build_rd_table)

    cpu = torch.device("cpu")
    cfg = smoke_config()._replace(input_size=64)
    imgs = serving_images(cfg, 8, 53)
    cmodel, cbank = serving_system(cpu, cfg, (4, 8), 16)
    zs = {im.tobytes(): cmodel.edge(torch.from_numpy(im[None]))[1]
          for im in imgs}
    table = build_rd_table(cmodel, cbank, imgs[:2], bits_sweep=(4, 8),
                           backend="rans", device=cpu)
    budget = int(sorted(p.bits_per_example for p in table)[2])
    runs = []
    for d in (dev, cpu):
        model, bank = (cmodel, cbank) if d == cpu else \
            serving_system(d, cfg, (4, 8), 16)
        gw = ServingGateway(
            model, bank, max_batch=4, device=d,
            controller=RateController(table, quality_floor_db=0.0),
            channel=SimulatedChannel(ChannelConfig(
                bandwidth_bps=2e6, tick_s=0.004,
                budget_bits_per_tick=budget)),
            executor=SerialExecutor(cost=LinearCostModel()))
        gw._edge_fn = lambda img, d=d: zs[img.cpu().numpy().tobytes()].to(d)
        seen = watch_batches(gw.executor)
        resp, tel = gw.serve(imgs, submit_times=[0.002 * i for i in range(8)])
        runs.append(([r.blob.data for b, _ in seen for r in b.requests],
                     tel.records, np.stack([r.logits for r in resp])))
    (wire, recs, logits), (cwire, crecs, clogits) = runs
    diff = float(np.abs(logits - clogits).max())
    ops = sorted({(r.c, r.bits) for r in recs})
    print(f"gateway card vs CPU at smoke scale ({cfg.input_size}x"
          f"{cfg.input_size}, C 4 and 8, 8 requests, operating points "
          f"{ops}): wire bytes identical {wire == cwire}, RequestRecords "
          f"identical {recs == crecs}; logits max abs diff {diff!r} "
          f"(tolerance {GATEWAY_CPU_TOL} relative and absolute)")
    if wire != cwire or recs != crecs or not np.allclose(
            logits, clogits, rtol=GATEWAY_CPU_TOL, atol=GATEWAY_CPU_TOL):
        raise AssertionError("the gateway disagrees between card and CPU")


# ---------------------------------------------------------------------------
# Phase 7: streaming sessions and multi-task heads at full width
# ---------------------------------------------------------------------------

def session_ladder():
    from repro_torch.pipeline import OperatingPoint
    from repro_torch.session import QosLevel
    return (QosLevel(OperatingPoint(c=64, bits=8, backend="rans")),
            QosLevel(OperatingPoint(c=32, bits=4, backend="rans"),
                     keyframe_interval=SESSION_KEYFRAME),
            QosLevel(OperatingPoint(c=16, bits=4, backend="rans"),
                     keyframe_interval=SESSION_KEYFRAME, frame_stride=2))


def session_clip(n: int, size: int, seed: int) -> np.ndarray:
    """A fixed camera's clip: the JAX session benchmark's sub-pixel jitter
    (~0.13 px a frame) and sensor noise, whatever the image size."""
    from repro_torch.data.synthetic import correlated_frames
    return correlated_frames(n, image_size=size,
                             drift=SESSION_JITTER_PX / size,
                             noise=SESSION_NOISE, seed=seed)


def session_task_path(dev, smi: str) -> dict:
    """Phase 7: the session codec over one clip, the SessionManager over
    four lossy sessions, the task RD sweep and the MultiTaskGateway, each
    with the kernels' counts read over it alone; then sessions and the task
    gateway on the card against the CPU at smoke scale."""
    from repro_torch.configs.yolo_baf import full_config

    cfg = full_config()
    model, bank = serving_system(dev, cfg, SERVE_BANK, HIDDEN)
    print(f"sessions and tasks: {cfg}, bank C={SERVE_BANK} (hidden "
          f"{HIDDEN}), float32, TF32 off")
    session_codec_path(dev, model, bank, cfg)
    session_manager_path(dev, smi, model, bank, cfg)
    out = task_path(dev, smi, model, bank, cfg)
    sessions_card_vs_cpu(dev)
    tasks_card_vs_cpu(dev)
    return out


def session_codec_path(dev, model, bank, cfg) -> None:
    """One lossless clip through SessionEncoder -> SessionDecoder at C=64,
    8 bits, keyframe interval 8: every decoded code tensor bit-identical to
    plan.quantize on the same z; quantize and histogram once a frame."""
    from repro_torch.kernels import _build
    from repro_torch.pipeline import OperatingPoint
    from repro_torch.serve import MultiTenantGateway, TenantSpec
    from repro_torch.session import (SessionConfig, SessionDecoder,
                                     SessionEncoder)

    gw = MultiTenantGateway(model, bank, tenants=[TenantSpec("cam")],
                            device=dev)
    op = gw._fit_op(OperatingPoint(c=64, bits=8, backend="rans"))
    scfg = SessionConfig(session_id=0, levels=(op,),
                         keyframe_interval=SESSION_KEYFRAME)
    enc = SessionEncoder(scfg, gw.plan_for)
    dec = SessionDecoder(scfg, gw.plan_for)
    clip = session_clip(SESSION_FRAMES, cfg.input_size, 77)
    zs, metas, decoded = [], [], []
    sync(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    for img in clip:
        z = gw._edge_fn(gw._to_device(img[None]))
        blob, meta = enc.encode(z)
        decoded.append(dec.decode(blob)[0].codes)
        zs.append(z)
        metas.append(meta)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    same = all(np.array_equal(d, gw.plan_for(op).quantize(z)[0])
               for d, z in zip(decoded, zs))
    i_bits = [m.wire_bits for m in metas if m.intra]
    p_bits = [m.wire_bits for m in metas if not m.intra]
    print(f"session clip ({SESSION_FRAMES} frames at {cfg.input_size}x"
          f"{cfg.input_size}, jitter {SESSION_JITTER_PX} px a frame, noise "
          f"{SESSION_NOISE}, {op}, keyframe interval {SESSION_KEYFRAME}): "
          f"{len(i_bits)} I-frames of mean {np.mean(i_bits)!r} wire bits, "
          f"{len(p_bits)} P-frames of mean {np.mean(p_bits)!r}, P/I "
          f"{np.mean(p_bits) / np.mean(i_bits)!r}; decoded codes "
          f"{'bit-identical to' if same else 'DIFFER from'} plan.quantize on "
          f"the same z; {wall!r} s wall ({wall / SESSION_FRAMES * 1e3!r} ms "
          f"a frame: edge, encode, decode); launches {launches}")
    want = {"quantize": SESSION_FRAMES, "histogram": SESSION_FRAMES}
    if not same or {k: v for k, v in launches.items() if v} != want or \
            len(i_bits) != SESSION_FRAMES // SESSION_KEYFRAME:
        raise AssertionError(f"session clip: codes differ, or launches "
                             f"{launches} are not {want}")


def session_manager_path(dev, smi, model, bank, cfg) -> None:
    """SESSIONS sessions at SESSION_FPS through a SessionManager on lossy,
    corrupting channels (one packet a frame), twice."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.pipeline import DecodedBatch
    from repro_torch.serve import (ChannelConfig, LinearCostModel,
                                   MultiQueueExecutor, MultiTenantGateway,
                                   TenantSpec)
    from repro_torch.session import (RecoveryConfig, SessionManager,
                                     SessionSpec, recovery_bound_s)

    gw = MultiTenantGateway(
        model, bank,
        tenants=[TenantSpec(f"cam{i}", priority=i % 2)
                 for i in range(SESSIONS)],
        executor=MultiQueueExecutor(2, cost=LinearCostModel(0.002, 0.0005)),
        max_batch=SERVE_MAX_BATCH, batch_window_s=0.01, device=dev)
    link = ChannelConfig(bandwidth_bps=SESSION_LINK_BPS,
                         base_latency_s=0.005, loss_p=0.05, corrupt_p=0.02)
    nack = 0.01
    mgr = SessionManager(
        gw, [SessionSpec(f"cam{i}", fps=SESSION_FPS, start_s=0.002 * i)
             for i in range(SESSIONS)],
        ladder=session_ladder(), channel_cfg=link,
        recovery=RecoveryConfig(nack_latency_s=nack), seed=3)
    frames = {f"cam{i}": session_clip(SESSION_FRAMES, cfg.input_size, 10 + i)
              for i in range(SESSIONS)}
    offered = SESSIONS * SESSION_FRAMES
    mgr.run({k: v[:2] for k, v in frames.items()})      # warm-up
    seen = watch_batches(gw.executor)
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    resp, rep = mgr.run(frames)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    batches = list(seen)
    counts = {n: rep.counts(n) for n in sorted(frames)}
    logged = sum(sum(c.values()) for c in counts.values())
    encoded = sum(f.seq >= 0 for logs in rep.frames.values() for f in logs)
    max_i = max(f.wire_bits for logs in rep.frames.values() for f in logs
                if f.intra)
    bound = recovery_bound_s(fps=SESSION_FPS,
                             uplink_latency_s=link.base_latency_s
                             + max_i / link.bandwidth_bps,
                             nack_latency_s=nack)
    worst = max(tr.max_recovery_s for tr in rep.recovery.values())
    print(f"session manager ({smi}): {SESSIONS} sessions x {SESSION_FRAMES} "
          f"frames at {SESSION_FPS} fps, links at {SESSION_LINK_BPS:g} bit/s "
          f"with loss 0.05 and corruption 0.02 a frame; outcomes {counts}; "
          f"{rep.settle_frames} settle frames; NACKs {rep.nacks}; recovery "
          f"episodes {[tr.episodes for tr in rep.recovery.values()]}, longest "
          f"{worst!r} s against 2 x bound {2 * bound!r} s; micro-batches "
          f"{[(len(b.requests), b.padded_size) for b, _ in batches]}; "
          f"launches {launches} for {encoded} encoded frames")
    print(f"session manager: {wall!r} s wall, {wall / offered * 1e3!r} ms a "
          f"frame offered; peak memory {peak / 1e9!r} GB, of which "
          f"{(peak - held) / 1e9!r} GB above what earlier phases held; "
          f"final levels {rep.final_levels}")
    want = {"quantize": encoded, "histogram": encoded,
            "consolidate": len(batches), "baf_conv": 5 * len(batches)}
    if logged != offered + rep.settle_frames or \
            any(tr.in_desync for tr in rep.recovery.values()) or \
            worst > 2 * bound or \
            {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"session manager: outcomes, sync, recovery or "
                             f"launches {launches} (want {want}) failed")
    for name in frames:
        for seq, logits in resp[name].items():
            if logits.shape != (cfg.num_classes,) or \
                    not np.isfinite(logits).all():
                raise AssertionError(f"{name} frame {seq}: bad logits")
    again = mgr.run(frames)[1]
    print(f"session manager replay: signature identical "
          f"{again.signature() == rep.signature()}")
    if again.signature() != rep.signature():
        raise AssertionError("the session run did not replay")
    batch = max(batches, key=lambda b: b[0].padded_size)[0]
    baf, sel = gw.baf_bank[batch.key.c]
    check_consolidate_on_path(
        dev, model, baf, sel, DecodedBatch(codes=batch.codes,
                                           mins=batch.mins,
                                           maxs=batch.maxs),
        bits=batch.key.bits)


def detect_qkv(head, z, hcfg):
    """The detect head's q, k, v (N, S, H, hd) on a restored z: the
    attention call's own inputs."""
    import torch
    from repro_torch import nn as tnn
    from repro_torch.models.attention import (_project_qkv, apply_rope,
                                              rope_freqs)
    with torch.no_grad():
        n, h, w, p = z.shape
        x = head.proj(tnn.leaky_relu(z).reshape(n, h * w, p))
        q, k, v = _project_qkv(head.attn, head.ln1(x), hcfg.n_heads,
                               hcfg.n_heads, hcfg.head_dim, x.dtype)
        cos, sin = rope_freqs(hcfg.head_dim, 10000.0,
                              torch.arange(h * w, device=z.device))
        return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def task_path(dev, smi, model, bank, cfg) -> dict:
    """The task RD sweep through load_or_build_task_tables, then a
    MultiTaskGateway (a full-set and a classify-only tenant) under
    MeasuredCost; returns the detect head's flash launches and its
    kernel-against-plain error at the path's shape."""
    import tempfile

    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.serve import (ChannelConfig, SerialExecutor,
                                   TenantRequest, TenantSpec, rd_grid)
    from repro_torch.tasks import (BitAllocationController, HeadConfig,
                                   MultiTaskGateway, build_task_rd_tables,
                                   init_head_bank, load_or_build_task_tables,
                                   task_set_key)

    hcfg = HeadConfig(split_p=cfg.split_p, num_classes=cfg.num_classes)
    heads = init_head_bank(torch.Generator().manual_seed(99), hcfg,
                           device=dev)
    calib = serving_images(cfg, SERVE_CALIB, 31)
    ops = rd_grid(bank, SERVE_BITS, "rans")
    weights = dict(TASK_WEIGHTS)
    tkey = task_set_key(heads, weights)
    key = {"calib": SERVE_CALIB, "input": cfg.input_size, "head_seed": 99}
    with tempfile.TemporaryDirectory() as tmp:
        cache = Path(tmp) / "rd_cache_tasks.json"
        _build.reset_launches()
        t0 = time.perf_counter()
        tables = load_or_build_task_tables(
            cache, key, lambda: build_task_rd_tables(
                model, bank, calib, head_bank=heads, head_cfg=hcfg, ops=ops,
                device=dev), ops=ops, tasks=tkey)
        sweep_s = time.perf_counter() - t0
        sweep = launch_counts()

        def missed():
            raise AssertionError("the task cache missed on its own key")
        hit = load_or_build_task_tables(cache, key, missed, ops=ops,
                                        tasks=tkey)
    print(f"task RD sweep ({SERVE_CALIB} images, {len(ops)} points, heads "
          f"{sorted(heads)}, weights {weights}): {sweep_s!r} s, launches "
          f"{sweep}; the cache hits on its key: "
          f"{sorted(hit) == sorted(tables)}")
    for task, pts in sorted(tables.items()):
        print(f"  {task}: " + "; ".join(
            f"C={p.op.c} {p.op.bits}b {p.bits_per_example!r} bits "
            f"{p.psnr_db!r} dB" for p in pts))
    # one encode per image and point, one restore (consolidate, five convs)
    # and one detect-head call (flash) per point, and the reference's flash
    # call
    want = {"quantize": len(ops) * SERVE_CALIB,
            "histogram": len(ops) * SERVE_CALIB, "consolidate": len(ops),
            "baf_conv": 5 * len(ops), "flash_attention": len(ops) + 1}
    if {k: v for k, v in sweep.items() if v} != want or not all(
            np.isfinite([p.psnr_db, p.bits_per_example]).all()
            for pts in tables.values() for p in pts):
        raise AssertionError(f"task RD sweep launched {sweep}, not {want}, "
                             f"or a point is not finite")
    # floors: classify is met at the cheapest point, detect only at its
    # best quality in the table (random weights: quality is not monotone in
    # bits), so a full-set tenant needs detect's best point and a
    # classify-only tenant the cheapest
    cheap = min(tables["classify"], key=lambda p: p.bits_per_example)
    floors = {"classify": cheap.psnr_db,
              "detect": max(p.psnr_db for p in tables["detect"])}
    alloc = BitAllocationController(tables, weights=weights, floors=floors)
    lite_pick = alloc.select(("classify",))
    full_pick = alloc.select(tuple(heads))
    print(f"allocation over the swept tables, floors {floors}: "
          f"classify-only {lite_pick.op} at {lite_pick.bits_per_example!r} "
          f"bits, full set {full_pick.op} at {full_pick.bits_per_example!r} "
          f"bits, degraded {full_pick.degraded}")
    gw = MultiTaskGateway(
        model, bank, tenants=[TenantSpec("full"),
                              TenantSpec("lite", tasks=("classify",))],
        head_bank=heads, head_cfg=hcfg, allocator=alloc,
        channel_cfg=ChannelConfig(bandwidth_bps=1e9, base_latency_s=0.005),
        max_batch=SERVE_MAX_BATCH, batch_window_s=0.02,
        executor=SerialExecutor(), device=dev)
    imgs = serving_images(cfg, 8, 43)
    # the two tenants send the same images, so their wire bits differ by
    # the operating point alone
    work = [TenantRequest(("full", "lite")[i % 2], imgs[i // 2 % 8],
                          t_submit=0.005 * i) for i in range(TASK_N)]
    gw.serve_tenants(work[:4])                          # warm-up
    gw.decode_calls, gw.head_calls = 0, {}
    seen = watch_batches(gw.executor)
    sync(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    resp, tel = gw.serve_tenants(work)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    per = tel.per_tenant()
    mean_bits = {t: per[t]["bits_on_wire"] / per[t]["count"] for t in per}
    sizes = [(len(b.requests), b.padded_size) for b, _ in seen]
    ops_used = {t: per[t]["operating_points"] for t in per}
    print(f"multi-task gateway ({smi}): {TASK_N} requests in {wall!r} s "
          f"wall; decode calls {gw.decode_calls} for {len(seen)} "
          f"micro-batches {sizes}; head calls {gw.head_calls}; launches "
          f"{launches}; mean wire bits {mean_bits}, operating points "
          f"{ops_used}")
    print(tel.format_summary())
    served = [r for rs in resp.values() for r in rs]
    if gw.decode_calls != len(seen) or \
            any(n > gw.decode_calls for n in gw.head_calls.values()) or \
            launches["flash_attention"] != gw.head_calls.get("detect", 0) or \
            launches["consolidate"] != len(seen) or \
            launches["baf_conv"] != 5 * len(seen) or \
            launches["quantize"] != TASK_N or \
            not mean_bits["lite"] < mean_bits["full"] or \
            ops_used != {"full": [(full_pick.op.c, full_pick.op.bits)],
                         "lite": [(lite_pick.op.c, lite_pick.op.bits)]} or \
            len(served) != TASK_N or any(
                not np.isfinite(v).all() for r in served
                for v in r.outputs.values()):
        raise AssertionError("multi-task gateway: decode/head/flash counts, "
                             "the subset tenant's bits or outputs failed")
    # the detect head's attention at the path's shape: kernel vs plain
    batch = max((b for b, _ in seen), key=lambda b: b.padded_size)
    plan = gw.plan_for(batch.key.op)
    z = plan.restore(plan.decode_batch([r.blob for r in batch.requests])
                     .pad_to(batch.padded_size))
    q, k, v = detect_qkv(heads["detect"], z, hcfg)
    got = flash_attention(q, k, v, causal=False)
    ref = flash_attention_plain(q, k, v, causal=False)
    err = max_abs_diff([(got, ref)])
    tol = FLASH_TOL["float32"]
    print(f"detect head's flash at the path's shape {tuple(q.shape)} "
          f"float32, not causal: kernel vs plain max abs diff {err!r} "
          f"(tolerance {tol})")
    if not torch.allclose(got, ref, rtol=tol, atol=tol):
        raise AssertionError("the detect head's flash disagrees with plain")
    del z, q, k, v, got, ref
    return dict(detect_flash=launches["flash_attention"], detect_err=err)


def sessions_card_vs_cpu(dev) -> None:
    """At smoke scale one clip through the session codec on the card and on
    the CPU, both given the CPU's z, at 8 and 12 bits (the uint16 delta):
    SSF1 frames byte-identical, decoded codes identical."""
    import torch
    from repro_torch import pipeline
    from repro_torch.configs.yolo_baf import smoke_config
    from repro_torch.session import (SessionConfig, SessionDecoder,
                                     SessionEncoder)

    cpu = torch.device("cpu")
    cfg = smoke_config()._replace(input_size=64)
    model, _ = serving_system(cpu, cfg, (8,), 16)
    clip = session_clip(12, cfg.input_size, 5)
    zs = [model.edge(torch.from_numpy(im[None]))[1] for im in clip]
    for bits in (8, 12):
        op = pipeline.OperatingPoint(c=8, bits=bits, backend="rans")
        runs = []
        for d in (dev, cpu):
            spec = pipeline.ModelSpec(sel_idx=np.arange(8))

            def plan_for(o, d=d, spec=spec):
                return pipeline.compile(o, spec, device=d)
            scfg = SessionConfig(session_id=1, levels=(op,),
                                 keyframe_interval=5)
            enc, dec = SessionEncoder(scfg, plan_for), \
                SessionDecoder(scfg, plan_for)
            blobs = [enc.encode(z.to(d))[0] for z in zs]
            runs.append((blobs, [dec.decode(b)[0].codes for b in blobs]))
        (cb, cc), (hb, hc) = runs
        same = cb == hb and all(np.array_equal(a, b) for a, b in zip(cc, hc))
        print(f"sessions card vs CPU at smoke scale ({cfg.input_size}x"
              f"{cfg.input_size}, {len(zs)} frames, {op}): SSF1 frames and "
              f"decoded codes identical {same}")
        if not same:
            raise AssertionError("the session codec differs card vs CPU")


def tasks_card_vs_cpu(dev) -> None:
    """At smoke scale the same MultiTaskGateway on the card and on the CPU:
    both edges pinned to the CPU's z, LinearCostModel, an allocator over
    hand-written tables. Records identical, head outputs within
    GATEWAY_CPU_TOL."""
    import torch
    from repro_torch.configs.yolo_baf import smoke_config
    from repro_torch.pipeline import OperatingPoint
    from repro_torch.serve import (LinearCostModel, RDPoint, SerialExecutor,
                                   TenantRequest, TenantSpec)
    from repro_torch.tasks import (BitAllocationController, HeadConfig,
                                   MultiTaskGateway, init_head_bank)

    cpu = torch.device("cpu")
    cfg = smoke_config()._replace(input_size=64)
    imgs = serving_images(cfg, 8, 59)
    cmodel, cbank = serving_system(cpu, cfg, (4, 8), 16)
    zs = {im.tobytes(): cmodel.edge(torch.from_numpy(im[None]))[1]
          for im in imgs}
    hcfg = HeadConfig(split_p=cfg.split_p, num_classes=cfg.num_classes)
    lo = OperatingPoint(c=4, bits=4, backend="rans")
    hi = OperatingPoint(c=8, bits=8, backend="rans")
    tables = {t: [RDPoint(lo, 1000.0, q_lo), RDPoint(hi, 4000.0, q_hi)]
              for t, q_lo, q_hi in (("classify", 20.0, 30.0),
                                    ("detect", 8.0, 25.0),
                                    ("embed", 15.0, 28.0))}
    floors = {"classify": 15.0, "detect": 20.0, "embed": 10.0}
    runs = []
    for d in (dev, cpu):
        model, bank = (cmodel, cbank) if d == cpu else \
            serving_system(d, cfg, (4, 8), 16)
        gw = MultiTaskGateway(
            model, bank, tenants=[TenantSpec("full"),
                                  TenantSpec("lite", tasks=("classify",))],
            head_bank=init_head_bank(torch.Generator().manual_seed(7), hcfg,
                                     device=d),
            head_cfg=hcfg, allocator=BitAllocationController(
                tables, floors=floors),
            max_batch=4, batch_window_s=0.01, device=d,
            executor=SerialExecutor(cost=LinearCostModel(0.004, 0.001)))
        gw._edge_fn = lambda img, d=d: zs[img.cpu().numpy().tobytes()].to(d)
        resp, tel = gw.serve_tenants([
            TenantRequest(("full", "lite")[i % 2], imgs[i],
                          t_submit=0.001 * i) for i in range(8)])
        outs = [(t, task, r.outputs[task]) for t in sorted(resp)
                for r in resp[t] for task in sorted(r.outputs)]
        runs.append((tel.records, gw.decode_calls, gw.head_calls, outs))
    (recs, dc, hc, outs), (crecs, cdc, chc, couts) = runs
    diff = max(float(np.abs(a[2] - b[2]).max()) for a, b in zip(outs, couts))
    ok = all(np.allclose(a[2], b[2], rtol=GATEWAY_CPU_TOL,
                         atol=GATEWAY_CPU_TOL) for a, b in zip(outs, couts))
    same = recs == crecs and (dc, hc) == (cdc, chc) and \
        [a[:2] for a in outs] == [b[:2] for b in couts]
    print(f"multi-task gateway card vs CPU at smoke scale ({cfg.input_size}x"
          f"{cfg.input_size}, 8 requests, head calls {hc}): records and "
          f"counters identical {same}; head outputs max abs diff {diff!r} "
          f"(tolerance {GATEWAY_CPU_TOL} relative and absolute)")
    if not (same and ok):
        raise AssertionError("the task gateway disagrees between card and "
                             "CPU")


# ---------------------------------------------------------------------------
# Phases 8-10: the LM serving path at full width
# ---------------------------------------------------------------------------

def _argmax_tokens(logits):
    import torch
    return torch.argmax(logits.float(), dim=-1)


def _dist(a, b) -> float:
    return max_abs_diff([(a.float(), b.float())])


def _logit_check(label, got, want, tol, why) -> float:
    """max |got - want| <= tol, with the argmax agreement; raises."""
    err = _dist(got, want)
    agree = float((_argmax_tokens(got) == _argmax_tokens(want)).float()
                  .mean())
    print(f"{label}: max abs diff {err!r}, max |logit| "
          f"{float(want.float().abs().max())!r}, tolerance {tol!r} ({why}); "
          f"argmax agreement {agree!r}")
    if not (err <= tol and torch_isfinite(got)):
        raise AssertionError(f"{label}: logits disagree")
    return err


def _f32_checks(label, pairs32, noise, pairs16, spread: float = 1.0):
    """pairs32: (name, a, b) in float32, held to LM_F32_RTOL of max |b|;
    pairs16: (name, a, b) in bf16, held to ``spread`` x ``noise``, the
    plain bf16 evaluation's distance from float32."""
    errs = {}
    for name, a, b in pairs32:
        tol = LM_F32_RTOL * float(b.float().abs().max())
        errs[name + " f32"] = _logit_check(
            f"{label} float32, {name}", a, b, tol,
            f"{LM_F32_RTOL} of max |logit|")
    why = "the plain bf16 path's distance from float32"
    for name, a, b in pairs16:
        errs[name + " bf16"] = _logit_check(
            f"{label} bf16, {name}", a, b, spread * noise,
            why if spread == 1.0 else f"{spread} x {why}")
    return errs


def _f32_copy(model):
    """The same LM with every weight upcast to float32, computing in it."""
    import copy
    import torch
    m = copy.deepcopy(model).float()
    m.cfg = model.cfg.with_(dtype=torch.float32)
    return m


def torch_isfinite(t) -> bool:
    import torch
    return bool(torch.isfinite(t.float()).all())


def _timed(dev, fn):
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def _prompt(dev, cfg, gen):
    """(tokens (B, S), prefill batch, feed(model, cache, t) -> (logits,
    cache)): token prompts, or for a vlm seeded embeddings at the embedding
    table's scale (std 0.02), fed to the cache through
    ``lm_decode_step(..., embeds=)``."""
    import torch
    from repro_torch.models.lm import lm_decode_step
    tokens = torch.randint(0, cfg.vocab, (QWEN_B, QWEN_PROMPT), generator=gen,
                           device=dev)
    if cfg.embed_inputs:
        return tokens, {"tokens": tokens}, \
            lambda m, c, t: lm_decode_step(m, c, tokens[:, t])
    embeds = (torch.randn((QWEN_B, QWEN_PROMPT, cfg.d_model), generator=gen,
                          device=dev) * 0.02).to(cfg.dtype)
    return tokens, {"embeds": embeds}, \
        lambda m, c, t: lm_decode_step(m, c, None, embeds=embeds[:, t])


def _serve_prompt(dev, cfg, model, batch, feed) -> dict:
    """The counted run of a dense, vlm or MoE LM: a warm-up prefill, then
    with the launch counts from 0 the prefill (flash once a layer), the
    cache filled by ``feed`` token by token and GEN greedy decode steps;
    launches, shapes and finiteness checked, greedy tokens, times and the
    top kernels printed -> dict(logits, last (the cache fill's last
    logits), steps (``last`` and each decode step's logits), tokens (the
    token each decode step was fed), launches, times)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.models.lm import init_decode_cache
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    name = cfg.name
    prefill, step = make_prefill_step(cfg), make_decode_step(cfg)
    prefill(model, batch)                                   # warm-up
    _build.reset_launches()
    logits, t_prefill = _timed(dev, lambda: prefill(model, batch))
    after_prefill = launch_counts()
    # room for the prompt, the decode and one profiled step
    cache = init_decode_cache(cfg, QWEN_B, QWEN_PROMPT + GEN + 1, device=dev)

    def fill():
        nonlocal cache
        out = None
        for t in range(QWEN_PROMPT):
            out, cache = feed(model, cache, t)
        return out
    last, t_fill = _timed(dev, fill)
    tok = _argmax_tokens(logits[:, -1])
    generated = [tok]
    steps = [last]

    def decode():
        nonlocal cache, tok
        for _ in range(GEN):
            lt, cache = step(model, cache, tok)
            steps.append(lt)
            tok = _argmax_tokens(lt)
            generated.append(tok)
        return lt
    last_decode, t_decode = _timed(dev, decode)
    launches = launch_counts()
    print(f"{name} launches: after prefill {after_prefill}; after cache "
          f"fill and decode {launches}")
    if launches["flash_attention"] != cfg.n_layers or \
            after_prefill["flash_attention"] != cfg.n_layers:
        raise AssertionError(f"{name} prefill launched flash "
                             f"{launches['flash_attention']} times, expected "
                             f"{cfg.n_layers}")
    peak = torch.cuda.max_memory_allocated(dev)
    if tuple(logits.shape) != (QWEN_B, QWEN_PROMPT, cfg.vocab) or \
            not all(torch_isfinite(t) for t in (logits, last, last_decode)):
        raise AssertionError(f"{name} logits have the wrong shape or are "
                             f"not finite")
    rows = [[int(t[i]) for t in generated] for i in range(QWEN_B)]
    print(f"{name} greedy tokens: {rows}")
    times = dict(prefill_ms=t_prefill * 1e3,
                 cache_fill_ms_per_token=t_fill * 1e3 / QWEN_PROMPT,
                 decode_ms_per_token=t_decode * 1e3 / GEN,
                 peak_gb=peak / 1e9)
    print(f"{name} times (host clock, synchronised; {nvidia_smi_line()}): "
          f"prefill of {QWEN_B}x{QWEN_PROMPT} "
          f"{'tokens' if cfg.embed_inputs else 'embeddings'} "
          f"{times['prefill_ms']!r} ms; cache "
          f"fill {times['cache_fill_ms_per_token']!r} ms per step; decode "
          f"{times['decode_ms_per_token']!r} ms per step of {QWEN_B} tokens; "
          f"peak memory {times['peak_gb']!r} GB")
    profile_top(dev, f"{name} prefill", lambda: prefill(model, batch))
    profile_top(dev, f"{name} decode step", lambda: step(model, cache, tok))
    del cache
    torch.cuda.empty_cache()
    return dict(logits=logits, last=last, steps=steps, tokens=generated[:GEN],
                launches=launches, times=times)


def dense_lm_path(dev, arch: str, seed: int, token_seed: int,
                  bf16_spread: float = 1.0) -> dict:
    """A dense LM at its full published config: prefill (flash kernel, one
    launch a layer), token-by-token cache fill, greedy decode, checks. The
    float32 checks run on the same weights upcast in place once the bf16
    work is done, so a 15B model's float32 copy (~62 GB) never sits beside
    its bf16 weights. The bf16 pairs are held to ``bf16_spread`` times the
    plain bf16 path's distance from float32. A vlm (pixtral-12b) prefills
    from seeded embeddings, fills its cache with them and decodes text
    tokens."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import param_count_dense
    from repro_torch.kernels import _build
    from repro_torch.models.lm import init_decode_cache, init_lm, lm_forward

    cfg = get_config(arch)
    name = cfg.name
    torch.cuda.reset_peak_memory_stats(dev)
    (model, t_init) = _timed(dev, lambda: init_lm(cfg, seed=seed,
                                                  device=dev))
    nparams = sum(p.numel() for p in model.parameters())
    print(f"{name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} q / {cfg.n_kv_heads} kv heads of {cfg.hd}, "
          f"{cfg.act}, {cfg.norm}, vocab {cfg.vocab}, {nparams} parameters "
          f"held ({param_count_dense(cfg)} by the config's count, which "
          f"leaves out norms and biases), weights in {cfg.dtype}; "
          f"initialised on the card in {t_init!r} s")
    gen = torch.Generator(device=dev).manual_seed(token_seed)
    _, batch, feed = _prompt(dev, cfg, gen)
    run = _serve_prompt(dev, cfg, model, batch, feed)
    logits, last = run["logits"], run["last"]
    # the same model with the plain attention in place of the kernel
    plain = lm_forward(model, attention="blocked", **batch)[0]
    # the same weights in float32: prefill with the kernel and with plain
    # attention, and the cache fill
    model.float()
    model.cfg = cfg.with_(dtype=torch.float32)
    _build.reset_launches()
    logits32 = lm_forward(model, **batch)[0]
    launches32 = {k.name: k.launches for k in _build.KERNELS}
    plain32 = lm_forward(model, attention="blocked", **batch)[0]
    cache32 = init_decode_cache(model.cfg, QWEN_B, QWEN_PROMPT, device=dev)
    for t in range(QWEN_PROMPT):
        last32, cache32 = feed(model, cache32, t)
    del model, cache32
    noise = _dist(plain, plain32)
    print(f"{name} bf16 against float32 of the same weights: prefill with "
          f"the kernel {_dist(logits, logits32)!r}, with plain attention "
          f"{noise!r}, cache fill {_dist(last, last32)!r} (max abs); "
          f"launches in the float32 prefill {launches32}")
    checks = _f32_checks(name, [
        ("prefill: flash kernel vs plain attention", logits32, plain32),
        ("last prompt position: prefill vs cache fill (decode attention)",
         last32, logits32[:, -1])], noise, [
        ("prefill: flash kernel vs plain attention", logits, plain),
        ("last prompt position: prefill vs cache fill (decode attention)",
         last, logits[:, -1])], spread=bf16_spread)
    del logits32, plain32, logits, plain
    torch.cuda.empty_cache()
    return dict(launches=run["launches"], times=run["times"], checks=checks,
                noise=noise, steps=run["steps"], tokens=run["tokens"],
                launches32=launches32)


def rwkv_path(dev) -> dict:
    """rwkv6-3b, full config: prefill, long ingest, decode from the ingest
    state; ingest against one long prefill."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import param_count_dense
    from repro_torch.kernels import _build
    from repro_torch.models.lm import DecodeCache, init_lm
    from repro_torch.serve.engine import (make_decode_step, make_long_ingest,
                                          make_prefill_step)

    cfg = get_config("rwkv6_3b")
    torch.cuda.reset_peak_memory_stats(dev)
    (model, t_init) = _timed(dev, lambda: init_lm(cfg, seed=1, device=dev))
    nparams = sum(p.numel() for p in model.parameters())
    print(f"rwkv6-3b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.d_model // cfg.ssm.head_dim} heads of {cfg.ssm.head_dim}, "
          f"chunk {cfg.ssm.chunk}, {nparams} parameters held "
          f"({param_count_dense(cfg)} by the config's count); initialised on "
          f"the card in {t_init!r} s")
    gen = torch.Generator(device=dev).manual_seed(11)
    prompt = torch.randint(0, cfg.vocab, (RWKV_B, RWKV_PROMPT), generator=gen,
                           device=dev)
    long_toks = torch.randint(0, cfg.vocab, (RWKV_B, RWKV_LONG),
                              generator=gen, device=dev)
    prefill = make_prefill_step(cfg)
    ingest = make_long_ingest(cfg, block=RWKV_BLOCK)
    step = make_decode_step(cfg)
    prefill(model, {"tokens": prompt})                       # warm-up
    _build.reset_launches()
    logits, t_prefill = _timed(dev, lambda: prefill(model,
                                                    {"tokens": prompt}))
    n_prefill = _build.LINEAR_SCAN.launches
    (last, state), t_ingest = _timed(dev, lambda: ingest(model, long_toks))
    n_ingest = _build.LINEAR_SCAN.launches - n_prefill
    cache = DecodeCache(rwkv=state.layer_states)
    tok = _argmax_tokens(last)
    generated = [tok]

    def decode():
        nonlocal cache, tok
        for _ in range(GEN):
            lt, cache = step(model, cache, tok)
            tok = _argmax_tokens(lt)
            generated.append(tok)
        return lt
    last_decode, t_decode = _timed(dev, decode)
    launches = {k.name: k.launches for k in _build.KERNELS}
    print(f"rwkv6-3b linear-scan launches: prefill {n_prefill} (expected "
          f"{cfg.n_layers}), ingest {n_ingest} (expected {cfg.n_layers} x "
          f"{RWKV_LONG // RWKV_BLOCK}); all launches over the path {launches}")
    if n_prefill != cfg.n_layers or \
            n_ingest != cfg.n_layers * (RWKV_LONG // RWKV_BLOCK):
        raise AssertionError("rwkv6-3b did not run the scan kernel per layer")
    peak = torch.cuda.max_memory_allocated(dev)
    if tuple(logits.shape) != (RWKV_B, RWKV_PROMPT, cfg.vocab) or \
            not torch_isfinite(logits) or not torch_isfinite(last_decode):
        raise AssertionError("rwkv6-3b logits have the wrong shape or are "
                             "not finite")
    full, t_full = _timed(dev, lambda: prefill(model, {"tokens": long_toks}))
    full = full[:, -1]
    m32 = _f32_copy(model)
    last32, _ = make_long_ingest(m32.cfg, block=RWKV_BLOCK)(m32, long_toks)
    full32 = prefill(m32, {"tokens": long_toks})[:, -1]
    del m32
    noise = _dist(full, full32)
    label = (f"last position: ingest of {RWKV_LONG} tokens in blocks of "
             f"{RWKV_BLOCK} vs one {RWKV_LONG}-token prefill")
    checks = _f32_checks("rwkv6-3b", [(label, last32, full32)], noise,
                         [(label, last, full)])
    print(f"rwkv6-3b bf16 against float32 of the same weights, last "
          f"position: {RWKV_LONG}-token prefill {noise!r}, ingest "
          f"{_dist(last, last32)!r} (max abs)")
    rows = [[int(t[i]) for t in generated] for i in range(RWKV_B)]
    print(f"rwkv6-3b greedy tokens after the ingest: {rows}")
    times = dict(prefill_ms=t_prefill * 1e3, ingest_ms=t_ingest * 1e3,
                 long_prefill_ms=t_full * 1e3,
                 decode_ms_per_token=t_decode * 1e3 / GEN,
                 peak_gb=peak / 1e9)
    print(f"rwkv6-3b times (host clock, synchronised): prefill of "
          f"{RWKV_B}x{RWKV_PROMPT} tokens {times['prefill_ms']!r} ms; ingest "
          f"of {RWKV_B}x{RWKV_LONG} {times['ingest_ms']!r} ms; one "
          f"{RWKV_LONG}-token prefill {times['long_prefill_ms']!r} ms; decode "
          f"{times['decode_ms_per_token']!r} ms per step of {RWKV_B} tokens; "
          f"peak memory {times['peak_gb']!r} GB (the one long prefill "
          f"included)")
    profile_top(dev, "rwkv6-3b prefill", lambda: prefill(model,
                                                         {"tokens": prompt}))
    profile_top(dev, f"rwkv6-3b ingest of {RWKV_LONG} tokens",
                lambda: ingest(model, long_toks))
    profile_top(dev, "rwkv6-3b decode step", lambda: step(model, cache, tok))
    del model, cache, logits, full
    torch.cuda.empty_cache()
    return dict(launches=launches, times=times, checks=checks,
                n_prefill=n_prefill, n_ingest=n_ingest)


# ---------------------------------------------------------------------------
# Phase 9b: the rest of the LM zoo at full width
# ---------------------------------------------------------------------------

def _routed(r):
    """A ``moe.Routing``'s experts with the slots its capacity dropped set
    to -1: (G, T, k). Two runs whose tables agree here up to a position
    compute the same function there (a dropped slot depends on the other
    tokens of the group)."""
    import torch
    c = r.token_for.shape[-1] - 1
    return torch.where(r.slot_pos < c, r.top_e, -1)


def _route_diffs(top_a, top_b):
    """Per-layer routed experts (``_routed``) of two runs over the same
    (B, S) tokens, each (B, S, k) -> (the (token, layer, slot) routings
    that differ, [the first position of each row routed differently in
    some layer, S if none])."""
    import torch
    b, s = top_a[0].shape[:2]
    first = torch.full((b,), s, dtype=torch.long, device=top_a[0].device)
    pos = torch.arange(s, device=first.device)
    n = 0
    for a, c in zip(top_a, top_b):
        d = a != c
        n += int(d.sum())
        first = torch.minimum(first, torch.where(d.any(-1), pos, s)
                              .min(dim=1).values)
    return n, first.tolist()


def _prefix(first, *ts):
    """Each (B, S, ...) tensor's positions of row i before ``first[i]``,
    rows concatenated: where two routings agree, every layer's input."""
    import torch
    return [torch.cat([t[i, :f] for i, f in enumerate(first)]) for t in ts]


def moe_lm_path(dev, arch: str, seed: int, token_seed: int,
                n_layers) -> dict:
    """An MoE LM at full width (``n_layers`` of its layers, or all): B=2, a
    512-token prefill (flash once a layer), the cache filled token by
    token, 16 greedy decode steps. Routing is discontinuous, so: the
    routings of the kernel's prefill and of plain attention's are counted
    apart; float32 (the weights upcast in place) holds flash against plain
    at the positions before the first routing difference of their row, and
    prefill against cache fill at a MOE_FILL_PROMPT-token prompt, where no
    slot can drop, likewise; bf16 holds flash against plain at every position
    within twice the plain path's distance from float32."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import total_param_count
    from repro_torch.models.lm import (init_decode_cache, init_lm,
                                       lm_decode_step, lm_forward)
    from repro_torch.models.moe import capacity

    full = get_config(arch)
    cfg = full if n_layers is None else full.with_(n_layers=n_layers)
    name, m = cfg.name, cfg.moe
    torch.cuda.reset_peak_memory_stats(dev)
    model, t_init = _timed(dev, lambda: init_lm(cfg, seed=seed, device=dev))
    nparams = sum(p.numel() for p in model.parameters())
    print(f"{name}: {cfg.n_layers} of its {full.n_layers} layers at full "
          f"width, d_model {cfg.d_model}, {cfg.n_heads} q / "
          f"{cfg.n_kv_heads} kv heads of {cfg.hd}, {m.num_experts} experts "
          f"of d_ff {m.d_ff_expert}, top {m.top_k}"
          f"{f', a dense residual FFN of {cfg.d_ff}' if m.dense_residual else ''}"
          f"; capacity {capacity(QWEN_PROMPT, m)} slots an expert for a row "
          f"of {QWEN_PROMPT} tokens, {capacity(QWEN_B, m)} for a decode "
          f"step; {nparams} parameters held ({total_param_count(cfg)} by "
          f"the config's count), weights in {cfg.dtype}; initialised on the "
          f"card in {t_init!r} s")
    gen = torch.Generator(device=dev).manual_seed(token_seed)
    tokens, batch, feed = _prompt(dev, cfg, gen)
    run = _serve_prompt(dev, cfg, model, batch, feed)
    logits = run["logits"]

    def routed(model):
        """(flash logits, plain logits, routings that differ, first
        differing position per row, slots dropped in the flash prefill)"""
        rf, rp = [], []
        lf = lm_forward(model, tokens=tokens, routes=rf)[0]
        lp = lm_forward(model, tokens=tokens, attention="blocked",
                        routes=rp)[0]
        n, first = _route_diffs([_routed(r) for r in rf],
                                [_routed(r) for r in rp])
        c = capacity(QWEN_PROMPT, m)
        return lf, lp, n, first, sum(int((r.slot_pos == c).sum())
                                     for r in rf)

    def short_pair(model):
        """Prefill and cache fill of the short prompt: (prefill logits,
        cache-fill logits, routings that differ, first differing position
        per row); raises where the prefill drops a slot."""
        short = tokens[:, :MOE_FILL_PROMPT]
        rp, rf, steps = [], [], []
        lp = lm_forward(model, tokens=short, routes=rp)[0]
        c = capacity(MOE_FILL_PROMPT, m)
        dropped = sum(int((r.slot_pos == c).sum()) for r in rp)
        if dropped:
            raise AssertionError(f"{name}: {dropped} slots dropped at a "
                                 f"{MOE_FILL_PROMPT}-token prompt")
        cs = init_decode_cache(model.cfg, QWEN_B, MOE_FILL_PROMPT,
                               device=dev)
        for t in range(MOE_FILL_PROMPT):
            lt, cs = lm_decode_step(model, cs, short[:, t], routes=rf)
            steps.append(lt)
        nl = model.cfg.n_layers
        fill_e = [torch.stack([_routed(rf[t * nl + j])[0]
                               for t in range(MOE_FILL_PROMPT)], dim=1)
                  for j in range(nl)]
        n, first = _route_diffs([_routed(r) for r in rp], fill_e)
        return lp, torch.stack(steps, dim=1), n, first

    lf, plain, n16, first16, drop16 = routed(model)
    ps16, fs16, nf16, ff16 = short_pair(model)
    slots = QWEN_B * QWEN_PROMPT * m.top_k * cfg.n_layers
    print(f"{name} bf16 routing: the prefill dropped {drop16} of {slots} "
          f"(token, layer, slot) routings at capacity; flash vs plain "
          f"attention: {n16} routings differ (expert or drop), first "
          f"differing position per "
          f"row {first16}; the {MOE_FILL_PROMPT}-token prompt (no slot "
          f"dropped), prefill vs cache fill: {nf16} differ, first "
          f"{ff16}; the rerun prefill is bit-identical to the counted one: "
          f"{bits_equal(lf, logits)}")
    del lf
    model.float()
    model.cfg = cfg.with_(dtype=torch.float32)
    l32, plain32, n32, first32, drop32 = routed(model)
    ps32, fs32, nf32, ff32 = short_pair(model)
    del model
    print(f"{name} float32 routing: the prefill dropped {drop32} of {slots} "
          f"routings; flash vs plain attention: {n32} differ, first "
          f"differing position per row {first32}; the short prompt's "
          f"prefill vs cache fill: {nf32} differ, first {ff32}")
    if min(first32) == 0 or min(ff32) == 0:
        raise AssertionError(f"{name}: a float32 row is routed differently "
                             f"from its first position on")
    noise = _dist(plain, plain32)
    print(f"{name} bf16 against float32 of the same weights: prefill with "
          f"the kernel {_dist(logits, l32)!r}, with plain attention "
          f"{noise!r} (max abs, routing differences included)")
    short = f"{MOE_FILL_PROMPT}-token prompt, prefill vs cache fill"
    before = "positions before the first routing difference"
    pairs16 = [("prefill: flash kernel vs plain attention", logits, plain)]
    if sum(ff16) > 0:
        pairs16.append((f"{short}, {before}", *_prefix(ff16, ps16, fs16)))
    else:
        print(f"{name} bf16 {short}: routed differently from the first "
              f"position of each row; held in float32 only")
    checks = _f32_checks(name, [
        (f"prefill: flash kernel vs plain attention, {before}",
         *_prefix(first32, l32, plain32)),
        (f"{short}, {before}", *_prefix(ff32, ps32, fs32))], noise, pairs16,
        spread=BIG_LM_BF16_SPREAD)
    del l32, plain32, logits, plain
    torch.cuda.empty_cache()
    return dict(launches=run["launches"], times=run["times"], checks=checks)


def hybrid_lm_path(dev) -> dict:
    """zamba2-1.2b, full config: B=2, a 512-token prefill (the scan once a
    Mamba-2 layer, flash once a shared-block call), the cache filled token
    by token, 16 decode steps; an ingest of ZAMBA_LONG tokens in blocks of
    ZAMBA_BLOCK (the scan only: the shared block's windowed attention is
    plain torch, as in the reference), held against one ZAMBA_LONG-token
    prefill with window=ZAMBA_BLOCK, then 16 decode steps from the ingest's
    state; the float32 checks on a float32 copy."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import param_count_dense
    from repro_torch.kernels import _build
    from repro_torch.models.lm import (init_decode_cache, init_lm, lm_forward,
                                       segment_bounds)
    from repro_torch.serve.engine import (decode_cache_from_ingest,
                                          make_decode_step, make_long_ingest,
                                          make_prefill_step)

    cfg = get_config("zamba2_1p2b")
    if cfg.hybrid.attn_window_long != ZAMBA_BLOCK:
        raise AssertionError("the ingest's block must be the long window")
    nseg, sc = len(segment_bounds(cfg)), cfg.ssm
    torch.cuda.reset_peak_memory_stats(dev)
    model, t_init = _timed(dev, lambda: init_lm(cfg, seed=ZAMBA_SEED,
                                                device=dev))
    nparams = sum(p.numel() for p in model.parameters())
    print(f"zamba2-1.2b: {cfg.n_layers} Mamba-2 layers (d_inner "
          f"{sc.expand * cfg.d_model}, {sc.expand * cfg.d_model // sc.head_dim}"
          f" heads of {sc.head_dim}, state {sc.state_dim}, chunk {sc.chunk}) "
          f"in {nseg} segments, the shared block ({cfg.n_heads} heads of "
          f"{cfg.hd}, d_ff {cfg.d_ff}) after each; {nparams} parameters held "
          f"({param_count_dense(cfg)} by the config's count); initialised on "
          f"the card in {t_init!r} s")
    gen = torch.Generator(device=dev).manual_seed(ZAMBA_SEED + 10)
    prompt = torch.randint(0, cfg.vocab, (QWEN_B, QWEN_PROMPT), generator=gen,
                           device=dev)
    long_toks = torch.randint(0, cfg.vocab, (QWEN_B, ZAMBA_LONG),
                              generator=gen, device=dev)
    batch = {"tokens": prompt}
    prefill, step = make_prefill_step(cfg), make_decode_step(cfg)
    ingest = make_long_ingest(cfg, block=ZAMBA_BLOCK)
    prefill(model, batch)                                   # warm-up
    _build.reset_launches()
    logits, t_prefill = _timed(dev, lambda: prefill(model, batch))
    n_scan, n_flash = _build.LINEAR_SCAN.launches, \
        _build.FLASH_ATTENTION.launches
    cache = init_decode_cache(cfg, QWEN_B, QWEN_PROMPT + GEN + 1, device=dev)

    def fill(model, cache):
        out = None
        for t in range(QWEN_PROMPT):
            out, cache = step(model, cache, prompt[:, t])
        return out, cache
    (last, cache), t_fill = _timed(dev, lambda: fill(model, cache))
    tok = _argmax_tokens(logits[:, -1])

    def decode(cache, tok, out):
        for _ in range(GEN):
            lt, cache = step(model, cache, tok)
            tok = _argmax_tokens(lt)
            out.append(tok)
        return lt, cache
    generated = [tok]
    (last_decode, cache), t_decode = _timed(
        dev, lambda: decode(cache, tok, generated))
    before_ingest = launch_counts()
    (last_ing, state), t_ingest = _timed(dev, lambda: ingest(model,
                                                             long_toks))
    n_scan_ingest = _build.LINEAR_SCAN.launches \
        - before_ingest["linear_scan"]
    n_flash_ingest = _build.FLASH_ATTENTION.launches \
        - before_ingest["flash_attention"]
    dcache = decode_cache_from_ingest(cfg, state, GEN + 1)
    after = [_argmax_tokens(last_ing)]
    (ldec, dcache), t_dec_ing = _timed(
        dev, lambda: decode(dcache, after[0], after))
    launches = launch_counts()
    print(f"zamba2-1.2b launches: prefill scan {n_scan} (expected "
          f"{cfg.n_layers}) and flash {n_flash} (expected {nseg}); cache "
          f"fill and decode none of either ({before_ingest}); ingest of "
          f"{ZAMBA_LONG} tokens: scan {n_scan_ingest} (expected "
          f"{cfg.n_layers} x {ZAMBA_LONG // ZAMBA_BLOCK}), flash "
          f"{n_flash_ingest}; all launches over the path {launches}")
    if (n_scan, n_flash) != (cfg.n_layers, nseg) or \
            n_scan_ingest != cfg.n_layers * (ZAMBA_LONG // ZAMBA_BLOCK) or \
            n_flash_ingest != 0 or before_ingest["linear_scan"] != n_scan or \
            before_ingest["flash_attention"] != n_flash:
        raise AssertionError("zamba2-1.2b did not launch the kernels as its "
                             "layers call them")
    peak = torch.cuda.max_memory_allocated(dev)
    if tuple(logits.shape) != (QWEN_B, QWEN_PROMPT, cfg.vocab) or not all(
            torch_isfinite(t) for t in (logits, last, last_decode, last_ing,
                                        ldec)):
        raise AssertionError("zamba2-1.2b logits have the wrong shape or are "
                             "not finite")
    plain = lm_forward(model, tokens=prompt, attention="blocked")[0]
    full, t_full = _timed(dev, lambda: lm_forward(
        model, tokens=long_toks, window=ZAMBA_BLOCK)[0][:, -1])
    rows = [[int(t[i]) for t in generated] for i in range(QWEN_B)]
    rows_ing = [[int(t[i]) for t in after] for i in range(QWEN_B)]
    print(f"zamba2-1.2b greedy tokens after the prompt: {rows}; after the "
          f"ingest: {rows_ing}")
    times = dict(prefill_ms=t_prefill * 1e3,
                 cache_fill_ms_per_token=t_fill * 1e3 / QWEN_PROMPT,
                 decode_ms_per_token=t_decode * 1e3 / GEN,
                 ingest_ms=t_ingest * 1e3, long_prefill_ms=t_full * 1e3,
                 decode_after_ingest_ms_per_token=t_dec_ing * 1e3 / GEN,
                 peak_gb=peak / 1e9)
    print(f"zamba2-1.2b times (host clock, synchronised; "
          f"{nvidia_smi_line()}): prefill of {QWEN_B}x{QWEN_PROMPT} tokens "
          f"{times['prefill_ms']!r} ms; cache fill "
          f"{times['cache_fill_ms_per_token']!r} ms per step; decode "
          f"{times['decode_ms_per_token']!r} ms per step of {QWEN_B} tokens; "
          f"ingest of {QWEN_B}x{ZAMBA_LONG} in blocks of {ZAMBA_BLOCK} "
          f"{times['ingest_ms']!r} ms; one windowed {ZAMBA_LONG}-token "
          f"prefill {times['long_prefill_ms']!r} ms; decode after the ingest "
          f"{times['decode_after_ingest_ms_per_token']!r} ms per step; peak "
          f"memory {times['peak_gb']!r} GB (before the long prefill)")
    profile_top(dev, "zamba2-1.2b prefill", lambda: prefill(model, batch))
    profile_top(dev, f"zamba2-1.2b ingest of {ZAMBA_LONG} tokens",
                lambda: ingest(model, long_toks))
    profile_top(dev, "zamba2-1.2b decode step",
                lambda: step(model, cache, tok))
    del cache, dcache, state
    torch.cuda.empty_cache()
    m32 = _f32_copy(model)
    logits32 = prefill(m32, batch)
    plain32 = lm_forward(m32, tokens=prompt, attention="blocked")[0]
    last32, _ = fill(m32, init_decode_cache(m32.cfg, QWEN_B, QWEN_PROMPT,
                                            device=dev))
    ing32, _ = make_long_ingest(m32.cfg, block=ZAMBA_BLOCK)(m32, long_toks)
    full32 = lm_forward(m32, tokens=long_toks, window=ZAMBA_BLOCK)[0][:, -1]
    del m32, model
    noise, noise_long = _dist(plain, plain32), _dist(full, full32)
    print(f"zamba2-1.2b bf16 against float32 of the same weights: prefill "
          f"with the kernels {_dist(logits, logits32)!r}, with plain "
          f"attention {noise!r}, cache fill {_dist(last, last32)!r}; the "
          f"windowed {ZAMBA_LONG}-token prefill {noise_long!r}, the ingest "
          f"{_dist(last_ing, ing32)!r} (max abs)")
    checks = _f32_checks("zamba2-1.2b", [
        ("prefill: flash kernel vs plain attention", logits32, plain32),
        ("last prompt position: prefill vs cache fill", last32,
         logits32[:, -1])], noise, [
        ("prefill: flash kernel vs plain attention", logits, plain),
        ("last prompt position: prefill vs cache fill", last,
         logits[:, -1])], spread=BIG_LM_BF16_SPREAD)
    label = (f"last position: ingest of {ZAMBA_LONG} tokens in blocks of "
             f"{ZAMBA_BLOCK} vs one {ZAMBA_LONG}-token prefill with window "
             f"{ZAMBA_BLOCK}")
    checks.update(_f32_checks("zamba2-1.2b", [(label, ing32, full32)],
                              noise_long, [(label, last_ing, full)],
                              spread=BIG_LM_BF16_SPREAD))
    del logits, plain, logits32, plain32
    torch.cuda.empty_cache()
    return dict(launches=launches, times=times, checks=checks,
                n_scan=n_scan, n_flash=n_flash, n_scan_ingest=n_scan_ingest)


def _flash_launches_by_call(fn):
    """Run ``fn`` with every flash call of ``attention_apply`` observed:
    -> (fn's result, {(causal, Sq, Sk): launches}). A call adds what the
    kernel's own counter gained over it, so a call that took the plain path
    adds 0; the counter itself is bumped only by the wrapper."""
    from repro_torch.kernels import _build
    from repro_torch.models import attention as attn_mod
    real = attn_mod.flash_attention
    tally: dict = {}

    def observed(q, k, v, *, causal=True, window=None):
        before = _build.FLASH_ATTENTION.launches
        out = real(q, k, v, causal=causal, window=window)
        key = (bool(causal), q.shape[1], k.shape[1])
        tally[key] = tally.get(key, 0) + \
            _build.FLASH_ATTENTION.launches - before
        return out
    attn_mod.flash_attention = observed
    try:
        return fn(), tally
    finally:
        attn_mod.flash_attention = real


def whisper_path(dev) -> dict:
    """whisper-tiny, full config: B=2, WHISPER_FRAMES seeded frame
    embeddings through the encoder (flash once a layer) and a
    WHISPER_TOKENS-token teacher-forced decoder pass (flash twice a layer:
    self- and cross-attention); the cache built from the encoder's output
    and filled token by token, held against the teacher-forced logits at
    every position; 16 greedy decode steps; the float32 checks on a
    float32 copy."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.encdec import (decode_train, encode,
                                           init_encdec, init_encdec_cache)
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    cfg = get_config("whisper_tiny")
    ed = cfg.encdec
    torch.cuda.reset_peak_memory_stats(dev)
    model, t_init = _timed(dev, lambda: init_encdec(cfg, seed=WHISPER_SEED,
                                                    device=dev))
    nparams = sum(p.numel() for p in model.parameters())
    print(f"whisper-tiny: {ed.enc_layers} encoder and {ed.dec_layers} "
          f"decoder layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
          f"{cfg.hd}, vocab {cfg.vocab}, {nparams} parameters held; "
          f"initialised on the card in {t_init!r} s")
    gen = torch.Generator(device=dev).manual_seed(WHISPER_SEED + 10)
    audio = torch.randn((QWEN_B, WHISPER_FRAMES, cfg.d_model), generator=gen,
                        device=dev).to(cfg.dtype)
    tokens = torch.randint(0, cfg.vocab, (QWEN_B, WHISPER_TOKENS),
                           generator=gen, device=dev)
    batch = {"audio_embeds": audio, "tokens": tokens}
    prefill, step = make_prefill_step(cfg), make_decode_step(cfg)
    prefill(model, batch)                                   # warm-up
    _build.reset_launches()
    enc, t_enc = _timed(dev, lambda: encode(model, audio))
    n_enc = _build.FLASH_ATTENTION.launches
    (logits, by_call), t_dec = _timed(dev, lambda: _flash_launches_by_call(
        lambda: decode_train(model, tokens, enc)))
    n_dec = _build.FLASH_ATTENTION.launches - n_enc
    # self-attention is causal over the tokens; cross-attention is not, and
    # its keys are the encoder's frames
    n_self = by_call.pop((True, WHISPER_TOKENS, WHISPER_TOKENS), 0)
    n_cross = by_call.pop((False, WHISPER_TOKENS, WHISPER_FRAMES), 0)
    cache = init_encdec_cache(model, enc, WHISPER_TOKENS + GEN + 1)

    def fill(model, cache):
        outs = []
        for t in range(WHISPER_TOKENS):
            lt, cache = step(model, cache, tokens[:, t])
            outs.append(lt)
        return torch.stack(outs, dim=1), cache
    (filled, cache), t_fill = _timed(dev, lambda: fill(model, cache))
    tok = _argmax_tokens(logits[:, -1])
    generated = [tok]

    def decode():
        nonlocal cache, tok
        for _ in range(GEN):
            lt, cache = step(model, cache, tok)
            tok = _argmax_tokens(lt)
            generated.append(tok)
        return lt
    last_decode, t_decode = _timed(dev, decode)
    launches = launch_counts()
    print(f"whisper-tiny flash launches: encoder {n_enc} (expected "
          f"{ed.enc_layers}), decoder pass {n_dec}: self-attention {n_self} "
          f"and cross-attention {n_cross} (expected {ed.dec_layers} each), "
          f"other calls {by_call}; all launches over the path {launches}")
    if n_enc != ed.enc_layers or n_self != ed.dec_layers or \
            n_cross != ed.dec_layers or by_call or \
            n_dec != n_self + n_cross or \
            launches["flash_attention"] != n_enc + n_dec:
        raise AssertionError("whisper-tiny did not launch flash once an "
                             "attention")
    peak = torch.cuda.max_memory_allocated(dev)
    if tuple(logits.shape) != (QWEN_B, WHISPER_TOKENS, cfg.vocab) or \
            not torch_isfinite(logits) or not torch_isfinite(last_decode):
        raise AssertionError("whisper-tiny logits have the wrong shape or "
                             "are not finite")
    plain = decode_train(model, tokens, encode(model, audio,
                                               attention="blocked"),
                         attention="blocked")
    rows = [[int(t[i]) for t in generated] for i in range(QWEN_B)]
    print(f"whisper-tiny greedy tokens: {rows}")
    times = dict(prefill_ms=(t_enc + t_dec) * 1e3, encode_ms=t_enc * 1e3,
                 cache_fill_ms_per_token=t_fill * 1e3 / WHISPER_TOKENS,
                 decode_ms_per_token=t_decode * 1e3 / GEN,
                 peak_gb=peak / 1e9)
    print(f"whisper-tiny times (host clock, synchronised; "
          f"{nvidia_smi_line()}): encoder over {QWEN_B}x{WHISPER_FRAMES} "
          f"frames {times['encode_ms']!r} ms, with the {WHISPER_TOKENS}-token "
          f"decoder pass {times['prefill_ms']!r} ms; cache fill "
          f"{times['cache_fill_ms_per_token']!r} ms per step; decode "
          f"{times['decode_ms_per_token']!r} ms per step of {QWEN_B} tokens; "
          f"peak memory {times['peak_gb']!r} GB")
    profile_top(dev, "whisper-tiny encoder and decoder pass",
                lambda: prefill(model, batch))
    profile_top(dev, "whisper-tiny decode step",
                lambda: step(model, cache, tok))
    del cache
    m32 = _f32_copy(model)
    enc32 = encode(m32, audio)
    logits32 = decode_train(m32, tokens, enc32)
    plain32 = decode_train(m32, tokens, encode(m32, audio,
                                               attention="blocked"),
                           attention="blocked")
    filled32, _ = fill(m32, init_encdec_cache(m32, enc32, WHISPER_TOKENS))
    del m32, model
    noise = _dist(plain, plain32)
    print(f"whisper-tiny bf16 against float32 of the same weights: with the "
          f"kernel {_dist(logits, logits32)!r}, with plain attention "
          f"{noise!r}, cache fill {_dist(filled, filled32)!r} (max abs)")
    every = f"every one of the {WHISPER_TOKENS} positions"
    checks = _f32_checks("whisper-tiny", [
        ("encoder and decoder pass: flash kernel vs plain attention",
         logits32, plain32),
        (f"teacher-forced pass vs cache fill, {every}", filled32,
         logits32)], noise, [
        ("encoder and decoder pass: flash kernel vs plain attention",
         logits, plain),
        (f"teacher-forced pass vs cache fill, {every}", filled, logits)],
        spread=BIG_LM_BF16_SPREAD)
    del logits, plain, filled, logits32, plain32, filled32
    torch.cuda.empty_cache()
    return dict(launches=launches, times=times, checks=checks, n_enc=n_enc,
                n_self=n_self, n_cross=n_cross)


def zoo_paths(dev) -> dict:
    """Phase 9b, one arch after another, memory freed between them ->
    the launches of each new flash and scan row on its path."""
    import torch
    launches = {}
    for arch, seed, token_seed, n_layers in ZOO_MOE:
        res = moe_lm_path(dev, arch, seed, token_seed, n_layers)
        launches[f"flash_attention/{arch}"] = \
            res["launches"]["flash_attention"]
        torch.cuda.empty_cache()
    pix = dense_lm_path(dev, *PIXTRAL, bf16_spread=BIG_LM_BF16_SPREAD)
    launches[f"flash_attention/{PIXTRAL[0]}"] = \
        pix["launches"]["flash_attention"]
    torch.cuda.empty_cache()
    zamba = hybrid_lm_path(dev)
    launches["flash_attention/zamba2_1p2b"] = zamba["n_flash"]
    launches["linear_scan/zamba2_prefill"] = zamba["n_scan"]
    launches["linear_scan/zamba2_ingest_block"] = zamba["n_scan_ingest"]
    torch.cuda.empty_cache()
    whisper = whisper_path(dev)
    launches["flash_attention/whisper_encoder"] = whisper["n_enc"]
    launches["flash_attention/whisper_decoder"] = whisper["n_self"]
    launches["flash_attention/whisper_cross"] = whisper["n_cross"]
    torch.cuda.empty_cache()
    return launches


def profile_top(dev, label: str, fn, top: int = 8) -> None:
    """Device time of one call by kernel name, and the device's busy share
    of the call's wall time."""
    from torch.profiler import ProfilerActivity
    sync(dev)

    def run():
        t0 = time.perf_counter()
        fn()
        sync(dev)
        return time.perf_counter() - t0
    rows, wall = _device_rows(run, [ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
    busy = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    print(f"{label}: device busy {busy / 1e3!r} ms of {wall * 1e3!r} ms wall "
          f"under the profiler (busy share {busy / 1e6 / wall!r}); top "
          f"kernels: " + "; ".join(f"{k[:60]} {us / 1e3!r} ms"
                                   for us, k, _ in rows[:top]))


def lms_card_vs_cpu(dev) -> float:
    """Smoke-scale LMs in float32 from one seed: kernels on the card against
    the plain versions on the CPU (prefill, 3 decode steps, the ingests
    and their states; a vlm from embeddings; whisper's encoder, decoder
    pass and 3 decode steps)."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.encdec import (decode_train, encode, init_encdec,
                                           init_encdec_cache)
    from repro_torch.models.lm import init_decode_cache, init_lm
    from repro_torch.serve.engine import (make_decode_step, make_long_ingest,
                                          make_prefill_step)

    cpu = torch.device("cpu")
    worst = 0.0
    for arch in ("qwen2_7b", "rwkv6_3b", "olmoe_1b_7b", "arctic_480b",
                 "pixtral_12b", "zamba2_1p2b", "whisper_tiny"):
        cfg = get_smoke_config(arch).with_(dtype=torch.float32)
        g = torch.Generator().manual_seed(6)
        toks = torch.randint(0, cfg.vocab, (2, 128), generator=g)
        step = make_decode_step(cfg)
        if cfg.family == "audio":
            ref = init_encdec(cfg, seed=5, device=cpu)
            card = init_encdec(cfg, seed=5, device=cpu).to(dev)
            audio = torch.randn((2, 150, cfg.d_model), generator=g)
            er, ec = encode(ref, audio), encode(card, audio.to(dev))
            pairs = [(ec, er), (decode_train(card, toks.to(dev), ec),
                                decode_train(ref, toks, er))]
            cc = init_encdec_cache(card, ec, 8)
            rc = init_encdec_cache(ref, er, 8)
        else:
            ref = init_lm(cfg, seed=5, device=cpu)
            card = init_lm(cfg, seed=5, device=cpu).to(dev)
            kw = ({"tokens": toks} if cfg.embed_inputs else
                  {"embeds": torch.randn((2, 128, cfg.d_model), generator=g)})
            prefill = make_prefill_step(cfg)
            pairs = [(prefill(card, {k: v.to(dev) for k, v in kw.items()}),
                      prefill(ref, kw))]
            cc = init_decode_cache(cfg, 2, 8, device=dev)
            rc = init_decode_cache(cfg, 2, 8, device=cpu)
        for t in range(3):
            lc, cc = step(card, cc, toks[:, t].to(dev))
            lr, rc = step(ref, rc, toks[:, t])
            pairs.append((lc, lr))
        if cfg.family in ("ssm", "hybrid"):
            ingest = make_long_ingest(cfg, block=32)
            (lc, sc), (lr, sr) = ingest(card, toks.to(dev)), ingest(ref, toks)
            pairs.append((lc, lr))
            key = "wkv" if cfg.family == "ssm" else "ssm"
            pairs += [(getattr(a, key), getattr(b, key))
                      for a, b in zip(sc.layer_states, sr.layer_states)]
            if cfg.family == "hybrid":
                pairs += list(zip(sc.shared_k, sr.shared_k))
        pairs = [(a.cpu(), b) for a, b in pairs]
        err = max_abs_diff(pairs)
        ok = all(torch.allclose(a, b, atol=LM_CPU_TOL, rtol=LM_CPU_TOL)
                 for a, b in pairs)
        what = ("encoder, decoder pass, 3 decode steps"
                if cfg.family == "audio" else
                f"prefill{' from embeddings' if not cfg.embed_inputs else ''}"
                f", 3 decode steps"
                f"{', ingest and its states' if cfg.family in ('ssm', 'hybrid') else ''}")
        print(f"{arch} smoke config in float32, card (kernels) vs CPU (plain "
              f"versions): {what}: max abs diff {err!r} (tolerance "
              f"{LM_CPU_TOL} relative and absolute)")
        if not ok:
            raise AssertionError(f"{arch}: card and CPU disagree")
        worst = max(worst, err)
    return worst


# ---------------------------------------------------------------------------
# Phase 10a: LM training
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_kernels():
    """The models' kernel calls swapped for the plain versions: flash in
    ``attention_apply``, the scan in ``chunked_linear_attention``."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.linear_scan import linear_scan_plain
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import linear_attention as la_mod
    real = attn_mod.flash_attention, la_mod.linear_scan
    attn_mod.flash_attention = (
        lambda q, k, v, *, causal=True, window=None:
        flash_attention_plain(q, k, v, causal=causal, window=window))
    la_mod.linear_scan = linear_scan_plain
    try:
        yield
    finally:
        attn_mod.flash_attention, la_mod.linear_scan = real


@contextlib.contextmanager
def phase_counts():
    """The trainer's loss-and-gradients call observed: yields a dict that
    collects the launches of each kernel made while computing the loss
    ("forward") and while taking the gradients ("backward": the remat
    recompute and the backward)."""
    import torch
    from repro_torch.train import trainer
    real = trainer._LossAndGrads.forward
    tally = {"forward": {}, "backward": {}}

    def add(part, a, b):
        for k in a:
            tally[part][k] = tally[part].get(k, 0) + b[k] - a[k]

    def observed(self, batch, leaves):
        c0 = launch_counts()
        loss = self.loss_fn(self.model, batch)
        c1 = launch_counts()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        add("forward", c0, c1)
        add("backward", c1, launch_counts())
        return loss.detach(), grads
    trainer._LossAndGrads.forward = observed
    try:
        yield tally
    finally:
        trainer._LossAndGrads.forward = real


def training_profile(dev, label: str, fn, top: int = 10) -> None:
    """One training step under ``torch.profiler`` with each microbatch's
    forward and backward (the remat recompute included) inside a named
    range that ends in a synchronise, so each kernel falls in the range
    whose host window holds its start: the device's busy time, its top
    kernels, and the busy ms and share of the forward, the backward and
    the rest (casts, accumulation, AdamW)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.train import trainer
    real = trainer._LossAndGrads.forward

    def ranged(self, batch, leaves):
        with record_function("phase:forward"):
            loss = self.loss_fn(self.model, batch)
            torch.cuda.synchronize()
        with record_function("phase:backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            torch.cuda.synchronize()
        return loss.detach(), grads
    sync(dev)
    trainer._LossAndGrads.forward = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync(dev)
            wall = time.perf_counter() - t0
    finally:
        trainer._LossAndGrads.forward = real
    events = prof.events()
    windows = {part: [(e.time_range.start, e.time_range.end)
                      for e in events if e.device_type == DeviceType.CPU
                      and e.name == f"phase:{part}"]
               for part in ("forward", "backward")}
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith("phase:")]
    busy = {"forward": 0.0, "backward": 0.0, "rest": 0.0}
    by_name: dict = {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        part = next((p for p, ws in windows.items()
                     if any(a <= e.time_range.start < b for a, b in ws)),
                    "rest")
        busy[part] += us
    total = sum(busy.values())
    if not windows["forward"] or not windows["backward"] or not total:
        raise RuntimeError(f"{label}: the profiler recorded no phase "
                           f"ranges or no device time")
    ms = {k: v / 1e3 for k, v in busy.items()}
    print(f"{label}: device busy {total / 1e3!r} ms of {wall * 1e3!r} ms "
          f"wall under the profiler (busy share {total / 1e6 / wall!r}); "
          f"of the busy time: forward {ms['forward']!r} ms "
          f"({busy['forward'] / total!r}), backward with the remat "
          f"recompute {ms['backward']!r} ms ({busy['backward'] / total!r}),"
          f" the rest (casts, accumulation, AdamW) {ms['rest']!r} ms "
          f"({busy['rest'] / total!r}); top kernels: " + "; ".join(
              f"{k[:60]} {us / 1e3!r} ms" for k, us in sorted(
                  by_name.items(), key=lambda kv: -kv[1])[:top]))


def _grad_gap(got, want) -> float:
    """max |got - want| over max |want|."""
    return _dist(got, want) / max(float(want.float().abs().max()), 1e-30)


def train_kernel_grads(dev, errs: dict) -> None:
    """The flash and scan kernels under autograd on the card, at the
    training shapes of the full-width runs below: outputs with a graph,
    one launch a call and none in the backward, the output against the
    plain version (FLASH_TOL, SCAN_TOL), and the gradients against
    autograd through the plain version: TRAIN_KERNEL_RTOL of the largest
    entry in float32; in bf16 within twice the plain bf16 gradient's
    distance from float32. Also head dim 8 and a window. The errors go
    into ``errs`` under the training rows' names."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.linear_scan import linear_scan, linear_scan_plain

    g = torch.Generator(device=dev).manual_seed(21)

    def check(label, kernel, plain, base, cot, counter, out_tol):
        """base: float32 inputs (None allowed); the first three are cast
        to the dtype, the rest stay float32. -> {dtype name: the output's
        max abs diff}."""
        worst = {}
        for dtype in (torch.float32, torch.bfloat16):
            def leaves(dt):
                return [None if t is None else
                        (t.to(dt) if i < 3 else t).detach()
                        .requires_grad_(True) for i, t in enumerate(base)]

            def grads(fn, dt):
                ins = leaves(dt)
                out = fn(*ins)
                outs = out if isinstance(out, tuple) else (out,)
                wrt = [t for t in ins if t is not None]
                return outs, torch.autograd.grad(
                    outs, wrt, [c.to(o.dtype) for c, o in zip(cot, outs)])
            before = counter.launches
            outs, got = grads(kernel, dtype)
            sync(dev)
            if counter.launches != before + 1 or outs[0].grad_fn is None:
                raise AssertionError(f"{label}: {counter.launches - before} "
                                     f"launches, grad_fn {outs[0].grad_fn}")
            pouts, want = grads(plain, dtype)
            outs = [o.detach() for o in outs]
            pouts = [o.detach() for o in pouts]
            name = str(dtype).split(".")[1]
            fwd = max_abs_diff(zip(outs, pouts))
            if not all(torch.allclose(a.float(), b.float(), atol=out_tol[name],
                                      rtol=out_tol[name])
                       for a, b in zip(outs, pouts)):
                raise AssertionError(f"{label} {name}: outputs differ")
            gaps = [_grad_gap(a, b) for a, b in zip(got, want)]
            if dtype == torch.float32:
                bound = [TRAIN_KERNEL_RTOL] * len(gaps)
                why = f"{TRAIN_KERNEL_RTOL} of the largest entry"
            else:
                _, want32 = grads(plain, torch.float32)
                bound = [2 * _grad_gap(b, c) for b, c in zip(want, want32)]
                why = "2 x the plain bf16 gradient's distance from float32"
            print(f"train kernel {label} {name}: output max abs diff "
                  f"{fwd!r}; gradients over their largest entry "
                  f"{[round(x, 9) for x in gaps]!r}, bounds "
                  f"{[round(x, 9) for x in bound]!r} ({why})")
            if not all(a <= b for a, b in zip(gaps, bound)):
                raise AssertionError(f"{label} {name}: gradients differ")
            worst[name] = fwd
        return worst

    for label, (b, sq, sk, h, kh, hd, causal, window) in FLASH_TRAIN_SHAPES:
        base = [torch.randn((b, s, n, hd), generator=g, device=dev)
                for s, n in ((sq, h), (sk, kh), (sk, kh))]
        cot = [torch.randn((b, sq, h, hd), generator=g, device=dev)]
        kw = dict(causal=causal, window=window)
        err = check(f"flash {label}", lambda q, k, v: flash_attention(
            q, k, v, **kw), lambda q, k, v: flash_attention_plain(
            q, k, v, **kw), base, cot, _build.FLASH_ATTENTION, FLASH_TOL)
        if label.startswith("train_"):
            errs[f"flash_attention/{label}"] = max(err.values())
        if label == "hd8":
            errs["flash_attention/hd8_f32"] = err["float32"]
            errs["flash_attention/hd8_bf16"] = err["bfloat16"]
    for label, (b, s_, h, dk, dv, chunk, mode) in SCAN_TRAIN_SHAPES:
        qk_heads = h if mode == "rwkv" else 1
        raw = torch.randn((b, s_, h, dk if mode == "rwkv" else 1),
                          generator=g, device=dev)
        base = [torch.randn((b, s_, qk_heads, dk), generator=g,
                            device=dev) * 0.5 for _ in range(2)] + [
            torch.randn((b, s_, h, dv), generator=g, device=dev),
            -torch.exp(raw - 1.0) if mode == "rwkv" else
            -F.softplus(raw - 2.0) * 0.6931,
            torch.randn((h, dk), generator=g, device=dev) * 0.3
            if mode == "rwkv" else None,
            torch.randn((b, h, dk, dv), generator=g, device=dev)]
        cot = [torch.randn((b, s_, h, dv), generator=g, device=dev),
               torch.randn((b, h, dk, dv), generator=g, device=dev)]

        def scan_of(fn):
            def run(q, k, v, ld, u, s0):
                return fn(q.expand(b, s_, h, dk), k.expand(b, s_, h, dk), v,
                          ld, bonus=u, initial_state=s0, chunk=chunk,
                          mode=mode)
            return run
        errs[f"linear_scan/{label}"] = max(check(
            f"scan {label}", scan_of(linear_scan), scan_of(linear_scan_plain),
            base, cot, _build.LINEAR_SCAN,
            {"float32": SCAN_TOL, "bfloat16": SCAN_TOL}).values())


def _train_batch(cfg, b, s, gen, dev) -> dict:
    """Seeded tokens (and whisper's frame embeddings) -> a training batch:
    the labels are the tokens shifted by one."""
    import torch
    tokens = torch.randint(0, cfg.vocab, (b, s + 1), generator=gen,
                           device=dev)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    if cfg.family == "audio":
        batch["audio_embeds"] = torch.randn(
            (b, WHISPER_FRAMES, cfg.d_model), generator=gen, device=dev)
    return batch


def train_smoke_card_vs_cpu(dev) -> dict:
    """Every arch at smoke scale in float32 (TF32 off), one training step
    of 2 microbatches from the same seeded weights and batch: the loss and
    the gradients on the card (the kernels forward, their plain-torch
    backward) against the CPU (the plain versions) at LM_CPU_TOL of each
    leaf's largest |g|; then AdamW's update (the trainer's, leaf by leaf
    into the state) on both from the CPU's gradients, at LM_CPU_TOL.
    qwen2-72b at its published head dim 8, and also one step of its smoke
    config as published (bf16) on the card: a finite loss. -> the flash
    launches of qwen2-72b's two steps (the head-dim-8 rows)."""
    import torch
    from repro_torch.configs import PORTED, get_smoke_config
    from repro_torch.train import trainer as tr

    cpu = torch.device("cpu")
    worst, hd8 = 0.0, {}
    for arch in PORTED:
        cfg = get_smoke_config(arch).with_(dtype=torch.float32)
        tcfg = tr.TrainConfig(num_microbatches=2, peak_lr=1e-2,
                              warmup_steps=0, total_steps=10)
        params = tr.init_params(cfg, seed=13, device=cpu)
        gen = torch.Generator().manual_seed(14)
        tokens = torch.randint(0, cfg.vocab, (4, SMOKE_TRAIN_S + 1),
                               generator=gen)
        batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        if cfg.family == "audio":
            batch["audio_embeds"] = torch.randn((4, 150, cfg.d_model),
                                                generator=gen)
        elif not cfg.embed_inputs:
            batch["embeds"] = torch.randn((4, SMOKE_TRAIN_S, cfg.d_model),
                                          generator=gen)
        grads_of = tr.make_grads_fn(cfg, tcfg)
        card_params = {k: v.detach().to(dev).requires_grad_(True)
                       for k, v in params.items()}
        before = launch_counts()
        card_loss, card_g = grads_of(card_params,
                                     {k: v.to(dev) for k, v in batch.items()})
        launched = {k: v - before[k] for k, v in launch_counts().items()
                    if v - before[k]}
        cpu_loss, cpu_g = grads_of(params, batch)
        gaps = [_grad_gap(card_g[k].cpu(), w) for k, w in cpu_g.items()]
        ok = abs(float(card_loss) - float(cpu_loss)) <= \
            LM_CPU_TOL * abs(float(cpu_loss)) and max(gaps) <= LM_CPU_TOL
        ok = ok and all(torch.allclose(card_g[k].cpu(), w, rtol=LM_CPU_TOL,
                                       atol=LM_CPU_TOL * float(w.abs().max()))
                        for k, w in cpu_g.items())
        # the update from the CPU's gradients on both devices
        lr = torch.tensor(1e-2)
        states = [tr.init_train_state(p, tcfg) for p in (card_params, params)]
        for st in states:
            d = next(iter(st.params.values())).device
            tr._update(st, {k: v.to(d) for k, v in cpu_g.items()}, lr,
                       tcfg.adamw)
        upd = max_abs_diff((states[0].params[k].detach().cpu(), v.detach())
                           for k, v in states[1].params.items())
        ok = ok and upd <= LM_CPU_TOL
        print(f"{arch} smoke training step in float32, card vs CPU (2 "
              f"microbatches; launches on the card {launched}): loss "
              f"{float(card_loss)!r} vs {float(cpu_loss)!r}; largest "
              f"gradient difference {max(gaps)!r} of the leaf's largest |g| "
              f"over {len(gaps)} leaves; AdamW from the CPU's gradients, "
              f"card vs CPU: max abs diff {upd!r} (tolerance {LM_CPU_TOL})")
        if not ok or not launched:
            raise AssertionError(f"{arch}: training step differs between "
                                 f"card and CPU")
        worst = max(worst, max(gaps))
        if arch == "qwen2_72b":
            hd8["flash_attention/hd8_f32"] = launched["flash_attention"]
            c16 = get_smoke_config(arch)
            state = tr.init_train_state(
                tr.init_params(c16, seed=13, device=dev), tcfg)
            before = launch_counts()["flash_attention"]
            _, m = tr.make_train_step(c16, tcfg)(
                state, {k: v.to(dev) for k, v in batch.items()})
            sync(dev)
            hd8["flash_attention/hd8_bf16"] = \
                launch_counts()["flash_attention"] - before
            print(f"{arch} smoke config as published ({c16.dtype}, head dim "
                  f"{c16.hd}): one training step on the card, loss "
                  f"{float(m['loss'])!r}, "
                  f"{hd8['flash_attention/hd8_bf16']} flash launches")
            if not torch_isfinite(m["loss"]):
                raise AssertionError(f"{arch}: bf16 smoke loss not finite")
    print(f"smoke training, card vs CPU: worst gradient difference "
          f"{worst!r} of the leaf's largest |g|")
    return hd8


def _expected_launches(cfg) -> dict:
    """Kernel launches of one forward the config implies."""
    if cfg.family == "audio":
        return {"flash_attention": cfg.encdec.enc_layers
                + 2 * cfg.encdec.dec_layers}
    if cfg.family == "ssm":
        return {"linear_scan": cfg.n_layers}
    if cfg.family == "hybrid":
        from repro_torch.models.lm import segment_bounds
        return {"linear_scan": cfg.n_layers,
                "flash_attention": len(segment_bounds(cfg))}
    return {"flash_attention": cfg.n_layers}


def train_full_width(dev, arch, n_layers, b, s, seed, token_seed) -> dict:
    """One arch at full width (``n_layers``: the depth kept, None for all):
    the gates on step 1 (the loss and the GATE_LEAVES gradients with the
    kernels against the plain versions swapped in, in float32 at
    TRAIN_F32_RTOL of the largest entry and in bf16 within twice the plain
    bf16 path's distance from float32; the bf16 loss the same over two
    runs), then LM_TRAIN_STEPS steps of 2 microbatches in bf16 over the
    float32 master: ms a step, tokens/s, peak memory, launches a step
    (forward and backward apart, against the config's count), and one more
    step profiled (``training_profile``) -> the launches of a step of each
    kernel, and of flash by call kind."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.train import trainer as tr

    cfg = get_config(arch)
    if n_layers is not None:
        cfg = cfg.with_(n_layers=n_layers)
    name = cfg.name
    torch.cuda.reset_peak_memory_stats(dev)
    params, t_init = _timed(dev, lambda: tr.init_params(cfg, seed=seed,
                                                        device=dev))
    nparams = sum(p.numel() for p in params.values())
    tcfg = tr.TrainConfig(num_microbatches=TRAIN_MB,
                          peak_lr=TRAIN_PEAK_LR,
                          warmup_steps=TRAIN_WARMUP,
                          total_steps=LM_TRAIN_STEPS)
    gen = torch.Generator(device=dev).manual_seed(token_seed)
    batches = [_train_batch(cfg, b, s, gen, dev)
               for _ in range(LM_TRAIN_STEPS + 1)]
    depth = (f"{cfg.n_layers} layers" if cfg.family != "audio" else
             f"{cfg.encdec.enc_layers} + {cfg.encdec.dec_layers} layers")
    print(f"{name} training: {depth}{' (cut in depth)' if n_layers else ''}"
          f", d_model {cfg.d_model}, {nparams} float32 master parameters "
          f"drawn on the card in {t_init!r} s; B={b}, S={s}"
          f"{f', {WHISPER_FRAMES} frames' if cfg.family == 'audio' else ''}"
          f", {TRAIN_MB} microbatches, remat {tcfg.remat_policy}")
    leaves = GATE_LEAVES[cfg.family]

    def gate_grads(c, plain=False):
        grads_of = tr.make_grads_fn(c, tcfg)
        if plain:
            with plain_kernels():
                loss, g = grads_of(params, batches[0])
        else:
            loss, g = grads_of(params, batches[0])
        kept = {k: g[k] for k in leaves}
        del g
        return loss, kept
    c32 = cfg.with_(dtype=torch.float32)
    k32, p32 = gate_grads(c32), gate_grads(c32, plain=True)
    k16, p16 = gate_grads(cfg), gate_grads(cfg, plain=True)
    again = gate_grads(cfg)[0]
    torch.cuda.empty_cache()
    for leaf in ("loss",) + leaves:
        pick = (lambda r: r[0]) if leaf == "loss" else (lambda r: r[1][leaf])
        gap32 = _grad_gap(pick(k32), pick(p32))
        gap16, noise = _grad_gap(pick(k16), pick(p32)), \
            _grad_gap(pick(p16), pick(p32))
        print(f"{name} step 1 {leaf}: float32 kernels vs plain {gap32!r} of "
              f"the largest entry (tolerance {TRAIN_F32_RTOL}); bf16 kernels "
              f"{gap16!r} from the plain float32, the plain bf16 path "
              f"{noise!r} (tolerance twice that)")
        if not (gap32 <= TRAIN_F32_RTOL and gap16 <= 2 * noise):
            raise AssertionError(f"{name} step 1: {leaf} differs")
    if not (torch_isfinite(k16[0]) and torch.equal(k16[0], again)):
        raise AssertionError(f"{name}: the bf16 loss of step 1 is not "
                             f"finite or differs over two runs "
                             f"({float(k16[0])!r}, {float(again)!r})")
    print(f"{name} step 1 bf16 loss {float(k16[0])!r} over two runs "
          f"{float(again)!r}; float32 {float(k32[0])!r}")
    del k32, p32, k16, p16

    state = tr.init_train_state(params, tcfg)
    step = tr.make_train_step(cfg, tcfg)
    torch.cuda.reset_peak_memory_stats(dev)
    want = _expected_launches(cfg)
    times, losses = [], []
    for i in range(LM_TRAIN_STEPS):
        with phase_counts() as tally:
            ((state, m), by_call), t = _timed(
                dev, lambda: _flash_launches_by_call(
                    lambda: step(state, batches[i])))
        times.append(t)
        losses.append(float(m["loss"]))
        fwd = {k: v for k, v in tally["forward"].items() if v}
        bwd = {k: v for k, v in tally["backward"].items() if v}
        print(f"{name} step {i + 1}: loss {losses[-1]!r}, grad norm "
              f"{float(m['grad_norm'])!r}, {t * 1e3!r} ms (host clock, "
              f"synchronised); launches in the forward {fwd}, in the "
              f"backward {bwd}")
        expect = {k: TRAIN_MB * v for k, v in want.items()}
        if fwd != expect or bwd != expect:
            raise AssertionError(f"{name}: launches {fwd} forward and {bwd} "
                                 f"backward, the config implies {expect} "
                                 f"each (remat recomputes every block)")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: a training loss is not finite")
    tokens = b * s
    steady = sum(times[1:]) / (len(times) - 1)
    print(f"{name} training ({nvidia_smi_line()}): {steady * 1e3!r} ms a "
          f"step (steps 2-{LM_TRAIN_STEPS}; step 1 {times[0] * 1e3!r} ms), "
          f"{tokens / steady!r} tokens/s, peak memory {peak!r} GB; losses "
          f"{losses!r}")
    training_profile(dev, f"{name} training step",
                     lambda: step(state, batches[LM_TRAIN_STEPS]))
    del state, step, params
    torch.cuda.empty_cache()
    return dict(launches={k: fwd[k] + bwd[k] for k in fwd}, by_call=by_call,
                loss1=losses[0])


def training_path(dev, errs: dict) -> tuple[dict, dict]:
    """Phase 10a -> (the launches of each training row of the JSON line: a
    step's (forward and recompute) launches of flash and the scan at the
    full-width runs' shapes; each full-width arch's step-1 loss)."""
    import torch
    train_kernel_grads(dev, errs)
    launches = train_smoke_card_vs_cpu(dev)
    loss1 = {}
    for arch, n_layers, b, s, seed, token_seed in TRAIN_FULL:
        res = train_full_width(dev, arch, n_layers, b, s, seed, token_seed)
        loss1[arch] = res["loss1"]
        if arch == "whisper_tiny":
            for label, key in (("encoder", (False, WHISPER_FRAMES,
                                            WHISPER_FRAMES)),
                               ("decoder", (True, s, s)),
                               ("cross", (False, s, WHISPER_FRAMES))):
                launches[f"flash_attention/train_whisper_{label}"] = \
                    res["by_call"].get(key, 0)
        else:
            for k, v in res["launches"].items():
                launches[f"{k}/train_{arch}"] = v
        torch.cuda.empty_cache()
    return launches, loss1


# ---------------------------------------------------------------------------
# Phase 10b/10c: distributed training and the pod pipeline
# ---------------------------------------------------------------------------

# qwen2-7b's hidden stream at a stage boundary: B=2 x POD_S tokens through
# layers 0..POD_LAYER-1 (bf16), sent to the pod that runs layer POD_LAYER;
# the subset transfer sends POD_C of the 3584 channels, restored by a
# stream BaF predictor of hidden width POD_HIDDEN.
POD_S, POD_LAYER, POD_C, POD_HIDDEN = 4096, 14, 896, 512
# the subset transfer in float32, card against CPU: 1e-3 of the largest
# entry (a decoder block's float32 sums in another order)
POD_CPU_RTOL = 1e-3
# the flash-decode at full width (world size 1): bf16 logits within
# FLASH_DECODE_SPREAD x the plain bf16 prefill's distance from float32
FLASH_DECODE_SPREAD = 2.0
# two gloo ranks sharing the card: qwen2-7b's smoke config in float32,
# GLOO_STEPS steps on a global batch of GLOO_B x GLOO_S; step 1's loss
# within 1e-4 relative of the same run on the CPU, steps 2-3 within 1e-3
# (a gradient code can flip between the devices, which Adam makes a whole
# step); the sequence-sharded decode at the layer level at qwen2-7b's
# heads (B, H, K, hd) over a cache of DECODE_S slots, half a rank, at
# 1e-5 of the largest entry in float32
GLOO_STEPS, GLOO_B, GLOO_S = 3, 8, 64
GLOO_STEP1_RTOL, GLOO_LATER_RTOL = 1e-4, 1e-3
DECODE_HEADS, DECODE_S = (2, 28, 4, 128), 32768
DECODE_RTOL = 1e-5
GLOO_TIMEOUT_S = 300


def _plain_exchange(g, bits: int):
    """The compressed mean at one pod in plain torch: (mean, residual)."""
    import torch
    levels = (1 << (bits - 1)) - 1
    one = lambda v: torch.full((), float(v), device=g.device)
    amax = g.abs().amax().to(torch.float32)
    scale = torch.maximum(amax, one(1e-30)) / one(levels)
    codes = torch.clamp(torch.round(g.float() / scale), -levels, levels)
    codes = codes.to(torch.int8)
    mean = codes.to(torch.int32).to(torch.float32) * scale / one(1)
    return mean.to(g.dtype), g.float() - codes.to(torch.float32) * scale


@contextlib.contextmanager
def observed_exchange(check_bits=None):
    """``trainer.pod_exchange`` observed: yields a list that gets each
    call's (start, end) CUDA events; with ``check_bits``, the first call's
    means and residuals are held bit-identical to ``_plain_exchange`` on
    its inputs (raises)."""
    import torch
    from repro_torch.train import trainer
    real = trainer.pod_exchange
    events = []

    def exchange(grads, ef, bits, group, npod):
        check = check_bits is not None and not events
        if check:
            given = {k: (g if ef is None else g + ef[k]).clone()
                     for k, g in grads.items()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        real(grads, ef, bits, group, npod)
        end.record()
        events.append((start, end))
        if check:
            for k, g in given.items():
                mean, resid = _plain_exchange(g, check_bits)
                if not (torch.equal(mean, grads[k])
                        and (ef is None or torch.equal(resid, ef[k]))):
                    raise AssertionError(f"exchanged gradient {k} differs "
                                         f"from the plain formula")
            print(f"compressed step 1: {len(given)} exchanged gradients and "
                  f"residuals bit-identical to the plain-torch formula on "
                  f"the same gradients")
            del given
    trainer.pod_exchange = exchange
    try:
        yield events
    finally:
        trainer.pod_exchange = real


def compressed_training(dev, mesh, step1_loss: float) -> dict:
    """(a) zamba2-1.2b whole at phase 10a's shape and weights, 8-bit
    compressed exchange with error feedback, multi_pod over the world-1
    NCCL mesh: step 1's loss bit-equal to phase 10a's uncompressed step 1,
    the exchange of step 1 bit-identical to the plain formula; ms a step,
    the exchange's ms (CUDA events), peak, launches a step -> the launches
    of flash and the scan in a step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.train import trainer as tr

    arch, _, b, s, seed, token_seed = TRAIN_FULL[0]
    cfg = get_config(arch)
    name = cfg.name
    params = tr.init_params(cfg, seed=seed, device=dev)
    tcfg = tr.TrainConfig(num_microbatches=TRAIN_MB, peak_lr=TRAIN_PEAK_LR,
                          warmup_steps=TRAIN_WARMUP,
                          total_steps=LM_TRAIN_STEPS, grad_compress_bits=8,
                          error_feedback=True)
    gen = torch.Generator(device=dev).manual_seed(token_seed)
    batches = [_train_batch(cfg, b, s, gen, dev)
               for _ in range(LM_TRAIN_STEPS + 1)]
    state = tr.init_train_state(params, tcfg)
    step = tr.make_train_step(cfg, tcfg, mesh=mesh, multi_pod=True)
    want = {k: 2 * TRAIN_MB * v for k, v in _expected_launches(cfg).items()}
    times, losses, ex_ms = [], [], []
    with observed_exchange(check_bits=8) as events:
        for i in range(LM_TRAIN_STEPS):
            if i == 1:
                torch.cuda.reset_peak_memory_stats(dev)
            with phase_counts() as tally:
                (state, m), t = _timed(dev, lambda: step(state, batches[i]))
            times.append(t)
            losses.append(float(m["loss"]))
            ex_ms.append(events[-1][0].elapsed_time(events[-1][1]))
            got = {k: tally["forward"].get(k, 0) + tally["backward"].get(k, 0)
                   for k in want}
            print(f"{name} compressed step {i + 1}: loss {losses[-1]!r}, "
                  f"grad norm {float(m['grad_norm'])!r}, {t * 1e3!r} ms "
                  f"(host clock, synchronised), exchange {ex_ms[-1]!r} ms "
                  f"(CUDA events); launches {got}")
            if got != want:
                raise AssertionError(f"{name} compressed step launched "
                                     f"{got}, the config implies {want}")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    if losses[0] != step1_loss:
        raise AssertionError(f"{name}: compressed step 1 loss {losses[0]!r} "
                             f"is not phase 10a's {step1_loss!r}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: a compressed training loss is not "
                             f"finite")
    ef_norm = float(sum(float(v.float().square().sum())
                        for v in state.ef.values())) ** 0.5
    steady = sum(times[1:]) / (len(times) - 1)
    ex = sum(ex_ms[1:]) / (len(ex_ms) - 1)
    print(f"{name} compressed training ({nvidia_smi_line()}): multi_pod over "
          f"a world-1 NCCL mesh, 8-bit codes, error feedback; "
          f"{steady * 1e3!r} ms a step (steps 2-{LM_TRAIN_STEPS}; step 1 "
          f"{times[0] * 1e3!r} ms), the exchange {ex!r} ms a step "
          f"({ex / (steady * 1e3)!r} of it), peak memory {peak!r} GB over "
          f"steps 2-{LM_TRAIN_STEPS}; losses {losses!r}, step 1 bit-equal to "
          f"phase 10a's {step1_loss!r}; residual norm {ef_norm!r}")
    del state, step, params, batches
    torch.cuda.empty_cache()
    return want


def flash_decode_path(dev, mesh, model, cfg, qwen: dict) -> None:
    """(c) qwen2-7b at full width, world size 1: phase 8's QWEN_PROMPT-token
    prompt fed token by token and its GEN greedy steps' tokens, under
    ``flash_decode_ctx``; every step's bf16 logits held against phase 8's
    unsharded decode on the same weights and tokens, within
    FLASH_DECODE_SPREAD x the plain path's distance from float32."""
    import torch
    from repro_torch.distributed import flash_decode_ctx
    from repro_torch.models.lm import init_decode_cache, lm_decode_step

    gen = torch.Generator(device=dev).manual_seed(10)
    tokens = torch.randint(0, cfg.vocab, (QWEN_B, QWEN_PROMPT),
                           generator=gen, device=dev)

    def run():
        cache = init_decode_cache(cfg, QWEN_B, QWEN_PROMPT + GEN, device=dev)
        for t in range(QWEN_PROMPT):
            lt, cache = lm_decode_step(model, cache, tokens[:, t])
        out = [lt]
        for tok in qwen["tokens"]:
            lt, cache = lm_decode_step(model, cache, tok)
            out.append(lt)
        return out, cache.kv[0].k.shape[1]
    with flash_decode_ctx(mesh, axis="model"):
        (got, slots), t_sharded = _timed(dev, run)
    steps = QWEN_PROMPT + GEN
    print(f"{cfg.name} flash-decode ({nvidia_smi_line()}): world size 1 over "
          f"NCCL, {slots} cache slots a rank; {t_sharded * 1e3 / steps!r} ms "
          f"a step ({steps} steps of {QWEN_B} tokens, host clock); phase 8 "
          f"unsharded: cache fill {qwen['times']['cache_fill_ms_per_token']!r}"
          f" ms, decode {qwen['times']['decode_ms_per_token']!r} ms a step")
    tol = FLASH_DECODE_SPREAD * qwen["noise"]
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, qwen["steps"])):
        worst = max(worst, _logit_check(
            f"{cfg.name} flash-decode step {i} (0: the prompt's last)", a, b,
            tol, f"{FLASH_DECODE_SPREAD} x the plain bf16 path's distance "
            f"from float32"))
    print(f"{cfg.name} flash-decode: worst step {worst!r} of tolerance "
          f"{tol!r}")


def _stage_stream(dev, model, cfg):
    """qwen2-7b's hidden stream after layers 0..POD_LAYER-1 on B=QWEN_B x
    POD_S seeded tokens (bf16)."""
    import torch
    from repro_torch.models.lm import _attn_ffn_block
    gen = torch.Generator(device=dev).manual_seed(23)
    tokens = torch.randint(0, cfg.vocab, (QWEN_B, POD_S), generator=gen,
                           device=dev)
    x = model.embed[tokens].to(cfg.dtype)
    for lp in model.layers[:POD_LAYER]:
        x = _attn_ffn_block(lp, x, cfg, dtype=cfg.dtype)[0]
    return x


def pod_boundary_path(dev, mesh, model, cfg) -> dict:
    """(d) qwen2-7b's stream at a stage boundary over the world-1 NCCL
    mesh: ``compressed_pod_transfer`` at 8 and 4 bits (codes and side info
    of the kernel, of ``quantize_plain`` on the card and of the CPU
    bit-identical; the bytes handed to ppermute exactly ``wire_bytes()``;
    one quantize launch a transfer), ``subset_pod_transfer`` of POD_C
    channels with a stream BaF predictor and layer POD_LAYER as the frozen
    receiving block (one quantize, one consolidate and one flash launch;
    the output bit-identical to the plain consolidate on the same
    estimate; in float32 against the CPU) -> the stream and selection for
    the kernel rows, and their launches and errors."""
    import copy
    import torch
    from repro_torch.core.baf import BaFStream, BaFStreamConfig
    from repro_torch.distributed import pipeline
    from repro_torch.kernels import _build
    from repro_torch.kernels.consolidate import consolidate_plain
    from repro_torch.kernels.quantize import quantize_plain
    from repro_torch.models.lm import _attn_ffn_block

    x = _stage_stream(dev, model, cfg)
    b, s, d = x.shape
    sent = []
    real = pipeline.ppermute

    def counted(t, perm, group):
        sent[-1] += t.numel() * t.element_size()
        return real(t, perm, group)
    pipeline.ppermute = counted
    launches, errs = {}, {}
    try:
        for bits in (8, 4):
            codes, mn, mx = pipeline._quantize_stream(x, bits)
            x3 = x.reshape(1, -1, d).float()
            pc, pmn, pmx = quantize_plain(x3, bits)
            cc, cmn, cmx = pipeline._quantize_stream(x.cpu(), bits)
            same = (bits_equal(codes.reshape(pc.shape), pc)
                    and bits_equal(mn, pmn[0]) and bits_equal(mx, pmx[0])
                    and bits_equal(codes.cpu(), cc) and
                    bits_equal(mn.cpu(), cmn) and bits_equal(mx.cpu(), cmx))
            sent.append(0)
            _build.reset_launches()
            y = pipeline.compressed_pod_transfer(x, mesh, bits=bits,
                                                 dtype=torch.bfloat16)
            counts = launch_counts()
            want = pipeline._dequantize_stream(codes, mn, mx, bits,
                                               torch.bfloat16)
            comp, raw = pipeline.wire_bytes(x, bits)
            err = float((y.float() - x.float()).abs().max())
            print(f"pod transfer n={bits} ({nvidia_smi_line()}): x {(b, s, d)}"
                  f" bf16; codes and side info kernel = plain on the card = "
                  f"CPU: {same}; wire {sent[-1]} B (wire_bytes {comp}) vs bf16"
                  f" {raw} B ({raw / comp!r}x less); max dequantization error"
                  f" {err!r}; launches {counts}")
            if not (same and sent[-1] == comp and torch.equal(y, want)
                    and counts["quantize"] == 1):
                raise AssertionError(f"pod transfer n={bits} failed its "
                                     f"checks")
            if bits == 8:
                launches["quantize/pod_stream"] = counts["quantize"]
                errs["quantize/pod_stream"] = 0.0

        sel = torch.arange(0, d, d // POD_C, dtype=torch.int32, device=dev)
        baf = BaFStream(BaFStreamConfig(c=POD_C, d_in=d, hidden=POD_HIDDEN),
                        seed=24, device=dev)
        block = model.layers[POD_LAYER]
        seen = {}

        def forward_fn(t):
            seen["z"] = _attn_ffn_block(block, t, cfg, dtype=cfg.dtype)[0]
            return seen["z"]
        sent.append(0)
        _build.reset_launches()
        (y, t_subset) = _timed(dev, lambda: pipeline.subset_pod_transfer(
            x, mesh, sel_idx=sel, baf=baf, forward_fn=forward_fn, bits=8))
        counts = launch_counts()
        codes, mn, mx = pipeline._quantize_stream(x, 8, sel)
        z32 = seen["z"].reshape(1, -1, d).float()
        consolidate_plain(z32, codes.reshape(1, -1, POD_C), mn[None],
                          mx[None], 8, sel.long())
        plain = z32.reshape(x.shape).to(torch.bfloat16)
        comp, _ = pipeline.wire_bytes(x[..., :POD_C], 8)
        print(f"pod subset transfer ({nvidia_smi_line()}): C={POD_C} of {d},"
              f" BaF hidden {POD_HIDDEN}, frozen block qwen2-7b layer "
              f"{POD_LAYER}; {t_subset * 1e3!r} ms (host clock); wire "
              f"{sent[-1]} B (wire_bytes {comp}), {x.numel() * 2 / comp!r}x "
              f"less than bf16; launches {counts}; output = the plain "
              f"consolidate on the same estimate: {torch.equal(y, plain)}")
        if not (torch.equal(y, plain) and sent[-1] == comp
                and counts["quantize"] == 1 and counts["consolidate"] == 1
                and counts["flash_attention"] == 1 and torch_isfinite(y)):
            raise AssertionError("pod subset transfer failed its checks")
        launches["quantize/pod_subset"] = counts["quantize"]
        launches["consolidate/pod_subset"] = counts["consolidate"]
        errs["quantize/pod_subset"] = 0.0
        errs["consolidate/pod_subset"] = 0.0
        del seen["z"], z32, plain

        # float32, card against CPU
        cfg32 = cfg.with_(dtype=torch.float32)
        block32 = copy.deepcopy(block).float()
        x32 = x.float()
        card = pipeline.subset_pod_transfer(
            x32, mesh, sel_idx=sel, baf=baf, dtype=torch.float32,
            forward_fn=lambda t: _attn_ffn_block(block32, t, cfg32,
                                                 dtype=torch.float32)[0])
        block_cpu = copy.deepcopy(block32).cpu()
        baf_cpu = copy.deepcopy(baf).cpu()
        cpu = pipeline.subset_pod_transfer(
            x32.cpu(), mesh, sel_idx=sel.cpu(), baf=baf_cpu,
            dtype=torch.float32,
            forward_fn=lambda t: _attn_ffn_block(block_cpu, t, cfg32,
                                                 dtype=torch.float32)[0])
        gap = float((card.cpu() - cpu).abs().max())
        scale = float(cpu.abs().max())
        print(f"pod subset transfer in float32, card vs CPU: max abs diff "
              f"{gap!r}, largest entry {scale!r} (tolerance {POD_CPU_RTOL} "
              f"of it)")
        if not gap <= POD_CPU_RTOL * scale:
            raise AssertionError("pod subset transfer: card and CPU differ")
    finally:
        pipeline.ppermute = real
    return dict(x=x, sel=sel, launches=launches, errs=errs)


def _gloo_rank(rank: int, init_file: str, out: str) -> None:
    """One of two gloo ranks sharing cuda:0: (b) the multi-pod step on
    qwen2-7b's smoke config on the card and then on the CPU, the weights
    and exchanged gradients of the two ranks held bit-identical after each
    step; (c) the sequence-sharded decode at the layer level against the
    unsharded decode attention. Rank 0 writes what it saw to ``out``."""
    import datetime
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.distributed.collectives import \
        seq_sharded_decode_attention
    from repro_torch.train import trainer as tr

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(4)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank, world_size=2,
        timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S))
    from torch.distributed.device_mesh import init_device_mesh
    # the mesh's device type matters only to DTensors: the pods' tensors
    # are on cuda:0, and then on the CPU, through the same gloo groups
    mesh = init_device_mesh("cpu", (2, 1, 1),
                            mesh_dim_names=("pod", "data", "model"))
    seq_mesh = init_device_mesh("cpu", (1, 1, 2),
                                mesh_dim_names=("pod", "data", "model"))
    group = mesh.get_group("pod")
    report = {}
    try:
        cfg = configs.get_smoke_config("qwen2_7b").with_(dtype=torch.float32)
        tcfg = tr.TrainConfig(num_microbatches=2, grad_compress_bits=8,
                              peak_lr=1e-2, warmup_steps=0, total_steps=10)
        master = tr.init_params(cfg, seed=0, device="cpu")
        rng = np.random.default_rng(5)
        tokens = rng.integers(0, cfg.vocab, (GLOO_STEPS, GLOO_B, GLOO_S + 1))
        losses = {}
        for dev in ("cuda", "cpu"):
            params = {k: v.detach().to(dev).requires_grad_(True)
                      for k, v in master.items()}
            state = tr.init_train_state(params, tcfg)
            step = tr.make_train_step(cfg, tcfg, mesh=mesh, multi_pod=True)
            losses[dev] = []
            seen = {}
            real = tr.pod_exchange

            def exchange(grads, ef, bits, grp, npod):
                real(grads, ef, bits, grp, npod)
                seen["grads"] = {k: g.clone() for k, g in grads.items()}
            tr.pod_exchange = exchange
            try:
                for i in range(GLOO_STEPS):
                    t = torch.from_numpy(tokens[i]).to(dev)
                    state, m = step(state, {"tokens": t[:, :-1],
                                            "labels": t[:, 1:]})
                    losses[dev].append(float(m["loss"]))
                    for what, tree in (("gradient", seen["grads"]),
                                       ("weight", state.params)):
                        for k, v in tree.items():
                            both = [torch.empty_like(v) for _ in range(2)]
                            dist.all_gather(both, v.detach().contiguous(),
                                            group=group)
                            if not torch.equal(both[0], both[1]):
                                raise AssertionError(
                                    f"{dev} step {i + 1}: the ranks' "
                                    f"{what} {k} differ")
            finally:
                tr.pod_exchange = real
        report["losses"] = losses
        report["leaves"] = len(master)

        # (c) the layer-level sequence-sharded decode, float32 on the card
        b, h, kh, hd = DECODE_HEADS
        s_loc = DECODE_S // 2
        gen = torch.Generator(device="cuda").manual_seed(25)
        ck = torch.randn((b, DECODE_S, kh, hd), generator=gen, device="cuda")
        cv = torch.randn((b, DECODE_S, kh, hd), generator=gen, device="cuda")
        worst = 0.0
        lengths = (100, s_loc - 1, s_loc, s_loc + 1, DECODE_S - 1)
        for length in lengths:
            q = torch.randn((b, h, hd), generator=gen, device="cuda")
            nk = torch.randn((b, kh, hd), generator=gen, device="cuda")
            nv = torch.randn((b, kh, hd), generator=gen, device="cuda")
            lk = ck[:, rank * s_loc:(rank + 1) * s_loc].clone()
            lv = cv[:, rank * s_loc:(rank + 1) * s_loc].clone()
            got, lk, lv = seq_sharded_decode_attention(
                q, lk, lv, nk, nv, length, seq_mesh, axis="model")
            fk, fv = ck.clone(), cv.clone()
            fk[:, length], fv[:, length] = nk, nv
            qg = q.reshape(b, kh, h // kh, hd)
            p = torch.softmax(torch.einsum(
                "bkgh,bskh->bkgs", qg, fk[:, :length + 1]) / hd ** 0.5, -1)
            want = torch.einsum("bkgs,bskh->bkgh", p,
                                fv[:, :length + 1]).reshape(b, h * hd)
            gap = float((got - want).abs().max())
            worst = max(worst, gap / float(want.abs().max()))
            if not (gap <= DECODE_RTOL * float(want.abs().max())
                    and torch.equal(lk, fk[:, rank * s_loc:(rank + 1)
                                           * s_loc])):
                raise AssertionError(f"sharded decode at length {length}: "
                                     f"{gap!r} from the unsharded decode")
        report["decode"] = dict(lengths=lengths, worst=worst)
        if rank == 0:
            Path(out).write_text(json.dumps(report))
    finally:
        dist.destroy_process_group()


def gloo_pair(dev) -> None:
    """(b) and (c) with two gloo ranks sharing the card (NCCL refuses two
    ranks on one device; gloo takes all_reduce and all_gather of CUDA
    tensors, and no send or recv): the gates checked here on rank 0's
    report, a rank's failure fails the phase."""
    import tempfile
    import torch
    import torch.multiprocessing as mp
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "report.json")
        t0 = time.perf_counter()
        mp.spawn(_gloo_rank, args=(os.path.join(tmp, "rendezvous"), out),
                 nprocs=2)
        wall = time.perf_counter() - t0
        rep = json.loads(Path(out).read_text())
    card, cpu = rep["losses"]["cuda"], rep["losses"]["cpu"]
    rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
    print(f"two gloo ranks on {torch.cuda.get_device_name(0)} "
          f"({nvidia_smi_line()}), {wall!r} s with process start: qwen2-7b "
          f"smoke float32, 8-bit exchange, {GLOO_STEPS} steps of B="
          f"{GLOO_B} x {GLOO_S}; losses card {card!r}, CPU {cpu!r}, "
          f"relative gaps {rel!r} (tolerance {GLOO_STEP1_RTOL} at step 1, "
          f"{GLOO_LATER_RTOL} after); the ranks' {rep['leaves']} exchanged "
          f"gradients and weights bit-identical after each step")
    if not (rel[0] <= GLOO_STEP1_RTOL
            and all(r <= GLOO_LATER_RTOL for r in rel[1:])):
        raise AssertionError("two gloo ranks: the card's losses are not the "
                             "CPU's")
    dec = rep["decode"]
    print(f"sequence-sharded decode, two gloo ranks on the card: (B, H, K, "
          f"hd) {DECODE_HEADS}, {DECODE_S} slots, {DECODE_S // 2} a rank, "
          f"lengths {dec['lengths']}: worst {dec['worst']!r} of the largest "
          f"entry from the unsharded decode (tolerance {DECODE_RTOL})")


def distributed_path(dev, step1_loss: float, qwen: dict) -> dict:
    """Phase 10b/10c (``qwen``: phase 8's qwen2-7b run) -> the launches and
    errors of its kernel rows and what ``time_pod_kernels`` times."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import init_mesh
    from repro_torch.models.lm import init_lm

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mesh = init_mesh((1, 1, 1), backend="nccl", rank=0, world=1,
                         init_file=os.path.join(tmp, "rendezvous"),
                         device_type="cuda")
        try:
            launches = compressed_training(dev, mesh, step1_loss)
            cfg = get_config("qwen2_7b")
            with torch.no_grad():
                model = init_lm(cfg, seed=0, device=dev)
                flash_decode_path(dev, mesh, model, cfg, qwen)
                pod = pod_boundary_path(dev, mesh, model, cfg)
            del model
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    gloo_pair(dev)
    for k, v in launches.items():
        pod["launches"][f"{k}/train_zamba2_1p2b_compressed"] = v
    print(f"phase 10b/10c: {time.perf_counter() - t0!r} s")
    return pod


def time_pod_kernels(row, pod) -> list:
    """quantize at the stream's (1, B*S, D) with all D channels and with
    the subset's C, consolidate at the subset's shape."""
    import torch
    from repro_torch.kernels.consolidate import (consolidate_fused,
                                                 consolidate_plain)
    from repro_torch.kernels.quantize import (channel_order, quantize_fused,
                                              quantize_plain)
    x, sel = pod["x"], pod["sel"]
    d = x.shape[-1]
    x3 = x.reshape(1, -1, d).float()
    r = x3.shape[1]
    c = sel.numel()
    order = channel_order(sel)
    out = []
    for name, s_, cc in (("quantize/pod_stream", None, d),
                         ("quantize/pod_subset", sel, c)):
        kw = {} if s_ is None else {"order": order}
        # the channels coded read once, codes and side info written once
        nbytes = r * cc * 4 + r * cc + 2 * cc * 2 + (0 if s_ is None
                                                     else cc * 8)
        out.append(row(name, "src/repro_torch/csrc/quantize.cu",
                       "src/repro/kernels/quantize.py:48",
                       timed(lambda: quantize_fused(x3, 8, s_, **kw)),
                       timed(lambda: quantize_plain(
                           x3, 8, None if s_ is None else s_.long())),
                       nbytes, None, f"pod boundary B=1 R={r} P={d} C={cc}"))
    codes, mins, maxs = quantize_fused(x3, 8, sel, order=order)
    gen = torch.Generator(device=x3.device).manual_seed(26)
    est = x3 + 0.01 * torch.randn(x3.shape, generator=gen, device=x3.device)
    nbytes = 2 * r * c * 4 + r * c + 2 * c * 2 + c * 8
    out.append(row("consolidate/pod_subset",
                   "src/repro_torch/csrc/consolidate.cu",
                   "src/repro/kernels/consolidate.py:37",
                   timed(lambda: consolidate_fused(est, codes, mins, maxs, 8,
                                                   sel, order=order)),
                   timed(lambda: consolidate_plain(est, codes, mins, maxs, 8,
                                                   sel.long())),
                   nbytes, None, f"pod boundary B=1 R={r} P={d} C={c}"))
    return out


# ---------------------------------------------------------------------------
# Phase 10d: the sharded cloud tier
# ---------------------------------------------------------------------------

# the federation: two gateways of MESH_TENANTS tenants, each tenant sending
# MESH_PER_TENANT requests, so each gateway fills one bucket of
# MESH_TENANTS * MESH_PER_TENANT rows
MESH_TENANTS, MESH_PER_TENANT = 2, 2
MESH_SHARD_TOL = 1e-5            # two shards against the serial bucket,
                                 # of its largest |logit|


def mesh_path(dev, smi: str) -> dict:
    """Phase 10d -> the launches of the mesh serve (a), by kernel.

    Phase 6's system, images and submit times at the paper's full width,
    one operating point (C=64, 8 bits, rans: the main path's, so its
    kernels run at the shapes phase 11 times); cuDNN deterministic."""
    import torch
    from repro_torch.configs.yolo_baf import full_config
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_F32,
                                         make_dev_mesh)
    from repro_torch.pipeline import OperatingPoint
    from repro_torch.pipeline.plan import DecodedBatch
    from repro_torch.serve import (ChannelConfig, MeshExecutor,
                                   SerialExecutor, ServingGateway,
                                   SimulatedChannel, seed_cost_from_program)
    from repro_torch.serve.mesh_executor import restore_cloud_cost

    t_phase = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    cfg = full_config()
    model, bank = serving_system(dev, cfg, SERVE_BANK, HIDDEN)
    op = OperatingPoint(c=C, bits=BITS, backend="rans")
    imgs = serving_images(cfg, SERVE_N, 41)
    times = [0.01 * i for i in range(SERVE_N)]

    def gateway(executor):
        return ServingGateway(
            model, bank, default_op=op, max_batch=SERVE_MAX_BATCH,
            channel=SimulatedChannel(ChannelConfig(
                bandwidth_bps=100e6, base_latency_s=0.01)),
            executor=executor, device=dev)

    # (d) the restore + cloud body's program cost at B=8, its roofline seed
    serial = gateway(SerialExecutor())
    plan = serial.plan_for(op)
    shape = (SERVE_MAX_BATCH, cfg.split_hw, cfg.split_hw, C)
    est = restore_cloud_cost(plan, shape)
    cal = seed_cost_from_program(plan, shape)
    codes = torch.zeros(shape, dtype=torch.uint8, device=dev)
    mins = torch.zeros((shape[0], 1, 1, C), dtype=torch.float16, device=dev)
    maxs = torch.ones((shape[0], 1, 1, C), dtype=torch.float16, device=dev)
    body_ms = event_ms(lambda: plan.spec.params.cloud(
        plan.restore_device(codes, mins, maxs)), iters=20)
    roof = max(est["flops"] / PEAK_FLOPS_F32, est["bytes"] / HBM_BW)
    print(f"mesh (d) restore + cloud at {shape} ({smi}): {est['flops']!r} "
          f"flops, {est['bytes']!r} bytes ({len(est['bytes_by_op'])} kinds "
          f"of op; kernel charges {est['kernels']}); roofline "
          f"{roof / shape[0] * 1e3!r} ms an item (float32 67 TFLOP/s, "
          f"3.35 TB/s), seed per_item_s {cal.seed_per_item_s!r}; measured "
          f"{body_ms / shape[0]!r} ms an item (CUDA events, launch "
          f"included)")
    if not (est["flops"] > 0 and cal.seed_per_item_s > 0 and [
            k["name"] for k in est["kernels"]] == ["baf_conv"] * 5
            + ["consolidate"]):
        raise AssertionError(f"restore + cloud program cost: {est}")

    # (a) one card as the mesh: the serial tier calibrates, the mesh serves
    serial.executor.cost = cal
    seen_s = watch_batches(serial.executor)
    resp_s, _ = serial.serve(imgs, submit_times=times)
    cal.freeze()
    mesh_ex = MeshExecutor(make_dev_mesh(prefer="data"), cost=cal)
    mesh_gw = gateway(mesh_ex)
    if mesh_gw._run_fn != mesh_gw._run_batch_mesh or \
            dict(mesh_ex.mesh.shape) != {"data": 1, "model": 1}:
        raise AssertionError("the gateway does not route through the mesh")
    seen_m = watch_batches(mesh_ex)
    sync(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    resp_m, tel_m = mesh_gw.serve(imgs, submit_times=times)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    same = all(np.array_equal(a.logits, b.logits)
               for a, b in zip(resp_s, resp_m))
    print(f"mesh (a) ServingGateway on MeshExecutor(make_dev_mesh(prefer="
          f"'data')) = {dict(mesh_ex.mesh.shape)} ({smi}): {SERVE_N} "
          f"requests in {wall!r} s wall, {SERVE_N / wall!r} requests/s; "
          f"peak memory {peak / 1e9!r} GB, {(peak - held) / 1e9!r} GB above "
          f"what earlier phases held; micro-batches "
          f"{[(len(b.requests), b.padded_size) for b, _ in seen_m]}; "
          f"launches {launches}; calibrated fit base {cal.base_s!r} s, "
          f"per item {cal.per_item_s!r} s over {len(cal.samples)} samples; "
          f"logits bit-identical to the SerialExecutor gateway's: {same}")
    want = {"quantize": SERVE_N, "histogram": SERVE_N,
            "consolidate": len(seen_m), "baf_conv": 5 * len(seen_m)}
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"the mesh serve launched {launches}, not {want}")
    check_served(resp_m, seen_m, cfg.num_classes, SERVE_N)
    if not same or len(resp_m) != len(resp_s) or \
            [len(b.requests) for b, _ in seen_m] != \
            [len(b.requests) for b, _ in seen_s]:
        raise AssertionError("the mesh serve's logits are not the serial "
                             "serve's")

    # (b) two shards on one card: the first full micro-batch, again
    batch, serial_logits = next((b, lg) for b, lg in seen_s
                                if b.padded_size == SERVE_MAX_BATCH)
    decoded = plan.decode_batch([r.blob for r in batch.requests])
    two = MeshExecutor(make_dev_mesh(2, prefer="data", device=dev), cost=cal)
    _build.reset_launches()
    got = two.run_sharded(plan, decoded, batch.padded_size)
    sync(dev)
    shard_launches = launch_counts()["consolidate"]
    rows = two.shard_rows(batch.padded_size)
    shard_same = []
    for i in range(2):
        part = slice(i * rows, (i + 1) * rows)
        sub = decoded.pad_to(2 * rows)
        shard = DecodedBatch(codes=sub.codes[part], mins=sub.mins[part],
                             maxs=sub.maxs[part])
        want_rows = plan.spec.params.cloud(plan.restore(shard)).cpu().numpy()
        shard_same.append(bool(np.array_equal(got[part], want_rows)))
    gap = float(np.abs(got - serial_logits).max())
    tol = MESH_SHARD_TOL * float(np.abs(serial_logits).max())
    print(f"mesh (b) two shards of {rows} rows on {dev}: each shard "
          f"bit-identical to the serial path at {rows} rows: {shard_same}; "
          f"the batch against the serial {batch.padded_size}-row bucket max "
          f"abs diff {gap!r} (tolerance {tol!r}); consolidate launches "
          f"{shard_launches}")
    if not all(shard_same) or gap > tol or shard_launches != 2:
        raise AssertionError("two shards on one card disagree with the "
                             "serial path")

    # (c) a federation of two gateways on one shared mesh executor
    mesh_fed = federation_runs(dev, model, bank, op, cfg, imgs, MeshExecutor(
        make_dev_mesh(prefer="data"), cost=cal), repeat=2)
    serial_fed = federation_runs(dev, model, bank, op, cfg, imgs,
                                 SerialExecutor(cost=cal), repeat=1)
    replay = mesh_fed[0] == mesh_fed[1]
    as_serial = mesh_fed[0] == serial_fed[0]
    print(f"mesh (c) federation of 2 MultiTenantGateways x {MESH_TENANTS} "
          f"tenants x {MESH_PER_TENANT} requests on one MeshExecutor: replay "
          f"identical (records and logits) {replay}; records and logits "
          f"identical to the SerialExecutor federation's {as_serial}")
    if not (replay and as_serial):
        raise AssertionError("the mesh federation does not replay or does "
                             "not match the serial federation")

    # (e) the task gateway refuses the mesh executor
    mesh_refused(dev, model, bank, cfg)

    # (f) the quickstart on the card against the CPU
    quickstart_card_vs_cpu(dev)
    torch.backends.cudnn.deterministic = deterministic
    print(f"phase 10d: {time.perf_counter() - t_phase!r} s")
    return {f"{k}/mesh": v for k, v in want.items()}


def federation_runs(dev, model, bank, op, cfg, imgs, executor,
                    repeat: int) -> list:
    """``repeat`` runs of two federated MultiTenantGateways sharing
    ``executor`` -> each run's (records, logits) per gateway."""
    from repro_torch.serve import (ChannelConfig, GatewayFederation,
                                   MultiTenantGateway, TenantRequest,
                                   TenantSpec)
    gws = [MultiTenantGateway(
        model, bank, tenants=[TenantSpec(f"g{g}t{i}")
                              for i in range(MESH_TENANTS)],
        channel_cfg=ChannelConfig(bandwidth_bps=1e9, base_latency_s=0.001),
        default_op=op, max_batch=MESH_TENANTS * MESH_PER_TENANT,
        batch_window_s=None, executor=executor, shared_executor=True,
        seed=g, device=dev) for g in range(2)]
    work = [[TenantRequest(f"g{g}t{k % MESH_TENANTS}",
                           imgs[(4 * g + k) % len(imgs)], t_submit=1e-4 * k)
             for k in range(MESH_TENANTS * MESH_PER_TENANT)]
            for g in range(2)]
    fed = GatewayFederation(gws)
    runs = []
    for _ in range(repeat):
        out = fed.serve(work)
        runs.append([(tel.records, tel.shed,
                      {t: [r.logits.tobytes() for r in rs]
                       for t, rs in res.items()}) for res, tel in out])
        if fed.depth() != 0 or any(tel.shed for _, tel in out):
            raise AssertionError("the federation shed or left work queued")
    return runs


def mesh_refused(dev, model, bank, cfg) -> None:
    """(e) MultiTaskGateway refuses a mesh executor, as the reference."""
    import torch
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.serve import LinearCostModel, MeshExecutor, TenantSpec
    from repro_torch.tasks import HeadConfig, MultiTaskGateway, init_head_bank

    hcfg = HeadConfig(split_p=cfg.split_p, num_classes=cfg.num_classes)
    heads = init_head_bank(torch.Generator().manual_seed(5), hcfg,
                           device=dev)
    refused = None
    try:
        MultiTaskGateway(model, bank, tenants=[TenantSpec("t")],
                         head_bank=heads, head_cfg=hcfg,
                         executor=MeshExecutor(make_dev_mesh(prefer="data"),
                                               cost=LinearCostModel()),
                         device=dev)
    except NotImplementedError as e:
        refused = str(e)
    print(f"mesh (e) MultiTaskGateway on a MeshExecutor: refused with "
          f"NotImplementedError: {refused!r}")
    if refused is None or "run_sharded" not in refused:
        raise AssertionError("MultiTaskGateway took a mesh executor")


def quickstart_card_vs_cpu(dev) -> None:
    """(f) ``launch/quickstart.py`` on the card and on the CPU, both given
    the CPU's split activation: selection, codes, side info, wire bits and
    the container identical, z~ within RESTORE_TOL of the largest entry,
    quantize and consolidate once each on the card."""
    import torch
    from repro_torch.launch import quickstart

    inputs = quickstart.make_inputs(0)
    cpu = quickstart.run(*inputs, device=torch.device("cpu"))
    launches0 = launch_counts()
    card = quickstart.run(*inputs, device=dev, z=cpu["z"])
    sync(dev)
    launches = {k: v - launches0[k] for k, v in launch_counts().items()}
    same = (np.array_equal(card["sel"], cpu["sel"])
            and np.array_equal(card["codes"], cpu["codes"])
            and card["side_info"] == cpu["side_info"]
            and card["wire_bits"] == cpu["wire_bits"]
            and card["blob"] == cpu["blob"])
    gap = float(np.abs(card["z_tilde"] - cpu["z_tilde"]).max())
    tol = RESTORE_TOL * float(np.abs(cpu["z_tilde"]).max())
    for line in card["lines"]:
        print(f"  quickstart on the card: {line}")
    print(f"mesh (f) quickstart card vs CPU (the CPU's z): selection, codes, "
          f"side info, {card['wire_bits']} wire bits and the container "
          f"identical {same}; z~ max abs diff {gap!r} (tolerance {tol!r}); "
          f"launches {launches}")
    if not same or gap > tol or not card["inside"] or \
            {k: v for k, v in launches.items() if v} != {
                "quantize": 1, "consolidate": 1, "baf_conv": 5}:
        raise AssertionError("the quickstart disagrees between card and CPU")


# ---------------------------------------------------------------------------
# Phase 11: kernel times
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Phase 10e: the cells of launch/specs.py on DTensor meshes, the dry run
# ---------------------------------------------------------------------------

# (label, arch, shape, depth (None: the whole model), the cut shape,
# overrides). Each is cut only where one card forces it: depth for
# qwen2-7b, as phase 10a, and the batch to one card's share.
CELLS = (
    ("qwen2_7b train_4k", "qwen2_7b", "train_4k", 4,
     dict(seq_len=4096, global_batch=2, kind="train"), {"microbatches": 2}),
    ("qwen2_7b prefill_32k", "qwen2_7b", "prefill_32k", 4,
     dict(seq_len=32768, global_batch=1, kind="prefill"), None),
    ("qwen2_7b decode_32k", "qwen2_7b", "decode_32k", 4,
     dict(seq_len=32768, global_batch=8, kind="decode"), None),
    ("qwen2_7b decode_32k flash_decode=1", "qwen2_7b", "decode_32k", 4,
     dict(seq_len=32768, global_batch=8, kind="decode"),
     {"flash_decode": True}),
    ("rwkv6_3b long_500k", "rwkv6_3b", "long_500k", None,
     dict(seq_len=65536, global_batch=1, kind="long"), None),
    ("zamba2_1p2b train_4k", "zamba2_1p2b", "train_4k", None,
     dict(seq_len=4096, global_batch=2, kind="train"), {"microbatches": 1}),
)
CELL_SEED = 30
# (b): the smoke cells two gloo ranks sharing the card would run; they stay
# in tests/test_torch_cells.py while DTensor's redistributions over gloo
# fail on CUDA tensors on the card's torch (no runner is kept for them)
GLOO_CELLS = (("qwen2_7b", "train_4k"), ("rwkv6_3b", "decode_32k"))
# the collectives DTensor's redistributions issue, besides all_reduce
DTENSOR_COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor SUM",
                       "all_to_all_single")
# (c): the production dry run on the host, (arch, shape, multi-pod,
# overrides, depth (None: every layer)). arctic-480b's 8 rows a device in
# its default 16 microbatches: the step runs gcd(8, 16) = 8 of a row a
# device, each as many rows a device as the reference's padded ones.
DRY_CELLS = (("qwen2_72b", "train_4k", False, None, None),
             ("arctic_480b", "train_4k", True, None, None),
             ("qwen2_7b", "decode_32k", False, {"flash_decode": True}, None),
             ("rwkv6_3b", "long_500k", False, None, None))
DRY_TIMEOUT_S = 900

_DRY = r"""
import json, sys, time
import torch
torch.set_num_threads(1)
sys.path.insert(0, sys.argv[1])
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun
for arch, shape, mp, ov, depth in json.loads(sys.argv[2]):
    cut = None
    if depth:
        cut = (get_config(arch).with_(n_layers=depth), SHAPES[shape])
    rec = dryrun.run_cell(arch, shape, multi_pod=mp, overrides=ov, cut=cut,
                          verbose=False)
    rec["depth"] = depth
    print("DRY " + json.dumps(rec), flush=True)
"""


def start_dry_run():
    """(c) in a process of its own, started before the card's phases: it
    runs on the host while they run on the card, on one thread and at the
    lowest priority, so that the host-bound phases keep their cores."""
    return subprocess.Popen(
        [sys.executable, "-c", _DRY, str(ROOT / "src"),
         json.dumps(DRY_CELLS)],
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=str(ROOT),
        preexec_fn=lambda: os.nice(19),
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                 MKL_NUM_THREADS="1"))


def _cell_args(dev, cell):
    from repro_torch.launch import specs
    return specs.real_args(cell, seed=CELL_SEED, device=dev)


def _plain_step(cell, args):
    """The step built without a cell, on plain tensors."""
    from repro_torch.models.encdec import init_encdec
    from repro_torch.models.lm import init_lm
    from repro_torch.launch import specs
    from repro_torch.serve.engine import (make_decode_step, make_long_ingest,
                                          make_prefill_step)
    from repro_torch.train.trainer import make_train_step
    cfg = cell.cfg
    if cell.kind == "train":
        return make_train_step(cfg, cell.tcfg)(*args)
    params = args[0]
    model = (init_encdec if cfg.family == "audio" else init_lm)(
        cfg, device="meta")
    model.load_state_dict(params, assign=True)
    if cell.kind == "prefill":
        return make_prefill_step(cfg)(model, args[1])
    if cell.kind == "decode":
        return make_decode_step(cfg)(model, args[1], args[2])
    block = (min(specs.LONG_BLOCK, args[1].shape[1]) if cfg.family == "ssm"
             else cfg.hybrid.attn_window_long)
    return make_long_ingest(cfg, block=block)(model, args[1])


def _tensors_of(tree, out=None):
    import torch
    from torch.distributed.tensor import DTensor
    out = [] if out is None else out
    if isinstance(tree, DTensor):
        out.append(tree.full_tensor().detach())
    elif isinstance(tree, torch.Tensor):
        out.append(tree.detach())
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors_of(v, out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _tensors_of(tree[k], out)
    return out


def _cell_outputs(cell, out):
    """What a cell's run is held by: the train step's metrics, the updated
    weights and AdamW's moments (the first step's lr is 0 under the
    warm-up, so its gradients show in the moments only), a serving step's
    logits and its caches or states."""
    if cell.kind == "train":
        state, metrics = out
        return _tensors_of([metrics, state.params, state.opt.mu,
                            state.opt.nu])
    return _tensors_of(out)


def cells_on_card(dev, smi: str) -> dict:
    """(a) each cell at full width on a world-1 NCCL mesh (data 1, model
    1), held against the step built without a cell on the same weights."""
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch import specs
    from torch.distributed.device_mesh import init_device_mesh

    launches = {}
    torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(
            tmp, "rendezvous"), rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            for label, arch, shape, depth, sh, ov in CELLS:
                cfg = get_config(arch)
                if depth:
                    cfg = cfg.with_(n_layers=depth)
                cell = specs.build_cell(arch, shape, mesh, multi_pod=False,
                                        overrides=ov, cut=(cfg, sh))
                t0 = time.perf_counter()
                want = _cell_outputs(cell, _plain_step(
                    cell, _cell_args(dev, cell)))
                sync(dev)
                plain_s = time.perf_counter() - t0
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                placed = specs.place(_cell_args(dev, cell),
                                     cell.in_placements, mesh)
                _build.reset_launches()
                t0 = time.perf_counter()
                out = cell.fn(*placed)
                sync(dev)
                cell_s = time.perf_counter() - t0
                counts = launch_counts()
                peak = torch.cuda.max_memory_allocated(dev) / 1e9
                got = _cell_outputs(cell, out)
                del out, placed
                if len(got) != len(want):
                    raise AssertionError(f"cell {label}: {len(got)} outputs, "
                                         f"the plain step {len(want)}")
                # a train step's lr is on the step's device: the CPU for
                # the plain step, the card for the cell's placed step
                got = [a.to(b.device) for a, b in zip(got, want)]
                exact = all(torch.equal(a, b) for a, b in zip(got, want))
                gap = 0.0
                if not exact:
                    gap = max(float((a.float() - b.float()).abs().max())
                              / max(float(b.float().abs().max()), 1e-30)
                              for a, b in zip(got, want))
                need = {"flash_attention": cfg.family != "ssm"
                        and cell.kind in ("train", "prefill"),
                        "linear_scan": cfg.family in ("ssm", "hybrid")
                        and cell.kind != "decode"}
                for name, needed in need.items():
                    if needed and not counts[name]:
                        raise AssertionError(f"cell {label}: {name} was "
                                             f"not launched")
                    launches[f"{name}/cell_{arch}_{shape}"] = counts[name]
                cut = (f"{depth} of {get_config(arch).n_layers} layers, "
                       if depth else "the whole model, ")
                print(f"phase 10e (a) cell {label} ({cut}{sh}, overrides "
                      f"{ov}) on a world-1 NCCL (data 1, model 1) mesh of "
                      f"{torch.cuda.get_device_name(0)} ({smi}): "
                      f"{cell_s * 1e3!r} ms (the plain step "
                      f"{plain_s * 1e3!r} ms), peak {peak!r} GB; flash "
                      f"{counts['flash_attention']} launches, scan "
                      f"{counts['linear_scan']}; {len(got)} outputs "
                      + ("bit-identical to the plain step" if exact else
                         f"NOT bit-identical: largest gap {gap!r} of the "
                         f"largest entry"), flush=True)
                if not exact:      # at world 1 every op is the plain one
                    raise AssertionError(f"cell {label}: {gap!r} from the "
                                         f"plain step")
                del got, want
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    return launches


def gloo_collectives() -> dict:
    """tools/gloo_cuda_probe.py's float32 lines: {collective: result}."""
    proc = subprocess.run([sys.executable, str(ROOT / "tools" /
                                               "gloo_cuda_probe.py")],
                          capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))
    if proc.returncode:
        raise AssertionError(f"gloo_cuda_probe.py failed: "
                             f"{proc.stderr[-2000:]}")
    found = {}
    for line in proc.stdout.splitlines():
        head, _, res = line.rpartition(": ")
        what = head.split("cuda tensors: ")[-1]
        if what.endswith(" float32"):
            found[what[:-len(" float32")]] = res
    return found


_DTENSOR_GLOO = r"""
import os, sys, tempfile, torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

def rank(r, init):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method="file://" + init, rank=r,
                            world_size=2)
    try:
        mesh = init_device_mesh("cuda", (1, 2),
                                mesh_dim_names=("data", "model"))
        t = torch.arange(512 * 64, dtype=torch.float32,
                         device="cuda").reshape(512, 64)
        d = distribute_tensor(t, mesh, [Replicate(), Shard(0)],
                              src_data_rank=None)
        assert torch.equal(d.full_tensor(), t)
    finally:
        dist.destroy_process_group()

with tempfile.TemporaryDirectory() as tmp:
    mp.spawn(rank, args=(os.path.join(tmp, "rendezvous"),), nprocs=2)
print("OK")
"""


def dtensor_on_gloo() -> str:
    """'' when two gloo ranks sharing the card carry DTensor's own
    redistribution (a (512, 64) float32 shard gathered whole through
    ``_functional_collectives``), else what went wrong. In a process of
    its own: gloo has been seen to crash (SIGSEGV in ``wait_tensor``)
    there on torch 2.11 where its plain collectives of the probe pass."""
    proc = subprocess.run([sys.executable, "-c", _DTENSOR_GLOO],
                          capture_output=True, text=True, timeout=300,
                          cwd=str(ROOT))
    if proc.returncode == 0 and "OK" in proc.stdout:
        return ""
    tail = [line for line in proc.stderr.splitlines() if line.strip()]
    return (f"exit {proc.returncode}: "
            + " | ".join(tail[-2:])[-300:])


def cells_on_gloo() -> None:
    """(b): whether gloo carries DTensor's collectives on CUDA tensors
    here, and why GLOO_CELLS stay in the CPU tests."""
    probe = gloo_collectives()
    print(f"phase 10e (b) gloo on CUDA tensors, float32: {probe}")
    refused = [c for c in DTENSOR_COLLECTIVES if probe.get(c) != "ok"]
    if refused:
        why = (f"gloo refuses {refused} on CUDA tensors, which DTensor's "
               f"redistributions issue")
    else:
        crash = dtensor_on_gloo()
        why = (f"a DTensor redistribution over two gloo ranks on CUDA "
               f"tensors fails ({crash}), though the probe's plain "
               f"collectives pass" if crash else
               "no two-rank runner is kept; DTensor's gather over two gloo "
               "ranks on CUDA tensors passed in this run, so one can return")
    for arch, shape in GLOO_CELLS:
        print(f"phase 10e (b) cell {arch} {shape} on two gloo ranks sharing "
              f"the card: not run; it stays in the CPU tests "
              f"(tests/test_torch_cells.py) because {why}")


def dry_run_records(proc) -> list:
    """(c): the records of the dry-run process started with the card's
    phases, each required ok."""
    out, err = proc.communicate(timeout=DRY_TIMEOUT_S)
    if proc.returncode:
        raise AssertionError(f"dry run failed: {err[-3000:]}")
    recs = [json.loads(line[4:]) for line in out.splitlines()
            if line.startswith("DRY ")]
    if len(recs) != len(DRY_CELLS):
        raise AssertionError(f"dry run: {len(recs)} records of "
                             f"{len(DRY_CELLS)}")
    for rec in recs:
        tb = rec.pop("traceback", None)
        depth = rec.pop("depth")
        print(f"phase 10e (c) dry run on the host ({rec['mesh']}, meta "
              f"tensors over a fake process group"
              + (f", {depth} layers" if depth else ", every layer") + "): "
              + json.dumps(rec), flush=True)
        if rec["status"] != "ok":
            raise AssertionError(f"dry run {rec['arch']} {rec['shape']}: "
                                 f"{rec.get('error')}\n{tb}")
    return recs


def cells_path(dev, smi: str, dry) -> dict:
    """Phase 10e -> the flash and scan launches of each cell of (a)."""
    t0 = time.perf_counter()
    launches = cells_on_card(dev, smi)
    cells_on_gloo()
    dry_run_records(dry)
    print(f"phase 10e: {time.perf_counter() - t0!r} s")
    return launches


def timed(fn):
    """(device ms per call from the profiler, ms per call between CUDA
    events, device operations per call)."""
    ms, ops = device_ms(fn)
    return ms, event_ms(fn), ops


def time_kernels(dev, errs: dict, launches: dict, path_codes, pod) -> list:
    import torch
    from repro_torch.kernels.consolidate import (consolidate_fused,
                                                 consolidate_plain)
    from repro_torch.kernels.histogram import histogram, histogram_plain
    from repro_torch.kernels.quantize import (channel_order, quantize_fused,
                                              quantize_plain)

    gen = torch.Generator().manual_seed(1)
    rows = []

    def row(name, src, replaces, kernel, plain, nbytes, library, note,
            flops=0.0, peak=F32_FLOPS, clock="from the profiler"):
        """``flops`` at ``peak``, or a list of (flops, peak) terms whose
        times add up. ``clock``: where the device times come from."""
        terms = flops if isinstance(flops, list) else [(flops, peak)]
        by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        by_ops = sum(f / p for f, p in terms) * 1e3
        bound = max(by_bytes, by_ops)
        lib = None if library is None else library[0]
        ops = " + ".join(f"{f!r} flops at {p:g}/s" for f, p in terms)
        print(f"time {name} ({note}): device time per call, {clock}: "
              f"kernel {kernel[0]!r} ms, plain {plain[0]!r} ms, "
              f"library {lib!r} ms; bound {bound!r} ms ({nbytes} bytes -> "
              f"{by_bytes!r} ms; {ops} -> {by_ops!r} "
              f"ms); per call between CUDA events, launch included: kernel "
              f"{kernel[1]!r} ms, plain {plain[1]!r} ms, library "
              f"{None if library is None else library[1]!r} ms; device "
              f"operations per call: kernel {kernel[2]!r}, plain "
              f"{plain[2]!r}, library "
              f"{None if library is None else library[2]!r}")
        return dict(name=name, route="cuda", source=src, replaces=replaces,
                    launches=launches[name], max_abs_err=errs[name],
                    ms=kernel[0], plain_ms=plain[0], bound_ms=bound,
                    bound_by="bytes" if by_bytes >= by_ops else "operations",
                    library_ms=lib)

    def quantize_times(b):
        x = torch.randn((b, R, P), generator=gen).to(dev)
        sel = torch.randperm(P, generator=gen)[:C].to(torch.int32).to(dev)
        sel64 = sel.long()
        order = channel_order(sel)      # once per selection, as the plan
        ms = timed(lambda: quantize_fused(x, BITS, sel, order=order))
        plain = timed(lambda: quantize_plain(x, BITS, sel64))
        # selected elements read once, codes and fp16 side info written once
        nbytes = b * R * C * 4 + C * 4 + b * R * C + 2 * b * C * 2
        # 32-byte sectors of x that the gather touches
        sectors = len(set((sel.cpu().numpy() * 4 // 32).tolist()))
        return ms, plain, nbytes, b * R * sectors * 32

    def histogram_times(codes):
        offs = torch.arange(C, device=dev) * 256
        ms = timed(lambda: histogram(codes, 256))
        plain = timed(lambda: histogram_plain(codes, 256))
        lib = timed(lambda: torch.bincount(
            (codes.long() + offs).view(-1), minlength=C * 256))
        return ms, plain, lib, codes.numel() + C * 256 * 4

    def uniform(k):
        return torch.randint(0, 256, (k, C), generator=gen,
                             dtype=torch.uint8).to(dev)

    def consolidate_times(b):
        z = torch.randn((b, R, P), generator=gen).to(dev)
        sel = torch.randperm(P, generator=gen)[:C].to(torch.int32).to(dev)
        order = channel_order(sel)      # once per selection, as the plan
        codes, mins, maxs = quantize_fused(z, BITS, sel, order=order)
        est = z + 0.3 * torch.randn((b, R, P), generator=gen).to(dev)
        sel64 = sel.long()
        ms = timed(lambda: consolidate_fused(est, codes, mins, maxs, BITS,
                                             sel, order=order))
        plain = timed(lambda: consolidate_plain(est, codes, mins, maxs,
                                                BITS, sel64))
        # selected elements of z read and written once, codes, side info
        # and sel read once
        nbytes = 2 * b * R * C * 4 + b * R * C + 2 * b * C * 2 + C * 4
        # 32-byte sectors of z that hold a selected channel, read and
        # written
        sectors = len(set((sel.cpu().numpy() * 4 // 32).tolist()))
        return ms, plain, nbytes, 2 * b * R * sectors * 32

    q1 = quantize_times(1)
    q8 = quantize_times(B)
    h1 = histogram_times(uniform(R))
    h8 = histogram_times(uniform(B * R))
    hp = histogram_times(path_codes)
    c8 = consolidate_times(B)
    rows.append(row("quantize", "src/repro_torch/csrc/quantize.cu",
                    "src/repro/kernels/quantize.py:48", q1[0], q1[1], q1[2],
                    None, f"main path B=1 R={R} P={P} C={C}; the gather "
                    f"touches {q1[3]} bytes of 32-byte sectors"))
    row("quantize", "", "", q8[0], q8[1], q8[2], None,
        f"slice B={B} R={R} P={P} C={C}; the gather touches {q8[3]} bytes "
        f"of 32-byte sectors")
    rows.append(row("histogram", "src/repro_torch/csrc/histogram.cu",
                    "src/repro/kernels/histogram.py:61", h1[0], h1[1], h1[3],
                    h1[2], f"main path K={R} C={C} nsym=256, uniform codes"))
    row("histogram", "", "", h8[0], h8[1], h8[3], h8[2],
        f"slice K={B * R} C={C} nsym=256, uniform codes")
    row("histogram", "", "", hp[0], hp[1], hp[3], hp[2],
        f"main path K={R} C={C} nsym=256, the quantize kernel's codes of "
        f"the edge CNN's z")
    rows.append(row("consolidate", "src/repro_torch/csrc/consolidate.cu",
                    "src/repro/kernels/consolidate.py:37", c8[0], c8[1],
                    c8[2], None, f"main path B={B} R={R} P={P} C={C}, the "
                    f"plan's channel table; the kernel reads and writes "
                    f"{c8[3]} bytes of 32-byte sectors of z"))
    rows += time_cdf(dev, row, gen)
    rows += time_baf_conv(dev, row, errs, launches)
    rows += time_lm_kernels(dev, row, gen)
    rows += time_pod_kernels(row, pod)
    # the compressed step's launches of flash and the scan, at the training
    # rows' shapes and times
    for base in ("flash_attention/train_zamba2_1p2b",
                 "linear_scan/train_zamba2_1p2b"):
        name = base + "_compressed"
        rows.append(dict(next(r for r in rows if r["name"] == base),
                         name=name, launches=launches[name]))
    # phase 10d's mesh serve runs the main path's kernels at its shapes
    for base in ("quantize", "histogram", "consolidate"):
        rows.append(dict(next(r for r in rows if r["name"] == base),
                         name=base + "/mesh", launches=launches[base + "/mesh"]))
    return rows


def time_baf_conv(dev, row, errs: dict, launches: dict) -> list:
    """baf_conv at BAF_CONVS for B=8 and 32 (``baf_conv/<conv>_b<B>``: its
    launches on the main path, 0 at the shapes no path of this script runs;
    its error against the plain version at that shape and batch), beside
    its plain version and one cuDNN call
    (``F.conv2d`` on the padded channels_last view, as nn.py pads it, or
    ``F.conv_transpose2d``); bound: its products at 3xTF32's 165 TFLOP/s.

    Times between CUDA events around 50 back-to-back calls: each call keeps
    the card busy for 0.05 ms or more, so the host's launches hide behind
    it. The profiler only counts each call's device operations here: this
    late in the run its sessions lost cuDNN's kernels (a 1.26 ms call read
    0.05 ms, one operation of seven) and read the kernel at half its
    time, where a run of these rows alone agreed with the events."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.baf_conv import (baf_conv, baf_conv_cost,
                                              baf_conv_plain)
    from repro_torch.nn import _same_pads

    def clocked(fn):
        return (event_ms(fn),) * 2 + (device_ms(fn)[1],)

    gen = torch.Generator().manual_seed(31)
    out = []
    for b in (B, 32):
        for conv in BAF_CONVS:
            label, h, cin, cout, stride, transposed, kind = conv
            x, w, kw = baf_conv_inputs(dev, b, conv, gen)
            xc = x.permute(0, 3, 1, 2)
            if transposed:
                wt = w.flip(-2, -1).transpose(0, 1)

                def library():
                    return F.conv_transpose2d(xc, wt, kw["bias"], stride=2)
            else:
                pt, pb = _same_pads(h, 3, stride)
                xp = F.pad(xc, (pt, pb, pt, pb))

                def library():
                    return F.conv2d(xp, w, kw["bias"], stride=stride)
            flops, nbytes = baf_conv_cost(x, w, **kw)
            name = f"baf_conv/{label}_b{b}"
            launches[name] = launches.get(name, 0)
            with torch.no_grad():
                got = baf_conv(x, w, **kw)
                want = baf_conv_plain(x, w, **kw)
            errs[name] = max_abs_diff([(got, want)])
            print(f"baf_conv {label} B={b}: kernel vs plain max abs diff "
                  f"{errs[name]!r} (tolerance {BAF_CONV_TOL} relative and "
                  f"absolute); {launches[name]} launches on the main path")
            if not torch.allclose(got, want, rtol=BAF_CONV_TOL,
                                  atol=BAF_CONV_TOL):
                raise AssertionError(f"baf_conv kernel differs from plain "
                                     f"version at {name}")
            with torch.no_grad():
                kernel = clocked(lambda: baf_conv(x, w, **kw))
                plain = clocked(lambda: baf_conv_plain(x, w, **kw))
                lib = clocked(library)
            out.append(row(
                name, "src/repro_torch/csrc/baf_conv.cu",
                "none (XLA's convolutions; cuDNN on this path before)",
                kernel, plain, nbytes, lib,
                f"B={b} {h}x{h}x{cin} -> {cout}, stride {stride}"
                f"{', transposed' if transposed else ''}, {kind}; library "
                f"one cuDNN call, float32, TF32 off",
                flops=flops, peak=TF32_FLOPS / 3,
                clock="between CUDA events (device operations from the "
                      "profiler)"))
    return out


def time_cdf(dev, row, gen) -> list:
    """cdf at the cdf path's shape and layout, row-major, and at 12 bits."""
    import torch
    from repro_torch.kernels.histogram import cdf, cdf_plain

    out = []
    nsym = 1 << BITS
    counts = torch.randint(0, 64, (nsym, C), generator=gen,
                           dtype=torch.int32).to(dev)
    # the cdf path's layout: the (S, C) view of the histogram's (C, S)
    # counts, into the (S, C) view of a (C, S) buffer
    cols = counts.t().contiguous().t()
    dst = torch.empty_like(cols)
    out.append(row("cdf", "src/repro_torch/csrc/cdf.cu",
                   "src/repro/kernels/histogram.py:104",
                   timed(lambda: cdf(cols, out=dst)),
                   timed(lambda: cdf_plain(cols)), 2 * nsym * C * 4,
                   timed(lambda: torch.cumsum(cols, dim=0)),
                   f"cdf path S={nsym} C={C} through (C, S) views, library "
                   f"torch.cumsum"))
    row("cdf", "", "", timed(lambda: cdf(counts)),
        timed(lambda: cdf_plain(counts)), 2 * nsym * C * 4,
        timed(lambda: torch.cumsum(counts, dim=0)),
        f"S={nsym} C={C} row-major (S, C), library torch.cumsum")
    big = torch.randint(0, 64, (4096, C), generator=gen,
                        dtype=torch.int32).to(dev).t().contiguous().t()
    row("cdf", "", "", timed(lambda: cdf(big)),
        timed(lambda: cdf_plain(big)), 2 * 4096 * C * 4,
        timed(lambda: torch.cumsum(big, dim=0)),
        f"S=4096 (12 bits) C={C} through (C, S) views, library "
        f"torch.cumsum")
    return out


def scan_flops(b, h, nc, L, dk, dv, mode, v_bf16) -> list:
    """The linear scan's work as ``row``'s (flops, peak) terms: in each
    chunk the intra-chunk products over the (t, s) pairs the mask keeps
    (s < t in rwkv mode, s <= t in ssm mode), the carried state in and
    out, and the elementwise decay and bonus terms. Products at
    float32 accuracy run at the 3xTF32 rate (a third of TF32's), those
    with a bf16 v at half of it (v is exact in TF32: two terms); the
    elementwise terms at the float32 rate."""
    pairs = L * (L - 1) // 2 if mode == "rwkv" else L * (L + 1) // 2
    f32 = 2 * pairs * dk + 2 * L * dk * dv          # q k^T, q S
    with_v = 2 * pairs * dv + 2 * L * dk * dv       # scores v, k^T v
    n = b * h * nc
    return [(float(n * f32), TF32_FLOPS / 3),
            (float(n * with_v), TF32_FLOPS / (2 if v_bf16 else 3)),
            (float(n * 8 * L * dk), F32_FLOPS)]


def flash_flops(b, sq, sk, h, hd, causal, dtype: str) -> list:
    """Flash attention's work as ``row``'s (flops, peak) terms, over the
    (query, key) pairs the mask keeps (causal aligned by Sk - Sq, Sq <=
    Sk; or every pair). Per kept pair and head: 2 hd flops of q.k and 2 hd
    of p.v, and in float32 4 elementwise flops of the online softmax (the
    max, the subtraction, the exponential and the row sum; the scale folds
    into q). float32 products run at the 3xTF32 rate (a third of TF32's),
    the elementwise terms at the float32 rate; bf16 rows take the products
    at the bf16 tensor-core rate."""
    pairs = (sq * (sq + 1) // 2 + sq * (sk - sq)) if causal else sq * sk
    n = b * h * pairs
    if dtype == "bfloat16":
        return [(4.0 * hd * n, BF16_FLOPS)]
    return [(4.0 * hd * n, TF32_FLOPS / 3), (4.0 * n, F32_FLOPS)]


def time_lm_kernels(dev, row, gen, zamba_scan: bool = True) -> list:
    """flash at the qwen2-7b prefill's shape and at the other paths' (the
    detect head, the 15B prefills, the zoo's prefills and whisper's three
    attentions), the linear scan at the rwkv6-3b and zamba2-1.2b prefills'
    and ingest blocks' (the latter without ``zamba_scan``, for a checkout
    whose scan kernel does not take zamba2's chunk of 128), and zamba2's
    prefill shape with a per-channel decay, printed beside its rows (not
    on a path)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_backward,
                                                     flash_attention_plain)
    from repro_torch.kernels.linear_scan import (_scratch_floats, linear_scan,
                                                 linear_scan_backward,
                                                 linear_scan_plain)

    out = []

    g = torch.Generator(device=dev).manual_seed(3)

    def flash_row(name, dtype, shape, note):
        b, sq, sk, h, kh, hd, causal = shape
        q = torch.randn((b, sq, h, hd), generator=g, device=dev).to(dtype)
        k = torch.randn((b, sk, kh, hd), generator=g, device=dev).to(dtype)
        v = torch.randn((b, sk, kh, hd), generator=g, device=dev).to(dtype)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        # q, k, v read once and o written once, in their dtype
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        return row(
            name, "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:81",
            timed(lambda: flash_attention(q, k, v, causal=causal)),
            timed(lambda: flash_attention_plain(q, k, v, causal=causal)),
            nbytes,
            timed(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=kh != h)),
            f"{note} B={b} Sq={sq} Sk={sk} H={h} KH={kh} hd={hd} "
            f"{str(dtype).split('.')[1]} {'causal' if causal else 'not causal'}"
            f"; library F.scaled_dot_product_attention on (B, H, S, hd) "
            f"copies", flops=flash_flops(b, sq, sk, h, hd, causal,
                                         str(dtype).split(".")[1]))

    out.append(flash_row("flash_attention", torch.bfloat16,
                         (QWEN_B, QWEN_PROMPT, QWEN_PROMPT, 28, 4, 128, True),
                         "qwen2-7b prefill"))
    notes = {"detect_head": "detect head (a micro-batch of 8)",
             "qwen2_7b_f32": "qwen2-7b prefill in float32",
             "zamba2_1p2b": "zamba2-1.2b shared block, prefill",
             "whisper_encoder": "whisper-tiny encoder self-attention",
             "whisper_decoder": "whisper-tiny decoder self-attention",
             "whisper_cross": "whisper-tiny cross-attention"}
    for label, name, shape in FLASH_PATH_SHAPES:
        out.append(flash_row(f"flash_attention/{label}", getattr(torch, name),
                             shape, notes.get(label, f"{label} prefill")))
    # head dim 8 at qwen2-72b's smoke training shape, both dtypes
    hd8 = dict(FLASH_TRAIN_SHAPES)["hd8"][:7]
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        out.append(flash_row(f"flash_attention/hd8_{tag}", dtype, hd8,
                             "qwen2-72b smoke training step (head dim 8)"))
    # the training runs' shapes (one microbatch); the backward is plain
    # torch, timed beside the kernel's forward
    for label, (b, sq, sk, h, kh, hd, causal, window) in FLASH_TRAIN_SHAPES:
        if not label.startswith("train_"):
            continue
        r = flash_row(f"flash_attention/{label}", torch.bfloat16,
                      (b, sq, sk, h, kh, hd, causal),
                      f"{label[6:]} training forward (a microbatch)")
        q = torch.randn((b, sq, h, hd), generator=g, device=dev) \
            .to(torch.bfloat16)
        k, v = (torch.randn((b, sk, kh, hd), generator=g, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        do = torch.randn_like(q)
        r["backward_ms"] = timed(lambda: flash_attention_backward(
            q, k, v, do, causal=causal, window=window))[0]
        print(f"time {r['name']} backward (plain torch, float32): "
              f"{r['backward_ms']!r} ms device time per call")
        out.append(r)

    for name, s_, init in (("linear_scan", RWKV_PROMPT, False),
                           ("linear_scan/ingest_block", RWKV_BLOCK, True)):
        b, h, dk, dv, L = RWKV_B, 40, 64, 64, 16
        qs = torch.randn((b, s_, h, dk), generator=g, device=dev) * 0.5
        ks = torch.randn((b, s_, h, dk), generator=g, device=dev) * 0.5
        vs = torch.randn((b, s_, h, dv), generator=g, device=dev)
        qs, ks, vs = (t.to(torch.bfloat16) for t in (qs, ks, vs))
        ld = -torch.exp(torch.randn((b, s_, h, dk), generator=g,
                                    device=dev) - 1.0)
        u = torch.randn((h, dk), generator=g, device=dev) * 0.1
        s0 = torch.randn((b, h, dk, dv), generator=g, device=dev) \
            if init else None
        kw = dict(bonus=u, initial_state=s0, chunk=L, mode="rwkv")
        # bf16 q, k, v and f32 decay read once; f32 y and state written once
        nbytes = b * s_ * h * (2 * dk * 2 + dv * 2 + dk * 4 + dv * 4) \
            + h * dk * 4 + (2 if init else 1) * b * h * dk * dv * 4
        nc = s_ // L
        out.append(row(
            name, "src/repro_torch/csrc/linear_scan.cu",
            "src/repro/kernels/linear_scan.py:80",
            timed(lambda: linear_scan(qs, ks, vs, ld, **kw)),
            timed(lambda: linear_scan_plain(qs, ks, vs, ld, **kw)),
            nbytes, None,
            f"rwkv6-3b {'ingest block' if init else 'prefill'} B={b} "
            f"S={s_} H={h} dk=dv={dk} chunk {L}, rwkv with bonus"
            f"{', initial state' if init else ''}; scratch "
            f"{_scratch_floats(b, h, nc, L, dk, dv) * 4} bytes",
            flops=scan_flops(b, h, nc, L, dk, dv, "rwkv", True)))

    for label, (b, s_, h, dk, dv, L, mode) in SCAN_TRAIN_SHAPES:
        qs, ks = ((torch.randn((b, s_, 1 if mode == "ssm" else h, dk),
                               generator=g, device=dev) * 0.5)
                  .expand(b, s_, h, dk).to(torch.bfloat16).contiguous()
                  for _ in range(2))
        vs = torch.randn((b, s_, h, dv), generator=g, device=dev) \
            .to(torch.bfloat16)
        raw = torch.randn((b, s_, h, dk if mode == "rwkv" else 1),
                          generator=g, device=dev)
        ld = -torch.exp(raw - 1.0) if mode == "rwkv" else \
            -F.softplus(raw - 2.0) * 0.6931
        u = torch.randn((h, dk), generator=g, device=dev) * 0.1 \
            if mode == "rwkv" else None
        kw = dict(bonus=u, chunk=L, mode=mode)
        nbytes = b * s_ * h * (2 * dk * 2 + dv * 2 + ld.shape[-1] * 4
                               + dv * 4) + b * h * dk * dv * 4 \
            + (h * dk * 4 if u is not None else 0)
        nc = s_ // L
        r = row(f"linear_scan/{label}", "src/repro_torch/csrc/linear_scan.cu",
                "src/repro/kernels/linear_scan.py:80",
                timed(lambda: linear_scan(qs, ks, vs, ld, **kw)),
                timed(lambda: linear_scan_plain(qs, ks, vs, ld, **kw)),
                nbytes, None,
                f"{label[6:]} training forward (a microbatch) B={b} S={s_} "
                f"H={h} dk=dv={dk} chunk {L}, {mode}",
                flops=scan_flops(b, h, nc, L, dk, dv, mode, True))
        dy = torch.randn((b, s_, h, dv), generator=g, device=dev)
        r["backward_ms"] = timed(lambda: linear_scan_backward(
            (qs, ks, vs, ld, u, None), dy, None, chunk=L, mode=mode))[0]
        print(f"time {r['name']} backward (plain torch: the plain "
              f"version's vjp, recomputed): {r['backward_ms']!r} ms device "
              f"time per call")
        out.append(r)

    for label, s_, init in ZAMBA_SCAN if zamba_scan else ():
        b, h, dk, dv, L = QWEN_B, 64, 64, 64, 128
        # C and B of the Mamba-2 layer broadcast over the heads, as the
        # block hands them to the scan
        qs, ks = ((torch.randn((b, s_, 1, dk), generator=g, device=dev)
                   * 0.5).expand(b, s_, h, dk).to(torch.bfloat16).contiguous()
                  for _ in range(2))
        vs = torch.randn((b, s_, h, dv), generator=g, device=dev) \
            .to(torch.bfloat16)
        ld = -F.softplus(torch.randn((b, s_, h, 1), generator=g, device=dev)
                         - 2.0) * 0.6931
        s0 = torch.randn((b, h, dk, dv), generator=g, device=dev) \
            if init else None
        kw = dict(initial_state=s0, chunk=L, mode="ssm")
        # bf16 q, k, v and the f32 (B, S, H, 1) decay read once; f32 y and
        # state written once (and the initial state read)
        nbytes = b * s_ * h * (2 * dk * 2 + dv * 2 + 4 + dv * 4) \
            + (2 if init else 1) * b * h * dk * dv * 4
        nc = s_ // L
        flops = scan_flops(b, h, nc, L, dk, dv, "ssm", True)
        out.append(row(
            f"linear_scan/{label}", "src/repro_torch/csrc/linear_scan.cu",
            "src/repro/kernels/linear_scan.py:80",
            timed(lambda: linear_scan(qs, ks, vs, ld, **kw)),
            timed(lambda: linear_scan_plain(qs, ks, vs, ld, **kw)),
            nbytes, None,
            f"zamba2-1.2b {'ingest block' if init else 'prefill'} B={b} "
            f"S={s_} H={h} dk=dv={dk} chunk {L}, ssm, (B, S, H, 1) decay"
            f"{', initial state' if init else ''}; scratch "
            f"{_scratch_floats(b, h, nc, L, dk, dv) * 4} bytes",
            flops=flops))
        if init:
            continue
        # the same shape with a per-channel (B, S, H, dk) decay
        ld = -F.softplus(torch.randn((b, s_, h, dk), generator=g, device=dev)
                         - 2.0) * 0.6931
        row(f"linear_scan/{label}", "", "",
            timed(lambda: linear_scan(qs, ks, vs, ld, **kw)),
            timed(lambda: linear_scan_plain(qs, ks, vs, ld, **kw)),
            nbytes + b * s_ * h * (dk - 1) * 4, None,
            f"zamba2-1.2b prefill shape B={b} S={s_} H={h} dk=dv={dk} chunk "
            f"{L}, ssm, a per-channel (B, S, H, dk) decay (not on a path)",
            flops=flops)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.yolo_baf import full_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = resolve_device(None)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    print(f"device: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}")

    t_lap = [t_start]

    def lap(name: str) -> None:
        """The host clock's seconds for the phase just ended."""
        now = time.perf_counter()
        print(f"host time, {name}: {now - t_lap[0]!r} s (total "
              f"{now - t_start!r} s)")
        t_lap[0] = now

    secs = _build.build_all()
    print(f"build: {secs!r} s wall for "
          + ", ".join(f"{k.name} {k.build_seconds!r} s" for k in
                      _build.KERNELS))

    dry = start_dry_run()              # phase 10e (c), on the host
    lap("build")
    errs = check_kernels(dev)
    errs.update(check_lm_kernels(dev))
    lap("kernel checks")
    cfg = full_config()
    print(f"main path: {cfg}, split {cfg.split_hw}x{cfg.split_hw}x"
          f"{cfg.split_p}, Q={cfg.split_q}, C={C}, bits={BITS}, rans, fused")
    res = main_path(dev, cfg)
    errs["consolidate"] = max(errs["consolidate"], res["consolidate_err"])
    errs["histogram"] = max(errs["histogram"], res["histogram_err"])
    for k, v in res["times"].items():
        print(f"stage {k}: {v * 1e3!r} ms per request")
    launches = dict(res["launches"])
    launches["cdf"] = cdf_path(dev, res["decoded"])["cdf"]
    lap("BaF main path and cdf path")
    offline_path(dev, smi)
    lap("offline side")
    serving_path(dev, smi)
    lap("serving gateway")
    tasks = session_task_path(dev, smi)
    lap("sessions and tasks")
    errs["flash_attention/detect_head"] = max(
        errs["flash_attention/detect_head"], tasks["detect_err"])
    launches["flash_attention/detect_head"] = tasks["detect_flash"]
    with torch.no_grad():              # the LM serving phases
        qwen = dense_lm_path(dev, "qwen2_7b", 0, 10)
        lap("qwen2-7b")
        for arch, seed, token_seed in BIG_LMS:
            big = dense_lm_path(dev, arch, seed, token_seed,
                                bf16_spread=BIG_LM_BF16_SPREAD)
            launches[f"flash_attention/{arch}"] = \
                big["launches"]["flash_attention"]
            lap(arch)
        rwkv = rwkv_path(dev)
        lap("rwkv6-3b")
        launches["flash_attention"] = qwen["launches"]["flash_attention"]
        launches["flash_attention/qwen2_7b_f32"] = \
            qwen["launches32"]["flash_attention"]
        # the scan's two rows: its launches in the prefill and in the ingest
        launches["linear_scan"] = rwkv["n_prefill"]
        launches["linear_scan/ingest_block"] = rwkv["n_ingest"]
        launches.update(zoo_paths(dev))
        lap("the zoo (phase 9b)")
        lms_card_vs_cpu(dev)
        lap("LMs card vs CPU")
    errs["linear_scan/ingest_block"] = errs["linear_scan"]
    train_launches, loss1 = training_path(dev, errs)
    launches.update(train_launches)
    lap("LM training (phase 10a)")
    pod = distributed_path(dev, loss1["zamba2_1p2b"], qwen)
    launches.update(pod["launches"])
    errs.update(pod["errs"])
    launches.update(mesh_path(dev, smi))
    cells_path(dev, smi, dry)
    lap("phases 10b-10e")
    rows = time_kernels(dev, errs, launches, res["path_codes"], pod)
    lap("kernel times")
    print(f"total {time.perf_counter() - t_start!r} s")
    print(json.dumps({"kernels": rows}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

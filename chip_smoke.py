#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (the kernels are built from ``accelerate_tpu_torch/
csrc`` at first use) and no network. Phases, each of which fails the run:

1. build the CUDA kernels (one ``nvcc`` per source, in parallel) and the
   native host pipeline (``g++``; ``parallel_collate`` held to
   ``np.stack``'s bytes and timed against it); check
   that the flash forward, dq and dk/dv libraries, the fused forward and
   backward and the paged prefill hold tensor-core (``HGMMA``)
   instructions in their SASS and that no tensor-core variant and no
   paged decode variant spills registers;
2. each kernel against its plain PyTorch version on the card, in bf16 and
   f32, with times beside the least time the card could take and one
   PyTorch library call as a yardstick: the paged kernels at the serving
   path's shapes (decode at 8 ragged rows of up to 256 and 512 keys and
   one row of 512; prefill chunks of 128 and 256), with table entries past
   kv_len on a NaN block leaving the decode output bitwise unchanged, and
   the decode at each keys-per-split it can take; the fused attention
   forward and backward at BERT-base's (B=32, S=128, H=12, D=64, padded
   rows), a causal GQA case and S=1024;
3. the serving engine at full Llama-1B width (dim 2048, 16 layers, 32/8
   heads, vocab 32000; random bf16 weights from seed 0) answering 9 greedy
   requests — launch counters zeroed before and read after, so the run
   shows that the path went through both kernels; then ``torch.profiler``
   over 8 decode steps for the device's busy share, top kernels and the
   paged decode kernel's device time, and over one step that prefills a
   256-token chunk;
4. the cached path (chunked prefill + 16 decode steps through
   ``paged_forward`` and the kernels) against the plain full-sequence
   forward, logits compared in f32;
   then ``bench.py``'s config #5 on the same model: ``greedy_generate`` at
   batch 8 x 128 prompt tokens, 64 new, with warm-up (prefill seconds,
   decode tokens/s, seconds/token, the HBM roofline fraction, a profiled
   decode step), every greedy token held to an f32 forward of the same
   weights (the argmax, or a printed near-tie within a bar) and the
   cached forward in f32 to its logits, two decode-cache faults planted
   in the path failing both checks,
   ``sample_generate`` twice from one key to the same tokens, and
   ``beam_generate`` at 4 beams (finite) and 1 (equal to greedy); then its
   offload legs: ``cpu_offload`` (pinning timed apart) and
   ``generate_dispatched`` for 16 tokens, bit for bit greedy's tokens,
   with the bytes a token moves against one pinned copy timed alone and
   the copy time that runs beside the layers' kernels in a profile;
   ``disk_offload`` and ``load_checkpoint_and_dispatch`` from an ``.npz``
   of the same weights (layers on the card, on the host and two on disk),
   4 tokens each, the same tokens; the same weights quantized to int8 and
   NF4 (``phase_quant``): bytes an element, greedy decoding token for token
   the dense run's over the dequantized params with tokens/s and the extra
   peak memory against the bf16 run, the serving engine on the NF4 params
   equal to the engine over the dequantized ones, and
   ``int8_dynamic_matmul``'s int32 block partials through ``_int_mm``
   bitwise the plain product's;
   then ``benchmarks/serving/run.py``'s legs at their TPU configuration
   (dim 1024, 8 layers, 16/8 heads, vocab 32000, random bf16 weights from
   seed 0; 8 slots, 160 blocks of 16; the bench's seeded open-loop
   workloads), each with its launch counts zeroed before and read after:
   the speculative leg (``spec_tokens=3, draft_layers=2``) against the
   plain one — tokens/s, per-token latency, steps, accept rate, every
   divergence with its top-2 gap and the two legs' logit |delta|, held to
   a bar, and an f32 run of 4 requests whose streams must match; the same
   workload sampled (top-k, top-p), with and without speculation, each leg
   run twice to the same tokens, and the sampler's launches and device ms;
   continuous against static batching on 32 requests; then the serving
   fleet (``phase_fleet``) over config #5's model built by
   ``ReplicaSpec.build_params``: the JAX serving bench's replicated legs
   (16 requests through 1 and 2 thread replicas and 2 with one killed after
   4 completions, outputs bitwise equal), 2 process replicas with one
   SIGKILLed (each child's time to ready), the correctness canary (a
   replica of another param seed drained, no false positive), and the
   disaggregated leg (1 prefill + 1 decode replica, the SLO autoscaler
   under a 1 µs ttft objective scaling the decode tier up, open-loop at
   0.02 s a step) against one monolithic replica, with the KV handoffs' MB
   and pack and land ms, each step of a handoff timed alone, a planted
   landing fault that must break the near-tie bar on bf16 partings, and in
   f32 every resume path (kill, process, disaggregated, and a planted
   corrupt handoff caught and its prefill re-run) equal to its reference;
   #6/#7 launches counted on every leg, a child's from its own counters. Phase 2 also runs
   the paged kernels at a draft step's and a verify step's shapes, and at
   a tp 2 rank's heads of config #5 (16 q over 4 kv heads);
5. training: BERT-base at full width (``attn_impl="fused"``, S=128, batch
   32, random f32 master weights from seed 0, synthetic MRPC; the loader
   through ``prepare`` at its default ``prefetch_depth`` 2, its batches
   held bitwise to the synchronous loader's) through
   ``Accelerator(mixed_precision="bf16").prepare`` and
   ``prepare_train_loop`` (K=10 steps a call): one warm call, then timed
   calls with the fused-kernel counters zeroed before and read after (12
   forward and 12 backward launches a step); ``torch.profiler`` over one
   step for the busy share and top kernels; then 3 steps in f32, and 3 in
   fp16 with dynamic loss scaling, through the kernels against the same
   steps through their plain versions; then ``bench.py``'s config #3
   (gradient accumulation 4, micro-batch 64, 12 micro-steps a call) in
   bf16 and in fp16, 3 optimizer steps a call, with a profiled
   accumulation window, and a forced fp16 overflow whose loss scale must
   follow the scaler's rule on every micro-step; the fused kernels' fp16
   rows and an fp16 overflow that must leave the same elements non-finite
   in the kernel and in the plain version;
6. the flash kernels (#1-#3) against their plain versions at the
   long-context shapes and at ``bench.py`` config #4's attention (B=8,
   S=512, 20/20 heads); the long-context Llama (dim 1024, 16 layers,
   S=8192) in two legs, f32 masters with AdamW and the JAX bench's bf16
   params with ``adafactor`` and remat ``"dots_no_batch"``; then config #4
   itself at full width and depth (860.1 M params, vocab 50257, dim 1280,
   36 layers, 20 heads, batch 8 x 512, bf16 params, ``adafactor(1e-4)``,
   remat ``"dots_no_batch"``; the forward kernel runs twice a layer, once
   more in the recompute), timed, counted and profiled, with a few steps at
   remat ``False``, ``True``, ``"dots_no_batch"`` and ``"offload_dots"``
   whose peak memory must be ordered ``True < "dots_no_batch" < False``,
   with ``"offload_dots"`` (the same saved set in pinned host memory) below
   ``"dots_no_batch"``, and the bytes ``"offload_dots"`` sends to the host
   and takes back in one step; 3 f32 steps at its width and 2 layers, remat
   (``"dots_no_batch"`` and ``"offload_dots"``) against none and kernels
   against plain attention;
   the adafactor update on the card against the CPU; then config #4 at
   full width and depth through ``Accelerator.lomo_backward`` (3 steps of
   SGD fused into the backward: the gradient bytes left after a step and
   the most alive at once held to shares of the tree, losses held to the
   plain SGD step's, an fp16 leg at 4 layers whose planted overflow leaves
   the params bitwise unchanged, and a planted fault), and config #4 with
   f32 params and the recipe of
   ``examples/deepspeed_config_templates/zero_stage3_offload_config.json``
   through ``DeepSpeedPlugin(hf_ds_config=...)``: its AdamW state offloaded
   to pinned host memory, held bitwise to the plain step, with the peak
   below it by 0.75 of the state's bytes, the copies' GB/s against one
   pinned pass alone and their overlap with kernels, and a planted fault;
   fp8 (``phase_fp8``): the JAX bench's fp8 leg (``benchmarks/attention/
   run.py``'s TPU configuration, fp8 against bf16 step ms and the loss
   delta), ``fp8_dot``'s three products through ``_scaled_mm`` against the
   plain product at config #4's shapes, and config #4 at full width and
   depth under ``mixed_precision="fp8"`` with ``dtype_recipe="fp8"`` in
   ``phase_lm774m``'s recipe with accumulation 2: histories rolling every
   micro-step and params moving on boundaries only, every product
   launched through ``_scaled_mm``, step ms and peak against bf16;
7. the rest of the model zoo: ``bench.py``'s config #2 (ResNet-50, 1000
   classes, batch 64 x 192^2, bf16 params, ``sgd(0.1, momentum=0.9)``, 20
   timed steps through the Accelerator, a profiled step), the loss falling
   on its fixed batch, and one f32 step on the card against the CPU with
   TF32 off and with cuDNN's TF32 on; T5-small (batch 32 x 512 / 128
   tokens, ``adam``, bf16 mixed precision, K=4 loop steps, greedy decoding
   of 32 tokens, every bf16 token held to the f32 logits of its row, f32
   logits card vs CPU); the config #5 model with 8 experts, top-2: an f32
   forward card vs CPU at 2 layers, greedy generation (bf16 tokens held to
   the f32 cached path), the engine's requests through #6/#7 (launches
   counted, f32 streams repeatable) and 2 training steps in config #4's
   recipe through #1-#3 (launches counted), with the share of prefill
   token-choices dropped by capacity;
8. more than one process: ``PartialState`` from a torchrun-style
   environment joins an NCCL group of one and every collective of
   ``utils.operations`` runs on CUDA tensors against its one-process
   answer; config #4 at full width and depth through
   ``Accelerator(parallelism_config=ParallelismConfig(dp_shard_size=1))``
   and ``prepare_train_step``, its losses held to ``phase_lm774m``'s and
   its flash launches counted; then the script starts itself twice
   (``--cp-attn-child``): two processes share the card over ``gloo`` and
   split the long-context attention's sequence (B=1, S=8192, 16/8 heads,
   bf16) over cp 2 (the ring, zig-zag and all-gather) and sp 2
   (Ulysses), forward and backward, each rank's blocks held to one
   process's flash #1-#3 and to the plain attention, the ranks' #1-#3
   launches counted, two planted faults failing a bar; then twice more
   (``--mesh-2rank-child``) to train the long-context widths at 4 layers
   and S=2048 under
   dp_shard 2, tp 2, fused ZeRO-1, ZeRO-1 by annotation, dp_shard 2 in
   fp16, tp 2 through ``prepare(..., shard_rules=llama_shard_rules())``,
   adafactor under ZeRO-1, the bf16 comm hook, the optimizer state on
   the host, cp 2 with the zig-zag ring under ``llama_shard_rules`` (FSDP
   over cp) and sp 2 (Ulysses), each leg held to a one-process run or to
   its leg without the option, and fp8 under dp_replicate 2 with fused ZeRO-1 (the ranks' meta
   bitwise equal after every step, a passthrough slot for every meta leaf,
   losses held to one process), with flash #1-#3 launched on each
   rank (the fp16 leg: plain attention, the kernels take bf16 and f32),
   and BERT-base in phase_train's recipe under tp 2 through
   ``bert_shard_rules()``, held to one process with #4/#5 on each rank;
   config #4 at full width, 8 of its 36 layers (``MESH_LM_LAYERS``),
   under dp_shard 2, its layers gathered one at a time, held to a
   one-process run at the same depth with its peak memory a rank under
   0.75 of that run's, two planted faults failing a bar; phase_moe's model
   at 2 of its 16 layers (``MOE_EP_LAYERS``) and its training recipe under
   ep 2 (``moe_shard_rules``), held to a one-process run at that depth with
   equal drops and half the expert bytes a rank, and its greedy decode at
   all 16 layers under ep 2 equal to phase_moe's tokens;
   then config #5 at full width, 4 of its 16 layers, decoded under tp 2
   (``--mesh-decode-child``, ``llama_shard_rules``): f32 greedy 8 x 128 +
   64 and the engine's requests (f32 and bf16, #6/#7 on each rank's 16/4
   heads) held to one-process runs at near-ties, with per-rank bytes, ms a
   decode step, the collectives' bytes and a planted fault; the dp_shard 2
   leg of config #4 also saves sharded, steps, loads and steps again
   (bitwise), and that checkpoint loads into one process;
9. checkpoints (``phase_checkpoint``): config #4 at full width, 12 of its 36 layers
   saved after 2 steps and resumed in a fresh ``Accelerator`` to step 3
   bitwise; an async save with 2 steps at once behind it (stall, writer
   time, step ms with a writer in flight, device-to-host and disk GB/s),
   its files equal to a blocking save's; ``save_model`` and
   ``load_checkpoint_in_model`` bitwise; planted faults (a flipped byte in
   a shard file, a newest directory left uncommitted) caught; phase_train
   logs its steps through the JSONL tracker and reads them back;
10. the card's name and power limit, one JSON line of kernel records, and
   a last line ``{"ok": true, "device": {...}}``.

Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
import importlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# Kernel vs plain: f32 on both sides, another summation order. bf16: both
# accumulate in f32 and round the output once, so one bf16 step of an
# output below 2 in magnitude.
KERNEL_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# Cached path vs full forward, f32 logits (|logit| about 1 here): the two
# differ by the order of f32 sums through 16 layers, expected ~1e-4 at
# most; rounding every attention output to bf16 (the error a bf16
# accumulator would add) is expected near 1e-2 and must miss this bar —
# phase 4 checks that it does.
LOGIT_ATOL = 1e-3
# Fused kernels vs plain, relative to the largest magnitude of the plain
# result (gradients sum over up to 1024 keys): f32 differs only in the
# order of its sums; in bf16 both sides round p, ds and the outputs to bf16
# at the same points, so a value on the other side of a rounding boundary
# moves by one bf16 step — two steps allowed; fp16 the same in fp16 steps
# (2**-10 below 2).
FUSED_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -6, torch.float16: 2.0 ** -9}
# Training through the kernels vs through their plain versions, f32, 3
# AdamW steps (the two differ by the order of f32 sums only): losses within
# 1e-4 relative; each param leaf's 3-step update within 1e-3 of the plain
# run's in relative L2 norm. An update, not the param, because AdamW's
# step g / (|g| + eps) turns the rounding noise of a gradient element near
# zero into a visible share of lr, while a wrong gradient moves every
# element's step by O(lr). The key projection's bias has an exactly zero
# gradient (softmax ignores a constant added to a row's scores): its whole
# update is such noise, so it is held to the most 3 steps can move it, 3·lr.
TRAIN_RTOL = 1e-4
TRAIN_UPDATE_RTOL = 1e-3
TRAIN_LR = 2e-5
# The same 3 steps in fp16 with dynamic loss scaling: kernels and plain
# versions round p, ds and the outputs to fp16 at the same points, but sum
# in f32 in another order, so a value on a rounding boundary lands one fp16
# step apart; through 12 layers the step losses move by about 1e-4, and
# AdamW's g / (|g| + eps) turns that noise in near-zero gradients into the
# sign of small steps, as in the CPU tests' bf16 and fp16 envelopes: losses
# within 2e-3 relative, each leaf's update within 0.3 relative L2. The key
# bias's update is all such noise on both sides: each run moves it by at
# most 3 AdamW steps of about lr (|m̂| / √v̂ ≤ 1.003 in the first 3 steps), in
# any direction, so the two differ by at most 6 lr (the f32 check's 3 lr
# holds only because there both sides' noise is alike). The loss-scale and
# finite-flag sequences are decisions: they must be equal.
TRAIN_FP16_RTOL = 2e-3
TRAIN_FP16_UPDATE_RTOL = 0.3
# bench.py's config #3 (run_bench_grad_accum, bench.py:476-551): BERT-base,
# S=128, micro-batch 64, accumulation 4, 12 micro-steps a prepare_train_loop
# call, adamw(2e-5); 2 warm calls, then 4 timed ones. One departure:
# attn_impl="fused", where the bench keeps "auto" (the einsum path in both
# packages at S=128, which would run no kernel).
ACCUM_BATCH, ACCUM_STEPS, ACCUM_K, ACCUM_WARM, ACCUM_CALLS, ACCUM_LR = 64, 4, 12, 2, 4, 2e-5
# forced overflow: a scale that overflows the fp16 backward, short growth
# interval, 12 calls of one 4-micro-step window
FORCED_SCALE, FORCED_INTERVAL, FORCED_CALLS = 2.0 ** 30, 4, 16

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# dense bf16 and fp16 tensor cores; f32 outside them
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}

CONFIG_KW = dict(vocab_size=32000, dim=2048, n_layers=16, n_heads=32, n_kv_heads=8,
                 max_seq_len=512)
FUSED_CASES = {  # name: (B, S, H, Hkv, D, causal, padded)
    "bert": (32, 128, 12, 12, 64, False, True),
    "gqa_causal": (8, 256, 8, 2, 128, True, False),
    "s1024": (2, 1024, 12, 12, 64, False, True),
}
TRAIN_BATCH, TRAIN_SEQ, TRAIN_K, TRAIN_CALLS = 32, 128, 10, 2
ENGINE_KW = dict(num_blocks=160, block_size=16, max_slots=8, max_blocks_per_seq=32,
                 max_prefill_len=256)
# Flash kernels (#1-#3) against their plain versions: held to FUSED_RTOL for
# the same reasons (f32: another summation order; bf16: p and ds rounded at
# the same points against the same running max — the kernel rescales at the
# lattice's kv-block boundaries, as the plain version does).
FLASH_CASES = {  # name: (B, S, H, Hkv, D, window, packed); causal but FLASH_FULL_CASES
    "llama_long": (1, 8192, 16, 8, 64, None, False),  # the training slice's shape
    "packed": (4, 2048, 16, 8, 64, None, True),
    "window": (2, 4096, 16, 8, 64, 1024, False),
    "gqa_d128": (2, 2048, 8, 2, 128, None, False),
    "lm774m": (8, 512, 20, 20, 64, None, False),  # config #4's attention
    "lm774m_rank": (4, 512, 20, 20, 64, None, False),  # a rank's at dp_shard 2
    "moe_train": (4, 512, 32, 8, 64, None, False),  # phase_moe's training leg
    # phase_mesh_2rank's legs (f32): the one-process run and a tp 2 rank
    # take the global batch of 2, a dp_shard 2 or dp_replicate 2 rank 1 row
    "mesh_2rank": (2, 2048, 16, 8, 64, None, False),
    "mesh_2rank_b1": (1, 2048, 16, 8, 64, None, False),
    # a rank's blocks of the long-context attention split over cp 2
    # (phase_context_parallel): the ring's full block (a rank's 4096 queries
    # against another rank's 4096 keys) and zig-zag's full half-block (2048)
    "ring_block": (1, 4096, 16, 8, 64, None, False),
    "zigzag_block": (1, 2048, 16, 8, 64, None, False),
    # phase_mesh_2rank's cp 2 zig-zag leg (f32): a rank's causal and full
    # half-blocks of its 2 rows x 1024 tokens
    "cp2_half": (2, 512, 16, 8, 64, None, False),
    "cp2_half_full": (2, 512, 16, 8, 64, None, False),
}
# the cases whose blocks attend every key (no causal mask)
FLASH_FULL_CASES = ("ring_block", "zigzag_block", "cp2_half_full")
# The long-context Llama of the JAX package's run_bench_longcontext
# (bench.py:936-938) at full width and depth, batch 1 x S=8192.
LLAMA_KW = dict(vocab_size=32000, dim=1024, n_layers=16, n_heads=16, n_kv_heads=8,
                max_seq_len=8192, attn_impl="flash")
LLAMA_LR, LLAMA_K, LLAMA_CALLS = 1e-4, 2, 2
# kernels-vs-plain training check: the same width at 2 layers, a packed
# batch of 2 rows x 2048 tokens, 3 f32 AdamW steps
LLAMA_CHECK_LAYERS, LLAMA_CHECK_SEQ, LLAMA_CHECK_BATCH = 2, 2048, 2
# bench.py's config #4 (run_bench_fsdp_lm, bench.py:405-473) at full width
# and depth: a 774M-class Llama (860.1 M params; FFN 3584), bf16 params,
# adafactor(1e-4), remat "dots_no_batch" (the first rung of the bench's
# ladder), batch 8 x 512 of default_rng(0) ids, K steps a call. attn_impl=
# "flash" is what JAX's "auto" picks on a TPU at this shape (S=512 >= the
# bf16 causal crossover 384); the port's "auto" is the einsum path.
LM774M_KW = dict(vocab_size=50257, dim=1280, n_layers=36, n_heads=20, n_kv_heads=20,
                 max_seq_len=512, attn_impl="flash")
LM774M_BATCH, LM774M_LR, LM774M_K, LM774M_CALLS = 8, 1e-4, 2, 2
LM774M_REMATS = (False, True, "dots_no_batch", "offload_dots")
# check at a cut depth: 2 layers, 2 rows x 512, 3 f32 steps. Remat only
# recomputes what no remat computed once, with the same kernels on the same
# inputs, so the two runs may differ only where a kernel's summation order
# is not fixed: 1e-6 relative. The adafactor update on the card against the
# CPU (see _adafactor_device_check): f32 within 1e-5 of the leaf's largest
# update; bf16 each element within 8 bf16 ulps, each leaf within 1e-3
# relative L2 and bitwise in at least 99 % of its elements (measured on an
# H100: 5.0e-7; 4.4 ulps, 1.0e-4 and 99.99 %).
LM774M_CHECK_LAYERS, LM774M_CHECK_BATCH = 2, 2
REMAT_RTOL = 1e-6
ADAFACTOR_F32_RTOL, ADAFACTOR_BF16_ULPS, ADAFACTOR_BF16_RTOL = 1e-5, 8.0, 1e-3
ADAFACTOR_BF16_SAME = 0.99
# The serving benchmark's TPU configuration (benchmarks/serving/run.py:
# run_bench_spec_decode :751-757, run_bench_serving :818-826), full width
# and depth: a 0.16 B-param Llama (bf16 params from seed 0), 8 slots, 160
# blocks of 16; the speculative leg's self-draft is 2 of the 8 layers
# proposing 3 tokens a step. Workloads: build_workload's arguments.
SERVE_BENCH_KW = dict(vocab_size=32000, dim=1024, n_layers=8, n_heads=16, n_kv_heads=8,
                      max_seq_len=512)
SERVE_ENGINE_KW = dict(num_blocks=160, block_size=16, max_slots=8)
SPEC_TOKENS, SPEC_DRAFT_LAYERS = 3, 2
SPEC_WORKLOAD = (12, 0, (16, 96), (16, 64), 2.0)
STATIC_WORKLOAD = (32, 0, (16, 96), (8, 64), 2.0)
SAMPLING_LEGS = (dict(temperature=0.8, top_k=20), dict(temperature=0.8, top_p=0.9))
SPEC_F32_REQUESTS = 4
# Speculative vs plain leg, bf16: at a position whose prefix the two legs
# share, each selected its token from a logit row of the same model on the
# same tokens, the plain leg through S=1 GEMMs and the decode kernel, the
# speculative one through the S=4 verify GEMMs and the prefill kernel. The
# rows differ by rounding only: each bf16 op rounds at 2**-9 relative, a
# difference that grows through 8 residual layers to a few parts in 10**3
# of the hidden state, and the head's bf16 output rounds to steps of 2**-6
# for logits between 2 and 4 — so a few hundredths at most. A wrong position, key or fold
# index gives another row altogether, which differs by ~1 or more (the
# logits' spread; the check against the plain row one position on must
# exceed the bar, or the bar is too loose). Greedy ties closer than the
# rounding can flip a token, after which the streams part: the first
# divergence is printed with the plain row's top-2 gap.
SPEC_LOGIT_BAR = 0.25
# the same legs in f32 (params and cache): rows differ by f32 summation
# order only (~1e-5), so the streams must match unless the top two logits
# at a divergence lie closer than this
SPEC_F32_TIE_GAP = 1e-4
# More than one process (ROADMAP.md Queue A item 6). phase_fsdp_lm runs
# config #4 through a mesh of the running process group (one card: world
# size 1, every axis of size 1, so the plain step) and must give
# phase_lm774m's losses: the same kernels on the same inputs, which may
# differ only where a kernel's summation order is not fixed (1e-6).
FSDP_LM_RTOL = 1e-6
# phase_mesh_2rank: two processes on the one card over gloo (NCCL refuses
# two ranks on one GPU), at the long-context widths (bench.py:936-938;
# vocab 32000, which tp=2 splits, unlike config #4's 50257) cut to 4 layers
# and S=2048, global batch 2, f32 masters, adamw, flash; 3 steps a leg
# against a one-process run of the same steps: losses and each step's
# global gradient norm within 1e-5 relative (f32, the gradient sums and the
# batch rows' GEMMs in another order), each leaf's 3-step update within
# TRAIN_UPDATE_RTOL relative L2 (AdamW turns the rounding noise of
# near-zero gradient elements into parts of lr). AdamW's normalised step
# hides a gradient off by a constant factor from the losses and the
# updates; the norm sees it. Two planted faults, each on a copy of one leg,
# must fail at least one bar: the tp-split params' gradients summed over
# tp (2x), and the summed gradients not divided by the batch ranks (2x).
MESH_2RANK_KW = dict(LLAMA_KW, n_layers=4, max_seq_len=2048)
MESH_2RANK_BATCH, MESH_2RANK_STEPS, MESH_2RANK_LR = 2, 3, 1e-4
MESH_2RANK_LEGS = (  # (name, ParallelismConfig kwargs, ZeRO-1, llama_tp_rules, options)
    ("dp_shard2", {"dp_shard_size": 2}, False, False, {}),
    ("tp2", {"tp_size": 2}, False, True, {}),
    ("dp_replicate2_zero1", {"dp_replicate_size": 2}, True, False, {}),
    # ZeRO-1 by annotation (the fused update turned off): each rank owns half
    # the rows of every param's AdamW moments
    ("dp_replicate2_zero1_annotated", {"dp_replicate_size": 2}, True, False,
     {"env": {"ACCELERATE_ZERO1_FUSED": "0"}}),
    # fp16 loss scaling (held to a one-process fp16 run): a first step that
    # overflows, then growth every 2 finite steps
    ("dp_shard2_fp16", {"dp_shard_size": 2}, False, False, {"fp16": True}),
    # the models' own rules through prepare(..., shard_rules=llama_shard_rules()):
    # tp splits the heads' and the ffn's out or in dims, gathered per layer
    ("tp2_llama_shard_rules", {"tp_size": 2}, False, False, {"prepare_rules": True}),
    # adafactor(MESH_2RANK_LR) on dp_replicate 2, held to a one-process
    # adafactor run; then under ZeRO-1 (by annotation: the fused update
    # refuses adafactor), held to that leg
    ("dp_replicate2_adafactor", {"dp_replicate_size": 2}, False, False,
     {"factory": "adafactor", "ref": "adafactor"}),
    ("dp_replicate2_adafactor_zero1", {"dp_replicate_size": 2}, True, False,
     {"factory": "adafactor", "ref": "dp_replicate2_adafactor"}),
    # DistributedDataParallelKwargs(comm_hook="bf16"), held to one process
    # with the same hook
    ("dp_shard2_comm_bf16", {"dp_shard_size": 2}, False, False,
     {"comm_hook": "bf16", "ref": "comm_bf16"}),
    # the optimizer state of each rank's blocks on the host: bitwise dp_shard2
    ("dp_shard2_offload", {"dp_shard_size": 2}, False, False,
     {"offload": True, "ref": "dp_shard2"}),
    # the sequence split over cp 2 with the zig-zag ring (Accelerator.
    # context_parallel_attention) and llama_shard_rules; dp_shard -1 turns
    # FSDP on over (dp_shard, cp), here cp, so each layer's gather and
    # gradient reduce span the cp group. Every rank runs 5 flash blocks a
    # layer (2 causal half-blocks and 1 full at home, 2 full after the
    # rotation), forward and backward
    ("cp2_zigzag", {"cp_size": 2, "dp_shard_size": -1, "cp_rotate_method": "zigzag"}, False,
     False, {"prepare_rules": True, "attention": True, "flash_blocks": 5}),
    # Ulysses over sp 2: the plain attention on each rank's 8 of 16 heads over
    # the whole sequence, no flash launch
    ("sp2", {"sp_size": 2}, False, False, {"attention": True, "flash_blocks": 0}),
)
# the one-process runs the legs are held to (a leg's "ref" names one of
# these, or another leg): options of _mesh_2rank_leg
MESH_2RANK_REFS = {"f32": {}, "fp16": {"fp16": True}, "adafactor": {"factory": "adafactor"},
                   "comm_bf16": {"comm_hook": "bf16"}}
# adafactor under ZeRO-1 against adafactor on the same mesh without it: the
# same gradients, the statistics summed from the ranks' blocks (f32 sums in
# another order), so losses and gradient norms within 1e-5; adafactor
# divides by the root of its second moments, as AdamW does, so its 3-step
# updates are held to TRAIN_UPDATE_RTOL (a CPU rehearsal at 2 layers, dim
# 128, measured 1.5e-5 on layers/wv/kernel)
MESH_2RANK_ZERO1_ADAFACTOR_RTOL = 1e-5
MESH_2RANK_FAULTS = (("tp2_summed_over_tp", "tp2"), ("dp_shard2_not_divided", "dp_shard2"))
MESH_2RANK_LOSS_RTOL = MESH_2RANK_NORM_RTOL = 1e-5
# The fp16 leg: the flash kernels take bf16 and f32, so it runs the plain
# (einsum) attention, with no kernel; the scaler's scale 2**40 overflows
# fp16 by orders of magnitude and 2**10 lies far inside it, so the
# loss-scale and finite-flag sequences are decisions that must equal the
# one-process run's; the losses and updates are held to it at the fp16
# bars of phase_train_check_fp16 (TRAIN_FP16_RTOL, TRAIN_FP16_UPDATE_RTOL):
# one rank's GEMMs over one row round apart from one process's over two.
MESH_2RANK_FP16_SCALER = dict(init_scale=2.0 ** 40, growth_factor=2.0 ** 30,
                              backoff_factor=2.0 ** -30, growth_interval=2)
MESH_2RANK_TIMEOUT_S = 600
# phase_context_parallel: the attention alone at the long-context
# configuration's length and widths (bench.py:936-938: B=1, S=8192, 16/8
# heads, D=64, bf16), its sequence split over two processes sharing the card
# over gloo: the ring, zig-zag and all-gather over cp 2 and Ulysses over sp
# 2, forward and backward. Each rank's output and dq/dk/dv blocks are held
# to one process's flash_attention (#1-#3) on the whole sequence and to the
# plain attention (f32 math on the same bf16 inputs), both at
# FUSED_RTOL[bf16] (2**-6 of the largest value), the bar of the bf16 flash
# rows: each side rounds to bf16 once, the ring's blocks merge in f32. Each
# planted fault must break a bar: zig-zag's inverse exchange left out (the
# output) and the ring's k/v gradients not sent home (dk and dv).
CP_ATTN_SHAPE = (1, 8192, 16, 8, 64)  # B, S, H, Hkv, D
CP_ATTN_STRATEGIES = (("ring", {"cp_size": 2}), ("zigzag", {"cp_size": 2}),
                      ("allgather", {"cp_size": 2}), ("ulysses", {"sp_size": 2}))
CP_ATTN_FAULTS = (("zigzag_no_inverse_exchange", "zigzag"), ("ring_kv_grads_not_home", "ring"))
# flash calls of one attention call a rank (forward; the backward the same
# number of dq and dk/dv): the ring's rank 0 has its resident block only
# (rank 1's keys all follow its queries), rank 1 two; zig-zag 3 at home and
# 2 after the rotation on each; all-gather and Ulysses run plain attention
CP_ATTN_FLASH_CALLS = {"ring": (1, 2), "zigzag": (5, 5), "allgather": (0, 0), "ulysses": (0, 0)}
CP_ATTN_REPS = 3
CP_ATTN_TIMEOUT_S = 600
# The fp8 leg (dtype_recipe="fp8" under mixed_precision="fp8", dp_replicate 2
# with fused ZeRO-1, the meta as passthrough slots) against one process,
# sgd(1e-2). The first step runs on the same params and histories, held to
# MESH_2RANK_LOSS_RTOL; the meta after every step must be bitwise equal on
# both ranks. The compute is bf16, so each rank rounds its half of a
# weight gradient to bf16 before the sum over the ranks where one process
# rounds the whole sum once (the fp8 products' f32 sums split the same
# way), and the updated params part by an ulp, which later fp8 casts may
# carry: later steps are held to 1e-3 (measured on an H100: 1.18e-4 and
# 1.4e-5 at steps 2 and 3 with SGD, 1.9e-5 and 1.2e-4 with AdamW).
MESH_2RANK_FP8_LR, MESH_2RANK_FP8_RTOL = 1e-2, 1e-3
MESH_OPS_GATHER_MB = 64
# phase_mesh_lm774m: config #4 (LM774M_KW, its recipe: bf16 params,
# adafactor(1e-4), remat "dots_no_batch", flash) at full width, its depth
# cut to MESH_LM_LAYERS of 36 to keep the script's time (see MOE_EP_LAYERS),
# under ParallelismConfig(dp_shard_size=2): two processes on the one card
# over gloo, 4 rows a rank of the global batch of 8, 3 steps, the
# stacked layers gathered one at a time (FSDP splits the layer axis: each
# rank holds half the layers, and a gather is a broadcast from the owner).
# Held to a one-process run of the same steps at the same depth. Bars, bf16, set from a CPU run of these
# legs at cut widths (6 layers, dim 256, vocab 1003, S=128, batch 8) before
# the first run on the card: the losses differed by 3.5e-5 relative at
# most (each rank's bf16 GEMMs over its rows, the gradients summed in bf16
# over the ranks): bar 1e-3. The one-process step reports its gradient
# norm from a bf16 sum (a bf16 value, 2**-8 apart), the sharded step from
# f32 sums: 3.4e-3 apart; bar 8e-3 (two bf16 steps). Each layer's gradient
# norm in the first step (this rank's whole layers, divided by the 2
# batch ranks the step sums over) against one process's: bf16 gradients
# summed in another order, bar 2e-2. On an H100 the sound leg measured
# 3.2e-5, 3.4e-3 and 2.7e-4. Two planted faults must fail
# a bar: layer 0's gradient not summed over dp_shard, and layer i computed
# with layer i+1's prefetched params (layer 0 then has no gradient). Peak
# a rank under 0.75 of the one-process run's (at 36 layers it measured
# 0.535 of phase_lm774m's 8.10 GiB, at 12 0.550 of 4.56 GiB). Cut from 12
# to 8 layers in PR 20 for the script's clock (see MESH_DECODE_LAYERS).
MESH_LM_LAYERS = 8
MESH_LM_STEPS = 3
MESH_LM_LOSS_RTOL, MESH_LM_NORM_RTOL, MESH_LM_LAYER_NORM_RTOL = 1e-3, 8e-3, 2e-2
MESH_LM_PEAK_SHARE = 0.75
MESH_LM_FAULTS = ("layer_grads_not_summed", "next_layer_params")
# phase_moe_ep: phase_moe's model (MOE_KW) and training recipe (4 x 512,
# bf16 params, adafactor, remat "dots_no_batch", flash) under
# ParallelismConfig(ep_size=2) with moe_shard_rules: 2 steps held to
# phase_moe's one-process steps. The ranks of the ep group route the same
# rows alike and each computes 4 of the 8 experts; the combine sums over
# ep. Bars, bf16: losses within 1e-5 relative (the expert GEMMs are the
# same products, and a bf16 sum over ep of one rank's term and the other's
# zero is exact: an H100 measured 0.0 at both steps; the whole change of
# the loss over the 2 steps is 9.4e-4 relative, so a step that updates
# nothing or takes a wrong gradient misses the bar); each step's gradient
# norm within MESH_LM_NORM_RTOL (the one-process step reports a bf16 sum,
# the sharded step f32 sums, as in phase_mesh_lm774m); the first forward's
# aux loss within 1e-5 relative of one process's and its dropped
# token-choices equal (the router runs the same f32 product on the same
# rows). The planted fault (the expert input's gradient not summed over
# ep: each rank's tokens see only its own experts' part) must fail a bar.
# The training legs run MOE_EP_LAYERS of the model's 16 layers, to keep the
# script's time (at all 16 the one-process steps equalled phase_moe's loop
# bitwise); the greedy leg below runs all 16. The margin of the two cuts:
# the script is to finish in half its 1200 s limit where it can, and the
# same code has taken up to 1.30 times as long on one host as on another
# (624.4 and 810.0 s on an H100 80GB HBM3 at 700 W); uncut, it took 921 s,
# which a slow host would take to ~1200 s. The cuts took ~100 s off
# (phase_mesh_lm774m 65.9 -> 33-35 s, phase_moe_ep 113.3 -> 39-49 s), and
# the cut script took 625.5-721.7 s: ~810-940 s on the slowest host seen.
# Cut from 4 to 2 layers (one a rank) in PR 20 (see MESH_DECODE_LAYERS).
MOE_EP_LAYERS = 2
MOE_EP_STEPS = 2
MOE_EP_LOSS_RTOL, MOE_EP_AUX_RTOL = 1e-5, 1e-5
MOE_EP_FAULTS = ("expert_input_grad_not_summed",)
# ... and in the same launch, phase_moe's greedy decode (8 x 128 prompt
# tokens, GEN_SHORT_NEW new, bf16) under ep 2 with llama_shard_rules (each
# rank computes its 4 experts; the combine sums over ep): tokens equal to
# phase_moe's one-process greedy of the same length (the expert products
# are the same products, and the sum of one rank's term and the other's
# zero is exact).
# phase_mesh_decode: config #5 (CONFIG_KW) at full width (MESH_DECODE_LAYERS deep) under
# ParallelismConfig(tp_size=2), two processes on the one card over gloo,
# params placed by shard_params(rules=llama_shard_rules()) (each rank its
# 16 of 32 q heads and 4 of 8 kv heads, half of every ffn product and
# half the vocab). Greedy 8 x 128 + 64 in f32, held to a one-process f32
# run: the f32 sums part in order only (each wo/w2 product is two partial
# sums added), so a token may differ only at a near-tie: every sharded
# token lies within MESH_DECODE_TIE of the one-process f32 argmax over the
# sharded run's own rows, and the tokens equal to one process are counted.
# The engine's 9 requests of _engine_prompts, in bf16 and in f32: the f32
# streams held to the one-process f32 engine by the same rule; #6 and #7
# must launch on each rank (16 q over 4 kv heads); a rank holds half the
# pool and at most MESH_DECODE_PARAM_SHARE of the params. The planted
# fault (no sum over tp after wo) must fail the token bar.
MESH_DECODE_TIE = 1e-3
MESH_DECODE_PARAM_SHARE = 0.55
# depth cut to 8 of config #5's 16 layers for the script's clock
# (the whole script took 1084.5 s on a slow host): every check is per layer.
# Cut to 4 in PR 20, with MESH_LM_LAYERS 12 -> 8 and MOE_EP_LAYERS 4 -> 2:
# with phase_fleet the whole script took 1190.7 s on a host 1.2-1.9x
# slower a phase than the one of its 743.4 s, at the 1200 s limit.
MESH_DECODE_LAYERS = 4
MESH_DECODE_FAULT_NEW = 8


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, n_copies: int, iters: int, behind_sleep: bool = True) -> float:
    """Device ms per call over ``iters`` calls cycling through ``n_copies``
    input copies (together larger than the 50 MB L2, so each call finds
    its inputs cold, as a layer of the model does), by CUDA events.

    The calls are queued behind a device-side sleep that outlasts the host's
    time to queue them, so the events time the device's work and not the
    Python cost of each call; a sleep that proves too short is doubled. A
    function that queues more launches than the device's launch queue holds
    (the blocked plain flash versions queue thousands) would block the host
    on the full queue behind the sleep: ``behind_sleep=False`` times it
    between two events with no sleep, so a host slower than the device
    would show in its time."""
    t0 = time.perf_counter()
    for i in range(n_copies):
        fn(i)
    torch.cuda.synchronize()
    if not behind_sleep:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for it in range(iters):
            fn(it % n_copies)
        ev[1].record()
        torch.cuda.synchronize()
        return ev[0].elapsed_time(ev[1]) / iters
    host_s = (time.perf_counter() - t0) / n_copies * iters
    cycles = int(2e9 * 1.5 * host_s) + 1_000_000
    for _ in range(6):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for it in range(iters):
            fn(it % n_copies)
        queued_s = time.perf_counter() - t0
        ev[2].record()
        torch.cuda.synchronize()
        if ev[0].elapsed_time(ev[1]) > 1e3 * queued_s:
            return ev[1].elapsed_time(ev[2]) / iters
        cycles *= 2
    raise SmokeFailure("could not queue the timed calls behind the device sleep")


def _native_collate():
    """The native pipeline's ``parallel_collate`` against ``np.stack`` on
    phase_train's batches (32 samples of 128 int32 ids, below the C++
    team's 1 MiB threshold: one thread) and on 64 samples of 1 MiB (the
    thread team): the same bytes, host ms of each (best of 5)."""
    from accelerate_tpu_torch import native
    from accelerate_tpu_torch.utils.synthetic import make_synthetic_mrpc

    data = make_synthetic_mrpc(TRAIN_BATCH, TRAIN_SEQ, 30522, seed=0)
    rng = np.random.default_rng(0)
    cases = {"phase_train batch": [data["input_ids"][i] for i in range(TRAIN_BATCH)],
             "64 x 1 MiB": [rng.integers(0, 2**31, (1 << 18,), dtype=np.int32)
                            for _ in range(64)]}
    for name, samples in cases.items():
        times = {}
        for label, fn in (("parallel_collate", native.parallel_collate), ("np.stack", np.stack)):
            best = math.inf
            for _ in range(5):
                t0 = time.perf_counter()
                out = fn(samples)
                best = min(best, time.perf_counter() - t0)
            times[label] = (best * 1e3, out)
        same = times["parallel_collate"][1].tobytes() == times["np.stack"][1].tobytes()
        print(f"[build] native collate, {name} ({times['np.stack'][1].nbytes / 2**20:.3f} MiB): "
              f"parallel_collate {times['parallel_collate'][0]:.4f} ms, np.stack "
              f"{times['np.stack'][0]:.4f} ms; bytes equal {same}")
        check(same, f"parallel_collate of {name} does not give np.stack's bytes")


# Libraries whose bf16 products must run on tensor cores: each must hold
# warpgroup MMA (HGMMA) instructions in its SASS.
TENSOR_CORE_LIBS = ("flash_fwd", "flash_dq", "flash_dkdv", "fused_attention_fwd",
                    "fused_attention_bwd", "paged_prefill")


def phase_build():
    """The CUDA kernels (``nvcc``) and, beside them, the native host
    pipeline (``g++``); see :func:`_native_collate` for the latter's check."""
    import threading

    from accelerate_tpu_torch.ops import _build

    t0 = time.perf_counter()
    host = {}
    thread = threading.Thread(target=lambda: host.update(_build.build_host("pipeline")))
    thread.start()  # the host compiler runs beside the nvcc processes
    built = _build.build()
    thread.join()
    check("path" in host, "the native pipeline library did not build")
    print(f"[build] {len(built)} kernel libraries and the native pipeline in "
          f"{time.perf_counter() - t0:.2f} s (pipeline: {host['path'].name}, g++ "
          f"{host['seconds']:.2f} s)")
    _native_collate()
    spilled = []
    for name, info in built.items():
        print(f"[build] {name}: {info['path'].name} nvcc {info['seconds']:.2f} s")
        entry = ""
        for line in info["ptxas"].splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
                entry = entry[: entry.find("EEv") + 2] if "EEv" in entry else entry
            elif "registers" in line or "spill" in line:
                detail = line.split(":")[-1].strip()
                print(f"[build]   {entry}: {detail}")
                spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", detail)
                if (("_tc_kernel" in entry or name == "paged_decode") and spills
                        and spills.groups() != ("0", "0")):
                    spilled.append(f"{name} {entry}: {detail}")
    check(not spilled, "kernels spill registers: " + "; ".join(spilled))
    # the SASS, read with the cuobjdump of nvcc's own toolkit
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    check(os.path.isfile(cuobjdump), f"cuobjdump not found beside nvcc ({cuobjdump})")
    for name in TENSOR_CORE_LIBS:
        sass = subprocess.run([cuobjdump, "-sass", str(built[name]["path"])], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        counts = {op: sum(1 for line in sass.splitlines() if f" {op}." in line or f" {op} " in line)
                  for op in ("HGMMA", "HMMA", "FFMA")}
        print(f"[build] {name} SASS: {counts['HGMMA']} HGMMA, {counts['HMMA']} HMMA, "
              f"{counts['FFMA']} FFMA instructions")
        check(counts["HGMMA"] > 0, f"{name}: no HGMMA instruction in its SASS: its bf16 products "
                                   f"do not run on the tensor cores")


def _scrambled_tables(rng, B, W, need, nb):
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((B, W), np.int32)
    used = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[used : used + n]
        used += n
    return tables


# Decode cases: (table width W, kv_lens); an inactive slot (length 1 on an
# all-null table row) is marked by a negative length. H=32, Hkv=8, D=64,
# bs=16 as in serving.
DECODE_CASES = {
    "decode": (16, [1, 17, 100, 129, 200, 255, 256, -1]),
    "decode_long": (32, [37, 130, 256, 300, 364, 420, 480, 512]),  # up to max_seq_len
    "decode_b1": (32, [512]),  # a single request
    # a draft step of the serving bench's model (16/8 heads): 8 slots, the
    # widest table of its lattice (11 blocks), two padded slots
    "draft": (11, [5, 33, 64, 97, 120, 163, -1, -1]),
    # a decode step of config #5 on one rank under tp 2 (16 q over 4 kv heads)
    "decode_tp": (16, [1, 17, 100, 129, 200, 255, 256, -1]),
}
# the speculative verify step of the same model: 8 slot rows of k+1 = 4
# queries from their own positions (-1: a padded row on the null block,
# positions 0-3) over an 11-entry table
VERIFY_STARTS = [0, 15, 16, 47, 100, 159, -1, -1]
# q heads, kv heads of a case (default: the Llama-1B class, 32/8)
CASE_HEADS = {"draft": (16, 8), "verify": (16, 8), "decode_tp": (16, 4), "prefill_tp": (16, 4)}
# The paged kernel cases' seeds, by name (bf16 takes the seed, f32 the
# next), so that adding a case leaves every other case's inputs as they were.
KERNEL_CASE_SEEDS = {"decode": 0, "prefill128": 2, "prefill256": 4, "decode_long": 6,
                     "decode_b1": 8, "draft": 10, "verify": 12, "decode_tp": 14, "prefill_tp": 16}


def _kernel_case(kind, dtype, dev, seed):
    """Inputs at the serving path's shapes: the DECODE_CASES (D=64, bs=16)
    with ragged lengths; prefill B=1 at S=128 / S=256 against a W=32 table
    whose earlier KV has landed; the verify step's B=8, S=4, W=11."""
    rng = np.random.default_rng(seed)
    (H, Hkv), D, bs = CASE_HEADS.get(kind, (32, 8)), 64, 16
    if kind == "verify":
        B, W, S = len(VERIFY_STARTS), 11, 4
        starts = np.maximum(np.array(VERIFY_STARTS, np.int32), 0)
        qpos = starts[:, None] + np.arange(S, dtype=np.int32)[None]
        need = [0 if s < 0 else -(-(s + S) // bs) for s in VERIFY_STARTS]
    elif kind in DECODE_CASES:
        W, spec = DECODE_CASES[kind]
        B, S = len(spec), 1
        lens = np.abs(np.array(spec, np.int32))
        # an inactive slot: every entry the null block
        need = [0 if n < 0 else -(-n // bs) for n in spec]
        qpos = (lens - 1)[:, None]
    else:
        B, W = 1, 32
        S, start = {"prefill128": (128, 160), "prefill256": (256, 200),
                    "prefill_tp": (128, 160)}[kind]
        qpos = (start + np.arange(S, dtype=np.int32))[None]
        need = [-(-(start + S) // bs)]
    nb = sum(need) + 1
    tables = _scrambled_tables(rng, B, W, need, nb)
    q = torch.from_numpy(rng.standard_normal((B, S, H, D)).astype(np.float32)).to(dev, dtype)
    pool_bytes = 2 * nb * bs * Hkv * D * torch.tensor([], dtype=dtype).element_size()
    n_copies = max(1, math.ceil(128e6 / pool_bytes))
    pools = [tuple(torch.randn(nb, bs, Hkv, D, device=dev).to(dtype) for _ in range(2))
             for _ in range(n_copies)]
    return dict(q=q, pools=pools, tables=torch.from_numpy(tables).to(dev),
                qpos=torch.from_numpy(np.ascontiguousarray(qpos, np.int32)).to(dev),
                B=B, S=S, H=H, Hkv=Hkv, D=D, bs=bs, W=W)


def _bound(case, dtype):
    """Least time for the work these inputs need: bytes (q, out, tables,
    positions, the live KV up to each row's last attended position) over
    HBM rate vs 4*D flops per attended key per head over the type's peak."""
    elt = torch.tensor([], dtype=dtype).element_size()
    qpos = case["qpos"].cpu().numpy().astype(np.int64)
    live = int(np.sum(qpos.max(axis=1) + 1))
    attended = int(np.sum(qpos + 1))
    B, S, H, Hkv, D, W = (case[k] for k in ("B", "S", "H", "Hkv", "D", "W"))
    nbytes = 2 * B * S * H * D * elt + 2 * live * Hkv * D * elt + 4 * (B * W + qpos.size)
    flops = 4 * D * H * attended
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _decode_poison_check(dev):
    """Table entries past each row's live blocks point at a block of NaN:
    the decode kernel's output must be bitwise that of the same table with
    those entries on the (finite) null block — it reads no entry past a
    row's kv_len."""
    fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
    for kind in ("decode", "decode_long"):
        for dtype in (torch.bfloat16, torch.float32):
            case = _kernel_case(kind, dtype, dev, seed=77)
            q, (k, v), tables, bs = case["q"], case["pools"][0], case["tables"], case["bs"]
            lens = (case["qpos"][:, 0] + 1).to(torch.int32)
            nan_block = k.shape[0]
            k = torch.cat([k, torch.full_like(k[:1], float("nan"))])
            v = torch.cat([v, torch.full_like(v[:1], float("nan"))])
            poisoned = tables.clone()
            live = [-(-int(n) // bs) for n in lens.tolist()]
            for b, n in enumerate(live):
                poisoned[b, n:] = nan_block
            check(int((poisoned == nan_block).sum()) > 0, f"{kind}: no entry to poison")
            out = fa.paged_attention_decode(q, k, v, tables, lens)
            out_bad = fa.paged_attention_decode(q, k, v, poisoned, lens)
            torch.cuda.synchronize()
            ref = fa.paged_attention_decode_plain(q, k, v, tables, lens)
            err = float((out.float() - ref.float()).abs().max())
            check(bool(torch.isfinite(out_bad.float()).all()) and torch.equal(out_bad, out),
                  f"{kind} {dtype}: NaN in table entries past kv_len changed the decode output")
            check(err <= KERNEL_ATOL[dtype], f"{kind} {dtype}: poison case err {err}")
            print(f"[kernels] {kind} {dtype}: {int((poisoned == nan_block).sum())} table entries "
                  f"past kv_len on a NaN block: output bitwise unchanged (err vs plain {err:.3e})")


def phase_decode_splits(dev):
    """The decode kernel at each keys-per-split C the wrapper can pick, on
    the DECODE_CASES in bf16: each checked against the plain version and
    timed, beside the C the wrapper's shape rule picks on this card."""
    fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
    rule = fa._decode_split_keys
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for kind in DECODE_CASES:
        case = _kernel_case(kind, torch.bfloat16, dev, seed=5)
        q, pools, tables = case["q"], case["pools"], case["tables"]
        lens = (case["qpos"][:, 0] + 1).to(torch.int32)
        ref = fa.paged_attention_decode_plain(q, *pools[0], tables, lens)
        times = {}
        for c in fa._DECODE_SPLIT_KEYS:
            fa._decode_split_keys = lambda *args, c=c: c
            try:
                out = fa.paged_attention_decode(q, *pools[0], tables, lens)
                torch.cuda.synchronize()
                err = float((out.float() - ref.float()).abs().max())
                check(err <= KERNEL_ATOL[torch.bfloat16], f"{kind} split {c}: err {err}")
                times[c] = time_ms(lambda i: fa.paged_attention_decode(q, *pools[i], tables, lens),
                                   len(pools), 32)
            finally:
                fa._decode_split_keys = rule
        picked = rule(case["B"], case["Hkv"], case["W"] * case["bs"], n_sms)
        print(f"[splits] {kind:11s} bf16 B={case['B']} keys={case['W'] * case['bs']}: "
              + ", ".join(f"C={c} {t:.4f} ms" for c, t in times.items())
              + f"; the wrapper picks C={picked} ({n_sms} SMs)")


def phase_kernels(dev):
    fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
    from accelerate_tpu_torch.serving.kv_pager import gather_blocks

    sdpa = torch.nn.functional.scaled_dot_product_attention
    results = {}
    for kind in (*DECODE_CASES, "prefill128", "prefill256", "verify", "prefill_tp"):
        for dtype in (torch.bfloat16, torch.float32):
            seed = KERNEL_CASE_SEEDS[kind] + (dtype == torch.float32)
            case = _kernel_case(kind, dtype, dev, seed)
            q, pools, tables, qpos = case["q"], case["pools"], case["tables"], case["qpos"]
            if kind in DECODE_CASES:
                lens = (qpos[:, 0] + 1).to(torch.int32)
                kernel = lambda i: fa.paged_attention_decode(q, *pools[i], tables, lens)  # noqa: E731
                plain = lambda i: fa.paged_attention_decode_plain(q, *pools[i], tables, lens)  # noqa: E731
            else:
                kernel = lambda i: fa.paged_attention_prefill(q, *pools[i], tables, qpos)  # noqa: E731
                plain = lambda i: fa.paged_attention_prefill_plain(q, *pools[i], tables, qpos)  # noqa: E731
            out = kernel(0)
            torch.cuda.synchronize()
            ref = plain(0)
            err = float((out.float() - ref.float()).abs().max())
            check(bool(torch.isfinite(out.float()).all()), f"{kind} {dtype}: non-finite output")
            check(err <= KERNEL_ATOL[dtype],
                  f"{kind} {dtype}: kernel vs plain max abs err {err} > {KERNEL_ATOL[dtype]}")
            # the yardstick: one SDPA call on KV gathered ahead of time
            T = case["W"] * case["bs"]
            gathered = [tuple(gather_blocks(p, tables).transpose(1, 2).contiguous() for p in kv)
                        for kv in pools]
            mask = (torch.arange(T, device=dev)[None, None, :] <= qpos[:, :, None])[:, None]
            qt = q.transpose(1, 2)
            library = lambda i: sdpa(qt, *gathered[i], attn_mask=mask, enable_gqa=True)  # noqa: E731
            lib_err = float((library(0).transpose(1, 2).float() - ref.float()).abs().max())
            n, iters = len(pools), 32  # bounded: the plain version queues ~15 launches a call
            rec = dict(max_abs_err=err, ms=time_ms(kernel, n, iters),
                       plain_ms=time_ms(plain, n, iters), library_ms=time_ms(library, n, iters))
            rec["bound_ms"], rec["bound_by"] = _bound(case, dtype)
            results[(kind, dtype)] = rec
            print(f"[kernels] {kind:10s} {str(dtype):15s} err {err:.3e} (tol "
                  f"{KERNEL_ATOL[dtype]:.1e}; sdpa err {lib_err:.3e}) kernel {rec['ms']:.4f} ms "
                  f"plain {rec['plain_ms']:.4f} ms sdpa {rec['library_ms']:.4f} ms "
                  f"bound {rec['bound_ms']:.5f} ms ({rec['bound_by']})")
            del gathered, pools
    _decode_poison_check(dev)
    return results


def _fused_inputs(name, dtype, dev, seed):
    """Inputs of one fused case: q, k, v, dO from a seed; padded rows of
    different lengths (the first full) as segment ids 1 / 0."""
    B, S, H, Hkv, D, causal, padded = FUSED_CASES[name]
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)

    seg = None
    if padded:
        lens = rng.integers(S // 4, S + 1, B)
        lens[0] = S
        seg = torch.from_numpy((np.arange(S)[None] < lens[:, None]).astype(np.int32)).to(dev)
    return t(B, S, H, D), t(B, S, Hkv, D), t(B, S, Hkv, D), t(B, S, H, D), seg


def _fused_bound(name, dtype, seg, backward):
    """Least time for one call: bytes (each input read once, each output
    written once) over HBM rate vs the products' flops on the attended
    (query, key) pairs of these inputs over the type's peak. Forward: q, k,
    v in, o and lse out, 2 products (4·D flops a pair and head). Backward:
    q, k, v, o, dO, lse in, dq, dk, dv out, 5 products (10·D)."""
    B, S, H, Hkv, D, causal, _ = FUSED_CASES[name]
    elt = torch.tensor([], dtype=dtype).element_size()
    allow = torch.ones(B, S, S, dtype=torch.bool)
    if seg is not None:
        s = seg.cpu()
        allow &= s[:, :, None] == s[:, None, :]
    if causal:
        allow &= torch.ones(S, S, dtype=torch.bool).tril()
    pairs = int(allow.sum())
    n_q, n_kv = B * S * H * D, B * S * Hkv * D
    small = 4 * B * H * S + (0 if seg is None else 4 * B * S)  # lse, segment ids
    mult = 2 if backward else 1
    nbytes = mult * (2 * n_q + 2 * n_kv) * elt + small
    flops = (10 if backward else 4) * D * H * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _errs(pairs):
    """(max abs error, max error relative to max(1, largest |want|)) over
    (got, want) pairs."""
    abs_errs, rel_errs = [], []
    for got, want in pairs:
        err = float((got.float() - want.float()).abs().max())
        abs_errs.append(err)
        rel_errs.append(err / max(1.0, float(want.float().abs().max())))
    return max(abs_errs), max(rel_errs)


def phase_fused_kernels(dev):
    """Kernels #4 and #5 against their plain versions (out, lse; dq, dk,
    dv), with kernel, plain, bound and SDPA times. The yardstick for #4 is
    one ``scaled_dot_product_attention`` call with the boolean mask; for #5,
    ``torch.autograd.grad`` through that call less the call itself."""
    fa = importlib.import_module("accelerate_tpu_torch.ops.fused_attention")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results = {}

    def rows(name, dtype, seed):
        B, S, H, Hkv, D, causal, _ = FUSED_CASES[name]
        scale = 1.0 / math.sqrt(D)
        q, k, v, do, seg = _fused_inputs(name, dtype, dev, seed=seed)
        out, lse = fa.fused_attention_fwd(q, k, v, seg, scale, causal)
        grads = fa.fused_attention_bwd(q, k, v, seg, lse, out, do, scale, causal)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.fused_attention_fwd_reference(q, k, v, seg, scale, causal)
        ref_grads = fa.fused_attention_bwd_reference(q, k, v, seg, lse, out, do, scale, causal)
        errs = {"fwd": _errs([(out, ref_out), (lse, ref_lse)]),
                "bwd": _errs(zip(grads, ref_grads))}
        for x in (out, lse, *grads):
            check(bool(torch.isfinite(x.float()).all()), f"fused {name} {dtype}: non-finite")
        for kind, (_, rel) in errs.items():
            check(rel <= FUSED_RTOL[dtype],
                  f"fused {kind} {name} {dtype}: rel err {rel} > {FUSED_RTOL[dtype]}")

        # copies of the inputs, together past the 50 MB L2, so each
        # timed call finds its inputs cold as a model layer does
        per_copy = 6 * q.numel() * q.element_size()
        n = max(1, math.ceil(128e6 / per_copy))
        copies = [tuple(x.clone() for x in (q, k, v, do)) for _ in range(n)]
        saved = [fa.fused_attention_fwd(c[0], c[1], c[2], seg, scale, causal)[::-1]
                 for c in copies]  # (lse, out), in the backward's argument order
        mask = torch.ones(B, 1, S, S, dtype=torch.bool, device=dev)
        if seg is not None:
            mask &= (seg[:, :, None] == seg[:, None, :])[:, None]
        if causal:
            mask &= torch.ones(S, S, dtype=torch.bool, device=dev).tril()
        leaves = [tuple(x.transpose(1, 2).detach().requires_grad_(True) for x in c[:3])
                  for c in copies]
        dos = [c[3].transpose(1, 2) for c in copies]

        def library_fwd(i):
            return sdpa(*leaves[i], attn_mask=mask, enable_gqa=Hkv != H)

        def library_fwd_bwd(i):
            return torch.autograd.grad(library_fwd(i), leaves[i], dos[i])

        fwd = {
            "ms": lambda i: fa.fused_attention_fwd(*copies[i][:3], seg, scale, causal),
            "plain_ms": lambda i: fa.fused_attention_fwd_reference(*copies[i][:3], seg,
                                                                   scale, causal),
            "library_ms": library_fwd,
        }
        bwd = {
            "ms": lambda i: fa.fused_attention_bwd(*copies[i][:3], seg, *saved[i],
                                                   copies[i][3], scale, causal),
            "plain_ms": lambda i: fa.fused_attention_bwd_reference(
                *copies[i][:3], seg, *saved[i], copies[i][3], scale, causal),
            "library_ms": library_fwd_bwd,
        }
        iters = 16
        for kind, fns in (("fwd", fwd), ("bwd", bwd)):
            rec = {key: time_ms(fn, n, iters) for key, fn in fns.items()}
            rec["max_abs_err"], rec["rel_err"] = errs[kind]
            rec["bound_ms"], rec["bound_by"] = _fused_bound(name, dtype, seg, kind == "bwd")
            results[(name, kind, dtype)] = rec
        # the library's backward alone: its forward and backward less its forward
        bwd_rec = results[(name, "bwd", dtype)]
        bwd_rec["library_ms"] -= results[(name, "fwd", dtype)]["library_ms"]
        for kind in ("fwd", "bwd"):
            rec = results[(name, kind, dtype)]
            print(f"[fused] {kind} {name:10s} {str(dtype):15s} err {rec['max_abs_err']:.3e} "
                  f"(rel {rec['rel_err']:.3e}, tol {FUSED_RTOL[dtype]:.1e}) kernel "
                  f"{rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms sdpa "
                  f"{rec['library_ms']:.4f} ms bound {rec['bound_ms']:.5f} ms "
                  f"({rec['bound_by']})")
        del copies, saved, leaves, dos

    for name in FUSED_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            rows(name, dtype, len(results))
    for name in FUSED_CASES:  # after the others: their inputs (seeds) stay as they were
        rows(name, torch.float16, len(results))
    _fp16_overflow_check(dev)
    return results


def _fp16_overflow_check(dev):
    """dO scaled as a loss scale scales it (kept inside fp16's range) until
    ds = p (dp - δ) passes fp16's range, at the BERT and causal GQA shapes:
    each of dq, dk and dv must be non-finite in kernel #5 exactly where it
    is in the plain version (element by element), so the loss scaler sees
    every overflow."""
    fa = importlib.import_module("accelerate_tpu_torch.ops.fused_attention")
    for name in ("bert", "gqa_causal"):
        B, S, H, Hkv, D, causal, _ = FUSED_CASES[name]
        q, k, v, do, seg = _fused_inputs(name, torch.float16, dev, seed=50)
        scale = 1.0 / math.sqrt(D)
        out, lse = fa.fused_attention_fwd(q, k, v, seg, scale, causal)
        for mul in (1.0, 3e4):
            dd = (do.float() * mul).clamp(-6e4, 6e4).half()
            got = fa.fused_attention_bwd(q, k, v, seg, lse, out, dd, scale, causal)
            want = fa.fused_attention_bwd_reference(q, k, v, seg, lse, out, dd, scale, causal)
            torch.cuda.synchronize()
            counts = [(int((~torch.isfinite(a)).sum()), int((~torch.isfinite(b)).sum()))
                      for a, b in zip(got, want)]
            same = all(torch.equal(torch.isfinite(a), torch.isfinite(b))
                       for a, b in zip(got, want))
            print(f"[fused-overflow] {name} fp16 dO x {mul:g}: non-finite (kernel, plain) "
                  f"dq {counts[0]} dk {counts[1]} dv {counts[2]}; same elements: {same}")
            check(same, f"fp16 overflow {name} x{mul:g}: kernel and plain non-finite "
                        f"elements differ: {counts}")
            if mul == 1.0:
                check(counts[0][0] == 0, f"fp16 overflow {name}: unscaled dO overflowed")
            else:
                check(counts[0][0] > 0, f"fp16 overflow {name}: dO x {mul:g} did not overflow ds")


def _engine_prompts(config):
    """phase_engine's request set: 8 prompts of 128 tokens, two sharing a
    64-token prefix, and one of 300 (two chunks: 256 + 44); 64 new each."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, config.vocab_size, 128) for _ in range(8)]
    prompts[1][:64] = prompts[0][:64]
    prompts.append(rng.integers(0, config.vocab_size, 300))
    return prompts


ENGINE_NEW = 64


def phase_engine(params, config, dev, tag="engine"):
    fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
    from accelerate_tpu_torch.serving import RequestStatus, ServingEngine

    warm = ServingEngine(params, config, **ENGINE_KW)
    warm.submit(np.arange(40), 4)
    warm.run()
    del warm

    engine = ServingEngine(params, config, **ENGINE_KW)
    reqs = [engine.submit(p, ENGINE_NEW) for p in _engine_prompts(config)]
    fa.paged_attention_decode.launches = 0
    fa.paged_attention_prefill.launches = 0
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"paged_attention_decode": fa.paged_attention_decode.launches,
                "paged_attention_prefill": fa.paged_attention_prefill.launches}
    stats = engine.stats()
    for r in reqs:
        check(r.status is RequestStatus.FINISHED, f"[{tag}] request {r.rid} ended {r.status}")
        check(len(r.generated) == ENGINE_NEW, f"request {r.rid} made {len(r.generated)} tokens")
        check(all(0 <= t < config.vocab_size for t in r.generated), "token outside the vocab")
    check(stats["prefix_cached_tokens"] >= 64, f"no prefix hit: {stats}")
    check(launches["paged_attention_prefill"] == config.n_layers * stats["prefill_chunks"] > 0,
          f"prefill launches {launches} vs {stats['prefill_chunks']} chunks")
    check(launches["paged_attention_decode"] == config.n_layers * stats["decode_steps"] > 0,
          f"decode launches {launches} vs {stats['decode_steps']} steps")
    print(f"[{tag}] {len(reqs)} requests finished in {wall:.3f} s wall; "
          f"{stats['prefill_chunks']} prefill chunks, {stats['decode_steps']} decode steps, "
          f"{stats['prefix_cached_tokens']} prefix-cached tokens")
    print(f"[{tag}] prefill {stats['prefill_tokens'] / stats['prefill_seconds']:.1f} tok/s "
          f"({stats['prefill_tokens']} tokens in {stats['prefill_seconds']:.3f} s); decode "
          f"{stats['decode_tokens'] / stats['decode_seconds']:.1f} tok/s "
          f"({stats['decode_tokens']} tokens in {stats['decode_seconds']:.3f} s)")
    print(f"[{tag}] launches on the main path: {launches}")
    return launches


def phase_profile(params, config, dev):
    """Where a decode step's time goes: ``torch.profiler`` over 8 steps of 8
    live requests; device busy share = summed time of the device's kernels
    and copies (one stream, so they do not overlap) over the host wall of
    the same 8 steps run without the profiler (whose host cost inflates
    the wall it watches). Then the device time of one step that prefills a
    chunk of ``max_prefill_len`` tokens, and the paged prefill's part."""
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch.serving import ServingEngine

    def eight_steps(prof=None):
        """8 decode steps of 8 live requests (after the step that admits and
        prefills them); returns the host wall in µs."""
        rng = np.random.default_rng(2)
        engine = ServingEngine(params, config, **ENGINE_KW)
        for _ in range(8):
            engine.submit(rng.integers(0, config.vocab_size, 128), 24)
        engine.step()
        torch.cuda.synchronize()
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        for _ in range(8):
            engine.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
        if prof is not None:
            prof.stop()
        return wall

    plain_us = eight_steps()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    wall_us = eight_steps(prof)
    rows = _device_rows(prof)
    device_us = sum(r[1] for r in rows)
    if not rows:
        print("[profile] the profiler recorded no device time: busy share not measured")
        return
    print(f"[profile] 8 decode steps at 8 slots: wall {plain_us / 8e3:.3f} ms/step "
          f"({wall_us / 8e3:.3f} under the profiler), device {device_us / 8e3:.3f} ms/step, "
          f"busy share {device_us / plain_us:.3f}")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"[profile]   {us / 8e3:8.4f} ms/step  {count / 8:6.1f} calls/step  {key[:90]}")
    decode = [r for r in rows if "paged_decode" in r[0]]
    print(f"[profile] the paged decode kernel over the 8 steps: "
          f"{sum(r[1] for r in decode) / 1e3:.4f} ms of device time in "
          f"{sum(r[2] for r in decode)} launches")

    # one step that prefills a prompt of the largest chunk and decodes one
    # token, profiled after the same step on a fresh engine unprofiled
    prompt = np.random.default_rng(3).integers(0, config.vocab_size, ENGINE_KW["max_prefill_len"])
    for prof in (None, profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])):
        engine = ServingEngine(params, config, **ENGINE_KW)
        engine.submit(prompt, 2)
        torch.cuda.synchronize()
        if prof is not None:
            prof.start()
        engine.step()
        torch.cuda.synchronize()
        if prof is not None:
            prof.stop()
    rows = _device_rows(prof)
    prefill = [r for r in rows if "prefill" in r[0]]
    print(f"[profile] one step prefilling a {len(prompt)}-token chunk through {config.n_layers} "
          f"layers and decoding one token: device {sum(r[1] for r in rows) / 1e3:.3f} ms, the "
          f"paged prefill kernel {sum(r[1] for r in prefill) / 1e3:.4f} ms in "
          f"{sum(r[2] for r in prefill)} launches")


def _device_rows(prof):
    """(key, self device µs, count) of the device-side events (kernels,
    copies) a profiler recorded: an operator row carries the time of the
    kernels it launched, so summing both would count it twice."""
    return [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]


def _cached_logits(params, config, tokens, n_prompt, dev, chunk=128):
    """Logits at every position of ``tokens`` through the serving path:
    ``n_prompt`` tokens prefilled in chunks of ``chunk``, then one decode
    step per remaining token, against a fresh f32 pool."""
    from accelerate_tpu_torch.serving import init_block_pool, paged_forward

    bs, W = ENGINE_KW["block_size"], ENGINE_KW["max_blocks_per_seq"]
    pool = init_block_pool(config, W + 1, bs, torch.float32, dev)
    table = torch.arange(1, W + 1, dtype=torch.int32, device=dev)[None]
    ids = torch.from_numpy(tokens).to(dev)[None]
    out = []
    for s in range(0, n_prompt, chunk):
        e = min(s + chunk, n_prompt)
        pos = torch.arange(s, e, device=dev)[None]
        logits, pool = paged_forward(params, ids[:, s:e], pool, table, pos, config, bs)
        out.append(logits[0])
    for t in range(n_prompt, len(tokens)):
        pos = torch.tensor([[t]], device=dev)
        logits, pool = paged_forward(params, ids[:, t : t + 1], pool, table, pos, config, bs)
        out.append(logits[0])
    return torch.cat(out)


def phase_cached_vs_full(params_bf16, config, dev):
    from accelerate_tpu_torch.models.transformer import llama_forward
    fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
    from accelerate_tpu_torch.serving import engine as engine_mod

    params = {k: ({kk: {kkk: t.float() for kkk, t in vv.items()} for kk, vv in v.items()}
                  if k == "layers" else {kk: t.float() for kk, t in v.items()})
              for k, v in params_bf16.items()}
    # fixed tokens: the check compares logits, not sampled tokens (with
    # random weights the largest logit flips on rounding)
    rng = np.random.default_rng(1)
    n_prompt, n_decode = 192, 16
    tokens = rng.integers(0, config.vocab_size, n_prompt + n_decode)
    cached = _cached_logits(params, config, tokens, n_prompt, dev)
    full = llama_forward(params, torch.from_numpy(tokens).to(dev)[None], config)[0]
    err = float((cached - full).abs().max())
    scale = float(full.abs().max())
    check(bool(torch.isfinite(cached).all()), "non-finite cached logits")
    check(err <= LOGIT_ATOL, f"cached path vs full forward: max abs err {err} > {LOGIT_ATOL}")

    # negative control: bf16-rounded attention outputs must miss the bar
    original = engine_mod.paged_attention

    def rounded(*args):
        return original(*args).to(torch.bfloat16).float()

    engine_mod.paged_attention = rounded
    try:
        rounded_err = float((_cached_logits(params, config, tokens, n_prompt, dev) - full)
                            .abs().max())
    finally:
        engine_mod.paged_attention = original
    check(rounded_err > LOGIT_ATOL,
          f"bf16-rounded attention err {rounded_err} is within {LOGIT_ATOL}: bar too loose")
    print(f"[cached] {n_prompt}-token prefill (128 + 64 chunks) + {n_decode} decode steps vs "
          f"full forward, f32: max abs logit err {err:.3e} (tol {LOGIT_ATOL:.0e}, max |logit| "
          f"{scale:.3f}); with bf16-rounded attention {rounded_err:.3e}")
    print(f"[cached] decode launches {fa.paged_attention_decode.launches}, prefill launches "
          f"{fa.paged_attention_prefill.launches} (cumulative, outside the main-path count)")


def build_workload(n_requests, seed, prompt_lens, new_tokens, rate, vocab_size):
    """``benchmarks/serving/run.py``'s seeded open-loop arrival schedule
    (its ``shared_len=0`` case), copied: this script imports nothing of the
    JAX package's tree. ``[(arrival_step, prompt, max_new)]`` with
    exponential gaps of mean ``1 / rate`` engine steps."""
    rng = np.random.default_rng(seed)
    t = 0.0
    workload = []
    for _ in range(n_requests):
        t += rng.exponential(1.0 / rate)
        prompt = rng.integers(0, vocab_size, (int(rng.integers(*prompt_lens)),)).astype(np.int32)
        workload.append((int(t), prompt, int(rng.integers(*new_tokens))))
    return workload


def _serve_drive(engine, workload):
    """The bench's open-loop drive: submit each request at its arrival step
    with ``rng_seed`` = its index, step while work is live, idle-tick
    otherwise. Returns (requests in workload order, host wall s)."""
    reqs, nxt, step = [], 0, 0
    t0 = time.perf_counter()
    while nxt < len(workload) or not engine.scheduler.idle():
        while nxt < len(workload) and workload[nxt][0] <= step:
            _, prompt, new = workload[nxt]
            reqs.append(engine.submit(prompt, new, rng_seed=nxt))
            nxt += 1
        step += 1
        if not engine.scheduler.idle():
            engine.step()
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0


def _capture_selections(engine, store):
    """Record in ``store[(rid, fold index)]`` the logit row each token was
    selected from, as (logits, row) — a reference to the forward's output,
    no copy. Draft selections are skipped; a verify column past the
    accepted prefix is overwritten by the step that recomputes its index,
    so the last record of an emitted token is the row it came from."""
    state = {}

    def wrap(name, kind):
        inner = getattr(engine, name)

        def run(arg, *rest):
            state["kind"], state["reqs"] = kind, ([arg] if kind == "prefill" else arg)
            return inner(arg, *rest)

        setattr(engine, name, run)

    wrap("_prefill_request", "prefill")
    wrap("_decode_batch", "decode")
    wrap("_spec_decode_batch", "spec")
    select = engine._select

    def _select(logits, key_rows, offset=0):
        reqs, kind = state["reqs"], state["kind"]
        if kind == "spec" and torch.is_tensor(offset):  # the verify: rows (i, j)
            width = engine.spec_tokens + 1
            for i, r in enumerate(reqs):
                for j in range(width):
                    store[(r.rid, len(r.generated) + j)] = (logits, i * width + j)
        elif kind != "spec":
            for i, r in enumerate(reqs):
                store[(r.rid, len(r.generated))] = (logits, i)
        return select(logits, key_rows, offset)

    engine._select = _select


def _serve_leg(params, config, workload, lattice, tag, capture=None, **engine_kw):
    """One engine over ``workload``: every request must finish with its
    full budget, and the counters read after the run (zeroed just before
    it) must show every paged attention call of prefill, decode, draft and
    verify went through the kernels. Returns (metrics, requests, engine)."""
    fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
    from accelerate_tpu_torch.serving import RequestStatus, ServingEngine

    engine = ServingEngine(params, config, lattice=lattice, **SERVE_ENGINE_KW, **engine_kw)
    if capture is not None:
        _capture_selections(engine, capture)
    fa.paged_attention_decode.launches = 0
    fa.paged_attention_prefill.launches = 0
    reqs, wall = _serve_drive(engine, workload)
    launches = {"paged_attention_decode": fa.paged_attention_decode.launches,
                "paged_attention_prefill": fa.paged_attention_prefill.launches}
    st = engine.stats()
    for r, (_, _, new) in zip(reqs, workload):
        check(r.status is RequestStatus.FINISHED, f"{tag}: request {r.rid} ended {r.status}")
        check(len(r.generated) == new, f"{tag}: request {r.rid} made {len(r.generated)} of {new}")
        check(all(0 <= t < config.vocab_size for t in r.generated), f"{tag}: token outside vocab")
    want_prefill = config.n_layers * (st["prefill_chunks"] + st["verify_steps"])
    want_decode = (config.n_layers * st["decode_steps"]
                   + (engine.draft_layers or 0) * st["draft_steps"])
    check(launches["paged_attention_prefill"] == want_prefill > 0,
          f"{tag}: prefill launches {launches} vs {want_prefill} = {config.n_layers} x "
          f"({st['prefill_chunks']} chunks + {st['verify_steps']} verify steps)")
    check(launches["paged_attention_decode"] == want_decode > 0,
          f"{tag}: decode launches {launches} vs {want_decode}")
    tokens = sum(len(r.generated) for r in reqs)
    per_tok = [(r.finish_t - r.first_token_t) / (len(r.generated) - 1) * 1e3
               for r in reqs if len(r.generated) > 1]
    latency = [(r.finish_t - r.arrival_t) * 1e3 for r in reqs]
    leg = dict(tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall, steps=st["steps"],
               p50_per_token_ms=float(np.percentile(per_tok, 50)),
               p99_per_token_ms=float(np.percentile(per_tok, 99)),
               p99_latency_ms=float(np.percentile(latency, 99)),
               mean_occupancy=st["mean_occupancy"], preemptions=st["preemptions"],
               launches=launches)
    if engine.spec_tokens:
        leg.update(accept_rate=st["spec_accept_rate"], accept_hist=st["spec_accept_hist"])
    print(f"[{tag}] {len(reqs)} requests, {tokens} tokens in {wall:.3f} s: "
          f"{leg['tokens_per_s']:.1f} tok/s, {st['steps']} steps, per-token p50 "
          f"{leg['p50_per_token_ms']:.3f} ms p99 {leg['p99_per_token_ms']:.3f} ms, latency p99 "
          f"{leg['p99_latency_ms']:.1f} ms, occupancy {st['mean_occupancy']:.3f}, "
          f"{st['preemptions']} preemptions"
          + (f", accept rate {st['spec_accept_rate']:.4f} hist {st['spec_accept_hist']}"
             if engine.spec_tokens else "")
          + f"; launches {launches} ({st['prefill_chunks']} chunks, {st['decode_steps']} "
            f"decode, {st['draft_steps']} draft, {st['verify_steps']} verify steps)")
    return leg, reqs, engine


def _profile_serve_steps(params, config, lattice, tag, **engine_kw):
    """Where a step's time goes: ``torch.profiler`` over 8 steps of 8 live
    requests (64-token prompts, after the step that admits them); busy
    share = the device's summed kernel and copy time over the host wall of
    the same 8 steps run unprofiled."""
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch.serving import ServingEngine

    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, config.vocab_size, 64) for _ in range(8)]

    def eight_steps(prof=None):
        engine = ServingEngine(params, config, lattice=lattice, **SERVE_ENGINE_KW, **engine_kw)
        for p in prompts:
            engine.submit(p, 40)
        engine.step()
        torch.cuda.synchronize()
        if prof is not None:
            prof.start()
        t0 = time.perf_counter()
        for _ in range(8):
            engine.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        if prof is not None:
            prof.stop()
        return wall, engine.stats()["decode_tokens"]

    wall, _ = eight_steps()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    _, tokens = eight_steps(prof)
    rows = _device_rows(prof)
    if not rows:
        print(f"[{tag}] the profiler recorded no device time: busy share not measured")
        return
    device = sum(r[1] for r in rows) / 1e3
    print(f"[{tag}] 8 steps at 8 slots: wall {wall / 8:.3f} ms/step, device {device / 8:.3f} "
          f"ms/step, busy share {device / wall:.3f}, {sum(r[2] for r in rows) / 8:.0f} device "
          f"events a step, {tokens} tokens in the 9 steps")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:6]:
        print(f"[{tag}]   {us / 8e3:8.4f} ms/step  {count / 8:6.1f} calls/step  {key[:80]}")
    # by entry name: paged_decode_kernel; paged_prefill_kernel (CUDA
    # cores) and prefill_tc_kernel (tensor cores)
    for name, kernel in (("paged decode #6", "paged_decode"), ("paged prefill #7", "prefill")):
        hits = [r for r in rows if kernel in r[0]]
        print(f"[{tag}]   {name}: {sum(r[1] for r in hits) / 8e3:.4f} ms/step in "
              f"{sum(r[2] for r in hits) / 8:.0f} launches a step")


def _first_divergence(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def _row(cap, rid, idx):
    logits, row = cap[(rid, idx)]
    return logits[row].float()


def _compare_legs(tag, spec_reqs, plain_reqs, spec_cap, plain_cap, bar=None, tie_gap=None):
    """Per request: the first position where the legs' tokens part, the
    plain row's top-2 gap there, and the largest |delta| between the legs'
    logit rows at every position up to it (the same prefix on both sides).
    Returns (matching requests, largest |delta|, the divergences)."""
    match, worst, divergences = 0, 0.0, []
    for i, (rs, rp) in enumerate(zip(spec_reqs, plain_reqs)):
        d = _first_divergence(rs.generated, rp.generated)
        last = len(rp.generated) - 1 if d is None else d
        deltas = [float((_row(spec_cap, rs.rid, j) - _row(plain_cap, rp.rid, j)).abs().max())
                  for j in range(last + 1)]
        worst = max(worst, max(deltas))
        if d is None:
            match += 1
            continue
        top2 = torch.topk(_row(plain_cap, rp.rid, d), 2).values
        gap = float(top2[0] - top2[1])
        divergences.append((i, d, gap, deltas[-1]))
        print(f"[{tag}] request {i} diverges at generated token {d} of {len(rp.generated)}: "
              f"plain top-2 gap {gap:.4e}, max |delta| of the two legs' logits there "
              f"{deltas[-1]:.4e} (largest before it {max(deltas[:-1], default=0.0):.4e})")
        if tie_gap is not None:
            check(gap < tie_gap, f"{tag}: request {i} diverges at {d} with top-2 gap {gap} "
                                 f">= {tie_gap}: not a tie")
    if bar is not None:
        check(worst <= bar, f"{tag}: speculative vs plain logits differ by {worst} > {bar} at "
                            f"a shared prefix: a wrong position, key or fold index")
    return match, worst, divergences


def _to_f32(params):
    return _tree_to(params, torch.float32)


def _tree_to(tree, *to):
    """Every tensor of a param tree (dicts at any depth), detached and
    moved or cast by ``Tensor.to(*to)``."""
    from accelerate_tpu_torch.utils.operations import _tree_map

    return _tree_map(lambda t: t.detach().to(*to), tree)


def _serve_lattice(workload_args, prefill_cap):
    """The bench's lattice: 8 slots, tables to the longest request's blocks
    plus one, prefill buckets to ``prefill_cap``."""
    from accelerate_tpu_torch.serving import BucketLattice

    bs = SERVE_ENGINE_KW["block_size"]
    max_len = workload_args[2][1] + workload_args[3][1]
    return BucketLattice.from_limits(SERVE_ENGINE_KW["max_slots"], -(-max_len // bs) + 1,
                                     prefill_cap)


def phase_spec_decode(params, config):
    """``benchmarks/serving/run.py``'s speculative leg at its TPU
    configuration: the same workload with ``spec_tokens=3, draft_layers=2``
    and without, greedy, bf16; tokens/s, per-token latency, steps, the
    accept rate, launch counts; then both legs again capturing each token's
    logit row, to print every divergence and hold the rows to
    SPEC_LOGIT_BAR; then both legs in f32 on the first 4 requests, whose
    streams must match."""
    workload = build_workload(*SPEC_WORKLOAD, config.vocab_size)
    lattice = _serve_lattice(SPEC_WORKLOAD, SPEC_WORKLOAD[2][1])
    spec_kw = dict(spec_tokens=SPEC_TOKENS, draft_layers=SPEC_DRAFT_LAYERS)
    # one short run of each engine first: the first calls at new shapes
    # pay one-time costs (library heuristics, allocator growth)
    _serve_leg(params, config, workload[:2], lattice, "spec-warm", **spec_kw)
    _serve_leg(params, config, workload[:2], lattice, "spec-off-warm")
    spec, spec_reqs, _ = _serve_leg(params, config, workload, lattice, "spec", **spec_kw)
    plain, plain_reqs, _ = _serve_leg(params, config, workload, lattice, "spec-off")
    check(spec["accept_rate"] > 0, f"speculative leg accepted no draft token: {spec}")
    print(f"[spec] tokens/s spec/plain {spec['tokens_per_s'] / plain['tokens_per_s']:.3f}, "
          f"steps {spec['steps']} / {plain['steps']}, per-token p50 "
          f"{spec['p50_per_token_ms'] / plain['p50_per_token_ms']:.3f}x")
    _profile_serve_steps(params, config, lattice, "spec-profile", **spec_kw)
    _profile_serve_steps(params, config, lattice, "spec-off-profile")
    _profile_serve_steps(params, config, lattice, "sample-profile", **SAMPLING_LEGS[0])
    caps = ({}, {})
    _, spec_again, _ = _serve_leg(params, config, workload, lattice, "spec-capture",
                                  capture=caps[0], **spec_kw)
    _, plain_again, _ = _serve_leg(params, config, workload, lattice, "spec-off-capture",
                                   capture=caps[1])
    for a, b, tag in ((spec_reqs, spec_again, "spec"), (plain_reqs, plain_again, "spec-off")):
        check(all(x.generated == y.generated for x, y in zip(a, b)),
              f"{tag}: a second run of the same leg made other tokens")
    match, worst, div = _compare_legs("spec-bf16", spec_again, plain_again, *caps,
                                      bar=SPEC_LOGIT_BAR)
    # negative control: the plain row one position on must miss the bar
    r = plain_again[0]
    control = float((_row(caps[1], r.rid, 1) - _row(caps[1], r.rid, 0)).abs().max())
    check(control > SPEC_LOGIT_BAR, f"the next position's row is within the bar: {control}")
    print(f"[spec-bf16] {match} of {len(workload)} requests match across the legs; largest "
          f"|delta| of the legs' logits at a shared prefix {worst:.4e} (bar {SPEC_LOGIT_BAR}; "
          f"the next position's row differs by {control:.3f})")
    del caps, spec_again, plain_again
    f32 = _to_f32(params)
    caps = ({}, {})
    _, s32, _ = _serve_leg(f32, config, workload[:SPEC_F32_REQUESTS], lattice, "spec-f32",
                           capture=caps[0], cache_dtype=torch.float32, **spec_kw)
    _, p32, _ = _serve_leg(f32, config, workload[:SPEC_F32_REQUESTS], lattice, "spec-off-f32",
                           capture=caps[1], cache_dtype=torch.float32)
    match32, worst32, _ = _compare_legs("spec-f32", s32, p32, *caps, tie_gap=SPEC_F32_TIE_GAP)
    print(f"[spec-f32] {match32} of {SPEC_F32_REQUESTS} requests match; largest |delta| "
          f"{worst32:.4e}")
    return dict(spec=spec, plain=plain, match=match, divergences=len(div), worst_delta=worst,
                f32_match=match32)


def phase_sampling(params, config, dev):
    """The same workload sampled (top-k, then top-p), with and without
    ``spec_tokens=3``: each leg run twice, the second run must reproduce
    the first's tokens (counter-based streams); the match count between
    the speculative and plain legs; what the sampler adds to a decode step
    in launches and device ms, at the decode and verify widths."""
    from torch.profiler import ProfilerActivity, profile

    workload = build_workload(*SPEC_WORKLOAD, config.vocab_size)
    lattice = _serve_lattice(SPEC_WORKLOAD, SPEC_WORKLOAD[2][1])
    out = {}
    for sample in SAMPLING_LEGS:
        name = "top_k" if "top_k" in sample else "top_p"
        legs = {}
        for spec in (False, True):
            kw = dict(sample, **(dict(spec_tokens=SPEC_TOKENS, draft_layers=SPEC_DRAFT_LAYERS)
                                 if spec else {}))
            tag = f"sample-{name}" + ("-spec" if spec else "")
            # the first run warms the sampler's ops; the second is the leg's
            _, first, _ = _serve_leg(params, config, workload, lattice, tag + "-first", **kw)
            leg, reqs, engine = _serve_leg(params, config, workload, lattice, tag, **kw)
            check(all(a.generated == b.generated for a, b in zip(first, reqs)),
                  f"{tag}: a second run of the same leg made other tokens")
            legs[spec] = (leg, reqs)
        match = sum(a.generated == b.generated for a, b in zip(legs[False][1], legs[True][1]))
        # the sampler alone on the decode step's and the verify step's rows
        cost = {}
        rng = np.random.default_rng(0)
        for rows in (SERVE_ENGINE_KW["max_slots"], SERVE_ENGINE_KW["max_slots"] * (SPEC_TOKENS + 1)):
            logits = [torch.randn(rows, config.vocab_size, device=dev).to(torch.bfloat16)
                      for _ in range(2)]
            keys = torch.from_numpy(np.stack([rng.integers(0, 2**32, rows),
                                              rng.integers(0, 2**32, rows),
                                              rng.integers(0, 64, rows)], 1)).to(dev)
            engine._select(logits[0], keys)
            torch.cuda.synchronize()
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.start()
            engine._select(logits[0], keys)
            torch.cuda.synchronize()
            prof.stop()
            device = _device_rows(prof)
            # its launches outrun the device's launch queue behind a sleep:
            # timed between two events, so host issue gaps count too
            ms = time_ms(lambda i: engine._select(logits[i], keys), 2, 20, behind_sleep=False)
            cost[rows] = (sum(r[2] for r in device), sum(r[1] for r in device) / 1e3, ms)
        out[name] = dict(plain=legs[False][0], spec=legs[True][0], match=match, cost=cost)
        print(f"[sample-{name}] tok/s plain {legs[False][0]['tokens_per_s']:.1f} spec "
              f"{legs[True][0]['tokens_per_s']:.1f}; {match} of {len(workload)} requests match "
              f"across the legs; the sampler: "
              + ", ".join(f"{rows} rows {k} device launches, {dev_ms:.4f} ms of device time, "
                          f"{ms:.4f} ms a call" for rows, (k, dev_ms, ms) in cost.items())
              + " (greedy: 1 argmax launch)")
    return out


def phase_static(params, config):
    """``run_bench_serving``'s continuous-vs-static leg at its TPU
    configuration: 32 requests, greedy, ``continuous=True`` then
    ``continuous=False`` (gang admission, no backfill)."""
    workload = build_workload(*STATIC_WORKLOAD, config.vocab_size)
    lattice = _serve_lattice(STATIC_WORKLOAD, STATIC_WORKLOAD[2][1] + STATIC_WORKLOAD[3][1])
    _serve_leg(params, config, workload[:4], lattice, "static-warm")
    cont, creqs, _ = _serve_leg(params, config, workload, lattice, "continuous")
    static, sreqs, _ = _serve_leg(params, config, workload, lattice, "static", continuous=False)
    check(static["steps"] > cont["steps"], f"static took no more steps: {static} vs {cont}")
    match = sum(a.generated == b.generated for a, b in zip(creqs, sreqs))
    print(f"[static] continuous/static tok/s {cont['tokens_per_s'] / static['tokens_per_s']:.3f} "
          f"({cont['tokens_per_s']:.1f} / {static['tokens_per_s']:.1f}); occupancy "
          f"{cont['mean_occupancy']:.3f} / {static['mean_occupancy']:.3f}; latency p99 "
          f"{cont['p99_latency_ms']:.1f} / {static['p99_latency_ms']:.1f} ms; steps "
          f"{cont['steps']} / {static['steps']}; {match} of {len(workload)} requests match")
    return dict(continuous=cont, static=static, match=match)


# bench.py's config #5 (run_bench_inference, bench.py:554-630): the Llama-1B
# class model of CONFIG_KW (bf16 params from seed 0), batch 8 x 128 prompt
# tokens of default_rng(0), 64 new tokens, greedy with warm-up; then its
# CPU-offload leg, 16 tokens through generate_dispatched (the beam search
# runs 16 tokens too), and the disk legs 4.
GEN_BATCH, GEN_PROMPT, GEN_NEW, GEN_SHORT_NEW, GEN_DISK_NEW = 8, 128, 64, 16, 4
GEN_SAMPLE = dict(temperature=0.8, top_k=50, top_p=0.9)
GEN_SAMPLE_NEW, GEN_BEAMS = 32, 4
# Greedy bf16 tokens against an f32 forward of the same (upcast) weights
# over the generated rows: each token must be the f32 argmax, or its f32
# logit within this of the f32 maximum. Each bf16 op rounds at 2**-9
# relative, which grows through 16 residual layers to a few parts in 10**3
# of the hidden state, and the head's bf16 output rounds in steps of 2**-6
# to 2**-7 at these logits, so the two paths' logits differ by a few
# hundredths. Two decode-cache faults planted in the generation path
# (GEN_FAULTS) must miss it, and are printed beside it in every run.
GEN_F32_BAR = 0.25
# The generation path's cached forward in f32 (prefill, then one step per
# token, f32 cache) against the f32 full forward over the greedy rows is
# held to LOGIT_ATOL; each planted fault must miss it.
GEN_FAULTS = ("late", "lost")
# load_checkpoint_and_dispatch leg: stage names a layer may not be split
# across, and how many layers the budgets put on the device and the host
GEN_NO_SPLIT = [r"^layer_\d+$"]
GEN_LAYERS_ON_DEVICE, GEN_LAYERS_ON_CPU = 8, 6


def _profile_decode_step(params, config, dev, prompt):
    """``torch.profiler`` over one greedy decode step of the resident path
    (``_forward_cached`` at batch 8, position 128, and its argmax), after
    the same step unprofiled for its host wall: device ms, device events
    and busy share."""
    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch import generation as gen

    B, S = prompt.shape
    rope = gen._rope(config, dev)
    layers = [gen.layer_params(params, i) for i in range(config.n_layers)]
    cache = gen.init_kv_cache(config, B, S + 2, torch.bfloat16, dev)
    with torch.no_grad():
        tok = torch.argmax(gen._forward_cached(params, prompt, cache, 0, config, rope,
                                               layers)[:, -1], dim=-1)

        def one_step():
            return torch.argmax(gen._forward_cached(params, tok[:, None], cache, S, config, rope,
                                                    layers)[:, -1], dim=-1)

        one_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
        one_step()
        torch.cuda.synchronize()
        prof.stop()
    rows = _device_rows(prof)
    if not rows:
        print("[generate] the profiler recorded no device time: busy share not measured")
        return
    device_us = sum(r[1] for r in rows)
    print(f"[generate] profile of one decode step (batch {B}, position {S}): wall "
          f"{wall_us / 1e3:.3f} ms unprofiled, device {device_us / 1e3:.3f} ms in "
          f"{sum(r[2] for r in rows)} device events, busy share {device_us / wall_us:.3f}")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:6]:
        print(f"[generate]   {us / 1e3:8.4f} ms  {count:5d} calls  {key[:90]}")


def _f32_logits(f32, config, tokens, n_prompt, dev):
    """The f32 full forward (``llama_forward``, einsum attention) over the
    rows ``tokens [B, T]``: logits ``[B, T - n_prompt, V]``, row t the one
    that predicts token ``n_prompt + t``."""
    from accelerate_tpu_torch.models.transformer import llama_forward

    ids = torch.from_numpy(tokens.astype(np.int64)).to(dev)
    with torch.no_grad():
        return llama_forward(f32, ids[:, :-1], config, attention_impl="xla")[:, n_prompt - 1:]


def _token_gaps(logits, tokens, n_prompt):
    """How far each generated token's logit lies below the maximum of its
    row of ``logits`` (0 where it is the argmax), ``[B, T - n_prompt]``."""
    chosen = torch.from_numpy(tokens[:, n_prompt:].astype(np.int64)).to(logits.device)
    return (logits.max(dim=-1).values - logits.gather(-1, chosen[..., None])[..., 0]).cpu()


def _generate_logits(f32, config, tokens, n_prompt, dev):
    """The same logits through the generation path's cached forward
    (``_forward_cached``): the prompt prefilled at once, then one step per
    token, against an f32 cache."""
    from accelerate_tpu_torch import generation as gen

    ids = torch.from_numpy(tokens.astype(np.int64)).to(dev)
    B, T = ids.shape
    cache = gen.init_kv_cache(config, B, T, torch.float32, dev)
    rope = gen._rope(config, dev)
    with torch.no_grad():
        out = [gen._forward_cached(f32, ids[:, :n_prompt], cache, 0, config, rope)[:, -1:]]
        for t in range(n_prompt, T - 1):
            out.append(gen._forward_cached(f32, ids[:, t:t + 1], cache, t, config, rope))
    return torch.cat(out, dim=1)


@contextlib.contextmanager
def _planted_fault(fault):
    """A decode-cache fault planted in the generation path, for the checks'
    negative control: ``"late"`` writes each decode step's k/v one slot
    late (the step then attends a slot no step wrote, and loses the
    prompt's first token); ``"lost"`` keeps no decode step's k/v (each
    step sees the prompt and itself)."""
    from accelerate_tpu_torch import generation as gen

    real = gen._layer_step

    def step(layer, h, k_cache, v_cache, start, cos, sin, config):
        if h.shape[1] == 1:
            if fault == "late":
                k_cache, v_cache = k_cache[:, 1:], v_cache[:, 1:]
            else:
                k_cache, v_cache = k_cache.clone(), v_cache.clone()
        return real(layer, h, k_cache, v_cache, start, cos, sin, config)

    gen._layer_step = step
    try:
        yield
    finally:
        gen._layer_step = real


def _f32_greedy_check(params, config, tokens, n_prompt, dev, prompt):
    """Every greedy token against the f32 full forward of the same weights
    on the generated rows: the f32 argmax, or a near-tie within
    GEN_F32_BAR, each printed. Then the generation path's cached forward
    in f32 against the same logits, within LOGIT_ATOL. Then each planted
    fault through both, each of which it must fail: its greedy tokens'
    largest gap against GEN_F32_BAR, its cached logits' error against
    LOGIT_ATOL."""
    from accelerate_tpu_torch import greedy_generate

    f32 = _to_f32(params)
    logits = _f32_logits(f32, config, tokens, n_prompt, dev)
    gap = _token_gaps(logits, tokens, n_prompt)
    near = [(int(r), int(t), float(gap[r, t])) for r, t in torch.nonzero(gap > 0).tolist()]
    for r, t, g in near:
        print(f"[generate]   near-tie: row {r} token {t}: bf16 chose {int(tokens[r, n_prompt + t])}"
              f", f32 argmax {int(logits[r, t].argmax())}, f32 logit gap {g:.4f}")
    worst = float(gap.max())
    print(f"[generate] greedy bf16 tokens vs the f32 forward over the {tokens.shape[0]} generated "
          f"rows ({config.n_layers} layers): {gap.numel() - len(near)} of {gap.numel()} are the "
          f"f32 argmax; largest gap {worst:.4f} (bar {GEN_F32_BAR})")
    check(worst <= GEN_F32_BAR, f"a greedy token's f32 logit is {worst} below the f32 maximum")
    err = float((_generate_logits(f32, config, tokens, n_prompt, dev) - logits).abs().max())
    print(f"[generate] cached forward in f32 vs the f32 full forward over the greedy rows: max abs "
          f"logit err {err:.3e} (tol {LOGIT_ATOL:.0e}, max |logit| {float(logits.abs().max()):.3f})")
    check(err <= LOGIT_ATOL, f"generation's cached forward vs full forward: {err} > {LOGIT_ATOL}")
    for fault in GEN_FAULTS:
        with _planted_fault(fault):
            bad_err = float((_generate_logits(f32, config, tokens, n_prompt, dev) - logits)
                            .abs().max())
            bad = greedy_generate(params, prompt, config, max_new_tokens=GEN_SHORT_NEW)
        bad_gap = _token_gaps(_f32_logits(f32, config, bad, n_prompt, dev), bad, n_prompt)
        print(f"[generate] planted fault {fault!r}: greedy tokens' largest f32 gap "
              f"{float(bad_gap.max()):.4f} ({int((bad_gap > 0).sum())} of {bad_gap.numel()} not "
              f"the f32 argmax; bar {GEN_F32_BAR}); cached f32 logits err {bad_err:.3e} (tol "
              f"{LOGIT_ATOL:.0e})")
        check(bad_err > LOGIT_ATOL and float(bad_gap.max()) > GEN_F32_BAR,
              f"planted fault {fault!r} within a bar ({LOGIT_ATOL}, {GEN_F32_BAR}): too loose")
    del f32


def phase_generate(params, config, dev, load_s):
    """``bench.py``'s config #5 on the card: ``greedy_generate`` at batch 8
    x 128 prompt tokens, 64 new, bf16, with warm-up and stats; the HBM
    roofline fraction as ``bench.py:603-606`` computes it; a profiled decode
    step; the f32 check; ``sample_generate`` twice from one key;
    ``beam_generate`` at 4 beams (finite) and at 1 (equal to greedy).
    Returns the prompt and the greedy tokens at GEN_SHORT_NEW and
    GEN_DISK_NEW new tokens, for the offload legs."""
    from accelerate_tpu_torch import beam_generate, greedy_generate, sample_generate
    from accelerate_tpu_torch.utils.random import prng_key

    t_phase = time.perf_counter()
    prompt = np.random.default_rng(0).integers(0, config.vocab_size,
                                               (GEN_BATCH, GEN_PROMPT)).astype(np.int32)
    n_params = _n_params(params)
    tokens, stats = greedy_generate(params, prompt, config, max_new_tokens=GEN_NEW,
                                    return_stats=True, warmup=True)
    check(tokens.shape == (GEN_BATCH, GEN_PROMPT + GEN_NEW)
          and (tokens[:, GEN_PROMPT:] >= 0).all()
          and (tokens[:, GEN_PROMPT:] < config.vocab_size).all(), "bad greedy tokens")
    tps = stats["decode_tokens_per_sec"]
    hbm_frac = (tps / GEN_BATCH) * (2.0 * n_params) / HBM_BYTES_PER_S
    print(f"[generate] config #5: {n_params / 1e9:.4f} B params (bf16), batch {GEN_BATCH} x "
          f"{GEN_PROMPT} prompt tokens, {GEN_NEW} new; load_seconds {load_s:.3f} (init from "
          f"seed 0 on the card)")
    print(f"[generate] prefill_seconds {stats['prefill_seconds']:.4f}, decode_tokens_per_sec "
          f"{tps:.1f}, seconds_per_token {stats['seconds_per_token']:.5f}; HBM roofline fraction "
          f"{hbm_frac:.4f} ((tok/s / {GEN_BATCH}) x 2N bytes over {HBM_BYTES_PER_S / 1e12:.2f} "
          f"TB/s, the H100 SXM data sheet's HBM3 rate)")
    _profile_decode_step(params, config, dev, torch.from_numpy(prompt.astype(np.int64)).to(dev))
    _f32_greedy_check(params, config, tokens, GEN_PROMPT, dev, prompt)

    draws = [sample_generate(params, prompt, config, max_new_tokens=GEN_SAMPLE_NEW,
                             rng_key=prng_key(0), **GEN_SAMPLE) for _ in range(2)]
    check(np.array_equal(draws[0], draws[1]), "sample_generate from one key gave two streams")
    check(not np.array_equal(draws[0], tokens[:, :GEN_PROMPT + GEN_SAMPLE_NEW]),
          "sampled tokens equal the greedy ones")
    print(f"[generate] sample_generate {GEN_SAMPLE}, {GEN_SAMPLE_NEW} tokens, twice from "
          f"prng_key(0): the same tokens; "
          f"{int((draws[0][:, GEN_PROMPT:] != tokens[:, GEN_PROMPT:GEN_PROMPT + GEN_SAMPLE_NEW]).sum())}"
          f" of {GEN_BATCH * GEN_SAMPLE_NEW} differ from greedy")

    # a cache sized for 16 new tokens: the comparisons below are bitwise, and
    # the attention's reductions run over the cache's length
    greedy16 = greedy_generate(params, prompt, config, max_new_tokens=GEN_SHORT_NEW)
    t0 = time.perf_counter()
    beams, scores = beam_generate(params, prompt, config, num_beams=GEN_BEAMS,
                                  max_new_tokens=GEN_SHORT_NEW, return_scores=True)
    torch.cuda.synchronize()
    beam_s = time.perf_counter() - t0
    check(bool(np.isfinite(scores).all()) and beams.shape == greedy16.shape,
          f"beam search: scores {scores}")
    one = beam_generate(params, prompt, config, num_beams=1, max_new_tokens=GEN_SHORT_NEW)
    check(np.array_equal(one, greedy16), "beam_generate(num_beams=1) differs from greedy")
    print(f"[generate] beam_generate {GEN_BEAMS} beams x {GEN_SHORT_NEW} tokens in {beam_s:.3f} s: "
          f"scores {' '.join(f'{s:.4f}' for s in scores.tolist())}; "
          f"{int((beams != greedy16).sum())} tokens differ from greedy; 1 beam equals greedy")
    greedy4 = greedy_generate(params, prompt, config, max_new_tokens=GEN_DISK_NEW)
    print(f"[generate] phase seconds {time.perf_counter() - t_phase:.1f}")
    return prompt, greedy16, greedy4


def _copy_overlap(prof, kind: str = "HtoD"):
    """(copy µs of ``kind`` (``"HtoD"`` or ``"DtoH"``), of it µs overlapping
    a kernel on another stream, kernel µs) from a profiler's device events,
    or None when the profiler gives no device events with streams."""
    copies, kernels = [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end, getattr(e, "device_resource_id", None))
        if f"Memcpy {kind}" in e.name:
            copies.append(span)
        elif "Memcpy" not in e.name and "Memset" not in e.name:
            kernels.append(span)
    if not copies or not kernels:
        return None
    kernels.sort()
    copy_us = sum(b - a for a, b, _ in copies)
    kernel_us = sum(b - a for a, b, _ in kernels)
    beside = 0.0
    for a, b, stream in copies:
        # the union of kernel intervals on other streams, clipped to [a, b]
        cur_a = cur_b = None
        for ka, kb, ks in kernels:
            if ks == stream or kb <= a or ka >= b:
                continue
            ka, kb = max(ka, a), min(kb, b)
            if cur_b is None or ka > cur_b:
                if cur_b is not None:
                    beside += cur_b - cur_a
                cur_a, cur_b = ka, kb
            else:
                cur_b = max(cur_b, kb)
        if cur_b is not None:
            beside += cur_b - cur_a
    return copy_us, beside, kernel_us


def _stage_bytes(stages, names):
    return sum(t.numel() * t.element_size() for n in names for _, t in _named(stages[n]))


def phase_offload(params, config, dev, prompt, greedy16, greedy4):
    """The CPU-offload leg of ``bench.py:609-628``: ``cpu_offload(
    unstack_layer_params(params))`` (pinning timed apart) and
    ``generate_dispatched`` for 16 tokens with warm-up, which must give
    ``greedy_generate``'s tokens bit for bit; the host-to-device bytes a
    token and the rate they reach against one large pinned copy timed
    alone; a profile of a prefill and one decode step for the copy time
    that runs beside the layers' kernels. Then ``disk_offload`` (4
    tokens) and ``load_checkpoint_and_dispatch`` from an ``.npz`` of the
    same weights under budgets that put layers on the card, on the host
    and two on disk (4 tokens): the same tokens."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from accelerate_tpu_torch import (abstract_params, compute_module_sizes, cpu_offload,
                                      disk_offload, generate_dispatched, init_llama,
                                      load_checkpoint_and_dispatch, unstack_layer_params)
    from accelerate_tpu_torch.utils.modeling import named_parameters

    t_phase = time.perf_counter()
    stages = unstack_layer_params(params, config)
    layer_names = [n for n in stages if n.startswith("layer_")]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dp = cpu_offload(stages)
    pin_s = time.perf_counter() - t0
    pinned = all(t.is_pinned() for t in dp._host.values())
    check(pinned, "cpu_offload left a host leaf in pageable memory")
    out, stats = generate_dispatched(dp, prompt, config, max_new_tokens=GEN_SHORT_NEW,
                                     return_stats=True, warmup=True)
    check(np.array_equal(out, greedy16),
          f"generate_dispatched (cpu offload) differs from greedy_generate in "
          f"{int((out != greedy16).sum())} tokens")
    per_token = _stage_bytes(stages, layer_names)
    once = _stage_bytes(stages, [n for n in stages if n not in layer_names])
    spt = stats["seconds_per_token"]
    # the bound: one pinned copy of the same bytes, timed alone
    big = torch.empty(per_token // 2, dtype=torch.bfloat16, pin_memory=True)
    copy_ms = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        on_dev = big.to(dev, non_blocking=True)
        ev[1].record()
        torch.cuda.synchronize()
        copy_ms.append(ev[0].elapsed_time(ev[1]))
        del on_dev
    del big
    best_copy = min(copy_ms)
    print(f"[offload] cpu_offload of {len(stages)} stages: {pin_s:.3f} s pinning "
          f"{(per_token + once) / 1e9:.3f} GB (outside seconds_per_token)")
    print(f"[offload] generate_dispatched {GEN_SHORT_NEW} tokens: prefill_seconds "
          f"{stats['prefill_seconds']:.4f}, seconds_per_token {spt:.5f}, decode_tokens_per_sec "
          f"{stats['decode_tokens_per_sec']:.2f}; tokens equal greedy_generate's bit for bit")
    print(f"[offload] host-to-device {per_token / 1e9:.4f} GB a token (the {len(layer_names)} "
          f"layers; embedding, final norm and head, {once / 1e9:.4f} GB, stay after the first): "
          f"{per_token / spt / 1e9:.2f} GB/s; one pinned copy of the same bytes alone "
          f"{best_copy:.3f} ms ({per_token / best_copy / 1e6:.2f} GB/s, best of "
          f"{' '.join(f'{m:.3f}' for m in copy_ms)} ms): the leg runs at "
          f"{best_copy / 1e3 / spt:.3f} of that bound")
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    generate_dispatched(dp, prompt, config, max_new_tokens=2)
    torch.cuda.synchronize()
    prof.stop()
    overlap = _copy_overlap(prof)
    if overlap is None:
        print("[offload] the profiler gave no host-to-device copies with kernels: overlap "
              "not measured")
    else:
        copy_us, beside, kernel_us = overlap
        print(f"[offload] profile of a prefill and one decode step: host-to-device copies "
              f"{copy_us / 1e3:.3f} ms on the side stream, kernels {kernel_us / 1e3:.3f} ms; "
              f"{beside / 1e3:.3f} ms of copy run beside a kernel on the compute stream "
              f"({beside / max(copy_us, 1e-9):.3f} of the copy time, "
              f"{beside / max(kernel_us, 1e-9):.3f} of the kernel time)")
    del dp

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dp = disk_offload(stages, os.path.join(tmp, "disk"))
        write_s = time.perf_counter() - t0
        out, stats = generate_dispatched(dp, prompt, config, max_new_tokens=GEN_DISK_NEW,
                                         return_stats=True)
        check(np.array_equal(out, greedy4), "disk_offload tokens differ from greedy_generate's")
        print(f"[offload] disk_offload: {write_s:.3f} s writing the memmaps; "
              f"generate_dispatched {GEN_DISK_NEW} tokens, seconds_per_token "
              f"{stats['seconds_per_token']:.5f}; tokens equal greedy_generate's")
        del dp
        import shutil

        shutil.rmtree(os.path.join(tmp, "disk"))

        ckpt = os.path.join(tmp, "model.npz")
        t0 = time.perf_counter()
        np.savez(ckpt, **{k: v.float().cpu().numpy() for k, v in named_parameters(stages).items()})
        save_s = time.perf_counter() - t0
        abstract = abstract_params(lambda: unstack_layer_params(
            init_llama(config, device="cpu", dtype=torch.bfloat16), config))
        sizes = compute_module_sizes(abstract)
        layer = sizes[layer_names[0]]
        reserve = max(sizes["lm_head"] if "lm_head" in sizes else 0, layer)
        max_memory = {0: sizes["embed_tokens"] + GEN_LAYERS_ON_DEVICE * layer + reserve,
                      "cpu": GEN_LAYERS_ON_CPU * layer + reserve}
        t0 = time.perf_counter()
        dp = load_checkpoint_and_dispatch(abstract, ckpt, device_map="auto",
                                          max_memory=max_memory,
                                          no_split_module_patterns=GEN_NO_SPLIT,
                                          offload_folder=os.path.join(tmp, "offload"),
                                          dtype=torch.bfloat16)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        where = {}
        for name, target in dp.device_map.items():
            where.setdefault(str(target), []).append(name)
        on_disk = [n for n in where.get("disk", []) if n.startswith("layer_")]
        print(f"[offload] load_checkpoint_and_dispatch from a {os.path.getsize(ckpt) / 1e9:.2f} "
              f"GB .npz (f32, written in {save_s:.2f} s) to bf16: {load_s:.3f} s; max_memory "
              f"{max_memory}; map: " + "; ".join(f"{k}: {', '.join(v)}" for k, v in where.items()))
        check(len(on_disk) == 2 and any(n.startswith("layer_") for n in where.get("cpu", []))
              and any(n.startswith("layer_") for n in where.get("0", [])),
              f"the inferred map does not put layers on the card, the host and two on disk: "
              f"{dict(dp.device_map)}")
        out, stats = generate_dispatched(dp, prompt, config, max_new_tokens=GEN_DISK_NEW,
                                         return_stats=True)
        check(np.array_equal(out, greedy4),
              "load_checkpoint_and_dispatch tokens differ from greedy_generate's")
        print(f"[offload] its generate_dispatched {GEN_DISK_NEW} tokens: seconds_per_token "
              f"{stats['seconds_per_token']:.5f}; tokens equal greedy_generate's")
        del dp
    print(f"[offload] phase seconds {time.perf_counter() - t_phase:.1f}")


def _reset_states():
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _train_setup(dev, precision, n_batches):
    """BERT-base (S=128, fused attention) through ``Accelerator.prepare``:
    random f32 master weights from seed 0, synthetic MRPC from seed 0,
    ``adamw(TRAIN_LR)``, batch 32. Returns the prepared pieces and the loop."""
    from accelerate_tpu_torch import Accelerator, BertConfig, DataLoader, bert_loss, init_bert
    from accelerate_tpu_torch.optimizer import adamw
    from accelerate_tpu_torch.utils.synthetic import DictDataset, make_synthetic_mrpc

    _reset_states()
    config = dataclasses.replace(BertConfig.base(), max_seq_len=TRAIN_SEQ, attn_impl="fused")
    acc = Accelerator(mixed_precision=precision, rng_seed=0)
    data = make_synthetic_mrpc(TRAIN_BATCH * n_batches, TRAIN_SEQ, config.vocab_size, seed=0)
    params = init_bert(config, torch.Generator(device=dev).manual_seed(0), device=dev)
    params, opt, dl = acc.prepare(params, adamw(TRAIN_LR),
                                  DataLoader(DictDataset(data), batch_size=TRAIN_BATCH))
    loop = acc.prepare_train_loop(lambda p, b: bert_loss(p, b, config), opt)
    return config, params, opt, list(dl), loop


LOADER_BATCHES = 16


def _loader_depths(dev):
    """phase_train's loader through ``Accelerator.prepare`` at the default
    ``prefetch_depth`` (2: a producer thread, copies on the loader's side
    stream) and at 0 (synchronous): the batches must be bitwise equal. Two
    timings of each depth, on the host clock: the loader alone (each batch
    consumed by a sum on the device) and phase_train's BERT step fed from
    the loader, one step a batch, the depths taken in turn twice."""
    from accelerate_tpu_torch import Accelerator, DataLoader, DataLoaderConfiguration
    from accelerate_tpu_torch.data_loader import prepare_data_loader
    from accelerate_tpu_torch.utils.operations import stack_batches
    from accelerate_tpu_torch.utils.synthetic import DictDataset, make_synthetic_mrpc

    data = make_synthetic_mrpc(TRAIN_BATCH * LOADER_BATCHES, TRAIN_SEQ, 30522, seed=0)
    runs = {}
    for depth in (2, 0):
        _reset_states()
        acc = Accelerator(mixed_precision="bf16", dataloader_config=DataLoaderConfiguration(
            prefetch_depth=depth))
        dl = acc.prepare(DataLoader(DictDataset(data), batch_size=TRAIN_BATCH))
        check(dl.prefetch_depth == depth, f"[train-loader] prefetch_depth {dl.prefetch_depth}")
        for _ in range(2):  # the second epoch is the timed one
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batches = []
            for b in dl:
                torch.stack([t.float().sum() for t in b.values()]).sum().item()
                batches.append(b)
            wall = time.perf_counter() - t0
        runs[depth] = (batches, 1e3 * wall / len(batches))
    same = all(b2.keys() == b0.keys() and all(torch.equal(b2[k], b0[k]) for k in b0)
               for b2, b0 in zip(runs[2][0], runs[0][0])) and len(runs[2][0]) == len(runs[0][0])
    print(f"[train-loader] {LOADER_BATCHES} batches of {TRAIN_BATCH} x {TRAIN_SEQ} through "
          f"prepare: prefetch_depth 2 {runs[2][1]:.3f} ms a batch on the host, prefetch_depth 0 "
          f"{runs[0][1]:.3f} ms; batches bitwise equal: {same}")
    check(same, "[train-loader] prefetch_depth 2 and 0 gave different batches")

    # the same loader feeding the step: what the thread costs or hides there
    _, params, opt, _, loop = _train_setup(dev, "bf16", 1)
    state = opt.opt_state
    loaders = {depth: prepare_data_loader(DataLoader(DictDataset(data), batch_size=TRAIN_BATCH),
                                          prefetch_depth=depth) for depth in (2, 0)}
    step_ms = {2: [], 0: []}
    for rep in range(3):  # the first round warms both
        for depth, dl in loaders.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            n = 0
            for b in dl:
                params, state, m = loop(params, state, stack_batches([b]))
                n += 1
            torch.cuda.synchronize()
            if rep:
                step_ms[depth].append(1e3 * (time.perf_counter() - t0) / n)
    check(bool(torch.isfinite(m["loss"]).all()), "[train-loader] non-finite loss in the step loop")
    print(f"[train-loader] BERT step fed from the loader, {LOADER_BATCHES} steps an epoch, depths "
          f"in turn: prefetch_depth 2 " + " ".join(f"{x:.3f}" for x in step_ms[2])
          + " ms a step, prefetch_depth 0 " + " ".join(f"{x:.3f}" for x in step_ms[0])
          + f" ms; depth 2 / depth 0 {sum(step_ms[2]) / sum(step_ms[0]):.4f}")
    _reset_states()


def phase_train(dev):
    """The training main path in bf16: one warm call of the K-step loop,
    then TRAIN_CALLS timed calls with the fused counters zeroed before and
    read after; then ``torch.profiler`` over one step. The loader comes
    through ``prepare`` at its default ``prefetch_depth``, held first to
    the synchronous loader (:func:`_loader_depths`)."""
    fa = importlib.import_module("accelerate_tpu_torch.ops.fused_attention")
    from accelerate_tpu_torch.utils.operations import stack_batches

    _loader_depths(dev)
    config, params, opt, batches, loop = _train_setup(dev, "bf16", 4)
    n_params = sum(t.numel() for v in params.values() for e in v.values()
                   for t in (e.values() if isinstance(e, dict) else [e]))
    stacked = stack_batches([batches[i % len(batches)] for i in range(TRAIN_K)])
    state = opt.opt_state
    params, state, m = loop(params, state, stacked)
    losses = [m["loss"]]
    torch.cuda.synchronize()
    fa.fused_attention_fwd.launches = 0
    fa.fused_attention_bwd.launches = 0
    t0 = time.perf_counter()
    for _ in range(TRAIN_CALLS):
        params, state, m = loop(params, state, stacked)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_attention_fwd": fa.fused_attention_fwd.launches,
                "fused_attention_bwd": fa.fused_attention_bwd.launches}
    steps = TRAIN_CALLS * TRAIN_K
    losses = torch.cat(losses).cpu()
    check(bool(torch.isfinite(losses).all()), f"non-finite training loss: {losses.tolist()}")
    for name, count in launches.items():
        check(count == config.n_layers * steps,
              f"{name}: {count} launches in {steps} steps, want {config.n_layers} a step")
    print(f"[train] BERT-base {n_params / 1e6:.1f} M params, bf16 compute / f32 masters, "
          f"batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, attn_impl=fused, adamw({TRAIN_LR:g})")
    print(f"[train] {steps} timed steps in {wall:.3f} s: {steps * TRAIN_BATCH / wall:.1f} "
          f"samples/s, {wall / steps * 1e3:.2f} ms/step")
    print(f"[train] loss over {len(losses)} steps: "
          + " ".join(f"{x:.4f}" for x in losses.tolist()))
    print(f"[train] launches on the main path ({steps} steps): {launches}")
    _profile_step(loop, params, state, stack_batches([batches[0]]), "train-profile", 5)
    _log_read_back(losses.tolist())
    return launches


def _log_read_back(losses):
    """phase_train's losses through ``init_trackers``/``log`` into the JSONL
    tracker, read back from its file: one ``log`` line a step, equal."""
    import tempfile

    from accelerate_tpu_torch import Accelerator

    with tempfile.TemporaryDirectory(prefix="train_log_") as tmp:
        _reset_states()
        acc = Accelerator(device="cuda", project_dir=tmp, log_with="jsonl")
        acc.init_trackers("train", config={"lr": TRAIN_LR, "batch": TRAIN_BATCH})
        for i, loss in enumerate(losses):
            acc.log({"loss": loss}, step=i)
        acc.end_training()
        with open(os.path.join(tmp, "train.jsonl")) as f:
            lines = [json.loads(line) for line in f]
    logged = [line for line in lines if line["_type"] == "log"]
    same = [line["loss"] for line in logged] == losses and [line["step"] for line in logged] \
        == list(range(len(losses)))
    print(f"[train] JSONL tracker: {len(lines)} lines ({len(logged)} log lines, config "
          f"{lines[0].get('lr')!r}); losses read back equal: {same}")
    check(lines[0]["_type"] == "config" and same, f"[train] the JSONL log differs: {lines}")


def _profile_step(loop, params, state, one, tag, n_plain, match=None):
    """Where one step's time goes: device events of one profiled step
    (``one`` is a K=1 batch, or one accumulation window) over the median
    host wall of ``n_plain`` steps run without the profiler (whose host
    cost inflates the wall it watches); the rows whose name holds ``match``
    are printed besides the top ones. Updates ``params``/``state`` in
    place, as every step does."""
    from torch.profiler import ProfilerActivity, profile

    def one_step():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop(params, state, one)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e6

    plain_us = float(np.median([one_step() for _ in range(n_plain)]))
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    prof_us = one_step()
    prof.stop()
    events = prof.key_averages()
    # device events only: a host annotation (``Optimizer.step#AdamW.step``)
    # also shows on the device timeline, spanning kernels counted already
    host_keys = {e.key for e in events if e.device_type != torch.autograd.DeviceType.CUDA}
    rows = [(e.key, e.self_device_time_total, e.count) for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and e.key not in host_keys]
    if not rows:
        print(f"[{tag}] the profiler recorded no device time: busy share not measured")
        return
    device_us = sum(r[1] for r in rows)
    print(f"[{tag}] one step: wall {plain_us / 1e3:.3f} ms ({prof_us / 1e3:.3f} under "
          f"the profiler), device {device_us / 1e3:.3f} ms in {sum(r[2] for r in rows)} device "
          f"events, busy share {device_us / plain_us:.3f}")
    ranked = sorted(rows, key=lambda r: -r[1])
    for key, us, count in ranked[:10]:
        print(f"[{tag}]   {us / 1e3:8.4f} ms  {us / device_us:6.1%}  {count:5d} calls  "
              f"{key[:80]}")
    if match is not None:
        hits = [r for r in ranked if match in r[0].lower()]
        us = sum(r[1] for r in hits)
        print(f"[{tag}] rows naming {match!r}: {us / 1e3:.4f} ms ({us / device_us:.1%}) in "
              f"{sum(r[2] for r in hits)} calls")
        for key, us, count in hits[:5]:
            print(f"[{tag}]   {us / 1e3:8.4f} ms  {count:5d} calls  {key[:80]}")


def phase_train_check(dev):
    """3 steps in f32 from the same init and data, once through the fused
    kernels and once through their plain versions on the card: per-step
    losses and every param leaf's 3-step update compared."""
    k_loss, k_upd, _ = _train_run(dev, "no", plain=False)
    p_loss, p_upd, _ = _train_run(dev, "no", plain=True)
    _compare_runs("train-check", k_loss, k_upd, p_loss, p_upd, TRAIN_RTOL, TRAIN_UPDATE_RTOL,
                  3 * TRAIN_LR)


def _train_run(dev, precision, plain):
    """3 steps from the same init and data (see :func:`_train_setup`),
    through the fused kernels or, with ``plain``, through their plain
    versions on the card. Returns (losses, {leaf: update}, metrics)."""
    fa = importlib.import_module("accelerate_tpu_torch.ops.fused_attention")
    from accelerate_tpu_torch.utils.operations import stack_batches

    config, params, opt, batches, loop = _train_setup(dev, precision, 3)
    init = {name: t.clone() for name, t in _named(params)}
    kernels = (fa.fused_attention_fwd, fa.fused_attention_bwd)
    before = [k.launches for k in kernels]
    if plain:
        fa.fused_attention_fwd = fa.fused_attention_fwd_reference
        fa.fused_attention_bwd = fa.fused_attention_bwd_reference
    try:
        params, _, m = loop(params, opt.opt_state, stack_batches(batches))
        torch.cuda.synchronize()
    finally:
        fa.fused_attention_fwd, fa.fused_attention_bwd = kernels
    launched = [k.launches - b for k, b in zip(kernels, before)]
    want = [0, 0] if plain else [3 * config.n_layers] * 2
    check(launched == want, f"{precision} check ({'plain' if plain else 'kernels'}): fused "
                            f"launches {launched}, want {want}")
    upd = {name: (t - init[name]).float() for name, t in _named(params)}
    return m["loss"].cpu(), upd, {k: v.cpu() for k, v in m.items()}


def _compare_runs(tag, k_loss, k_upd, p_loss, p_upd, loss_tol, upd_tol, bias_tol,
                  what="kernels vs plain attention"):
    """Per-step losses and each leaf's 3-step update, ``what`` (kernels vs
    plain by default); the key bias (zero gradient) within ``bias_tol``."""
    check(bool(torch.isfinite(k_loss).all() and torch.isfinite(p_loss).all()),
          f"{tag}: non-finite loss")
    loss_err = float(((k_loss - p_loss).abs() / p_loss.abs()).max())
    zero_grad = "layers/wk/bias"
    upd_err = {name: float(torch.linalg.vector_norm(a - p_upd[name])
                           / torch.linalg.vector_norm(p_upd[name]))
               for name, a in k_upd.items() if name != zero_grad}
    worst = max(upd_err, key=upd_err.get)
    bias_err = float((k_upd[zero_grad] - p_upd[zero_grad]).abs().max())
    print(f"[{tag}] 3 steps, {what}: losses "
          f"{' '.join(f'{x:.6f}' for x in k_loss.tolist())} vs "
          f"{' '.join(f'{x:.6f}' for x in p_loss.tolist())}; max rel err loss {loss_err:.3e} "
          f"(tol {loss_tol:.0e}); updates: largest rel L2 err {upd_err[worst]:.3e} ({worst}; "
          f"tol {upd_tol:.0e}); {zero_grad} (zero gradient) abs err {bias_err:.3e} "
          f"(bound {bias_tol:.0e})")
    for name in sorted(upd_err, key=upd_err.get, reverse=True)[:4]:
        print(f"[{tag}]   {name}: update rel L2 err {upd_err[name]:.3e}, update max "
              f"{float(p_upd[name].abs().max()):.3e}")
    check(loss_err <= loss_tol, f"{tag} losses: {what} rel err {loss_err} > {loss_tol}")
    check(upd_err[worst] <= upd_tol,
          f"{tag} 3-step update of {worst}: {what} rel L2 err {upd_err[worst]} > "
          f"{upd_tol}")
    check(bias_err <= bias_tol, f"{zero_grad}: {what} {bias_err} > {bias_tol}")


def phase_train_check_fp16(dev):
    """The 3 steps of :func:`phase_train_check` in fp16 with the default
    loss scaler, through the fp16 kernels and through their plain
    versions: the same loss-scale and finite-flag sequences, losses and
    updates within the fp16 bars (TRAIN_FP16_*)."""
    k_loss, k_upd, k_m = _train_run(dev, "fp16", plain=False)
    p_loss, p_upd, p_m = _train_run(dev, "fp16", plain=True)
    print(f"[train-check-fp16] loss scale {k_m['loss_scale'].tolist()} vs "
          f"{p_m['loss_scale'].tolist()}, grads finite {k_m['grads_finite'].tolist()} vs "
          f"{p_m['grads_finite'].tolist()}")
    check(torch.equal(k_m["grads_finite"], p_m["grads_finite"])
          and torch.equal(k_m["loss_scale"], p_m["loss_scale"]),
          "fp16 check: loss-scale decisions differ between kernels and plain versions")
    _compare_runs("train-check-fp16", k_loss, k_upd, p_loss, p_upd, TRAIN_FP16_RTOL,
                  TRAIN_FP16_UPDATE_RTOL, 6 * TRAIN_LR)


def _accum_setup(dev, precision, scaler=None):
    """bench.py's config #3 through ``Accelerator(gradient_accumulation_steps
    =4).prepare`` and ``prepare_train_loop``: BERT-base (S=128, fused
    attention), random f32 master weights from seed 0, ``adamw(2e-5)``, and
    bench.py's ``micro_batch(seed)`` for seeds 0-11 (random ids from
    ``np.random.default_rng(seed)``, all-ones mask). Returns the config,
    params, optimizer, the 12 stacked micro-batches, the first 4 of them
    (one accumulation window) and the loop."""
    from accelerate_tpu_torch import Accelerator, BertConfig, bert_loss, init_bert
    from accelerate_tpu_torch.optimizer import adamw
    from accelerate_tpu_torch.utils.operations import stack_batches

    _reset_states()
    config = dataclasses.replace(BertConfig.base(), max_seq_len=TRAIN_SEQ, attn_impl="fused")
    acc = Accelerator(mixed_precision=precision, gradient_accumulation_steps=ACCUM_STEPS,
                      rng_seed=0, grad_scaler_config=scaler)
    params = init_bert(config, torch.Generator(device=dev).manual_seed(0), device=dev)
    params, opt = acc.prepare(params, adamw(ACCUM_LR))

    def micro_batch(seed):  # bench.py's micro_batch
        r = np.random.default_rng(seed)
        shape = (ACCUM_BATCH, TRAIN_SEQ)
        batch = {"input_ids": r.integers(0, config.vocab_size, shape).astype(np.int32),
                 "attention_mask": np.ones(shape, np.int32),
                 "token_type_ids": np.zeros(shape, np.int32),
                 "labels": r.integers(0, 2, (ACCUM_BATCH,)).astype(np.int32)}
        return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}

    batches = [micro_batch(i) for i in range(ACCUM_K)]
    loop = acc.prepare_train_loop(lambda p, b: bert_loss(p, b, config), opt)
    return (config, params, opt, stack_batches(batches), stack_batches(batches[:ACCUM_STEPS]),
            loop)


def _accum_run(dev, precision, tag):
    """ACCUM_WARM warm calls, then ACCUM_CALLS timed calls of 12 micro-steps
    with the fused counters zeroed before and read after; checks 3 optimizer
    steps a call, 12 launches of each kernel a micro-step and finite
    losses; then profiles one 4-micro-step window. Returns the launches and
    the timed calls' metrics."""
    fa = importlib.import_module("accelerate_tpu_torch.ops.fused_attention")
    config, params, opt, stacked, window, loop = _accum_setup(dev, precision)
    state = opt.opt_state
    for _ in range(ACCUM_WARM):
        params, state, m = loop(params, state, stacked)
    torch.cuda.synchronize()
    fa.fused_attention_fwd.launches = 0
    fa.fused_attention_bwd.launches = 0
    counts, metrics = [opt.step_count], []
    t0 = time.perf_counter()
    for _ in range(ACCUM_CALLS):
        params, state, m = loop(params, state, stacked)
        counts.append(opt.step_count)  # a host count: no device read
        metrics.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"fused_attention_fwd": fa.fused_attention_fwd.launches,
                "fused_attention_bwd": fa.fused_attention_bwd.launches}
    micro = ACCUM_CALLS * ACCUM_K
    metrics = {k: torch.cat([m[k] for m in metrics]).cpu() for k in metrics[0]}
    per_call = [b - a for a, b in zip(counts, counts[1:])]
    check(per_call == [ACCUM_K // ACCUM_STEPS] * ACCUM_CALLS,
          f"{tag}: optimizer steps per call {per_call}, want {ACCUM_K // ACCUM_STEPS} each")
    check(bool(torch.isfinite(metrics["loss"]).all()), f"{tag}: non-finite loss")
    for name, count in launches.items():
        check(count == config.n_layers * micro,
              f"{tag} {name}: {count} launches in {micro} micro-steps, want {config.n_layers} "
              f"a micro-step")
    print(f"[{tag}] BERT-base, {precision} compute / f32 masters, micro-batch {ACCUM_BATCH} x "
          f"seq {TRAIN_SEQ}, accumulation {ACCUM_STEPS}, {ACCUM_K} micro-steps a call, "
          f"attn_impl=fused, adamw({ACCUM_LR:g})")
    print(f"[{tag}] {ACCUM_CALLS} timed calls, {micro} micro-steps in {wall:.3f} s: "
          f"{micro * ACCUM_BATCH / wall:.1f} samples/s, {wall / micro * 1e3:.2f} ms/micro-step; "
          f"optimizer steps a call {per_call} (step_count {opt.step_count})")
    print(f"[{tag}] loss over {micro} micro-steps: "
          + " ".join(f"{x:.4f}" for x in metrics["loss"].tolist()))
    print(f"[{tag}] launches on the main path ({micro} micro-steps): {launches}")
    _profile_step(loop, params, state, window, f"{tag}-profile", 3, match="multi_tensor")
    return launches, metrics


def phase_grad_accum(dev):
    """bench.py's config #3 at full width in bf16 (see _accum_setup)."""
    launches, _ = _accum_run(dev, "bf16", "grad-accum")
    return launches


def _runs(values):
    """[(value, repeat count), ...] of a sequence."""
    out = []
    for x in values:
        if out and out[-1][0] == x:
            out[-1][1] += 1
        else:
            out.append([x, 1])
    return [tuple(r) for r in out]


def phase_fp16(dev):
    """The grad-accum configuration in fp16 with the default
    ``GradScalerConfig``: the loss-scale trajectory and the non-finite
    micro-steps. Then a forced overflow (a scale of FORCED_SCALE, growth
    interval FORCED_INTERVAL), one 4-micro-step window a call: every
    micro-step's scale against the rule (halved exactly when the grads are
    not finite, never below 1; doubled after FORCED_INTERVAL finite
    micro-steps in a row), and the params moved by an overflowed
    boundary once AdamW has moments."""
    from accelerate_tpu_torch import GradScalerConfig
    from accelerate_tpu_torch.optimizer import param_leaves

    launches, m = _accum_run(dev, "fp16", "fp16")
    finite = m["grads_finite"]
    print(f"[fp16] loss scale (value, micro-steps): {_runs(m['loss_scale'].tolist())}; "
          f"non-finite micro-steps {int((~finite).sum())} of {len(finite)}")

    cfg = GradScalerConfig(init_scale=FORCED_SCALE, growth_interval=FORCED_INTERVAL)
    _, params, opt, _, window, loop = _accum_setup(dev, "fp16", cfg)
    state = opt.opt_state
    flags, scales, moved = [], [], []
    for call in range(FORCED_CALLS):
        before = [t.detach().clone() for t in param_leaves(params)]
        params, state, m = loop(params, state, window)
        flags += m["grads_finite"].tolist()
        scales += m["loss_scale"].tolist()
        moved.append(sum(not torch.equal(a, b) for a, b in zip(before, param_leaves(params))))
        check(opt.step_count == call + 1, f"forced overflow: {opt.step_count} optimizer steps "
                                          f"after {call + 1} windows")
    check(not any(flags[:ACCUM_STEPS]),
          f"forced overflow: a scale of {FORCED_SCALE:g} did not overflow every micro-step of "
          f"the first window: {flags[:ACCUM_STEPS]}")
    want, scale, growth = [], cfg.init_scale, 0
    for ok in flags:  # the rule, on the host
        if not ok:
            scale, growth = max(scale * cfg.backoff_factor, 1.0), 0
        elif growth + 1 >= cfg.growth_interval:
            scale, growth = scale * cfg.growth_factor, 0
        else:
            growth += 1
        want.append(scale)
    # an overflowed boundary once AdamW has moments: the scale set back to
    # FORCED_SCALE, one more window overflows on every micro-step and its
    # update still runs, on the zeroed gradients' mean (the first windows'
    # updates ran too, on zero moments, where lr·weight decay = 2e-9 rounds
    # away in f32 and leaves the params as they were)
    opt.loss_scale.fill_(FORCED_SCALE)
    before = [t.detach().clone() for t in param_leaves(params)]
    params, state, m = loop(params, state, window)
    last_flags = m["grads_finite"].tolist()
    last_moved = sum(not torch.equal(a, b) for a, b in zip(before, param_leaves(params)))
    print(f"[fp16-forced] init scale {FORCED_SCALE:g}, growth interval {FORCED_INTERVAL}: "
          f"(finite, scale) runs {_runs(list(zip(flags, scales)))}; param leaves moved per "
          f"window {moved}; scale set back to {FORCED_SCALE:g}: finite {last_flags}, "
          f"{last_moved} param leaves moved, {opt.step_count} optimizer steps")
    check(scales == want, f"forced overflow: scales {scales} break the rule (want {want})")
    check(not all(flags) and any(flags) and len(set(scales)) > 2,
          "forced overflow: the run did not both back off and grow")
    check(not any(last_flags) and last_moved > 0 and opt.step_count == FORCED_CALLS + 1,
          f"forced overflow: the overflowed window did not update the params ({last_flags}, "
          f"{last_moved} leaves moved, {opt.step_count} optimizer steps)")
    return launches


def _packed_segments(rng, rows, seq):
    """Segment ids of ``rows`` rows packed by the port's ``pack_sequences``
    from documents of seeded lengths (seq/16 .. seq/2 tokens)."""
    from accelerate_tpu_torch.utils.packing import pack_sequences

    docs = [np.ones(n, np.int32) for n in rng.integers(seq // 16, seq // 2, 8 * rows)]
    ids, seg = pack_sequences(docs, seq)
    check(ids.shape[0] >= rows, f"packing gave {ids.shape[0]} rows, want {rows}")
    return seg[:rows]


def _flash_inputs(name, dtype, dev, seed):
    """q, k, v, dO of one flash case from a seed; segment ids [B, S] int32
    (packed documents, or all zeros), the config and the lattice."""
    fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
    B, S, H, Hkv, D, window, packed = FLASH_CASES[name]
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)

    q, k, v, do = t(B, S, H, D), t(B, S, Hkv, D), t(B, S, Hkv, D), t(B, S, H, D)
    seg = (torch.from_numpy(_packed_segments(rng, B, S)) if packed
           else torch.zeros(B, S, dtype=torch.int32)).to(dev)
    cfg = fa._FlashConfig(scale=1.0 / math.sqrt(D), causal=name not in FLASH_FULL_CASES,
                          window=window, block_q=128, block_kv=128, h=H, hkv=Hkv,
                          use_seg=packed)
    return q, k, v, do, seg, cfg, fa._block_lattice(seg, cfg)


def _attended_pairs(seg, cfg):
    """(query, key) pairs the mask allows, counted on the card in row chunks."""
    B, S = seg.shape
    kpos = torch.arange(S, device=seg.device)
    pairs = 0
    for r0 in range(0, S, 1024):
        qpos = kpos[r0 : r0 + 1024, None]
        allow = ((kpos[None] <= qpos) | (not cfg.causal))[None]
        if cfg.window is not None:
            allow = allow & (qpos - kpos[None] < cfg.window)
        if cfg.use_seg:
            allow = allow & (seg[:, r0 : r0 + 1024, None] == seg[:, None, :])
        pairs += int(allow.expand(B, -1, -1).sum())
    return pairs


def _flash_bound(name, dtype, pairs, kind):
    """Least time for one call: bytes (each input read once, each output
    written once) over HBM rate vs the products' flops on the attended
    pairs over the type's peak. fwd: q, k, v in, o and lse out, 2 products
    (4·D flops a pair and head). dq: q, k, v, dO, lse, δ in, dq out, 3
    products (QKᵀ, dO Vᵀ, dS K: 6·D). dk/dv: the same inputs, dk and dv out,
    4 products (QKᵀ, dO Vᵀ, Pᵀ dO, dSᵀ Q: 8·D)."""
    B, S, H, Hkv, D, _, packed = FLASH_CASES[name]
    elt = torch.tensor([], dtype=dtype).element_size()
    n_q, n_kv, rows = B * S * H * D, B * S * Hkv * D, B * H * S
    seg_bytes = 4 * B * S if packed else 0
    nbytes, mult = {
        "fwd": ((2 * n_q + 2 * n_kv) * elt + 4 * rows, 4),
        "dq": ((3 * n_q + 2 * n_kv) * elt + 8 * rows, 6),
        "dkdv": ((2 * n_q + 4 * n_kv) * elt + 8 * rows, 8),
    }[kind]
    flops = mult * D * H * pairs
    t_bytes = (nbytes + seg_bytes) / HBM_BYTES_PER_S
    t_ops = flops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _poison_check(dev):
    """Block skipping on the card: NaN in K/V block 0 of the window case,
    which the lattice never walks for q blocks >= 9 (128-row blocks, window
    1024), must leave those rows of the output and of dq bitwise unchanged."""
    fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
    q, k, v, do, seg, cfg, (ids, counts, _, _) = _flash_inputs("window", torch.bfloat16, dev, 99)
    first = 9 * cfg.block_q
    check(bool((ids[:, 9:, 0] > 0).all()) and int(ids[:, 8, 0].max()) == 0,
          "window lattice: q block 9 should be the first to skip kv block 0")

    def run(kk, vv):
        out, lse = fa.flash_attention_fwd(q, kk, vv, seg, ids, counts, cfg)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        return out, fa.flash_attention_dq(q, kk, vv, seg, lse, delta, do, ids, counts, cfg)

    out, dq = run(k, v)
    kbad, vbad = k.clone(), v.clone()
    kbad[:, : cfg.block_kv] = float("nan")
    vbad[:, : cfg.block_kv] = float("nan")
    out_bad, dq_bad = run(kbad, vbad)
    torch.cuda.synchronize()
    check(torch.equal(out[:, first:], out_bad[:, first:]) and
          torch.equal(dq[:, first:], dq_bad[:, first:]),
          "NaN in a skipped K/V block changed rows that never attend it")
    check(bool(torch.isnan(out_bad[:, :first].float()).any()),
          "NaN in K/V block 0 reached no row that attends it: the check sees nothing")
    print(f"[flash] NaN-poisoned K/V block 0 (window {cfg.window}): rows >= {first} of the "
          f"output and dq bitwise unchanged, rows that attend it are NaN")


def phase_flash_kernels(dev):
    """Kernels #1-#3 against their plain versions (out, lse; dq; dk, dv) at
    each of FLASH_CASES, with kernel, plain, bound and SDPA times. The
    yardstick for #1 is one ``scaled_dot_product_attention`` call (causal,
    with the band or the segment mask as a boolean mask where there is
    one, ``enable_gqa``); for #2 and #3, ``torch.autograd.grad`` through
    it less the call itself — the library's one backward call computes dq,
    dk and dv, so the same number stands beside both kernels."""
    fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    _poison_check(dev)
    results = {}
    for name in FLASH_CASES:
        B, S, H, Hkv, D, window, packed = FLASH_CASES[name]
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do, seg, cfg, (ids, counts, idsT, countsT) = _flash_inputs(
                name, dtype, dev, seed=len(results))
            out, lse = fa.flash_attention_fwd(q, k, v, seg, ids, counts, cfg)
            delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
            dq = fa.flash_attention_dq(q, k, v, seg, lse, delta, do, ids, counts, cfg)
            dk, dv = fa.flash_attention_dkdv(q, k, v, seg, lse, delta, do, idsT, countsT, cfg)
            torch.cuda.synchronize()
            ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, seg, ids, counts, cfg)
            ref_dq = fa.flash_attention_dq_reference(q, k, v, seg, lse, delta, do, ids, counts,
                                                     cfg)
            ref_dk, ref_dv = fa.flash_attention_dkdv_reference(q, k, v, seg, lse, delta, do,
                                                               idsT, countsT, cfg)
            errs = {"fwd": _errs([(out, ref_out), (lse, ref_lse)]), "dq": _errs([(dq, ref_dq)]),
                    "dkdv": _errs([(dk, ref_dk), (dv, ref_dv)])}
            for x in (out, lse, dq, dk, dv):
                check(bool(torch.isfinite(x.float()).all()), f"flash {name} {dtype}: non-finite")
            for kind, (_, rel) in errs.items():
                check(rel <= FUSED_RTOL[dtype],
                      f"flash {kind} {name} {dtype}: rel err {rel} > {FUSED_RTOL[dtype]}")
            del ref_out, ref_lse, ref_dq, ref_dk, ref_dv

            # copies of the inputs, together past the 50 MB L2
            per_copy = 4 * q.numel() * q.element_size()
            n = max(2, math.ceil(128e6 / per_copy))
            copies = [tuple(x.clone() for x in (q, k, v, do)) for _ in range(n)]
            saved = []
            for c in copies:
                o, s = fa.flash_attention_fwd(*c[:3], seg, ids, counts, cfg)
                saved.append((s, (c[3].float() * o.float()).sum(-1).transpose(1, 2).contiguous()))
            mask = None
            if packed or window is not None:
                rows = torch.arange(S, device=dev)
                mask = (rows[None, :] <= rows[:, None])[None, None]
                if window is not None:
                    mask = mask & (rows[:, None] - rows[None, :] < window)
                if packed:
                    mask = mask & (seg[:, :, None] == seg[:, None, :])[:, None]
            leaves = [tuple(x.transpose(1, 2).detach().requires_grad_(True) for x in c[:3])
                      for c in copies]
            dos = [c[3].transpose(1, 2) for c in copies]

            def library_fwd(i):
                return sdpa(*leaves[i], attn_mask=mask, is_causal=cfg.causal and mask is None,
                            enable_gqa=True)

            def library_fwd_bwd(i):
                return torch.autograd.grad(library_fwd(i), leaves[i], dos[i])

            def lat_args(i):
                return (*copies[i][:3], seg, saved[i][0], saved[i][1], copies[i][3])

            fns = {
                "fwd": {"ms": lambda i: fa.flash_attention_fwd(*copies[i][:3], seg, ids, counts, cfg),
                        "plain_ms": lambda i: fa.flash_attention_fwd_reference(
                            *copies[i][:3], seg, ids, counts, cfg),
                        "library_ms": library_fwd},
                "dq": {"ms": lambda i: fa.flash_attention_dq(*lat_args(i), ids, counts, cfg),
                       "plain_ms": lambda i: fa.flash_attention_dq_reference(
                           *lat_args(i), ids, counts, cfg)},
                "dkdv": {"ms": lambda i: fa.flash_attention_dkdv(*lat_args(i), idsT, countsT, cfg),
                         "plain_ms": lambda i: fa.flash_attention_dkdv_reference(
                             *lat_args(i), idsT, countsT, cfg)},
            }
            iters = 4
            pairs = _attended_pairs(seg, cfg)
            lib_fwd_bwd = time_ms(library_fwd_bwd, n, iters)
            for kind, kind_fns in fns.items():
                rec = {key: time_ms(fn, n, iters, behind_sleep=key != "plain_ms")
                       for key, fn in kind_fns.items()}
                rec["max_abs_err"], rec["rel_err"] = errs[kind]
                rec["bound_ms"], rec["bound_by"] = _flash_bound(name, dtype, pairs, kind)
                results[(name, kind, dtype)] = rec
            lib_bwd = lib_fwd_bwd - results[(name, "fwd", dtype)]["library_ms"]
            results[(name, "dq", dtype)]["library_ms"] = lib_bwd
            results[(name, "dkdv", dtype)]["library_ms"] = lib_bwd
            for kind in fns:
                rec = results[(name, kind, dtype)]
                print(f"[flash] {kind:4s} {name:10s} {str(dtype):15s} err {rec['max_abs_err']:.3e} "
                      f"(rel {rec['rel_err']:.3e}, tol {FUSED_RTOL[dtype]:.1e}) kernel "
                      f"{rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms sdpa "
                      f"{rec['library_ms']:.4f} ms bound {rec['bound_ms']:.5f} ms "
                      f"({rec['bound_by']}); {pairs} pairs, lattice {int(counts.sum())} of "
                      f"{counts.numel() * ids.shape[-1]} blocks")
            del copies, saved, leaves, dos, mask
    return results


FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkdv")


def _llama_setup(dev, precision, config, factory, dtype=torch.float32, remat=False):
    """``config`` through ``Accelerator.prepare``: random weights from seed 0
    in ``dtype`` (f32 masters, or bf16 params as the JAX benches keep
    them), the optimizer ``factory``. Returns the prepared params,
    optimizer and loop (``llama_loss`` at ``remat``)."""
    from accelerate_tpu_torch import Accelerator, init_llama, llama_loss

    _reset_states()
    acc = Accelerator(mixed_precision=precision, rng_seed=0)
    params = init_llama(config, torch.Generator(device=dev).manual_seed(0), device=dev,
                        dtype=dtype)
    params, opt = acc.prepare(params, factory)
    loop = acc.prepare_train_loop(lambda p, b: llama_loss(p, b, config, remat=remat), opt)
    return params, opt, loop


def _n_params(params) -> int:
    from accelerate_tpu_torch.optimizer import param_leaves

    return sum(t.numel() for t in param_leaves(params))


def _lm_leg(dev, tag, config, batches, precision, factory, dtype, remat, calls, what,
            profile=True):
    """One Llama training leg: ``_llama_setup``, one warm call of the
    K-step loop, then ``calls`` timed calls with the flash counters zeroed
    before and read after and the peak memory reset; then, with
    ``profile``, ``torch.profiler`` over one step. Under remat each layer's
    flash forward runs twice a step (forward and recompute), dq and dk/dv
    once. Returns the launches and the leg's numbers."""
    fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
    K, B, S = batches["input_ids"].shape
    params, opt, loop = _llama_setup(dev, precision, config, factory, dtype, remat)
    state = opt.opt_state
    params, state, m = loop(params, state, batches)
    losses = [m["loss"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in FLASH_KERNELS:
        getattr(fa, kern).launches = 0
    t0 = time.perf_counter()
    for _ in range(calls):
        params, state, m = loop(params, state, batches)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {kern: getattr(fa, kern).launches for kern in FLASH_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    steps = calls * K
    losses = torch.cat(losses).cpu()
    check(bool(torch.isfinite(losses).all()), f"[{tag}] non-finite loss: {losses.tolist()}")
    fwd_a_step = config.n_layers * (2 if remat else 1)
    want = {"flash_attention_fwd": fwd_a_step * steps,
            "flash_attention_dq": config.n_layers * steps,
            "flash_attention_dkdv": config.n_layers * steps}
    check(launches == want, f"[{tag}] launches in {steps} steps {launches}, want {want} "
                            f"({fwd_a_step} forwards a step at remat={remat!r})")
    ms = wall / steps * 1e3
    print(f"[{tag}] {_n_params(params) / 1e6:.1f} M params, dim {config.dim}, "
          f"{config.n_layers} layers, {config.n_heads}/{config.n_kv_heads} heads, ffn "
          f"{config.hidden_dim}, vocab {config.vocab_size}; {what}, batch {B} x seq {S}, "
          f"attn_impl=flash, remat={remat!r}")
    print(f"[{tag}] {steps} timed steps in {wall:.3f} s: {ms:.1f} ms/step, "
          f"{steps * B * S / wall:.1f} tokens/s; peak memory {peak / 2**30:.2f} GiB")
    print(f"[{tag}] loss over {len(losses)} steps: "
          + " ".join(f"{x:.4f}" for x in losses.tolist()))
    print(f"[{tag}] launches on the main path ({steps} steps): {launches}")
    if profile:
        one = {"input_ids": batches["input_ids"][:1]}
        _profile_step(loop, params, state, one, f"{tag}-profile", 2)
    del params, opt, loop, state
    torch.cuda.empty_cache()
    return launches, {"ms": ms, "peak": peak, "losses": losses}


def phase_llama_train(dev):
    """The long-context Llama at full width and depth, two legs: f32
    masters with bf16 compute and ``adamw``, no remat; then the JAX
    bench's own configuration: bf16 params, ``adafactor(1e-4)``, remat
    ``"dots_no_batch"``. Each leg's timed calls read the flash counters: 16
    launches of dq and dk/dv a step, and of the forward 16 or, under
    remat, 32."""
    from accelerate_tpu_torch import LlamaConfig
    from accelerate_tpu_torch.optimizer import adafactor, adamw

    config = LlamaConfig(**LLAMA_KW)
    S = config.max_seq_len
    ids = np.random.default_rng(0).integers(0, config.vocab_size, (LLAMA_K, 1, S))
    batches = {"input_ids": torch.from_numpy(ids.astype(np.int32)).to(dev)}
    launches, masters = _lm_leg(dev, "llama", config, batches, "bf16", adamw(LLAMA_LR),
                                torch.float32, False, LLAMA_CALLS,
                                f"bf16 compute / f32 masters, adamw({LLAMA_LR:g})")
    _, jax_leg = _lm_leg(dev, "llama-jaxcfg", config, batches, "no", adafactor(LLAMA_LR),
                         torch.bfloat16, "dots_no_batch", LLAMA_CALLS,
                         f"bf16 params, adafactor({LLAMA_LR:g})")
    print(f"[llama] step: f32 masters + adamw, no remat {masters['ms']:.1f} ms "
          f"({masters['peak'] / 2**30:.2f} GiB); bf16 params + adafactor + remat "
          f"'dots_no_batch' (the JAX bench's) {jax_leg['ms']:.1f} ms "
          f"({jax_leg['peak'] / 2**30:.2f} GiB)")
    return launches


def _offload_dots_traffic(dev, config, batch):
    """The host traffic of ``remat="offload_dots"`` in one forward and
    backward of ``config`` on ``batch``: the stores of the save mode are
    read through a wrapped ``_HostSaveMode.__init__``, summed after the
    forward (every saved product is on the host then) and after the
    backward (the products the recompute never took back: the backward
    reads no layer's last product, w2's)."""
    from accelerate_tpu_torch import init_llama, llama_loss
    from accelerate_tpu_torch.models import transformer as tt
    from accelerate_tpu_torch.optimizer import param_leaves

    stores = []
    real_init = tt._HostSaveMode.__init__

    def spy(self, saved, store):
        stores.append(store)
        real_init(self, saved, store)

    def held():
        entries = [host for store in stores for e in store.values() for host, _ in e]
        return len(entries), sum(h.numel() * h.element_size() for h in entries)

    params = init_llama(config, torch.Generator(device=dev).manual_seed(0), device=dev,
                        dtype=torch.bfloat16)
    leaves = param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    tt._HostSaveMode.__init__ = spy
    try:
        loss = llama_loss(params, batch, config, remat="offload_dots")
        torch.cuda.synchronize()
        n_sent, sent = held()
        torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        n_unread, unread = held()
    finally:
        tt._HostSaveMode.__init__ = real_init
    B, S = batch["input_ids"].shape
    print(f"[lm774m] offload_dots host traffic, one step at batch {B} x {S}: {n_sent} products, "
          f"{sent / 1e9:.4f} GB to the host; {n_sent - n_unread} back ({(sent - unread) / 1e9:.4f}"
          f" GB); {n_unread} never read back ({unread / 1e9:.4f} GB, "
          f"{unread / n_unread / 1e6:.3f} MB each)")
    check(n_unread == config.n_layers, f"{n_unread} products unread, want one a layer (w2's)")
    del params, leaves, loss
    torch.cuda.empty_cache()


def phase_lm774m(dev):
    """``bench.py``'s config #4 at full width and depth through
    ``prepare_train_loop``: bf16 params from seed 0, ``Accelerator(
    mixed_precision="no")`` (the bench's raw-jit semantics), ``adafactor(
    1e-4)``, flash attention, remat ``"dots_no_batch"``, batch 8 x 512 of
    ``default_rng(0)`` ids; timed, counted and profiled. Then a few steps
    at each of remat ``False``, ``True`` and ``"dots_no_batch"``: peak
    memory must order ``True < "dots_no_batch" < False``, which shows that
    the policies save different sets on the card."""
    from accelerate_tpu_torch import LlamaConfig
    from accelerate_tpu_torch.optimizer import adafactor

    config = LlamaConfig(**LM774M_KW)
    ids = np.random.default_rng(0).integers(0, config.vocab_size,
                                            (LM774M_K, LM774M_BATCH, config.max_seq_len))
    batches = {"input_ids": torch.from_numpy(ids.astype(np.int32)).to(dev)}
    what = f"bf16 params, adafactor({LM774M_LR:g}), mixed_precision='no'"
    launches, lm_ref = _lm_leg(dev, "lm774m", config, batches, "no", adafactor(LM774M_LR),
                               torch.bfloat16, "dots_no_batch", LM774M_CALLS, what)
    ladder, ladder_launches = {}, {}
    for remat in LM774M_REMATS:
        t0 = time.perf_counter()
        ladder_launches[remat], ladder[remat] = _lm_leg(
            dev, f"lm774m-remat-{remat}", config, batches, "no", adafactor(LM774M_LR),
            torch.bfloat16, remat, 1, what, profile=False)
        ladder[remat]["seconds"] = time.perf_counter() - t0
    print("[lm774m] remat ladder: " + "; ".join(
        f"{r!r} {v['ms']:.1f} ms/step, peak {v['peak'] / 2**30:.2f} GiB ({v['seconds']:.1f} s)"
        for r, v in ladder.items()))
    peaks = [ladder[r]["peak"] for r in (True, "dots_no_batch", False)]
    check(peaks[0] < peaks[1] < peaks[2],
          f"peak memory not ordered True < 'dots_no_batch' < False: {peaks}")
    # the same saved set held in pinned host memory: below "dots_no_batch"
    check(ladder["offload_dots"]["peak"] < ladder["dots_no_batch"]["peak"],
          f"remat 'offload_dots' peaks at {ladder['offload_dots']['peak']}, not below "
          f"'dots_no_batch' ({ladder['dots_no_batch']['peak']})")
    _offload_dots_traffic(dev, config, {"input_ids": batches["input_ids"][0]})
    return launches, ladder_launches["offload_dots"], lm_ref


def _named(tree, prefix=""):
    for key, v in tree.items():
        if isinstance(v, dict):
            yield from _named(v, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", v.detach()


def _adafactor_device_check(dev, config):
    """The adafactor update on the card against the same update on the
    CPU: the leaves of ``config`` (a cut depth of config #4) in f32 and in
    bf16, seeded params and gradients, 3 steps, each step's update (the
    chain's output before it is added) compared. f32: within
    ADAFACTOR_F32_RTOL of the leaf's largest update element (another
    summation order in the means, another ``pow``). bf16: both sides round
    every op to bf16 at the same points, but a mean summed in another order
    can round its scalar or row statistic one bf16 ulp apart, and that ulp
    passes through up to five roundings of the update (the two factors,
    their product, the clip and the param scale); each element within
    ADAFACTOR_BF16_ULPS ulps (2**-8 of its magnitude each), each leaf
    within ADAFACTOR_BF16_RTOL relative L2 and bitwise in at least
    ADAFACTOR_BF16_SAME of its elements."""
    from accelerate_tpu_torch import init_llama
    from accelerate_tpu_torch.optimizer import Adafactor

    for dtype in (torch.float32, torch.bfloat16):
        sides = {"cpu": dict(_named(init_llama(config, torch.Generator().manual_seed(3),
                                               device="cpu", dtype=dtype)))}
        sides["gpu"] = {k: v.to(dev, copy=True) for k, v in sides["cpu"].items()}
        opts = {d: Adafactor(list(ps.values()), lr=LM774M_LR) for d, ps in sides.items()}
        rng = np.random.default_rng(4)
        worst = {"rel": 0.0, "l2": 0.0, "ulps": 0.0, "same": 1.0}
        for _ in range(3):
            for k, p in sides["cpu"].items():
                g = torch.from_numpy(rng.standard_normal(p.shape, np.float32)).to(dtype)
                u = {}
                for d, ps in sides.items():
                    opt = opts[d]
                    u[d] = opt._update(ps[k], g.to(ps[k].device), opt.param_groups[0])
                    ps[k].add_(u[d])
                a, b = u["gpu"].cpu().float(), u["cpu"].float()
                diff = (a - b).abs()
                worst["rel"] = max(worst["rel"], float(diff.max() / b.abs().max()))
                worst["l2"] = max(worst["l2"], float(torch.linalg.vector_norm(a - b)
                                                    / torch.linalg.vector_norm(b)))
                worst["ulps"] = max(worst["ulps"], float(
                    (diff / (2.0 ** -8 * b.abs()).clamp_min(1e-30)).max()))
                worst["same"] = min(worst["same"], float((a == b).float().mean()))
        print(f"[lm774m-check] adafactor on the card vs the CPU, {len(sides['cpu'])} leaves of "
              f"{config.n_layers} layers at config #4's width, 3 steps, {dtype}: largest "
              f"update difference {worst['rel']:.3e} of the leaf's largest, {worst['ulps']:.2f} "
              f"bf16 ulps of its own element, {worst['l2']:.3e} relative L2; smallest bitwise "
              f"share of a leaf {worst['same']:.5f}")
        if dtype == torch.float32:
            check(worst["rel"] <= ADAFACTOR_F32_RTOL, f"adafactor f32 card vs CPU: {worst}")
        else:
            check(worst["ulps"] <= ADAFACTOR_BF16_ULPS and worst["l2"] <= ADAFACTOR_BF16_RTOL
                  and worst["same"] >= ADAFACTOR_BF16_SAME,
                  f"adafactor bf16 card vs CPU: {worst}")


def phase_lm774m_check(dev):
    """Config #4's width at LM774M_CHECK_LAYERS layers, 3 f32 steps with
    ``adafactor``: remat ``"dots_no_batch"`` against no remat, both
    through the kernels (losses and each leaf's 3-step update within
    REMAT_RTOL, and whether they are bitwise equal); then the kernels
    against their plain versions at remat ``"dots_no_batch"``, as
    ``phase_llama_train_check``; then the adafactor update on the card
    against the CPU."""
    from accelerate_tpu_torch import LlamaConfig
    fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
    from accelerate_tpu_torch.optimizer import adafactor

    config = LlamaConfig(**{**LM774M_KW, "n_layers": LM774M_CHECK_LAYERS})
    ids = np.random.default_rng(1).integers(0, config.vocab_size,
                                            (3, LM774M_CHECK_BATCH, config.max_seq_len))
    batches = {"input_ids": torch.from_numpy(ids.astype(np.int32)).to(dev)}

    def run(remat, plain):
        params, opt, loop = _llama_setup(dev, "no", config, adafactor(LM774M_LR),
                                         remat=remat)
        init = {name: t.clone() for name, t in _named(params)}
        kernels = [getattr(fa, kern) for kern in FLASH_KERNELS]
        before = [kern.launches for kern in kernels]
        if plain:
            for kern in FLASH_KERNELS:
                setattr(fa, kern, getattr(fa, f"{kern}_reference"))
        try:
            params, _, m = loop(params, opt.opt_state, batches)
            torch.cuda.synchronize()
        finally:
            for kern, fn in zip(FLASH_KERNELS, kernels):
                setattr(fa, kern, fn)
        launched = [kern.launches - b for kern, b in zip(kernels, before)]
        L = 3 * config.n_layers
        want = [0] * 3 if plain else [L * (2 if remat else 1), L, L]
        check(launched == want, f"lm774m f32 check (remat={remat!r}, "
                                f"{'plain' if plain else 'kernels'}): flash launches "
                                f"{launched}, want {want}")
        return m["loss"].cpu(), {name: t - init[name] for name, t in _named(params)}

    r_loss, r_upd = run("dots_no_batch", plain=False)
    n_loss, n_upd = run(False, plain=False)
    check(bool(torch.isfinite(r_loss).all() and torch.isfinite(n_loss).all()),
          "non-finite lm774m f32 loss")
    loss_err = float(((r_loss - n_loss).abs() / n_loss.abs()).max())
    upd_err = {name: float(torch.linalg.vector_norm(a - n_upd[name])
                           / torch.linalg.vector_norm(n_upd[name])) for name, a in r_upd.items()}
    worst = max(upd_err, key=upd_err.get)
    bitwise = torch.equal(r_loss, n_loss) and all(torch.equal(a, n_upd[k])
                                                  for k, a in r_upd.items())
    print(f"[lm774m-check] {LM774M_CHECK_LAYERS} layers at config #4's width, batch "
          f"{LM774M_CHECK_BATCH} x {config.max_seq_len}, f32, adafactor, 3 steps, remat "
          f"'dots_no_batch' vs none: losses {' '.join(f'{x:.6f}' for x in r_loss.tolist())}; "
          f"max rel err loss {loss_err:.3e}, largest update rel L2 err {upd_err[worst]:.3e} "
          f"({worst}; tol {REMAT_RTOL:.0e}); bitwise equal: {bitwise}")
    check(loss_err <= REMAT_RTOL and upd_err[worst] <= REMAT_RTOL,
          f"remat 'dots_no_batch' vs none: loss {loss_err}, {worst} {upd_err[worst]}")
    o_loss, o_upd = run("offload_dots", plain=False)
    loss_err = float(((o_loss - n_loss).abs() / n_loss.abs()).max())
    upd_err = {name: float(torch.linalg.vector_norm(a - n_upd[name])
                           / torch.linalg.vector_norm(n_upd[name])) for name, a in o_upd.items()}
    worst = max(upd_err, key=upd_err.get)
    bitwise = torch.equal(o_loss, r_loss) and all(torch.equal(a, r_upd[k])
                                                  for k, a in o_upd.items())
    print(f"[lm774m-check] remat 'offload_dots' vs none: max rel err loss {loss_err:.3e}, "
          f"largest update rel L2 err {upd_err[worst]:.3e} ({worst}; tol {REMAT_RTOL:.0e}); "
          f"bitwise equal to 'dots_no_batch': {bitwise}")
    check(loss_err <= REMAT_RTOL and upd_err[worst] <= REMAT_RTOL,
          f"remat 'offload_dots' vs none: loss {loss_err}, {worst} {upd_err[worst]}")
    p_loss, p_upd = run("dots_no_batch", plain=True)
    loss_err = float(((r_loss - p_loss).abs() / p_loss.abs()).max())
    upd_err = {name: float(torch.linalg.vector_norm(a - p_upd[name])
                           / torch.linalg.vector_norm(p_upd[name])) for name, a in r_upd.items()}
    worst = max(upd_err, key=upd_err.get)
    print(f"[lm774m-check] remat 'dots_no_batch', kernels vs plain attention: max rel err loss "
          f"{loss_err:.3e} (tol {TRAIN_RTOL:.0e}); largest update rel L2 err "
          f"{upd_err[worst]:.3e} ({worst}; tol {TRAIN_UPDATE_RTOL:.0e})")
    check(loss_err <= TRAIN_RTOL, f"lm774m f32 losses: kernels vs plain rel err {loss_err}")
    check(upd_err[worst] <= TRAIN_UPDATE_RTOL,
          f"lm774m f32 3-step update of {worst}: kernels vs plain rel L2 err {upd_err[worst]}")
    _adafactor_device_check(dev, config)


def phase_llama_train_check(dev):
    """3 f32 steps of the same width at LLAMA_CHECK_LAYERS layers on packed
    rows, once through the flash kernels and once through their plain
    versions on the card: per-step losses and every param leaf's 3-step
    update compared."""
    from accelerate_tpu_torch import LlamaConfig
    fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
    from accelerate_tpu_torch.optimizer import adamw

    config = LlamaConfig(**{**LLAMA_KW, "n_layers": LLAMA_CHECK_LAYERS,
                            "max_seq_len": LLAMA_CHECK_SEQ})
    rng = np.random.default_rng(1)
    shape = (3, LLAMA_CHECK_BATCH, LLAMA_CHECK_SEQ)
    seg = np.stack([_packed_segments(rng, LLAMA_CHECK_BATCH, LLAMA_CHECK_SEQ) for _ in range(3)])
    ids = np.where(seg > 0, rng.integers(1, config.vocab_size, shape), 0)
    batches = {"input_ids": torch.from_numpy(ids.astype(np.int32)).to(dev),
               "segment_ids": torch.from_numpy(seg).to(dev)}

    def run(plain):
        params, opt, loop = _llama_setup(dev, "no", config, adamw(LLAMA_LR))
        init = {name: t.clone() for name, t in _named(params)}
        kernels = [getattr(fa, kern) for kern in FLASH_KERNELS]
        before = [kern.launches for kern in kernels]
        if plain:
            for kern in FLASH_KERNELS:
                setattr(fa, kern, getattr(fa, f"{kern}_reference"))
        try:
            params, _, m = loop(params, opt.opt_state, batches)
            torch.cuda.synchronize()
        finally:
            for kern, fn in zip(FLASH_KERNELS, kernels):
                setattr(fa, kern, fn)
        launched = [kern.launches - b for kern, b in zip(kernels, before)]
        want = [0] * 3 if plain else [3 * config.n_layers] * 3
        check(launched == want, f"Llama f32 check ({'plain' if plain else 'kernels'}): flash "
                                f"launches {launched}, want {want}")
        return m["loss"].cpu(), {name: t - init[name] for name, t in _named(params)}

    k_loss, k_upd = run(plain=False)
    p_loss, p_upd = run(plain=True)
    check(bool(torch.isfinite(k_loss).all() and torch.isfinite(p_loss).all()),
          "non-finite Llama f32 loss")
    loss_err = float(((k_loss - p_loss).abs() / p_loss.abs()).max())
    upd_err = {name: float(torch.linalg.vector_norm(a - p_upd[name])
                           / torch.linalg.vector_norm(p_upd[name]))
               for name, a in k_upd.items()}
    worst = max(upd_err, key=upd_err.get)
    print(f"[llama-check] {LLAMA_CHECK_LAYERS} layers, {LLAMA_CHECK_BATCH} packed rows x "
          f"{LLAMA_CHECK_SEQ} ({int(seg.max())} documents in a row at most), f32, 3 steps, "
          f"kernels vs plain attention: losses {' '.join(f'{x:.6f}' for x in k_loss.tolist())} vs "
          f"{' '.join(f'{x:.6f}' for x in p_loss.tolist())}; max rel err loss {loss_err:.3e} "
          f"(tol {TRAIN_RTOL:.0e}); updates: largest rel L2 err {upd_err[worst]:.3e} ({worst}; "
          f"tol {TRAIN_UPDATE_RTOL:.0e})")
    check(loss_err <= TRAIN_RTOL, f"Llama f32 losses: kernels vs plain rel err {loss_err}")
    check(upd_err[worst] <= TRAIN_UPDATE_RTOL,
          f"Llama f32 3-step update of {worst}: kernels vs plain rel L2 err {upd_err[worst]}")


# bench.py's config #2 (run_bench_resnet, bench.py:338-402) as written:
# ResNet-50, 1000 classes, 192 x 192, batch 64, bf16 params, sgd(0.1,
# momentum=0.9), one fixed batch of default_rng(0) pixels and labels; 1
# warm-up and 20 timed steps through Accelerator.prepare and
# prepare_train_step (examples/cv_example.py's entry). At this learning
# rate the loss on one fixed batch first climbs and then falls, in the JAX
# package as in the port (tests/test_torch_resnet.py::
# test_fixed_batch_loss_climbs_then_falls): the check is that it falls
# below half its peak within the 20 steps.
RESNET_BATCH, RESNET_SIDE, RESNET_STEPS = 64, 192, 20
# One f32 step on the card against the same step on the CPU, on the first
# RESNET_CHECK_ROWS rows of the batch, each held to the same step in f64 on
# the CPU: each leaf's update (-0.1 x its gradient; momentum starts at 0)
# in relative L2 norm. A random ResNet-50's f32 gradients are themselves
# ill-conditioned: the CPU's f32 step lies up to ~7e-3 from the f64 step on
# a leaf (GroupNorm scales and early convs). The card's f32 step (TF32 off,
# this script's setting) must lie within RESNET_F32_SLACK times the CPU's
# largest f32 distance; with cuDNN's TF32 on (PyTorch's default for
# convolutions: inputs rounded to a 10-bit mantissa, 2**-11 relative) it
# must miss that bar, or the check could not see the precision.
RESNET_CHECK_ROWS, RESNET_F32_SLACK = 8, 3.0
# T5-small's published widths (T5Config.small(): vocab 32128, d_model 512,
# 6+6 layers, 8 heads, d_ff 2048, 32 buckets, max distance 128) on
# examples/seq2seq_example.py's recipe at batch 32 x 512 source / 128
# target tokens of default_rng(0), adam(1e-4), bf16 mixed precision, K=4
# steps a prepare_train_loop call; then t5_greedy_generate of 32 tokens at
# batch 32.
T5_BATCH, T5_SRC, T5_TGT, T5_K, T5_LR, T5_GEN_NEW = 32, 512, 128, 4, 1e-4, 32
# f32 logits on the card against the port on the CPU (2 rows, TF32 off):
# another order of f32 sums through 12 layers, logits of magnitude ~5.
T5_LOGIT_ATOL = 1e-3
# The greedy leg runs t5-small's widths with an untied head (an lm_head,
# as T5 v1.1 keeps it; weights from seed 1): at random weights the tied
# head maps a decoder state back onto its own input's embedding, so greedy
# repeats the start token and a token check sees nothing. At least
# T5_MIN_DISTINCT of the generated tokens must be distinct. Each greedy
# token is held to the logits of the same params over the finished rows in
# one decoder call (t5_decode, the teacher-forced path), which the greedy
# loop's re-run of each prefix must reproduce: in f32 every token is the
# argmax or within T5_LOGIT_ATOL of it (another order of f32 sums); in
# bf16 at least T5_BF16_SAME of them are the argmax (the two paths' GEMMs
# have other row counts, so a sum may round another way, and T5's
# unscaled attention, logits of std ~8 at this init, carries a one-ulp
# change far). bf16 against f32 is printed and held to no bar: on this
# random model the unscaled attention makes them different functions (the
# leg prints how far their logits part). Two faults planted in the greedy
# loop (T5_FAULTS, see _t5_fault) must miss both bars.
T5_MIN_DISTINCT, T5_BF16_SAME = 0.25, 0.9
T5_FAULTS = ("stale", "no-encoder")
# The config #5 model (CONFIG_KW) with 8 experts, top-2 (Mixtral-8x7B's
# routing: num_local_experts 8, num_experts_per_tok 2) and JAX's default
# capacity factor 1.25: 3.25 B params, 6.5 GB in bf16. Legs: greedy at
# batch 8 x 128 + 64 tokens; phase_engine's requests through the engine; 2
# training steps (after one warm-up) in config #4's recipe (bf16 params,
# adafactor(1e-4), remat "dots_no_batch", flash) at batch 4 x 512. Bytes:
# params 6.5 GB, gradients 6.5 GB, adafactor's factored moments < 0.1 GB,
# the saved projections and layer inputs ~0.5 GB, one layer's recomputed
# experts and the f32 logits ~1 GB: about 15 GB, so no depth is cut.
MOE_KW = dict(CONFIG_KW, moe_experts=8, moe_top_k=2, moe_capacity_factor=1.25)
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_CALLS, MOE_LR = 4, 512, 2, 1e-4
# f32 forward on the card against the CPU at the model's width, cut to its
# first MOE_CHECK_LAYERS layers (2 rows x 64 tokens, TF32 off): another
# order of f32 sums, and the same routing unless two router probabilities
# lie within that noise.
MOE_CHECK_LAYERS, MOE_CHECK_ATOL = 2, 1e-3
# Greedy bf16 tokens against the f32 cached path on the same rows: a
# token is the f32 argmax, or a near-tie within GEN_F32_BAR, or sits
# where bf16 rounding moved a router decision (a second and a third
# expert within the rounding of the hidden state swap places, and that
# token's FFN output changes by O(1)); at most MOE_F32_MISS of the
# tokens may be neither. Each planted cache fault (GEN_FAULTS) must miss
# that bar, and a tighter one in f32: the cached forward against the full
# forward within LOGIT_ATOL, both at a capacity factor of E / top_k (no
# token dropped, so routing is the same in both).
MOE_F32_MISS = 0.05
MOE_ENGINE_F32_REQUESTS, MOE_ENGINE_F32_NEW = 3, 16


def _card_step(params, batch, dev, loss_fn, factory):
    """One step of ``loss_fn`` through ``Accelerator.prepare_train_step``
    on ``dev`` from ``params`` (copied there): ``(loss, {leaf: update})``."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.utils.modeling import named_parameters

    _reset_states()
    acc = Accelerator(device=dev)
    start = {k: v.detach().to(dev, copy=True) for k, v in named_parameters(params).items()}
    p, opt = acc.prepare(params, factory)
    step = acc.prepare_train_step(loss_fn, opt)
    _, _, m = step(p, opt.opt_state, {k: v.to(dev) for k, v in batch.items()})
    upd = {k: (v.detach() - start[k]).cpu() for k, v in named_parameters(p).items()}
    return float(m["loss"]), upd


def _update_errs(got, want):
    """Relative L2 error of each leaf's update, and the worst leaf."""
    errs = {k: float((got[k] - want[k]).norm() / want[k].norm().clamp_min(1e-30))
            for k in want}
    return errs, max(errs, key=errs.get)


def phase_resnet(dev):
    """``bench.py``'s config #2 on the card through the Accelerator; then
    the f32 step against the CPU. Returns the leg's numbers."""
    from accelerate_tpu_torch import Accelerator, ResNetConfig, init_resnet, resnet_loss
    from accelerate_tpu_torch.optimizer import param_leaves, sgd

    t_phase = time.perf_counter()
    config = ResNetConfig.resnet50(num_classes=1000)
    rng = np.random.default_rng(0)
    pixels = rng.normal(size=(RESNET_BATCH, RESNET_SIDE, RESNET_SIDE, 3)).astype(np.float32)
    labels = rng.integers(0, config.num_classes, (RESNET_BATCH,))
    batch = {"pixels": torch.from_numpy(pixels).to(dev, torch.bfloat16),
             "labels": torch.from_numpy(labels).to(dev)}
    _reset_states()
    acc = Accelerator(rng_seed=0)
    params = init_resnet(config, torch.Generator(device=dev).manual_seed(0), device=dev,
                         dtype=torch.bfloat16)
    n_params = sum(t.numel() for t in param_leaves(params))
    params, opt = acc.prepare(params, sgd(0.1, momentum=0.9))
    step = acc.prepare_train_step(lambda p, b: resnet_loss(p, b, config), opt)
    state = opt.opt_state
    params, state, m = step(params, state, batch)
    losses = [m["loss"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(RESNET_STEPS):
        params, state, m = step(params, state, batch)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = torch.stack(losses).float().cpu()
    check(bool(torch.isfinite(losses).all()), f"[resnet] non-finite loss: {losses.tolist()}")
    peak_loss = float(losses.max())
    check(float(losses[-1]) < 0.5 * peak_loss,
          f"[resnet] the loss did not turn down within {RESNET_STEPS} steps on one batch: "
          f"{losses.tolist()}")
    ms = wall / RESNET_STEPS * 1e3
    print(f"[resnet] config #2: ResNet-50 ({n_params / 1e6:.3f} M params, bf16, GroupNorm "
          f"{config.groups}), {config.num_classes} classes, batch {RESNET_BATCH} x "
          f"{RESNET_SIDE}^2, sgd(0.1, momentum=0.9), channels-last convolutions (cuDNN)")
    print(f"[resnet] {RESNET_STEPS} timed steps in {wall:.3f} s: {ms:.2f} ms/step, "
          f"{RESNET_STEPS * RESNET_BATCH / wall:.1f} images/s; peak memory "
          f"{peak / 2**30:.2f} GiB")
    print("[resnet] loss over the warm-up and timed steps: "
          + " ".join(f"{x:.4f}" for x in losses.tolist()))
    _profile_step(lambda p, s, b: step(p, s, b), params, state, batch, "resnet-profile", 3)
    del params, opt, state, step
    torch.cuda.empty_cache()

    # one f32 step on the card (TF32 off, then cuDNN's TF32 on) and on the
    # CPU, each against the CPU's f64 step
    f32 = init_resnet(config, torch.Generator(device=dev).manual_seed(1), device=dev)
    rows = {"pixels": torch.from_numpy(pixels[:RESNET_CHECK_ROWS]),
            "labels": torch.from_numpy(labels[:RESNET_CHECK_ROWS])}

    def loss_fn(p, b):
        return resnet_loss(p, b, config)

    def one_step(params, device, dtype=torch.float32):
        batch = {"pixels": rows["pixels"].to(dtype), "labels": rows["labels"]}
        return _card_step(_tree_to(params, dtype), batch, device, loss_fn,
                          sgd(0.1, momentum=0.9))

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    ref_loss, ref = one_step(f32, cpu, torch.float64)
    cpu_loss, cpu_upd = one_step(f32, cpu)
    cpu_s = time.perf_counter() - t0
    card_loss, card_upd = one_step(f32, dev)
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_loss, tf32_upd = one_step(f32, dev)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    (cpu_errs, cpu_w), (errs, worst), (tf32_errs, tf32_w) = (
        _update_errs({k: v.double() for k, v in u.items()}, ref)
        for u in (cpu_upd, card_upd, tf32_upd))
    bar = RESNET_F32_SLACK * cpu_errs[cpu_w]
    print(f"[resnet-check] one step, {RESNET_CHECK_ROWS} rows, each against the CPU's f64 step "
          f"(loss {ref_loss:.6f}; {cpu_s:.1f} s on the CPU): worst leaf update rel L2 err CPU "
          f"f32 {cpu_errs[cpu_w]:.3e} ({cpu_w}), card f32 {errs[worst]:.3e} ({worst}; bar "
          f"{bar:.3e}, TF32 off), card with cuDNN TF32 {tf32_errs[tf32_w]:.3e} ({tf32_w}; must "
          f"exceed the bar); losses {cpu_loss:.6f} / {card_loss:.6f} / {tf32_loss:.6f}")
    check(errs[worst] <= bar, f"[resnet-check] card f32 update of {worst}: {errs[worst]} > {bar}")
    check(tf32_errs[tf32_w] > bar,
          f"[resnet-check] the TF32 step is within the f32 bar ({tf32_errs[tf32_w]} <= {bar})")
    del f32
    torch.cuda.empty_cache()
    print(f"[resnet] phase seconds {time.perf_counter() - t_phase:.1f}")
    return {"ms": ms, "images_per_s": RESNET_STEPS * RESNET_BATCH / wall, "peak": peak}


def phase_t5(dev):
    """T5-small on ``examples/seq2seq_example.py``'s recipe: K-step
    ``prepare_train_loop`` calls in bf16 mixed precision with ``adam``,
    then greedy decoding at the same widths with an untied head, each
    greedy token held to one decoder call over its rows (see
    T5_MIN_DISTINCT), beside two planted faults; f32 logits on the card
    against the CPU."""
    from accelerate_tpu_torch import (
        Accelerator,
        T5Config,
        init_t5,
        t5_decode,
        t5_encode,
        t5_forward,
        t5_greedy_generate,
        t5_loss,
    )
    from accelerate_tpu_torch.optimizer import adam, param_leaves
    from accelerate_tpu_torch.utils.operations import stack_batches

    t_phase = time.perf_counter()
    config = T5Config.small()
    rng = np.random.default_rng(0)
    V = config.vocab_size

    def batch():
        tgt = rng.integers(2, V, (T5_BATCH, T5_TGT))
        dec_in = np.concatenate([np.zeros((T5_BATCH, 1), np.int64), tgt[:, :-1]], axis=1)
        return {"input_ids": torch.from_numpy(rng.integers(2, V, (T5_BATCH, T5_SRC))),
                "decoder_input_ids": torch.from_numpy(dec_in),
                "labels": torch.from_numpy(tgt)}

    batches = {k: v.to(dev) for k, v in stack_batches([batch() for _ in range(T5_K)]).items()}
    _reset_states()
    acc = Accelerator(mixed_precision="bf16", rng_seed=0)
    params = init_t5(config, torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = sum(t.numel() for t in param_leaves(params))
    params, opt = acc.prepare(params, adam(T5_LR))
    loop = acc.prepare_train_loop(lambda p, b: t5_loss(p, b, config), opt)
    state = opt.opt_state
    params, state, m = loop(params, state, batches)
    losses = [m["loss"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, state, m = loop(params, state, batches)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses.append(m["loss"])
    peak = torch.cuda.max_memory_allocated()
    losses = torch.cat(losses).cpu()
    check(bool(torch.isfinite(losses).all()), f"[t5] non-finite loss: {losses.tolist()}")
    ms = wall / T5_K * 1e3
    print(f"[t5] T5Config.small(): {n_params / 1e6:.2f} M params (f32 masters, bf16 compute), "
          f"batch {T5_BATCH} x {T5_SRC} source / {T5_TGT} target tokens, adam({T5_LR:g})")
    print(f"[t5] {T5_K} timed steps in {wall:.3f} s: {ms:.2f} ms/step, "
          f"{T5_K * T5_BATCH / wall:.1f} samples/s; peak memory {peak / 2**30:.2f} GiB")
    print("[t5] loss over 2 calls: " + " ".join(f"{x:.4f}" for x in losses.tolist()))
    one = {k: v[:1] for k, v in batches.items()}
    _profile_step(loop, params, state, one, "t5-profile", 2)

    src = batches["input_ids"][0]
    gen_config = dataclasses.replace(config, tie_word_embeddings=False)
    gen32 = init_t5(gen_config, torch.Generator(device=dev).manual_seed(1), device=dev)
    gen16 = _tree_to(gen32, torch.bfloat16)
    t5_greedy_generate(gen16, src[:, :16], gen_config, max_new_tokens=2)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = t5_greedy_generate(gen16, src, gen_config, max_new_tokens=T5_GEN_NEW)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    check(ids.shape == (T5_BATCH, 1 + T5_GEN_NEW) and bool((ids >= 0).all())
          and bool((ids < V).all()), f"[t5] bad greedy ids {ids.shape}")
    print(f"[t5] t5_greedy_generate bf16 (untied head), batch {T5_BATCH} x {T5_SRC} source, "
          f"{T5_GEN_NEW} new tokens in {gen_s:.3f} s: {T5_BATCH * T5_GEN_NEW / gen_s:.1f} tokens/s")

    def logits_of(p, rows):
        with torch.no_grad():
            return t5_decode(p, rows[:, :-1], t5_encode(p, src, gen_config), gen_config).float()

    def held(ids16, ids32):
        """bf16 tokens' argmax share, f32 tokens' largest gap, the smaller
        distinct share of the two streams."""
        share = float((_t5_gaps(logits_of(gen16, ids16), ids16) == 0).float().mean())
        worst = float(_t5_gaps(logits_of(gen32, ids32), ids32).max())
        distinct = min(len(torch.unique(x[:, 1:])) for x in (ids16, ids32)) / ids16[:, 1:].numel()
        return share, worst, distinct

    ids32 = t5_greedy_generate(gen32, src, gen_config, max_new_tokens=T5_GEN_NEW)
    same, worst, distinct = held(ids, ids32)
    print(f"[t5] greedy tokens vs one decoder call over their rows: bf16 {same:.4f} the argmax "
          f"(bar {T5_BF16_SAME}), f32 largest gap {worst:.3e} (bar {T5_LOGIT_ATOL:.0e}); distinct "
          f"share {distinct:.4f} (bar {T5_MIN_DISTINCT})")
    check(distinct >= T5_MIN_DISTINCT, f"[t5] greedy streams of {distinct} distinct tokens")
    check(worst <= T5_LOGIT_ATOL, f"[t5] an f32 greedy token's logit is {worst} below the maximum")
    check(same >= T5_BF16_SAME, f"[t5] only {same} of bf16 greedy tokens are the argmax")
    l16, l32 = logits_of(gen16, ids), logits_of(gen32, ids)
    gap = _t5_gaps(l32, ids)
    print(f"[t5] bf16 greedy tokens under the f32 logits of their rows (no bar): "
          f"{float((gap == 0).float().mean()):.4f} the f32 argmax, largest gap "
          f"{float(gap.max()):.4f}; bf16 and f32 logits part by up to "
          f"{float((l16 - l32).abs().max()):.4f} (max |logit| {float(l32.abs().max()):.3f}); "
          f"{int((ids == ids32).all(-1).sum())} of {T5_BATCH} rows the same stream in both")
    del l16, l32
    for fault in T5_FAULTS:
        with _t5_fault(fault):
            bad = [t5_greedy_generate(p, src, gen_config, max_new_tokens=T5_GEN_NEW)
                   for p in (gen16, gen32)]
        b_same, b_worst, b_distinct = held(*bad)
        print(f"[t5] planted fault {fault!r}: bf16 {b_same:.4f} the argmax (bar {T5_BF16_SAME}), "
              f"f32 largest gap {b_worst:.4f} (bar {T5_LOGIT_ATOL:.0e}); distinct share "
              f"{b_distinct:.4f}")
        check(b_same < T5_BF16_SAME and b_worst > T5_LOGIT_ATOL,
              f"[t5] planted fault {fault!r} within a bar: too loose")
    del gen16, gen32
    f32 = _tree_to(params, dev)
    rows = {k: v[0, :2] for k, v in batches.items()}
    cpu = torch.device("cpu")
    with torch.no_grad():
        card = t5_forward(f32, rows, config).cpu()
        host = t5_forward(_tree_to(f32, cpu), {k: v.cpu() for k, v in rows.items()}, config)
    err = float((card - host).abs().max())
    print(f"[t5-check] f32 logits, 2 rows, card vs CPU: max abs err {err:.3e} (tol "
          f"{T5_LOGIT_ATOL:.0e}, max |logit| {float(host.abs().max()):.3f})")
    check(err <= T5_LOGIT_ATOL, f"[t5-check] f32 logits card vs CPU: {err}")
    del params, opt, loop, state, f32
    torch.cuda.empty_cache()
    print(f"[t5] phase seconds {time.perf_counter() - t_phase:.1f}")
    return {"ms": ms, "samples_per_s": T5_K * T5_BATCH / wall,
            "tokens_per_s": T5_BATCH * T5_GEN_NEW / gen_s}


def _t5_gaps(logits, ids):
    """How far each greedy token of ``ids [B, 1 + T]`` lies below the
    maximum of its row of ``logits [B, T, V]`` (0 where it is the argmax)."""
    chosen = ids[:, 1:]
    return (logits.max(-1).values - logits.gather(-1, chosen[..., None])[..., 0]).cpu()


@contextlib.contextmanager
def _t5_fault(fault):
    """A fault planted in ``t5_greedy_generate``'s loop, for the greedy
    checks' negative control: ``"stale"`` takes each step's token from the
    row before the last (an off-by-one: the prediction for the position
    just written); ``"no-encoder"`` decodes against a zeroed encoder
    output."""
    from accelerate_tpu_torch.models import t5

    real = t5.t5_decode

    def decode(params, ids, enc_out, config, enc_mask=None):
        if fault == "stale":
            out = real(params, ids, enc_out, config, enc_mask)
            return out[:, :-1] if ids.shape[1] > 1 else out
        return real(params, ids, torch.zeros_like(enc_out), config, enc_mask)

    t5.t5_decode = decode
    try:
        yield
    finally:
        t5.t5_decode = real


@contextlib.contextmanager
def _count_drops(store):
    """Count the routed and dropped token-choices of every MoE call over
    more than one token position (prefill chunks, full forwards) into
    ``store`` (device tensors; under a mesh, this rank's rows), from the
    routing each call computes."""
    from accelerate_tpu_torch.parallel import moe

    real = moe.route

    def route(router_kernel, x, *args, **kwargs):
        r = real(router_kernel, x, *args, **kwargs)
        if x.shape[1] > 1:
            store["routed"] = store.get("routed", 0) + r.keep.numel()
            store["dropped"] = store.get("dropped", 0) + (~r.keep).sum()
        return r

    moe.route = route
    try:
        yield store
    finally:
        moe.route = real


def _drop_share(store) -> float:
    return float(store["dropped"]) / max(int(store["routed"]), 1)


def phase_moe(dev):
    """The config #5 model with 8 experts, top-2: greedy generation, the
    serving engine and 2 training steps, each with its checks. Returns the
    launches of the engine leg (#6/#7) and of the training leg (#1-#3)."""
    from accelerate_tpu_torch import (
        LlamaConfig,
        ServingEngine,
        draft_config,
        draft_params,
        greedy_generate,
        init_llama,
        llama_forward,
    )
    from accelerate_tpu_torch.optimizer import adafactor

    t_phase = time.perf_counter()
    config = LlamaConfig(**MOE_KW)
    params = init_llama(config, torch.Generator(device=dev).manual_seed(0), device=dev,
                        dtype=torch.bfloat16)
    n_params = _n_params(params)
    print(f"[moe] config #5 model with {config.moe_experts} experts, top-{config.moe_top_k}, "
          f"capacity factor {config.moe_capacity_factor}: {n_params / 1e9:.3f} B params "
          f"({2 * n_params / 1e9:.2f} GB in bf16), ffn {config.hidden_dim} an expert")

    # f32 forward at the model's width, first layers, card vs CPU
    cut = draft_config(config, MOE_CHECK_LAYERS)
    f32_cut = _to_f32(draft_params(params, MOE_CHECK_LAYERS))
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, config.vocab_size, (2, 64)))
    with torch.no_grad():
        card = llama_forward(f32_cut, ids.to(dev), cut, attention_impl="xla").cpu()
        host = llama_forward(_tree_to(f32_cut, torch.device("cpu")), ids, cut,
                             attention_impl="xla")
    err = float((card - host).abs().max())
    print(f"[moe-check] f32 forward, {MOE_CHECK_LAYERS} layers at full width, 2 x 64 tokens, card "
          f"vs CPU: max abs logit err {err:.3e} (tol {MOE_CHECK_ATOL:.0e}, max |logit| "
          f"{float(host.abs().max()):.3f})")
    check(err <= MOE_CHECK_ATOL, f"[moe-check] f32 forward card vs CPU: {err}")
    del f32_cut

    # leg 1: greedy generation at config #5's shapes
    prompt = np.random.default_rng(0).integers(0, config.vocab_size,
                                               (GEN_BATCH, GEN_PROMPT)).astype(np.int32)
    tokens, stats = greedy_generate(params, prompt, config, max_new_tokens=GEN_NEW,
                                    return_stats=True, warmup=True)
    check(tokens.shape == (GEN_BATCH, GEN_PROMPT + GEN_NEW)
          and (tokens[:, GEN_PROMPT:] < config.vocab_size).all(), "[moe] bad greedy tokens")
    # the same decode at GEN_SHORT_NEW new tokens: phase_moe_ep's reference
    short = greedy_generate(params, prompt, config, max_new_tokens=GEN_SHORT_NEW)
    drops = {}
    with _count_drops(drops):
        greedy_generate(params, prompt, config, max_new_tokens=1)
    print(f"[moe-generate] batch {GEN_BATCH} x {GEN_PROMPT} prompt tokens, {GEN_NEW} new: "
          f"prefill_seconds {stats['prefill_seconds']:.4f}, decode_tokens_per_sec "
          f"{stats['decode_tokens_per_sec']:.1f}, seconds_per_token "
          f"{stats['seconds_per_token']:.5f}; prefill token-choices dropped by capacity "
          f"{_drop_share(drops):.4f} ({int(drops['dropped'])} of {int(drops['routed'])})")
    f32 = _to_f32(params)
    logits = _generate_logits(f32, config, tokens, GEN_PROMPT, dev)
    gap = _token_gaps(logits, tokens, GEN_PROMPT)
    near = [(int(r), int(t), float(gap[r, t])) for r, t in torch.nonzero(gap > 0).tolist()]
    for r, t, g in near[:12]:
        print(f"[moe-generate]   not the f32 argmax: row {r} token {t}: bf16 chose "
              f"{int(tokens[r, GEN_PROMPT + t])}, f32 argmax {int(logits[r, t].argmax())}, f32 "
              f"logit gap {g:.4f}")
    miss = float((gap > GEN_F32_BAR).float().mean())
    print(f"[moe-generate] greedy bf16 tokens vs the f32 cached path on their rows: "
          f"{gap.numel() - len(near)} of {gap.numel()} are the f32 argmax, "
          f"{int((gap > GEN_F32_BAR).sum())} lie more than {GEN_F32_BAR} below it (share "
          f"{miss:.4f}, bar {MOE_F32_MISS}); largest gap {float(gap.max()):.4f}")
    check(miss <= MOE_F32_MISS, f"[moe-generate] {miss} of greedy tokens off the f32 argmax")
    # the cached path in f32 against the full forward, both at a factor
    # that drops no token (E / top_k), over the first GEN_SHORT_NEW rows
    nodrop = dataclasses.replace(config,
                                 moe_capacity_factor=config.moe_experts / config.moe_top_k)
    rows = tokens[:, :GEN_PROMPT + GEN_SHORT_NEW]
    full = _f32_logits(f32, nodrop, rows, GEN_PROMPT, dev)
    err = float((_generate_logits(f32, nodrop, rows, GEN_PROMPT, dev) - full).abs().max())
    print(f"[moe-generate] cached forward in f32 vs the f32 full forward, capacity factor "
          f"{nodrop.moe_capacity_factor:g} (no drops), {rows.shape[0]} x {rows.shape[1]} tokens: "
          f"max abs logit err {err:.3e} (tol {LOGIT_ATOL:.0e}, max |logit| "
          f"{float(full.abs().max()):.3f})")
    check(err <= LOGIT_ATOL, f"[moe-generate] cached vs full forward: {err} > {LOGIT_ATOL}")
    for fault in GEN_FAULTS:
        with _planted_fault(fault):
            bad_err = float((_generate_logits(f32, nodrop, rows, GEN_PROMPT, dev) - full)
                            .abs().max())
            bad = greedy_generate(params, prompt, config, max_new_tokens=GEN_SHORT_NEW)
        bad_gap = _token_gaps(_generate_logits(f32, config, bad, GEN_PROMPT, dev), bad, GEN_PROMPT)
        bad_miss = float((bad_gap > GEN_F32_BAR).float().mean())
        print(f"[moe-generate] planted fault {fault!r}: cached f32 logits err {bad_err:.3e} (tol "
              f"{LOGIT_ATOL:.0e}); {int((bad_gap > GEN_F32_BAR).sum())} of {bad_gap.numel()} "
              f"greedy tokens more than {GEN_F32_BAR} below the f32 argmax (share "
              f"{bad_miss:.4f}, token bar {MOE_F32_MISS}); largest gap {float(bad_gap.max()):.4f}")
        check(bad_err > LOGIT_ATOL and bad_miss > MOE_F32_MISS,
              f"[moe-generate] planted fault {fault!r} within a bar ({bad_err} <= {LOGIT_ATOL} "
              f"or {bad_miss} <= {MOE_F32_MISS}): too loose")
    del f32, logits, full
    torch.cuda.empty_cache()

    # leg 2: phase_engine's requests through the serving engine (#6, #7);
    # then the same requests once more, untimed, with the drops counted
    engine_launches = phase_engine(params, config, dev, tag="moe-engine")
    prompts = _engine_prompts(config)
    engine = ServingEngine(params, config, **ENGINE_KW)
    for p in prompts:
        engine.submit(p, ENGINE_NEW)
    drops = {}
    with _count_drops(drops):
        engine.run()
    print(f"[moe-engine] prefill token-choices dropped by capacity {_drop_share(drops):.4f} "
          f"({int(drops['dropped'])} of {int(drops['routed'])}, padded rows of a chunk routed "
          f"with it)")
    f32 = _to_f32(params)
    streams = []
    for _ in range(2):
        eng = ServingEngine(f32, config, cache_dtype=torch.float32, **ENGINE_KW)
        rs = [eng.submit(p, MOE_ENGINE_F32_NEW) for p in prompts[:MOE_ENGINE_F32_REQUESTS]]
        eng.run()
        streams.append([r.output_ids().tolist() for r in rs])
    check(streams[0] == streams[1], "[moe-engine] two f32 engine runs gave different streams")
    print(f"[moe-engine] f32 params and cache, {MOE_ENGINE_F32_REQUESTS} requests x "
          f"{MOE_ENGINE_F32_NEW} tokens, run twice: the same streams")
    del f32, engine
    torch.cuda.empty_cache()

    # leg 3: training in config #4's recipe (#1-#3), at the attention shape
    # phase_flash_kernels held them to their plain versions
    train_cfg = dataclasses.replace(config, max_seq_len=MOE_TRAIN_SEQ, attn_impl="flash")
    check(FLASH_CASES["moe_train"] == (MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, config.n_heads,
                                       config.n_kv_heads, config.head_dim, None, False),
          "FLASH_CASES['moe_train'] is not the training leg's shape")
    tids = np.random.default_rng(0).integers(0, config.vocab_size,
                                             (1, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ))
    del params
    torch.cuda.empty_cache()
    train_launches, leg = _lm_leg(
        dev, "moe-train", train_cfg, {"input_ids": torch.from_numpy(tids.astype(np.int32)).to(dev)},
        "no", adafactor(MOE_LR), torch.bfloat16, "dots_no_batch", MOE_TRAIN_CALLS,
        f"bf16 params, adafactor({MOE_LR:g}), {config.moe_experts} experts top-"
        f"{config.moe_top_k}")
    leg["greedy_short"] = short
    print(f"[moe] phase seconds {time.perf_counter() - t_phase:.1f}")
    return engine_launches, train_launches, leg


# ------------------------------------------------------- more than one process --
def phase_mesh_ops(dev):
    """The port's ``PartialState`` from a torchrun-style environment (``RANK``,
    ``WORLD_SIZE=1``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT`` on a
    free localhost port) joins an NCCL process group of one; every
    collective of ``utils.operations`` runs on CUDA tensors through it and
    is checked against its one-process answer; the fused ZeRO-1 update's
    self check and a 64 MiB gather are timed. The group stays up for
    ``phase_fsdp_lm``."""
    import socket

    from accelerate_tpu_torch.parallel import weight_update
    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.utils import operations as ops

    _reset_states()
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        state = PartialState()
        join_s = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(state.backend == "nccl" and state.num_processes == 1
          and state.device == torch.device("cuda", 0),
          f"PartialState from the torchrun environment: {state!r}")
    print(f"[mesh-ops] {state!r}: joined in {join_s:.2f} s")
    ops.reset_comm_counters()
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(8, 16, device=dev, generator=gen)
    tree = {"x": x, "ids": torch.arange(5, device=dev, dtype=torch.int32), "flag": x > 0,
            "scalar": x.sum()}

    def same(a, b):
        return all(ta.device.type == "cuda" and torch.equal(ta.reshape(tb.shape), tb)
                   for ta, tb in zip(_leaves(a), _leaves(b)))

    results = {
        "gather": same(ops.gather(tree), tree),
        "gather_object": ops.gather_object(("rank", 0)) == [("rank", 0)],
        "broadcast": same(ops.broadcast(tree), tree),
        "broadcast_object_list": ops.broadcast_object_list([{"a": 1}]) == [{"a": 1}],
        "reduce_sum": same(ops.reduce(x, "sum"), x),
        "reduce_mean": same(ops.reduce(x, "mean"), x),
        "reduce_scale": same(ops.reduce(x, "sum", scale=2.0), 2 * x),
        "pad_across_processes": same(ops.pad_across_processes(x, dim=0), x),
        "pad_input_tensors": same(ops.pad_input_tensors(x[:7], 7, 2),
                                  torch.cat([x[:7], x[6:7]])),
        "slice_tensors": same(ops.slice_tensors(tree["x"], slice(0, 3)), x[:3]),
        "concatenate": same(ops.concatenate([{"x": x}, {"x": x}]), {"x": torch.cat([x, x])}),
        "find_batch_size": ops.find_batch_size(tree) == 8,
        "ignorant_find_batch_size": ops.ignorant_find_batch_size([{}]) is None,
        "gather_across_data_parallel_groups": same(
            ops.gather_across_data_parallel_groups(x), x),
        "avg_losses_across_data_parallel_group": same(
            ops.avg_losses_across_data_parallel_group([x.sum(), x.mean()]),
            torch.stack([x.sum(), x.mean()])),
        "data_structure": [tuple(t.shape) for t in _leaves(ops.initialize_tensors(
            ops.get_data_structure(tree)))] == [tuple(t.shape) for t in _leaves(tree)],
    }
    bad = [k for k, ok in results.items() if not ok]
    check(not bad, f"collectives on the NCCL group of one disagree with one process: {bad}")
    zero1 = weight_update.self_check(device="cuda")
    check(zero1["parity_max_abs_delta"] <= 1e-6,
          f"fused ZeRO-1 self check: {zero1}")
    big = torch.randn(MESH_OPS_GATHER_MB * 2 ** 18, device=dev, generator=gen)
    gather_ms = time_ms(lambda i: ops.gather(big), 1, 10, behind_sleep=False)
    counters = ops.get_comm_counters()
    print(f"[mesh-ops] {len(results)} collectives and helpers on CUDA tensors agree with one "
          f"process; fused ZeRO-1 self check {zero1}")
    print(f"[mesh-ops] gather of {MESH_OPS_GATHER_MB} MiB through NCCL at world size 1: "
          f"{gather_ms:.3f} ms; counters {counters}")
    return {"gather_ms": gather_ms}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def phase_fsdp_lm(dev, lm_ref):
    """Config #4 at full width and depth through ``Accelerator(
    parallelism_config=ParallelismConfig(dp_shard_size=world))`` on the
    process group of ``phase_mesh_ops``, ``prepare`` and
    ``prepare_train_step`` with ``llama_loss(mesh=...)``: the K-step calls
    of ``phase_lm774m`` as single steps (one warm call, then timed ones),
    whose losses must be its losses; ms/step beside its, flash launches
    counted. A world of one leaves every axis at size 1, so the plan must
    be the plain step. The process group is closed after it."""
    from accelerate_tpu_torch import Accelerator, LlamaConfig, init_llama, llama_loss
    fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
    from accelerate_tpu_torch.optimizer import adafactor
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState

    world = PartialState().num_processes
    AcceleratorState._reset_state()
    GradientState._reset_state()
    config = LlamaConfig(**LM774M_KW)
    ids = np.random.default_rng(0).integers(0, config.vocab_size,
                                            (LM774M_K, LM774M_BATCH, config.max_seq_len))
    batches = torch.from_numpy(ids.astype(np.int32)).to(dev)
    acc = Accelerator(mixed_precision="no", rng_seed=0,
                      parallelism_config=ParallelismConfig(dp_shard_size=world))
    params = init_llama(config, torch.Generator(device=dev).manual_seed(0), device=dev,
                        dtype=torch.bfloat16)
    params, opt = acc.prepare(params, adafactor(LM774M_LR))
    check(not acc.sharding_plan.distributed,
          f"a mesh of one process must run the plain step: {acc.mesh}")
    step = acc.prepare_train_step(
        lambda p, b: llama_loss(p, b, config, remat="dots_no_batch", mesh=acc.mesh), opt)
    state, losses = opt.opt_state, []

    def call():
        nonlocal params, state
        for k in range(LM774M_K):
            params, state, m = step(params, state, {"input_ids": batches[k]})
            losses.append(m["loss"])

    call()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in FLASH_KERNELS:
        getattr(fa, kern).launches = 0
    t0 = time.perf_counter()
    for _ in range(LM774M_CALLS):
        call()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {kern: getattr(fa, kern).launches for kern in FLASH_KERNELS}
    steps = LM774M_CALLS * LM774M_K
    want = {"flash_attention_fwd": 2 * config.n_layers * steps,
            "flash_attention_dq": config.n_layers * steps,
            "flash_attention_dkdv": config.n_layers * steps}
    check(launches == want, f"[fsdp-lm] launches in {steps} steps {launches}, want {want}")
    got = torch.stack(losses).float().cpu()
    ref = lm_ref["losses"].float()
    check(got.shape == ref.shape, f"[fsdp-lm] {got.shape[0]} losses, phase_lm774m {ref.shape[0]}")
    err = float(((got - ref).abs() / ref.abs()).max())
    ms = wall / steps * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"[fsdp-lm] config #4 through ParallelismConfig(dp_shard_size={world}) on the NCCL "
          f"group: {acc.parallelism_config.describe(world)}; {steps} timed steps "
          f"{ms:.1f} ms/step (phase_lm774m's loop {lm_ref['ms']:.1f} ms/step), peak "
          f"{peak / 2**30:.2f} GiB; launches {launches}")
    print(f"[fsdp-lm] losses " + " ".join(f"{v:.4f}" for v in got.tolist())
          + f"; max rel err against phase_lm774m {err:.3e} (envelope {FSDP_LM_RTOL:g})")
    check(err <= FSDP_LM_RTOL, f"[fsdp-lm] losses differ from phase_lm774m's by {err}")
    del params, opt, step, state
    torch.cuda.empty_cache()
    PartialState().destroy_process_group()
    _reset_states()
    return launches, {"ms": ms, "peak": peak, "err": err}


@contextlib.contextmanager
def _mesh_fault(fault):
    """A fault planted in the sharded step, for the two-process bars'
    negative control: ``"tp2_summed_over_tp"`` sums the gradient of every
    param gathered whole and split over ``tp`` (the embedding, the head)
    over ``tp`` too (the ranks there hold the same gradient, so it comes out
    ``tp`` times too large);
    ``"dp_shard2_not_divided"`` builds the step as if one rank held the
    batch, so the gradients summed over the batch ranks are not divided by
    their count (the loss the step reports is still averaged)."""
    from accelerate_tpu_torch.parallel import sharding

    if fault is None:
        yield
        return
    if fault == "tp2_summed_over_tp":
        owner, name = sharding._Layout, "scatter_grad"
        real = owner.scatter_grad

        def patched(self, grad):
            out = real(self, grad)
            return out * self.mesh.shape["tp"] if any("tp" in axes for _, axes in self.dims) \
                else out
    else:
        owner, name = sharding.ShardingPlan, "batch_ranks"
        real = owner.batch_ranks
        patched = property(lambda self: 1)
    setattr(owner, name, patched)
    try:
        yield
    finally:
        setattr(owner, name, real)


def _mesh_2rank_leg(dev, config, pc_kwargs, zero1, tp_rules, options=None, ref_updates=None,
                    updates: bool = True, fault=None, save_updates=None):
    """``MESH_2RANK_STEPS`` f32 AdamW steps of ``config`` through a mesh of
    the running processes (or of none): the losses, global gradient norms,
    flash launches, peak memory, optimizer-state bytes, the bytes the
    step's collectives moved, the gather's ms, and with ``updates`` each
    leaf's 3-step update (or, given ``ref_updates``, its relative L2 error
    against them). ``fault`` plants one of :func:`_mesh_fault`'s: in the
    step's build for ``"dp_shard2_not_divided"``, in its run for the
    other. ``options``: ``env`` (set around ``prepare``) and ``fp16``
    (mixed precision with ``MESH_2RANK_FP16_SCALER``, plain attention; the
    loss scales and finite flags are returned), ``prepare_rules`` (pass
    ``llama_shard_rules()`` to ``prepare``), ``factory`` (``"adafactor"``
    for ``adafactor(MESH_2RANK_LR)``), ``comm_hook`` (a
    ``DistributedDataParallelKwargs`` handler), ``offload`` (the optimizer
    state on the host; its groups a step are returned), ``attention``
    (the loss's attention from ``Accelerator.context_parallel_attention()``,
    the mesh's cp or sp split of the sequence). ``save_updates`` is a path
    the updates are also saved to."""
    from accelerate_tpu_torch import Accelerator, LlamaConfig, init_llama, llama_loss
    from accelerate_tpu_torch import llama_shard_rules
    from accelerate_tpu_torch.data_loader import GlobalBatchAssembler
    fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
    from accelerate_tpu_torch.optimizer import adafactor, adamw
    from accelerate_tpu_torch.parallel.sharding import _map_with_path, llama_tp_rules
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.state import AcceleratorState, GradientState
    from accelerate_tpu_torch.utils import operations as ops
    from accelerate_tpu_torch.utils.dataclasses import (
        DeepSpeedPlugin,
        DistributedDataParallelKwargs,
        GradScalerConfig,
    )
    from accelerate_tpu_torch.utils.environment import patch_environment

    options = options or {}
    fp16 = options.get("fp16", False)
    AcceleratorState._reset_state()
    GradientState._reset_state()
    hook = options.get("comm_hook")
    factory = (adafactor if options.get("factory") == "adafactor" else adamw)(MESH_2RANK_LR)
    with patch_environment(**options.get("env", {})):
        acc = Accelerator(mixed_precision="fp16" if fp16 else "no", rng_seed=0, device=dev,
                          parallelism_config=ParallelismConfig(**pc_kwargs),
                          deepspeed_plugin=DeepSpeedPlugin(zero_stage=1) if zero1 else None,
                          shard_rules=llama_tp_rules() if tp_rules else None,
                          kwargs_handlers=[DistributedDataParallelKwargs(comm_hook=hook)]
                          if hook else None,
                          grad_scaler_config=GradScalerConfig(**MESH_2RANK_FP16_SCALER)
                          if fp16 else None)
        init = init_llama(config, torch.Generator(device=dev).manual_seed(0), device=dev)
        params, opt = acc.prepare(init, factory, shard_rules=(
            llama_shard_rules() if options.get("prepare_rules") else None))
    plan = acc.sharding_plan
    impl = "xla" if fp16 else None  # the flash kernels take bf16 and f32
    attention_fn = acc.context_parallel_attention() if options.get("attention") else None
    with _mesh_fault(fault if fault == "dp_shard2_not_divided" else None):
        step = acc.prepare_train_step(
            lambda p, b: llama_loss(p, b, config, mesh=acc.mesh, attention_impl=impl,
                                    attention_fn=attention_fn), opt,
            compute_grad_norm=True, offload_optimizer=options.get("offload", False))
    ids = np.random.default_rng(0).integers(
        0, config.vocab_size, (MESH_2RANK_STEPS, MESH_2RANK_BATCH, config.max_seq_len))
    assembler = GlobalBatchAssembler(acc.mesh, device=dev)
    state, losses, norms, scales, finite = opt.opt_state, [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_comm_counters()
    for kern in FLASH_KERNELS:
        getattr(fa, kern).launches = 0
    t0 = time.perf_counter()
    with _mesh_fault(fault if fault == "tp2_summed_over_tp" else None):
        for k in range(MESH_2RANK_STEPS):
            batch = assembler.to_global(
                assembler.local_block({"input_ids": ids[k].astype(np.int32)}))
            params, state, m = step(params, state, batch)
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
            if fp16:
                scales.append(m["loss_scale"])
                finite.append(m["grads_finite"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {kern: getattr(fa, kern).launches for kern in FLASH_KERNELS}
    comm = {op: c["bytes"] for op, c in ops.get_comm_counters().items()}
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    full = plan.gather_params_no_grad(params) if plan.distributed else params
    torch.cuda.synchronize()
    gather_ms = (time.perf_counter() - t0) * 1e3
    out = {"losses": [float(v) for v in losses], "grad_norms": [float(v) for v in norms],
           "launches": launches, "peak": peak,
           "opt_state_bytes": opt.state_bytes(), "comm_bytes": comm,
           "ms": wall / MESH_2RANK_STEPS * 1e3, "gather_ms": gather_ms,
           "fused_zero1": opt.zero1 is not None, "zero1_rows": opt.zero1_rows is not None,
           "sharded": plan.sharded, "loss_scale": [float(v) for v in scales],
           "grads_finite": [bool(v) for v in finite],
           "max_live_layers": plan.layer_stats.get("max_live_layers"),
           "device_state_bytes": opt.device_state_bytes(),
           "offload_groups": None if opt.offload is None else
           opt.offload.stats["groups"] // max(opt.offload.stats["steps"], 1)}
    if updates:
        final, start = {}, {}
        _map_with_path(lambda path, a: final.__setitem__(path, a), full)
        _map_with_path(lambda path, a: start.__setitem__(path, a), init)
        upd = {k: final[k].detach().float() - start[k].float() for k in final}
        if save_updates is not None:
            torch.save({k: v.cpu() for k, v in upd.items()}, save_updates)
        if ref_updates is None:
            out["updates"] = {k: v.cpu() for k, v in upd.items()}
        else:
            out["update_err"] = {k: float(torch.linalg.vector_norm(v - ref_updates[k].to(dev))
                                          / torch.linalg.vector_norm(ref_updates[k].to(dev)))
                                 for k, v in upd.items()}
    del params, opt, step, state, full, init
    torch.cuda.empty_cache()
    return out


def _bert_tp_leg(dev, pc_kwargs=None):
    """phase_train's recipe (BERT-base, S=128, fused attention, bf16 compute
    over f32 masters, adamw(TRAIN_LR), batch 32 from the prepared loader)
    for 3 steps, through a mesh of the running processes with
    ``prepare(..., shard_rules=bert_shard_rules())`` when ``pc_kwargs`` is
    given: the losses, each leaf's 3-step update (whole params) and the
    fused launches."""
    from accelerate_tpu_torch import (
        Accelerator,
        BertConfig,
        DataLoader,
        bert_loss,
        bert_shard_rules,
        init_bert,
    )
    fa = importlib.import_module("accelerate_tpu_torch.ops.fused_attention")
    from accelerate_tpu_torch.optimizer import adamw
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.state import AcceleratorState, GradientState
    from accelerate_tpu_torch.utils.operations import stack_batches
    from accelerate_tpu_torch.utils.synthetic import DictDataset, make_synthetic_mrpc

    AcceleratorState._reset_state()
    GradientState._reset_state()
    config = dataclasses.replace(BertConfig.base(), max_seq_len=TRAIN_SEQ, attn_impl="fused")
    acc = Accelerator(mixed_precision="bf16", rng_seed=0, device=dev,
                      parallelism_config=ParallelismConfig(**(pc_kwargs or {})))
    data = make_synthetic_mrpc(TRAIN_BATCH * 3, TRAIN_SEQ, config.vocab_size, seed=0)
    init = init_bert(config, torch.Generator(device=dev).manual_seed(0), device=dev)
    params, opt, dl = acc.prepare(init, adamw(TRAIN_LR),
                                  DataLoader(DictDataset(data), batch_size=TRAIN_BATCH),
                                  shard_rules=bert_shard_rules() if pc_kwargs else None)
    loop = acc.prepare_train_loop(lambda p, b: bert_loss(p, b, config), opt)
    kernels = (fa.fused_attention_fwd, fa.fused_attention_bwd)
    for k in kernels:
        k.launches = 0
    params, _, m = loop(params, opt.opt_state, stack_batches(list(dl)))
    torch.cuda.synchronize()
    full = acc.sharding_plan.gather_params_no_grad(params)
    start = dict(_named(init))
    upd = {name: (t.detach() - start[name]).float().cpu() for name, t in _named(full)}
    out = {"losses": m["loss"].float().cpu(), "updates": upd,
           "launches": {k.__name__: k.launches for k in kernels},
           "sharded": acc.sharding_plan.sharded}
    del params, opt, loop, full, init
    torch.cuda.empty_cache()
    return out


def mesh_2rank_child(tmp: str) -> int:
    """One of ``phase_mesh_2rank``'s two processes (``chip_smoke.py
    --mesh-2rank-child <dir>``): joins the gloo group of two on ``cuda:0``
    through the ``FileStore`` in ``dir``, runs every leg, and writes its
    numbers to ``dir/rank<i>.json``."""
    from accelerate_tpu_torch import LlamaConfig

    state = _join_two(tmp)
    config = LlamaConfig(**MESH_2RANK_KW)
    refs = {}
    if state.is_main_process:
        refs = {kind: torch.load(os.path.join(tmp, f"ref_updates_{kind}.pt"))
                for kind in MESH_2RANK_REFS}
    report = {}
    names = {leg[0] for leg in MESH_2RANK_LEGS}
    # legs held to another leg: both save their updates for the parent
    paired = {opts["ref"] for *_, opts in MESH_2RANK_LEGS if opts.get("ref") in names}
    for name, pc_kwargs, zero1, tp_rules, options in MESH_2RANK_LEGS:
        kind = options.get("ref", "fp16" if options.get("fp16") else "f32")
        save = state.is_main_process and (name in paired or kind in names)
        out = _mesh_2rank_leg(state.device, config, pc_kwargs, zero1, tp_rules, options,
                              refs.get(kind), updates=state.is_main_process,
                              save_updates=os.path.join(tmp, f"updates_{name}.pt") if save
                              else None)
        out.pop("updates", None)
        report[name] = out
    legs = {leg[0]: leg[1:] for leg in MESH_2RANK_LEGS}
    report["faults"] = {fault: _mesh_2rank_leg(state.device, config, *legs[leg], refs.get("f32"),
                                               updates=state.is_main_process, fault=fault)
                        for fault, leg in MESH_2RANK_FAULTS}
    report["fp8"] = _mesh_2rank_fp8_leg(state.device, config, {"dp_replicate_size": 2}, True)
    bert = _bert_tp_leg(state.device, {"tp_size": 2})
    if state.is_main_process:
        torch.save({"losses": bert["losses"], "updates": bert["updates"]},
                   os.path.join(tmp, "bert_tp2.pt"))
    report["bert_tp2"] = {"launches": bert["launches"], "sharded": bert["sharded"]}
    return _leave_two(state, tmp, report)


def _join_two(tmp: str):
    """A child of :func:`_run_two`: the gloo group of two on ``cuda:0``."""
    from accelerate_tpu_torch.state import PartialState

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return PartialState(device="cuda:0", backend="gloo")


def _leave_two(state, tmp: str, report: dict) -> int:
    with open(os.path.join(tmp, f"rank{state.process_index}.json"), "w") as f:
        json.dump(report, f)
    state.wait_for_everyone()
    state.destroy_process_group()
    return 0


def _run_two(flag: str, tmp: str, tag: str, timeout_s: float) -> list:
    """Start this script twice (``flag tmp``) as the two ranks of a gloo
    group on the one card, wait for both (killing them past ``timeout_s``)
    and return each rank's ``rank<i>.json``."""
    procs = []
    try:
        for i in range(2):
            env = {k: v for k, v in os.environ.items()
                   if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                                "MASTER_PORT")}
            env.update({"ACCELERATE_COORDINATOR_ADDRESS": f"file://{tmp}/store",
                        "ACCELERATE_NUM_PROCESSES": "2", "ACCELERATE_PROCESS_ID": str(i),
                        "ACCELERATE_LOCAL_PROCESS_INDEX": "0",
                        "ACCELERATE_INITIALIZATION_TIMEOUT": "300"})
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), flag, tmp],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout_s
        failed = []
        for i, proc in enumerate(procs):
            try:
                out, _ = proc.communicate(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                raise SmokeFailure(f"[{tag}] process {i} still running after {timeout_s} s")
            if proc.returncode != 0:
                failed.append(f"--- process {i} exited {proc.returncode}:\n{out[-4000:]}")
        check(not failed, f"[{tag}] " + "\n".join(failed))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    ranks = []
    for i in range(2):
        with open(os.path.join(tmp, f"rank{i}.json")) as f:
            ranks.append(json.load(f))
    return ranks


def phase_mesh_2rank(dev):
    """Two processes on the one card over gloo: each of ``MESH_2RANK_LEGS``
    (dp_shard 2; tp 2 with ``llama_tp_rules``; dp_replicate 2 with fused
    ZeRO-1, and with ZeRO-1 by annotation; dp_shard 2 under fp16; adafactor
    on dp_replicate 2, with and without ZeRO-1; dp_shard 2 with the bf16
    comm hook; dp_shard 2 with its optimizer state on the host; cp 2 with
    the zig-zag ring and ``llama_shard_rules``, FSDP over cp; sp 2 with
    Ulysses) runs 3 steps, held to a one-process run of the same steps here
    (``MESH_2RANK_REFS``: losses, gradient norms, updates; the fp16 leg to
    a one-process fp16 run, with its loss-scale and finite-flag sequences
    equal) or to another leg (ZeRO-1 adafactor to adafactor without it,
    with less state a rank; the offloaded leg bitwise to dp_shard 2);
    flash #1-#3 must launch
    on each rank of every leg but the fp16 and sp 2 ones (5 a layer under
    cp 2: the zig-zag blocks), at the shapes
    ``FLASH_CASES`` held them to their plain versions; each AdamW ZeRO-1 leg must
    hold half the AdamW moments on each rank; each of
    ``MESH_2RANK_FAULTS`` must fail a bar. Per-rank peak memory,
    optimizer-state bytes, collective bytes and the gather's ms are
    printed. Also BERT-base in phase_train's recipe under tp 2
    (:func:`_bert_tp_leg`), held to one process with #4/#5 on each rank.
    Returns each Llama leg's launches per rank, and the BERT leg's."""
    import tempfile

    from accelerate_tpu_torch import LlamaConfig

    config = LlamaConfig(**MESH_2RANK_KW)
    # phase_flash_kernels held #1-#3 to their plain versions at each rank's shape
    for case, rows, seq in (("mesh_2rank", MESH_2RANK_BATCH, config.max_seq_len),
                            ("mesh_2rank_b1", MESH_2RANK_BATCH // 2, config.max_seq_len),
                            ("cp2_half", MESH_2RANK_BATCH, config.max_seq_len // 4),
                            ("cp2_half_full", MESH_2RANK_BATCH, config.max_seq_len // 4)):
        check(FLASH_CASES[case] == (rows, seq, config.n_heads, config.n_kv_heads,
                                    config.head_dim, None, False),
              f"FLASH_CASES[{case!r}] is not a rank's attention shape in the two-process legs")
    _reset_states()
    t0 = time.perf_counter()
    refs = {kind: _mesh_2rank_leg(dev, config, {}, False, False, opts)
            for kind, opts in MESH_2RANK_REFS.items()}
    ref_s = time.perf_counter() - t0
    for kind, ref in refs.items():
        opt_name = MESH_2RANK_REFS[kind].get("factory", "adamw")
        print(f"[mesh-2rank] one-process reference ({kind}): {config.n_layers} layers, dim "
              f"{config.dim}, {config.n_heads}/{config.n_kv_heads} heads, vocab "
              f"{config.vocab_size}, batch {MESH_2RANK_BATCH} x {config.max_seq_len}, {opt_name}("
              f"{MESH_2RANK_LR:g}): losses " + " ".join(f"{v:.5f}" for v in ref["losses"])
              + f"; {ref['ms']:.1f} ms/step, peak {ref['peak'] / 2**30:.2f} GiB, optimizer "
              f"state {ref['opt_state_bytes'] / 2**20:.1f} MiB"
              + (f"; loss scale {ref['loss_scale']}, finite {ref['grads_finite']}"
                 if kind == "fp16" else ""))
    print(f"[mesh-2rank] references {ref_s:.1f} s")
    check(refs["fp16"]["grads_finite"][0] is False and all(refs["fp16"]["grads_finite"][1:]),
          f"[mesh-2rank] the fp16 reference's scaler did not overflow once and only on its first "
          f"step: {refs['fp16']['grads_finite']}")
    _reset_states()
    bert_ref = _bert_tp_leg(dev)
    _reset_states()
    fp8_ref = _mesh_2rank_fp8_leg(dev, config, {}, False)
    _reset_states()
    with tempfile.TemporaryDirectory(prefix="mesh_2rank_") as tmp:
        for kind, ref in refs.items():
            torch.save(ref.pop("updates"), os.path.join(tmp, f"ref_updates_{kind}.pt"))
        ranks = _run_two("--mesh-2rank-child", tmp, "mesh-2rank", MESH_2RANK_TIMEOUT_S)
        bert = torch.load(os.path.join(tmp, "bert_tp2.pt"))
        saved = {name: torch.load(os.path.join(tmp, f"updates_{name}.pt"))
                 for name, *_ in MESH_2RANK_LEGS
                 if os.path.exists(os.path.join(tmp, f"updates_{name}.pt"))}
    bert_want = {"fused_attention_fwd": 3 * 12, "fused_attention_bwd": 3 * 12}
    for i, r in enumerate(ranks):
        check(r["bert_tp2"]["sharded"], f"[mesh-2rank] BERT tp 2 rank {i}: no param split")
        check(r["bert_tp2"]["launches"] == bert_want,
              f"[mesh-2rank] BERT tp 2 rank {i} fused launches {r['bert_tp2']['launches']}, "
              f"want {bert_want}")
    print(f"[mesh-2rank] BERT-base under tp 2 through prepare(..., shard_rules="
          f"bert_shard_rules()), phase_train's recipe, 3 steps: launches on each rank "
          f"{[r['bert_tp2']['launches'] for r in ranks]}")
    _compare_runs("mesh-2rank-bert", bert["losses"], bert["updates"], bert_ref["losses"],
                  bert_ref["updates"], TRAIN_RTOL, TRAIN_UPDATE_RTOL, 3 * TRAIN_LR,
                  what="tp 2 vs one process")
    want = {"flash_attention_fwd": config.n_layers * MESH_2RANK_STEPS,
            "flash_attention_dq": config.n_layers * MESH_2RANK_STEPS,
            "flash_attention_dkdv": config.n_layers * MESH_2RANK_STEPS}
    launches = {}
    for name, _, zero1, _, options in MESH_2RANK_LEGS:
        fp16 = options.get("fp16", False)
        kind = options.get("ref", "fp16" if fp16 else "f32")
        paired = kind not in refs  # held to another leg, rank by rank
        loss_tol = TRAIN_FP16_RTOL if fp16 else MESH_2RANK_LOSS_RTOL
        norm_tol = TRAIN_FP16_RTOL if fp16 else MESH_2RANK_NORM_RTOL
        upd_tol = TRAIN_FP16_UPDATE_RTOL if fp16 else TRAIN_UPDATE_RTOL
        if options.get("offload"):  # the same arithmetic as its reference leg: bitwise
            loss_tol = norm_tol = upd_tol = 0.0
        elif paired:
            loss_tol = norm_tol = MESH_2RANK_ZERO1_ADAFACTOR_RTOL
        legs = [r[name] for r in ranks]
        launches[name] = [leg["launches"] for leg in legs]
        loss_err = norm_err = 0.0
        for i, leg in enumerate(legs):
            ref = ranks[i][kind] if paired else refs[kind]
            blocks = options.get("flash_blocks", 0 if fp16 else 1)  # flash calls a layer
            leg_want = {k: blocks * n for k, n in want.items()}
            check(leg["launches"] == leg_want, f"[mesh-2rank] {name} rank {i} launches "
                                               f"{leg['launches']}, want {leg_want}")
            rank_loss_err, rank_norm_err, _, _ = _mesh_2rank_errs(leg, ref)
            check(rank_loss_err <= loss_tol,
                  f"[mesh-2rank] {name} rank {i} losses {leg['losses']} vs one process "
                  f"{ref['losses']}: rel err {rank_loss_err}")
            check(rank_norm_err <= norm_tol,
                  f"[mesh-2rank] {name} rank {i} gradient norms {leg['grad_norms']} vs one "
                  f"process {ref['grad_norms']}: rel err {rank_norm_err}")
            check(leg["loss_scale"] == ref["loss_scale"]
                  and leg["grads_finite"] == ref["grads_finite"],
                  f"[mesh-2rank] {name} rank {i}: loss scales {leg['loss_scale']} and finite "
                  f"flags {leg['grads_finite']}, one process {ref['loss_scale']} and "
                  f"{ref['grads_finite']}")
            loss_err, norm_err = max(loss_err, rank_loss_err), max(norm_err, rank_norm_err)
        if paired:
            worst, upd_err = _saved_update_err(saved[name], saved[kind])
        else:
            _, _, worst, upd_err = _mesh_2rank_errs(legs[0], ref)
        check(upd_err <= upd_tol, f"[mesh-2rank] {name}: 3-step update of {worst} "
                                  f"rel L2 err {upd_err} against {kind}")
        adafactor = options.get("factory") == "adafactor"
        check(legs[0]["fused_zero1"] == (zero1 and "env" not in options and not adafactor),
              f"[mesh-2rank] {name}: fused ZeRO-1 {legs[0]['fused_zero1']}")
        if options.get("offload"):
            check(all(leg["device_state_bytes"] == 0 and leg["offload_groups"] for leg in legs),
                  f"[mesh-2rank] {name}: optimizer state left on the device "
                  f"{[leg['device_state_bytes'] for leg in legs]}")
        if zero1 and adafactor:  # each rank its rows of every split moment
            whole = [r[kind]["opt_state_bytes"] for r in ranks]
            check(all(leg["opt_state_bytes"] < w for leg, w in zip(legs, whole)),
                  f"[mesh-2rank] {name}: adafactor state per rank "
                  f"{[leg['opt_state_bytes'] for leg in legs]}, not below {whole} without "
                  "ZeRO-1")
            print(f"[mesh-2rank] {name}: adafactor state a rank "
                  f"{[leg['opt_state_bytes'] for leg in legs]} B against {whole} B without "
                  f"ZeRO-1 ({legs[0]['opt_state_bytes'] / whole[0]:.3f})")
        elif zero1:
            check(all(2 * leg["opt_state_bytes"] == ref["opt_state_bytes"] for leg in legs),
                  f"[mesh-2rank] {name}: optimizer state per rank "
                  f"{[leg['opt_state_bytes'] for leg in legs]}, not half of "
                  f"{ref['opt_state_bytes']}")
        print(f"[mesh-2rank] {name}: losses " + " ".join(f"{v:.5f}" for v in legs[0]["losses"])
              + f" against {kind} (max rel err {loss_err:.3e}, bar {loss_tol:g}); gradient norms "
              + " ".join(f"{v:.5f}" for v in legs[0]["grad_norms"])
              + f" (max rel err {norm_err:.3e}, bar {norm_tol:g}); worst 3-step "
              f"update {worst} rel L2 {upd_err:.3e} (bar {upd_tol:g})"
              + (f"; loss scales {legs[0]['loss_scale']}, finite {legs[0]['grads_finite']} "
                 "(equal on both ranks and to one process)" if fp16 else "") + "; " + "; ".join(
                  f"rank {i}: {leg['ms']:.1f} ms/step, peak {leg['peak'] / 2**30:.2f} GiB, "
                  f"optimizer state {leg['opt_state_bytes'] / 2**20:.1f} MiB, collectives "
                  f"{leg['comm_bytes']} B, gather {leg['gather_ms']:.1f} ms, live gathered "
                  f"layers at most {leg['max_live_layers']}, launches {leg['launches']}"
                  + (f", offload groups a step {leg['offload_groups']}, state on the device "
                     f"{leg['device_state_bytes']} B" if options.get("offload") else "")
                  for i, leg in enumerate(legs)))
    fp8_legs = [r["fp8"] for r in ranks]
    fp8_launches = 3 * 7 * config.n_layers * MESH_2RANK_STEPS
    for i, leg in enumerate(fp8_legs):
        check(leg["fused_zero1"] and leg["passthrough"] == leg["meta_leaves"] == 7 * 3,
              f"[mesh-2rank] fp8 rank {i}: fused {leg['fused_zero1']}, passthrough "
              f"{leg['passthrough']}, meta leaves {leg['meta_leaves']} (want 21 of each)")
        check(leg["launches"] == fp8_launches, f"[mesh-2rank] fp8 rank {i}: {leg['launches']} "
                                               f"scaled_mm launches, want {fp8_launches}")
        errs = [abs(a - b) / abs(b) for a, b in zip(leg["losses"], fp8_ref["losses"])]
        check(errs[0] <= MESH_2RANK_LOSS_RTOL and max(errs[1:]) <= MESH_2RANK_FP8_RTOL,
              f"[mesh-2rank] fp8 rank {i} losses {leg['losses']} vs one process "
              f"{fp8_ref['losses']}: rel errs {errs}, bars {MESH_2RANK_LOSS_RTOL:g} at the first "
              f"step, {MESH_2RANK_FP8_RTOL:g} after")
    check(fp8_legs[0]["meta_digests"] == fp8_legs[1]["meta_digests"],
          "[mesh-2rank] fp8: the two ranks' meta differ after a step")
    print(f"[mesh-2rank] fp8 (dtype_recipe='fp8', mixed_precision='fp8', sgd("
          f"{MESH_2RANK_FP8_LR:g})) under dp_replicate 2 with fused ZeRO-1: losses "
          + " ".join(f"{v:.5f}" for v in fp8_legs[0]["losses"]) + " against one process "
          + " ".join(f"{v:.5f}" for v in fp8_ref["losses"]) + f" (bars {MESH_2RANK_LOSS_RTOL:g} "
          f"at the first step, {MESH_2RANK_FP8_RTOL:g} after); "
          f"meta bitwise equal on both ranks after each of {MESH_2RANK_STEPS} steps; "
          f"{fp8_legs[0]['passthrough']} passthrough slots = meta leaves; scaled_mm launches a "
          f"rank {[leg['launches'] for leg in fp8_legs]}")
    for fault, leg_name in MESH_2RANK_FAULTS:
        ref = refs["f32"]
        loss_err, norm_err, worst, upd_err = _mesh_2rank_errs(ranks[0]["faults"][fault], ref)
        caught = [bar for bar, err, tol in (("loss", loss_err, MESH_2RANK_LOSS_RTOL),
                                            ("gradient norm", norm_err, MESH_2RANK_NORM_RTOL),
                                            ("update", upd_err, TRAIN_UPDATE_RTOL)) if err > tol]
        print(f"[mesh-2rank] planted fault {fault} on {leg_name}: losses rel err {loss_err:.3e}, "
              f"gradient norms {norm_err:.3e}, worst update {worst} {upd_err:.3e}; caught by "
              f"{caught or 'no bar'}")
        check(bool(caught), f"[mesh-2rank] the planted fault {fault} passes every bar")
    return launches, [r["bert_tp2"]["launches"] for r in ranks]


def _saved_update_err(got: dict, want: dict) -> tuple:
    """(worst leaf, its 3-step update's rel L2 error) of one leg's saved
    updates against another's."""
    errs = {k: float(torch.linalg.vector_norm(v - want[k])
                     / max(float(torch.linalg.vector_norm(want[k])), 1e-30))
            for k, v in got.items()}
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


def _mesh_2rank_errs(leg, ref):
    """A two-process leg against the one-process run: the largest relative
    error of its losses and of its gradient norms, and its worst leaf's
    3-step update error (with the leaf's path)."""
    def rel(a, b):  # an fp16 step that overflowed reports a norm of 0 on both sides
        return abs(a - b) / abs(b) if b else abs(a)

    loss_err = max(rel(a, b) for a, b in zip(leg["losses"], ref["losses"]))
    norm_err = max(rel(a, b) for a, b in zip(leg["grad_norms"], ref["grad_norms"]))
    worst, upd_err = None, None
    if "update_err" in leg:
        worst = max(leg["update_err"], key=leg["update_err"].get)
        upd_err = leg["update_err"][worst]
    return loss_err, norm_err, worst, upd_err


def _cp_attn_inputs(dev):
    """q, k, v, dO of the long-context attention, bf16 on ``dev``, from a
    seed (the same in every process)."""
    B, S, H, Hkv, D = CP_ATTN_SHAPE
    rng = np.random.default_rng(7)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                 .to(dev, torch.bfloat16)
                 for shape in ((B, S, H, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, H, D)))


@contextlib.contextmanager
def _cp_attn_fault(fault):
    """One of ``CP_ATTN_FAULTS`` planted in ``parallel.long_context``."""
    lc = importlib.import_module("accelerate_tpu_torch.parallel.long_context")
    if fault is None:
        yield
        return
    if fault == "zigzag_no_inverse_exchange":
        owner, name = lc, "_zigzag_unexchange"
        patched = lambda lane_a, lane_b, *args: torch.cat([lane_a, lane_b], dim=1)  # noqa: E731
    else:  # ring_kv_grads_not_home: every rotation's gradient kept where it arrived
        owner, name = lc._PPermute, "backward"
        patched = staticmethod(lambda ctx, g: (g, None, None, None))
    real = owner.__dict__[name]
    setattr(owner, name, patched)
    try:
        yield
    finally:
        setattr(owner, name, real)


def _cp_attn_run(mesh, strategy, q, k, v, do):
    """One forward and backward of ``strategy``'s attention on this rank's
    blocks: ``(out, dq, dk, dv)``."""
    lc = importlib.import_module("accelerate_tpu_torch.parallel.long_context")
    q, k, v = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = lc.make_context_parallel_attention(mesh, strategy)(q, k, v, causal=True)
    out.backward(do)
    return out.detach(), q.grad, k.grad, v.grad


def cp_attn_child(tmp: str) -> int:
    """One of ``phase_context_parallel``'s two processes (``chip_smoke.py
    --cp-attn-child <dir>``): each strategy of ``CP_ATTN_STRATEGIES`` on
    this rank's half of the sequence, its flash launches for one call, its
    forward and backward device ms (CUDA events over ``CP_ATTN_REPS``
    calls, the collectives' host staging included), and its blocks of the
    output and gradients (and of each planted fault's) saved to ``dir``."""
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig

    state = _join_two(tmp)
    dev, rank = state.device, state.process_index
    inputs = _cp_attn_inputs(dev)
    S = CP_ATTN_SHAPE[1]
    blocks = [x[:, rank * S // 2:(rank + 1) * S // 2].contiguous() for x in inputs]
    report, meshes = {}, {}
    for strategy, pc_kwargs in CP_ATTN_STRATEGIES:
        key = tuple(sorted(pc_kwargs.items()))
        mesh = meshes.get(key) or meshes.setdefault(key, ParallelismConfig(**pc_kwargs)
                                                    .build_mesh(device_type=dev.type))
        check(mesh.coords["cp" if "cp_size" in pc_kwargs else "sp"] == rank,
              f"[cp-attention] rank {rank} holds another chunk of the sequence")
        _zero_flash_counters()
        got = _cp_attn_run(mesh, strategy, *blocks)
        torch.cuda.synchronize()
        launches = _flash_counts()
        torch.save([x.cpu() for x in got], os.path.join(tmp, f"{strategy}_rank{rank}.pt"))
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        lc = importlib.import_module("accelerate_tpu_torch.parallel.long_context")
        attn = lc.make_context_parallel_attention(mesh, strategy)
        fwd_ms = bwd_ms = 0.0
        for _ in range(CP_ATTN_REPS):
            q, k, v = (x.detach().requires_grad_(True) for x in blocks[:3])
            state.wait_for_everyone()
            torch.cuda.synchronize()
            ev[0].record()
            out = attn(q, k, v, causal=True)
            ev[1].record()
            out.backward(blocks[3])
            ev[2].record()
            torch.cuda.synchronize()
            fwd_ms += ev[0].elapsed_time(ev[1]) / CP_ATTN_REPS
            bwd_ms += ev[1].elapsed_time(ev[2]) / CP_ATTN_REPS
        report[strategy] = {"launches": launches, "fwd_ms": fwd_ms, "bwd_ms": bwd_ms}
    for fault, strategy in CP_ATTN_FAULTS:
        mesh = meshes[tuple(sorted(dict(CP_ATTN_STRATEGIES)[strategy].items()))]
        with _cp_attn_fault(fault):
            got = _cp_attn_run(mesh, strategy, *blocks)
        torch.save([x.cpu() for x in got], os.path.join(tmp, f"{fault}_rank{rank}.pt"))
    return _leave_two(state, tmp, report)


def phase_context_parallel(dev):
    """The long-context attention (``CP_ATTN_SHAPE``) with its sequence
    split over two processes sharing the card over gloo (``--cp-attn-child``):
    for each of ``CP_ATTN_STRATEGIES`` each rank's output and dq/dk/dv
    blocks against one process's ``flash_attention`` (#1-#3) on the whole
    sequence and against the plain attention, each rank's #1-#3 launches
    (``CP_ATTN_FLASH_CALLS``) and its forward and backward ms; each of
    ``CP_ATTN_FAULTS`` must break a bar. Returns each strategy's launches
    per rank."""
    import tempfile

    from accelerate_tpu_torch.ops.attention import _xla_attention

    fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
    q, k, v, do = _cp_attn_inputs(dev)
    refs = {}
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True)
    out.backward(do)
    refs["flash"] = [out.detach()] + [x.grad for x in leaves]
    leaves = [x.detach().float().requires_grad_(True) for x in (q, k, v)]
    out = _xla_attention(*leaves, causal=True, mask=None, scale=None)
    out.backward(do.float())
    refs["plain"] = [out.detach()] + [x.grad for x in leaves]
    del leaves, out
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    names = ("out", "dq", "dk", "dv")
    bar = FUSED_RTOL[torch.bfloat16]

    def errs(got):
        return {ref: {n: _errs([(g, w)])[1] for n, g, w in zip(names, got, want)}
                for ref, want in refs.items()}

    with tempfile.TemporaryDirectory(prefix="cp_attention_") as tmp:
        ranks = _run_two("--cp-attn-child", tmp, "cp-attention", CP_ATTN_TIMEOUT_S)

        def whole(name):  # the two ranks' halves of the sequence, on the card
            parts = [torch.load(os.path.join(tmp, f"{name}_rank{i}.pt")) for i in range(2)]
            return [torch.cat([a, b], dim=1).to(dev) for a, b in zip(*parts)]

        results = {name: errs(whole(name)) for name in
                   [s for s, _ in CP_ATTN_STRATEGIES] + [f for f, _ in CP_ATTN_FAULTS]}
    launches = {}
    for strategy, pc_kwargs in CP_ATTN_STRATEGIES:
        per_rank = [r[strategy]["launches"] for r in ranks]
        launches[strategy] = per_rank
        for i, got in enumerate(per_rank):
            want = {kern: CP_ATTN_FLASH_CALLS[strategy][i] for kern in FLASH_KERNELS}
            check(got == want, f"[cp-attention] {strategy} rank {i} flash launches {got}, "
                               f"want {want}")
        worst = max(e for ref in results[strategy].values() for e in ref.values())
        check(worst <= bar, f"[cp-attention] {strategy} against one process: "
                            f"{results[strategy]} (bar {bar:g})")
        print(f"[cp-attention] {strategy} over {'sp' if strategy == 'ulysses' else 'cp'} 2 at "
              f"B={CP_ATTN_SHAPE[0]} S="
              f"{CP_ATTN_SHAPE[1]} {CP_ATTN_SHAPE[2]}/{CP_ATTN_SHAPE[3]} heads D="
              f"{CP_ATTN_SHAPE[4]} bf16: rel err against one process's flash "
              + ", ".join(f"{n} {e:.3e}" for n, e in results[strategy]["flash"].items())
              + "; against the plain attention "
              + ", ".join(f"{n} {e:.3e}" for n, e in results[strategy]["plain"].items())
              + f" (bar {bar:g}); " + "; ".join(
                  f"rank {i}: flash launches {r[strategy]['launches']}, forward "
                  f"{r[strategy]['fwd_ms']:.3f} ms, backward {r[strategy]['bwd_ms']:.3f} ms"
                  for i, r in enumerate(ranks)), flush=True)
    for fault, strategy in CP_ATTN_FAULTS:
        caught = sorted({n for ref in results[fault].values() for n, e in ref.items() if e > bar})
        print(f"[cp-attention] planted fault {fault} on {strategy}: rel errs "
              f"{results[fault]['flash']}; caught by {caught or 'no bar'}", flush=True)
        check(bool(caught), f"[cp-attention] the planted fault {fault} passes every bar")
    return launches


@contextlib.contextmanager
def _mesh_lm_fault(fault):
    """A fault planted in the per-layer gather, for phase_mesh_lm774m's
    negative control: ``"layer_grads_not_summed"`` leaves layer 0's
    gradient unsummed over the batch axes (its owner keeps its own rows'
    part);
    ``"next_layer_params"`` computes layer i with layer i+1's gathered
    params (the last layer with its own)."""
    from accelerate_tpu_torch.parallel import sharding

    if fault is None:
        yield
        return
    if fault == "layer_grads_not_summed":
        owner, name = sharding._LayerGroup, "reduce"
        real = owner.reduce

        def patched(self, i, grads):
            if i:
                return real(self, i, grads)
            axes, sharding.GRAD_SUM_AXES = sharding.GRAD_SUM_AXES, ()
            try:
                return real(self, i, grads)
            finally:
                sharding.GRAD_SUM_AXES = axes
    else:
        owner, name = sharding.LayerStack, "layer"
        real = owner.layer

        def patched(self, i):
            return real(self, min(i + 1, self.n_layers - 1))
    setattr(owner, name, patched)
    try:
        yield
    finally:
        setattr(owner, name, real)


def _layer_norms(params, ranks: int) -> list:
    """The gradient norm of each whole layer this rank holds (its block of
    the stacked layers, in order), from the params' ``.grad`` after a step,
    divided by the ``ranks`` the sharded step sums the batch over (its
    gradient is their sum)."""
    from accelerate_tpu_torch.optimizer import param_leaves

    leaves = param_leaves(params["layers"])
    rows = leaves[0].shape[0]
    check(all(t.grad is not None and t.shape[0] == rows for t in leaves),
          "a stacked layer leaf is not split like the others over the layer axis")
    return [math.sqrt(sum(float(t.grad[j].float().pow(2).sum()) for t in leaves)) / ranks
            for j in range(rows)]


def _mesh_lm_leg(dev, pc_kwargs, fault=None, steps=MESH_LM_STEPS):
    """``steps`` steps of config #4 in its recipe through a mesh of
    the running processes (or none): losses, gradient norms, each held
    layer's gradient norm in the first step, flash launches, ms/step (the
    steps after the first), peak memory, the per-layer gather's counts,
    collective bytes a step and the whole tree's gather ms."""
    from accelerate_tpu_torch import Accelerator, LlamaConfig, init_llama, llama_loss
    from accelerate_tpu_torch.data_loader import GlobalBatchAssembler
    fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
    from accelerate_tpu_torch.optimizer import adafactor
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.state import AcceleratorState, GradientState
    from accelerate_tpu_torch.utils import operations as ops

    AcceleratorState._reset_state()
    GradientState._reset_state()
    config = dataclasses.replace(LlamaConfig(**LM774M_KW), n_layers=MESH_LM_LAYERS)
    acc = Accelerator(mixed_precision="no", rng_seed=0, device=dev,
                      parallelism_config=ParallelismConfig(**pc_kwargs))
    init = init_llama(config, torch.Generator(device=dev).manual_seed(0), device=dev,
                      dtype=torch.bfloat16)
    params, opt = acc.prepare(init, adafactor(LM774M_LR))
    del init
    torch.cuda.empty_cache()
    plan = acc.sharding_plan
    step = acc.prepare_train_step(
        lambda p, b: llama_loss(p, b, config, remat="dots_no_batch", mesh=acc.mesh), opt,
        compute_grad_norm=True)
    ids = np.random.default_rng(0).integers(0, config.vocab_size,
                                            (LM774M_K, LM774M_BATCH, config.max_seq_len))
    assembler = GlobalBatchAssembler(acc.mesh, device=dev)
    state, losses, norms, walls, layer_norms = opt.opt_state, [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_comm_counters()
    for kern in FLASH_KERNELS:
        getattr(fa, kern).launches = 0
    live = []
    with _mesh_lm_fault(fault):
        for k in range(steps):
            batch = assembler.to_global(assembler.local_block(
                {"input_ids": ids[k % LM774M_K].astype(np.int32)}))
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            live.append(plan.layer_stats.get("max_live_layers"))
            if k == 0:
                layer_norms = _layer_norms(params, plan.batch_ranks)
    launches = {kern: getattr(fa, kern).launches for kern in FLASH_KERNELS}
    comm = {op: c["bytes"] / steps for op, c in ops.get_comm_counters().items()}
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    full = plan.gather_params_no_grad(params) if plan.distributed else params
    torch.cuda.synchronize()
    gather_ms = (time.perf_counter() - t0) * 1e3
    coords = acc.mesh.coords
    rows = config.n_layers // acc.mesh.shape["dp_shard"]
    offset = coords["dp_shard"] * rows if plan.distributed else 0
    out = {"losses": losses, "grad_norms": norms, "launches": launches, "peak": peak,
           "ms": 1e3 * sum(walls[1:]) / max(len(walls) - 1, 1), "first_ms": 1e3 * walls[0],
           "max_live_layers": max(v for v in live if v is not None) if any(live) else None,
           "gathers": plan.layer_stats.get("gathers"), "comm_bytes": comm,
           "gather_ms": gather_ms,
           "layer_norms": {str(offset + j): v for j, v in enumerate(layer_norms)},
           "local_param_bytes": sum(t.numel() * t.element_size()
                                    for t in opt.model_params)}
    del params, opt, step, state, full
    torch.cuda.empty_cache()
    return out


def _mesh_ckpt_leg(dev, ckpt_dir: str) -> dict:
    """Config #4 at ``MESH_LM_LAYERS`` under dp_shard 2 (this process's
    rank): 2 steps, a sharded ``save_state`` into ``ckpt_dir`` (each rank
    its blocks), step 3, ``load_state``, step 3 again: the loss and the
    rank's blocks bitwise."""
    from accelerate_tpu_torch import Accelerator, LlamaConfig, init_llama, llama_loss
    from accelerate_tpu_torch.data_loader import GlobalBatchAssembler
    from accelerate_tpu_torch.optimizer import adafactor, param_leaves
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state()
    GradientState._reset_state()
    config = dataclasses.replace(LlamaConfig(**LM774M_KW), n_layers=MESH_LM_LAYERS)
    acc = Accelerator(mixed_precision="no", rng_seed=0, device=dev,
                      parallelism_config=ParallelismConfig(dp_shard_size=2))
    init = init_llama(config, torch.Generator(device=dev).manual_seed(0), device=dev,
                      dtype=torch.bfloat16)
    params, opt = acc.prepare(init, adafactor(LM774M_LR))
    del init
    step = acc.prepare_train_step(
        lambda p, b: llama_loss(p, b, config, remat="dots_no_batch", mesh=acc.mesh), opt)
    ids = np.random.default_rng(0).integers(0, config.vocab_size,
                                            (LM774M_K, LM774M_BATCH, config.max_seq_len))
    assembler = GlobalBatchAssembler(acc.mesh, device=dev)
    batches = [assembler.to_global(assembler.local_block(
        {"input_ids": ids[k % LM774M_K].astype(np.int32)})) for k in range(3)]
    state = opt.opt_state
    for k in range(2):
        params, state, m = step(params, state, batches[k])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc.save_state(ckpt_dir)
    save_s = time.perf_counter() - t0
    snap = acc.last_checkpoint
    params, state, m = step(params, state, batches[2])
    loss3 = float(m["loss"])
    ref = [t.detach().clone() for t in param_leaves(params)]
    t0 = time.perf_counter()
    acc.load_state(ckpt_dir)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    params, state, m = step(params, state, batches[2])
    again = float(m["loss"])
    bitwise = all(torch.equal(a, b) for a, b in zip(param_leaves(params), ref))
    out = {"loss3": loss3, "again": again, "bitwise": bitwise, "bytes": snap.nbytes,
           "sharded": snap.sharded, "save_s": save_s, "load_s": load_s}
    del params, opt, step, state, ref
    torch.cuda.empty_cache()
    return out


def mesh_lm_child(tmp: str) -> int:
    """One of ``phase_mesh_lm774m``'s two processes: the sound leg under
    dp_shard 2, then each planted fault on a copy, one step (the first
    step's gradient norms show both), then the sharded checkpoint leg
    (``_mesh_ckpt_leg``, into ``tmp/ckpt``)."""
    state = _join_two(tmp)
    report = {"dp_shard2": _mesh_lm_leg(state.device, {"dp_shard_size": 2})}
    report["faults"] = {fault: _mesh_lm_leg(state.device, {"dp_shard_size": 2}, fault, steps=1)
                        for fault in MESH_LM_FAULTS}
    report["ckpt"] = _mesh_ckpt_leg(state.device, os.path.join(tmp, "ckpt"))
    return _leave_two(state, tmp, report)


def _mesh_ckpt_one_process(dev, ckpt_dir: str, ranks: list) -> None:
    """The dp_shard 2 ranks' sharded checkpoint loaded into one process
    (params from another seed): every param bitwise ``consolidate_sharded``'s
    array, and step 3 from it within ``MESH_LM_LOSS_RTOL`` of the ranks'
    step 3."""
    from accelerate_tpu_torch import Accelerator, LlamaConfig, init_llama, llama_loss
    from accelerate_tpu_torch.optimizer import adafactor
    from accelerate_tpu_torch.sharded_checkpoint import consolidate_sharded, flatten_with_path

    for i, r in enumerate(ranks):
        c = r["ckpt"]
        print(f"[mesh-lm774m] sharded checkpoint, rank {i}: wrote {c['bytes'] / 1e9:.3f} GB "
              f"(sharded {c['sharded']}) in {c['save_s']:.3f} s, loaded in {c['load_s']:.3f} s; "
              f"step 3 loss {c['loss3']!r}, after the load {c['again']!r}; its blocks bitwise "
              f"{c['bitwise']}")
        check(c["sharded"] and c["bitwise"] and c["again"] == c["loss3"],
              f"[mesh-lm774m] rank {i}: the sharded save did not resume bitwise: {c}")
    _reset_states()
    config = dataclasses.replace(LlamaConfig(**LM774M_KW), n_layers=MESH_LM_LAYERS)
    acc = Accelerator(mixed_precision="no", rng_seed=0, device=dev)
    init = init_llama(config, torch.Generator(device=dev).manual_seed(1), device=dev,
                      dtype=torch.bfloat16)
    params, opt = acc.prepare(init, adafactor(LM774M_LR))
    del init
    step = acc.prepare_train_step(lambda p, b: llama_loss(p, b, config, remat="dots_no_batch"),
                                  opt)
    acc.load_state(ckpt_dir)
    full = consolidate_sharded(ckpt_dir, "model")
    same = all(torch.equal(t.float().cpu(), torch.from_numpy(full[k]))
               for k, t in flatten_with_path(params))
    ids = np.random.default_rng(0).integers(0, config.vocab_size,
                                            (LM774M_K, LM774M_BATCH, config.max_seq_len))
    _, _, m = step(params, opt.opt_state,
                   {"input_ids": torch.from_numpy(ids[0].astype(np.int32)).to(dev)})
    loss = float(m["loss"])
    err = abs(loss - ranks[0]["ckpt"]["loss3"]) / abs(ranks[0]["ckpt"]["loss3"])
    print(f"[mesh-lm774m] that checkpoint in one process: params bitwise consolidate_sharded's "
          f"{same}; step 3 loss {loss!r} (rel err {err:.3e} from the ranks', bar "
          f"{MESH_LM_LOSS_RTOL:g})")
    check(same and err <= MESH_LM_LOSS_RTOL, f"[mesh-lm774m] one-process load: bitwise {same}, "
                                             f"loss rel err {err}")
    del params, opt, step, full
    _reset_states()
    torch.cuda.empty_cache()


def _lm_errs(leg, ref):
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(leg["losses"], ref["losses"]))
    norm_err = max(abs(a - b) / abs(b) for a, b in zip(leg["grad_norms"], ref["grad_norms"]))
    layer_err = max(abs(v - ref["layer_norms"][k]) / ref["layer_norms"][k]
                    for k, v in leg["layer_norms"].items())
    return loss_err, norm_err, layer_err


def phase_mesh_lm774m(dev):
    """Config #4 at full width, ``MESH_LM_LAYERS`` deep, under dp_shard 2
    (two processes on the one card over gloo), held to a one-process run of
    the same 3 steps: the bars of ``MESH_LM_*``; each rank's peak memory
    under ``MESH_LM_PEAK_SHARE`` of the one-process run's; at most 2
    layers' gathered params alive; #1-#3 launched 2/1/1 times a layer and
    step on each rank; each planted fault failing a bar. Returns the
    launches of each rank."""
    import tempfile

    from accelerate_tpu_torch import LlamaConfig

    config = dataclasses.replace(LlamaConfig(**LM774M_KW), n_layers=MESH_LM_LAYERS)
    rows = LM774M_BATCH // 2
    check(FLASH_CASES["lm774m_rank"] == (rows, config.max_seq_len, config.n_heads,
                                         config.n_kv_heads, config.head_dim, None, False),
          "FLASH_CASES['lm774m_rank'] is not a dp_shard 2 rank's attention shape")
    _reset_states()
    ref = _mesh_lm_leg(dev, {})
    print(f"[mesh-lm774m] one-process reference, {config.n_layers} of config #4's "
          f"{LM774M_KW['n_layers']} layers: {MESH_LM_STEPS} steps of prepare_train_step, "
          f"losses " + " ".join(f"{v:.5f}" for v in ref["losses"]) + ", gradient norms "
          + " ".join(f"{v:.5f}" for v in ref["grad_norms"]) + f"; {ref['ms']:.1f} ms/step "
          f"(first {ref['first_ms']:.1f}), peak {ref['peak'] / 2**30:.2f} GiB")
    _reset_states()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="mesh_lm_") as tmp:
        ranks = _run_two("--mesh-lm-child", tmp, "mesh-lm774m", MESH_2RANK_TIMEOUT_S)
        _mesh_ckpt_one_process(dev, os.path.join(tmp, "ckpt"), ranks)
    want = {"flash_attention_fwd": 2 * config.n_layers * MESH_LM_STEPS,
            "flash_attention_dq": config.n_layers * MESH_LM_STEPS,
            "flash_attention_dkdv": config.n_layers * MESH_LM_STEPS}
    limit = MESH_LM_PEAK_SHARE * ref["peak"]
    for i, r in enumerate(ranks):
        leg = r["dp_shard2"]
        loss_err, norm_err, layer_err = _lm_errs(leg, ref)
        print(f"[mesh-lm774m] dp_shard 2 rank {i}: losses "
              + " ".join(f"{v:.5f}" for v in leg["losses"]) + f" (max rel err {loss_err:.3e}, "
              f"bar {MESH_LM_LOSS_RTOL:g}); gradient norms "
              + " ".join(f"{v:.5f}" for v in leg["grad_norms"]) + f" (max rel err "
              f"{norm_err:.3e}, bar {MESH_LM_NORM_RTOL:g}); its {len(leg['layer_norms'])} layers' "
              f"first-step gradient norms max rel err {layer_err:.3e} (bar "
              f"{MESH_LM_LAYER_NORM_RTOL:g}); {leg['ms']:.1f} ms/step (first "
              f"{leg['first_ms']:.1f}), peak {leg['peak'] / 2**30:.2f} GiB ("
              f"{leg['peak'] / ref['peak']:.3f} of one process's {ref['peak'] / 2**30:.2f}, "
              f"bar {MESH_LM_PEAK_SHARE}), params held {leg['local_param_bytes'] / 2**30:.3f} GiB; "
              f"live gathered layers at most {leg['max_live_layers']}, {leg['gathers']} layer "
              f"gathers in the last step; bytes a step {leg['comm_bytes']}; whole-tree gather "
              f"{leg['gather_ms']:.1f} ms; launches {leg['launches']}")
        check(leg["launches"] == want, f"[mesh-lm774m] rank {i} launches {leg['launches']}, "
                                       f"want {want}")
        check(loss_err <= MESH_LM_LOSS_RTOL, f"[mesh-lm774m] rank {i} loss rel err {loss_err}")
        check(norm_err <= MESH_LM_NORM_RTOL, f"[mesh-lm774m] rank {i} norm rel err {norm_err}")
        check(layer_err <= MESH_LM_LAYER_NORM_RTOL,
              f"[mesh-lm774m] rank {i} layer gradient norm rel err {layer_err}")
        check(leg["max_live_layers"] is not None and leg["max_live_layers"] <= 2,
              f"[mesh-lm774m] rank {i}: {leg['max_live_layers']} layers' gathered params alive")
        check(leg["peak"] < limit, f"[mesh-lm774m] rank {i} peak {leg['peak']} not below "
                                   f"{MESH_LM_PEAK_SHARE} x one process's {ref['peak']}")
    for fault in MESH_LM_FAULTS:
        loss_err, norm_err, layer_err = (max(e) for e in zip(*(
            _lm_errs(r["faults"][fault], ref) for r in ranks)))
        caught = [bar for bar, e, tol in (("loss", loss_err, MESH_LM_LOSS_RTOL),
                                          ("gradient norm", norm_err, MESH_LM_NORM_RTOL),
                                          ("layer gradient norm", layer_err,
                                           MESH_LM_LAYER_NORM_RTOL)) if e > tol]
        print(f"[mesh-lm774m] planted fault {fault}: losses rel err {loss_err:.3e}, gradient "
              f"norms {norm_err:.3e}, layer gradient norms {layer_err:.3e}; caught by "
              f"{caught or 'no bar'}")
        check(bool(caught), f"[mesh-lm774m] the planted fault {fault} passes every bar")
    return [r["dp_shard2"]["launches"] for r in ranks]


@contextlib.contextmanager
def _moe_ep_fault(fault):
    """A fault planted in the MoE FFN under ep, for phase_moe_ep's negative
    control: ``"expert_input_grad_not_summed"`` passes the gradient of the
    expert input (the ``[n, D]`` token rows) back unsummed over ep, so each
    rank's rows get only its own experts' part of it."""
    from accelerate_tpu_torch.parallel import moe

    if fault is None:
        yield
        return
    real = moe._SumGradOverAxis
    dim = MOE_KW["dim"]

    class Unsummed:
        @staticmethod
        def apply(x, mesh, axis):
            return x if x.shape[-1] == dim else real.apply(x, mesh, axis)

    moe._SumGradOverAxis = Unsummed
    try:
        yield
    finally:
        moe._SumGradOverAxis = real


def _expert_grad_collective_ms(acc, config) -> dict:
    """ms a step of the expert weights' gradient collective that the ep
    leg's backward runs (a gather over ep of each layer's ``wi`` and ``wo``
    blocks to the rank that keeps the layer), and of an all-gather of the
    same blocks (every rank keeping all of it), timed alone on tensors of
    the same shapes."""
    import torch.distributed as dist

    from accelerate_tpu_torch.parallel.sharding import _all_gather_dim

    group, ep = acc.mesh.group("ep"), acc.mesh.shape["ep"]
    e_loc = config.moe_experts // ep
    blocks = [torch.zeros((e_loc, config.dim, config.hidden_dim), device=acc.device,
                          dtype=torch.bfloat16),
              torch.zeros((e_loc, config.hidden_dim, config.dim), device=acc.device,
                          dtype=torch.bfloat16)]
    out = {}
    for name in ("all_gather", "gather"):
        dist.barrier(group=group)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(config.n_layers):
            for blk in blocks:
                if name == "all_gather":
                    _all_gather_dim(blk, 0, group)
                else:
                    keep = [torch.empty_like(blk) for _ in range(ep)] if (
                        acc.mesh.coords["ep"] == 0) else None
                    dist.gather(blk, keep, group=group, group_dst=0)
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3
    out["bytes"] = config.n_layers * sum(b.numel() * b.element_size() for b in blocks) * ep
    return out


def _moe_ep_leg(dev, pc_kwargs, rules: bool, fault=None, steps=MOE_EP_STEPS):
    """``steps`` steps of phase_moe's training recipe through a mesh of the
    running processes (``moe_shard_rules`` with ``rules``), after the first
    forward's aux loss and drops at the initial params: losses, gradient
    norms, aux, routed and dropped token-choices, flash launches, ms/step,
    peak, the bytes of this rank's expert weights and of all its params."""
    from accelerate_tpu_torch import Accelerator, LlamaConfig, init_llama, llama_forward, llama_loss
    from accelerate_tpu_torch.data_loader import GlobalBatchAssembler
    fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
    from accelerate_tpu_torch.optimizer import adafactor
    from accelerate_tpu_torch.parallel import moe
    from accelerate_tpu_torch.parallel.sharding import _map_with_path
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.state import AcceleratorState, GradientState
    from accelerate_tpu_torch.utils import operations as ops

    AcceleratorState._reset_state()
    GradientState._reset_state()
    config = dataclasses.replace(LlamaConfig(**MOE_KW), n_layers=MOE_EP_LAYERS,
                                 max_seq_len=MOE_TRAIN_SEQ,
                                 attn_impl="flash")
    acc = Accelerator(mixed_precision="no", rng_seed=0, device=dev,
                      parallelism_config=ParallelismConfig(**pc_kwargs),
                      shard_rules=moe.moe_shard_rules() if rules else None)
    init = init_llama(config, torch.Generator(device=dev).manual_seed(0), device=dev,
                      dtype=torch.bfloat16)
    params, opt = acc.prepare(init, adafactor(MOE_LR))
    del init
    torch.cuda.empty_cache()
    plan = acc.sharding_plan
    tids = np.random.default_rng(0).integers(0, config.vocab_size,
                                             (MOE_TRAIN_BATCH, MOE_TRAIN_SEQ)).astype(np.int32)
    assembler = GlobalBatchAssembler(acc.mesh, device=dev)
    batch = assembler.to_global(assembler.local_block({"input_ids": tids}))
    drops = {}
    with torch.no_grad(), _count_drops(drops):
        full = plan.gather_params_no_grad(params) if plan.distributed else params
        _, aux = llama_forward(full, batch["input_ids"], config, mesh=acc.mesh, with_aux=True)
        del full
    drops = {k: int(v) for k, v in drops.items()}
    step = acc.prepare_train_step(
        lambda p, b: llama_loss(p, b, config, remat="dots_no_batch", mesh=acc.mesh), opt,
        compute_grad_norm=True)
    state, losses, norms, walls = opt.opt_state, [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_comm_counters()
    for kern in FLASH_KERNELS:
        getattr(fa, kern).launches = 0
    with _moe_ep_fault(fault):
        for _ in range(steps):
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    named = {}
    _map_with_path(lambda path, t: named.__setitem__(path, t), params)
    expert = sum(t.numel() * t.element_size() for k, t in named.items()
                 if k.startswith("layers/moe/w"))
    out = {"losses": losses, "grad_norms": norms, "aux": float(aux), "drops": drops,
           "launches": {kern: getattr(fa, kern).launches for kern in FLASH_KERNELS},
           "ms": 1e3 * sum(walls) / len(walls), "walls": walls,
           "peak": torch.cuda.max_memory_allocated(), "expert_bytes": expert,
           "param_bytes": sum(t.numel() * t.element_size() for t in named.values()),
           "max_live_layers": plan.layer_stats.get("max_live_layers"),
           "comm_bytes": {op: c["bytes"] / steps
                          for op, c in ops.get_comm_counters().items()}}
    if plan.distributed and fault is None:
        out["expert_grad_ms"] = _expert_grad_collective_ms(acc, config)
    del params, opt, step, state
    torch.cuda.empty_cache()
    return out


def _moe_ep_greedy(dev, tmp: str) -> dict:
    """phase_moe's greedy decode (its bf16 params from seed 0, its prompt)
    under ep 2 with ``llama_shard_rules``: the tokens, ms a decode step, the
    rank's expert bytes and the collectives' bytes by op."""
    from accelerate_tpu_torch import (
        Accelerator,
        LlamaConfig,
        greedy_generate,
        init_llama,
        llama_shard_rules,
    )
    from accelerate_tpu_torch.parallel.sharding import shard_params
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.state import AcceleratorState, GradientState
    from accelerate_tpu_torch.utils import operations as ops

    AcceleratorState._reset_state()
    GradientState._reset_state()
    config = LlamaConfig(**MOE_KW)
    acc = Accelerator(device=dev, parallelism_config=ParallelismConfig(ep_size=2))
    whole = init_llama(config, torch.Generator(device=dev).manual_seed(0), device=dev,
                       dtype=torch.bfloat16)
    params, _ = shard_params(whole, acc.mesh, rules=llama_shard_rules())
    del whole
    torch.cuda.empty_cache()
    prompt = np.load(os.path.join(tmp, "moe_prompt.npy"))
    ops.reset_comm_counters()
    tokens, stats = greedy_generate(params, prompt, config, max_new_tokens=GEN_SHORT_NEW,
                                    mesh=acc.mesh, return_stats=True)
    moe = params["layers"]["moe"]
    out = {"tokens": tokens.tolist(), "ms_per_step": 1e3 * stats["seconds_per_token"],
           "expert_bytes": sum(moe[k]["kernel"].numel() * moe[k]["kernel"].element_size()
                               for k in ("wi", "wo")),
           "comm": {op: c["bytes"] for op, c in ops.get_comm_counters().items()}}
    del params
    torch.cuda.empty_cache()
    return out


def moe_ep_child(tmp: str) -> int:
    """One of ``phase_moe_ep``'s two processes: the sound leg under ep 2,
    then each planted fault."""
    state = _join_two(tmp)
    report = {"greedy": _moe_ep_greedy(state.device, tmp)}
    report["ep2"] = _moe_ep_leg(state.device, {"ep_size": 2}, True)
    report["faults"] = {fault: _moe_ep_leg(state.device, {"ep_size": 2}, True, fault)
                        for fault in MOE_EP_FAULTS}
    return _leave_two(state, tmp, report)


def phase_moe_ep(dev, moe_leg):
    """phase_moe's model (MOE_EP_LAYERS deep) and training recipe under
    ``ParallelismConfig(ep_size=2)`` with ``moe_shard_rules`` (two
    processes on the one card over gloo), held to one-process steps here:
    losses, the first forward's aux loss and dropped token-choices,
    gradient norms, half the expert bytes a rank (4 of the 8 experts'
    worth), #1-#3 launched on each rank, the planted fault failing a bar;
    and phase_moe's greedy decode under ep 2 at all 16 layers, equal to
    its tokens. Returns each rank's launches."""
    import tempfile

    from accelerate_tpu_torch import LlamaConfig

    config = dataclasses.replace(LlamaConfig(**MOE_KW), n_layers=MOE_EP_LAYERS)
    _reset_states()
    ref = _moe_ep_leg(dev, {}, False)
    print(f"[moe-ep] one process, {config.n_layers} of the model's {MOE_KW['n_layers']} layers: "
          f"losses " + " ".join(f"{v:.5f}" for v in ref["losses"]) + ", gradient "
          f"norms " + " ".join(f"{v:.5f}" for v in ref["grad_norms"]) + ", aux "
          f"{ref['aux']:.6f}, drops {ref['drops']}; {ref['ms']:.1f} ms/step, peak "
          f"{ref['peak'] / 2**30:.2f} GiB, expert weights {ref['expert_bytes'] / 2**30:.3f} GiB")
    _reset_states()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="moe_ep_") as tmp:
        np.save(os.path.join(tmp, "moe_prompt.npy"), np.random.default_rng(0).integers(
            0, config.vocab_size, (GEN_BATCH, GEN_PROMPT)).astype(np.int32))
        ranks = _run_two("--moe-ep-child", tmp, "moe-ep", MESH_2RANK_TIMEOUT_S)
    want_tokens = np.asarray(moe_leg["greedy_short"])
    for i, r in enumerate(ranks):
        got = np.asarray(r["greedy"]["tokens"])
        same = int((got == want_tokens).sum()) - GEN_BATCH * GEN_PROMPT
        print(f"[moe-ep] greedy under ep 2, rank {i}: {GEN_BATCH} x {GEN_PROMPT} + "
              f"{GEN_SHORT_NEW}, {same} of {GEN_BATCH * GEN_SHORT_NEW} tokens equal to "
              f"phase_moe's one-process greedy; {r['greedy']['ms_per_step']:.2f} ms a decode "
              f"step; expert weights {r['greedy']['expert_bytes'] / 2**30:.3f} GiB; collectives "
              f"by op {r['greedy']['comm']}")
        check(np.array_equal(got, want_tokens), f"[moe-ep] rank {i}'s greedy tokens under ep 2 "
                                                "differ from phase_moe's")
    want = {"flash_attention_fwd": 2 * config.n_layers * MOE_EP_STEPS,
            "flash_attention_dq": config.n_layers * MOE_EP_STEPS,
            "flash_attention_dkdv": config.n_layers * MOE_EP_STEPS}
    for i, r in enumerate(ranks):
        leg = r["ep2"]
        loss_err, norm_err = _moe_ep_errs(leg, ref)
        aux_err = abs(leg["aux"] - ref["aux"]) / abs(ref["aux"])
        coll = leg["expert_grad_ms"]
        print(f"[moe-ep] ep 2 rank {i}: losses " + " ".join(f"{v:.5f}" for v in leg["losses"])
              + f" (max rel err {loss_err:.3e}, bar {MOE_EP_LOSS_RTOL:g}); gradient norms "
              + " ".join(f"{v:.5f}" for v in leg["grad_norms"]) + f" (max rel err "
              f"{norm_err:.3e}, bar {MESH_LM_NORM_RTOL:g}); aux "
              f"{leg['aux']:.6f} (rel err {aux_err:.3e}, bar {MOE_EP_AUX_RTOL:g}); drops "
              f"{leg['drops']} (one process {ref['drops']}); expert weights held "
              f"{leg['expert_bytes'] / 2**30:.3f} GiB of {ref['expert_bytes'] / 2**30:.3f}, all "
              f"params {leg['param_bytes'] / 2**30:.3f} GiB; {leg['ms']:.1f} ms/step (steps "
              + " ".join(f"{1e3 * w:.1f}" for w in leg["walls"]) + f" ms), peak "
              f"{leg['peak'] / 2**30:.2f} GiB; live gathered layers at most "
              f"{leg['max_live_layers']}; bytes a step {leg['comm_bytes']}; the expert "
              f"weights' gradient gather over ep to its owner, timed alone: {coll['gather']:.1f} "
              f"ms a step ({coll['bytes'] / 1e9:.3f} GB gathered), an all-gather of the same "
              f"blocks {coll['all_gather']:.1f} ms; launches {leg['launches']}")
        check(leg["launches"] == want, f"[moe-ep] rank {i} launches {leg['launches']}, want {want}")
        check(loss_err <= MOE_EP_LOSS_RTOL, f"[moe-ep] rank {i} loss rel err {loss_err}")
        check(norm_err <= MESH_LM_NORM_RTOL, f"[moe-ep] rank {i} norm rel err {norm_err}")
        check(aux_err <= MOE_EP_AUX_RTOL, f"[moe-ep] rank {i} aux rel err {aux_err}")
        check(leg["drops"] == ref["drops"], f"[moe-ep] rank {i} drops {leg['drops']}, one "
                                            f"process {ref['drops']}")
        check(2 * leg["expert_bytes"] == ref["expert_bytes"],
              f"[moe-ep] rank {i} holds {leg['expert_bytes']} B of expert weights, not half of "
              f"{ref['expert_bytes']}")
        check(leg["max_live_layers"] is not None and leg["max_live_layers"] <= 2,
              f"[moe-ep] rank {i}: {leg['max_live_layers']} layers' gathered params alive")
    for fault in MOE_EP_FAULTS:
        loss_err, norm_err = (max(e) for e in zip(*(
            _moe_ep_errs(r["faults"][fault], ref) for r in ranks)))
        caught = [bar for bar, e, tol in (("loss", loss_err, MOE_EP_LOSS_RTOL),
                                          ("gradient norm", norm_err, MESH_LM_NORM_RTOL))
                  if e > tol]
        print(f"[moe-ep] planted fault {fault}: losses rel err {loss_err:.3e}, gradient norms "
              f"{norm_err:.3e}; caught by {caught or 'no bar'}")
        check(bool(caught), f"[moe-ep] the planted fault {fault} passes every bar")
    return [r["ep2"]["launches"] for r in ranks]


def _moe_ep_errs(leg, ref):
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(leg["losses"], ref["losses"]))
    norm_err = max(abs(a - b) / abs(b) for a, b in zip(leg["grad_norms"], ref["grad_norms"]))
    return loss_err, norm_err


# ------------------------------------------------------------ sharded decode --
def _mesh_decode_params(dev):
    """Config #5 at full width, ``MESH_DECODE_LAYERS`` deep, from seed 0, in
    f32."""
    from accelerate_tpu_torch import LlamaConfig, init_llama

    config = LlamaConfig(**dict(CONFIG_KW, n_layers=MESH_DECODE_LAYERS))
    return config, init_llama(config, torch.Generator(device=dev).manual_seed(0), device=dev,
                              dtype=torch.float32)


def _engine_streams(params, config, dtype, mesh=None):
    """The engine over _engine_prompts (ENGINE_NEW tokens each): the
    streams, the stats, #6/#7 launches, the rank's pool bytes and the
    wall."""
    fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
    from accelerate_tpu_torch.serving import ServingEngine

    engine = ServingEngine(params, config, cache_dtype=dtype, mesh=mesh, **ENGINE_KW)
    reqs = [engine.submit(p, ENGINE_NEW) for p in _engine_prompts(config)]
    fa.paged_attention_decode.launches = 0
    fa.paged_attention_prefill.launches = 0
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = engine.stats()
    out = {"streams": [r.output_ids().tolist() for r in reqs], "wall": wall,
           "decode_steps": stats["decode_steps"], "prefill_chunks": stats["prefill_chunks"],
           "decode_seconds": stats["decode_seconds"],
           "launches": {"paged_attention_decode": fa.paged_attention_decode.launches,
                        "paged_attention_prefill": fa.paged_attention_prefill.launches},
           "pool_bytes": sum(t.numel() * t.element_size() for t in engine.pool.values()),
           "pool_elements": sum(t.numel() for t in engine.pool.values())}
    del engine
    return out


def mesh_decode_child(tmp: str) -> int:
    """One of ``phase_mesh_decode``'s two processes: config #5 under tp 2,
    greedy in f32, the engine in f32 and bf16, the planted fault."""
    from accelerate_tpu_torch import Accelerator, greedy_generate, llama_shard_rules
    from accelerate_tpu_torch.generation import MeshDecode
    from accelerate_tpu_torch.parallel.sharding import shard_params
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.utils import operations as ops

    state = _join_two(tmp)
    dev = state.device
    acc = Accelerator(device=dev, parallelism_config=ParallelismConfig(tp_size=2))
    config, whole = _mesh_decode_params(dev)
    whole_bytes = sum(t.numel() * t.element_size() for t in _leaves(whole))
    params, _ = shard_params(whole, acc.mesh, rules=llama_shard_rules())
    del whole
    torch.cuda.empty_cache()
    md = MeshDecode(params, config, acc.mesh)
    prompt = np.load(os.path.join(tmp, "prompt.npy"))
    report = {"param_bytes": md.block_bytes(), "whole_param_bytes": whole_bytes,
              "cache_bytes": 2 * config.n_layers * GEN_BATCH * (GEN_PROMPT + GEN_NEW)
              * md.kv_heads * config.head_dim * 4, "kv_heads": md.kv_heads}
    ops.reset_comm_counters()
    tokens, stats = greedy_generate(params, prompt, config, max_new_tokens=GEN_NEW,
                                    cache_dtype=torch.float32, mesh=acc.mesh, return_stats=True)
    report.update(tokens=tokens.tolist(), ms_per_step=1e3 * stats["seconds_per_token"],
                  prefill_ms=1e3 * stats["prefill_seconds"],
                  comm={op: c["bytes"] for op, c in ops.get_comm_counters().items()},
                  comm_calls={op: c["calls"] for op, c in ops.get_comm_counters().items()})
    ops.reset_comm_counters()
    report["engine_f32"] = _engine_streams(params, config, torch.float32, acc.mesh)
    report["engine_f32"]["comm"] = {op: c["bytes"] for op, c in
                                    ops.get_comm_counters().items()}
    bf16 = _tree_to(params, torch.bfloat16)
    report["engine_bf16"] = _engine_streams(bf16, config, torch.bfloat16, acc.mesh)
    del bf16
    with _mesh_decode_fault():
        report["fault_tokens"] = greedy_generate(
            params, prompt, config, max_new_tokens=MESH_DECODE_FAULT_NEW,
            cache_dtype=torch.float32, mesh=acc.mesh).tolist()
    del params
    torch.cuda.empty_cache()
    return _leave_two(state, tmp, report)


@contextlib.contextmanager
def _mesh_decode_fault():
    """The planted fault of phase_mesh_decode: no sum over tp after wo
    (each rank keeps its heads' part of the attention output)."""
    from accelerate_tpu_torch.generation import MeshDecode

    real = MeshDecode.attn_out
    MeshDecode.attn_out = lambda self, x: x
    try:
        yield
    finally:
        MeshDecode.attn_out = real


def _tie_gaps(f32, config, rows, n_prompt, dev) -> torch.Tensor:
    """How far each generated token of ``rows`` lies below the one-process
    f32 argmax of the cached forward over those same rows."""
    return _token_gaps(_generate_logits(f32, config, rows, n_prompt, dev), rows, n_prompt)


def phase_mesh_decode(dev):
    """Config #5 at full width, ``MESH_DECODE_LAYERS`` deep, under tp 2 (two processes on the
    one card over gloo): f32 greedy and the engine (f32, bf16) held to
    one-process runs here (see MESH_DECODE_TIE), per-rank param, cache and
    pool bytes, ms a decode step and the collectives' bytes by op, #6/#7
    launched on each rank, the planted fault failing the token bar.
    Returns each rank's #6/#7 launches of the bf16 engine."""
    import tempfile

    from accelerate_tpu_torch import greedy_generate

    t_phase = time.perf_counter()
    _reset_states()
    config, f32 = _mesh_decode_params(dev)
    prompt = np.random.default_rng(0).integers(0, config.vocab_size,
                                               (GEN_BATCH, GEN_PROMPT)).astype(np.int32)
    ref, ref_stats = greedy_generate(f32, prompt, config, max_new_tokens=GEN_NEW,
                                     cache_dtype=torch.float32, return_stats=True)
    ref_engine = _engine_streams(f32, config, torch.float32)
    print(f"[mesh-decode] one process, f32, config #5 ({config.n_layers} layers, dim "
          f"{config.dim}, {config.n_heads}/{config.n_kv_heads} heads, vocab {config.vocab_size}): "
          f"greedy {GEN_BATCH} x {GEN_PROMPT} + {GEN_NEW} at "
          f"{1e3 * ref_stats['seconds_per_token']:.2f} ms a decode step; engine "
          f"{len(ref_engine['streams'])} requests in {ref_engine['wall']:.2f} s, pool "
          f"{ref_engine['pool_bytes'] / 2**20:.1f} MiB")
    with tempfile.TemporaryDirectory(prefix="mesh_decode_") as tmp:
        np.save(os.path.join(tmp, "prompt.npy"), prompt)
        ranks = _run_two("--mesh-decode-child", tmp, "mesh-decode", MESH_2RANK_TIMEOUT_S)
    launches = []
    for i, r in enumerate(ranks):
        check(r["tokens"] == ranks[0]["tokens"], f"[mesh-decode] rank {i}'s tokens differ from "
                                                 "rank 0's")
        check(r["param_bytes"] <= MESH_DECODE_PARAM_SHARE * r["whole_param_bytes"],
              f"[mesh-decode] rank {i} holds {r['param_bytes']} of {r['whole_param_bytes']} "
              "param bytes")
        check(r["kv_heads"] == config.n_kv_heads // 2, f"[mesh-decode] rank {i} cache heads "
                                                       f"{r['kv_heads']}")
        print(f"[mesh-decode] tp 2 rank {i}: params {r['param_bytes'] / 2**30:.3f} GiB of "
              f"{r['whole_param_bytes'] / 2**30:.3f} ({r['param_bytes'] / r['whole_param_bytes']:.4f}), "
              f"f32 cache {r['cache_bytes'] / 2**20:.1f} MiB ({r['kv_heads']} kv heads); greedy "
              f"prefill {r['prefill_ms']:.1f} ms, {r['ms_per_step']:.2f} ms a decode step (one "
              f"process {1e3 * ref_stats['seconds_per_token']:.2f}); collectives of the greedy "
              f"run, bytes by op {r['comm']}, calls by op {r['comm_calls']}")
        for kind in ("engine_f32", "engine_bf16"):
            eng = r[kind]
            half = 2 * eng["pool_elements"] == ref_engine["pool_elements"]
            check(half, f"[mesh-decode] rank {i} {kind} pool of {eng['pool_elements']} elements, "
                        f"not half of {ref_engine['pool_elements']}")
            want = {"paged_attention_decode": config.n_layers * eng["decode_steps"],
                    "paged_attention_prefill": config.n_layers * eng["prefill_chunks"]}
            check(eng["launches"] == want and min(want.values()) > 0,
                  f"[mesh-decode] rank {i} {kind} launches {eng['launches']}, want {want}")
            print(f"[mesh-decode] rank {i} {kind}: {len(eng['streams'])} requests in "
                  f"{eng['wall']:.2f} s ({eng['decode_steps']} decode steps, "
                  f"{1e3 * eng['decode_seconds'] / eng['decode_steps']:.2f} ms a step), pool "
                  f"{eng['pool_bytes'] / 2**20:.1f} MiB (half), launches {eng['launches']}"
                  + (f", collectives by op {eng['comm']}" if "comm" in eng else ""))
        launches.append(r["engine_bf16"]["launches"])
    got = np.asarray(ranks[0]["tokens"])
    gaps = _tie_gaps(f32, config, got, GEN_PROMPT, dev)
    same = int((got[:, GEN_PROMPT:] == ref[:, GEN_PROMPT:]).sum())
    print(f"[mesh-decode] f32 greedy under tp 2: {same} of {got[:, GEN_PROMPT:].size} tokens equal "
          f"to one process; largest gap below the one-process f32 argmax over its own rows "
          f"{float(gaps.max()):.3e} (bar {MESH_DECODE_TIE:g})")
    check(float(gaps.max()) <= MESH_DECODE_TIE, f"[mesh-decode] a greedy token lies "
                                                f"{float(gaps.max())} below the f32 argmax")
    worst, same, total, by_len = 0.0, 0, 0, {}
    for got_s, ref_s, p in zip(ranks[0]["engine_f32"]["streams"], ref_engine["streams"],
                               _engine_prompts(config)):
        by_len.setdefault((len(p), len(got_s)), []).append(got_s)
        same += sum(a == b for a, b in zip(got_s[len(p):], ref_s[len(p):]))
        total += len(ref_s) - len(p)
    for (n_prompt, _), rows in by_len.items():  # the streams of one length in one batch
        worst = max(worst, float(_tie_gaps(f32, config, np.asarray(rows), n_prompt, dev).max()))
    print(f"[mesh-decode] f32 engine under tp 2: {same} of {total} tokens equal to the "
          f"one-process engine; largest gap below the one-process f32 argmax over its own "
          f"streams {worst:.3e} (bar {MESH_DECODE_TIE:g})")
    check(worst <= MESH_DECODE_TIE, f"[mesh-decode] an engine token lies {worst} below the f32 "
                                    "argmax")
    bad = np.asarray(ranks[0]["fault_tokens"])
    bad_gap = float(_tie_gaps(f32, config, bad, GEN_PROMPT, dev).max())
    print(f"[mesh-decode] planted fault (no sum over tp after wo): largest gap {bad_gap:.3e} "
          f"(bar {MESH_DECODE_TIE:g})")
    check(bad_gap > MESH_DECODE_TIE, "[mesh-decode] the planted fault passes the token bar")
    del f32
    torch.cuda.empty_cache()
    print(f"[mesh-decode] phase seconds {time.perf_counter() - t_phase:.1f}")
    return launches


# -- LOMO and the optimizer state offloaded to host memory (Queue A item 6) --
# phase_lomo: config #4 (LM774M_KW) at full width and depth in its recipe
# (bf16 params, remat "dots_no_batch", flash), LOMO_STEPS lomo_backward
# steps of SGD(LOMO_LR) on one fixed batch of 8 x 512, against as many
# prepare_train_step steps of sgd(LOMO_LR) from the same params: the same
# arithmetic with the whole gradient tree alive. The peak of both may fall
# at the loss head or the start of the backward, before any gradient
# exists (the f32 logits of 8 x 512 x 50257 are 0.82 GB, their gradient as
# much again), so the peak is printed without a bar; the bars are on the
# gradient bytes: memory allocated after the step returns less its value
# before the forward is the whole tree (1.72 GB) in the plain step and at
# most LOMO_LEFT_SHARE of it under LOMO; the most gradient bytes alive at
# once under LOMO (counted from each gradient's arrival until it is
# garbage) at most LOMO_LIVE_SHARE of the tree. Losses equal the plain
# steps' within LOMO_LOSS_RTOL (the same forward and the same bf16 update:
# only a kernel's summation order may differ). The fp16 leg: the same
# width at LOMO_FP16_LAYERS layers, f32 masters, plain attention (#1-#3
# take bf16 and f32); a planted overflow (the loss times an infinity from
# the batch) must leave the params bitwise unchanged and halve the scale,
# and the planted fault (the update applied in the finite-check pass)
# must fail that bar.
LOMO_LR, LOMO_STEPS, LOMO_FP16_LAYERS = 1e-2, 3, 4
LOMO_LEFT_SHARE, LOMO_LIVE_SHARE, LOMO_LOSS_RTOL = 0.1, 0.25, 1e-3
# phase_offload_opt: config #4 at full width and depth with f32 params and
# the whole recipe of examples/deepspeed_config_templates/
# zero_stage3_offload_config.json, through Accelerator(deepspeed_plugin=
# DeepSpeedPlugin(hf_ds_config=...)): bf16, AdamW from dummy_optim_kwargs,
# the template's gradient_clipping chained ahead, the optimizer state
# offloaded to pinned host memory; OFFLOAD_STEPS steps, held to as many
# steps of the same Accelerator's prepare_train_step(offload_optimizer=
# False) from the same params and batches: the arithmetic is the same per
# element (bitwise expected; any difference printed, under
# OFFLOAD_PARAM_RTOL relative). The peak (steps 2 on, once the state
# exists) must lie below the plain step's by OFFLOAD_PEAK_SHARE of the
# state's bytes. A group whose write-back is lost (the planted fault)
# must fail the equality bar.
OFFLOAD_TEMPLATE = "examples/deepspeed_config_templates/zero_stage3_offload_config.json"
OFFLOAD_STEPS, OFFLOAD_PARAM_RTOL, OFFLOAD_PEAK_SHARE = 3, 1e-6, 0.75


def _lm774m_batch(dev, config, seed=0):
    ids = np.random.default_rng(seed).integers(0, config.vocab_size,
                                               (LM774M_BATCH, config.max_seq_len))
    return {"input_ids": torch.from_numpy(ids.astype(np.int32)).to(dev)}


def _zero_flash_counters():
    fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
    for kern in FLASH_KERNELS:
        getattr(fa, kern).launches = 0


def _flash_counts() -> dict:
    fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
    return {kern: getattr(fa, kern).launches for kern in FLASH_KERNELS}


def _lomo_plain_leg(dev, config, batch):
    """LOMO_STEPS prepare_train_step steps of sgd(LOMO_LR): losses, ms a
    step, peak, and the bytes left after each step less before its forward
    (the gradient tree, which the plain step keeps in ``.grad``)."""
    from accelerate_tpu_torch import Accelerator, init_llama, llama_loss
    from accelerate_tpu_torch.optimizer import sgd

    _reset_states()
    acc = Accelerator(mixed_precision="no", device=dev)
    params, opt = acc.prepare(init_llama(config, torch.Generator(device=dev).manual_seed(0),
                                         device=dev, dtype=torch.bfloat16), sgd(LOMO_LR))
    seen = {}

    def loss_fn(p, b):
        seen["before"] = torch.cuda.memory_allocated()
        return llama_loss(p, b, config, remat="dots_no_batch")

    step = acc.prepare_train_step(loss_fn, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, left = [], []
    for k in range(LOMO_STEPS):
        if k == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        params, _, m = step(params, opt.opt_state, batch)
        left.append(torch.cuda.memory_allocated() - seen["before"])
        losses.append(m["loss"])
    torch.cuda.synchronize()
    out = {"ms": (time.perf_counter() - t0) / (LOMO_STEPS - 1) * 1e3,
           "peak": torch.cuda.max_memory_allocated(), "left": left,
           "losses": [float(v) for v in losses]}
    del params, opt, step
    torch.cuda.empty_cache()
    return out


def _lomo_fp16_leg(dev, fault: bool = False):
    """The fp16 leg: a normal LOMO step, then one on a batch whose loss is
    multiplied by an infinity. Returns (params unchanged bitwise by the
    overflowed step, the scale before and after it, the normal step moved
    the params). ``fault`` applies the update in the finite-check pass."""
    from accelerate_tpu_torch import Accelerator, LlamaConfig, init_llama, llama_loss
    from accelerate_tpu_torch.optimizer import param_leaves
    from accelerate_tpu_torch.utils.dataclasses import GradScalerConfig

    config = LlamaConfig(**dict(LM774M_KW, n_layers=LOMO_FP16_LAYERS, attn_impl="xla"))
    _reset_states()
    # a scale far inside fp16 for the normal step; the overflow is planted
    acc = Accelerator(mixed_precision="fp16", device=dev,
                      grad_scaler_config=GradScalerConfig(init_scale=2.0 ** 10))
    params = acc.prepare(init_llama(config, torch.Generator(device=dev).manual_seed(0),
                                    device=dev))
    batch = _lm774m_batch(dev, config)

    def loss_fn(p, b, mul):
        return llama_loss(p, b, config) * mul

    real_pass = Accelerator._lomo_pass
    if fault:  # the check pass updates too: an update made before the finite check
        def faulty(self, loss_fn, params, args, scale, learning_rate, axes):
            return real_pass(self, loss_fn, params, args, scale, learning_rate or LOMO_LR, axes)

        Accelerator._lomo_pass = faulty
    try:
        start = [t.detach().clone() for t in param_leaves(params)]
        acc.lomo_backward(loss_fn, params, batch, torch.ones((), device=dev),
                          learning_rate=LOMO_LR)
        moved = any(not torch.equal(a, b) for a, b in zip(start, param_leaves(params)))
        before = [t.detach().clone() for t in param_leaves(params)]
        scale0 = acc._lomo_scale
        loss, _ = acc.lomo_backward(loss_fn, params, batch, torch.full((), math.inf, device=dev),
                                    learning_rate=LOMO_LR)
        unchanged = all(torch.equal(a, b) for a, b in zip(before, param_leaves(params)))
        scale1 = acc._lomo_scale
    finally:
        Accelerator._lomo_pass = real_pass
    del params, start, before
    torch.cuda.empty_cache()
    return unchanged, scale0, scale1, moved


def phase_lomo(dev):
    """``Accelerator.lomo_backward`` on config #4 (see LOMO_LR's comment):
    bars on the gradient bytes, losses against the plain SGD step, #1-#3's
    launches (72 / 36 / 36 a step), the fp16 overflow and its planted
    fault. Returns the LOMO leg's flash launches."""
    from accelerate_tpu_torch import Accelerator, LlamaConfig, init_llama, llama_loss
    from accelerate_tpu_torch.optimizer import param_leaves

    config = LlamaConfig(**LM774M_KW)
    batch = _lm774m_batch(dev, config)
    _reset_states()
    acc = Accelerator(mixed_precision="no", device=dev)
    params = acc.prepare(init_llama(config, torch.Generator(device=dev).manual_seed(0),
                                    device=dev, dtype=torch.bfloat16))
    tree = sum(t.numel() * t.element_size() for t in param_leaves(params))

    def loss_fn(p, b):
        return llama_loss(p, b, config, remat="dots_no_batch")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_flash_counters()
    losses, left, live = [], [], []
    for k in range(LOMO_STEPS):
        if k == 1:  # the first step warms up: steps 2 on are timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        before = torch.cuda.memory_allocated()
        loss, params = acc.lomo_backward(loss_fn, params, batch, learning_rate=LOMO_LR)
        left.append(torch.cuda.memory_allocated() - before)
        live.append(acc.lomo_stats["max_live_bytes"])
        losses.append(loss)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / (LOMO_STEPS - 1) * 1e3
    peak = torch.cuda.max_memory_allocated()
    launches = _flash_counts()
    losses = [float(v) for v in losses]
    del params
    torch.cuda.empty_cache()
    plain = _lomo_plain_leg(dev, config, batch)
    print(f"[lomo] config #4, bf16 params, remat 'dots_no_batch', flash, batch "
          f"{LM774M_BATCH} x {config.max_seq_len}, SGD({LOMO_LR:g}); gradient tree "
          f"{tree / 1e9:.3f} GB")
    print(f"[lomo] LOMO: {ms:.1f} ms/step, peak {peak / 2**30:.2f} GiB, bytes left after the "
          f"step {left}, most gradient bytes alive {max(live) / 1e9:.4f} GB "
          f"({max(live) / tree:.4f} of the tree); losses " + " ".join(f"{v:.5f}" for v in losses))
    print(f"[lomo] plain SGD step: {plain['ms']:.1f} ms/step, peak {plain['peak'] / 2**30:.2f} "
          f"GiB, bytes left after the step {plain['left']}; losses "
          + " ".join(f"{v:.5f}" for v in plain["losses"]))
    print(f"[lomo] launches in {LOMO_STEPS} LOMO steps: {launches}")
    want = {"flash_attention_fwd": 2 * config.n_layers * LOMO_STEPS,
            "flash_attention_dq": config.n_layers * LOMO_STEPS,
            "flash_attention_dkdv": config.n_layers * LOMO_STEPS}
    check(launches == want, f"[lomo] launches {launches}, want {want}")
    check(max(left) <= LOMO_LEFT_SHARE * tree,
          f"[lomo] {max(left)} bytes left after a LOMO step, over {LOMO_LEFT_SHARE} of the "
          f"{tree}-byte gradient tree")
    check(min(plain["left"]) >= 0.9 * tree,
          f"[lomo] the plain step keeps {plain['left']} bytes, not its gradient tree ({tree}): "
          "the measurement does not see the gradients")
    check(max(live) <= LOMO_LIVE_SHARE * tree,
          f"[lomo] {max(live)} gradient bytes alive at once, over {LOMO_LIVE_SHARE} of {tree}")
    err = max(abs(a - b) / abs(b) for a, b in zip(losses, plain["losses"]))
    print(f"[lomo] losses against the plain SGD steps: max rel err {err:.3e} "
          f"(bar {LOMO_LOSS_RTOL:g})")
    check(err <= LOMO_LOSS_RTOL, f"[lomo] losses {losses} vs plain {plain['losses']}")
    unchanged, s0, s1, moved = _lomo_fp16_leg(dev)
    print(f"[lomo] fp16 leg ({LOMO_FP16_LAYERS} layers, plain attention): a normal step moved "
          f"the params {moved}; the planted overflow left them bitwise unchanged {unchanged}, "
          f"scale {s0:g} -> {s1:g}")
    check(moved and unchanged and s1 == s0 / 2,
          "[lomo] fp16: the overflowed step changed the params or did not halve the scale")
    f_unchanged, _, f_s1, _ = _lomo_fp16_leg(dev, fault=True)
    print(f"[lomo] planted fault (the update applied before the finite check): params "
          f"unchanged {f_unchanged}, scale -> {f_s1:g}; caught {not f_unchanged}")
    check(not f_unchanged, "[lomo] the planted fault passes the overflow bar")
    return launches


def _offload_leg(dev, acc, plugin, config, batches, offload: bool, fault=None,
                 profile: bool = False):
    """OFFLOAD_STEPS steps of config #4 through ``acc`` from the seed-0 f32
    params (``offload`` keeps the optimizer state on the host): losses, the
    final params, ms a step and peak over steps 2 on, the state's bytes on
    the device and the host, and with ``profile`` one more profiled step
    (the copies' device time and overlap). ``fault`` plants one of
    ``multihost_script._fault``'s faults."""
    from accelerate_tpu_torch import init_llama, llama_loss
    from accelerate_tpu_torch.utils.dataclasses import DummyOptim

    params, opt = acc.prepare(init_llama(config, torch.Generator(device=dev).manual_seed(0),
                                         device=dev), DummyOptim(**plugin.dummy_optim_kwargs()))
    step = acc.prepare_train_step(lambda p, b: llama_loss(p, b, config, remat="dots_no_batch"),
                                  opt, offload_optimizer=offload)
    check(offload == (opt.offload is not None), f"[offload-opt] offload {offload} not applied")
    from accelerate_tpu_torch.test_utils.scripts.multihost_script import _fault

    with _fault(fault):
        losses = []
        params, _, m = step(params, opt.opt_state, batches[0])
        losses.append(m["loss"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_flash_counters()
        t0 = time.perf_counter()
        for b in batches[1:]:
            params, _, m = step(params, opt.opt_state, b)
            losses.append(m["loss"])
        torch.cuda.synchronize()
    out = {"ms": (time.perf_counter() - t0) / (len(batches) - 1) * 1e3,
           "peak": torch.cuda.max_memory_allocated(), "launches": _flash_counts(),
           "losses": [float(v) for v in losses],
           "params": [t.detach().to("cpu", copy=True) for t in _leaves(params)],
           "device_state": opt.device_state_bytes(), "state": opt.state_bytes()}
    if offload:
        out["host_state"] = opt.offload.host_bytes()
        out["groups"] = opt.offload.stats["groups"] // opt.offload.stats["steps"]
        out["offload"] = opt.offload
    if profile:
        from torch.profiler import ProfilerActivity, profile as torch_profile

        h2d0, d2h0 = opt.offload.stats["h2d_bytes"], opt.offload.stats["d2h_bytes"]
        prof = torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
        step(params, opt.opt_state, batches[-1])
        torch.cuda.synchronize()
        prof.stop()
        out["profile"] = (prof, opt.offload.stats["h2d_bytes"] - h2d0,
                          opt.offload.stats["d2h_bytes"] - d2h0)
    # nothing of this leg may stay on the card during the next: the
    # Accelerator keeps what it prepared (the params, and the optimizers that
    # hold their last gradients and the state) until free_memory
    opt.zero_grad(set_to_none=True)
    del params, opt, step
    acc.free_memory()
    return out


def _param_errs(got, want) -> tuple:
    """(bitwise equal, largest relative L2 error of a leaf)."""
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max(float(torch.linalg.vector_norm((a - b).float())
                    / max(float(torch.linalg.vector_norm(b.float())), 1e-30))
              for a, b in zip(got, want))
    return same, err


def _pinned_copy_rates(offload, dev) -> tuple:
    """GB/s of one host-to-device and one device-to-host pass over every
    offloaded state tensor, alone (CUDA events around the pass)."""
    host = [v for st in offload.optimizer.state.values() for v in st.values()
            if isinstance(v, torch.Tensor) and v.dim() > 0]
    nbytes = sum(v.numel() * v.element_size() for v in host)
    dev_copies = [torch.empty_like(v, device=dev) for v in host]
    rates = []
    for direction in ("h2d", "d2h"):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        for h, d in zip(host, dev_copies):
            (d.copy_(h, non_blocking=True) if direction == "h2d"
             else h.copy_(d, non_blocking=True))
        ev[1].record()
        torch.cuda.synchronize()
        rates.append(nbytes / (ev[0].elapsed_time(ev[1]) * 1e-3) / 1e9)
    del dev_copies
    torch.cuda.empty_cache()
    return nbytes, rates[0], rates[1]


def phase_offload_opt(dev):
    """Config #4's AdamW state offloaded to pinned host memory, through the
    DeepSpeed plugin and its template (see OFFLOAD_TEMPLATE's comment):
    equality with the plain step, the peak bar, the bytes on the device
    and on the host, host-to-device and device-to-host GB/s in the step
    against one pinned pass of the same bytes alone, the copies' overlap
    with kernels in a profiled step, and the planted fault. Returns the
    offloaded leg's flash launches."""
    from accelerate_tpu_torch import Accelerator, LlamaConfig
    from accelerate_tpu_torch.utils.dataclasses import DeepSpeedPlugin

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, OFFLOAD_TEMPLATE)) as f:
        plugin = DeepSpeedPlugin(hf_ds_config=json.load(f))
    config = LlamaConfig(**LM774M_KW)
    batches = [_lm774m_batch(dev, config, seed) for seed in range(OFFLOAD_STEPS)]
    _reset_states()
    acc = Accelerator(deepspeed_plugin=plugin, device=dev)
    check(acc.mixed_precision == "bf16" and acc._offload_optimizer
          and acc._plugin_grad_clip == 1.0 and plugin.zero_stage == 3,
          f"[offload-opt] the template's recipe was not taken: {plugin}")
    print(f"[offload-opt] {OFFLOAD_TEMPLATE}: zero stage {plugin.zero_stage}, mixed precision "
          f"{acc.mixed_precision}, AdamW {plugin.dummy_optim_kwargs()}, gradient clipping "
          f"{plugin.gradient_clipping}, optimizer offload {plugin.offload_optimizer_device!r}; "
          f"config #4 f32 params, remat 'dots_no_batch', flash, batch {LM774M_BATCH} x "
          f"{config.max_seq_len}")
    plain = _offload_leg(dev, acc, plugin, config, batches, offload=False)
    off = _offload_leg(dev, acc, plugin, config, batches, offload=True, profile=True)
    same, err = _param_errs(off["params"], plain["params"])
    losses_same = off["losses"] == plain["losses"]
    state = plain["state"]
    prof, h2d_bytes, d2h_bytes = off.pop("profile")
    nbytes, h2d_alone, d2h_alone = _pinned_copy_rates(off.pop("offload"), dev)
    rates = {}
    for kind, moved in (("HtoD", h2d_bytes), ("DtoH", d2h_bytes)):
        ov = _copy_overlap(prof, kind)
        rates[kind] = None if ov is None else (moved / (ov[0] * 1e-6) / 1e9, ov[1] / ov[0])
    print(f"[offload-opt] plain: {plain['ms']:.1f} ms/step, peak {plain['peak'] / 2**30:.2f} "
          f"GiB, optimizer state on the device {plain['device_state'] / 1e9:.3f} GB; losses "
          + " ".join(f"{v:.5f}" for v in plain["losses"]))
    print(f"[offload-opt] offloaded: {off['ms']:.1f} ms/step, peak {off['peak'] / 2**30:.2f} "
          f"GiB, optimizer state on the device {off['device_state'] / 1e9:.3f} GB, on the host "
          f"{off['host_state'] / 1e9:.3f} GB, {off['groups']} groups a step; losses "
          + " ".join(f"{v:.5f}" for v in off["losses"]))
    for kind, alone in (("HtoD", h2d_alone), ("DtoH", d2h_alone)):
        r = rates[kind]
        print(f"[offload-opt] {kind} in a profiled step: "
              + ("not measured (the profiler gave no device copies)" if r is None else
                 f"{r[0]:.2f} GB/s, {r[1]:.3f} of the copy time beside kernels on another "
                 f"stream") + f"; one pinned pass of the {nbytes / 1e9:.3f} GB alone "
              f"{alone:.2f} GB/s")
    print(f"[offload-opt] against the plain steps: losses equal {losses_same}, params bitwise "
          f"{same} (largest leaf rel L2 {err:.3e}, bar {OFFLOAD_PARAM_RTOL:g}); peak "
          f"{(plain['peak'] - off['peak']) / 1e9:.3f} GB below the plain step's "
          f"({(plain['peak'] - off['peak']) / state:.3f} of the state's {state / 1e9:.3f} GB, "
          f"bar {OFFLOAD_PEAK_SHARE})")
    check(off["device_state"] == 0 and off["host_state"] == state,
          f"[offload-opt] state on the device {off['device_state']}, host {off['host_state']}")
    check(err <= OFFLOAD_PARAM_RTOL and max(
        abs(a - b) / abs(b) for a, b in zip(off["losses"], plain["losses"])) <= OFFLOAD_PARAM_RTOL,
          f"[offload-opt] the offloaded steps differ from the plain ones: params {err}")
    check(plain["peak"] - off["peak"] >= OFFLOAD_PEAK_SHARE * state,
          f"[offload-opt] peak {off['peak']} not {OFFLOAD_PEAK_SHARE} of {state} below "
          f"{plain['peak']}")
    want = {"flash_attention_fwd": 2 * config.n_layers * (OFFLOAD_STEPS - 1),
            "flash_attention_dq": config.n_layers * (OFFLOAD_STEPS - 1),
            "flash_attention_dkdv": config.n_layers * (OFFLOAD_STEPS - 1)}
    check(off["launches"] == want == plain["launches"],
          f"[offload-opt] launches {off['launches']} / {plain['launches']}, want {want}")
    del plain["params"]
    fault = _offload_leg(dev, acc, plugin, config, batches, offload=True,
                         fault="offload_lost_write_back")
    f_same, f_err = _param_errs(fault["params"], off["params"])
    print(f"[offload-opt] planted fault (the first group's write-back lost): params rel L2 "
          f"{f_err:.3e} from the sound run; caught {f_err > OFFLOAD_PARAM_RTOL}")
    check(f_err > OFFLOAD_PARAM_RTOL, "[offload-opt] the planted fault passes the equality bar")
    return off["launches"]

# phase_checkpoint: config #4 at full width, CKPT_LAYERS deep, in phase_lm774m's
# recipe (bf16 params, adafactor(1e-4), flash, remat "dots_no_batch"), one
# step a call through prepare_train_step on batches of default_rng(seed)
CKPT_SEEDS = (0, 1, 2)  # the batches of steps 1-3
CKPT_SHARD = "500MB"  # save_model's max_shard_size: several shards of the f32 export
# depth cut to 12 of config #4's 36 layers for the script's clock
# (the whole script took 1084.5 s on a slow host): every check is bitwise
CKPT_LAYERS = 12


def _ckpt_setup(dev, seed, project_dir):
    from accelerate_tpu_torch import Accelerator, LlamaConfig, init_llama, llama_loss
    from accelerate_tpu_torch.optimizer import adafactor

    _reset_states()
    config = LlamaConfig(**dict(LM774M_KW, n_layers=CKPT_LAYERS))
    acc = Accelerator(mixed_precision="no", rng_seed=0, device=dev, project_dir=project_dir)
    init = init_llama(config, torch.Generator(device=dev).manual_seed(seed), device=dev,
                      dtype=torch.bfloat16)
    params, opt = acc.prepare(init, adafactor(LM774M_LR))
    del init
    step = acc.prepare_train_step(lambda p, b: llama_loss(p, b, config, remat="dots_no_batch"),
                                  opt)
    return acc, config, params, opt, step


def _npz_arrays(path) -> dict:
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def _same_arrays(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and a[k].tobytes() == b[k].tobytes()
        for k in a)


def _pinned_pass_gbs(tensors) -> float:
    """GB/s of one device-to-host pass of ``tensors`` into pinned buffers
    (CUDA events around the copies)."""
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    ev[1].record()
    torch.cuda.synchronize()
    return nbytes / (ev[0].elapsed_time(ev[1]) * 1e-3) / 1e9


def phase_checkpoint(dev):
    """Checkpoints of config #4 at full width, ``CKPT_LAYERS`` deep: 2 steps, a
    blocking ``save_state``, step 3; a fresh ``Accelerator`` with params
    from another seed, ``load_state``, step 3 again: the loss and every
    param bitwise, flash #1-#3 launched 2/1/1 times a layer. Then, on the
    resumed run: 2 steps with no writer, a blocking save, an async save
    followed at once by 2 steps (the snapshot stall, the writer's time,
    the step ms with the writer in flight against none, device-to-host
    GB/s against one pinned pass of the same tensors, disk write and
    (warm) read GB/s, free disk before), and the async save's arrays equal
    to the blocking save's, byte for byte, though the steps behind it
    changed the params; ``save_model`` (``CKPT_SHARD`` shards) and
    ``load_checkpoint_in_model`` bitwise; planted faults: a flipped byte
    in a shard file raises ``CheckpointCorruptError`` naming it, and a
    newest ``checkpoint_<i>`` without ``_COMMITTED`` is passed over by
    ``load_state("latest")``."""
    import shutil
    import tempfile

    from accelerate_tpu_torch.checkpointing import (
        CheckpointCorruptError,
        find_latest_checkpoint,
        load_checkpoint_in_model,
        load_flat,
    )
    from accelerate_tpu_torch.optimizer import param_leaves

    tmp = tempfile.mkdtemp(prefix="ckpt_")
    try:
        free = shutil.disk_usage(tmp).free
        acc, config, params, opt, step = _ckpt_setup(dev, 0, tmp)
        batches = [_lm774m_batch(dev, config, seed) for seed in CKPT_SEEDS]
        state = opt.opt_state
        for k in range(2):
            params, state, m = step(params, state, batches[k])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dir_a = acc.save_state(os.path.join(tmp, "a"))
        save_s = time.perf_counter() - t0
        snap_a = acc.last_checkpoint
        params, state, m = step(params, state, batches[2])
        loss3 = float(m["loss"])
        ref = [t.detach().clone() for t in param_leaves(params)]
        del acc, params, opt, step, state, m
        torch.cuda.empty_cache()

        acc, config, params, opt, step = _ckpt_setup(dev, 1, tmp)
        t0 = time.perf_counter()
        acc.load_state(dir_a)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        _zero_flash_counters()
        params, state, m = step(params, opt.opt_state, batches[2])
        torch.cuda.synchronize()
        launches = _flash_counts()
        resumed = float(m["loss"])
        bitwise = all(torch.equal(a, b) for a, b in zip(param_leaves(params), ref))
        del ref
        print(f"[checkpoint] config #4 ({config.n_layers} layers, dim {config.dim}, bf16 params, "
              f"adafactor({LM774M_LR:g}), flash, remat 'dots_no_batch', batch {LM774M_BATCH} x "
              f"{config.max_seq_len}); blocking save of {snap_a.nbytes / 1e9:.3f} GB after 2 "
              f"steps: {save_s:.3f} s (snapshot {snap_a.snapshot_s:.3f} s, write "
              f"{snap_a.write_s:.3f} s, commit {snap_a.commit_s:.3f} s); load into a fresh "
              f"Accelerator (params from seed 1) {load_s:.3f} s")
        print(f"[checkpoint] step 3: loss {loss3!r} uninterrupted, {resumed!r} resumed; params "
              f"bitwise {bitwise}; launches in the resumed step {launches}")
        want = {"flash_attention_fwd": 2 * config.n_layers,
                "flash_attention_dq": config.n_layers, "flash_attention_dkdv": config.n_layers}
        check(launches == want, f"[checkpoint] launches {launches}, want {want}")
        check(resumed == loss3 and bitwise, f"[checkpoint] the resumed step 3 differs: loss "
                                            f"{resumed!r} vs {loss3!r}, params bitwise {bitwise}")

        def timed(n):
            nonlocal params, state
            walls = []
            for k in range(n):
                t0 = time.perf_counter()
                params, state, _ = step(params, state, batches[k % len(batches)])
                torch.cuda.synchronize()
                walls.append(1e3 * (time.perf_counter() - t0))
            return walls

        plain_ms = timed(2)
        dir_c = acc.save_state(os.path.join(tmp, "c"))
        t0 = time.perf_counter()
        dir_b = acc.save_state(os.path.join(tmp, "b"), blocking=False)
        stall_s = time.perf_counter() - t0
        snap_b = acc.last_checkpoint
        inflight_ms = timed(2)
        in_flight = acc._checkpoint_manager.pending()
        t0 = time.perf_counter()
        acc.wait_for_checkpoint()
        drain_s = time.perf_counter() - t0
        same = all(_same_arrays(_npz_arrays(os.path.join(dir_b, f)),
                                _npz_arrays(os.path.join(dir_c, f)))
                   for f in ("model.npz", "optimizer.npz"))
        emb = _npz_arrays(os.path.join(dir_b, "model.npz"))["embed_tokens/embedding"]
        live = params["embed_tokens"]["embedding"].detach().view(torch.int16).cpu().numpy()
        moved = live.tobytes() != emb.tobytes()
        leaves = param_leaves(params) + [v for st in opt.optimizer.state.values()
                                         for v in st.values() if isinstance(v, torch.Tensor)]
        pinned = _pinned_pass_gbs(leaves)
        path = os.path.join(dir_b, "model.npz")
        t0 = time.perf_counter()
        load_flat(path)
        read_gbs = os.path.getsize(path) / (time.perf_counter() - t0) / 1e9
        write_bytes = sum(os.path.getsize(os.path.join(dir_b, f)) for f in os.listdir(dir_b))
        print(f"[checkpoint] async save of {snap_b.nbytes / 1e9:.3f} GB: save_state returned in "
              f"{stall_s:.3f} s (snapshot {snap_b.snapshot_s:.3f} s, device-to-host "
              f"{snap_b.nbytes / snap_b.snapshot_s / 1e9:.2f} GB/s; one pinned pass of the same "
              f"tensors alone {pinned:.2f} GB/s); writer {snap_b.write_s:.3f} s write + "
              f"{snap_b.commit_s:.3f} s commit ({write_bytes / snap_b.write_s / 1e9:.2f} GB/s "
              f"to disk), {in_flight} save(s) still in flight after the 2 steps, drain "
              f"{drain_s:.3f} s; disk read {read_gbs:.2f} GB/s (warm); free disk before "
              f"{free / 1e9:.1f} GB")
        print(f"[checkpoint] step ms with no writer " + " ".join(f"{v:.1f}" for v in plain_ms)
              + ", with the writer in flight " + " ".join(f"{v:.1f}" for v in inflight_ms)
              + f"; async files equal the blocking save's byte for byte: {same}; the steps "
              f"after it changed the params: {moved}")
        check(same and moved, f"[checkpoint] the async save holds other bytes than the blocking "
                              f"one (equal {same}) or the steps did not move the params ({moved})")
        shutil.rmtree(dir_c)

        t0 = time.perf_counter()
        files = acc.save_model(params, os.path.join(tmp, "model"), max_shard_size=CKPT_SHARD)
        export_s = time.perf_counter() - t0
        back = load_checkpoint_in_model(params, os.path.join(tmp, "model"))
        export_same = all(torch.equal(a, b) for a, b in zip(param_leaves(back), param_leaves(params)))
        del back
        torch.cuda.empty_cache()
        print(f"[checkpoint] save_model(max_shard_size={CKPT_SHARD!r}): {len(files)} safetensors "
              f"files, {sum(os.path.getsize(f) for f in files) / 1e9:.3f} GB (bf16 as f32) in "
              f"{export_s:.3f} s; load_checkpoint_in_model bitwise {export_same}")
        check(export_same and len(files) > 1, f"[checkpoint] save_model round trip: bitwise "
                                              f"{export_same}, {len(files)} files")
        shutil.rmtree(os.path.join(tmp, "model"))

        dir_s = acc.save_state(os.path.join(tmp, "s"), sharded=True)
        shard = os.path.join(dir_s, "model-shard-00000.bin")
        with open(shard, "r+b") as f:
            f.seek(os.path.getsize(shard) // 2)
            byte = f.read(1)
            f.seek(-1, 1)
            f.write(bytes([byte[0] ^ 0xFF]))
        try:
            acc.load_state(dir_s)
            caught = None
        except CheckpointCorruptError as e:
            caught = e.path
        print(f"[checkpoint] planted fault: one byte flipped in {os.path.basename(shard)}; "
              f"load_state raised CheckpointCorruptError naming {caught}")
        check(caught == shard, f"[checkpoint] the flipped byte was not caught ({caught})")
        shutil.rmtree(dir_s)

        acc.project_configuration.automatic_checkpoint_naming = True
        first = acc.save_state()
        torn = os.path.join(os.path.dirname(first), "checkpoint_1")
        shutil.copytree(first, torn)
        os.remove(os.path.join(torn, "_COMMITTED"))
        os.remove(os.path.join(torn, "model.npz"))
        latest = find_latest_checkpoint(os.path.dirname(first))
        acc.load_state("latest")
        print(f"[checkpoint] planted fault: newest dir {os.path.basename(torn)} left uncommitted "
              f"(no _COMMITTED, no model.npz); load_state('latest') took "
              f"{os.path.basename(latest)}")
        check(latest == first, f"[checkpoint] 'latest' took {latest}, not {first}")
        acc.end_training()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _reset_states()
    torch.cuda.empty_cache()


# ------------------------------------------------------------ fp8 and quant --
# phase_fp8, leg 1: the JAX package's own fp8 leg (benchmarks/attention/
# run.py:171-232, its TPU configuration): dim 1024, 8 layers, 16/8 heads,
# vocab 32000, batch 4 x 1024, sgd(1e-3); f32 params through fp8_dot against
# the same step on bf16-cast params. attn_impl="flash", as for config #4.
FP8_BENCH_KW = dict(vocab_size=32000, dim=1024, n_layers=8, n_heads=16, n_kv_heads=8,
                    max_seq_len=1024, attn_impl="flash")
FP8_BENCH_BATCH, FP8_BENCH_LR, FP8_BENCH_STEPS = 4, 1e-3, 10
# leg 2: config #4 (LM774M_KW) in phase_lm774m's recipe (bf16 params,
# adafactor(1e-4), remat "dots_no_batch") under Accelerator(mixed_precision=
# "fp8") with dtype_recipe="fp8" and accumulation FP8_ACCUM: one window to
# warm, then FP8_MICRO micro-steps timed, checked and counted; a bf16 run
# of the same steps beside it. Under remat each product's forward runs twice a
# micro-step (forward and recompute), as the flash forward does.
FP8_ACCUM, FP8_MICRO = 2, 4
# _scaled_mm against the plain version (the same fp8 operands upcast, an f32
# product on the card with TF32 off) at config #4's three product shapes
# (M, K, N) of a micro-step's 8 x 512 tokens: both accumulate the exact fp8
# products in f32 in another order (cuBLASLt's fp8 tensor cores keep a
# narrower partial sum between its promotions to f32), so each product is
# held to FP8_PRODUCT_RTOL of the plain output's largest magnitude
FP8_PRODUCT_SHAPES = {"qkvo": (4096, 1280, 1280), "w1_w3": (4096, 1280, 3584),
                      "w2": (4096, 3584, 1280)}
FP8_PRODUCT_RTOL = 2e-3
PEAK_FP8_OPS_PER_S = 1979e12  # dense fp8 and int8 tensor cores, H100 SXM data sheet
# phase_quant: config #5 (CONFIG_KW, bf16) quantized to int8 and NF4 (the
# JAX package's QuantizationConfig defaults: blocks of 64, embeddings and
# head dense, leaves of at least 4096 elements); int8_dynamic_matmul at a
# 1024-token chunk through config #5's w1 (2048 x 5632), k-blocks of 128
QUANT_KINDS = (("int8", dict(load_in_8bit=True)), ("nf4", dict(load_in_4bit=True)))
INT8_MM_SHAPE, INT8_MM_BLOCK = (1024, 2048, 5632), 128


def _fp8_bench_leg(dev):
    """The JAX bench's fp8 leg on the card: ``fp8_step_ms``, ``bf16_step_ms``,
    ``fp8_over_bf16`` and ``loss_rel_delta`` (the first step's losses, from
    the same init), with the scaled_mm launches of the fp8 steps counted."""
    from accelerate_tpu_torch import LlamaConfig, init_llama, llama_loss
    from accelerate_tpu_torch.ops import fp8
    from accelerate_tpu_torch.optimizer import AcceleratedOptimizer, param_leaves, sgd

    base = LlamaConfig(**FP8_BENCH_KW)
    ids = np.random.default_rng(0).integers(0, base.vocab_size,
                                            (FP8_BENCH_BATCH, base.max_seq_len))
    batch = {"input_ids": torch.from_numpy(ids.astype(np.int32)).to(dev)}

    def run(recipe):
        cfg = dataclasses.replace(base, dtype_recipe=recipe)
        params = init_llama(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                            dtype=torch.float32 if recipe else torch.bfloat16)
        for t in param_leaves(params):
            t.requires_grad_(True)
        opt = (fp8.make_fp8_optimizer(sgd(FP8_BENCH_LR), params) if recipe
               else AcceleratedOptimizer(sgd(FP8_BENCH_LR)))
        opt.init(params)

        def step():
            loss = llama_loss(params, batch, cfg)
            loss.backward()
            opt.step()
            opt.zero_grad()
            return loss.detach()

        first = float(step())
        step()
        torch.cuda.synchronize()
        fp8.scaled_mm.launches = 0
        t0 = time.perf_counter()
        for _ in range(FP8_BENCH_STEPS):
            step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / FP8_BENCH_STEPS * 1e3
        return ms, first, fp8.scaled_mm.launches

    bf16_ms, bf16_loss, _ = run(None)
    fp8_ms, fp8_loss, launches = run("fp8")
    want = 3 * 7 * base.n_layers * FP8_BENCH_STEPS
    check(launches == want, f"[fp8-bench] scaled_mm launches {launches}, want {want}")
    out = {"bf16_step_ms": round(bf16_ms, 3), "fp8_step_ms": round(fp8_ms, 3),
           "fp8_over_bf16": round(fp8_ms / bf16_ms, 3),
           "loss_rel_delta": round(abs(fp8_loss - bf16_loss) / max(abs(bf16_loss), 1e-9), 5),
           "seq": base.max_seq_len, "batch": FP8_BENCH_BATCH}
    check(math.isfinite(fp8_loss) and out["loss_rel_delta"] < 1e-2,
          f"[fp8-bench] first-step losses fp8 {fp8_loss} vs bf16 {bf16_loss}")
    print(f"[fp8-bench] benchmarks/attention/run.py's fp8 leg (dim {base.dim}, {base.n_layers} "
          f"layers, {base.n_heads}/{base.n_kv_heads} heads, batch {FP8_BENCH_BATCH} x "
          f"{base.max_seq_len}, sgd({FP8_BENCH_LR:g}), f32 params through fp8_dot vs bf16 "
          f"params): {json.dumps(out)}; scaled_mm launches in {FP8_BENCH_STEPS} steps "
          f"{launches}")
    return out


def _fp8_products(dev):
    """Each of ``FP8_PRODUCT_SHAPES``: the forward, dx and dw products of
    fp8_dot (e4m3 x and w, e5m2 g, scales from primed histories) through
    ``scaled_mm`` against the plain version on the same fp8 tensors, with
    device times, the bound and one bf16 ``torch.matmul`` of the shape."""
    from accelerate_tpu_torch.ops import fp8

    recipe = fp8.FP8Recipe()
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for name, (M, K, N) in FP8_PRODUCT_SHAPES.items():
        x = torch.randn(M, K, generator=gen, device=dev, dtype=torch.bfloat16)
        w = (torch.randn(K, N, generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
        g = (torch.randn(M, N, generator=gen, device=dev) * 1e-3).to(torch.bfloat16)
        scales = [fp8._scale_from_history(fp8._amax(t).float().reshape(1), m, recipe)
                  for t, m in ((x, fp8.E4M3_MAX), (w, fp8.E4M3_MAX), (g, recipe.grad_max))]
        sx, sw, sg = scales
        qx = fp8._quantize(x, sx, fp8.E4M3_MAX, torch.float8_e4m3fn)
        qw = fp8._quantize(w, sw, fp8.E4M3_MAX, torch.float8_e4m3fn)
        qg = fp8._quantize(g, sg, recipe.grad_max, recipe.grad_dtype)
        products = {"fwd": (qx, qw.T.contiguous(), sx, sw, M, K, N),
                    "dx": (qg, qw, sg, sw, M, N, K),
                    "dw": (qx.T.contiguous(), qg.T.contiguous(), sx, sg, K, M, N)}
        for kind, (a, b_t, sa, sb, m, k, n) in products.items():
            got = fp8.scaled_mm(a, b_t, sa, sb)
            want = (a.float() @ b_t.float().T) / (sa * sb)
            err = float((got - want).abs().max() / want.abs().max())
            check(err <= FP8_PRODUCT_RTOL, f"[fp8-products] {name} {kind}: max err {err} of the "
                                           f"largest output, bar {FP8_PRODUCT_RTOL}")
            a16, b16 = a.to(torch.bfloat16), b_t.T.to(torch.bfloat16)
            launches = fp8.scaled_mm.launches
            ms = time_ms(lambda i: fp8.scaled_mm(a, b_t, sa, sb), 1, 20)
            fast_ms = time_ms(lambda i: torch._scaled_mm(
                a, b_t.T, scale_a=torch.reciprocal(sa).reshape(()),
                scale_b=torch.reciprocal(sb).reshape(()), out_dtype=torch.float32,
                use_fast_accum=True), 1, 20)
            fp8.scaled_mm.launches = launches  # timing launches are not the path's
            plain_ms = time_ms(lambda i: (a.float() @ b_t.float().T) / (sa * sb), 1, 20)
            library_ms = time_ms(lambda i: a16 @ b16, 1, 20)
            ops_s = 2.0 * m * k * n / PEAK_FP8_OPS_PER_S
            bytes_s = (m * k + k * n + 4 * m * n) / HBM_BYTES_PER_S
            rows[f"{name}_{kind}"] = {
                "shape": [m, k, n], "max_err_rel": err, "ms": ms, "fast_accum_ms": fast_ms,
                "plain_ms": plain_ms, "library_bf16_ms": library_ms,
                "bound_ms": max(ops_s, bytes_s) * 1e3,
                "bound_by": "operations" if ops_s >= bytes_s else "bytes"}
    print(f"[fp8-products] _scaled_mm (use_fast_accum=False, the port's) against the plain f32 "
          f"product of the same fp8 operands, bar {FP8_PRODUCT_RTOL} of the largest output; "
          f"fast_accum_ms (not used by the port) and one bf16 torch.matmul of the shape as "
          f"yardsticks: {json.dumps(rows)}")
    return rows


def _fp8_lm774m(dev):
    """Config #4 under ``mixed_precision="fp8"``: the histories roll every
    micro-step and the params change on accumulation boundaries only; every
    projection's products go through scaled_mm (7 x 36 forwards, twice
    under remat, and 2 x 7 x 36 backward products a micro-step); step ms,
    peak memory and the losses of the first window against a bf16 run."""
    from accelerate_tpu_torch import Accelerator, LlamaConfig, init_llama, llama_loss
    from accelerate_tpu_torch.ops import fp8
    from accelerate_tpu_torch.optimizer import adafactor

    config = LlamaConfig(**LM774M_KW)
    ids = np.random.default_rng(0).integers(0, config.vocab_size,
                                            (FP8_MICRO, LM774M_BATCH, config.max_seq_len))
    batches = {"input_ids": torch.from_numpy(ids.astype(np.int32)).to(dev)}
    remat = "dots_no_batch"

    def setup(cfg, precision):
        _reset_states()
        acc = Accelerator(mixed_precision=precision, gradient_accumulation_steps=FP8_ACCUM,
                          rng_seed=0)
        params = init_llama(cfg, torch.Generator(device=dev).manual_seed(0), device=dev,
                            dtype=torch.bfloat16)
        params, opt = acc.prepare(params, adafactor(LM774M_LR))
        loop = acc.prepare_train_loop(lambda p, b: llama_loss(p, b, cfg, remat=remat), opt)
        return params, opt, loop

    def window(k0, k1):
        return {"input_ids": batches["input_ids"][k0:k1]}

    out = {}
    for tag, cfg, precision in (("bf16", config, "bf16"),
                                ("fp8", dataclasses.replace(config, dtype_recipe="fp8"), "fp8")):
        params, opt, loop = setup(cfg, precision)
        state = opt.opt_state
        params, state, m = loop(params, state, window(0, FP8_ACCUM))
        first = m["loss"].cpu()
        meta = params["layers"]["wq"].get("fp8_meta", {}).get("x_hist")
        kernel = params["layers"]["wq"]["kernel"]
        if tag == "fp8":
            check(opt.fp8_partition and len(opt.meta) == 7 * 3,
                  f"[fp8-lm774m] {len(opt.meta)} meta leaves split out, want 21")
            fp8.scaled_mm.launches = 0
            fp8.PRODUCTS.update(forward=0, backward=0)
        # the timed micro-steps one a call: the fp8 run checks each one's
        # histories and params (a call's host cost is a few ms of ~1 s)
        seen = [(None if meta is None else meta.clone(), kernel[0].clone())]
        losses = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for k in range(FP8_MICRO):
            params, state, m = loop(params, state, window(k, k + 1))
            losses.append(m["loss"])
            if meta is not None:
                seen.append((meta.clone(), kernel[0].clone()))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[tag] = {"ms": wall / FP8_MICRO * 1e3, "peak": torch.cuda.max_memory_allocated(),
                    "first": first, "losses": torch.cat(losses).cpu()}
        check(bool(torch.isfinite(out[tag]["losses"]).all()), f"[fp8-lm774m] {tag} losses")
        for i in range(1, len(seen) if meta is not None else 0):
            check(not torch.equal(seen[i][0], seen[i - 1][0]),
                  f"[fp8-lm774m] histories did not roll on micro-step {i}")
            boundary = i % FP8_ACCUM == 0
            check(torch.equal(seen[i][1], seen[i - 1][1]) != boundary,
                  f"[fp8-lm774m] micro-step {i}: params "
                  f"{'unchanged on a boundary' if boundary else 'moved mid-window'}")
        if tag == "fp8":
            n = 7 * config.n_layers * FP8_MICRO
            want = {"forward": n * (2 if remat else 1), "backward": 2 * n}
            check(dict(fp8.PRODUCTS) == want and fp8.scaled_mm.launches == sum(want.values()),
                  f"[fp8-lm774m] fp8 products {dict(fp8.PRODUCTS)} and scaled_mm launches "
                  f"{fp8.scaled_mm.launches}, want {want} all launched")
            out["launches"] = fp8.scaled_mm.launches
            print(f"[fp8-lm774m] histories rolled on each of 4 micro-steps, params moved on the "
                  f"2 boundaries only; {FP8_MICRO} micro-steps: fp8 products {dict(fp8.PRODUCTS)}"
                  f", scaled_mm launches {fp8.scaled_mm.launches}")
        del params, opt, loop, state
        torch.cuda.empty_cache()
    delta = float(((out["fp8"]["first"] - out["bf16"]["first"]).abs()
                   / out["bf16"]["first"].abs()).max())
    check(delta < 1e-2, f"[fp8-lm774m] first-window losses fp8 {out['fp8']['first'].tolist()} "
                        f"vs bf16 {out['bf16']['first'].tolist()}")
    print(f"[fp8-lm774m] config #4 ({config.n_layers} layers, dim {config.dim}, batch "
          f"{LM774M_BATCH} x {config.max_seq_len}), "
          f"adafactor({LM774M_LR:g}), remat {remat!r}, accumulation {FP8_ACCUM}: fp8 "
          f"{out['fp8']['ms']:.1f} ms/micro-step, peak {out['fp8']['peak'] / 2**30:.2f} GiB; bf16 "
          f"{out['bf16']['ms']:.1f} ms/micro-step, peak {out['bf16']['peak'] / 2**30:.2f} GiB; "
          f"fp8/bf16 {out['fp8']['ms'] / out['bf16']['ms']:.3f}; first-window losses fp8 "
          f"{[round(v, 5) for v in out['fp8']['first'].tolist()]} bf16 "
          f"{[round(v, 5) for v in out['bf16']['first'].tolist()]} (max rel delta {delta:.2e})")
    return out


def phase_fp8(dev):
    """fp8 on the card: the JAX bench's fp8 leg, the three products at
    config #4's shapes against their plain version, and config #4 at full
    width and depth under ``mixed_precision="fp8"``. Returns the scaled_mm
    launches of config #4's timed micro-steps."""
    _fp8_bench_leg(dev)
    _fp8_products(dev)
    return _fp8_lm774m(dev)["launches"]


def _int8_matmul_check(dev):
    """``int8_dynamic_matmul``'s int32 block partials through ``_int_mm``
    against the plain product of the same int8 values (on the card an f32
    product, exact: every partial sum is an integer below 2**24), bitwise;
    times beside the bound and one bf16 ``torch.matmul`` of the shape."""
    from accelerate_tpu_torch.ops import quantization as q_ops

    M, K, N = INT8_MM_SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(M, K, generator=gen, device=dev, dtype=torch.bfloat16)
    w = (torch.randn(K, N, generator=gen, device=dev) * K ** -0.5).to(torch.bfloat16)
    wq = q_ops.quantize_int8_matmul_weight(w, block_size=INT8_MM_BLOCK)
    q_ops.int_mm.launches = 0
    partials, x_scale = q_ops.int8_block_partials(x, wq)
    nblk = wq.codes.shape[0]
    check(q_ops.int_mm.launches == nblk, f"[int8-mm] {q_ops.int_mm.launches} _int_mm launches, "
                                         f"want {nblk}")
    xb, _ = q_ops.quantize_rows(x, wq)
    plain = torch.stack([xb[:, b].float() @ wq.codes[b].float() for b in range(nblk)])
    check(torch.equal(partials, plain.to(torch.int32)), "[int8-mm] int32 block partials differ "
                                                          "from the plain product")
    out = q_ops.int8_dynamic_matmul(x, wq, preferred_dtype=torch.float32)
    rel = float(torch.linalg.vector_norm(out - x.float() @ w.float())
                / torch.linalg.vector_norm(x.float() @ w.float()))
    check(rel < 0.02, f"[int8-mm] int8_dynamic_matmul rel L2 {rel} from the bf16 product")
    xs = [xb[:, b].contiguous() for b in range(nblk)]
    ms = time_ms(lambda i: [q_ops.int_mm(xs[b], wq.codes[b]) for b in range(nblk)], 1, 10)
    plain_ms = time_ms(lambda i: [xs[b].float() @ wq.codes[b].float() for b in range(nblk)], 1, 10)
    library_ms = time_ms(lambda i: x @ w, 1, 10)
    ops_s = 2.0 * M * K * N / PEAK_FP8_OPS_PER_S
    bytes_s = (M * K + K * N + 4 * nblk * M * N) / HBM_BYTES_PER_S
    row = {"shape": [M, K, N], "blocks": nblk, "bitwise": True, "rel_l2_vs_bf16": rel, "ms": ms,
           "plain_ms": plain_ms, "library_bf16_ms": library_ms,
           "bound_ms": max(ops_s, bytes_s) * 1e3,
           "bound_by": "operations" if ops_s >= bytes_s else "bytes"}
    q_ops.int_mm.launches = nblk
    print(f"[int8-mm] int8_dynamic_matmul x {M}x{K} by w {K}x{N} in k-blocks of {INT8_MM_BLOCK}: "
          f"{nblk} _int_mm launches, int32 partials bitwise the plain product's; "
          f"{json.dumps(row)}")
    return row


def phase_quant(params, config, dev):
    """Config #5 quantized to int8 and NF4: bytes against the dense tree,
    greedy 8 x 128 + 64 token for token the dense run over the dequantized
    params, tokens/s against the bf16 dense run and the extra peak memory
    of each call; the serving engine on the NF4 params equal to the engine
    over the dequantized ones (#6/#7 launched); the int8 _int_mm check."""
    from accelerate_tpu_torch import (
        QuantizationConfig,
        QuantizedArray,
        dequantize_params,
        greedy_generate,
        quantize_params,
    )
    fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
    from accelerate_tpu_torch.ops.quantization import quantized_byte_size
    from accelerate_tpu_torch.optimizer import param_leaves
    from accelerate_tpu_torch.serving import ServingEngine

    prompt = np.random.default_rng(0).integers(0, config.vocab_size,
                                               (GEN_BATCH, GEN_PROMPT)).astype(np.int32)

    def generate(tree):
        gc.collect()  # an earlier call's garbage freed mid-call would hide this one's peak
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        # no warm-up run: phase_generate warmed this path, and eager torch
        # compiles nothing at a first call
        tokens, stats = greedy_generate(tree, prompt, config, max_new_tokens=GEN_NEW,
                                        return_stats=True)
        return tokens, stats, torch.cuda.max_memory_allocated() - base

    dense_bytes = quantized_byte_size(params)
    dense_tokens, dense_stats, dense_peak = generate(params)
    print(f"[quant] config #5 dense bf16: {dense_bytes / 2**30:.3f} GiB, greedy {GEN_BATCH} x "
          f"{GEN_PROMPT} + {GEN_NEW}: {dense_stats['decode_tokens_per_sec']:.1f} decode tok/s, "
          f"extra peak {dense_peak / 2**30:.3f} GiB")
    for kind, kw in QUANT_KINDS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q = quantize_params(params, QuantizationConfig(**kw))
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        leaves = [t for t in param_leaves(q) if isinstance(t, QuantizedArray)]
        per_elem = sum(t.nbytes_quantized for t in leaves) / sum(t.size for t in leaves)
        q_bytes = quantized_byte_size(q)
        tokens, stats, peak = generate(q)
        deq = dequantize_params(q)
        deq_tokens = greedy_generate(deq, prompt, config, max_new_tokens=GEN_NEW)
        check(np.array_equal(tokens, deq_tokens),
              f"[quant] {kind}: {int((tokens != deq_tokens).sum())} greedy tokens differ from the "
              "dense run over the dequantized params")
        print(f"[quant] {kind}: {len(leaves)} leaves quantized in {quant_s:.2f} s, "
              f"{per_elem:.4f} bytes an element of them (bf16: 2); tree {q_bytes / 2**30:.3f} GiB "
              f"({q_bytes / dense_bytes:.4f} of dense); greedy equal to the dequantized dense run "
              f"token for token; {stats['decode_tokens_per_sec']:.1f} decode tok/s "
              f"({stats['decode_tokens_per_sec'] / dense_stats['decode_tokens_per_sec']:.3f} of "
              f"dense bf16), prefill {stats['prefill_seconds']:.4f} s, extra peak "
              f"{peak / 2**30:.3f} GiB; {int((tokens != dense_tokens).sum())} of "
              f"{GEN_BATCH * (GEN_PROMPT + GEN_NEW)} tokens differ from the bf16 weights' run")
        if kind == "nf4":
            streams = {}
            for tag, tree in (("nf4", q), ("dequantized", deq)):
                engine = ServingEngine(tree, config, **ENGINE_KW)
                reqs = [engine.submit(p, ENGINE_NEW) for p in _engine_prompts(config)]
                fa.paged_attention_decode.launches = fa.paged_attention_prefill.launches = 0
                engine.run()
                launches = (fa.paged_attention_decode.launches,
                            fa.paged_attention_prefill.launches)
                check(all(n > 0 for n in launches), f"[quant] engine {tag}: launches {launches}")
                streams[tag] = [list(r.generated) for r in reqs]
            check(streams["nf4"] == streams["dequantized"],
                  "[quant] the engine's NF4 streams differ from the dequantized run's")
            print(f"[quant] ServingEngine on the NF4 params: {len(streams['nf4'])} requests equal "
                  f"to the engine over the dequantized params, token for token; paged decode / "
                  f"prefill launches {launches}")
        del q, deq
        torch.cuda.empty_cache()
    return _int8_matmul_check(dev)


def _mesh_2rank_fp8_leg(dev, config, pc_kwargs, zero1):
    """``MESH_2RANK_STEPS`` steps of ``sgd(MESH_2RANK_FP8_LR)`` on ``config`` with ``dtype_recipe=
    "fp8"`` under ``Accelerator(mixed_precision="fp8")`` through a mesh of
    the running processes (or of none): the losses, a digest of this
    rank's meta after each step, the meta and passthrough counts, whether
    the fused ZeRO-1 path ran, and the scaled_mm launches."""
    import hashlib

    from accelerate_tpu_torch import Accelerator, init_llama, llama_loss
    from accelerate_tpu_torch.data_loader import GlobalBatchAssembler
    from accelerate_tpu_torch.ops import fp8
    from accelerate_tpu_torch.optimizer import sgd
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.state import AcceleratorState, GradientState
    from accelerate_tpu_torch.utils.dataclasses import DeepSpeedPlugin


    AcceleratorState._reset_state()
    GradientState._reset_state()
    cfg = dataclasses.replace(config, dtype_recipe="fp8")
    acc = Accelerator(mixed_precision="fp8", rng_seed=0, device=dev,
                      parallelism_config=ParallelismConfig(**pc_kwargs),
                      deepspeed_plugin=DeepSpeedPlugin(zero_stage=1) if zero1 else None)
    init = init_llama(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    params, opt = acc.prepare(init, sgd(MESH_2RANK_FP8_LR))
    del init
    step = acc.prepare_train_step(lambda p, b: llama_loss(p, b, cfg, mesh=acc.mesh), opt)
    ids = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MESH_2RANK_STEPS, MESH_2RANK_BATCH, cfg.max_seq_len))
    assembler = GlobalBatchAssembler(acc.mesh, device=dev)
    state, losses, digests = opt.opt_state, [], []
    fp8.scaled_mm.launches = 0
    for k in range(MESH_2RANK_STEPS):
        batch = assembler.to_global(assembler.local_block({"input_ids": ids[k].astype(np.int32)}))
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
        digests.append(hashlib.sha256(b"".join(
            t.detach().cpu().numpy().tobytes() for t in opt.meta)).hexdigest())
    out = {"losses": losses, "meta_digests": digests, "meta_leaves": len(opt.meta),
           "passthrough": (len(opt.zero1.plan.passthrough_indices) if opt.zero1 is not None
                           else None),
           "fused_zero1": opt.zero1 is not None, "launches": fp8.scaled_mm.launches}
    del params, opt, step, state
    torch.cuda.empty_cache()
    return out
# phase_fleet: the fleet (router, admission, thread and process replicas,
# the canary, disaggregated prefill/decode and the SLO autoscaler) over
# config #5's serving Llama-1B (CONFIG_KW, bench.py:569-570) at full width
# and depth, bf16, SERVE_ENGINE_KW's pool, one coarse bucket per axis and
# the seeded workloads of the JAX serving bench's replicated and
# disaggregated legs (benchmarks/serving/run.py:128-291, :412-600;
# build_workload's arguments). Weights come from ReplicaSpec.build_params
# (a CPU generator seeded param_seed): one CPU init a seed, shared by the
# thread replicas and cast to each dtype. Every resume path (a failover, a
# thread or process replica's; a handoff; a corrupt handoff's re-prefill)
# runs in f32 params and cache, where its outputs must equal its
# reference's bitwise. The bf16 legs give the rates and hold 1 and 2
# thread replicas bitwise; their resume paths may part from the reference
# only on a request that took the resume path (a retry, a handoff), and
# only at a near-tie: the two tokens' logits in the f32 forward of the same
# weights on the reference's prefix lie within FLEET_NEAR_TIE. The bar was
# set from the largest such gap in sound runs (3.7e-2) and is held against
# a planted landing fault (bf16, the first handed-off block's content
# landed in every adopted place), which must break it.
FLEET_WORKLOAD = (16, 0, (16, 128), (16, 64), 2.0)
FLEET_DISAGG_WORKLOAD = (16, 0, (64, 256), (2, 24), 2.0)
FLEET_KILL_AFTER = 4
FLEET_ARRIVAL_DT_S = 0.02
FLEET_CANARY = dict(count=2, max_new_tokens=6)
FLEET_BAD_SEED = 1234
FLEET_CANARY_INTERVAL_S = 0.5
FLEET_NEAR_TIE = 0.1
FLEET_FAULT_REQUESTS = 4
FLEET_HANDOFF_REPS = 5
_FLEET_WEIGHTS: dict = {}
_FLEET_LOCK = threading.Lock()


def _fleet_spec(workload_args, dev, **kw):
    """The fleet's ReplicaSpec for ``workload_args``: one slot bucket (8),
    one table width (the longest request's blocks plus one) and one
    prefill bucket (the longest prompt plus the largest budget), as the JAX
    bench sets them; its thread replicas share one copy of each
    (seed, dtype) of weights."""
    from accelerate_tpu_torch.serving import ReplicaSpec

    class FleetSpec(ReplicaSpec):
        def build_params(self):
            # ReplicaSpec.build_params at f32 on the CPU once a seed (its
            # slow part, the seeded draws), then the cast and move it makes
            with _FLEET_LOCK:
                cpu = ("cpu", self.param_seed)
                if cpu not in _FLEET_WEIGHTS:
                    _FLEET_WEIGHTS[cpu] = ReplicaSpec.build_params(
                        dataclasses.replace(self, param_dtype="float32", device="cpu"))
                key = (self.param_seed, self.param_dtype, self.device)
                if key not in _FLEET_WEIGHTS:
                    cast = _tree_to(_FLEET_WEIGHTS[cpu], getattr(torch, self.param_dtype))
                    _FLEET_WEIGHTS[key] = _tree_to(cast, torch.device(self.device))
            return _FLEET_WEIGHTS[key]

    bs, slots = SERVE_ENGINE_KW["block_size"], SERVE_ENGINE_KW["max_slots"]
    max_len = workload_args[2][1] + workload_args[3][1]
    return FleetSpec(model=dict(CONFIG_KW), **SERVE_ENGINE_KW, slot_buckets=(slots,),
                     block_buckets=(-(-max_len // bs) + 1,), prefill_buckets=(max_len,),
                     device=dev.type, **kw)


def _fleet_f32(spec):
    return dataclasses.replace(spec, param_dtype="float32", cache_dtype="float32")


def _engines(router) -> dict:
    """Every thread replica's engine, by replica name."""
    return {n: r._worker.engine for n, r in router.replicas.items()
            if getattr(r, "_worker", None) is not None}


def _fleet_launch_check(tag, router, launches, warmed_in_window=()):
    """#6/#7 launched exactly once a layer for every decode step and
    prefill chunk the leg's engines ran (and for the warm-up points of the
    replicas that joined inside the window): the wrappers count under a
    lock, so the threads' launches add up."""
    n_layers = CONFIG_KW["n_layers"]
    want = {"paged_attention_decode": 0, "paged_attention_prefill": 0}
    for name, eng in _engines(router).items():
        st = eng.stats()
        want["paged_attention_prefill"] += n_layers * st["prefill_chunks"]
        want["paged_attention_decode"] += n_layers * st["decode_steps"]
        if name in warmed_in_window:
            ready = router.replicas[name].ready_info
            want["paged_attention_prefill"] += n_layers * ready["prefill_compiles"]
            want["paged_attention_decode"] += n_layers * ready["decode_compiles"]
    check(launches == want and all(v > 0 for v in launches.values()),
          f"[{tag}] launches {launches} against {want} from the engines' steps and chunks")


def _fleet_drive(tag, router, workload, *, kill_after=None, arrival_dt_s=None, dev=None):
    """Submit ``workload`` (``rng_seed`` = index; all at once, or open-loop
    at ``arrival_dt_s`` a step) and poll until every request is terminal,
    killing ``r0`` after ``kill_after`` completions. The launch counters are
    zeroed just before and read just after. Returns (leg metrics, requests,
    launches)."""
    fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
    from accelerate_tpu_torch.serving import RouterRequestStatus

    fa.paged_attention_decode.launches = 0
    fa.paged_attention_prefill.launches = 0
    t0 = time.monotonic()
    reqs, nxt, killed = [], 0, False
    while nxt < len(workload) or not all(r.status.terminal for r in reqs):
        now = time.monotonic()
        while nxt < len(workload) and (arrival_dt_s is None
                                       or workload[nxt][0] * arrival_dt_s <= now - t0):
            _, prompt, new = workload[nxt]
            reqs.append(router.submit(prompt, new, rng_seed=nxt))
            nxt += 1
        router.poll()
        done = sum(r.status is RouterRequestStatus.FINISHED for r in reqs)
        if kill_after is not None and not killed and done >= kill_after:
            router.replicas["r0"].kill()
            killed = True
        check(time.monotonic() - t0 < 600, f"[{tag}] wedged")
        time.sleep(0.001)
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"paged_attention_decode": fa.paged_attention_decode.launches,
                "paged_attention_prefill": fa.paged_attention_prefill.launches}
    done = [r for r in reqs if r.status is RouterRequestStatus.FINISHED]
    tokens = sum(len(r.generated) for r in done)
    lat = [(r.finish_t - r.arrival_t) * 1e3 for r in done]
    ttft = [(r.first_token_t - r.arrival_t) * 1e3 for r in done if r.first_token_t]
    leg = dict(tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall, lost=len(reqs) - len(done),
               failovers=router.failovers, killed=killed,
               retried=[i for i, r in enumerate(reqs) if r.retries],
               p50_latency_ms=float(np.percentile(lat, 50)),
               p99_latency_ms=float(np.percentile(lat, 99)),
               p50_ttft_ms=float(np.percentile(ttft, 50)),
               p99_ttft_ms=float(np.percentile(ttft, 99)))
    return leg, reqs, launches


def _wait_ready(router, timeout_s=600.0) -> dict:
    """Poll until no replica is STARTING; seconds from now to each
    replica's ready event."""
    from accelerate_tpu_torch.serving import ReplicaState

    t0 = time.monotonic()
    ready = {}
    while True:
        router.poll()
        for name, rep in router.replicas.items():
            if name not in ready and rep.state is not ReplicaState.STARTING:
                ready[name] = time.monotonic() - t0
        if len(ready) == len(router.replicas):
            return ready
        check(time.monotonic() - t0 < timeout_s, f"replicas never became ready: {ready}")
        time.sleep(0.005)


def _fleet_leg(tag, replicas, workload, dev, *, router_cls=None, kill_after=None,
               arrival_dt_s=None, inspect=None, **router_kw):
    """A router over ``replicas`` (the router's positional arguments; its
    queue sized so nothing sheds) drains ``workload``; ``inspect(router)``
    runs before the router is closed, in place of the launch check of the
    thread replicas' engines. Returns (metrics, outputs, router)."""
    fa = importlib.import_module("accelerate_tpu_torch.ops.flash_attention")
    from accelerate_tpu_torch.serving import AdmissionController, ServingRouter

    cls = router_cls or ServingRouter
    router = cls(*replicas, admission=AdmissionController(max_queue=len(workload) + 1),
                 health_timeout_s=30.0, **router_kw)
    try:
        ready = _wait_ready(router)
        leg, reqs, launches = _fleet_drive(tag, router, workload, kill_after=kill_after,
                                           arrival_dt_s=arrival_dt_s, dev=dev)
        autoscaler = router_kw.get("autoscaler")
        joiners = ()
        if autoscaler is not None:
            # let a join finish warming: its warm-up belongs to this window
            t0 = time.monotonic()
            while autoscaler.stats()["pending_joins"]:
                router.poll()
                check(time.monotonic() - t0 < 300, f"[{tag}] a join never became ready")
                time.sleep(0.005)
            launches = {k: getattr(fa, k).launches for k in launches}
            joiners = [e["replica"] for e in autoscaler.events if e["action"] == "scale_up"]
        if inspect is None:
            _fleet_launch_check(tag, router, launches, joiners)
        else:
            launches = inspect(router)
        leg.update(ready_s=ready, launches=launches)
        check(leg["lost"] == 0, f"[{tag}] lost {leg['lost']} request(s)")
        return leg, [list(r.generated) for r in reqs], router
    finally:
        router.close()


def _print_leg(tag, leg, card, extra=""):
    print(f"[{tag}] {leg['tokens']} tokens in {leg['wall_s']:.3f} s: "
          f"{leg['tokens_per_s']:.1f} tok/s, latency p50 {leg['p50_latency_ms']:.1f} ms p99 "
          f"{leg['p99_latency_ms']:.1f} ms, ttft p50 {leg['p50_ttft_ms']:.1f} ms p99 "
          f"{leg['p99_ttft_ms']:.1f} ms, failovers {leg['failovers']}, lost {leg['lost']}, "
          f"ready {', '.join(f'{n} {s:.2f} s' for n, s in leg['ready_s'].items())}, "
          f"launches {leg['launches']}{extra} ({card})", flush=True)


def _parted(got, want) -> list:
    """(request, first differing index) of every output that differs."""
    out = []
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            j = _first_divergence(g, w)
            out.append((i, min(len(g), len(w)) if j is None else j))
    return out


def _partings(tag, spec, workload, got, want, dev) -> list:
    """Each parted request's first differing token, both tokens, and their
    logit gap in the f32 forward of the same weights on the reference's
    prefix (a near-tie shows as a small gap), printed; returns (request,
    index, gap) of each."""
    config = spec.config()
    f32 = _fleet_f32(spec).build_params()
    out = []
    for i, j in _parted(got, want):
        prompt = workload[i][1]
        ids = np.concatenate([prompt, np.asarray(want[i][:j + 1], np.int32)])[None]
        logits = _f32_logits(f32, config, ids, ids.shape[1] - 1, dev)[0, -1]
        a, b = want[i][j] if j < len(want[i]) else None, got[i][j] if j < len(got[i]) else None
        gap = (float(logits[a] - logits[b]) if a is not None and b is not None else float("nan"))
        print(f"[{tag}] request {i} parts at token {j}: reference {a}, this leg {b}, "
              f"f32 logit gap {gap:.4e}", flush=True)
        out.append((i, j, gap))
    return out


def _near_ties_only(partings, resumed) -> bool:
    """Every parting on a request that took the resume path, at an f32
    logit gap within FLEET_NEAR_TIE (a NaN gap, a stream cut short, fails)."""
    return all(i in resumed and abs(gap) < FLEET_NEAR_TIE for i, _, gap in partings)


def _hold_bf16_leg(tag, spec, workload, got, want, resumed, dev) -> list:
    """A bf16 leg against its reference: partings only on ``resumed``
    requests and only at near-ties. Returns the partings."""
    parts = _partings(tag, spec, workload, got, want, dev)
    check(_near_ties_only(parts, set(resumed)),
          f"[{tag}] partings {parts} off the resume path {sorted(resumed)} or at an f32 logit "
          f"gap of {FLEET_NEAR_TIE} or more")
    print(f"[{tag}] {len(parts)} of {len(workload)} outputs parted from the reference, each on "
          f"the resume path at an f32 logit gap under {FLEET_NEAR_TIE}", flush=True)
    return parts


class _StampedQueue:
    """A child replica's event queue that notes when its ``ready`` event
    arrived (the child's time to ready, whoever polls it later)."""

    def __init__(self, inner):
        self._inner, self.ready_t = inner, None

    def put(self, item, *args, **kwargs):
        if self.ready_t is None and item.get("event") == "ready":
            self.ready_t = time.monotonic()
        self._inner.put(item, *args, **kwargs)

    def get_nowait(self):
        return self._inner.get_nowait()


def _spawn_children(spec) -> list:
    """Two ``ProcessReplica`` children of a plain ``ReplicaSpec`` copy of
    ``spec`` (a child rebuilds the spec from JSON), started now so they warm
    while other legs run."""
    from accelerate_tpu_torch.serving import ProcessReplica, ReplicaSpec

    plain = ReplicaSpec(**{f.name: getattr(spec, f.name) for f in dataclasses.fields(ReplicaSpec)})
    children = []
    for i in range(2):
        rep = ProcessReplica(f"r{i}", plain)
        rep.spawned_t, rep._outbox = time.monotonic(), _StampedQueue(rep._outbox)
        children.append(rep)
    return children


def _proc_leg(tag, children, workload, dev):
    leg, out, router = _fleet_leg(tag, [children], workload, dev, kill_after=FLEET_KILL_AFTER,
                                  inspect=_child_launches)
    check(router.replicas["r0"].proc.returncode == -9, f"[{tag}] r0 was not SIGKILLed")
    check(leg["failovers"] >= 1, f"[{tag}] no failover")
    leg["ready_s"] = {c.name: c._outbox.ready_t - c.spawned_t for c in children}
    return leg, out


def _corrupt_leg(tag, spec, workload, dev):
    """The planted fault: the first wire a prefill engine packs is damaged
    in transit (``corrupt_wire``, after its CRC). The router must catch it
    and re-run that prefill."""
    from accelerate_tpu_torch.serving import disagg as disagg_mod

    real_pack = disagg_mod.LocalBlockCopyTransport.pack
    packed = []

    def corrupt_first(self, engine, req):
        wire = real_pack(self, engine, req)
        packed.append(req)
        return disagg_mod.corrupt_wire(wire) if len(packed) == 1 else wire

    disagg_mod.LocalBlockCopyTransport.pack = corrupt_first
    try:
        leg, out, router = _disagg_leg(tag, spec, workload, dev)
    finally:
        disagg_mod.LocalBlockCopyTransport.pack = real_pack
    check(router.handoff_corrupt >= 1 and len(packed) == len(workload) + router.handoff_corrupt,
          f"[{tag}] {router.handoff_corrupt} corrupt handoffs caught, {len(packed)} packed")
    print(f"[{tag}] {router.handoff_corrupt} corrupt handoff caught and its prefill re-run "
          f"({len(packed)} packed for {len(workload)} requests)", flush=True)
    return leg, out


def phase_fleet(dev):
    """The fleet at config #5's serving widths, in bf16: replicated legs (1,
    2, and 2 thread replicas with r0 killed after FLEET_KILL_AFTER
    completions), 2 process replicas with one SIGKILLed (started at the
    phase's start, so they warm while the thread legs run), the canary (a
    good replica and one of another param seed), the disaggregated leg (1
    prefill + 1 decode with the SLO autoscaler under a 1 µs ttft objective,
    open-loop) against one monolithic replica, the near-tie bar's planted
    landing fault and the handoff's steps timed alone; then every resume
    path in f32 (the kill, process, disaggregated and planted corrupt
    handoff legs) against its f32 reference. Prints each leg's rates beside
    the card; returns each leg's #6/#7 launches."""
    from accelerate_tpu_torch.serving import (
        CanaryProbe,
        LocalReplica,
        ReplicaState,
        ServingRouter,
        precompute_goldens,
    )
    from accelerate_tpu_torch.utils.device import gpu_info

    card = gpu_info()["line"] if dev.type == "cuda" else "cpu"
    launches = {}
    workload = build_workload(*FLEET_WORKLOAD, CONFIG_KW["vocab_size"])
    spec = _fleet_spec(FLEET_WORKLOAD, dev)
    children = _spawn_children(spec)
    t0 = time.perf_counter()
    spec.build_params()
    print(f"[fleet] weights built by ReplicaSpec.build_params in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    def replicated(spec, kill_after=None, n=2, tag="fleet"):
        return _fleet_leg(tag, [[LocalReplica(f"r{i}", spec) for i in range(n)]], workload,
                          dev, kill_after=kill_after)

    # -- replicated legs ----------------------------------------------------
    one, out1, _ = _fleet_leg("fleet-1r", [[LocalReplica("r0", spec)]], workload, dev)
    many, out2, _ = replicated(spec, tag="fleet-2r")
    kill, outk, _ = replicated(spec, FLEET_KILL_AFTER, tag="fleet-2r-kill")
    for tag, leg in (("fleet-1r", one), ("fleet-2r", many), ("fleet-2r-kill", kill)):
        _print_leg(tag, leg, card)
        launches[tag] = leg["launches"]
    check(kill["killed"] and kill["failovers"] >= 1, f"kill leg: {kill['failovers']} failovers")
    check(out2 == out1, f"2 replicas parted from 1 at {_parted(out2, out1)}")
    print(f"[fleet] 2r/1r tok/s {many['tokens_per_s'] / one['tokens_per_s']:.3f}; kill leg "
          f"{kill['failovers']} failovers, requests {kill['retried']} retried ({card})",
          flush=True)
    _hold_bf16_leg("fleet-2r-kill", spec, workload, outk, out2, kill["retried"], dev)

    # -- process replicas ---------------------------------------------------
    proc, outp = _proc_leg("fleet-proc", children, workload, dev)
    _print_leg("fleet-proc", proc, card)
    launches["fleet-proc"] = proc["launches"]
    print(f"[fleet-proc] proc/1r tok/s {proc['tokens_per_s'] / one['tokens_per_s']:.3f}; "
          f"requests {proc['retried']} retried", flush=True)
    _hold_bf16_leg("fleet-proc", spec, workload, outp, out2, proc["retried"], dev)

    # -- the canary ---------------------------------------------------------
    # a healthy replica answers through #6/#7 over the bf16 pool, the
    # goldens come from greedy_generate: they must agree, or the canary
    # would drain a healthy replica
    goldens = precompute_goldens(spec, **FLEET_CANARY)
    eng = spec.build_engine()
    eng.warmup()
    answers = [eng.submit(np.asarray(g.prompt, np.int32), g.max_new_tokens, rng_seed=g.rng_seed)
               for g in goldens]
    eng.run()
    got = [list(r.generated) for r in answers]
    want = [list(g.expected) for g in goldens]
    del eng
    check(got == want, f"bf16 goldens (greedy_generate) parted from one engine at "
                       f"{_parted(got, want)}")
    print(f"[fleet-canary] bf16 goldens (greedy_generate) equal one engine's answers on "
          f"{len(goldens)} of {len(goldens)}", flush=True)
    probe = CanaryProbe(goldens, interval_s=FLEET_CANARY_INTERVAL_S)
    router = ServingRouter([LocalReplica("good", spec),
                            LocalReplica("bad", dataclasses.replace(spec,
                                                                    param_seed=FLEET_BAD_SEED))],
                           canary=probe, health_timeout_s=30.0)
    try:
        _wait_ready(router)
        t0 = time.monotonic()
        while (probe.by_replica.get("bad", {}).get("failures", 0) < 1
               or probe.by_replica.get("good", {}).get("probes", 0) < 2 or router._inflight):
            router.poll()
            check(time.monotonic() - t0 < 300, f"canary probes stalled: {probe.stats()}")
            time.sleep(0.002)
    finally:
        router.close()
    check(router.replicas["bad"].state is ReplicaState.DRAINING, "the bad replica kept serving")
    check(probe.by_replica["bad"]["failures"] >= 1, f"no canary failure: {probe.stats()}")
    check(probe.by_replica["good"]["failures"] == 0, f"a false positive: {probe.stats()}")
    print(f"[fleet-canary] {probe.stats()} (bf16; {card})", flush=True)

    # -- disaggregated prefill/decode --------------------------------------
    dworkload = build_workload(*FLEET_DISAGG_WORKLOAD, CONFIG_KW["vocab_size"])
    dspec = _fleet_spec(FLEET_DISAGG_WORKLOAD, dev)
    mono, outm, _ = _fleet_leg("fleet-mono", [[LocalReplica("m0", dspec)]], dworkload, dev)
    _print_leg("fleet-mono", mono, card)
    launches["fleet-mono"] = mono["launches"]
    leg, outd, router = _disagg_leg("fleet-disagg", dspec, dworkload, dev, autoscale=True)
    _print_leg("fleet-disagg", leg, card, _handoff_line(router, leg))
    launches["fleet-disagg"] = leg["launches"]
    _check_disagg(router, dworkload)
    ups = [e for e in router.autoscaler.events if e["action"] == "scale_up"]
    joins = [e for e in router.autoscaler.events if e["action"] == "join_ready"]
    print(f"[fleet-disagg] scale-ups {len(ups)}, joins ready in "
          f"{[j['time_to_ready_s'] for j in joins]} s, join_compiles "
          f"{sum(j['join_compiles'] for j in joins)}; disagg/mono tok/s "
          f"{leg['tokens_per_s'] / mono['tokens_per_s']:.3f}", flush=True)
    # every request of a disaggregated leg took the resume path (a handoff)
    _hold_bf16_leg("fleet-disagg", dspec, dworkload, outd, outm, range(len(dworkload)), dev)
    _landing_fault_leg("fleet-fault", dspec, dworkload[:FLEET_FAULT_REQUESTS],
                       outm[:FLEET_FAULT_REQUESTS], dev)
    _handoff_split(dspec, dworkload, dev, card)

    # -- the resume paths in f32 -------------------------------------------
    s32, d32 = _fleet_f32(spec), _fleet_f32(dspec)
    children32 = _spawn_children(s32)  # they warm during the thread legs below
    _, ref32, _ = replicated(s32, tag="fleet-2r-f32")
    leg32, out32, _ = replicated(s32, FLEET_KILL_AFTER, tag="fleet-2r-kill-f32")
    check(leg32["failovers"] >= 1 and out32 == ref32,
          f"f32 kill leg: {leg32['failovers']} failovers, parted at {_parted(out32, ref32)}")
    _, out32 = _proc_leg("fleet-proc-f32", children32, workload, dev)
    check(out32 == ref32, f"f32 process leg parted at {_parted(out32, ref32)}")
    _, refm32, _ = _fleet_leg("fleet-mono-f32", [[LocalReplica("m0", d32)]], dworkload, dev)
    _, outd32, router = _disagg_leg("fleet-disagg-f32", d32, dworkload, dev, autoscale=True)
    _check_disagg(router, dworkload)
    check(outd32 == refm32, f"f32 disagg leg parted at {_parted(outd32, refm32)}")
    # the planted corrupt handoff: caught, its prefill re-run, the same outputs
    _, outc32 = _corrupt_leg("fleet-corrupt-f32", d32, dworkload, dev)
    check(outc32 == refm32, f"f32 corrupt leg parted at {_parted(outc32, refm32)}")
    print(f"[fleet-f32] the kill, process, disaggregated (autoscaled) and corrupt-handoff legs "
          f"equal their references in f32 (params and cache)", flush=True)
    _FLEET_WEIGHTS.clear()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return launches


def _check_disagg(router, workload):
    """The disaggregated leg's pass conditions beside its outputs: every
    request handed off, none corrupt, at least one scale-up and every join
    ready."""
    ups = [e for e in router.autoscaler.events if e["action"] == "scale_up"]
    joins = [e for e in router.autoscaler.events if e["action"] == "join_ready"]
    check(len(ups) >= 1 and len(joins) == len(ups), f"autoscaler: {router.autoscaler.events}")
    check(router.handoff_corrupt == 0 and router.handoffs >= len(workload),
          f"{router.handoffs} handoffs, {router.handoff_corrupt} corrupt")


def _landing_fault_leg(tag, spec, workload, want, dev):
    """The near-tie bar's planted fault: the decode side lands the first
    handed-off block's content in every adopted place (bf16, a backlog).
    Its partings from the monolith must break FLEET_NEAR_TIE."""
    from accelerate_tpu_torch.serving import DecodeEngine

    real = DecodeEngine.land_blocks

    def land_first(self, blocks, k, v):
        first = [0] * len(blocks)
        real(self, blocks, k[first], v[first])

    DecodeEngine.land_blocks = land_first
    try:
        _, out, _ = _disagg_leg(tag, spec, workload, dev)
    finally:
        DecodeEngine.land_blocks = real
    parts = _partings(tag, spec, workload, out, want, dev)
    check(not _near_ties_only(parts, set(range(len(workload)))),
          f"[{tag}] the planted landing fault passed the near-tie bar: {parts}")
    print(f"[{tag}] planted landing fault: {len(parts)} of {len(workload)} outputs parted, f32 "
          f"logit gaps {[round(g, 4) for *_, g in parts]}: the near-tie bar fails it", flush=True)


def _handoff_split(spec, workload, dev, card):
    """The handoff's steps one by one, alone, on the FLEET_HANDOFF_REPS
    longest prompts (the most blocks), each step timed after the device
    queue drained: the capture's gather and device-to-host copy, its CRC,
    the base64 of ``to_wire``, the JSON line a process replica's pipe
    carries; on the decode side the base64 decode of ``from_wire`` and the
    landing (adoption, host-to-device copy, pool write) up to the device's
    end. Prints the medians."""
    import zlib

    from accelerate_tpu_torch.serving import KVHandoff, LocalBlockCopyTransport

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    rows = []

    class Timed(LocalBlockCopyTransport):
        def pack(self, engine, req):
            sync()  # the prefill's own kernels end before the clock starts
            t0 = time.perf_counter()
            ho = KVHandoff.capture(engine, req)  # gather, copy, CRC
            t1 = time.perf_counter()
            zlib.crc32(ho.v.tobytes(), zlib.crc32(ho.k.tobytes()))
            t2 = time.perf_counter()
            wire = ho.to_wire()
            t3 = time.perf_counter()
            json.dumps(wire)
            t4 = time.perf_counter()
            rows.append(dict(mb=ho.nbytes / 1e6, copy=(t1 - t0) - (t2 - t1), crc=t2 - t1,
                             b64=t3 - t2, json=t4 - t3))
            return wire

    pe = dataclasses.replace(spec, role="prefill").build_engine()
    de = dataclasses.replace(spec, role="decode").build_engine()
    pe.transport = Timed()
    pe.warmup()
    de.warmup()
    longest = sorted(range(len(workload)), key=lambda i: -workload[i][1].size)
    for i in longest[:FLEET_HANDOFF_REPS]:
        pe.submit(workload[i][1], 2)
        pe.step()
        ((_, wire),) = pe.pop_handoffs()
        t0 = time.perf_counter()
        back = KVHandoff.from_wire(wire)
        t1 = time.perf_counter()
        de.transport.deliver(back, de)
        sync()
        rows[-1].update(unb64=t1 - t0, land=time.perf_counter() - t1)
    med = {k: float(np.median([r[k] for r in rows])) for k in rows[0]}
    print(f"[fleet-handoff] {len(rows)} handoffs alone, median {med['mb']:.2f} MB (f32 k and v): "
          f"gather + device-to-host copy {med['copy'] * 1e3:.2f} ms, CRC {med['crc'] * 1e3:.2f} "
          f"ms, base64 {med['b64'] * 1e3:.2f} ms, JSON line {med['json'] * 1e3:.2f} ms; decode "
          f"side: base64 decode {med['unb64'] * 1e3:.2f} ms, land with the device write "
          f"{med['land'] * 1e3:.2f} ms ({card})", flush=True)
    del pe, de


def _disagg_leg(tag, spec, workload, dev, autoscale=False):
    """1 prefill + 1 decode thread replica under a DisaggRouter; with
    ``autoscale`` the SLO autoscaler (a 1 µs ttft objective: burning as
    soon as 4 requests finish) and open-loop arrivals, as the JAX bench's
    disaggregated leg; otherwise the backlog at once."""
    import dataclasses as _dc

    from accelerate_tpu_torch.serving import AutoscalerPolicy, DisaggRouter, LocalReplica
    from accelerate_tpu_torch.telemetry import SLOMonitor, serving_slos

    pspec, dspec = (_dc.replace(spec, role=r) for r in ("prefill", "decode"))
    kw = {}
    if autoscale:
        kw = dict(slo_monitor=SLOMonitor(serving_slos(ttft_threshold_s=1e-6), min_events=4),
                  slo_eval_interval_s=0.0,
                  autoscaler=AutoscalerPolicy(dspec, min_decode=1, max_decode=2,
                                              cooldown_s=30.0, idle_shrink_after_s=3600.0))
    return _fleet_leg(tag, [[LocalReplica("p0", pspec)], [LocalReplica("d0", dspec)]], workload,
                      dev, router_cls=DisaggRouter,
                      arrival_dt_s=FLEET_ARRIVAL_DT_S if autoscale else None, **kw)


def _handoff_line(router, leg) -> str:
    """Handoffs, MB a handoff (the f32 k and v blocks) and, on the host's
    clock inside the leg, the prefill side's pack ms (its copy waits for
    whatever the stream has queued) and the decode side's land ms (the
    device write left queued) a handoff; _handoff_split times the steps
    alone."""
    engines = _engines(router)
    packed = sum(e.stats().get("handoffs_packed", 0) for e in engines.values())
    landed = sum(e.stats().get("handoffs_landed", 0) for e in engines.values())
    blocks = sum(e.stats().get("handoff_blocks", 0) for e in engines.values())
    pack_s = sum(e.stats().get("pack_seconds", 0.0) for e in engines.values())
    land_s = sum(e.stats().get("land_seconds", 0.0) for e in engines.values())
    c = CONFIG_KW
    block_mb = (2 * c["n_layers"] * SERVE_ENGINE_KW["block_size"] * c["n_kv_heads"]
                * (c["dim"] // c["n_heads"]) * 4 / 1e6)
    leg.update(handoffs=router.handoffs, handoff_corrupt=router.handoff_corrupt,
               mb_per_handoff=blocks * block_mb / max(landed, 1),
               capture_ms=pack_s / max(packed, 1) * 1e3, land_ms=land_s / max(landed, 1) * 1e3)
    return (f"; handoffs {router.handoffs} ({router.handoff_corrupt} corrupt), "
            f"{leg['mb_per_handoff']:.2f} MB a handoff ({blocks} blocks landed), host ms in "
            f"the leg: pack {leg['capture_ms']:.2f} and land (queued) {leg['land_ms']:.2f} a "
            f"handoff")


def _child_launches(router) -> dict:
    """The surviving child's own #6/#7 counts (its ``stats`` event: the
    parent's counters never see a child's launches), held to one launch a
    layer for each of its decode steps, prefill chunks and warm-up points."""
    rep = router.replicas["r1"]
    rep.request_stats()
    t0 = time.monotonic()
    while True:
        got = [e for e in rep.drain_events() if e.get("event") == "stats"]
        if got:
            break
        check(time.monotonic() - t0 < 60, "the surviving child sent no stats")
        time.sleep(0.01)
    st, launches = got[0]["engine"], got[0]["launches"]
    n_layers = CONFIG_KW["n_layers"]
    want = {"paged_attention_prefill": n_layers * (st["prefill_chunks"]
                                                   + rep.ready_info["prefill_compiles"]),
            "paged_attention_decode": n_layers * (st["decode_steps"]
                                                  + rep.ready_info["decode_compiles"])}
    check(launches == want and all(v > 0 for v in launches.values()),
          f"[fleet-proc] the survivor's launches {launches} against {want}")
    return launches


def _timed(phase, *args):
    """``phase(*args)``, with its wall seconds printed."""
    t0 = time.perf_counter()
    out = phase(*args)
    print(f"[time] {phase.__name__} {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    children = {"--mesh-2rank-child": mesh_2rank_child, "--mesh-lm-child": mesh_lm_child,
                "--moe-ep-child": moe_ep_child, "--mesh-decode-child": mesh_decode_child,
                "--cp-attn-child": cp_attn_child}
    if sys.argv[1:2] and sys.argv[1] in children:
        return children[sys.argv[1]](sys.argv[2])
    import accelerate_tpu_torch
    from accelerate_tpu_torch import LlamaConfig, init_llama
    from accelerate_tpu_torch.utils.device import gpu_info

    # the checkout beside this script is what is checked, never a copy
    # installed elsewhere
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(accelerate_tpu_torch.__file__)))
    check(pkg_root == here, f"accelerate_tpu_torch imported from {pkg_root}, not {here}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = gpu_info()["line"]
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}; every number "
          f"below is from this card: {card}")
    _timed(phase_build)
    kernel_results = _timed(phase_kernels, dev)
    _timed(phase_decode_splits, dev)
    fused_results = _timed(phase_fused_kernels, dev)

    config = LlamaConfig(**CONFIG_KW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_llama(config, torch.Generator(device=dev).manual_seed(0), device=dev,
                        dtype=torch.bfloat16)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n_params = sum(t.numel() for v in params.values() for e in v.values()
                   for t in (e.values() if isinstance(e, dict) else [e]))
    print(f"[model] {n_params / 1e9:.3f} B params in bf16, head_dim {config.head_dim}, "
          f"ffn {config.hidden_dim}")
    launches = _timed(phase_engine, params, config, dev)
    _timed(phase_profile, params, config, dev)
    _timed(phase_cached_vs_full, params, config, dev)
    prompt, greedy16, greedy4 = _timed(phase_generate, params, config, dev, load_s)
    _timed(phase_offload, params, config, dev, prompt, greedy16, greedy4)
    _timed(phase_quant, params, config, dev)
    del params
    serve_config = LlamaConfig(**SERVE_BENCH_KW)
    serve_params = init_llama(serve_config, torch.Generator(device=dev).manual_seed(0),
                              device=dev, dtype=torch.bfloat16)
    spec_results = _timed(phase_spec_decode, serve_params, serve_config)
    _timed(phase_sampling, serve_params, serve_config, dev)
    _timed(phase_static, serve_params, serve_config)
    del serve_params
    fleet_launches = _timed(phase_fleet, dev)
    train_launches = _timed(phase_train, dev)
    _timed(phase_train_check, dev)
    _timed(phase_train_check_fp16, dev)
    accum_launches = _timed(phase_grad_accum, dev)
    fp16_launches = _timed(phase_fp16, dev)
    flash_results = _timed(phase_flash_kernels, dev)
    llama_launches = _timed(phase_llama_train, dev)
    _timed(phase_llama_train_check, dev)
    lm_launches, offload_dots_launches, lm_ref = _timed(phase_lm774m, dev)
    _timed(phase_lm774m_check, dev)
    lomo_launches = _timed(phase_lomo, dev)
    offload_opt_launches = _timed(phase_offload_opt, dev)
    _timed(phase_fp8, dev)
    _timed(phase_checkpoint, dev)
    _timed(phase_resnet, dev)
    _timed(phase_t5, dev)
    moe_engine_launches, moe_train_launches, moe_leg = _timed(phase_moe, dev)
    _timed(phase_mesh_ops, dev)
    fsdp_launches, _ = _timed(phase_fsdp_lm, dev, lm_ref)
    cp_launches = _timed(phase_context_parallel, dev)
    mesh_launches, bert_tp_launches = _timed(phase_mesh_2rank, dev)
    mesh_lm_launches = _timed(phase_mesh_lm774m, dev)
    moe_ep_launches = _timed(phase_moe_ep, dev, moe_leg)
    mesh_decode_launches = _timed(phase_mesh_decode, dev)

    keys =("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    records = []
    for name, kind, spec_kind, tp_kind, source, replaces in (
        ("paged_attention_decode", "decode", "draft", "decode_tp",
         "accelerate_tpu_torch/csrc/paged_decode.cu", "accelerate_tpu/ops/flash_attention.py:619"),
        ("paged_attention_prefill", "prefill256", "verify", "prefill_tp",
         "accelerate_tpu_torch/csrc/paged_prefill.cu",
         "accelerate_tpu/ops/flash_attention.py:753"),
    ):
        rec = kernel_results[(kind, torch.bfloat16)]
        spec_rec = kernel_results[(spec_kind, torch.bfloat16)]
        tp_rec = kernel_results[(tp_kind, torch.bfloat16)]
        records.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": launches[name], **{k: rec[k] for k in keys},
                        spec_kind: {k: spec_rec[k] for k in keys},
                        tp_kind: {k: tp_rec[k] for k in keys},
                        "launches_spec_decode": spec_results["spec"]["launches"][name],
                        "launches_moe_engine": moe_engine_launches[name],
                        "launches_mesh_decode": [r[name] for r in mesh_decode_launches],
                        "launches_fleet": {leg: n[name] for leg, n in fleet_launches.items()}})
    for name, kind, replaces in (
        ("fused_attention_fwd", "fwd", "accelerate_tpu/ops/fused_attention.py:90"),
        ("fused_attention_bwd", "bwd", "accelerate_tpu/ops/fused_attention.py:107"),
    ):
        rec = fused_results[("bert", kind, torch.bfloat16)]
        rec16 = fused_results[("bert", kind, torch.float16)]
        records.append({"name": name, "route": "cuda",
                        "source": f"accelerate_tpu_torch/csrc/{name}.cu", "replaces": replaces,
                        "launches": train_launches[name], **{k: rec[k] for k in keys},
                        "launches_grad_accum": accum_launches[name],
                        "launches_fp16": fp16_launches[name],
                        "launches_mesh_2rank_bert": [r[name] for r in bert_tp_launches],
                        "fp16": {k: rec16[k] for k in keys}})
    for name, kind, source, line in (
        ("flash_attention_fwd", "fwd", "flash_fwd", 166),
        ("flash_attention_dq", "dq", "flash_dq", 232),
        ("flash_attention_dkdv", "dkdv", "flash_dkdv", 281),
    ):
        rec = flash_results[("llama_long", kind, torch.bfloat16)]
        lm_rec = flash_results[("lm774m", kind, torch.bfloat16)]
        rank_rec = flash_results[("lm774m_rank", kind, torch.bfloat16)]
        moe_rec = flash_results[("moe_train", kind, torch.bfloat16)]
        mesh_recs = {case: flash_results[(case, kind, torch.float32)]
                     for case in ("mesh_2rank", "mesh_2rank_b1", "cp2_half", "cp2_half_full")}
        cp_recs = {case: flash_results[(case, kind, torch.bfloat16)]
                   for case in ("ring_block", "zigzag_block")}
        records.append({"name": name, "route": "cuda",
                        "source": f"accelerate_tpu_torch/csrc/{source}.cu",
                        "replaces": f"accelerate_tpu/ops/flash_attention.py:{line}",
                        "launches": llama_launches[name], **{k: rec[k] for k in keys},
                        "lm774m": {k: lm_rec[k] for k in keys},
                        "lm774m_rank": {k: rank_rec[k] for k in keys},
                        "moe_train": {k: moe_rec[k] for k in keys},
                        **{f"{case}_f32": {k: r[k] for k in keys}
                           for case, r in mesh_recs.items()},
                        **{case: {k: r[k] for k in keys} for case, r in cp_recs.items()},
                        "launches_cp_attention": {strategy: [r[name] for r in per_rank]
                                                  for strategy, per_rank in cp_launches.items()},
                        "launches_lm774m": lm_launches[name],
                        "launches_lm774m_offload_dots": offload_dots_launches[name],
                        "launches_lomo": lomo_launches[name],
                        "launches_offload_opt": offload_opt_launches[name],
                        "launches_moe_train": moe_train_launches[name],
                        "launches_fsdp_lm": fsdp_launches[name],
                        "launches_mesh_2rank": {leg: [r[name] for r in per_rank]
                                                for leg, per_rank in mesh_launches.items()},
                        "launches_mesh_lm774m": [r[name] for r in mesh_lm_launches],
                        "launches_moe_ep": [r[name] for r in moe_ep_launches]})
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root

Phases, each of which stops the script with a non-zero exit on failure:

1. environment: the card's name and power limit; TF32 off, deterministic
   algorithms on;
2. build: kernels B1 (``csrc/tdvmm.cu``), B2 (``csrc/tdvmm_calib.cu``), B3
   (``kernels/ssd/csrc/ssd.cu``) and B4 (``kernels/crossing/csrc/
   crossing.cu``) with ``nvcc`` from the checkout's sources, one process per
   source, all started together; one line per B1/B2 kernel instantiation
   with its registers, shared memory and spills (``-Xptxas -v``) and the
   tensor-core instructions of its SASS (``cuobjdump``), failing if a K
   loop has no IMMA/HMMA or keeps an IDP4A; the same line per B3 device
   kernel, failing unless its three product kernels (C.B^T with the
   prefix sums, the chunk states, the scan) have HMMA in both dtypes; the
   same line per B4 device kernel (prep, fused), failing unless the fused
   kernel (the 3xTF32 product t_on . I, then the bisection) has HMMA; and
   every B1/B2 instantiation of the 3xTF32 storage has HMMA and no FFMA
   beyond its bf16 twin's (the readout's IEEE division);
3. kernels: every mode of B1 (raw, fused without readout, scalar window,
   (E,) window, shared-x, per-column member windows of a ragged launch) and
   B2 (one slot, E slots, member slots) against its plain torch version on
   the card at the serving paths' shapes, bitwise (``max_abs_err == 0``),
   in each code storage: int8, float32 codes and int4-packed pairs, the
   MoE expert grid at mixtral-8x7b's prefill (E 8, M 2049) and decode (M 5)
   shapes and at kimi-k2's (E 384 on the grid's z axis: B1 fused at the
   engine steps' 4 capacity rows, B1 raw and B2 with 384 slots at
   calibration's 54, K x N 7168 x 2048 and 2048 x 7168), the edges of the two CTA tiles (``tile_edge_cases``: M 1, 16,
   17, 129, 256, 257, ragged and unaligned operands) and of the float32
   codes' exact envelope (|acc| 15,667,200 and 16,776,450); float32 rows also time a
   TF32 ``bmm`` yardstick beside the full-float32 one; the training path's
   int8 launches (``qat_cases``: B2 at every site of the full-width qwen
   QAT run, 2048 rows, B1 fused at the same shapes, the perceptron's B2 at
   800 and 200 rows), bitwise; B1/B2's 3xTF32
   storage (``f32x3_cases``) at qwen's QAT shapes (2048 rows, ffn.in, the
   grouped q/k/v launch, ffn.out, attn.out) and the tiles' edges, on noisy
   codes against
   the exact float64 product (accumulator within ``tdvmm.F32X3_RTOL`` of
   sum|x||w|, readout levels within the exact one's rounding:
   ``tdvmm.check_readout``) and on p = 9 and p = 11 integer codes bitwise,
   two calls bitwise equal;
   zamba2-2.7b's launches (``ssm.in_proj`` as one ragged launch of
   member widths 5120, 5120, 64, 64, 80 in 128-lane spans, ``hybrid.fuse``
   at K 5120; 8192 prefill rows and 2 decode rows), bitwise;
   B3 against ``ssd_plain`` at full width in bfloat16 and float32 (and at
   zamba2's prefill: B 2, L 4096, H 80, G 1, S 64), on a
   small grouped case with a ragged length and at its tiles' edges (rows
   that 16-byte copies cannot take among them), within SSD_RTOL, the full
   width rows beside the earlier CUDA-core kernel's time as read before
   (not in this run) and the bfloat16 one with its device time by kernel;
   shapes past B3's chunk or d_state limit must raise; B4 against
   ``crossing_plain`` at the physics path's three launches, a built case
   whose steps all fall below the row's last onset (the general step) and
   one whose crossings fall exactly on it, within CROSSING_RTOL_T of the
   window T and bitwise equal over two calls; each with kernel / plain /
   bound / library times; flash attention (``_attend_flash`` and
   ``_attend_flash_blocks``) against the dense softmax at zamba2's shared
   block, B 2 x S 4096 x 32 heads x 80 in float32, within FLASH_TOL, timed
   in float32 and bfloat16, and its backward: the gradients of q, k, v,
   the block's input and weights through ``attention.apply_train`` with
   flash against the dense softmax's, within FLASH_TOL elementwise, each
   forward + backward timed; then "autotune" (``autotune_phase``): (a) the
   tile sweep of ``launch/autotune_tdvmm`` over the main path's serving
   shapes (qwen's ffn.in / ffn.out at 4, 64, 128 and 256 rows) and two
   M = 512 shapes of its work list, every tile bitwise the others and the
   plain version (B1 raw, B1 fused, B2), B1 fused timed at each tile, the
   table written to a temporary file, never to the committed one; (b) at
   every committed entry of those serving shapes, the table's tile bitwise
   ``plan_tile``'s; ``plan_kernel``'s host time per call; then "api"
   (``api_phase``): the layer object a user reaches for,
   ``repro_torch.core.TDVMMLinear``, at qwen's ffn.in width (1024 -> 2816,
   bf16, int8 codes at p = 6, a nonzero bias) on API_ROWS rows: its
   forward bitwise a direct ``td_matmul`` on the same weights plus the
   bias, exactly one B2 launch (the data-calibrated window); ``calibrate``
   equal to ``calibrate_out_scale``, exactly one B1 raw launch; the pinned
   config's forward bitwise ``td_matmul`` under it, exactly one B1 fused
   launch;
4. serving: qwen1.5-0.5b at full width, 8 of its 24 layers
   (SERVE_LAYERS; d_model 1024, bf16, random weights from seed 0) under
   the ``ffn_unchained`` and
   ``ffn_chained`` plans: one calibration pass, then the paged engine
   serves 8 ragged requests; every request must finish with its full token
   budget, no NaN logits, its stream equal to the same request served alone,
   and the kernel launch counts must match the plan's sites exactly; (c)
   the engine report's ``autotune`` names the card's platform, every entry
   a table hit, and each B1/B2 launch took the tile its entry names; the
   same for ``ffn_unchained`` with the int8 KV cache (int8 page pools).
   Then the engine's fault tolerance on that model, params, calibration
   and trace (``fault_qwen``): killed mid-prefill, at the first decode and
   late in decode, each snapshot saved to disk, restored into a fresh
   engine and resumed to the unbroken run's streams, finish reasons and
   steps, with bf16 and with int8 page pools (snapshot bytes, save and
   restore seconds printed); a transient step failure retried once with
   the streams unchanged; a persistent one failing exactly one request,
   its neighbours unchanged and its stream a prefix of the unbroken one;
   injected drift recalibrating in place under a drift probe of 2 x 128
   tokens every 8 steps (the window tensors keep their storage, step
   shapes 2, B1 raw and B2 launches exactly sites x probes), and the same
   probes without drift reproducing the pinned windows bitwise.
   Then (``observe_qwen``) the engine's SLA policy, telemetry and tracing
   on that model: a run with a metrics sink (memory and JSONL emitters, a
   step-latency spike rule) and a tracer keeps the untraced streams, 2 step
   shapes and exact B1 launches, its Chrome trace validates with every
   request's spans at the report's steps and its JSONL holds every
   observation and alert; an SLA run (aging 4, priorities rid % 3, one
   deadline-infeasible request, one joule budget crossed mid-stream)
   rejects at zero cost, finishes the over-budget request on a prefix of
   its stream and leaves every other stream unchanged, and the default
   policy replays FIFO; live ``clip_rate.<site>`` series with drift
   injected mid-run equal direct probes of the clean and drifted weights,
   alerts exactly above their limit, B1 raw and B2 sites x observations;
   a kill and resume with a fresh sink and tracer continues the series
   and the trace as one document; the serve CLI writes its metrics, trace
   and report files, and ``launch/trace_report`` renders the trace.
   Then "mesh qwen" (``mesh_qwen``): a world of one over NCCL and a (1, 1)
   mesh; each plan's engine on the mesh serves the trace to the meshless
   engine's streams, finish reasons, finish steps and steps with exactly
   sites x steps B1 fused launches, and one full-width QAT step on the
   mesh equals the meshless step bitwise (every state leaf, every
   metric, the same launches).  The kernel phase holds B1/B2 at the shard
   shapes of a model axis of 2 and kimi-k2's expert grid at a data axis of
   2 (``tp_shard_cases``).  Then two processes share the card over gloo,
   which carries CUDA tensors for the collectives this path uses
   (``GLOO_CUDA``, from scripts/gloo_cuda_probe.py): at 1 x 2 (TP) and
   2 x 1 (DP), TD-VMM row and column sites bitwise the meshless sites, the
   engine on the trace with exact launches, and teacher-forced logits;
   at 2 x 1 the meshless streams and logits, at 1 x 2 those of the
   meshless run in TP's order (``tp_order``), bitwise (``two_ranks``).
   Then kimi-k2-1t-a32b at full width (d_model 7168, 384 experts of d_ff
   2048, top-8, one shared expert, vocab 163,840, bf16, random weights from
   seed 0) cut to 1 of its 61 layers, capacity factor 1.25, under moe.* at
   p = 6 through the paged engine: one calibration pass over 4 x 512
   tokens ((384,) windows at moe.expert.*, (1,) at moe.shared.*), then the
   8 ragged requests (slots 4, chunk 64, page 16); exact launch counts (6
   B1 fused per step, B1 raw = B2 = 6 in calibration), 2 step shapes, no
   NaN, the first and last requests alone == batched; its peak allocated
   memory after init, calibration and serving (each expert bank is
   programmed a slice of experts at a time).
   Then "mesh kimi" (``mesh_kimi``): that layer's attention (64 heads, 8 KV
   heads of 112) split as a model axis of 16 splits it, by KV groups (4
   query heads and their one KV head a rank), the 16 shards run one after
   another in this process (``ShardView``: rank r's view of the mesh, no
   process group), each from ``meshctx.local_config`` and
   ``sharding.shard``: a 4 x 512 prefill and 8 decode steps on a dense
   cache; every shard's attention output before ``wo`` is bitwise the
   meshless layer's heads, and the 16 ``wo`` partials summed in rank order
   are bitwise the layer's output, in the mesh's order (``tp_order(16)``
   with each column product formed as its shards form it); a shard's cache
   is 1/8 of the meshless one.  The kernel phase also holds B1 at kimi's
   expert shard on the 16 x 16 mesh (24 experts, d_ff 128).
   Then mamba2-1.3b at full width (24 of its 48 layers, SSM_SERVE_LAYERS;
   d_model 2048, 64 heads x 64, d_state 128, chunk 128, vocab 50280, bf16,
   random weights from seed 0)
   under ``ssm_unchained``: one calibration pass over 4 x 512 tokens, then
   the static path serves 4 prompts x 512 tokens for 32 new tokens each;
   no NaN, exact launch counts, and the batch served in reverse order must
   give the reversed streams.  Then "mesh ssm" (``mesh_ssm``, two processes
   on the card over gloo): that mamba2 on a 1 x 2 mesh (its heads, x / z
   channels and B / C columns split, B and C all-gathered before the
   scan): ssm.in_proj and ssm.out bitwise on each rank's shard, the serve
   with exact B1 fused / raw and B3 launches a rank, its streams and its
   teacher-forced logits (ssm.* and TD-VMM off) bitwise the meshless run's
   in TP's order (``tp_order``, which also sums the gated norm's squares as
   two partials), TD-VMM off within TWO_RANK_RTOL of the plain meshless
   run; one qwen1.5-0.5b QAT step in float32 at 1 x 2 (parameters bitwise,
   gradients within QAT_TP_RTOL, each shard's noisy codes bitwise the
   meshless codes); zamba2-2.7b in float32 at 2 x 1 with batch 1 and an
   8192-token prompt on the sequence-split cache, teacher-forced with the
   meshless greedy stream (logits bitwise the meshless run's in the
   split's order, ``seq_order``, and within MESH_HYB_RTOL of the plain
   one's, its greedy token at every step; each rank's cache bytes).
   ("mesh qwen" ends with (d), ``dryrun_vs_step``: the dry run of qwen's
   4 x 512 prefill counts the real step's kernel calls, FLOPs and HBM
   bytes.)  Then mixtral-8x7b at full width (d_model
   4096, 32 heads, GQA kv 8, 8 experts top-2 of d_ff 14336, sliding window
   4096, vocab 32000, bf16, random weights from seed 0) cut to 8 of its 32
   layers, capacity factor 4.0 (dropless), under ``moe_unchained`` (int8
   codes) and ``moe_mixed`` (f32 codes at ``moe.expert.in``, int4 pairs at
   ``moe.expert.out``): one calibration pass over 4 x 512 tokens, then the
   static path serves 4 prompts x 512 tokens for 16 new tokens each; exact
   launch counts per code storage, (8,) windows, no NaN, reversed batch ==
   reversed streams.  Then zamba2-2.7b at full width and depth (54 Mamba-2
   layers, d_model 2560, 80 heads x 64, d_state 64, chunk 128; 9 calls of
   the shared attention block, 32 heads x 80, d_ff 10240, fed
   fuse(concat(x, embed0)); vocab 32000, bf16, random weights from seed
   0) under ``hybrid_unchained`` (ssm.*, ffn.*, hybrid.fuse at p = 6):
   one calibration pass over 2 x 4096 tokens, then the static path serves
   2 prompts x 4096 tokens (past FLASH_THRESHOLD: flash in every
   shared-block prefill) for 16 new tokens each; exact launch counts
   derived from the plan, the five calibrated sites, no NaN, reversed batch
   == reversed streams; then the same with the int8 KV cache, and how many
   tokens differ from the bf16 run.  Then the paper's circuit
   (``launch/perceptron.py``): the 10 x 10 x 10 perceptron on a batch of 64,
   clean and on DIBL-perturbed 6-bit weights, and a 1024 x 1024
   four-quadrant array on 4096 samples, each within TD_ATOL of its closed
   form, with exactly 2 B4 launches per perceptron forward and 1 per array
   forward;
   Then training: qwen1.5-0.5b at full width (24 layers, d_model 1024,
   d_ff 2816, vocab 151936, bf16, random weights from seed 0), every linear
   a 6-bit TD-VMM site (QAT: B2 in every forward, the straight-through
   custom gradient in the backward), through ``launch/train.train_loop``:
   AdamW (lr 1e-3, 2 warmup steps), SyntheticLM seed 0, 4 x 512 tokens a
   step, 8 steps, remat "minimal"; every loss and gradient norm finite, the
   last loss below the first, exactly sites x layers x (steps + recomputes)
   B2 launches; one more step under the profiler.  Two noisy steps at the
   same width (programming noise at every site, ``loss_fn`` with a key):
   every launch in the 3xTF32 storage, counted.  The case study's QAT half
   (``launch/perceptron.qat_case_study``): the 10 x 10 x 10 perceptron
   trained on the card, deployed through B4 with DIBL, digital twin >= 0.9
   and circuit > 0.8.  mamba2-1.3b at full width, 24 of its 48 layers,
   every ssm.* site a 6-bit QAT site, through ``train_loop`` (AdamW lr
   1e-3, 4 steps of 4 x 512 tokens, remat "minimal", the scan
   ``ssd_plain`` under autograd): losses and gradient norms finite, the
   last loss below the first, B2 exactly sites x layers x (steps +
   recomputes).  Then three more training paths, each through ``train_loop`` with random weights from seed 0,
   SyntheticLM seed 0, remat "minimal" and AdamW with 1 warmup step, each
   gated on finite metrics, the last loss below the first and exactly
   ``qat_expected_launches`` B2 launches (derived from the resolved plan:
   the blocks' sites twice a step, the recompute included, the hybrid
   fuse and the head once) and nothing else, each with its seconds a step
   and peak allocated memory: "train long", qwen1.5-0.5b at full width
   and depth, every linear 6-bit, 4 steps of one 4096-token sequence
   (past FLASH_THRESHOLD: flash under autograd in every layer), then the
   control in float32 with TD-VMM off, flash's loss and gradients against
   the dense softmax's (LONG_LOSS_RTOL; FLASH_TOL of each leaf's max|g|);
   "train mixtral", mixtral-8x7b at full width, 2 of its 32 layers,
   dropless, every linear 6-bit (B2 on the (8, 2049, K, N) expert grid),
   4 steps of 4 x 512 with bfloat16 moments (the byte reckoning printed
   first; float32 moments do not fit), the router's aux losses finite and
   the load-balance loss positive; "train zamba2", zamba2-2.7b at full
   width and depth under the hybrid plan, 3 steps of one 4096-token
   sequence (flash in the shared block, the scan ``ssd_plain`` under
   autograd: no B3 launch);
5. small input: the card's kernel path against the CPU plain path at smoke
   width, same weights, for qwen, for mamba2, for mixtral under both MoE
   plans (a prompt longer than its window of 8), for zamba2 under
   ``hybrid_unchained`` with the flash threshold lowered to 8 (flash in
   every shared-block prefill), for the perceptron and
   a 64 x 64 array, and for 3 training steps of the smoke qwen under the
   global TD-VMM config and under ``ffn_chained``, and of the smoke mamba2
   under the global config (step-0 loss and gradients, then the losses;
   under TD-VMM the CPU also runs on the card's codes, ``CodeTape``, which
   counts the codes the two devices round to different levels).

It then prints one ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line.  Without a CUDA device, or run from a
directory that does not hold the repository, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import tempfile
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
# cuBLAS reads this once, at its first handle: set before torch starts it.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
# the caching allocator grows its segments instead of splitting fixed ones:
# kimi-k2's phase frees and takes multi-GB blocks (a bank's 5.6 GB of codes,
# its 1 GB slices) beside ~39 GB of weights
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

H100_HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
H100_INT8_OPS_PER_S = 1979e12       # dense int8 tensor-core rate
H100_TF32_FLOPS_PER_S = 495e12      # dense TF32 tensor-core rate
H100_BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core rate

ARCH = "qwen1.5-0.5b"
# qwen's serving paths ("serve qwen", "fault qwen", "observe qwen", "mesh
# qwen") run 8 of its 24 layers, at full width: with all 24 they took ~570 s
# of a 1,177 s run on a slow card host, near the 1200 s limit; with 12 and
# the three training phases of ``train_new_paths`` the script took 1,018 s
# on an H100 (those four phases 306 s); training keeps all 24
SERVE_LAYERS = 8
CHUNK, SLOTS, PAGE, NUM_PAGES = 64, 4, 16, 64
CALIB_BATCH = (2, 64)
CALIB_ROWS = CALIB_BATCH[0] * CALIB_BATCH[1]
FFN_SHAPES = ((1024, 2816), (2816, 1024))       # ffn.in (K, N), ffn.out
PROFILE_SKIP, PROFILE_STEPS = 16, 12             # engine ticks
# the fault phase's drift probe: a (batch, tokens) batch, every N steps
FAULT_PROBE, FAULT_CHECK_EVERY = (2, 128), 8
FAULT_ROWS = FAULT_PROBE[0] * FAULT_PROBE[1]
# the observe phase's live clip series: a probe of FAULT_PROBE tokens every
# OBSERVE_EVERY steps, drift injected at OBSERVE_DRIFT_AT
OBSERVE_EVERY, OBSERVE_DRIFT_AT = 8, 20
# ... against windows pinned at this fraction of the probe's own max|z|
OBSERVE_PIN = 0.6
# series read off the host clock: two runs never give the same values
CLOCK_SERIES = ("step_latency_s", "straggler_dt_s", "heartbeat")
# Phase 5, card against CPU logits relative to max|logit|: the TD-VMM codes
# are bitwise on both, so only float32 reductions outside the kernels
# (attention, norms, the head) differ; measured 6e-7 on an H100.
SMALL_LOGIT_RTOL = 1e-5

SSM_ARCH = "mamba2-1.3b"
# mamba2's serving paths ("serve mamba2", "mesh ssm" (a)) run 24 of its 48
# layers, at full width, for the script's time limit (zamba2 serves its 54
# Mamba-2 layers at full depth)
SSM_SERVE_LAYERS = 24
SSM_BATCH, SSM_PROMPT, SSM_GEN = 4, 512, 32
SSM_ROWS = SSM_BATCH * SSM_PROMPT
# ssm.in_proj: the five members z, x, B, C, dt (4096, 4096, 128, 128, 64),
# each in a 128-lane span; ssm.out: (d_inner, d_model)
SSM_WIDTHS = (4096, 4096, 128, 128, 128)
SSM_IN, SSM_OUT = (2048, sum(SSM_WIDTHS)), (4096, 2048)
SSM_PROFILE_STEPS = 8                            # decode steps
# B3 against ssd_plain, max|kernel - plain| over max|plain|, for y and the
# final state: both sum in float32 in different orders, and B3 multiplies
# on the tensor cores in 3xTF32 (~2^-22 of each product).  Measured on an
# NVIDIA H100 80GB HBM3 at 700 W, at the cases of ``ssd_cases``: float32 y
# <= 1.1e-6, the state <= 3.3e-7.  bfloat16 y rounds once from float32 on
# both sides, so one bf16 ulp (at most 2^-7 of |y|) can separate them;
# measured 5.3e-4.
SSD_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7, "state": 1e-5}
# Phase 5, mamba2 at smoke width, card against CPU logits relative to
# max|logit|: the TD-VMM codes came out equal; B3 and the plain scan, the
# conv and the norms sum in other orders; measured 3.5e-7 on an NVIDIA H100
# 80GB HBM3 at 700 W.
SMALL_SSM_LOGIT_RTOL = 1e-5

# The physics path (launch/perceptron.py): the paper's 10 x 10 x 10
# perceptron on a batch of 64, and a 1024 x 1024 four-quadrant array on 4096
# samples.
PHYS_N, PHYS_BATCH = 1024, 4096
CASE_N, CASE_BATCH = 10, 64
# B4 against crossing_plain, max|t_kernel - t_plain| / T: B4 takes Q past
# the row's last onset as mid * S - M (M = t_on . I in 3xTF32) and sums it
# over K in another order below, so where Q(mid) lies within that rounding
# of the charge the two may take different halves; both still bracket the
# crossing, so they differ by at most the last bracket (2T * 2^-24) plus
# the rounding over Q's slope.  Measured on an NVIDIA H100 80GB HBM3 at
# 700 W: 4.4e-7 T at the perceptron's launches, 8.9e-7 T at the array's (a
# few float32 ulps of t in [T, 2T]), as with the earlier CUDA-core
# kernel, and 2.4e-7 T at the general-step and t_max cases.  The
# gate, ~2.8x that, keeps float32 rounding apart from a kernel short of
# steps (after 18 of 24 the last bracket is 7.6e-6 T and its midpoint is
# off by up to 3.8e-6 T) and from a product summed in the tensor cores'
# truncating accumulator over all of K (3.55e-6 T at the array).
CROSSING_RTOL_T = 2.5e-6
# decoded output against the closed form (Eq. 1) in float64, and card
# against the CPU plain path: float32 onsets, currents and charge sums, and
# the bisection's last bracket (2^-23 of T).  Measured on the same card
# with the redesigned B4: 7.4e-7 (perceptron), 1.17e-6 (array), 8.9e-7
# (card against CPU); 5.6e-7, 6.7e-7 and 8.9e-7 with the earlier kernel.
# Gated at 2.5e-6, for the same reason as CROSSING_RTOL_T.
TD_ATOL = 2.5e-6
H100_F32_FLOPS_PER_S = 67e12        # float32 on CUDA cores (data sheet)

# Training at full width (qwen1.5-0.5b, every linear a TD-VMM site):
# ShapeConfig train_4k's 256 x 4096 cut to 4 x 512 and 8 steps, for the
# script's time limit.
QAT_BATCH, QAT_SEQ, QAT_STEPS = 4, 512, 8
QAT_ROWS = QAT_BATCH * QAT_SEQ
QKV_WIDTHS = (1024, 1024, 1024)                   # q, k, v at d_model 1024
# (K, N) and member widths of the QAT run's B2 launches: attn.qkv (one
# grouped launch), ffn.in (gate and up), ffn.out and attn.out
QAT_SHAPES = (((1024, sum(QKV_WIDTHS)), QKV_WIDTHS), ((1024, 2816), None),
              ((2816, 1024), None), ((1024, 1024), None))
# the perceptron's QAT: 800 training rows a step, 200 test rows, 10 x 10
PERCEPTRON_QAT_ROWS = (800, 200)
# the 3xTF32 storage's integer cases: p = 9 inputs x 4-bit weights and
# p = 11 inputs x 3-bit weights (random codes, |acc| far below 2^24)
F32X3_INT = {"p9": (511, 15), "p11": (2047, 7)}
# Phase 5, training at smoke width, card against CPU: the TD-VMM codes are
# the same on both (the CPU's run on the card's codes checks it, and counts
# where not), attention, norms and the float32 gradient products sum in
# other orders.  Step 0: the loss relative (1e-6) and each leaf's
# gradient relative to its max|g| (1e-5); the losses of 3 AdamW steps
# relative (1e-5, as tests/test_torch_train.py holds 3 steps of train_loop
# to the JAX package's).
SMALL_TRAIN_LOSS_RTOL0 = 1e-6
SMALL_TRAIN_GRAD_RTOL = 1e-5
SMALL_TRAIN_LOSS_RTOL = 1e-5

# mixtral-8x7b (arXiv:2401.04088) at full width: 8 of its 32 layers (one
# layer is ~2.9 GB in bf16, 32 would be ~93 GB on an 80 GB card), capacity
# factor n_experts / top_k = 4.0, so capacity is T + 1 and no token drops
# (the default 1.25 drops tokens depending on the batch's composition).
MOE_ARCH = "mixtral-8x7b"
MOE_LAYERS, MOE_CAPACITY_FACTOR = 8, 4.0
MOE_BATCH, MOE_PROMPT, MOE_GEN = 4, 512, 16
# the expert grid: E experts, C = capacity rows of the dispatch buffer
# (int(T * top_k * factor / E) + 1: 2049 at prefill, 5 at decode), and the
# (K, N) of moe.expert.in and moe.expert.out
MOE_E, MOE_PREFILL_C, MOE_DECODE_C = 8, 2049, 5
MOE_IN, MOE_OUT = (4096, 14336), (14336, 4096)
MOE_PROFILE_STEPS = 4                            # decode steps
# Phase 5, mixtral at smoke width, card against CPU logits relative to
# max|logit|: the TD-VMM codes are bitwise on both; the router, attention
# and norms sum in float32 in other orders.
SMALL_MOE_LOGIT_RTOL = 1e-5

# kimi-k2-1t-a32b (archs.py:79-87) at full width through the paged engine:
# d_model 7168, 64 heads (GQA kv 8, head_dim 112), 384 experts of d_ff 2048,
# top-8, one shared expert, an untied vocab of 163,840, bf16.  Depth cut
# from 61 layers to 1: one layer is ~34 GB in bf16 (its three expert banks
# 11.27 GB each) beside 4.7 GB of embeddings and head, so 61 would be ~2 TB.
# The published capacity factor 1.25 is kept: a decode step of 4 slots
# puts at most 4 rows on an expert, its capacity (cannot drop), and a
# prefill chunk's drops depend on that chunk alone.
# "mesh qwen": the mesh axes the TP shard shapes of the kernel phase assume
TP, DP = 2, 2
# Two ranks sharing the one card can only talk over gloo (NCCL takes one
# rank per device), and gloo must then carry CUDA tensors for every
# collective their path uses: (b) of "mesh qwen" (the dense qwen engine at
# 1 x 2 and 2 x 1: TP all-reduces and all-gathers, the decode tokens'
# all-gather) runs only if all of these are.  scripts/gloo_cuda_probe.py
# found on the H100 (torch 2.11) that gloo carries both (PERF.md section 6
# has its whole finding).
GLOO_CUDA = {"all_reduce": True, "all_gather": True}

TWO_RANK_TIMEOUT = 240
# (b)'s teacher-forced logits: 4 x 64 prompts, 8 forced tokens; the gate on
# the 1 x 2 run's gap to the meshless run's with TD-VMM off, relative to
# max|logit| (the CPU tests' outer limit for sharded logits,
# tests/test_torch_dist_mesh.py)
TWO_RANK_PROMPTS, TWO_RANK_FORCED = (4, 64), 8
TWO_RANK_RTOL = 5e-2

# "mesh ssm": mamba2 at 1 x 2 (teacher-forced for MESH_SSM_FORCED tokens
# after the serve phase's 4 x 512 prompts); one full-width qwen QAT step at
# 1 x 2 in float32, each gradient leaf within QAT_TP_RTOL of its max|g|
# (tests/test_torch_train.py's GRAD_RTOL: the column sites' input
# gradients are two partial products summed over ``model``, the meshless
# one one product, so the two are not bitwise); zamba2 at 2 x 1 in float32
# with batch 1 and a MESH_HYB_PROMPT-token prompt (a sequence-split cache
# of 4,104 positions a rank, its prefill's attention whole), teacher-forced
# with the meshless greedy stream: the same greedy token at every step and
# logits within MESH_HYB_RTOL of max|logit| (a decode step sums the ranks'
# softmax sums and float32 products over the data axes, in another order
# than one softmax; in bf16 the model carries such a reordering to 17 % of
# max|logit| in 16 steps, so the check is made where the arithmetic is
# float32)
MESH_SSM_FORCED = 8
QAT_TP_RTOL = 1e-5
MESH_HYB_PROMPT, MESH_HYB_GEN = 8192, 16
MESH_HYB_RTOL = 1e-3
MESH_TIMEOUT = 420

KIMI_ARCH = "kimi-k2-1t-a32b"
KIMI_LAYERS = 1
KIMI_E = 384
KIMI_IN, KIMI_OUT = (7168, 2048), (2048, 7168)
KIMI_CALIB = (4, 512)
KIMI_CALIB_ROWS = KIMI_CALIB[0] * KIMI_CALIB[1]
# the expert grid's capacity rows: 4 for a 64-token chunk and for 4 decode
# slots, 54 for the 2048 calibration tokens
KIMI_STEP_C, KIMI_CALIB_C = 4, 54
# the requests served alone against their batched streams: the first, last
KIMI_SOLO = (0, 7)
# an expert whose window stays at calibration's floor saw no token
KIMI_FLOOR = 1e-9
# "mesh kimi": the production mesh's axes (16 x 16); the attention of that
# one layer split by KV groups over a model axis of 16, a prefill of
# KIMI_MESH_PROMPT and KIMI_MESH_GEN decode steps on a dense cache
KIMI_MESH = 16
KIMI_MESH_PROMPT, KIMI_MESH_GEN = (4, 512), 8
# mamba2-1.3b trained at full width, every ssm.* site a 6-bit QAT site, 4
# steps of QAT_BATCH x QAT_SEQ tokens (its scan is ssd_plain under
# autograd: B3 has no backward); depth cut from 48 to 24 layers for the
# script's time limit (the phase took 57.6 s at 48 on an H100, ~39 s of it
# the final checkpoint)
SSM_TRAIN_STEPS, SSM_TRAIN_LAYERS = 4, 24
# Three more training paths (``train_new_paths``), each through
# ``train_loop`` with AdamW, remat "minimal", every site of its plan a
# 6-bit QAT site.  "train long": qwen1.5-0.5b at full width and depth on
# one 4096-token sequence a step (past FLASH_THRESHOLD: every layer's
# training attention runs flash under autograd), and a control in float32
# with TD-VMM off, where flash's loss and gradients must match the dense
# softmax's: the loss within LONG_LOSS_RTOL relative, each gradient leaf
# within FLASH_TOL of that leaf's max|g| (the JAX package's flash bound).
LONG_BATCH, LONG_SEQ, LONG_STEPS = 1, 4096, 4
LONG_LOSS_RTOL = 1e-5
# "train mixtral": mixtral-8x7b at full width, 2 of its 32 layers, the
# dropless capacity factor, MOE_BATCH x MOE_PROMPT tokens a step.  AdamW
# holds ~18 bytes a parameter (bf16 weight 2, float32 gradient and its
# clipped copy 8, two float32 moments 8): 3.16 G parameters at 2 layers
# (~57 GB), 6.07 G at 4 (~109 GB, past the card's 80 GB).  With float32
# moments the first update of the 2 layers ran out of the H100's 80 GB
# (78.1 GB allocated), so the moments are bfloat16: 14 bytes a parameter,
# ~44 GB.
MIX_TRAIN_LAYERS, MIX_TRAIN_STEPS = 2, 4
MIX_MOMENTS = "bfloat16"
# AdamW's first update moves every weight by ~lr: on the H100 it took the
# 2 layers' loss from 10.87 to 20.40 at lr 1e-3 (qwen's rate), to 19.93 at
# 2.5e-4 (qwen's scaled by the width ratio 1024 / 4096; the fourth step
# still ended above the first) and to 18.35 at 1e-4, whose next step fell
# to 9.45
MIX_TRAIN_LR = 1e-4
TRAIN_BYTES_PER_PARAM = {"float32": 18, "bfloat16": 14}
# "train zamba2": zamba2-2.7b at full width and depth (2.44 G parameters,
# ~44 GB by the same reckoning) on one sequence of its 4096-token context
# a step, HYB_SITES 6-bit QAT sites; the shared block's attention trains
# through flash, the scan is ssd_plain under autograd (no B3 launch).
HYB_TRAIN_BATCH, HYB_TRAIN_SEQ, HYB_TRAIN_STEPS = 1, 4096, 3
# sites applied between the rematerialized blocks, once per forward: the
# hybrid family's fuse (once a group) and the untied head; every other
# site's block runs again when the backward recomputes it
OUTSIDE_REMAT = ("hybrid.fuse", "head")

# zamba2-2.7b (arXiv:2411.15242) at full width and depth: 54 Mamba-2 layers
# (80 heads x 64, d_state 64, chunk 128) in 9 groups of 6, each group
# followed by the shared attention + FFN block (32 heads x 80, d_ff 10240)
# fed fuse(concat(x, embed0)); 2 prompts of 4096 tokens (its context, past
# FLASH_THRESHOLD, so every shared-block prefill runs flash attention), 16
# new tokens each.
HYB_ARCH = "zamba2-2.7b"
HYB_SITES = ("ssm.*", "ffn.*", "hybrid.fuse")
HYB_BATCH, HYB_PROMPT, HYB_GEN = 2, 4096, 16
HYB_ROWS = HYB_BATCH * HYB_PROMPT
# ssm.in_proj: the five members z, x, B, C, dt (5120, 5120, 64, 64, 80),
# each in a 128-lane span whose tail columns hold zero weight codes;
# hybrid.fuse: (2 d_model, d_model)
HYB_MEMBERS = (5120, 5120, 64, 64, 80)
HYB_WIDTHS = (5120, 5120, 128, 128, 128)
HYB_IN, HYB_FUSE = (2560, sum(HYB_WIDTHS)), (5120, 2560)
# the shared block's ffn.in (gate and up, two launches) and ffn.out
HYB_FFN_IN, HYB_FFN_OUT = (2560, 10240), (10240, 2560)
HYB_PROFILE_STEPS = 4                            # decode steps
# Flash attention against the dense softmax on float32 inputs: the JAX
# package's own bound (tests/test_models.py::test_flash_matches_dense_
# attention), elementwise |flash - dense| <= tol + tol |dense|.
FLASH_TOL = 2e-3
# Phase 5, zamba2 at smoke width (flash on: threshold 8, blocks of 4), card
# against CPU logits relative to max|logit|: B1 codes bitwise, B3, flash,
# the conv and the norms sum in float32 in other orders.
SMALL_HYB_LOGIT_RTOL = 1e-5
# zamba2 at full width with TD-VMM off: the first decode step's logits with
# the int8 KV cache against the bf16 one, relative to max|logit|; ~3x the
# 0.049 measured on an H100 (the JAX package holds its smoke int8 decode to
# 0.15 of the full forward, tests/test_models.py)
INT8_KV_STEP_RTOL = 0.15

_TDVMM_SRC = "src/repro_torch/kernels/tdvmm/csrc/"
SOURCES = {"tdvmm_fused": _TDVMM_SRC + "tdvmm.cu",
           "tdvmm_matmul_raw": _TDVMM_SRC + "tdvmm.cu",
           "tdvmm_calibrated": _TDVMM_SRC + "tdvmm_calib.cu",
           "ssd_scan": "src/repro_torch/kernels/ssd/csrc/ssd.cu",
           "crossing": "src/repro_torch/kernels/crossing/csrc/crossing.cu"}
REPLACES = {"tdvmm_fused": "src/repro/kernels/tdvmm/tdvmm.py:233",
            "tdvmm_matmul_raw": "src/repro/kernels/tdvmm/tdvmm.py:233",
            "tdvmm_calibrated": "src/repro/kernels/tdvmm/tdvmm.py:440",
            "ssd_scan": "src/repro/kernels/ssd/ssd.py:32",
            "crossing": "src/repro/kernels/crossing/crossing.py:27"}
COUNTER = {"tdvmm_fused": "fused", "tdvmm_matmul_raw": "raw",
           "tdvmm_calibrated": "calibrated", "ssd_scan": "ssd",
           "crossing": "crossing"}
# B1/B2 in the f32-code and int4-pair storages: one entry each
for _kern in ("tdvmm_fused", "tdvmm_matmul_raw", "tdvmm_calibrated"):
    for _codes in ("f32", "int4"):
        SOURCES[f"{_kern}_{_codes}"] = SOURCES[_kern]
        REPLACES[f"{_kern}_{_codes}"] = REPLACES[_kern]
        COUNTER[f"{_kern}_{_codes}"] = f"{COUNTER[_kern]}_{_codes}"
# B1/B2 in the 3xTF32 storage (float32 codes off the integer grid): the
# fused and B2 wrappers launch it on the noisy training steps
for _kern in ("tdvmm_fused", "tdvmm_calibrated"):
    SOURCES[f"{_kern}_f32x3"] = SOURCES[_kern]
    REPLACES[f"{_kern}_f32x3"] = REPLACES[_kern]
    COUNTER[f"{_kern}_f32x3"] = f"{COUNTER[_kern]}_f32x3"
# code ranges: p = 6 codes, moe_mixed's p = 8 x 4-bit weights (f32 codes)
# and 3-bit x 3-bit (int4 pairs)
CODE_LIMITS = {"int8": (63, 63), "f32": (255, 15), "int4": (7, 7)}


SHAPE_KEYS = {"ssd_scan": ("dtype", "b", "l", "h", "p", "g", "s", "q"),
              "crossing": ("case", "quadrants", "b", "k", "n", "iters")}


def entry_name(case: dict) -> str:
    """The kernels-line entry of a B1/B2 case: the wrapper's name, with the
    code storage appended for f32 and int4."""
    codes = case.get("codes", "int8")
    return case["kernel"] + ("" if codes == "int8" else "_" + codes)


def say(tag: str, msg: str) -> None:
    print(f"[{tag}] t={time.perf_counter() - T_START:.0f}s {msg}", flush=True)


PHASE_S: dict[str, float] = {}
_PHASE_T = [T_START]


def phase_done(name: str) -> None:
    """Book the seconds since the previous phase ended to ``name``."""
    now = time.perf_counter()
    PHASE_S[name] = PHASE_S.get(name, 0.0) + now - _PHASE_T[0]
    _PHASE_T[0] = now


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# Phase 1: environment
# ---------------------------------------------------------------------------
def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 2: what the compiler made of B1 and B2
# ---------------------------------------------------------------------------
def _demangle(names: list[str]) -> list[str]:
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout.splitlines()
        return out if len(out) == len(names) else names
    except (OSError, subprocess.SubprocessError):
        return names


def kernel_report(lib, ops: tuple[str, ...]) -> dict[str, dict]:
    """What the compiler made of one built library, by demangled kernel
    name: registers, static shared memory and spills (``-Xptxas -v``, from
    the build's log) and the count of each SASS opcode of ``ops``
    (``cuobjdump -sass``, from the toolkit of the ``nvcc`` that built it).
    Fails if the SASS cannot be read."""
    import re
    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    require(cuobjdump.exists(), f"{cuobjdump} not found: the SASS of "
            f"{lib.name} cannot be read")
    entries: dict[str, dict] = {}
    name = None
    for line in _build.LOGS.get(lib.name, "").splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(_Z\w+)'?", line)
        if m:
            name = m.group(1)
            entries.setdefault(name, {})
            continue
        if name is None:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entries[name]["regs"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            entries[name]["smem"] = int(sm.group(1)) if sm else 0
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            entries[name]["spill"] = int(m.group(1)) + int(m.group(2))
    sass: dict[str, dict[str, int]] = {}
    dump = subprocess.run(
        [str(cuobjdump), "-sass", str(lib.path())],
        capture_output=True, text=True, timeout=300).stdout
    fn = None
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            sass[fn] = dict.fromkeys(ops, 0)
            continue
        if fn is not None:
            for op in ops:
                if re.search(rf"\b{op}\b", line):
                    sass[fn][op] += 1
    require(bool(sass), f"no kernel in the SASS of {lib.path().name}")
    names = sorted(set(entries) | set(sass))
    return {pretty.split("(")[0]: dict(entries.get(mangled, {}),
                                       sass=sass.get(mangled))
            for mangled, pretty in zip(names, _demangle(names))}


def report_line(key: str, pretty: str, info: dict, extra: str = "") -> None:
    ops_ = info["sass"]
    say("ptxas", f"{key} {pretty}: registers={info.get('regs')} "
        f"static_smem={info.get('smem')}{extra} "
        f"spill_bytes={info.get('spill')}"
        + ("" if ops_ is None else " sass " + " ".join(
            f"{op}={n}" for op, n in ops_.items())))


def tdvmm_build_report() -> None:
    """One line per B1/B2 kernel instantiation: registers, static and
    dynamic shared memory and spills, and the tensor-core instructions in
    its SASS.  Fails if a B1/B2 K loop has no IMMA/HMMA or still has
    IDP4A, or if a 3xTF32 instantiation (code storage 3) has no HMMA or
    more FFMA than the bf16 float32 instantiation of the same mode and tile
    (its products must all be on the tensor cores: the only FFMA of these
    kernels are the readout division's, ``--fmad=false`` leaves none
    elsewhere)."""
    import re
    from repro_torch.kernels import _build
    from repro_torch.kernels.tdvmm import tdvmm as tk

    smem = _build.load(tk.LIBRARIES["b1"]).tdvmm_smem_bytes
    ffma = {}           # (kernel, mode and tile, storage) -> FFMA count
    for key, lib in tk.LIBRARIES.items():
        rep = kernel_report(lib, ("IMMA", "HMMA", "IDP4A", "FFMA"))
        require(any(("b1_kernel" in f or "b2_integrate" in f) for f in rep),
                f"{key}: no B1/B2 kernel in the SASS of {lib.path().name}")
        for pretty, info in rep.items():
            dyn = ""
            m = re.search(r"<(\d+), (\d+)(?:, (\d+))?>", pretty)
            if m and "b1_kernel" in pretty:
                dyn = f" dynamic_smem={smem(int(m.group(3)), int(m.group(2)))}"
            elif m and "b2_integrate" in pretty:
                dyn = f" dynamic_smem={smem(int(m.group(2)), int(m.group(1)))}"
            report_line(key, pretty, info, dyn)
            if "b1_kernel" in pretty or "b2_integrate" in pretty:
                ops_ = info["sass"]
                require(ops_ is not None, f"{pretty}: not in the SASS")
                require(ops_["IMMA"] + ops_["HMMA"] > 0 and ops_["IDP4A"] == 0,
                        f"{pretty}: the K loop is not on the tensor cores")
                args = [int(v) for v in m.groups() if v is not None]
                b1 = "b1_kernel" in pretty
                codes = args.pop(1 if b1 else 0)
                if codes in (tk.CODES["f32"], tk.CODES["f32x3"]):
                    ffma[(b1, tuple(args), codes)] = ops_["FFMA"]
    # B1: 3 modes x 2 tiles; B2's integrate: 2 tiles
    x3 = {k: v for k, v in ffma.items() if k[2] == tk.CODES["f32x3"]}
    require(len(x3) == 8, f"{len(x3)} 3xTF32 instantiations in the SASS, "
            "want 8")
    for (b1, args, _), n in x3.items():
        bf16 = ffma.get((b1, args, tk.CODES["f32"]))
        require(bf16 is not None and n <= bf16,
                f"{'b1_kernel' if b1 else 'b2_integrate'}{list(args)}: "
                f"3xTF32 has {n} FFMA, its bf16 twin {bf16}: a K loop off "
                "the tensor cores")


# B3's device kernels, whose products run on the tensor cores (csrc/ssd.cu)
SSD_MMA_KERNELS = ("prep_kernel", "state_kernel", "scan_kernel")
SSD_OPS = ("HMMA", "FFMA", "LDS", "LDGSTS")


def ssd_build_report() -> dict[str, dict]:
    """One line per B3 device kernel, as for B1/B2, with the counts of
    HMMA, FFMA, shared-memory loads and cp.async copies in its SASS.  Fails
    unless every instantiation of the three product kernels has HMMA."""
    from repro_torch.kernels.ssd import ssd

    rep = kernel_report(ssd.LIBRARIES["b3"], SSD_OPS)
    for pretty, info in rep.items():
        report_line("b3", pretty, info)
    for kern in SSD_MMA_KERNELS:
        mine = [info for pretty, info in rep.items() if kern in pretty]
        require(len(mine) == 2, f"B3 {kern}: {len(mine)} instantiations in "
                "the SASS, want float32 and bfloat16")
        require(all(i["sass"] and i["sass"]["HMMA"] > 0 for i in mine),
                f"B3 {kern}: its products are not on the tensor cores")
    return rep


def crossing_build_report() -> dict[str, dict]:
    """One line per B4 device kernel (prep, fused), as for B3.  Fails
    unless the fused kernel's product is on the tensor cores (HMMA)."""
    from repro_torch.kernels.crossing import crossing

    rep = kernel_report(crossing.LIBRARIES["b4"], SSD_OPS)
    for pretty, info in rep.items():
        report_line("b4", pretty, info)
    fused = [info for pretty, info in rep.items() if "fused_kernel" in pretty]
    require(len(fused) == 1, f"B4: {len(fused)} fused kernels in the SASS")
    require(bool(fused[0]["sass"]) and fused[0]["sass"]["HMMA"] > 0,
            "B4 fused_kernel: its product is not on the tensor cores")
    return rep


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def device_profile(fn) -> tuple[float, dict[str, float], int]:
    """(host wall seconds, device microseconds by kernel name, kernels run)
    of one call of ``fn``, from ``torch.profiler``'s CUDA activity; copies
    and fills are in the times but not in the kernel count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # device activity only: host-side op events would cost minutes to parse
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, float] = {}
    kernels = 0
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) \
                + ev.time_range.elapsed_us()
            kernels += not ev.name.startswith(("Memcpy", "Memset"))
    return wall, by_name, kernels


def time_ms(fn, iters: int) -> float:
    """Device milliseconds of one call of ``fn``: CUDA events around
    ``iters`` calls that were all queued while the card slept, so the
    elapsed time is the card's alone, with no host launch gaps in it."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    cycles = 50_000_000
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_ahead = not start.query()
        end.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / iters
        cycles *= 4
    raise SmokeFailure("the timed calls could not be queued ahead of the card")


def kernel_cases() -> list[dict]:
    """Every kernel mode at the serving path's shapes: M = prefill chunk C,
    decode batch B, calibration rows, drift-probe rows; (K, N) of ffn.in
    and ffn.out; one ragged shape.  ``rep`` marks the row a kernel's JSON
    entry reports."""
    cases = []
    for k, n in FFN_SHAPES:
        for m in (CALIB_ROWS, FAULT_ROWS):
            cases.append(dict(kernel="tdvmm_matmul_raw", mode="raw", e=1,
                              ex=1, m=m, k=k, n=n,
                              rep=(m, k, n) == (CALIB_ROWS,) + FFN_SHAPES[0]))
            cases.append(dict(kernel="tdvmm_calibrated", mode="one_slot",
                              e=1, ex=1, m=m, k=k, n=n,
                              rep=(m, k, n) == (CALIB_ROWS,) + FFN_SHAPES[0]))
        for m in (CHUNK, SLOTS):
            cases.append(dict(kernel="tdvmm_fused", mode="no_readout", e=1,
                              ex=1, m=m, k=k, n=n))
            cases.append(dict(kernel="tdvmm_fused", mode="scalar_window",
                              e=1, ex=1, m=m, k=k, n=n,
                              rep=(m, k, n) == (CHUNK,) + FFN_SHAPES[0]))
    k, n = FFN_SHAPES[0]
    cases += [
        dict(kernel="tdvmm_fused", mode="expert_windows", e=3, ex=3,
             m=CHUNK, k=k, n=n),
        dict(kernel="tdvmm_fused", mode="shared_x_window", e=3, ex=1, m=CHUNK,
             k=k, n=n),
        dict(kernel="tdvmm_calibrated", mode="expert_slots", e=3, ex=3,
             m=CHUNK, k=k, n=n),
        dict(kernel="tdvmm_matmul_raw", mode="raw", e=1, ex=1, m=3, k=130,
             n=200),
        dict(kernel="tdvmm_fused", mode="scalar_window", e=1, ex=1, m=3,
             k=130, n=200),
        dict(kernel="tdvmm_calibrated", mode="one_slot", e=1, ex=1, m=3,
             k=130, n=200),
    ]
    # mamba2-1.3b: ssm.in_proj as one ragged launch with per-member
    # windows, ssm.out with a scalar one; prefill rows B*L and decode rows B
    for (k, n), mode in ((SSM_IN, "member_windows"),
                         (SSM_OUT, "scalar_window")):
        for m in (SSM_ROWS, SSM_BATCH):
            cases.append(dict(kernel="tdvmm_fused", mode=mode, e=1, ex=1,
                              m=m, k=k, n=n))
        cases.append(dict(kernel="tdvmm_matmul_raw", mode="raw", e=1, ex=1,
                          m=SSM_ROWS, k=k, n=n))
        cases.append(dict(kernel="tdvmm_calibrated",
                          mode="member_slots" if n == SSM_IN[1] else "one_slot",
                          e=1, ex=1, m=SSM_ROWS, k=k, n=n))
    # zamba2-2.7b: ssm.in_proj as one ragged launch (the dt member 80
    # columns wide in its 128-lane span), hybrid.fuse (K = 2 d_model,
    # concat(x, embed0); ssm.out's shape too) and the shared block's
    # ffn.in and ffn.out; the prefill's rows B*L (calibration capture, B2,
    # serving) and the decode's B
    for (k, n), mode, extra in (
            (HYB_IN, "member_windows",
             dict(widths=HYB_WIDTHS, members=HYB_MEMBERS)),
            (HYB_FUSE, "scalar_window", {}),
            (HYB_FFN_IN, "scalar_window", {}),
            (HYB_FFN_OUT, "scalar_window", {})):
        for m in (HYB_ROWS, HYB_BATCH):
            cases.append(dict(extra, kernel="tdvmm_fused", mode=mode, e=1,
                              ex=1, m=m, k=k, n=n))
        cases.append(dict(extra, kernel="tdvmm_matmul_raw", mode="raw", e=1,
                          ex=1, m=HYB_ROWS, k=k, n=n))
        cases.append(dict(extra, kernel="tdvmm_calibrated",
                          mode="member_slots" if extra else "one_slot",
                          e=1, ex=1, m=HYB_ROWS, k=k, n=n))
    # mixtral-8x7b's expert grid, E = 8 with (E,) windows and one B2 slot
    # per expert, in each storage at the sites that take it: int8 at both
    # (moe_unchained), f32 codes at moe.expert.in and int4 pairs at
    # moe.expert.out (moe_mixed); capture rows and decode rows; then a small
    # case of each new storage with an odd K and ragged tiles
    e = MOE_E
    for codes, shapes in (("int8", (MOE_IN, MOE_OUT)), ("f32", (MOE_IN,)),
                          ("int4", (MOE_OUT,))):
        new = codes != "int8"
        for k, n in shapes:
            big = dict(codes=codes, e=e, ex=e, k=k, n=n)
            cases += [
                dict(big, kernel="tdvmm_matmul_raw", mode="raw",
                     m=MOE_PREFILL_C, rep=new),
                dict(big, kernel="tdvmm_fused", mode="expert_windows",
                     m=MOE_PREFILL_C, rep=new),
                dict(big, kernel="tdvmm_fused", mode="expert_windows",
                     m=MOE_DECODE_C),
                dict(big, kernel="tdvmm_calibrated", mode="expert_slots",
                     m=MOE_PREFILL_C, rep=new)]
        if new:
            small = dict(codes=codes, e=3, ex=3, m=5, k=131, n=70)
            cases += [dict(small, kernel="tdvmm_fused", mode="no_readout"),
                      dict(small, kernel="tdvmm_fused", mode="expert_windows"),
                      dict(small, kernel="tdvmm_calibrated",
                           mode="expert_slots"),
                      dict(small, kernel="tdvmm_fused",
                           mode="shared_x_window", ex=1)]
    # kimi-k2's expert grid, E = 384 (gridDim.z), int8: B1 fused with (E,)
    # windows at the engine steps' 4 capacity rows (prefill chunk and
    # decode), B1 raw and B2 (384 slots) at calibration's 54; its shared
    # expert at the same K x N, E = 1 with a (1,) window: B1 fused at the
    # step's rows (a prefill chunk's 64, 4 decode slots), B1 raw and B2 at
    # calibration's 2048
    for k, n in (KIMI_IN, KIMI_OUT):
        big = dict(e=KIMI_E, ex=KIMI_E, k=k, n=n)
        cases += [dict(big, kernel="tdvmm_fused", mode="expert_windows",
                       m=KIMI_STEP_C),
                  dict(big, kernel="tdvmm_matmul_raw", mode="raw",
                       m=KIMI_CALIB_C),
                  dict(big, kernel="tdvmm_calibrated", mode="expert_slots",
                       m=KIMI_CALIB_C)]
        one = dict(e=1, ex=1, k=k, n=n)
        cases += [dict(one, kernel="tdvmm_fused", mode="expert_windows",
                       m=m) for m in (CHUNK, SLOTS)]
        cases += [dict(one, kernel="tdvmm_matmul_raw", mode="raw",
                       m=KIMI_CALIB_ROWS),
                  dict(one, kernel="tdvmm_calibrated", mode="expert_slots",
                       m=KIMI_CALIB_ROWS)]
    return cases + qat_cases() + tile_edge_cases() + tp_shard_cases()


def tp_shard_cases() -> list[dict]:
    """B1/B2 at the shapes a (data, model) mesh with model 2 gives them
    (``core/layers`` mesh sites): qwen's column-parallel ffn.in (K 1024 x N
    1408: B1 fused with the pinned window at the engine steps' rows, B1 raw
    for its capture and data-calibrated window at calibration's) and
    row-parallel ffn.out (K 1408 x N 1024: B1 raw at every row count, its
    int32 sums reduced over ``model`` before the one epilogue), and kimi's
    expert grid at data 2 (E 192 local experts, each rank's rows from both
    ranks: 2 x the step's capacity rows for B1 fused, 2 x calibration's for
    B1 raw).  B2 at the meshless shapes' shard widths for a one-rank run's
    data-calibrated site."""
    (k_in, n_in), (k_out, n_out) = FFN_SHAPES
    col, row = (k_in, n_in // TP), (k_out // TP, n_out)
    cases = []
    for m in (CHUNK, SLOTS):
        cases.append(dict(kernel="tdvmm_fused", mode="scalar_window", e=1,
                          ex=1, m=m, k=col[0], n=col[1], tp="col"))
        cases.append(dict(kernel="tdvmm_matmul_raw", mode="raw", e=1, ex=1,
                          m=m, k=row[0], n=row[1], tp="row"))
    for k, n, tp in (col + ("col",), row + ("row",)):
        cases.append(dict(kernel="tdvmm_matmul_raw", mode="raw", e=1, ex=1,
                          m=CALIB_ROWS, k=k, n=n, tp=tp))
        cases.append(dict(kernel="tdvmm_calibrated", mode="one_slot", e=1,
                          ex=1, m=CALIB_ROWS, k=k, n=n, tp=tp))
    e = KIMI_E // DP
    for k, n in (KIMI_IN, KIMI_OUT):
        cases += [dict(kernel="tdvmm_fused", mode="expert_windows", e=e,
                       ex=e, m=DP * KIMI_STEP_C, k=k, n=n, tp="ep"),
                  dict(kernel="tdvmm_matmul_raw", mode="raw", e=e, ex=e,
                       m=DP * KIMI_CALIB_C, k=k, n=n, tp="ep")]
    # the production mesh's 16 x 16: 24 local experts, d_ff 2048 / 16 over
    # the model axis (the up banks' columns, the down bank's rows), each
    # expert's rows from all 16 data ranks
    e, f = KIMI_E // KIMI_MESH, KIMI_IN[1] // KIMI_MESH
    for k, n in ((KIMI_IN[0], f), (f, KIMI_OUT[1])):
        cases += [dict(kernel="tdvmm_fused", mode="expert_windows", e=e,
                       ex=e, m=KIMI_MESH * KIMI_STEP_C, k=k, n=n,
                       tp="ep x tp 16x16"),
                  dict(kernel="tdvmm_matmul_raw", mode="raw", e=e, ex=e,
                       m=KIMI_MESH * KIMI_CALIB_C, k=k, n=n,
                       tp="ep x tp 16x16")]
    return cases


def qat_cases() -> list[dict]:
    """B1/B2 in int8 at the training path's shapes: every B2 launch of the
    full-width qwen QAT run (M = B x S = 2048; the q/k/v launch with one
    slot per member, ffn.in, ffn.out, attn.out), B1 fused at the same
    shapes with a fixed window (per member at q/k/v) and without a readout
    at ffn.in (the chained plan), the perceptron's two B2 shapes; and the
    bf16 tile (f32 codes, p = 8) at ffn.in's shape beside the 3xTF32
    storage's rows there."""
    cases = []
    for (k, n), widths in QAT_SHAPES:
        big = dict(e=1, ex=1, m=QAT_ROWS, k=k, n=n, widths=widths)
        cases += [
            dict(big, kernel="tdvmm_calibrated",
                 mode="member_slots" if widths else "one_slot"),
            dict(big, kernel="tdvmm_fused",
                 mode="member_windows" if widths else "scalar_window")]
    ffn_in = dict(e=1, ex=1, m=QAT_ROWS, k=1024, n=2816)
    cases += [dict(ffn_in, kernel="tdvmm_fused", mode="no_readout"),
              dict(ffn_in, codes="f32", kernel="tdvmm_matmul_raw",
                   mode="raw")]
    cases += [dict(kernel="tdvmm_calibrated", mode="one_slot", e=1, ex=1,
                   m=m, k=10, n=10) for m in PERCEPTRON_QAT_ROWS]
    return cases


def tile_edge_cases() -> list[dict]:
    """B1/B2 at the edges of the two CTA tiles (``tdvmm.plan_tile``, the
    lookup's rule on a miss: 16 rows up to M 256, 128 rows above) and of
    the float32 codes' exact
    envelope:

    - M = 1, 16, 17, 129, 256, 257 at qwen's ffn.in shape (int8, scalar
      window);
    - ragged tiles in every storage: odd K 131 and N 70 at 33 rows (the
      16-row tile) and 300 rows (the 128-row tile, shared-x too), int4
      with odd K 1001 at the 128-row tile, and operands at an unaligned
      base (element offset 1, so no 16-byte copies) at both tiles;
    - float32 codes at the largest |acc| the layer accepts without a
      warning: x = +255 and w = +15 everywhere at K 4096 (|acc| =
      15,667,200, moe_mixed's worst case) and K 4386 (16,776,450, 766
      below 2^24), and the same with x's sign alternating by row; B1 raw
      at the 128-row tile, B1 fused and B2 at the 16-row one."""
    k, n = FFN_SHAPES[0]
    cases = [dict(kernel="tdvmm_fused", mode="scalar_window", e=1, ex=1, m=m,
                  k=k, n=n) for m in (1, 16, 17, 129, 256, 257)]
    for codes in ("int8", "f32", "int4"):
        for m in (33, 300):
            rag = dict(codes=codes, e=3, ex=3, m=m, k=131, n=70)
            cases += [dict(rag, kernel="tdvmm_matmul_raw", mode="raw"),
                      dict(rag, kernel="tdvmm_fused", mode="expert_windows"),
                      dict(rag, kernel="tdvmm_calibrated",
                           mode="expert_slots")]
        cases += [dict(codes=codes, e=3, ex=1, m=300, k=131, n=200,
                       kernel="tdvmm_fused", mode="shared_x_window"),
                  *(dict(codes=codes, e=2, ex=2, m=m, k=256, n=128,
                         kernel="tdvmm_fused", mode="expert_windows",
                         unaligned=True) for m in (129, 300))]
    odd4 = dict(codes="int4", e=2, ex=2, m=300, k=1001, n=256)
    cases += [dict(odd4, kernel="tdvmm_matmul_raw", mode="raw"),
              dict(odd4, kernel="tdvmm_calibrated", mode="expert_slots")]
    for k in (4096, 4386):
        for fill in ("max", "alt_rows"):
            edge = dict(codes="f32", e=2, ex=2, k=k, n=192, fill=fill)
            cases += [dict(edge, kernel="tdvmm_matmul_raw", mode="raw",
                           m=300),
                      dict(edge, kernel="tdvmm_fused", mode="expert_windows",
                           m=5),
                      dict(edge, kernel="tdvmm_calibrated",
                           mode="expert_slots", m=129)]
    return cases


def bound(case: dict) -> tuple[float, str]:
    """Least time for the work: each input read once (int4 codes as packed
    pairs, f32 codes as 4 bytes), each output written once, against the
    operations at the int8 tensor-core rate for integer codes (the data
    sheet gives no int4 rate for this card) and the bf16 rate for f32 codes
    (B1/B2 run them as bf16 MMAs, exact for integer codes up to 256)."""
    e, ex, m, k, n = (case[f] for f in ("e", "ex", "m", "k", "n"))
    codes = case.get("codes", "int8")
    kb = (k + 1) // 2 if codes == "int4" else k            # bytes per row
    cb = 4 if codes == "f32" else 1
    nbytes = cb * (ex * m * kb + e * kb * n) + 4 * e * m * n   # codes, out
    if case["mode"] != "raw":
        nbytes += 4 * (ex * m + e * n)                     # scales
    if case["mode"] == "member_windows":
        nbytes += 4 * n
    elif "window" in case["mode"]:
        nbytes += 4 * e
    t_bytes = nbytes / H100_HBM_BYTES_PER_S
    t_ops = 2.0 * e * m * k * n / (H100_BF16_FLOPS_PER_S if codes == "f32"
                                   else H100_INT8_OPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def run_case(case: dict, dev, seed: int) -> dict:
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels.tdvmm import ops, tdvmm as tk

    e, ex, m, k, n = (case[f] for f in ("e", "ex", "m", "k", "n"))
    codes = case.get("codes", "int8")
    lim_x, lim_w = CODE_LIMITS[codes]
    dtype = torch.float32 if codes == "f32" else torch.int8
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randint(-lim_x, lim_x + 1, (ex, m, k), generator=g, device=dev,
                      dtype=dtype)
    w = torch.randint(-lim_w, lim_w + 1, (e, k, n), generator=g, device=dev,
                      dtype=dtype)
    widths = case.get("widths") or (SSM_WIDTHS if n == sum(SSM_WIDTHS)
                                     else None)
    if case.get("members"):
        # each member's columns past its own width are the 128-lane padding,
        # whose weight codes the layer sets to zero
        off = 0
        for n_g, wd in zip(case["members"], widths):
            w[:, :, off + n_g:off + wd] = 0
            off += wd
    if case.get("fill"):
        # every product at +lim_x * lim_w: |acc| = lim_x lim_w K
        x.fill_(lim_x)
        w.fill_(lim_w)
        if case["fill"] == "alt_rows":
            x[:, 1::2] = -lim_x
    xs = torch.rand((ex, m), generator=g, device=dev) + 0.5
    ws = torch.rand((e, n), generator=g, device=dev) + 0.5
    gain = 1.0 / (float(lim_x) * float(lim_w) * 2.0 * k)
    # the operands as B1/B2 take them: int4 codes packed in pairs along K
    xk, wk, i4 = x, w, None
    if codes == "int4":
        xk = quant.pack_int4(x, axis=-1).contiguous()
        wk = quant.pack_int4(w, axis=-2).contiguous()
        i4 = k
    if case.get("unaligned"):
        # the same codes one element past an aligned base: contiguous, but
        # not 16-byte aligned, so the kernels stage them element by element
        xk, wk = (torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:]
                  .view(t.shape).copy_(t) for t in (xk, wk))
    max_code = max(lim_x, lim_w)
    mode = case["mode"]
    window, members = None, None
    if mode == "member_windows":
        z = torch.abs(tk.acc_plain(x, w)[0].to(torch.float32) * float(gain))
        spans = torch.split(z, list(widths), dim=1)
        members = tuple(float(torch.amax(t)) * 0.7 for t in spans)
        window = ops._member_window_cols(members, widths, n, x.device)
    elif "window" in mode:
        z = tk.acc_plain(x, w).to(torch.float32) * float(gain)
        zmax = torch.amax(torch.abs(z), dim=(1, 2)) * 0.7
        window = zmax if mode == "expert_windows" else zmax[0].reshape(())
        del z
    bits = None if mode in ("raw", "no_readout") else 6
    if case["kernel"] == "tdvmm_matmul_raw":
        kern = lambda: tk.tdvmm_matmul_raw(xk, wk, i4, max_code)  # noqa: E731
        plain = lambda: tk.tdvmm_raw_plain(xk, wk, i4)            # noqa: E731
    elif case["kernel"] == "tdvmm_fused":
        kern = lambda: tk.tdvmm_fused(xk, wk, xs, ws, gain, bits,  # noqa: E731
                                      window, i4, max_code)
        plain = lambda: tk.tdvmm_fused_plain(xk, wk, xs, ws, gain,  # noqa: E731
                                             bits, window, i4)
    else:
        slots, nslots = ops._calib_slots(e, n, tk.TILE_N, widths)
        slots = slots.contiguous().to(dev)
        bw = min(tk.TILE_N, n)
        kern = lambda: tk.tdvmm_calibrated(xk, wk, xs, ws, slots,  # noqa: E731
                                           nslots, bw, gain, 6, i4, max_code)
        plain = lambda: tk.tdvmm_calibrated_plain(              # noqa: E731
            xk, wk, xs, ws, slots, nslots, bw, gain, 6, i4)
    yk, yp = kern(), plain()
    torch.cuda.synchronize()
    require(yk.dtype == yp.dtype and yk.shape == yp.shape,
            f"{case}: kernel {yk.dtype}{tuple(yk.shape)} vs plain "
            f"{yp.dtype}{tuple(yp.shape)}")
    require(bool(torch.isfinite(yp.to(torch.float32)).all()),
            f"{case}: non-finite plain output")
    err = float((yk.to(torch.float64) - yp.to(torch.float64)).abs().max())
    require(err == 0.0, f"{case}: kernel differs from plain by {err}")
    del yk, yp

    # the yardstick: per expert torch._int_mm on the unpacked integer codes
    # (it takes M > 16 only: fewer rows are zero-padded to 32 and sliced
    # back), or torch.bmm in float32 for f32 codes; plus the torch epilogue
    library, padded = None, codes != "f32" and m <= 16
    library_tf32 = None
    if codes == "f32" or (k % 8 == 0 and n % 8 == 0):
        if codes == "f32":
            xb = x.expand(e, m, k)

            def lib_acc():
                return torch.bmm(xb, w)

            def lib_acc_tf32():
                # the second yardstick: TF32 tensor cores, exact for integer
                # codes up to 2048 inside the 2^24 envelope; allowed here
                # only, and never called by the port
                torch.backends.cuda.matmul.allow_tf32 = True
                try:
                    return torch.bmm(xb, w)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = False
        else:
            x2 = x
            if padded:
                x2 = torch.cat([x, torch.zeros((ex, 32 - m, k), dtype=x.dtype,
                                               device=dev)], dim=1)

            def lib_acc():
                return torch.stack([torch._int_mm(x2[min(i, ex - 1)], w[i])
                                    for i in range(e)])[:, :m]
        lib_win = None if mode == "member_windows" else window

        def with_epilogue(acc_fn):
            if case["kernel"] == "tdvmm_matmul_raw":
                return acc_fn
            return lambda: ops._epilogue(                         # noqa: E731
                acc_fn(), xs, ws, gain, bits, members, out_window=lib_win,
                group_widths=widths)
        library = with_epilogue(lib_acc)
        if codes == "f32":
            library_tf32 = with_epilogue(lib_acc_tf32)
        for fn in (library, library_tf32):
            if fn is None:
                continue
            ylib, yp = fn(), plain()
            torch.cuda.synchronize()
            require(bool(torch.equal(ylib, yp)),
                    f"{case}: the library yardstick computes another function")
            del ylib, yp
    bound_ms, bound_by = bound(case)
    big = e * m * k * n > 1e11
    # at kimi-k2's 384 experts the per-expert library and the plain
    # version's expert slices launch more kernels than time_ms can queue
    # ahead of the card: they replay as one CUDA graph

    def timed(fn, iters):
        return time_graph_ms(fn, iters) if e > 64 else time_ms(fn, iters)
    row = dict(case, codes=codes, max_abs_err=err,
               ms=time_ms(kern, 3 if big else 20),
               plain_ms=timed(plain, 2 if big else 5), bound_ms=bound_ms,
               bound_by=bound_by,
               library_ms=None if library is None
               else timed(library, 3 if big else 10),
               library_tf32_ms=None if library_tf32 is None
               else timed(library_tf32, 3 if big else 10),
               library_padded=library is not None and padded,
               tile=tk.autotune_blocks(m, k, n, codes).name)
    row.pop("rep", None)
    return row


# The autotune phase's M = 512 shapes of the work list: qwen's ffn.in, and
# its ffn.out, where the committed table's tile is not plan_tile's
AUTOTUNE_WORK = ((512, 1024, 2816, "int8"), (512, 2816, 1024, "int8"))
# the "api" phase's rows: a prefill chunk of the qwen engine (CHUNK)
API_ROWS = 64
PLAN_CALLS = 20_000


def autotune_phase(dev) -> dict:
    """The tile autotuner on the card: (a) the sweep
    (``launch/autotune_tdvmm``: every tile bitwise the others and the plain
    version in B1 raw, B1 fused and B2, then B1 fused timed at each tile)
    over the main path's serving shapes and ``AUTOTUNE_WORK``, its table
    written to a temporary file, never to the committed one; (b) at every
    committed entry of the main path's serving shapes, the table's tile
    bitwise ``plan_tile``'s in the three modes; ``plan_kernel``'s host
    time per call (memoized)."""
    import torch
    from repro_torch.kernels.tdvmm import autotune_table, ops, tdvmm as tk
    from repro_torch.launch import autotune_tdvmm as at

    t0 = time.perf_counter()
    serving = at.serving_shapes()
    rows = at.sweep(serving + list(AUTOTUNE_WORK), 1e13,
                    log=lambda line: say("autotune", line[11:]))
    picks = at.measured_entries(rows)
    require(len(picks) == len(rows), "a shape of the autotune phase was "
            "not timed")
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "autotune_table.py"
        path.write_text(at.render(picks))
        written = {}
        exec(path.read_text(), written)
    require(written["HOPPER_TABLE"] == picks,
            "the rendered table does not read back as the sweep's picks")
    committed = autotune_table.HOPPER_TABLE
    agree = sum(committed.get(key) == tile for key, tile in picks.items())
    differ = []
    for i, key in enumerate(serving):
        require(key in committed, f"{key} is not in the committed table")
        table_tile, planned = tk.autotune_blocks(*key), tk.plan_tile(key[0])
        o = at.operands(*key, dev, 500 + i)
        for kind, (kern, _) in at.calls(o).items():
            require(torch.equal(kern(table_tile), kern(planned)),
                    f"{key} {kind}: the table's tile {table_tile.name} "
                    f"differs from plan_tile's {planned.name}")
        if table_tile != planned:
            differ.append(key)
    t = time.perf_counter()
    for _ in range(PLAN_CALLS):
        ops.plan_kernel("auto", CHUNK, *FFN_SHAPES[0], "int8", dev)
    plan_us = (time.perf_counter() - t) / PLAN_CALLS * 1e6
    ops.reset_autotune_report()
    return dict(rows=rows, agree=agree, checked=len(serving), differ=differ,
                plan_us=plan_us, seconds=time.perf_counter() - t0)


def api_phase(dev) -> dict:
    """``repro_torch.core.TDVMMLinear`` on the card at qwen's ffn.in width
    (FFN_SHAPES[0], bf16, 6-bit int8 codes, bias on and drawn nonzero),
    random weights and API_ROWS rows from seed 0: the forward with the
    window data-calibrated, ``calibrate``, and the forward under the pinned
    config, each launch-counted alone, then each held to a direct
    ``td_matmul`` / ``calibrate_out_scale`` call on the same weights and
    rows: outputs bitwise, the window equal, exactly one B2, one B1 raw
    and one B1 fused launch, nothing else.  Returns the launches, the
    window and the seconds."""
    import torch
    from repro_torch.core import TDVMMLayerConfig, TDVMMLinear, td_matmul
    from repro_torch.core.layers import calibrate_out_scale

    t0 = time.perf_counter()
    k, n = FFN_SHAPES[0]
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    cfg = TDVMMLayerConfig(enabled=True, bits=6, weight_bits=6)
    layer = TDVMMLinear(k, n, cfg, bias=True, dtype=torch.bfloat16,
                        generator=g)
    x = torch.randn((API_ROWS, k), generator=g, device=dev).to(
        torch.bfloat16)
    runs = {}
    with torch.no_grad():
        layer.b.normal_(generator=g)
        for name in ("forward", "calibrate", "pinned"):
            reset_all_launches()
            out = layer.calibrate(x) if name == "calibrate" else layer(x)
            torch.cuda.synchronize()
            runs[name] = (out, launches_now())
            if name == "calibrate":
                layer.cfg = out
        w, b = layer.w.detach(), layer.b.detach()
        want = {"forward": td_matmul(x, w, cfg) + b,
                "pinned": td_matmul(x, w, layer.cfg) + b}
        window = calibrate_out_scale(x, w, cfg)
    for name in ("forward", "pinned"):
        y = runs[name][0]
        require(tuple(y.shape) == (API_ROWS, n) and y.dtype == torch.bfloat16
                and bool(torch.isfinite(y).all()),
                f"api {name}: {tuple(y.shape)} {y.dtype}, finite "
                f"{bool(torch.isfinite(y).all())}")
        require(torch.equal(y, want[name]), f"api {name}: TDVMMLinear "
                f"differs from td_matmul by "
                f"{float((y.float() - want[name].float()).abs().max())}")
    require(runs["calibrate"][0].out_scale == window,
            f"api calibrate: {runs['calibrate'][0].out_scale} != "
            f"calibrate_out_scale's {window}")
    launches = {}
    for name, kind in (("forward", "calibrated"), ("calibrate", "raw"),
                       ("pinned", "fused")):
        got = runs[name][1]
        want_l = dict.fromkeys(got, 0) | {kind: 1}
        require(got == want_l, f"api {name} launches {got} != {want_l}")
        launches[kind] = 1
    return dict(launches=launches, window=window,
                seconds=time.perf_counter() - t0)


def check_tiles_taken(rep, name: str) -> dict:
    """(c): the engine's report names the card's platform and every
    recorded entry is a table hit; each B1/B2 launch since the counts were
    reset took the tile its recorded entry names.  Returns the launches by
    tile."""
    from repro_torch.kernels.tdvmm import tdvmm as tk
    at_rep = rep.autotune
    entries = at_rep["entries"]
    require(at_rep["platform"] == "sm_90a" and entries
            and not at_rep["misses"],
            f"{name}: autotune report platform {at_rep['platform']}, "
            f"{len(entries)} entries, misses {at_rep['misses']}")
    by_tile = dict.fromkeys((t.name for t in tk.TILES), 0)
    for (m, k, n, dtype, tile), count in tk.TILE_LAUNCHES.items():
        key = f"{m}x{k}x{n}:{dtype}"
        require(key in entries and entries[key]["tile"] == tile,
                f"{name}: {count} launches at {key} took tile {tile}, the "
                f"report has {entries.get(key)}")
        by_tile[tile] += count
    require(sum(by_tile.values()) == sum(tk.LAUNCHES.values()),
            f"{name}: launches by tile {by_tile} != {tk.LAUNCHES}")
    return by_tile


# ---------------------------------------------------------------------------
# Phase 3: kernel B3 against ssd_plain
# ---------------------------------------------------------------------------
def ssd_cases() -> list[dict]:
    """mamba2-1.3b's prefill scan at full width (bfloat16, as served, and
    float32), a small grouped case (G = 2 over H = 4) whose length is not a
    multiple of the chunk, and zamba2-2.7b's prefill scan at full width (B
    2, L 4096, H 80 over one group, S 64, bfloat16); then the tiles' edges: a sequence shorter
    than the chunk (Q 13) with P over two 64-column blocks (80) and
    S 64 (zamba2's d_state); bfloat16 P 24 (a partial 16-column tile of
    48-byte rows, still 16-byte copies) with S 40 (a partial 16-column
    step); and two cases marked ``unaligned`` whose x, B and C rows are
    not multiples of 16 bytes (bfloat16 P 20, S 34: 40- and 68-byte rows;
    float32 P 18, S 30: 72 and 120 bytes), so B3 reads them element by
    element and writes y and the states (S not a multiple of 4) element by
    element too.  ``earlier_ms``: the time of the kernel B3 replaced (CUDA
    cores, one CTA per (row, head)) at the same case, as read before on
    one NVIDIA H100 80GB HBM3 at 700 W; not measured in this run."""
    full = dict(kernel="ssd_scan", b=SSM_BATCH, l=SSM_PROMPT, h=64, p=64,
                g=1, s=128, q=128)
    return [dict(full, dtype="bfloat16", rep=True, earlier_ms=1.70288),
            dict(full, dtype="float32", earlier_ms=1.71904),
            dict(full, b=2, l=300, h=4, g=2, dtype="float32",
                 earlier_ms=0.64120),
            dict(full, b=HYB_BATCH, l=HYB_PROMPT, h=80, s=64,
                 dtype="bfloat16"),
            dict(full, b=3, l=13, h=6, p=80, g=3, s=64, dtype="float32"),
            dict(full, b=2, l=40, h=4, p=24, g=1, s=40, q=16,
                 dtype="bfloat16"),
            dict(full, b=2, l=70, h=4, p=20, g=2, s=34, q=32,
                 dtype="bfloat16", unaligned=True),
            dict(full, b=2, l=50, h=6, p=18, g=3, s=30, q=32,
                 dtype="float32", unaligned=True)]


def ssd_bound(case: dict) -> tuple[float, str]:
    """Least time for the scan: x, dt, b, c and a_log read once, y and the
    state written once, against the products the scan needs at the TF32
    tensor-core rate.  Both Q x Q products are causal, so each counts its
    Q (Q + 1) / 2 lower triangle; C.B^T depends on the group, not the head,
    so it counts once per (row, group, chunk): Q (Q + 1) S flops there, and
    Q (Q + 1) P + 4 Q P S per (row, head, chunk) for the weighted x, the
    inter-chunk C.state^T and the state update."""
    b, l, h, p, g, s, q = (case[f] for f in "blhpgsq")
    q = min(q, l)                  # the wrapper's chunk: Q = min(chunk, L)
    elt = 2 if case["dtype"] == "bfloat16" else 4
    nbytes = (2 * b * l * h * p * elt + 4 * b * l * h + 2 * b * l * g * s * elt
              + 4 * h + 4 * b * h * p * s)
    nc = -(-l // q)
    flops = (b * g * nc * q * (q + 1) * s
             + b * h * nc * (q * (q + 1) * p + 4 * q * p * s))
    t_bytes = nbytes / H100_HBM_BYTES_PER_S
    t_ops = flops / H100_TF32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ssd_inputs(case: dict, dev, seed: int):
    """(x, dt, a_log, b, c) of a B3 case, random from ``seed`` on ``dev``."""
    import torch

    b, l, h, p, g, s = (case[f] for f in "blhpgs")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dtype = getattr(torch, case["dtype"])
    x = torch.randn((b, l, h, p), generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((b, l, h), generator=gen, device=dev) - 3.0)
    a_log = torch.log(torch.arange(1, h + 1, dtype=torch.float32, device=dev))
    bb = (torch.randn((b, l, g, s), generator=gen, device=dev) * 0.3).to(dtype)
    cc = (torch.randn((b, l, g, s), generator=gen, device=dev) * 0.3).to(dtype)
    return x, dt, a_log, bb, cc


def run_ssd_case(case: dict, dev, seed: int) -> dict:
    import torch
    from repro_torch.kernels.ssd import ssd

    q, dtype = case["q"], getattr(torch, case["dtype"])
    x, dt, a_log, bb, cc = ssd_inputs(case, dev, seed)
    kern = lambda: ssd.ssd_scan(x, dt, a_log, bb, cc, q)           # noqa: E731
    plain = lambda: ssd.ssd_plain(x, dt, a_log, bb, cc, q)         # noqa: E731
    if case.get("unaligned"):
        elt = x.element_size()
        require(ssd.staging(x, bb, cc) == (0, 0) and case["p"] * elt % 16
                and case["s"] % 4, f"{case}: rows that 16-byte copies can take")
    (yk, sk), (yp, sp) = kern(), plain()
    torch.cuda.synchronize()
    require(yk.dtype == yp.dtype == dtype and yk.shape == yp.shape
            and sk.shape == sp.shape, f"{case}: kernel y {yk.dtype}"
            f"{tuple(yk.shape)} vs plain {yp.dtype}{tuple(yp.shape)}")
    require(bool(torch.isfinite(yp.float()).all() and torch.isfinite(sp).all()),
            f"{case}: non-finite plain output")
    err_y = float((yk.double() - yp.double()).abs().max())
    err_s = float((sk.double() - sp.double()).abs().max())
    rel_y = err_y / float(yp.double().abs().max())
    rel_s = err_s / float(sp.double().abs().max())
    require(rel_y <= SSD_RTOL[case["dtype"]] and rel_s <= SSD_RTOL["state"],
            f"{case}: kernel differs from plain by {rel_y:.3g} (y) and "
            f"{rel_s:.3g} (state) of max|plain|")
    bound_ms, bound_by = ssd_bound(case)
    row = dict(case, mode=case["dtype"], max_abs_err=max(err_y, err_s), rel_err_y=rel_y,
               rel_err_state=rel_s, ms=time_ms(kern, 10),
               plain_ms=time_ms(plain, 3), bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None)
    if case.get("rep"):
        _, by_name, _ = device_profile(kern)
        row["device_us"] = {k.split("(")[0].split("<")[0].split("::")[-1]: v
                            for k, v in by_name.items() if "ssd::" in k}
    for key in ("rep", "earlier_ms", "unaligned"):
        row.pop(key, None)
    return row


def ssd_limits(dev) -> None:
    """A chunk or d_state past what B3 holds (``ssd.MAX_CHUNK``,
    ``ssd.MAX_STATE``) raises on the card, with no launch."""
    import torch
    from repro_torch.kernels.ssd import ssd

    base = dict(kernel="ssd_scan", b=1, h=2, p=64, g=1, dtype="float32")
    for case in (dict(base, l=2 * ssd.MAX_CHUNK, s=64, q=2 * ssd.MAX_CHUNK),
                 dict(base, l=64, s=ssd.MAX_STATE + 16, q=64)):
        x, dt, a_log, bb, cc = ssd_inputs(case, dev, seed=0)
        before = ssd.LAUNCHES["ssd"]
        try:
            ssd.ssd_scan(x, dt, a_log, bb, cc, case["q"])
        except NotImplementedError:
            pass
        else:
            raise SmokeFailure(f"B3 took Q={case['q']}, S={case['s']}")
        torch.cuda.synchronize()
        require(ssd.LAUNCHES["ssd"] == before, f"{case}: counted a launch")
    say("kernel", f"ssd_scan refuses Q > {ssd.MAX_CHUNK} and S > "
        f"{ssd.MAX_STATE} with no launch")


# ---------------------------------------------------------------------------
# Phase 3: kernel B4 against crossing_plain
# ---------------------------------------------------------------------------
def crossing_cases() -> list[dict]:
    """B4's launches on the physics path: the perceptron's four-quadrant
    layer (K 21, N 20) and two-quadrant layer (K 11, N 20) on a batch of
    64, and the array's four-quadrant launch (K 2049, N 2048) on 4096 rows;
    then two built cases that the physics path never gives it: most
    crossings before the row's last onset (the general step, B 256, K 513,
    N 512) and crossings exactly at the last onset (``edge``, on ragged
    tiles: B 100 and N 126 are no multiples of 64 and 128, and N, no
    multiple of 4, takes the currents in 4-byte copies)."""
    return [dict(kernel="crossing", case="physics", quadrants=4,
                 b=CASE_BATCH, n_in=CASE_N, n_out=CASE_N),
            dict(kernel="crossing", case="physics", quadrants=2,
                 b=CASE_BATCH, n_in=CASE_N, n_out=CASE_N),
            dict(kernel="crossing", case="physics", quadrants=4,
                 b=PHYS_BATCH, n_in=PHYS_N, n_out=PHYS_N, rep=True),
            dict(kernel="crossing", case="general", quadrants=None, b=256,
                 k=513, n=512),
            dict(kernel="crossing", case="edge", quadrants=None, b=100,
                 k=129, n=126)]


def crossing_bound(b: int, k: int, n: int, general: int) -> tuple[float, str]:
    """Least time for the solve: onsets and currents read once, the times
    written once, against the operations: the product t_on . I in 3xTF32
    (3 x 2 B K N at the TF32 rate) plus, for the ``general`` (row, column,
    step) triples whose mid lies below the row's last onset, a subtract, a
    max and an FMA (4 flops) per source at the float32 CUDA-core rate.
    The earlier design's basis, 4 flops per (row, column, source, step) at
    67 TFLOP/s, was 24.628 ms at the array's launch."""
    t_bytes = 4.0 * (b * k + k * n + b * n) / H100_HBM_BYTES_PER_S
    t_ops = (3 * 2.0 * b * k * n / H100_TF32_FLOPS_PER_S
             + 4.0 * general * k / H100_F32_FLOPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_graph_ms(fn, iters: int) -> float:
    """Device milliseconds of one call of ``fn``, captured in one CUDA graph
    and replayed ``iters`` times between CUDA events: its hundreds of
    launches replay with no host launch gaps between them.  Such a graph
    holds more launches than the card's queue, so it cannot be queued
    ahead of a sleeping card as in ``time_ms``: the host waits on the full
    queue while the card works, and only the first replay's launch, some
    microseconds, falls inside the events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                    # warm, off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    try:
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(iters):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    finally:
        del graph
        torch.cuda.empty_cache()


def time_long_ms(fn) -> float:
    """Device milliseconds of one call of a function that runs long and
    launches more kernels than the card's queue holds (so ``time_ms`` cannot
    queue it ahead): CUDA events around one call after a warm one; the host's
    launch gaps are inside, negligible against its ms-long kernels."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def crossing_operands(case: dict, dev, seed: int):
    """(t_on, currents, k_charge, T) of a B4 case.  ``physics``: weights and
    inputs U(-1, 1) (inputs U(0, 1) for the two-quadrant layer), programmed
    and encoded by ``core/tdcore``, the bias source as the last row.
    ``general``: onsets U(0, 2), currents U(0.01, 1), charge 0.1 K, T 1.
    ``edge``: every row's onsets a permutation of the same multiples of
    1/64 (one of them 1, one 0), column currents (1 + n mod 4) / 4 constant
    over the sources, and the charge Q(1) of the columns at 1/2: those
    cross exactly at t_max = 1, exact in float32 in any order."""
    import torch
    from repro_torch.core import tdcore
    from repro_torch.launch.perceptron import SPEC

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    if case["case"] == "physics":
        w = torch.rand((case["n_in"], case["n_out"]), generator=gen,
                       device=dev) * 2 - 1
        x = torch.rand((case["b"], case["n_in"]), generator=gen, device=dev)
        operands = (tdcore.four_quadrant_operands(x * 2 - 1, w, SPEC)
                    if case["quadrants"] == 4
                    else tdcore.two_quadrant_operands(x, w, SPEC))
        t_on, i_full = tdcore.with_bias_source(*operands[:3])
        return t_on, i_full, operands[3], SPEC.t_window_s
    b, k, n = case["b"], case["k"], case["n"]
    if case["case"] == "general":
        t_on = torch.rand((b, k), generator=gen, device=dev) * 2
        cur = torch.rand((k, n), generator=gen, device=dev) * 0.99 + 0.01
        return t_on, cur, 0.1 * k, 1.0
    base = torch.randint(0, 65, (k,), generator=gen, device=dev).float() / 64
    base[:2] = torch.tensor([0.0, 1.0], device=dev)
    order = torch.argsort(torch.rand((b, k), generator=gen, device=dev), 1)
    t_on = base[order]
    c = (1 + torch.arange(n, device=dev) % 4).float() / 4
    cur = c.expand(k, n).contiguous()
    return t_on, cur, float(0.5 * (1.0 - base.double()).sum()), 1.0


def run_crossing_case(case: dict, dev, seed: int) -> dict:
    """B4 against crossing_plain within CROSSING_RTOL_T of T, twice with
    bitwise equal results; the steps below the last onset (none on the
    physics path); its time, the plain version's and the bound."""
    import torch
    from repro_torch.kernels.crossing import crossing, ref

    t_on, i_full, k_charge, t_window = crossing_operands(case, dev, seed)
    iters = 24
    b, k = t_on.shape
    n = i_full.shape[1]
    args = (t_on, i_full, k_charge, 0.0, 2.0 * t_window, iters)
    kern = lambda: crossing.crossing_kernel(*args)                # noqa: E731
    plain = lambda: ref.crossing_plain(*args)                     # noqa: E731
    tk, tk2, tp = kern(), kern(), plain()
    torch.cuda.synchronize()
    require(tk.shape == tp.shape == (b, n) and tk.dtype == torch.float32,
            f"{case}: kernel {tk.dtype}{tuple(tk.shape)} vs plain "
            f"{tp.dtype}{tuple(tp.shape)}")
    require(torch.equal(tk, tk2), f"{case}: two calls differ")
    require(bool(torch.isfinite(tp).all()), f"{case}: non-finite plain times")
    err = float((tk.double() - tp.double()).abs().max())
    rel = err / t_window
    require(rel <= CROSSING_RTOL_T,
            f"{case}: kernel differs from plain by {rel:.3g} T")
    general = ref.general_steps(*args)
    if case["case"] == "physics":
        require(general == 0, f"{case}: {general} steps below the last onset")
    if case["case"] == "general":
        require(general > b * n * iters // 2,
                f"{case}: only {general} general steps")
    if case["case"] == "edge":
        at_max = (torch.arange(n, device=dev) % 4) == 1
        require(bool(((tk[:, at_max] - 1.0).abs()
                      <= CROSSING_RTOL_T).all()),
                f"{case}: the crossings at t_max = 1 came out elsewhere")
        # no step: the middle of [t_lo, t_hi], without the product
        none = crossing.crossing_kernel(*args[:5], 0)
        require(torch.equal(none, ref.crossing_plain(*args[:5], 0)),
                f"{case}: iters = 0 differs from the plain version")
    bound_ms, bound_by = crossing_bound(b, k, n, general)
    # the plain version launches ~7 kernels per bisection step: one call
    # fits the card's queue below the array's shape
    big = b * k * n > 1 << 28
    row = dict(case, k=k, n=n, iters=iters, general_steps=general,
               max_abs_err=err, rel_err_t=rel, ms=time_ms(kern, 20),
               plain_ms=time_long_ms(plain) if big else time_ms(plain, 1),
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    row.pop("rep", None)
    return row


# ---------------------------------------------------------------------------
# Phase 4: serving at full width
# ---------------------------------------------------------------------------
def plans():
    from repro_torch.configs import TDVMMPlan, tdvmm_rule
    return {
        "ffn_unchained": TDVMMPlan(rules=(
            tdvmm_rule("ffn.*", enabled=True, backend="auto"),)),
        "ffn_chained": TDVMMPlan(rules=(
            tdvmm_rule("ffn.*", enabled=True, backend="auto"),
            tdvmm_rule("ffn.in", chain=True))),
    }


def make_trace(vocab: int, seed: int = 0):
    """8 ragged requests: prompts of 16-128 tokens, 8-32 new tokens,
    arrival gaps of 0-2 engine steps."""
    import numpy as np
    from repro_torch.runtime.engine import Request
    rng = np.random.default_rng(seed)
    reqs, arrival = [], 0
    for rid in range(8):
        reqs.append(Request(
            rid=rid,
            prompt=tuple(int(t) for t in rng.integers(
                0, vocab, int(rng.integers(16, 129)))),
            max_new_tokens=int(rng.integers(8, 33)),
            arrival_step=arrival))
        arrival += int(rng.integers(0, 3))
    return reqs


def expected_launches(cfg, plan: str, steps: int) -> dict:
    """Exact kernel launches of the main path: every ffn matmul of every
    layer is one TD-VMM launch; the calibration pass captures each
    digital-boundary matmul once (B1 raw) and reads it out data-calibrated
    (B2), and a chained ffn.in has no readout (B1 fused)."""
    from repro_torch.kernels.tdvmm import tdvmm as tk
    n_in = 2 if cfg.act == "silu_glu" else 1
    per_layer = n_in + 1
    readouts = 1 if plan == "ffn_chained" else per_layer
    L = cfg.n_layers
    zero = dict.fromkeys(tk.LAUNCHES, 0)
    return {"calibrate": zero | {"raw": L * readouts,
                                 "calibrated": L * readouts,
                                 "fused": L * (per_layer - readouts)},
            "serve": zero | {"fused": L * per_layer * steps}}


def serve_plan(name: str, plan, dev, params_cache: dict) -> dict:
    """qwen1.5-0.5b under ``plan`` through the paged engine (its page pools
    int8 codes with per-(token, head) scales under
    ``attention.set_kv_cache_int8``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.tdvmm import ops, tdvmm as tk
    from repro_torch.models import attention, model
    from repro_torch.runtime.engine import Engine, EngineConfig, Request
    from repro_torch.runtime.paged_cache import pages_for

    cfg = get_config(ARCH).replace(n_layers=SERVE_LAYERS, tdvmm_plan=plan)
    if "params" not in params_cache:
        params_cache["params"] = model.init_params(0, cfg, device=dev)
    params = params_cache["params"]
    trace = make_trace(cfg.vocab_size)
    max_len = max(len(r.prompt) + r.max_new_tokens for r in trace)
    ecfg = EngineConfig(slots=SLOTS, page_size=PAGE, num_pages=NUM_PAGES,
                        chunk=CHUNK, max_pages_per_slot=pages_for(max_len, PAGE))
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    calib_tokens = torch.randint(0, cfg.vocab_size, CALIB_BATCH, generator=g,
                                 device=dev)

    # ---- the main path: counts at 0, calibrate, serve, read ---------------
    reset_all_launches()
    ops.reset_autotune_report()
    t0 = time.perf_counter()
    calib = model.calibrate(params, {"inputs": calib_tokens}, cfg)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    at_calib = dict(tk.LAUNCHES)
    engine = Engine(cfg, params, ecfg, calib=calib)
    rep = engine.run(trace)
    torch.cuda.synchronize()
    launches = dict(tk.LAUNCHES)
    by_tile = check_tiles_taken(rep, name)
    serve_launches = {k: launches[k] - at_calib[k] for k in launches}
    pool = engine._st.caches["seg0"]
    require((pool.k.dtype == torch.int8) == attention.KV_CACHE_INT8
            and (pool.k_scale is not None) == attention.KV_CACHE_INT8,
            f"{name}: page pool {pool.k.dtype}, scales "
            f"{pool.k_scale is not None}, int8 KV {attention.KV_CACHE_INT8}")

    steps = rep.prefill_steps + rep.decode_steps
    want = expected_launches(cfg, name, steps)
    require(at_calib == want["calibrate"],
            f"{name}: calibration launches {at_calib} != {want['calibrate']}")
    require(serve_launches == want["serve"],
            f"{name}: serving launches {serve_launches} != {want['serve']}")
    require(set(calib.sites()) == ({"ffn.out"} if name == "ffn_chained"
                                   else {"ffn.in", "ffn.out"}),
            f"{name}: calibrated sites {calib.sites()}")
    require(rep.nan_logit_steps == 0, f"{name}: {rep.nan_logit_steps} NaN steps")
    require(rep.step_shapes == 2, f"{name}: {rep.step_shapes} step shapes")
    for req, rec in zip(trace, rep.requests):
        require(rec["finish_reason"] == "max_tokens"
                and len(rec["tokens"]) == req.max_new_tokens,
                f"{name}: request {req.rid} finished {rec['finish_reason']} "
                f"with {len(rec['tokens'])} of {req.max_new_tokens} tokens")
    # each stream equals its request served alone (same engine config)
    for req, rec in zip(trace, rep.requests):
        solo = Engine(cfg, params, ecfg, calib=calib).run(
            [Request(req.rid, req.prompt, req.max_new_tokens, 0)])
        require(solo.requests[0]["tokens"] == rec["tokens"],
                f"{name}: request {req.rid} batched stream differs from solo")
    return dict(plan=name, requests=len(trace), steps=rep.steps,
                prefill_steps=rep.prefill_steps, decode_steps=rep.decode_steps,
                generated_tokens=rep.generated_tokens,
                serve_s=rep.wall_s, calibrate_s=t_cal,
                tokens_per_s=rep.generated_tokens / rep.wall_s,
                fj_per_op=rep.fj_per_op, utilization=rep.utilization,
                launches=launches, launches_calibrate=at_calib,
                engine_args=(cfg, params, ecfg, calib), trace=trace,
                report=rep, by_tile=by_tile,
                autotune_entries=sorted(rep.autotune["entries"]))


def profile_plan(out: dict) -> dict:
    """Where the device time goes: a window of engine steps of the plan's
    trace, profiled after the first prefills (it mixes prefill and
    decode).  Device-busy share = summed kernel time over the window's
    wall time; kernels per step = device kernels run in the window over its
    engine steps."""
    from repro_torch.runtime.engine import Engine

    cfg, params, ecfg, calib = out["engine_args"]
    eng = Engine(cfg, params, ecfg, calib=calib)
    eng.start(out["trace"])
    for _ in range(PROFILE_SKIP):
        eng.tick()
    before = (eng._st.prefill_steps, eng._st.decode_steps)

    def window():
        for _ in range(PROFILE_STEPS):
            eng.tick()
    wall, by_name, kernels = device_profile(window)
    dev_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(
        steps=(eng._st.prefill_steps - before[0],
               eng._st.decode_steps - before[1]),
        kernels_per_step=kernels / PROFILE_STEPS,
        wall_s=wall, device_busy_share=dev_us / 1e6 / wall,
        tdvmm_device_share=sum(v for k, v in by_name.items()
                               if "tdvmm::" in k) / max(dev_us, 1e-9),
        top_kernels=[(k[:70], v / max(dev_us, 1e-9)) for k, v in top])


def ssm_plan():
    from repro_torch.configs import TDVMMPlan, tdvmm_rule
    return TDVMMPlan(rules=(tdvmm_rule("ssm.*", enabled=True,
                                       backend="auto"),))


def ssm_config():
    """mamba2-1.3b at full width, SSM_SERVE_LAYERS layers, under
    ``ssm_plan``."""
    from repro_torch.configs import get_config
    return get_config(SSM_ARCH).replace(n_layers=SSM_SERVE_LAYERS,
                                        tdvmm_plan=ssm_plan())


def ssm_expected_launches(n_layers: int) -> dict:
    """Exact kernel launches of the SSM path: per layer one B3 scan per
    prefill; ssm.in_proj (one ragged launch) and ssm.out at every step, B1
    fused in serving; in calibration each is captured (B1 raw) and read out
    data-calibrated (B2)."""
    L = n_layers
    zero = dict.fromkeys(launches_now(), 0)
    return {"calibrate": zero | {"raw": 2 * L, "calibrated": 2 * L, "ssd": L},
            "serve": zero | {"fused": 2 * L * SSM_GEN, "ssd": L}}


def launches_now() -> dict:
    from repro_torch.kernels.crossing import crossing
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.tdvmm import tdvmm as tk
    return {**tk.LAUNCHES, **ssd.LAUNCHES, **crossing.LAUNCHES}


def reset_all_launches() -> None:
    from repro_torch.kernels.crossing import crossing
    from repro_torch.kernels.ssd import ssd
    from repro_torch.kernels.tdvmm import tdvmm as tk
    tk.reset_launches()
    ssd.reset_launches()
    crossing.reset_launches()


def serve_ssm(dev) -> dict:
    """mamba2-1.3b at full width (``ssm_config``) through the static path:
    calibrate on one 4 x 512 batch, serve another for 32 new tokens, then
    the same batch in reverse order."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model

    cfg = ssm_config()
    params = model.init_params(0, cfg, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    calib_tokens = torch.randint(0, cfg.vocab_size, (SSM_BATCH, SSM_PROMPT),
                                 generator=g, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (SSM_BATCH, SSM_PROMPT),
                            generator=g, device=dev)

    # ---- the main path: counts at 0, calibrate, serve, read ---------------
    reset_all_launches()
    t0 = time.perf_counter()
    calib = model.calibrate(params, {"inputs": calib_tokens}, cfg,
                            max_len=SSM_PROMPT + SSM_GEN)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    at_calib = launches_now()
    out = serve.serve_static(cfg, SSM_BATCH, SSM_PROMPT, SSM_GEN, calib=calib,
                             device=dev, params=params, prompts=prompts)
    launches = launches_now()
    serve_launches = {k: launches[k] - at_calib[k] for k in launches}

    want = ssm_expected_launches(cfg.n_layers)
    require(at_calib == want["calibrate"],
            f"ssm: calibration launches {at_calib} != {want['calibrate']}")
    require(serve_launches == want["serve"],
            f"ssm: serving launches {serve_launches} != {want['serve']}")
    require(calib.sites() == ("ssm.in_proj", "ssm.out"),
            f"ssm: calibrated sites {calib.sites()}")
    require(tuple(calib.windows["ssm.in_proj"].shape) == (5,),
            f"ssm: in_proj window {tuple(calib.windows['ssm.in_proj'].shape)}")
    tokens = out["tokens"]
    require(tuple(tokens.shape) == (SSM_BATCH, SSM_GEN),
            f"ssm: tokens {tuple(tokens.shape)}")
    require(out["nan_steps"] == 0, f"ssm: {out['nan_steps']} NaN steps")
    require(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
            "ssm: a token outside the vocabulary")
    # the same batch in reverse order gives the reversed streams
    rev = serve.serve_static(cfg, SSM_BATCH, SSM_PROMPT, SSM_GEN, calib=calib,
                             device=dev, params=params,
                             prompts=torch.flip(prompts, dims=(0,)))
    require(torch.equal(rev["tokens"], torch.flip(tokens, dims=(0,))),
            "ssm: the reversed batch did not give the reversed streams")
    return dict(plan="ssm_unchained", calibrate_s=t_cal,
                prefill_s=out["prefill_s"], decode_s=out["decode_s"],
                decode_tok_per_s=out["decode_tok_per_s"],
                tokens=tokens[:, :8].tolist(), launches=launches,
                launches_calibrate=at_calib,
                args=(cfg, params, calib, prompts))


# ---------------------------------------------------------------------------
# Phase 4: mixtral-8x7b at full width through the static path
# ---------------------------------------------------------------------------
def moe_plans():
    """moe_unchained: every moe.* site at p = 6 (int8 codes).  moe_mixed:
    moe.expert.in at 8-bit inputs x 4-bit weights (f32 codes; worst |acc|
    255 x 15 x 4096 = 15,667,200 < 2^24, so exact) and moe.expert.out at
    3 x 3 bits (int4 pairs)."""
    from repro_torch.configs import TDVMMPlan, tdvmm_rule
    unchained = TDVMMPlan(rules=(tdvmm_rule("moe.*", enabled=True,
                                            backend="auto"),))
    return {"moe_unchained": unchained,
            "moe_mixed": unchained.with_rules(
                tdvmm_rule("moe.expert.in", bits=8, weight_bits=4),
                tdvmm_rule("moe.expert.out", bits=3, weight_bits=3))}


def moe_config():
    """mixtral-8x7b at its published width, cut to MOE_LAYERS layers, with
    the dropless capacity factor."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(MOE_ARCH)
    return cfg.replace(n_layers=MOE_LAYERS, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_CAPACITY_FACTOR))


def moe_expected_launches(plan: str, n_layers: int) -> dict:
    """Exact kernel launches of the MoE path: per layer gate and up are two
    moe.expert.in launches and down one moe.expert.out launch over the
    (E, C, d) dispatch buffer, at every static step (the prefill and
    MOE_GEN - 1 decode steps) B1 fused; in calibration each is captured
    (B1 raw) and read out data-calibrated (B2, one slot per expert).
    moe_mixed runs them in the f32 (in) and int4 (out) storages."""
    L = n_layers
    codes_in, codes_out = ("", "") if plan == "moe_unchained" \
        else ("_f32", "_int4")
    calib = dict.fromkeys(launches_now(), 0)
    serve = dict(calib)
    for codes, per_layer in ((codes_in, 2), (codes_out, 1)):
        calib["raw" + codes] += per_layer * L
        calib["calibrated" + codes] += per_layer * L
        serve["fused" + codes] += per_layer * L * MOE_GEN
    return {"calibrate": calib, "serve": serve}


def serve_moe(name: str, plan, dev, params_cache: dict) -> dict:
    """mixtral-8x7b under ``plan`` through the static path: calibrate on one
    4 x 512 batch, serve another for 16 new tokens, then the same batch in
    reverse order."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import model

    cfg = moe_config().replace(tdvmm_plan=plan)
    if "params" not in params_cache:
        params_cache["params"] = model.init_params(0, cfg, device=dev)
    params = params_cache["params"]
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    calib_tokens = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT),
                                 generator=g, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT),
                            generator=g, device=dev)

    # ---- the main path: counts at 0, calibrate, serve, read ---------------
    reset_all_launches()
    t0 = time.perf_counter()
    calib = model.calibrate(params, {"inputs": calib_tokens}, cfg,
                            max_len=MOE_PROMPT + MOE_GEN, device=dev)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    at_calib = launches_now()
    out = serve.serve_static(cfg, MOE_BATCH, MOE_PROMPT, MOE_GEN, calib=calib,
                             device=dev, params=params, prompts=prompts)
    launches = launches_now()
    serve_launches = {k: launches[k] - at_calib[k] for k in launches}

    want = moe_expected_launches(name, cfg.n_layers)
    require(at_calib == want["calibrate"],
            f"{name}: calibration launches {at_calib} != {want['calibrate']}")
    require(serve_launches == want["serve"],
            f"{name}: serving launches {serve_launches} != {want['serve']}")
    require(calib.sites() == ("moe.expert.in", "moe.expert.out"),
            f"{name}: calibrated sites {calib.sites()}")
    for site, win in calib.windows.items():
        require(tuple(win.shape) == (MOE_E,)
                and bool(torch.isfinite(win).all() and (win > 0).all()),
                f"{name}: {site} window {win.tolist()}")
    tokens = out["tokens"]
    require(tuple(tokens.shape) == (MOE_BATCH, MOE_GEN),
            f"{name}: tokens {tuple(tokens.shape)}")
    require(out["nan_steps"] == 0, f"{name}: {out['nan_steps']} NaN steps")
    require(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
            f"{name}: a token outside the vocabulary")
    # the same batch in reverse order gives the reversed streams
    rev = serve.serve_static(cfg, MOE_BATCH, MOE_PROMPT, MOE_GEN, calib=calib,
                             device=dev, params=params,
                             prompts=torch.flip(prompts, dims=(0,)))
    require(torch.equal(rev["tokens"], torch.flip(tokens, dims=(0,))),
            f"{name}: the reversed batch did not give the reversed streams")
    return dict(plan=name, calibrate_s=t_cal, prefill_s=out["prefill_s"],
                decode_s=out["decode_s"],
                decode_tok_per_s=out["decode_tok_per_s"],
                tokens=tokens[:, :8].tolist(), launches=launches,
                launches_calibrate=at_calib,
                windows={s: [round(float(v), 6) for v in w]
                         for s, w in calib.windows.items()},
                args=(cfg, params, calib, prompts))


def kimi_config():
    """kimi-k2-1t-a32b at its published width, cut to KIMI_LAYERS layers,
    every moe.* site at p = 6 (int8 codes)."""
    from repro_torch.configs import get_config
    return get_config(KIMI_ARCH).replace(
        n_layers=KIMI_LAYERS, tdvmm_plan=moe_plans()["moe_unchained"])


def tree_bytes(tree) -> int:
    from repro_torch.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def serve_kimi(dev) -> dict:
    """kimi-k2-1t-a32b at full width (one layer) through the paged engine
    under moe.*: random weights from seed 0 on the card, one calibration
    pass over KIMI_CALIB tokens ((384,) windows at moe.expert.*, (1,) at
    moe.shared.*), then make_trace's 8 ragged requests with slots 4, chunk
    64 and page 16.  Exact launches (per MoE layer and step: 2
    moe.expert.in, 1 moe.expert.out, 2 moe.shared.in, 1 moe.shared.out,
    B1 fused; in calibration B1 raw = B2 = 6), 2 step shapes, no NaN, and
    the first and last requests served alone give their batched streams.
    Each bank is programmed a slice of experts at a time
    (``quant.program_weights``): a whole bank's float32 temporaries alone would
    take over 100 GB."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.runtime.engine import Engine, EngineConfig, Request
    from repro_torch.runtime.paged_cache import pages_for

    t_phase = time.perf_counter()
    cfg = kimi_config()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(0, cfg, device=dev)
    torch.cuda.synchronize()
    peak = {"init": torch.cuda.max_memory_allocated()}
    resident = tree_bytes(params)
    layer = tree_bytes(params["blocks"]["seg0"][0])
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    calib_tokens = torch.randint(0, cfg.vocab_size, KIMI_CALIB, generator=g,
                                 device=dev)
    trace = make_trace(cfg.vocab_size)
    max_len = max(len(r.prompt) + r.max_new_tokens for r in trace)
    ecfg = EngineConfig(slots=SLOTS, page_size=PAGE, num_pages=NUM_PAGES,
                        chunk=CHUNK, max_pages_per_slot=pages_for(max_len, PAGE))
    per_step = 6 * cfg.n_layers          # B1 fused per engine step

    # ---- the main path: counts at 0, calibrate, serve, read ---------------
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    t0 = time.perf_counter()
    calib = model.calibrate(params, {"inputs": calib_tokens}, cfg)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    peak["calibrate"] = torch.cuda.max_memory_allocated()
    at_calib = launches_now()
    torch.cuda.reset_peak_memory_stats()
    rep = Engine(cfg, params, ecfg, calib=calib).run(trace)
    torch.cuda.synchronize()
    peak["serve"] = torch.cuda.max_memory_allocated()
    launches = launches_now()
    serve_launches = {k: launches[k] - at_calib[k] for k in launches}

    zero = dict.fromkeys(launches, 0)
    want_cal = zero | {"raw": per_step, "calibrated": per_step}
    require(at_calib == want_cal,
            f"kimi: calibration launches {at_calib} != {want_cal}")
    want = zero | {"fused": per_step * rep.steps}
    require(serve_launches == want,
            f"kimi: serving launches {serve_launches} != {want} "
            f"({rep.steps} steps)")
    shapes = {s: tuple(w.shape) for s, w in calib.windows.items()}
    require(shapes == {"moe.expert.in": (KIMI_E,), "moe.expert.out": (KIMI_E,),
                       "moe.shared.in": (1,), "moe.shared.out": (1,)},
            f"kimi: window shapes {shapes}")
    for site, win in calib.windows.items():
        require(bool(torch.isfinite(win).all() and (win > 0).all()),
                f"kimi: {site} window not finite and positive")
    floor = {s: int((w <= KIMI_FLOOR).sum()) for s, w in calib.windows.items()}
    require(rep.nan_logit_steps == 0, f"kimi: {rep.nan_logit_steps} NaN steps")
    require(rep.step_shapes == 2, f"kimi: {rep.step_shapes} step shapes")
    for req, rec in zip(trace, rep.requests):
        require(rec["finish_reason"] == "max_tokens"
                and len(rec["tokens"]) == req.max_new_tokens,
                f"kimi: request {req.rid} finished {rec['finish_reason']} "
                f"with {len(rec['tokens'])} of {req.max_new_tokens} tokens")
    t0 = time.perf_counter()
    for rid in KIMI_SOLO:
        req = trace[rid]
        solo = Engine(cfg, params, ecfg, calib=calib).run(
            [Request(req.rid, req.prompt, req.max_new_tokens, 0)])
        require(solo.requests[0]["tokens"] == rep.requests[rid]["tokens"],
                f"kimi: request {rid} batched stream differs from solo")
    t_solo = time.perf_counter() - t0
    out = dict(resident=resident, layer=layer,
               full_depth=get_config(KIMI_ARCH).n_layers, peak=peak,
               calibrate_s=t_cal, steps=rep.steps,
               prefill_steps=rep.prefill_steps, decode_steps=rep.decode_steps,
               generated_tokens=rep.generated_tokens, serve_s=rep.wall_s,
               solo_s=t_solo, floor=floor, fj_per_op=rep.fj_per_op,
               launches=launches, launches_calibrate=at_calib,
               tokens=rep.requests[0]["tokens"][:8])
    del params, calib, rep
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


class ShardView:
    """Rank ``r``'s view of a 1 x ``n`` ("data", "model") mesh with no
    process group: what ``meshctx``'s sizes and ranks and
    ``sharding``'s placements read of a mesh.  A collective on it raises
    (there is no group to reduce over)."""

    mesh_dim_names = ("data", "model")

    def __init__(self, n: int, r: int):
        self.n, self.r = n, r

    def size(self, dim: int = -1) -> int:
        return (1, self.n)[dim] if dim >= 0 else self.n

    def get_local_rank(self, axis: str) -> int:
        return self.r if axis == "model" else 0


def mesh_kimi(dev, cfg=None, prompt=KIMI_MESH_PROMPT,
              gen=KIMI_MESH_GEN) -> dict:
    """kimi-k2-1t-a32b's attention at full width (one layer: d_model 7168,
    64 heads and 8 KV heads of 112, random bf16 weights from seed 3) split
    by KV groups over a model axis of KIMI_MESH, the shards run one after
    another (``ShardView``): each rank's config (``meshctx.local_config``:
    4 heads, 1 KV head) and weights (``sharding.shard``: ``wq``'s and
    ``wo``'s 448 columns / rows, ``wk`` / ``wv``'s 112 of KV head r / 2),
    a KIMI_MESH_PROMPT prefill and KIMI_MESH_GEN decode steps on its dense
    cache.  Against the meshless layer in the mesh's order
    (``tp_order(16)``, ``attn.qkv`` in the shards' column slices): at every
    step each shard's attention output before ``wo`` is bitwise that
    layer's 4 heads, and the 16 float32 ``wo`` partials
    (``common.partial_f32``) summed in rank order and rounded once are
    bitwise its output; each shard's cache holds the meshless cache's KV
    head bitwise, in 1/8 of its bytes.  Also the gaps of the mesh-order
    layer to the plain meshless one (column products at K 7168 may take
    another reduction order on the card).  ``cfg``, ``prompt`` and
    ``gen``: another attention config and sizes (a small one on the CPU)."""
    import torch
    from repro_torch.launch import meshctx, sharding
    from repro_torch.models import attention, common

    t0 = time.perf_counter()
    cfg = kimi_config() if cfg is None else cfg
    n, kv = KIMI_MESH, cfg.n_kv_heads
    per = cfg.n_heads // n
    (b, s), steps = prompt, gen
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    params = {"attn": attention.init(g, cfg, bf16, dev)}
    xs = [torch.randn((b, s, cfg.d_model), generator=g, device=dev)
          .to(bf16)]
    xs += [torch.randn((b, 1, cfg.d_model), generator=g, device=dev)
           .to(bf16) for _ in range(steps)]

    def run(p, c, out_fn):
        """Every step's (attention output before wo, layer output) and the
        cache, with ``attention._out`` replaced by ``out_fn``."""
        cache = attention.init_cache(c, b, s + steps, bf16, dev)
        old, seen = attention._out, []

        def out_(params_, out, cfg_, key=None):
            seen.append(out)
            return out_fn(params_, out, cfg_, key)
        attention._out = out_
        try:
            ys = []
            with torch.no_grad():
                y, cache = attention.apply_prefill(p, xs[0], c, cache)
                ys.append(y)
                for x in xs[1:]:
                    y, cache = attention.apply_decode(p, x, c, cache)
                    ys.append(y)
        finally:
            attention._out = old
        return list(zip(seen, ys)), cache

    plain, _ = run(params["attn"], cfg, attention._out)
    with tp_order(n, col_parts=(n, kv, kv)):
        ctrl, ctrl_cache = run(params["attn"], cfg, attention._out)
    ctrl_bytes = ctrl_cache.k.nbytes + ctrl_cache.v.nbytes
    sums, t_shards = None, []
    for r in range(n):
        view = ShardView(n, r)
        ts = time.perf_counter()
        with meshctx.use_mesh_of(view):
            local = meshctx.local_config(cfg)
            require(local.attn_split == "groups" and local.n_heads == per
                    and local.n_kv_heads == 1,
                    f"mesh kimi: rank {r}'s config {local.attn_split} "
                    f"{local.n_heads} x {local.n_kv_heads}")
            specs = sharding.param_specs(params, cfg, view, dp_axes=())
            mine = sharding.shard_tree(params, specs, view)["attn"]
            got, cache = run(mine, local, lambda p_, o, c_, k=None:
                             common.partial_f32(
                                 attention._merge_heads(o), p_["wo"]["w"]))
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t_shards.append(time.perf_counter() - ts)
        for i, ((o, part), (co, _)) in enumerate(zip(got, ctrl)):
            require(torch.equal(o, co[:, :, r * per:(r + 1) * per]),
                    f"mesh kimi: rank {r}'s attention output at step {i} "
                    "is not the meshless layer's heads, bitwise")
        h = r * kv // n
        require(torch.equal(cache.k[:, :, 0], ctrl_cache.k[:, :, h])
                and torch.equal(cache.v[:, :, 0], ctrl_cache.v[:, :, h])
                and kv * (cache.k.nbytes + cache.v.nbytes) == ctrl_bytes,
                f"mesh kimi: rank {r}'s cache is not KV head {h}'s in "
                f"1/{kv} of the meshless cache's bytes")
        shard_bytes = cache.k.nbytes + cache.v.nbytes
        del cache
        parts = [part for _, part in got]
        sums = parts if sums is None else [a + p for a, p in
                                           zip(sums, parts)]
    for i, (tot, (_, cy)) in enumerate(zip(sums, ctrl)):
        require(torch.equal(tot.to(bf16), cy),
                f"mesh kimi: the {n} wo partials summed in rank order at "
                f"step {i} are not the layer's output, bitwise")

    def gap(a, b_):
        return float((a.float() - b_.float()).abs().max()
                     / b_.float().abs().max().clamp_min(1e-30))
    return {"cache_bytes": ctrl_bytes, "shard_cache_bytes": shard_bytes,
            "steps": len(ctrl), "shard_s": sum(t_shards),
            "gap_out": max(gap(co, po) for (co, _), (po, _) in
                           zip(ctrl, plain)),
            "gap_layer": max(gap(cy, py) for (_, cy), (_, py) in
                             zip(ctrl, plain)),
            "seconds": time.perf_counter() - t0}


def train_mamba2(dev, workdir: Path) -> dict:
    """mamba2-1.3b at full width, SSM_TRAIN_LAYERS of its 48 layers (bf16),
    every ssm.* site a 6-bit QAT site, SSM_TRAIN_STEPS steps of QAT_BATCH x
    QAT_SEQ tokens through ``qat_train``.  The scan runs ``ssd_plain``
    under autograd (no B3 launch)."""
    cfg = ssm_config().replace(n_layers=SSM_TRAIN_LAYERS,
                               remat_policy="minimal")
    return qat_train("mamba2", cfg, QAT_BATCH, QAT_SEQ, SSM_TRAIN_STEPS, dev,
                     workdir)


def qat_expected_launches(cfg, steps: int) -> tuple[int, str]:
    """B2 launches of ``steps`` QAT steps under remat "minimal", derived
    from the resolved plan, and the formula: every enabled site launches
    once per application (a grouped site's members in one launch, a GLU's
    gate and up in two, an expert bank all its experts in one), at its
    layer multiplicity; a block's sites launch again when the backward
    recomputes the block, OUTSIDE_REMAT's do not."""
    from repro_torch.configs import plan as planlib
    table = planlib.resolve_plan(cfg).table
    top_k = cfg.moe.top_k if cfg.moe is not None else 1
    count = {"inside": 0, "outside": 0}
    terms = []
    for site, info in planlib.site_linear_shapes(cfg).items():
        sc = table.get(site)
        if sc is None or not sc.enabled:
            continue
        per_app = (1 if site in planlib.GROUPED_SITES else
                   len(info["matrices"]) // (top_k if site.startswith(
                       "moe.expert") else 1))
        count["outside" if site in OUTSIDE_REMAT else "inside"] += \
            per_app * info["per_token"]
        terms.append(f"{site} {per_app} x {info['per_token']}")
    per_step = 2 * count["inside"] + count["outside"]
    return per_step * steps, (
        f"(2 x {count['inside']} in blocks + {count['outside']} outside) x "
        f"{steps} steps; launches per forward: {', '.join(terms)}")


def qat_train(tag: str, cfg, batch: int, seq: int, steps: int, dev,
              workdir: Path, optimizer=None, lr: float = 1e-3) -> dict:
    """``steps`` steps of ``cfg`` through ``launch/train.train_loop``:
    random weights from seed 0, SyntheticLM seed 0, ``batch`` x ``seq``
    tokens a step, ``optimizer`` (default AdamW) at ``lr`` with 1 warmup
    step (step 0 takes lr 0).  Every logged metric finite, the last loss
    below the first, and exactly ``qat_expected_launches`` B2 launches with
    nothing else launched.  Returns the history, the launches and their
    formula, the seconds and the peak allocated bytes of the phase."""
    import torch
    from repro_torch.configs import OptimizerConfig, RunConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import train

    opt = dataclasses.replace(optimizer or OptimizerConfig(), lr=lr,
                              warmup_steps=1, total_steps=steps)
    run = RunConfig(model=cfg, shape=ShapeConfig(
        tag, seq, batch, "train", microbatch_per_shard=batch), seed=0,
        optimizer=opt, checkpoint_dir=str(workdir / tag),
        checkpoint_every=10 * steps)
    n_want, formula = qat_expected_launches(cfg, steps)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    out = train.train_loop(run, steps, log_every=1, device=dev)
    torch.cuda.synchronize()
    launches = launches_now()
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    require(len(hist) == steps, f"{tag}: {len(hist)} logged steps")
    for h in hist:
        require(all(math.isfinite(v) for v in h.values()),
                f"{tag} step {h['step']}: {h}")
    require(hist[-1]["loss"] < hist[0]["loss"],
            f"{tag}: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    want = dict.fromkeys(launches, 0) | {"calibrated": n_want}
    require(launches == want, f"{tag} launches {launches} != {want}")
    del out["state"]
    torch.cuda.empty_cache()
    return dict(cfg=cfg, hist=hist, total_s=out["total_s"],
                launches=launches, formula=formula, peak=peak,
                opt=opt)


def flash_train_control(dev) -> dict:
    """Flash against the dense softmax in training at full width:
    qwen1.5-0.5b in float32 with TD-VMM off (a code that rounds to the next
    level between the two attentions would make the comparison
    meaningless), random weights from seed 0, one LONG_BATCH x LONG_SEQ
    batch of SyntheticLM: ``model.loss_fn`` and its gradients through flash
    (S past FLASH_THRESHOLD), then with the threshold raised to S for that
    call only (the dense softmax).  The loss within LONG_LOSS_RTOL
    relative, each gradient leaf within FLASH_TOL of its max|g|."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, make_pipeline
    from repro_torch.models import attention, model
    from repro_torch.tree import leaves_with_paths

    cfg = get_config(ARCH).replace(dtype="float32", remat_policy="minimal")
    require(not cfg.tdvmm.enabled and cfg.tdvmm_plan is None,
            "flash control: TD-VMM must be off")
    params = model.init_params(0, cfg, device=dev)
    named = leaves_with_paths(params)
    for _, p in named:
        p.requires_grad_(True)
    batch = make_pipeline(cfg, ShapeConfig("long", LONG_SEQ, LONG_BATCH,
                                           "train"),
                          DataConfig(seed=0)).batch_at(0)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    old = attention.FLASH_THRESHOLD
    runs = {}
    try:
        for name, threshold in (("flash", old), ("dense", LONG_SEQ)):
            attention.FLASH_THRESHOLD = threshold
            t0 = time.perf_counter()
            total, metrics = model.loss_fn(params, batch, cfg)
            grads = torch.autograd.grad(total, [p for _, p in named])
            torch.cuda.synchronize()
            runs[name] = (float(metrics["loss"].detach()), grads,
                          time.perf_counter() - t0)
    finally:
        attention.FLASH_THRESHOLD = old
    (lf, gf, sf), (ld, gd, sd) = runs["flash"], runs["dense"]
    loss_gap = abs(lf - ld) / abs(ld)
    require(math.isfinite(lf) and loss_gap <= LONG_LOSS_RTOL,
            f"flash control: loss {lf} against the dense {ld} "
            f"({loss_gap:.3g} relative)")
    worst, worst_leaf = 0.0, None
    for (name, _), a, b in zip(named, gf, gd):
        scale = float(b.abs().max())
        gap = float((a - b).abs().max())
        rel = gap / scale if scale else gap
        require(bool(torch.isfinite(a).all()) and rel <= FLASH_TOL,
                f"flash control: gradient {name} {rel:.3g} of max|g| from "
                "the dense softmax's")
        if rel >= worst:
            worst, worst_leaf = rel, name
    del runs, gf, gd, params
    torch.cuda.empty_cache()
    return dict(loss=(lf, ld), loss_gap=loss_gap, grad_gap=worst,
                grad_leaf=worst_leaf, seconds=(sf, sd))


def train_long(dev, workdir: Path) -> dict:
    """qwen1.5-0.5b at full width and depth, every linear a 6-bit QAT
    site, LONG_STEPS steps of one LONG_SEQ-token sequence (past
    FLASH_THRESHOLD: every layer's training attention is flash under
    autograd, ``_attend_flash`` or ``_attend_flash_blocks`` as
    FLASH_BLOCK_SKIP picks), then ``flash_train_control``."""
    from repro_torch.models import attention
    require(LONG_SEQ > attention.FLASH_THRESHOLD,
            f"train long: {LONG_SEQ} tokens do not pass the flash threshold")
    res = qat_train("long", qat_config(), LONG_BATCH, LONG_SEQ, LONG_STEPS,
                    dev, workdir)
    res["control"] = flash_train_control(dev)
    return res


def train_mixtral(dev, workdir: Path) -> dict:
    """mixtral-8x7b at full width, MIX_TRAIN_LAYERS of its 32 layers, the
    dropless capacity factor, every linear a 6-bit QAT site (moe.expert.in
    and moe.expert.out: B2 on the (8, 2049, K, N) expert grid), the
    optimizer ``launch/dryrun.optimizer_for`` gives it (AdamW) with
    MIX_MOMENTS moments at MIX_TRAIN_LR, MIX_TRAIN_STEPS steps of MOE_BATCH x MOE_PROMPT tokens.  The router's
    auxiliary losses finite and the load-balance loss positive."""
    from repro_torch.core.layers import TDVMMLayerConfig
    from repro_torch.launch import dryrun

    cfg = moe_config().replace(
        n_layers=MIX_TRAIN_LAYERS, remat_policy="minimal",
        tdvmm=TDVMMLayerConfig(enabled=True, bits=6, weight_bits=6))
    params = {n: cfg.replace(n_layers=n).param_count()
              for n in (MIX_TRAIN_LAYERS, 2 * MIX_TRAIN_LAYERS)}
    say("train", "mixtral reckoning, before activations and one expert "
        "bank's QAT programming temporaries: a bf16 weight 2 B, its float32 "
        "gradient and clipped copy 8 B, AdamW's two moments 8 B in float32 "
        "or 4 B in bfloat16: " + "; ".join(
            f"{n} layers {p / 1e9:.2f} G parameters, " + ", ".join(
                f"{p * b / 1e9:.1f} GB with {m} moments"
                for m, b in TRAIN_BYTES_PER_PARAM.items())
            for n, p in params.items()) + f"; {MIX_MOMENTS} moments taken")
    opt = dataclasses.replace(dryrun.optimizer_for(cfg),
                              moment_dtype=MIX_MOMENTS)
    res = qat_train("mixtral", cfg, MOE_BATCH, MOE_PROMPT, MIX_TRAIN_STEPS,
                    dev, workdir, optimizer=opt, lr=MIX_TRAIN_LR)
    for h in res["hist"]:
        require(h["lb_loss"] > 0, f"mixtral qat step {h['step']}: "
                f"load-balance loss {h['lb_loss']}")
    res["params"] = params
    return res


def train_zamba2(dev, workdir: Path) -> dict:
    """zamba2-2.7b at full width and depth under ``hybrid_plan`` as 6-bit
    QAT sites, HYB_TRAIN_STEPS steps of one HYB_TRAIN_SEQ-token sequence:
    the shared block's attention trains through flash, the scan runs
    ``ssd_plain`` under autograd (B3 has no backward: no B3 launch)."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention
    require(HYB_TRAIN_SEQ > attention.FLASH_THRESHOLD,
            f"train zamba2: {HYB_TRAIN_SEQ} tokens do not pass the flash "
            "threshold")
    cfg = get_config(HYB_ARCH).replace(remat_policy="minimal",
                                       tdvmm_plan=hybrid_plan())
    res = qat_train("zamba2", cfg, HYB_TRAIN_BATCH, HYB_TRAIN_SEQ,
                    HYB_TRAIN_STEPS, dev, workdir)
    res["params"] = cfg.param_count()
    return res


def say_train(tag: str, res: dict, what: str) -> None:
    """One line of a ``qat_train`` phase: its losses, gradient norms,
    seconds a step, peak memory and launches."""
    hist = res["hist"]
    say("train", f"{tag}: {what}; loss "
        + " ".join(f"{h['loss']:.4f}" for h in hist)
        + "; gnorm " + " ".join(f"{h['grad_norm']:.3f}" for h in hist)
        + "; step s " + " ".join(f"{h['dt']:.3f}" for h in hist)
        + f"; {res['total_s']:.1f} s with the checkpoint; peak allocated "
        f"{res['peak'] / 1e9:.2f} GB; B2 launches "
        f"{res['launches']['calibrated']} = {res['formula']}")


def train_new_paths(dev, served: list) -> None:
    """The phases "train long", "train mixtral" and "train zamba2", each
    with its checkpoints in a temporary directory of its own; their
    launches join ``served``."""
    import torch
    with tempfile.TemporaryDirectory() as workdir:
        tl = train_long(dev, Path(workdir))
    served.append({"launches": tl["launches"]})
    c, ctl = tl["cfg"], tl["control"]
    say_train("train long", tl, f"{ARCH} full width and depth "
              f"({c.n_layers} layers, {c.dtype}), every linear 6-bit "
              f"TD-VMM, {LONG_BATCH} x {LONG_SEQ} tokens a step (flash in "
              "every layer's training attention), AdamW, remat minimal")
    say("train", f"train long control: float32, TD-VMM off, one {LONG_BATCH}"
        f" x {LONG_SEQ} batch: loss through flash {ctl['loss'][0]:.7f}, "
        f"dense {ctl['loss'][1]:.7f} ({ctl['loss_gap']:.3g} relative, gate "
        f"{LONG_LOSS_RTOL}); gradients within {ctl['grad_gap']:.3g} of each "
        f"leaf's max|g| (worst {ctl['grad_leaf']}; gate {FLASH_TOL}); loss + "
        f"gradients {ctl['seconds'][0]:.2f} s flash, {ctl['seconds'][1]:.2f}"
        " s dense")
    del tl
    phase_done("train long")

    with tempfile.TemporaryDirectory() as workdir:
        tx = train_mixtral(dev, Path(workdir))
    served.append({"launches": tx["launches"]})
    say_train("train mixtral", tx, f"{MOE_ARCH} full width, "
              f"{MIX_TRAIN_LAYERS} of 32 layers ({tx['params'][2] / 1e9:.2f}"
              f" G parameters), capacity factor {MOE_CAPACITY_FACTOR}, "
              f"every linear 6-bit TD-VMM (experts on the (8, C, K, N) "
              f"grid), {MOE_BATCH} x {MOE_PROMPT} tokens a step, "
              f"{tx['opt'].name} with {tx['opt'].moment_dtype} moments at lr "
              f"{tx['opt'].lr:g}, remat minimal; lb_loss "
              + " ".join(f"{h['lb_loss']:.4f}" for h in tx["hist"])
              + ", z_loss " + " ".join(f"{h['z_loss']:.4f}"
                                       for h in tx["hist"]))
    del tx
    phase_done("train mixtral")

    with tempfile.TemporaryDirectory() as workdir:
        tz = train_zamba2(dev, Path(workdir))
    served.append({"launches": tz["launches"]})
    say_train("train zamba2", tz, f"{HYB_ARCH} full width and depth "
              f"({tz['params'] / 1e9:.2f} G parameters, "
              f"{tz['cfg'].n_layers} layers), {', '.join(HYB_SITES)} 6-bit "
              f"TD-VMM, {HYB_TRAIN_BATCH} x {HYB_TRAIN_SEQ} tokens a step "
              "(flash in the shared block), the scan ssd_plain under "
              "autograd, AdamW, remat minimal")
    del tz
    torch.cuda.empty_cache()
    phase_done("train zamba2")


def profile_static(args, steps: int) -> dict:
    """Device time of one full prefill and of ``steps`` decode steps of the
    static path: kernels per step, device-busy share (summed kernel time
    over the window's wall time), the TD-VMM kernels' share and the largest
    kernels."""
    import torch
    from repro_torch.models import model

    cfg, params, calib, prompts = args
    b, s = prompts.shape
    caches = model.init_caches(cfg, b, s + steps + 1, prompts.device)
    state = {}

    def prefill():
        logits, _ = model.prefill_step(params, {"inputs": prompts}, caches,
                                       cfg, calib=calib)
        state["tok"] = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]

    def decode_window():
        for _ in range(steps):
            logits, _ = model.decode_step(params, {"inputs": state["tok"]},
                                          caches, cfg, calib=calib)
            state["tok"] = torch.argmax(logits[:, -1, :cfg.vocab_size],
                                        -1)[:, None]

    rows = {}
    for name, fn, n in (("prefill", prefill, 1),
                        ("decode", decode_window, steps)):
        with torch.no_grad():
            wall, by_name, kernels = device_profile(fn)
        dev_us = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        rows[name] = dict(
            steps=n, wall_s=wall, kernels_per_step=kernels / n,
            device_busy_share=dev_us / 1e6 / wall,
            tdvmm_device_share=sum(v for k, v in by_name.items()
                                   if "tdvmm::" in k) / max(dev_us, 1e-9),
            ssd_device_share=sum(v for k, v in by_name.items()
                                 if "ssd::" in k) / max(dev_us, 1e-9),
            ssd_device_ms=sum(v for k, v in by_name.items()
                              if "ssd::" in k) / 1e3,
            device_ms=dev_us / 1e3,
            top_kernels=[(k[:70], v / max(dev_us, 1e-9)) for k, v in top])
    return rows


# ---------------------------------------------------------------------------
# Phase 3: flash attention on the card
# ---------------------------------------------------------------------------
def flash_on_card(dev) -> dict:
    """Flash attention at zamba2's shared block (B 2, S 4096, 32 heads x 80,
    no grouping), float32 inputs: ``_attend_flash`` and
    ``_attend_flash_blocks`` against the dense ``_attend`` within
    FLASH_TOL, each timed beside the dense softmax; then the three again in
    bfloat16, as served (times only)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import attention

    cfg = get_config(HYB_ARCH)
    b, s, d = HYB_BATCH, HYB_PROMPT, cfg.resolved_head_dim
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    q = torch.randn((b, s, cfg.n_heads, d), generator=g, device=dev) * 0.5
    k = torch.randn((b, s, cfg.n_kv_heads, d), generator=g, device=dev) * 0.5
    v = torch.randn((b, s, cfg.n_kv_heads, d), generator=g, device=dev)
    mask = attention._causal_mask(s, s, 0, cfg.swa_window, dev)
    fns = {"dense": lambda q, k, v: attention._attend(q, k, v, mask, cfg),
           "flash": lambda q, k, v: attention._attend_flash(q, k, v, cfg),
           "flash_blocks": lambda q, k, v: attention._attend_flash_blocks(
               q, k, v, cfg)}
    want = fns["dense"](q, k, v)
    out = {"err": {}, "ms": {}, "ms_bf16": {}}
    for name in ("flash", "flash_blocks"):
        got = fns[name](q, k, v)
        torch.cuda.synchronize()
        diff = (got - want).abs()
        require(bool(torch.isfinite(got).all()
                     and (diff <= FLASH_TOL + FLASH_TOL * want.abs()).all()),
                f"{name}: differs from the dense softmax by up to "
                f"{float(diff.max()):.3g}")
        out["err"][name] = float(diff.max())
        del got, diff
    del want
    # one call per timing: a flash call is ~400 launches (16 tile pairs),
    # and more than the card's launch queue holds would block the host
    # before the timed calls are all queued
    for dtype, key in ((torch.float32, "ms"), (torch.bfloat16, "ms_bf16")):
        args = tuple(t.to(dtype) for t in (q, k, v))
        for name, fn in fns.items():
            out[key][name] = time_ms(lambda: fn(*args), 1)
        del args
        torch.cuda.empty_cache()
    return out


def flash_grad_on_card(dev) -> dict:
    """Flash attention's backward at zamba2's shared block, float32: the
    gradients of q, k and v through ``_self_attend`` (B 2, S 4096, 32 heads
    x 80) and of x and the block's weights through ``attention.apply_train``
    (d_model 2560), with flash (S past FLASH_THRESHOLD) against the dense
    softmax (the threshold raised past S), each within FLASH_TOL
    elementwise; each forward + backward timed on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import attention
    from repro_torch.tree import leaves_with_paths, tree_map

    cfg = get_config(HYB_ARCH)
    b, s, h, d = HYB_BATCH, HYB_PROMPT, cfg.n_heads, cfg.resolved_head_dim
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    qkv = [torch.randn((b, s, n, d), generator=g, device=dev) * 0.5
           for n in (h, cfg.n_kv_heads, cfg.n_kv_heads)]
    ct_heads = torch.randn((b, s, h, d), generator=g, device=dev)
    params = attention.init(g, cfg, torch.float32, dev)
    x = torch.randn((b, s, cfg.d_model), generator=g, device=dev)
    ct = torch.randn((b, s, cfg.d_model), generator=g, device=dev)
    positions = torch.arange(s, dtype=torch.int32, device=dev).expand(b, s)

    def core():
        leaves = [t.clone().requires_grad_() for t in qkv]
        (attention._self_attend(*leaves, cfg) * ct_heads).sum().backward()
        return {n: t.grad for n, t in zip("qkv", leaves)}

    def block():
        p = tree_map(lambda t: t.clone().requires_grad_(), params)
        xx = x.clone().requires_grad_()
        (attention.apply_train(p, xx, cfg, positions) * ct).sum().backward()
        return {"x": xx.grad, **{name: t.grad
                                 for name, t in leaves_with_paths(p)}}

    old = attention.FLASH_THRESHOLD
    grads, ms = {}, {}
    try:
        for name, threshold in (("flash", s - 1), ("dense", s)):
            attention.FLASH_THRESHOLD = threshold
            grads[name] = {**core(), **block()}
            torch.cuda.synchronize()
            # forward + backward launch more kernels than the card's queue
            # holds: CUDA events around one call
            ms[name] = {"core": time_long_ms(core),
                        "block": time_long_ms(block)}
    finally:
        attention.FLASH_THRESHOLD = old
    gap = {}
    for leaf, want in grads["dense"].items():
        got = grads["flash"][leaf]
        diff = (got - want).abs()
        require(bool(torch.isfinite(got).all()
                     and (diff <= FLASH_TOL + FLASH_TOL * want.abs()).all()),
                f"flash gradient {leaf}: differs from the dense softmax's by "
                f"up to {float(diff.max()):.3g}")
        gap[leaf] = (float(diff.max()),
                     float((diff / want.abs().clamp_min(1e-30)).max()),
                     float(want.abs().max()))
    del grads
    torch.cuda.empty_cache()
    return {"gap": gap, "ms": ms}


# ---------------------------------------------------------------------------
# Phase 4: the qwen engine's fault tolerance and drift recalibration
# ---------------------------------------------------------------------------
def step_kinds(engine_args, trace) -> tuple[list, object]:
    """(kinds, report): an unbroken run of ``trace`` tick by tick, with
    (step, "prefill" | "decode", a slot mid-prefill before it) for every
    engine step — the kill points come from it."""
    from repro_torch.runtime.engine import Engine

    cfg, params, ecfg, calib = engine_args
    eng = Engine(cfg, params, ecfg, calib=calib)
    eng.start(trace)
    st, kinds = eng._st, []
    while True:
        k, p0 = st.steps, st.prefill_steps
        mid = any(0 < sl.prefill_done < sl.prompt_len
                  for sl in st.sched.occupied())
        if not eng.tick():
            break
        if st.steps != k:
            kinds.append((k, "prefill" if st.prefill_steps > p0 else
                          "decode", mid))
    return kinds, eng.report()


def same_streams(a, b, what: str) -> None:
    for ra, rb in zip(a.requests, b.requests):
        require(ra["tokens"] == rb["tokens"]
                and ra["finish_reason"] == rb["finish_reason"]
                and ra["finished_step"] == rb["finished_step"],
                f"{what}: request {ra['rid']} differs from the unbroken run")
    require(a.steps == b.steps,
            f"{what}: {a.steps} steps, the unbroken run {b.steps}")


def kill_and_resume(engine_args, trace, base, kills: dict) -> list[dict]:
    """Preempt at each kill point with a snapshot on disk, restore it into
    a fresh Engine and resume: the streams, finish reasons and steps must
    be the unbroken run's."""
    import torch
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.runtime import faultinject as fi
    from repro_torch.runtime.engine import Engine, FaultConfig

    cfg, params, ecfg, calib = engine_args
    save = ckpt.save_engine_snapshot
    saved: list[float] = []

    def timed_save(*args, **kw):
        t0 = time.perf_counter()
        out = save(*args, **kw)
        saved.append(time.perf_counter() - t0)
        return out

    rows = []
    ckpt.save_engine_snapshot = timed_save
    try:
        for where, k in kills.items():
            with tempfile.TemporaryDirectory() as snap_dir:
                victim = Engine(cfg, params, ecfg, calib=calib)
                rep = victim.run(trace, FaultConfig(
                    injector=fi.FaultInjector([fi.PreemptAt(k)]),
                    snapshot_dir=snap_dir, snapshot_keep=1))
                require(rep.preempted and rep.steps == k,
                        f"kill at {k} ({where}): stopped at {rep.steps}")
                mid = [sl for sl in victim._st.sched.occupied()
                       if 0 < sl.prefill_done < sl.prompt_len]
                require(bool(mid) == (where == "mid-prefill"),
                        f"kill at {k} ({where}): {len(mid)} slots "
                        "mid-prefill")
                del victim
                size = (Path(rep.snapshot_path) / "state.pt").stat().st_size
                t0 = time.perf_counter()
                flat, step = ckpt.load_engine_snapshot(snap_dir)
                survivor = Engine(cfg, params, ecfg, calib=calib)
                survivor.restore(flat)
                torch.cuda.synchronize()
                t_restore = time.perf_counter() - t0
                require(step == k, f"snapshot step {step} != {k}")
                del flat
                resumed = survivor.resume()
                same_streams(resumed, base, f"resume at {k} ({where})")
                require(resumed.step_shapes <= 2,
                        f"resume at {k}: {resumed.step_shapes} step shapes")
                rows.append(dict(where=where, step=k, bytes=size,
                                 save_s=saved[-1], restore_s=t_restore))
    finally:
        ckpt.save_engine_snapshot = save
    return rows


def fault_qwen(dev, bf16: dict, int8: dict) -> dict:
    """qwen1.5-0.5b at full width under ``ffn_unchained`` with the params,
    calibration and trace of the serving phase (``bf16`` and ``int8``: its
    outputs with bf16 and int8 page pools).  (a) Killed mid-prefill, at the
    first decode and late in decode, snapshotted to disk, restored into a
    fresh Engine and resumed: the unbroken run's streams, in both pool
    dtypes.  (b) A transient step failure is retried with the streams
    unchanged; a persistent one fails exactly one request, its neighbours'
    streams unchanged and its own a prefix of its unbroken stream.  (c)
    Windows pinned on the FAULT_PROBE probe batch itself; injected drift
    (sigma 0.5, 3 repeats) under a DriftConfig probing that batch every
    FAULT_CHECK_EVERY steps recalibrates in place (the window tensors keep
    their storage, their values move, the step shapes stay 2), with B1 raw
    and B2 launched exactly sites x probes; the same probes without drift
    reproduce the pinned windows bitwise (no clip, every ratio 1)."""
    import torch
    from repro_torch.kernels.tdvmm import tdvmm as tk
    from repro_torch.models import attention, model
    from repro_torch.runtime import faultinject as fi
    from repro_torch.runtime.engine import DriftConfig, Engine, FaultConfig

    engine_args, trace = bf16["engine_args"], bf16["trace"]
    cfg, params, ecfg, calib = engine_args
    kinds, base = step_kinds(engine_args, trace)
    same_streams(base, bf16["report"], "tick-by-tick run")
    decode = [k for k, kind, _ in kinds if kind == "decode"]
    kills = {"mid-prefill": next(k for k, _, mid in kinds if mid),
             "first decode": decode[0], "late decode": decode[-3]}
    out = {"kills": kills, "steps": base.steps}
    out["resume"] = kill_and_resume(engine_args, trace, base, kills)
    attention.set_kv_cache_int8(True)
    try:
        out["resume_int8"] = kill_and_resume(
            int8["engine_args"], trace, int8["report"], kills)
    finally:
        attention.set_kv_cache_int8(False)

    # (b) failures through the retry boundary
    rep = Engine(cfg, params, ecfg, calib=calib).run(trace, FaultConfig(
        injector=fi.FaultInjector([fi.FailStep(
            step=kills["first decode"], kind="any", times=1)]),
        retries=2, backoff_s=0.001))
    require(rep.step_retries == 1 and rep.failed == 0,
            f"transient failure: {rep.step_retries} retries, {rep.failed} "
            "failed")
    same_streams(rep, base, "transient failure")
    rep = Engine(cfg, params, ecfg, calib=calib).run(trace, FaultConfig(
        injector=fi.FaultInjector([fi.FailStep(
            step=kills["late decode"], kind="decode", times=2)]),
        retries=1, backoff_s=0.001))
    failed = [r for r in rep.requests if r["finish_reason"] == "failed"]
    require(len(failed) == 1 and rep.failed == 1 and rep.step_retries == 1,
            f"persistent failure: {len(failed)} failed, {rep.step_retries} "
            "retries")
    by_rid = {r["rid"]: r for r in base.requests}
    for r in rep.requests:
        want = by_rid[r["rid"]]
        require(r["tokens"] == (want["tokens"] if r is not failed[0] else
                                want["tokens"][:len(r["tokens"])]),
                f"persistent failure: request {r['rid']}'s stream changed")
    out["failed_rid"] = failed[0]["rid"]
    out["failed_tokens"] = (len(failed[0]["tokens"]),
                            len(by_rid[failed[0]["rid"]]["tokens"]))

    # (c) drift and online recalibration
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    probe = {"inputs": torch.randint(0, cfg.vocab_size, FAULT_PROBE,
                                     generator=g, device=dev)}
    probe_calib = model.calibrate(params, probe, cfg)
    per_probe = expected_launches(cfg, "ffn_unchained", 0)["calibrate"]
    for name, events in (("drift", [fi.DriftAt(
            step=kills["first decode"], sigma=0.5, repeats=3)]),
                         ("no drift", [])):
        eng = Engine(cfg, params, ecfg, calib=probe_calib)
        ptrs = {site: t.data_ptr() for site, t in eng._windows.items()}
        reset_all_launches()
        rep = eng.run(trace, FaultConfig(
            injector=fi.FaultInjector(events),
            drift=DriftConfig(probe_batch=probe,
                              check_every=FAULT_CHECK_EVERY)))
        torch.cuda.synchronize()
        launches = dict(tk.LAUNCHES)
        probes = rep.drift_checks
        n = len(probes)
        want = expected_launches(cfg, "ffn_unchained",
                                 rep.prefill_steps + rep.decode_steps)
        want = {k: want["serve"][k] + n * per_probe[k] for k in want["serve"]}
        require(launches == want,
                f"{name}: launches {launches} != {want} ({n} probes)")
        require(rep.step_shapes == 2 and rep.nan_logit_steps == 0,
                f"{name}: {rep.step_shapes} step shapes, "
                f"{rep.nan_logit_steps} NaN steps")
        require({s: t.data_ptr() for s, t in eng._windows.items()} == ptrs,
                f"{name}: a window tensor was replaced")
        moved = eng.pinned_calibration().drift_ratios(probe_calib)
        if events:
            require(rep.recalibrations >= 1 and len(rep.drift_events) >= 1,
                    f"drift: {rep.recalibrations} recalibrations")
            require(any(abs(math.log(max(r, 1e-12))) > 1e-6
                        for r in moved.values()),
                    f"drift: the pinned windows did not move {moved}")
            out["drift_events"] = [
                (ev["step"], round(ev["max_clip_rate"], 6),
                 round(ev["max_log_ratio"], 4))
                for ev in rep.drift_events]
        else:
            require(rep.recalibrations == 0 and rep.drift_events == []
                    and all(p["max_clip_rate"] == 0.0
                            and p["max_log_ratio"] == 0.0 for p in probes),
                    f"no drift: {len(rep.drift_events)} drift events, "
                    f"probes {probes}")
            require(all(r == 1.0 for r in moved.values()),
                    f"no drift: the windows moved {moved}")
        out[name] = dict(probes=n, launches=launches,
                         recalibrations=rep.recalibrations,
                         probe_s=[p["seconds"] for p in probes],
                         max_clip=max((p["max_clip_rate"] for p in probes),
                                      default=0.0),
                         max_log_ratio=max((p["max_log_ratio"]
                                            for p in probes), default=0.0),
                         serve_s=rep.wall_s)
    out["launches"] = out["drift"]["launches"]
    return out


def timed_methods(obj, names, acc: list) -> None:
    """Wrap ``obj``'s methods ``names`` (on the instance) so the host
    seconds spent in them add up in ``acc[0]``."""
    for name in names:
        fn = getattr(obj, name)

        def wrapped(*args, _fn=fn, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                acc[0] += time.perf_counter() - t0
        setattr(obj, name, wrapped)


def timeless(events):
    """Trace events without their engine-clock stamps and durations."""
    return [{k: v for k, v in e.items() if k not in ("ts", "dur")}
            for e in events]


def check_trace(tr, rep, what: str) -> dict:
    """The tracer's document validates; every request's span boundaries
    carry the report's steps; each tick slice ends where its tick's counters
    stand and the clock, the sum over every tick, is within the run's wall
    time."""
    from repro_torch.runtime import trace

    doc = tr.chrome_trace()
    counts = trace.validate_chrome_trace(doc)
    spans = {}
    for e in doc["traceEvents"]:
        if e.get("pid") == trace.REQUEST_PID and e["ph"] in "Bi":
            spans.setdefault(e["tid"], []).append((e["name"],
                                                   e["args"]["step"]))
    for r in rep.requests:
        want = ([("queued", r["arrival_step"])]
                + ([("prefill", r["admitted_step"]),
                    ("decode", r["first_token_step"])]
                   if r["finish_reason"] != "rejected" else [])
                + [(f"finish:{r['finish_reason']}", r["finished_step"])])
        require(spans.get(r["rid"]) == want,
                f"{what}: request {r['rid']} spans {spans.get(r['rid'])} != "
                f"the report's {want}")
    slices = [e for e in doc["traceEvents"]
              if e.get("pid") == trace.ENGINE_PID and e["ph"] == "X"]
    ticks = sorted({e["ts"] for e in doc["traceEvents"] if e["ph"] == "C"})
    require(len(ticks) == tr.ticks and ticks[-1] == tr.clock_us
            and all(e["ts"] + e["dur"] in ticks for e in slices)
            and tr.clock_us <= rep.wall_s * 1e6 and tr.dropped == 0,
            f"{what}: tick slices do not add up to the clock "
            f"{tr.clock_us} us (wall {rep.wall_s} s)")
    return dict(doc=doc, counts=counts, slices_us=sum(e["dur"] for e in slices))


def observe_qwen(dev, bf16: dict) -> dict:
    """The engine's SLA policy, telemetry and tracing on qwen1.5-0.5b at full
    width under ``ffn_unchained``, with the params, calibration, trace and
    untraced report of the serving phase (``bf16``).  (a) A run with a
    metrics sink (memory and JSONL emitters, the CLI's default step-latency
    spike rule) and a tracer: the untraced run's streams, 2 step shapes,
    B1 fused exactly sites x steps, a valid trace whose request spans carry
    the report's steps, the JSONL holding every observation and alert;
    host seconds in the sink and tracer, and per tick beside an untraced
    run's.  (b) SlaConfig(aging_steps=4), priorities rid % 3, one request
    given a deadline it cannot meet (from ``min_steps_to_finish``) and one a
    joule budget between its minimum and full energy
    (``request_energy_bounds``): rejections cost nothing, the over-budget
    stream is a prefix of its plain one, every other admitted stream is its
    plain one; the default SlaConfig replays FIFO.  (c) Live clip rates:
    windows pinned at OBSERVE_PIN of the probe's clean and drifted max|z|,
    so every site clips at nonzero rates that the drift changes; the probe
    every OBSERVE_EVERY steps, drift at OBSERVE_DRIFT_AT, each observation
    equal to a direct ``drift_probe`` on the clean or the drifted weights,
    alerts exactly above the limit, no recalibration, B1 raw and B2 sites x
    observations.  (d) Killed mid-decode with a snapshot
    on disk, restored into a fresh engine with a fresh sink and tracer: the
    streams, one trace document and the series of the unbroken run (a).
    (e) The serve CLI with --sla, --metrics-jsonl, --trace-out and
    --report-json, then ``launch/trace_report`` on its trace."""
    import torch
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.core import energy
    from repro_torch.core.calibration import CalibrationState
    from repro_torch.core.nonideal import NonIdealityConfig
    from repro_torch.kernels.tdvmm import tdvmm as tk
    from repro_torch.models import model
    from repro_torch.runtime import faultinject as fi
    from repro_torch.runtime import sla, telemetry as tele, trace
    from repro_torch.runtime.engine import (DriftConfig, Engine, FaultConfig,
                                            Request)

    cfg, params, ecfg, calib = bf16["engine_args"]
    reqs, base = bf16["trace"], bf16["report"]
    per_probe = expected_launches(cfg, "ffn_unchained", 0)["calibrate"]
    out = {"launches": dict.fromkeys(tk.LAUNCHES, 0)}

    def add_launches(got):
        for k, v in got.items():
            out["launches"][k] += v

    def serve_launches(rep, probes=0):
        want = expected_launches(cfg, "ffn_unchained",
                                 rep.prefill_steps + rep.decode_steps)
        return {k: want["serve"][k] + probes * per_probe[k]
                for k in want["serve"]}

    def spike_rule():
        return tele.AlertRule("step_latency_s", kind="spike", k=6.0,
                              abs_floor=0.05)

    # ---- (a) a sink and a tracer -----------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        plain = Engine(cfg, params, ecfg, calib=calib).run(reqs)
        same_streams(plain, base, "untraced rerun")
        mem, jsonl = tele.MemoryEmitter(), Path(tmp) / "metrics.jsonl"
        sink = tele.MetricsSink(rules=[spike_rule()],
                                emitters=[mem, tele.JsonlEmitter(jsonl)])
        tr = trace.Tracer()
        spent = [0.0]
        timed_methods(sink, ("observe",), spent)
        timed_methods(tr, ("note_arrival", "admitted", "mark_chunk",
                           "mark_decode", "mark_idle", "finished",
                           "tick_done"), spent)
        reset_all_launches()
        eng = Engine(cfg, params, ecfg, calib=calib, sink=sink, tracer=tr)
        rep = eng.run(reqs)
        torch.cuda.synchronize()
        launches = dict(tk.LAUNCHES)
        add_launches(launches)
        same_streams(rep, base, "sink and tracer")
        require(rep.step_shapes == 2 and rep.nan_logit_steps == 0,
                f"traced: {rep.step_shapes} step shapes")
        require(launches == serve_launches(rep),
                f"traced: launches {launches} != {serve_launches(rep)}")
        got = check_trace(tr, rep, "traced")
        trace_path = Path(tmp) / "trace.json"
        trace_path.write_text(json.dumps(got["doc"]))
        lines = [json.loads(ln) for ln in jsonl.read_text().splitlines()]
        summ = sink.summary()
        require(sum(ln["t"] == "metric" for ln in lines)
                == summ["observations"] == len(mem.metrics)
                and sum(ln["t"] == "alert" for ln in lines)
                == len(sink.alerts) == rep.alerts,
                f"jsonl: {len(lines)} lines for {summ['observations']} "
                f"observations and {len(sink.alerts)} alerts")
        out["a"] = dict(
            events=len(got["doc"]["traceEvents"]), counts=got["counts"],
            trace_bytes=trace_path.stat().st_size,
            jsonl_bytes=jsonl.stat().st_size, jsonl_lines=len(lines),
            observations=summ["observations"], ticks=tr.ticks,
            alerts=[(a.step, a.value, a.median, a.mad) for a in sink.alerts],
            hook_us_per_tick=spent[0] / tr.ticks * 1e6,
            step_ms=rep.wall_s / rep.steps * 1e3,
            plain_step_ms=plain.wall_s / plain.steps * 1e3,
            clock_s=tr.clock_us / 1e6, slices_s=got["slices_us"] / 1e6,
            wall_s=rep.wall_s)
        for em in sink.emitters:
            em.close()
        unbroken = dict(report=rep, doc=got["doc"], sink=sink)

    # ---- (b) SLA ---------------------------------------------------------
    chunk = ecfg.chunk
    table = energy.serving_energy_model(cfg, ecfg.tile_n)
    late = max(reqs, key=lambda r: sla.min_steps_to_finish(r, chunk))
    capped = max((r for r in reqs if r is not late),
                 key=lambda r: r.max_new_tokens)
    deadline = sla.min_steps_to_finish(late, chunk) - 2
    bounds = energy.request_energy_bounds(table, len(capped.prompt),
                                          capped.max_new_tokens)
    budget = 0.5 * (bounds["min_energy_j"] + bounds["full_energy_j"])
    sla_reqs = [Request(
        rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
        arrival_step=r.arrival_step, priority=r.rid % 3,
        deadline_steps=(deadline if r is late else None),
        joule_budget=(budget if r is capped else None)) for r in reqs]
    reset_all_launches()
    rep = Engine(cfg, params, ecfg, calib=calib,
                 sla=sla.SlaConfig(aging_steps=4)).run(sla_reqs)
    torch.cuda.synchronize()
    launches = dict(tk.LAUNCHES)
    add_launches(launches)
    require(launches == serve_launches(rep),
            f"sla: launches {launches} != {serve_launches(rep)}")
    by_rid = {r["rid"]: r for r in base.requests}
    for r in rep.requests:
        want = by_rid[r["rid"]]
        if r["finish_reason"] == "rejected":
            require(r["tokens"] == [] and r["analog_ops"] == 0.0
                    and r["joules_used"] == 0.0
                    and r["first_token_step"] == -1,
                    f"sla: rejected request {r['rid']} did work")
        elif r["finish_reason"] == "over_budget":
            require(r["tokens"] == want["tokens"][:len(r["tokens"])]
                    and len(r["tokens"]) < len(want["tokens"])
                    and r["joules_used"] > budget,
                    f"sla: over-budget request {r['rid']} is not a prefix")
        else:
            require(r["tokens"] == want["tokens"]
                    and r["finish_reason"] == want["finish_reason"],
                    f"sla: admitted request {r['rid']}'s stream changed")
    reasons = {r["rid"]: r["finish_reason"] for r in rep.requests}
    require(reasons[late.rid] == "rejected"
            and reasons[capped.rid] == "over_budget"
            and rep.rejected >= 1 and rep.over_budget == 1
            and rep.step_shapes == 2,
            f"sla: reasons {reasons}, {rep.rejected} rejected, "
            f"{rep.over_budget} over budget")
    fifo = Engine(cfg, params, ecfg, calib=calib,
                  sla=sla.SlaConfig()).run(reqs)
    same_streams(fifo, base, "default SlaConfig")
    require([r["admitted_step"] for r in fifo.requests]
            == [r["admitted_step"] for r in base.requests],
            "default SlaConfig: admission steps differ from FIFO")
    out["b"] = dict(
        deadline=(late.rid, deadline), budget=(capped.rid, budget, bounds),
        rejected=rep.rejected, over_budget=rep.over_budget,
        deadline_hits=rep.deadline_hits,
        deadline_misses=rep.deadline_misses,
        capped_tokens=(len(rep.requests[reqs.index(capped)]["tokens"]),
                       capped.max_new_tokens),
        admitted=[r["admitted_step"] for r in rep.requests],
        fifo_admitted=[r["admitted_step"] for r in base.requests],
        steps=rep.steps)

    # ---- (c) live clip rates ---------------------------------------------
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    probe = {"inputs": torch.randint(0, cfg.vocab_size, FAULT_PROBE,
                                     generator=g, device=dev)}
    ev = dict(sigma=0.5, seed=0, repeats=3)
    drifted = fi.drift_params(
        params, ev["seed"], fi._model_spec(cfg),
        NonIdealityConfig(dibl=False, weight_noise=True,
                          sigma_tune=ev["sigma"]), repeats=ev["repeats"])
    # Pinned at OBSERVE_PIN of the smaller of the clean and the drifted
    # probe's max|z| per site, so both weights clip at every site: the
    # serving windows clip (almost) nothing, and this drift shrinks a
    # window to a quarter (PR 21), below any fixed fraction of the clean one.
    fresh_clean = model.drift_probe(params, probe, cfg, calib)[0].windows
    fresh_drift = model.drift_probe(drifted, probe, cfg, calib)[0].windows
    pinned = CalibrationState(windows={
        s: OBSERVE_PIN * torch.minimum(fresh_clean[s], fresh_drift[s])
        for s in calib.sites()})
    t0 = time.perf_counter()
    clean = dict(model.drift_probe(params, probe, cfg, pinned)[1])
    probe_s = time.perf_counter() - t0
    after = dict(model.drift_probe(drifted, probe, cfg, pinned)[1])
    del drifted
    require(all(clean[s] > 0.0 and after[s] > 0.0 and clean[s] != after[s]
                for s in calib.sites()),
            f"clip series: the pinned windows must clip both weights at "
            f"every site, differently: clean {clean}, drifted {after}")
    values = list(clean.values()) + list(after.values())
    limit = 0.5 * max(values)
    sink = tele.MetricsSink(rules=[
        tele.AlertRule(f"clip_rate.{s}", kind="threshold", limit=limit)
        for s in calib.sites()])
    eng = Engine(cfg, params, ecfg, calib=pinned, sink=sink)
    seen = []                  # (step, drifted?) of each observation
    observe = eng._observe_clips

    def observe_and_note(dc):
        seen.append((eng._st.steps, eng.params is not params))
        observe(dc)
    eng._observe_clips = observe_and_note
    reset_all_launches()
    rep = eng.run(reqs, FaultConfig(
        injector=fi.FaultInjector([fi.DriftAt(step=OBSERVE_DRIFT_AT, **ev)]),
        drift=DriftConfig(probe_batch=probe, check_every=10**9,
                          observe_every=OBSERVE_EVERY)))
    torch.cuda.synchronize()
    launches = dict(tk.LAUNCHES)
    add_launches(launches)
    n = len(seen)
    require(n >= 2 and any(d for _, d in seen) and not all(d for _, d in seen)
            and launches == serve_launches(rep, probes=n),
            f"clip series: {n} observations {seen}, launches {launches} != "
            f"{serve_launches(rep, probes=n)}")
    series = {name: list(zip(s.steps, s.values))
              for name, s in sink.series.items()
              if name.startswith("clip_rate.")}
    require(set(series) == {f"clip_rate.{s}" for s in calib.sites()},
            f"clip series: series {sorted(series)}")
    for site in calib.sites():
        obs = series[f"clip_rate.{site}"]
        want = [(step, (after if d else clean)[site]) for step, d in seen]
        require(obs == want, f"clip series {site}: {obs} != {want}")
    fired = [(a.metric, a.step, a.value) for a in sink.alerts]
    require(fired == [(f"clip_rate.{s}", step, v) for step, _ in seen
                      for s in sorted(calib.sites())
                      for st2, v in series[f"clip_rate.{s}"]
                      if st2 == step and v > limit],
            f"clip series: alerts {fired} are not the observations above "
            f"{limit}")
    require(rep.recalibrations == 0 and rep.drift_checks == []
            and rep.step_shapes == 2,
            f"clip series: {rep.recalibrations} recalibrations")
    out["c"] = dict(observations=n, seen=seen, clean=clean, after=after,
                    limit=limit, alerts=len(fired), probe_s=probe_s,
                    launches=launches,
                    pinned={s: pinned.windows[s].tolist()
                            for s in calib.sites()},
                    drift_ratio={s: (fresh_drift[s] / fresh_clean[s]).tolist()
                                 for s in calib.sites()})

    # ---- (d) kill and resume with telemetry and trace ---------------------
    kill = next(r["first_token_step"] for r in sorted(
        unbroken["report"].requests, key=lambda r: r["first_token_step"])) + 4
    with tempfile.TemporaryDirectory() as snap_dir:
        victim = Engine(cfg, params, ecfg, calib=calib,
                        sink=tele.MetricsSink(rules=[spike_rule()]),
                        tracer=trace.Tracer())
        reset_all_launches()
        rep = victim.run(reqs, FaultConfig(
            injector=fi.FaultInjector([fi.PreemptAt(kill)]),
            snapshot_dir=snap_dir, snapshot_keep=1))
        require(rep.preempted and rep.steps == kill,
                f"kill at {kill}: stopped at {rep.steps}")
        size = (Path(rep.snapshot_path) / "state.pt").stat().st_size
        del victim
        flat, _ = ckpt.load_engine_snapshot(snap_dir)
        sink, tr = tele.MetricsSink(rules=[spike_rule()]), trace.Tracer()
        survivor = Engine(cfg, params, ecfg, calib=calib, sink=sink,
                          tracer=tr)
        survivor.restore(flat)
        meta_bytes = int(flat["meta"].numel())
        del flat
        resumed = survivor.resume()
        torch.cuda.synchronize()
    add_launches(dict(tk.LAUNCHES))
    same_streams(resumed, unbroken["report"], f"resume at {kill}")
    doc = check_trace(tr, resumed, f"resume at {kill}")["doc"]
    require(timeless(doc["traceEvents"])
            == timeless(unbroken["doc"]["traceEvents"]),
            f"resume at {kill}: the trace differs from the unbroken run's")
    ref = unbroken["sink"]
    require(sink.series.keys() == ref.series.keys()
            and sink.observations == ref.observations,
            f"resume at {kill}: series {sorted(sink.series)}, "
            f"{sink.observations} observations")
    for name, s in sink.series.items():
        r = ref.series[name]
        require(s.count == r.count and list(s.steps) == list(r.steps)
                and (name in CLOCK_SERIES or list(s.values) == list(r.values)),
                f"resume at {kill}: series {name} differs")
    out["d"] = dict(step=kill, bytes=size, meta_bytes=meta_bytes)

    # ---- (e) the serve CLI -------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        files = {k: str(Path(tmp) / f) for k, f in (
            ("m", "metrics.jsonl"), ("t", "trace.json"), ("r", "report.json"),
            ("md", "report.md"))}
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        for argv in (
                ["-m", "repro_torch.launch.serve", "--arch", ARCH,
                 "--tdvmm", "ffn.*", "--calibrate", "--sla",
                 "--clip-observe-every", "4", "--metrics-jsonl", files["m"],
                 "--trace-out", files["t"], "--report-json", files["r"]],
                ["-m", "repro_torch.launch.trace_report", files["t"], "-o",
                 files["md"]]):
            run = subprocess.run([sys.executable, *argv], env=env, cwd=tmp,
                                 capture_output=True, text=True, timeout=400)
            require(run.returncode == 0,
                    f"{argv[1]} exited {run.returncode}: {run.stderr[-2000:]}")
        lines = [json.loads(ln) for ln in
                 Path(files["m"]).read_text().splitlines()]
        trace.validate_chrome_trace(json.loads(Path(files["t"]).read_text()))
        report = json.loads(Path(files["r"]).read_text())
        md = Path(files["md"]).read_text()
        rows = [r for r in report["requests"]
                if f"| {r['rid']} | {r['finish_reason']} "
                   f"| {r['finished_step']} |" in md]
        require(len(rows) == len(report["requests"]) > 0
                and sum(ln["t"] == "metric" for ln in lines)
                == report["telemetry"]["observations"],
                f"cli: {len(rows)} report rows for "
                f"{len(report['requests'])} requests")
        out["e"] = dict(seconds=time.perf_counter() - t0,
                        requests=len(report["requests"]),
                        rejected=report["rejected"],
                        over_budget=report["over_budget"],
                        steps=report["steps"], metric_lines=len(lines),
                        bytes={k: Path(v).stat().st_size
                               for k, v in files.items()})
    return out


# ---------------------------------------------------------------------------
# Phase 4: zamba2-2.7b at full width and depth through the static path
# ---------------------------------------------------------------------------
def hybrid_plan():
    """hybrid_unchained: TD-VMM at ssm.*, ffn.* (the shared block's FFN) and
    hybrid.fuse, p = 6 (int8 codes), every readout digital."""
    from repro_torch.configs import TDVMMPlan, tdvmm_rule
    return TDVMMPlan(rules=tuple(tdvmm_rule(p, enabled=True, backend="auto")
                                 for p in HYB_SITES))


def hybrid_expected_launches(cfg) -> dict:
    """Exact kernel launches of the hybrid path, derived from the resolved
    plan: a step launches every enabled site once per application (a
    grouped site's members in one launch, ffn.in's gate and up in two), at
    its per-token multiplicity (layers, or groups for the shared block);
    B1 fused at every static step (the prefill and HYB_GEN - 1 decode
    steps); in calibration each digital-boundary launch is captured (B1
    raw) and read out data-calibrated (B2).  One B3 scan per layer per
    prefill."""
    from repro_torch.configs import plan as planlib
    table = planlib.resolve_plan(cfg).table
    per_step = readouts = 0
    for site, info in planlib.site_linear_shapes(cfg).items():
        sc = table.get(site)
        if sc is None or not sc.enabled:
            continue
        n = (1 if site in planlib.GROUPED_SITES
             else len(info["matrices"])) * info["per_token"]
        per_step += n
        readouts += n if sc.io_quantize else 0
    zero = dict.fromkeys(launches_now(), 0)
    return {"calibrate": zero | {"raw": readouts, "calibrated": readouts,
                                 "fused": per_step - readouts,
                                 "ssd": cfg.n_layers},
            "serve": zero | {"fused": per_step * HYB_GEN,
                             "ssd": cfg.n_layers}}


def serve_hybrid(dev) -> dict:
    """zamba2-2.7b under ``hybrid_unchained`` through the static path:
    calibrate on one 2 x 4096 batch, serve another for 16 new tokens, then
    the same batch in reverse order; then both again with the int8 KV
    cache, counted as a path of its own."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import attention, model

    cfg = get_config(HYB_ARCH).replace(tdvmm_plan=hybrid_plan())
    params = model.init_params(0, cfg, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    calib_tokens = torch.randint(0, cfg.vocab_size, (HYB_BATCH, HYB_PROMPT),
                                 generator=g, device=dev)
    prompts = torch.randint(0, cfg.vocab_size, (HYB_BATCH, HYB_PROMPT),
                            generator=g, device=dev)
    want = hybrid_expected_launches(cfg)

    # ---- the main path: counts at 0, calibrate, serve, read ---------------
    reset_all_launches()
    t0 = time.perf_counter()
    calib = model.calibrate(params, {"inputs": calib_tokens}, cfg,
                            max_len=HYB_PROMPT + HYB_GEN, device=dev)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    at_calib = launches_now()
    out = serve.serve_static(cfg, HYB_BATCH, HYB_PROMPT, HYB_GEN, calib=calib,
                             device=dev, params=params, prompts=prompts)
    launches = launches_now()
    serve_launches = {k: launches[k] - at_calib[k] for k in launches}
    require(at_calib == want["calibrate"],
            f"zamba2: calibration launches {at_calib} != {want['calibrate']}")
    require(serve_launches == want["serve"],
            f"zamba2: serving launches {serve_launches} != {want['serve']}")
    require(set(calib.sites()) == {"ssm.in_proj", "ssm.out", "ffn.in",
                                   "ffn.out", "hybrid.fuse"},
            f"zamba2: calibrated sites {calib.sites()}")
    require(tuple(calib.windows["ssm.in_proj"].shape) == (5,),
            f"zamba2: in_proj window "
            f"{tuple(calib.windows['ssm.in_proj'].shape)}")
    for site, win in calib.windows.items():
        require(bool(torch.isfinite(win).all() and (win > 0).all()),
                f"zamba2: {site} window {win.tolist()}")

    def check(res, what):
        tokens = res["tokens"]
        require(tuple(tokens.shape) == (HYB_BATCH, HYB_GEN),
                f"zamba2 {what}: tokens {tuple(tokens.shape)}")
        require(res["nan_steps"] == 0,
                f"zamba2 {what}: {res['nan_steps']} NaN steps")
        require(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
                f"zamba2 {what}: a token outside the vocabulary")
        # the same batch in reverse order gives the reversed streams
        rev = serve.serve_static(cfg, HYB_BATCH, HYB_PROMPT, HYB_GEN,
                                 calib=calib, device=dev, params=params,
                                 prompts=torch.flip(prompts, dims=(0,)))
        require(torch.equal(rev["tokens"], torch.flip(tokens, dims=(0,))),
                f"zamba2 {what}: the reversed batch did not give the "
                "reversed streams")

    check(out, "bf16 KV")
    # ---- the int8 KV cache: counts at 0, serve, read ----------------------
    attention.set_kv_cache_int8(True)
    try:
        caches = model.init_caches(cfg, 1, 8, dev)
        require(caches["shared_attn"].k.dtype == torch.int8,
                "zamba2: the int8 switch made no int8 cache")
        del caches
        reset_all_launches()
        out8 = serve.serve_static(cfg, HYB_BATCH, HYB_PROMPT, HYB_GEN,
                                  calib=calib, device=dev, params=params,
                                  prompts=prompts)
        launches8 = launches_now()
        require(launches8 == want["serve"],
                f"zamba2 int8 KV: serving launches {launches8} != "
                f"{want['serve']}")
        check(out8, "int8 KV")
    finally:
        attention.set_kv_cache_int8(False)
    # the int8 cache's own error at full width: the first decode step's
    # logits with either cache after the same prefill (which attends over
    # the full-precision keys in both), with TD-VMM off within
    # INT8_KV_STEP_RTOL of max|logit|; under the plan (6-bit readouts turn
    # the cache's rounding into whole-level steps) reported beside it, with
    # the bf16 logits' top-1 over top-2 margin
    step = {}
    for name, c, cal in (("plan", cfg, calib),
                         ("off", cfg.replace(tdvmm_plan=None), None)):
        for int8 in (False, True):
            attention.set_kv_cache_int8(int8)
            try:
                caches = model.init_caches(c, HYB_BATCH, HYB_PROMPT + 2, dev)
                logits, caches = model.prefill_step(
                    params, {"inputs": prompts}, caches, c, calib=cal)
                tok = torch.argmax(logits[:, -1, :c.vocab_size], -1)[:, None]
                logits, _ = model.decode_step(params, {"inputs": tok},
                                              caches, c, calib=cal)
                step[name, int8] = logits[:, -1, :c.vocab_size].float()
                del caches
            finally:
                attention.set_kv_cache_int8(False)
    rel, margin = {}, {}
    for name in ("plan", "off"):
        ref = step[name, False]
        scale = float(ref.abs().max())
        top2 = torch.topk(ref, 2, dim=-1).values
        rel[name] = float((step[name, True] - ref).abs().max()) / scale
        margin[name] = [float(m) / scale for m in top2[:, 0] - top2[:, 1]]
    require(rel["off"] <= INT8_KV_STEP_RTOL,
            f"zamba2: with TD-VMM off the int8-KV decode step's logits "
            f"differ from the bf16-KV ones by {rel['off']:.3g} of "
            f"max|logit| (gate {INT8_KV_STEP_RTOL})")
    return dict(plan="hybrid_unchained", calibrate_s=t_cal,
                int8_step_rel=rel, bf16_margin_rel=margin,
                prefill_s=out["prefill_s"], decode_s=out["decode_s"],
                decode_tok_per_s=out["decode_tok_per_s"],
                prefill_s_int8=out8["prefill_s"],
                decode_s_int8=out8["decode_s"],
                decode_tok_per_s_int8=out8["decode_tok_per_s"],
                tokens=out["tokens"][:, :8].tolist(),
                tokens_int8=out8["tokens"][:, :8].tolist(),
                int8_differ=int((out8["tokens"] != out["tokens"]).sum()),
                int8_first_differ=[
                    int(r.nonzero()[0]) if bool(r.any()) else None
                    for r in out8["tokens"] != out["tokens"]],
                launches=launches, launches_calibrate=at_calib,
                launches_int8=launches8,
                windows={s: [round(float(v), 6) for v in w.reshape(-1)]
                         for s, w in calib.windows.items()},
                args=(cfg, params, calib, prompts))


# ---------------------------------------------------------------------------
# Phase 4: the paper's circuit on the card (launch/perceptron.py)
# ---------------------------------------------------------------------------
def physics_path(dev) -> dict:
    """The 10 x 10 x 10 perceptron on a batch of 64 (a clean and a DIBL
    forward, 2 B4 launches each), then the 1024 x 1024 array on 4096
    samples (1 launch): decoded outputs within TD_ATOL of the closed form,
    exact launch counts."""
    import torch
    from repro_torch.launch import perceptron

    reset_all_launches()
    case = perceptron.case_study(dev)
    at_case = launches_now()
    arr = perceptron.array(dev, PHYS_N, PHYS_BATCH)
    launches = launches_now()
    want_case = {k: 0 for k in at_case} | {"crossing": 4}
    require(at_case == want_case,
            f"perceptron: launches {at_case} != {want_case}")
    require(launches["crossing"] - at_case["crossing"] == 1,
            f"array: {launches['crossing'] - at_case['crossing']} B4 "
            "launches, not 1")
    for name, out in (("perceptron", case), ("array", arr)):
        require(bool(torch.isfinite(out["y"]).all()),
                f"{name}: non-finite outputs")
    require(tuple(case["y"].shape) == (CASE_BATCH, CASE_N)
            and tuple(arr["y"].shape) == (PHYS_BATCH, PHYS_N),
            f"outputs {tuple(case['y'].shape)}, {tuple(arr['y'].shape)}")
    for what, err in (("perceptron", case["max_err"]),
                      ("perceptron on DIBL weights", case["max_err_dibl"]),
                      ("array", arr["max_err"])):
        require(err <= TD_ATOL,
                f"{what}: {err:.3g} from the closed form (> {TD_ATOL})")
    return dict(case=case, array=arr, launches=launches)


def small_physics_agreement(dev) -> float:
    """The perceptron (batch 64) and a 64 x 64 array (batch 16) from the
    same seed on the card (B4) and on the CPU (crossing_plain): decoded
    outputs within TD_ATOL."""
    from repro_torch.launch import perceptron

    worst = 0.0
    for fn, keys in ((perceptron.case_study, ("y", "y_dibl")),
                     (lambda d: perceptron.array(d, 64, 16), ("y",))):
        cpu, card = fn("cpu"), fn(dev)
        for k in keys:
            worst = max(worst, float((card[k].cpu().double()
                                      - cpu[k].double()).abs().max()))
    require(worst <= TD_ATOL, f"physics card vs cpu: {worst:.3g} > {TD_ATOL}")
    return worst


# ---------------------------------------------------------------------------
# Phase 3: B1/B2's 3xTF32 storage against the plain versions
# ---------------------------------------------------------------------------
def f32x3_cases() -> list[dict]:
    """The 3xTF32 storage at qwen1.5-0.5b's QAT shapes (M = B x S = 2048
    rows; ffn.in 1024 x 2816 and the grouped q/k/v launch 1024 x 3 x 1024
    with per-member windows and slots), raw, fused and B2, on noisy codes
    (p = 6 inputs, p = 6 weights with programming noise) and on integer
    codes of p = 9 and p = 11; the noisy steps' other launches (B2 at
    ffn.out and attn.out, B1 without a readout at the chained ffn.in); then
    noisy codes at the tiles' edges (M 1, 17, 257; K 131; N 70), shared-x
    with (E,) windows and B2 with expert slots at 300 rows.  ``rep`` marks
    the rows of the kernels line."""
    cases = []
    for (k, n), widths in (((1024, 2816), None),
                           ((1024, sum(QKV_WIDTHS)), QKV_WIDTHS)):
        for data in ("noisy", "p9", "p11"):
            base = dict(codes="f32x3", data=data, e=1, ex=1, m=QAT_ROWS, k=k,
                        n=n, widths=widths,
                        rep=widths is None and data == "noisy")
            cases += [
                dict(base, kernel="tdvmm_matmul_raw", mode="raw"),
                dict(base, kernel="tdvmm_fused",
                     mode="member_windows" if widths else "scalar_window"),
                dict(base, kernel="tdvmm_calibrated",
                     mode="member_slots" if widths else "one_slot")]
    noisy = dict(codes="f32x3", data="noisy", e=1, ex=1, m=QAT_ROWS,
                 widths=None)
    cases += [dict(noisy, kernel="tdvmm_calibrated", mode="one_slot", k=k,
                   n=n) for k, n in ((2816, 1024), (1024, 1024))]
    cases.append(dict(noisy, kernel="tdvmm_fused", mode="no_readout", k=1024,
                      n=2816))
    for m in (1, 17, 257):
        edge = dict(codes="f32x3", data="noisy", e=1, ex=1, m=m, k=131, n=70,
                    widths=None)
        cases += [dict(edge, kernel="tdvmm_matmul_raw", mode="raw"),
                  dict(edge, kernel="tdvmm_fused", mode="scalar_window"),
                  dict(edge, kernel="tdvmm_calibrated", mode="one_slot")]
    cases += [dict(codes="f32x3", data="noisy", e=3, ex=1, m=17, k=131, n=70,
                   widths=None, kernel="tdvmm_fused", mode="expert_windows"),
              dict(codes="f32x3", data="noisy", e=3, ex=3, m=300, k=131,
                   n=70, widths=None, kernel="tdvmm_calibrated",
                   mode="expert_slots")]
    return cases


def f32x3_bound(case: dict) -> tuple[float, str]:
    """Float32 codes read once (4 bytes each), the output written once,
    scales and windows; against 3 x 2 M K N at the TF32 tensor-core rate
    (three products per 8-deep block)."""
    e, ex, m, k, n = (case[f] for f in ("e", "ex", "m", "k", "n"))
    nbytes = 4 * (ex * m * k + e * k * n + e * m * n)
    if case["mode"] != "raw":
        nbytes += 4 * (ex * m + e * n)
    t_bytes = nbytes / H100_HBM_BYTES_PER_S
    t_ops = 3 * 2.0 * e * m * k * n / H100_TF32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _slot_windows64(acc64, absacc64, gain, slots, nslots, bw, rtol):
    """The exact per-column window of a B2 launch, (E, 1, N) float64, and
    its relative error bound when read from a float32 accumulation within
    ``rtol`` of the exact one."""
    import torch
    e, _, n = acc64.shape
    col = slots.repeat_interleave(bw, dim=1)[:, :n].long()
    zc = torch.amax(torch.abs(acc64) * gain, dim=1)
    ac = torch.amax(absacc64, dim=1) * gain
    smax = torch.stack([torch.amax(torch.where(col == i, zc, 0.0))
                        for i in range(nslots)]).clamp_min(1e-9)
    amax = torch.stack([torch.amax(torch.where(col == i, ac, 0.0))
                        for i in range(nslots)])
    s64 = smax[col].reshape(e, 1, n)
    return s64, (rtol * amax[col]).reshape(e, 1, n) / s64


def run_f32x3_case(case: dict, dev, seed: int) -> dict:
    """One 3xTF32 case: two kernel calls bitwise equal; integer codes
    bitwise the plain version; noisy codes held to the exact (float64)
    product: the raw accumulator within F32X3_RTOL x sum|x||w| (without a
    readout, the scaled output within that and the epilogue's three float32
    roundings, 2^-22), each readout level within the rounding of the exact
    one (``tdvmm.check_readout``: a level may move by one only at a tie),
    the plain version's too."""
    import torch
    from repro_torch.core import quant
    from repro_torch.core.constants import TDVMMSpec
    from repro_torch.kernels.tdvmm import ops, tdvmm as tk

    import numpy as np
    e, ex, m, k, n = (case[f] for f in ("e", "ex", "m", "k", "n"))
    data, widths, mode = case["data"], case["widths"], case["mode"]
    lim_x, lim_w = F32X3_INT.get(data, (63, 63))
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randint(-lim_x, lim_x + 1, (ex, m, k), generator=g,
                      device=dev).to(torch.float32)
    w = torch.randint(-lim_w, lim_w + 1, (e, k, n), generator=g,
                      device=dev).to(torch.float32)
    noisy = data == "noisy"
    if noisy:
        # the programming noise of training (DIBL and tuning), as the layer
        # draws it
        w = quant.program_noise(quant.QuantizedTensor(
            w, torch.ones((), device=dev), 6), TDVMMSpec(), seed).codes
    # noisy codes ask for the 3xTF32 storage; integer ones get it from
    # their width (check_code_width)
    max_code = None if noisy else max(lim_x, lim_w)
    storage = "f32x3" if noisy else None
    xs = torch.rand((ex, m), generator=g, device=dev) + 0.5
    ws = torch.rand((e, n), generator=g, device=dev) + 0.5
    gain = 1.0 / (float(lim_x) * float(lim_w) * 2.0 * k)
    acc64 = torch.matmul(x.double(), w.double())
    absacc64 = torch.matmul(x.abs().double(), w.abs().double())
    rtol = tk.F32X3_RTOL
    window = members = None
    if mode == "member_windows":
        z = torch.abs(acc64[0] * gain)
        members = tuple(float(np.float32(float(torch.amax(t)) * 0.7))
                        for t in torch.split(z, list(widths), dim=1))
        window = ops._member_window_cols(members, widths, n, x.device)
        s64, s_rel = window.double(), 0.0
    elif "window" in mode:
        zmax = (torch.amax(torch.abs(acc64 * gain), dim=(1, 2))
                * 0.7).to(torch.float32)
        window = zmax if mode == "expert_windows" else zmax[0].reshape(())
        s64 = window.double().reshape(-1, 1, 1)
        s_rel = 0.0
    bits = None if mode in ("raw", "no_readout") else 6
    if case["kernel"] == "tdvmm_matmul_raw":
        kern = lambda: tk.tdvmm_matmul_raw(x, w, None, max_code,  # noqa: E731
                                           storage)
        plain = lambda: tk.tdvmm_raw_plain(x, w)                  # noqa: E731
    elif case["kernel"] == "tdvmm_fused":
        kern = lambda: tk.tdvmm_fused(x, w, xs, ws, gain, bits,  # noqa: E731
                                      window, None, max_code, storage)
        plain = lambda: tk.tdvmm_fused_plain(x, w, xs, ws, gain,  # noqa: E731
                                             bits, window)
    else:
        slots, nslots = ops._calib_slots(e, n, tk.TILE_N, widths)
        slots = slots.contiguous().to(dev)
        bw = min(tk.TILE_N, n)
        s64, s_rel = _slot_windows64(acc64, absacc64, gain, slots, nslots,
                                     bw, rtol)
        kern = lambda: tk.tdvmm_calibrated(x, w, xs, ws, slots,  # noqa: E731
                                           nslots, bw, gain, 6, None,
                                           max_code, storage)
        plain = lambda: tk.tdvmm_calibrated_plain(              # noqa: E731
            x, w, xs, ws, slots, nslots, bw, gain, 6)
    reset_all_launches()
    yk, yk2, yp = kern(), kern(), plain()
    torch.cuda.synchronize()
    launched = launches_now()
    counter = COUNTER[case["kernel"]] + "_f32x3"
    require(launched[counter] == 2 and sum(launched.values()) == 2,
            f"{case}: launches {launched}, want 2 x {counter}")
    require(bool(torch.equal(yk, yk2)), f"{case}: two calls differ")
    require(bool(torch.isfinite(yp).all()), f"{case}: non-finite plain")
    err = float((yk.double() - yp.double()).abs().max())
    flips = flips_plain = 0
    acc_rel = acc_rel_plain = None
    gate = rtol
    if not noisy:
        require(err == 0.0, f"{case}: integer codes differ from plain by "
                f"{err}")
    if bits is None:
        scale = 1.0
        if mode == "no_readout":
            scale = (float(np.float32(gain)) * xs.double()[..., :, None]
                     * ws.double()[..., None, :])
            gate = rtol + 2.0 ** -22
        for name, y in (("kernel", yk), ("plain", yp)):
            rel = float(((y.double() - acc64 * scale).abs()
                         / (absacc64 * scale).clamp_min(1e-30)).max())
            require(rel <= gate, f"{case}: {name} accumulator {rel:.3g} of "
                    f"sum|x||w| from the exact product (> {gate:.3g})")
            if name == "kernel":
                acc_rel = rel
            else:
                acc_rel_plain = rel
    else:
        (flips, bad), (flips_plain, bad_p) = (
            tk.check_readout(y, acc64, absacc64, xs, ws, gain, 6, s64, s_rel)
            for y in (yk, yp))
        require(bad == 0 and bad_p == 0,
                f"{case}: {bad} kernel and {bad_p} plain outputs off the "
                "exact readout beyond its rounding")
    del yk, yk2, yp, acc64, absacc64

    # the yardstick: float32 torch.bmm (TF32 off), plus the torch epilogue
    xb = x.expand(e, m, k)

    def library():
        acc = torch.bmm(xb, w)
        if case["kernel"] == "tdvmm_matmul_raw":
            return acc
        if case["kernel"] == "tdvmm_calibrated":
            return ops._epilogue(acc, xs, ws, gain, 6, None,
                                 group_widths=widths)
        return ops._epilogue(acc, xs, ws, gain, bits, members,
                             out_window=None if members else window,
                             group_widths=widths)
    bound_ms, bound_by = f32x3_bound(case)
    row = dict(case, max_abs_err=err, acc_rel_err=acc_rel,
               acc_rel_err_plain=acc_rel_plain, gate=gate,
               flips=flips,
               flips_plain=flips_plain, ms=time_ms(kern, 20),
               plain_ms=time_ms(plain, 5), bound_ms=bound_ms,
               bound_by=bound_by, library_ms=time_ms(library, 10),
               library_tf32_ms=None, library_padded=False,
               tile=tk.autotune_blocks(m, k, n, storage or "f32").name)
    row.pop("rep", None)
    return row


# ---------------------------------------------------------------------------
# Phase 4: training at full width (QAT), noisy steps, the case study
# ---------------------------------------------------------------------------
def qat_config(**tdvmm):
    from repro_torch.configs import get_config
    from repro_torch.core.layers import TDVMMLayerConfig
    return get_config(ARCH).replace(
        remat_policy="minimal",
        tdvmm=TDVMMLayerConfig(enabled=True, bits=6, weight_bits=6, **tdvmm))


def mesh_qwen(dev, *outs) -> dict:
    """"mesh qwen" (a): a world of one over NCCL on the card and a (1, 1)
    mesh.  Each plan's engine on the mesh (``Engine(..., mesh=)``) serves
    the trace of "serve qwen" to that engine's streams, finish reasons,
    finish steps and steps, bitwise, with B1 fused launched exactly sites x
    steps in the run (counts set to 0 just before it, read just after); one
    full-width QAT step on the mesh (``launch.steps`` with the state
    sharded, the FSDP dims gathered, the data-parallel reduction) equals
    the meshless step bitwise, in every leaf of the new state and every
    metric, with the same launches.  (b) ``two_ranks``: two processes on the
    card over gloo (``GLOO_CUDA``) serve the ffn_unchained trace at 1 x 2
    and at 2 x 1."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import OptimizerConfig, RunConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, make_pipeline
    from repro_torch.kernels.tdvmm import tdvmm as tk
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.optim.optimizer import make_optimizer
    from repro_torch.runtime.engine import Engine
    from repro_torch.tree import leaves_with_paths

    t0 = time.perf_counter()
    _, world, _ = mesh_lib.init_distributed(dev)
    require(world == 1 and dist.get_backend() == "nccl",
            f"mesh qwen: world {world} over {dist.get_backend()}")
    mesh = mesh_lib.make_test_mesh(1, 1, "cuda")
    res = {"plans": {}}
    try:
        for out in outs:
            cfg, params, ecfg, calib = out["engine_args"]
            base = out["report"]
            reset_all_launches()
            rep = Engine(cfg, params, ecfg, calib=calib, mesh=mesh).run(
                out["trace"])
            torch.cuda.synchronize()
            launches = dict(tk.LAUNCHES)
            want = expected_launches(cfg, out["plan"], rep.prefill_steps
                                     + rep.decode_steps)["serve"]
            name = out["plan"]
            require(launches == want,
                    f"mesh qwen {name}: launches {launches} != {want}")
            require(rep.steps == base.steps and rep.step_shapes == 2
                    and rep.devices == 1 and rep.total_slots == ecfg.slots,
                    f"mesh qwen {name}: steps {rep.steps} / {base.steps}, "
                    f"shapes {rep.step_shapes}, devices {rep.devices}")
            for a, b in zip(base.requests, rep.requests):
                require(a["tokens"] == b["tokens"]
                        and a["finish_reason"] == b["finish_reason"]
                        and a["finished_step"] == b["finished_step"],
                        f"mesh qwen {name}: request {a['rid']} differs from "
                        "the meshless engine")
            res["plans"][name] = dict(launches=launches, steps=rep.steps,
                                      serve_s=rep.wall_s,
                                      meshless_s=base.wall_s)
        cfg = qat_config()
        opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=2,
                                  total_steps=QAT_STEPS)
        run = RunConfig(model=cfg, shape=ShapeConfig(
            "qat", QAT_SEQ, QAT_BATCH, "train",
            microbatch_per_shard=QAT_BATCH), seed=0, optimizer=opt_cfg)
        optimizer = make_optimizer(opt_cfg)
        state = steps.init_train_state(0, cfg, optimizer, dev)
        batch = make_pipeline(cfg, run.shape, DataConfig(seed=0)).batch_at(0)
        reset_all_launches()
        t1 = time.perf_counter()
        one, m1 = steps.make_train_step(cfg, run, optimizer)(state, batch)
        torch.cuda.synchronize()
        res["meshless_step_s"] = time.perf_counter() - t1
        l1 = launches_now()
        specs = steps.state_specs(state, cfg, mesh)
        sharded = steps.shard_state(state, cfg, mesh)
        del state
        reset_all_launches()
        t1 = time.perf_counter()
        two, m2 = steps.make_train_step(cfg, run, optimizer, mesh=mesh,
                                        specs=specs)(sharded, batch)
        torch.cuda.synchronize()
        res["mesh_step_s"] = time.perf_counter() - t1
        l2 = launches_now()
        res["qat_launches"] = l2
        require(l1 == l2, f"mesh qwen qat: launches {l2} != meshless {l1}")
        diff = [p for (p, a), (_, b) in zip(leaves_with_paths(one),
                                            leaves_with_paths(two))
                if not torch.equal(a, b)]
        require(not diff, f"mesh qwen qat: leaves differ: {diff[:4]}")
        require(all(torch.equal(m1[k], m2[k]) for k in m1),
                "mesh qwen qat: metrics differ")
        res["loss"] = float(m1["loss"])
        res["leaves"] = len(leaves_with_paths(one))
        del one, two, sharded
    finally:
        dist.destroy_process_group()
    res["two_ranks"] = all(GLOO_CUDA.values())
    if res["two_ranks"]:
        res["b"] = two_ranks(outs[0], dev)
    res["seconds"] = time.perf_counter() - t0
    return res


def forced_logits(params, cfg, calib, prompts, forced, dev, mesh=None):
    """The static path teacher-forced: prefill ``prompts`` (B, S), then one
    decode step per column of ``forced`` (B, T) tokens; every step's
    logits (B, V) as float32 on the CPU.  On ``mesh`` each rank keeps its
    shards of ``params`` and its rows of the batch, and the logits come
    back whole."""
    import torch
    from repro_torch.launch import meshctx, sharding, steps
    from repro_torch.launch.mesh import axis_info
    from repro_torch.models import common, model
    b, s = prompts.shape
    if mesh is not None:
        dp = axis_info(mesh)["dp_axes"]
        params = sharding.shard_tree(params, sharding.param_specs(
            params, cfg, mesh, dp_axes=(), ep_axes=dp), mesh)
    out = []
    caches = steps.init_serving_caches(cfg, b, s + forced.shape[1], dev,
                                       mesh)
    with meshctx.use_mesh_of(mesh):
        rows = common.constrain_batch(prompts)
        split = rows.shape[0] != b
        toks = common.constrain_batch(forced)
        with meshctx.split_rows(split), meshctx.split_seq(not split):
            logits, caches = model.prefill_step(params, {"inputs": rows},
                                                caches, cfg, calib=calib)
            out.append(meshctx.dp_gather(logits[:, -1], b))
            for t in range(forced.shape[1] - 1):
                logits, caches = model.decode_step(
                    params, {"inputs": toks[:, t:t + 1]}, caches, cfg,
                    calib=calib)
                out.append(meshctx.dp_gather(logits[:, -1], b))
    return [x.float().cpu() for x in out]


@contextlib.contextmanager
def tp_order(tp: int, col_parts=None):
    """The meshless model with each row-parallel product outside the TD-VMM
    sites (``common.dense(..., tp="row")``, ``common.dense_tp_reduce``:
    attn.wo, and ffn.w_down with TD-VMM off) formed as a 1 x ``tp`` mesh
    forms it: ``tp`` float32 partial products (``common.partial_f32`` on
    each rank's slice of K), summed in rank order and rounded once.  Every
    other op of a TP shard gives the meshless op's bits on the card
    (column products, attention by heads: scripts/tp_order_probe.py; the
    TD-VMM sites: ``two_rank_sites``), so a 1 x ``tp`` run equals this one
    bit for bit, and a wrong shard, cache layout or reduction does not.
    The SSM's gated RMSNorm sums its squares as ``tp`` partial sums added
    in rank order (``ssm.TP_ORDER``), as a 1 x ``tp`` run's all-reduce
    does.  ``col_parts``: the grouped column products (``attn.qkv`` with
    TD-VMM off) formed as the shards form them too, member g as
    ``col_parts[g]`` products of equal column slices, concatenated: at
    kimi-k2's K 7168 a column slice's product is not always the whole
    product's columns on the card (scripts/tp_order_probe.py)."""
    import torch
    from repro_torch.models import common, ssm
    dense, reduce_ = common.dense, common.dense_tp_reduce
    group = common.dense_group

    def row(params, x):
        k = x.shape[-1] // tp
        y = None
        for r in range(tp):
            part = common.partial_f32(
                x[..., r * k:(r + 1) * k].contiguous(),
                params["w"][r * k:(r + 1) * k].contiguous())
            y = part if y is None else y + part
        y = y.to(x.dtype)
        return y + params["b"].to(y.dtype) if "b" in params else y

    def dense_(params, x, td, key=None, tp="col", shard=None):
        if tp == "row" and not td.enabled:
            return row(params, x)
        return dense(params, x, td, key, tp, shard)

    def reduce__(params, x, td, key=None, shard=None):
        return reduce_(params, x, td, key, shard) if td.enabled else \
            row(params, x)

    def group_(param_group, x, td, key=None, tp="col", shard=None,
               replicas=None):
        if td.enabled or col_parts is None:
            return group(param_group, x, td, key, tp, shard, replicas)
        out = []
        for p, parts in zip(param_group, col_parts):
            w = p["w"]
            c = w.shape[-1] // parts
            y = torch.cat([x @ w[:, i * c:(i + 1) * c].contiguous()
                           for i in range(parts)], dim=-1)
            out.append(y + p["b"].to(y.dtype) if "b" in p else y)
        return tuple(out)
    common.dense, common.dense_tp_reduce = dense_, reduce__
    common.dense_group = group_
    ssm.TP_ORDER = tp
    try:
        yield
    finally:
        common.dense, common.dense_tp_reduce = dense, reduce_
        common.dense_group = group
        ssm.TP_ORDER = 1


@contextlib.contextmanager
def seq_order(n: int):
    """The meshless model with each decode step's attention formed as an
    n x 1 mesh forms it over a sequence-split cache
    (``attention.SEQ_ORDER``: the softmax's sum and the float32 products
    over n contiguous segments of the cache, added in segment order): an
    n x 1 run equals it bit for bit (the prefill and every other op are the
    meshless ones there), a wrong segment, write or reduction does not."""
    from repro_torch.models import attention
    attention.SEQ_ORDER = n
    try:
        yield
    finally:
        attention.SEQ_ORDER = 1


def two_ranks(out: dict, dev) -> dict:
    """"mesh qwen" (b): two processes share the card in one gloo group
    (``two_rank_worker``), at full width on a 1 x 2 mesh (TP: heads, FFN
    hidden and vocab split, B1 fused at the column sites with the pinned
    window, B1 raw at the row sites with their int32 sums all-reduced) and
    on a 2 x 1 mesh (DP: each rank's rows, the samples all-gathered).
    - TD-VMM sites on CUDA through gloo: a row site (pinned window and
      data-calibrated) and a column site at qwen's FFN shapes, on each
      rank's shard, bitwise the meshless site.
    - The engine, each mesh, on the "serve qwen" trace under ffn_unchained:
      every request its full budget, B1 launched exactly as the sites and
      steps give it, 2 step shapes, both ranks' streams equal.  At 2 x 1
      with 2 x the slots (each rank's decode step the meshless step's
      shape; a request's stream is its solo stream): the meshless streams,
      finish reasons and finish steps.  At 1 x 2: those of the meshless
      engine in TP's order (``tp_order``), and its steps.
    - Teacher-forced logits (static path, 4 x 64 prompts + 8 tokens of the
      meshless greedy stream), TD-VMM off and under ffn_unchained: at 2 x 1
      bitwise the meshless run's; at 1 x 2 bitwise the meshless run's in
      TP's order, and with TD-VMM off within TWO_RANK_RTOL of max|logit| of
      the meshless run's (its bf16 row sums round in another order; under
      the plan a value that crosses a 6-bit level flips a code downstream,
      and that gap is reported)."""
    import multiprocessing as mp
    import queue
    import torch
    from repro_torch.models import model
    from repro_torch.runtime.engine import Engine
    cfg, params, ecfg, calib = out["engine_args"]
    plain = cfg.replace(tdvmm_plan=None)

    def streams(rep):
        return [(q["rid"], q["tokens"], q["finish_reason"], q["finished_step"])
                for q in rep.requests]
    base = streams(out["report"])
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    prompts = torch.randint(0, cfg.vocab_size, TWO_RANK_PROMPTS, generator=g,
                            device=dev)
    with torch.no_grad():
        # the meshless greedy stream, then the logits it forces
        caches = model.init_caches(cfg, prompts.shape[0], prompts.shape[1]
                                   + TWO_RANK_FORCED, dev)
        logits, caches = model.prefill_step(params, {"inputs": prompts},
                                            caches, cfg, calib=calib)
        toks = [logits[:, -1].argmax(-1)]
        for _ in range(TWO_RANK_FORCED - 1):
            logits, caches = model.decode_step(
                params, {"inputs": toks[-1][:, None]}, caches, cfg,
                calib=calib)
            toks.append(logits[:, -1].argmax(-1))
        del caches
        forced = torch.stack(toks, 1)
        ref = {"plan": forced_logits(params, cfg, calib, prompts, forced,
                                     dev),
               "plain": forced_logits(params, plain, None, prompts, forced,
                                      dev)}
        with tp_order(TP):
            ctrl = {"plan": forced_logits(params, cfg, calib, prompts,
                                          forced, dev),
                    "plain": forced_logits(params, plain, None, prompts,
                                           forced, dev)}
            rep = Engine(cfg, params, ecfg, calib=calib).run(out["trace"])
        ctrl_streams, ctrl_steps = streams(rep), rep.steps
        del rep
    # numpy, not tensors, through the queues: a tensor would travel as a
    # shared-memory handle that dies with the process that sent it
    job = {"plan": out["plan"], "ecfg": dataclasses.asdict(ecfg),
           "windows": {k: v.detach().cpu().numpy() for k, v in
                       calib.as_arrays("cpu").items()},
           "prompts": prompts.cpu().numpy(), "forced": forced.cpu().numpy()}
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got = {}
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=two_rank_worker, args=(
            r, os.path.join(d, "init"), job, results)) for r in range(2)]
        for p in procs:
            p.start()
        try:
            for _ in procs:
                try:
                    rank, ok, val = results.get(timeout=TWO_RANK_TIMEOUT)
                except queue.Empty:
                    raise SmokeFailure("mesh qwen (b): a rank gave no "
                                       f"result in {TWO_RANK_TIMEOUT} s")
                require(ok, f"mesh qwen (b) rank {rank}: {val}")
                got[rank] = val
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    L = cfg.n_layers
    res = {}
    for name in ("tp", "dp"):
        a = got[0][name]
        # at 2 x 1 each rank's decode steps are the meshless engine's, and
        # twice the slots take fewer steps: its finish steps and steps move
        want = {"tp": (ctrl, ctrl_streams, ctrl_steps),
                "dp": (ref, [x[:3] for x in base], a["steps"])}[name]
        streams_ = [x[:len(want[1][0])] for x in a["streams"]]
        require(a["streams"] == got[1][name]["streams"],
                f"mesh qwen (b) {name}: the two ranks' streams differ")
        for rank in (0, 1):
            r_ = got[rank][name]
            bad = [k for k, v in r_["sites"].items() if not v]
            require(not bad, f"mesh qwen (b) {name} rank {rank}: TD-VMM "
                    f"sites differ from the meshless sites: {bad}")
            for req, rec in zip(out["trace"], r_["streams"]):
                require(rec[2] == "max_tokens"
                        and len(rec[1]) == req.max_new_tokens,
                        f"mesh qwen (b) {name} rank {rank}: request "
                        f"{req.rid} finished {rec[2]} with {len(rec[1])} of "
                        f"{req.max_new_tokens} tokens")
            per = 2 if name == "tp" else 3          # fused launches a layer
            need = {"fused": per * L * r_["steps"],
                    "raw": (L if name == "tp" else 0) * r_["steps"]}
            have = {k: r_["launches"][k] for k in need}
            require(have == need and r_["launches"]["calibrated"] == 0
                    and r_["shapes"] == 2,
                    f"mesh qwen (b) {name} rank {rank}: launches {have} != "
                    f"{need}, shapes {r_['shapes']}")
        first = [next((i for i, (u, v) in enumerate(zip(x[1], y[1]))
                       if u != v), None)
                 for x, y in zip(streams_, want[1])]
        require(streams_ == want[1] and a["steps"] == want[2],
                f"mesh qwen (b) {name}: streams differ from the meshless "
                f"engine's{' in TP order' if name == 'tp' else ''} (first "
                f"differing token {first}; steps {a['steps']} / {want[2]})")
        gaps = {}
        for kind in ("plain", "plan"):
            mine = [torch.from_numpy(x) for x in a["logits"][kind]]
            same = [torch.equal(x, y) for x, y in zip(mine, want[0][kind])]
            require(all(same), f"mesh qwen (b) {name} {kind}: teacher-forced "
                    "logits differ from the meshless run's"
                    f"{' in TP order' if name == 'tp' else ''} at steps "
                    f"{[i for i, e in enumerate(same) if not e]}")
            gap = max(float((x - y).abs().max())
                      for x, y in zip(mine, ref[kind]))
            gaps[kind] = gap / max(float(y.abs().max()) for y in ref[kind])
        require(gaps["plain"] <= TWO_RANK_RTOL,
                f"mesh qwen (b) {name}: TD-VMM off, forced logits "
                f"{gaps['plain']:.4g} of max|logit| from the meshless run's")
        res[name] = dict(
            {k: v for k, v in a.items() if k != "logits"}, gaps=gaps,
            equal=sum(x[:3] == y[:3] for x, y in zip(a["streams"], base)),
            first=[next((i for i, (u, v) in enumerate(zip(x[1], y[1]))
                         if u != v), None)
                   for x, y in zip(a["streams"], base)])
    require(res["tp"]["devices"] == res["dp"]["devices"] == 2
            and res["tp"]["total_slots"] == ecfg.slots
            and res["dp"]["total_slots"] == 2 * ecfg.slots,
            "mesh qwen (b): devices / slots")
    return res


def two_rank_sites(mesh, dev) -> dict:
    """A row site (pinned window, data-calibrated) and a column site at
    qwen's FFN shapes on this rank's shard, against the meshless site on
    the whole operands: bitwise?"""
    import torch
    from repro_torch.core import layers
    from repro_torch.core.layers import TDVMMLayerConfig
    from repro_torch.launch import meshctx
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    (k_in, n_in), (k_out, n_out) = FFN_SHAPES
    x = torch.randn((CHUNK, k_out), generator=g, device=dev).bfloat16()
    w = (torch.randn((k_out, n_out), generator=g, device=dev) * 0.02
         ).bfloat16()
    x2 = torch.randn((CHUNK, k_in), generator=g, device=dev).bfloat16()
    w2 = (torch.randn((k_in, n_in), generator=g, device=dev) * 0.02
          ).bfloat16()
    tp, r = meshctx.axis_size("model", mesh), meshctx.axis_rank("model", mesh)
    out = {}
    for name, cfg in (("row pinned", TDVMMLayerConfig(
            enabled=True, site="ffn.out", out_scale=0.01)),
            ("row data-calibrated", TDVMMLayerConfig(
                enabled=True, site="ffn.out"))):
        want = layers.td_matmul(x, w, cfg)
        with meshctx.use_mesh_of(mesh):
            got = layers.td_matmul(x.chunk(tp, -1)[r], w.chunk(tp, 0)[r],
                                   cfg, tp="row")
        out[name] = bool(torch.equal(got, want))
    cfg = TDVMMLayerConfig(enabled=True, site="ffn.in", out_scale=0.01)
    want = layers.td_matmul(x2, w2, cfg)
    with meshctx.use_mesh_of(mesh):
        got = layers.td_matmul(x2, w2.chunk(tp, -1)[r], cfg, tp="col")
    out["column pinned"] = bool(torch.equal(got, want.chunk(tp, -1)[r]))
    return out


def two_rank_worker(rank: int, init_file: str, job: dict, results) -> None:
    """One rank of ``two_ranks``: device 0, a gloo group of two."""
    import traceback
    try:
        import torch
        import torch.distributed as dist
        sys.path.insert(0, str(ROOT / "src"))
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.use_deterministic_algorithms(True)
        torch.utils.deterministic.fill_uninitialized_memory = False
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=2)
        from repro_torch.configs import get_config
        from repro_torch.core.calibration import CalibrationState
        from repro_torch.kernels.tdvmm import tdvmm as tk
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.models import model
        from repro_torch.runtime.engine import Engine, EngineConfig
        dev = torch.device("cuda", 0)
        cfg = get_config(ARCH).replace(n_layers=SERVE_LAYERS,
                                       tdvmm_plan=plans()[job["plan"]])
        params = model.init_params(0, cfg, device=dev)
        calib = CalibrationState(windows={
            k: torch.from_numpy(v) for k, v in job["windows"].items()})
        trace = make_trace(cfg.vocab_size)
        prompts = torch.from_numpy(job["prompts"]).to(dev)
        forced = torch.from_numpy(job["forced"]).to(dev)
        out = {}
        for name, shape, slots in (
                ("tp", (1, 2), job["ecfg"]["slots"]),
                ("dp", (2, 1), 2 * job["ecfg"]["slots"])):
            mesh = mesh_lib.make_test_mesh(*shape, "cuda")
            ecfg = EngineConfig(**dict(job["ecfg"], slots=slots // shape[0]))
            engine = Engine(cfg, params, ecfg, calib=calib, device=dev,
                            mesh=mesh)
            tk.reset_launches()
            rep = engine.run(trace)
            torch.cuda.synchronize()
            out[name] = dict(
                streams=[(q["rid"], q["tokens"], q["finish_reason"],
                          q["finished_step"]) for q in rep.requests],
                steps=rep.steps, launches=dict(tk.LAUNCHES),
                shapes=rep.step_shapes, serve_s=rep.wall_s,
                devices=rep.devices, total_slots=rep.total_slots)
            del engine
            with torch.no_grad():
                out[name]["sites"] = two_rank_sites(mesh, dev)
                out[name]["logits"] = {
                    "plan": [x.numpy() for x in forced_logits(
                        params, cfg, calib, prompts, forced, dev, mesh)],
                    "plain": [x.numpy() for x in forced_logits(
                        params, cfg.replace(tdvmm_plan=None), None, prompts,
                        forced, dev, mesh)]}
        dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    results.close()
    results.join_thread()
    os._exit(0)


def greedy_logits(params, cfg, prompts, steps: int, dev):
    """The static path greedy for ``steps`` tokens after ``prompts`` (B,
    S), meshless: (the (B, steps) tokens, every step's (B, V) logits as
    float32 on the CPU)."""
    import torch
    from repro_torch.models import model
    caches = model.init_caches(cfg, prompts.shape[0],
                               prompts.shape[1] + steps, dev)
    logits, caches = model.prefill_step(params, {"inputs": prompts}, caches,
                                        cfg)
    toks, out = [], []
    for t in range(steps):
        out.append(logits[:, -1].float().cpu())
        toks.append(logits[:, -1].argmax(-1))
        if t + 1 < steps:
            logits, caches = model.decode_step(
                params, {"inputs": toks[-1][:, None]}, caches, cfg)
    return torch.stack(toks, 1), out


def cache_bytes(cfg, batch: int, max_len: int, dev, mesh=None) -> int:
    """Bytes of this rank's serving caches (``steps.init_serving_caches``)."""
    from repro_torch.launch import steps
    caches = steps.init_serving_caches(cfg, batch, max_len, dev, mesh)
    return sum(t.numel() * t.element_size() for t in _leaves(caches))


def _leaves(tree):
    from repro_torch.tree import leaves
    return [t for t in leaves(tree) if hasattr(t, "numel")]


def mesh_ssm(dev, ssm_args) -> dict:
    """"mesh ssm": two processes share the card over gloo
    (``mesh_ssm_worker``), as "mesh qwen" (b) does.
    - mamba2-1.3b at full width on 1 x 2 under ssm.* with the serve
      phase's windows: its TD-VMM sites on each rank's shard bitwise the
      meshless sites; ``serve_static`` on the serve phase's 4 x 512 prompts
      for 32 tokens, with exactly L x 32 B1 fused (ssm.in_proj), L x 32 B1
      raw (ssm.out, int32 sums over ``model``) and L B3 launches a rank;
      its streams and its teacher-forced logits (plan and TD-VMM off)
      bitwise the meshless run's in TP's order (``tp_order``), and TD-VMM
      off within TWO_RANK_RTOL of the plain meshless run.
    - one qwen1.5-0.5b QAT step at full width in float32 on 1 x 2, every
      linear a 6-bit site: the new parameters bitwise the meshless step's
      (the warmup's first learning rate is 0), the gradients within
      QAT_TP_RTOL; the noisy codes of each rank's shard of ffn.in, ffn.out
      and the grouped q/k/v bitwise the meshless noisy codes.
    - zamba2-2.7b at full width in float32 on 2 x 1 with batch 1: a
      sequence-split cache, a MESH_HYB_PROMPT-token prompt, then
      MESH_HYB_GEN steps teacher-forced with the meshless greedy stream:
      every step's logits bitwise the meshless run's in the split's order
      (``seq_order``), within MESH_HYB_RTOL of the plain meshless run's,
      the meshless greedy token at every step; each rank's cache bytes."""
    import multiprocessing as mp
    import queue
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model
    t0 = time.perf_counter()
    cfg, params, calib, prompts = ssm_args
    plain = cfg.replace(tdvmm_plan=None)
    with torch.no_grad():
        forced, _ = greedy_logits(params, cfg.replace(tdvmm_plan=None),
                                  prompts, MESH_SSM_FORCED, dev)
        ref_plain = forced_logits(params, plain, None, prompts, forced, dev)
        with tp_order(TP):
            ctrl = {"plan": forced_logits(params, cfg, calib, prompts,
                                          forced, dev),
                    "plain": forced_logits(params, plain, None, prompts,
                                           forced, dev)}
            ctrl_tokens = serve.serve_static(
                cfg, SSM_BATCH, SSM_PROMPT, SSM_GEN, calib=calib,
                device=dev, params=params, prompts=prompts)["tokens"]
        hcfg = get_config(HYB_ARCH).replace(dtype="float32")
        hparams = model.init_params(0, hcfg, device=dev)
        g = torch.Generator(device=dev)
        g.manual_seed(7)
        hprompt = torch.randint(0, hcfg.vocab_size, (1, MESH_HYB_PROMPT),
                                generator=g, device=dev)
        t1 = time.perf_counter()
        h_tokens, h_logits = greedy_logits(hparams, hcfg, hprompt,
                                           MESH_HYB_GEN, dev)
        torch.cuda.synchronize()
        h_meshless_s = time.perf_counter() - t1
        h_bytes = cache_bytes(hcfg, 1, MESH_HYB_PROMPT + MESH_HYB_GEN, dev)
        with seq_order(2):
            c_logits = forced_logits(hparams, hcfg, None, hprompt, h_tokens,
                                     dev)
        del hparams
        torch.cuda.empty_cache()
    job = {"windows": {k: v.detach().cpu().numpy() for k, v in
                       calib.as_arrays("cpu").items()},
           "prompts": prompts.cpu().numpy(), "forced": forced.cpu().numpy(),
           "hprompt": hprompt.cpu().numpy(),
           "hforced": h_tokens.cpu().numpy()}
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got = {}
    with tempfile.TemporaryDirectory() as d:
        procs = [ctx.Process(target=mesh_ssm_worker, args=(
            r, os.path.join(d, "init"), job, results)) for r in range(2)]
        for p in procs:
            p.start()
        try:
            for _ in procs:
                try:
                    rank, ok, val = results.get(timeout=MESH_TIMEOUT)
                except queue.Empty:
                    raise SmokeFailure("mesh ssm: a rank gave no result in "
                                       f"{MESH_TIMEOUT} s")
                require(ok, f"mesh ssm rank {rank}: {val}")
                got[rank] = val
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    L = cfg.n_layers
    res = {"launches": [], "ranks": got}
    for rank in (0, 1):
        a = got[rank]["ssm"]
        bad = [k for k, v in a["sites"].items() if not v]
        require(not bad, f"mesh ssm rank {rank}: TD-VMM sites differ from "
                f"the meshless sites: {bad}")
        need = {"fused": L * SSM_GEN, "raw": L * SSM_GEN, "ssd": L}
        have = {k: a["launches"][k] for k in need}
        require(have == need and a["launches"]["calibrated"] == 0,
                f"mesh ssm rank {rank}: launches {have} != {need}")
        res["launches"].append(a["launches"])
        require(torch.equal(torch.from_numpy(a["tokens"]), ctrl_tokens),
                f"mesh ssm rank {rank}: streams differ from the meshless "
                "run's in TP order")
        for kind in ("plan", "plain"):
            mine = [torch.from_numpy(x) for x in a["logits"][kind]]
            same = [torch.equal(x, y) for x, y in zip(mine, ctrl[kind])]
            require(all(same), f"mesh ssm rank {rank} {kind}: teacher-forced "
                    "logits differ from the meshless run's in TP order at "
                    f"steps {[i for i, e in enumerate(same) if not e]}")
        gap = max(float((torch.from_numpy(x) - y).abs().max())
                  for x, y in zip(a["logits"]["plain"], ref_plain)) / max(
            float(y.abs().max()) for y in ref_plain)
        require(gap <= TWO_RANK_RTOL, f"mesh ssm: TD-VMM off, forced logits "
                f"{gap:.4g} of max|logit| from the plain meshless run's")
        res.setdefault("ssm_gap", []).append(gap)
        q = got[rank]["qat"]
        require(q["params_equal"], f"mesh ssm qat rank {rank}: parameters "
                f"differ from the meshless step's: {q['params_differ'][:4]}")
        require(q["grad_gap"] <= QAT_TP_RTOL, f"mesh ssm qat rank {rank}: "
                f"gradient {q['grad_gap']:.3g} of max|g| at {q['grad_leaf']}")
        require(not q["noise_bad"], f"mesh ssm qat rank {rank}: noisy codes "
                f"differ from the meshless codes: {q['noise_bad']}")
        require(abs(q["loss"] - q["meshless_loss"])
                <= 1e-6 * abs(q["meshless_loss"]),
                f"mesh ssm qat: loss {q['loss']} / {q['meshless_loss']}")
        res["launches"].append(q["launches"])
        h = got[rank]["hyb"]
        same = [np.array_equal(x, y.numpy())
                for x, y in zip(h["logits"], c_logits)]
        require(all(same), f"mesh ssm rank {rank}: zamba2's sequence-split "
                "teacher-forced logits differ from the meshless run's in "
                f"the split's order at steps "
                f"{[i for i, e in enumerate(same) if not e]}")
        hgap = max(float((torch.from_numpy(x) - y).abs().max())
                   for x, y in zip(h["logits"], h_logits)) / max(
            float(y.abs().max()) for y in h_logits)
        # the greedy stream the split run takes, step by step
        agree = [int(np.argmax(x[0])) == int(t) for x, t in
                 zip(h["logits"], h_tokens[0].tolist())]
        require(all(agree), f"mesh ssm rank {rank}: zamba2's sequence-split "
                "greedy tokens differ from the meshless stream at steps "
                f"{[i for i, a in enumerate(agree) if not a]}")
        require(hgap <= MESH_HYB_RTOL, f"mesh ssm: zamba2 2 x 1 logits "
                f"{hgap:.4g} of max|logit| from the meshless run's")
        # the KV caches split over the two ranks, the SSM state whole on
        # each (batch 1 cannot split)
        require(h["cache_bytes"] < h_bytes, f"mesh ssm: a rank's cache "
                f"{h['cache_bytes']} B is not a share of the meshless "
                f"{h_bytes} B")
        res.setdefault("hyb_gap", []).append(hgap)
        res["launches"].append(h["launches"])
    res["h_meshless_s"] = h_meshless_s
    res["h_bytes"] = h_bytes
    res["seconds"] = time.perf_counter() - t0
    return res


def ssm_sites(mesh, dev) -> dict:
    """mamba2's ssm.in_proj (the grouped column site, pinned and
    data-calibrated) and ssm.out (the row site, pinned) at full width on
    this rank's shard of a 1 x 2 mesh against the meshless site: bitwise?"""
    import torch
    from repro_torch.core import layers
    from repro_torch.core.layers import TDVMMLayerConfig
    from repro_torch.launch import meshctx
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    k, widths = SSM_IN[0], (4096, 4096, 128, 128, 64)
    x = torch.randn((CHUNK, k), generator=g, device=dev).bfloat16()
    ws = [(torch.randn((k, n), generator=g, device=dev) * 0.02).bfloat16()
          for n in widths]
    xo = torch.randn((CHUNK, SSM_OUT[0]), generator=g, device=dev).bfloat16()
    wo = (torch.randn(SSM_OUT, generator=g, device=dev) * 0.02).bfloat16()
    tp, r = meshctx.axis_size("model", mesh), meshctx.axis_rank("model", mesh)
    out = {}
    for name, kw in (("in_proj pinned", dict(out_scale=(0.01,) * 5)),
                     ("in_proj data-calibrated", {})):
        cfg = TDVMMLayerConfig(enabled=True, site="ssm.in_proj", **kw)
        want = layers.td_grouped_matmul(x, ws, cfg)
        with meshctx.use_mesh_of(mesh):
            got = layers.td_grouped_matmul(
                x, [w.chunk(tp, -1)[r] for w in ws], cfg, tp="col")
        out[name] = all(torch.equal(a, b.chunk(tp, -1)[r])
                        for a, b in zip(got, want))
    cfg = TDVMMLayerConfig(enabled=True, site="ssm.out", out_scale=0.01)
    want = layers.td_matmul(xo, wo, cfg)
    with meshctx.use_mesh_of(mesh):
        got = layers.td_matmul(xo.chunk(tp, -1)[r], wo.chunk(tp, 0)[r], cfg,
                               tp="row")
    out["out pinned"] = bool(torch.equal(got, want))
    return out


def qat_tp_step(dev, mesh) -> dict:
    """One full-width qwen QAT step in float32 (every linear a 6-bit site)
    meshless and on ``mesh``: the new parameters equal?, the largest
    gradient gap over its leaf's max|g|, the noisy codes of this rank's
    shards against the meshless noisy codes."""
    import torch
    from repro_torch.configs import OptimizerConfig, RunConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import layers, quant
    from repro_torch.core.layers import TDVMMLayerConfig
    from repro_torch.data.pipeline import DataConfig, make_pipeline
    from repro_torch.kernels.tdvmm import tdvmm as tk
    from repro_torch.launch import meshctx, sharding, steps
    from repro_torch.optim import optimizer as om
    from repro_torch.tree import leaves_with_paths
    cfg = qat_config().replace(dtype="float32")
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=QAT_STEPS)
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "qat", QAT_SEQ, QAT_BATCH, "train", microbatch_per_shard=QAT_BATCH),
        seed=0, optimizer=opt_cfg)
    optimizer = om.make_optimizer(opt_cfg)
    state = steps.init_train_state(0, cfg, optimizer, dev)
    batch = make_pipeline(cfg, run.shape, DataConfig(seed=0)).batch_at(0)
    got, update = [], om.Optimizer.update

    def spy(self, grads, *a, **kw):
        got.append(grads)
        return update(self, grads, *a, **kw)
    om.Optimizer.update = spy
    try:
        one, m1 = steps.make_train_step(cfg, run, optimizer)(state, batch)
        specs = steps.state_specs(state, cfg, mesh)
        reset_all_launches()
        two, m2 = steps.make_train_step(cfg, run, optimizer, mesh=mesh,
                                        specs=specs)(
            steps.shard_state(state, cfg, mesh), batch)
        torch.cuda.synchronize()
        launches = launches_now()
    finally:
        om.Optimizer.update = update
    whole = sharding.gather_tree(two.params, specs[0].params, mesh)
    differ = [p for (p, a), (_, b) in zip(leaves_with_paths(one.params),
                                          leaves_with_paths(whole))
              if not torch.equal(a, b)]
    grads = sharding.gather_tree(got[1], specs[0].params, mesh)
    gap, leaf = max((float((a - b).abs().max() / a.abs().max()), p)
                    for (p, a), (_, b) in zip(leaves_with_paths(got[0]),
                                              leaves_with_paths(grads)))
    del one, two, whole, grads, got, state
    # noisy codes: each rank's shard of ffn.in (column), ffn.out (row) and
    # the grouped q/k/v (column) against the whole bank's draws, sliced
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    noisy = TDVMMLayerConfig(enabled=True, noise=True)
    bad = []
    with meshctx.use_mesh_of(mesh):
        tp, r = meshctx.tp_size(), meshctx.tp_rank()
        for name, (k, n), kind in (("ffn.in", FFN_SHAPES[0], "col"),
                                   ("ffn.out", FFN_SHAPES[1], "row")):
            w = torch.randn((k, n), generator=g, device=dev) * 0.02
            dim = -1 if kind == "col" else -2
            whole_c = quant.program_noise(quant.program_weights(w, 6, True),
                                          noisy.spec, 5).codes
            qw = quant.program_weights(w.chunk(tp, dim)[r], 6, True,
                                       tp_reduce=kind == "row")
            mine = layers._shard_noise(qw, noisy, 5, kind).codes
            if not torch.equal(mine, whole_c.chunk(tp, dim)[r]):
                bad.append(name)
        ws = [torch.randn((1024, n), generator=g, device=dev) * 0.02
              for n in QKV_WIDTHS]
        ns = tuple(w.shape[-1] // tp for w in ws)
        widths = tuple(tk.padded_size(m, tk.LANE, tk.LANE) for m in ns)
        qw = quant.concat_group([quant.program_weights(
            w.chunk(tp, -1)[r], 6, True) for w in ws], widths)
        mine = layers._group_noise(qw, noisy, 5, "col", ns, widths, None)
        wide = tuple(tk.padded_size(w.shape[-1], tk.LANE, tk.LANE)
                     for w in ws)
        ref = quant.program_noise(quant.concat_group(
            [quant.program_weights(w, 6, True) for w in ws], wide),
            noisy.spec, 5).codes
        off = lo = 0
        for i, m in enumerate(ns):
            if not torch.equal(mine.codes[:, lo:lo + m],
                               ref[:, off + r * m:off + (r + 1) * m]):
                bad.append(f"attn.qkv member {i}")
            off += wide[i]
            lo += widths[i]
    return {"params_equal": not differ, "params_differ": differ,
            "grad_gap": gap, "grad_leaf": leaf, "noise_bad": bad,
            "loss": float(m2["loss"]), "meshless_loss": float(m1["loss"]),
            "launches": launches}


def dryrun_vs_step(dev, engine_args) -> dict:
    """"mesh ssm" (d): the dry run against the real step.  The full-width
    qwen prefill (4 x 512 tokens, the ffn_unchained plan data-calibrated)
    counted by ``launch.roofline.StepCounter`` around the real step on the
    card (its second call: the first fills the launch caches), and by the
    dry run (``launch.dryrun.count_fake``: fake tensors, a fake world of
    one, a (1, 1) mesh): the same kernel calls per storage, the same FLOPs
    by class and the same HBM bytes."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, meshctx, roofline, steps
    cfg, params, _, _ = engine_args
    shape = ShapeConfig("prefill", 512, 4, "prefill")
    g = torch.Generator(device=dev)
    g.manual_seed(13)
    # int32 token ids, as the dry run's (and the JAX package's) batches
    batch = {"inputs": torch.randint(0, cfg.vocab_size, (4, 512),
                                     generator=g, device=dev,
                                     dtype=torch.int32)}
    step = steps.make_prefill_step(cfg)
    t0 = time.perf_counter()
    with torch.no_grad():
        for i in range(2):
            caches = steps.init_serving_caches(cfg, 4, 512, dev)
            counter = roofline.StepCounter()
            counter.known(params, batch, caches)
            with counter:
                step(params, batch, caches)
            torch.cuda.synchronize()
    real = counter.summary()
    real_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        fake = dryrun.count_fake(cfg, shape, (1, 1))["counter"]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        meshctx._GROUPS.clear()
    fake_s = time.perf_counter() - t0
    ops = {k: (fake["bytes_by_op"].get(k), v)
           for k, v in real["bytes_by_op"].items()
           if fake["bytes_by_op"].get(k) != v}
    ops.update({k: (v, None) for k, v in fake["bytes_by_op"].items()
                if k not in real["bytes_by_op"]})
    for k in ("kernel_launches", "flops_by_class", "hbm_bytes",
              "collective_bytes"):
        require(real[k] == fake[k], f"dry run vs the real step: {k} "
                f"{fake[k]} != {real[k]}; bytes by op (dry run, real) "
                f"where they differ: {ops}")
    return {"real": real, "real_s": real_s, "fake_s": fake_s}


def mesh_ssm_worker(rank: int, init_file: str, job: dict, results) -> None:
    """One rank of ``mesh_ssm``: device 0, a gloo group of two."""
    import traceback
    try:
        import torch
        import torch.distributed as dist
        sys.path.insert(0, str(ROOT / "src"))
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.use_deterministic_algorithms(True)
        torch.utils.deterministic.fill_uninitialized_memory = False
        dist.init_process_group("gloo", init_method=f"file://{init_file}",
                                rank=rank, world_size=2)
        from repro_torch.configs import get_config
        from repro_torch.core.calibration import CalibrationState
        from repro_torch.launch import mesh as mesh_lib
        from repro_torch.launch import serve
        from repro_torch.models import model
        dev = torch.device("cuda", 0)
        out = {}
        # (a) mamba2 on 1 x 2
        cfg = ssm_config()
        params = model.init_params(0, cfg, device=dev)
        calib = CalibrationState(windows={
            k: torch.from_numpy(v) for k, v in job["windows"].items()})
        prompts = torch.from_numpy(job["prompts"]).to(dev)
        forced = torch.from_numpy(job["forced"]).to(dev)
        mesh = mesh_lib.make_test_mesh(1, 2, "cuda")
        with torch.no_grad():
            sites = ssm_sites(mesh, dev)
            reset_all_launches()
            served = serve.serve_static(
                cfg, SSM_BATCH, SSM_PROMPT, SSM_GEN, calib=calib,
                device=dev, params=params, prompts=prompts, mesh=mesh)
            torch.cuda.synchronize()
            launches = launches_now()
            logits = {"plan": [x.numpy() for x in forced_logits(
                params, cfg, calib, prompts, forced, dev, mesh)],
                "plain": [x.numpy() for x in forced_logits(
                    params, cfg.replace(tdvmm_plan=None), None, prompts,
                    forced, dev, mesh)]}
        out["ssm"] = dict(sites=sites, launches=launches,
                          tokens=served["tokens"].numpy(), logits=logits,
                          prefill_s=served["prefill_s"],
                          decode_s=served["decode_s"])
        del params
        torch.cuda.empty_cache()
        # (b) one qwen QAT step on 1 x 2
        t0 = time.perf_counter()
        out["qat"] = qat_tp_step(dev, mesh)
        out["qat"]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        # (c) zamba2 on 2 x 1, batch 1, a sequence-split cache
        hcfg = get_config(HYB_ARCH).replace(dtype="float32")
        hparams = model.init_params(0, hcfg, device=dev)
        hprompt = torch.from_numpy(job["hprompt"]).to(dev)
        hforced = torch.from_numpy(job["hforced"]).to(dev)
        mesh = mesh_lib.make_test_mesh(2, 1, "cuda")
        reset_all_launches()
        t0 = time.perf_counter()
        with torch.no_grad():
            hl = forced_logits(hparams, hcfg, None, hprompt, hforced, dev,
                               mesh)
        torch.cuda.synchronize()
        out["hyb"] = dict(logits=[x.numpy() for x in hl],
                          cache_bytes=cache_bytes(
                              hcfg, 1, MESH_HYB_PROMPT + MESH_HYB_GEN, dev,
                              mesh),
                          launches=launches_now(),
                          seconds=time.perf_counter() - t0)
        dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    results.close()
    results.join_thread()
    os._exit(0)


def qat_sites(cfg) -> int:
    """TD-VMM launches of one layer's forward: attn.qkv (one grouped
    launch), attn.out, ffn.in (gate and up), ffn.out."""
    return 2 + (2 if cfg.act == "silu_glu" else 1) + 1


def train_full_width(dev, workdir: Path) -> dict:
    """qwen1.5-0.5b at full width (24 layers, bf16, random weights from
    seed 0), every linear a 6-bit TD-VMM site (the CLI's --tdvmm), trained
    through ``launch/train.train_loop``: AdamW at lr 1e-3 with 2 warmup
    steps, SyntheticLM seed 0, 4 x 512 tokens a step, 8 steps, remat
    "minimal".  Every loss and gradient norm finite, the last loss below the
    first, and B2 launched exactly sites x layers x (steps + recomputes):
    each block's forward runs once and once more when the backward
    recomputes it, and nothing else launches."""
    import torch
    from repro_torch.configs import OptimizerConfig, RunConfig
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import train

    cfg = qat_config()
    shape = ShapeConfig("qat", QAT_SEQ, QAT_BATCH, "train",
                        microbatch_per_shard=QAT_BATCH)
    run = RunConfig(model=cfg, shape=shape, seed=0,
                    optimizer=OptimizerConfig(lr=1e-3, warmup_steps=2,
                                              total_steps=QAT_STEPS),
                    checkpoint_dir=str(workdir / "qat"),
                    checkpoint_every=10 * QAT_STEPS)
    reset_all_launches()
    out = train.train_loop(run, QAT_STEPS, log_every=1, device=dev)
    torch.cuda.synchronize()
    launches = launches_now()
    hist = out["history"]
    require(len(hist) == QAT_STEPS, f"qat: {len(hist)} logged steps")
    for h in hist:
        require(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"]),
                f"qat step {h['step']}: loss {h['loss']}, gnorm "
                f"{h['grad_norm']}")
    require(hist[-1]["loss"] < hist[0]["loss"],
            f"qat: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}")
    per_fwd = qat_sites(cfg) * cfg.n_layers
    want = dict.fromkeys(launches, 0) | {"calibrated": per_fwd * 2 * QAT_STEPS}
    require(launches == want, f"qat launches {launches} != {want}")
    return dict(cfg=cfg, run=run, out=out, launches=launches,
                formula=f"{qat_sites(cfg)} sites x {cfg.n_layers} layers x "
                f"({QAT_STEPS} steps + {QAT_STEPS} recomputes)")


def profile_train_step(res: dict) -> dict:
    """One more training step of the full-width QAT run under the
    profiler: ms per step, device-busy share, the largest device kernels."""
    from repro_torch.data.pipeline import DataConfig, make_pipeline
    from repro_torch.launch import steps
    from repro_torch.optim.optimizer import make_optimizer

    run, state = res["run"], res["out"]["state"]
    step_fn = steps.make_train_step(res["cfg"], run,
                                    make_optimizer(run.optimizer))
    batch = make_pipeline(res["cfg"], run.shape,
                          DataConfig(seed=run.seed)).batch_at(QAT_STEPS)
    step_fn(state, batch)                                  # warm
    wall, by_name, kernels = device_profile(lambda: step_fn(state, batch))
    dev_us = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return dict(ms_per_step=wall * 1e3, kernels=kernels,
                device_busy_share=dev_us / 1e6 / wall,
                device_ms=dev_us / 1e3,
                tdvmm_device_share=sum(v for k, v in by_name.items()
                                       if "tdvmm::" in k) / max(dev_us, 1e-9),
                top_kernels=[(k[:70], v / max(dev_us, 1e-9))
                             for k, v in top])


def noisy_steps(dev, params) -> dict:
    """Two noisy training steps (loss and gradients) of the full-width qwen
    with programming noise at every site, through ``models/model.loss_fn``
    with a key: every site's codes are float32 off the integer grid, so
    every launch takes the 3xTF32 storage.  The first step under the global
    config (B2 at every site), the second with ffn.in chained into ffn.out
    (ffn.in then has no readout: B1 fused)."""
    import torch
    from repro_torch.configs import TDVMMPlan, tdvmm_rule
    from repro_torch.data.pipeline import DataConfig, make_pipeline
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import model
    from repro_torch.tree import leaves

    cfg = qat_config(noise=True)
    chained = cfg.replace(tdvmm_plan=TDVMMPlan(
        rules=(tdvmm_rule("ffn.in", chain=True),)))
    n_in = 2 if cfg.act == "silu_glu" else 1
    per = cfg.n_layers * 2                 # a forward and its recompute
    batch = make_pipeline(cfg, ShapeConfig("qat", QAT_SEQ, QAT_BATCH,
                                           "train"),
                          DataConfig(seed=1)).batch_at(0)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    out = {"losses": [], "launches": dict.fromkeys(launches_now(), 0)}
    ps = leaves(params)
    for key, (name, c, want) in enumerate((
            ("global", cfg, {"calibrated_f32x3": qat_sites(cfg) * per}),
            ("ffn_chained", chained,
             {"fused_f32x3": n_in * per,
              "calibrated_f32x3": (qat_sites(cfg) - n_in) * per}))):
        reset_all_launches()
        for p in ps:
            p.requires_grad_(True)
        total, metrics = model.loss_fn(params, batch, c, key=key + 1)
        grads = torch.autograd.grad(total, ps)
        for p in ps:
            p.requires_grad_(False)
        torch.cuda.synchronize()
        got = launches_now()
        want = dict.fromkeys(got, 0) | want
        require(got == want, f"noisy {name}: launches {got} != {want}")
        require(math.isfinite(float(total.detach())),
                f"noisy {name}: loss {float(total.detach())}")
        require(all(bool(torch.isfinite(g).all()) for g in grads),
                f"noisy {name}: non-finite gradients")
        out["losses"].append((name, float(metrics["loss"])))
        out["launches"] = {k: out["launches"][k] + got[k] for k in got}
        del grads
    return out


def qat_case_study(dev) -> dict:
    """The paper's case study end to end on the card: the 10 x 10 x 10
    perceptron trained with TD-VMM QAT (300 SGD steps, B2 at both layers of
    every forward), then deployed through B4 with DIBL.  Digital twin >=
    0.9, circuit > 0.8 (the example's own assert), exact launch counts."""
    from repro_torch.launch import perceptron

    reset_all_launches()
    out = perceptron.qat_case_study(dev)
    launches = launches_now()
    want = dict.fromkeys(launches, 0) | {
        "calibrated": 2 * (perceptron.QAT_STEPS + 1), "crossing": 2}
    require(launches == want, f"qat case study: launches {launches} != "
            f"{want}")
    require(out["acc_digital"] >= 0.9,
            f"qat case study: digital twin {out['acc_digital']:.3f} < 0.9")
    require(out["acc_circuit"] > 0.8,
            f"qat case study: circuit {out['acc_circuit']:.3f} <= 0.8")
    require(out["max_err"] <= TD_ATOL,
            f"qat case study: circuit {out['max_err']:.3g} from the closed "
            "form")
    out["launches"] = launches
    return out


class CodeTape:
    """The int8 codes of every ``quant.encode_input`` and
    ``quant.program_weights`` call, in call order.  ``record``: the card's,
    kept on the host.  ``replay``: the CPU's run takes the card's codes in
    place of its own (its scales and straight-through terms stay its own),
    and ``flips`` counts, by kind, contraction width K (which tells the
    sites apart) and step, the codes the CPU would have rounded to another
    level; ``jump`` is the largest such move."""

    def __init__(self):
        self.codes, self.pos, self.step = [], 0, 0
        self.flips: dict[tuple[str, int, int], int] = {}
        self.jump = 0

    def first_flip(self) -> int | None:
        return min((st for *_, st in self.flips), default=None)

    def install(self, mode: str):
        """Wrap the two quantizers; returns the function that unwraps them."""
        import dataclasses
        import torch
        from repro_torch.core import quant
        saved = {n: getattr(quant, n)
                 for n in ("encode_input", "program_weights")}

        def wrap(kind, fn):
            def run(*a, **kw):
                q = fn(*a, **kw)
                require(q.codes.dtype == torch.int8,
                        f"code tape: {kind} gave {q.codes.dtype} codes")
                if mode == "record":
                    self.codes.append(q.codes.detach().cpu())
                    return q
                want = self.codes[self.pos]
                self.pos += 1
                require(want.shape == q.codes.shape,
                        f"code tape: {kind} call {self.pos} is "
                        f"{tuple(q.codes.shape)} here, {tuple(want.shape)} "
                        "on the card")
                jump = (q.codes.to(torch.int16) - want).abs()
                moved = int((jump > 0).sum())
                if moved:
                    k = want.shape[-1 if kind == "input" else -2]
                    key = (kind, k, self.step)
                    self.flips[key] = self.flips.get(key, 0) + moved
                    self.jump = max(self.jump, int(jump.max()))
                return dataclasses.replace(q, codes=want)
            return run

        quant.encode_input = wrap("input", saved["encode_input"])
        quant.program_weights = wrap("weight", saved["program_weights"])

        def undo():
            for n, fn in saved.items():
                setattr(quant, n, fn)
        return undo


def small_train_agreement(dev) -> dict:
    """Smoke-width training (float32), the same weights and batches on the
    card (B1/B2) and on the CPU (plain versions): qwen (2 layers) under the
    global --tdvmm config and under ffn_chained (B1 no-readout into B2),
    and mamba2 (2 layers; its scan ``ssd_plain`` under autograd on both)
    with TD-VMM off and under the global config.  The step-0 loss within
    SMALL_TRAIN_LOSS_RTOL0 and every leaf's step-0 gradient within
    SMALL_TRAIN_GRAD_RTOL of its max|g|; then 3 steps of the train step
    (AdamW), each loss within SMALL_TRAIN_LOSS_RTOL.

    Under TD-VMM the CPU runs twice: on its own codes, and on the card's
    (``CodeTape``), which counts the codes the two devices' float32 sums
    put on two sides of a rounding edge.  The run on the card's codes is
    held to every bound above.  The run on its own codes is held to them
    at every step before the first with such a flip; from that step on a
    6-bit level that moved is another result, and the replay holds it."""
    import torch
    from repro_torch.configs import (OptimizerConfig, RunConfig, get_config,
                                     smoke)
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.layers import TDVMMLayerConfig
    from repro_torch.data.pipeline import DataConfig, make_pipeline
    from repro_torch.launch import steps
    from repro_torch.models import model
    from repro_torch.optim.optimizer import make_optimizer
    from repro_torch.tree import leaves_with_paths

    def train(cfg, run, pipe, p, tape=None, mode=None):
        """(step-0 loss, step-0 gradients, the losses of 3 AdamW steps)"""
        undo = tape.install(mode) if tape else (lambda: None)
        if tape:
            tape.step = 0
        try:
            named = leaves_with_paths(p)
            for _, t in named:
                t.requires_grad_(True)
            batch = {k: torch.as_tensor(v).to(p["ln_f"]["scale"].device)
                     for k, v in pipe.batch_at(0).items()}
            total, _ = model.loss_fn(p, batch, cfg)
            grads = torch.autograd.grad(total, [t for _, t in named])
            for _, t in named:
                t.requires_grad_(False)
            opt = make_optimizer(run.optimizer)
            step_fn = steps.make_train_step(cfg, run, opt)
            st = steps.TrainState(p, opt.init(p))
            losses = []
            for i in range(3):
                if tape:
                    tape.step = i
                st, m = step_fn(st, pipe.batch_at(i))
                losses.append(float(m["loss"]))
        finally:
            undo()
        return (float(total.detach()),
                {n: g.detach().cpu() for (n, _), g in zip(named, grads)},
                losses)

    def held(name, ref, got, upto=3):
        """got's step-0 loss, gradients and first ``upto`` later losses
        against ref's; returns (loss0, worst gradient, its leaf, later)"""
        (l_c, g_c, ls_c), (l_d, g_d, ls_d) = ref, got
        loss0 = abs(l_d - l_c) / abs(l_c)
        require(loss0 <= SMALL_TRAIN_LOSS_RTOL0,
                f"small train {name}: step-0 loss {l_d} vs {l_c}")
        grad, worst = 0.0, ""
        for n, gc in g_c.items():
            scale = float(gc.abs().max())
            if scale == 0.0:
                require(float(g_d[n].abs().max()) == 0.0,
                        f"small train {name}: {n} gradient")
                continue
            rel = float((g_d[n] - gc).abs().max()) / scale
            require(rel <= SMALL_TRAIN_GRAD_RTOL,
                    f"small train {name}: {n} gradient {rel:.3g} of max|g|")
            if rel > grad:
                grad, worst = rel, n
        later = [abs(a - b) / abs(b) for a, b in zip(ls_d, ls_c)]
        require(all(r <= SMALL_TRAIN_LOSS_RTOL for r in later[:upto]),
                f"small train {name}: losses {ls_d} vs {ls_c}")
        return loss0, grad, worst, max(later)

    td = TDVMMLayerConfig(enabled=True, bits=6, weight_bits=6)
    base = smoke(get_config(ARCH))
    ssm_base = smoke(get_config(SSM_ARCH))
    out = {}
    for name, cfg in (
            ("qwen tdvmm", base.replace(tdvmm=td)),
            ("qwen ffn_chained",
             base.replace(tdvmm_plan=plans()["ffn_chained"])),
            ("mamba2", ssm_base),
            ("mamba2 tdvmm", ssm_base.replace(tdvmm=td))):
        run = RunConfig(model=cfg, shape=ShapeConfig("small", 16, 4, "train",
                                                     microbatch_per_shard=4),
                        optimizer=OptimizerConfig(lr=1e-3, warmup_steps=2,
                                                  total_steps=3))
        pipe = make_pipeline(cfg, run.shape, DataConfig(seed=0))
        p_cpu = model.init_params(0, cfg, device="cpu")
        quantized = cfg.tdvmm.enabled or cfg.tdvmm_plan is not None
        tape = CodeTape() if quantized else None
        card = train(cfg, run, pipe, _to(p_cpu, dev), tape, "record")
        cpu = train(cfg, run, pipe, p_cpu)
        r = {}
        if tape:
            # the card's codes: every bound, every step
            replay = train(cfg, run, pipe,
                           model.init_params(0, cfg, device="cpu"), tape,
                           "replay")
            require(tape.pos == len(tape.codes),
                    f"small train {name}: the CPU quantized {tape.pos} "
                    f"times, the card {len(tape.codes)}")
            _, r["replay_grad"], _, r["replay_losses"] = held(
                name + " (the card's codes)", replay, card)
            r.update(flips={f"{kind} K{k} step {st}": v
                            for (kind, k, st), v in sorted(tape.flips.items())},
                     jump=tape.jump, calls=len(tape.codes))
        first = tape.first_flip() if tape else None
        loss0, grad, worst, later = held(name, cpu, card,
                                         3 if first is None else first)
        out[name] = dict(r, loss0=loss0, grad=grad, worst=worst,
                         losses=later, first_flip=first)
    return out


# ---------------------------------------------------------------------------
# Phase 5: the card's kernel path against the CPU plain path, small input
# ---------------------------------------------------------------------------
def small_input_agreement(dev) -> float:
    """Smoke-width qwen (2 layers, float32), the same weights on the card
    (kernels) and on the CPU (plain versions): equal greedy tokens, logits
    within SMALL_LOGIT_RTOL of max|logit|."""
    import torch
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import model

    cfg = smoke(get_config(ARCH)).replace(tdvmm_plan=plans()["ffn_unchained"])
    p_cpu = model.init_params(0, cfg, device="cpu")
    p_dev = {"embed": {"table": p_cpu["embed"]["table"].to(dev)},
             "ln_f": {"scale": p_cpu["ln_f"]["scale"].to(dev)},
             "blocks": {"seg0": [_to(layer, dev)
                                 for layer in p_cpu["blocks"]["seg0"]]}}
    prompt = torch.arange(3, 19).reshape(1, 16)
    calib = model.calibrate(p_cpu, {"inputs": prompt.repeat(2, 1)}, cfg,
                            device="cpu")
    worst = 0.0
    for p, d in ((p_cpu, "cpu"), (p_dev, dev)):
        caches = model.init_caches(cfg, 1, 24, d)
        logits, caches = model.prefill_step(p, {"inputs": prompt.to(d)},
                                            caches, cfg, calib=calib)
        rows, toks = [logits[0, -1].float().cpu()], []
        for _ in range(7):
            toks.append(int(torch.argmax(rows[-1])))
            logits, caches = model.decode_step(
                p, {"inputs": torch.tensor([[toks[-1]]], device=d)}, caches,
                cfg, calib=calib)
            rows.append(logits[0, -1].float().cpu())
        if d == "cpu":
            ref_rows, ref_toks = torch.stack(rows), toks
        else:
            got = torch.stack(rows)
            worst = float((got - ref_rows).abs().max()
                          / ref_rows.abs().max())
            require(toks == ref_toks, f"card tokens {toks} != cpu {ref_toks}")
    require(worst <= SMALL_LOGIT_RTOL,
            f"card logits differ from cpu by {worst:.3g}")
    return worst


def small_ssm_agreement(dev) -> float:
    """Smoke-width mamba2 (2 layers, float32, chunk 8) under ssm_unchained,
    the same weights on the card (B1, B3) and on the CPU (plain versions):
    equal greedy tokens, logits within SMALL_SSM_LOGIT_RTOL of max|logit|.
    The 13-token prompt is not a multiple of the chunk."""
    import torch
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import model

    cfg = smoke(get_config(SSM_ARCH)).replace(tdvmm_plan=ssm_plan())
    p_cpu = model.init_params(0, cfg, device="cpu")
    p_dev = _to(p_cpu, dev)
    prompt = torch.arange(3, 29).reshape(2, 13)
    calib = model.calibrate(p_cpu, {"inputs": prompt}, cfg, device="cpu")
    worst = 0.0
    for p, d in ((p_cpu, "cpu"), (p_dev, dev)):
        caches = model.init_caches(cfg, 2, 24, d)
        logits, caches = model.prefill_step(p, {"inputs": prompt.to(d)},
                                            caches, cfg, calib=calib)
        rows, toks = [logits[:, -1].float().cpu()], []
        for _ in range(7):
            toks.append(torch.argmax(rows[-1][:, :cfg.vocab_size], -1))
            logits, caches = model.decode_step(
                p, {"inputs": toks[-1][:, None].to(d)}, caches, cfg,
                calib=calib)
            rows.append(logits[:, -1].float().cpu())
        toks = torch.stack(toks, 1)
        if d == "cpu":
            ref_rows, ref_toks = torch.stack(rows), toks
        else:
            got = torch.stack(rows)
            worst = float((got - ref_rows).abs().max()
                          / ref_rows.abs().max())
            require(torch.equal(toks, ref_toks),
                    f"mamba2 card tokens {toks.tolist()} != cpu "
                    f"{ref_toks.tolist()}")
    require(worst <= SMALL_SSM_LOGIT_RTOL,
            f"mamba2 card logits differ from cpu by {worst:.3g}")
    return worst


def small_moe_agreement(dev, plan) -> float:
    """Smoke-width mixtral (2 layers, d_model 64, 4 experts top-2, window
    8, float32) under ``plan``, the same weights on the card (B1/B2 in the
    plan's code storages) and on the CPU (plain versions): equal greedy
    tokens, logits within SMALL_MOE_LOGIT_RTOL of max|logit|.  The 13-token
    prompt is longer than the window, so the cache rolls."""
    import torch
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import model

    cfg = smoke(get_config(MOE_ARCH)).replace(tdvmm_plan=plan)
    p_cpu = model.init_params(0, cfg, device="cpu")
    p_dev = _to(p_cpu, dev)
    prompt = torch.arange(3, 29).reshape(2, 13)
    calib = model.calibrate(p_cpu, {"inputs": prompt}, cfg, device="cpu")
    worst = 0.0
    for p, d in ((p_cpu, "cpu"), (p_dev, dev)):
        caches = model.init_caches(cfg, 2, 24, d)
        logits, caches = model.prefill_step(p, {"inputs": prompt.to(d)},
                                            caches, cfg, calib=calib)
        rows, toks = [logits[:, -1].float().cpu()], []
        for _ in range(7):
            toks.append(torch.argmax(rows[-1][:, :cfg.vocab_size], -1))
            logits, caches = model.decode_step(
                p, {"inputs": toks[-1][:, None].to(d)}, caches, cfg,
                calib=calib)
            rows.append(logits[:, -1].float().cpu())
        toks = torch.stack(toks, 1)
        if d == "cpu":
            ref_rows, ref_toks = torch.stack(rows), toks
        else:
            got = torch.stack(rows)
            worst = float((got - ref_rows).abs().max()
                          / ref_rows.abs().max())
            require(torch.equal(toks, ref_toks),
                    f"mixtral card tokens {toks.tolist()} != cpu "
                    f"{ref_toks.tolist()}")
    require(worst <= SMALL_MOE_LOGIT_RTOL,
            f"mixtral card logits differ from cpu by {worst:.3g}")
    return worst


def small_hybrid_agreement(dev) -> float:
    """Smoke-width zamba2 (4 layers, a shared block every 2, float32, chunk
    8) under hybrid_unchained with FLASH_THRESHOLD lowered to 8 (blocks of
    4), so every shared-block prefill of the 13-token prompt runs flash;
    the same weights on the card (B1, B3) and on the CPU (plain versions):
    equal greedy tokens, logits within SMALL_HYB_LOGIT_RTOL of
    max|logit|."""
    import torch
    from repro_torch.configs import get_config, smoke
    from repro_torch.models import attention, model

    cfg = smoke(get_config(HYB_ARCH)).replace(tdvmm_plan=hybrid_plan())
    p_cpu = model.init_params(0, cfg, device="cpu")
    p_dev = _to(p_cpu, dev)
    prompt = torch.arange(3, 29).reshape(2, 13)
    saved = {k: getattr(attention, k) for k in (
        "FLASH_THRESHOLD", "FLASH_BLOCK_Q", "FLASH_BLOCK_KV")}
    attention.FLASH_THRESHOLD, attention.FLASH_BLOCK_Q = 8, 4
    attention.FLASH_BLOCK_KV = 4
    try:
        calib = model.calibrate(p_cpu, {"inputs": prompt}, cfg, device="cpu")
        worst = 0.0
        for p, d in ((p_cpu, "cpu"), (p_dev, dev)):
            caches = model.init_caches(cfg, 2, 24, d)
            logits, caches = model.prefill_step(p, {"inputs": prompt.to(d)},
                                                caches, cfg, calib=calib)
            rows, toks = [logits[:, -1].float().cpu()], []
            for _ in range(7):
                toks.append(torch.argmax(rows[-1][:, :cfg.vocab_size], -1))
                logits, caches = model.decode_step(
                    p, {"inputs": toks[-1][:, None].to(d)}, caches, cfg,
                    calib=calib)
                rows.append(logits[:, -1].float().cpu())
            toks = torch.stack(toks, 1)
            if d == "cpu":
                ref_rows, ref_toks = torch.stack(rows), toks
            else:
                got = torch.stack(rows)
                worst = float((got - ref_rows).abs().max()
                              / ref_rows.abs().max())
                require(torch.equal(toks, ref_toks),
                        f"zamba2 card tokens {toks.tolist()} != cpu "
                        f"{ref_toks.tolist()}")
    finally:
        for k, v in saved.items():
            setattr(attention, k, v)
    require(worst <= SMALL_HYB_LOGIT_RTOL,
            f"zamba2 card logits differ from cpu by {worst:.3g}")
    return worst


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


# ---------------------------------------------------------------------------
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} does not hold the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import attention

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    say("env", f"{kind} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # deterministic kernels for the batched == solo check, without the
    # NaN fill of every fresh allocation that the mode adds by default
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False

    phase_done("environment")
    build_s = kernels.build_all(verbose=True)
    say("build", f"B1 + B2 (int8, int4 and f32 codes) + B3 + B4 built in "
        f"{build_s:.1f} s")
    tdvmm_build_report()
    ssd_build_report()
    crossing_build_report()
    phase_done("build")

    rows = []
    for i, case in enumerate(kernel_cases()):
        row = run_case(case, dev, seed=i)
        rows.append((case, row))
        lib = row["library_ms"]
        say("kernel", f"{row['kernel']:<17} {row['codes']:<4} "
            f"{row['mode']:<15} E={row['e']} "
            f"x{row['ex']} M={row['m']:<4} K={row['k']:<5} N={row['n']:<5} "
            f"max_abs_err={row['max_abs_err']} kernel_ms={row['ms']:.5f} "
            f"plain_ms={row['plain_ms']:.5f} bound_ms={row['bound_ms']:.5f} "
            f"({row['bound_by']}) library_ms="
            f"{'n/a' if lib is None else format(lib, '.5f')}"
            f"{' (rows padded to 32)' if row['library_padded'] else ''}"
            + ("" if row["library_tf32_ms"] is None else
               f" library_tf32_ms={row['library_tf32_ms']:.5f}")
            + f" tile={row['tile']}"
            + (f" fill={row['fill']}" if row.get("fill") else "")
            + (f" members={row['members']}" if row.get("members") else "")
            + (" unaligned" if row.get("unaligned") else "")
            + (f" shard={case['tp']}" if case.get("tp") else ""))
    for i, case in enumerate(f32x3_cases()):
        row = run_f32x3_case(case, dev, seed=300 + i)
        rows.append((case, row))
        say("kernel", f"{row['kernel']:<17} f32x3 {row['data']:<5} "
            f"{row['mode']:<15} E={row['e']} x{row['ex']} M={row['m']:<4} "
            f"K={row['k']:<5} N={row['n']:<5} two calls equal, "
            + ("bitwise the plain version" if row["data"] != "noisy" else
               "within the exact readout's rounding")
            + (f", accumulator {row['acc_rel_err']:.3g} of sum|x||w| "
               f"(plain {row['acc_rel_err_plain']:.3g}, gate "
               f"{row['gate']:.3g})" if row["acc_rel_err"] is not None
               else f", readout flips at ties: kernel {row['flips']}, plain "
                    f"{row['flips_plain']}")
            + f" max_abs_err={row['max_abs_err']:.3g} "
            f"kernel_ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f} "
            f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}) "
            f"library_ms={row['library_ms']:.5f} tile={row['tile']}")
    for i, case in enumerate(ssd_cases()):
        row = run_ssd_case(case, dev, seed=100 + i)
        rows.append((case, row))
        say("kernel", f"ssd_scan {row['dtype']:<8} B={row['b']} L={row['l']} "
            f"H={row['h']} P={row['p']} G={row['g']} S={row['s']} "
            f"Q={row['q']} max_abs_err={row['max_abs_err']:.3g} rel_err "
            f"y={row['rel_err_y']:.3g} state={row['rel_err_state']:.3g} "
            f"kernel_ms={row['ms']:.5f} "
            + ("" if "earlier_ms" not in case else
               f"earlier_ms={case['earlier_ms']} (the CUDA-core kernel, read "
               "before, not in this run) ")
            + f"plain_ms={row['plain_ms']:.5f} "
            f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}) "
            "library_ms=none"
            + (" unaligned" if case.get("unaligned") else "")
            + ("" if "device_us" not in row else " device_us " + ", ".join(
                f"{k} {v:.1f}" for k, v in row["device_us"].items())))
    ssd_limits(dev)
    for i, case in enumerate(crossing_cases()):
        row = run_crossing_case(case, dev, seed=200 + i)
        rows.append((case, row))
        what = (f"{row['quadrants']}-quadrant" if row["case"] == "physics"
                else row["case"])
        say("kernel", f"crossing {what} B={row['b']} "
            f"K={row['k']} N={row['n']} iters={row['iters']} "
            f"general_steps={row['general_steps']} "
            f"max|dt|/T={row['rel_err_t']:.3g} (two calls equal) "
            f"kernel_ms={row['ms']:.5f} "
            f"plain_ms={row['plain_ms']:.5f} bound_ms={row['bound_ms']:.5f} "
            f"({row['bound_by']}) library_ms=none")
    phase_done("kernels")
    au = autotune_phase(dev)
    say("autotune", f"(a) sweep of {len(au['rows'])} shapes (the main path's "
        f"serving shapes and {len(AUTOTUNE_WORK)} of M 512), every tile "
        "bitwise the others and the plain version, written to a temporary "
        f"table: picks equal to the committed table's at {au['agree']} of "
        f"{len(au['rows'])}; (b) the committed table's tile bitwise "
        f"plan_tile's at the {au['checked']} serving entries (B1 raw, B1 "
        f"fused, B2; where they differ: {au['differ'] or 'none'}); "
        f"plan_kernel {au['plan_us']:.3f} us of host time a call; phase "
        f"{au['seconds']:.1f} s | {card}")
    del au
    phase_done("autotune")
    fl = flash_on_card(dev)
    say("flash", f"{HYB_ARCH} shared block, B {HYB_BATCH} x S {HYB_PROMPT} x "
        f"32 heads x 80, float32: flash within "
        f"{fl['err']['flash']:.3g}, block-skip flash within "
        f"{fl['err']['flash_blocks']:.3g} of the dense softmax (gate "
        f"{FLASH_TOL} + {FLASH_TOL} |dense|); ms float32 "
        + ", ".join(f"{k} {v:.3f}" for k, v in fl["ms"].items())
        + "; ms bfloat16 "
        + ", ".join(f"{k} {v:.3f}" for k, v in fl["ms_bf16"].items()))
    del fl
    torch.cuda.empty_cache()
    fg = flash_grad_on_card(dev)
    say("flash", f"{HYB_ARCH} shared block backward, B {HYB_BATCH} x S "
        f"{HYB_PROMPT}, float32: gradients through flash against the dense "
        f"softmax's (gate {FLASH_TOL} + {FLASH_TOL} |g|), max |gap| / max "
        "relative gap / max |g_dense|: "
        + "; ".join(f"{k} {a:.3g} / {r:.3g} / {m:.3g}"
                    for k, (a, r, m) in fg["gap"].items())
        + "; forward + backward ms: "
        + ", ".join(f"{n} q/k/v {t['core']:.3f} block {t['block']:.3f}"
                    for n, t in fg["ms"].items()))
    del fg
    torch.cuda.empty_cache()
    phase_done("flash")

    ap = api_phase(dev)
    say("api", f"repro_torch.core.TDVMMLinear {FFN_SHAPES[0][0]} -> "
        f"{FFN_SHAPES[0][1]}, bf16, int8 codes at p = 6, bias on, "
        f"{API_ROWS} rows: forward bitwise td_matmul + b (1 B2 launch), "
        f"calibrate == calibrate_out_scale = {ap['window']:.6g} (1 B1 raw), "
        f"pinned forward bitwise td_matmul under it (1 B1 fused); "
        f"launches {ap['launches']}; phase "
        f"{ap['seconds']:.2f} s | {card}")
    del ap
    phase_done("api")

    served, cache = [], {}
    for name, plan in plans().items():
        out = serve_plan(name, plan, dev, cache)
        served.append(out)
        say("serve", f"{name}: {out['generated_tokens']} tokens for "
            f"{out['requests']} requests in {out['steps']} steps "
            f"({out['prefill_steps']} prefill + {out['decode_steps']} "
            f"decode), {out['tokens_per_s']:.2f} tokens/s "
            f"({out['serve_s']:.2f} s), calibrate {out['calibrate_s']:.2f} s, "
            f"{out['fj_per_op']:.3f} fJ/Op, utilization "
            f"{out['utilization']:.3f}, launches calibrate "
            f"{out['launches_calibrate']} total {out['launches']}, "
            "batched == solo")
        say("autotune", f"(c) {name}: report platform sm_90a, every entry a "
            f"table hit ({', '.join(out['autotune_entries'])}); B1/B2 "
            f"launches by tile {out['by_tile']}, each at its entry's tile")
    for out in served:
        prof = profile_plan(out)
        say("profile", f"{out['plan']}: {prof['steps'][0]} prefill + "
            f"{prof['steps'][1]} decode steps in {prof['wall_s']:.3f} s, "
            f"{prof['kernels_per_step']:.1f} device kernels per step, "
            f"device busy {prof['device_busy_share']:.3f}, TD-VMM kernels "
            f"{prof['tdvmm_device_share']:.3f} of device time; top "
            + "; ".join(f"{k} {v:.3f}" for k, v in prof["top_kernels"]))
    attention.set_kv_cache_int8(True)
    try:
        out = serve_plan("ffn_unchained", plans()["ffn_unchained"], dev, cache)
    finally:
        attention.set_kv_cache_int8(False)
    served.append(out)
    say("serve", f"ffn_unchained + int8 KV: {out['generated_tokens']} tokens "
        f"for {out['requests']} requests in {out['steps']} steps, every "
        f"request its full budget, {out['tokens_per_s']:.2f} tokens/s "
        f"({out['serve_s']:.2f} s), launches calibrate "
        f"{out['launches_calibrate']} total {out['launches']}, int8 page "
        "pools, batched == solo")
    phase_done("serve qwen")

    fq = fault_qwen(dev, served[0], out)
    served.append({"launches": fq["launches"]})
    for tag in ("resume", "resume_int8"):
        say("fault", f"ffn_unchained {'bf16' if tag == 'resume' else 'int8'}"
            " page pools, killed, snapshotted to disk, restored into a fresh "
            "engine and resumed: unbroken streams, finish reasons and "
            f"{fq['steps']} steps at " + "; ".join(
                f"{r['where']} (step {r['step']}): {r['bytes']} bytes, save "
                f"{r['save_s']:.3f} s, restore {r['restore_s']:.3f} s"
                for r in fq[tag]))
    say("fault", f"transient step failure at step "
        f"{fq['kills']['first decode']}: 1 retry, streams unchanged; "
        f"persistent at step {fq['kills']['late decode']}: request "
        f"{fq['failed_rid']} failed after {fq['failed_tokens'][0]} of "
        f"{fq['failed_tokens'][1]} tokens (a prefix), its neighbours "
        "unchanged")
    for name in ("drift", "no drift"):
        r = fq[name]
        say("fault", f"{name}: {r['probes']} probes of {FAULT_PROBE[0]} x "
            f"{FAULT_PROBE[1]} tokens every {FAULT_CHECK_EVERY} steps "
            f"({min(r['probe_s']):.3f}-{max(r['probe_s']):.3f} s each), "
            f"max clip rate {r['max_clip']:.4g}, max |log window ratio| "
            f"{r['max_log_ratio']:.4g}, {r['recalibrations']} "
            "recalibrations in place (window tensors kept, step shapes 2), "
            f"launches {r['launches']}, serve {r['serve_s']:.2f} s"
            + (f"; events (step, clip rate, log ratio) {fq['drift_events']}"
               if name == "drift" else "; no events"))
    fault_bytes = [r["bytes"] for r in fq["resume"]]
    del fq
    phase_done("fault qwen")

    ob = observe_qwen(dev, served[0])
    served.append({"launches": ob["launches"]})
    a, b, c, d, e = (ob[k] for k in "abcde")
    say("observe", f"ffn_unchained with a metrics sink and a tracer: streams, "
        f"finish reasons and steps equal the untraced run's, step shapes 2, "
        f"B1 fused sites x steps, trace valid with every request's spans at "
        f"the report's steps; {a['events']} events {a['counts']}, trace "
        f"{a['trace_bytes']} bytes, JSONL {a['jsonl_bytes']} bytes in "
        f"{a['jsonl_lines']} lines ({a['observations']} observations over "
        f"{a['ticks']} ticks), alerts (step, value, median, MAD) "
        f"{a['alerts']}; sink + tracer {a['hook_us_per_tick']:.1f} us of "
        f"host time per tick; {a['step_ms']:.2f} ms per step traced, "
        f"{a['plain_step_ms']:.2f} untraced; clock {a['clock_s']:.4f} s "
        f"(slices {a['slices_s']:.4f} s) within wall {a['wall_s']:.4f} s")
    say("observe", f"sla (aging 4, priorities rid % 3): request "
        f"{b['deadline'][0]} given deadline {b['deadline'][1]} steps, "
        f"request {b['budget'][0]} a budget of {b['budget'][1]:.6g} J "
        f"(min {b['budget'][2]['min_energy_j']:.6g}, full "
        f"{b['budget'][2]['full_energy_j']:.6g}): {b['rejected']} rejected "
        f"(no token, no joule), {b['over_budget']} over budget after "
        f"{b['capped_tokens'][0]} of {b['capped_tokens'][1]} tokens (a "
        f"prefix), deadlines {b['deadline_hits']} hit / "
        f"{b['deadline_misses']} missed, {b['steps']} steps, admitted at "
        f"{b['admitted']} (FIFO {b['fifo_admitted']}); other streams "
        "unchanged; the default SlaConfig replays FIFO")
    say("observe", f"clip series: {c['observations']} probes of "
        f"{FAULT_PROBE[0]} x {FAULT_PROBE[1]} tokens every {OBSERVE_EVERY} "
        f"steps, drift (sigma 0.5, 3 repeats) at step {OBSERVE_DRIFT_AT}; "
        f"the drifted / clean probe max|z| {c['drift_ratio']}, windows "
        f"pinned at {OBSERVE_PIN} of the smaller {c['pinned']}; "
        f"(step, drifted) {c['seen']}; clean {c['clean']}, drifted "
        f"{c['after']}, each observation equal to a direct probe; limit "
        f"{c['limit']:.6g}, {c['alerts']} alerts, 0 recalibrations; probe "
        f"{c['probe_s']:.3f} s; launches {c['launches']}")
    say("observe", f"killed at step {d['step']} with a snapshot of "
        f"{d['bytes']} bytes (meta {d['meta_bytes']} bytes; the fault "
        f"phase's bf16 snapshots, with no sink or tracer, {fault_bytes}), "
        "restored with a fresh sink and tracer: unbroken streams, one trace "
        "document equal to the unbroken run's but its times, every series "
        "continued")
    say("observe", f"serve CLI --sla --metrics-jsonl --trace-out "
        f"--report-json and trace_report: {e['requests']} requests, "
        f"{e['rejected']} rejected, {e['over_budget']} over budget, "
        f"{e['steps']} steps, {e['metric_lines']} metric lines, bytes "
        f"{e['bytes']}, {e['seconds']:.1f} s")
    phase_done("observe qwen")

    mq = mesh_qwen(dev, served[0], served[1])
    served.append({"launches": mq["qat_launches"]})
    for name, r in mq["plans"].items():
        served.append({"launches": r["launches"]})
        say("mesh", f"{name}: the engine on a (1, 1) mesh (a world of one "
            f"over NCCL) == the meshless engine: streams, finish reasons, "
            f"finish steps, {r['steps']} steps, 2 step shapes, launches "
            f"{r['launches']}; serve {r['serve_s']:.2f} s (meshless "
            f"{r['meshless_s']:.2f} s)")
    say("mesh", f"qat: one full-width step ({QAT_BATCH} x {QAT_SEQ} tokens, "
        f"every linear 6-bit TD-VMM) on the (1, 1) mesh == the meshless "
        f"step, bitwise in all {mq['leaves']} state leaves and the metrics "
        f"(loss {mq['loss']:.4f}); launches {mq['qat_launches']}; "
        f"{mq['mesh_step_s']:.2f} s (meshless {mq['meshless_step_s']:.2f} "
        "s, the first step of this process's shapes)")
    say("mesh", "(b) two ranks on the card over gloo, which carries CUDA "
        "tensors for " + ", ".join(k for k, v in GLOO_CUDA.items() if v)
        + (": run" if mq["two_ranks"] else "; not for " + ", ".join(
            k for k, v in GLOO_CUDA.items() if not v) + ": (b) does not run"))
    if mq["two_ranks"]:
        for name, r in mq["b"].items():
            served.append({"launches": r["launches"]})
            order = " in TP order" if name == "tp" else ""
            say("mesh", f"(b) {'1 x 2 (TP)' if name == 'tp' else '2 x 1 (DP)'}"
                f", {r['total_slots']} slots: TD-VMM row (pinned, "
                "data-calibrated) and column sites on CUDA through gloo "
                f"bitwise the meshless sites; engine {r['steps']} steps, "
                f"launches B1 fused {r['launches']['fused']} + raw "
                f"{r['launches']['raw']} a rank, serve {r['serve_s']:.2f} s, "
                + ("streams, finish reasons, finish steps and steps"
                   if name == "tp" else "token streams and finish reasons")
                + f" == the meshless engine's{order}; teacher-forced "
                "logits, TD-VMM off and "
                f"ffn_unchained, == the meshless run's{order}, bitwise; "
                "against the meshless run: "
                f"{r['equal']} of 8 streams equal (first differing token "
                f"{r['first']}), logits of max|logit| TD-VMM off "
                f"{r['gaps']['plain']:.4g} (gate {TWO_RANK_RTOL}), "
                f"ffn_unchained {r['gaps']['plan']:.4g}")
    say("mesh", f"phase {mq['seconds']:.1f} s")
    phase_done("mesh qwen")
    dv = dryrun_vs_step(dev, served[0]["engine_args"])
    say("mesh", f"(d) dry run vs the real step: {ARCH} prefill 4 x 512 "
        "under ffn_unchained, data-calibrated: kernel calls "
        f"{dv['real']['kernel_launches']}, FLOPs "
        f"{dv['real']['flops_by_class']}, HBM bytes "
        f"{dv['real']['hbm_bytes']:.0f} counted around the real step == the "
        f"dry run's (fake tensors, a fake world of one); {dv['real_s']:.2f} "
        f"s (two counted calls), dry run {dv['fake_s']:.2f} s | {card}")
    del dv
    for o in served:
        o.pop("engine_args", None)
    del out, ob, cache, mq
    torch.cuda.empty_cache()
    phase_done("mesh ssm")

    ki = serve_kimi(dev)
    served.append({"launches": ki["launches"]})
    gb = 1e-9
    say("serve", f"{KIMI_ARCH}: full width, depth cut to {KIMI_LAYERS} of "
        f"{ki['full_depth']} layers: one layer is {ki['layer'] * gb:.2f} GB "
        f"in bf16 ({ki['full_depth']} would be "
        f"{ki['layer'] * ki['full_depth'] * gb:.0f} GB on an 80 GB card); "
        f"resident {ki['resident'] * gb:.2f} GB; capacity factor "
        f"{kimi_config().moe.capacity_factor}")
    say("serve", f"moe_unchained: {KIMI_ARCH} through the paged engine, "
        f"{ki['generated_tokens']} tokens for 8 requests in {ki['steps']} "
        f"steps ({ki['prefill_steps']} prefill + {ki['decode_steps']} "
        f"decode) in {ki['serve_s']:.2f} s "
        f"({ki['serve_s'] / ki['steps']:.3f} s a step), calibrate "
        f"{ki['calibrate_s']:.2f} s over {KIMI_CALIB[0]} x {KIMI_CALIB[1]} "
        f"tokens; experts at the {KIMI_FLOOR:g} window floor (no calibration "
        f"token) {ki['floor']}; peak allocated GB "
        + ", ".join(f"{k} {v * gb:.2f}" for k, v in ki["peak"].items())
        + f"; {ki['fj_per_op']:.3f} fJ/Op; launches calibrate "
        f"{ki['launches_calibrate']} total {ki['launches']}; requests "
        f"{KIMI_SOLO} served alone == batched ({ki['solo_s']:.2f} s); first "
        f"tokens {ki['tokens']}; phase {ki['seconds']:.1f} s")
    del ki
    phase_done("serve kimi")

    mk = mesh_kimi(dev)
    say("mesh", f"kimi: {KIMI_ARCH}'s attention at full width (one layer, "
        f"64 heads and 8 KV heads of 112) split by KV groups over a model "
        f"axis of {KIMI_MESH}, the {KIMI_MESH} shards from local_config and "
        f"sharding.shard one after another: {KIMI_MESH_PROMPT[0]} x "
        f"{KIMI_MESH_PROMPT[1]} prefill + {KIMI_MESH_GEN} decode steps on a "
        "dense cache; every shard's attention output before wo == the "
        "meshless layer's heads, the 16 wo partials summed in rank order == "
        "its output, bitwise, in the mesh's order (tp_order(16), q/k/v in "
        "the shards' column slices); cache bytes a shard "
        f"{mk['shard_cache_bytes']} = 1/8 of the meshless "
        f"{mk['cache_bytes']}; the mesh-order layer against the plain "
        f"meshless one: attention output {mk['gap_out']:.3g}, layer output "
        f"{mk['gap_layer']:.3g} of max|y|; shards {mk['shard_s']:.2f} s, "
        f"phase {mk['seconds']:.1f} s | {card}")
    del mk
    torch.cuda.empty_cache()
    phase_done("mesh kimi")

    ssm = serve_ssm(dev)
    served.append(ssm)
    say("serve", f"ssm_unchained: mamba2-1.3b full width, "
        f"{SSM_SERVE_LAYERS} of 48 layers, {SSM_BATCH} x "
        f"{SSM_PROMPT} prompt tokens + {SSM_GEN} new each: calibrate "
        f"{ssm['calibrate_s']:.3f} s, prefill {ssm['prefill_s']:.3f} s, "
        f"decode {ssm['decode_s']:.3f} s ({ssm['decode_tok_per_s']:.2f} "
        f"tokens/s), launches calibrate {ssm['launches_calibrate']} total "
        f"{ssm['launches']}, reversed batch == reversed streams, no NaN; "
        f"first tokens {ssm['tokens']}")
    prof = profile_static(ssm["args"], SSM_PROFILE_STEPS)
    for name, r in prof.items():
        say("profile", f"ssm_unchained {name}: {r['steps']} step(s) in "
            f"{r['wall_s']:.3f} s, {r['kernels_per_step']:.1f} device "
            f"kernels per step, device busy {r['device_busy_share']:.3f} "
            f"({r['device_ms']:.3f} device ms), B3 kernels "
            f"{r['ssd_device_share']:.4f} ({r['ssd_device_ms']:.3f} ms) "
            "and TD-VMM kernels "
            f"{r['tdvmm_device_share']:.3f} of device time; "
            "top " + "; ".join(f"{k} {v:.3f}" for k, v in r["top_kernels"]))
    del prof
    torch.cuda.empty_cache()
    phase_done("serve mamba2")

    ms = mesh_ssm(dev, ssm["args"])
    del ssm["args"]
    served.extend({"launches": x} for x in ms["launches"])
    r0 = ms["ranks"][0]
    say("mesh", f"ssm (a): {SSM_ARCH} full width ({SSM_SERVE_LAYERS} "
        "layers) on 1 x 2, two ranks on the "
        f"card over gloo: ssm.in_proj (pinned, data-calibrated) and ssm.out "
        "(pinned) bitwise the meshless sites on each rank's shard; "
        f"serve_static {SSM_BATCH} x {SSM_PROMPT} + {SSM_GEN} tokens, "
        f"launches a rank B1 fused {r0['ssm']['launches']['fused']} + raw "
        f"{r0['ssm']['launches']['raw']}, B3 {r0['ssm']['launches']['ssd']} "
        f"(prefill {r0['ssm']['prefill_s']:.3f} s, decode "
        f"{r0['ssm']['decode_s']:.3f} s); streams and teacher-forced logits "
        "(ssm.* and TD-VMM off) == the meshless run's in TP order, bitwise; "
        "TD-VMM off against the plain meshless run "
        + ", ".join(f"{x:.4g}" for x in ms["ssm_gap"])
        + f" of max|logit| (gate {TWO_RANK_RTOL})")
    q0 = r0["qat"]
    say("mesh", f"ssm (b): one {ARCH} QAT step at full width in float32 on "
        f"1 x 2, every linear 6-bit: parameters == the meshless step's; "
        f"gradients within {max(ms['ranks'][r]['qat']['grad_gap'] for r in (0, 1)):.3g} "
        f"of max|g| (gate {QAT_TP_RTOL}, at {q0['grad_leaf']}); loss "
        f"{q0['loss']:.6f} (meshless {q0['meshless_loss']:.6f}); noisy codes "
        f"of ffn.in, ffn.out and q/k/v shards == the meshless codes; "
        f"launches {q0['launches']}; {q0['seconds']:.1f} s")
    h0 = r0["hyb"]
    say("mesh", f"ssm (c): {HYB_ARCH} full width on 2 x 1, batch 1, "
        f"{MESH_HYB_PROMPT} + {MESH_HYB_GEN} tokens on a sequence-split "
        "cache, float32, teacher-forced with the meshless greedy stream: "
        "logits == the meshless run's in the split's order, bitwise; "
        "against the plain meshless run: the same greedy token at every "
        "step, logits within "
        + ", ".join(f"{x:.4g}" for x in ms["hyb_gap"])
        + f" of max|logit| (gate {MESH_HYB_RTOL}); cache bytes a rank "
        + ", ".join(str(ms["ranks"][r]["hyb"]["cache_bytes"]) for r in (0, 1))
        + f" (meshless {ms['h_bytes']}); launches {h0['launches']}; "
        f"{h0['seconds']:.2f} s (meshless {ms['h_meshless_s']:.2f} s)")
    say("mesh", f"ssm phase {ms['seconds']:.1f} s | {card}")
    del ms
    torch.cuda.empty_cache()
    phase_done("mesh ssm")

    say("serve", f"{MOE_ARCH}: full width, depth cut to {MOE_LAYERS} of "
        f"{get_config(MOE_ARCH).n_layers} layers, capacity factor "
        f"{MOE_CAPACITY_FACTOR} (default "
        f"{get_config(MOE_ARCH).moe.capacity_factor}): dropless")
    moe_cache = {}
    for name, plan in moe_plans().items():
        out = serve_moe(name, plan, dev, moe_cache)
        served.append(out)
        say("serve", f"{name}: {MOE_ARCH} {MOE_LAYERS} layers, {MOE_BATCH} "
            f"x {MOE_PROMPT} prompt tokens + {MOE_GEN} new each: calibrate "
            f"{out['calibrate_s']:.3f} s, prefill {out['prefill_s']:.3f} s, "
            f"decode {out['decode_s']:.3f} s ({out['decode_tok_per_s']:.2f} "
            f"tokens/s), launches calibrate {out['launches_calibrate']} "
            f"total {out['launches']}, windows {out['windows']}, reversed "
            f"batch == reversed streams, no NaN; first tokens "
            f"{out['tokens']}")
        prof = profile_static(out["args"], MOE_PROFILE_STEPS)
        for step, r in prof.items():
            say("profile", f"{name} {step}: {r['steps']} step(s) in "
                f"{r['wall_s']:.3f} s, {r['kernels_per_step']:.1f} device "
                f"kernels per step, device busy "
                f"{r['device_busy_share']:.3f}, TD-VMM kernels "
                f"{r['tdvmm_device_share']:.3f} of device time; top "
                + "; ".join(f"{k} {v:.3f}" for k, v in r["top_kernels"]))
        del out["args"], prof
    del moe_cache
    torch.cuda.empty_cache()
    phase_done("serve mixtral")

    hyb = serve_hybrid(dev)
    served.append({"launches": hyb["launches"]})
    served.append({"launches": hyb["launches_int8"]})
    say("serve", f"hybrid_unchained: {HYB_ARCH} full width and depth (54 "
        f"layers, 9 shared-block calls), {HYB_BATCH} x {HYB_PROMPT} prompt "
        f"tokens + {HYB_GEN} new each: calibrate {hyb['calibrate_s']:.3f} s, "
        f"prefill {hyb['prefill_s']:.3f} s, decode {hyb['decode_s']:.3f} s "
        f"({hyb['decode_tok_per_s']:.2f} tokens/s), launches calibrate "
        f"{hyb['launches_calibrate']} total {hyb['launches']}, windows "
        f"{hyb['windows']}, reversed batch == reversed streams, no NaN; "
        f"first tokens {hyb['tokens']}")
    say("serve", f"hybrid_unchained + int8 KV: prefill "
        f"{hyb['prefill_s_int8']:.3f} s, decode {hyb['decode_s_int8']:.3f} s "
        f"({hyb['decode_tok_per_s_int8']:.2f} tokens/s), launches "
        f"{hyb['launches_int8']}, reversed batch == reversed streams, no NaN;"
        f" {hyb['int8_differ']} of {HYB_BATCH * HYB_GEN} tokens differ from "
        f"the bf16-KV run (first at step {hyb['int8_first_differ']} by "
        "row); at the first decode step the int8-KV logits differ from "
        "the bf16-KV ones by "
        + "; ".join(f"{hyb['int8_step_rel'][k]:.3g} of max|logit| "
                    f"({k}: the bf16 logits' top-1 over top-2 margin "
                    + ", ".join(f"{m:.3g}" for m in hyb["bf16_margin_rel"][k])
                    + " of it)" for k in ("plan", "off"))
        + f" (gate {INT8_KV_STEP_RTOL} with TD-VMM off); first tokens "
        f"{hyb['tokens_int8']}")
    prof = profile_static(hyb["args"], HYB_PROFILE_STEPS)
    for name, r in prof.items():
        say("profile", f"hybrid_unchained {name}: {r['steps']} step(s) in "
            f"{r['wall_s']:.3f} s, {r['kernels_per_step']:.1f} device "
            f"kernels per step, device busy {r['device_busy_share']:.3f} "
            f"({r['device_ms']:.3f} device ms), B3 kernels "
            f"{r['ssd_device_share']:.4f} ({r['ssd_device_ms']:.3f} ms) "
            "and TD-VMM kernels "
            f"{r['tdvmm_device_share']:.3f} of device time; "
            "top " + "; ".join(f"{k} {v:.3f}" for k, v in r["top_kernels"]))
    del hyb, prof
    torch.cuda.empty_cache()
    phase_done("serve zamba2")

    phys = physics_path(dev)
    served.append(phys)
    case, arr = phys["case"], phys["array"]
    say("physics", f"perceptron {CASE_N}x{CASE_N}x{CASE_N}, batch "
        f"{CASE_BATCH}: max|y - ideal| {case['max_err']:.3g}, on 6-bit DIBL "
        f"weights (error {case['dibl_error']:.4f}) {case['max_err_dibl']:.3g};"
        f" argmax agrees with the closed form on those weights in "
        f"{case['argmax_agree']:.4f} of rows, with the 6-bit digital twin in "
        f"{case['argmax_agree_twin']:.4f}; pipelined period "
        f"{case['pipeline']['period_s'] * 1e9:.1f} ns, 64 samples in "
        f"{case['pipeline']['total_s'] * 1e6:.3f} us; "
        f"{case['energy_pj_per_inference']:.3f} pJ per inference; forward "
        f"{case['seconds'] * 1e3:.3f} ms")
    say("physics", f"array {PHYS_N}x{PHYS_N}, batch {PHYS_BATCH}: max|y - "
        f"ideal| {arr['max_err']:.3g}, forward {arr['seconds']:.4f} s, "
        f"{arr['fj_per_op']:.3f} fJ/Op ({arr['tops_per_j']:.1f} TOps/J); "
        f"B4 launches {phys['launches']['crossing']} (2 per perceptron "
        "forward, 1 per array forward)")
    del phys["case"], phys["array"]

    phase_done("physics")
    with tempfile.TemporaryDirectory() as workdir:
        qat = train_full_width(dev, Path(workdir))
    served.append({"launches": qat["launches"]})
    hist = qat["out"]["history"]
    say("train", f"qat: {ARCH} full width ({qat['cfg'].n_layers} layers, "
        f"d_model {qat['cfg'].d_model}, d_ff {qat['cfg'].d_ff}, vocab "
        f"{qat['cfg'].vocab_size}, {qat['cfg'].dtype}), every linear 6-bit "
        f"TD-VMM, {QAT_BATCH} x {QAT_SEQ} tokens a step, remat minimal: "
        "loss " + " ".join(f"{h['loss']:.4f}" for h in hist)
        + "; gnorm " + " ".join(f"{h['grad_norm']:.3f}" for h in hist)
        + "; step s " + " ".join(f"{h['dt']:.3f}" for h in hist)
        + f"; {qat['out']['total_s']:.1f} s with the checkpoint; B2 "
        f"launches {qat['launches']['calibrated']} = {qat['formula']}")
    prof = profile_train_step(qat)
    say("profile", f"qat train step: {prof['ms_per_step']:.1f} ms, "
        f"{prof['kernels']} device kernels, device busy "
        f"{prof['device_busy_share']:.3f} ({prof['device_ms']:.1f} device "
        f"ms), TD-VMM kernels {prof['tdvmm_device_share']:.3f} of device "
        "time; top " + "; ".join(f"{k} {v:.3f}"
                                 for k, v in prof["top_kernels"]))
    noisy = noisy_steps(dev, qat["out"]["state"].params)
    served.append({"launches": noisy["launches"]})
    say("train", "noisy: two steps with programming noise at every site, "
        "losses " + ", ".join(f"{n} {v:.4f}" for n, v in noisy["losses"])
        + f"; 3xTF32 launches fused {noisy['launches']['fused_f32x3']}, "
        f"B2 {noisy['launches']['calibrated_f32x3']}, no other storage")
    del qat, noisy
    torch.cuda.empty_cache()
    case_qat = qat_case_study(dev)
    served.append({"launches": case_qat["launches"]})
    say("train", f"perceptron QAT: {case_qat['steps']} steps, loss "
        f"{case_qat['loss_first']:.4f} -> {case_qat['loss_last']:.4f} in "
        f"{case_qat['train_s']:.2f} s; digital-twin test accuracy "
        f"{case_qat['acc_digital']:.3f}, circuit (B4, DIBL "
        f"{case_qat['dibl_error'] * 100:.1f}%) {case_qat['acc_circuit']:.3f},"
        f" drop {case_qat['drop']:+.3f}; circuit vs closed form "
        f"{case_qat['max_err']:.3g}; launches B2 "
        f"{case_qat['launches']['calibrated']}, B4 "
        f"{case_qat['launches']['crossing']}")
    del case_qat["logits"]
    phase_done("train")

    with tempfile.TemporaryDirectory() as workdir:
        tm = train_mamba2(dev, Path(workdir))
    served.append({"launches": tm["launches"]})
    say_train("qat", tm, f"{SSM_ARCH} full width, {tm['cfg'].n_layers} of "
              f"{get_config(SSM_ARCH).n_layers} layers, every ssm.* site "
              f"6-bit TD-VMM, {QAT_BATCH} x {QAT_SEQ} tokens a step, remat "
              "minimal, the scan ssd_plain under autograd")
    del tm
    torch.cuda.empty_cache()
    phase_done("train mamba2")

    train_new_paths(dev, served)

    worst = small_input_agreement(dev)
    say("small", "qwen card vs cpu plain path: equal greedy tokens, logits "
        f"within {worst:.3g} of max|logit|")
    worst = small_ssm_agreement(dev)
    say("small", "mamba2 card vs cpu plain path: equal greedy tokens, "
        f"logits within {worst:.3g} of max|logit|")
    for name, plan in moe_plans().items():
        worst = small_moe_agreement(dev, plan)
        say("small", f"mixtral {name} card vs cpu plain path: equal greedy "
            f"tokens, logits within {worst:.3g} of max|logit|")
    worst = small_hybrid_agreement(dev)
    say("small", "zamba2 (flash on) card vs cpu plain path: equal greedy "
        f"tokens, logits within {worst:.3g} of max|logit|")
    worst = small_physics_agreement(dev)
    say("small", "perceptron and 64 x 64 array card vs cpu plain path: "
        f"decoded outputs within {worst:.3g}")
    for name, r in small_train_agreement(dev).items():
        msg = (f"{name} training card vs cpu: step-0 loss {r['loss0']:.3g} "
               f"relative, gradients within {r['grad']:.3g} of max|g| per "
               f"leaf ({r['worst']}), 3 AdamW steps' losses within "
               f"{r['losses']:.3g}")
        if "calls" in r:
            msg += (f"; on the card's codes ({r['calls']} quantizer calls) "
                    f"gradients within {r['replay_grad']:.3g}, losses within "
                    f"{r['replay_losses']:.3g}; codes the CPU rounds to "
                    f"another level: {r['flips'] or 'none'}"
                    + (f" (at most {r['jump']} level), losses gated before "
                       f"step {r['first_flip']}" if r["flips"] else ""))
        say("small", msg)

    kernels = []
    for name in SOURCES:
        mine = [r for c, r in rows if entry_name(c) == name]
        rep = next(r for c, r in rows if entry_name(c) == name and c.get("rep"))
        launches = sum(s["launches"].get(COUNTER[name], 0) for s in served)
        require(launches > 0, f"{name} was not launched on the main path")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"],
            **({"library_tf32_ms": rep["library_tf32_ms"]}
               if rep.get("library_tf32_ms") is not None else {}),
            "shape": {k: rep[k] for k in SHAPE_KEYS.get(
                name, ("codes", "mode", "e", "m", "k", "n"))}})
    phase_done("small")
    say("phases", ", ".join(f"{k} {v:.1f} s" for k, v in PHASE_S.items()))
    say("done", "all phases passed")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

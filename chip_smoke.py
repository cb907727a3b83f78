"""Quickest proof that the PyTorch/CUDA port runs on a GPU.

    python3 chip_smoke.py [--seed N] [--out chiprun_out/chip_smoke.json]

Needs one CUDA card and the CUDA toolkit (nvcc); exits non-zero without
them, and without the repository around it.  Phases, each of which
raises (and so exits non-zero) when it fails:

1. the card's name and power limit (nvidia-smi); TF32 off;
2. build the three CUDA kernel sources for sm_90a, in parallel
   (``bfp_conv.cu`` holds both conv cores: the tile kernel and the int8
   ``mma.sync`` core with its activation and patch format passes), and
   print each kernel's ptxas registers, shared memory and spills;
3. each kernel against its plain PyTorch version on the card, bit-equal
   (``torch.equal``), at full-width VGG16 shapes at batch 8; the int8
   mma core (the weight-prequant convs) with its activation format pass
   at ResNet-50 stage-4 and VGG16 conv5 shapes and at a ragged M; the
   inline conv on the mma core with its patch format pass (each also
   alone) at K = 27, 147/2, 576, 400, 864 and 1x1 over C = 192, 480,
   832, N = 16..192, blocks 32/128/512, L 4/8, and at a ragged shape
   with zero, NaN, inf and subnormal pixels, K-tiles wholly outside the
   image and an inf weight; and one conv whose policy names no block
   (``ops.bfp_conv2d``, whole-K); the f32-output matmuls on the mma core
   as 1x1 convs (each with its format pass alone) at VGG16 fc6-8,
   ResNet-50's fc and GoogLeNet's loss fc1, at M = 1 and 17, blocks 32,
   128 and 512, L 4 and 8, inline at K = 64, 4096 and a ragged 2047,
   with zero, NaN, inf and subnormal rows and an inf weight, and reduced
   VGG16's fc8 (N = 10) on the tile kernel; the x-prequant conv on the
   mma core after its weight format pass, and the requantize epilogue of
   every conv mode and of both matmuls with f32 x as the output format
   pass after the core (each pass also alone), at VGG16's conv4_2,
   conv3_1 and fc6 as the chains run them, at a ragged M with OC = 40,
   block 32, out_block 4 and hazard pixels, inf / NaN / subnormal wire
   steps and an inf weight, at blocks 512 and 128 (stride 2) with
   OC = 200 and 224 and out_block 8 and 32; and one case per tile-kernel
   fallback (L_W = 9, out_block = 2, OC = 30); the x-prequant matmul on
   the mma core after its weight format pass (each pass also alone) at
   chain B's fc7 and fc8 (batch 8), at M = 1 and 17, blocks 32, 128 and
   512, out_block 4 and 128, with hazard rows and wire steps, and one
   case per tile-kernel fallback (L_W = 9, N = 30, out_block = 2); the
   xw-prequant matmul (both operands on the wire) on the mma core with
   no format pass (its output pass also alone) at chain A's fc7 and fc8
   (batch 8), at M = 1 and 17, blocks 32, 128 and 512, out_block 4 and
   128, with hazard rows, inf / NaN / subnormal wire steps and an inf
   weight step, and one case per tile-kernel fallback (a block of 96,
   N = 30, out_block = 2);
4. the main path: full-width VGG16 (224x224x3, 1000 classes, seeded
   random weights) bound with ``PALLAS_TILED`` (strict, prequantized) and
   served through ``CnnServeEngine`` — 16 requests, no failures, no float
   retries, 3 inline-conv (each one patch format pass and one mma-core
   launch) / 10 prequant-conv (each one format pass and one mma-core
   launch) / 3 prequant-matmul (each one format pass and one mma-core
   launch) launches per forward, logits bit-equal to a direct ``apply``
   and to a forward through a backend made of the plain versions.  The
   reduced VGG16 of the model registry is served the same way: its 13
   convs inline on the mma core, its fc6 and fc7 (K = 64) inline on the
   mma core after a patch format pass each, its fc8 (N = 10) on the tile
   kernel;
5. CUDA-event times of each kernel and its plain version at the phase-3
   shapes and at every layer of one batch-8 forward of each path (each
   layer also checked bit-equal to its plain version, with its bound and
   the core it ran on, and a conv's format pass on the mma core timed
   alone),
   served req/s, and one more served run under ``torch.profiler``
   (device-busy share, host time by op; trace in
   ``chiprun_out/serve_trace.json``);
6. the activation wire-format chain on full-width VGG16 at batch 8,
   from the real activations at each stage's entry: conv2_1 -> conv2_2,
   conv3_1 -> conv3_3, conv4_1 -> conv4_3, conv5_1 -> conv5_3 and
   fc6 -> fc8, every producer passing ``out_policy=plan.out_policy_for(
   next)``, no bias or ReLU between.  Plan A binds the phase-4 weights
   prequantized (the xw-prequant kernels), plan B with float weights (the
   x-prequant kernels).  Each plan's launches are counted in its own
   zeroed run and checked (``CHAIN_LAUNCHES``: every chain layer on the
   mma core, each with its format passes; chain B's fc7-8 after a weight
   format pass each, chain A's with none), with the epilogue count;
   every output
   (wire dicts included) is ``torch.equal`` to the same chain through a
   backend of plain versions, each ``out_policy`` output to
   ``prequant_act`` of the layer's f32 output, and each chain's end to
   the float-activation chain.  Then each layer is timed (CUDA events)
   as it runs in the chain, through the plain versions, and with f32 in
   and out, beside its bound and the core it ran on, and the weight and
   output format passes inside it alone (checked bit-equal); then the
   sums over each chain's epilogue layers and wire-x convs;
7. the block-formatting kernel (``bfp_quantize``) against its plain
   version at ragged M and K, blocks 32/48/128/512, L 4/6/8, with zero,
   inf and NaN blocks, each case on the path (vector or scalar) its shape
   and alignment name, and at an x that starts 4 bytes off 16-byte
   alignment (the scalar path); then the path ``resnet50_format``: full-width
   ResNet-50 (BN statistics from the seed) bound like phase 4, and every
   weight its plan prequantized (44 convs and fc) formatted offline
   through ``ops.bfp_quantize`` in the GEMM view ``[N, K]`` — launches
   counted in their own zeroed run, each output ``torch.equal`` to the
   plain version and to the plan's sidecar (``m.T == m``,
   ``pow2(e - 6).T == s``), and timed: each weight alone, the loop of
   the 45 calls (CUDA events) and its device time (``torch.profiler``);
8. ResNet-50 (the slice's main path), ResNet-18 and GoogLeNet at full
   width served like phase 4 (16 requests, launches as
   ``MODEL_LAUNCHES`` predicts, logits — GoogLeNet's head 0 — bit-equal
   to a direct apply and to the plain-version forward), each with its
   CUDA-event forward time and served req/s, and ResNet-50 layer by
   layer at its own inputs (kernel, plain, bound, core) with its sums by
   stage, GoogLeNet layer by layer the same way, and a yardstick for
   the int dot alone: ``torch._int_mm`` on
   the im2col'd int8 operands of a stage-4 3x3 conv (not the same
   function: no block steps, no tile-ordered f32 sum; the port never
   calls it);
9. the paper's policy (``PAPER_DEFAULT``: EQ4, L=8) requested on the
   kernel backend, bound non-strict for VGG16 and ResNet-18: one
   ``BackendFallbackWarning`` per site, every site on "emulated", no
   kernel launched while 16 requests are served, served logits equal to
   a direct apply and to a ``PAPER_DEFAULT`` plan, forward time beside
   the kernel forward's;
10. the paper's Table-4 per-layer SNR analysis (``models.cnn.analysis``,
   a float and a BFP run observed through ``engine.taps``): full-width
   VGG16 at batch 2 under the paper's policy (EQ4, L=8: the emulated
   datapath, no kernel launch), its 13 rows printed, every SNR finite,
   the measured output SNR within the paper's 8.9 dB of the multi-layer
   model and ReLU within 1.5 dB; full-width ResNet-50 at batch 2 with
   float weights on the kernels (``R50_T4_BLOCKS``: TILED, block 128
   where it divides K), launches counted in their own zeroed run
   (``R50_T4_LAUNCHES``), its 54 rows equal within 1e-4 dB to the same
   analysis through the plain versions and every site's BFP output
   ``torch.equal`` to that run's; and a reduced VGG16 whose card rows
   agree with the CPU's within 1e-3 dB; each with its wall time;
11. packed BFP artifacts end to end: phase 4's VGG16 saved
   ``bfp_packed`` and ``float32`` under a temporary directory (both
   artifacts' bytes and their ratio printed), a tenant cold-started from
   the packed one (``serve.tenants.cold_start``: restore, unpack + bind
   and first forward timed, beside a float32 restore + bind) serving
   phase 4's 16 requests, logits ``torch.equal`` to phase 4's and
   launches equal to phase 4's, its sidecars ``torch.equal`` to the
   float32 artifact's bind; phase 8's ResNet-50 saved ``bfp_packed`` and
   ``bfp_packed_v2``, each cold-started as a tenant
   (``add_tenant(checkpoint_dir=)``) and served bit-equal to phase 8 with
   launches as ``MODEL_LAUNCHES``, and a tenant on the second one's plan
   (``plan=``) sharing its forward; ResNet-50's packed tree with
   ``faults.inject_tree`` faults (exponent, mantissa MSB and LSB, BER
   1e-3, seed 0), each faulty forward on the kernels equal (NaN-aware)
   to the plain versions', with top-1 agreement and logit SNR against
   the clean logits; ``faults.endurance_campaign`` (LeNet, CIFARNet, L 6
   and 8, BER 1e-3 and 1e-2) on the card and on the CPU, rows equal
   (SNR within 1e-3 dB); the serve CLI (``repro_torch.launch.serve_cnn``)
   as two subprocesses, ResNet-50 at full width and two tenants, each
   exiting 0 with its req/s line;
12. BFP training (``repro_torch.train.cnn``, both backward GEMMs of every
   site on the ``bfp_matmul`` kernels): ``train_vgg16_full``, VGG16 at
   published width from phase 4's float weights, 2 workers of 8 images,
   ``PALLAS_TILED`` without straight-through, 8-bit wire; two steps, each
   with launches as ``TRAIN_VGG16_LAUNCHES`` and its params, OptState and
   residuals ``torch.equal`` to the same step through the plain versions,
   step 1 repeated ``torch.equal``, the loss finite; one worker's
   backward profiled (device ms by kernel family); peak memory; measured
   gradient NSR of all 32 backward GEMMs within their bounds, in the
   order a reduced VGG16 gives on the CPU.  ``train_cifarnet``:
   ``train_cnn`` at ``repro``'s CIFARNet configuration (8 steps, the first
   over the packed wire, NSR at step 0, a checkpoint): the loss falls,
   the measured wire bytes equal ``wire_report``'s, the packed exchange
   equals the in-graph step bit for bit, the checkpoint round trip is
   ``torch.equal``, and step 1 on the card is within 1e-5 (loss,
   relative) and ``2.5 * lr`` (params) of the same step on the CPU;
13. the tune slice on the card.  ``tuned_vgg16_full``: phase 4's 16
   VGG16 sites tuned at batch 8 on the routes they are served by
   (``tune.autotune.tune_plan``; block 128 is pinned, so only the mma
   core's tile moves) and the canonical GEMMs (``tune.shapes``) with a
   free block, each at its tuned ``bk`` ``torch.equal`` to the plain
   version at that block, into a temporary cache whose entries carry
   the card's target; phase 4's 16 requests served from a plan bound
   with it (``bind(tune_cache=)``): logits ``torch.equal`` to phase 4's,
   launches equal, no cache miss and one hit per site run; tuned and
   untuned batch-8 forwards in A/B pairs; ``python -m repro_torch.tune
   --smoke`` once as a subprocess.  ``precision_vgg16_full``: the
   per-site mantissa-width search (``tune.search_precision``) on phase
   4's weights and images, ``PALLAS_TILED`` base (every L_w 2-8 on the
   mma core), budget 1e-2 and top-1 tolerance 0.25 (the CLI's): every
   site's NSR within budget and its fresh NSR within its bound, the
   map's tapped forward on the kernels ``torch.equal`` to the plain
   versions at every site, the map saved ``bfp_packed_v2`` (bytes beside
   phase 11's fixed-L artifact) and served by a cold-started tenant
   bit-equal to a direct apply under the map; reduced VGG16 searched on
   the card and on the CPU, the maps equal.  ``load_resnet50_full``:
   phase 8's ResNet-50 plan closed loop (64 requests, bucket 8), then
   open loop on wall time (``serve.load.run_open_loop``), 256 Poisson
   arrivals at 0.5x and 0.9x that capacity in continuous batching and at
   0.9x in bucket batching (``max_wait`` 2): p50 / p99 / mean, goodput,
   shed / expired / failed, the accounting exact, no failure, every
   completed logit ``torch.equal`` to its image's direct batch-8
   forward; LeNet's virtual-time rows (``call_cost``) on the card equal
   to the CPU's for the same trace, with deadlines and shedding;
14. the LM serving path (``serve.engine``, ``models.lm``).
   ``lm_tinyllama_full``: TinyLlama-1.1B at its published configuration
   (22 layers, d_model 2048, 32 heads, GQA kv 4, head_dim 64, d_ff 5632,
   vocab 32,000), seeded on the card, served by ``ServeEngine`` at
   ``PALLAS_TILED`` (block 128, L = 8; strict, weights prequantized at
   admission), 4 slots, a 256-position cache, prefill chunks of 8, 8
   requests (prompt lengths 8-64 and tokens from ``--seed``, 32 new
   tokens each), continuous batching: no failure and no float retry,
   and 155 ``bfp_matmul_prequant`` and 155 ``bfp_matmul_xformat``
   launches per ``decode_step`` call (7 linears of 22 layers and
   ``lm_head``), every other counter 0.  Every request served alone on a
   fresh engine of the same geometry gives its batched tokens; bucket
   batching gives continuous' tokens; four decode steps from one fresh
   cache on the kernels are ``torch.equal`` to the same steps through
   the plain versions (logits and bf16 caches).  Then the median
   decode-step time (CUDA events), one step profiled (device ms by
   family beside the kernel GEMMs' bound), tokens/s, init and
   bind + prequant seconds, peak memory.  ``lm_olmoe_width``: OLMoE-1B-7B
   at published width (64 experts top-8, d_ff 1024, vocab 50,304) at 4
   of its 16 layers and capacity factor 64 (no token dropped: see
   ``LM_PATHS``), 4 requests of 8 new tokens, the same checks, 17
   launches per call (the router in float, the experts on the emulated
   datapath).  The LM serve CLI (``repro_torch.launch.serve``, smoke
   scale: TinyLlama and RWKV6) as subprocesses, exiting 0;
15. the recurrent LM families and the encoder-decoder, each bound at
   ``PALLAS_TILED`` (strict, weights prequantized).  ``lm_rwkv6_full``:
   RWKV6-3B at its published configuration (32 layers, d_model 2560, 40
   WKV heads of 64, d_ff 8960, vocab 65,536) served like phase 14's
   paths (8 requests of 16 new tokens), its decay LoRA's ``tm/wB`` (K =
   64) left float; its decode forms drop the policy (R7), so a
   ``decode_step`` launches only ``lm_head`` (1 + 1 a call) and runs
   every layer GEMM on the float backend; a forward over B = 2, S = 64
   (two WKV chunks) ``torch.equal`` to the plain versions with 289 + 289
   prequant launches and 32 + 32 inline ones (``tm/wB``).
   ``lm_griffin_width``: RecurrentGemma-9B at published width (LRU 4096,
   16 heads of 256, MQA, d_ff 12,288, vocab 256,000, window 2048, tied
   embeddings) at 5 of its 38 layers (one (rec, rec, attn) period and
   two rec blocks), 4 requests of 8 new tokens, the same checks, 39 + 39
   prequant launches a call and the tied head on the float ``embed.T``
   (1 + 1); ``lm_head`` timed alone.  ``lm_seamless_full``:
   seamless-m4t-medium at its published configuration (12 + 12 layers,
   d_model 1024, 16 heads, d_ff 4096, vocab 256,206) through
   ``serve.generate(enc_feats=)``: B = 4 rows of 1,024 seeded frame
   embeddings, 8-token prompts, 16 new greedy tokens; 84 + 84 launches
   for ``prefill_encoder`` and 133 + 132 a ``decode_step`` call (11
   linears of 12 decoder layers on the mma core, ``lm_head`` with N % 4
   = 2 on the tile kernel, timed alone); the rows rolled by one slot
   give their batched tokens (each row generated alone, B = 1, is
   printed: the float attention at another batch size may round
   otherwise), and the tokens, the encoder output and four decode steps
   are ``torch.equal`` to the plain versions.  Each path
   prints tokens/s, the median ``decode_step`` (CUDA events), one
   profiled step by kernel family (mma core, format passes, tile kernel,
   cuBLAS float GEMMs, other) beside the bound of the GEMMs that ran on
   the kernels in it (tapped: float-backend GEMMs left out), init and
   bind + prequant seconds, and peak memory;
16. LM training (``train.step``, ``train.loop``, ``data.pipeline
   .lm_batch``, ``launch.train``).  ``train_tinyllama_full``:
   TinyLlama-1.1B at its published configuration, seeded on the card,
   ``make_train_step`` at ``PALLAS_TILED`` without straight-through
   (every forward GEMM and both backward GEMMs of each of the 155 linear
   sites on the kernels: 465 ``bfp_matmul`` launches a step, each after a
   patch format pass, ``lm_train_launches``), ``cosine_schedule(3e-4,
   20, 100)``, batches of the port's ``lm_batch`` at B = 8, S = 256; two
   steps, each ``torch.equal`` to the same step through the plain
   versions (params, AdamW moments, step, metrics) with its launches
   checked; then the median of 5 timed steps (CUDA events), tokens/s,
   one profiled step by kernel family beside the bound of its kernel
   GEMMs, init seconds and peak memory.
   ``train_olmoe_width``: OLMoE-1B-7B at published width and capacity
   factor, 2 of its 16 layers, ``PALLAS_TILED`` with straight-through
   (the experts' estimator, F9), B = 4, S = 128: one step ``torch.equal``
   to the plain versions, the experts' gradients non-zero, 9 launches.
   ``train_rwkv6_width`` (RWKV6-3B, 20 of its 32 layers),
   ``train_seamless_full`` (seamless-m4t-medium at its published
   configuration) and ``train_griffin_width`` (RecurrentGemma-9B, one
   (rec, rec, attn) period: 3 of its 38 layers), at published width,
   ``PALLAS_TILED`` without straight-through, B = 4, S = 256: the depths
   are what one card holds with AdamW (``LM_TRAIN_WIDTH``).  One step
   ``torch.equal`` to the plain versions (the kernels' new state waits on
   the host while the plain-version step runs), its launches equal to
   ``lm_train_launches`` (read from the model code: every linear site's
   forward, #dx and #dw; seamless' head runs the tile kernel, N % 4 = 2,
   its #dx at block 6) and printed by core; then the median of 3 timed
   steps, tokens/s, one profiled step by kernel family beside the bound
   of its kernel GEMMs, init seconds and peak memory.
   ``train_families_smoke``: each of the ten architectures at
   ``reduced()`` (the hybrid at 3 layers: one period, so its attention
   runs) at ``PALLAS_TILED`` block 32 without straight-through,
   B = 2, S = 32, one step ``torch.equal`` to the plain versions, its
   launches by core printed (a contraction shorter than the block, MQA's
   16, runs the tile kernel); TinyLlama's step also against the CPU's by
   ``tests/test_torch_lm_train.py``'s rules.  ``train_loop_100m``: the
   launcher's ``100m`` scale of TinyLlama through ``run_training``, 30
   steps at ``cosine_schedule(3e-3, 5, 30)``, the loss falling, 171
   launches every step; a 10-step run failed at step 6 (checkpoints every
   4) and resumed equals an uninterrupted one bit for bit.  The training
   CLI (``repro_torch.launch.train``: TinyLlama with ``--bfp
   --compress-grads``, OLMoE with ``--ckpt-dir``) as subprocesses,
   exiting 0 with their ``done: loss`` line;
17. logical-axis sharding (``dist.sharding``, ``launch.mesh``) on a 1x1
   ("data", "model") mesh of the card, over the one-rank group
   ``make_mesh`` starts.  ``sharded_resnet50_full``: phase 8's ResNet-50
   plan served through ``CnnServeEngine(mesh=, rules=DEFAULT_RULES)``,
   16 requests at bucket 8: logits ``torch.equal`` to phase 8's
   unsharded engine and to the plain versions, launches equal to
   ``MODEL_LAUNCHES["resnet50_full"]`` and to phase 8's run, no rule
   dropped; then the median batch-8 forward with and without the
   binding (alternating pairs, CUDA events) and the engine's host work
   per forward.  ``serve_cnn_mesh_vgg16_full``: the serve CLI on
   full-width VGG16 (``--bfp --prequant --strict-backend``) with ``--mesh
   1x1`` and without, as subprocesses: both exit 0 with equal logits.
   ``restore_sharded_vgg16``: phase 4's VGG16 saved float32 and
   ``bfp_packed``, restored with ``sharding_fn`` onto the card and onto
   the mesh (``[Replicate(), Replicate()]``): every leaf equal to the
   plain restore, the ``"dequant"`` weights placed as DTensors, the
   ``"prequant"`` sidecars not.  ``lm_tinyllama_bound``: one full-width
   TinyLlama ``decode_step`` (B = 4) and one ``forward`` (B = 2,
   S = 64) under ``axis_rules(DEFAULT_RULES, mesh)``, ``torch.equal`` to
   the unbound calls with ``lm_launches_per_call``'s launches (155 + 155
   a step) both ways and no rule dropped;
18. the dry run and the roofline (``launch.input_specs``,
   ``launch.dryrun``, ``launch.hillclimb``, ``roofline``).  Full-width
   TinyLlama-1.1B cells (``build_cell`` on a 1x1 mesh of the card):
   ``train`` B = 8, S = 256; ``prefill`` B = 4, S = 4,096; ``decode``
   B = 8 over a 4,096-position cache, with float weights and with
   hillclimb's BFP-8 weights.  Each cell is traced on fake tensors
   (``roofline.counter``), run for real on the card from a seeded
   generator (``input_specs.materialize``) under ``FlopCounterMode``,
   whose count must equal the trace's, then timed (one warm-up, the
   median of 5 by CUDA events) and profiled once (device ms against the
   call's wall); a line ``roofline tinyllama_<cell>`` prints the H100
   roofline terms, the dominant one, the measured ms, the share
   ``max(t_compute, t_memory) / measured``, the compute share
   ``t_compute / measured`` and the profiled call's device busy share.  The cells run
   the float route (no policy, as in ``repro``), so no kernel launches:
   the phase checks every counter reads zero.  Then hillclimb cell C
   (``mistral-nemo-12b``, ``decode_32k``) on the fake 16x16 mesh of this
   machine's torch: ``run_cell_roofline`` and ``run_cell_compile``
   (``baseline``), ``measure`` (``no_fsdp+bfp8w``) and ``report.render``
   over the JSONs written; the baseline's per-device FLOPs must lie
   within 2x of model FLOPs / 256 (line ``roofline cell_C``, then the
   table).  Then, on the same fake mesh, the cells that trace on meshes
   of many devices through ``roofline.partition``'s MoE, RG-LRU, head and
   WKV rules: hillclimb cell B (``olmoe-1b-7b``, ``prefill_32k``) in its
   three variants through ``measure``, the baseline's per-device FLOPs
   within 0.5x-4x of model FLOPs / 256 (lines ``roofline cell_B_<variant>``),
   and ``run_cell_roofline`` of ``recurrentgemma-9b``, ``minicpm-2b`` and
   ``rwkv6-3b`` at ``train_4k`` (line ``roofline <arch> train_4k``); no
   counter moves.  The phase prints its seconds;
19. a JSON line of per-kernel numbers, then the result line
   ``{"ok": true, "device": {...}}``.  Each kernel's row is read from the
   first path that launches it (``path``): its launches in that path's
   own zeroed run, and ms / plain_ms / bound_ms summed over that path's
   layers that run it, per batch-8 forward (per chain run for the
   wire-format kernels, per formatting of ResNet-50 for
   ``bfp_quantize``).  ``bfp_conv2d_prequant``'s, ``bfp_conv2d``'s and
   the f32-x matmuls' ms are their wrappers': the format pass and the
   core (and the output pass in a chain); the ``*_xformat``,
   ``*_pformat``, ``*_wformat`` and ``*_oformat`` rows are the format
   passes alone.  A matmul row's ``source`` is the file of the core its path
   ran (``sources_by_core`` names both).
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
# int8 tensor-core operations/s, for the least time a call could take.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

_MM_CU = "src/repro_torch/kernels/csrc/bfp_matmul.cu"
_CONV_CU = "src/repro_torch/kernels/csrc/bfp_conv.cu"
#: a kernel's source, or for the f32-output matmuls one per core: the mma
#: core's route is in bfp_conv.cu, the tile kernel's in bfp_matmul.cu
_MM_BOTH = {"mma": _CONV_CU, "tile": _MM_CU}
SOURCES = {"bfp_matmul": _MM_BOTH, "bfp_matmul_prequant": _MM_BOTH,
           "bfp_matmul_xprequant": _MM_BOTH, "bfp_matmul_xwprequant": _MM_BOTH,
           "bfp_matmul_xformat": _CONV_CU, "bfp_matmul_pformat": _CONV_CU,
           "bfp_matmul_wformat": _CONV_CU,
           "bfp_conv2d": _CONV_CU, "bfp_conv2d_prequant": _CONV_CU,
           "bfp_conv2d_xprequant": _CONV_CU, "bfp_conv2d_xwprequant": _CONV_CU,
           "bfp_conv2d_xformat": _CONV_CU, "bfp_conv2d_pformat": _CONV_CU,
           "bfp_conv2d_wformat": _CONV_CU, "bfp_conv2d_oformat": _CONV_CU,
           "bfp_matmul_oformat": _CONV_CU,
           "bfp_quantize": "src/repro_torch/kernels/csrc/bfp_quantize.cu"}
REPLACES = {"bfp_matmul": "src/repro/kernels/bfp_matmul.py:362",
            "bfp_matmul_prequant": "src/repro/kernels/bfp_matmul.py:388",
            "bfp_matmul_xprequant": "src/repro/kernels/bfp_matmul.py:419",
            "bfp_matmul_xwprequant": "src/repro/kernels/bfp_matmul.py:448",
            # load_x (and load_w) in _make_matmul_kernel, which the
            # prequant (inline) matmul now formats once per row block
            # (and weight block) before the mma core
            "bfp_matmul_xformat": "src/repro/kernels/bfp_matmul.py:216",
            "bfp_matmul_pformat": "src/repro/kernels/bfp_matmul.py:216",
            # load_w, which the x-prequant matmul now formats once per
            # call (the patch pass's weight blocks) before the mma core
            "bfp_matmul_wformat": "src/repro/kernels/bfp_matmul.py:216",
            "bfp_conv2d": "src/repro/kernels/bfp_conv.py:278",
            "bfp_conv2d_prequant": "src/repro/kernels/bfp_conv.py:304",
            "bfp_conv2d_xprequant": "src/repro/kernels/bfp_conv.py:332",
            "bfp_conv2d_xwprequant": "src/repro/kernels/bfp_conv.py:363",
            # the x quantization inside _make_conv_kernel, which the
            # prequant conv now does once per pixel chunk
            "bfp_conv2d_xformat": "src/repro/kernels/bfp_conv.py:94",
            # x_tile / w_tile of _make_conv_kernel, which the inline conv
            # now formats once per patch block and weight block
            "bfp_conv2d_pformat": "src/repro/kernels/bfp_conv.py:131",
            # w_tile of _make_conv_kernel, which the x-prequant conv now
            # formats once per call (the patch pass's weight blocks)
            "bfp_conv2d_wformat": "src/repro/kernels/bfp_conv.py:137",
            # the out_q epilogue of _make_conv_kernel and _requant_store,
            # now the activation format pass over the core's f32 output
            "bfp_conv2d_oformat": "src/repro/kernels/bfp_conv.py:166",
            "bfp_matmul_oformat": "src/repro/kernels/bfp_matmul.py:169",
            "bfp_quantize": "src/repro/kernels/bfp_quantize.py:38"}
#: counters of the wire-format kernels, of the requantize epilogue and of
#: the weight and output format passes, which no served path launches
#: (phases 4 and 8 expect them at 0)
WIRE_COUNTERS = ("bfp_matmul_xprequant", "bfp_matmul_xwprequant",
                 "bfp_conv2d_xprequant", "bfp_conv2d_xwprequant",
                 "bfp_matmul_epilogue", "bfp_conv2d_epilogue",
                 "bfp_conv2d_wformat", "bfp_conv2d_oformat",
                 "bfp_matmul_wformat", "bfp_matmul_oformat")
#: the chains of phase 6: each stage starts from the real activation at
#: its entry; conv1_x cannot chain (C = 3 and 64 are not block multiples)
CHAIN_STAGES = (("conv2_1", "conv2_2"), ("conv3_1", "conv3_2", "conv3_3"),
                ("conv4_1", "conv4_2", "conv4_3"),
                ("conv5_1", "conv5_2", "conv5_3"), ("fc6", "fc7", "fc8"))
#: predicted launches per batch-8 forward of the full-width models: a
#: conv or GEMM whose K = kh*kw*C is a multiple of the 128 block is
#: prequantized at bind (prequant conv / matmul); prequant_leaf leaves any
#: other K float, for the inline-weight kernel.  ResNet-50: the stem (K
#: 147) and stage 1's K = 64 / 576 convs inline.  ResNet-18: the stem,
#: stage 1's four 3x3x64 convs, stage 2's first conv (576) and projection
#: (64) inline.  GoogLeNet (from repro's _INCEPTION table, inputs of 192,
#: 256, 480, 512, 512, 512, 528, 832, 832 channels): inline are the three
#: stem convs (K 147, 64, 576), every conv of 3a, 4a, 4e, 5a and 5b (C not
#: a multiple of 128; their 3x3 and 5x5 K 864, 400, 1440, 800, 1728,
#: 1200 neither), 3b/b5 (800), 4b/b3 (1008), 4b/b5 and 4c/b5 (600),
#: 4d/b3 (1296), 4d/b5 (800) and loss2/conv (528): 40; prequant the other
#: 19; the five GEMMs (fc, loss1|2/fc1|fc2: K 1024 or 2048) prequant.
#: Every prequant conv (block 128 | C, OC a multiple of 4, f32 out) runs
#: the int8 mma core after one activation format pass, and every inline
#: conv (OC a multiple of 4, f32 out) after one patch format pass; so
#: does every prequant GEMM (N a multiple of 4, f32 out), as a 1x1 conv
#: after one activation format pass of its own counter.
MODEL_LAUNCHES = {
    "resnet50_full": {"bfp_conv2d": 9, "bfp_conv2d_pformat": 9,
                      "bfp_conv2d_prequant": 44, "bfp_conv2d_xformat": 44,
                      "bfp_matmul_prequant": 1, "bfp_matmul_xformat": 1,
                      "bfp_matmul_pformat": 0},
    "resnet18_full": {"bfp_conv2d": 7, "bfp_conv2d_pformat": 7,
                      "bfp_conv2d_prequant": 13, "bfp_conv2d_xformat": 13,
                      "bfp_matmul_prequant": 1, "bfp_matmul_xformat": 1,
                      "bfp_matmul_pformat": 0},
    "googlenet_full": {"bfp_conv2d": 40, "bfp_conv2d_pformat": 40,
                       "bfp_conv2d_prequant": 19, "bfp_conv2d_xformat": 19,
                       "bfp_matmul_prequant": 5, "bfp_matmul_xformat": 5,
                       "bfp_matmul_pformat": 0}}
#: the format passes of the mma core, timed alone as rows of their own
#: beside the layer whose time includes them
FORMAT_PASSES = ("bfp_conv2d_xformat", "bfp_conv2d_pformat",
                 "bfp_matmul_xformat", "bfp_matmul_pformat",
                 "bfp_conv2d_wformat", "bfp_conv2d_oformat",
                 "bfp_matmul_wformat", "bfp_matmul_oformat")
#: offline formatting of ResNet-50: one launch per prequantized weight
FORMAT_LAUNCHES = {"bfp_quantize": 45}
#: (M, K, bk, bits) of the phase-7 checks: ragged M and K, blocks 32, 48,
#: 128 and 512, L 4, 6 and 8 (rows 0-4 of each carry the hazard blocks).
#: The kernel's vector path takes K % 16 == 0 with bk % 16 == 0 and
#: bk <= 512 (at bk 32, 48, 128 and 512 here), the scalar path the rest
Q_SHAPES = ((1000, 2047, 128, 8), (37, 300, 32, 4), (512, 4608, 512, 8),
            (2049, 1153, 128, 8), (64, 147, 32, 8), (300, 96, 512, 4),
            (1000, 4608, 32, 8), (64, 64, 128, 8), (40, 480, 48, 6),
            (2048, 1152, 512, 4))
#: captures of a profiled loop before a capture short of kernel events
#: fails the check (the profiler has been seen to drop one event)
PROFILE_TRIES = 3
#: every chain layer runs on the mma core: an f32-x layer after its
#: activation (prequant) or patch (inline) format pass, a wire-x conv or
#: matmul with float weights after its weight format pass, a layer with
#: both operands on the wire (chain A's wire convs and fc7-8) with no
#: pass, and every layer with an out_policy (7 convs, fc6 and fc7) with
#: one output format pass after the core.  Per chain run at batch 8
#: (plan A: weights prequantized; plan B: float weights); 9 layers run
#: the requantize epilogue each
CHAIN_LAUNCHES = {
    "chain_A": {"bfp_conv2d": 1, "bfp_conv2d_pformat": 1,
                "bfp_conv2d_prequant": 3, "bfp_conv2d_xformat": 3,
                "bfp_conv2d_xwprequant": 7, "bfp_conv2d_oformat": 7,
                "bfp_conv2d_epilogue": 7, "bfp_matmul_prequant": 1,
                "bfp_matmul_xformat": 1, "bfp_matmul_oformat": 2,
                "bfp_matmul_xwprequant": 2, "bfp_matmul_epilogue": 2,
                "bfp_matmul_pformat": 0, "bfp_conv2d_wformat": 0,
                "bfp_matmul_wformat": 0},
    "chain_B": {"bfp_conv2d": 4, "bfp_conv2d_pformat": 4,
                "bfp_conv2d_xprequant": 7, "bfp_conv2d_wformat": 7,
                "bfp_conv2d_oformat": 7, "bfp_conv2d_epilogue": 7,
                "bfp_matmul": 1, "bfp_matmul_pformat": 1,
                "bfp_matmul_xprequant": 2, "bfp_matmul_wformat": 2,
                "bfp_matmul_oformat": 2, "bfp_matmul_epilogue": 2,
                "bfp_matmul_xformat": 0, "bfp_conv2d_xformat": 0}}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed no card")
    return out[0].strip()


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call, CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _parts(v):
    """A tensor, or the tensors of a wire-format {"m", "s"} dict or of an
    (int8, steps) pair."""
    if isinstance(v, dict):
        return tuple(v.values())
    return tuple(v) if isinstance(v, tuple) else (v,)


def bound(x, w_parts, out, m, n, k):
    """(bound_ms, bound_by): each input read once and the output written
    once at the HBM rate (a wire-format x or output counts its int8
    mantissas and f32 steps), against 2*M*N*K int8 operations at the
    int8 tensor-core peak."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*_parts(x), *w_parts, *_parts(out)))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * m * n * k / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def with_bn_stats(params, gen):
    """The tree with every batch norm's statistics and affine terms drawn
    from ``gen`` (``layers.batchnorm_init`` is the identity, which would
    hide BN): gamma and var in [0.5, 1.5), beta and mean 0.1 N(0, 1)."""
    if isinstance(params, dict):
        if set(params) == {"gamma", "beta", "mean", "var"}:
            c, d = params["gamma"].shape[0], params["gamma"].device
            return {"gamma": (0.5 + torch.rand(c, generator=gen)).to(d),
                    "beta": (0.1 * torch.randn(c, generator=gen)).to(d),
                    "mean": (0.1 * torch.randn(c, generator=gen)).to(d),
                    "var": (0.5 + torch.rand(c, generator=gen)).to(d)}
        return {k: with_bn_stats(v, gen) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(with_bn_stats(v, gen) for v in params)
    return params


def nan_bits(a):
    """NaN-aware bit patterns of a tensor or tuple of tensors (hazard
    inputs make NaN, and ``torch.equal`` says NaN != NaN)."""
    a = a if isinstance(a, tuple) else (a,)
    return [torch.where(v.isnan(), torch.full_like(v, float("nan")),
                        v).view(torch.int32) if v.is_floating_point()
            else v for v in a]


def same_bits(a, b) -> bool:
    a, b = nan_bits(a), nan_bits(b)
    return len(a) == len(b) and all(torch.equal(u, v) for u, v in zip(a, b))


def diff(a, b) -> float:
    """Largest absolute difference of two tensors or tuples, NaN as 0."""
    a, b = (a if isinstance(a, tuple) else (a,),
            b if isinstance(b, tuple) else (b,))
    return max(((u.float() - v.float()).abs().nan_to_num(0.0).max().item()
                for u, v in zip(a, b) if u.numel()), default=0.0)


def tree_leaves(tree, device=None) -> tuple:
    """The tensors of a tree (a tensor, a wire-format {"m", "s"} dict, a
    params tree, a train state) in the port's leaf order, moved to
    ``device`` when given."""
    from repro_torch import _tree
    return tuple(v.to(device) if device else v
                 for v in _tree.flatten(tree)[0])


def same_tree(a, b, nan_aware: bool = True) -> bool:
    """The one tree comparator of every phase: the same number of leaves,
    each pair bit-equal — NaN-aware bit patterns by default (``nan_bits``:
    NaN == NaN, -0.0 != +0.0), else ``torch.equal`` (NaN != NaN)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    # leaf by leaf: the NaN-aware patterns of one pair at a time (a
    # full-width train state is 13 GB)
    same = same_bits if nan_aware else torch.equal
    return len(la) == len(lb) and all(same(u, v) for u, v in zip(la, lb))


def tree_diff(a, b) -> float:
    """Largest absolute difference over two trees' leaves, NaN as 0."""
    return diff(tree_leaves(a), tree_leaves(b))


def weight_at(tree, path):
    """The weight leaf of site ``path`` ("blocks/3/c1", "fc") in a CNN
    tree; a conv+bn site keeps its weight under "conv"."""
    node = tree
    for key in path.split("/"):
        node = node[int(key)] if isinstance(node, (list, tuple)) else \
            node[key]
    if "bn" in node:
        node = node["conv"]
    return node["w"]


#: the Table-4 phase's ResNet-50 policy: PALLAS_TILED (block 128) wherever
#: the block divides the site's K; the analysis block-formats each site's
#: im2col matrix as the datapath does (``bfp_quantize_matrix``), which
#: needs bk | K, so stage 1 (blocks 0-2: K = 64, 576) takes block 64 and
#: the stem (K = 147, no power-of-two divisor) one block per patch row.
#: Every other site is the served policy.
R50_T4_BLOCKS = (("^stem$", 147), ("^blocks/[0-2]/", 64))
#: launches of one analysis run of ResNet-50 at that policy: 52 convs on
#: the mma core after a patch format pass each, the stem (block 147) on
#: the tile kernel, the fc on the mma core after its patch format pass
R50_T4_LAUNCHES = {"bfp_conv2d": 53, "bfp_conv2d_pformat": 52,
                   "bfp_matmul": 1, "bfp_matmul_pformat": 1}
#: the Table-4 row fields (SNRs in dB)
T4_FIELDS = ("input_ex", "input_single", "input_multi", "weight_ex",
             "weight_model", "output_ex", "output_single", "output_multi",
             "relu_ex")


def serve_check(label, plan, apply, images, per_forward, dev, classes,
                pplan, **engine_kw):
    """Serve ``images`` (16) as requests through ``CnnServeEngine`` on the
    bound ``plan`` (8 slots, ``engine_kw`` passed on) and check the path:
    no failed request and no float retry, its own launches (zeroed just
    before, read just after) ``per_forward`` times the forwards, finite
    logits of [16, ``classes``], ``torch.equal`` to a direct batch-8
    forward of the plan and to the same forward of ``pplan`` (the plain
    versions).  Returns (engine, served logits, launches)."""
    from repro_torch import kernels as K
    from repro_torch.models.cnn import head_logits
    from repro_torch.serve.cnn import CnnServeEngine

    eng = CnnServeEngine(None, apply, plan, slots=8, **engine_kw)
    n = len(images)
    reqs = [eng.submit(image=images[i]) for i in range(n)]
    K.reset_launch_counts()
    eng.run()
    counts = K.launch_counts()
    print(f"path {label}: stats {eng.stats} forwards {eng.ncalls} "
          f"launches {counts}", flush=True)
    check(all(r.done and r.error is None for r in reqs),
          f"{label}: a request failed: "
          f"{[repr(r.error) for r in reqs if r.error]}")
    check(eng.stats["completed"] == n and eng.stats["failed"] == 0
          and eng.stats["float_retries"] == 0,
          f"{label}: serving stats {eng.stats}")
    want = {**dict.fromkeys(counts, 0),
            **{k: v * eng.ncalls for k, v in per_forward.items()}}
    check(counts == want, f"{label}: launches {counts} != {want}")
    served = torch.from_numpy(np.stack([r.logits for r in reqs]))
    check(served.shape == (n, classes)
          and bool(torch.isfinite(served).all()),
          f"{label}: logits not finite of the expected shape")

    def batched(p):
        fwd = p.jit_forward(apply)
        return torch.cat([head_logits(fwd(images[i:i + 8].to(dev))).cpu()
                          for i in range(0, n, 8)])

    check(torch.equal(served, batched(plan)),
          f"{label}: served logits differ from a direct apply")
    plain = batched(pplan)
    err = (served - plain).abs().max().item()
    check(torch.equal(served, plain),
          f"{label}: kernel forward differs from the plain-backend "
          f"forward (max |diff| {err})")
    print(f"path {label}: {n} served logits bit-equal to direct apply and "
          f"to the plain-version forward (max |diff| {err})", flush=True)
    return eng, served, counts


def register_plain_backend():
    """Register backend "plain": the kernels' plain versions, taking the
    activation wire format in and out as the kernels' backend does (phase
    6).  Returns its (matmul, conv)."""
    from repro_torch import engine as EG
    from repro_torch.core.prequant import act_block, is_prequant
    from repro_torch.kernels import bfp_conv as KC
    from repro_torch.kernels import bfp_matmul as KM

    def epilogue(out_policy):
        return ((None, None) if out_policy is None
                else (out_policy.l_i, out_policy.block_k))

    def wire(out):
        return {"m": out[0], "s": out[1]} if isinstance(out, tuple) else out

    def plain_matmul(x2d, w, p, out_policy=None):
        epi = epilogue(out_policy)
        if is_prequant(x2d):
            xb = act_block(x2d)
            if is_prequant(w):
                return wire(KM.bfp_matmul_xwprequant_plain(
                    x2d["m"], x2d["s"], w["m"], w["s"], p.l_i, p.l_w, xb,
                    *epi))
            return wire(KM.bfp_matmul_xprequant_plain(
                x2d["m"], x2d["s"], w, p.l_i, p.l_w, xb, *epi))
        if is_prequant(w):
            kb = w["m"].shape[0] // w["s"].shape[0]
            return wire(KM.bfp_matmul_prequant_plain(
                x2d, w["m"], w["s"], p.l_i, p.l_w, kb, *epi))
        return wire(KM.bfp_matmul_plain(x2d, w, p.l_i, p.l_w, p.block_k,
                                        *epi))

    def plain_conv(x, w, p, stride, padding, out_policy=None):
        epi = epilogue(out_policy)
        if is_prequant(w):
            kh, kw, c, _ = w["m"].shape
            kb = kh * kw * c // w["s"].shape[0]
        else:
            kb = p.block_k
        if is_prequant(x):
            if is_prequant(w):
                return wire(KC.bfp_conv2d_xwprequant_plain(
                    x["m"], x["s"], w["m"], w["s"], p.l_i, p.l_w, kb,
                    stride, padding, *epi))
            return wire(KC.bfp_conv2d_xprequant_plain(
                x["m"], x["s"], w, p.l_i, p.l_w, act_block(x), stride,
                padding, *epi))
        if is_prequant(w):
            return wire(KC.bfp_conv2d_prequant_plain(
                x, w["m"], w["s"], p.l_i, p.l_w, kb, stride, padding, *epi))
        return wire(KC.bfp_conv2d_plain(x, w, p.l_i, p.l_w, kb, stride,
                                        padding, *epi))

    EG.register_backend("plain", plain_matmul, conv=plain_conv,
                        act_prequant=True, out_quant=True)
    return plain_matmul, plain_conv


def table4_phase(dev, card, pol, vgg_params, vgg_images, r50_params,
                 r50_images, gen, launches, detail):
    """The paper's Table-4 per-layer SNR analysis on the card (see the
    module docstring, phase 10)."""
    import math

    from repro_torch import engine as EG
    from repro_torch import kernels as K
    from repro_torch.core.policy import BFPPolicy
    from repro_torch.engine import PolicyMap
    from repro_torch.models.cnn import MODELS, vgg
    from repro_torch.models.cnn import analysis as A

    t4 = detail["table4"] = {}

    def run(label, fn):
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[label] = K.launch_counts()
        t4[label] = {"seconds": secs, "rows": [
            {"path": getattr(r, "name", None) or r.path,
             **{f: getattr(r, f) for f in T4_FIELDS}} for r in rows]}
        for r in t4[label]["rows"]:
            print(f"table4 {label} {r['path']:<14} "
                  + " ".join(f"{f}={r[f]:.4f}" for f in T4_FIELDS),
                  flush=True)
        print(f"table4 {label}: {len(rows)} rows in {secs:.3f} s, launches "
              f"{ {k: v for k, v in launches[label].items() if v} }  "
              f"[{card}]", flush=True)
        return rows

    def db_close(got, want, tol):
        return all(a == b or abs(a - b) < tol
                   for g, w in zip(got, want)
                   for a, b in ((getattr(g, f), getattr(w, f))
                                for f in T4_FIELDS))

    # full-width VGG16, batch 2, the paper's policy (EQ4, L = 8: the
    # emulated datapath, no kernel)
    label = "table4_vgg16"
    rows = run(label, lambda: A.analyze_vgg(vgg_params, vgg_images[:2].to(
        dev), BFPPolicy()))
    vals = [getattr(r, f) for r in rows for f in T4_FIELDS]
    out_dev = max(abs(r.output_ex - r.output_multi) for r in rows)
    relu_dev = max(abs(r.relu_ex - r.output_ex) for r in rows)
    t4[label].update(max_output_dev_db=out_dev, max_relu_dev_db=relu_dev)
    print(f"table4 {label}: max |output_ex - output_multi| {out_dev:.4f} dB "
          f"(envelope 8.9), max |relu_ex - output_ex| {relu_dev:.4f} dB "
          f"(1.5)", flush=True)
    check([r.name for r in rows] == vgg.conv_names(),
          f"{label}: rows {[r.name for r in rows]}")
    check(all(math.isfinite(v) for v in vals), f"{label}: a non-finite SNR")
    check(out_dev < 8.9, f"{label}: output SNR off the multi-layer model "
                         f"by {out_dev} dB")
    check(relu_dev < 1.5, f"{label}: ReLU moved the SNR by {relu_dev} dB")
    check(not any(launches[label].values()),
          f"{label}: a kernel ran on the emulated path {launches[label]}")

    # full-width ResNet-50, batch 2, TILED on the kernels with float
    # weights, and the same analysis through the plain versions
    def r50_policy(backend):
        p = pol.with_(backend=backend)
        return PolicyMap.of(*((pat, p.with_(block_k=blk))
                              for pat, blk in R50_T4_BLOCKS), default=p)

    def r50_analysis(backend, events):
        with EG.taps(lambda ev: events.append(ev) if ev.policy is not None
                     else None):
            return A.analyze_model(MODELS["resnet50"].apply, r50_params,
                                   r50_images[:2].to(dev),
                                   r50_policy(backend))

    label = "table4_resnet50"
    kev, pev = [], []
    rows = run(label, lambda: r50_analysis(pol.backend_name, kev))
    want = {**dict.fromkeys(launches[label], 0), **R50_T4_LAUNCHES}
    check(launches[label] == want,
          f"{label}: launches {launches[label]} != {want}")
    prows = r50_analysis("plain", pev)
    check(len(rows) == len(prows) == 54 and len(kev) == len(pev) == 54,
          f"{label}: {len(rows)} / {len(prows)} rows, {len(kev)} / "
          f"{len(pev)} BFP sites")
    ydiff = max(diff(a.y, b.y) for a, b in zip(kev, pev))
    check(all(a.path == b.path and same_bits(a.y, b.y)
              for a, b in zip(kev, pev)),
          f"{label}: a site's BFP output differs from the plain-version run "
          f"(max |diff| {ydiff})")
    check(db_close(rows, prows, 1e-4),
          f"{label}: rows differ from the plain-version analysis")
    check(not any(math.isnan(getattr(r, f)) for r in rows
                  for f in T4_FIELDS), f"{label}: a NaN SNR")
    t4[label]["max_output_dev_db"] = max(
        abs(r.output_ex - r.output_multi) for r in rows)
    print(f"table4 {label}: {len(rows)} rows equal to the plain-version "
          f"analysis "
          f"within 1e-4 dB, every site's BFP output torch.equal to it; max "
          f"|output_ex - output_multi| "
          f"{t4[label]['max_output_dev_db']:.4f} dB", flush=True)

    # reduced VGG16: the card's rows against the CPU's (the ones the CPU
    # tests hold against the reference)
    label = "table4_vgg16_reduced"
    small = vgg.init(gen, 10, width_mult=0.25, input_hw=32, fc_dim=64,
                     device="cpu")
    xs = torch.randn((2, 32, 32, 3), generator=gen)
    cpu_rows = A.analyze_vgg(small, xs, BFPPolicy())
    rows = run(label, lambda: A.analyze_vgg(
        {k: {n: v.to(dev) for n, v in p.items()} for k, p in small.items()},
        xs.to(dev), BFPPolicy()))
    check([r.name for r in rows] == [r.name for r in cpu_rows]
          and db_close(rows, cpu_rows, 1e-3),
          f"{label}: card rows differ from the CPU rows by more than 1e-3 dB")
    print(f"table4 {label}: {len(rows)} card rows within 1e-3 dB of the "
          f"CPU's", flush=True)


#: the campaign of phase 11, run on the card and on the CPU
CAMPAIGN = {"models": ("lenet", "cifarnet"), "l_values": (6, 8),
            "bers": (1e-3, 1e-2), "seed": 0}
#: the serve CLI runs of phase 11 (each a subprocess, on the card)
CLI_RUNS = (("--model", "resnet50", "--scale", "full", "--requests", "16",
             "--slots", "8", "--bfp", "--prequant", "--strict-backend"),
            ("--tenants", "lenet,cifarnet", "--requests", "12", "--bfp"))


def dir_bytes(d: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f))
               for r, _, fs in os.walk(d) for f in fs)


def packed_phase(dev, card, pol, detail, vgg_params, vgg_images, vgg_served,
                 vgg_counts, r50, r50_served):
    """Packed BFP artifacts end to end on the card (see the module
    docstring, phase 11)."""
    from repro_torch import _tree
    from repro_torch import engine as EG
    from repro_torch import kernels as K
    from repro_torch.checkpoint import store
    from repro_torch.core import nsr as NSR
    from repro_torch.core.packed import is_packed, pack_param_tree
    from repro_torch.faults import endurance_campaign, inject_tree
    from repro_torch.models.cnn import MODELS, head_logits, vgg
    from repro_torch.serve.tenants import MultiTenantServer, cold_start

    out = detail["packed"] = {}
    sync = torch.cuda.synchronize

    def serve16(srv, name, imgs):
        reqs = [srv.submit(name, image=imgs[i]) for i in range(16)]
        K.reset_launch_counts()
        srv.run()
        sync()
        counts = K.launch_counts()
        check(all(r.done and r.error is None for r in reqs),
              f"{name}: a request failed")
        return torch.from_numpy(np.stack([r.logits for r in reqs])), counts

    def packed_leaf_ratio(tree):
        """Bytes of the packed leaves' containers over their float32
        bytes."""
        leaves = [x for x in _tree.flatten(tree, is_leaf=is_packed)[0]
                  if is_packed(x)]
        return (sum(x.nbytes for x in leaves)
                / sum(4 * x.n_elements for x in leaves), len(leaves))

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        # -- full-width VGG16 from a packed artifact ------------------------
        label = "packed_vgg16_full"
        row = out[label] = {}
        t0 = time.perf_counter()
        d32 = os.path.join(tmp, "vgg16_f32")
        store.save(d32, 0, vgg_params)
        row["save_f32_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dpk = os.path.join(tmp, "vgg16_packed")
        store.save(dpk, 0, vgg_params, format="bfp_packed", policy=pol)
        row["save_packed_s"] = time.perf_counter() - t0
        row["f32_bytes"] = dir_bytes(d32)
        row["packed_bytes"] = dir_bytes(dpk)
        row["ratio"] = row["packed_bytes"] / row["f32_bytes"]
        t0 = time.perf_counter()
        cparams = cold_start("vgg16", dpk, reduced=False, num_classes=1000,
                             device=dev)
        row["restore_s"] = time.perf_counter() - t0
        row["packed_leaf_ratio"], n_packed = packed_leaf_ratio(cparams)
        srv = MultiTenantServer(device=dev)
        t0 = time.perf_counter()
        ten = srv.add_tenant("vgg16", "vgg16", params=cparams, policy=pol,
                             prequant=False, strict_backend=True, slots=8)
        sync()
        row["unpack_bind_s"] = time.perf_counter() - t0
        x8 = vgg_images[:8].to(dev)
        t0 = time.perf_counter()
        first = head_logits(ten.plan.jit_forward(vgg.apply)(x8)).cpu()
        sync()
        row["first_forward_s"] = time.perf_counter() - t0
        check(torch.equal(first, vgg_served[:8]),
              f"{label}: first forward differs from phase 4's logits")
        served, counts = serve16(srv, "vgg16", vgg_images)
        check(torch.equal(served, vgg_served),
              f"{label}: served logits differ from phase 4's (max |diff| "
              f"{diff(served, vgg_served)})")
        check(counts == vgg_counts,
              f"{label}: launches {counts} != phase 4's {vgg_counts}")
        row["launches"] = counts
        # the float32 artifact restored and bound beside it; its plan's
        # sidecars are the packed plan's, bit for bit
        template = MODELS["vgg16"].init(torch.Generator(), reduced=False,
                                        num_classes=1000, device="meta")
        t0 = time.perf_counter()
        fparams, _ = store.restore(d32, template, device=dev)
        fplan = EG.bind(fparams, pol, tree="cnn", strict=True, device=dev)
        sync()
        row["f32_restore_bind_s"] = time.perf_counter() - t0
        check(same_tree(ten.plan.params, fplan.params, nan_aware=False),
              f"{label}: unpacked sidecars differ from the float32 "
              f"artifact's bind")
        del fparams, fplan, cparams, srv, ten
        shutil.rmtree(d32)
        print(f"path {label}: artifacts float32 {row['f32_bytes']} B, "
              f"bfp_packed {row['packed_bytes']} B, ratio "
              f"{row['ratio']:.4f} ({n_packed} packed leaves at "
              f"{row['packed_leaf_ratio']:.4f} of their float32 bytes); 16 "
              f"served logits torch.equal to phase 4's, launches equal to "
              f"phase 4's {({k: v for k, v in counts.items() if v})}, "
              f"sidecars torch.equal to the float32 artifact's bind",
              flush=True)
        print(f"time {label}: cold start restore {row['restore_s']:.4f} s, "
              f"unpack + bind {row['unpack_bind_s']:.4f} s, first forward "
              f"batch 8 {row['first_forward_s']:.4f} s (kernels already "
              f"built in this process); float32 restore + bind "
              f"{row['f32_restore_bind_s']:.4f} s; saves: float32 "
              f"{row['save_f32_s']:.4f} s, packed {row['save_packed_s']:.4f}"
              f" s  [{card}]", flush=True)

        # -- full-width ResNet-50 from bfp_packed and bfp_packed_v2 --------
        label = "packed_resnet50_full"
        row = out[label] = {}
        apply, imgs = r50["apply"], r50["images"]
        want = {k: v * 2 for k, v in MODEL_LAUNCHES["resnet50_full"].items()}
        srv = MultiTenantServer(device=dev)
        d32 = os.path.join(tmp, "r50_f32")
        store.save(d32, 0, r50["params"])
        row["f32_bytes"] = dir_bytes(d32)
        shutil.rmtree(d32)
        for fmt in ("bfp_packed", "bfp_packed_v2"):
            d = os.path.join(tmp, f"r50_{fmt}")
            store.save(d, 0, r50["params"], format=fmt, policy=pol)
            t0 = time.perf_counter()
            ten = srv.add_tenant(fmt, "resnet50", checkpoint_dir=d,
                                 policy=pol, reduced=False,
                                 num_classes=1000, strict_backend=True,
                                 slots=8)
            sync()
            secs = time.perf_counter() - t0
            served, counts = serve16(srv, fmt, imgs)
            got = {k: counts[k] for k in want}
            check(got == want and sum(counts.values()) == sum(want.values()),
                  f"{label} {fmt}: launches {counts} != {want}")
            check(torch.equal(served, r50_served),
                  f"{label} {fmt}: served logits differ from phase 8's "
                  f"(max |diff| {diff(served, r50_served)})")
            row[fmt] = {"bytes": dir_bytes(d), "cold_start_s": secs}
            print(f"path {label} {fmt}: {row[fmt]['bytes']} B "
                  f"({row[fmt]['bytes'] / row['f32_bytes']:.4f} of the "
                  f"float32 artifact), cold start (restore + unpack + bind) "
                  f"{secs:.4f} s, 16 served logits torch.equal to phase 8's, "
                  f"launches as MODEL_LAUNCHES  [{card}]", flush=True)
        shared = srv.add_tenant("shared", "resnet50", plan=ten.plan, slots=8)
        check(shared.engine._fwd is ten.engine._fwd,
              f"{label}: the plan= tenant does not share the forward")
        served, counts = serve16(srv, "shared", imgs)
        check(torch.equal(served, r50_served) and
              counts == {**dict.fromkeys(counts, 0), **want},
              f"{label}: the plan= tenant's logits or launches differ")
        st = srv.stats()
        check(st["total"]["completed"] == 48 and st["total"]["failed"] == 0
              and all(v["completed"] == 16 for v in st["tenants"].values()),
              f"{label}: stats {st}")
        print(f"path {label}: a tenant on the bfp_packed_v2 tenant's plan "
              f"shares its forward and serves the same logits; stats total "
              f"{st['total']}", flush=True)

        # -- faults in the packed ResNet-50 weights, on the kernels ---------
        label = "faults_resnet50_full"
        row = out[label] = {}
        pk = pack_param_tree(r50["params"], pol)
        x8, clean = imgs[:8].to(dev), r50_served[:8]
        per_fwd = dict(MODEL_LAUNCHES["resnet50_full"])
        nsr = {}
        for target in ("exponent", "mantissa_msb", "mantissa_lsb"):
            tree_f, n = inject_tree(pk, target, 1e-3, 0)
            kplan = EG.bind(tree_f, pol, tree="cnn", strict=True, device=dev)
            K.reset_launch_counts()
            got = head_logits(kplan.jit_forward(apply)(x8)).cpu()
            sync()
            counts = K.launch_counts()
            pplan = EG.bind(tree_f, pol.with_(backend="plain"), tree="cnn",
                            strict=True, device=dev)
            plain = head_logits(pplan.jit_forward(apply)(x8)).cpu()
            check({k: counts[k] for k in per_fwd} == per_fwd,
                  f"{label} {target}: launches {counts}")
            check(same_bits(got, plain),
                  f"{label} {target}: the kernels' faulty forward differs "
                  f"from the plain versions' (max |diff| {diff(got, plain)})")
            finite = bool(torch.isfinite(got).all())
            snr = float(NSR.snr_db(clean, got)) if finite else float("-inf")
            agree = float((got.argmax(-1) == clean.argmax(-1)).float()
                          .mean())
            nsr[target] = 10.0 ** (-snr / 10.0)
            amax = got.abs().nan_to_num(0.0).max().item()
            row[target] = {"n_flips": n, "top1_agree": agree, "snr_db": snr,
                           "finite": finite, "max_abs_logit": amax,
                           "nonfinite_logits": int((~torch.isfinite(got))
                                                   .sum())}
            print(f"faults {label} {target} ber=1e-3 seed=0: {n} flips, "
                  f"top-1 agreement {agree:.4f}, logit SNR {snr:.4f} dB, "
                  f"finite {finite}, max |logit| {amax:.6g} (clean "
                  f"{clean.abs().max().item():.6g}); kernels == plain "
                  f"versions (NaN-aware)  [{card}]", flush=True)
        row["ordered"] = (nsr["exponent"] >= nsr["mantissa_msb"]
                          >= nsr["mantissa_lsb"])
        print(f"faults {label}: NSR exponent >= mantissa_msb >= "
              f"mantissa_lsb holds at full width: {row['ordered']}",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # -- the endurance campaign, card against CPU ---------------------------
    label = "campaign_small"
    t0 = time.perf_counter()
    rows = endurance_campaign(**CAMPAIGN, device=dev)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_rows = endurance_campaign(**CAMPAIGN, device="cpu")
    cpu_s = time.perf_counter() - t0
    for r, c in zip(rows, cpu_rows):
        same_snr = (r["snr_db"] == c["snr_db"] or
                    abs(r["snr_db"] - c["snr_db"]) < 1e-3)
        check(len(rows) == len(cpu_rows) == 24 and
              r["n_flips"] == c["n_flips"] and
              r["top1_agree"] == c["top1_agree"] and same_snr,
              f"{label}: card row {r} != CPU row {c}")
        print(f"campaign {r['model']} L={r['l']} {r['target']:<12} "
              f"ber={r['ber']:g}: flips {r['n_flips']} top-1 "
              f"{r['top1_agree']:.2f} SNR card {r['snr_db']:.4f} dB, CPU "
              f"{c['snr_db']:.4f} dB", flush=True)
    out[label] = {"rows": rows, "card_s": card_s, "cpu_s": cpu_s}
    print(f"path {label}: {len(rows)} rows, card and CPU agree (flips, "
          f"top-1, SNR within 1e-3 dB); card {card_s:.3f} s, CPU "
          f"{cpu_s:.3f} s  [{card}]", flush=True)

    # -- the serve CLI, as subprocesses on the card -------------------------
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"),
                    os.environ.get("PYTHONPATH")) if p))
    out["cli"] = []
    for argv in CLI_RUNS:
        cmd = [sys.executable, "-m", "repro_torch.launch.serve_cnn", *argv]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
        secs = time.perf_counter() - t0
        lines = run.stdout.strip().splitlines()
        check(run.returncode == 0 and lines and
              re.search(r"req/s", lines[-1]),
              f"cli {' '.join(argv)}: rc {run.returncode}\n{run.stdout}"
              f"\n{run.stderr[-3000:]}")
        out["cli"].append({"argv": list(argv), "seconds": secs,
                           "last_line": lines[-1]})
        print(f"cli {' '.join(argv)}: rc 0 in {secs:.2f} s: {lines[-1]}  "
              f"[{card}]", flush=True)


#: kernel launches per training step of ``train_vgg16_full`` (2 workers
#: of 8 images, PALLAS_TILED at block 128, float weights): the forward
#: runs 13 inline convs (each a patch format pass + the mma core; conv1_1
#: pads K = 27 to a block) and 3 inline matmuls on the mma core per
#: worker; the backward runs two ``bfp_matmul`` GEMMs per site (#dx, #dw)
#: per worker at the fitted blocks (``grad.fit_grad_policy``): on the mma
#: core (after a patch format pass) the 12 conv #dx with N' = 9C a
#: multiple of 4, the 10 conv #dw over M = 8*H*W at block 128 (conv1-4)
#: and fc6/fc7 #dx; on the tile kernel conv1_1's #dx (N' = 27), conv5's
#: three #dw (M = 1568: block 112), fc8's #dx (K' = 1000: block 125) and
#: the three fc #dw (K' = 8: block 8).  Per step: 6 + 48 mma, 16 tile
TRAIN_VGG16_LAUNCHES = {"bfp_conv2d": 26, "bfp_conv2d_pformat": 26,
                        "bfp_matmul": 70, "bfp_matmul_pformat": 54}
TRAIN_VGG16_SPLIT = {"forward mma": 6, "backward mma": 48,
                     "backward tile": 16}
#: the kernels' families in a profile, by kernel name
FAMILIES = (("mma core", "conv_mma_kernel"), ("format pass",
                                              "xformat_kernel"),
            ("patch format pass", "pformat_kernel"),
            ("tile kernel", "bfp_tile_kernel"))


def train_phase(dev, card, pol, detail, launches, vgg_params, gen):
    """BFP training on the card: full-width VGG16 steps with every
    backward GEMM on the kernels, and ``repro``'s CIFARNet trainer (see
    the module docstring, phase 12).  ``vgg_params`` are VGG16's float
    weights; their fc6 fixes the image size (K = (hw / 32)^2 * C)."""
    import dataclasses
    import math

    from repro_torch import _tree
    from repro_torch import engine as EG
    from repro_torch import kernels as K
    from repro_torch.checkpoint import store
    from repro_torch.data.pipeline import image_batch
    from repro_torch.grad import measure_gradient_nsr
    from repro_torch.grad.nsr import BACKWARD_KINDS
    from repro_torch.kernels import bfp_matmul as KM
    from repro_torch.models.cnn import MODELS, vgg
    from repro_torch.optim import optimizers as opt
    from repro_torch.train import cnn as TC

    out = detail["train"] = {}
    sync = torch.cuda.synchronize

    def live(params):
        """The params as fresh leaves that require grad."""
        leaves, treedef = _tree.flatten(params)
        leaves = [p.detach().requires_grad_() for p in leaves]
        return _tree.unflatten(treedef, leaves), leaves

    def grad_once(params, x, y, policy, nc, apply=vgg.apply):
        tree, ps = live(params)
        loss = TC.cnn_loss(tree, apply, x, y, policy, nc)
        return torch.autograd.grad(loss, ps)

    # -- train_vgg16_full: two steps at published width --------------------
    label = "train_vgg16_full"
    row = out[label] = {}
    nc = vgg_params["fc8"]["w"].shape[1]
    hw = 32 * math.isqrt(vgg_params["fc6"]["w"].shape[0]
                         // vgg_params["conv5_3"]["w"].shape[3])
    cfg = TC.CnnTrainConfig(model="vgg16", workers=2, batch=16,
                            num_classes=nc, policy=pol, grad_bits=8)
    pcfg = dataclasses.replace(cfg, policy=pol.with_(backend="plain"))
    state0 = TC.CnnTrainState(
        params=vgg_params, opt_state=opt.adamw_init(vgg_params),
        residual=_tree.tree_map(lambda p: torch.zeros(
            (cfg.workers, *p.shape), dtype=torch.float32, device=dev),
            vgg_params),
        step=torch.zeros((), dtype=torch.int32, device=dev))
    x, y, _ = image_batch(gen, nc, cfg.batch, hw, 3, device=dev)
    step, pstep = TC.make_cnn_train_step(cfg), TC.make_cnn_train_step(pcfg)
    sync()
    torch.cuda.reset_peak_memory_stats()
    state, row["steps"] = state0, []
    for i in range(2):
        K.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        new, m = step(state, (x, y))
        sync()
        wall = (time.perf_counter() - t0) * 1e3
        counts = K.launch_counts()
        loss = float(m["loss"])
        check(np.isfinite(loss) and np.isfinite(float(m["grad_norm"])),
              f"{label}: step {i + 1} loss {loss}")
        want = {**dict.fromkeys(counts, 0), **TRAIN_VGG16_LAUNCHES}
        check(counts == want, f"{label}: step {i + 1} launches "
              f"{ {k: v for k, v in counts.items() if v} } != "
              f"{TRAIN_VGG16_LAUNCHES}")
        K.reset_launch_counts()
        t0 = time.perf_counter()
        plain, pm = pstep(state, (x, y))
        sync()
        pwall = (time.perf_counter() - t0) * 1e3
        check(not any(K.launch_counts().values()),
              f"{label}: the plain-version step launched a kernel")
        check(same_tree(new, plain)
              and torch.equal(m["loss"], pm["loss"]),
              f"{label}: step {i + 1} on the kernels != the plain-version "
              f"step (params, OptState, residuals; max |diff| "
              f"{tree_diff(new, plain)})")
        if i == 0:
            launches[label] = counts
            again, _ = step(state, (x, y))
            check(same_tree(again, new),
                  f"{label}: step 1 repeated differs")
        row["steps"].append({"loss": loss, "grad_norm": float(
            m["grad_norm"]), "ms": wall, "plain_ms": pwall})
        print(f"path {label} step {i + 1}: loss {loss:.6f} grad_norm "
              f"{float(m['grad_norm']):.6f}, {wall:.1f} ms (plain versions "
              f"{pwall:.1f} ms); params, OptState and residuals torch.equal "
              f"to the plain-version step; launches "
              f"{ {k: v for k, v in counts.items() if v} }  [{card}]",
              flush=True)
        del plain
        state = new
    row["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    row["launch_split"] = TRAIN_VGG16_SPLIT
    rnorm = sum(float(torch.linalg.norm(r))
                for r in _tree.flatten(state.residual)[0])
    check(rnorm > 0, f"{label}: residuals are zero after two steps")
    print(f"path {label}: step 1 repeated torch.equal; bfp_matmul per step "
          f"{TRAIN_VGG16_LAUNCHES['bfp_matmul']} = {TRAIN_VGG16_SPLIT} "
          f"(mma = the {TRAIN_VGG16_LAUNCHES['bfp_matmul_pformat']} calls "
          f"with a patch format pass); peak memory "
          f"{row['peak_mem_gb']:.2f} GB  [{card}]", flush=True)

    # the backward of one worker's microbatch under the profiler: its wall
    # time and device time by kernel family
    x8, y8 = x[:8], y[:8]
    tree, ps = live(state.params)
    loss = TC.cnn_loss(tree, vgg.apply, x8, y8, pol, nc)
    sync()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    caught = []       # the backward GEMMs' events: operands and policy
    with torch.profiler.profile(activities=acts) as prof, EG.taps(
            lambda ev: caught.append(ev) if ev.kind in BACKWARD_KINDS
            else None):
        t0 = time.perf_counter()
        torch.autograd.grad(loss, ps)
        sync()
        bwd = (time.perf_counter() - t0) * 1e3
    fam = dict.fromkeys([f for f, _ in FAMILIES] + ["other"], 0.0)
    other = {}
    for e in prof.key_averages():
        # device events only: a host op's entry repeats its kernels' time
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0):
            key = next((f for f, n in FAMILIES if n in e.key), "other")
            fam[key] += e.self_device_time_total / 1e3
            if key == "other":
                name = e.key[:60]
                other[name] = (other.get(name, 0.0)
                               + e.self_device_time_total / 1e3)
    devt = sum(fam.values())
    top = dict(sorted(other.items(), key=lambda kv: -kv[1])[:6])
    row["backward"] = {"wall_ms": bwd, "device_ms": devt, **fam,
                       "other_top": top}
    del tree, ps, loss
    # each backward GEMM of that run alone, on contiguous copies of its
    # operands (CUDA events), beside its bound, by core
    gemms = row["backward_gemms"] = {}
    for ev in caught:
        a, b = ev.x.contiguous(), ev.w.contiguous()
        gbk = ev.policy.block_k
        (m, k), n = a.shape, b.shape[1]
        core = KM.matmul_core(False, gbk, k, n, 8, 8)
        gms = cuda_ms(lambda: KM.bfp_matmul(a, b, l_i=8, l_w=8, bk=gbk),
                      reps=3)
        bms, by = bound(a, (b,), ev.y, m, n, k)
        gemms[ev.path] = {"core": core, "M,N,K": [m, n, k], "block": gbk,
                          "ms": gms, "bound_ms": bms, "bound_by": by}
    by_core = {c: [sum(r[f] for r in gemms.values() if r["core"] == c)
                   for f in ("ms", "bound_ms")] for c in ("mma", "tile")}
    slow = sorted(gemms.items(), key=lambda kv: -kv[1]["ms"])[:4]
    del caught
    print(f"time {label} backward GEMMs (one worker): "
          + "; ".join(f"{c} {sum(r['core'] == c for r in gemms.values())} "
                      f"GEMMs {v[0]:.3f} ms (bound {v[1]:.4f})"
                      for c, v in by_core.items())
          + "; slowest " + ", ".join(
              f"{p} {r['core']} M,N,K={r['M,N,K']} bk {r['block']} "
              f"{r['ms']:.3f} ms (bound {r['bound_ms']:.4f})"
              for p, r in slow) + f"  [{card}]", flush=True)
    print(f"profile {label} backward (one worker, 8 images): wall "
          f"{bwd:.1f} ms, device {devt:.1f} ms "
          f"({'busy %.1f%%' % (100 * devt / bwd) if devt else 'not measured: no device events'}); "
          f"device ms by family "
          f"{json.dumps({k: round(v, 3) for k, v in fam.items()})}; "
          f"top other kernels (ms) "
          f"{json.dumps({k: round(v, 3) for k, v in top.items()})}  "
          f"[{card}]", flush=True)

    # measured gradient NSR against the bound, at full width (global
    # batch), paths and order as a reduced VGG16's on the CPU
    t0 = time.perf_counter()
    recs = measure_gradient_nsr(lambda: grad_once(state.params, x, y, pol,
                                                  nc))
    sync()
    nsr_s = time.perf_counter() - t0
    red = MODELS["vgg16"].init(torch.Generator().manual_seed(0),
                               reduced=True, device="cpu")
    cpu = measure_gradient_nsr(lambda: grad_once(
        red, torch.randn(2, 32, 32, 3, generator=gen), torch.tensor([1, 7]),
        pol, 10))
    order = [(r.path, r.kind) for r in recs]
    check(order == [(r.path, r.kind) for r in cpu] and len(order) == 32
          and order[-2:] == [("conv1_1#dx", "conv_dx"),
                             ("conv1_1#dw", "conv_dw")],
          f"{label}: gradient NSR records {order} differ from the CPU's")
    check(all(r.policy is not None and r.backend == "pallas"
              and r.within_bound for r in recs),
          f"{label}: a backward GEMM over its NSR bound or off the kernels: "
          f"{[(r.path, r.eta_measured, r.eta_bound) for r in recs if not r.within_bound]}")
    worst = max(recs, key=lambda r: r.eta_measured / r.eta_bound)
    row["nsr"] = {"records": len(recs), "seconds": nsr_s,
                  "worst": [worst.path, worst.eta_measured, worst.eta_bound],
                  "eta": {r.path: [r.eta_measured, r.eta_bound,
                                   r.policy.block_k] for r in recs}}
    print(f"nsr {label}: {len(recs)} backward GEMMs on the kernels, each "
          f"eta_measured <= eta_bound, in the CPU's order; worst "
          f"{worst.path} {worst.eta_measured:.3e} <= {worst.eta_bound:.3e}; "
          f"{nsr_s:.2f} s  [{card}]", flush=True)
    del state, state0, x, y

    # -- train_cifarnet: repro's trainer configuration ----------------------
    label = "train_cifarnet"
    row = out[label] = {}
    ccfg = TC.CnnTrainConfig(model="cifarnet", workers=2, batch=64,
                             policy=pol, grad_bits=8)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        K.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        res = TC.train_cnn(ccfg, steps=8, packed_wire_steps=1,
                           measure_nsr_every=8,
                           ckpt_dir=os.path.join(tmp, "ck"), device=dev)
        sync()
        row["train_s"] = time.perf_counter() - t0
        launches[label] = K.launch_counts()
        losses = [h["loss"] for h in res["history"]]
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"{label}: the loss did not fall: {losses}")
        wire = res["wire_bytes"]
        check(wire["measured_bytes"] == wire["per_step_bytes"]
              * wire["packed_steps"] > 0,
              f"{label}: measured wire bytes {wire} != wire_report's")
        recs = res["nsr_records"]
        check(len(recs) == 10 and all(r.within_bound for r in recs),
              f"{label}: NSR records {[(r.path, r.eta_measured, r.eta_bound) for r in recs]}")
        st = res["state"]
        d2 = os.path.join(tmp, "ck2")
        store.save(d2, int(st.step), st)
        back, bstep = store.restore(d2, st, device=dev)
        check(bstep == 8 and isinstance(back, TC.CnnTrainState)
              and same_tree(back, st),
              f"{label}: the checkpoint round trip differs")
        s0 = TC.init_state(ccfg, device=dev)
        xb, yb, _ = TC.data_batch(ccfg, 0, device=dev)
        sw, mw = TC.packed_exchange_step(ccfg, s0, (xb, yb))
        sm, mm = TC.make_cnn_train_step(ccfg)(s0, (xb, yb))
        check(same_tree(sw, sm)
              and torch.equal(mw["loss"], mm["loss"])
              and mw["wire_bytes"] == wire["per_step_bytes"],
              f"{label}: the packed exchange differs from the in-graph "
              f"step (max |diff| {tree_diff(sw, sm)})")
        # step 1 on the kernels against the same step on the plain
        # versions, on the card: bit for bit
        pccfg = dataclasses.replace(ccfg, policy=pol.with_(backend="plain"))
        K.reset_launch_counts()
        sp, mp = TC.make_cnn_train_step(pccfg)(s0, (xb, yb))
        check(not any(K.launch_counts().values()),
              f"{label}: the plain-version step launched a kernel")
        check(same_tree(sm, sp)
              and torch.equal(mm["loss"], mp["loss"]),
              f"{label}: step 1 on the kernels != the plain-version step "
              f"(params, OptState, residuals; max |diff| "
              f"{tree_diff(sm, sp)})")
        # and against the same step on the CPU, by the CPU parity test's
        # rule (tests/test_torch_train_cnn.py): float reductions (the
        # log-softmax, col2im, the bias sums) order differently there
        s0c = TC.init_state(ccfg, device="cpu")
        xc, yc, _ = TC.data_batch(ccfg, 0, device="cpu")
        t0 = time.perf_counter()
        sc, mc = TC.make_cnn_train_step(ccfg)(s0c, (xc, yc))
        cpu_s = time.perf_counter() - t0
        check(same_tree(s0c, tree_leaves(s0, "cpu"))
              and torch.equal(xc, xb.cpu()),
              f"{label}: the CPU's initial state or batch differs")
        dloss = abs(float(mc["loss"]) - float(mm["loss"]))
        dnorm = abs(float(mc["grad_norm"]) - float(mm["grad_norm"]))
        check(dloss <= 1e-5 * abs(float(mc["loss"]))
              and dnorm <= 1e-4 * float(mc["grad_norm"]),
              f"{label}: step 1 on the card vs the CPU: loss diff {dloss}, "
              f"grad_norm diff {dnorm}")
        # the gradients before AdamW (whose first update is about
        # lr * sign(g) and hides their size): one worker's microbatch
        w = ccfg.batch // ccfg.workers
        apply = MODELS["cifarnet"].apply
        gd = grad_once(s0.params, xb[:w], yb[:w], pol, ccfg.num_classes,
                       apply)
        gc = grad_once(s0c.params, xc[:w], yc[:w], pol, ccfg.num_classes,
                       apply)
        far = {"params": [], "grads": []}
        for what, pairs in (("params", zip(tree_leaves(sm.params, "cpu"),
                                           tree_leaves(sc.params))),
                            ("grads", zip((g.cpu() for g in gd), gc))):
            for u, v in pairs:
                d = (u - v).abs()
                far[what].append(float((d > 1e-5 * v.abs() + 1e-5 * float(
                    v.abs().max())).float().mean()))
        dparam = diff(tree_leaves(sm.params, "cpu"), tree_leaves(sc.params))
        check(max(far["params"] + far["grads"]) <= 0.01
              and dparam <= 2.5 * ccfg.lr,
              f"{label}: step 1 on the card vs the CPU: share of elements "
              f"off by more than 1e-5 relative + 1e-5 of the largest "
              f"{far}, params max |diff| {dparam}")
        row.update({"losses": losses, "accuracy": res["accuracy"],
                    "wire": wire, "nsr_records": len(recs),
                    "cpu_step_s": cpu_s, "card_vs_cpu_loss": dloss,
                    "card_vs_cpu_grad_norm": dnorm,
                    "card_vs_cpu_params": dparam,
                    "card_vs_cpu_far_share": {k: max(v) for k, v in
                                              far.items()}})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"path {label}: 8 steps in {row['train_s']:.2f} s, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, accuracy "
          f"{res['accuracy']:.3f}; 1 packed step of "
          f"{wire['measured_bytes']} B = wire_report's (ratio "
          f"{wire['ratio']:.4f}), packed == in-graph bit for bit; "
          f"{len(recs)} NSR records within bound; checkpoint round trip "
          f"torch.equal; step 1 torch.equal to the plain-version step; "
          f"vs the CPU: loss {dloss:.2e}, grad_norm {dnorm:.2e}, params "
          f"{dparam:.2e}, share off by > 1e-5 "
          f"{ {k: max(v) for k, v in far.items()} } (CPU step "
          f"{cpu_s:.2f} s); launches "
          f"{ {k: v for k, v in launches[label].items() if v} }  "
          f"[{card}]", flush=True)


#: phase 13's open-loop runs of ResNet-50: (label, fraction of the
#: closed-loop capacity, batching, max_wait)
LOAD_RUNS = (("continuous_0.5x", 0.5, "continuous", 4),
             ("continuous_0.9x", 0.9, "continuous", 4),
             ("bucket_0.9x", 0.9, "bucket", 2))
#: tuned / untuned batch-8 forward A/B pairs (one pair misleads)
AB_PAIRS = 12


def tuned_phase(dev, card, pol, detail, launches, vgg_params, vgg_images,
                vgg_served, vgg_counts, gen):
    """``tuned_vgg16_full``: phase 4's VGG16 sites tuned on the card, the
    canonical GEMMs with a free block, and phase 4's 16 requests served
    from a plan bound with the cache (see the module docstring, phase
    13)."""
    from repro_torch import engine as EG
    from repro_torch import kernels as K
    from repro_torch.kernels import bfp_matmul as KM
    from repro_torch.kernels import ops
    from repro_torch.models.cnn import vgg
    from repro_torch.serve.cnn import CnnServeEngine
    from repro_torch.tune import CARD_TARGET, TuneCache, use_cache
    from repro_torch.tune.autotune import tune_gemm, tune_plan
    from repro_torch.tune.shapes import GEMM_LAYERS

    label = "tuned_vgg16_full"
    row = detail[label] = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    try:
        path = os.path.join(tmp, "tune_cache.json")
        cache = TuneCache.load(path)
        plan = EG.bind(vgg_params, pol, tree="cnn", strict=True)
        x8 = vgg_images[:8].to(dev)
        t0 = time.perf_counter()
        ents = tune_plan(plan, vgg.apply, x8, cache=cache, max_steps=4)
        row["tune_sites_s"] = time.perf_counter() - t0
        check(sorted(ents) == sorted(plan.sites) and len(ents) == 16,
              f"{label}: tuned {sorted(ents)}, sites {sorted(plan.sites)}")
        row["entries"] = ents
        free = pol.with_(block_k=None)
        row["gemm_free"] = {}
        for name, b, k, n in GEMM_LAYERS:
            xg = torch.randn((b, k), generator=gen).to(dev)
            wg = (0.1 * torch.randn((k, n), generator=gen)).to(dev)
            ent = tune_gemm(b, k, n, free, cache=cache, x=xg, w=wg,
                            max_steps=8)
            with use_cache(cache):
                got = ops.bfp_matmul(xg, wg, free)
            want = KM.bfp_matmul_plain(xg, wg, free.l_i, free.l_w, ent["bk"])
            check(torch.equal(got, want),
                  f"{label}: {name} at its tuned bk={ent['bk']} differs "
                  f"from the plain version (max |diff| {diff(got, want)})")
            row["gemm_free"][name] = ent
            print(f"tune {label} {name} ({b},{k},{n}) free block -> "
                  f"bm={ent['bm']} bn={ent['bn']} bk={ent['bk']} "
                  f"{ent['us']:.1f} us in {ent['steps']} steps, bit-equal "
                  f"to the plain version at bk={ent['bk']}  [{card}]",
                  flush=True)
        cache.save()
        # sites of one shape (conv3_2 and conv3_3, ...) share one entry;
        # the served run below shows that every site finds one
        check(all(k.endswith(":" + CARD_TARGET) for k in cache.entries)
              and TuneCache.load(path).entries == cache.entries,
              f"{label}: saved entries {sorted(cache.entries)}")
        for site, ent in ents.items():
            tile = " ".join(f"{k}={v}" for k, v in ent.items()
                            if k not in ("us", "steps"))
            print(f"tune {label} {site}: {tile} {ent['us']:.1f} us "
                  f"({ent['steps']} steps)  [{card}]", flush=True)

        # serve phase 4's requests from a plan bound with the cache
        tplan = EG.bind(vgg_params, pol, tree="cnn", strict=True,
                        tune_cache=path)
        eng = CnnServeEngine(None, vgg.apply, tplan, slots=8)
        reqs = [eng.submit(image=vgg_images[i]) for i in range(16)]
        tc = tplan.tune_cache
        K.reset_launch_counts()
        eng.run()
        torch.cuda.synchronize()
        launches[label] = K.launch_counts()
        served = torch.from_numpy(np.stack([r.logits for r in reqs]))
        check(all(r.error is None for r in reqs)
              and eng.stats["completed"] == 16,
              f"{label}: serving stats {eng.stats}")
        check(torch.equal(served, vgg_served),
              f"{label}: tuned logits differ from phase 4's (max |diff| "
              f"{diff(served, vgg_served)})")
        check(launches[label] == vgg_counts,
              f"{label}: launches {launches[label]} != phase 4's "
              f"{vgg_counts}")
        check(tc.misses == 0 and tc.hits == 16 * eng.ncalls,
              f"{label}: cache hits {tc.hits}, misses {tc.misses} for "
              f"{16 * eng.ncalls} site runs")
        row.update(hits=tc.hits, misses=tc.misses, forwards=eng.ncalls)
        print(f"path {label}: 16 requests served from the tuned plan, "
              f"logits torch.equal to phase 4's, launches equal, cache "
              f"hits {tc.hits} misses {tc.misses} ({eng.ncalls} forwards "
              f"x 16 sites)", flush=True)

        # tuned against untuned forward, many A/B pairs
        fu, ft = plan.jit_forward(vgg.apply), tplan.jit_forward(vgg.apply)
        pairs = [(cuda_ms(lambda: fu(x8), reps=5),
                  cuda_ms(lambda: ft(x8), reps=5)) for _ in range(AB_PAIRS)]
        un, tu = (float(np.median([p[i] for p in pairs])) for i in (0, 1))
        wins = sum(b < a for a, b in pairs)
        row["forward_ab"] = {"untuned_ms": [p[0] for p in pairs],
                             "tuned_ms": [p[1] for p in pairs]}
        print(f"time {label}: forward batch 8 untuned median {un:.4f} ms, "
              f"tuned median {tu:.4f} ms, tuned faster in {wins} of "
              f"{AB_PAIRS} A/B pairs  [{card}]", flush=True)

        # the CLI's tile mode, once, as a subprocess
        cpath = os.path.join(tmp, "cli_cache.json")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "repro_torch.tune", "--smoke", "--out",
             cpath], cwd=ROOT, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")})
        row["cli_s"] = time.perf_counter() - t0
        check(res.returncode == 0,
              f"{label}: python -m repro_torch.tune --smoke exited "
              f"{res.returncode}: {res.stderr[-2000:]}")
        cli = TuneCache.load(cpath)
        check(len(cli) == 11 and all(k.endswith(":" + CARD_TARGET)
                                     for k in cli.entries),
              f"{label}: the CLI's cache {sorted(cli.entries)}")
        print(f"cli python -m repro_torch.tune --smoke: exit 0, "
              f"{len(cli)} entries on {CARD_TARGET}, "
              f"{row['cli_s']:.1f} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def precision_phase(dev, card, pol, detail, launches, vgg_params,
                    vgg_images, gen):
    """``precision_vgg16_full``: the per-site width search on phase 4's
    VGG16 on the kernels, its evidence, its ``bfp_packed_v2`` artifact
    served by a tenant, and reduced VGG16 searched on the card and on the
    CPU (see the module docstring, phase 13)."""
    from repro_torch import engine as EG
    from repro_torch import kernels as K
    from repro_torch.checkpoint import store
    from repro_torch.engine import PolicyMap
    from repro_torch.models.cnn import MODELS, head_logits, vgg
    from repro_torch.serve.tenants import MultiTenantServer, cold_start
    from repro_torch.tune import search_precision

    label = "precision_vgg16_full"
    row = detail[label] = {}
    x8 = vgg_images[:8].to(dev)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = search_precision("vgg16", reduced=False, batch=8,
                           base_policy=pol, nsr_budget=1e-2, top1_tol=0.25,
                           params=vgg_params, x=x8)
    torch.cuda.synchronize()
    row["search_s"] = time.perf_counter() - t0
    launches[label] = K.launch_counts()
    row.update(n_evals=res.n_evals, top1_agreement=res.top1_agreement,
               assignment=res.assignment)
    check(len(res.sites) == 16, f"{label}: {len(res.sites)} sites")
    for s in res.sites:
        print(f"precision {label} {s.path:<8} {s.kind:<4} l_w={s.l_w} "
              f"nsr {s.nsr_measured:.4g} (budget 1e-2) fresh "
              f"{s.nsr_fresh:.4g} <= bound {s.nsr_bound:.4g}", flush=True)
        check(s.nsr_measured <= 1e-2 and s.nsr_fresh <= s.nsr_bound,
              f"{label}: site {s.path} nsr {s.nsr_measured} fresh "
              f"{s.nsr_fresh} bound {s.nsr_bound}")
    check(res.top1_agreement >= 0.75 and launches[label]["bfp_conv2d"] > 0,
          f"{label}: agreement {res.top1_agreement}, launches "
          f"{launches[label]}")

    # the final map's tapped forward: kernels against the plain versions
    pmap = res.policy_map
    plain_map = PolicyMap(rules=tuple((r, p.with_(backend="plain"))
                                      for r, p in pmap.rules),
                          default=pmap.default.with_(backend="plain"))
    runs = {}
    for name, m in (("kernels", pmap), ("plain", plain_map)):
        evs = []
        with torch.no_grad(), EG.taps(evs.append):
            runs[name] = (evs, vgg.apply(vgg_params, x8, m))
    ek, ep = runs["kernels"][0], runs["plain"][0]
    check(len(ek) == len(ep) == 16 and all(
        a.path == b.path and a.backend == "pallas" and b.backend == "plain"
        and same_bits(a.y, b.y) for a, b in zip(ek, ep)),
        f"{label}: the map's tapped forward on the kernels differs from "
        f"the plain versions")
    direct = head_logits(runs["kernels"][1])

    # the bfp_packed_v2 artifact of the map, served by a tenant
    tmp = tempfile.mkdtemp(prefix="chip_smoke_prec_")
    try:
        dv2 = os.path.join(tmp, "vgg16_v2")
        t0 = time.perf_counter()
        store.save(dv2, 0, vgg_params, format="bfp_packed_v2", policy=pmap,
                   tree_kind="cnn")
        row["save_v2_s"] = time.perf_counter() - t0
        row["v2_bytes"] = dir_bytes(dv2)
        fixed = detail["packed"]["packed_vgg16_full"]["packed_bytes"]
        row["fixed_l_bytes"] = fixed
        t0 = time.perf_counter()
        cparams = cold_start("vgg16", dv2, reduced=False, num_classes=1000,
                             device=dev)
        row["restore_v2_s"] = time.perf_counter() - t0
        srv = MultiTenantServer(device=dev)
        srv.add_tenant("vgg16_v2", "vgg16", params=cparams, policy=pmap,
                       prequant=False, strict_backend=True, slots=8)
        reqs = [srv.submit("vgg16_v2", image=vgg_images[i])
                for i in range(8)]
        srv.run()
        served = torch.from_numpy(np.stack([r.logits for r in reqs]))
        check(all(r.error is None for r in reqs)
              and torch.equal(served, direct.cpu()),
              f"{label}: the v2 tenant's logits differ from apply(params, "
              f"map) (max |diff| {diff(served, direct.cpu())})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"path {label}: {res.n_evals} tapped forwards in "
          f"{row['search_s']:.2f} s, widths {res.assignment}, top-1 "
          f"agreement {res.top1_agreement:.3f}; every site's fresh NSR "
          f"within its bound; the map's forward on the kernels equal to "
          f"the plain versions at all 16 sites; bfp_packed_v2 "
          f"{row['v2_bytes']} B against fixed-L bfp_packed {fixed} B "
          f"({row['v2_bytes'] / fixed:.4f}; saved in {row['save_v2_s']:.2f}"
          f" s, restored in {row['restore_v2_s']:.2f} s), its tenant's "
          f"logits equal to apply(params, map)  [{card}]", flush=True)

    # reduced VGG16 searched on the card and on the CPU: the same map
    rparams = MODELS["vgg16"].init(torch.Generator().manual_seed(5),
                                   device="cpu")
    rx = torch.randn((4, 32, 32, 3), generator=torch.Generator()
                     .manual_seed(6))
    maps = {}
    for d in ("cuda", "cpu"):
        t0 = time.perf_counter()
        r = search_precision("vgg16", batch=4, base_policy=pol,
                             nsr_budget=1e-2, top1_tol=0.25,
                             params=rparams, x=rx, device=d)
        maps[d] = (r.to_dict(), time.perf_counter() - t0)
    check(maps["cuda"][0]["policy_map"] == maps["cpu"][0]["policy_map"]
          and maps["cuda"][0]["n_evals"] == maps["cpu"][0]["n_evals"],
          f"{label}: reduced VGG16's map on the card "
          f"{maps['cuda'][0]['policy_map']} != the CPU's "
          f"{maps['cpu'][0]['policy_map']}")
    print(f"path precision_vgg16_reduced: card and CPU maps equal "
          f"({maps['cuda'][0]['n_evals']} evals; card "
          f"{maps['cuda'][1]:.2f} s, CPU {maps['cpu'][1]:.2f} s)",
          flush=True)


def load_phase(dev, card, detail, launches, r50, gen):
    """``load_resnet50_full``: phase 8's ResNet-50 plan closed loop, then
    open loop on wall time at fractions of that capacity, and LeNet's
    virtual-time row on the card against the CPU's (see the module
    docstring, phase 13)."""
    from repro_torch import kernels as K
    from repro_torch.models.cnn import MODELS, head_logits
    from repro_torch.serve.cnn import CnnServeEngine, ImageRequest
    from repro_torch.serve.load import (VirtualClock, poisson_arrivals,
                                        run_open_loop)

    label = "load_resnet50_full"
    row = detail[label] = {}
    plan, apply, imgs = r50["plan"], r50["apply"], r50["images"]
    fwd = plan.jit_forward(apply)
    ref = torch.cat([head_logits(fwd(imgs[i:i + 8].to(dev))).cpu()
                     for i in (0, 8)])
    # closed loop: 64 requests submitted at once, bucket 8
    eng = CnnServeEngine(None, apply, plan, slots=8)
    reqs = [eng.submit(image=imgs[i % 16]) for i in range(64)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    cap = 64 / (time.perf_counter() - t0)
    check(all(r.error is None for r in reqs), f"{label}: closed loop failed")
    row["closed_loop_req_per_s"] = cap
    print(f"time {label}: closed loop 64 requests at batch 8, "
          f"{cap:.2f} req/s  [{card}]", flush=True)

    K.reset_launch_counts()
    for name, frac, batching, max_wait in LOAD_RUNS:
        arrivals = poisson_arrivals(frac * cap, 256, [(1.0, "img", {})],
                                    seed=7)
        clock = VirtualClock()
        eng = CnnServeEngine(None, apply, plan, slots=8, clock=clock,
                             batching=batching, max_wait=max_wait)
        done = {}

        def mk(a, done=done):
            req = ImageRequest(rid=a.rid, image=imgs[a.rid % 16])
            done[a.rid] = req
            return req

        rep = run_open_loop(eng, arrivals, mk, clock=clock)
        r = rep.row()
        row[name] = r
        check(rep.completed + rep.shed + rep.expired + rep.failed
              == rep.offered == 256 and rep.failed == 0,
              f"{label} {name}: accounting {r}")
        ok = [q for q in done.values() if q.error is None]
        check(len(ok) == rep.completed and all(
            torch.equal(torch.from_numpy(q.logits), ref[q.rid % 16])
            for q in ok), f"{label} {name}: a completed logit differs "
                          f"from its image's direct batch-8 forward")
        print(f"load {label} {name} ({frac} x {cap:.1f} req/s, {batching}"
              f"{', max_wait %d' % max_wait if batching == 'bucket' else ''}"
              f"): p50 {rep.p50_ms:.3f} ms p99 {rep.p99_ms:.3f} ms mean "
              f"{rep.mean_ms:.3f} ms, goodput {rep.goodput_rps:.2f} req/s, "
              f"completed {rep.completed} shed {rep.shed} expired "
              f"{rep.expired} failed {rep.failed}, {rep.calls} forwards  "
              f"[{card}]", flush=True)
    torch.cuda.synchronize()
    launches[label] = K.launch_counts()
    check(launches[label]["bfp_conv2d_prequant"] > 0,
          f"{label}: no kernel ran: {launches[label]}")

    # LeNet under virtual time: the card's row is the CPU's
    spec = MODELS["lenet"]
    lp = spec.init(torch.Generator().manual_seed(3), device="cpu")
    limgs = torch.randn((4, 28, 28, 1), generator=gen)
    mix = [(0.5, "a", {}), (0.5, "b", {"deadline": 0.010})]
    rows = {}
    for d in ("cuda", "cpu"):
        for batching in ("continuous", "bucket"):
            clock = VirtualClock()
            eng = CnnServeEngine(lp, spec.apply, pol_lenet(), slots=4,
                                 clock=clock, batching=batching,
                                 max_queue=3, device=d)
            arr = poisson_arrivals(3000.0, 60, mix, seed=4)
            rep = run_open_loop(eng, arr, lambda a: ImageRequest(
                rid=a.rid, image=limgs[a.rid % 4],
                deadline=None if a.deadline is None else a.t + a.deadline),
                clock=clock, call_cost=0.002)
            rows[d, batching] = rep.row()
    for batching in ("continuous", "bucket"):
        check(rows["cuda", batching] == rows["cpu", batching],
              f"{label}: LeNet's virtual-time row on the card "
              f"{rows['cuda', batching]} != the CPU's "
              f"{rows['cpu', batching]}")
    row["lenet_virtual"] = {b: rows["cuda", b]
                            for b in ("continuous", "bucket")}
    print(f"path lenet_virtual_time: rows on the card equal the CPU's "
          f"(continuous: {rows['cuda', 'continuous']['completed']} "
          f"completed, {rows['cuda', 'continuous']['shed']} shed, "
          f"{rows['cuda', 'continuous']['expired']} expired; bucket: "
          f"{rows['cuda', 'bucket']['completed']} / "
          f"{rows['cuda', 'bucket']['shed']} / "
          f"{rows['cuda', 'bucket']['expired']})", flush=True)


#: phase 14's LM paths: (label, arch, layers kept (None: the published
#: depth), requests, max_new).  Every path serves with 4 slots, a cache
#: of 256 positions and prefill chunks of 8 (continuous batching), on
#: PALLAS_TILED (block 128, L = 8), weights prequantized at admission.
#: OLMoE keeps 4 of its 16 layers (run time) and serves with capacity
#: factor 64 (no token is dropped): at the published 1.25 and 4 slots an
#: expert takes 1 token per call, so whether a request's token is dropped
#: would depend on its neighbours, and solo serving could not equal
#: batched serving (the reference's own equivalence tests lift the
#: capacity the same way, ``tests/test_models_lm.py``).
LM_PATHS = (("lm_tinyllama_full", "tinyllama-1.1b", None, 8, 32),
            ("lm_olmoe_width", "olmoe-1b-7b", 4, 4, 8))
#: phase 15's recurrent LM paths, served like phase 14's: (label, arch,
#: layers kept, requests, max_new, site paths left float by the
#: prequant walk).  RWKV6-3B at its published depth; its decay LoRA's
#: second matrix (``tm/wB``, K = 64 < block 128) stays float.
#: RecurrentGemma-9B keeps 5 of its 38 layers: one (rec, rec, attn)
#: period and the two trailing rec blocks, so the period loop and the
#: remainder both run (full depth is 9.40 B params, 37.6 GB f32 at
#: init, for no other code path).
LM_RECURRENT_PATHS = (
    ("lm_rwkv6_full", "rwkv6-3b", None, 8, 16, ("tm/wB",)),
    ("lm_griffin_width", "recurrentgemma-9b", 5, 4, 8, ()))
#: phase 15's encoder-decoder: seamless-m4t-medium at its published
#: configuration through ``serve.generate(enc_feats=)`` (``ServeEngine``
#: refuses an encoder-decoder, as in the reference): (label, arch, rows,
#: encoder frames, prompt tokens, max_new)
LM_ENCDEC_PATH = ("lm_seamless_full", "seamless-m4t-medium", 4, 1024, 8,
                  16)
#: the LM serve CLI runs of phase 14 (each a subprocess, on the card)
LM_CLI_RUNS = (("--arch", "tinyllama-1.1b", "--scale", "smoke",
                "--requests", "2", "--max-new", "4", "--bfp",
                "--bfp-weights"),
               ("--arch", "rwkv6-3b", "--scale", "smoke", "--requests",
                "2", "--max-new", "4", "--bfp", "--bfp-weights"))
#: decode steps timed one by one (CUDA events) for the median
LM_TIMED_STEPS = 20
#: the kernel families of an LM step's profile: the BFP kernels by name,
#: then cuBLAS's float GEMMs (the float backend: RWKV6's decode, R7)
LM_FAMILIES = FAMILIES + tuple(("float GEMMs", k) for k in
                              ("gemm", "gemv", "xmma", "cutlass"))


def lm_launches_per_call(cfg, forward: bool = False):
    """{counter: launches} of one ``decode_step`` call (``forward``: one
    ``forward``) at PALLAS_TILED, block 128, read from the model code.
    Every layer linear is prequantized (block 128 divides every K, N %
    4 == 0) and runs the mma core after one activation format pass: 7 an
    attention block (4 with MoE, whose expert GEMMs run the emulated
    datapath), 8 a Griffin rec block (in_g, in_x, wr, wi, out, ffn w1-3),
    11 a decoder block with cross-attention.  RWKV6's decode forms drop
    the policy (R7): no layer GEMM on the kernels; its forward runs 9
    prequant linears a layer and ``tm/wB`` (K = 64, float) on the
    patch pass and the core.  ``lm_head``: a tied head multiplies the
    float ``embed.T`` (patch pass + core); a vocabulary with N % 4 != 0
    (seamless' 256,206) runs the tile kernel, with no pass."""
    from repro_torch.models.lm.model import _hybrid_layout

    out = {}
    if cfg.family == "ssm":
        layer = 9 * cfg.n_layers if forward else 0
        if forward:
            out = {"bfp_matmul": cfg.n_layers,
                   "bfp_matmul_pformat": cfg.n_layers}
    elif cfg.block_pattern:
        n_periods, rem = _hybrid_layout(cfg)
        layer = 8 * (2 * n_periods + len(rem)) + 7 * n_periods
    elif cfg.is_encdec:
        layer = 11 * cfg.n_layers
    else:
        layer = cfg.n_layers * (4 if cfg.is_moe else 7)
    out.update(bfp_matmul_prequant=layer, bfp_matmul_xformat=layer)
    head = "bfp_matmul" if cfg.tie_embeddings else "bfp_matmul_prequant"
    out[head] = out.get(head, 0) + 1
    if cfg.vocab_size % 4 == 0:
        fmt = ("bfp_matmul_pformat" if cfg.tie_embeddings
               else "bfp_matmul_xformat")
        out[fmt] = out.get(fmt, 0) + 1
    return {k: v for k, v in out.items() if v}


def mma_per_call(per_call) -> int:
    """mma-core launches of a call: one after each format pass."""
    return (per_call.get("bfp_matmul_xformat", 0)
            + per_call.get("bfp_matmul_pformat", 0))


def kernel_gemm_bound(events):
    """(bound_ms, bound_by, bytes, ops) of the GEMMs that ran on the
    kernels among tapped engine ``events`` (GEMMs on the float backend,
    RWKV6's decode linears, and the MoE experts, which are no engine
    site, are left out): each weight (int8 mantissas and f32 steps, or
    a float weight), x and output read or written once against the HBM
    rate, 2*M*N*K int8 operations against the int8 peak."""
    nbytes = ops = 0
    for ev in events:
        b, o = gemm_cost(ev)
        nbytes, ops = nbytes + b, ops + o
    return bound_of(nbytes, ops)


def gemm_cost(ev):
    """(bytes, ops) of one tapped engine GEMM for :func:`kernel_gemm_bound`
    ((0, 0) off the kernels), from its shapes: nothing is kept."""
    if ev.backend == "float" or ev.policy is None:
        return 0, 0
    w = ev.w
    parts = [w["m"], w["s"]] if isinstance(w, dict) else [w]
    k, n = parts[0].shape[-2:]
    m = ev.x.numel() // ev.x.shape[-1]
    return (sum(p.numel() * p.element_size() for p in parts)
            + m * k * 4 + m * n * 4, 2 * m * k * n)


def bound_of(nbytes, ops):
    """(bound_ms, bound_by, bytes, ops) of GEMMs moving ``nbytes`` and
    doing ``ops`` int8 operations."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT8_OPS_PER_S * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
            ) + (nbytes, ops)


def lm_step_bound(plan, cfg, cache, tok, pos):
    """:func:`kernel_gemm_bound` of one ``decode_step`` (tapped)."""
    from repro_torch import engine as EG
    from repro_torch.models.lm import model as LM

    events = []
    with torch.inference_mode(), EG.taps(events.append):
        LM.decode_step(plan.params, cfg, cache, tok, pos, plan)
    return kernel_gemm_bound(events)


def profile_step(step, per_mma):
    """Device ms of one call of ``step()`` by kernel family
    (``LM_FAMILIES`` and "other"), the fullest of ``PROFILE_TRIES``
    captures by mma-core events.  Returns (mma events, families, wall
    ms)."""
    best = None
    for _ in range(PROFILE_TRIES):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        fam = dict.fromkeys([f for f, _ in LM_FAMILIES] + ["other"], 0.0)
        n_mma = 0
        for e in prof.key_averages():
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or e.self_device_time_total <= 0):
                continue
            key = next((f for f, kname in LM_FAMILIES if kname in e.key),
                       "other")
            fam[key] += e.self_device_time_total / 1e3
            n_mma += e.count if key == "mma core" else 0
        if best is None or n_mma > best[0]:
            best = (n_mma, fam, wall)
        if n_mma == per_mma:
            break
    return best


def time_head(label, plan, pplan, x, row, card):
    """``lm_head`` alone at the step's x (CUDA events): the kernel route
    the plan gives it, its plain version, and its bound."""
    from repro_torch import engine as EG

    events = []
    with torch.inference_mode(), EG.taps(events.append):
        head = plan.params.get("lm_head", {}).get("w")
        tied = head is None
        w = plan.params["embed"]["e"].t() if tied else head
        y = EG.gemm(x, w, plan, path="lm_head")
        wp = pplan.params["embed"]["e"].t() if tied else \
            pplan.params["lm_head"]["w"]
        yp = EG.gemm(x, wp, pplan, path="lm_head")
    check(torch.equal(y, yp), f"{label}: lm_head on the kernels differs "
                              f"from its plain version")
    with torch.inference_mode():
        ms = cuda_ms(lambda: EG.gemm(x, w, plan, path="lm_head"), 10)
        plain = cuda_ms(lambda: EG.gemm(x, wp, pplan, path="lm_head"), 3)
    bms, by, nbytes, _ = kernel_gemm_bound(events[:1])
    row["lm_head"] = {"ms": ms, "plain_ms": plain, "bound_ms": bms,
                      "bound_by": by, "tied": tied, "m": x.numel() //
                      x.shape[-1]}
    print(f"time {label} lm_head ({'tied: float embed.T, patch pass + mma'
          if tied else 'prequant'}, M = {row['lm_head']['m']}): kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.4f} ms ({by}, "
          f"{nbytes / 1e9:.4f} GB)  [{card}]", flush=True)


def lm_path(label, cfg, n_req, max_new, dev, card, seed, detail,
            launches, float_sites=(), forward_check=False):
    """One served LM path of phases 14 and 15 (see the module
    docstring).  ``float_sites``: the site paths the prequant walk leaves
    float; ``forward_check``: also hold a forward over B = 2, S = 64 on
    the kernels ``torch.equal`` to the plain versions, and time it."""
    import statistics

    from repro_torch import engine as EG
    from repro_torch import kernels as K
    from repro_torch.core.policy import PALLAS_TILED
    from repro_torch.models.lm import model as LM
    from repro_torch.serve.engine import Request, ServeEngine

    sync = torch.cuda.synchronize
    row = detail[label] = {}
    pol = PALLAS_TILED.with_(straight_through=False)
    geometry = dict(slots=4, max_len=256, prefill_chunk=8, device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = LM.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), device=dev)
    sync()
    row["init_s"] = time.perf_counter() - t0
    row["params"] = LM.param_count(params)
    t0 = time.perf_counter()
    eng = ServeEngine(params, cfg, policy=pol, prequant=pol,
                      strict_backend=True, **geometry)
    sync()
    row["bind_prequant_s"] = time.perf_counter() - t0
    del params            # the engine holds the prequantized tree
    qparams = eng.params
    sites = eng.plan.sites
    check(all(s.backend.name == "pallas" and not s.fallback
              and s.prequantized == (p not in float_sites)
              for p, s in sites.items())
          and set(float_sites) <= set(sites),
          f"{label}: a site is not on the kernels, or not prequantized "
          f"but for {float_sites}: {eng.plan.describe()}")
    g = torch.Generator().manual_seed(seed + 1)
    lens = torch.randint(8, 65, (n_req,), generator=g).tolist()
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()
               for n in lens]
    per_call = lm_launches_per_call(cfg)

    def serve(engine, tag):
        reqs = [Request(rid=i, prompt=list(p), max_new=max_new)
                for i, p in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        sync()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        engine.run()
        sync()
        secs = time.perf_counter() - t0
        counts = K.launch_counts()
        check(all(r.done and r.error is None and len(r.out) == max_new
                  for r in reqs),
              f"{label} {tag}: a request failed: "
              f"{[repr(r.error) for r in reqs if r.error]}")
        st = engine.stats
        check(st["completed"] == len(reqs) and st["failed"] == 0
              and st["float_retries"] == 0 and st["expired"] == 0,
              f"{label} {tag}: serving stats {st}")
        want = {**dict.fromkeys(counts, 0),
                **{k: v * engine.ncalls for k, v in per_call.items()}}
        check(counts == want, f"{label} {tag}: launches {counts} != "
                              f"{want}")
        return [r.out for r in reqs], secs, counts

    outs, secs, counts = serve(eng, "continuous")
    launches[label] = counts
    gen_tokens = n_req * max_new
    row.update(serve_s=secs, calls=eng.ncalls, tokens=gen_tokens,
               prompt_tokens=sum(lens), tokens_per_s=gen_tokens / secs,
               launches_per_call=per_call)
    print(f"path {label}: {n_req} requests (prompts {min(lens)}-"
          f"{max(lens)} tokens, max_new {max_new}, 4 slots, chunk 8): "
          f"stats {eng.stats}, {eng.ncalls} decode_step calls, launches "
          f"{({k: v for k, v in counts.items() if v})} = {per_call} per "
          f"call as predicted", flush=True)

    # solo serving on fresh engines of the same geometry (the sidecars
    # bound again, not formatted again), then bucket batching
    for i, p in enumerate(prompts):
        solo = ServeEngine(qparams, cfg, policy=pol, strict_backend=True,
                           **geometry)
        r = Request(rid=i, prompt=list(p), max_new=max_new)
        solo.submit(r)
        solo.run()
        check(r.error is None and r.out == outs[i],
              f"{label}: request {i} alone gave {r.out}, batched "
              f"{outs[i]}")
    bucket = ServeEngine(qparams, cfg, policy=pol, strict_backend=True,
                         batching="bucket", **geometry)
    outs_b, secs_b, _ = serve(bucket, "bucket")
    check(outs_b == outs, f"{label}: bucket tokens differ from continuous")
    row.update(bucket_s=secs_b, bucket_calls=bucket.ncalls)
    del solo, bucket

    # four decode steps from one fresh cache: kernels against the plain
    # versions (backend "plain", the same sidecars)
    pplan = EG.bind(qparams, pol.with_(backend="plain"), tree="lm",
                    strict=True, prequantize=False, device=dev)
    toks = torch.tensor([[prompts[j % n_req][i] for i in range(4)]
                         for j in range(4)], device=dev)
    runs = {}
    for name, plan in (("kernels", eng.plan), ("plain", pplan)):
        cache = LM.init_cache(cfg, 4, 256, device=dev)
        lgs = []
        with torch.inference_mode():
            for i in range(4):
                lg, cache = LM.decode_step(plan.params, cfg, cache,
                                           toks[:, i:i + 1], i, plan)
                lgs.append(lg)
        runs[name] = (torch.stack(lgs), cache)
    (lk, ck), (lp, cp) = runs["kernels"], runs["plain"]
    check(lk.shape == (4, 4, 1, cfg.vocab_size)
          and bool(torch.isfinite(lk).all()),
          f"{label}: decode logits not finite of the expected shape")
    check(torch.equal(lk, lp) and same_tree(ck, cp, nan_aware=False),
          f"{label}: four decode steps on the kernels differ from the "
          f"plain versions (max |diff| {diff(lk, lp)}, caches "
          f"{tree_diff(ck, cp)})")
    print(f"path {label}: every request alone on a fresh engine gave its "
          f"batched tokens; bucket batching ({row['bucket_calls']} calls) "
          f"gave continuous' tokens; 4 decode steps on the kernels "
          f"torch.equal to the plain versions (logits and every cache "
          f"leaf)", flush=True)

    if forward_check:
        # a forward over B = 2, S = 64 (RWKV6: two WKV chunks)
        ftoks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g).to(
            dev)
        want = lm_launches_per_call(cfg, forward=True)
        fwd = {}
        for name, plan in (("kernels", eng.plan), ("plain", pplan)):
            with torch.inference_mode():
                sync()
                K.reset_launch_counts()
                fwd[name] = LM.forward(plan.params, cfg, ftoks,
                                       policy=plan)[0]
                sync()
                fwd[name + "_counts"] = {k: v for k, v in
                                         K.launch_counts().items() if v}
        check(fwd["kernels_counts"] == want and not fwd["plain_counts"],
              f"{label}: forward launches {fwd['kernels_counts']} != "
              f"{want}")
        check(torch.equal(fwd["kernels"], fwd["plain"])
              and bool(torch.isfinite(fwd["kernels"]).all()),
              f"{label}: the forward on the kernels differs from the "
              f"plain versions (max |diff| "
              f"{diff(fwd['kernels'], fwd['plain'])})")
        with torch.inference_mode():
            fms = cuda_ms(lambda: LM.forward(eng.plan.params, cfg, ftoks,
                                             policy=eng.plan), 3)
        row.update(forward_launches=want, forward_ms=fms)
        print(f"path {label}: forward (B = 2, S = 64) on the kernels "
              f"torch.equal to the plain versions, launches {want} as "
              f"predicted; {fms:.4f} ms (CUDA events)  [{card}]",
              flush=True)
        del fwd

    # steady-state decode steps: the median of CUDA-event times, then one
    # step under the profiler (device ms by kernel family)
    cache, tok = ck, toks[:, :1]
    eng._step(cache, tok, 4)
    sync()
    ms = []
    for i in range(LM_TIMED_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        eng._step(cache, tok, 4 + i)
        stop.record()
        sync()
        ms.append(start.elapsed_time(stop))
    step_ms = statistics.median(ms)
    # device events only (one decode step issues ~1,000 kernels); a
    # capture short of mma-core events is retaken, and the fullest of
    # PROFILE_TRIES kept, its count printed beside the times
    per = mma_per_call(per_call)
    n_mma, fam, wall = profile_step(lambda: eng._step(cache, tok, 4), per)
    check(2 * n_mma >= per, f"{label}: the profiled step shows {n_mma} mma "
                            f"core launches of {per}")
    devt = sum(fam.values())
    bms, by, nbytes, ops = lm_step_bound(eng.plan, cfg, cache, tok, 4)
    if label in LM_HEAD_TIMED:
        x = torch.randn((4, 1, cfg.d_model), generator=g).to(dev)
        time_head(label, eng.plan, pplan, x, row, card)
    peak = torch.cuda.max_memory_allocated() / 1e9
    row.update(step_ms_median=step_ms, step_ms_all=ms,
               profile={"wall_ms": wall, "device_ms": devt,
                        "mma_events": n_mma, **fam},
               bound_ms=bms, bound_by=by, bound_bytes=nbytes,
               bound_ops=ops, peak_gb=peak)
    print(f"profile {label} decode step (M = 4): wall {wall:.4f} ms, "
          f"device {devt:.4f} ms (busy {100 * devt / wall:.1f}%; "
          f"{n_mma} of {per} mma-core launches captured): "
          f"{json.dumps({k: round(v, 4) for k, v in fam.items()})}; "
          f"kernel GEMMs' bound {bms:.4f} ms ({by}: {nbytes / 1e9:.4f} GB, "
          f"{ops / 1e9:.3f} GOP)  [{card}]", flush=True)
    print(f"time {label}: {gen_tokens / secs:.2f} tokens/s ({gen_tokens} "
          f"generated, {sum(lens)} prompt tokens, in {secs:.3f} s, "
          f"{eng.ncalls} calls)  [{card}]", flush=True)
    print(f"time {label}: median decode step {step_ms:.4f} ms (CUDA "
          f"events, {LM_TIMED_STEPS} steps, M = 4)  [{card}]", flush=True)
    print(f"time {label}: init {row['init_s']:.3f} s, bind + prequant "
          f"{row['bind_prequant_s']:.3f} s ({row['params'] / 1e9:.4f} B "
          f"params)  [{card}]", flush=True)
    print(f"memory {label}: peak {peak:.3f} GB allocated  [{card}]",
          flush=True)
    del eng, qparams, cache, ck, cp, pplan, runs


#: the paths whose ``lm_head`` is timed alone (the tied head's float
#: ``embed.T``; seamless' head on the tile kernel)
LM_HEAD_TIMED = ("lm_griffin_width", "lm_seamless_full")


def lm_encdec_path(dev, card, seed, detail, launches):
    """Phase 15's encoder-decoder (see the module docstring)."""
    import statistics

    from repro_torch import engine as EG
    from repro_torch import kernels as K
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core.policy import PALLAS_TILED
    from repro_torch.models.lm import model as LM
    from repro_torch.serve.engine import generate

    label, arch, b, s_enc, s_prompt, max_new = LM_ENCDEC_PATH
    cfg = ARCHS[arch]
    sync = torch.cuda.synchronize
    row = detail[label] = {}
    pol = PALLAS_TILED.with_(straight_through=False)
    print(f"path {label}: {arch} at its published configuration "
          f"({cfg.encoder_layers} + {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}) through serve.generate(enc_feats=): B = {b}, "
          f"{s_enc} frames, {s_prompt}-token prompts, {max_new} new",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = LM.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), device=dev)
    sync()
    row["init_s"] = time.perf_counter() - t0
    row["params"] = LM.param_count(params)
    t0 = time.perf_counter()
    plan = EG.bind(params, pol, tree="lm", strict=True, device=dev)
    sync()
    row["bind_prequant_s"] = time.perf_counter() - t0
    del params
    check(all(s.prequantized and s.backend.name == "pallas"
              and not s.fallback for s in plan.sites.values()),
          f"{label}: a site is not prequantized on the kernels: "
          f"{plan.describe()}")
    pplan = EG.bind(plan.params, pol.with_(backend="plain"), tree="lm",
                    strict=True, prequantize=False, device=dev)
    g = torch.Generator().manual_seed(seed + 2)
    frames = (torch.randn((b, s_enc, cfg.d_model), generator=g)
              * 0.5).to(dev)
    prompt = torch.randint(0, cfg.vocab_size, (b, s_prompt),
                           generator=g).to(dev)

    per_call = lm_launches_per_call(cfg)
    calls = s_prompt + max_new - 1
    enc_per = 7 * cfg.encoder_layers
    want = {k: v * calls for k, v in per_call.items()}
    for k in ("bfp_matmul_prequant", "bfp_matmul_xformat"):
        want[k] += enc_per
    runs = {}
    for name, p in (("kernels", plan), ("plain", pplan)):
        sync()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        runs[name] = generate(p.params, cfg, prompt, max_new, policy=p,
                              enc_feats=frames, device=dev)
        sync()
        runs[name + "_s"] = time.perf_counter() - t0
        runs[name + "_counts"] = {k: v for k, v in K.launch_counts().items()
                                  if v}
    toks, secs = runs["kernels"], runs["kernels_s"]
    check(runs["kernels_counts"] == want and not runs["plain_counts"],
          f"{label}: launches {runs['kernels_counts']} != {want}")
    check(torch.equal(toks, runs["plain"]),
          f"{label}: generated tokens differ from the plain versions'")
    launches[label] = {**dict.fromkeys(K.launch_counts(), 0),
                       **runs["kernels_counts"]}
    # row independence at this batch geometry: the rows rolled by one
    # slot give the same tokens.  A row generated alone (B = 1) runs the
    # float attention's batched products at another batch size, where
    # cuBLAS may sum in another order (an ulp that flips a BFP block
    # rounding): printed, not held
    perm = torch.roll(torch.arange(b, device=dev), 1)
    rolled = generate(plan.params, cfg, prompt[perm], max_new, policy=plan,
                      enc_feats=frames[perm], device=dev)
    check(torch.equal(rolled, toks[perm]),
          f"{label}: rows rolled by one slot gave {rolled.tolist()}, "
          f"batched {toks[perm].tolist()}")
    alone = [torch.equal(generate(plan.params, cfg, prompt[i:i + 1],
                                  max_new, policy=plan,
                                  enc_feats=frames[i:i + 1],
                                  device=dev)[0], toks[i])
             for i in range(b)]
    row["rows_alone_equal"] = alone
    gen_tokens = b * max_new
    row.update(generate_s=secs, plain_generate_s=runs["plain_s"],
               tokens=gen_tokens, tokens_per_s=gen_tokens / secs,
               launches=runs["kernels_counts"], launches_per_call=per_call,
               calls=calls)
    print(f"path {label}: generate launches {runs['kernels_counts']} = "
          f"{enc_per} (prefill_encoder) + {calls} decode_step calls x "
          f"{per_call} as predicted; tokens torch.equal to the plain "
          f"versions', and the rows rolled by one slot gave their batched "
          f"tokens; generated alone (B = 1), {sum(alone)} of {b} rows gave "
          f"their batched tokens", flush=True)

    # the encoder output and four decode steps: kernels against plain
    enc, steps = {}, {}
    for name, p in (("kernels", plan), ("plain", pplan)):
        with torch.inference_mode():
            enc[name] = LM.prefill_encoder(p.params, cfg, frames, p)
            cache = LM.init_cache(cfg, b, 64, device=dev)
            cache["enc_out"] = enc[name]
            lgs = []
            for i in range(4):
                lg, cache = LM.decode_step(p.params, cfg, cache,
                                           prompt[:, i:i + 1], i, p)
                lgs.append(lg)
        steps[name] = (torch.stack(lgs), cache)
    (lk, ck), (lp, cp) = steps["kernels"], steps["plain"]
    check(torch.equal(enc["kernels"], enc["plain"])
          and torch.equal(lk, lp) and same_tree(ck, cp, nan_aware=False)
          and bool(torch.isfinite(lk).all()),
          f"{label}: prefill_encoder or 4 decode steps on the kernels "
          f"differ from the plain versions (max |diff| {diff(lk, lp)})")
    print(f"path {label}: prefill_encoder and 4 decode steps on the "
          f"kernels torch.equal to the plain versions (encoder output, "
          f"logits, every cache leaf)", flush=True)

    def step(c=ck):
        with torch.inference_mode():
            return LM.decode_step(plan.params, cfg, c, prompt[:, :1], 4,
                                  plan)

    with torch.inference_mode():
        enc_ms = cuda_ms(lambda: LM.prefill_encoder(plan.params, cfg,
                                                    frames, plan), 3)
    step()
    sync()
    ms = []
    for _ in range(LM_TIMED_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        stop.record()
        sync()
        ms.append(start.elapsed_time(stop))
    step_ms = statistics.median(ms)
    per = mma_per_call(per_call)
    n_mma, fam, wall = profile_step(step, per)
    check(2 * n_mma >= per, f"{label}: the profiled step shows {n_mma} mma "
                            f"core launches of {per}")
    devt = sum(fam.values())
    bms, by, nbytes, ops = lm_step_bound(plan, cfg, ck, prompt[:, :1], 4)
    time_head(label, plan, pplan, torch.randn(
        (b, 1, cfg.d_model), generator=g).to(dev), row, card)
    peak = torch.cuda.max_memory_allocated() / 1e9
    row.update(step_ms_median=step_ms, step_ms_all=ms, encoder_ms=enc_ms,
               profile={"wall_ms": wall, "device_ms": devt,
                        "mma_events": n_mma, **fam},
               bound_ms=bms, bound_by=by, bound_bytes=nbytes,
               bound_ops=ops, peak_gb=peak)
    print(f"profile {label} decode step (M = {b}, cross-attention K/V over "
          f"{s_enc} frames a row): wall {wall:.4f} ms, device {devt:.4f} "
          f"ms (busy {100 * devt / wall:.1f}%; {n_mma} of {per} mma-core "
          f"launches captured): "
          f"{json.dumps({k: round(v, 4) for k, v in fam.items()})}; "
          f"kernel GEMMs' bound {bms:.4f} ms ({by}: {nbytes / 1e9:.4f} GB, "
          f"{ops / 1e9:.3f} GOP)  [{card}]", flush=True)
    print(f"time {label}: {gen_tokens / secs:.2f} tokens/s ({gen_tokens} "
          f"generated in {secs:.3f} s, prefill_encoder included; plain "
          f"versions {runs['plain_s']:.3f} s)  [{card}]", flush=True)
    print(f"time {label}: median decode step {step_ms:.4f} ms (CUDA "
          f"events, {LM_TIMED_STEPS} steps, M = {b}); prefill_encoder "
          f"{enc_ms:.4f} ms (M = {b * s_enc})  [{card}]", flush=True)
    print(f"time {label}: init {row['init_s']:.3f} s, bind + prequant "
          f"{row['bind_prequant_s']:.3f} s ({row['params'] / 1e9:.4f} B "
          f"params)  [{card}]", flush=True)
    print(f"memory {label}: peak {peak:.3f} GB allocated  [{card}]",
          flush=True)
    del plan, pplan, steps, enc, ck, cp


def lm_path_header(label, arch, cfg, layers):
    print(f"path {label}: {arch} at published width (d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, kv {cfg.n_kv_heads}, "
          f"head_dim {cfg.dh}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}"
          f"{', %d experts top-%d' % (cfg.n_experts, cfg.top_k) if cfg.is_moe else ''}"
          f"{', LRU %d, window %d, tied embeddings' % (cfg.lru_width, cfg.sliding_window) if cfg.block_pattern else ''}"
          f"), {cfg.n_layers} layers"
          f"{' (reduced depth: run time)' if layers else ''}"
          f"{', capacity factor %g (no drops)' % cfg.capacity_factor if layers and cfg.is_moe else ''}",
          flush=True)


def lm_phase(dev, card, detail, launches, seed):
    """Phase 14: the LM serving path (see the module docstring)."""
    import dataclasses

    from repro_torch.configs.registry import ARCHS

    register_plain_backend()
    t14 = time.perf_counter()
    print(card_line(), flush=True)      # the card under phase 14's numbers
    for label, arch, layers, n_req, max_new in LM_PATHS:
        cfg = ARCHS[arch]
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers,
                                      capacity_factor=float(cfg.n_experts))
        lm_path_header(label, arch, cfg, layers)
        lm_path(label, cfg, n_req, max_new, dev, card, seed, detail,
                launches)
        torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"),
                    os.environ.get("PYTHONPATH")) if p))
    detail["lm_cli"] = []
    for argv in LM_CLI_RUNS:
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", *argv]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
        secs = time.perf_counter() - t0
        lines = run.stdout.strip().splitlines()
        check(run.returncode == 0 and lines and
              re.search(r"tok/s", lines[-1]),
              f"cli {' '.join(argv)}: rc {run.returncode}\n{run.stdout}"
              f"\n{run.stderr[-3000:]}")
        detail["lm_cli"].append({"argv": list(argv), "seconds": secs,
                                 "last_line": lines[-1]})
        print(f"cli {' '.join(argv)}: rc 0 in {secs:.2f} s: {lines[-1]}  "
              f"[{card}]", flush=True)
    print(f"phase 14: {time.perf_counter() - t14:.1f} s", flush=True)


def lm_recurrent_phase(dev, card, detail, launches, seed):
    """Phase 15: the recurrent LM families and the encoder-decoder (see
    the module docstring)."""
    import dataclasses

    from repro_torch.configs.registry import ARCHS

    register_plain_backend()
    t15 = time.perf_counter()
    print(card_line(), flush=True)      # the card under phase 15's numbers
    for label, arch, layers, n_req, max_new, float_sites in \
            LM_RECURRENT_PATHS:
        cfg = ARCHS[arch]
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        lm_path_header(label, arch, cfg, layers)
        t0 = time.perf_counter()
        lm_path(label, cfg, n_req, max_new, dev, card, seed, detail,
                launches, float_sites=float_sites, forward_check=True)
        detail[label]["path_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lm_encdec_path(dev, card, seed, detail, launches)
    detail[LM_ENCDEC_PATH[0]]["path_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    print(f"phase 15: {time.perf_counter() - t15:.1f} s", flush=True)


#: phase 16's LM training.  ``train_tinyllama_full``: TinyLlama-1.1B at
#: its published configuration, (label, arch, batch, sequence).
LM_TRAIN_FULL = ("train_tinyllama_full", "tinyllama-1.1b", 8, 256)
#: OLMoE-1B-7B at published width and its published capacity factor
#: (1.25), 2 of its 16 layers (run time): (label, arch, layers, batch,
#: sequence)
LM_TRAIN_OLMOE = ("train_olmoe_width", "olmoe-1b-7b", 2, 4, 128)
#: every architecture at ``reduced()`` (d_model 64, d_ff 128, vocab
#: 256), one step each at B = 2, S = 32 (RWKV6's WKV chunk): (arch,
#: layers).  The hybrid keeps 3 layers, one (rec, rec, attn) period: at
#: 2 it has no attention block, and its MQA ``wk`` / ``wv`` (N = 16) are
#: the GEMMs whose #dx contraction is shorter than block 32 (fitted to
#: 16: the tile kernel)
LM_TRAIN_FAMILIES = (("tinyllama-1.1b", 2), ("mistral-nemo-12b", 2),
                     ("minicpm-2b", 2), ("qwen1.5-4b", 2),
                     ("qwen2-vl-2b", 2), ("mixtral-8x7b", 2),
                     ("olmoe-1b-7b", 2), ("rwkv6-3b", 2),
                     ("recurrentgemma-9b", 3), ("seamless-m4t-medium", 2))
#: the launcher's ``100m`` scale of TinyLlama through ``run_training``:
#: (label, steps, batch, sequence); the resume check runs 10 steps at
#: B = 4, S = 128
LM_TRAIN_LOOP = ("train_loop_100m", 30, 8, 256)
#: full-width steps timed one by one (CUDA events) for the median
LM_TRAIN_TIMED = 5
#: the recurrent families and the encoder-decoder at published width,
#: B * S = 1,024 tokens (S a multiple of RWKV6's WKV chunk, 32): (label,
#: arch, layers or None for the published depth, batch, sequence).  A
#: step holds the state, the gradients and the new state (~32.4 bytes a
#: parameter: RWKV6 at 8 layers peaked at 31.31 GB,
#: ``tools/probe_train_width.py``), so
#: the depths are what one 80 GB card holds: RWKV6 20 of its 32 layers
#: (2.0 B parameters; 32 ran out of memory at 77.4 GB), RecurrentGemma
#: one (rec, rec, attn) period, 3 of its 38 layers (1.7 B with its
#: 1.05 B tied embedding; 6 layers would take ~77 GB); seamless whole
LM_TRAIN_WIDTH = (("train_rwkv6_width", "rwkv6-3b", 20, 4, 256),
                  ("train_seamless_full", "seamless-m4t-medium", None, 4,
                   256),
                  ("train_griffin_width", "recurrentgemma-9b", 3, 4, 256))
#: their steps timed one by one (CUDA events) for the median
LM_TRAIN_WIDTH_TIMED = 3
#: the training CLI (``repro_torch.launch.train``) as subprocesses on the
#: card; "{tmp}" becomes a temporary checkpoint directory
LM_TRAIN_CLI_RUNS = (
    ("--arch", "tinyllama-1.1b", "--scale", "smoke", "--steps", "4",
     "--batch", "4", "--seq", "64", "--bfp", "--compress-grads"),
    ("--arch", "olmoe-1b-7b", "--scale", "smoke", "--steps", "4",
     "--batch", "4", "--seq", "64", "--ckpt-dir", "{tmp}"))


def lm_train_sites(cfg, batch: int, seq: int):
    """(K, N, M) of every linear site of one LM forward on the kernels,
    read from the model code (``models.lm``): an attention block's wq /
    wk / wv / wo and its SwiGLU w1 / w3 / w2 (the MoE experts run the
    emulated datapath, the router in float: neither is a site); an RWKV6
    layer's time mix (wr, wk, wv, wg, the decay LoRA's wA [d, 64] and wB
    [64, d], wo) and channel mix (wk, wv, wr); a Griffin recurrent block's
    in_x, in_g, wr, wi, out and SwiGLU; an encoder-decoder's encoder
    layers over the ``enc_seq_stub`` frames of its zero stub, and each
    decoder layer's cross-attention, whose wk / wv read the encoder
    output; and ``lm_head`` (a tied head multiplies the float
    ``embed.T``).  M is the rows the site multiplies: ``batch * seq``, or
    the encoder's ``batch * enc_seq_stub``."""
    from repro_torch.models.lm.model import _hybrid_layout

    d, f, dh = cfg.d_model, cfg.d_ff, cfg.dh
    q, kv = cfg.n_heads * dh, cfg.n_kv_heads * dh
    tokens = batch * seq

    def attn(m, m_kv=None):
        m_kv = m_kv or m
        return [(d, q, m), (d, kv, m_kv), (d, kv, m_kv), (q, d, m)]

    def ffn(m):
        return [(d, f, m), (d, f, m), (f, d, m)]

    if cfg.family == "ssm":
        layer = [(d, d, tokens)] * 4 + [(d, 64, tokens), (64, d, tokens),
                                        (d, d, tokens), (d, f, tokens),
                                        (f, d, tokens), (d, d, tokens)]
        sites = layer * cfg.n_layers
    elif cfg.block_pattern:
        lw = cfg.lru_width
        block = {"rec": [(d, lw, tokens), (d, lw, tokens), (lw, lw, tokens),
                         (lw, lw, tokens), (lw, d, tokens)] + ffn(tokens),
                 "attn": attn(tokens) + ffn(tokens)}
        n_periods, rem = _hybrid_layout(cfg)
        sites = [site for kind in cfg.block_pattern * n_periods + rem
                 for site in block[kind]]
    elif cfg.is_encdec:
        m_enc = batch * cfg.enc_seq_stub
        sites = (attn(m_enc) + ffn(m_enc)) * cfg.encoder_layers + (
            attn(tokens) + [(d, q, tokens), (d, kv, m_enc), (d, kv, m_enc),
                            (q, d, tokens)] + ffn(tokens)) * cfg.n_layers
    else:
        sites = (attn(tokens) + ([] if cfg.is_moe else ffn(tokens))) \
            * cfg.n_layers
    return sites + [(d, cfg.vocab_size, tokens)]


def lm_train_launches(cfg, straight_through: bool, batch: int, seq: int,
                      pol=None):
    """{counter: launches} of one ``make_train_step`` step at ``pol``
    (PALLAS_TILED by default, float weights), read from the code: each
    site of :func:`lm_train_sites` runs its forward GEMM and, without
    straight-through, its #dx (contracting N at ``fit_grad_policy``'s
    block) and #dw (contracting M at its block) on the kernels; with it
    the backward is float.  A GEMM runs the mma core after a patch format
    pass (a ``bfp_matmul`` and a ``bfp_matmul_pformat`` launch) where
    ``kernels.bfp_matmul.matmul_core`` says so, else the tile kernel (a
    ``bfp_matmul`` launch): N % 4 != 0 (seamless' head: 256,206) or a
    fitted block that is no power of two (its #dx at block 6)."""
    from repro_torch.core.policy import PALLAS_TILED
    from repro_torch.grad.paths import fit_grad_policy
    from repro_torch.kernels.bfp_matmul import matmul_core

    pol = pol or PALLAS_TILED
    out = {"bfp_matmul": 0, "bfp_matmul_pformat": 0}

    def gemm(k, n, bk):
        out["bfp_matmul"] += 1
        if matmul_core(False, bk, k, n, pol.l_i, pol.l_w) == "mma":
            out["bfp_matmul_pformat"] += 1

    for k, n, m in lm_train_sites(cfg, batch, seq):
        gemm(k, n, pol.block_k or k)
        if not straight_through:
            gemm(n, k, fit_grad_policy(pol, n).block_k)
            gemm(m, n, fit_grad_policy(pol, m).block_k)
    return {k: v for k, v in out.items() if v}


def same_step(a, ma, b, mb) -> bool:
    """Two ``make_train_step`` results (state and metrics) bit-equal."""
    return (same_tree(a, b) and sorted(ma) == sorted(mb)
            and all(same_bits(ma[k], mb[k].to(ma[k].device)) for k in ma))


def step_counts(step, state, batch):
    """(new state, metrics, launches, wall ms) of one step."""
    from repro_torch import kernels as K
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new, m = step(state, batch)
    torch.cuda.synchronize()
    return new, m, K.launch_counts(), (time.perf_counter() - t0) * 1e3


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def by_core(counts):
    """``bfp_matmul`` launches split by core: the mma core runs after a
    patch format pass, the tile kernel without one."""
    mma = counts.get("bfp_matmul_pformat", 0)
    return {"mma": mma, "tile": counts.get("bfp_matmul", 0) - mma}


def lm_train_full(dev, card, seed, detail, launches):
    """``train_tinyllama_full`` (see the module docstring, phase 16)."""
    import statistics

    from repro_torch import engine as EG
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core.policy import PALLAS_TILED
    from repro_torch.data.pipeline import LMBatchSpec, lm_batch
    from repro_torch.models.lm import model as LM
    from repro_torch.optim import optimizers as opt
    from repro_torch.train import step as TS

    label, arch, b, s = LM_TRAIN_FULL
    cfg = ARCHS[arch]
    row = detail[label] = {}
    sync = torch.cuda.synchronize
    pol = PALLAS_TILED.with_(straight_through=False)
    sched = opt.cosine_schedule(3e-4, 20, 100)
    want = lm_train_launches(cfg, False, b, s)
    lm_path_header(label, arch, cfg, None)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = TS.init_state(cfg, torch.Generator(device=dev).manual_seed(seed),
                          device=dev)
    sync()
    row["init_s"] = time.perf_counter() - t0
    row["params"] = LM.param_count(state.params)
    spec = LMBatchSpec(vocab_size=cfg.vocab_size, seq_len=s, global_batch=b,
                       seed=seed)
    step = TS.make_train_step(cfg, sched, policy=pol)
    pstep = TS.make_train_step(cfg, sched,
                               policy=pol.with_(backend="plain"))
    row["steps"] = []
    for i in range(2):
        batch = lm_batch(spec, i, device=dev)
        new, m, counts, wall = step_counts(step, state, batch)
        loss = float(m["loss"])
        check(np.isfinite(loss) and np.isfinite(float(m["grad_norm"])),
              f"{label}: step {i + 1} loss {loss}")
        check(nonzero(counts) == want, f"{label}: step {i + 1} launches "
              f"{nonzero(counts)} != {want}")
        plain, pm, pcounts, pwall = step_counts(pstep, state, batch)
        check(not any(pcounts.values()),
              f"{label}: the plain-version step launched a kernel")
        if not same_step(new, m, plain, pm):
            fail(f"{label}: step {i + 1} on the kernels != the "
                 f"plain-version step (params, mu, nu, step, metrics; max "
                 f"|diff| {tree_diff(new, plain)})")
        if i == 0:
            launches[label] = counts
        del plain, pm
        state = new
        row["steps"].append({"loss": loss, "grad_norm": float(
            m["grad_norm"]), "lr": float(m["lr"]), "ms": wall,
            "plain_ms": pwall})
        print(f"path {label} step {i + 1}: loss {loss:.6f} grad_norm "
              f"{float(m['grad_norm']):.6f} lr {float(m['lr']):.3e}, "
              f"{wall:.1f} ms (plain versions {pwall:.1f} ms); params, mu, "
              f"nu, step and metrics torch.equal to the plain-version step;"
              f" launches {nonzero(counts)} ({by_core(counts)})  [{card}]",
              flush=True)
    row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9

    # steady-state steps: the median of CUDA-event times
    ms = []
    for i in range(LM_TRAIN_TIMED):
        batch = lm_batch(spec, 2 + i, device=dev)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, batch)
        stop.record()
        sync()
        ms.append(start.elapsed_time(stop))
    step_ms = statistics.median(ms)
    check(np.isfinite(float(m["loss"])) and int(state.step) == 7,
          f"{label}: after 7 steps loss {float(m['loss'])}, step "
          f"{int(state.step)}")
    # the bound of the step's kernel GEMMs, from a tapped step's shapes
    cost = [0, 0]

    def tap(ev):
        c = gemm_cost(ev)
        cost[0], cost[1] = cost[0] + c[0], cost[1] + c[1]

    with EG.taps(tap):
        step(state, batch)
    bms, by, nbytes, ops = bound_of(*cost)
    # one step under the profiler, by kernel family
    per_mma = want["bfp_matmul_pformat"]
    n_mma, fam, pwall = profile_step(lambda: step(state, batch), per_mma)
    devt = sum(fam.values())
    tok_s = b * s / (step_ms / 1e3)
    row.update(step_ms_median=step_ms, step_ms_all=ms, tokens_per_s=tok_s,
               bound_ms=bms, bound_by=by, bound_bytes=nbytes, bound_ops=ops,
               profile={"wall_ms": pwall, "device_ms": devt,
                        "mma_events": n_mma, **fam})
    print(f"time {label}: median step {step_ms:.2f} ms (CUDA events, "
          f"{LM_TRAIN_TIMED} steps, B = {b}, S = {s}), {tok_s:.1f} "
          f"tokens/s; init {row['init_s']:.2f} s ({row['params'] / 1e9:.4f}"
          f" B params); peak memory {row['peak_gb']:.2f} GB allocated (the "
          f"kernel and plain-version steps)  [{card}]", flush=True)
    print(f"profile {label} step: wall {pwall:.2f} ms, device {devt:.2f} ms"
          f" (busy {100 * devt / pwall:.1f}% of the profiled wall, "
          f"{100 * devt / step_ms:.1f}% of the median step; {n_mma} of "
          f"{per_mma} mma-core launches captured): "
          f"{json.dumps({k: round(v, 3) for k, v in fam.items()})}; kernel "
          f"GEMMs' bound {bms:.3f} ms ({by}: {nbytes / 1e9:.3f} GB, "
          f"{ops / 1e12:.3f} TOP)  [{card}]", flush=True)
    del state, m, step, pstep


def lm_train_olmoe(dev, card, seed, detail, launches):
    """``train_olmoe_width`` (see the module docstring, phase 16)."""
    import dataclasses

    from repro_torch.configs.registry import ARCHS
    from repro_torch.core.policy import PALLAS_TILED
    from repro_torch.data.pipeline import LMBatchSpec, lm_batch
    from repro_torch.train import step as TS

    label, arch, layers, b, s = LM_TRAIN_OLMOE
    cfg = dataclasses.replace(ARCHS[arch], n_layers=layers)
    row = detail[label] = {}
    pol = PALLAS_TILED           # straight-through: the experts' STE (F9)
    want = lm_train_launches(cfg, True, b, s)
    print(f"path {label}: {arch} at published width (d_model {cfg.d_model},"
          f" {cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.n_experts} experts top-{cfg.top_k}, capacity factor "
          f"{cfg.capacity_factor:g}), {layers} of its 16 layers (run time)",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    state = TS.init_state(cfg, torch.Generator(device=dev).manual_seed(seed),
                          device=dev)
    batch = lm_batch(LMBatchSpec(vocab_size=cfg.vocab_size, seq_len=s,
                                 global_batch=b, seed=seed), 0, device=dev)
    step = TS.make_train_step(cfg, policy=pol)
    new, m, counts, wall = step_counts(step, state, batch)
    check(nonzero(counts) == want,
          f"{label}: launches {nonzero(counts)} != {want}")
    plain, pm, pcounts, pwall = step_counts(
        TS.make_train_step(cfg, policy=pol.with_(backend="plain")), state,
        batch)
    check(not any(pcounts.values()),
          f"{label}: the plain-version step launched a kernel")
    if not same_step(new, m, plain, pm):
        fail(f"{label}: the step on the kernels != the plain-version step "
             f"(max |diff| {tree_diff(new, plain)})")
    mu = new.opt_state.mu["layers"]["moe"]
    gsum = {k: float(mu[k].abs().sum()) for k in ("w1", "w2", "w3")}
    check(all(v > 0 for v in gsum.values()) and np.isfinite(
        float(m["loss"])), f"{label}: expert gradients {gsum}, loss "
        f"{float(m['loss'])}")
    launches[label] = counts
    del plain, pm
    step_ms = cuda_ms(lambda: step(state, batch), reps=3)
    row.update(loss=float(m["loss"]), aux=float(m["aux"]), ms=wall,
               plain_ms=pwall, step_ms=step_ms, expert_mu_abs_sum=gsum,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"path {label}: loss {float(m['loss']):.6f} aux "
          f"{float(m['aux']):.6f}; the step torch.equal to the plain "
          f"versions; expert gradients non-zero (sum |mu| "
          f"{ {k: round(v, 4) for k, v in gsum.items()} }); launches "
          f"{nonzero(counts)}  [{card}]", flush=True)
    print(f"time {label}: step {step_ms:.2f} ms (CUDA events, mean of 3, "
          f"B = {b}, S = {s}); peak memory {row['peak_gb']:.2f} GB "
          f"allocated  [{card}]", flush=True)
    del state, new, m, step


def to_host(tree):
    """``tree``'s tensors copied to the host, leaf by leaf."""
    from repro_torch import _tree
    return _tree.tree_map(lambda t: t.cpu(), tree)


def same_as_host(host, tree) -> bool:
    """:func:`same_tree` of a host copy and a device tree, one leaf on
    the device at a time."""
    la, lb = tree_leaves(host), tree_leaves(tree)
    return len(la) == len(lb) and all(
        same_bits(u.to(v.device), v) for u, v in zip(la, lb))


def lm_train_width(dev, card, seed, detail, launches):
    """``train_rwkv6_width``, ``train_seamless_full`` and
    ``train_griffin_width`` (see the module docstring, phase 16)."""
    import dataclasses
    import statistics

    from repro_torch import engine as EG
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core.policy import PALLAS_TILED
    from repro_torch.data.pipeline import LMBatchSpec, lm_batch
    from repro_torch.models.lm import model as LM
    from repro_torch.optim import optimizers as opt
    from repro_torch.train import step as TS

    pol = PALLAS_TILED.with_(straight_through=False)
    sched = opt.cosine_schedule(3e-4, 20, 100)
    sync = torch.cuda.synchronize
    for label, arch, layers, b, s in LM_TRAIN_WIDTH:
        cfg = ARCHS[arch] if layers is None else dataclasses.replace(
            ARCHS[arch], n_layers=layers)
        row = detail[label] = {"layers": cfg.n_layers,
                               "published_layers": ARCHS[arch].n_layers}
        want = lm_train_launches(cfg, False, b, s)
        depth = ("its published depth" if layers is None else
                 f"{layers} of its {ARCHS[arch].n_layers} layers (what one "
                 f"card holds with AdamW)")
        print(f"path {label}: {arch} at published width (d_model "
              f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}"
              f"{', encoder ' + str(cfg.encoder_layers) + ' layers' if cfg.is_encdec else ''}),"
              f" {cfg.n_layers} layers: {depth}; B = {b}, S = {s}, "
              f"PALLAS_TILED without straight-through", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state = TS.init_state(cfg, torch.Generator(device=dev).manual_seed(
            seed), device=dev)
        sync()
        row["init_s"] = time.perf_counter() - t0
        row["params"] = LM.param_count(state.params)
        spec = LMBatchSpec(vocab_size=cfg.vocab_size, seq_len=s,
                           global_batch=b, seed=seed)
        step = TS.make_train_step(cfg, sched, policy=pol)
        pstep = TS.make_train_step(cfg, sched,
                                   policy=pol.with_(backend="plain"))
        batch = lm_batch(spec, 0, device=dev)
        new, m, counts, wall = step_counts(step, state, batch)
        loss = float(m["loss"])
        check(np.isfinite(loss) and np.isfinite(float(m["grad_norm"])),
              f"{label}: loss {loss}")
        check(nonzero(counts) == want,
              f"{label}: launches {nonzero(counts)} != {want}")
        launches[label] = counts
        # the kernels' new state waits on the host while the plain-version
        # step runs: the card holds one step at a time
        t0 = time.perf_counter()
        host, hm = to_host(new), to_host(m)
        del new, m
        off_s = time.perf_counter() - t0
        plain, pm, pcounts, pwall = step_counts(pstep, state, batch)
        check(not any(pcounts.values()),
              f"{label}: the plain-version step launched a kernel")
        if not (same_as_host(host, plain) and sorted(hm) == sorted(pm)
                and all(same_bits(hm[k], pm[k].cpu()) for k in hm)):
            fail(f"{label}: the step on the kernels != the plain-version "
                 f"step (params, mu, nu, step, metrics)")
        del plain, pm, host, hm
        row.update(loss=loss, ms=wall, plain_ms=pwall, offload_s=off_s,
                   launches=nonzero(counts), by_core=by_core(counts))
        print(f"path {label} step 1: loss {loss:.6f}, {wall:.1f} ms "
              f"(plain versions {pwall:.1f} ms); params, mu, nu, step and "
              f"metrics torch.equal to the plain-version step; launches "
              f"{nonzero(counts)} as lm_train_launches predicts; "
              f"bfp_matmul by core {by_core(counts)}  [{card}]", flush=True)
        ms = []
        for i in range(LM_TRAIN_WIDTH_TIMED):
            batch = lm_batch(spec, 1 + i, device=dev)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step(state, batch)
            stop.record()
            sync()
            ms.append(start.elapsed_time(stop))
        step_ms = statistics.median(ms)
        check(np.isfinite(float(m["loss"]))
              and int(state.step) == LM_TRAIN_WIDTH_TIMED,
              f"{label}: after {LM_TRAIN_WIDTH_TIMED} steps loss "
              f"{float(m['loss'])}, step {int(state.step)}")
        cost = [0, 0]                   # the tapped step's kernel GEMMs

        def tap(ev):
            c = gemm_cost(ev)
            cost[0], cost[1] = cost[0] + c[0], cost[1] + c[1]

        with EG.taps(tap):
            step(state, batch)
        bms, by, nbytes, ops = bound_of(*cost)
        per_mma = want.get("bfp_matmul_pformat", 0)
        n_mma, fam, pwall = profile_step(lambda: step(state, batch),
                                         per_mma)
        devt = sum(fam.values())
        row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        tok_s = b * s / (step_ms / 1e3)
        row.update(step_ms_median=step_ms, step_ms_all=ms,
                   tokens_per_s=tok_s, bound_ms=bms, bound_by=by,
                   bound_bytes=nbytes, bound_ops=ops,
                   profile={"wall_ms": pwall, "device_ms": devt,
                            "mma_events": n_mma, **fam})
        print(f"time {label}: median step {step_ms:.2f} ms (CUDA events, "
              f"{LM_TRAIN_WIDTH_TIMED} steps, B = {b}, S = {s}), {tok_s:.1f}"
              f" tokens/s; init {row['init_s']:.2f} s ("
              f"{row['params'] / 1e9:.4f} B params); new state to the host "
              f"{off_s:.1f} s; peak memory {row['peak_gb']:.2f} GB "
              f"allocated  [{card}]", flush=True)
        print(f"profile {label} step: wall {pwall:.2f} ms, device "
              f"{devt:.2f} ms (busy {100 * devt / pwall:.1f}% of the "
              f"profiled wall; {n_mma} of {per_mma} mma-core launches "
              f"captured): {json.dumps({k: round(v, 3) for k, v in fam.items()})};"
              f" kernel GEMMs' bound {bms:.3f} ms ({by}: {nbytes / 1e9:.3f} "
              f"GB, {ops / 1e12:.3f} TOP)  [{card}]", flush=True)
        del state, m, step, pstep, batch


def lm_train_families(dev, card, seed, detail, launches):
    """``train_families_smoke`` (see the module docstring, phase 16)."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core.policy import PALLAS_TILED
    from repro_torch.data.pipeline import LMBatchSpec, lm_batch
    from repro_torch.train import step as TS

    label = "train_families_smoke"
    rows = detail[label] = {}
    pol = PALLAS_TILED.with_(block_k=32, straight_through=False)
    for arch, layers in LM_TRAIN_FAMILIES:
        cfg = reduced(ARCHS[arch], n_layers=layers)
        cpu_state = TS.init_state(cfg, torch.Generator().manual_seed(seed),
                                  device="cpu")
        state = TS.TrainState(*(tree_leaves_to(t, dev) for t in cpu_state))
        cpu_batch = lm_batch(LMBatchSpec(vocab_size=cfg.vocab_size,
                                         seq_len=32, global_batch=2,
                                         seed=seed), 0, device="cpu")
        batch = tuple(t.to(dev) for t in cpu_batch)
        new, m, counts, _ = step_counts(TS.make_train_step(cfg, policy=pol),
                                        state, batch)
        plain, pm, pcounts, _ = step_counts(
            TS.make_train_step(cfg, policy=pol.with_(backend="plain")),
            state, batch)
        others = {k: v for k, v in nonzero(counts).items()
                  if k not in ("bfp_matmul", "bfp_matmul_pformat")}
        check(counts["bfp_matmul"] > 0 and not others,
              f"{label} {arch}: launches {nonzero(counts)}")
        check(not any(pcounts.values()),
              f"{label} {arch}: the plain-version step launched a kernel")
        if not same_step(new, m, plain, pm):
            fail(f"{label} {arch}: the step on the kernels != the plain "
                 f"versions (max |diff| {tree_diff(new, plain)})")
        check(np.isfinite(float(m["loss"])),
              f"{label} {arch}: loss {float(m['loss'])}")
        launches[f"{label}/{arch}"] = counts
        rows[arch] = {"loss": float(m["loss"]), "launches": nonzero(counts),
                      "by_core": by_core(counts)}
        note = ""
        if arch == "tinyllama-1.1b":
            note = "; " + card_vs_cpu(cfg, pol, cpu_state, cpu_batch, new, m,
                                      rows[arch])
        print(f"path {label} {arch}: loss {float(m['loss']):.6f}, the step "
              f"torch.equal to the plain versions; bfp_matmul by core "
              f"{by_core(counts)}{note}  [{card}]", flush=True)
        launches[label] = {k: launches.get(label, {}).get(k, 0) + v
                           for k, v in counts.items()}
        del state, new, plain


def tree_leaves_to(tree, dev):
    """``tree`` with every tensor leaf moved to ``dev``."""
    from repro_torch import _tree
    return _tree.tree_map(lambda t: t.to(dev), tree)


def card_vs_cpu(cfg, pol, cpu_state, cpu_batch, new, m, row) -> str:
    """Step 1 on the card against the same step on the CPU, by the CPU
    parity rules of ``tests/test_torch_lm_train.py``: metrics within 1e-5
    relative (1e-7 absolute); AdamW's moments and the params with all
    but 1% of each leaf's elements within 1e-5 relative + 1e-5 of the
    leaf's largest, and the params within 2.5 lr."""
    from repro_torch.train import step as TS

    cpu_new, cm = TS.make_train_step(cfg, policy=pol)(cpu_state, cpu_batch)
    lr = float(cm["lr"])
    dl = {k: abs(float(m[k]) - float(cm[k])) / max(abs(float(cm[k])),
                                                   1e-30) for k in cm}
    worst = {"mu": 0.0, "nu": 0.0, "params": 0.0, "params_max": 0.0}
    ok = all(abs(float(m[k]) - float(cm[k])) <= 1e-5 * abs(float(cm[k]))
             + 1e-7 for k in cm)
    for what, a_tree, b_tree in (("mu", new.opt_state.mu,
                                  cpu_new.opt_state.mu),
                                 ("nu", new.opt_state.nu,
                                  cpu_new.opt_state.nu),
                                 ("params", new.params, cpu_new.params)):
        for u, v in zip(tree_leaves(a_tree, "cpu"), tree_leaves(b_tree)):
            if not v.numel():
                continue
            d = (u.double() - v.double()).abs()
            top = float(v.abs().max())
            far = float((d > 1e-5 * v.abs() + 1e-5 * top).double().mean())
            worst[what] = max(worst[what], far)
            ok &= far <= 0.01
            if what == "params":
                worst["params_max"] = max(worst["params_max"],
                                          float(d.max()))
                ok &= float(d.max()) <= 2.5 * lr
    check(ok, f"card vs CPU: metrics {dl}, worst {worst}, lr {lr}")
    row["card_vs_cpu"] = {"metrics_rel": dl, **worst}
    return (f"step 1 vs the CPU's: metrics within "
            f"{max(dl.values()):.2e} relative, share off by > 1e-5 "
            f"{max(worst['mu'], worst['nu']):.4f} (moments) and "
            f"{worst['params']:.4f} (params), params max |diff| "
            f"{worst['params_max']:.2e} (2.5 lr {2.5 * lr:.2e})")


def lm_train_loop(dev, card, seed, detail, launches):
    """``train_loop_100m`` (see the module docstring, phase 16)."""
    from repro_torch import kernels as K
    from repro_torch.checkpoint import store
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core.policy import PALLAS_TILED
    from repro_torch.data.pipeline import LMBatchSpec
    from repro_torch.optim import optimizers as opt
    from repro_torch.train import loop as TL
    from repro_torch.train import step as TS

    label, steps, b, s = LM_TRAIN_LOOP
    cfg = reduced(ARCHS["tinyllama-1.1b"], n_layers=8, d_model=512,
                  d_ff=2048, vocab=8192)
    row = detail[label] = {}
    pol = PALLAS_TILED.with_(straight_through=False)
    want = lm_train_launches(cfg, False, b, s)
    state = TS.init_state(cfg, torch.Generator(device=dev).manual_seed(seed),
                          device=dev)
    step = TS.make_train_step(cfg, opt.cosine_schedule(3e-3, 5, steps),
                              policy=pol)
    per_step = []

    def counted(st, batch):
        K.reset_launch_counts()
        out = step(st, batch)
        per_step.append(K.launch_counts())
        return out

    t0 = time.perf_counter()
    out = TL.run_training(state, counted, LMBatchSpec(
        vocab_size=cfg.vocab_size, seq_len=s, global_batch=b, seed=seed),
        TL.LoopConfig(total_steps=steps))
    secs = time.perf_counter() - t0
    losses = [h["loss"] for h in out["history"]]
    check(len(per_step) == steps
          and all(nonzero(c) == want for c in per_step),
          f"{label}: launches per step {[nonzero(c) for c in per_step]} "
          f"!= {want}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{label}: the loss did not fall: {losses}")
    launches[label] = per_step[0]
    # a run broken at step 6 (checkpoints every 4) and resumed equals an
    # uninterrupted run of the same length, bit for bit
    rspec = LMBatchSpec(vocab_size=cfg.vocab_size, seq_len=128,
                        global_batch=4, seed=seed)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_lm_loop_")
    try:
        t1 = time.perf_counter()
        try:
            TL.run_training(state, step, rspec, TL.LoopConfig(
                total_steps=10, ckpt_dir=tmp, ckpt_every=4, fail_at_step=6))
            fail(f"{label}: the injected failure did not fire")
        except TL._SimulatedFailure:
            pass
        # the step-4 save the crash left in flight lands in the background
        deadline = time.monotonic() + 60
        while (store.latest_step(tmp) != 4
               and time.monotonic() < deadline):
            time.sleep(0.01)
        check(store.latest_step(tmp) == 4,
              f"{label}: latest checkpoint after the crash is "
              f"{store.latest_step(tmp)}, not 4")
        resumed = TL.run_training(state, step, rspec, TL.LoopConfig(
            total_steps=10, ckpt_dir=tmp, ckpt_every=4))
        whole = TL.run_training(state, step, rspec,
                                TL.LoopConfig(total_steps=10))
        resume_s = time.perf_counter() - t1
        if not (len(resumed["history"]) == 6
                and same_tree(resumed["state"], whole["state"])):
            fail(f"{label}: the resumed run differs from the uninterrupted "
                 f"one (max |diff| "
                 f"{tree_diff(resumed['state'], whole['state'])}, "
                 f"{len(resumed['history'])} steps after the resume)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    row.update(losses=losses, seconds=secs,
               median_step_s=out["median_step_s"],
               stragglers=out["stragglers_flagged"], resume_s=resume_s,
               launches=want)
    print(f"path {label}: {steps} steps of TinyLlama's 100m scale (8 layers,"
          f" d_model 512, d_ff 2048, vocab 8192; B = {b}, S = {s}) in "
          f"{secs:.2f} s, loss {losses[0]:.4f} -> {losses[-1]:.4f}, median "
          f"step {out['median_step_s'] * 1e3:.2f} ms, stragglers "
          f"{out['stragglers_flagged']}; launches {want} every step; a run "
          f"failed at step 6 and resumed from step 4 torch.equal to an "
          f"uninterrupted one ({resume_s:.2f} s)  [{card}]", flush=True)


def lm_train_phase(dev, card, detail, launches, seed):
    """Phase 16: LM training (see the module docstring)."""
    register_plain_backend()
    t16 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(card_line(), flush=True)      # the card under phase 16's numbers
    print(f"phase 16: {torch.cuda.memory_allocated() / 1e9:.2f} GB held by "
          f"earlier phases", flush=True)
    for path in (lm_train_full, lm_train_olmoe, lm_train_width,
                 lm_train_families, lm_train_loop):
        t0 = time.perf_counter()
        path(dev, card, seed, detail, launches)
        gc.collect()            # the path's tensors in reference cycles
        torch.cuda.empty_cache()
        print(f"phase 16 {path.__name__}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"),
                    os.environ.get("PYTHONPATH")) if p))
    detail["lm_train_cli"] = []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_cli_")
    try:
        for argv in LM_TRAIN_CLI_RUNS:
            argv = [a.replace("{tmp}", tmp) for a in argv]
            cmd = [sys.executable, "-m", "repro_torch.launch.train", *argv]
            t0 = time.perf_counter()
            run = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                                 text=True, timeout=600)
            secs = time.perf_counter() - t0
            lines = run.stdout.strip().splitlines()
            check(run.returncode == 0 and lines
                  and lines[-1].startswith("done: loss"),
                  f"cli {' '.join(argv)}: rc {run.returncode}\n{run.stdout}"
                  f"\n{run.stderr[-3000:]}")
            detail["lm_train_cli"].append({"argv": argv, "seconds": secs,
                                           "last_line": lines[-1]})
            print(f"cli {' '.join(argv)}: rc 0 in {secs:.2f} s: "
                  f"{lines[-1]}  [{card}]", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 16: {time.perf_counter() - t16:.1f} s", flush=True)


#: phase 17's serve CLI runs: full-width VGG16 on the paper's policy,
#: once on a 1x1 (data, model) mesh and once without (subprocesses)
DIST_CLI = ("--model", "vgg16", "--scale", "full", "--bfp", "--prequant",
            "--strict-backend")
#: alternating pairs of the unbound / bound batch-8 ResNet-50 forward
DIST_AB_PAIRS = 10


def dist_resnet50(dev, card, detail, launches, mesh, r50, r50_served):
    """``sharded_resnet50_full``: phase 8's ResNet-50 plan served on the
    1x1 mesh, then the forward timed with and without the binding."""
    import statistics

    from repro_torch.dist import sharding as DS
    from repro_torch.serve.cnn import CnnServeEngine

    label = "sharded_resnet50_full"
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always", DS.ShardingRuleDropped)
        eng, served, counts = serve_check(
            label, r50["plan"], r50["apply"], r50["images"],
            MODEL_LAUNCHES["resnet50_full"], dev, 1000, r50["pplan"],
            mesh=mesh, rules=DS.DEFAULT_RULES, device=dev)
    launches[label] = counts
    drops = [str(w.message) for w in rec
             if issubclass(w.category, DS.ShardingRuleDropped)]
    check(eng.mesh is mesh and not drops,
          f"{label}: engine mesh {eng.mesh}, rules dropped {drops}")
    check(torch.equal(served, r50_served),
          f"{label}: logits differ from the unsharded engine's (max |diff| "
          f"{diff(served, r50_served)})")
    check(counts == launches["resnet50_full"],
          f"{label}: launches {counts} != the unsharded run's "
          f"{launches['resnet50_full']}")
    print(f"path {label}: 16 requests on a 1x1 (data, model) mesh with "
          f"DEFAULT_RULES: logits torch.equal to the unsharded engine's "
          f"and to the plain versions', launches equal to the unsharded "
          f"run's, no rule dropped", flush=True)

    free = CnnServeEngine(None, r50["apply"], r50["plan"], slots=8,
                          device=dev)
    xb = r50["images"][:8].to(dev)

    def forward_ms(e):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        e._logits(e._fwd, xb)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    def host_us(e, n=2000):           # the engine's own host work
        t0 = time.perf_counter()
        for _ in range(n):
            e._logits(lambda x: x, xb)
        return (time.perf_counter() - t0) / n * 1e6

    forward_ms(free), forward_ms(eng)
    times = {"unbound": [], "bound": []}
    for i in range(DIST_AB_PAIRS):
        for tag, e in ((("unbound", free), ("bound", eng)) if i % 2 == 0
                       else (("bound", eng), ("unbound", free))):
            times[tag].append(forward_ms(e))
    med = {k: statistics.median(v) for k, v in times.items()}
    host = {"unbound": host_us(free), "bound": host_us(eng)}
    detail[label] = {"forward_ms": med, "forward_ms_all": times,
                     "host_us": host}
    span = {k: (min(v), max(v)) for k, v in times.items()}
    print(f"time {label}: batch-8 forward median unbound {med['unbound']:.4f}"
          f" ms ({span['unbound'][0]:.4f}-{span['unbound'][1]:.4f}), bound "
          f"{med['bound']:.4f} ms ({span['bound'][0]:.4f}-"
          f"{span['bound'][1]:.4f}) ({DIST_AB_PAIRS} alternating "
          f"pairs, CUDA events); the engine's host work per forward "
          f"{host['unbound']:.2f} us unbound, {host['bound']:.2f} us bound "
          f"(+{host['bound'] - host['unbound']:.2f} us)  [{card}]",
          flush=True)


def dist_cli(card, detail):
    """``serve_cnn_mesh_vgg16_full``: the serve CLI with ``--mesh 1x1``
    and without, as two subprocesses side by side on the card: both exit
    0, the same logits."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"),
                    os.environ.get("PYTHONPATH")) if p))
    label = "serve_cnn_mesh_vgg16_full"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_cli_")
    logits, row, procs = {}, {}, {}
    detail[label] = row
    t0 = time.perf_counter()
    try:
        for tag, extra in (("mesh", ("--mesh", "1x1")), ("no_mesh", ())):
            out = os.path.join(tmp, f"{tag}.npy")
            argv = [*DIST_CLI, *extra, "--logits-out", out]
            procs[tag] = (argv, out, subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.serve_cnn",
                 *argv], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        for tag, (argv, out, proc) in procs.items():
            try:
                stdout, stderr = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                stdout, stderr = proc.communicate()
            secs = time.perf_counter() - t0
            lines = stdout.strip().splitlines()
            check(proc.returncode == 0 and lines and
                  re.search(r"req/s", lines[-1]) and os.path.exists(out),
                  f"cli {' '.join(argv)}: rc {proc.returncode}\n{stdout}"
                  f"\n{stderr[-3000:]}")
            logits[tag] = np.load(out)
            row[tag] = {"seconds": secs, "last_line": lines[-1]}
            print(f"cli {' '.join(argv[:-2])}: rc 0 after {secs:.2f} s: "
                  f"{lines[-1]}  [{card}]", flush=True)
    finally:
        for _, _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    check("mesh=1x1" in row["mesh"]["last_line"]
          and logits["mesh"].shape == (16, 1000)
          and np.isfinite(logits["mesh"]).all()
          and np.array_equal(logits["mesh"], logits["no_mesh"]),
          f"{label}: --mesh 1x1 logits differ from the run without a mesh")
    print(f"path {label}: 16 logits of --mesh 1x1 equal to the run "
          f"without a mesh (both runs side by side)", flush=True)


def dist_restore(dev, card, detail, mesh, pol, vgg_params):
    """``restore_sharded_vgg16``: phase 4's VGG16 saved float32 and
    ``bfp_packed``, restored with ``sharding_fn`` onto the card and onto
    the mesh: every leaf equal to the plain restore; the ``"dequant"``
    weights placed, the ``"prequant"`` sidecars not."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch import _tree
    from repro_torch.checkpoint import store

    label = "restore_sharded_vgg16"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_ckpt_")
    on_card = lambda i: dev                                 # noqa: E731
    on_mesh = lambda i: (mesh, [Replicate(), Replicate()])  # noqa: E731
    t0 = time.perf_counter()
    n_placed = {}
    try:
        store.save(os.path.join(tmp, "f32"), 0, vgg_params)
        store.save(os.path.join(tmp, "packed"), 0, vgg_params,
                   format="bfp_packed", policy=pol)
        for fmt, mode, fns in (("f32", "prequant", (on_card, on_mesh)),
                               ("packed", "dequant", (on_card, on_mesh)),
                               ("packed", "prequant", (on_mesh,))):
            base = os.path.join(tmp, fmt)
            want = _tree.leaves_with_path(
                store.restore(base, vgg_params, packed=mode)[0])
            for fn in fns:
                got = _tree.leaves_with_path(store.restore(
                    base, vgg_params, packed=mode, sharding_fn=fn)[0])
                tag = f"{fmt}/{mode}/{'mesh' if fn is on_mesh else 'card'}"
                check(len(got) == len(want)
                      and all(p == q for (p, _), (q, _) in zip(got, want)),
                      f"{label} {tag}: tree differs")
                side = [bool(p) and p[-1] in ("m", "s") for p, _ in got]
                placed = [isinstance(v, DTensor) for _, v in got]
                vals = [v.full_tensor() if d else v
                        for (_, v), d in zip(got, placed)]
                check(all(torch.equal(v, w) and v.device == w.device
                          for v, (_, w) in zip(vals, want)),
                      f"{label} {tag}: a leaf differs from the plain restore")
                want_placed = ([not s for s in side] if fn is on_mesh
                               else [False] * len(got))
                check(placed == want_placed,
                      f"{label} {tag}: placed leaves {sum(placed)} of "
                      f"{len(placed)}, sidecars {sum(side)}")
                n_placed[tag] = (sum(placed), len(placed))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t0
    detail[label] = {"seconds": secs, "placed": n_placed}
    print(f"path {label}: every leaf equal to the plain restore; DTensor "
          f"leaves (placed / all) {n_placed}: the dequant weights placed, "
          f"the prequant sidecars not ({secs:.2f} s with the saves)  "
          f"[{card}]", flush=True)


def dist_lm(dev, card, seed, detail, launches, mesh):
    """``lm_tinyllama_bound``: one full-width TinyLlama decode step and
    one forward under ``axis_rules(DEFAULT_RULES, 1x1 mesh)``, against the
    same calls unbound."""
    from repro_torch import engine as EG
    from repro_torch import kernels as K
    from repro_torch.configs.registry import ARCHS
    from repro_torch.core.policy import PALLAS_TILED
    from repro_torch.dist import sharding as DS
    from repro_torch.models.lm import model as LM

    label = "lm_tinyllama_bound"
    cfg = ARCHS["tinyllama-1.1b"]
    pol = PALLAS_TILED.with_(straight_through=False)
    params = LM.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed), device=dev)
    plan = EG.bind(params, pol, tree="lm", strict=True, device=dev)
    del params
    g = torch.Generator().manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab_size, (4, 1), generator=g).to(dev)
    ftoks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g).to(dev)
    per_call = lm_launches_per_call(cfg)
    per_fwd = lm_launches_per_call(cfg, forward=True)

    def run():
        cache = LM.init_cache(cfg, 4, 256, device=dev)
        with torch.inference_mode():
            torch.cuda.synchronize()
            K.reset_launch_counts()
            lg, cache = LM.decode_step(plan.params, cfg, cache, toks, 0,
                                       plan)
            c_step = nonzero(K.launch_counts())
            K.reset_launch_counts()
            flg, _ = LM.forward(plan.params, cfg, ftoks, policy=plan)
            c_fwd = nonzero(K.launch_counts())
        return (lg, cache, flg), c_step, c_fwd

    free, s_free, f_free = run()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always", DS.ShardingRuleDropped)
        with DS.axis_rules(DS.DEFAULT_RULES, mesh):
            bound, s_bound, f_bound = run()
    drops = [str(w.message) for w in rec
             if issubclass(w.category, DS.ShardingRuleDropped)]
    launches[label] = {k: s_bound.get(k, 0) + f_bound.get(k, 0)
                       for k in K.launch_counts()}
    check(s_free == s_bound == per_call and f_free == f_bound == per_fwd,
          f"{label}: launches step {s_free} / {s_bound}, forward {f_free} / "
          f"{f_bound}; want {per_call} and {per_fwd}")
    check(not drops, f"{label}: rules dropped {drops}")
    check(bool(torch.isfinite(free[0]).all())
          and bool(torch.isfinite(free[2]).all()),
          f"{label}: logits not finite")
    check(same_tree(free, bound, nan_aware=False),
          f"{label}: bound decode step / forward differ from unbound "
          f"(max |diff| {tree_diff(free, bound)})")
    detail[label] = {"step_launches": s_bound, "forward_launches": f_bound}
    print(f"path {label}: decode step (B = 4) and forward (B = 2, S = 64) "
          f"under axis_rules(DEFAULT_RULES, 1x1 mesh) torch.equal to "
          f"unbound (logits and cache), launches {s_bound} a step and "
          f"{f_bound} a forward both ways, no rule dropped  [{card}]",
          flush=True)


def dist_phase(dev, card, detail, launches, seed, pol, r50, r50_served,
               vgg_params):
    """Phase 17: logical-axis sharding on a 1x1 mesh of the card (see the
    module docstring)."""
    import torch.distributed as dist

    from repro_torch.dist import sharding as DS
    from repro_torch.launch.mesh import make_mesh

    t17 = time.perf_counter()
    print(card_line(), flush=True)      # the card under phase 17's numbers
    mesh = make_mesh((1, 1), ("data", "model"))
    try:
        check(mesh.device_type == "cuda" and dist.get_world_size() == 1
              and DS.mesh_axis_sizes(mesh) == {"data": 1, "model": 1},
              f"phase 17: mesh {mesh}, world {dist.get_world_size()}")
        for name, call in (
                ("dist_resnet50", lambda: dist_resnet50(
                    dev, card, detail, launches, mesh, r50, r50_served)),
                ("dist_cli", lambda: dist_cli(card, detail)),
                ("dist_restore", lambda: dist_restore(
                    dev, card, detail, mesh, pol, vgg_params)),
                ("dist_lm", lambda: dist_lm(dev, card, seed, detail,
                                            launches, mesh))):
            t0 = time.perf_counter()
            call()
            gc.collect()
            torch.cuda.empty_cache()
            print(f"phase 17 {name}: {time.perf_counter() - t0:.1f} s",
                  flush=True)
    finally:
        dist.destroy_process_group()
    print(f"phase 17: {time.perf_counter() - t17:.1f} s", flush=True)


#: phase 18(a)'s cells: full-width TinyLlama-1.1B on a 1x1 mesh of the
#: card, sized for one card: (label, shape, BFP-8 weights).
DRYRUN_CELLS = (
    ("train", ("train_b8_s256", 256, 8, "train"), False),
    ("prefill", ("prefill_b4_s4096", 4096, 4, "prefill"), False),
    ("decode", ("decode_b8_t4096", 4096, 8, "decode"), False),
    ("decode_bfp8w", ("decode_b8_t4096", 4096, 8, "decode"), True))
#: phase 18(b): hillclimb cell C on the fake 16x16 mesh, two variants.
DRYRUN_C_VARIANTS = ("baseline", "no_fsdp+bfp8w")


def dryrun_cell(dev, card, detail, label, cfg, shape, bfp, mesh, seed):
    """One phase 18(a) cell: the fake trace's per-device counts, the real
    run's FLOPs (equal), its median time and its share of the H100
    roofline."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import hillclimb as HC
    from repro_torch.launch.input_specs import build_cell, materialize
    from repro_torch.roofline import analysis as RA

    cell = build_cell(cfg, shape, mesh,
                      bfp_weights=HC._BFP8 if bfp else None)
    t0 = time.perf_counter()
    trace = DR.trace_cell(cell, mesh)
    trace_s = time.perf_counter() - t0
    args = materialize(cell, cfg.vocab_size,
                       torch.Generator(device=dev).manual_seed(seed), dev)
    with FlopCounterMode(display=False) as fc:
        cell.fn(*args)
    real = fc.get_total_flops()
    check(real == trace.flops, f"dryrun {label}: the real run counts "
          f"{real} FLOPs, the fake trace {trace.flops}")
    torch.cuda.synchronize()
    runs = []
    for i in range(6):                  # one warm-up, then 5 timed
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        cell.fn(*args)
        stop.record()
        torch.cuda.synchronize()
        if i:
            runs.append(start.elapsed_time(stop))
    ms = float(np.median(runs))
    # one more call under the profiler: its device time against its wall
    _, fam, wall = profile_step(lambda: cell.fn(*args), 0)
    devt = sum(fam.values())
    terms = RA.roofline_terms(trace.cost(), {}, RA.HW(chips=1),
                              n_links=RA.N_LINKS)
    t_c, t_m = terms["t_compute"] * 1e3, terms["t_memory"] * 1e3
    bound = max(t_c, t_m)
    detail[label] = {"flops": trace.flops, "bytes": trace.bytes_accessed,
                     "t_compute_ms": t_c, "t_memory_ms": t_m,
                     "dominant": terms["dominant"], "ms": ms, "runs": runs,
                     "share": bound / ms, "compute_share": t_c / ms,
                     "profile": {"wall_ms": wall, "device_ms": devt,
                                 **fam},
                     "trace_s": trace_s, "memory": trace.memory()}
    print(f"roofline {label}: t_compute {t_c:.4f} ms, t_memory {t_m:.4f} "
          f"ms, dominant {terms['dominant']}, measured {ms:.4f} ms (median "
          f"of {len(runs)}), share {bound / ms:.4f}, compute share "
          f"{t_c / ms:.4f}; profiled call: wall {wall:.4f} ms, device "
          f"{devt:.4f} ms (busy {100 * devt / wall:.1f}%); flops "
          f"{trace.flops} (real run {real}), unfused bytes "
          f"{trace.bytes_accessed}, trace {trace_s:.1f} s  [{card}]",
          flush=True)
    del args
    gc.collect()
    torch.cuda.empty_cache()


def dryrun_cell_c(card, detail):
    """Phase 18(b): hillclimb cell C on the fake 16x16 mesh on this
    machine's torch: ``baseline`` through ``run_cell_roofline`` and
    ``run_cell_compile``, ``no_fsdp+bfp8w`` through ``measure``, then
    ``report.render`` over the JSONs."""
    import contextlib
    import io

    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import hillclimb as HC
    from repro_torch.roofline import report as REP

    arch, shape_name, variants = HC.VARIANTS["C"]
    mesh_name = "single_pod_16x16"
    out = tempfile.mkdtemp(prefix="dryrun_")
    try:
        with DR.fake_mesh(*DR.MESHES[mesh_name]) as mesh:
            t0 = time.perf_counter()
            r = DR.run_cell_roofline(arch, shape_name, mesh, mesh_name, out)
            t1 = time.perf_counter()
            c = DR.run_cell_compile(arch, shape_name, mesh, mesh_name, out)
            t2 = time.perf_counter()
            kw = dict((n, (k, p)) for n, k, p in variants)
            v = HC.measure(arch, shape_name, mesh, *kw[DRYRUN_C_VARIANTS[1]])
            t3 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            REP.render(out)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    table = buf.getvalue()
    flops = r["cost_analysis"]["flops"]
    per_dev = r["model_flops"] / r["n_devices"]
    t, tv = r["roofline"], v
    detail["dryrun_cell_C"] = {
        "baseline": r, "compile": c, DRYRUN_C_VARIANTS[1]: v,
        "report": table, "seconds": {"roofline": t1 - t0,
                                     "compile": t2 - t1, "variant": t3 - t2}}
    print(f"roofline cell_C {arch} {shape_name} 16x16 (fake): baseline "
          f"flops/device {flops:.6g} vs model/256 {per_dev:.6g} (ratio "
          f"{flops / per_dev:.4f}); t_compute {t['t_compute']:.6f} s, "
          f"t_memory {t['t_memory']:.6f} s, t_coll {t['t_collective']:.6f} "
          f"s, dominant {t['dominant']}; {DRYRUN_C_VARIANTS[1]}: t_compute "
          f"{tv['t_compute']:.6f} s, t_memory {tv['t_memory']:.6f} s, "
          f"t_coll {tv['t_collective']:.6f} s, dominant {tv['dominant']}; "
          f"full-depth trace: temp {c['memory_analysis']['temp_bytes']} "
          f"B/device; seconds {t1 - t0:.1f} + {t2 - t1:.1f} + "
          f"{t3 - t2:.1f}  [{card}]", flush=True)
    print(table.strip(), flush=True)
    check(r["n_devices"] == 256 and per_dev / 2 <= flops <= per_dev * 2,
          f"dryrun cell C: {flops:.6g} FLOPs per device, model FLOPs / 256 "
          f"{per_dev:.6g}")
    check(f"| {arch} | {shape_name} |" in table,
          f"dryrun cell C: report.render printed no row:\n{table}")


#: phase 18(c): cells that trace on meshes of many devices through
#: ``roofline.partition``'s rules, one roofline cell each of the RG-LRU
#: scan, a head count the model
#: axis does not divide and the WKV core, in training (hillclimb cell
#: B's MoE dispatch runs before them)
DRYRUN_MANY = (("recurrentgemma-9b", "train_4k"), ("minicpm-2b", "train_4k"),
               ("rwkv6-3b", "train_4k"))


def dryrun_many(card, detail):
    """Phase 18(c): hillclimb cell B's three variants through ``measure``
    and the :data:`DRYRUN_MANY` cells through ``run_cell_roofline``, on
    the fake 16x16 mesh of this machine's torch; the baseline's
    per-device FLOPs must lie within 0.5x-4x of model FLOPs / 256."""
    from repro_torch.configs.base import SHAPES
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch import hillclimb as HC

    mesh_name = "single_pod_16x16"
    arch, shape_name, variants = HC.VARIANTS["B"]
    per_dev = DR._model_flops(ARCHS[arch], SHAPES[shape_name]) / 256
    rows = detail["dryrun_many"] = {}
    out = tempfile.mkdtemp(prefix="dryrun_")
    try:
        with DR.fake_mesh(*DR.MESHES[mesh_name]) as mesh:
            for name, kw, patch in variants:
                t0 = time.perf_counter()
                t = HC.measure(arch, shape_name, mesh, kw, patch)
                secs = time.perf_counter() - t0
                ratio = t["hlo_flops"] / per_dev
                rows[f"cell_B/{name}"] = dict(t, ratio=ratio, seconds=secs)
                print(f"roofline cell_B_{name} {arch} {shape_name} 16x16 "
                      f"(fake): flops/device {t['hlo_flops']:.6g} vs "
                      f"model/256 {per_dev:.6g} (ratio {ratio:.4f}); "
                      f"t_compute {t['t_compute']:.6f} s, t_memory "
                      f"{t['t_memory']:.6f} s, t_coll "
                      f"{t['t_collective']:.6f} s, dominant "
                      f"{t['dominant']}; wire bytes "
                      f"{t['collective_wire_bytes']:.6g}; {secs:.1f} s  "
                      f"[{card}]", flush=True)
                if name == "baseline":
                    check(0.5 <= ratio <= 4, f"dryrun cell B: {ratio:.4f}x "
                          f"model FLOPs / 256 per device")
            for arch_c, shape_c in DRYRUN_MANY:
                t0 = time.perf_counter()
                r = DR.run_cell_roofline(arch_c, shape_c, mesh, mesh_name,
                                         out)
                secs = time.perf_counter() - t0
                t = r["roofline"]
                ratio = r["cost_analysis"]["flops"] / (r["model_flops"]
                                                       / r["n_devices"])
                rows[f"{arch_c}/{shape_c}"] = dict(r, seconds=secs)
                print(f"roofline {arch_c} {shape_c} 16x16 (fake): "
                      f"{r['layer_units']} layer units from 1 and 2; "
                      f"flops/device {r['cost_analysis']['flops']:.6g} "
                      f"({ratio:.4f}x model/256), bytes "
                      f"{r['cost_analysis']['bytes_accessed']:.6g}; "
                      f"t_compute {t['t_compute']:.6f} s, t_memory "
                      f"{t['t_memory']:.6f} s, t_coll "
                      f"{t['t_collective']:.6f} s, dominant "
                      f"{t['dominant']}; {secs:.1f} s  [{card}]",
                      flush=True)
                check(r["status"] == "ok" and t["hlo_flops"] > 0,
                      f"dryrun {arch_c} {shape_c}: {r['status']}")
    finally:
        shutil.rmtree(out, ignore_errors=True)


def dryrun_phase(dev, card, detail, seed):
    """Phase 18: the dry run and the roofline (see the module
    docstring)."""
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch.mesh import make_mesh

    t18 = time.perf_counter()
    print(card_line(), flush=True)      # the card under phase 18's numbers
    rows = detail["dryrun"] = {}
    K.reset_launch_counts()
    cfg = ARCHS["tinyllama-1.1b"]
    mesh = make_mesh((1, 1), ("data", "model"))
    try:
        for label, shape, bfp in DRYRUN_CELLS:
            dryrun_cell(dev, card, rows, f"tinyllama_{label}", cfg,
                        ShapeConfig(*shape), bfp, mesh, seed)
    finally:
        dist.destroy_process_group()
    counts = K.launch_counts()
    check(not any(counts.values()), f"phase 18: the float route launched "
          f"kernels: {counts}")
    dryrun_cell_c(card, rows)
    dryrun_many(card, rows)
    counts = K.launch_counts()
    check(not any(counts.values()), f"phase 18: the traces launched "
          f"kernels: {counts}")
    secs = time.perf_counter() - t18
    rows["seconds"] = secs
    print(f"phase 18: {secs:.1f} s, no kernel launched", flush=True)


def pol_lenet():
    """LeNet's kernel policy: PALLAS_TILED at block 16 (c2's K = 400 and
    fc1's 1568 are multiples), strict round to nearest."""
    from repro_torch.core.policy import PALLAS_TILED
    return PALLAS_TILED.with_(block_k=16, straight_through=False)


def main() -> int:
    ap = argparse.ArgumentParser(prog="chip_smoke")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "chip_smoke.json"))
    args = ap.parse_args()

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this smoke needs a card")
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import engine as EG
    from repro_torch import kernels as K
    from repro_torch.core.bfp import pow2
    from repro_torch.core.conv_utils import (conv_geometry,
                                             conv_weight_matrix, im2col)
    from repro_torch.core.policy import PALLAS_TILED, PAPER_DEFAULT
    from repro_torch.core.prequant import (act_block, dequantize_act,
                                           is_prequant, prequant_act,
                                           prequant_conv_leaf, prequant_leaf)
    from repro_torch.kernels import _build
    from repro_torch.kernels import bfp_conv as KC
    from repro_torch.kernels import bfp_matmul as KM
    from repro_torch.kernels import bfp_quantize as KQ
    from repro_torch.kernels import ops
    from repro_torch.models.cnn import MODELS, head_logits, layers, vgg
    from repro_torch.engine.plan import Plan
    from repro_torch.serve.cnn import CnnServeEngine

    # -- 1. the card -------------------------------------------------------
    card = card_line()
    device_kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    times = _build.build()
    print(f"build: {json.dumps(times)} wall {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name in _build.SOURCES:
        entry = None
        for line in _build.build_log(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name} {entry}: {line.strip()}")

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    pol = PALLAS_TILED.with_(straight_through=False)
    bk = pol.block_k

    def rnd(*shape, scale=1.0, relu=False):
        t = torch.randn(shape, generator=gen) * scale
        return (torch.relu(t) if relu else t).to(dev)

    # -- 3. each kernel against its plain version at main-path shapes -------
    # (label, path, kernel, kernel call, plain call, x, weight parts, M, N,
    # K, core); path is the served path that runs the shape, or
    # "off_path"
    cases = []

    def conv_case(label, path, x, w, stride, prequant, padding="SAME",
                  cbk=bk, L=8):
        kh, kw, c, oc = w.shape
        core = KC.conv_core(False, prequant, cbk, c, oc, L, None, L)
        if prequant:
            d = prequant_conv_leaf(w, pol)
            parts = (d["m"], d["s"])
            call = lambda: KC.bfp_conv2d_prequant(  # noqa: E731
                x, d["m"], d["s"], l_i=8, l_w=8, bk=bk, stride=stride,
                padding=padding)
            plain = lambda: KC.bfp_conv2d_prequant_plain(  # noqa: E731
                x, d["m"], d["s"], 8, 8, bk, stride, padding)
        else:
            parts = (w,)
            call = lambda: KC.bfp_conv2d(  # noqa: E731
                x, w, l_i=L, l_w=L, bk=cbk, stride=stride, padding=padding)
            plain = lambda: KC.bfp_conv2d_plain(  # noqa: E731
                x, w, L, L, cbk, stride, padding)
        name = "bfp_conv2d_prequant" if prequant else "bfp_conv2d"
        oh, ow, _, _ = conv_geometry(x.shape[1], x.shape[2], kh, kw, stride,
                                     padding)
        m = x.shape[0] * oh * ow
        cases.append((label, path, name, call, plain, x, parts, m, oc,
                      kh * kw * c, core))
        if prequant:        # its format pass, alone
            cases.append((label, path, "bfp_conv2d_xformat",
                          lambda: KC.bfp_conv2d_xformat(x, l_i=8, bk=bk),
                          lambda: KC.bfp_conv2d_xformat_plain(x, 8, bk), x,
                          (), x.numel() // bk, bk, 0, core))
        elif core == "mma":  # its patch format pass, alone
            cases.append((label, path, "bfp_conv2d_pformat",
                          lambda: KC.bfp_conv2d_pformat(
                              x, w, l_i=L, l_w=L, bk=cbk, stride=stride,
                              padding=padding),
                          lambda: KC.bfp_conv2d_pformat_plain(
                              x, w, L, L, cbk, stride, padding), x, (w,),
                          m, oc, 0, core))

    def mm_case(label, path, x, w, prequant, mbk=bk, L=8):
        (m, k), n = x.shape, w.shape[1]
        core = KM.matmul_core(prequant, mbk, k, n, L, L)
        # the matmul as the core runs it: the 1x1 conv over [1, M, 1, K]
        x4 = x.reshape(1, m, 1, k)
        if prequant:
            d = prequant_leaf(w, pol.with_(block_k=mbk))
            parts = (d["m"], d["s"])
            call = lambda: KM.bfp_matmul_prequant(  # noqa: E731
                x, d["m"], d["s"], l_i=L, l_w=8, bk=mbk)
            plain = lambda: KM.bfp_matmul_prequant_plain(  # noqa: E731
                x, d["m"], d["s"], L, 8, mbk)
        else:
            parts = (w,)
            call = lambda: KM.bfp_matmul(x, w, l_i=L, l_w=L,  # noqa: E731
                                         bk=mbk)
            plain = lambda: KM.bfp_matmul_plain(x, w, L, L,  # noqa: E731
                                                mbk)
        name = "bfp_matmul_prequant" if prequant else "bfp_matmul"
        cases.append((label, path, name, call, plain, x, parts, m, n, k,
                      core))
        if core == "mma" and prequant:   # its format pass, alone
            cases.append((label, path, "bfp_matmul_xformat",
                          lambda: KC.bfp_conv2d_xformat(x4, l_i=L, bk=mbk),
                          lambda: KC.bfp_conv2d_xformat_plain(x4, L, mbk),
                          x, (), x.numel() // mbk, mbk, 0, core))
        elif core == "mma":              # its patch format pass, alone
            w4 = w.reshape(1, 1, k, n)
            cases.append((label, path, "bfp_matmul_pformat",
                          lambda: KC.bfp_conv2d_pformat(
                              x4, w4, l_i=L, l_w=L, bk=mbk, stride=1,
                              padding="VALID"),
                          lambda: KC.bfp_conv2d_pformat_plain(
                              x4, w4, L, L, mbk, 1, "VALID"), x, (w,),
                          m, n, 0, core))

    b, full_p, red_p = 8, "vgg16_full", "vgg16_reduced"
    conv_case("conv1_1", full_p, rnd(b, 224, 224, 3),
              rnd(3, 3, 3, 64, scale=0.27), 1, False)
    conv_case("conv1_2", full_p, rnd(b, 224, 224, 64, relu=True),
              rnd(3, 3, 64, 64, scale=0.06), 1, False)
    conv_case("conv3_2", full_p, rnd(b, 56, 56, 256, relu=True),
              rnd(3, 3, 256, 256, scale=0.03), 1, True)
    conv_case("conv5_3", full_p, rnd(b, 14, 14, 512, relu=True),
              rnd(3, 3, 512, 512, scale=0.02), 1, True)
    conv_case("stem7x7s2", "resnet50_full", rnd(b, 224, 224, 3),
              rnd(7, 7, 3, 64, scale=0.12), 2, False)
    # the inline conv on the mma core at GoogLeNet's inline shapes (K 400,
    # 864; 1x1 over C = 192, 480, 832), blocks 32/128/512, L 4/8, N 16,
    # 24, 64, 128 and 192
    gn_p = "googlenet_full"
    conv_case("gn3a_5x5", gn_p, rnd(b, 28, 28, 16, relu=True),
              rnd(5, 5, 16, 24, scale=0.05), 1, False, cbk=32, L=4)
    conv_case("gn3a_3x3", gn_p, rnd(b, 28, 28, 96, relu=True),
              rnd(3, 3, 96, 128, scale=0.03), 1, False)
    conv_case("gn3a_1x1", gn_p, rnd(b, 28, 28, 192, relu=True),
              rnd(1, 1, 192, 64, scale=0.07), 1, False)
    conv_case("gn4a_1x1", gn_p, rnd(b, 14, 14, 480, relu=True),
              rnd(1, 1, 480, 16, scale=0.05), 1, False, cbk=512)
    conv_case("gn5b_1x1", gn_p, rnd(b, 7, 7, 832, relu=True),
              rnd(1, 1, 832, 192, scale=0.03), 1, False, cbk=32, L=4)
    # ... and at a ragged shape (M = 189, N = 20) with hazards: a zero, a
    # NaN and an inf pixel, a subnormal image, K-tiles wholly outside the
    # image (a 7x7 SAME window at the corners, block 32) and an inf weight
    xp = rnd(3, 9, 7, 4)
    xp[1] = 1e-40 * torch.sign(xp[1])
    xp[0, 0, 0, :] = 0.0
    xp[0, 0, 1, 2] = float("nan")
    xp[2, 8, 6, 3] = float("inf")
    wp = rnd(7, 7, 4, 20, scale=0.05)
    wp[0, 0, 0, 1] = float("inf")
    conv_case("ragged_7x7", "off_path", xp, wp, 1, False, cbk=32)
    # a policy that names no block: ops takes whole-K (576, tile kernel)
    x0, w0 = rnd(b, 28, 28, 64, relu=True), rnd(3, 3, 64, 64, scale=0.06)
    cases.append(("wholeK_576", "off_path", "bfp_conv2d",
                  lambda: ops.bfp_conv2d(x0, w0, pol.with_(block_k=None)),
                  lambda: KC.bfp_conv2d_plain(x0, w0, 8, 8, 576), x0, (w0,),
                  b * 28 * 28, 64, 576,
                  KC.conv_core(False, False, 576, 64, 64, 8)))
    # the mma core at ResNet-50 stage-4 shapes (3x3 and the stride-2
    # projection into the stage), and at a ragged M (3 images of 7x7 at
    # stride 2 VALID: 27 rows) with hazard chunks (zero, NaN, inf,
    # subnormal amax)
    conv_case("r50_s4_3x3", "resnet50_full", rnd(b, 7, 7, 512, relu=True),
              rnd(3, 3, 512, 512, scale=0.02), 1, True)
    conv_case("r50_s4_proj", "resnet50_full",
              rnd(b, 14, 14, 1024, relu=True),
              rnd(1, 1, 1024, 2048, scale=0.03), 2, True)
    xh = rnd(3, 7, 7, 256)
    xh[0, 0, 0, :bk] = 0.0
    xh[0, 1, 1, 5] = float("nan")
    xh[1, 2, 3, 7] = float("inf")
    xh[2, 6, 6, :bk] = 1e-40
    conv_case("ragged_M27", "off_path", xh, rnd(3, 3, 256, 40, scale=0.03),
              2, True, "VALID")
    # the f32-output matmuls on the mma core as 1x1 convs: VGG16 fc6-8,
    # ResNet-50's fc, GoogLeNet's loss fc1; M = 1 and 17, blocks 32, 128
    # and 512, L 4 and 8; inline at K = 64 and at a ragged K; hazard rows
    # (a zero block, NaN, inf, a subnormal row; an inf weight inline)
    mm_case("fc6", full_p, rnd(b, 25088, relu=True),
            rnd(25088, 4096, scale=0.009), True)
    mm_case("fc7", full_p, rnd(b, 4096, relu=True),
            rnd(4096, 4096, scale=0.02), True)
    mm_case("fc8", full_p, rnd(b, 4096, relu=True),
            rnd(4096, 1000, scale=0.02), True)
    mm_case("r50_fc", "resnet50_full", rnd(b, 2048, relu=True),
            rnd(2048, 1000, scale=0.03), True)
    mm_case("gn_loss_fc1", gn_p, rnd(b, 2048, relu=True),
            rnd(2048, 1024, scale=0.03), True)
    mm_case("fc6_M1_bk512", "off_path", rnd(1, 25088, relu=True),
            rnd(25088, 4096, scale=0.009), True, mbk=512, L=4)
    mm_case("fc8_M17_bk32", "off_path", rnd(17, 4096, relu=True),
            rnd(4096, 1000, scale=0.02), True, mbk=32, L=4)
    mm_case("fc6_reduced", red_p, rnd(b, 64, relu=True),
            rnd(64, 64, scale=0.18), False)
    mm_case("fc8_reduced", red_p, rnd(b, 64, relu=True),
            rnd(64, 10, scale=0.18), False)
    mm_case("fc7_inline", "off_path", rnd(b, 4096, relu=True),
            rnd(4096, 4096, scale=0.02), False)

    def hazard_rows(x, hbk):
        x[0, :hbk] = 0.0
        x[1, 3] = float("nan")
        x[2, -1] = float("inf")
        x[3] = 1e-40 * torch.sign(x[3])
        return x

    mm_case("ragged_pq_M17", "off_path",
            hazard_rows(rnd(17, 1536, relu=True), 512),
            rnd(1536, 36, scale=0.03), True, mbk=512)
    wh = rnd(2047, 44, scale=0.03)
    wh[700, 1] = float("inf")
    mm_case("ragged_K2047", "off_path",
            hazard_rows(rnd(17, 2047, relu=True), 32), wh, False, mbk=32)

    # the wire-x conv and the requantize epilogue on the mma core: the
    # x-prequant conv after its weight format pass, and every conv mode
    # and matmul with f32 x followed by the output format pass; each pass
    # also alone
    def wire_x(x, cbk, L, hazards):
        xm, xs = KC.bfp_conv2d_xformat_plain(x, L, cbk)
        if hazards:         # wire steps that are inf, NaN and subnormal
            xs[0, 0, 1, 0] = float("inf")
            xs[-1, 1, 1, -1] = float("nan")
            xs[0, 2, 2, 0] = 1e-40
        return xm, xs

    def epi_case(label, path, mode, x, w, stride=1, padding="SAME", cbk=bk,
                 L=8, lw=None, obits=8, ob=bk, hazards=False):
        """A conv of ``mode`` ("xprequant", "xwprequant", "prequant" or
        "inline") on f32 x (formatted to the wire first for the wire
        modes), with the epilogue (``obits`` None: f32 out)."""
        lw = L if lw is None else lw
        kh, kw, c, oc = w.shape
        wire = mode in ("xprequant", "xwprequant")
        prequant = mode in ("xwprequant", "prequant")
        core = KC.conv_core(wire, prequant, cbk, c, oc, L, obits, lw, ob)
        check(core == ("tile" if label.startswith("tile_") else "mma"),
              f"{label}: {mode} routed to the {core} core")
        xs_ = wire_x(x, cbk, L, hazards) if wire else (x,)
        ws_ = ((lambda d: (d["m"], d["s"]))(prequant_conv_leaf(
            w, pol.with_(block_k=cbk))) if prequant else (w,))
        name = "bfp_conv2d" if mode == "inline" else "bfp_conv2d_" + mode
        kern, plain_fn = getattr(KC, name), getattr(KC, name + "_plain")
        args = xs_ + ws_
        call = lambda: kern(*args, l_i=L, l_w=lw, bk=cbk,  # noqa: E731
                            stride=stride, padding=padding, out_bits=obits,
                            out_block=ob)
        plain = lambda: plain_fn(*args, L, lw, cbk, stride,  # noqa: E731
                                 padding, obits, ob)
        oh, ow, _, _ = conv_geometry(x.shape[1], x.shape[2], kh, kw, stride,
                                     padding)
        m = x.shape[0] * oh * ow
        xin = {"m": xs_[0], "s": xs_[1]} if wire else x
        cases.append((label, path, name, call, plain, xin, ws_, m, oc,
                      kh * kw * c, core))
        if core == "mma" and mode == "xprequant":   # its weight pass alone
            cases.append((label, path, "bfp_conv2d_wformat",
                          lambda: KC.bfp_conv2d_wformat(w, l_w=lw, bk=cbk),
                          lambda: KC.bfp_conv2d_wformat_plain(w, lw, cbk),
                          w, (), kh * kw * c, oc, 0, core))
        if core == "mma" and obits is not None:     # its output pass alone
            y = plain_fn(*args, L, lw, cbk, stride, padding)
            cases.append((label, path, "bfp_conv2d_oformat",
                          lambda: KC.bfp_conv2d_xformat(y, l_i=obits, bk=ob),
                          lambda: KM.requant_plain(y, obits, ob), y, (),
                          y.numel() // ob, ob, 0, core))

    def mm_epi_case(label, path, x, w, prequant, mbk=bk, L=8, obits=8,
                    ob=bk):
        (m, k), n = x.shape, w.shape[1]
        core = KM.matmul_core(prequant, mbk, k, n, L, L, obits, ob)
        check(core == "mma", f"{label}: matmul routed to the {core} core")
        lw = 8 if prequant else L
        if prequant:
            d = prequant_leaf(w, pol.with_(block_k=mbk))
            args, name = (x, d["m"], d["s"]), "bfp_matmul_prequant"
        else:
            args, name = (x, w), "bfp_matmul"
        kern, plain_fn = getattr(KM, name), getattr(KM, name + "_plain")
        cases.append((label, path, name,
                      lambda: kern(*args, l_i=L, l_w=lw, bk=mbk,
                                   out_bits=obits, out_block=ob),
                      lambda: plain_fn(*args, L, lw, mbk, obits, ob), x,
                      args[1:], m, n, k, core))
        if core == "mma":                           # its output pass alone
            y4 = plain_fn(*args, L, lw, mbk).reshape(1, m, 1, n)
            cases.append((label, path, "bfp_matmul_oformat",
                          lambda: KC.bfp_conv2d_xformat(y4, l_i=obits,
                                                        bk=ob),
                          lambda: KC.bfp_conv2d_xformat_plain(y4, obits, ob),
                          y4, (), m * n // ob, ob, 0, core))

    # VGG16 conv4_2 as chain_B runs it (wire x, float w) and as chain_A
    # does (wire x, prequant w), conv3_1 as chain_A (prequant) and chain_B
    # (inline) run it, each requantized for its consumer; fc6 likewise
    x42, w42 = rnd(b, 28, 28, 512, relu=True), rnd(3, 3, 512, 512,
                                                   scale=0.02)
    epi_case("conv4_2", "chain_B", "xprequant", x42, w42)
    epi_case("conv4_2", "chain_A", "xwprequant", x42, w42)
    x31, w31 = rnd(b, 56, 56, 128, relu=True), rnd(3, 3, 128, 256,
                                                   scale=0.03)
    epi_case("conv3_1", "chain_A", "prequant", x31, w31)
    epi_case("conv3_1", "chain_B", "inline", x31, w31)
    x6, w6 = rnd(b, 25088, relu=True), rnd(25088, 4096, scale=0.009)
    mm_epi_case("fc6", "chain_A", x6, w6, True)
    mm_epi_case("fc6", "chain_B", x6, w6, False)
    # every mode at a ragged M (189 rows) and OC = 40 with block 32,
    # out_block 4, L 6 out: zero, NaN, inf and subnormal pixels, wire
    # steps that are inf, NaN and subnormal, an inf weight
    xr = rnd(3, 9, 7, 64)
    xr[1] = 1e-40 * torch.sign(xr[1])
    xr[0, 0, 0, :32] = 0.0
    xr[0, 1, 1, 3] = float("nan")
    xr[2, 8, 6, 31] = float("inf")
    wr = rnd(3, 3, 64, 40, scale=0.05)
    wr[0, 1, 2, 3] = float("inf")
    for mode in ("xprequant", "xwprequant", "prequant", "inline"):
        epi_case("ragged_" + mode, "off_path", mode, xr, wr, cbk=32, obits=6,
                 ob=4, hazards=True)
    # blocks 512 and 128 (stride 2, VALID), OC = 200 and 224, out_block 8
    # and 32
    epi_case("wx_bk512", "off_path", "xprequant", rnd(2, 7, 7, 512),
             rnd(1, 1, 512, 200, scale=0.03), cbk=512, L=4, obits=3, ob=8)
    epi_case("wx_s2", "off_path", "xprequant", rnd(3, 7, 5, 256),
             rnd(3, 3, 256, 224, scale=0.03), stride=2, padding="VALID",
             obits=8, ob=32, hazards=True)
    mm_epi_case("ragged_mm_pq", "off_path",
                hazard_rows(rnd(17, 1536, relu=True), 512),
                rnd(1536, 36, scale=0.03), True, mbk=512, obits=3, ob=4)
    mm_epi_case("ragged_mm_K2047", "off_path",
                hazard_rows(rnd(17, 2047, relu=True), 32), wh, False, mbk=32,
                L=4, obits=6, ob=4)
    # the tile kernel keeps L_W = 9, out_block = 2 and OC % 4 != 0
    epi_case("tile_L9", "off_path", "xprequant", xr, wr, cbk=32, lw=9,
             ob=8, hazards=True)
    epi_case("tile_ob2", "off_path", "xwprequant", xr, wr, cbk=32, ob=2,
             hazards=True)
    epi_case("tile_oc30", "off_path", "xprequant", xr,
             wr[..., :30].contiguous(), cbk=32, obits=None, hazards=True)

    # the x-prequant matmul (wire x, float w) on the mma core after its
    # weight format pass, as the 1x1 conv over [1, M, 1, K]; each pass
    # also alone
    def wx_mm_case(label, path, x, w, mbk=bk, lw=8, obits=8, ob=bk,
                   hazards=False):
        """``x`` f32 formatted to the wire first (L 8); with ``hazards``
        its first block is zero and its wire steps hold an inf, a NaN
        and a subnormal, and ``w`` an inf."""
        (m, k), n = x.shape, w.shape[1]
        core = KM.matmul_core(False, mbk, k, n, 8, lw, obits, ob,
                              wire_x=True)
        check(core == ("tile" if label.startswith("tile_") else "mma"),
              f"{label}: wire-x matmul routed to the {core} core")
        if hazards:
            x[0, :mbk] = 0.0
            w[k // 3, 1] = float("inf")
        xm, xs = KC.bfp_conv2d_xformat_plain(x.reshape(1, m, 1, k), 8, mbk)
        xm, xs = xm.reshape(m, k), xs.reshape(m, k // mbk)
        if hazards:
            xs[0, -1] = float("inf")
            xs[-1, 0] = float("nan")
            xs[m // 2, 1] = 1e-40
        cases.append((label, path, "bfp_matmul_xprequant",
                      lambda: KM.bfp_matmul_xprequant(
                          xm, xs, w, l_i=8, l_w=lw, bk=mbk, out_bits=obits,
                          out_block=ob),
                      lambda: KM.bfp_matmul_xprequant_plain(
                          xm, xs, w, 8, lw, mbk, obits, ob),
                      {"m": xm, "s": xs}, (w,), m, n, k, core))
        if core != "mma":
            return
        w4 = w.reshape(1, 1, k, n)                  # its weight pass alone
        cases.append((label, path, "bfp_matmul_wformat",
                      lambda: KC.bfp_conv2d_wformat(w4, l_w=lw, bk=mbk),
                      lambda: KC.bfp_conv2d_wformat_plain(w4, lw, mbk), w,
                      (), k, n, 0, core))
        if obits is not None:                       # its output pass alone
            y4 = KM.bfp_matmul_xprequant_plain(xm, xs, w, 8, lw,
                                               mbk).reshape(1, m, 1, n)
            cases.append((label, path, "bfp_matmul_oformat",
                          lambda: KC.bfp_conv2d_xformat(y4, l_i=obits,
                                                        bk=ob),
                          lambda: KC.bfp_conv2d_xformat_plain(y4, obits, ob),
                          y4, (), m * n // ob, ob, 0, core))

    # chain B's fc7 (out_policy for fc8) and fc8 at batch 8
    wx_mm_case("fc7", "chain_B", rnd(b, 4096, relu=True),
               rnd(4096, 4096, scale=0.02))
    wx_mm_case("fc8", "chain_B", rnd(b, 4096, relu=True),
               rnd(4096, 1000, scale=0.02), obits=None)
    # M = 1 and 17, blocks 512, 32 and 128, out_block 8, 4 and 128, L_W 4
    # and 6, hazards
    wx_mm_case("wx_M1_bk512", "off_path", rnd(1, 4096),
               rnd(4096, 1000, scale=0.02), mbk=512, lw=4, obits=6, ob=8,
               hazards=True)
    wx_mm_case("wx_M17_bk32", "off_path", rnd(17, 1536),
               rnd(1536, 36, scale=0.03), mbk=32, obits=3, ob=4,
               hazards=True)
    wx_mm_case("wx_M17_ob128", "off_path", rnd(17, 2048),
               rnd(2048, 256, scale=0.03), lw=6, ob=128, hazards=True)
    # the tile kernel keeps L_W = 9, N % 4 != 0 and out_block = 2
    wx_mm_case("tile_wx_L9", "off_path", rnd(17, 1536),
               rnd(1536, 36, scale=0.03), mbk=32, lw=9, ob=4, hazards=True)
    wx_mm_case("tile_wx_N30", "off_path", rnd(17, 1536),
               rnd(1536, 30, scale=0.03), mbk=32, obits=None, hazards=True)
    wx_mm_case("tile_wx_ob2", "off_path", rnd(17, 1536),
               rnd(1536, 36, scale=0.03), mbk=32, ob=2, hazards=True)

    # the xw-prequant matmul (both operands on the wire) on the mma core,
    # as the 1x1 conv over [1, M, 1, K] with no format pass; its output
    # pass also alone
    def xw_mm_case(label, path, x, w, mbk=bk, lw=8, obits=8, ob=bk,
                   hazards=False):
        """``x`` f32 formatted to the wire first (L 8), ``w`` prequantized
        (L ``lw``); with ``hazards`` x's first block is zero, its wire
        steps hold an inf, a NaN and a subnormal, and a weight step is
        inf."""
        (m, k), n = x.shape, w.shape[1]
        core = KM.matmul_core(True, mbk, k, n, 8, lw, obits, ob,
                              wire_x=True)
        check(core == ("tile" if label.startswith("tile_") else "mma"),
              f"{label}: xw matmul routed to the {core} core")
        if hazards:
            x[0, :mbk] = 0.0
        xm, xs = KC.bfp_conv2d_xformat_plain(x.reshape(1, m, 1, k), 8, mbk)
        xm, xs = xm.reshape(m, k), xs.reshape(m, k // mbk)
        d = prequant_leaf(w, pol.with_(block_k=mbk, l_w=lw))
        wm, ws = d["m"], d["s"]
        if hazards:
            xs[0, -1] = float("inf")
            xs[-1, 0] = float("nan")
            xs[m // 2, 1] = 1e-40
            ws[k // mbk // 2, 1] = float("inf")
        cases.append((label, path, "bfp_matmul_xwprequant",
                      lambda: KM.bfp_matmul_xwprequant(
                          xm, xs, wm, ws, l_i=8, l_w=lw, bk=mbk,
                          out_bits=obits, out_block=ob),
                      lambda: KM.bfp_matmul_xwprequant_plain(
                          xm, xs, wm, ws, 8, lw, mbk, obits, ob),
                      {"m": xm, "s": xs}, (wm, ws), m, n, k, core))
        if core == "mma" and obits is not None:     # its output pass alone
            y4 = KM.bfp_matmul_xwprequant_plain(xm, xs, wm, ws, 8, lw,
                                                mbk).reshape(1, m, 1, n)
            cases.append((label, path, "bfp_matmul_oformat",
                          lambda: KC.bfp_conv2d_xformat(y4, l_i=obits,
                                                        bk=ob),
                          lambda: KC.bfp_conv2d_xformat_plain(y4, obits, ob),
                          y4, (), m * n // ob, ob, 0, core))

    # chain A's fc7 (out_policy for fc8) and fc8 at batch 8
    xw_mm_case("fc7", "chain_A", rnd(b, 4096, relu=True),
               rnd(4096, 4096, scale=0.02))
    xw_mm_case("fc8", "chain_A", rnd(b, 4096, relu=True),
               rnd(4096, 1000, scale=0.02), obits=None)
    # M = 1 and 17, blocks 512, 32 and 128, out_block 8, 4 and 128, L_W 4
    # and 6, hazards
    xw_mm_case("xw_M1_bk512", "off_path", rnd(1, 4096),
               rnd(4096, 1000, scale=0.02), mbk=512, lw=4, obits=6, ob=8,
               hazards=True)
    xw_mm_case("xw_M17_bk32", "off_path", rnd(17, 1536),
               rnd(1536, 36, scale=0.03), mbk=32, obits=3, ob=4,
               hazards=True)
    xw_mm_case("xw_M17_ob128", "off_path", rnd(17, 2048),
               rnd(2048, 256, scale=0.03), lw=6, ob=128, hazards=True)
    # the tile kernel keeps a block of 96, N % 4 != 0 and out_block = 2
    xw_mm_case("tile_xw_bk96", "off_path", rnd(17, 1536),
               rnd(1536, 36, scale=0.03), mbk=96, ob=4, hazards=True)
    xw_mm_case("tile_xw_N30", "off_path", rnd(17, 1536),
               rnd(1536, 30, scale=0.03), mbk=32, obits=None, hazards=True)
    xw_mm_case("tile_xw_ob2", "off_path", rnd(17, 1536),
               rnd(1536, 36, scale=0.03), mbk=32, ob=2, hazards=True)

    errs = {}
    for label, path, name, call, plain, x, *_, core in cases:
        got, want = call(), plain()
        torch.cuda.synchronize()
        err = diff(got, want)
        equal = same_bits(got, want)
        shape = tuple((got[0] if isinstance(got, tuple) else got).shape)
        print(f"check {label:<11} {path:<14} {name:<20} {shape} "
              f"torch.equal={equal} max_abs_diff={err} core={core}",
              flush=True)
        check(equal, f"{name} differs from its plain version at {label}")
        errs[name] = max(errs.get(name, 0.0), err)

    # -- 4. the main path: serve full-width VGG16 ---------------------------
    plain_matmul, plain_conv = register_plain_backend()

    served_logits = {}      # each served path's 16 logits (phase 11)

    def serve(label, params, hw, per_forward, apply=vgg.apply):
        plan = EG.bind(params, pol, tree="cnn", strict=True)
        images = torch.randn((16, hw, hw, 3), generator=gen)
        pplan = EG.bind(params, pol.with_(backend="plain"), tree="cnn",
                        strict=True)
        eng, served, counts = serve_check(
            label, plan, apply, images, per_forward, dev,
            1000 if hw == 224 else 10, pplan)
        served_logits[label] = served
        return plan, eng, images, counts, pplan

    # each path's own launches: counts zeroed just before it, read after
    launches = {}
    full_params = vgg.init(gen, device=dev)
    plan, eng, images, launches[full_p], _ = serve(
        full_p, full_params, 224,
        {"bfp_conv2d": 3, "bfp_conv2d_pformat": 3, "bfp_conv2d_prequant": 10,
         "bfp_conv2d_xformat": 10, "bfp_matmul_prequant": 3,
         "bfp_matmul_xformat": 3, "bfp_matmul": 0, "bfp_matmul_pformat": 0,
         **dict.fromkeys(WIRE_COUNTERS, 0)})
    red_plan, _, red_images, launches[red_p], _ = serve(
        red_p, MODELS["vgg16"].init(gen, reduced=True, device=dev), 32,
        {"bfp_conv2d": 13, "bfp_conv2d_pformat": 13,
         "bfp_conv2d_prequant": 0, "bfp_conv2d_xformat": 0,
         "bfp_matmul_prequant": 0, "bfp_matmul_xformat": 0,
         "bfp_matmul": 3, "bfp_matmul_pformat": 2,
         **dict.fromkeys(WIRE_COUNTERS, 0)})

    # -- 5. timing ---------------------------------------------------------
    detail = {"card": card, "kind": device_kind, "seed": args.seed, "shapes": [],
              "layers": {}, "launches": launches,
              "build_s": times}
    for label, path, name, call, plain, x, parts, m, n, k, _ in cases:
        out = call()
        ms = cuda_ms(call, reps=20)
        pms = cuda_ms(plain, reps=3)
        bms, by = bound(x, parts, out, m, n, k)
        row = {"shape": label, "path": path, "kernel": name, "ms": ms,
               "plain_ms": pms, "bound_ms": bms, "bound_by": by, "M": m,
               "N": n, "K": k}
        detail["shapes"].append(row)
        print(f"time {label:<11} {path:<14} {name:<20} kernel {ms:.4f} ms  "
              f"plain {pms:.4f} ms  bound {bms:.4f} ms ({by})  [{card}]",
              flush=True)

    # every layer of one batch-8 forward of each path: kernel and plain
    # times at the layer's own input, and its bound
    class RecordingPlan(Plan):
        """The plan, recording each conv/GEMM call of a forward."""

        def __init__(self, plan):
            super().__init__(dict(plan.sites), plan.params, plan.policy,
                             plan.strict, device=plan.device)
            self.calls = []

        def conv2d(self, x, w, *, path=None, stride=1, padding="SAME",
                   out_policy=None, noise=None):
            self.calls.append((path, "conv", x, w, stride, padding))
            return super().conv2d(x, w, path=path, stride=stride,
                                  padding=padding, out_policy=out_policy,
                                  noise=noise)

        def gemm(self, x, w, *, path=None, out_policy=None, noise=None):
            self.calls.append((path, "gemm", x, w, 1, None))
            return super().gemm(x, w, path=path, out_policy=out_policy,
                                noise=noise)

    def time_layers(label, plan, apply, imgs):
        """Each BFP layer of one batch-8 forward through ``plan``, at its
        own input: checked equal to its plain version, timed (CUDA events;
        kernel 5 calls, plain 2), with its bound."""
        rec = RecordingPlan(plan)
        rows = detail["layers"][label] = {}
        with torch.inference_mode():
            apply(rec.params, imgs[:8].to(dev), rec)
            for path, op, x, w, stride, padding in rec.calls:
                if op == "conv":
                    call = lambda: plan.conv2d(  # noqa: E731
                        x, w, path=path, stride=stride, padding=padding)
                    plain = lambda: plain_conv(  # noqa: E731
                        x, w, pol, stride, padding)
                    kh, kw, c, n = (w["m"] if is_prequant(w) else w).shape
                    k = kh * kw * c
                else:
                    call = lambda: plan.gemm(x, w, path=path)  # noqa: E731
                    plain = lambda: plain_matmul(x, w, pol)  # noqa: E731
                    k, n = (w["m"] if is_prequant(w) else w).shape
                out, ref = call(), plain()
                kname = (("bfp_conv2d" if op == "conv" else "bfp_matmul")
                         + ("_prequant" if is_prequant(w) else ""))
                check(torch.equal(out, ref),
                      f"{label} {path}: kernel != plain")
                errs[kname] = max(errs.get(kname, 0.0),
                                  (out - ref).abs().max().item())
                parts = (w["m"], w["s"]) if is_prequant(w) else (w,)
                bms, by = bound(x, parts, out, out.numel() // n, n, k)
                kb = (k // w["s"].shape[0] if is_prequant(w)
                      else pol.block_k)
                core = (KC.conv_core(is_prequant(x), is_prequant(w), kb, c,
                                     n, pol.l_i, None, pol.l_w)
                        if op == "conv" else
                        KM.matmul_core(is_prequant(w), kb, k, n, pol.l_i,
                                       pol.l_w))
                rows[path] = {"kernel": kname, "core": core,
                              "shape": [out.numel() // n, n, k],
                              "ms": cuda_ms(call, reps=5),
                              "plain_ms": cuda_ms(plain, reps=2),
                              "bound_ms": bms, "bound_by": by}
                # a GEMM's passes run on it as the 1x1 conv over
                # [1, M, 1, K] (w [1, 1, K, N]), stride 1, VALID
                fx, fw, fs, fp = ((x, w, stride, padding) if op == "conv"
                                  else (x.reshape(1, x.shape[0], 1, k),
                                        w if is_prequant(w) else
                                        w.reshape(1, 1, k, n), 1, "VALID"))
                fam = "bfp_conv2d" if op == "conv" else "bfp_matmul"
                if core == "mma" and is_prequant(w) and not is_prequant(x):
                    # the format pass inside that call, alone: x f32 in,
                    # int8 mantissas and f32 steps out
                    fmt = lambda: KC.bfp_conv2d_xformat(  # noqa: E731
                        fx, l_i=pol.l_i, bk=kb)
                    fplain = lambda: KC.bfp_conv2d_xformat_plain(  # noqa
                        fx, pol.l_i, kb)
                    got, want = fmt(), fplain()
                    check(same_bits(got, want),
                          f"{label} {path}: format pass != plain")
                    errs[fam + "_xformat"] = max(
                        errs.get(fam + "_xformat", 0.0), diff(got, want))
                    fb, fby = bound(x, (), got, x.numel() // kb, kb, 0)
                    rows[path + "/xformat"] = {
                        "kernel": fam + "_xformat", "core": "mma",
                        "shape": [x.numel() // kb, kb, 0],
                        "ms": cuda_ms(fmt, reps=5),
                        "plain_ms": cuda_ms(fplain, reps=2),
                        "bound_ms": fb, "bound_by": fby}
                elif core == "mma" and not is_prequant(w):
                    # the patch format pass inside that call, alone: x
                    # and w f32 in, the patch and weight blocks out
                    fmt = lambda: KC.bfp_conv2d_pformat(  # noqa: E731
                        fx, fw, l_i=pol.l_i, l_w=pol.l_w, bk=pol.block_k,
                        stride=fs, padding=fp)
                    fplain = lambda: KC.bfp_conv2d_pformat_plain(  # noqa
                        fx, fw, pol.l_i, pol.l_w, pol.block_k, fs, fp)
                    got, want = fmt(), fplain()
                    check(same_bits(got, want),
                          f"{label} {path}: patch format pass != plain")
                    errs[fam + "_pformat"] = max(
                        errs.get(fam + "_pformat", 0.0), diff(got, want))
                    fb, fby = bound(x, (w,), got, out.numel() // n, n, 0)
                    rows[path + "/pformat"] = {
                        "kernel": fam + "_pformat", "core": "mma",
                        "shape": [out.numel() // n, n, k],
                        "ms": cuda_ms(fmt, reps=5),
                        "plain_ms": cuda_ms(fplain, reps=2),
                        "bound_ms": fb, "bound_by": fby}
        for path, row in rows.items():
            print(f"time layer {label:<13} {path:<12} {row['kernel']:<20} "
                  f"core={row['core']:<4} M,N,K={row['shape']} kernel "
                  f"{row['ms']:.4f} ms  plain "
                  f"{row['plain_ms']:.4f} ms  bound {row['bound_ms']:.4f} ms "
                  f"({row['bound_by']})  [{card}]")
        layer_rows = [r for r in rows.values()
                      if r["kernel"] not in FORMAT_PASSES]
        fmt_ms = sum(r["ms"] for r in rows.values()
                     if r["kernel"] in FORMAT_PASSES)
        print(f"time {label}: {len(layer_rows)} layers, kernel "
              f"{sum(r['ms'] for r in layer_rows):.4f} ms, plain "
              f"{sum(r['plain_ms'] for r in layer_rows):.4f} ms, bound "
              f"{sum(r['bound_ms'] for r in layer_rows):.4f} ms (format "
              f"passes inside them: {fmt_ms:.4f} ms)  [{card}]", flush=True)

    time_layers(full_p, plan, vgg.apply, images)
    time_layers(red_p, red_plan, vgg.apply, red_images)
    fwd = plan.jit_forward(vgg.apply)
    xb = images[:8].to(dev)
    detail["forward_ms"] = cuda_ms(lambda: fwd(xb), reps=5)
    print(f"time forward batch 8: {detail['forward_ms']:.4f} ms  [{card}]")

    reqs = [eng.submit(image=images[i]) for i in range(16)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    check(all(r.error is None for r in reqs), "timed serve run failed")
    detail["serve_req_per_s"] = 16 / serve_s
    print(f"time serve: 16 requests at bucket 8 in {serve_s:.4f} s = "
          f"{16 / serve_s:.2f} req/s  [{card}]", flush=True)

    # one more served run under the profiler: device-busy share of the
    # serve wall time and where the host time goes (a separate run, so
    # the req/s above carries no tracing cost)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for i in range(16):
        eng.submit(image=images[i])
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    # device events only: a host op's entry repeats its kernels' time
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    top_host = sorted(events, key=lambda e: e.self_cpu_time_total,
                      reverse=True)[:8]
    detail["profile"] = {
        "wall_ms": wall_ms, "device_ms": device_ms,
        "host_self_ms": {e.key: e.self_cpu_time_total / 1e3
                         for e in top_host}}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    prof.export_chrome_trace(os.path.join(os.path.dirname(args.out),
                                          "serve_trace.json"))
    busy = (f"{100 * device_ms / wall_ms:.1f}%" if device_ms > 0
            else "not measured (no device events)")
    print(f"profile serve: wall {wall_ms:.3f} ms, device kernels "
          f"{device_ms:.3f} ms, device busy {busy}; top host self time "
          f"(ms): {json.dumps({k: round(v, 3) for k, v in detail['profile']['host_self_ms'].items()})}"
          f"  [{card}]", flush=True)

    # -- 6. the activation wire-format chain ------------------------------
    wire_plans = {
        "chain_A": (plan, EG.bind(full_params, pol.with_(backend="plain"),
                                  tree="cnn", strict=True)),
        "chain_B": tuple(EG.bind(full_params, p, tree="cnn", strict=True,
                                 prequantize=False)
                         for p in (pol, pol.with_(backend="plain")))}
    heads = {stage[0] for stage in CHAIN_STAGES}
    entries = {}
    with torch.inference_mode():     # the f32 forward of phase 4's plan
        x = images[:8].to(dev)
        for name, _ in vgg.VGG16_CONV_PLAN:
            if name == "pool":
                x = layers.max_pool(x)
                continue
            if name in heads:
                entries[name] = x
            x = torch.relu(EG.conv2d(x, plan.params[name]["w"], plan,
                                     path=name) + plan.params[name]["b"])
        entries["fc6"] = x.reshape(8, -1)

    def run_chain(p, stage, wire=True):
        """(layer, input, output, out_policy) of each layer of ``stage``
        through plan ``p``; ``wire=False`` hands over f32."""
        steps, x = [], entries[stage[0]]
        for i, name in enumerate(stage):
            nxt = stage[i + 1] if wire and i + 1 < len(stage) else None
            opol = p.out_policy_for(nxt) if nxt else None
            fn = p.gemm if name.startswith("fc") else p.conv2d
            y = fn(x, p.params[name]["w"], path=name, out_policy=opol)
            steps.append((name, x, y, opol))
            x = y
        return steps

    def same(a, b):
        return (isinstance(a, dict) == isinstance(b, dict)
                and same_tree(a, b, nan_aware=False))

    def kernel_of(p, name, x):
        w = p.params[name]["w"]
        base = "bfp_matmul" if name.startswith("fc") else "bfp_conv2d"
        if is_prequant(x):
            return base + ("_xwprequant" if is_prequant(w) else "_xprequant")
        return base + ("_prequant" if is_prequant(w) else "")

    with torch.inference_mode():
        for label, (kplan, pplan) in wire_plans.items():
            K.reset_launch_counts()
            runs = [run_chain(kplan, stage) for stage in CHAIN_STAGES]
            torch.cuda.synchronize()
            launches[label] = K.launch_counts()
            fused = (launches[label]["bfp_conv2d_epilogue"]
                     + launches[label]["bfp_matmul_epilogue"])
            print(f"path {label}: launches per chain run "
                  f"{ {k: v for k, v in launches[label].items() if v} }, "
                  f"requantize epilogue {fused}", flush=True)
            want = {**dict.fromkeys(launches[label], 0),
                    **CHAIN_LAUNCHES[label]}
            check(launches[label] == want,
                  f"{label}: launches {launches[label]} != {want}")
            for stage, steps in zip(CHAIN_STAGES, runs):
                # (a) the same chain through the plain versions
                for (name, x, y, opol), (_, _, py, _) in zip(
                        steps, run_chain(pplan, stage)):
                    kname = kernel_of(kplan, name, x)
                    errs[kname] = max(errs.get(kname, 0.0), tree_diff(y, py))
                    check(same(y, py), f"{label} {name}: {kname} differs "
                                       f"from the plain-version chain")
                    # (b) the epilogue == the two-step route
                    if opol is not None:
                        fn = kplan.gemm if name.startswith("fc") \
                            else kplan.conv2d
                        two = prequant_act(fn(x, kplan.params[name]["w"],
                                              path=name), opol)
                        check(same(y, two), f"{label} {name}: epilogue != "
                                            f"prequant_act of the f32 output")
                # (c) the wire chain's end == the float-activation chain's
                flt = run_chain(kplan, stage, wire=False)[-1][2]
                check(same(steps[-1][2], flt),
                      f"{label} {stage}: wire chain != float chain")
            print(f"path {label}: every layer torch.equal to the "
                  f"plain-version chain, every out_policy output to "
                  f"prequant_act of its f32 output, each stage's end to the "
                  f"float-activation chain", flush=True)

            # per layer as it runs in the chain: kernel, plain, f32 handoff
            rows = detail["layers"][label] = {}
            for steps in runs:
                for name, x, y, opol in steps:
                    w = kplan.params[name]["w"]
                    fc = name.startswith("fc")
                    fn = kplan.gemm if fc else kplan.conv2d
                    xf = dequantize_act(x) if is_prequant(x) else x
                    yf = fn(xf, w, path=name)
                    wt = w["m"] if is_prequant(w) else w
                    parts = (w["m"], w["s"]) if is_prequant(w) else (w,)
                    if fc:
                        (k, n), m = wt.shape, xf.shape[0]
                    else:
                        kh, kw, c, n = wt.shape
                        m, k = xf.shape[0] * xf.shape[1] * xf.shape[2], \
                            kh * kw * c
                    bms, by = bound(x, parts, y, m, n, k)
                    kb = (k // w["s"].shape[0] if is_prequant(w)
                          else pol.block_k)
                    obits, ob = ((opol.l_i, opol.block_k) if opol is not None
                                 else (None, None))
                    if not fc:
                        core = KC.conv_core(is_prequant(x), is_prequant(w),
                                            kb, c, n, pol.l_i, obits,
                                            pol.l_w, ob)
                    else:
                        core = KM.matmul_core(is_prequant(w), kb, k, n,
                                              pol.l_i, pol.l_w, obits, ob,
                                              wire_x=is_prequant(x))
                    check(core == "mma",
                          f"{label} {name}: ran on the {core} core")
                    row = rows[name] = {
                        "kernel": kernel_of(kplan, name, x), "core": core,
                        "epilogue": opol is not None, "shape": [m, n, k],
                        "ms": cuda_ms(lambda: fn(x, w, path=name,
                                                 out_policy=opol), reps=5),
                        "plain_ms": cuda_ms(lambda: (plain_matmul(
                            x, w, pol, opol) if fc else plain_conv(
                            x, w, pol, 1, "SAME", opol)), reps=2),
                        "f32_ms": cuda_ms(lambda: fn(xf, w, path=name),
                                          reps=5),
                        "bound_ms": bms, "bound_by": by,
                        "f32_bound_ms": bound(xf, parts, yf, m, n, k)[0]}
                    print(f"time chain {label} {name:<8} {row['kernel']:<22} "
                          f"core={core:<4} epilogue={row['epilogue']!s:<5} "
                          f"M,N,K={row['shape']} "
                          f"kernel {row['ms']:.4f} ms  plain "
                          f"{row['plain_ms']:.4f} ms  f32 handoff "
                          f"{row['f32_ms']:.4f} ms  bound {bms:.4f} ms ({by}),"
                          f" f32 bound {row['f32_bound_ms']:.4f} ms  [{card}]",
                          flush=True)
                    # the passes around the core in that call, each alone:
                    # a float weight's format pass, the output format pass
                    # over the layer's f32 output (a GEMM's as [1, M, 1, N])
                    fam = "bfp_matmul" if fc else "bfp_conv2d"
                    passes = []
                    if core == "mma" and is_prequant(x) and not \
                            is_prequant(w):
                        w4 = w.reshape(1, 1, k, n) if fc else w
                        passes.append((
                            "wformat", fam + "_wformat", w,
                            lambda: KC.bfp_conv2d_wformat(w4, l_w=pol.l_w,
                                                          bk=kb),
                            lambda: KC.bfp_conv2d_wformat_plain(
                                w4, pol.l_w, kb)))
                    if core == "mma" and opol is not None:
                        y4 = yf.reshape(1, m, 1, n) if fc else yf
                        passes.append((
                            "oformat", fam + "_oformat", y4,
                            lambda: KC.bfp_conv2d_xformat(y4, l_i=obits,
                                                          bk=ob),
                            lambda: KC.bfp_conv2d_xformat_plain(y4, obits,
                                                                ob)))
                    for tag, pname, pin, pcall, pplain in passes:
                        got, want = pcall(), pplain()
                        check(same_bits(got, want),
                              f"{label} {name}: {tag} pass != plain")
                        errs[pname] = max(errs.get(pname, 0.0),
                                          diff(got, want))
                        pb, pby = bound(pin, (), got, 0, 0, 0)
                        prow = rows[f"{name}/{tag}"] = {
                            "kernel": pname, "core": "mma",
                            "epilogue": False, "shape": list(pin.shape),
                            "ms": cuda_ms(pcall, reps=5),
                            "plain_ms": cuda_ms(pplain, reps=2),
                            "bound_ms": pb, "bound_by": pby}
                        print(f"time chain {label} {name + '/' + tag:<14} "
                              f"{pname:<22} kernel {prow['ms']:.4f} ms  "
                              f"plain {prow['plain_ms']:.4f} ms  bound "
                              f"{pb:.4f} ms ({pby})  [{card}]", flush=True)
            epi = [r for r in rows.values() if r["epilogue"]]
            wx = [r for r in rows.values()
                  if r["kernel"] == "bfp_conv2d_xprequant"]
            wmm = {ln: r for ln, r in rows.items()
                   if r["kernel"] in ("bfp_matmul_xprequant",
                                      "bfp_matmul_xwprequant")}
            oft = sum(r["ms"] for r in rows.values()
                      if r["kernel"].endswith("_oformat"))
            print(f"time chain {label}: {len(epi)} layers run the "
                  f"requantize epilogue, kernel "
                  f"{sum(r['ms'] for r in epi):.4f} ms, bound "
                  f"{sum(r['bound_ms'] for r in epi):.4f} ms (int8 mantissas "
                  f"and steps out; output format passes inside them "
                  f"{oft:.4f} ms); {len(wx)} wire-x convs with float "
                  f"weights {sum(r['ms'] for r in wx):.4f} ms, bound "
                  f"{sum(r['bound_ms'] for r in wx):.4f} ms; wire-format "
                  f"matmuls {'+'.join(wmm)} "
                  f"{sum(r['ms'] for r in wmm.values()):.4f} ms, bound "
                  f"{sum(r['bound_ms'] for r in wmm.values()):.4f} ms, "
                  f"core={'/'.join(r['core'] for r in wmm.values())}"
                  f"  [{card}]", flush=True)

    # -- 7. bfp_quantize: the offline block formatting -----------------------
    def q_input(m, k, bk):
        x = torch.randn((m, k), generator=gen)
        x[0, :bk] = 0.0                               # an all-zero block
        x[1, 3] = float("nan")                        # a NaN block
        x[2, k - 1] = float("inf")                    # an inf block
        x[3, :bk] = float("-inf")
        x[4] *= 1000.0
        return x.to(dev)

    def q_check(x, xref, qbk, bits, want_path, what):
        """The kernel on ``x`` against the plain version on ``xref`` (the
        same values), on the path the launch names for it."""
        got, want = KQ.bfp_quantize(x, bits=bits, bk=qbk), \
            KQ.bfp_quantize_plain(xref, bits, qbk)
        torch.cuda.synchronize()
        qpath = KQ.kernel_path(x, got[0], qbk)
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
        print(f"check bfp_quantize M,K={x.shape[0]},{x.shape[1]} bk={qbk} "
              f"L={bits} {what} path={qpath} torch.equal={equal} "
              f"max_abs_diff={err}", flush=True)
        check(qpath == want_path, f"bfp_quantize took the {qpath} path at "
                                  f"{what}, expected {want_path}")
        check(equal, f"bfp_quantize differs from its plain version at "
                     f"{(*x.shape, qbk, bits)} {what}")
        errs["bfp_quantize"] = max(errs.get("bfp_quantize", 0.0), err)

    for m_rows, k, qbk, bits in Q_SHAPES:
        x = q_input(m_rows, k, qbk)
        vec = k % 16 == 0 and qbk % 16 == 0 and qbk <= 512
        q_check(x, x, qbk, bits, "vector" if vec else "scalar",
                "(zero/NaN/inf blocks)")
    # x 4 bytes off 16-byte alignment (a contiguous view at an offset):
    # the scalar path, on a shape the vector path would otherwise take
    x = q_input(300, 1024, bk)
    xo = torch.zeros(x.numel() + 1, device=dev)[1:].view(x.shape)
    xo.copy_(x)
    check(xo.is_contiguous() and xo.data_ptr() % 16 == 4,
          "misaligned bfp_quantize input is not 4 bytes off")
    q_check(xo, x, bk, 8, "scalar", "(x 4 bytes off 16-byte alignment)")

    # ResNet-50 at published width, BN statistics from the seed; every
    # weight its plan prequantizes, formatted offline through
    # ops.bfp_quantize in the GEMM view [N, K] (the transposed [K, N])
    fmt_p = "resnet50_format"
    r50_params = with_bn_stats(MODELS["resnet50"].init(gen, reduced=False,
                                                       device=dev), gen)
    r50_plan = EG.bind(r50_params, pol, tree="cnn", strict=True)
    fmt_sites = [p for p, st in r50_plan.sites.items() if st.prequantized]

    def gemm_view_t(w):           # HWIO kernel or [K, N] -> [N, K]
        return (conv_weight_matrix(w) if w.ndim == 4 else w).t().contiguous()

    views = {p: gemm_view_t(weight_at(r50_params, p)) for p in fmt_sites}
    K.reset_launch_counts()
    formatted = {p: ops.bfp_quantize(views[p], 8, bk) for p in fmt_sites}
    torch.cuda.synchronize()
    launches[fmt_p] = K.launch_counts()
    want = {**dict.fromkeys(launches[fmt_p], 0), **FORMAT_LAUNCHES}
    print(f"path {fmt_p}: {len(fmt_sites)} weights formatted, launches "
          f"{ {k: v for k, v in launches[fmt_p].items() if v} }", flush=True)
    check(launches[fmt_p] == want,
          f"{fmt_p}: launches {launches[fmt_p]} != {want}")
    rows = detail["layers"][fmt_p] = {}
    for p in fmt_sites:
        m, e = formatted[p]
        pm, pe = KQ.bfp_quantize_plain(views[p], 8, bk)
        check(torch.equal(m, pm) and torch.equal(e, pe),
              f"{fmt_p} {p}: kernel != plain version")
        leaf = weight_at(r50_plan.params, p)
        lm = conv_weight_matrix(leaf["m"]) if leaf["m"].ndim == 4 \
            else leaf["m"]
        check(torch.equal(m.t(), lm) and
              torch.equal(pow2(e - (8 - 2)).t(), leaf["s"]),
              f"{fmt_p} {p}: formatted weight != the plan's sidecar")
        n, k = views[p].shape
        nbytes = 4 * n * k + n * k + 4 * e.numel()
        rows[p] = {"kernel": "bfp_quantize", "shape": [n, k],
                   "ms": cuda_ms(lambda: ops.bfp_quantize(views[p], 8, bk),
                                 reps=20),
                   "plain_ms": cuda_ms(lambda: KQ.bfp_quantize_plain(
                       views[p], 8, bk), reps=3),
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                   "bound_by": "bytes"}
    print(f"path {fmt_p}: every formatted weight torch.equal to its plain "
          f"version and to the plan's sidecar (m.T == m, "
          f"pow2(e - 6).T == s); kernel "
          f"{sum(r['ms'] for r in rows.values()):.4f} ms, plain "
          f"{sum(r['plain_ms'] for r in rows.values()):.4f} ms, bound "
          f"{sum(r['bound_ms'] for r in rows.values()):.4f} ms (bytes) "
          f"over the {len(rows)} weights  [{card}]", flush=True)

    # the 45 calls as one loop: CUDA events around it (the host's time
    # per call shows); then each call's device time from the profiler's
    # kernel events, on the vector path (the weights as bound) and on the
    # scalar path (copies of them 4 bytes off 16-byte alignment)
    def fmt_loop():
        for p in fmt_sites:
            ops.bfp_quantize(views[p], 8, bk)

    def device_us(xs, reps=5):
        """Median device time (us) of each call, over ``reps`` loops: the
        loops must launch one kernel a call and nothing else.  The
        profiler has been seen to drop one kernel event of 225: a capture
        short of events is taken again, up to ``PROFILE_TRIES`` times,
        and still fails the check if it never comes back whole."""
        for _ in range(PROFILE_TRIES):
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    for x in xs:
                        ops.bfp_quantize(x, 8, bk)
                torch.cuda.synchronize()
            ev = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
            if len(ev) == reps * len(xs):
                break
        check(len(ev) == reps * len(xs)
              and all("bfp_quantize" in e.name for e in ev),
              f"{fmt_p}: {len(ev)} device events for {reps * len(xs)} "
              f"calls: {sorted({e.name[:60] for e in ev})}")
        return [float(np.median([ev[r * len(xs) + i].time_range.elapsed_us()
                                 for r in range(reps)]))
                for i in range(len(xs))]

    loop_ms = cuda_ms(fmt_loop, reps=20)
    off = []
    for p in fmt_sites:
        xo = torch.zeros(views[p].numel() + 1, device=dev)[1:].view(
            views[p].shape)
        off.append(xo.copy_(views[p]))
    for x in (views[fmt_sites[0]], off[0]):
        got = ops.bfp_quantize(x, 8, bk)
        check(KQ.kernel_path(x, got[0], bk) == ("scalar" if x is off[0]
                                                 else "vector"),
              f"{fmt_p}: a weight took the wrong path")
    vec_us = device_us([views[p] for p in fmt_sites])
    sca_us = device_us(off)
    for p, v, sc in zip(fmt_sites, vec_us, sca_us):
        rows[p].update(device_us_vector=v, device_us_scalar=sc)
    big = max(fmt_sites, key=lambda p: views[p].numel())
    detail[fmt_p] = {"loop_ms": loop_ms, "device_ms": sum(vec_us) / 1e3,
                     "device_ms_scalar": sum(sca_us) / 1e3,
                     "vector_faster": sum(v < sc for v, sc in zip(vec_us,
                                                                  sca_us))}
    fd = detail[fmt_p]
    print(f"time {fmt_p}: loop of the {len(fmt_sites)} calls "
          f"{loop_ms:.4f} ms (CUDA events); device time (profiler, one "
          f"launch a call and nothing else) {fd['device_ms']:.4f} ms on the "
          f"vector path, {fd['device_ms_scalar']:.4f} ms on the scalar path "
          f"(x 4 bytes off alignment), the vector path faster for "
          f"{fd['vector_faster']} of {len(fmt_sites)} weights; calls "
          f"{min(vec_us):.2f}-{max(vec_us):.2f} us, the largest "
          f"{tuple(views[big].shape)} {rows[big]['device_us_vector']:.2f} "
          f"/ {rows[big]['device_us_scalar']:.2f} us; bound "
          f"{sum(r['bound_ms'] for r in rows.values()):.4f} ms  [{card}]",
          flush=True)

    # -- 8. ResNet-50, ResNet-18, GoogLeNet served at full width ------------
    def time_forward(plan, apply, imgs):
        fwd = plan.jit_forward(apply)
        xb = imgs[:8].to(dev)
        return cuda_ms(lambda: fwd(xb), reps=5)

    def time_serve(eng, imgs):
        reqs = [eng.submit(image=imgs[i]) for i in range(16)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        check(all(r.error is None for r in reqs), "timed serve run failed")
        return 16 / secs

    models = {}
    for label, name, params in (
            ("resnet50_full", "resnet50", r50_params),
            ("resnet18_full", "resnet18", None),
            ("googlenet_full", "googlenet", None)):
        if params is None:
            params = with_bn_stats(MODELS[name].init(gen, reduced=False,
                                                     device=dev), gen)
        apply = MODELS[name].apply
        hw = MODELS[name].input_shape(reduced=False)[0]
        mplan, meng, mimgs, launches[label], mpplan = serve(
            label, params, hw, MODEL_LAUNCHES[label], apply=apply)
        fms, rps = time_forward(mplan, apply, mimgs), time_serve(meng, mimgs)
        models[label] = {"params": params, "plan": mplan, "images": mimgs,
                         "apply": apply, "pplan": mpplan}
        detail[label] = {"forward_ms": fms, "serve_req_per_s": rps}
        print(f"time {label}: forward batch 8 {fms:.4f} ms, served 16 "
              f"requests at {rps:.2f} req/s  [{card}]", flush=True)

    # ResNet-50 layer by layer, each at its own input from one forward
    r50 = models["resnet50_full"]
    time_layers("resnet50_full", r50["plan"], r50["apply"], r50["images"])
    # GoogLeNet too: 40 of its 59 convs are inline (K not a block multiple)
    gn = models["googlenet_full"]
    time_layers("googlenet_full", gn["plan"], gn["apply"], gn["images"])
    # ... and by stage (blocks/<i> of stage s: cumulative depths)
    ends = np.cumsum(r50["params"]["meta"][1])
    stages = detail["resnet50_full"]["stages"] = {}
    for path, row in detail["layers"]["resnet50_full"].items():
        if row["kernel"] in FORMAT_PASSES:
            continue
        name = path.split("/")[0]
        if name == "blocks":
            name = "stage%d" % (1 + int(np.searchsorted(
                ends, int(path.split("/")[1]), side="right")))
        st = stages.setdefault(name, {"layers": 0, "mma": 0, "ms": 0.0,
                                      "plain_ms": 0.0, "bound_ms": 0.0})
        st["layers"] += 1
        st["mma"] += row["core"] == "mma"
        for key in ("ms", "plain_ms", "bound_ms"):
            st[key] += row[key]
    for name, st in stages.items():
        print(f"time stage resnet50_full {name:<6} {st['layers']} layers "
              f"({st['mma']} on the mma core) kernel {st['ms']:.4f} ms  "
              f"plain {st['plain_ms']:.4f} ms  bound {st['bound_ms']:.4f} ms"
              f"  [{card}]", flush=True)

    # one batch-8 forward under the profiler: device time by kernel
    # family and the device-busy share of the wall time (the rest is the
    # host: dispatch, wrappers, BN/add/ReLU launches)
    fwd50 = r50["plan"].jit_forward(r50["apply"])
    xb50 = r50["images"][:8].to(dev)
    fwd50(xb50)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            fwd50(xb50)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 3
    fam = {"mma core": 0.0, "format pass": 0.0, "patch format pass": 0.0,
           "tile kernel": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.self_device_time_total <= 0):
            continue        # device events only (host ops repeat them)
        key = ("mma core" if "conv_mma_kernel" in e.key else
               "format pass" if "xformat_kernel" in e.key else
               "patch format pass" if "pformat_kernel" in e.key else
               "tile kernel" if "bfp_tile_kernel" in e.key else "other")
        fam[key] += e.self_device_time_total / 1e3 / 3
    devt = sum(fam.values())
    detail["resnet50_full"]["profile"] = {"wall_ms": wall,
                                          "device_ms": devt, **fam}
    print(f"profile resnet50_full forward batch 8: wall {wall:.4f} ms, "
          f"device {devt:.4f} ms (busy {100 * devt / wall:.1f}%); device "
          f"ms by kernel: "
          f"{json.dumps({k: round(v, 4) for k, v in fam.items()})}  "
          f"[{card}]", flush=True)

    # A yardstick for the int dot alone, NOT the same function (no block
    # steps, no tile-ordered f32 sum) and never called by the port:
    # torch._int_mm on the im2col'd int8 operands of a stage-4 3x3 conv
    # (M, N, K = 392, 512, 4608), beside the mma core on the same
    # mantissas with their steps.
    x4 = rnd(8, 7, 7, 512, relu=True)
    d4 = prequant_conv_leaf(rnd(3, 3, 512, 512, scale=0.02), pol)
    xm4, xs4 = KC.bfp_conv2d_xformat(x4, l_i=8, bk=bk)
    a8 = im2col(xm4.float(), 3, 3, 1, "SAME")[0].to(torch.int8)
    b8 = conv_weight_matrix(d4["m"]).contiguous()
    got8 = torch._int_mm(a8, b8)
    check(torch.equal(got8.double(), a8.double() @ b8.double()),
          "torch._int_mm yardstick: wrong int dot")
    ym = {"shape": [392, 512, 4608],
          "int_mm_ms": cuda_ms(lambda: torch._int_mm(a8, b8), reps=20),
          "core_ms": cuda_ms(lambda: KC.bfp_conv2d_xwprequant(
              xm4, xs4, d4["m"], d4["s"], l_i=8, l_w=8, bk=bk), reps=20),
          "int8_ops_bound_ms": 2.0 * 392 * 512 * 4608 / INT8_OPS_PER_S
          * 1e3}
    detail["yardstick_int_mm"] = ym
    print(f"yardstick stage-4 3x3 M,N,K=392,512,4608: torch._int_mm "
          f"{ym['int_mm_ms']:.4f} ms (int dot only, not the same function,"
          f" never called by the port), mma core on the same mantissas "
          f"{ym['core_ms']:.4f} ms, int8 operations bound "
          f"{ym['int8_ops_bound_ms']:.4f} ms  [{card}]", flush=True)

    # -- 9. the paper's policy (EQ4, L=8) on the emulated datapath ----------
    # requested on the kernel backend, non-strict: every site warns once
    # and falls back to "emulated"; no kernel runs
    paper = PAPER_DEFAULT.with_(backend="pallas")
    for label, params, apply, imgs, kernel_ms in (
            ("vgg16_emulated", full_params, vgg.apply, images,
             detail["forward_ms"]),
            ("resnet18_emulated", models["resnet18_full"]["params"],
             models["resnet18_full"]["apply"],
             models["resnet18_full"]["images"],
             detail["resnet18_full"]["forward_ms"])):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eplan = EG.bind(params, paper, tree="cnn")
        n_warn = sum(issubclass(c.category, EG.BackendFallbackWarning)
                     for c in caught)
        check(all(st.backend.name == "emulated" and st.fallback
                  for st in eplan.sites.values())
              and n_warn == len(eplan.sites),
              f"{label}: {n_warn} fallback warnings for "
              f"{len(eplan.sites)} sites, backends "
              f"{ {st.backend.name for st in eplan.sites.values()} }")
        eeng = CnnServeEngine(None, apply, eplan, slots=8)
        reqs = [eeng.submit(image=imgs[i]) for i in range(16)]
        K.reset_launch_counts()
        eeng.run()
        torch.cuda.synchronize()
        launches[label] = K.launch_counts()
        check(not any(launches[label].values()),
              f"{label}: a kernel ran on the emulated path "
              f"{launches[label]}")
        check(eeng.stats["completed"] == 16 and eeng.stats["failed"] == 0
              and eeng.stats["float_retries"] == 0,
              f"{label}: serving stats {eeng.stats}")
        served = torch.from_numpy(np.stack([r.logits for r in reqs]))
        efwd = eplan.jit_forward(apply)
        direct = torch.cat([head_logits(efwd(imgs[i:i + 8].to(dev))).cpu()
                            for i in (0, 8)])
        check(torch.equal(served, direct) and
              bool(torch.isfinite(served).all()),
              f"{label}: served logits differ from a direct apply")
        # PAPER_DEFAULT names "emulated" itself: no downgrade, same logits
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            dplan = EG.bind(params, PAPER_DEFAULT, tree="cnn")
        check(torch.equal(head_logits(dplan.jit_forward(apply)(
            imgs[:8].to(dev))).cpu(), direct[:8]),
            f"{label}: PAPER_DEFAULT differs from the fallback plan")
        xb = imgs[:8].to(dev)
        ems = cuda_ms(lambda: efwd(xb), reps=2)
        detail[label] = {"forward_ms": ems, "kernel_forward_ms": kernel_ms,
                         "fallback_warnings": n_warn,
                         "sites": len(eplan.sites)}
        print(f"path {label}: {n_warn} fallback warnings, all "
              f"{len(eplan.sites)} sites emulated, no kernel launched, 16 "
              f"served logits bit-equal to direct apply; forward batch 8 "
              f"{ems:.4f} ms (TILED kernels: {kernel_ms:.4f} ms)  [{card}]",
              flush=True)

    # -- 10. the paper's Table 4 ---------------------------------------------
    table4_phase(dev, card, pol, full_params, images, r50_params,
                 models["resnet50_full"]["images"], gen, launches, detail)

    # -- 11. packed BFP artifacts end to end --------------------------------
    packed_phase(dev, card, pol, detail, full_params, images,
                 served_logits[full_p], launches[full_p],
                 models["resnet50_full"], served_logits["resnet50_full"])

    # -- 12. BFP training ----------------------------------------------------
    train_phase(dev, card, pol, detail, launches, full_params, gen)

    # -- 13. tuned serving, the precision search, open-loop load -----------
    t13 = time.perf_counter()
    tuned_phase(dev, card, pol, detail, launches, full_params, images,
                served_logits[full_p], launches[full_p], gen)
    precision_phase(dev, card, pol, detail, launches, full_params, images,
                    gen)
    load_phase(dev, card, detail, launches, models["resnet50_full"], gen)
    print(f"phase 13: {time.perf_counter() - t13:.1f} s", flush=True)

    # -- 14. the LM serving path ---------------------------------------------
    lm_phase(dev, card, detail, launches, args.seed)

    # -- 15. the recurrent LM families and the encoder-decoder -------------
    lm_recurrent_phase(dev, card, detail, launches, args.seed)

    # -- 16. LM training -----------------------------------------------------
    lm_train_phase(dev, card, detail, launches, args.seed)

    # -- 17. logical-axis sharding on a 1x1 mesh ---------------------------
    dist_phase(dev, card, detail, launches, args.seed, pol,
               models["resnet50_full"], served_logits["resnet50_full"],
               full_params)

    # -- 18. the dry run and the roofline ------------------------------------
    dryrun_phase(dev, card, detail, args.seed)

    # -- 19. results ---------------------------------------------------------
    kernels = []
    for name in SOURCES:
        path = next(p for p in launches if launches[p][name] > 0)
        rows = {ln: r for ln, r in detail["layers"][path].items()
                if r["kernel"] == name}
        bms = sum(r["bound_ms"] for r in rows.values())
        bytes_ms = sum(r["bound_ms"] for r in rows.values()
                       if r["bound_by"] == "bytes")
        src = SOURCES[name]
        if isinstance(src, dict):    # the core the path's layers ran on
            src = src["mma" if any(r.get("core") == "mma"
                                   for r in rows.values()) else "tile"]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "sources_by_core": (SOURCES[name]
                                if isinstance(SOURCES[name], dict)
                                else None),
            "replaces": REPLACES[name], "path": path,
            "launches": launches[path][name],
            "launches_by_path": {p: launches[p][name] for p in launches},
            "max_abs_err": errs[name],
            "ms": sum(r["ms"] for r in rows.values()),
            "plain_ms": sum(r["plain_ms"] for r in rows.values()),
            "bound_ms": bms,
            "bound_by": "bytes" if bytes_ms * 2 >= bms else "operations",
            "library_ms": None, "bit_exact": errs[name] == 0.0,
            "layers": sorted(rows)})
    print("kernels: " + "; ".join(
        f"{k['name']} path={k['path']} launches={k['launches_by_path']} "
        f"bit_exact={k['bit_exact']} ms/run={k['ms']:.4f}"
        for k in kernels) + f"  [{card}]")
    with open(args.out, "w") as f:
        json.dump({**detail, "kernels": kernels}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

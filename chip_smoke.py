#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--report PATH]

Phases, in order; any failure raises and the script exits nonzero:

1. the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` and print the compiler's report;
2. K1 (flash-attention forward) against its plain PyTorch version at the
   serve shape and at ragged / windowed / offset / fp32 variants and at
   head widths 120 (h2o-danube3-4b, window 4096) and 32 (the reduced
   configs) and at DeepSeek-V2's MLA widths, q/k 192 and v 128 (fp32,
   bf16, window, ragged) and (48, 32) (the narrow test variant, and the
   reduced config's absorbed route at one kv head), and its absorbed
   route's full width (576, 512) at one kv head (fp32 ragged q_offset,
   bf16 window; ``csrc/flash_attention_wide.cu``), timed (median and
   min-max of 20 cold-L2 samples) beside its plain version,
   ``scaled_dot_product_attention`` (the backend that served it printed,
   "no single call" where none takes the shape) and its bound, at hd 64,
   at danube's 1 x 6000, at arctic-480b's serve prefill, 4 x 2100 (hd
   128, a group of 7 query heads per kv head, a ragged last tile) and
   its 1 x 4096, at deepseek-v2-236b's prefill 4 x 4096 at (192,
   128), G 1, at whisper-small's 1 x 4096 (12 over 12 heads, G 1, hd 64)
   and at llava-next-mistral-7b's 2 x 5200 (G 4, hd 128, window 4096
   binding, a ragged last tile), and at deepseek's absorbed prefill 4 x
   4096 at (576, 512), G 128 (arctic's, deepseek's, deepseek's ragged
   4 x 2100, whisper's, llava's and the absorbed one each checked twice
   for the same bits; every (576, 512) case also with v as k's first 512
   columns, the absorbed route's form, which the timed absorbed row
   uses, the separate-v time beside it),
   then the kernel and sdpa once more after a ~0.5 ms device spin each
   (their device work alone, without the host work the device waits on);
   the HMMA and HGMMA (wgmma) instructions ``cuobjdump -sass`` finds in
   each K1 kernel (the bf16 ones run on tensor cores and must hold some;
   the wgmma ones, at (64, 64), (128, 128) and (576, 512), must hold
   HGMMA, no HMMA, and spill nothing) and K1's blocks per SM;
3. K5 (flash-decode, split across blocks, then combined) the same way
   at the contiguous-decode shape, at danube's (hd 120, window 4096) and
   at arctic's (B=4, KH=8, G=7, hd 128, the serve phase's cache of 2116
   positions at its first and last decode step's lengths, 2101 and
   2116, and a cache of 2128 at 2100), at whisper's (B=4, KH=12, G=1, hd
   64, a cache of 480 at 449 and 480) and at llava's (B=2, KH=8, G=4, hd
   128, window 4096, a cache of 5216 at 5201 and 5216),
   each case twice for the same bits; the split count and the blocks
   launched at each timed shape (at least one per SM), and the host work
   a call of K5's wrapper and of sdpa takes;
3a. K9 (the Mamba2 SSD scan) against its plain version at mamba2's
   serve shape (B=4, S=4096, H=64, P=64, N=128, bf16), zamba2's (N=64,
   B=1 x 3000), B=1 x 16384, a ragged 4 x 3000, the reduced fp32 shape
   (P=32, N=16, chunk 16) and prompts of 40, 70 and 100 tokens (the
   chunk is the prompt), each on the route ``ssd_scan.route`` gives (the
   bf16 shapes on the tensor-core route, whose entering states are also
   held against ``ssd_chunk_states_plain``); the three full-width shapes
   timed under both timers (events, and device-only) beside the plain
   version and the bound, with the tensor-core route's two kernels (K9s,
   K9y) timed alone and its own byte floor;
3b. K9b (the scan's backward) against ``ssd_scan_bwd_plain`` at
   mamba2's training shape (4 x 4096 bf16), zamba2's (N 64), a ragged 4 x
   3000, the reduced fp32 and bf16 shapes (P 32, N 16, chunk 16) and two
   with a nonzero final-state gradient (bf16 1 x 1000, fp32 full width),
   each called twice for the same bits; the two 4 x 4096 shapes timed
   under both timers beside the plain backward and the bound, one call's
   kernels profiled; the HMMA count of each K9b kernel (a tc-route kernel
   without any fails);
4. K1 with its logsumexp, K2 (dq; dk/dv) and K3 (fused backward; bf16
   on tensor cores) against their plain versions at the training shape
   (B=4, H=15, KH=5, S=4096, hd 64, bf16) and at ragged / window /
   q_offset / fp32-hd128 / bf16-hd128 / hd 120 window 4096 (bf16, fp32)
   / hd 32 variants, arctic's (B=4, H=56, KH=8, S=4096, hd 128) and
   MLA's (deepseek's micro-batch B=1, H=KH=128, S=4096 at (192, 128);
   fp32, window and ragged (192, 128); (48, 32) in bf16 and fp32 and at
   one kv head), whisper's (B=4, H=KH=12, S=4096, hd 64), llava's
   (B=4, H=32, KH=8, S=4096, hd 128, window 4096) and the absorbed MLA
   route's (B=1, H=128, KH=1, S=4096 at (576, 512); fp32 ragged with a
   q_offset; both also with v as k's first 512 columns), K3 against K2,
   K1-lse and K2 twice the same bits, and at (576, 512) in bf16 K3's dq
   (summed from the stored dS, no atomics) twice the same bits; the
   HMMA and HGMMA instructions ``cuobjdump -sass`` finds in the bf16 K1,
   K2 and K3 kernels of each compiled width pair (every one must hold
   some; the wgmma kernels HGMMA alone) and their blocks per SM, and the
   registers and spills ptxas reports for the (192, 128) and (576, 512)
   kernels (a spill fails);
   then
   timed at the training shape, at arctic's, deepseek's, whisper's and
   the absorbed route's (median
   and min-max
   of 10 cold-L2 samples) beside the plain versions, the forward and the
   backward (``torch.autograd.grad``) of one
   ``scaled_dot_product_attention`` call (with ``enable_gqa``, or on k
   and v expanded to the query heads where that form falls to the math
   backend: the memory-efficient one takes (576, 512)), and their bounds;
4a. K4f and K4b (the whole-sequence megakernels; bf16 on tensor cores)
   against their plain versions at the short-sequence training shape
   (B=64, H=15, KH=5, S=256, hd 64, bf16) and at ragged / window /
   q_offset / window + q_offset / G=1 / hd 128 / hd 120 / fp32
   variants; K4b deterministic and against K2 (same bits in bf16); K3
   fed K4f's lse; the HMMA instructions in the bf16 K4 kernels' SASS
   (a kernel without any fails) and their blocks per SM and waves at 320
   and 160 blocks; then timed (events and device-only) beside K1,
   K1-lse, K3 and the K2 pair at B=64 and B=32 x 256 (``MEGA_TIMED``:
   the entries of the planner's table ``autotune.MEGA_TIMINGS``, printed
   as such), and at B=64 beside the plain versions, one
   ``scaled_dot_product_attention`` forward and forward+backward, and
   their bounds;
5. the engine: ``repro_torch.launch.serve`` builds ServeEngine +
   ModelBackend for smollm-360m at full width (bf16, seeded random
   weights) and serves 12 Poisson requests with 2100-3000-token prompts
   twice — ample page pool, then a tight one that forces evictions
   through the spill file — and the two token streams must agree;
6. contiguous-cache serving: ``LanguageModel.prefill`` on 4 prompts of
   2560 tokens, then 32 ``decode_step``s;
6a. SSM serving: mamba2-1.3b at full width (48 layers, bf16) through
   ``LanguageModel.prefill`` on 4 x 4096 tokens (K9 once a layer, on
   its tensor-core route every time, as at 1 x 16384 and in 6b), 32
   ``decode_step``s, one 1 x 16384 prefill, and prefill(S) + decode
   against prefill(S + 1) (argmax agreement >= 0.95 in fp32; in bf16,
   as served, the largest logit difference <= 0.42), with the peak
   device memory of each prefill;
6b. hybrid serving: zamba2-1.2b at full width (38 Mamba layers, one
   shared attention block applied 6 times), prefill 1 x 3000 (K9 38
   times, K1 6 times), 16 decode steps (K5 6 times a step), the same
   consistency check;
6c. h2o-danube3-4b at full width (24 layers, hd 120, window 4096), bf16:
   prefill 1 x 6000 (24 K1), 16 contiguous decodes (24 K5 a step), both
   profiled, and 3 requests with 4200-5000-token prompts through
   ``ServeEngine``;
6d. one depth-cut danube train step (1 layer, full width, fp32, 1 x
   4352) on the card through K1-lse and K3, and through K2 in
   deterministic mode, against the CPU: loss and gradients;
7. a 2-layer full-width fp32 model on the card against the same weights
   on the CPU (plain versions), prefill plus 3 decode steps, then reduced
   fp32 mamba2 and zamba2 the same way (K9 at the reduced shape, at
   chunk 16 and at chunk 128 with a 70-token prompt);
8. training: ``repro_torch.launch.train`` trains smollm-360m at full
   width for 8 steps of 4 x 4096 tokens (bf16 compute, fp32 master
   weights, remat per layer); the cross entropy must fall, and K1 with
   lse must launch twice a layer and K3 once a layer per step; a
   ``torch.profiler`` breakdown of one step;
8a. short-sequence training: smollm-360m at full width with
   ``attn_flash_min_seq=128``, 8 steps of 64 x 256 tokens through the
   port's Trainer on the default plan, which must be what the planner's
   measured table says there, with exactly that route's launches a step
   (64 K4f-lse or K1-lse, 32 K4b or K3); the cross entropy must fall; a
   profiled step; then, on the same trainer, blocks of 4 steps on the
   other route (each pass flipped, forced by patching the planner's
   measured table in-process) and on the default route in turn, twice,
   each block's launches checked; both routes' step medians (each
   block's first step left out) and a profiled step of each printed;
8b. short-sequence serving: the same model in bf16, prefill 32 x 256 on
   the table's plan (32 K4f or K1 launches), 16 decode steps (K5),
   prefill(S) + decode against prefill(S + 1) (fp32 argmax agreement >=
   0.95, through K1; the bf16 logit gap printed), and the paged engine's
   plan (one request a prefill: K1);
8c. SSM training: ``repro_torch.launch.train`` trains mamba2-1.3b at
   full width (48 layers, bf16 compute, fp32 master weights, remat per
   layer) for 6 steps of 4 x 4096; the cross entropy must fall and each
   step launch K9 twice a layer and K9b once; step median, peak memory
   and a profiled step;
8d. hybrid training: zamba2-1.2b the same way, 10 steps of 4 x 4096: K9
   twice and K9b once a Mamba layer (38), K1-lse and K3 once per
   application of the shared attention block (6, outside remat as in the
   reference);
8e. one depth-cut mamba2 train step (2 layers, full width, fp32, 1 x
   1024) on the card (K9, K9b on the fp32 route) against the CPU's plain
   path: loss and every gradient;
8f. deterministic reruns: 2 steps of a depth-cut mamba2 (4 layers) and
   zamba2 (7 layers) at full width, 2 x 2560, each run twice: the final
   parameters must be the same bits (K2 for the shared attention);
9. restart in deterministic mode (K2 backward): 8 uninterrupted steps
   against a run that checkpoints at step 4 and fail-stops at 6, resumed
   from the checkpoint — the final parameters must be equal bit for bit;
10. serving from that checkpoint: prefill 2100 tokens (K1), 16 decode
    steps (K5);
11. one train step of a 2-layer full-width fp32 model on the card (K1
    with lse, K3) against the CPU's plain path: loss, grad norm and the
    updated parameters;
12. the §6.3 partition copy: K6, K7 and K8 against their plain versions
    bit for bit (K6: one 128 MiB range of 256 MiB buffers; K7: 4 MiB
    and exactly-16 MiB buffers, ragged and 64-range sets; K8: 256 MiB
    buffers, 64 ragged ranges and the hazard pattern; K7 and K8 on both
    routes of their range descriptor: a 64-range set by value and forced
    onto the card, a 256-range set past ``MAX_PARAM_RANGES`` on the
    card), timed beside their plain versions, ``Tensor.copy_`` (K6) and
    their bounds, each under both timers, with the wrapper's time and
    host µs and K7's one-row floor; then
    the paths: ``ops.partition_copy_bytes`` (K6) and a 64-partition §6
    program under ``Runtime(copy_backend="cuda")`` at 4 MiB (K7) and
    256 MiB (K8), equal to the numpy backend, one fused copy each, with
    the split of the fused copy into host→device, kernel and
    device→host; the overlapping-destination and read-after-write
    programs take no fused copy;
13. MoE serving: arctic-480b at full width (d_model 7168, all 128
    experts of width 4864, top-2, capacity factor 1.25, dense residual),
    depth cut from 35 to 2 layers, bf16 (~55 GB of weights, each expert
    bank filled in place): prefill 4 x 2100 (K1 twice), 16 decode steps
    (K5 twice a step), the prefill's drops, peak memory, prefill and
    decode profiled beside their bounds (every expert's weights are read
    by every step), and a second prefill the same bits;
14. MoE training: the Trainer as ``launch.train`` builds it for arctic
    (bf16 parameters, int8 AdamW moments) at full width with 2 layers
    and 32 experts, 6 steps of 4 x 4096 at lr 3e-4 (ce_loss falls, K1-lse 4 and K3 2
    a step, aux_loss and the drop gauges each step, the median beside
    its bound, peak memory, a profiled step), then 2 steps twice in
    deterministic mode (K2): the same bits;
15. MoE against the CPU: arctic at full width in fp32 with 1 layer and
    8 experts, 1 x 576 (the flash gate lowered to 512): the routing of
    every MoE call (a choice may differ only between probabilities
    within 1e-5), prefill and 4 decode
    logits, ``train_loss`` and every gradient on the card (K1, K5,
    K1-lse, K3) against the port's CPU path;
16. MLA serving: deepseek-v2-236b at full width (128 MLA heads of q/k
    128 + 64 and v 128 over a 512-wide kv latent, the dense first layer
    at d_ff 12288, all 160 experts of width 1536, top-6, 2 shared),
    depth cut from 60 to 3 layers (the dense one and 2 MoE layers), fp32
    master weights (~37 GB) cast to bf16 per layer: prefill 4 x 4096 (K1
    at (192, 128) three times), 16 decode steps in the latent space (torch
    ops), both profiled beside their bounds, the latent caches' layout,
    the prefill's drops, init and prefill peak memory, and prefill(S) +
    decode against prefill(S + 1) (1 x 2100, fp32 and bf16, at a capacity
    factor with no drops);
17. MLA training: the Trainer as ``launch.train`` builds it for
    deepseek (int8 AdamW moments, the config's 4 micro-batches a step) at
    full width with 2 layers (dense + 1 MoE) and 64 experts, 6 steps of
    4 x 4096 at lr 3e-4 (ce_loss falls; K1-lse 4 and K3 2 a micro-batch;
    peak memory, step median beside its bound, the AdamW share, a
    profiled step), then 2 steps twice in deterministic mode (K2): the
    same bits;
18. MLA against the CPU: deepseek at full width in fp32, dense + 1 MoE
    layer of 8 experts, 1 x 576 (the flash gate lowered to 512: the
    fp32 K1, K1-lse and K3 at (192, 128)): routing, prefill and 4 decode
    logits, loss and every gradient on the card against the port's CPU
    path;
18a. the absorbed MLA route at full width: one deepseek attention block
    (d_model 5120, q_lora_rank 1536, 128 heads, kv_lora_rank 512, q/k
    128 + 64, v 128; seeded weights, bf16) through
    ``attention.mla_prefill`` at 4 x 4096 (K1 at (576, 512) once, wall
    and device busy, the latent caches ``_mla_kv_latents``' bits) and
    ``mla_train`` forward and backward at 1 x 4096 (K1-lse and K3 once;
    again in deterministic mode: K2, every gradient within 2e-2 of its
    leaf's largest entry of K3's); then in fp32 at 1 x 2180 the absorbed
    route against the dense route (loss, every gradient, prefill output
    and caches; the route with the kernels' plain version in their place
    printed beside);
19. encoder-decoder serving: whisper-small at full width (12 encoder + 12
    decoder layers, 12 heads of 64, 278 M parameters), fp32 master
    weights cast to bf16 per layer, seeded weights and frames: prefill
    of a 4 x 448 prompt (its decoder context; the dense attention) over
    4 x 1504 frames, 32 decode steps (K5 12 times a step), both profiled
    beside their bounds, the caches' layout (self k / v head-major, cross
    k / v seq-major); a 1 x 4096 prefill (K1 12 times, G 1, hd 64),
    profiled; prefill(S) + decode against prefill(S + 1) (fp32 argmax
    agreement >= 0.95, bf16 gap reported);
20. encoder-decoder training: the Trainer as ``launch.train`` builds it,
    fed 4 x 1504 seeded frames a batch, 6 steps of 4 x 4096 decoder
    tokens (ce_loss falls; K1-lse 24 and K3 12 a step; step median
    beside its bound, peak memory, a profiled step), then 2 steps twice
    in deterministic mode (K2): the same bits;
21. whisper against the CPU: fp32, 2 encoder + 2 decoder layers at full
    width, 1 x 2304 decoder tokens over 1504 frames: prefill and one
    decode step's logits, loss and every gradient;
22. VLM serving: llava-next-mistral-7b at full width, all 32 layers
    (7.24 B parameters, fp32 master weights, 29 GB), seeded weights and
    patches: prefill 2 x (576 patches + 4624 text) (K1 32 times, the
    4096 window binding), 16 decode steps at ``cur_len`` 5200-5215 (K5
    32 times a step), both profiled beside their bounds, the caches'
    layout, and prefill(S) + decode against prefill(S + 1) with the
    patches in both (1 x 5200);
23. VLM training: 4 of llava's 32 layers at full width, 6 Trainer steps
    of 4 x (576 seeded patches + 3520 text) (ce_loss falls; K1-lse 8 and
    K3 4 a step; the ``tokens`` metric exactly 4 x 3520);
24. llava against the CPU: fp32, 1 layer at full width, 1 x (576 +
    1728): prefill and one decode step's logits, loss and every gradient;
24a. the port's four example scripts (``examples/torch_*.py``) in this
    process at the reference examples' sizes: the quickstart (its lines
    equal to its CPU run's; its one ``db_copy`` is a zero-copy partition,
    so no batch reaches K7 / K8), the wavefront pipeline (order and
    makespan equal to its CPU run's, pipeline output equal to the
    sequential stages bit for bit), serving reduced llama3.2-3b, mamba2
    and zamba2 (B 4, 24-token prompts, 12 tokens: K5 and K9 must launch)
    and training reduced llama 240 steps with a fail-stop at 150 and a
    restart from the last committed checkpoint (the final loss below the
    first); each one's wall, the serve tokens/s and the kernels each
    launched printed;
25. the mesh (2 ranks sharing one H100 over gloo: no time of it is a
    multi-card time): ``launch.mesh.spawn`` starts 2 rank processes on
    cuda:0 after the kernels are built here, mesh (1, 2) ("data",
    "model"); each collective the mesh paths use on CUDA tensors
    (all_reduce sum and max, all_gather_into_tensor, the list all_gather,
    reduce_scatter_tensor, all_to_all_single); at full-width shapes in
    bf16, each against the same call on one rank: head-parallel
    ``causal_attention`` at llama3.2-3b's 24 / 8 heads (4 x 4096, forward
    and backward: K1-lse and K3 on 12 / 4 local heads), context-parallel
    at smollm-360m's 15 / 5 heads (2 x 8192: K1-lse and K3 on stripes of
    4096 at q_offset 0 and 4096), the lse-combine decode at smollm's heads
    against an 8192-slot cache, the head-parallel decode (K5 on 4 local kv
    heads) at llama's and MLA's head-sharded decode at deepseek-v2's 128
    heads; two arctic-width MoE layers (32 experts, 16 a rank) through the
    a2a dispatch, forward and backward, against the no-mesh oracle with
    no drops; smollm-360m (MESH_SMOLLM_LAYERS = 4 of 32 layers, 2 x
    8192) and llama3.2-3b (4 of 28 layers, 4 x 4096) trained at full
    width through
    ``Trainer(mesh=...)`` (K1-lse twice and K3 once a layer a step on each
    rank), each with an fp32 depth-cut step held against one rank's (loss
    1e-3, parameters 3e-4), and two full-width mamba2-1.3b layers' fp32
    step (1 x 4096) the same way, a rank's B / C projection GEMM FLOPs
    exactly half of one rank's (each rank projects its stripe of the
    sequence); smollm's mesh-trained state (fp32 params, m
    and v) saved by its Trainer inside the last step on the §6
    sharded path by both ranks (no leaf gathered: ``host_gathers`` 0;
    sharded and replicated leaves both), resumed by a second
    ``Trainer(mesh=...)`` on the same directory (start step 2, each
    rank's shards bit for bit) and, in this process after the ranks
    exit, restored on one device with no mesh (each rank's ``shard_of``
    of every whole leaf hashes to what that rank held), with every wall
    printed; both served in fp32 under the mesh against one
    rank (smollm prefill 4 x 4608: K1 on stripes of 2304); then, in this
    process, the §6 ranges of a TP-sharded llama leaf through
    ``db_partition`` and one K7 fused copy that reassembles it from the
    two ranks' shards bit for bit, and K1-lse / K3 on a stripe and K5 on
    local kv heads timed with the card to themselves;
26. the "data" axis: 2 ranks on cuda:0 over gloo, mesh (2, 1): arctic at
    full width cut to 2 layers x 8 experts (bf16, int8 moments), 2 x
    4096 (each rank one row: K1-lse and K3 at 1 x 4096, G 7), a
    ``Trainer(mesh=...)`` step and a counted step held against the dry
    run's layout pass of ``MeshLayout((2, 1))`` (FLOPs, kernel FLOPs,
    every ``TRAFFIC`` kind, peak within 10 %), every FSDP leaf's gradient
    reduce-scattered once; then an fp32 step of 1 layer x 8 experts at
    capacity factor 1 (pairs drop) against one rank: drops equal,
    parameters 3e-4.

Phase 7 also runs a reduced fp32 smollm (head_dim 64,
``attn_flash_min_seq=32``, B 72 x S 96: B·KH = 144) on the forced K4
route (the CUDA-core fp32 K4) on the card against the CPU: prefill
logits through K4f and one step's gradients through K4f and K4b; and the reduced smollm as it is
(head_dim 32) through K1, K5, K1-lse and K3.

Counters on the kernel wrappers are zeroed just before each main-path
phase (5, 6, 6a, 6b, 6c, 6d, 8, 8a and its other route, 8b, 8c-8f, 9,
10, each path of 12, 13-24, each example of 24a, and in each rank each
part of 25 and 26)
and read just after: every kernel of the path must have launched (25's
and 26's counts are both ranks' sums).  The kernel line's
launches are those counts alone; the reduced model of phase 7 and the
fp32 consistency check of 8b keep theirs in their own results.  The line before the last is the kernel table as
JSON; the last line is ``{"ok": true, "device": {...}}``.  Exits nonzero
without a CUDA device or without the package beside it.  ``--report
PATH`` also writes every number of the run as JSON to PATH.
"""
import argparse
import contextlib
import dataclasses
import functools
import gc
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

# cuBLAS reads this when CUDA starts: the deterministic-restart phase
# needs it for torch.use_deterministic_algorithms(True)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import state_from_numpy  # noqa: E402
from repro_torch.data import SyntheticTokens  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import ops as kernel_ops  # noqa: E402
from repro_torch.kernels import partition_copy as pc  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels import counts as kcounts  # noqa: E402
from repro_torch.kernels.autotune import plan_copy_chunk  # noqa: E402
from repro_torch.core import NULL_GUID, Runtime, spawn_main  # noqa: E402
from repro_torch.launch import analysis  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import attention, blocks, moe  # noqa: E402
from repro_torch.models.model import LanguageModel  # noqa: E402
from repro_torch.optim import (OptimizerConfig, adamw_update,  # noqa: E402
                               init_opt_state)
from repro_torch.optim.adamw import iter_leaves  # noqa: E402
from repro_torch.train.steps import make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel, the
# dry run's roofline constants (launch.analysis)
PEAK_FLOPS = {torch.bfloat16: analysis.H100_BF16_FLOPS,
              torch.float32: analysis.H100_FP32_FLOPS}
PEAK_BYTES = analysis.H100_HBM_BYTES
# bf16 results of two fp32 computations that differ only in summation
# order and the final rounding: one bf16 ulp is 2^-8 of |x| <= ~4 here;
# fp32: summation order alone
TOL = {torch.bfloat16: (2e-2, 2e-3), torch.float32: (1e-4, 1e-5)}
# backward and lse, relative to the largest / mean |value| of the plain
# result (gradients grow with the sequence): bf16 outputs of fp32 sums
# round once (2^-9 relative, a quarter ulp on average), fp32 differ in
# summation order over up to 4096 terms
TOL_REL = {torch.bfloat16: (1e-2, 4e-3), torch.float32: (1e-4, 1e-5)}


def _randn(shape, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


# the timed attention shapes, bf16 (scripts/torch_attention_ab.py times
# the same): K1 (B, H, KH, S, hd, hd_v, window), K1-lse (B, H, KH, S, hd,
# hd_v; the second is phase_k4's training shape), K5 (B, KH, G, S, hd,
# cur_len, window).  deepseek: DeepSeek-V2's MLA heads, q/k 128 + 64 and
# v 128, 128 query heads over 128 kv heads (G 1), at the serve phase's
# prefill 4 x 4096 and one training micro-batch 1 x 4096.  whisper:
# whisper-small's decoder self-attention, 12 heads over 12 kv heads (G 1)
# of width 64, at its 1 x 4096 prefill, its 4 x 4096 train step and its
# decode cache of 448 + 32 positions; llava: llava-next-mistral-7b's (32
# over 8, hd 128, window 4096) at its serve prefill 2 x (576 + 4624),
# where the window binds, and its decode cache of 5200 + 16.
# mla_absorbed: deepseek-v2-236b's absorbed MLA route, one latent kv head
# of q/k 512 + 64 and v 512 for its 128 query heads (G 128, the (576,
# 512) pair), at the prefill 4 x 4096 and the micro-batch 1 x 4096
K1_TIMED = {"serve": (1, 15, 5, 3008, 64, 64, 0),
            "danube": (1, 32, 8, 6000, 120, 120, 4096),
            "arctic": (4, 56, 8, 2100, 128, 128, 0),
            "arctic_4096": (1, 56, 8, 4096, 128, 128, 0),
            "deepseek": (4, 128, 128, 4096, 192, 128, 0),
            "whisper": (1, 12, 12, 4096, 64, 64, 0),
            "llava": (2, 32, 8, 5200, 128, 128, 4096),
            "mla_absorbed": (4, 128, 1, 4096, 576, 512, 0)}
K1_LSE_TIMED = {"train": (4, 15, 5, 4096, 64, 64),
                "short": (64, 15, 5, 256, 64, 64),
                "arctic": (4, 56, 8, 4096, 128, 128),
                "deepseek": (1, 128, 128, 4096, 192, 128),
                "whisper": (4, 12, 12, 4096, 64, 64),
                "mla_absorbed": (1, 128, 1, 4096, 576, 512)}
K5_TIMED = {"smollm": (4, 5, 3, 2624, 64, 2600, 0),
            "danube": (1, 8, 4, 6016, 120, 6001, 4096),
            "arctic": (4, 8, 7, 2116, 128, 2116, 0),
            "arctic_2128": (4, 8, 7, 2128, 128, 2100, 0),
            "whisper": (4, 12, 1, 480, 64, 480, 0),
            "llava": (2, 8, 4, 5216, 128, 5216, 4096)}

# cycles the device spins before a call timed with ``spin`` (~0.5 ms)
SPIN_CYCLES = 1_000_000


def _time_stats(fn, reps, flush, spin=False):
    """Time of ``fn`` by CUDA events over ``reps`` calls, each after a
    write of a buffer larger than L2 so every call starts with a cold
    cache: {"median", "min", "max"} in ms.  The span from the start to
    the end event holds the call's device work and whatever of its host
    work the device waits on (the timer of every kernel row).  With
    ``spin`` the device first spins ~0.5 ms, so the host has enqueued the
    call before its start event runs: the device work alone (read beside
    :func:`_host_us` for a short kernel)."""
    for _ in range(2):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e in zip(starts, ends)]
    return {"median": float(np.median(ms)), "min": float(np.min(ms)),
            "max": float(np.max(ms))}


def _time_ms(fn, reps, flush):
    """Median of :func:`_time_stats`."""
    return _time_stats(fn, reps, flush)["median"]


def _host_us(fn, reps=100, batches=5):
    """Host µs per call of ``fn``, the calls enqueued behind a long device
    spin so that none waits on the device: the wrapper's own host work.
    Median over ``batches`` batches of ``reps`` calls."""
    fn()
    per = []
    for _ in range(batches):
        torch.cuda.synchronize()
        torch.cuda._sleep(100 * SPIN_CYCLES)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        per.append((time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    return float(np.median(per))


def _fmt(st):
    return f"{st['median']:.4f} ms ({st['min']:.4f}-{st['max']:.4f})"


def _sdpa_backend(fn):
    """The ATen op that served ``scaled_dot_product_attention`` in ``fn``
    (flash, efficient, cuDNN or math), from the profiler's op names."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    for backend in ("flash", "efficient", "cudnn"):
        if any(f"_scaled_dot_product_{backend}_attention" in n
               for n in names):
            return backend
    return "math" if any("attention_math" in n for n in names) else \
        "unknown: " + ", ".join(sorted(n for n in names if "dot_product" in n))


@functools.lru_cache(maxsize=None)
def _sass_text():
    """``cuobjdump -sass`` of the built library, dumped once a run."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([cuobjdump, "-sass", str(_build.library_path())],
                          capture_output=True, text=True, check=True).stdout


def _sass_counts(pattern):
    """Per kernel whose mangled name contains ``pattern``: the count of
    tensor-core (HMMA / HGMMA) instructions ``cuobjdump -sass`` finds in
    the built library."""
    return {name: sum(n) for name, n in _sass_ops(pattern).items()}


def _sass_ops(pattern):
    """Per kernel whose mangled name contains ``pattern``: its count of
    (HMMA, HGMMA) instructions, mma.sync's and wgmma's, in the built
    library's SASS."""
    ops, name = {}, None
    for line in _sass_text().splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            if pattern not in name:
                name = None
            else:
                ops[name] = [0, 0]
        elif name is not None:
            ops[name][0] += "HMMA" in line
            ops[name][1] += "HGMMA" in line
    return ops


# the wgmma kernels: the (576, 512) pair's (csrc/flash_attention_wide.cu;
# K1 with v apart and v k's prefix, dV, dK in 2 forms of v x dS on / off,
# K3's dq) and those of (64, 64) and (128, 128) in bf16
# (csrc/flash_attention_hopper.cu; K1 at each width, K2's dk/dv and K3 at
# each width)
WGMMA = {"flash_fwd_wide_tc_kernel": 2, "tc_bwd_dv_wide_kernel": 1,
         "tc_bwd_dk_wide_kernel": 4, "tc_bwd_dq_ds_wide_kernel": 1,
         "flash_fwd_hopper_kernel": 2, "tc_bwd_hopper_kernel": 4}


def _wgmma_check():
    """The HMMA and HGMMA counts of each wgmma kernel (one without HGMMA or
    with any HMMA fails) and its registers and spills from the build's
    ptxas report (a spill fails), printed."""
    ops, regs = {}, {}
    for pat, n in WGMMA.items():
        found = _sass_ops(pat)
        if len(found) != n:
            raise AssertionError(f"{pat}: {len(found)} kernels, want {n}")
        ops.update(found)
        regs.update(_ptxas_report((pat,)))
    for name, (hmma, hgmma) in ops.items():
        print(f"  SASS {name[-60:]}: {hmma} HMMA, {hgmma} HGMMA")
    for name, r in regs.items():
        print(f"  ptxas {name[-64:]}: {r.get('registers')} registers, "
              f"{r.get('spill_stores')} B spill stores, "
              f"{r.get('spill_loads')} B spill loads")
    if any(hmma or not hgmma for hmma, hgmma in ops.values()):
        raise AssertionError(f"wgmma kernels without HGMMA or with HMMA: "
                             f"{ops}")
    if len(regs) != len(ops) or any(r.get("spill_stores", 1) or r.get(
            "spill_loads", 1) for r in regs.values()):
        raise AssertionError(f"wgmma kernels spill: {regs}")
    return {"sass_hmma_hgmma": ops, "ptxas": regs}


def _hopper_ranges_check():
    """autotune's mirror of the wgmma kernels' tile ranges (the CPU tests'
    plans) against the .cu's own range functions, run on the host, for
    every q tile and kv block of 300 random shapes; the cases compared."""
    rng = np.random.RandomState(0)
    kv, qt, order = [], [], []
    for _ in range(300):
        sq, sk = (int(x) for x in rng.randint(1, 5000, size=2))
        q_offset, causal = int(rng.randint(0, 700)), int(rng.randint(2))
        window = int(rng.choice([0, 1, 100, 300, 4096]))
        kv += [(q0, sq, sk, q_offset, causal, window)
               for q0 in range(0, sq, autotune.HOPPER_Q_ROWS)]
        qt += [(k0, sq, sk, q_offset, causal, window)
               for k0 in range(0, sk, autotune.HOPPER_KV_ROWS)]
        order.append(sq)
    got_kv = [tuple(r) for r in fa.hopper_ranges("kv_tiles", kv)]
    got_qt = [tuple(r) for r in fa.hopper_ranges("q_tiles", qt)]
    bad = [c for c, g in zip(kv, got_kv) if g != autotune.hopper_kv_tiles(
        *c[:4], bool(c[4]), c[5])]
    bad += [c for c, g in zip(qt, got_qt) if g != autotune.hopper_q_tiles(
        *c[:4], bool(c[4]), c[5])]
    for sq in order:
        ny = -(-sq // autotune.HOPPER_Q_ROWS)
        got = fa.hopper_ranges("q_order", [(y, ny) for y in range(ny)])
        if tuple(got[:, 0]) != autotune.hopper_q_order(sq):
            bad.append(("q_order", sq))
    n = len(kv) + len(qt) + len(order)
    print(f"  wgmma tile ranges: autotune's mirror against the kernels' own "
          f"functions, {n} cases, {len(bad)} differ")
    if bad:
        raise AssertionError(f"autotune's hopper ranges differ from the "
                             f"kernels' at {bad[:5]}")
    return n


def _errors(got, want):
    d = (got.float() - want.float()).abs()
    return d.max().item(), d.mean().item()


def _check(name, got, want, dtype):
    mx, mean = _errors(got, want)
    lim_max, lim_mean = TOL[dtype]
    print(f"  {name}: max_abs_err {mx:.3e} mean_abs_err {mean:.3e} "
          f"(limits {lim_max:g}, {lim_mean:g})")
    if not (mx <= lim_max and mean <= lim_mean):
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return mx


def _check_rel(name, got, want, dtype):
    mx, mean = _errors(got, want)
    wa = want.float().abs()
    lim_max, lim_mean = TOL_REL[dtype]
    print(f"  {name}: max_abs_err {mx:.3e} mean_abs_err {mean:.3e} "
          f"(limits {lim_max:g} x max|want| {wa.max().item():.3g}, "
          f"{lim_mean:g} x mean|want| {wa.mean().item():.3g})")
    if not (mx <= lim_max * wa.max().item()
            and mean <= lim_mean * wa.mean().item()):
        raise AssertionError(f"{name}: kernel disagrees with plain version")
    return mx, mean


def _bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def _profile(fn, reps):
    """Host wall time and device kernel time per call of ``fn`` under
    ``torch.profiler`` (after one warm call), with the heaviest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3 / reps
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:6]
    return {"profiled_wall_ms": wall_ms,
            "device_busy_ms": busy_ms if busy_ms > 0 else None,
            "top_kernels": [[e.key[:70], e.self_device_time_total / 1e3 / reps,
                             e.count // reps] for e in top]}


def _print_profile(name, prof, wall_ms):
    """Idle share of the device over ``wall_ms``, a host wall time of the
    same call taken without the profiler where the caller has one."""
    busy = prof["device_busy_ms"]
    if busy is None:
        print(f"  profile {name}: device time not measured (no CUDA events)")
        return
    prof["idle_share"] = max(0.0, 1.0 - busy / wall_ms)
    print(f"  profile {name}: wall {wall_ms:.3f} ms, device busy {busy:.3f} ms,"
          f" idle share {prof['idle_share']:.3f}; top kernels "
          + "; ".join(f"{k} {t:.3f} ms x{c}" for k, t, c in prof["top_kernels"]))


# (query, key) pairs the mask keeps: the work this input needs; the
# kernels count their work from the same pairs (kernels.counts)
_live_pairs = kcounts.live_pairs


# ------------------------------------------------------------------- phases

def _window_mask(sq, sk, q_offset, window, device="cuda"):
    """The causal sliding-window mask as sdpa's boolean attn_mask (True:
    attend)."""
    rows = q_offset + torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    return (cols <= rows) & (rows - cols < window)


def _pair_name(hd, hd_v):
    """A compiled width pair's key in the printed tables: "hd64", "hd128",
    "hd192/128"."""
    return f"hd{hd}" if hd == hd_v else f"hd{hd}/{hd_v}"


def _sdpa_pick(q, k, v, do, kw):
    """(closure, backend) of the sdpa call that serves these tensors best,
    or (None, "no single call").  The ``enable_gqa`` form comes first.
    Where it raises or falls to the math backend and one kv head serves
    several query heads, the same function on k and v expanded to q's
    heads (views) is tried: the memory-efficient backend takes no
    ``enable_gqa`` but widths past flash's and cuDNN's (MLA's absorbed
    (576, 512)).  With ``do`` the closure is the backward alone:
    ``autograd.grad`` through a kept graph on copies of the tensors
    (nothing added into ``.grad``)."""
    forms = [("", lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, enable_gqa=True, **kw))]
    if k.shape[1] == 1 < q.shape[1]:
        forms.append((", kv expanded", lambda q, k, v:
                      F.scaled_dot_product_attention(
                          q, *(t.expand(-1, q.shape[1], -1, -1)
                               for t in (k, v)), **kw)))
    best = (None, "no single call")
    for form, attend in forms:
        try:
            if do is None:
                fn = (lambda attend=attend: attend(q, k, v))
                backend = _sdpa_backend(fn)
            else:
                leaves = [t.detach().clone().requires_grad_()
                          for t in (q, k, v)]
                backend = _sdpa_backend(lambda: torch.autograd.grad(
                    attend(*leaves), leaves, do))
                out = attend(*leaves)
                fn = (lambda out=out, leaves=leaves: torch.autograd.grad(
                    out, leaves, do, retain_graph=True))
        except RuntimeError as e:
            print(f"  sdpa{form} takes no call here: "
                  f"{str(e).splitlines()[0][:120]}")
            torch.cuda.empty_cache()
            continue
        print(f"  sdpa{form}{' backward' if do is not None else ''}: "
              f"{backend}")
        if best[0] is None or backend != "math":
            best = (fn, backend + form)
        if backend != "math":
            break
    torch.cuda.empty_cache()
    return best


def _sdpa_call(q, k, v, **kw):
    """(closure, backend) of one ``scaled_dot_product_attention`` call on
    these tensors, or (None, "no single call") where no backend takes
    them (see ``_sdpa_pick``)."""
    return _sdpa_pick(q, k, v, None, kw)


def _sdpa_backward(q, k, v, do, **kw):
    """(closure, backend) of the backward alone of one
    ``scaled_dot_product_attention`` call on copies of these tensors;
    the closure holds the graph (see ``_sdpa_pick``)."""
    return _sdpa_pick(q, k, v, do, kw)


def _ptxas_report(pattern):
    """{kernel: {"registers", "spill_stores", "spill_loads"}} from the
    build's ``-Xptxas -v`` report, for each kernel whose mangled name
    holds every piece of ``pattern`` (a tuple of substrings)."""
    out, name = {}, None
    for line in _build.log_path().read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1) if all(p in m.group(1) for p in pattern) \
                else None
            if name:
                out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name]["spill_stores"] = int(m.group(1))
            out[name]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


def _fwd_hmma():
    """The tensor-core instructions in each K1 kernel's SASS (every bf16
    one must hold some: mma.sync's HMMA at (192, 128), wgmma's HGMMA at
    the other pairs) and K1's blocks per SM, printed."""
    hmma = _sass_counts("flash_fwd")
    for name, n in hmma.items():
        print(f"  SASS {name[-60:]}: {n} HMMA/HGMMA instructions")
    tc = [n for name, n in hmma.items()
          if "tc_kernel" in name or "hopper_kernel" in name]
    # (192, 128) on mma.sync, (576, 512) twice (v apart, v k's prefix),
    # (64, 64) and (128, 128) on wgmma
    if len(tc) != 5 or min(tc) == 0:
        raise AssertionError(f"the bf16 K1 kernels: {hmma}")
    occupancy = {f"{_pair_name(hd, hd_v)} {dt}": fa.fwd_occupancy(hd, dt, hd_v)
                 for hd, hd_v in autotune.ATTN_PAIRS
                 for dt in (torch.bfloat16, torch.float32)}
    print(f"  K1 blocks per SM (occupancy calculator): {occupancy}")
    return hmma, occupancy


def phase_k1(flush):
    print("== K1 flash_attention: kernel vs plain version")
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # name, B, H, KH, Sq, Sk, hd, hd_v, dtype, window, q_offset
        ("serve 3008 bf16 causal", 1, 15, 5, 3008, 3008, 64, 64, bf, 0, 0),
        ("ragged Sk 3001", 1, 15, 5, 3001, 3001, 64, 64, bf, 0, 0),
        ("window 512", 1, 15, 5, 3008, 3008, 64, 64, bf, 512, 0),
        ("q_offset 1024", 1, 15, 5, 1984, 3008, 64, 64, bf, 0, 1024),
        ("fp32 hd128", 2, 8, 2, 1100, 1100, 128, 128, f32, 0, 0),
        ("danube hd120 window 4096", 1, 32, 8, 6000, 6000, 120, 120, bf,
         4096, 0),
        ("hd120 fp32 q_offset 512", 1, 8, 2, 1000, 1512, 120, 120, f32, 700,
         512),
        ("reduced hd32 bf16", 2, 4, 2, 600, 600, 32, 32, bf, 0, 0),
        ("reduced hd32 fp32 window 64", 2, 4, 2, 600, 600, 32, 32, f32, 64,
         0),
        ("mla (192, 128) fp32 ragged q_offset 100", 1, 8, 8, 700, 800, 192,
         128, f32, 0, 100),
        ("mla (192, 128) bf16 window 300", 1, 8, 8, 1000, 1000, 192, 128, bf,
         300, 0),
        ("mla narrow (48, 32) bf16 ragged 300", 2, 8, 8, 300, 300, 48, 32, bf,
         0, 0),
        ("mla narrow (48, 32) fp32", 2, 8, 8, 300, 300, 48, 32, f32, 0, 0),
        ("mla absorbed reduced (48, 32) bf16 KH 1", 2, 4, 1, 300, 300, 48,
         32, bf, 0, 0),
        ("mla absorbed (576, 512) fp32 ragged q_offset 143", 1, 16, 1, 257,
         400, 576, 512, f32, 0, 143),
        ("mla absorbed (576, 512) bf16 window 100", 1, 16, 1, 600, 600, 576,
         512, bf, 100, 0),
    ]
    # the worst error over every case, and over the (576, 512) ones alone
    worst = wide = 0.0
    for i, (name, b, h, kh, sq, sk, hd, hd_v, dt, win, off) in \
            enumerate(cases):
        q = _randn((b, h, sq, hd), dt, 10 * i)
        k = _randn((b, kh, sk, hd), dt, 10 * i + 1)
        v = _randn((b, kh, sk, hd_v), dt, 10 * i + 2)
        got = fa.flash_attention(q, k, v, off, causal=True, window=win)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, off, causal=True, window=win)
        err = _check(name, got, want, dt)
        worst = max(worst, err)
        if (hd, hd_v) == autotune.WIDE_PAIR:
            # the absorbed route's form: v is k's first 512 columns
            v = k[..., :hd_v]
            err = max(err, _check(
                f"{name}, v = k's first {hd_v} columns",
                fa.flash_attention(q, k, v, off, causal=True, window=win),
                fa.flash_attention_plain(q, k, v, off, causal=True,
                                         window=win), dt))
            worst = max(worst, err)
            wide = max(wide, err)

    def timed(b, h, kh, s, hd, hd_v, win, seed):
        dt = torch.bfloat16
        q, k, v = (_randn((b, h, s, hd), dt, seed),
                   _randn((b, kh, s, hd), dt, seed + 1),
                   _randn((b, kh, s, hd_v), dt, seed + 2))
        separate = None
        if (hd, hd_v) == autotune.WIDE_PAIR:
            # timed on the absorbed route's form (v k's first 512
            # columns), the separate v's time beside it
            separate = _time_stats(lambda: fa.flash_attention(q, k, v), 20,
                                   flush)
            v = k[..., :hd_v]
        kern = lambda: fa.flash_attention(q, k, v, window=win)  # noqa: E731
        st = _time_stats(kern, 20, flush)
        dev = _time_stats(kern, 20, flush, spin=True)
        plain_ms = _time_ms(lambda: fa.flash_attention_plain(
            q, k, v, window=win), 3, flush)
        if win:
            lib, lib_backend = _sdpa_call(
                q, k, v, attn_mask=_window_mask(s, s, 0, win))
        else:
            lib, lib_backend = _sdpa_call(q, k, v, is_causal=True)
        lib_st = lib_dev = None
        if lib is not None:
            lib_st = _time_stats(lib, 20, flush)
            lib_dev = _time_stats(lib, 20, flush, spin=True)
        # S over hd, P V over hd_v, per live pair; q, k, v read once, the
        # (B, H, S, hd_v) output written once (K1's own count)
        flops, nbytes = kcounts.attention_work(
            "k1", b, h, kh, s, s, hd, hd_v, 0, True, win, q.element_size())
        bound_ms, bound_by = _bound(flops, nbytes, dt)
        row = {"ms": st["median"], "ms_min": st["min"], "ms_max": st["max"],
               "plain_ms": plain_ms,
               "library_ms": lib_st and lib_st["median"],
               "library_min": lib_st and lib_st["min"],
               "library_max": lib_st and lib_st["max"],
               "library_backend": lib_backend,
               "bound_ms": bound_ms,
               "bound_by": bound_by, "gflop": flops / 1e9,
               "tflops": flops / st["median"] / 1e9, "device_ms": dev,
               "library_device_ms": lib_dev}
        if separate is not None:
            row["v_form"] = "k's first columns"
            row["separate_v_ms"] = separate
            print(f"  (576, 512) with v apart from k: {_fmt(separate)}")
        lib_txt = ("no single call" if lib is None else
                   f"{_fmt(lib_st)} [{row['library_backend']}]")
        print(f"  B={b} H={h} KH={kh} S={s} hd={hd} hd_v={hd_v} window "
              f"{win}: kernel {_fmt(st)}, plain {plain_ms:.4f} ms, sdpa "
              f"{lib_txt}, bound {bound_ms:.4f} ms ({bound_by}: "
              f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); after a "
              f"device spin: kernel {_fmt(dev)}, sdpa "
              f"{'-' if lib_dev is None else _fmt(lib_dev)}")
        return row

    # arctic-480b: hd 128, a group of 7 query heads per kv head (56 / 8),
    # at the serve prefill's 4 x 2100 (past the last whole tile) and at
    # 1 x 4096; deepseek-v2-236b's MLA heads (192, 128) at G 1, at its
    # serve prefill 4 x 4096 and at a ragged 4 x 2100; whisper's G 1 at hd
    # 64, 1 x 4096; llava's 2 x 5200 (81.25 tiles of 64 rows, the window
    # binding on the last 1104); deepseek's absorbed route (576, 512) at G
    # 128, its prefill 4 x 4096
    for shape, s_over in (("arctic", None), ("arctic_4096", None),
                          ("deepseek", None), ("deepseek", 2100),
                          ("whisper", None), ("llava", None),
                          ("mla_absorbed", None)):
        b, h, kh, s, hd, hd_v, win = K1_TIMED[shape]
        s = s_over or s
        dt = torch.bfloat16
        q, k, v = (_randn((b, h, s, hd), dt, 90),
                   _randn((b, kh, s, hd), dt, 91),
                   _randn((b, kh, s, hd_v), dt, 92))
        if shape == "mla_absorbed":   # the absorbed route's form
            v = k[..., :hd_v]
        got = fa.flash_attention(q, k, v, causal=True, window=win)
        again = fa.flash_attention(q, k, v, causal=True, window=win)
        torch.cuda.synchronize()
        what = (f"{shape} {b}x{s} ({hd}, {hd_v}) G{h // kh} bf16 causal"
                + (f" window {win}" if win else "")
                + (" v = k's prefix" if shape == "mla_absorbed" else ""))
        if not torch.equal(got, again):
            raise AssertionError(f"K1 {what}: two runs gave other bits")
        err = _check(f"{what} (twice the same bits)", got,
                     fa.flash_attention_plain(q, k, v, causal=True,
                                              window=win), dt)
        worst = max(worst, err)
        if shape == "mla_absorbed":
            wide = max(wide, err)
        del q, k, v, got, again
        torch.cuda.empty_cache()

    main = timed(*K1_TIMED["serve"], 0)
    danube = timed(*K1_TIMED["danube"], 40)
    arctic = timed(*K1_TIMED["arctic"], 90)
    arctic_4096 = timed(*K1_TIMED["arctic_4096"], 90)
    deepseek = timed(*K1_TIMED["deepseek"], 93)
    torch.cuda.empty_cache()
    whisper = timed(*K1_TIMED["whisper"], 94)
    llava = timed(*K1_TIMED["llava"], 95)
    torch.cuda.empty_cache()
    absorbed = timed(*K1_TIMED["mla_absorbed"], 96)
    torch.cuda.empty_cache()
    hmma, occupancy = _fwd_hmma()
    wgmma = _wgmma_check()
    wgmma["range_cases"] = _hopper_ranges_check()
    return {"name": "flash_attention (K1)", "route": "cuda", "wgmma": wgmma,
            "source": "src/repro_torch/kernels/csrc/flash_attention_hopper.cu",
            "sources": {"bf16 (64, 64), (128, 128)":
                        "src/repro_torch/kernels/csrc/flash_attention_hopper.cu",
                        "bf16 (192, 128), fp32":
                        "src/repro_torch/kernels/csrc/flash_attention.cu",
                        "(576, 512)":
                        "src/repro_torch/kernels/csrc/flash_attention_wide.cu"},
            "replaces": "src/repro/kernels/flash_attention.py:134",
            "max_abs_err": worst, **main, "bound_us": main["bound_ms"] * 1e3,
            "hmma": hmma, "blocks_per_sm": occupancy,
            "timed_shape": "B=1 H=15 KH=5 Sq=Sk=3008 hd=64 bf16 causal",
            "hd120": {**danube, "timed_shape": "B=1 H=32 KH=8 Sq=Sk=6000 "
                      "hd=120 bf16 causal window 4096 (h2o-danube3-4b)"},
            "arctic": {**arctic, "timed_shape": "B=4 H=56 KH=8 Sq=Sk=2100 "
                       "hd=128 bf16 causal (arctic-480b's prefill, G 7)"},
            "arctic_4096": {**arctic_4096, "timed_shape": "B=1 H=56 KH=8 "
                            "Sq=Sk=4096 hd=128 bf16 causal (arctic, G 7)"},
            "deepseek": {**deepseek, "timed_shape": "B=4 H=KH=128 Sq=Sk=4096 "
                         "hd=192 hd_v=128 bf16 causal (deepseek-v2-236b's "
                         "MLA prefill, G 1)"},
            "whisper": {**whisper, "timed_shape": "B=1 H=KH=12 Sq=Sk=4096 "
                        "hd=64 bf16 causal (whisper-small's 1 x 4096 "
                        "prefill, G 1)"},
            "llava": {**llava, "timed_shape": "B=2 H=32 KH=8 Sq=Sk=5200 "
                      "hd=128 bf16 causal window 4096 (llava-next-mistral-"
                      "7b's serve prefill, 576 patches + 4624 text)"},
            "mla_absorbed": {**absorbed, "max_abs_err": wide,
                             "timed_shape": "B=4 H=128 KH=1 Sq=Sk=4096 "
                             "hd=576 hd_v=512 bf16 causal (deepseek-v2-"
                             "236b's absorbed MLA route, G 128: its "
                             "prefill)"}}


def phase_k5(flush):
    print("== K5 flash_decode: kernel vs plain version")
    b, kh, g, s, hd, cur_main, win_main = K5_TIMED["smollm"]
    dt = torch.bfloat16
    q = _randn((b, kh, g, hd), dt, 100)
    kc, vc = _randn((b, kh, s, hd), dt, 101), _randn((b, kh, s, hd), dt, 102)
    worst = 0.0
    # cur s + 1: a decode past the cache end, the window counted from it
    for cur, win in ((2561, 0), (2561, 512), (2600, 0), (2600, 512),
                     (s + 1, 512)):
        cur_t = torch.full((1,), cur, dtype=torch.int32, device="cuda")
        got = fd.flash_decode(q, kc, vc, cur_t, window=win)
        again = fd.flash_decode(q, kc, vc, cur_t, window=win)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"K5 cur {cur}: two runs gave other bits")
        want = fd.flash_decode_plain(q, kc, vc, cur_t, window=win)
        worst = max(worst, _check(f"cur {cur} window {win}", got, want, dt))
    for name, (bb, kk, gg, ss, hh, dd, cur, win) in {
            "fp32 hd128 cur 641": (2, 2, 4, 700, 128, torch.float32, 641, 0),
            "danube hd120 bf16 cur 6001 window 4096":
                (1, 8, 4, 6016, 120, dt, 6001, 4096),
            "hd120 fp32 cur 5000 window 4096":
                (2, 2, 4, 5008, 120, torch.float32, 5000, 4096),
            "reduced hd32 bf16 cur 301": (2, 2, 2, 320, 32, dt, 301, 0),
            "reduced hd32 fp32 cur 300 window 16":
                (2, 2, 2, 320, 32, torch.float32, 300, 16)}.items():
        qx = _randn((bb, kk, gg, hh), dd, 103 + ss)
        kx, vx = (_randn((bb, kk, ss, hh), dd, 104 + ss),
                  _randn((bb, kk, ss, hh), dd, 105 + ss))
        cur_t = torch.full((1,), cur, dtype=torch.int32, device="cuda")
        got = fd.flash_decode(qx, kx, vx, cur_t, window=win)
        if not torch.equal(got, fd.flash_decode(qx, kx, vx, cur_t,
                                                window=win)):
            raise AssertionError(f"K5 {name}: two runs gave other bits")
        worst = max(worst, _check(
            name, got, fd.flash_decode_plain(qx, kx, vx, cur_t, window=win),
            dd))

    def timed(q, kc, vc, cur, win):
        b, kh, g, hd = q.shape
        cur_t = torch.full((1,), cur, dtype=torch.int32, device="cuda")
        kern = lambda: fd.flash_decode(q, kc, vc, cur_t,  # noqa: E731
                                       window=win)
        st = _time_stats(kern, 50, flush)
        dev = _time_stats(kern, 50, flush, spin=True)
        host_us = _host_us(kern)
        plain_ms = _time_ms(lambda: fd.flash_decode_plain(
            q, kc, vc, cur_t, window=win), 20, flush)
        lo = max(0, cur - win) if win else 0
        q4 = q.reshape(b, kh * g, 1, hd)
        k_live, v_live = kc[:, :, lo:cur], vc[:, :, lo:cur]
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, k_live, v_live, enable_gqa=True)
        lib_st = _time_stats(lib, 50, flush)
        lib_dev = _time_stats(lib, 50, flush, spin=True)
        lib_host_us = _host_us(lib)
        flops, nbytes = kcounts.decode_work(b, kh, g, cur - lo, hd,
                                            q.element_size())
        bound_ms, bound_by = _bound(flops, nbytes, q.dtype)
        splits = fd.flash_decode.last_splits    # of the timed launches
        blocks = b * kh * splits
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        row = {"ms": st["median"], "ms_min": st["min"], "ms_max": st["max"],
               "plain_ms": plain_ms, "library_ms": lib_st["median"],
               "library_min": lib_st["min"], "library_max": lib_st["max"],
               "library_backend": _sdpa_backend(lib), "bound_ms": bound_ms,
               "bound_by": bound_by, "splits": splits, "blocks": blocks,
               "device_ms": dev, "library_device_ms": lib_dev,
               "host_us": host_us, "library_host_us": lib_host_us}
        print(f"  B={b} KH={kh} G={g} hd={hd} cur {cur} window {win}: kernel "
              f"{_fmt(st)}, plain {plain_ms:.4f} ms, sdpa {_fmt(lib_st)} "
              f"[{row['library_backend']}], bound {bound_ms:.4f} ms "
              f"({bound_by}: {nbytes / 1e6:.2f} MB); {splits} splits, "
              f"{blocks} blocks on {sms} SMs; after a device spin: kernel "
              f"{_fmt(dev)}, sdpa {_fmt(lib_dev)}; host work a call: "
              f"kernel's wrapper {host_us:.1f} us, sdpa {lib_host_us:.1f} us")
        if blocks < sms:
            raise AssertionError(f"K5 launched {blocks} blocks on {sms} SMs")
        return row

    main = timed(q, kc, vc, cur_main, win_main)
    bd, khd, gd, sd, hdd, cur_d, win_d = K5_TIMED["danube"]
    qd = _randn((bd, khd, gd, hdd), dt, 110)
    kd, vd = (_randn((bd, khd, sd, hdd), dt, 111),
              _randn((bd, khd, sd, hdd), dt, 112))
    danube = timed(qd, kd, vd, cur_d, win_d)
    # arctic-480b: G 7 of K5's 8 rows per block, hd 128: the serve
    # phase's cache (prefill 2100 + 16 decodes) at its first and last
    # decode step's lengths, and a 2128-position cache at 2100; whisper's
    # G 1 at hd 64 (cache 448 + 32) and llava's G 4 at hd 128 with the
    # window binding (cache 5200 + 16), each at its first and last decode
    # step's lengths
    rows = {}
    for shape, curs in (("arctic", (K5_TIMED["arctic"][3] - 15,)),
                        ("arctic_2128", ()),
                        ("whisper", (K5_TIMED["whisper"][3] - 31,)),
                        ("llava", (K5_TIMED["llava"][3] - 15,))):
        ba, kha, ga, sa, hda, cur_a, win_a = K5_TIMED[shape]
        qa = _randn((ba, kha, ga, hda), dt, 120)
        ka, va = (_randn((ba, kha, sa, hda), dt, 121),
                  _randn((ba, kha, sa, hda), dt, 122))
        for cur in (*curs, cur_a):
            cur_t = torch.full((1,), cur, dtype=torch.int32, device="cuda")
            got = fd.flash_decode(qa, ka, va, cur_t, window=win_a)
            what = (f"{shape} hd{hda} G{ga} bf16 S {sa} cur {cur}"
                    + (f" window {win_a}" if win_a else ""))
            if not torch.equal(got, fd.flash_decode(qa, ka, va, cur_t,
                                                    window=win_a)):
                raise AssertionError(f"K5 {what}: two runs gave other bits")
            worst = max(worst, _check(
                f"{what} (twice the same bits)", got,
                fd.flash_decode_plain(qa, ka, va, cur_t, window=win_a), dt))
        rows[shape] = timed(qa, ka, va, cur_a, win_a)
    return {"name": "flash_decode (K5)", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:34",
            "max_abs_err": worst, **main, "bound_us": main["bound_ms"] * 1e3,
            "timed_shape": "B=4 KH=5 G=3 S=2624 cur=2600 hd=64 bf16",
            "hd120": {**danube, "timed_shape": "B=1 KH=8 G=4 S=6016 "
                      "cur=6001 hd=120 bf16 window 4096 (h2o-danube3-4b)"},
            "arctic": {**rows["arctic"], "timed_shape": "B=4 KH=8 G=7 "
                       "S=2116 cur=2116 hd=128 bf16 (arctic-480b's last "
                       "decode step)"},
            "arctic_2128": {**rows["arctic_2128"], "timed_shape": "B=4 "
                            "KH=8 G=7 S=2128 cur=2100 hd=128 bf16 "
                            "(arctic)"},
            "whisper": {**rows["whisper"], "timed_shape": "B=4 KH=12 G=1 "
                        "S=480 cur=480 hd=64 bf16 (whisper-small's last "
                        "decode step)"},
            "llava": {**rows["llava"], "timed_shape": "B=2 KH=8 G=4 "
                      "S=5216 cur=5216 hd=128 bf16 window 4096 (llava-next-"
                      "mistral-7b's last decode step)"}}


SERVE_ARGS = ["--arch", "smollm-360m", "--device", "cuda", "--requests", "12",
              "--rate", "200", "--prompt-len", "2100", "3000", "--gen", "16",
              "32", "--page-size", "64", "--max-pages", "48", "--b-cap", "8",
              "--seed", "0"]


def _engine_run(pool_pages, budget, profile=False, argv=SERVE_ARGS):
    args = serve_cli.parse_args(argv + ["--pool-pages", str(pool_pages),
                                        "--resident-budget", str(budget)])
    eng, reqs = serve_cli.build(args)
    bk = eng.backend
    walls = {"prefill": [], "decode": []}

    def timed(name, fn):
        def call(*a):
            t0 = time.perf_counter()
            out = fn(*a)      # returns host values: the device has finished
            walls[name].append(time.perf_counter() - t0)
            return out
        return call

    prefill, decode = bk.prefill, bk.decode_step
    bk.prefill = timed("prefill", prefill)
    bk.decode_step = timed("decode", decode)
    fa.flash_attention.launches = 0
    fd.flash_decode.launches = 0
    t0 = time.perf_counter()
    m = eng.run(reqs)
    wall = time.perf_counter() - t0
    k1 = fa.flash_attention.launches
    vocab = bk.model.cfg.vocab_size
    for r in reqs:
        if len(r.out) != r.gen or not all(0 <= t < vocab for t in r.out):
            raise AssertionError(f"request {r.rid}: {len(r.out)} of {r.gen} "
                                 f"tokens, or a token outside the vocabulary")
    n_pre = len(walls["prefill"])
    if k1 < bk.model.cfg.num_layers * n_pre:
        raise AssertionError(f"K1 launched {k1} times for {n_pre} prefills")
    toks = sum(r.gen for r in reqs)
    info = {"pool_pages": pool_pages, "resident_budget": budget,
            "wall_s": wall, "tokens": toks, "tok_per_s": toks / wall,
            "prefills": n_pre,
            "prompt_lens": [len(r.prompt) for r in reqs],
            "prefill_ms_mean": 1e3 * float(np.mean(walls["prefill"])),
            "prefill_ms_median": 1e3 * float(np.median(walls["prefill"])),
            "decode_steps": len(walls["decode"]),
            "decode_step_ms_mean": 1e3 * float(np.mean(walls["decode"])),
            "decode_step_ms_median": 1e3 * float(np.median(walls["decode"])),
            "evictions": m["evictions"], "resumes": m["resumes"],
            "spilled_objects": m["spilled_objects"], "k1_launches": k1,
            "k5_launches": fd.flash_decode.launches}
    print(f"  pool {pool_pages} budget {budget}: {toks} tokens in "
          f"{wall:.2f} s wall ({info['tok_per_s']:.1f} tok/s); prefill "
          f"{info['prefill_ms_mean']:.1f} ms/request (median "
          f"{info['prefill_ms_median']:.1f}); decode step "
          f"{info['decode_step_ms_mean']:.2f} ms (median "
          f"{info['decode_step_ms_median']:.2f}, {len(walls['decode'])} "
          f"steps); evictions {m['evictions']:.0f} resumes "
          f"{m['resumes']:.0f} spilled {m['spilled_objects']:.0f}; K1 "
          f"launches {k1}")
    if profile:   # one full-shape step of each kind; writes no live page
        req = dataclasses.replace(reqs[0], prompt=np.arange(3000) % 512,
                                  out=[])
        info["prefill_profile"] = _profile(lambda: prefill(0, req, []), 2)
        _print_profile("engine prefill (3000 tokens)", info["prefill_profile"],
                       info["prefill_profile"]["profiled_wall_ms"])
        info["decode_profile"] = _profile(lambda: decode(
            eng.page_table, eng.cur_lens, eng.active, eng.tokens, eng.rids), 3)
        _print_profile("engine paged decode step (B=8)",
                       info["decode_profile"], info["decode_step_ms_median"])
    outs = [list(r.out) for r in reqs]
    del eng, bk
    torch.cuda.empty_cache()
    return outs, info


def phase_engine():
    print("== engine: smollm-360m full width, bf16, 12 requests")
    ample, info_a = _engine_run(384, 0, profile=True)
    tight, info_t = _engine_run(120, 2)
    if not info_t["evictions"] > 0:
        raise AssertionError("the tight pool forced no eviction")
    if ample != tight:
        raise AssertionError("token streams differ through eviction")
    print("  token streams identical with and without eviction")
    return info_a, info_t


def phase_contiguous():
    print("== contiguous: prefill 4 x 2560, then 32 decode steps")
    cfg = dataclasses.replace(get_config("smollm-360m"), param_dtype="bfloat16")
    model = LanguageModel(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(1))
    b, s, steps = 4, 2560, 32
    gen = torch.Generator(device="cuda").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda")
    _zero_counts()
    prefill_ms, step_ms, cache, tok = _serve_run(model, params, tokens,
                                                 steps, cache_len=s + 64)
    k1, k5 = fa.flash_attention.launches, fd.flash_decode.launches
    if k1 != cfg.num_layers or k5 != cfg.num_layers * steps:
        raise AssertionError(f"K1 {k1} / K5 {k5} launches, want "
                             f"{cfg.num_layers} / {cfg.num_layers * steps}")
    print(f"  prefill {prefill_ms:.1f} ms (B=4 x 2560), decode step "
          f"{step_ms:.3f} ms (B=4, cache 2624); K1 launches {k1}, K5 "
          f"launches {k5}")
    prof = _profile(lambda: model.decode_step(params, cache, tok, s + steps), 3)
    _print_profile("contiguous decode step (B=4)", prof, step_ms)
    del model, params, cache
    torch.cuda.empty_cache()
    return {"prefill_ms": prefill_ms, "decode_step_ms": step_ms,
            "k1_launches": k1, "k5_launches": k5, "decode_profile": prof}


def phase_reference():
    print("== reference: 2-layer full-width fp32 smollm, reduced fp32 mamba2 "
          "and zamba2, card vs CPU plain path")
    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=2,
                              dtype="float32", param_dtype="float32")
    gpu, cpu = LanguageModel(cfg, device="cuda"), LanguageModel(cfg, "cpu")
    params = gpu.init(torch.Generator(device="cuda").manual_seed(3))
    params_cpu = _tree_to(params, "cpu")
    s = 2100                                   # > 2048: prefill runs K1
    rng = np.random.RandomState(4)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, s)))
    worst = 0.0
    fa.flash_attention.launches = 0
    fd.flash_decode.launches = 0
    lg, cg = gpu.prefill(params, {"tokens": tokens.cuda()})
    lc, cc = cpu.prefill(params_cpu, {"tokens": tokens})
    worst = max(worst, (lg.cpu() - lc).abs().max().item())
    cg, cc = gpu.alloc_cache(1, s + 3, init=cg), cpu.alloc_cache(1, s + 3, init=cc)
    for i in range(3):
        tok = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, 1)))
        lg, cg = gpu.decode_step(params, cg, tok.cuda(), s + i)
        lc, cc = cpu.decode_step(params_cpu, cc, tok, s + i)
        worst = max(worst, (lg.cpu() - lc).abs().max().item())
    if fa.flash_attention.launches != 2 or fd.flash_decode.launches != 6:
        raise AssertionError("the reference check did not run the kernels")
    print(f"  logits max_abs_err {worst:.3e} (limit 1e-3; fp32, logits O(1))")
    if not worst <= 1e-3:
        raise AssertionError("card and CPU disagree")
    return {"dense_max_abs_err": worst, **_ssm_reference(),
            "megakernels": _mega_reference(), "hd32": _reduced_reference()}


def _grads(model, params, batch, device):
    """(loss, gradients of every leaf) of ``model.train_loss``."""
    leaves = [x.requires_grad_() for _p, x in iter_leaves(params)]
    loss, _ = model.train_loss(params, {k: v.to(device)
                                        for k, v in batch.items()})
    return loss.item(), torch.autograd.grad(loss, leaves)


def _reduced_reference():
    """The reduced smollm as it is (head_dim 32, run by the kernels at
    their compiled width 64) with ``attn_flash_min_seq=32``, fp32, B 2 x
    S 96, on the card against the CPU's plain path: prefill logits (K1
    once a layer), two decode steps (K5), one ``train_loss`` and its
    gradients (K1-lse twice a layer, K3 once)."""
    print("  reduced fp32 smollm, hd 32, B 2 x S 96: K1 / K5 / K1-lse / K3, "
          "card vs CPU")
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              attn_flash_min_seq=32)
    gpu, cpu = LanguageModel(cfg, device="cuda"), LanguageModel(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(44))
    params_gpu = _tree_to(params, "cuda", copy=True)
    rng = np.random.RandomState(45)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 99)))
    batch = {"tokens": toks[:, :96], "targets": toks[:, 1:97]}
    _zero_counts()
    with torch.no_grad():
        lg, cg = gpu.prefill(params_gpu, {"tokens": batch["tokens"].cuda()})
        lc, cc = cpu.prefill(params, {"tokens": batch["tokens"]})
        err = (lg.cpu() - lc).abs().max().item()
        cg, cc = gpu.alloc_cache(2, 98, init=cg), cpu.alloc_cache(2, 98,
                                                                  init=cc)
        for i in range(2):
            tok = toks[:, 96 + i:97 + i]
            lg, cg = gpu.decode_step(params_gpu, cg, tok.cuda(), 96 + i)
            lc, cc = cpu.decode_step(params, cc, tok, 96 + i)
            err = max(err, (lg.cpu() - lc).abs().max().item())
    torch.cuda.synchronize()
    serve_counts = _counts()
    _zero_counts()
    loss_g, g_gpu = _grads(gpu, params_gpu, batch, "cuda")
    torch.cuda.synchronize()
    train_counts = _counts()
    loss_c, g_cpu = _grads(cpu, params, batch, "cpu")
    grad_err = max((a.cpu() - c).abs().max().item()
                   / max(c.abs().max().item(), 1e-30)
                   for a, c in zip(g_gpu, g_cpu))
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    layers = cfg.num_layers
    want_serve = {**{k: 0 for k in serve_counts}, "k1": layers,
                  "k5": 2 * layers}
    want_train = {**{k: 0 for k in train_counts}, "k1_lse": 2 * layers,
                  "k3": layers}
    print(f"  logits max_abs_err {err:.3e} (limit 1e-4; fp32, logits O(1)); "
          f"loss rel err {loss_err:.2e} (limit 1e-5), gradients "
          f"{grad_err:.2e} of each leaf's max (limit 1e-4); launches serve "
          f"{serve_counts}, train {train_counts}")
    if serve_counts != want_serve or train_counts != want_train:
        raise AssertionError(f"launches {serve_counts} / {train_counts}, "
                             f"want {want_serve} / {want_train}")
    if not (err <= 1e-4 and loss_err <= 1e-5 and grad_err <= 1e-4):
        raise AssertionError("head_dim 32: card and CPU disagree")
    return {"logits": err, "loss_rel": loss_err, "grad_rel": grad_err,
            "launches_serve": serve_counts, "launches_train": train_counts}


def _mega_reference():
    """A reduced fp32 smollm with head_dim 64 and ``attn_flash_min_seq=32``
    at B 72 x S 96 (B·KH = 144 blocks) on the forced K4 route, against
    the CPU's plain path: prefill logits (K4f once a layer), then one
    ``train_loss`` and its gradients (K4f with lse twice a layer under
    remat="layer", K4b once a layer, no K1/K2/K3)."""
    print("  reduced fp32 smollm, hd 64, B 72 x S 96: K4f / K4b, card vs CPU")
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              head_dim=64, attn_flash_min_seq=32)
    gpu, cpu = LanguageModel(cfg, device="cuda"), LanguageModel(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(42))
    params_gpu = _tree_to(params, "cuda", copy=True)
    rng = np.random.RandomState(43)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (72, 97)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    layers = cfg.num_layers
    with _k4_route(96, 64, 32, 72, cfg.num_kv_heads):
        _zero_counts()
        with torch.no_grad():
            lg, _ = gpu.prefill(params_gpu,
                                {"tokens": batch["tokens"].cuda()})
        torch.cuda.synchronize()
        serve_counts = _counts()
        _zero_counts()
        loss_g, g_gpu = _grads(gpu, params_gpu, batch, "cuda")
        torch.cuda.synchronize()
        train_counts = _counts()
    lc, _ = cpu.prefill(params, {"tokens": batch["tokens"]})
    logit_err = (lg.cpu() - lc).abs().max().item()
    loss_c, g_cpu = _grads(cpu, params, batch, "cpu")
    grad_err = max((a.cpu() - c).abs().max().item()
                   / max(c.abs().max().item(), 1e-30)
                   for a, c in zip(g_gpu, g_cpu))
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    want_serve = {**{k: 0 for k in serve_counts}, "k4f": layers}
    want_train = {**{k: 0 for k in train_counts}, "k4f": 2 * layers,
                  "k4f_lse": 2 * layers, "k4b": layers}
    print(f"  prefill logits max_abs_err {logit_err:.3e} (limit 1e-4; fp32, "
          f"logits O(1)); loss rel err {loss_err:.2e} (limit 1e-5), "
          f"gradients {grad_err:.2e} of each leaf's max (limit 1e-4: fp32 "
          f"in another summation order); launches prefill {serve_counts}, "
          f"train {train_counts}")
    if serve_counts != want_serve or train_counts != want_train:
        raise AssertionError(f"launches {serve_counts} / {train_counts}, "
                             f"want {want_serve} / {want_train}")
    if not (logit_err <= 1e-4 and loss_err <= 1e-5 and grad_err <= 1e-4):
        raise AssertionError("K4f / K4b: card and CPU disagree")
    return {"prefill_logits": logit_err, "loss_rel": loss_err,
            "grad_rel": grad_err, "launches_prefill": serve_counts,
            "launches_train": train_counts}


# ------------------------------------------------------------ danube

DANUBE = "h2o-danube-3-4b"
DANUBE_SERVE_ARGS = ["--arch", DANUBE, "--device", "cuda", "--requests", "3",
                     "--rate", "200", "--prompt-len", "4200", "5000",
                     "--gen", "8", "16", "--page-size", "64", "--max-pages",
                     "80", "--b-cap", "4", "--seed", "1"]


def phase_danube():
    """h2o-danube3-4b at full width (24 layers, d_model 3840, 32 heads over
    8 kv heads of width 120, sliding window 4096), bf16, seeded random
    weights: prefill 1 x 6000 through ``LanguageModel.prefill`` (24 K1,
    the window biting on rows past 4096), 16 contiguous decodes (24 K5 a
    step, the window active), each profiled; then a few requests with
    prompts of 4200-5000 tokens through ``ServeEngine``."""
    print("== danube: h2o-danube3-4b full width, bf16, prefill 1 x 6000, "
          "16 decodes, the paged engine")
    cfg = dataclasses.replace(get_config(DANUBE), param_dtype="bfloat16")
    if not (cfg.head_dim == 120 and cfg.sliding_window == 4096):
        raise AssertionError("the config is not danube's")
    model = LanguageModel(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(60))
    weights_gb = torch.cuda.memory_allocated() / 1e9
    b, s, steps = 1, 6000, 16
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(61))
    layers = cfg.num_layers
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        prefill_ms, step_ms, cache, tok = _serve_run(model, params, tokens,
                                                     steps)
        counts = _counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = {**{k: 0 for k in counts}, "k1": layers, "k5": layers * steps}
        print(f"  weights {weights_gb:.2f} GB; prefill {prefill_ms:.1f} ms "
              f"(B=1 x {s}, window {cfg.sliding_window}), decode step "
              f"{step_ms:.3f} ms (cache {s + steps}); launches {counts}; peak "
              f"device memory {peak_gb:.2f} GB")
        if counts != want:
            raise AssertionError(f"launches {counts}, want {want}")
        prof_pre = _profile(lambda: model.prefill(params, {"tokens": tokens}),
                            1)
        _print_profile(f"danube prefill (1 x {s})", prof_pre,
                       prof_pre["profiled_wall_ms"])
        prof_dec = _profile(lambda: model.decode_step(params, cache, tok,
                                                      s + steps - 1), 3)
        _print_profile("danube decode step (B=1)", prof_dec, step_ms)
    info = {"weights_gb": weights_gb, "prefill_ms": prefill_ms,
            "decode_step_ms": step_ms, "launches": counts,
            "peak_gb": peak_gb, "prefill_profile": prof_pre,
            "decode_profile": prof_dec}
    del model, params, cache, tokens
    torch.cuda.empty_cache()

    _, eng = _engine_run(240, 0, argv=DANUBE_SERVE_ARGS)
    info["engine"] = eng
    return info


def phase_danube_train():
    """One depth-cut train step of h2o-danube3-4b: 1 layer at full width,
    fp32, 1 x 4352 tokens (the 4096 window bites on the last 256 rows):
    loss and gradients on the card through K1-lse and K3, and in
    deterministic mode through K1-lse and K2, against the CPU's plain
    path from the same weights."""
    print("== danube train: 1 layer full width, fp32, 1 x 4352, card (K3; "
          "K2 in deterministic mode) vs CPU")
    cfg = dataclasses.replace(get_config(DANUBE), num_layers=1,
                              dtype="float32", param_dtype="float32")
    cpu = _cpu_model(cfg)
    params = cpu.init(torch.Generator().manual_seed(62))
    gpu = LanguageModel(cfg, "cuda")
    params_gpu = _tree_to(params, "cuda", copy=True)
    toks = np.random.RandomState(63).randint(0, cfg.vocab_size, (1, 4353))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(toks[:, 1:])}
    runs = {}
    for mode in ("default", "deterministic"):
        torch.use_deterministic_algorithms(mode == "deterministic")
        try:
            _zero_counts()
            t0 = time.perf_counter()
            loss, grads = _grads(gpu, params_gpu, batch, "cuda")
            torch.cuda.synchronize()
            runs[mode] = (loss, [g.cpu() for g in grads], _counts(),
                          time.perf_counter() - t0)
        finally:
            torch.use_deterministic_algorithms(False)
        del grads
    t0 = time.perf_counter()
    loss_c, g_cpu = _grads(cpu, params, batch, "cpu")
    cpu_s = time.perf_counter() - t0
    info = {"cpu_s": cpu_s}
    n = cfg.num_layers
    want = {"default": {"k1_lse": 2 * n, "k3": n},
            "deterministic": {"k1_lse": 2 * n, "k2_dq": n, "k2_dkv": n}}
    for mode, (loss, grads, counts, card_s) in runs.items():
        loss_err = abs(loss - loss_c) / abs(loss_c)
        grad_err = max((a - c).abs().max().item()
                       / max(c.abs().max().item(), 1e-30)
                       for a, c in zip(grads, g_cpu))
        print(f"  {mode}: loss {loss:.6f} vs CPU {loss_c:.6f} (rel err "
              f"{loss_err:.2e}, limit 1e-5), gradients {grad_err:.2e} of "
              f"each leaf's max (limit 1e-4: fp32 in another summation "
              f"order); launches {counts}; card {card_s:.1f} s, CPU "
              f"{cpu_s:.1f} s")
        if counts != {**{k: 0 for k in counts}, **want[mode]}:
            raise AssertionError(f"{mode}: launches {counts}")
        if not (loss_err <= 1e-5 and grad_err <= 1e-4):
            raise AssertionError(f"danube {mode}: card and CPU disagree")
        info[mode] = {"loss_rel_err": loss_err, "grad_rel_err": grad_err,
                      "launches": counts, "card_s": card_s}
    del gpu, params_gpu, runs
    torch.cuda.empty_cache()
    return info


# ------------------------------------------------------- training phases

COUNTERS = (fa.flash_attention, fa.flash_attention_fwd,
            fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv,
            fa.flash_attention_bwd_fused, fa.flash_attention_mega_fwd,
            fa.flash_attention_mega_bwd, fd.flash_decode, ssd.ssd_scan)


def _zero_counts():
    for fn in COUNTERS:
        fn.launches = 0
    fa.flash_attention_mega_fwd.lse_launches = 0
    ssd.ssd_scan.bwd_launches = 0
    ssd.ssd_scan.route_launches = {"tc": 0, "fp32": 0}


def _check_k9_routes(what, layers):
    """Every Mamba layer of the prefill just run took K9's tc route."""
    routes = dict(ssd.ssd_scan.route_launches)
    print(f"  {what}: K9 routes {routes} (want tc on all {layers} layers)")
    if routes != {"tc": layers, "fp32": 0}:
        raise AssertionError(f"{what}: K9 routes {routes}")
    return routes


def _counts():
    return {"k1": fa.flash_attention.launches,
            "k1_lse": fa.flash_attention_fwd.launches,
            "k2_dq": fa.flash_attention_bwd_dq.launches,
            "k2_dkv": fa.flash_attention_bwd_dkv.launches,
            "k3": fa.flash_attention_bwd_fused.launches,
            "k4f": fa.flash_attention_mega_fwd.launches,
            "k4f_lse": fa.flash_attention_mega_fwd.lse_launches,
            "k4b": fa.flash_attention_mega_bwd.launches,
            "k5": fd.flash_decode.launches,
            "k9": ssd.ssd_scan.launches,
            "k9b": ssd.ssd_scan.bwd_launches}


def phase_k_train(flush):
    """K1 with lse, K2 (dq, dk/dv) and K3 against their plain versions,
    then timed at the training shape; the tensor-core instructions and
    blocks per SM of the bf16 K2/K3."""
    print("== K1-lse, K2, K3: kernels vs plain versions")
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # name, B, H, KH, Sq, Sk, hd, hd_v, dtype, window, q_offset
        ("train 4x4096 bf16 causal", 4, 15, 5, 4096, 4096, 64, 64, bf, 0, 0),
        ("ragged 4097", 1, 15, 5, 4097, 4097, 64, 64, bf, 0, 0),
        ("window 512", 1, 15, 5, 4096, 4096, 64, 64, bf, 512, 0),
        ("q_offset 1024", 1, 15, 5, 3072, 4096, 64, 64, bf, 0, 1024),
        ("fp32 hd128", 2, 8, 2, 1100, 1100, 128, 128, f32, 0, 0),
        ("bf16 hd128 ragged 1100 q_offset 300", 2, 8, 2, 1100, 1400, 128,
         128, bf, 0, 300),
        ("danube hd120 window 4096, Sq 4352", 1, 32, 8, 4352, 4352, 120,
         120, bf, 4096, 0),
        ("hd120 fp32 window 4096, Sq 4352", 1, 8, 2, 4352, 4352, 120, 120,
         f32, 4096, 0),
        ("reduced hd32 bf16 ragged 601", 2, 4, 2, 601, 601, 32, 32, bf, 0,
         0),
        ("reduced hd32 fp32 window 64", 2, 4, 2, 600, 600, 32, 32, f32, 64,
         0),
        ("arctic hd128 G7 4x4096 bf16", 4, 56, 8, 4096, 4096, 128, 128, bf,
         0, 0),
        ("deepseek mla (192, 128) G1 1x4096 bf16", 1, 128, 128, 4096, 4096,
         192, 128, bf, 0, 0),
        ("mla (192, 128) fp32 ragged 1100 q_offset 200", 1, 16, 16, 1100,
         1300, 192, 128, f32, 0, 200),
        ("mla (192, 128) bf16 window 700 ragged 2000", 1, 16, 16, 2000,
         2000, 192, 128, bf, 700, 0),
        ("mla narrow (48, 32) bf16 ragged 601", 2, 8, 8, 601, 601, 48, 32,
         bf, 0, 0),
        ("mla narrow (48, 32) fp32 window 64", 2, 8, 8, 600, 600, 48, 32,
         f32, 64, 0),
        ("mla absorbed reduced (48, 32) bf16 KH 1", 2, 4, 1, 600, 600, 48,
         32, bf, 0, 0),
        ("whisper G1 hd64 4x4096 bf16", 4, 12, 12, 4096, 4096, 64, 64, bf,
         0, 0),
        ("llava G4 hd128 window 4096 4x4096 bf16", 4, 32, 8, 4096, 4096,
         128, 128, bf, 4096, 0),
        ("mla absorbed (576, 512) G128 1x4096 bf16", 1, 128, 1, 4096, 4096,
         576, 512, bf, 0, 0),
        ("mla absorbed (576, 512) fp32 ragged 1100 q_offset 200", 1, 16, 1,
         1100, 1300, 576, 512, f32, 0, 200),
        # the absorbed route's form: v is k's first 512 columns
        ("mla absorbed (576, 512) G128 1x4096 bf16, v = k's prefix", 1,
         128, 1, 4096, 4096, 576, 512, bf, 0, 0),
        ("mla absorbed (576, 512) bf16 window 100 ragged 1100 q_offset "
         "200, v = k's prefix", 1, 16, 1, 1100, 1300, 576, 512, bf, 100,
         200),
        ("mla absorbed (576, 512) fp32 ragged 1100 q_offset 200, v = k's "
         "prefix", 1, 16, 1, 1100, 1300, 576, 512, f32, 0, 200),
    ]
    # the worst errors over every case, and over the (576, 512) ones alone
    keys = ("k1_lse", "k2_dq", "k2_dkv", "k3")
    worst = {k: [0.0, 0.0] for k in keys}
    worst_wide = {k: [0.0, 0.0] for k in keys}
    wide = False

    def note(key, err):
        for w in (worst, worst_wide) if wide else (worst,):
            w[key] = [max(w[key][0], err[0]), max(w[key][1], err[1])]

    for i, (name, b, h, kh, sq, sk, hd, hd_v, dt, win, off) in \
            enumerate(cases):
        wide = (hd, hd_v) == autotune.WIDE_PAIR
        q = _randn((b, h, sq, hd), dt, 200 + 10 * i)
        k = _randn((b, kh, sk, hd), dt, 201 + 10 * i)
        v = (k[..., :hd_v] if name.endswith("v = k's prefix") else
             _randn((b, kh, sk, hd_v), dt, 202 + 10 * i))
        do = _randn((b, h, sq, hd_v), dt, 203 + 10 * i)
        kw = dict(causal=True, window=win)
        out, lse = fa.flash_attention_fwd(q, k, v, off, **kw)
        out2, lse2 = fa.flash_attention_fwd(q, k, v, off, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
            raise AssertionError(f"{name}: K1-lse run twice gave other bits")
        del out2, lse2
        want_o, want_lse = fa.flash_attention_plain(q, k, v, off,
                                                    with_lse=True, **kw)
        _check(f"{name} K1-lse out", out, want_o, dt)
        note("k1_lse", _errors(lse, want_lse))
        _check(f"{name} K1-lse lse", lse, want_lse, torch.float32)
        del want_o, want_lse
        delta = (do.float() * out.float()).sum(-1)
        dq2 = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, off, **kw)
        dk2, dv2 = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, off,
                                              **kw)
        dq3, dk3, dv3 = fa.flash_attention_bwd_fused(q, k, v, do, lse, delta,
                                                     off, **kw)
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, off,
                                            causal=True, window=win)
        note("k2_dq", _check_rel(f"{name} K2 dq", dq2, want[0], dt))
        e_k = _check_rel(f"{name} K2 dk", dk2, want[1], dt)
        e_v = _check_rel(f"{name} K2 dv", dv2, want[2], dt)
        note("k2_dkv", (max(e_k[0], e_v[0]), max(e_k[1], e_v[1])))
        e3 = [_check_rel(f"{name} K3 {n}", g, w, dt)
              for n, g, w in zip(("dq", "dk", "dv"), (dq3, dk3, dv3), want)]
        note("k3", (max(e[0] for e in e3), max(e[1] for e in e3)))
        # one code path for dk/dv; dq summed in another order (with
        # atomics, except at (576, 512) in bf16, from the stored dS)
        if not (torch.equal(dk2, dk3) and torch.equal(dv2, dv3)):
            raise AssertionError(f"{name}: K3 dk/dv differ from K2's")
        if wide and dt == bf:
            if not torch.equal(fa.flash_attention_bwd_fused(
                    q, k, v, do, lse, delta, off, **kw)[0], dq3):
                raise AssertionError(f"{name}: K3's dq run twice gave "
                                     "other bits")
            print(f"  {name}: K3's dq twice the same bits")
        again = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, off, **kw)
        if not (torch.equal(again, dq2) and all(torch.equal(a, c) for a, c in
                zip(fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, off,
                                               **kw), (dk2, dv2)))):
            raise AssertionError(f"{name}: K2 run twice gave other bits")
        d = (dq3.float() - dq2.float()).abs()
        lim = ((2.0 ** -7 if dt == torch.bfloat16 else 1e-5)
               * dq2.float().abs() + 1e-4 * dq2.float().abs().max())
        print(f"  {name} K3 vs K2: dk, dv bit-equal; K1-lse and K2 twice "
              f"the same bits; dq max_abs_diff {d.max().item():.3e} (limit 2^-7|dq| "
              f"+ 1e-4 max|dq| in bf16, 1e-5|dq| + 1e-4 max|dq| in fp32)")
        if (d > lim).any():
            raise AssertionError(f"{name}: K3 dq differs from K2's")
        del want, dq2, dk2, dv2, dq3, dk3, dv3, again
        torch.cuda.empty_cache()

    # the tensor cores: HMMA / HGMMA instructions in the bf16 kernels'
    # SASS, and the blocks per SM the occupancy calculator gives.  Every
    # bf16 backward kernel holds some: K2's dq on mma.sync at the first
    # three pairs (twice at (64, 64) and (128, 128): SAME and not), dk/dv
    # and K3 on mma.sync at (192, 128), on wgmma at (64, 64) and (128,
    # 128), the (576, 512) pair's seven
    hmma = {name: n for name, n in _sass_counts("tc_bwd").items()}
    for name, n in hmma.items():
        print(f"  SASS {name[-60:]}: {n} HMMA/HGMMA instructions")
    if len(hmma) != 18 or min(hmma.values()) == 0:
        raise AssertionError(f"the bf16 K2/K3 kernels: {hmma}")
    occupancy = {f"{w} {_pair_name(hd, hd_v)} {dt}":
                 fa.bwd_occupancy(w, hd, dt, hd_v)
                 for w in ("dq", "dkv", "fused")
                 for hd, hd_v in autotune.ATTN_PAIRS for dt in (bf, f32)}
    print(f"  blocks per SM (occupancy calculator): {occupancy}")
    fwd_hmma, fwd_occ = _fwd_hmma()
    # the compiled pairs MLA added, (192, 128) and the absorbed route's
    # (576, 512): registers and spills of each kernel, eight each
    mla_regs = {}
    for pair in ("192ELi128", "576ELi512"):
        regs = {}
        for kern in ("flash_fwd", "bwd_dq", "bwd_dkv"):
            regs.update(_ptxas_report((kern, pair)))
        for kname, r in regs.items():
            print(f"  ptxas {kname[-64:]}: {r.get('registers')} registers, "
                  f"{r.get('spill_stores')} B spill stores, "
                  f"{r.get('spill_loads')} B spill loads")
        # (576, 512): the fp32 kernels and K2's bf16 dq (the wgmma kernels
        # are phase_k1's _wgmma_check)
        if len(regs) != (8 if pair == "192ELi128" else 5):
            raise AssertionError(f"ptxas report for {pair}: {regs}")
        mla_regs[pair] = regs

    def occ(pair):
        return {"k1_lse": fwd_occ[f"{pair} {bf}"],
                **{key: occupancy[f"{w} {pair} {bf}"] for key, w in (
                    ("k2_dq", "dq"), ("k2_dkv", "dkv"), ("k3", "fused"))}}

    train = _k_train_times(K1_LSE_TIMED["train"], 300, flush, worst,
                           occ("hd64"))
    arctic = _k_train_times(K1_LSE_TIMED["arctic"], 320, flush, worst,
                            occ("hd128"))
    deepseek = _k_train_times(K1_LSE_TIMED["deepseek"], 340, flush, worst,
                              occ("hd192/128"))
    whisper = _k_train_times(K1_LSE_TIMED["whisper"], 360, flush, worst,
                             occ("hd64"))
    absorbed = _k_train_times(K1_LSE_TIMED["mla_absorbed"], 380, flush,
                              worst_wide, occ("hd576/512"), k_prefix=True)
    rows = train
    for key, other, shape in (
            ("arctic", arctic, "B=4 H=56 KH=8 S=4096 hd=128 bf16 causal "
             "(arctic-480b, G 7)"),
            ("deepseek", deepseek, "B=1 H=KH=128 S=4096 hd=192 hd_v=128 "
             "bf16 causal (deepseek-v2-236b's MLA, G 1: one micro-batch of "
             "its accumulated train step)"),
            ("whisper", whisper, "B=4 H=KH=12 S=4096 hd=64 bf16 causal "
             "(whisper-small's decoder self-attention, G 1: its train "
             "step)"),
            ("mla_absorbed", absorbed, "B=1 H=128 KH=1 S=4096 hd=576 "
             "hd_v=512 bf16 causal (deepseek-v2-236b's absorbed MLA route, "
             "G 128: one micro-batch)")):
        rows[key] = {k: other[k] for k in ("k1_lse", "k2_dq", "k2_dkv", "k3",
                                           "library_bwd", "library_backend")}
        rows[key]["timed_shape"] = shape
    rows["hmma"] = {**hmma, **fwd_hmma}
    rows["ptxas_192_128"] = mla_regs["192ELi128"]
    rows["ptxas_576_512"] = mla_regs["576ELi512"]
    rows["occupancy"] = {**occupancy, **{f"k1 {k}": n
                                         for k, n in fwd_occ.items()}}
    return rows


def _k_train_times(shape, seed, flush, worst, occ, k_prefix=False):
    """K1 with lse, the K2 pair and K3 timed at one training shape (bf16,
    causal; median and min-max of 10 cold-L2 samples) beside their plain
    versions, one ``scaled_dot_product_attention`` forward and its
    backward, and their bounds; K1-lse and sdpa's forward again after a
    device spin.  With ``k_prefix`` (the absorbed route's (576, 512)) the
    kernels are timed with v as k's first hd_v columns, the route's form,
    and each once more with v apart (``separate_v_ms``)."""
    (b, h, kh, s, hd, hd_v), dt = shape, torch.bfloat16
    q, k, v, do = (_randn((b, h, s, hd), dt, seed),
                   _randn((b, kh, s, hd), dt, seed + 1),
                   _randn((b, kh, s, hd_v), dt, seed + 2),
                   _randn((b, h, s, hd_v), dt, seed + 3))
    separate = {}
    if k_prefix:
        out, lse = fa.flash_attention_fwd(q, k, v)
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, do, lse, delta)
        separate = {
            "k1_lse": _time_stats(lambda: fa.flash_attention_fwd(q, k, v),
                                  10, flush),
            "k2_dq": _time_stats(lambda: fa.flash_attention_bwd_dq(*args),
                                 10, flush),
            "k2_dkv": _time_stats(lambda: fa.flash_attention_bwd_dkv(*args),
                                  10, flush),
            "k3": _time_stats(lambda: fa.flash_attention_bwd_fused(*args),
                              10, flush)}
        v = k[..., :hd_v]
    out, lse = fa.flash_attention_fwd(q, k, v)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta)
    st = {"k1_lse": _time_stats(lambda: fa.flash_attention_fwd(q, k, v), 10,
                                flush),
          "k2_dq": _time_stats(lambda: fa.flash_attention_bwd_dq(*args), 10,
                               flush),
          "k2_dkv": _time_stats(lambda: fa.flash_attention_bwd_dkv(*args), 10,
                                flush),
          "k3": _time_stats(lambda: fa.flash_attention_bwd_fused(*args), 10,
                            flush)}
    plain_fwd = _time_ms(lambda: fa.flash_attention_plain(
        q, k, v, with_lse=True), 3, flush)
    plain_bwd = _time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, out, lse, do), 3, flush)
    k1_dev = _time_stats(lambda: fa.flash_attention_fwd(q, k, v), 10, flush,
                         spin=True)
    lib_f, fwd_backend = _sdpa_call(q, k, v, is_causal=True)
    lib_fwd = lib_fwd_dev = lib_bwd = None
    if lib_f is not None:
        lib_fwd = _time_stats(lib_f, 10, flush)
        lib_fwd_dev = _time_stats(lib_f, 10, flush, spin=True)
    del lib_f
    lib_b, bwd_backend = _sdpa_backward(q, k, v, do, is_causal=True)
    if lib_b is not None:
        lib_bwd = _time_stats(lib_b, 10, flush)
    del lib_b
    torch.cuda.empty_cache()
    backend = {"forward": fwd_backend, "backward": bwd_backend}
    # FLOP per live pair: 2 x the width of each product (S and dK, dQ
    # over hd; dP, P V and dV over hd_v); bytes read once + written once
    work = {key: kcounts.attention_work(key, b, h, kh, s, s, hd, hd_v, 0,
                                        True, 0, q.element_size())
            for key in ("k1_lse", "k2_dq", "k2_dkv", "k3")}
    rows = {}
    names = {"k1_lse": "K1 with lse", "k2_dq": "K2 dq", "k2_dkv": "K2 dk/dv",
             "k3": "K3 fused"}
    print(f"  timed at B={b} H={h} KH={kh} S={s} hd={hd} hd_v={hd_v} bf16 "
          "causal:")
    for key, (flops, nbytes) in work.items():
        bound_ms, bound_by = _bound(flops, nbytes, dt)
        plain = plain_fwd if key == "k1_lse" else plain_bwd
        lib = lib_fwd if key == "k1_lse" else (lib_bwd if key == "k3"
                                               else None)
        rows[key] = {"ms": st[key]["median"], "ms_min": st[key]["min"],
                     "ms_max": st[key]["max"], "plain_ms": plain,
                     "library_ms": None if lib is None else lib["median"],
                     "library_backend": backend["forward" if key == "k1_lse"
                                                else "backward"],
                     "library_min": None if lib is None else lib["min"],
                     "library_max": None if lib is None else lib["max"],
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "max_abs_err": worst[key][0],
                     "mean_abs_err": worst[key][1],
                     "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
                     "tflops": flops / st[key]["median"] / 1e9,
                     "blocks_per_sm": occ[key]}
        if k_prefix:
            rows[key]["v_form"] = "k's first columns"
            rows[key]["separate_v_ms"] = separate[key]
        print(f"  {names[key]}: kernel {_fmt(st[key])}, plain {plain:.4f} "
              f"ms, library {'none' if lib is None else _fmt(lib)}, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.1f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB), {rows[key]['tflops']:.1f} TFLOP/s, "
              f"{occ[key]} blocks an SM")
    pair = st["k2_dq"]["median"] + st["k2_dkv"]["median"]
    if lib_fwd is not None or lib_bwd is not None:
        print(f"  sdpa forward [{backend['forward']}] "
              f"{'-' if lib_fwd is None else _fmt(lib_fwd)}; sdpa "
              f"backward via autograd.grad [{backend['backward']}] "
              f"{'-' if lib_bwd is None else _fmt(lib_bwd)}")
    if k_prefix:
        passes = autotune.wide_ds_passes(b * h, s, s, 0, True, 0)
        rows["k3"]["ds_workspace_bytes"] = (
            b * h * max(p[2] for p in passes) * autotune.WIDE_DS_PAIR_BYTES)
        rows["k3"]["ds_passes"] = len(passes)
        print("  with v apart from k: " + ", ".join(
            f"{names[key]} {_fmt(separate[key])}" for key in separate)
            + f"; K3's dS workspace {rows['k3']['ds_workspace_bytes']} B "
            f"in {len(passes)} pass(es)")
    print(f"  K2 pair {pair:.4f} ms, K3 {st['k3']['median']:.4f} ms; after "
          f"a device spin: K1 with lse {_fmt(k1_dev)}, sdpa forward "
          f"{'-' if lib_fwd_dev is None else _fmt(lib_fwd_dev)}")
    rows["k1_lse"]["device_ms"] = k1_dev
    rows["k1_lse"]["library_device_ms"] = lib_fwd_dev
    rows["library_bwd_ms"] = lib_bwd and lib_bwd["median"]
    rows["library_bwd"] = lib_bwd
    rows["library_backend"] = backend
    del q, k, v, do, out, lse, delta, args
    torch.cuda.empty_cache()
    return rows


def _mega_hmma():
    """The tensor-core instructions in each K4 kernel's SASS (the bf16
    ones must hold some; the fp32 strips hold none), printed."""
    hmma = _sass_counts("mega_")
    for name, n in hmma.items():
        print(f"  SASS {name[-60:]}: {n} HMMA/HGMMA instructions")
    tc = [n for name, n in hmma.items() if "tc_kernel" in name]
    if len(tc) != 4 or min(tc) == 0:
        raise AssertionError("the bf16 K4f / K4b kernels hold no HMMA")
    return hmma


# the shapes at which K4 is timed against the tiled kernels for the
# planner's table (autotune.MEGA_TIMINGS): smollm-360m's short training
# batch and its short-serve prefill, B x S with H=15, KH=5, hd 64, bf16
MEGA_TIMED = {"train": (64, 256), "serve": (32, 256)}


def _k4_inputs(b, s, seed):
    h, kh, hd, dt = 15, 5, 64, torch.bfloat16
    q, k, v, do = (_randn((b, h, s, hd), dt, seed),
                   _randn((b, kh, s, hd), dt, seed + 1),
                   _randn((b, kh, s, hd), dt, seed + 2),
                   _randn((b, h, s, hd), dt, seed + 3))
    out, lse = fa.flash_attention_mega_fwd(q, k, v, with_lse=True)
    return q, k, v, do, out, lse, (do.float() * out.float()).sum(-1)


def _k4_times(b, s, flush):
    """K4f, K4f-lse and K4b against K1, K1-lse, K3 and the K2 pair at
    (B, S), one process, median and spread of cold-L2 samples: under the
    events timer (every kernel row's) and after a device spin (the device
    work alone)."""
    q, k, v, do, out, lse, delta = _k4_inputs(b, s, 900 + b)
    args = (q, k, v, do, lse, delta)
    calls = {"k4f": (lambda: fa.flash_attention_mega_fwd(q, k, v), 20),
             "k4f_lse": (lambda: fa.flash_attention_mega_fwd(
                 q, k, v, with_lse=True), 20),
             "k4b": (lambda: fa.flash_attention_mega_bwd(*args), 10),
             "k1": (lambda: fa.flash_attention(q, k, v, block_q=64), 20),
             "k1_lse": (lambda: fa.flash_attention_fwd(q, k, v), 20),
             "k3": (lambda: fa.flash_attention_bwd_fused(*args), 10),
             "k2": (lambda: (fa.flash_attention_bwd_dq(*args),
                             fa.flash_attention_bwd_dkv(*args)), 10)}
    st = {key: _time_stats(fn, reps, flush)
          for key, (fn, reps) in calls.items()}
    dev = {key: _time_stats(calls[key][0], calls[key][1], flush, spin=True)
           for key in ("k4f", "k4f_lse", "k4b", "k1", "k1_lse", "k3")}
    host = {key: _host_us(calls[key][0])
            for key in ("k4f_lse", "k4b", "k1_lse", "k3")}
    print(f"  B={b} S={s}: K4f {_fmt(st['k4f'])}, K4f-lse "
          f"{_fmt(st['k4f_lse'])} against K1 {_fmt(st['k1'])}, K1-lse "
          f"{_fmt(st['k1_lse'])}; K4b {_fmt(st['k4b'])} against K3 "
          f"{_fmt(st['k3'])}, K2 pair {_fmt(st['k2'])}; device only: "
          + ", ".join(f"{k} {_fmt(v)}" for k, v in dev.items())
          + "; host us a wrapper call: "
          + ", ".join(f"{k} {v:.1f}" for k, v in host.items()))
    return q, k, v, do, out, lse, args, st, dev, host


def phase_k4(flush):
    """K4f (with and without lse) and K4b against their plain versions,
    K4b's determinism and agreement with K2, K3 fed K4f's lse, the HMMA
    count of the bf16 kernels and their blocks per SM, then K4f, K4f-lse
    and K4b timed beside K1, K1-lse, K3 and the K2 pair at the two
    MEGA_TIMED shapes: the numbers of the planner's table."""
    print("== K4f, K4b: whole-sequence kernels vs plain versions")
    bf, f32 = torch.bfloat16, torch.float32
    cases = [  # name, B, H, KH, Sq, Sk, hd, dtype, window, q_offset
        ("train 64x256 bf16 causal", 64, 15, 5, 256, 256, 64, bf, 0, 0),
        ("ragged S 200", 64, 15, 5, 200, 200, 64, bf, 0, 0),
        ("ragged S 100", 64, 15, 5, 100, 100, 64, bf, 0, 0),
        ("window 64", 64, 15, 5, 256, 256, 64, bf, 64, 0),
        ("q_offset 128, Sq 256, Sk 384", 32, 15, 5, 256, 384, 64, bf, 0, 128),
        ("q_offset 64, Sq 192, Sk 256", 32, 15, 5, 192, 256, 64, bf, 0, 64),
        ("window 96 + q_offset 128, Sk 384", 64, 15, 5, 256, 384, 64, bf, 96,
         128),
        ("G = 1", 32, 5, 5, 256, 256, 64, bf, 0, 0),
        ("hd 128 at S 256", 32, 15, 5, 256, 256, 128, bf, 0, 0),
        ("hd 120 at S 256 (width 128)", 32, 32, 8, 256, 256, 120, bf, 0, 0),
        ("fp32 S 128", 32, 15, 5, 128, 128, 64, f32, 0, 0),
    ]
    worst = {k: [0.0, 0.0] for k in ("k4f", "k4f_lse", "k4b")}

    def note(key, err):
        worst[key] = [max(worst[key][0], err[0]), max(worst[key][1], err[1])]

    for i, (name, b, h, kh, sq, sk, hd, dt, win, off) in enumerate(cases):
        q = _randn((b, h, sq, hd), dt, 700 + 10 * i)
        k = _randn((b, kh, sk, hd), dt, 701 + 10 * i)
        v = _randn((b, kh, sk, hd), dt, 702 + 10 * i)
        do = _randn((b, h, sq, hd), dt, 703 + 10 * i)
        kw = dict(causal=True, window=win)
        out = fa.flash_attention_mega_fwd(q, k, v, off, **kw)
        out_l, lse = fa.flash_attention_mega_fwd(q, k, v, off, with_lse=True,
                                                 **kw)
        torch.cuda.synchronize()
        want_o, want_lse = fa.flash_attention_plain(q, k, v, off,
                                                    with_lse=True, **kw)
        note("k4f", (_check(f"{name} K4f out", out, want_o, dt), 0.0))
        note("k4f_lse", (_check(f"{name} K4f-lse out", out_l, want_o, dt),
                         0.0))
        note("k4f_lse", _errors(lse, want_lse))
        _check(f"{name} K4f-lse lse", lse, want_lse, torch.float32)
        rows = autotune.mega_rows(True, sk, hd, q.element_size())
        if rows == 0:
            print(f"  {name}: K4b not run — its block does not fit at Sk "
                  f"{sk}, hd {hd}, {dt} (the planner's gate)")
            continue
        delta = (do.float() * out_l.float()).sum(-1)
        got = fa.flash_attention_mega_bwd(q, k, v, do, lse, delta, off, **kw)
        torch.cuda.synchronize()
        want = fa.flash_attention_bwd_plain(q, k, v, out_l, lse, do, off,
                                            causal=True, window=win)
        unit = f"{rows}-row strips" if dt == f32 else "64-row tiles"
        errs = [_check_rel(f"{name} K4b {n} ({unit})", g, w, dt)
                for n, g, w in zip(("dq", "dk", "dv"), got, want)]
        note("k4b", (max(e[0] for e in errs), max(e[1] for e in errs)))
        del got, want, out, out_l, want_o
        torch.cuda.empty_cache()

    # the training shape: determinism, K2, K3 fed K4f's lse
    b, h, kh, s, hd, dt = 64, 15, 5, 256, 64, bf
    q, k, v, do, out, lse, delta = _k4_inputs(b, s, 800)
    args = (q, k, v, do, lse, delta)
    first, second = fa.flash_attention_mega_bwd(*args), \
        fa.flash_attention_mega_bwd(*args)
    same = all(torch.equal(a, c) for a, c in zip(first, second))
    print(f"  K4b run twice on the same inputs: same bits {same}")
    if not same:
        raise AssertionError("K4b is not deterministic")
    ref2 = (fa.flash_attention_bwd_dq(*args),
            *fa.flash_attention_bwd_dkv(*args))
    same_as_k2 = {}
    for n, a, c in zip(("dq", "dk", "dv"), first, ref2):
        d = (a.float() - c.float()).abs()
        lim = 2.0 ** -7 * c.float().abs() + 1e-4 * c.float().abs().max()
        same_as_k2[n] = torch.equal(a, c)
        print(f"  K4b vs K2 {n}: same bits {same_as_k2[n]}, max_abs_diff "
              f"{d.max().item():.3e} (limit 2^-7|x| + 1e-4 max|x|: one bf16 "
              f"rounding of two fp32 sums)")
        if (d > lim).any():
            raise AssertionError(f"K4b {n} differs from K2's")
    qf, kf, vf, dof = (x.float() for x in (q[:32, :, :128], k[:32, :, :128],
                                           v[:32, :, :128], do[:32, :, :128]))
    qf, kf, vf, dof = (x.contiguous() for x in (qf, kf, vf, dof))
    of, lsef = fa.flash_attention_mega_fwd(qf, kf, vf, with_lse=True)
    argsf = (qf, kf, vf, dof, lsef, (dof * of).sum(-1))
    for n, a, c in zip(("dq", "dk", "dv"), fa.flash_attention_mega_bwd(*argsf),
                       (fa.flash_attention_bwd_dq(*argsf),
                        *fa.flash_attention_bwd_dkv(*argsf))):
        d = (a - c).abs()
        print(f"  K4b vs K2 {n}, fp32 32x128: max_abs_diff "
              f"{d.max().item():.3e} (limit 1e-5|x| + 1e-5 max|x|: fp32 "
              f"summation order)")
        if (d > 1e-5 * c.abs() + 1e-5 * c.abs().max()).any():
            raise AssertionError(f"K4b {n} differs from K2's in fp32")
    _, lse1 = fa.flash_attention_fwd(q, k, v)
    _check("K4f lse vs K1-lse lse (one convention)", lse, lse1, torch.float32)
    dq3, dk3, dv3 = fa.flash_attention_bwd_fused(*args)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do)
    for n, g, w in zip(("dq", "dk", "dv"), (dq3, dk3, dv3), want):
        _check_rel(f"mixed plan: K3 {n} from K4f's lse", g, w, dt)
    del first, second, ref2, dq3, dk3, dv3, want, qf, kf, vf, dof, of, lsef
    del q, k, v, do, out, lse, delta, args
    torch.cuda.empty_cache()

    # the tensor cores, and the blocks an SM at the timed shapes
    hmma = _mega_hmma()
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    occ = {}
    for key, bwd in (("k4f", False), ("k4b", True)):
        rows, smem, per_sm = fa.mega_occupancy(bwd, 256, hd, dt)
        occ[key] = {"rows": rows, "smem_bytes": smem, "blocks_per_sm": per_sm,
                    "waves": {bs: bs * kh / (sm * per_sm)
                              for bs, _s in MEGA_TIMED.values()}}
        print(f"  {key}: {rows}-row tiles, {smem} B shared, {per_sm} blocks "
              f"an SM (occupancy calculator): " + ", ".join(
                  f"{bs * kh} blocks = {w:.2f} waves on {sm} SMs"
                  for bs, w in occ[key]["waves"].items()))

    # times at the two shapes; the first gives the kernel rows
    timed = {}
    for label in ("serve", "train"):   # the last one's tensors stay
        tb, ts = MEGA_TIMED[label]
        q, k, v, do, out, lse, args, st, dev, host = _k4_times(tb, ts, flush)
        timed[label] = {"shape": [tb, 15, 5, ts, 64], "events": st,
                        "device": dev, "host_us": host}
        print(f"  table entry: MegaTiming({ts}, 64, 16, {tb}, 5, k4f_ms="
              f"{st['k4f_lse']['median']:.4f}, k1_ms="
              f"{st['k1_lse']['median']:.4f}, k4b_ms="
              f"{st['k4b']['median']:.4f}, k3_ms={st['k3']['median']:.4f})")
        if label != "train":
            del q, k, v, do, out, lse, args
            torch.cuda.empty_cache()
    ms = {key: timed["train"]["events"][key]["median"]
          for key in timed["train"]["events"]}
    plain_fwd = _time_ms(lambda: fa.flash_attention_plain(q, k, v), 3, flush)
    plain_fwd_lse = _time_ms(lambda: fa.flash_attention_plain(
        q, k, v, with_lse=True), 3, flush)
    plain_bwd = _time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, out, lse, do), 3, flush)
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, enable_gqa=True)
    lib_fwd = _time_ms(sdpa, 20, flush)
    lib_fwd_dev = _time_stats(sdpa, 20, flush, spin=True)["median"]
    ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                        enable_gqa=True)
    sdpa_bwd = lambda: torch.autograd.grad(  # noqa: E731
        lo, (ql, kl, vl), do, retain_graph=True)
    lib_bwd = _time_ms(sdpa_bwd, 20, flush)
    lib_bwd_dev = _time_stats(sdpa_bwd, 20, flush, spin=True)["median"]
    lib_fwd_bwd = _time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                       enable_gqa=True), (ql, kl, vl), do),
        20, flush)
    del ql, kl, vl, lo
    b, s = MEGA_TIMED["train"]
    work = {key: kcounts.attention_work(key, b, h, kh, s, s, hd, hd, 0, True,
                                        0, q.element_size())
            for key in ("k4f", "k4f_lse", "k4b")}
    plan = autotune.plan_attention(s, hd, hd, kh, b, 16, sm_count=sm)
    out_rows = {}
    names = {"k4f": "K4f", "k4f_lse": "K4f with lse", "k4b": "K4b"}
    for key, (flops, nbytes) in work.items():
        bound_ms, bound_by = _bound(flops, nbytes, dt)
        o = occ["k4b" if key == "k4b" else "k4f"]
        plain = {"k4f": plain_fwd, "k4f_lse": plain_fwd_lse,
                 "k4b": plain_bwd}[key]
        lib = lib_bwd if key == "k4b" else lib_fwd
        dev = timed["train"]["device"].get(key, {}).get("median")
        out_rows[key] = {"ms": ms[key], "device_ms": dev, "plain_ms": plain,
                         "library_ms": lib, "bound_ms": bound_ms,
                         "bound_by": bound_by,
                         "max_abs_err": worst[key][0],
                         "mean_abs_err": worst[key][1],
                         "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
                         "tile_rows": o["rows"], "smem_bytes": o["smem_bytes"],
                         "blocks": b * kh, "blocks_per_sm": o["blocks_per_sm"],
                         "waves": o["waves"][b],
                         "tiled_ms": ms[{"k4f": "k1", "k4f_lse": "k1_lse",
                                         "k4b": "k3"}[key]]}
        print(f"  {names[key]}: kernel {ms[key]:.4f} ms"
              + (f" (device {dev:.4f})" if dev is not None else "")
              + f", plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP, "
              f"{nbytes / 1e6:.1f} MB), {flops / ms[key] / 1e9:.0f} TFLOP/s "
              f"of the reference count")
    print(f"  sdpa at B={b} S={s}: forward {lib_fwd:.4f} ms (device "
          f"{lib_fwd_dev:.4f}), backward {lib_bwd:.4f} ms (device "
          f"{lib_bwd_dev:.4f}), forward+backward {lib_fwd_bwd:.4f} ms; "
          f"the planner's table gives {plan.describe()}")
    out_rows["tiled_ms"] = {k_: ms[k_] for k_ in ("k1", "k1_lse", "k3", "k2")}
    out_rows["library_ms"] = {"sdpa_fwd": lib_fwd, "sdpa_bwd": lib_bwd,
                              "sdpa_fwd_bwd": lib_fwd_bwd,
                              "sdpa_fwd_device": lib_fwd_dev,
                              "sdpa_bwd_device": lib_bwd_dev}
    out_rows["timed"] = timed
    out_rows["hmma"] = hmma
    out_rows["k4b_same_bits_as_k2"] = same_as_k2
    out_rows["plan"] = plan.describe()
    del q, k, v, do, out, lse, args
    torch.cuda.empty_cache()
    return out_rows


SHORT_ARGS = ["--arch", "smollm-360m", "--data", "markov", "--batch", "64",
              "--seq", "256", "--steps", "8", "--lr", "1e-3",
              "--device", "cuda"]
SHORT_MIN_SEQ = {"attn_flash_min_seq": 128}     # 256 > 128: flash


@contextlib.contextmanager
def _k4_route(sk, hd, dtype_bits, batch, kh, fwd=True, bwd=True):
    """The planner as if the card's times said K4f (``fwd``) and K4b
    (``bwd``) beat the tiled kernels at this shape, and the others lose:
    a route forced by putting such an entry first in the planner's
    measured table in this process (no config field or environment
    variable of the package changes)."""
    saved = autotune.MEGA_TIMINGS
    autotune.MEGA_TIMINGS = (autotune.MegaTiming(
        sk, hd, dtype_bits, batch, kh, k4f_ms=0.0 if fwd else 2.0, k1_ms=1.0,
        k4b_ms=0.0 if bwd else 2.0, k3_ms=1.0,
        card="forced by chip_smoke.py"),) + saved
    try:
        yield
    finally:
        autotune.MEGA_TIMINGS = saved


def _route_counts(plan, layers, steps, counts):
    """The launches a short train run takes on ``plan``: the forward
    twice a layer (remat="layer"), the backward once, every step."""
    fwd, bwd = 2 * layers * steps, layers * steps
    want = {k: 0 for k in counts}
    if plan.mega_fwd:
        want.update(k4f=fwd, k4f_lse=fwd)
    else:
        want["k1_lse"] = fwd
    want["k4b" if plan.mega_bwd else "k3"] = bwd
    return want


def _short_run(cfg, steps):
    """``steps`` steps of the short-sequence Trainer from seed 0: (the
    trainer, the state, host wall s, launch counts, step ms)."""
    tr = _trainer(cfg, TrainerConfig(), SHORT_ARGS)
    _zero_counts()
    t0 = time.perf_counter()
    state = tr.run(tr.init_or_restore(
        torch.Generator(device="cuda").manual_seed(0)), steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    for hst in tr.history:
        print(f"  step {hst['step']}: ce_loss {hst['ce_loss']:.4f} grad_norm "
              f"{hst['grad_norm']:.3f} {hst['step_time'] * 1e3:.1f} ms")
    if len(tr.history) != steps:
        raise AssertionError(f"{len(tr.history)} of {steps} steps ran")
    return tr, state, wall, counts, [1e3 * h["step_time"] for h in tr.history]


def phase_short_train():
    """smollm-360m at full width on 64 x 256-token sequences (16,384
    tokens a step, as the 4 x 4096 phase), 8 steps through the Trainer on
    the default plan, which must be what the planner's measured table
    (``autotune.MEGA_TIMINGS``) says at that shape, with exactly that
    route's launches; then, on the same trainer, blocks of 4 steps on the
    other route (each pass flipped between K4 and the tiled kernels) and
    on the default route in turn, each block's launches checked, both
    routes' step medians and a profiled step of each printed: host walls
    of this step move by ~100 ms between runs, so the two routes are
    compared in turn and by their device time."""
    print("== short train: smollm-360m full width, attn_flash_min_seq=128, "
          "64 x 256, 8 steps")
    cfg = dataclasses.replace(get_config("smollm-360m"), **SHORT_MIN_SEQ)
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    hd, kh = cfg.head_dim, cfg.num_kv_heads
    shape = (256, hd, 16, 64, kh)
    plan = autotune.plan_attention(256, hd, hd, kh, 64, 16, sm_count=sm)
    entry = [t for t in autotune.MEGA_TIMINGS
             if (t.sk, t.hd, t.dtype_bits, t.batch, t.kh) == shape]
    table = (bool(entry) and entry[0].k4f_ms < entry[0].k1_ms,
             bool(entry) and entry[0].k4b_ms < entry[0].k3_ms)
    print(f"  plan at B=64 S=256 bf16 on {sm} SMs: {plan.describe()}; the "
          f"table: {entry[0] if entry else 'no entry'}")
    if (plan.mega_fwd, plan.mega_bwd) != table:
        raise AssertionError("the default plan is not what the card's "
                             "measured table says")
    torch.cuda.reset_peak_memory_stats()
    tr, state, wall, counts, step_ms = _short_run(cfg, 8)
    layers, steps = cfg.num_layers, len(tr.history)
    want = _route_counts(plan, layers, steps, counts)
    print(f"  launches {counts} over {steps} steps (want {want}: "
          f"remat='layer' runs each forward twice)")
    if counts != want:
        raise AssertionError("the short train run did not launch its plan's "
                             "kernels alone")
    first, last = tr.history[0]["ce_loss"], tr.history[-1]["ce_loss"]
    if not (np.isfinite(last) and last < first):
        raise AssertionError(f"ce_loss {first} -> {last}: did not descend")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  {steps} steps in {wall:.1f} s wall; step median "
          f"{np.median(step_ms):.1f} ms (steps 2-8 mean "
          f"{np.mean(step_ms[1:]):.1f}); peak memory {peak_gb:.2f} GB")
    step_fn = tr._build()
    batch = {k: torch.from_numpy(v).cuda() for k, v in tr.data.get(0).items()}
    prof = _profile(lambda: step_fn(state, batch), 1)
    _print_profile("short train step (B=64 x 256; idle share against the "
                   "unprofiled step median)", prof, float(np.median(step_ms)))
    info = {"wall_s": wall, "step_ms": step_ms,
            "step_ms_median": float(np.median(step_ms)),
            "ce_loss": [hst["ce_loss"] for hst in tr.history],
            "peak_memory_gb": peak_gb, "launches": counts,
            "plan": plan.describe(), "step_profile": prof}

    # the other route and the default one in turn, blocks of 4 steps on
    # the same trainer, so that both see the same host; each block's first
    # step (the allocator meeting the route's buffers) is left out
    flip = dict(fwd=not plan.mega_fwd, bwd=not plan.mega_bwd)
    with _k4_route(*shape, **flip):
        other = autotune.plan_attention(256, hd, hd, kh, 64, 16, sm_count=sm,
                                        timings=autotune.MEGA_TIMINGS)
    print(f"  the other route ({other.describe()}) and the default one in "
          f"turn, 2 blocks of 4 steps each on the same trainer")
    runs = {"other": (other, []), "default": (plan, [])}
    totals = {key: {k: 0 for k in counts} for key in runs}

    def route(key):
        return (_k4_route(*shape, **flip) if key == "other"
                else contextlib.nullcontext())

    step = steps
    for key in ("other", "default", "other", "default"):
        plan_k, times = runs[key]
        _zero_counts()
        with route(key):
            state = tr.run(state, 4, start_step=step)
        torch.cuda.synchronize()
        got = _counts()
        want = _route_counts(plan_k, layers, 4, got)
        if got != want:
            raise AssertionError(f"{plan_k.describe()}: launches {got}, want "
                                 f"{want}")
        totals[key] = {k: totals[key][k] + got[k] for k in got}
        times.extend(1e3 * h["step_time"] for h in tr.history[-3:])
        step += 4
    if not all(np.isfinite(h["ce_loss"]) for h in tr.history):
        raise AssertionError("a short train step gave a non-finite loss")
    other_ms, default_ms = runs["other"][1], runs["default"][1]
    with route("other"):
        prof_other = _profile(lambda: step_fn(state, batch), 1)
    _print_profile(f"short train step on the other route ({other.describe()}"
                   "; idle share against its interleaved median)",
                   prof_other, float(np.median(other_ms)))
    print(f"  step medians, in turn: other route {np.median(other_ms):.1f} "
          f"ms {[round(x, 1) for x in other_ms]}, default route "
          f"{np.median(default_ms):.1f} ms "
          f"{[round(x, 1) for x in default_ms]}; device busy a step "
          f"{prof_other['device_busy_ms']} ms on the other route against "
          f"{prof['device_busy_ms']} on the default; launches on the other "
          f"route {totals['other']}")
    info["other_route"] = {"step_ms": other_ms,
                           "step_ms_median": float(np.median(other_ms)),
                           "launches": totals["other"],
                           "plan": other.describe(),
                           "step_profile": prof_other}
    info["default_interleaved"] = {
        "step_ms": default_ms, "step_ms_median": float(np.median(default_ms)),
        "launches": totals["default"]}
    del step_fn, batch
    del tr, state
    torch.cuda.empty_cache()
    return info


def phase_short_serve():
    """The same model in bf16: prefill 32 x 256 (B·KH = 160) on the plan
    the card's measured table gives (K4f or K1), 16 decode steps (K5);
    consistency in fp32 through K1; the paged engine's plan."""
    print("== short serve: smollm-360m full width, bf16, prefill 32 x 256")
    cfg = dataclasses.replace(get_config("smollm-360m"),
                              param_dtype="bfloat16", **SHORT_MIN_SEQ)
    model = LanguageModel(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(50))
    b, s, steps = 32, 256, 16
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(51))
    with torch.no_grad():
        _zero_counts()
        prefill_ms, step_ms, cache, tok = _serve_run(model, params, tokens,
                                                     steps)
        counts = _counts()
    layers = cfg.num_layers
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    plan = autotune.plan_attention(s, cfg.head_dim, cfg.head_dim,
                                   cfg.num_kv_heads, b, 16, sm_count=sm)
    want = {**{k: 0 for k in counts}, "k5": layers * steps,
            ("k4f" if plan.mega_fwd else "k1"): layers}
    print(f"  prefill {prefill_ms:.1f} ms (B=32 x 256, {plan.describe()}), "
          f"decode step {step_ms:.3f} ms (B=32); launches {counts}")
    if counts != want:
        raise AssertionError(f"launches {counts}, want {want}")
    prof = _profile(lambda: model.prefill(params, {"tokens": tokens}), 2)
    _print_profile("short prefill (B=32 x 256)", prof,
                   prof["profiled_wall_ms"])
    del model, params, cache
    torch.cuda.empty_cache()
    _zero_counts()
    f32 = _consistency("smollm-360m", b, s, "float32", 52, **SHORT_MIN_SEQ)
    cons_counts = _counts()
    bf16 = _consistency("smollm-360m", b, s, "bfloat16", 52, **SHORT_MIN_SEQ)
    print(f"  consistency, prefill({s}) + decode vs prefill({s + 1}), B={b}:"
          f" fp32 argmax agreement {f32['argmax_agreement']:.3f} (limit >= "
          f"0.95), max logit diff {f32['max_logit_diff']:.3e}; bf16 max "
          f"logit diff {bf16['max_logit_diff']:.3e}, RMS "
          f"{bf16['rms_logit_diff']:.3e}, argmax agreement "
          f"{bf16['argmax_agreement']:.3f} (reported); fp32 launches "
          f"{cons_counts}")
    if not (f32["argmax_agreement"] >= 0.95
            and cons_counts["k1"] == 2 * layers):
        raise AssertionError("short serve: decode disagrees with prefill, "
                             "or the fp32 prefills did not run K1")
    paged = autotune.plan_attention(s, cfg.head_dim, cfg.head_dim,
                                    cfg.num_kv_heads, 1, 16, sm_count=sm)
    print(f"  the paged engine prefills one request at a time: B·KH = "
          f"{cfg.num_kv_heads} blocks < {sm} SMs, plan: {paged.describe()}")
    if paged.mega_fwd:
        raise AssertionError("a one-request prefill planned K4f")
    return {"prefill_ms": prefill_ms, "decode_step_ms": step_ms,
            "launches": counts, "plan": plan.describe(),
            "prefill_profile": prof,
            "consistency": {"fp32": f32, "bf16": bf16},
            "consistency_launches": cons_counts,
            "paged_plan": paged.describe()}


TRAIN_ARGS = ["--arch", "smollm-360m", "--data", "markov", "--batch", "4",
              "--seq", "4096", "--steps", "8", "--lr", "1e-3",
              "--device", "cuda"]


def phase_train():
    """Full-width training through the entry point, 8 steps."""
    print("== train: repro_torch.launch.train " + " ".join(TRAIN_ARGS))
    args = train_cli.parse_args(TRAIN_ARGS)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    tr, state = train_cli.run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    layers, steps = tr.model.cfg.num_layers, args.steps
    for h in tr.history:
        print(f"  step {h['step']}: ce_loss {h['ce_loss']:.4f} loss "
              f"{h['loss']:.4f} grad_norm {h['grad_norm']:.3f} "
              f"{h['step_time'] * 1e3:.1f} ms")
    want = {**{k: 0 for k in counts}, "k1_lse": 2 * layers * steps,
            "k3": layers * steps}
    print(f"  launches {counts} (want {want}: with remat='layer' K1 with "
          f"lse runs twice a layer, K3 once)")
    if counts != want:
        raise AssertionError("the train run did not launch the kernels "
                             "the reckoning says")
    first, last = tr.history[0]["ce_loss"], tr.history[-1]["ce_loss"]
    if not (np.isfinite(last) and last < first):
        raise AssertionError(f"ce_loss {first} -> {last}: did not descend")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [1e3 * h["step_time"] for h in tr.history]
    print(f"  {steps} steps in {wall:.1f} s wall; step median "
          f"{np.median(step_ms):.1f} ms (steps 2-8 mean "
          f"{np.mean(step_ms[1:]):.1f}); tokens/step "
          f"{args.batch * args.seq}; peak memory {peak_gb:.2f} GB")
    step_fn = tr._build()
    batch = {k: torch.from_numpy(v).cuda() for k, v in tr.data.get(0).items()}
    prof = _profile(lambda: step_fn(state, batch), 1)
    _print_profile("train step (B=4 x 4096)", prof, prof["profiled_wall_ms"])
    info = {"wall_s": wall, "step_ms": step_ms,
            "ce_loss": [h["ce_loss"] for h in tr.history],
            "grad_norm": [h["grad_norm"] for h in tr.history],
            "peak_memory_gb": peak_gb, "launches": counts,
            "step_profile": prof}
    del tr, state, step_fn, batch
    torch.cuda.empty_cache()
    return info


def _trainer(cfg, tc, argv=TRAIN_ARGS):
    """The port's Trainer as ``launch.train`` builds it from ``argv``
    (the config's optimizer state dtype: int8 moments for arctic and
    deepseek, and its ``train_accum_steps`` micro-batches a step)."""
    args = train_cli.parse_args(argv)
    oc = train_cli.optimizer_config(cfg, args)
    data = SyntheticTokens(cfg.vocab_size, args.batch, args.seq, seed=0,
                           mode="markov")
    return Trainer(LanguageModel(cfg, device="cuda"), oc, data, tc)


def _n_params(cfg):
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim
    layer = (2 * d * (cfg.num_heads + cfg.num_kv_heads) * hd
             + 2 * d + 3 * d * f)
    return cfg.vocab_size * d + d + cfg.num_layers * layer


# smollm's depth in the restart phase (of 32), cut to keep the whole run
# inside its time limit: the two checkpoints are host-bound
RESTART_LAYERS = 8


def phase_restart(ckpt_dir):
    """Deterministic mode (K2 backward): 8 uninterrupted steps against 6
    steps that checkpoint at 4 and die at 6, resumed from 4, with
    ``RESTART_LAYERS`` of smollm's layers at full width."""
    print("== restart: deterministic mode, full width, bit-exact")
    cfg = dataclasses.replace(get_config("smollm-360m"),
                              num_layers=RESTART_LAYERS)
    state_bytes = 12 * _n_params(cfg)     # fp32 params, m and v
    free = shutil.disk_usage(ckpt_dir).free
    cut = None
    if free < 3 * state_bytes:       # two checkpoints and room to spare
        cut = max(2, int(cfg.num_layers * free / (3 * state_bytes)))
        cfg = dataclasses.replace(cfg, num_layers=cut)
    print(f"  checkpoint of the train state {state_bytes / 1e9:.2f} GB, "
          f"{free / 1e9:.1f} GB free at {ckpt_dir}; depth "
          f"{cfg.num_layers}{' (cut for disk space)' if cut else ''}")
    torch.use_deterministic_algorithms(True)
    try:
        _zero_counts()
        tr_a = _trainer(cfg, TrainerConfig())
        gen = torch.Generator(device="cuda")
        state_a = tr_a.run(tr_a.init_or_restore(gen.manual_seed(0)), 8)
        final_a = [p.cpu() for _p, p in iter_leaves(state_a["params"])]
        del state_a, tr_a
        torch.cuda.empty_cache()

        tc = TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=4, async_ckpt=False,
                           fail_at_step=6)
        tr_b = _trainer(cfg, tc)
        t0 = time.perf_counter()
        tr_b.run(tr_b.init_or_restore(gen.manual_seed(0)), 8)
        b_s = time.perf_counter() - t0
        if max(h["step"] for h in tr_b.history) != 5:
            raise AssertionError("run B did not die at step 6")
        del tr_b
        torch.cuda.empty_cache()

        tr_c = _trainer(cfg, TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=4,
                                           async_ckpt=False))
        t0 = time.perf_counter()
        state_c = tr_c.init_or_restore(gen.manual_seed(99))
        restore_s = time.perf_counter() - t0
        if tr_c.start_step != 4:
            raise AssertionError(f"resumed at {tr_c.start_step}, not 4")
        state_c = tr_c.run(state_c, 8 - tr_c.start_step)
        counts = _counts()
    finally:
        torch.use_deterministic_algorithms(False)
    final_c = [p.cpu() for _p, p in iter_leaves(state_c["params"])]
    same = all(torch.equal(a, c) for a, c in zip(final_a, final_c))
    steps = 8 + 6 + 4
    print(f"  C's final params equal A's bit for bit: {same}; run B "
          f"{b_s:.1f} s (6 steps, one checkpoint), restore {restore_s:.1f} "
          f"s; launches {counts}")
    if not same:
        raise AssertionError("the resumed run differs from the "
                             "uninterrupted one")
    if not (counts["k2_dq"] == counts["k2_dkv"] == cfg.num_layers * steps
            and counts["k3"] == 0):
        raise AssertionError("deterministic mode did not run K2 alone")
    del state_c, tr_c
    torch.cuda.empty_cache()
    return {"bit_exact": same, "launches": counts, "run_b_s": b_s,
            "restore_s": restore_s, "num_layers": cfg.num_layers,
            "depth_cut_for_disk": cut, "state_gb": state_bytes / 1e9}


SSM_TRAIN_ARGS = ["--arch", "mamba2-1.3b", "--data", "markov", "--batch",
                  "4", "--seq", "4096", "--steps", "6", "--lr", "1e-3",
                  "--device", "cuda"]
# zamba2's loss rises over its first steps at this lr before it falls,
# and from run to run (K3's dq atomics sum in another order) its sixth
# lies ±0.01 about the first: 10 steps take it clearly below
HYBRID_TRAIN_ARGS = ["--arch", "zamba2-1.2b", "--data", "markov",
                     "--batch", "4", "--seq", "4096", "--steps", "10",
                     "--lr", "1e-3", "--device", "cuda"]


def _ssm_want(cfg, steps, counts, deterministic=False):
    """The launches of ``steps`` train steps of an ssm / hybrid config:
    with remat="layer" K9 twice a Mamba layer (forward, then again in the
    backward's recompute) and K9b once; a hybrid's shared attention block
    (outside remat, as in the reference) K1-lse and K3 (K2 in
    deterministic mode) once per application."""
    want = {**{k: 0 for k in counts}, "k9": 2 * cfg.num_layers * steps,
            "k9b": cfg.num_layers * steps}
    if cfg.family == "hybrid":
        g = cfg.num_layers // cfg.attn_every
        want["k1_lse"] = g * steps
        if deterministic:
            want["k2_dq"] = want["k2_dkv"] = g * steps
        else:
            want["k3"] = g * steps
    return want


def _ssm_train(argv, what):
    """Full-width training of an ssm or hybrid config through the entry
    point: ce_loss falls, the launches match the reckoning; step median,
    peak memory and one profiled step."""
    print(f"== {what}: repro_torch.launch.train " + " ".join(argv))
    args = train_cli.parse_args(argv)
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    t0 = time.perf_counter()
    tr, state = train_cli.run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    cfg = tr.model.cfg
    for h in tr.history:
        print(f"  step {h['step']}: ce_loss {h['ce_loss']:.4f} grad_norm "
              f"{h['grad_norm']:.3f} {h['step_time'] * 1e3:.1f} ms")
    want = _ssm_want(cfg, args.steps, counts)
    print(f"  launches {counts} (want {want})")
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, want {want}")
    first, last = tr.history[0]["ce_loss"], tr.history[-1]["ce_loss"]
    if not (np.isfinite(last) and last < first):
        raise AssertionError(f"ce_loss {first} -> {last}: did not descend")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [1e3 * h["step_time"] for h in tr.history]
    print(f"  {args.steps} steps in {wall:.1f} s wall; step median "
          f"{np.median(step_ms):.1f} ms (steps 2-{args.steps} mean "
          f"{np.mean(step_ms[1:]):.1f}); peak memory {peak_gb:.2f} GB")
    step_fn = tr._build()
    batch = {k: torch.from_numpy(v).cuda() for k, v in tr.data.get(0).items()}
    prof = _profile(lambda: step_fn(state, batch), 1)
    _print_profile(f"{what} step (B=4 x 4096)", prof,
                   prof["profiled_wall_ms"])
    info = {"wall_s": wall, "step_ms": step_ms,
            "ce_loss": [h["ce_loss"] for h in tr.history],
            "grad_norm": [h["grad_norm"] for h in tr.history],
            "peak_memory_gb": peak_gb, "launches": counts,
            "step_profile": prof}
    del tr, state, step_fn, batch
    torch.cuda.empty_cache()
    return info


def phase_ssm_train():
    """mamba2-1.3b at full width (48 layers), 6 steps of 4 x 4096."""
    return _ssm_train(SSM_TRAIN_ARGS, "ssm train")


def phase_hybrid_train():
    """zamba2-1.2b at full width (38 Mamba layers, the shared attention
    block applied 6 times), 10 steps of 4 x 4096."""
    return _ssm_train(HYBRID_TRAIN_ARGS, "hybrid train")


def phase_ssm_train_reference():
    """One depth-cut mamba2 train step: 2 layers at full width, fp32, 1 x
    1024 tokens, on the card (K9 and K9b on the fp32 route) against the
    CPU's plain path (autograd of the plain scan) from the same weights:
    loss and gradients."""
    print("== ssm train: 2 layers full width, fp32, 1 x 1024, card (K9, "
          "K9b) vs CPU")
    cfg = dataclasses.replace(get_config("mamba2-1.3b"), num_layers=2,
                              dtype="float32", param_dtype="float32")
    cpu = LanguageModel(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(64))
    gpu = LanguageModel(cfg, "cuda")
    params_gpu = _tree_to(params, "cuda", copy=True)
    toks = np.random.RandomState(65).randint(0, cfg.vocab_size, (1, 1025))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(toks[:, 1:])}
    _zero_counts()
    loss, grads = _grads(gpu, params_gpu, batch, "cuda")
    torch.cuda.synchronize()
    counts = _counts()
    grads = [g.cpu() for g in grads]
    t0 = time.perf_counter()
    loss_c, g_cpu = _grads(cpu, params, batch, "cpu")
    cpu_s = time.perf_counter() - t0
    loss_err = abs(loss - loss_c) / abs(loss_c)
    errs = {"/".join(p): (a - c).abs().max().item()
            / max(c.abs().max().item(), 1e-30)
            for (p, _), a, c in zip(iter_leaves(params), grads, g_cpu)}
    grad_err = max(errs.values())
    want = _ssm_want(cfg, 1, counts)
    finite = all(torch.isfinite(g).all() for g in g_cpu)
    print(f"  loss {loss:.6f} vs CPU {loss_c:.6f} (rel err {loss_err:.2e}, "
          f"limit 1e-5), gradients {grad_err:.2e} of each leaf's max (limit "
          f"1e-4: fp32 in another summation order; worst "
          f"{max(errs, key=errs.get)}), CPU gradients finite {finite}; "
          f"launches {counts} (want {want}); CPU {cpu_s:.1f} s")
    if counts != want:
        raise AssertionError(f"launches {counts}, want {want}")
    if not (finite and loss_err <= 1e-5 and grad_err <= 1e-4):
        raise AssertionError("ssm train step: card and CPU disagree")
    del gpu, params_gpu
    torch.cuda.empty_cache()
    return {"loss_rel_err": loss_err, "grad_rel_err": grad_err,
            "grad_rel_err_by_leaf": errs, "launches": counts, "cpu_s": cpu_s}


def phase_ssm_deterministic():
    """Deterministic mode: 2 steps of a depth-cut mamba2 (4 layers) and
    zamba2 (7 layers: one shared-attention group and one more Mamba layer)
    at full width, each run twice from the same seed: the two runs' final
    parameters must be the same bits."""
    print("== ssm / hybrid deterministic reruns (depth-cut, full width)")
    info = {}
    for arch, layers in (("mamba2-1.3b", 4), ("zamba2-1.2b", 7)):
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        argv = ["--arch", arch, "--data", "markov", "--batch", "2", "--seq",
                "2560", "--steps", "2", "--lr", "1e-3", "--device", "cuda"]
        finals, counts = [], []
        torch.use_deterministic_algorithms(True)
        try:
            for _ in range(2):
                _zero_counts()
                tr = _trainer(cfg, TrainerConfig(), argv=argv)
                state = tr.run(tr.init_or_restore(
                    torch.Generator(device="cuda").manual_seed(0)), 2)
                torch.cuda.synchronize()
                counts.append(_counts())
                finals.append([p.cpu() for _p, p in
                               iter_leaves(state["params"])])
                del tr, state
                torch.cuda.empty_cache()
        finally:
            torch.use_deterministic_algorithms(False)
        same = all(torch.equal(a, c) for a, c in zip(*finals))
        want = _ssm_want(cfg, 2, counts[0], deterministic=True)
        print(f"  {arch} ({layers} layers, 2 x 2560, 2 steps twice): final "
              f"params the same bits {same}; launches {counts[0]} (want "
              f"{want})")
        if not same:
            raise AssertionError(f"{arch}: deterministic reruns differ")
        if counts[0] != want or counts[1] != want:
            raise AssertionError(f"{arch}: launches {counts}, want {want}")
        info[arch] = {"bit_exact": same, "launches": counts[0]}
    return info


def phase_serve_ckpt(ckpt_dir):
    """Restore the restart phase's last checkpoint; prefill a 2100-token
    prompt (K1) and decode 16 tokens (K5) on the card."""
    print("== serve from the checkpoint: prefill 2100 tokens, 16 decodes")
    tree, step = ckpt.restore(ckpt_dir)
    n_layers = tree["params"]["layers"]["attn"]["w_q"].shape[0]
    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=n_layers)
    model = LanguageModel(cfg, device="cuda")
    params = state_from_numpy(tree["params"], "cuda")
    del tree
    rng = np.random.RandomState(5)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, 2100))).cuda()
    _zero_counts()
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tokens})
        cache = model.alloc_cache(1, 2100 + 16, init=cache)
        tok = logits.argmax(-1, keepdim=True)
        for i in range(16):
            logits, cache = model.decode_step(params, cache, tok, 2100 + i)
            tok = logits.argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    counts = _counts()
    print(f"  restored step {step}; launches {counts}")
    if logits.shape != (1, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError("logits from the checkpoint are not finite")
    if counts["k1"] != n_layers or counts["k5"] != 16 * n_layers or \
            counts["k1_lse"]:
        raise AssertionError("serving did not run K1 (no lse) and K5")
    del model, params, cache
    torch.cuda.empty_cache()
    return {"step": step, "launches": counts}


def phase_train_reference():
    """One train step of a 2-layer full-width fp32 model on the card (K1
    with lse, K3) against the CPU's plain path from the same weights."""
    print("== train reference: 2-layer full width fp32, B=1 S=2100, card "
          "vs CPU")
    # loss chunks of 700 positions: the default 1024 halves down to 4
    # (the largest power of two dividing 2100), 525 chunks that re-read
    # the 189 MB unembedding each, most of the CPU side's minute
    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=2,
                              dtype="float32", param_dtype="float32",
                              loss_chunk=700)
    oc = OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    cpu = LanguageModel(cfg, "cpu")
    params = cpu.init(torch.Generator().manual_seed(6))
    toks = np.random.RandomState(7).randint(0, cfg.vocab_size, (1, 2101))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "targets": torch.from_numpy(toks[:, 1:])}
    out = {}
    for dev in ("cuda", "cpu"):
        model = LanguageModel(cfg, dev) if dev == "cuda" else _cpu_model(cfg)
        p = _tree_to(params, dev, copy=True)
        state = {"params": p, "opt": init_opt_state(p, oc)}
        _zero_counts()
        t0 = time.perf_counter()
        state, m = make_train_step(model, oc)(
            state, {k: v.to(dev) for k, v in batch.items()})
        m = {k: float(v) for k, v in m.items()}
        out[dev] = (state, m, _counts(), time.perf_counter() - t0)
    (sg, mg, cg, tg), (sc, mc, _cc, tc) = out["cuda"], out["cpu"]
    if cg["k1_lse"] != 4 or cg["k3"] != 2:
        raise AssertionError(f"card step launches {cg}: want K1-lse 4, K3 2")
    loss_err = abs(mg["loss"] - mc["loss"]) / abs(mc["loss"])
    gn_err = abs(mg["grad_norm"] - mc["grad_norm"]) / mc["grad_norm"]
    p_max = p_mean = 0.0
    for (_p, a), (_q, c) in zip(iter_leaves(sg["params"]),
                                iter_leaves(sc["params"])):
        d = (a.cpu() - c).abs()
        p_max, p_mean = max(p_max, d.max().item()), max(p_mean,
                                                        d.mean().item())
    lr = oc.peak_lr
    print(f"  loss {mg['loss']:.6f} vs {mc['loss']:.6f} (rel err "
          f"{loss_err:.2e}, limit 1e-5); grad_norm {mg['grad_norm']:.5f} vs "
          f"{mc['grad_norm']:.5f} (rel err {gn_err:.2e}, limit 1e-4); "
          f"params after the step max_abs_err {p_max:.3e} (limit 2 lr = "
          f"{2 * lr:g}), worst leaf mean {p_mean:.3e} (limit 1e-4 lr); "
          f"card {tg:.1f} s, CPU {tc:.1f} s")
    if not (loss_err <= 1e-5 and gn_err <= 1e-4 and p_max <= 2 * lr
            and p_mean <= 1e-4 * lr):
        raise AssertionError("the card's train step disagrees with the CPU")
    return {"loss_rel_err": loss_err, "grad_norm_rel_err": gn_err,
            "param_max_abs_err": p_max, "param_worst_leaf_mean_err": p_mean,
            "launches": cg}


# ------------------------------------------------- SSM and hybrid serving

def _ssd_inputs(b, h, s, p, n, dtype, seed):
    """x (B,H,S,P), dt = softplus(randn) (~0.7 a step, as the dt
    projection gives), A = -exp(0.5 randn) (around the initial -1), B/C
    (B,S,N)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, h, s, p), generator=gen, device="cuda").to(dtype)
    dt = F.softplus(torch.randn((b, h, s), generator=gen, device="cuda"))
    A = -torch.exp(0.5 * torch.randn((h,), generator=gen, device="cuda"))
    B = torch.randn((b, s, n), generator=gen, device="cuda").to(dtype)
    C = torch.randn((b, s, n), generator=gen, device="cuda").to(dtype)
    return x, dt, A, B, C


# K9's and K9b's work: their own counts (kernels.counts)
_ssd_work = kcounts.ssd_work


def _ssd_tc_floor(b, h, s, p, n, chunk, el):
    """Bytes the tc route itself moves at the least, over the card's
    memory rate (ms): x read by both kernels, y written, B twice and C
    once, dt twice, the entering states' scratch written and read, the
    final state written.  Beside the function's bound, never instead."""
    nc = -(-s // min(chunk, s))
    scratch = b * h * nc * p * n * 4
    nbytes = (3 * b * h * s * p * el + 3 * b * s * n * el + 8 * b * h * s
              + 2 * scratch + 4 * b * h * p * n)
    return nbytes / PEAK_BYTES * 1e3


def phase_k9(flush):
    """K9 against its plain version at the serving shapes (on the tc
    route also the entering states against ``ssd_chunk_states_plain``),
    then timed: the call under both timers, and on the tc route K9s and
    K9y alone (device-only)."""
    print("== K9 ssd_scan: kernel vs plain version")
    cases = [  # name, B, H, S, P, N, chunk, dtype, timed
        ("mamba2 4x4096 bf16", 4, 64, 4096, 64, 128, 128, torch.bfloat16,
         True),
        ("zamba2 1x3000 N=64 bf16 (ragged)", 1, 64, 3000, 64, 64, 128,
         torch.bfloat16, True),
        ("mamba2 1x16384 bf16", 1, 64, 16384, 64, 128, 128, torch.bfloat16,
         True),
        ("ragged 4x3000 bf16", 4, 64, 3000, 64, 128, 128, torch.bfloat16,
         False),
        ("reduced fp32 P=32 N=16 chunk 16, S=65", 2, 8, 65, 32, 16, 16,
         torch.float32, False),
    ] + [  # short prompts: the chunk is S, not a whole number of strips
        (f"short 4x{s} bf16", 4, 64, s, 64, 128, 128, torch.bfloat16, False)
        for s in (40, 70, 100)
    ]
    worst = {"y": 0.0, "state_rel": 0.0, "entering_rel": 0.0}
    timed = []
    for i, (name, b, h, s, p, n, chunk, dt, time_it) in enumerate(cases):
        args = _ssd_inputs(b, h, s, p, n, dt, 500 + i)
        y, st = ssd.ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
        route = ssd.ssd_scan.last_route
        if route != ssd.route(dt, p, n, min(chunk, s)):
            raise AssertionError(f"{name}: K9 took the {route} route")
        yw, sw = ssd.ssd_scan_plain(*args, chunk=chunk)
        if not (torch.isfinite(y.float()).all() and torch.isfinite(st).all()):
            raise AssertionError(f"{name}: K9 gave a NaN or inf")
        d = (y.float() - yw.float()).abs()
        top = yw.float().abs()
        # bf16: one rounding of y apart (2^-7 relative); fp32: summation
        # order; both with 1e-4 of max|y| for entries near zero
        rel = 2.0 ** -7 if dt == torch.bfloat16 else 1e-4
        bad = int((d > rel * top + 1e-4 * top.max()).sum())
        st_rel = (st - sw).abs().max().item() / sw.abs().max().item()
        ent = ""
        ent_rel = 0.0
        if route == "tc":
            # the tc route's first stage against its plain version: the
            # entering states (read back as their hi + lo pair)
            entering, _ = ssd.ssd_chunk_states_plain(*args[:4], chunk=chunk)
            scratch, _ = ssd.chunk_states_tc(*args, chunk=chunk)
            ent_rel = ((ssd.states_from_scratch(scratch) - entering).abs()
                       .max().item() / max(entering.abs().max().item(),
                                           1e-30))
            ent = f", entering states {ent_rel:.2e} (limit 1e-4)"
            del entering, scratch
        print(f"  {name}: route {route}; y max_abs_err {d.max().item():.3e} "
              f"(max|y| {top.max().item():.3g}; {bad} entries past {rel:g}"
              f"|y| + 1e-4 max|y|), state max err {st_rel:.2e} of "
              f"max|state| (limit 1e-4){ent}")
        if bad or not st_rel <= 1e-4 or not ent_rel <= 1e-4:
            raise AssertionError(f"{name}: K9 disagrees with plain version")
        worst["y"] = max(worst["y"], d.max().item())
        worst["state_rel"] = max(worst["state_rel"], st_rel)
        worst["entering_rel"] = max(worst["entering_rel"], ent_rel)
        del y, st, yw, sw
        if time_it:
            call = lambda: ssd.ssd_scan(*args, chunk=chunk)  # noqa: E731
            ev = _time_stats(call, 10, flush)
            dev = _time_stats(call, 10, flush, spin=True)
            plain_ms = _time_ms(lambda: ssd.ssd_scan_plain(
                *args, chunk=chunk), 3, flush)
            flops, nbytes = _ssd_work(b, h, s, p, n, chunk,
                                      args[0].element_size())
            bound_ms, bound_by = _bound(flops, nbytes, dt)
            row = {"shape": name, "k9_route": route, "ms": ev["median"],
                   "events": ev, "device": dev, "plain_ms": plain_ms,
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "gflop": flops / 1e9, "mbytes": nbytes / 1e6}
            stages = ""
            if route == "tc":
                scratch, _ = ssd.chunk_states_tc(*args, chunk=chunk)
                row["k9s_device"] = _time_stats(
                    lambda: ssd.chunk_states_tc(*args, chunk=chunk), 10,
                    flush, spin=True)
                row["k9y_device"] = _time_stats(
                    lambda: ssd.chunk_scan_tc(*args, scratch, chunk=chunk),
                    10, flush, spin=True)
                row["design_floor_ms"] = _ssd_tc_floor(
                    b, h, s, p, n, chunk, args[0].element_size())
                row["heads_per_k9y_block"] = ssd.tc_group(
                    b, h, -(-s // min(chunk, s)),
                    torch.cuda.get_device_properties(0).multi_processor_count)
                stages = (f"; K9s {_fmt(row['k9s_device'])}, K9y "
                          f"{_fmt(row['k9y_device'])} (device-only); the "
                          f"route's byte floor {row['design_floor_ms']:.4f}"
                          f" ms")
                del scratch
            timed.append(row)
            print(f"    kernel {_fmt(ev)}, device-only {_fmt(dev)}{stages}; "
                  f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}: {flops / 1e9:.2f} GFLOP, "
                  f"{nbytes / 1e6:.1f} MB)")
        del args
        torch.cuda.empty_cache()
    main = timed[0]
    return {"name": "ssd_scan (K9)", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:28",
            "max_abs_err": worst["y"],
            "state_max_err_rel": worst["state_rel"],
            "entering_max_err_rel": worst["entering_rel"], "ms": main["ms"],
            "device_ms": main["device"]["median"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "timed_shape": "B=4 H=64 S=4096 P=64 N=128 chunk 128 bf16",
            "timed": timed}


_ssd_bwd_work = kcounts.ssd_bwd_work


# K9b's kernels: label -> a piece of the mangled name (the fp32 state pass
# serves both directions)
K9B_KERNELS = {"K9bs tc": "ssd_states_tc_kernelILb1",
               "K9bx tc": "ssd_bwd_chunk_tc_kernel",
               "K9bc tc": "ssd_bwd_bc_tc_kernel",
               "pass fp32": "ssd_pass_kernel",
               "K9bg fp32": "ssd_bwd_state_kernel",
               "K9bx fp32": "ssd_bwd_chunk_kernel",
               "K9bc fp32": "ssd_bwd_bc_kernel"}


def _bwd_check(name, got, want, dtype):
    """One gradient against the plain version's: bf16 entries one bf16
    rounding apart (2^-7 relative) plus 1e-4 of the largest |value| (sums
    of thousands of terms near zero); fp32 1e-4 of the largest |value|
    (summation order).  Returns (entries past the limit, the largest
    error, the same relative to the largest |value|)."""
    d = (got.float() - want.float()).abs()
    top = want.float().abs()
    scale = max(top.max().item(), 1e-30)
    rel = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    bad = int((d > rel * top + 1e-4 * scale).sum())
    return bad, d.max().item(), d.max().item() / scale


def phase_k9b(flush):
    """K9b (the scan's backward) against ``ssd_scan_bwd_plain`` at the
    training shapes, twice each for the same bits; the two full-width
    bf16 shapes timed under both timers beside the plain backward and
    the bound."""
    print("== K9b ssd_scan backward: kernel vs plain version")
    bf = torch.bfloat16
    cases = [  # name, B, H, S, P, N, chunk, dtype, dstate, timed
        ("mamba2 4x4096 bf16", 4, 64, 4096, 64, 128, 128, bf, False, True),
        ("zamba2 4x4096 N=64 bf16", 4, 64, 4096, 64, 64, 128, bf, False,
         True),
        ("ragged 4x3000 bf16", 4, 64, 3000, 64, 128, 128, bf, False, False),
        ("reduced fp32 P=32 N=16 chunk 16, S=65", 2, 8, 65, 32, 16, 16,
         torch.float32, False, False),
        ("reduced bf16 P=32 N=16 chunk 16, S=65", 2, 8, 65, 32, 16, 16, bf,
         False, False),
        ("dstate 1x1000 bf16", 1, 64, 1000, 64, 128, 128, bf, True, False),
        ("dstate fp32 1x300 P=64 N=128", 1, 8, 300, 64, 128, 128,
         torch.float32, True, False),
    ]
    names = ("dx", "ddt", "dA", "dB", "dC")
    worst = dict.fromkeys(names, 0.0)
    worst_abs = 0.0
    timed = []
    for i, (name, b, h, s, p, n, chunk, dt, with_ds, time_it) in \
            enumerate(cases):
        args = _ssd_inputs(b, h, s, p, n, dt, 700 + i)
        gen = torch.Generator(device="cuda").manual_seed(800 + i)
        dy = torch.randn((b, h, s, p), generator=gen, device="cuda").to(dt)
        ds = (torch.randn((b, h, p, n), generator=gen, device="cuda")
              if with_ds else None)
        before = ssd.ssd_scan.bwd_launches
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = ssd._launch_bwd(*args, dy, ds, chunk)
        torch.cuda.synchronize()
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        again = ssd._launch_bwd(*args, dy, ds, chunk)
        torch.cuda.synchronize()
        if ssd.ssd_scan.bwd_launches != before + 2:
            raise AssertionError(f"{name}: K9b launches not counted")
        same = all(torch.equal(a, c) for a, c in zip(got, again))
        want = ssd.ssd_scan_bwd_plain(*args, dy, ds, chunk=chunk)
        errs, fails = {}, []
        for nm, g, w in zip(names, got, want):
            if not torch.isfinite(g.float()).all():
                fails.append(f"{nm} not finite")
            bad, err_abs, err = _bwd_check(nm, g, w, g.dtype)
            # dA sums B·S products dcum·cumsum(dt) that cancel: 1e-3 of
            # max|dA| (the CPU tests see ~1e-5 at a few hundred positions)
            if (err > 1e-3) if nm == "dA" else bad:
                fails.append(f"{nm}: {bad} entries out, err {err:.2e}")
            errs[nm] = err
            worst[nm] = max(worst[nm], err)
            worst_abs = max(worst_abs, err_abs)
        print(f"  {name}: route {ssd.route(dt, p, n, min(chunk, s))}; "
              f"max err / max|value|: " + ", ".join(
                  f"{k} {v:.2e}" for k, v in errs.items())
              + f" (limits: bf16 outputs one rounding + 1e-4, fp32 1e-4, "
              f"dA 1e-3); twice the same bits {same}; peak {peak_gb:.2f} GB")
        if fails or not same:
            raise AssertionError(f"{name}: K9b disagrees with the plain "
                                 f"backward: {fails}, same bits {same}")
        del got, again, want
        if time_it:
            call = lambda: ssd._launch_bwd(*args, dy, ds, chunk)  # noqa: E731
            ev = _time_stats(call, 5, flush)
            dev = _time_stats(call, 5, flush, spin=True)
            plain_ms = _time_ms(lambda: ssd.ssd_scan_bwd_plain(
                *args, dy, ds, chunk=chunk), 2, flush)
            flops, nbytes = _ssd_bwd_work(b, h, s, p, n, chunk,
                                          args[0].element_size())
            bound_ms, bound_by = _bound(flops, nbytes, dt)
            row = {"shape": name, "ms": ev["median"], "events": ev,
                   "device": dev, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "gflop": flops / 1e9,
                   "mbytes": nbytes / 1e6, "peak_gb": peak_gb}
            if not timed:
                # the kernels of one call, device time each
                row["profile"] = _profile(call, 2)
                _print_profile(f"K9b ({name})", row["profile"],
                               row["profile"]["profiled_wall_ms"])
            timed.append(row)
            print(f"    kernel {_fmt(ev)}, device-only {_fmt(dev)}; plain "
                  f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
                  f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
        del args, dy, ds
        torch.cuda.empty_cache()
    sass = _sass_counts("ssd_")
    hmma = {label: sum(n for name, n in sass.items() if pattern in name)
            for label, pattern in K9B_KERNELS.items()}
    print(f"  K9b's kernels, HMMA in SASS: {hmma} (the tc route's K9bs, K9bx "
          f"and K9bc on tensor cores; the fp32 route's on CUDA cores)")
    if not all(hmma[k] for k in K9B_KERNELS if k.endswith("tc")):
        raise AssertionError(f"a tc kernel of K9b has no HMMA: {hmma}")
    main = timed[0]
    return {"name": "ssd_scan_bwd (K9b)", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
            "replaces": "none: autodiff of src/repro/models/mamba.py:71 "
                        "ssd_chunked",
            "max_abs_err": worst_abs, "max_err_rel": worst,
            "ms": main["ms"], "device_ms": main["device"]["median"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": None,
            "timed_shape": "B=4 H=64 S=4096 P=64 N=128 chunk 128 bf16",
            "hmma": hmma, "timed": timed}


def _serve_run(model, params, tokens, steps, cache_len=None, extra=None):
    """prefill(tokens), then ``steps`` greedy decode steps into a cache of
    ``cache_len`` positions (default: just enough), prefill and decode
    each timed by the host clock around work that ends in a synchronize.
    ``extra`` joins the prefill's batch (``frames``, or ``patches``,
    whose positions come first).  Returns (prefill ms, ms per decode
    step, cache, last token)."""
    extra = extra or {}
    b, s = tokens.shape
    s += extra["patches"].shape[1] if "patches" in extra else 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": tokens, **extra})
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    cache = model.alloc_cache(b, cache_len or s + steps, init=cache)
    tok = logits.argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        logits, cache = model.decode_step(params, cache, tok, s + i)
        tok = logits.argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / max(steps, 1)
    if logits.shape != (b, model.cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError("decode logits are not finite (B, V)")
    return prefill_ms, step_ms, cache, tok


def _consistency(arch, b, s, dtype, seed, **over):
    """prefill(S) then decode(token S) against prefill(S + 1)'s last
    logits on a full-width model in ``dtype`` (config fields ``over``
    replaced): argmax agreement and the largest logit difference."""
    cfg = dataclasses.replace(get_config(arch), param_dtype=dtype,
                              dtype=dtype, **over)
    model = LanguageModel(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    full = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                         device="cuda")
    with torch.no_grad():
        truth, _ = model.prefill(params, {"tokens": full})
        _, cache = model.prefill(params, {"tokens": full[:, :-1]})
        cache = model.alloc_cache(b, s + 1, init=cache)
        got, _ = model.decode_step(params, cache, full[:, -1:], s)
    agree = (got.argmax(-1) == truth.argmax(-1)).float().mean().item()
    d = (got.float() - truth.float())
    diff, rms = d.abs().max().item(), d.square().mean().sqrt().item()
    del model, params, cache
    torch.cuda.empty_cache()
    return {"dtype": dtype, "batch": b, "prompt": s, "argmax_agreement":
            agree, "max_logit_diff": diff, "rms_logit_diff": rms}


def _check_consistency(arch, b, s, seed):
    """The serving contract (tests/test_models.py): argmax agreement >=
    0.95, held on the full-width model in fp32, where prefill's chunked
    scan (K9) and decode's recurrence differ by summation order only
    (logits O(1): limit 5e-3).  The served bf16 model is held to a bound
    on its largest logit difference, 0.42 (2x the 0.21 an H100 showed):
    there the two paths round different intermediates to bf16, and the
    reference has that gap too (tests/test_torch_ssm_model.py::
    test_bf16_prefill_decode_gap_is_the_references); its argmax agreement,
    which such a gap can flip where the top two logits are close, is
    reported."""
    f32 = _consistency(arch, b, s, "float32", seed)
    bf16 = _consistency(arch, b, s, "bfloat16", seed)
    print(f"  consistency, prefill({s}) + decode vs prefill({s + 1}), B={b}:"
          f" fp32 argmax agreement {f32['argmax_agreement']:.3f} (limit "
          f">= 0.95), max logit diff {f32['max_logit_diff']:.3e} (limit "
          f"5e-3); bf16 max logit diff {bf16['max_logit_diff']:.3e} (limit "
          f"0.42), RMS {bf16['rms_logit_diff']:.3e}, argmax agreement "
          f"{bf16['argmax_agreement']:.3f} (reported)")
    if not (f32["argmax_agreement"] >= 0.95
            and f32["max_logit_diff"] <= 5e-3
            and bf16["max_logit_diff"] <= 0.42):
        raise AssertionError(f"{arch}: decode disagrees with prefill")
    return {"fp32": f32, "bf16": bf16}


def phase_ssm_serve():
    """mamba2-1.3b at full width, bf16: prefill 4 x 4096 (K9 on all 48
    layers), 32 decode steps; one 1 x 16384 prefill; consistency."""
    print("== ssm serve: mamba2-1.3b full width, bf16")
    cfg = dataclasses.replace(get_config("mamba2-1.3b"), param_dtype="bfloat16")
    model = LanguageModel(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(20))
    gen = torch.Generator(device="cuda").manual_seed(21)
    b, s, steps = 4, 4096, 32
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda")
    info = {}
    weights_gb = torch.cuda.memory_allocated() / 1e9
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        prefill_ms, step_ms, cache, tok = _serve_run(model, params, tokens,
                                                     steps)
        counts = _counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        info["routes"] = _check_k9_routes("prefill 4 x 4096", cfg.num_layers)
        want = {**{k: 0 for k in counts}, "k9": cfg.num_layers}
        print(f"  prefill {prefill_ms:.1f} ms (B=4 x 4096), decode step "
              f"{step_ms:.3f} ms (B=4); launches {counts}; peak device "
              f"memory {peak_gb:.2f} GB (weights {weights_gb:.2f} GB)")
        if counts != want:
            raise AssertionError(f"launches {counts}, want {want}")
        info.update(prefill_ms=prefill_ms, decode_step_ms=step_ms,
                    launches=counts, weights_gb=weights_gb,
                    peak_gb_4x4096=peak_gb)
        prof = _profile(lambda: model.decode_step(params, cache, tok,
                                                  s + steps), 3)
        _print_profile("ssm decode step (B=4)", prof, step_ms)
        info["decode_profile"] = prof
        del cache
        long = torch.randint(0, cfg.vocab_size, (1, 16384), generator=gen,
                             device="cuda")
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        prefill_long_ms, _, cache, _ = _serve_run(model, params, long, 0)
        counts = _counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        info["routes_16384"] = _check_k9_routes("prefill 1 x 16384",
                                                cfg.num_layers)
        print(f"  prefill {prefill_long_ms:.1f} ms (B=1 x 16384); launches "
              f"{counts}; peak device memory {peak_gb:.2f} GB")
        if counts != want:
            raise AssertionError(f"launches {counts}, want {want}")
        info.update(prefill_16384_ms=prefill_long_ms,
                    launches_16384=counts, peak_gb_1x16384=peak_gb)
        prof = _profile(lambda: model.prefill(params, {"tokens": long}), 1)
        _print_profile("ssm prefill (B=1 x 16384)", prof,
                       prof["profiled_wall_ms"])
        info["prefill_16384_profile"] = prof
    del model, params, cache
    torch.cuda.empty_cache()
    info["consistency"] = _check_consistency("mamba2-1.3b", 8, 1000, 22)
    return info


def phase_hybrid_serve():
    """zamba2-1.2b at full width, bf16: prefill 1 x 3000 (K9 on the 38
    Mamba layers, K1 on the 6 shared-attention applications), 16 decode
    steps (K5 6 times a step); consistency."""
    print("== hybrid serve: zamba2-1.2b full width, bf16")
    cfg = dataclasses.replace(get_config("zamba2-1.2b"), param_dtype="bfloat16")
    model = LanguageModel(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(30))
    g, rem = model._hybrid_segments()
    gen = torch.Generator(device="cuda").manual_seed(31)
    b, s, steps = 1, 3000, 16
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device="cuda")
    with torch.no_grad():
        _zero_counts()
        prefill_ms, step_ms, cache, tok = _serve_run(model, params, tokens,
                                                     steps)
        counts = _counts()
        routes = _check_k9_routes("prefill 1 x 3000", cfg.num_layers)
        want = {**{k: 0 for k in counts}, "k9": cfg.num_layers, "k1": g,
                "k5": g * steps}
        print(f"  {g} groups of {cfg.attn_every} + {rem}: prefill "
              f"{prefill_ms:.1f} ms (B=1 x 3000), decode step {step_ms:.3f} "
              f"ms (B=1); launches {counts}")
        if counts != want:
            raise AssertionError(f"launches {counts}, want {want}")
        prof = _profile(lambda: model.decode_step(params, cache, tok,
                                                  s + steps - 1), 3)
        _print_profile("hybrid decode step (B=1)", prof, step_ms)
    info = {"prefill_ms": prefill_ms, "decode_step_ms": step_ms,
            "launches": counts, "routes": routes, "decode_profile": prof}
    del model, params, cache
    torch.cuda.empty_cache()
    # S > 2048: the fp32 check runs the shared attention through K1 too
    info["consistency"] = _check_consistency("zamba2-1.2b", 4, 2100, 32)
    return info


def _ssm_reference():
    """Reduced fp32 mamba2 and zamba2 on the card (K9 at P=32, N=16)
    against the CPU's plain path: prefill logits and every cache leaf,
    then one decode step; at chunk 16 with a ragged 300-token prompt, and
    at chunk 128 with a 70-token prompt (the chunk is the prompt)."""
    print("  reduced fp32 mamba2 / zamba2, card vs CPU")
    worst = {}
    for arch, s, chunk in (("mamba2-1.3b", 300, 16), ("zamba2-1.2b", 300, 16),
                           ("mamba2-1.3b", 70, 128), ("zamba2-1.2b", 70, 128)):
        # the reduced config as it is: head_dim 32, K5 at width 64
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  ssm_chunk=chunk)
        gpu, cpu = LanguageModel(cfg, device="cuda"), LanguageModel(cfg, "cpu")
        params = cpu.init(torch.Generator().manual_seed(40))
        params_gpu = _tree_to(params, "cuda", copy=True)
        rng = np.random.RandomState(41)
        # s < flash_min_seq: the shared attention takes its plain branch
        tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, s)))
        _zero_counts()
        lg, cg = gpu.prefill(params_gpu, {"tokens": tokens.cuda()})
        torch.cuda.synchronize()
        k9 = ssd.ssd_scan.launches
        lc, cc = cpu.prefill(params, {"tokens": tokens})
        err = (lg.cpu() - lc).abs().max().item()
        cache_err = max((a.cpu().float() - c.float()).abs().max().item()
                        / max(c.float().abs().max().item(), 1e-30)
                        for (_, a), (_, c) in zip(iter_leaves(cg),
                                                  iter_leaves(cc)))
        cg = gpu.alloc_cache(2, s + 1, init=cg)
        cc = cpu.alloc_cache(2, s + 1, init=cc)
        tok = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 1)))
        lg, _ = gpu.decode_step(params_gpu, cg, tok.cuda(), s)
        lc, _ = cpu.decode_step(params, cc, tok, s)
        dec_err = (lg.cpu() - lc).abs().max().item()
        print(f"  {arch} S={s} chunk {chunk}: K9 launches {k9} (want "
              f"{cfg.num_layers}); prefill logits max_abs_err {err:.3e}, "
              f"caches {cache_err:.2e} of each leaf's max, decode logits "
              f"{dec_err:.3e} (limits 1e-4; fp32, logits O(1))")
        if k9 != cfg.num_layers or not max(err, cache_err, dec_err) <= 1e-4:
            raise AssertionError(f"{arch}: card and CPU disagree")
        worst[f"{arch} S={s} chunk {chunk}"] = {
            "prefill_logits": err, "cache_rel": cache_err,
            "decode_logits": dec_err}
    return worst


# --------------------------------------------------- §6.3 partition copy

MIB = 2 ** 20
COPY_COUNTERS = (pc.partition_copy, pc.multi_partition_copy_tiles,
                 pc.multi_partition_copy_staged)


def _copy_counts():
    return {"k6": pc.partition_copy.launches,
            "k7": pc.multi_partition_copy_tiles.launches,
            "k8": pc.multi_partition_copy_staged.launches}


def _zero_copy_counts():
    for fn in COPY_COUNTERS:
        fn.launches = 0


def _rand_rows(nbytes, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, 256, (nbytes // pc.LANES, pc.LANES),
                         dtype=torch.uint8, generator=gen, device="cuda")


def _ragged_set(size, parts):
    """``parts`` disjoint lane-aligned byte ranges covering most of a
    ``size``-byte buffer: ragged starts and lengths, sources permuted."""
    psize = size // parts
    return [(i * psize + 128 * (i % 3), ((i + 7) % parts) * psize,
             psize - 256 - 128 * (i % 5)) for i in range(parts)]


def _rows_of(ranges):
    return tuple((d // pc.LANES, s // pc.LANES, n // pc.LANES)
                 for d, s, n in ranges)


def _hazard_rows(nrows):
    """The reference's hazard pattern in rows: two ranges gathering the
    same source rows, adjacent destination ranges (the gap row between
    the last two), an odd row count, the tails of dst and of src."""
    return ((0, 1000, 512), (1024, 1000, 512), (1536, 256, 512),
            (2049, 256, 511), (nrows - 5001, 60_000, 5000),
            (40_000, nrows - 129, 128), (30_000, 30_000, 257))


def _copy_check(name, fn, dst, src, ranges, counter, route=None):
    """One call of a copy kernel against its plain version, bit for bit;
    the counter must rise by one, on descriptor ``route`` where given."""
    want = pc.multi_partition_copy_plain(dst.clone(), src, ranges)
    before = counter.launches
    got = fn(dst.clone(), src, ranges)
    torch.cuda.synchronize()
    if counter.launches != before + 1:
        raise AssertionError(f"{name}: the kernel did not launch once")
    taken = getattr(counter, "last_route", None)
    if route is not None and taken != route:
        raise AssertionError(f"{name}: took the {taken} route, not {route}")
    same = torch.equal(got, want)
    print(f"  {name}: {len(ranges)} ranges, "
          f"{sum(r for _, _, r in ranges) * pc.LANES / MIB:.3f} MiB, "
          f"route {taken}, bit-exact {same}")
    if not same:
        raise AssertionError(f"{name}: kernel disagrees with plain version")


def _copy_times(kernel, wrapper, plain, reps, flush):
    """CUDA-event ms of the bare kernel launch (the range descriptor
    already built; ``ms``) and of the same after a device spin (the
    device work alone; ``device_ms``), of the whole wrapper (its checks,
    the descriptor and the launch; ``wrapper_ms``) and the host µs a
    wrapper call takes, and of the plain version, each call after an L2
    flush."""
    return {"ms": _time_ms(kernel, reps, flush),
            "device_ms": _time_stats(kernel, reps, flush,
                                     spin=True)["median"],
            "wrapper_ms": _time_ms(wrapper, reps, flush),
            "wrapper_host_us": _host_us(wrapper),
            "plain_ms": _time_ms(plain, reps, flush)}


def _copy_bound(nbytes):
    """Bytes bound of a copy of ``nbytes``: read once, written once."""
    return _bound(0, 2 * nbytes, torch.bfloat16)


def _routes_check(name, launch, wrapper, dst, src, ranges, entry_rows,
                  counter, flush):
    """A set past ``MAX_PARAM_RANGES`` (its descriptor on the card) and
    the timed set ``ranges`` forced onto the card, each bit-exact with
    one launch, then timed device-only (and the first through the
    wrapper)."""
    many = _rows_of(_ragged_set(dst.numel(), 256))
    _copy_check(f"{name} 256 ragged ranges, past MAX_PARAM_RANGES", wrapper,
                dst, src, many, counter, "device")
    forced = pc.descriptor(ranges, entry_rows, "cuda", route="device")
    _copy_check(f"{name} {len(ranges)} ragged ranges, forced onto the card",
                lambda d, s_, r: launch(d, s_, forced), dst, src, ranges,
                counter, "device")
    many_desc = pc.descriptor(many, entry_rows, "cuda")
    return {"many_ranges": len(many),
            "many_device_ms": _time_stats(
                lambda: launch(dst, src, many_desc), 20, flush,
                spin=True)["median"],
            "many_wrapper_ms": _time_ms(lambda: wrapper(dst, src, many), 20,
                                        flush),
            "forced_device_route_device_ms": _time_stats(
                lambda: launch(dst, src, forced), 20, flush,
                spin=True)["median"]}


def phase_copy_kernels():
    """K6, K7 and K8 against their plain versions, then timed."""
    print("== K6, K7, K8 partition copy: kernels vs plain versions")
    flush = torch.empty(64 * MIB, dtype=torch.uint8, device="cuda")
    # K6: one 128 MiB range of 256 MiB buffers, 32 KiB-aligned
    dst, src = _rand_rows(256 * MIB, 400), _rand_rows(256 * MIB, 401)
    k6 = (32 * MIB // pc.LANES, 96 * MIB // pc.LANES, 128 * MIB // pc.LANES)
    want = pc.partition_copy_plain(dst.clone(), src, *k6)
    got = pc.partition_copy(dst.clone(), src, *k6)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("K6 disagrees with its plain version")
    print("  K6 128 MiB of 256 MiB: bit-exact True")
    del got, want
    d0, s0, rows = k6
    rows_out = {}
    k6_call = lambda: pc.partition_copy(dst, src, *k6)  # noqa: E731
    lib_call = lambda: dst[d0:d0 + rows].copy_(  # noqa: E731
        src[s0:s0 + rows])
    t = _copy_times(k6_call, k6_call,
                    lambda: pc.partition_copy_plain(dst, src, *k6), 20, flush)
    lib = _time_stats(lib_call, 20, flush)
    lib_device_ms = _time_stats(lib_call, 20, flush, spin=True)["median"]
    bound_ms, bound_by = _copy_bound(rows * pc.LANES)
    rows_out["k6"] = {**t, "library_ms": lib["median"], "library": lib,
                      "library_device_ms": lib_device_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "max_abs_err": 0.0,
                      "timed_shape": "one 128 MiB range of 256 MiB uint8 "
                                     "buffers, 32 KiB-aligned"}
    print(f"  K6: kernel {t['ms']:.4f} ms (wrapper {t['wrapper_ms']:.4f}, "
          f"device-only {t['device_ms']:.4f}), plain {t['plain_ms']:.4f} ms, "
          f"copy_ {_fmt(lib)} (device-only {lib_device_ms:.4f}), bound "
          f"{bound_ms:.4f} ms ({bound_by}: {2 * rows * pc.LANES / 1e6:.1f} "
          f"MB)")

    # K8: 256 MiB buffers
    nrows = dst.shape[0]
    k8_set = _rows_of(_ragged_set(256 * MIB, 64))
    staged = pc.multi_partition_copy_staged
    _copy_check("K8 64 ragged ranges, 256 MiB", pc.multi_partition_copy,
                dst, src, k8_set, staged, "param")
    _copy_check("K8 hazard pattern, 256 MiB", pc.multi_partition_copy,
                dst, src, _hazard_rows(nrows), staged, "param")
    for chunk in (16, 128):
        _copy_check(f"K8 hazard pattern, chunk {chunk}",
                    lambda d, s_, r: pc.multi_partition_copy_staged(
                        d, s_, r, chunk=chunk),
                    dst, src, _hazard_rows(nrows), staged, "param")
    k8_bytes = sum(r for _, _, r in k8_set) * pc.LANES
    chunk = plan_copy_chunk(k8_bytes // pc.LANES)
    desc = pc.descriptor(k8_set, chunk, "cuda")
    t = _copy_times(lambda: pc.launch_staged(dst, src, desc),
                    lambda: pc.multi_partition_copy(dst, src, k8_set),
                    lambda: pc.multi_partition_copy_plain(dst, src, k8_set),
                    20, flush)
    t.update(_routes_check("K8", pc.launch_staged, pc.multi_partition_copy,
                           dst, src, k8_set, chunk, staged, flush))
    bound_ms, bound_by = _copy_bound(k8_bytes)
    rows_out["k8"] = {**t, "library_ms": None,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "max_abs_err": 0.0, "chunk_rows": chunk,
                      "entries": desc.total, "descriptor_route": desc.route,
                      "timed_shape": f"64 ragged ranges, "
                                     f"{k8_bytes / MIB:.2f} MiB of 256 MiB "
                                     f"uint8 buffers"}
    print(f"  K8: kernel {t['ms']:.4f} ms (device-only {t['device_ms']:.4f};"
          f" wrapper {t['wrapper_ms']:.4f}, host {t['wrapper_host_us']:.1f} "
          f"us), plain (64 copy_ calls) {t['plain_ms']:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {2 * k8_bytes / 1e6:.1f} MB); "
          f"{desc.total} entries of {chunk} rows by value; 256 ranges on the"
          f" card: device-only {t['many_device_ms']:.4f}, wrapper "
          f"{t['many_wrapper_ms']:.4f}; the 64-range set forced onto the "
          f"card: device-only {t['forced_device_route_device_ms']:.4f}; no "
          f"single PyTorch call computes it")
    del dst, src

    # K7: 4 MiB and exactly-16 MiB buffers
    dst, src = _rand_rows(4 * MIB, 402), _rand_rows(4 * MIB, 403)
    tiles = pc.multi_partition_copy_tiles
    k7_set = _rows_of(_ragged_set(4 * MIB, 64))
    for name, ranges in (
            ("K7 one range", ((0, 1, 3),)),
            ("K7 three ranges", ((1, 0, 2), (8, 16, 1), (32, 4, 5))),
            ("K7 spanning tiles", ((0, 0, 300), (700, 350, 257))),
            ("K7 empty and one-row ranges",
             ((5, 9, 0), (0, 3, 1), (9, 9, 0), (1, 700, 300), (400, 0, 1))),
            ("K7 64 ranges of 7 rows",
             tuple((i * 8, ((i + 7) % 64) * 8, 7) for i in range(64))),
            ("K7 64 ragged ranges, 4 MiB", k7_set)):
        _copy_check(name, pc.multi_partition_copy, dst, src, ranges, tiles,
                    "param")
    k7_bytes = sum(r for _, _, r in k7_set) * pc.LANES
    desc = pc.descriptor(k7_set, pc.BLOCK_ROWS, "cuda")
    t = _copy_times(lambda: pc.launch_tiles(dst, src, desc),
                    lambda: pc.multi_partition_copy(dst, src, k7_set),
                    lambda: pc.multi_partition_copy_plain(dst, src, k7_set),
                    50, flush)
    t.update(_routes_check("K7", pc.launch_tiles, pc.multi_partition_copy,
                           dst, src, k7_set, pc.BLOCK_ROWS, tiles, flush))
    one_row = pc.descriptor(((0, 0, 1),), pc.BLOCK_ROWS, "cuda")
    t["floor_ms"] = _time_stats(lambda: pc.launch_tiles(dst, src, one_row),
                                50, flush, spin=True)["median"]
    bound_ms, bound_by = _copy_bound(k7_bytes)
    rows_out["k7"] = {**t, "library_ms": None,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "max_abs_err": 0.0, "entries": desc.total,
                      "descriptor_route": desc.route,
                      "timed_shape": f"64 ragged ranges, "
                                     f"{k7_bytes / MIB:.3f} MiB of 4 MiB "
                                     f"uint8 buffers"}
    print(f"  K7: kernel {t['ms']:.4f} ms (device-only {t['device_ms']:.4f};"
          f" wrapper {t['wrapper_ms']:.4f}, host {t['wrapper_host_us']:.1f} "
          f"us), plain (64 copy_ calls) {t['plain_ms']:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {2 * k7_bytes / 1e6:.2f} MB), "
          f"floor (one row, device-only) {t['floor_ms']:.4f} ms; "
          f"{desc.total} entries by value; 256 ranges on the card: "
          f"device-only {t['many_device_ms']:.4f}, wrapper "
          f"{t['many_wrapper_ms']:.4f}; the 64-range set forced onto the "
          f"card: device-only {t['forced_device_route_device_ms']:.4f}; no "
          f"single PyTorch call computes it")
    dst, src = _rand_rows(16 * MIB, 404), _rand_rows(16 * MIB, 405)
    _copy_check("K7 64 ragged ranges, exactly 16 MiB", pc.multi_partition_copy,
                dst, src, _rows_of(_ragged_set(16 * MIB, 64)), tiles, "param")
    del dst, src, desc, one_row, flush
    torch.cuda.empty_cache()
    return rows_out


def _partition_program(size, ranges, seed):
    """The §6 program: one task creates a data block and a shadow block
    and issues one ``db_copy`` per range at one virtual timestamp."""
    data = np.frombuffer(np.random.default_rng(seed).bytes(size), np.uint8)

    def body(api, out):
        block, ptr = api.db_create(size)
        ptr[:] = data
        api.db_release(block)
        shadow, _ = api.db_create(size)
        api.db_release(shadow)
        for d_off, s_off, n in ranges:
            api.db_copy(shadow, d_off, block, s_off, n)
        out["db"] = shadow
    return body, data


def _overlap_program(api, out):
    block, ptr = api.db_create(1024)
    ptr[:512] = 1
    ptr[512:] = 2
    api.db_release(block)
    shadow, _ = api.db_create(1024)
    api.db_release(shadow)
    api.db_copy(shadow, 0, block, 0, 512)
    api.db_copy(shadow, 256, block, 512, 512)   # overlaps the first dst
    out["db"] = shadow


def _read_after_write_program(api, out):
    b, ptr = api.db_create(4096)
    ptr[:] = 0
    ptr[:128] = 1
    api.db_release(b)
    api.db_copy(b, 1024, b, 0, 128)
    api.db_copy(b, 2048, b, 1024, 128)   # reads the first copy's dst
    out["db"] = b


def _run_program(body, backend, walls=None):
    rt = Runtime(copy_backend=backend)
    if walls is not None:
        fused = rt._fused_copy

        def timed(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ok = fused(*a)
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t0))
            return ok
        rt._fused_copy = timed
    out = {}

    def main(paramv, depv, api):
        body(api, out)
        return NULL_GUID

    spawn_main(rt, main)
    t0 = time.perf_counter()
    stats = rt.run()
    run_ms = 1e3 * (time.perf_counter() - t0)
    return rt.lookup(out["db"]).buffer.copy(), stats, run_ms


def _fused_copy_split(data, ranges, want):
    """The fused copy's three steps replayed on fresh buffers of the
    program's size, host clock and a sync around each: both blocks to
    the card, the kernel step (the range checks, the descriptor and the
    launch), dst back into the host buffer.  The result must equal the
    numpy backend's shadow ``want``."""
    dbuf, sbuf, split = np.zeros_like(data), data.copy(), {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        split[name] = 1e3 * (time.perf_counter() - t0)
        return out

    host_dst = torch.from_numpy(dbuf)
    dst, src = step("h2d_ms", lambda: (host_dst.to("cuda", copy=True),
                                       torch.from_numpy(sbuf).to("cuda")))
    step("kernel_ms", lambda: kernel_ops.multi_partition_copy_bytes_(
        dst, src, ranges))
    step("d2h_ms", lambda: host_dst.copy_(dst))
    if not np.array_equal(dbuf, want):
        raise AssertionError("the replayed fused copy differs")
    return split


def phase_copy_paths():
    """The paths: ops.partition_copy_bytes (K6), then the §6 program of
    64 partitions under Runtime(copy_backend="cuda") at 4 MiB (K7) and
    256 MiB (K8), and two programs that must not fuse."""
    print("== §6.3 copy paths: ops.partition_copy_bytes, "
          "Runtime(copy_backend='cuda')")
    info = {}
    dst, src = (_rand_rows(256 * MIB, 406).reshape(-1),
                _rand_rows(256 * MIB, 407).reshape(-1))
    kw = dict(dst_off=32 * MIB, src_off=96 * MIB, size=128 * MIB)
    _zero_copy_counts()
    got = kernel_ops.partition_copy_bytes(dst, src, **kw)
    torch.cuda.synchronize()
    counts = _copy_counts()
    want = dst.clone()
    want[32 * MIB:160 * MIB] = src[96 * MIB:224 * MIB]
    print(f"  ops.partition_copy_bytes 128 MiB of 256 MiB: launches {counts},"
          f" equal to slice assignment {torch.equal(got, want)}")
    if counts != {"k6": 1, "k7": 0, "k8": 0} or not torch.equal(got, want):
        raise AssertionError("partition_copy_bytes did not run K6 alone, or "
                             "its result is wrong")
    info["ops"] = counts
    del dst, src, got, want
    torch.cuda.empty_cache()

    for size, kernel in ((4 * MIB, "k7"), (256 * MIB, "k8")):
        ranges = _ragged_set(size, 64)
        body, data = _partition_program(size, ranges, seed=size // MIB)
        walls = []
        _zero_copy_counts()
        got, stats, run_ms = _run_program(body, "cuda", walls)
        counts = _copy_counts()
        route = {"k7": pc.multi_partition_copy_tiles,
                 "k8": pc.multi_partition_copy_staged}[kernel].last_route
        want, ref_stats, numpy_ms = _run_program(body, "numpy")
        same = np.array_equal(got, want)
        expect = {"k6": 0, "k7": 0, "k8": 0, kernel: 1}
        print(f"  §6 program, 64 partitions of a {size // MIB} MiB block: "
              f"shadow equal to the numpy backend's {same}; fused_copies "
              f"{stats.fused_copies}; launches {counts}, descriptor route "
              f"{route}; bytes_copied {stats.bytes_copied} "
              f"({ref_stats.bytes_copied} numpy)")
        if not (same and stats.fused_copies == 1 and counts == expect
                and route == "param"
                and stats.bytes_copied == ref_stats.bytes_copied):
            raise AssertionError(f"the {size // MIB} MiB program did not "
                                 f"take one fused {kernel} copy, or differs")
        split = _fused_copy_split(data, ranges, want)
        row = {"launches": counts, "fused_copy_ms": walls[0],
               "run_ms": run_ms, "numpy_run_ms": numpy_ms,
               "copied_bytes": stats.bytes_copied, "split": split}
        info[f"runtime_{size // MIB}mib"] = row
        print(f"    fused copy wall {walls[0]:.3f} ms; replayed: host->device "
              f"{split['h2d_ms']:.3f} ms, kernel step {split['kernel_ms']:.3f}"
              f" ms, device->host {split['d2h_ms']:.3f} ms; rt.run() "
              f"{run_ms:.1f} ms (numpy backend {numpy_ms:.1f} ms)")

    for name, body in (("overlapping destinations", _overlap_program),
                       ("read after write", _read_after_write_program)):
        _zero_copy_counts()
        got, stats, _ = _run_program(body, "cuda")
        counts = _copy_counts()
        want, _, _ = _run_program(body, "numpy")
        same = np.array_equal(got, want)
        print(f"  {name}: fused_copies {stats.fused_copies}, launches "
              f"{counts}, equal to the numpy backend {same}")
        if stats.fused_copies or any(counts.values()) or not same:
            raise AssertionError(f"{name}: the batch must replay in order")
    return info


# ------------------------------------------------------------------ MoE

ARCTIC = "arctic-480b"
# at lr 1e-3 (smollm's) the fresh router runs away within 6 steps and
# ce_loss rises from step 5: with fp32 moments as with int8 ones, and
# the reference's Trainer does the same on the CPU from the same weights
# (scripts/moe_lr_witness.py, PERF.md §6); 3e-4 keeps ce_loss falling
ARCTIC_TRAIN_ARGS = ["--arch", ARCTIC, "--data", "markov", "--batch", "4",
                     "--seq", "4096", "--steps", "6", "--lr", "3e-4",
                     "--device", "cuda"]
# one full-width MoE layer of 128 experts is 13.6 B parameters: with its
# gradients and int8 moments ~82 GB, past one card; 32 experts train
ARCTIC_TRAIN_EXPERTS = 32


def _release():
    """Frees what the deleted objects held on the card: a Trainer's
    runtime keeps its step closure, and so the train state, in a
    reference cycle that only the collector breaks."""
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _moe_record():
    """Records, per MoE layer call, the aux dict (``blocks.moe_ffn``) and
    the router's fp32 logits and chosen experts (``moe._route``)."""
    rec = {"aux": [], "route": []}
    ffn, route = blocks.moe_ffn, moe._route

    def ffn_rec(*args):
        y, aux = ffn(*args)
        rec["aux"].append({k: v.detach() for k, v in aux.items()})
        return y, aux

    def route_rec(logits, k):
        gates, idx = route(logits, k)
        rec["route"].append((logits.detach(), idx))
        return gates, idx

    blocks.moe_ffn, moe._route = ffn_rec, route_rec
    try:
        yield rec
    finally:
        blocks.moe_ffn, moe._route = ffn, route


def _arctic_flops(cfg, b, s, ctx, head_rows):
    """FLOPs of one forward of ``b`` x ``s`` new tokens whose attention
    reads ``ctx`` positions: the attention projections and core, the
    router, the grouped expert products over every expert's E x C
    capacity rows (the algorithm's work, empty slots included), the
    dense residual, and the LM head on ``head_rows`` rows."""
    t = b * s
    d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    e, f = cfg.num_experts, cfg.moe_d_ff
    c = moe._capacity(cfg, t)
    live = b * h * _live_pairs(s, ctx, ctx - s, True, 0)
    layer = (2 * t * d * hd * (2 * h + 2 * kh) + 4 * hd * live
             + 2 * t * d * e + 6 * e * c * d * f + 6 * t * d * cfg.d_ff)
    return cfg.num_layers * layer + 2 * head_rows * d * cfg.vocab_size


def _weight_bytes(params):
    """Bytes of every weight a forward reads whole (all but the
    embedding, of which it reads only its tokens' rows)."""
    return sum(x.numel() * x.element_size() for path, x in
               iter_leaves(params) if path[0] != "embedding")


def _split_step(model, oc, state, batch):
    """One train step in its two halves, each timed by the host clock to
    a synchronize: the loss and its gradients, then the AdamW update."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _loss, grads = _grads(model, state["params"], batch, "cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    it = iter(grads)

    def tree(node):
        return {k: tree(node[k]) if isinstance(node[k], dict) else next(it)
                for k in sorted(node)}
    adamw_update(oc, tree(state["params"]), state["params"], state["opt"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for _p, x in iter_leaves(state["params"]):
        x.requires_grad_(False)
    return 1e3 * (t1 - t0), 1e3 * (t2 - t1)


def phase_moe_serve():
    """arctic-480b at full width (d_model 7168, 56 heads over 8 kv heads
    of width 128, all 128 experts of width 4864, top-2, capacity factor
    1.25, the dense residual MLP), depth cut from 35 to 2 layers, bf16,
    seeded random weights: init without holding a bank twice, prefill 4 x
    2100 (K1 twice), 16 decode steps (K5 twice a step), each beside its
    bound; the prefill's drop counts; a second prefill the same bits."""
    print("== moe serve: arctic-480b full width, 2 of 35 layers, all 128 "
          "experts, bf16, prefill 4 x 2100, 16 decodes")
    cfg = dataclasses.replace(get_config(ARCTIC), num_layers=2)
    if not (cfg.num_experts == 128 and cfg.experts_per_token == 2
            and cfg.capacity_factor == 1.25 and cfg.moe_dense_residual
            and cfg.param_dtype == cfg.dtype == "bfloat16"):
        raise AssertionError("the config is not arctic's")
    model = LanguageModel(cfg, device="cuda")
    _release()                 # what earlier phases left in cycles
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(70))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(x.numel() for _p, x in iter_leaves(params))
    print(f"  {n_params / 1e9:.2f} B parameters, {weights_gb:.2f} GB; init "
          f"{init_s:.1f} s, peak {init_peak_gb:.2f} GB (no bank held twice)")
    b, s, steps = 4, 2100, 16
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(71))
    layers = cfg.num_layers
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        with _moe_record() as rec:
            prefill_ms, step_ms, cache, tok = _serve_run(model, params,
                                                         tokens, steps)
        counts = _counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = {**{k: 0 for k in counts}, "k1": layers, "k5": layers * steps}
        pre, dec = rec["aux"][:layers], rec["aux"][layers:]
        dropped = sum(float(a["dropped"]) for a in pre)
        routed = sum(float(a["routed"]) for a in pre)
        dec_dropped = sum(float(a["dropped"]) for a in dec)
        print(f"  prefill {prefill_ms:.1f} ms (B=4 x {s}), decode step "
              f"{step_ms:.3f} ms (B=4, cache {s + steps}); launches {counts};"
              f" peak device memory {peak_gb:.2f} GB; prefill drops "
              f"{dropped:.0f} of {routed:.0f} routed (token, choice) pairs "
              f"({dropped / routed:.4f}; capacity "
              f"{moe._capacity(cfg, b * s)} a layer and expert), decode "
              f"drops {dec_dropped:.0f}")
        if counts != want:
            raise AssertionError(f"launches {counts}, want {want}")
        if len(rec["aux"]) != layers * (1 + steps):
            raise AssertionError(f"{len(rec['aux'])} MoE layer calls")
        first, _ = model.prefill(params, {"tokens": tokens})
        again, _ = model.prefill(params, {"tokens": tokens})
        if not torch.equal(first, again):
            raise AssertionError("two arctic prefills gave other bits")
        del first, again
        prof_pre = _profile(lambda: model.prefill(params, {"tokens": tokens}),
                            1)
        _print_profile(f"arctic prefill ({b} x {s})", prof_pre,
                       prof_pre["profiled_wall_ms"])
        prof_dec = _profile(lambda: model.decode_step(params, cache, tok,
                                                      s + steps - 1), 3)
        _print_profile("arctic decode step (B=4)", prof_dec, step_ms)
    wbytes = _weight_bytes(params)
    el = 2
    kv = 2 * layers * b * cfg.num_kv_heads * cfg.head_dim * el
    pre_flops = _arctic_flops(cfg, b, s, s, b)
    pre_bytes = wbytes + b * s * cfg.d_model * el + kv * s
    pre_bound, pre_by = _bound(pre_flops, pre_bytes, torch.bfloat16)
    dec_flops = _arctic_flops(cfg, b, 1, s + steps, b)
    dec_bytes = wbytes + b * cfg.d_model * el + kv * (s + steps)
    dec_bound, dec_by = _bound(dec_flops, dec_bytes, torch.bfloat16)
    print(f"  prefill: wall {prefill_ms:.1f} ms the first (cold) call, "
          f"{prof_pre['profiled_wall_ms']:.1f} ms warm (profiled), device "
          f"busy {prof_pre['device_busy_ms'] or float('nan'):.1f} ms; bound "
          f"{pre_bound:.2f} ms ({pre_by}: {pre_flops / 1e12:.2f} TFLOP, "
          f"{pre_bytes / 1e9:.2f} GB)")
    print(f"  decode step: wall {step_ms:.2f} ms, device busy "
          f"{prof_dec['device_busy_ms'] or float('nan'):.2f} ms, idle share "
          f"{prof_dec.get('idle_share', float('nan')):.3f}; bound "
          f"{dec_bound:.2f} ms ({dec_by}: {dec_bytes / 1e9:.2f} GB, every "
          f"expert's weights, {dec_flops / 1e9:.1f} GFLOP)")
    info = {"num_layers": layers, "num_experts": cfg.num_experts,
            "params_b": n_params / 1e9, "weights_gb": weights_gb,
            "init_s": init_s, "init_peak_gb": init_peak_gb,
            "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
            "peak_gb": peak_gb, "launches": counts,
            "prefill_dropped": dropped, "prefill_routed": routed,
            "decode_dropped": dec_dropped,
            "prefill_bound_ms": pre_bound, "prefill_bound_by": pre_by,
            "prefill_tflop": pre_flops / 1e12, "prefill_gb": pre_bytes / 1e9,
            "decode_bound_ms": dec_bound, "decode_bound_by": dec_by,
            "decode_gb": dec_bytes / 1e9, "prefill_profile": prof_pre,
            "decode_profile": prof_dec}
    del model, params, cache, tokens, tok
    _release()
    return info


def phase_moe_train():
    """The Trainer as ``launch.train`` builds it (bf16 parameters, int8
    AdamW moments) for arctic-480b at full width, 2 layers and 32
    experts (top-2, capacity factor 1.25): 6 steps of 4 x 4096 at lr
    3e-4 (ce_loss falls; K1-lse 4 and K3 2 a step; the MoE gauges each
    step; the median beside a bound; peak memory; one profiled step),
    then 2 steps twice in deterministic mode (K2) from the same seed: the
    same bits."""
    # one micro-batch a step: the config's 4 would add an fp32
    # accumulator of the 7.6 B parameters (30 GB) beside the 52 GB this
    # phase peaks at
    cfg = dataclasses.replace(get_config(ARCTIC), num_layers=2,
                              num_experts=ARCTIC_TRAIN_EXPERTS,
                              train_accum_steps=1)
    print(f"== moe train: arctic-480b full width, 2 layers, "
          f"{cfg.num_experts} experts, " + " ".join(ARCTIC_TRAIN_ARGS))
    args = train_cli.parse_args(ARCTIC_TRAIN_ARGS)
    layers, steps = cfg.num_layers, args.steps
    _release()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    tr = _trainer(cfg, TrainerConfig(), argv=ARCTIC_TRAIN_ARGS)
    t0 = time.perf_counter()
    state = tr.run(tr.init_or_restore(
        torch.Generator(device="cuda").manual_seed(0)), steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    m_q = state["opt"]["m"]["layers"]["moe"]["w_gate"]["q"]
    w_gate = state["params"]["layers"]["moe"]["w_gate"]
    if not (m_q.dtype == torch.int8 and w_gate.dtype == torch.bfloat16
            and tuple(w_gate.shape) == (layers, cfg.num_experts,
                                        cfg.d_model, cfg.moe_d_ff)):
        raise AssertionError("not bf16 parameters with int8 moments")
    for h in tr.history:
        print(f"  step {h['step']}: ce_loss {h['ce_loss']:.4f} aux_loss "
              f"{h['aux_loss']:.4f} moe_dropped_tokens "
              f"{h['moe_dropped_tokens']:.0f} moe_overflow_rate "
              f"{h['moe_overflow_rate']:.4f} grad_norm {h['grad_norm']:.3f} "
              f"{h['step_time'] * 1e3:.1f} ms")
    want = {**{k: 0 for k in counts}, "k1_lse": 2 * layers * steps,
            "k3": layers * steps}
    print(f"  launches {counts} (want {want})")
    if counts != want:
        raise AssertionError(f"moe train: launches {counts}, want {want}")
    first, last = tr.history[0]["ce_loss"], tr.history[-1]["ce_loss"]
    if not (np.isfinite(last) and last < first):
        raise AssertionError(f"ce_loss {first} -> {last}: did not descend")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [1e3 * h["step_time"] for h in tr.history]
    n_params = sum(x.numel() for _p, x in iter_leaves(state["params"]))
    b, s = args.batch, args.seq
    # forward, its recompute under remat="layer" and a backward of twice
    # the forward; the head on every position for the loss
    flops = 4 * _arctic_flops(cfg, b, s, s, b * s)
    # bf16 weights read by the forward, the recompute and the backward,
    # bf16 gradients written and read, the update's bf16 weights and
    # int8 moments read and written
    nbytes = n_params * (3 * 2 + 2 * 2 + 2 * 2 + 2 * 2)
    bound_ms, bound_by = _bound(flops, nbytes, torch.bfloat16)
    print(f"  {n_params / 1e9:.2f} B parameters; {steps} steps in "
          f"{wall:.1f} s wall; step median {np.median(step_ms):.1f} ms "
          f"(steps 2-{steps} mean {np.mean(step_ms[1:]):.1f}); bound "
          f"{bound_ms:.1f} ms ({bound_by}: {flops / 1e12:.1f} TFLOP, "
          f"{nbytes / 1e9:.1f} GB); peak memory {peak_gb:.2f} GB")
    step_fn = tr._build()
    batch = {k: torch.from_numpy(v).cuda() for k, v in tr.data.get(0).items()}
    prof = _profile(lambda: step_fn(state, batch), 1)
    _print_profile(f"arctic train step (B={b} x {s})", prof,
                   prof["profiled_wall_ms"])
    grad_ms, update_ms = _split_step(tr.model, tr.oc, state, batch)
    print(f"  one step in halves: loss and gradients {grad_ms:.1f} ms, "
          f"AdamW update (int8 moments, {n_params / 1e9:.2f} B parameters) "
          f"{update_ms:.1f} ms")
    info = {"num_layers": layers, "num_experts": cfg.num_experts,
            "params_b": n_params / 1e9, "wall_s": wall, "step_ms": step_ms,
            "ce_loss": [h["ce_loss"] for h in tr.history],
            "aux_loss": [h["aux_loss"] for h in tr.history],
            "moe_dropped_tokens": [h["moe_dropped_tokens"]
                                   for h in tr.history],
            "moe_overflow_rate": [h["moe_overflow_rate"] for h in tr.history],
            "grad_norm": [h["grad_norm"] for h in tr.history],
            "peak_memory_gb": peak_gb, "launches": counts,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "grad_ms": grad_ms, "update_ms": update_ms,
            "step_profile": prof}
    del tr, state, step_fn, batch, m_q, w_gate
    _release()

    finals, det_counts = [], []
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(2):
            _zero_counts()
            tr = _trainer(cfg, TrainerConfig(), argv=ARCTIC_TRAIN_ARGS)
            st = tr.run(tr.init_or_restore(
                torch.Generator(device="cuda").manual_seed(0)), 2)
            torch.cuda.synchronize()
            det_counts.append(_counts())
            finals.append([p.cpu() for _p, p in iter_leaves(st["params"])])
            del tr, st
            _release()
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(torch.equal(a, c) for a, c in zip(*finals))
    want = {**{k: 0 for k in det_counts[0]}, "k1_lse": 2 * layers * 2,
            "k2_dq": layers * 2, "k2_dkv": layers * 2}
    print(f"  deterministic mode, 2 steps twice: final parameters the same "
          f"bits {same}; launches {det_counts[0]} (want {want})")
    if not same:
        raise AssertionError("arctic: deterministic reruns differ")
    if det_counts[0] != want or det_counts[1] != want:
        raise AssertionError(f"arctic deterministic: launches {det_counts}")
    info["deterministic"] = {"bit_exact": same, "launches": det_counts[0]}
    return info


def _route_flips(card, host):
    """Per MoE call, the (token) rows whose chosen experts differ between
    the card and the CPU; each must be a choice between two experts
    whose probabilities lie within 1e-5 on the card."""
    flips = 0
    for (lg, ig), (_lc, ic) in zip(card, host):
        ig = ig.cpu()
        probs = torch.softmax(lg.cpu(), dim=-1)
        for t in (ig != ic).any(-1).nonzero().flatten().tolist():
            a, b = ig[t][ig[t] != ic[t]], ic[t][ig[t] != ic[t]]
            gap = (probs[t, a] - probs[t, b]).abs().max().item()
            if gap > 1e-5:
                raise AssertionError(f"token {t}: experts {a.tolist()} on "
                                     f"the card, {b.tolist()} on the CPU, "
                                     f"probabilities {gap:.2e} apart")
            flips += 1
    return flips


# the card-vs-CPU references of MoE and MLA run 1 x REFERENCE_SEQ tokens
# with the flash gate lowered to REFERENCE_MIN_SEQ, so the fp32 kernels
# run on the card: the CPU side's time grows with the tokens
REFERENCE_SEQ = 576
REFERENCE_MIN_SEQ = 512


def phase_moe_reference():
    """arctic-480b at full width in fp32, 1 layer and 8 experts (1.52 B
    parameters), 1 x ``REFERENCE_SEQ`` tokens (past the lowered flash
    gate: K1, K1-lse and K3 run), on the
    card against the port's CPU path from the same weights: the routing
    of every MoE call (a choice may differ only between two experts whose
    probabilities lie within 1e-5), the prefill logits and 4 decode
    steps' (1e-3, fp32 logits O(1)), ``train_loss`` (1e-5 relative) and
    the gradient of every leaf (1e-4 of its largest entry): the
    tolerances of the danube train phase."""
    print(f"== moe reference: arctic-480b full width, fp32, 1 layer, 8 "
          f"experts, 1 x {REFERENCE_SEQ}, card vs CPU")
    cfg = dataclasses.replace(get_config(ARCTIC), num_layers=1,
                              num_experts=8, dtype="float32",
                              param_dtype="float32",
                              attn_flash_min_seq=REFERENCE_MIN_SEQ)
    gpu, cpu = LanguageModel(cfg, device="cuda"), LanguageModel(cfg, "cpu")
    _release()
    params = gpu.init(torch.Generator(device="cuda").manual_seed(72))
    params_cpu = _tree_to(params, "cpu")
    s, steps = REFERENCE_SEQ, 4
    toks = np.random.RandomState(73).randint(0, cfg.vocab_size,
                                             (1, s + steps + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :s]),
             "targets": torch.from_numpy(toks[:, 1:s + 1])}
    runs = {}
    for side, model, p in (("card", gpu, params), ("cpu", cpu, params_cpu)):
        dev = model.device
        t0 = time.perf_counter()
        _zero_counts()
        with torch.no_grad(), _moe_record() as rec:
            lg, cache = model.prefill(p, {"tokens": batch["tokens"].to(dev)})
            logits = [lg.cpu()]
            cache = model.alloc_cache(1, s + steps, init=cache)
            for i in range(steps):
                tok = torch.from_numpy(toks[:, s + i:s + i + 1]).to(dev)
                lg, cache = model.decode_step(p, cache, tok, s + i)
                logits.append(lg.cpu())
        serve_counts = _counts()
        serve_route = rec["route"]
        del cache
        _zero_counts()
        with _moe_record() as rec:
            loss, grads = _grads(model, p, batch, dev)
        grads = [g.cpu() for g in grads]
        runs[side] = {"logits": logits, "route": serve_route + rec["route"],
                      "loss": loss, "grads": grads,
                      "launches_serve": serve_counts,
                      "launches_train": _counts(),
                      "s": time.perf_counter() - t0}
        del grads
    card, host = runs["card"], runs["cpu"]
    flips = _route_flips(card["route"], host["route"])
    logit_err = max((a - c).abs().max().item()
                    for a, c in zip(card["logits"], host["logits"]))
    loss_err = abs(card["loss"] - host["loss"]) / abs(host["loss"])
    grad_err = max((a - c).abs().max().item()
                   / max(c.abs().max().item(), 1e-30)
                   for a, c in zip(card["grads"], host["grads"]))
    want_serve = {**{k: 0 for k in card["launches_serve"]}, "k1": 1,
                  "k5": steps}
    want_train = {**{k: 0 for k in card["launches_train"]}, "k1_lse": 2,
                  "k3": 1}
    print(f"  routing: {len(card['route'])} MoE calls, {flips} choices "
          f"differ (each within 1e-5 of probability); logits max_abs_err "
          f"{logit_err:.3e} (limit 1e-3; fp32, logits O(1)), loss rel err "
          f"{loss_err:.2e} (limit 1e-5), gradients {grad_err:.2e} of each "
          f"leaf's max (limit 1e-4); launches serve "
          f"{card['launches_serve']}, train {card['launches_train']}; card "
          f"{card['s']:.1f} s, CPU {host['s']:.1f} s")
    if card["launches_serve"] != want_serve or \
            card["launches_train"] != want_train:
        raise AssertionError(f"launches {card['launches_serve']} / "
                             f"{card['launches_train']}, want {want_serve} "
                             f"/ {want_train}")
    if len(card["route"]) != len(host["route"]) or \
            len(card["route"]) != 1 + steps + 2:
        raise AssertionError(f"MoE calls {len(card['route'])} / "
                             f"{len(host['route'])}")
    if not (logit_err <= 1e-3 and loss_err <= 1e-5 and grad_err <= 1e-4):
        raise AssertionError("arctic: card and CPU disagree")
    info = {"route_flips": flips, "logits_max_abs_err": logit_err,
            "loss_rel_err": loss_err, "grad_rel_err": grad_err,
            "launches_serve": card["launches_serve"],
            "launches_train": card["launches_train"],
            "card_s": card["s"], "cpu_s": host["s"]}
    del gpu, params, params_cpu, runs, card, host
    _release()
    return info


DEEPSEEK = "deepseek-v2-236b"
# the serve phase's depth, cut from 60: the dense first layer and 2 MoE
# layers of all 160 experts, fp32 master weights (~37.3 GB)
DEEPSEEK_SERVE_LAYERS = 3
# lr 3e-4 as arctic's (phase_moe_train): a fresh router runs away at 1e-3
DEEPSEEK_TRAIN_ARGS = ["--arch", DEEPSEEK, "--data", "markov", "--batch",
                       "4", "--seq", "4096", "--steps", "6", "--lr", "3e-4",
                       "--device", "cuda"]
# the dense first layer and 1 MoE layer: with all 160 experts that is 5.4
# B fp32 parameters, and a step holds ~14 B a parameter (the parameters,
# a micro-batch's gradients, the accumulator of the config's 4
# micro-batches, int8 moments) beside the MoE layer's bf16 cast and its
# gradient (~8 B a parameter of the layer): ~105 GB.  64 experts: 3.1 B
# parameters, ~60 GB.
DEEPSEEK_TRAIN_EXPERTS = 64


def _deepseek_cfg(**over):
    """deepseek-v2-236b as registered (checked: MLA with q/k 128 + 64 and
    v 128 over 128 heads, kv_lora_rank 512, 160 experts top-6 with 2
    shared, the dense first layer, fp32 master weights, bf16 compute,
    int8 moments, 4 micro-batches a step), then ``over`` replaced."""
    cfg = get_config(DEEPSEEK)
    if not (cfg.use_mla and cfg.d_model == 5120 and cfg.num_heads == 128
            and (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                 cfg.v_head_dim) == (128, 64, 128)
            and (cfg.q_lora_rank, cfg.kv_lora_rank) == (1536, 512)
            and (cfg.num_experts, cfg.experts_per_token,
                 cfg.num_shared_experts, cfg.first_k_dense) == (160, 6, 2, 1)
            and cfg.param_dtype == "float32" and cfg.dtype == "bfloat16"
            and cfg.optimizer_state_dtype == "int8"
            and cfg.train_accum_steps == 4):
        raise AssertionError("the config is not deepseek-v2-236b's")
    return dataclasses.replace(cfg, **over)


def _mla_flops(cfg, params, b, s, ctx, head_rows, decode=False):
    """FLOPs of one forward of ``b`` x ``s`` new tokens whose attention
    reads ``ctx`` positions: every projection on every token (two per
    weight), the expert banks on every expert's capacity rows (empty
    slots included: the reference's grouped GEMM), the attention (prefill
    on the full heads: S over dn + dr and P V over dv a live pair; decode
    in the latent space: scores over rkv + dr and the output over rkv a
    cached position), and the LM head on ``head_rows`` rows."""
    t = b * s
    c = moe._capacity(cfg, t)
    flops = 2 * head_rows * cfg.d_model * cfg.vocab_size
    for path, x in iter_leaves(params):
        if path[0] in ("embedding", "lm_head") or path[-1] == "scale":
            continue
        bank = "moe" in path and "shared" not in path and path[-1] != "router"
        flops += 2 * (c if bank else t) * x.numel()
    h, dr, rkv = cfg.num_heads, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    if decode:
        per_layer = 2 * (2 * rkv + dr) * h * b * ctx
    else:
        hd = cfg.qk_nope_head_dim + dr
        per_layer = 2 * (hd + cfg.v_head_dim) * h * b * _live_pairs(
            s, ctx, ctx - s, True, 0)
    return flops + cfg.num_layers * per_layer


def _mla_consistency(cfg, params, b=1, s=2100, seed=82):
    """prefill(S) + decode(token S) against prefill(S + 1)'s last logits
    on the serve phase's weights, in fp32 and in bf16 compute, at a
    capacity factor of experts / top-k, where a bucket holds every token,
    so neither path drops a (token, expert) pair (at 1.25 the last token
    of prefill(S + 1) is the likeliest dropped, and a decode step never
    drops)."""
    full = torch.randint(0, cfg.vocab_size, (b, s + 1), device="cuda",
                         generator=torch.Generator(
                             device="cuda").manual_seed(seed))
    out = {}
    for dtype in ("float32", "bfloat16"):
        model = LanguageModel(dataclasses.replace(
            cfg, dtype=dtype,
            capacity_factor=cfg.num_experts / cfg.experts_per_token), "cuda")
        with torch.no_grad(), _moe_record() as rec:
            truth, _ = model.prefill(params, {"tokens": full})
            _, cache = model.prefill(params, {"tokens": full[:, :-1]})
            cache = model.alloc_cache(b, s + 1, init=cache)
            got, _ = model.decode_step(params, cache, full[:, -1:], s)
        d = got.float() - truth.float()
        out[dtype] = {
            "batch": b, "prompt": s,
            "argmax_agreement": (got.argmax(-1) == truth.argmax(-1)).float()
            .mean().item(),
            "max_logit_diff": d.abs().max().item(),
            "rms_logit_diff": d.square().mean().sqrt().item(),
            "dropped": sum(float(a["dropped"]) for a in rec["aux"])}
        del model, cache, got, truth, rec
        torch.cuda.empty_cache()
    f32, bf16 = out["float32"], out["bfloat16"]
    print(f"  consistency, prefill({s}) + decode vs prefill({s + 1}), B={b},"
          f" capacity factor {cfg.num_experts / cfg.experts_per_token:.2f} "
          f"(drops {f32['dropped']:.0f} / {bf16['dropped']:.0f}): fp32 argmax"
          f" agreement {f32['argmax_agreement']:.3f} (limit >= 0.95), max "
          f"logit diff {f32['max_logit_diff']:.3e} (limit 5e-3); bf16 max "
          f"logit diff {bf16['max_logit_diff']:.3e}, RMS "
          f"{bf16['rms_logit_diff']:.3e}, argmax agreement "
          f"{bf16['argmax_agreement']:.3f} (reported)")
    if not (f32["argmax_agreement"] >= 0.95 and f32["max_logit_diff"] <= 5e-3
            and f32["dropped"] == 0 == bf16["dropped"]):
        raise AssertionError("deepseek: decode disagrees with prefill")
    return out


def phase_mla_serve():
    """deepseek-v2-236b at full width (d_model 5120, 128 MLA heads of q/k
    128 + 64 and v 128 over the 512-wide kv latent, the dense first
    layer's MLP at 12288, all 160 experts of width 1536, top-6, 2 shared
    experts), depth cut from 60 to 3 layers (the dense one and 2 MoE
    layers), fp32 master weights cast to bf16 per layer, seeded random
    weights: init, prefill 4 x 4096 (K1 at (192, 128) three times), 16
    decode steps (the latent-space decode, torch ops), each beside its
    bound and profiled; the latent cache's layout; the prefill's drops;
    prefill(S) + decode against prefill(S + 1)."""
    print("== mla serve: deepseek-v2-236b full width, 3 of 60 layers (the "
          "dense first layer and 2 MoE layers of all 160 experts), fp32 "
          "master weights, bf16 compute, prefill 4 x 4096, 16 decodes")
    cfg = _deepseek_cfg(num_layers=DEEPSEEK_SERVE_LAYERS)
    model = LanguageModel(cfg, device="cuda")
    _release()                 # what earlier phases left in cycles
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(80))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    init_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_params = sum(x.numel() for _p, x in iter_leaves(params))
    print(f"  {n_params / 1e9:.2f} B parameters, {weights_gb:.2f} GB; init "
          f"{init_s:.1f} s, peak {init_peak_gb:.2f} GB")
    b, s, steps = 4, 4096, 16
    tokens = torch.randint(0, cfg.vocab_size, (b, s), device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(81))
    layers, n_moe = cfg.num_layers, cfg.num_layers - cfg.first_k_dense
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        with _moe_record() as rec:
            prefill_ms, step_ms, cache, tok = _serve_run(model, params,
                                                         tokens, steps)
        counts = _counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = {**{k: 0 for k in counts}, "k1": layers}
        pre = rec["aux"][:n_moe]
        dropped = sum(float(a["dropped"]) for a in pre)
        routed = sum(float(a["routed"]) for a in pre)
        layout = {part: {k: tuple(v.shape) for k, v in c.items()}
                  for part, c in cache.items()}
        want_layout = {part: {"c_kv": (n, b, s + steps, cfg.kv_lora_rank),
                              "k_rope": (n, b, s + steps,
                                         cfg.qk_rope_head_dim)}
                       for part, n in (("dense", 1), ("layers", n_moe))}
        print(f"  prefill {prefill_ms:.1f} ms (B=4 x {s}), decode step "
              f"{step_ms:.3f} ms (B=4, cache {s + steps}); launches {counts};"
              f" peak device memory {peak_gb:.2f} GB; prefill drops "
              f"{dropped:.0f} of {routed:.0f} routed (token, choice) pairs "
              f"({dropped / routed:.4f}); latent caches {layout}")
        if counts != want:
            raise AssertionError(f"launches {counts}, want {want}")
        if len(rec["aux"]) != n_moe * (1 + steps):
            raise AssertionError(f"{len(rec['aux'])} MoE layer calls")
        if layout != want_layout:
            raise AssertionError(f"cache {layout}, want {want_layout}")
        prof_pre = _profile(lambda: model.prefill(params, {"tokens": tokens}),
                            1)
        _print_profile(f"deepseek prefill ({b} x {s})", prof_pre,
                       prof_pre["profiled_wall_ms"])
        prof_dec = _profile(lambda: model.decode_step(params, cache, tok,
                                                      s + steps - 1), 3)
        _print_profile("deepseek decode step (B=4)", prof_dec, step_ms)
        del cache
    # fp32 weights read once; the prefill's tokens and the latent caches
    wbytes = _weight_bytes(params)
    lat = layers * b * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2
    pre_flops = _mla_flops(cfg, params, b, s, s, b)
    pre_bytes = wbytes + b * s * cfg.d_model * 2 + lat * s
    pre_bound, pre_by = _bound(pre_flops, pre_bytes, torch.bfloat16)
    dec_flops = _mla_flops(cfg, params, b, 1, s + steps, b, decode=True)
    dec_bytes = wbytes + b * cfg.d_model * 2 + lat * (s + steps)
    dec_bound, dec_by = _bound(dec_flops, dec_bytes, torch.bfloat16)
    print(f"  prefill: wall {prefill_ms:.1f} ms the first (cold) call, "
          f"{prof_pre['profiled_wall_ms']:.1f} ms warm (profiled), device "
          f"busy {prof_pre['device_busy_ms'] or float('nan'):.1f} ms; bound "
          f"{pre_bound:.2f} ms ({pre_by}: {pre_flops / 1e12:.2f} TFLOP, "
          f"{pre_bytes / 1e9:.2f} GB)")
    print(f"  decode step: wall {step_ms:.2f} ms, device busy "
          f"{prof_dec['device_busy_ms'] or float('nan'):.2f} ms, idle share "
          f"{prof_dec.get('idle_share', float('nan')):.3f}; bound "
          f"{dec_bound:.2f} ms ({dec_by}: {dec_bytes / 1e9:.2f} GB, every "
          f"fp32 weight, {dec_flops / 1e9:.1f} GFLOP)")
    consistency = _mla_consistency(cfg, params)
    info = {"num_layers": layers, "num_experts": cfg.num_experts,
            "params_b": n_params / 1e9, "weights_gb": weights_gb,
            "init_s": init_s, "init_peak_gb": init_peak_gb,
            "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
            "peak_gb": peak_gb, "launches": counts, "cache": layout,
            "prefill_dropped": dropped, "prefill_routed": routed,
            "prefill_bound_ms": pre_bound, "prefill_bound_by": pre_by,
            "prefill_tflop": pre_flops / 1e12, "prefill_gb": pre_bytes / 1e9,
            "decode_bound_ms": dec_bound, "decode_bound_by": dec_by,
            "decode_gb": dec_bytes / 1e9, "prefill_profile": prof_pre,
            "decode_profile": prof_dec, "consistency": consistency}
    del model, params, tokens, tok
    _release()
    return info


def phase_mla_train():
    """The Trainer as ``launch.train`` builds it for deepseek-v2-236b
    (fp32 master weights, bf16 compute, int8 AdamW moments, the config's
    4 micro-batches a step) at full width with 2 layers (the dense first
    one and 1 MoE layer) and 64 experts: 6 steps of 4 x 4096 at lr 3e-4
    (ce_loss falls; K1-lse 4 and K3 2 a micro-batch; the MoE gauges each
    step; the median beside a bound; peak memory; the AdamW share; one
    profiled step), then 2 steps twice in deterministic mode (K2): the
    same bits."""
    cfg = _deepseek_cfg(num_layers=2, num_experts=DEEPSEEK_TRAIN_EXPERTS)
    print(f"== mla train: deepseek-v2-236b full width, 2 layers, "
          f"{cfg.num_experts} experts, " + " ".join(DEEPSEEK_TRAIN_ARGS))
    args = train_cli.parse_args(DEEPSEEK_TRAIN_ARGS)
    layers, steps = cfg.num_layers, args.steps
    _release()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    tr = _trainer(cfg, TrainerConfig(), argv=DEEPSEEK_TRAIN_ARGS)
    accum = tr.oc.accum_steps
    t0 = time.perf_counter()
    state = tr.run(tr.init_or_restore(
        torch.Generator(device="cuda").manual_seed(0)), steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    m_q = state["opt"]["m"]["layers"]["moe"]["w_gate"]["q"]
    w_gate = state["params"]["layers"]["moe"]["w_gate"]
    if not (accum == 4 and m_q.dtype == torch.int8
            and w_gate.dtype == torch.float32
            and tuple(w_gate.shape) == (1, cfg.num_experts, cfg.d_model,
                                        cfg.moe_d_ff)):
        raise AssertionError("not 4 micro-batches of fp32 parameters with "
                             "int8 moments")
    for h in tr.history:
        print(f"  step {h['step']}: ce_loss {h['ce_loss']:.4f} aux_loss "
              f"{h['aux_loss']:.4f} moe_dropped_tokens "
              f"{h['moe_dropped_tokens']:.0f} moe_overflow_rate "
              f"{h['moe_overflow_rate']:.4f} grad_norm {h['grad_norm']:.3f} "
              f"{h['step_time'] * 1e3:.1f} ms")
    want = {**{k: 0 for k in counts}, "k1_lse": 2 * layers * steps * accum,
            "k3": layers * steps * accum}
    print(f"  launches {counts} (want {want})")
    if counts != want:
        raise AssertionError(f"mla train: launches {counts}, want {want}")
    first, last = tr.history[0]["ce_loss"], tr.history[-1]["ce_loss"]
    if not (np.isfinite(last) and last < first):
        raise AssertionError(f"ce_loss {first} -> {last}: did not descend")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [1e3 * h["step_time"] for h in tr.history]
    n_params = sum(x.numel() for _p, x in iter_leaves(state["params"]))
    b, s = args.batch, args.seq
    mb = b // accum
    # each micro-batch: forward, its recompute under remat="layer" and a
    # backward of twice the forward, the head on every position
    flops = accum * 4 * _mla_flops(cfg, state["params"], mb, s, s, mb * s)
    # each micro-batch reads the fp32 weights in the forward, the
    # recompute and the backward and writes, then adds, fp32 gradients;
    # the update reads weights and gradients, writes weights, and reads
    # and writes the int8 moments
    nbytes = n_params * (accum * (3 * 4 + 3 * 4) + 3 * 4 + 2 * 2)
    bound_ms, bound_by = _bound(flops, nbytes, torch.bfloat16)
    print(f"  {n_params / 1e9:.2f} B parameters; {steps} steps in "
          f"{wall:.1f} s wall; step median {np.median(step_ms):.1f} ms "
          f"(steps 2-{steps} mean {np.mean(step_ms[1:]):.1f}); bound "
          f"{bound_ms:.1f} ms ({bound_by}: {flops / 1e12:.1f} TFLOP, "
          f"{nbytes / 1e9:.1f} GB); peak memory {peak_gb:.2f} GB")
    step_fn = tr._build()
    batch = {k: torch.from_numpy(v).cuda() for k, v in tr.data.get(0).items()}
    prof = _profile(lambda: step_fn(state, batch), 1)
    _print_profile(f"deepseek train step ({accum} x {mb} x {s})", prof,
                   prof["profiled_wall_ms"])
    micro = {k: v[:mb] for k, v in batch.items()}
    grad_ms, update_ms = _split_step(tr.model, tr.oc, state, micro)
    adamw_share = update_ms / float(np.median(step_ms))
    print(f"  one micro-batch's loss and gradients {grad_ms:.1f} ms; AdamW "
          f"update (int8 moments, {n_params / 1e9:.2f} B parameters) "
          f"{update_ms:.1f} ms, {adamw_share:.3f} of the step median")
    info = {"num_layers": layers, "num_experts": cfg.num_experts,
            "accum_steps": accum, "params_b": n_params / 1e9, "wall_s": wall,
            "step_ms": step_ms,
            "ce_loss": [h["ce_loss"] for h in tr.history],
            "aux_loss": [h["aux_loss"] for h in tr.history],
            "moe_dropped_tokens": [h["moe_dropped_tokens"]
                                   for h in tr.history],
            "moe_overflow_rate": [h["moe_overflow_rate"] for h in tr.history],
            "grad_norm": [h["grad_norm"] for h in tr.history],
            "peak_memory_gb": peak_gb, "launches": counts,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "micro_grad_ms": grad_ms, "update_ms": update_ms,
            "adamw_share": adamw_share, "step_profile": prof}
    del tr, state, step_fn, batch, micro, m_q, w_gate
    _release()

    finals, det_counts = [], []
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(2):
            _zero_counts()
            tr = _trainer(cfg, TrainerConfig(), argv=DEEPSEEK_TRAIN_ARGS)
            st = tr.run(tr.init_or_restore(
                torch.Generator(device="cuda").manual_seed(0)), 2)
            torch.cuda.synchronize()
            det_counts.append(_counts())
            finals.append([p.cpu() for _p, p in iter_leaves(st["params"])])
            del tr, st
            _release()
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(torch.equal(a, c) for a, c in zip(*finals))
    want = {**{k: 0 for k in det_counts[0]},
            "k1_lse": 2 * layers * 2 * accum, "k2_dq": layers * 2 * accum,
            "k2_dkv": layers * 2 * accum}
    print(f"  deterministic mode, 2 steps twice: final parameters the same "
          f"bits {same}; launches {det_counts[0]} (want {want})")
    if not same:
        raise AssertionError("deepseek: deterministic reruns differ")
    if det_counts[0] != want or det_counts[1] != want:
        raise AssertionError(f"deepseek deterministic: launches {det_counts}")
    info["deterministic"] = {"bit_exact": same, "launches": det_counts[0]}
    return info


def phase_mla_reference():
    """deepseek-v2-236b at full width in fp32 with 2 layers (the dense
    first one and 1 MoE layer of 8 experts; 1.78 B parameters), 1 x
    ``REFERENCE_SEQ`` tokens (past the lowered flash gate: the fp32 K1,
    K1-lse and K3 at (192, 128) run), on the
    card against the port's CPU path from the same weights: the routing
    of every MoE call, the prefill logits and 4 decode steps', the loss
    and every gradient, within the limits of ``phase_moe_reference``."""
    print(f"== mla reference: deepseek-v2-236b full width, fp32, dense + 1 "
          f"MoE layer of 8 experts, 1 x {REFERENCE_SEQ}, card vs CPU")
    cfg = _deepseek_cfg(num_layers=2, num_experts=8, dtype="float32",
                        attn_flash_min_seq=REFERENCE_MIN_SEQ)
    gpu, cpu = LanguageModel(cfg, device="cuda"), LanguageModel(cfg, "cpu")
    _release()
    params = gpu.init(torch.Generator(device="cuda").manual_seed(83))
    params_cpu = _tree_to(params, "cpu")
    s, steps = REFERENCE_SEQ, 4
    toks = np.random.RandomState(84).randint(0, cfg.vocab_size,
                                             (1, s + steps + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :s]),
             "targets": torch.from_numpy(toks[:, 1:s + 1])}
    runs = {}
    for side, model, p in (("card", gpu, params), ("cpu", cpu, params_cpu)):
        dev = model.device
        t0 = time.perf_counter()
        _zero_counts()
        with torch.no_grad(), _moe_record() as rec:
            lg, cache = model.prefill(p, {"tokens": batch["tokens"].to(dev)})
            logits = [lg.cpu()]
            cache = model.alloc_cache(1, s + steps, init=cache)
            for i in range(steps):
                tok = torch.from_numpy(toks[:, s + i:s + i + 1]).to(dev)
                lg, cache = model.decode_step(p, cache, tok, s + i)
                logits.append(lg.cpu())
        serve_counts = _counts()
        serve_route = rec["route"]
        del cache
        _zero_counts()
        with _moe_record() as rec:
            loss, grads = _grads(model, p, batch, dev)
        grads = [g.cpu() for g in grads]
        runs[side] = {"logits": logits, "route": serve_route + rec["route"],
                      "loss": loss, "grads": grads,
                      "launches_serve": serve_counts,
                      "launches_train": _counts(),
                      "s": time.perf_counter() - t0}
        del grads
    card, host = runs["card"], runs["cpu"]
    flips = _route_flips(card["route"], host["route"])
    logit_err = max((a - c).abs().max().item()
                    for a, c in zip(card["logits"], host["logits"]))
    loss_err = abs(card["loss"] - host["loss"]) / abs(host["loss"])
    grad_err = max((a - c).abs().max().item()
                   / max(c.abs().max().item(), 1e-30)
                   for a, c in zip(card["grads"], host["grads"]))
    layers = cfg.num_layers
    want_serve = {**{k: 0 for k in card["launches_serve"]}, "k1": layers}
    want_train = {**{k: 0 for k in card["launches_train"]},
                  "k1_lse": 2 * layers, "k3": layers}
    print(f"  routing: {len(card['route'])} MoE calls, {flips} choices "
          f"differ (each within 1e-5 of probability); logits max_abs_err "
          f"{logit_err:.3e} (limit 1e-3; fp32, logits O(1)), loss rel err "
          f"{loss_err:.2e} (limit 1e-5), gradients {grad_err:.2e} of each "
          f"leaf's max (limit 1e-4); launches serve "
          f"{card['launches_serve']}, train {card['launches_train']}; card "
          f"{card['s']:.1f} s, CPU {host['s']:.1f} s")
    if card["launches_serve"] != want_serve or \
            card["launches_train"] != want_train:
        raise AssertionError(f"launches {card['launches_serve']} / "
                             f"{card['launches_train']}, want {want_serve} "
                             f"/ {want_train}")
    if len(card["route"]) != len(host["route"]) or \
            len(card["route"]) != 1 + steps + 2:
        raise AssertionError(f"MoE calls {len(card['route'])} / "
                             f"{len(host['route'])}")
    if not (logit_err <= 1e-3 and loss_err <= 1e-5 and grad_err <= 1e-4):
        raise AssertionError("deepseek: card and CPU disagree")
    info = {"route_flips": flips, "logits_max_abs_err": logit_err,
            "loss_rel_err": loss_err, "grad_rel_err": grad_err,
            "launches_serve": card["launches_serve"],
            "launches_train": card["launches_train"],
            "card_s": card["s"], "cpu_s": host["s"]}
    del gpu, params, params_cpu, runs, card, host
    _release()
    return info


# deepseek-v2-236b's absorbed MLA route: one latent kv head of q/k 512 +
# 64 and v 512 (the (576, 512) pair) for all 128 query heads.  The fp32
# check's length lies past the 2048 flash gate and cuts a ragged last
# tile from every (576, 512) kernel's q and kv tiles (16, 32, 64 rows)
MLA_ABSORBED_PREFILL = (4, 4096)
MLA_ABSORBED_TRAIN = (1, 4096)
MLA_ABSORBED_CHECK = 2180


def _grad_leaves(params):
    """(tree, leaves): an MLA block's parameters (the norms' scales too)
    as fresh gradient leaves, in a tree of the block's layout."""
    leaf = {k: (v["scale"] if isinstance(v, dict) else v).detach()
            .requires_grad_() for k, v in params.items()}
    return ({k: {"scale": leaf[k]} if isinstance(v, dict) else leaf[k]
             for k, v in params.items()}, list(leaf.values()))


def _plain_flash(q, k, v, q_offset=0, *, causal=True, window=0, **_):
    """``ops.flash_attention``'s function (model layout) through the
    kernels' plain version, differentiable by autograd."""
    out = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), q_offset,
                                   causal=causal, window=window)
    return out.transpose(1, 2)


def _absorbed_train(params, x, w, cfg, pos):
    """``attention.mla_train`` forward and backward: the loss sum(out ·
    w) in fp32 and the gradients of every parameter and of x."""
    tree, leaves = _grad_leaves(params)
    xg = x.detach().requires_grad_()
    out = attention.mla_train(tree, xg, cfg, pos)
    loss = (out.float() * w.float()).sum()
    grads = torch.autograd.grad(loss, leaves + [xg])
    return loss.item(), grads


def phase_mla_absorbed():
    """deepseek-v2-236b's absorbed MLA route at full width, one attention
    block (d_model 5120, q_lora_rank 1536, 128 heads, kv_lora_rank 512,
    q/k 128 + 64, v 128) of seeded weights (``attention.mla_init``, fp32
    cast to bf16): ``mla_prefill`` at 4 x 4096 (K1 at (576, 512) once;
    the wall and the device's busy time; the latent caches equal
    ``_mla_kv_latents``' bits), ``mla_train`` forward and backward at 1 x
    4096 (K1-lse and K3 once), then again in deterministic mode (K1-lse,
    K2): every gradient finite and K3's within 2e-2 of each leaf's
    largest entry of K2's; then in fp32 at 1 x ``MLA_ABSORBED_CHECK`` the
    absorbed route against the dense route of the same functions (the
    flash gate raised for the dense side), as the reference's
    test_mla_flash_bwd_matches_dense holds it: loss (1e-3 + 1e-5
    relative), every gradient (1e-4 of its leaf's largest entry; that
    test's elementwise 1e-3 + 1e-3 |g| printed beside, for the kernels
    and for the route with their plain version in their place), prefill
    output (1e-4) and caches (1e-5)."""
    cfg = _deepseek_cfg()
    print("== mla absorbed: deepseek-v2-236b's attention block at full "
          "width on the absorbed route, one kv head of (576, 512) for 128 "
          "heads; bf16 prefill 4 x 4096 and train 1 x 4096, fp32 against "
          f"the dense route at 1 x {MLA_ABSORBED_CHECK}")
    bf, f32 = torch.bfloat16, torch.float32
    master = attention.mla_init(torch.Generator(device="cuda").manual_seed(85),
                                cfg)
    params = _tree_to(master, bf)
    info = {}

    b, s = MLA_ABSORBED_PREFILL
    x = _randn((b, s, cfg.d_model), bf, 86)
    pos = torch.arange(s, device="cuda")[None].expand(b, s)
    with torch.no_grad():
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        out, cache = attention.mla_prefill(params, x, cfg, pos)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = _counts()
        c_kv, k_rope = attention._mla_kv_latents(params, x, cfg, pos)
        same = (torch.equal(cache["c_kv"], c_kv)
                and torch.equal(cache["k_rope"], k_rope[:, :, 0]))
        finite = bool(torch.isfinite(out).all())
        prof = _profile(lambda: attention.mla_prefill(params, x, cfg, pos),
                        2)
    _print_profile(f"prefill {b} x {s}", prof, prof["profiled_wall_ms"])
    print(f"  prefill {b} x {s}: first call {wall:.1f} ms, launches "
          f"{counts}; output {tuple(out.shape)} finite {finite}; caches "
          f"equal _mla_kv_latents' bits {same}")
    _want_launches("absorbed prefill", counts,
                   {**dict.fromkeys(counts, 0), "k1": 1})
    if not (same and finite and out.shape == (b, s, cfg.d_model)):
        raise AssertionError("absorbed prefill: output or caches wrong")
    info["prefill"] = {"first_call_ms": wall, "launches": counts, **prof}
    del x, pos, out, cache, c_kv, k_rope
    torch.cuda.empty_cache()

    b, s = MLA_ABSORBED_TRAIN
    x = _randn((b, s, cfg.d_model), bf, 87)
    w = _randn((b, s, cfg.d_model), bf, 88)
    pos = torch.arange(s, device="cuda")[None].expand(b, s)
    runs = {}
    for mode in ("default", "deterministic"):
        torch.use_deterministic_algorithms(mode == "deterministic")
        try:
            torch.cuda.synchronize()
            _zero_counts()
            t0 = time.perf_counter()
            loss, grads = _absorbed_train(params, x, w, cfg, pos)
            torch.cuda.synchronize()
            runs[mode] = {"wall_ms": (time.perf_counter() - t0) * 1e3,
                          "launches": _counts(), "loss": loss,
                          "grads": grads}
        finally:
            torch.use_deterministic_algorithms(False)
    k3, k2 = runs["default"], runs["deterministic"]
    none = dict.fromkeys(k3["launches"], 0)
    _want_launches("absorbed train", k3["launches"],
                   {**none, "k1_lse": 1, "k3": 1})
    _want_launches("absorbed train, deterministic", k2["launches"],
                   {**none, "k1_lse": 1, "k2_dq": 1, "k2_dkv": 1})
    finite = all(bool(torch.isfinite(g).all()) for r in (k3, k2)
                 for g in r["grads"])
    # K3's dq differs from K2's by its summation order (phase_k_train
    # holds the kernels' outputs at this shape: dk, dv the same bits, dq
    # within 2^-7; K3's dq twice the same bits); through the bf16 projections each leaf's gradient stays
    # within the repo's bf16 limit, 2e-2 of its largest entry
    leaf_diff = [((a.float() - c.float()).abs().max()
                  / c.float().abs().max().clamp_min(1e-30)).item()
                 for a, c in zip(k3["grads"], k2["grads"])]
    print(f"  train {b} x {s}: forward and backward {k3['wall_ms']:.1f} ms "
          f"(K3), {k2['wall_ms']:.1f} ms (deterministic: K2), first calls; "
          f"launches {k3['launches']} / {k2['launches']}; loss "
          f"{k3['loss']:.6g} / {k2['loss']:.6g}; every gradient finite "
          f"{finite}; K3's gradients against K2's, max diff / max over "
          f"the leaves {max(leaf_diff):.3e} (limit 2e-2)")
    if not (finite and max(leaf_diff) <= 2e-2):
        raise AssertionError("absorbed train: K2's and K3's gradients "
                             "disagree or one is not finite")
    info["train"] = {"wall_ms": k3["wall_ms"], "launches": k3["launches"],
                     "loss": k3["loss"],
                     "leaf_max_diff_over_max": leaf_diff}
    info["train_deterministic"] = {"wall_ms": k2["wall_ms"],
                                   "launches": k2["launches"],
                                   "loss": k2["loss"]}
    del x, w, pos, runs, k3, k2
    torch.cuda.empty_cache()

    # fp32: the absorbed route (the fp32 kernels) against the dense route
    s = MLA_ABSORBED_CHECK
    flash_cfg = dataclasses.replace(cfg, dtype="float32")
    dense_cfg = dataclasses.replace(flash_cfg, attn_flash_min_seq=1 << 20)
    assert attention.flash_min_seq(flash_cfg) < s <= \
        attention.flash_min_seq(dense_cfg)
    x = _randn((1, s, cfg.d_model), f32, 89)
    pos = torch.arange(s, device="cuda")[None]
    sides = {}
    for name, c in (("absorbed", flash_cfg), ("plain", flash_cfg),
                    ("dense", dense_cfg)):
        # "plain": the absorbed route with the kernels' plain version
        # (autograd through it) in their place, the yardstick of their
        # fp32 error
        with (mock.patch.object(kernel_ops, "flash_attention", _plain_flash)
              if name == "plain" else contextlib.nullcontext()):
            _zero_counts()
            tree, leaves = _grad_leaves(master)
            xg = x.detach().requires_grad_()
            loss = torch.sin(attention.mla_train(tree, xg, c, pos)).sum()
            grads = torch.autograd.grad(loss, leaves + [xg])
            train_counts = _counts()
            _zero_counts()
            with torch.no_grad():
                out, cache = attention.mla_prefill(master, x, c, pos)
        sides[name] = {"loss": loss.item(), "grads": grads, "out": out,
                       "cache": cache, "train": train_counts,
                       "prefill": _counts()}
        del tree, leaves, xg, loss
    fl, pl, de = sides["absorbed"], sides["plain"], sides["dense"]
    none = dict.fromkeys(fl["train"], 0)
    _want_launches("fp32 absorbed train", fl["train"],
                   {**none, "k1_lse": 1, "k3": 1})
    _want_launches("fp32 absorbed prefill", fl["prefill"], {**none, "k1": 1})
    _want_launches("fp32 plain train", pl["train"], none)
    _want_launches("fp32 dense train", de["train"], none)
    loss_err = abs(fl["loss"] - de["loss"])
    # each gradient within 1e-4 of its leaf's largest entry (as
    # phase_mla_reference): the reference's elementwise 1e-3 + 1e-3 |g|,
    # set at its reduced widths' O(1) gradients, does not scale to
    # w_dkv's, which reach ~2e3 here and lose ~5e-3 to fp32 summation
    # order on entries near zero, the plain version's too: both ratios
    # are printed beside
    def of_max(side):
        return max(((a - c).abs().max() / c.abs().max().clamp_min(1e-30))
                   .item() for a, c in zip(side["grads"], de["grads"]))

    def elementwise(side):
        return max(((a - c).abs() / (1e-3 + 1e-3 * c.abs())).max().item()
                   for a, c in zip(side["grads"], de["grads"]))
    grad_err, grad_ratio = of_max(fl), elementwise(fl)
    plain_err, plain_ratio = of_max(pl), elementwise(pl)
    out_ratio = ((fl["out"] - de["out"]).abs()
                 / (1e-4 + 1e-4 * de["out"].abs())).max().item()
    cache_ratio = max(((fl["cache"][k] - de["cache"][k]).abs()
                       / (1e-5 + 1e-5 * de["cache"][k].abs())).max().item()
                      for k in ("c_kv", "k_rope"))
    print(f"  fp32 1 x {s}, absorbed vs dense: loss {fl['loss']:.6g} vs "
          f"{de['loss']:.6g} (|diff| {loss_err:.3e}, limit 1e-3 + 1e-5 "
          f"|loss|); gradients {grad_err:.3e} of each leaf's max (limit "
          f"1e-4; the plain version {plain_err:.3e}), elementwise "
          f"{grad_ratio:.3f} of 1e-3 + 1e-3 |g| (the plain version "
          f"{plain_ratio:.3f}; reported), prefill output {out_ratio:.3f} "
          f"of 1e-4 + 1e-4 |o|, "
          f"caches {cache_ratio:.3f} of 1e-5 + 1e-5 |c|; launches train "
          f"{fl['train']}, prefill {fl['prefill']}")
    if not (loss_err <= 1e-3 + 1e-5 * abs(de["loss"]) and grad_err <= 1e-4
            and out_ratio <= 1 and cache_ratio <= 1):
        raise AssertionError("fp32: the absorbed route disagrees with the "
                             "dense route")
    info["fp32"] = {"seq": s, "loss_abs_diff": loss_err,
                    "grad_rel_err": grad_err,
                    "grad_elementwise_of_1e-3": grad_ratio,
                    "plain_grad_rel_err": plain_err,
                    "plain_grad_elementwise_of_1e-3": plain_ratio,
                    "out_of_limit": out_ratio,
                    "cache_of_limit": cache_ratio,
                    "launches_train": fl["train"],
                    "launches_prefill": fl["prefill"]}
    del master, params, x, pos, sides, fl, pl, de
    torch.cuda.empty_cache()
    return info


# ---------------------------------------------- encoder-decoder and VLM

WHISPER = "whisper-small"
LLAVA = "llava-next-mistral-7b"
# whisper's decoder context, 448 positions (arXiv:2212.04356): the serve
# prompt
WHISPER_PROMPT = 448
WHISPER_TRAIN_ARGS = ["--arch", WHISPER, "--data", "markov", "--batch", "4",
                      "--seq", "4096", "--steps", "6", "--lr", "1e-3",
                      "--device", "cuda"]
# 576 patches + 3520 text tokens = 4096 positions, the repo's train shape
# for llava (launch/specs.py); lr 3e-4 as the other phases at d_model
# 4096 and wider
LLAVA_TRAIN_ARGS = ["--arch", LLAVA, "--data", "markov", "--batch", "4",
                    "--seq", "3520", "--steps", "6", "--lr", "3e-4",
                    "--device", "cuda"]
# 4 of 32 layers: 1.135 B fp32 parameters, ~18 GB with their gradients
# and fp32 moments before activations (all 32 would need ~116 GB)
LLAVA_TRAIN_LAYERS = 4


def _whisper_cfg(**over):
    """whisper-small as registered (checked: 12 encoder + 12 decoder
    layers, d_model 768, 12 heads over 12 kv heads of 64, d_ff 3072,
    vocab 51865, 1504 frames, fp32 master weights, bf16 compute), then
    ``over`` replaced."""
    cfg = get_config(WHISPER)
    if not (cfg.family == "encdec" and cfg.num_layers == 12
            and cfg.num_encoder_layers == 12 and cfg.d_model == 768
            and cfg.num_heads == cfg.num_kv_heads == 12
            and cfg.head_dim == 64 and cfg.d_ff == 3072
            and cfg.vocab_size == 51865 and cfg.encoder_seq == 1504
            and cfg.param_dtype == "float32" and cfg.dtype == "bfloat16"):
        raise AssertionError("the config is not whisper-small's")
    return dataclasses.replace(cfg, **over)


def _llava_cfg(**over):
    """llava-next-mistral-7b as registered (checked: the mistral-7b
    decoder, 32 layers, d_model 4096, 32 heads over 8 kv heads of 128,
    d_ff 14336, window 4096, vocab 32000, 576 patches, fp32 master
    weights, bf16 compute), then ``over`` replaced."""
    cfg = get_config(LLAVA)
    if not (cfg.family == "vlm" and cfg.num_layers == 32
            and cfg.d_model == 4096 and cfg.num_heads == 32
            and cfg.num_kv_heads == 8 and cfg.head_dim == 128
            and cfg.d_ff == 14336 and cfg.sliding_window == 4096
            and cfg.vocab_size == 32000 and cfg.num_patches == 576
            and cfg.param_dtype == "float32" and cfg.dtype == "bfloat16"):
        raise AssertionError("the config is not llava-next-mistral-7b's")
    return dataclasses.replace(cfg, **over)


def _embeddings(shape, seed):
    """Seeded frontend embeddings on the card (a normal x 0.02, fp32, as
    the reference's tests draw them): both configs' frontends are stubs
    that take precomputed frames or patches."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return 0.02 * torch.randn(shape, generator=gen, device="cuda")


class _Embedded:
    """A Trainer's data object: the batches of ``tokens`` (a
    ``SyntheticTokens``) with seeded frontend embeddings (a normal x
    0.02, fp32 numpy) under ``key``: whisper's ``frames`` or llava's
    ``patches``, ``length`` x d_model a row."""

    def __init__(self, tokens, key, length, width, seed):
        self.tokens, self.key, self.seed = tokens, key, seed
        self.shape = (tokens.batch, length, width)

    def get(self, step):
        batch = dict(self.tokens.get(step))
        rng = np.random.default_rng(self.seed + step)
        batch[self.key] = 0.02 * rng.standard_normal(self.shape,
                                                     dtype=np.float32)
        return batch


def _embedded_trainer(cfg, argv, key, length):
    """The port's Trainer as ``launch.train`` builds it from ``argv``,
    fed by ``_Embedded`` batches."""
    args = train_cli.parse_args(argv)
    oc = train_cli.optimizer_config(cfg, args)
    data = _Embedded(SyntheticTokens(cfg.vocab_size, args.batch, args.seq,
                                     seed=0, mode="markov"),
                     key, length, cfg.d_model, seed=1)
    return Trainer(LanguageModel(cfg, device="cuda"), oc, data,
                   TrainerConfig())


def _encdec_flops(cfg, b, s, ctx, head_rows, encode=True):
    """FLOPs of one whisper forward of ``b`` x ``s`` decoder tokens whose
    self-attention reads ``ctx`` positions: with ``encode`` the encoder
    over b x ``encoder_seq`` frames (projections, MLP, unmasked
    attention) and the cross K / V projections of its output; the
    decoder's projections, MLP, causal self-attention and cross attention
    over the encoder states; the LM head on ``head_rows`` rows."""
    d, h, kh, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    se = cfg.encoder_seq
    t, te = b * s, b * se
    flops = 2 * head_rows * d * cfg.vocab_size
    if encode:
        flops += cfg.num_encoder_layers * (8 * te * d * h * hd
                                           + 4 * te * d * f
                                           + 4 * hd * h * b * se * se)
        flops += cfg.num_layers * 4 * te * d * h * hd
    live = b * h * _live_pairs(s, ctx, ctx - s, True, 0)
    return flops + cfg.num_layers * (
        2 * t * d * hd * (2 * h + 2 * kh) + 4 * hd * live
        + 4 * t * d * h * hd + 4 * hd * h * t * se + 4 * t * d * f)


def _dense_flops(cfg, b, s, ctx, head_rows):
    """FLOPs of one forward of llava's decoder (mistral-7b) on ``b`` x
    ``s`` new positions (patches included) whose windowed attention
    reads ``ctx`` positions: projections, SwiGLU MLP, attention over the
    live pairs, the LM head on ``head_rows`` rows."""
    d, h, kh, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    t = b * s
    live = b * h * _live_pairs(s, ctx, ctx - s, True, cfg.sliding_window)
    return cfg.num_layers * (2 * t * d * hd * (2 * h + 2 * kh)
                             + 4 * hd * live + 6 * t * d * f) \
        + 2 * head_rows * d * cfg.vocab_size


def _prefix_consistency(cfg, params, tokens, extra):
    """prefill(S) + decode(token S) against prefill(S + 1)'s last logits
    on the serve phase's weights, the same frames or patches in both
    prefills, in fp32 and in bf16 compute; decode at ``cur_len`` = P + S
    (P patches, 0 for frames)."""
    b, s = tokens.shape[0], tokens.shape[1] - 1
    pre = extra["patches"].shape[1] if "patches" in extra else 0
    out = {}
    for dtype in ("float32", "bfloat16"):
        model = LanguageModel(dataclasses.replace(cfg, dtype=dtype), "cuda")
        with torch.no_grad():
            truth, _ = model.prefill(params, {"tokens": tokens, **extra})
            _, cache = model.prefill(params, {"tokens": tokens[:, :-1],
                                              **extra})
            cache = model.alloc_cache(b, pre + s + 1, init=cache)
            got, _ = model.decode_step(params, cache, tokens[:, -1:],
                                       pre + s)
        d = got.float() - truth.float()
        out[dtype] = {
            "batch": b, "prompt": pre + s,
            "argmax_agreement": (got.argmax(-1) == truth.argmax(-1)).float()
            .mean().item(),
            "max_logit_diff": d.abs().max().item(),
            "rms_logit_diff": d.square().mean().sqrt().item()}
        del model, cache, got, truth
        torch.cuda.empty_cache()
    f32, bf16 = out["float32"], out["bfloat16"]
    print(f"  consistency, prefill({pre} + {s}) + decode vs prefill({pre} + "
          f"{s + 1}), B={b}: fp32 argmax agreement "
          f"{f32['argmax_agreement']:.3f} (limit >= 0.95), max logit diff "
          f"{f32['max_logit_diff']:.3e} (limit 5e-3); bf16 max logit diff "
          f"{bf16['max_logit_diff']:.3e}, RMS {bf16['rms_logit_diff']:.3e}, "
          f"argmax agreement {bf16['argmax_agreement']:.3f} (reported)")
    if not (f32["argmax_agreement"] >= 0.95
            and f32["max_logit_diff"] <= 5e-3):
        raise AssertionError(f"{cfg.name}: decode disagrees with prefill")
    return out


def _init_report(model, seed):
    """Seeded init on the card: (params, info) with the parameter count,
    weight bytes, init seconds and init peak memory, printed."""
    _release()                 # what earlier phases left in cycles
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    info = {"init_s": time.perf_counter() - t0,
            "params_b": sum(x.numel() for _p, x in iter_leaves(params)) / 1e9,
            "weights_gb": torch.cuda.memory_allocated() / 1e9,
            "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"  {info['params_b']:.3f} B parameters, {info['weights_gb']:.2f} "
          f"GB; init {info['init_s']:.1f} s, peak {info['init_peak_gb']:.2f} "
          "GB")
    return params, info


def _print_bound(what, wall_ms, prof, flops, nbytes):
    """A step's wall, device busy and idle share (from ``prof``) beside
    its bf16 bound, printed; returns the bound."""
    bound, by = _bound(flops, nbytes, torch.bfloat16)
    print(f"  {what}: wall {wall_ms:.2f} ms, device busy "
          f"{prof['device_busy_ms'] or float('nan'):.2f} ms, idle share "
          f"{prof.get('idle_share', float('nan')):.3f}; bound {bound:.3f} ms "
          f"({by}: {flops / 1e12:.3f} TFLOP, {nbytes / 1e9:.2f} GB)")
    return {"bound_ms": bound, "bound_by": by, "tflop": flops / 1e12,
            "gb": nbytes / 1e9}


def phase_encdec_serve():
    """whisper-small at full width (12 encoder + 12 decoder layers, d_model
    768, 12 heads of 64), fp32 master weights cast to bf16 per layer,
    seeded random weights and frames: prefill of a 4 x 448 prompt (its
    decoder context) over 4 x 1504 frames (the dense attention, as in the
    reference), 32 decode steps (K5 12 times a step), both profiled
    beside their bounds, the caches' layout (self k / v head-major with
    12 kv heads, cross k / v seq-major); a 1 x 4096 prefill (K1 12
    times, G 1, hd 64); prefill(S) + decode against prefill(S + 1)."""
    print("== encdec serve: whisper-small full width (12 + 12 layers), fp32 "
          "master weights, bf16 compute, frames 4 x 1504, prompt 4 x 448, "
          "32 decodes; prefill 1 x 4096")
    cfg = _whisper_cfg()
    model = LanguageModel(cfg, device="cuda")
    params, info = _init_report(model, 90)
    b, s, steps = 4, WHISPER_PROMPT, 32
    layers, se = cfg.num_layers, cfg.encoder_seq
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    frames = _embeddings((b, se, cfg.d_model), 91)
    gen = torch.Generator(device="cuda").manual_seed(92)
    tokens = torch.randint(0, cfg.vocab_size, (b, s + 1), device="cuda",
                           generator=gen)
    long = torch.randint(0, cfg.vocab_size, (1, 4096), device="cuda",
                         generator=gen)
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        prefill_ms, step_ms, cache, tok = _serve_run(
            model, params, tokens[:, :s], steps, extra={"frames": frames})
        counts = _counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = {**{k: 0 for k in counts}, "k5": layers * steps}
        layout = {k: tuple(v.shape) for k, v in cache["layers"].items()}
        want_layout = {"k": (layers, b, kh, s + steps, hd),
                       "v": (layers, b, kh, s + steps, hd),
                       "cross_k": (layers, b, se, h, hd),
                       "cross_v": (layers, b, se, h, hd)}
        print(f"  prefill {prefill_ms:.1f} ms (B=4 x {s}, frames 4 x {se}), "
              f"decode step {step_ms:.3f} ms (B=4, cache {s + steps}); "
              f"launches {counts}; peak device memory {peak_gb:.2f} GB; "
              f"caches {layout}")
        if counts != want:
            raise AssertionError(f"launches {counts}, want {want}")
        if layout != want_layout:
            raise AssertionError(f"cache {layout}, want {want_layout}")
        batch = {"tokens": tokens[:, :s], "frames": frames}
        prof_pre = _profile(lambda: model.prefill(params, batch), 1)
        _print_profile(f"whisper prefill ({b} x {s})", prof_pre,
                       prof_pre["profiled_wall_ms"])
        prof_dec = _profile(lambda: model.decode_step(params, cache, tok,
                                                      s + steps - 1), 3)
        _print_profile("whisper decode step (B=4)", prof_dec, step_ms)
        del cache
        long_batch = {"tokens": long, "frames": frames[:1]}
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, c_long = model.prefill(params, long_batch)
        torch.cuda.synchronize()
        long_ms = 1e3 * (time.perf_counter() - t0)
        long_counts = _counts()
        want_long = {**{k: 0 for k in long_counts}, "k1": layers}
        print(f"  prefill 1 x 4096: {long_ms:.1f} ms; launches {long_counts}")
        if long_counts != want_long or lg.shape != (1, cfg.vocab_size) or \
                not torch.isfinite(lg).all():
            raise AssertionError(f"1 x 4096 prefill: launches {long_counts}, "
                                 f"want {want_long}; or its logits")
        del c_long
        prof_long = _profile(lambda: model.prefill(params, long_batch), 1)
        _print_profile("whisper prefill (1 x 4096)", prof_long,
                       prof_long["profiled_wall_ms"])
    # fp32 weights read once (decode: the decoder's, less the cross K / V
    # projections, whose output is cached); bf16 frames / tokens in,
    # caches written or read
    wbytes = _weight_bytes(params)
    dec_w = sum(x.numel() * x.element_size() for path, x in
                iter_leaves(params) if path[0] in ("dec_layers", "lm_head",
                                                    "final_norm")
                and path[1:3] not in (("cross", "w_k"), ("cross", "w_v")))
    cross = layers * 2 * b * se * h * hd * 2

    def kv(ctx, bb=b):
        return layers * 2 * bb * kh * ctx * hd * 2
    bounds = {
        "prefill": _print_bound(
            "prefill", prof_pre["profiled_wall_ms"], prof_pre,
            _encdec_flops(cfg, b, s, s, b),
            wbytes + b * se * cfg.d_model * 4 + cross + kv(s)),
        "decode": _print_bound(
            "decode step", step_ms, prof_dec,
            _encdec_flops(cfg, b, 1, s + steps, b, encode=False),
            dec_w + cross + kv(s + steps)),
        "prefill_4096": _print_bound(
            "prefill 1 x 4096", prof_long["profiled_wall_ms"], prof_long,
            _encdec_flops(cfg, 1, 4096, 4096, 1),
            wbytes + se * cfg.d_model * 4 + cross // b + kv(4096, 1))}
    consistency = _prefix_consistency(cfg, params, tokens,
                                      {"frames": frames})
    info.update({"prefill_ms": prefill_ms, "decode_step_ms": step_ms,
                 "prefill_4096_ms": long_ms, "peak_gb": peak_gb,
                 "launches": counts, "launches_4096": long_counts,
                 "cache": layout, "bounds": bounds,
                 "prefill_profile": prof_pre, "decode_profile": prof_dec,
                 "prefill_4096_profile": prof_long,
                 "consistency": consistency})
    del model, params, frames, tokens, long, tok
    _release()
    return info


def _train_phase(name, cfg, argv, key, length, deterministic):
    """The Trainer as ``launch.train`` builds it from ``argv``, fed by
    seeded frames or patches: every step's ce_loss falls from the first,
    K1-lse twice and K3 once a decoder layer a step (remat="layer"), the
    ``tokens`` metric exactly B x S (the text; patches carry no loss),
    step median beside its bound, peak memory, one profiled step; with
    ``deterministic``, 2 steps twice in deterministic mode (K2): the same
    bits."""
    args = train_cli.parse_args(argv)
    layers, steps, b, s = cfg.num_layers, args.steps, args.batch, args.seq
    _release()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    tr = _embedded_trainer(cfg, argv, key, length)
    t0 = time.perf_counter()
    state = tr.run(tr.init_or_restore(
        torch.Generator(device="cuda").manual_seed(0)), steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    for hh in tr.history:
        print(f"  step {hh['step']}: ce_loss {hh['ce_loss']:.4f} tokens "
              f"{hh['tokens']:.0f} grad_norm {hh['grad_norm']:.3f} "
              f"{hh['step_time'] * 1e3:.1f} ms")
    want = {**{k: 0 for k in counts}, "k1_lse": 2 * layers * steps,
            "k3": layers * steps}
    print(f"  launches {counts} (want {want}: with remat='layer' K1 with lse "
          f"runs twice a decoder layer, K3 once)")
    if counts != want:
        raise AssertionError(f"{name} train: launches {counts}, want {want}")
    first, last = tr.history[0]["ce_loss"], tr.history[-1]["ce_loss"]
    if not (np.isfinite(last) and last < first):
        raise AssertionError(f"ce_loss {first} -> {last}: did not descend")
    if any(hh["tokens"] != b * s for hh in tr.history):
        raise AssertionError(f"tokens {[hh['tokens'] for hh in tr.history]},"
                             f" want {b * s} a step")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [1e3 * hh["step_time"] for hh in tr.history]
    n_params = sum(x.numel() for _p, x in iter_leaves(state["params"]))
    # forward, its recompute under remat="layer" and a backward of twice
    # the forward, the head on every position; the fp32 weights read in
    # the forward, the recompute and the backward, fp32 gradients written
    # then added; the update reads weights, gradients and both fp32
    # moments and writes weights and moments
    if cfg.family == "encdec":
        fwd = _encdec_flops(cfg, b, s, s, b * s)
    else:
        fwd = _dense_flops(cfg, b, length + s, length + s,
                           b * (length + s))
    flops = 4 * fwd
    nbytes = n_params * (3 * 4 + 3 * 4 + 7 * 4)
    bound_ms, bound_by = _bound(flops, nbytes, torch.bfloat16)
    print(f"  {n_params / 1e9:.3f} B parameters; {steps} steps in "
          f"{wall:.1f} s wall; step median {np.median(step_ms):.1f} ms "
          f"(steps 2-{steps} mean {np.mean(step_ms[1:]):.1f}); bound "
          f"{bound_ms:.1f} ms ({bound_by}: {flops / 1e12:.1f} TFLOP, "
          f"{nbytes / 1e9:.1f} GB); peak memory {peak_gb:.2f} GB")
    step_fn = tr._build()
    batch = {k: torch.from_numpy(v).cuda() for k, v in tr.data.get(0).items()}
    prof = _profile(lambda: step_fn(state, batch), 1)
    _print_profile(f"{name} train step ({b} x {s})", prof,
                   prof["profiled_wall_ms"])
    info = {"num_layers": layers, "params_b": n_params / 1e9,
            "wall_s": wall, "step_ms": step_ms,
            "ce_loss": [hh["ce_loss"] for hh in tr.history],
            "tokens": [hh["tokens"] for hh in tr.history],
            "grad_norm": [hh["grad_norm"] for hh in tr.history],
            "peak_memory_gb": peak_gb, "launches": counts,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "step_profile": prof}
    del tr, state, step_fn, batch
    _release()
    if not deterministic:
        return info
    finals, det_counts = [], []
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(2):
            _zero_counts()
            tr = _embedded_trainer(cfg, argv, key, length)
            st = tr.run(tr.init_or_restore(
                torch.Generator(device="cuda").manual_seed(0)), 2)
            torch.cuda.synchronize()
            det_counts.append(_counts())
            finals.append([p.cpu() for _p, p in iter_leaves(st["params"])])
            del tr, st
            _release()
    finally:
        torch.use_deterministic_algorithms(False)
    same = all(torch.equal(a, c) for a, c in zip(*finals))
    want = {**{k: 0 for k in det_counts[0]}, "k1_lse": 2 * layers * 2,
            "k2_dq": layers * 2, "k2_dkv": layers * 2}
    print(f"  deterministic mode, 2 steps twice: final parameters the same "
          f"bits {same}; launches {det_counts[0]} (want {want})")
    if not same:
        raise AssertionError(f"{name}: deterministic reruns differ")
    if det_counts[0] != want or det_counts[1] != want:
        raise AssertionError(f"{name} deterministic: launches {det_counts}")
    info["deterministic"] = {"bit_exact": same, "launches": det_counts[0]}
    return info


def phase_encdec_train():
    """whisper-small at full width: 6 Trainer steps of 4 x 4096 decoder
    tokens (the repo's train shape) over 4 x 1504 frames, fp32 master
    weights and moments, bf16 compute (K1-lse 24 and K3 12 a step), then
    2 steps twice in deterministic mode (K2)."""
    print("== encdec train: whisper-small full width, frames 4 x 1504, "
          + " ".join(WHISPER_TRAIN_ARGS))
    cfg = _whisper_cfg()
    return _train_phase("whisper", cfg, WHISPER_TRAIN_ARGS, "frames",
                        cfg.encoder_seq, deterministic=True)


def phase_vlm_serve():
    """llava-next-mistral-7b at full width, all 32 layers (7.24 B
    parameters), fp32 master weights (29.0 GB) cast to bf16 per layer,
    seeded random weights and patches: prefill 2 x (576 patches + 4624
    text) = 2 x 5200 positions (K1 32 times, the 4096 window binding),
    16 decode steps at ``cur_len`` 5200-5215 (K5 32 times a step), both
    profiled beside their bounds, the caches' layout, and prefill(S) +
    decode against prefill(S + 1) with the patches in both (1 x 5200)."""
    print("== vlm serve: llava-next-mistral-7b full width, 32 layers, fp32 "
          "master weights, bf16 compute, prefill 2 x (576 patches + 4624 "
          "text), 16 decodes")
    cfg = _llava_cfg()
    model = LanguageModel(cfg, device="cuda")
    params, info = _init_report(model, 100)
    b, s, steps, p = 2, 4624, 16, cfg.num_patches
    layers, kh, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    patches = _embeddings((b, p, cfg.d_model), 101)
    tokens = torch.randint(0, cfg.vocab_size, (b, s + 1), device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(102))
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        prefill_ms, step_ms, cache, tok = _serve_run(
            model, params, tokens[:, :s], steps, extra={"patches": patches})
        counts = _counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = {**{k: 0 for k in counts}, "k1": layers,
                "k5": layers * steps}
        layout = {k: tuple(v.shape) for k, v in cache["layers"].items()}
        want_layout = {n: (layers, b, kh, p + s + steps, hd)
                       for n in ("k", "v")}
        print(f"  prefill {prefill_ms:.1f} ms (B=2 x ({p} + {s}), window "
              f"{cfg.sliding_window}), decode step {step_ms:.3f} ms (B=2, "
              f"cur_len {p + s}-{p + s + steps - 1}); launches {counts}; "
              f"peak device memory {peak_gb:.2f} GB; caches {layout}")
        if counts != want:
            raise AssertionError(f"launches {counts}, want {want}")
        if layout != want_layout:
            raise AssertionError(f"cache {layout}, want {want_layout}")
        batch = {"tokens": tokens[:, :s], "patches": patches}
        prof_pre = _profile(lambda: model.prefill(params, batch), 1)
        _print_profile(f"llava prefill ({b} x {p + s})", prof_pre,
                       prof_pre["profiled_wall_ms"])
        prof_dec = _profile(lambda: model.decode_step(
            params, cache, tok, p + s + steps - 1), 3)
        _print_profile("llava decode step (B=2)", prof_dec, step_ms)
        del cache
    wbytes = _weight_bytes(params)

    def kv(ctx):
        return layers * 2 * b * kh * min(ctx, cfg.sliding_window) * hd * 2
    bounds = {
        "prefill": _print_bound(
            "prefill", prof_pre["profiled_wall_ms"], prof_pre,
            _dense_flops(cfg, b, p + s, p + s, b),
            wbytes + b * p * cfg.d_model * 4 + layers * 2 * b * kh
            * (p + s) * hd * 2),
        "decode": _print_bound(
            "decode step", step_ms, prof_dec,
            _dense_flops(cfg, b, 1, p + s + steps, b),
            wbytes + kv(p + s + steps))}
    consistency = _prefix_consistency(cfg, params, tokens[:1],
                                      {"patches": patches[:1]})
    info.update({"prefill_ms": prefill_ms, "decode_step_ms": step_ms,
                 "peak_gb": peak_gb, "launches": counts, "cache": layout,
                 "bounds": bounds, "prefill_profile": prof_pre,
                 "decode_profile": prof_dec, "consistency": consistency})
    del model, params, patches, tokens, tok
    _release()
    return info


def phase_vlm_train():
    """llava-next-mistral-7b at full width, 4 of 32 layers: 6 Trainer
    steps of 4 x (576 patches + 3520 text) at lr 3e-4, fp32 master
    weights and moments, bf16 compute (K1-lse 8 and K3 4 a step; the
    ``tokens`` metric exactly 4 x 3520)."""
    print(f"== vlm train: llava-next-mistral-7b full width, "
          f"{LLAVA_TRAIN_LAYERS} of 32 layers, patches 4 x 576, "
          + " ".join(LLAVA_TRAIN_ARGS))
    cfg = _llava_cfg(num_layers=LLAVA_TRAIN_LAYERS)
    return _train_phase("llava", cfg, LLAVA_TRAIN_ARGS, "patches",
                        cfg.num_patches, deterministic=False)


def _prefix_reference(name, cfg, key, length, s, seed):
    """``cfg`` in fp32 on the card against the port's CPU path from the
    same weights, 1 x ``s`` tokens with ``length`` seeded frames or
    patches: prefill logits and one decode step's (K1 and K5 once a
    decoder layer), ``train_loss`` and every gradient (K1-lse twice and
    K3 once a decoder layer), within the limits of
    ``phase_mla_reference``."""
    gpu, cpu = LanguageModel(cfg, device="cuda"), _cpu_model(cfg)
    _release()
    params = gpu.init(torch.Generator(device="cuda").manual_seed(seed))
    params_cpu = _tree_to(params, "cpu")
    rng = np.random.RandomState(seed + 1)
    toks = rng.randint(0, cfg.vocab_size, (1, s + 2))
    extra = torch.from_numpy((0.02 * rng.standard_normal(
        (1, length, cfg.d_model))).astype(np.float32))
    pre = length if key == "patches" else 0
    batch = {"tokens": torch.from_numpy(toks[:, :s]),
             "targets": torch.from_numpy(toks[:, 1:s + 1]), key: extra}
    runs = {}
    for side, model, p in (("card", gpu, params), ("cpu", cpu, params_cpu)):
        dev = model.device
        t0 = time.perf_counter()
        _zero_counts()
        with torch.no_grad():
            lg, cache = model.prefill(p, {"tokens": batch["tokens"].to(dev),
                                          key: extra.to(dev)})
            logits = [lg.cpu()]
            cache = model.alloc_cache(1, pre + s + 1, init=cache)
            lg, cache = model.decode_step(
                p, cache, torch.from_numpy(toks[:, s:s + 1]).to(dev), pre + s)
            logits.append(lg.cpu())
        serve_counts = _counts()
        del cache
        _zero_counts()
        loss, grads = _grads(model, p, batch, dev)
        runs[side] = {"logits": logits, "loss": loss,
                      "grads": [g.cpu() for g in grads],
                      "launches_serve": serve_counts,
                      "launches_train": _counts(),
                      "s": time.perf_counter() - t0}
        del grads
    card, host = runs["card"], runs["cpu"]
    logit_err = max((a - c).abs().max().item()
                    for a, c in zip(card["logits"], host["logits"]))
    loss_err = abs(card["loss"] - host["loss"]) / abs(host["loss"])
    grad_err = max((a - c).abs().max().item()
                   / max(c.abs().max().item(), 1e-30)
                   for a, c in zip(card["grads"], host["grads"]))
    layers = cfg.num_layers
    want_serve = {**{k: 0 for k in card["launches_serve"]}, "k1": layers,
                  "k5": layers}
    want_train = {**{k: 0 for k in card["launches_train"]},
                  "k1_lse": 2 * layers, "k3": layers}
    print(f"  logits max_abs_err {logit_err:.3e} (limit 1e-3; fp32, logits "
          f"O(1)), loss rel err {loss_err:.2e} (limit 1e-5), gradients "
          f"{grad_err:.2e} of each leaf's max (limit 1e-4); launches serve "
          f"{card['launches_serve']}, train {card['launches_train']}; card "
          f"{card['s']:.1f} s, CPU {host['s']:.1f} s")
    if card["launches_serve"] != want_serve or \
            card["launches_train"] != want_train:
        raise AssertionError(f"launches {card['launches_serve']} / "
                             f"{card['launches_train']}, want {want_serve} "
                             f"/ {want_train}")
    if not (logit_err <= 1e-3 and loss_err <= 1e-5 and grad_err <= 1e-4):
        raise AssertionError(f"{name}: card and CPU disagree")
    info = {"logits_max_abs_err": logit_err, "loss_rel_err": loss_err,
            "grad_rel_err": grad_err,
            "launches_serve": card["launches_serve"],
            "launches_train": card["launches_train"],
            "card_s": card["s"], "cpu_s": host["s"]}
    del gpu, params, params_cpu, runs, card, host
    _release()
    return info


def phase_encdec_reference():
    """whisper-small at full width in fp32 with 2 encoder + 2 decoder
    layers, 1 x 2304 decoder tokens (> 2048: K1, K1-lse and K3 at G 1, hd
    64) over 1504 frames, card vs CPU."""
    print("== encdec reference: whisper-small full width, fp32, 2 + 2 "
          "layers, 1 x 2304 over 1504 frames, card vs CPU")
    cfg = _whisper_cfg(num_layers=2, num_encoder_layers=2, dtype="float32")
    return _prefix_reference("whisper", cfg, "frames", cfg.encoder_seq, 2304,
                             110)


def phase_vlm_reference():
    """llava-next-mistral-7b at full width in fp32 with 1 layer, 1 x (576
    patches + 1728 text) = 2304 positions (> 2048: K1, K1-lse and K3 at G
    4, hd 128), card vs CPU."""
    print("== vlm reference: llava-next-mistral-7b full width, fp32, 1 "
          "layer, 1 x (576 + 1728), card vs CPU")
    cfg = _llava_cfg(num_layers=1, dtype="float32")
    return _prefix_reference("llava", cfg, "patches", cfg.num_patches, 1728,
                             120)


# --------------------------------------------------------------- the mesh

# ------------------------------------------------ the port's example scripts

EXAMPLES = Path(__file__).resolve().parent / "examples"


def _example(name):
    """The module of ``examples/<name>.py``, loaded by path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example_run(fn, *args, **kwargs):
    """(``fn``'s result, its wall in s, the kernels it launched): the
    kernel and copy counters zeroed just before and read just after."""
    _zero_counts()
    _zero_copy_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = {**_counts(), **_copy_counts()}
    return out, wall, {k: v for k, v in counts.items() if v}


def phase_examples():
    """The port's four example scripts (``examples/torch_*.py``) in this
    process on cuda:0 at the reference examples' sizes: the quickstart's
    lines equal to the same script's on the CPU; the wavefront's order
    and makespan equal to its CPU run's and its pipeline output equal to
    the sequential stages bit for bit on the card (the script asserts
    it); serving reduced llama3.2-3b, mamba2-1.3b and zamba2-1.2b (B 4, a
    24-token prompt, 12 tokens: K5 in decode, K9 in the SSM and hybrid
    prefills); training reduced llama 240 steps with a fail-stop at 150,
    a restart from the last committed checkpoint and the greedy decode
    (the final loss below the first).  Prints each example's wall, the
    serve tokens/s and the kernels each launched."""
    smi = _smi()
    print(f"== examples: examples/torch_*.py on cuda:0 at the reference "
          f"examples' sizes; {smi}")
    out = {"device": smi}
    qs = _example("torch_quickstart")
    lines, wall, launched = _example_run(qs.main, "cuda")
    cpu_lines = qs.main("cpu")
    if lines != cpu_lines:
        raise AssertionError(f"quickstart: card lines {lines} != CPU "
                             f"lines {cpu_lines}")
    out["quickstart"] = {"wall_s": wall, "launches": launched,
                         "lines": lines}
    print(f"  quickstart: {wall:.2f} s, the card's lines equal the CPU's; "
          f"kernels {launched} (the demo's one db_copy is a zero-copy "
          f"partition, so no batch reaches the fused copy)")

    wf = _example("torch_wavefront_pipeline")
    card, wall, launched = _example_run(wf.main, "cuda")
    cpu = wf.main("cpu")
    if card["order"] != cpu["order"] or card["makespan"] != cpu["makespan"]:
        raise AssertionError("wavefront: the card's order or makespan "
                             "differs from the CPU's")
    worst = max(float((a.cpu() - b).abs().max())
                for a, b in zip(card["outputs"], cpu["outputs"]))
    out["wavefront"] = {"wall_s": wall, "launches": launched,
                        "makespan": card["makespan"],
                        "max_err_vs_sequential": card["max_err"],
                        "card_vs_cpu_max_abs": worst}
    print(f"  wavefront: {wall:.2f} s, {card['cells']} cells, makespan "
          f"{card['makespan']:.1f} and order equal to the CPU's, pipeline "
          f"== sequential exactly on the card; card vs CPU outputs max "
          f"|diff| {worst:.2e}; kernels {launched}")

    sv = _example("torch_serve_lm")
    res, wall, launched = _example_run(sv.main, "cuda")
    if not (launched.get("k5", 0) > 0 and launched.get("k9", 0) > 0):
        raise AssertionError(f"serve example: kernels {launched}, want K5 "
                             f"and K9")
    out["serve"] = {"wall_s": wall, "launches": launched,
                    "tok_s": {r["arch"]: r["tok_s"] for r in res}}
    print(f"  serve: {wall:.2f} s; tokens/s "
          + ", ".join(f"{r['arch']} {r['tok_s']:.1f}" for r in res)
          + f"; kernels {launched} ({smi})")

    tl = _example("torch_train_lm")
    res, wall, launched = _example_run(tl.main, "cuda")
    first, final = res["first_loss"], res["final"]["ce_loss"]
    ok = (res["died_at"] == tl.FAIL_AT - 1 and res["latest_step"] == tl.FAIL_AT
          and res["restart_step"] == res["latest_step"]
          and res["final"]["step"] == tl.STEPS - 1 and final < first)
    out["train"] = {"wall_s": wall, "launches": launched,
                    **{k: res[k] for k in ("died_at", "latest_step",
                                           "restart_step", "first_loss",
                                           "hits", "preds", "want")},
                    "final": res["final"]}
    print(f"  train: {wall:.2f} s for {tl.STEPS} steps with the restart; "
          f"died after step {res['died_at']}, restarted from "
          f"{res['restart_step']} (latest_step {res['latest_step']}); "
          f"loss {first:.4f} -> {final:.4f}; chain hits {res['hits']}/5; "
          f"kernels {launched} ({smi})")
    if not ok:
        raise AssertionError(f"train example: {out['train']}")
    return out


MESH_NOTE = "2 ranks sharing one H100 over gloo; not a multi-card time"
MESH_STEPS = 2
MESH_SMOLLM_ARGS = ["--arch", "smollm-360m", "--data", "markov", "--batch",
                    "2", "--seq", "8192", "--steps", str(MESH_STEPS),
                    "--lr", "1e-3"]
MESH_LLAMA_ARGS = ["--arch", "llama3.2-3b", "--data", "markov", "--batch",
                   "4", "--seq", "4096", "--steps", str(MESH_STEPS),
                   "--lr", "1e-3"]
MESH_LLAMA_LAYERS = 4
# smollm's depth under the mesh (of 32: trained, saved sharded, resumed,
# served), cut to keep the whole run inside its time limit: the sharded
# save is host-bound, ~0.5-0.7 ms a range, ~5,800 ranges a layer a rank
MESH_SMOLLM_LAYERS = 4
MESH_MOE_EXPERTS = 32
MESH_MAMBA_LAYERS = 2
# (batch, seq[, cached positions | decodes]) of each part of the phase
MESH_SHAPES = {"head_attn": (4, 4096), "ctx_attn": (2, 8192),
               "decode": (4, 8192, 8000), "mla": (4, 4096, 4000),
               "moe": (2, 1024), "fp32_smollm": (1, 8192),
               "fp32_llama": (1, 4096), "fp32_mamba": (1, 4096),
               "serve_smollm": (4, 4608, 8),
               "serve_llama": (4, 4096, 8)}


def _want_launches(what, counts, want):
    """Fail unless each kernel of ``want`` launched exactly that often."""
    got = {k: counts[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")


def _wall(fn, reps=3):
    """Median host wall of ``fn`` in ms, synchronized before and after
    each of ``reps`` calls (after one warm call)."""
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
    return float(np.median(ms))


def _mesh_collectives(rank):
    """Each collective the mesh paths use, on CUDA tensors over gloo; a
    refusal raises here, with the backend's error."""
    import torch.distributed as dist
    x = torch.arange(4, dtype=torch.float32, device="cuda") + rank

    def reduce(op):
        y = x.clone()
        dist.all_reduce(y, op=op)
        return y

    def into(fn, n):
        y = torch.empty(n, device="cuda")
        fn(y, x)
        return y

    def listed():
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    cases = (("all_reduce sum", lambda: reduce(dist.ReduceOp.SUM),
              [1, 3, 5, 7]),
             ("all_reduce max", lambda: reduce(dist.ReduceOp.MAX),
              [1, 2, 3, 4]),
             ("all_gather_into_tensor",
              lambda: into(dist.all_gather_into_tensor, 8),
              [0, 1, 2, 3, 1, 2, 3, 4]),
             ("all_gather (list)", listed, [0, 1, 2, 3, 1, 2, 3, 4]),
             ("reduce_scatter_tensor",
              lambda: into(dist.reduce_scatter_tensor, 2),
              [[1, 3], [5, 7]][rank]),
             ("all_to_all_single", lambda: into(dist.all_to_all_single, 4),
              [[0, 1, 1, 2], [2, 3, 3, 4]][rank]))
    out = {}
    for name, fn, want in cases:
        got = fn()
        torch.cuda.synchronize()
        vals = got.cpu().tolist()
        print(f"  {name} on cuda tensors: rank {rank} got {vals}")
        if got.device != x.device or vals != [float(w) for w in want]:
            raise AssertionError(f"{name}: rank {rank} got {vals}, want "
                                 f"{want}")
        out[name] = vals
    return out


def _model_share(t, dim, mesh):
    """This rank's chunk of ``t`` along ``dim`` over "model" (contiguous:
    the operand a tensor-parallel layer hands on)."""
    from repro_torch.dist.sharding import ShardCtx
    ctx = ShardCtx(mesh)
    n = t.shape[dim] // ctx.model_size
    return t.narrow(dim, ctx.coord("model") * n, n).contiguous()


def _mesh_attention_call(name, cfg, b, s, seed, mesh, rank):
    """``causal_attention`` forward and backward (bf16) as the layers run
    it under the mesh, each rank on its share: its heads where the heads
    and kv heads divide the mesh, else its stripe of the sequence at its
    ``q_offset`` against k / v gathered by ``gather_seq`` (whose backward
    reduce-scatters their gradients).  Rank 0 holds its share against the
    same share of the call on one rank alone."""
    import torch.distributed as dist
    from repro_torch.dist import flash as dflash
    from repro_torch.dist.sharding import gather_seq, use_mesh
    dt = torch.bfloat16
    h, kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v, do = (_randn((b, s, h, hd), dt, seed),
                   _randn((b, s, kh, hd), dt, seed + 1),
                   _randn((b, s, kh, hd), dt, seed + 2),
                   _randn((b, s, h, hd), dt, seed + 3))
    heads = h % 2 == 0 and kh % 2 == 0
    dim = 2 if heads else 1

    def share(t):
        return _model_share(t, dim, mesh)

    def run_mesh():
        qq, kk, vv = (share(t).requires_grad_() for t in (q, k, v))
        with use_mesh(mesh):
            if heads:
                o = dflash.causal_attention(qq, kk, vv, cfg=cfg,
                                            window=cfg.sliding_window)
            else:
                o = dflash.causal_attention(
                    qq, gather_seq(kk), gather_seq(vv), cfg=cfg,
                    window=cfg.sliding_window,
                    q_offset=mesh.get_local_rank("model") * qq.shape[1])
            g = torch.autograd.grad(o, (qq, kk, vv), share(do))
        return o.detach(), g

    def run_one():
        qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
        o = dflash.causal_attention(qq, kk, vv, cfg=cfg,
                                    window=cfg.sliding_window)
        return o.detach(), torch.autograd.grad(o, (qq, kk, vv), do)

    _zero_counts()
    got = run_mesh()
    torch.cuda.synchronize()
    counts = _counts()
    print(f"  {name}: B={b} S={s} H={h} KH={kh} hd={hd} bf16, each rank "
          f"its {'heads' if heads else 'stripe of the sequence'}, rank "
          f"{rank} launches {counts}")
    _want_launches(name, counts, {"k1_lse": 1, "k3": 1})
    info = {"launches": counts}
    if rank == 0:
        want = run_one()
        info["max_abs_err"] = _check(f"{name} out vs one rank", got[0],
                                     share(want[0]), dt)
        for n, a, w in zip("qkv", got[1], want[1]):
            _check_rel(f"{name} d{n} vs one rank", a, share(w), dt)
        info["one_rank_ms"] = _wall(run_one)
        del want
    del got
    dist.barrier()
    info["mesh_ms"] = _wall(run_mesh)
    print(f"  {name}: forward + backward {info['mesh_ms']:.2f} ms a rank "
          f"under the mesh ({MESH_NOTE})"
          + (f", {info['one_rank_ms']:.2f} ms on one rank alone"
             if rank == 0 else ""))
    return info


def _mesh_decode_call(name, h, kh, hd, b, smax, cur, seed, mesh, rank):
    """One decode (bf16) as the layers run it under the mesh against the
    caches at rest: ``decode_update_and_attend`` on the rank's kv heads
    (K5) where the heads divide the mesh, else
    ``stripe_update_and_attend`` (the lse-combine, torch ops) on the
    rank's stripe of a whole-head cache.  Rank 0 holds its output against
    its share of the same decode on one rank alone (K5 there)."""
    import torch.distributed as dist
    from repro_torch.dist import flash as dflash
    from repro_torch.dist.sharding import use_mesh
    dt = torch.bfloat16
    q = _randn((b, 1, h, hd), dt, seed)
    kn, vn = _randn((b, 1, kh, hd), dt, seed + 1), _randn((b, 1, kh, hd),
                                                          dt, seed + 2)
    kc, vc = _randn((b, kh, smax, hd), dt, seed + 3), _randn(
        (b, kh, smax, hd), dt, seed + 4)
    heads = h % 2 == 0 and kh % 2 == 0
    if heads:
        ql, knl, vnl = (_model_share(t, 2, mesh) for t in (q, kn, vn))
        kcl, vcl = (_model_share(t, 1, mesh) for t in (kc, vc))
    else:
        ql, knl, vnl = q, kn, vn
        kcl, vcl = (_model_share(t, 2, mesh) for t in (kc, vc))

    def run_mesh():
        attend = (dflash.decode_update_and_attend if heads
                  else dflash.stripe_update_and_attend)
        with use_mesh(mesh):
            return attend(ql, knl, vnl, kcl.clone(), vcl.clone(), cur)[0]

    def run_one():
        return dflash.decode_update_and_attend(q, kn, vn, kc.clone(),
                                               vc.clone(), cur)[0]

    _zero_counts()
    got = run_mesh()
    torch.cuda.synchronize()
    counts = _counts()
    info = {"launches": counts}
    print(f"  {name}: B={b} H={h} KH={kh} hd={hd} cache {smax} at {cur}, "
          f"each rank its {'kv heads' if heads else 'stripe'}, rank {rank} "
          f"launches {counts}")
    # the rank's kv heads: K5; the lse-combine: torch ops
    _want_launches(name, counts, {"k5": int(heads)})
    if rank == 0:
        want = run_one()
        info["max_abs_err"] = _check(
            f"{name} vs one rank", got,
            _model_share(want, 2, mesh) if heads else want, dt)
        info["one_rank_ms"] = _wall(run_one)
    dist.barrier()
    info["mesh_ms"] = _wall(run_mesh)
    return info


def _mesh_mla_call(mesh, rank):
    """``mla_decode_attend`` at deepseek-v2's 128 heads, rkv 512, dr 64
    (bf16), each rank on its heads against the whole latent caches, as
    the layers run it; rank 0 against its heads of one rank's call."""
    from repro_torch.dist import flash as dflash
    from repro_torch.dist.sharding import use_mesh
    cfg = get_config(DEEPSEEK)
    dt = torch.bfloat16
    b, smax, cur = MESH_SHAPES["mla"]
    h, rkv, dr = cfg.num_heads, cfg.kv_lora_rank, cfg.qk_rope_head_dim
    ql, qr = _randn((b, 1, h, rkv), dt, 61), _randn((b, 1, h, dr), dt, 62)
    cn, kn = _randn((b, 1, rkv), dt, 63), _randn((b, 1, dr), dt, 64)
    ckv, kr = _randn((b, smax, rkv), dt, 65), _randn((b, smax, dr), dt, 66)
    scale = 1.0 / np.sqrt(cfg.qk_nope_head_dim + dr)
    qll, qrl = _model_share(ql, 2, mesh), _model_share(qr, 2, mesh)

    def run_mesh():
        with use_mesh(mesh):
            return dflash.mla_decode_attend(qll, qrl, cn, kn, ckv.clone(),
                                            kr.clone(), cur, scale=scale)[0]

    got = run_mesh()
    info = {"mesh_ms": _wall(run_mesh)}
    print(f"  mla_decode_attend: B={b} H={h} rkv={rkv} dr={dr} cache "
          f"{smax} at {cur}, each rank its {qll.shape[2]} heads")
    if rank == 0:
        want = dflash.mla_decode_attend(ql, qr, cn, kn, ckv.clone(),
                                        kr.clone(), cur, scale=scale)[0]
        info["max_abs_err"] = _check("mla decode vs one rank", got,
                                     _model_share(want, 2, mesh), dt)
    return info


def _mesh_trainer(cfg, argv, mesh, tc=None):
    """The port's Trainer under ``mesh`` as ``launch.train`` builds it
    from ``argv`` (a fresh seeded state cut to this rank's shards), run
    for ``args.steps`` steps with ``tc`` (no checkpoints by default)."""
    args = train_cli.parse_args(argv + ["--device", "cuda"])
    oc = train_cli.optimizer_config(cfg, args)
    data = SyntheticTokens(cfg.vocab_size, args.batch, args.seq, seed=0,
                           mode="markov")
    tr = Trainer(LanguageModel(cfg, device="cuda"), oc, data,
                 tc or TrainerConfig(), mesh=mesh)
    state = tr.init_or_restore(torch.Generator(device="cuda").manual_seed(0))
    return tr, tr.run(state, args.steps)


def _mesh_train(name, cfg, argv, rank, mesh, tc=None):
    """Steps of ``cfg`` at full width through ``Trainer(mesh=...)``:
    K1-lse twice and K3 once a layer a step on each rank (the wall
    includes the saves that ``tc`` asks for)."""
    _zero_counts()
    t0 = time.perf_counter()
    tr, state = _mesh_trainer(cfg, argv, mesh, tc)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    layers, steps = cfg.num_layers, len(tr.history)
    want = {"k1_lse": 2 * layers * steps, "k3": layers * steps}
    times = [h["step_time"] * 1e3 for h in tr.history]
    losses = [h["ce_loss"] for h in tr.history]
    print(f"  {name}: {layers} layers at full width, {steps} steps; rank "
          f"{rank} launches {counts} (want {want}); step ms "
          f"{[round(t, 1) for t in times]} ({MESH_NOTE}); ce_loss "
          f"{[round(x, 4) for x in losses]}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    _want_launches(name, counts, want)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{name}: losses {losses}")
    return {"launches": counts, "step_ms": times, "ce_loss": losses,
            "wall_s": wall, "layers": layers}, tr, state


class _BCGemms(TorchDispatchMode):
    """FLOPs of the GEMMs that produce or contract a width-``n`` operand:
    in a Mamba train step (n = ssm_state, a width no other GEMM of the
    step has) the B / C projections' forward and remat recompute (x @
    w_B: output n), dX (contracting n) and dW (output n)."""

    def __init__(self, n):
        super().__init__()
        self.n, self.flops = n, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            a, b = args[0], args[1]
            if self.n in (a.shape[1], b.shape[1]):
                self.flops += 2 * a.shape[0] * a.shape[1] * b.shape[1]
        return func(*args, **(kwargs or {}))


def _mesh_fp32_step(name, cfg, b, s, rank, mesh, device="cuda", oc=None,
                    bc_width=None):
    """One fp32 step under the mesh against the one-rank step on the same
    weights and batch: ce_loss within 1e-3, every parameter within 3e-4,
    the clip's global gradient norm within 1e-4 of it (relative) and the
    MoE drop counts and overflow rate equal (zeros for a dense model).
    The optimizer is the reference test's (peak lr 1e-3, warmup 2: lr
    5e-4 at step 1), so AdamW's first step moves each entry by about
    5e-4: a gradient of the wrong sign or left at zero moves its entry
    past the 3e-4 limit.  AdamW's first step does not see a gradient's
    scale, so the gradient norm holds that.  ``device`` "cpu" runs the
    same check on gloo ranks of the CPU; ``oc`` another optimizer (its
    moments' dtype).  The one-rank parameters wait on the host while the
    mesh steps.  ``bc_width`` (a Mamba model's ssm_state) also counts
    both steps' B / C GEMM FLOPs (:class:`_BCGemms`) and records the mesh
    step's wall and the bytes it hands gloo."""
    import torch.distributed as dist
    from repro_torch.dist import sharding
    from repro_torch.convert import place_state
    from repro_torch.dist.sharding import (full_tensor, param_shardings,
                                           use_mesh)
    from repro_torch.models.model import param_shapes
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = LanguageModel(cfg, device=device)
    oc = oc or OptimizerConfig(peak_lr=1e-3, warmup_steps=2, total_steps=50)
    data = SyntheticTokens(cfg.vocab_size, b, s, seed=5, mode="markov")
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in data.get(0).items()}
    step = make_train_step(model, oc)

    def fresh():
        p = model.init(torch.Generator(device=device).manual_seed(3))
        return {"params": p, "opt": init_opt_state(p, oc)}

    def counted():
        return (_BCGemms(bc_width) if bc_width
                else contextlib.nullcontext(None))

    one, bc_one = None, None
    if rank == 0:
        with counted() as bc:
            one, m1 = step(fresh(), batch)
        bc_one = bc and bc.flops
        one = _tree_to(one["params"], "cpu")
        _release()
    dist.barrier()
    state = place_state(fresh(), mesh)
    _release()
    if device == "cuda":
        torch.cuda.synchronize()
    sharding.reset_traffic()
    t = time.perf_counter()
    with use_mesh(mesh) as ctx:
        with counted() as bc:
            state, m2 = step(state, batch)
        if device == "cuda":
            torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t)
        traffic = {k: list(v) for k, v in sharding.TRAFFIC.items()}
        sh = param_shardings(param_shapes(cfg), ctx)
        worst = 0.0
        for path, leaf in iter_leaves(state["params"]):
            spec = sh
            for key in path:
                spec = spec[key]
            full = full_tensor(leaf, spec.spec, ctx)
            if one is not None:
                want = _at(one, path).to(full.device)
                d = ((full - want).abs() - 3e-4 * want.abs()).max().item()
                del want
                worst = max(worst, d)
            del full
    moe_keys = ("moe_dropped_tokens", "moe_overflow_rate")
    info = {"ce_loss": float(m2["ce_loss"]),
            **{k: float(m2[k]) for k in moe_keys}}
    if bc_width:
        info.update(step_ms=step_ms, traffic=traffic, bc_flops=bc.flops,
                    bc_flops_one_rank=bc_one)
    if rank == 0:
        ce = abs(float(m1["ce_loss"]) - float(m2["ce_loss"]))
        gn, gn1 = float(m2["grad_norm"]), float(m1["grad_norm"])
        gn_rel = abs(gn - gn1) / max(abs(gn1), 1e-30)
        moe_one = {k: float(m1[k]) for k in moe_keys}
        same_moe = all(info[k] == moe_one[k] for k in moe_keys)
        print(f"  {name} fp32 step ({cfg.num_layers} layers, {b} x {s}, "
              f"peak lr {oc.peak_lr:g}, warmup {oc.warmup_steps}) vs one "
              f"rank: ce_loss diff {ce:.2e} (limit "
              f"1e-3), params max(|diff| - 3e-4 |want|) {worst:.2e} (limit "
              f"3e-4), grad_norm {gn:.6f} vs {gn1:.6f}, relative diff "
              f"{gn_rel:.2e} (limit 1e-4); MoE pairs dropped "
              f"{info['moe_dropped_tokens']:g}, one rank "
              f"{moe_one['moe_dropped_tokens']:g} (equal), overflow rate "
              f"{info['moe_overflow_rate']:.6f} (equal)")
        if not (ce <= 1e-3 and worst <= 3e-4 and gn_rel <= 1e-4):
            raise AssertionError(f"{name}: the mesh step differs from one "
                                 f"rank's")
        if not same_moe:
            raise AssertionError(f"{name}: the mesh step's MoE drops "
                                 f"differ from one rank's")
        info.update(ce_diff=ce, param_excess=worst, grad_norm_rel=gn_rel,
                    one_rank=moe_one)
    del one, state
    _release()
    return info


def _mesh_serve(name, cfg, b, s, decodes, rank, mesh):
    """fp32 prefill and decodes under the mesh, against the same serve on
    one rank (rank 0): prefill logits within 1e-3 (fp32, logits O(1)),
    the greedy tokens agreeing at >= 0.95, and, on a second copy of the
    cache, decodes of the same given tokens: every step's logits within
    1e-3 and each rank's caches within 1e-3 of its share of the one-rank
    caches (its kv heads, or for whole-head attention its stripe of the
    sequence: ``LanguageModel.alloc_cache``)."""
    import torch.distributed as dist
    from repro_torch.dist.sharding import use_mesh
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = LanguageModel(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(4))
    gen = torch.Generator(device="cuda").manual_seed(6)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device="cuda")
    given = torch.randint(0, cfg.vocab_size, (decodes, b, 1), generator=gen,
                          device="cuda")

    def serve(m, walls=None):
        with use_mesh(m):
            t = time.perf_counter()
            logits, cache = model.prefill(params, {"tokens": toks})
            torch.cuda.synchronize()
            if walls is not None:
                walls["prefill_ms"] = 1e3 * (time.perf_counter() - t)
            first = logits
            cache = model.alloc_cache(b, s + decodes, init=cache)
            forced = _tree_to(cache, "cuda", copy=True)
            out, tok = [], logits.argmax(-1)
            t = time.perf_counter()
            for i in range(decodes):
                out.append(tok)
                logits, cache = model.decode_step(params, cache, tok[:, None],
                                                  s + i)
                tok = logits.argmax(-1)
            torch.cuda.synchronize()
            if walls is not None:
                walls["decode_ms"] = 1e3 * (time.perf_counter() - t) / decodes
            del cache
            steps = [model.decode_step(params, forced, given[i], s + i)[0]
                     for i in range(decodes)]
        return first, torch.stack(out, 1), torch.stack(steps), forced

    walls = {}
    _zero_counts()
    first, tokens, steps, cache = serve(mesh, walls)
    counts = _counts()
    print(f"  {name} serve (fp32, {cfg.num_layers} layers): prefill {b} x "
          f"{s} {walls['prefill_ms']:.1f} ms, {decodes} decodes "
          f"{walls['decode_ms']:.1f} ms a step ({MESH_NOTE}); rank {rank} "
          f"launches {counts}")
    # prefill: K1 once a layer (on the rank's heads or sequence stripe);
    # decode (greedy, then the given tokens): K5 once a layer a step when
    # the heads split, else the lse-combine's torch ops
    heads = cfg.num_heads % 2 == 0 and cfg.num_kv_heads % 2 == 0
    _want_launches(f"{name} serve", counts, {
        "k1": cfg.num_layers, "k5": 2 * cfg.num_layers * decodes * heads})
    # every rank's caches, for rank 0 to hold against the one-rank caches
    parts = {}
    for path, leaf in iter_leaves(cache):
        got = [torch.empty_like(leaf) for _ in range(dist.get_world_size())]
        dist.all_gather(got, leaf.contiguous())
        parts["/".join(path)] = got
    del cache
    info = {"launches": counts, **walls}
    if rank == 0:
        w_first, w_tokens, w_steps, w_cache = serve(None)
        err = (first - w_first).abs().max().item()
        agree = (tokens == w_tokens).float().mean().item()
        step_err = (steps - w_steps).abs().max().item()
        cache_err, layouts = 0.0, set()
        for path, whole in iter_leaves(w_cache):
            for r, got in enumerate(parts["/".join(path)]):
                if got.shape == whole.shape:
                    want, lay = whole, "whole"
                elif got.shape[2] != whole.shape[2]:      # the rank's heads
                    n = got.shape[2]
                    want, lay = whole[:, :, r * n:(r + 1) * n], "heads"
                else:                          # the rank's sequence stripe
                    n = got.shape[3]
                    want = whole[:, :, :, r * n:(r + 1) * n]
                    got = got[:, :, :, :want.shape[3]]
                    lay = "seq"
                layouts.add(f"{path[-1]}: {lay}")
                cache_err = max(cache_err, (got - want).abs().max().item())
        print(f"  {name} serve vs one rank: prefill logits max_abs_err "
              f"{err:.2e} (limit 1e-3), greedy tokens agree {agree:.3f} "
              f"(limit 0.95); {decodes} decodes of given tokens: logits "
              f"max_abs_err {step_err:.2e} (limit 1e-3), every rank's "
              f"caches vs its share of the one-rank caches "
              f"({', '.join(sorted(layouts))}) max_abs_err {cache_err:.2e} "
              f"(limit 1e-3)")
        if not (err <= 1e-3 and agree >= 0.95 and step_err <= 1e-3
                and cache_err <= 1e-3):
            raise AssertionError(f"{name}: mesh serve differs from one rank")
        info.update(max_abs_err=err, token_agreement=agree,
                    decode_max_abs_err=step_err, cache_max_abs_err=cache_err,
                    cache_layouts=sorted(layouts))
        del w_cache
    del params, parts
    _release()
    dist.barrier()
    return info


# PR 25's llama3.2-3b mesh train steps, GEMMs replicated over "model"
# (PERF.md §5; H100 80GB HBM3, 700 W, 2 ranks over gloo)
MESH_PR25_LLAMA_MS = (4686.9, 4469.0)


def _gemm_step(tr, state, mesh):
    """One more step of ``tr``'s model on its data's first batch, under
    ``FlopCounterMode``: this rank's GEMM FLOPs (the attention kernels
    are not aten ops: they count themselves, ``kernels.counts``), the
    kernels' counts {name: [calls, flops, bytes]} and FLOPs, the step's
    wall in ms, the collectives it handed gloo {kind: [calls, bytes,
    largest]} and the card's peak allocated bytes during the step (the
    state and the batch included)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.dist import sharding
    from repro_torch.dist.sharding import use_mesh
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in tr.data.get(0).items()}
    step = make_train_step(tr.model, tr.oc)
    torch.cuda.synchronize()
    sharding.reset_traffic()
    kcounts.reset()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with use_mesh(mesh), FlopCounterMode(display=False) as fc:
        step(state, batch)
    torch.cuda.synchronize()
    return {"gemm_flops": int(fc.get_total_flops()),
            "ms": 1e3 * (time.perf_counter() - t),
            "traffic": {k: list(v) for k, v in sharding.TRAFFIC.items()},
            "kernels": {k: list(v) for k, v in kcounts.KERNELS.items()},
            "kernel_flops": sum(v[1] for v in kcounts.KERNELS.values()),
            "peak_bytes": torch.cuda.max_memory_allocated()}


def _mesh_layout_pass(cfg=None, argv=MESH_LLAMA_ARGS, shape=(1, 2)):
    """The dry run's layout pass of a mesh train step
    (``launch.dryrun.train_report``): rank 0 of ``MeshLayout(shape)`` on
    the meta device, the step a rank counts on the card (by default
    llama's in ``_mesh_tp``: 4 layers; the same optimizer and the same
    batch shapes as ``argv``), no process and no card.  Returns its
    prediction: aten FLOPs, the kernels' counts and FLOPs, every
    ``TRAFFIC`` kind's [calls, bytes], the peak bytes of the storages
    (the state and the batch included) and its host seconds."""
    from repro_torch.dist.sharding import MeshLayout
    from repro_torch.launch.dryrun import train_report
    cfg = cfg or dataclasses.replace(get_config("llama3.2-3b"),
                                     num_layers=MESH_LLAMA_LAYERS)
    args = train_cli.parse_args(argv + ["--device", "cuda"])
    oc = train_cli.optimizer_config(cfg, args)
    data = SyntheticTokens(cfg.vocab_size, args.batch, args.seq, seed=0,
                           mode="markov")
    batch = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                            device="meta") for k, v in data.get(0).items()}
    t = time.perf_counter()
    rep = train_report(cfg, oc, batch, MeshLayout(shape, ("data", "model")),
                       0)
    secs = time.perf_counter() - t
    pred = {"aten_flops": int(rep.aten_flops),
            "kernel_flops": int(rep.kernel_flops), "kernels": rep.kernels,
            "traffic": {k: [int(rep.coll_counts[k]), int(v)]
                        for k, v in rep.coll_bytes.items()},
            "peak_bytes": int(rep.peak_bytes), "arg_bytes": rep.arg_bytes,
            "seconds": secs}
    print(f"  the dry run's layout pass of {cfg.name}'s mesh step (rank 0 "
          f"of MeshLayout({shape}), {cfg.num_layers} layers, "
          f"{args.batch} x {args.seq}, meta device): {secs:.2f} s on the "
          f"host; aten FLOPs "
          f"{rep.aten_flops / 1e12:.3f} T, kernel FLOPs "
          f"{rep.kernel_flops / 1e12:.3f} T {rep.kernels}, peak "
          f"{rep.peak_bytes / 1e9:.2f} GB ({rep.arg_bytes / 1e9:.2f} GB of "
          f"state and batch), traffic {pred['traffic']}")
    return pred


def _check_layout_pass(pred, got, rank):
    """Rank 0's counted step against the layout pass's prediction: GEMM
    FLOPs, kernel FLOPs and every TRAFFIC kind's calls and bytes equal,
    peak memory within 10 % of ``torch.cuda.max_memory_allocated``;
    prints both and raises on a miss."""
    traffic = {k: v[:2] for k, v in got["traffic"].items()}
    ratio = pred["peak_bytes"] / got["peak_bytes"]
    misses = [what for what, ok in (
        ("GEMM FLOPs", got["gemm_flops"] == pred["aten_flops"]),
        ("kernel FLOPs", got["kernel_flops"] == pred["kernel_flops"]),
        ("TRAFFIC", traffic == pred["traffic"]),
        ("peak memory", abs(ratio - 1.0) <= 0.10)) if not ok]
    print(f"  rank {rank} against the layout pass: GEMM FLOPs "
          f"{got['gemm_flops']} (predicted {pred['aten_flops']}); kernel "
          f"FLOPs {got['kernel_flops']} {got['kernels']} (predicted "
          f"{pred['kernel_flops']} {pred['kernels']}); TRAFFIC {traffic} "
          f"(predicted {pred['traffic']}); peak "
          f"{got['peak_bytes'] / 1e9:.3f} GB by max_memory_allocated, "
          f"predicted {pred['peak_bytes'] / 1e9:.3f} GB (ratio {ratio:.4f}, "
          f"limit 10 %); {'all held' if not misses else 'MISSED: ' + ', '.join(misses)}")
    if misses:
        raise AssertionError(f"rank {rank}: the layout pass missed "
                             f"{misses}")
    return {"peak_ratio": ratio, "measured": got, "predicted": pred}


def _mesh_llama_one_rank(cfg, rank):
    """llama's bf16 Trainer steps on rank 0 alone (no mesh, the same
    argv), and one more step counted: its GEMM FLOPs, walls and peak
    memory above what the rank held before (the other rank waits)."""
    import torch.distributed as dist
    info = None
    if rank == 0:
        _release()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        tr, state = _mesh_trainer(cfg, MESH_LLAMA_ARGS, None)
        counted = _gemm_step(tr, state, None)
        info = {"gemm_flops": counted["gemm_flops"],
                "counted_step_ms": counted["ms"],
                "step_ms": [h["step_time"] * 1e3 for h in tr.history],
                "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
        del tr, state
        _release()
    dist.barrier()
    return info


def _mesh_tp(tr, state, mesh, rank, train, one, base, prediction):
    """What tensor parallelism does to llama's bf16 mesh step (4 layers,
    4 x 4096 on each rank's half of every head, hidden unit and vocab
    row): the rank's GEMM FLOPs against one rank's, peak memory, the
    bytes a step hands gloo by kind and the walls beside PR 25's.  Fails
    if a rank's GEMM FLOPs exceed 0.6 of one rank's or the step gathers
    any parameter over "model" (the replicated design gathered every
    sharded leaf whole, the 788 MB bf16 embedding among them)."""
    import torch.distributed as dist
    cfg = tr.model.cfg
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    counted = _gemm_step(tr, state, mesh)
    flops, ms, traffic = (counted["gemm_flops"], counted["ms"],
                          counted["traffic"])
    smi = _smi()
    info = {"gemm_flops": flops, "peak_gb": peak, "counted_step_ms": ms,
            "traffic": traffic, "step_ms": train["step_ms"],
            "pr25_step_ms": list(MESH_PR25_LLAMA_MS), "device": smi}
    if rank == 0:
        info["layout_pass"] = _check_layout_pass(prediction, counted, rank)
    if rank == 0:
        ratio = flops / one["gemm_flops"]
        info.update(one_rank=one, flop_ratio=ratio)
        print(f"  llama3.2-3b bf16 mesh step under tensor parallelism "
              f"({cfg.num_layers} layers, 4 x 4096): GEMM FLOPs a rank "
              f"{flops / 1e12:.3f} T, one rank alone "
              f"{one['gemm_flops'] / 1e12:.3f} T (ratio {ratio:.3f}, "
              f"limit 0.6); peak memory a rank {peak:.2f} GB, one rank "
              f"alone {one['peak_gb']:.2f} GB; a step hands gloo "
              + ", ".join(f"{k} {c} calls {b / 1e6:.1f} MB (largest "
                          f"{big / 1e6:.1f} MB)"
                          for k, (c, b, big) in sorted(traffic.items()))
              + f"; step walls {[round(t, 1) for t in train['step_ms']]} "
              f"ms (PR 25, GEMMs replicated: {list(MESH_PR25_LLAMA_MS)}; "
              f"one rank alone {[round(t, 1) for t in one['step_ms']]}); "
              f"the counted step {ms:.1f} ms ({MESH_NOTE}; {smi})")
        if ratio > 0.6:
            raise AssertionError(f"llama's mesh step: {ratio:.3f} of one "
                                 f"rank's GEMM FLOPs on a rank")
    over_model = [k for k in traffic if k == "param_gather/model"]
    if over_model:
        raise AssertionError(f"rank {rank}: the step gathered parameters "
                             f"over 'model': {traffic[over_model[0]]}")
    dist.barrier()
    return info


def _mesh_moe(rank, mesh):
    """Two arctic-width MoE layers (d_model 7168, experts of 4864, top 2,
    the dense residual; 32 experts, 16 on each rank) through the a2a
    dispatch, forward and backward, against the no-mesh oracle on rank 0
    at capacity factor E/k (every expert can take every token: no
    drops)."""
    import torch.distributed as dist
    from repro_torch.dist.sharding import use_mesh
    e = MESH_MOE_EXPERTS
    cfg = dataclasses.replace(get_config(ARCTIC), num_experts=e,
                              capacity_factor=e / 2)
    full = [moe.moe_init(torch.Generator(device="cuda").manual_seed(90 + i),
                         cfg) for i in range(2)]
    dt = full[0]["w_gate"].dtype          # arctic's bf16 parameters
    half = e // 2
    banks = ("w_gate", "w_up", "w_down")
    local = [{k: (v[rank * half:(rank + 1) * half].clone() if k in banks
                  else v) for k, v in p.items()} for p in full]
    if rank:
        del full
        _release()
    x = _randn((*MESH_SHAPES["moe"], cfg.d_model), dt, 91)
    dy = _randn((*MESH_SHAPES["moe"], cfg.d_model), dt, 92)

    def run(layers, m):
        leaves = [p[n].requires_grad_() for p in layers for n in banks]
        with use_mesh(m):
            h, auxs = x, []
            for p in layers:
                h, a = moe.moe_ffn(p, h, cfg)
                auxs.append(a)
            grads = torch.autograd.grad(h, leaves, dy)
        for p in layers:
            for n in banks:
                p[n].requires_grad_(False)
        return h.detach(), auxs, grads

    _zero_counts()
    t = time.perf_counter()
    y, auxs, grads = run(local, mesh)
    torch.cuda.synchronize()
    mesh_ms = 1e3 * (time.perf_counter() - t)
    dropped = [float(a["dropped"]) for a in auxs]
    a2a = [float(a["a2a_bytes"]) for a in auxs]
    norms = torch.stack([torch.linalg.vector_norm(
        g, dim=(1, 2), dtype=torch.float32) for g in grads])
    parts = [torch.empty_like(norms) for _ in range(2)]
    dist.all_gather(parts, norms)
    info = {"mesh_ms": mesh_ms, "dropped": dropped, "a2a_bytes": a2a}
    print(f"  moe a2a: 2 layers, {e} experts ({half} a rank), "
          f"{tuple(x.shape[:2])} tokens bf16: forward + backward {mesh_ms:.1f} ms ({MESH_NOTE}), "
          f"dropped {dropped}, a2a bytes a layer {a2a}")
    if rank == 0:
        t = time.perf_counter()
        wy, waux, wgrads = run(full, None)
        torch.cuda.synchronize()
        info["one_rank_ms"] = 1e3 * (time.perf_counter() - t)
        info["max_abs_err"] = _check("moe y vs no-mesh oracle", y, wy, dt)
        for n, g, w in zip(("w_gate 1", "w_up 1", "w_down 1", "w_gate 2",
                            "w_up 2", "w_down 2"), grads, wgrads):
            _check_rel(f"moe d{n} (rank 0's experts) vs oracle", g,
                       w[:half], dt)
        wn = torch.stack([torch.linalg.vector_norm(
            g, dim=(1, 2), dtype=torch.float32) for g in wgrads])
        got = torch.cat(parts, dim=1)
        rel = ((got - wn).abs() / wn.clamp(min=1e-30)).max().item()
        print(f"  moe: every expert's gradient norm (both ranks) vs the "
              f"oracle's: max relative diff {rel:.2e} (limit 1e-2); oracle "
              f"dropped {[float(a['dropped']) for a in waux]}")
        if rel > 1e-2 or any(dropped) or not all(b > 0 for b in a2a):
            raise AssertionError("moe a2a differs from the oracle")
        info["grad_norm_rel"] = rel
        del full, wy, wgrads
    del local, grads
    _release()
    dist.barrier()
    return info


def _sha1(t):
    return hashlib.sha1(t.detach().contiguous().cpu().numpy()
                        .reshape(-1).view(np.uint8)).hexdigest()


def _mesh_ckpt(tr, state, rank, mesh, full_layers):
    """smollm's mesh-trained state through the §6 sharded checkpoint, as
    ``launch.train --tp 2 --ckpt-dir`` runs it: ``tr`` saved it inside
    its last step (every rank its own ranges of its live shards, no leaf
    gathered); a second ``Trainer(mesh=)`` on the same directory resumes
    from it (``init_or_restore``: each rank reads its shards' ranges
    under ``Trainer.state_shardings()``) and must start at that step with
    every shard bit for bit the live one.  Returns each local shard's
    sha1 for the one-device restore in the parent.  A depth below
    ``full_layers`` is the disk-space cut."""
    import torch.distributed as dist
    from repro_torch.launch.specs import state_specs
    smi = _smi()
    cfg, layers = tr.model.cfg, tr.model.cfg.num_layers
    if not tr.saves or tr.saves[-1]["step"] != MESH_STEPS:
        raise AssertionError(f"rank {rank}: the Trainer saved at "
                             f"{[s['step'] for s in tr.saves]}, not at "
                             f"step {MESH_STEPS}")
    save_s, st = tr.saves[-1]["wall_s"], tr.saves[-1]["stats"]
    sh, shapes = tr.state_shardings(), state_specs(cfg, tr.oc)
    flat = {"/".join(p): (v, _at(sh, p)) for p, v in iter_leaves(state)}
    sharded = sum(any(e is not None for e in s.spec) for _v, s in
                  flat.values())
    # this rank's share of the write table: the ranges it owns
    mine = [size for p, (v, s) in flat.items()
            for _node, _off, size, r, _piece in ckpt.range_owners(
                tuple(_at(shapes, p.split("/")).shape), v.element_size(),
                s, mesh.size()) if r == rank]
    owned, n_mine = sum(mine), len(mine)
    dist.barrier()
    tr2 = Trainer(LanguageModel(cfg, device="cuda"), tr.oc, tr.data,
                  tr.tc, mesh=mesh)
    t0 = time.perf_counter()
    got = tr2.init_or_restore(torch.Generator(device="cuda").manual_seed(99))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    same = all(torch.equal(v, _at(got, p.split("/")))
               for p, (v, _s) in flat.items())
    info = {"layers": layers, "reduced": (f"{layers} of {full_layers} "
                                          f"layers (disk space)"
                                          if layers < full_layers else None),
            "leaves_sharded": sharded,
            "leaves_replicated": len(flat) - sharded,
            "save_s": save_s, "bytes_owned": owned, "ranges_owned": n_mine,
            "save_gb_s": owned / save_s / 1e9,
            "save_us_a_range": save_s / max(n_mine, 1) * 1e6,
            "restore_mesh_s": restore_s,
            "host_gathers": st.host_gathers, "committed": st.committed,
            "stats": st.snapshot(), "restored_step": tr2.start_step,
            "restored_bits_equal": same,
            "sha1": {p: _sha1(v) for p, (v, _s) in flat.items()}}
    print(f"  sharded checkpoint of smollm-360m's mesh-trained state "
          f"({layers} layers{', reduced: cut for disk space' if info['reduced'] else ''}; "
          f"{len(flat)} leaves: {sharded} sharded, "
          f"{len(flat) - sharded} replicated), saved by the Trainer after "
          f"step {MESH_STEPS}: rank {rank} wrote its own {n_mine} ranges, "
          f"{owned / 1e9:.3f} GB, in {save_s:.2f} s "
          f"({info['save_gb_s']:.3f} GB/s, {info['save_us_a_range']:.1f} "
          f"us a range), host_gathers {st.host_gathers}, "
          f"{st.chunks_written} ranges in all; a new Trainer(mesh=) resumed "
          f"at step {tr2.start_step} in {restore_s:.2f} s, its shards "
          f"{'bit for bit the live ones' if same else 'DIFFERENT'} "
          f"({MESH_NOTE}; {smi})")
    del got, tr2
    if st.host_gathers or not st.committed or not same or \
            info["restored_step"] != MESH_STEPS or not sharded or \
            sharded == len(flat):
        raise AssertionError(f"sharded checkpoint on rank {rank}: "
                             f"{ {k: v for k, v in info.items() if k != 'sha1'} }")
    return info


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def _mesh_rank(rank, world, ckpt_dir, ckpt_layers, prediction):
    """Everything one rank of the mesh phase runs (the module-level
    entry ``launch.mesh.spawn`` starts on cuda:0); rank 1 prints only its
    collectives' lines.  Returns the rank's numbers."""
    import torch.distributed as dist
    from repro_torch.dist.sharding import full_tensor, param_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.model import param_shapes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()                      # the parent built it: a load
    mesh = make_host_mesh(model=world, device_type="cuda")
    out = {"collectives": _mesh_collectives(rank)}
    if rank:
        sys.stdout = open(os.devnull, "w")
    print(f"== mesh ({MESH_NOTE}): call level at full width, bf16")
    llama, smollm = get_config("llama3.2-3b"), get_config("smollm-360m")
    sh = MESH_SHAPES
    out["head_parallel"] = _mesh_attention_call(
        "head-parallel causal_attention (llama3.2-3b heads)", llama,
        *sh["head_attn"], 71, mesh, rank)
    out["context_parallel"] = _mesh_attention_call(
        "context-parallel causal_attention (smollm-360m heads)", smollm,
        *sh["ctx_attn"], 72, mesh, rank)
    out["lse_decode"] = _mesh_decode_call(
        "lse-combine decode (smollm-360m heads)", smollm.num_heads,
        smollm.num_kv_heads, smollm.head_dim, *sh["decode"], 73, mesh, rank)
    out["head_decode"] = _mesh_decode_call(
        "head-parallel decode (llama3.2-3b heads, K5)", llama.num_heads,
        llama.num_kv_heads, llama.head_dim, *sh["decode"], 74, mesh, rank)
    out["mla_decode"] = _mesh_mla_call(mesh, rank)
    out["moe"] = _mesh_moe(rank, mesh)

    print(f"== mesh train ({MESH_NOTE})")
    # smollm saves on the §6 sharded path inside its last step, at the
    # whole depth unless the disk is too small for the state
    smollm_ck = dataclasses.replace(smollm, num_layers=ckpt_layers)
    out["train_smollm"], tr, state = _mesh_train(
        "smollm-360m (15 heads: context-parallel; MLP and vocab "
        "tensor-parallel)", smollm_ck,
        MESH_SMOLLM_ARGS, rank, mesh,
        TrainerConfig(ckpt_dir=ckpt_dir, ckpt_every=MESH_STEPS,
                      async_ckpt=False))
    out["ckpt"] = _mesh_ckpt(tr, state, rank, mesh, MESH_SMOLLM_LAYERS)
    del tr, state
    _release()
    llama4 = dataclasses.replace(llama, num_layers=MESH_LLAMA_LAYERS)
    one = _mesh_llama_one_rank(llama4, rank)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out["train_llama"], tr, state = _mesh_train(
        "llama3.2-3b (24 / 8 heads: tensor-parallel)", llama4,
        MESH_LLAMA_ARGS, rank, mesh)
    out["tp_llama"] = _mesh_tp(tr, state, mesh, rank, out["train_llama"],
                               one, base, prediction)
    # one TP-sharded leaf's local shard, for the §6 copy in the parent
    from repro_torch.dist.sharding import use_mesh
    with use_mesh(mesh) as ctx:
        spec = param_shardings(param_shapes(llama4),
                               ctx)["layers"]["attn"]["w_k"].spec[1:]
        shard = state["params"]["layers"]["attn"]["w_k"][0]
        out["k7_leaf"] = {"spec": spec, "shard": shard.cpu(),
                          "full": full_tensor(shard, spec, ctx).cpu()}
    del tr, state
    _release()
    out["fp32_smollm"] = _mesh_fp32_step(
        "smollm-360m", dataclasses.replace(smollm, num_layers=4),
        *sh["fp32_smollm"], rank, mesh)
    out["fp32_llama"] = _mesh_fp32_step(
        "llama3.2-3b", dataclasses.replace(llama, num_layers=2),
        *sh["fp32_llama"], rank, mesh)
    out["fp32_mamba"] = _mesh_mamba(rank, mesh)

    print(f"== mesh serve ({MESH_NOTE})")
    out["serve_smollm"] = _mesh_serve(
        "smollm-360m", dataclasses.replace(smollm,
                                           num_layers=MESH_SMOLLM_LAYERS),
        *sh["serve_smollm"], rank, mesh)
    out["serve_llama"] = _mesh_serve("llama3.2-3b", llama4,
                                     *sh["serve_llama"], rank, mesh)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    dist.barrier()
    return out


def _mesh_mamba(rank, mesh):
    """Two mamba2-1.3b layers at full width (d_model 2048, d_inner 4096,
    64 heads of 64, N 128), one fp32 train step of 1 x 4096 under (1, 2)
    against one rank's (``_mesh_fp32_step``): each rank its 32 heads and
    2048 channels, B and C projected on its 2048-row stripe and gathered
    (``models.mamba``).  Fails unless a rank's B / C GEMM FLOPs are
    exactly half of one rank's; prints them, the step's wall and what it
    hands gloo."""
    cfg = dataclasses.replace(get_config("mamba2-1.3b"),
                              num_layers=MESH_MAMBA_LAYERS)
    info = _mesh_fp32_step("mamba2-1.3b", cfg, *MESH_SHAPES["fp32_mamba"],
                           rank, mesh, bc_width=cfg.ssm_state)
    if rank == 0:
        ratio = info["bc_flops"] / info["bc_flops_one_rank"]
        info["bc_ratio"] = ratio
        print(f"  mamba2-1.3b B / C GEMMs a rank {info['bc_flops'] / 1e9:.3f} "
              f"GFLOP, one rank alone "
              f"{info['bc_flops_one_rank'] / 1e9:.3f} (ratio {ratio:.4f}, "
              f"want 0.5); the mesh step {info['step_ms']:.1f} ms, hands "
              f"gloo " + ", ".join(
                  f"{k} {c} calls {b / 1e6:.1f} MB"
                  for k, (c, b, _big) in sorted(info["traffic"].items()))
              + f" ({MESH_NOTE}; {_smi()})")
        if ratio != 0.5:
            raise AssertionError(f"mamba2's B / C GEMMs: {ratio} of one "
                                 f"rank's on a rank, want 0.5")
    return info


def _mesh_k7(ranks):
    """The §6 ranges of a TP-sharded llama leaf (layer 0's w_k, fp32,
    kv heads over "model": 3072 rows x 2 ranges) handed to db_partition
    on ``Runtime(copy_backend="cuda")``: one fused copy (K7, ranges on
    the card) reassembles the leaf from the two ranks' local shards, bit
    for bit."""
    from repro_torch.dist.sharding import (MeshLayout, NamedSharding,
                                           device_ranges_of)
    leaf = ranks[0]["k7_leaf"]
    full, spec = leaf["full"], leaf["spec"]
    sh = NamedSharding(MeshLayout((1, 2), ("data", "model")), spec)
    per_rank = device_ranges_of(tuple(full.shape), full.element_size(), sh)
    distinct = sorted({r for _rank, rs in per_rank for r in rs})
    src = np.concatenate([r["k7_leaf"]["shard"].numpy().reshape(-1).view(
        np.uint8) for r in ranks])
    want = full.numpy().reshape(-1).view(np.uint8)
    copies, cursor = [], 0
    for _rank, rs in per_rank:
        for off, n in rs:
            copies.append((off, cursor, n))
            cursor += n

    def body(api, out):
        dst, _ = api.db_create(want.size)
        api.db_release(dst)
        out["parts"] = len(api.db_partition(dst, distinct))
        block, ptr = api.db_create(src.size)
        ptr[:] = src
        api.db_release(block)
        for d_off, s_off, n in copies:
            api.db_copy(dst, d_off, block, s_off, n)
        out["db"] = dst

    _zero_copy_counts()
    got, stats, run_ms = _run_program(body, "cuda")
    counts = _copy_counts()
    ok = bool(np.array_equal(got, want))
    print(f"  §6 ranges of layers.attn.w_k[0] {tuple(full.shape)} spec "
          f"{spec}: {len(distinct)} ranges through db_partition; "
          f"Runtime(copy_backend='cuda') reassembled the leaf from both "
          f"ranks' shards {'bit for bit' if ok else 'WRONG'}: launches "
          f"{counts}, fused copies {stats.fused_copies}, run {run_ms:.1f} ms")
    if not ok or counts["k7"] != 1 or stats.fused_copies != 1:
        raise AssertionError("the §6 reassembly through K7 failed")
    return {"ranges": len(distinct), "launches": counts, "run_ms": run_ms}


def _shard_kernel_times(flush):
    """The kernels at the shard shapes the mesh phase gave them, timed on
    the card alone (no other rank running): K1-lse and K3 on a
    context-parallel stripe (smollm's B=2, H=15, KH=5, hd 64: Sq 4096
    against Sk 8192 at q_offset 4096), and K5 on 4 local kv heads
    (llama's B=4, G=3, hd 128, a cache of 8192 at 8001)."""
    dt = torch.bfloat16
    b, h, kh, sq, sk, hd, off = 2, 15, 5, 4096, 8192, 64, 4096
    q, k, v, do = (_randn((b, h, sq, hd), dt, 81), _randn((b, kh, sk, hd),
                                                          dt, 82),
                   _randn((b, kh, sk, hd), dt, 83), _randn((b, h, sq, hd),
                                                           dt, 84))
    out, lse = fa.flash_attention_fwd(q, k, v, off)
    want, want_lse = fa.flash_attention_plain(q, k, v, off, with_lse=True)
    e_fwd = _check("K1-lse stripe", out, want, dt)
    delta = (do.float() * out.float()).sum(-1)
    grads = fa.flash_attention_bwd_fused(q, k, v, do, lse, delta, off)
    wgrads = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, off)
    e_bwd = max(_check_rel(f"K3 stripe d{n}", g, w, dt)[0]
                for n, g, w in zip("qkv", grads, wgrads))
    work = {key: kcounts.attention_work(key, b, h, kh, sq, sk, hd, hd, off,
                                        True, 0, q.element_size())
            for key in ("k1_lse", "k3")}
    mask = _window_mask(sq, sk, off, sk + 1)
    libs = {"k1_lse": _sdpa_call(q, k, v, attn_mask=mask)[0],
            "k3": _sdpa_backward(q, k, v, do, attn_mask=mask)[0]}
    rows = {}
    for key, fn, plain, flops, nbytes, err in (
            ("k1_lse", lambda: fa.flash_attention_fwd(q, k, v, off),
             lambda: fa.flash_attention_plain(q, k, v, off, with_lse=True),
             *work["k1_lse"], e_fwd),
            ("k3", lambda: fa.flash_attention_bwd_fused(q, k, v, do, lse,
                                                        delta, off),
             lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, do, off),
             *work["k3"], e_bwd)):
        st = _time_stats(fn, 10, flush)
        bound_ms, bound_by = _bound(flops, nbytes, dt)
        rows[key] = {"timed_shape": f"B={b} H={h} KH={kh} Sq={sq} Sk={sk} "
                     f"hd={hd} q_offset={off} bf16 causal (a context-"
                     f"parallel stripe)", "ms": st["median"],
                     "ms_min": st["min"], "ms_max": st["max"],
                     "plain_ms": _time_ms(plain, 3, flush),
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "max_abs_err": err,
                     "library_ms": (_time_ms(libs[key], 10, flush)
                                    if libs[key] else None)}
        print(f"  {key} at the stripe: {_fmt(st)}, plain "
              f"{rows[key]['plain_ms']:.3f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), library {rows[key]['library_ms']}")
    del q, k, v, do, out, lse, want, grads, wgrads, mask, libs
    b, kh, g, hd, s, cur = 4, 4, 3, 128, 8192, 8001
    qd = _randn((b, kh, g, hd), dt, 85)
    kc, vc = _randn((b, kh, s, hd), dt, 86), _randn((b, kh, s, hd), dt, 87)
    valid = torch.full((1,), cur, dtype=torch.int32, device="cuda")
    got = fd.flash_decode(qd, kc, vc, valid)
    err = _check("K5 on 4 local kv heads", got,
                 fd.flash_decode_plain(qd, kc, vc, valid), dt)
    st = _time_stats(lambda: fd.flash_decode(qd, kc, vc, valid), 10, flush)
    # the library: sdpa (GQA) of the rank's query heads over the live cache
    q4, k_live, v_live = (qd.reshape(b, kh * g, 1, hd), kc[:, :, :cur],
                          vc[:, :, :cur])
    lib_k5 = _time_ms(lambda: F.scaled_dot_product_attention(
        q4, k_live, v_live, enable_gqa=True), 10, flush)
    nbytes = 2 * b * kh * cur * hd * 2 + 2 * qd.numel() * 2
    bound_ms, bound_by = _bound(4 * b * kh * g * cur * hd, nbytes, dt)
    rows["k5"] = {"timed_shape": f"B={b} KH={kh} G={g} hd={hd} cache {s} "
                  f"at {cur} bf16 (a rank's kv heads, head-parallel)",
                  "ms": st["median"], "ms_min": st["min"], "ms_max": st["max"],
                  "plain_ms": _time_ms(lambda: fd.flash_decode_plain(
                      qd, kc, vc, valid), 3, flush),
                  "bound_ms": bound_ms, "bound_by": bound_by,
                  "max_abs_err": err, "library_ms": lib_k5}
    print(f"  k5 on local kv heads: {_fmt(st)}, plain "
          f"{rows['k5']['plain_ms']:.3f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}), library (sdpa, GQA) {lib_k5:.4f} ms")
    del qd, kc, vc, q4, k_live, v_live
    torch.cuda.empty_cache()
    return rows


def phase_mesh():
    """Two ranks on cuda:0 over gloo, mesh (1, 2) ("data", "model"),
    started by ``launch.mesh.spawn`` after the parent built the kernels:
    each collective on CUDA tensors; attention (head- and
    context-parallel), decode (the rank's kv heads, and the lse-combine
    over its stripe) and MLA's decode on each rank's share at full-width
    shapes against that share of one rank's call; arctic-width MoE a2a against the
    no-mesh oracle; smollm-360m (4 of 32 layers, saving a sharded
    checkpoint that a second mesh Trainer resumes) and llama3.2-3b (4
    layers) trained at full width through ``Trainer(mesh=...)`` with
    tensor parallelism (each rank its heads, hidden units and vocab rows;
    llama's GEMM FLOPs, peak memory, gloo bytes and walls against one
    rank alone), each with an fp32 step held against one rank; both
    served under the mesh (fp32) against one rank, every rank's caches
    against its share of the one-rank caches; then, in the parent, the §6
    ranges of a sharded leaf through K7 and the kernels timed at their
    shard shapes.  Before the ranks start, the parent runs the dry run's
    layout pass of llama's step (rank 0 of a ``MeshLayout``, meta
    tensors); rank 0's counted step must equal its GEMM FLOPs, kernel
    FLOPs and every ``TRAFFIC`` kind, and its peak memory within 10 %."""
    from repro_torch.launch import mesh as mesh_launch
    smi = _smi()
    print(f"== mesh: 2 ranks on cuda:0 over gloo, mesh (1, 2) "
          f"('data', 'model'); {smi}; {MESH_NOTE}")
    prediction = _mesh_layout_pass()
    _release()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_ckpt_")
    try:
        layers = _mesh_ckpt_layers(ckpt_dir)
        t0 = time.perf_counter()
        ranks = mesh_launch.spawn(_mesh_rank, 2, backend="gloo",
                                  devices=["cuda:0", "cuda:0"],
                                  args=(ckpt_dir, layers, prediction),
                                  timeout_s=900)
        wall = time.perf_counter() - t0
        print(f"  the ranks ran {wall:.1f} s ({MESH_NOTE}; {smi})")
        one_rank = _mesh_ckpt_one_device(ranks, ckpt_dir, layers)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    for r, res in enumerate(ranks):
        print(f"  rank {r}: train launches smollm "
              f"{res['train_smollm']['launches']}, llama "
              f"{res['train_llama']['launches']}; serve smollm "
              f"{res['serve_smollm']['launches']}, llama "
              f"{res['serve_llama']['launches']}; peak memory "
              f"{res['peak_gb']:.2f} GB")
        ck = res["ckpt"]
        print(f"  rank {r}: the Trainer's sharded save {ck['save_s']:.2f} "
              f"s for its own {ck['ranges_owned']} ranges, "
              f"{ck['bytes_owned'] / 1e9:.3f} GB ({ck['save_gb_s']:.3f} "
              f"GB/s, {ck['save_us_a_range']:.1f} us a range), "
              f"host_gathers {ck['host_gathers']}; the mesh Trainer's "
              f"resume {ck['restore_mesh_s']:.2f} s ({MESH_NOTE}; {smi})")
    k7 = _mesh_k7(ranks)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    shard_rows = _shard_kernel_times(flush)
    del flush
    for res in ranks:
        res.pop("k7_leaf")
    return {"ranks": ranks, "wall_s": wall, "k7": k7,
            "ckpt_one_device": one_rank, "shard_kernels": shard_rows,
            "layout_pass": prediction, "device": smi, "note": MESH_NOTE}


# arctic-480b data-parallel on (2, 1) ("data", "model"): full width, cut to
# 2 of its 35 layers and 8 of its 128 experts (bf16 masters, int8
# moments), one micro-batch a step; each rank trains one row of 4096
MESH_DP_LAYERS = 2
MESH_DP_EXPERTS = 8
# 1 Trainer step, not MESH_STEPS, then the counted step: a step hands
# gloo ~9.4 GB (16-17 s on the card's host; the first ~26 s)
MESH_DP_ARGS = ["--arch", ARCTIC, "--data", "markov", "--batch", "2",
                "--seq", "4096", "--steps", "1", "--lr", "3e-4"]
# the fp32 check: batch, seq, the lowered capacity factor (pairs drop)
# and its depth (1 layer of 8 experts: an fp32 step of 2 layers hands
# gloo ~19 GB)
MESH_DP_FP32 = (2, 1024, 1.0, 1)


def _arctic_dp_cfg(**over):
    over = {"num_layers": MESH_DP_LAYERS, **over}
    return dataclasses.replace(get_config(ARCTIC),
                               num_experts=MESH_DP_EXPERTS,
                               train_accum_steps=1, **over)


def _fsdp_split(params, cfg, mesh):
    """(each FSDP leaf's whole gradient bytes — its shard's bytes times
    the "data" size —, the bytes of the leaves FSDP keeps whole): a
    step reduce-scatters the former once each, and all-reduces over
    "data" the latter besides the loss, MoE and optimizer statistics."""
    from repro_torch.dist.sharding import (_entry_axes, param_shardings,
                                           use_mesh)
    from repro_torch.models.model import param_shapes
    with use_mesh(mesh) as ctx:
        sh = param_shardings(param_shapes(cfg), ctx)
        data = ctx.axis_sizes["data"]
    fsdp, whole = [], 0
    for p, v in iter_leaves(params):
        n = v.numel() * v.element_size()
        if any("data" in _entry_axes(e) for e in _at(sh, p).spec):
            fsdp.append(data * n)
        else:
            whole += n
    return fsdp, whole


def _mesh_dp_rank(rank, world, prediction):
    """One rank of the data-parallel phase on cuda:0: arctic's bf16 steps
    through ``Trainer(mesh=...)``, one more step counted against the
    layout pass, then the fp32 step against one rank.  Rank 1 prints
    nothing."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()                      # the parent built it: a load
    mesh = make_host_mesh(model=1, device_type="cuda")
    if rank:
        sys.stdout = open(os.devnull, "w")
    cfg = _arctic_dp_cfg()
    print(f"== mesh dp ({MESH_NOTE}): arctic-480b at full width, "
          f"{MESH_DP_LAYERS} layers x {MESH_DP_EXPERTS} experts (of "
          f"{get_config(ARCTIC).num_layers} x "
          f"{get_config(ARCTIC).num_experts}), bf16, int8 moments, one "
          f"micro-batch, mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    out = {}
    out["train"], tr, state = _mesh_train(
        f"arctic-480b data-parallel ({MESH_DP_LAYERS} layers x "
        f"{MESH_DP_EXPERTS} experts, each rank 1 x 4096)", cfg, MESH_DP_ARGS,
        rank, mesh)
    counted = _gemm_step(tr, state, mesh)
    traffic = counted["traffic"]
    fsdp, whole = _fsdp_split(state["params"], cfg, mesh)
    ar = traffic.get("all_reduce/data", [0, 0, 0])[1]
    rs_calls, rs = traffic.get("reduce_scatter/data", [0, 0, 0])[:2]
    out.update(counted_step_ms=counted["ms"], traffic=traffic,
               fsdp_grad_bytes=sum(fsdp), whole_leaf_bytes=whole,
               device=_smi())
    if rank == 0:
        out["layout_pass"] = _check_layout_pass(prediction, counted, rank)
    print(f"  rank {rank}: gradients reduce-scattered over 'data' "
          f"{rs / 1e9:.3f} GB in {rs_calls} calls (the {len(fsdp)} FSDP "
          f"leaves' whole gradients {sum(fsdp) / 1e9:.3f} GB, the smallest "
          f"{min(fsdp) / 1e6:.1f} MB); all-reduced over 'data' "
          f"{ar / 1e6:.3f} MB, of which the leaves FSDP keeps whole "
          f"{whole / 1e6:.3f} MB and the loss, MoE and int8 row-scale "
          f"statistics the rest; the counted step {counted['ms']:.1f} ms "
          f"({MESH_NOTE}; {out['device']})")
    # every FSDP leaf's whole gradient reduce-scattered once, and the
    # all-reduce too small to hold any of them beside the whole leaves
    if rs != sum(fsdp) or not whole <= ar < min(fsdp):
        raise AssertionError(f"rank {rank}: reduce_scatter/data {rs} B, "
                             f"FSDP leaves {sum(fsdp)} B, all_reduce/data "
                             f"{ar} B, whole leaves {whole} B")
    del tr, state
    _release()
    b, s, cf, layers = MESH_DP_FP32
    fp32 = _arctic_dp_cfg(capacity_factor=cf, param_dtype="float32",
                          num_layers=layers)
    oc = OptimizerConfig(peak_lr=1e-3, warmup_steps=2, total_steps=50,
                         state_dtype=fp32.optimizer_state_dtype)
    out["fp32"] = _mesh_fp32_step(
        f"arctic-480b data-parallel ({layers} layer x {MESH_DP_EXPERTS} "
        f"experts, capacity factor {cf:g}, int8 moments)",
        fp32, b, s, rank, mesh, oc=oc)
    if not out["fp32"]["moe_dropped_tokens"] > 0:
        raise AssertionError(f"the fp32 check dropped no pair at capacity "
                             f"factor {cf}")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    dist.barrier()
    return out


def phase_mesh_dp():
    """Two ranks on cuda:0 over gloo, mesh (2, 1) ("data", "model"): the
    "data" axis, which ``phase_mesh``'s (1, 2) lacks.  arctic-480b at full
    width (2 layers x 8 experts, bf16, int8 moments) trains a step
    through ``Trainer(mesh=...)`` and one more counted, each rank its row
    of the batch:
    the batch split, the FSDP gathers and gradient reduce-scatters over
    "data", MoE's global-view slots (``moe._global_positions``) and the
    statistics' sums over "data", with K1-lse and K3 on each rank's 1 x
    4096.  Before the ranks start the parent runs the dry run's layout
    pass of the same step on ``MeshLayout((2, 1))``; rank 0's counted step
    must equal it (GEMM and kernel FLOPs, every ``TRAFFIC`` kind; peak
    memory within 10 %), every FSDP leaf's gradient reduce-scattered
    once and only the whole leaves' all-reduced.  Then an fp32 step (1
    layer x 8 experts, ``MESH_DP_FP32``) at a capacity factor that drops
    pairs, against one rank's: the same drops, parameters within 3e-4."""
    from repro_torch.launch import mesh as mesh_launch
    smi = _smi()
    print(f"== mesh dp: 2 ranks on cuda:0 over gloo, mesh (2, 1) "
          f"('data', 'model'); {smi}; {MESH_NOTE}")
    prediction = _mesh_layout_pass(_arctic_dp_cfg(), MESH_DP_ARGS, (2, 1))
    _release()
    t0 = time.perf_counter()
    ranks = mesh_launch.spawn(_mesh_dp_rank, 2, backend="gloo",
                              devices=["cuda:0", "cuda:0"],
                              args=(prediction,), timeout_s=600)
    wall = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        print(f"  rank {r}: train launches {res['train']['launches']}, step "
              f"ms {[round(t, 1) for t in res['train']['step_ms']]}, counted "
              f"step {res['counted_step_ms']:.1f} ms, peak memory "
              f"{res['peak_gb']:.2f} GB")
    print(f"  the ranks ran {wall:.1f} s ({MESH_NOTE}; {smi})")
    return {"ranks": ranks, "wall_s": wall, "layout_pass": prediction,
            "device": smi, "note": MESH_NOTE,
            "reduced": f"{MESH_DP_LAYERS} of 35 layers, {MESH_DP_EXPERTS} "
                       f"of 128 experts"}


def _mesh_ckpt_layers(ckpt_dir):
    """smollm's depth for the mesh train and checkpoint:
    ``MESH_SMOLLM_LAYERS`` unless the disk cannot hold the state twice."""
    cfg = dataclasses.replace(get_config("smollm-360m"),
                              num_layers=MESH_SMOLLM_LAYERS)
    state_bytes = 12 * _n_params(cfg)     # fp32 params, m and v
    free = shutil.disk_usage(ckpt_dir).free
    layers = cfg.num_layers
    if free < 2 * state_bytes:
        layers = max(2, int(cfg.num_layers * free / (2 * state_bytes)))
    print(f"  mesh checkpoint: smollm-360m's train state "
          f"{state_bytes / 1e9:.2f} GB, {free / 1e9:.1f} GB free at "
          f"{ckpt_dir}; depth {layers}"
          f"{' (reduced: cut for disk space)' if layers < cfg.num_layers else ''}")
    return layers


def _mesh_ckpt_one_device(ranks, ckpt_dir, layers):
    """The ranks' sharded checkpoint restored on one device with no mesh
    (whole leaves: ``restore`` then ``state_from_numpy`` onto the card):
    each rank's ``shard_of`` every whole leaf must hash to the sha1 that
    rank returned of its live shard."""
    from repro_torch.dist.sharding import MeshLayout, ShardCtx, shard_of
    from repro_torch.launch.specs import state_shardings
    cfg = dataclasses.replace(get_config("smollm-360m"), num_layers=layers)
    args = train_cli.parse_args(MESH_SMOLLM_ARGS)
    sh = state_shardings(cfg, train_cli.optimizer_config(cfg, args),
                         ShardCtx(MeshLayout((1, 2), ("data", "model"))))
    t0 = time.perf_counter()
    tree, step = ckpt.restore(ckpt_dir)
    read_s = time.perf_counter() - t0
    state = state_from_numpy(tree, "cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    nbytes = sum(a.nbytes for _p, a in iter_leaves(tree))
    del tree
    bad = [f"rank {r}: {'/'.join(p)}" for p, v in iter_leaves(state)
           for r, res in enumerate(ranks)
           if _sha1(shard_of(v, _at(sh, p), r))
           != res["ckpt"]["sha1"]["/".join(p)]]
    smi = _smi()
    print(f"  the checkpoint restored on one device with no mesh: "
          f"{nbytes / 1e9:.3f} GB read in {read_s:.2f} s, on the card in "
          f"{restore_s:.2f} s; every leaf's shard_of for both ranks "
          f"{'hashes to what the rank held' if not bad else 'DIFFERS'} "
          f"({smi})")
    del state
    torch.cuda.empty_cache()
    if bad or step != MESH_STEPS:
        raise AssertionError(f"one-device restore: step {step}, {bad[:5]}")
    return {"read_s": read_s, "restore_s": restore_s, "bytes": nbytes,
            "step": step, "layers": layers}


def _cpu_model(cfg):
    """The CPU side of a card-vs-CPU check: the same model with every
    activation kept for the backward.  ``cfg.remat`` only trades memory
    for a second forward, which on the CPU gives the same bits, and that
    forward is a quarter of the CPU's share of these phases.  (The MoE
    phases keep it: their routing records count the recompute's calls
    on both sides.)"""
    return LanguageModel(dataclasses.replace(cfg, remat="none"), "cpu")


def _tree_to(tree, device, copy=False):
    return {k: _tree_to(v, device, copy) if isinstance(v, dict)
            else v.to(device, copy=copy) for k, v in tree.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--report", type=Path,
                    help="write the run's numbers as JSON to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    _build.load()
    print(f"== build ({time.perf_counter() - t0:.1f} s): "
          f"{_build.library_path().name}")
    print(_build.log_path().read_text())

    flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device="cuda")
    timings = {}

    def timed(name, fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        timings[name] = time.perf_counter() - t
        return out

    k1 = timed("k1_s", phase_k1, flush)
    k5 = timed("k5_s", phase_k5, flush)
    k9 = timed("k9_s", phase_k9, flush)
    k9b = timed("k9b_s", phase_k9b, flush)
    ktrain = timed("k_train_s", phase_k_train, flush)
    k4 = timed("k4_s", phase_k4, flush)
    del flush
    eng_a, eng_t = timed("engine_s", phase_engine)
    contig = timed("contiguous_s", phase_contiguous)
    ssm = timed("ssm_serve_s", phase_ssm_serve)
    hybrid = timed("hybrid_serve_s", phase_hybrid_serve)
    danube = timed("danube_s", phase_danube)
    danube_train = timed("danube_train_s", phase_danube_train)
    ref_err = timed("reference_s", phase_reference)
    train = timed("train_s", phase_train)
    short_train = timed("short_train_s", phase_short_train)
    short_serve = timed("short_serve_s", phase_short_serve)
    ssm_train = timed("ssm_train_s", phase_ssm_train)
    hybrid_train = timed("hybrid_train_s", phase_hybrid_train)
    ssm_train_ref = timed("ssm_train_reference_s", phase_ssm_train_reference)
    ssm_det = timed("ssm_deterministic_s", phase_ssm_deterministic)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        restart = timed("restart_s", phase_restart, ckpt_dir)
        served = timed("serve_ckpt_s", phase_serve_ckpt, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    train_ref = timed("train_reference_s", phase_train_reference)
    kcopy = timed("copy_kernels_s", phase_copy_kernels)
    copy_paths = timed("copy_paths_s", phase_copy_paths)
    moe_serve = timed("moe_serve_s", phase_moe_serve)
    moe_train = timed("moe_train_s", phase_moe_train)
    moe_ref = timed("moe_reference_s", phase_moe_reference)
    mla_serve = timed("mla_serve_s", phase_mla_serve)
    mla_train = timed("mla_train_s", phase_mla_train)
    mla_ref = timed("mla_reference_s", phase_mla_reference)
    mla_abs = timed("mla_absorbed_s", phase_mla_absorbed)
    encdec_serve = timed("encdec_serve_s", phase_encdec_serve)
    encdec_train = timed("encdec_train_s", phase_encdec_train)
    encdec_ref = timed("encdec_reference_s", phase_encdec_reference)
    vlm_serve = timed("vlm_serve_s", phase_vlm_serve)
    vlm_train = timed("vlm_train_s", phase_vlm_train)
    vlm_ref = timed("vlm_reference_s", phase_vlm_reference)
    examples = timed("examples_s", phase_examples)
    mesh = timed("mesh_s", phase_mesh)
    mesh_dp = timed("mesh_dp_s", phase_mesh_dp)

    def both(key, phase=mesh):
        return {k: sum(r[key]["launches"][k] for r in phase["ranks"])
                for k in phase["ranks"][0][key]["launches"]}

    by_phase = {"engine_ample": {"k1": eng_a["k1_launches"],
                                 "k5": eng_a["k5_launches"]},
                "engine_tight": {"k1": eng_t["k1_launches"],
                                 "k5": eng_t["k5_launches"]},
                "contiguous": {"k1": contig["k1_launches"],
                               "k5": contig["k5_launches"]},
                "ssm_serve": ssm["launches"],
                "ssm_serve_16384": ssm["launches_16384"],
                "hybrid_serve": hybrid["launches"],
                "danube": danube["launches"],
                "danube_engine": {"k1": danube["engine"]["k1_launches"],
                                  "k5": danube["engine"]["k5_launches"]},
                "danube_train": danube_train["default"]["launches"],
                "danube_train_deterministic":
                    danube_train["deterministic"]["launches"],
                "train": train["launches"], "restart": restart["launches"],
                "serve_ckpt": served["launches"],
                "short_train": short_train["launches"],
                "short_train_other": short_train["other_route"]["launches"],
                "short_train_interleaved":
                    short_train["default_interleaved"]["launches"],
                "short_serve": short_serve["launches"],
                "ssm_train": ssm_train["launches"],
                "hybrid_train": hybrid_train["launches"],
                "ssm_train_reference": ssm_train_ref["launches"],
                "ssm_deterministic":
                    ssm_det["mamba2-1.3b"]["launches"],
                "hybrid_deterministic":
                    ssm_det["zamba2-1.2b"]["launches"],
                "moe_serve": moe_serve["launches"],
                "moe_train": moe_train["launches"],
                "moe_train_deterministic":
                    moe_train["deterministic"]["launches"],
                "moe_reference_serve": moe_ref["launches_serve"],
                "moe_reference_train": moe_ref["launches_train"],
                "mla_serve": mla_serve["launches"],
                "mla_train": mla_train["launches"],
                "mla_train_deterministic":
                    mla_train["deterministic"]["launches"],
                "mla_reference_serve": mla_ref["launches_serve"],
                "mla_reference_train": mla_ref["launches_train"],
                "mla_absorbed_prefill": mla_abs["prefill"]["launches"],
                "mla_absorbed_train": mla_abs["train"]["launches"],
                "mla_absorbed_train_deterministic":
                    mla_abs["train_deterministic"]["launches"],
                "mla_absorbed_fp32_train": mla_abs["fp32"]["launches_train"],
                "mla_absorbed_fp32_prefill":
                    mla_abs["fp32"]["launches_prefill"],
                "encdec_serve": encdec_serve["launches"],
                "encdec_prefill_4096": encdec_serve["launches_4096"],
                "encdec_train": encdec_train["launches"],
                "encdec_train_deterministic":
                    encdec_train["deterministic"]["launches"],
                "encdec_reference_serve": encdec_ref["launches_serve"],
                "encdec_reference_train": encdec_ref["launches_train"],
                "vlm_serve": vlm_serve["launches"],
                "vlm_train": vlm_train["launches"],
                "vlm_reference_serve": vlm_ref["launches_serve"],
                "vlm_reference_train": vlm_ref["launches_train"],
                "examples_serve": examples["serve"]["launches"],
                "examples_train": examples["train"]["launches"],
                "examples_wavefront": examples["wavefront"]["launches"],
                # both ranks' launches (2 ranks sharing the card)
                "mesh_train_smollm": both("train_smollm"),
                "mesh_train_llama": both("train_llama"),
                "mesh_serve_smollm": both("serve_smollm"),
                "mesh_serve_llama": both("serve_llama"),
                "mesh_dp_train_arctic": both("train", mesh_dp)}

    def launches(*keys):
        per = {ph: sum(c.get(k, 0) for k in keys)
               for ph, c in by_phase.items()}
        return sum(per.values()), per

    k1["launches"], k1["launches_by_phase"] = launches("k1", "k1_lse")
    k1["launches_with_lse"] = launches("k1_lse")[0]
    k1["lse_at_train_shape"] = ktrain["k1_lse"]
    k1["lse_deepseek"] = {**ktrain["deepseek"]["k1_lse"],
                          "timed_shape": ktrain["deepseek"]["timed_shape"]}
    k1["lse_whisper"] = {**ktrain["whisper"]["k1_lse"],
                         "timed_shape": ktrain["whisper"]["timed_shape"]}
    k5["launches"], k5["launches_by_phase"] = launches("k5")
    k1["mesh_stripe_lse"] = mesh["shard_kernels"]["k1_lse"]
    k5["mesh_local_heads"] = mesh["shard_kernels"]["k5"]
    kernels = [k1, k5]
    src_bwd = "src/repro_torch/kernels/csrc/flash_attention_bwd.cu"
    src_hopper = "src/repro_torch/kernels/csrc/flash_attention_hopper.cu"
    for key, name, replaces in (
            ("k2_dq", "flash_attention_bwd_dq (K2 dq)",
             "src/repro/kernels/flash_attention.py:451"),
            ("k2_dkv", "flash_attention_bwd_dkv (K2 dk/dv)",
             "src/repro/kernels/flash_attention.py:494"),
            ("k3", "flash_attention_bwd_fused (K3)",
             "src/repro/kernels/flash_attention.py:541")):
        # the timed shape (hd 64, bf16) runs K2's dq on mma.sync, dk/dv
        # and K3 on wgmma
        row = {"name": name, "route": "cuda",
               "source": src_bwd if key == "k2_dq" else src_hopper,
               "replaces": replaces, **ktrain[key],
               "timed_shape": "B=4 H=15 KH=5 S=4096 hd=64 bf16 causal",
               **{shape: {**ktrain[shape][key],
                          "timed_shape": ktrain[shape]["timed_shape"]}
                  for shape in ("deepseek", "whisper")}}
        row["launches"], row["launches_by_phase"] = launches(key)
        if key == "k3":
            row["mesh_stripe"] = mesh["shard_kernels"]["k3"]
        kernels.append(row)
    src_copy = "src/repro_torch/kernels/csrc/partition_copy.cu"
    copy_phase = {"ops_partition_copy_bytes": copy_paths["ops"],
                  "runtime_4mib": copy_paths["runtime_4mib"]["launches"],
                  "runtime_256mib": copy_paths["runtime_256mib"]["launches"],
                  "mesh_leaf_reassembly": mesh["k7"]["launches"],
                  "examples_quickstart": {
                      k: examples["quickstart"]["launches"].get(k, 0)
                      for k in ("k6", "k7", "k8")}}
    for key, name, replaces in (
            ("k6", "partition_copy (K6)",
             "src/repro/kernels/partition_copy.py:52"),
            ("k7", "multi_partition_copy_tiles (K7)",
             "src/repro/kernels/partition_copy.py:151"),
            ("k8", "multi_partition_copy_staged (K8)",
             "src/repro/kernels/partition_copy.py:204")):
        per = {ph: c[key] for ph, c in copy_phase.items()}
        kernels.append({"name": name, "route": "cuda", "source": src_copy,
                        "replaces": replaces, **kcopy[key],
                        "launches": sum(per.values()),
                        "launches_by_phase": per})
    k9["launches"], k9["launches_by_phase"] = launches("k9")
    kernels.append(k9)
    k9b["launches"], k9b["launches_by_phase"] = launches("k9b")
    kernels.append(k9b)
    src_mega = "src/repro_torch/kernels/csrc/flash_attention_mega.cu"
    for key, name, replaces, counter in (
            ("k4f", "flash_attention_mega_fwd (K4f)",
             "src/repro/kernels/flash_attention.py:243", "k4f"),
            ("k4b", "flash_attention_mega_bwd (K4b)",
             "src/repro/kernels/flash_attention.py:312", "k4b")):
        row = {"name": name, "route": "cuda", "source": src_mega,
               "replaces": replaces, **k4[key],
               "timed_shape": "B=64 H=15 KH=5 S=256 hd=64 bf16 causal"}
        row["launches"], row["launches_by_phase"] = launches(counter)
        if key == "k4f":
            row["launches_with_lse"] = launches("k4f_lse")[0]
            row["lse"] = k4["k4f_lse"]
        kernels.append(row)
    # the (576, 512) pair's kernels (csrc/flash_attention_wide.cu): their
    # launches on the absorbed route alone, timed at its shapes
    src_wide = "src/repro_torch/kernels/csrc/flash_attention_wide.cu"
    absorbed = [ph for ph in by_phase if ph.startswith("mla_absorbed")]
    for key, name, replaces, timing, shape in (
            ("k1", "flash_attention at (576, 512) (K1, absorbed MLA)",
             ":134", k1["mla_absorbed"], k1["mla_absorbed"]["timed_shape"]),
            ("k1_lse", "flash_attention_fwd at (576, 512) (K1-lse)", ":134",
             ktrain["mla_absorbed"]["k1_lse"],
             ktrain["mla_absorbed"]["timed_shape"]),
            ("k2_dq", "flash_attention_bwd_dq at (576, 512) (K2 dq)", ":451",
             ktrain["mla_absorbed"]["k2_dq"],
             ktrain["mla_absorbed"]["timed_shape"]),
            ("k2_dkv", "flash_attention_bwd_dkv at (576, 512) (K2 dk/dv)",
             ":494", ktrain["mla_absorbed"]["k2_dkv"],
             ktrain["mla_absorbed"]["timed_shape"]),
            ("k3", "flash_attention_bwd_fused at (576, 512) (K3)", ":541",
             ktrain["mla_absorbed"]["k3"],
             ktrain["mla_absorbed"]["timed_shape"])):
        per = {ph: by_phase[ph].get(key, 0) for ph in absorbed}
        kernels.append({"name": name, "route": "cuda", "source": src_wide,
                        "replaces": "src/repro/kernels/flash_attention.py"
                        + replaces, **timing, "timed_shape": shape,
                        "launches": sum(per.values()),
                        "launches_by_phase": per})
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on the path")
    name = torch.cuda.get_device_name(0)
    report = {"device": smi, "kernels": kernels, "engine_ample": eng_a,
              "engine_tight": eng_t, "contiguous": contig,
              "ssm_serve": ssm, "hybrid_serve": hybrid, "danube": danube,
              "danube_train": danube_train,
              "reference": ref_err, "train": train,
              "restart": restart, "serve_ckpt": served,
              "train_reference": train_ref, "copy_paths": copy_paths,
              "k4": k4, "short_train": short_train,
              "short_serve": short_serve, "ssm_train": ssm_train,
              "hybrid_train": hybrid_train,
              "ssm_train_reference": ssm_train_ref,
              "ssm_deterministic": ssm_det, "moe_serve": moe_serve,
              "moe_train": moe_train, "moe_reference": moe_ref,
              "mla_serve": mla_serve, "mla_train": mla_train,
              "mla_reference": mla_ref, "mla_absorbed": mla_abs,
              "encdec_serve": encdec_serve,
              "encdec_train": encdec_train, "encdec_reference": encdec_ref,
              "vlm_serve": vlm_serve, "vlm_train": vlm_train,
              "vlm_reference": vlm_ref, "examples": examples,
              "mesh": mesh, "mesh_dp": mesh_dp,
              "library_bwd_ms": ktrain["library_bwd_ms"], "phase_s": timings,
              "total_s": time.perf_counter() - t_start,
              "build_log": _build.log_path().read_text()}
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(report, indent=1))
    print(f"phases (s): {json.dumps(timings)}; all of the run "
          f"{report['total_s']:.1f} s")
    print(smi)     # again near the end, where a cut log still shows it
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

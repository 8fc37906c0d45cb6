#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

  1. builds the port's kernels from the sources in this checkout: the
     nine CUDA C++ sources (``wemd``, ``persample_gradnorm``,
     ``flash_attention``, ``flash_attention_bwd``, ``wkv``, ``wkv_bwd``,
     ``rglru_scan``, which also holds the RG-LRU backward, ``head_split``
     and ``moe_rows``) with one nvcc each, all at once; prints ptxas's
     registers, spills and warnings for the kernels of every source;
  2. holds every kernel against its plain PyTorch version on the card,
     at ``tests/test_kernels.py``'s shape sweep and tolerances and at the
     round's shapes (``wemd_*`` to 1e-5 on f32 and on f64 inputs, the f64
     output bitwise equal to the output on the f32-cast inputs; sigma to
     1e-3, gi_sq to atol 1e-2; attention f32 atol 3e-5 / rtol 1e-4, bf16
     atol 1e-3 / rtol 8e-3, tighter than the sweep's 3e-2; wkv atol 2e-3
     / rtol 1e-3 on y and state, with T = 1, T = 17, T = 3072, hd 128
     and an empty batch, and 1e-3 in the w=1e-4 and w=1e-8 cases; rglru
     atol 1e-5 + rtol 1e-5 on h and h_T at the sweep, T = 1, T = 257,
     T = 3072 and D = 37, and at a = 0, 1 and 0.9999 (unit b over 100
     steps, b = sqrt(1 - a^2) x over 3072), h_T the last step's h and a
     second call bitwise equal; persample_gradnorm on int64 and int32
     labels, bitwise equal, at B = 33 / d = 37, C = 100 and h in column
     tiles, and V = 0 launching nothing; the WEMD kernels also at 100
     classes, (1, 64, 100), (8, 27, 100), (32, 23, 100), and
     persample_gradnorm at the ResNet's d = 512, C = 100 for V = 19 and
     152, aligned gradients included); the backward kernels against
     autograd of the plain attention (f32 at 3e-5 / 1e-4 on the CUDA
     cores, bf16 at one bf16 step on the tensor cores; GQA groups of 1,
     2 and 10, head sizes 32 to 256, a window, T > S, the train step's
     shape, there also with 1, 2 and 10 parts of the GQA sum) and the
     written-out reverse RG-LRU recurrence (1e-5; da, which is g h_{t-1},
     at 1e-5 x max(1, max |h|); a = 1 and 0.9999), each twice, bitwise
     equal; and the WKV backward (K5-bwd, from the forward's chunk
     states) against the plain backward in f64 at the rwkv6-3b train
     shape [16, 256, 40, 64], at T = 250 and at hd 128: on each gradient
     at most ``WKV_BWD_ERR_MULT`` (16) times the f32 plain version's
     error, two calls bitwise equal; and the head's split (K7) bitwise
     equal to its plain version at the rwkv6-3b head chunk with f32's
     edge values, at a ragged shape and off alignment, two calls bitwise
     equal;
  3. solves 100 seeded random P1 problems with the torch scheduler on the
     card (25 at each of V = 16 and 64 for C = 10 and C = 100) and
     requires the numpy solvers' masks and iteration counts;
  4. drives the FL main path: ``FederatedTrainer`` on the full-width
     paper CNN (V=64 devices, batch 32, 32x32x3 images, dropout on), 3
     rounds of ``fedcgd-fscd`` and 3 of ``fedcgd-gs`` with
     ``scheduler_backend="torch"``; every round must have finite losses,
     2 host syncs, the numpy solver's mask on the same Problem and
     Eq. 10 sigmas (from the ``persample_gradnorm`` kernel) within 2e-6
     relative plus 1e-6 of the device's rms ||h_i|| of Eq. 10 in f64
     from the materialised per-sample gradients on the same features,
     one ``solve_many`` and one K3 launch, and every FL kernel must have
     been launched in that run; a second
     ``fedcgd-fscd`` trainer on the same seed must give a bitwise-equal
     history (records, masks, iteration counts, sigmas) and bitwise-equal
     params after its 3 rounds; then one more round of each, held to the
     same checks, under ``repro_torch.obs.profile_rounds`` after a
     warm-up round (the device's busy share of the round, its longest
     kernels and the split by the round's phases);
  5. drives the same path batched over 8 cells: ``MultiCellTrainer``
     (seeds 0-7, phase 4's world and config, ``num_cells=8``), 3 rounds
     of each scheduler; every cell's mask and iteration count must equal
     the numpy solver's on its unpadded ``Problem`` with no padded row
     scheduled, every round must make 2 host syncs and one
     ``solve_many``, launch K3 once for all cells and give sigmas within
     phase 4's tolerance of Eq. 10 in f64; a second 8-cell engine on the
     same
     seeds must be bitwise equal, and a one-cell engine bitwise equal to
     ``FederatedTrainer``; logs each warm 8-cell round beside 8 x the
     single-cell warm rounds, one profiled 8-cell round of each
     scheduler, and each cell's sigmas against Eq. 10 in f64 beside the
     closed form's and the one-pass sum's;
  6. drives the same path on ResNet18-GN (``RESNET18_GN_CIFAR100``:
     32x32x3 images, 64-512 channels, 11.22 M parameters) on synthetic
     CIFAR-100-shaped data (100 classes x 500, sorted over 64 devices,
     seed 0) with phase 4's config: phase 4's rounds and checks (K1/K2
     over 100 classes, K3 at d = 512), then 2 FSCD rounds of an 8-cell
     engine held to phase 5's round checks; logs peak memory;
  7. drives the LM serving path through ``repro_torch.serve.generate``:
     recurrentgemma-2b, then rwkv6-3b, each at published width and full
     depth in bf16 with seeded random weights, B=4 prompts of 3072
     tokens (longer than the 2048 window), 32 sampled tokens.  Prefill
     must launch the attention kernel 8 times and the RG-LRU kernel 18
     times (recurrentgemma), the WKV kernel 32 times (rwkv6), and decode
     no kernel; logits must be finite; the prefill step
     (``fl.distributed.make_prefill_step``: the head on the last position
     only) must give the full forward's last-position logits within
     ``HEAD_TOL`` x scale; and the prefill step of P tokens plus 8
     teacher-forced decode steps (the plain decode route) must agree
     with one forward of P+8 tokens (the kernel route), in f32 on each
     reduced config (2e-3 * scale, the bound of the JAX package's
     tests/test_models_smoke.py) and in bf16 on the full ones and on
     their first layers (``BF16_CONSISTENCY``, ``LM_DEPTHS``);
 7b. serves the rest of the LM zoo (``phase_lm_zoo``): qwen2-7b,
     gemma3-27b, moonshot-v1-16b-a3b and llama-3.2-vision-11b (with 1601
     encoder embeddings) at published width and full depth, B=4 prompts
     of 3072 tokens, 32 sampled tokens; then yi-34b (B=1), musicgen-large
     (the prefill step alone, over frame embeddings), qwen3-moe-235b-a22b
     cut to 11 layers and arctic-480b cut to 2 (what fits in about 60
     GB); bf16, seeded random
     weights with every cross layer's gate 1.0 and the QKV biases and
     RMS-norm scales N(0, 0.02).  Each prefill must launch the attention
     kernel once an attention layer, cross layers included
     (``ZOO_PREFILL_LAUNCHES``), and decode none; the prefill step's
     last-position logits must lie within ``HEAD_TOL`` x scale of the
     full forward's head (over its last ``ZOO_HEAD_ROWS`` positions; it
     logs whether they are bitwise the head on the forward's last row
     alone, and that head's gap to the one over 512 rows); the
     prefill step of P tokens plus 8 teacher-forced decode steps must
     agree with one forward of P+8 within ``ZOO_BF16_CONSISTENCY`` (an
     MoE model on one sequence at capacity factor min(E/k, 16), where it
     must drop nothing, and again with every layer routed as the forward,
     within ``ZOO_REPLAYED_CONSISTENCY``, where a step's own choice may
     differ from the forward's only at a near-tie, ``ZOO_FLIP_GAP``);
     logs the dropped MoE assignments at the published capacity factor,
     1.25, and each model's peak memory; then holds the attention kernel
     to its plain version (bf16 and f32) at every shape these prefills
     launched it at;
  8. trains recurrentgemma-2b, then rwkv6-3b, at published width and
     depth (bf16, each layer rematerialised) through
     ``launch.federated_lm_silos.run``: FedCGD over 8 silos of 2
     sequences of 256 tokens, 3 rounds of one schedule-weighted train
     step (recurrentgemma-2b's CE chunked: 256 x 256000 > 2**24;
     rwkv6-3b's whole: 256 x 65536 = 2**24); every round's loss and grad
     norm finite; a round launches recurrentgemma-2b's attention and
     RG-LRU kernels 16 and 36 times (the forward and its recompute) and
     their backward kernels 8 and 18 times, rwkv6-3b's WKV kernel 64
     times and its backward 32 times, and each the head's split (K7,
     the bf16 head's backward) once, nothing else; a second run on the
     same seed bitwise equal (metrics, masks, params); one plain
     ``make_train_step`` step, and one profiled through
     ``repro_torch.obs.profile_rounds``; peak memory logged.  Before each:
     the reduced f32 step on the card against the same step on the CPU
     (loss within 1e-5 relative, params within 1e-4 in L2 a leaf);
 8b. trains the rest of the LM zoo the same way (``phase_lm_zoo_train``,
     through the same ``train_arch``), each model at published width
     with its zero-initialised leaves drawn nonzero as in phase 7b and
     the VLM's encoder embeddings N(0, 1) in the card / CPU check:
     qwen2-7b, moonshot-v1-16b-a3b (cut to 24 of 48 layers) and
     llama-3.2-vision-11b with phase 8's 3 rounds, twin, plain step and
     profiled step; gemma3-27b and yi-34b (24 layers), musicgen-large
     (frame embeddings), qwen3-moe-235b-a22b (5 of 94) and arctic-480b
     (1 of 35) with one round and the twin (``ZOO_TRAIN``).  A round
     launches K4 twice and K4-bwd once an attention layer, self and
     cross, K7 once, and nothing else (``train_step_launches``, worked
     out from each config's layers); the MoE models' twins hold the fixed-order
     MoE backward; each round's model-FLOP share of the bf16 peak
     (``repro_torch.roofline.model_flops``) is logged, and the peak must
     stay under ``ZOO_TRAIN_PEAK_GIB``.  Then K4-bwd against its plain
     version (bf16 and f32, two calls bitwise equal) at every shape those
     steps launched it at and at gemma3-27b's local layers at S = T =
     2048 (window 1024);
 8c. the sharding context on the one card (``phase_sharded``): a
     one-rank nccl group from an in-process ``HashStore``, a (1, 1)
     ("data", "model") mesh and ``launch.shardings.make_ctx`` with the
     regime the 16-way production model axis picks; one federated train
     step (phase 8's world) of qwen2-7b at full depth (context-parallel),
     moonshot-v1-16b-a3b at 24 layers (MoE, every expert local),
     llama-3.2-vision-11b (cross attention), recurrentgemma-2b and
     rwkv6-3b (K6 / K5 and their backward kernels through ``local_map``)
     on DTensor params, each bitwise equal to the unsharded step (loss,
     grad norm, every param leaf) with the same launches
     (``SHARDED_TRAIN``); qwen2-7b's prefill of 4 x 3072 tokens and 8
     decode steps bitwise equal to the unsharded ones; K4 and K4-bwd on
     query shards at their offsets against the plain version at
     qwen2-7b's and gemma3-27b's heads, bf16 and f32 (``Q_OFFSET_*``);
     and, in processes of their own on the host's CPU, the dry runs of
     qwen2-7b train_4k on 16x16 and 2x16x16 and moonshot-v1-16b-a3b on
     16x16 (``repro_torch.launch.dryrun``): per device FLOPs, bytes,
     collective bytes, peak and the roofline's bottleneck logged, and
     qwen2-7b's counted FLOPs x devices over 6 N D within
     ``DRYRUN_RATIO``;
 8d. moonlight-16b-a3b's latent attention at the benchmark cell
     ``moonlight-silos``'s shape (``phase_mla``, ``MLA_SHAPE``: q and k
     [8, 16, 4096, 192], v [8, 16, 4096, 128], causal, scale
     1/sqrt(192)): K4 and K4-bwd at the (192, 128) pair on bf16 and f32
     against their plain versions (``BF16_ATTN_TOL``, ``F32_ATTN_TOL``);
     one federated train step of the cell's cut (``MLA_CUT``: experts
     0-7 of 64, 20480 ids; all 27 layers) over 8 x 4096 tokens, its
     launches ``train_step_launches`` at that length (K8's four entry
     points 52 / 52 / 26 / 26) and K4 / K4-bwd at ``MLA_SHAPE`` alone, a
     second step from the same seed bitwise equal;
  9. times each kernel at the shapes of its last main-path launch (the
     LM kernels at their prefill shapes, the backward kernels at the
     train step's (K5-bwd from the forward's chunk states, no library
     call computing its function), SDPA's backward alone as attention's
     yardstick;
     K1-K3 also at their 8-cell
     shapes, rows ``<name>@C8``, K1/K2 at the ResNet rounds' 100
     classes, rows ``<name>@C100``, K3 at the ResNet's single-cell
     and 8-cell shapes, rows ``persample_gradnorm@R`` and ``@Rx8``, and
     attention at the zoo's prefill shapes, rows ``attention@<arch>/<kind>``
     for qwen2-7b, gemma3-27b's local and global layers and
     llama-3.2-vision-11b's cross layers, and attention's backward at the
     zoo's train shapes, rows ``attention_bwd@<arch>/<kind>`` for
     qwen2-7b (GQA group 7), qwen3-moe-235b-a22b (group 16) and
     llama-3.2-vision-11b's cross layers, attention and its backward at
     ``MLA_SHAPE`` with phase 8d's launches, rows
     ``attention@moonlight-16b-a3b`` and ``attention_bwd@...``, the
     head's split at the
     benchmark's rwkv6-3b head chunk, ``HEAD_CHUNK``, and the held MoE's
     dispatch and combine (K8's four entry points in a row, once each)
     at the cell's ``MOE_ROWS_SHAPE`` on a seeded routing, row
     ``moe_rows@moonlight-16b-a3b``)
     beside its plain version, one
     library call where one computes the same function (``cdist`` for
     the WEMD scans, ``scaled_dot_product_attention`` under the window
     mask for attention), and the least time the card could take (its
     bound), and holds it to its plain version there again (attention
     also in f32 at that shape, atol 3e-5 / rtol 1e-4): ``ms`` is
     the median per-call time of back-to-back calls by CUDA events (what
     a caller pays, launch included), ``device_ms`` the kernels' own
     device time from a ``torch.profiler`` trace; for the WEMD kernels
     also ``path_ms``, the call as the scheduler makes it (``ops.wemd_*``
     on f64 inputs, bitwise equal to ``ms``'s call on the cast inputs);
     for ``persample_gradnorm`` also ``path_ms``, the round's call
     (``ops.persample_gradnorm`` on int64 labels), which must run one
     device op (no cast kernel in front of the kernel); for attention
     also the rate over the visible pairs (``tflops``); for attention's
     backward the time with each part count of the GQA sum
     (``parts_ms``) and the device time of each of its launches
     (``device_kernels``); for the head's split the head's three
     products there as f32 and as the bf16 route (``products_ms``,
     ``head_products``); for K8 each entry point's ms, device ms and
     bound (``entries``); for every kernel the share of the bound
     (``bound_share``, bound over device time).

Before the last line come a JSON object with one entry per kernel and
the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the rest of the checkout, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SIGMA_ATOL = SIGMA_RTOL = 1e-3  # K3 vs its plain version (f32)
# The round's sigmas vs Eq. 10 in f64 (``sigma_tolerance``): 2e-6
# relative (~9x the kernel's largest reading on devices whose sigma is
# not tiny, 2.34e-7; the one-pass f32 sum was up to 9.6e-4 off on
# diverging cells) plus 1e-6 of the device's rms ||h_i||: an f32 softmax
# resolves a confident sample's error e only to ~6e-8, so a device whose
# own sigma is small carries ~6e-8 * ||h|| of it (up to 6e-3 relative).
SIGMA_F64_RTOL = 2e-6
SIGMA_F64_FLOOR = 1e-6
TPU_KERNELS = {
    "wemd_add": "src/repro/kernels/wemd_swap.py:115",
    "wemd_swap": "src/repro/kernels/wemd_swap.py:74",
    "persample_gradnorm": "src/repro/kernels/persample_gradnorm.py:65",
    "attention": "src/repro/kernels/flash_attention.py:77",
    "wkv": "src/repro/kernels/rwkv_scan.py:75",
    "rglru": "src/repro/kernels/rglru_scan.py:50",
    # the backward kernels: the JAX package differentiates its plain
    # model and has no backward kernel, so each names the TPU kernel whose
    # function it differentiates
    "attention_bwd": "src/repro/kernels/flash_attention.py:77",
    "rglru_bwd": "src/repro/kernels/rglru_scan.py:50",
    "wkv_bwd": "src/repro/kernels/rwkv_scan.py:75",
    # the LM head's f32 product on the bf16 tensor cores: the JAX package
    # leaves that product to XLA, so the split replaces no TPU kernel
    "head_split": "none (the f32 LM head's cotangent split into three "
                  "bf16 terms)",
    # the held MoE's dispatch and combine: the JAX package gathers into
    # capacity buffers with XLA
    "moe_rows": "none (the held-expert MoE's dispatch and combine)",
}
# kernels launched by the train step alone, timed at its shapes
TRAIN_KERNELS = ("attention_bwd", "rglru_bwd", "wkv_bwd", "head_split")
# kernels timed at the moonlight-silos cell's shapes alone (phase 8d)
MLA_KERNELS = ("moe_rows",)
FL_KERNELS = ("wemd_add", "wemd_swap", "persample_gradnorm")
# the kernels' symbols in a profiler trace
PORT_KERNEL_SYMBOLS = ("wemd_", "psg_kernel", "flash_", "wkv_chunked",
                       "rglru_scan", "attn_bwd_", "wkv_bwd_", "head_split_",
                       "moe_rows_")
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {
    "wemd_add": ("cuda", CSRC + "wemd.cu"),
    "wemd_swap": ("cuda", CSRC + "wemd.cu"),
    "persample_gradnorm": ("cuda", CSRC + "persample_gradnorm.cu"),
    "attention": ("cuda", CSRC + "flash_attention.cu"),
    "wkv": ("cuda", CSRC + "wkv.cu"),
    "rglru": ("cuda", CSRC + "rglru_scan.cu"),
    "attention_bwd": ("cuda", CSRC + "flash_attention_bwd.cu"),
    "rglru_bwd": ("cuda", CSRC + "rglru_scan.cu"),
    "wkv_bwd": ("cuda", CSRC + "wkv_bwd.cu"),
    "head_split": ("cuda", CSRC + "head_split.cu"),
    "moe_rows": ("cuda", CSRC + "moe_rows.cu"),
}
# K5-bwd against the plain backward in f64: on each gradient the kernel's
# max abs error at most WKV_BWD_ERR_MULT times the f32 plain version's
# (or 2^-24 of the gradient's largest entry, where that is larger).  The
# first card run read ratios of 0.55-8.4 (8.4: dw at hd 128; 0.75-3.0 at
# the train shape): the kernel's decays go through ex2/lg2.approx and its
# sums run in other orders (tests/test_torch_kernels_cuda.py's bound).
WKV_BWD_ERR_MULT = 16
# the rwkv6-3b train shape and a tail (T off the chunk of 16), hd 64 and 128
WKV_BWD_SHAPES = [(16, 256, 40, 64), (16, 250, 40, 64), (4, 256, 20, 128),
                  (4, 250, 20, 128)]
# LM serving phase: batch, prompt (> the 2048 window), sampled tokens,
# teacher-forced decode steps of the consistency check
LM_BATCH, LM_PROMPT, LM_GEN, LM_CHECK = 4, 3072, 32, 8
LM_PREFILL_LAUNCHES = {"recurrentgemma-2b": {"attention": 8, "rglru": 18},
                       "rwkv6-3b": {"wkv": 32}}
# prefill (kernel route) vs decode (plain route) at bf16: max abs error
# over max(1, max |logit|), and relative L2 error.  bf16 keeps 8 bits;
# the decode route rounds attention probabilities to bf16 where the
# kernel keeps them in f32, and matmuls of other shapes round otherwise.
# The readings at full depth are deterministic (three runs on one H100
# gave the same digits): recurrentgemma-2b 0.006825 and 0.02242, rwkv6-3b
# 0.06971 and 0.06116, which is the size of the JAX package's own bf16
# error for rwkv6 (tests/test_torch_lm.py).  The bounds are about 1.5x
# recurrentgemma's readings and 1.3-1.4x rwkv6's.
BF16_CONSISTENCY = {"recurrentgemma-2b": (0.01, 0.035),
                    "rwkv6-3b": (0.1, 0.08)}
# depths (whole pattern periods) of the first layers whose bf16
# prefill/decode gap is also read, to see where over the depth it grows
LM_DEPTHS = {"recurrentgemma-2b": (3, 6, 12, 24),
             "rwkv6-3b": (1, 2, 4, 8, 16)}
F32_CONSISTENCY = 2e-3          # tests/test_models_smoke.py's bound
# the benchmark cell's rwkv6-3b head chunk, [M, K] x [K, N]: 16 sequences x
# CE_CHUNK positions, d_model 2560, vocab 65536
HEAD_CHUNK = (16 * 512, 2560, 65536)
# the prefill step's last-position logits vs the full forward's: one trunk,
# the f32 head GEMM at M = B rows against M = B S (tests/test_torch_lm.py's
# f32 logit tolerance)
HEAD_TOL = 1e-4
# bf16 attention against its f32-accumulated plain version: both round
# the same f32 value to bf16 once, so they differ by at most one bf16
# step (< 2**-7 relative) plus f32 noise
BF16_ATTN_TOL = (1e-3, 8e-3)
F32_ATTN_TOL = (3e-5, 1e-4)
# psg_path's trace of K3's round call: calls a trace, and traces that may
# come back empty before its "the kernel alone" check fails
PSG_CALLS, PSG_TRACES = 100, 4


def log(msg: str) -> None:
    print(msg, flush=True)


def smi(query="name,power.limit") -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip()


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# kernel inputs, plain versions, library yardsticks and bounds


def wemd_inputs(torch, B, V, C, size, seed, device, dtype=None):
    """f32 inputs, or f64 as the scheduler keeps them."""
    import numpy as np
    dtype = dtype or torch.float32
    rng = np.random.default_rng(seed)
    p_dev = torch.tensor(rng.dirichlet(np.full(C, 0.4), size=(B, V)),
                         dtype=dtype, device=device)
    p_sum = p_dev[:, :size].sum(dim=1)
    gd = p_dev.mean(dim=1)
    cw = torch.tensor(rng.uniform(0.5, 1.5, (B, C)), dtype=dtype,
                      device=device)
    sizes = torch.full((B,), float(size), dtype=dtype, device=device)
    return p_sum, p_dev, gd, cw, sizes


def psg_inputs(torch, V, B, d, C, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    h = torch.randn((V, B, d), generator=g).to(device)
    logits = torch.randn((V, B, C), generator=g).to(device)
    labels = torch.randint(0, C, (V, B), generator=g).to(device)
    return h, logits, labels


def psg_aligned(torch, V, B, d, C, seed, device, spread=0.003, scale=1e4):
    """Per-sample gradients sharing a large common part (every h_i near
    one direction, every softmax near one class, one label): mean
    ||g_i||^2 / sigma^2 is about 1 / spread^2, where a one-pass f32 sum
    of sigma^2 loses three digits."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    h = scale * (torch.randn((V, 1, d), generator=g)
                 + spread * torch.randn((V, B, d), generator=g))
    logits = torch.randn((V, B, C), generator=g)
    logits[..., 0] += 30.0
    return (h.to(device), logits.to(device),
            torch.ones((V, B), dtype=torch.int64, device=device))


def sigma_f64(torch, h, logits, labels):
    """Eq. 10 in f64 from the materialised per-sample gradients: h
    [..., B, d], logits [..., B, C], labels [..., B] -> [...]."""
    e = torch.softmax(logits.double(), -1) - torch.nn.functional.one_hot(
        labels, logits.shape[-1]).double()
    g = h.double()[..., :, :, None] * e[..., :, None, :]
    return torch.sqrt(((g - g.mean(-3, keepdim=True)) ** 2).sum((-2, -1))
                      .mean(-1))


def attn_inputs(torch, B, H, KV, S, T, hd, dtype, seed, device, hdv=None):
    """q [B,H,S,hd], k [B,KV,T,hd] and v [B,KV,T,hdv] (hdv: hd unless
    given) as views of [B,S,H,.] memory, the layout the model hands the
    kernel."""
    g = torch.Generator(device=device).manual_seed(seed)

    def draw(n, heads, width=hd):
        return torch.randn((B, n, heads, width), generator=g, device=device,
                           dtype=dtype).transpose(1, 2)
    return draw(S, H), draw(T, KV), draw(T, KV, hdv or hd)


def attn_dims(shp):
    """(B, H, S, hd, KV, T, hdv, kw) of an attention shape key, laid out
    as ``common.SHAPES`` keys it: q's shape, k's, (causal, window), and
    v's where its head size is not q's (a head pair); ``kw`` the kernel's
    mask keywords, with the scale 1/sqrt(hd) given at a head pair, as
    ``models/mla.py`` gives it."""
    (B, H, S, hd), (_, KV, T, _), (causal, window), *vs = shp
    kw = dict(causal=bool(causal), window=window)
    if vs:
        kw["scale"] = 1.0 / math.sqrt(hd)
    return B, H, S, hd, KV, T, (vs[0][3] if vs else hd), kw


def wkv_inputs(torch, B, T, H, hd, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=device) * scale
    w = torch.sigmoid(randn(B, T, H, hd) * 2) * 0.6 + 0.39
    return (randn(B, T, H, hd), randn(B, T, H, hd, scale=0.3),
            randn(B, T, H, hd), w, randn(H, hd, scale=0.1),
            randn(B, H, hd, hd, scale=0.5))


def rglru_inputs(torch, B, T, D, seed, device, a_val=None, scaled=False):
    """a in [0.8, 0.999], or ``a_val`` everywhere; unit b, or b =
    sqrt(1 - a^2) x as RG-LRU forms it; h0 ~ N(0, 1)."""
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.rand((B, T, D), generator=g, device=device) * 0.199 + 0.8
    if a_val is not None:
        a = torch.full_like(a, a_val)
    b = torch.randn((B, T, D), generator=g, device=device)
    if scaled:
        b = torch.sqrt(1 - a * a) * b
    return a, b, torch.randn((B, D), generator=g, device=device)


def window_mask(torch, S, T, causal, window, device):
    """[S,T] bool, True where attention_ref lets query q see key k."""
    qi = torch.arange(S, device=device)[:, None] + (T - S)
    ki = torch.arange(T, device=device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        ok &= ki <= qi
    if window > 0:
        ok &= ki > qi - window
    return ok


def cdist_add(torch, p_sum, p_dev, gd, cw, sizes):
    """wemd_add as one L1 distance: cw >= 0 folds into both sides."""
    s1 = (sizes + 1.0)[:, None, None]
    x = p_dev / s1 * cw[:, None, :]
    y = -((p_sum[:, None, :] / s1 - gd[:, None, :]) * cw[:, None, :])
    return x, y


def cdist_swap(torch, p_sum, p_dev, gd, cw, sizes):
    s = sizes[:, None, None]
    a = ((p_sum[:, None, :] - p_dev) / s - gd[:, None, :]) * cw[:, None, :]
    b = -(p_dev / s) * cw[:, None, :]
    return a, b


def visible_pairs(S, T, causal, window):
    """(query, key) pairs attention_ref lets through, per (batch, head)."""
    import numpy as np
    q = np.arange(S) + (T - S)
    hi = np.minimum(q, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(S, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def bound(name, shapes, itemsize=4):
    """(bound_ms, bound_by): bytes each input read once and each output
    written once over HBM, operations over the peak rate of their type
    (the f32 rate, and bf16 tensor cores for bf16 attention), at the
    H100 SXM's peaks from ``repro_torch.roofline``."""
    from repro_torch.roofline import F32_FLOPS, HBM_BW, PEAK_FLOPS, TF32_FLOPS
    rate = F32_FLOPS
    if name == "attention_bwd":
        # reads q, k, v, dO, writes dq, dk, dv; s, dq and dk take 2 hd
        # FLOPs each a visible pair, dP and dv 2 hdv (v's head size)
        B, H, S, hd, KV, T, hdv, kw = attn_dims(shapes)
        nbytes = itemsize * (B * H * S * (2 * hd + hdv)
                             + 2 * B * KV * T * (hd + hdv))
        ops = 2 * (3 * hd + 2 * hdv) * B * H * visible_pairs(
            S, T, kw["causal"], kw["window"])
        rate = PEAK_FLOPS if itemsize == 2 else F32_FLOPS
    elif name == "rglru_bwd":
        # reads a, h, dh [B,T,D] and h0, dh_T [B,D], writes da, db and dh0;
        # an FMA for g and a product for da an element
        (B, T, D), = shapes
        nbytes = 4 * (5 * B * T * D + 3 * B * D)
        ops = 3 * B * T * D
    elif name == "wkv_bwd":
        # reads r, k, v, w, dy, u, the chunk states and dS_T, writes dr,
        # dk, dv, dw, du and dS_0; the design's operations a chunk, f32 on
        # the CUDA cores and TF32 on the tensor cores, which run side by
        # side (so the larger of the two times)
        (B, T, H, hd), = shapes
        nch = -(-T // 16)
        nbytes = 4 * (9 * B * T * H * hd + 2 * H * hd
                      + (B * nch + 2 * B) * H * hd * hd)
        f32_ops, tc_ops = (B * H * nch * x for x in wkv_bwd_chunk_ops(hd))
        ops, rate = max((f32_ops, F32_FLOPS), (tc_ops, TF32_FLOPS),
                        key=lambda x: x[0] / x[1])
    elif name == "head_split":
        # reads the f32 cotangent, writes its three bf16 terms
        (M, N), = shapes
        nbytes, ops = 10 * M * N, 0
    elif name == "moe_rows":
        # K8's four entry points once each
        nbytes, ops = sum(moe_rows_bytes(shapes, itemsize).values()), 0
    elif name == "attention":
        # s takes 2 hd FLOPs a visible pair, the output 2 hdv
        B, H, S, hd, KV, T, hdv, kw = attn_dims(shapes)
        nbytes = itemsize * (B * H * S * (hd + hdv) + B * KV * T * (hd + hdv))
        ops = 2 * (hd + hdv) * B * H * visible_pairs(S, T, kw["causal"],
                                                     kw["window"])
        rate = PEAK_FLOPS if itemsize == 2 else F32_FLOPS
    elif name == "wkv":
        (B, T, H, hd), = shapes
        nbytes = 4 * (5 * B * T * H * hd + H * hd + 2 * B * H * hd * hd)
        ops = B * H * T * (5 * hd * hd + 3 * hd)
    elif name == "rglru":
        (B, T, D), = shapes
        nbytes = 4 * (3 * B * T * D + 2 * B * D)
        ops = 2 * B * T * D
    elif name == "wemd_add":
        (B, V, C), = shapes
        nbytes = 4 * (3 * B * C + B * V * C + B + B * V)
        ops = 6 * B * V * C
    elif name == "wemd_swap":
        (B, V, C), = shapes
        nbytes = 4 * (3 * B * C + B * V * C + B + B * V * V)
        ops = 7 * B * V * V * C
    else:                           # labels int64, as the round's
        (V, B, d), (_, _, C) = shapes
        nbytes = 4 * (V * B * d + V * B * C + V * B + V) + 8 * V * B
        # what the function needs: softmax errors, ||h_i||^2, H^T E and
        # the Eq. 10 reduction (the kernel's second pass over the rows,
        # which keeps f32's digits, is not counted)
        ops = V * (8 * B * C + 2 * B * d + 2 * B * d * C + 2 * d * C)
    t_bytes, t_ops = nbytes / HBM_BW, ops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def wkv_bwd_chunk_ops(hd, L=16):
    """(f32 operations on the CUDA cores, TF32 operations on the tensor
    cores) of one chunk of one (batch, head) in ``csrc/wkv_bwd.cu``,
    counted from its code (an FMA is two; ex2 and lg2 one each).  CUDA
    cores: the decays, b r, k a and 2^lct (10 a (t, d)), the lo parts of
    v and dy, the forward's A (5 a pair and channel, 3 a diagonal term),
    X, 2^lct G, the steps' decays (2 a step and channel) and per (t, d)
    of dr, dk and dw 17 + 6t + (15 - t)(7 + 2t) (its q < t and s > t
    sums).  Tensor cores: B, SD, GV, dv's two terms and G's update, each
    multiply-add three TF32 products (3xTF32)."""
    pairs = L * (L - 1) // 2
    per_d = 2 * (L - 1) + sum(17 + 6 * t + (L - 1 - t) * (7 + 2 * t)
                              for t in range(L))
    f32 = (10 * L * hd + hd + 2 * L * hd + 5 * pairs * hd + 3 * L * hd
           + 3 * hd * hd + per_d * hd)
    macs = 4 * L * hd * hd + 2 * L * L * hd
    return f32, 3 * 2 * macs


def calls_per_rep(torch, fn, most=50, target_s=0.05):
    """Back-to-back calls that take about ``target_s`` (1 to ``most``),
    from one timed call after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return max(1, min(most, int(target_s / (time.perf_counter() - t0))))


def time_ms(torch, fn, reps=7):
    """Median over ``reps`` of the mean per-call time of back-to-back
    calls (50, or fewer for a slow call), by CUDA events, after a
    warm-up."""
    inner = calls_per_rep(torch, fn)
    reps = reps if inner > 1 else 3
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / inner)
    return statistics.median(out)


def profiler_works(torch) -> bool:
    """Whether ``torch.profiler`` can trace the card here, from one
    traced no-op.  Only this probe is guarded: the profiled work itself
    runs outside any ``try``, so its failures end the script."""
    from torch.profiler import ProfilerActivity, profile
    try:
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.cuda.synchronize()
    except RuntimeError as e:
        log(f"profiler unavailable, device times not measured: {e}")
        return False
    return True


def device_kernels(torch, fn):
    """Each kernel ``fn`` launches (name cut to 60 characters) -> [device
    ms a launch, launches a call], from a ``torch.profiler`` trace of 50
    calls or fewer: the kernels' own time, without the host's launch
    path.  A trace can drop a launch, so launches a call are a kernel's
    count over the calls, rounded, at least 1."""
    from torch.profiler import ProfilerActivity, profile
    n = calls_per_rep(torch, fn)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0 and ev.count:
            out[ev.key[:60]] = [t / ev.count / 1e3,
                                max(1, round(ev.count / n))]
    return out


def attention_bwd_trace(torch, fn, kernels, tries=3):
    """K4-bwd's ``device_kernels``, traced again (``tries`` in all) until
    it names both the dq and the dkv kernel; None (no device time) when
    no trace does.  A trace that dropped one of them would give the time
    of half the work."""
    def whole(ks):
        return all(any(f"attn_bwd_{part}" in key for key in ks)
                   for part in ("dq", "dkv"))
    for i in range(tries):
        if whole(kernels):
            return kernels
        log(f"attention_bwd: trace {i + 1} lacks the dq or the dkv kernel "
            f"({sorted(kernels)})")
        if i + 1 < tries:
            kernels = device_kernels(torch, fn)
    log("attention_bwd: no whole trace; no device time for this row")
    return None


def device_ms(torch, fn, kernels=None):
    """Device time of the kernels ``fn`` launches, per call (None when
    the trace holds no device time), from ``device_kernels`` (or its
    given result)."""
    kernels = device_kernels(torch, fn) if kernels is None else kernels
    total = sum(ms * k for ms, k in kernels.values())
    return total if total > 0 else None


def attention_bwd_parts(torch, dev, shp):
    """K4-bwd's bf16 ms a call at ``shp`` with each part count of the GQA
    sum (a divisor of the group), by CUDA events, after holding each to
    the default part count's output at the bf16 tolerance."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    B, H, S, hd, KV, T, hdv, kw = attn_dims(shp)
    q, k, v = attn_inputs(torch, B, H, KV, S, T, hd, torch.bfloat16, 96, dev,
                          hdv)
    do = attn_inputs(torch, B, H, KV, S, T, hdv, torch.bfloat16, 97, dev)[0]
    base = flash_attention_bwd_cuda(q, k, v, do, **kw)
    out = {}
    for parts in [p for p in range(1, H // KV + 1) if (H // KV) % p == 0]:
        def call(parts=parts):
            return flash_attention_bwd_cuda(q, k, v, do, parts=parts, **kw)
        for g, w in zip(call(), base):
            require(bool(torch.allclose(g.float(), w.float(),
                                        atol=BF16_ATTN_TOL[0],
                                        rtol=BF16_ATTN_TOL[1])),
                    f"attention_bwd with {parts} parts disagrees")
        out[parts] = time_ms(torch, call)
    return out


# ---------------------------------------------------------------------------
# phases


def phase_build(torch, dev):
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import common
    from repro_torch.kernels import flash_attention as K4
    from repro_torch.kernels import head_split as K7
    from repro_torch.kernels import moe_rows as K8
    from repro_torch.kernels import persample_gradnorm as K3
    from repro_torch.kernels import rglru_scan as K6
    from repro_torch.kernels import rwkv_scan as K5
    from repro_torch.kernels import wemd_swap as K12
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:     # one nvcc per source, at once
        for f in [pool.submit(fn) for fn in (K12._launchers, K3._launcher,
                                             K4._launcher, K4._bwd_launcher,
                                             K5._launcher, K5._bwd_launcher,
                                             K6._launcher, K7._launcher,
                                             K8._launchers)]:
            f.result()
    K6._bwd_launcher()                      # rglru_scan.cu's second entry
    log(f"build: nvcc of 9 sources in parallel "
        f"{time.perf_counter() - t0:.2f} s (" + ", ".join(
            f"{k} {v:.2f} s" for k, v in common.BUILD_SECONDS.items()) + ")")
    log("ptxas, wemd.cu: " + ptxas_summary(
        common.BUILD_LOGS.get("wemd.cu", "")))
    lib = common.load_library("flash_attention.cu")
    log("ptxas, flash_attention.cu: " + ptxas_summary(
        common.BUILD_LOGS.get("flash_attention.cu", ""))
        + "; dynamic shared memory a block: " + ", ".join(
            f"{route} hd{hd} {lib.flash_attention_smem_bytes(hd, dt)} B"
            for dt, route in ((1, "bf16"), (0, "f32"))
            for hd in K4.HEAD_SIZES))
    for src in ("flash_attention_bwd.cu", "wkv.cu", "wkv_bwd.cu",
                "rglru_scan.cu", "persample_gradnorm.cu", "head_split.cu",
                "moe_rows.cu"):
        log(f"ptxas, {src}: "
            + ptxas_summary(common.BUILD_LOGS.get(src, "")))


def ptxas_summary(text: str) -> str:
    """Registers, spills and static shared memory of each kernel in an
    ``nvcc -Xptxas -v`` log, and every ptxas warning (``wgmma``
    serialisation among them).  The attention kernels' shared memory is
    dynamic, so ptxas does not see it: ``flash_attention_smem_bytes``
    reports it."""
    import re
    out, name = [], "?"
    for line in text.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"flash_(wgmma|kernel)ILi(\d+)E", line)
            w = re.search(r"wemd_(add|swap)_kernelI([fd])E", line)
            c = re.search(r"wkv_chunkedILi(\d+)E", line)
            cb = re.search(r"wkv_bwd_chunkedILi(\d+)E", line)
            r = re.search(r"rglru_scan(_bwd)?ILb([01])E", line)
            a = re.search(r"attn_bwd_(dq|dkv)IfLi(\d+)E", line)
            aw = re.search(r"attn_bwd_(dq|dkv)_wgmmaILi(\d+)E", line)
            p = re.search(r"psg_kernelI([xi])Lb([01])E", line)
            mr = re.search(r"\dmoe_rows_(\w+?)I(13__nv_bfloat16|f)Li(\d)E",
                           line)
            if m:
                name = (f"{'bf16 wgmma' if m[1] == 'wgmma' else 'f32'} "
                        f"hd{m[2]}")
            elif w:
                name = f"{w[1]} {'f64' if w[2] == 'd' else 'f32'} inputs"
            elif c:
                name = f"wkv hd{c[1]}"
            elif cb:
                name = f"wkv bwd hd{cb[1]}"
            elif "wkv_bwd_du" in line:
                name = "wkv bwd du sum"
            elif r:
                name = (f"rglru{' bwd' if r[1] else ''} "
                        f"{'16-byte' if r[2] == '1' else '4-byte'} rows")
            elif a:
                name = f"attention bwd {a[1]} f32 hd{a[2]}"
            elif aw:
                name = f"attention bwd {aw[1]} bf16 wgmma hd{aw[2]}"
            elif "attn_bwd_gqa_sum" in line:
                name = "attention bwd GQA sum"
            elif "head_split_vec" in line:
                name = "head_split 16-byte groups"
            elif "head_split_scalar" in line:
                name = "head_split one element a step"
            elif mr:
                name = (f"moe_rows {mr[1]} "
                        f"{'f32' if mr[2] == 'f' else 'bf16'} x{mr[3]}")
            elif p:
                name = (f"psg int{64 if p[1] == 'x' else 32} labels, "
                        f"{'16-byte' if p[2] == '1' else '4-byte'} h")
            else:
                name = line.split("'")[1]
        elif "spill stores" in line:
            out.append(f"{name}: {line.strip()}")
        elif "Used" in line and "registers" in line and out:
            out[-1] += "; " + line.split(":", 1)[1].strip()
        elif "warning" in line:
            out.append(line.strip())
    return " | ".join(out) if out else "no report (library was cached)"


def phase_kernel_checks(torch, dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels.persample_gradnorm import (
        persample_gradnorm_cuda)
    worst = {}

    def close(name, got, want, atol, rtol):
        torch.cuda.synchronize()
        err = (got - want).abs()
        require(bool((err <= atol + rtol * want.abs()).all()),
                f"{name}: max abs err {float(err.max()):.3g} over tolerance")
        worst[name] = max(worst.get(name, 0.0), float(err.max()))

    wemd_checks(torch, dev, close)
    for i, (B, d, C) in enumerate([(64, 120, 10), (100, 512, 100),
                                   (32, 48, 5), (130, 64, 16),
                                   (32, 120, 10)]):
        h, logits, labels = psg_inputs(torch, 1, B, d, C, 50 + i, dev)
        s, gi = persample_gradnorm_cuda(h[0], logits[0], labels[0])
        sr, gr = ref.persample_gradnorm_ref(h[0], logits[0], labels[0])
        close("persample_gradnorm", s, sr, 1e-3, 1e-3)
        close("persample_gradnorm.gi_sq", gi, gr, 1e-2, 1e-3)
    psg_checks(torch, dev, close)
    lm_kernel_checks(torch, dev, close)
    head_split_checks(torch, dev)
    log("kernels vs plain: " + ", ".join(
        f"{k} max abs err {v:.3g}" for k, v in worst.items()))


def psg_checks(torch, dev, close):
    """The batched Eq. 10 kernel at the round's shapes (V = 19, 23, 64,
    and 200 for 8 cells; the ResNet's d = 512 and C = 100 at V = 19 and
    152), B off 32 with d off 4, C = 100 and h in column tiles (100, 512,
    100): sigma within 1e-3, gi_sq within atol 1e-2;
    int64 labels (the round's) and int32 labels give one bit pattern, and
    so does a second call; on nearly aligned per-sample gradients sigma
    within 1e-5 relative of Eq. 10 in f64; V = 0 launches nothing."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.persample_gradnorm import (
        persample_gradnorm_cuda_batched as kern)
    for i, (V, B, d, C) in enumerate([(19, 32, 120, 10), (23, 32, 120, 10),
                                      (64, 32, 120, 10), (3, 33, 37, 10),
                                      (2, 32, 120, 100), (2, 100, 512, 100),
                                      (200, 32, 120, 10), (19, 32, 512, 100),
                                      (152, 32, 512, 100)]):
        h, logits, labels = psg_inputs(torch, V, B, d, C, 70 + i, dev)
        s, gi = kern(h, logits, labels)
        s32, gi32 = kern(h, logits, labels.to(torch.int32))
        again = kern(h, logits, labels)
        sr, gr = ref.persample_gradnorm_ref(h, logits, labels)
        close("persample_gradnorm", s, sr, 1e-3, 1e-3)
        close("persample_gradnorm.gi_sq", gi, gr, 1e-2, 1e-3)
        require(labels.dtype == torch.int64 and torch.equal(s, s32)
                and torch.equal(gi, gi32) and torch.equal(s, again[0])
                and torch.equal(gi, again[1]),
                f"persample_gradnorm at {(V, B, d, C)}: int64 and int32 "
                f"labels, or two calls, differ")
    for i, (V, B, d, C) in enumerate([(8, 32, 120, 10), (2, 100, 512, 100),
                                      (19, 32, 512, 100),
                                      (152, 32, 512, 100)]):
        h, logits, labels = psg_aligned(torch, V, B, d, C, 90 + i, dev)
        s, _ = kern(h, logits, labels)
        close("persample_gradnorm.aligned", s.double(),
              sigma_f64(torch, h, logits, labels), 0.0, 1e-5)
    h, logits, labels = psg_inputs(torch, 0, 32, 120, 10, 79, dev)
    before = LAUNCHES["persample_gradnorm"]
    s, gi = kern(h, logits, labels)
    require(tuple(s.shape) == (0,) and tuple(gi.shape) == (0, 32)
            and LAUNCHES["persample_gradnorm"] == before,
            "persample_gradnorm: V = 0 gives empty outputs and no launch")


def wemd_checks(torch, dev, close):
    """Both WEMD kernels against their plain versions to 1e-5 at the sweep
    and the round's shapes, on f32 inputs and on f64 inputs (the
    scheduler's); the f64 output must be bitwise the output on the
    f32-cast inputs.  (2, 300, 10) takes more than one block of devices;
    the last three shapes are the ResNet rounds' 100 classes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.wemd_swap import wemd_add_cuda, wemd_swap_cuda
    f64 = torch.float64
    resnet = [(1, 64, 100), (8, 27, 100), (32, 23, 100)]
    swap_shapes = [(2, 16, 10), (1, 64, 10), (3, 7, 5), (2, 33, 100),
                   (1, 130, 130), (2, 19, 11), (32, 19, 10), (32, 64, 10),
                   (2, 300, 10)] + resnet
    add_shapes = [(2, 16, 10), (1, 64, 10), (3, 7, 5), (2, 33, 100),
                  (1, 19, 10), (1, 64, 10), (1, 130, 130),
                  (2, 300, 10)] + resnet
    for name, kern, plain, shapes, size, seed in (
            ("wemd_swap", wemd_swap_cuda, ref.wemd_swap_ref, swap_shapes, 5,
             10),
            ("wemd_add", wemd_add_cuda, ref.wemd_add_ref, add_shapes, 3, 30)):
        for i, (B, V, C) in enumerate(shapes):
            args = wemd_inputs(torch, B, V, C, min(size, V), seed + i, dev)
            out, want = kern(*args), plain(*args)
            require(out.shape == want.shape, f"{name} shape")
            close(name, out, want, 1e-5, 1e-5)
            a64 = wemd_inputs(torch, B, V, C, min(size, V), seed + i, dev,
                              f64)
            a32 = [a.float() for a in a64]
            out64 = kern(*a64)
            close(f"{name}.f64", out64, plain(*a32), 1e-5, 1e-5)
            require(out64.dtype == torch.float32
                    and torch.equal(out64, kern(*a32)),
                    f"{name} at {(B, V, C)}: the f64 output is not the "
                    f"output on the f32-cast inputs")


def lm_kernel_checks(torch, dev, close):
    """The LM kernels against their plain versions at
    ``tests/test_kernels.py``'s sweep and tolerances, plus one case of
    recurrentgemma's layout (ten query heads on one key head, hd 256)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rglru_scan import rglru_cuda
    from repro_torch.kernels.rwkv_scan import wkv_cuda
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(B, H, H, S, T, hd, c, w, f32)
             for B, H, S, T, hd in [(2, 3, 128, 128, 64), (1, 2, 256, 256, 64),
                                    (2, 2, 100, 100, 32), (1, 2, 64, 192, 64),
                                    (1, 1, 128, 128, 128), (1, 1, 257, 257, 64)]
             for c, w in [(True, 0), (True, 32), (False, 0)]]
    cases += [(1, 2, 2, 128, 128, 64, True, 0, bf16),
              (2, 10, 1, 300, 300, 256, True, 64, f32),
              (2, 10, 1, 300, 300, 256, True, 64, bf16)]
    for i, (B, H, KV, S, T, hd, causal, window, dt) in enumerate(cases):
        q, k, v = attn_inputs(torch, B, H, KV, S, T, hd, dt, 100 + i, dev)
        out = flash_attention_cuda(q, k, v, causal=causal, window=window)
        want = ref.attention_ref(q, k, v, causal=causal, window=window)
        require(out.dtype == dt, "attention output dtype")
        if dt == f32:
            close("attention", out, want, *F32_ATTN_TOL)
        else:
            close("attention.bf16", out.float(), want.float(),
                  *BF16_ATTN_TOL)
    wkv_checks(torch, dev, close)
    rglru_checks(torch, dev, close)
    bwd_checks(torch, dev, close)
    wkv_bwd_checks(torch, dev)


def bwd_checks(torch, dev, close):
    """The backward kernels against their plain versions: attention's dq,
    dk, dv (f32 at the forward's 3e-5 / 1e-4 on the CUDA cores, bf16 at
    one bf16 step on the tensor cores) over GQA groups of 1, 2 and 10,
    head sizes 32 to 256, a window, T > S, S off the tiles and the train
    step's [16, 10, 256, 256] (bf16 also with each part count of the GQA
    sum); RG-LRU's da, db, dh0 within 1e-5 (da within 1e-5 times max(1,
    max |h|): it is g h_{t-1}) at the sweep, T = 1, T = 257, D = 37 and
    a = 1 and 0.9999; a second call of each bitwise equal."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    from repro_torch.kernels.rglru_scan import rglru_bwd_cuda
    f32, bf16 = torch.float32, torch.bfloat16
    for i, (B, H, KV, S, T, hd, causal, window, dt, parts) in enumerate([
            (2, 3, 3, 128, 128, 64, True, 0, f32, None),
            (1, 4, 2, 100, 300, 128, True, 0, f32, None),
            (2, 10, 1, 300, 300, 256, True, 64, f32, None),
            (1, 2, 2, 257, 257, 32, False, 0, f32, None),
            (2, 3, 3, 128, 128, 64, True, 0, bf16, None),
            (1, 2, 2, 257, 257, 32, False, 0, bf16, None),
            (1, 4, 2, 100, 300, 128, True, 0, bf16, None),
            (2, 4, 2, 130, 130, 64, True, 40, bf16, None),
            (2, 10, 1, 300, 300, 256, True, 100, bf16, None),
            (16, 10, 1, 256, 256, 256, True, 2048, bf16, None),
            (16, 10, 1, 256, 256, 256, True, 2048, bf16, 1),
            (16, 10, 1, 256, 256, 256, True, 2048, bf16, 2),
            (16, 10, 1, 256, 256, 256, True, 2048, bf16, 10)]):
        q, k, v = attn_inputs(torch, B, H, KV, S, T, hd, dt, 400 + i, dev)
        do = attn_inputs(torch, B, H, KV, S, T, hd, dt, 500 + i, dev)[0]
        got = flash_attention_bwd_cuda(q, k, v, do, causal=causal,
                                       window=window, parts=parts)
        want = ref.attention_bwd_ref(q, k, v, do, causal=causal,
                                     window=window)
        again = flash_attention_bwd_cuda(q, k, v, do, causal=causal,
                                         window=window, parts=parts)
        for name, g, w, g2 in zip(("dq", "dk", "dv"), got, want, again):
            require(g.dtype == dt and torch.equal(g, g2),
                    f"attention bwd {name}: dtype, or two calls differ")
            if dt == f32:
                close("attention_bwd", g, w, *F32_ATTN_TOL)
            else:
                close("attention_bwd.bf16", g.float(), w.float(),
                      *BF16_ATTN_TOL)
    for i, (B, T, D, a_val) in enumerate([
            (2, 300, 64, None), (3, 37, 100, None), (2, 1, 64, None),
            (2, 257, 37, None), (16, 256, 2560, None), (2, 100, 64, 1.0),
            (2, 100, 37, 0.9999)]):
        a, b, h0 = rglru_inputs(torch, B, T, D, 600 + i, dev, a_val)
        h, _ = ref.rglru_ref(a, b, h0)
        dh, dT = (torch.randn_like(x) for x in (h, h0))
        got = rglru_bwd_cuda(a, h, h0, dh, dT)
        want = ref.rglru_bwd_ref(a, h, h0, dh, dT)
        require(all(torch.equal(x, y) for x, y in
                    zip(got, rglru_bwd_cuda(a, h, h0, dh, dT))),
                f"rglru bwd at {(B, T, D)}: two calls differ")
        atol = 1e-5 * max(1.0, float(h.abs().max()))
        close("rglru_bwd.da", got[0], want[0], atol, 1e-5)
        close("rglru_bwd", got[1], want[1], 1e-5, 1e-5)
        close("rglru_bwd", got[2], want[2], 1e-5, 1e-5)


def wkv_bwd_inputs(torch, B, T, H, hd, seed, device):
    """``wkv_inputs`` and the outputs' gradients dy, dS_T ~ N(0, 1)."""
    g = torch.Generator(device=device).manual_seed(seed + 1)
    return (*wkv_inputs(torch, B, T, H, hd, seed, device),
            torch.randn((B, T, H, hd), generator=g, device=device),
            torch.randn((B, H, hd, hd), generator=g, device=device))


def wkv_bwd_checks(torch, dev):
    """K5-bwd from the forward's chunk states against the plain backward
    in f64 at ``WKV_BWD_SHAPES``: each gradient's max abs error at most
    ``WKV_BWD_ERR_MULT`` times the f32 plain version's (logged as the
    ratio); two calls bitwise equal."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rwkv_scan import wkv_bwd_cuda, wkv_cuda
    names = ("dr", "dk", "dv", "dw", "du", "dstate")
    for i, (B, T, H, hd) in enumerate(WKV_BWD_SHAPES):
        r, k, v, w, u, s0, dy, ds = wkv_bwd_inputs(torch, B, T, H, hd,
                                                   720 + i, dev)
        chunks = wkv_cuda(r, k, v, w, u, s0, save_chunks=True)[2]
        got = wkv_bwd_cuda(r, k, v, w, u, chunks, dy, ds)
        again = wkv_bwd_cuda(r, k, v, w, u, chunks, dy, ds)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"wkv_bwd at {(B, T, H, hd)}: two calls differ")
        ratios = {}
        for name, g, p, t in zip(names, got,
                                 ref.wkv_bwd_ref(r, k, v, w, u, s0, dy, ds),
                                 ref.wkv_bwd_ref(*(x.double() for x in (
                                     r, k, v, w, u, s0, dy, ds)))):
            err = float((g.double() - t).abs().max())
            floor = max(float((p.double() - t).abs().max()),
                        2.0 ** -24 * float(t.abs().max()))
            ratios[name] = err / floor
            require(err <= WKV_BWD_ERR_MULT * floor,
                    f"wkv_bwd {name} at {(B, T, H, hd)}: max abs err "
                    f"{err:.3g} over {WKV_BWD_ERR_MULT} x the f32 plain "
                    f"version's {floor:.3g}")
        log(f"wkv_bwd at {(B, T, H, hd)} vs f64: kernel error over the f32 "
            f"plain version's " + ", ".join(
                f"{k} {v:.2f}" for k, v in ratios.items())
            + f" (bound {WKV_BWD_ERR_MULT}); two calls bitwise equal")


def head_split_checks(torch, dev):
    """K7 against its plain version, bitwise, at the rwkv6-3b head chunk's
    cotangent with f32's edge values written over its first entries
    (ties, tiny and subnormal values, infinities, NaN, -0), at a ragged
    shape (the one-element path) and off 16-byte alignment; two calls
    bitwise equal."""
    from repro_torch.kernels.head_split import head_split_cuda, split3_ref
    M, _, N = HEAD_CHUNK
    edges = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                          float("nan"), 1e-40, -1e-45, 2.0 ** -110,
                          2.0 ** -111 * 1.5, 3e38, 1.0 + 2.0 ** -8,
                          1.0 + 3 * 2.0 ** -8, 1.0 + 2.0 ** -16,
                          1.0 + 2.0 ** -8 + 2.0 ** -17], device=dev)
    for shape, offset in (((M, N), 0), ((999, 5003), 0), ((64, 1024), 1)):
        g = torch.Generator(device=dev).manual_seed(sum(shape))
        n = shape[0] * shape[1]
        buf = torch.randn(n + offset, generator=g, device=dev)
        buf.mul_(torch.exp2(torch.randint(-120, 100, (n + offset,),
                                          generator=g, device=dev).float()))
        buf[offset:offset + edges.numel()] = edges
        d = buf[offset:].view(shape)
        got, again = head_split_cuda(d), head_split_cuda(d)
        want = split3_ref(d)
        torch.cuda.synchronize()
        require(torch.equal(got.view(torch.int16), want.view(torch.int16)),
                f"head_split at {shape}: not bitwise its plain version")
        require(torch.equal(got.view(torch.int16), again.view(torch.int16)),
                f"head_split at {shape}: two calls differ")
    log("head_split at [8192, 65536], [999, 5003] and off alignment: "
        "bitwise its plain version, two calls bitwise equal")


def rglru_checks(torch, dev, close):
    """The RG-LRU scan against its step-by-step plain version at atol
    1e-5 + rtol 1e-5 on h and h_T: the sweep, T = 1, T = 257 (off the
    run and the segment), D = 37 (the kernel's 4-byte loads), T = 3072
    (12 segments of carry); a = 0, 1 and 0.9999 with unit b over 100
    steps and with b = sqrt(1 - a^2) x (RG-LRU's) over 3072; h_T is the
    last step's h, and a second call gives the same bits."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rglru_scan import rglru_cuda
    cases = [(B, T, D, None, False) for B, T, D in [
        (2, 300, 64), (1, 128, 512), (3, 37, 100), (1, 1024, 256),
        (2, 1, 64), (2, 257, 37), (3, 100, 37), (1, 3072, 256)]]
    cases += [(2, T, D, a_val, scaled) for a_val in (0.0, 1.0, 0.9999)
              for T, D, scaled in [(100, 64, False), (100, 37, False),
                                   (3072, 64, True)]]
    for i, (B, T, D, a_val, scaled) in enumerate(cases):
        args = rglru_inputs(torch, B, T, D, 300 + i, dev, a_val, scaled)
        h, hT = rglru_cuda(*args)
        hr, hTr = ref.rglru_ref(*args)
        close("rglru", h, hr, 1e-5, 1e-5)
        close("rglru", hT, hTr, 1e-5, 1e-5)
        h2, hT2 = rglru_cuda(*args)
        require(torch.equal(hT, h[:, -1]) and torch.equal(h, h2)
                and torch.equal(hT, hT2),
                f"rglru at {(B, T, D, a_val)}: h_T is not the last h, or "
                f"two calls differ")


def wkv_checks(torch, dev, close):
    """The WKV kernel against its step-by-step plain version at atol 2e-3
    / rtol 1e-3 on y and the final state: the sweep, T = 1 and T = 17 (a
    chunk mostly past T), T = 3072 (192 chunks of drift), hd 128; an empty batch
    launches nothing; w = 1e-4 (hd 16) and w = 1e-8 over 48 steps (hd 64)
    finite and within 1e-3."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.rwkv_scan import wkv_cuda
    for i, (B, T, H, hd) in enumerate([(2, 48, 3, 32), (1, 16, 2, 64),
                                       (2, 100, 2, 16), (1, 64, 1, 64),
                                       (2, 1, 2, 64), (2, 17, 3, 64),
                                       (1, 3072, 2, 64), (2, 40, 2, 128)]):
        args = wkv_inputs(torch, B, T, H, hd, 200 + i, dev)
        y, st = wkv_cuda(*args)
        yr, sr = ref.wkv_ref(*args)
        close("wkv", y, yr, 2e-3, 1e-3)
        close("wkv.state", st, sr, 2e-3, 1e-3)
    args = wkv_inputs(torch, 0, 16, 2, 64, 208, dev)
    before = LAUNCHES["wkv"]
    y, st = wkv_cuda(*args)
    require(tuple(y.shape) == (0, 16, 2, 64) and tuple(st.shape)
            == (0, 2, 64, 64) and LAUNCHES["wkv"] == before,
            "wkv: an empty batch gives empty outputs and no launch")
    for i, (T, hd, wval) in enumerate([(32, 16, 1e-4), (48, 64, 1e-8)]):
        r, k, v, _, u, _ = wkv_inputs(torch, 1, T, 1, hd, 210 + i, dev)
        w = torch.full_like(r, wval)                # extreme decay
        s0 = torch.zeros((1, 1, hd, hd), device=dev)
        y, st = wkv_cuda(r, k, v, w, u, s0)
        require(bool(torch.isfinite(y).all() and torch.isfinite(st).all()),
                f"wkv: not finite at w={wval}")
        yr, sr = ref.wkv_ref(r, k, v, w, u, s0)
        close("wkv", y, yr, 1e-3, 1e-3)
        close("wkv.state", st, sr, 1e-3, 1e-3)


def phase_scheduler(torch, dev):
    import numpy as np
    from repro_torch.core import scheduling as S
    from repro_torch.obs import Obs

    def random_problem(rng, V, C, infeasible_frac):
        p_dev = rng.dirichlet(np.full(C, 0.4), size=V)
        min_bw = rng.uniform(0.4, 1.6, V)
        if infeasible_frac:
            min_bw[rng.random(V) < infeasible_frac] = -1.0
        return S.Problem(p_dev=p_dev,
                         global_dist=rng.dirichlet(np.full(C, 3.0)),
                         class_weights=rng.uniform(0.5, 1.5, C),
                         sigma=float(rng.uniform(2.0, 6.0)), batch_size=32,
                         min_bw=min_bw, total_bw=V * 0.5)

    obs = Obs(enabled=True)
    for C, V in ((10, 16), (10, 64), (100, 16), (100, 64)):
        rng = np.random.default_rng(2000 + V + (C != 10))
        probs = [random_problem(rng, V, C, 0.2 if t % 3 == 0 else 0.0)
                 for t in range(25)]
        for alg, fn in (("gs", S.greedy_scheduling), ("fscd", S.fscd)):
            t0 = time.perf_counter()
            got = S.solve_many(probs, alg, backend="torch", obs=obs,
                               device=dev)
            dt = time.perf_counter() - t0
            for t, (p, g) in enumerate(zip(probs, got)):
                e = fn(p)
                require(np.array_equal(e.mask, g.mask)
                        and e.iterations == g.iterations,
                        f"scheduler {alg} V={V} C={C} problem {t}: mask or "
                        f"iterations differ from numpy")
            log(f"scheduler {alg} V={V} C={C}: 25 problems equal to numpy, "
                f"{dt:.3f} s")
    c = obs.metrics.counters
    log(f"scheduler host syncs: {int(c['sched.host_syncs.torch'].value)} "
        f"over {int(c['sched.solve_many_calls.torch'].value)} batched solves")


def check_round(torch, tr, solve, tag, rec) -> tuple:
    """Hold one main-path round to the numpy solver's mask and iteration
    count on the same Problem, finite losses, 2 host syncs, and its
    kernel-computed Eq. 10 sigmas to Eq. 10 in f64 (``sigma_errors``);
    returns the sigmas' errors."""
    import numpy as np
    prob, sched = tr.solved[-1]
    want = solve(prob)
    require(np.array_equal(want.mask, sched.mask)
            and want.iterations == sched.iterations,
            f"{tag}: mask differs from numpy")
    require(np.isfinite(rec["mean_local_loss"]), f"{tag}: loss not finite")
    require(tr.last_round_host_syncs == 2,
            f"{tag}: {tr.last_round_host_syncs} host syncs")
    return sigma_errors(torch, tr.model.cfg, *tr.sigmas[-1], tag)


def cell_heads(torch, cfg, params_c, images):
    """Per cell, the penultimate features [V, b, d] and logits [V, b, C]
    of its model (params [C, ...]) on its devices' first batches
    (images [C, V, b, ...]), as the round core computes them."""
    from repro_torch.fl.rounds import _cnn_features_logits
    C, V, b = images.shape[:3]
    for c in range(C):
        feats, logits = _cnn_features_logits(
            {k: x[c] for k, x in params_c.items()}, cfg,
            images[c].reshape((V * b,) + images.shape[3:]))
        yield feats.reshape(V, b, -1), logits.reshape(V, b, -1)


def sigma_tolerance(torch, h, truth):
    """Per device: ``SIGMA_F64_RTOL`` of its Eq. 10 sigma in f64
    (``truth`` [V]) plus ``SIGMA_F64_FLOOR`` of its rms ||h_i||
    (features h [V, b, d])."""
    rms_h = torch.sqrt((h.double() ** 2).sum(-1).mean(-1))
    return SIGMA_F64_RTOL * truth + SIGMA_F64_FLOOR * rms_h


def sigma_errors(torch, cfg, params_c, images, labels, sigma, tag) -> tuple:
    """Hold kernel-computed Eq. 10 sigmas [C, V] (params [C, ...], first
    batches [C, V, b, ...]) to Eq. 10 in f64 on the same features, cell
    by cell, within ``sigma_tolerance``.  Returns (max abs error, max
    relative error over the devices at least 1e-6 of their cell's
    largest sigma, largest sigma, largest error over the tolerance)."""
    errs = []
    for c, (h, lg) in enumerate(cell_heads(torch, cfg, params_c, images)):
        truth = sigma_f64(torch, h, lg, labels[c])
        top = truth.max()
        err = (sigma[c].double() - truth).abs()
        share = float((err / sigma_tolerance(torch, h, truth)).max())
        require(share <= 1.0,
                f"{tag}: cell {c} sigma max abs err {float(err.max()):.3g}, "
                f"{share:.3g} of the tolerance against Eq. 10 in f64")
        big = truth >= 1e-6 * top
        errs.append((float(err.max()), float((err / truth)[big].max()),
                     float(top), share))
    return tuple(max(e[i] for e in errs) for i in range(4))


def log_sigma_errors(tag, errs):
    """Log the worst of ``sigma_errors``'s readings over a phase."""
    abs_err, rel_err, top, share = (max(e[i] for e in errs)
                                    for i in range(4))
    log(f"{tag} sigmas (persample_gradnorm kernel) vs Eq. 10 in f64: max "
        f"abs err {abs_err:.3g}, max rel err {rel_err:.3g} (devices at "
        f"least 1e-6 of their cell's largest sigma), largest sigma "
        f"{top:.4g}, at most {share:.3g} of the tolerance")


def vision_world(cfg):
    """A vision model's world: the model at full width, synthetic 32x32x3
    images of its classes (500 a class, as CIFAR's training sets), sorted
    and split over 64 devices, seed 0: (model, train, test, parts)."""
    import numpy as np
    from repro_torch.data import (sort_and_partition, synthetic_image_dataset,
                                  train_test_split)
    from repro_torch.models.registry import build_model
    ds = synthetic_image_dataset(num_classes=cfg.num_classes,
                                 num_per_class=500, image_size=32, channels=3,
                                 seed=0)
    train, test = train_test_split(ds, seed=0)
    parts = sort_and_partition(train.labels, 64, 1,
                               np.random.default_rng(0))
    return build_model(cfg), train, test, parts


def fl_world():
    """The main path's world: the full-width paper CNN on 10 classes."""
    from repro_torch.configs.paper_cnn import PAPER_CNN_CIFAR10
    return vision_world(PAPER_CNN_CIFAR10)


def resnet_world():
    """The ResNet phase's world: ResNet18-GN on 100 classes (CIFAR-100's
    shape), 64-512 channels, 11.22 M parameters."""
    from repro_torch.configs.paper_cnn import RESNET18_GN_CIFAR100
    return vision_world(RESNET18_GN_CIFAR100)


def fl_config(sched_name, ring_size=16):
    """The main path's ``FLConfig`` for one scheduler."""
    from repro_torch.fl import FLConfig
    from repro_torch.obs import ObsConfig
    return FLConfig(num_devices=64, available_prob=0.3, batch_size=32,
                    tau=1, scheduler=sched_name, scheduler_backend="torch",
                    seed=0, eval_every=3,
                    obs=ObsConfig(enabled=True, ring_size=ring_size))


def phase_main_path(torch, dev, prof_ok, world):
    """The single-cell main path on ``world`` (its logs tagged with the
    model's name): every round held to ``check_round`` with one
    ``solve_many`` and one K3 launch; returns the FL kernels' launches
    and last shapes, and the warm rounds' ms by scheduler."""
    from repro_torch.core import scheduling as S
    from repro_torch.fl import FederatedTrainer
    from repro_torch.kernels import common

    class CheckedTrainer(FederatedTrainer):
        """Keeps every (Problem, Schedule) the round solved, and the
        inputs and result of every Eq. 10 sigma call."""

        def _schedule(self, prob, *a):
            sched = super()._schedule(prob, *a)
            self.solved.append((prob, sched))
            return sched

        def _sigma_all(self, params_c, images, labels):
            sigma = super()._sigma_all(params_c, images, labels)
            self.sigmas.append((params_c, images, labels, sigma))
            return sigma

    def new_trainer(sched_name):
        tr = CheckedTrainer(*world, fl_config(sched_name))
        tr.solved, tr.sigmas = [], []
        return tr

    model = world[0].name
    trainers, warm = {}, {}
    sigma_err = []
    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    for sched_name, solve in (("fedcgd-fscd", S.fscd),
                              ("fedcgd-gs", S.greedy_scheduling)):
        tr = new_trainer(sched_name)
        tag = f"{model} {sched_name}"
        for j in range(3):
            k3 = common.LAUNCHES["persample_gradnorm"]
            rec = tr.run_round(j)
            k3 = common.LAUNCHES["persample_gradnorm"] - k3
            calls = tr.obs.metrics.counters["sched.solve_many_calls.torch"]
            require(k3 == 1 and len(tr.solved) == j + 1
                    and calls.value == j + 1,
                    f"{tag} round {j}: K3 launched {k3} times, "
                    f"{calls.value} solves")
            sigma_err.append(check_round(
                torch, tr, solve, f"{tag} round {j}", rec))
        require(all(bool(torch.isfinite(p).all())
                    for p in tr.params.values()),
                f"{tag}: params not finite")
        recs = tr.obs.records()
        c = tr.obs.metrics.counters
        syncs = c["sched.host_syncs.torch"].value
        calls = c["sched.solve_many_calls.torch"].value
        for r in recs:
            ph = " ".join(f"{k}={v * 1e3:.2f}ms"
                          for k, v in r["phases"].items())
            log(f"{tag} round {r['round']}: round={r['round_s'] * 1e3:.2f}"
                f"ms {ph} | avail={r['num_available']} "
                f"sched={r['num_scheduled']} loss={r['mean_local_loss']:.4f}"
                f" sched_iters={r['sched_iterations']} host_syncs="
                f"{r['host_syncs']}")
        log(f"{tag}: {syncs / calls:.1f} scheduler host syncs per "
            f"solve ({int(calls)} solves)")
        trainers[sched_name] = (tr, solve)
        warm[sched_name] = [r["round_s"] * 1e3 for r in recs[1:]]
    launches = dict(common.LAUNCHES)
    shapes = dict(common.LAST_SHAPES)
    log(f"{model} main path launches: {launches}, last shapes {shapes}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name in FL_KERNELS:
        require(launches.get(name, 0) > 0,
                f"kernel {name} was not launched on the {model} main path")
    tr, _ = trainers["fedcgd-fscd"]
    twin = new_trainer("fedcgd-fscd")
    for j in range(3):
        twin.run_round(j)
    check_same_run(torch, tr, twin, f"{model} fedcgd-fscd")
    if prof_ok:
        for sched_name, (tr, solve) in trainers.items():
            sigma_err.append(profile_round(torch, f"{model} {sched_name}",
                                           tr, solve))
    log_sigma_errors(f"{model} main path", sigma_err)
    return launches, shapes, warm


def check_same_run(torch, a, b, tag):
    """Two trainers on one seed after the same rounds: bitwise-equal
    history (the round records), masks, iteration counts, Eq. 10 sigmas
    and params."""
    import numpy as np
    require(a.history == b.history,
            f"{tag}: two trainers on one seed differ in their history")
    require(len(a.solved) == len(b.solved) and all(
        np.array_equal(sa.mask, sb.mask) and sa.iterations == sb.iterations
        for (_, sa), (_, sb) in zip(a.solved, b.solved)),
        f"{tag}: two trainers on one seed differ in masks or iterations "
        f"{[s.iterations for _, s in a.solved]} / "
        f"{[s.iterations for _, s in b.solved]}")
    require(all(torch.equal(x[3], y[3]) for x, y in zip(a.sigmas, b.sigmas)),
            f"{tag}: two trainers on one seed differ in their sigmas")
    differ = [k for k in a.params if not torch.equal(a.params[k],
                                                     b.params[k])]
    require(not differ, f"{tag}: two trainers on one seed differ in params "
            f"{differ}")
    log(f"{tag}: a second trainer on the same seed gave a bitwise-equal "
        f"history, masks, iterations "
        f"{[s.iterations for _, s in b.solved]}, sigmas and params after "
        f"{len(b.history)} rounds (cudnn deterministic "
        f"{torch.backends.cudnn.deterministic}, benchmark "
        f"{torch.backends.cudnn.benchmark})")


def profile_round(torch, sched_name, tr, solve) -> tuple:
    """Two more rounds, the second (index 4: no evaluation in it) under
    ``repro_torch.obs.profile_rounds`` (round 3 its warm-up), held to
    ``check_round``'s checks: the device's busy share of the round's wall
    time, the kernels that took longest, the split by the round's ``obs``
    phases (``log_profile``) and the port's kernel launches in the two
    rounds.  Returns the profiled round's sigma errors."""
    import collections

    from repro_torch.kernels import common
    from repro_torch.obs import profile_rounds
    before = collections.Counter(common.LAUNCHES)
    tag = f"{sched_name} profiled round"
    prof = profile_rounds(tr, 1, TRACE_DIR /
                          tag.replace(" ", "_"), warmup=1)
    log_profile(tag, prof, top=6)
    log(f"{tag}: kernel launches in it and its warm-up "
        f"{dict(common.LAUNCHES - before)}")
    return check_round(torch, tr, solve, tag, tr.history[-1])


def profiled(torch, tag, fn, top=6):
    """Run ``fn`` once under ``torch.profiler`` and log the device's busy
    share of its wall time (summed kernel and copy time over the host
    clock, the profiler's own cost included, so a lower bound), the
    kernels that took longest and the port's kernels' totals.  Returns
    what ``fn`` returns."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    evs = sorted((e for e in prof.key_averages()
                  if e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in evs) / 1e6
    log(f"{tag}: wall {wall * 1e3:.2f} ms, device busy {busy * 1e3:.3f} ms"
        f" ({100 * busy / wall:.1f}%), {sum(e.count for e in evs)} device "
        f"ops; longest: " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms "
            f"x{e.count}" for e in evs[:top]))
    port = [e for e in evs if any(k in e.key for k in PORT_KERNEL_SYMBOLS)]
    log(f"{tag}: the port's kernels: " + ("; ".join(
        f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms x{e.count} "
        f"({e.self_device_time_total / 1e3 / e.count:.4f} ms a launch)"
        for e in port) or "none"))
    return out


MC_CELLS = 8                    # cells of the multi-cell phase, seeds 0-7


def mc_config(sched_name, cells=MC_CELLS):
    """The multi-cell phase's ``FLConfig``: the main path's with
    ``cells`` cells (a ring that holds a round's 1 + C records many
    times over)."""
    import dataclasses
    return dataclasses.replace(fl_config(sched_name, ring_size=256),
                               num_cells=cells)


def checked_engine(world, cfg):
    """A ``MultiCellTrainer`` that keeps every batched solve (the cells'
    unpadded Problems and the padded Schedules) and the inputs and
    result of every round core's Eq. 10 sigmas."""
    from repro_torch.fl import MultiCellTrainer

    class CheckedEngine(MultiCellTrainer):
        def _solve_batch(self, probs):
            scheds = super()._solve_batch(probs)
            self.solved.append((list(probs), scheds))
            return scheds

    mc = CheckedEngine(*world, cfg)
    mc.solved, mc.sigmas = [], []
    core = mc._core

    def recording(params_c, batches_c, dropout_c):
        out = core(params_c, batches_c, dropout_c)
        mc.sigmas.append((params_c, batches_c["images"][:, :, 0],
                          batches_c["labels"][:, :, 0], out[2]))
        return out

    mc._core = recording
    return mc


def check_mc_round(torch, mc, solve, tag, recs) -> tuple:
    """Hold one C-cell round to the numpy solver's mask and iteration
    count on every cell's unpadded Problem (no padded row scheduled),
    finite losses, 2 host syncs for the whole round, and every cell's
    Eq. 10 sigmas to Eq. 10 in f64; returns the sigmas' errors."""
    import numpy as np
    probs, scheds = mc.solved[-1]
    for c, (prob, sched) in enumerate(zip(probs, scheds)):
        n = prob.num_devices
        want = solve(prob)
        require(np.array_equal(want.mask, sched.mask[:n])
                and want.iterations == sched.iterations
                and not sched.mask[n:].any(),
                f"{tag}: cell {c}'s mask or iterations differ from numpy, "
                f"or a padded row was scheduled")
    require(all(np.isfinite(r["mean_local_loss"]) for r in recs),
            f"{tag}: loss not finite")
    require(mc.last_round_host_syncs == 2,
            f"{tag}: {mc.last_round_host_syncs} host syncs")
    return sigma_errors(torch, mc.cells[0].model.cfg, *mc.sigmas[-1], tag)


def sigma_conditioning(torch, cfg, params_c, images, labels, sigma, tag):
    """Log, cell by cell, how far each way of computing the round's
    Eq. 10 sigmas lies from Eq. 10 in f64 (from the materialised
    per-sample gradients): the kernel's two-pass sum, the closed form
    ``E.sigma_hat_lastlayer`` and the TPU kernel's one-pass f32 sum
    ``mean gi_sq - ||gbar||^2``; beside them the largest |feature| and
    the largest mean ||g_i||^2 / sigma^2 (over the devices whose sigma is
    at least 1e-6 of the cell's largest), which sets how much a one-pass
    sum cancels; and for each way its largest error over the tolerance
    ``sigma_errors`` holds the kernel to (over 1 fails)."""
    from repro_torch.core import estimation as E
    for c, (h, lg) in enumerate(cell_heads(torch, cfg, params_c, images)):
        V, b = h.shape[:2]
        truth = sigma_f64(torch, h, lg, labels[c]).clamp(min=1e-30)
        gi_sq = (h.double() ** 2).sum(-1) * ((torch.softmax(
            lg.double(), -1) - torch.nn.functional.one_hot(
                labels[c], lg.shape[-1]).double()) ** 2).sum(-1)
        ratio = gi_sq.mean(-1) / truth ** 2
        e32 = torch.softmax(lg, -1) - torch.nn.functional.one_hot(
            labels[c], lg.shape[-1]).float()
        gbar = h.transpose(-1, -2) @ e32 / b
        one_pass = torch.sqrt(torch.clamp(
            ((h * h).sum(-1) * (e32 * e32).sum(-1)).mean(-1)
            - (gbar * gbar).sum((-2, -1)), min=0.0))
        ways = {"kernel": sigma[c],
                "closed form": E.sigma_hat_lastlayer(h, lg, labels[c]),
                "one-pass f32": one_pass}
        # devices whose sigma lies under 1e-6 of the cell's largest are
        # left out: their softmax errors underflow in f32 (logits 1e6
        # apart), which is not the cancellation measured here
        big = truth >= 1e-6 * truth.max()
        tol = sigma_tolerance(torch, h, truth)
        errs = ", ".join(
            f"{k} {float(((v.double() - truth).abs() / truth)[big].max()):.3g}"
            f" ({float(((v.double() - truth).abs() / tol).max()):.3g} of "
            f"the tolerance)" for k, v in ways.items())
        log(f"{tag} cell {c}: max |h| {float(h.abs().max()):.4g}, max mean "
            f"||g_i||^2 / sigma^2 {float(ratio[big].max()):.4g}, largest "
            f"sigma {float(truth.max()):.6g}; max relative error against "
            f"f64 ({int(big.sum())} of {V} devices): {errs}")


def engine_records(mc):
    return [r for r in mc.obs.records() if r["kind"] == "multicell_round"]


def phase_multicell(torch, dev, prof_ok, world, single_ms):
    """The main path batched over 8 cells (``MultiCellTrainer``, seeds
    0-7, the main path's world and config): 3 rounds of each scheduler
    held to ``check_mc_round`` with one ``solve_many`` and one K3 launch
    (every device of every cell) a round; a second FSCD engine on the
    same seeds bitwise equal; a one-cell engine bitwise equal to
    ``FederatedTrainer``; one profiled 8-cell round of each scheduler.
    Returns the FL kernels' launches and last shapes over the 3 + 3
    rounds."""
    import collections

    from repro_torch.core import scheduling as S
    from repro_torch.kernels import common
    C = MC_CELLS
    engines, sigma_err = {}, []
    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    for sched_name, solve in (("fedcgd-fscd", S.fscd),
                              ("fedcgd-gs", S.greedy_scheduling)):
        mc, warm = run_engine(torch, world, sched_name, solve, C, 3,
                              sigma_err)
        one = single_ms[sched_name]
        log(f"{sched_name}: warm {C}-cell rounds {[f'{t:.2f}' for t in warm]}"
            f" ms against {C} x the single-cell warm rounds "
            f"{[f'{C * t:.2f}' for t in one]} ms (ratio "
            f"{min(warm) / (C * min(one)):.3f} at the fastest of each)")
        engines[sched_name] = (mc, solve)
    launches = dict(common.LAUNCHES)
    shapes = dict(common.LAST_SHAPES)
    log(f"{C}-cell launches over 3 + 3 rounds: "
        f"{launches}, last shapes {shapes}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name in FL_KERNELS:
        require(launches.get(name, 0) > 0,
                f"kernel {name} was not launched by the {C}-cell rounds")
    mc, _ = engines["fedcgd-fscd"]
    twin = checked_engine(world, mc_config("fedcgd-fscd"))
    for j in range(3):
        twin.run_round(j)
    check_same_engine(torch, mc, twin, f"fedcgd-fscd {C} cells")
    check_one_cell(torch, world)
    if prof_ok:
        for sched_name, (mc, solve) in engines.items():
            before = collections.Counter(common.LAUNCHES)
            recs = profiled(torch, f"{sched_name} {C} cells profiled round",
                            lambda: mc.run_round(4))
            log(f"{sched_name} {C} cells profiled round: kernel launches "
                f"{dict(common.LAUNCHES - before)}")
            sigma_err.append(check_mc_round(
                torch, mc, solve, f"{sched_name} {C} cells profiled round",
                recs))
    mc, _ = engines["fedcgd-gs"]
    last = mc.history[-1][0]["round"]
    sigma_conditioning(torch, mc.cells[0].model.cfg, *mc.sigmas[-1],
                       f"fedcgd-gs {C} cells round {last} sigmas")
    log_sigma_errors(f"{C}-cell", sigma_err)
    return launches, shapes


def run_engine(torch, world, sched_name, solve, cells, rounds, sigma_err):
    """``rounds`` rounds of a ``cells``-cell engine on ``world``, each
    held to ``check_mc_round`` with one ``solve_many`` and one K3 launch
    (its sigma errors appended to ``sigma_err``), its rounds and phase
    spans logged; returns the engine and its warm rounds' ms."""
    from repro_torch.kernels import common
    mc = checked_engine(world, mc_config(sched_name, cells))
    tag = f"{world[0].name} {sched_name} {cells} cells"
    for j in range(rounds):
        k3 = common.LAUNCHES["persample_gradnorm"]
        calls = mc.solve_many_calls
        recs = mc.run_round(j)
        k3 = common.LAUNCHES["persample_gradnorm"] - k3
        require(mc.solve_many_calls == calls + 1,
                f"{tag} round {j}: {mc.solve_many_calls - calls} "
                f"solve_many calls")
        require(k3 == 1, f"{tag} round {j}: K3 launched {k3} times")
        sigma_err.append(check_mc_round(torch, mc, solve,
                                        f"{tag} round {j}", recs))
        probs, scheds = mc.solved[-1]
        log(f"{tag} round {j}: avail {[p.num_devices for p in probs]} sched "
            f"{[r['num_scheduled'] for r in recs]} iterations "
            f"{[s.iterations for s in scheds]} loss "
            f"{[round(r['mean_local_loss'], 4) for r in recs]}")
    require(all(bool(torch.isfinite(p).all())
                for p in mc._params_c.values()),
            f"{tag}: params not finite")
    for r in engine_records(mc):
        ph = " ".join(f"{k}={v * 1e3:.2f}ms"
                      for k, v in r["phases"].items())
        log(f"{tag} round {r['round']}: "
            f"round={r['round_s'] * 1e3:.2f}ms {ph} | host_syncs="
            f"{r['host_syncs']} solve_many_calls={r['solve_many_calls']}"
            f" uploaded={r['num_uploaded']}")
    return mc, [r["round_s"] * 1e3 for r in engine_records(mc)[1:]]


RESNET_CELLS = 8                # cells of the ResNet phase's engine


def phase_resnet(torch, dev, prof_ok):
    """ResNet18-GN on CIFAR-100's shape at full width: the main path's
    checks on its world (``phase_main_path``: 3 rounds each of FSCD and
    GS, a second FSCD trainer bitwise equal, profiled rounds), then 2
    FSCD rounds of a ``RESNET_CELLS``-cell engine held to
    ``check_mc_round``, the last round's sigmas logged by
    ``sigma_conditioning``.  Returns the single-cell and the engine's FL
    kernel launches and last shapes."""
    from repro_torch.core import scheduling as S
    from repro_torch.kernels import common
    t0 = time.perf_counter()
    world = resnet_world()
    n_params = sum(x.numel() for x in
                   world[0].init(torch.Generator().manual_seed(0)).values())
    log(f"resnet data: {len(world[1])} train / {len(world[2])} test images "
        f"32x32x3 of {world[0].cfg.num_classes} classes, 64 devices; "
        f"{n_params / 1e6:.2f} M parameters "
        f"({time.perf_counter() - t0:.2f} s)")
    launches, shapes, _ = phase_main_path(torch, dev, prof_ok, world)
    sigma_err = []
    torch.cuda.reset_peak_memory_stats()
    common.reset_launches()
    mc, _ = run_engine(torch, world, "fedcgd-fscd", S.fscd, RESNET_CELLS, 2,
                       sigma_err)
    mc_launches, mc_shapes = dict(common.LAUNCHES), dict(common.LAST_SHAPES)
    sigma_conditioning(torch, world[0].cfg, *mc.sigmas[-1],
                       f"{world[0].name} {RESNET_CELLS} cells round 1 sigmas")
    log(f"{world[0].name} {RESNET_CELLS}-cell launches over 2 rounds: "
        f"{mc_launches}, last shapes {mc_shapes}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name in ("wemd_swap", "persample_gradnorm"):
        require(mc_launches.get(name, 0) > 0,
                f"kernel {name} was not launched by the {RESNET_CELLS}-cell "
                f"ResNet rounds")
    log_sigma_errors(f"{world[0].name} {RESNET_CELLS}-cell", sigma_err)
    return launches, shapes, mc_launches, mc_shapes


def check_same_engine(torch, a, b, tag):
    """Two engines on the same seeds after the same rounds: bitwise-equal
    history, masks, iteration counts, Eq. 10 sigmas and params."""
    import numpy as np
    require(a.history == b.history,
            f"{tag}: two engines on one seed differ in their history")
    require(len(a.solved) == len(b.solved) and all(
        np.array_equal(sa.mask, sb.mask) and sa.iterations == sb.iterations
        for (_, xa), (_, xb) in zip(a.solved, b.solved)
        for sa, sb in zip(xa, xb)),
        f"{tag}: two engines on one seed differ in masks or iterations")
    require(all(torch.equal(x[3], y[3]) for x, y in zip(a.sigmas, b.sigmas)),
            f"{tag}: two engines on one seed differ in their sigmas")
    differ = [k for k in a._params_c
              if not torch.equal(a._params_c[k], b._params_c[k])]
    require(not differ, f"{tag}: two engines on one seed differ in params "
            f"{differ}")
    log(f"{tag}: a second engine on the same seeds gave a bitwise-equal "
        f"history, masks, iterations, sigmas and params after "
        f"{len(b.history)} rounds")


def check_one_cell(torch, world):
    """A one-cell engine and ``FederatedTrainer`` on one seed: bitwise
    equal records and params after 3 FSCD rounds."""
    from repro_torch.fl import FederatedTrainer, MultiCellTrainer
    ref = FederatedTrainer(*world, fl_config("fedcgd-fscd"))
    one = MultiCellTrainer(*world, mc_config("fedcgd-fscd", cells=1))
    for j in range(3):
        a = ref.run_round(j)
        b, = one.run_round(j)
        require(a == b, f"one cell round {j}: the record differs from "
                f"FederatedTrainer's")
    differ = [k for k in ref.params
              if not torch.equal(ref.params[k], one.cells[0].params[k])]
    require(not differ, f"one cell: params differ from FederatedTrainer's "
            f"{differ}")
    log("fedcgd-fscd: a one-cell engine equals FederatedTrainer bitwise "
        "(records and params after 3 rounds)")


def lm_consistency(torch, model, params, prompts, P, C):
    """The prefill step of P tokens (the head on the last position only)
    plus C teacher-forced decode steps (the plain decode route) against
    one forward of P+C tokens (the kernel route) at those positions; and
    the prefill step's logits against the full forward's last position
    over the P tokens, within ``HEAD_TOL`` x max(1, max |logit|) (the
    same trunk, so only the head's GEMM differs: cuBLAS may pick another
    algorithm at M = B).  Returns (max abs error over max(1, max
    |logit|), relative L2 error, warm prefill ms, max(1, max |logit|),
    the last position's error over its scale)."""
    from repro_torch.fl.distributed import make_prefill_step, make_serve_step
    prefill = make_prefill_step(model.cfg, cache_len=P + C + 8)
    serve = make_serve_step(model.cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    last, cache = prefill(params, {"tokens": prompts[:, :P]})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    require(bool(torch.isfinite(last).all()), "prefill logits not finite")
    with torch.no_grad():
        full = model.forward(params, {"tokens": prompts[:, :P]})[0][:, -1]
    head_scale = max(1.0, float(full.abs().max()))
    head_err = float((last[:, 0] - full).abs().max()) / head_scale
    require(head_err <= HEAD_TOL, f"{model.cfg.name}: the prefill step's "
            f"last-position logits are {head_err:.3g} x scale off the full "
            f"forward's")
    del full
    dec = []
    for i in range(C):
        step, cache = serve(params, cache,
                            {"tokens": prompts[:, P + i:P + i + 1]})
        dec.append(step[:, 0])
    dec = torch.stack(dec, dim=1)
    with torch.no_grad():
        full, _, _ = model.forward(params, {"tokens": prompts[:, :P + C]})
    require(bool(torch.isfinite(full).all()), "prefill logits not finite")
    want = full[:, P:P + C].clone()
    del full, cache
    scale = max(1.0, float(want.abs().max()))
    err = float((dec - want).abs().max()) / scale
    rel = float((dec - want).norm() / want.norm())
    return err, rel, prefill_ms, scale, head_err


def phase_lm(torch, dev, prof_ok):
    """Serve recurrentgemma-2b, then rwkv6-3b, through ``generate`` at
    full width and depth (bf16), each held to the launch counts and the
    prefill/decode consistency bounds; first the same consistency check
    on each reduced config in f32.  Returns the serving runs' launches and
    kernel shapes."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import common
    from repro_torch.models.registry import build_model
    from repro_torch.serve import generate
    launches, shapes = {}, {}
    for arch, want_launches in LM_PREFILL_LAUNCHES.items():
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        gen = torch.Generator(device=dev).manual_seed(1)
        params = model.init(gen)
        prompts = torch.randint(0, cfg.vocab_size, (2, 108), generator=gen,
                                device=dev)
        err, rel, _, _, head_err = lm_consistency(torch, model, params,
                                                  prompts, 100, 8)
        log(f"{cfg.name} f32 prefill(100)+8 steps vs prefill(108): max err"
            f" {err:.3g} x scale, rel L2 {rel:.3g}; prefill step's last "
            f"position vs the full forward's {head_err:.3g} x scale")
        require(err <= F32_CONSISTENCY,
                f"{cfg.name}: decode disagrees with prefill")

        cfg = get_config(arch)
        model = build_model(cfg)
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = model.init(gen)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n_params = sum(x.numel() for x in _leaves(params))
        prompts = torch.randint(0, cfg.vocab_size,
                                (LM_BATCH, LM_PROMPT + LM_CHECK),
                                generator=gen, device=dev)
        common.reset_launches()
        toks, st = generate(model, params, prompts[:, :LM_PROMPT], LM_GEN,
                            temperature=0.8, generator=gen)
        got = dict(common.LAUNCHES)
        log(f"{arch}: {n_params / 1e9:.3f} B params ({cfg.param_dtype}, "
            f"{cfg.num_layers} layers, d_model {cfg.d_model}) drawn on the "
            f"card in {t_init:.2f} s; first prefill {LM_BATCH}x{LM_PROMPT} "
            f"{st['prefill_ms']:.2f} ms, decode {LM_GEN} tokens "
            f"{st['decode_tokens_per_s']:.2f} tok/s ({st['decode_s']:.3f} s);"
            f" launches prefill {st['launches_prefill']} decode "
            f"{st['launches_decode']}; seq 0: {toks[0].tolist()}")
        require(got == want_launches and st["launches_prefill"] == got
                and st["launches_decode"] == {},
                f"{arch}: launches {got}, decode {st['launches_decode']}, "
                f"want {want_launches} in prefill and none in decode")
        require(tuple(toks.shape) == (LM_BATCH, LM_GEN)
                and 0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size,
                f"{arch}: sampled tokens out of range")
        launches.update(got)
        shapes.update(common.LAST_SHAPES)
        bounds = BF16_CONSISTENCY[arch]
        err, rel, warm_ms, scale, head_err = lm_consistency(
            torch, model, params, prompts, LM_PROMPT, LM_CHECK)
        log(f"{arch}: warm prefill step {LM_BATCH}x{LM_PROMPT} "
            f"{warm_ms:.2f} ms (the head on the last position; its logits "
            f"{head_err:.3g} x scale off the full forward's, bound "
            f"{HEAD_TOL}); "
            f"bf16 prefill({LM_PROMPT})+{LM_CHECK} steps vs prefill("
            f"{LM_PROMPT + LM_CHECK}): max err {err:.4g} x scale, rel L2 "
            f"{rel:.4g} (bounds {bounds}, max |logit| {scale:.4g});"
            f" peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        require(err <= bounds[0] and rel <= bounds[1],
                f"{arch}: decode disagrees with prefill")
        gaps = []
        for depth in LM_DEPTHS[arch]:
            sub, sub_params = first_layers(cfg, params, depth)
            e, r, _, sc, _ = lm_consistency(torch, build_model(sub),
                                            sub_params, prompts, LM_PROMPT,
                                            LM_CHECK)
            gaps.append(f"{depth} layers {e:.4g} / {r:.4g} (max |logit| "
                        f"{sc:.4g})")
            require(e <= bounds[0] and r <= bounds[1],
                    f"{arch}: decode disagrees with prefill over the first "
                    f"{depth} layers")
        log(f"{arch}: bf16 prefill/decode gap (max err x scale / rel L2) "
            f"over the first layers: " + "; ".join(gaps)
            + f"; {cfg.num_layers} layers {err:.4g} / {rel:.4g}")
        if prof_ok:
            profile_serving(torch, model, params, prompts[:, :LM_PROMPT], arch)
        del params, model, prompts
        torch.cuda.empty_cache()
    return launches, shapes


def profile_serving(torch, model, params, prompt, arch):
    """One warm prefill step and one warm decode step under the
    profiler."""
    from repro_torch.fl.distributed import make_prefill_step, make_serve_step
    prefill_step = make_prefill_step(model.cfg, prompt.shape[1] + 8)
    serve = make_serve_step(model.cfg)

    def prefill():
        logits, cache = prefill_step(params, {"tokens": prompt})
        return logits[:, -1].argmax(-1)[:, None], cache

    tok, cache = profiled(torch, f"{arch} profiled prefill", prefill, top=8)
    serve(params, cache, {"tokens": tok})     # warm-up
    profiled(torch, f"{arch} profiled decode step",
             lambda: serve(params, cache, {"tokens": tok}))


# LM zoo serving phase: the primary models at published width and full
# depth, then the secondary ones in order, each in bf16 with seeded random
# weights whose zero-initialised leaves are made nonzero (``zoo_leaves``).
# Secondary: (arch, batch, depth or None for full, decodes).  yi-34b's 68.8
# GB of weights leave room for one sequence; qwen3-moe-235b-a22b (4.98 GB
# a layer) and arctic-480b (27.3 GB a layer) are cut to the layers that fit
# in about 60 GB (the init draws each period into its slice of the stack,
# so it holds no second period while it draws); musicgen-large's
# reference refuses audio decode, so it runs the prefill step alone, over
# frame embeddings.
ZOO_PRIMARY = ("qwen2-7b", "gemma3-27b", "moonshot-v1-16b-a3b",
               "llama-3.2-vision-11b")
ZOO_SECONDARY = (("yi-34b", 1, None, True),
                 ("musicgen-large", LM_BATCH, None, False),
                 ("qwen3-moe-235b-a22b", LM_BATCH, 11, True),
                 ("arctic-480b", LM_BATCH, 2, True))
# attention launches of one prefill: one an attention layer, cross layers
# included (at the cut depths of the secondary MoE models)
ZOO_PREFILL_LAUNCHES = {"qwen2-7b": 28, "gemma3-27b": 62,
                        "moonshot-v1-16b-a3b": 48,
                        "llama-3.2-vision-11b": 40, "yi-34b": 60,
                        "musicgen-large": 48, "qwen3-moe-235b-a22b": 11,
                        "arctic-480b": 2}
# prefill(P) + 8 decode steps vs one forward of P+8 at bf16 (max abs error
# over max(1, max |logit|), relative L2), as BF16_CONSISTENCY: about 1.5x
# the first readings (on one H100 80GB HBM3 at 700 W, the same digits in
# every run; arctic-480b's at 2 layers):
#   qwen2-7b 0.02241 / 0.02076, gemma3-27b 0.007603 / 0.0307,
#   llama-3.2-vision-11b 0.02541 / 0.02596, yi-34b 0.02938 / 0.02719,
#   moonshot-v1-16b-a3b 0.193 / 0.1447, qwen3-moe-235b-a22b 0.06168 /
#   0.03925, arctic-480b 0.004115 / 0.004118.
# The MoE models' gaps carry routing flips: bf16 noise between the decode
# route and the forward moves a token's k-th and (k+1)-th experts past
# each other (moonshot: 5 to 25 of its 48 layers a step, every step;
# qwen3-moe: 0 to 5 of 11), and a flipped expert changes the token's
# output outright.
ZOO_BF16_CONSISTENCY = {"qwen2-7b": (0.034, 0.031),
                        "gemma3-27b": (0.0115, 0.046),
                        "moonshot-v1-16b-a3b": (0.29, 0.22),
                        "llama-3.2-vision-11b": (0.038, 0.039),
                        "yi-34b": (0.044, 0.041),
                        "qwen3-moe-235b-a22b": (0.093, 0.059),
                        "arctic-480b": (0.0062, 0.0062)}
# an MoE model's prefill + decode steps routed as the forward of P+8
# (``RoutingReplay``): the bf16 gap without its routing flips, at the dense
# models' level.  About 1.5x the first readings (the same card): moonshot
# 0.03426 / 0.03277, qwen3-moe 0.008975 / 0.01013, arctic (no flips)
# 0.004115 / 0.004118
ZOO_REPLAYED_CONSISTENCY = {"moonshot-v1-16b-a3b": (0.052, 0.05),
                            "qwen3-moe-235b-a22b": (0.0135, 0.0152),
                            "arctic-480b": (0.0062, 0.0062)}
# the full forward's head over its last ZOO_HEAD_ROWS positions (a GEMM of
# B x 512 rows against the prefill step's B): the whole [B, S, V] f32
# logits of gemma3-27b would be 12.9 GB beside its 54 GB of weights
ZOO_HEAD_ROWS = 512
# an MoE model's consistency check runs drop-free: capacity factor
# min(E / k, 16) (E / k makes every expert's capacity the token count, as
# the reference's tests/test_moe.py; arctic-480b's 64 would need 23 GB of
# dispatch buffers), on the first sequence, and must drop nothing
ZOO_MOE_CHECK_FACTOR = 16.0
# the largest gap between the forward's k-th and (k+1)-th expert
# probability at a layer where a decode step fed the forward's routing
# (``RoutingReplay``) would itself have chosen other experts: such a flip
# is bf16 noise only where the forward nearly ties.  About 1.5x the first
# readings (the same card): moonshot 0.00156 (4 to 8 of 48 layers a
# step), qwen3-moe 0.000484 (0 or 1 of 11); arctic chose as the forward
# throughout and takes moonshot's.  The free run's flips, routing
# upstream included, reached 0.00839 and 0.00185
ZOO_FLIP_GAP = {"moonshot-v1-16b-a3b": 0.0023, "qwen3-moe-235b-a22b": 0.00073,
                "arctic-480b": 0.0023}
# models whose warm prefill and decode steps are profiled
ZOO_PROFILED = ("qwen2-7b", "gemma3-27b", "moonshot-v1-16b-a3b")


def zoo_check_config(cfg):
    """The config of ``zoo_checks``' prefill/decode check: an MoE model's
    at capacity factor min(E / k, ``ZOO_MOE_CHECK_FACTOR``)."""
    import dataclasses
    if not cfg.num_experts:
        return cfg
    return dataclasses.replace(cfg, capacity_factor=min(
        cfg.num_experts / cfg.experts_per_token, ZOO_MOE_CHECK_FACTOR))


def zoo_leaves(torch, params, gen):
    """Make the init's zero leaves nonzero, in place: each cross layer's
    gate 1.0 (tanh(0) would close it), the QKV biases and every RMS-norm
    scale N(0, 0.02)."""
    for k, v in params.items():
        if isinstance(v, dict):
            zoo_leaves(torch, v, gen)
        elif k == "gate":
            v.fill_(1.0)
        elif k in ("bq", "bk", "bv", "scale"):
            v.copy_(torch.randn(v.shape, generator=gen, device=v.device)
                    * 0.02)


class DropCount:
    """While entered, counts the MoE assignments dropped at an expert's
    capacity and all assignments of ``cfg``'s layers: each call of
    ``moe.top_k_routing`` (wrapped) routes T tokens, and the assignments
    whose arrival rank within their expert (``moe._positions_in_expert``)
    reaches ``moe._capacity`` are the dropped ones (0-d tensors summed on
    the card, read once at the end)."""

    def __init__(self, torch, cfg):
        self.torch, self.cfg = torch, cfg

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe.top_k_routing
        self.dropped, self.total = [], 0
        E, factor = self.cfg.num_experts, self.cfg.capacity_factor

        def counted(logits, k):
            out = self.orig(logits, k)
            experts = out[1]
            cap = moe._capacity(experts.shape[0], k, E, factor)
            pos, _ = moe._positions_in_expert(experts.reshape(-1), E)
            self.dropped.append((pos >= cap).sum())
            self.total += experts.numel()
            return out
        moe.top_k_routing = counted
        return self

    def __exit__(self, *exc):
        self.moe.top_k_routing = self.orig

    def read(self):
        return (int(self.torch.stack(self.dropped).sum())
                if self.dropped else 0), self.total


class RoutingLog:
    """While entered, records the experts [T, k] that every MoE layer
    routes its tokens to and their probabilities [T, E], call by call
    (``moe.top_k_routing`` wrapped)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe.top_k_routing
        self.experts, self.probs = [], []

        def logged(logits, k):
            out = self.orig(logits, k)
            self.experts.append(out[1])
            self.probs.append(out[2])
            return out
        moe.top_k_routing = logged
        return self

    def __exit__(self, *exc):
        self.moe.top_k_routing = self.orig


class RoutingReplay:
    """While entered, every MoE layer routes as the forward of P+C
    positions did (``fwd``: its records, layer by layer, each [rows
    (P+C), k]): the first call of each layer (the prefill) takes the
    forward's experts at positions 0..P-1, its i-th next call (decode step
    i) those at position P+i; the weights are the call's own
    probabilities at those experts, normalised as ``top_k_routing``'s.
    ``own`` records the experts each decode call would have chosen from
    its own logits (C x layers, each [rows, k]): with every layer fed the
    forward's routing, where these differ from the forward's, bf16 noise
    alone moved the layer's k-th and (k+1)-th experts past each other."""

    def __init__(self, torch, fwd, rows, P, C):
        self.torch, self.P = torch, P
        self.fwd = [e.reshape(rows, P + C, -1) for e in fwd]

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe.top_k_routing
        self.own = []
        calls = iter(range(1 << 30))
        torch, P, fwd = self.torch, self.P, self.fwd

        def replayed(logits, k):
            c = next(calls)
            e, i = fwd[c % len(fwd)], c // len(fwd)
            if i:
                self.own.append(self.orig(logits, k)[1])
            experts = e[:, :P].reshape(-1, k) if i == 0 else e[:, P + i - 1]
            probs = torch.softmax(logits.to(torch.float32), dim=-1)
            w = torch.gather(probs, 1, experts)
            return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), \
                experts, probs
        moe.top_k_routing = replayed
        return self

    def __exit__(self, *exc):
        self.moe.top_k_routing = self.orig


def routing_flips(torch, dec, fwd, rows, P, C):
    """For each of C decode steps, the MoE layers whose expert choice (as
    a set, over ``rows`` sequences) differs from the forward's at the
    same position: ``dec`` the decode steps' records (C x layers, each
    [rows, k]), ``fwd`` the forward's (layers, each [rows (P+C), k])."""
    L = len(fwd)
    flips = []
    for i in range(C):
        flips.append([
            l for l in range(L)
            if not torch.equal(
                dec[i * L + l].sort(-1).values,
                fwd[l].reshape(rows, P + C, -1)[:, P + i].sort(-1).values)])
    return flips


def flip_gaps(torch, flips, probs, rows, P, C, k):
    """For each flipped (step i, layer l) of ``flips`` (``routing_flips``),
    the forward's gap between its k-th and (k+1)-th expert probability at
    position P+i (the largest over ``rows`` sequences): ``probs`` the
    forward's records (layers, each [rows (P+C), E])."""
    gaps = []
    for i, layers in enumerate(flips):
        for l in layers:
            p = probs[l].reshape(rows, P + C, -1)[:, P + i].sort(
                -1, descending=True).values
            gaps.append(float((p[:, k - 1] - p[:, k]).max()))
    return gaps


def zoo_batch(torch, cfg, B, S, gen, dev):
    """Prompts [B, S] (the audio family: frame embeddings [B, S,
    encoder_dim]) and the VLM's encoder embeddings, from ``gen``."""
    if cfg.family == "audio":
        batch = {"frame_embeddings": torch.randn(
            (B, S, cfg.encoder_dim), generator=gen, device=dev)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                         generator=gen, device=dev)}
    if cfg.family == "vlm":
        batch["encoder_embeddings"] = torch.randn(
            (B, cfg.num_encoder_tokens, cfg.encoder_dim), generator=gen,
            device=dev)
    return batch


def _upto(batch, P, rows=None):
    """The batch's first ``rows`` sequences and, of the positions, the
    first P (the encoder embeddings whole)."""
    return {k: (v[:rows] if k == "encoder_embeddings" else v[:rows, :P])
            for k, v in batch.items()}


def zoo_checks(torch, model, params, batch, P, C, rows):
    """The prefill step's last-position logits against the full forward's
    head (over its last ``ZOO_HEAD_ROWS`` positions), and with ``C`` > 0
    the prefill step of P positions plus C teacher-forced decode steps
    against the head of one forward of P+C over those positions, on the
    first ``rows`` sequences; an MoE model at capacity factor
    ``ZOO_MOE_CHECK_FACTOR``, where it must drop nothing.  Returns a dict:
    ``head_err`` (over scale), ``warm_ms`` (the prefill step), ``drops``
    (dropped and all assignments of the prefill step at the config's
    capacity factor), and with C: ``err`` (max over scale), ``rel``
    (relative L2), ``scale`` (max(1, max |logit|)), ``step_errs`` (each
    step's max error over scale), ``decode_ms`` (the C warm steps) and,
    for an MoE model, ``flips`` (each step's MoE layers whose experts
    differ from the forward's, ``routing_flips``), ``gaps`` (the
    forward's gap between the k-th and (k+1)-th expert probability at
    each flip, ``flip_gaps``), ``replayed`` (max error over scale and
    relative L2 of the prefill and decode steps routed as the forward,
    ``RoutingReplay``), ``noise_flips`` and ``noise_gaps`` (the same for
    the experts the replayed decode steps would have chosen themselves);
    always ``trunk_same`` (the prefill step's logits bitwise the head on
    the forward's last row alone), ``norm_diff`` (the bf16 elements of the
    final norm's last row that differ between ``ZOO_HEAD_ROWS`` rows and
    1) and ``gemm_err`` (the head's f32 product over ``ZOO_HEAD_ROWS`` rows
    against over 1 on the same normed rows, max over scale)."""
    from repro_torch.fl.distributed import make_prefill_step, make_serve_step
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.sharding import matmul
    cfg = model.cfg
    prefill = make_prefill_step(cfg, cache_len=P + 8)
    with DropCount(torch, cfg) as drops, torch.no_grad():
        last, cache = prefill(params, _upto(batch, P))
    del cache
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        last, cache = prefill(params, _upto(batch, P))
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    del cache
    require(bool(torch.isfinite(last).all()), f"{cfg.name}: prefill logits "
            f"not finite")
    with torch.no_grad():
        x = T.forward_hidden(params, cfg, _upto(batch, P))[0]
        full = T._head(params, cfg, x[:, -ZOO_HEAD_ROWS:])[:, -1]
        one = T._head(params, cfg, x[:, -1:])[:, 0]
        # the head's two steps apart: its final norm's last row over
        # ZOO_HEAD_ROWS rows and over 1 (bf16 outputs), and its f32
        # product (``_head``'s) over ZOO_HEAD_ROWS rows and over 1 on the
        # same normed rows
        norm = L.rms_norm(params["final_norm"], x[:, -ZOO_HEAD_ROWS:])
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        gemm_gap = (matmul(norm, w, out_dtype=torch.float32)[:, -1]
                    - matmul(norm[:, -1:], w, out_dtype=torch.float32)[:, 0])
        norm_diff = int((norm[:, -1:] != L.rms_norm(params["final_norm"],
                                                    x[:, -1:])).sum())
    scale = max(1.0, float(full.abs().max()))
    head_err = float((last[:, 0] - full).abs().max()) / scale
    require(head_err <= HEAD_TOL, f"{cfg.name}: the prefill step's "
            f"last-position logits are {head_err:.3g} x scale off the full "
            f"forward's")
    # the head on the forward's last row alone: the prefill step's logits
    # bit for bit where the two trunks agree bit for bit
    out = {"head_err": head_err, "warm_ms": warm_ms, "drops": drops.read(),
           "trunk_same": bool(torch.equal(one, last[:, 0])),
           "norm_diff": norm_diff,
           "gemm_err": float(gemm_gap.abs().max()) / scale}
    del x, full, last, one, norm, w, gemm_gap
    if not C:
        return out
    cfg = zoo_check_config(cfg)
    prefill = make_prefill_step(cfg, cache_len=P + C + 8)
    serve = make_serve_step(cfg)
    sub = _upto(batch, P + C, rows)

    def prefill_and_decode():
        _, cache = prefill(params, _upto(sub, P))
        dec = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(C):
            step, cache = serve(params, cache,
                                {"tokens": sub["tokens"][:, P + i:P + i + 1]})
            dec.append(step[:, 0])
        torch.cuda.synchronize()
        return torch.stack(dec, dim=1), (time.perf_counter() - t0) * 1e3

    with DropCount(torch, cfg) as check_drops, RoutingLog() as routes, \
            torch.no_grad():
        x = T.forward_hidden(params, cfg, sub)[0]
        want = T._head(params, cfg, x[:, P:P + C])
        del x
        n0 = len(routes.experts)
        dec, out["decode_ms"] = prefill_and_decode()
    require(bool(torch.isfinite(want).all()), f"{cfg.name}: forward logits "
            f"not finite")
    scale = max(1.0, float(want.abs().max()))
    if cfg.num_experts:
        # the records: the forward's (a layer each), the prefill's, then
        # the decode steps'
        fwd = routes.experts[:n0]
        out["flips"] = routing_flips(torch, routes.experts[2 * n0:], fwd,
                                     rows, P, C)
        with RoutingReplay(torch, fwd, rows, P, C) as replay, \
                torch.no_grad():
            replayed = prefill_and_decode()[0]
        out["replayed"] = (float((replayed - want).abs().max()) / scale,
                           float((replayed - want).norm() / want.norm()))
        k = cfg.experts_per_token
        out["noise_flips"] = routing_flips(torch, replay.own, fwd, rows, P, C)
        out["noise_gaps"] = flip_gaps(torch, out["noise_flips"],
                                      routes.probs[:n0], rows, P, C, k)
        out["gaps"] = flip_gaps(torch, out["flips"], routes.probs[:n0], rows,
                                P, C, k)
    dropped, total = check_drops.read()
    require(dropped == 0, f"{cfg.name}: the consistency check dropped "
            f"{dropped} of {total} assignments at capacity factor "
            f"{cfg.capacity_factor}")
    out.update(err=float((dec - want).abs().max()) / scale,
               rel=float((dec - want).norm() / want.norm()), scale=scale,
               step_errs=[float(x) / scale for x in
                          (dec - want).abs().amax(dim=(0, 2))])
    return out


def zoo_model(torch, dev, arch, B, depth, decodes, prof_ok):
    """Serve one zoo model through ``generate`` (or, for the audio family,
    the prefill step alone) at published width, held to its attention
    launches, and run ``zoo_checks``.  Returns the prefill's launches and
    the distinct shapes it launched the attention kernel at."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.fl.distributed import make_prefill_step
    from repro_torch.kernels import common
    from repro_torch.models.registry import build_model
    from repro_torch.serve import generate
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    if depth:
        cfg = dataclasses.replace(cfg, num_layers=depth)
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(gen)
    zoo_leaves(torch, params, gen)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 2**30
    n_params = sum(x.numel() for x in _leaves(params))
    batch = zoo_batch(torch, cfg, B, LM_PROMPT + LM_CHECK, gen, dev)
    want = {"attention": ZOO_PREFILL_LAUNCHES[arch]}
    common.reset_launches()
    if decodes:
        extra = ({"encoder_embeddings": batch["encoder_embeddings"]}
                 if cfg.family == "vlm" else None)
        toks, st = generate(model, params, batch["tokens"][:, :LM_PROMPT],
                            LM_GEN, temperature=0.8, generator=gen,
                            extra=extra)
        got = dict(common.LAUNCHES)
        shapes = set(common.SHAPES["attention"])
        require(tuple(toks.shape) == (B, LM_GEN) and 0 <= int(toks.min())
                and int(toks.max()) < cfg.vocab_size,
                f"{arch}: sampled tokens out of range")
        served = (f"first prefill {B}x{LM_PROMPT} {st['prefill_ms']:.2f} ms,"
                  f" decode {LM_GEN} tokens {st['decode_tokens_per_s']:.2f} "
                  f"tok/s ({st['decode_s']:.3f} s); seq 0: "
                  f"{toks[0].tolist()}")
        decode_launches = st["launches_decode"]
    else:
        prefill = make_prefill_step(cfg, cache_len=LM_PROMPT + 8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        last, _ = prefill(params, _upto(batch, LM_PROMPT))
        torch.cuda.synchronize()
        got = dict(common.LAUNCHES)
        shapes = set(common.SHAPES["attention"])
        require(tuple(last.shape) == (B, 1, cfg.vocab_size)
                and bool(torch.isfinite(last).all()),
                f"{arch}: prefill logits {tuple(last.shape)} not finite")
        served = (f"first prefill {B}x{LM_PROMPT} "
                  f"{(time.perf_counter() - t0) * 1e3:.2f} ms (no decode: "
                  f"audio)")
        decode_launches = {}
        del last
    require(got == want and decode_launches == {},
            f"{arch}: launches {got}, decode {decode_launches}, want {want} "
            f"in prefill and none in decode")
    cut = f", cut to {depth} of {get_config(arch).num_layers} layers" \
        if depth else ""
    log(f"{arch}: {n_params / 1e9:.3f} B params ({cfg.param_dtype}, "
        f"{cfg.num_layers} layers{cut}, d_model {cfg.d_model}) drawn on the "
        f"card in {t_init:.2f} s (peak {init_peak:.2f} GiB); B = {B}; "
        f"{served}; launches prefill {got}"
        f" decode {decode_launches}")
    rows = 1 if cfg.num_experts else B
    res = zoo_checks(torch, model, params, batch, LM_PROMPT,
                     LM_CHECK if decodes else 0, rows)
    dropped, total = res["drops"]
    moe = (f"; dropped {dropped} of {total} assignments "
           f"({100 * dropped / total:.3f} %) at capacity factor "
           f"{cfg.capacity_factor}" if cfg.num_experts else "")
    msg = (f"{arch}: warm prefill step {B}x{LM_PROMPT} {res['warm_ms']:.2f} "
           f"ms (its logits {res['head_err']:.3g} x scale off the full "
           f"forward's, bound {HEAD_TOL}; bitwise the head on the "
           f"forward's last row: {res['trunk_same']}; between "
           f"{ZOO_HEAD_ROWS} rows and 1, the final norm's last row differs "
           f"in {res['norm_diff']} of {B * cfg.d_model} elements and the "
           f"head GEMM by {res['gemm_err']:.3g} x scale){moe}")
    if decodes:
        err, rel, scale = res["err"], res["rel"], res["scale"]
        bounds = ZOO_BF16_CONSISTENCY[arch]
        factor = (f", capacity factor "
                  f"{zoo_check_config(cfg).capacity_factor:.4g}"
                  if cfg.num_experts else "")
        msg += (f"; bf16 prefill({LM_PROMPT})+{LM_CHECK} steps vs prefill("
                f"{LM_PROMPT + LM_CHECK}) on {rows} sequence(s){factor}: max "
                f"err {err:.4g} x scale, rel L2 {rel:.4g} (bounds {bounds}, "
                f"max |logit| {scale:.4g}); each step's max err x scale "
                f"{[round(e, 5) for e in res['step_errs']]}; warm decode "
                f"{LM_CHECK * rows / res['decode_ms'] * 1e3:.2f} tok/s on "
                f"{rows} sequence(s)")
        if "flips" in res:
            noise_gap = max(res["noise_gaps"], default=0.0)
            msg += (f"; MoE layers routed otherwise than the forward, a "
                    f"step: {res['flips']} (the forward's k-th less "
                    f"(k+1)-th probability there at most "
                    f"{max(res['gaps'], default=0.0):.3g}); routed as the "
                    f"forward: max err {res['replayed'][0]:.4g} x scale, "
                    f"rel L2 {res['replayed'][1]:.4g} (bounds "
                    f"{ZOO_REPLAYED_CONSISTENCY[arch]}), the steps' own "
                    f"choice otherwise in {res['noise_flips']}, gap at most "
                    f"{noise_gap:.3g} (bound {ZOO_FLIP_GAP[arch]})")
    log(msg + f"; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if decodes:
        require(err <= bounds[0] and rel <= bounds[1],
                f"{arch}: decode disagrees with prefill")
    if "replayed" in res:
        rb = ZOO_REPLAYED_CONSISTENCY[arch]
        require(res["replayed"][0] <= rb[0] and res["replayed"][1] <= rb[1],
                f"{arch}: decode routed as the forward disagrees with it")
        require(noise_gap <= ZOO_FLIP_GAP[arch],
                f"{arch}: a decode step fed the forward's routing chose "
                f"experts whose forward gap {noise_gap:.3g} is past bf16 "
                f"noise")
    if prof_ok and arch in ZOO_PROFILED:
        profile_serving(torch, model, params,
                        batch["tokens"][:, :LM_PROMPT], arch)
    del params, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    return got, shapes


def phase_lm_zoo(torch, dev, prof_ok):
    """Serve the zoo's primary models, then its secondary ones, each
    through ``zoo_model``, then hold the attention kernel to its plain
    version at every shape those prefills launched it at
    (``zoo_attention_checks``).  Returns the attention kernel's launches
    over the phase."""
    total, shapes = 0, {}
    runs = [(arch, LM_BATCH, None, True) for arch in ZOO_PRIMARY]
    for arch, B, depth, decodes in runs + list(ZOO_SECONDARY):
        got, seen = zoo_model(torch, dev, arch, B, depth, decodes, prof_ok)
        total += got["attention"]
        for shp in seen:
            shapes.setdefault(shp, []).append(arch)
    zoo_attention_checks(torch, dev, shapes)
    return total


def zoo_attention_checks(torch, dev, shapes):
    """The attention kernel at each of ``shapes`` (shape -> the models
    that launch it there) on seeded bf16 and f32 inputs against its plain
    version, at ``BF16_ATTN_TOL`` and ``F32_ATTN_TOL`` elementwise."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    for shp, archs in sorted(shapes.items()):
        B, H, S, hd, KV, T, hdv, kw = attn_dims(shp)
        errs = []
        for dtype, (atol, rtol) in ((torch.bfloat16, BF16_ATTN_TOL),
                                    (torch.float32, F32_ATTN_TOL)):
            q, k, v = attn_inputs(torch, B, H, KV, S, T, hd, dtype, 88, dev,
                                  hdv)
            got = flash_attention_cuda(q, k, v, **kw)
            want = ref.attention_ref(q, k, v, **kw)
            err = (got.float() - want.float()).abs()
            errs.append(float(err.max()))
            require(bool((err <= atol + rtol * want.float().abs()).all()),
                    f"attention {dtype} at {shp} ({archs}): max abs err "
                    f"{errs[-1]:.3g} over tolerance")
            del q, k, v, got, want, err
        log(f"attention at {shp} ({', '.join(archs)}): kernel vs plain, "
            f"max abs err bf16 {errs[0]:.3g} (atol {BF16_ATTN_TOL[0]} + "
            f"rtol {BF16_ATTN_TOL[1]}), f32 {errs[1]:.3g} (atol "
            f"{F32_ATTN_TOL[0]} + rtol {F32_ATTN_TOL[1]})")
    torch.cuda.empty_cache()


def zoo_timing_cases():
    """phase_timing's rows at the zoo's attention shapes (B = 4, the
    3072-token prompt, bf16): qwen2-7b's layers, gemma3-27b's local and
    global ones and llama-3.2-vision-11b's cross layers, each with its
    launches in one prefill."""
    from repro_torch.configs import get_config
    rows = []
    for arch, kind, n in (("qwen2-7b", "global", 28),
                          ("gemma3-27b", "local", 52),
                          ("gemma3-27b", "global", 10),
                          ("llama-3.2-vision-11b", "cross", 8)):
        cfg = get_config(arch)
        T = cfg.num_encoder_tokens if kind == "cross" else LM_PROMPT
        rows.append((f"attention@{arch}/{kind}", "attention",
                     ((LM_BATCH, cfg.num_heads, LM_PROMPT, cfg.head_dim),
                      (LM_BATCH, cfg.num_kv_heads, T, cfg.head_dim),
                      (int(kind != "cross"),
                       cfg.window_size if kind == "local" else 0)), n))
    return rows


# LM training phase: recurrentgemma-2b and rwkv6-3b at published width and
# depth (bf16, remat), FedCGD over 8 silos of 2 sequences of 256 tokens
# (4096 tokens a round), 3 rounds.  recurrentgemma-2b's S x vocab = 65.5 M
# > 2**24 takes the chunked CE; rwkv6-3b's 256 x 65536 = 2**24 exactly is
# not over it, so it takes the whole [B, S, V] f32 logits (1 GiB)
TRAIN_ARCHS = ("recurrentgemma-2b", "rwkv6-3b")
TRAIN_SILOS, TRAIN_PER_SILO, TRAIN_SEQ, TRAIN_ROUNDS = 8, 2, 256, 3
# phase 8b, the LM zoo's training in the same world: (arch, depth, full).
# Each model at published width, at full depth where its step's peak stays
# well under the card's 80 GB, else at the most whole pattern periods that
# do: the step holds the params, their gradients (both bf16) and an f32
# copy of the largest gradient leaf (the grad norm).  gemma3-27b, yi-34b
# and moonshot-v1-16b-a3b at 24 layers (of 62, 60 and 48), qwen3-moe at 5
# of 94 (5 GB of weights a layer), arctic-480b at 1 of 35 (its 128 experts
# alone 27 GB a layer).  ``full``: 3 rounds, the twin, a plain step and a
# profiled step; else one round and the twin
ZOO_TRAIN = (("qwen2-7b", None, True), ("moonshot-v1-16b-a3b", 24, True),
             ("llama-3.2-vision-11b", None, True), ("gemma3-27b", 24, False),
             ("yi-34b", 24, False), ("musicgen-large", None, False),
             ("qwen3-moe-235b-a22b", 5, False), ("arctic-480b", 1, False))
ZOO_TRAIN_PEAK_GIB = 75.0       # a zoo train step's peak memory, at most
# launches a train step: with remat every layer's forward runs again in
# the backward, so the forward kernels launch twice (the WKV forward saves
# its chunk states both times: the checkpoint drops the first pass's, the
# recompute's feed K5-bwd), and each backward kernel once a layer (K4-bwd
# is three launches, K5-bwd two, each counted once).  The zoo's models
# run no kernel but K4: ``train_step_launches``
TRAIN_STEP_LAUNCHES = {
    "recurrentgemma-2b": {"attention": 16, "attention_bwd": 8, "rglru": 36,
                          "rglru_bwd": 18},
    "rwkv6-3b": {"wkv": 64, "wkv_bwd": 32}}
TRAIN_LOSS_RTOL, TRAIN_PARAM_RTOL = 1e-5, 1e-4   # card vs CPU, f32
# profile_rounds' traces (tens of MB a train step), in the ignored build
# directory
TRACE_DIR = ROOT / ".torch_ext_build" / "traces"


def _rel_l2(torch, got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def train_step_launches(cfg, seq=TRAIN_SEQ):
    """The launches of one train step of ``cfg`` (at the depth it trains
    at, ``seq`` positions): ``TRAIN_STEP_LAUNCHES`` for phase 8's
    models; for the zoo's and moonlight-16b-a3b, K4 twice and K4-bwd once
    a layer that runs attention (global, local, cross and latent); and
    for a bf16 config the head's split (K7) once a head chunk (the whole
    sequence where seq x vocab is at most 2**24, else chunks of
    ``CE_CHUNK``); for each layer of the held MoE (kind ``MLA``), K8's
    dispatch and combine twice (forward and recompute) and their backward
    once."""
    from repro_torch.configs.base import (CROSS_ATTN, GLOBAL_ATTN,
                                          LOCAL_ATTN, MLA, MLA_DENSE)
    from repro_torch.models.transformer import CE_CHUNK
    if cfg.name in TRAIN_STEP_LAUNCHES:
        out = dict(TRAIN_STEP_LAUNCHES[cfg.name])
    else:
        n = sum(cfg.layer_kind(i) in (GLOBAL_ATTN, LOCAL_ATTN, CROSS_ATTN,
                                      MLA, MLA_DENSE)
                for i in range(cfg.num_layers))
        out = {"attention": 2 * n, "attention_bwd": n}
    n_moe = sum(cfg.layer_kind(i) == MLA for i in range(cfg.num_layers))
    if n_moe:
        out.update(moe_dispatch=2 * n_moe, moe_combine=2 * n_moe,
                   moe_combine_bwd=n_moe, moe_dispatch_bwd=n_moe)
    if cfg.dtype == cfg.param_dtype == "bfloat16":
        big = seq * cfg.vocab_size > 1 << 24
        out["head_split"] = -(-seq // CE_CHUNK) if big else 1
    return out


def train_params(torch, cfg, gen):
    """``cfg``'s params drawn from ``gen``; a zoo model's zero-initialised
    leaves made nonzero (``zoo_leaves``: a closed cross gate would leave
    its layer's attention without a gradient)."""
    from repro_torch.models import transformer as T
    params = T.init(gen, cfg)
    if cfg.name.removesuffix("-reduced") not in TRAIN_ARCHS:
        zoo_leaves(torch, params, gen)
    return params


def train_batch(torch, cfg, toks, seed):
    """``launch.train.lm_batch``'s batch of token rows ``toks`` [B, S+1]
    (the audio family's frame embeddings N(0, 1)); the VLM's encoder
    embeddings N(0, 1) from ``seed`` in place of lm_batch's zeros, whose
    keys and values would be zero."""
    import numpy as np

    from repro_torch.launch.train import lm_batch
    rng = np.random.default_rng(seed)
    batch = lm_batch(cfg, toks, rng)
    if "encoder_embeddings" in batch:
        batch["encoder_embeddings"] = torch.from_numpy(rng.standard_normal(
            tuple(batch["encoder_embeddings"].shape),
            dtype=np.float32)).to(toks.device)
    return batch


def train_card_vs_cpu(torch, dev, arch):
    """The reduced f32 step of ``arch`` on the card (its kernels and their
    backward kernels) against the same step on the CPU (the plain
    versions): the loss within 1e-5 relative, every new param within 1e-4
    relative in L2 a leaf."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.fl.distributed import make_train_step
    cfg = get_config(arch).reduced()
    params = train_params(torch, cfg, torch.Generator().manual_seed(1))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 41)).astype(np.int32))
    batch = train_batch(torch, cfg, toks, 1)
    step = make_train_step(cfg, eta=0.1)
    want, wm = step(params, batch)
    got, gm = step(_to(params, dev), {k: v.to(dev) for k, v in batch.items()})
    loss_err = abs(float(gm["loss"]) - float(wm["loss"])) / abs(
        float(wm["loss"]))
    worst = max((_rel_l2(torch, a, b), k) for (k, a), (_, b)
                in zip(_paths(got), _paths(want)))
    log(f"{cfg.name} train step, card vs CPU: loss {float(gm['loss']):.6f} "
        f"vs {float(wm['loss']):.6f} ({loss_err:.3g} relative), worst "
        f"param {worst[1]} {worst[0]:.3g} relative L2")
    require(loss_err <= TRAIN_LOSS_RTOL and worst[0] <= TRAIN_PARAM_RTOL,
            f"{cfg.name}: the card's train step disagrees with the CPU's")


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def _paths(tree, prefix=""):
    """(path, leaf) of a nested dict in sorted key order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _paths(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, tree[k]


class HostParams:
    """A pinned host buffer that holds one params tree at a time (the first
    of two runs, while the second runs on the card), grown as a larger
    tree comes: on an H100 host a pageable copy of qwen2-7b's 15.2 GB
    took 6.76 s, a pinned one 0.36 s."""

    def __init__(self, torch):
        self.torch, self.buf = torch, None

    def hold(self, tree):
        """{path: pinned host copy} of ``tree``'s leaves."""
        torch = self.torch
        leaves = [(k, x, x.numel() * x.element_size()) for k, x
                  in _paths(tree)]
        need = sum(-(-n // 16) * 16 for _, _, n in leaves)
        if self.buf is None or self.buf.numel() < need:
            self.buf = None
            self.buf = torch.empty(need, dtype=torch.uint8, pin_memory=True)
        out, off = {}, 0
        for k, x, n in leaves:
            out[k] = self.buf[off:off + n].view(x.dtype).view(x.shape)
            out[k].copy_(x)
            off += -(-n // 16) * 16
        return out


class StepRounds:
    """One train step a round on a fixed batch, for
    ``repro_torch.obs.profile_rounds`` (which needs ``run_round(j)``, a
    ``history`` and the ``device``)."""

    def __init__(self, step, params, batch, device):
        self.step, self.params, self.batch = step, params, batch
        self.device, self.history = device, []

    def run_round(self, j):
        self.history.append(self.step(self.params, self.batch)[1])


def log_profile(tag, prof, top=10):
    """Log a ``profile_rounds`` result: the device's busy share of the wall
    time (summed kernel and copy time over the host clock, the profiler's
    own cost included, so a lower bound), its ops, the longest kernels,
    the port's kernels and the phase split where there is one."""
    log(f"{tag}: wall {prof.wall_ms:.2f} ms, device busy "
        f"{prof.device_ms:.3f} ms ({100 * prof.busy_share:.1f}%), "
        f"{prof.device_ops} device ops; longest: " + "; ".join(
            f"{k[:60]} {ms:.3f} ms x{n}"
            for k, (ms, n) in list(prof.kernels.items())[:top]))
    log(f"{tag}: the port's kernels: " + ("; ".join(
        f"{k[:60]} {ms:.3f} ms x{n} ({ms / n:.4f} ms a launch)"
        for k, (ms, n) in prof.kernels.items()
        if any(s in k for s in PORT_KERNEL_SYMBOLS)) or "none"))
    if prof.phases:
        log(f"{tag}: by phase (host ms, device ms, ops, busy): " + "; ".join(
            f"{k} {v['wall_ms']:.2f} / {v['device_ms']:.3f} / "
            f"{v['device_ops']} / {100 * (v['busy_share'] or 0):.1f}%"
            for k, v in prof.phases.items()))


def phase_lm_train(torch, dev, prof_ok):
    """FedCGD over LM silos on each of ``TRAIN_ARCHS`` (``train_arch``).
    Returns the runs' launches and kernel shapes, merged."""
    launches, shapes = {}, {}
    host = HostParams(torch)
    for arch in TRAIN_ARCHS:
        t0 = time.perf_counter()
        got, shp, _ = train_arch(torch, dev, prof_ok, host, arch)
        launches.update(got)
        shapes.update(shp)
        log(f"[LM training, {arch}] done in {time.perf_counter() - t0:.2f} s")
    return launches, shapes


def phase_lm_zoo_train(torch, dev, prof_ok):
    """Phase 8b: FedCGD over LM silos on each of ``ZOO_TRAIN``
    (``train_arch`` at its depth, full treatment or one round and the
    twin), then K4-bwd held to its plain version at every shape those
    steps launched it at and at gemma3-27b's local layers at S = T = 2048
    (``zoo_attention_bwd_checks``).  Returns {arch: (launches, the
    shapes of each kernel's last launch)}."""
    out, bwd_shapes = {}, {}
    host = HostParams(torch)
    for arch, depth, full in ZOO_TRAIN:
        t0 = time.perf_counter()
        out[arch] = train_arch(torch, dev, prof_ok, host, arch, depth, full)
        for shp in out[arch][2]:
            bwd_shapes.setdefault(shp, []).append(arch)
        log(f"[LM zoo training, {arch}] done in "
            f"{time.perf_counter() - t0:.2f} s")
    del host
    from repro_torch.configs import get_config
    g = get_config("gemma3-27b")
    bwd_shapes[((2, g.num_heads, 2048, g.head_dim),
                (2, g.num_kv_heads, 2048, g.head_dim),
                (1, g.window_size))] = ["gemma3-27b at S = 2048"]
    zoo_attention_bwd_checks(torch, dev, bwd_shapes)
    return out


# phase 8c: the sharding context on one card (world size 1) and the dry
# run.  (arch, depth): each model the phase trains at phase 8b's depth,
# with the regime its production mesh picks (tp_capable at 16 ranks):
# qwen2-7b, recurrentgemma-2b and rwkv6-3b context-parallel (tp False),
# moonshot-v1-16b-a3b (its MoE layer at a model axis of 1: every expert
# local) and llama-3.2-vision-11b (cross attention) tensor-parallel
SHARDED_TRAIN = (("qwen2-7b", None), ("moonshot-v1-16b-a3b", 24),
                 ("llama-3.2-vision-11b", None), ("recurrentgemma-2b", None),
                 ("rwkv6-3b", None))
SHARDED_PREFILL, SHARDED_DECODES = (4, 3072), 8
# the dry runs: (arch, shape, multi-pod), in a process each on the host's
# CPU (a "fake" group of 256 / 512 ranks, meta tensors)
DRYRUNS = (("qwen2-7b", "train_4k", False), ("qwen2-7b", "train_4k", True),
           ("moonshot-v1-16b-a3b", "train_4k", False))
DRYRUN_DIR = ROOT / ".torch_ext_build" / "dryrun"
# counted FLOPs x devices over 6 N D for qwen2-7b train_4k: per-layer remat
# runs the trunk's forward twice (8 N D, less the last product of each
# layer, whose recompute the checkpoint skips) and the plain attention
# counts the whole S x T matrix; outside this range a layer is counted
# twice or not at all, or the counts are global
DRYRUN_RATIO = (1.0, 2.0)
# K4 / K4-bwd on a shard [a, b) of the queries at q_offset = a, over all
# keys (context parallelism): qwen2-7b's and gemma3-27b's prefill heads
# (B, H, KV, S, hd, window) and the slices, edges mid-way through the
# 64-key and 128-query tiles
Q_OFFSET_SHAPES = ((1, 28, 4, 3072, 128, 0), (1, 32, 16, 3072, 128, 1024))
Q_OFFSET_SLICES = ((0, 1000), (1000, 2048), (2048, 3072), (1100, 1237))


def start_dryruns():
    """The dry runs' processes (their CPU work overlaps the card's)."""
    import os
    DRYRUN_DIR.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    procs = []
    for arch, shape, mp in DRYRUNS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", str(DRYRUN_DIR)]
        procs.append(((arch, shape, mp), subprocess.Popen(
            cmd + (["--multi-pod"] if mp else []), cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    return procs


def finish_dryruns(procs, timeout=600):
    """Wait for the dry runs (killing any left on a failure), log each
    one's per-device numbers and bottleneck, and hold qwen2-7b
    train_4k's counted FLOPs x devices over 6 N D to ``DRYRUN_RATIO``."""
    t0 = time.perf_counter()
    try:
        for (arch, shape, mp), p in procs:
            out, _ = p.communicate(
                timeout=max(1.0, timeout - (time.perf_counter() - t0)))
            tag = f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}"
            require(p.returncode == 0, f"dry run {tag} failed:\n{out[-3000:]}")
            res = json.loads((DRYRUN_DIR / f"{tag}.json").read_text())
            r, c = res["roofline"], res["collectives"]
            peak = res["memory_analysis"]["peak_bytes_per_device"]
            ratio = (r["flops_per_device"] * r["chips"] / r["model_flops"])
            log(f"dry run {tag} ({res['chips']} fake ranks, tp "
                f"{res['tp_mode']}, trace {res['trace_s']:.2f} s): per "
                f"device {r['flops_per_device']:.6e} FLOPs, "
                f"{r['bytes_per_device']:.6e} bytes (unfused), "
                f"{r['collective_bytes_per_device']:.6e} collective bytes "
                f"(" + ", ".join(f"{k} {c[k]:.4e} x{c['counts'][k]}"
                                 for k in c["counts"] if c["counts"][k])
                + f"), peak {peak / 2**30:.3f} GiB; roofline at the H100's "
                f"peaks: compute "
                f"{r['compute_s']:.4e} s, memory {r['memory_s']:.4e} s, "
                f"collective {r['collective_s']:.4e} s -> "
                f"{r['bottleneck']}-bound; counted FLOPs x devices / "
                f"6 N D = {ratio:.4f}")
            if (arch, shape) == ("qwen2-7b", "train_4k"):
                require(DRYRUN_RATIO[0] <= ratio <= DRYRUN_RATIO[1],
                        f"dry run {tag}: counted over model FLOPs {ratio:.4f}"
                        f" outside {DRYRUN_RATIO}")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def sharded_ctx(cfg, mesh, kind, B, S):
    """``launch.shardings.make_ctx`` on the one-rank mesh, with the
    regime (``tp``) the 16-way production model axis picks for ``cfg``
    (on a model axis of 1 every head count divides it)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch import shardings as SH
    from repro_torch.launch.shapes import InputShape
    ctx = SH.make_ctx(cfg, mesh, InputShape(kind, S, B, kind))
    return dataclasses.replace(
        ctx, tp=SH.tp_capable(get_config(cfg.name), 16))


def _shard(cfg, tree, ctx, mesh, kind):
    from repro_torch.launch import shardings as SH
    from repro_torch.sharding import shard_tree
    rule = {"params": lambda t: SH.param_shardings(t, cfg, ctx),
            "batch": lambda t: SH.batch_shardings(t, ctx)}[kind]
    return shard_tree(tree, rule(tree), mesh)


def sharded_train(torch, dev, host, mesh, arch, depth):
    """One federated train step of ``arch`` (phase 8's world: 8 silos x 2
    x 256 tokens, silo 3 unscheduled) unsharded, then on DTensor params
    under its ctx: loss, grad norm, the other metrics and every new param
    leaf bitwise equal, and the kernels launched the same times.  Logs
    both steps' ms and peak memory.  Returns the sharded step's
    launches."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.fl.distributed import make_train_step, silo_weights
    from repro_torch.kernels import common
    from repro_torch.launch import federated_lm_silos
    from repro_torch.sharding import local
    cfg = get_config(arch)
    if depth:
        cfg = dataclasses.replace(cfg, num_layers=depth)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = train_params(torch, cfg, gen)
    ds, _, _ = federated_lm_silos.silo_world(cfg, TRAIN_SILOS, TRAIN_SEQ, 8)
    B = TRAIN_SILOS * TRAIN_PER_SILO
    batch = train_batch(torch, cfg, torch.from_numpy(ds.inputs[:B]).to(dev),
                        8)
    mask = np.ones(TRAIN_SILOS)
    mask[3] = 0
    batch["schedule_weights"] = silo_weights(mask, TRAIN_SILOS) \
        .repeat_interleave(TRAIN_PER_SILO).to(dev)
    out = {}
    sctx = sharded_ctx(cfg, mesh, "train", B, TRAIN_SEQ)
    for name, ctx in (("unsharded", None), ("sharded", sctx)):
        p, b = params, batch
        if ctx is not None:
            p = _shard(cfg, params, ctx, mesh, "params")
            b = _shard(cfg, batch, ctx, mesh, "batch")
        step = make_train_step(cfg, eta=0.05, federated=True, ctx=ctx)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        common.reset_launches()
        t0 = time.perf_counter()
        new, met = step(p, b)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        out[name] = (dict(common.LAUNCHES), met, ms,
                     torch.cuda.max_memory_allocated() / 2**30)
        if ctx is None:
            first = host.hold(new)
        else:
            same = all(torch.equal(first[k].to(dev), local(x))
                       for k, x in _paths(new))
        del new
    (l0, m0, ms0, pk0), (l1, m1, ms1, pk1) = out["unsharded"], out["sharded"]
    same_m = all(torch.equal(m0[k], m1[k]) for k in m0)
    log(f"{cfg.name} ({cfg.num_layers} layers, tp {sctx.tp}) federated "
        f"train step on the (1, 1) mesh: unsharded {ms0:.2f} ms, "
        f"peak {pk0:.2f} GiB; sharded (DTensor) {ms1:.2f} ms, peak "
        f"{pk1:.2f} GiB; loss {float(m1['loss']):.6f}, grad norm "
        f"{float(m1['grad_norm']):.6f}; metrics bitwise equal {same_m}, "
        f"params bitwise equal {same}; launches {l1} (unsharded {l0})")
    require(same_m and same, f"{cfg.name}: the sharded step differs from "
            f"the unsharded one at world size 1")
    require(l0 == l1 and l1 == train_step_launches(cfg),
            f"{cfg.name}: launches {l1}, unsharded {l0}")
    del params
    return l1


def sharded_serve(torch, dev, mesh):
    """qwen2-7b's prefill of 4 x 3072 tokens and 8 greedy decode steps,
    unsharded then under the prefill and decode ctxs: every step's
    logits and the final cache bitwise equal."""
    from repro_torch.configs import get_config
    from repro_torch.fl.distributed import make_prefill_step, make_serve_step
    from repro_torch.kernels import common
    from repro_torch.sharding import local
    cfg = get_config("qwen2-7b")
    B, S = SHARDED_PREFILL
    gen = torch.Generator(device=dev).manual_seed(1)
    params = train_params(torch, cfg, gen)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    L = S + SHARDED_DECODES
    runs = {}
    for name in ("unsharded", "sharded"):
        pctx = dctx = None
        p = params
        if name == "sharded":
            pctx = sharded_ctx(cfg, mesh, "prefill", B, S)
            dctx = sharded_ctx(cfg, mesh, "decode", B, S)
            p = _shard(cfg, params, pctx, mesh, "params")

        def inputs(tree, ctx):
            return tree if ctx is None else _shard(cfg, tree, ctx, mesh,
                                                   "batch")
        common.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            logits, cache = make_prefill_step(cfg, L, ctx=pctx)(
                p, inputs({"tokens": prompt}, pctx))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = [local(logits).clone()]
            serve = make_serve_step(cfg, ctx=dctx)
            for i in range(SHARDED_DECODES):
                # greedy on the unsharded run's logits: both runs decode
                # the same tokens
                last = runs["unsharded"][0][i] if runs else out[-1]
                tok = last[:, -1].argmax(-1)[:, None]
                logits, cache = serve(p, cache, inputs({"tokens": tok},
                                                       dctx))
                out.append(local(logits).clone())
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        runs[name] = (out, {k: local(x) for k, x in _paths(cache)},
                      1e3 * (t1 - t0), 1e3 * (t2 - t1) / SHARDED_DECODES,
                      dict(common.LAUNCHES))
    (o0, c0, p0, d0, l0), (o1, c1, p1, d1, l1) = runs["unsharded"], \
        runs["sharded"]
    same = all(torch.equal(a, b) for a, b in zip(o0, o1)) and all(
        torch.equal(c0[k], c1[k]) for k in c0)
    log(f"qwen2-7b prefill {B} x {S} and {SHARDED_DECODES} decode steps: "
        f"unsharded {p0:.2f} ms + {d0:.2f} ms a step, sharded {p1:.2f} ms "
        f"+ {d1:.2f} ms a step; launches {l1} (unsharded {l0}); logits and "
        f"cache bitwise equal {same}")
    require(same and l0 == l1 and l1.get("attention", 0) == cfg.num_layers,
            "qwen2-7b: the sharded prefill / decode differs from the "
            "unsharded one")
    del params


def q_offset_checks(torch, dev):
    """K4 and K4-bwd on query shards at their offsets against the plain
    version (module constant ``Q_OFFSET_SHAPES``), bf16 and f32 at the
    phase 2 tolerances."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd_cuda, flash_attention_cuda)
    worst = {}
    for B, H, KV, S, hd, window in Q_OFFSET_SHAPES:
        for dtype, tol in ((torch.bfloat16, BF16_ATTN_TOL),
                           (torch.float32, F32_ATTN_TOL)):
            q, k, v = attn_inputs(torch, B, H, KV, S, S, hd, dtype, S + H,
                                  dev)
            do = attn_inputs(torch, B, H, KV, S, S, hd, dtype, 7, dev)[0]
            full = ref.attention_ref(q, k, v, causal=True, window=window)
            for a, b in Q_OFFSET_SLICES:
                qs, dos = q[:, :, a:b], do[:, :, a:b]
                out = flash_attention_cuda(qs, k, v, window=window,
                                           q_offset=a)
                got = flash_attention_bwd_cuda(qs, k, v, dos, window=window,
                                               q_offset=a)
                want = ref.attention_bwd_ref(qs, k, v, dos, window=window,
                                             q_offset=a)
                torch.cuda.synchronize()
                for name, g, w in (("out", out, full[:, :, a:b]),
                                   *zip(("dq", "dk", "dv"), got, want)):
                    err = float(((g.float() - w.float()).abs()
                                 / (tol[0] + tol[1] * w.float().abs()))
                                .max())
                    key = f"{name}.{str(dtype)[6:]}"
                    worst[key] = max(worst.get(key, 0.0), err)
                    require(err <= 1.0, f"K4 at q_offset {a} ({H} heads, "
                            f"window {window}, {dtype}): {name} off by "
                            f"{err:.3f} x the tolerance")
            del q, k, v, do, full
    log("K4 / K4-bwd on query shards at their offsets (qwen2-7b's and "
        "gemma3-27b's heads, S = T = 3072, slices "
        f"{list(Q_OFFSET_SLICES)}): worst error over the tolerance "
        + ", ".join(f"{k} {v:.4f}" for k, v in sorted(worst.items())))


def phase_sharded(torch, dev):
    """Phase 8c: the dry runs start on the host's CPU; a one-rank nccl
    group (from an in-process HashStore) and a (1, 1) ("data", "model")
    mesh; ``sharded_train`` for each of ``SHARDED_TRAIN``,
    ``sharded_serve``, ``q_offset_checks``; then the dry runs' results
    (``finish_dryruns``).  Returns the sharded steps' launches."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    procs = start_dryruns()
    launches = {}
    try:
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
        mesh = make_debug_mesh(1, 1, device_type="cuda")
        host = HostParams(torch)
        for arch, depth in SHARDED_TRAIN:
            t0 = time.perf_counter()
            launches[arch] = sharded_train(torch, dev, host, mesh, arch,
                                           depth)
            log(f"[sharded, {arch}] done in {time.perf_counter() - t0:.2f} s")
        del host
        t0 = time.perf_counter()
        sharded_serve(torch, dev, mesh)
        log(f"[sharded serving] done in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        q_offset_checks(torch, dev)
        log(f"[K4 query offsets] done in {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        finish_dryruns(procs)
        log(f"[dry runs] waited {time.perf_counter() - t0:.2f} s")
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if dist.is_initialized():
            dist.destroy_process_group()
    from repro_torch.kernels import common
    common.reset_launches()
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def zoo_bwd_timing_case(arch, kind, trained):
    """phase_timing's K4-bwd row at the shape ``arch``'s train step
    launched it at for its layers of ``kind`` (``trained``: that model's
    ``train_arch`` result), with the run's launches at that shape."""
    shapes = trained[2]
    (shp,) = [x for x in shapes if bool(x[2][0]) == (kind != "cross")]
    return (f"attention_bwd@{arch}/{kind}", "attention_bwd", shp,
            shapes[shp])


def zoo_attention_bwd_checks(torch, dev, shapes):
    """K4-bwd at each of ``shapes`` (shape -> the models that launch it
    there) on seeded bf16 and f32 inputs against autograd of the plain
    attention (``ref.attention_bwd_ref``), at ``BF16_ATTN_TOL`` and
    ``F32_ATTN_TOL`` elementwise, a second call bitwise equal."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_bwd_cuda
    for shp, archs in sorted(shapes.items()):
        B, H, S, hd, KV, T, hdv, kw = attn_dims(shp)
        errs = []
        for dtype, (atol, rtol) in ((torch.bfloat16, BF16_ATTN_TOL),
                                    (torch.float32, F32_ATTN_TOL)):
            q, k, v = attn_inputs(torch, B, H, KV, S, T, hd, dtype, 86, dev,
                                  hdv)
            do = attn_inputs(torch, B, H, KV, S, T, hdv, dtype, 87, dev)[0]
            got = flash_attention_bwd_cuda(q, k, v, do, **kw)
            again = flash_attention_bwd_cuda(q, k, v, do, **kw)
            want = ref.attention_bwd_ref(q, k, v, do, **kw)
            err = 0.0
            for name, g, w, g2 in zip(("dq", "dk", "dv"), got, want, again):
                e = (g.float() - w.float()).abs()
                err = max(err, float(e.max()))
                require(torch.equal(g, g2) and bool(
                    (e <= atol + rtol * w.float().abs()).all()),
                        f"attention_bwd {dtype} {name} at {shp} ({archs}): "
                        f"max abs err {float(e.max()):.3g} over tolerance, "
                        f"or two calls differ")
            errs.append(err)
            del q, k, v, do, got, again, want
        log(f"attention_bwd at {shp} ({', '.join(archs)}): kernel vs plain, "
            f"max abs err bf16 {errs[0]:.3g} (atol {BF16_ATTN_TOL[0]} + "
            f"rtol {BF16_ATTN_TOL[1]}), f32 {errs[1]:.3g} (atol "
            f"{F32_ATTN_TOL[0]} + rtol {F32_ATTN_TOL[1]}); two calls "
            f"bitwise equal")
    torch.cuda.empty_cache()


def train_arch(torch, dev, prof_ok, host, arch, depth=None, full=True):
    """``arch`` at full width (and ``depth`` layers, or its own) through
    ``launch.federated_lm_silos.run``: 3 rounds of one schedule-weighted
    train step each (1 unless ``full``), every round's loss and grad norm
    finite, its kernels and their backward kernels launched
    ``train_step_launches`` times a round and nothing else; a second run
    on the same seed bitwise equal (metrics, masks, params: the first
    run's params wait on the host, in ``host``, a ``HostParams``, so one
    model's params and gradients are on the card at a time); with ``full`` one plain
    ``make_train_step`` step, and one profiled (``obs.profile_rounds``);
    first the card / CPU check of the reduced step.  Logs each round's
    share of the card's bf16 peak in model FLOPs (``roofline.model_flops``:
    6 x active params x tokens) and the peak memory.  Returns the run's
    launches, the shapes of each kernel's last launch and K4-bwd's
    launches at each shape it was launched at."""
    import collections
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.fl.distributed import make_train_step
    from repro_torch.kernels import common
    from repro_torch.launch import federated_lm_silos
    from repro_torch.roofline import PEAK_FLOPS, InputShape, model_flops
    train_card_vs_cpu(torch, dev, arch)
    cfg = get_config(arch)
    if depth:
        cfg = dataclasses.replace(cfg, num_layers=depth)
    require(cfg.remat and cfg.param_dtype == "bfloat16",
            f"{cfg.name}: not the bf16 remat config")
    per_round = train_step_launches(cfg)
    rounds = TRAIN_ROUNDS if full else 1
    log(f"{cfg.name}: S x vocab = {TRAIN_SEQ * cfg.vocab_size}, "
        + ("over 2**24: the chunked CE" if TRAIN_SEQ * cfg.vocab_size
           > 1 << 24 else "not over 2**24: the whole f32 logits"))
    tokens = TRAIN_SILOS * TRAIN_PER_SILO * TRAIN_SEQ
    flops = model_flops(cfg, InputShape("round", TRAIN_SEQ,
                                        TRAIN_SILOS * TRAIN_PER_SILO,
                                        "train"), "train")
    torch.cuda.reset_peak_memory_stats()

    def run():
        stamps = []

        def stamp(msg):                 # after float(loss): synchronised
            stamps.append(time.perf_counter())
            log(f"  {msg}")
        gen = torch.Generator(device=dev).manual_seed(0)
        # each run from an empty cache: a twin that reused the first run's
        # cached blocks found no free 13 GiB among 12 GiB of them (yi-34b)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        common.reset_launches()
        # the drawn params go straight into run(), which drops them after
        # its first step: no third copy beside the step's params and
        # gradients
        params, hist = federated_lm_silos.run(
            cfg, rounds=rounds, silos=TRAIN_SILOS,
            per_silo_batch=TRAIN_PER_SILO, seq=TRAIN_SEQ, device=dev,
            params=train_params(torch, cfg, gen), log=stamp, log_every=1)
        launches = dict(common.LAUNCHES)
        ms = [1e3 * (b - a) for a, b in zip([t0] + stamps, stamps)]
        return (params, hist, launches, dict(common.LAST_SHAPES),
                collections.Counter(common.SHAPES["attention_bwd"]), ms)

    params, hist, launches, shapes, bwd_shapes, ms = run()
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {k: v * rounds for k, v in per_round.items()}
    n_params = sum(x.numel() for _, x in _paths(params))
    cut = (f", {depth} of {get_config(arch).num_layers} layers" if depth
           else "")
    log(f"{cfg.name} FedCGD over {TRAIN_SILOS} silos x {TRAIN_PER_SILO} x "
        f"{TRAIN_SEQ} tokens, {n_params / 1e9:.3f} B params (bf16, "
        f"remat{cut}): rounds " + ", ".join(
            f"{m:.2f} ms (loss {float(h['metrics']['loss']):.4f}, grad norm "
            f"{float(h['metrics']['grad_norm']):.4f}, {h['scheduled']}/"
            f"{TRAIN_SILOS} scheduled; {flops / 1e12:.1f} TFLOP of model "
            f"FLOPs, {100 * flops / (m / 1e3 * PEAK_FLOPS):.1f} % of the "
            f"bf16 peak)" for m, h in zip(ms, hist))
        + f"; {tokens / (min(ms) / 1e3):.0f} tokens/s at the fastest round"
        f"; launches {launches}; peak memory {peak:.2f} GiB")
    require(launches == want, f"{cfg.name}: launches {launches}, want {want}")
    require(all(bool(torch.isfinite(h["metrics"][k]))
                for h in hist for k in ("loss", "grad_norm")),
            f"{cfg.name}: a round's loss or grad norm is not finite")
    require(peak < ZOO_TRAIN_PEAK_GIB, f"{cfg.name}: peak memory {peak:.2f} "
            f"GiB, past {ZOO_TRAIN_PEAK_GIB}")
    t0 = time.perf_counter()
    first = host.hold(params)
    del params
    t_host = time.perf_counter() - t0
    params, thist, _, _, _, tms = run()
    t0 = time.perf_counter()
    same = all(torch.equal(first[k].to(dev), x) for k, x in _paths(params))
    same &= all(torch.equal(h["metrics"][k], g["metrics"][k])
                and (h["mask"] == g["mask"]).all()
                for h, g in zip(hist, thist) for k in h["metrics"])
    del first
    log(f"{cfg.name} second run on the same seed: rounds "
        + ", ".join(f"{m:.2f} ms" for m in tms)
        + f"; bitwise equal: {same} (the first run's params to the host "
        f"{t_host:.2f} s, compared on the card "
        f"{time.perf_counter() - t0:.2f} s); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    require(same, f"{cfg.name}: two runs on one seed differ")
    if full:
        ds, _, _ = federated_lm_silos.silo_world(cfg, TRAIN_SILOS,
                                                 TRAIN_SEQ, 8)
        toks = torch.from_numpy(
            ds.inputs[:TRAIN_SILOS * TRAIN_PER_SILO]).to(dev)
        batch = train_batch(torch, cfg, toks, 8)
        step = make_train_step(cfg, eta=0.05)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, met = step(params, batch)
        torch.cuda.synchronize()
        log(f"{cfg.name} plain train step: "
            f"{1e3 * (time.perf_counter() - t0):.2f} ms, loss "
            f"{float(met['loss']):.4f}, grad norm "
            f"{float(met['grad_norm']):.4f}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        require(bool(torch.isfinite(met["loss"]) and torch.isfinite(
            met["grad_norm"])), f"{cfg.name}: the plain step is not finite")
        del new
        if prof_ok:
            from repro_torch.obs import profile_rounds
            prof = profile_rounds(StepRounds(step, params, batch, dev), 1,
                                  TRACE_DIR / cfg.name, warmup=0)
            log_profile(f"{cfg.name} profiled train step", prof)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, shapes, bwd_shapes


def first_layers(cfg, params, depth):
    """(config, params) of the model made of the first ``depth`` layers
    (whole pattern periods) and the same embedding and head: views of the
    stacked period weights, no copy."""
    import dataclasses
    sub = dataclasses.replace(cfg, num_layers=depth)
    require(depth < cfg.num_layers and sub.num_remainder_layers == 0,
            f"{depth} is not a prefix of whole periods")

    def take(tree):
        return ({k: take(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree[:sub.num_full_periods])
    out = {k: v for k, v in params.items()
           if k != "blocks" and not k.startswith("rem")}
    out["blocks"] = take(params["blocks"])
    return sub, out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# phase 8d, moonlight-16b-a3b as the benchmark cell ``moonlight-silos``
# trains it: one chip's share (experts 0-7 of each MoE layer's 64, ids
# 0-20479 of the 163840), all 27 layers at published width, bf16 with
# remat, 8 sequences of 4096 tokens.  Its attention: q and k [8, 16,
# 4096, 192] (nope 128 | rope 64), v [8, 16, 4096, 128], causal, scale
# 1/sqrt(192): K4 and K4-bwd at the (192, 128) head pair
MLA_CUT = {"experts_held": 8, "vocab_size": 20480}
MLA_BATCH, MLA_SEQ = 8, 4096
MLA_SHAPE = ((MLA_BATCH, 16, MLA_SEQ, 192), (MLA_BATCH, 16, MLA_SEQ, 192),
             (1, 0), (MLA_BATCH, 16, MLA_SEQ, 128))


def phase_mla(torch, dev):
    """Phase 8d: K4 and K4-bwd at ``MLA_SHAPE`` on seeded bf16 and f32
    inputs against their plain versions (``zoo_attention_checks``,
    ``zoo_attention_bwd_checks``: ``BF16_ATTN_TOL`` and ``F32_ATTN_TOL``,
    two backward calls bitwise equal); then one federated train step of
    the cell's configuration (weights from ``transformer.init`` on a
    seeded generator, token rows from a seed, every row weighted), its
    loss, grad norm and MoE counters finite and its launches
    ``train_step_launches`` at ``MLA_SEQ``, K4 and K4-bwd launched at
    ``MLA_SHAPE`` alone; a second step from the same seed bitwise equal
    (loss, grad norm, counters, every param).  Returns the step's
    launches at ``MLA_SHAPE`` ({"attention": n, "attention_bwd": n}) and
    K8's ({entry point: n})."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.fl.distributed import make_train_step
    from repro_torch.kernels import common
    from repro_torch.models import transformer as T
    zoo_attention_checks(torch, dev, {MLA_SHAPE: ["moonlight-16b-a3b"]})
    zoo_attention_bwd_checks(torch, dev, {MLA_SHAPE: ["moonlight-16b-a3b"]})
    cfg = dataclasses.replace(get_config("moonlight-16b-a3b"), **MLA_CUT)
    g = torch.Generator(device=dev).manual_seed(31)
    toks = torch.randint(0, cfg.vocab_size, (MLA_BATCH, MLA_SEQ + 1),
                         generator=g, device=dev)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "schedule_weights": torch.ones(MLA_BATCH, device=dev)}
    step = make_train_step(cfg, eta=0.05, federated=True)

    def run():
        gc.collect()
        torch.cuda.empty_cache()
        params = T.init(torch.Generator(device=dev).manual_seed(32), cfg)
        common.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, met = step(params, batch)
        met = {k: v.clone() for k, v in met.items()}
        torch.cuda.synchronize()
        return (new, met, 1e3 * (time.perf_counter() - t0),
                dict(common.LAUNCHES),
                {k: dict(common.SHAPES[k])
                 for k in ("attention", "attention_bwd")})

    torch.cuda.reset_peak_memory_stats()
    params, met, ms, launches, shapes = run()
    peak = torch.cuda.max_memory_allocated() / 2**30
    n = sum(x.numel() for _, x in _paths(params))
    last = cfg.expert_lo + cfg.num_held - 1
    log(f"{cfg.name} (experts {cfg.expert_lo}-{last} of {cfg.num_experts}, "
        f"vocab {cfg.vocab_size}) federated "
        f"train step over {MLA_BATCH} x {MLA_SEQ} tokens, {n / 1e9:.3f} B "
        f"params: {ms:.2f} ms (the first, with its kernels' first calls), "
        + ", ".join(f"{k} {float(v):.6g}" for k, v in met.items())
        + f"; launches {launches}, K4 / K4-bwd by shape {shapes}; peak "
        f"memory {peak:.2f} GiB")
    want = train_step_launches(cfg, MLA_SEQ)
    require(launches == want, f"{cfg.name}: launches {launches}, want {want}")
    require(shapes == {k: {MLA_SHAPE: want[k]}
                       for k in ("attention", "attention_bwd")},
            f"{cfg.name}: K4 / K4-bwd launched at {shapes}, not at "
            f"{MLA_SHAPE} alone")
    require(all(bool(torch.isfinite(v)) for v in met.values())
            and int(met["moe_tokens_held"]) > 0,
            f"{cfg.name}: a metric is not finite, or no held assignment")
    first = {k: x.cpu() for k, x in _paths(params)}
    del params
    params, met2, ms2, _, _ = run()
    same = all(torch.equal(met[k], met2[k]) for k in met) and all(
        torch.equal(first[k], x.cpu()) for k, x in _paths(params))
    log(f"{cfg.name} second step from the same seed: {ms2:.2f} ms; "
        f"bitwise equal: {same}")
    require(same, f"{cfg.name}: two steps from one seed differ")
    del params, first
    gc.collect()
    torch.cuda.empty_cache()
    return ({k: want[k] for k in ("attention", "attention_bwd")},
            {k: want[k] for k in MOE_ROWS_ENTRIES})


# K8 at the cell's shape: T = 8 x 4096 tokens, k 6, d 2048, bf16, experts
# 0-7 of 64 held, each token's experts its top 6 by seeded uniform scores
# (about T k / 8 = 24576 held rows, as in the cell's layers)
MOE_ROWS_DIMS = (MLA_BATCH * MLA_SEQ, 6, 2048)
MOE_ROWS_ENTRIES = ("moe_dispatch", "moe_combine", "moe_combine_bwd",
                    "moe_dispatch_bwd")


def moe_rows_bytes(shapes, itemsize=2):
    """{entry point: bytes} of K8 at ``shapes`` ((T, k, d), (H, Th)): H
    held rows, Th tokens with a held slot; each input read once, each
    output written once (slot and src int64, w and dw f32, the rows
    ``itemsize`` bytes an element)."""
    (T, k, d), (H, Th) = shapes
    b = itemsize
    return {"moe_dispatch": 2 * H * d * b + 8 * H + 4,
            "moe_combine": (H + 2 * T) * d * b + 12 * T * k,
            "moe_combine_bwd": (Th + 2 * H) * d * b + 16 * T * k,
            "moe_dispatch_bwd": (H + T) * d * b + 8 * T * k}


def moe_rows_routing(torch, dev):
    """The seeded routing's layout at ``MOE_ROWS_DIMS``: (slot, src, offs,
    shapes ((T, k, d), (H, Th)))."""
    from repro_torch.models.moe import held_layout
    T, k, d = MOE_ROWS_DIMS
    g = torch.Generator(device=dev).manual_seed(33)
    scores = torch.rand((T, 64), generator=g, device=dev)
    experts = torch.sort(scores, dim=-1, descending=True,
                         stable=True).indices[:, :k]
    slot, src, offs, _ = held_layout(experts, 0, 8)
    held = int(offs[-1])
    tokens = int((slot < T * k).any(-1).sum())
    return slot, src, offs, ((T, k, d), (held, tokens))


def moe_rows_calls(torch, dev, shp):
    """(kernel call, plain call, tolerances, {entry point: its kernel
    call}) for K8 at ``shp`` (``moe_rows_routing``'s): the four entry
    points in a row on bf16 rows from a seed, the buffers' rows past the
    held ones NaN.  Both calls return (x_buf's held rows, out, d_buf's
    held rows, dw, dx): bitwise, dw within 1e-5 of its largest sum of
    |g| |y|."""
    from repro_torch.kernels import moe_rows as K8
    slot, src, offs, shapes = moe_rows_routing(torch, dev)
    require(shapes == shp, f"moe_rows: the routing gives {shapes}, not {shp}")
    (T, k, d), (H, _) = shp
    g = torch.Generator(device=dev).manual_seed(34)

    def rows(n):
        return torch.randn((n, d), generator=g, device=dev).to(
            torch.bfloat16)
    x, shared, dy = rows(T), rows(T), rows(T)
    y_buf, d_xbuf = rows(T * k), rows(T * k)
    y_buf[H:] = float("nan")
    d_xbuf[H:] = float("nan")
    w = torch.rand((T, k), generator=g, device=dev) + 0.1
    entries = {"moe_dispatch": lambda: K8.dispatch_cuda(x, src, offs),
               "moe_combine": lambda: K8.combine_cuda(y_buf, w, slot,
                                                      shared),
               "moe_combine_bwd": lambda: K8.combine_bwd_cuda(dy, y_buf, w,
                                                              slot),
               "moe_dispatch_bwd": lambda: K8.dispatch_bwd_cuda(d_xbuf,
                                                                slot)}

    def kern():
        x_buf = entries["moe_dispatch"]()
        out = entries["moe_combine"]()
        d_buf, dw = entries["moe_combine_bwd"]()
        return x_buf[:H], out, d_buf[:H], dw, entries["moe_dispatch_bwd"]()

    def plain():
        d_buf, dw = K8.combine_bwd_ref(dy, y_buf, w, slot)
        return (K8.dispatch_ref(x, src, offs)[:H],
                K8.combine_ref(y_buf, w, slot, shared), d_buf[:H], dw,
                K8.dispatch_bwd_ref(d_xbuf, slot))
    mag = float(K8.combine_bwd_ref(dy.abs(), y_buf.abs(), w, slot)[1].max())
    tols = [(0.0, 0.0)] * 3 + [(1e-5 * mag, 0.0), (0.0, 0.0)]
    return kern, plain, tols, entries


def moe_rows_entries(torch, dev, shp, prof_ok):
    """{entry point: {ms, device_ms, bound_ms}} of K8 at ``shp``, each
    timed alone."""
    from repro_torch.roofline import HBM_BW
    *_, entries = moe_rows_calls(torch, dev, shp)
    nbytes = moe_rows_bytes(shp)
    out = {name: {"ms": time_ms(torch, fn),
                  "device_ms": device_ms(torch, fn) if prof_ok else None,
                  "bound_ms": nbytes[name] / HBM_BW * 1e3}
           for name, fn in entries.items()}
    log(f"moe_rows at {shp}, each entry point alone: " + "; ".join(
        f"{k} {v['ms']:.4f} ms (device {v['device_ms']}, bound "
        f"{v['bound_ms']:.4f})" for k, v in out.items()))
    return out


def timing_case(torch, dev, name, shp):
    """(kernel call, plain call, library call or None, tolerance, bytes
    per element) for one kernel at shapes ``shp``.  For attention the
    library call (bf16 tensor cores, bf16 probabilities) is held to the
    plain version at the sweep's 3e-2 only.  A backward kernel's calls
    return a tuple of gradients, and its tolerance is one (atol, rtol) a
    gradient."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.persample_gradnorm import (
        persample_gradnorm_cuda_batched)
    from repro_torch.kernels.rglru_scan import rglru_cuda
    from repro_torch.kernels.rwkv_scan import wkv_cuda
    from repro_torch.kernels.wemd_swap import wemd_add_cuda, wemd_swap_cuda
    if name == "attention_bwd":    # at the model's dtype, bf16
        from repro_torch.kernels.flash_attention import (
            flash_attention_bwd_cuda)
        B, H, S, hd, KV, T, hdv, kw = attn_dims(shp)
        q, k, v = attn_inputs(torch, B, H, KV, S, T, hd, torch.bfloat16, 96,
                              dev, hdv)
        do = attn_inputs(torch, B, H, KV, S, T, hdv, torch.bfloat16, 97,
                         dev)[0]
        # the library yardstick: SDPA's backward alone (its forward is run
        # once, outside the timed call), over the key heads repeated to
        # the query heads
        leaves = [x.detach().requires_grad_(True) for x in
                  (q, *(y.repeat_interleave(H // KV, dim=1) for y in (k, v)))]
        with torch.enable_grad():
            out = F.scaled_dot_product_attention(
                *leaves, attn_mask=window_mask(torch, S, T, kw["causal"],
                                               kw["window"], dev))
        return (lambda: flash_attention_bwd_cuda(q, k, v, do, **kw),
                lambda: ref.attention_bwd_ref(q, k, v, do, **kw),
                lambda: torch.autograd.grad(out, leaves, do,
                                            retain_graph=True),
                [BF16_ATTN_TOL] * 3, 2)
    if name == "wkv_bwd":
        # from the forward's chunk states, as the train step calls it; held
        # to the plain version within WKV_BWD_ERR_MULT f32 roundings of each
        # gradient's largest entry (phase 2 holds it to f64)
        from repro_torch.kernels.rwkv_scan import wkv_bwd_cuda, wkv_cuda
        (B, T, H, hd), = shp
        r, k, v, w, u, s0, dy, ds = wkv_bwd_inputs(torch, B, T, H, hd, 99,
                                                   dev)
        chunks = wkv_cuda(r, k, v, w, u, s0, save_chunks=True)[2]
        want = ref.wkv_bwd_ref(r, k, v, w, u, s0, dy, ds)
        tols = [(WKV_BWD_ERR_MULT * 2.0 ** -23 * float(x.abs().max()), 0.0)
                for x in want]
        return (lambda: wkv_bwd_cuda(r, k, v, w, u, chunks, dy, ds),
                lambda: ref.wkv_bwd_ref(r, k, v, w, u, s0, dy, ds), None,
                tols, 4)
    if name == "head_split":       # bitwise its plain version
        from repro_torch.kernels.head_split import head_split_cuda, split3_ref
        (M, N), = shp
        g = torch.Generator(device=dev).manual_seed(95)
        d = torch.randn((M, N), generator=g, device=dev) / (M * N)
        return (lambda: head_split_cuda(d), lambda: split3_ref(d), None,
                (0.0, 0.0), 4)
    if name == "moe_rows":         # bitwise its plain version but dw
        kern, plain, tols, _ = moe_rows_calls(torch, dev, shp)
        return kern, plain, None, tols, 2
    if name == "rglru_bwd":
        from repro_torch.kernels.rglru_scan import rglru_bwd_cuda
        (B, T, D), = shp
        a, b, h0 = rglru_inputs(torch, B, T, D, 98, dev)
        h, _ = ref.rglru_ref(a, b, h0)
        dh, dT = (torch.randn_like(x) for x in (h, h0))
        args = (a, h, h0, dh, dT)
        da_tol = 1e-5 * max(1.0, float(h.abs().max()))
        return (lambda: rglru_bwd_cuda(*args),
                lambda: ref.rglru_bwd_ref(*args), None,
                [(da_tol, 1e-5), (1e-5, 1e-5), (1e-5, 1e-5)], 4)
    if name == "attention":        # at the model's dtype, bf16
        B, H, S, hd, KV, T, hdv, kw = attn_dims(shp)
        q, k, v = attn_inputs(torch, B, H, KV, S, T, hd, torch.bfloat16, 92,
                              dev, hdv)
        kx, vx = (x.repeat_interleave(H // KV, dim=1) for x in (k, v))
        mask = window_mask(torch, S, T, kw["causal"], kw["window"], dev)
        return (lambda: flash_attention_cuda(q, k, v, **kw),
                lambda: ref.attention_ref(q, k, v, **kw),
                lambda: F.scaled_dot_product_attention(q, kx, vx,
                                                       attn_mask=mask),
                BF16_ATTN_TOL, 2)
    if name == "wkv":
        (B, T, H, hd), = shp
        args = wkv_inputs(torch, B, T, H, hd, 93, dev)
        return (lambda: wkv_cuda(*args)[0], lambda: ref.wkv_ref(*args)[0],
                None, (2e-3, 1e-3), 4)
    if name == "rglru":
        (B, T, D), = shp
        args = rglru_inputs(torch, B, T, D, 94, dev)
        return (lambda: rglru_cuda(*args)[0], lambda: ref.rglru_ref(*args)[0],
                None, (1e-5, 1e-5), 4)
    if name == "persample_gradnorm":
        (V, B, d), (_, _, C) = shp
        args = psg_inputs(torch, V, B, d, C, 90, dev)
        require(args[2].dtype == torch.int64, "the round's labels are int64")
        return (lambda: persample_gradnorm_cuda_batched(*args)[0],
                lambda: ref.persample_gradnorm_ref(*args)[0], None,
                (SIGMA_ATOL, SIGMA_RTOL), 4)
    (B, V, C), = shp
    args = wemd_inputs(torch, B, V, C, max(1, min(5, V)), 91, dev)
    if name == "wemd_add":
        kern, plain = wemd_add_cuda, ref.wemd_add_ref
        x, y = cdist_add(torch, *args)
    else:
        kern, plain = wemd_swap_cuda, ref.wemd_swap_ref
        x, y = cdist_swap(torch, *args)
    return (lambda: kern(*args), lambda: plain(*args),
            lambda: torch.cdist(x, y, p=1), (1e-5, 1e-5), 4)


def wemd_path(torch, dev, name, shp):
    """The call as the scheduler makes it: ``ops.wemd_*`` on f64 inputs at
    shapes ``shp``, held bitwise to the kernel's call on the f32-cast
    inputs.  Returns the call."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.wemd_swap import wemd_add_cuda, wemd_swap_cuda
    (B, V, C), = shp
    a64 = wemd_inputs(torch, B, V, C, max(1, min(5, V)), 91, dev,
                      torch.float64)
    a32 = [a.float() for a in a64]
    op, kern = ((ops.wemd_add, wemd_add_cuda) if name == "wemd_add"
                else (ops.wemd_swap, wemd_swap_cuda))
    got, want = op(*a64), kern(*a32)
    torch.cuda.synchronize()
    require(torch.equal(got, want), f"{name}: ops on f64 inputs is not the "
            f"kernel on the f32-cast inputs at {shp}")
    return lambda: op(*a64)


def psg_path(torch, dev, shp, prof_ok):
    """The call as the round makes it: ``ops.persample_gradnorm`` on f32
    features and logits and int64 labels at shapes ``shp``, bitwise equal
    to the kernel's call and, where the profiler works, running no device
    op but the kernel (no cast kernel in front of it).  Returns the
    call."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.kernels.persample_gradnorm import (
        persample_gradnorm_cuda_batched)
    (V, B, d), (_, _, C) = shp
    args = psg_inputs(torch, V, B, d, C, 90, dev)
    got, want = ops.persample_gradnorm(*args), \
        persample_gradnorm_cuda_batched(*args)
    torch.cuda.synchronize()
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            f"persample_gradnorm: ops is not the kernel's call at {shp}")
    if prof_ok:
        # late in a long run a trace can lose a batch of two dozen device
        # records or so, every other trace (at every K3 shape): the trace
        # takes PSG_CALLS calls, more than such a batch, and one that
        # still records no device op proves nothing and is taken again,
        # PSG_TRACES times in all; any op a trace does record but the
        # kernel fails the check
        for attempt in range(1, PSG_TRACES + 1):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(PSG_CALLS):
                    ops.persample_gradnorm(*args)
                torch.cuda.synchronize()
            ran = {e.key: e.count for e in prof.key_averages()
                   if e.self_device_time_total > 0}
            log(f"persample_gradnorm at {shp}: trace {attempt} recorded "
                f"{sum(ran.values())} device ops over {PSG_CALLS} calls")
            if ran:
                break
        require(ran and all("psg_kernel" in k for k in ran),
                f"persample_gradnorm: the round's call ran {ran}, not the "
                f"kernel alone")
    return lambda: ops.persample_gradnorm(*args)


def attention_f32_check(torch, dev, shp):
    """The attention kernel on f32 inputs at the path's shape against its
    plain version; returns the max abs error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    B, H, S, hd, KV, T, hdv, kw = attn_dims(shp)
    q, k, v = attn_inputs(torch, B, H, KV, S, T, hd, torch.float32, 95, dev,
                          hdv)
    got = flash_attention_cuda(q, k, v, **kw)
    want = ref.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs()
    require(bool((err <= F32_ATTN_TOL[0]
                  + F32_ATTN_TOL[1] * want.abs()).all()),
            f"attention f32: max abs err {float(err.max()):.3g} over "
            f"tolerance at {shp}")
    return float(err.max())


def head_products(torch, dev):
    """The head's three products at ``HEAD_CHUNK`` (forward, dx, dW), as
    the f32 product on the CUDA cores and as the route on the bf16 tensor
    cores (dx and dW from the split's three terms; the split is timed in
    its own row): K7's library yardstick, ms a call by CUDA events, and
    the TFLOP/s of each (2 M K N an operand pass, three for the
    route's backward)."""
    from repro_torch.kernels import head_split as HS
    M, K, N = HEAD_CHUNK
    g = torch.Generator(device=dev).manual_seed(96)
    x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn((K, N), generator=g, device=dev)
         / K ** 0.5).to(torch.bfloat16)
    d = torch.randn((M, N), generator=g, device=dev) / (M * N)
    xf, wf = x.float(), w.float()
    terms = HS.head_split_cuda(d)
    calls = {"f32": {"forward": lambda: xf @ wf, "dx": lambda: d @ wf.t(),
                     "dw": lambda: xf.t() @ d},
             "route": {"forward": lambda: HS.logits(x, w),
                       "dx": lambda: HS.grad_x(terms, w),
                       "dw": lambda: HS.grad_w(x, terms)}}
    out = {route: {k: time_ms(torch, fn) for k, fn in fns.items()}
           for route, fns in calls.items()}

    def tflops(route, k, ms):
        passes = 3 if route == "route" and k != "forward" else 1
        return passes * 2 * M * K * N / ms / 1e9
    log(f"head products at {HEAD_CHUNK}: " + "; ".join(
        f"{route} " + ", ".join(
            f"{k} {ms:.3f} ms ({tflops(route, k, ms):.0f} TFLOP/s)"
            for k, ms in t.items()) for route, t in out.items()))
    del x, w, d, xf, wf, terms
    return out


def phase_timing(torch, dev, cases, prof_ok):
    """One row a case (row name, kernel name, shapes, launches): the
    kernel timed at the shapes beside its plain version, library call
    and bound, held to its plain version there."""
    rows = []
    for row_name, name, shp, n_launches in cases:
        kern, plain, library, tol, itemsize = timing_case(
            torch, dev, name, shp)
        got, want = kern(), plain()
        multi = isinstance(got, tuple)
        got, want = (got, want) if multi else ((got,), (want,))
        tols = tol if multi else [tol]
        torch.cuda.synchronize()
        err = rel = 0.0
        for g, w, (atol, rtol) in zip(got, want, tols):
            g, w = g.float(), w.float()
            e = (g - w).abs()
            err = max(err, float(e.max()))
            rel = max(rel, float((g - w).norm() / w.norm()))
            require(bool((e <= atol + rtol * w.abs()).all()),
                    f"{name}: max abs err {float(e.max()):.3g} over "
                    f"tolerance at {shp}")
        if library is not None:
            lib_out = library()
            lib_out = lib_out if multi else (lib_out,)
            for g, w, (atol, rtol) in zip(lib_out, want, tols):
                lib_tol = ((3e-2, 3e-2) if name.startswith("attention")
                           else (atol, rtol))
                g, w = g.float(), w.float()
                if name == "attention_bwd":
                    # SDPA's gradients of the repeated key heads, summed
                    # over each group; ten bf16 gradients summed stray past
                    # an elementwise 3e-2 near zero, so the check is 3e-2
                    # in relative L2
                    g = g.reshape(w.shape[0], w.shape[1], -1,
                                  *w.shape[2:]).sum(2)
                    ok = float((g - w).norm() / w.norm()) <= lib_tol[1]
                else:
                    ok = bool(torch.allclose(g.reshape(w.shape), w,
                                             atol=lib_tol[0],
                                             rtol=lib_tol[1]))
                require(ok, f"{name}: the library yardstick computes "
                        f"another function")
        if name == "attention":
            log(f"attention at {shp}: bf16 max abs err {err:.3g} (atol "
                f"{atol} + rtol {rtol}), rel L2 {rel:.3g}; f32 max abs err "
                f"{attention_f32_check(torch, dev, shp):.3g} (atol "
                f"{F32_ATTN_TOL[0]} + rtol {F32_ATTN_TOL[1]})")
        ms = time_ms(torch, kern)
        clock_power = smi("clocks.sm,power.draw")
        plain_ms = time_ms(torch, plain)
        lib_ms = time_ms(torch, library) if library else None
        b_ms, b_by = bound(name, shp, itemsize)
        route, src = SOURCES[name]
        kernels = device_kernels(torch, kern) if prof_ok else None
        for _ in range(2):      # a trace late in the run may hold no records
            if prof_ok and not kernels:
                kernels = device_kernels(torch, kern)
        if name == "attention_bwd" and prof_ok:
            kernels = attention_bwd_trace(torch, kern, kernels)
        row = {"name": row_name, "route": route, "source": src,
               "replaces": TPU_KERNELS[name],
               "launches": int(n_launches), "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": lib_ms,
               "device_ms": (device_ms(torch, kern, kernels)
                             if kernels else None),
               "plain_device_ms": (device_ms(torch, plain)
                                   if prof_ok else None),
               "sm_clock_power_after": clock_power,
               "shape": [list(s) for s in shp]}
        if name in ("wemd_add", "wemd_swap"):
            row["path_ms"] = time_ms(torch, wemd_path(torch, dev, name, shp))
        if name == "persample_gradnorm":
            row["path_ms"] = time_ms(torch, psg_path(torch, dev, shp,
                                                     prof_ok))
        if name == "head_split":
            row["products_ms"] = head_products(torch, dev)
        if name == "moe_rows":
            row["entries"] = moe_rows_entries(torch, dev, shp, prof_ok)
        if name == "attention_bwd":
            # the GQA sum's part counts, and the time of each launch
            row["parts_ms"] = attention_bwd_parts(torch, dev, shp)
            row["device_kernels"] = kernels
            log(f"attention_bwd at {shp}: ms a call by parts of the GQA "
                f"sum {row['parts_ms']}; [device ms a launch, launches a "
                f"call] {kernels}")
        t = row["device_ms"] or ms
        row["bound_share"] = b_ms / t
        if name == "attention":
            # the rate over the visible pairs (2 (hd + hdv) FLOPs each),
            # from the device time (else ms)
            B, H, S, hd, _, T, hdv, kw = attn_dims(shp)
            flops = 2 * (hd + hdv) * B * H * visible_pairs(
                S, T, kw["causal"], kw["window"])
            row["tflops"] = flops / t / 1e9
            log(f"attention bf16 at {shp}: {row['tflops']:.1f} TFLOP/s over "
                f"the visible pairs; library {lib_ms:.4f} ms")
        log(f"{row_name} at {shp}: {100 * row['bound_share']:.1f} % of the "
            f"bound "
            f"({b_ms:.6f} ms over {t:.6f} ms)")
        rows.append(row)
    log("kernels: " + "; ".join(
        f"{r['name']} median {r['ms']:.4f} ms per call"
        + (f" (path {r['path_ms']:.4f} ms)" if "path_ms" in r else "")
        + f", device "
        f"{r['device_ms']} ms, at {r['shape']} (plain {r['plain_ms']:.4f}"
        f" ms, library {r['library_ms']} ms, bound {r['bound_ms']:.6f} ms, "
        f"max abs err {r['max_abs_err']:.3g}; SM clock, power just after: "
        f"{r['sm_clock_power_after']})" for r in rows))
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout)
    dev = torch.device("cuda")
    card = smi()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t_all = time.perf_counter()
    for name, fn in (("build", phase_build),
                     ("kernel checks", phase_kernel_checks),
                     ("scheduler parity", phase_scheduler)):
        t0 = time.perf_counter()
        fn(torch, dev)
        log(f"[{name}] done in {time.perf_counter() - t0:.2f} s")
    prof_ok = profiler_works(torch)
    t0 = time.perf_counter()
    world = fl_world()
    log(f"main path data: {len(world[1])} train / {len(world[2])} test "
        f"images 32x32x3, 64 devices ({time.perf_counter() - t0:.2f} s)")
    launches, shapes, single_ms = phase_main_path(torch, dev, prof_ok, world)
    log(f"[main path] done in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    mc_launches, mc_shapes = phase_multicell(torch, dev, prof_ok, world,
                                             single_ms)
    log(f"[{MC_CELLS} cells] done in {time.perf_counter() - t0:.2f} s")
    del world
    t0 = time.perf_counter()
    r_launches, r_shapes, rc_launches, rc_shapes = phase_resnet(torch, dev,
                                                                prof_ok)
    log(f"[resnet] done in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    lm_launches, lm_shapes = phase_lm(torch, dev, prof_ok)
    launches.update(lm_launches)
    shapes.update(lm_shapes)
    log(f"[LM serving] done in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    zoo_launches = phase_lm_zoo(torch, dev, prof_ok)
    log(f"[LM zoo] done in {time.perf_counter() - t0:.2f} s; attention "
        f"launched {zoo_launches} times over its prefills")
    t0 = time.perf_counter()
    tr_launches, tr_shapes = phase_lm_train(torch, dev, prof_ok)
    log(f"[LM training] done in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    zoo_train = phase_lm_zoo_train(torch, dev, prof_ok)
    log(f"[LM zoo training] done in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    sharded = phase_sharded(torch, dev)
    log(f"[sharded] done in {time.perf_counter() - t0:.2f} s; launches "
        f"{sharded}")
    t0 = time.perf_counter()
    mla_launches, moe_launches = phase_mla(torch, dev)
    log(f"[latent attention] done in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    cases = [(name, name, shapes[name], launches[name])
             for name in TPU_KERNELS
             if name not in TRAIN_KERNELS + MLA_KERNELS]
    # the training phase: the backward kernels at the train step's shapes,
    # the head's split at the benchmark cell's head chunk
    tr_shapes["head_split"] = (HEAD_CHUNK[::2],)
    cases += [(name, name, tr_shapes[name], tr_launches[name])
              for name in TRAIN_KERNELS]
    cases += [(f"{name}@C{MC_CELLS}", name, mc_shapes[name],
               mc_launches[name]) for name in FL_KERNELS]
    # the ResNet phase: K1/K2 over 100 classes, K3 at d = 512 (one cell,
    # and the engine's cells in one launch)
    cases += [(f"{name}@C100", name, r_shapes[name], r_launches[name])
              for name in ("wemd_add", "wemd_swap")]
    cases += [("persample_gradnorm@R", "persample_gradnorm",
               r_shapes["persample_gradnorm"],
               r_launches["persample_gradnorm"]),
              (f"persample_gradnorm@Rx{RESNET_CELLS}", "persample_gradnorm",
               rc_shapes["persample_gradnorm"],
               rc_launches["persample_gradnorm"])]
    # the LM zoo phase: attention at its models' shapes
    cases += zoo_timing_cases()
    # the zoo's training: K4-bwd at qwen2-7b's group 7, qwen3-moe's group
    # 16 and llama-vision's cross layers
    cases += [zoo_bwd_timing_case(arch, kind, zoo_train[arch])
              for arch, kind in (("qwen2-7b", "global"),
                                 ("qwen3-moe-235b-a22b", "global"),
                                 ("llama-3.2-vision-11b", "cross"))]
    # moonlight-16b-a3b's step: K4 and K4-bwd at the (192, 128) pair
    cases += [(f"{name}@moonlight-16b-a3b", name, MLA_SHAPE, n)
              for name, n in mla_launches.items()]
    # and the held MoE's dispatch and combine, K8's four entry points
    cases.append(("moe_rows@moonlight-16b-a3b", "moe_rows",
                  moe_rows_routing(torch, dev)[3],
                  sum(moe_launches.values())))
    rows = phase_timing(torch, dev, cases, prof_ok)
    log(f"[timing] done in {time.perf_counter() - t0:.2f} s; "
        f"total {time.perf_counter() - t_all:.2f} s")
    print(json.dumps({"kernels": rows}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

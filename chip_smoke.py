#!/usr/bin/env python3
"""Drive the PyTorch port's RAGCache main path once on one CUDA card.

    python3 chip_smoke.py          # from the repository root

Phases, each fatal on failure:
  1. device  — require CUDA, print the card's name and power limit, TF32 off;
  2. build   — compile every CUDA kernel from src/repro_torch/kernels/csrc
               (one nvcc each, in parallel) and print ptxas's registers and
               spills for each kernel;
  3. parity  — each kernel against its plain PyTorch version (and the dense
               oracle) at the main path's shapes, at decode rows of ~3,400
               keys and at small edge cases in f32 and bf16, the body
               (tensor or CUDA cores) serving each dtype, and bit for bit:
               rows of a 2048-row prefill equal to the same rows recomputed
               as a later chunk, for the paged and the prefix kernel, and a
               decode row equal alone and in its batch, with its
               neighbours' pages changed, and with its table narrowed or
               widened by empty entries;
  4. times   — CUDA-event medians of kernel, plain version and a PyTorch
               library yardstick, beside the card's least possible time
               (decode at the main shape and at the long rows);
  5. serve   — the main path at full Qwen2-0.5B width (seeded random bf16
               weights): 32 requests through ContinuousRuntime, counting
               kernel launches;
  6. rows    — row-invariance probe: row 0 of every row-wise op of the
               paged steps in calls of 1 .. 8192 rows, with and without the
               fixed-slab helper (layers.ROW_SLAB, for the products
               layers.slabbed names), and the main serve's tokens/s and
               TTFT p50 without and with it;
  7. check   — the first 8 requests again on a fresh runtime through the
               plain versions, compared under first-token-logit tolerance;
               then unchunked vs 128-token prefill chunks through the
               kernels, which must give bit-identical first-token logits
               and identical tokens;
  8. cag     — --mode cag: the 200-doc corpus preloaded into an auto-sized
               disk tier through the dense prefill (the prefix kernel,
               24 launches a doc), then 8 requests with zero retrieval
               stages, against the main serve's;
  9. dense   — --attn dense on 8 requests, against the main serve's;
 10. seq     — the port's serve.main --check-tokens tol:0.15 on 8
               requests: continuous vs the sequential RAGServer;
 11. chunk   — --reuse chunk (16 boundary tokens): 16 requests twice on one
               runtime, the second pass with each request's doc order
               reversed, so docs are reused exactly and relocated; results
               flagged exact against the sequential engine on the same
               doc order, the relocated ones' first-token L-inf; the first
               4 requests' two passes through the kernels against the
               plain versions; then serve.main --reuse chunk with a
               recompute budget past every doc, --check-tokens tol:0.15 on
               8 requests;
 12. fleet   — serve.main --replicas 2 --routing affinity --check-tokens
               tol:0.15 on 16 requests (two runtimes, two pools, one set of
               weights on the card), and the same 16 requests through one
               replica: identical token streams and first-token L-inf;
 13. door    — serve.main --frontdoor --tenants 4 --replicas 2 --autoscale
               with a disk tier sized for the corpus and decode batch 4,
               --check-tokens tol:0.15 on the admitted misses of 32
               requests;
 14. profile — torch.profiler over 8 more requests: device time by kernel,
               and the decode kernels' (split + merge) share of it;
 15. paper   — the paper's evaluation models at full published width and
               a cut depth (PAPER_LAYERS: Mistral-7B 4 layers, LLaMA2-7B
               2), Mistral-7B then LLaMA2-7B, one set of weights on the
               card at a time (Qwen's deleted first): (a) the main serve of
               phase 5 with pools of 3,904 blocks of Mistral KV and 1,024
               of LLaMA2 KV (7.5 GiB at 32 layers), hit rates and tier hits
               side by side; the row probe and the chunk split, bit for
               bit; the serve without the slab helper; (c) 4 requests
               through the plain versions; (e) Mistral only: 4 requests of
               ~4,450 tokens, past its 4096-token window, against the
               sequential engine and the plain versions; the profile of
               phase 14; (b) continuous against sequential on 8 requests.
               Their eps comes from the measured logits (paper_eps);
 16. moe     — Mixtral-8x7B at full width and 4 of its 32 layers: the
               main serve, row probe, chunk split, kernels vs plain and
               continuous vs sequential with the routes pinned,
               moe_capacity vs moe_dense, the profile;
 phi       — Phi-3.5-MoE at full width and 4 of its 32 layers through
               phase 16's chain but its capacity and tensor-parallel runs
               (the row probe at its widths: q/o, k/v, the router, expert
               0's gate/up (K 4096, N 6400) and down (K 6400));
 17. vlm     — InternVL2-1B at full width and 12 of its 24 layers: the
               main serve, chunk split,
               plain versions, a prefill with 256 patch embeddings;
 18. xlstm   — xLSTM-1.3B at full width and 8 of its 48 blocks (a depth
               cut, RECURRENT_LAYERS) through the sequential
               RAGServer, its state snapshots in the knowledge tree: 8
               requests cold, then 4 whose docs are cached (one through
               the pinned host tier) bit-identical to their cold results,
               every snapshot's checksum unchanged across the hits; billed
               and real tier bytes side by side; mlstm_chunkwise against
               mlstm_scan on one full-width layer; the row probe of the
               mLSTM block's products (w_up, wq/wk/wv, w_down);
 19. hymba   — Hymba-1.5B at full width and 4 of its 32 layers the same
               way, its attention on the prefix kernel (R 5, windows of
               1024), and the 8 cold requests through
               the plain
               versions, and in f32 through both (HYBRID_ARCH's eps
               rule); its profile is scripts/profile_recurrent.py;
 20. audio   — MusicGen-large's model steps at full width: a codebook
               prefill and 8 decode steps, kernel vs plain, and the prefill
               as 256 cached + 256 new tokens against the whole;
 21-23. large — Gemma3-12B (hd 256, its 1024 window binding on the main
               rows), Gemma2-27B (softcaps 50 and 30, a 4096 window the
               main rows do not reach) and Yi-34B (R 7) at full published
               width and a quarter of their depth (LARGE_LAYERS), one set
               of weights on the card at a time: the main serve of 16
               requests, the row probe, the chunk split bit for bit, 2
               requests through the plain versions, the profile
               (Gemma3-12B only), and continuous against sequential on 8
               requests in process; eps is paper_eps scaled by
               sqrt(layers / 32) past 32 layers (large_eps);
 24. train   — run after phase 14, on Qwen2-0.5B's weights at full width
               and depth: training.train_lib.make_train_step for 20 AdamW
               steps of 8 x 1024 tokens of the synthetic stream (bf16
               weights, f32 moments), the loss falling and every loss,
               grad norm and param finite; tokens/s, ms a step and peak
               memory; the prefix kernel's launches in one step (the
               forward and the backward's recompute of each layer); one
               step's device time by kernel class (torch.profiler); one
               step through the kernels against one through the plain
               versions (loss and grad norm in bf16 at full width, every
               grad leaf in f32 at 2 layers); the prefix kernel timed at
               the training shape beside the plain backward;
 25. fault   — paper §6: the main trace's first 16 requests on a fresh
               runtime, hot nodes replicated to the host tier, a simulated
               device loss (core.fault_tolerance), every survivor's host
               KV hashed equal to its KV before the loss, then the same
               requests again: tokens and first-token logits bit for bit;
 26. hops    — paper §9: core.iterative.run_iterative plans 3 hops of 2
               docs over a runtime's controller, each hop's alpha the
               previous path's tokens; the three paths served one request
               a hop through a runtime that reuses each path's KV, tokens
               equal to a cold runtime's on each path.

 seqpar  — Yi-34B at full width and 4 of its 60 layers, one 8192-token
               prefill over a (1, 4) mesh of shards on the one card: the
               seq-par option (512-row query chunks dealt over the shards,
               each through the prefix kernel) bit for bit against the
               unsplit prefill on that mesh (logits and cache), and
               flat-gqa (K/V repeated to every head, the kernel at R 1)
               against the plain version on layer 0's q, k, v;
 train_mesh_families — one (2, 2) mesh train step of Hymba-1.5B (2
               layers), xLSTM-1.3B (8 blocks) and MusicGen-large (2
               layers) at full width against the one-device step on the
               same batch (phase 24b's tolerances), the replicas' params
               equal after it;
 recurrent_train — the scans' per-chunk recompute at full width over a
               batch of 2 x 4096 tokens: xLSTM-1.3B's slstm_scan and
               Hymba-1.5B's mamba_scan with 256-step chunks against one
               chunk (outputs bit for bit, grads within tolerance, the
               peak lower), then one train step of xLSTM-1.3B (8 blocks)
               and Hymba-1.5B (2 layers), each peak beside the dry run's
               one-device prediction;
 capacity_data2 — Mixtral-8x7B's first layer at full width with capacity
               dispatch: a (2, 1) mesh step whose 4096-token dispatch
               chunk straddles both data replicas, against the one-device
               step;
 mesh_decode — the reference's decode cache layout with every shard on
               the one card, a batch of 1: Qwen2-0.5B at full depth on a
               (2, 4) mesh and Gemma3-12B (4 layers) on (2, 16), the
               cache's 16,384 positions split over the 2 data replicas
               and hd over model; a 12,000-token prefill and 4 decode
               steps against the one-device steps in f32 and bf16, each
               step's ms and the peak memory printed; then xLSTM-1.3B (16
               blocks) and Hymba-1.5B (8 layers) on (2, 4) meshes, a
               1024-token prefill, their recurrent state split over model
               as the reference lays it out (each shard stepping its
               part), Hymba's K/V over 2048 positions;
 examples — examples/torch_quickstart.py, torch_rag_serving.py and
               torch_train_tiny.py run on the card, each in a process of
               its own: exit 0, their claim lines, the prefix kernel
               launched;
 dryrun_cal — the compile analysis against the card: phase 24's
               one-device step, phase 24b's mesh step and
               recurrent_train's steps dry-run on fake cards in processes
               started at the beginning (their prefix-kernel calls must
               equal the card's launches), the predicted peak of each
               one-device step beside the card's (their ratio printed),
               and qwen2-0.5b decode_32k on the
               (16, 16) production mesh through launch/dryrun.py, its
               record printed.

 tp      — run after phase 26 on Qwen2-0.5B's weights (tp 2) and inside
               phase 15 on Mistral-7B's (tp 2 and 4), every shard on the
               one card: the column-product probe (each shard's columns
               against a one-device mesh's of its column-slab group, and
               the plain slice for contrast), the per-shard decode and
               prefill dispatch against the whole heads at the model's
               head shape, then the serve of TP_MODELS' note
               (TP_REQUESTS), tp N bit for bit against tp 1 of group N,
               launches tp times its, ms a decode step and peak memory of
               each run, the default tp 1 (group 1) among them.

Phases 3-4 also hold and time each kernel at the paper models' head shapes
(hd 128; KV 8 and R 4, KV 32 and R 1; Mistral's window over rows past 4096
keys), at Gemma3-12B's (hd 256, KV 8 and R 2, its 1024 window and global),
Gemma2-27B's (KV 16 and R 2, softcap 50) and Yi-34B's (KV 8 and R 7), and
the prefix kernel at Hymba-1.5B's (R 5, hd 64, a window layer and a
global one) and MusicGen-large's (R 1, 32 heads, hd 64).  Every comparison of kernels against plain versions and of the
continuous runtime against the sequential engine records the reference's
top-2 logit margin at each stream's first differing token, and dies on a
flip where that margin exceeds the comparison's eps (check_flips).

The last stdout line is {"ok": true, "device": {...}}; the line before it is
the kernels' JSON record.  Without CUDA, or outside a checkout of the
repository, the script exits nonzero and prints no result.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
# kernel vs plain version on identical inputs: f32 outputs differ only by
# summation order; bf16 outputs, compared in f32, by at most one bf16 ulp
# of values below 4 (2**-6 ~ 1.6e-2 in [2, 4), where rows with few visible
# keys sit; until the tensor-core kernels carried P as hi + lo bf16 parts,
# P rounded to bf16 for P @ V moved such an output by up to ~8e-3 before
# its final rounding)
TOL_F32 = 1e-4
TOL_BF16 = 2e-2
# bf16 outputs row by row: the largest ||got - exact|| / ||exact|| of an
# output row, exact being the plain version run in f32 on the same inputs.
# Unlike the absolute bound it scales with each row, so it holds the long
# rows (|out| ~ 0.05 after ~1000 keys) as tightly as the short ones.  On
# the card the plain version's own bf16 rounding gives up to 2.7e-3, the
# tensor-core kernels 3.5e-3; 16 keys dropped or counted twice give 0.5-0.9
TOL_ROW_BF16 = 1e-2
# the hd-256 cases (Gemma3-12B's heads) are held tighter: bf16 within one
# bf16 ulp of outputs in [1, 2), f32 within 2e-6 (summation order over 256
# dims, outputs below ~4)
TOL_BF16_HD256 = 2.0 ** -7
TOL_F32_HD256 = 2e-6
# full-path cross-checks, bf16 through 24 layers: first-token logits of two
# runs that differ only in arithmetic order (kernel vs plain attention, or
# the GEMM shapes of another chunk split).  |logits| reach ~3, where a bf16
# ulp is 1.6e-2; the card measured 7.4e-2 between the kernel and the
# plain path with P in f32 for P @ V, 9.0e-2 with the tensor-core prefill
# kernels rounding P to bf16: 0.15 is 1.67 times that
LOGIT_EPS = 0.15
# the paper models (32 layers, d_model 4096, seeded random weights): an
# lm_head of N(0, 0.02) over unit-RMS input gives logits of spread 0.02 *
# sqrt(4096) ~ 1.28 and a maximum over 32,000 of ~5.3, where a bf16 ulp is
# 3.1e-2, twice Qwen's.  Their eps is LOGIT_EPS scaled by that ulp ratio,
# read off the main serve's measured max |first-token logit|: 0.30 for a
# maximum in [4, 8) (paper_eps).  The rule was fixed before the first card
# run of these models and is not tuned after one.
PAPER_EPS_RANGE = (4.0, 8.0)
# Gemma3-12B's sliding window (5 of every 6 layers)
GEMMA3_WINDOW = 1024
MAIN_ARGV = ["--docs", "200", "--doc-tokens", "512", "--top-k", "2",
             "--requests", "32", "--max-new-tokens", "8", "--max-batch", "8",
             "--max-prefill-bs", "4", "--gpu-cache-bytes", "805306368",
             "--device", "cuda"]
# the paper models, served after the Qwen phases; one GPU-tier budget for
# both at full depth: 7.5 GiB, a 3,904-block pool of Mistral-7B KV (0.125
# MiB a token) and 1,024 blocks of LLaMA2-7B KV (0.5 MiB), both below the
# runtime's 4096-block clip; both keep the parser's host-tier default, 512
# MiB
PAPER_MODELS = ("mistral-7b", "llama2-7b")
PAPER_GPU_BYTES = 8_053_063_680
PAPER_HOST_BYTES = 512 * 2**20
# phase 15 serves them at full width through their first PAPER_LAYERS
# layers (views of the weights of all 32), the GPU tier scaled with the
# depth so that each pool keeps its blocks: depth cuts that hold the
# script's wall under ~800 s once phases 21-23 run.  LLaMA2-7B first (it
# runs the kernels Mistral runs, at R 1), then Mistral-7B.  Nothing picks
# the depth at run time.
PAPER_LAYERS = {"mistral-7b": 4, "llama2-7b": 2}
# phase 15 (e): 4 requests whose two docs (of a 12-doc corpus, mean 2,400
# tokens) make sequences of 4,401-4,478 tokens, past Mistral-7B's
# 4096-token window, prefilled in 512-token chunks
WINDOW_ARGV = ["--docs", "12", "--doc-tokens", "2400", "--requests", "4",
               "--prefill-chunk", "512"]
# ... through the first WINDOW_LAYERS of the layers phase 15 serves, the
# pool keeping its 3,904 blocks (the whole window phase took 176-187 s at
# 32 layers, 79 s at 16, 21.8 s at 4)
# phase 16: Mixtral-8x7B (8 experts, top 2) at full published width and 4
# of its 32 identical layers: 11.9e9 B of bf16 weights (all 32 layers take
# 93.4e9 B, past one 80 GB card; 24 layers, 70.2e9 B, until the depth cut
# that made room for phases 21-23).  The depth is fixed here; nothing
# picks it at run time.
MOE_ARCH = "mixtral-8x7b"
MOE_LAYERS = 4
# its GPU tier: 4,032 blocks of its KV (4,096 B a token a layer), so that
# the pool (the tier's blocks + 64, clipped at 4096) holds every block the
# tree budgets
MOE_GPU_BYTES = 4032 * 16 * 4096 * MOE_LAYERS
# phase phi: Phi-3.5-MoE (16 experts of d_ff 6400, top 2) at full published
# width and 4 of its 32 layers (10.9e9 B of bf16 weights), through phase
# 16's chain with Mixtral's tier (the same KV a token a layer), without
# its capacity and tensor-parallel runs, which Mixtral shows on the card
PHI_ARCH = "phi3.5-moe-42b-a6.6b"
PHI_LAYERS = 4
# phase 16's capacity check: rows of one layer through moe_capacity and
# moe_dense.  Rows both of whose experts kept them must agree within
# CAPACITY_TOL x the largest |dense output| of those rows, four bf16 ulps
# at that value: dense rounds each expert's weighted term to bf16 and the
# sum after each add, capacity sums in f32 and rounds once, and the two
# run each expert's products as GEMMs of other shapes
CAPACITY_ROWS = 2048
CAPACITY_TOL = 2.0 ** -5
# phase 17: InternVL2-1B at full published width and 12 of its 24 layers
# (a depth cut for phases 21-23), its text backbone served on the main
# trace; its dense prefill also takes its 256 patch embeddings
VLM_ARCH = "internvl2-1b"
VLM_LAYERS = 12
# phases 18-19: the recurrent families at full published width (and, since
# the depth cuts below, half their depth), served by the sequential RAGServer on the first 8 requests of the main
# trace (Qwen's corpus), then 4 of them again with their docs cached.  The
# tiers are sized in billed bytes: 3,000 tokens on the GPU tier and 6,000
# on the host tier (the reference bills an xLSTM state node at 4 B a token
# whatever its real size, 706,560,672 B at full width and depth; Hymba's
# K/V at 40,960 B a token, its 3,317,760 B of SSM state unbilled, at full
# depth), so that the
# cold serve swaps state snapshots to the pinned host tier and a warm hit
# promotes one back
RECURRENT_REQUESTS = 8
WARM_REQUESTS = 4
TIER_TOKENS = (3000, 6000)
XLSTM_ARCH = "xlstm-1.3b"
# depth cuts that make room for phases 21-23, the compile analysis's
# phases and phi, recurrent_train and examples: xLSTM-1.3B through 8 of its
# 48 blocks (one period of 7 mLSTM blocks and an sLSTM block), Hymba-1.5B
# through 4 of its 32 layers (all windowed)
RECURRENT_LAYERS = {"xlstm-1.3b": 8, "hymba-1.5b": 4}
# Hymba's comparisons of two bf16 serves take eps = max(paper_eps, 2 x F),
# F the first-token L-inf of its plain-version serve in bf16 against the
# same serve in f32, measured in the same run: each bf16 serve may lie F
# from the f32 one.  On the card its bf16 rounding alone moves the
# first-token logits ~0.4, past paper_eps (0.30), while in f32 the kernels'
# serve matches the plain versions' within HYBRID_F32_TOL (f32 sums in
# other orders through 32 layers).  The rule was set after reading a card
# run.
HYBRID_ARCH = "hymba-1.5b"
HYBRID_F32_TOL = 1e-3
# phase 18's chunkwise-vs-recurrent check: one mLSTM layer at full width
# (4 heads of 1024) over this many tokens of f32 inputs; the outputs must
# agree within MLSTM_TOL x the largest |h| of the recurrent form (the CPU
# tests' rule: h is a quotient that reaches ~35 where its normaliser is
# small, and the two forms sum in other orders)
MLSTM_TOKENS = 1100
MLSTM_TOL = 1e-4
# phase 20: MusicGen-large's model steps at full width on codebook tokens
# (B, K, S): a prefill of 2 x 4 x 512, 8 decode steps, and the prefill as
# 256 cached + 256 new tokens
AUDIO_ARCH = "musicgen-large"
AUDIO_TOKENS = 512
AUDIO_STEPS = 8
# phases 21-23: the rest of the dense family at full published width and a
# quarter of their depth (LARGE_LAYERS: a depth cut that keeps the script
# inside its limit on slow hosts; at full depth their weights are 23.5e9 /
# 54.5e9 / 68.8e9 B), one set of weights on the card at a time, on the
# main trace's first 16 requests with the paper models' tiers (Yi-34B's
# 5 GiB); continuous against sequential runs in process, as Mixtral's
# does.  Gemma3-12B's 12 layers hold two global ones.
LARGE_DENSE = ("gemma3-12b", "gemma2-27b", "yi-34b")
LARGE_LAYERS = {"gemma3-12b": 12, "gemma2-27b": 12, "yi-34b": 15}
LARGE_REQUESTS = 16
LARGE_GPU_BYTES = {"yi-34b": 5 * 2**30}
# requests of each through the plain versions (phase_check)
LARGE_PLAIN = 2
# the one of them profiled: the hd-256 kernels' share of device time
LARGE_PROFILE = "gemma3-12b"
# card clock cycles (~1 ms) the card spins before each timed call
SPIN_CYCLES = 2_000_000
# rows per call in the row-invariance probe; 8192 is the largest prefill
# iteration of the main path (4 rows x a 2048-token bucket)
PROBE_ROWS = (1, 8, 64, 128, 512, 2048, 8192)
# phase 24 (train): Qwen2-0.5B at full width and depth, seeded bf16 weights
# (the main serve's) and f32 moments, TRAIN_STEPS AdamW steps of
# TRAIN_BATCH x TRAIN_SEQ tokens of the synthetic stream, the lr schedule
# launch/train.py gives a run of that length
TRAIN_STEPS = 20
TRAIN_BATCH, TRAIN_SEQ = 8, 1024
TRAIN_LR = 1e-3
# one step through the kernels against one through the plain versions, on
# the same batch and weights.  bf16 at full width: the loss (~11.9 at init,
# a mean over 8,192 tokens) within TRAIN_LOSS_TOL and the global grad norm
# within TRAIN_GNORM_RTOL of each other; f32 at TRAIN_F32_LAYERS layers:
# every grad leaf within TRAIN_F32_TOL * max|g_plain| + 1e-6 (set before
# the first card run of these phases)
TRAIN_LOSS_TOL = 1e-2
TRAIN_GNORM_RTOL = 5e-2
TRAIN_F32_LAYERS = 2
TRAIN_F32_TOL = 1e-3
# phase 24b (train tp): TRAIN_TP_STEPS steps of the same model and batches
# on a (data 2, model 2) mesh (launch/mesh.py::make_debug_mesh), every
# shard on the one card: Megatron row sums of wo/wd, the batch split over
# data, ZeRO-1 moments.  Each step's loss within TRAIN_LOSS_TOL and grad
# norm within TRAIN_GNORM_RTOL of the one-device step's from the same
# params and batches; at TRAIN_F32_LAYERS layers in f32, one step's loss
# and grad norm within TRAIN_TP_F32_RTOL (relative) of each other
TRAIN_TP_MESH = (2, 2)
TRAIN_TP_STEPS = 3
TRAIN_TP_F32_RTOL = 1e-4
# the profiler's spans over one train step
BWD_SPAN = "flash attention backward"
LOSS_SPAN = "chunked loss"
# phase 25 (fault): the main trace's first FAULT_REQUESTS requests on a
# fresh main-config runtime (host tier: the parser's 512 MiB), then hot
# nodes replicated to the host within FAULT_REPLICA_BYTES before the
# simulated device loss
FAULT_REQUESTS = 16
FAULT_REPLICA_BYTES = 64 * 2**20
# phase 26 (hops): HOPS hops of HOP_DOCS docs each (paper §9)
HOPS = 3
HOP_DOCS = 2
# phase tp: tensor-parallel serving with every shard on the one card
# (launch/mesh.py::make_serving_mesh(tp, devices=["cuda:0"] * tp)), which
# shows the per-shard path, not several cards.  Qwen2-0.5B at full width
# and depth at tp 2 (7 query heads and 1 KV head a shard, vocab shards of
# 75,968) on its main serve's weights; Mistral-7B at full width and phase
# 15's depth (PAPER_LAYERS: 4 of 32 layers, its weights already on the
# card) at tp 2 and 4.  A mesh's bits are fixed by its column-slab group
# G (launch/mesh.py; G = tp by default): tp N is held against tp 1 over a
# one-device mesh of group N, and the default tp 1 (group 1, no slabs) is
# served too.  Each run serves the main trace's first TP_REQUESTS
# requests with prefix reuse, demotes every cached node to the host tier
# through the pool's backend, and serves them again from there: tokens,
# tier hits, first-token logits, host copies and launch counts against
# tp 1's of the group.  The serves run on one constant clock (the
# runtime's clock otherwise advances by measured wall time, and tp N's
# slower iterations would batch differently); a decode step is timed after
# them on the real clock (TP_DECODE_REPS rounds of the runtimes' warm-up
# steps at max_batch rows, the runs taking turns).  TP_PROBE_ROWS: the rows of the
# column-product probe.
# Mixtral-8x7B (phase 16's MOE_LAYERS layers at full width, 8 experts) at
# tp 2 and 4: its expert stacks split along E (4 and 2 whole experts a
# shard), the router's 8 columns in slabs, the expert wd on the
# controller; the probe adds the router's columns and the batched expert
# products of moe_capacity in groups of E / G experts (TP_EXPERT_ROWS
# tokens a buffer's worth)
TP_MODELS = {"qwen2-0.5b": (2,), "mistral-7b": (2, 4),
             "mixtral-8x7b": (2, 4)}
TP_EXPERT_ROWS = (64, 512, 2048)
# depth cuts that make room for the later phases: the tp runs go through
# the first 6 of Qwen2-0.5B's 24 layers and the first 2 of the 4 that
# phases 15-16 serve of Mistral-7B and Mixtral-8x7B; Mistral-7B's window
# phase through the first 2 of phase 15's 4
TP_LAYERS = {"qwen2-0.5b": 6, "mistral-7b": 2, "mixtral-8x7b": 2}
WINDOW_LAYERS = 2
TP_REQUESTS = 16
TP_DECODE_REPS = 20
TP_PROBE_ROWS = (1, 8, 64, 512, 2048)
# the compile analysis (launch/dryrun.py) against the card: phase 24's
# one-device step and phase 24b's (2, 2) mesh step run on fake cards in
# processes of their own beside the card's phases, their prefix-kernel
# calls held to the card's launch counters; the predicted peak of the
# one-device step beside the card's (a ratio outside DRYRUN_PEAK_BAND is
# recorded, not fatal); one production case (DRYRUN_CASE) through the CLI
DRYRUN_CASE = ("qwen2-0.5b", "decode_32k")
DRYRUN_TIMEOUT = 600
DRYRUN_PEAK_BAND = (0.8, 1.25)
# phase seqpar: Yi-34B (56 / 8 heads) at full width, SEQPAR_LAYERS of its 60
# layers, one SEQPAR_TOKENS-token prefill over a (1, 4) mesh on the card
SEQPAR_ARCH = "yi-34b"
SEQPAR_LAYERS = 4
SEQPAR_TOKENS = 8192
# phase train_mesh_families: full width, these depths (xLSTM: one period
# of 7 mLSTM blocks and an sLSTM block), batch MESH_FAMILY_BATCH
MESH_FAMILIES = {"hymba-1.5b": 2, "xlstm-1.3b": 8, "musicgen-large": 2}
MESH_FAMILY_BATCH = (4, 256)
# phase capacity_data2: Mixtral-8x7B's 1 layer at full width, 2 rows of
# 2048 tokens: one 4096-token dispatch chunk over both data replicas
CAPACITY_BATCH = (2, 2048)
# phase mesh_decode: the reference's decode cache layout on a (data, model)
# mesh of shards on the one card, a batch of 1 (the sequence over data, hd
# over model): arch -> (mesh, layers; None: full depth); a prefill of
# MESH_DECODE_PREFILL tokens into a cache of MESH_DECODE_LEN positions (so
# both data slices hold keys), then MESH_DECODE_STEPS decode steps against
# the one-device step: f32 logits within MESH_DECODE_RTOL x max |logit|,
# bf16 first-step L-inf within paper_eps.  The recurrent families lay their
# state out as the reference does too (launch/sharding.py::state_layout:
# xLSTM's leaves and Hymba's ssm split over model, each shard stepping its
# part), at 16 / 8 layers and lengths of their own
# (MESH_DECODE_RECURRENT: the state has no sequence to split, and Hymba's
# per-token scan is launch-bound; Hymba's K/V still splits its positions
# over both data slices); their bf16 first step is held to phase 19's
# rule, max(paper_eps, 2 x the one-device bf16 step's L-inf from the f32
# one)
MESH_DECODE = {"qwen2-0.5b": ((2, 4), None), "gemma3-12b": ((2, 16), 4),
               "xlstm-1.3b": ((2, 4), 16), "hymba-1.5b": ((2, 4), 8)}
MESH_DECODE_LEN = 16384
MESH_DECODE_PREFILL = 12000
# arch -> (prefill tokens, cache positions)
MESH_DECODE_RECURRENT = {"xlstm-1.3b": (1024, 1024),
                         "hymba-1.5b": (1024, 2048)}
MESH_DECODE_STEPS = 4
MESH_DECODE_RTOL = 1e-4
# phase recurrent_train: the scans' per-chunk recompute (the reference's
# chunked_scan / jax.checkpoint(chunk_body)) at full width and batch
# RECURRENT_TRAIN_BATCH: slstm_scan and mamba_scan at xLSTM-1.3B's and
# Hymba-1.5B's shapes with chunk=256 against chunk=S (outputs and states bit
# for bit, each input grad within TRAIN_GNORM_RTOL x its max |g|, the peak
# lower), then one train step of each model at these depths (xLSTM: one
# period of 7 mLSTM blocks and an sLSTM block), its peak beside the dry
# run's one-device prediction (a ratio outside DRYRUN_PEAK_BAND recorded)
RECURRENT_TRAIN = {"xlstm-1.3b": 8, "hymba-1.5b": 2}
RECURRENT_TRAIN_BATCH = (2, 4096)
SCAN_CHUNK = 256
# phase examples: the port's twins of examples/*.py that run on the card,
# each in a process of its own, the three at once within EXAMPLE_TIMEOUT
# seconds, and the lines each must print
EXAMPLE_TIMEOUT = 300
EXAMPLES = {
    "quickstart": ([], ["cold plan: cached=0 tokens, to compute=56",
                        "warm plan: cached=48 tokens, to compute=8",
                        "cold-vs-warm logits bit-identical: True (exact "
                        "reuse)"]),
    "rag_serving": ([], ["identical answers with/without cache: 10/10"]),
    "train_tiny": (["--steps", "30"], []),
}
# where each kernel came from: (wrapper, source, TPU kernel it replaces)
KERNELS = (
    ("paged_decode_attention", "src/repro_torch/kernels/csrc/paged_decode.cu",
     "src/repro/kernels/paged_attention.py:142"),
    ("paged_prefill_attention",
     "src/repro_torch/kernels/csrc/paged_prefill.cu",
     "src/repro/kernels/paged_prefill.py:155"),
    ("prefix_flash_attention",
     "src/repro_torch/kernels/csrc/prefix_attention.cu",
     "src/repro/kernels/prefix_attention.py:140"),
)


def die(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# run-table inputs
# ---------------------------------------------------------------------------

def build_runs(seg_lens, page, free_pages):
    """Run tables for a sequence of segments, each starting in a fresh page
    (the runtime's contract): lists of page ids, counts and start positions."""
    tables, counts, starts = [], [], []
    pos = 0
    for n in seg_lens:
        for off in range(0, n, page):
            tables.append(int(free_pages.pop()))
            counts.append(min(page, n - off))
            starts.append(pos + off)
        pos += n
    return tables, counts, starts, pos


def pool(torch, L, n_pages, page, KV, hd, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (L, n_pages, page, KV, hd)
    k = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    v = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return k, v


def decode_case(torch, np, *, B, H, KV, hd, page, n_slots, rows, dtype,
                seed, L=2, layer=1, window=0, cap=0.0):
    """rows[b] is a list of segment lengths (empty = an all-empty row)."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + sum(-(-n // page) for segs in rows for n in segs) + 8
    free = list(rng.permutation(np.arange(1, n_pages)))    # 0 = scratch
    tables = np.zeros((B, n_slots), np.int32)
    counts = np.zeros((B, n_slots), np.int32)
    starts = np.zeros((B, n_slots), np.int32)
    qpos = np.zeros((B,), np.int32)
    for b, segs in enumerate(rows):
        t, c, s, total = build_runs(segs, page, free)
        assert len(t) <= n_slots, (len(t), n_slots)
        tables[b, :len(t)], counts[b, :len(t)], starts[b, :len(t)] = t, c, s
        qpos[b] = max(total - 1, 0)
    k, v = pool(torch, L, n_pages, page, KV, hd, dtype, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    q = torch.randn((B, H, hd), generator=gen, device="cuda").to(dtype)
    dev = lambda a: torch.from_numpy(a).cuda()
    return dict(q=q, k_pages=k, v_pages=v, tables=dev(tables),
                counts=dev(counts), starts=dev(starts), qpos=dev(qpos),
                layer=layer, window=window, logit_cap=cap)


def prefill_case(torch, np, *, B, H, KV, hd, page, n_slots, Sq, rows, dtype,
                 seed, L=2, layer=1, window=0, cap=0.0):
    """rows[b] = (cached prefix segment lengths, q_len); q_len == 0 is a
    padding row.  The chunk's own pages follow the prefix's."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + sum(-(-n // page) for pre, ql in rows
                      for n in list(pre) + [ql]) + 8
    free = list(rng.permutation(np.arange(1, n_pages)))
    tables = np.zeros((B, n_slots), np.int32)
    counts = np.zeros((B, n_slots), np.int32)
    starts = np.zeros((B, n_slots), np.int32)
    q_start = np.zeros((B,), np.int32)
    q_len = np.zeros((B,), np.int32)
    for b, (pre, ql) in enumerate(rows):
        if ql == 0:
            continue
        t, c, s, total = build_runs(list(pre) + [ql], page, free)
        assert len(t) <= n_slots, (len(t), n_slots)
        tables[b, :len(t)], counts[b, :len(t)], starts[b, :len(t)] = t, c, s
        q_start[b], q_len[b] = total - ql, ql
    k, v = pool(torch, L, n_pages, page, KV, hd, dtype, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    # the model's (B, Sq, H, hd) activations viewed as (B, H, Sq, hd): the
    # strides the kernel reads in place
    q = torch.randn((B, Sq, H, hd), generator=gen, device="cuda").to(dtype)
    q = q.transpose(1, 2)
    dev = lambda a: torch.from_numpy(a).cuda()
    return dict(q=q, k_pages=k, v_pages=v, tables=dev(tables),
                counts=dev(counts), starts=dev(starts), q_start=dev(q_start),
                q_len=dev(q_len), layer=layer, window=window, logit_cap=cap)


def call(fn, case):
    c = dict(case)
    layer, window = c.pop("layer"), c.pop("window")
    cap = c.pop("logit_cap")
    args = list(c.values())
    return fn(*args, layer, window, logit_cap=cap)


# ---------------------------------------------------------------------------
# bounds, times
# ---------------------------------------------------------------------------

def visible_pairs(np, case, decode: bool):
    """(query, key) pairs the masks leave visible, summed over rows, and the
    live key tokens the kernel must read."""
    counts = case["counts"].cpu().numpy()
    starts = case["starts"].cpu().numpy()
    page = case["k_pages"].shape[2]
    window = case["window"]
    slot = np.arange(page)
    live = slot[None, None] < counts[..., None]            # (B, n, page)
    kpos = starts[..., None] + slot[None, None]
    pairs = 0
    if decode:
        qpos = case["qpos"].cpu().numpy()
        vis = live.copy()
        if window:
            vis &= kpos > qpos[:, None, None] - window
        pairs = int(vis.sum())
        return pairs, pairs
    q_start = case["q_start"].cpu().numpy()
    q_len = case["q_len"].cpu().numpy()
    keys = 0
    for b in range(counts.shape[0]):
        if q_len[b] == 0:
            continue
        kp = kpos[b][live[b]]
        qp = q_start[b] + np.arange(q_len[b])
        vis = kp[None] <= qp[:, None]
        if window:
            vis &= kp[None] > qp[:, None] - window
        pairs += int(vis.sum())
        seen = kp <= qp[-1]
        if window:
            seen &= kp > qp[0] - window
        keys += int(seen.sum())
    return pairs, keys


def bound_ms(np, case, decode: bool):
    """Least time for the work: each input read once, each output written
    once, over the memory rate; the QK and PV products over the bf16 peak."""
    q = case["q"]
    H, hd = q.shape[1], q.shape[-1]
    KV = case["k_pages"].shape[3]
    es = q.element_size()
    pairs, keys = visible_pairs(np, case, decode)
    n_int = sum(case[n].numel() for n in ("tables", "counts", "starts"))
    byts = 2 * q.numel() * es + 2 * keys * KV * hd * es + 4 * n_int
    flops = 4 * pairs * (H // KV) * KV * hd
    t_bytes, t_ops = byts / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, *, reps=21, warm=3, flush=None):
    """Median of `reps` CUDA-event timings of fn(), L2 flushed before each
    (the serving pool is far larger than the 50 MB L2).  The card spins
    for SPIN_CYCLES between the flush and the first event, so the host has
    enqueued fn()'s launches before the card reaches them: the events time
    the card's work, not the Python that launches it."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def sdpa_inputs(torch, case, decode: bool):
    """Contiguous K/V and a boolean mask for one
    F.scaled_dot_product_attention call computing the same function (the
    gather is done here, outside the timed call)."""
    q = case["q"]
    B = q.shape[0]
    page = case["k_pages"].shape[2]
    counts = case["counts"].cpu().numpy()
    nb = int((counts > 0).sum(axis=1).max())
    tables = case["tables"][:, :nb].long()
    kl = case["k_pages"][case["layer"]][tables]            # (B, nb, page, KV, hd)
    vl = case["v_pages"][case["layer"]][tables]
    S = nb * page
    k = kl.reshape(B, S, *kl.shape[3:]).transpose(1, 2).contiguous()
    v = vl.reshape(B, S, *vl.shape[3:]).transpose(1, 2).contiguous()
    slot = torch.arange(page, device="cuda")
    cnt = case["counts"][:, :nb]
    live = (slot[None, None] < cnt[..., None]).reshape(B, S)
    kpos = (case["starts"][:, :nb, None] + slot[None, None]).reshape(B, S)
    window = case["window"]
    if decode:
        mask = live
        if window:
            mask = mask & (kpos > case["qpos"][:, None] - window)
        mask = mask[:, None, None, :]
        qq = q[:, :, None]
    else:
        Sq = q.shape[2]
        qpos = case["q_start"][:, None] + torch.arange(Sq, device="cuda")
        mask = live[:, None] & (kpos[:, None] <= qpos[..., None])
        if window:
            mask &= kpos[:, None] > qpos[..., None] - window
        mask = mask[:, None]
        qq = q
    return qq, k, v, mask


def library_fn(torch, case, decode: bool):
    import torch.nn.functional as F
    qq, k, v, mask = sdpa_inputs(torch, case, decode)
    try:
        F.scaled_dot_product_attention(qq, k, v, attn_mask=mask,
                                       enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(
            qq, k, v, attn_mask=mask, enable_gqa=True)
    except (TypeError, RuntimeError):   # no GQA support: repeat the heads
        R = qq.shape[1] // k.shape[1]
        kr = k.repeat_interleave(R, dim=1)
        vr = v.repeat_interleave(R, dim=1)
        return lambda: F.scaled_dot_product_attention(qq, kr, vr,
                                                      attn_mask=mask)


def prefix_case(torch, *, B, H, KV, hd, P, Sq, dtype, seed, window=0,
                cap=0.0):
    """q/k/v of a dense prefill in the model's (B, S, heads, hd) layout,
    viewed as (B, heads, S, hd) — the strides the kernel reads in place."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((B, Sq, H, hd), generator=gen, device="cuda")
    k = torch.randn((B, P + Sq, KV, hd), generator=gen, device="cuda")
    v = torch.randn((B, P + Sq, KV, hd), generator=gen, device="cuda")
    return dict(q=q.to(dtype).transpose(1, 2), k=k.to(dtype).transpose(1, 2),
                v=v.to(dtype).transpose(1, 2), prefix_len=P, window=window,
                logit_cap=cap)


def call_prefix(fn, case):
    c = dict(case)
    return fn(c.pop("q"), c.pop("k"), c.pop("v"), **c)


def prefix_bound_ms(case):
    """Least time for one dense prefill attention: q, k, v read once and the
    output written once over the memory rate; the QK and PV products of the
    visible pairs over the bf16 peak."""
    q, k = case["q"], case["k"]
    B, H, Sq, hd = q.shape
    KV, P, w = k.shape[1], case["prefix_len"], case["window"]
    es = q.element_size()
    byts = (2 * q.numel() + 2 * k.numel()) * es
    pairs = 0
    for i in range(Sq):
        qpos = P + i
        pairs += qpos + 1 if w <= 0 else min(qpos + 1, w)
    flops = 4 * B * H * hd * pairs
    t_bytes, t_ops = byts / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def prefix_library_fn(torch, case):
    """One F.scaled_dot_product_attention call computing the same function:
    contiguous inputs and an explicit prefix-causal mask (its is_causal is
    top-left aligned, wrong once a prefix is cached)."""
    import torch.nn.functional as F
    q, k, v = (case[n].contiguous() for n in ("q", "k", "v"))
    Sq, Skv, P = q.shape[2], k.shape[2], case["prefix_len"]
    qpos = P + torch.arange(Sq, device="cuda")[:, None]
    kpos = torch.arange(Skv, device="cuda")[None]
    mask = kpos <= qpos
    if case["window"] > 0:
        mask &= kpos > qpos - case["window"]
    try:
        F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                       enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)
    except (TypeError, RuntimeError):   # no GQA support: repeat the heads
        R = q.shape[1] // k.shape[1]
        kr = k.repeat_interleave(R, dim=1)
        vr = v.repeat_interleave(R, dim=1)
        return lambda: F.scaled_dot_product_attention(q, kr, vr,
                                                      attn_mask=mask)


def reset_counts():
    """Zero every kernel's launch count and every plain version's call
    count."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import paged_prefill as PP
    from repro_torch.kernels import prefix_attention as PX
    PA.paged_decode_attention.launches = 0
    PP.paged_prefill_attention.launches = 0
    PX.prefix_flash_attention.launches = 0
    PA.paged_decode_torch.calls = 0
    PP.paged_prefill_torch.calls = 0
    PX.prefix_attention_torch.calls = 0


def read_counts():
    """(launches by kernel, plain-version calls in all)."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import paged_prefill as PP
    from repro_torch.kernels import prefix_attention as PX
    launches = {"paged_decode_attention": PA.paged_decode_attention.launches,
                "paged_prefill_attention":
                    PP.paged_prefill_attention.launches,
                "prefix_flash_attention": PX.prefix_flash_attention.launches}
    plain = (PA.paged_decode_torch.calls + PP.paged_prefill_torch.calls
             + PX.prefix_attention_torch.calls)
    return launches, plain


def check_leak(rt):
    rt.tree.check_invariants()
    live = rt.store.pool.n_blocks - rt.store.pool.free_blocks
    tree_blocks = sum(len(n.payload_gpu.blocks) for n in rt.tree.nodes()
                      if n.in_gpu and n.payload_gpu is not None)
    if live != tree_blocks + 1:
        die(f"pool leak: {live} live blocks, tree {tree_blocks} + scratch")


def compare_logits(np, name, got, want, eps=LOGIT_EPS,
                   against="the main serve"):
    """First-token logits and tokens of two serves of the same requests:
    die unless the logits agree within eps (tokens then agree under the
    tol: semantics)."""
    by_id = {r.req_id: r for r in want}
    worst, same, bad = 0.0, 0, []
    for a in got:
        b = by_id[a.req_id]
        linf = float(np.max(np.abs(a.first_logits.astype(np.float64)
                                   - b.first_logits.astype(np.float64))))
        worst = max(worst, linf)
        same += list(a.tokens) == list(b.tokens)
        if linf > eps:
            bad.append((a.req_id, list(a.tokens), list(b.tokens), linf))
    print(f"[{name}] against {against}: first-token logits max L-inf "
          f"{worst:.4e} (eps {eps:g}), tokens identical for {same}/"
          f"{len(got)}", flush=True)
    if bad:
        die(f"{name} and the main serve disagree: {bad}")
    return worst


def paper_eps(max_abs: float) -> float:
    """LOGIT_EPS scaled by the bf16 ulp at the largest first-token logit,
    against Qwen's |logits| in [2, 4): 0.30 for a maximum in [4, 8)."""
    import numpy as np
    return LOGIT_EPS * 2.0 ** (int(np.floor(np.log2(max_abs))) - 1)


def first_margin(logits):
    """(argmax, largest minus second largest) of a (V,) array."""
    import numpy as np
    top = np.partition(np.asarray(logits, np.float64), -2)[-2:]
    return int(np.argmax(logits)), float(top[1] - top[0])


@contextlib.contextmanager
def recording_margins():
    """While open, every result the continuous runtime or the sequential
    engine returns carries ``margins``: token index -> (greedy token, top-2
    logit margin of the logits it was picked from), index 0 from its
    first-token logits.  Yields a list that collects the (continuous,
    sequential) pairs serve.main's --check-tokens compares."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serving.engine import RAGServer
    from repro_torch.serving.runtime import ContinuousRuntime
    orig = dict(paged=M.paged_decode_step, dense=M.decode_step,
                decode=ContinuousRuntime._decode,
                serve=ContinuousRuntime.serve, one=RAGServer._serve_one,
                check=serve.token_mismatches)
    state = {"logits": None, "seq": None}
    pairs = []

    def top2(logits):
        v, i = torch.topk(logits.float(), 2, dim=-1)
        v, i = v.cpu().numpy(), i.cpu().numpy()
        return [(int(a[0]), float(b[0] - b[1])) for a, b in zip(i, v)]

    @functools.wraps(orig["paged"])
    def paged_step(*a, **k):
        state["logits"] = orig["paged"](*a, **k)
        return state["logits"]

    @functools.wraps(orig["dense"])
    def dense_step(*a, **k):
        state["logits"] = out = orig["dense"](*a, **k)
        if state["seq"] is not None:
            state["seq"].append(top2(out[:, -1])[0])
        return out

    def decode(self, batch):
        toks = orig["decode"](self, batch)
        if batch:
            pend = self.__dict__.setdefault("_margins", {})
            for st, m in zip(batch, top2(state["logits"][:len(batch), -1])):
                pend.setdefault(st.r.req_id, {})[len(st.tokens)] = m
        return toks

    def serve_rt(self, requests, max_new_tokens=4):
        res = orig["serve"](self, requests, max_new_tokens)
        pend = self.__dict__.pop("_margins", {})
        for r in res:
            r.margins = dict(pend.get(r.req_id, {}))
            r.margins[0] = first_margin(r.first_logits)
        return res

    def serve_one(self, r, docs, max_new_tokens):
        state["seq"] = []
        try:
            res = orig["one"](self, r, docs, max_new_tokens)
        finally:
            steps, state["seq"] = state["seq"], None
        res.margins = {i + 1: m for i, m in enumerate(steps)}
        res.margins[0] = first_margin(res.first_logits)
        return res

    def check(p, mode, eps):
        p = list(p)
        pairs.extend(p)
        return orig["check"](p, mode, eps)

    M.paged_decode_step, M.decode_step = paged_step, dense_step
    ContinuousRuntime._decode, ContinuousRuntime.serve = decode, serve_rt
    RAGServer._serve_one, serve.token_mismatches = serve_one, check
    try:
        yield pairs
    finally:
        M.paged_decode_step, M.decode_step = orig["paged"], orig["dense"]
        ContinuousRuntime._decode = orig["decode"]
        ContinuousRuntime.serve = orig["serve"]
        RAGServer._serve_one = orig["one"]
        serve.token_mismatches = orig["check"]


@contextlib.contextmanager
def pinned_routes(routes, replay):
    """While open, each MoE routing (layers.route, once a layer a step) is
    keyed by (layer, absolute position, token id) of each of its rows,
    from the model step that runs it.  Without ``replay`` the experts each
    row chose are recorded into ``routes``; with it, a row whose key is in
    ``routes`` takes the recorded experts, gated by the softmax of its own
    logits at them.  Top-k routing is discontinuous: two runs that differ
    only in arithmetic order choose other experts for rows whose k-th and
    next logits lie within a rounding of each other, and the difference
    grows through the layers.  Pinned, the reference computes the same
    function as the run it is held against.  Yields counts: rows keyed,
    rows pinned, and pinned rows whose own choice differed."""
    import inspect
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    orig = dict(route=L.route, paged_prefill_step=M.paged_prefill_step,
                paged_decode_step=M.paged_decode_step, prefill=M.prefill,
                decode_step=M.decode_step)
    state = {"keys": None, "layer": 0}
    counts = {"rows": 0, "pinned": 0, "changed": 0}

    def positions(name, args):
        """(B, S) absolute positions of a step's rows, -1 for padding."""
        if name == "paged_prefill_step":
            Sq = args["tokens"].shape[1]
            ar = torch.arange(Sq, device=args["tokens"].device)
            pos = args["q_start"][:, None] + ar
            return torch.where(ar < args["q_len"][:, None], pos, -1)
        if name == "prefill":
            S = args["tokens"].shape[1]
            ar = torch.arange(S, device=args["tokens"].device)
            return (args["prefix_len"] + ar)[None].expand(
                args["tokens"].shape)
        return (args["pos"] - 1)[:, None]                # the decode steps

    def keyed(name):
        fn, sig = orig[name], inspect.signature(orig[name])

        @functools.wraps(fn)
        def step(*a, **kw):
            args = sig.bind(*a, **kw)
            args.apply_defaults()
            args = args.arguments
            if args.get("patch_embeds") is not None:
                return fn(*a, **kw)
            pos = positions(name, args)
            state["keys"] = list(zip(pos.flatten().tolist(),
                                     args["tokens"].flatten().tolist()))
            state["layer"] = 0
            try:
                return fn(*a, **kw)
            finally:
                state["keys"] = None
        return step

    def route(x, router_w, k):
        keys, li = state["keys"], state["layer"]
        state["layer"] += 1
        gates, topi = orig["route"](x, router_w, k)
        if keys is None:
            return gates, topi
        own = topi.reshape(-1, k).tolist()
        if not replay:
            for key, t in zip(keys, own):
                if key[0] >= 0:
                    # a key that recurs with other experts (rows of two
                    # requests with one token at one position) stays
                    # unpinned
                    prev = routes.setdefault((li,) + key, sorted(t))
                    if prev is not None and prev != sorted(t):
                        routes[(li,) + key] = None
            return gates, topi
        want = [routes.get((li,) + key) if key[0] >= 0 else None
                for key in keys]
        counts["rows"] += sum(key[0] >= 0 for key in keys)
        counts["pinned"] += sum(w is not None for w in want)
        changed = sum(w is not None and w != sorted(t)
                      for w, t in zip(want, own))
        counts["changed"] += changed
        if not changed:
            return gates, topi
        pin = torch.tensor([w if w is not None else t
                            for w, t in zip(want, own)],
                           device=topi.device).reshape(topi.shape)
        logits = L.proj(x, router_w).float()
        return torch.softmax(logits.gather(-1, pin), dim=-1), pin

    L.route = route
    for name in ("paged_prefill_step", "paged_decode_step", "prefill",
                 "decode_step"):
        setattr(M, name, keyed(name))
    try:
        yield counts
    finally:
        L.route = orig["route"]
        for name in ("paged_prefill_step", "paged_decode_step", "prefill",
                     "decode_step"):
            setattr(M, name, orig[name])


# (comparison, pairs compared, streams that flipped, smallest reference
# margin at a flip, eps) of every check_flips call
FLIPS = []


def check_flips(name, pairs, eps):
    """Each (got, ref) pair's first differing token, if any, and the
    reference's top-2 logit margin there (ref.margins, from
    recording_margins): die on a flip whose margin exceeds eps, which the
    tol: rule makes a fault."""
    margins = []
    for a, b in pairs:
        i = next((j for j, (x, y) in enumerate(zip(a.tokens, b.tokens))
                  if x != y), None)
        if i is None:
            continue
        m = getattr(b, "margins", {}).get(i)
        if m is None or (m[0] != b.tokens[i] and m[1] != 0.0):
            die(f"[{name}] request {b.req_id}: no recorded margin for the "
                f"reference's token {i} ({m})")
        margins.append((m[1], a.req_id, i))
    low = min(margins)[0] if margins else None
    FLIPS.append((name, len(pairs), len(margins), low, eps))
    print(f"[{name}] flips: {len(margins)} of {len(pairs)} streams; "
          f"smallest reference top-2 margin at a flip "
          f"{'none' if low is None else f'{low:.4e}'} (eps {eps:g}); "
          f"(margin, request, token) {sorted(margins)[:6]}", flush=True)
    bad = [f for f in margins if f[0] > eps]
    if bad:
        die(f"[{name}] a token flipped where the reference's top-2 margin "
            f"exceeds eps {eps}: {bad}")


def serve_stats(results, rt, wall):
    n_tok = sum(len(r.tokens) for r in results)
    ttft = rt.metrics.summary()["ttft"]["p50"]
    return n_tok / wall, 1e3 * ttft


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def card_line(torch):
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"{torch.cuda.get_device_name(0)}, power limit not read ({e})"


def phase_device(torch):
    if not torch.cuda.is_available():
        die("torch.cuda.is_available() is false: this script needs a card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        die(f"no src/repro_torch beside {Path(__file__).name}: run it from "
            f"a checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    smi = card_line(torch)
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    return smi


def demangle(nvcc: str, names):
    """`name<args>` of each kernel, as the toolkit's cu++filt (beside nvcc)
    prints it without its parameters, or the names as they are if it does
    not run."""
    try:
        out = subprocess.run(
            [str(Path(nvcc).with_name("cu++filt")), *names],
            capture_output=True, text=True, timeout=60,
            check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return list(names)
    if len(out) != len(names):
        return list(names)
    short = []
    for name in out:
        name = name.removeprefix("void ").replace("<unnamed>::", "")
        head, sep, _ = name.partition(">(")
        short.append(head + ">" if sep else name.split("(")[0])
    return short


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"[build] {', '.join(_build.SOURCES)} for sm_90a in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    # ptxas -v: "Compiling entry function '<name>'", then its stack/spill
    # line and its registers/shared-memory line
    entries = []
    for src, text in reports.items():
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entries.append((src, line.split("'")[1], []))
            elif entries and ("spill" in line or "registers" in line):
                entries[-1][2].append(line.split(":", 1)[-1].strip())
    names = demangle(_build.nvcc_path(), [e[1] for e in entries])
    for (src, _, parts), name in zip(entries, names):
        print(f"[build] ptxas {src}.cu {name}: {'; '.join(parts)}",
              flush=True)


def as_f32(case):
    """The case with its floating tensors (bf16 q, k, v) as f32: the plain
    version then gives the unrounded result of the same inputs."""
    return {key: val.float() if getattr(val, "is_floating_point",
                                        lambda: False)() else val
            for key, val in case.items()}


def row_err(torch, got, exact):
    """The largest ||got - exact|| / ||exact|| over output rows (the last
    dim); a row whose exact result is 0 must be exactly 0."""
    g = got.float().reshape(-1, got.shape[-1])
    e = exact.float().reshape(-1, exact.shape[-1])
    diff, norm = (g - e).norm(dim=-1), e.norm(dim=-1)
    zero = norm == 0
    if bool((diff[zero] > 0).any()):
        return float("inf")
    return (diff[~zero] / norm[~zero]).max().item() if bool(
        (~zero).any()) else 0.0


def check(torch, name, got, want, tol, zero_rows=None, exact=None):
    """got against want within tol (max abs); with `exact` (the plain
    version in f32 on the same inputs) also each row within TOL_ROW_BF16,
    printed beside the plain version's own bf16 rounding of its rows."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    finite = bool(torch.isfinite(got.float()).all())
    zeros_ok = True
    if zero_rows is not None:
        zeros_ok = bool((got.float()[zero_rows] == 0).all())
    rel, note = 0.0, ""
    if exact is not None:
        rel = row_err(torch, got, exact)
        note = (f", row err {rel:.3e} (tol {TOL_ROW_BF16:g}; the plain "
                f"version's own {row_err(torch, want, exact):.3e})")
    print(f"[parity] {name}: max_abs_err {err:.3e} (tol {tol:g}){note}"
          f"{'' if zero_rows is None else ', padding exact 0: ' + str(zeros_ok)}",
          flush=True)
    if not (err <= tol and rel <= TOL_ROW_BF16 and finite and zeros_ok):
        die(f"parity {name}: err {err} row err {rel} finite {finite} zeros "
            f"{zeros_ok}")
    return err


def main_cases(torch, np):
    rng = np.random.default_rng(7)

    def doc():
        return int(np.clip(rng.lognormal(np.log(512), 0.4), 16, 1400))

    dec = decode_case(torch, np, B=8, H=14, KV=2, hd=64, page=16,
                      n_slots=220, dtype=torch.bfloat16, seed=11,
                      rows=[[doc(), doc(), 8 + int(rng.integers(1, 9))]
                            for _ in range(8)])
    # the main path's longest decode rows at 220 slots: two 1400-token docs
    # and a question, ~3,400 live keys (214 of the 220 entries)
    dec_long = decode_case(torch, np, B=8, H=14, KV=2, hd=64, page=16,
                           n_slots=220, dtype=torch.bfloat16, seed=14,
                           rows=[[1400 - 3 * i, 1390, 600 + i]
                                 for i in range(8)])
    pre = {
        2048: prefill_case(torch, np, B=4, H=14, KV=2, hd=64, page=16,
                           n_slots=220, Sq=2048, dtype=torch.bfloat16,
                           seed=12, rows=[([], 2048), ([700], 1500),
                                          ([900, 800], 300), ([], 0)]),
        64: prefill_case(torch, np, B=4, H=14, KV=2, hd=64, page=16,
                         n_slots=220, Sq=64, dtype=torch.bfloat16, seed=13,
                         rows=[([800, 1000], 64), ([1200], 40), ([], 24),
                               ([], 0)]),
    }
    return dec, dec_long, pre


def paper_cases(torch, np):
    """The kernels at the paper models' head shapes, bf16: hd 128, 32 query
    heads over Mistral-7B's 8 KV heads (R 4) and LLaMA2-7B's 32 (R 1);
    decode and paged prefill with the main case's rows, the prefix kernel
    at prefix 0; for Mistral also decode rows of ~4,800 keys and a 512-row
    chunk after ~4,500 cached keys, both under its 4096-token window; the
    prefix kernel also at Hymba-1.5B's heads (R 5, hd 64; a 1024 window
    and a global layer over 1,200 rows) and MusicGen-large's (R 1, 32
    heads, hd 64).  Returns {key: (kind, case)}, kind in decode / prefill
    / prefix."""
    cases = {}
    for model, KV in (("mistral", 8), ("llama2", 32)):
        rng = np.random.default_rng(7)

        def doc():
            return int(np.clip(rng.lognormal(np.log(512), 0.4), 16, 1400))

        cases[f"{model}_decode"] = ("decode", decode_case(
            torch, np, B=8, H=32, KV=KV, hd=128, page=16, n_slots=220,
            dtype=torch.bfloat16, seed=11,
            rows=[[doc(), doc(), 8 + int(rng.integers(1, 9))]
                  for _ in range(8)]))
        cases[f"{model}_prefill"] = ("prefill", prefill_case(
            torch, np, B=4, H=32, KV=KV, hd=128, page=16, n_slots=220,
            Sq=2048, dtype=torch.bfloat16, seed=12,
            rows=[([], 2048), ([700], 1500), ([900, 800], 300), ([], 0)]))
        cases[f"{model}_prefix"] = ("prefix", prefix_case(
            torch, B=1, H=32, KV=KV, hd=128, P=0, Sq=2048,
            dtype=torch.bfloat16, seed=20))
    # Hymba-1.5B's attention heads (25 over 5 KV heads, R 5, hd 64): a
    # window layer (1024) and a global one, rows past the window; and
    # MusicGen-large's (MHA, 32 heads, hd 64) codebook prefill
    for key, window in (("hymba_prefix_window", 1024),
                        ("hymba_prefix_global", 0)):
        cases[key] = ("prefix", prefix_case(
            torch, B=1, H=25, KV=5, hd=64, P=0, Sq=1200,
            dtype=torch.bfloat16, seed=21, window=window))
    cases["musicgen_prefix"] = ("prefix", prefix_case(
        torch, B=2, H=32, KV=32, hd=64, P=0, Sq=AUDIO_TOKENS,
        dtype=torch.bfloat16, seed=22))
    # Gemma3-12B's heads (16 over 8 KV heads, R 2, hd 256) on the main
    # rows, under its 1024 window (which rows of ~1,100 keys pass) and on
    # its global layers
    for tag, window in (("window", GEMMA3_WINDOW), ("global", 0)):
        rng = np.random.default_rng(7)
        cases[f"gemma3_decode_{tag}"] = ("decode", decode_case(
            torch, np, B=8, H=16, KV=8, hd=256, page=16, n_slots=220,
            dtype=torch.bfloat16, seed=11, window=window,
            rows=[[doc(), doc(), 8 + int(rng.integers(1, 9))]
                  for _ in range(8)]))
        cases[f"gemma3_prefill_{tag}"] = ("prefill", prefill_case(
            torch, np, B=4, H=16, KV=8, hd=256, page=16, n_slots=220,
            Sq=2048, dtype=torch.bfloat16, seed=12, window=window,
            rows=[([], 2048), ([700], 1500), ([900, 800], 300), ([], 0)]))
        cases[f"gemma3_prefix_{tag}"] = ("prefix", prefix_case(
            torch, B=1, H=16, KV=8, hd=256, P=0, Sq=2048,
            dtype=torch.bfloat16, seed=20, window=window))
    # Gemma2-27B's (32 over 16 KV heads, R 2, softcap 50) and Yi-34B's (56
    # over 8, R 7) at hd 128 on the main rows
    for model, H, KV, cap in (("gemma2", 32, 16, 50.0), ("yi", 56, 8, 0.0)):
        rng = np.random.default_rng(7)
        cases[f"{model}_decode"] = ("decode", decode_case(
            torch, np, B=8, H=H, KV=KV, hd=128, page=16, n_slots=220,
            dtype=torch.bfloat16, seed=11, cap=cap,
            rows=[[doc(), doc(), 8 + int(rng.integers(1, 9))]
                  for _ in range(8)]))
        cases[f"{model}_prefill"] = ("prefill", prefill_case(
            torch, np, B=4, H=H, KV=KV, hd=128, page=16, n_slots=220,
            Sq=2048, dtype=torch.bfloat16, seed=12, cap=cap,
            rows=[([], 2048), ([700], 1500), ([900, 800], 300), ([], 0)]))
        cases[f"{model}_prefix"] = ("prefix", prefix_case(
            torch, B=1, H=H, KV=KV, hd=128, P=0, Sq=2048,
            dtype=torch.bfloat16, seed=20, cap=cap))
    cases["mistral_decode_window"] = ("decode", decode_case(
        torch, np, B=8, H=32, KV=8, hd=128, page=16, n_slots=330,
        dtype=torch.bfloat16, seed=15, window=4096,
        rows=[[2400 - 7 * i, 2390, 8 + i] for i in range(8)]))
    cases["mistral_prefill_window"] = ("prefill", prefill_case(
        torch, np, B=4, H=32, KV=8, hd=128, page=16, n_slots=330, Sq=512,
        dtype=torch.bfloat16, seed=16, window=4096,
        rows=[([2400, 2100], 512), ([2300, 2200], 400), ([4500], 512),
              ([], 0)]))
    return cases


def case_tag(kind, case):
    q = case["q"]
    k = case["k_pages"] if kind != "prefix" else case["k"]
    KV = k.shape[3] if kind != "prefix" else k.shape[1]
    tag = f"q {tuple(q.shape)} KV={KV} win={case['window']}"
    if kind != "prefix":
        tag += f" slots={case['tables'].shape[1]}"
    return tag


def parity_paper(torch, np, cases, errs):
    """Each kernel against its plain version at the paper models' shapes,
    bf16 (with the row check against the plain version in f32) and f32;
    the decode split each dtype takes; then the bit checks: decode rows
    alone vs in their batch, prefill rows as a later chunk."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import paged_prefill as PP
    from repro_torch.kernels import prefix_attention as PX
    fns = {"decode": (PA.paged_decode_attention, PA.paged_decode_torch, call),
           "prefill": (PP.paged_prefill_attention, PP.paged_prefill_torch,
                       call),
           "prefix": (PX.prefix_flash_attention, PX.prefix_attention_torch,
                      call_prefix)}
    for key, (kind, case) in cases.items():
        kern, plain, run = fns[kind]
        pad = None
        if kind == "prefill":
            Sq = case["q"].shape[2]
            pad = torch.arange(Sq, device="cuda")[None] >= \
                case["q_len"][:, None]
            pad = pad[:, None, :].expand(-1, case["q"].shape[1], -1)
        exact = run(plain, as_f32(case))
        wide = case["q"].shape[-1] == 256
        errs[key] = check(torch, f"{key} bf16 {case_tag(kind, case)}",
                          run(kern, case), run(plain, case),
                          TOL_BF16_HD256 if wide else TOL_BF16,
                          zero_rows=pad, exact=exact)
        check(torch, f"{key} f32", run(kern, as_f32(case)), exact,
              TOL_F32_HD256 if wide else TOL_F32, zero_rows=pad)
        del exact
        if kind == "decode":
            n_slots = case["tables"].shape[1]
            hd = case["q"].shape[-1]
            # 128 keys (8 pages of 16) a split, 64 for rows above 256 bytes
            keys = {dt: 64 if dt.itemsize * hd > 256 else 128
                    for dt in (torch.bfloat16, torch.float32)}
            splits = {dt: PA.decode_splits(n_slots, 16, hd, dt)
                      for dt in keys}
            want = {dt: -(-n_slots // (n // 16)) for dt, n in keys.items()}
            print(f"[parity] {key}: decode splits over {n_slots} entries: "
                  f"bf16 {splits[torch.bfloat16]} "
                  f"({keys[torch.bfloat16]} keys), f32 "
                  f"{splits[torch.float32]} ({keys[torch.float32]} keys)",
                  flush=True)
            if splits != want:
                die(f"{key}: decode splits {splits}, want {want}")
            decode_bits(torch, case)
        elif kind == "prefill" and case["q"].shape[2] == 2048:
            chunk_split_paged(torch, case)
        elif kind == "prefix" and case["q"].shape[2] > 1048:
            prefix_split(torch, case, 1048)


def phase_parity(torch, np):
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import paged_prefill as PP
    from repro_torch.kernels import ref
    dec, dec_long, pre = main_cases(torch, np)
    errs = {}
    errs["decode"] = check(torch, "decode main B=8 H=14 KV=2 hd=64 slots=220",
                           call(PA.paged_decode_attention, dec),
                           call(PA.paged_decode_torch, dec), TOL_BF16,
                           exact=call(PA.paged_decode_torch, as_f32(dec)))
    errs["decode_long"] = check(
        torch, "decode long rows (~3,400 keys) B=8 H=14 KV=2 hd=64 "
        "slots=220", call(PA.paged_decode_attention, dec_long),
        call(PA.paged_decode_torch, dec_long), TOL_BF16,
        exact=call(PA.paged_decode_torch, as_f32(dec_long)))
    decode_bits(torch, dec)
    parity_single_layer(torch)
    for sq, case in pre.items():
        pad = torch.arange(sq, device="cuda")[None] >= case["q_len"][:, None]
        pad = pad[:, None, :].expand(-1, case["q"].shape[1], -1)
        errs[f"prefill{sq}"] = check(
            torch, f"prefill main B=4 H=14 Sq={sq}",
            call(PP.paged_prefill_attention, case),
            call(PP.paged_prefill_torch, case), TOL_BF16, zero_rows=pad,
            exact=call(PP.paged_prefill_torch, as_f32(case)))
    # edge cases: GQA widths, head dims, empty / padded rows, mid-block
    # tails, window + softcap, f32 against the dense oracle
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        for R, hd, window, cap in ((1, 64, 0, 0.0), (2, 64, 0, 0.0),
                                   (7, 64, 0, 0.0), (7, 128, 0, 0.0),
                                   (16, 128, 0, 0.0), (7, 64, 24, 30.0)):
            H, tag = 2 * R, f"{str(dtype)[6:]} R={R} hd={hd} win={window} cap={cap}"
            d = decode_case(torch, np, B=3, H=H, KV=2, hd=hd, page=16,
                            n_slots=12, dtype=dtype, seed=R + hd,
                            rows=[[20, 13, 5], [], [16, 40]],
                            window=window, cap=cap)
            got = call(PA.paged_decode_attention, d)
            check(torch, f"decode {tag}", got,
                  call(PA.paged_decode_torch, d), tol, zero_rows=[1],
                  exact=call(PA.paged_decode_torch, as_f32(d))
                  if dtype == torch.bfloat16 else None)
            if dtype == torch.float32:
                check(torch, f"decode-oracle {tag}", got,
                      call(ref.reference_paged_decode, d), tol)
            p = prefill_case(torch, np, B=3, H=H, KV=2, hd=hd, page=16,
                             n_slots=12, Sq=40, dtype=dtype, seed=R + hd + 1,
                             rows=[([20, 13], 40), ([], 17), ([], 0)],
                             window=window, cap=cap)
            pad = torch.arange(40, device="cuda")[None] >= p["q_len"][:, None]
            pad = pad[:, None, :].expand(-1, H, -1)
            got = call(PP.paged_prefill_attention, p)
            check(torch, f"prefill {tag}", got,
                  call(PP.paged_prefill_torch, p), tol, zero_rows=pad,
                  exact=call(PP.paged_prefill_torch, as_f32(p))
                  if dtype == torch.bfloat16 else None)
            if dtype == torch.float32:
                check(torch, f"prefill-oracle {tag}", got,
                      call(ref.reference_paged_prefill, p), tol)
        # pages of 8 and 32 keys: one 16-key unit a page, and two; decode
        # rows of 3-4 splits (16 and 4 table entries a split) under a
        # window of 300
        for page, R in ((8, 2), (32, 7)):
            tag = f"{str(dtype)[6:]} page={page} R={R} hd=64 win=24 cap=30"
            dtag = tag.replace("win=24", "win=300")
            d = decode_case(torch, np, B=3, H=2 * R, KV=2, hd=64, page=page,
                            n_slots=80, dtype=dtype, seed=page + R + 2,
                            rows=[[300, 130, 5], [], [16, 400]], window=300,
                            cap=30.0)
            got = call(PA.paged_decode_attention, d)
            check(torch, f"decode {dtag}", got,
                  call(PA.paged_decode_torch, d), tol, zero_rows=[1],
                  exact=call(PA.paged_decode_torch, as_f32(d))
                  if dtype == torch.bfloat16 else None)
            if dtype == torch.float32:
                check(torch, f"decode-oracle {dtag}", got,
                      call(ref.reference_paged_decode, d), tol)
            p = prefill_case(torch, np, B=3, H=2 * R, KV=2, hd=64, page=page,
                             n_slots=24, Sq=40, dtype=dtype, seed=page + R,
                             rows=[([20, 13], 40), ([], 17), ([], 0)],
                             window=24, cap=30.0)
            pad = torch.arange(40, device="cuda")[None] >= p["q_len"][:, None]
            pad = pad[:, None, :].expand(-1, 2 * R, -1)
            got = call(PP.paged_prefill_attention, p)
            check(torch, f"prefill {tag}", got,
                  call(PP.paged_prefill_torch, p), tol, zero_rows=pad,
                  exact=call(PP.paged_prefill_torch, as_f32(p))
                  if dtype == torch.bfloat16 else None)
            if dtype == torch.float32:
                check(torch, f"prefill-oracle {tag}", got,
                      call(ref.reference_paged_prefill, p), tol)
    chunk_split_paged(torch, pre[2048])
    pfx = parity_prefix(torch, errs)
    paper = paper_cases(torch, np)
    parity_paper(torch, np, paper, errs)
    for name in ("paged_prefill", "prefix_attention"):
        for dtype in ("bfloat16", "float32"):
            print(f"[parity] {name} body for {dtype}: "
                  f"{_build.body(name, dtype == 'bfloat16')}", flush=True)
    return dec, dec_long, pre, pfx, paper, errs


def parity_single_layer(torch):
    """The single-layer decode API (kernels/ops.py::paged_attention:
    contiguous runs from a block table and lengths, through the decode
    kernel) against the dense oracle ref.reference_paged_attention, at
    Qwen2-0.5B's heads, rows of 1-384 keys."""
    from repro_torch.kernels import ops, ref
    B, H, KV, hd, page, n_pages, n_slots = 8, 14, 2, 64, 16, 240, 24
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        gen = torch.Generator(device="cuda").manual_seed(17)
        kp, vp = (torch.randn((n_pages, page, KV, hd), generator=gen,
                              device="cuda").to(dtype) for _ in "kv")
        q = torch.randn((B, H, hd), generator=gen, device="cuda").to(dtype)
        bt = torch.randint(0, n_pages, (B, n_slots), generator=gen,
                           device="cuda", dtype=torch.int32)
        lengths = torch.randint(1, page * n_slots + 1, (B,), generator=gen,
                                device="cuda", dtype=torch.int32)
        check(torch, f"paged_attention {str(dtype)[6:]} B={B} H={H} KV={KV} "
              f"hd={hd} slots={n_slots}",
              ops.paged_attention(q, kp, vp, bt, lengths),
              ref.reference_paged_attention(q, kp, vp, bt, lengths), tol)


def decode_bits(torch, dec):
    """A decode row's bits depend only on its own run table: each row of
    the main case must come out bit for bit the same alone (B = 1), with
    every page but its own refilled at random, and with its table cut to
    the longest row's live entries or widened by empty entries to
    max(300, its entries + 80)."""
    from repro_torch.kernels import paged_attention as PA
    out = call(PA.paged_decode_attention, dec)
    B = dec["q"].shape[0]
    ints = ("tables", "counts", "starts")

    def verdict(name, same):
        print(f"[parity] decode kernel, {name}: bit-identical {same}",
              flush=True)
        if not same:
            die(f"decode rows are not bit-identical {name}")

    verdict("each row alone (B=1) vs in the B=8 batch", all(
        torch.equal(out[b:b + 1], call(PA.paged_decode_attention, dict(
            dec, q=dec["q"][b:b + 1], qpos=dec["qpos"][b:b + 1],
            **{n: dec[n][b:b + 1] for n in ints})))
        for b in range(B)))
    gen = torch.Generator(device="cuda").manual_seed(99)
    same, moved = True, False
    for b in range(B):
        own = dec["tables"][b][dec["counts"][b] > 0].long()
        other = {}
        for n in ("k_pages", "v_pages"):
            t = torch.randn(dec[n].shape, generator=gen, device="cuda")
            t = t.to(dec[n].dtype)
            t[:, own] = dec[n][:, own]
            other[n] = t
        got = call(PA.paged_decode_attention, dict(dec, **other))
        same &= torch.equal(got[b], out[b])
        moved |= not torch.equal(got, out)
    if not moved:
        die("refilling the neighbours' pages changed no output: the bit "
            "check would not see a leak")
    verdict("each row with every other page refilled at random", same)
    counts = dec["counts"]
    live = int((counts > 0).sum(dim=1).max())
    n_slots = counts.shape[1]
    narrow = {n: dec[n][:, :live].contiguous() for n in ints}
    n_wide = max(300, n_slots + 80)
    wide = {n: torch.cat([dec[n], torch.zeros_like(dec[n][:, :1])
                          .expand(-1, n_wide - n_slots)], dim=1)
            for n in ints}
    verdict(f"tables of {n_slots} entries vs {live} (the longest row's "
            f"live ones) and {n_wide}",
            torch.equal(call(PA.paged_decode_attention, dict(dec, **narrow)),
                        out)
            and torch.equal(call(PA.paged_decode_attention,
                                 dict(dec, **wide)), out))


def chunk_split_paged(torch, whole):
    """A row's bits do not depend on the chunk it is computed in: the rows
    of the 2048-row paged prefill from row `cut` on, recomputed as a later
    chunk whose prefix (rows 0..cut-1) sits in the pool's pages, must equal
    the whole chunk's rows bit for bit (padding rows included).  The two
    cuts give chunks of 1048 and 64 rows, which the kernel packs 8 and 2
    warps a CTA."""
    from repro_torch.kernels import paged_prefill as PP
    out = call(PP.paged_prefill_attention, whole)
    q_len = whole["q_len"]
    for cut in (1000, 1984):
        split = dict(whole, q=whole["q"][:, :, cut:],
                     q_start=whole["q_start"] + cut,
                     q_len=torch.clamp(q_len - cut, min=0).to(q_len.dtype))
        b = call(PP.paged_prefill_attention, split)
        torch.cuda.synchronize()
        same = bool(torch.equal(out[:, :, cut:], b))
        print(f"[parity] paged prefill kernel, q {tuple(whole['q'].shape)} "
              f"KV={whole['k_pages'].shape[3]}: 2048 rows whole vs rows "
              f"{cut}.. as a later chunk: bit-identical {same}", flush=True)
        if not same:
            die("the paged prefill kernel's rows depend on the chunk split")


def main_prefix_cases(torch):
    """The dense prefill's attention at full width: a CAG preload doc of
    512 tokens, a 2048-token prefill, and 300 new tokens after a 1700-token
    cached prefix (--attn dense / the sequential engine)."""
    return {key: prefix_case(torch, B=1, H=14, KV=2, hd=64, P=P, Sq=Sq,
                             dtype=torch.bfloat16, seed=20 + i)
            for i, (key, P, Sq) in enumerate((("prefix512", 0, 512),
                                              ("prefix2048", 0, 2048),
                                              ("prefix1700+300", 1700, 300)))}


def parity_prefix(torch, errs):
    from repro_torch.kernels import prefix_attention as PX
    from repro_torch.kernels import ref
    pfx = main_prefix_cases(torch)
    for key, case in pfx.items():
        got = call_prefix(PX.prefix_flash_attention, case)
        errs[key] = check(torch, f"{key} main B=1 H=14 KV=2 hd=64", got,
                          call_prefix(PX.prefix_attention_torch, case),
                          TOL_BF16, exact=call_prefix(
                              PX.prefix_attention_torch, as_f32(case)))
        check(torch, f"{key}-oracle", got,
              call_prefix(ref.reference_prefix_attention, case), TOL_BF16)
    # edge cases, the same grid in f32 and bf16: GQA widths, head dims, a
    # single query, lengths off the 64-key tile, window + softcap, a batch
    # of 3
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        for B, R, hd, P, Sq, window, cap in (
                (2, 1, 64, 37, 70, 0, 0.0), (2, 2, 64, 37, 70, 0, 0.0),
                (1, 7, 128, 100, 1, 0, 0.0), (1, 16, 128, 150, 200, 24, 30.0),
                (1, 7, 64, 150, 200, 24, 30.0), (3, 7, 64, 0, 129, 0, 0.0)):
            c = prefix_case(torch, B=B, H=2 * R, KV=2, hd=hd, P=P, Sq=Sq,
                            dtype=dtype, seed=R + hd + Sq, window=window,
                            cap=cap)
            tag = (f"{str(dtype)[6:]} B={B} R={R} hd={hd} P={P} Sq={Sq} "
                   f"win={window} cap={cap}")
            got = call_prefix(PX.prefix_flash_attention, c)
            check(torch, f"prefix {tag}", got,
                  call_prefix(PX.prefix_attention_torch, c), tol,
                  exact=call_prefix(PX.prefix_attention_torch, as_f32(c))
                  if dtype == torch.bfloat16 else None)
            if dtype == torch.float32:
                check(torch, f"prefix-oracle {tag}", got,
                      call_prefix(ref.reference_prefix_attention, c), tol)
    prefix_split(torch, pfx["prefix2048"], 1048)
    return pfx


def prefix_split(torch, whole, cut):
    """A row's bits do not depend on the chunk it is computed in: the rows
    of a prefill from ``cut`` on, as a chunk after a ``cut``-token prefix,
    must equal the whole prefill's rows bit for bit."""
    from repro_torch.kernels import prefix_attention as PX
    split = dict(whole, q=whole["q"][:, :, cut:], prefix_len=cut)
    a = call_prefix(PX.prefix_flash_attention, whole)[:, :, cut:]
    b = call_prefix(PX.prefix_flash_attention, split)
    torch.cuda.synchronize()
    same = bool(torch.equal(a, b))
    Sq = whole["q"].shape[2]
    print(f"[parity] prefix kernel, q {tuple(whole['q'].shape)}: {Sq} rows "
          f"whole vs the last {Sq - cut} as a chunk: bit-identical {same}",
          flush=True)
    if not same:
        die("the prefix kernel's rows depend on the chunk split")


def phase_times(torch, np, dec, dec_long, pre, pfx, paper, errs):
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import paged_prefill as PP
    from repro_torch.kernels import prefix_attention as PX
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    rows = {}
    for name, fn, plain, case, decode, key in (
            ("paged_decode_attention", PA.paged_decode_attention,
             PA.paged_decode_torch, dec, True, "decode"),
            ("paged_decode_attention@long_rows", PA.paged_decode_attention,
             PA.paged_decode_torch, dec_long, True, "decode_long"),
            ("paged_prefill_attention", PP.paged_prefill_attention,
             PP.paged_prefill_torch, pre[2048], False, "prefill2048"),
            ("paged_prefill_attention@Sq=64", PP.paged_prefill_attention,
             PP.paged_prefill_torch, pre[64], False, "prefill64")):
        ms = time_ms(torch, lambda: call(fn, case), flush=flush)
        plain_ms = time_ms(torch, lambda: call(plain, case), flush=flush)
        lib = library_fn(torch, case, decode)
        lib_ms = time_ms(torch, lib, flush=flush)
        bnd, by = bound_ms(np, case, decode)
        q = case["q"]
        rows[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bnd, bound_by=by, max_abs_err=errs[key],
                         shape=f"q {tuple(q.shape)} {str(q.dtype)[6:]}, "
                               f"pool {tuple(case['k_pages'].shape)}, "
                               f"slots {case['tables'].shape[1]}")
        print(f"[times] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {lib_ms:.4f} ms, bound {bnd:.4f} ms ({by})",
              flush=True)
    for key, case in pfx.items():
        ms = time_ms(torch, lambda: call_prefix(PX.prefix_flash_attention,
                                                case), flush=flush)
        plain_ms = time_ms(torch, lambda: call_prefix(
            PX.prefix_attention_torch, case), reps=5, flush=flush)
        lib_ms = time_ms(torch, prefix_library_fn(torch, case), flush=flush)
        bnd, by = prefix_bound_ms(case)
        q = case["q"]
        rows[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bnd, bound_by=by, max_abs_err=errs[key],
                         shape=f"q {tuple(q.shape)} {str(q.dtype)[6:]}, "
                               f"prefix {case['prefix_len']}")
        print(f"[times] prefix_flash_attention@{key}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
              f"{bnd:.4f} ms ({by})", flush=True)
    rows.update(time_paper(torch, np, paper, errs, flush))
    del flush
    return rows


def time_paper(torch, np, paper, errs, flush):
    """Kernel, plain version and library times at the paper models' shapes
    (the plain versions, seconds a call here, over 5 timings), with each
    one's bound."""
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import paged_prefill as PP
    from repro_torch.kernels import prefix_attention as PX
    rows = {}
    for key, (kind, case) in paper.items():
        if kind == "prefix":
            fn = lambda: call_prefix(PX.prefix_flash_attention, case)
            plain = lambda: call_prefix(PX.prefix_attention_torch, case)
            lib = prefix_library_fn(torch, case)
            bnd, by = prefix_bound_ms(case)
        else:
            mod = PA if kind == "decode" else PP
            kern = getattr(mod, f"paged_{kind}_attention")
            ref = getattr(mod, f"paged_{kind}_torch")
            fn = lambda: call(kern, case)
            plain = lambda: call(ref, case)
            lib = library_fn(torch, case, kind == "decode")
            bnd, by = bound_ms(np, case, kind == "decode")
        ms = time_ms(torch, fn, flush=flush)
        plain_ms = time_ms(torch, plain, reps=5, warm=1, flush=flush)
        lib_ms = time_ms(torch, lib, flush=flush)
        del lib
        rows[key] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bnd, bound_by=by, max_abs_err=errs[key],
                         factor=ms / lib_ms, shape=case_tag(kind, case))
        print(f"[times] {key} ({case_tag(kind, case)}): kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms (factor "
              f"{ms / lib_ms:.2f}x), bound {bnd:.4f} ms ({by})", flush=True)
    return rows


def phase_serve(torch, np):
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    args = serve.build_parser().parse_args(MAIN_ARGV)
    cfg = get_config("qwen2-0.5b")
    t0 = time.perf_counter()
    cfg, params, corpus, idx, wl, _ = serve.make_setup(args, cfg=cfg)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype}; set-up "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    results, rt, launches, stats = serve_main_path(
        torch, np, "serve", cfg, params, corpus, idx, wl, args)
    return (cfg, params, corpus, idx, wl, args, results, launches, stats)


def serve_main_path(torch, np, tag, cfg, params, corpus, idx, wl, args):
    """The main path once: ``wl`` through one ContinuousRuntime, counting
    kernel launches; dies unless every request is served in full through
    the kernels, with finite first-token logits and no leaked block.
    Returns (results, runtime, launches, (tokens/s, TTFT p50 ms))."""
    from repro_torch.launch import serve
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    results, (rt,) = serve.serve_continuous(cfg, params, corpus, idx, wl,
                                            args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = read_counts()
    n_tok = sum(len(r.tokens) for r in results)
    peak = torch.cuda.max_memory_allocated()
    print(f"[{tag}] {len(results)} requests, {n_tok} tokens in {wall:.2f}s "
          f"wall = {n_tok / wall:.1f} tokens/s", flush=True)
    print(f"[{tag}] peak device memory {peak} B ({peak / 2**30:.2f} GiB; "
          f"{held} B held before the serve); pool blocks "
          f"{rt.store.pool.n_blocks}", flush=True)
    print(f"[{tag}] kernel launches {launches}; plain-version calls {plain}",
          flush=True)
    if len(results) != len(wl) or any(len(r.tokens) != args.max_new_tokens
                                      for r in results):
        die(f"[{tag}] not every request was served in full")
    if min(launches["paged_decode_attention"],
           launches["paged_prefill_attention"]) <= 0:
        die(f"[{tag}] a kernel of the main path never launched: {launches}")
    if plain:
        die(f"[{tag}] the plain versions ran {plain} times on the main path")
    for r in results:
        fl = r.first_logits
        if fl is None or fl.shape != (cfg.vocab_size,) \
                or not np.isfinite(fl).all():
            die(f"[{tag}] request {r.req_id}: first-token logits missing, "
                f"misshapen or not finite")
    check_leak(rt)
    return results, rt, launches, serve_stats(results, rt, wall)


def phase_row_invariance(torch, cfg, params, tag="rows"):
    """Row 0 of each row-wise op of the paged steps, at the model's shapes
    and dtype, computed in calls of PROBE_ROWS rows: bit-identical across
    the row counts or not, with the fixed-slab helper off
    (layers.ROW_SLAB = 0) and on, each op run as the model runs it (the
    products through layers.proj).  Returns the ops still row-variant with
    the helper on."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    p = {k: w[0] for k, w in params["blocks"].items()}
    gen = torch.Generator(device="cuda").manual_seed(5)
    n = max(PROBE_ROWS)
    x = torch.randn((n, cfg.d_model), generator=gen, device="cuda")
    x = x.to(cfg.tdtype)
    h = torch.randn((n, cfg.d_ff), generator=gen, device="cuda")
    h = h.to(cfg.tdtype)
    o = torch.randn((n, cfg.n_heads * cfg.hd), generator=gen, device="cuda")
    o = o.to(cfg.tdtype)
    ops = [("rms_norm", x, lambda t: L.rms_norm(t, p["ln1"], cfg.norm_eps))]
    for name in ("q", "k", "v"):
        ops.append((f"proj {name}", x, lambda t, w=p[f"w{name}"],
                    b=p.get(f"b{name}"): L.proj(t, w, b)))
    ops.append(("proj o", o, lambda t: L.proj(t, p["wo"])))
    if cfg.moe_experts:
        # every expert's products have expert 0's shapes
        wg, wu, wd = p["wg"][0], p["wu"][0], p["wd"][0]
        ops.append(("proj router", x, lambda t: L.proj(t, p["router"])))
        pre = "expert 0 "
    else:
        wg, wu, wd = p["wg"], p["wu"], p["wd"]
        pre = ""
    ops += [(f"{pre}proj gate (d_ff out)", x, lambda t: L.proj(t, wg)),
            (f"{pre}proj up (d_ff out)", x, lambda t: L.proj(t, wu)),
            (f"{pre}proj down (d_ff in)", h, lambda t: L.proj(t, wd)),
            (f"{pre}swiglu", x, lambda t: L.swiglu(t, wg, wu, wd))]
    if cfg.moe_experts:
        ops.append(("moe_dense (all experts)", x, lambda t: L.moe_dense(
            t, p["router"], p["wg"], p["wu"], p["wd"], cfg.moe_top_k)))
    ops.append(("lm_logits", x, lambda t: M.lm_logits(cfg, params, t)))
    # m rows of logits and a final softcap's temporaries take up to ~16 x
    # m x vocab B: the logits are probed at the row counts that fit the
    # free memory (all of them but at Gemma2-27B's width, where 8192 rows
    # would need 33.6e9 B beside 54.5e9 B of weights)
    free = torch.cuda.mem_get_info()[0]
    rows_of = {"lm_logits": [m for m in PROBE_ROWS
                             if 16 * m * cfg.vocab_size <= free] or [1]}
    return probe_rows(torch, ops, tag, cfg.name, rows_of)


def probe_rows(torch, ops, tag, name, rows_of=None):
    """Row 0 of each op in ``ops`` ((name, input, fn)) computed in calls of
    PROBE_ROWS rows (``rows_of[name]`` for some), with the fixed-slab
    helper off and on: prints each op's verdict and returns the ops still
    row-variant with the helper on."""
    from repro_torch.models import layers as L
    rows_of = rows_of or {}
    slab = L.ROW_SLAB
    variant = []
    try:
        for op, inp, fn in ops:
            verdict = []
            for label, rows in (("without helper", 0), ("with helper", slab)):
                L.ROW_SLAB = rows
                ref0 = fn(inp[:1])[0]
                diffs = {m: (fn(inp[:m])[0].float() - ref0.float())
                         .abs().max().item()
                         for m in rows_of.get(op, PROBE_ROWS)}
                same = all(d == 0 for d in diffs.values())
                verdict.append(f"{label}: bit-identical {same}" + (
                    "" if same else f" (max |diff| by rows {diffs})"))
                if rows and not same:
                    variant.append(op)
            print(f"[{tag}] {op}: {'; '.join(verdict)}", flush=True)
    finally:
        L.ROW_SLAB = slab
    torch.cuda.synchronize()
    logits = rows_of.get("lm_logits")
    print(f"[{tag}] {name}: row counts {PROBE_ROWS}"
          + (f" (the logits {tuple(logits)})" if logits else "")
          + f", slabs of {slab} rows for the products layers.slabbed names; "
          f"row-variant with the helper: {variant or 'none'}", flush=True)
    return variant


def phase_repair_cost(torch, cfg, params, corpus, idx, wl, args, with_stats,
                      tag="rows"):
    """The main serve's tokens/s and TTFT p50 without the fixed-slab helper,
    beside the main serve's own (with it), and with it once more."""
    from repro_torch.models import layers as L
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.runtime import ContinuousRuntime
    slab = L.ROW_SLAB
    out = {"with (main serve)": with_stats}
    try:
        for label, rows in (("without", 0), ("with", slab)):
            L.ROW_SLAB = rows
            rt = ContinuousRuntime(cfg, params, corpus, idx,
                                   config=EngineConfig.from_args(args),
                                   device="cuda")
            t0 = time.perf_counter()
            res = rt.serve(wl, max_new_tokens=args.max_new_tokens)
            torch.cuda.synchronize()
            out[label] = serve_stats(res, rt, time.perf_counter() - t0)
    finally:
        L.ROW_SLAB = slab
    for label, (tps, ttft) in out.items():
        print(f"[{tag}] main serve {label} the helper: {tps:.1f} tokens/s, "
              f"TTFT p50 {ttft:.1f} ms", flush=True)


def phase_check(torch, np, cfg, params, corpus, idx, wl, args, results,
                n=8, eps=LOGIT_EPS, tag="check"):
    """The first ``n`` requests again on a fresh runtime through the plain
    versions, against the main serve's results: first-token logits within
    eps, and no token flipped above eps.  Returns the first-token L-inf."""
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.runtime import ContinuousRuntime
    sub = sorted(wl, key=lambda r: r.req_id)[:n]
    econf = dataclasses.replace(EngineConfig.from_args(args),
                                attn_impl="torch")
    gc.collect()
    reset_counts()
    t0 = time.perf_counter()
    rt = ContinuousRuntime(cfg, params, corpus, idx, config=econf,
                           device="cuda")
    with recording_margins():
        plain = rt.serve(sub, max_new_tokens=args.max_new_tokens)
    torch.cuda.synchronize()
    launches, _ = read_counts()
    print(f"[{tag}] {len(plain)} requests through the plain versions in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    if any(launches.values()):
        die(f"the plain-version runtime launched a kernel: {launches}")
    linf = compare_logits(np, tag, plain, results, eps)
    by_id = {r.req_id: r for r in results}
    check_flips(tag, [(by_id[b.req_id], b) for b in plain], eps)
    return linf


def phase_pinned_check(torch, np, cfg, params, corpus, idx, wl, args,
                       eps, tag, n=4):
    """phase_check for the MoE family, its routes pinned (pinned_routes):
    the first ``n`` requests through the kernels, recording each row's
    experts; again through the kernels without the slab helper, which
    changes only the order of the GEMMs' sums (the floor); then through
    the plain versions.  The paper models' eps does not bound the floor
    (a top-2 MoE amplifies rounding more than the dense models it was
    reckoned on), so the MoE eps is the larger of it and twice the floor:
    a kernel may move the logits at most twice as far as reordering the
    model's own GEMMs does.  Plain within that eps, and no flip above it.
    Returns (the MoE eps, pin counts)."""
    from repro_torch.models import layers as L
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.runtime import ContinuousRuntime
    sub = sorted(wl, key=lambda r: r.req_id)[:n]
    econf = EngineConfig.from_args(args)
    routes = {}
    t0 = time.perf_counter()

    def serve_sub(conf, replay):
        gc.collect()
        rt = ContinuousRuntime(cfg, params, corpus, idx, config=conf,
                               device="cuda")
        with pinned_routes(routes, replay=replay) as pin:
            res = rt.serve(sub, max_new_tokens=args.max_new_tokens)
        torch.cuda.synchronize()
        return {r.req_id: r for r in res}, pin

    kern, _ = serve_sub(econf, False)
    slab = L.ROW_SLAB
    L.ROW_SLAB = 0
    try:
        floor_run, floor_pin = serve_sub(econf, True)
    finally:
        L.ROW_SLAB = slab
    floor = max(float(np.max(np.abs(
        kern[i].first_logits.astype(np.float64)
        - floor_run[i].first_logits.astype(np.float64)))) for i in kern)
    moe_eps = max(eps, 2 * floor)
    print(f"[{tag}] floor: the kernels with and without the slab helper, "
          f"routes pinned ({floor_pin['changed']} of "
          f"{floor_pin['pinned']} pinned rows routed otherwise): "
          f"first-token L-inf {floor:.4e}; MoE eps max({eps:g}, 2 x floor) "
          f"= {moe_eps:.4f}", flush=True)
    reset_counts()
    with recording_margins():
        plain, pin = serve_sub(dataclasses.replace(econf, attn_impl="torch"),
                               True)
    launches, _ = read_counts()
    print(f"[{tag}] {len(sub)} requests through the kernels (twice) and "
          f"the plain versions, routes pinned, in "
          f"{time.perf_counter() - t0:.1f}s: {pin['pinned']} of "
          f"{pin['rows']} routed rows pinned, {pin['changed']} of them "
          f"routed otherwise by the plain run's own logits", flush=True)
    if any(launches.values()):
        die(f"the plain-version runtime launched a kernel: {launches}")
    if pin["pinned"] < pin["rows"] // 2:
        die(f"[{tag}] too few rows pinned: {pin}")
    against = "the kernels' serve, routes pinned"
    compare_logits(np, tag, list(plain.values()), list(kern.values()),
                   moe_eps, against)
    check_flips(tag, [(kern[i], plain[i]) for i in kern], moe_eps)
    return moe_eps, pin


def phase_chunk_split(torch, np, cfg, params, corpus, idx, wl, args,
                      tag="chunk-split"):
    """The first 8 requests unchunked and in 128-token prefill chunks,
    through the kernels: first-token logits and tokens bit-identical."""
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.runtime import ContinuousRuntime
    sub = sorted(wl, key=lambda r: r.req_id)[:8]
    runs = []
    for chunk in (0, 128):
        econf = dataclasses.replace(EngineConfig.from_args(args),
                                    prefill_chunk=chunk)
        # runtimes form reference cycles: free the last one's pool first
        gc.collect()
        rt = ContinuousRuntime(cfg, params, corpus, idx, config=econf,
                               device="cuda")
        runs.append({r.req_id: r for r in
                     rt.serve(sub, max_new_tokens=args.max_new_tokens)})
        del rt
    a, b = runs
    bitwise = all(np.array_equal(a[i].first_logits, b[i].first_logits)
                  for i in a)
    linf = max(float(np.max(np.abs(a[i].first_logits.astype(np.float64)
                                   - b[i].first_logits.astype(np.float64))))
               for i in a)
    same = sum(a[i].tokens == b[i].tokens for i in a)
    print(f"[{tag}] prefill_chunk 0 vs 128 through the kernels: "
          f"first-token logits bit-identical {bitwise}, max L-inf "
          f"{linf:.4e}, tokens identical {same}/{len(a)}", flush=True)
    if not bitwise or same != len(a):
        die(f"[{tag}] chunk split is not bit-identical: max L-inf {linf}, "
            f"tokens identical {same}/{len(a)}")


def phase_cag(torch, np, cfg, params, corpus, idx, wl, args, results):
    """--mode cag at full width: preload the corpus through the dense
    prefill into an auto-sized disk tier, serve 8 requests with zero
    retrieval stages, compare with the main serve's, and remove the tier's
    files."""
    import os
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.runtime import ContinuousRuntime
    sub = sorted(wl, key=lambda r: r.req_id)[:8]
    kv_bytes = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * 2
    need = int(corpus.doc_lengths.sum()) * kv_bytes
    econf = dataclasses.replace(EngineConfig.from_args(args), mode="cag",
                                disk_cache_bytes=need)
    reset_counts()
    t0 = time.perf_counter()
    rt = ContinuousRuntime(cfg, params, corpus, idx, config=econf,
                           device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pre, plain_pre = read_counts()
    ps = rt.preload_stats
    print(f"[cag] preload: {ps['docs']} docs, {ps['tokens']} tokens, "
          f"{ps['bytes']} B in {ps['files']} files (disk tier sized "
          f"{need} B); {wall:.2f}s wall, {ps['seconds']:.2f}s of it disk "
          f"writes; prefix kernel launches {pre['prefix_flash_attention']}",
          flush=True)
    want = cfg.n_layers * len(corpus.doc_lengths)
    if pre["prefix_flash_attention"] != want or ps["docs"] != \
            len(corpus.doc_lengths) or ps["bytes"] != need:
        die(f"CAG preload: {pre['prefix_flash_attention']} prefix-kernel "
            f"launches (want {want}), {ps['docs']} docs, {ps['bytes']} B")
    reset_counts()
    t0 = time.perf_counter()
    res = rt.serve(sub, max_new_tokens=args.max_new_tokens)
    torch.cuda.synchronize()
    tps, ttft = serve_stats(res, rt, time.perf_counter() - t0)
    served, plain = read_counts()
    print(f"[cag] {len(res)} requests: {tps:.1f} tokens/s, TTFT p50 "
          f"{ttft:.1f} ms, retrieval stages {rt.metrics.retrieval_stages}; "
          f"launches {served}; plain-version calls {plain_pre + plain}",
          flush=True)
    s = rt.tree.stats
    print(f"[cag] tier hits (tokens): gpu {s['hit_tokens_gpu']} / host "
          f"{s['hit_tokens_host']} / disk {s['hit_tokens_disk']}; fetched "
          f"{s['fetch_bytes']} B from disk in {s['fetch_seconds']:.2f}s",
          flush=True)
    if plain_pre + plain:
        die(f"the plain versions ran {plain_pre + plain} times in CAG")
    if rt.metrics.retrieval_stages != 0:
        die(f"CAG ran {rt.metrics.retrieval_stages} retrieval stages")
    if len(res) != len(sub) or any(len(r.tokens) != args.max_new_tokens
                                   for r in res):
        die("CAG did not serve every request in full")
    check_leak(rt)
    compare_logits(np, "cag", res, results)
    root = rt.disk.root
    rt.disk.close()
    if os.path.exists(root):
        die(f"the disk tier's files outlived close(): {root}")
    return {"preload": pre["prefix_flash_attention"],
            "serve": served["prefix_flash_attention"]}


def phase_dense(torch, np, cfg, params, corpus, idx, wl, args, results):
    """--attn dense at full width on 8 requests: the prefix kernel carries
    the prefill, decode gathers a dense cache from the pool every step."""
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.runtime import ContinuousRuntime
    sub = sorted(wl, key=lambda r: r.req_id)[:8]
    econf = dataclasses.replace(EngineConfig.from_args(args), attn="dense")
    rt = ContinuousRuntime(cfg, params, corpus, idx, config=econf,
                           device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    res = rt.serve(sub, max_new_tokens=args.max_new_tokens)
    torch.cuda.synchronize()
    tps, ttft = serve_stats(res, rt, time.perf_counter() - t0)
    launches, plain = read_counts()
    # one dense decode step alone: gather (L, B, S, KV, hd) + decode
    rt._decode([])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        rt._decode([])
    step_ms = 1e3 * (time.perf_counter() - t0) / 3
    S = rt._n_slots * rt.store.block_size
    gathered = (2 * cfg.n_layers * econf.max_batch * S * cfg.n_kv_heads
                * cfg.hd * rt.store.k_planes[0].element_size())
    print(f"[dense] {len(res)} requests: {tps:.1f} tokens/s, TTFT p50 "
          f"{ttft:.1f} ms; decode step {step_ms:.2f} ms (gathers {gathered} "
          f"B of K/V, S {S}); launches {launches}; plain-version calls "
          f"{plain}", flush=True)
    if launches["prefix_flash_attention"] <= 0:
        die("the prefix kernel never launched under --attn dense")
    if plain:
        die(f"the plain versions ran {plain} times under --attn dense")
    check_leak(rt)
    compare_logits(np, "dense", res, results)
    return launches["prefix_flash_attention"]


def main_argv(n_requests, *extra):
    """serve.main's argv: the main configuration at published width with
    ``n_requests`` requests, plus ``extra`` flags."""
    argv = list(MAIN_ARGV)
    argv[argv.index("--requests") + 1] = str(n_requests)
    return argv + ["--full-size", *extra]


def run_main(tag, argv, keep=(), flips_eps=None):
    """Run serve.main(argv) with its stdout captured: the lines starting
    with a prefix in ``keep`` are echoed under ``[tag]``; with
    ``flips_eps``, the (continuous, sequential) pairs its --check-tokens
    compares go through check_flips.  Returns (stdout, launches,
    plain-version calls)."""
    from repro_torch.launch import serve
    reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with recording_margins() as pairs:
        try:
            with contextlib.redirect_stdout(buf):
                serve.main(argv)
        except SystemExit as e:
            print(buf.getvalue()[-4000:], flush=True)
            die(f"[{tag}] serve.main exited: {e}")
    wall = time.perf_counter() - t0
    launches, plain = read_counts()
    out = buf.getvalue()
    for ln in out.splitlines():
        if ln.lstrip().startswith(keep):
            print(f"[{tag}] {ln}", flush=True)
    print(f"[{tag}] {wall:.1f}s wall; launches {launches}; plain-version "
          f"calls {plain}", flush=True)
    if flips_eps is not None:
        check_flips(tag, pairs, flips_eps)
    return out, launches, plain


def phase_sequential(torch):
    """The port's serve.main with --check-tokens tol:0.15 on 8 full-width
    requests: the continuous runtime against the sequential RAGServer."""
    out, launches, plain = run_main(
        "seq", main_argv(8, "--check-tokens", f"tol:{LOGIT_EPS}"),
        keep=("[continuous]", "[sequential]", "mean TTFT", "token check"),
        flips_eps=LOGIT_EPS)
    if f"token check: all 8 requests within tol {LOGIT_EPS:g}" not in out:
        die("serve.main printed no passing token-check line")
    if launches["prefix_flash_attention"] <= 0 or plain:
        die(f"sequential path: launches {launches}, plain calls {plain}")
    return launches["prefix_flash_attention"]


class FlipIndex:
    """An index whose retrievals come back in reversed doc order while
    ``reverse`` is set: the same docs at other positions, which is what
    relocates a cached doc under --reuse chunk."""

    def __init__(self, base):
        self.base = base
        self.reverse = False

    def search(self, q, k, fraction=1.0):
        out = self.base.search(q, k, fraction)
        return out[::-1] if self.reverse else out

    def staged_search(self, q, k, fraction=1.0):
        for st in self.base.staged_search(q, k, fraction):
            yield (dataclasses.replace(st, topk=tuple(reversed(st.topk)))
                   if self.reverse else st)


def chunk_passes(torch, cfg, params, corpus, idx, sub, args, **conf):
    """One --reuse chunk runtime (16 boundary tokens) over ``sub`` twice,
    the second pass with every request's doc order reversed; returns
    (runtime, the index wrapper, results of each pass, (tokens/s, TTFT p50
    ms) of each pass)."""
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.runtime import ContinuousRuntime
    econf = dataclasses.replace(EngineConfig.from_args(args), reuse="chunk",
                                recompute_tokens=16, **conf)
    flip = FlipIndex(idx)
    rt = ContinuousRuntime(cfg, params, corpus, flip, config=econf,
                           device="cuda")
    passes, stats = [], []
    for reverse in (False, True):
        flip.reverse = reverse
        t0 = time.perf_counter()
        res = rt.serve(sub, max_new_tokens=args.max_new_tokens)
        torch.cuda.synchronize()
        passes.append(res)
        stats.append(serve_stats(res, rt, time.perf_counter() - t0))
    return rt, flip, passes, stats


def phase_chunk_reuse(torch, np, cfg, params, corpus, idx, wl, args,
                      main_stats):
    """--reuse chunk at full width: two passes of one runtime over 16
    requests, the second with every request's doc order reversed; the
    first 4 requests' two passes again through the kernels and through the
    plain versions."""
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import RAGServer
    sub = sorted(wl, key=lambda r: r.req_id)[:16]
    reset_counts()
    rt, flip, passes, stats = chunk_passes(torch, cfg, params, corpus, idx,
                                           sub, args)
    launches, plain = read_counts()
    m = rt.metrics
    counters = {"exact_chunk_hits": m.exact_chunk_hits,
                "reloc_chunk_hits": m.reloc_chunk_hits,
                "reloc_recompute_tokens": m.reloc_recompute_tokens}
    n_exact = [sum(r.exact for r in res) for res in passes]
    print(f"[chunk] {len(sub)} requests, twice (doc order kept, then "
          f"reversed): {counters}; results flagged exact {n_exact[0]}/"
          f"{len(sub)}, {n_exact[1]}/{len(sub)}", flush=True)
    for label, (tps, ttft) in zip(("kept", "reversed"), stats):
        print(f"[chunk] pass, doc order {label}: {tps:.1f} tokens/s, TTFT "
              f"p50 (over both passes so far) {ttft:.1f} ms", flush=True)
    print(f"[chunk] main serve (prefix reuse, 32 requests): "
          f"{main_stats[0]:.1f} tokens/s, TTFT p50 {main_stats[1]:.1f} ms",
          flush=True)
    print(f"[chunk] launches {launches}; plain-version calls {plain}",
          flush=True)
    if min(counters.values()) <= 0:
        die(f"chunk reuse never reused exactly and relocated: {counters}")
    if min(launches["paged_decode_attention"],
           launches["paged_prefill_attention"]) <= 0 or plain:
        die(f"chunk reuse: launches {launches}, plain calls {plain}")
    if any(len(r.tokens) != args.max_new_tokens for res in passes
           for r in res):
        die("chunk reuse did not serve every request in full")
    check_leak(rt)
    # the oracle: the sequential engine (exact, prefix reuse) on the same
    # doc order as each pass
    srv = RAGServer(cfg, params, corpus, flip,
                    config=EngineConfig.from_args(args), device="cuda")
    exact_linf, reloc_linf, same, bad, exact_pairs = 0.0, [], 0, [], []
    for reverse, res in zip((False, True), passes):
        flip.reverse = reverse
        with recording_margins():
            want = {r.req_id: r for r in
                    srv.serve(sub, max_new_tokens=args.max_new_tokens)}
        for a in res:
            b = want[a.req_id]
            if a.docs != b.docs:
                die(f"request {a.req_id}: docs {a.docs} vs {b.docs}")
            linf = float(np.max(np.abs(a.first_logits.astype(np.float64)
                                       - b.first_logits.astype(np.float64))))
            if not np.isfinite(linf):
                die(f"request {a.req_id}: first-token L-inf {linf}")
            if a.exact:
                exact_linf = max(exact_linf, linf)
                same += a.tokens == b.tokens
                exact_pairs.append((a, b))
                if a.tokens != b.tokens and linf > LOGIT_EPS:
                    bad.append((a.req_id, reverse, linf))
            else:
                reloc_linf.append(linf)
    print(f"[chunk] results flagged exact against the sequential engine: "
          f"first-token max L-inf {exact_linf:.4e} (eps {LOGIT_EPS}), "
          f"tokens identical {same}/{sum(n_exact)}", flush=True)
    print(f"[chunk] relocated results ({len(reloc_linf)}): first-token "
          f"L-inf max {max(reloc_linf, default=0.0):.4e}, median "
          f"{statistics.median(reloc_linf) if reloc_linf else 0.0:.4e}",
          flush=True)
    if bad:
        die(f"chunk reuse: exact results off the oracle: {bad}")
    check_flips("chunk exact vs sequential", exact_pairs, LOGIT_EPS)
    del rt, srv
    gc.collect()
    torch.cuda.empty_cache()
    # relocated rows through the kernels against the plain versions on the
    # same chunk-mode run tables
    pair = []
    for impl in (None, "torch"):
        with recording_margins():
            rt4, _, res4, _ = chunk_passes(torch, cfg, params, corpus, idx,
                                           sub[:4], args, attn_impl=impl)
        pair.append([r for res in res4 for r in res])
        del rt4
    linf, same, n_reloc = 0.0, 0, 0
    for a, b in zip(*pair):
        d = float(np.max(np.abs(a.first_logits.astype(np.float64)
                                - b.first_logits.astype(np.float64))))
        linf = max(linf, d)
        same += a.tokens == b.tokens
        n_reloc += not a.exact
        if a.exact != b.exact or a.docs != b.docs:
            die(f"chunk reuse: kernel and plain runs planned request "
                f"{a.req_id} differently")
    print(f"[chunk] 4 requests, both passes, kernels vs plain versions "
          f"({n_reloc} of {len(pair[0])} results relocated): first-token max "
          f"L-inf {linf:.4e} (eps {LOGIT_EPS}), tokens identical "
          f"{same}/{len(pair[0])}", flush=True)
    if n_reloc == 0 or linf > LOGIT_EPS:
        die(f"chunk reuse: kernels vs plain versions L-inf {linf} over "
            f"{n_reloc} relocated results")
    check_flips("chunk kernels vs plain", list(zip(*pair)), LOGIT_EPS)
    gc.collect()
    torch.cuda.empty_cache()
    out, deg, plain = run_main(
        "chunk", main_argv(8, "--reuse", "chunk", "--recompute-tokens",
                           "100000", "--check-tokens", f"tol:{LOGIT_EPS}"),
        keep=("[continuous]", "chunk hits", "token check"),
        flips_eps=LOGIT_EPS)
    if f"token check: all 8 requests within tol {LOGIT_EPS:g}" not in out:
        die("serve.main --reuse chunk printed no passing token-check line")
    if plain:
        die(f"chunk reuse (degenerate budget): {plain} plain calls")
    return dict(counters, decode=launches["paged_decode_attention"],
                prefill=launches["paged_prefill_attention"],
                main_decode=deg["paged_decode_attention"],
                main_prefill=deg["paged_prefill_attention"])


def phase_replicas(torch, np):
    """serve.main --replicas 2 --check-tokens on 16 full-width requests;
    then the same requests through two replicas and through one: the token
    streams of the two fleets, and the peak device memory with two
    pools."""
    from repro_torch.launch import serve
    argv = main_argv(16, "--replicas", "2", "--routing", "affinity")
    out, launches, plain = run_main(
        "fleet", argv + ["--check-tokens", f"tol:{LOGIT_EPS}"],
        keep=("[continuous", "fleet:", "routed per", "replica",
              "token check"), flips_eps=LOGIT_EPS)
    if f"token check: all 16 requests within tol {LOGIT_EPS:g}" not in out:
        die("serve.main --replicas 2 printed no passing token-check line")
    if min(launches["paged_decode_attention"],
           launches["paged_prefill_attention"]) <= 0 or plain:
        die(f"replicas: launches {launches}, plain calls {plain}")
    args = serve.build_parser().parse_args(argv)
    cfg, params, corpus, idx, wl, _ = serve.make_setup(args)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with contextlib.redirect_stdout(io.StringIO()):
        two, rts = serve.serve_continuous(cfg, params, corpus, idx, wl, args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    if len(rts) != 2 or any(rt.params[0] is not params for rt in rts):
        die("the two replicas do not share one set of weights")
    for rt in rts:
        check_leak(rt)
    pool = sum(2 * p.numel() * p.element_size()
               for rt in rts for p in rt.store.k_planes)
    print(f"[fleet] peak device memory with two pools {peak} B "
          f"({peak / 2**30:.2f} GiB; {base} B held before the serve: this "
          f"phase's weights and the main serve's; the two pools {pool} B)",
          flush=True)
    del rts
    gc.collect()
    torch.cuda.empty_cache()
    args.replicas = 1
    with contextlib.redirect_stdout(io.StringIO()):
        one, _ = serve.serve_continuous(cfg, params, corpus, idx, wl, args)
    by_id = {r.req_id: r for r in one}
    same = sum(a.tokens == by_id[a.req_id].tokens for a in two)
    bitwise = sum(np.array_equal(a.first_logits, by_id[a.req_id].first_logits)
                  for a in two)
    linf = max(float(np.max(np.abs(
        a.first_logits.astype(np.float64)
        - by_id[a.req_id].first_logits.astype(np.float64)))) for a in two)
    print(f"[fleet] replicas 2 vs 1 on the same 16 requests: token streams "
          f"identical {same}/{len(two)}, first-token logits bit-identical "
          f"{bitwise}/{len(two)}, max L-inf {linf:.4e}", flush=True)
    if linf > LOGIT_EPS:
        die(f"replicas 2 vs 1: first-token L-inf {linf}")
    return dict(decode=launches["paged_decode_attention"],
                prefill=launches["paged_prefill_attention"])


def phase_frontdoor(torch, cfg, corpus):
    """serve.main --frontdoor --tenants 4 --replicas 2 --autoscale on 32
    full-width requests, each replica with a disk tier sized for the
    corpus, --check-tokens on the admitted misses."""
    kv_bytes = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * 2
    need = int(corpus.doc_lengths.sum()) * kv_bytes
    argv = main_argv(32, "--frontdoor", "--tenants", "4", "--tenant-queries",
                     "8", "--replicas", "2", "--autoscale",
                     "--autoscale-min", "1", "--disk-cache-bytes", str(need),
                     "--check-tokens", f"tol:{LOGIT_EPS}")
    # decode batch 4: the front door's in-flight window (2 x batch x
    # replicas) then spans 16 of the 32 requests, so answered queries reach
    # the query cache while repeats still arrive
    argv[argv.index("--max-batch") + 1] = "4"
    out, launches, plain = run_main(
        "door", argv,
        keep=("[frontdoor", "fleet:", "cross-replica", "routed per",
              "decision kinds", "fleet hit", "replica", "front door",
              "SLO", "autoscale", "t=", "scale-up", "token check"),
        flips_eps=LOGIT_EPS)
    m = re.search(r"\] 32 requests -> (\d+) cache hits, (\d+) shed, (\d+) "
                  r"engine-served", out)
    if m is None:
        die("serve.main --frontdoor printed no partition line")
    hits, shed, served = (int(x) for x in m.groups())
    warmed = sum(int(x) for x in re.findall(
        r"scale-up warmed replica\d+: (\d+) B", out))
    ok = re.search(rf"token check: all {served} front-door miss requests "
                   rf"within tol {LOGIT_EPS:g}", out)
    print(f"[door] 32 requests: {hits} hits, {shed} shed, {served} misses "
          f"served; warmed {warmed} B from disk (tier {need} B a replica)",
          flush=True)
    if ok is None:
        die("serve.main --frontdoor printed no passing token-check line")
    if hits + shed + served != 32 or min(hits, served) <= 0:
        die(f"front door: {hits} hits + {shed} shed + {served} misses")
    if min(launches["paged_decode_attention"],
           launches["paged_prefill_attention"]) <= 0 or plain:
        die(f"front door: launches {launches}, plain calls {plain}")
    return dict(decode=launches["paged_decode_attention"],
                prefill=launches["paged_prefill_attention"], hits=hits,
                shed=shed, served=served, warmed=warmed)


# the profiler span over each expert's products in the MoE profile, and the
# kernel names that are cuBLAS GEMMs (nvjet_* on Hopper)
EXPERT_SPAN = "moe expert swiglu"
GEMM_KERNEL = re.compile(r"nvjet|gemm|gemv|xmma|cutlass", re.I)


def span_kernels(prof, span):
    """{kernel name: device ms} of the kernels launched under every CPU
    event named ``span``."""
    from torch.autograd import DeviceType
    out = {}
    for ev in prof.events():
        if ev.name != span or ev.device_type != DeviceType.CPU:
            continue
        stack = [ev]
        while stack:
            e = stack.pop()
            for k in e.kernels:
                out[k.name] = out.get(k.name, 0.0) + k.duration / 1e3
            stack.extend(e.cpu_children)
    return out


def phase_profile(torch, cfg, params, corpus, idx, wl, args, tag="profile"):
    """Device time by kernel over a short serve (8 requests on a fresh
    runtime, under torch.profiler), beside the wall time of the same serve
    on another fresh runtime without the profiler: their ratio is the
    device's busy share.  For the MoE family each expert's products run
    under one span (EXPERT_SPAN), whose kernels give the experts' share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import layers as L
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.runtime import ContinuousRuntime
    sub = sorted(wl, key=lambda r: r.req_id)[8:16]

    def serve_once():
        gc.collect()
        rt = ContinuousRuntime(cfg, params, corpus, idx,
                               config=EngineConfig.from_args(args),
                               device="cuda")
        t0 = time.perf_counter()
        rt.serve(sub, max_new_tokens=args.max_new_tokens)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0), rt.metrics.summary()

    def expert_swiglu(*a):
        with record_function(EXPERT_SPAN):
            return swiglu(*a)

    wall_ms, summ = serve_once()
    swiglu = L.swiglu
    if cfg.moe_experts:
        L.swiglu = expert_swiglu        # moe_dense's per-expert call
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            serve_once()
    finally:
        L.swiglu = swiglu
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        # the span's device-side twin covers its kernels; they count once
        if getattr(e, "device_type", None) == DeviceType.CUDA and us > 0 \
                and e.key != EXPERT_SPAN:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    if not rows:
        print(f"[{tag}] device time: not measured (the profiler recorded "
              "no kernels)", flush=True)
        return None
    busy = sum(r[0] for r in rows)
    print(f"[{tag}] 8 requests: wall {wall_ms:.1f} ms unprofiled "
          f"({summ['prefill_iterations']} prefill / "
          f"{summ['decode_iterations']} decode iterations), device busy "
          f"{busy:.1f} ms = {100 * busy / wall_ms:.1f}% of it", flush=True)
    for ms, n, name in rows[:12]:
        print(f"[{tag}]   {ms:9.2f} ms {100 * ms / busy:5.1f}% x{n:<6d} "
              f"{name[:80]}", flush=True)
    dec = [r for r in rows if "paged_decode_" in r[2]]
    dec_ms = sum(r[0] for r in dec)
    names = [re.search(r"paged_decode_[^(]*", r[2]).group(0) for r in dec]
    print(f"[{tag}] decode (the splits and their merge): {dec_ms:.2f} ms = "
          f"{100 * dec_ms / busy:.1f}% of device time, "
          f"{' + '.join(str(r[1]) for r in dec) or 0} launches "
          f"({', '.join(names)})", flush=True)
    pre = [r for r in rows if "paged_prefill_" in r[2]]
    pre_ms = sum(r[0] for r in pre)
    print(f"[{tag}] paged prefill: {pre_ms:.2f} ms = "
          f"{100 * pre_ms / busy:.1f}% of device time, "
          f"{sum(r[1] for r in pre)} launches", flush=True)
    gemm_ms = sum(r[0] for r in rows if GEMM_KERNEL.search(r[2]))
    print(f"[{tag}] cuBLAS GEMMs: {gemm_ms:.2f} ms = "
          f"{100 * gemm_ms / busy:.1f}% of device time", flush=True)
    if cfg.moe_experts:
        ker = span_kernels(prof, EXPERT_SPAN)
        if not ker:
            print(f"[{tag}] experts' device time: not measured (no kernel "
                  f"under the {EXPERT_SPAN!r} span)", flush=True)
            return
        exp_ms = sum(ker.values())
        gemm = sum(ms for name, ms in ker.items() if GEMM_KERNEL.search(name))
        print(f"[{tag}] experts ({cfg.moe_experts} a layer, every row "
              f"through each; top {cfg.moe_top_k} used): {exp_ms:.2f} ms = "
              f"{100 * exp_ms / busy:.1f}% of device time, their GEMMs "
              f"{gemm:.2f} ms = {100 * gemm / busy:.1f}%", flush=True)
        for name, ms in sorted(ker.items(), key=lambda kv: -kv[1])[:6]:
            print(f"[{tag}]   expert span {ms:9.2f} ms {name[:80]}",
                  flush=True)


@contextlib.contextmanager
def constant_clock():
    """The serving runtime reads a constant perf_counter while open: its
    schedule then follows the workload alone (as tests/test_torch_clock.py
    does on the CPU)."""
    import types
    import repro_torch.serving.runtime as R
    real = R.time
    clock = {k: getattr(real, k) for k in dir(real) if not k.startswith("__")}
    clock["perf_counter"] = lambda: 0.0
    R.time = types.SimpleNamespace(**clock)
    try:
        yield
    finally:
        R.time = real


def first_layers(cfg, params, n):
    """``cfg`` and ``params`` cut to their first ``n`` layers (views of the
    weights): a depth cut that keeps every width."""
    blocks = {k: w[:n] for k, w in params["blocks"].items()}
    return dataclasses.replace(cfg, n_layers=n), dict(params, blocks=blocks)


def one_card_mesh(tp, slabs=0):
    """tp shards, all on cuda:0, of column-slab group ``slabs`` (0: tp)."""
    from repro_torch.launch.mesh import make_serving_mesh
    return make_serving_mesh(tp, devices=["cuda:0"] * tp, slabs=slabs)


def tp_probe(torch, cfg, params, tps, tag):
    """The column products of layer 0 (wq, wk, wv with their biases, wg,
    wu) and the logits, at TP_PROBE_ROWS rows, for each tp of ``tps`` at
    its column-slab group G = tp: each shard's columns (its leaves as
    launch/sharding.py::placer lays them out, through layers.col_proj: the
    port's path) must equal those of a one-device mesh of group G bit for
    bit.  The default tp 1's columns (one unslabbed call through proj's
    row rule, group 1) are reported for contrast: where they differ from
    tp N's, the group is what keeps tp N's bits.  Dies on a mismatch
    through the slabs."""
    from repro_torch.launch.sharding import placer
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    gen = torch.Generator(device="cuda").manual_seed(23)
    x = torch.randn((max(TP_PROBE_ROWS), cfg.d_model), generator=gen,
                    device="cuda").to(cfg.tdtype)
    blk = params["blocks"]
    cols = ("q", "k", "v") + (("outer",) if cfg.moe_experts else ("g", "u"))
    prods = [(n, ("blocks", f"w{n}"), blk[f"w{n}"][:1],
              blk[f"b{n}"][:1] if f"b{n}" in blk else None)
             for n in cols if n != "outer"]
    if cfg.moe_experts:
        prods.append(("router", ("blocks", "router"), blk["router"][:1],
                      None))
    logit = "embed" if cfg.tie_embeddings else "lm_head"
    prods.append(("logits", (logit,), params[logit], None))
    bad, plain_diff = [], {}
    for tp in tps:
        one, split = placer(cfg, one_card_mesh(1, tp)), placer(
            cfg, one_card_mesh(tp))
        for name, path, w, b in prods:
            bpath = ("blocks", f"b{name}")
            w1 = one(path, w)[0]
            ws = split(path, w)
            b1 = None if b is None else one(bpath, b)[0][0]
            bs = [None] * tp if b is None else [t[0] for t in split(bpath, b)]
            for rows in TP_PROBE_ROWS:
                xs = x[:rows]
                if name == "logits":
                    whole = M._logit_cols(cfg, {logit: w1}, xs, tp)
                    plain = M._logit_cols(cfg, {logit: w}, xs, 1)
                    got = [M._logit_cols(cfg, {logit: wi}, xs, 1)
                           for wi in ws]
                else:
                    whole = L.col_proj(xs, w1[0], b1, tp)
                    plain = L.proj(xs, w[0], None if b is None else b[0])
                    got = [L.col_proj(xs, wi[0], bi) for wi, bi in zip(ws, bs)]
                N = whole.shape[-1]
                for i, g in enumerate(got):
                    cols = slice(i * N // tp, (i + 1) * N // tp)
                    if not torch.equal(g, whole[..., cols]):
                        bad.append((tp, name, rows, i))
                    if not torch.equal(g, plain[..., cols]):
                        plain_diff.setdefault((tp, name), []).append(rows)
                del whole, plain, got
            del w1, ws
    if cfg.moe_experts:
        expert_probe(torch, cfg, params, tps, x, bad, plain_diff)
        prods.append(("experts (batched)",))
    torch.cuda.synchronize()
    for tp in tps:
        for name, *_ in prods:
            rows = sorted(set(plain_diff.get((tp, name), [])))
            print(f"[{tag}] column probe tp {tp} {name}: the default tp "
                  f"1's columns differ at rows {rows or 'none'}; against "
                  f"tp 1 of group {tp}: "
                  f"bit-identical {not any(b[:2] == (tp, name) for b in bad)}",
                  flush=True)
    if bad:
        die(f"[{tag}] shards' columns differ from a one-device mesh's of "
            f"their group: {bad[:8]}")
    return {f"tp{tp} {name}": sorted(set(rows))
            for (tp, name), rows in plain_diff.items()}


def expert_probe(torch, cfg, params, tps, x, bad, plain_diff):
    """The batched expert products of layers.moe_capacity (``eCd,edf->eCf``
    over the experts' buffers) as tensor-parallel serving computes them
    (models/model.py::_moe_shards): each shard its whole experts, in
    groups of E / G experts a call.  For each tp of ``tps`` at G = tp, at
    buffers of TP_EXPERT_ROWS rows, every shard's groups must equal tp 1's
    of group G bit for bit (appended to ``bad``); where the default tp 1's
    one product over all E experts differs from them is recorded in
    ``plain_diff`` (whether a batched product's slice keeps its bits when
    the batch count changes)."""
    from repro_torch.launch.sharding import expert_rule
    E = cfg.moe_experts
    wg = params["blocks"]["wg"][0]                       # (E, D, F)
    for tp in tps:
        if expert_rule(cfg, tp) != "experts":
            continue
        n = E // tp
        for rows in TP_EXPERT_ROWS:
            xbuf = torch.stack([x.roll(97 * e, 0)[:rows] for e in range(E)])
            plain = torch.einsum("eCd,edf->eCf", xbuf, wg)
            whole = torch.cat([torch.einsum("eCd,edf->eCf",
                                            xbuf[j * n:(j + 1) * n],
                                            wg[j * n:(j + 1) * n])
                               for j in range(tp)])
            for i in range(tp):
                part = wg[i * n:(i + 1) * n].contiguous()
                got = torch.einsum("eCd,edf->eCf",
                                   xbuf[i * n:(i + 1) * n].contiguous(), part)
                if not torch.equal(got, whole[i * n:(i + 1) * n]):
                    bad.append((tp, "experts (batched)", rows, i))
            if not torch.equal(plain, whole):
                plain_diff.setdefault((tp, "experts (batched)"),
                                      []).append(rows)
            del xbuf, plain, whole


def tp_kernel_bits(torch, np, cfg, tps, tag):
    """The per-shard dispatch of kernels/ops.py at the model's heads (every
    shard on the card) against one launch over the whole heads: decode
    rows of ~3,400 keys (several splits) and a 256-row prefill chunk after
    a 1,500-key prefix, bit for bit."""
    from repro_torch.kernels import ops
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    d = decode_case(torch, np, B=8, H=H, KV=KV, hd=hd, page=16, n_slots=220,
                    dtype=cfg.tdtype, seed=31,
                    rows=[[1700, 1700], [900, 33], [16], [3000, 400]] * 2)
    p = prefill_case(torch, np, B=2, H=H, KV=KV, hd=hd, page=16,
                     n_slots=120, Sq=256, dtype=cfg.tdtype, seed=32,
                     rows=[([1000, 500], 256), ([700], 100)])
    for tp in tps:
        mesh = one_card_mesh(tp)
        for name, case, fn in (("decode", d, ops.paged_decode_attention),
                               ("prefill", p, ops.paged_prefill_attention)):
            c = dict(case)
            whole = call(fn, c)
            for name_ in ("k_pages", "v_pages"):
                c[name_] = [t.contiguous() for t in case[name_].chunk(tp, 3)]
            layer, window = c.pop("layer"), c.pop("window")
            cap = c.pop("logit_cap")
            split = fn(*c.values(), layer, window, logit_cap=cap, mesh=mesh)
            same = torch.equal(split, whole)
            print(f"[{tag}] per-shard {name} tp {tp} ({H // tp} query / "
                  f"{KV // tp} KV heads a shard) against the whole heads: "
                  f"bit-identical {same}", flush=True)
            if not same:
                die(f"[{tag}] per-shard {name} at tp {tp} differs")


TIER_KEYS = ("hit_tokens_gpu", "hit_tokens_host", "hit_tokens_disk", "hits",
             "misses", "swap_out_bytes", "load_bytes")


def tp_serve(torch, cfg, params, corpus, idx, sub, args, tp, slabs):
    """One serve of ``sub`` at ``tp`` shards on the card, column-slab group
    ``slabs`` (on a constant clock), demotion of every cached node to the
    host tier, and the serve again; returns its results, tier figures,
    host copies, launches, plain calls, peak memory and ms a decode
    step."""
    from repro_torch.core.knowledge_tree import EvictionError
    from repro_torch.serving.config import EngineConfig, MeshConfig
    from repro_torch.serving.runtime import ContinuousRuntime
    econf = dataclasses.replace(EngineConfig.from_args(args),
                                mesh=MeshConfig(tp=tp))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with constant_clock():
        rt = ContinuousRuntime(cfg, params, corpus, idx, config=econf,
                               device="cuda", mesh=one_card_mesh(tp, slabs))
        res = rt.serve(sub, max_new_tokens=args.max_new_tokens)
        try:
            rt.tree.evict_gpu_until(lambda: False)
        except EvictionError:
            pass
        host = {n.path(): (n.payload_host["k"], n.payload_host["v"])
                for n in rt.tree.nodes() if n.payload_host is not None}
        again = [dataclasses.replace(r, req_id=r.req_id + 10**6)
                 for r in sub]
        res += rt.serve(again, max_new_tokens=args.max_new_tokens)
    torch.cuda.synchronize()
    launches, plain = read_counts()
    check_leak(rt)
    return dict(results=sorted(res, key=lambda r: r.req_id),
                tier={k: rt.tree.stats[k] for k in TIER_KEYS}, host=host,
                launches=launches, plain=plain,
                peak=torch.cuda.max_memory_allocated() - held,
                backend=type(rt.tree.backend).__name__, rt=rt)


def time_decode_steps(runs):
    """ms a decode step of each run's runtime (its warm-up step at
    max_batch rows: the weight products and launches of a step), host
    clock around a step that ends in a device synchronise; the runtimes
    take turns, TP_DECODE_REPS rounds, so host load falls on all alike."""
    for run in runs.values():
        for _ in range(3):
            run["rt"]._decode([])
    ts = {key: [] for key in runs}
    order = list(runs)
    for i in range(TP_DECODE_REPS):
        for key in (order if i % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            runs[key]["rt"]._decode([])
            ts[key].append(time.perf_counter() - t0)
    return {key: 1e3 * statistics.median(t) for key, t in ts.items()}


def phase_tp(torch, np, cfg, params, corpus, idx, wl, args, tps, full):
    """Tensor-parallel serving of ``cfg`` at each of ``tps``, every shard on
    the one card: tp N (its column-slab group G = N) against tp 1 of group
    N, bit for bit, and tp 1 of group 1 (the default serve) for its time
    and bits (TP_MODELS' note).  Returns the launches, decode ms and peak
    memory by run, where the plain column slice differs, and the wall."""
    t0 = time.perf_counter()
    tag = f"tp {cfg.name}"
    print(f"[{tag}] shards on one card (cuda:0 x tp): {cfg.n_layers} of "
          f"{full.n_layers} layers at full width, tp {tps}, each against "
          f"tp 1 of its column-slab group; {card_line(torch)}", flush=True)
    plain_diff = tp_probe(torch, cfg, params, tps, tag)
    tp_kernel_bits(torch, np, cfg, tps, tag)
    sub = wl[:TP_REQUESTS]
    plan = [("tp 1", 1, 1)]
    for tp in tps:
        plan += [(f"tp 1 G{tp}", 1, tp), (f"tp {tp}", tp, tp)]
    runs = {key: tp_serve(torch, cfg, params, corpus, idx, sub, args, tp, g)
            for key, tp, g in plan}
    for key, ms in time_decode_steps(runs).items():
        runs[key]["ms"] = ms
        del runs[key]["rt"]
    gc.collect()
    torch.cuda.empty_cache()
    one = runs["tp 1"]
    if one["tier"]["load_bytes"] <= 0 or one["tier"]["hit_tokens_host"] <= 0:
        die(f"[{tag}] the second serve promoted nothing from the host tier: "
            f"{one['tier']}")
    for key, run in runs.items():
        print(f"[{tag}] {key} ({run['backend']}): {run['ms']:.3f} ms a "
              f"decode step ({args.max_batch} rows, median of "
              f"{TP_DECODE_REPS} rounds); peak device memory "
              f"{run['peak']} B above what the earlier runs held; "
              f"launches {run['launches']}; plain calls {run['plain']}; "
              f"tiers {run['tier']}", flush=True)
        if run["plain"]:
            die(f"[{tag}] {key}: the plain versions ran {run['plain']} "
                f"times")
    for tp in tps:
        run, ref = runs[f"tp {tp}"], runs[f"tp 1 G{tp}"]
        for name in ("paged_decode_attention", "paged_prefill_attention"):
            if run["launches"][name] != tp * ref["launches"][name]:
                die(f"[{tag}] tp {tp}: {name} launched "
                    f"{run['launches'][name]} times, not {tp} x "
                    f"{ref['launches'][name]}")
        if run["tier"] != ref["tier"]:
            die(f"[{tag}] tp {tp} tier figures {run['tier']} != tp 1's "
                f"{ref['tier']}")
        diff = [a.req_id for a, b in zip(run["results"], ref["results"])
                if a.req_id != b.req_id or list(a.tokens) != list(b.tokens)
                or not np.array_equal(a.first_logits, b.first_logits)]
        if diff or len(run["results"]) != 2 * len(sub):
            die(f"[{tag}] tp {tp}: tokens or first-token logits differ from "
                f"tp 1's of group {tp} for requests {diff[:8]}")
        if run["host"].keys() != ref["host"].keys() or not all(
                torch.equal(x, y) for path in ref["host"]
                for x, y in zip(run["host"][path], ref["host"][path])):
            die(f"[{tag}] tp {tp}: host copies differ from tp 1's")
        same = sum(list(a.tokens) == list(b.tokens)
                   and np.array_equal(a.first_logits, b.first_logits)
                   for a, b in zip(ref["results"], one["results"]))
        print(f"[{tag}] tp {tp}: {len(run['results'])} results' tokens and "
              f"first-token logits, the tier figures and "
              f"{len(run['host'])} host copies bit-identical to tp 1's of "
              f"group {tp}; paged launches {tp} x its; tp 1 of group {tp} "
              f"against the default tp 1: {same}/{len(ref['results'])} "
              f"results bit-identical, tiers equal "
              f"{ref['tier'] == one['tier']}", flush=True)
    wall = time.perf_counter() - t0
    print(f"[{tag}] phase wall {wall:.1f}s", flush=True)
    return dict(launches={k: r["launches"] for k, r in runs.items()},
                ms={k: r["ms"] for k, r in runs.items()},
                peak={k: r["peak"] for k, r in runs.items()},
                default_differs=plain_diff, wall=wall)


def paper_argv(arch, n_requests, *extra):
    """serve.main's argv for a paper model at published width: the main
    configuration with the paper models' cache budgets."""
    argv = main_argv(n_requests, "--arch", arch, "--host-cache-bytes",
                     str(PAPER_HOST_BYTES), *extra)
    argv[argv.index("--gpu-cache-bytes") + 1] = str(PAPER_GPU_BYTES)
    return argv


def model_setup(torch, args, cfg, tag):
    """Seeded random weights of ``cfg`` on the card, and the data of
    ``args``: prints the shape, the weights' bytes, the init's peak above
    what was held before and the card's free memory after.  Returns
    (cfg, params, corpus, idx, wl)."""
    from repro_torch.launch import serve
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, params, corpus, idx, wl, _ = serve.make_setup(args, cfg=cfg)
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - held
    init_peak = torch.cuda.max_memory_allocated() - held
    free, total = torch.cuda.mem_get_info()
    kv = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * 2
    moe = (f"experts {cfg.moe_experts} (top {cfg.moe_top_k}, "
           f"{cfg.moe_impl}), " if cfg.moe_experts else "")
    print(f"[{tag}] {cfg.family}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} (R "
          f"{cfg.q_rep}), hd {cfg.hd}, d_ff {cfg.d_ff}, {moe}vocab "
          f"{cfg.vocab_size}, windows {sorted(set(cfg.layer_windows()))}, "
          f"{cfg.dtype}; {cfg.n_params()} params = {weights} B on the card, "
          f"init peak {init_peak} B above the {held} B held before; free "
          f"after the init {free} of {total} B; KV {kv} B a token; set-up "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return cfg, params, corpus, idx, wl


def model_serve(torch, np, tag, cfg, params, corpus, idx, wl, args):
    """The main serve of ``cfg`` (serve_main_path), its hit rates and tier
    hits, and its eps from the max |first-token logit| (paper_eps).
    Returns (results, figures)."""
    results, rt, launches, stats = serve_main_path(
        torch, np, tag, cfg, params, corpus, idx, wl, args)
    summ = rt.metrics.summary()
    top = max(float(np.max(np.abs(r.first_logits))) for r in results)
    eps = paper_eps(top)
    print(f"[{tag}] main serve: {stats[0]:.1f} tokens/s, TTFT p50 "
          f"{stats[1]:.1f} ms; doc hit rate {summ['doc_hit_rate']:.4f}, "
          f"tier hit tokens {summ['tier_hit_tokens']}; pool "
          f"{rt.store.pool.n_blocks} blocks = "
          f"{rt.store.pool.n_blocks * args.block_size} tokens", flush=True)
    print(f"[{tag}] max |first-token logit| {top:.4f}: eps {eps:g} "
          f"(LOGIT_EPS {LOGIT_EPS} x the bf16 ulp ratio)", flush=True)
    if not PAPER_EPS_RANGE[0] <= top < PAPER_EPS_RANGE[1]:
        print(f"[{tag}] note: max |logit| outside {PAPER_EPS_RANGE}, "
              f"where the rule was reckoned", flush=True)
    out = dict(stats=stats, doc_hit_rate=summ["doc_hit_rate"],
               tier=summ["tier_hit_tokens"], eps=eps, launches=launches,
               blocks=rt.store.pool.n_blocks)
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    return results, out


def phase_paper(torch, np, arch):
    """One paper model at full published width and PAPER_LAYERS layers,
    its weights the only ones on the card: (a) the main serve, (d) the row
    probe, the chunk split and the serve without the slab helper, (c)
    kernels against plain versions, (e) for Mistral-7B the window, the
    profile, then (b) continuous against sequential on 8 requests in this
    process (serve.main --full-size would load all 32 layers).  Returns
    its serve's figures and launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=PAPER_LAYERS[arch])
    argv = paper_argv(arch, 32)
    argv[argv.index("--gpu-cache-bytes") + 1] = str(
        PAPER_GPU_BYTES * cfg.n_layers // full.n_layers)
    args = serve.build_parser().parse_args(argv)
    cfg, params, corpus, idx, wl = model_setup(torch, args, cfg, arch)
    results, out = model_serve(torch, np, arch, cfg, params, corpus, idx,
                               wl, args)
    stats, eps = out["stats"], out["eps"]
    variant = phase_row_invariance(torch, cfg, params, tag=f"{arch} rows")
    phase_chunk_split(torch, np, cfg, params, corpus, idx, wl, args,
                      tag=f"{arch} chunk-split")
    if variant:
        die(f"[{arch}] row-variant with the helper: {variant}")
    phase_repair_cost(torch, cfg, params, corpus, idx, wl, args, stats,
                      tag=f"{arch} rows")
    phase_check(torch, np, cfg, params, corpus, idx, wl, args, results,
                n=4, eps=eps, tag=f"{arch} check")
    if arch == "mistral-7b":
        out["window"] = phase_window(
            torch, np, *first_layers(cfg, params, WINDOW_LAYERS), eps, full)
    if arch in TP_MODELS:
        out["tp"] = phase_tp(
            torch, np, *first_layers(cfg, params, TP_LAYERS[arch]), corpus,
            idx, wl, args, TP_MODELS[arch], full)
    phase_profile(torch, cfg, params, corpus, idx, wl, args,
                  tag=f"{arch} profile")
    out["seq"] = {"prefix_flash_attention": phase_seq_in_process(
        torch, np, cfg, params, corpus, idx, wl, args, eps, f"{arch} seq")}
    del params, results
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{arch}] phase wall {time.perf_counter() - t_phase:.1f}s",
          flush=True)
    return out


def phase_window(torch, np, cfg, params, eps, full):
    """Mistral-7B past its 4096-token window, through the layers of
    ``cfg`` (``full``: the published config): 4 requests of 4,401-4,478
    tokens in 512-token prefill chunks through the kernels, against the
    sequential engine and against the plain versions."""
    from repro_torch.launch import serve
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import RAGServer
    from repro_torch.serving.runtime import ContinuousRuntime
    tier = PAPER_GPU_BYTES * cfg.n_layers // full.n_layers
    tag = f"{cfg.name} window"
    t0 = time.perf_counter()
    args = serve.build_parser().parse_args(paper_argv(
        cfg.name, 4, *WINDOW_ARGV, "--gpu-cache-bytes", str(tier)))
    corpus, idx, wl, _ = serve.make_data(args, cfg)
    econf = EngineConfig.from_args(args)
    rt = ContinuousRuntime(cfg, params, corpus, idx, config=econf,
                           device="cuda")
    reset_counts()
    res = rt.serve(wl, max_new_tokens=args.max_new_tokens)
    torch.cuda.synchronize()
    launches, plain = read_counts()
    lens = [sum(int(corpus.doc_lengths[d]) for d in r.docs)
            + len(wq.question_tokens) + len(r.tokens)
            for r, wq in zip(res, sorted(wl, key=lambda w: w.req_id))]
    window = max(cfg.layer_windows())
    print(f"[{tag}] {cfg.n_layers} layers, pool {rt.store.pool.n_blocks} "
          f"blocks; {len(res)} requests, sequences of {lens} tokens "
          f"(longest {max(lens)}, window {window}); table entries "
          f"{rt._n_tbl}; launches {launches}; plain-version calls {plain}",
          flush=True)
    if len(res) != len(wl) or any(len(r.tokens) != args.max_new_tokens
                                  for r in res):
        die(f"[{tag}] not every request was served in full")
    if min(lens) <= window:
        die(f"[{tag}] a sequence of {min(lens)} tokens: the window does not "
            f"bind")
    if min(launches["paged_decode_attention"],
           launches["paged_prefill_attention"]) <= 0 or plain:
        die(f"[{tag}] launches {launches}, plain calls {plain}")
    check_leak(rt)
    del rt
    with recording_margins():
        srv = RAGServer(cfg, params, corpus, idx, config=econf,
                        device="cuda")
        seq = {r.req_id: r for r in
               srv.serve(wl, max_new_tokens=args.max_new_tokens)}
        del srv
        gc.collect()
        rt = ContinuousRuntime(cfg, params, corpus, idx,
                               config=dataclasses.replace(
                                   econf, attn_impl="torch"), device="cuda")
        plain_res = rt.serve(wl, max_new_tokens=args.max_new_tokens)
        del rt
    against = "the kernels' serve"
    compare_logits(np, f"{tag} sequential", list(seq.values()), res, eps,
                   against)
    check_flips(f"{tag} vs sequential", [(a, seq[a.req_id]) for a in res],
                eps)
    compare_logits(np, f"{tag} plain", plain_res, res, eps, against)
    by_id = {r.req_id: r for r in res}
    check_flips(f"{tag} kernels vs plain",
                [(by_id[b.req_id], b) for b in plain_res], eps)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[{tag}] wall {time.perf_counter() - t0:.1f}s", flush=True)
    return dict(longest=max(lens), decode=launches["paged_decode_attention"],
                prefill=launches["paged_prefill_attention"])


def phase_seq_in_process(torch, np, cfg, params, corpus, idx, wl, args,
                         eps, tag):
    """What serve.main --check-tokens tol:<eps> does, on the weights
    already on the card: the first 8 requests through a fresh continuous
    runtime, then through the sequential RAGServer (the prefix kernel),
    tokens equal or first-token logits within eps, and no flip above eps.
    Returns the sequential engine's prefix-kernel launches."""
    from repro_torch.launch import serve
    sub = sorted(wl, key=lambda r: r.req_id)[:8]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    routes = {}
    with recording_margins() as pairs:
        with contextlib.redirect_stdout(io.StringIO()), \
                pinned_routes(routes, replay=False):
            cont, rts = serve.serve_continuous(cfg, params, corpus, idx,
                                               sub, args)
        del rts
        gc.collect()
        torch.cuda.empty_cache()
        reset_counts()
        with contextlib.redirect_stdout(io.StringIO()), \
                pinned_routes(routes, replay=True) as pin:
            seq, srv = serve.serve_sequential(cfg, params, corpus, idx, sub,
                                              args)
        torch.cuda.synchronize()
        del srv
        launches, plain = read_counts()
        bad = serve.token_mismatches(zip(cont, seq), "tol", eps)
    gc.collect()
    torch.cuda.empty_cache()
    pins = (f" with the continuous run's routes pinned ({pin['pinned']} of "
            f"{pin['rows']} routed rows, {pin['changed']} of them routed "
            f"otherwise by the sequential run's own logits)"
            if cfg.moe_experts else "")
    print(f"[{tag}] {len(sub)} requests, continuous then sequential"
          f"{pins}, in {time.perf_counter() - t0:.1f}s; sequential "
          f"launches {launches}, plain-version calls {plain}", flush=True)
    if pin["pinned"] < pin["rows"] // 2:
        die(f"[{tag}] too few rows pinned: {pin}")
    compare_logits(np, tag, cont, seq, eps,
                   "the sequential engine" + (", routes pinned"
                                              if cfg.moe_experts else ""))
    if bad:
        die(f"[{tag}] continuous and sequential disagree past tol {eps}: "
            f"{bad}")
    check_flips(tag, pairs, eps)
    if launches["prefix_flash_attention"] <= 0 or plain:
        die(f"[{tag}] sequential path: launches {launches}, plain calls "
            f"{plain}")
    return launches["prefix_flash_attention"]


def phase_capacity(torch, np, cfg, params, tag):
    """moe_capacity against moe_dense on CAPACITY_ROWS rows through layer
    0's router and experts at full width.  The rows share one random
    direction, which skews the router so that some experts overflow their
    buffers.  Prints the expert loads, the rows the capacity dropped (for
    one expert or both) and each function's time; the rows kept for both
    their experts must agree within CAPACITY_TOL x their max |dense|."""
    from repro_torch.models import layers as L
    gc.collect()
    torch.cuda.empty_cache()
    p = {k: w[0] for k, w in params["blocks"].items()}
    E, k = cfg.moe_experts, cfg.moe_top_k
    gen = torch.Generator(device="cuda").manual_seed(7)
    shared = torch.randn((cfg.d_model,), generator=gen, device="cuda")
    x = torch.randn((1, CAPACITY_ROWS, cfg.d_model), generator=gen,
                    device="cuda")
    x = (x + shared).to(cfg.tdtype)
    ws = (p["router"], p["wg"], p["wu"], p["wd"])
    dense = L.moe_dense(x, *ws, k)[0].float()
    capped = L.moe_capacity(x, *ws, k)[0].float()
    # moe_capacity's defaults: one chunk of CAPACITY_ROWS tokens, factor
    # 1.25
    cap = max(int(1.25 * CAPACITY_ROWS * k / E), 1)
    _, topi = L.route(x[0], p["router"], k)
    _, _, keep = L.capacity_slots(topi, E, cap)
    kept = keep.any(dim=-1).all(dim=-1)                     # (rows,)
    loads = torch.bincount(topi.flatten(), minlength=E).tolist()
    n_kept = int(kept.sum())
    if not n_kept or not (torch.isfinite(dense).all()
                          and torch.isfinite(capped).all()):
        die(f"[{tag}] no row kept both experts, or outputs not finite")
    err = float((capped - dense).abs()[kept].max())
    scale = float(dense.abs()[kept].max())
    dense_ms = time_ms(torch, lambda: L.moe_dense(x, *ws, k), reps=5,
                       warm=1)
    cap_ms = time_ms(torch, lambda: L.moe_capacity(x, *ws, k), reps=5,
                     warm=1)
    print(f"[{tag}] moe_capacity vs moe_dense, {CAPACITY_ROWS} rows, layer "
          f"0: expert loads {loads} (capacity {cap} each); rows dropped for "
          f"an expert {CAPACITY_ROWS - n_kept}, kept for both {n_kept}; "
          f"max |capacity - dense| over the kept rows {err:.4e} (tol "
          f"{CAPACITY_TOL:g} x max |dense| {scale:.4e} = "
          f"{CAPACITY_TOL * scale:.4e}); moe_dense {dense_ms:.3f} ms, "
          f"moe_capacity {cap_ms:.3f} ms", flush=True)
    if err > CAPACITY_TOL * scale:
        die(f"[{tag}] moe_capacity disagrees with moe_dense on the rows it "
            f"kept: {err} > {CAPACITY_TOL * scale}")
    return dict(dropped=CAPACITY_ROWS - n_kept, err=err, dense_ms=dense_ms,
                capacity_ms=cap_ms)


def phase_moe(torch, np, arch=MOE_ARCH, layers=MOE_LAYERS, full=True):
    """A MoE model at full published width and ``layers`` layers, its
    weights the only ones on the card: (a) the main serve, (d) the row
    probe (router and expert products included) and the chunk split, (c)
    kernels against plain versions and continuous against sequential in
    this process, routes pinned, and the profile with the experts' share;
    with ``full`` (Mixtral) also moe_capacity against moe_dense and the
    tensor-parallel runs.  Returns its figures and launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    tag = arch
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    # the tier's 4,032 blocks of the model's KV (MOE_GPU_BYTES at
    # Mixtral's heads and depth)
    gpu_bytes = 4032 * 16 * 2 * cfg.n_kv_heads * cfg.hd * 2 * layers
    argv = paper_argv(arch, 32)
    argv[argv.index("--gpu-cache-bytes") + 1] = str(gpu_bytes)
    args = serve.build_parser().parse_args(argv)
    cfg, params, corpus, idx, wl = model_setup(torch, args, cfg, tag)
    results, out = model_serve(torch, np, tag, cfg, params, corpus, idx,
                               wl, args)
    out["gpu_bytes"] = gpu_bytes
    eps = out["eps"]
    variant = phase_row_invariance(torch, cfg, params, tag=f"{tag} rows")
    if variant:
        die(f"[{tag}] row-variant with the helper: {variant}")
    phase_chunk_split(torch, np, cfg, params, corpus, idx, wl, args,
                      tag=f"{tag} chunk-split")
    eps, out["pinned"] = phase_pinned_check(torch, np, cfg, params, corpus,
                                            idx, wl, args, eps,
                                            f"{tag} check")
    out["moe_eps"] = eps
    if full:
        out["capacity"] = phase_capacity(torch, np, cfg, params,
                                         f"{tag} capacity")
    out["seq"] = phase_seq_in_process(torch, np, cfg, params, corpus, idx,
                                      wl, args, eps, f"{tag} seq")
    if full:
        out["tp"] = phase_tp(
            torch, np, *first_layers(cfg, params, TP_LAYERS[arch]), corpus,
            idx, wl, args, TP_MODELS[arch], get_config(arch))
    phase_profile(torch, cfg, params, corpus, idx, wl, args,
                  tag=f"{tag} profile")
    del params, results
    gc.collect()
    torch.cuda.empty_cache()
    out["wall"] = time.perf_counter() - t_phase
    print(f"[{tag}] phase wall {out['wall']:.1f}s", flush=True)
    return out


def phase_patch_prefill(torch, np, cfg, params, eps, tag):
    """One dense prefill of 2 rows, each the model's vision_tokens random
    patch embeddings ahead of 256 tokens, through the prefix kernel and
    through the plain version: last-position logits within eps."""
    from repro_torch.models import model as M
    gen = torch.Generator(device="cuda").manual_seed(11)
    B, S, P = 2, 256, cfg.vision_tokens
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device="cuda")
    pe = torch.randn((B, P, cfg.d_model), generator=gen, device="cuda")
    reset_counts()
    got, cache = M.prefill(cfg, params, toks, patch_embeds=pe)
    torch.cuda.synchronize()
    launches, plain = read_counts()
    want, _ = M.prefill(cfg, params, toks, patch_embeds=pe,
                        attn_impl="torch")
    text, _ = M.prefill(cfg, params, toks)
    linf = float((got - want).abs().max())
    moved = float((got - text).abs().max())
    print(f"[{tag}] prefill of {P} patches + {S} tokens x {B} rows: cache "
          f"{tuple(cache['k'].shape)}; launches {launches}, plain-version "
          f"calls {plain}; kernel vs plain logits max L-inf {linf:.4e} "
          f"(eps {eps:g}); the patches move the logits by {moved:.4e}",
          flush=True)
    if cache["k"].shape[2] != P + S or not torch.isfinite(got).all():
        die(f"[{tag}] the cache does not cover patches and tokens, or the "
            f"logits are not finite")
    if launches["prefix_flash_attention"] != cfg.n_layers or plain:
        die(f"[{tag}] launches {launches}, plain calls {plain}")
    if linf > eps:
        die(f"[{tag}] kernel and plain prefill disagree: {linf} > {eps}")
    return launches["prefix_flash_attention"]


def phase_vlm(torch, np):
    """InternVL2-1B at full published width, its text backbone on the main
    trace (Qwen's corpus, requests and tiers): the main serve, the chunk
    split, 4 requests through the plain versions, and one prefill with its
    patch embeddings.  Returns its figures and launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    tag = VLM_ARCH
    args = serve.build_parser().parse_args(MAIN_ARGV)
    cfg = dataclasses.replace(get_config(VLM_ARCH), n_layers=VLM_LAYERS)
    cfg, params, corpus, idx, wl = model_setup(torch, args, cfg, tag)
    results, out = model_serve(torch, np, tag, cfg, params, corpus, idx,
                               wl, args)
    eps = out["eps"]
    phase_chunk_split(torch, np, cfg, params, corpus, idx, wl, args,
                      tag=f"{tag} chunk-split")
    phase_check(torch, np, cfg, params, corpus, idx, wl, args, results,
                n=4, eps=eps, tag=f"{tag} check")
    out["patches"] = phase_patch_prefill(torch, np, cfg, params, eps,
                                         f"{tag} patches")
    del params, results
    gc.collect()
    torch.cuda.empty_cache()
    out["wall"] = time.perf_counter() - t_phase
    print(f"[{tag}] phase wall {out['wall']:.1f}s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phases 18-20: the recurrent and audio families
# ---------------------------------------------------------------------------

def tensor_sum(torch, t):
    """A checksum of a tensor's bits, computed on the card: the sum of its
    elements' bit patterns (as integers of their width) weighted by (index
    mod 65521) + 1, in int64 (wrapping), over 2**25-element slices."""
    ints = {4: torch.int32, 2: torch.int16, 1: torch.uint8}
    flat = t.detach().reshape(-1).view(ints[t.element_size()])
    total, step = 0, 1 << 25
    for i in range(0, flat.numel(), step):
        part = flat[i:i + step].to("cuda", non_blocking=True).long()
        w = torch.arange(i, i + part.numel(), device="cuda") % 65521 + 1
        total += int((part * w).sum())
    return total


def payload_sums(torch, payload):
    """The checksums of a nested payload's tensors, in tree order."""
    if isinstance(payload, dict):
        return tuple(payload_sums(torch, payload[k]) for k in sorted(payload))
    if isinstance(payload, (tuple, list)):
        return tuple(payload_sums(torch, v) for v in payload)
    return None if payload is None else tensor_sum(torch, payload)


def payload_bytes(payload):
    if isinstance(payload, dict):
        return sum(payload_bytes(v) for v in payload.values())
    if isinstance(payload, (tuple, list)):
        return sum(payload_bytes(v) for v in payload)
    return 0 if payload is None else payload.numel() * payload.element_size()


def snapshot_sums(torch, tree):
    """{(node id, tier): checksums} of every GPU- and host-tier payload."""
    out = {}
    for n in tree.nodes():
        if n is tree.root:
            continue
        if n.in_gpu and n.payload_gpu is not None:
            out[(id(n), "gpu")] = payload_sums(torch, n.payload_gpu)
        if n.in_host and n.payload_host is not None:
            out[(id(n), "host")] = payload_sums(torch, n.payload_host)
    return out


def tier_line(tree):
    """Billed and real bytes of the GPU and host tiers."""
    parts = []
    for tier, held in (("gpu", lambda n: n.in_gpu and n.payload_gpu),
                       ("host", lambda n: n.in_host and n.payload_host)):
        nodes = [n for n in tree.nodes() if n is not tree.root and held(n)]
        real = sum(payload_bytes(held(n)) for n in nodes)
        billed = sum(n.bytes_ for n in nodes)
        parts.append(f"{tier} {len(nodes)} nodes, billed {billed} B, real "
                     f"{real} B")
    return "; ".join(parts)


def recurrent_argv(arch, bytes_per_token):
    """The main configuration for a recurrent family, its tiers sized in
    billed bytes (TIER_TOKENS)."""
    argv = main_argv(32, "--arch", arch)
    argv[argv.index("--gpu-cache-bytes") + 1] = \
        str(TIER_TOKENS[0] * bytes_per_token)
    return argv + ["--host-cache-bytes", str(TIER_TOKENS[1]
                                             * bytes_per_token)]


def recurrent_serve(torch, np, tag, cfg, params, corpus, idx, wl, args,
                    attn_impl=None):
    """The first RECURRENT_REQUESTS requests through the sequential
    RAGServer (cold), then WARM_REQUESTS of them whose docs are all cached,
    one through the host tier (warm): the warm tokens and first-token
    logits must equal the cold ones bit for bit, a host-tier snapshot must
    come back, and no snapshot the tree held may change (checksums before
    and after the warm pass).  Returns (cold results, launches of the cold
    serve, figures)."""
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import RAGServer
    sub = sorted(wl, key=lambda r: r.req_id)[:RECURRENT_REQUESTS]
    econf = dataclasses.replace(EngineConfig.from_args(args),
                                attn_impl=attn_impl)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    srv = RAGServer(cfg, params, corpus, idx, config=econf, device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    cold = {r.req_id: r for r in
            srv.serve(sub, max_new_tokens=args.max_new_tokens)}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = read_counts()
    tree = srv.tree
    n_tok = sum(len(r.tokens) for r in cold.values())
    print(f"[{tag}] cold: {len(cold)} requests, {n_tok} tokens in "
          f"{wall:.2f}s wall = {n_tok / wall:.2f} tokens/s; mean TTFT "
          f"{1e3 * np.mean([r.ttft for r in cold.values()]):.1f} ms; peak "
          f"device memory {torch.cuda.max_memory_allocated()} B; launches "
          f"{launches}; plain-version calls {plain}", flush=True)
    print(f"[{tag}] tiers after the cold serve: {tier_line(tree)}; "
          f"budgets gpu {econf.gpu_cache_bytes} B, host "
          f"{econf.host_cache_bytes} B (billed); swapped out "
          f"{tree.stats['swap_out_bytes']} B billed", flush=True)
    if len(cold) != len(sub) or any(len(r.tokens) != args.max_new_tokens
                                    for r in cold.values()):
        die(f"[{tag}] not every request was served in full")
    for r in cold.values():
        fl = r.first_logits
        if fl is None or fl.shape != (cfg.vocab_size,) \
                or not np.isfinite(fl).all():
            die(f"[{tag}] request {r.req_id}: first-token logits missing, "
                f"misshapen or not finite")
    # warm: requests whose every doc is cached, served one at a time, the
    # one cached through the host tier last (its promotion evicts GPU
    # nodes, which could drop another warm request's host copy)
    full, host = [], []
    for r in sub:
        path = tree.match_prefix(cold[r.req_id].docs)
        if len(path) == len(cold[r.req_id].docs):
            (host if any(not n.in_gpu for n in path) else full).append(r)
    warm_sub = full[:WARM_REQUESTS - 1] + host[:1]
    if len(warm_sub) < WARM_REQUESTS or not host:
        die(f"[{tag}] {len(full)} requests cached on the GPU tier and "
            f"{len(host)} through the host tier: no warm set")
    before = snapshot_sums(torch, tree)
    loads = tree.stats["load_bytes"]
    t0 = time.perf_counter()
    warm = [res for r in warm_sub
            for res in srv.serve([r], max_new_tokens=args.max_new_tokens)]
    torch.cuda.synchronize()
    warm_wall = time.perf_counter() - t0
    after = snapshot_sums(torch, tree)
    common = sorted(before.keys() & after.keys())
    changed = [k for k in common if before[k] != after[k]]
    same = [np.array_equal(r.first_logits, cold[r.req_id].first_logits)
            and r.tokens == cold[r.req_id].tokens for r in warm]
    alphas = [(r.alpha, r.beta) for r in warm]
    print(f"[{tag}] warm: requests {[r.req_id for r in warm_sub]} "
          f"({len(host)} of the cold set cached through the host tier) in "
          f"{warm_wall:.2f}s; (alpha, beta) {alphas}; promoted "
          f"{tree.stats['load_bytes'] - loads} B billed back from the host "
          f"tier; tokens and first-token logits bit-identical to the cold "
          f"serve for {sum(same)}/{len(warm)}; snapshot checksums compared "
          f"{len(common)} (of {len(before)} before, {len(after)} after), "
          f"changed {len(changed)}", flush=True)
    print(f"[{tag}] tiers after the warm serve: {tier_line(tree)}",
          flush=True)
    if tree.stats["load_bytes"] <= loads:
        die(f"[{tag}] no snapshot came back from the host tier")
    if not all(same):
        die(f"[{tag}] warm hits differ from the cold serve: {same}")
    if any(a != sum(int(corpus.doc_lengths[d]) for d in r.docs)
           for (a, _), r in zip(alphas, warm)):
        die(f"[{tag}] a warm request missed the tree: {alphas}")
    if not common or changed:
        die(f"[{tag}] snapshots changed across the warm hits: {changed}")
    out = dict(wall=wall, tokens_per_s=n_tok / wall,
               peak=torch.cuda.max_memory_allocated(), launches=launches,
               plain=plain, warm=[r.req_id for r in warm_sub],
               compared=len(common))
    del srv, tree
    gc.collect()
    torch.cuda.empty_cache()
    return list(cold.values()), launches, out


def model_setup_only(torch, cfg, tag):
    """Seeded random weights of ``cfg`` on the card (the serve's seed), and
    their bytes and init peak."""
    from repro_torch.models import model as M
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, 0, "cuda")
    torch.cuda.synchronize()
    weights = torch.cuda.memory_allocated() - held
    print(f"[{tag}] {cfg.family}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}, hd "
          f"{cfg.hd}, d_ff {cfg.d_ff}, {cfg.n_codebooks} codebooks of "
          f"{cfg.vocab_size}, {cfg.dtype}; weights {weights} B on the card, "
          f"init peak {torch.cuda.max_memory_allocated() - held} B above "
          f"the {held} B held before; set-up "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    return params


def phase_mlstm_forms(torch, cfg, tag):
    """mlstm_chunkwise against mlstm_scan on one full-width mLSTM layer
    (its heads and head dim) over MLSTM_TOKENS tokens of f32 inputs, forget
    gates around 0 (log f ~ -0.69 a step: the reference's chunkwise form
    overflows there, the port's must not)."""
    from repro_torch.models import layers as L
    Dp = int(cfg.proj_factor * cfg.d_model)
    H, hd = cfg.n_heads, Dp // cfg.n_heads
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((1, MLSTM_TOKENS, H, hd), generator=gen,
                           device="cuda") for _ in range(3))
    ig, fg = (torch.randn((1, MLSTM_TOKENS, H), generator=gen,
                          device="cuda") for _ in range(2))
    t0 = time.perf_counter()
    hc, sc = L.mlstm_chunkwise(q, k, v, ig, fg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hs, ss = L.mlstm_scan(q, k, v, ig, fg)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    top = float(hs.abs().max())
    err = float((hc - hs).abs().max())
    st = [float((a - b).abs().max()) for a, b in zip(sc, ss)]
    finite = bool(torch.isfinite(hc).all() and torch.isfinite(hs).all())
    print(f"[{tag}] mlstm_chunkwise vs mlstm_scan, (1, {MLSTM_TOKENS}, {H}, "
          f"{hd}) f32: max |h| {top:.4f}, max |chunkwise - recurrent| "
          f"{err:.4e} = {err / top:.3e} of it (tol {MLSTM_TOL:g}); final "
          f"state (C, n, m) max diffs {', '.join(f'{x:.3e}' for x in st)}; "
          f"finite {finite}; chunkwise {1e3 * (t1 - t0):.1f} ms, recurrent "
          f"{1e3 * (t2 - t1):.1f} ms (host clock)", flush=True)
    if not finite or err > MLSTM_TOL * max(1.0, top):
        die(f"[{tag}] chunkwise and recurrent mLSTM disagree: {err} (max "
            f"|h| {top})")
    return err / top


def mlstm_row_ops(torch, cfg, params):
    """The row probe's ops of an mLSTM block's products, through
    layers.proj at the model's widths: w_up (D -> 2 Dp), wq / wk / wv (Dp
    -> Dp) and w_down (Dp -> D)."""
    from repro_torch.models import layers as L
    blk = params["blocks"]["mlstm"]

    def first(w):
        while w.dim() > 2:
            w = w[0]
        return w

    gen = torch.Generator(device="cuda").manual_seed(5)
    n = max(PROBE_ROWS)
    Dp = int(cfg.proj_factor * cfg.d_model)
    x, xp = (torch.randn((n, d), generator=gen, device="cuda")
             .to(cfg.tdtype) for d in (cfg.d_model, Dp))
    ops = []
    for name, inp in (("w_up", x), ("wq", xp), ("wk", xp), ("wv", xp),
                      ("w_down", xp)):
        w = first(blk[name])
        ops.append((f"proj {name} (K {w.shape[0]}, N {w.shape[1]}"
                    f"{', slabbed' if L.slabbed(w) else ''})", inp,
                    lambda t, w=w: L.proj(t, w)))
    return ops


def phase_xlstm(torch, np):
    """Phase 18: xLSTM-1.3B at full published width and RECURRENT_LAYERS
    depth, its weights the only ones on the card: the cold and warm
    serves through the sequential engine with its state snapshots in the
    tree, and the two mLSTM forms on one full-width layer."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    t_phase = time.perf_counter()
    tag = XLSTM_ARCH
    cfg = dataclasses.replace(get_config(XLSTM_ARCH),
                              n_layers=RECURRENT_LAYERS[XLSTM_ARCH])
    args = serve.build_parser().parse_args(recurrent_argv(XLSTM_ARCH, 4))
    params = model_setup_only(torch, cfg, tag)
    corpus, idx, wl, _ = serve.make_data(args, cfg)
    snap = payload_bytes(M.init_decode_cache(cfg, 1, 0, device="meta"))
    print(f"[{tag}] a state snapshot: {snap} B real, billed 4 B a token",
          flush=True)
    _, _, out = recurrent_serve(torch, np, tag, cfg, params, corpus, idx,
                                wl, args)
    out["snapshot"] = snap
    out["mlstm_rel"] = phase_mlstm_forms(torch, cfg, f"{tag} mlstm")
    variant = probe_rows(torch, mlstm_row_ops(torch, cfg, params),
                         f"{tag} rows", cfg.name)
    if variant:
        die(f"[{tag}] row-variant with the helper: {variant}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_wall"] = time.perf_counter() - t_phase
    print(f"[{tag}] phase wall {out['phase_wall']:.1f}s", flush=True)
    return out


def f32_params(params):
    return {k: f32_params(v) if isinstance(v, dict) else v.float()
            for k, v in params.items()}


def phase_hybrid(torch, np):
    """Phase 19: Hymba-1.5B at full published width and RECURRENT_LAYERS
    depth: the cold and warm serves through the sequential engine on the
    prefix kernel (R 5), the same cold requests through the plain
    versions and through the plain versions in f32.  The kernels' serve
    must lie within eps of the plain versions' and of the f32 serve, with
    no flip above eps, where eps = max(paper_eps, 2 x the bf16 floor) and
    the floor is the plain versions' own distance from the f32 serve:
    this model's bf16 rounding moves its first-token logits further than
    paper_eps (see HYBRID_ARCH)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    tag = HYBRID_ARCH
    cfg = dataclasses.replace(get_config(HYBRID_ARCH),
                              n_layers=RECURRENT_LAYERS[HYBRID_ARCH])
    kv = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * cfg.tdtype.itemsize
    args = serve.build_parser().parse_args(recurrent_argv(HYBRID_ARCH, kv))
    params = model_setup_only(torch, cfg, tag)
    corpus, idx, wl, _ = serve.make_data(args, cfg)
    ssm = cfg.n_layers * cfg.n_heads * cfg.hd * cfg.ssm_state * 4
    print(f"[{tag}] K/V {kv} B a token (billed); SSM state {ssm} B a "
          f"snapshot (not billed)", flush=True)
    with recording_margins():
        cold, launches, out = recurrent_serve(
            torch, np, tag, cfg, params, corpus, idx, wl, args)
        if launches["prefix_flash_attention"] <= 0 or out["plain"]:
            die(f"[{tag}] the serve did not run on the prefix kernel: "
                f"{launches}, plain calls {out['plain']}")
        top = max(float(np.max(np.abs(r.first_logits))) for r in cold)
        p_eps = paper_eps(top)
        reset_counts()
        plain, plain_launches, _ = recurrent_serve(
            torch, np, f"{tag} plain", cfg, params, corpus, idx, wl, args,
            attn_impl="torch")
        if any(plain_launches.values()):
            die(f"[{tag}] the plain-version serve launched a kernel: "
                f"{plain_launches}")
        exact = serve_f32(torch, cfg, params, corpus, idx, wl, args,
                          "torch")
    f32_kernels = serve_f32(torch, cfg, params, corpus, idx, wl, args, None)
    by_id = {r.req_id: r for r in cold}
    f32_err = max_linf(np, f32_kernels, exact)
    print(f"[{tag}] in f32, the kernels' serve vs the plain versions': "
          f"first-token max L-inf {f32_err:.4e} (tol {HYBRID_F32_TOL:g})",
          flush=True)
    if f32_err > HYBRID_F32_TOL:
        die(f"[{tag}] in f32 the kernels' serve is {f32_err} from the "
            f"plain versions'")
    floor = max_linf(np, plain, exact)
    eps = max(p_eps, 2 * floor)
    print(f"[{tag}] max |first-token logit| {top:.4f}: paper_eps {p_eps:g}; "
          f"first-token L-inf against the f32 plain serve: plain "
          f"versions (bf16) {floor:.4e}, kernels {max_linf(np, cold, exact):.4e}"
          f"; kernels vs plain {max_linf(np, cold, plain):.4e}; eps = max("
          f"paper_eps, 2 x {floor:.4e}) = {eps:.4f}", flush=True)
    compare_logits(np, f"{tag} plain", plain, cold, eps,
                   "the kernels' serve")
    check_flips(f"{tag} kernels vs plain",
                [(by_id[b.req_id], b) for b in plain], eps)
    compare_logits(np, f"{tag} f32", exact, cold, eps, "the kernels' serve")
    check_flips(f"{tag} kernels vs f32",
                [(by_id[b.req_id], b) for b in exact], eps)
    out.update(paper_eps=p_eps, floor=floor, f32_err=f32_err,
               plain_linf=max_linf(np, cold, plain),
               f32_linf=max_linf(np, cold, exact))
    out["eps"] = eps
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_wall"] = time.perf_counter() - t_phase
    print(f"[{tag}] phase wall {out['phase_wall']:.1f}s", flush=True)
    return out


def max_linf(np, got, want):
    """The largest first-token L-inf between two serves' results."""
    by_id = {r.req_id: r for r in want}
    return max(float(np.max(np.abs(
        a.first_logits.astype(np.float64)
        - by_id[a.req_id].first_logits.astype(np.float64)))) for a in got)


def serve_f32(torch, cfg, params, corpus, idx, wl, args, attn_impl):
    """The cold requests of recurrent_serve in f32 (weights and
    activations; the same seeded bf16 weights, widened), through the
    kernels (attn_impl None) or the plain versions ("torch")."""
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.engine import RAGServer
    sub = sorted(wl, key=lambda r: r.req_id)[:RECURRENT_REQUESTS]
    econf = dataclasses.replace(EngineConfig.from_args(args),
                                attn_impl=attn_impl)
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    t0 = time.perf_counter()
    srv = RAGServer(dataclasses.replace(cfg, dtype="float32"),
                    f32_params(params), corpus, idx, config=econf,
                    device="cuda")
    res = srv.serve(sub, max_new_tokens=args.max_new_tokens)
    torch.cuda.synchronize()
    launches, plain = read_counts()
    print(f"[{cfg.name} f32] {len(res)} requests in f32 through the "
          f"{'plain versions' if attn_impl else 'kernels'} in "
          f"{time.perf_counter() - t0:.1f}s; launches {launches}, "
          f"plain-version calls {plain}", flush=True)
    if bool(attn_impl) != bool(plain) or bool(attn_impl) == bool(
            launches["prefix_flash_attention"]):
        die(f"[{cfg.name} f32] the serve ran the wrong attention: "
            f"{launches}, plain calls {plain}")
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_audio(torch, np):
    """Phase 20: MusicGen-large's model steps at full published width on
    codebook tokens: a prefill of (2, 4, AUDIO_TOKENS) through the prefix
    kernel and through the plain version, AUDIO_STEPS decode steps over
    each one's cache, and the prefill as half cached + half new against
    the whole: logits within paper_eps."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    t_phase = time.perf_counter()
    tag = AUDIO_ARCH
    cfg = get_config(AUDIO_ARCH)
    params = model_setup_only(torch, cfg, tag)
    K, B, S = cfg.n_codebooks, 2, AUDIO_TOKENS
    gen = torch.Generator(device="cuda").manual_seed(12)
    toks = torch.randint(0, cfg.vocab_size, (B, K, S), generator=gen,
                         device="cuda")
    steps = torch.randint(0, cfg.vocab_size, (AUDIO_STEPS, B, K, 1),
                          generator=gen, device="cuda")
    reset_counts()
    got, cache = M.prefill(cfg, params, toks)
    torch.cuda.synchronize()
    launches, plain = read_counts()
    want, pcache = M.prefill(cfg, params, toks, attn_impl="torch")
    if tuple(got.shape) != (B, 1, K, cfg.vocab_size) \
            or not torch.isfinite(got).all():
        die(f"[{tag}] prefill logits {tuple(got.shape)} misshapen or not "
            f"finite")
    if launches["prefix_flash_attention"] != cfg.n_layers or plain:
        die(f"[{tag}] prefill launches {launches}, plain calls {plain}")
    top = float(got.abs().max())
    eps = paper_eps(top)
    errs = [float((got - want).abs().max())]

    def decode(c):
        dc = M.init_decode_cache(cfg, B, S + AUDIO_STEPS, device="cuda")
        dc["k"][:, :, :S], dc["v"][:, :, :S] = c["k"], c["v"]
        pos = torch.full((B,), S, dtype=torch.int32, device="cuda")
        out = []
        for t in range(AUDIO_STEPS):
            pos = pos + 1
            out.append(M.decode_step(cfg, params, steps[t], dc, pos))
        return out

    for a, b in zip(decode(cache), decode(pcache)):
        if not torch.isfinite(a).all():
            die(f"[{tag}] decode logits not finite")
        errs.append(float((a - b).abs().max()))
    del cache, pcache
    half = S // 2
    _, doc = M.prefill(cfg, params, toks[..., :half])
    cached, _ = M.prefill(cfg, params, toks[..., half:], doc, half)
    split = float((cached - got).abs().max())
    bitwise = bool(torch.equal(cached, got))
    print(f"[{tag}] prefill (B, K, S) = {(B, K, S)}: launches {launches}; "
          f"max |logit| {top:.4f}, eps {eps:g}; kernel vs plain max L-inf: "
          f"prefill {errs[0]:.4e}, decode steps "
          f"{', '.join(f'{e:.3e}' for e in errs[1:])}; {half} cached + "
          f"{S - half} new vs the whole prefill: max L-inf {split:.4e}, "
          f"bit-identical {bitwise}", flush=True)
    if max(errs) > eps:
        die(f"[{tag}] kernel and plain disagree past eps {eps}: {errs}")
    if split > eps:
        die(f"[{tag}] the prefix-cached prefill differs from the whole: "
            f"{split}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"[{tag}] phase wall {wall:.1f}s", flush=True)
    return dict(launches=launches["prefix_flash_attention"], eps=eps,
                err=max(errs), split=split, bitwise=bitwise,
                phase_wall=wall)


# ---------------------------------------------------------------------------
# phases 21-23: the rest of the dense family
# ---------------------------------------------------------------------------

def large_eps(cfg, p_eps):
    """The eps of the deep dense models' comparisons: paper_eps, reckoned
    on 32 layers, times sqrt(layers / 32) past 32 layers.  Each layer rounds its outputs
    to bf16, so two arithmetic orders of the same model inject ulp-sized
    differences at every layer, and those add up like a random walk
    through the depth.  A rule set after reading the card: Gemma3-12B's
    kernels lay 0.3105-0.3125 from its plain versions (first-token L-inf,
    48 layers), past paper_eps (0.30), while each kernel call matched its
    plain version's own bf16 rounding row for row, and running the
    row-variant products without the slab helper moved nothing (a floor
    of 0) (PERF.md, section 6)."""
    return p_eps * max(1.0, cfg.n_layers / 32) ** 0.5


def large_argv(arch, n_requests, gpu_bytes, *extra):
    """serve.main's argv for one of LARGE_DENSE at published width: the
    paper models' configuration with a GPU tier of ``gpu_bytes``."""
    argv = paper_argv(arch, n_requests, *extra)
    argv[argv.index("--gpu-cache-bytes") + 1] = str(gpu_bytes)
    return argv


def phase_large_dense(torch, np, arch):
    """One of the rest of the dense family at full published width and
    LARGE_LAYERS depth, its weights the only ones on the card: the main
    serve of LARGE_REQUESTS requests (for Gemma3-12B, rows past its 1024
    window), the row probe, the chunk split bit for bit, LARGE_PLAIN
    requests through the plain versions, the profile (LARGE_PROFILE only),
    then continuous against sequential in this process (eps from
    large_eps).  Returns its figures and launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    gpu = LARGE_GPU_BYTES.get(arch, PAPER_GPU_BYTES)
    args = serve.build_parser().parse_args(
        large_argv(arch, LARGE_REQUESTS, gpu))
    cfg = dataclasses.replace(get_config(arch), n_layers=LARGE_LAYERS[arch])
    cfg, params, corpus, idx, wl = model_setup(torch, args, cfg, arch)
    results, out = model_serve(torch, np, arch, cfg, params, corpus, idx,
                               wl, args)
    eps = out["eps"]
    questions = {w.req_id: len(w.question_tokens) for w in wl}
    lens = [sum(int(corpus.doc_lengths[d]) for d in r.docs)
            + questions[r.req_id] + len(r.tokens) for r in results]
    windows = sorted(set(cfg.layer_windows()))
    print(f"[{arch}] sequences of {min(lens)}-{max(lens)} tokens, "
          f"{sum(n > max(windows) for n in lens)} of {len(lens)} past the "
          f"largest window of {windows}", flush=True)
    if arch == "gemma3-12b" and max(lens) <= GEMMA3_WINDOW:
        die(f"[{arch}] no sequence passes the {GEMMA3_WINDOW} window")
    variant = phase_row_invariance(torch, cfg, params, tag=f"{arch} rows")
    phase_chunk_split(torch, np, cfg, params, corpus, idx, wl, args,
                      tag=f"{arch} chunk-split")
    if variant:
        die(f"[{arch}] row-variant with the helper: {variant}")
    eps = out["large_eps"] = large_eps(cfg, out["eps"])
    print(f"[{arch}] eps paper_eps x sqrt({cfg.n_layers} / 32) = {eps:.4f}",
          flush=True)
    out["plain_linf"] = phase_check(torch, np, cfg, params, corpus, idx, wl,
                                    args, results, n=LARGE_PLAIN, eps=eps,
                                    tag=f"{arch} check")
    print(f"[{arch} check] kernels vs plain versions "
          f"{out['plain_linf']:.4e}: "
          f"{'within' if out['plain_linf'] <= out['eps'] else 'PAST'} "
          f"paper_eps {out['eps']:g}", flush=True)
    if arch == LARGE_PROFILE:
        phase_profile(torch, cfg, params, corpus, idx, wl, args,
                      tag=f"{arch} profile")
    out["seq"] = phase_seq_in_process(torch, np, cfg, params, corpus, idx,
                                      wl, args, eps, f"{arch} seq")
    del params, results
    out["longest"] = max(lens)
    gc.collect()
    torch.cuda.empty_cache()
    out["wall"] = time.perf_counter() - t_phase
    print(f"[{arch}] phase wall {out['wall']:.1f}s", flush=True)
    return out


# ---------------------------------------------------------------------------
# phases 24-26: training, GPU-failure recovery, multi-hop retrieval
# ---------------------------------------------------------------------------

def tree_finite(torch, tree):
    from repro_torch.training.optimizer import tree_leaves
    return all(bool(torch.isfinite(t.float()).all())
               for t in tree_leaves(tree))


def train_batches(torch, cfg, n):
    """``n`` batches of the synthetic stream on the card."""
    from repro_torch.training.data import DataConfig, make_batches
    data = make_batches(DataConfig(batch_size=TRAIN_BATCH,
                                   seq_len=TRAIN_SEQ,
                                   vocab_size=cfg.vocab_size), cfg)
    return [{k: torch.as_tensor(v, device="cuda")
             for k, v in next(data).items()} for _ in range(n)]


def train_parity(torch, cfg, params, batch):
    """One step's loss and grads through the kernels and through the plain
    versions: bf16 at full width (loss, grad norm), then f32 at
    TRAIN_F32_LAYERS layers (every leaf).  Returns the distances."""
    from repro_torch.training.optimizer import global_norm, tree_leaves
    from repro_torch.training.train_lib import loss_and_grads
    out = {}
    lk, gk = loss_and_grads(cfg, params, batch)
    nk = float(global_norm(gk))
    del gk
    lp, gp = loss_and_grads(cfg, params, batch, attn_impl="torch")
    npl = float(global_norm(gp))
    del gp
    out["loss"] = (float(lk), float(lp), abs(float(lk) - float(lp)))
    out["gnorm"] = (nk, npl, abs(nk - npl) / npl)
    print(f"[train] kernels vs plain, bf16, {cfg.n_layers} layers: loss "
          f"{float(lk):.6f} vs {float(lp):.6f} (|d| {out['loss'][2]:.3e}, "
          f"tol {TRAIN_LOSS_TOL:g}); grad norm {nk:.6f} vs {npl:.6f} "
          f"(relative {out['gnorm'][2]:.3e}, tol {TRAIN_GNORM_RTOL:g})",
          flush=True)
    if not out["loss"][2] <= TRAIN_LOSS_TOL:
        die(f"[train] kernel loss {float(lk)} vs plain {float(lp)}")
    if not out["gnorm"][2] <= TRAIN_GNORM_RTOL:
        die(f"[train] kernel grad norm {nk} vs plain {npl}")
    c32 = dataclasses.replace(cfg, n_layers=TRAIN_F32_LAYERS,
                              dtype="float32")
    p32 = {k: ({n: w[:TRAIN_F32_LAYERS].float() for n, w in v.items()}
               if k == "blocks" else v.float()) for k, v in params.items()}
    _, gk = loss_and_grads(c32, p32, batch)
    _, gp = loss_and_grads(c32, p32, batch, attn_impl="torch")
    worst = 0.0
    for a, b in zip(tree_leaves(gk), tree_leaves(gp)):
        d = float((a - b).abs().max())
        tol = TRAIN_F32_TOL * float(b.abs().max()) + 1e-6
        worst = max(worst, d / tol)
        if not d <= tol:
            die(f"[train] f32 grad leaf {tuple(a.shape)}: kernels vs plain "
                f"{d:.3e} > {tol:.3e}")
    out["f32_worst"] = worst
    print(f"[train] kernels vs plain, f32, {TRAIN_F32_LAYERS} layers: every "
          f"grad leaf within tolerance, worst at {worst:.3e} of it",
          flush=True)
    return out


def time_train_prefix(torch, cfg):
    """The prefix kernel at the training shape, q (TRAIN_BATCH, heads,
    TRAIN_SEQ, hd) from position 0, against its plain version and one SDPA
    call; and the plain backward (layers.flash_attention_bwd) there."""
    from repro_torch.kernels import prefix_attention as PX
    from repro_torch.models import layers as L
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    case = prefix_case(torch, B=TRAIN_BATCH, H=cfg.n_heads,
                       KV=cfg.n_kv_heads, hd=cfg.hd, P=0, Sq=TRAIN_SEQ,
                       dtype=torch.bfloat16, seed=24)
    got = call_prefix(PX.prefix_flash_attention, case).float()
    want = call_prefix(PX.prefix_attention_torch, case).float()
    err = float((got - want).abs().max())
    if not err <= TOL_BF16:
        die(f"[train] prefix kernel vs plain at the training shape: {err}")
    ms = time_ms(torch, lambda: call_prefix(PX.prefix_flash_attention, case),
                 flush=flush)
    plain_ms = time_ms(torch, lambda: call_prefix(PX.prefix_attention_torch,
                                                  case), reps=5, flush=flush)
    lib_ms = time_ms(torch, prefix_library_fn(torch, case), flush=flush)
    bnd, by = prefix_bound_ms(case)
    q, k, v = (case[n].transpose(1, 2) for n in ("q", "k", "v"))
    o = got.to(q.dtype).transpose(1, 2)
    do = torch.randn_like(o)
    bwd_ms = time_ms(torch, lambda: L.flash_attention_bwd(q, k, v, o, do),
                     reps=5, flush=flush)
    row = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bnd,
               bound_by=by, max_abs_err=err, plain_backward_ms=bwd_ms,
               shape=f"q {tuple(case['q'].shape)} bf16, prefix 0")
    print(f"[times] prefix_flash_attention@train: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound {bnd:.4f} ms "
          f"({by}); max |kernel - plain| {err:.3e}; plain backward "
          f"{bwd_ms:.4f} ms", flush=True)
    return row


def profile_train_step(torch, cfg, params, state, step_fn, batch):
    """Device time of one train step by kernel class under torch.profiler:
    cuBLAS GEMMs, the prefix kernel, the flash backward's span (BWD_SPAN,
    plain PyTorch products) and the chunked loss's span (LOSS_SPAN: its
    forward and the backward's recompute of it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import layers as L
    from repro_torch.training import train_lib as TL
    bwd, nll = L.flash_attention_bwd, TL._chunk_nll

    def bwd_span(*a, **kw):
        with record_function(BWD_SPAN):
            return bwd(*a, **kw)

    def nll_span(*a, **kw):
        with record_function(LOSS_SPAN):
            return nll(*a, **kw)

    L.flash_attention_bwd, TL._chunk_nll = bwd_span, nll_span
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step_fn(params, state, batch)
            torch.cuda.synchronize()
    finally:
        L.flash_attention_bwd, TL._chunk_nll = bwd, nll
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if getattr(e, "device_type", None) == DeviceType.CUDA and us > 0 \
                and e.key not in (BWD_SPAN, LOSS_SPAN):
            rows.append((us / 1e3, e.count, e.key))
    if not rows:
        print("[train] device time: not measured (the profiler recorded no "
              "kernels)", flush=True)
        return None
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    gemm = sum(r[0] for r in rows if GEMM_KERNEL.search(r[2]))
    pfx = [r for r in rows if "prefix_attention" in r[2]]
    spans = {name: span_kernels(prof, name) for name in (BWD_SPAN, LOSS_SPAN)}
    out = {"busy_ms": busy, "gemm_ms": gemm,
           "prefix_ms": sum(r[0] for r in pfx),
           "prefix_launches": sum(r[1] for r in pfx)}
    print(f"[train] profiled step: device busy {busy:.1f} ms; cuBLAS GEMMs "
          f"{gemm:.1f} ms = {100 * gemm / busy:.1f}%; prefix kernel "
          f"{out['prefix_ms']:.2f} ms = {100 * out['prefix_ms'] / busy:.1f}% "
          f"({out['prefix_launches']} launches)", flush=True)
    for name, ker in spans.items():
        ms = sum(ker.values())
        g = sum(v for n, v in ker.items() if GEMM_KERNEL.search(n))
        out[name] = (ms, g)
        print(f"[train]   {name} span: {ms:.1f} ms = {100 * ms / busy:.1f}% "
              f"of device time (its GEMMs {g:.1f} ms)", flush=True)
    for ms, n, name in rows[:10]:
        print(f"[train]   {ms:9.2f} ms {100 * ms / busy:5.1f}% x{n:<5d} "
              f"{name[:80]}", flush=True)
    return out


def phase_train(torch, np, cfg, params):
    """Phase 24: train_lib.make_train_step on the full-width model, from the
    main serve's weights (only read: each step returns new tensors)."""
    from repro_torch.training.optimizer import AdamWConfig, init_state
    from repro_torch.training.train_lib import make_train_step
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=max(10, TRAIN_STEPS // 20),
                      total_steps=TRAIN_STEPS)
    step_fn = make_train_step(cfg, opt)
    batches = train_batches(torch, cfg, TRAIN_STEPS)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    p, state = params, init_state(params)
    losses, gnorms, step_ms, launches = [], [], [], None
    for i, batch in enumerate(batches):
        if i == 0:
            reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, state, m = step_fn(p, state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        step_ms.append(1e3 * (time.perf_counter() - t0))
        if i == 0:
            launches, plain = read_counts()
            if launches["prefix_flash_attention"] <= 0 or plain:
                die(f"[train] one step: launches {launches}, plain-version "
                    f"calls {plain}")
    peak = torch.cuda.max_memory_allocated()
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (statistics.median(step_ms[1:]) / 1e3)
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype} weights, f32 "
          f"moments; {TRAIN_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ} "
          f"tokens", flush=True)
    print(f"[train] loss by step {[round(x, 4) for x in losses]}", flush=True)
    print(f"[train] grad norm by step {[round(x, 4) for x in gnorms]}",
          flush=True)
    print(f"[train] ms per step: first {step_ms[0]:.1f}, median of the "
          f"rest {statistics.median(step_ms[1:]):.1f} (min "
          f"{min(step_ms[1:]):.1f}, max {max(step_ms[1:]):.1f}) = "
          f"{tok_s:.0f} tokens/s; peak device memory {peak} B "
          f"({peak / 2**30:.2f} GiB; {held} B held before)", flush=True)
    print(f"[train] one step's launches {launches}", flush=True)
    if not all(np.isfinite(losses)) or not all(np.isfinite(gnorms)):
        die("[train] a loss or grad norm is not finite")
    if not tree_finite(torch, p):
        die("[train] the trained params are not finite")
    if not losses[-1] < losses[0]:
        die(f"[train] the loss did not fall: {losses[0]} -> {losses[-1]}")
    prof = profile_train_step(torch, cfg, p, state, step_fn, batches[0])
    del p, state
    gc.collect()
    torch.cuda.empty_cache()
    parity = train_parity(torch, cfg, params, batches[0])
    times = time_train_prefix(torch, cfg)
    wall = time.perf_counter() - t_phase
    print(f"[train] phase wall {wall:.1f}s", flush=True)
    return dict(launches=launches["prefix_flash_attention"], losses=losses,
                step_ms=step_ms, tok_s=tok_s, peak=peak, profile=prof,
                parity=parity, times=times, wall=wall)


def phase_train_tp(torch, np, cfg, params):
    """Phase 24b: train_lib.make_train_step(mesh=) on a TRAIN_TP_MESH mesh
    of shards on the one card against the one-device step, TRAIN_TP_STEPS
    steps each from the main serve's weights and the same batches: loss
    and grad norm by step (bf16, full width and depth), then one step in
    f32 at TRAIN_F32_LAYERS layers; the prefix kernel's launches a step
    (each shard's forward and recompute: data x model x the one-device
    step's), ms a step and peak memory.  Every data replica must hold the
    same param bits after each step."""
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.training.optimizer import (AdamWConfig, init_state,
                                                init_state_zero, tree_leaves)
    from repro_torch.training.train_lib import make_train_step
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    n_data, n_model = TRAIN_TP_MESH
    mesh = make_debug_mesh(n_data, n_model,
                           devices=["cuda:0"] * (n_data * n_model))
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=max(10, TRAIN_STEPS // 20),
                      total_steps=TRAIN_STEPS)
    batches = train_batches(torch, cfg, TRAIN_TP_STEPS)

    def run(step_fn, p, state):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = dict(loss=[], gnorm=[], ms=[], launches=None)
        for i, batch in enumerate(batches):
            if i == 0:
                reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, state, m = step_fn(p, state, batch)
            out["loss"].append(float(m["loss"]))
            out["gnorm"].append(float(m["grad_norm"]))
            out["ms"].append(1e3 * (time.perf_counter() - t0))
            if i == 0:
                out["launches"], plain = read_counts()
                if plain:
                    die(f"[train tp] the plain versions ran: {plain}")
            if isinstance(p, list):
                for d in range(1, n_data):
                    same = all(torch.equal(a, b) for a, b in zip(
                        tree_leaves(p[0]), tree_leaves(p[d])))
                    if not same:
                        die(f"[train tp] step {i}: data replica {d}'s "
                            f"params differ from replica 0's")
        out["peak"] = torch.cuda.max_memory_allocated() - held
        return out, p

    one, _ = run(make_train_step(cfg, opt), params, init_state(params))
    placed = sh.place_train(params, cfg, mesh)
    tp, trained = run(make_train_step(cfg, opt, mesh=mesh), placed,
                      init_state_zero(sh.train_dims(cfg, mesh), placed,
                                      mesh))
    del placed, trained
    gc.collect()
    torch.cuda.empty_cache()
    name = "prefix_flash_attention"
    want = n_data * n_model * one["launches"][name]
    print(f"[train tp] {cfg.name}: a ({n_data}, {n_model}) mesh, every "
          f"shard on the one card; {TRAIN_TP_STEPS} steps of {TRAIN_BATCH} "
          f"x {TRAIN_SEQ} tokens, bf16; {card_line(torch)}", flush=True)
    for key, r in (("one device", one), ("mesh", tp)):
        print(f"[train tp] {key}: loss by step {r['loss']}; grad norm by "
              f"step {r['gnorm']}; ms by step "
              f"{[round(t, 1) for t in r['ms']]}; peak device memory "
              f"{r['peak']} B above what was held; prefix launches a step "
              f"{r['launches'][name]}", flush=True)
    dl = [abs(a - b) for a, b in zip(tp["loss"], one["loss"])]
    dg = [abs(a - b) / b for a, b in zip(tp["gnorm"], one["gnorm"])]
    print(f"[train tp] mesh vs one device by step: |loss d| {dl} (tol "
          f"{TRAIN_LOSS_TOL:g}); grad norm relative {dg} (tol "
          f"{TRAIN_GNORM_RTOL:g}); prefix launches {tp['launches'][name]} "
          f"(want {n_data} x {n_model} x {one['launches'][name]})",
          flush=True)
    if tp["launches"][name] != want:
        die(f"[train tp] prefix kernel launched {tp['launches'][name]} "
            f"times in a mesh step, not {want}")
    if max(dl) > TRAIN_LOSS_TOL or max(dg) > TRAIN_GNORM_RTOL:
        die(f"[train tp] mesh steps differ from the one-device steps: "
            f"loss {dl}, grad norm {dg}")
    c32 = dataclasses.replace(cfg, n_layers=TRAIN_F32_LAYERS,
                              dtype="float32")
    p32 = {k: ({n: w[:TRAIN_F32_LAYERS].float() for n, w in v.items()}
               if k == "blocks" else v.float()) for k, v in params.items()}
    batch = batches[0]
    _, _, m1 = make_train_step(c32, opt)(p32, init_state(p32), batch)
    placed = sh.place_train(p32, c32, mesh)
    _, _, m2 = make_train_step(c32, opt, mesh=mesh)(
        placed, init_state_zero(sh.train_dims(c32, mesh), placed, mesh),
        batch)
    del placed
    f32 = {k: abs(float(m2[k]) - float(m1[k])) / abs(float(m1[k]))
           for k in ("loss", "grad_norm")}
    print(f"[train tp] f32, {TRAIN_F32_LAYERS} layers, one step: mesh vs "
          f"one device, relative {f32} (tol {TRAIN_TP_F32_RTOL:g})",
          flush=True)
    if max(f32.values()) > TRAIN_TP_F32_RTOL:
        die(f"[train tp] f32 mesh step differs from the one-device step: "
            f"{f32}")
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"[train tp] phase wall {wall:.1f}s", flush=True)
    return dict(launches=tp["launches"][name], one=one, mesh=tp, f32=f32,
                wall=wall)


def kv_digest(torch, k, v):
    """sha256 over the bytes of a (k, v) pair."""
    import hashlib
    h = hashlib.sha256()
    for t in (k, v):
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def node_digests(torch, rt):
    """(node, KV digest from its fastest tier) of each cached node."""
    out = []
    for n in rt.tree.nodes():
        if n.in_gpu:
            out.append((n, kv_digest(torch,
                                     *rt.store.gather(n.payload_gpu))))
        elif n.in_host:
            out.append((n, kv_digest(torch, n.payload_host["k"],
                                     n.payload_host["v"])))
    return out


def phase_fault(torch, np, cfg, params, corpus, idx, wl, args):
    """Phase 25: paper §6 on the card.  The main trace's first
    FAULT_REQUESTS requests through a fresh main-config runtime; hot nodes
    replicated to the host tier, a simulated device loss, recovery; each
    survivor's host copy against its KV captured before the loss; then the
    same requests again, bit for bit."""
    from repro_torch.core.fault_tolerance import (recover_from_gpu_failure,
                                                  replicate_hot_nodes)
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.runtime import ContinuousRuntime
    t_phase = time.perf_counter()
    gc.collect()
    sub = sorted(wl, key=lambda r: r.req_id)[:FAULT_REQUESTS]
    rt = ContinuousRuntime(cfg, params, corpus, idx,
                           config=EngineConfig.from_args(args),
                           device="cuda")
    reset_counts()
    first = rt.serve(sub, max_new_tokens=args.max_new_tokens)
    launches, plain = read_counts()
    if plain or min(launches["paged_decode_attention"],
                    launches["paged_prefill_attention"]) <= 0:
        die(f"[fault] serve: launches {launches}, plain calls {plain}")
    check_leak(rt)
    before = node_digests(torch, rt)
    gpu_nodes = [n for n in rt.tree.nodes() if n.in_gpu]
    gpu_blocks = sum(len(n.payload_gpu.blocks) for n in gpu_nodes)
    replicated = replicate_hot_nodes(rt.tree, FAULT_REPLICA_BYTES)
    rt.tree.check_invariants()
    recovered, lost = recover_from_gpu_failure(rt.tree)
    rt.tree.check_invariants()
    survivors = [(n, d) for n, d in before if n.cached]
    for n, digest in survivors:
        if not n.in_host or n.in_gpu:
            die(f"[fault] survivor doc {n.doc_id} is not on the host alone")
        if kv_digest(torch, n.payload_host["k"],
                     n.payload_host["v"]) != digest:
            die(f"[fault] survivor doc {n.doc_id}: host KV differs from its "
                f"KV before the loss")
    on_device = {id(n) for n in gpu_nodes}
    live = rt.store.pool.n_blocks - rt.store.pool.free_blocks
    stranded = live - 1
    print(f"[fault] {len(first)} requests served; {len(gpu_nodes)} nodes "
          f"({gpu_blocks} blocks) on the device; {replicated} B replicated "
          f"to the host; (recovered, lost) = ({recovered}, {lost}); "
          f"{len(survivors)} survivors' host KV equal to their KV before "
          f"the loss; {stranded} pool blocks stranded (recovery frees no "
          f"device payload, as in the reference)", flush=True)
    if recovered != sum(id(n) in on_device for n, _ in survivors):
        die(f"[fault] recovered {recovered}, but {len(survivors)} nodes "
            f"survived")
    second = rt.serve(sub, max_new_tokens=args.max_new_tokens)
    for a, b in zip(first, second):
        if a.req_id != b.req_id or a.tokens != b.tokens:
            die(f"[fault] request {a.req_id}: tokens {b.tokens} after the "
                f"recovery, {a.tokens} before")
        if not np.array_equal(a.first_logits, b.first_logits):
            die(f"[fault] request {a.req_id}: first-token logits differ "
                f"after the recovery")
    hits = rt.metrics.summary()["tier_hit_tokens"]
    wall = time.perf_counter() - t_phase
    print(f"[fault] re-serve after the recovery: {len(second)} requests, "
          f"tokens and first-token logits bit-identical; tier hit tokens "
          f"{hits}; phase wall {wall:.1f}s", flush=True)
    return dict(recovered=recovered, lost=lost, replicated=replicated,
                stranded=stranded, launches=launches, wall=wall)


class HopIndex:
    """An index whose staged search for a query returns the doc path
    assigned to it (``paths[id(query_vec)]``) at every stage."""

    def __init__(self, base, paths):
        self.base = base
        self.paths = paths

    def staged_search(self, q, k, fraction=1.0):
        for st in self.base.staged_search(q, k, fraction):
            yield dataclasses.replace(st, topk=tuple(self.paths[id(q)]))


def phase_hops(torch, np, cfg, params, corpus, idx, wl, args):
    """Phase 26: paper §9.  core/iterative.run_iterative plans HOPS hops
    over a main-config runtime's controller (HOP_DOCS docs a hop, each
    hop's path extending the last); then the same three paths served one
    request a hop through a runtime, whose tree holds each path's KV for
    the next hop, against a cold runtime for each path."""
    from repro_torch.core.iterative import run_iterative
    from repro_torch.serving.config import EngineConfig
    from repro_torch.serving.runtime import ContinuousRuntime
    t_phase = time.perf_counter()
    gc.collect()
    reqs = sorted(wl, key=lambda r: r.req_id)[:HOPS]
    k_path = HOPS * HOP_DOCS
    econf = dataclasses.replace(EngineConfig.from_args(args), top_k=k_path)

    def runtime(index):
        return ContinuousRuntime(cfg, params, corpus, index, config=econf,
                                 device="cuda")

    def retrieve(h):
        return idx.search(reqs[h].query_vec, HOP_DOCS)

    def doc_tokens(d):
        return int(corpus.doc_lengths[d])

    planner = runtime(idx)
    hops = run_iterative(planner.controller, retrieve, doc_tokens, HOPS,
                         len(reqs[0].question_tokens))
    paths = [tuple(h.plan.doc_ids) for h in hops]
    for i, h in enumerate(hops[1:], 1):
        want = sum(doc_tokens(d) for d in paths[i - 1])
        if h.alpha != want:
            die(f"[hops] hop {i}: alpha {h.alpha}, the previous path holds "
                f"{want} tokens")
    del planner
    index = HopIndex(idx, {id(r.query_vec): p for r, p in zip(reqs, paths)})
    rt = runtime(index)
    reset_counts()
    warm = [rt.serve([r], max_new_tokens=args.max_new_tokens)[0]
            for r in reqs]
    launches, plain = read_counts()
    if plain or launches["paged_prefill_attention"] <= 0:
        die(f"[hops] serve: launches {launches}, plain calls {plain}")
    check_leak(rt)
    cold = [runtime(index).serve([r], max_new_tokens=args.max_new_tokens)[0]
            for r in reqs]
    same_logits = 0
    for i, (a, b) in enumerate(zip(warm, cold)):
        if tuple(a.docs) != paths[i]:
            die(f"[hops] hop {i} served docs {a.docs}, planned {paths[i]}")
        if i and a.alpha < sum(doc_tokens(d) for d in paths[i - 1]):
            die(f"[hops] hop {i}: the runtime reused {a.alpha} tokens, "
                f"short of the previous path")
        if a.tokens != b.tokens:
            die(f"[hops] hop {i}: tokens {a.tokens}, cold {b.tokens}")
        same_logits += bool(np.array_equal(a.first_logits, b.first_logits))
    wall = time.perf_counter() - t_phase
    print(f"[hops] {HOPS} hops, paths {[len(p) for p in paths]} docs; "
          f"planned alphas {[h.alpha for h in hops]}; served alphas "
          f"{[r.alpha for r in warm]}, betas {[r.beta for r in warm]}; "
          f"tokens equal to a cold runtime's on every path, first-token "
          f"logits bit-identical on {same_logits} of {HOPS}; phase wall "
          f"{wall:.1f}s", flush=True)
    return dict(alphas=[r.alpha for r in warm], launches=launches,
                same_logits=same_logits, wall=wall)


# ---------------------------------------------------------------------------
# the compile analysis against the card, seq-par, the mesh families
# ---------------------------------------------------------------------------

DRYRUN_WORKER = r'''
import dataclasses, json, sys
sys.path.insert(0, "src")
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, op_analysis, specs
from repro_torch.training import optimizer as O, train_lib as TL
from repro_torch.training.data import DataConfig, make_batches
which, B, S = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
cfg = get_config(sys.argv[4])
if int(sys.argv[5]):
    cfg = dataclasses.replace(cfg, n_layers=int(sys.argv[5]))
if which == "one":
    host = next(make_batches(DataConfig(batch_size=B, seq_len=S,
                                        vocab_size=cfg.vocab_size), cfg))
    with FakeTensorMode():
        params = specs._whole_params(cfg, "meta:0")
        state = O.init_state(params)
        batch = {k: torch.zeros(v.shape, dtype=torch.as_tensor(v).dtype,
                                device="meta:0") for k, v in host.items()}
        _, tally = op_analysis.analyze(TL.make_train_step(
            cfg, O.AdamWConfig()), params, state, batch)
else:
    tally, _ = dryrun.analyze_case(cfg, dict(kind="train", seq=S, batch=B),
                                   dryrun.fake_mesh(2, 2, whole=True),
                                   computed=None)
calls = sum(c.kernels.get("prefix_flash_attention", 0)
            for c in tally.cards.values())
card = tally.cards[torch.device("meta:0")]
print("RESULT" + json.dumps({"calls": calls, "peak": card.peak_bytes,
                             "args": card.argument_bytes,
                             "flops": sum(c.flops for c in
                                          tally.cards.values())}))
'''


def start_dryruns():
    """The compile analysis's runs, on the host's CPU while the card works:
    phase 24's one-device step and phase 24b's (2, 2) mesh step on fake
    cards, phase recurrent_train's one-device steps, and one production
    case through launch/dryrun.py."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = ROOT / "chiprun_out" / "dryrun_torch"
    out.mkdir(parents=True, exist_ok=True)
    runs = {which: (which, TRAIN_BATCH, TRAIN_SEQ, "qwen2-0.5b", 0)
            for which in ("one", "mesh")}
    for arch, layers in RECURRENT_TRAIN.items():
        runs[arch] = ("one", *RECURRENT_TRAIN_BATCH, arch, layers)
    procs = {}
    for name, argv in runs.items():
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", DRYRUN_WORKER, *map(str, argv)], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    procs["production"] = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         DRYRUN_CASE[0], "--shape", DRYRUN_CASE[1], "--out", str(out),
         "--force"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    def stop():
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    atexit.register(stop)
    return procs, time.perf_counter()


def train_step_peak(torch, cfg, params, batch=None):
    """One AdamW step of ``cfg`` on the card from a clean allocator, on
    ``batch`` (phase 24's first batch by default): (bytes of its
    arguments, the most bytes allocated above what was held before it,
    its loss and grad norm, ms on the host clock)."""
    from repro_torch.training.optimizer import (AdamWConfig, init_state,
                                                tree_leaves)
    from repro_torch.training.train_lib import make_train_step
    gc.collect()
    torch.cuda.empty_cache()
    state = init_state(params)
    batch = batch or train_batches(torch, cfg, 1)[0]
    args = sum(t.numel() * t.element_size() for t in
               tree_leaves(params) + tree_leaves(state.m) + tree_leaves(
                   state.v) + [state.step] + list(batch.values()))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = make_train_step(cfg, AdamWConfig())(params, state, batch)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    above = torch.cuda.max_memory_allocated() - held
    metrics = (float(out[2]["loss"]), float(out[2]["grad_norm"]))
    del out, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return args, above, metrics, ms


def phase_dryrun_cal(torch, procs, t_started, train, train_tp, card_peak,
                     recurrent):
    """Phase dryrun_cal: the fake runs against the card.  Their prefix-kernel
    calls must equal phases 24 / 24b's launch counters (and phase
    recurrent_train's); the predicted peak of each one-device step is
    printed beside the card's (its arguments plus the most allocated above
    what was held) and their ratio; the production case's record is
    printed."""
    t_phase = time.perf_counter()
    got = {}
    for name, p in procs.items():
        try:
            out, err = p.communicate(timeout=DRYRUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            p.kill()
            p.communicate()
            die(f"[dryrun_cal] the {name} dry run passed {DRYRUN_TIMEOUT}s")
        if p.returncode != 0:
            die(f"[dryrun_cal] the {name} dry run failed: {err[-2000:]}")
        got[name] = out
    waited = time.perf_counter() - t_phase
    res = {k: json.loads([ln for ln in got[k].splitlines()
                          if ln.startswith("RESULT")][0][len("RESULT"):])
           for k in got if k != "production"}
    ratios = {}
    for arch, o in recurrent["runs"].items():
        pred, card = res[arch]["peak"], o["args"] + o["above"]
        ratios[arch] = pred / card
        inside = DRYRUN_PEAK_BAND[0] <= ratios[arch] <= DRYRUN_PEAK_BAND[1]
        print(f"[dryrun_cal] {arch} one-device step of "
              f"{RECURRENT_TRAIN_BATCH}, {RECURRENT_TRAIN[arch]} layers: "
              f"predicted peak {pred} B ({pred / 1e9:.2f} GB), the card's "
              f"{card} B ({card / 1e9:.2f} GB); ratio {ratios[arch]:.4f} "
              f"({'inside' if inside else 'OUTSIDE'} band "
              f"{DRYRUN_PEAK_BAND}: recorded, not fatal); prefix calls "
              f"{res[arch]['calls']} fake, {o['launches']} on the card; "
              f"FLOPs {res[arch]['flops']:.6e}", flush=True)
        if res[arch]["calls"] != o["launches"]:
            die(f"[dryrun_cal] {arch}: the fake run counts "
                f"{res[arch]['calls']} prefix-kernel calls, the card "
                f"launched {o['launches']}")
    want = {"one": train["launches"], "mesh": train_tp["launches"]}
    for k in ("one", "mesh"):
        print(f"[dryrun_cal] {k}: fake run's prefix-kernel calls "
              f"{res[k]['calls']}, the card's launches {want[k]}; FLOPs "
              f"{res[k]['flops']:.6e}", flush=True)
        if res[k]["calls"] != want[k]:
            die(f"[dryrun_cal] {k}: the fake run counts {res[k]['calls']} "
                f"prefix-kernel calls, the card launched {want[k]}")
    args, above = card_peak
    pred = res["one"]["peak"]
    card = args + above
    ratio = pred / card
    print(f"[dryrun_cal] one-device step of {TRAIN_BATCH} x {TRAIN_SEQ}: "
          f"predicted peak {pred} B ({pred / 1e9:.2f} GB; arguments "
          f"{res['one']['args']} B), the card's {card} B ({card / 1e9:.2f} "
          f"GB = arguments {args} B + {above} B max allocated above them); "
          f"ratio {ratio:.4f} (band {DRYRUN_PEAK_BAND}); "
          f"{card_line(torch)}", flush=True)
    rec = json.loads((ROOT / "chiprun_out" / "dryrun_torch" /
                      f"{DRYRUN_CASE[0]}__{DRYRUN_CASE[1]}__single.json")
                     .read_text())
    if rec.get("status") != "ok":
        die(f"[dryrun_cal] production case: {rec}")
    rl = rec["roofline"]
    print(f"[dryrun_cal] {DRYRUN_CASE[0]} {DRYRUN_CASE[1]} on "
          f"{rec['mesh_shape']}: dominant {rl['dominant']}, t_compute "
          f"{rl['t_compute_s']:.4e} s, t_memory {rl['t_memory_s']:.4e} s, "
          f"t_collective {rl['t_collective_s']:.4e} s, peak "
          f"{rec['memory']['peak_bytes']} B, useful ratio "
          f"{rl['useful_ratio']:.4f} (published H100 peaks, not measured); "
          f"dry run {rec['run_s']}s", flush=True)
    print(f"[dryrun_cal] record {json.dumps(rec)[:3000]}", flush=True)
    wall = time.perf_counter() - t_started
    print(f"[dryrun_cal] phase wall {time.perf_counter() - t_phase:.1f}s "
          f"({waited:.1f}s waiting; the dry runs ran {wall:.1f}s beside "
          f"the card's phases)", flush=True)
    return dict(ratio=ratio, pred=pred, card=card, calls={
        k: res[k]["calls"] for k in res}, record=rec, recurrent=ratios)


def cut_params(torch, cfg, n_layers, seed=0):
    """Seeded bf16 params of ``cfg`` cut to ``n_layers`` at full width,
    drawn on the card."""
    from repro_torch.models.model import init_params
    cut = dataclasses.replace(cfg, n_layers=n_layers)
    return cut, init_params(cut, seed, device="cuda")


def phase_seqpar(torch):
    """Phase seqpar: Yi-34B at full width and SEQPAR_LAYERS layers, one
    SEQPAR_TOKENS-token prefill (models/model.py::replica_prefill) over a
    (1, 4) mesh of shards on the one card: seq-par (512-row query chunks
    dealt over the shards, each through the prefix kernel) against the
    unsplit prefill on the same mesh, bit for bit (logits and cache); then
    flat-gqa (K/V repeated to 56 heads, the kernel at R 1) on layer 0's q,
    k, v, row by row against the plain version run in f32 within
    TOL_ROW_BF16 (the kernel's bf16 row tolerance), and its logits'
    distance from the grouped run's."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.kernels import prefix_attention as PX
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg, params = cut_params(torch, get_config(SEQPAR_ARCH), SEQPAR_LAYERS)
    mesh = make_debug_mesh(1, 4, devices=["cuda:0"] * 4)
    placed = sh.place_train(params, cfg, mesh)[0]
    del params
    row = mesh.replica(0)
    gen = torch.Generator(device="cuda").manual_seed(31)
    toks = torch.randint(0, cfg.vocab_size, (1, SEQPAR_TOKENS),
                         generator=gen, device="cuda", dtype=torch.int32)
    runs, launches = {}, {}
    with torch.no_grad():
        for name, opts in (("unsplit", sh.Options()),
                           ("seq-par", sh.Options(seq_par=True)),
                           ("flat-gqa", sh.Options(flat_gqa=True))):
            reset_counts()
            runs[name] = M.replica_prefill(cfg, placed, {"tokens": toks},
                                           mesh=row, opts=opts)
            torch.cuda.synchronize()
            launches[name], plain = read_counts()
            if plain or launches[name]["prefix_flash_attention"] <= 0:
                die(f"[seqpar] {name}: launches {launches[name]}, plain "
                    f"{plain}")
    (la, ca), (lb, cb), (lf, _) = (runs[k] for k in ("unsplit", "seq-par",
                                                     "flat-gqa"))
    def whole(t):
        return torch.cat(t, dim=3) if isinstance(t, tuple) else t
    bits = {"logits": bool(torch.equal(la, lb)),
            "k": bool(torch.equal(whole(ca["k"]), whole(cb["k"]))),
            "v": bool(torch.equal(whole(ca["v"]), whole(cb["v"])))}
    dl = float((la - lb).abs().max())
    flat_d = float((lf - la).abs().max())
    # flat-gqa's kernel call at R 1 against the plain version on layer 0
    with torch.no_grad():
        p0 = M._rep_layer(M._replica(cfg, placed, row), 0)
        rep = M._replica(cfg, placed, row, sh.Options(flat_gqa=True))
        x = M._embed_seq(cfg, rep, {"tokens": toks})
        (q, k, v), = M._qkv_parts(cfg, rep, p0, L.rms_norm(
            x, p0["ln1"], cfg.norm_eps), torch.arange(
                SEQPAR_TOKENS, dtype=torch.int32, device="cuda"), whole=True)
        r = q.shape[2] // k.shape[2]
        kr, vr = k.repeat_interleave(r, 2), v.repeat_interleave(r, 2)
        got = M._attend(cfg, rep, q, k, v, 0, None)
        exact = PX.prefix_attention_torch(
            *(t.float().transpose(1, 2) for t in (q, kr, vr)),
            prefix_len=0).transpose(1, 2)
        plain = PX.prefix_attention_torch(
            q.transpose(1, 2), kr.transpose(1, 2), vr.transpose(1, 2),
            prefix_len=0).transpose(1, 2)
        err = row_err(torch, got, exact)
        plain_err = row_err(torch, plain, exact)
        abs_d = float((got.float() - plain.float()).abs().max())
    n = {k: launches[k]["prefix_flash_attention"] for k in launches}
    print(f"[seqpar] {cfg.name}: full width, {cfg.n_layers} of 60 layers, "
          f"{cfg.n_heads} / {cfg.n_kv_heads} heads over a (1, 4) mesh on "
          f"one card; one {SEQPAR_TOKENS}-token prefill: seq-par vs "
          f"unsplit bit-identical {bits} (max |d logits| {dl:.3e}); prefix "
          f"launches unsplit {n['unsplit']}, seq-par {n['seq-par']}, "
          f"flat-gqa {n['flat-gqa']}; flat-gqa layer 0, rows against the "
          f"plain version in f32: kernel {err:.3e}, plain bf16 "
          f"{plain_err:.3e} (tol {TOL_ROW_BF16:g}), max |kernel - plain| "
          f"{abs_d:.3e}; flat-gqa vs grouped logits "
          f"{flat_d:.3e}; {card_line(torch)}", flush=True)
    if not all(bits.values()):
        die(f"[seqpar] seq-par prefill differs from the unsplit one: {bits}")
    if not err <= TOL_ROW_BF16:
        die(f"[seqpar] flat-gqa kernel rows {err} > {TOL_ROW_BF16}")
    del runs, placed, q, k, v, kr, vr, got, exact, plain, x
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"[seqpar] phase wall {wall:.1f}s", flush=True)
    return dict(bits=bits, flat_err=err, flat_logits=flat_d, launches=n,
                wall=wall)


def mesh_step(torch, cfg, params, batch, mesh=None):
    """One AdamW step of ``cfg`` (one device, or on ``mesh``): (loss, grad
    norm, launches); every data replica's params equal after it."""
    from repro_torch.launch import sharding as sh
    from repro_torch.training.optimizer import (AdamWConfig, init_state,
                                                init_state_zero, tree_leaves)
    from repro_torch.training.train_lib import make_train_step
    opt = AdamWConfig(lr=TRAIN_LR, warmup_steps=1)
    if mesh is None:
        p, state = params, init_state(params)
    else:
        p = sh.place_train(params, cfg, mesh)
        state = init_state_zero(sh.train_dims(cfg, mesh), p, mesh)
    reset_counts()
    new, _, m = make_train_step(cfg, opt, mesh=mesh)(p, state, batch)
    torch.cuda.synchronize()
    launches, plain = read_counts()
    if plain:
        die(f"[train mesh] {cfg.name}: the plain versions ran ({plain})")
    out = (float(m["loss"]), float(m["grad_norm"]),
           launches["prefix_flash_attention"])
    if not all(math.isfinite(x) for x in out[:2]):
        die(f"[train mesh] {cfg.name}: loss / grad norm {out[:2]}")
    if mesh is not None:
        for d in range(1, len(new)):
            for i, (a, b) in enumerate(zip(tree_leaves(new[0]),
                                           tree_leaves(new[d]))):
                if not torch.equal(a, b):
                    bad = int((a != b).sum())
                    die(f"[train mesh] {cfg.name}: replica {d}'s leaf {i} "
                        f"{tuple(a.shape)} differs at {bad} of {a.numel()} "
                        f"(max |d| {float((a.float() - b.float()).abs().max())}"
                        f"; finite {bool(torch.isfinite(a.float()).all())})")
    del new, p, state, m
    return out


def family_batch(torch, cfg, B, S, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    shape = (B, cfg.n_codebooks, S) if cfg.n_codebooks else (B, S)
    return {k: torch.randint(0, cfg.vocab_size, shape, generator=gen,
                             device="cuda", dtype=torch.int32)
            for k in ("tokens", "labels")}


def phase_train_mesh_families(torch):
    """Phase train_mesh_families: one (2, 2) mesh train step of each of
    MESH_FAMILIES (full width, the cut depth given) against the one-device
    step on the same batch and weights: loss within TRAIN_LOSS_TOL, grad
    norm within TRAIN_GNORM_RTOL; Hymba's and MusicGen's attention on the
    prefix kernel (launches data x model x the one-device step's)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.sharding import kv_heads_shardable
    t_phase = time.perf_counter()
    mesh = make_debug_mesh(2, 2, devices=["cuda:0"] * 4)
    out = {}
    for arch, layers in MESH_FAMILIES.items():
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        cfg, params = cut_params(torch, get_config(arch), layers)
        batch = family_batch(torch, cfg, *MESH_FAMILY_BATCH, seed=41)
        one = mesh_step(torch, cfg, params, batch)
        two = mesh_step(torch, cfg, params, batch, mesh)
        dl, dg = abs(two[0] - one[0]), abs(two[1] - one[1]) / one[1]
        print(f"[train mesh] {arch}: full width, {layers} of "
              f"{get_config(arch).n_layers} layers, batch "
              f"{MESH_FAMILY_BATCH}; one device loss {one[0]:.6f} grad "
              f"norm {one[1]:.6f}; (2, 2) mesh loss {two[0]:.6f} grad norm "
              f"{two[1]:.6f}: |d loss| {dl:.3e} (tol {TRAIN_LOSS_TOL:g}), "
              f"grad norm relative {dg:.3e} (tol {TRAIN_GNORM_RTOL:g}); "
              f"prefix launches {one[2]} / {two[2]}; "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
        if not (dl <= TRAIN_LOSS_TOL and dg <= TRAIN_GNORM_RTOL):
            die(f"[train mesh] {arch}: mesh step vs one device: loss {dl}, "
                f"grad norm {dg}")
        # each replica's shards attend on their whole heads, or (heads that
        # do not split over 2) its controller once over all of them
        per = 2 * (2 if kv_heads_shardable(cfg, 2) else 1)
        if two[2] != per * one[2]:
            die(f"[train mesh] {arch}: {two[2]} prefix launches on the "
                f"mesh, not {per} x {one[2]}")
        out[arch] = dict(one=one, mesh=two, loss=dl, gnorm=dg)
        del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"[train mesh] phase wall {wall:.1f}s", flush=True)
    return dict(runs=out, wall=wall)


def phase_capacity_data2(torch):
    """Phase capacity_data2: Mixtral-8x7B at full width and 1 layer, moe_impl
    capacity, one step on a (2, 1) mesh (the batch's single 4096-token
    dispatch chunk straddles both replicas, whose slots follow the whole
    batch's order: models/model.py::CapacityDispatch) against the
    one-device capacity step, same tolerances as phase 24b."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    base = dataclasses.replace(get_config(MOE_ARCH), moe_impl="capacity")
    cfg, params = cut_params(torch, base, 1)
    batch = family_batch(torch, cfg, *CAPACITY_BATCH, seed=43)
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    one = mesh_step(torch, cfg, params, batch)
    two = mesh_step(torch, cfg, params, batch,
                    make_debug_mesh(2, 1, devices=["cuda:0"] * 2))
    peak = torch.cuda.max_memory_allocated() - held
    dl, dg = abs(two[0] - one[0]), abs(two[1] - one[1]) / one[1]
    print(f"[capacity data2] {MOE_ARCH}: full width, 1 layer, capacity "
          f"dispatch, batch {CAPACITY_BATCH}; one device loss {one[0]:.6f} "
          f"grad norm {one[1]:.6f}; (2, 1) mesh loss {two[0]:.6f} grad "
          f"norm {two[1]:.6f}: |d loss| {dl:.3e} (tol {TRAIN_LOSS_TOL:g}), "
          f"grad norm relative {dg:.3e} (tol {TRAIN_GNORM_RTOL:g}); peak "
          f"{peak} B above {held} B held; {card_line(torch)}", flush=True)
    if not (dl <= TRAIN_LOSS_TOL and dg <= TRAIN_GNORM_RTOL):
        die(f"[capacity data2] mesh step vs one device: loss {dl}, grad "
            f"norm {dg}")
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"[capacity data2] phase wall {wall:.1f}s", flush=True)
    return dict(one=one, mesh=two, loss=dl, gnorm=dg, peak=peak, wall=wall,
                launches=two[2])


def mesh_decode_lengths(name):
    """(prefill tokens, cache positions) of ``name``'s mesh decode."""
    return MESH_DECODE_RECURRENT.get(name, (MESH_DECODE_PREFILL,
                                            MESH_DECODE_LEN))


def check_state_split(cfg, cache, mesh, when):
    """Die unless every recurrent state leaf that ``state_layout`` splits
    over ``mesh``'s model axis is one part a shard, on the shard's device,
    its split dim cut by the axis, and every other leaf one tensor on the
    controller."""
    from repro_torch.launch import sharding as sh
    from repro_torch.models import model as M
    lay = sh.state_layout(cfg, mesh, 1)
    whole = M.init_decode_cache(cfg, 1, 0, device="meta")
    tree = {"ssm": whole["ssm"]} if cfg.family == "hybrid" else whole
    got = {"ssm": cache["ssm"]} if cfg.family == "hybrid" else cache
    row = mesh.replica(0).devices
    for path, d in lay.dims.items():
        want, leaf = leaf_of(tree, path), leaf_of(got, path)
        if d < 0:
            ok = (not isinstance(leaf, tuple) and leaf.shape == want.shape
                  and leaf.device == row[0])
        else:
            shape = list(want.shape)
            shape[d] //= len(row)
            ok = (isinstance(leaf, tuple) and len(leaf) == len(row)
                  and all(list(t.shape) == shape and t.device == dev
                          for t, dev in zip(leaf, row)))
        if not ok:
            die(f"[mesh decode] {cfg.name} {when}: state leaf {path} not in "
                f"its layout (split dim {d})")


def leaf_of(tree, path):
    for key in path:
        tree = tree[int(key)] if isinstance(tree, tuple) else tree[key]
    return tree


def mesh_decode_run(torch, cfg, params, toks, mesh, P, max_len):
    """A prefill of ``P`` tokens into a cache of ``max_len`` positions,
    then MESH_DECODE_STEPS decode steps, on ``mesh`` (None: one device):
    (logits by step, the prefill's first, ms by decode step, peak bytes
    above what was held, prefix launches)."""
    from repro_torch.launch import sharding as sh
    from repro_torch.models import model as M
    tree = params
    if mesh is not None:
        tree = M.with_slices(sh.place_train(params, cfg, mesh), 0,
                             sh.train_dims(cfg, mesh))
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    recurrent = mesh is not None and cfg.family in ("ssm", "hybrid")
    with torch.no_grad():
        reset_counts()
        first, cache = M.replica_prefill(cfg, tree, {"tokens": toks[:, :P]},
                                         mesh=mesh, max_len=max_len)
        torch.cuda.synchronize()
        launches, plain = read_counts()
        if plain or (cfg.family != "ssm"
                     and launches["prefix_flash_attention"] <= 0):
            die(f"[mesh decode] {cfg.name}: prefill launches {launches}, "
                f"plain {plain}")
        if (mesh is not None and cfg.family != "ssm"
                and not isinstance(cache["k"], M.SeqSlices)):
            die(f"[mesh decode] {cfg.name}: the cache's sequence is not "
                f"split over {mesh.n_replicas} replicas")
        if recurrent:
            check_state_split(cfg, cache, mesh, "after the prefill")
        out, ms = [first], []
        for i in range(MESH_DECODE_STEPS):
            pos = torch.full((1,), P + 1 + i, dtype=torch.int32,
                             device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out.append(M.replica_decode_step(cfg, tree, toks[:, P + i:P + i
                                                              + 1], cache,
                                             pos, mesh=mesh))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        if recurrent:
            check_state_split(cfg, cache, mesh, "after the decode steps")
    peak = torch.cuda.max_memory_allocated() - held
    del cache, tree
    return out, ms, peak, launches["prefix_flash_attention"]


def phase_mesh_decode(torch, np):
    """Phase mesh_decode: the reference's decode cache layout
    (launch/sharding.py::cache_layout) on a (data, model) mesh with every
    shard on the one card, a batch of 1: the cache's sequence split over
    the data replicas (each attends to its slice, replica 0 merges the
    partials) and hd over model (the shards' partial scores added on the
    controller); for xLSTM and Hymba also the recurrent state split over
    model (launch/sharding.py::state_layout), each shard stepping its
    part.  For each of MESH_DECODE, in f32 and bf16, a prefill then
    MESH_DECODE_STEPS decode steps on the mesh against the same on one
    device (models/model.py::replica_prefill / replica_decode_step):
    every f32 logit within MESH_DECODE_RTOL x max |logit|, the bf16 first
    step's L-inf within paper_eps (the recurrent families: within
    max(paper_eps, 2 x the one-device bf16 step's L-inf from the f32
    one), phase 19's rule); each decode step's ms and the peak memory
    printed."""
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_debug_mesh
    t_phase = time.perf_counter()
    out = {}
    for arch, (shape, layers) in MESH_DECODE.items():
        gc.collect()
        torch.cuda.empty_cache()
        full = get_config(arch)
        cfg, params = cut_params(torch, full, layers or full.n_layers)
        mesh = make_debug_mesh(*shape, devices=["cuda:0"] * math.prod(shape))
        P, max_len = mesh_decode_lengths(arch)
        lay = (None if cfg.family == "ssm" else
               sh.cache_layout(cfg, mesh, 1, max_len))
        if cfg.family != "ssm" and lay != sh.CacheLayout(1, shape[0], "hd"):
            die(f"[mesh decode] {arch}: layout {lay}")
        if cfg.family in ("ssm", "hybrid"):
            slay = sh.state_layout(cfg, mesh, 1)
            split = sorted(p for p, d in slay.dims.items() if d >= 0)
            want = ([("ssm",)] if cfg.family == "hybrid" else
                    sorted(p for p in slay.dims if p != ("mlstm", "2")))
            if split != want:
                die(f"[mesh decode] {arch}: state layout {slay}")
            lay = ", ".join(([str(lay)] if lay else [])
                            + [f"state split {slay.dims}"])
        gen = torch.Generator(device="cuda").manual_seed(47)
        toks = torch.randint(0, cfg.vocab_size, (1, P + MESH_DECODE_STEPS),
                             generator=gen, device="cuda", dtype=torch.int32)
        res = {}
        for dt in ("float32", "bfloat16"):
            c = dataclasses.replace(cfg, dtype=dt)
            p = f32_params(params) if dt == "float32" else params
            res[dt] = {"one": mesh_decode_run(torch, c, p, toks, None, P,
                                              max_len),
                       "mesh": mesh_decode_run(torch, c, p, toks, mesh, P,
                                               max_len)}
            del p
        f32 = res["float32"]
        rel = max(float((a - b).abs().max()) / float(b.abs().max())
                  for a, b in zip(f32["mesh"][0], f32["one"][0]))
        a, b = (res["bfloat16"][k][0][1] for k in ("mesh", "one"))
        linf = float((a - b).abs().max())
        eps = paper_eps(float(b.abs().max()))
        if cfg.family in ("ssm", "hybrid"):
            floor = float((b - f32["one"][0][1]).abs().max())
            print(f"[mesh decode] {arch}: one device's bf16 first step "
                  f"L-inf {floor:.4e} from its f32 one; eps = max(paper_eps "
                  f"{eps:g}, 2 x {floor:.4e})", flush=True)
            eps = max(eps, 2 * floor)
        for dt, r in res.items():
            print(f"[mesh decode] {arch} {dt}: full width, {cfg.n_layers} of "
                  f"{full.n_layers} layers, {lay}, a {P}-"
                  f"token prefill into {max_len} positions; decode "
                  f"ms by step on the {shape} mesh "
                  f"{[round(t, 3) for t in r['mesh'][1]]}, one device "
                  f"{[round(t, 3) for t in r['one'][1]]}; peak "
                  f"{r['mesh'][2]} B (one device {r['one'][2]} B) above "
                  f"what was held; prefill prefix launches {r['mesh'][3]} "
                  f"(one device {r['one'][3]}); {card_line(torch)}",
                  flush=True)
        print(f"[mesh decode] {arch}: f32 logits of the prefill and every "
              f"step within {rel:.3e} x max |logit| of one device's (tol "
              f"{MESH_DECODE_RTOL:g}); bf16 first step L-inf {linf:.4e} "
              f"(eps {eps:g})", flush=True)
        if not rel <= MESH_DECODE_RTOL:
            die(f"[mesh decode] {arch}: f32 relative {rel}")
        if not linf <= eps:
            die(f"[mesh decode] {arch}: bf16 first step {linf} > {eps}")
        out[arch] = dict(rel=rel, linf=linf, eps=eps, launches={
            dt: r["mesh"][3] for dt, r in res.items()}, ms={
            dt: r["mesh"][1] for dt, r in res.items()}, peak={
            dt: r["mesh"][2] for dt, r in res.items()}, shape=shape)
        del params, res, toks
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"[mesh decode] phase wall {wall:.1f}s", flush=True)
    return dict(runs=out, wall=wall)


def scan_run(torch, fn, inputs, cot, chunk):
    """One forward and backward of ``fn(*leaves, chunk=chunk)`` -> (out,
    states) from fresh leaves of ``inputs``, the loss sum(out * cot) +
    sum(states): (out, states, the leaves' grads, the most bytes allocated
    above what was held before, inputs included, ms on the host clock)."""
    gc.collect()
    torch.cuda.empty_cache()
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, states = fn(*leaves, chunk=chunk)
    loss = (out.float() * cot).sum() + sum(s.sum() for s in states)
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - held
    return out.detach(), [t.detach() for t in states], grads, peak, ms


def scan_ab(torch, tag, fn, inputs, names, hd):
    """A scan with chunk=SCAN_CHUNK against chunk=S at the same inputs:
    outputs and final states bit for bit, each input's grad within
    TRAIN_GNORM_RTOL x its max |g| (its largest |d| and whether its bits
    are equal printed), and the chunked peak below the unchunked one."""
    B, S, H = inputs[0].shape[:3]
    gen = torch.Generator(device="cuda").manual_seed(7)
    cot = torch.randn((B, S, H, hd), generator=gen, device="cuda")
    runs = {c: scan_run(torch, fn, inputs, cot, c) for c in (S, SCAN_CHUNK)}
    (out, st, grads, peak, ms), (out0, st0, grads0, peak0, ms0) = \
        runs[SCAN_CHUNK], runs[S]
    bits = torch.equal(out, out0) and all(torch.equal(a, b)
                                          for a, b in zip(st, st0))
    rows = []
    for name, g, g0 in zip(names, grads, grads0):
        d = float((g.float() - g0.float()).abs().max())
        top = float(g0.float().abs().max())
        rows.append((name, d, top, torch.equal(g, g0)))
    print(f"[{tag}] chunk={SCAN_CHUNK} vs chunk={S}, inputs "
          f"{[tuple(t.shape) for t in inputs]}: outputs and final states "
          f"bit-identical {bits}; peak above the inputs {peak} B vs {peak0} "
          f"B; {ms:.1f} vs {ms0:.1f} ms forward and backward (host clock)",
          flush=True)
    for name, d, top, same in rows:
        print(f"[{tag}]   grad {name}: max |d| {d:.4e} of max |g| "
              f"{top:.4e} ({d / top if top else 0.0:.3e}; tol "
              f"{TRAIN_GNORM_RTOL:g}); bits equal {same}", flush=True)
    if not bits:
        die(f"[{tag}] chunked outputs differ from the unchunked ones")
    bad = [n for n, d, top, _ in rows if not d <= TRAIN_GNORM_RTOL * top]
    if bad:
        die(f"[{tag}] grads past tolerance: {bad}")
    if peak >= peak0:
        die(f"[{tag}] the chunked peak {peak} B is not below {peak0} B")
    return dict(peak=peak, peak_whole=peak0, ms=ms, ms_whole=ms0,
                grads=rows)


def recurrent_step(torch, cfg, params, batch):
    """train_step_peak on ``batch``, through the kernels only: (loss, grad
    norm, bytes of its arguments, the most bytes allocated above them,
    ms, prefix-kernel launches)."""
    reset_counts()
    args, above, (loss, gnorm), ms = train_step_peak(torch, cfg, params,
                                                     batch)
    launches, plain = read_counts()
    if plain:
        die(f"[recurrent_train] {cfg.name}: the plain versions ran ({plain})")
    if not (math.isfinite(loss) and math.isfinite(gnorm)):
        die(f"[recurrent_train] {cfg.name}: loss / grad norm {loss}, {gnorm}")
    return loss, gnorm, args, above, ms, launches["prefix_flash_attention"]


def phase_recurrent_train(torch):
    """Phase recurrent_train: xLSTM-1.3B's sLSTM and Hymba-1.5B's SSM scans
    at full width over RECURRENT_TRAIN_BATCH, chunked (the reference's
    per-chunk recompute) against unchunked (scan_ab), then one train step
    of each model at its RECURRENT_TRAIN depth: loss, grad norm, peak."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    t_phase = time.perf_counter()
    B, S = RECURRENT_TRAIN_BATCH
    out = {}
    for arch, layers in RECURRENT_TRAIN.items():
        gc.collect()
        torch.cuda.empty_cache()
        cfg, params = cut_params(torch, get_config(arch), layers)
        gen = torch.Generator(device="cuda").manual_seed(11)
        H = cfg.n_heads
        if cfg.family == "ssm":
            hd = cfg.d_model // H
            zifo = torch.randn((B, S, H, 4 * hd), generator=gen,
                               device="cuda").to(cfg.tdtype)
            r_w = params["blocks"]["slstm"]["r_w"][0]
            ab = scan_ab(torch, f"recurrent_train {arch} slstm_scan",
                         lambda z, r, chunk: L.slstm_scan(z, r, chunk=chunk),
                         [zifo, r_w], ["zifo", "r_w"], hd)
            del zifo
        else:
            hd, N = cfg.hd, cfg.ssm_state
            p = {k: params["blocks"][k][0] for k in ("ssm_A", "ssm_D")}
            x = F.silu(torch.randn((B, S, H, hd), generator=gen,
                                   device="cuda")).to(cfg.tdtype)
            delta = F.softplus(torch.randn((B, S, H), generator=gen,
                                           device="cuda"))
            Bm, Cm = (torch.randn((B, S, N), generator=gen, device="cuda")
                      .to(cfg.tdtype) for _ in range(2))

            def mamba(x, d, A, Bm, Cm, D, chunk):
                y, h = L.mamba_scan(x, d, A, Bm, Cm, D, chunk=chunk)
                return y, (h,)

            ab = scan_ab(torch, f"recurrent_train {arch} mamba_scan", mamba,
                         [x, delta, p["ssm_A"], Bm, Cm, p["ssm_D"]],
                         ["x", "delta", "A", "B", "C", "D"], hd)
            del x, delta, Bm, Cm
        batch = family_batch(torch, cfg, B, S, seed=43)
        loss, gnorm, args, above, ms, launches = recurrent_step(
            torch, cfg, params, batch)
        print(f"[recurrent_train] {arch}: full width, {layers} of "
              f"{get_config(arch).n_layers} layers, batch "
              f"{RECURRENT_TRAIN_BATCH}: one train step loss {loss:.6f}, "
              f"grad norm {gnorm:.6f}, {ms:.1f} ms (host clock, first "
              f"step); peak {args + above} B = arguments {args} B + "
              f"{above} B max allocated above them; prefix launches "
              f"{launches}; {card_line(torch)}", flush=True)
        out[arch] = dict(ab=ab, loss=loss, gnorm=gnorm, args=args,
                         above=above, ms=ms, launches=launches)
        del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t_phase
    print(f"[recurrent_train] phase wall {wall:.1f}s", flush=True)
    return dict(runs=out, wall=wall)


def phase_examples(torch):
    """Phase examples: the port's twins of examples/*.py that use the card
    (EXAMPLES), each run as a user runs it (``--device cuda``) in a process
    of its own, the three at once: exit 0, its last line OK, its claim
    lines printed, the prefix kernel launched and no plain version called;
    train_tiny's loss must fall."""
    import os
    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {name: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / f"torch_{name}.py"),
         "--device", "cuda", *argv], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, (argv, _) in EXAMPLES.items()}
    out = {}
    try:
        for name, (_, claims) in EXAMPLES.items():
            try:
                stdout, stderr = procs[name].communicate(
                    timeout=max(1.0, EXAMPLE_TIMEOUT
                                - (time.perf_counter() - t_phase)))
            except subprocess.TimeoutExpired:
                die(f"[examples] {name} passed {EXAMPLE_TIMEOUT}s")
            lines = stdout.splitlines()
            for ln in lines:
                print(f"[examples] {name} | {ln}", flush=True)
            rc = procs[name].returncode
            if rc != 0 or not lines or lines[-1] != "OK":
                die(f"[examples] {name} exited {rc}: {stderr[-2000:]}")
            missing = [c for c in claims if c not in lines]
            counts = re.search(r"^device cuda\S*: prefix kernel launches "
                               r"(\d+), plain version calls (\d+)$", stdout,
                               re.M)
            if missing or not counts:
                die(f"[examples] {name}: claim lines missing: "
                    f"{missing or 'the kernel counts'}")
            launches, plain = int(counts.group(1)), int(counts.group(2))
            if not launches or plain:
                die(f"[examples] {name}: {launches} prefix launches, {plain} "
                    f"plain-version calls")
            if name == "train_tiny":
                loss = re.search(r"^loss ([\d.]+) -> ([\d.]+)$", stdout,
                                 re.M)
                if not loss or float(loss.group(2)) >= float(loss.group(1)):
                    die("[examples] train_tiny: the loss did not fall")
            print(f"[examples] {name}: exit 0 and its claims; prefix kernel "
                  f"launches {launches}, plain versions 0", flush=True)
            out[name] = dict(launches=launches)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall = time.perf_counter() - t_phase
    print(f"[examples] phase wall {wall:.1f}s", flush=True)
    return dict(runs=out, wall=wall)


def main() -> None:
    t_start = time.perf_counter()
    import torch
    phase_device(torch)
    import numpy as np
    dry_procs, dry_t0 = start_dryruns()
    phase_build()
    dec, dec_long, pre, pfx, paper, errs = phase_parity(torch, np)
    times = phase_times(torch, np, dec, dec_long, pre, pfx, paper, errs)
    del dec, dec_long, pre, pfx, paper
    torch.cuda.empty_cache()
    (cfg, params, corpus, idx, wl, args, results, launches,
     main_stats) = phase_serve(torch, np)
    variant = phase_row_invariance(torch, cfg, params)
    phase_repair_cost(torch, cfg, params, corpus, idx, wl, args, main_stats)
    phase_check(torch, np, cfg, params, corpus, idx, wl, args, results)
    phase_chunk_split(torch, np, cfg, params, corpus, idx, wl, args)
    if variant:
        die(f"row-variant with the helper: {variant}")
    cag = phase_cag(torch, np, cfg, params, corpus, idx, wl, args, results)
    dense = phase_dense(torch, np, cfg, params, corpus, idx, wl, args,
                        results)
    seq = phase_sequential(torch)
    chunk = phase_chunk_reuse(torch, np, cfg, params, corpus, idx, wl, args,
                              main_stats)
    fleet = phase_replicas(torch, np)
    door = phase_frontdoor(torch, cfg, corpus)
    torch.cuda.empty_cache()
    phase_profile(torch, cfg, params, corpus, idx, wl, args)
    fault = phase_fault(torch, np, cfg, params, corpus, idx, wl, args)
    hops = phase_hops(torch, np, cfg, params, corpus, idx, wl, args)
    train = phase_train(torch, np, cfg, params)
    train_tp = phase_train_tp(torch, np, cfg, params)
    card_peak = train_step_peak(torch, cfg, params)[:2]
    tp_qwen = phase_tp(torch, np,
                       *first_layers(cfg, params, TP_LAYERS[cfg.name]),
                       corpus, idx, wl, args, TP_MODELS[cfg.name], cfg)
    del params, results
    paper = {arch: phase_paper(torch, np, arch) for arch in PAPER_MODELS}
    moe = phase_moe(torch, np)
    phi = phase_moe(torch, np, PHI_ARCH, PHI_LAYERS, full=False)
    vlm = phase_vlm(torch, np)
    xlstm = phase_xlstm(torch, np)
    hybrid = phase_hybrid(torch, np)
    audio = phase_audio(torch, np)
    large = {arch: phase_large_dense(torch, np, arch) for arch in LARGE_DENSE}
    seqpar = phase_seqpar(torch)
    families = phase_train_mesh_families(torch)
    rtrain = phase_recurrent_train(torch)
    cap2 = phase_capacity_data2(torch)
    mdec = phase_mesh_decode(torch, np)
    examples = phase_examples(torch)
    cal = phase_dryrun_cal(torch, dry_procs, dry_t0, train, train_tp,
                           card_peak, rtrain)
    for arch, o in paper.items():
        print(f"[paper] {arch} ({PAPER_LAYERS[arch]} layers): "
              f"{o['blocks']} pool blocks, host tier {PAPER_HOST_BYTES} B; "
              f"doc hit rate "
              f"{o['doc_hit_rate']:.4f}; tier hit tokens {o['tier']}; "
              f"{o['stats'][0]:.1f} tokens/s, TTFT p50 {o['stats'][1]:.1f} "
              f"ms; eps {o['eps']:g}", flush=True)
    for name, n, flips, low, eps in FLIPS:
        print(f"[margins] {name}: {flips} of {n} streams flipped, smallest "
              f"reference top-2 margin at a flip "
              f"{'none' if low is None else f'{low:.4e}'} (eps {eps:g})",
              flush=True)
    # launches: the main serve's for the paged kernels; the CAG phase's
    # (preload + serve) for the prefix kernel, whose path it is
    by_path = {"paged_decode_attention": {
                   "main serve": launches["paged_decode_attention"],
                   "chunk reuse": chunk["decode"],
                   "chunk reuse check": chunk["main_decode"],
                   "replicas 2": fleet["decode"],
                   "front door": door["decode"]},
               "paged_prefill_attention": {
                   "main serve": launches["paged_prefill_attention"],
                   "chunk reuse": chunk["prefill"],
                   "chunk reuse check": chunk["main_prefill"],
                   "replicas 2": fleet["prefill"],
                   "front door": door["prefill"]},
               "prefix_flash_attention": {
                   "cag preload": cag["preload"], "cag serve": cag["serve"],
                   "dense serve": dense, "sequential check": seq,
                   "train step": train["launches"],
                   "train step, (2, 2) mesh": train_tp["launches"]}}
    for key, n in seqpar["launches"].items():
        by_path["prefix_flash_attention"][
            f"{SEQPAR_ARCH} {key} prefill, (1, 4) mesh"] = n
    for arch, o in families["runs"].items():
        if o["mesh"][2]:
            by_path["prefix_flash_attention"][
                f"{arch} train step, (2, 2) mesh"] = o["mesh"][2]
    by_path["prefix_flash_attention"][
        f"{MOE_ARCH} capacity train step, (2, 1) mesh"] = cap2["launches"]
    for arch, o in mdec["runs"].items():
        for dt, n in o["launches"].items():
            if n:
                by_path["prefix_flash_attention"][
                    f"{arch} {dt} prefill, {o['shape']} mesh decode"] = n
    for name in ("paged_decode_attention", "paged_prefill_attention"):
        by_path[name]["fault serve"] = fault["launches"][name]
        by_path[name]["hops serve"] = hops["launches"][name]
        for arch, o in (("qwen2-0.5b", tp_qwen),
                        ("mistral-7b", paper["mistral-7b"]["tp"]),
                        (MOE_ARCH, moe["tp"])):
            for key, n in o["launches"].items():
                by_path[name][f"{arch} {key}"] = n[name]
    for arch, o in paper.items():
        for name, n in o["launches"].items():
            if name != "prefix_flash_attention":
                by_path[name][f"{arch} main serve"] = n
        by_path["prefix_flash_attention"][f"{arch} sequential check"] = \
            o["seq"]["prefix_flash_attention"]
        if "window" in o:
            by_path["paged_decode_attention"][f"{arch} window"] = \
                o["window"]["decode"]
            by_path["paged_prefill_attention"][f"{arch} window"] = \
                o["window"]["prefill"]
    for arch, o in ((MOE_ARCH, moe), (PHI_ARCH, phi), (VLM_ARCH, vlm),
                    *large.items()):
        for name, n in o["launches"].items():
            if name != "prefix_flash_attention":
                by_path[name][f"{arch} main serve"] = n
    for arch, o in large.items():
        by_path["prefix_flash_attention"][f"{arch} sequential check"] = \
            o["seq"]
        print(f"[large] {arch}: {o['blocks']} pool blocks; doc hit rate "
              f"{o['doc_hit_rate']:.4f}; tier hit tokens {o['tier']}; "
              f"{o['stats'][0]:.1f} tokens/s, TTFT p50 {o['stats'][1]:.1f} "
              f"ms; longest sequence {o['longest']}; kernels vs plain "
              f"{o['plain_linf']:.4e} ("
              f"{'within' if o['plain_linf'] <= o['eps'] else 'PAST'} "
              f"paper_eps {o['eps']:g}; eps {o['large_eps']:.4f}); phase "
              f"wall {o['wall']:.1f}s", flush=True)
    by_path["prefix_flash_attention"][f"{MOE_ARCH} sequential check"] = \
        moe["seq"]
    by_path["prefix_flash_attention"][f"{PHI_ARCH} sequential check"] = \
        phi["seq"]
    for name, o in examples["runs"].items():
        by_path["prefix_flash_attention"][f"examples/torch_{name}.py"] = \
            o["launches"]
    by_path["prefix_flash_attention"][f"{HYBRID_ARCH} train step, "
                                      f"{RECURRENT_TRAIN_BATCH}"] = \
        rtrain["runs"][HYBRID_ARCH]["launches"]
    by_path["prefix_flash_attention"][f"{VLM_ARCH} patch prefill"] = \
        vlm["patches"]
    by_path["prefix_flash_attention"][f"{HYBRID_ARCH} serve"] = \
        hybrid["launches"]["prefix_flash_attention"]
    by_path["prefix_flash_attention"][f"{AUDIO_ARCH} prefill"] = \
        audio["launches"]
    print(f"[moe] {MOE_ARCH} ({MOE_LAYERS} layers): GPU tier "
          f"{MOE_GPU_BYTES} B = {moe['blocks']} pool blocks; doc hit rate "
          f"{moe['doc_hit_rate']:.4f}; tier hit tokens {moe['tier']}; "
          f"{moe['stats'][0]:.1f} tokens/s, TTFT p50 {moe['stats'][1]:.1f} "
          f"ms; paper eps {moe['eps']:g}, MoE eps {moe['moe_eps']:.4f}; "
          f"capacity dropped "
          f"{moe['capacity']['dropped']} of {CAPACITY_ROWS} rows; phase "
          f"wall {moe['wall']:.1f}s", flush=True)
    print(f"[phi] {PHI_ARCH} ({PHI_LAYERS} layers): GPU tier "
          f"{phi['gpu_bytes']} B = {phi['blocks']} pool blocks; doc hit rate "
          f"{phi['doc_hit_rate']:.4f}; tier hit tokens {phi['tier']}; "
          f"{phi['stats'][0]:.1f} tokens/s, TTFT p50 {phi['stats'][1]:.1f} "
          f"ms; paper eps {phi['eps']:g}, MoE eps {phi['moe_eps']:.4f}; "
          f"phase wall {phi['wall']:.1f}s", flush=True)
    for arch, o in rtrain["runs"].items():
        ab = o["ab"]
        rel = max(d / t if t else 0.0 for _, d, t, _ in ab["grads"])
        print(f"[recurrent_train] {arch}: scan peak chunk={SCAN_CHUNK} "
              f"{ab['peak']} B vs unchunked {ab['peak_whole']} B; grads max "
              f"|d| / max |g| {rel:.3e}; step loss {o['loss']:.6f}, peak "
              f"{o['args'] + o['above']} B, dry run / card "
              f"{cal['recurrent'][arch]:.4f}; phase wall "
              f"{rtrain['wall']:.1f}s; [examples] phase wall "
              f"{examples['wall']:.1f}s", flush=True)
    for arch, o in ((XLSTM_ARCH, xlstm), (HYBRID_ARCH, hybrid)):
        print(f"[recurrent] {arch}: cold {o['tokens_per_s']:.2f} tokens/s, "
              f"peak {o['peak']} B; warm requests {o['warm']} bit-identical, "
              f"{o['compared']} snapshots unchanged; phase wall "
              f"{o['phase_wall']:.1f}s", flush=True)
    print(f"[audio] {AUDIO_ARCH}: kernel vs plain max L-inf "
          f"{audio['err']:.4e} (eps {audio['eps']:g}); cached vs whole "
          f"{audio['split']:.4e}; phase wall {audio['phase_wall']:.1f}s",
          flush=True)
    print(f"[train] qwen2-0.5b: {train['tok_s']:.0f} tokens/s, peak "
          f"{train['peak']} B, loss {train['losses'][0]:.4f} -> "
          f"{train['losses'][-1]:.4f}, prefix launches a step "
          f"{train['launches']}; phase wall {train['wall']:.1f}s", flush=True)
    print(f"[train tp] {cfg.name} on a {TRAIN_TP_MESH} mesh, shards on one "
          f"card: ms by step {[round(t, 1) for t in train_tp['mesh']['ms']]}"
          f" (one device {[round(t, 1) for t in train_tp['one']['ms']]}); "
          f"peak {train_tp['mesh']['peak']} B (one device "
          f"{train_tp['one']['peak']} B); prefix launches a step "
          f"{train_tp['launches']}; f32 relative {train_tp['f32']}; phase "
          f"wall {train_tp['wall']:.1f}s", flush=True)
    for arch, o in (("qwen2-0.5b", tp_qwen),
                    ("mistral-7b", paper["mistral-7b"]["tp"]),
                    (MOE_ARCH, moe["tp"])):
        print(f"[tp] {arch}, shards on one card: ms a decode step by run "
              f"{ {k: round(ms, 3) for k, ms in o['ms'].items()} }; peak "
              f"device memory above what was held, by run {o['peak']}; "
              f"tp N bit-identical to tp 1 of group N; "
              f"the default tp 1's columns differ at "
              f"{o['default_differs']}"
              f"; phase wall {o['wall']:.1f}s; {card_line(torch)}",
              flush=True)
    print(f"[fault] (recovered, lost) = ({fault['recovered']}, "
          f"{fault['lost']}), {fault['stranded']} blocks stranded; phase "
          f"wall {fault['wall']:.1f}s; [hops] served alphas "
          f"{hops['alphas']}; phase wall {hops['wall']:.1f}s", flush=True)
    print(f"[vlm] {VLM_ARCH}: doc hit rate {vlm['doc_hit_rate']:.4f}; "
          f"{vlm['stats'][0]:.1f} tokens/s, TTFT p50 {vlm['stats'][1]:.1f} "
          f"ms; eps {vlm['eps']:g}; phase wall {vlm['wall']:.1f}s",
          flush=True)
    count = dict(launches, prefix_flash_attention=cag["preload"]
                 + cag["serve"])
    kernels = []
    hd256 = [f"gemma3_{kind}_{tag}" for kind in ("decode", "prefill", "prefix")
             for tag in ("window", "global")]
    for (name, src, replaces), key, extra, hd128 in zip(
            KERNELS, ("decode", "prefill2048", "prefix2048"),
            ({"at_long_rows": times["decode_long"]},
             {"at_sq64": times["prefill64"]},
             {"at_prefix0_sq512": times["prefix512"],
              "at_prefix1700_sq300": times["prefix1700+300"],
              "at_hymba": {k: times[f"hymba_prefix_{k}"]
                           for k in ("window", "global")},
              "at_musicgen": times["musicgen_prefix"],
              "at_train": train["times"]}),
            (("mistral_decode", "llama2_decode", "mistral_decode_window",
              "gemma2_decode", "yi_decode"),
             ("mistral_prefill", "llama2_prefill", "mistral_prefill_window",
              "gemma2_prefill", "yi_prefill"),
             ("mistral_prefix", "llama2_prefix", "gemma2_prefix",
              "yi_prefix"))):
        row = times[key]
        kernels.append(dict(
            {"name": name, "route": "cuda", "source": src,
             "replaces": replaces, "launches": count[name],
             "launches_by_path": by_path[name],
             "max_abs_err": row["max_abs_err"], "ms": row["ms"],
             "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
             "bound_by": row["bound_by"], "library_ms": row["library_ms"],
             "shape": row["shape"], "at_hd128": {k: times[k] for k in hd128},
             "at_hd256": {k: times[k] for k in hd256
                          if k.split("_")[1] in name}},
            **extra))
    print(f"[dryrun_cal] predicted / card peak {cal['ratio']:.4f}; calls "
          f"{cal['calls']}; [seqpar] bits {seqpar['bits']}, flat-gqa "
          f"{seqpar['flat_err']:.3e}, phase wall {seqpar['wall']:.1f}s; "
          f"[train mesh] phase wall {families['wall']:.1f}s; [capacity "
          f"data2] |d loss| {cap2['loss']:.3e}, grad norm {cap2['gnorm']:.3e}"
          f", phase wall {cap2['wall']:.1f}s", flush=True)
    for arch, o in mdec["runs"].items():
        print(f"[mesh decode] {arch} on {o['shape']}: f32 relative "
              f"{o['rel']:.3e}, bf16 first step {o['linf']:.4e} (eps "
              f"{o['eps']:g}); decode ms {o['ms']}; peak {o['peak']} B; "
              f"phase wall {mdec['wall']:.1f}s; {card_line(torch)}",
              flush=True)
    print(f"[done] {time.perf_counter() - t_start:.1f}s wall in all",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

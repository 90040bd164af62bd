#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py`` (``--seed N`` for
other random weights and prompts). Phases, in order; any failure exits
non-zero:

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile the CUDA kernels with nvcc (sm_90a), in parallel.
3. kernels — each kernel against its plain PyTorch version on the card, in
             bf16, f32 and f16 (f16 within F16_TOL), at the two head shapes
             of the engine phase (qwen3-1.7b: H=16 Hkv=8 D=128;
             stablelm-1.6b: H=32 Hkv=32 D=64), with ragged positions,
             sentinel rows, unmapped page-table entries, abort caps and
             Sq=1 prefill against decode (f32 elementwise, bf16 and f16 per
             (row, KV head) by relative L2 with a planted fault); all four
             attention kernels also per (row, KV head) by a relative L2
             over the rows that see >= 512 keys, against a planted fault
             (decode: a 256-key span read twice; prefill: a 128-key tile
             holding the tile before it) that must read above the limit;
             dense decode on a bshd copy equal to bhsd bit for bit; every
             prefill call required on the route ``route(dtype, D)`` names
             (bf16 and f16: the tensor-core "wgmma" body; f32: "simt").
             Each kernel is timed beside its
             plain version and one PyTorch library call, on the device from
             a CUDA graph of 20 calls (``device_ms``; a call may take the
             host longer to enqueue than the device to run), with the
             host's enqueue time (``host_ms``) and the back-to-back loop
             time beside it.
4. model   — qwen3-1.7b at its published width (28 layers, bf16, random
             weights from the seed): one paged 256-token prefill_step for 4
             rows and 8 decode_steps, with use_flash on and off.
5. engine  — the LS+BE paged engine with use_flash: LS qwen3-1.7b, BE
             stablelm-1.6b, 8 slots each, chunk 256, ResourcePlan(sm_be=0.3);
             every prefill launch on the "wgmma" route (both bf16).
6. dense   — an LS-only dense-cache engine with use_flash, likewise;
             then (6b) the LS qwen3-1.7b tenant in f32 (TF32 off), dense
             and paged: every prefill launch on the CUDA-core ("simt")
             body, its launches the f32 rows' engine counts; (6c) the same
             tenant in f16, dense and paged: every prefill launch on the
             tensor-core ("wgmma") body, its launches the f16 rows' engine
             counts; then one full-width f16 paged prefill_step (4 x 256
             tokens) with use_flash on and off: finite logits, within
             F16_MODEL_REL_TOL relative L2 of each other.
7. SGDRC kernels — the kernel layer's co-execution and shadow-page-table
             entry points (``repro_torch.kernels.ops``) at full width:
             flash_attention at qwen3-1.7b heads (causal, bf16, f32 and
             f16; non-causal f32) and gemma2-9b heads (D 256, S 8192,
             window 4096, softcap 50; bf16 and f32); dual_tenant_attention
             (LS B 1 + BE B 4, qwen3 heads, S 2048; bf16, f32 and f16),
             equal bit for bit to flash_attention for sm_be 0.1/0.3/0.9;
             f16 attention within F16_TOL of the plain version (elementwise
             and on late rows); dual_tenant_matmul at qwen3-1.7b's gate
             projection (LS 256 x 2048 @ 2048 x 6144, BE 2048 x 2048 @ the
             same) and down projection (LS 256 x 6144 @ 6144 x 2048, BE
             2048 x 6144 @ the same) in bf16, f32 and f16, each tenant's
             output equal bit for bit across sm_be 0.1/0.3/0.9 and to a
             call with the other tenant empty (bf16, f32), and once in f16
             at a ragged K (the gate projection's K less 2, on the
             CUDA-core body); spt_scatter/spt_gather of a 1 GiB LS and a
             512 MiB BE bf16 tensor through the SPTs of a 2 GiB
             ColoredArena. Each
             against its plain version, and timed beside it, its bound and
             one PyTorch library call. Every bf16 and f16 call of flash,
             dual-tenant attention and the matmul at K and N multiples of 8
             must take the tensor-core ("wgmma") route, and every f32 call
             and the ragged-K f16 matmul the CUDA-core ("simt") route; each
             time is printed with its route, TFLOP/s and host enqueue
             time (``host_ms``: checks, TMA tensor maps, launch), and
             rows 5-7 of the kernels' JSON line carry the drive's
             launches by route; flash's row also carries its f32, f16,
             non-causal f32 and gemma2-9b (D 256) rows, dual-tenant
             attention's its f32 and f16 rows, and the matmul's its f32
             and f16 rows and the down projection's.
8. SSM and hybrid families — (a) ``ops.ssd_scan`` at zamba2-1.2b's mamba2
             widths (B 4, T 2048, H 64, K 64, P 64, chunk 64) with mamba2's
             decays (bf16 and f32), the reference tests' decay range and
             zero decay (f32), against the exact recurrence
             ``ref_ssd_scan`` and the model path's ``chunked_linear_attn``
             within SSD_TOL; chunk 16 bit-equal to chunk 64 (mamba2 bf16,
             f32); a planted fault (the second half of the reference-range
             and zero-decay inputs run alone, its carried state lost) that
             must read above SSD_TOL; the four rows nested in the JSON
             line (``float32``, ``ref_range_float32``, ``zero_float32``);
             (b) zamba2-1.2b at its published width in f32: ``forward``
             (chunk 64) against token-by-token ``prefill`` of 2 x 128
             tokens; (c) the dense engine with use_flash: LS zamba2-1.2b +
             BE rwkv6-7b at half depth (SSM_ENGINE_LAYERS: zamba2's 2
             prefix layers and 3 of its 6 periods, rwkv6 16 of 32 layers;
             published widths), 4 slots each, max_seq 512, sm_be 0.3, 4
             prompts of 64-256 tokens per class in two length groups, 16
             new tokens; every zamba2 decode step launches decode_attention
             once per shared-block invocation (3 at that depth).
9. tidal   — SGDRC's control plane on phase 5's engine and prompts, with
             one set of weights from the seed: KV page pools colored from a
             3 GiB ColoredArena over the tesla-p40 channel hash (12
             channels: the reference's placement bookkeeping over a hash
             model the repo has, not the H100's channels), LS 2 GiB / BE
             1 GiB at ch_be 1/3. Three runs: (a) static, the plan's split;
             (b) tidal, an OnlineController over tidal_frontier (idle
             patience 1, control every 2 quanta) with a ChunkGovernor whose
             target TBT is half phase 5's LS TBT p99; once the lending plan
             is in force two more LS prompts arrive and the next step must
             snap back; (c) static with a mid-run resplit to ch_be 1/2 at
             step 3. Required: every request completes, (b) lends, snaps
             back and adapts the chunk, no LS page group off its colors in
             (b) and none at all after (c)'s resplit, BE peak_active (b) >
             (a), (c)'s tokens equal (a)'s bit for bit, every prefill on
             "wgmma". Printed: transitions, each run's quanta, wall, LS
             TTFT/TBT and BE tokens/s (a smoke), and the host ms of the
             control tick and plan adoption. The resplit makes no device
             copy (placement bookkeeping, as in the reference).
10. hierarchy — the KV memory hierarchy and the fault plane on phase 5's
             engine (uncolored) and weights, 8 LS prompts of one 768-token
             prefix and 8 BE prompts of one 512-token prefix (suffixes of
             64-256 tokens), 32 new tokens; each tenant's first request
             warms before the other 7 arrive. (a) prefix cache off and on:
             tokens bit-equal, LS hit tokens >= 7 x 768, prefill tokens
             computed lower by exactly the hit tokens; a planted fault (one
             shared tree page's K zeroed) must change later hits' tokens;
             an 800-token LS prefix (not a multiple of the chunk) reported:
             tokens equal or the first diverging request, token and K/V
             layer. (b) grow_pages + swap at half the batch's full page
             extent, cold_dtype fp16 and int8: every request completes,
             fp16 swaps out and in and its tokens equal (a)'s unpressured
             run; bytes, pcie_s and host ms a put and a get printed. (c) a
             seeded FaultPlane storm (swap write/read failures, page
             corruption, allocator faults) over (b)'s fp16 run on a
             virtual step clock: injections, recoveries and a CRC catch
             required, survivors bit-equal to (b), LS never shed. Then the
             ladder's flash_to_dense rung on phase 6b's f32 LS tenant: its
             tokens equal the torch-op engine's and no kernel launches
             after it. Every bf16 prefill of (a)-(c) on "wgmma".
11. disaggregation and the launcher — (a) phase 5's 8 LS qwen3-1.7b
             prompts and LS weights (bf16, paged, page 16, chunk 256,
             max_seq 2048, use_flash, 8 slots a slice, 32 new tokens):
             co-located on a virtual clock of 1 ms a quantum, then the
             DisaggregatedEngine over the modeled interconnect (host star,
             its virtual clock), pipelined twice, whole-group, and at 4
             devices with 2 prefilling; the modeled devices share the one
             card. Required: every request's tokens in every run bit-equal
             to co-located, the two seeded pipelined runs' fingerprints
             equal, 8 migrations delivered, xfer_bytes exactly the pages
             shipped x WIRE_PAGE_BYTES (and the pages the prompts' own),
             every prefill launch on "wgmma", the decode slice launching
             decode_attention_paged and the prefill slice no decode; in the
             first run every page the decode slice restores bit-equal to
             the prefill slice's page as shipped, and a planted fault (one
             bf16 exponent bit of a wire page flipped after its CRC, the
             pool's check off) read by that check. Printed: each run's
             wall, host ms a wire put and get, flows and flows a request,
             the decode slice's TTFT and TBT p50/p99 on the virtual clock,
             work_conservation, launches by slice. (b) the launcher
             ``repro_torch.launch.serve.main`` in-process at its defaults
             (LS qwen3-1.7b, BE gemma2-9b smoke configs in f32) with six
             flag sets (LAUNCH_SETS): every metrics JSON parses, every
             request completes (on sim: the LS stream; BE is modeled over
             the launcher's horizon), each run launches exactly the kernels
             of its KV path (paged or dense; none on sim) with every
             prefill on "simt", every one of those launches (the inputs
             copied at the call) within TOL of its plain version at the
             shapes the run gave it (H 4, Hkv 2, D 32, page 8), a planted
             fault in one output caught, each --use-flash run's tokens
             equal to the same flags' run without it (which launches no
             kernel), and the trace's JSONL passes
             ``repro_torch.obs.schema``.
12. families — (a) phase 5's LS qwen3-1.7b tenant (its weights and
             prompts) beside BE moonshot-v1-16b-a3b at the reference's
             config (48 layers, d_model 2048, MHA 16 x 128, 64 experts
             top-6, 2 shared, expert width 1408, 1 dense layer, vocab
             163840, bf16, 28.39 B parameters; the published Moonlight
             model has 27 MLA layers and 16 B), paged, page 16, max_seq 2048, chunk 256,
             8 slots a tenant, sm_be 0.3, flash, 8 BE prompts of 512-1536
             tokens, 32 new tokens: a timed run (every request completes,
             every prefill on "wgmma"; printed: wall, quanta, both
             classes' TTFT/TBT p50/p99 and tokens/s, the MoE dropped_frac
             per prefill call, the wall of each BE decode step, the peak
             memory), then the same run with every kernel launch held
             against its plain version on the card on copies of its inputs
             taken at the call (a planted fault caught) and its tokens
             equal to the timed run's. (b) one MoE layer at moonshot's
             width, T = 8 x 256, bf16: top-k indices, keep masks and
             positions equal to ``moe_forward_plain``'s (which shares no
             code with the layer), drops present,
             each token's output within MOE_REL_TOL (relative L2), a kept
             slot's gate zeroed read above it. (c) deepseek-v2-236b at full
             width, MLA_LAYERS deep (1 dense + 3 MoE layers), LS alone, 4
             slots, paged then dense with the same weights: tokens
             bit-equal, no kernel launched, the latent pool at (512 + 64)
             x 2 B a token a layer. (d) whisper-small whole and
             llama-3.2-vision-90b one period (4 global + 1 cross layer), f32,
             TF32 off: ``forward`` against 16 ``decode_step(use_flash)``
             calls, each dense decode_attention launch (H 12 / D 64; H 64
             / Hkv 8 / D 128) held against its plain version at the call:
             whisper's first decoder layer (its cross block over the whole
             encoder) and llama's first global and first cross layer
             within 2e-3; the whole decoder a smoke of finite logits, its
             distance printed, not held (a random-weight stack amplifies
             rounding, the reference's too: 2.90 for whisper-small on the
             CPU).
             Each part starts from freed memory and prints its peak.
13. coloring — the paper's channel reverse engineering (Algo 1-3 and the
             granularity probe) on the simulated rtx-a2000 (host numpy):
             15000 addresses of a 64 MiB space labelled by channel conflict,
             every channel found, label accuracy > 0.97, granularity 2 KiB;
             then ``fit_channel_hash`` on the card at the reference's
             defaults (9 layers of 256, 3000 Adam steps of 1024) on those
             samples: test accuracy > 0.95 and agreement with the hash on
             every page of the space it did not see >= 0.95; steps/s
             printed. (The repo has no model of the H100's own channels.)
14. long sequence — qwen3-1.7b at full width, bf16, B 1, S 32768 (the
             reference's prefill_32k): ``forward(last_only=True)`` on the
             query-blocked attention path (no kernel; peak below 24 GiB,
             where [B, H, S, S] f32 scores alone would take 68.7 GB a
             layer), against the same tokens through paged
             ``prefill_step`` in 32 chunks of 1024 with use_flash (every
             prefill_attention_paged launch on "wgmma"): last-position
             logits within MODEL_REL_TOL; one layer's blocked attention
             at qwen3-1.7b's heads, S 32768, recorded (grad on, its saved
             tensors dropped) and lean (no grad): bit-equal, each peak
             printed; then the chunked run again with
             every launch held against its plain version on copies of its
             inputs taken at the call (relative L2 per (row, KV head)
             within LATE_REL_TOL, Skv up to 32768 over a 2048-page table),
             its logits equal to the timed run's, and three planted faults
             on the last launch caught (a block scaled by 1.1, the chunk's
             own 64 pages read as the 64 before them, pages 1024-2047 read
             as pages 0-1023).
15. training — (a) one step of qwen3-1.7b at full width, 2 layers, S
             2304 (a ragged last query block), batch 1, on the card
             against the same params and batch on the CPU: f32 gradients
             (TF32 off) within 1e-4 relative L2 on every leaf; remat
             "full" against "none" in bf16 within 1e-3; bf16 remat "full"
             against the CPU's f32 within MODEL_REL_TOL; AdamW in place on
             the card against the CPU on the same gradients (the params'
             update, m and v) within 1e-6. One full-width qwen3-1.7b step
             at S 4096 with the loss's NLL in its plain form (f32 logits
             whole) and row-blocked: each peak, the loss's and the worst
             leaf's gradient gap within REMAT_TOL. grouped attention's
             softmax·V at whisper-small's encoder shapes (B 4, S 1500, H
             12, D 64, bf16) against the plain graph: output and gradients
             bit-equal, the bytes each keeps for the backward pass. Then
             qwen3-1.7b at full width,
             f32 params, bf16
             activations, remat "full", seq 4096 at batch 1 (train_4k's
             256 rows cut to 1), 6 ``Trainer`` steps: every loss and grad
             norm finite, step 0's loss equal to a separate ``loss_fn``
             within MODEL_REL_TOL; step ms and tokens/s printed beside the
             card. (b) ``repro_torch.launch.train.main`` on the qwen3
             smoke config, 16 steps with a checkpoint dir, with
             deterministic algorithms on: stopped at step 8 and resumed,
             its steps 8-15 losses bit-equal to an uninterrupted run, the
             last loss below the first.
16. sharding — (a) qwen3-1.7b at full width in 15a's setting (f32
             params, bf16 activations, remat "full", S 4096 x 1), 3
             ``Trainer`` steps with no mesh and then on a 1x1 (data,
             model) mesh of an NCCL group of one rank (DTensor params,
             ZeRO-1 moments, batches placed over the batch axes), from the
             same seed and batches, deterministic algorithms on for both:
             step 0's loss within SHARD_LOSS_TOL (bit-equal), the later
             steps' within SHARD_STEP_TOL (one rounding step of a gradient
             leaf, carried by AdamW), bit equality printed, step ms and
             peak beside the card; (b) the unsharded run's params
             checkpointed and restored onto the mesh
             (``restore(shardings=...)``): every leaf's ``full_tensor()``
             bit-equal; (c) ``python -m repro_torch.launch.dryrun`` at full
             width, the pinned cells (``PIN_CELLS``: qwen3-1.7b,
             rwkv6-7b, whisper-small and zamba2-1.2b ``train_4k`` on the
             fake 16x16 mesh, deepseek-v2-236b and llama-3.2-vision-90b
             ``decode_32k`` on the fake 2x16x16 mesh) and the smoke cells,
             each in a subprocess on the host (a fake group cannot share a
             process with NCCL), started with phase 14 and read last: each
             records ``ok``, is held to ``tests/torch_dryrun_pins.json``
             and gives the reference's fits-in-80-GB verdict; per-device
             argument and temp GiB, FLOPs and wire bytes by kind
             printed. The process group is destroyed
             at the end of the phase.

Launch counts of phases 5, 6, 6b, 6c, 7, 8a, 8c and 9-12 are read with the
counters set to 0 just before each phase drives its path (phases 7 and 8a
count their drive, before their checks and timings). The next-to-last line
is one JSON object with every kernel's launches and times (phase 3's f32
rows of the four engine kernels under "float32", with phase 6b's launches,
and its f16 rows under "float16", with phase 6c's;
phase 9's runs under "tidal_launches", phase 10's (a)-(c) under
"hierarchy_launches" and phase 11a's runs under "disagg_launches" of the
two paged rows, phase 11b's launches by flag set and their worst error
under "launcher" of the four engine kernels' rows, phase 12's under
"families_launches" of rows 1-3, phase 14's under "long_seq_launches" of
row 2); the last line is the device JSON. ``--from N`` (or ``--start
N``), N in 10-16, runs phases 1-3 and phase N alone, or N through
``--until``; ``--until N`` stops after phase N (no result lines either
way).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PAGE = 16
# kernel tolerances of the reference's tests/test_kernels.py
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# phase 7 attention, beside TOL: the relative L2 error of each (batch row,
# head) over the late query rows [S/2, S). TOL alone is blind there: a row
# that sees n keys of N(0, 1) values has outputs of about sqrt(e / n), some
# 0.03 at n 2048, the size of TOL's bf16 atol. A sound kernel misses by a
# few bf16 roundings (the output on each side, P once in the kernel); a key
# tile dropped or read twice by ~sqrt(128 / n). Every run also measures a
# planted fault of that kind and requires it above the limit.
# Phase 3 holds both decode kernels to the same limits per (row, KV head)
# over the rows that see >= 512 keys (outputs of ~sqrt(e / n) there too);
# its planted fault is one 256-key span of a long row holding the span
# before it, as a split read twice would give.
LATE_REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# Sq == 1 prefill against decode. f32, elementwise (rtol, atol): two
# CUDA-core bodies that sum in f32 in other orders, within the reference's
# 2e-6 (tests/test_kernels.py).
SQ1_TOL = {"float32": (2e-6, 2e-6)}
# bf16 and f16: the prefill body rounds P to the type for P.V on the tensor
# cores, decode keeps P in f32, so an elementwise bound of one output
# rounding (bf16: rtol 2^-7, atol 1e-4) fails on short rows' near-zero
# outputs: excess over it 2.2e-4 to 1.4e-3 (H100, both models, paged and
# dense). Held instead per (row, KV head) by the relative L2 between the
# two bodies: bf16 sound 2.85e-3 to 4.22e-3; a planted fault (one 128-key
# tile of a long row holding the tile before it) 0.235 to 0.304. The limit
# sits between, as LATE_REL_TOL's: a few roundings against a tile-sized
# fault. f16 rounds 8x finer (2^-11 against 2^-8), so its limit is 10x
# lower.
SQ1_REL_TOL = {"bfloat16": 2e-2, "float16": 2e-3}
# f16 kernels: f16 inputs rounded the same on both sides, so kernel and
# plain version differ by f32 summation order and one output rounding
# (2^-11 of the value) each; on the tensor-core bodies (chunked prefill,
# phase 7's attention) also by the kernel's rounding of P to f16 for P.V
# (2^-11 of each weight; the plain version keeps P in f32). On late rows a
# few roundings of 2^-11 against a dropped or repeated key tile's ~0.1.
F16_TOL = 2e-3
ATTN_TOL = dict(TOL, float16=F16_TOL)
ATTN_LATE_REL_TOL = dict(LATE_REL_TOL, float16=2e-3)
# phase 6c: last-position logits of one full-width f16 prefill_step with
# use_flash against without, relative L2. MODEL_REL_TOL's reasoning with
# f16's 8x finer roundings (2^-11 against 2^-8): a sound kernel ~1e-3, a
# wrong one O(1).
F16_MODEL_REL_TOL = 1e-2
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12}
# model phase: last-position logits of flash vs torch-op attention in bf16.
# Both paths round each layer's attention output to bf16 (2^-8 relative)
# at different places, and those roundings compound through 28 residual
# layers and the final norm; 5e-2 relative L2 bounds that drift while still
# failing on a wrong kernel (which gives O(1) relative error).
MODEL_REL_TOL = 5e-2
# phase 9: the colored arena's bytes (LS 2 GiB, BE 1 GiB at ch_be 1/3)
TIDAL_ARENA_BYTES = 3 << 30
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {
    "decode_attention_paged": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                               "src/repro/kernels/decode_attention.py:181"),
    "prefill_attention_paged": ("src/repro_torch/kernels/csrc/prefill_attention.cu",
                                "src/repro/kernels/prefill_attention.py:210"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:131"),
    "prefill_attention": ("src/repro_torch/kernels/csrc/prefill_attention.cu",
                          "src/repro/kernels/prefill_attention.py:148"),
    "flash_attention": (CSRC + "flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:79"),
    "dual_tenant_attention": (
        CSRC + "dual_tenant_attention.cu",
        "src/repro/kernels/dual_tenant_attention.py:136"),
    "dual_tenant_matmul": (CSRC + "dual_tenant_matmul.cu",
                           "src/repro/kernels/dual_tenant_matmul.py:121"),
    "spt_gather": (CSRC + "spt_gather.cu",
                   "src/repro/kernels/spt_gather.py:27"),
    "spt_scatter": (CSRC + "spt_gather.cu",
                    "src/repro/kernels/spt_gather.py:49"),
    "ssd_scan": (CSRC + "ssd_scan.cu", "src/repro/kernels/ssd_scan.py:59"),
}
# dual_tenant_matmul (rtol, atol). f32: the reference's. bf16 and f16: the
# kernel and the plain version each round an f32 sum (within f32 noise of
# each other) to the type once, so they land on the same or a neighbouring
# value: one output rounding, at most 2^-7 (bf16) or 2^-10 (f16) of the
# value apart.
MATMUL_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2 ** -7, 1e-4),
              "float16": (2 ** -10, 1e-4)}
SPT_ARENA_BYTES = 2 << 30
HEADS = {"qwen3-1.7b": (16, 8, 128), "stablelm-1.6b": (32, 32, 64)}
# ssd_scan: |got - want| <= rtol * |want| + atol * max(1, max |want|). The
# kernel and both plain versions sum in f32 in other orders, an error that
# grows with the partial sums, not with the element: at zero decay y is a
# running sum of 2048 outer products (|y| up to ~1400), and the chunked
# and step-by-step plain versions alone differ by 1.5e-3 there (measured on
# the CPU at B 1, H 2). bf16 adds one output rounding on each side (2^-8
# of the value each).
SSD_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2 ** -7, 2e-4)}
# phase 8b, one layer: zamba2-1.2b's first mamba2 layer over 2 x 128
# tokens, chunked (chunk 64) against token by token with the state and
# conv rows carried, f32 with TF32 off: the same recurrence in two
# summation orders, relative L2. The reference's clamped scan misses the
# exact recurrence by O(1) at mamba2's decays (about -0.8 a token, -50 a
# chunk).
LAYER_REL_TOL = 1e-4
# phase 8b, the model: the random-weight 38-layer stack amplifies rounding
# (at smoke width the reference moves its logits by 3e-4 when its
# embedding is scaled by 1 + 1e-6), so the chunked forward is held to the
# token-by-token prefill relative to the stack's own noise, measured in
# the same run as forward at chunk 64 against forward at chunk 16: within
# 10x that, and never worse than the reference's 1.42 (smoke width).
MODEL_NOISE_FACTOR, MODEL_REL_CAP = 10.0, 0.5


def log(*a):
    print(*a, flush=True)


class Check(RuntimeError):
    pass


def require(ok, what):
    if not ok:
        raise Check(what)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def graph_ms(fn, iters=20, replays=5):
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph, replayed. Where enqueueing a call takes the host longer than
    the device needs to run it (a decode step), ``cuda_ms`` measures the
    host; the graph's replay does not wait on the host between calls."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    t1.synchronize()
    del graph
    return t0.elapsed_time(t1) / (iters * replays)


def host_ms(fn, iters=50):
    """Mean host time to enqueue ``fn`` (the wrapper's checks, its TMA
    tensor-map encoding and the launch), with nothing waited on."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / iters


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _bound_ms(kv_keys, B, Sq, H, Hkv, D, itemsize, q_rows_keys, dtype):
    """Least time for the work this call's data needs: the K/V bytes of the
    keys each (row, kv head) visits plus q and out once, over the HBM rate;
    or 4*D flops per visible (query row, key) pair over the type's peak."""
    nbytes = (2 * kv_keys * Hkv * D + 2 * B * Sq * H * D) * itemsize
    flops = 4.0 * D * q_rows_keys * H
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _paged_case(torch, gen, B, Sq, H, Hkv, D, dtype, n_pages, P, pos):
    """Random pools, and a page table mapping each row's needed pages to
    distinct random pages; the rest of each row is unmapped (n_pages), and
    one entry of a row's tail is negative."""
    dev = "cuda"
    q = torch.randn(B, Sq, H, D, generator=gen, device=dev).to(dtype)
    kp = torch.randn(n_pages, Hkv, PAGE, D, generator=gen, device=dev) \
        .to(dtype)
    vp = torch.randn(n_pages, Hkv, PAGE, D, generator=gen, device=dev) \
        .to(dtype)
    perm = torch.randperm(n_pages, generator=gen, device=dev).cpu()
    pt = torch.full((B, P), n_pages, dtype=torch.int32)
    used = 0
    for b, p in enumerate(pos):
        need = min(-(-(p + Sq) // PAGE), P) if p < P * PAGE else 0
        pt[b, :need] = perm[used:used + need].to(torch.int32)
        used += need
        if need < P:
            pt[b, -1] = -1
    return q, kp, vp, pt.to(dev)


def _keys_seen(pos, Sq, window, abort=None):
    """(K/V keys the call must read, visible (query row, key) pairs) per
    kv head, summed over rows."""
    kv = pairs = 0
    for b, p in enumerate(pos):
        cap = Sq if abort is None else min(max(abort[b], 0), Sq)
        if cap == 0:
            continue
        kv += min(p + cap - 1, window - 1) + 1
        pairs += sum(min(p + s, window - 1) + 1 for s in range(cap))
    return kv, pairs


def _long_rows(pos, window):
    """The batch rows of a decode that see >= 512 keys."""
    return [b for b, p in enumerate(pos) if min(p, window - 1) + 1 >= 512]


def _rel_rows(got, want, rows, Hkv):
    """Relative L2 error of ``got`` against ``want`` ([B, H, D]) per (row,
    KV head) of ``rows``: [len(rows), Hkv]."""
    d = (got.float() - want.float())[rows].reshape(len(rows), Hkv, -1)
    w = want.float()[rows].reshape(len(rows), Hkv, -1)
    return d.norm(dim=2) / w.norm(dim=2)


def _rel_late_prefill(torch, got, want, pos, window, Hkv):
    """Relative L2 error of ``got`` against ``want`` ([B, Sq, H, D]) per
    (row, KV head) over the chunk positions that see >= 512 keys: [rows
    that have such positions, Hkv]."""
    B, Sq = want.shape[:2]
    seen = torch.clamp(torch.tensor(pos)[:, None] + torch.arange(Sq)[None],
                       max=window - 1) + 1
    sel = (seen >= 512).to(want.device)[:, :, None, None]
    d = ((got.float() - want.float()) * sel).reshape(B, Sq, Hkv, -1)
    w = (want.float() * sel).reshape(B, Sq, Hkv, -1)
    rel = d.square().sum((1, 3)).sqrt() / w.square().sum((1, 3)).sqrt()
    return rel[sel[:, :, 0, 0].any(1)]


def _planted_tile(k, v, b, t0):
    """Dense [B, S, Hkv, D] K/V with row b's key tile [t0, t0 + 128)
    holding the tile before it, as a ring stage used twice would give."""
    k2, v2 = k.clone(), v.clone()
    k2[b, t0:t0 + 128], v2[b, t0:t0 + 128] = k[b, t0 - 128:t0], \
        v[b, t0 - 128:t0]
    return k2, v2


def _planted_span(k, v, b, t0):
    """Dense [B, S, Hkv, D] K/V with row b's keys [t0, t0 + 256) replaced by
    the 256 before them: a split read twice."""
    k2, v2 = k.clone(), v.clone()
    k2[b, t0:t0 + 256], v2[b, t0:t0 + 256] = k[b, t0 - 256:t0], \
        v[b, t0 - 256:t0]
    return k2, v2


def kernel_phase(torch, seed):
    from repro_torch.kernels import decode_attention as kd
    from repro_torch.kernels import prefill_attention as kp_
    from repro_torch.kernels import ref
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(seed)
    results = {}
    B, P, n_pages = 8, 2048 // PAGE, 1024
    window = P * PAGE
    sentinel = window
    dec_pos = [0, 17, 130, 511, 1000, 1500, sentinel, 1777]
    pre_pos = [0, 16, 300, 511, 1024, 1600, sentinel, 1792]
    Sq = 256
    aborts = [0, 1, 3, Sq, Sq + 5, 3, Sq, 1]
    for model, (H, Hkv, D) in HEADS.items():
        G = H // Hkv
        for dname in ("bfloat16", "float32", "float16"):
            dtype = getattr(torch, dname)
            tol = ATTN_TOL[dname]
            main = dname == "bfloat16"
            tag = f"{model} {dname}"

            def rec(name, err, ms=None, plain_ms=None, lib_ms=None,
                    bound=None, host=None, loop=None):
                log(f"  {name:24s} {tag:26s} max_abs_err={err:.3e}"
                    + ("" if ms is None else
                       f" {'ms' if host is None else 'device_ms'}={ms:.4f} "
                       f"plain_ms={plain_ms:.4f} "
                       f"library_ms={lib_ms:.4f} bound_ms={bound[0]:.4f}"
                       f" ({bound[1]})")
                    + ("" if host is None else
                       f" host_ms={host:.4f} loop_ms={loop[0]:.4f} "
                       f"library_loop_ms={loop[1]:.4f} of_bound="
                       f"{bound[0] / ms:.3f} vs_library={ms / lib_ms:.3f}"))
                require(err == err, f"{name} {tag}: NaN in the output")
                if model == "qwen3-1.7b" and ms is not None:
                    row = {"max_abs_err": err, "ms": ms,
                           "plain_ms": plain_ms, "library_ms": lib_ms,
                           "bound_ms": bound[0], "bound_by": bound[1],
                           "of_bound": bound[0] / ms,
                           "vs_library": ms / lib_ms, "host_ms": host}
                    if main:
                        results[name] = row
                    else:  # the bf16 row comes first
                        row["vs_bfloat16"] = ms / results[name]["ms"]
                        log(f"  {name:24s} {tag:26s} vs bfloat16 "
                            f"{row['vs_bfloat16']:.3f}")
                        results[name][dname] = row

            def close(a, b, what):
                err = (a.float() - b.float()).abs().max().item()
                ok = torch.allclose(a.float(), b.float(), rtol=tol, atol=tol)
                require(ok, f"{what} {tag}: not within {tol} (max abs "
                            f"{err})")
                return err

            def late(name, sound, planted):
                """The late-row check: ``sound``, the kernel's relative L2
                per (row, KV head) over the rows that see >= 512 keys,
                within LATE_REL_TOL; ``planted``, the planted fault's
                reading (its row's least over KV heads), above it."""
                lim = ATTN_LATE_REL_TOL[dname]
                sound, planted = sound.max().item(), planted.min().item()
                log(f"  {name:24s} {tag:26s} rows >= 512 keys: relative L2 "
                    f"{sound:.3e}, planted fault {planted:.3e} (limit {lim})")
                require(sound <= lim, f"{name} {tag}: relative L2 {sound} "
                                      f"over {lim}")
                require(planted > lim, f"{name} {tag}: the late-row check "
                                       f"misses a planted fault ({planted})")

            def sq1(one, dec, fault, fault_row, what):
                """Sq = 1 prefill against decode: f32 elementwise within
                SQ1_TOL; bf16 and f16 (the tensor-core body) per (row, KV
                head) by relative L2 within SQ1_REL_TOL, a planted fault's
                reading above it."""
                d = (one.float() - dec.float()).abs()
                rel = _rel_rows(one, dec, list(range(one.shape[0])),
                                Hkv).max().item()
                planted = _rel_rows(one, fault, [fault_row], Hkv).min() \
                    .item()
                log(f"  Sq=1 {what:19s} {tag:26s} prefill vs decode: max abs "
                    f"{d.max().item():.3e}, relative L2 per (row, KV head) "
                    f"{rel:.3e}, planted fault {planted:.3e}")
                if dname in SQ1_TOL:
                    rtol, atol = SQ1_TOL[dname]
                    require(bool((d <= atol + rtol * dec.float().abs())
                                 .all()),
                            f"Sq=1 {what} prefill != decode {tag} (max abs "
                            f"{d.max().item()})")
                    return
                lim = SQ1_REL_TOL[dname]
                require(rel <= lim, f"Sq=1 {what} prefill vs decode {tag}: "
                                    f"relative L2 {rel} over {lim}")
                require(planted > lim, f"Sq=1 {what} {tag}: the check misses "
                                       f"a planted fault ({planted})")

            def routed(fn, call):
                """``call()``, required to launch ``fn`` once on the route
                ``kp_.route`` names for this dtype and head dim."""
                way, before = kp_.route(dtype, D), dict(fn.routes)
                out = call()
                require(fn.routes == {**before, way: before[way] + 1},
                        f"{fn.__name__} {tag}: routes {fn.routes}, want one "
                        f"more launch on {way} than {before}")
                return out

            # -- 1: paged decode --------------------------------------
            q, kpool, vpool, pt = _paged_case(
                torch, gen, B, 1, H, Hkv, D, dtype, n_pages, P, dec_pos)
            q1 = q[:, 0].contiguous()
            posd = torch.tensor(dec_pos, dtype=torch.int32, device="cuda")
            out = kd.decode_attention_paged(q1, kpool, vpool, pt, posd)
            want = ref.ref_decode_attention_paged(q1, kpool, vpool, pt, posd)
            err = close(out, want, "decode_attention_paged")
            kdense = ref.gather_pages(kpool, pt)
            vdense = ref.gather_pages(vpool, pt)
            fr = dec_pos.index(1777)     # the longest row with its own pages
            late("decode_attention_paged",
                 _rel_rows(out, want, _long_rows(dec_pos, window), Hkv),
                 _rel_rows(ref.ref_decode_attention(
                     q1, *_planted_span(kdense, vdense, fr, 1024), posd),
                     want, [fr], Hkv))
            kr = kdense.repeat_interleave(G, dim=2).transpose(1, 2)
            vr = vdense.repeat_interleave(G, dim=2).transpose(1, 2)
            mask = (torch.arange(window, device="cuda")[None, :]
                    <= posd[:, None])[:, None, None, :]
            kvk, pairs = _keys_seen(dec_pos, 1, window)

            def kern():
                return kd.decode_attention_paged(q1, kpool, vpool, pt, posd)

            def lib():
                return F.scaled_dot_product_attention(q1[:, :, None], kr, vr,
                                                      attn_mask=mask)
            rec("decode_attention_paged", err, graph_ms(kern),
                cuda_ms(lambda: ref.ref_decode_attention_paged(
                    q1, kpool, vpool, pt, posd), iters=5),
                graph_ms(lib),
                _bound_ms(kvk, B, 1, H, Hkv, D, q.element_size(), pairs,
                          dname),
                host_ms(kern), (cuda_ms(kern), cuda_ms(lib)))

            # -- 2: paged chunked prefill, abort/progress ------------
            q, kpool, vpool, pt = _paged_case(
                torch, gen, B, Sq, H, Hkv, D, dtype, n_pages, P, pre_pos)
            posp = torch.tensor(pre_pos, dtype=torch.int32, device="cuda")
            fn = kp_.prefill_attention_paged
            out = routed(fn, lambda: fn(q, kpool, vpool, pt, posp))
            want = ref.ref_prefill_attention_paged(q, kpool, vpool, pt, posp)
            err = close(out, want, "prefill_attention_paged")
            kdense = ref.gather_pages(kpool, pt)
            vdense = ref.gather_pages(vpool, pt)
            fr = pre_pos.index(1792)     # the longest row with its own pages
            kf, vf = _planted_tile(kdense, vdense, fr, 1024)
            late("prefill_attention_paged",
                 _rel_late_prefill(torch, out, want, pre_pos, window, Hkv),
                 _rel_late_prefill(torch, ref.ref_prefill_attention(
                     q, kf, vf, posp)[fr:fr + 1], want[fr:fr + 1],
                     pre_pos[fr:fr + 1], window, Hkv))
            abort = torch.tensor(aborts, dtype=torch.int32, device="cuda")
            out_a, prog = routed(fn, lambda: fn(q, kpool, vpool, pt, posp,
                                                abort=abort))
            require(prog.tolist() == [min(max(a, 0), Sq) for a in aborts],
                    f"progress {prog.tolist()} for abort {aborts}")
            for b, a in enumerate(aborts):
                n = min(a, Sq)
                if n:
                    err = max(err, close(out_a[b, :n], want[b, :n],
                                         "prefill_attention_paged abort"))
            one = routed(fn, lambda: fn(q[:, :1], kpool, vpool, pt, posp))
            dec = kd.decode_attention_paged(q[:, 0].contiguous(), kpool,
                                            vpool, pt, posp)
            sq1(one[:, 0], dec, ref.ref_decode_attention(q[:, 0], kf, vf,
                                                         posp), fr, "paged")
            del kf, vf
            kr = kdense.repeat_interleave(G, dim=2).transpose(1, 2)
            vr = vdense.repeat_interleave(G, dim=2).transpose(1, 2)
            qpos = posp[:, None] + torch.arange(Sq, device="cuda")[None]
            mask = (torch.arange(window, device="cuda")[None, None, :]
                    <= qpos[:, :, None])[:, None]
            qt = q.transpose(1, 2)
            kvk, pairs = _keys_seen(pre_pos, Sq, window)

            def kern():
                return fn(q, kpool, vpool, pt, posp)

            def lib():
                return F.scaled_dot_product_attention(qt, kr, vr,
                                                      attn_mask=mask)
            rec("prefill_attention_paged", err, graph_ms(kern),
                cuda_ms(lambda: ref.ref_prefill_attention_paged(
                    q, kpool, vpool, pt, posp), iters=3),
                graph_ms(lib),
                _bound_ms(kvk, B, Sq, H, Hkv, D, q.element_size(), pairs,
                          dname),
                host_ms(kern), (cuda_ms(kern), cuda_ms(lib)))

            # -- 3: dense decode (bhsd, the serving layout; bshd too) --
            Bd, Smax = 4, 2048
            dpos = [5, 700, Smax, 2047]
            q1 = torch.randn(Bd, H, D, generator=gen, device="cuda") \
                .to(dtype)
            kc = torch.randn(Bd, Hkv, Smax, D, generator=gen,
                             device="cuda").to(dtype)
            vc = torch.randn(Bd, Hkv, Smax, D, generator=gen,
                             device="cuda").to(dtype)
            posd = torch.tensor(dpos, dtype=torch.int32, device="cuda")
            out = kd.decode_attention(q1, kc, vc, posd, kv_layout="bhsd")
            want = ref.ref_decode_attention(q1, kc.transpose(1, 2),
                                            vc.transpose(1, 2), posd)
            err = close(out, want, "decode_attention")
            ks, vs = (x.transpose(1, 2).contiguous() for x in (kc, vc))
            out_s = kd.decode_attention(q1, ks, vs, posd, kv_layout="bshd")
            require(torch.equal(out, out_s), f"bshd != bhsd {tag}")
            fr = dpos.index(2047)
            late("decode_attention",
                 _rel_rows(out, want, _long_rows(dpos, Smax), Hkv),
                 _rel_rows(ref.ref_decode_attention(
                     q1, *_planted_span(ks, vs, fr, 1024), posd), want,
                     [fr], Hkv))
            del ks, vs, out_s
            # a ragged window (not a multiple of any tile), scalar pos
            Sr = 1000
            out_r = kd.decode_attention(q1, kc[:, :, :Sr], vc[:, :, :Sr],
                                        999, kv_layout="bhsd")
            want_r = ref.ref_decode_attention(
                q1, kc[:, :, :Sr].transpose(1, 2),
                vc[:, :, :Sr].transpose(1, 2), 999)
            err = max(err, close(out_r, want_r, "decode_attention ragged"))
            kr = kc.repeat_interleave(G, dim=1)
            vr = vc.repeat_interleave(G, dim=1)
            mask = (torch.arange(Smax, device="cuda")[None, :]
                    <= posd[:, None])[:, None, None, :]
            kvk, pairs = _keys_seen(dpos, 1, Smax)

            def kern():
                return kd.decode_attention(q1, kc, vc, posd, kv_layout="bhsd")

            def lib():
                return F.scaled_dot_product_attention(q1[:, :, None], kr, vr,
                                                      attn_mask=mask)
            rec("decode_attention", err, graph_ms(kern),
                cuda_ms(lambda: ref.ref_decode_attention(
                    q1, kc.transpose(1, 2), vc.transpose(1, 2), posd),
                    iters=5),
                graph_ms(lib),
                _bound_ms(kvk, Bd, 1, H, Hkv, D, q1.element_size(), pairs,
                          dname),
                host_ms(kern), (cuda_ms(kern), cuda_ms(lib)))

            # -- 4: dense chunked prefill, abort/progress -------------
            ppos = [0, 300, Smax, 1792]
            pab = [Sq + 5, 3, 1, 0]
            q = torch.randn(Bd, Sq, H, D, generator=gen, device="cuda") \
                .to(dtype)
            posp = torch.tensor(ppos, dtype=torch.int32, device="cuda")
            fn = kp_.prefill_attention
            out = routed(fn, lambda: fn(q, kc, vc, posp))
            ks, vs = (x.transpose(1, 2) for x in (kc, vc))
            want = ref.ref_prefill_attention(q, ks, vs, posp)
            err = close(out, want, "prefill_attention")
            fr = ppos.index(1792)
            kf, vf = _planted_tile(ks, vs, fr, 1024)
            late("prefill_attention",
                 _rel_late_prefill(torch, out, want, ppos, Smax, Hkv),
                 _rel_late_prefill(torch, ref.ref_prefill_attention(
                     q, kf, vf, posp)[fr:fr + 1], want[fr:fr + 1],
                     ppos[fr:fr + 1], Smax, Hkv))
            abort = torch.tensor(pab, dtype=torch.int32, device="cuda")
            out_a, prog = routed(fn, lambda: fn(q, kc, vc, posp,
                                                abort=abort))
            require(prog.tolist() == [min(max(a, 0), Sq) for a in pab],
                    f"dense progress {prog.tolist()} for abort {pab}")
            for b, a in enumerate(pab):
                n = min(a, Sq)
                if n:
                    err = max(err, close(out_a[b, :n], want[b, :n],
                                         "prefill_attention abort"))
            one = routed(fn, lambda: fn(q[:, :1], kc, vc, posp))
            dec = kd.decode_attention(q[:, 0].contiguous(), kc, vc, posp,
                                      kv_layout="bhsd")
            sq1(one[:, 0], dec, ref.ref_decode_attention(q[:, 0], kf, vf,
                                                         posp), fr, "dense")
            del kf, vf, ks, vs
            qt = q.transpose(1, 2)
            qpos = posp[:, None] + torch.arange(Sq, device="cuda")[None]
            mask = (torch.arange(Smax, device="cuda")[None, None, :]
                    <= qpos[:, :, None])[:, None]
            kvk, pairs = _keys_seen(ppos, Sq, Smax)

            def kern():
                return fn(q, kc, vc, posp)

            def lib():
                return F.scaled_dot_product_attention(qt, kr, vr,
                                                      attn_mask=mask)
            rec("prefill_attention", err, graph_ms(kern),
                cuda_ms(lambda: ref.ref_prefill_attention(
                    q, kc.transpose(1, 2), vc.transpose(1, 2), posp),
                    iters=3),
                graph_ms(lib),
                _bound_ms(kvk, Bd, Sq, H, Hkv, D, q.element_size(), pairs,
                          dname),
                host_ms(kern), (cuda_ms(kern), cuda_ms(lib)))
            del kpool, vpool, kc, vc, kr, vr
            torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 4: the model at full width
# ---------------------------------------------------------------------------

def _profiler(torch):
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def _profile_summary(prof, wall_s, top=8):
    """Device time by kernel name in a profiled run, and its total as a
    share of ``wall_s``, the same work's wall time without the profiler
    (the device-busy share): the ``top`` kernels, and the decode and
    prefill kernels wherever they rank."""
    rows = []
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        t = getattr(e, "device_time_total", None)
        if t is None:
            t = getattr(e, "cuda_time_total", 0)
        if t > 0:
            rows.append((t, e.count, e.key))
    if not rows:
        log("  profile: no device time recorded (device busy share not "
            "measured)")
        return
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    log(f"  profile: device busy {busy * 1e3:.1f} ms of {wall_s * 1e3:.1f} "
        f"ms unprofiled wall (share {busy / wall_s:.3f})")
    for i, (t, n, name) in enumerate(rows):
        if i < top or "decode" in name or "prefill" in name:
            log(f"    {t / 1e3:9.3f} ms {n:6d}x {name[:90]}")


def model_phase(torch, seed):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    cfg = get_config("qwen3-1.7b")
    dev = "cuda"
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed, dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    log(f"  qwen3-1.7b: layers={cfg.num_layers} d_model={cfg.d_model} "
        f"vocab={cfg.vocab_size}, bf16 init {time.perf_counter() - t0:.1f}s")
    B, L, steps, P = 4, 256, 8, 32
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab_size, (B, L), generator=gen)
    dec_toks = torch.randint(0, cfg.vocab_size, (steps, B, 1), generator=gen)
    pt = torch.full((B, P), B * P, dtype=torch.int32)
    need = -(-(L + steps) // PAGE)
    for b in range(B):
        pt[b, :need] = torch.arange(b * P, b * P + need, dtype=torch.int32)
    pt = pt.to(dev)
    ctx = {"page_table": pt}

    def run(flash):
        """One paged prefill + ``steps`` decode steps from fresh pools;
        returns (last logits, wall seconds)."""
        pools = tf.init_paged_cache(cfg, B * P, PAGE, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, pools = tf.prefill_step(
                params, cfg, toks.to(dev), pools,
                torch.zeros(B, dtype=torch.int32, device=dev),
                ctx_extra=ctx, use_flash=flash)
            for i in range(steps):
                pos = torch.full((B,), L + i, dtype=torch.int32, device=dev)
                logits, pools = tf.decode_step(params, cfg,
                                               dec_toks[i].to(dev), pools,
                                               pos, ctx_extra=ctx,
                                               use_flash=flash)
            torch.cuda.synchronize()
        return logits[:, 0].float(), time.perf_counter() - t0

    runs = {}
    # the torch-op run first, so the timed flash run finds cuBLAS and the
    # allocator warm
    for flash in (False, True):
        ops.reset_launch_counts()
        logits, wall = run(flash)
        runs[flash] = (logits, ops.launch_counts(), wall)
        log(f"  use_flash={flash}: prefill {L} x {B} + {steps} decode "
            f"steps in {wall:.3f}s, launches {runs[flash][1]}")
    # the same flash run again under the profiler: device time by kernel,
    # against the unprofiled run's wall time
    with _profiler(torch) as prof:
        run(True)
    _profile_summary(prof, runs[True][2])
    (lf, cf, _), (lr, cr, _) = runs[True], runs[False]
    require(bool(torch.isfinite(lf).all()), "flash logits not finite")
    require(tuple(lf.shape) == (B, cfg.vocab_size), f"logits {lf.shape}")
    rel = ((lf - lr).norm() / lr.norm()).item()
    agree = (lf.argmax(-1) == lr.argmax(-1)).float().mean().item()
    log(f"  last logits flash vs torch-op: rel L2 {rel:.3e} (tol "
        f"{MODEL_REL_TOL}), max abs {(lf - lr).abs().max().item():.3e}, "
        f"argmax agreement {agree:.2f}")
    require(rel <= MODEL_REL_TOL, f"model logits rel err {rel}")
    require(cf["prefill_attention_paged"] == cfg.num_layers
            and cf["decode_attention_paged"] == cfg.num_layers * steps,
            f"flash run launches {cf}")
    require(sum(cr.values()) == 0, f"torch-op run launched kernels {cr}")
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 5-6: the serving engine
# ---------------------------------------------------------------------------

def _engine_plan():
    """The LS+BE engines' static plan: BE gets 0.3 of contended quanta."""
    from repro_torch.core.controller import ResourcePlan
    return ResourcePlan(sm_be=0.3, ch_be=1 / 3, thres_dram=0.4,
                        ls_channels=(), be_channels=(),
                        max_ls_inflation=0.25)


def _serve(torch, seed, *, paged, chunk, ls_lens, be_lens, max_new,
           slots, max_seq, plan=None, params=None, ls_cfg=None):
    from repro_torch.configs import get_config
    from repro_torch.core.tenancy import TenantSpec
    from repro_torch.serving import ServingEngine
    import numpy as np
    eng = ServingEngine(max_seq=max_seq, paged=paged, page_size=PAGE,
                        use_flash=True, chunk_size=chunk, slots_ls=slots,
                        slots_be=slots, plan=plan, torch_device="cuda")
    t0 = time.perf_counter()
    ls = eng.add_tenant(TenantSpec("ls-qwen3", "LS"),
                        ls_cfg or get_config("qwen3-1.7b"),
                        params=None if params is None else params["ls"],
                        seed=seed)
    be = None
    if be_lens:
        be = eng.add_tenant(TenantSpec("be-stablelm", "BE"),
                            get_config("stablelm-1.6b"), seed=seed + 1)
    torch.cuda.synchronize()
    log(f"  tenants ready in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(seed)
    reqs = []
    for L in ls_lens:
        reqs.append(eng.submit("ls-qwen3", rng.integers(
            0, ls.cfg.vocab_size, L), max_new=max_new))
    for L in be_lens:
        reqs.append(eng.submit("be-stablelm", rng.integers(
            0, be.cfg.vocab_size, L), max_new=max_new))
    t0 = time.perf_counter()
    n = eng.run_until_idle()
    torch.cuda.synchronize()
    log(f"  {n} quanta in {time.perf_counter() - t0:.2f}s")
    for r in reqs:
        require(not r.failed and r.output is not None
                and len(r.output) == max_new,
                f"request {r.rid} ({r.tenant}, {len(r.tokens)} tokens): "
                f"{None if r.output is None else len(r.output)} tokens")
    return eng, reqs, ls.params


def engine_phase(torch, seed):
    import numpy as np
    from repro_torch.kernels import ops
    rng = np.random.default_rng(seed + 7)
    ls_lens = [int(x) for x in rng.integers(128, 1025, 8)]
    be_lens = [int(x) for x in rng.integers(512, 1537, 8)]
    plan = _engine_plan()
    log(f"  LS prompts {ls_lens}; BE prompts {be_lens}; max_new 32")
    ops.reset_launch_counts()
    eng, _, _ = _serve(torch, seed, paged=True, chunk=256, ls_lens=ls_lens,
                       be_lens=be_lens, max_new=32, slots=8, max_seq=2048,
                       plan=plan)
    counts = ops.launch_counts()
    routes = ops.route_counts()
    log(f"  launches {counts}")
    log(f"  prefill routes {routes['prefill_attention_paged']}")
    require(counts["decode_attention_paged"] > 0
            and counts["prefill_attention_paged"] > 0,
            f"paged kernels not launched: {counts}")
    # both tenants are bf16 at head dims 128 and 64: the tensor-core body
    require(routes["prefill_attention_paged"] == {
        "wgmma": counts["prefill_attention_paged"], "simt": 0},
        f"engine prefill routes {routes['prefill_attention_paged']}")
    m = eng.metrics()
    cls = m["_class"]
    log("  metrics _class " + json.dumps(cls))
    quanta = {"LS": 0, "BE": 0}
    for _, _, pri in eng.events:
        quanta[pri] += 1
    log(f"  quanta by class {quanta}")
    del eng
    torch.cuda.empty_cache()
    return counts, routes, cls


def dense_phase(torch, seed):
    import numpy as np
    from repro_torch.kernels import ops
    rng = np.random.default_rng(seed + 11)
    ls_lens = [int(x) for x in rng.integers(128, 513, 4)]
    log(f"  LS prompts {ls_lens}; max_new 16; chunk 64 then 256")
    ops.reset_launch_counts()
    eng, reqs, params = _serve(torch, seed, paged=False, chunk=64,
                               ls_lens=ls_lens, be_lens=[], max_new=16,
                               slots=4, max_seq=1024)
    counts = ops.launch_counts()
    routes = ops.route_counts()
    log(f"  launches {counts}")
    log(f"  prefill routes {routes['prefill_attention']}")
    require(counts["decode_attention"] > 0
            and counts["prefill_attention"] > 0,
            f"dense kernels not launched: {counts}")
    require(routes["prefill_attention"] == {
        "wgmma": counts["prefill_attention"], "simt": 0},
        f"engine prefill routes {routes['prefill_attention']}")
    out64 = [r.output for r in reqs]
    del eng
    eng2, reqs2, _ = _serve(torch, seed, paged=False, chunk=256,
                            ls_lens=ls_lens, be_lens=[], max_new=16,
                            slots=4, max_seq=1024, params={"ls": params})
    same = out64 == [r.output for r in reqs2]
    log(f"  greedy tokens equal across chunk_size 64/256: {same} "
        "(reported, not required: a GEMM may pick another algorithm for "
        "another batch shape)")
    del eng2, params
    torch.cuda.empty_cache()
    return counts, routes


def typed_engine_phase(torch, seed, dname):
    """The LS qwen3-1.7b tenant in ``dname`` (f32 with TF32 off, or f16),
    dense cache then paged, with the same weights: every prefill launch on
    the route ``route(dtype, 128)`` names (f32: the CUDA-core "simt" body;
    f16: the tensor-core "wgmma" body). Returns the launch counts of both
    runs and the tenant's params."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import prefill_attention as kp_
    cfg = get_config("qwen3-1.7b").replace(activation_dtype=dname)
    way = kp_.route(getattr(torch, dname), cfg.head_dim)
    rng = np.random.default_rng(seed + 13)
    ls_lens = [int(x) for x in rng.integers(128, 513, 4)]
    log(f"  LS prompts {ls_lens}; max_new 8; chunk 256; {dname}; prefill "
        f"route {way}")
    counts, params = {}, None
    for paged in (False, True):
        sfx = "_paged" if paged else ""
        name = "prefill_attention" + sfx
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        eng, _, params = _serve(torch, seed, paged=paged, chunk=256,
                                ls_lens=ls_lens, be_lens=[], max_new=8,
                                slots=4, max_seq=1024, ls_cfg=cfg,
                                params=None if params is None
                                else {"ls": params})
        run = ops.launch_counts()
        routes = ops.route_counts()[name]
        log(f"  {'paged' if paged else 'dense'}: "
            f"{time.perf_counter() - t0:.2f}s wall (tenant set-up "
            f"included), launches {run}, prefill routes {routes}")
        require(run[name] > 0 and routes == {**dict.fromkeys(routes, 0),
                                             way: run[name]},
                f"{dname} engine prefill routes {routes}, launches {run}")
        for k in ("decode_attention" + sfx, name):
            counts[k] = run[k]
        del eng
    torch.cuda.empty_cache()
    return counts, params


def f16_prefill_check(torch, seed, params):
    """One full-width f16 paged prefill_step of 4 x 256 tokens with
    ``params`` (phase 6c's tenant), use_flash on and off: finite logits of
    the right shape, the last position's within F16_MODEL_REL_TOL relative
    L2 of each other, the flash run launching the prefill kernel once a
    layer on "wgmma"."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    cfg = get_config("qwen3-1.7b").replace(activation_dtype="float16")
    B, L, P, dev = 4, 256, 16, "cuda"
    gen = torch.Generator(device="cpu").manual_seed(seed + 17)
    toks = torch.randint(0, cfg.vocab_size, (B, L), generator=gen).to(dev)
    pt = torch.arange(B * P, dtype=torch.int32, device=dev).reshape(B, P)
    logits = {}
    for flash in (False, True):
        pools = tf.init_paged_cache(cfg, B * P, PAGE, device=dev)
        ops.reset_launch_counts()
        with torch.inference_mode():
            out, _ = tf.prefill_step(
                params, cfg, toks, pools,
                torch.zeros(B, dtype=torch.int32, device=dev),
                ctx_extra={"page_table": pt}, use_flash=flash)
        torch.cuda.synchronize()
        routes = ops.route_counts()["prefill_attention_paged"]
        require(routes == {"wgmma": cfg.num_layers if flash else 0,
                           "simt": 0},
                f"f16 prefill_step use_flash={flash}: routes {routes}")
        require(out.dtype == torch.float16
                and tuple(out.shape) == (B, 1, cfg.vocab_size),
                f"f16 prefill_step logits {out.dtype} {tuple(out.shape)}")
        n_bad = int((~torch.isfinite(out)).sum())
        log(f"  f16 prefill_step {B} x {L}, use_flash={flash}: non-finite "
            f"logits {n_bad}, max |logit| {out.float().abs().max():.3f}")
        require(n_bad == 0, f"f16 prefill_step use_flash={flash}: {n_bad} "
                            "non-finite logits")
        logits[flash] = out[:, 0].float()
    lf, lr = logits[True], logits[False]
    rel = ((lf - lr).norm() / lr.norm()).item()
    log(f"  f16 last logits flash vs torch-op: rel L2 {rel:.3e} (tol "
        f"{F16_MODEL_REL_TOL}), max abs {(lf - lr).abs().max().item():.3e},"
        f" argmax agreement "
        f"{(lf.argmax(-1) == lr.argmax(-1)).float().mean().item():.2f}")
    require(rel <= F16_MODEL_REL_TOL, f"f16 model logits rel err {rel}")


# ---------------------------------------------------------------------------
# phase 7: the SGDRC kernels (co-execution and shadow page tables)
# ---------------------------------------------------------------------------

def _visible_pairs(S, causal, window):
    """(query, key) pairs one (batch row, head) of self-attention sees."""
    total = 0
    for s in range(S):
        hi = s + 1 if causal else S
        lo = max(0, s - window + 1) if window else 0
        total += hi - lo
    return total


def _bound(nbytes, flops, dname):
    """(ms, what bounds it): the larger of ``nbytes`` over the HBM rate and
    ``flops`` over the type's peak."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dname]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _attn_work(B, S, H, Hkv, D, itemsize, causal, window):
    """(bytes of q, k, v and out once; 4 * D flops per visible (query, key)
    pair and head) of one self-attention."""
    nbytes = B * S * (2 * H + 2 * Hkv) * D * itemsize
    return nbytes, 4.0 * D * _visible_pairs(S, causal, window) * B * H


def _sdpa(torch, q, k, v, causal, window):
    """One PyTorch library call computing the same attention (no softcap):
    the yardstick of ``library_ms``, never called by the port."""
    F = torch.nn.functional
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if window is None:
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=True)
    S = q.shape[1]
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] > pos[:, None] - window
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                          enable_gqa=True)


def sgdrc_phase(torch, seed):
    from repro_torch.configs import get_config
    from repro_torch.core import coloring
    from repro_torch.kernels import dual_tenant_matmul as dtm
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed + 70)

    qwen, gemma = get_config("qwen3-1.7b"), get_config("gemma2-9b")

    def randn(*shape, dtype, scale=1.0):
        x = torch.randn(*shape, generator=gen, device=dev)
        return (x * scale if scale != 1.0 else x).to(dtype)

    def heads(cfg):
        return cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def qkv(cfg, B, S, dtype):
        H, Hkv, D = heads(cfg)
        return tuple(randn(B, S, h, D, dtype=dtype) for h in (H, Hkv, Hkv))

    # inputs, all from the seed
    flash = [
        dict(tag="qwen3-1.7b causal bfloat16", cfg=qwen, B=2, S=2048,
             causal=True, window=None, softcap=None, dname="bfloat16"),
        dict(tag="qwen3-1.7b causal float32", cfg=qwen, B=2, S=2048,
             causal=True, window=None, softcap=None, dname="float32"),
        dict(tag="gemma2-9b local bfloat16", cfg=gemma, B=1, S=8192,
             causal=True, window=gemma.local_window,
             softcap=gemma.attn_logit_softcap, dname="bfloat16"),
        dict(tag="qwen3-1.7b non-causal float32", cfg=qwen, B=2, S=1024,
             causal=False, window=None, softcap=None, dname="float32"),
        dict(tag="qwen3-1.7b causal float16", cfg=qwen, B=2, S=2048,
             causal=True, window=None, softcap=None, dname="float16"),
        dict(tag="gemma2-9b local float32", cfg=gemma, B=1, S=8192,
             causal=True, window=gemma.local_window,
             softcap=gemma.attn_logit_softcap, dname="float32"),
    ]
    for c in flash:
        c["qkv"] = qkv(c["cfg"], c["B"], c["S"], getattr(torch, c["dname"]))
    dual = {d: (qkv(qwen, 1, 2048, getattr(torch, d)),
                qkv(qwen, 4, 2048, getattr(torch, d)))
            for d in ("bfloat16", "float32", "float16")}
    # the MLP's gate and down projections (K, N), LS 256 + BE 2048 rows:
    # activations ~N(0, 1), weights ~N(0, 1/K) as the models' init scales
    # them; bf16 and f16 on the tensor cores, f32 on the CUDA cores
    mm_shapes = {"gate": (qwen.d_model, qwen.d_ff),
                 "down": (qwen.d_ff, qwen.d_model)}
    mm = {(sh, d): (randn(256, K, dtype=getattr(torch, d)),
                    randn(K, N, dtype=getattr(torch, d), scale=K ** -0.5),
                    randn(2048, K, dtype=getattr(torch, d)),
                    randn(K, N, dtype=getattr(torch, d), scale=K ** -0.5))
          for sh, (K, N) in mm_shapes.items()
          for d in ("bfloat16", "float32", "float16")}
    # f16 at the gate projection's K less 2 (not a multiple of 8): the
    # CUDA-core body with 4-byte copies
    K, N = mm_shapes["gate"][0] - 2, mm_shapes["gate"][1]
    f16 = torch.float16
    mm_ragged = (randn(256, K, dtype=f16),
                 randn(K, N, dtype=f16, scale=K ** -0.5),
                 randn(2048, K, dtype=f16),
                 randn(K, N, dtype=f16, scale=K ** -0.5))
    t0 = time.perf_counter()
    hm = coloring.gpu_hash_model("tesla-p40")
    arena = coloring.ColoredArena(SPT_ARENA_BYTES, hm.channel_of,
                                  hm.num_channels, hm.granularity)
    ls_ch, be_ch = coloring.split_channels(hm.num_channels, 1 / 3)
    spt_ls = arena.alloc("ls", 1 << 30, ls_ch).spt
    spt_be = arena.alloc("be", 512 << 20, be_ch).spt
    require(arena.isolation_violations(arena.allocations["ls"]) == 0
            and arena.isolation_violations(arena.allocations["be"]) == 0,
            "SPT pages off their tenant's channels")
    n_arena = SPT_ARENA_BYTES // hm.granularity
    page = hm.granularity // 2                 # bf16 elements a page
    log(f"  ColoredArena {SPT_ARENA_BYTES >> 20} MiB, tesla-p40 hash, "
        f"{n_arena} pages of {hm.granularity} B: LS {len(spt_ls)} pages on "
        f"channels {ls_ch}, BE {len(spt_be)} on {be_ch} "
        f"({time.perf_counter() - t0:.1f}s on the host)")
    spts = {t: torch.from_numpy(s).to(dev) for t, s in (("ls", spt_ls),
                                                        ("be", spt_be))}
    xs = {t: randn(len(s), page, dtype=torch.bfloat16)
          for t, s in spts.items()}
    torch.cuda.synchronize()

    # -- the path, through the public entry points, counted from zero ----
    ops.reset_launch_counts()
    for c in flash:
        c["out"] = ops.flash_attention(*c["qkv"], causal=c["causal"],
                                       window=c["window"],
                                       softcap=c["softcap"])
    dual_out, dual_flash = {}, {}
    for d, (ls, be) in dual.items():
        dual_out[d] = {sm: ops.dual_tenant_attention(*ls, *be, sm_be=sm)
                       for sm in (0.1, 0.3, 0.9)}
        dual_flash[d] = (ops.flash_attention(*ls), ops.flash_attention(*be))
    mm_out = {key: ops.dual_tenant_matmul(*a, sm_be=0.3)
              for key, a in mm.items()}
    ragged_out = ops.dual_tenant_matmul(*mm_ragged, sm_be=0.3)
    scattered = {t: ops.spt_scatter(xs[t], spts[t], n_arena) for t in xs}
    # one device arena holding both tenants (their pages are disjoint)
    be_page = torch.zeros(n_arena, dtype=torch.bool, device=dev)
    be_page[spts["be"].long()] = True
    shared = torch.where(be_page[:, None], scattered["be"], scattered["ls"])
    gathered = {t: ops.spt_gather(shared, spts[t]) for t in xs}
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    routes = ops.route_counts()
    log(f"  launches {counts}")
    log(f"  routes {routes}")
    for name in ("flash_attention", "dual_tenant_attention",
                 "dual_tenant_matmul", "spt_gather", "spt_scatter"):
        require(counts[name] > 0, f"{name} not launched: {counts}")
    # every bf16 and f16 call of the drive takes the tensor-core body
    # (the matmul's at K and N multiples of 8), every f32 call and the
    # ragged-K f16 matmul the CUDA-core body
    half = ("bfloat16", "float16")
    n_tc = {
        "flash_attention": sum(c["dname"] in half for c in flash)
        + 2 * sum(d in half for d in dual),
        "dual_tenant_attention": 3 * sum(d in half for d in dual),
        "dual_tenant_matmul": sum(d in half for _, d in mm)}
    for name, n in n_tc.items():
        require(routes[name] == {"wgmma": n, "simt": counts[name] - n},
                f"{name}: routes {routes[name]}, want {n} bf16 and f16 "
                "calls on wgmma and the rest (f32, ragged K) on simt")

    # -- checks against the plain versions --------------------------------
    results = {}

    def late_rel(a, b):
        """Largest relative L2 error of a against b over the rows [S/2, S)
        of one (batch row, head)."""
        h = b.shape[1] // 2
        d, w = (a[:, h:].float() - b[:, h:].float()), b[:, h:].float()
        return (d.square().sum((1, 3)).sqrt()
                / w.square().sum((1, 3)).sqrt()).max().item()

    def close(a, b, dname, what):
        tol = ATTN_TOL[dname]
        err = (a.float() - b.float()).abs().max().item()
        require(err == err and torch.allclose(a.float(), b.float(), rtol=tol,
                                              atol=tol),
                f"{what}: not within {tol} (max abs {err})")
        late = late_rel(a, b)
        require(late <= ATTN_LATE_REL_TOL[dname],
                f"{what}: late rows' relative L2 error {late} over "
                f"{ATTN_LATE_REL_TOL[dname]}")
        return err, late

    for c in flash:
        kw = dict(causal=c["causal"], window=c["window"], softcap=c["softcap"])
        want = ref.ref_attention(*c["qkv"], **kw)
        c["err"], c["late"] = close(c["out"], want, c["dname"],
                                    f"flash_attention {c['tag']}")
        require(tuple(c["out"].shape) == tuple(c["qkv"][0].shape),
                f"flash_attention {c['tag']}: shape {c['out'].shape}")
        # planted fault: key tile [S/2, S/2 + 128) holds the K/V of the tile
        # before it, as a ring stage used twice would give
        q, k, v = c["qkv"]
        t0 = c["S"] // 2
        k2, v2 = k.clone(), v.clone()
        k2[:, t0:t0 + 128], v2[:, t0:t0 + 128] = k[:, t0 - 128:t0], \
            v[:, t0 - 128:t0]
        c["planted"] = late_rel(ref.ref_attention(q, k2, v2, **kw), want)
        require(c["planted"] > ATTN_LATE_REL_TOL[c["dname"]],
                f"flash_attention {c['tag']}: the late-row check misses a "
                f"planted fault ({c['planted']})")
        log(f"  flash_attention {c['tag']}: late rows' relative L2 "
            f"{c['late']:.3e}, planted fault {c['planted']:.3e} (limit "
            f"{ATTN_LATE_REL_TOL[c['dname']]})")
        del want, k2, v2
    dual_err = {}
    for d, (ls, be) in dual.items():
        fl, fb = dual_flash[d]
        for sm, (o_ls, o_be) in dual_out[d].items():
            require(torch.equal(o_ls, fl) and torch.equal(o_be, fb),
                    f"dual_tenant_attention {d} sm_be={sm} != flash_attention")
        o0 = dual_out[d][0.1]
        for sm in (0.3, 0.9):
            same = all(torch.equal(a, b) for a, b in zip(dual_out[d][sm], o0))
            require(same, f"dual_tenant_attention {d}: sm_be {sm} != sm_be "
                          "0.1")
        errs = [close(o, ref.ref_attention(*t, causal=True), d,
                      f"dual_tenant_attention {d}")
                for o, t in zip(dual_out[d][0.3], (ls, be))]
        err, late = (max(e[i] for e in errs) for i in (0, 1))
        dual_err[d] = err
        log(f"  dual_tenant_attention {d}: == flash_attention bit for bit "
            f"and across sm_be 0.1/0.3/0.9; vs plain max abs {err:.3e}, "
            f"late rows' relative L2 {late:.3e}")
    mm_err = {}
    for (sh, d), a in mm.items():
        rtol, atol = MATMUL_TOL[d]
        errs = []
        for o, w in zip(mm_out[sh, d], ref.ref_dual_tenant_matmul(*a)):
            errs.append((o.float() - w.float()).abs().max().item())
            require(torch.allclose(o.float(), w.float(), rtol=rtol,
                                   atol=atol),
                    f"dual_tenant_matmul {sh} {d}: not within rtol {rtol} "
                    f"atol {atol} (max abs {errs[-1]})")
        mm_err[sh, d] = max(errs)
        log(f"  dual_tenant_matmul {sh} {d}: vs plain max abs "
            f"{mm_err[sh, d]:.3e} (rtol {rtol}, atol {atol})")
    rtol, atol = MATMUL_TOL["float16"]
    K, errs = mm_ragged[0].shape[1], []
    for o, w in zip(ragged_out, ref.ref_dual_tenant_matmul(*mm_ragged)):
        errs.append((o.float() - w.float()).abs().max().item())
        require(torch.allclose(o.float(), w.float(), rtol=rtol, atol=atol),
                f"dual_tenant_matmul ragged K {K} float16: not within rtol "
                f"{rtol} atol {atol} (max abs {errs[-1]})")
    log(f"  dual_tenant_matmul gate K {K} float16: route="
        f"{dtm.route(f16, K, mm_ragged[1].shape[1])}, vs plain max abs "
        f"{max(errs):.3e} (rtol {rtol}, atol {atol})")
    del ragged_out
    # a tenant's bits depend neither on sm_be nor on the other tenant: each
    # output is one sum over k in order, whatever runs beside it
    for (sh, d), (a_ls, b_ls, a_be, b_be) in mm.items():
        if d == "float16":
            continue
        o_ls, o_be = mm_out[sh, d]
        for sm in (0.1, 0.9):
            l, b = ops.dual_tenant_matmul(a_ls, b_ls, a_be, b_be, sm_be=sm)
            require(torch.equal(l, o_ls) and torch.equal(b, o_be),
                    f"dual_tenant_matmul {sh} {d}: sm_be {sm} != sm_be 0.3")
        alone_ls = ops.dual_tenant_matmul(a_ls, b_ls, a_be[:0], b_be)[0]
        alone_be = ops.dual_tenant_matmul(a_ls[:0], b_ls, a_be, b_be)[1]
        require(torch.equal(alone_ls, o_ls),
                f"dual_tenant_matmul {sh} {d}: LS != LS with BE empty")
        require(torch.equal(alone_be, o_be),
                f"dual_tenant_matmul {sh} {d}: BE != BE with LS empty")
        log(f"  dual_tenant_matmul {sh} {d}: each tenant's output equal bit "
            "for bit across sm_be 0.1/0.3/0.9 and with the other tenant "
            "empty")
    lib_arena = torch.zeros_like(shared)
    for t in xs:
        lib_arena.index_copy_(0, spts[t].long(), xs[t])
    require(torch.equal(shared, lib_arena), "spt_scatter != index_copy_")
    for t in xs:
        require(torch.equal(gathered[t], xs[t]),
                f"spt round trip of the {t.upper()} tensor is not exact")
        require(torch.equal(gathered[t],
                            shared.index_select(0, spts[t].long())),
                f"spt_gather of the {t.upper()} tensor != index_select")
    log("  spt: scatter == index_copy_, gather == index_select, round trip "
        "exact, for both tenants")
    del lib_arena, shared, scattered, gathered, be_page
    torch.cuda.empty_cache()

    # -- times (after the counts: these launches are not the path's) -------
    for c in flash:
        H, Hkv, D = heads(c["cfg"])
        q, k, v = c["qkv"]
        kw = dict(causal=c["causal"], window=c["window"],
                  softcap=c["softcap"])
        ms = cuda_ms(lambda: ops.flash_attention(q, k, v, **kw), iters=10)
        host = host_ms(lambda: ops.flash_attention(q, k, v, **kw), iters=10)
        plain = cuda_ms(lambda: ref.ref_attention(q, k, v, **kw), iters=2,
                        warmup=1)
        lib = None if c["softcap"] else cuda_ms(
            lambda: _sdpa(torch, q, k, v, c["causal"], c["window"]))
        work = _attn_work(c["B"], c["S"], H, Hkv, D, q.element_size(),
                          c["causal"], c["window"])
        bound = _bound(*work, c["dname"])
        log(f"  flash_attention {c['tag']:32s} route={fa.route(q.dtype)} "
            f"max_abs_err={c['err']:.3e} ms={ms:.4f} "
            f"TFLOP/s={work[1] / ms / 1e9:.1f} host_ms={host:.4f} "
            f"plain_ms={plain:.4f} "
            f"library_ms={'null' if lib is None else f'{lib:.4f}'} "
            f"bound_ms={bound[0]:.4f} ({bound[1]}) "
            f"of_bound={bound[0] / ms:.3f}")
        c["row"] = dict(max_abs_err=c["err"], ms=ms, host_ms=host,
                        plain_ms=plain, library_ms=lib, bound_ms=bound[0],
                        bound_by=bound[1], of_bound=bound[0] / ms)
    # qwen3 causal bf16 is the kernel's row; the other forms beside it
    fl = {c["tag"]: c["row"] for c in flash}
    results["flash_attention"] = dict(
        fl["qwen3-1.7b causal bfloat16"], routes=routes["flash_attention"],
        float32=fl["qwen3-1.7b causal float32"],
        float16=fl["qwen3-1.7b causal float16"],
        non_causal_float32=fl["qwen3-1.7b non-causal float32"],
        gemma2_local_d256={d: fl[f"gemma2-9b local {d}"]
                           for d in ("bfloat16", "float32")})
    H, Hkv, D = heads(qwen)
    dual_rows = {}
    for d, (ls, be) in dual.items():
        err = dual_err[d]
        ms = cuda_ms(lambda: ops.dual_tenant_attention(*ls, *be, sm_be=0.3),
                     iters=10)
        host = host_ms(lambda: ops.dual_tenant_attention(*ls, *be,
                                                         sm_be=0.3), iters=10)
        plain = cuda_ms(lambda: (ref.ref_attention(*ls),
                                 ref.ref_attention(*be)), iters=2, warmup=1)
        lib = cuda_ms(lambda: (_sdpa(torch, *ls, True, None),
                               _sdpa(torch, *be, True, None)))
        # both tenants: B 1 + B 4 rows of the same shape
        work = _attn_work(5, 2048, H, Hkv, D, ls[0].element_size(), True,
                          None)
        bound = _bound(*work, d)
        log(f"  dual_tenant_attention {d:9s} route={fa.route(ls[0].dtype)} "
            f"max_abs_err={err:.3e} ms={ms:.4f} "
            f"TFLOP/s={work[1] / ms / 1e9:.1f} host_ms={host:.4f} "
            f"plain_ms={plain:.4f} library_ms={lib:.4f} "
            f"bound_ms={bound[0]:.4f} ({bound[1]}) "
            f"of_bound={bound[0] / ms:.3f}")
        dual_rows[d] = dict(max_abs_err=err, ms=ms, host_ms=host,
                            plain_ms=plain, library_ms=lib,
                            bound_ms=bound[0], bound_by=bound[1],
                            of_bound=bound[0] / ms)
    results["dual_tenant_attention"] = dict(
        dual_rows["bfloat16"], routes=routes["dual_tenant_attention"],
        float32=dual_rows["float32"], float16=dual_rows["float16"])
    mm_rows = {}
    for (sh, d), a in mm.items():
        a_ls, b_ls, a_be, b_be = a
        (K, N), M = mm_shapes[sh], a_ls.shape[0] + a_be.shape[0]
        ms = cuda_ms(lambda: ops.dual_tenant_matmul(*a, sm_be=0.3), iters=10)
        host = host_ms(lambda: ops.dual_tenant_matmul(*a, sm_be=0.3),
                       iters=10)
        plain = cuda_ms(lambda: ref.ref_dual_tenant_matmul(*a), iters=5)
        lib = cuda_ms(lambda: (torch.matmul(a_ls, b_ls),
                               torch.matmul(a_be, b_be)))
        nbytes = (M * K + 2 * K * N + M * N) * a_ls.element_size()
        flops = 2.0 * M * K * N
        bound = _bound(nbytes, flops, d)
        log(f"  dual_tenant_matmul {sh} {d:9s} "
            f"route={dtm.route(a_ls.dtype, K, N)} "
            f"max_abs_err={mm_err[sh, d]:.3e} ms={ms:.4f} "
            f"TFLOP/s={flops / ms / 1e9:.1f} host_ms={host:.4f} "
            f"plain_ms={plain:.4f} library_ms={lib:.4f} "
            f"bound_ms={bound[0]:.4f} ({bound[1]}) "
            f"of_bound={bound[0] / ms:.3f} vs_library={ms / lib:.3f}")
        mm_rows[sh, d] = dict(
            max_abs_err=mm_err[sh, d], ms=ms, host_ms=host, plain_ms=plain,
            library_ms=lib, bound_ms=bound[0], bound_by=bound[1],
            of_bound=bound[0] / ms, vs_library=ms / lib)
    # the gate projection in bf16 is the kernel's row; f32, f16 and the
    # down projection beside it
    results["dual_tenant_matmul"] = dict(
        mm_rows["gate", "bfloat16"], routes=routes["dual_tenant_matmul"],
        float32=mm_rows["gate", "float32"],
        float16=mm_rows["gate", "float16"],
        down_projection={d: mm_rows["down", d]
                         for d in ("bfloat16", "float32", "float16")})
    page_bytes = page * 2
    for t in ("ls", "be"):
        x, spt = xs[t], spts[t]
        sl = spt.long()
        arena_t = ops.spt_scatter(x, spt, n_arena)
        n = len(spt)
        rows = {
            "spt_gather": (
                lambda: ops.spt_gather(arena_t, spt),
                lambda: ref.ref_spt_gather(arena_t, spt),
                lambda: arena_t.index_select(0, sl),
                2 * n * page_bytes + 4 * n),
            "spt_scatter": (
                lambda: ops.spt_scatter(x, spt, n_arena),
                lambda: ref.ref_spt_scatter(x, spt, n_arena),
                lambda: torch.zeros(n_arena, page, dtype=x.dtype,
                                    device=dev).index_copy_(0, sl, x),
                (n + n_arena) * page_bytes + 4 * n),
        }
        for name, (kern, plain_fn, lib_fn, nbytes) in rows.items():
            ms = cuda_ms(kern, iters=10)
            plain = cuda_ms(plain_fn, iters=5)
            lib = cuda_ms(lib_fn, iters=10)
            bound = _bound(nbytes, 0.0, "bfloat16")
            log(f"  {name} {t.upper()} {n * page_bytes >> 20} MiB "
                f"max_abs_err=0 ms={ms:.4f} plain_ms={plain:.4f} "
                f"library_ms={lib:.4f} bound_ms={bound[0]:.4f} ({bound[1]})")
            if t == "ls":
                results[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                                     library_ms=lib, bound_ms=bound[0],
                                     bound_by=bound[1])
        del arena_t
        torch.cuda.empty_cache()
    return counts, results

# ---------------------------------------------------------------------------
# phase 8: the SSM and hybrid families
# ---------------------------------------------------------------------------

def _ssd_excess(torch, got, want, dname):
    """The largest |got - want| over its limit under ``SSD_TOL``: at most 1
    within it."""
    rtol, atol = SSD_TOL[dname]
    g, w = got.float(), want.float()
    scale = max(1.0, w.abs().max().item())
    return ((g - w).abs() / (rtol * w.abs() + atol * scale)).max().item()


def _ssd_close(torch, got, want, dname, what):
    """Max abs error of ``got`` against ``want`` under ``SSD_TOL``."""
    err = (got.float() - want.float()).abs().max().item()
    excess = _ssd_excess(torch, got, want, dname)
    require(bool(torch.isfinite(got.float()).all()) and excess <= 1.0,
            f"{what}: not within {SSD_TOL[dname]} (max abs {err}, "
            f"{excess:.3g} x the limit)")
    return err


def ssd_phase(torch, seed):
    """(a) ``ssd_scan`` at zamba2-1.2b's mamba2 widths."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.models import ssm
    F = torch.nn.functional
    s = get_config("zamba2-1.2b").ssm
    B, T, L = 4, 2048, s.chunk
    H = s.expand * get_config("zamba2-1.2b").d_model // s.head_dim
    K, P = s.state_dim, s.head_dim
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed + 80)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    q, k, v = randn(B, T, H, K), randn(B, T, H, K), randn(B, T, H, P)
    decays = {
        # as mamba2_block makes them: -exp(a_log) * softplus(dt), a_log = 0,
        # one value per (token, head), broadcast over the state channels
        "mamba2": -F.softplus(randn(B, T, H, 1)).expand(B, T, H, K)
        .contiguous(),
        "ref-range": -0.2 * randn(B, T, H, K).abs(),
        "zero": torch.zeros(B, T, H, K, device=dev),
    }
    # (decay, dtype, the row's key in the JSON line: None for the kernel's
    # own row, the first)
    cases = []
    for decay, dname, key in (("mamba2", "bfloat16", None),
                              ("mamba2", "float32", "float32"),
                              ("ref-range", "float32", "ref_range_float32"),
                              ("zero", "float32", "zero_float32")):
        dtype = getattr(torch, dname)
        # log_w stays f32, as mamba2 hands it over beside bf16 q, k, v
        cases.append((f"{decay} {dname}", dname, key,
                      (q.to(dtype), k.to(dtype), v.to(dtype),
                       decays[decay])))
    sums = [float(w[0, :L, 0, 0].sum()) for w in decays.values()]
    log(f"  B {B} T {T} H {H} K {K} P {P} chunk {L}; one chunk's cumulative "
        f"log-decay (row 0, head 0): mamba2 {sums[0]:.1f}, reference-test "
        f"range {sums[1]:.1f}, zero {sums[2]:.1f}")
    torch.cuda.synchronize()

    blocks = _build.entry("ssd_scan", "sgdrc_ssd_scan_blocks_per_sm")
    log(f"  blocks an SM: bf16 {blocks(1, 0, K)}, f32 {blocks(0, 0, K)}")
    ops.reset_launch_counts()
    outs = [ops.ssd_scan(*args, chunk=L) for _, _, _, args in cases]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"  launches {counts}")
    require(counts["ssd_scan"] == len(cases), f"ssd_scan launches {counts}")

    result = {}
    for (tag, dname, key, args), out in zip(cases, outs):
        require(tuple(out.shape) == (B, T, H, P)
                and out.dtype == args[0].dtype, f"ssd_scan {tag}: "
                f"{out.dtype} {tuple(out.shape)}")
        want = ref.ref_ssd_scan(*args)
        err = _ssd_close(torch, out, want, dname,
                         f"ssd_scan {tag} vs ref_ssd_scan")
        model = ssm.chunked_linear_attn(*args, chunk=L)[0]
        err_m = _ssd_close(torch, out, model, dname,
                           f"ssd_scan {tag} vs chunked_linear_attn")
        del model
        if key is None or key == "float32":
            # the kernel tiles T its own way: the chunk changes no bit
            out16 = ops.ssd_scan(*args, chunk=16)
            require(torch.equal(out16, out), f"ssd_scan {tag}: chunk 16 "
                    f"and chunk {L} differ")
            del out16
            log(f"  ssd_scan {tag}: chunk 16 and chunk {L} equal bit for "
                f"bit")
        else:
            # planted fault: the second half run alone loses the state the
            # first half carries into it; the check must see that
            half = T // 2
            lost = ops.ssd_scan(*(a[:, half:] for a in args), chunk=L)
            sound = _ssd_excess(torch, out[:, half:], want[:, half:], dname)
            planted = _ssd_excess(torch, lost, want[:, half:], dname)
            log(f"  ssd_scan {tag}: second half vs ref_ssd_scan "
                f"{sound:.3g} x the limit; run alone (state lost) "
                f"{planted:.3g} x")
            require(planted > 1.0, f"ssd_scan {tag}: the check misses a "
                                   f"lost state ({planted:.3g} x the limit)")
            del lost
        del want
        ms = cuda_ms(lambda: ops.ssd_scan(*args, chunk=L), iters=20)
        plain = cuda_ms(lambda: ref.ref_ssd_scan(*args), iters=2, warmup=1)
        model_ms = cuda_ms(lambda: ssm.chunked_linear_attn(*args, chunk=L),
                           iters=3, warmup=1)
        nbytes = sum(t.numel() * t.element_size() for t in args) \
            + out.numel() * out.element_size()
        flops = B * H * (T // L) * (L * (L + 1) * (K + P) + 4 * L * K * P)
        bound = _bound(nbytes, flops, dname)
        log(f"  ssd_scan {tag:20s} max_abs_err={err:.3e} (vs "
            f"chunked_linear_attn {err_m:.3e}) ms={ms:.4f} "
            f"plain_ms={plain:.4f} model_path_ms={model_ms:.4f} "
            f"library_ms=null bound_ms={bound[0]:.4f} ({bound[1]}) "
            f"of_bound={bound[0] / ms:.3f}")
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None,
                   bound_ms=bound[0], bound_by=bound[1],
                   of_bound=bound[0] / ms, model_path_ms=model_ms)
        if key is None:
            result.update(row)
        else:
            result[key] = row
    result.update(_ssm_train_cost(torch, cases[0][3], L))
    del outs, cases, q, k, v, decays
    torch.cuda.empty_cache()
    return counts, result


def _ssm_train_cost(torch, args, L):
    """What training pays for ``chunked_linear_attn`` recomputing each
    chunk in the backward pass (``ssm._Recomputed``): forward and backward
    on ``args`` (the bf16 mamba2 case) against the same chunk steps with
    autograd keeping every chunk's [B, n, l, l, H, K] pairs, device ms and
    peak GiB each; the two gradients must agree within f32 rounding."""
    from repro_torch.models import ssm
    B, T, H, K = args[0].shape
    P = args[2].shape[-1]
    ins = [a.detach().requires_grad_() for a in args]

    def kept(q, k, v, w):
        state = torch.zeros(B, H, K, P, device=q.device)
        qf, kf, vf, wf = (a.float() for a in (q, k, v, w))
        ys = []
        for c0 in range(0, T, L):
            sl = slice(c0, c0 + L)
            state, y = ssm._chunk_step(state, qf[:, sl], kf[:, sl],
                                       vf[:, sl], wf[:, sl], True, None)
            ys.append(y)
        return torch.cat(ys, dim=1).to(q.dtype), state

    def grads(scan):
        y, state = scan(*ins)
        return torch.autograd.grad(y.float().sum() + state.sum(), ins)

    row, got = {}, {}
    for name, scan in (("recomputed", lambda *a: ssm.chunked_linear_attn(
            *a, chunk=L)), ("kept", kept)):
        _free(torch)
        got[name] = grads(scan)
        torch.cuda.synchronize()
        peak = _peak_gib(torch)
        row[name] = (cuda_ms(lambda: grads(scan), iters=3, warmup=1), peak)
    rel = max(_rel(torch, a, b) for a, b in zip(got["recomputed"],
                                                  got["kept"]))
    log(f"  training through chunked_linear_attn (forward + backward, B {B}"
        f" T {T} H {H} K {K} P {P}, chunk {L}, bf16 inputs): each chunk "
        f"recomputed in backward {row['recomputed'][0]:.2f} ms, peak "
        f"{row['recomputed'][1]:.2f} GiB; every chunk's pairs kept "
        f"{row['kept'][0]:.2f} ms, peak {row['kept'][1]:.2f} GiB; gradients "
        f"rel L2 {rel:.3e} (limit 1e-5)")
    require(rel <= 1e-5, f"recomputed SSM gradients off by {rel:.3e}")
    return {"model_path_train_ms": row["recomputed"][0],
            "model_path_train_kept_ms": row["kept"][0]}


def _rel(torch, a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def hybrid_model_phase(torch, seed):
    """(b) zamba2-1.2b at full width, f32: a mamba2 layer chunked against
    token by token, and the model's chunked forward against its
    token-by-token prefill."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tf
    cfg = get_config("zamba2-1.2b").replace(activation_dtype="float32")
    dev = "cuda"
    t0 = time.perf_counter()
    params = tf.init_params(cfg, seed, dev, dtype=torch.float32)
    torch.cuda.synchronize()
    log(f"  zamba2-1.2b: layers={cfg.num_layers} d_model={cfg.d_model} "
        f"ssm chunk={cfg.ssm.chunk} shared invocations="
        f"{tf.n_shared_invocations(cfg)}, f32 init "
        f"{time.perf_counter() - t0:.1f}s")
    B, S = 2, 128
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    x = torch.randn(B, S, cfg.d_model, generator=gen, device=dev)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=dev)
    with torch.inference_mode():
        p = params["prefix"][0]["mamba"]
        y_chunk, st_chunk, _ = ssm.mamba2_block(p, x, cfg)
        st = cv = None
        steps = []
        for t in range(S):
            y, st, cv = ssm.mamba2_block(p, x[:, t:t + 1], cfg, st, cv)
            steps.append(y)
        y_step = torch.cat(steps, dim=1)
        rel_y, rel_s = _rel(torch, y_chunk, y_step), _rel(torch, st_chunk, st)
        log(f"  mamba2 layer, chunked vs token by token: rel L2 output "
            f"{rel_y:.3e}, state {rel_s:.3e} (tol {LAYER_REL_TOL})")
        require(bool(torch.isfinite(y_chunk).all())
                and max(rel_y, rel_s) <= LAYER_REL_TOL,
                f"mamba2 layer chunked vs steps rel {rel_y}, {rel_s}")
        t0 = time.perf_counter()
        lf, _ = tf.forward(params, cfg, {"tokens": toks}, last_only=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        lp, _ = tf.prefill(params, cfg, {"tokens": toks}, S)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        cfg16 = cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk=16))
        l16, _ = tf.forward(params, cfg16, {"tokens": toks}, last_only=True)
    lf, lp, l16 = (a[:, 0].float() for a in (lf, lp, l16))
    require(bool(torch.isfinite(lf).all() and torch.isfinite(lp).all()),
            "zamba2 logits not finite")
    require(tuple(lf.shape) == (B, cfg.vocab_size), f"logits {lf.shape}")
    rel, noise = _rel(torch, lf, lp), _rel(torch, lf, l16)
    tol = min(MODEL_REL_CAP, max(1e-3, MODEL_NOISE_FACTOR * noise))
    agree = (lf.argmax(-1) == lp.argmax(-1)).float().mean().item()
    log(f"  forward {B} x {S} in {t1 - t0:.2f}s, prefill in {t2 - t1:.2f}s; "
        f"last logits forward vs prefill: rel L2 {rel:.3e} (tol {tol:.3e}; "
        f"forward at chunk 64 vs 16: {noise:.3e}), argmax agreement "
        f"{agree:.2f}")
    require(rel <= tol, f"zamba2 forward vs prefill rel {rel}")
    del params
    torch.cuda.empty_cache()


SSM_ENGINE_LAYERS = (20, 16)      # phase 8c: zamba2-1.2b, rwkv6-7b


def ssm_engine_phase(torch, seed):
    """(c) the dense engine: LS zamba2-1.2b + BE rwkv6-7b, use_flash."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.tenancy import TenantSpec
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine
    rng = np.random.default_rng(seed + 13)
    lens = {c: [int(x) for x in np.repeat(rng.choice(np.arange(64, 257), 2,
                                                     replace=False), 2)]
            for c in ("LS", "BE")}
    # half depth (the script's time budget; widths as published): zamba2
    # keeps its 2 prefix layers and 3 of its 6 periods, rwkv6 16 of 32
    zamba, rwkv = (get_config(name).replace(num_layers=n) for name, n in
                   zip(("zamba2-1.2b", "rwkv6-7b"), SSM_ENGINE_LAYERS))
    plan = _engine_plan()
    max_new = 16
    log(f"  LS zamba2-1.2b ({zamba.num_layers} of 38 layers) prompts "
        f"{lens['LS']}; BE rwkv6-7b ({rwkv.num_layers} of 32 layers) prompts "
        f"{lens['BE']}; max_new {max_new}")
    eng = ServingEngine(max_seq=512, paged=False, use_flash=True,
                        slots_ls=4, slots_be=4, plan=plan,
                        torch_device="cuda")
    t0 = time.perf_counter()
    eng.add_tenant(TenantSpec("ls-zamba2", "LS"), zamba, seed=seed)
    eng.add_tenant(TenantSpec("be-rwkv6", "BE"), rwkv, seed=seed + 1)
    torch.cuda.synchronize()
    sizes = []
    tf.tree_map(lambda a: sizes.append(a.numel()),
                eng.tenants["be-rwkv6"].params)
    n_be = sum(sizes)
    log(f"  tenants ready in {time.perf_counter() - t0:.1f}s (rwkv6-7b at "
        f"{rwkv.num_layers} layers: {n_be / 1e9:.2f} B parameters in bf16)")
    reqs = []
    for name, cls, cfg in (("ls-zamba2", "LS", zamba),
                           ("be-rwkv6", "BE", rwkv)):
        for L in lens[cls]:
            reqs.append(eng.submit(name, rng.integers(0, cfg.vocab_size, L),
                                   max_new=max_new))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    n = eng.run_until_idle()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log(f"  {n} quanta in {time.perf_counter() - t0:.2f}s; launches {counts}")
    for r in reqs:
        require(not r.failed and r.output is not None
                and len(r.output) == max_new,
                f"request {r.rid} ({r.tenant}, {len(r.tokens)} tokens): "
                f"{None if r.output is None else len(r.output)} tokens")
    ls_decodes = sum(1 for q in eng.quantum_log
                     if q.tenant == "ls-zamba2" and q.decode_tokens)
    n_inv = tf.n_shared_invocations(zamba)
    require(counts["decode_attention"] == n_inv * ls_decodes,
            f"decode_attention launches {counts['decode_attention']} != "
            f"{n_inv} x {ls_decodes} LS decode calls")
    prefills = sum(1 for q in eng.quantum_log if q.prefill_tokens)
    log(f"  {ls_decodes} LS decode calls x {n_inv} shared invocations = "
        f"{counts['decode_attention']} decode_attention launches; "
        f"{prefills} quanta ran a monolithic prefill")
    cls = eng.metrics()["_class"]
    log("  metrics _class " + json.dumps(cls))
    del eng
    torch.cuda.empty_cache()
    return counts, cls


# ---------------------------------------------------------------------------
# phase 9: the tidal control plane on the engine
# ---------------------------------------------------------------------------

def _tidal_engine(params, *, controller=None, governor=None, plan=None):
    """Phase 5's paged LS qwen3-1.7b + BE stablelm-1.6b engine with colored
    KV pools over the tesla-p40 hash (12 channels). The colors are the
    reference's placement bookkeeping over a hash model the repo has, not
    the H100's memory channels: the repo has no H100 channel hash."""
    from repro_torch.configs import get_config
    from repro_torch.core.coloring import gpu_hash_model
    from repro_torch.core.tenancy import TenantSpec
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(max_seq=2048, paged=True, page_size=PAGE,
                        use_flash=True, chunk_size=256, slots_ls=8,
                        slots_be=8, plan=plan, coloring=True,
                        hash_model=gpu_hash_model("tesla-p40"),
                        arena_bytes=TIDAL_ARENA_BYTES, ch_be=1 / 3,
                        controller=controller, chunk_governor=governor,
                        control_interval=2, torch_device="cuda")
    eng.add_tenant(TenantSpec("ls-qwen3", "LS"), get_config("qwen3-1.7b"),
                   params=params["ls"])
    eng.add_tenant(TenantSpec("be-stablelm", "BE"),
                   get_config("stablelm-1.6b"), params=params["be"])
    return eng


def _timed_calls(targets):
    """Wrap each ``(obj, method, key)`` with a host timer whose ms land in
    ``spent[key]`` (a call made inside another counts in both)."""
    spent = {}
    for obj, name, key in targets:
        inner = getattr(obj, name)
        spent.setdefault(key, [])

        def timed(*a, _inner=inner, _key=key, **kw):
            t0 = time.perf_counter()
            try:
                return _inner(*a, **kw)
            finally:
                spent[_key].append((time.perf_counter() - t0) * 1e3)
        setattr(obj, name, timed)
    return spent


def _timed_control(eng):
    """The engine's control tick and plan adoption, and the arena's
    operations, under host timers."""
    return _timed_calls(
        [(eng, n, n) for n in ("_maybe_control", "apply_plan")]
        + [(eng.arena, n, n) for n in ("alloc", "release", "resplit",
                                       "isolation_violations")])


def _host_line(spent):
    return "; ".join(
        f"{k} {len(v)} calls, {sum(v):.1f} ms ({sum(v) / max(len(v), 1):.2f}"
        f" per call, max {max(v, default=0):.1f})" for k, v in spent.items())


def _ls_violations(eng):
    a = eng.arena
    return {n: a.isolation_violations(al) for n, al in a.allocations.items()
            if n.startswith("ls-") and a.isolation_violations(al)}


def tidal_phase(torch, seed, ls_tbt_p99_ms):
    """(a) static colored split, (b) the online controller with a chunk
    governor, (c) the static split with one mid-run channel resplit, on
    phase 5's prompts and the same weights. Returns each run's launches."""
    from dataclasses import replace
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.controller import (ChunkGovernor,
                                             OnlineController, ResourcePlan,
                                             tidal_frontier)
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    C = 12
    plan = ResourcePlan(sm_be=0.3, ch_be=1 / 3, thres_dram=0.4,
                        ls_channels=tuple(range(8)),
                        be_channels=tuple(range(8, 12)),
                        max_ls_inflation=0.25)
    t0 = time.perf_counter()
    params = {"ls": tf.init_params(get_config("qwen3-1.7b"), seed, "cuda",
                                   dtype=torch.bfloat16),
              "be": tf.init_params(get_config("stablelm-1.6b"), seed + 1,
                                   "cuda", dtype=torch.bfloat16)}
    torch.cuda.synchronize()
    log(f"  weights (phase 5's seeds) ready in {time.perf_counter() - t0:.1f}"
        f"s; arena {TIDAL_ARENA_BYTES >> 30} GiB over the tesla-p40 hash "
        f"({C} channels; bookkeeping, not the H100's channels)")
    lens = np.random.default_rng(seed + 7)
    ls_lens = [int(x) for x in lens.integers(128, 1025, 8)]
    be_lens = [int(x) for x in lens.integers(512, 1537, 8)]
    rng = np.random.default_rng(seed)     # phase 5's token draw
    ls_p = [rng.integers(0, get_config("qwen3-1.7b").vocab_size, L)
            for L in ls_lens]
    be_p = [rng.integers(0, get_config("stablelm-1.6b").vocab_size, L)
            for L in be_lens]
    tide = [rng.integers(0, get_config("qwen3-1.7b").vocab_size, L)
            for L in (300, 700)]
    target = 0.5 * ls_tbt_p99_ms
    log(f"  LS prompts {ls_lens}; BE prompts {be_lens}; tide LS (b) "
        f"[300, 700]; max_new 32; chunk governor target TBT {target:.1f} ms"
        f" (half phase 5's LS TBT p99)")
    max_new = 32
    runs = {}
    for mode in ("static", "tidal", "resplit"):
        governor = controller = None
        if mode == "tidal":
            controller = OnlineController(tidal_frontier(plan, C),
                                          idle_patience=1)
            governor = ChunkGovernor(target_tbt_ms=target, chunk=256,
                                     min_chunk=32, max_chunk=256)
        t0 = time.perf_counter()
        eng = _tidal_engine(params, plan=plan, controller=controller,
                            governor=governor)
        spent = _timed_control(eng)
        t_setup = time.perf_counter() - t0
        reqs = [eng.submit("ls-qwen3", p, max_new=max_new) for p in ls_p]
        reqs += [eng.submit("be-stablelm", p, max_new=max_new)
                 for p in be_p]
        ops.reset_launch_counts()
        bad, checks, lent_step, snapped = {}, 0, None, None
        t_check = 0.0
        admit = {k: len(v) for k, v in spent.items()}
        t0 = time.perf_counter()
        steps = 0
        while steps < 100_000:
            n_tr, moved = len(eng.transitions), eng.migrated_bytes
            progressed = eng.step()
            steps += 1
            if mode == "tidal" and lent_step is None and eng.sm_be >= 1.0:
                lent_step = eng.transitions[-1]["step"]
                reqs += [eng.submit("ls-qwen3", p, max_new=max_new)
                         for p in tide]
                eng.step()                 # the out-of-band tick
                steps += 1
                snapped = eng.sm_be
            if mode == "resplit" and steps == 3:
                eng.apply_plan(replace(plan, ch_be=0.5))
            tc = time.perf_counter()
            n_viol = len(spent["isolation_violations"])
            if mode == "resplit" and steps >= 3 and (
                    steps == 3 or steps % 10 == 0):
                checks += 1
                a = eng.arena
                for n, al in a.allocations.items():
                    if a.isolation_violations(al):
                        bad[n] = a.isolation_violations(al)
            elif (mode == "tidal" and (len(eng.transitions) != n_tr
                                       or eng.migrated_bytes != moved)):
                checks += 1
                bad.update(_ls_violations(eng))
            del spent["isolation_violations"][n_viol:]   # the checks' own
            t_check += time.perf_counter() - tc
            if not progressed and not any(rt.has_work()
                                          for rt in eng.tenants.values()):
                break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - t_check
        counts, routes = ops.launch_counts(), ops.route_counts()
        for r in reqs:
            require(not r.failed and r.output is not None
                    and len(r.output) == max_new,
                    f"({mode}) request {r.rid} ({r.tenant}, "
                    f"{len(r.tokens)} tokens): "
                    f"{None if r.output is None else len(r.output)} tokens")
        require(counts["decode_attention_paged"] > 0
                and counts["prefill_attention_paged"] > 0,
                f"({mode}) paged kernels not launched: {counts}")
        require(routes["prefill_attention_paged"] == {
            "wgmma": counts["prefill_attention_paged"], "simt": 0},
            f"({mode}) prefill routes {routes['prefill_attention_paged']}")
        # the run's host work only (not set-up, not the checks, not the
        # metrics() call below)
        spent = {k: v[admit[k]:] for k, v in spent.items()}
        m = eng.metrics()
        cls = m["_class"]
        be_toks = sum(len(r.output) for r in reqs if r.tenant != "ls-qwen3")
        log(f"  ({mode}) smoke: {len(eng.events)} quanta in {wall:.2f}s "
            f"(set-up {t_setup:.1f}s, checks {t_check * 1e3:.0f} ms "
            f"excluded); LS TTFT p50/p99 {cls['LS']['ttft']['p50_ms']:.1f}/"
            f"{cls['LS']['ttft']['p99_ms']:.1f} ms, TBT p50/p99 "
            f"{cls['LS']['tbt']['p50_ms']:.1f}/"
            f"{cls['LS']['tbt']['p99_ms']:.1f} ms; BE "
            f"{be_toks / wall:.2f} tokens/s (run wall); BE "
            f"peak_active {m['be-stablelm']['peak_active']}; launches "
            f"{counts}")
        log(f"  ({mode}) host: {_host_line(spent)}; migrated "
            f"{eng.migrated_bytes} B")
        for t in eng.transitions:
            log(f"    transition step {t['step']}: sm_be {t['sm_be']:.2f} "
                f"ch_be {t['ch_be']:.3f} pages {t['pages_moved']} bytes "
                f"{t['bytes_moved']} cause {t['cause']}"
                + (f" chunk {t['chunk_size']} budget {t['prefill_budget']}"
                   if "chunk_size" in t else ""))
        require(not bad, f"({mode}) isolation violations {bad} "
                f"({checks} checks)")
        runs[mode] = {"tokens": [list(r.output) for r in reqs[:16]],
                      "events": list(eng.events), "counts": counts,
                      "peak_be": m["be-stablelm"]["peak_active"],
                      "causes": [t["cause"] for t in eng.transitions],
                      "lent": lent_step, "snapped": snapped,
                      "checks": checks}
        del eng
    tidal = runs["tidal"]
    require(tidal["lent"] is not None, "the controller never lent")
    require(tidal["snapped"] is not None and tidal["snapped"] < 1.0,
            f"no snap-back one step after the LS tide ({tidal['snapped']})")
    require({"lending", "snap_back", "chunk_adapt"} <= set(tidal["causes"]),
            f"tidal causes {tidal['causes']}")
    require(tidal["peak_be"] > runs["static"]["peak_be"],
            f"BE peak_active tidal {tidal['peak_be']} <= static "
            f"{runs['static']['peak_be']}")
    require(runs["resplit"]["tokens"] == runs["static"]["tokens"],
            "tokens changed across a mid-run resplit")
    log(f"  tidal: lent at step {tidal['lent']}, sm_be {tidal['snapped']} "
        f"one step after the tide; BE peak_active tidal {tidal['peak_be']}"
        f" vs static {runs['static']['peak_be']}; resplit tokens equal "
        f"static (bit for bit); quantum order equal: "
        f"{runs['resplit']['events'] == runs['static']['events']}; LS "
        f"violation checks {tidal['checks']}, resplit checks "
        f"{runs['resplit']['checks']}")
    del params
    torch.cuda.empty_cache()
    return {mode: r["counts"] for mode, r in runs.items()}


# ---------------------------------------------------------------------------
# phase 10: the KV memory hierarchy and the fault plane on the engine
# ---------------------------------------------------------------------------

HIER_MAX_NEW = 32
# phase 10c's storm on a virtual clock of one unit an engine step: Poisson
# rates per step and the windows' length in steps
STORM_RATES = {"swap_write_fail": 0.02, "swap_read_fail": 0.02,
               "page_corrupt": 0.03, "alloc_fail": 0.01}
STORM_DURATION, STORM_HORIZON = 8.0, 1000.0


def _hier_engine(params, *, ls_only=False, **kw):
    """Phase 5's paged LS qwen3-1.7b + BE stablelm-1.6b engine (uncolored)
    with the hierarchy's options in ``kw``."""
    from repro_torch.configs import get_config
    from repro_torch.core.tenancy import TenantSpec
    from repro_torch.serving import ServingEngine
    kw.setdefault("plan", _engine_plan())
    eng = ServingEngine(max_seq=2048, paged=True, page_size=PAGE,
                        use_flash=True, chunk_size=256, slots_ls=8,
                        slots_be=8, torch_device="cuda", **kw)
    eng.add_tenant(TenantSpec("ls-qwen3", "LS"), get_config("qwen3-1.7b"),
                   params=params["ls"])
    if not ls_only:
        eng.add_tenant(TenantSpec("be-stablelm", "BE"),
                       get_config("stablelm-1.6b"), params=params["be"])
    return eng


def _shared_prompts(rng, vocab, prefix_len, n):
    """``n`` prompts of one common prefix and distinct suffixes of 64-256
    tokens whose first tokens all differ, so no hit reaches past the
    prefix."""
    import numpy as np
    prefix = rng.integers(0, vocab, prefix_len)
    firsts = rng.choice(vocab, n, replace=False)
    return [np.concatenate([prefix, [f], rng.integers(0, vocab, int(L) - 1)])
            for f, L in zip(firsts, rng.integers(64, 257, n))]


def _capture_kv(eng, tenant):
    """Keep a copy of each request's prompt K/V pages (every layer) when
    its first token is seeded, keyed by rid (``_kv_list`` orders them as
    the tenant's requests)."""
    import torch
    rt, store = eng.tenants[tenant], {}
    inner = eng.backend._seed_first_token

    def seed(rt_, req, tok):
        if rt_ is rt:
            n = rt.kv.pages_for(len(req.tokens))
            pages = torch.as_tensor(rt.kv.page_table[req.slot, :n]
                                    .astype("int64"),
                                    device=rt.kv.device)
            store[req.rid] = {k: leaf.index_select(1, pages).clone()
                              for k, leaf in rt.cache["layers"]["s0"].items()}
        inner(rt_, req, tok)
    eng.backend._seed_first_token = seed
    return store


def _kv_list(store, reqs):
    return [store[r.rid] for r in reqs]


def _first_kv_diff(a, b, first_page=0):
    """(layer, leaf, position) of the first K/V element that differs
    between two captures of one prompt's pages, from ``first_page`` on, or
    None."""
    for layer in range(a["k"].shape[0]):
        for leaf in ("k", "v"):
            d = (a[leaf][layer, first_page:]
                 != b[leaf][layer, first_page:])   # [n, Hkv, page, D]
            if bool(d.any()):
                pos = d.any(dim=3).any(dim=1).reshape(-1)
                return (layer, leaf,
                        first_page * PAGE + int(pos.nonzero()[0, 0]))
    return None


def _serve_warm(torch, eng, prompts, *, after_warm=None, clock=None):
    """Submit each tenant's first prompt, step until it decodes (its prompt
    pages donated to the tree when the prefix cache is on), then submit the
    rest and run to idle. ``clock``: a virtual step clock to advance."""
    from repro_torch.serving import Phase
    reqs = {t: [eng.submit(t, p[0], max_new=HIER_MAX_NEW)]
            for t, p in prompts.items()}
    firsts = [r[0] for r in reqs.values()]
    t0 = time.perf_counter()
    while any(r.phase not in (Phase.DECODING, Phase.FINISHED)
              for r in firsts):
        if clock is not None:
            clock["t"] += 1.0
        eng.step()
    if after_warm is not None:
        after_warm(eng, {t: r[0] for t, r in reqs.items()})
    for t, p in prompts.items():
        reqs[t] += [eng.submit(t, q, max_new=HIER_MAX_NEW) for q in p[1:]]
    _drive_idle(eng, clock)
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0


def _drive_idle(eng, clock=None, stall_cap=10_000):
    """Step until no tenant has work; a step that makes no progress inside
    a fault window (a deferral) does not end the run."""
    stall = 0
    while stall < stall_cap:
        if clock is not None:
            clock["t"] += 1.0
        if eng.step():
            stall = 0
        elif not any(rt.has_work() for rt in eng.tenants.values()):
            return
        else:
            stall += 1
    raise Check("engine wedged: no progress in "
                f"{stall_cap} steps with work left")


def _toks(reqs):
    return {t: [None if r.failed else list(r.output) for r in rs]
            for t, rs in reqs.items()}


def _first_divergence(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            j = next((k for k, (u, v) in enumerate(zip(x, y)) if u != v),
                     min(len(x), len(y)))
            return i, j
    return None


def _timed_host(eng):
    """Every tenant's HostSwapPool put and get under host timers."""
    return _timed_calls([(rt.host, n, n) for rt in eng.tenants.values()
                         for n in ("put", "get")])


def _p50(xs):
    xs = sorted(xs)
    return xs[(len(xs) - 1) // 2] if xs else None


def hierarchy_phase(torch, seed):
    """(a) the prefix cache, (b) page growth and the host swap tier in fp16
    and int8, (c) a seeded fault storm over (b), and the ladder's
    flash_to_dense rung in f32, on phase 5's models and weights. Returns
    the launches of (a)-(c) and what the JSON line records."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.serving import FaultPlane
    LS, BE = "ls-qwen3", "be-stablelm"
    t_phase = time.perf_counter()
    params = {"ls": tf.init_params(get_config("qwen3-1.7b"), seed, "cuda",
                                   dtype=torch.bfloat16),
              "be": tf.init_params(get_config("stablelm-1.6b"), seed + 1,
                                   "cuda", dtype=torch.bfloat16)}
    torch.cuda.synchronize()
    rng = np.random.default_rng(seed + 17)
    ls_vocab = get_config("qwen3-1.7b").vocab_size
    prompts = {LS: _shared_prompts(rng, ls_vocab, 768, 8),
               BE: _shared_prompts(rng, get_config("stablelm-1.6b")
                                   .vocab_size, 512, 8)}
    unaligned = _shared_prompts(rng, ls_vocab, 800, 8)
    log(f"  weights (phase 5's seeds) ready in "
        f"{time.perf_counter() - t_phase:.1f}s; LS prompts "
        f"{[len(p) for p in prompts[LS]]} (768-token prefix), BE prompts "
        f"{[len(p) for p in prompts[BE]]} (512); max_new {HIER_MAX_NEW}; "
        "first request of each tenant warms, then the other 7 arrive")
    ops.reset_launch_counts()

    # -- (a) prefix cache -------------------------------------------------
    runs = {}
    for name, kw in (("off", {}), ("on", {"prefix_cache": True})):
        eng = _hier_engine(params, **kw)
        kv = _capture_kv(eng, LS)
        reqs, wall = _serve_warm(torch, eng, prompts)
        m = eng.metrics()
        runs[name] = {"toks": _toks(reqs), "wall": wall,
                      "kv": _kv_list(kv, reqs[LS]),
                      "computed": {t: eng.tenants[t].prefill_computed
                                   for t in prompts},
                      "hits": {t: [r.hit_tokens for r in rs]
                               for t, rs in reqs.items()},
                      "ttft": [r.ttft * 1e3 for r in reqs[LS][1:]],
                      "ttft0": reqs[LS][0].ttft * 1e3}
        log(f"  (a) prefix {name}: {len(eng.events)} quanta in {wall:.2f}s;"
            f" LS TTFT first {runs[name]['ttft0']:.1f} ms, later 7 p50 "
            f"{_p50(runs[name]['ttft']):.1f} ms; prefill computed "
            f"{runs[name]['computed']}"
            + (f"; prefix_cache LS {m[LS]['prefix_cache']} BE "
               f"{m[BE]['prefix_cache']}" if name == "on" else ""))
        for t, rs in reqs.items():
            for r in rs:
                require(not r.failed and len(r.output) == HIER_MAX_NEW,
                        f"(a {name}) request {r.rid} ({t}): {r.output}")
        del eng
    off, on = runs["off"], runs["on"]
    for t in prompts:
        div = _first_divergence(off["toks"][t], on["toks"][t])
        require(div is None, f"(a) {t} tokens differ with the prefix cache "
                f"on: request {div}")
        hit = sum(on["hits"][t])
        saved = off["computed"][t] - on["computed"][t]
        require(saved == hit, f"(a) {t}: prefill computed lower by {saved}"
                f", hit tokens {hit}")
    ls_hit = sum(on["hits"][LS])
    require(ls_hit >= 7 * 768, f"(a) LS hit tokens {ls_hit} < 7 x 768")
    # the K/V each LS prompt leaves in every layer: a hit's suffix rows
    # read the shared pages in layer l and write layer l + 1's K/V
    for i, (a, b) in enumerate(zip(off["kv"], on["kv"])):
        diff = _first_kv_diff(a, b)
        require(diff is None, f"(a) LS request {i}: prompt K/V differ "
                f"with the prefix cache on, first at (layer, leaf, "
                f"position) {diff}")
    log(f"  (a) tokens bit-equal prefix on/off (16 requests), and every LS "
        f"prompt's K/V in all {off['kv'][0]['k'].shape[0]} layers; hit "
        f"tokens "
        f"LS {ls_hit} BE {sum(on['hits'][BE])} = prefill tokens saved; LS "
        f"TTFT p50 of the 7 later requests: hit {_p50(on['ttft']):.1f} ms, "
        f"cold {_p50(off['ttft']):.1f} ms")

    # planted fault: one shared K page of the tree zeroed in every layer
    # once the first LS request has donated its prompt pages; the later
    # hits must then write other K/V at their suffix rows
    def zero_page(eng, first):
        rt = eng.tenants[LS]
        page = int(rt.kv.page_table[first[LS].slot, 10])
        require(rt.kv.page_ref[page] >= 1 and any(
            nd.page == page for nd in rt.prefix._nodes()),
            f"(a) page {page} is not a tree page")
        rt.cache["layers"]["s0"]["k"][:, page].zero_()
    eng = _hier_engine(params, ls_only=True, prefix_cache=True)
    kv = _capture_kv(eng, LS)
    reqs, _ = _serve_warm(torch, eng, {LS: prompts[LS]},
                          after_warm=zero_page)
    planted = _toks(reqs)[LS]
    changed = sum(a != b for a, b in zip(planted[1:], on["toks"][LS][1:]))
    # the hits' own rows: the suffix from the prefix's 48 pages on
    moved = [_first_kv_diff(a, b, first_page=768 // PAGE)
             for a, b in zip(on["kv"][1:], _kv_list(kv, reqs[LS])[1:])]
    require(all(d is not None for d in moved),
            f"(a) planted fault: a zeroed shared K page left a later hit's "
            f"suffix K/V unchanged: {moved}")
    log(f"  (a) planted fault (tree page's K zeroed in every layer): every "
        f"later hit's suffix K/V differ from the clean run, first at "
        f"(layer, leaf, position) {sorted(set(moved))}; "
        f"{changed} of 7 hits' tokens differ")
    del eng, kv
    for r in runs.values():
        del r["kv"]

    # the prefix at 800 tokens, not a multiple of the 256-token chunk:
    # reported, not required
    caps, toks800 = {}, {}
    for name, kw in (("off", {}), ("on", {"prefix_cache": True})):
        eng = _hier_engine(params, ls_only=True, **kw)
        kv = _capture_kv(eng, LS)
        reqs, _ = _serve_warm(torch, eng, {LS: unaligned})
        toks800[name] = _toks(reqs)[LS]
        caps[name] = _kv_list(kv, reqs[LS])
        hits800 = sum(r.hit_tokens for r in reqs[LS])
        del eng
    div = _first_divergence(toks800["off"], toks800["on"])
    kv_diff = dict(enumerate(_first_kv_diff(a, b)
                             for a, b in zip(caps["off"], caps["on"])))
    line = (f"  (a) 800-token prefix (hit tokens {hits800}): tokens "
            f"bit-equal on/off: {div is None}; prompt K/V bit-equal: "
            f"{not any(kv_diff.values())}")
    if div is not None:
        line += f"; first diverging request {div[0]} at token {div[1]}"
    if any(kv_diff.values()):
        i, d = next((k, v) for k, v in kv_diff.items() if v)
        line += (f"; first differing op output: request {i}'s layer "
                 f"{d[0]} {d[1]}-projection at position {d[2]}")
    log(line)
    del caps, kv

    # -- (b) growth and the host swap tier ---------------------------------
    extent = {t: sum(-(-(len(p) + HIER_MAX_NEW) // PAGE) for p in ps)
              for t, ps in prompts.items()}
    kv_pages = min(extent.values()) // 2
    log(f"  (b) kv_pages {kv_pages} per tenant (full extent of the batch: "
        f"LS {extent[LS]}, BE {extent[BE]} pages)")
    swapped = {}
    for dtype in ("fp16", "int8"):
        eng = _hier_engine(params, grow_pages=True, swap=True,
                           cold_dtype=dtype, kv_pages=kv_pages)
        spent = _timed_host(eng)
        reqs = {t: [eng.submit(t, p, max_new=HIER_MAX_NEW) for p in ps]
                for t, ps in prompts.items()}
        t0 = time.perf_counter()
        _drive_idle(eng)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        m = eng.metrics()
        sw = {t: m[t]["swap"] for t in prompts}
        for t, rs in reqs.items():
            for r in rs:
                require(not r.failed and len(r.output) == HIER_MAX_NEW,
                        f"(b {dtype}) request {r.rid} ({t}): {r.output}")
        toks = _toks(reqs)
        equal = sum(a == b for t in prompts
                    for a, b in zip(toks[t], off["toks"][t]))
        host = {t: s["host"] for t, s in sw.items()}
        log(f"  (b) {dtype}: {len(eng.events)} quanta in {wall:.2f}s; "
            + "; ".join(f"{t} preemptions {s['preemptions']} swap_outs "
                        f"{s['swap_outs']} swap_ins {s['swap_ins']} "
                        f"grow_stalls {s['grow_stalls']}"
                        for t, s in sw.items())
            + f"; {equal} of 16 requests' tokens equal the unpressured run")
        log(f"  (b) {dtype} host tier: to host "
            f"{sum(h['bytes_to_host'] for h in host.values())} B, to device "
            f"{sum(h['bytes_to_device'] for h in host.values())} B, pcie_s "
            f"{sum(h['pcie_s'] for h in host.values()):.6f}; host ms a put "
            f"{sum(spent['put']) / max(len(spent['put']), 1):.3f} "
            f"({len(spent['put'])} puts), a get "
            f"{sum(spent['get']) / max(len(spent['get']), 1):.3f} "
            f"({len(spent['get'])} gets)")
        swapped[dtype] = {"toks": toks, "sw": sw}
        del eng
    fp16 = swapped["fp16"]
    require(sum(s["swap_outs"] for s in fp16["sw"].values()) > 0
            and sum(s["swap_ins"] for s in fp16["sw"].values()) > 0,
            f"(b) fp16: no swap out/in {fp16['sw']}")
    for t in prompts:
        div = _first_divergence(off["toks"][t], fp16["toks"][t])
        require(div is None, f"(b) fp16 {t} tokens differ from the "
                f"unpressured run: request {div}")
    log("  (b) fp16 tokens bit-equal to the unpressured run (16 requests)")

    # -- (c) a seeded fault storm over (b)'s fp16 run ----------------------
    # fault_budget: the ladder's first rung would move a bf16 tenant onto
    # the torch-op attention core, whose roundings differ from the
    # kernels'; (c) holds the recovery paths, the f32 run below the rung
    clock = {"t": 0.0}
    plane = FaultPlane.storm(horizon=STORM_HORIZON, seed=seed,
                             rates=STORM_RATES, duration=STORM_DURATION)
    eng = _hier_engine(params, grow_pages=True, swap=True, cold_dtype="fp16",
                       kv_pages=kv_pages, faults=plane, fault_budget=10 ** 6,
                       now_fn=lambda: clock["t"])
    reqs = {t: [eng.submit(t, p, max_new=HIER_MAX_NEW) for p in ps]
            for t, ps in prompts.items()}
    t0 = time.perf_counter()
    _drive_idle(eng, clock)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fa = eng.metrics()["faults"]
    corrupt = sum(rt.host.corruptions for rt in eng.tenants.values())
    toks = _toks(reqs)
    surv = sum(x is not None for t in prompts for x in toks[t])
    log(f"  (c) storm: {int(clock['t'])} steps, {len(eng.events)} quanta "
        f"in {wall:.2f}s; injected {fa['injected']}; recovered "
        f"{fa['recovered']}; CRC catches {corrupt}; shed {fa['shed']}; "
        f"swap retries {fa['swap_retries']}; grow deadlocks "
        f"{fa['grow_deadlocks']}; {surv} of 16 requests survive")
    require(sum(fa["injected"].values()) > 0
            and sum(fa["recovered"].values()) > 0 and corrupt >= 1,
            f"(c) storm not exercised: injected {fa['injected']}, "
            f"recovered {fa['recovered']}, CRC catches {corrupt}")
    require(all(x is not None for x in toks[LS])
            and eng.tenants[LS].shed == 0, "(c) an LS request was shed")
    for t in prompts:
        for i, (x, y) in enumerate(zip(toks[t], fp16["toks"][t])):
            require(x is None or x == y, f"(c) {t} request {i}: surviving "
                    "tokens differ from (b)'s fp16 run")
    log("  (c) every surviving request bit-equal to (b)'s fp16 run; LS "
        "never shed")
    del eng
    counts, routes = ops.launch_counts(), ops.route_counts()
    del params
    torch.cuda.empty_cache()
    log(f"  (a)-(c) launches {counts}; prefill routes "
        f"{routes['prefill_attention_paged']}")
    require(counts["decode_attention_paged"] > 0
            and counts["prefill_attention_paged"] > 0,
            f"paged kernels not launched: {counts}")
    require(routes["prefill_attention_paged"] == {
        "wgmma": counts["prefill_attention_paged"], "simt": 0},
        f"hierarchy prefill routes {routes['prefill_attention_paged']}")

    # -- the ladder's flash_to_dense rung, phase 6b's f32 configuration ----
    from repro_torch.core.tenancy import TenantSpec
    from repro_torch.serving import ServingEngine
    cfg = get_config("qwen3-1.7b").replace(activation_dtype="float32")
    lens = np.random.default_rng(seed + 13).integers(128, 513, 4)
    f32 = tf.init_params(cfg, seed, "cuda", dtype=torch.float32)
    out = {}
    for mode in ("torch-op", "rung"):
        eng = ServingEngine(max_seq=1024, paged=True, page_size=PAGE,
                            use_flash=mode == "rung", chunk_size=256,
                            slots_ls=4, fault_budget=1, torch_device="cuda")
        rt = eng.add_tenant(TenantSpec(LS, "LS"), cfg, params=f32)
        if mode == "rung":
            eng.backend._record_recovery(rt, "synthetic")
            require(not rt.flash and rt.degraded == ["flash_to_dense"],
                    f"rung not taken: {rt.degraded}")
        p = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                 (len(lens), 512))
        before = ops.launch_counts()
        reqs = [eng.submit(LS, p[i, :L], max_new=8)
                for i, L in enumerate(lens)]
        eng.run_until_idle()
        torch.cuda.synchronize()
        after = ops.launch_counts()
        out[mode] = ([list(r.output) for r in reqs],
                     {k: after[k] - before[k] for k in after},
                     eng.metrics().get("faults", {}).get("degraded_tenants"))
        del eng
    require(out["rung"][0] == out["torch-op"][0],
            "flash_to_dense: tokens differ from the torch-op engine")
    require(not any(out["rung"][1].values()),
            f"flash_to_dense: kernels still launched {out['rung'][1]}")
    log(f"  flash_to_dense (f32, TF32 off, prompts {list(map(int, lens))}):"
        f" rungs taken {out['rung'][2]}; tokens equal the torch-op "
        "engine's; no kernel launched after the rung")
    del f32
    torch.cuda.empty_cache()
    log(f"  phase 10 wall {time.perf_counter() - t_phase:.1f}s")
    return counts, routes


# ---------------------------------------------------------------------------
# phase 11: disaggregation and the launcher
# ---------------------------------------------------------------------------

# one qwen3-1.7b KV page on the wire, bf16 carried as its raw 16 bits:
# 16 tokens x 28 layers x 8 KV heads x 128 dims x (K, V) x 2 bytes
WIRE_PAGE_BYTES = PAGE * 28 * 8 * 128 * 2 * 2
DISAGG_MAX_NEW = 32


def _slice_launches(eng, into):
    """Add the kernel launches made inside ``eng.step`` to ``into``."""
    from repro_torch.kernels import ops
    inner = eng.step

    def step():
        before = ops.launch_counts()
        try:
            return inner()
        finally:
            for k, v in ops.launch_counts().items():
                into[k] = into.get(k, 0) + v - before[k]
    eng.step = step


def _wire_check(dis, tenant, plant_at=None):
    """Hold every page the decode slice restores from the wire against the
    page the prefill slice shipped: a device copy of the prefill pool's
    page taken at the put, compared bit for bit with the decode pool's
    page right after the get. ``plant_at``: the wire copy of that put
    (1-based) has one bf16 exponent bit flipped after its CRC was taken
    (the decode pool's check is turned off, so the page is served)."""
    import numpy as np
    import torch
    from repro_torch.serving.swap import _page_leaves
    host = dis.decode.tenants[tenant].host
    put, get = host.put, host.get
    shipped, res = {}, {"pages": 0, "bad": [], "planted": []}
    if plant_at is not None:
        host.verify = False

    def put_(pools, key, page, t=0.0):
        n = put(pools, key, page, t=t)
        shipped[key] = [leaf.select(ax, page).clone()
                        for leaf, ax in _page_leaves(pools)]
        if plant_at is not None and len(shipped) == plant_at:
            hp = host.pages[key]
            rot = hp.leaves[0].copy()
            rot.view(np.uint16).reshape(-1)[0] ^= 0x4000
            hp.leaves[0] = rot
            res["planted"].append(key)
        return n

    def get_(pools, key, dest, t=0.0):
        out = get(pools, key, dest, t=t)
        want = shipped.pop(key)
        res["pages"] += 1
        if not all(torch.equal(leaf.select(ax, dest), w)
                   for (leaf, ax), w in zip(_page_leaves(pools), want)):
            res["bad"].append(key)
        return out
    host.put, host.get = put_, get_
    return res


def _disagg_run(torch, params, prompts, *, tenant, check=False,
                timers=False, plant_at=None, **kw):
    """One DisaggregatedEngine run over ``prompts`` at phase 5's LS
    settings. Returns the engine and what the run recorded."""
    from repro_torch.configs import get_config
    from repro_torch.core.tenancy import TenantSpec
    from repro_torch.kernels import ops
    from repro_torch.serving import DisaggregatedEngine
    dis = DisaggregatedEngine(max_seq=2048, page_size=PAGE, chunk_size=256,
                              slots_prefill=8, slots_decode=8,
                              use_flash=True, seed=0, torch_device="cuda",
                              **kw)
    dis.add_tenant(TenantSpec(tenant, "LS"), get_config("qwen3-1.7b"),
                   params=params)
    rec = {"slices": {"prefill": {}, "decode": {}}}
    _slice_launches(dis.prefill, rec["slices"]["prefill"])
    _slice_launches(dis.decode, rec["slices"]["decode"])
    if check or plant_at is not None:
        rec["wire"] = _wire_check(dis, tenant, plant_at)
    if timers:
        rec["host"] = _timed_calls([(dis.decode.tenants[tenant].host, n, n)
                                    for n in ("put", "get")])
    for p in prompts:
        dis.submit(tenant, p, max_new=DISAGG_MAX_NEW)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    dis.run_until_idle()
    torch.cuda.synchronize()
    rec["wall"] = time.perf_counter() - t0
    rec["counts"] = ops.launch_counts()
    rec["routes"] = ops.route_counts()
    rec["outputs"] = dis.outputs(tenant)
    rec["metrics"] = dis.metrics()
    rec["shipped"] = sum(st.shipped_pages for st in dis._mig.values())
    return dis, rec


def disagg_phase(torch, seed):
    """(a) phase 5's LS tenant served co-located, then disaggregated over
    the modeled interconnect (pipelined twice, whole-group, 4 devices),
    tokens and wire K/V held bit for bit, a planted wire fault caught.
    Returns each run's launches of the two paged kernels."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.tenancy import TenantSpec
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine
    LS = "ls-qwen3"
    t_phase = time.perf_counter()
    cfg = get_config("qwen3-1.7b")
    params = tf.init_params(cfg, seed, "cuda", dtype=torch.bfloat16)
    lens = [int(x) for x in
            np.random.default_rng(seed + 7).integers(128, 1025, 8)]
    rng = np.random.default_rng(seed)      # phase 5's token draw
    prompts = [rng.integers(0, cfg.vocab_size, L) for L in lens]
    torch.cuda.synchronize()
    log(f"  weights (phase 5's LS seed) ready in "
        f"{time.perf_counter() - t_phase:.1f}s; LS prompts {lens}; max_new "
        f"{DISAGG_MAX_NEW}; 8 slots a slice, virtual clock 1 ms a quantum")

    # -- the co-located baseline on the same virtual clock ---------------
    clock = {"t": 0.0}
    eng = ServingEngine(max_seq=2048, paged=True, page_size=PAGE,
                        use_flash=True, chunk_size=256, slots_ls=8,
                        now_fn=lambda: clock["t"], torch_device="cuda")
    eng.add_tenant(TenantSpec(LS, "LS"), cfg, params=params)
    reqs = [eng.submit(LS, p, max_new=DISAGG_MAX_NEW) for p in prompts]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    while any(rt.has_work() for rt in eng.tenants.values()):
        eng.step()
        clock["t"] += 1e-3
    torch.cuda.synchronize()
    co_wall = time.perf_counter() - t0
    co_counts = ops.launch_counts()
    base = [[int(x) for x in r.output] for r in reqs]
    require(all(len(o) == DISAGG_MAX_NEW for o in base),
            "co-located run: a request did not complete")
    co = eng.metrics()["_class"]["LS"]
    log(f"  co-located: {len(eng.events)} quanta, wall {co_wall:.2f}s; "
        f"virtual TTFT p50/p99 {co['ttft']['p50_ms']}/{co['ttft']['p99_ms']}"
        f" ms, TBT p50/p99 {co['tbt']['p50_ms']}/{co['tbt']['p99_ms']} ms;"
        f" launches {co_counts}")
    del eng
    torch.cuda.empty_cache()

    runs = {}
    for name, kw in (("pipelined", {"check": True}),
                     ("pipelined_replay", {"timers": True}),
                     ("whole_group", {"timers": True, "pipeline": False}),
                     ("n4_p2", {"n_devices": 4, "n_prefill": 2})):
        dis, rec = _disagg_run(torch, params, prompts, tenant=LS, **kw)
        rec["fingerprint"] = dis.fingerprint()
        m = rec["metrics"]
        dec = m["decode"]["_class"]["LS"]
        ic, mig = m["interconnect"], m["migrations"]
        host = rec.get("host")
        host_line = "" if host is None else "; host ms a wire " + ", ".join(
            f"{k} {sum(v) / max(len(v), 1):.3f} ({len(v)} calls)"
            for k, v in host.items())
        log(f"  {name}: wall {rec['wall']:.2f}s, {dis.rounds} rounds; "
            f"flows {ic['flows']}, {mig['pipelined_flows_per_req']} a "
            f"request; {rec['shipped']} pages shipped, xfer_bytes "
            f"{ic['xfer_bytes']}; decode slice virtual TTFT p50/p99 "
            f"{dec['ttft']['p50_ms']}/{dec['ttft']['p99_ms']} ms, TBT "
            f"p50/p99 {dec['tbt']['p50_ms']}/{dec['tbt']['p99_ms']} ms; "
            f"work_conservation {m['work_conservation']}{host_line}")
        log(f"    launches by slice {rec['slices']}; prefill routes "
            f"{rec['routes']['prefill_attention_paged']}")
        for i, (got, want) in enumerate(zip(rec["outputs"], base)):
            if got != want:
                j = next((k for k, (u, v) in enumerate(zip(got, want))
                          if u != v), min(len(got), len(want)))
                raise Check(f"{name}: request {i} ({lens[i]} tokens) "
                            f"differs from co-located at token {j}")
        require(mig["delivered"] == len(prompts) and mig["in_flight"] == 0,
                f"{name}: migrations {mig}")
        require(ic["xfer_bytes"] == rec["shipped"] * WIRE_PAGE_BYTES,
                f"{name}: xfer_bytes {ic['xfer_bytes']} != "
                f"{rec['shipped']} pages x {WIRE_PAGE_BYTES}")
        require(rec["shipped"] == sum(-(-L // PAGE) for L in lens),
                f"{name}: {rec['shipped']} pages shipped")
        c = rec["counts"]
        require(rec["routes"]["prefill_attention_paged"] == {
            "wgmma": c["prefill_attention_paged"], "simt": 0}
            and c["prefill_attention_paged"] > 0,
            f"{name}: prefill routes {rec['routes']}")
        require(rec["slices"]["decode"].get("decode_attention_paged", 0) > 0,
                f"{name}: the decode slice launched no decode kernel")
        require(not rec["slices"]["prefill"].get("decode_attention_paged"),
                f"{name}: the prefill slice decoded")
        if "wire" in rec:
            w = rec["wire"]
            require(w["pages"] == rec["shipped"] and not w["bad"],
                    f"{name}: wire K/V {w['pages']} pages restored, "
                    f"{len(w['bad'])} differ")
            log(f"    wire K/V: {w['pages']} pages restored bit-equal to "
                "the pages shipped")
        runs[name] = rec
        del dis
        torch.cuda.empty_cache()
    require(runs["pipelined"]["fingerprint"]
            == runs["pipelined_replay"]["fingerprint"],
            "seeded pipelined runs: fingerprints differ")
    require(runs["pipelined"]["metrics"]["interconnect"]["flows"]
            > runs["whole_group"]["metrics"]["interconnect"]["flows"],
            "pipelining shipped no more flows than whole groups")
    log("  every request of every run bit-equal to co-located; pipelined "
        "fingerprints equal; xfer_bytes = pages x "
        f"{WIRE_PAGE_BYTES} exactly")

    # -- a planted wire fault must read in the K/V check ------------------
    _, rec = _disagg_run(torch, params, prompts[:2], tenant=LS, plant_at=3)
    w = rec["wire"]
    require(w["planted"] and w["bad"] == w["planted"],
            f"planted wire fault: planted {w['planted']}, caught {w['bad']}")
    log(f"  planted fault (one bf16 exponent bit of wire page "
        f"{w['planted'][0]} flipped after its CRC, verify off): caught, "
        f"{len(w['bad'])} of {w['pages']} restored pages differ")
    del params
    torch.cuda.empty_cache()
    log(f"  phase 11a wall {time.perf_counter() - t_phase:.1f}s")
    return {k: {name: rec["counts"][k] for name, rec in runs.items()}
            for k in ("decode_attention_paged", "prefill_attention_paged")}


# the launcher's flag sets of phase 11b and the kernels each must launch
LAUNCH_SETS = {
    "paged_prefix_swap": (["--paged", "--use-flash", "--chunk-size", "8",
                           "--prefix-cache", "--swap"], "paged"),
    "dense": (["--use-flash", "--chunk-size", "8"], "dense"),
    "online_coloring": (["--online", "--coloring", "--paged",
                         "--use-flash"], "paged"),
    "disagg": (["--disagg", "--use-flash", "--devices", "4",
                "--prefill-devices", "2"], "paged"),
    "sim": (["--backend", "sim"], None),
    "trace": (["--trace", "TRACE", "--paged", "--use-flash"], "paged"),
}
LAUNCH_KERNELS = {"paged": ("decode_attention_paged",
                            "prefill_attention_paged"),
                  "dense": ("decode_attention", "prefill_attention")}


def _tensors(x, fn):
    """``x`` with ``fn`` applied to every tensor in it (tuples, lists and
    dicts walked)."""
    import torch
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_tensors(v, fn) for v in x)
    if isinstance(x, dict):
        return {k: _tensors(v, fn) for k, v in x.items()}
    return x


def _record_calls(names, into):
    """Wrap the entry point ``ops.<name>`` of each of ``names`` (the one
    the model layers call) so that every call keeps a copy of its inputs,
    taken before the call (the pools change in place after it), and of
    its output in ``into[name]``. Returns the function that unwraps."""
    from repro_torch.kernels import ops
    orig = {n: getattr(ops, n) for n in names}

    def wrap(name, fn):
        def call(*args, **kw):
            keep = _tensors((args, kw), lambda t: t.detach().clone())
            out = fn(*args, **kw)
            into.setdefault(name, []).append(
                (*keep, _tensors(out, lambda t: t.detach().clone())))
            return out
        return call
    for n, fn in orig.items():
        setattr(ops, n, wrap(n, fn))

    def undo():
        for n, fn in orig.items():
            setattr(ops, n, fn)
    return undo


def _check_calls(torch, calls, what):
    """Hold every recorded launch's output against the plain version: the
    same entry point on CPU copies of the same inputs, within TOL of the
    output's dtype (a progress tensor, where there is one, exactly).
    Returns {name: (calls, worst error, the shapes of q seen)}."""
    from repro_torch.kernels import ops
    res = {}
    for name, recs in calls.items():
        worst, shapes = 0.0, set()
        for args, kw, out in recs:
            want = getattr(ops, name)(*_tensors(args, lambda t: t.cpu()),
                                      **_tensors(kw, lambda t: t.cpu()))
            got, want = ((out, want) if isinstance(out, tuple)
                         else ((out,), (want,)))
            g, w = got[0].float().cpu(), want[0].float()
            tol = TOL[str(got[0].dtype).split(".")[-1]]
            err = (g - w).abs().max().item()
            require(torch.allclose(g, w, rtol=tol, atol=tol),
                    f"launcher {what}: {name} at q {tuple(args[0].shape)} "
                    f"not within {tol} of its plain version (max abs {err})")
            for a, b in zip(got[1:], want[1:]):
                require(torch.equal(a.cpu(), b),
                        f"launcher {what}: {name} progress {a.tolist()} != "
                        f"{b.tolist()}")
            worst = max(worst, err)
            shapes.add(tuple(args[0].shape))
        res[name] = (len(recs), worst, sorted(shapes))
    return res


def _served_tokens(eng):
    """Every tenant's outputs in submit order, from the engine
    ``serve.main`` returns (a ServingEngine or a DisaggregatedEngine)."""
    if hasattr(eng, "prefill"):
        return {t: eng.outputs(t) for t in eng.prefill.tenants}
    return {t: [[int(x) for x in r.output]
                for r in sorted(rt.done, key=lambda r: r.rid)]
            for t, rt in eng.tenants.items()}


def _launch(serve, argv):
    """``serve.main(argv)`` with its standard output captured: (engine,
    stdout, wall seconds)."""
    import contextlib
    import io
    import torch
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        eng = serve.main(argv)
    torch.cuda.synchronize()
    return eng, buf.getvalue(), time.perf_counter() - t0


def launcher_phase(torch):
    """(b) ``repro_torch.launch.serve.main`` in-process with each flag set
    of LAUNCH_SETS at its defaults (6 requests a tenant, LS qwen3-1.7b and
    BE gemma2-9b smoke configs in f32 on the torch backend, the full
    configs on sim). Every kernel launch of a run is held against its
    plain version at the shapes the run gave it, and each ``--use-flash``
    run's tokens against the same flags without it. Returns, by kernel,
    each set's launches and the worst error over them."""
    import contextlib
    import io
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.obs import schema
    out_dir = ROOT / "build" / "phase11"
    out_dir.mkdir(parents=True, exist_ok=True)
    trace = str(out_dir / "trace.json")
    res = {}
    for name, (argv, path) in LAUNCH_SETS.items():
        argv = [trace if a == "TRACE" else a for a in argv]
        want_k = LAUNCH_KERNELS.get(path, ())
        calls = {}
        undo = _record_calls(want_k, calls)
        ops.reset_launch_counts()
        try:
            eng, text, wall = _launch(serve, argv)
        finally:
            undo()
        counts, routes = ops.launch_counts(), ops.route_counts()
        m = json.JSONDecoder().raw_decode(text[text.index("{\n"):])[0]
        if name == "disagg":
            done = m["decode"]["_class"]["LS"]["completed"]
            require(m["migrations"]["delivered"] == 6 and done == 6,
                    f"launcher {name}: {m['migrations']}, {done} done")
        else:
            done = {c: m["_class"][c]["completed"] for c in ("LS", "BE")}
            # on sim the LS stream completes; BE (gemma2-9b at full width,
            # batch 8) is modeled over the launcher's horizon
            want = {"LS": 6, "BE": 6} if path else {"LS": 6}
            require(all(done[c] == n for c, n in want.items()),
                    f"launcher {name}: completed {done}")
        ran = {k: v for k, v in counts.items() if v}
        require(set(ran) == set(want_k),
                f"launcher {name}: launched {ran}, expected {want_k}")
        for k in want_k:
            if k in routes:
                require(routes[k] == {"simt": counts[k], "wgmma": 0},
                        f"launcher {name}: {k} routes {routes[k]} (f32 "
                        "smoke configs take the CUDA-core body)")
            require(len(calls.get(k, ())) == counts[k],
                    f"launcher {name}: {len(calls.get(k, ()))} calls of "
                    f"{k} recorded, {counts[k]} launched")
        if name == "trace":
            sbuf = io.StringIO()
            with contextlib.redirect_stdout(sbuf):
                rc = schema._main([trace + ".jsonl"])
            require(rc == 0, "launcher trace: schema check failed")
            log(f"  trace: {sbuf.getvalue().strip()}")
        tail = [ln for ln in text.splitlines()
                if ln and ln[0] not in " {}"]
        log(f"  {name} ({' '.join(argv)}): {wall:.2f}s; completed {done}; "
            f"launches {ran}; {tail}")
        checked = _check_calls(torch, calls, name)
        if name == "paged_prefix_swap":
            # a planted fault: one output element of one recorded decode
            # launch moved by 10x the tolerance must fail the check
            k = want_k[0]
            args, kw, out = calls[k][-1]
            bad = out.clone()
            bad.view(-1)[0] += 10 * TOL["float32"] * (1 + bad.view(-1)[0]
                                                      .abs())
            try:
                _check_calls(torch, {k: [(args, kw, bad)]}, "planted")
            except Check:
                log(f"    planted fault (one {k} output element moved by "
                    f"10x the tolerance): caught")
            else:
                raise Check("launcher: the kernel-vs-plain check misses a "
                            "planted fault")
        for k, (n, err, shapes) in checked.items():
            log(f"    {k}: {n} launches within {TOL['float32']} of the "
                f"plain version, max abs {err:.3e}; q shapes {shapes}")
            row = res.setdefault(k, {"launches": {}, "max_abs_err": 0.0})
            row["launches"][name] = n
            row["max_abs_err"] = max(row["max_abs_err"], err)
        if path:
            # the same flags without --use-flash: the torch-op attention,
            # no kernel, the same tokens
            plain_argv = [trace + ".plain" if a == trace else a
                          for a in argv if a != "--use-flash"]
            ops.reset_launch_counts()
            peng, _, pwall = _launch(serve, plain_argv)
            require(not any(ops.launch_counts().values()),
                    f"launcher {name} without --use-flash launched "
                    f"{ops.launch_counts()}")
            got, want = _served_tokens(eng), _served_tokens(peng)
            for t in want:
                for i, (u, v) in enumerate(zip(got[t], want[t])):
                    require(u == v, f"launcher {name}: {t} request {i} "
                                    f"{u} with the kernels, {v} without")
            require(got.keys() == want.keys() and all(
                len(got[t]) == len(want[t]) for t in want),
                f"launcher {name}: requests differ with the kernels")
            log(f"    tokens of {sum(map(len, got.values()))} requests "
                f"equal to the run without --use-flash ({pwall:.2f}s)")
            del peng
        del eng
    return res


# ---------------------------------------------------------------------------
# phase 12: the MoE, MLA, encoder and vision families
# ---------------------------------------------------------------------------

# 12a: BE moonshot-v1-16b-a3b at the reference's config; cut to 4 slots (not
# in depth) should the peak pass 75 GiB
FAMILY_BE_SLOTS = 8
FAMILY_PEAK_GIB = 75
# 12b: one MoE layer, bf16, the batched layer against its per-expert plain
# version: the worst token's L2 error over the mean token norm. Both run
# bf16 GEMMs with f32 accumulation and round h and the expert output to
# bf16 (2^-9 relative each); they differ only where the two GEMM shapes
# round differently, a few 2^-9 at most: 2^-6 leaves 4x over 2^-8. The
# same measure of either against the f32 layer is printed beside it.
MOE_REL_TOL = 2 ** -6
# 12c: deepseek-v2-236b's first dense layer and 3 MoE layers
MLA_LAYERS = 4
# 12d: forward against the decode_step loop, the reference's own
# tests/test_models_smoke.py tolerance (f32, TF32 off)
FAMILY_FWD_TOL = 2e-3
FAMILY_DECODE_STEPS = 16


def _free(torch):
    """Release what earlier parts left on the card and restart the peak."""
    import gc
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _peak_gib(torch):
    return torch.cuda.max_memory_allocated() / 2 ** 30


def _plain_on_card(fn, args, kw):
    """The plain version of one kernel call, on the card: the entry point
    ``fn`` of ``kernels.ops`` run down its CPU branch (the plain PyTorch
    version in ``kernels/ref.py``) on the same CUDA tensors. At the
    engine's full-width shapes the CPU could not keep up with every
    launch."""
    from repro_torch.kernels import ops
    on_cpu = ops._on_cpu
    ops._on_cpu = lambda t: True
    try:
        return fn(*args, **kw)
    finally:
        ops._on_cpu = on_cpu


def _head_rel(torch, g, w, Hkv):
    """Relative L2 error of an attention output ([B, (Sq,) H, D]) per
    (batch row, KV head): [B, Hkv]."""
    B, H, D = g.shape[0], g.shape[-2], g.shape[-1]

    def blocks(x):
        return x.reshape(B, -1, Hkv, H // Hkv * D).transpose(1, 2) \
            .reshape(B, Hkv, -1)
    dn, wn = (blocks(g) - blocks(w)).norm(dim=2), blocks(w).norm(dim=2)
    # a block the plain version leaves at exactly 0 (a free slot's row
    # over never-written pages) must be exactly 0 in the kernel too
    return torch.where(wn > 0, dn / wn.clamp_min(1e-30),
                       torch.where(dn > 0, float("inf"), 0.0))


def _call_err(torch, out, want, Hkv, what):
    """One launch's output against its plain version by relative L2 per
    (batch row, KV head) within LATE_REL_TOL (phases 3 and 7's limits). A
    model's real activations are not TOL's N(0, 1) inputs: the
    reference's init scales wq/wk by the head count's fan-in, so scores
    reach ~150 at whisper-small's heads and values ~25, and f32 rounding
    of such scores alone moves an output element by ~1e-4, and bf16's
    rounding of P by 0.25-0.5 at moonshot's. A progress tensor must be
    equal. Returns (max abs error, worst relative L2)."""
    got, want = ((out, want) if isinstance(out, tuple)
                 else ((out,), (want,)))
    g, w = got[0].float(), want[0].float()
    dname = str(got[0].dtype).split(".")[-1]
    err = (g - w).abs().max().item()
    rel = _head_rel(torch, g, w, Hkv).max().item()
    require(rel <= LATE_REL_TOL[dname],
            f"{what}: relative L2 {rel} per (row, KV head) over "
            f"{LATE_REL_TOL[dname]} against its plain version (max abs "
            f"{err})")
    for a, b in zip(got[1:], want[1:]):
        require(torch.equal(a, b), f"{what}: progress {a.tolist()} != "
                                   f"{b.tolist()}")
    return err, rel


def _check_at_call(torch, names, stats, keep=()):
    """Wrap ``ops.<name>`` for each of ``names``: every call copies its
    inputs at the call, launches the kernel, and holds the output against
    the plain version on those copies on the card, within TOL
    (``_call_err``). ``stats[name]`` collects the calls, the worst error
    and the q shapes seen; ``stats["_last"]`` keeps the last call of each
    kernel (copies) for the planted fault, and ``stats["_kept"][i]`` the
    calls of index i in ``keep`` (counted from 0 over ``names``). Returns
    the function that unwraps."""
    from repro_torch.kernels import ops
    orig = {n: getattr(ops, n) for n in names}
    stats.setdefault("_n", 0)

    def wrap(name, fn):
        def call(*args, **kw):
            kept = _tensors((args, kw), lambda t: t.detach().clone())
            out = fn(*args, **kw)
            want = _plain_on_card(fn, *kept)
            err, rel = _call_err(torch, out, want, args[1].shape[1],
                                 f"{name} at q {tuple(args[0].shape)}")
            st = stats.setdefault(name, {"calls": 0, "max_abs_err": 0.0,
                                         "rel": 0.0, "q": set()})
            st["calls"] += 1
            st["max_abs_err"] = max(st["max_abs_err"], err)
            st["rel"] = max(st["rel"], rel)
            st["q"].add(tuple(args[0].shape))
            rec = (fn, kept, _tensors(out, lambda t: t.detach().clone()))
            stats.setdefault("_last", {})[name] = rec
            if stats["_n"] in keep:
                stats.setdefault("_kept", {})[stats["_n"]] = rec
            stats["_n"] += 1
            return out
        return call
    for n, fn in orig.items():
        setattr(ops, n, wrap(n, fn))

    def undo():
        for n, fn in orig.items():
            setattr(ops, n, fn)
    return undo


def _planted_call_fault(torch, stats, name):
    """One recorded output with its largest (batch row, KV head) block
    scaled by 1.1 (a wrong-scale fault) must fail ``_call_err``."""
    fn, (args, kw), out = stats["_last"][name]
    want = _plain_on_card(fn, args, kw)
    outs = list(out) if isinstance(out, tuple) else [out]
    Hkv = args[1].shape[1]
    bad = outs[0].clone()
    B, H, D = bad.shape[0], bad.shape[-2], bad.shape[-1]
    w = (want[0] if isinstance(want, tuple) else want).float()
    norms = w.reshape(B, -1, Hkv, H // Hkv * D).square().sum((1, 3))
    b, h = divmod(int(norms.argmax()), Hkv)
    G = H // Hkv
    bad.view(B, -1, H, D)[b, :, h * G:(h + 1) * G] *= 1.1
    outs[0] = bad
    try:
        _call_err(torch, tuple(outs) if isinstance(out, tuple) else bad,
                  want, Hkv, "planted")
    except Check:
        return
    raise Check(f"the kernel-vs-plain check misses a planted fault in "
                f"{name}")


def _moe_drops(into):
    """Wrap ``models.moe.moe_forward`` so each call's (tokens, S,
    dropped_frac) lands in ``into``, the fraction as a device tensor (no
    host sync). Returns the function that unwraps."""
    from repro_torch.models import moe
    orig = moe.moe_forward

    def call(p, x, cfg):
        y, aux = orig(p, x, cfg)
        into.append((x.shape[0] * x.shape[1], x.shape[1],
                     aux["dropped_frac"]))
        return y, aux
    moe.moe_forward = call

    def undo():
        moe.moe_forward = orig
    return undo


def _family_pair(torch, seed, *, be_slots, ls_params=None, be_params=None,
                 check=False, decode_ms=None, drops=None):
    """Phase 5's LS tenant (qwen3-1.7b, its seed) and BE moonshot-v1-16b-a3b
    at the reference's config (seed + 1) on one paged engine: page 16,
    max_seq 2048, chunk 256, 8 LS slots, ``be_slots`` BE slots,
    ``ResourcePlan(sm_be=0.3)``, the flash kernels; phase 5's LS prompts
    and 8 BE prompts of 512-1536 tokens, 32 new tokens each. ``check``
    holds every launch against its plain version at the call;
    ``decode_ms`` collects the wall ms of each BE decode step (synchronized
    after), ``drops`` each MoE layer call's dropped_frac. Returns (engine,
    requests, LS params, BE params, stats)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.tenancy import TenantSpec
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(max_seq=2048, paged=True, page_size=PAGE,
                        use_flash=True, chunk_size=256, slots_ls=8,
                        slots_be=be_slots, plan=_engine_plan(),
                        torch_device="cuda")
    t0 = time.perf_counter()
    ls = eng.add_tenant(TenantSpec("ls-qwen3", "LS"),
                        get_config("qwen3-1.7b"), params=ls_params, seed=seed)
    be = eng.add_tenant(TenantSpec("be-moonshot", "BE"),
                        get_config("moonshot-v1-16b-a3b"), params=be_params,
                        seed=seed + 1)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    if decode_ms is not None:
        inner = be.decode_fn

        def timed(*a, **kw):
            t = time.perf_counter()
            out = inner(*a, **kw)
            torch.cuda.synchronize()
            decode_ms.append(1e3 * (time.perf_counter() - t))
            return out
        be.decode_fn = timed
    rng = np.random.default_rng(seed + 7)           # phase 5's lengths
    ls_lens = [int(x) for x in rng.integers(128, 1025, 8)]
    be_lens = [int(x) for x in rng.integers(512, 1537, 8)]
    rng = np.random.default_rng(seed)               # phase 5's tokens
    reqs = [eng.submit("ls-qwen3", rng.integers(0, ls.cfg.vocab_size, L),
                       max_new=32) for L in ls_lens]
    reqs += [eng.submit("be-moonshot", rng.integers(0, be.cfg.vocab_size, L),
                        max_new=32) for L in be_lens]
    stats = {}
    undo = [_moe_drops(drops)] if drops is not None else []
    if check:
        undo.append(_check_at_call(torch, ("decode_attention_paged",
                                           "prefill_attention_paged"),
                                   stats))
    t0 = time.perf_counter()
    try:
        quanta = eng.run_until_idle()
        torch.cuda.synchronize()
    finally:
        for u in undo:
            u()
    stats["wall_s"] = time.perf_counter() - t0
    stats["setup_s"] = setup
    stats["quanta"] = quanta
    for r in reqs:
        require(not r.failed and r.output is not None
                and len(r.output) == 32,
                f"request {r.rid} ({r.tenant}, {len(r.tokens)} tokens): "
                f"{None if r.output is None else len(r.output)} tokens")
    return eng, reqs, ls.params, be.params, stats


def _profile_be_decode(torch, eng, rt, steps=3):
    """Where a BE decode step's time goes: ``steps`` batched decode steps of
    the tenant after its run, every slot at the engine's write sentinel
    (a free slot's row: the whole window read, nothing written), timed
    unprofiled, then profiled (device time by kernel name)."""
    from repro_torch.models import transformer as tf
    B = rt.n_slots
    tok = torch.zeros((B, 1), dtype=torch.int32, device="cuda")
    pos = torch.full((B,), eng.backend._write_sentinel(rt),
                     dtype=torch.int32, device="cuda")
    ctx = {"page_table": rt.kv.device_page_table()}

    def run():
        with torch.inference_mode():
            for _ in range(steps):
                tf.decode_step(rt.params, rt.cfg, tok, rt.cache, pos,
                               ctx_extra=ctx, use_flash=True)
        torch.cuda.synchronize()
    run()
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    log(f"  {steps} BE decode steps at 8 sentinel rows: "
        f"{wall * 1e3 / steps:.1f} ms a step unprofiled")
    with _profiler(torch) as prof:
        run()
    _profile_summary(prof, wall, top=12)


def _pcts_line(c):
    return (f"TTFT p50/p99 {c['ttft']['p50_ms']:.1f}/"
            f"{c['ttft']['p99_ms']:.1f} ms, TBT p50/p99 "
            f"{c['tbt']['p50_ms']:.1f}/{c['tbt']['p99_ms']:.1f} ms, "
            f"{c['tokens_per_s']} tokens/s, {c['completed']} completed")


def family_engine_phase(torch, seed):
    """(a) LS qwen3-1.7b + BE moonshot-v1-16b-a3b at full width: a timed
    run, then the same run with every kernel launch held against its plain
    version at the call; tokens equal across the two. Returns the timed
    run's launches."""
    from repro_torch.kernels import ops
    from repro_torch.configs import get_config
    from repro_torch.serving.kv_cache import kv_bytes_per_token
    cfg = get_config("moonshot-v1-16b-a3b")
    slots = FAMILY_BE_SLOTS
    _free(torch)
    decode_ms, drops = [], []
    ops.reset_launch_counts()
    eng, reqs, ls_p, be_p, st = _family_pair(
        torch, seed, be_slots=slots, decode_ms=decode_ms, drops=drops)
    counts, routes = ops.launch_counts(), ops.route_counts()
    peak = _peak_gib(torch)
    n_params = sum(t.numel() for t in _leaves(be_p))
    log(f"  BE moonshot-v1-16b-a3b: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}x{cfg.head_dim} heads, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, "
        f"{cfg.moe.num_shared_experts} shared, expert width "
        f"{cfg.moe.d_ff_expert}, vocab {cfg.vocab_size}: {n_params:,} "
        f"parameters ({n_params * 2 / 1e9:.1f} GB bf16); KV "
        f"{kv_bytes_per_token(cfg)} B a token; {slots} BE slots")
    log(f"  tenants ready in {st['setup_s']:.1f}s; run: {st['quanta']} "
        f"quanta in {st['wall_s']:.2f}s; peak "
        f"max_memory_allocated {peak:.2f} GiB")
    require(peak <= FAMILY_PEAK_GIB or slots == 4,
            f"peak {peak:.1f} GiB over {FAMILY_PEAK_GIB}: cut BE to 4 slots")
    m = eng.metrics()
    for c in ("LS", "BE"):
        log(f"  {c}: " + _pcts_line(m["_class"][c]))
    quanta = {"LS": 0, "BE": 0}
    for _, _, pri in eng.events:
        quanta[pri] += 1
    log(f"  quanta by class {quanta}; launches {counts}; prefill routes "
        f"{routes['prefill_attention_paged']}")
    require(counts["decode_attention_paged"] > 0
            and counts["prefill_attention_paged"] > 0,
            f"paged kernels not launched: {counts}")
    require(routes["prefill_attention_paged"] == {
        "wgmma": counts["prefill_attention_paged"], "simt": 0},
        f"prefill routes {routes['prefill_attention_paged']}")
    n_moe = cfg.num_layers - cfg.n_prefix
    require(len(drops) % n_moe == 0, f"{len(drops)} MoE calls")
    per_call = [(drops[i][0], drops[i][1],
                 float(sum(d[2] for d in drops[i:i + n_moe])) / n_moe)
                for i in range(0, len(drops), n_moe)]
    pre = [f"{S}:{f:.4f}" for T, S, f in per_call if S > 1]
    log(f"  MoE dropped_frac, mean over the {n_moe} MoE layers, per "
        f"prefill call (chunk length:fraction; {len(pre)} calls of "
        f"{per_call[0][0] // per_call[0][1]} rows): {' '.join(pre)}; "
        f"decode calls: max "
        f"{max(f for T, S, f in per_call if S == 1):.4f}")
    bd = sorted(decode_ms)
    log(f"  BE decode step (wall, synchronized): {len(bd)} steps, p50 "
        f"{_p50(bd):.1f} ms, max {bd[-1]:.1f} ms")
    _profile_be_decode(torch, eng, eng.tenants["be-moonshot"])
    toks = _outputs(reqs)
    del eng, reqs
    # the same run, every launch held against its plain version
    _free(torch)
    ops.reset_launch_counts()
    eng, reqs, _, _, cst = _family_pair(torch, seed, be_slots=slots,
                                        ls_params=ls_p, be_params=be_p,
                                        check=True)
    require(ops.launch_counts() == counts,
            f"checked run launched {ops.launch_counts()}, timed {counts}")
    require(_outputs(reqs) == toks, "checked run's tokens differ from the "
                                    "timed run's")
    for name in ("decode_attention_paged", "prefill_attention_paged"):
        s = cst[name]
        require(s["calls"] == counts[name],
                f"{name}: {s['calls']} checked, {counts[name]} launched")
        _planted_call_fault(torch, cst, name)
        log(f"  {name}: {s['calls']} launches each within relative L2 "
            f"{LATE_REL_TOL['bfloat16']} per (row, KV head) of its plain "
            f"version on copies of its inputs: worst {s['rel']:.3e}, max "
            f"abs {s['max_abs_err']:.3e}; q shapes "
            f"{sorted(s['q'])[:4]}{'...' if len(s['q']) > 4 else ''}; a "
            f"planted fault (the largest (row, KV head) block scaled by "
            f"1.1) caught")
    log(f"  checked run: {cst['wall_s']:.2f}s, tokens equal to the timed "
        f"run's; peak {_peak_gib(torch):.2f} GiB")
    del eng, reqs, ls_p, be_p
    _free(torch)
    return {k: counts[k] for k in ("decode_attention_paged",
                                   "prefill_attention_paged")}


def _outputs(reqs):
    return [[int(t) for t in r.output] for r in reqs]


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def moe_layer_phase(torch, seed):
    """(b) one MoE layer at moonshot's width (64 experts top-6, 2 shared,
    expert width 1408), T = 8 rows x 256 tokens, bf16, capacity factor
    1.25: the batched layer against ``moe_forward_plain`` on the card.
    The tokens share one component (a residual stream's common part, a
    quarter of their own standard-normal one): it skews the random router
    as trained routers are skewed, so experts overflow (~10% of slots at
    seed 0); independent tokens alone load each expert ~192 +- 14 slots
    against a capacity of 240 and drop none."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.transformer import tree_map
    cfg = get_config("moonshot-v1-16b-a3b")
    _free(torch)
    # bf16 leaves, the router too: the engine holds it as the reference's
    # cast_tree gives it to the layer
    p = tree_map(lambda a: a.to(torch.bfloat16),
                 moe.init_moe(seed, "phase12b", cfg, torch.bfloat16, "cuda"))
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((8, 256, cfg.d_model), generator=g, device="cuda")
         + 0.25 * torch.randn((cfg.d_model,), generator=g, device="cuda")) \
        .to(torch.bfloat16)
    T = x.shape[0] * x.shape[1]
    y, aux = moe.moe_forward(p, x, cfg)
    r = moe.route(p, x, cfg)
    yp, auxp, rp = moe.moe_forward_plain(p, x, cfg)
    require(torch.equal(r.idx, rp.idx) and torch.equal(r.keep, rp.keep)
            and torch.equal(r.pos, rp.pos),
            "batched routing differs from the plain version's")
    # f32 gates: a sum of six probabilities in another order
    gerr = (r.gates - rp.gates).abs().max().item()
    require(gerr <= 1e-6, f"gates off the plain version's by {gerr}")
    n_drop = int((~r.keep).sum())
    require(n_drop > 0, "no slot dropped at capacity factor 1.25")
    require(abs(float(aux["dropped_frac"]) - float(auxp["dropped_frac"]))
            <= 1e-6, "dropped_frac differs")

    def rel(a, b):
        a, b = a.float().reshape(T, -1), b.float().reshape(T, -1)
        return ((a - b).norm(dim=1).max() / b.norm(dim=1).mean()).item()
    err = rel(y, yp)
    # the f32 rounding scale: the plain layer in f32 on the same values
    p32 = tree_map(lambda a: a.float(), p)
    y32, _, _ = moe.moe_forward_plain(p32, x.float(), cfg, routing=rp)
    log(f"  T {T}, capacity {r.C}, {n_drop} of {r.keep.numel()} slots "
        f"dropped (dropped_frac {float(aux['dropped_frac']):.4f}); top-k "
        f"indices, positions and keep masks equal to the plain version's "
        f"(argmax rounds, a per-expert loop), gates within {gerr:.1e}")
    log(f"  output vs plain, worst token's L2 error / mean token norm "
        f"{err:.3e} (limit "
        f"{MOE_REL_TOL:.3e}); bf16 vs the f32 layer: batched "
        f"{rel(y, y32):.3e}, plain {rel(yp, y32):.3e}")
    require(err <= MOE_REL_TOL, f"MoE layer off its plain version: {err}")
    kept = torch.nonzero(rp.keep)[:, 0]
    slot = int(kept[rp.gates[kept].argmax()])
    bad = rp._replace(gates=rp.gates.clone().index_fill_(
        0, torch.tensor([slot], device="cuda"), 0.0))
    yb, _, _ = moe.moe_forward_plain(p, x, cfg, routing=bad)
    ferr = rel(y, yb)
    require(ferr > MOE_REL_TOL, f"planted fault reads {ferr}")
    log(f"  planted fault (kept slot {slot}'s gate "
        f"{float(rp.gates[slot]):.3f} zeroed): rel L2 {ferr:.3e}, caught")
    ms = cuda_ms(lambda: moe.moe_forward(p, x, cfg), iters=5, warmup=1)
    pms = cuda_ms(lambda: moe.moe_forward_plain(p, x, cfg), iters=3,
                  warmup=1)
    log(f"  moe_forward {ms:.2f} ms, moe_forward_plain {pms:.2f} ms "
        f"(device, back to back); peak {_peak_gib(torch):.2f} GiB")
    del p, p32, x
    _free(torch)


def mla_phase(torch, seed):
    """(c) deepseek-v2-236b at full width, MLA_LAYERS deep, served as LS
    alone, paged then dense with the same weights: tokens bit-equal, no
    kernel launched, the latent pool's bytes a token a layer."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.tenancy import TenantSpec
    from repro_torch.kernels import ops
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.kv_cache import kv_bytes_per_token
    cfg = get_config("deepseek-v2-236b").replace(num_layers=MLA_LAYERS)
    m = cfg.mla
    _free(torch)
    rng = np.random.default_rng(seed + 17)
    lens = [int(x) for x in rng.integers(128, 1025, 4)]
    prompts = [rng.integers(0, cfg.vocab_size, L) for L in lens]
    outs, params = {}, None
    for paged in (True, False):
        eng = ServingEngine(max_seq=2048, paged=paged, page_size=PAGE,
                            use_flash=True, chunk_size=256, slots_ls=4,
                            torch_device="cuda")
        t0 = time.perf_counter()
        ls = eng.add_tenant(TenantSpec("ls-deepseek", "LS"), cfg,
                            params=params, seed=seed + 3)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        if params is None:
            params = ls.params
            n = sum(t.numel() for t in _leaves(params))
            log(f"  deepseek-v2-236b, {cfg.num_layers} of 60 layers (1 "
                f"dense + {cfg.num_layers - 1} MoE), d_model {cfg.d_model}"
                f", {cfg.num_heads} heads, kv_lora {m.kv_lora_rank}, rope "
                f"{m.qk_rope_head_dim}, {cfg.moe.num_experts} experts "
                f"top-{cfg.moe.top_k}: {n:,} parameters "
                f"({n * 2 / 1e9:.1f} GB bf16); prompts {lens}")
        if paged:
            per = kv_bytes_per_token(cfg) // cfg.num_layers
            want = (m.kv_lora_rank + m.qk_rope_head_dim) * 2
            pool = sum(t.numel() * t.element_size()
                       for t in _leaves(ls.cache))
            tok = ls.kv.n_pages * PAGE * cfg.num_layers
            require(per == want and pool == want * tok,
                    f"latent pool {pool} B for {tok} token-layers, "
                    f"kv_bytes_per_token/layer {per}; want {want}")
            log(f"  latent pool: {pool:,} B = {ls.kv.n_pages} pages x "
                f"{PAGE} x {cfg.num_layers} layers x {want} B "
                f"((512 + 64) x 2)")
        reqs = [eng.submit("ls-deepseek", p, max_new=16) for p in prompts]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        n = eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = {k: v for k, v in ops.launch_counts().items() if v}
        require(not launched, f"MLA launched kernels {launched}")
        for r in reqs:
            require(not r.failed and r.output is not None
                    and len(r.output) == 16, f"request {r.rid} failed")
        outs[paged] = _outputs(reqs)
        c = eng.metrics()["_class"]["LS"]
        log(f"  {'paged' if paged else 'dense'}: set-up {setup:.1f}s, "
            f"{n} quanta in {wall:.2f}s, no kernel launched; "
            + _pcts_line(c) + f"; peak {_peak_gib(torch):.2f} GiB")
        del eng, ls, reqs
    require(outs[True] == outs[False],
            "deepseek tokens differ between paged and dense")
    log(f"  tokens of {len(prompts)} requests bit-equal, paged and dense")
    del params
    _free(torch)


def _decode_loop(torch, params, cfg, batch, ctx, stats):
    """``decode_step(use_flash=True)`` over the batch's tokens from an empty
    dense cache, every decode_attention launch held against its plain
    version at the call (``_check_at_call``, into ``stats``). Returns
    (logits [B, S, V], launches)."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tf
    S = batch["tokens"].shape[1]
    cache = tf.init_cache(cfg, batch["tokens"].shape[0], S, device="cuda")
    undo = _check_at_call(torch, ("decode_attention",), stats)
    ops.reset_launch_counts()
    try:
        steps = []
        for t in range(S):
            logits, cache = tf.decode_step(
                params, cfg, batch["tokens"][:, t:t + 1], cache,
                torch.tensor(t, device="cuda"), ctx_extra=ctx,
                use_flash=True)
            steps.append(logits[:, 0])
    finally:
        undo()
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    n_attn = sum(1 for k in cfg.pattern if k == "global")
    require(launched == {"decode_attention": n_attn * S},
            f"{cfg.name}: launched {launched}, want {n_attn * S} "
            "decode_attention")
    return torch.stack(steps, 1), n_attn * S


def _first_layers(tf, params, cfg):
    """The checked cut: the first global layer and, for the VLM, its first
    cross layer (pattern ("global", "cross")); whisper's first decoder
    layer comes with its first cross block over the whole encoder."""
    slots = [0] + ([cfg.layer_pattern.index("cross")]
                   if "cross" in cfg.layer_pattern else [])
    p = dict(params, layers={f"s{i}": tf.tree_map(
        lambda a: a[:1], params["layers"][f"s{j}"])
        for i, j in enumerate(slots)})
    if "cross" in params:
        p["cross"] = tf.tree_map(lambda a: a[:1], params["cross"])
    pattern = tuple(cfg.layer_pattern[j] for j in slots)
    return p, cfg.replace(num_layers=len(slots), layer_pattern=pattern)


def context_phase(torch, seed):
    """(d) whisper-small whole (12 + 12 layers) and llama-3.2-vision-90b at
    published width, one period (4 global + 1 cross layer), both f32:
    ``forward`` against the ``decode_step(use_flash=True)`` loop, each
    dense decode_attention launch held against its plain version at the
    call. The checked cut (``_first_layers``: whisper's first decoder
    layer with its cross block over the whole encoder, llama's first
    global layer and its first cross layer over the image features)
    within FAMILY_FWD_TOL. The whole decoder is a smoke of finite logits
    only: a random-weight stack amplifies rounding past any fixed limit
    (the reference's init scales wq/wk by the head count's fan-in, so
    scores reach 100-1000 and the softmax is near-argmax; whisper-small's
    logits move by ~3 under a 1e-6 change of its embedding, the
    reference's too), so its distance from ``forward`` is printed, not
    held. Returns the launches by model."""
    from repro_torch.configs import get_config
    from repro_torch.models import io, transformer as tf
    out = {}
    for name, layers in (("whisper-small", None),
                         ("llama-3.2-vision-90b", 5)):
        _free(torch)
        cfg = get_config(name).replace(activation_dtype="float32")
        if layers:
            cfg = cfg.replace(num_layers=layers)
        t0 = time.perf_counter()
        params = tf.init_params(cfg, seed + 5, "cuda", torch.float32)
        for slot in params["layers"].values():
            if "gate" in slot["attn"]:
                slot["attn"]["gate"].fill_(0.5)   # tanh(0) would hide it
        g = torch.Generator(device="cuda").manual_seed(seed)
        batch = io.make_batch(cfg, 1, FAMILY_DECODE_STEPS, g,
                              with_labels=False)
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        ctx = tf._context(params, cfg, batch)
        n_launch = 0
        H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        for checked, (p, c) in ((True, _first_layers(tf, params, cfg)),
                                (False, (params, cfg))):
            full, _ = tf.forward(p, c, batch)
            stats = {}
            dec, n = _decode_loop(torch, p, c, batch, ctx, stats)
            n_launch += n
            st = stats["decode_attention"]
            require(st["calls"] == n, f"{st['calls']} of {n} checked")
            _planted_call_fault(torch, stats, "decode_attention")
            err = (dec - full).abs().max().item()
            require(bool(torch.isfinite(dec).all())
                    and dec.shape == full.shape,
                    f"{name}, {c.pattern}: decode_step logits not finite")
            if checked:
                require(err <= FAMILY_FWD_TOL,
                        f"{name}, {c.pattern}: decode_step loop off "
                        f"forward by {err} (limit {FAMILY_FWD_TOL})")
            what = c.pattern if checked else c.num_layers
            log(f"  {name}, decoder layers {what}"
                + (f" + {cfg.encoder.num_layers} encoder over "
                   f"{cfg.encoder.num_frames} frames" if cfg.encoder else
                   f", {cfg.vision.num_tokens} image tokens of "
                   f"{cfg.vision.vision_dim}")
                + f", f32: forward vs {FAMILY_DECODE_STEPS} decode steps "
                f"max abs {err:.2e} "
                + (f"(limit {FAMILY_FWD_TOL}, the reference's)" if checked
                   else "(finite; not held: the random-weight stack "
                        "amplifies rounding)")
                + f"; {n} decode_attention launches at H {H} Hkv {Hkv} D "
                f"{D}, each within relative L2 {LATE_REL_TOL['float32']} "
                f"per (row, KV head) of its plain version: worst "
                f"{st['rel']:.2e}, max abs {st['max_abs_err']:.2e}; a "
                f"planted fault caught")
            del full, dec, stats
        log(f"  {name}: set-up {setup:.1f}s; peak {_peak_gib(torch):.2f} "
            "GiB")
        out[name] = n_launch
        del params, ctx, batch
    _free(torch)
    return out


def families_phase(torch, seed):
    """Phase 12, (a)-(d). Returns (launches of (a) by kernel, (d)'s
    decode_attention launches by model)."""
    t0 = time.perf_counter()
    log("  -- (a) LS qwen3-1.7b + BE moonshot-v1-16b-a3b, paged, flash")
    pair = family_engine_phase(torch, seed)
    log("  -- (b) one MoE layer at moonshot's width vs moe_forward_plain")
    moe_layer_phase(torch, seed)
    log("  -- (c) deepseek-v2-236b MLA, LS alone, paged then dense")
    mla_phase(torch, seed)
    log("  -- (d) whisper-small and llama-3.2-vision-90b, forward vs decode")
    ctx = context_phase(torch, seed)
    log(f"  phase 12 wall {time.perf_counter() - t0:.1f}s")
    return pair, ctx


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 13: channel reverse engineering and the MLP hash fit
# ---------------------------------------------------------------------------

# the paper's sample count (§5.2: ~15K probed addresses) over a 64 MiB
# space of rtx-a2000's 1 KiB hash pages; the fit at the reference's
# defaults (9 layers of 256, 3000 Adam steps of 1024 addresses)
RE_SPACE, RE_SAMPLES = 64 << 20, 15_000
FIT_ACC = 0.95


def coloring_phase(torch, seed):
    """Phase 13: Algo 1-3 and the granularity probe on the simulated
    rtx-a2000 (host numpy), then ``fit_channel_hash`` on the card on the
    probed (address, cluster label) samples; its held-out accuracy on
    every page of the space it did not see, labels mapped to channels by
    the samples' majority."""
    import numpy as np
    from repro_torch.core.coloring import (VRAMDevice, collect_samples,
                                           fit_channel_hash, gpu_hash_model,
                                           measure_granularity)
    t0 = time.perf_counter()
    hm = gpu_hash_model("rtx-a2000")
    dev = VRAMDevice(hm, seed=seed + 1)
    res = collect_samples(dev, RE_SPACE, RE_SAMPLES, seed=seed)
    gran = measure_granularity(dev)
    t_probe = time.perf_counter() - t0
    n_unlabelled = int((res.labels < 0).sum())
    log(f"  probes (host): {RE_SAMPLES} addresses of {RE_SPACE >> 20} MiB, "
        f"{res.num_channels_found} channels found (true {hm.num_channels}), "
        f"label accuracy {res.label_accuracy:.4f}, {n_unlabelled} "
        f"unlabelled, granularity {gran} B, {dev.reads} timed reads in "
        f"{t_probe:.1f}s")
    require(res.num_channels_found == hm.num_channels,
            f"found {res.num_channels_found} channels")
    require(res.label_accuracy > 0.97, f"label accuracy {res.label_accuracy}")
    require(gran == 2048, f"granularity {gran}")      # A2000: 2 KiB runs
    ok = res.labels >= 0
    addrs, labels = res.addrs[ok], res.labels[ok]
    require(len(addrs) >= RE_SAMPLES - 100, f"{len(addrs)} labelled")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fit = fit_channel_hash(addrs, labels, hm.granularity,
                           res.num_channels_found, seed=seed, device="cuda")
    torch.cuda.synchronize()
    t_fit = time.perf_counter() - t1
    to_channel = {}
    for lab in np.unique(labels):
        vals, counts = np.unique(res.true_channels[ok][labels == lab],
                                 return_counts=True)
        to_channel[int(lab)] = int(vals[counts.argmax()])
    held = np.setdiff1d(np.arange(RE_SPACE // hm.granularity,
                                  dtype=np.int64) * hm.granularity, addrs)
    pred = np.vectorize(to_channel.get)(fit.predict(held))
    agree = float(np.mean(pred == hm.channel_of(held)))
    log(f"  fit on {torch.cuda.get_device_name(0)}: {len(addrs)} labelled "
        f"addresses, 3000 steps in {t_fit:.2f}s ({3000 / t_fit:.0f} "
        f"steps/s); train acc {fit.train_acc:.4f}, test acc "
        f"{fit.test_acc:.4f}, held-out agreement with the hash "
        f"{agree:.4f} over {len(held)} pages (limit {FIT_ACC})")
    require(fit.test_acc > FIT_ACC, f"MLP test acc {fit.test_acc}")
    require(agree >= FIT_ACC, f"held-out agreement {agree}")
    del fit
    _free(torch)
    log(f"  phase 13 wall {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# phase 14: long-sequence forward (query-blocked attention)
# ---------------------------------------------------------------------------

LONG_S, LONG_CHUNK = 32_768, 1024
LONG_PEAK_GIB = 24.0


def _chunked_prefill(torch, params, cfg, toks):
    """``toks`` [1, LONG_S] through paged ``prefill_step`` in chunks of
    LONG_CHUNK with use_flash, one page table over the whole pool. Returns
    the last position's logits [1, V] in f32."""
    from repro_torch.models import transformer as tf
    n_pages = LONG_S // PAGE
    pools = tf.init_paged_cache(cfg, n_pages, PAGE, device="cuda")
    pt = torch.arange(n_pages, dtype=torch.int32, device="cuda")[None]
    with torch.inference_mode():
        for pos in range(0, LONG_S, LONG_CHUNK):
            lp, pools = tf.prefill_step(
                params, cfg, toks[:, pos:pos + LONG_CHUNK], pools,
                torch.tensor([pos], dtype=torch.int32, device="cuda"),
                ctx_extra={"page_table": pt}, use_flash=True)
    return lp[:, 0].float()


def _planted_pages(torch, rec, dst, src):
    """The plain version of the recorded prefill_attention_paged call
    ``rec`` with page-table entries ``dst`` read from entries ``src`` (a
    kernel that misreads those pages), against the sound plain version:
    its worst relative L2 per (row, KV head)."""
    fn, (args, kw), _ = rec
    want = _plain_on_card(fn, args, kw)
    pt = args[3].clone()
    pt[:, dst] = args[3][:, src]
    bad = _plain_on_card(fn, (*args[:3], pt, *args[4:]), kw)
    return _head_rel(torch, bad.float(), want.float(),
                     args[1].shape[1]).max().item()


def _blocked_modes(torch, seed):
    """One layer's ``blocked_attention`` at qwen3-1.7b's heads, S LONG_S,
    bf16, causal, in both of its modes: recorded (inputs that require
    grad, grad on; what autograd would keep for the backward pass is
    dropped by a saved-tensors hook, so the peak is the forward's own
    buffers) and lean (no grad). The outputs must be bit-equal; each
    peak above the inputs and wall is printed."""
    from repro_torch.models import attention as attn
    H, Hkv, D = HEADS["qwen3-1.7b"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 141)
    q, k, v = (torch.randn(1, LONG_S, h, D, generator=gen, device="cuda",
                           dtype=torch.bfloat16) for h in (H, Hkv, Hkv))
    out, res = {}, {}
    for mode in ("recorded", "lean"):
        _free(torch)
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        if mode == "recorded":
            with torch.enable_grad(), \
                    torch.autograd.graph.saved_tensors_hooks(
                        lambda x: None, lambda x: x):
                o = attn.blocked_attention(
                    *(x.detach().requires_grad_(True) for x in (q, k, v)))
            require(o.grad_fn is not None, "the recorded path recorded "
                                           "nothing")
        else:
            with torch.no_grad():
                o = attn.blocked_attention(q, k, v)
        torch.cuda.synchronize()
        res[mode] = ((torch.cuda.max_memory_allocated() - base) / 2 ** 30,
                     time.perf_counter() - t)
        out[mode] = o.detach()
        del o
    same = torch.equal(out["recorded"], out["lean"])
    log(f"  one layer's blocked attention, H {H}, Hkv {Hkv}, D {D}, S "
        f"{LONG_S}, bf16, causal: peak above its inputs recorded "
        f"{res['recorded'][0]:.3f} GiB ({res['recorded'][1]:.2f}s; saved "
        f"tensors dropped), lean {res['lean'][0]:.3f} GiB "
        f"({res['lean'][1]:.2f}s); outputs bit-equal {same}")
    require(same, "lean blocked attention differs from the recorded path")
    del q, k, v, out
    _free(torch)


def long_seq_phase(torch, seed):
    """Phase 14: qwen3-1.7b at full width, bf16, B 1, S 32768 (the
    reference's prefill_32k): ``forward(last_only=True)`` on the blocked
    path, then the same tokens through paged ``prefill_step`` in chunks of
    LONG_CHUNK with use_flash (``prefill_attention_paged``), timed, then
    again with every launch held against its plain version at the call.
    Returns the timed chunked run's launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tf
    t0 = time.perf_counter()
    cfg = get_config("qwen3-1.7b")
    _free(torch)
    params = tf.init_params(cfg, seed, "cuda", dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(seed + 14)
    toks = torch.randint(0, cfg.vocab_size, (1, LONG_S), generator=gen,
                         device="cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    require(LONG_S > attn.BLOCKED_THRESHOLD, "S below the threshold")
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    with torch.inference_mode():
        lf, _ = tf.forward(params, cfg, {"tokens": toks}, last_only=True)
    torch.cuda.synchronize()
    t_fwd = time.perf_counter() - t1
    peak = _peak_gib(torch)
    fwd_launches = sum(ops.launch_counts().values())
    lf = lf[:, 0].float()
    log(f"  forward(last_only) S {LONG_S}: {t_fwd:.2f}s, peak "
        f"{peak:.2f} GiB ({base:.2f} GiB weights and tokens; limit "
        f"{LONG_PEAK_GIB}), no kernel launched ({fwd_launches})")
    require(peak < LONG_PEAK_GIB, f"blocked forward peak {peak:.2f} GiB")
    require(fwd_launches == 0, "the forward launched a kernel")
    require(bool(torch.isfinite(lf).all()), "forward logits not finite")
    _blocked_modes(torch, seed)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    lp = _chunked_prefill(torch, params, cfg, toks)
    torch.cuda.synchronize()
    t_pre = time.perf_counter() - t2
    launches = ops.launch_counts()["prefill_attention_paged"]
    routes = ops.route_counts()["prefill_attention_paged"]
    want = cfg.num_layers * (LONG_S // LONG_CHUNK)
    rel = ((lf - lp).norm() / lp.norm()).item()
    agree = bool((lf.argmax(-1) == lp.argmax(-1)).all())
    log(f"  chunked paged prefill_step x {LONG_S // LONG_CHUNK} (chunk "
        f"{LONG_CHUNK}, use_flash): {t_pre:.2f}s, "
        f"prefill_attention_paged launches {launches} (want {want}), routes "
        f"{routes}")
    log(f"  last-position logits blocked forward vs chunked flash prefill: "
        f"rel L2 {rel:.3e} (tol {MODEL_REL_TOL}), max abs "
        f"{(lf - lp).abs().max().item():.3e}, argmax equal {agree}")
    require(launches == want, f"{launches} prefill launches, want {want}")
    require(routes.get("wgmma", 0) == want, f"routes {routes}")
    require(rel <= MODEL_REL_TOL, f"long-sequence logits rel err {rel}")
    # the same chunked run, every launch held against its plain version;
    # the last chunk's launches of the first and the last layer kept
    name, stats = "prefill_attention_paged", {}
    first, last = launches - cfg.num_layers, launches - 1
    ops.reset_launch_counts()
    undo = _check_at_call(torch, (name,), stats, keep=(first, last))
    t3 = time.perf_counter()
    try:
        lc = _chunked_prefill(torch, params, cfg, toks)
        torch.cuda.synchronize()
    finally:
        undo()
    t_chk = time.perf_counter() - t3
    st = stats[name]
    require(ops.launch_counts()[name] == launches == st["calls"],
            f"checked run: {ops.launch_counts()[name]} launched, "
            f"{st['calls']} checked, timed run {launches}")
    same = torch.equal(lc, lp)
    log(f"  checked run ({t_chk:.2f}s, logits equal to the timed run's "
        f"{same}): {st['calls']} launches each within relative L2 "
        f"{LATE_REL_TOL['bfloat16']} per (row, KV head) of the plain "
        f"version on copies of their inputs: worst {st['rel']:.3e}, max abs "
        f"{st['max_abs_err']:.3e}")
    require(same, "checked run's logits differ from the timed run's")
    _planted_call_fault(torch, stats, name)
    # planted page faults on the last chunk (Skv LONG_S over the whole
    # table): the chunk's own pages read as those before them (a dropped
    # or misread tail), the table's second half read as its first
    P, tail = LONG_S // PAGE, LONG_CHUNK // PAGE
    faults = {"tail": (slice(P - tail, P), slice(P - 2 * tail, P - tail)),
              "half": (slice(P // 2, P), slice(0, P // 2))}
    read = {(layer, k): _planted_pages(torch, stats["_kept"][i], *f)
            for layer, i in ((0, first), (cfg.num_layers - 1, last))
            for k, f in faults.items()}
    log(f"  planted faults, the last launch's largest (row, KV head) block "
        f"x1.1: caught; on the last chunk (Skv {LONG_S}, {P} pages), its "
        f"own {tail} pages read as the {tail} before them: layer 0 "
        f"{read[0, 'tail']:.3e}, layer {cfg.num_layers - 1} "
        f"{read[cfg.num_layers - 1, 'tail']:.3e}; pages {P // 2}-{P - 1} "
        f"read as 0-{P // 2 - 1}: layer 0 {read[0, 'half']:.3e}, layer "
        f"{cfg.num_layers - 1} {read[cfg.num_layers - 1, 'half']:.3e} "
        f"(limit {LATE_REL_TOL['bfloat16']})")
    # a kernel fault reads in every layer's launches; layer 0 (values of
    # the embeddings, no common component yet) must show each
    for k in faults:
        require(read[0, k] > LATE_REL_TOL["bfloat16"],
                f"the kernel-vs-plain check misses a planted fault ({k}, "
                f"layer 0: {read[0, k]})")
    del params, toks, stats
    _free(torch)
    log(f"  phase 14 wall {time.perf_counter() - t0:.1f}s")
    return launches


# ---------------------------------------------------------------------------
# phase 15: training
# ---------------------------------------------------------------------------

TRAIN_SEQ, TRAIN_STEPS = 4096, 6      # train_4k's seq_len at batch 1
RESUME_STEPS, RESUME_AT = 16, 8
# one step on the card against the CPU: qwen3-1.7b at full width cut to
# CHECK_LAYERS layers, at CHECK_S tokens (blocked attention with a ragged
# last block of 256 rows), batch 1
CHECK_LAYERS, CHECK_S = 2, 2304
# f32 gradients, the card (TF32 off) against the CPU: summation order only,
# against a backward fault's O(1)
GRAD_F32_TOL = 1e-4
# remat "full" against "none", both bf16 on the card: the recomputed
# period runs the same kernels on the same inputs
REMAT_TOL = 1e-3
# AdamW on the same gradients, the card in place against the CPU:
# elementwise f32 on both sides
ADAMW_TOL = 1e-6


def _grads(torch, cfg, params, batch):
    """``loss_fn``'s loss and its gradients in flatten order, taken as the
    trainer's step takes them (autograd over every param leaf)."""
    from repro_torch.models import transformer as tf
    from repro_torch.train.tree import leaves, unflatten
    flat = [p.detach().clone().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss, _ = tf.loss_fn(unflatten(params, flat), cfg, batch)
        g = torch.autograd.grad(loss, flat, materialize_grads=True)
    return float(loss.detach()), [x.detach() for x in g]


def _worst_leaf(torch, got, want):
    """The worst relative L2 over the leaves of ``got`` against ``want``,
    on ``want``'s device (a leaf whose ``want`` is 0 reads 0 or inf)."""
    import math
    worst = 0.0
    for a, b in zip(got, want):
        d = (a.to(b.device).float() - b.float()).norm().item()
        n = b.float().norm().item()
        worst = max(worst, d / n if n > 0 else (0.0 if d == 0 else math.inf))
    return worst


def _train_step_check(torch, cfg, S, seed, dev="cuda"):
    """One training step of ``cfg`` (bf16 activations) at S tokens on
    ``dev`` against the CPU, from the same params and batch: f32
    gradients on ``dev`` against the CPU's within GRAD_F32_TOL; remat
    "full" against "none" in bf16 on ``dev`` within REMAT_TOL; bf16
    remat "full" against the CPU's f32 within MODEL_REL_TOL; AdamW in
    place on ``dev`` against the CPU on the CPU's gradients (params'
    update, m and v) within ADAMW_TOL. Returns the readings."""
    from repro_torch.models import transformer as tf
    from repro_torch.train import (AdamWConfig, DataConfig, adamw_update,
                                   device_batch, init_opt_state)
    from repro_torch.train.tree import leaves, unflatten
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=1,
                    seed=seed)
    p_cpu = tf.init_params(cfg, seed, "cpu")
    p_dev = unflatten(p_cpu, [p.to(dev) for p in leaves(p_cpu)])
    batch = device_batch(dc, 0, None, dev)
    f32 = cfg.replace(activation_dtype="float32", remat="none")
    l_cpu, g_cpu = _grads(torch, f32, p_cpu, device_batch(dc, 0, None, "cpu"))
    l_f32, g_f32 = _grads(torch, f32, p_dev, batch)
    l_full, g_full = _grads(torch, cfg.replace(remat="full"), p_dev, batch)
    l_none, g_none = _grads(torch, cfg.replace(remat="none"), p_dev, batch)
    r = {"loss_f32": abs(l_f32 - l_cpu) / abs(l_cpu),
         "grad_f32": _worst_leaf(torch, g_f32, g_cpu),
         "remat": _worst_leaf(torch, g_full, g_none),
         "loss_bf16": abs(l_full - l_cpu) / abs(l_cpu),
         "grad_bf16": _worst_leaf(torch, g_full, g_cpu)}
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    u_cpu, s_cpu, _ = adamw_update(opt, unflatten(p_cpu, g_cpu),
                                   init_opt_state(p_cpu), p_cpu)
    u_dev, s_dev, _ = adamw_update(
        opt, unflatten(p_dev, [g.to(dev) for g in g_cpu]),
        init_opt_state(p_dev), p_dev, donate=True)
    p0 = leaves(p_cpu)
    r["adamw"] = max(
        _worst_leaf(torch, [a.cpu() - b for a, b in zip(leaves(u_dev), p0)],
                    [a - b for a, b in zip(leaves(u_cpu), p0)]),
        _worst_leaf(torch, leaves(s_dev.m), leaves(s_cpu.m)),
        _worst_leaf(torch, leaves(s_dev.v), leaves(s_cpu.v)))
    for key, lim in (("loss_f32", GRAD_F32_TOL), ("grad_f32", GRAD_F32_TOL),
                     ("remat", REMAT_TOL), ("loss_bf16", MODEL_REL_TOL),
                     ("grad_bf16", MODEL_REL_TOL), ("adamw", ADAMW_TOL)):
        require(r[key] <= lim, f"training step check {key}: {r[key]} over "
                               f"{lim}")
    return r


def _nll_modes(torch, cfg, seed):
    """One step of ``cfg`` (full width) at TRAIN_SEQ x 1 through
    ``loss_fn`` and autograd (``_grads``), once with the whole-vocabulary
    NLL's plain version (``transformer._nll_terms_plain``: the logits cast
    to f32 whole) and once with the row-blocked ``_BlockedNll``, from the
    same params and batch: each peak ``max_memory_allocated``, the loss's
    relative gap and the worst leaf's gradient gap (within REMAT_TOL).
    The plain step's gradients wait on the host while the blocked step
    runs, so both peaks start from the same memory."""
    from repro_torch.models import transformer as tf
    from repro_torch.train import DataConfig, device_batch
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                    global_batch=1, seed=seed)
    params = tf.init_params(cfg, seed, "cuda")
    batch = device_batch(dc, 0, None, "cuda")
    blocked, res = tf._nll_terms, {}
    try:
        for mode, fn in (("plain", tf._nll_terms_plain),
                         ("blocked", blocked)):
            tf._nll_terms = fn
            _free(torch)
            base = torch.cuda.memory_allocated() / 2 ** 30
            t = time.perf_counter()
            loss, g = _grads(torch, cfg, params, batch)
            torch.cuda.synchronize()
            res[mode] = (loss, _peak_gib(torch), base,
                         time.perf_counter() - t)
            if mode == "plain":
                g_plain = [x.cpu() for x in g]
                del g
    finally:
        tf._nll_terms = blocked
    gap = _worst_leaf(torch, g_plain, g)
    rel = abs(res["blocked"][0] - res["plain"][0]) / abs(res["plain"][0])
    del g, g_plain, params
    _free(torch)
    log(f"  (a) the loss's NLL over qwen3-1.7b's {cfg.vocab_size} logits, "
        f"one step at S {TRAIN_SEQ} x 1 (remat {cfg.remat}): plain (f32 "
        f"logits whole) peak {res['plain'][1]:.2f} GiB "
        f"({res['plain'][3]:.2f}s), row-blocked peak "
        f"{res['blocked'][1]:.2f} GiB ({res['blocked'][3]:.2f}s), both "
        f"from {res['plain'][2]:.2f} GiB; loss rel gap {rel:.3e}, "
        f"worst-leaf grad rel L2 {gap:.3e} (tol {REMAT_TOL})")
    require(rel <= REMAT_TOL and gap <= REMAT_TOL,
            f"blocked NLL off the plain version: loss {rel}, grads {gap}")


# whisper-small's encoder self-attention: B 4 (phase 12d's batch), its
# 1500 frames, 12 heads of 64
ENC_B, ENC_S, ENC_H, ENC_D = 4, 1500, 12, 64


def _encoder_pv_check(torch, seed):
    """grouped_attention's softmax·V (``attention._SoftmaxPV``) at
    whisper-small's encoder shapes in bf16, non-causal, against the plain
    graph (``_softmax_pv_plain`` on the same scores): output and the
    gradients of q, k and v bit-equal on the card, and the bytes each
    keeps for the backward pass (allocated after the forward, less its
    output)."""
    from repro_torch.models import attention as attn
    gen = torch.Generator(device="cuda").manual_seed(seed + 151)
    q, k, v = (torch.randn(ENC_B, ENC_S, ENC_H, ENC_D, generator=gen,
                           device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    g = torch.randn(q.shape, generator=gen, device="cuda",
                    dtype=torch.bfloat16)

    def plain(q, k, v, mask):
        B, S, H, Dh = q.shape
        s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, S, H, 1, Dh)
                         .float(), k.float()) * (Dh ** -0.5)
        return attn._softmax_pv_plain(s, v, mask).reshape(B, S, H, Dh) \
            .to(q.dtype)

    res = {}
    for name, fn in (("plain", plain), ("helper", attn.grouped_attention)):
        _free(torch)
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        before = torch.cuda.memory_allocated()
        with torch.enable_grad():
            out = fn(*leaves, None)
            torch.cuda.synchronize()
            kept = (torch.cuda.memory_allocated() - before
                    - out.numel() * out.element_size())
            grads = torch.autograd.grad(out, leaves, g)
        res[name] = (out.detach(), [x.detach() for x in grads], kept)
        del out, grads, leaves
    same = torch.equal(res["plain"][0], res["helper"][0]) and all(
        torch.equal(a, b) for a, b in zip(res["plain"][1], res["helper"][1]))
    log(f"  (a) grouped attention's softmax·V at whisper-small's encoder "
        f"(B {ENC_B}, S {ENC_S}, H {ENC_H}, D {ENC_D}, bf16): kept for the "
        f"backward pass {res['helper'][2] / 2 ** 20:.1f} MiB against the "
        f"plain graph's {res['plain'][2] / 2 ** 20:.1f} MiB; output and "
        f"q/k/v gradients bit-equal {same}")
    require(same, "softmax·V helper differs from the plain graph")
    require(res["helper"][2] < res["plain"][2],
            "softmax·V helper keeps no less than the plain graph")
    del res, q, k, v, g
    _free(torch)


def train_phase(torch, seed, smi):
    """Phase 15: (a) one step of qwen3-1.7b at full width cut to
    CHECK_LAYERS layers on the card against the CPU
    (``_train_step_check``), then qwen3-1.7b at full width, f32 params,
    bf16 activations, remat "full", S 4096, batch 1 (train_4k cut from 256
    rows), TRAIN_STEPS ``Trainer`` steps; (b) the launcher
    ``repro_torch.launch.train.main`` on the smoke config, interrupted at
    RESUME_AT and resumed, against an uninterrupted run."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.train import (AdamWConfig, DataConfig, Trainer,
                                   TrainerConfig, device_batch)
    t0 = time.perf_counter()
    _free(torch)
    cfg = get_config("qwen3-1.7b").replace(remat="full")
    t1 = time.perf_counter()
    r = _train_step_check(torch, cfg.replace(num_layers=CHECK_LAYERS),
                          CHECK_S, seed)
    log(f"  (a) one step of qwen3-1.7b at full width, {CHECK_LAYERS} "
        f"layers, S {CHECK_S}, on the card against the CPU "
        f"({time.perf_counter() - t1:.1f}s): f32 loss rel "
        f"{r['loss_f32']:.3e}, worst-leaf grad rel L2 {r['grad_f32']:.3e} "
        f"(tol {GRAD_F32_TOL}); bf16 remat full vs none {r['remat']:.3e} "
        f"(tol {REMAT_TOL}); bf16 remat full vs the CPU's f32: loss rel "
        f"{r['loss_bf16']:.3e}, grads {r['grad_bf16']:.3e} (tol "
        f"{MODEL_REL_TOL}); AdamW in place vs the CPU on the same grads "
        f"{r['adamw']:.3e} (tol {ADAMW_TOL})")
    _free(torch)
    _nll_modes(torch, cfg, seed)
    _encoder_pv_check(torch, seed)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                    global_batch=1, seed=seed)
    tr = Trainer(cfg, dc, AdamWConfig(lr=1e-4, warmup_steps=2,
                                      total_steps=TRAIN_STEPS),
                 TrainerConfig(steps=TRAIN_STEPS), seed=seed, device="cuda")
    n_params = sum(p.numel() for p in _leaves(tr.params))
    with torch.no_grad():
        l0, _ = tf.loss_fn(tr.params, cfg, device_batch(dc, 0, None,
                                                        "cuda"))
    l0 = float(l0)
    grad_norms = []
    step_fn = tr._step_fn

    def recorded(*a):
        out = step_fn(*a)
        grad_norms.append(float(out[3]["grad_norm"]))
        return out
    tr._step_fn = recorded
    torch.cuda.reset_peak_memory_stats()
    hist = tr.run()
    peak = _peak_gib(torch)
    losses = [h["loss"] for h in hist]
    ms = [h["time_s"] * 1e3 for h in hist]
    steady = sorted(ms[1:])[len(ms[1:]) // 2]
    log(f"  (a) qwen3-1.7b {n_params / 1e9:.3f} B params f32, bf16 "
        f"activations, remat full, S {TRAIN_SEQ} x 1: losses "
        f"{[round(x, 4) for x in losses]}, grad norms "
        f"{[round(x, 3) for x in grad_norms]}")
    log(f"  step ms {[round(x, 1) for x in ms]} (first with warm-up); "
        f"median of steps 1-{TRAIN_STEPS - 1} {steady:.1f} ms, "
        f"{TRAIN_SEQ / steady * 1e3:.0f} tokens/s; peak {peak:.2f} GiB; "
        f"{smi}")
    require(all(math.isfinite(x) for x in losses + grad_norms),
            "non-finite loss or grad norm")
    rel = abs(losses[0] - l0) / abs(l0)
    log(f"  step 0 loss {losses[0]:.6f} vs a separate loss_fn "
        f"{l0:.6f}: rel {rel:.3e} (tol {MODEL_REL_TOL})")
    require(rel <= MODEL_REL_TOL, f"step 0 loss off loss_fn by {rel}")
    # one more step under the profiler: device time by kernel against the
    # unprofiled steps' median wall
    with _profiler(torch) as prof:
        tr.run(TRAIN_STEPS + 1)
    _profile_summary(prof, steady / 1e3, top=12)
    del tr, step_fn, recorded, prof
    _free(torch)
    log("  -- (b) python -m repro_torch.launch.train --arch qwen3-1.7b "
        f"--smoke --steps {RESUME_STEPS}, interrupted at {RESUME_AT} and "
        "resumed")
    full, resumed = _resume_runs(torch)
    log(f"  uninterrupted losses {[round(x, 4) for x in full]}")
    log(f"  resumed at step {RESUME_AT}: steps {RESUME_AT}-"
        f"{RESUME_STEPS - 1} bit-equal {resumed == full[RESUME_AT:]}; "
        f"loss {full[0]:.4f} -> {full[-1]:.4f}")
    require(resumed == full[RESUME_AT:], "resumed losses differ from the "
            f"uninterrupted run's: {resumed} vs {full[RESUME_AT:]}")
    require(full[-1] < full[0], "the launcher's loss did not fall")
    log(f"  phase 15 wall {time.perf_counter() - t0:.1f}s")


def _resume_runs(torch):
    """The launcher in-process three times, deterministic algorithms on:
    uninterrupted to RESUME_STEPS; stopped at RESUME_AT (its run cut
    there, which saves); resumed from that checkpoint. Returns (the
    uninterrupted run's losses, the resumed run's)."""
    import io
    import shutil
    from repro_torch.launch import train as launch_train
    from repro_torch.train.trainer import Trainer
    out = ROOT / "build" / "phase15"
    shutil.rmtree(out, ignore_errors=True)
    argv = ["--arch", "qwen3-1.7b", "--smoke", "--steps", str(RESUME_STEPS)]
    real_run = Trainer.run

    def main(tag):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            tr = launch_train.main(argv + ["--ckpt-dir", str(out / tag)])
        log("    " + buf.getvalue().strip().splitlines()[-1])
        return [h["loss"] for h in tr.history], tr
    try:
        with _deterministic(torch):
            full, _ = main("full")
            Trainer.run = lambda self, steps=None: real_run(self, RESUME_AT)
            cut, _ = main("cut")
            Trainer.run = real_run
            require(len(cut) == RESUME_AT, f"cut run took {len(cut)} steps")
            resumed, tr = main("cut")
            require(len(resumed) == RESUME_STEPS - RESUME_AT,
                    f"resumed run took {len(resumed)} steps")
    finally:
        Trainer.run = real_run
    return full, resumed


@contextlib.contextmanager
def _deterministic(torch):
    """Deterministic algorithms (and cuBLAS's fixed workspace) inside,
    restored on the way out: the atomics of an index_put's backward and
    of split reductions otherwise order their sums run by run."""
    import os
    cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        if cublas is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas


# ---------------------------------------------------------------------------
# phase 16: the sharding layer
# ---------------------------------------------------------------------------

SHARD_STEPS = 3
# the 1x1 mesh's losses against no mesh's. Step 0 (the forward before any
# update) runs the same ops on the same values: bit-equal. After an update
# they may differ by what one rounding step in a few gradient leaves makes
# of the loss where DTensor's dispatch hands a product other operand
# layouts (steps 1-2: 9.4e-6 and 1.1e-5 relative while the blocks ran on
# DTensors; bit-equal since they run on local tensors, PERF.md)
SHARD_LOSS_TOL = 1e-6
SHARD_STEP_TOL = 1e-4
# the dry run's cells at full width are the pinned ones
# (``repro_torch.launch.dryrun.PIN_CELLS``), each in a subprocess of its
# own (a fake process group cannot share a process with NCCL)
DRYRUN_TIMEOUT = 900
# phase 16c's dry run starts with phase DRYRUN_START when the run goes on
# to phase 16 (with phase 16 itself under --from 16) and runs beside
# phases 14-16b, one thread each at the lowest priority: rwkv6-7b
# train_4k traces in 186-233 s on the card's host, and started after
# 16a's timed steps instead, it took all sixteen phases to 1038.8 s of
# the 1200 s limit on a slow host. Phase 14's forward wall and 15a's and
# 16a's steps are read beside it: compare them within one run
DRYRUN_START = 14
_DRYRUN = {}


def _start_dryrun():
    """Start phase 16c's dry-run subprocesses once (``_dryrun_procs``);
    returns {"procs", "t0"}."""
    if not _DRYRUN:
        _DRYRUN.update(procs=_dryrun_procs(ROOT / "build" / "phase16"
                                           / "dryrun"),
                       t0=time.perf_counter())
    return _DRYRUN


def _stop_dryrun():
    """Kill whatever of the dry run still runs (a phase failed)."""
    for _, _, p in _DRYRUN.get("procs", ()):
        if p.poll() is None:
            p.kill()
            p.wait()
# the pinned traces (this tree's, on the build host's torch) and the
# reference's compiled values beside them; a trace here must have the
# same collective counts by kind, its FLOPs and temp within PIN_TOL
PINS = ROOT / "tests" / "torch_dryrun_pins.json"
PIN_TOL = 0.02


def _dryrun_procs(out):
    """Start the pinned full-width cells (``PIN_CELLS``) and the smoke
    cells as ``python -m repro_torch.launch.dryrun`` subprocesses on the
    host (no card, one thread each, at the lowest priority), all at once;
    returns them with their record paths."""
    import os
    import shutil
    from repro_torch.launch.dryrun import PIN_CELLS
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = []
    cmds = [([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
              arch, "--shape", shape, "--mesh", mesh, "--out", str(out),
              "--force"], out / f"{arch}__{shape}__{mesh}.json")
            for arch, shape, mesh in PIN_CELLS]
    cmds.append(([sys.executable, "-m", "repro_torch.launch.dryrun",
                  "--smoke", str(out / "smoke.json")], out / "smoke.json"))
    for cmd, path in cmds:
        procs.append((cmd, path,
                      subprocess.Popen(cmd, env=env, cwd=ROOT,
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True,
                                       preexec_fn=lambda: os.nice(19))))
    return procs


def _against_pins(traced):
    """Hold each traced cell ({"<mesh>/<arch>/<shape>": summary}) to the
    pins: collective counts by kind equal, FLOPs and temp within PIN_TOL;
    then each full-width cell's fits-in-80-GB verdict to the reference's
    once its CPU copies of bf16 inputs are out (printed beside the
    reference's as compiled)."""
    from repro_torch.launch.dryrun import fits as fit
    pins = json.loads(PINS.read_text())
    log(f"  (c) against {PINS.name} (torch {pins['torch']}, "
        f"{pins['command']}):")
    for cell, got in traced.items():
        want = pins["cells"][cell]
        rel = {k: got[k] / want[k] - 1 for k in ("flops", "temp_bytes")}
        log(f"      {cell}: collectives {got['collectives']} (pinned "
            f"{want['collectives']}), FLOPs {got['flops']:.6e} "
            f"({rel['flops']:+.2e}), temp {got['temp_bytes']} "
            f"({rel['temp_bytes']:+.2e})")
        require(got["collectives"] == want["collectives"],
                f"{cell}: collectives {got['collectives']} against the "
                f"pinned {want['collectives']}")
        require(all(abs(x) <= PIN_TOL for x in rel.values()),
                f"{cell}: FLOPs or temp off the pins by {rel}")
        require(got["argument_bytes"] == want["argument_bytes"],
                f"{cell}: argument bytes off the pins")
    ref = pins["reference"]
    for cell, want in ref["cells"].items():
        got = traced[cell]
        port = got["argument_bytes"] + got["temp_bytes"]
        as_compiled = want["argument_bytes"] + want["temp_bytes"]
        less = want["argument_bytes"] + want["live_peak_less_cpu_copies"]
        fits = lambda b: "fits" if fit(b, 0) else "does not fit"
        log(f"      {cell} in 80 GB (argument + temp): port "
            f"{port / 1e9:.3f} GB {fits(port)}; reference compiled (jax "
            f"{ref['jax']}, CPU) {as_compiled / 1e9:.3f} GB "
            f"{fits(as_compiled)}; its live peak without its "
            f"{want['cpu_copies_bytes'] / 1e9:.3f} GB of f32 copies of bf16 "
            f"inputs {less / 1e9:.3f} GB {fits(less)}; port temp over the "
            f"reference's {got['temp_bytes'] / want['temp_bytes']:.3f}")
        require(fits(port) == fits(less),
                f"{cell}: the port {fits(port)} in 80 GB, the reference "
                f"{fits(less)} less its copies")


def _dryrun_results(procs, t0):
    """Wait for the dry run's subprocesses (``_dryrun_procs``, started at
    ``t0``), print each record and hold them to the pins."""
    t1 = time.perf_counter()
    traced = {}
    for cmd, path, p in procs:
        try:
            _, err = p.communicate(timeout=max(
                1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            for _, _, q in procs:
                q.kill()
            require(False, f"dry run over {DRYRUN_TIMEOUT}s: {cmd}")
        require(p.returncode == 0 and path.exists(),
                f"dry run failed: {cmd}: {err[-2000:]}")
        rec = json.loads(path.read_text())
        if "cells" in rec:                               # the smoke cells
            traced.update({k: {x: v[x] for x in ("flops", "argument_bytes",
                                                 "temp_bytes", "collectives")}
                           for k, v in rec["cells"].items()})
            log(f"  (c) {len(rec['cells'])} smoke cells traced (torch "
                f"{rec['torch']})")
            continue
        require(rec["ok"], f"dry run cell not ok: {rec.get('error')}\n"
                           f"{rec.get('traceback', '')[-2500:]}")
        m = rec["main"]
        traced[f"{rec['mesh']}/{rec['arch']}/{rec['shape']}"] = {
            "flops": m["flops"],
            "argument_bytes": m["memory"]["argument_bytes"],
            "temp_bytes": m["memory"]["temp_bytes"],
            "collectives": dict(sorted(m["collectives"]["counts"].items()))}
        mem, coll = m["memory"], m["collectives"]
        log(f"  (c) {rec['arch']} {rec['shape']} on {rec['n_devices']} "
            f"ranks ({rec['mesh']}), traced in {rec['elapsed_s']}s: per "
            f"device argument {mem['argument_bytes'] / 2 ** 30:.3f} GiB, "
            f"temp {mem['temp_bytes'] / 2 ** 30:.3f} GiB (of the H100's "
            f"80 GB: {(mem['argument_bytes'] + mem['temp_bytes']) / 80e9:.3f}"
            f"), output {mem['output_bytes'] / 2 ** 30:.3f} GiB, "
            f"{m['flops']:.4e} FLOPs, bytes accessed "
            f"{m['bytes_accessed']:.4e}; collectives {coll['counts']}, "
            f"wire bytes {coll['wire_bytes']}; temp at its peak by op (GiB) "
            f"{ {k: round(v / 2 ** 30, 3) for k, v in mem.get('temp_by_op', {}).items()} }"
            f"; torch {rec['torch']}")
    log(f"  (c) waited {time.perf_counter() - t1:.1f}s for the dry run")
    _against_pins(traced)


def _train_losses(torch, cfg, dc, seed, mesh, ckpt_dir=None):
    """SHARD_STEPS ``Trainer`` steps (on ``mesh``, or none); returns the
    trainer, its losses, step ms and peak GiB."""
    from repro_torch.train import AdamWConfig, Trainer, TrainerConfig
    _free(torch)
    tr = Trainer(cfg, dc, AdamWConfig(lr=1e-4, warmup_steps=2,
                                      total_steps=SHARD_STEPS),
                 TrainerConfig(steps=SHARD_STEPS), seed=seed, device="cuda",
                 mesh=mesh)
    hist = tr.run()
    torch.cuda.synchronize()
    return (tr, [h["loss"] for h in hist],
            [round(h["time_s"] * 1e3, 1) for h in hist], _peak_gib(torch))


def sharding_phase(torch, seed, smi):
    """Phase 16: (a) qwen3-1.7b at full width in phase 15's setting, a
    ``Trainer`` with no mesh, then one on a 1x1 mesh of an NCCL group of
    one rank, from the same seed and batches, each with deterministic
    algorithms: step 0's loss within SHARD_LOSS_TOL, the later steps'
    within SHARD_STEP_TOL (see there); (b) the unsharded trainer's params, checkpointed,
    restored onto the mesh (``restore(shardings=...)``): every leaf's
    ``full_tensor()`` bit-equal; (c) the dry run at full width, each of
    the six pinned cells in its own subprocess on the host, and the
    eighteen smoke cells in another, started with phase DRYRUN_START (or
    first) and read last: each records ``ok``,
    each cell's trace matches the pins (``_against_pins``), and each
    full-width cell gives the reference's fits-in-80-GB verdict."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import param_pspecs
    from repro_torch.launch.mesh import local_group, make_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.train import DataConfig
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.tree import leaves
    t0 = time.perf_counter()
    out = ROOT / "build" / "phase16"
    shutil.rmtree(out / "ckpt", ignore_errors=True)
    dry = _start_dryrun()
    log(f"  (c) the dry run started {t0 - dry['t0']:.1f}s before phase 16")
    cfg = get_config("qwen3-1.7b").replace(remat="full")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                    global_batch=1, seed=seed)
    with _deterministic(torch):
        tr, plain, plain_ms, plain_peak = _train_losses(torch, cfg, dc, seed,
                                                        None)
    ckpt.save(str(out / "ckpt"), SHARD_STEPS, {"params": tr.params})
    del tr
    with local_group("nccl"):
        mesh = make_mesh((1, 1), ("data", "model"))
        with _deterministic(torch):
            tr, sharded, sharded_ms, sharded_peak = _train_losses(
                torch, cfg, dc, seed, mesh)
        log(f"  (a) qwen3-1.7b full width, f32 params, bf16 activations, "
            f"remat full, S {TRAIN_SEQ} x 1, {SHARD_STEPS} steps, "
            f"deterministic algorithms on for both; {smi}")
        log(f"  no mesh: losses {plain}, step ms {plain_ms}, peak "
            f"{plain_peak:.2f} GiB")
        log(f"  1x1 mesh (NCCL, DTensor): losses {sharded}, step ms "
            f"{sharded_ms}, peak {sharded_peak:.2f} GiB")
        rel = [abs(a - b) / abs(b) for a, b in zip(sharded, plain)]
        log(f"  losses bit-equal {sharded == plain} (step 0 "
            f"{sharded[0] == plain[0]}); rel by step "
            f"{[f'{x:.3e}' for x in rel]} (tol {SHARD_LOSS_TOL} at step 0, "
            f"{SHARD_STEP_TOL} after an update)")
        require(rel[0] <= SHARD_LOSS_TOL and max(rel[1:]) <= SHARD_STEP_TOL,
                f"1x1 mesh losses off no mesh's by {rel}")
        placed = tr.params["embed"]
        require(hasattr(placed, "placements"), "the mesh trainer's params "
                                               "are not DTensors")
        del tr
        _free(torch)
        like = {"params": tf.init_params(cfg, seed, "meta")}
        t1 = time.perf_counter()
        want, _ = ckpt.restore(str(out / "ckpt"), SHARD_STEPS,
                               _on_cuda(torch, like))
        got, _ = ckpt.restore(str(out / "ckpt"), SHARD_STEPS,
                              _on_cuda(torch, like),
                              shardings={"params": param_pspecs(
                                  like["params"], mesh)})
        equal = [torch.equal(a.full_tensor(), b)
                 for a, b in zip(leaves(got), leaves(want))]
        log(f"  (b) the unsharded checkpoint restored onto the 1x1 mesh "
            f"({time.perf_counter() - t1:.1f}s): {len(equal)} leaves, "
            f"all DTensors {all(hasattr(x, 'placements') for x in leaves(got))}"
            f", full_tensor() bit-equal {all(equal)}")
        require(all(equal), "a resharded leaf differs from the checkpoint")
        del got, want
        _free(torch)
    _dryrun_results(dry["procs"], dry["t0"])
    log(f"  phase 16 wall {time.perf_counter() - t0:.1f}s")


def _on_cuda(torch, tree):
    """A meta tree as zeros on the card (the shapes and dtypes a restore
    casts to)."""
    from repro_torch.train.tree import leaves, unflatten
    return unflatten(tree, [torch.zeros(x.shape, dtype=x.dtype,
                                        device="cuda") for x in leaves(tree)])


def _hierarchy(torch, seed, smi, kres):
    counts, routes = hierarchy_phase(torch, seed)
    for name in ("decode_attention_paged", "prefill_attention_paged"):
        kres[name]["hierarchy_launches"] = counts[name]
    kres["prefill_attention_paged"]["hierarchy_routes"] = routes[
        "prefill_attention_paged"]


def _disagg_and_launcher(torch, seed, smi, kres):
    log("== phase 11a: disaggregated prefill/decode (co-located, pipelined "
        "x2, whole-group, 4 devices, planted fault)")
    counts = disagg_phase(torch, seed)
    for name in ("decode_attention_paged", "prefill_attention_paged"):
        kres[name]["disagg_launches"] = counts[name]
    log("== phase 11b: the launcher repro_torch.launch.serve, in-process")
    for name, row in launcher_phase(torch).items():
        kres[name]["launcher"] = row


def _families(torch, seed, smi, kres):
    pair, ctx = families_phase(torch, seed)
    for name, n in pair.items():
        kres[name]["families_launches"] = {"moonshot-v1-16b-a3b BE": n}
    kres["decode_attention"]["families_launches"] = ctx


def _long_seq(torch, seed, smi, kres):
    kres["prefill_attention_paged"]["long_seq_launches"] = long_seq_phase(
        torch, seed)


# phases 10-16: each reachable alone through --from; each records what the
# result line keeps into kres
LATER_PHASES = {
    10: ("KV hierarchy and fault plane, LS qwen3-1.7b + BE stablelm-1.6b, "
         "paged (prefix cache, growth and swap, storm)", _hierarchy),
    11: ("disaggregated prefill/decode, LS qwen3-1.7b, paged; the launcher "
         "repro_torch.launch.serve", _disagg_and_launcher),
    12: ("the MoE, MLA, encoder and vision families (BE moonshot-v1-16b-a3b "
         "at full width, one MoE layer, deepseek-v2 MLA, whisper-small and "
         "llama-3.2-vision)", _families),
    13: ("channel reverse engineering (rtx-a2000, simulated) and the MLP "
         "hash fit on the card",
         lambda torch, seed, smi, kres: coloring_phase(torch, seed)),
    14: ("qwen3-1.7b full width, S 32768: blocked forward vs chunked flash "
         "prefill", _long_seq),
    15: ("training: qwen3-1.7b full width at S 4096, remat full; the launcher "
         "repro_torch.launch.train, interrupted and resumed",
         lambda torch, seed, smi, kres: train_phase(torch, seed, smi)),
    16: ("the sharding layer: qwen3-1.7b trained on a 1x1 NCCL mesh vs no "
         "mesh, a resharded restore, the dry run at full width on fake "
         "256- and 512-rank meshes",
         lambda torch, seed, smi, kres: sharding_phase(torch, seed, smi)),
}


def early_phases(torch, args, kres):
    """Phases 4-9 (the full run only), recording into ``kres``. Returns
    (the launches of the result line, phase 5's and phase 8c's class
    metrics), or None where ``--until`` stopped it."""
    log("== phase 4: qwen3-1.7b full width, paged prefill + decode")
    model_phase(torch, args.seed)

    log("== phase 5: engine LS qwen3-1.7b + BE stablelm-1.6b, paged, flash")
    paged_counts, paged_routes, cls = engine_phase(torch, args.seed)

    log("== phase 6: engine LS qwen3-1.7b, dense cache, flash")
    dense_counts, dense_routes = dense_phase(torch, args.seed)
    for name, routes in (("prefill_attention_paged", paged_routes),
                         ("prefill_attention", dense_routes)):
        kres[name]["routes"] = routes[name]
    for sub, dname in (("6b", "float32"), ("6c", "float16")):
        log(f"== phase {sub}: engine LS qwen3-1.7b in {dname}, dense then "
            "paged, flash")
        t_phase = time.perf_counter()
        counts, params = typed_engine_phase(torch, args.seed, dname)
        for name in ("decode_attention_paged", "prefill_attention_paged",
                     "decode_attention", "prefill_attention"):
            kres[name][dname]["launches"] = counts[name]
        if dname == "float16":
            f16_prefill_check(torch, args.seed, params)
        del params
        torch.cuda.empty_cache()
        log(f"  phase {sub} wall {time.perf_counter() - t_phase:.1f}s")

    if args.until <= 6:
        return None
    log("== phase 7: SGDRC kernels (flash, dual-tenant attention and "
        "matmul, SPT gather/scatter)")
    t_phase = time.perf_counter()
    sgdrc_counts, sgdrc_res = sgdrc_phase(torch, args.seed)
    kres.update(sgdrc_res)
    log(f"  phase 7 wall {time.perf_counter() - t_phase:.1f}s")

    if args.until <= 7:
        return None
    log("== phase 8a: ssd_scan at zamba2-1.2b's mamba2 widths")
    ssd_counts, kres["ssd_scan"] = ssd_phase(torch, args.seed)
    log("== phase 8b: zamba2-1.2b full width, f32, forward vs prefill")
    hybrid_model_phase(torch, args.seed)
    log("== phase 8c: engine LS zamba2-1.2b + BE rwkv6-7b, dense cache, "
        "flash")
    _, ssm_cls = ssm_engine_phase(torch, args.seed)

    if args.until <= 8:
        return None
    log("== phase 9: tidal control plane, LS qwen3-1.7b + BE stablelm-1.6b,"
        " colored paged KV (static, tidal, resplit)")
    tidal_counts = tidal_phase(torch, args.seed,
                               cls["LS"]["tbt"]["p99_ms"])
    for name in ("decode_attention_paged", "prefill_attention_paged"):
        kres[name]["tidal_launches"] = {
            mode: c[name] for mode, c in tidal_counts.items()}

    launches = {**{k: paged_counts[k] for k in ("decode_attention_paged",
                                                "prefill_attention_paged")},
                **{k: dense_counts[k] for k in ("decode_attention",
                                                "prefill_attention")},
                **{k: sgdrc_counts[k] for k in sgdrc_res},
                "ssd_scan": ssd_counts["ssd_scan"]}
    return launches, cls, ssm_cls


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--until", type=int, default=None,
                    help="stop after this phase (debugging; the result "
                         "lines are printed only when all sixteen ran)")
    ap.add_argument("--from", "--start", dest="start", type=int, default=4,
                    choices=(4, 10, 11, 12, 13, 14, 15, 16),
                    help="10-16: run phases 1-3 and that phase alone, or "
                         "through --until (debugging; no result lines)")
    args = ap.parse_args()
    if args.until is None:
        args.until = args.start if args.start > 4 else 16

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    log("== phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"  {smi}")
    log(f"  {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; python {sys.version.split()[0]}")

    log("== phase 2: build")
    secs = _build.build_all()
    log(f"  nvcc sm_90a build of {len(_build.SOURCES)} sources: "
        f"{secs:.1f}s")
    for name, text in _build.build_logs.items():
        entry = ""
        for line in text.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                log(f"  [{name}] {entry}: {line.split(':', 1)[-1].strip()}")

    log("== phase 3: kernels vs plain versions")
    t_phase = time.perf_counter()
    kres = kernel_phase(torch, args.seed)
    log(f"  phase 3 wall {time.perf_counter() - t_phase:.1f}s")

    if args.until <= 3:
        return 1
    if args.start == 4:
        result = early_phases(torch, args, kres)
        if result is None:
            return 1
    try:
        for n in range(max(args.start, 10), args.until + 1):
            title, run = LATER_PHASES[n]
            if n >= DRYRUN_START and args.until >= 16:
                _start_dryrun()
            log(f"== phase {n}: {title}")
            run(torch, args.seed, smi, kres)
    finally:
        _stop_dryrun()
    if args.start > 4 or args.until < 16:
        log(f"== phases {args.start}-{args.until} passed; the others "
            "skipped: no result lines")
        return 1
    launches, cls, ssm_cls = result
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        **kres[name]})
    log(f"== all sixteen phases passed in "
        f"{time.perf_counter() - t_start:.1f}s; "
        f"{smi}; engine _class tokens/s LS "
        f"{cls['LS']['tokens_per_s']} BE {cls['BE']['tokens_per_s']}; "
        f"SSM engine LS {ssm_cls['LS']['tokens_per_s']} BE "
        f"{ssm_cls['BE']['tokens_per_s']}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

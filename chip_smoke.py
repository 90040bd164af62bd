#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root: ``python3 chip_smoke.py`` (``--seed N`` for
other random weights and prompts). Phases, in order; any failure exits
non-zero:

1. device  — require CUDA; print the card's name and power limit.
2. build   — compile the CUDA kernels with nvcc (sm_90a), in parallel.
3. kernels — each kernel against its plain PyTorch version on the card, in
             bf16 and f32, at the two head shapes of the engine phase
             (qwen3-1.7b: H=16 Hkv=8 D=128; stablelm-1.6b: H=32 Hkv=32 D=64),
             with ragged positions, sentinel rows, unmapped page-table
             entries, abort caps and Sq=1 prefill == decode; times each
             kernel, its plain version and one PyTorch library call.
4. model   — qwen3-1.7b at its published width (28 layers, bf16, random
             weights from the seed): one paged 256-token prefill_step for 4
             rows and 8 decode_steps, with use_flash on and off.
5. engine  — the LS+BE paged engine with use_flash: LS qwen3-1.7b, BE
             stablelm-1.6b, 8 slots each, chunk 256, ResourcePlan(sm_be=0.3).
6. dense   — an LS-only dense-cache engine with use_flash.

Launch counts of phases 5 and 6 are read with the counters set to 0 just
before each phase. The next-to-last line is one JSON object with every
kernel's launches and times; the last line is the device JSON.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PAGE = 16
# kernel tolerances of the reference's tests/test_kernels.py
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# H100 SXM peaks (NVIDIA data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# model phase: last-position logits of flash vs torch-op attention in bf16.
# Both paths round each layer's attention output to bf16 (2^-8 relative)
# at different places, and those roundings compound through 28 residual
# layers and the final norm; 5e-2 relative L2 bounds that drift while still
# failing on a wrong kernel (which gives O(1) relative error).
MODEL_REL_TOL = 5e-2
SOURCES = {
    "decode_attention_paged": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                               "src/repro/kernels/decode_attention.py:181"),
    "prefill_attention_paged": ("src/repro_torch/kernels/csrc/prefill_attention.cu",
                                "src/repro/kernels/prefill_attention.py:210"),
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:131"),
    "prefill_attention": ("src/repro_torch/kernels/csrc/prefill_attention.cu",
                          "src/repro/kernels/prefill_attention.py:148"),
}
HEADS = {"qwen3-1.7b": (16, 8, 128), "stablelm-1.6b": (32, 32, 64)}


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
        for dname in ("bfloat16", "float32"):
            dtype = getattr(torch, dname)
            tol = TOL[dname]
            main = dname == "bfloat16"
            tag = f"{model} {dname}"

            def rec(name, err, ms=None, plain_ms=None, lib_ms=None,
                    bound=None):
                log(f"  {name:24s} {tag:26s} max_abs_err={err:.3e}"
                    + ("" if ms is None else
                       f" ms={ms:.4f} plain_ms={plain_ms:.4f} "
                       f"library_ms={lib_ms:.4f} bound_ms={bound[0]:.4f}"
                       f" ({bound[1]})"))
                require(err == err, f"{name} {tag}: NaN in the output")
                if main and model == "qwen3-1.7b" and ms is not None:
                    results[name] = {"max_abs_err": err, "ms": ms,
                                     "plain_ms": plain_ms,
                                     "library_ms": lib_ms,
                                     "bound_ms": bound[0],
                                     "bound_by": bound[1]}

            def close(a, b, what):
                err = (a.float() - b.float()).abs().max().item()
                ok = torch.allclose(a.float(), b.float(), rtol=tol, atol=tol)
                require(ok, f"{what} {tag}: not within {tol} (max abs "
                            f"{err})")
                return err

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
            kr = kdense.repeat_interleave(G, dim=2).transpose(1, 2)
            vr = vdense.repeat_interleave(G, dim=2).transpose(1, 2)
            mask = (torch.arange(window, device="cuda")[None, :]
                    <= posd[:, None])[:, None, None, :]
            kvk, pairs = _keys_seen(dec_pos, 1, window)
            rec("decode_attention_paged", err,
                cuda_ms(lambda: kd.decode_attention_paged(q1, kpool, vpool,
                                                          pt, posd)),
                cuda_ms(lambda: ref.ref_decode_attention_paged(
                    q1, kpool, vpool, pt, posd), iters=5),
                cuda_ms(lambda: F.scaled_dot_product_attention(
                    q1[:, :, None], kr, vr, attn_mask=mask)),
                _bound_ms(kvk, B, 1, H, Hkv, D, q.element_size(), pairs,
                          dname))

            # -- 2: paged chunked prefill, abort/progress ------------
            q, kpool, vpool, pt = _paged_case(
                torch, gen, B, Sq, H, Hkv, D, dtype, n_pages, P, pre_pos)
            posp = torch.tensor(pre_pos, dtype=torch.int32, device="cuda")
            out = kp_.prefill_attention_paged(q, kpool, vpool, pt, posp)
            want = ref.ref_prefill_attention_paged(q, kpool, vpool, pt, posp)
            err = close(out, want, "prefill_attention_paged")
            abort = torch.tensor(aborts, dtype=torch.int32, device="cuda")
            out_a, prog = kp_.prefill_attention_paged(q, kpool, vpool, pt,
                                                      posp, abort=abort)
            require(prog.tolist() == [min(max(a, 0), Sq) for a in aborts],
                    f"progress {prog.tolist()} for abort {aborts}")
            for b, a in enumerate(aborts):
                n = min(a, Sq)
                if n:
                    err = max(err, close(out_a[b, :n], want[b, :n],
                                         "prefill_attention_paged abort"))
            one = kp_.prefill_attention_paged(q[:, :1], kpool, vpool, pt,
                                              posp)
            dec = kd.decode_attention_paged(q[:, 0].contiguous(), kpool,
                                            vpool, pt, posp)
            require(torch.allclose(one[:, 0].float(), dec.float(),
                                   rtol=2e-6, atol=2e-6),
                    f"Sq=1 paged prefill != decode {tag}")
            kdense = ref.gather_pages(kpool, pt)
            vdense = ref.gather_pages(vpool, pt)
            kr = kdense.repeat_interleave(G, dim=2).transpose(1, 2)
            vr = vdense.repeat_interleave(G, dim=2).transpose(1, 2)
            qpos = posp[:, None] + torch.arange(Sq, device="cuda")[None]
            mask = (torch.arange(window, device="cuda")[None, None, :]
                    <= qpos[:, :, None])[:, None]
            qt = q.transpose(1, 2)
            kvk, pairs = _keys_seen(pre_pos, Sq, window)
            rec("prefill_attention_paged", err,
                cuda_ms(lambda: kp_.prefill_attention_paged(
                    q, kpool, vpool, pt, posp)),
                cuda_ms(lambda: ref.ref_prefill_attention_paged(
                    q, kpool, vpool, pt, posp), iters=3),
                cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kr, vr, attn_mask=mask)),
                _bound_ms(kvk, B, Sq, H, Hkv, D, q.element_size(), pairs,
                          dname))

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
            out_s = kd.decode_attention(q1, kc.transpose(1, 2),
                                        vc.transpose(1, 2), posd,
                                        kv_layout="bshd")
            require(torch.equal(out, out_s), f"bshd != bhsd {tag}")
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
            rec("decode_attention", err,
                cuda_ms(lambda: kd.decode_attention(q1, kc, vc, posd,
                                                    kv_layout="bhsd")),
                cuda_ms(lambda: ref.ref_decode_attention(
                    q1, kc.transpose(1, 2), vc.transpose(1, 2), posd),
                    iters=5),
                cuda_ms(lambda: F.scaled_dot_product_attention(
                    q1[:, :, None], kr, vr, attn_mask=mask)),
                _bound_ms(kvk, Bd, 1, H, Hkv, D, q1.element_size(), pairs,
                          dname))

            # -- 4: dense chunked prefill, abort/progress -------------
            ppos = [0, 300, Smax, 1792]
            pab = [Sq + 5, 3, 1, 0]
            q = torch.randn(Bd, Sq, H, D, generator=gen, device="cuda") \
                .to(dtype)
            posp = torch.tensor(ppos, dtype=torch.int32, device="cuda")
            out = kp_.prefill_attention(q, kc, vc, posp)
            want = ref.ref_prefill_attention(q, kc.transpose(1, 2),
                                             vc.transpose(1, 2), posp)
            err = close(out, want, "prefill_attention")
            abort = torch.tensor(pab, dtype=torch.int32, device="cuda")
            out_a, prog = kp_.prefill_attention(q, kc, vc, posp, abort=abort)
            require(prog.tolist() == [min(max(a, 0), Sq) for a in pab],
                    f"dense progress {prog.tolist()} for abort {pab}")
            for b, a in enumerate(pab):
                n = min(a, Sq)
                if n:
                    err = max(err, close(out_a[b, :n], want[b, :n],
                                         "prefill_attention abort"))
            one = kp_.prefill_attention(q[:, :1], kc, vc, posp)
            dec = kd.decode_attention(q[:, 0].contiguous(), kc, vc, posp,
                                      kv_layout="bhsd")
            require(torch.allclose(one[:, 0].float(), dec.float(),
                                   rtol=2e-6, atol=2e-6),
                    f"Sq=1 dense prefill != decode {tag}")
            qt = q.transpose(1, 2)
            qpos = posp[:, None] + torch.arange(Sq, device="cuda")[None]
            mask = (torch.arange(Smax, device="cuda")[None, None, :]
                    <= qpos[:, :, None])[:, None]
            kvk, pairs = _keys_seen(ppos, Sq, Smax)
            rec("prefill_attention", err,
                cuda_ms(lambda: kp_.prefill_attention(q, kc, vc, posp)),
                cuda_ms(lambda: ref.ref_prefill_attention(
                    q, kc.transpose(1, 2), vc.transpose(1, 2), posp),
                    iters=3),
                cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kr, vr, attn_mask=mask)),
                _bound_ms(kvk, Bd, Sq, H, Hkv, D, q.element_size(), pairs,
                          dname))
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
    (the device-busy share)."""
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
    for t, n, name in rows[:top]:
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

def _serve(torch, seed, *, paged, chunk, ls_lens, be_lens, max_new,
           slots, max_seq, plan=None, params=None):
    from repro_torch.configs import get_config
    from repro_torch.core.tenancy import TenantSpec
    from repro_torch.serving import ServingEngine
    import numpy as np
    eng = ServingEngine(max_seq=max_seq, paged=paged, page_size=PAGE,
                        use_flash=True, chunk_size=chunk, slots_ls=slots,
                        slots_be=slots, plan=plan, torch_device="cuda")
    t0 = time.perf_counter()
    ls = eng.add_tenant(TenantSpec("ls-qwen3", "LS"),
                        get_config("qwen3-1.7b"),
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
    from repro_torch.core.controller import ResourcePlan
    from repro_torch.kernels import ops
    rng = np.random.default_rng(seed + 7)
    ls_lens = [int(x) for x in rng.integers(128, 1025, 8)]
    be_lens = [int(x) for x in rng.integers(512, 1537, 8)]
    plan = ResourcePlan(sm_be=0.3, ch_be=1 / 3, thres_dram=0.4,
                        ls_channels=(), be_channels=(),
                        max_ls_inflation=0.25)
    log(f"  LS prompts {ls_lens}; BE prompts {be_lens}; max_new 32")
    ops.reset_launch_counts()
    eng, _, _ = _serve(torch, seed, paged=True, chunk=256, ls_lens=ls_lens,
                       be_lens=be_lens, max_new=32, slots=8, max_seq=2048,
                       plan=plan)
    counts = ops.launch_counts()
    log(f"  launches {counts}")
    require(counts["decode_attention_paged"] > 0
            and counts["prefill_attention_paged"] > 0,
            f"paged kernels not launched: {counts}")
    m = eng.metrics()
    cls = m["_class"]
    log("  metrics _class " + json.dumps(cls))
    quanta = {"LS": 0, "BE": 0}
    for _, _, pri in eng.events:
        quanta[pri] += 1
    log(f"  quanta by class {quanta}")
    del eng
    torch.cuda.empty_cache()
    return counts, cls


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
    log(f"  launches {counts}")
    require(counts["decode_attention"] > 0
            and counts["prefill_attention"] > 0,
            f"dense kernels not launched: {counts}")
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
    return counts


# ---------------------------------------------------------------------------

def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--until", type=int, default=6,
                    help="stop after this phase (debugging; the result "
                         "lines are printed only when all six ran)")
    args = ap.parse_args()

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
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  [{name}] {line.strip()}")

    log("== phase 3: kernels vs plain versions")
    kres = kernel_phase(torch, args.seed)

    if args.until <= 3:
        return 1
    log("== phase 4: qwen3-1.7b full width, paged prefill + decode")
    model_phase(torch, args.seed)

    log("== phase 5: engine LS qwen3-1.7b + BE stablelm-1.6b, paged, flash")
    paged_counts, cls = engine_phase(torch, args.seed)

    log("== phase 6: engine LS qwen3-1.7b, dense cache, flash")
    dense_counts = dense_phase(torch, args.seed)

    launches = {**{k: paged_counts[k] for k in ("decode_attention_paged",
                                                "prefill_attention_paged")},
                **{k: dense_counts[k] for k in ("decode_attention",
                                                "prefill_attention")}}
    kernels = []
    for name, (src, replaces) in SOURCES.items():
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        **kres[name]})
    log(f"== all phases passed in {time.perf_counter() - t_start:.1f}s; "
        f"{smi}; engine _class tokens/s LS "
        f"{cls['LS']['tokens_per_s']} BE {cls['BE']['tokens_per_s']}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time forms of the ``ssd_scan`` kernel on the card.

Each form is a list of text edits applied to a copy of
``src/repro_torch/kernels/csrc/`` (the form "kept" has none: the source as
it is). Every form is built with nvcc and the flags of
``repro_torch.kernels._build``, one process each, all started together,
into ``build/ssd_forms/<form>/``, then timed on the inputs of
``chip_smoke.py`` phase 8a (zamba2-1.2b's mamba2 widths: B 4, T 2048, H 64,
K = P = 64, mamba2's decays; bf16 q/k/v and f32, f32 log_w) with CUDA
events over 20 calls, in two rounds (forms in order, then reversed). A
probe form that leaves work out gives wrong results by design; its
difference from the kept form's output is printed beside its time.

Run from the repository root on a machine with the card:

    python3 tools/ssd_scan_forms.py [form ...]

Prints, per form: registers and spills (ptxas), resident blocks an SM,
ms in bf16 and f32 for each round, and the max abs difference from
"kept".
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# form -> [(old, new), ...] edits of csrc/ssd_scan.cu
FORMS = {
    "kept": [],
    # probes: one part of the sub-chunk left out
    "no-scores": [("    if (warp < 2) {\n#pragma unroll\n      for (int x",
                   "    if (false) {\n#pragma unroll\n      for (int x"),
                  ("    } else if (warp < 5) {", "    } else if (false) {")],
    "no-inter": [("for (int g = 0; g < KT / 4; ++g) {",
                  "for (int g = 0; g < 0; ++g) {")],
    "no-state": [("for (int i = 0; i < kLS; ++i) {",
                  "for (int i = 0; i < 0; ++i) {")],
    "no-intra": [("for (int m = 0; m < kLS / 4; ++m) {",
                  "for (int m = 0; m < 0; ++m) {")],
    "no-step-1": [("    if (!ywarp && n + 1 < nsub) prep(n + 1);\n", "")],
    "no-products": [  # scores, q~ . S and the state left out together
        ("    if (warp < 2) {\n#pragma unroll\n      for (int x",
         "    if (false) {\n#pragma unroll\n      for (int x"),
        ("    } else if (warp < 5) {", "    } else if (false) {"),
        ("for (int g = 0; g < KT / 4; ++g) {", "for (int g = 0; g < 0; ++g) {"),
        ("for (int i = 0; i < kLS; ++i) {", "for (int i = 0; i < 0; ++i) {")],
    # probes: every FMA kept, one loop's shared-memory reads hoisted out of
    # it (the same operands each step)
    "hoist-inter": [("const int c = 4 * g + cq;", "const int c = cq;")],
    "hoist-state": [("reinterpret_cast<const float4*>(vc + i * PS + pb);",
                     "reinterpret_cast<const float4*>(vc + pb);"),
                    ("reinterpret_cast<const float4*>(kt + i * RS + cs + x4);",
                     "reinterpret_cast<const float4*>(kt + cs + x4);")],
    # variants
    "step1-all-warps": [  # step 1 spread over all 8 warps
        ("const int t1 = tid & 15, hw = (tid >> 4) & 7;",
         "const int t1 = tid & 15, hw = tid >> 4;"),
        ("for (int gi = 0; gi < KT / 32; ++gi) {\n      const int c0 = 4 * (hw + 8 * gi);",
         "for (int gi = 0; gi < KT / 64; ++gi) {\n      const int c0 = 4 * (hw + 16 * gi);"),
        ("for (int gi = 0; gi < kTileP / 32; ++gi) {\n      const int p4 = 4 * (hw + 8 * gi);",
         "for (int gi = 0; gi < kTileP / 64; ++gi) {\n      const int p4 = 4 * (hw + 16 * gi);"),
        ("  if (!ywarp) prep(0);", "  prep(0);"),
        ("    if (!ywarp && n + 1 < nsub) prep(n + 1);", "    if (n + 1 < nsub) prep(n + 1);")],
    "inter-unroll-4": [("#pragma unroll\n      for (int g = 0; g < KT / 4; ++g) {",
                        "#pragma unroll 4\n      for (int g = 0; g < KT / 4; ++g) {")],
    "state-unroll-4": [("#pragma unroll\n      for (int i = 0; i < kLS; ++i) {",
                        "#pragma unroll 4\n      for (int i = 0; i < kLS; ++i) {")],
    "stages-2": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
    "stages-4": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
}


def build(names):
    from repro_torch.kernels import _build
    out = {}
    procs = []
    for name in names:
        d = ROOT / "build" / "ssd_forms" / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(_build.CSRC, d / "csrc")
        src = d / "csrc" / "ssd_scan.cu"
        text = src.read_text()
        for old, new in FORMS[name]:
            if old not in text:
                raise SystemExit(f"form {name}: edit does not apply: {old!r}")
            text = text.replace(old, new)
        src.write_text(text)
        lib = d / "ssd_scan.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        procs.append((name, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    for name, lib, proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"form {name}: nvcc failed\n{err}")
        regs = []
        entry = ""
        for line in err.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif re.search(r"ssd_scan_kernelI(13__nv_bfloat16|f)fLi64E",
                           entry) and ("registers" in line
                                       or "spill" in line):
                kind = re.search(r"ssd_scan_kernelI(.+?)EEv", entry)
                regs.append(f"{kind.group(1) if kind else entry}: "
                            f"{line.split(':', 1)[-1].strip()}")
        out[name] = (lib, regs)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("forms", nargs="*", default=list(FORMS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sass", default="",
                    help="also write the kept form's SASS to this file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssd_scan_forms: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    F = torch.nn.functional
    names = ["kept"] + [n for n in args.forms if n != "kept"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    libs = build(names)
    if args.sass:
        sass = subprocess.run(
            [str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass",
             str(libs["kept"][0])], capture_output=True, text=True).stdout
        Path(args.sass).parent.mkdir(parents=True, exist_ok=True)
        Path(args.sass).write_text(sass)

    cfg = get_config("zamba2-1.2b")
    s = cfg.ssm
    B, T, L = 4, 2048, s.chunk
    H, K, P = s.expand * cfg.d_model // s.head_dim, s.state_dim, s.head_dim
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 80)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    q, k, v = randn(B, T, H, K), randn(B, T, H, K), randn(B, T, H, P)
    w = -F.softplus(randn(B, T, H, 1)).expand(B, T, H, K).contiguous()
    inputs = {d: (q.to(getattr(torch, d)), k.to(getattr(torch, d)),
                  v.to(getattr(torch, d)), w)
              for d in ("bfloat16", "float32")}
    stream = torch.cuda.current_stream().cuda_stream

    fns = {}
    for name, (lib, regs) in libs.items():
        so = ctypes.CDLL(str(lib))
        fn = so.sgdrc_ssd_scan
        fn.argtypes, fn.restype = _build.SSD_ARGTYPES, ctypes.c_int
        occ = so.sgdrc_ssd_scan_blocks_per_sm
        occ.argtypes, occ.restype = [ctypes.c_int] * 3, ctypes.c_int
        fns[name] = fn
        print(f"{name}: blocks an SM bf16 {occ(1, 0, K)} f32 {occ(0, 0, K)}; "
              + "; ".join(regs), flush=True)

    def run(fn, a):
        y = torch.empty(B, T, H, P, dtype=a[0].dtype, device="cuda")
        strides = (ctypes.c_int64 * 15)(*(st for t in (*a, y)
                                          for st in t.stride()[:3]))
        err = fn(*(t.data_ptr() for t in (*a, y)),
                 _build.DTYPE_CODES[a[0].dtype], _build.DTYPE_CODES[a[3].dtype],
                 B, T, H, K, P, L, strides, stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")
        return y

    def ms(fn, a, iters=20):
        for _ in range(3):
            run(fn, a)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            run(fn, a)
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / iters

    want = {d: run(fns["kept"], a) for d, a in inputs.items()}
    # the SM clock under load: 500 calls queued, read while they run
    for _ in range(500):
        run(fns["kept"], inputs["bfloat16"])
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    torch.cuda.synchronize()
    print(f"under load: SM clock, max SM clock, power: {clocks.strip()}",
          flush=True)
    times = {n: {d: [] for d in inputs} for n in names}
    for order in (names, names[::-1]):
        for n in order:
            for d, a in inputs.items():
                times[n][d].append(ms(fns[n], a))
    for n in names:
        diff = {d: (run(fns[n], a).float() - want[d].float()).abs().max()
                .item() for d, a in inputs.items()}
        print(f"{n:18s} bf16 ms {times[n]['bfloat16'][0]:.4f} "
              f"{times[n]['bfloat16'][1]:.4f}  f32 ms "
              f"{times[n]['float32'][0]:.4f} {times[n]['float32'][1]:.4f}  "
              f"max abs vs kept bf16 {diff['bfloat16']:.3g} f32 "
              f"{diff['float32']:.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""How many rows a block of the whole-vocabulary NLL needs on the card
(``models/transformer.py::_BlockedNll``, ``NLL_MIN_ROWS``).

Run from the repository root on a machine with a GPU:

    python3 tools/nll_rows_probe.py [--rows 64,441,512,528,529,1024,2048]

Part 1: seeded bf16 logits [4096, 151936] (qwen3-1.7b's vocabulary, S
4096 x 1): for each block size, the number of rows whose f32 logsumexp,
taken a block of rows at a time, differs from one call over all 4096
rows, and the largest difference. Part 2: one full-width qwen3-1.7b
step at S 4096 x 1 (f32 params, bf16 activations, remat full, TF32 off)
through ``loss_fn`` and autograd, with the NLL's plain version twice
(``_nll_terms_plain``: is the step deterministic?), then the blocked NLL
with the row floor off (``NLL_MIN_ROWS`` = 1: 10 blocks of 409-410 rows)
and at the module's floor: for each pair, the loss and the worst and
median relative L2 gap over the gradient leaves.
"""
import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="64,441,512,528,529,1024,2048")
    args = ap.parse_args()
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.train import DataConfig, device_batch
    from repro_torch.train.tree import leaves, leaves_with_paths, unflatten
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), torch.__version__,
          flush=True)
    N, V = 4096, 151936
    g = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(N, V, generator=g, device="cuda") * 3).to(
        torch.bfloat16)
    whole = torch.logsumexp(x.float(), -1)
    for rows in map(int, args.rows.split(",")):
        blk = torch.cat([torch.logsumexp(x[i:i + rows].float(), -1)
                         for i in range(0, N, rows)])
        print(f"lse in blocks of {rows} rows: {int((whole != blk).sum())} "
              f"of {N} rows differ from one call, max "
              f"{float((whole - blk).abs().max()):.3e}", flush=True)
    del x, whole, blk

    cfg = get_config("qwen3-1.7b").replace(remat="full")
    dc = DataConfig(vocab_size=V, seq_len=N, global_batch=1, seed=0)
    params = tf.init_params(cfg, 0, "cuda")
    batch = device_batch(dc, 0, None, "cuda")
    names = ["/".join(map(str, p)) for p, _ in leaves_with_paths(params)]

    def step(nll, min_rows):
        tf._nll_terms, tf.NLL_MIN_ROWS = nll, min_rows
        flat = [p.detach().clone().requires_grad_(True)
                for p in leaves(params)]
        loss, _ = tf.loss_fn(unflatten(params, flat), cfg, batch)
        gr = torch.autograd.grad(loss, flat)
        return float(loss), [t.cpu() for t in gr]

    blocked, floor = tf._nll_terms, tf.NLL_MIN_ROWS
    runs = {"plain": step(tf._nll_terms_plain, floor),
            "plain again": step(tf._nll_terms_plain, floor),
            "blocked, no floor": step(blocked, 1),
            f"blocked, floor {floor}": step(blocked, floor)}
    tf._nll_terms, tf.NLL_MIN_ROWS = blocked, floor
    want = runs["plain"]
    for name, (loss, gr) in runs.items():
        if name == "plain":
            continue
        gaps = sorted(((a.float() - b.float()).norm().item()
                       / max(b.float().norm().item(), 1e-30), n)
                      for n, a, b in zip(names, gr, want[1]))
        print(f"{name} against plain: loss {loss!r} vs {want[0]!r}; leaf "
              f"gap worst {gaps[-1][0]:.3e} ({gaps[-1][1]}), median "
              f"{gaps[len(gaps) // 2][0]:.3e}", flush=True)


if __name__ == "__main__":
    main()

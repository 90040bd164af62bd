"""Train a small LM on the PyTorch/CUDA port for a few hundred steps with
checkpointing and a simulated mid-run failure + restart (fault-tolerance
demo).

Run:  PYTHONPATH=src python examples/train_small_lm_torch.py  [--steps 200]
      [--device cpu]   (the card by default)
"""
import argparse
import math
import tempfile

from repro_torch.configs import smoke_config
from repro_torch.train import AdamWConfig, DataConfig, Trainer, TrainerConfig

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--arch", default="stablelm-1.6b")
ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
args = ap.parse_args()

cfg = smoke_config(args.arch).replace(num_layers=2)
dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8,
                mode="pattern")
oc = AdamWConfig(lr=2e-3, warmup_steps=10, total_steps=args.steps)

with tempfile.TemporaryDirectory() as ckpt_dir:
    half = args.steps // 2
    t1 = Trainer(cfg, dc, oc, TrainerConfig(steps=half, ckpt_dir=ckpt_dir,
                                            ckpt_every=25),
                 device=args.device)
    t1.run()
    print(f"[phase 1] trained to step {t1.step}, "
          f"loss {t1.history[-1]['loss']:.3f} — simulating node failure...")
    del t1  # "crash"

    t2 = Trainer(cfg, dc, oc, TrainerConfig(steps=args.steps,
                                            ckpt_dir=ckpt_dir,
                                            ckpt_every=25),
                 device=args.device)
    print(f"[phase 2] auto-resumed at step {t2.step}")
    hist = t2.run()
    for h in hist[:: max(1, len(hist) // 8)]:
        print(f"  step {h['step']:4d}  loss {h['loss']:.4f}")
    print(f"final loss {hist[-1]['loss']:.4f} "
          f"(started near ln(V)={math.log(cfg.vocab_size):.2f})")

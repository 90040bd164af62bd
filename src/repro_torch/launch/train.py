"""Training launcher of the PyTorch/CUDA port.

    python -m repro_torch.launch.train --arch qwen3-1.7b --smoke --steps 20

--smoke uses the reduced config (CPU-runnable); otherwise the full config.
Trains on the card (``--device cpu`` trains on the CPU). Auto-resumes from
--ckpt-dir. The reference's --mesh and --devices (a sharded mesh, fake host
devices) wait on the port's sharding layer and exit with an error.
``main(argv)`` runs the launcher in-process and returns its trainer.
"""
import argparse

NO_MESH = ("{} needs the sharding layer (dist/sharding, launch/mesh), which "
           "the port does not have yet (ROADMAP.md queue 1 item 5)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mesh", default=None,
                    help="comma dims, e.g. 2,4 = (data=2, model=4); not "
                         "ported")
    ap.add_argument("--devices", type=int, default=0,
                    help="fake host devices (CPU testing only); not ported")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.mesh:
        ap.error(NO_MESH.format("--mesh"))
    if args.devices:
        ap.error(NO_MESH.format("--devices"))

    from ..configs import get_config, smoke_config
    from ..train import AdamWConfig, DataConfig, Trainer, TrainerConfig

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch, mode="pattern")
    tr = Trainer(cfg, dc,
                 AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                             total_steps=args.steps),
                 TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                               compress_grads=args.compress_grads),
                 device=args.device)
    hist = tr.run()
    for h in hist[:: max(1, len(hist) // 10)]:
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}  {h['time_s']*1e3:.0f} ms")
    print(f"final loss {hist[-1]['loss']:.4f}; "
          f"stragglers flagged: {len(tr.straggler_events)}")
    return tr


if __name__ == "__main__":
    main()

"""Training launcher of the PyTorch/CUDA port.

    python -m repro_torch.launch.train --arch qwen3-1.7b --smoke --steps 20
    python -m repro_torch.launch.train --arch qwen3-1.7b --smoke --mesh 2,2 \\
        --devices 4 --device cpu

--smoke uses the reduced config (CPU-runnable); otherwise the full config.
Trains on the card (``--device cpu`` trains on the CPU). Auto-resumes from
--ckpt-dir.

--devices N starts N local ranks, one process each: gloo on the CPU; on
the card only N = 1 (an NCCL group of one), since NCCL cannot put two
ranks on one GPU. --mesh d0,d1[,d2] shards the trainer over a (data,
model) or (pod, data, model) mesh whose dims multiply to the world size;
without --devices it needs a group of one rank (in-process) or a
``torchrun`` launch. --devices without --mesh trains unsharded on every
rank, as the reference does. Rank 0 prints the reference's lines.
``main(argv)`` runs the launcher in-process and returns its trainer (rank
0's loss history when it started ranks of its own).
"""
import argparse
import os
import sys

import numpy as np


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mesh", default=None,
                    help="comma dims, e.g. 2,4 = (data=2, model=4)")
    ap.add_argument("--devices", type=int, default=0,
                    help="local ranks to start (gloo on the CPU; 1 on the "
                         "card)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def _mesh_dims(text):
    dims = tuple(int(x) for x in text.split(","))
    axes = ("data", "model")[:len(dims)] if len(dims) <= 2 else \
        ("pod", "data", "model")
    return dims, axes


def _train(args, rank: int = 0):
    """Build the trainer (on the mesh, if any), train, and print on rank
    0. Returns the trainer."""
    from ..configs import get_config, smoke_config
    from ..train import AdamWConfig, DataConfig, Trainer, TrainerConfig
    from .mesh import make_mesh

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    mesh = make_mesh(*_mesh_dims(args.mesh)) if args.mesh else None
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch, mode="pattern")
    tr = Trainer(cfg, dc,
                 AdamWConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                             total_steps=args.steps),
                 TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                               compress_grads=args.compress_grads),
                 mesh=mesh, device=args.device)
    hist = tr.run()
    if rank == 0:
        for h in hist[:: max(1, len(hist) // 10)]:
            print(f"step {h['step']:5d}  loss {h['loss']:.4f}  {h['time_s']*1e3:.0f} ms")
        print(f"final loss {hist[-1]['loss']:.4f}; "
              f"stragglers flagged: {len(tr.straggler_events)}", flush=True)
    return tr


def _rank_main(rank, argv):
    return _train(_parser().parse_args(argv), rank).history


def main(argv=None):
    ap = _parser()
    args = ap.parse_args(argv)
    backend = "gloo" if args.device == "cpu" else "nccl"
    if args.devices:
        if args.device == "cuda" and args.devices != 1:
            ap.error(f"--devices {args.devices} on the card: NCCL cannot put "
                     "two ranks on one GPU; use --devices 1, or --device "
                     "cpu for gloo ranks")
        if args.mesh and int(np.prod(_mesh_dims(args.mesh)[0])) != \
                args.devices:
            ap.error(f"--mesh {args.mesh} needs "
                     f"{int(np.prod(_mesh_dims(args.mesh)[0]))} ranks; "
                     f"--devices gives {args.devices}")
        from .mesh import run_local
        return run_local(args.devices, _rank_main,
                         list(sys.argv[1:] if argv is None else argv),
                         backend=backend)[0]
    if args.mesh:
        import torch.distributed as dist
        from .mesh import local_group
        n = int(np.prod(_mesh_dims(args.mesh)[0]))
        if "WORLD_SIZE" in os.environ and not dist.is_initialized():
            if backend == "nccl":                  # torchrun's environment
                import torch
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(backend)
            try:
                return _train(args, dist.get_rank())
            finally:
                dist.destroy_process_group()
        if n != 1:
            ap.error(f"--mesh {args.mesh} needs {n} ranks: pass --devices "
                     f"{n} (or launch with torchrun)")
        with local_group(backend):
            return _train(args)
    return _train(args)


if __name__ == "__main__":
    main()

"""The port's model steps on a (data=2, model=2) mesh of 4 gloo ranks,
held by ``tests/test_torch_sharded_steps.py`` against the same steps with
no mesh: ``python _torch_dist_steps.py OUT`` (a subprocess, so that no
process group outlives it) writes a pickle of, per smoke config, each
rank's sharded results (``full_tensor()``) beside rank 0's unsharded ones.

Per config: the forward's logits, the loss and every gradient leaf, and,
for the configs with a cache the decode step places on the mesh, one
decode step's logits and the written cache, from a cache of seeded noise
placed by the dry run's rules (the prefix layer's cache one dim off, as
the reference's rule places it). The decode step also runs on a
(data=1, model=4) mesh, where qwen3's 2 KV heads do not divide "model"
and its cache is split on the sequence instead. whisper's frames and
encoder output and the VLM's image features are seeded noise on the
tokens' rows; the VLM's cross gates are opened to 0.5 (zeros at init
hide its cross layers). Those two and zamba2 run in f64: their smoke
stacks amplify rounding (one device's own f32 step sits 1.5e-3 (logits)
and 1.4e-2 (gradients) from its f64 step on the VLM, 1.7e-4 and 6.1e-4
on whisper, relative to each tensor's largest value; on zamba2 one
device's f32 forward moves its logits by 7.0e-5 when each mamba layer's
output product is summed as two partial products, as the head split
sums them over "model", and by 5.1e-5 from a 1e-7 relative change of
the first mamba layer's output, most of it through the shared attention
block), so in f32 the ranks' other summation order alone would move
them past ``TOL``. ``tests/test_torch_mamba_heads.py`` holds one mamba
layer under the head split in f32.
"""
import pickle
import sys

MESH = (2, 2)
SEQ_MESH = (1, 4)             # the decode's cache split on the sequence
B, S, SEED = 4, 16, 3
ARCHS = {"qwen3-1.7b": True, "deepseek-v2-236b": True,
         "zamba2-1.2b": True, "whisper-small": True,
         "llama-3.2-vision-90b": True, "rwkv6-7b": True,
         "whisper-small/v513": False}  # case: decode
# a case "<arch>/v<n>" is the arch's smoke config with a vocabulary of n,
# which "model" does not divide: the loss takes the whole-vocabulary NLL on
# each rank's rows
F64 = ("whisper-small", "llama-3.2-vision-90b", "zamba2-1.2b")


def _whole(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach()


def _steps(cfg, params, tokens, labels, cache, decode, ctx, train=True):
    """(logits, loss, grads, decode logits, cache after) of one config on
    whatever placements its inputs have; ``ctx`` holds the context
    tensors (``frames``, ``enc_out``, ``vision``)."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.train.tree import leaves
    out = {}
    if train:
        out = _train_steps(cfg, params, tokens, labels,
                           {k: v for k, v in ctx.items() if k != "enc_out"})
    if decode:
        extra = {k: v for k, v in ctx.items() if k != "frames"}
        with torch.no_grad():
            dl, c = tf.decode_step(params, cfg, tokens[:, :1], cache, S - 1,
                                   ctx_extra=extra or None)
        out["decode"] = _whole(dl).numpy()
        out["cache"] = [_whole(x).numpy() for x in leaves(c)]
    return out


def _train_steps(cfg, params, tokens, labels, ctx):
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.train.tree import leaves
    logits, _ = tf.forward(params, cfg, dict(ctx, tokens=tokens))
    loss, _ = tf.loss_fn(params, cfg, dict(ctx, tokens=tokens,
                                           labels=labels))
    # whisper's cross gate takes no part (its cross layers are ungated)
    grads = torch.autograd.grad(loss, leaves(params), allow_unused=True,
                                materialize_grads=True)
    return {"logits": _whole(logits).numpy(), "loss": float(_whole(loss)),
            "grads": [_whole(g).numpy() for g in grads]}


def rank_main(rank):
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.dist.sharding import PSpec, distribute, param_pspecs
    from repro_torch.dist.sharding import use_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import batch_pspec, cache_pspecs
    from repro_torch.models import transformer as tf
    from repro_torch.train.tree import leaves, leaves_with_paths, unflatten
    torch.manual_seed(SEED)
    meshes = {"2x2": make_mesh(MESH, ("data", "model")),
              "1x4": make_mesh(SEQ_MESH, ("data", "model"))}
    res = {}
    for case, decode in ARCHS.items():
        arch, _, vocab = case.partition("/v")
        fl = "float64" if arch in F64 else "float32"
        cfg = smoke_config(arch).replace(param_dtype=fl,
                                         activation_dtype=fl)
        if vocab:
            cfg = cfg.replace(vocab_size=int(vocab))
        params = tf.init_params(cfg, SEED, "cpu")
        if cfg.vision:
            params = unflatten(params, [
                torch.full_like(x, 0.5) if path[-1] == "gate" else x
                for path, x in leaves_with_paths(params)])
        for p in leaves(params):
            p.requires_grad_(True)
        g = torch.Generator().manual_seed(SEED)
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
        cache = None
        if decode:
            cache = tf.init_cache(cfg, B, S, device="cpu")
            cache = unflatten(cache, [torch.randn(x.shape, generator=g)
                                      .to(x.dtype) for x in leaves(cache)])
        labels = tokens.roll(-1, 1)
        ctx = {}
        if cfg.encoder:
            for k in ("frames", "enc_out"):
                ctx[k] = torch.randn(B, cfg.encoder.num_frames, cfg.d_model,
                                     generator=g).to(tf.dt(fl))
        if cfg.vision:
            ctx["vision"] = torch.randn(B, cfg.vision.num_tokens,
                                        cfg.vision.vision_dim,
                                        generator=g).to(tf.dt(fl))
        want = _steps(cfg, params, tokens, labels,
                      unflatten(cache, [x.clone() for x in leaves(cache)])
                      if decode else None, decode, ctx)
        got = {}
        for name, mesh in meshes.items():
            if name != "2x2" and not decode:
                continue
            with use_mesh(mesh):
                sp = distribute(params, param_pspecs(params, mesh))
                for p in leaves(sp):
                    p.requires_grad_(True)
                rows = PSpec(mesh, (batch_pspec(mesh, B),))
                tok, lab = distribute(tokens, rows), distribute(labels, rows)
                sc = (distribute(cache, cache_pspecs(cache, mesh))
                      if decode else None)
                sctx = {k: distribute(v, rows) for k, v in ctx.items()}
                got[name] = _steps(cfg, sp, tok, lab, sc, decode, sctx,
                                   train=name == "2x2")
        res[case] = {"got": got, "want": want if rank == 0 else None}
    return res


if __name__ == "__main__":
    from repro_torch.launch.mesh import run_local
    out = run_local(MESH[0] * MESH[1], rank_main, threads=1)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)

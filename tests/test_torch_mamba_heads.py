"""One zamba2 mamba2 layer (``transformer.py::_mamba_layer``) under a mesh
splits its heads over "model", where XLA's compiled program places the
reference's: on a (data=2, model=2) and a (data=1, model=4) mesh of 4
gloo ranks, each rank's scan runs H / model of the smoke config's H = 8
heads (every head on every rank before the split), and the layer gives
what it gives with no mesh, in f32 within ``TOL``: its output and the
gradient of a seeded projection of it with respect to the input and to
every weight, and one decode step's output and written state and conv
window, from a seeded cache placed as the reference's rule places a
prefix layer's (one dim off: rows whole, the state split on N, the
window on its channels) and a period's (rows, the state split on the
heads, the window on its channels).

``python tests/test_torch_mamba_heads.py OUT`` runs the ranks (a
subprocess of the test, so that no process group outlives it) and writes
a pickle of each rank's results.
"""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
B, T, SEED = 4, 16, 5
# f32 sums over the heads' partial products in another order than one
# device's whole product
TOL = 2e-5


def _whole(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach()


def _layer_steps(cfg, p, x, proj, cache):
    """(output, gradients of ``(out * proj).sum()`` w.r.t. x and each
    weight, decode output, state and conv after it) of one mamba layer on
    whatever placements its inputs have."""
    import torch
    from repro_torch.models import transformer as tf
    from repro_torch.train.tree import leaves
    y = tf._mamba_layer(p, x, cfg)
    grads = torch.autograd.grad((y * proj).sum(), [x] + leaves(p))
    with torch.no_grad():
        yd = tf._mamba_layer(p, x[:, :1].detach(), cfg, cache)
    return {"out": _whole(y).numpy(),
            "grads": [_whole(g).numpy() for g in grads],
            "decode": _whole(yd).numpy(),
            "cache": {k: _whole(v).numpy() for k, v in cache.items()}}


def rank_main(rank):
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.dist.sharding import (PSpec, distribute, param_pspecs,
                                           use_mesh)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import batch_pspec, cache_pspecs
    from repro_torch.models import ssm as ssmm
    from repro_torch.models import transformer as tf
    from repro_torch.train.tree import leaves, unflatten
    cfg = smoke_config("zamba2-1.2b").replace(param_dtype="float32",
                                              activation_dtype="float32")
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H, N, P = d_in // s.head_dim, s.state_dim, s.head_dim
    rng = np.random.default_rng(SEED)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    p = tf.init_params(cfg, SEED, "cpu")["prefix"][0]
    # nonzero norm scales and per-head decays, so that a head or channel
    # out of place shows
    p = unflatten(p, [x + 0.3 * draw(*x.shape) for x in leaves(p)])
    x, proj = draw(B, T, cfg.d_model), draw(B, T, cfg.d_model)
    cache = {"state": draw(B, H, N, P),
             "conv": draw(B, s.conv_dim - 1, d_in + 2 * N)}
    # each scan's heads, as the rank runs it
    heads = []
    scan = ssmm._scan

    def spy(q, *a, **k):
        heads.append(q.shape[2])
        return scan(q, *a, **k)

    ssmm._scan = spy
    want = _layer_steps(cfg, unflatten(p, [w.clone().requires_grad_(True)
                                           for w in leaves(p)]),
                        x.clone().requires_grad_(True), proj,
                        {k: v.clone() for k, v in cache.items()})
    res = {"want": want, "want_heads": heads[:]}
    for name, dims in MESHES.items():
        mesh = make_mesh(dims, ("data", "model"))
        rows = PSpec(mesh, (batch_pspec(mesh, B),))
        # the prefix layer's cache placement, and a period's (its stacked
        # leaves' placement past the layer dim)
        stacked = cache_pspecs({k: v[None] for k, v in cache.items()}, mesh)
        for where, specs in (
                ("prefix", cache_pspecs(cache, mesh)),
                ("period", {k: PSpec(mesh, v.spec[1:])
                            for k, v in stacked.items()})):
            heads.clear()
            with use_mesh(mesh):
                sp = distribute(p, param_pspecs(p, mesh))
                for w in leaves(sp):
                    w.requires_grad_(True)
                sx = distribute(x, rows).requires_grad_(True)
                got = _layer_steps(cfg, sp, sx, distribute(proj, rows),
                                   distribute(cache, specs))
            res[f"{name}/{where}"] = dict(got, heads=heads[:])
    return res


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    here = os.path.dirname(os.path.abspath(__file__))
    out = tmp_path_factory.mktemp("mamba_heads") / "out.pkl"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(here, "..", "src"))
    p = subprocess.run([sys.executable, os.path.abspath(__file__), str(out)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= TOL, f"{what}: max|got - want| / max|want| = {err:.3e}"


CASES = [f"{m}/{w}" for m in MESHES for w in ("prefix", "period")]


@pytest.mark.parametrize("case", CASES)
def test_each_rank_scans_its_heads(ranks, case):
    """Without a mesh the scan runs all 8 heads; under the mesh each rank's
    runs 8 / model, in the forward step, its recomputation in the backward
    pass and the decode step alike."""
    model = MESHES[case.split("/")[0]][1]
    assert set(ranks[0]["want_heads"]) == {8}
    for rank in ranks:
        assert rank[case]["heads"], case
        assert set(rank[case]["heads"]) == {8 // model}, case


@pytest.mark.parametrize("case", CASES)
def test_layer_matches_no_mesh(ranks, case):
    want = ranks[0]["want"]
    for rank in ranks:
        got = rank[case]
        _close(got["out"], want["out"], f"{case} out")
        assert len(got["grads"]) == len(want["grads"])
        for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
            _close(g, w, f"{case} grad {i}")
        _close(got["decode"], want["decode"], f"{case} decode")
        for k in want["cache"]:
            _close(got["cache"][k], want["cache"][k], f"{case} cache {k}")


if __name__ == "__main__":
    from repro_torch.launch.mesh import run_local
    out = run_local(4, rank_main, threads=1)
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)

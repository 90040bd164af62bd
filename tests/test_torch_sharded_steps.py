"""The port's model steps under the explicit placements of
``repro_torch.dist.sharding`` (attention with every head on every rank,
the MLP split on its hidden, vocab-sharded logits and loss, the
sequence-split decode over the dry run's cache placement, MoE and SSM
layers on local tensors) give, on a (data=2, model=2) mesh of 4 gloo
ranks, what the same steps give with no mesh: the forward's logits, the
loss and every gradient leaf for qwen3, deepseek-v2, zamba2, whisper,
llama-3.2-vision and rwkv6 smoke configs in f32, and one decode step's
logits and written cache for each (deepseek-v2's dense prefix layer's
cache the reference's rule places one dim off: rows whole, sequence and
latent split), on that mesh (qwen3's cache split on its KV
heads) and on (data=1, model=4) (split on the sequence). whisper and the
VLM run their cross-attention (and whisper its encoder) on stated
placements, rwkv6 its head-parallel layer, its cache's state split on
the heads, zamba2's mamba layers theirs (each rank's scan on its heads,
its cache's state stepped on them, the conv window gathered for the
step; in f64, as whisper and the VLM, ``tests/_torch_dist_steps.py``
says why). whisper also
runs with a vocabulary of 513 ("whisper-small/v513"), which "model" does
not divide, so each rank's rows take the whole-vocabulary NLL
(``transformer.py::_BlockedNll``). All four ranks return the same whole
tensors.
``tests/_torch_dist_steps.py`` runs the ranks in a subprocess."""
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

# f32 sums over the ranks' shards in another order than one device's sum
TOL = 2e-5


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    here = os.path.dirname(os.path.abspath(__file__))
    out = tmp_path_factory.mktemp("steps") / "out.pkl"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(here, "..", "src"))
    p = subprocess.run([sys.executable,
                        os.path.join(here, "_torch_dist_steps.py"), str(out)],
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


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-236b",
                                  "zamba2-1.2b", "whisper-small",
                                  "llama-3.2-vision-90b", "rwkv6-7b",
                                  "whisper-small/v513"])
def test_sharded_forward_loss_grads_match_unsharded(steps, arch):
    want = steps[0][arch]["want"]
    for rank in steps:
        got = rank[arch]["got"]["2x2"]
        _close(got["logits"], want["logits"], f"{arch} logits")
        _close(got["loss"], want["loss"], f"{arch} loss")
        assert len(got["grads"]) == len(want["grads"])
        for i, (g, w) in enumerate(zip(got["grads"], want["grads"])):
            _close(g, w, f"{arch} grad leaf {i}")


@pytest.mark.parametrize("mesh", ["2x2", "1x4"])
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-236b",
                                  "zamba2-1.2b", "whisper-small",
                                  "llama-3.2-vision-90b", "rwkv6-7b"])
def test_sharded_decode_matches_unsharded(steps, arch, mesh):
    want = steps[0][arch]["want"]
    for rank in steps:
        got = rank[arch]["got"][mesh]
        _close(got["decode"], want["decode"], f"{arch} decode logits")
        assert len(got["cache"]) == len(want["cache"])
        for i, (c, w) in enumerate(zip(got["cache"], want["cache"])):
            _close(c, w, f"{arch} cache leaf {i}")

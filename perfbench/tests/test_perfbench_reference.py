"""The plain reference against the program's model at smoke size, one
smoke model for each model the configurations serve (its norm, head,
MLP and head ratio kept), in float32 on the CPU."""
import json
from pathlib import Path

import pytest
import torch

from perfbench import weights
from perfbench.reference import dense
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _smoke_archs():
    out = {}
    for f in sorted(CONFIGS.glob("*.json")):
        conf = json.loads(f.read_text())
        for cls in ("ls", "be"):
            m = conf[cls]
            a = dict(m["arch"])
            g = a["num_heads"] // a["num_kv_heads"]
            kv = 1 if g > 2 else 2
            a.update(num_layers=2, d_model=96, head_dim=16, d_ff=160,
                     vocab_size=300, num_kv_heads=kv, num_heads=kv * g)
            out[m["model"]] = a
    return out


ARCHS = _smoke_archs()


def _program_logits(arch, params, tokens):
    cfg = ModelConfig(name="smoke", family="dense",
                      activation_dtype="float32", **arch)
    with torch.no_grad():
        return tf.forward(params, cfg, {"tokens": tokens[None]})[0][0]


@pytest.mark.parametrize("model", sorted(ARCHS))
def test_reference_matches_the_program(model):
    arch = ARCHS[model]
    params = weights.make(arch, 2 ** 31 + 3, 0, "cpu", torch.float32)
    tokens = torch.randint(0, arch["vocab_size"], (40,),
                           generator=torch.Generator().manual_seed(0))
    got = _program_logits(arch, params, tokens)
    want = dense.logits_at(params, arch, [tokens], [range(40)])[0]
    rel = ((got - want).norm() / want.norm()).item()
    # two float32 forwards of one model in other summation orders
    assert rel < 1e-5, rel
    low = dense.logits_at(params, arch, [tokens], [range(40)], "float8")[0]
    assert ((low - want).norm() / want.norm()).item() > 1e-2


def test_reference_reads_norm_scales():
    """The weights' gammas are not zero, so the (1 + gamma) form shows."""
    arch = ARCHS["qwen3-1.7b"]
    params = weights.make(arch, 5, 0, "cpu", torch.float32)
    gam = params["layers"]["s0"]["ln1"]
    assert gam.abs().max() > 0.05
    tokens = torch.arange(12)
    want = dense.logits_at(params, arch, [tokens], [range(12)])[0]
    params["layers"]["s0"]["ln1"].zero_()
    moved = dense.logits_at(params, arch, [tokens], [range(12)])[0]
    assert (moved - want).abs().max() > 1e-3

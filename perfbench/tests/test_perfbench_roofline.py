"""The yardstick against bytes and operations counted by hand."""
import pytest

from perfbench import roofline as R

ARCH = {"num_layers": 2, "d_model": 8, "num_heads": 4, "num_kv_heads": 2,
        "head_dim": 2, "d_ff": 16, "vocab_size": 10, "mlp_act": "swiglu"}


def test_prefill_attention_work():
    # two rows of a 3-token chunk at 0 and 5; H 4, Hkv 2, D 2, bf16
    nbytes, flops = R.prefill_attn_work([0, 5], 3, 4, 2, 2, 2)
    # K and V of 3 and 8 keys, 2 KV heads of 2 dims; q and out of 3 rows
    assert nbytes == ((2 * 3 * 2 * 2 + 2 * 3 * 4 * 2)
                      + (2 * 8 * 2 * 2 + 2 * 3 * 4 * 2)) * 2
    # visible pairs: 1 + 2 + 3 and 6 + 7 + 8; 4 * D per pair and head
    assert flops == 4 * 2 * 4 * (6 + 21)


def test_decode_attention_work():
    nbytes, flops = R.decode_attn_work([0, 9], 4, 2, 2, 2)
    assert nbytes == ((2 * 1 * 2 * 2 + 2 * 4 * 2)
                      + (2 * 10 * 2 * 2 + 2 * 4 * 2)) * 2
    assert flops == 4 * 2 * 4 * (1 + 10)


def test_model_operations_and_bytes():
    # q 8x8, k and v 8x4 each, o 8x8, swiglu 3 x 8x16: 576 a layer
    assert R.layer_matmul_params(ARCH) == 64 + 32 + 32 + 64 + 384
    per_tok = 2 * 576 * 2
    # one row at 4 with 2 tokens: pairs 5 + 6, head once
    assert R.prefill_flops(ARCH, [4], 2) == \
        per_tok * 2 + 2 * 8 * 10 + 4 * 2 * 4 * 2 * 11
    assert R.decode_flops(ARCH, [0, 3]) == \
        2 * (per_tok + 2 * 8 * 10) + 4 * 2 * 4 * 2 * (1 + 4)
    assert R.decode_bytes(ARCH, [0, 3], 2) == \
        (576 * 2 + 80 + 2 * 2 * 2 * 2 * (1 + 4)) * 2


def test_bound_takes_the_longer():
    assert R.bound_s(3.35e12, 0.0, "bfloat16") == pytest.approx(1.0)
    assert R.bound_s(0.0, 989e12, "bfloat16") == pytest.approx(1.0)
    assert R.bound_s(3.35e9, 989e12, "bfloat16") == pytest.approx(1.0)

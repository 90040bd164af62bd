"""The harness driven end to end on the CPU (the look for a card
skipped), at a tiny size: a sound run is correct, the timed path broken
underneath is not, and the float8 control fails the check."""
import json
import os
import subprocess
import sys

import pytest
import torch

from perfbench.catalog import Catalog
from perfbench.harness import run_cell
from perfbench.tests import tiny
from repro_torch.models import attention
from repro_torch.models import transformer as tf

# the tiny cell's limit: its sound runs read 0 to 0.01 on the CPU, the
# float8 control 0.04 to 0.29 over 24 tokens
LIMIT = 0.05


@pytest.fixture(scope="module")
def cat(tmp_path_factory):
    cell = dict(tiny.CELL, check=dict(tiny.CELL["check"],
                                      ls_logit_gap=LIMIT,
                                      be_logit_gap=LIMIT))
    return Catalog(tiny.make_root(tmp_path_factory.mktemp("pb"), cell))


def test_sound_run_is_correct(cat):
    res, run = run_cell(cat, "tiny.cell", 2 ** 31 + 77, 2, True,
                        device="cpu")
    assert res["correct"], res["checks"]
    # on a loaded CPU a request may miss the drain's cap: timing, not output
    assert res["attempted"] > 0
    # a host metric is read where its calls ended in the window
    tl, tr = run.timeline, run.trace
    for name, cls, kind in (("prefill_pad_share.ls", "LS", "prefill"),
                            ("prefill_pad_share.be", "BE", "prefill"),
                            ("mfu.decode", "LS", "decode")):
        assert (name in res["metrics"]) == bool(tr.in_window(tl, cls, kind))
    assert tr.calls
    # no card: nothing device-side to read, and nothing made up
    assert "prefill_attn.roofline" not in res["metrics"]
    assert json.loads(json.dumps(res)) == res


def test_altered_token_is_caught(cat, monkeypatch):
    """A token altered where it is produced: every 5th decode step puts
    the runner-up first in each row."""
    real, calls = tf.decode_step, [0]

    def altered(*a, **kw):
        logits, cache = real(*a, **kw)
        calls[0] += 1
        if calls[0] % 5 == 0:
            top2 = logits[:, 0].topk(2, dim=-1).indices[:, 1]
            logits = logits.clone()
            logits[torch.arange(len(top2)), 0, top2] = 1e4
        return logits, cache

    monkeypatch.setattr(tf, "decode_step", altered)
    res, _ = run_cell(cat, "tiny.cell", 5, 1, False, device="cpu")
    assert not res["correct"], res["checks"]


def test_state_left_unchanged_is_caught(cat, monkeypatch):
    """A decode step that leaves the cache as it was: its K/V never
    written."""
    real = attention._page_write

    def dropped(pages_a, pages_b, phys, off, a, b):
        if a.shape[1] != 1:
            real(pages_a, pages_b, phys, off, a, b)

    monkeypatch.setattr(attention, "_page_write", dropped)
    res, _ = run_cell(cat, "tiny.cell", 6, 1, False, device="cpu")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_float8_control_fails_the_check(cat, seed):
    # more served tokens than a sound run's check reads: at this size a
    # sample of 24 now and then holds no token float8 puts elsewhere
    check = dict(cat.cell("tiny.cell")["cell"]["check"], min_tokens=96)
    res, run = run_cell(cat, "tiny.cell", seed, 2, False, device="cpu",
                        control=True, override={"check": check})
    gaps = run.extra["gaps"]
    assert res["correct"]
    assert max(g["served"] for g in gaps.values()) <= LIMIT
    assert max(g["control"] for g in gaps.values()) > LIMIT


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, str(tiny.REPO / "perfbench" /
                                            "run.py"),
                        "--workload", "qwen3-stablelm.docqa", "--seed", "1",
                        "--seconds", "1"], capture_output=True, text=True,
                       env=env, cwd=tiny.REPO, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and perfbench/."""
    import shutil
    shutil.copy(tiny.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(tiny.REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "qwen3-stablelm.docqa", "--seed", "1", "--seconds",
                        "1"], capture_output=True, text=True, cwd=tmp_path,
                       env=dict(os.environ, PYTHONPATH=""), timeout=120)
    assert p.returncode != 0 and p.stdout == ""

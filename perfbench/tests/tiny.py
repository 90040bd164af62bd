"""A throwaway catalog beside the real one: the repository's
``BENCHMARK.json`` and metric readers, with one cell of tiny models that
the CPU runs in seconds."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

ARCH_LS = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
           "head_dim": 16, "d_ff": 128, "vocab_size": 256, "qk_norm": True,
           "tie_embeddings": True, "mlp_act": "swiglu",
           "rope_theta": 1000000.0, "norm_eps": 1e-06}
ARCH_BE = {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 4,
           "head_dim": 16, "d_ff": 96, "vocab_size": 300, "qk_norm": False,
           "tie_embeddings": False, "mlp_act": "sq_relu",
           "rope_theta": 10000.0, "norm_eps": 1e-06}
CONFIG = {"name": "tiny", "deployment": "CPU tests", "dtype": "bfloat16",
          "slots": {"ls": 4, "be": 2},
          "engine": {"paged": True, "page_size": 16, "use_flash": True,
                     "chunk_size": 32, "max_seq": 256, "sm_be": 0.3,
                     "ch_be": 1 / 3, "prefill_budget": None},
          "ls": {"model": "tiny-ls", "arch": ARCH_LS},
          "be": {"model": "tiny-be", "arch": ARCH_BE}}
MIX = {"why": "tiny", "block_s": 0.5,
       "ls": {"prompt": {"dist": "uniform", "lo": 20, "hi": 90},
              "output": {"dist": "uniform", "lo": 3, "hi": 10}},
       "be": {"prompt": {"dist": "uniform", "lo": 20, "hi": 70},
              "output": {"dist": "uniform", "lo": 3, "hi": 8}}}
CELL = {"ls_rate": 6.0, "limits": {"ttft_ms": 1e5, "tpot_ms": 1e5},
        "preroll_s": 0.3, "drain_cap_s": 60,
        "profile": {"start_s": 0.2, "seconds": 0.5},
        "check": {"min_tokens": 24, "ls_logit_gap": 0.25,
                  "be_logit_gap": 0.25}}


def make_root(tmp: Path, cell: dict = CELL) -> Path:
    """A repository root under ``tmp`` whose catalog has the cell
    ``tiny.cell`` (config ``tiny``, traffic ``tiny``) beside the real
    entries, and the real metric readers."""
    root = Path(tmp)
    pb = root / "perfbench"
    for d in ("configs", "workloads", "traffic"):
        (pb / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "perfbench" / "metrics", pb / "metrics",
                    dirs_exist_ok=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "tests",
                             "file": "perfbench/configs/tiny.json",
                             "reduced": [], "why": "tests"})
    bench["workloads"].append({"name": "tiny.cell", "config": "tiny",
                               "traffic": "tiny", "chips": 1,
                               "why": "tests"})
    for m in bench["per_layer"] + bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("tiny.cell")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (pb / "configs" / "tiny.json").write_text(json.dumps(CONFIG))
    (pb / "traffic" / "tiny.json").write_text(json.dumps(MIX))
    (pb / "workloads" / "tiny.cell.json").write_text(json.dumps(cell))
    return root

"""What the tools share: the paths, the caches and the output file."""
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def setup():
    """The program's sources and the benchmark on the path, the caches in
    the checkout (as ``run.py`` sets them); returns the catalog."""
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    cache = ROOT / "build" / "cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    from perfbench.catalog import Catalog
    return Catalog(ROOT)


def emit(path, rec: dict):
    """One JSON line to standard output and appended to ``path``."""
    line = json.dumps(rec)
    print(line, flush=True)
    if path:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "a") as f:
            f.write(line + "\n")

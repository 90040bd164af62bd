#!/usr/bin/env python3
"""Compare one kernel source's PTX and SASS, and its build time, between
two trees.

Builds ``src/repro_torch/kernels/csrc/<source>.cu`` of the tree BEFORE and
of the tree AFTER (default: this repository) with nvcc, all at once: PTX
(``nvcc -ptx``, the flags
of ``repro_torch.kernels._build`` less those of the shared library) and the
shared library itself (those flags exactly, its ptxas register report kept),
into ``build/ptx_compare/``. Then it takes every ``.entry`` whose name holds
``--entry`` and compares each of AFTER's with BEFORE's of the same name,
after ``--drop`` is taken out of AFTER's names (a template argument that
BEFORE's instantiation did not have), each entry's own name is taken out
of its text (the parameter names carry it), comment lines and trailing
blank lines are dropped and its branch labels are renumbered from the
entry alone (``$L__BB<f>_<n>``: nvcc numbers f by the function's place in
the file, which moves when other instantiations come or go); and the
same pair's machine code (``cuobjdump -sass -fun``) of the two shared
libraries, the name taken out likewise.
Entries that AFTER has and BEFORE has not are listed as new.

Run from the repository root on a machine with nvcc, BEFORE being the root
of another checkout (``git archive`` of the parent into ``build/``):

    python3 tools/ptx_compare.py BEFORE [--after DIR]
        [--source prefill_attention] [--entry prefill_wgmma_kernel]
        [--drop 13__nv_bfloat16]

Prints, per entry of BEFORE: PTX and SASS identical or not (with the first
differing lines); the new entries; each tree's shared-library build
seconds and ptxas registers and spills by entry. Exits 1 if an entry's
PTX differs or it is missing.
"""
from __future__ import annotations

import argparse
import difflib
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
CSRC = Path("src/repro_torch/kernels/csrc")
OUT = ROOT / "build" / "ptx_compare"
ENTRY = re.compile(r"^\.(?:visible|weak) \.entry (\S+)\(", re.M)
LABEL = re.compile(r"\$L__BB\d+_")
COMMENT = re.compile(r"^\s*//.*\n", re.M)


def entries(ptx: str, part: str) -> dict:
    """name -> text of every ``.entry`` whose name holds ``part``, with
    the name itself replaced by ``ENTRY``, comment lines dropped and the
    function's number taken out of its branch labels."""
    found = {}
    starts = list(ENTRY.finditer(ptx))
    for i, m in enumerate(starts):
        name = m.group(1)
        if part not in name:
            continue
        end = starts[i + 1].start() if i + 1 < len(starts) else len(ptx)
        text = COMMENT.sub("", ptx[m.start():end].replace(name, "ENTRY"))
        found[name] = LABEL.sub("$L__BB_", text).rstrip() + "\n"
    return found


def ptxas_report(log: str) -> list:
    """(entry, registers and spills) lines of ptxas' verbose report."""
    lines, entry = [], ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "registers" in line or "spill" in line:
            lines.append(f"{entry}: {line.split(':', 1)[-1].strip()}")
    return lines


def run(cmd):
    """(seconds, return code, stdout + stderr) of ``cmd``."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return time.perf_counter() - t0, proc.returncode, \
        proc.stdout + proc.stderr


def sass(lib: Path, name: str) -> str:
    """The machine code of entry ``name`` in ``lib``, the name replaced by
    ``ENTRY``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", "-fun", name, str(lib)],
                         capture_output=True, text=True, check=True).stdout
    return out.replace(name, "ENTRY")


def show_diff(a: str, b: str):
    diff = difflib.unified_diff(a.splitlines(), b.splitlines(), lineterm="",
                                n=1)
    print("\n".join(list(diff)[:40]))


def main() -> int:
    from repro_torch.kernels._build import NVCC_FLAGS, _nvcc
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("before", type=Path)
    ap.add_argument("--after", type=Path, default=ROOT)
    ap.add_argument("--source", default="prefill_attention")
    ap.add_argument("--entry", default="prefill_wgmma_kernel")
    ap.add_argument("--drop", default="13__nv_bfloat16")
    args = ap.parse_args()
    OUT.mkdir(parents=True, exist_ok=True)
    ptx_flags = [f for f in NVCC_FLAGS
                 if f not in ("-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")]
    cmds = {}
    for tag, root in (("before", args.before.resolve()),
                      ("after", args.after.resolve())):
        src = str(root / CSRC / f"{args.source}.cu")
        cmds[tag, "ptx"] = [_nvcc(), *ptx_flags, "-ptx", "-o",
                            str(OUT / f"{tag}.ptx"), src]
        cmds[tag, "so"] = [_nvcc(), *NVCC_FLAGS, "-o",
                           str(OUT / f"{tag}.so"), src]
    with ThreadPoolExecutor(len(cmds)) as pool:
        done = dict(zip(cmds, pool.map(run, cmds.values())))
    secs = {key: t for key, (t, _, _) in done.items()}
    logs = {key: text for key, (_, _, text) in done.items()}
    for key, (_, rc, text) in done.items():
        if rc != 0:
            print(f"nvcc failed ({key}):\n{text}")
            return 1
    old = entries((OUT / "before.ptx").read_text(), args.entry)
    new = entries((OUT / "after.ptx").read_text(), args.entry)
    renamed = {n.replace(args.drop, ""): n for n in new}
    ok = bool(old)
    for name, text in sorted(old.items()):
        mine = renamed.get(name)
        if mine is None:
            print(f"{name}: missing from this tree")
            ok = False
            continue
        same = new[mine] == text
        ok &= same
        print(f"{name} -> {mine}: {'identical' if same else 'DIFFERENT'} "
              f"PTX ({text.count(chr(10))} lines)")
        if not same:
            show_diff(text, new[mine])
        code = sass(OUT / "before.so", name), sass(OUT / "after.so", mine)
        print(f"  SASS {'identical' if code[0] == code[1] else 'DIFFERENT'} "
              f"({code[0].count(chr(10))} lines)")
        if code[0] != code[1]:
            show_diff(*code)
    for mine in sorted(set(new) - {renamed[n] for n in old if n in renamed}):
        print(f"new in this tree: {mine} ({new[mine].count(chr(10))} lines)")
    for tag in ("before", "after"):
        print(f"{tag}: {args.source}.cu shared library {secs[tag, 'so']:.1f}s"
              f" (PTX alone {secs[tag, 'ptx']:.1f}s), both built at once")
        for line in ptxas_report(logs[tag, "so"]):
            print(f"  {line}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

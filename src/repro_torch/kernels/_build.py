"""Build, load and call the CUDA kernels: ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.

Each ``csrc/*.cu`` source becomes one library under ``build/kernels/`` at the
repository root, named by a hash of every source in ``csrc/`` and the flags,
so an edited kernel is rebuilt and an unchanged one is reused. Libraries are
built at first use (``python3 chip_smoke.py`` alone builds them);
:func:`build_all` compiles every source at once, one ``nvcc`` process each,
started together. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("decode_attention", "prefill_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# the one C signature every entry point shares (attention_core.cuh)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
ATTENTION_ARGTYPES = ([_P] * 8 + [_I] * 10 + [_L] * 12
                      + [ctypes.c_float, _P])

_lock = threading.Lock()
_libs: dict = {}
build_logs: dict = {}     # source -> nvcc's stderr (ptxas register report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def _start(name: str):
    out = lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return name, out, tmp, proc


def _finish(name, out, tmp, proc):
    stdout, stderr = proc.communicate()
    build_logs[name] = stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{stdout}{stderr}")
    os.replace(tmp, out)


def build_all() -> float:
    """Compile every source that has no up-to-date library, all in
    parallel. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = [_start(n) for n in SOURCES if not lib_path(n).exists()]
        errors = []
        for job in jobs:
            try:
                _finish(*job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    if not lib_path(name).exists():
        build_all()
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(lib_path(name)))
            fn = getattr(lib, f"sgdrc_{name}")
            fn.argtypes = ATTENTION_ARGTYPES
            fn.restype = ctypes.c_int
            _libs[name] = lib
    return lib


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HEAD_DIMS = (32, 64, 128)


def _i32(x, shape, device, what):
    if x.dtype != torch.int32 or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous() or x.device != device:
        raise ValueError(f"{what}: need contiguous int32 {tuple(shape)} on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    return x.data_ptr()


def launch_attention(name, q, out, k, v, pos, *, abort=None, progress=None,
                     page_table=None, window, page_size=0):
    """Launch ``sgdrc_<name>`` on the current stream. q/out: [B,Sq,H,D]
    (any strides, D contiguous); k/v: [X,Hkv,S,D] views whose first three
    axes are (batch row, kv head, key) for a dense cache or (page, kv head,
    in-page offset) for a pool; pos/abort/progress: int32 [B]; page_table:
    int32 [B,P]. Raises on anything the kernel does not take, and on a
    non-zero ``cudaGetLastError`` after the launch."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: CUDA kernel called on {dev}")
    for t, what in ((out, "out"), (k, "k"), (v, "v")):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"{name}: {what} is {t.dtype} on {t.device}, "
                             f"q is {q.dtype} on {dev}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {what} needs a contiguous last axis")
    if q.stride(-1) != 1:
        raise ValueError(f"{name}: q needs a contiguous last axis")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {q.dtype}")
    B, Sq, H, D = q.shape
    Hkv = k.shape[1]
    if D not in HEAD_DIMS or k.shape[-1] != D or H % Hkv:
        raise ValueError(f"{name}: unsupported heads H={H} Hkv={Hkv} D={D}")
    ptrs = [q.data_ptr(), out.data_ptr(), k.data_ptr(), v.data_ptr(),
            _i32(pos, (B,), dev, "pos"),
            None if abort is None else _i32(abort, (B,), dev, "abort"),
            None if progress is None else _i32(progress, (B,), dev,
                                               "progress"),
            None]
    pt_stride = n_pages = 0
    if page_table is not None:
        ptrs[7] = _i32(page_table, (B, page_table.shape[1]), dev,
                        "page_table")
        pt_stride, n_pages = page_table.shape[1], k.shape[0]
    fn = getattr(load(name), f"sgdrc_{name}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(*ptrs, _DTYPE_CODES[q.dtype], B, Sq, H, Hkv, D, int(window),
             int(page_size), pt_stride, n_pages,
             q.stride(0), q.stride(1), q.stride(2),
             out.stride(0), out.stride(1), out.stride(2),
             k.stride(0), k.stride(1), k.stride(2),
             v.stride(0), v.stride(1), v.stride(2),
             float(D ** -0.5), stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")

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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
# prefill_attention.cu: q, out, k, v, pos, abort, progress, page_table;
# dtype, B, Sq, H, Hkv, D, wgmma (the route), window, page_size, pt_stride,
# n_pages; strides of q, out (b, s, h) and k, v (3 each); scale; stream
ATTENTION_ARGTYPES = [_P] * 8 + [_I] * 11 + [_L] * 12 + [_F, _P]
# decode_attention.cu: q, out, k, v, pos, page_table; dtype, B, H, Hkv, D,
# heads_per_block, window, page_size, pt_stride, n_pages, split, cluster;
# strides of q, out (b, h) and k, v (3 each); scale; stream
DECODE_ARGTYPES = [_P] * 6 + [_I] * 12 + [_L] * 10 + [_F, _P]
# flash_attention.cu: q, k, v, out; dtype, B, S, H, Hkv, D, causal, window,
# wgmma (the route); scale, softcap; stream
FLASH_ARGTYPES = [_P] * 4 + [_I] * 9 + [_F, _F, _P]
# dual_tenant_attention.cu: q, k, v, out of LS then BE; order, ticket;
# dtype, B_ls, B_be, S, H, Hkv, D, n_units, wgmma; scale; stream
DUAL_ATTENTION_ARGTYPES = [_P] * 10 + [_I] * 9 + [_F, _P]
# dual_tenant_matmul.cu: a, b, out of LS then BE; order, ticket; dtype,
# M_ls, M_be, K, N, n_order, wgmma, copy width; stream
DUAL_MATMUL_ARGTYPES = [_P] * 8 + [_I] * 8 + [_P]
# spt_gather.cu: src, dst, spt; n, row bytes, src rows, dst rows; stream
SPT_ARGTYPES = [_P] * 3 + [_L] * 4 + [_P]
# ssd_scan.cu: q, k, v, log_w, y; dtype, wdtype, B, T, H, K, P, L;
# strides (int64[15]); stream
SSD_ARGTYPES = [_P] * 5 + [_I] * 8 + [ctypes.POINTER(_L), _P]
#: source -> {C symbol: (argtypes, restype)}; every source builds one library
ENTRIES = {
    "decode_attention": {"sgdrc_decode_attention": (DECODE_ARGTYPES, _I)},
    "prefill_attention": {
        "sgdrc_prefill_attention": (ATTENTION_ARGTYPES, _I)},
    "flash_attention": {"sgdrc_flash_attention": (FLASH_ARGTYPES, _I)},
    "dual_tenant_attention": {
        "sgdrc_dual_tenant_attention": (DUAL_ATTENTION_ARGTYPES, _I),
        "sgdrc_flash_tile_rows": ([_I, _I], _I)},
    "dual_tenant_matmul": {
        "sgdrc_dual_tenant_matmul": (DUAL_MATMUL_ARGTYPES, _I),
        "sgdrc_matmul_tile": ([], _I)},
    "spt_gather": {"sgdrc_spt_gather": (SPT_ARGTYPES, _I),
                   "sgdrc_spt_scatter": (SPT_ARGTYPES, _I)},
    "ssd_scan": {"sgdrc_ssd_scan": (SSD_ARGTYPES, _I),
                 "sgdrc_ssd_scan_blocks_per_sm": ([_I, _I, _I], _I)},
}
SOURCES = tuple(ENTRIES)

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
            for sym, (argtypes, restype) in ENTRIES[name].items():
                fn = getattr(lib, sym)
                fn.argtypes = argtypes
                fn.restype = restype
            _libs[name] = lib
    return lib


def entry(name: str, symbol: str = ""):
    """The C function ``symbol`` (default ``sgdrc_<name>``) of
    ``csrc/<name>.cu``, bound with its argument types."""
    return getattr(load(name), symbol or f"sgdrc_{name}")


def stream_of(device) -> int:
    """The current CUDA stream of ``device``, as the C entry points take
    it."""
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(name: str, err: int):
    """Raise on a non-zero ``cudaError_t`` from a C entry point."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def check_cuda(name: str, tensors: dict, dtype=None):
    """Raise unless every tensor is contiguous, on the first one's CUDA
    device, and (when ``dtype`` is given) of that dtype, one the kernels
    take."""
    dev = next(iter(tensors.values())).device
    if dev.type != "cuda":
        raise ValueError(f"{name}: CUDA kernel called on {dev}")
    if dtype is not None and dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {dtype}")
    for what, t in tensors.items():
        if t.device != dev or (dtype is not None and t.dtype != dtype):
            raise ValueError(f"{name}: {what} is {t.dtype} on {t.device}; "
                             f"need {dtype} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    return dev


def aligned16(t):
    """``t``, or a fresh copy of it when its data does not start on a
    16-byte boundary (TMA reads only from such addresses)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


#: the tile bodies of the kernels that have two: tensor cores, CUDA cores
ROUTES = ("wgmma", "simt")


def count_launch(fn, route: str):
    """Count one launch of the wrapper ``fn`` on ``route``."""
    fn.launches += 1
    fn.routes[route] += 1


HEAD_DIMS = (32, 64, 128)


def _i32(x, shape, device, what):
    if x.dtype != torch.int32 or tuple(x.shape) != tuple(shape) \
            or not x.is_contiguous() or x.device != device:
        raise ValueError(f"{what}: need contiguous int32 {tuple(shape)} on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    return x.data_ptr()


def launch_attention(name, q, out, k, v, pos, *, abort=None, progress=None,
                     page_table=None, window, page_size=0, wgmma=False):
    """Launch ``sgdrc_<name>`` on the current stream, on the tensor-core
    body when ``wgmma``. q/out: [B,Sq,H,D] (any strides, D contiguous);
    k/v: [X,Hkv,S,D] views whose first three axes are (batch row, kv head,
    key) for a dense cache or (page, kv head, in-page offset) for a pool;
    pos/abort/progress: int32 [B]; page_table: int32 [B,P]. Raises on
    anything the kernel does not take, and on a non-zero
    ``cudaGetLastError`` after the launch."""
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
    if q.dtype not in DTYPE_CODES:
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
    err = entry(name)(*ptrs, DTYPE_CODES[q.dtype], B, Sq, H, Hkv, D,
                      int(bool(wgmma)), int(window), int(page_size),
                      pt_stride, n_pages,
                      q.stride(0), q.stride(1), q.stride(2),
                      out.stride(0), out.stride(1), out.stride(2),
                      k.stride(0), k.stride(1), k.stride(2),
                      v.stride(0), v.stride(1), v.stride(2),
                      float(D ** -0.5), stream_of(dev))
    check_launch(name, err)

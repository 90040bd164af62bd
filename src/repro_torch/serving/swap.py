"""Host<->device swapping over the interconnect, on PyTorch.

Two swap flows share the PCIe bus model (``core.pcie``):

* **Model swapping** (paper scenario #2, §8.4): DNNs live in host memory and
  must be streamed to the device before serving; the PCIe scheduler decides
  who gets the bus. PipeSwitch-style pipelining overlaps layer transfer with
  layer execution (§7) — :func:`pipelined_serve_time` / :func:`swap_requests`.

* **KV page swapping** (the KV memory hierarchy's middle + cold tiers):
  instead of discarding cold KV pages under pool pressure, the serving
  engine moves them to a :class:`HostSwapPool` — preempted decode requests'
  page groups and zero-ref prefix-tree leaves survive a tide on the host and
  fault back in over the bus instead of being recomputed. The host tier
  stores pages either **exact** (``cold_dtype="fp16"``: the pool's native
  dtype, so a fp16/fp32 pool round-trips bit-identically and resumed tokens
  are bit-equal to a never-swapped run) or **quantized** (``cold_dtype=
  "int8"``: per-page-per-leaf abs-max scale, 2-4x less host memory and bus
  traffic at a bounded dequantization error). Every put/get is logged as a
  :class:`~repro.core.pcie.bus.CopyRequest`, so swap traffic can be replayed
  through the :class:`~repro.core.pcie.cfs.PCIeCFS` against concurrent
  weight streaming (:func:`page_swap_requests` builds the same flows
  analytically for contention studies).

The bus model, the analytic flows, the int8 quantizer and the host pool's
accounting are the reference's (``repro.serving.swap``), copied as they
are. The device side is torch: a page is read from the engine's pool
tensors and written back into them in place (``get`` returns the same
pools object). numpy has no bfloat16, so a bf16 page is stored in fp16
mode as its raw 16-bit patterns (an int16 array): the round trip is bit
exact and the page's CRC32 hashes the bytes the reference's bf16 host
array holds. int8 mode quantizes the page's f32 values.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.costmodel import model_costs, param_count
from ..core.pcie.bus import BusSpec, CopyRequest, bw_of
from ..core.simulator import DeviceSpec
from .faults import ColdPageCorrupt, HostTierFault


def model_bytes(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    return param_count(cfg) * dtype_bytes


def pipelined_serve_time(cfg: ModelConfig, B: int, S: int, mode: str,
                         dev: DeviceSpec, effective_bw: float) -> float:
    """Execution latency when weights stream in at effective_bw and layer i's
    compute overlaps layer i+1's transfer (PipeSwitch): the request finishes
    at max(total_transfer, first_layer_transfer + total_compute)."""
    ops = model_costs(cfg, B, S, mode)
    compute = sum(max(o.flops / dev.peak_flops, o.bytes / dev.hbm_bw)
                  for o in ops)
    total_tx = model_bytes(cfg) / max(effective_bw, 1.0)
    first_tx = total_tx / max(cfg.num_layers, 1)
    return max(total_tx, first_tx + compute)


def swap_requests(cfg: ModelConfig, tenant: str, priority: str, nice: int,
                  arrivals: List[float], rid0: int = 0,
                  per_layer: bool = False) -> List[CopyRequest]:
    """Weight-load copies per inference request (cold model). With
    ``per_layer`` the stream is split into layer-granularity transfers
    (PipeSwitch-style pipelining — also what lets schedulers interleave)."""
    size = model_bytes(cfg)
    if not per_layer:
        return [CopyRequest(rid0 + i, tenant, priority, nice, size, "h2d", t)
                for i, t in enumerate(arrivals)]
    n = max(cfg.num_layers, 1)
    out = []
    for i, t in enumerate(arrivals):
        for j in range(n):
            out.append(CopyRequest(rid0 + i * 1000 + j, tenant, priority,
                                   nice, size // n, "h2d", t))
    return out


def page_swap_requests(tenant: str, priority: str, nice: int,
                       page_bytes: int, n_pages: int, direction: str,
                       arrivals: List[float],
                       rid0: int = 20_000_000) -> List[CopyRequest]:
    """Analytic KV page-group swap flow for PCIe contention studies: each
    arrival moves ``n_pages`` pages of ``page_bytes`` as one page-granular
    copy each (the CFS interleaves at packet granularity either way)."""
    out = []
    for i, t in enumerate(arrivals):
        for j in range(n_pages):
            out.append(CopyRequest(rid0 + i * 1000 + j, tenant, priority,
                                   nice, page_bytes, direction, t))
    return out


# ---------------------------------------------------------------------------
# KV page host tier (middle tier of the KV memory hierarchy)
# ---------------------------------------------------------------------------

def quantize_page(arr: np.ndarray) -> Tuple[np.ndarray, float]:
    """Per-page abs-max int8 quantization of one pool-leaf page slice.
    Returns (int8 data, scale); ``dequantize_page`` inverts it with error
    bounded by ``scale / 2 = max|x| / 254`` per element."""
    a = np.asarray(arr)
    scale = float(np.max(np.abs(a))) / 127.0 if a.size else 0.0
    if scale == 0.0:
        return np.zeros(a.shape, np.int8), 0.0
    q = np.clip(np.round(a.astype(np.float32) / scale), -127, 127)
    return q.astype(np.int8), scale


def dequantize_page(q: np.ndarray, scale: float) -> np.ndarray:
    return q.astype(np.float32) * scale


@dataclass
class _HostPage:
    """One swapped KV page: per-pool-leaf host arrays (flat, in pool tree
    order) plus per-leaf scales when quantized (None = exact). ``crc`` is
    the CRC32 of the stored representation, recorded at put time and
    re-verified at get time — a mismatch means the host copy rotted and
    must not be served."""
    leaves: List[np.ndarray]
    scales: Optional[List[float]]
    nbytes: int
    crc: int = 0


def _page_crc(leaves: List[np.ndarray]) -> int:
    crc = 0
    for a in leaves:
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    return crc & 0xFFFFFFFF


def _leaves(tree) -> list:
    """A pool tree's tensors in ``jax.tree.leaves`` order (dict keys
    sorted, lists in order), so a page's host leaves and CRC line up with
    the reference's."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _page_leaves(pools) -> List[Tuple[torch.Tensor, int]]:
    """Flatten a paged-cache tree into (leaf, page_axis) pairs in a
    deterministic order. ``layers`` leaves are [n_periods, n_pages, ...]
    (page axis 1); ``prefix`` entries are per-layer dicts with page axis
    0."""
    out = []
    if "prefix" in pools:
        for pp in pools["prefix"]:
            out += [(l, 0) for l in _leaves(pp)]
    out += [(l, 1) for l in _leaves(pools["layers"])]
    return out


def _read_page(leaf: torch.Tensor, page: int, page_axis: int,
               raw: bool) -> np.ndarray:
    """One page of a pool leaf on the host: its raw 16-bit patterns for a
    bf16 leaf when ``raw`` (numpy has no bfloat16), else its values (f32
    for bf16)."""
    t = leaf.select(page_axis, page)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16) if raw else t.float()
    return t.cpu().numpy()


def _write_page(leaf: torch.Tensor, data: np.ndarray, page: int,
                page_axis: int):
    """Write a host page into a pool leaf in place: raw int16 patterns of a
    bf16 leaf are reinterpreted, values are cast to the leaf's dtype."""
    src = torch.from_numpy(np.ascontiguousarray(data))
    if leaf.dtype == torch.bfloat16 and src.dtype == torch.int16:
        src = src.view(torch.bfloat16)
    leaf.select(page_axis, page).copy_(src.to(leaf.device, leaf.dtype))


class HostSwapPool:
    """Host-memory tier for swapped KV pages.

    ``put`` copies one device page (every pool leaf's slice) to host arrays
    — quantized int8 with a per-leaf abs-max scale when ``cold_dtype=
    "int8"``, the pool's native dtype when ``"fp16"`` (exact: a native-dtype
    round trip is bit-identical, so fp16-mode swap never changes a token).
    ``get`` writes it back into a (possibly different) destination device
    page, in place, dequantizing, and drops the host copy. Both directions
    are logged as :class:`CopyRequest` flows (``d2h`` puts, ``h2d`` gets)
    so swap traffic can be replayed through the PCIe CFS and charged
    against the owning class's bandwidth; :meth:`pcie_seconds` is the uncontended bus
    occupancy of everything logged so far.

    Chaos plane: with ``faults`` attached, ``put`` raises
    :class:`HostTierFault` inside a ``swap_write_fail`` window (before any
    host state mutates) and ``get`` raises inside a ``swap_read_fail``
    window (the page stays resident for the retry). A ``page_corrupt``
    point event flips bytes in the stored host page; every page carries a
    CRC32 recorded at put time, and ``get`` re-verifies it when ``verify``
    is on — a mismatch discards the host copy and raises
    :class:`ColdPageCorrupt` instead of serving rotted KV. ``verify=False``
    is the naive-engine ablation: corruption is served silently."""

    def __init__(self, cold_dtype: str = "int8", *, tenant: str = "kv",
                 priority: str = "BE", nice: int = 1,
                 bus: Optional[BusSpec] = None, faults=None,
                 verify: bool = True):
        assert cold_dtype in ("int8", "fp16"), cold_dtype
        self.cold_dtype = cold_dtype
        self.tenant, self.priority, self.nice = tenant, priority, nice
        self.bus = bus or BusSpec()
        self.faults = faults
        self.verify = verify
        self.pages: Dict[object, _HostPage] = {}
        self.copies: List[CopyRequest] = []
        self.bytes_to_host = 0
        self.bytes_to_device = 0
        self.puts = 0
        self.gets = 0
        self.write_faults = 0
        self.read_faults = 0
        self.corruptions = 0
        self._rid = 0
        #: optional obs.Tracer; every logged copy also emits a kind="swap"
        #: instant on the owning engine's virtual clock (trace_prefix
        #: namespaces the track when engines share one tracer, e.g. disagg)
        self.tracer = None
        self.trace_prefix = ""

    def __contains__(self, key) -> bool:
        return key in self.pages

    def __len__(self) -> int:
        return len(self.pages)

    @property
    def host_bytes(self) -> int:
        return sum(p.nbytes for p in self.pages.values())

    def _log(self, size: int, direction: str, t: float):
        self.copies.append(CopyRequest(self._rid, self.tenant, self.priority,
                                       self.nice, size, direction, t))
        self._rid += 1
        if self.tracer is not None:
            self.tracer.instant("swap", direction, float(t),
                                f"{self.trace_prefix}swap/{self.tenant}",
                                bytes=int(size), direction=direction,
                                tenant=self.tenant)

    # -- device -> host ------------------------------------------------
    def put(self, pools, key, page: int, t: float = 0.0) -> int:
        """Copy device page ``page`` to host under ``key``; returns the
        bytes moved over the bus (the cold tier's compressed size). Raises
        :class:`HostTierFault` inside an injected write-fault window —
        before any host state mutates, so the caller may retry or fall
        back without cleanup here."""
        if self.faults is not None and self.faults.active(
                "swap_write_fail", t, target=self.tenant):
            self.write_faults += 1
            raise HostTierFault("swap_write_fail", key)
        assert key not in self.pages, key
        leaves, scales, nbytes = [], [], 0
        for leaf, _ax in _page_leaves(pools):
            data = _read_page(leaf, page, _ax,
                              raw=self.cold_dtype != "int8")
            if self.cold_dtype == "int8":
                q, s = quantize_page(data)
                leaves.append(q)
                scales.append(s)
                nbytes += q.nbytes
            else:
                leaves.append(data.copy())
                nbytes += data.nbytes
        self.pages[key] = _HostPage(leaves,
                                    scales if self.cold_dtype == "int8"
                                    else None, nbytes, crc=_page_crc(leaves))
        self.bytes_to_host += nbytes
        self.puts += 1
        self._log(nbytes, "d2h", t)
        return nbytes

    # -- host -> device (fault) ----------------------------------------
    def get(self, pools, key, dest_page: int, t: float = 0.0):
        """Fault the host page ``key`` back into device page ``dest_page``
        (dequantizing in int8 mode), in place, and drop the host copy.
        Returns (pools, bytes moved); ``pools`` is the object passed in.

        Chaos plane: raises :class:`HostTierFault` inside a read-fault
        window (page stays resident — a later retry can succeed); a
        ``page_corrupt`` point event rots the stored copy, which the CRC32
        check then catches (``verify`` on): the corrupt page is dropped
        and :class:`ColdPageCorrupt` raised so the caller re-prefills
        instead of serving bad KV."""
        if self.faults is not None and self.faults.active(
                "swap_read_fail", t, target=self.tenant):
            self.read_faults += 1
            raise HostTierFault("swap_read_fail", key)
        hp = self.pages[key]
        if self.faults is not None and self.faults.fires(
                "page_corrupt", t, target=self.tenant):
            if hp.leaves and hp.leaves[0].size:
                rot = hp.leaves[0].copy()
                flat = rot.reshape(-1).view(np.uint8)
                flat[0] ^= 0xFF
                hp.leaves[0] = rot
        if self.verify and _page_crc(hp.leaves) != hp.crc:
            self.corruptions += 1
            del self.pages[key]
            raise ColdPageCorrupt(key)
        del self.pages[key]
        for i, (leaf, ax) in enumerate(_page_leaves(pools)):
            data = hp.leaves[i]
            if hp.scales is not None:
                data = dequantize_page(data, hp.scales[i])
            _write_page(leaf, data, dest_page, ax)
        self.bytes_to_device += hp.nbytes
        self.gets += 1
        self._log(hp.nbytes, "h2d", t)
        return pools, hp.nbytes

    def drop(self, key):
        self.pages.pop(key, None)

    # -- accounting ----------------------------------------------------
    def pcie_seconds(self) -> float:
        """Uncontended bus occupancy of every logged swap copy (per-DMA
        overhead + bytes/bw per direction) — the modeled PCIe time the
        engine reports next to its wall-clock metrics."""
        return sum(self.bus.call_overhead_s + c.size / bw_of(self.bus,
                                                            c.direction)
                   for c in self.copies)

    def stats(self) -> dict:
        out = {"cold_dtype": self.cold_dtype,
               "pages_resident": len(self.pages),
               "host_bytes": self.host_bytes,
               "puts": self.puts, "gets": self.gets,
               "bytes_to_host": self.bytes_to_host,
               "bytes_to_device": self.bytes_to_device,
               "pcie_s": self.pcie_seconds()}
        if self.write_faults or self.read_faults or self.corruptions:
            out["faults"] = {"write": self.write_faults,
                             "read": self.read_faults,
                             "corrupt": self.corruptions}
        return out

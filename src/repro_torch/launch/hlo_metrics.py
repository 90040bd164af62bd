"""Roofline inputs of a traced step (``repro.launch.hlo_metrics`` in
PyTorch): the reference's HLO collective parser, verbatim, and
:func:`traced_metrics`, the counterpart of its ``compiled_metrics``, which
runs a step once under a dispatch mode and reads the same keys off the ops
each rank would run.

Wire-byte model per collective (ring algorithms, group size n, S = result
bytes of the op as printed in the per-device program):
    all-reduce          2*S*(n-1)/n
    all-gather          S*(n-1)/n            (S is the gathered result)
    reduce-scatter      S*(n-1)              (S is the scattered result)
    all-to-all          S*(n-1)/n
    collective-permute  S
"""
from __future__ import annotations

import re
import sys
import weakref
from collections import defaultdict
from dataclasses import dataclass, field

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_SHAPE_RE = re.compile(r"\b([a-z0-9]+)\[([0-9,]*)\]")
_COLL_RE = re.compile(
    r"=\s*((?:\([^)]*\))|(?:[a-z0-9]+\[[0-9,]*\][^ ]*))\s*"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(-start|-done)?\(")
_GROUPS_RE = re.compile(r"replica_groups=\{([^}]*(?:\},\{[^}]*)*)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        # iota format [G, N/G] => groups of N/G ranks
        return int(m.group(2))
    m = _GROUPS_RE.search(line)
    if m:
        first = m.group(1).split("},{")[0]
        return max(1, len([x for x in first.replace("{", "").split(",") if x]))
    return default


@dataclass
class CollectiveStats:
    counts: dict = field(default_factory=lambda: defaultdict(int))
    result_bytes: dict = field(default_factory=lambda: defaultdict(float))
    wire_bytes: dict = field(default_factory=lambda: defaultdict(float))

    @property
    def total_wire_bytes(self) -> float:
        return float(sum(self.wire_bytes.values()))

    @property
    def total_result_bytes(self) -> float:
        return float(sum(self.result_bytes.values()))

    def to_dict(self):
        return {"counts": dict(self.counts),
                "result_bytes": dict(self.result_bytes),
                "wire_bytes": dict(self.wire_bytes),
                "total_wire_bytes": self.total_wire_bytes,
                "total_result_bytes": self.total_result_bytes}


def _wire(kind: str, s: float, n: int) -> float:
    if kind == "all-reduce":
        return 2.0 * s * (n - 1) / n
    if kind == "all-gather":
        return s * (n - 1) / n
    if kind == "reduce-scatter":
        return float(s) * (n - 1)
    if kind == "all-to-all":
        return s * (n - 1) / n
    return float(s)                            # collective-permute


def parse_collectives(hlo_text: str, n_devices: int) -> CollectiveStats:
    stats = CollectiveStats()
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        shape_txt, kind, startdone = m.group(1), m.group(2), m.group(3)
        if startdone == "-done":
            continue                       # counted at -start
        s = _shape_bytes(shape_txt)
        n = _group_size(line, n_devices)
        if n <= 1:
            continue
        stats.counts[kind] += 1
        stats.result_bytes[kind] += s
        stats.wire_bytes[kind] += _wire(kind, s, n)
    return stats


# ---------------------------------------------------------------------------
# the traced counterpart of compiled_metrics
# ---------------------------------------------------------------------------

# funcol op -> the HLO collective it is
_FUNCOL = {"all_reduce": "all-reduce",
           "all_gather_into_tensor": "all-gather",
           "reduce_scatter_tensor": "reduce-scatter",
           "all_to_all_single": "all-to-all"}


# ops whose result is their input under a wrapper (an AsyncCollectiveTensor
# on a real run; the meta kernels allocate a new storage)
_WRAPS = ("_wrap_tensor_autograd", "wait_tensor")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _local(t):
    """A DTensor's own shard (the tensor object itself, so identity tells
    an in-place result from a new one); a plain tensor as it is."""
    return getattr(t, "_local_tensor", t)


def local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in ``tree`` (a plain
    tensor counts whole)."""
    return sum(_nbytes(_local(t)) for t in _tensors(tree))


def argument_bytes(args, read=None) -> int:
    """A step's ``argument_bytes``: its tensors' local bytes, and 4 for
    each Python int (a decode step's position, which the reference passes
    as an int32 scalar). Given ``read`` (the storages the step's ops
    read or it returns), only those tensors count: XLA drops an argument
    its program neither reads nor returns (whisper's encoder weights in a
    decode step that is given the encoder output)."""
    ints = sum(1 for a in args if isinstance(a, int)
               and not isinstance(a, bool))
    ts = [_local(t) for t in _tensors(args)]
    if read is not None:
        ts = [t for t in ts if t.untyped_storage()._cdata in read]
    return sum(_nbytes(t) for t in ts) + 4 * ints


def _in_propagation() -> bool:
    """Whether DTensor's sharding propagation is running this op: it
    builds and runs global-shape stand-ins of the operands (its own
    allocations, no rank's work)."""
    f = sys._getframe(2)
    while f is not None:
        if "propagate_tensor_meta" in f.f_code.co_name:
            return True
        f = f.f_back
    return False


class _Recorder:
    """The dispatch mode behind :func:`traced_metrics`. An op on DTensors is
    handed back to DTensor (``NotImplemented``), which runs it as local
    ops on each rank's shards, collectives included; those local ops come
    back here, so everything is counted as one rank runs it."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        rec = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return rec.dispatch(func, types, args, kwargs or {})

        self.mode = Mode()
        self.flop_registry = flop_registry
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = CollectiveStats()
        self.coll_shapes = defaultdict(int)     # "kind dtype[shape] of n"
        self.live = 0
        self.peak = 0
        self.peak_by_op = {}
        self._seen = {}         # live entry -> [bytes, op, storages held]
        self._addr = {}         # live storage address -> its entry
        self._entries = 0       # entries made
        self.read = set()       # storages the local ops read

    def _track(self, t, op):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._addr:
            return
        n = st.nbytes()
        eid = self._entries
        self._entries += 1
        self._seen[eid] = [n, op, 0]
        self.live += n
        if self.live > self.peak:
            if self.live > 1.02 * self.peak:     # the peak's makeup, by op
                by = defaultdict(int)
                for b, o, _ in self._seen.values():
                    by[o] += b
                self.peak_by_op = dict(sorted(by.items(),
                                              key=lambda kv: -kv[1])[:8])
            self.peak = self.live
        self._hold(st, key, eid)

    def _hold(self, st, key, eid):
        """Count entry ``eid`` live while storage ``st`` (at address
        ``key``: its own, or an alias's) is: a meta storage's Python
        object lives as long as the storage, and ``weakref.finalize``
        fires when it goes. An address is released with its storage, so
        a later storage there is a new one."""
        self._addr[key] = eid
        self._seen[eid][2] += 1

        def release(key=key, eid=eid, rec=weakref.ref(self)):
            r = rec()
            if r is None:
                return
            if r._addr.get(key) == eid:
                del r._addr[key]
            e = r._seen.get(eid)
            if e is not None:
                e[2] -= 1
                if e[2] == 0:
                    r.live -= r._seen.pop(eid)[0]
        weakref.finalize(st, release)

    def _alias(self, out, src):
        """``out`` is ``src`` under another storage (a collective's
        autograd wrapper, whose meta kernel allocates where the real one
        wraps): one logical tensor, counted once, live while either is."""
        eid = self._addr.get(src.untyped_storage()._cdata)
        st = out.untyped_storage()
        if eid is not None and st._cdata not in self._addr:
            self._hold(st, st._cdata, eid)

    def dispatch(self, func, types, args, kwargs):
        import torch
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if (any(isinstance(t, FakeTensor) for t in _tensors((args, kwargs)))
                or _in_propagation()):
            return out      # DTensor's shape propagation, on global shapes
        packet = getattr(func, "_overloadpacket", None)
        name = getattr(packet, "__name__", "")
        if name in _FUNCOL and "c10d_functional" in str(packet):
            self._collective(_FUNCOL[name], args, kwargs, out)
        if packet in self.flop_registry:
            self.flops += float(self.flop_registry[packet](
                *args, **kwargs, out_val=out))
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        self.bytes += sum(_nbytes(t) for t in ins + outs)
        schema = getattr(func, "_schema", None)
        aliases = schema is not None and (
            func.is_view or any(a.alias_info is not None
                                for a in schema.returns))
        if not aliases:         # a view reads nothing
            self.read.update(t.untyped_storage()._cdata for t in ins)
        if name in _WRAPS and ins and isinstance(out, torch.Tensor):
            self._alias(out, ins[0])
        elif not aliases:
            for t in outs:
                if isinstance(t, torch.Tensor) and not isinstance(t, DTensor):
                    self._track(t, name)
        return out

    def _collective(self, kind, args, kwargs, out):
        from torch.distributed.distributed_c10d import _resolve_process_group
        group = args[-1] if isinstance(args[-1], str) else kwargs.get(
            "group_name")
        n = _resolve_process_group(group).size()
        if n <= 1:
            return
        s = _nbytes(out)
        self.coll.counts[kind] += 1
        self.coll.result_bytes[kind] += s
        self.coll.wire_bytes[kind] += _wire(kind, s, n)
        dt = str(out.dtype).replace("torch.", "")
        self.coll_shapes[f"{kind} {dt}{list(out.shape)} of {n}"] += 1


def traced_metrics(step, *args) -> dict:
    """Run ``step(*args)`` once and return the keys of the reference's
    ``compiled_metrics``, each per device (one rank's share), for a step
    on DTensors over a mesh (meta shards on a fake group trace a
    production mesh in one process) or on plain tensors:

    - ``flops``: the matmul-class FLOPs (``torch.utils.flop_counter``'s
      formulas: mm, bmm, addmm, baddbmm, convolutions, attention) of the
      local ops this rank runs, forward and backward. A column-parallel
      product counts its own columns, a row-parallel one (a ``Partial``
      output) its own rows, a replicated op the whole. Elementwise ops
      count nothing (XLA's analysis counts them too, so the two differ
      there);
    - ``bytes_accessed``: the bytes every local op reads and writes, each
      input once and each output once, summed over the ops: what the step
      would move if no two ops were fused. XLA's number is after fusion, so
      this one is an upper bound on it, not the same quantity;
    - ``memory``: ``argument_bytes`` is the local shard bytes of the
      ``args`` the step reads or returns (:func:`argument_bytes`);
      ``output_bytes`` those of the result; ``alias_bytes`` those of the
      results that are arguments updated in place (the counterpart of
      donated buffers); ``temp_bytes`` the peak of live local storages the
      step's ops allocate (views, in-place results and a collective's
      autograd wrapper are not new storage; a storage counts from the op
      that makes it until its last tensor dies), while it runs, and
      ``temp_by_op`` the 8 ops whose results held most of it at (about)
      that peak; ``code_bytes`` is 0: nothing is compiled, the kernels are
      the ops' own. It is what an eager step holds, not what XLA's
      ``temp_size_in_bytes`` holds: XLA counts buffers an eager step never
      makes (on its CPU backend, f32 copies of bf16 dot operands, hoisted
      out of the layer loop over the whole stacked leaf; the scan's stacked
      residuals of every query block at once) and fuses away results the
      eager step makes one op at a time (a cast, a mask, a ``where``);
      ``PERF.md`` names them cell by cell;
    - ``collectives``: each functional collective a rank issues
      (all_reduce, all_gather_into_tensor, reduce_scatter_tensor,
      all_to_all_single), by its local result bytes and its group's size,
      under the wire-byte model of the module docstring, and ``shapes``:
      how many of each kind, result dtype and shape, and group size.
    Returns (metrics, the step's result)."""
    rec = _Recorder()
    arg_ids = {id(_local(t)) for t in _tensors(args)}
    with rec.mode:
        out = step(*args)
    outs = _tensors(out)
    alias = sum(_nbytes(_local(t)) for t in outs if id(_local(t)) in arg_ids)
    metrics = {
        "flops": rec.flops,
        "bytes_accessed": rec.bytes,
        "memory": {
            "argument_bytes": argument_bytes(
                args, rec.read | {_local(t).untyped_storage()._cdata
                                  for t in outs}),
            "output_bytes": local_bytes(out),
            "temp_bytes": rec.peak,
            "alias_bytes": alias,
            "code_bytes": 0,
            "temp_by_op": rec.peak_by_op,
        },
        "collectives": dict(rec.coll.to_dict(),
                            shapes=dict(sorted(rec.coll_shapes.items()))),
    }
    return metrics, out

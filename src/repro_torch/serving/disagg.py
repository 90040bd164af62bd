"""Disaggregated prefill/decode serving over a modeled interconnect.

Monolithic co-located serving makes prompt processing and token generation
fight for the same device: prefill bursts stretch decode gaps (TBT) and
decode occupancy stretches queueing (TTFT). Disaggregation splits the two
phases across device slices — a *prefill slice* turns prompts into KV page
groups, a *decode slice* streams tokens — and ships the KV between them
over the modeled interconnect (``core.interconnect``).

:class:`DisaggregatedEngine` composes two real-execution
:class:`~.engine.ServingEngine` instances (torch backend, one
``torch_device`` for both) around that wire:

* Requests are submitted to the prefill engine. When a request's prompt
  completes (``migrate_hook`` at the prefill epilogue), its committed KV
  page group is serialized through the decode tenant's
  :class:`~.swap.HostSwapPool` — the same page-group wire
  format the swap tier uses, ``fp16`` passthrough so the transfer is
  bit-exact — and the request is re-queued on the decode engine as a
  ``SWAPPED`` request whose "host" pages are the wire buffer. The decode
  engine's existing re-admission path (``alloc_slot_pages`` + paced
  ``_swap_progress`` fault-in) restores the pages and resumes decoding at
  ``resume_pos`` with the prefill-produced first token — no new restore
  machinery, and decode tokens are bit-equal to a single co-located
  engine's.

* With ``pipeline=True`` (default) the prefill engine's ``chunk_hook``
  streams each *fully committed* page as soon as a mid-prompt chunk lands
  (layer-pipelined transfer): by prefill completion most bytes are already
  in flight, so the migration's critical path is only the tail of the page
  group. A completed page is never written again (chunks only write
  positions ``>= prefill_pos``; copy-on-write forks target written pages),
  so streaming early is safe.

* Every shipped page group becomes a :class:`~..core.interconnect.Flow`
  and the whole flow history (including caller-supplied background
  collective flows) is replayed through :class:`InterconnectSim` — flows
  contend under the PCIe CFS discipline per link, and a migration is only
  *injected* into the decode queue once the virtual clock passes its last
  flow's completion. Injection commits against the flow set known at
  injection time (later flows never retroactively delay an already-admitted
  request) — an optimistic but fully deterministic model.

* Control: every ``control_interval`` rounds the prefill slice's windowed
  :class:`~repro.core.compute.LoadSignal` drives
  :meth:`ElasticMeshPartitioner.rebalance_from_signal` — the device-lending
  analogue of the tidal ``sm_be`` re-plan. The resulting assignment is the
  per-round step quota of each engine (prefill slice = LS, decode slice =
  BE), so a prompt burst tidally borrows decode-slice quanta and releases
  them as the queue drains; the partitioner's clamps guarantee the device
  count is conserved and the prefill slice never drops below its floor.

Everything runs on one shared virtual clock (fixed ``quantum_dt`` per
engine quantum), so a seeded run — outputs, flow completions, lending
decisions — replays bit-identically.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..core.compute import ElasticMeshPartitioner, LoadSignal
from ..core.interconnect import (Flow, FlowCompletion, InterconnectSim,
                                 Topology)
from .engine import Request, ServingEngine
from .scheduler import Phase


@dataclass
class _Migration:
    """One request's journey from the prefill slice to the decode slice."""
    mid: int
    tenant: str
    preq: Request                    # prefill-engine request
    keys: List = field(default_factory=list)   # wire-buffer keys, page order
    flow_ids: List[int] = field(default_factory=list)
    bytes: int = 0
    shipped_pages: int = 0
    migrated: bool = False           # prefill done, resume state captured
    first_tok: int = 0
    resume_pos: int = 0
    ready_at: Optional[float] = None     # last flow landed (injection time)
    dreq: Optional[Request] = None       # decode-engine request
    t_migrate: Optional[float] = None


class DisaggregatedEngine:
    """Prefill/decode disaggregation over two ServingEngines and a modeled
    interconnect (module docstring). ``n_prefill`` of ``n_devices`` anchor
    the prefill slice initially; lending moves the ratio, never the two
    anchor devices the flows ride between."""

    def __init__(self, *, max_seq: int = 128, page_size: int = 8,
                 chunk_size: Optional[int] = None,
                 token_budget: Optional[int] = None,
                 kv_pages: Optional[int] = None,
                 slots_prefill: int = 4, slots_decode: int = 4,
                 n_devices: int = 2, n_prefill: int = 1,
                 min_prefill: int = 1,
                 topology: Optional[Topology] = None,
                 pipeline: bool = True, control_interval: int = 4,
                 quantum_dt: float = 1e-3,
                 background_flows: Optional[List[Flow]] = None,
                 use_flash: bool = False, prefix_cache: bool = False,
                 seed: int = 0, tracer=None, torch_device="cuda"):
        assert n_devices >= 2, "disaggregation needs >= 2 devices"
        assert 1 <= n_prefill < n_devices
        # one shared tracer across both slices on the shared virtual clock:
        # tracks are namespaced "prefill/..." / "decode/...", lending and
        # wire-flow events land on their own tracks
        self.tracer = tracer
        self._t = 0.0
        self._dt = float(quantum_dt)
        self.devices = [f"dev{i}" for i in range(n_devices)]
        self.topology = topology or Topology.host_star(self.devices)
        self.icx = InterconnectSim(self.topology)
        self.prefill_anchor = self.devices[0]
        self.decode_anchor = self.devices[-1]
        clock = lambda: self._t              # noqa: E731 — shared virtual clock
        # prefill slice: chunked prompt processing, prompt-only page
        # admission (grow_pages); requests leave at the prefill epilogue
        self.prefill = ServingEngine(
            max_seq=max_seq, backend="torch", paged=True, page_size=page_size,
            chunk_size=chunk_size, token_budget=token_budget,
            kv_pages=kv_pages, slots_ls=slots_prefill, slots_be=slots_prefill,
            grow_pages=True, prefix_cache=prefix_cache, use_flash=use_flash,
            now_fn=clock, seed=seed, tracer=tracer, trace_name="prefill",
            torch_device=torch_device)
        # decode slice: swap tier on (its SWAPPED re-admission path is the
        # migration restore path; its HostSwapPool is the wire buffer) with
        # fp16 passthrough so transferred KV is bit-exact, and page growth
        # on so decode extends past the transferred prompt pages
        self.decode = ServingEngine(
            max_seq=max_seq, backend="torch", paged=True, page_size=page_size,
            chunk_size=chunk_size, token_budget=token_budget,
            kv_pages=kv_pages, slots_ls=slots_decode, slots_be=slots_decode,
            swap=True, grow_pages=True, cold_dtype="fp16",
            use_flash=use_flash, now_fn=clock, seed=seed, tracer=tracer,
            trace_name="decode", torch_device=torch_device)
        self.prefill.migrate_hook = self._migrate
        self.pipeline = bool(pipeline)
        if self.pipeline:
            self.prefill.chunk_hook = self._stream_chunk
        self.partitioner = ElasticMeshPartitioner(n_devices,
                                                  min_ls=min_prefill)
        first = self.partitioner.rebalance(n_prefill / n_devices)
        self._p_quota = first["LS"]
        self._d_quota = first["BE"]
        self.control_interval = max(int(control_interval), 1)
        self._flows: List[Flow] = list(background_flows or [])
        self._fid = max((f.fid for f in self._flows), default=-1) + 1
        self._dirty = bool(self._flows)
        self._mid = 0
        self._mig: Dict[int, _Migration] = {}
        self._by_preq: Dict[int, _Migration] = {}
        self._completions: Dict[int, float] = {}
        self.flow_log: List[FlowCompletion] = []
        self.lending_log: List[dict] = []
        self.conservation: List[dict] = []
        self.rounds = 0
        self.xfer_bytes = 0
        self._order: List = []           # (tenant, prefill req) submit order

    # -- construction --------------------------------------------------
    def _now(self) -> float:
        return self._t

    def add_tenant(self, spec, cfg, params=None, seed=None,
                   n_slots: Optional[int] = None):
        """Mirror one tenant onto both slices with *identical* params (the
        bit-equality contract needs byte-equal weights on both sides).
        ``params=None`` draws the weights once, from ``seed`` (default: a
        crc32 of the tenant's name, the same in every process), and gives
        the same tensors to both slices."""
        prt = self.prefill.add_tenant(spec, cfg, params, seed=seed,
                                      n_slots=n_slots)
        drt = self.decode.add_tenant(spec, cfg, prt.params, n_slots=n_slots)
        return prt, drt

    def submit(self, tenant: str, tokens, max_new: int = 8, at=None,
               deadline: Optional[float] = None) -> Request:
        req = self.prefill.submit(tenant, tokens, max_new=max_new,
                                  at=(self._t if at is None else at),
                                  deadline=deadline)
        self._order.append((tenant, req))
        return req

    # -- prefill-side hooks --------------------------------------------
    def _state_for(self, rt, req: Request) -> _Migration:
        st = self._by_preq.get(req.rid)
        if st is None:
            self._mid += 1
            st = _Migration(self._mid, rt.spec.name, req)
            self._by_preq[req.rid] = st
            self._mig[st.mid] = st
        return st

    def _ship(self, st: _Migration, rt, req: Request, upto: int):
        """Serialize pages [shipped, upto) of the request's page group into
        the decode tenant's host pool (the wire buffer) and submit one flow
        for the batch."""
        drt = self.decode.tenants[st.tenant]
        kv = rt.kv
        nbytes = 0
        for j in range(st.shipped_pages, upto):
            key = ("mig", st.mid, j)
            drt.host.drop(key)
            nbytes += drt.host.put(rt.cache, key,
                                   int(kv.page_table[req.slot, j]),
                                   t=self._t)
            st.keys.append(key)
        if nbytes:
            st.shipped_pages = upto
            self._flows.append(Flow(self._fid, self.prefill_anchor,
                                    self.decode_anchor, nbytes,
                                    tenant=f"kv:{st.tenant}",
                                    priority=rt.spec.priority,
                                    nice=rt.spec.nice, t_submit=self._t,
                                    kind="kv"))
            st.flow_ids.append(self._fid)
            st.bytes += nbytes
            self.xfer_bytes += nbytes
            self._fid += 1
            self._dirty = True

    def _stream_chunk(self, rt, req: Request):
        """chunk_hook: after a mid-prompt chunk commits, stream the pages it
        completed. Requests that will finish *locally* at the prefill
        epilogue (degenerate max_new, prompt at max_seq) never migrate, so
        streaming for them would only orphan wire pages."""
        kv = rt.kv
        if kv is None or req.max_new <= 1 \
                or len(req.tokens) >= self.prefill.max_seq:
            return
        st = self._state_for(rt, req)
        full = min(req.prefill_pos // kv.page_size,
                   kv.mapped_count(req.slot))
        if full > st.shipped_pages:
            self._ship(st, rt, req, full)

    def _migrate(self, rt, req: Request) -> bool:
        """migrate_hook: prefill epilogue of a still-live request — ship the
        tail of the page group, capture the resume state (first token +
        prompt position), and hand the slot back to the prefill engine."""
        kv = rt.kv
        if kv is None:
            return False             # no page group to ship (dense tenant)
        st = self._state_for(rt, req)
        self._ship(st, rt, req, kv.mapped_count(req.slot))
        st.first_tok = int(req.output[0])
        st.resume_pos = len(req.tokens)
        st.migrated = True
        st.t_migrate = self._t
        self._dirty = True
        return True

    # -- interconnect --------------------------------------------------
    def _recompute(self):
        """Replay the full flow history through the interconnect DES — a
        pure function of the flow set, so replays are bit-identical."""
        self.flow_log = self.icx.run(self._flows)
        self._completions = {c.flow.fid: c.t_end for c in self.flow_log}

    def _pump(self):
        """Inject every migration whose last flow has landed by virtual now
        into the decode queue as a SWAPPED request (the swap tier's
        re-admission path restores it), and reap wire pages of prefill
        requests that died (shed/rejected) before migrating."""
        if self._dirty:
            self._recompute()
            self._dirty = False
        for st in list(self._mig.values()):
            if st.dreq is not None:
                continue
            if not st.migrated:
                if st.preq.phase is Phase.FINISHED:   # shed before migrating
                    drt = self.decode.tenants[st.tenant]
                    for k in st.keys:
                        drt.host.drop(k)
                    del self._mig[st.mid]
                    del self._by_preq[st.preq.rid]
                continue
            ready = max((self._completions.get(f, float("inf"))
                         for f in st.flow_ids), default=st.t_migrate)
            if ready > self._t:
                continue
            self._inject(st, ready)

    def _inject(self, st: _Migration, ready: float):
        eng = self.decode
        drt = eng.tenants[st.tenant]
        if len(drt.queue) >= eng.max_queue:
            return                    # backpressure: retry next pump
        preq = st.preq
        req = eng.submit(st.tenant, preq.tokens, max_new=preq.max_new,
                         at=ready)
        if req.rejected:
            return
        req.phase = Phase.SWAPPED
        req.swap_keys = list(st.keys)
        req.swap_cursor = 0
        req.resume_pos = st.resume_pos
        req.resume_tok = st.first_tok
        req.output = [st.first_tok]
        # end-to-end accounting: the decode-side record keeps the original
        # submit/first-token stamps, so its latency spans the whole journey
        # and the transfer tail lands in the first decode gap
        req.t_submit = preq.t_submit
        req.t_admit = preq.t_admit
        req.t_first = preq.t_first
        req.t_last = ready
        st.dreq = req
        st.ready_at = ready

    # -- main loop -----------------------------------------------------
    def _prefill_signal(self) -> LoadSignal:
        q = a = slots = 0
        for rt in self.prefill.tenants.values():
            q += len(rt.queue)
            a += sum(r is not None for r in rt.active)
            slots += rt.n_slots
        return LoadSignal(ls_queued=q, ls_active=a, ls_slots=max(slots, 1),
                          window_s=self.control_interval * self._dt)

    def _control(self):
        sig = self._prefill_signal()
        assign = self.partitioner.rebalance_from_signal(sig)
        self._p_quota = assign["LS"]
        self._d_quota = assign["BE"]
        self.lending_log.append({"round": self.rounds,
                                 "ls_load": sig.ls_load,
                                 "prefill_devices": assign["LS"],
                                 "decode_devices": assign["BE"]})
        if self.tracer is not None:
            self.tracer.instant("lending", "rebalance", self._t, "lending",
                                round=self.rounds, ls_load=sig.ls_load,
                                prefill_devices=assign["LS"],
                                decode_devices=assign["BE"])

    @staticmethod
    def _has_work(eng: ServingEngine) -> bool:
        return any(rt.has_work() for rt in eng.tenants.values())

    def _in_flight(self) -> List[_Migration]:
        return [st for st in self._mig.values()
                if st.migrated and st.dreq is None]

    def step_round(self) -> bool:
        """One lending round: each slice runs as many engine quanta as it
        holds devices, with migration pumps between the half-rounds."""
        if self.rounds % self.control_interval == 0:
            self._control()
        p_work = self._has_work(self.prefill)
        d_work = self._has_work(self.decode) or bool(self._in_flight())
        prog = False
        p_prog = d_prog = False
        for _ in range(self._p_quota):
            p_prog |= self.prefill.step()
            self._t += self._dt
        self._pump()
        for _ in range(self._d_quota):
            d_prog |= self.decode.step()
            self._t += self._dt
        self._pump()
        prog = p_prog or d_prog
        self.conservation.append({"round": self.rounds,
                                  "prefill": {"work": p_work,
                                              "quota": self._p_quota,
                                              "progressed": p_prog},
                                  "decode": {"work": d_work,
                                             "quota": self._d_quota,
                                             "progressed": d_prog}})
        self.rounds += 1
        return prog

    def run_until_idle(self, max_rounds: int = 100_000) -> int:
        n = 0
        while n < max_rounds:
            prog = self.step_round()
            n += 1
            if prog:
                continue
            pend = self._in_flight()
            if not pend:
                if not (self._has_work(self.prefill)
                        or self._has_work(self.decode)):
                    break
                continue
            # both slices idle but bytes still on the wire: advance the
            # virtual clock to the earliest landing and pump
            nxt = min(max((self._completions.get(f, self._t)
                           for f in st.flow_ids), default=self._t)
                      for st in pend)
            self._t = max(self._t, nxt)
            self._pump()
        self._flush_flow_trace()
        return n

    def _flush_flow_trace(self):
        """Emit one kind="flow" event per wire flow from the *final*
        interconnect replay (the flow set is replayed whole on every
        mutation, so intermediate completions would duplicate fids; the
        last completion per fid is the authoritative lifetime)."""
        if self.tracer is None:
            return
        by_fid = {}
        for c in self.flow_log:
            by_fid[c.flow.fid] = c
        for fid in sorted(by_fid):
            self.tracer.emit_raw(by_fid[fid].to_event())

    # -- results -------------------------------------------------------
    def outputs(self, tenant: str) -> List[List[int]]:
        """Final token outputs in submit order — decode-slice output when
        the request migrated, prefill-local output otherwise (degenerate
        requests finish on the prefill slice)."""
        outs = []
        for t, preq in self._order:
            if t != tenant:
                continue
            st = self._by_preq.get(preq.rid)
            if st is not None and st.dreq is not None:
                outs.append([int(x) for x in st.dreq.output])
            else:
                outs.append([int(x) for x in (preq.output or [])])
        return outs

    def work_conservation(self) -> dict:
        """Fraction of rounds each slice sat workless while the peer slice
        had work — the lending loop should drive both toward 0 by moving
        quota to the loaded slice."""
        total = max(len(self.conservation), 1)
        p_idle = sum(1 for c in self.conservation
                     if not c["prefill"]["work"] and c["decode"]["work"])
        d_idle = sum(1 for c in self.conservation
                     if not c["decode"]["work"] and c["prefill"]["work"])
        return {"rounds": len(self.conservation),
                "prefill_idle_while_decode_busy": p_idle / total,
                "decode_idle_while_prefill_busy": d_idle / total}

    def metrics(self) -> dict:
        mig = list(self._mig.values())
        return {
            "prefill": self.prefill.metrics(),
            "decode": self.decode.metrics(),
            "interconnect": {
                "flows": len(self._flows),
                "xfer_bytes": int(self.xfer_bytes),
                "completed_flows": len(self.flow_log),
            },
            "migrations": {
                "started": len(mig),
                "delivered": sum(1 for st in mig if st.dreq is not None),
                "in_flight": len(self._in_flight()),
                "pipelined_flows_per_req": (
                    float(np.mean([len(st.flow_ids) for st in mig]))
                    if mig else 0.0),
            },
            "lending": list(self.lending_log),
            "work_conservation": self.work_conservation(),
        }

    def fingerprint(self) -> dict:
        """Deterministic replay digest: outputs + flow schedule + lending
        decisions. Two seeded runs with the same submissions must match
        exactly (the multi-device determinism oracle)."""
        return {
            "outputs": {name: self.outputs(name)
                        for name in self.prefill.tenants},
            "flows": [(c.flow.fid, c.flow.src, c.flow.dst, c.flow.size,
                       c.t_start, c.t_end) for c in self.flow_log],
            "lending": [(e["round"], e["prefill_devices"],
                         e["decode_devices"]) for e in self.lending_log],
        }

"""Multi-tenant serving launcher of the PyTorch/CUDA port (SGDRC on one
GPU).

    python -m repro_torch.launch.serve --ls qwen3-1.7b --be gemma2-9b \
        --requests 8 --coloring --grid-search

Runs reduced-config models for real through the continuous-batching
ServingEngine on the card (``--torch-device cpu`` runs them on the CPU
instead, with each kernel's plain PyTorch version): slot-pool batched
prefill/decode; LS preempts BE at step boundaries, or lends BE the plan's
sm_be quantum share when --grid-search derives a ResourcePlan; colored KV
arenas when --coloring; page-table KV admission with --paged; the CUDA
flash-decode and chunked-prefill kernels with --use-flash; the full KV
memory hierarchy with --grow-pages / --swap / --cold-dtype. With
--backend sim the same request stream drives the contention simulator
instead (what-if on the full configs). --disagg swaps the single engine
for the disaggregated prefill/decode pair over the modeled interconnect
(serving.disagg). ``main(argv)`` runs the launcher in-process and
returns the engine it served with.
"""
import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ls", nargs="+", default=["qwen3-1.7b"])
    ap.add_argument("--be", nargs="+", default=["gemma2-9b"])
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=4)
    ap.add_argument("--coloring", action="store_true")
    ap.add_argument("--backend", default="torch", choices=["torch", "sim"])
    ap.add_argument("--torch-device", default="cuda", choices=["cuda", "cpu"],
                    help="device of the torch backend (cuda raises where "
                         "no card is present; cpu runs each kernel's plain "
                         "PyTorch version)")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots per tenant (continuous batching)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache with page-table admission")
    ap.add_argument("--page-size", type=int, default=8,
                    help="tokens per KV page (with --paged)")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="per-tenant KV page-pool override (with --paged); "
                         "a tight pool forces growth preemption / swapping, "
                         "which is what exercises the host-tier fault seams "
                         "under --chaos")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix-tree copy-on-write KV page sharing: cached "
                         "prompt prefixes map into new slots' page tables "
                         "and only the uncached suffix is prefilled "
                         "(implies --paged)")
    ap.add_argument("--grow-pages", action="store_true",
                    help="dynamic page growth: admit on prompt-extent pages "
                         "only and allocate decode pages lazily at page-"
                         "boundary crossings; on pool exhaustion the "
                         "youngest active request is preempted back to the "
                         "queue (or swapped out with --swap). Implies "
                         "--paged")
    ap.add_argument("--swap", action="store_true",
                    help="KV page-group swap to a host-memory tier over the "
                         "PCIe CFS: growth victims and zero-ref prefix "
                         "leaves move to host instead of being recomputed, "
                         "and fault back in when re-admitted (implies "
                         "--grow-pages)")
    ap.add_argument("--cold-dtype", default="int8",
                    choices=["int8", "fp16"],
                    help="host cold-tier encoding for --swap: int8 = per-"
                         "page abs-max quantization (4x less host memory, "
                         "bounded-error faults); fp16 = native-dtype "
                         "passthrough (bit-exact resume)")
    ap.add_argument("--use-flash", action="store_true",
                    help="attention through the CUDA kernels (split-K "
                         "flash-decode, chunked prefill); their plain "
                         "PyTorch versions with --torch-device cpu")
    ap.add_argument("--chunk-size", type=int, default=None,
                    help="chunked prefill: max prompt tokens one request "
                         "advances per engine quantum, so a long prompt "
                         "prefills across quanta while decode keeps "
                         "ticking (bounds the co-located TBT spike; "
                         "default: whole prompt per quantum)")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="per-class per-quantum token budget for the "
                         "scheduler: decode tokens first, prefill chunks "
                         "fill the remainder (default: unbounded)")
    ap.add_argument("--preempt-tile", type=int, default=None,
                    help="sub-chunk preemption: split BE prefill chunks "
                         "into tiles of at most this many tokens with a "
                         "preemption point per tile — an LS arrival "
                         "mid-quantum aborts the remaining BE tiles and "
                         "admits in the same quantum; tokens stay "
                         "bit-equal (default: chunk-granular)")
    ap.add_argument("--adapt-chunk", type=float, default=None,
                    metavar="TBT_MS",
                    help="SLO-driven chunk sizing: attach a ChunkGovernor "
                         "that halves/doubles --chunk-size from the "
                         "windowed LS TBT p99 against this target "
                         "(cause 'chunk_adapt' in the transition log; "
                         "torch backend)")
    ap.add_argument("--grid-search", action="store_true",
                    help="derive a ResourcePlan offline and thread it in")
    ap.add_argument("--online", action="store_true",
                    help="online control plane: grid-search a plan frontier "
                         "and attach an OnlineController (tidal sm_be/ch_be "
                         "re-planning at step boundaries; implies planning)")
    ap.add_argument("--control-interval", type=int, default=4,
                    help="quanta between control ticks (torch backend)")
    ap.add_argument("--gpu", default="tesla-p40",
                    help="hash-model / device model for coloring and sim")
    ap.add_argument("--chaos", action="store_true",
                    help="attach a seeded FaultPlane storm (serving.faults): "
                         "host-tier write/read faults, cold-page corruption, "
                         "allocator faults and controller missed ticks over "
                         "the run, with the engine's recovery paths on")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="storm seed for --chaos (same seed, same schedule)")
    ap.add_argument("--no-fault-recovery", action="store_true",
                    help="naive ablation for --chaos: blind retries, no "
                         "watchdog, no shedding, unverified cold pages")
    ap.add_argument("--fault-budget", type=int, default=8,
                    help="recoveries per degradation-ladder rung per tenant")
    ap.add_argument("--disagg", action="store_true",
                    help="disaggregated prefill/decode: pin prompts to a "
                         "prefill device slice, stream finished KV page "
                         "groups to the decode slice over the modeled "
                         "interconnect, and lend devices tidally between "
                         "slices from the windowed load signal (torch "
                         "backend; implies --paged)")
    ap.add_argument("--devices", type=int, default=2,
                    help="modeled device count for --disagg")
    ap.add_argument("--prefill-devices", type=int, default=1,
                    help="initial prefill-slice size for --disagg")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="--disagg: ship each KV page group whole at the "
                         "prefill epilogue instead of layer-pipelined "
                         "per-chunk streaming")
    ap.add_argument("--max-queue", type=int, default=4096,
                    help="per-tenant submit backpressure bound (excess "
                         "requests are rejected, not queued)")
    ap.add_argument("--trace", default=None, metavar="OUT",
                    help="telemetry plane (repro.obs): record structured "
                         "trace events on the engine's virtual clock and "
                         "write a Chrome/Perfetto trace_event JSON to OUT "
                         "(plus a canonical JSONL stream next to it at "
                         "OUT + '.jsonl'); prints the SLO timeline when "
                         "any tenant carries an SLO")
    ap.add_argument("--trace-level", default="info",
                    choices=["coarse", "info", "debug"],
                    help="trace verbosity: coarse = control plane only "
                         "(plans/faults/violations), info = + request "
                         "phases/quanta/swaps/flows, debug = + per-chunk "
                         "and per-kernel events")
    args = ap.parse_args(argv)

    from ..configs import get_config, smoke_config
    from ..core.coloring import gpu_hash_model
    from ..core.controller import (ChunkGovernor, OnlineController,
                                   frontier_search, grid_search)
    from ..core.simulator import GPU_DEVICES
    from ..core.tenancy import TenantSpec
    from ..serving import FaultPlane, ServingEngine

    tracer = None
    if args.trace:
        from .. import obs
        tracer = obs.Tracer(args.trace_level)

    def _export_trace(events):
        from ..obs import SLOTimeline, write_jsonl, write_perfetto
        write_perfetto(events, args.trace)
        write_jsonl(events, args.trace + ".jsonl")
        print(f"trace: {len(events)} events -> {args.trace} "
              f"(+.jsonl); flight-recorder dumps: {len(tracer.dumps)}")
        tl = SLOTimeline(events)
        if tl.dones:
            print(tl.format_table())

    faults = None
    now_fn = None
    if args.chaos:
        # FaultPlane schedules events on a zero-based clock; anchor the
        # engine clock at launch so the storm window actually overlaps
        # the run (time.perf_counter's origin is arbitrary).
        import time
        t0 = time.perf_counter()
        now_fn = lambda: time.perf_counter() - t0
        horizon = max(args.requests * 2.0, 10.0)
        faults = FaultPlane.storm(
            horizon=horizon, seed=args.fault_seed,
            rates={"swap_write_fail": 0.1, "swap_read_fail": 0.1,
                   "page_corrupt": 0.1, "alloc_fail": 0.05,
                   "ctl_missed_tick": 0.05, "bw_degrade": 0.05},
            duration=horizon / 10)

    plan, ctrl = None, None
    if args.online:
        dev = GPU_DEVICES[args.gpu]
        frontier = frontier_search(dev,
                                   [smoke_config(n) for n in args.ls],
                                   [smoke_config(n) for n in args.be],
                                   load_grid=(0.5, 1.0), pairs_per_model=1,
                                   sm_grid=(0.2, 0.3, 0.4),
                                   ch_grid=(1 / 4, 1 / 2),
                                   thres_grid=(0.4,))
        ctrl = OnlineController(frontier)
        plan = ctrl.plan       # starting point = most conservative regime
        print("frontier: " + "; ".join(
            f"load<={lvl:.2f}: SM_BE={p.sm_be:.2f} Ch_BE={p.ch_be:.2f}"
            for lvl, p in frontier.entries))
    elif args.grid_search:
        dev = GPU_DEVICES[args.gpu]
        plan = grid_search(dev,
                           [smoke_config(n) for n in args.ls],
                           [smoke_config(n) for n in args.be],
                           pairs_per_model=2)
        print(f"plan: SM_BE={plan.sm_be:.2f} Ch_BE={plan.ch_be:.2f} "
              f"Thres_DRAM={plan.thres_dram:.2f} "
              f"(worst LS inflation {plan.max_ls_inflation:.2f}x)")

    if args.disagg:
        if args.backend != "torch":
            ap.error("--disagg runs on the torch backend")
        import json
        from ..serving import DisaggregatedEngine
        dis = DisaggregatedEngine(
            max_seq=args.prompt_len + args.max_new + 4,
            page_size=args.page_size, chunk_size=args.chunk_size,
            token_budget=args.token_budget, kv_pages=args.kv_pages,
            slots_prefill=args.slots, slots_decode=args.slots,
            n_devices=args.devices, n_prefill=args.prefill_devices,
            pipeline=not args.no_pipeline,
            control_interval=args.control_interval,
            use_flash=args.use_flash, prefix_cache=args.prefix_cache,
            tracer=tracer, torch_device=args.torch_device)
        names = []
        for name in args.ls:
            cfg = smoke_config(name).replace(activation_dtype="float32")
            dis.add_tenant(TenantSpec(f"ls:{name}", "LS", nice=10_000), cfg)
            names.append(f"ls:{name}")
        rng = np.random.default_rng(0)
        for _ in range(args.requests):
            for t in names:
                dis.submit(t, rng.integers(0, 256, args.prompt_len).tolist(),
                           max_new=args.max_new)
        dis.run_until_idle()
        print(json.dumps(dis.metrics(), indent=1))
        if tracer is not None:
            _export_trace(tracer.events)
        return dis

    grow = args.grow_pages or args.swap
    eng = ServingEngine(
        max_seq=args.prompt_len + args.max_new + 4,
        backend=args.backend, plan=plan, coloring=args.coloring,
        paged=args.paged or args.prefix_cache or grow,
        page_size=args.page_size, kv_pages=args.kv_pages,
        grow_pages=grow, swap=args.swap, cold_dtype=args.cold_dtype,
        prefix_cache=args.prefix_cache, use_flash=args.use_flash,
        chunk_size=args.chunk_size, token_budget=args.token_budget,
        preempt_tile=args.preempt_tile,
        chunk_governor=(ChunkGovernor(target_tbt_ms=args.adapt_chunk,
                                      chunk=args.chunk_size or 64,
                                      min_chunk=min(8, args.chunk_size or 64))
                        if args.adapt_chunk else None),
        slots_ls=args.slots, slots_be=args.slots, device=args.gpu
        if args.gpu in GPU_DEVICES else "tpu-v5e",
        controller=ctrl, control_interval=args.control_interval,
        faults=faults, fault_recovery=not args.no_fault_recovery,
        fault_budget=args.fault_budget, max_queue=args.max_queue,
        now_fn=now_fn, tracer=tracer, torch_device=args.torch_device,
        hash_model=gpu_hash_model(args.gpu)
        if args.coloring and args.backend == "torch" else None)
    rng = np.random.default_rng(0)
    # torch backend executes reduced (smoke) models for real; the sim backend
    # models the FULL configs at paper-scale request shapes. With
    # --prefix-cache the sim tenants stay stream-derived (no sim_seq): the
    # prefix estimator only applies to request streams, so a fixed sim_seq
    # would silently disable the suffix-only prefill costing
    sim = args.backend == "sim"
    sim_seq_ls = None if args.prefix_cache else 128
    sim_seq_be = None if args.prefix_cache else 256
    for name in args.ls:
        cfg = (get_config(name) if sim
               else smoke_config(name).replace(activation_dtype="float32"))
        eng.add_tenant(TenantSpec(f"ls:{name}", "LS", nice=10_000), cfg,
                       sim_seq=sim_seq_ls if sim else None)
    for name in args.be:
        cfg = (get_config(name) if sim
               else smoke_config(name).replace(activation_dtype="float32"))
        eng.add_tenant(TenantSpec(f"be:{name}", "BE", nice=1, batch_size=8
                                  if sim else 1), cfg,
                       sim_seq=sim_seq_be if sim else None)
    # with --prefix-cache, give the stream a shared system-prompt prefix so
    # the radix tree has something to hit (drawn only then, so existing
    # configurations keep their exact token streams)
    shared = (rng.integers(0, 256, args.prompt_len // 2)
              if args.prefix_cache else None)
    for i in range(args.requests):
        for t in eng.tenants:
            toks = rng.integers(0, 256, args.prompt_len)
            if args.prefix_cache:
                toks[: len(shared)] = shared
            eng.submit(t, toks, max_new=args.max_new,
                       at=0.05 * i if args.backend == "sim" else None)
    steps = eng.run_until_idle(horizon=args.requests * 0.1 + 2.0
                               if args.backend == "sim" else None)
    import json
    print(json.dumps(eng.metrics(), indent=1))
    print(f"engine quanta executed: {steps}" if args.backend == "torch"
          else f"requests completed in sim: {steps}")
    if tracer is not None:
        _export_trace(tracer.events)
    return eng


if __name__ == "__main__":
    main()

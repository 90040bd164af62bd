"""The port's prefix cache against the reference: twins of
``tests/test_prefix_cache.py``.

``serving/prefix_cache.py`` is a copy of the reference's, so the radix
tree's matching and plan arithmetic are checked on the port's module and
against the reference's on the same inputs. Every engine test runs the
port's engine (``torch_device="cpu"``) and the reference engine on one
virtual clock with the same weights (``_torch_serving_parity``) and holds
them equal in tokens, quantum order, quantum log, transitions, the prefix
tree's stats and the ``prefix_cache`` metrics, beside the reference
test's own checks on the port: token bit-equality with the cache off
under random interleavings, LRU eviction under pool pressure, tree
teardown, copy-on-write isolation, pinning of referenced shared pages
across a resplit, a tidal run under the online controller (whose
``measured_prefix_hit`` gauge now reads the port's trees), and engine
tokens with the cache on across chunk sizes 2, 3 and 8.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _hypothesis_compat import given, settings, st  # noqa: E402
from conftest import FakeHashModel  # noqa: E402
import _torch_serving_parity as par  # noqa: E402

import repro.serving as jserving  # noqa: E402
from repro_torch.serving import PrefixCache  # noqa: E402
from repro_torch.serving.kv_cache import kv_bytes_per_token  # noqa: E402

PS = 4


@pytest.fixture(scope="module")
def tiny():
    return par.tiny_models()


# ---------------------------------------------------------------------------
# radix tree (token-only estimator mode)
# ---------------------------------------------------------------------------

def test_radix_match_and_insert():
    a = list(range(12))
    b = a[:9] + [70, 71, 72]
    queries = [a, a[:8], a[:6], [99] + a, b, a[:9] + [70, 99]]
    out = []
    for mod in (jserving, None):
        pc = (mod.PrefixCache if mod else PrefixCache)(PS)
        pc.insert_tokens(a)                   # 3 full pages
        seen = [pc.match_len(q) for q in queries[:4]]
        pc.insert_tokens(b)                   # sibling edges in a page
        seen += [pc.match_len(q) for q in (b, a, queries[5])]
        n0 = pc.inserted
        pc.insert_tokens(a)                   # an existing stream: no nodes
        out.append((seen, n0, pc.inserted, pc.stats()))
    assert out[1] == out[0]
    assert out[1][0] == [12, 8, 6, 0, 12, 12, 10]
    assert out[1][1] == out[1][2]


def _plans(s, clock):
    eng = par.build(s, clock, tenants=("ls0",), max_seq=20, paged=True,
                    page_size=PS, prefix_cache=True, slots_ls=2)
    prompt = np.arange(12)
    req = eng.submit("ls0", prompt, max_new=4)
    par.drive(eng, clock)
    assert req.hit_tokens == 0
    rt = eng.tenants["ls0"]
    plans = [rt.prefix.plan(prompt, 16),
             rt.prefix.plan(np.concatenate([prompt[:8], [88, 89, 90, 91]]),
                            16)]
    return eng, [req], plans


def test_plan_arithmetic(tiny):
    """A hit needs strictly fewer free pages than the dense extent, and the
    copy-on-write fork count is predicted exactly at admission."""
    got = []
    for name in ("ref", "port"):
        eng, _, plans = _plans(par.side(tiny, name), {"t": 0.0})
        got.append([(p.match_len, p.n_shared, p.n_cow, p.n_new,
                     p.need_free) for p in plans])
    assert got[1] == got[0]
    rt = eng.tenants["ls0"]
    plan, plan2 = plans
    assert plan.match_len == 11               # capped at L-1
    assert plan.n_shared == 3
    assert plan.n_cow == 1                    # replay pos 11 -> page 2 forks
    assert plan.need_free == plan.n_new + 1 < rt.kv.pages_for(16)
    assert plan2.match_len == 8 and plan2.n_shared == 2 and plan2.n_cow == 0


# ---------------------------------------------------------------------------
# engine: sharing on == sharing off, bit for bit, and == the reference
# ---------------------------------------------------------------------------

def _invariants(kv):
    assert (kv.page_ref >= 0).all()
    pt = kv.page_table
    mapped = pt[pt < kv.n_pages]
    # every live page-table entry holds a reference; free pages hold none
    assert (kv.page_ref[mapped] >= 1).all()
    assert all(kv.page_ref[p] == 0 for p in kv.free_list)


def _interleaved(s, clock, *, ops, prefix):
    eng = par.build(s, clock, tenants=("ls0",), max_seq=16, slots_ls=3,
                    paged=True, page_size=PS, kv_pages=10,
                    prefix_cache=prefix)
    reqs = []
    for toks, max_new, steps in ops:
        reqs.append(eng.submit("ls0", toks, max_new=max_new))
        par.step(eng, clock, steps)
        if prefix:
            _invariants(eng.tenants["ls0"].kv)
    par.drive(eng, clock)
    if prefix:
        _invariants(eng.tenants["ls0"].kv)
    return eng, reqs


@given(seed=st.integers(0, 10_000))
@settings(max_examples=3, deadline=None)
def test_prefix_bit_equal_random_interleaving(seed):
    """Random admit/decode/evict/fork interleavings (shared-prefix prompt
    pool, more requests than pages): the port's tokens are bit-equal with
    the prefix cache on and off, refcounts never go negative, and the run
    with the cache on equals the reference engine's."""
    tiny = par.tiny_models()
    rng = np.random.default_rng(seed)
    bases = [rng.integers(0, 100, 8), rng.integers(0, 100, 8)]
    ops = []
    for _ in range(10):
        base = bases[int(rng.integers(2))]
        keep = int(rng.integers(2, 9))
        tail = rng.integers(0, 100, int(rng.integers(0, 5)))
        ops.append((np.concatenate([base[:keep], tail]).astype(np.int32),
                    int(rng.integers(1, 7)), int(rng.integers(1, 4))))
    ref, port, eng = par.run_both(tiny, _interleaved, ops=ops, prefix=True)
    par.assert_same(ref, port)
    _, off = _interleaved(par.side(tiny, "port"), {"t": 0.0}, ops=ops,
                          prefix=False)
    assert port["tokens"] == [r.output for r in off]
    st_on = eng.tenants["ls0"].prefix.stats()
    assert st_on["hits"] + st_on["misses"] == sum(
        1 for r in eng.tenants["ls0"].done if not r.failed)


def _pressure(s, clock):
    eng = par.build(s, clock, tenants=("ls0",), max_seq=16, slots_ls=2,
                    paged=True, page_size=PS, kv_pages=6, prefix_cache=True)
    rng = np.random.default_rng(0)
    reqs = []
    # distinct prompts, sequential: each finish donates full pages; with a
    # 6-page pool the tree must shed old nodes to admit new requests
    for _ in range(5):
        reqs.append(eng.submit("ls0", rng.integers(0, 100, 8), max_new=3))
        par.drive(eng, clock)
    return eng, reqs


def test_eviction_under_pool_pressure(tiny):
    """Cold cached pages are LRU-evicted so admission proceeds; the tree
    never blocks the pool, and zero-ref leaves go first."""
    ref, port, eng = par.run_both(tiny, _pressure)
    par.assert_same(ref, port)
    rt = eng.tenants["ls0"]
    m = eng.metrics()["ls0"]
    assert m["completed"] == 5
    assert m["prefix_cache"]["evictions"] > 0
    _invariants(rt.kv)
    # every surviving tree page is accounted for: ref exactly 1 (the tree)
    for nd in rt.prefix._nodes():
        assert nd.ref == 0 and rt.kv.page_ref[nd.page] == 1


def _plan(s, sm_be=0.3, ch_be=0.25, C=4):
    ls, be = tuple(range(C - 1)), (C - 1,)
    return s.cm.ResourcePlan(sm_be, ch_be, 0.4, ls, be, 1.2)


def _colored(s, clock, *, tenants, controller=None, rows=16, specs=None):
    return par.build(
        s, clock, tenants=tenants, specs=specs, max_seq=16, coloring=True,
        plan=_plan(s), paged=True, page_size=PS,
        hash_model=FakeHashModel(), prefix_cache=True,
        arena_bytes=rows * kv_bytes_per_token(s.cfg) * 16,
        slots_ls=3, slots_be=4, controller=controller, control_interval=2)


def _arena(eng):
    a = eng.arena
    return [(n, al.spt.tolist(), tuple(al.channels))
            for n, al in a.allocations.items()]


def _teardown(s, clock):
    eng = _colored(s, clock, tenants=("ls0",))
    rng = np.random.default_rng(0)
    reqs = [eng.submit("ls0", rng.integers(0, 100, 8), max_new=3)
            for _ in range(3)]
    par.drive(eng, clock)
    return eng, reqs


def test_release_tree_teardown(tiny):
    """Tenant teardown in sharing mode: draining the slots and releasing
    the tree returns every page to the pool and every arena group (slot and
    ``:px`` node groups alike) to the arena, after a run equal to the
    reference's (arena groups included)."""
    arenas = []
    for name in ("ref", "port"):
        eng, _ = _teardown(par.side(tiny, name), {"t": 0.0})
        arenas.append(_arena(eng))
    assert arenas[1] == arenas[0]
    rt = eng.tenants["ls0"]
    assert any(True for _ in rt.prefix._nodes())    # tree holds pages
    rt.kv.release()
    rt.prefix.release_tree()
    assert len(rt.kv.free_list) == rt.kv.n_pages
    assert (rt.kv.page_ref == 0).all()
    assert not any(n.startswith("ls0") for n in eng.arena.allocations)


def _sharers(s, clock, *, prefix=True):
    prompt = np.arange(8, dtype=np.int32)
    eng = par.build(s, clock, tenants=("ls0",), max_seq=16, slots_ls=2,
                    paged=True, page_size=PS, prefix_cache=prefix)
    a = eng.submit("ls0", prompt, max_new=6)
    par.step(eng, clock)               # admit+donate A, A still decoding
    b = eng.submit("ls0", prompt, max_new=6)   # full-prompt hit
    par.drive(eng, clock)
    return eng, [a, b]


def test_cow_fork_isolates_sharers(tiny):
    """Two live requests sharing a full-prompt prefix: the second's replay
    forks the boundary page, and the first's output is unaffected (against
    the sharing-off run), as in the reference."""
    ref, port, eng = par.run_both(tiny, _sharers)
    par.assert_same(ref, port)
    _, off = _sharers(par.side(tiny, "port"), {"t": 0.0}, prefix=False)
    assert port["tokens"] == [r.output for r in off]
    assert port["tokens"][0] == port["tokens"][1]
    kv = eng.tenants["ls0"].kv
    assert kv.cow_forks >= 1
    assert eng.tenants["ls0"].done[1].hit_tokens == 7   # L-1 of 8 tokens


# ---------------------------------------------------------------------------
# recolor / resplit under active shared pages (pinning)
# ---------------------------------------------------------------------------

def _pinning(s, clock):
    eng = _colored(s, clock, tenants=("ls0",))
    rt = eng.tenants["ls0"]
    prompt = np.arange(8, dtype=np.int32)
    reqs = [eng.submit("ls0", prompt, max_new=8)]
    par.step(eng, clock)                       # A admitted, pages donated
    reqs.append(eng.submit("ls0", prompt, max_new=8))   # B shares them
    par.step(eng, clock)
    pinned = rt.prefix.pinned_names()
    arena = eng.arena
    placed = {n: arena.page_channel[arena.allocations[n].spt].copy()
              for n in pinned}
    eng.apply_plan(_plan(s, 0.3, 0.5))         # pure channel move
    moved = {n: arena.page_channel[arena.allocations[n].spt].copy()
             for n in pinned}
    par.drive(eng, clock)                      # refs drop at eviction
    drain = rt.prefix.drain_recolor()
    eng._pin_state = (pinned, placed, moved, drain)
    return eng, reqs


def test_resplit_pins_referenced_shared_pages(tiny):
    """A mid-run ch_be move with live shared pages: referenced node groups
    are excluded from the migration (their placement is untouched), and
    they drain to the new color once their references drop; the port's
    pinned names, placements and drain equal the reference's."""
    states = []
    for name in ("ref", "port"):
        eng, reqs = _pinning(par.side(tiny, name), {"t": 0.0})
        pinned, placed, moved, drain = eng._pin_state
        states.append((pinned, {n: v.tolist() for n, v in placed.items()},
                       sorted(drain), eng.transitions,
                       [r.output for r in reqs]))
    assert states[1] == states[0]
    assert pinned, "no live shared pages to pin"
    for n in pinned:                           # pinned: placement untouched
        np.testing.assert_array_equal(moved[n], placed[n])
    assert eng.transitions[-1]["pinned_groups"] == len(pinned)
    arena = eng.arena
    live = [n for n in pinned if n in arena.allocations]
    assert set(drain) >= set(live)             # now migratable
    arena.resplit(drain)
    for n in drain:
        if n in arena.allocations:
            assert arena.isolation_violations(arena.allocations[n]) == 0


def _online(s, clock):
    ctrl = s.cm.OnlineController(s.cm.tidal_frontier(_plan(s), 4),
                                 idle_patience=1)
    eng = _colored(s, clock, tenants=("ls0", "be0"), controller=ctrl,
                   specs={"ls0": {"slo_ms": 300_000.0}})
    arena = eng.arena
    real_resplit = arena.resplit

    def checked_resplit(mapping, pinned=()):
        for rt in eng.tenants.values():
            if rt.prefix is None:
                continue
            for name in rt.prefix.pinned_names():
                assert name not in mapping, \
                    f"{name} migrated while referenced"
        return real_resplit(mapping, pinned=pinned)

    arena.resplit = checked_resplit
    rng = np.random.default_rng(2)
    base = rng.integers(0, 100, 8)
    reqs = []
    # two tides with idle troughs between them: lending, snap-back, resplit
    for _ in range(2):
        for _ in range(2):
            reqs.append(eng.submit("ls0", np.concatenate(
                [base, rng.integers(0, 100, 2)]), max_new=3))
        for _ in range(4):
            reqs.append(eng.submit("be0", np.concatenate(
                [base, rng.integers(0, 100, 2)]), max_new=6))
        par.drive(eng, clock)
    return eng, reqs


def test_prefix_cache_with_online_controller(tiny):
    """A tidal online run with prefix_cache=True completes with full LS SLO
    attainment, never migrates a referenced shared page, and equals the
    reference engine's run — its transitions and its live
    ``measured_prefix_hit`` gauge (in the registry) included."""
    ref, port, eng = par.run_both(tiny, _online)
    par.assert_same(ref, port)
    m = eng.metrics()
    assert m["ls0"]["completed"] == 4 and m["be0"]["completed"] == 8
    assert m["_class"]["LS"]["slo_attainment"] == 1.0
    assert eng.transitions, "controller never re-planned"
    assert m["_online"]["migrated_bytes"] == eng.migrated_bytes
    hits = (m["ls0"]["prefix_cache"]["hits"]
            + m["be0"]["prefix_cache"]["hits"])
    assert hits > 0, "shared-prefix workload produced no cache hits"
    assert port["registry"]["gauges"]["measured_prefix_hit"]["value"] > 0


# ---------------------------------------------------------------------------
# engine tokens with the cache on across chunk sizes (the scheduler grid)
# ---------------------------------------------------------------------------

def _grid(s, clock, *, chunk):
    eng = par.build(s, clock, tenants=("ls0",), max_seq=24, slots_ls=3,
                    paged=True, page_size=PS, prefix_cache=True,
                    chunk_size=chunk)
    rng = np.random.default_rng(5)
    base = rng.integers(0, 100, 10)
    reqs = []
    for i in range(6):
        tail = rng.integers(0, 100, int(rng.integers(0, 5)))
        reqs.append(eng.submit("ls0", np.concatenate(
            [base[:int(rng.integers(3, 11))], tail]), max_new=5))
        par.step(eng, clock, 2)
    par.drive(eng, clock)
    return eng, reqs


@pytest.fixture(scope="module")
def grid_ref(tiny):
    eng, reqs = _grid(par.side(tiny, "ref"), {"t": 0.0}, chunk=None)
    return [r.output for r in reqs]


@pytest.mark.parametrize("chunk", [2, 3, 8])
def test_prefix_engine_tokens_across_chunks(tiny, grid_ref, chunk):
    """Tokens with the cache on are chunking-invariant in the reference
    (``tests/test_scheduler.py``); the port's at chunk 2, 3 and 8 equal the
    reference's at whole-prompt chunks."""
    eng, reqs = _grid(par.side(tiny, "port"), {"t": 0.0}, chunk=chunk)
    assert [r.output for r in reqs] == grid_ref
    assert sum(r.hit_tokens for r in reqs) > 0

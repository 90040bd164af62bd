"""The port's attention kernels against the reference's Pallas kernels.

CPU: the plain PyTorch versions (what ``repro_torch.kernels.ops`` runs for
CPU tensors) against the JAX kernels in interpret mode, on the same inputs
made from a numpy seed, at the shapes of ``tests/test_kernels.py``: dense and
paged decode and chunked prefill, ragged positions, non-dividing windows,
the abort/progress protocol and Sq == 1 prefill == decode; chunked prefill
split in two calls and cut at an abort cap against the whole chunk, the
route each dtype and head dim takes, and the prefill wrapper's refusal of
rows off 16-byte boundaries. Tolerances are the reference's: 2e-5 in f32,
3e-2 in bf16.

The split-K decode kernel's plan (``kernels/decode_attention.py``): every
visible key read once by the cluster's blocks for every row position and
window, and the plan's split-then-merge algebra against the plain decode.

CUDA (marked ``cuda``, skipped without a card): each CUDA kernel against its
plain version on the card (f16 too), on both prefill routes, with the
late-row relative L2 of decode and prefill, bshd == bhsd, determinism and
batch invariance bit for bit (and for prefill the abort prefix and the chunk
split), and the Sq == 1 prefill == decode check per dtype. The JAX reference
is imported lazily so that this file also runs on a machine without JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.fixture(scope="module")
def jx():
    """(jax.numpy, reference ops) — the reference side of every parity
    test."""
    jax = pytest.importorskip("jax")
    from repro.kernels import ops as jops
    return jax.numpy, jops


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(jnp, a, dtype):
    """The same values on both sides: f32 numpy rounded to ``dtype`` by
    each framework (both round to nearest even)."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _close(got, want, dtype="float32"):
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


def _paged(rng, kc, vc, ps, n_pages):
    """Scatter dense [B,S,Hkv,D] caches onto a shuffled page pool."""
    B, Smax, Hkv, D = kc.shape
    P = Smax // ps
    pages = rng.permutation(n_pages)[:B * P].reshape(B, P)
    kp = np.zeros((n_pages, Hkv, ps, D), np.float32)
    vp = np.zeros((n_pages, Hkv, ps, D), np.float32)
    for b in range(B):
        for j in range(P):
            kp[pages[b, j]] = kc[b, j * ps:(j + 1) * ps].transpose(1, 0, 2)
            vp[pages[b, j]] = vc[b, j * ps:(j + 1) * ps].transpose(1, 0, 2)
    return kp, vp, pages.astype(np.int32)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Smax,H,Hkv,D,pos", [
    (2, 256, 8, 2, 64, 0), (2, 256, 8, 2, 64, 100), (1, 512, 4, 4, 128, 511),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_sweep(jx, B, Smax, H, Hkv, D, pos, dtype):
    jnp, jops = jx
    rng = np.random.default_rng(3)
    q, kc, vc = (_rand(rng, s) for s in ((B, H, D), (B, Smax, Hkv, D),
                                         (B, Smax, Hkv, D)))
    (jq, tq), (jk, tk), (jv, tv) = (_both(jnp, a, dtype) for a in (q, kc, vc))
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(pos, jnp.int32),
                                 block_k=64)
    got = ops.decode_attention(tq, tk, tv, torch.tensor(pos), block_k=64)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_ragged_pos(jx, dtype):
    jnp, jops = jx
    B, Smax, H, Hkv, D = 4, 256, 8, 2, 64
    rng = np.random.default_rng(6)
    q, kc, vc = (_rand(rng, s) for s in ((B, H, D), (B, Smax, Hkv, D),
                                         (B, Smax, Hkv, D)))
    pos = np.asarray([0, 17, 128, 255], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(jnp, a, dtype) for a in (q, kc, vc))
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(pos), block_k=64)
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(pos), block_k=64)
    _close(got, want, dtype)


@pytest.mark.parametrize("Smax,block_k", [(192, 128), (100, 64)])
def test_decode_attention_nondividing_window(jx, Smax, block_k):
    """A window block_k doesn't divide, plus the dense sentinel row
    ``pos == Smax`` (every key visible)."""
    jnp, jops = jx
    B, H, Hkv, D = 3, 4, 2, 64
    rng = np.random.default_rng(9)
    q, kc, vc = (_rand(rng, s) for s in ((B, H, D), (B, Smax, Hkv, D),
                                         (B, Smax, Hkv, D)))
    pos = np.asarray([7, Smax - 1, Smax], np.int32)
    want = jops.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(pos),
                                 block_k=block_k)
    got = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                               torch.from_numpy(vc), torch.from_numpy(pos),
                               block_k=block_k)
    _close(got, want)


def test_decode_attention_kv_major_layout(jx):
    """``bhsd`` (the serving layout) equals ``bshd`` on the port and agrees
    with the reference's ``bhsd`` kernel."""
    jnp, jops = jx
    B, Smax, H, Hkv, D = 2, 128, 4, 2, 64
    rng = np.random.default_rng(7)
    q, kc, vc = (_rand(rng, s) for s in ((B, H, D), (B, Smax, Hkv, D),
                                         (B, Smax, Hkv, D)))
    pos = np.asarray([3, 100], np.int32)
    kt, vt = kc.transpose(0, 2, 1, 3).copy(), vc.transpose(0, 2, 1, 3).copy()
    want = jops.decode_attention(jnp.asarray(q), jnp.asarray(kt),
                                 jnp.asarray(vt), jnp.asarray(pos),
                                 block_k=32, kv_layout="bhsd")
    a = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                             torch.from_numpy(vc), torch.from_numpy(pos))
    b = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(kt),
                             torch.from_numpy(vt), torch.from_numpy(pos),
                             kv_layout="bhsd")
    assert torch.equal(a, b)
    _close(b, want)


def test_decode_attention_paged(jx):
    """Paged decode through a shuffled page table with partially-mapped
    rows, negative and past-the-pool entries, and a sentinel row at
    ``pos == P * page_size``."""
    jnp, jops = jx
    B, Smax, H, Hkv, D, ps, n_pages = 4, 128, 8, 2, 64, 16, 40
    rng = np.random.default_rng(8)
    q = _rand(rng, (B, H, D))
    kc, vc = _rand(rng, (B, Smax, Hkv, D)), _rand(rng, (B, Smax, Hkv, D))
    kp, vp, pt = _paged(rng, kc, vc, ps, n_pages)
    pt[0, 1:] = n_pages            # row 0 (pos 5 < ps): rest unmapped
    pt[1, 5:] = -1                 # negative entries past row 1's pages
    pos = np.asarray([5, 63, 127, Smax], np.int32)
    args = (q, kp, vp, pt, pos)
    want = jops.decode_attention_paged(*(jnp.asarray(a) for a in args))
    got = ops.decode_attention_paged(*(torch.from_numpy(a) for a in args))
    _close(got, want)


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,Smax,Sq,H,Hkv,D", [
    (2, 256, 8, 8, 2, 64), (1, 128, 16, 4, 4, 64), (2, 128, 1, 4, 2, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_attention_sweep(jx, B, Smax, Sq, H, Hkv, D, dtype):
    jnp, jops = jx
    rng = np.random.default_rng(11)
    q = _rand(rng, (B, Sq, H, D))
    kc, vc = _rand(rng, (B, Hkv, Smax, D)), _rand(rng, (B, Hkv, Smax, D))
    pos = np.asarray(list(range(0, B * 37, 37))[:B], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(jnp, a, dtype) for a in (q, kc, vc))
    want = jops.prefill_attention(jq, jk, jv, jnp.asarray(pos), block_k=64)
    got = ops.prefill_attention(tq, tk, tv, torch.from_numpy(pos),
                                block_k=64)
    _close(got, want, dtype)


def test_prefill_attention_paged(jx):
    jnp, jops = jx
    B, Smax, Sq, H, Hkv, D, ps, n_pages = 3, 128, 8, 8, 2, 64, 16, 32
    rng = np.random.default_rng(12)
    q = _rand(rng, (B, Sq, H, D))
    kc, vc = _rand(rng, (B, Smax, Hkv, D)), _rand(rng, (B, Smax, Hkv, D))
    kp, vp, pt = _paged(rng, kc, vc, ps, n_pages)
    pt[0, 1:] = n_pages            # row 0 (chunk within page 0): unmapped
    pos = np.asarray([0, 40, 120], np.int32)
    args = (q, kp, vp, pt, pos)
    want = jops.prefill_attention_paged(*(jnp.asarray(a) for a in args))
    got = ops.prefill_attention_paged(*(torch.from_numpy(a) for a in args))
    _close(got, want)


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_attention_abort_progress(jx, paged):
    """abort caps {0, 1, 3, Sq, Sq+5}: progress equals the reference's
    exactly, and the rows before each cap agree."""
    jnp, jops = jx
    B, Smax, Sq, H, Hkv, D, ps = 5, 128, 8, 4, 2, 64, 16
    rng = np.random.default_rng(24)
    q = _rand(rng, (B, Sq, H, D))
    kc, vc = _rand(rng, (B, Smax, Hkv, D)), _rand(rng, (B, Smax, Hkv, D))
    pos = np.asarray([0, 13, 40, 77, 100], np.int32)
    abort = np.asarray([0, 1, 3, Sq, Sq + 5], np.int32)
    if paged:
        kp, vp, pt = _paged(rng, kc, vc, ps, 48)
        args = (q, kp, vp, pt, pos)
        want, wprog = jops.prefill_attention_paged(
            *(jnp.asarray(a) for a in args), abort=jnp.asarray(abort))
        got, prog = ops.prefill_attention_paged(
            *(torch.from_numpy(a) for a in args),
            abort=torch.from_numpy(abort))
    else:
        kt = kc.transpose(0, 2, 1, 3).copy()
        vt = vc.transpose(0, 2, 1, 3).copy()
        args = (q, kt, vt, pos)
        want, wprog = jops.prefill_attention(
            *(jnp.asarray(a) for a in args), block_k=32,
            abort=jnp.asarray(abort))
        got, prog = ops.prefill_attention(
            *(torch.from_numpy(a) for a in args), block_k=32,
            abort=torch.from_numpy(abort))
    assert prog.dtype == torch.int32
    np.testing.assert_array_equal(prog.numpy(), np.asarray(wprog))
    np.testing.assert_array_equal(prog.numpy(), np.minimum(abort, Sq))
    for b, cap in enumerate(np.minimum(abort, Sq)):
        _close(got[b, :cap], np.asarray(want)[b, :cap])


def test_prefill_attention_reduces_to_decode(jx):
    """An Sq == 1 chunk is a decode step, on the port as in the
    reference."""
    jnp, jops = jx
    B, Smax, H, Hkv, D = 2, 128, 4, 2, 64
    rng = np.random.default_rng(13)
    q = _rand(rng, (B, 1, H, D))
    kc, vc = _rand(rng, (B, Hkv, Smax, D)), _rand(rng, (B, Hkv, Smax, D))
    pos = np.asarray([3, 90], np.int32)
    tq, tk, tv, tp = (torch.from_numpy(a) for a in (q, kc, vc, pos))
    a = ops.prefill_attention(tq, tk, tv, tp)
    b = ops.decode_attention(tq[:, 0], tk, tv, tp, kv_layout="bhsd")
    torch.testing.assert_close(a[:, 0], b, rtol=2e-6, atol=2e-6)
    want = jops.decode_attention(jnp.asarray(q[:, 0]), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(pos),
                                 block_k=32, kv_layout="bhsd")
    _close(a[:, 0], want)


@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_prefill_route(dtype, D):
    """bf16 at head dim 64 or 128 takes the tensor-core body; f32, f16 and
    bf16 at head dim 32 the CUDA-core body."""
    from repro_torch.kernels import prefill_attention as kp_
    want = "wgmma" if dtype == "bfloat16" and D in (64, 128) else "simt"
    assert kp_.route(getattr(torch, dtype), D) == want


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_prefill_wrapper_refuses_unaligned_rows(dtype):
    """Both bodies copy q, k and v rows in 16-byte pieces: the wrapper
    raises on rows that do not start on 16-byte boundaries, before any
    launch; given a CPU tensor it raises rather than fall back."""
    from repro_torch.kernels import prefill_attention as kp_
    dt = getattr(torch, dtype)
    q = torch.zeros(1, 3, 2, 32, dtype=dt)
    kc = torch.zeros(1, 2, 16, 32, dtype=dt)
    pos = torch.zeros(1, dtype=torch.int32)
    odd_q = torch.zeros(1, 3, 2, 33, dtype=dt)[..., 1:]    # starts 1 off
    odd_k = torch.zeros(1, 2, 16, 33, dtype=dt)[..., :32]  # rows 33 apart
    with pytest.raises(ValueError, match="16-byte aligned"):
        kp_.prefill_attention(odd_q, kc, kc, pos)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kp_.prefill_attention(q, odd_k, odd_k, pos)
    with pytest.raises(ValueError, match="CUDA kernel called on cpu"):
        kp_.prefill_attention(q, kc, kc, pos)


# The plain version against itself across chunkings: the same rows in
# calls of other shapes, where PyTorch's CPU matmul may sum in another
# order (an Sq == 1 call takes a matrix-vector product): f32 within the
# reference's 2e-6 for two summation orders; bf16 within one output
# rounding (2^-7 of the value, 1e-4 near zero).
SPLIT_TOL = {"float32": (2e-6, 2e-6), "bfloat16": (2 ** -7, 1e-4)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefill_chunk_split_and_abort_prefix(jx, paged, dtype):
    """A chunk split in two calls (rows [a, Sq) from a call at pos + a)
    gives the whole chunk's rows, and the rows before an abort cap equal a
    chunk of exactly that many tokens: the port's plain version against the
    reference's kernels (interpret mode) on the same inputs, and each side
    against its own whole chunk (the reference bit for bit, as its
    tests/test_kernels.py asserts for the abort prefix)."""
    jnp, jops = jx
    B, Smax, Sq, H, Hkv, D, ps = 3, 256, 40, 4, 2, 64, 16
    rng = np.random.default_rng(31)
    q = _rand(rng, (B, Sq, H, D))
    kc, vc = _rand(rng, (B, Smax, Hkv, D)), _rand(rng, (B, Smax, Hkv, D))
    pos = np.asarray([0, 13, 150], np.int32)
    if paged:
        kp, vp, pt = _paged(rng, kc, vc, ps, 56)
        kv = (kp, vp, pt)
        jfn, tfn, kw = jops.prefill_attention_paged, \
            ops.prefill_attention_paged, {}
    else:
        kv = (kc.transpose(0, 2, 1, 3).copy(), vc.transpose(0, 2, 1, 3).copy())
        jfn, tfn, kw = jops.prefill_attention, ops.prefill_attention, \
            {"block_k": 32}
    jkv = [jnp.asarray(a) for a in kv]
    jkv[:2] = [a.astype(getattr(jnp, dtype)) for a in jkv[:2]]
    tkv = [torch.from_numpy(a) for a in kv]
    tkv[:2] = [a.to(getattr(torch, dtype)) for a in tkv[:2]]
    jq, tq = _both(jnp, q, dtype)
    rtol, atol = SPLIT_TOL[dtype]

    def run(rows, p, **extra):
        return (jfn(jq[:, rows], *jkv, jnp.asarray(p), **kw, **extra),
                tfn(tq[:, rows], *tkv, torch.from_numpy(p), **kw, **extra))

    whole_j, whole_t = run(slice(None), pos)
    _close(whole_t, whole_j, dtype)
    for a in (1, 37):
        part_j, part_t = run(slice(a, None), pos + a)
        _close(part_t, part_j, dtype)
        _close(part_t, np.asarray(whole_j)[:, a:], dtype)
        torch.testing.assert_close(part_t, whole_t[:, a:], rtol=rtol,
                                   atol=atol)
    abort = np.asarray([3, Sq + 5, 0], np.int32)
    (out_j, prog_j), (out_t, prog_t) = run(slice(None), pos,
                                           abort=jnp.asarray(abort))
    np.testing.assert_array_equal(prog_t.numpy(), np.asarray(prog_j))
    small_j, small_t = run(slice(0, 3), pos)
    np.testing.assert_array_equal(np.asarray(out_j)[0, :3],
                                  np.asarray(small_j)[0])
    _close(out_t[0, :3], np.asarray(small_j)[0], dtype)
    torch.testing.assert_close(out_t[0, :3], small_t[0], rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(out_t[1], whole_t[1], rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the split-K decode kernel's plan (kernels/decode_attention.py), which the
# CUDA kernel follows key for key
# ---------------------------------------------------------------------------

SPLIT_WINDOWS = [1, 15, 16, 1000, 2048, 4096]


@pytest.mark.parametrize("page_size", [16, 0], ids=["paged16", "dense"])
@pytest.mark.parametrize("window", SPLIT_WINDOWS)
def test_split_plan_covers_every_key_once(window, page_size):
    """For every row position 0..window (the last one the sentinel row
    ``pos == window``), the cluster's blocks read each visible key exactly
    once, never a key past ``min(pos, window - 1)``, in whole-page splits;
    on a page table no block reaches past the row's last page or past
    column P."""
    from repro_torch.kernels import decode_attention as kd
    plan = kd.split_plan(window, page_size)
    assert plan.split % (page_size or kd.DENSE_UNIT) == 0
    assert plan.split <= max(kd.SPLIT_KEYS, page_size)
    assert plan.n_split * plan.split >= window > (plan.n_split - 1) * \
        plan.split
    assert 1 <= plan.cluster <= kd.CLUSTER_MAX
    for pos in range(-1, window + 1):
        n = kd.visible_keys(pos, window)
        assert n == (0 if pos < 0 else min(pos + 1, window))
        seen = np.zeros(window + plan.split, np.int64)
        for c in range(plan.cluster):
            ranges = kd.block_ranges(plan, n, c)
            assert ranges == sorted(ranges)
            for lo, hi in ranges:
                assert lo % plan.split == 0 and lo < hi <= n
                seen[lo:hi] += 1
        assert (seen[:n] == 1).all() and not seen[n:].any(), pos
        if page_size and n:
            assert (n - 1) // page_size <= pos // page_size
            assert (n - 1) // page_size < -(-window // page_size)


def test_split_plan_ignores_the_batch():
    """The plan takes no batch and no position: a row's blocks read the
    same ranges in the same order whether it is decoded alone or in a
    batch of 8, and the split length is the same for every batch."""
    from repro_torch.kernels import decode_attention as kd
    import inspect
    assert list(inspect.signature(kd.split_plan).parameters) == [
        "window", "page_size"]
    plan = kd.split_plan(2048, 16)
    assert plan == kd.SplitPlan(128, 16, 8)
    batch = [0, 17, 255, 256, 1000, 2047, 2048, 1777]
    alone = {p: [kd.block_ranges(kd.split_plan(2048, 16),
                                 kd.visible_keys(p, 2048), c)
                 for c in range(plan.cluster)] for p in batch}
    together = [[kd.block_ranges(plan, kd.visible_keys(p, 2048), c)
                 for c in range(plan.cluster)] for p in batch]
    assert together == [alone[p] for p in batch]
    assert kd.block_ranges(plan, 2048, 0) == [(0, 128), (1024, 1152)]
    assert kd.block_ranges(plan, 1000, 7) == [(896, 1000)]
    assert kd.split_plan(512, 16) == kd.SplitPlan(64, 8, 8)
    assert kd.split_plan(15, 0) == kd.SplitPlan(16, 1, 1)


@pytest.mark.parametrize("G", [1, 2, 3, 4, 6, 8, 12, 16])
def test_heads_per_block_covers_every_head(G):
    """A block serves heads_per_block(G) query heads of one KV head; the
    ceil(G / that) blocks of a KV head cover its G heads exactly once."""
    from repro_torch.kernels import decode_attention as kd
    gm = kd.heads_per_block(G)
    assert gm in (1, 2, 4, 8) and (gm >= G or gm == kd.MAX_HEADS_PER_BLOCK)
    heads = [gc * gm + g for gc in range(-(-G // gm)) for g in range(gm)
             if gc * gm + g < G]
    assert heads == list(range(G))


def _split_decode(q, kc, vc, pos, plan):
    """The kernel's algebra in plain PyTorch (f64): per (row, KV head), each
    cluster block runs an online softmax over its ranges in order, then the
    blocks that hold keys merge their (m, l, acc) in block order. q:
    [B,H,D]; caches [B,Hkv,S,D]."""
    from repro_torch.kernels import decode_attention as kd
    B, H, D = q.shape
    Hkv, S = kc.shape[1], kc.shape[2]
    G = H // Hkv
    f = torch.float64
    out = torch.zeros(B, H, D)
    for b in range(B):
        n = kd.visible_keys(int(pos[b]), S)
        for h in range(Hkv):
            qs = q[b, h * G:(h + 1) * G].to(f) * D ** -0.5
            parts = []
            for c in range(plan.cluster):
                ranges = kd.block_ranges(plan, n, c)
                m = torch.full((G,), -1e30, dtype=f)
                l, acc = torch.zeros(G, dtype=f), torch.zeros(G, D, dtype=f)
                for lo, hi in ranges:
                    s = qs @ kc[b, h, lo:hi].to(f).T
                    mx = torch.maximum(m, s.max(1).values)
                    p, a = torch.exp(s - mx[:, None]), torch.exp(m - mx)
                    l = l * a + p.sum(1)
                    acc = acc * a[:, None] + p @ vc[b, h, lo:hi].to(f)
                    m = mx
                if ranges:
                    parts.append((m, l, acc))
            if not parts:
                continue
            mx = torch.stack([p[0] for p in parts]).max(0).values
            l = sum(p[1] * torch.exp(p[0] - mx) for p in parts)
            acc = sum(p[2] * torch.exp(p[0] - mx)[:, None] for p in parts)
            out[b, h * G:(h + 1) * G] = (acc / l.clamp_min(1e-30)[:, None]
                                         ).float()
    return out


@pytest.mark.parametrize("Smax", [15, 1000, 2048])
def test_split_decode_algebra_matches_plain(Smax):
    """Split, then merge in the kernel's order: equal to the plain
    single-pass decode within f32 rounding (2e-6), for rows at pos 0, at
    a split boundary, mid-window, past Smax and at the sentinel."""
    from repro_torch.kernels import decode_attention as kd
    B, H, Hkv, D = 5, 4, 2, 32
    rng = np.random.default_rng(21)
    q = torch.from_numpy(_rand(rng, (B, H, D)))
    kc = torch.from_numpy(_rand(rng, (B, Hkv, Smax, D)))
    vc = torch.from_numpy(_rand(rng, (B, Hkv, Smax, D)))
    pos = torch.tensor([0, min(255, Smax - 1), Smax // 2, Smax, Smax + 7])
    got = _split_decode(q, kc, vc, pos, kd.split_plan(Smax))
    want = ref.ref_decode_attention(q, kc.transpose(1, 2),
                                    vc.transpose(1, 2), pos)
    torch.testing.assert_close(got, want, rtol=2e-6, atol=2e-6)


def test_launch_counts_cpu_path_counts_nothing():
    """The CPU path is the plain version: no kernel launch is counted."""
    ops.reset_launch_counts()
    q = torch.zeros(1, 2, 32)
    kc = torch.zeros(1, 8, 1, 32)
    ops.decode_attention(q, kc, kc, 3)
    ops.prefill_attention(q[:, None], kc.transpose(1, 2),
                          kc.transpose(1, 2), torch.tensor([0]))
    assert sum(ops.launch_counts().values()) == 0


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

# On the card, f16 beside the reference's two: f16 inputs are rounded the
# same on both sides, so the kernel and the plain version differ by f32
# summation order and one output rounding (2^-11 of the value) each.
CUDA_TOL = {**TOL, "float16": 2e-3}
# Decode, per (row, KV head) over the rows that see >= 512 keys: relative L2
# error against the plain version. CUDA_TOL is blind there, as a row over n
# keys of N(0, 1) values has outputs of about sqrt(e / n), 0.037 at n 2000.
# A sound kernel misses by its output rounding; a 256-key split read twice
# or dropped by ~sqrt(256 / n) (chip_smoke.py measures such a fault).
LATE_REL_TOL = {"float32": 1e-4, "float16": 2e-3, "bfloat16": 2e-2}
# Sq == 1 prefill against decode, elementwise (rtol, atol): two CUDA-core
# bodies that sum in f32 in other orders. f32: the reference's 2e-6. f16:
# each body rounds its f32 result once, so they agree to one output
# rounding (at most 2^-10 of the value).
SQ1_TOL = {"float32": (2e-6, 2e-6), "float16": (2 ** -10, 1e-4)}
# bf16 prefill takes the tensor-core body, which rounds P to bf16 for P.V
# while decode keeps P in f32: short rows' near-zero outputs miss one output
# rounding elementwise (excess 2.2e-4 to 1.4e-3 on an H100, chip_smoke.py
# phase 3), so the two are held per (row, KV head) by relative L2 (sound
# 2.85e-3 to 4.22e-3 there, a planted 128-key tile fault 0.235 to 0.304).
SQ1_REL_TOL = {"bfloat16": 2e-2}


def _late_rows_close(got, want, pos, window, Hkv, dtype):
    """Per (row, KV head) of the rows that see >= 512 keys: relative L2 of
    ``got`` against ``want`` within LATE_REL_TOL."""
    B, H, D = want.shape
    rows = [b for b, p in enumerate(pos) if min(p, window - 1) + 1 >= 512]
    assert rows
    d = (got.float() - want.float())[rows].reshape(len(rows), Hkv, -1)
    w = want.float()[rows].reshape(len(rows), Hkv, -1)
    rel = (d.norm(dim=2) / w.norm(dim=2)).max().item()
    assert rel <= LATE_REL_TOL[dtype], rel


def _paged_pool(g, dev, dt, pos, H, Hkv, D, ps, P, n_pages):
    """q and random pools, and a page table mapping each row's pages
    (through ``pos``) to distinct random pages; the rest of each row is
    unmapped (``n_pages``), with one negative entry at its end."""
    B = len(pos)
    q = torch.randn(B, H, D, generator=g, device=dev).to(dt)
    kp = torch.randn(n_pages, Hkv, ps, D, generator=g, device=dev).to(dt)
    vp = torch.randn(n_pages, Hkv, ps, D, generator=g, device=dev).to(dt)
    perm = torch.randperm(n_pages, generator=g, device=dev).cpu()
    pt = torch.full((B, P), n_pages, dtype=torch.int32)
    used = 0
    for b, p in enumerate(pos):
        need = min(p // ps + 1, P)
        pt[b, :need] = perm[used:used + need].to(torch.int32)
        used += need
        if need < P:
            pt[b, -1] = -1
    return q, kp, vp, pt.to(dev)


def _prefill_case(g, dev, dt, pos, Sq, H, Hkv, D, window, paged, ps=16):
    """q [B,Sq,H,D] and, for a window of ``window`` keys, a dense KV-major
    cache (k, v) or a page pool (k, v, page table) in which each row's
    pages through ``pos + Sq`` map to distinct random pages and the rest
    are unmapped (the pool size), with one negative entry at the row's
    end."""
    B = len(pos)
    q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(dt)
    if not paged:
        return q, tuple(torch.randn(B, Hkv, window, D, generator=g,
                                    device=dev).to(dt) for _ in range(2))
    P = window // ps
    n_pages = B * P + 8
    kp, vp = (torch.randn(n_pages, Hkv, ps, D, generator=g,
                          device=dev).to(dt) for _ in range(2))
    perm = torch.randperm(n_pages, generator=g, device=dev).cpu()
    pt = torch.full((B, P), n_pages, dtype=torch.int32)
    used = 0
    for b, p in enumerate(pos):
        need = min(-(-(p + Sq) // ps), P)
        pt[b, :need] = perm[used:used + need].to(torch.int32)
        used += need
        if need < P:
            pt[b, -1] = -1
    return q, (kp, vp, pt.to(dev))


def _prefill(paged, q, kv, pos, **kw):
    from repro_torch.kernels import prefill_attention as kp_
    fn = kp_.prefill_attention_paged if paged else kp_.prefill_attention
    return fn(q, *kv, pos, **kw)


def _prefill_ref(paged, q, kv, pos):
    if paged:
        return ref.ref_prefill_attention_paged(q, *kv, pos)
    return ref.ref_prefill_attention(q, kv[0].transpose(1, 2),
                                     kv[1].transpose(1, 2), pos)


def _prefill_late_rel(got, want, pos, window, Hkv):
    """Relative L2 error of ``got`` against ``want`` ([B,Sq,H,D]) per (row,
    KV head) over the chunk positions that see >= 512 keys: [rows that
    have such positions, Hkv]."""
    B, Sq = want.shape[:2]
    seen = torch.clamp(torch.tensor(pos)[:, None] + torch.arange(Sq)[None],
                       max=window - 1) + 1
    sel = (seen >= 512).to(want.device)[:, :, None, None]
    d = ((got.float() - want.float()) * sel).reshape(B, Sq, Hkv, -1)
    w = (want.float() * sel).reshape(B, Sq, Hkv, -1)
    rel = d.square().sum((1, 3)).sqrt() / w.square().sum((1, 3)).sqrt()
    return rel[sel[:, :, 0, 0].any(1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
class TestCudaKernels:
    """Each kernel at small shapes on the card vs ``kernels.ref`` on the
    same tensors (``pytest -m cuda tests/test_torch_kernels.py``)."""

    @pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
    @pytest.mark.parametrize("G", [1, 2, 4, 8])
    @pytest.mark.parametrize("D", [32, 64, 128])
    def test_decode(self, cuda, dtype, G, D):
        """Dense decode at windows of one split (Smax 16), of seven (200)
        and of nineteen (2400; both ragged): rows at pos 0, at a split's
        last and first key, mid-window, at the last key and at the
        sentinel. bhsd against the plain version, the late-row check, and
        a bshd copy equal to bhsd bit for bit."""
        from repro_torch.kernels import decode_attention as kd
        g = torch.Generator(device=cuda).manual_seed(0)
        dt = getattr(torch, dtype)
        B, Hkv = 6, 2
        H = G * Hkv
        for Smax, pos in ((16, [0, 3, 9, 15, 16, 40]),
                          (200, [0, 31, 32, 150, 199, 200]),
                          (2400, [0, 127, 128, 1300, 2399, 2400])):
            q = torch.randn(B, H, D, generator=g, device=cuda).to(dt)
            kc = torch.randn(B, Hkv, Smax, D, generator=g,
                             device=cuda).to(dt)
            vc = torch.randn(B, Hkv, Smax, D, generator=g,
                             device=cuda).to(dt)
            p = torch.tensor(pos, device=cuda, dtype=torch.int32)
            got = kd.decode_attention(q, kc, vc, p, kv_layout="bhsd")
            want = ref.ref_decode_attention(q, kc.transpose(1, 2),
                                            vc.transpose(1, 2), p)
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=CUDA_TOL[dtype],
                                       atol=CUDA_TOL[dtype])
            if Smax > 512:
                _late_rows_close(got, want, pos, Smax, Hkv, dtype)
            bshd = kd.decode_attention(q, kc.transpose(1, 2).contiguous(),
                                       vc.transpose(1, 2).contiguous(), p)
            assert torch.equal(got, bshd)

    @pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
    @pytest.mark.parametrize("H,Hkv,D", [(16, 8, 128), (32, 32, 64),
                                         (8, 1, 32)])
    def test_decode_paged(self, cuda, dtype, H, Hkv, D):
        """Paged decode over a 160-page table (20 splits) into a shuffled
        pool: rows at pos 0, at a split's last and first key, mid-window,
        the last key and the sentinel ``P * page``, with unmapped
        (``n_pages``) and negative entries past each row's pages."""
        from repro_torch.kernels import decode_attention as kd
        g = torch.Generator(device=cuda).manual_seed(3)
        dt = getattr(torch, dtype)
        ps, P, n_pages = 16, 160, 1200
        pos = [0, 127, 128, 1000, 2559, P * ps, 40]
        q, kp, vp, pt = _paged_pool(g, cuda, dt, pos, H, Hkv, D, ps, P,
                                    n_pages)
        p = torch.tensor(pos, device=cuda, dtype=torch.int32)
        got = kd.decode_attention_paged(q, kp, vp, pt, p)
        want = ref.ref_decode_attention_paged(q, kp, vp, pt, p)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=CUDA_TOL[dtype], atol=CUDA_TOL[dtype])
        _late_rows_close(got, want, pos, P * ps, Hkv, dtype)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
    def test_decode_bits_invariant(self, cuda, dtype, paged):
        """Two calls give the same bits, and a row decoded alone gives the
        same bits as inside a batch of 8 (the split plan never depends on
        the batch)."""
        from repro_torch.kernels import decode_attention as kd
        g = torch.Generator(device=cuda).manual_seed(4)
        dt = getattr(torch, dtype)
        H, Hkv, D, ps, P = 16, 8, 128, 16, 128
        pos = [5, 2048, 700, 1777, 256, 0, 1999, 1024]
        p = torch.tensor(pos, device=cuda, dtype=torch.int32)
        if paged:
            q, kp, vp, pt = _paged_pool(g, cuda, dt, pos, H, Hkv, D, ps, P,
                                        1200)

            def run(rows):
                return kd.decode_attention_paged(
                    q[rows].contiguous(), kp, vp, pt[rows].contiguous(),
                    p[rows].contiguous())
        else:
            q = torch.randn(8, H, D, generator=g, device=cuda).to(dt)
            kc = torch.randn(8, Hkv, P * ps, D, generator=g,
                             device=cuda).to(dt)
            vc = torch.randn(8, Hkv, P * ps, D, generator=g,
                             device=cuda).to(dt)

            def run(rows):
                return kd.decode_attention(q[rows].contiguous(), kc[rows],
                                           vc[rows], p[rows].contiguous(),
                                           kv_layout="bhsd")
        every = slice(0, 8)
        batch = run(every)
        assert torch.equal(batch, run(every))
        for b in (1, 3, 6):
            assert torch.equal(run(slice(b, b + 1)), batch[b:b + 1]), b

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_paged_and_abort(self, cuda, dtype):
        from repro_torch.kernels import decode_attention as kd
        from repro_torch.kernels import prefill_attention as kp_
        g = torch.Generator(device=cuda).manual_seed(1)
        dt = getattr(torch, dtype)
        B, Sq, H, Hkv, D, ps, P, n_pages = 5, 8, 8, 2, 64, 16, 8, 64
        q = torch.randn(B, Sq, H, D, generator=g, device=cuda).to(dt)
        kp = torch.randn(n_pages, Hkv, ps, D, generator=g,
                         device=cuda).to(dt)
        vp = torch.randn(n_pages, Hkv, ps, D, generator=g,
                         device=cuda).to(dt)
        pt = torch.randperm(n_pages, generator=g, device=cuda)[:B * P] \
            .reshape(B, P).to(torch.int32)
        pt[0, 2:] = n_pages
        pt[1, 6:] = -1
        pos = torch.tensor([3, 50, 100, 120, P * ps], device=cuda,
                           dtype=torch.int32)
        abort = torch.tensor([0, 1, 3, Sq, Sq + 5], device=cuda,
                             dtype=torch.int32)
        want = ref.ref_prefill_attention_paged(q, kp, vp, pt, pos)
        got, prog = kp_.prefill_attention_paged(q, kp, vp, pt, pos,
                                                abort=abort)
        assert prog.tolist() == [0, 1, 3, Sq, Sq]
        for b, cap in enumerate(prog.tolist()):
            torch.testing.assert_close(got[b, :cap].float(),
                                       want[b, :cap].float(),
                                       rtol=TOL[dtype], atol=TOL[dtype])
        one = kp_.prefill_attention_paged(q[:, :1], kp, vp, pt, pos)
        dec = kd.decode_attention_paged(q[:, 0].contiguous(), kp, vp, pt,
                                        pos)
        if dtype in SQ1_TOL:
            rtol, atol = SQ1_TOL[dtype]
            torch.testing.assert_close(one[:, 0], dec, rtol=rtol, atol=atol)
        else:
            d = (one[:, 0].float() - dec.float()).reshape(B, Hkv, -1)
            w = dec.float().reshape(B, Hkv, -1)
            rel = (d.norm(dim=2) / w.norm(dim=2)).max().item()
            assert rel <= SQ1_REL_TOL[dtype], rel
        wd = ref.ref_decode_attention_paged(q[:, 0], kp, vp, pt, pos)
        torch.testing.assert_close(dec.float(), wd.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])

    @pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
    @pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
    @pytest.mark.parametrize("G", [1, 2, 4, 8])
    @pytest.mark.parametrize("D", [32, 64, 128])
    def test_prefill(self, cuda, D, G, dtype, paged):
        """Chunked prefill on the route ``route(dtype, D)`` names (counted
        in ``.routes``) against the plain version, Sq 1/5/65/100/256, over
        a ragged dense window of 1000 keys or a 75-page table (1200 keys),
        and over a window shorter than one key tile (40 dense, 3 pages
        paged): rows at pos 0, crossing and at a key-tile boundary, a late
        row, one ending at the last key, and the sentinel (clamped to the
        short window); unmapped and negative page entries past each row's
        pages; the late-row check on the long window. Sq = 65 leaves one
        or two rows in a unit of their own."""
        from repro_torch.kernels import prefill_attention as kp_
        g = torch.Generator(device=cuda).manual_seed(5)
        dt = getattr(torch, dtype)
        Hkv = 2
        fn = kp_.prefill_attention_paged if paged else kp_.prefill_attention
        way = kp_.route(dt, D)
        for window in ((1200, 48) if paged else (1000, 40)):
            for Sq in (1, 5, 65, 100, 256):
                pos = [min(p, window) for p in (0, 100, 128, 700)] + \
                    [max(window - Sq, 0), window]
                q, kv = _prefill_case(g, cuda, dt, pos, Sq, G * Hkv, Hkv, D,
                                      window, paged)
                p = torch.tensor(pos, device=cuda, dtype=torch.int32)
                before = dict(fn.routes)
                got = _prefill(paged, q, kv, p)
                assert fn.routes == {**before, way: before[way] + 1}, Sq
                want = _prefill_ref(paged, q, kv, p)
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=CUDA_TOL[dtype],
                                           atol=CUDA_TOL[dtype])
                if window >= 512:
                    rel = _prefill_late_rel(got, want, pos, window, Hkv)
                    assert rel.max().item() <= LATE_REL_TOL[dtype], (Sq, rel)

    @pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
    @pytest.mark.parametrize("H,Hkv,D", [(16, 8, 128), (8, 1, 64),
                                         (4, 4, 32)])
    @pytest.mark.parametrize("ps", [8, 12, 32])
    def test_prefill_page_sizes(self, cuda, ps, H, Hkv, D, dtype):
        """Pages of 8 and 32 keys (a power of two: shift and mask) and of
        12 (division), against the plain version, at qwen3-1.7b heads, G 8
        at D 64 and G 1 at D 32, over a window of about 1270 keys (not a
        multiple of either body's key tile) with a sentinel row."""
        g = torch.Generator(device=cuda).manual_seed(7)
        dt = getattr(torch, dtype)
        Sq = 100
        window = (1270 // ps) * ps
        pos = [0, 130, 700, window - Sq, window]
        q, kv = _prefill_case(g, cuda, dt, pos, Sq, H, Hkv, D, window,
                              True, ps=ps)
        p = torch.tensor(pos, device=cuda, dtype=torch.int32)
        got = _prefill(True, q, kv, p)
        want = _prefill_ref(True, q, kv, p)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=CUDA_TOL[dtype], atol=CUDA_TOL[dtype])
        rel = _prefill_late_rel(got, want, pos, window, Hkv)
        assert rel.max().item() <= LATE_REL_TOL[dtype], rel

    @pytest.mark.parametrize("dtype,D", [("float32", 128), ("float32", 64),
                                         ("float16", 64), ("bfloat16", 32),
                                         ("bfloat16", 64),
                                         ("bfloat16", 128)])
    @pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
    def test_prefill_bits_invariant(self, cuda, paged, dtype, D):
        """Bit for bit, on both routes: two calls; the first ``abort``
        rows against the whole chunk's and against a chunk of exactly
        ``abort`` tokens (that row alone); rows [a, Sq) against a call at
        pos + a, a = 1, 37, 64; a row alone against the same row in a
        batch of 8."""
        g = torch.Generator(device=cuda).manual_seed(6)
        dt = getattr(torch, dtype)
        H, Hkv, Sq, window = 16, 8, 200, 2048
        pos = [5, window, 700, 1777, 256, 0, 1848, 1024]
        aborts = [0, 1, 37, 64, Sq, Sq + 5, 130, 3]
        q, kv = _prefill_case(g, cuda, dt, pos, Sq, H, Hkv, D, window,
                              paged)
        p = torch.tensor(pos, device=cuda, dtype=torch.int32)

        def rows(b):
            return (*kv[:2], kv[2][b:b + 1]) if paged else \
                tuple(x[b:b + 1] for x in kv)

        whole = _prefill(paged, q, kv, p)
        assert torch.equal(_prefill(paged, q, kv, p), whole)
        out_a, prog = _prefill(paged, q, kv, p, abort=torch.tensor(
            aborts, device=cuda, dtype=torch.int32))
        assert prog.tolist() == [min(a, Sq) for a in aborts]
        for b, cap in enumerate(prog.tolist()):
            if cap:
                assert torch.equal(out_a[b, :cap], whole[b, :cap]), b
                small = _prefill(paged, q[b:b + 1, :cap], rows(b),
                                 p[b:b + 1])
                assert torch.equal(small[0], whole[b, :cap]), b
        for a in (1, 37, 64):
            assert torch.equal(_prefill(paged, q[:, a:], kv, p + a),
                               whole[:, a:]), a
        for b in (1, 3, 6):
            assert torch.equal(_prefill(paged, q[b:b + 1], rows(b),
                                        p[b:b + 1]), whole[b:b + 1]), b

    def test_dense_prefill_counts_launches(self, cuda):
        from repro_torch.kernels import prefill_attention as kp_
        g = torch.Generator(device=cuda).manual_seed(2)
        B, Sq, H, Hkv, D, Smax = 3, 5, 4, 2, 128, 100
        q = torch.randn(B, Sq, H, D, generator=g, device=cuda)
        kc = torch.randn(B, Hkv, Smax, D, generator=g, device=cuda)
        vc = torch.randn(B, Hkv, Smax, D, generator=g, device=cuda)
        pos = torch.tensor([0, 60, Smax], device=cuda, dtype=torch.int32)
        ops.reset_launch_counts()
        got = ops.prefill_attention(q, kc, vc, pos)
        assert ops.launch_counts()["prefill_attention"] == 1
        want = ref.ref_prefill_attention(q, kc.transpose(1, 2),
                                         vc.transpose(1, 2), pos)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)

"""The port's co-execution and shadow-page-table kernels against the
reference: flash attention, dual-tenant attention, dual-tenant matmul and
SPT gather/scatter, with the schedule and the colored arena they rest on.

CPU: the plain PyTorch versions (what ``repro_torch.kernels.ops`` runs for
CPU tensors) against the reference's Pallas kernels in interpret mode, on
the same inputs made from a numpy seed, at the shapes and tolerances of
``tests/test_kernels.py``; the port's ``_schedule`` and ``ColoredArena``
against the reference's, exactly; and the new plain versions of
``kernels/ref.py`` against their jnp twins.

CUDA (marked ``cuda``, skipped without a card): each CUDA kernel against its
plain version on the card, and dual-tenant attention against the port's own
flash kernel bit for bit. The JAX reference is imported lazily so that this
file also runs on a machine without JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import coloring
from repro_torch.kernels import dual_tenant_matmul as dtm
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels.dual_tenant_matmul import _schedule

# flash tolerances of tests/test_kernels.py
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def jx():
    """(jax.numpy, reference ops, reference ref) — the reference side of
    every parity test."""
    jax = pytest.importorskip("jax")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    return jax.numpy, jops, jref


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(jnp, a, dtype="float32"):
    """The same values on both sides: f32 numpy rounded to ``dtype`` by
    each framework (both round to nearest even)."""
    return (jnp.asarray(a).astype(getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _qkv(jnp, rng, B, S, H, Hkv, D, dtype="float32"):
    arrs = (_rand(rng, (B, S, H, D)), _rand(rng, (B, S, Hkv, D)),
            _rand(rng, (B, S, Hkv, D)))
    pairs = [_both(jnp, a, dtype) for a in arrs]
    return [p[0] for p in pairs], [p[1] for p in pairs]


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,H,Hkv,D", [
    (1, 128, 4, 4, 64), (2, 256, 8, 2, 64), (1, 128, 4, 1, 128),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_sweep(jx, B, S, H, Hkv, D, dtype):
    jnp, jops, _ = jx
    (jq, jk, jv), (tq, tk, tv) = _qkv(jnp, np.random.default_rng(0), B, S,
                                      H, Hkv, D, dtype)
    want = jops.flash_attention(jq, jk, jv, block_q=64, block_k=64)
    got = ops.flash_attention(tq, tk, tv, block_q=64, block_k=64)
    assert got.dtype == getattr(torch, dtype) and got.shape == tq.shape
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("window,softcap", [(64, None), (None, 30.0),
                                            (32, 50.0)])
def test_flash_attention_window_softcap(jx, window, softcap):
    jnp, jops, _ = jx
    (jq, jk, jv), (tq, tk, tv) = _qkv(jnp, np.random.default_rng(1), 1, 128,
                                      2, 2, 64)
    want = jops.flash_attention(jq, jk, jv, window=window, softcap=softcap,
                                block_q=32, block_k=32)
    got = ops.flash_attention(tq, tk, tv, window=window, softcap=softcap,
                              block_q=32, block_k=32)
    _close(got, want, 2e-5)


def test_flash_attention_noncausal(jx):
    jnp, jops, _ = jx
    (jq, jk, jv), (tq, tk, tv) = _qkv(jnp, np.random.default_rng(2), 1, 64,
                                      2, 2, 64)
    want = jops.flash_attention(jq, jk, jv, causal=False, block_q=32,
                                block_k=32)
    got = ops.flash_attention(tq, tk, tv, causal=False, block_q=32,
                              block_k=32)
    _close(got, want, 2e-5)


# ---------------------------------------------------------------------------
# dual-tenant attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B_ls,B_be,S,H,Hkv,D,sm_be", [
    (2, 3, 256, 4, 4, 64, 0.3), (1, 2, 128, 4, 2, 64, 0.5),
])
def test_dual_tenant_attention(jx, B_ls, B_be, S, H, Hkv, D, sm_be):
    """Each tenant matches the reference's fused kernel at 2e-5, and equals
    the port's own flash attention on that tenant exactly."""
    jnp, jops, _ = jx
    rng = np.random.default_rng(21)
    j1, t1 = _qkv(jnp, rng, B_ls, S, H, Hkv, D)
    j2, t2 = _qkv(jnp, rng, B_be, S, H, Hkv, D)
    w1, w2 = jops.dual_tenant_attention(*j1, *j2, sm_be=sm_be, block_q=64,
                                        block_k=64)
    o1, o2 = ops.dual_tenant_attention(*t1, *t2, sm_be=sm_be, block_q=64,
                                       block_k=64)
    _close(o1, w1, 2e-5)
    _close(o2, w2, 2e-5)
    assert torch.equal(o1, ops.flash_attention(*t1, causal=True))
    assert torch.equal(o2, ops.flash_attention(*t2, causal=True))


# ---------------------------------------------------------------------------
# dual-tenant matmul and its schedule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m_ls,m_be,K,N,sm_be", [
    (128, 256, 128, 128, 0.3), (256, 128, 256, 256, 0.5),
])
def test_dual_tenant_matmul(jx, m_ls, m_be, K, N, sm_be):
    jnp, jops, _ = jx
    rng = np.random.default_rng(4)
    arrs = [_rand(rng, s) for s in ((m_ls, K), (K, N), (m_be, K), (K, N))]
    want = jops.dual_tenant_matmul(*(jnp.asarray(a) for a in arrs),
                                   sm_be=sm_be, block_m=64, block_n=64,
                                   block_k=64)
    got = ops.dual_tenant_matmul(*(torch.from_numpy(a) for a in arrs),
                                 sm_be=sm_be, block_m=64, block_n=64,
                                 block_k=64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-4)


def test_schedule_equals_reference(jx):
    """The port's copy of ``_schedule`` gives the reference's order, list
    for list, over a grid of tile counts, quotas and round sizes."""
    from repro.kernels.dual_tenant_matmul import _schedule as jschedule
    for n_ls in (0, 1, 5, 16, 40):
        for n_be in (0, 1, 6, 64):
            for sm_be in (0.0, 0.05, 0.25, 0.3, 0.5, 0.9, 1.0):
                for rt in (1, 2, 8, 13):
                    assert _schedule(n_ls, n_be, sm_be, round_tiles=rt) \
                        == jschedule(n_ls, n_be, sm_be, round_tiles=rt)


def test_schedule_quota():
    """While both tenants hold tiles, BE takes at most floor(sm_be * round)
    tiles of every round of 8."""
    order = _schedule(n_ls=16, n_be=64, sm_be=0.25, round_tiles=8)
    owners = [o for o, _ in order]
    assert owners.count(0) == 16 and owners.count(1) == 64
    upto = max(i for i, o in enumerate(owners) if o == 0)
    for s in range(0, upto - 8, 8):
        assert owners[s:s + 8].count(1) <= 2, (s, owners[s:s + 8])


def test_schedule_no_starvation():
    """A quota below one tile a round accrues credit: BE starts before LS
    drains, every tile appears once, in order, and the quota holds."""
    order = _schedule(n_ls=40, n_be=6, sm_be=0.05, round_tiles=8)
    owners = [o for o, _ in order]
    assert owners.count(0) == 40 and owners.count(1) == 6
    assert owners.index(1) < 40
    assert [r for o, r in order if o == 0] == list(range(40))
    assert [r for o, r in order if o == 1] == list(range(6))
    upto = max(i for i, o in enumerate(owners) if o == 0)
    for s in range(0, upto - 8, 8):
        assert owners[s:s + 8].count(1) <= 1, (s, owners[s:s + 8])


# ---------------------------------------------------------------------------
# shadow page tables: the colored arena and gather/scatter
# ---------------------------------------------------------------------------

def _arena_history(col, gpu, mb=4):
    """SPTs from one allocation sequence: alloc, release, realloc into the
    freed pages, then an online resplit of the channels."""
    hm = col.gpu_hash_model(gpu)
    arena = col.ColoredArena(mb << 20, hm.channel_of, hm.num_channels,
                             hm.granularity)
    ls, be = col.split_channels(hm.num_channels, 1 / 3)
    spts = [arena.alloc("ls_w", 512 * 1024, ls).spt.copy(),
            arena.alloc("be_w", 256 * 1024, be).spt.copy(),
            arena.alloc("ls_kv", 300 * 1024, ls).spt.copy()]
    arena.release("ls_w")
    spts.append(arena.alloc("ls_w2", 700 * 1024, ls).spt.copy())
    ls2, be2 = col.split_channels(hm.num_channels, 0.5)
    arena.resplit({"be_w": be2, "ls_kv": ls2})
    spts += [arena.allocations[n].spt.copy() for n in ("be_w", "ls_kv")]
    return arena.page_channel, spts, arena.last_resplit, (ls, be)


@pytest.mark.parametrize("gpu", ["tesla-p40", "rtx-a2000", "tesla-v100"])
def test_colored_arena_spts_equal_reference(jx, gpu):
    from repro.core import coloring as jcol
    chan, spts, resplit, split = _arena_history(coloring, gpu)
    jchan, jspts, jresplit, jsplit = _arena_history(jcol, gpu)
    np.testing.assert_array_equal(chan, jchan)
    assert len(spts) == len(jspts)
    for a, b in zip(spts, jspts):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    assert resplit == jresplit and split == jsplit


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spt_gather_scatter(jx, seed):
    """Gather and scatter through a random SPT are bit-exact against the
    reference's kernels; scatter-then-gather restores the logical pages."""
    jnp, jops, jref = jx
    rng = np.random.default_rng(seed)
    n_pages = int(rng.integers(1, 33))
    n_arena = n_pages + int(rng.integers(0, 16))
    arena = rng.normal(size=(n_arena, 256)).astype(np.float32)
    spt = rng.choice(n_arena, n_pages, replace=False).astype(np.int32)
    got = ops.spt_gather(torch.from_numpy(arena), torch.from_numpy(spt))
    want = jops.spt_gather(jnp.asarray(arena), jnp.asarray(spt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = ops.spt_scatter(got, torch.from_numpy(spt), n_arena)
    # the reference's kernel writes only the referenced pages (the rest is
    # uninitialized: NaN in interpret mode), its oracle zeroes the rest;
    # the port zeroes them, as its docstring says
    wback = jops.spt_scatter(want, jnp.asarray(spt), n_arena)
    np.testing.assert_array_equal(back.numpy()[spt], np.asarray(wback)[spt])
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jref.ref_spt_scatter(
            jnp.asarray(arena[spt]), jnp.asarray(spt), n_arena)))
    np.testing.assert_array_equal(back.numpy()[spt], arena[spt])


def test_spt_roundtrip_through_colored_arena(jx):
    """A tenant's bf16 tensor through the SPT the port's arena hands out:
    scatter into the arena and gather back is the identity, and equals the
    reference on the reference's SPT."""
    jnp, jops, _ = jx
    from repro.core import coloring as jcol
    hm = coloring.gpu_hash_model("tesla-p40")
    ls, _ = coloring.split_channels(hm.num_channels, 1 / 3)
    arena = coloring.ColoredArena(1 << 20, hm.channel_of, hm.num_channels,
                                  hm.granularity)
    jarena = jcol.ColoredArena(1 << 20, hm.channel_of, hm.num_channels,
                               hm.granularity)
    spt = arena.alloc("ls", 96 * 1024, ls).spt
    np.testing.assert_array_equal(spt, jarena.alloc("ls", 96 * 1024, ls).spt)
    page_elems = hm.granularity // 2          # bf16: 512 elements a page
    x = _rand(np.random.default_rng(5), (len(spt), page_elems))
    jx_, tx = _both(jnp, x, "bfloat16")
    n_arena = arena.total_bytes // arena.granularity
    dev = ops.spt_scatter(tx, torch.from_numpy(spt), n_arena)
    jdev = jops.spt_scatter(jx_, jnp.asarray(spt), n_arena)
    np.testing.assert_array_equal(dev.float().numpy()[spt],
                                  np.asarray(jdev.astype(jnp.float32))[spt])
    rest = np.setdiff1d(np.arange(n_arena), spt)
    assert not dev[torch.from_numpy(rest)].any()
    assert torch.equal(ops.spt_gather(dev, torch.from_numpy(spt)), tx)


# ---------------------------------------------------------------------------
# the new plain versions against their jnp twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (False, None, None), (True, 16, 20.0),
    (False, 24, None),
])
def test_ref_attention_matches_jnp(jx, monkeypatch, causal, window, softcap):
    """In one pass, and in query blocks of 3 rows (a scores budget of
    3 * B * H * S), at 2e-5."""
    jnp, _, jref = jx
    B, S, H = 2, 64, 4
    (jq, jk, jv), (tq, tk, tv) = _qkv(jnp, np.random.default_rng(31), B, S,
                                      H, 2, 32)
    want = jref.ref_attention(jq, jk, jv, causal=causal, window=window,
                              softcap=softcap)
    got = ref.ref_attention(tq, tk, tv, causal=causal, window=window,
                            softcap=softcap)
    _close(got, want, 2e-5)
    monkeypatch.setattr(ref, "SCORES_BUDGET", 3 * B * H * S)
    blocked = ref.ref_attention(tq, tk, tv, causal=causal, window=window,
                                softcap=softcap)
    _close(blocked, want, 2e-5)


def test_ref_spt_and_matmul_match_jnp(jx):
    jnp, _, jref = jx
    rng = np.random.default_rng(32)
    arena = _rand(rng, (20, 48))
    spt = rng.choice(20, 9, replace=False).astype(np.int32)
    np.testing.assert_array_equal(
        ref.ref_spt_gather(torch.from_numpy(arena),
                           torch.from_numpy(spt)).numpy(),
        np.asarray(jref.ref_spt_gather(jnp.asarray(arena), jnp.asarray(spt))))
    x = _rand(rng, (9, 48))
    np.testing.assert_array_equal(
        ref.ref_spt_scatter(torch.from_numpy(x), torch.from_numpy(spt),
                            20).numpy(),
        np.asarray(jref.ref_spt_scatter(jnp.asarray(x), jnp.asarray(spt),
                                        20)))
    arrs = [_rand(rng, s) for s in ((32, 64), (64, 48), (16, 64), (64, 48))]
    for dtype, tol in (("float32", 1e-5), ("bfloat16", 2 ** -7)):
        pairs = [_both(jnp, a, dtype) for a in arrs]
        got = ref.ref_dual_tenant_matmul(*(p[1] for p in pairs))
        want = jref.ref_dual_tenant_matmul(*(p[0] for p in pairs))
        for g, w in zip(got, want):
            assert g.dtype == getattr(torch, dtype)
            np.testing.assert_allclose(_np(g), _np(w), rtol=tol, atol=1e-4)


@pytest.mark.parametrize("B,T,H,K,P", [(1, 64, 2, 16, 32), (2, 32, 4, 8, 8)])
def test_ref_ssd_scan_matches_jnp(jx, B, T, H, K, P):
    jnp, _, jref = jx
    rng = np.random.default_rng(33)
    q, k = _rand(rng, (B, T, H, K)), _rand(rng, (B, T, H, K))
    v = _rand(rng, (B, T, H, P))
    log_w = -np.abs(_rand(rng, (B, T, H, K))) * 0.2
    args = (q, k, v, log_w)
    want = jref.ref_ssd_scan(*(jnp.asarray(a) for a in args))
    got = ref.ref_ssd_scan(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_cpu_path_counts_no_launch():
    """The CPU path is the plain version: no kernel launch is counted."""
    ops.reset_launch_counts()
    q = torch.zeros(1, 8, 2, 64)
    ops.flash_attention(q, q, q)
    ops.dual_tenant_attention(q, q, q, q, q, q)
    a = torch.zeros(4, 4)
    ops.dual_tenant_matmul(a, a, a, a)
    ops.spt_scatter(ops.spt_gather(a, torch.tensor([1, 0])),
                    torch.tensor([1, 0]), 4)
    assert sum(ops.launch_counts().values()) == 0


@pytest.mark.parametrize("dtype,D,want", [
    ("bfloat16", 64, "wgmma"), ("bfloat16", 128, "wgmma"),
    ("bfloat16", 256, "wgmma"), ("float32", 128, "simt"),
    ("float16", 64, "simt"), ("bfloat16", 32, None)])
def test_flash_route(dtype, D, want):
    """bf16 takes the tensor-core body at every head dim the kernels take;
    f32 and f16 keep the CUDA-core body; any other head dim is refused
    before a route is picked (``want`` None)."""
    dt = getattr(torch, dtype)
    q, kv = torch.zeros(1, 4, 2, D, dtype=dt), torch.zeros(1, 4, 1, D,
                                                            dtype=dt)
    if want is None:
        with pytest.raises(ValueError, match="head dim"):
            fa.check_heads("flash_attention", q, kv, kv)
    else:
        fa.check_heads("flash_attention", q, kv, kv)
        assert fa.route(dt) == want


@pytest.mark.parametrize("dtype,K,N,want", [
    ("bfloat16", 2048, 6144, "wgmma"), ("bfloat16", 72, 200, "wgmma"),
    ("bfloat16", 128, 128, "wgmma"), ("bfloat16", 70, 200, "simt"),
    ("bfloat16", 72, 201, "simt"), ("bfloat16", 0, 64, "simt"),
    ("float32", 2048, 6144, "simt"), ("float16", 64, 64, "simt")])
def test_matmul_route(dtype, K, N, want):
    """The tensor-core matmul needs bf16 and 16-byte row strides (K and N
    multiples of 8); every other shape and type takes the CUDA-core body."""
    assert dtm.route(getattr(torch, dtype), K, N) == want


@pytest.mark.parametrize("itemsize,K,N,addresses,want", [
    (4, 2048, 6144, (0, 256, 4096), 16), (4, 70, 200, (0, 256), 4),
    (4, 72, 200, (0, 8), 4), (4, 72, 202, (0,), 4),
    (2, 72, 200, (0, 256), 16), (2, 70, 200, (0,), 4),
    (2, 71, 200, (0,), 2), (2, 72, 201, (0,), 2), (2, 72, 200, (6,), 2),
    (2, 64, 8, (4, 512), 4)])
def test_matmul_copy_width(itemsize, K, N, addresses, want):
    """The CUDA-core body copies 16 bytes at a time only where every row
    stride and base is a multiple of 16, else 4 bytes, else (2-byte types
    with an odd K, N or base) one element."""
    assert dtm.copy_width(itemsize, K, N, *addresses) == want


def test_reset_clears_route_counts():
    fa.flash_attention.routes["wgmma"] = 3
    ops.reset_launch_counts()
    assert all(n == 0 for r in ops.route_counts().values()
               for n in r.values())
    assert set(ops.route_counts()) == {"flash_attention",
                                       "dual_tenant_attention",
                                       "dual_tenant_matmul",
                                       "prefill_attention",
                                       "prefill_attention_paged"}


# ---------------------------------------------------------------------------
# on the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cuda_qkv(cuda, seed, B, S, H, Hkv, D, dtype):
    g = torch.Generator(device=cuda).manual_seed(seed)
    dt = getattr(torch, dtype)
    return [torch.randn(B, S, h, D, generator=g, device=cuda).to(dt)
            for h in (H, Hkv, Hkv)]


# attention on the card, elementwise (rtol = atol): f32 the reference's;
# bf16 as chip_smoke.py holds it; f16: inputs rounded the same on both sides,
# so kernel and plain version differ by f32 summation order and one output
# rounding (2^-11 of the value) each, as chip_smoke.py's F16_TOL
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2, "float16": 2e-3}
# Beside the elementwise tolerance, which at long S is about the size of a
# late row's output: each (batch row, head)'s relative L2 error over the
# rows [S/2, S), as chip_smoke.py's phase 7 holds it (f16: a few output
# roundings of 2^-11, against a dropped or repeated key tile's ~0.1)
LATE_REL_TOL = {"float32": 1e-4, "bfloat16": 2e-2, "float16": 2e-3}
# a long ragged S: past a key-tile ring's depth, a multiple of no tile
LONG_S = 999
# dual-tenant matmul rtol (atol 1e-4): f32 the reference's; bf16 and f16
# one output rounding apart (2^-7, 2^-10 relative), as chip_smoke.py holds it
MATMUL_RTOL = {"float32": 1e-5, "bfloat16": 2 ** -7, "float16": 2 ** -10}


def _assert_late_rows(got, want, dtype):
    h = want.shape[1] // 2
    d, w = got[:, h:].float() - want[:, h:].float(), want[:, h:].float()
    rel = (d.square().sum((1, 3)).sqrt() / w.square().sum((1, 3)).sqrt())
    assert rel.max().item() <= LATE_REL_TOL[dtype], rel.max().item()


def _check_flash(q, k, v, dtype, causal, window, softcap):
    """One flash_attention launch on its route, within ATTN_TOL and
    LATE_REL_TOL of the plain version."""
    way = "wgmma" if dtype == "bfloat16" else "simt"
    before = fa.flash_attention.routes[way]
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap)
    assert fa.flash_attention.routes[way] == before + 1
    want = ref.ref_attention(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    _assert_late_rows(got, want, dtype)


def _check_dual_is_flash(cuda, dtype, D, B_ls, B_be, S):
    """Each tenant of dual_tenant_attention equals flash_attention bit for
    bit for sm_be 0.1/0.5/0.9, on the route of its dtype."""
    t1 = _cuda_qkv(cuda, 1, B_ls, S, 4, 2, D, dtype)
    t2 = _cuda_qkv(cuda, 2, B_be, S, 4, 2, D, dtype)
    w1 = ops.flash_attention(*t1, causal=True)
    w2 = ops.flash_attention(*t2, causal=True)
    way = "wgmma" if dtype == "bfloat16" else "simt"
    routes = ops.route_counts()
    for sm_be in (0.1, 0.5, 0.9):
        o1, o2 = ops.dual_tenant_attention(*t1, *t2, sm_be=sm_be)
        assert torch.equal(o1, w1) and torch.equal(o2, w2), sm_be
    assert ops.route_counts()["dual_tenant_attention"][way] == \
        routes["dual_tenant_attention"][way] + 3
    want = ref.ref_attention(*t2, causal=True)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(w2.float(), want.float(), rtol=tol, atol=tol)
    _assert_late_rows(w2, want, dtype)


@pytest.mark.cuda
class TestCudaKernels:
    """Each kernel on the card vs ``kernels.ref`` on the same tensors
    (``pytest -m cuda tests/test_torch_sgdrc_kernels.py``)."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
    @pytest.mark.parametrize("D", [64, 128, 256])
    @pytest.mark.parametrize("causal,window,softcap", [
        (True, None, None), (False, None, None), (True, 40, 30.0),
        (False, 70, None)])
    def test_flash(self, cuda, dtype, D, causal, window, softcap):
        # S = 200 is a multiple of no tile: the ragged edge is masked
        q, k, v = _cuda_qkv(cuda, D, 2, 200, 4, 2, D, dtype)
        _check_flash(q, k, v, dtype, causal, window, softcap)

    @pytest.mark.parametrize("D", [128, 256])
    @pytest.mark.parametrize("causal,window,softcap", [
        (True, None, None), (True, 300, 50.0), (False, None, None)])
    def test_flash_long(self, cuda, D, causal, window, softcap):
        """f32 at LONG_S: many key tiles through the load buffers, the
        last one ragged; the window and softcap path at both head dims."""
        q, k, v = _cuda_qkv(cuda, D + 1, 2, LONG_S, 4, 2, D, "float32")
        _check_flash(q, k, v, "float32", causal, window, softcap)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
    @pytest.mark.parametrize("D", [64, 128, 256])
    def test_dual_attention_is_flash(self, cuda, dtype, D):
        """Bit-identical to the flash kernel per tenant, for any sm_be."""
        _check_dual_is_flash(cuda, dtype, D, 1, 3, 192)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
    @pytest.mark.parametrize("D", [128, 256])
    def test_dual_attention_is_flash_long(self, cuda, dtype, D):
        """The same at LONG_S, with a BE batch of another size."""
        _check_dual_is_flash(cuda, dtype, D, 2, 3, LONG_S)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
    @pytest.mark.parametrize("m_ls,m_be,K,N", [(128, 256, 128, 128),
                                               (100, 300, 72, 200),
                                               (100, 300, 70, 200),
                                               (100, 300, 71, 200),
                                               (300, 200, 1024, 200),
                                               (0, 130, 64, 8),
                                               (130, 0, 1024, 96)])
    def test_dual_matmul(self, cuda, dtype, m_ls, m_be, K, N):
        """Aligned ragged bf16 (K 72, N 200) on the tensor cores, K 70 and
        71 on the CUDA cores (4-byte copies, and one-element copies of f16
        and bf16 at K 71); K 1024 cycles the CUDA-core body's ring many
        times, N 200 ends inside an n-block; an empty tenant on either."""
        g = torch.Generator(device=cuda).manual_seed(3)
        dt = getattr(torch, dtype)
        a_ls, a_be = (torch.randn(m, K, generator=g, device=cuda).to(dt)
                      for m in (m_ls, m_be))
        b_ls, b_be = (torch.randn(K, N, generator=g, device=cuda).to(dt)
                      for _ in range(2))
        way = dtm.route(dt, K, N)
        assert way == ("wgmma" if dtype == "bfloat16" and K % 8 == 0
                       else "simt")
        before = dtm.dual_tenant_matmul.routes[way]
        got = ops.dual_tenant_matmul(a_ls, b_ls, a_be, b_be, sm_be=0.3)
        assert dtm.dual_tenant_matmul.routes[way] == before + 1
        want = ref.ref_dual_tenant_matmul(a_ls, b_ls, a_be, b_be)
        for o, w in zip(got, want):
            torch.testing.assert_close(o.float(), w.float(),
                                       rtol=MATMUL_RTOL[dtype], atol=1e-4)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
    @pytest.mark.parametrize("K,N", [(256, 200), (71, 200)])
    def test_dual_matmul_tenants_independent(self, cuda, dtype, K, N):
        """Each tenant's output is the same bit for bit under sm_be 0.1,
        0.3 and 0.9 and when the other tenant has no rows: every output is
        one sum over k in order, whatever else the launch runs."""
        g = torch.Generator(device=cuda).manual_seed(6)
        dt = getattr(torch, dtype)
        a_ls, a_be = (torch.randn(m, K, generator=g, device=cuda).to(dt)
                      for m in (300, 500))
        b_ls, b_be = (torch.randn(K, N, generator=g, device=cuda).to(dt)
                      for _ in range(2))
        o_ls, o_be = ops.dual_tenant_matmul(a_ls, b_ls, a_be, b_be,
                                            sm_be=0.3)
        for sm_be in (0.1, 0.9):
            l, b = ops.dual_tenant_matmul(a_ls, b_ls, a_be, b_be, sm_be=sm_be)
            assert torch.equal(l, o_ls) and torch.equal(b, o_be), sm_be
        assert torch.equal(
            ops.dual_tenant_matmul(a_ls, b_ls, a_be[:0], b_be)[0], o_ls)
        assert torch.equal(
            ops.dual_tenant_matmul(a_ls[:0], b_ls, a_be, b_be)[1], o_be)

    @pytest.mark.parametrize("dtype,width", [("bfloat16", 512),
                                             ("float32", 100),
                                             ("bfloat16", 7)])
    def test_spt(self, cuda, dtype, width):
        """Bit-exact, for pages of 1024, 400 and 14 bytes (16-byte and
        1-byte copies)."""
        g = torch.Generator(device=cuda).manual_seed(4)
        n_arena, n = 300, 120
        arena = torch.randn(n_arena, width, generator=g,
                            device=cuda).to(getattr(torch, dtype))
        spt = torch.randperm(n_arena, generator=g, device=cuda)[:n] \
            .to(torch.int32)
        got = ops.spt_gather(arena, spt)
        assert torch.equal(got, arena.index_select(0, spt.long()))
        back = ops.spt_scatter(got, spt, n_arena)
        want = torch.zeros_like(arena).index_copy_(0, spt.long(), got)
        assert torch.equal(back, want)
        assert torch.equal(ops.spt_gather(back, spt), got)

    def test_launch_counts(self, cuda):
        q, k, v = _cuda_qkv(cuda, 5, 1, 64, 2, 1, 64, "float32")
        a = torch.ones(128, 64, device=cuda)
        ops.reset_launch_counts()
        ops.flash_attention(q, k, v)
        ops.dual_tenant_attention(q, k, v, q, k, v)
        ops.dual_tenant_matmul(a, a.T, a, a.T)
        ops.spt_scatter(ops.spt_gather(a, torch.tensor([1, 0])),
                        torch.tensor([1, 0]), 128)
        counts = ops.launch_counts()
        for name in ("flash_attention", "dual_tenant_attention",
                     "dual_tenant_matmul", "spt_gather", "spt_scatter"):
            assert counts[name] == 1, counts
        torch.cuda.synchronize()

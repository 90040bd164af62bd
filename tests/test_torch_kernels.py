"""The port's attention kernels against the reference's Pallas kernels.

CPU: the plain PyTorch versions (what ``repro_torch.kernels.ops`` runs for
CPU tensors) against the JAX kernels in interpret mode, on the same inputs
made from a numpy seed, at the shapes of ``tests/test_kernels.py``: dense and
paged decode and chunked prefill, ragged positions, non-dividing windows,
the abort/progress protocol and Sq == 1 prefill == decode. Tolerances are the
reference's: 2e-5 in f32, 3e-2 in bf16.

CUDA (marked ``cuda``, skipped without a card): each CUDA kernel against its
plain version on the card. The JAX reference is imported lazily so that this
file also runs on a machine without JAX.
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

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("H,Hkv,D", [(8, 2, 64), (4, 4, 128),
                                         (8, 4, 32)])
    def test_decode(self, cuda, dtype, H, Hkv, D):
        from repro_torch.kernels import decode_attention as kd
        g = torch.Generator(device=cuda).manual_seed(0)
        dt = getattr(torch, dtype)
        B, Smax = 4, 200
        q = torch.randn(B, H, D, generator=g, device=cuda).to(dt)
        kc = torch.randn(B, Hkv, Smax, D, generator=g, device=cuda).to(dt)
        vc = torch.randn(B, Hkv, Smax, D, generator=g, device=cuda).to(dt)
        pos = torch.tensor([0, 31, 199, Smax], device=cuda)
        got = kd.decode_attention(q, kc, vc, pos, kv_layout="bhsd")
        want = ref.ref_decode_attention(q, kc.transpose(1, 2),
                                        vc.transpose(1, 2), pos)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])

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
        torch.testing.assert_close(one[:, 0], dec, rtol=2e-6, atol=2e-6)
        wd = ref.ref_decode_attention_paged(q[:, 0], kp, vp, pt, pos)
        torch.testing.assert_close(dec.float(), wd.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])

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

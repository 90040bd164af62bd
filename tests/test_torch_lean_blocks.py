"""What the port's training and long-sequence steps keep, at smoke sizes on
the CPU:

- ``models/transformer.py::_BlockedNll`` (``loss_fn``'s NLL where the
  vocabulary is whole on the rank: one device, or whisper's 51865, which
  "model" does not divide) against ``_nll_terms_plain``, today's
  whole-tensor form, in f32 and bf16, with ``NLL_BLOCK_BYTES`` and
  ``NLL_MIN_ROWS`` cut so that the blocks do not divide the rows: the
  loss and the logits' gradient are bit-equal on this CPU (its blocks,
  ``_nll_blocks``, bounded and balanced at full-width shapes), and autograd keeps the logits in
  their own dtype with the f32 ``lse`` a row, no f32 [rows, V] copy;
- ``models/attention.py::_SoftmaxPV`` (grouped attention's softmax·V where
  autograd records) against ``_softmax_pv_plain`` (the graph autograd
  records op by op), with no mask, a 2-D and a 3-D mask (one query row
  masked whole, a uniform softmax), with and without a logit softcap, in
  f32 and bf16: outputs and the gradients of q, k and v bit-equal, and
  the saved bytes (``torch.autograd.graph.saved_tensors_hooks``) one f32
  weights tensor plus ``v`` in its own dtype, where the plain graph also
  keeps f32 copies of the weights' rounding and of ``v``;
- the lean blocks where autograd records nothing: ``grouped_attention``
  and ``blocked_attention`` (a ragged last block, causal, a local window,
  a softcap, a negative ``q_offset``) under ``torch.no_grad`` bit-equal to
  the recorded path on the same inputs, and the blocked loop's peak of
  live bytes, read by the dry run's recorder (``traced_metrics`` on meta
  tensors), within its f32 copies of the inputs, the output's f32 blocks
  and their concatenation, the masks and two blocks of scores; the
  recorded path's peak is above that bound.

The sharded counterpart (whisper with a 513-token vocabulary on 4 gloo
ranks, each rank's rows through the blocked NLL) is in
``tests/_torch_dist_steps.py``.
"""
import pytest
import torch

from repro_torch.launch.hlo_metrics import traced_metrics
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.common import softcap

DTYPES = [torch.float32, torch.bfloat16]
V = 97


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: at these sizes torch splits an elementwise op
    such as ``exp`` over its threads, and in a process that had run the
    dry-run tests first, the f32 NLL's two losses here were seen to
    differ now and then with all of the host's threads (the plain form's
    first ``logsumexp`` once gave 17 of 33 rows apart by up to 5e-5 from
    a second call on the same input), and not with one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# (rows, vocab): whisper-small train_4k's rows on a rank of 16x16,
# qwen3-1.7b's step at S 4096 on one card, gemma2's vocabulary, a ragged
# count, fewer rows than the floor
@pytest.mark.parametrize("rows,vocab", [(65536, 51865), (4096, 151936),
                                        (4096, 256000), (5000, 151936),
                                        (700, 151936)])
def test_nll_blocks_bounded_and_balanced(rows, vocab):
    """The blocks cover the rows in order, their sizes within one row of
    each other; each holds at least NLL_MIN_ROWS rows (or all of them),
    and where the floor does not set their number, a block's f32 logits
    stay within NLL_BLOCK_BYTES (to the row)."""
    blocks = tf._nll_blocks(rows, vocab)
    assert blocks[0][0] == 0 and blocks[-1][1] == rows
    assert all(b == c for (_, b), (c, _) in zip(blocks, blocks[1:]))
    sizes = [b - a for a, b in blocks]
    assert max(sizes) - min(sizes) <= 1
    assert min(sizes) >= min(rows, tf.NLL_MIN_ROWS)
    if len(blocks) < rows // tf.NLL_MIN_ROWS:       # the floor not binding
        assert (max(sizes) - 1) * vocab * 4 <= tf.NLL_BLOCK_BYTES
    if rows * vocab * 4 > tf.NLL_BLOCK_BYTES and rows >= 2 * tf.NLL_MIN_ROWS:
        assert len(blocks) > 1


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_blocked_nll_bit_equal_to_plain(monkeypatch, dtype):
    """33 rows in nine blocks of 3 or 4 (the floor and the byte bound cut
    small): the mean NLL and the logits' gradient equal the plain
    version's bit for bit (each row's logsumexp reduces the same values in
    the same order; the backward is autograd's ``g * exp(l - lse)`` plus
    ``-g`` at the label, rounded once to the logits' dtype)."""
    monkeypatch.setattr(tf, "NLL_BLOCK_BYTES", 4 * V * 4)
    monkeypatch.setattr(tf, "NLL_MIN_ROWS", 1)
    assert sorted({b - a for a, b in tf._nll_blocks(33, V)}) == [3, 4]
    logits = (torch.randn(3, 11, V, generator=_gen(0)) * 4).to(dtype)
    labels = torch.randint(0, V, (3, 11), generator=_gen(1))
    res = []
    for fn in (tf._nll_terms_plain, tf._nll_terms):
        lg = logits.clone().requires_grad_(True)
        loss = torch.mean(fn(lg, labels))
        grad, = torch.autograd.grad(loss, lg)
        res.append((loss, grad))
    (want, gwant), (got, ggot) = res
    assert got.dtype == torch.float32 and ggot.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(ggot, gwant)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_blocked_nll_keeps_logits_in_their_dtype(dtype):
    """What autograd keeps of the blocked NLL: the logits as given, the
    f32 ``lse`` a row and the labels; from bf16 logits the plain version
    keeps an f32 [rows, V] copy (logsumexp's input)."""
    logits = torch.randn(2, 9, V, generator=_gen(2)).to(dtype) \
        .requires_grad_(True)
    labels = torch.randint(0, V, (2, 9), generator=_gen(3))
    rows = 2 * 9

    def saved(fn):
        got = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: got.append(t) or t, lambda t: t):
            fn(logits, labels)
        return got

    kept = saved(tf._nll_terms)
    assert sorted(((t.dtype, tuple(t.shape)) for t in kept
                   if t.is_floating_point()), key=str) == sorted(
        [(dtype, (2, 9, V)), (torch.float32, (rows,))], key=str)
    assert sum(t.numel() * t.element_size() for t in kept) == \
        rows * V * logits.element_size() + rows * 4 + rows * 8
    if dtype == torch.bfloat16:
        assert any(t.dtype == torch.float32 and t.shape[-1] == V
                   for t in saved(tf._nll_terms_plain))


def _scores(q, k, cap):
    """grouped_attention's f32 scores ([B,Hkv,G,Sq,Sk]), as it computes
    them where autograd records."""
    B, Sq, H, Dh = q.shape
    qg = q.reshape(B, Sq, k.shape[2], H // k.shape[2], Dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                     k.float()) * (Dh ** -0.5)
    return softcap(s, cap) if cap is not None else s


def _grouped_plain(q, k, v, mask, cap):
    """grouped_attention as autograd recorded it before the helper:
    today's graph op by op (``_softmax_pv_plain``)."""
    B, Sq, H, _ = q.shape
    if mask is not None:
        mask = mask[None, None, None] if mask.dim() == 2 else \
            mask[:, None, None]
    out = attn._softmax_pv_plain(_scores(q, k, cap), v, mask)
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def _qkv(dtype, B=2, S=37, H=4, Hkv=2, D=16, seed=4):
    g = _gen(seed)
    return [torch.randn(B, S, h, D, generator=g).to(dtype)
            for h in (H, Hkv, Hkv)]


def _mask(kind, B, S):
    if kind == "none":
        return None
    if kind == "2d":
        return torch.ones(S, S, dtype=torch.bool).tril()
    m = torch.rand(B, S, S, generator=_gen(5)) > 0.3
    m[:, 3] = False                   # a row masked whole
    return m


# (B, S, H, Hkv, D): GQA 2:1 at a small width; whisper's encoder heads
# (G = 1) at its head dim
SHAPES = {"gqa": (2, 37, 4, 2, 16), "mha": (1, 130, 3, 3, 64)}


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("cap", [None, 30.0], ids=["nocap", "cap"])
@pytest.mark.parametrize("mask", ["none", "2d", "3d"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_softmax_pv_bit_equal_to_plain_graph(dtype, cap, mask, shape):
    """grouped_attention (``_SoftmaxPV`` where autograd records, the lean
    block where it does not) against today's graph: the output and the
    gradients of q, k and v bit-equal, and the no-grad output too."""
    B, S, H, Hkv, D = SHAPES[shape]
    q, k, v = _qkv(dtype, B, S, H, Hkv, D)
    m = _mask(mask, q.shape[0], q.shape[1])
    g = torch.randn(q.shape, generator=_gen(6)).to(dtype)
    res = []
    for fn in (_grouped_plain, attn.grouped_attention):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, m, cap)
        res.append((out, torch.autograd.grad(out, leaves, g)))
    (want, gwant), (got, ggot) = res
    assert torch.equal(got, want)
    for a, b in zip(ggot, gwant):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert torch.equal(attn.grouped_attention(q, k, v, m, cap), want)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("mask", ["none", "2d", "3d"])
def test_softmax_pv_saves_weights_once(dtype, mask):
    """The bytes ``_SoftmaxPV`` saves for the backward pass: the f32
    weights once and ``v`` in its own dtype (the mask is held as given,
    not saved). The plain graph saves more in bf16 (the f32 copies of the
    weights' rounding and of ``v``)."""
    q, k, v = _qkv(dtype, seed=7)
    m = _mask(mask, q.shape[0], q.shape[1])
    m5 = None if m is None else (m[None, None, None] if m.dim() == 2
                                 else m[:, None, None])
    s = _scores(q, k, None).requires_grad_(True)
    v = v.requires_grad_(True)

    def saved(fn):
        got = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: got.append(t) or t, lambda t: t):
            fn(s, v)
        return sum(t.numel() * t.element_size() for t in got
                   if t.dtype != torch.bool)

    helper = saved(lambda s, v: attn._SoftmaxPV.apply(s, v, m5))
    plain = saved(lambda s, v: attn._softmax_pv_plain(s, v, m5))
    assert helper == s.numel() * 4 + v.numel() * v.element_size()
    if dtype == torch.bfloat16:
        assert plain == 2 * s.numel() * 4 + v.numel() * 4
    else:
        assert plain >= helper


# blocked_attention's cases: (causal, window, cap, q_offset)
CASES = {"causal": (True, None, None, 0),
         "window": (True, 100, None, 0),
         "cap": (True, None, 20.0, 0),
         "noncausal": (False, None, None, 0),
         "offset": (True, None, None, -40)}
S, BLOCK = 300, 128                      # blocks of 128, 128 and 44 rows


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_lean_blocked_bit_equal_to_grad_path(dtype, case):
    causal, window, cap, off = CASES[case]
    q, k, v = _qkv(dtype, B=1, S=S, H=4, Hkv=2, D=8, seed=8)
    kw = dict(causal=causal, window=window, cap=cap, q_offset=off,
              block_q=BLOCK)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want = attn.blocked_attention(*leaves, **kw)
    assert want.grad_fn is not None
    with torch.no_grad():
        got = attn.blocked_attention(q, k, v, **kw)
    assert torch.equal(got, want.detach())
    # no input that requires grad: autograd records nothing either
    assert torch.equal(attn.blocked_attention(q, k, v, **kw), got)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_lean_blocked_peak_within_two_blocks(dtype):
    """The no-grad loop's peak of live bytes (the dry run's recorder, on
    meta tensors) is within: f32 copies of k and v and of one block's q,
    the blocks' f32 outputs and their concatenation (and its cast back),
    the block's masks, and two blocks of f32 scores. The recorded path
    keeps each block's weights for the backward pass and reads above it."""
    B, H, Hkv, D = 1, 4, 2, 8
    q, k, v = (torch.empty(B, S, h, D, dtype=dtype, device="meta")
               for h in (H, Hkv, Hkv))
    block = 4 * B * Hkv * (H // Hkv) * BLOCK * S
    out_f32 = 4 * B * S * H * D
    bound = (4 * (k.numel() + v.numel()) + 4 * B * BLOCK * H * D
             + 2 * out_f32 + q.numel() * q.element_size()
             + 4 * BLOCK * S + 2 * block)

    def step(q, k, v):
        return attn.blocked_attention(q, k, v, block_q=BLOCK)

    with torch.no_grad():
        lean, _ = traced_metrics(step, q, k, v)
    rec, _ = traced_metrics(step, *(t.requires_grad_(True)
                                    for t in (q, k, v)))
    assert lean["memory"]["temp_bytes"] <= bound
    assert rec["memory"]["temp_bytes"] > bound

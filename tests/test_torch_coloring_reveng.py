"""The port's channel reverse engineering (``core/coloring/device_model``,
``reveng``: verbatim numpy copies) and its MLP hash fit (``mlp_fit``, in
torch) against the reference.

The probes are the reference's code, so for the same seeds they give the
same latencies, pairwise verdicts, eviction sets, samples, labels and
granularity, array for array. The MLP's weights and minibatches come from
``torch.Generator``s and cannot equal ``jax.random``'s, so the fit is held
to the reference test's accuracy bar (``tests/test_coloring.py``), to the
hash itself on held-out addresses, and, on the same weights, to the
reference's ``mlp_apply`` (GELU in its tanh form) within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.coloring as jcol
from repro.core.coloring import mlp_fit as jfit
import repro_torch.core.coloring as col
from repro_torch.core.coloring import mlp_fit


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Small shapes and many small ops: two intra-op threads, so that the
    suite's parallel workers do not oversubscribe the cores (with all of
    them, this file ran 20-35x slower beside five other workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _devices(gpu, seed):
    return (col.VRAMDevice(col.gpu_hash_model(gpu), seed=seed),
            jcol.VRAMDevice(jcol.gpu_hash_model(gpu), seed=seed))


def test_exports_every_reference_name():
    want = {n for n in dir(jcol) if not n.startswith("_")}
    missing = sorted(n for n in want - set(dir(col))
                     if not hasattr(getattr(jcol, n), "__path__")
                     and getattr(jcol, n).__class__.__name__ != "module")
    assert missing == []
    assert "not ported" not in col.__doc__


def test_device_reads_equal_reference():
    dev, jdev = _devices("rtx-a2000", 7)
    addrs = np.random.default_rng(0).integers(0, 1 << 22, 400) * 64
    for a in addrs:
        assert dev.read(int(a)) == jdev.read(int(a))
    dev.flush(), jdev.flush()
    assert dev.read_chain(addrs[:50]) == jdev.read_chain(addrs[:50])
    assert dev.reads == jdev.reads
    np.testing.assert_array_equal(dev.tags, jdev.tags)


@pytest.mark.parametrize("gpu", ["rtx-a2000", "tesla-p40"])
def test_probes_equal_reference(gpu):
    dev, jdev = _devices(gpu, 3)
    rng = np.random.default_rng(1)
    pairs = rng.integers(0, 1 << 12, (40, 2)) * 1024
    got = [col.is_channel_conflicted(dev, int(a), int(b)) for a, b in pairs]
    want = [jcol.is_channel_conflicted(jdev, int(a), int(b))
            for a, b in pairs]
    assert got == want and any(got) and not all(got)
    assert (col.find_cache_conflict_addrs(dev, 0, 4 << 20, 4)
            == jcol.find_cache_conflict_addrs(jdev, 0, 4 << 20, 4))
    assert col.measure_granularity(dev) == jcol.measure_granularity(jdev)


def test_collect_samples_equals_reference():
    dev, jdev = _devices("rtx-a2000", 1)
    got = col.collect_samples(dev, 2 << 20, 150, seed=0)
    want = jcol.collect_samples(jdev, 2 << 20, 150, seed=0)
    for f in ("addrs", "labels", "true_channels"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.num_channels_found == want.num_channels_found
    assert got.label_accuracy == want.label_accuracy
    assert (col.build_channel_representatives(dev, 1 << 20)
            == jcol.build_channel_representatives(jdev, 1 << 20))


def test_page_bits_equal_reference():
    addrs = np.random.default_rng(2).integers(0, 1 << 34, 300)
    for gran, n_bits in ((1024, 14), (2048, 24)):
        got = col.page_bits(addrs, gran, n_bits)
        np.testing.assert_array_equal(got, jfit.page_bits(addrs, gran,
                                                          n_bits))
        assert got.dtype == np.float32


def test_mlp_apply_matches_reference():
    """Same weights on both sides: the forward (tanh-form GELU between
    layers) within 1e-5; torch's exact GELU would miss by ~1e-3."""
    params = mlp_fit.init_mlp(0, 12, 6, hidden=32, depth=4, device="cpu")
    x = col.page_bits(np.arange(64) * 1024, 1024, 12)
    want = np.asarray(jfit.mlp_apply(
        [{k: jnp.asarray(v.numpy()) for k, v in l.items()} for l in params],
        jnp.asarray(x)))
    got = mlp_fit.mlp_apply(params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # He-normal: std sqrt(2 / fan_in) a layer, zero biases
    assert abs(float(params[1]["w"].std()) - (2 / 32) ** 0.5) < 0.03
    assert all(float(l["b"].abs().max()) == 0.0 for l in params)


# ---------------------------------------------------------------------------
# twins of tests/test_coloring.py:39-80
# ---------------------------------------------------------------------------

def test_algo1_pairwise_conflict():
    hm = col.gpu_hash_model("rtx-a2000")
    dev = col.VRAMDevice(hm, seed=3)
    addrs = np.arange(0, 256 * 1024, 1024)
    ch = hm.channel_of(addrs)
    same = np.nonzero(ch == ch[0])[0]
    diff = np.nonzero(ch != ch[0])[0]
    assert col.is_channel_conflicted(dev, int(addrs[same[0]]),
                                     int(addrs[same[1]]))
    assert not col.is_channel_conflicted(dev, int(addrs[same[0]]),
                                         int(addrs[diff[0]]))


def test_reveng_finds_channels_and_granularity():
    hm = col.gpu_hash_model("rtx-a2000")
    dev = col.VRAMDevice(hm, seed=1)
    res = col.collect_samples(dev, 2 << 20, 150, seed=0)
    assert res.num_channels_found == hm.num_channels
    assert res.label_accuracy > 0.97
    assert col.measure_granularity(dev) == 2048


@pytest.mark.slow
def test_mlp_fit_high_accuracy():
    """The reference's slow-test settings; ``predict`` against the hash on
    every page of the space the fit did not see."""
    hm = col.gpu_hash_model("rtx-a2000")
    rng = np.random.default_rng(0)
    addrs = (rng.choice(8192, 3000, replace=False) * 1024).astype(np.int64)
    labels = hm.channel_of(addrs)
    fit = col.fit_channel_hash(addrs, labels, 1024, hm.num_channels,
                               steps=1200, hidden=128, depth=6, n_bits=14,
                               seed=0, device="cpu")
    assert fit.test_acc > 0.95, fit.test_acc
    held = np.setdiff1d(np.arange(8192) * 1024, addrs)
    pred = fit.predict(held)
    assert pred.dtype.kind == "i" and pred.shape == held.shape
    assert np.mean(pred == hm.channel_of(held)) >= 0.95
    assert fit.n_bits == 14 and len(fit.params) == 6

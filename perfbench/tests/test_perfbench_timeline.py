"""The end-to-end arithmetic on synthetic request timelines."""
import math

from perfbench import timeline as T


def _tl():
    tl = T.Timeline(t0=10.0, t1=20.0)
    # due before the window: judged by nobody's TTFT, its gaps count
    tl.ls.append(T.LSRecord(9.0, 100, 3, tokens=[9.5, 10.5, 11.0]))
    # due at the window's opening: in
    tl.ls.append(T.LSRecord(10.0, 100, 3, tokens=[10.2, 10.3, 10.6]))
    tl.ls.append(T.LSRecord(15.0, 100, 2, tokens=[16.0, 16.1]))
    # never served
    tl.ls.append(T.LSRecord(19.0, 100, 2, failed=True))
    # due at the window's close: out; its tokens fall in the drain
    tl.ls.append(T.LSRecord(20.0, 100, 2, tokens=[20.1, 20.2]))
    tl.be_steps += [(9.9, 500, 0), (10.0, 100, 4), (19.99, 0, 8),
                    (20.0, 700, 9)]
    tl.t_end = 40.0
    return tl


def test_window_edges():
    tl = _tl()
    assert [r.due for r in tl.ls_due()] == [10.0, 15.0, 19.0]


def test_failed_request_above_every_served_one():
    tl = _tl()
    # TTFTs 0.2, 1.0, failed: p50 is 1.0 s, p90 the failed one's wait
    assert T.ttft_percentile_ms(tl, 50) == 1000.0
    assert T.ttft_percentile_ms(tl, 90) == (40.0 - 19.0) * 1e3
    assert math.isinf(tl.ls[3].ttft_s) and math.isinf(tl.ls[3].tpot_s)


def test_gaps_whose_later_token_is_in_the_window():
    gaps = sorted(round(g, 6) for g in T.ls_gaps_s(_tl()))
    # 9.5->10.5, 10.5->11.0, 10.2->10.3, 10.3->10.6, 16.0->16.1;
    # 20.1->20.2 lies in the drain
    assert gaps == [0.1, 0.1, 0.3, 0.5, 1.0]


def test_slo_attainment_counts_failures_as_misses():
    tl = _tl()
    # TPOT: 0.2 s and 0.1 s; TTFT 0.2 and 1.0 s
    assert T.slo_attainment(tl, 1000.5, 250.0) == 100.0 * 2 / 3
    assert T.slo_attainment(tl, 500.0, 250.0) == 100.0 * 1 / 3
    assert T.slo_attainment(tl, 1e9, 150.0) == 100.0 * 1 / 3


def test_drain_and_preroll_count_in_no_rate():
    assert T.be_tokens_in_window(_tl()) == 100 + 4 + 8


def test_nearest_rank():
    assert T.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 99) == 10
    assert T.percentile([3, 1, 2], 50) == 2
    assert T.percentile([], 50) is None

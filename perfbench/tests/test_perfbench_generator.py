"""The traffic generator: a seed fixes the stream; another seed gives the
same work per segment in another order."""
import json
from collections import Counter
from pathlib import Path

from perfbench import generator

MIX = json.loads((Path(__file__).resolve().parents[1] / "traffic"
                  / "chat.json").read_text())
SEGS = [("preroll", 0.0, 10.0), ("window", 10.0, 45.0),
        ("drain", 55.0, 30.0)]
BIG = 2 ** 31 + 12345


def _key(reqs):
    return [(round(r.due, 9), len(r.prompt), r.max_new, r.segment,
             r.prompt[:4].tolist()) for r in reqs]


def test_same_seed_same_stream():
    a = generator.ls_stream(MIX["ls"], 2.5, SEGS, 151936, BIG, MIX["block_s"])
    b = generator.ls_stream(MIX["ls"], 2.5, SEGS, 151936, BIG, MIX["block_s"])
    assert _key(a) == _key(b)
    ba = generator.be_backlog(MIX["be"], 64, 100352, BIG)
    bb = generator.be_backlog(MIX["be"], 64, 100352, BIG)
    assert [r.prompt.tolist() for r in ba] == [r.prompt.tolist() for r in bb]


def test_other_seed_other_order_same_work():
    a = generator.ls_stream(MIX["ls"], 2.5, SEGS, 151936, BIG, MIX["block_s"])
    b = generator.ls_stream(MIX["ls"], 2.5, SEGS, 151936, BIG + 1, MIX["block_s"])
    assert _key(a) != _key(b)
    for name, start, seconds in SEGS:
        sa = [r for r in a if r.segment == name]
        sb = [r for r in b if r.segment == name]
        assert len(sa) == len(sb) == sum(
            round(2.5 * b) for _, b in generator.blocks(start, seconds,
                                                          MIX["block_s"]))
        assert Counter(len(r.prompt) for r in sa) == \
            Counter(len(r.prompt) for r in sb)
        assert Counter(r.max_new for r in sa) == \
            Counter(r.max_new for r in sb)
        assert all(start <= r.due < start + seconds for r in sa + sb)
        # the gaps' multiset is the same: so is their sum
        assert abs(max(r.due for r in sa) - max(r.due for r in sb)) < 1e-9


def test_blocks_carry_the_same_work():
    a = generator.ls_stream(MIX["ls"], 2.5, SEGS, 151936, BIG, MIX["block_s"])
    b = generator.ls_stream(MIX["ls"], 2.5, SEGS, 151936, BIG + 9, MIX["block_s"])
    for start, seconds in generator.blocks(10.0, 45.0, MIX["block_s"]):
        ia = [r for r in a if start <= r.due < start + seconds]
        ib = [r for r in b if start <= r.due < start + seconds]
        assert seconds <= MIX["block_s"] and len(ia) == len(ib) > 0
        assert sorted(r.max_new for r in ia) == sorted(r.max_new for r in ib)


def test_backlog_joined_part_way():
    full = generator.be_backlog(MIX["be"], 40, 100, 3)
    part = generator.be_backlog(MIX["be"], 40, 100, 3, joined=8)
    assert [r.max_new for r in part[8:]] == [r.max_new for r in full[8:]]
    assert all(1 <= p.max_new <= f.max_new for p, f in zip(part, full))
    assert sum(p.max_new for p in part[:8]) < sum(f.max_new
                                                  for f in full[:8])


def test_lengths_follow_the_mix():
    reqs = generator.ls_stream(MIX["ls"], 4.0, SEGS, 1000, 7, MIX["block_s"])
    plen = sorted(len(r.prompt) for r in reqs)
    assert plen[0] >= 32 and plen[-1] <= 2048
    med = plen[len(plen) // 2]
    assert 330 <= med <= 440          # lognormal median 384
    assert all(8 <= r.max_new <= 256 for r in reqs)
    assert all(0 <= int(r.prompt.max()) < 1000 for r in reqs)

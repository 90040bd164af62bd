"""The port's ``launch.hlo_metrics``: the reference's HLO collective parser
(a verbatim copy, held to the reference's own cases and to the reference
itself), and ``traced_metrics``, which reads per-device FLOPs, bytes and
collectives off a step run on DTensors: the funcol recorder's wire bytes
under the reference's model, and the four per-device FLOP cases
(column-parallel, row-parallel, replicated, data-parallel). Each fake
process group is destroyed before its test ends."""
import pytest
import torch
from torch.distributed.tensor import (Partial, Replicate, Shard,
                                      distribute_tensor)

from repro.launch import hlo_metrics as jhm
from repro_torch.launch.hlo_metrics import (_group_size, _shape_bytes,
                                            parse_collectives,
                                            traced_metrics)
from repro_torch.launch.mesh import fake_group, make_mesh

HLO = """
  %ar = f32[128,256]{1,0} all-reduce(%x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag.1 = bf16[512,64]{1,0} all-gather(%y), replica_groups=[16,32]<=[512] , dimensions={0}
  %rs = f32[32,64]{1,0} reduce-scatter(%z), replica_groups={{0,1},{2,3}}, to_apply=%add
  %a2a = bf16[8,8]{1,0} all-to-all(%w), replica_groups={{0,1,2,3,4,5,6,7}}
  %cp = f32[16]{0} collective-permute(%v), source_target_pairs={{0,1}}
  %ar2-start = f32[4]{0} all-reduce-start(%q), replica_groups={{0,1}}
  %ar2-done = f32[4]{0} all-reduce-done(%ar2-start)
"""


def test_shape_bytes():
    assert _shape_bytes("f32[128,256]") == 128 * 256 * 4
    assert _shape_bytes("bf16[512,64]") == 512 * 64 * 2
    assert _shape_bytes("(f32[2,2], bf16[4])") == 16 + 8


def test_group_size_formats():
    assert _group_size("replica_groups={{0,1,2,3}}", 8) == 4
    assert _group_size("replica_groups=[16,32]<=[512]", 8) == 32
    assert _group_size("no groups here", 8) == 8


def test_parse_collectives_counts_and_wire():
    st = parse_collectives(HLO, n_devices=512)
    assert st.counts["all-reduce"] == 2
    assert st.counts["all-gather"] == 1
    assert st.counts["reduce-scatter"] == 1
    assert st.counts["all-to-all"] == 1
    assert st.counts["collective-permute"] == 1
    s_ar = 128 * 256 * 4
    assert abs(st.wire_bytes["all-reduce"]
               - (2 * s_ar * 3 / 4 + 2 * 16 * 1 / 2)) < 1e-6
    s_ag = 512 * 64 * 2
    assert abs(st.wire_bytes["all-gather"] - s_ag * 31 / 32) < 1e-6
    s_rs = 32 * 64 * 4
    assert st.wire_bytes["reduce-scatter"] == s_rs * 1
    assert st.total_wire_bytes > 0
    # the reference's parser, on the same text
    assert st.to_dict() == jhm.parse_collectives(HLO, 512).to_dict()


@pytest.fixture
def mesh24():
    with fake_group(8):
        yield make_mesh((2, 4), ("data", "model"))


def _mm(x, w):
    return x @ w


M, K, N = 64, 256, 128
WHOLE = 2 * M * K * N


def _flops(mesh, xp, wp):
    x = distribute_tensor(torch.empty(M, K, device="meta"), mesh.device_mesh,
                          xp)
    w = distribute_tensor(torch.empty(K, N, device="meta"), mesh.device_mesh,
                          wp)
    m, out = traced_metrics(_mm, x, w)
    return m, out


def test_flops_column_parallel_is_a_quarter(mesh24):
    m, out = _flops(mesh24, [Replicate(), Replicate()],
                    [Replicate(), Shard(1)])
    assert tuple(out.placements) == (Replicate(), Shard(1))
    assert m["flops"] == WHOLE / 4
    assert m["collectives"]["counts"] == {}


def test_flops_row_parallel_is_a_quarter(mesh24):
    m, out = _flops(mesh24, [Replicate(), Shard(1)],
                    [Replicate(), Shard(0)])
    assert tuple(out.placements) == (Replicate(), Partial())
    assert m["flops"] == WHOLE / 4


def test_flops_replicated_is_whole(mesh24):
    m, out = _flops(mesh24, [Replicate(), Replicate()],
                    [Replicate(), Replicate()])
    assert m["flops"] == WHOLE


def test_flops_data_parallel_times_ranks_is_unsharded():
    with fake_group(8):
        mesh = make_mesh((8,), ("data",))
        m, _ = _flops(mesh, [Shard(0)], [Replicate()])
    plain, _ = traced_metrics(_mm, torch.empty(M, K, device="meta"),
                              torch.empty(K, N, device="meta"))
    assert plain["flops"] == WHOLE
    assert 8 * m["flops"] == plain["flops"]


def test_recorder_wire_bytes(mesh24):
    """Each redistribute's collective, by its local result bytes and group
    size, under the reference's ring model: an all-gather over model (4)
    to a [64, 128] f32 tensor, a reduce-scatter over data (2) of a partial
    sum to a [32, 128] shard, an all-reduce over model of a [32, 128]
    partial shard."""
    from torch.distributed.tensor import DTensor
    dm = mesh24.device_mesh
    x = distribute_tensor(torch.empty(64, 128, device="meta"), dm,
                          [Replicate(), Shard(1)])
    p = DTensor.from_local(torch.empty(64, 128, device="meta"), dm,
                           [Partial(), Replicate()], run_check=False)
    q = DTensor.from_local(torch.empty(32, 128, device="meta"), dm,
                           [Shard(0), Partial()], run_check=False)

    def step(x, p, q):
        return (x.redistribute(dm, [Replicate(), Replicate()]),
                p.redistribute(dm, [Shard(0), Replicate()]),
                q.redistribute(dm, [Shard(0), Replicate()]))

    m, _ = traced_metrics(step, x, p, q)
    c = m["collectives"]
    assert c["counts"] == {"all-gather": 1, "reduce-scatter": 1,
                           "all-reduce": 1}
    ag, rs, ar = 64 * 128 * 4, 32 * 128 * 4, 32 * 128 * 4
    assert c["result_bytes"] == {"all-gather": ag, "reduce-scatter": rs,
                                 "all-reduce": ar}
    assert c["wire_bytes"]["all-gather"] == ag * 3 / 4
    assert c["wire_bytes"]["reduce-scatter"] == rs * 1
    assert c["wire_bytes"]["all-reduce"] == 2 * ar * 3 / 4
    assert c["total_wire_bytes"] == sum(c["wire_bytes"].values())
    assert m["memory"]["argument_bytes"] == (64 * 32 + 64 * 128
                                             + 32 * 128) * 4


def test_memory_keys_on_plain_tensors():
    """Argument bytes are the inputs', temp the peak of live new storage,
    alias the results updated in place, code 0."""
    a = torch.ones(16, 16)

    def step(a):
        b = a * 2                         # 1 KiB, freed at the end
        c = (b + 1).sum()
        a.add_(c)                         # in place: an alias
        return a, c

    m, _ = traced_metrics(step, a)
    mem = m["memory"]
    assert mem["argument_bytes"] == 1024
    assert mem["temp_bytes"] >= 2048
    assert mem["alias_bytes"] == 1024
    assert mem["output_bytes"] == 1024 + 4
    assert mem["code_bytes"] == 0
    assert m["flops"] == 0 and m["bytes_accessed"] > 0


def test_recorder_releases_meta_storages():
    """A meta storage leaves the count when its last tensor dies: a chain
    of ten 4 KiB results, each dropping the one before, peaks at two of
    them (the step's own argument is not temp), and views are free."""
    def step(x):
        y = x.view(32, 32)
        for _ in range(10):
            y = y * 2
        return y.view(-1)

    m, _ = traced_metrics(step, torch.empty(1024, device="meta"))
    assert m["memory"]["temp_bytes"] == 2 * 4096


def test_recorder_counts_a_collective_wrapper_once():
    """A collective's autograd wrapper is its input under another storage
    (its meta kernel allocates one, a real run wraps): one logical
    tensor, counted once, and live while either lives."""
    wrap = torch.ops._c10d_functional._wrap_tensor_autograd

    def step(x):
        w = wrap(x * 2)              # 4 KiB, the product's own storage
        return w + 1                 # 4 KiB more while w lives: 8 KiB

    m, _ = traced_metrics(step, torch.empty(1024, device="meta"))
    assert m["memory"]["temp_bytes"] == 2 * 4096


def test_trace_repeats_exactly(mesh24):
    """Two traces of one sharded step in one process give the same
    temp (entries are keyed by id, so a storage address reused after a
    free is a new storage) and the same collectives."""
    from repro_torch.configs import smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import trace_cell, tune_config
    shape = ShapeConfig("t", 32, 8, "train")
    cfg = tune_config(smoke_config("qwen3-1.7b"), shape.kind)
    a, b = (trace_cell(cfg, shape, mesh24, "train") for _ in range(2))
    assert a["memory"]["temp_bytes"] == b["memory"]["temp_bytes"]
    assert a["collectives"]["shapes"] == b["collectives"]["shapes"]

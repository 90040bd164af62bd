"""Mesh construction (``repro.launch.mesh`` on ``torch.distributed``).

``make_mesh`` lays a named mesh over the default process group, so it needs
one, of exactly the mesh's size. Three ways to have one:
  * ``fake_group(n)``: a fake group of ``n`` ranks in this one process
    (``torch.testing``'s ``FakeStore``; every collective returns at once).
    It is the counterpart of the reference's
    ``--xla_force_host_platform_device_count`` for the dry run: the 256- and
    512-rank production meshes trace in one process, on meta tensors;
  * ``run_local(n, fn, ...)``: ``n`` local processes, one rank each, on
    gloo (CPU) or NCCL (one card a rank), for the launcher's ``--devices``
    and the tests;
  * ``local_group(backend)``: this process as rank 0 of a group of one.
Each of them destroys its group on the way out.
"""
from __future__ import annotations

import socket
import time
from contextlib import contextmanager

import numpy as np
import torch
import torch.distributed as dist

from ..dist.sharding import Mesh


def make_mesh(shape, axes, device_type=None):
    """A :class:`Mesh` of ``shape`` named ``axes`` over the default process
    group, whose world size must be ``prod(shape)``. Its device type is
    "cuda" on NCCL and "cpu" otherwise (gloo, or a fake group)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    if not dist.is_initialized():
        raise RuntimeError(f"make_mesh{shape} needs a process group "
                           "(fake_group, run_local or local_group)")
    world = dist.get_world_size()
    if world != int(np.prod(shape)):
        raise ValueError(f"mesh {shape} has {int(np.prod(shape))} ranks; "
                         f"the process group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(init_device_mesh(device_type, shape, mesh_dim_names=axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 chips per pod; 2x16x16 = 512 chips across two pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


@contextmanager
def fake_group(n: int):
    """A fake process group of ``n`` ranks in this process (this process is
    rank 0), destroyed on exit. Collectives move nothing: it serves
    tracing on meta tensors."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextmanager
def local_group(backend: str = "nccl", port: int | None = None):
    """This process as the one rank of a ``backend`` group, destroyed on
    exit (NCCL: the current card)."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port or free_port()}",
        rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(rank, n, backend, port, threads, fn, args, results):
    if threads:
        torch.set_num_threads(threads)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=n)
    try:
        out = fn(rank, *args)
        results.put((rank, None, out))
    except BaseException as e:                  # reported by the parent
        import traceback
        results.put((rank, f"{type(e).__name__}: {e}\n"
                     f"{traceback.format_exc()[-3000:]}", None))
    finally:
        dist.destroy_process_group()


def run_local(n: int, fn, *args, backend: str = "gloo", threads: int = 0,
              timeout: float = 600.0):
    """Run ``fn(rank, *args)`` in ``n`` new processes, one rank each, in a
    ``backend`` group of ``n`` on this host (``fn`` must be importable:
    the processes are spawned). Returns the ``n`` results in rank order;
    raises, and kills the other ranks, when a rank raises, dies or does
    not finish in ``timeout`` seconds. ``threads`` caps each
    rank's intra-op threads."""
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, backend, port, threads, fn, args,
                               results), daemon=True)
             for r in range(n)]
    for p in procs:
        p.start()
    out, errors = [None] * n, []
    deadline = time.monotonic() + timeout
    got, done = 0, False
    try:
        while got < n:
            if results.empty():
                if time.monotonic() > deadline:
                    raise TimeoutError(f"run_local: {n - got} of {n} ranks "
                                       f"did not finish in {timeout} s")
                if any(p.exitcode not in (None, 0) for p in procs):
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    if results.empty():
                        raise RuntimeError(f"run_local: ranks {dead} died")
                time.sleep(0.05)
                continue
            rank, err, res = results.get()
            got += 1
            if err:                 # the other ranks may wait on it forever
                errors.append(f"rank {rank}: {err}")
                break
            out[rank] = res
        done = not errors
    finally:
        for p in procs:
            p.join(timeout=30 if done else 0)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return out

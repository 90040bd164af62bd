"""Shadow-page-table gather and scatter on Hopper: a tenant's tensor read
from, or written to, its colored pages of a flat arena (the paper's Fig. 10
kernel transformation).

CUDA wrappers for ``csrc/spt_gather.cu``. They replace the Pallas kernels
``src/repro/kernels/spt_gather.py::spt_gather`` (``out[i] =
arena[spt[i]]``) and ``::spt_scatter`` (its inverse into a zeroed arena,
which the wrapper allocates with ``torch.zeros``), with the same arguments
and result, bit-exact. ``spt`` is the ``Allocation.spt`` that
:class:`repro_torch.core.coloring.ColoredArena` hands out; its entries must
lie in the arena, and be unique for scatter. Neither is checked on the card
(that costs a host sync); the kernel clamps gather entries into the arena
and drops scatter entries outside it, so a bad table cannot fault the card.

What bounds them on the card is bytes: every page is read once and written
once (for scatter, the zeroing writes the rest of the arena). The kernel
copies a page per warp with 16-byte vectors and int64 offsets.

CUDA tensors only; :mod:`repro_torch.kernels.ops` sends CPU tensors to the
plain versions. Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from ._build import check_cuda, check_launch, entry, stream_of


def _copy(name, src, dst, spt):
    """Launch ``sgdrc_<name>`` copying whole rows of ``src`` to ``dst``."""
    if src.dim() != 2 or dst.dim() != 2 or src.shape[1] != dst.shape[1]:
        raise ValueError(f"{name}: need 2-D pages of one width, got "
                         f"{tuple(src.shape)} and {tuple(dst.shape)}")
    dev = check_cuda(name, {"src": src, "dst": dst})
    if src.dtype != dst.dtype:
        raise ValueError(f"{name}: {src.dtype} pages into {dst.dtype}")
    spt = torch.as_tensor(spt, device=dev).to(torch.int32).contiguous()
    logical = dst if name == "spt_gather" else src
    if spt.dim() != 1 or spt.numel() != logical.shape[0]:
        raise ValueError(f"{name}: spt {tuple(spt.shape)} for "
                         f"{logical.shape[0]} logical pages")
    err = entry("spt_gather", f"sgdrc_{name}")(
        src.data_ptr(), dst.data_ptr(), spt.data_ptr(), spt.numel(),
        src.shape[1] * src.element_size(), src.shape[0], dst.shape[0],
        stream_of(dev))
    check_launch(name, err)


def spt_gather(arena, spt):
    """arena: [n_arena_pages, page_elems]; spt: [n_pages] int. Returns the
    logical tensor [n_pages, page_elems]."""
    arena = arena.contiguous()
    out = torch.empty(len(spt), arena.shape[1], dtype=arena.dtype,
                      device=arena.device)
    _copy("spt_gather", arena, out, spt)
    spt_gather.launches += 1
    return out


def spt_scatter(x, spt, n_arena_pages):
    """x: [n_pages, page_elems] placed at the ``spt`` rows of a fresh zeroed
    arena [n_arena_pages, page_elems], which is returned."""
    x = x.contiguous()
    out = torch.zeros(n_arena_pages, x.shape[1], dtype=x.dtype,
                      device=x.device)
    _copy("spt_scatter", x, out, spt)
    spt_scatter.launches += 1
    return out


spt_gather.launches = 0
spt_scatter.launches = 0

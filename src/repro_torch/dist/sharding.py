"""Sharding rules + mesh context for the unified model
(``repro.dist.sharding`` on DTensor).

``use_mesh`` installs a process-wide current mesh; ``hint`` redistributes a
DTensor to named placements against it (and is the identity outside any
mesh, so single-device runs and the serving engine never pay for it).
``param_pspecs`` derives a spec tree for a params tree with divisibility
guards: any dim that doesn't divide the model-axis size replicates, so the
same rules hold on 1x1 meshes, the 8-rank meshes of the tests and the 16x16
production mesh.

A :class:`Mesh` wraps a ``torch.distributed.device_mesh.DeviceMesh`` under
the reference's attribute names (``axis_names``, ``shape`` as a dict,
``size``). A :class:`PSpec` is the counterpart of a ``NamedSharding``: its
``spec`` is the reference's ``PartitionSpec`` as a tuple (a mesh-axis name,
a tuple of names, or None per tensor dim) and its ``placements`` the
DTensor placements (``Shard(d)`` or ``Replicate()`` per mesh dim).

Conventions (the pure rule is ``partition_dims`` — directly testable against
production mesh sizes without a mesh):
  * batch dims shard over ("pod",)+("data",) — see ``batch_axes``,
  * embeddings shard the vocab dim on "model"; other >=2-D params shard their
    largest divisible dim on "model"; 1-D params (norm scales) replicate,
  * MoE expert tensors (``.../experts/...``, shaped ``[..., E, din, dout]``
    with an optional leading stacked layer dim) shard the expert dim on the
    mesh's "expert" axis when it has one, and "model" only considers the
    matmul dims after it,
  * MLA down-projections (``wq_a``/``wkv_a``) never shard their trailing
    latent dim (it feeds the latent RMSNorm); up-projections
    (``wq_b``/``wk_b``/``wv_b``, shaped ``[..., latent, heads, head_dim]``)
    shard heads first and never the shared latent dim,
  * attention params honour ``set_attn_fallback``: "headdim" (default) may
    shard the trailing head_dim, "replicate" never does — the knob the
    dry run exposes for archs whose head counts don't divide the mesh.

``partition_dims``, ``batch_axes``, ``set_attn_fallback``,
``current_mesh``/``use_mesh`` and ``_path_str`` are the reference's,
verbatim.

Where the reference leaves a placement to XLA's propagation, the port
states it: a model block runs under :func:`local_call` with the specs
XLA's compiled program gives it (``spec_of`` reads a DTensor's own), and
its collectives are the ones the specs imply (:class:`Reduced` outputs,
:func:`whole_product`, :func:`mesh_reduce`); every redistribution, both
ways, goes one mesh dim at a time (:func:`move`, :func:`place`). Neither
DTensor's sharding propagation nor its redistribution planner then
chooses a placement or a collective, so a traced step is the same on
every torch version.
"""
from __future__ import annotations

from contextlib import contextmanager

_CURRENT_MESH = None
_ATTN_FALLBACK = "headdim"   # "headdim" | "replicate"


class Mesh:
    """A ``DeviceMesh`` with the reference's attribute names: ``axis_names``
    (its dim names, in order), ``shape`` ({name: size}) and ``size``."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.shape))
        self.size = device_mesh.size()

    @property
    def device_type(self) -> str:
        return self.device_mesh.device_type

    def __repr__(self):
        return f"Mesh({self.shape}, {self.device_type})"


class PSpec:
    """A tensor's sharding on ``mesh``: ``spec`` per tensor dim as the
    reference's ``PartitionSpec`` holds it, ``placements`` per mesh dim."""

    def __init__(self, mesh: Mesh, spec=()):
        self.mesh = mesh
        self.spec = tuple(spec)

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for ax in self.mesh.axis_names:
            dims = [d for d, s in enumerate(self.spec)
                    if s == ax or (isinstance(s, tuple) and ax in s)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def __repr__(self):
        return f"PSpec{self.spec}"


def set_attn_fallback(mode: str):
    global _ATTN_FALLBACK
    assert mode in ("headdim", "replicate"), mode
    _ATTN_FALLBACK = mode


def current_mesh():
    return _CURRENT_MESH


@contextmanager
def use_mesh(mesh):
    """Install ``mesh`` as the process-wide mesh for hint()/tracing."""
    global _CURRENT_MESH
    prev = _CURRENT_MESH
    _CURRENT_MESH = mesh
    try:
        yield mesh
    finally:
        _CURRENT_MESH = prev


def batch_axes(mesh) -> tuple:
    """Mesh axes the batch dim shards over (pod-major)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _hint_spec(mesh, shape, axes) -> tuple:
    spec = []
    for dim, ax in zip(shape, axes):
        if (ax is None or ax not in mesh.axis_names
                or mesh.shape[ax] <= 1 or dim % mesh.shape[ax] != 0):
            spec.append(None)
        else:
            spec.append(ax)
    return tuple(spec)


def hint(x, *axes):
    """Sharding constraint by mesh-axis names (None = replicate that dim).
    The identity outside a mesh; inside one, ``x`` (a DTensor, or a plain
    tensor, which every rank holds whole) is redistributed to those
    placements. Axes absent from the mesh (e.g. "expert" on a data/model
    mesh) or non-divisible dims replicate."""
    mesh = _CURRENT_MESH
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate
    placements = PSpec(mesh, _hint_spec(mesh, x.shape, axes)).placements
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh.device_mesh,
                               [Replicate()] * len(placements),
                               run_check=False)
    return place(x, placements)


def _on_mesh(mesh, spec) -> tuple:
    """``spec`` without the axis names ``mesh`` lacks."""
    out = []
    for s in spec:
        if isinstance(s, tuple):
            s = tuple(a for a in s if a in mesh.axis_names) or None
        elif s is not None and s not in mesh.axis_names:
            s = None
        out.append(s)
    return tuple(out)


class Reduced:
    """An out spec of :func:`local_call`: each rank's result is one part
    of the whole over the mesh axes ``over``, combined by ``op`` ("sum" or
    "max") as it comes back (an all-reduce an axis); ``spec`` places the
    other dims."""

    def __init__(self, spec=(), over=("model",), op="sum"):
        self.spec, self.over, self.op = tuple(spec), tuple(over), op


def axes_of(s) -> tuple:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    return () if s is None else (s,) if isinstance(s, str) else tuple(s)


def spec_of(t) -> tuple:
    """The spec of a DTensor's placements: per tensor dim, the mesh axis
    it is split over (a tuple where several), None where whole; all None
    for a plain tensor. Partial placements are not specs (none here)."""
    spec = [None] * t.dim()
    for name, p in zip(getattr(getattr(t, "device_mesh", None),
                               "mesh_dim_names", None) or (),
                       getattr(t, "placements", ())):
        if p.is_shard():
            d = p.dim % t.dim()
            spec[d] = name if spec[d] is None else axes_of(spec[d]) + (name,)
    return tuple(spec)


def reshard(x, spec):
    """``x`` redistributed to ``spec`` (per dim: a mesh axis, a tuple of
    them or None) on the current mesh; names it lacks replicate. The
    identity outside a mesh."""
    mesh = _CURRENT_MESH
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate
    pl = PSpec(mesh, _on_mesh(mesh, spec)).placements
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh.device_mesh,
                               [Replicate()] * len(pl), run_check=False)
    return place(x, pl)


def move(x, placements):
    """The DTensor ``x`` redistributed to ``placements`` one mesh dim at a
    time, in an order fixed here (each step one collective or none), so
    that no torch version's redistribution planner chooses it: partial
    sums first (reduce-scattered where the target splits that dim and no
    other mesh dim splits its tensor dim, else all-reduced), then every
    mesh dim splitting a tensor dim whose split changes gathered, the
    innermost first, then the target's splits cut, the outermost first
    (a local slice). Not differentiable by itself: :func:`place` is."""
    from torch.distributed.tensor import Replicate
    dm = x.device_mesh
    target = tuple(placements)
    cur = list(x.placements)

    def step(i, p):
        nonlocal x
        cur[i] = p
        x = x.redistribute(dm, tuple(cur))

    def splits(pl, d):
        return {i for i, p in enumerate(pl) if p.is_shard(d)}

    for i, p in enumerate(cur):
        if p.is_partial() and not target[i].is_partial():
            t = target[i]
            alone = t.is_shard() and splits(cur, t.dim) == set() and \
                splits(target, t.dim) == {i}
            step(i, t if alone else Replicate())
    moved = {p.dim for p, t in zip(cur, target) if p.is_shard() and p != t}
    moved |= {t.dim for p, t in zip(cur, target)
              if t.is_shard() and splits(cur, t.dim) != splits(target, t.dim)}
    for i in reversed(range(len(cur))):
        if cur[i].is_shard() and cur[i].dim in moved:
            step(i, Replicate())
    for i, t in enumerate(target):
        if cur[i] != t:
            step(i, t)
    return x


_PLACE = None


def place(x, placements):
    """``x`` (a DTensor) moved to ``placements`` by :func:`move`, and its
    gradient moved back by :func:`move` to ``x``'s own placements (its
    partial sums reduced where they arrive), so neither direction is left
    to DTensor's planner."""
    global _PLACE
    if _PLACE is None:
        import torch

        class Place(torch.autograd.Function):
            @staticmethod
            def forward(ctx, t, pl, back):
                ctx.back = back
                return move(t, pl)

            @staticmethod
            def backward(ctx, g):
                return move(g, ctx.back), None, None
        _PLACE = Place
    if tuple(x.placements) == tuple(placements) and not x.requires_grad:
        return x
    return _PLACE.apply(x, tuple(placements), tuple(x.placements))


_REDUCED = None


def reduced_out(t, dm, placements):
    """The DTensor whose rank shards are ``t`` placed by ``placements``
    (some Partial), its partial sums reduced by :func:`move`. Its gradient
    comes back to ``t`` as the whole gradient's local part: each rank's
    part of a sum has the sum's gradient (whatever a torch version's
    ``from_local`` makes of a Partial's gradient)."""
    global _REDUCED
    if _REDUCED is None:
        import torch
        from torch.distributed.tensor import DTensor, Replicate

        class ReducedOut(torch.autograd.Function):
            @staticmethod
            def forward(ctx, local, dm, pl):
                d = DTensor.from_local(local, dm, pl, run_check=False)
                ctx.whole = [Replicate() if p.is_partial() else p
                             for p in pl]
                return move(d, ctx.whole)

            @staticmethod
            def backward(ctx, g):
                return move(g, ctx.whole).to_local(), None, None
        _REDUCED = ReducedOut
    return _REDUCED.apply(t, dm, tuple(placements))


_LOCAL_MESH = None      # the mesh a local_call function runs on


def _group(mesh, axis):
    return (mesh.device_mesh, mesh.axis_names.index(axis))


def mesh_reduce(t, axes, op="sum"):
    """Inside a :func:`local_call` function: ``t`` combined by ``op``
    ("sum", "max") over the ranks of the mesh ``axes`` (an all-reduce an
    axis); the identity outside one, or over axes of size 1. Not
    differentiable: for steps that take no gradient."""
    mesh = _LOCAL_MESH
    if mesh is None:
        return t
    import torch.distributed._functional_collectives as funcol
    for ax in axes_of(axes):
        if mesh.shape.get(ax, 1) > 1:
            t = funcol.all_reduce(t, op, _group(mesh, ax))
    return t


def mesh_gather(t, dim, axes):
    """Inside a :func:`local_call` function: the ranks' ``t`` over the
    mesh ``axes`` concatenated along ``dim`` (an all-gather an axis, the
    last axis first); the identity outside one. Not differentiable."""
    mesh = _LOCAL_MESH
    if mesh is None:
        return t
    import torch.distributed._functional_collectives as funcol
    for ax in reversed(axes_of(axes)):
        if mesh.shape.get(ax, 1) > 1:
            t = funcol.all_gather_tensor(t.contiguous(), dim,
                                         _group(mesh, ax))
    return t


def whole_product(eq, x, w, wspec):
    """Inside a :func:`local_call` function: ``torch.einsum(eq, x, W)``
    made whole, for the rank's shard ``w`` of a weight ``W`` placed by
    ``wspec`` and an ``x`` whole over the mesh axes of ``wspec``. ``x`` is
    cut to the rank's range of each split dim it shares with ``W``; where
    that dim is summed, the partial products are summed (an all-reduce),
    where it is a result dim, the shards are gathered along it (an
    all-gather). The plain einsum outside a mesh. Not differentiable: for
    steps that take no gradient (decode)."""
    import torch
    mesh = _LOCAL_MESH
    if mesh is None:
        return torch.einsum(eq, x, w)
    ins, out = eq.replace(" ", "").split("->")
    lx, lw = ins.split(",")
    summed, gathered = [], []
    for i, s in enumerate(wspec):
        axes = [a for a in axes_of(s) if mesh.shape.get(a, 1) > 1]
        if not axes:
            continue
        c, n, coord = lw[i], w.shape[i], 0
        for a in axes:
            coord = coord * mesh.shape[a] + \
                mesh.device_mesh.get_local_rank(a)
        if c in lx:
            x = x.narrow(lx.index(c), coord * n, n)
        if c in out:
            gathered.append((out.index(c), axes))
        else:
            summed += axes
    y = mesh_reduce(torch.einsum(eq, x, w), tuple(summed))
    for d, axes in gathered:
        y = mesh_gather(y, d, tuple(axes))
    return y


def local_call(fn, *args, in_specs=None, out_specs=None):
    """``fn`` on plain tensors, each rank on its own shards: the port's
    ``shard_map``, for a region whose ops DTensor has no sharding rule
    for (sorts, cumulative counts, data-dependent scatters) or whose
    per-row loops its propagation would walk op by op. Each tensor
    argument is redistributed to its spec of ``in_specs`` (mesh-axis names
    per dim, as a PartitionSpec; names the mesh lacks replicate; default:
    replicated whole) and passed as its local tensor; each tensor ``fn``
    returns (in tuples, named tuples, lists and dicts, in that order) comes
    back as a DTensor placed by the next spec of ``out_specs`` (default:
    replicated). The caller states specs under which ``fn`` on the shards
    is ``fn`` on the whole. An out spec may be :class:`Reduced`: ``fn``
    returns each rank's part and the whole comes back. ``fn`` runs with
    no current mesh (a ``hint`` or ``local_call`` inside it is the
    identity), and its own collectives (:func:`mesh_reduce`,
    :func:`mesh_gather`, :func:`whole_product`) go over the mesh. Outside
    a mesh it is ``fn(*args)``. Differentiable both ways: each argument's
    gradient goes back to the argument's own placements, its partial sums
    reduced where they arrive (:func:`place`)."""
    global _LOCAL_MESH
    mesh = _CURRENT_MESH
    if mesh is None:
        return fn(*args)
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate
    dm = mesh.device_mesh
    in_specs = list(in_specs or [()] * len(args))
    tensors = [isinstance(a, torch.Tensor) for a in args]
    pls = [PSpec(mesh, _on_mesh(mesh, spec)).placements for spec in in_specs]
    # mesh dims the work is split over: an argument whole on such a dim
    # gets, on each rank, the gradient of that rank's share alone (a
    # partial sum), as shard_map's transpose of a replicated input
    split = {i for pl, t in zip(pls, tensors) if t
             for i, p in enumerate(pl) if p.is_shard()}
    local = []
    for a, pl, t in zip(args, pls, tensors):
        if t:
            if not isinstance(a, DTensor):
                a = DTensor.from_local(a, dm, [Replicate()] * dm.ndim,
                                       run_check=False)
            grad = [p if p.is_shard() else
                    Partial() if i in split else Replicate()
                    for i, p in enumerate(pl)]
            a = place(a, pl).to_local(grad_placements=grad)
        local.append(a)
    specs = iter(out_specs or ())
    prev = _LOCAL_MESH
    _LOCAL_MESH = mesh
    try:
        with use_mesh(None):
            res = fn(*local)
    finally:
        _LOCAL_MESH = prev
    return _wrap_out(res, specs, mesh)


def _wrap_out(t, specs, mesh):
    """:func:`local_call`'s result ``t``, each plain tensor (in tuples,
    named tuples, lists and dicts) a DTensor placed by the next of
    ``specs``. (A module-level recursion: a nested one would be a
    reference cycle, freed only by the garbage collector.)"""
    import torch
    from torch.distributed.tensor import DTensor, Partial
    dm = mesh.device_mesh
    if isinstance(t, torch.Tensor) and not isinstance(t, DTensor):
        spec = next(specs, ())
        if not isinstance(spec, Reduced):
            return DTensor.from_local(
                t, dm, PSpec(mesh, _on_mesh(mesh, spec)).placements,
                run_check=False)
        pl = [Partial(spec.op) if ax in spec.over else p
              for ax, p in zip(mesh.axis_names,
                               PSpec(mesh, _on_mesh(mesh, spec.spec))
                               .placements)]
        return reduced_out(t, dm, pl)
    if isinstance(t, dict):
        return {k: _wrap_out(v, specs, mesh) for k, v in t.items()}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(_wrap_out(v, specs, mesh) for v in t))
    if isinstance(t, (tuple, list)):
        return type(t)(_wrap_out(v, specs, mesh) for v in t)
    return t


def take_rows(table, ids):
    """``table[ids]``. For a DTensor ``table`` (an embedding, split on its
    rows over "model" by the rules) each rank looks its ids up in its own
    rows, zero where another rank holds the row, and the partial results
    are summed over those mesh dims (an all-reduce): the vocab-parallel
    lookup, written on local tensors, so that no gather or scatter goes
    through DTensor's sharding rules. ``ids`` keep their batch split on
    mesh dims where the table is whole."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(table, DTensor):
        return table[ids]
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    dm = table.device_mesh
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, dm, [Replicate()] * dm.ndim,
                                 run_check=False)
    t_pl = tuple(table.placements)
    ids_pl = [Shard(0) if ip.is_shard(0) and not tp.is_shard()
              else Replicate() for tp, ip in zip(t_pl, ids.placements)]
    grad = [tp if tp.is_shard() else
            Partial() if ip.is_shard() else Replicate()
            for tp, ip in zip(t_pl, ids_pl)]
    tl = place(table, t_pl).to_local(grad_placements=grad)
    il = move(ids, ids_pl).to_local()
    if any(tp.is_shard(0) for tp in t_pl):
        shape, offset = compute_local_shape_and_global_offset(
            table.shape, dm, t_pl)
        rel = il - offset[0]
        inside = (rel >= 0) & (rel < shape[0])
        rows = tl[rel.clamp(0, shape[0] - 1)].masked_fill(
            ~inside[..., None], 0)
    else:
        rows = tl[il]
    out = [Partial() if tp.is_shard(0) else
           Shard(rows.dim() - 1) if tp.is_shard() else ip
           for tp, ip in zip(t_pl, ids_pl)]
    return reduced_out(rows, dm, out)


def _path_str(path) -> str:
    out = []
    for k in path:
        if hasattr(k, "key"):
            out.append(str(k.key))
        elif hasattr(k, "idx"):
            out.append(str(k.idx))
        else:
            out.append(str(k))
    return "/".join(out)


def partition_dims(name, shape, *, model: int = 1, expert: int = 1,
                   attn_fallback=None) -> tuple:
    """Mesh-axis name (or None) per dim of one param — the pure sharding
    rule behind :func:`param_pspecs` (module docstring conventions).
    ``model``/``expert`` are the mesh axis sizes; a dim that doesn't divide
    its axis replicates, so the rule is safe at any mesh shape."""
    if attn_fallback is None:
        attn_fallback = _ATTN_FALLBACK
    nd = len(shape)
    s = [None] * nd
    if nd < 2:
        return tuple(s)

    def fits(i, size):
        return size > 1 and shape[i] >= size and shape[i] % size == 0

    lo = 0
    if "/experts/" in f"/{name}/" and nd >= 3:
        # [..., E, din, dout]: expert dim on "expert"; "model" only
        # considers the per-expert matmul dims after it (never E, never a
        # leading vmapped layer dim)
        e = nd - 3
        if fits(e, expert):
            s[e] = "expert"
        lo = e + 1
    cands = list(range(lo, nd))
    leaf = name.rsplit("/", 1)[-1]
    if leaf in ("wq_a", "wkv_a"):
        # MLA down-projection [*, d_model, latent]: the latent output feeds
        # the latent RMSNorm — keep it whole, shard the model dim
        cands = sorted((i for i in cands if i != nd - 1),
                       key=lambda i: -shape[i])
    elif leaf in ("wq_b", "wk_b", "wv_b") and nd >= 3:
        # MLA up-projection [*, latent, heads, head_dim]: heads are the
        # tensor-parallel axis; the shared latent input never shards
        cands = sorted((i for i in cands if i != nd - 3),
                       key=lambda i: (i != nd - 2, -shape[i]))
    else:
        # canonical tensor-parallel dim first, then largest divisible dim
        cands.sort(key=lambda i: -shape[i])
        if "unembed" in name:
            cands = [nd - 1] + [i for i in cands if i != nd - 1]
        elif "embed" in name:           # embed / pos_embed: vocab-dim first
            cands = [0] + [i for i in cands if i != 0]
    skip_last = ("attn" in name and attn_fallback == "replicate")
    for i in cands:
        if skip_last and i == nd - 1:
            continue
        if fits(i, model):
            s[i] = "model"
            break
    return tuple(s)


def param_pspecs(params, mesh):
    """PSpec tree for a params tree (structure-preserving)."""
    msize = mesh.shape.get("model", 1)
    esize = mesh.shape.get("expert", 1)
    model = msize if "model" in mesh.axis_names else 1
    expert = esize if "expert" in mesh.axis_names else 1
    from ..train.tree import leaves_with_paths, unflatten
    return unflatten(params, [
        PSpec(mesh, partition_dims(_path_str(path), leaf.shape, model=model,
                                   expert=expert))
        for path, leaf in leaves_with_paths(params)])


def distribute(tree, specs):
    """Each leaf of ``tree`` as a DTensor placed by the matching PSpec of
    ``specs``. Every rank holds the same whole leaf (a seeded init, a
    checkpoint), so each keeps its own shard of it and nothing is sent;
    meta leaves give meta shards."""
    from torch.distributed.tensor import distribute_tensor
    from ..train.tree import leaves_with_paths, unflatten
    flat_s = [s for _, s in leaves_with_paths(specs)]
    out = []
    for (_, leaf), sp in zip(leaves_with_paths(tree), flat_s):
        out.append(distribute_tensor(leaf, sp.mesh.device_mesh,
                                     sp.placements, src_data_rank=None))
    return unflatten(tree, out)

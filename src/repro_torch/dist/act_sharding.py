"""Activation-sharding constraints over logical axis names
(``repro.dist.act_sharding``).

Model code names the axes of an activation ("batch", "heads", "embed",
"act_seq") instead of mesh dims; the mapping to the dims of a
``torch.distributed.device_mesh.DeviceMesh`` is resolved here, against the
mesh of the active :func:`activation_rules` context.  Outside a context
every :func:`constrain` call returns its tensor itself, so the same model
code runs unsharded on one device and under a mesh without change.

Inside a context a ``DTensor`` is redistributed to the resolved
placements.  The port's meshed steps (``launch.steps``) run the model on
each rank's local tensors, so their activations are plain tensors and
pass through :func:`constrain`.  They run every family tensor parallel
(``lm.tp_view``): each weight is read as this rank's shard
(:func:`tp_local`), the residual stream is sharded on ``embed`` as the
reference constrains it, and the model gathers an activation over
``model`` where a whole row is needed (:func:`gather_model`: the norms'
rows and weights, attention's k and v and its merged heads, the FFN's and
the experts' hidden units, the SSM's channels, RWKV's heads).  A product
of this rank's channels with a replicated weight is a partial sum
(:func:`sum_partials`), the SSM's ``in_proj`` columns are re-paired by one
all-to-all (:func:`pair_halves`), and a term every rank computes whole
(the MoE aux loss) counts once in the gradient (:func:`share_model`).  The
helpers read a tensor's width against the whole one, so the same model
code runs unsharded.

The gradient of a whole activation on a rank is partial over ``model``
(each rank's share of it: the sum over the ranks is the gradient), and
that of a rank's piece is its own; the helpers' backwards keep to that.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import torch

# The active mesh for constraint resolution (None: constraints are no-ops).
_ACTIVE_MESH = None

# Data-parallel axes in priority order; "model" is the tensor axis.
_DP_AXES = ("pod", "data")


def axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of a torch ``DeviceMesh`` (``mesh_dim_names``) or of
    any mesh-like object with ``axis_names`` (a stand-in with a shape)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size for a torch ``DeviceMesh`` or a stand-in whose
    ``shape`` maps names to sizes."""
    names = axis_names(mesh)
    shape = mesh.shape
    if isinstance(shape, dict) or hasattr(shape, "items"):
        return {a: int(shape[a]) for a in names}
    return dict(zip(names, (int(n) for n in shape)))


@contextlib.contextmanager
def activation_rules(mesh):
    """Enable activation constraints for ``mesh`` inside the context."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes present in ``mesh``, in order."""
    names = axis_names(mesh)
    return tuple(a for a in _DP_AXES if a in names)


def _resolve(name, mesh):
    """Logical axis name -> mesh axis, a tuple of axes, or None (the
    reference's table)."""
    if name is None:
        return None
    names = axis_names(mesh)
    if name in ("batch", "act_batch"):
        axes = dp_axes(mesh)
        return axes if axes else None
    if name in ("heads", "embed", "model"):
        return "model" if "model" in names else None
    if name == "act_seq":
        return None  # sequence stays unsharded (no sequence parallelism yet)
    return name if name in names else None


def placements(mesh, spec) -> List:
    """``Shard``/``Replicate`` placements, one a mesh dim, for a tensor
    whose dims carry the mesh-axis entries of ``spec`` (each ``None``, an
    axis name or a tuple of them; the first dim naming an axis claims
    it)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None and isinstance(out[names.index(a)], Replicate):
                out[names.index(a)] = Shard(dim)
    return out


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """``x`` itself outside a context or when it is not a ``DTensor``;
    else ``x`` redistributed to the placements of the logical ``axes``."""
    from torch.distributed.tensor import DTensor
    if _ACTIVE_MESH is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, placements(
        mesh, [_resolve(a, mesh) for a in axes]))


def gathered(t: torch.Tensor) -> torch.Tensor:
    """A weight as the meshed steps compute with it: a ``DTensor`` is
    all-gathered into a whole local tensor whose gradient is partial over
    the data-parallel axes (each rank's batch slice gives its part) and
    the same on every rank of ``model``; any other tensor as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    dp = dp_axes(mesh)
    whole = t.redistribute(mesh, [Replicate()] * mesh.ndim)
    return whole.to_local(grad_placements=[
        Partial() if a in dp else Replicate() for a in axis_names(mesh)])


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a ``DTensor`` (a collective: every rank of its
    mesh calls it); any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def local(t):
    """This rank's shard of a ``DTensor``; any other value as it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


# ---------------------------------------------------------------------------
# tensor parallelism over ``model``: shards, gathers and vocabulary reductions
# ---------------------------------------------------------------------------

# bytes of the tensor-parallel collectives by purpose while :func:`traffic`
# records (None: not recording)
_TRAFFIC: Optional[Dict[str, int]] = None


@contextlib.contextmanager
def traffic():
    """Record, inside the context, the output bytes of every collective
    the tensor-parallel helpers issue, by ``"<what> <kind>"`` (``"ffn
    all-gather"``, ``"ffn reduce-scatter"``, ``"head all-to-all"``, ...):
    the dry run's breakdown of its collectives."""
    global _TRAFFIC
    prev, _TRAFFIC = _TRAFFIC, {}
    try:
        yield _TRAFFIC
    finally:
        _TRAFFIC = prev


def _note(what: str, kind: str, t: torch.Tensor) -> torch.Tensor:
    if _TRAFFIC is not None:
        key = f"{what} {kind}"
        _TRAFFIC[key] = _TRAFFIC.get(key, 0) + t.numel() * t.element_size()
    return t

def tp_local(t: torch.Tensor) -> torch.Tensor:
    """A parameter as the tensor-parallel design computes with it: a
    ``DTensor``'s local shard, its gradient partial over the data-parallel
    axes and, over ``model``, the shard's own (a ``Shard``) or partial (a
    replicated leaf: each rank of ``model`` computes the replicated part of
    a layer on its own heads, columns or vocabulary); any other tensor as
    it is."""
    from torch.distributed.tensor import DTensor, Partial
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    dp = dp_axes(mesh)
    return t.to_local(grad_placements=[
        Partial() if a in dp or not pl.is_shard() else pl
        for a, pl in zip(axis_names(mesh), t.placements)])


def model_group():
    """(process group, size, rank) of the active mesh's ``model`` axis;
    (None, 1, 0) outside the rules or on a mesh without one."""
    mesh = _ACTIVE_MESH
    if mesh is None or "model" not in axis_names(mesh):
        return None, 1, 0
    size = axis_sizes(mesh)["model"]
    if size == 1:
        return None, 1, 0
    return mesh.get_group("model"), size, mesh.get_local_rank("model")


def chunk(n: int) -> Tuple[int, int]:
    """(start, size) of this rank's piece of ``n`` entries split over
    ``model`` as ``torch.chunk`` (and so ``DTensor``'s ``Shard``) splits
    them: pieces of ``ceil(n / size)``, the last short, trailing ranks
    possibly empty."""
    _, size, rank = model_group()
    c = -(-n // size)
    start = min(rank * c, n)
    return start, min(c, n - start)


def _chunk_width(n: int) -> int:
    return -(-n // model_group()[1])


def _eager_gather(group, t: torch.Tensor) -> bool:
    """Whether an all-gather on ``group`` takes the eager c10d call: gloo
    with CUDA tensors (two ranks sharing one card).  PyTorch 2.11's
    functional all-gather ends the process with a segmentation fault there
    (its eager call, its reduce-scatter and its all-to-all do not)."""
    import torch.distributed as dist
    return t.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _all_gather0(t: torch.Tensor, group, size: int) -> torch.Tensor:
    """``[c, ...]`` from each rank -> ``[size * c, ...]`` in rank order."""
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol
    t = t.contiguous()
    if _eager_gather(group, t):
        out = t.new_empty((size * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=group)
        return out
    return funcol.wait_tensor(funcol.all_gather_tensor(t, 0, group))


def _reduce_scatter0(t: torch.Tensor, group) -> torch.Tensor:
    """``[size * c, ...]`` summed over the ranks, this rank's ``[c, ...]``."""
    from torch.distributed import _functional_collectives as funcol
    return funcol.wait_tensor(funcol.reduce_scatter_tensor(
        t.contiguous(), "sum", 0, group))


def _all_to_all0(t: torch.Tensor, group, out_sizes=None,
                 in_sizes=None) -> torch.Tensor:
    """``[size, ...]``: piece ``s`` to rank ``s`` (with split sizes: rows
    ``in_sizes[s]`` of ``t`` to rank ``s``); returns the pieces each rank
    sent this one, in rank order (``out_sizes[r]`` rows from rank
    ``r``)."""
    from torch.distributed import _functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_to_all_single(
        t.contiguous(), out_sizes, in_sizes, group))


def _pad_last(t: torch.Tensor, width: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


class _GatherModel(torch.autograd.Function):
    """This rank's columns ``[..., k]`` of a ``[..., n]`` tensor -> the
    whole, all-gathered over ``model`` (each piece padded to the chunk
    width); the backward reduce-scatters the partial gradients of the
    whole and keeps this rank's columns."""

    @staticmethod
    def forward(ctx, x, n, what):
        group, size, _ = model_group()
        c = _chunk_width(n)
        ctx.k, ctx.group, ctx.width, ctx.what = x.shape[-1], group, \
            size * c, what
        whole = _all_gather0(_pad_last(x, c).movedim(-1, 0), group, size)
        return _note(what, "all-gather", whole).movedim(0, -1)[..., :n]

    @staticmethod
    def backward(ctx, g):
        g = _pad_last(g, ctx.width).movedim(-1, 0)
        mine = _note(ctx.what, "reduce-scatter",
                     _reduce_scatter0(g, ctx.group)).movedim(0, -1)
        return mine[..., :ctx.k], None, None


def gather_model(x: torch.Tensor, n: int, what: str,
                 dim: int = -1) -> torch.Tensor:
    """``x`` whole on its ``dim`` (the last by default) of ``n``: itself
    when it is whole already (a replicated weight's output, or no
    ``model`` axis), else its pieces all-gathered over ``model``
    (:func:`chunk`'s split).  Differentiable: the backward is a
    reduce-scatter.  ``what`` names the activation for :func:`traffic`."""
    if x.shape[dim] == n:
        return x
    if model_group()[0] is None or x.shape[dim] != chunk(n)[1]:
        raise ValueError(f"{x.shape[dim]} entries of dim {dim} are not this "
                         f"rank's piece of {n} over 'model'")
    if dim in (-1, x.dim() - 1):
        return _GatherModel.apply(x, n, what)
    return _GatherModel.apply(x.movedim(dim, -1), n, what).movedim(-1, dim)


def model_slice(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's :func:`chunk` of a whole tensor's ``dim`` (no
    communication; the gradient of the rest is 0 on this rank)."""
    start, size = chunk(x.shape[dim])
    return x.narrow(dim, start, size)


def own_piece(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """This rank's piece of ``x``'s ``dim`` of ``n``: :func:`model_slice`
    of a whole one, ``x`` itself when it holds the piece already (a
    sharded leaf read by ``tp_local``)."""
    return model_slice(x, dim) if x.shape[dim] == n else x


class _ColumnsToRows(torch.autograd.Function):
    """This rank's columns ``[N, k]`` of an ``[N, C]`` table -> its rows
    ``[N / size, C]``: one all-to-all over ``model`` (``Shard(1)`` to
    ``Shard(0)``); the backward is the reverse all-to-all."""

    @staticmethod
    def forward(ctx, t, n_cols):
        group, size, _ = model_group()
        c = _chunk_width(n_cols)
        rows = t.shape[0] // size
        ctx.k, ctx.group, ctx.size, ctx.c = t.shape[1], group, size, c
        pieces = _note("head", "all-to-all", _all_to_all0(
            _pad_last(t, c).reshape(size, rows, c), group))
        return pieces.permute(1, 0, 2).reshape(rows, size * c)[:, :n_cols]

    @staticmethod
    def backward(ctx, g):
        size, c, rows = ctx.size, ctx.c, g.shape[0]
        g = _pad_last(g, size * c).reshape(rows, size, c)
        pieces = _note("head", "all-to-all",
                       _all_to_all0(g.permute(1, 0, 2), ctx.group))
        return pieces.reshape(size * rows, c)[:, :ctx.k], None


def rows_from_columns(t: torch.Tensor, n_cols: int) -> torch.Tensor:
    """This rank's rows of a table whose columns (``n_cols`` whole) are
    split over ``model`` (the tied embedding ``[Vp, D]``, placed
    ``Shard(1)``, read as the head's vocabulary shard); a whole table's
    rows are sliced.  The rows must split evenly."""
    _, size, _ = model_group()
    if t.shape[0] % size:
        raise ValueError(f"{t.shape[0]} rows do not split over {size} ranks "
                         "of 'model'")
    if t.shape[1] == n_cols:
        return model_slice(t, 0)
    return _ColumnsToRows.apply(t, n_cols)


class _SumModel(torch.autograd.Function):
    """The sum over ``model`` of each rank's term; every rank's term gets
    the sum's gradient as it is (the sum is the same on every rank)."""

    @staticmethod
    def forward(ctx, x):
        from torch.distributed import _functional_collectives as funcol
        return _note("vocab", "all-reduce", funcol.wait_tensor(
            funcol.all_reduce(x.contiguous(), "sum", model_group()[0])))

    @staticmethod
    def backward(ctx, g):
        return g


def sum_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over ``model`` (itself without a ``model`` axis)."""
    return x if model_group()[0] is None else _SumModel.apply(x)


def max_model(x: torch.Tensor) -> torch.Tensor:
    """``x``'s elementwise maximum over ``model``, outside the graph (a
    softmax's shift)."""
    from torch.distributed import _functional_collectives as funcol
    group = model_group()[0]
    x = x.detach()
    if group is None:
        return x
    return _note("vocab", "all-reduce", funcol.wait_tensor(
        funcol.all_reduce(x.contiguous(), "max", group)))


def vocab_start(padded_vocab: int, width: int) -> Optional[int]:
    """The first vocabulary column of a head or logits ``width`` wide:
    None when it is the whole ``padded_vocab``, else this rank's
    :func:`chunk` start."""
    if width == padded_vocab:
        return None
    start, size = chunk(padded_vocab)
    if size != width:
        raise ValueError(f"{width} vocabulary columns are not this rank's "
                         f"piece of {padded_vocab}")
    return start


class _SumPartials(torch.autograd.Function):
    """Each rank's partial sum -> their sum over ``model``, whole on every
    rank; the backward sums the ranks' partial gradients of the whole, the
    gradient of every rank's term."""

    @staticmethod
    def forward(ctx, x, what):
        from torch.distributed import _functional_collectives as funcol
        ctx.what = what
        return _note(what, "all-reduce", funcol.wait_tensor(
            funcol.all_reduce(x.contiguous(), "sum", model_group()[0])))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol
        return _note(ctx.what, "all-reduce", funcol.wait_tensor(
            funcol.all_reduce(g.contiguous(), "sum", model_group()[0]))), None


def sum_partials(x: torch.Tensor, what: str) -> torch.Tensor:
    """The sum over ``model`` of each rank's partial sum ``x`` (a product
    of this rank's channels with their rows of a replicated weight), whole
    on every rank; ``x`` itself without a ``model`` axis."""
    return x if model_group()[0] is None else _SumPartials.apply(x, what)


class _ShareModel(torch.autograd.Function):
    """``x`` as it is; its gradient divided over the ranks of ``model``."""

    @staticmethod
    def forward(ctx, x):
        ctx.size = model_group()[1]
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size


def share_model(x: torch.Tensor) -> torch.Tensor:
    """A term every rank of ``model`` computes whole from whole inputs (the
    MoE aux loss): its value, with each rank's gradient its share, so that
    the gradients summed over ``model`` count it once."""
    return x if model_group()[0] is None else _ShareModel.apply(x)


def _pair_splits(n: int, src: int) -> List[Tuple[int, int, int, int]]:
    """For each rank ``s`` of ``model``: where in rank ``src``'s columns
    of ``[A | B]`` (``2 n`` wide, :func:`chunk`'s split) rank ``s``'s
    channels of A start and how many ``src`` holds, and the same for B."""
    _, size, _ = model_group()
    c, c2 = -(-n // size), -(-2 * n // size)
    lo = min(src * c2, 2 * n)
    hi = min(lo + c2, 2 * n)
    out = []
    for s in range(size):
        a0, a1 = min(s * c, n), min(s * c + c, n)
        piece = []
        for base in (0, n):
            start, stop = max(lo, base + a0), min(hi, base + a1)
            piece += [start - lo, max(stop - start, 0)]
        out.append(tuple(piece))
    return out


class _PairHalves(torch.autograd.Function):
    """This rank's columns of ``[A | B]`` -> its channels of A and of B:
    one all-to-all over ``model`` (each rank sends each other the columns
    it holds of that rank's channels); the backward is the reverse one."""

    @staticmethod
    def forward(ctx, t, n, what):
        group, size, rank = model_group()
        sends = _pair_splits(n, rank)
        recvs = [_pair_splits(n, r)[rank] for r in range(size)]
        ctx.group, ctx.what, ctx.width = group, what, t.shape[-1]
        ctx.sends, ctx.recvs = sends, recvs
        src = t.movedim(-1, 0)
        got = _note(what, "all-to-all", _all_to_all0(
            torch.cat([src[o:o + k] for sa, ka, sb, kb in sends
                       for o, k in ((sa, ka), (sb, kb))]),
            group, [ka + kb for _, ka, _, kb in recvs],
            [ka + kb for _, ka, _, kb in sends]))
        pieces = torch.split(got, [ka + kb for _, ka, _, kb in recvs])
        a = torch.cat([x[:ka] for x, (_, ka, _, _) in zip(pieces, recvs)])
        b = torch.cat([x[ka:] for x, (_, ka, _, _) in zip(pieces, recvs)])
        return a.movedim(0, -1), b.movedim(0, -1)

    @staticmethod
    def backward(ctx, ga, gb):
        ka = [k for _, k, _, _ in ctx.recvs]
        kb = [k for _, _, _, k in ctx.recvs]
        send = [g for pa, pb in zip(torch.split(ga.movedim(-1, 0), ka),
                                    torch.split(gb.movedim(-1, 0), kb))
                for g in (pa, pb)]
        got = _note(ctx.what, "all-to-all", _all_to_all0(
            torch.cat(send), ctx.group,
            [a + b for _, a, _, b in ctx.sends],
            [a + b for a, b in zip(ka, kb)]))
        grad = got.new_zeros((ctx.width,) + tuple(got.shape[1:]))
        for (sa, na, sb, nb), x in zip(ctx.sends, torch.split(
                got, [a + b for _, a, _, b in ctx.sends])):
            grad[sa:sa + na] = x[:na]
            grad[sb:sb + nb] = x[na:]
        return grad.movedim(0, -1), None, None


def pair_halves(t: torch.Tensor, n: int, what: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``t [..., 2n]`` (``[A | B]``, the SSM's ``xs | z``) as (A, B) on
    this rank's channels: halved when whole (every channel, as on one
    device), else, when ``t`` holds this rank's :func:`chunk` of the
    ``2n`` columns, re-paired by one all-to-all (the chunks of ``2n`` do
    not follow those of ``n``: at 2 ranks rank 0 holds all of A)."""
    if t.shape[-1] == 2 * n:
        a, b = torch.chunk(t, 2, dim=-1)
        return a, b
    if model_group()[0] is None or t.shape[-1] != chunk(2 * n)[1]:
        raise ValueError(f"a [..., {t.shape[-1]}] tensor is not this rank's "
                         f"piece of {2 * n} columns over 'model'")
    return _PairHalves.apply(t, n, what)

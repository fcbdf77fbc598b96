"""Pipeline parallelism (``repro.dist.pipeline``): the GPipe microbatch
schedule over one mesh axis, written out by hand.

:func:`make_pipelined_fn` splits a stack of identical layers over
``n_stages`` ranks of a mesh axis and streams microbatches through them:
stage ``s`` runs microbatch ``m`` at tick ``m + s``, and the schedule takes
``M + n_stages - 1`` ticks for ``M`` microbatches (the classic bubble).
Each tick every stage runs its ``layers_per_stage`` layers on what it
holds (stage 0 a fresh microbatch, the others what came over the wire),
then one ``batch_isend_irecv`` passes the activations round the ring to
the right neighbour (the reference's ``ppermute``).  The last stage keeps
its finished microbatches; a closing all-reduce of every stage's masked
output (the reference's ``psum``) gives all ranks the result.  The
reference's tick order, not ``torch.distributed.pipelining``'s schedules.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.dist import act_sharding


def make_pipelined_fn(layer_fn: Callable[[torch.Tensor, torch.Tensor],
                                         torch.Tensor], mesh, *,
                      axis_name: str, n_stages: int, layers_per_stage: int):
    """Build ``fn(ws, xs) -> ys``.

    ``ws``: this stage's layer weights ``[layers_per_stage, ...]`` (the
    stage's rows of the stacked ``[n_stages * layers_per_stage, ...]``
    weights; a ``DTensor`` sharded over ``axis_name`` gives its local
    rows); ``xs``: ``[n_micro, ...]`` microbatches, the same on every rank;
    ``ys``: ``[n_micro, ...]`` after all layers, on every rank.
    ``fn.ticks`` is the number of ticks the last call ran."""
    if act_sharding.axis_sizes(mesh)[axis_name] != n_stages:
        raise ValueError(f"axis {axis_name!r} holds "
                         f"{act_sharding.axis_sizes(mesh)[axis_name]} ranks, "
                         f"not {n_stages} stages")
    group = mesh.get_group(axis_name)
    s = mesh.get_local_rank(axis_name)
    right = dist.get_global_rank(group, (s + 1) % n_stages)
    left = dist.get_global_rank(group, (s - 1) % n_stages)

    def fn(ws: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
        from torch.distributed.tensor import DTensor
        if isinstance(ws, DTensor):
            ws = ws.to_local()
        if ws.shape[0] != layers_per_stage:
            raise ValueError(f"{ws.shape[0]} layers on stage {s}, not "
                             f"{layers_per_stage}")
        n_micro = xs.shape[0]
        out = torch.zeros_like(xs)
        recv = torch.zeros_like(xs[0])
        fn.ticks = 0
        for t in range(n_micro + n_stages - 1):
            fn.ticks += 1
            # stage 0 reads a fresh microbatch; later stages read the wire
            h = xs[min(t, n_micro - 1)] if s == 0 else recv
            for i in range(layers_per_stage):
                h = layer_fn(ws[i], h)
            m_last = t - (n_stages - 1)
            if s == n_stages - 1 and 0 <= m_last < n_micro:
                out[m_last] = h
            if n_stages == 1:
                continue
            h = h.contiguous()
            recv = torch.empty_like(h)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, h, right, group),
                    dist.P2POp(dist.irecv, recv, left, group)]):
                req.wait()
        # only the last stage holds results; an all-reduce gives them all
        if s != n_stages - 1:
            out.zero_()
        dist.all_reduce(out, group=group)
        return out

    fn.ticks = 0
    return fn

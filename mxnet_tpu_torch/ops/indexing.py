"""Indexing ops of the port (``mxnet_tpu/ops/indexing.py``, every name it
registers): ``Embedding``, ``take``, ``batch_take``, ``one_hot``,
``choose_element_0index`` and ``fill_element_0index``.

Ids arrive as floats and are truncated to integers.  Where the JAX op
indexes with them unclipped, an id outside the axis behaves as a JAX
gather or scatter does: a negative id counts from the end, a gather
clamps to the axis (and passes no gradient back for that id, as JAX's
transpose drops it: :func:`jax_gather`) and a scatter drops the update.
No op reads an id on the host."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import numeric_dtype, parse_attr
from .registry import register


def _embedding_params(attrs, *in_shapes):
    inp = int(parse_attr(attrs["input_dim"]))
    out = int(parse_attr(attrs["output_dim"]))
    return {"weight": (inp, out)}


@register("Embedding", arg_names=("data", "weight"),
          infer_params=_embedding_params)
def _embedding(ctx, data, weight, **attrs):
    """``data`` holds float ids (MXNet's convention), truncated to
    integers and clipped to the table; output ``data.shape +
    (output_dim,)``."""
    idx = data.long().clamp(0, weight.shape[0] - 1)
    from ..parallel import mesh as _mesh

    if _mesh.is_dtensor(weight):
        return _embedding_placed(idx, weight)
    return F.embedding(idx, weight)


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's reduce from a tensor-parallel region: the forward sums
    the ranks' partial values over ``group``, the backward passes the
    (replicated) gradient through as it is."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as td

        out = x.clone()
        td.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _embedding_placed(idx, weight):
    """Embedding over DTensors (a mesh).  A table split on its rows (the
    vocab, ``megatron_rules``' ``tok_embed``) over one mesh axis is
    Megatron's vocab-parallel embedding: each rank gathers the ids in its
    block of rows (zeros for the others) and the partial rows are summed
    over that axis; the gradient of each block stays local.  Any other
    placement takes DTensor's own gather."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..parallel import mesh as _mesh

    mesh = weight.device_mesh
    split = [i for i, p in enumerate(weight.placements)
             if isinstance(p, Shard) and p.dim == 0]
    rows = weight.shape[0]
    if len(split) != 1 or rows % mesh.size(split[0]):
        return F.embedding(idx, weight)
    axis = split[0]
    block = rows // mesh.size(axis)
    lo = mesh.get_local_rank(axis) * block
    group = mesh.get_group(axis)
    # the ids keep their batch split; every rank of the vocab axis sees
    # all of them
    id_place = tuple(p if i != axis and isinstance(p, Shard) else Replicate()
                     for i, p in enumerate(idx.placements))
    idx = idx.redistribute(mesh, id_place)
    out_place = tuple(Replicate() if i == axis else p
                      for i, p in enumerate(id_place))

    def run(ids, w):
        local = ids - lo
        mine = (local >= 0) & (local < block)
        rows_ = F.embedding(local.clamp(0, block - 1), w)
        return _ReduceFromGroup.apply(
            rows_ * mine.unsqueeze(-1).to(rows_.dtype), group)

    # each rank's gradient of its block covers only its own rows of the
    # batch: partial over the axes that split the ids
    w_grad = tuple(Partial() if isinstance(p, Shard) else w
                   for p, w in zip(id_place, weight.placements))
    return _mesh.local_map(run, out_placements=(out_place,),
                           in_placements=(id_place, weight.placements),
                           in_grad_placements=(id_place, w_grad),
                           device_mesh=mesh)(idx, weight)


@register("one_hot", aliases=("_onehot_encode",))
def _one_hot(ctx, data, **attrs):
    """``data`` holds float ids, truncated to integers; ids outside
    ``[0, depth)`` give a row of ``off_value`` (as ``jax.nn.one_hot``).
    Output ``data.shape + (depth,)`` in ``dtype`` (float32 default)."""
    depth = int(parse_attr(attrs["depth"]))
    on = float(parse_attr(attrs.get("on_value", 1.0)))
    off = float(parse_attr(attrs.get("off_value", 0.0)))
    dtype = numeric_dtype(attrs.get("dtype", "float32"))
    idx = data.to(torch.int32)
    classes = torch.arange(depth, dtype=torch.int32, device=data.device)
    hot = idx.unsqueeze(-1) == classes
    on, off = (torch.full((), v, dtype=dtype, device=data.device)
               for v in (on, off))
    return torch.where(hot, on, off)


def _normalize(idx, n):
    """Integer ids as JAX indexing reads them: negatives count from the
    end."""
    return torch.where(idx < 0, idx + n, idx)


def jax_gather(values, valid):
    """Gathered ``values`` whose gradient reaches the source only where
    ``valid`` (broadcast over ``values``): a JAX gather clamps an
    out-of-range id in the forward but its transpose drops that id."""
    while valid.ndim < values.ndim:
        valid = valid.unsqueeze(-1)
    return torch.where(valid, values, values.detach())


@register("take", arg_names=("a", "indices"))
def _take(ctx, a, indices, **attrs):
    """Rows of ``a`` (axis 0) at ``indices``, clipped to the axis."""
    idx = indices.long().clamp(0, a.shape[0] - 1)
    return a[idx]


def _pick(lhs, rhs):
    """``lhs[i, rhs[i]]`` per row, the column clamped as a JAX gather
    clamps it."""
    n = lhs.shape[1]
    idx = _normalize(rhs.long().reshape(-1), n)
    out = lhs.gather(1, idx.clamp(0, n - 1)[:, None])[:, 0]
    return jax_gather(out, (idx >= 0) & (idx < n))


@register("batch_take", arg_names=("a", "indices"))
def _batch_take(ctx, a, indices, **attrs):
    """``a[i, indices[i]]`` per row."""
    return _pick(a, indices)


@register("choose_element_0index", arg_names=("lhs", "rhs"))
def _choose_element_0index(ctx, lhs, rhs, **attrs):
    """The NDArray function: ``lhs[i, rhs[i]]`` per row."""
    return _pick(lhs, rhs)


@register("fill_element_0index", arg_names=("lhs", "mhs", "rhs"))
def _fill_element_0index(ctx, lhs, mhs, rhs, **attrs):
    """The NDArray function: a copy of ``lhs`` with ``lhs[i, rhs[i]] =
    mhs[i]``; a row whose column lies outside the axis is left as it
    is."""
    n = lhs.shape[1]
    idx = _normalize(rhs.long().reshape(-1), n)
    hit = idx[:, None] == torch.arange(n, device=lhs.device)
    return torch.where(hit, mhs.reshape(-1, 1).to(lhs.dtype), lhs)

"""Expert parallelism — the mixture-of-experts FFN with all-to-all
dispatch (mirrors ``mxnet_tpu/parallel/moe.py``).

Experts live on an ``expert`` mesh axis, one expert per rank; tokens are
sharded over the same axis ([tokens/world, d_model] per rank), routed by
a learned gate, and two ``all_to_all_single`` exchanges carry each token
to its expert's rank and back — the Switch-Transformer layout.

Design (top-k routing, dense dispatch; k=1 = Switch, k=2 = the
GShard/Mixtral configuration), as in the reference:
- gate probabilities pick each token's top-k experts (a stable
  descending sort: ties go to the lower expert, as ``lax.top_k``);
  tokens scatter into an [n_experts, capacity, d_model] buffer with
  capacity slots claimed choice-major — rank-0 picks never lose a slot
  to a runner-up — in integer bookkeeping, and over-capacity choices
  drop, like Switch;
- the all-to-all swaps the expert axis with the rank axis so each rank
  holds ITS expert's tokens from every peer, runs the expert FFN as
  batched products, and the inverse all-to-all + combine weights bring
  the results home.

Everything is differentiable: gates get gradients through the combine
weights, experts through their products, and the all-to-all's backward
is the inverse exchange.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import mesh as _mesh

__all__ = ["init_moe_params", "moe_ffn"]


def init_moe_params(rng, d_model, d_hidden, n_experts, scale=0.02,
                    device=None):
    """Gate and expert weights drawn from ``rng`` (a ``torch.Generator``,
    on ``device``'s type; default the card), normal with std ``scale``."""
    from ..context import resolve_device

    device = resolve_device(device)

    def normal(*shape):
        return torch.randn(shape, generator=rng, device=device) * scale

    return {"gate_w": normal(d_model, n_experts),
            "w_in": normal(n_experts, d_model, d_hidden),
            "w_out": normal(n_experts, d_hidden, d_model)}


def _local(value, sharding):
    """This rank's block of ``value`` under ``sharding``: a DTensor's
    local block (redistributed first if placed otherwise), or a
    differentiable slice of a full tensor every rank holds."""
    if _mesh.is_dtensor(value):
        if tuple(value.placements) != sharding.placements:
            value = value.redistribute(sharding.mesh.device_mesh,
                                       sharding.placements)
        return value.to_local()
    return _mesh.narrow_local(value, sharding)


def _promoted(*ts):
    """The operands in their common dtype, by the promotion rules the
    JAX package's products follow (bf16 with fp32 computes in fp32)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _top_k(probs, k):
    """``lax.top_k`` along the last dim: the k largest, ties to the lower
    index (a stable descending sort; ``torch.topk`` promises no order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(probs, top_k_, cap, dtype):
    """The reference's routing of one rank's tokens: (top_e ``[nt, k]``,
    pos ``[nt, k]`` slot positions as int32, keep ``[nt, k]``, dispatch
    and combine ``[nt, E, cap]`` in ``dtype``).  Slots are claimed
    choice-major; positions stay integer through the cumsum (in bf16 a
    cumsum over >256 same-expert tokens loses exactness and two tokens
    share a slot)."""
    nt, n_exp = probs.shape
    top_p, top_e = _top_k(probs, top_k_)
    if top_k_ == 1:
        gates = top_p  # Switch: the raw gate prob scales the output
    else:
        # GShard/Mixtral: renormalize over the chosen experts
        gates = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    disp = torch.zeros((nt, n_exp, cap), dtype=dtype, device=probs.device)
    # the gate weighs in its own dtype where it is wider (JAX's promotion)
    combine = torch.zeros_like(disp, dtype=torch.promote_types(
        dtype, gates.dtype))
    counts = torch.zeros((n_exp,), dtype=torch.int32, device=probs.device)
    positions, keeps = [], []
    for j in range(top_k_):
        e_j = top_e[:, j]
        onehot_i = F.one_hot(e_j, n_exp).to(torch.int32)
        before = torch.cumsum(onehot_i, dim=0, dtype=torch.int32) - onehot_i
        pos = before.gather(1, e_j[:, None])[:, 0] + counts[e_j]
        keep = pos < cap
        # one_hot of a slot past capacity is a zero row (jax.nn.one_hot):
        # clamp the index and let keep zero it
        sel = (F.one_hot(e_j, n_exp).to(dtype)[:, :, None]
               * F.one_hot(pos.clamp(max=cap - 1).long(), cap)
               .to(dtype)[:, None, :]
               * keep.to(dtype)[:, None, None])
        disp = disp + sel
        combine = combine + sel * gates[:, j][:, None, None]
        counts = counts + onehot_i.sum(0, dtype=torch.int32)
        positions.append(pos)
        keeps.append(keep)
    return (top_e, torch.stack(positions, 1), torch.stack(keeps, 1), disp,
            combine)


def moe_ffn(params, x, mesh, axis_name: str = "expert",
            capacity_factor: float = 1.25, activation=F.relu,
            top_k: int = 1):
    """Apply the expert-parallel FFN.

    x: [tokens, d_model] sharded over `axis_name` on dim 0 (a DTensor, or
    a full tensor every rank holds, of which each keeps its block).
    params: gate_w [d, E] replicated; w_in [E, d, h] / w_out [E, h, d]
    sharded over `axis_name` on dim 0 (one expert slice per rank; E ==
    axis size).  top_k: experts per token — 1 = Switch routing, 2 = the
    GShard/Mixtral configuration (each choice gets its own capacity slot;
    the outputs combine weighted by the renormalized gate probabilities).
    Returns (y, aux_loss): y a DTensor [tokens, d_model] placed as x,
    aux_loss the load-balancing loss averaged over the axis (a scalar
    every rank holds), to be added to the task loss.

    Gradients: the all-to-all and the average over the axis carry their
    adjoints (the cotangents of every rank summed), so the objective is
    the sum over ranks of what each backpropagates.  For the gradient of
    a mean over all tokens, each rank backpropagates its share (its
    tokens' mean over the ranks' count) and the replicated parameters'
    gradients are summed over the axis, as data parallelism does.
    """
    from torch.distributed.nn.functional import all_reduce, all_to_all_single

    n_exp = mesh.shape[axis_name]
    if not 1 <= top_k <= n_exp:
        raise ValueError(f"top_k must be in [1, {n_exp}], got {top_k}")
    tok = _mesh.NamedSharding(mesh, (axis_name, None))
    exp = _mesh.NamedSharding(mesh, (axis_name, None, None))
    gate_w = params["gate_w"]
    if _mesh.is_dtensor(gate_w):
        gate_w = _local(gate_w, _mesh.replicated(mesh))
    xs = _local(x, tok)
    w1, w2 = _local(params["w_in"], exp)[0], _local(params["w_out"], exp)[0]
    group = mesh.get_group(axis_name)

    nt = xs.shape[0]  # local tokens
    cap = max(1, int(capacity_factor * top_k * nt / n_exp))
    logits = torch.matmul(*_promoted(xs, gate_w))          # [nt, E]
    probs = torch.softmax(logits, dim=-1)
    top_e, _, _, disp, combine = route(probs, top_k, cap, xs.dtype)
    buf = torch.einsum("tec,td->ecd", disp, xs)  # [E, cap, d]

    # expert axis <-> rank axis: after this, dim 0 indexes the PEER rank
    # the tokens came from, and every row belongs to MY expert
    if n_exp > 1:
        buf = all_to_all_single(torch.empty_like(buf), buf.contiguous(),
                                group=group)
    h = activation(torch.einsum("wcd,dh->wch", *_promoted(buf, w1)))
    y = torch.einsum("wch,hd->wcd", *_promoted(h, w2))
    if n_exp > 1:
        y = all_to_all_single(torch.empty_like(y), y.contiguous(),
                              group=group)   # home again

    # combine: weight by the gate, scatter to tokens
    out = torch.einsum("tec,ecd->td", *_promoted(combine, y))

    # load-balancing loss: E * sum_e f_e * P_e over rank-0 routing
    onehot0 = F.one_hot(top_e[:, 0], n_exp).float()
    frac = onehot0.mean(0)                    # fraction routed per expert
    prob_mean = probs.float().mean(0)
    aux = n_exp * (frac * prob_mean).sum()
    if n_exp > 1:
        aux = all_reduce(aux, group=group) / n_exp
    y_out = _mesh.from_block(out, mesh.device_mesh, tok.placements,
                             (nt * n_exp,) + tuple(out.shape[1:]))
    return y_out, aux.to(xs.dtype)

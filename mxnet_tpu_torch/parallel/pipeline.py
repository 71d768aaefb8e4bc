"""Pipeline parallelism over a mesh axis (mirrors
``mxnet_tpu/parallel/pipeline.py``).

Stages live on the ``pipe`` axis of a :class:`~.mesh.Mesh`, one stage
per rank: each rank runs its own stage function on its own block of the
stacked parameters, and activations hop between neighbouring stages
through :func:`~.dist.exchange` (one ``all_to_all_single`` with uneven
splits, which NCCL and gloo both carry).  Where the reference runs the
schedule as one ``lax.scan`` of an SPMD program, the port runs the same
ticks as a Python loop in each rank, so a rank may skip the compute of a
slot that holds no microbatch; every rank still makes the same exchange
each tick, in the same order.

- :func:`pipeline_apply` / :func:`pipeline_apply_tree`: the GPipe
  schedule (bubble ``(S-1)/(S-1+M)``, :func:`bubble_fraction`),
  differentiable through autograd.  The backward runs the ticks in
  reverse, each stage recomputing nothing (the GPipe memory profile:
  every tick's activations stay) unless ``remat=True``, which wraps each
  stage call in ``torch.utils.checkpoint``.
- :func:`make_pipeline_train_step`: the lockstep 1F1B step of T = M +
  2S - 1 ticks; tick t runs the forward of microbatch t - s and the
  backward of microbatch t + s - (2S - 1) on stage s, the backward
  recomputing its stage from a stash of boundary inputs (at most 2S + 1
  deep), so activation memory is O(S) microbatches, flat in M.

Shapes and placement, as in the reference: stage parameters are stacked
on a leading stage axis and placed ``Shard(0)`` over ``pipe``
(:func:`shard_stacked`, :func:`union_stack`); microbatched inputs are
``[n_micro, micro_batch, ...]``.  Heterogeneous stages (per-stage trees,
shape-changing boundaries) embed their trees in one union keyed by the
reference's path strings (``"['blocks']['q_w']"``) and pass activations
through a flat ``[mb, F]`` boundary buffer padded to the widest edge.

Gradients follow the reference's reading of its collectives: outputs are
summed over ``pipe`` and replicated, every rank computes the same loss
from them and calls backward, and the sum's gradient is that one loss's
(not the ranks' count of it); a replicated input's gradient is summed
over the stages that used it.  Every rank of the axis must run the
backward, since it exchanges cotangents each tick.  With ``data_axis``
each rank holds its block of the batch, and parameter gradients are
averaged over the data axis (the gradient of the mean over the whole
batch, when each rank backpropagates the mean over its block).
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from . import dist as _dist
from . import mesh as _mesh

__all__ = ["stack_stage_params", "shard_stacked", "bubble_fraction",
           "bubble_fraction_1f1b", "stacked_blocks_stage", "pipeline_apply",
           "microbatch", "UnionMeta", "union_stack", "union_unstack",
           "pipeline_apply_tree", "make_pipeline_train_step"]


def stack_stage_params(per_stage_params):
    """[{name: tensor}, ...] -> {name: tensor stacked on dim 0} (all
    stages must share parameter structure — the usual 'repeated block'
    layout)."""
    names = per_stage_params[0].keys()
    return {n: torch.stack([p[n] for p in per_stage_params]) for n in names}


def _pipe_sharding(mesh, ndim, axis_name):
    return _mesh.NamedSharding(mesh, (axis_name,) + (None,) * (ndim - 1))


def shard_stacked(mesh, stacked, axis_name: str = "pipe"):
    """Place each stage's parameter slice on its pipeline rank: DTensors
    placed ``Shard(0)`` over ``axis_name``, each rank keeping a copy of
    its own slice only (no transfer: every rank holds the full value)."""
    out = {}
    for n, v in stacked.items():
        sh = _pipe_sharding(mesh, v.ndim, axis_name)
        if _mesh.is_dtensor(v):
            out[n] = v.redistribute(mesh.device_mesh, sh.placements)
            continue
        full = _mesh._as_tensor(v, mesh.device)
        out[n] = _mesh.from_block(_mesh.narrow_local(full, sh).clone(),
                                  mesh.device_mesh, sh.placements, full.shape)
    return out


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """Idle fraction of the GPipe forward (`pipeline_apply`):
    (S-1)/(S-1+M) — each stage does M useful ticks out of M+S-1."""
    return (n_stages - 1) / (n_stages - 1 + n_micro)


def bubble_fraction_1f1b(n_stages: int, n_micro: int) -> float:
    """Idle fraction of the LOCKSTEP 1F1B train step
    (`make_pipeline_train_step`): (2S-1)/(M+2S-1).

    Each of the M+2S-1 ticks has one forward and one backward slot on
    every stage, of which a stage fills M each — so the fill/drain is
    ~2x the classic asynchronous 1F1B's (S-1)/(M+S-1).  Amortize with
    M >> S, which the O(S) activation stash makes affordable."""
    return (2 * n_stages - 1) / (n_micro + 2 * n_stages - 1)


def stacked_blocks_stage(block_fn):
    """Build a stage_fn running `blocks_per_stage` identical blocks.

    block_fn(block_params, x) -> y.  The per-stage parameter slice
    carries a leading block axis on every leaf ({name: [B, ...]}); the
    blocks run one after another.  With stack_stage_params the full tree
    is {name: [n_stages, B, ...]} — L = n_stages*B total blocks, the
    standard "repeated trunk" pipeline layout.
    """

    def stage_fn(params, x, stage):
        n = next(iter(params.values())).shape[0]
        for i in range(n):
            x = block_fn({k: v[i] for k, v in params.items()}, x)
        return x

    return stage_fn


def microbatch(x, n_micro):
    """[batch, ...] -> [n_micro, batch/n_micro, ...]."""
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} not divisible by {n_micro}")
    return x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))


# ---------------------------------------------------------------- trees
def _tree_paths(tree):
    """Pytree -> (ordered path-key list, {path: leaf}, treespec); the
    keys are the reference's ``keystr`` strings."""
    leaves, spec = pytree.tree_flatten_with_path(tree)
    keys = [pytree.keystr(p) for p, _ in leaves]
    return keys, dict(zip(keys, (v for _, v in leaves))), spec


class UnionMeta:
    """Bookkeeping for per-stage trees embedded in one stacked union."""

    def __init__(self, per_stage_params):
        self.n_stages = len(per_stage_params)
        self.stage_keys = []   # per stage: ordered leaf path keys
        self.stage_defs = []   # per stage: treespec
        self.union = {}        # path -> (shape, dtype)
        for tree in per_stage_params:
            keys, leaves, spec = _tree_paths(tree)
            self.stage_keys.append(keys)
            self.stage_defs.append(spec)
            for k in keys:
                sig = (tuple(leaves[k].shape), leaves[k].dtype)
                if k in self.union and self.union[k] != sig:
                    raise ValueError(
                        f"leaf {k!r} has shape/dtype {sig} on one stage but "
                        f"{self.union[k]} on another; same-named leaves must "
                        "match across stages (rename stage-specific layers)")
                self.union[k] = sig

    def stage_tree(self, stage, union_slice):
        """{path: leaf} union slice -> stage's own pytree."""
        return pytree.tree_unflatten(
            [union_slice[k] for k in self.stage_keys[stage]],
            self.stage_defs[stage])

    def embed_grads(self, stage, grads_tree, like):
        """Stage's grad pytree -> union-slice dict (zeros elsewhere)."""
        out = {k: torch.zeros_like(v) for k, v in like.items()}
        for k, g in zip(self.stage_keys[stage], pytree.tree_leaves(grads_tree)):
            out[k] = g.to(like[k].dtype)
        return out


def union_stack(per_stage_params, mesh=None, axis_name="pipe"):
    """Per-stage trees -> ({path: [S, ...] stacked tensor}, UnionMeta).

    Leaves absent from a stage are zero-filled at that stage's index.
    With ``mesh`` the result is DTensors placed ``Shard(0)`` over the
    pipe axis, each rank holding only its own stage's slice (the others
    are never stacked)."""
    meta = UnionMeta(per_stage_params)
    stage_leaves = [_tree_paths(tree)[1] for tree in per_stage_params]
    if mesh is None:
        return {k: torch.stack([
            leaves[k] if k in leaves else torch.zeros(
                shape, dtype=dtype, device=_first_device(stage_leaves))
            for leaves in stage_leaves])
            for k, (shape, dtype) in meta.union.items()}, meta
    stage = mesh.coordinate(axis_name)
    mine = stage_leaves[stage]
    stacked = {}
    for k, (shape, dtype) in meta.union.items():
        sh = _pipe_sharding(mesh, len(shape) + 1, axis_name)
        local = (_mesh._as_tensor(mine[k], mesh.device).clone() if k in mine
                 else torch.zeros(shape, dtype=dtype, device=mesh.device))
        stacked[k] = _mesh.from_block(local[None], mesh.device_mesh,
                                      sh.placements,
                                      (meta.n_stages,) + shape)
    return stacked, meta


def _first_device(stage_leaves):
    for leaves in stage_leaves:
        for v in leaves.values():
            return v.device
    return None


def union_unstack(stacked, meta):
    """Stacked union -> list of per-stage pytrees (host-side interop).
    DTensors are gathered first: a collective every rank of their mesh
    calls (gloo cannot gather CUDA tensors: on ranks sharing a card,
    read each rank's own block instead)."""
    full = {k: _mesh.full_value(v) for k, v in stacked.items()}
    return [meta.stage_tree(s, {k: v[s] for k, v in full.items()})
            for s in range(meta.n_stages)]


# ------------------------------------------------------- the rank's view
def _stage_block(v, mesh, axis_name):
    """This rank's stage slice of a stacked leaf, differentiably: a
    DTensor's local block, or the stage's row of a full tensor."""
    if _mesh.is_dtensor(v):
        return v.to_local()[0]
    return v[mesh.coordinate(axis_name)]


def _batch_block(x, mesh, data_axis, dim=1):
    """This rank's block of the batch dim ``dim`` over ``data_axis`` (the
    whole of it without one): a DTensor's local block, or a slice of a
    full tensor."""
    if _mesh.is_dtensor(x):
        return x.to_local()
    x = torch.as_tensor(x)
    if not data_axis:
        return x
    n = mesh.shape[data_axis]
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.coordinate(data_axis) * size, size)


def _flat_len(shape) -> int:
    n = 1
    for d in shape[1:]:
        n *= int(d)
    return n


def _flatpad(y, F):
    flat = y.reshape(y.shape[0], -1)
    return torch.nn.functional.pad(flat, (0, F - flat.shape[1]))


def _unflat(buf, like):
    return buf[:, :_flat_len(like.shape)].reshape(like.shape).to(like.dtype)


def _boundary_chain(stage_fns, meta, xs_local):
    """Run the stage chain on meta tensors; returns (in, out) meta tensors
    per stage under LOCAL (per-rank) batch shapes."""
    in_m, out_m = [], []
    cur = xs_local
    for s, fn in enumerate(stage_fns):
        params = meta.stage_tree(s, {
            k: torch.empty(shape, dtype=dtype, device="meta")
            for k, (shape, dtype) in meta.union.items()})
        in_m.append(cur)
        with torch.no_grad():
            cur = fn(params, cur)
        out_m.append(cur)
    return in_m, out_m


def _boundary_setup(stage_fns, meta, xs_shape, xs_dtype, S, dp):
    """Abstract-eval the stage chain under local batch shapes and size
    the flat boundary buffer.  Returns (in, out, F, bdt): per-stage in /
    out meta tensors, the padded per-sample boundary width and the
    buffer dtype."""
    xs_local = torch.empty((xs_shape[1] // dp,) + tuple(xs_shape[2:]),
                           dtype=xs_dtype, device="meta")
    in_m, out_m = _boundary_chain(stage_fns, meta, xs_local)
    bdtypes = {o.dtype for o in out_m[:-1]}
    if len(bdtypes) > 1:
        raise ValueError(f"boundary activations mix dtypes {bdtypes}")
    F = max((_flat_len(o.shape) for o in out_m[:-1]), default=1)
    bdt = out_m[0].dtype if S > 1 else torch.float32
    return in_m, out_m, F, bdt


class _Stage:
    """One rank's view of a pipeline: its boundary shapes and the hops to
    its neighbours on the pipe axis (and, for GPipe, ``call(leaves, x)``
    running its stage, and whether to keep each tick's graph)."""

    def __init__(self, mesh, axis_name, data_axis, M, in_m, out_m, F, bdt,
                 raw_input=False, call=None, keep=False):
        self.call, self.keep, self.M = call, keep, M
        self.S = mesh.shape[axis_name]
        self.stage = mesh.coordinate(axis_name)
        self.group = mesh.get_group(axis_name) if self.S > 1 else None
        self.dgroup = (mesh.get_group(data_axis)
                       if data_axis and mesh.shape[data_axis] > 1 else None)
        self.dp = mesh.shape[data_axis] if data_axis else 1
        self.in_m, self.out_m, self.F, self.bdt = in_m, out_m, F, bdt
        # stage 0 takes the microbatch itself, not the boundary buffer
        self.raw_input = raw_input
        self.first = self.stage == 0
        self.last = self.stage == self.S - 1

    def active(self, t):
        """Whether this stage holds a microbatch at tick ``t`` of a GPipe
        schedule."""
        return 0 <= t - self.stage < self.M

    def hop(self, like, send_next=None, recv_prev=False, send_prev=None,
            recv_next=False):
        """One exchange with the neighbouring stages: ``send_next`` goes
        to stage s+1, ``send_prev`` to s-1; returns what came from s-1
        and from s+1 (``[mb, F]`` buffers, or None)."""
        s = self.stage
        sends, recvs = {}, {}
        shape = (like.shape[0], self.F)
        if send_next is not None:
            sends[s + 1] = send_next
        if send_prev is not None:
            sends[s - 1] = send_prev
        if recv_prev:
            recvs[s - 1] = shape
        if recv_next:
            recvs[s + 1] = shape
        got = _dist.exchange(self.group, sends, recvs, like)
        return got.get(s - 1), got.get(s + 1)

    def stage_input(self, x0, buf):
        return x0 if self.raw_input else _unflat(buf, self.in_m[self.stage])


def _leaves(params):
    """Detached leaves of the stage's parameters that autograd may
    differentiate (floating ones)."""
    return {k: v.detach().requires_grad_(v.is_floating_point())
            for k, v in params.items()}


def _grad_inputs(leaves, x):
    items = [v for v in leaves.values() if v.requires_grad]
    if x is not None and x.requires_grad:
        items.append(x)
    return items


def _vjp(out, leaves, x, seed):
    """Gradients of ``out`` (seeded by ``seed``) to the leaves that
    require grad, then to ``x`` where it does; None where ``out`` does
    not depend on one.  A stage whose output depends on nothing to
    differentiate (a first stage without parameters) gets all None."""
    inputs = _grad_inputs(leaves, x)
    if not out.requires_grad:
        return [None] * len(inputs)
    return torch.autograd.grad(out, inputs, seed, allow_unused=True)


# ---------------------------------------------------------------- GPipe
class _GPipe(torch.autograd.Function):
    """The GPipe schedule of one rank as one autograd node: the forward
    runs the ticks, keeping each tick's local graph (or, under remat,
    its checkpoint); the backward runs them in reverse, exchanging
    cotangents with the neighbouring stages each tick."""

    @staticmethod
    def forward(ctx, st, keys, xs, *params):
        leaves = dict(zip(keys, params))
        if st.keep:
            leaves = _leaves(leaves)
        like = torch.empty(0, dtype=st.bdt, device=xs.device)
        mb = xs.shape[1]
        T = st.M + st.S - 1
        ticks = {}
        y_m = st.out_m[-1]
        outs = torch.zeros((st.M,) + tuple(y_m.shape), dtype=y_m.dtype,
                           device=xs.device)
        buf = None
        for t in range(T):
            m = t - st.stage
            flat = None
            if st.active(t):
                x = st.stage_input(xs[m], buf).detach()
                if st.keep and x.is_floating_point() and (
                        not st.first or xs.requires_grad):
                    x.requires_grad_(True)
                with torch.set_grad_enabled(st.keep):
                    y = st.call(leaves, x)
                if st.keep:
                    ticks[m] = (x, y)
                if st.last:
                    outs[m] = y.detach()
                else:
                    flat = _flatpad(y.detach(), st.F).to(st.bdt)
            if t < T - 1 and st.S > 1:
                buf, _ = st.hop(
                    like.new_empty(mb, 0),
                    send_next=flat if (not st.last and st.active(t)) else None,
                    recv_prev=not st.first and st.active(t + 1))
        if st.S > 1:
            torch.distributed.all_reduce(outs, group=st.group)
        ctx.st, ctx.keys, ctx.leaves, ctx.ticks = st, keys, leaves, ticks
        ctx.xs_meta = (xs.shape, xs.dtype, xs.device)
        return outs

    @staticmethod
    def backward(ctx, g):
        st, leaves, ticks = ctx.st, ctx.leaves, ctx.ticks
        shape, dtype, device = ctx.xs_meta
        like = torch.empty(0, dtype=st.bdt, device=device)
        T = st.M + st.S - 1
        acc = {k: None for k in leaves}
        want_dxs = ctx.needs_input_grad[2]
        dxs = torch.zeros(shape, dtype=dtype, device=device) if want_dxs \
            else None
        dx_flat = None   # cotangent of the input of tick t + 1
        for t in reversed(range(T)):
            dflat = None
            if t < T - 1 and st.S > 1:
                _, dflat = st.hop(
                    like.new_empty(shape[1], 0),
                    send_prev=dx_flat if (not st.first and st.active(t + 1))
                    else None,
                    recv_next=not st.last and st.active(t))
            dx_flat = None
            if not st.active(t):
                continue
            m = t - st.stage
            x, y = ticks.pop(m)
            dy = g[m] if st.last else _unflat(dflat, st.out_m[st.stage])
            grads = _vjp(y, leaves, x, dy)
            for k, d in zip([k for k, v in leaves.items() if v.requires_grad],
                            grads):
                if d is not None:
                    acc[k] = d if acc[k] is None else acc[k] + d
            dx = grads[-1] if x.requires_grad else None
            if dx is None:
                dx = torch.zeros_like(x, dtype=st.bdt)
            if not st.first:
                dx_flat = _flatpad(dx, st.F).to(st.bdt)
            elif want_dxs:
                dxs[m] = dx
        if want_dxs and st.S > 1:
            # the replicated input's cotangent: stage 0's, summed over pipe
            torch.distributed.all_reduce(dxs, group=st.group)
        out = []
        for k, v in leaves.items():
            if not v.requires_grad:
                out.append(None)
                continue
            d = torch.zeros_like(v) if acc[k] is None else acc[k]
            if st.dgroup is not None:
                torch.distributed.all_reduce(d, group=st.dgroup)
                d = d / st.dp
            out.append(d)
        return (None, None, dxs, *out)


def _gpipe(fn, params, xs, mesh, axis_name, data_axis, in_m, out_m, F, bdt,
           raw_input, remat, tree_of=None):
    """Run ``fn`` (this rank's stage) in the GPipe schedule; the tick
    graphs are kept only where a backward may come (grad mode on and an
    input that requires grad).  ``params`` holds every stage's leaves
    (this rank's blocks of them), so the ranks agree on it: every one
    runs the backward and its exchanges, also a stage whose own leaves
    are none."""
    tree_of = tree_of or (lambda leaves: leaves)

    def call(leaves, x):
        if not remat:
            return fn(tree_of(leaves), x)
        keys = list(leaves)

        def run(x, *vals):
            return fn(tree_of(dict(zip(keys, vals))), x)

        return torch.utils.checkpoint.checkpoint(
            run, x, *leaves.values(), use_reentrant=False)

    keep = torch.is_grad_enabled() and (xs.requires_grad or any(
        v.requires_grad for v in params.values()))
    st = _Stage(mesh, axis_name, data_axis, xs.shape[0], in_m, out_m, F,
                bdt, raw_input, call, keep)
    return _GPipe.apply(st, list(params), xs, *params.values())


def pipeline_apply(stage_fn, stacked_params, micro_inputs, mesh,
                   axis_name: str = "pipe", remat: bool = False):
    """Run the GPipe schedule; returns [n_micro, ...] last-stage outputs,
    replicated on every rank of the pipe axis.

    stage_fn(params_slice, x, stage_index) -> y; every stage maps the
    same activation shape to itself (classic equal-width pipeline).
    ``stage_index`` is this rank's stage, a Python int.  remat=True
    recomputes stage activations in backward (1F1B's memory profile;
    module docstring).  ``stacked_params`` are DTensors placed
    ``Shard(0)`` over the axis (:func:`shard_stacked`) or full tensors
    every rank holds; ``micro_inputs`` a full tensor every rank holds.
    """
    stage = mesh.coordinate(axis_name)
    params = {n: _stage_block(v, mesh, axis_name)
              for n, v in stacked_params.items()}
    xs = torch.as_tensor(micro_inputs)
    act = torch.empty(xs.shape[1:], dtype=xs.dtype, device="meta")
    n = mesh.shape[axis_name]
    return _gpipe(lambda p, x: stage_fn(p, x, stage), params, xs, mesh,
                  axis_name, None, [act] * n, [act] * n,
                  _flat_len(act.shape), xs.dtype, stage == 0, remat)


def pipeline_apply_tree(stage_fns, stacked, meta, micro_inputs, mesh,
                        axis_name: str = "pipe", data_axis=None):
    """Forward GPipe pass with per-stage trees + shape-changing stages.

    Returns [n_micro, mb, ...] last-stage outputs, replicated over the
    pipe axis (with ``data_axis``: this rank's block of the batch).
    Differentiable: grads of a loss on the result flow back through the
    reversed ticks with the GPipe (all-forward-then-all-backward) memory
    profile; use `make_pipeline_train_step` for the O(S)-memory 1F1B
    schedule.
    """
    S = mesh.shape[axis_name]
    if len(stage_fns) != S:
        raise ValueError(f"{len(stage_fns)} stage fns for {S}-way pipe axis")
    dp = mesh.shape[data_axis] if data_axis else 1
    xs = torch.as_tensor(micro_inputs) if not _mesh.is_dtensor(
        micro_inputs) else micro_inputs
    in_m, out_m, F, bdt = _boundary_setup(stage_fns, meta, xs.shape,
                                          xs.dtype, S, dp)
    stage = mesh.coordinate(axis_name)
    # every leaf of the union, also those of other stages: the ranks then
    # agree on whether a backward comes, and each gives each DTensor leaf
    # its block's gradient (zeros where its stage lacks the leaf), as the
    # reference's zero-filled union does
    mine = {k: _stage_block(v, mesh, axis_name) for k, v in stacked.items()}
    return _gpipe(stage_fns[stage], mine,
                  _batch_block(xs, mesh, data_axis), mesh, axis_name,
                  data_axis, in_m, out_m, F, bdt, stage == 0, False,
                  tree_of=lambda leaves: meta.stage_tree(stage, leaves))


# ------------------------------------------------------------------ 1F1B
def make_pipeline_train_step(stage_fns, loss_fn, meta, mesh,
                             axis_name: str = "pipe", data_axis=None):
    """Build the 1F1B train step.

    stage_fns[i](params_i, x) -> y; loss_fn(y_last, labels) -> scalar
    (mean over its microbatch).  Returns step(stacked, xs, labels) ->
    (loss, grads): ``loss`` a scalar tensor every rank holds, ``grads`` a
    stacked union dict of DTensors placed like the params (stage s's
    grads in stage s's block; zeros for leaves a stage doesn't own) —
    feed it straight to a sharded update, or `union_unstack` it.

    Schedule: tick t runs fwd(microbatch t-s) and bwd(microbatch
    t+s-(2S-1)) on stage s; boundary inputs are stashed (at most 2S+1
    deep) and each backward recomputes its stage under autograd — O(S)
    activation memory, (2S-1)/(M+2S-1) lockstep bubble
    (`bubble_fraction_1f1b`), one extra stage forward per microbatch.
    The last stage's forward slot only stashes its input: its loss comes
    from the backward's recompute one tick later (the same values, one
    forward fewer).  Each tick ends in one exchange that carries the
    forward activation to s+1 and the input cotangent to s-1.
    """
    S = mesh.shape[axis_name]
    if len(stage_fns) != S:
        raise ValueError(f"{len(stage_fns)} stage fns for {S}-way pipe axis")
    dp = mesh.shape[data_axis] if data_axis else 1
    D = 2 * S + 1  # stash depth: max fwd->bwd gap is 2(S-1)+1 ticks

    def step(stacked, xs, labels):
        xs_l = _batch_block(xs, mesh, data_axis)
        labels_l = _batch_block(labels, mesh, data_axis)
        M = xs_l.shape[0]
        T = M + 2 * S - 1
        xs_shape = (M, xs_l.shape[1] * dp) + tuple(xs_l.shape[2:])
        in_m, out_m, F, bdt = _boundary_setup(stage_fns, meta, xs_shape,
                                              xs_l.dtype, S, dp)
        st = _Stage(mesh, axis_name, data_axis, M, in_m, out_m, F, bdt)
        s = st.stage
        fn = stage_fns[s]
        sl = {k: _stage_block(v, mesh, axis_name).detach()
              for k, v in stacked.items()}
        leaves = _leaves({k: sl[k] for k in meta.stage_keys[s]})
        tree = meta.stage_tree(s, leaves)
        grad_keys = [k for k, v in leaves.items() if v.requires_grad]
        gacc = {k: torch.zeros_like(v) for k, v in sl.items()}
        device = xs_l.device
        like = torch.empty(xs_l.shape[1], 0, dtype=bdt, device=device)
        loss_acc = torch.zeros((), dtype=torch.float32, device=device)
        scale = torch.full((), 1.0 / M, dtype=torch.float32, device=device)
        buf_in = dy_in = None
        stash = {}
        for t in range(T):
            # ---- forward slot: microbatch t - s
            fm = t - s
            flat_out = None
            if 0 <= fm < M:
                if not st.first:
                    stash[fm] = buf_in
                if not st.last:
                    x = xs_l[fm] if st.first else _unflat(buf_in, in_m[s])
                    with torch.no_grad():
                        flat_out = _flatpad(fn(tree, x), F).to(bdt)
            assert len(stash) <= D
            # ---- backward slot: microbatch t + s - (2S-1)
            bm = t + s - (2 * S - 1)
            dx_out = None
            if 0 <= bm < M:
                x = (xs_l[bm] if st.first
                     else _unflat(stash.pop(bm), in_m[s]))
                if not st.first and x.is_floating_point():
                    x.requires_grad_(True)
                with torch.enable_grad():
                    y = fn(tree, x)
                    if st.last:
                        out = loss_fn(y, labels_l[bm])
                        loss_acc = loss_acc + out.detach().float()
                        seed = scale.to(out.dtype)
                    else:
                        out, seed = y, _unflat(dy_in, out_m[s])
                grads = _vjp(out, leaves, x, seed)
                for k, d in zip(grad_keys, grads):
                    if d is not None:
                        gacc[k] += d.to(gacc[k].dtype)
                if not st.first:
                    dx = grads[-1] if x.requires_grad else None
                    dx_out = _flatpad(torch.zeros_like(x) if dx is None
                                      else dx, F).to(bdt)
            # ---- one exchange: activations on, cotangents back
            if t < T - 1 and S > 1:
                # a rank receives an activation when its next forward
                # slot holds a microbatch, a cotangent when its next
                # backward slot does: exactly the slots its neighbours
                # filled this tick
                nxt_f = 0 <= t + 1 - s < M
                nxt_b = 0 <= t + 1 + s - (2 * S - 1) < M
                buf_in, dy_in = st.hop(
                    like,
                    send_next=flat_out if (not st.last and 0 <= fm < M)
                    else None,
                    recv_prev=not st.first and nxt_f,
                    send_prev=dx_out if (not st.first and 0 <= bm < M)
                    else None,
                    recv_next=not st.last and nxt_b)
        loss = loss_acc
        if S > 1:
            torch.distributed.all_reduce(loss, group=st.group)
        loss = loss / M
        if st.dgroup is not None:
            torch.distributed.all_reduce(loss, group=st.dgroup)
            loss = loss / dp
            for v in gacc.values():
                torch.distributed.all_reduce(v, group=st.dgroup)
                v.div_(dp)
        grads = {}
        for k, v in gacc.items():
            sh = _pipe_sharding(mesh, v.ndim + 1, axis_name)
            grads[k] = _mesh.from_block(v[None], mesh.device_mesh,
                                        sh.placements, (S,) + tuple(v.shape))
        return loss, grads

    return step

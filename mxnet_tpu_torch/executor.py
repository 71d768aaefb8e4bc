"""The graph interpreter and the Executor of the port
(``mxnet_tpu/executor.py``).

:func:`_build_graph_fn` turns a Symbol into ``f(args, aux, gen,
is_train) -> (outputs, new_aux)``, which evaluates the nodes eagerly in
topological order; ``torch.autograd`` records the graph for the
backward (the trainer's path).

:func:`simple_bind` / :func:`bind` / :class:`Executor` bind a symbol:
the graph passes run at bind (``passes.apply_graph_passes``, as the JAX
executor runs them), and the JAX executor's channels-last (NHWC) layout
pass becomes torch's ``channels_last`` memory format: every 4-D
argument (the image input, the conv weights) is allocated channels-last
once at bind, tensors stay logical NCHW, and cuDNN keeps the
activations channels-last through conv, BN, ReLU, pooling and the adds,
which is what lets the residual-epilogue kernel view them as ``(N*H*W,
C)``.  ``MXTPU_CONV_LAYOUT=NCHW`` keeps every tensor contiguous
(NCHW memory), as it turns the JAX pass off.

Training (the reference's fused fwd+bwd, ``_make_fwdbwd``):
``forward(is_train=True)`` runs the graph under ``torch.autograd`` with
the arguments whose ``grad_req`` is not ``null`` as leaves, writes the
aux states back and keeps the outputs readable; ``backward(out_grads)``
differentiates that graph once — the head gradient is ones when none is
given (the loss ops ignore it), a caller's head takes the output's dtype
— and writes each gradient into its bound buffer (``write``) or adds it
there (``add``).  Under AMP loss scaling (``MXTPU_LOSS_SCALE`` with
``MXTPU_AMP``, decided at bind) each gradient is multiplied by the
scaler's device scale first, in the gradient's dtype.  The graph is
freed by the backward, so a second ``backward`` needs a new
``forward``.

Profiling (``mx.profiler``): while the profiler runs, an inference
forward is a ``forward[<symbol name>]`` span and a training forward
with its backward one ``forward_backward[<symbol name>]`` span, each
closed after a device sync, as the JAX executor's; while it is off
neither records nor syncs.

Monitoring (``set_monitor_callback``, parity:
GraphExecutor::SetMonitorCallback): after each inference forward and
each backward (a training step taps once, as the JAX executor) the
internal outputs of the symbol (``get_internals``, without the passes)
are evaluated in inference mode and handed to the callback by name.  A
callback that is a bound method of an object with an ``activated`` flag
(``monitor.Monitor.stat_helper``) is tapped only while the flag is set.

Row-sparse gradients (``Variable(grad_stype="row_sparse")`` on an
Embedding weight, :func:`mxnet_tpu_torch.sparse.rs_plan`): ``simple_bind``
gives such a weight a :class:`~mxnet_tpu_torch.sparse.RowSparseNDArray`
holder instead of a table-sized buffer (unless ``MXTPU_SPARSE_UPDATE=0``).
The training forward adds a zero "probe" of one row a lookup to the
gathered rows, so the probe's gradient is the per-lookup row gradient
and no dense scatter into the table is made; the backward coalesces it
(``sparse.coalesce_rows``) and rebinds the holder to the ``(indices,
values)`` pair.

The program cache (the reference's ``MXTPU_PROGRAM_CACHE``, default 64
entries, ``0``/``off`` disables, ``N`` sets the capacity): a bind runs
the graph passes, then looks up the post-pass symbol and its graph
function by the post-pass :meth:`~.symbol.Symbol.structural_signature`,
the device, the layout and the autotuner's ``fingerprint()`` (a new
schedule winner re-keys the programs bound before it), so a rebind of an
equal graph reuses both; hits and misses count in
``executor_graph_cache_total``.  A captured
CUDA graph is tied to the buffers it was captured on, so it stays with
the trainer that captured it and is never cached across binds.

Health and perf planes: a bind records the executor's memory row
(``telemetry.health.record_program``, label ``name[signature]``); an
allocator failure in ``forward``/``backward`` re-raises as
``DeviceOOMError`` with the ranked memory report; under
``MXTPU_PERF_ATTR`` the first inference forward and the first training
forward + backward count their FLOPs into the label's cost row (the
training pair's row wins once training runs), and every dispatch adds
its host wall (a training forward's to its backward's).

Telemetry (``MXTPU_TELEMETRY``): each ``forward`` and ``backward`` is an
``executor_forward_seconds`` / ``executor_backward_seconds`` observation
of its dispatch.  The port compiles nothing, so ``executor_compile_total``
and ``executor_compile_seconds`` count what takes a compile's place: a
graph function's first forward (``fwd``, per mode) and first backward
(``fwdbwd``) at a bind's input signature, kept on the cached function,
so an equal graph bound again at the same shapes adds none; the fused
trainer's CUDA-graph captures (``fwdbwd``), the kvstore's bucket
programs (``kv_update``, ``kv_sparse``) and the decoders' first steps at
a shape (``decode_*``) count there too.

Bound arrays are tensors: ``arg_dict``/``grad_dict``/``aux_dict`` map
names to torch tensors on the bind device (``bind`` shares the storage
of the tensors or NDArrays it is given), and ``outputs`` are tensors.
Ctx-group placement (``group2ctx``, parity: PlaceDevice,
graph_executor.cc:225-314; the reference's ``placement_plan``,
``mxnet_tpu/executor.py:484``): each node of a graph annotated with
``AttrScope(ctx_group=...)`` runs on its group's torch device, a variable
lives with its own group or its first consumer's (:func:`placement_plan`),
and a value that crosses groups is copied there (:func:`_to_device`:
without a host wait onto a card, where the card's stream orders the copy
before its reader; a blocking copy onto the host, whose ops read it at
once), and autograd carries the gradients back.  One process drives
several cards for model parallelism natively.  Groups mapped to shardings
(the reference's ``PartitionSpec`` values) are refused (ROADMAP Queue 1
item 10b, slice 5).
"""
from __future__ import annotations

import os
import threading
import time
import warnings
import weakref
from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

from . import amp as _amp
from . import autotune as _autotune
from . import ops
from . import profiler as _prof
from . import random as _random
from . import sparse as _sparse
from . import telemetry as _tm
from .base import MXNetError, numeric_dtype
from .context import resolve_device
from .convert import _to_tensor
from .ndarray import NDArray
from .symbol import Symbol, _topo_order

__all__ = ["_build_graph_fn", "Executor", "simple_bind", "bind",
           "channels_last_default", "program_cache_capacity",
           "program_cache_clear", "program_cache_get", "program_cache_put"]

_GRAD_REQ = ("null", "write", "add")
_RS_PROBE = "__rs_probe__:"
_RS_IDX = "__rs_idx__:"

_TM_GRAPH_CACHE = _tm.counter(
    "executor_graph_cache_total",
    "program-cache lookups at bind (hit: an equal post-pass graph was "
    "bound before; miss: its graph function was built)",
    labels=("result",))
_TM_COMPILE = _tm.counter(
    "executor_compile_total",
    "what takes an XLA compile's place in the port, which compiles "
    "nothing: the first run of a program at an input signature (a graph "
    "function's forward or forward+backward, a kvstore bucket's update, "
    "a decode step or prefill at a shape) and each CUDA-graph capture "
    "of the fused step; flat after warm-up", labels=("kind",))
_TM_COMPILE_SEC = _tm.histogram(
    "executor_compile_seconds",
    "host wall of each executor_compile_total event: that first run's "
    "dispatch (cuDNN/cuBLAS plan choice and lazy kernel loads happen "
    "there) or the capture (seconds)", labels=("kind",))
_TM_FWD_SEC = _tm.histogram(
    "executor_forward_seconds",
    "Executor.forward wall time (dispatch; device-complete only under "
    "the profiler's sync mode); the port's Predictor.forward, which runs "
    "its executor's graph, counts here too")
_TM_BWD_SEC = _tm.histogram(
    "executor_backward_seconds", "Executor.backward wall time (dispatch)")
# in the port the gradient all-reduce and the sharded update's exchanges
# run in the collective kvstore's bucketed update (kvstore_fused)
_TM_COLLECTIVE = _tm.counter(
    "executor_collective_bytes_total",
    "logical payload bytes of mesh collectives the sharded paths "
    "request per dispatch (grad all-reduce, sharded-update param "
    "all-gather; estimate at dispatch, not wire bytes)", labels=("op",))

# program -> the (kind, signature) pairs it has run: a pair's first run
# is the port's "compile" (the JAX package's jit traces one per pair)
_first_runs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_first_runs_lock = threading.Lock()


def _compile_start(program, kind, sig=()):
    """``time.perf_counter()`` when this is ``program``'s first run of
    ``(kind, sig)`` and telemetry is on, else None.  The pair is marked
    run either way, as a jit cache fills whether or not it is counted."""
    with _first_runs_lock:
        seen = _first_runs.get(program)
        if seen is None:
            seen = _first_runs[program] = set()
        if (kind, sig) in seen:
            return None
        seen.add((kind, sig))
    return time.perf_counter() if _tm.enabled() else None


def _compile_done(t0, kind):
    """Count the event :func:`_compile_start` opened at ``t0`` (if any)."""
    if t0 is not None:
        _TM_COMPILE.inc(kind=kind)
        _TM_COMPILE_SEC.observe(time.perf_counter() - t0, kind=kind)


def _to_device(x, dev):
    """``x`` on ``dev``: a copy onto a card does not wait for the host
    (the card's stream runs it before the ops that read it); a copy onto
    the host blocks until the values are there, since the host's ops
    read the buffer as soon as they get it."""
    return x.to(dev, non_blocking=dev.type == "cuda")


def _eval_node(node, env, ctx, dev=None):
    """Evaluate one op node into ``env``; returns ``{aux_name: value}``.
    With ``dev`` (a placed graph), inputs from another device are copied
    there first."""
    od = ops.get(node.op)
    ins = [env[id(src)][oidx] for src, oidx in node.inputs]
    if dev is not None:
        ins = [_to_device(x, dev)
               if isinstance(x, torch.Tensor) and x.device != dev else x
               for x in ins]
    res = od.fn(ctx, *ins, **node.attrs)
    aux_updates = {}
    if od.aux_names:
        res, updates = res
        for (aux_node, _), val in zip(node.inputs[-len(od.aux_names):],
                                      updates):
            aux_updates[aux_node.name] = val
    env[id(node)] = res if isinstance(res, tuple) else (res,)
    return aux_updates


def _build_graph_fn(symbol: Symbol, device=None, node_devices=None):
    """``f(arg_vals, aux_vals, gen, is_train) -> (outputs, new_aux)``.

    ``arg_vals``/``aux_vals`` map variable names to tensors; ``gen`` is
    the ``torch.Generator`` random ops draw from (or None); ``device`` is
    handed to the ops through their :class:`~.ops.registry.OpCtx`.
    ``node_devices`` (``{id(node): device}``, a ctx-group placement) runs
    each op node on its device, its random ops drawing from that
    device's generator."""
    out_entries = list(symbol._outputs)
    topo = _topo_order([n for n, _ in out_entries])
    # row-sparse Embedding nodes: with a probe among the arguments the
    # gathered rows get the probe added (its gradient is the per-lookup
    # row gradient) and the looked-up ids go out through new_aux;
    # without one the node runs the Embedding op itself
    rs_nodes = {id(node): wname
                for wname, node in _sparse.rs_plan(symbol).items()}

    def fn(arg_vals: Dict, aux_vals: Dict, gen, is_train: bool):
        env = {}
        new_aux = dict(aux_vals)
        ctx = ops.OpCtx(is_train=is_train, device=device, generator=gen)
        ctxs = {}

        def placed(node):
            dev = node_devices.get(id(node), device)
            c = ctxs.get(dev)
            if c is None:
                c = ctxs[dev] = ctx if dev == device else ops.OpCtx(
                    is_train=is_train, device=dev,
                    generator=None if gen is None
                    else _random.generator(dev))
            return c, dev

        for node in topo:
            if node.is_variable:
                src = aux_vals if node.is_aux else arg_vals
                env[id(node)] = (src[node.name],)
                continue
            wname = rs_nodes.get(id(node))
            probe = None if wname is None else \
                arg_vals.get(_RS_PROBE + wname)
            if probe is not None:
                (dsrc, di), (wsrc, wi) = node.inputs
                data, w = env[id(dsrc)][di], env[id(wsrc)][wi]
                # the Embedding op's ids: truncated, clipped to the table
                idx = data.long().clamp(0, w.shape[0] - 1)
                rows = w.detach().index_select(0, idx.reshape(-1))
                out = (rows + probe.to(rows.dtype)).reshape(
                    tuple(idx.shape) + tuple(w.shape[1:]))
                env[id(node)] = (out,)
                new_aux[_RS_IDX + wname] = idx.reshape(-1)
                continue
            if node_devices is None:
                new_aux.update(_eval_node(node, env, ctx))
            else:
                new_aux.update(_eval_node(node, env, *placed(node)))
        return [env[id(n)][i] for n, i in out_entries], new_aux

    return fn


# ------------------------------------------------------ ctx-group placement
def _group_device(value):
    """A ``group2ctx`` value as a torch device, or None for a sharding
    (a ``parallel.mesh.NamedSharding``)."""
    from .parallel import mesh as _mesh

    if isinstance(value, _mesh.NamedSharding):
        return None
    return resolve_device(value)


def placement_plan(symbol: Symbol, group2ctx, default_device):
    """``(node_devices, var_devices, n_distinct)`` of a ctx-group
    annotated graph (the reference's ``placement_plan``): every op node's
    device by its ``ctx_group`` (the default device without one),
    ``{variable name: device}`` (a variable's own group wins, else its
    first consumer's) and the number of distinct devices in the plan.
    Groups no node is annotated with are ignored."""
    groups = {g: d for g, d in ((g, _group_device(v))
                                for g, v in (group2ctx or {}).items())
              if d is not None}
    default_device = resolve_device(default_device)
    topo = _topo_order([n for n, _ in symbol._outputs])
    node_dev, var_dev = {}, {}
    for node in topo:
        grp = node.extra_attrs.get("ctx_group")
        if node.is_variable and grp in groups:
            var_dev[node.name] = groups[grp]
    for node in topo:
        if node.is_variable:
            continue
        dev = groups.get(node.extra_attrs.get("ctx_group"), default_device)
        node_dev[id(node)] = dev
        for src, _ in node.inputs:
            if src.is_variable and src.name not in var_dev:
                var_dev[src.name] = dev  # the first consumer's
    distinct = set(node_dev.values()) | set(var_dev.values())
    return node_dev, var_dev, len(distinct)


_warned_unknown_groups = set()


def _check_group2ctx(symbol: Symbol, group2ctx):
    """Warn once per ``group2ctx`` entry that names a group no node is
    annotated with (it is ignored); refuse groups mapped to shardings."""
    annotated = {n.extra_attrs.get("ctx_group") for n in symbol.nodes
                 if n.extra_attrs.get("ctx_group")}
    for g, v in group2ctx.items():
        if _group_device(v) is None:
            raise _not_ported(f"group2ctx group {g!r} mapped to a sharding "
                              "(bind a mesh through FusedTrainer(mesh=))",
                              "10b, slice 5")
        if g not in annotated and g not in _warned_unknown_groups:
            _warned_unknown_groups.add(g)
            warnings.warn(
                f"group2ctx group {g!r} matches no ctx_group annotation "
                f"in the symbol (annotated groups: {sorted(annotated)}); "
                "the entry is ignored", stacklevel=3)


def channels_last_default() -> bool:
    """``MXTPU_CONV_LAYOUT`` (default NHWC): channels-last memory for the
    4-D arguments of a bind unless it says NCHW."""
    return os.environ.get("MXTPU_CONV_LAYOUT", "NHWC").upper() != "NCHW"


def _not_ported(what, item):
    return MXNetError(f"{what} is not ported yet (ROADMAP Queue 1 item "
                      f"{item})")


# ------------------------------------------------------------ program cache
_PROGRAM_CACHE_DEFAULT_CAPACITY = 64
_program_cache: "OrderedDict" = OrderedDict()
_program_cache_lock = threading.Lock()


def program_cache_capacity() -> int:
    """``MXTPU_PROGRAM_CACHE`` as a capacity (0: the cache is off)."""
    raw = os.environ.get("MXTPU_PROGRAM_CACHE", "").strip().lower()
    if raw in ("", "on", "true", "yes", "default"):
        return _PROGRAM_CACHE_DEFAULT_CAPACITY
    if raw in ("0", "off", "false", "no", "disable", "disabled"):
        return 0
    try:
        return max(int(raw), 0)
    except ValueError:
        return _PROGRAM_CACHE_DEFAULT_CAPACITY


def program_cache_clear():
    """Drop every cached entry."""
    with _program_cache_lock:
        _program_cache.clear()


def program_cache_get(key):
    """The entry under ``key`` (a hit moves it to the front and counts),
    or None when absent or when the cache is off."""
    if program_cache_capacity() <= 0:
        return None
    with _program_cache_lock:
        entry = _program_cache.get(key)
        if entry is not None:
            _program_cache.move_to_end(key)
    if entry is not None and _tm.enabled():
        _TM_GRAPH_CACHE.inc(result="hit")
    return entry


def program_cache_put(key, entry):
    """Insert an entry built after a miss (the miss counts), evicting
    the least recently used past the capacity."""
    if _tm.enabled():
        _TM_GRAPH_CACHE.inc(result="miss")
    capacity = program_cache_capacity()
    if capacity <= 0:
        return
    with _program_cache_lock:
        _program_cache[key] = entry
        _program_cache.move_to_end(key)
        while len(_program_cache) > capacity:
            _program_cache.popitem(last=False)


def _compiled_programs(symbol, device):
    """``(post-pass symbol, graph function)`` of ``symbol`` on
    ``device``, through the program cache.  The passes run first, so the
    key is the post-pass signature: graphs that rewrite to one structure
    share one entry."""
    from .passes import apply_graph_passes

    post = apply_graph_passes(symbol)
    key = (post.structural_signature(), str(device),
           channels_last_default(), _autotune.fingerprint())
    entry = program_cache_get(key)
    if entry is None:
        entry = (post, _build_graph_fn(post, device))
        program_cache_put(key, entry)
    return entry


def _as_list(names, given, what):
    """``given`` (a dict or a list in ``names`` order) as a dict."""
    if given is None:
        return {}
    if isinstance(given, dict):
        return dict(given)
    given = list(given)
    if len(given) != len(names):
        raise MXNetError(f"bind: expected {len(names)} {what} ({names}), "
                         f"got {len(given)}")
    return dict(zip(names, given))


def _req_dict(arg_names, grad_req):
    if isinstance(grad_req, str):
        req = {k: grad_req for k in arg_names}
    elif isinstance(grad_req, (list, tuple)):
        req = dict(zip(arg_names, grad_req))
    else:
        req = {k: grad_req.get(k, "null") for k in arg_names}
    for k, v in req.items():
        if v not in _GRAD_REQ:
            raise MXNetError(f"invalid grad_req {v} for {k}")
    return req


class Executor:
    """A bound symbol.

    ``arg_dict`` / ``aux_dict`` / ``grad_dict`` map names to the bound
    tensors on the bind device; :meth:`forward` runs the post-pass graph
    on them and keeps the outputs on the device (no host sync);
    :attr:`outputs` returns them; :meth:`backward` fills ``grad_dict``
    per ``grad_req``."""

    def __init__(self, symbol: Symbol, device, arg_dict, aux_dict,
                 grad_dict=None, grad_req="null", shared_exec=None,
                 group2ctx=None):
        self._symbol = symbol
        self._device = device
        self._group2ctx = dict(group2ctx or {})
        arg_names = symbol.list_arguments()
        missing = [k for k in arg_names if k not in arg_dict]
        if missing:
            raise MXNetError(f"bind: missing arguments {missing}")
        missing = [k for k in symbol.list_auxiliary_states()
                   if k not in aux_dict]
        if missing:
            raise MXNetError(f"bind: missing aux states {missing}")
        self.arg_dict = {k: arg_dict[k] for k in arg_names}
        self.aux_dict = dict(aux_dict)
        self.grad_dict = dict(grad_dict or {})
        self.grad_req = _req_dict(arg_names, grad_req)
        for k in arg_names:
            # an argument without a gradient buffer cannot be written
            if k not in self.grad_dict:
                self.grad_req[k] = "null"
        # row-sparse holders leave the autograd leaves: their gradient
        # comes from the probe of their Embedding node
        rs_holders = sorted(k for k, g in self.grad_dict.items()
                            if getattr(g, "stype", "default") == "row_sparse")
        self._grad_names = [k for k in arg_names
                            if self.grad_req[k] != "null"
                            and k not in rs_holders]
        # the graph passes run once, at bind (through the program cache);
        # they never rename or drop a variable, so the argument names
        # stay as bound
        if self._group2ctx:
            # a placed graph is keyed by its devices, not its structure:
            # no program cache (as the reference)
            from .passes import apply_graph_passes

            self._exec_symbol = apply_graph_passes(symbol)
            node_dev, _, _ = placement_plan(self._exec_symbol,
                                            self._group2ctx, device)
            self._graph_fn = _build_graph_fn(self._exec_symbol, device,
                                             node_dev)
            if _tm.enabled():
                _TM_GRAPH_CACHE.inc(result="miss")
        elif shared_exec is not None and shared_exec._symbol is symbol:
            self._exec_symbol = shared_exec._exec_symbol
            self._graph_fn = shared_exec._graph_fn
            if _tm.enabled():
                _TM_GRAPH_CACHE.inc(result="hit")
        else:
            self._exec_symbol, self._graph_fn = _compiled_programs(symbol,
                                                                   device)
        self._rs_specs = self._build_rs_specs(rs_holders) \
            if rs_holders else ()
        # AMP loss scaling is decided at bind; the scaler's state moves
        # to this bind's device once, here
        self._amp_scale = _amp.scaling_active()
        if self._amp_scale:
            _amp.global_scaler().place(device)
        self._outputs = None
        self._pending = None  # (outputs with their graph, grad leaves)
        # the profiler's spans (recorded only while it runs)
        self._fb_start = None  # the training forward's start
        name = symbol.name or "graph"
        self._spans = (f"forward[{name}]", f"forward_backward[{name}]")
        self._sync = _prof.device_sync(device)
        self._monitor_callback = None
        self._monitor_fn = None
        self._monitor_names = None
        # health and perf planes: one memory row per bound structure;
        # the cost rows are counted at the first dispatches
        self._program_label = self._record_bind_memory()
        self._cost_fwd_done = False
        self._cost_fwdbwd_done = False
        self._fwd_flops = None      # the counted training forward
        self._pending_fwd_wall = 0.0
        # the (kind, mode) pairs this executor has run, and its input
        # signature: executor_compile_total's keys on the graph function
        self._ran = set()
        self._sig = None

    def _record_bind_memory(self):
        """The bind's memory row (arguments + aux + gradients in, the
        inferred outputs out; shape math) under ``name[signature]``."""
        try:
            sig = str(self._symbol.structural_signature())[:10]
        except Exception:  # noqa: BLE001 — accounting never breaks a bind
            sig = "%x" % (id(self._symbol) & 0xFFFFFF)
        label = f"{self._symbol.name or 'graph'}[{sig}]"

        def nbytes(t):
            return int(t.numel()) * int(t.element_size())

        try:
            arg_b = sum(nbytes(v) for v in self.arg_dict.values())
            arg_b += sum(nbytes(v) for v in self.aux_dict.values())
            grad_b = sum(nbytes(v) for v in self.grad_dict.values()
                         if isinstance(v, torch.Tensor))
            out_b = 0
            try:
                _, out_shapes, _ = self._symbol.infer_shape(
                    **{k: tuple(v.shape) for k, v in self.arg_dict.items()})
                out_b = sum(int(np.prod(s)) * 4 for s in out_shapes or ())
            except Exception:  # noqa: BLE001 — unknown outputs stay 0
                pass
            _tm.health.record_program(label, argument=arg_b + grad_b,
                                      output=out_b, source="shape_math")
        except Exception:  # noqa: BLE001 — accounting never breaks a bind
            pass
        return label

    def _first_run(self, kind, mode):
        """:func:`_compile_start` on this bind's graph function, at the
        bound shapes: None once this executor has run ``(kind, mode)``."""
        if (kind, mode) in self._ran:
            return None
        self._ran.add((kind, mode))
        if self._sig is None:
            self._sig = (str(self._device), tuple(self._grad_names),
                         tuple((k, tuple(v.shape), str(v.dtype))
                               for d in (self.arg_dict, self.aux_dict)
                               for k, v in d.items()))
        return _compile_start(self._graph_fn, kind, (mode, self._sig))

    def _build_rs_specs(self, rs_holders):
        """``(name, lookups, row width, dtype)`` of each row-sparse
        holder; the lookup count is the size of the ids feeding its
        Embedding node at the bound shapes, fixed per bind."""
        plan = _sparse.rs_plan(self._exec_symbol)
        known = {k: tuple(v.shape) for k, v in self.arg_dict.items()}
        shapes = self._exec_symbol._infer(known, partial=True)
        specs = []
        for wname in rs_holders:
            node = plan.get(wname)
            w = self.arg_dict.get(wname)
            if node is None or w is None or self.grad_req[wname] != "write":
                raise MXNetError(
                    f"bind: arg {wname!r} has a row_sparse gradient buffer "
                    "but is not the sole weight of one Embedding op with "
                    "grad_req='write'; bind a dense gradient instead")
            src, oidx = node.inputs[0]
            dshape = (shapes.get((src.name, "var")) if src.is_variable
                      else shapes.get((id(src), oidx)))
            if dshape is None or w.dim() != 2:
                raise MXNetError(f"bind: cannot infer the lookup shape "
                                 f"feeding Embedding weight {wname!r}")
            specs.append((wname, int(np.prod(dshape)), int(w.shape[1]),
                          w.dtype))
        return tuple(specs)

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def symbol(self) -> Symbol:
        return self._symbol

    @property
    def arg_arrays(self):
        return list(self.arg_dict.values())

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(k) for k in self.arg_dict]

    @property
    def aux_arrays(self):
        return [self.aux_dict[k]
                for k in self._symbol.list_auxiliary_states()]

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        """Copy ``{name: value}`` (numpy arrays, tensors, NDArrays, JAX
        arrays) into the bound tensors, keeping their dtype, device and
        memory format; a name the bind lacks raises unless
        ``allow_extra_params``."""
        for kind, have, given in (("param", self.arg_dict, arg_params),
                                  ("aux", self.aux_dict, aux_params)):
            for k, v in (given or {}).items():
                dst = have.get(k)
                if dst is None:
                    if not allow_extra_params:
                        raise MXNetError(f"unknown {kind} {k}")
                    continue
                src = _to_tensor(v, dst.dtype, dst.device)
                if src.shape != dst.shape:
                    raise MXNetError(f"copy_params_from: {k} has shape "
                                     f"{tuple(src.shape)}, bound "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)

    def forward(self, is_train=False, **kwargs):
        """Run the graph; ``kwargs`` set arguments first.  In training
        the arguments with a gradient are autograd leaves and the aux
        states are written back."""
        for k, v in kwargs.items():
            dst = self.arg_dict.get(k)
            if dst is None:
                raise MXNetError(f"unknown input {k}")
            dst.copy_(_value(v, dst))
        # a forward drops the graph of one without its backward first
        self._pending = None
        perf_on = _tm.perf.enabled()
        tp0 = time.perf_counter() if perf_on else 0.0
        t0 = time.perf_counter() if _tm.enabled() else None
        tc = self._first_run("fwd", bool(is_train))
        if not is_train:
            with _prof.span(self._spans[0], device=str(self._device),
                            sync=self._sync), torch.no_grad():
                try:
                    if perf_on and not self._cost_fwd_done:
                        self._cost_fwd_done = True
                        outs, _ = _tm.perf.count_cost(
                            self._program_label, self._graph_fn,
                            self.arg_dict, self.aux_dict, None, False)
                    else:
                        outs, _ = self._graph_fn(self.arg_dict,
                                                 self.aux_dict, None, False)
                except Exception as e:  # noqa: BLE001 — OOM: the report
                    _tm.health.reraise_if_oom(e, site="executor.forward")
                    raise
            self._outputs = outs
            _compile_done(tc, "fwd")
            if t0 is not None:
                _TM_FWD_SEC.observe(time.perf_counter() - t0)
            if perf_on:
                _tm.perf.record_dispatch(self._program_label,
                                         time.perf_counter() - tp0)
            self._run_monitor()
            return outs
        # the forward_backward span opens here and closes in backward()
        self._fb_start = _prof.now_us() if _prof.is_running() else None
        args = dict(self.arg_dict)
        leaves = {k: args[k].detach().requires_grad_(True)
                  for k in self._grad_names}
        for wname, n_ids, row_dim, dt in self._rs_specs:
            leaves[_RS_PROBE + wname] = torch.zeros(
                (n_ids, row_dim), dtype=dt, device=self._device,
                requires_grad=True)
        args.update(leaves)
        gen = _random.generator(self._device)
        with torch.enable_grad():
            try:
                if perf_on and not self._cost_fwdbwd_done:
                    with _tm.perf.counting() as c:
                        outs, new_aux = self._graph_fn(args, self.aux_dict,
                                                       gen, True)
                    self._fwd_flops = c.flops
                else:
                    outs, new_aux = self._graph_fn(args, self.aux_dict, gen,
                                                   True)
            except Exception as e:  # noqa: BLE001 — OOM: the report
                _tm.health.reraise_if_oom(e, site="executor.forward")
                raise
        rs_ids = {w: new_aux.pop(_RS_IDX + w) for w, *_ in self._rs_specs}
        with torch.no_grad():
            for k, v in new_aux.items():
                dst = self.aux_dict[k]
                if v is not dst:
                    dst.copy_(v)
        self._pending = (outs, leaves, rs_ids)
        self._outputs = [o.detach() for o in outs]
        _compile_done(tc, "fwd")
        if t0 is not None:
            _TM_FWD_SEC.observe(time.perf_counter() - t0)
        # the training forward's wall joins its backward's dispatch
        self._pending_fwd_wall = (time.perf_counter() - tp0) if perf_on \
            else 0.0
        return self._outputs

    @property
    def outputs(self):
        if self._outputs is None:
            raise MXNetError("no forward has been run")
        return self._outputs

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def backward(self, out_grads=None):
        """Differentiate the last training forward into ``grad_dict``.
        ``out_grads`` (one value or a list, one per output) seeds the
        outputs; none seeds ones, which the loss ops ignore."""
        if self._pending is None:
            raise MXNetError("backward() requires forward(is_train=True) "
                             "first")
        outs, leaves, rs_ids = self._pending
        self._pending = None
        start = self._fb_start
        if start is None and _prof.is_running():
            start = _prof.now_us()
        perf_on = _tm.perf.enabled()
        t0 = time.perf_counter() if (perf_on or _tm.enabled()) else None
        tc = self._first_run("fwdbwd", out_grads is None)
        try:
            if self._fwd_flops is not None:
                # the first training pair: its forward was counted too,
                # and the pair's row takes the label
                with _tm.perf.counting() as c:
                    self._backward(outs, leaves, rs_ids, out_grads)
                _tm.perf.record_cost(self._program_label,
                                     flops=self._fwd_flops + c.flops,
                                     source="flop_counter")
                self._fwd_flops = None
                self._cost_fwdbwd_done = True
            else:
                self._backward(outs, leaves, rs_ids, out_grads)
        except Exception as e:  # noqa: BLE001 — OOM: the report
            _tm.health.reraise_if_oom(e, site="executor.backward")
            raise
        _compile_done(tc, "fwdbwd")
        if t0 is not None and _tm.enabled():
            _TM_BWD_SEC.observe(time.perf_counter() - t0)
        if perf_on:
            _tm.perf.record_dispatch(
                self._program_label,
                time.perf_counter() - t0 + self._pending_fwd_wall)
            self._pending_fwd_wall = 0.0
        if start is not None and _prof.is_running():
            if self._sync is not None:
                self._sync()
            _prof.record(self._spans[1], str(self._device), start,
                         _prof.now_us())
        self._run_monitor()

    def _backward(self, outs, leaves, rs_ids, out_grads):
        """The gradients of ``outs`` into ``grad_dict``."""
        if out_grads is None:
            heads = [torch.ones_like(o) for o in outs]
        else:
            if not isinstance(out_grads, (list, tuple)):
                out_grads = [out_grads]
            if len(out_grads) != len(outs):
                raise MXNetError(f"backward: {len(out_grads)} head "
                                 f"gradients for {len(outs)} outputs")
            heads = [_value(g, o) for g, o in zip(out_grads, outs)]
        pairs = [(o, h) for o, h in zip(outs, heads) if o.requires_grad]
        names = list(leaves)
        grads = [None] * len(names)
        if pairs and names:
            grads = torch.autograd.grad(
                [o for o, _ in pairs], [leaves[k] for k in names],
                grad_outputs=[h for _, h in pairs], allow_unused=True)
        grads = dict(zip(names, grads))
        rows = {}
        with torch.no_grad():
            for wname, n_ids, row_dim, dt in self._rs_specs:
                vals = grads.pop(_RS_PROBE + wname)
                if vals is None:
                    vals = torch.zeros((n_ids, row_dim), dtype=dt,
                                       device=self._device)
                sid, gvals, _ = _sparse.coalesce_rows(rs_ids[wname], vals)
                rows[wname] = (sid, gvals)
        if self._amp_scale:
            # the loss scale multiplies each gradient here, not the head:
            # the loss ops discard the head gradient
            scale = _amp.global_scaler().scale_raw()
            grads = {k: None if g is None else g * scale.to(g.dtype)
                     for k, g in grads.items()}
            rows = {k: (sid, v * scale.to(v.dtype))
                    for k, (sid, v) in rows.items()}
        for wname, (sid, vals) in rows.items():
            self.grad_dict[wname]._set_rows(sid, vals)
        with torch.no_grad():
            for k, g in grads.items():
                buf = self.grad_dict[k]
                if self.grad_req[k] == "add":
                    if g is not None:
                        buf.add_(g)
                elif g is None:
                    buf.zero_()
                else:
                    buf.copy_(g)

    def set_monitor_callback(self, callback):
        """Tap every internal output: ``callback(name, NDArray)`` after
        each inference forward and each backward (parity: GraphExecutor::
        SetMonitorCallback, graph_executor.cc:63)."""
        self._monitor_callback = callback

    def _run_monitor(self):
        cb = self._monitor_callback
        if cb is None or not getattr(getattr(cb, "__self__", None),
                                     "activated", True):
            return
        if self._monitor_fn is None:
            internals = self._symbol.get_internals()
            self._monitor_fn = _build_graph_fn(internals, self._device)
            self._monitor_names = internals.list_outputs()
        with torch.no_grad():
            outs, _ = self._monitor_fn(self.arg_dict, self.aux_dict, None,
                                       False)
        for name, val in zip(self._monitor_names, outs):
            cb(name, NDArray(val))

    def reshape(self, partial_shaping=False, allow_up_sizing=False,
                **kwargs):
        """A new executor for new input shapes: arrays whose shape is
        unchanged share storage with this executor's (as MXNet's
        reshape), the others are new zeros."""
        shapes = {k: tuple(v.shape) for k, v in self.arg_dict.items()}
        shapes.update({k: tuple(v) for k, v in kwargs.items()})
        types = {k: v.dtype for k, v in self.arg_dict.items()}
        types.update({k: v.dtype for k, v in self.aux_dict.items()})
        new = simple_bind(self._symbol, self._device, grad_req=self.grad_req,
                          type_dict=types, shared_exec=self,
                          group2ctx=self._group2ctx or None, **shapes)
        for mine, theirs in ((self.arg_dict, new.arg_dict),
                             (self.aux_dict, new.aux_dict),
                             (self.grad_dict, new.grad_dict)):
            for k, t in list(theirs.items()):
                if k in mine and mine[k].shape == t.shape:
                    theirs[k] = mine[k]
        return new


def _value(v, like: torch.Tensor) -> torch.Tensor:
    """An input as a tensor on ``like``'s device in ``like``'s dtype: a
    tensor or a port NDArray without a host round trip, anything else
    (numpy, lists, JAX arrays) through ``convert._to_tensor``."""
    if isinstance(v, NDArray):
        v = v.tensor
    if not isinstance(v, torch.Tensor):
        return _to_tensor(v, like.dtype, like.device)
    return v.to(device=like.device, dtype=like.dtype)


def _dtypes(symbol, type_dict):
    dtypes = {}
    for node in symbol.nodes:
        if node.is_variable and "__dtype__" in node.extra_attrs:
            dtypes[node.name] = numeric_dtype(node.extra_attrs["__dtype__"])
    dtypes.update({k: numeric_dtype(v) for k, v in (type_dict or {}).items()})
    return dtypes


def simple_bind(symbol: Symbol, device=None, grad_req="write",
                type_dict=None, group2ctx=None, shared_exec=None,
                **shapes) -> Executor:
    """Infer shapes from ``shapes``, allocate zeros for every argument
    and aux state on ``device`` (default: the card) in its dtype
    (``type_dict``, else a ``__dtype__`` attr, else float32), a gradient
    buffer like each argument whose ``grad_req`` is not ``null``, and
    bind.  4-D arrays are channels-last unless
    ``MXTPU_CONV_LAYOUT=NCHW``.  A ``grad_stype="row_sparse"`` Embedding
    weight gets a row-sparse gradient holder.  ``shared_exec`` bound on
    the same symbol object lends its post-pass graph function.
    ``group2ctx`` places each variable (and its gradient) on its group's
    device (:func:`placement_plan`) and runs each node there."""
    device = resolve_device(device)
    var_dev = {}
    if group2ctx:
        _check_group2ctx(symbol, group2ctx)
        _, var_dev, _ = placement_plan(symbol, group2ctx, device)
    arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)
    if arg_shapes is None:
        raise MXNetError(f"simple_bind: cannot infer shapes from {shapes}")
    cl = channels_last_default()
    dtypes = _dtypes(symbol, type_dict)

    def alloc(name, shape):
        t = torch.zeros(shape, dtype=dtypes.get(name, torch.float32),
                        device=var_dev.get(name, device))
        return t.contiguous(memory_format=torch.channels_last) \
            if cl and t.ndim == 4 else t

    arg_names = symbol.list_arguments()
    args = {n: alloc(n, s) for n, s in zip(arg_names, arg_shapes)}
    aux = {n: alloc(n, s)
           for n, s in zip(symbol.list_auxiliary_states(), aux_shapes)}
    req = _req_dict(arg_names, grad_req)
    # row-sparse holders for the grad_stype="row_sparse" Embedding
    # weights (MXTPU_SPARSE_UPDATE=0 keeps dense buffers)
    rs_names = set()
    if _sparse.sparse_update_enabled() and _sparse.annotated_rs_names(symbol):
        rs_names = {n for n in _sparse.rs_plan(symbol)
                    if req.get(n) == "write"}
    grads = {}
    for n in arg_names:
        if req[n] == "null":
            continue
        if n in rs_names:
            grads[n] = _sparse.zeros("row_sparse", tuple(args[n].shape),
                                     ctx=args[n].device, dtype=args[n].dtype)
        else:
            grads[n] = torch.zeros_like(args[n])
    return Executor(symbol, device, args, aux, grads, req,
                    shared_exec=shared_exec, group2ctx=group2ctx)


def bind(symbol: Symbol, device, args, args_grad=None, grad_req="write",
         aux_states=None, group2ctx=None, shared_exec=None) -> Executor:
    """Bind ``symbol`` to the given arrays (a dict, or a list in
    ``list_arguments()`` order; tensors and NDArrays are bound as they
    are, sharing their storage; numpy data is copied to ``device``).
    With ``group2ctx`` each node runs on its group's device (the given
    arrays stay where they are)."""
    device = resolve_device(device)
    if group2ctx:
        _check_group2ctx(symbol, group2ctx)

    def tensor(v):
        if getattr(v, "stype", "default") == "row_sparse":
            return v  # a row-sparse gradient holder, bound as it is
        if isinstance(v, NDArray):
            return v.tensor
        if isinstance(v, torch.Tensor):
            return v
        return torch.from_numpy(np.array(v, dtype=np.float32)).to(device)

    arg_names = symbol.list_arguments()
    args = {k: tensor(v) for k, v in _as_list(arg_names, args,
                                              "args").items()}
    grads = {k: tensor(v) for k, v in _as_list(arg_names, args_grad,
                                               "args_grad").items()
             if v is not None}
    aux = {k: tensor(v) for k, v in _as_list(
        symbol.list_auxiliary_states(), aux_states, "aux_states").items()}
    return Executor(symbol, device, args, aux, grads, grad_req,
                    shared_exec=shared_exec, group2ctx=group2ctx)

"""Mesh and sharding helpers of the port (mirrors
``mxnet_tpu/parallel/mesh.py``).

The reference's ``jax.sharding.Mesh`` over devices becomes a
:class:`Mesh` over process ranks, one rank per card (the PyTorch SPMD
idiom: each process drives its own card and runs the same program).  It
wraps a ``torch.distributed.device_mesh.DeviceMesh`` with the same named
axes and answers what the reference's mesh answers: ``mesh.shape[axis]``,
``mesh.axis_names``, ``mesh.devices`` (here the grid of ranks) and
``mesh.size``.

A ``NamedSharding(mesh, P(...))`` becomes :class:`NamedSharding` with
the same spec tuple (``spec[d]`` names the mesh axis tensor dimension
``d`` is split over, or None), whose :attr:`~NamedSharding.placements`
are the ``DTensor`` placements (``Shard(d)``, ``Replicate()``) on each
mesh axis.  Placed tensors are ``torch.distributed.tensor.DTensor``s,
and DTensor's sharding propagation plays the part of GSPMD: the
all-reduces a data-parallel gradient and a row-parallel product need
are the ones DTensor inserts.

- 'data'  : batch (data parallel)
- 'model' : tensor parallel (Megatron's column/row split)
- 'pipe'  : pipeline stages
- 'seq'   : sequence/context parallel (ring and Ulysses attention)

:func:`create_mesh` validates the shape before it touches a process
group (the reference's texts), then brings up the group through
:func:`~.dist.init_from_env` (NCCL when each rank has a card of its own,
gloo on the CPU or when ranks share a card; a world of one process needs
no launcher).  The mesh lives on the card unless the caller asks for the
CPU (``device="cpu"``); without a card it raises.
"""
from __future__ import annotations

import os
import re
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from .. import telemetry as _tm
from ..base import MXNetError

__all__ = ["Mesh", "NamedSharding", "ShardingRule", "GLOBAL_AXES",
           "create_mesh", "mesh_shape_from_env", "global_mesh",
           "data_sharding", "replicated", "param_shardings", "shard_params",
           "narrow_local", "from_block", "copy_full_into", "full_value", "is_dtensor",
           "megatron_rules", "local_map"]

# docs/telemetry.md — set whenever a process mesh is (re)built, one
# sample per axis; the scrapeable record of the topology a run used
_TM_AXIS = _tm.gauge(
    "mesh_axis_size",
    "size of each axis of the process-level device mesh "
    "(MXTPU_MESH_SHAPE; set at global_mesh build)", labels=("axis",))


class Mesh:
    """Named axes over a grid of process ranks (one card each), on a
    ``DeviceMesh``.  ``shape`` maps each axis to its size, as the
    reference's mesh does; ``devices`` is the grid of ranks."""

    def __init__(self, device_mesh, axis_names, ranks, device):
        self.device_mesh = device_mesh
        self.axis_names = tuple(axis_names)
        self.devices = np.asarray(ranks)
        self.shape = OrderedDict(zip(self.axis_names, self.devices.shape))
        self.device = device

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def get_group(self, axis):
        """The process group of ``axis`` this rank belongs to."""
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis) -> int:
        """This rank's index along ``axis``."""
        return int(self.device_mesh.get_local_rank(axis))

    def __repr__(self):
        return (f"Mesh({dict(self.shape)}, device_type="
                f"{self.device_mesh.device_type!r})")


def _world_size() -> int:
    """The world the default mesh spans: the live process group's, or
    the launcher's worker count, or 1."""
    from . import dist as _dist

    if _dist._initialized():
        return _dist.num_workers()
    try:
        n = int(os.environ.get("MXTPU_NUM_WORKERS", "1"))
    except ValueError:
        n = 1
    return n if os.environ.get("MXTPU_COORDINATOR") else 1


def _validated_shape(shape, axes, n_devices):
    """The reference's checks and messages, word for word, and the -1
    inference; no process group is touched."""
    if shape is None:
        shape = (n_devices,)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axes):
        raise MXNetError(
            f"mesh shape {shape} has {len(shape)} dims for "
            f"{len(axes)} axes {tuple(axes)}")
    if sum(1 for s in shape if s == -1) > 1:
        raise MXNetError(f"mesh shape {shape}: at most one -1 axis")
    if any(s == 0 or s < -1 for s in shape):
        raise MXNetError(f"mesh shape {shape}: axis sizes must be "
                         "positive (or one -1 to infer)")
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        if known <= 0 or n_devices % known != 0:
            raise MXNetError(
                f"mesh shape {shape}: cannot infer -1 axis — "
                f"{n_devices} devices not divisible by {known}")
        shape = tuple(n_devices // known if s == -1 else s for s in shape)
    n = int(np.prod(shape))
    if n > n_devices:
        raise MXNetError(
            f"mesh shape {shape} needs {n} devices, have {n_devices}")
    return shape


def create_mesh(shape=None, axes=("data",), devices=None,
                device=None) -> Mesh:
    """Build a mesh over the process ranks (``devices``: the ranks,
    default every rank of the world).

    create_mesh() -> 1-D data mesh over all ranks;
    create_mesh((4, 2), ("data", "model")) -> 2-D dp x tp mesh.

    One axis may be ``-1`` (inferred from the rank count).  A shape the
    ranks cannot fill raises :class:`MXNetError` naming the counts.
    ``device`` (default: the card) is where the mesh's tensors live;
    ``"cpu"`` runs it over gloo on the host."""
    from ..context import resolve_device
    from . import dist as _dist

    devices = (list(devices) if devices is not None
               else list(range(_world_size())))
    shape = _validated_shape(shape, axes, len(devices))
    dev = resolve_device(device)
    _dist.init_from_env(device=dev.type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    from torch.distributed.device_mesh import DeviceMesh

    ranks = np.array(devices[:int(np.prod(shape))]).reshape(shape)
    dm = DeviceMesh(dev.type, torch.as_tensor(ranks, dtype=torch.int64),
                    mesh_dim_names=tuple(axes))
    return Mesh(dm, axes, ranks, dev)


# ---------------------------------------------------------------------------
# Process-level mesh: one logical 2-D mesh ("batch", "model") over the
# world's ranks; MXTPU_MESH_SHAPE ("8,1", "4,2", "-1,2", ...) picks the
# factorization, the default is pure data parallel (n_ranks, 1).
# ---------------------------------------------------------------------------
GLOBAL_AXES = ("batch", "model")
_global_mesh_cache = {}
_global_mesh_lock = threading.Lock()


def mesh_shape_from_env(n_devices: int):
    """Resolved MXTPU_MESH_SHAPE as a tuple (default (n_devices, 1))."""
    raw = os.environ.get("MXTPU_MESH_SHAPE", "").strip()
    if not raw:
        return (n_devices, 1)
    parts = [p for p in re.split(r"[,x\s]+", raw.strip("()[]")) if p]
    try:
        shape = tuple(int(p) for p in parts)
    except ValueError:
        raise MXNetError(f"MXTPU_MESH_SHAPE={raw!r}: expected integers "
                         "like '8,1' or '4,2'")
    if len(shape) == 1:
        shape = (shape[0], 1)
    if len(shape) != 2:
        raise MXNetError(f"MXTPU_MESH_SHAPE={raw!r}: the process mesh "
                         f"is 2-D {GLOBAL_AXES}, got {len(shape)} dims")
    return shape


def global_mesh(devices=None, device=None) -> Mesh:
    """The process-level ("batch", "model") mesh over ``devices`` (the
    ranks; default all of them).  Cached per (env shape, ranks, device);
    the ``mesh_axis_size`` gauge records the axes of the last build."""
    devices = (list(devices) if devices is not None
               else list(range(_world_size())))
    raw = os.environ.get("MXTPU_MESH_SHAPE", "").strip()
    key = (raw, tuple(devices), str(device))
    with _global_mesh_lock:
        mesh = _global_mesh_cache.get(key)
    if mesh is not None:
        return mesh
    shape = mesh_shape_from_env(len(devices))
    n = int(np.prod([s for s in shape if s != -1]))
    if -1 not in shape and len(devices) % n != 0:
        raise MXNetError(
            f"MXTPU_MESH_SHAPE={shape} needs a multiple of {n} devices, "
            f"have {len(devices)}")
    mesh = create_mesh(shape, GLOBAL_AXES, devices=devices, device=device)
    with _global_mesh_lock:
        _global_mesh_cache[key] = mesh
    if _tm.enabled():
        for axis, size in mesh.shape.items():
            _TM_AXIS.set(size, axis=axis)
    return mesh


# ------------------------------------------------------------- shardings
class NamedSharding:
    """``NamedSharding(mesh, P(*spec))``: ``spec[d]`` is the mesh axis
    (or tuple of axes) tensor dimension ``d`` is split over, or None;
    an empty spec is replicated.  :attr:`placements` are its DTensor
    placements, one per mesh axis."""

    def __init__(self, mesh: Mesh, spec=()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def _key(self):
        spec = self.spec
        while spec and spec[-1] is None:
            spec = spec[:-1]
        return spec

    @property
    def placements(self):
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for axis in self.mesh.axis_names:
            dims = [d for d, s in enumerate(self.spec)
                    if s == axis or (isinstance(s, tuple) and axis in s)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    @property
    def is_fully_replicated(self) -> bool:
        return all(s is None for s in self.spec)

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and other._key() == self._key())

    def __hash__(self):
        return hash((id(self.mesh), self._key()))

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, P{self.spec!r})"


def data_sharding(mesh: Mesh, ndim: int, axis: str = "data"):
    """Batch-dim sharding for an ndim array."""
    return NamedSharding(mesh, (axis,) + (None,) * (ndim - 1))


def replicated(mesh: Mesh):
    return NamedSharding(mesh, ())


@dataclass
class ShardingRule:
    """Regex -> spec rule for parameter sharding (the TP analogue of the
    reference's ctx_group model-parallel annotations)."""

    pattern: str
    spec: tuple

    def matches(self, name: str) -> bool:
        return re.match(self.pattern, name) is not None


def param_shardings(mesh: Mesh, names, rules: Sequence[ShardingRule] = ()):
    """{name: NamedSharding} from the first matching rule per name
    (default: replicated over ``mesh``)."""
    out = {}
    for name in names:
        spec = ()
        for rule in rules:
            if rule.matches(name):
                spec = tuple(rule.spec)
                break
        out[name] = NamedSharding(mesh, spec)
    return out


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _as_tensor(value, device):
    """A full value (DTensor, tensor, the port's NDArray, numpy array) as
    a tensor on ``device``.  Called where a parameter is placed
    (``init``, a load), never per batch."""
    if is_dtensor(value):
        return value
    if hasattr(value, "tensor") and not isinstance(value, torch.Tensor):
        value = value.tensor                      # the port's NDArray
    if isinstance(value, torch.Tensor):
        return value.detach().to(device)
    # sync-ok: a parameter's full value uploaded once at init or a load,
    # never on a batch
    return torch.from_numpy(np.ascontiguousarray(np.asarray(value))).to(
        device)


def narrow_local(value, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of the full tensor ``value`` under ``sharding``
    as a differentiable slice (narrow) of it; every split must be even."""
    from torch.distributed.tensor import Shard

    out = value
    for axis, p in zip(sharding.mesh.axis_names, sharding.placements):
        if not isinstance(p, Shard):
            continue
        n = sharding.mesh.shape[axis]
        size = out.shape[p.dim]
        if size % n:
            raise MXNetError(f"dimension {p.dim} of size {size} does not "
                             f"split over the {n} ranks of mesh axis "
                             f"{axis!r}")
        out = out.narrow(p.dim, sharding.mesh.coordinate(axis) * (size // n),
                         size // n)
    return out


def _same_placement(arr, sharding):
    return (is_dtensor(arr) and arr.device_mesh is sharding.mesh.device_mesh
            and tuple(arr.placements) == sharding.placements)


def shard_params(mesh: Mesh, params: dict,
                 rules: Sequence[ShardingRule] = ()) -> dict:
    """Place every param according to the first matching rule (default:
    replicated over ``mesh``), as DTensors.

    Every rank holds the same full value and keeps its own block (no
    transfer).  Entries already placed as their target pass through
    untouched: re-sharding an already-sharded dict is a no-op that
    returns the same objects, so callers may re-apply rules
    defensively."""
    from torch.distributed.tensor import distribute_tensor

    shardings = param_shardings(mesh, params.keys(), rules)
    out = {}
    for name, arr in params.items():
        sh = shardings[name]
        if _same_placement(arr, sh):
            out[name] = arr
        elif is_dtensor(arr):
            out[name] = arr.redistribute(sh.mesh.device_mesh, sh.placements)
        else:
            out[name] = distribute_tensor(
                _as_tensor(arr, mesh.device), mesh.device_mesh,
                sh.placements, src_data_rank=None)
    for name, arr in params.items():
        if _same_placement(arr, shardings[name]):
            assert out[name] is arr, (
                f"shard_params: re-sharding already-placed param {name!r} "
                "must be a no-op")
    return out


def from_block(local, device_mesh, placements, shape):
    """The DTensor of global ``shape`` (contiguous) whose block on this
    rank is ``local``, placed by ``placements``; no communication."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size(shape)
    return DTensor.from_local(
        local, device_mesh, placements, run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def copy_full_into(dst, full):
    """Copy the full value ``full`` into ``dst`` in place: a DTensor
    takes its own block of it, a plain tensor all of it."""
    if is_dtensor(dst):
        from torch.distributed.tensor import distribute_tensor

        src = _as_tensor(full, dst.to_local().device)
        dst.to_local().copy_(distribute_tensor(
            src, dst.device_mesh, dst.placements,
            src_data_rank=None).to_local())
    else:
        dst.copy_(_as_tensor(full, dst.device))


def full_value(t):
    """The full (global) value of a DTensor, gathered (a collective
    every rank of its mesh must call); a plain tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def local_map(*args, **kwargs):
    """``torch.distributed.tensor.experimental.local_map``: run a
    function on each rank's blocks of its DTensor arguments and wrap
    its results back (the counterpart of the reference's ``shard_map``
    shim)."""
    from torch.distributed.tensor.experimental import local_map as impl

    return impl(*args, **kwargs)


def megatron_rules(model_axis: str = "model", shard_embed: bool = True):
    """Megatron-style tensor-parallel sharding rules for the transformer
    zoo (models/transformer.py naming).

    The classic layout (Shoeybi et al.): attention qkv and FFN-in are
    *column*-parallel (split the output features: weight rows, since
    FullyConnected weights are (out, in)), their biases split with them;
    the attention out-projection and FFN-out are *row*-parallel (split
    the input features: weight columns) with replicated biases — DTensor
    then inserts exactly one all-reduce after each row-parallel matmul,
    matching Megatron's f/g collectives.  The LM head and token embedding
    shard over the vocab dim.

    Returns a tuple of ShardingRule for FusedTrainer(sharding_rules=...)
    / shard_params.
    """
    rules = [
        # attention: q/k/v column-parallel, out-projection row-parallel
        # (separate projections so the shard boundary never cuts a packed
        # q|k|v layout — models/transformer.py)
        ShardingRule(r".*_(q|k|v)_weight$", (model_axis, None)),
        ShardingRule(r".*_(q|k|v)_bias$", (model_axis,)),
        ShardingRule(r".*_proj_weight$", (None, model_axis)),
        # FFN: in column-parallel, out row-parallel
        ShardingRule(r".*_ffn_in_weight$", (model_axis, None)),
        ShardingRule(r".*_ffn_in_bias$", (model_axis,)),
        ShardingRule(r".*_ffn_out_weight$", (None, model_axis)),
        # LM head: vocab-dim column-parallel
        ShardingRule(r"lm_head_weight$", (model_axis, None)),
        ShardingRule(r"lm_head_bias$", (model_axis,)),
    ]
    if shard_embed:
        rules.append(ShardingRule(r"tok_embed_weight$", (model_axis, None)))
    return tuple(rules)

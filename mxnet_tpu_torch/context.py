"""Device contexts of the port (mirrors ``mxnet_tpu/context.py``).

``cpu(i)``, ``gpu(i)`` and ``tpu(i)`` return ``torch.device``s, so they
go straight to torch (``torch.zeros(3, device=mx.gpu())``): ``gpu(i)``
is ``cuda:i``, ``tpu(i)`` names the accelerator, which on this port is
the card (``cuda:i`` too, so a reference script written with
``mx.tpu()`` runs unchanged), and ``cpu(i)`` is the host.

:class:`Context` is the reference's type: ``Context("gpu", 0)``, its
``device_type``/``device_id``, equality and hash, and ``with ctx:``
scoping, which sets :func:`current_context` for the ``nd`` creators
(the scope is per thread).  A Context equals the ``torch.device`` it
names (``mx.gpu(0) == mx.Context("gpu", 0)``); two Contexts compare as
in the reference, by type and id.  ``cpu_pinned(i)`` is a Context:
its ``nd`` arrays live in pinned host memory taken from the
``storage`` pool, which needs a card (pinning is a CUDA call).

Every entry point of the port resolves its ``device`` argument through
:func:`resolve_device`, which takes a Context, a ``torch.device``, a
string or an index: the default is the card, and without one it raises
instead of quietly running on the CPU.  Tests pass ``device="cpu"``.

:func:`process_mesh` is the process-level ``("batch", "model")`` mesh
over the world's ranks (``MXTPU_MESH_SHAPE``), and :func:`mesh_sharding`
a sharding on it.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "cpu_pinned", "gpu", "tpu", "num_devices",
           "current_context", "resolve_device", "is_pinned", "process_mesh",
           "mesh_sharding"]

_scope = threading.local()


class Context:
    """A device: ``Context("cpu" | "gpu" | "cpu_pinned" | "tpu", id)``
    (also from another Context or a ``torch.device``)."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 4: "tpu"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "tpu": 4}

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        elif isinstance(device_type, torch.device):
            self.device_typeid = 2 if device_type.type == "cuda" else 1
            self.device_id = device_type.index or 0
        else:
            if device_type not in Context.devstr2type:
                raise MXNetError(f"unknown device type {device_type!r} "
                                 f"(one of {sorted(Context.devstr2type)})")
            self.device_typeid = Context.devstr2type[device_type]
            self.device_id = int(device_id)

    @property
    def device_type(self) -> str:
        return Context.devtype2str[self.device_typeid]

    @property
    def torch_device(self) -> torch.device:
        """The ``torch.device`` this context names (the host for
        ``cpu``/``cpu_pinned``, ``cuda:<id>`` for ``gpu``/``tpu``)."""
        if self.device_type in ("cpu", "cpu_pinned"):
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    def __eq__(self, other):
        if isinstance(other, Context):
            return (self.device_typeid == other.device_typeid
                    and self.device_id == other.device_id)
        if isinstance(other, torch.device):
            return (self.device_type != "cpu_pinned"
                    and self.torch_device == other)
        return NotImplemented

    def __hash__(self):
        if self.device_type == "cpu_pinned":
            return hash(("cpu_pinned", self.device_id))
        return hash(self.torch_device)

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    def __enter__(self):
        stack = getattr(_scope, "stack", None)
        if stack is None:
            stack = _scope.stack = []
        stack.append(self)
        return self

    def __exit__(self, *exc):
        _scope.stack.pop()

    def empty_cache(self):
        """Hand the card's cached blocks back (MXStorageEmptyCache)."""
        if self.torch_device.type == "cuda" and torch.cuda.is_available():
            torch.cuda.empty_cache()


def cpu(device_id: int = 0) -> torch.device:
    """The host (``device_id`` is accepted for MXNet parity and ignored)."""
    return torch.device("cpu")


def gpu(device_id: int = 0) -> torch.device:
    return torch.device("cuda", int(device_id))


def tpu(device_id: int = 0) -> torch.device:
    """The accelerator: on this port the card, ``gpu(device_id)``."""
    return gpu(device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    """Pinned host memory (the ``nd`` creators allocate it pinned)."""
    return Context("cpu_pinned", device_id)


def num_devices(device_type: str = "tpu") -> int:
    """The number of devices of ``device_type``: the cards for
    ``gpu``/``tpu``, one host for ``cpu``/``cpu_pinned``."""
    if device_type not in Context.devstr2type:
        raise MXNetError(f"unknown device type {device_type!r}")
    if device_type in ("gpu", "tpu"):
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return 1


def _scoped():
    stack = getattr(_scope, "stack", None)
    return stack[-1] if stack else None


def is_pinned(ctx=None) -> bool:
    """Whether ``ctx`` (None: the ``with`` scope's) asks for pinned host
    memory."""
    if ctx is None:
        ctx = _scoped()
    return isinstance(ctx, Context) and ctx.device_type == "cpu_pinned"


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (the current card); a Context, string, index
    or ``torch.device`` names its device (``"gpu"``/``"tpu"`` the card).
    Raises :class:`MXNetError` when the resolved device is CUDA and no
    card is available."""
    if device is None:
        device = torch.device("cuda")
    elif isinstance(device, Context):
        device = device.torch_device
    elif isinstance(device, int):
        device = gpu(device)
    elif isinstance(device, str) and device in Context.devstr2type:
        device = Context(device).torch_device
    else:
        device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "host explicitly")
    return device


def process_mesh(device=None):
    """The process-level ("batch", "model") mesh
    (:func:`~mxnet_tpu_torch.parallel.mesh.global_mesh` over the world's
    ranks; ``MXTPU_MESH_SHAPE`` picks the factorization, default pure
    data parallel).  ``device`` (default: the card) is where its tensors
    live."""
    from .parallel.mesh import global_mesh

    return global_mesh(device=device)


def mesh_sharding(spec=None, device=None):
    """A :class:`~mxnet_tpu_torch.parallel.mesh.NamedSharding` on the
    process mesh for a spec (a tuple of axis names / None spelled the
    PartitionSpec way, or one axis name).  ``None`` means replicated."""
    from .parallel.mesh import NamedSharding

    if spec is None:
        spec = ()
    elif not isinstance(spec, (tuple, list)):
        spec = (spec,)
    return NamedSharding(process_mesh(device), tuple(spec))


def current_context() -> torch.device:
    """The device the imperative creators default to: the innermost
    ``with Context(...)`` scope's, else the card with its index
    (``cuda:<current device>``); raises :class:`MXNetError` when that
    is the card and there is none."""
    ctx = _scoped()
    if ctx is not None:
        return resolve_device(ctx)
    resolve_device(None)
    return gpu(torch.cuda.current_device())

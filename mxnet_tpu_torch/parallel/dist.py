"""Multi-process runtime of the port over ``torch.distributed`` (mirrors
``mxnet_tpu/parallel/dist.py``; parity: the ps-lite ``Postoffice`` role
of include/mxnet/kvstore.h:158-242: ranks, barriers, dead peers).

- :func:`init_from_env` brings up a process group from the
  launcher's environment (``MXTPU_COORDINATOR`` host:port, ``MXTPU_RANK``,
  ``MXTPU_NUM_WORKERS``), validated first: a bad rank or address is a
  named :class:`MXNetError`, not a rendezvous that hangs.
- :func:`barrier` is the cross-process rendezvous under a **watchdog**:
  ``MXTPU_DIST_BARRIER_TIMEOUT_S`` bounds the wait, and expiry raises
  :class:`HostLostError` naming rank, generation and the flight record
  instead of parking the survivors for good (fault site
  ``dist_barrier``: a drop is a dead peer without the wait).
- **Generations** (:func:`generation`, ``MXTPU_DIST_GENERATION``): the
  epoch of a cluster's membership, which the coordinator
  (:mod:`.coordinator`) publishes; a change makes every member leave at
  a checkpoint boundary with :data:`EXIT_HOST_LOST`
  (:func:`elastic_main`).

- :func:`ppermute` is the reference's ``jax.lax.ppermute`` over a mesh
  axis's group (the pipeline's stage hops, the ring's rotation), and
  :func:`exchange` the one collective under it: ``all_to_all_single``
  with uneven splits, which NCCL and gloo both carry (gloo refuses P2P
  on CUDA tensors).
- :func:`all_reduce`, :func:`reduce_scatter`, :func:`all_gather` and
  :func:`broadcast` of a flat tensor over a group are the collective
  ``dist_sync``'s (``kvstore.KVStoreDist`` without servers and its
  sharded bucket update): ``all_reduce``, ``reduce_scatter_tensor``,
  ``all_gather_into_tensor`` and ``broadcast`` of ``torch.distributed``
  on every backend.  gloo carries all four on CUDA tensors too (torch
  2.11 on the H100, two ranks sharing the card; it stages them through
  the host), so no collective is replaced by another.  The gradient
  bytes entering an all-reduce or a reduce-scatter count in
  ``dist_allreduce_bytes_total``.

The parameter-server stores (``kvstore_server.py``) need none of this to
train.  A mesh (:mod:`.mesh`) brings its group up through
:func:`init_from_env` with its device: NCCL when each rank has a card of
its own, gloo on the CPU and when ranks share a card.
"""
from __future__ import annotations

import logging
import math
import os
import threading

import torch

from .. import telemetry as _tm
from ..base import MXNetError

__all__ = ["EXIT_HOST_LOST", "HostLostError", "GenerationChanged",
           "generation", "barrier_timeout_s", "init_from_env",
           "mesh_backend", "rank", "exchange",
           "ppermute", "all_reduce", "reduce_scatter", "all_gather",
           "broadcast", "count_allreduce_bytes",
           "num_workers", "log_prefix", "is_multi_host", "barrier",
           "elastic_main"]

_logger = logging.getLogger("mxnet_tpu_torch.parallel.dist")

#: Process exit code for "this worker left its generation on purpose"
#: (host lost, membership changed): an elastic launcher relaunches the
#: next generation instead of counting it as a crash.
EXIT_HOST_LOST = 43

_TM_ALLREDUCE_BYTES = _tm.counter(
    "dist_allreduce_bytes_total",
    "logical gradient bytes entering the cross-host in-trace all-reduce "
    "of the collective dist_sync path (dispatch-side accounting; the "
    "reduction itself runs inside the compiled step)")
_TM_BARRIER_SEC = _tm.histogram(
    "dist_barrier_seconds",
    "cross-host barrier wall time (the process group's barrier under "
    "the MXTPU_DIST_BARRIER_TIMEOUT_S watchdog)")


class HostLostError(MXNetError):
    """A cross-host blocking site timed out or the membership changed: a
    peer is gone (or joining) and this process must leave its
    generation.  ``host`` (the peer believed dead, or ``"?"``), ``rank``
    and ``generation`` of this process, ``site`` (barrier / collective /
    coordinator / membership) and ``dump`` (the flight record's path,
    when ``MXTPU_FLIGHT_RECORD`` names one) say what happened; exit with
    :data:`EXIT_HOST_LOST` after catching it."""

    def __init__(self, site, host="?", rank=None, generation=None,
                 dump=None, detail=""):
        self.site = site
        self.host = host
        self.rank = _rank_or_env() if rank is None else int(rank)
        self.generation = (generation if generation is not None
                           else _generation_env())
        self.dump = dump
        msg = (f"host lost at site {site!r}: host={host} "
               f"rank={self.rank} generation={self.generation}")
        if detail:
            msg += f" ({detail})"
        if dump:
            msg += f" (flight record: {dump})"
        super().__init__(msg)


class GenerationChanged(HostLostError):
    """The coordinator published a new generation and this process
    checkpointed at the boundary: leave with :data:`EXIT_HOST_LOST` and
    rejoin the next generation through resume."""


def _generation_env() -> int:
    try:
        return int(os.environ.get("MXTPU_DIST_GENERATION", "0") or 0)
    except ValueError:
        return 0


def generation() -> int:
    """The generation this process was launched into (0 unless an
    elastic launcher set ``MXTPU_DIST_GENERATION``)."""
    return _generation_env()


def _rank_or_env() -> int:
    """This process's rank from the environment (safe before, and
    without, a process group)."""
    try:
        return int(os.environ.get("MXTPU_RANK",
                                  os.environ.get("DMLC_RANK", "0")) or 0)
    except ValueError:
        return 0


def barrier_timeout_s() -> float:
    """MXTPU_DIST_BARRIER_TIMEOUT_S: the watchdog's bound on every
    cross-host rendezvous (default 600 s; <= 0 disables it)."""
    try:
        return float(os.environ.get("MXTPU_DIST_BARRIER_TIMEOUT_S", "600"))
    except ValueError:
        return 600.0


def _validate_coordinator(coord: str):
    """A well-formed ``host:port``, named when it is not."""
    host, sep, port = str(coord).rpartition(":")
    ok = bool(sep) and bool(host)
    if ok:
        try:
            ok = 0 < int(port) < 65536
        except ValueError:
            ok = False
    if not ok:
        raise MXNetError(
            f"MXTPU_COORDINATOR={coord!r}: expected 'host:port' with a "
            "port in 1..65535 (e.g. '10.0.0.1:8476')")


def _dist():
    import torch.distributed as td

    return td


def _initialized() -> bool:
    td = _dist()
    return td.is_available() and td.is_initialized()


def _local_layout(rank_, nproc):
    """(local rank, ranks on this host): torchrun's ``LOCAL_RANK`` /
    ``LOCAL_WORLD_SIZE`` when set, else every rank on this host (the
    port's launcher starts them all here)."""
    try:
        local = int(os.environ.get("LOCAL_RANK", rank_))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", nproc))
    except ValueError:
        local, local_world = rank_, nproc
    return local, local_world


def mesh_backend(device_type, local_world):
    """The backend a mesh's process group takes: NCCL when each rank of
    this host has a card of its own, gloo on the CPU, and gloo (logged)
    when ranks must share a card, which NCCL refuses."""
    if device_type != "cuda":
        return "gloo"
    import torch

    n = torch.cuda.device_count()
    if local_world <= n:
        return "nccl"
    _logger.warning(
        "%d ranks share %d card(s) on this host: the mesh runs over gloo "
        "(NCCL refuses two ranks on one GPU)", local_world, n)
    return "gloo"


def init_from_env(device=None):
    """Bring up the process group from the launcher's environment
    (parity: InitPSEnv, include/mxnet/kvstore.h:158-208).  A no-op when a
    group is already up.  ``MXTPU_RANK`` must be an integer in ``[0,
    MXTPU_NUM_WORKERS)`` and ``MXTPU_COORDINATOR`` a ``host:port`` (rank
    0 listens there), else a named error.

    ``device=None`` (the parameter-server stores) brings up gloo, and
    nothing for one process.  ``device="cuda"``/``"cpu"`` brings up the
    group a mesh runs on (:func:`mesh_backend`): on the card each rank
    takes ``cuda:<local rank>`` where it has a card of its own; a world
    of one process gets a group of its own (an in-process store, no
    launcher).

    Rank 0 hosts the rendezvous store at ``MXTPU_COORDINATOR`` unless
    ``TORCHELASTIC_USE_AGENT_STORE=True`` says that the launcher hosts it
    (torch's own convention, which ``python -m mxnet_tpu_torch.launch -s
    0`` follows: it binds the store before its workers start, so no
    other process can take the port in between); then every rank joins
    as a client."""
    if _initialized():
        return
    coord = os.environ.get("MXTPU_COORDINATOR")
    try:
        nproc = int(os.environ.get("MXTPU_NUM_WORKERS", "1"))
        rank_ = int(os.environ.get("MXTPU_RANK", "0"))
    except ValueError as exc:
        raise MXNetError(
            f"MXTPU_RANK={os.environ.get('MXTPU_RANK')!r} / "
            f"MXTPU_NUM_WORKERS={os.environ.get('MXTPU_NUM_WORKERS')!r}: "
            "both must be integers") from exc
    import datetime

    timeout = barrier_timeout_s()
    timeout = datetime.timedelta(seconds=timeout if timeout > 0 else 1800)
    if not coord or nproc <= 1:
        if device is None:
            return
        td = _dist()
        td.init_process_group(mesh_backend(device, 1), store=td.HashStore(),
                              rank=0, world_size=1, timeout=timeout)
        return
    if not 0 <= rank_ < nproc:
        raise MXNetError(
            f"MXTPU_RANK={rank_} out of range for "
            f"MXTPU_NUM_WORKERS={nproc} (need 0 <= rank < num_workers); "
            "check the launcher env")
    _validate_coordinator(coord)
    backend = "gloo"
    if device is not None:
        local, local_world = _local_layout(rank_, nproc)
        backend = mesh_backend(device, local_world)
        if device == "cuda":
            import torch

            torch.cuda.set_device(local if backend == "nccl" else
                                  local % max(torch.cuda.device_count(), 1))
    _dist().init_process_group(
        backend, init_method=f"tcp://{coord}", world_size=nproc, rank=rank_,
        timeout=timeout)


def rank() -> int:
    return _dist().get_rank() if _initialized() else 0


# ---------------------------------------------- the collective dist_sync
def count_allreduce_bytes(nbytes: int):
    """Count ``nbytes`` of gradient entering a cross-process reduction
    (``dist_allreduce_bytes_total``)."""
    if _tm.enabled():
        _TM_ALLREDUCE_BYTES.inc(int(nbytes))


def _group_size(group) -> int:
    return _dist().get_world_size(group)


def all_reduce(t, group=None):
    """Sum the gradient ``t`` over ``group`` (default: the world) in
    place; returns ``t``.  Its bytes count in
    ``dist_allreduce_bytes_total``."""
    count_allreduce_bytes(t.numel() * t.element_size())
    return all_reduce_stats(t, group)


def all_reduce_stats(t, group=None):
    """Sum ``t`` (a few flags or statistics, not counted) over
    ``group`` in place; returns ``t``."""
    import torch.distributed as td

    td.all_reduce(t, group=group)
    return t


def reduce_scatter(flat, group=None):
    """This rank's block of the sum of the 1-D ``flat`` over ``group``:
    ``flat`` is cut into ``size`` equal blocks (its length must be a
    multiple of the group's size) and rank ``r`` gets the sum of every
    rank's block ``r``, a new tensor."""
    n = _group_size(group)
    if flat.dim() != 1 or flat.numel() % n:
        raise MXNetError(f"reduce_scatter: a 1-D tensor whose length is a "
                         f"multiple of {n} expected, got {tuple(flat.shape)}")
    out = flat.new_empty(flat.numel() // n)
    count_allreduce_bytes(flat.numel() * flat.element_size())
    td = _dist()
    # torch 2.13 names reduce_scatter_tensor reduce_scatter_single (the
    # old name warns); 2.11 has only the old one: one collective
    getattr(td, "reduce_scatter_single", td.reduce_scatter_tensor)(
        out, flat.contiguous(), group=group)
    return out


def all_gather(block, group=None):
    """Every rank's 1-D ``block`` of ``group``, concatenated in rank
    order: a new tensor of ``size`` times its length."""
    n = _group_size(group)
    out = block.new_empty(block.numel() * n)
    td = _dist()
    # all_gather_into_tensor under its torch 2.13 name where it has one
    getattr(td, "all_gather_single", td.all_gather_into_tensor)(
        out, block.contiguous(), group=group)
    return out


def broadcast(t, src=0, group=None):
    """``t`` on every rank of ``group`` becomes rank ``src``'s, in
    place; returns ``t``."""
    _dist().broadcast(t, src, group=group)
    return t


# ------------------------------------------------------------ exchanges
def exchange(group, sends, recvs, like):
    """One exchange among the ranks of ``group`` (keys are ranks within
    the group): this rank sends ``sends[j]`` to rank ``j`` and receives a
    tensor of shape ``recvs[j]`` from rank ``j``, in ``like``'s dtype and
    on its device.  Returns ``{j: tensor}`` for the keys of ``recvs``.
    Every rank of the group calls it, in the same order, also one with
    nothing to send or receive: it is one ``all_to_all_single`` with
    uneven splits.  A rank's own index is a local copy."""
    td = _dist()
    me = td.get_group_rank(group, td.get_rank())
    out = {}
    if me in recvs:
        out[me] = sends[me].to(like.dtype).reshape(recvs[me]).clone()
    sends = {j: t.to(like.dtype) for j, t in sends.items() if j != me}
    recvs = {j: tuple(s) for j, s in recvs.items() if j != me}
    n = td.get_world_size(group)
    in_sizes = [sends[j].numel() if j in sends else 0 for j in range(n)]
    out_sizes = [math.prod(recvs[j]) if j in recvs else 0
                 for j in range(n)]
    flat = (torch.cat([sends[j].reshape(-1) for j in sorted(sends)])
            if sends else like.new_empty(0))
    buf = like.new_empty(sum(out_sizes))
    td.all_to_all_single(buf, flat, out_sizes, in_sizes, group=group)
    for j, piece in zip(range(n), buf.split(out_sizes)):
        if j in recvs:
            out[j] = piece.view(recvs[j])
    return out


def _permute(x, group, perm):
    td = _dist()
    me = td.get_group_rank(group, td.get_rank())
    src = [s for s, d in perm if d == me]
    got = exchange(group, {d: x for s, d in perm if s == me},
                   {src[0]: x.shape} if src else {}, x)
    return got[src[0]] if src else torch.zeros_like(x)


class _PPermute(torch.autograd.Function):
    """:func:`ppermute` with its transpose as the gradient: the
    cotangents travel the inverse permutation."""

    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _permute(x, group, perm)

    @staticmethod
    def backward(ctx, grad):
        inverse = [(d, s) for s, d in ctx.perm]
        return _permute(grad, ctx.group, inverse), None, None


def ppermute(x, group, perm):
    """The reference's ``jax.lax.ppermute(x, axis, perm)`` over the
    process group of a mesh axis: ``perm`` lists ``(source, destination)``
    pairs of ranks within ``group``; a rank that is no destination
    receives zeros.  Differentiable: the gradient goes back along the
    inverse permutation.  One collective (:func:`exchange`), which
    every rank of the group calls; a world of 1 returns ``x``."""
    n = _dist().get_world_size(group)
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) < len(srcs) or len(set(dsts)) < len(dsts) or any(
            not 0 <= i < n for i in srcs + dsts):
        raise ValueError(f"ppermute: {perm} is not a permutation of a "
                         f"subset of range({n})")
    if n == 1 and perm == [(0, 0)]:
        return x
    return _PPermute.apply(x, group, perm)


def num_workers() -> int:
    return _dist().get_world_size() if _initialized() else 1


def log_prefix() -> str:
    """``"[rank/size@g<generation>] "`` while a process group spans more
    than one process, else ``""``: the identity prefix Speedometer and
    the logging reporter stamp on their lines."""
    ident = _log_identity()
    return "[%d/%d@g%d] " % ident if ident else ""


def _log_identity():
    """(rank, size, generation) of a live multi-process group, or None
    (split out so tests can fake a world)."""
    try:
        if not _initialized() or _dist().get_world_size() <= 1:
            return None
        return (_dist().get_rank(), _dist().get_world_size(), generation())
    except Exception:  # noqa: BLE001 — logging must never require dist
        return None


def is_multi_host() -> bool:
    """True when a process group spans more than one process, or the
    environment says one will (several workers and a coordinator)."""
    if _initialized():
        return _dist().get_world_size() > 1
    try:
        return (int(os.environ.get("MXTPU_NUM_WORKERS", "1")) > 1
                and bool(os.environ.get("MXTPU_COORDINATOR")))
    except ValueError:
        return False


def _world_size() -> int:
    """Indirection point for the barrier's world (tests fake a world)."""
    return num_workers()


def _sync_global_devices(name):
    """Indirection point for the barrier collective (tests substitute a
    slow one to exercise the watchdog without a second process)."""
    _dist().barrier()


def barrier(name: str = "mxtpu_barrier", timeout: float = None):
    """Cross-process rendezvous (parity: KVStore::Barrier, the
    Postoffice barrier) under a watchdog: the collective runs on a
    helper thread and the caller waits at most ``timeout`` (default
    ``MXTPU_DIST_BARRIER_TIMEOUT_S``), then raises
    :class:`HostLostError` with rank, generation and the flight record.
    The helper stays parked in the dead collective: the process is
    expected to exit with :data:`EXIT_HOST_LOST`."""
    import time

    from .. import faults as _faults

    if _world_size() <= 1:
        return
    if _faults.maybe_fail("dist_barrier"):
        # an injected drop is a dead-peer timeout without the wait
        raise HostLostError("barrier", dump=_tm.health.auto_dump("fault"),
                            detail=f"injected dist_barrier drop ({name})")
    timeout = barrier_timeout_s() if timeout is None else float(timeout)
    t0 = time.perf_counter()
    if timeout <= 0:
        _sync_global_devices(name)
    else:
        done = threading.Event()
        err = []

        def _run():
            try:
                _sync_global_devices(name)
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                err.append(exc)
            finally:
                done.set()

        t = threading.Thread(target=_run, daemon=True,
                             name=f"mxtpu-barrier[{name}]")
        t.start()
        if not done.wait(timeout):
            raise HostLostError(
                "barrier", dump=_tm.health.auto_dump("fault"),
                detail=f"barrier {name!r} timed out after {timeout:g}s "
                       "(a peer host stopped participating)")
        if err:
            raise err[0]
    if _tm.enabled():
        _TM_BARRIER_SEC.observe(time.perf_counter() - t0)


def elastic_main(fn):
    """Run one generation of an elastic worker: call ``fn()`` and turn a
    :class:`HostLostError` (membership change, dead peer, lost
    coordinator) into :data:`EXIT_HOST_LOST`.  The exit is ``os._exit``
    on purpose: after a peer's death the process group's teardown can
    park, and the state worth keeping is in the boundary checkpoint.
    Any other error after a published membership change (or with the
    coordinator lost) is a host-lost exit too: a dead peer often first
    breaks a collective before the loop reaches its next poll."""
    import sys

    def _leave(exc):
        _logger.warning("leaving generation: %s", exc)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(EXIT_HOST_LOST)

    try:
        return fn()
    except HostLostError as exc:
        _leave(exc)
    except BaseException as exc:
        try:
            from . import coordinator as _coord

            client = _coord._default_client
        except Exception:  # noqa: BLE001 — the conversion is best effort
            client = None
        if client is not None and (client.changed() or client._lost):
            _tm.health.auto_dump("fault")
            _leave(HostLostError(
                "collective", rank=client.rank,
                generation=client.generation,
                detail=f"runtime error after membership change: {exc!r}"))
        raise

"""Multi-process runtime of the port over ``torch.distributed`` (mirrors
``mxnet_tpu/parallel/dist.py``; parity: the ps-lite ``Postoffice`` role
of include/mxnet/kvstore.h:158-242: ranks, barriers, dead peers).

- :func:`init_from_env` brings up a gloo process group from the
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

The parameter-server stores (``kvstore_server.py``) need none of this to
train; NCCL and the collectives come with the mesh (ROADMAP Queue 1
item 10b).
"""
from __future__ import annotations

import logging
import os
import threading

from .. import telemetry as _tm
from ..base import MXNetError

__all__ = ["EXIT_HOST_LOST", "HostLostError", "GenerationChanged",
           "generation", "barrier_timeout_s", "init_from_env", "rank",
           "num_workers", "log_prefix", "is_multi_host", "barrier",
           "elastic_main"]

_logger = logging.getLogger("mxnet_tpu_torch.parallel.dist")

#: Process exit code for "this worker left its generation on purpose"
#: (host lost, membership changed): an elastic launcher relaunches the
#: next generation instead of counting it as a crash.
EXIT_HOST_LOST = 43

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


def init_from_env():
    """Bring up the gloo process group from the launcher's environment
    (parity: InitPSEnv, include/mxnet/kvstore.h:158-208).  A no-op for
    one process, or when a group is already up.  ``MXTPU_RANK`` must be
    an integer in ``[0, MXTPU_NUM_WORKERS)`` and ``MXTPU_COORDINATOR`` a
    ``host:port`` (rank 0 listens there), else a named error."""
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
    if not coord or nproc <= 1:
        return
    if not 0 <= rank_ < nproc:
        raise MXNetError(
            f"MXTPU_RANK={rank_} out of range for "
            f"MXTPU_NUM_WORKERS={nproc} (need 0 <= rank < num_workers); "
            "check the launcher env")
    _validate_coordinator(coord)
    import datetime

    timeout = barrier_timeout_s()
    _dist().init_process_group(
        "gloo", init_method=f"tcp://{coord}", world_size=nproc, rank=rank_,
        timeout=datetime.timedelta(seconds=timeout if timeout > 0
                                   else 1800))


def rank() -> int:
    return _dist().get_rank() if _initialized() else 0


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

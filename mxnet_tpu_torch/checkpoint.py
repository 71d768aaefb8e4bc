"""Checkpoints that survive a crash (mirrors ``mxnet_tpu/checkpoint.py``).

The survival layer under the training loops: a run loses at most one
checkpoint window to a preemption or a crash, a corrupt checkpoint falls
back to the previous complete one, and taking a snapshot does not stall
a training loop that makes no host sync a batch.

- **Capture is a device-side snapshot.**  Each tensor is cloned on the
  stream that computes it, behind the steps already queued, and an event
  is recorded after the clones; the training thread never waits.  The
  writer thread waits on that event on a stream of its own, copies the
  clones into pinned host memory and does the file IO.  (The JAX package
  dispatches a ``jnp.copy`` behind its donated steps instead.)
- **A checkpoint is complete iff its manifest says so.**  Arrays land in
  a temp directory (write, flush, fsync each file); the manifest (crc32
  of each file, shape, dtype, the bound graph's structural signature,
  the step/epoch/batch cursor, the generator state) is written last, and
  one ``os.replace`` publishes the directory.
- **Resume never trusts a file.**  :func:`latest` walks newest to
  oldest, re-hashing each array against its manifest, and falls back
  past corrupt checkpoints with a warning.

The files are the JAX package's: ``ckpt-<step>`` directories of ``.npy``
arrays and a ``manifest.json``, so either package reads what the other
writes.  Knobs (the reference's): ``MXTPU_CKPT_DIR`` arms the training
loops, ``MXTPU_CKPT_EVERY`` (steps between snapshots, default 0: only at
preemption and the end), ``MXTPU_CKPT_KEEP`` (complete checkpoints kept,
default 3).  The reference's fault-injection site ``ckpt_write`` is the
private :func:`_fault_hook` here (the fault plane is not ported); tests
replace it to make a writer fail.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import signal
import threading
import time
import zlib

import numpy as np
import torch

from . import telemetry as _tm
from .base import MXNetError

__all__ = [
    "CheckpointError", "CheckpointCorrupt", "Preempted",
    "save", "load", "latest", "list_checkpoints", "validate",
    "CheckpointWrite", "CheckpointManager", "resolve_resume",
]

_logger = logging.getLogger("mxnet_tpu_torch.checkpoint")

MANIFEST = "manifest.json"
_PREFIX = "ckpt-"
FORMAT_VERSION = 1

_TM_WRITE_SEC = _tm.histogram(
    "checkpoint_write_seconds",
    "wall time of one checkpoint write on the background writer thread "
    "(device->host copy + file IO + fsync + atomic publish)")
_TM_BYTES = _tm.counter(
    "checkpoint_bytes_total",
    "array payload bytes written into published checkpoints")
_TM_RESUME = _tm.counter(
    "checkpoint_resume_total",
    "training-state restores (status=ok: newest complete checkpoint; "
    "fallback: a newer corrupt/incomplete checkpoint was skipped first)",
    labels=("status",))


class CheckpointError(MXNetError):
    """A checkpoint write or restore failed."""


class CheckpointCorrupt(CheckpointError):
    """A checkpoint on disk fails validation (a truncated file, a
    checksum mismatch, an unreadable manifest)."""


class Preempted(MXNetError):
    """Raised by a training loop after a SIGTERM-triggered boundary
    checkpoint landed; the message names the checkpoint to resume
    from."""


def _fault_hook(site: str):
    """The reference's fault-injection site (``faults.maybe_fail``); a
    no-op here, replaced by tests to make a writer fail."""


# ------------------------------------------------------------------ env
def ckpt_dir():
    return os.environ.get("MXTPU_CKPT_DIR", "").strip() or None


def ckpt_every() -> int:
    try:
        return max(int(os.environ.get("MXTPU_CKPT_EVERY", "0") or 0), 0)
    except ValueError:
        return 0


def ckpt_keep() -> int:
    try:
        return max(int(os.environ.get("MXTPU_CKPT_KEEP", "3") or 3), 1)
    except ValueError:
        return 3


# ------------------------------------------------------------- snapshot
class _Snapshot:
    """Detached copies of the arrays of one checkpoint, taken on the
    training thread without a host sync; :meth:`host` (on the writer
    thread) waits for them and brings them to host memory."""

    def __init__(self, arrays: dict):
        self.items = {}
        self.event = None
        dev = None
        for name, v in arrays.items():
            if isinstance(v, torch.Tensor):
                # a copy ordered behind the queued steps, so the next
                # in-place update cannot change it
                c = v.detach().clone(memory_format=torch.contiguous_format)
                if c.is_cuda:
                    dev = c.device
                self.items[name] = c
            else:
                self.items[name] = np.array(v, copy=True)
        if dev is not None:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(dev))

    def host(self) -> dict:
        """``{name: numpy array}``; device copies land in pinned memory
        through a stream that waits on the capture's event."""
        out = {}
        cuda = [n for n, v in self.items.items()
                if isinstance(v, torch.Tensor) and v.is_cuda]
        if cuda:
            dev = self.items[cuda[0]].device
            stream = torch.cuda.Stream(dev)
            stream.wait_event(self.event)
            pinned = {}
            with torch.cuda.stream(stream):
                for n in cuda:
                    src = self.items[n]
                    # the allocator must not reuse the clone before the
                    # copy on this stream is done
                    src.record_stream(stream)
                    dst = torch.empty(src.shape, dtype=src.dtype,
                                      pin_memory=True)
                    dst.copy_(src, non_blocking=True)
                    pinned[n] = dst
            stream.synchronize()
            for n, dst in pinned.items():
                out[n] = _to_numpy(dst)
        for n, v in self.items.items():
            if n not in out:
                out[n] = _to_numpy(v) if isinstance(v, torch.Tensor) else v
        self.items = {}
        return out


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy; bfloat16 (which numpy lacks) is widened to
    float32."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def snapshot(arrays: dict) -> _Snapshot:
    """The device-side snapshot of ``arrays`` (tensors are cloned behind
    the queued work, numpy values copied)."""
    return _Snapshot(arrays)


def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass  # platforms without directory fsync


class CheckpointWrite:
    """The handle of one (possibly background) write: ``path`` is the
    directory it publishes, :meth:`wait` joins the writer and re-raises
    its error, :attr:`alive` says whether it still runs."""

    def __init__(self, path):
        self.path = path
        self.exc = None
        self._thread = None
        self.skipped = False

    @property
    def alive(self):
        return self._thread is not None and self._thread.is_alive()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
        if self.exc is not None:
            raise self.exc
        return self.path


def save(directory, step, arrays: dict, meta=None, keep=None,
         background=True) -> CheckpointWrite:
    """Write checkpoint ``ckpt-<step>`` under ``directory``.

    ``arrays`` maps names to tensors or numpy arrays; tensors are
    snapshotted before this returns, so the caller may go on training at
    once — the copy to the host and the file IO run on the writer thread
    when ``background``.  ``meta`` is JSON-serialisable run state.
    After a publish the oldest complete checkpoints beyond ``keep``
    (default ``MXTPU_CKPT_KEEP``) are pruned."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    keep = ckpt_keep() if keep is None else max(int(keep), 1)
    step = int(step)
    final = os.path.join(directory, f"{_PREFIX}{step:012d}")
    handle = CheckpointWrite(final)
    if os.path.isdir(final) and os.path.exists(
            os.path.join(final, MANIFEST)):
        handle.skipped = True  # this step is already published
        return handle
    snap = snapshot(arrays)
    meta = dict(meta or {})

    def _write():
        # tensors in the meta (a generator state) are encoded here, off
        # the training thread
        for k, v in list(meta.items()):
            if isinstance(v, torch.Tensor):
                meta[k] = v.numpy().tobytes().hex()
        t0 = time.perf_counter()
        tmp = os.path.join(directory,
                           f".tmp-{_PREFIX}{step:012d}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            # a failure here is a writer crash mid-checkpoint: no
            # manifest appears, so resume falls back
            _fault_hook("ckpt_write")
            host = snap.host()
            entries = {}
            total = 0
            for i, (name, a) in enumerate(sorted(host.items())):
                fname = f"a{i:05d}.npy"
                fpath = os.path.join(tmp, fname)
                with open(fpath, "wb") as f:
                    np.save(f, a, allow_pickle=False)
                    f.flush()
                    os.fsync(f.fileno())
                with open(fpath, "rb") as f:
                    crc = zlib.crc32(f.read())
                entries[name] = {
                    "file": fname,
                    "shape": list(a.shape),
                    "dtype": str(a.dtype),
                    "crc32": int(crc),
                    "bytes": int(a.nbytes),
                    "sharding": "host" if isinstance(
                        arrays.get(name), np.ndarray) else "device/1dev",
                }
                total += int(a.nbytes)
            manifest = {"version": FORMAT_VERSION, "step": step,
                        "time": time.time(), "arrays": entries,
                        "meta": meta}
            mpath = os.path.join(tmp, MANIFEST)
            with open(mpath, "w") as f:
                json.dump(manifest, f, indent=1, default=str)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(tmp)
            # one atomic publish: complete checkpoints are exactly the
            # directories holding a manifest under their final name
            if os.path.isdir(final):
                shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            _fsync_dir(directory)
            if _tm.enabled():
                _TM_BYTES.inc(total)
                _TM_WRITE_SEC.observe(time.perf_counter() - t0)
            _prune(directory, keep)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    if not background:
        _write()
        return handle

    def _runner():
        try:
            _write()
        except BaseException as e:  # noqa: BLE001 — surfaced via wait()
            handle.exc = e
            _logger.warning("background checkpoint write for step %d "
                            "failed: %r", step, e)

    t = threading.Thread(target=_runner, daemon=False,
                         name=f"mxtt-ckpt-writer-{step}")
    handle._thread = t
    t.start()
    return handle


def _prune(directory, keep):
    """Drop the oldest complete checkpoints beyond ``keep`` and other
    processes' stale temp directories."""
    complete = list_checkpoints(directory)
    for _, path in complete[:-keep] if keep else []:
        shutil.rmtree(path, ignore_errors=True)
    for name in os.listdir(directory):
        if (name.startswith(".tmp-" + _PREFIX)
                and not name.endswith(f"-{os.getpid()}")):
            shutil.rmtree(os.path.join(directory, name), ignore_errors=True)


def list_checkpoints(directory):
    """``[(step, path)]`` of the complete checkpoints (manifest present),
    oldest first; a directory without a manifest is a torn write."""
    out = []
    if not directory or not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if not name.startswith(_PREFIX):
            continue
        path = os.path.join(directory, name)
        if not os.path.exists(os.path.join(path, MANIFEST)):
            continue
        try:
            step = int(name[len(_PREFIX):])
        except ValueError:
            continue
        out.append((step, path))
    out.sort()
    return out


def validate(path) -> dict:
    """Re-hash every array file against the manifest; returns the
    manifest, or raises :class:`CheckpointCorrupt` naming the first
    offending file."""
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as exc:
        raise CheckpointCorrupt(
            f"checkpoint {path!r}: unreadable manifest: {exc}") from exc
    if manifest.get("version") != FORMAT_VERSION:
        raise CheckpointCorrupt(
            f"checkpoint {path!r}: format version "
            f"{manifest.get('version')!r} (this build reads "
            f"{FORMAT_VERSION})")
    for name, ent in manifest.get("arrays", {}).items():
        try:
            with open(os.path.join(path, ent["file"]), "rb") as f:
                crc = zlib.crc32(f.read())
        except OSError as exc:
            raise CheckpointCorrupt(
                f"checkpoint {path!r}: array {name!r} file "
                f"{ent['file']!r} unreadable: {exc}") from exc
        if crc != int(ent["crc32"]):
            raise CheckpointCorrupt(
                f"checkpoint {path!r}: array {name!r} failed its checksum "
                f"(file {ent['file']!r}) — truncated or corrupt")
    return manifest


def load(path, validate_data=True):
    """``(arrays, manifest)`` of one checkpoint, arrays as host numpy;
    ``validate_data`` re-hashes first."""
    if validate_data:
        manifest = validate(path)
    else:
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
    arrays = {name: np.load(os.path.join(path, ent["file"]),
                            allow_pickle=False)
              for name, ent in manifest.get("arrays", {}).items()}
    return arrays, manifest


def latest(directory, validate_data=True):
    """The newest checkpoint that validates, or None; a corrupt one is
    skipped with a warning (and a later resume counts a fallback)."""
    fell_back = False
    for _step, path in reversed(list_checkpoints(directory)):
        if not validate_data:
            return path
        try:
            validate(path)
            if fell_back and _tm.enabled():
                _TM_RESUME.inc(status="fallback")
            return path
        except CheckpointCorrupt as exc:
            fell_back = True
            _logger.warning(
                "skipping corrupt checkpoint %s (falling back to the "
                "previous complete one): %s", path, exc)
    return None


# -------------------------------------------------------------- manager
class CheckpointManager:
    """A training loop's checkpoint policy: the directory, the
    ``every``/``keep`` cadence, at most one background write in flight
    (a writer slower than the cadence skips a snapshot rather than
    stacking threads) and the SIGTERM flag the loops poll."""

    def __init__(self, directory, every=None, keep=None):
        if not directory:
            raise MXNetError("CheckpointManager needs a directory (set "
                             "MXTPU_CKPT_DIR or pass one)")
        self.directory = os.path.abspath(directory)
        self.every = ckpt_every() if every is None else max(int(every), 0)
        self.keep = ckpt_keep() if keep is None else max(int(keep), 1)
        self._write = None
        self._last_step = None
        self.preempted = False
        self._prev_handler = None

    @classmethod
    def from_env(cls):
        """A manager when ``MXTPU_CKPT_DIR`` is set, else None."""
        d = ckpt_dir()
        return cls(d) if d else None

    def due(self, step) -> bool:
        """Whether the loop snapshots at ``step`` (host integer math)."""
        if self.every <= 0:
            return False
        if self._last_step is not None and step <= self._last_step:
            return False
        return step % self.every == 0

    def save(self, step, arrays, meta=None, background=True):
        """Snapshot and write; a background write still running makes
        this a no-op returning None (a foreground save waits for it)."""
        if self._write is not None and self._write.alive:
            if not background:
                self._write.wait()
            else:
                _logger.warning(
                    "checkpoint writer for %s still running; skipping the "
                    "step-%d snapshot (slow storage? raise "
                    "MXTPU_CKPT_EVERY)", os.path.basename(self._write.path),
                    step)
                return None
        self._write = save(self.directory, step, arrays, meta=meta,
                           keep=self.keep, background=background)
        self._last_step = int(step)
        return self._write

    def wait(self):
        """Join the write in flight."""
        if self._write is not None:
            self._write.wait()

    def latest(self):
        return latest(self.directory)

    def install_preempt_handler(self):
        """SIGTERM sets :attr:`preempted`; the loop then saves a boundary
        checkpoint and raises :class:`Preempted`.  Chains a previous
        handler; the main thread only (False elsewhere)."""
        try:
            prev = signal.getsignal(signal.SIGTERM)

            def _handler(signum, frame):
                self.preempted = True
                _logger.warning("SIGTERM: checkpoint at the next batch "
                                "boundary, then exiting")
                if callable(prev) and prev not in (signal.SIG_DFL,
                                                   signal.SIG_IGN):
                    prev(signum, frame)

            self._prev_handler = prev
            signal.signal(signal.SIGTERM, _handler)
            return True
        except (ValueError, OSError):  # not the main thread
            return False

    def uninstall_preempt_handler(self):
        if self._prev_handler is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev_handler)
            except (ValueError, OSError):
                pass
            self._prev_handler = None


def resolve_resume(resume, manager=None):
    """A ``fit(resume=...)`` value as a checkpoint path or None:
    ``True``/``"auto"`` take the newest complete checkpoint in the
    manager's directory (or ``MXTPU_CKPT_DIR``); a path is a checkpoint
    (validated) or a directory of them (its newest complete one)."""
    if resume in (None, False):
        return None
    if resume is True or resume == "auto":
        directory = manager.directory if manager is not None else ckpt_dir()
        if not directory:
            raise MXNetError(
                "resume=True needs a checkpoint directory: set "
                "MXTPU_CKPT_DIR or pass a CheckpointManager/path")
        return latest(directory)
    path = str(resume)
    if os.path.exists(os.path.join(path, MANIFEST)):
        validate(path)
        return path
    return latest(path)


def resolve_manager(checkpoint):
    """A loop's ``checkpoint=`` value as a manager: a manager as given, a
    directory, or the environment's (``MXTPU_CKPT_DIR``), else None."""
    if isinstance(checkpoint, CheckpointManager):
        return checkpoint
    if checkpoint:
        return CheckpointManager(str(checkpoint))
    return CheckpointManager.from_env()


def generator_meta(gen: torch.Generator) -> dict:
    """The port's own generator record for a manifest (a torch stream
    cannot continue the reference's threefry key, nor the reverse): the
    state tensor (host values, no device read), hex-encoded by the
    writer."""
    return {"torch_rng": gen.get_state(),
            "torch_rng_device": str(gen.device)}


def restore_generator(gen: torch.Generator, meta: dict):
    """Put ``gen`` back to the state a manifest recorded; a checkpoint
    written by the JAX package carries a threefry key instead, so the
    generator is reseeded from the process seed with a warning."""
    state = meta.get("torch_rng")
    if state is not None:
        gen.set_state(torch.frombuffer(bytearray(bytes.fromhex(state)),
                                       dtype=torch.uint8))
        return
    if meta.get("rng_key") is not None:
        from . import random as _random

        _logger.warning(
            "checkpoint written by the JAX package: its threefry key cannot "
            "continue a torch generator; reseeding from the process seed "
            "(random ops will not replay bit for bit)")
        gen.manual_seed(_random._state["seed"])

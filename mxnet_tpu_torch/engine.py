"""Host-side waiting of the port (the async window of
``mxnet_tpu/engine.py``).

PyTorch launches CUDA work asynchronously, as PjRt dispatches, so a
training loop that never reads a value can run arbitrarily far ahead
of the card.  :class:`AsyncWindow` bounds that: each pushed step
records a CUDA event, and once more than ``depth`` steps are in flight
the host waits on the oldest event.  With fused metrics the window is
the only place the steady-state ``fit`` loop waits.

Not ported yet (ROADMAP Queue 1 item 11): the host task engine
(``push``/``new_host_var``), ``track``/``live_memory`` and the
telemetry of the waits.
"""
from __future__ import annotations

import os
from collections import deque

import torch

__all__ = ["async_depth", "AsyncWindow", "wait_for_all"]


def _engine_is_naive() -> bool:
    return os.environ.get("MXNET_ENGINE_TYPE",
                          "ThreadedEnginePerDevice") == "NaiveEngine"


def async_depth(default: int = 2) -> int:
    """``MXTPU_ASYNC_DEPTH``: how many training steps the host may run
    ahead of the card (at least 1).  ``MXNET_ENGINE_TYPE=NaiveEngine``
    forces 1."""
    try:
        depth = int(os.environ.get("MXTPU_ASYNC_DEPTH", default))
    except ValueError:
        depth = default
    if _engine_is_naive():
        return 1
    return max(1, depth)


def _cuda_device(handle):
    """The CUDA device of the first tensor in ``handle`` (a tensor, an
    NDArray or a list of them), or None when none lies on a card."""
    items = handle if isinstance(handle, (list, tuple)) else [handle]
    for h in items:
        t = getattr(h, "tensor", h)
        if isinstance(t, torch.Tensor) and t.is_cuda:
            return t.device
    return None


class AsyncWindow:
    """Bounded window of steps in flight.

    :meth:`push` takes a dispatched step's outputs and records a CUDA
    event behind them on the current stream; once more than ``depth``
    steps are in flight the host waits on the OLDEST event.  Outputs on
    the CPU are already computed and record nothing.  :meth:`drain`
    waits for everything in flight (epoch end, any boundary that needs
    the card caught up)."""

    def __init__(self, depth=None):
        self.depth = async_depth() if depth is None else max(1, int(depth))
        self._dq = deque()
        self.waits = 0  # host waits on an event, for the loops' counters

    def __len__(self):
        return len(self._dq)

    def push(self, handle):
        device = _cuda_device(handle)
        event = None
        if device is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        self._dq.append(event)
        while len(self._dq) > self.depth:
            self._wait_one()

    def _wait_one(self):
        event = self._dq.popleft()
        if event is not None:
            self.waits += 1
            event.synchronize()

    def drain(self):
        while self._dq:
            self._wait_one()


def wait_for_all():
    """Wait for every launch on every card (parity:
    ``Engine::WaitForAll``)."""
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

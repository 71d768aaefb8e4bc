"""Monitor of the port: per-tensor statistics taps during execution
(mirrors ``mxnet_tpu/monitor.py``; parity: python/mxnet/monitor.py).

:meth:`Monitor.install` sets the executor's monitor callback
(``Executor.set_monitor_callback``; parity:
GraphExecutor::SetMonitorCallback, graph_executor.cc:63): after each
inference forward and each backward the executor evaluates every internal output
of its symbol (``Symbol.get_internals``, variables included) in
inference mode and hands each ``(name, NDArray)`` to the monitor, which
keeps the statistic of each name its ``pattern`` matches, once every
``interval`` batches.  The statistic (default: the root mean square,
``norm(x) / sqrt(n)``) stays on the device until :meth:`Monitor.toc`
renders it: toc is the only read to the host, so batches outside a
monitor's window make no host sync, and run no tap at all.
"""
from __future__ import annotations

import logging
import re

from . import ndarray as nd
from .ndarray import NDArray

__all__ = ["Monitor"]


def _rms(x):
    """Default statistic: ``||x||_2 / sqrt(n)``, the root mean square."""
    return nd.norm(x) / float(max(x.size, 1)) ** 0.5


def _render(value):
    """One statistic (a scalar NDArray, a number, or a list of either)
    as its display string."""
    items = value if isinstance(value, (list, tuple)) else [value]
    parts = []
    for item in items:
        if isinstance(item, NDArray) and item.size == 1:
            item = item.asscalar()
        parts.append(str(item))
    return "\t".join(parts) + "\t"


class Monitor:
    """Tap internal outputs of installed executors.

    interval:  the window in batches (``tic`` opens every interval-th)
    stat_func: NDArray -> statistic (scalar NDArray, number or list);
               default the root mean square
    pattern:   the regex a tensor's name must match to be recorded
    sort:      order ``toc``'s rows by tensor name
    """

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        self.stat_func = stat_func if stat_func is not None else _rms
        self.interval = interval
        self.sort = sort
        self.re_prog = re.compile(pattern)
        self.activated = False
        self.step = 0
        self.exes = []
        self._records = []

    def stat_helper(self, name, array):
        """The executor callback: records while a window is open and the
        name matches."""
        if self.activated and self.re_prog.match(name):
            self._records.append((self.step, name, self.stat_func(array)))

    def install(self, exe):
        """Hook this monitor into an executor's internal-output taps."""
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def tic(self):
        """Open a recording window if this batch is due (no device
        sync: the statistics are computed on the device, read at toc)."""
        if self.step % self.interval == 0:
            self._records = []
            self.activated = True
        self.step += 1

    def toc(self):
        """Close the window; returns ``[(batch, tensor_name, stat_str)]``."""
        if not self.activated:
            return []
        self.activated = False
        taken, self._records = self._records, []
        if self.sort:
            taken.sort(key=lambda rec: rec[1])
        return [(batch, name, _render(value))
                for batch, name, value in taken]

    def toc_print(self):
        """``toc`` and log every row."""
        for batch, name, stat in self.toc():
            logging.info("Batch: %7d %30s %s", batch, name, stat)

    @property
    def queue(self):
        return self._records

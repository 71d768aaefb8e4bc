"""Probes handed to the decode workers of ``mxnet_tpu_torch.mp_io`` by
the tests, as the ``preprocess_threads`` of the workers' iterators: the
thread pool compares the count with 0 when it is made, and the probe
acts at that moment inside a real worker.  This module imports neither
JAX nor the JAX package, so a worker that loads it stays as it was."""
import json
import sys


class TouchesCuda(int):
    """A thread count of 1 that asks ``torch.cuda`` for a card when it
    is compared."""

    def __new__(cls):
        return super().__new__(cls, 1)

    def __reduce__(self):
        return (TouchesCuda, ())

    def __le__(self, other):
        import torch

        torch.cuda.is_available()
        return int(self) <= other


class RecordsModules(int):
    """A thread count of 1 that writes the worker's ``sys.modules`` (as
    a JSON list) to ``path`` when it is compared."""

    def __new__(cls, path):
        obj = super().__new__(cls, 1)
        obj.path = path
        return obj

    def __reduce__(self):
        return (RecordsModules, (self.path,))

    def __le__(self, other):
        with open(self.path, "w") as f:
            json.dump(sorted(sys.modules), f)
        return int(self) <= other

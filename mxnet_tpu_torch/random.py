"""Random state of the port (mirrors ``mxnet_tpu/random.py``).

The JAX package keeps one root PRNG key; the port keeps one seed and a
``torch.Generator`` per device, made from it on first use.  The two
packages give different numbers from the same seed: tests make their
inputs with numpy and hand them to both.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator"]

_lock = threading.Lock()
_state = {"seed": 0, "gens": {}}


def seed(seed_state: int):
    """Reseed the process: every device's generator restarts from
    ``seed_state``.  Generators are reseeded in place, so a captured
    training step that registered one keeps drawing from it."""
    with _lock:
        _state["seed"] = int(seed_state)
        for gen in _state["gens"].values():
            gen.manual_seed(_state["seed"])


def generator(device="cpu") -> torch.Generator:
    """The process generator of ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        gen = _state["gens"].get(device)
        if gen is None:
            gen = torch.Generator(device=device).manual_seed(_state["seed"])
            _state["gens"][device] = gen
        return gen

"""Random state of the port (mirrors ``mxnet_tpu/random.py``).

The JAX package keeps one root PRNG key; the port keeps one seed and a
``torch.Generator`` per device, made from it on first use.  The two
packages give different numbers from the same seed: tests make their
inputs with numpy and hand them to both.  :func:`seed` also reseeds
every granted ``kRandom`` resource (:mod:`mxnet_tpu_torch.resource`),
as the reference's does.  :func:`uniform` and :func:`normal` are the
reference's sampling front ends over the ``nd`` samplers.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["seed", "generator", "uniform", "normal"]

_lock = threading.Lock()
_state = {"seed": 0, "gens": {}}


def seed(seed_state: int):
    """Reseed the process: every device's generator restarts from
    ``seed_state``.  Generators are reseeded in place, so a captured
    training step that registered one keeps drawing from it."""
    from .resource import ResourceManager

    with _lock:
        _state["seed"] = int(seed_state)
        for gen in _state["gens"].values():
            gen.manual_seed(_state["seed"])
    ResourceManager.get().seed_random(int(seed_state))


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


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
            out=None):
    """Samples from U[low, high) (``nd.uniform``) on ``ctx`` (default:
    the card)."""
    from . import ndarray as nd

    return nd.uniform(low=low, high=high, shape=shape or (1,), dtype=dtype,
                      ctx=ctx, out=out)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None):
    """Samples from N(loc, scale^2) (``nd.normal``) on ``ctx`` (default:
    the card)."""
    from . import ndarray as nd

    return nd.normal(loc=loc, scale=scale, shape=shape or (1,), dtype=dtype,
                     ctx=ctx, out=out)

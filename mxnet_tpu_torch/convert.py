"""The weight carry: the JAX package's ``arg_params`` -> the port's tensors
(:func:`from_jax_params`), and into a port ``FusedTrainer``
(:func:`load_trainer_params`); the pytrees of the functional parallel
code (the pipeline's per-stage trees and stacked unions, the MoE
parameter dicts) -> the same trees of tensors (:func:`from_jax_tree`).

Duck-typed on purpose, so the port never imports ``mxnet_tpu``: a value
may be anything with ``.asnumpy()`` (an ``mxnet_tpu`` NDArray), anything
numpy can read through ``__array__`` (a JAX array, including bfloat16
ones), a numpy array, or a torch tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError, torch_dtype
from .context import resolve_device

__all__ = ["from_jax_params", "load_trainer_params", "from_jax_tree"]


def _to_tensor(value, dtype, device) -> torch.Tensor:
    """One parameter as a contiguous tensor of ``dtype`` on ``device``."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
    else:
        a = value.asnumpy() if hasattr(value, "asnumpy") else value
        a = np.asarray(a)
        if (a.dtype != np.float32 or not a.flags.writeable
                or not a.flags.c_contiguous):
            # float64 (the JAX side runs without x64) and bfloat16
            # (ml_dtypes, which torch cannot read) go through float32;
            # read-only views are copied before torch wraps them
            a = np.array(a, np.float32, order="C")
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype).contiguous()


def _quantized(value, dtype, device):
    """A quantized weight of either package (anything with ``.q`` and
    ``.scale``, e.g. the JAX package's ``quantize_params`` output) as the
    port's ``QuantizedTensor`` on ``device``: ``q`` stays int8 and
    ``scale`` fp32, bit for bit, never requantized."""
    from .serving.quantize import QuantizedTensor

    def tensor(a, np_dtype):
        if isinstance(a, torch.Tensor):
            return a.detach().to(device)
        return torch.from_numpy(np.array(a, np_dtype, order="C")).to(device)

    return QuantizedTensor(tensor(value.q, np.int8),
                           tensor(value.scale, np.float32), dtype=dtype,
                           axis=getattr(value, "axis", 0))


def from_jax_params(arg_params, dtype=torch.float32, device=None):
    """``{name: value}`` -> ``{name: tensor}`` in ``dtype`` on ``device``
    (default: the card; pass ``device="cpu"`` for the host).  A quantized
    value (``.q`` and ``.scale``) comes across as a ``QuantizedTensor``
    dequantizing to ``dtype``."""
    dtype = torch_dtype(dtype)
    device = resolve_device(device)
    return {k: (_quantized(v, dtype, device)
                if hasattr(v, "q") and hasattr(v, "scale")
                else _to_tensor(v, dtype, device))
            for k, v in arg_params.items()}


def load_trainer_params(trainer, arg_params, aux_params=None):
    """Load ``{name: value}`` (the JAX trainer's ``params``, numpy arrays,
    NDArrays, tensors) into an initialised port ``FusedTrainer`` as its
    fp32 masters, in place, and rebuild its compute-dtype copy.  Every
    parameter of the trainer must be given, with its shape; the
    optimizer state is left as it is."""
    from .parallel import mesh as _mesh

    for kind, have, given in (("param", trainer.params, arg_params),
                              ("aux state", trainer.aux, aux_params or {})):
        missing = sorted(set(have) - set(given))
        if missing:
            raise MXNetError(f"load_trainer_params: no value for {kind}s "
                             f"{missing[:5]}")
        for name, dst in have.items():
            src = _to_tensor(given[name], torch.float32, dst.device)
            if src.shape != dst.shape:
                raise MXNetError(f"load_trainer_params: {name} has shape "
                                 f"{tuple(src.shape)}, the trainer "
                                 f"{tuple(dst.shape)}")
            # a DTensor (a trainer on a mesh) takes its own block
            _mesh.copy_full_into(dst, src)
    trainer._refresh_compute_cache()
    return trainer


def _leaf_dtype(value):
    """The torch dtype of a leaf's values: its own (bfloat16 for
    ml_dtypes' bfloat16, which numpy reports as kind "V")."""
    if isinstance(value, torch.Tensor):
        return value.dtype
    a = np.asarray(value)
    if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, a.dtype)).dtype


def from_jax_tree(tree, dtype=None, device=None):
    """A pytree of the JAX package (nested dicts, lists and tuples of JAX
    or numpy arrays) -> the same tree of tensors on ``device`` (default:
    the card), in ``dtype`` (default: each leaf's own).  Dict keys, and
    with them a stacked union's ``keystr`` path strings
    (``"['blocks']['q_w']"``), stay as they are, so results compare by
    key; a dict keeps its order (JAX sorts keys when it flattens: compare
    by path, never by position)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: from_jax_tree(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(from_jax_tree(v, dtype, device) for v in tree)
    want = torch_dtype(dtype) if dtype is not None else _leaf_dtype(tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device=device, dtype=want).contiguous()
    a = np.asarray(tree)
    if want.is_floating_point:
        return _to_tensor(a, want, device)
    return torch.from_numpy(np.array(a, order="C")).to(device=device,
                                                       dtype=want)

"""Verification utilities of the port (mirrors ``mxnet_tpu/test_utils.py``;
parity: python/mxnet/test_utils.py).

``check_symbolic_forward``/``check_symbolic_backward`` hold a symbol's
outputs and gradients against numpy expectations;
``check_numeric_gradient`` against central finite differences (the
scalar loss is the sum of the outputs); ``check_consistency`` runs one
symbol on several contexts (the reference's cpu-vs-gpu harness:
``[{"ctx": mx.cpu(), ...}, {"ctx": mx.gpu(), ...}]``) from the same
seeded inputs and cross-checks outputs and gradients; ``check_speed``
times forward and backward.  The tolerances default by dtype
(:func:`default_tols`).  ``get_synthetic_mnist`` gives the JAX
package's arrays for the same seed (numpy's ``RandomState``).

The executors bind torch tensors: values go in through ``copy_`` and
come out through :func:`_np` (bfloat16 widened to float32).  The
default context is :func:`~.context.current_context` (the card, or the
``with mx.Context(...)`` scope's).
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from . import ndarray as nd
from . import random as _random
from .context import current_context

__all__ = ["default_context", "default_tols", "check_symbolic_forward",
           "check_symbolic_backward", "check_numeric_gradient",
           "check_consistency", "check_speed", "rand_ndarray", "same",
           "almost_equal", "assert_almost_equal", "get_synthetic_mnist"]


def default_context():
    return current_context()


# per-dtype (rtol, atol): bf16 carries ~8 mantissa bits (relative
# rounding ~2^-9), fp16 ~11 (the reference's check_consistency tables)
_DTYPE_RTOL_ATOL = {
    np.dtype(np.float64): (1e-7, 1e-9),
    np.dtype(np.float32): (1e-5, 1e-8),
    np.dtype(np.float16): (1e-2, 1e-3),
}


def _tols_for_dtype(dtype):
    """(rtol, atol) for one dtype; None for non-floats."""
    if dtype is None:
        return None
    if "bfloat16" in str(dtype):
        return 3e-2, 1e-2
    if isinstance(dtype, torch.dtype):
        dtype = torch.empty(0, dtype=dtype).numpy().dtype
    try:
        return _DTYPE_RTOL_ATOL.get(np.dtype(dtype))
    except TypeError:
        return None


def default_tols(*arrays, rtol=None, atol=None):
    """(rtol, atol) for comparing ``arrays``: explicit values win, else
    the widest tolerance among the operands' dtypes."""
    if rtol is not None and atol is not None:
        return rtol, atol
    pick_r, pick_a = _DTYPE_RTOL_ATOL[np.dtype(np.float32)]
    for a in arrays:
        tols = _tols_for_dtype(getattr(a, "dtype", None))
        if tols is not None and tols[0] > pick_r:
            pick_r, pick_a = tols
    return (rtol if rtol is not None else pick_r,
            atol if atol is not None else pick_a)


def _np(value) -> np.ndarray:
    """A tensor, NDArray or array-like as numpy (bfloat16 as float32)."""
    if isinstance(value, nd.NDArray):
        value = value.tensor
    if isinstance(value, torch.Tensor):
        value = value.detach()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.cpu().numpy()
    return np.asarray(value)


def _set(dst: torch.Tensor, value):
    dst.copy_(torch.from_numpy(np.ascontiguousarray(value,
                                                    dtype=np.float32)))


def _as_numpy_dict(symbol, location):
    if isinstance(location, dict):
        return {k: np.asarray(v, dtype=np.float32)
                for k, v in location.items()}
    return {k: np.asarray(v, dtype=np.float32)
            for k, v in zip(symbol.list_arguments(), location)}


def _bind_with(symbol, location, aux=None, grad_req="write", ctx=None):
    ctx = ctx or default_context()
    ex = symbol.simple_bind(ctx, grad_req=grad_req,
                            **{k: v.shape for k, v in location.items()})
    for k, v in location.items():
        _set(ex.arg_dict[k], v)
    for k, v in (aux or {}).items():
        _set(ex.aux_dict[k], v)
    return ex


def _ones_like(outputs):
    return [torch.ones_like(o) for o in outputs]


def check_symbolic_forward(sym, location, expected, rtol=1e-4, atol=1e-5,
                           aux_states=None, ctx=None):
    """The inference outputs at ``location`` (a dict or a list in
    argument order) against ``expected``; returns them as numpy."""
    location = _as_numpy_dict(sym, location)
    ex = _bind_with(sym, location, aux_states, grad_req="null", ctx=ctx)
    outputs = ex.forward(is_train=False)
    if isinstance(expected, (list, tuple)):
        pairs = zip(outputs, expected)
    else:
        pairs = [(outputs[0], expected)]
    for out, exp in pairs:
        np.testing.assert_allclose(_np(out), exp, rtol=rtol, atol=atol)
    return [_np(o) for o in outputs]


def check_symbolic_backward(sym, location, out_grads, expected, rtol=1e-4,
                            atol=1e-5, aux_states=None, grad_req="write",
                            ctx=None):
    """The gradients at ``location`` for head gradients ``out_grads``
    (None: ones) against ``expected`` (a dict by name, or a list in
    argument order with None to skip); returns every gradient."""
    location = _as_numpy_dict(sym, location)
    ex = _bind_with(sym, location, aux_states, grad_req=grad_req, ctx=ctx)
    outs = ex.forward(is_train=True)
    og = None
    if out_grads is not None:
        og = [torch.from_numpy(np.asarray(g, dtype=np.float32)).to(o.device)
              for g, o in zip(out_grads, outs)]
    ex.backward(og)
    if isinstance(expected, dict):
        items = expected.items()
    else:
        items = zip(sym.list_arguments(), expected)
    for name, exp in items:
        if exp is None:
            continue
        np.testing.assert_allclose(_np(ex.grad_dict[name]), exp,
                                   rtol=rtol, atol=atol, err_msg=name)
    return {k: _np(v) for k, v in ex.grad_dict.items()}


def check_numeric_gradient(sym, location, aux_states=None, numeric_eps=1e-3,
                           rtol=1e-2, atol=None, grad_nodes=None, ctx=None):
    """The backward's gradients (all-ones heads: the scalar loss is the
    sum of the outputs) against central finite differences."""
    location = _as_numpy_dict(sym, location)
    grad_nodes = grad_nodes or list(location.keys())
    ex = _bind_with(sym, location, aux_states, grad_req="write", ctx=ctx)
    outs = ex.forward(is_train=True)
    ex.backward(_ones_like(outs))
    analytic = {k: _np(ex.grad_dict[k]).copy() for k in grad_nodes
                if k in ex.grad_dict}

    def loss_at(loc):
        ex2 = _bind_with(sym, loc, aux_states, grad_req="null", ctx=ctx)
        return sum(float(_np(o).sum()) for o in ex2.forward(is_train=True))

    for name in grad_nodes:
        if name not in analytic:
            continue
        base = location[name]
        num_grad = np.zeros_like(base)
        flat = base.reshape(-1)
        ng = num_grad.reshape(-1)
        for i in range(flat.size):
            orig = flat[i]
            flat[i] = orig + numeric_eps
            lp = loss_at(location)
            flat[i] = orig - numeric_eps
            lm = loss_at(location)
            flat[i] = orig
            ng[i] = (lp - lm) / (2 * numeric_eps)
        np.testing.assert_allclose(analytic[name], num_grad, rtol=rtol,
                                   atol=atol or 1e-2, err_msg=name)


def check_consistency(sym, ctx_list, scale=1.0, rtol=None, atol=None,
                      arg_params=None, amp=None):
    """Run ``sym`` on every context of ``ctx_list`` (dicts of ``ctx``,
    the input shapes and an optional ``type_dict``) from the same
    seeded inputs (``arg_params`` overrides some) and cross-check the
    outputs and gradients against the first.  ``amp`` sets
    ``MXTPU_AMP`` for the run; with rtol/atol left None a low-precision
    run compares at bf16 tolerance, else at 1e-3/1e-4."""
    low_prec = amp is not None and str(amp) not in ("0", "off", "False")
    for spec in ctx_list:
        for dt in (spec.get("type_dict") or {}).values():
            if "float16" in str(np.dtype(dt) if dt is not None else ""):
                low_prec = True
    if rtol is None and atol is None and low_prec:
        rtol, atol = 3e-2, 1e-2
    elif rtol is None or atol is None:
        rtol = 1e-3 if rtol is None else rtol
        atol = 1e-4 if atol is None else atol

    prev_amp = os.environ.get("MXTPU_AMP")
    if amp is not None:
        os.environ["MXTPU_AMP"] = str(amp)
    try:
        results = []
        for spec in ctx_list:
            shapes = {k: v for k, v in spec.items()
                      if k not in ("ctx", "type_dict")}
            _random.seed(0)
            ex = sym.simple_bind(spec["ctx"], grad_req="write",
                                 type_dict=spec.get("type_dict"), **shapes)
            rs = np.random.RandomState(0)
            for k in sorted(ex.arg_dict):
                dst = ex.arg_dict[k]
                if arg_params and k in arg_params:
                    val = np.asarray(arg_params[k], np.float32)
                else:
                    val = (rs.standard_normal(tuple(dst.shape))
                           * scale).astype(np.float32)
                dst.copy_(torch.from_numpy(val))
            outs = ex.forward(is_train=True)
            ex.backward(_ones_like(outs))
            results.append(([_np(o) for o in ex.outputs],
                            {k: _np(v) for k, v in ex.grad_dict.items()}))
    finally:
        if amp is not None:
            if prev_amp is None:
                os.environ.pop("MXTPU_AMP", None)
            else:
                os.environ["MXTPU_AMP"] = prev_amp
    ref_outs, ref_grads = results[0]
    for outs, grads in results[1:]:
        for a, b in zip(ref_outs, outs):
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(b, np.float64),
                                       rtol=rtol, atol=atol)
        for k in ref_grads:
            np.testing.assert_allclose(np.asarray(ref_grads[k], np.float64),
                                       np.asarray(grads[k], np.float64),
                                       rtol=rtol, atol=atol, err_msg=k)
    return results


def _wait(ex):
    if ex.device.type == "cuda":
        torch.cuda.synchronize(ex.device)


def check_speed(sym, location=None, ctx=None, n=20, grad_req="write",
                **shapes):
    """Seconds per forward and backward (after one warm-up), ending in
    a device sync."""
    ctx = ctx or default_context()
    if location is None:
        ex = sym.simple_bind(ctx, grad_req=grad_req, **shapes)
        rs = np.random.RandomState(0)
        for k, dst in ex.arg_dict.items():
            dst.copy_(torch.from_numpy(
                rs.standard_normal(tuple(dst.shape)).astype(np.float32)))
    else:
        ex = _bind_with(sym, _as_numpy_dict(sym, location),
                        grad_req=grad_req, ctx=ctx)
    ex.forward(is_train=True)
    ex.backward()
    _wait(ex)
    tic = time.time()
    for _ in range(n):
        ex.forward(is_train=True)
        ex.backward()
    _wait(ex)
    return (time.time() - tic) / n


def rand_ndarray(shape, ctx=None):
    return nd.array(np.random.uniform(-1, 1, shape).astype(np.float32),
                    ctx=ctx)


def same(a, b):
    return np.array_equal(_np(a), _np(b))


def almost_equal(a, b, rtol=None, atol=None):
    rtol, atol = default_tols(a, b, rtol=rtol, atol=atol)
    return np.allclose(_np(a).astype(np.float64), _np(b).astype(np.float64),
                       rtol=rtol, atol=atol)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b")):
    """With rtol/atol left None the tolerances come from the operands'
    dtypes (:func:`default_tols`)."""
    rtol, atol = default_tols(a, b, rtol=rtol, atol=atol)
    np.testing.assert_allclose(_np(a).astype(np.float64),
                               _np(b).astype(np.float64),
                               rtol=rtol, atol=atol)


def get_synthetic_mnist(num_train=512, num_test=128, seed=7):
    """A deterministic MNIST-like dataset: each class lights a distinct
    6x6 block of a 1x28x28 image, plus noise, so small models reach
    high accuracy within a few epochs; the JAX package's arrays for the
    same seed."""
    rs = np.random.RandomState(seed)
    n = num_train + num_test
    labels = rs.randint(0, 10, size=n)
    images = np.zeros((n, 1, 28, 28), dtype=np.float32)
    for i, lab in enumerate(labels):
        r, c = divmod(int(lab), 5)
        images[i, 0, 2 + r * 13:8 + r * 13, 1 + c * 5:7 + c * 5] = 1.0
    images += rs.uniform(0, 0.3, images.shape).astype(np.float32)
    x_train, x_test = images[:num_train], images[num_train:]
    y_train = labels[:num_train].astype(np.float32)
    y_test = labels[num_train:].astype(np.float32)
    return (x_train, y_train), (x_test, y_test)

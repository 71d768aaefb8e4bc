"""The port's elementwise ops against the JAX package's, on the CPU:
every name that ``mxnet_tpu_torch/ops/elemwise.py`` ports beyond the
operators ``NDArray`` dispatched to before — the unary math table,
``Cast``, ``BlockGrad``, ``_copy``, ``_maximum``/``_minimum``/``_hypot``/
``_power`` and their aliases, ``_grad_add``, ``smooth_l1``, the
broadcast forms, ``broadcast_axis``, ``ElementWiseSum``, ``clip``,
``softmax``, ``log_softmax`` — and the scalar forms whose gradient
follows JAX's rules, forward and gradient (a seeded cotangent through
``jax.vjp`` and ``torch.autograd.grad``), in fp32 and bf16.

The inputs hold the points where the two libraries' derivatives part:
``abs`` and ``sign`` at 0, ``maximum``/``minimum`` at ties (both split
the cotangent 0.5/0.5), ``clip`` on its bounds (half the cotangent, as
``jnp.clip`` is a maximum then a minimum), ``power`` at a zero base
(JAX's ``y * x**(y - 1)``, NaN at 0**0), ``round``/``rint`` at halves
(half to even in both), ``gamma`` at negative x (``exp(gammaln)``
drops the sign in both) and ``hypot`` at the origin (JAX's formula,
``max * sqrt(1 + (min / max)**2)`` guarded at 0, gives each side half
the cotangent where torch's ``hypot`` gives NaN).

Tolerances: fp32 ``rtol 2e-5, atol 1e-6`` (the transcendental functions
of the two libraries differ by a few ulp); bf16 ``rtol 2e-2, atol
2e-2``: each side rounds every intermediate to bf16 (8 mantissa bits,
a relative step of 2^-8), so results may differ by a couple of bf16
steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu import ops as jops

from mxnet_tpu_torch.ops import registry as treg

TOL = {"float32": (2e-5, 1e-6), "bfloat16": (2e-2, 2e-2)}
DTYPES = ["float32", "bfloat16"]
SHAPE = (3, 8)


def _u(seed, lo, hi, shape=SHAPE):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _with(a, edges):
    """``a`` with its first entries replaced by ``edges``."""
    a = a.copy()
    a.flat[:len(edges)] = edges
    return a


def _unary(lo, hi, edges=()):
    return lambda seed: [_with(_u(seed, lo, hi), edges)]


# input domains of the unary table (default: -2..2 with a 0 in it)
_DOMAIN = {
    "arccos": (-0.9, 0.9), "arcsin": (-0.9, 0.9), "arctanh": (-0.9, 0.9),
    "arccosh": (1.1, 3.0), "log": (0.1, 3.0), "log10": (0.1, 3.0),
    "log2": (0.1, 3.0), "log1p": (-0.5, 3.0), "sqrt": (0.1, 3.0),
    "rsqrt": (0.1, 3.0), "tan": (-1.2, 1.2), "gammaln": (0.2, 4.0),
}
_HALVES = (0.5, 1.5, 2.5, -0.5, -1.5, 0.0, 1.0)
_EDGES = {"abs": (0.0, 1.0, -1.0), "sign": (0.0, 1.0, -1.0),
          "round": _HALVES, "rint": _HALVES, "relu": (0.0,),
          "gamma": (-0.5, -1.5, -2.5, 0.5, 1.5, 3.7),
          "fix": (-1.5, 1.5), "floor": (-1.0,), "ceil": (1.0,),
          "gammaln": (1.0, 2.0)}
_UNARY = ["abs", "arccos", "arccosh", "arcsin", "arcsinh", "arctan",
          "arctanh", "ceil", "cos", "cosh", "degrees", "exp", "expm1", "fix",
          "floor", "gamma", "gammaln", "log", "log10", "log1p", "log2",
          "negative", "radians", "rint", "round", "rsqrt", "sign", "sin",
          "sinh", "sqrt", "square", "tan", "tanh", "sigmoid", "relu"]

_TIES = (0.0, 1.0, -1.0, 0.5)


def _pair_ties(lo, hi, shape=SHAPE):
    """Two operands equal at their first entries (ties)."""
    def make(seed):
        a, b = _u(seed, lo, hi, shape), _u(seed + 1, lo, hi, shape)
        return [_with(a, _TIES), _with(b, _TIES)]
    return make


def _power_pair(seed):
    base = _with(_u(seed, 0.2, 2.0), (0.0, 0.0, 1.0))
    expo = _with(_u(seed + 1, -1.0, 2.5), (2.0, 0.0, 0.0))
    return [base, expo]


def _bcast(lo, hi):
    return lambda seed: [_u(seed, lo, hi, (3, 1)), _u(seed + 1, lo, hi,
                                                      (1, 8))]


# name -> (make inputs from a seed, attrs)
CASES = {n: (_unary(*_DOMAIN.get(n, (-2.0, 2.0)),
                    _EDGES.get(n, () if n in _DOMAIN else (0.0,))), {})
         for n in _UNARY}
CASES.update({
    "_copy": (_unary(-2, 2), {}),
    "identity": (_unary(-2, 2), {}),
    "BlockGrad": (_unary(-2, 2), {}),
    "stop_gradient": (_unary(-2, 2), {}),
    "Cast": (_unary(-2, 2), {"dtype": "cast-to-other"}),
    "cast": (_unary(-2, 2), {"dtype": "float16"}),
    "_maximum": (_pair_ties(-2, 2), {}),
    "_Maximum": (_pair_ties(-2, 2), {}),
    "_minimum": (_pair_ties(-2, 2), {}),
    "_Minimum": (_pair_ties(-2, 2), {}),
    "_hypot": (_pair_ties(0.3, 2), {}),
    "_power": (_power_pair, {}),
    "_Power": (_power_pair, {}),
    "_grad_add": (_pair_ties(-2, 2), {}),
    "smooth_l1": (_unary(-3, 3, (0.0, 0.2, -0.2, 1.0)), {"scalar": 2.0}),
    "broadcast_power": (_bcast(0.3, 2.0), {}),
    "broadcast_maximum": (_bcast(-2, 2), {}),
    "broadcast_minimum": (_bcast(-2, 2), {}),
    "broadcast_hypot": (_bcast(0.3, 2), {}),
    "broadcast_plus": (_bcast(-2, 2), {}),
    "broadcast_minus": (_bcast(-2, 2), {}),
    "broadcast_axis": (lambda s: [_u(s, -2, 2, (3, 1, 4))],
                       {"axis": 1, "size": 5}),
    "broadcast_axes": (lambda s: [_u(s, -2, 2, (1, 4, 1))],
                       {"axis": (0, 2), "size": (2, 3)}),
    "ElementWiseSum": (lambda s: [_u(s + i, -2, 2) for i in range(3)],
                       {"num_args": 3}),
    "add_n": (lambda s: [_u(s + i, -2, 2) for i in range(2)], {}),
    "_sum": (lambda s: [_u(s + i, -2, 2) for i in range(4)], {}),
    "clip": (_unary(-2, 2, (-0.5, 1.0, -2.0, 2.0, 0.0)),
             {"a_min": -0.5, "a_max": 1.0}),
    "softmax": (lambda s: [_u(s, -3, 3, (2, 3, 5))], {"axis": 1}),
    "log_softmax": (_unary(-3, 3), {}),
    "_maximum_scalar": (_unary(-2, 2, _TIES), {"scalar": 0.5}),
    "_minimum_scalar": (_unary(-2, 2, _TIES), {"scalar": 0.5}),
    "_hypot_scalar": (_unary(-2, 2, _TIES), {"scalar": 0.5}),
    "_power_scalar": (_unary(0.2, 2, (0.0, 1.0)), {"scalar": 2.0}),
    "_rpower_scalar": (_unary(-2, 2, (0.0, 1.0)), {"scalar": 1.5}),
})


def _jax_run(name, xs, attrs, cot_seed):
    fn = jops.get(name).fn
    ctx = jops.OpCtx(is_train=True)
    out, vjp = jax.vjp(lambda *a: fn(ctx, *a, **attrs), *xs)
    cot = jnp.asarray(_u(cot_seed, -1, 1, out.shape), out.dtype)
    return out, vjp(cot), cot


def _port_run(name, xs, attrs, cot):
    ts = [x.clone().requires_grad_(True) for x in xs]
    out = treg.get(name).fn(treg.OpCtx(is_train=True), *ts, **attrs)
    if not out.requires_grad:     # BlockGrad: no graph, zero gradients
        return out, [torch.zeros_like(t) for t in ts]
    grads = torch.autograd.grad(out, ts, cot.to(out.dtype),
                                allow_unused=True)
    return out, [torch.zeros_like(t) if g is None else g
                 for t, g in zip(ts, grads)]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_elemwise_op_matches_jax(name, dtype):
    make, attrs = CASES[name]
    attrs = dict(attrs)
    if attrs.get("dtype") == "cast-to-other":
        attrs["dtype"] = "float32" if dtype == "bfloat16" else "bfloat16"
    xs = make(7)
    jxs = [jnp.asarray(x, jnp.dtype(dtype)) for x in xs]
    txs = [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs]
    jout, jgrads, cot = _jax_run(name, jxs, attrs, 11)
    tout, tgrads = _port_run(name, txs, attrs, torch.from_numpy(_f32(cot)))
    assert str(tout.dtype).replace("torch.", "") == str(jout.dtype)
    assert tuple(tout.shape) == jout.shape
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(_f32(tout), _f32(jout), rtol=rtol, atol=atol,
                               err_msg=f"{name} forward")
    for i, (tg, jg) in enumerate(zip(tgrads, jgrads)):
        assert tg.dtype == txs[i].dtype
        np.testing.assert_allclose(_f32(tg), _f32(jg), rtol=rtol, atol=atol,
                                   err_msg=f"{name} gradient of input {i}")


def test_every_jax_elemwise_name_is_registered():
    """The JAX module's registry names are all in the port's registry,
    with the same input names."""
    from mxnet_tpu.ops import elemwise as jew

    names = set(jew._UNARY) | set(jew._SCALAR) | set(jew._BROADCAST) | {
        "_copy", "identity", "BlockGrad", "stop_gradient", "Cast", "cast",
        "_grad_add", "smooth_l1", "broadcast_axis", "broadcast_axes",
        "broadcast_to", "ElementWiseSum", "add_n", "_sum", "clip",
        "softmax", "log_softmax"} | set(jew._BINARY) | set(jew._LOGIC)
    for aliases in jew._BINARY_ALIASES.values():
        names |= set(aliases)
    for n in sorted(names):
        assert tuple(treg.get(n).arg_names) == tuple(jops.get(n).arg_names), n
    assert treg.get("ElementWiseSum").varargs


def test_cast_keeps_channels_last_and_identity():
    w = torch.randn(4, 3, 2, 2).contiguous(memory_format=torch.channels_last)
    out = treg.get("Cast").fn(treg.OpCtx(), w, dtype="bfloat16")
    assert out.dtype == torch.bfloat16
    assert out.is_contiguous(memory_format=torch.channels_last)
    # a cast to the dtype a tensor already has is the tensor itself
    assert treg.get("Cast").fn(treg.OpCtx(), w, dtype="float32") is w


def test_creation_ops_match_jax():
    for name, attrs in (("_zeros", {"shape": (2, 3)}),
                        ("_ones", {"shape": (4,), "dtype": "bfloat16"}),
                        ("_full", {"shape": (2, 2), "value": 1.5}),
                        ("_set_value", {"shape": (3,), "src": -2.0}),
                        ("_arange", {"start": 1, "stop": 7, "step": 2,
                                     "repeat": 2})):
        want = jops.get(name).fn(jops.OpCtx(), **attrs)
        got = treg.get(name).fn(treg.OpCtx(device=torch.device("cpu")),
                                **attrs)
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        np.testing.assert_array_equal(_f32(got), _f32(want), err_msg=name)

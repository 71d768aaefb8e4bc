"""The port's vision ops against the JAX package's, on the CPU:
``Convolution`` (stride / pad / dilate / group / bias), ``BatchNorm``
(eval, train with the aux update, ``fix_gamma``, ``use_global_stats``),
``Pooling`` (max / avg / sum, global, valid / full, padded avg, and
1-D and 3-D), ``Flatten``, and BatchNorm's
``MXTPU_BN_STATS_DTYPE=compute`` moments.

Each case runs in two layouts: NCHW on both sides, and the JAX op under
its layout pass's attr ``__layout__="NHWC"`` on NHWC data against the
port's op on the same logical NCHW tensor in channels-last memory (the
port's form of that pass).  fp32 throughout,
with ``MXTPU_CONV_PRECISION=float32`` so the JAX convolution runs in
true fp32 (its default is one reduced-precision pass).  Tolerance 1e-5:
the same fp32 arithmetic summed in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu  # noqa: F401  (registers the JAX ops)
from mxnet_tpu import ops as jops

from mxnet_tpu_torch.ops import registry as treg

TOL = 1e-5
LAYOUTS = ["NCHW", "channels_last"]


@pytest.fixture(autouse=True)
def _fp32_convs(monkeypatch):
    monkeypatch.setenv("MXTPU_CONV_PRECISION", "float32")


def _n(seed, *shape):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


def _nhwc(a):
    return np.ascontiguousarray(a.transpose(0, 2, 3, 1))


def _run(name, inputs, attrs, layout, is_train=False):
    """(jax result, port result) of op ``name``; the first input is the
    4-D activation, given NCHW.  Outputs come back as NCHW numpy, with
    any aux pair as numpy."""
    ins = list(inputs)
    jins = list(ins)
    jattrs = dict(attrs)
    ts = [torch.from_numpy(np.array(a)) for a in ins]
    if layout == "channels_last":
        if ins[0].ndim == 4 and name != "Flatten":
            jins[0] = _nhwc(ins[0])
            jattrs["__layout__"] = "NHWC"
        ts[0] = ts[0].contiguous(memory_format=torch.channels_last)
    jres = jops.get(name).fn(jops.OpCtx(is_train=is_train),
                             *map(jnp.asarray, jins), **jattrs)
    tres = treg.get(name).fn(treg.OpCtx(is_train=is_train), *ts, **attrs)

    def out_np(j, t):
        j, t = np.asarray(j), t.detach().numpy()
        if "__layout__" in jattrs and j.ndim == 4:
            j = j.transpose(0, 3, 1, 2)
        return j, t

    if isinstance(jres, tuple):
        (jo, ja), (to, ta) = jres, tres
        return out_np(jo, to), [(np.asarray(a), b.detach().numpy())
                                for a, b in zip(ja, ta)]
    return out_np(jres, tres), []


def _check(pair, aux=(), tol=TOL):
    j, t = pair
    assert j.shape == t.shape
    np.testing.assert_allclose(t, j, rtol=tol, atol=tol)
    for a, b in aux:
        np.testing.assert_allclose(b, a, rtol=tol, atol=tol)


CONV_CASES = [
    # (data NCHW, weight OIHW, attrs, with bias)
    ((2, 3, 9, 9), (4, 3, 3, 3), {"kernel": (3, 3), "num_filter": 4}, True),
    ((2, 4, 10, 8), (6, 4, 3, 3), {"kernel": "(3, 3)", "num_filter": "6",
                                   "stride": "(2, 2)", "pad": "(1, 1)",
                                   "no_bias": "True"}, False),
    ((1, 3, 11, 11), (5, 3, 3, 3), {"kernel": (3, 3), "num_filter": 5,
                                    "dilate": (2, 2), "pad": (2, 2)}, True),
    ((2, 6, 7, 7), (9, 2, 3, 3), {"kernel": (3, 3), "num_filter": 9,
                                  "num_group": 3, "pad": (1, 1),
                                  "no_bias": True}, False),
    ((2, 8, 6, 6), (16, 8, 1, 1), {"kernel": (1, 1), "num_filter": 16,
                                   "stride": (2, 2), "no_bias": True}, False),
    ((2, 3, 16, 16), (8, 3, 7, 7), {"kernel": (7, 7), "num_filter": 8,
                                    "stride": (2, 2), "pad": (3, 3),
                                    "no_bias": True}, False),
]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", range(len(CONV_CASES)))
def test_convolution_matches_jax(case, layout):
    dshape, wshape, attrs, with_bias = CONV_CASES[case]
    ins = [_n(1, *dshape), _n(2, *wshape) * 0.3]
    if with_bias:
        ins.append(_n(3, wshape[0]))
    _check(*_run("Convolution", ins, attrs, layout))


def test_convolution_infers_the_weight_shape():
    from mxnet_tpu_torch import symbol as tsym

    net = tsym.Convolution(tsym.Variable("data"), kernel=(3, 3),
                           num_filter=6, num_group=2, name="c")
    args, outs, _ = net.infer_shape(data=(2, 4, 8, 8))
    assert dict(zip(net.list_arguments(), args)) == {
        "data": (2, 4, 8, 8), "c_weight": (6, 2, 3, 3), "c_bias": (6,)}
    assert outs == [(2, 6, 6, 6)]


def _bn_inputs(c, seed):
    rng = np.random.RandomState(seed)
    x = rng.normal(0.3, 1.5, (2, c, 5, 4)).astype(np.float32)
    return [x, rng.uniform(0.5, 1.5, c).astype(np.float32),
            rng.uniform(-0.5, 0.5, c).astype(np.float32),
            rng.uniform(-0.2, 0.2, c).astype(np.float32),
            rng.uniform(0.5, 1.5, c).astype(np.float32)]


BN_ATTRS = [
    {"fix_gamma": False, "eps": 2e-5, "momentum": 0.9},   # ResNet's BNs
    {"fix_gamma": True, "eps": 2e-5},                     # bn_data
    {},                                                   # the defaults
    {"fix_gamma": "False", "use_global_stats": "True", "momentum": "0.8"},
]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("is_train", [False, True])
@pytest.mark.parametrize("attrs", BN_ATTRS)
def test_batch_norm_matches_jax(attrs, is_train, layout):
    ins = _bn_inputs(6, 4)
    out, aux = _run("BatchNorm", ins, attrs, layout, is_train)
    _check(out, aux)
    if not is_train or "use_global_stats" in attrs:
        for (a, b), given in zip(aux, ins[3:]):
            np.testing.assert_array_equal(b, given)
    else:  # the update moved the stats
        assert not np.allclose(aux[0][1], ins[3])


def test_batch_norm_bf16_eval_matches_jax():
    """The Predictor's bf16 BatchNorm: data, params and stats bf16.  The
    port rounds each of the four ops (sub, mul, mul, add) to bf16; XLA on
    the CPU computes the fused chain in fp32 and rounds once.  Four
    roundings of 2^-8 relative each: 2^-6 bounds them (measured: 2
    ulps at magnitude 2-4)."""
    import ml_dtypes

    bf = ml_dtypes.bfloat16
    ins = [a.astype(bf) for a in _bn_inputs(8, 5)]
    attrs = {"fix_gamma": False, "eps": 2e-5}
    jo, _ = jops.get("BatchNorm").fn(jops.OpCtx(is_train=False),
                                     *map(jnp.asarray, ins), **attrs)
    ts = [torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
          for a in ins]
    to, _ = treg.get("BatchNorm").fn(treg.OpCtx(is_train=False), *ts,
                                     **attrs)
    assert to.dtype == torch.bfloat16
    w = np.asarray(jo).astype(np.float32)
    np.testing.assert_allclose(to.float().numpy(), w, rtol=2 ** -6,
                               atol=2 ** -6)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("attrs", BN_ATTRS[:3])
def test_batch_norm_compute_stats_knob_matches_jax(monkeypatch, attrs,
                                                  layout):
    """``MXTPU_BN_STATS_DTYPE=compute``: the moments shifted by the
    moving mean, fp32 sums; the same output and aux update as JAX."""
    monkeypatch.setenv("MXTPU_BN_STATS_DTYPE", "compute")
    out, aux = _run("BatchNorm", _bn_inputs(6, 4), attrs, layout, True)
    _check(out, aux)


def test_batch_norm_compute_stats_knob_bf16_matches_jax(monkeypatch):
    """bf16 data under the knob with fp32 moving stats (the AMP case):
    the shift is the moving mean rounded to bf16, and that rounded value
    is what both packages add back, so the updated stats agree to fp32
    summation order (1e-5); the bf16 output to 2e-2 (a few bf16
    roundings)."""
    import ml_dtypes

    monkeypatch.setenv("MXTPU_BN_STATS_DTYPE", "compute")
    bf = ml_dtypes.bfloat16
    ins = _bn_inputs(8, 6)
    ins[0] = ins[0] + np.float32(3.0)  # |mean| well above the std
    ins[3] = ins[3] + np.float32(3.1)
    attrs = {"fix_gamma": False, "eps": 2e-5}
    jins = [jnp.asarray(a.astype(bf)) if i < 3 else jnp.asarray(a)
            for i, a in enumerate(ins)]
    jo, ja = jops.get("BatchNorm").fn(jops.OpCtx(is_train=True), *jins,
                                      **attrs)
    ts = [torch.from_numpy(a.astype(bf).astype(np.float32)).bfloat16()
          if i < 3 else torch.from_numpy(a) for i, a in enumerate(ins)]
    to, ta = treg.get("BatchNorm").fn(treg.OpCtx(is_train=True), *ts,
                                      **attrs)
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().numpy(),
                               np.asarray(jo).astype(np.float32),
                               rtol=2e-2, atol=2e-2)
    for a, b in zip(ja, ta):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-5)


POOL_CASES = [
    {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "pool_type": "max"},
    {"kernel": (2, 2), "stride": (2, 2), "pool_type": "max"},
    {"kernel": (3, 3), "stride": (2, 2), "pool_type": "max",
     "pooling_convention": "full"},
    {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "pool_type": "avg"},
    {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "pool_type": "avg",
     "pooling_convention": "full"},
    {"kernel": (2, 3), "stride": (1, 2), "pool_type": "sum"},
    {"kernel": (3, 3), "stride": (1, 1), "pad": (2, 2), "pool_type": "max"},
    {"kernel": (7, 7), "global_pool": True, "pool_type": "avg"},
    {"kernel": (1, 1), "global_pool": "True", "pool_type": "max"},
    {"kernel": "(3, 3)", "stride": "(3, 3)", "pool_type": "sum",
     "pooling_convention": "full"},
]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("case", range(len(POOL_CASES)))
def test_pooling_matches_jax(case, layout):
    _check(*_run("Pooling", [_n(7, 2, 3, 10, 9)], POOL_CASES[case], layout))


OTHER_RANK_POOLS = [
    ((2, 3, 11), {"kernel": (3,), "stride": (2,), "pool_type": "max"}),
    ((2, 3, 10), {"kernel": (4,), "stride": (3,), "pad": (1,),
                  "pool_type": "avg", "pooling_convention": "full"}),
    ((1, 2, 5, 6, 7), {"kernel": (3, 3, 3), "stride": (2, 2, 2),
                       "pad": (1, 1, 1), "pool_type": "max"}),
    ((1, 2, 4, 6, 5), {"kernel": (1, 1, 1), "global_pool": True,
                       "pool_type": "sum"}),
]


@pytest.mark.parametrize("case", range(len(OTHER_RANK_POOLS)))
def test_pooling_other_ranks_match_jax(case):
    shape, attrs = OTHER_RANK_POOLS[case]
    _check(*_run("Pooling", [_n(7, *shape)], attrs, "NCHW"))


@pytest.mark.parametrize("layout", ["NCHW", "channels_last"])
def test_flatten_matches_jax(layout):
    _check(*_run("Flatten", [_n(8, 2, 3, 4, 5)], {}, layout))


def test_slice_matches_jax():
    x = _n(9, 2, 4, 6, 6)
    attrs = {"begin": (None, None, 0, 1), "end": (None, None, 3, 6)}
    want = jops.get("slice").fn(jops.OpCtx(), jnp.asarray(x), **attrs)
    got = treg.get("slice").fn(treg.OpCtx(), torch.from_numpy(x), **attrs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

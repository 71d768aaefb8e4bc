"""The rest of the port's Predictor against the JAX package's, on the CPU:
``output_index`` (by int, by name, by list) and ``partial_forward``,
``forward_async``/``get_async``/``discard_async``, and int8 weights
(``quantize="int8"`` and ``MXTPU_PREDICT_INT8``).

The net is small: a 3x3 convolution with a BatchNorm (which the Conv+BN
fold folds, so the cut must come before it), a relu, a
FullyConnected head and a softmax, data 4 x 3 x 8 x 8; weights from a
numpy seed, handed to both packages.  The JAX side runs its
convolutions in true fp32 (``MXTPU_CONV_PRECISION=float32``).
Tolerances: fp32 outputs of the two libraries agree to ~1e-7 here;
1e-5 holds them.  int8: both packages dequantize the same bit-equal
``q`` and ``scale`` in fp32, so the int8 outputs agree to the same
1e-5.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import symbol as jsym
from mxnet_tpu.predict import Predictor as JPredictor

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.predict import MAX_IN_FLIGHT, Predictor
from mxnet_tpu_torch.predict import create as tcreate

SHAPE = (4, 3, 8, 8)
TOL = 1e-5


@pytest.fixture(autouse=True)
def _fp32_convs(monkeypatch):
    monkeypatch.setenv("MXTPU_CONV_PRECISION", "float32")
    monkeypatch.delenv("MXTPU_PREDICT_INT8", raising=False)
    monkeypatch.delenv("MXTPU_PREDICT_DTYPE", raising=False)


def _net(s):
    data = s.Variable("data")
    c = s.Convolution(data, num_filter=8, kernel=(3, 3), pad=(1, 1),
                      name="conv0")
    b = s.BatchNorm(c, fix_gamma=False, name="bn0")
    r = s.Activation(b, act_type="relu", name="relu0")
    f = s.FullyConnected(s.Flatten(r), num_hidden=5, name="fc1")
    return s.SoftmaxOutput(f, name="softmax")


@pytest.fixture(scope="module")
def params():
    rs = np.random.RandomState(0)
    arg = {"conv0_weight": rs.normal(0, 0.3, (8, 3, 3, 3)),
           "conv0_bias": rs.normal(0, 0.1, (8,)),
           "bn0_gamma": rs.uniform(0.8, 1.2, (8,)),
           "bn0_beta": rs.uniform(-0.1, 0.1, (8,)),
           "fc1_weight": rs.normal(0, 0.05, (5, 512)),
           "fc1_bias": rs.normal(0, 0.1, (5,))}
    aux = {"bn0_moving_mean": rs.uniform(-0.1, 0.1, (8,)),
           "bn0_moving_var": rs.uniform(0.75, 1.25, (8,))}
    x = rs.normal(size=SHAPE)
    f32 = lambda d: {k: v.astype(np.float32) for k, v in d.items()}  # noqa
    return f32(arg), f32(aux), x.astype(np.float32)


def _jax(params, **kw):
    arg, aux, _ = params
    return JPredictor(symbol=_net(jsym),
                      arg_params={k: jmx.nd.array(v) for k, v in arg.items()},
                      aux_params={k: jmx.nd.array(v) for k, v in aux.items()},
                      input_shapes={"data": SHAPE}, **kw)


def _port(params, **kw):
    arg, aux, _ = params
    return Predictor(symbol=_net(tsym), arg_params=arg, aux_params=aux,
                     input_shapes={"data": SHAPE}, dev_type="cpu", **kw)


def _outs(p, x):
    p.forward(data=x)
    return [p.get_output(i) for i in range(p.num_outputs)]


# ------------------------------------------------------------ output_index
@pytest.mark.parametrize("sel", [
    3, "relu0_output", ["conv0_output", "fc1_output"], ["bn0_output", 4],
    -1,
], ids=["int", "name", "names", "mixed", "last"])
def test_output_index_matches_jax(params, sel):
    """The cut picks the same internals in both packages (the names and
    indices of the unfolded graph) and computes the same values."""
    x = params[2]
    j, t = _jax(params, output_index=sel), _port(params, output_index=sel)
    assert t.symbol.list_outputs() == j.symbol.list_outputs()
    got, want = _outs(t, x), _outs(j, x)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("step", [0, 3, 5, 10_000])
def test_partial_forward_matches_jax(params, step):
    x = params[2]
    j, t = _jax(params), _port(params)
    _outs(j, x)
    _outs(t, x)
    got, want = t.partial_forward(step), j.partial_forward(step)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)


def test_partial_forward_at_a_variable_returns_its_value(params):
    """The JAX Predictor binds the cut with the input shapes only, so a
    step that names a weight or the label fails there ("Shapes must be
    1D sequences"); the port binds every argument's shape and returns
    the bound value: the folded conv weight, the zero label."""
    x = params[2]
    t = _port(params)
    _outs(t, x)
    names = t.symbol.get_internals().list_outputs()
    w = t.partial_forward(names.index("conv0_weight"))[0]
    np.testing.assert_array_equal(
        w, t._exec.arg_dict["conv0_weight"].numpy())
    lab = t.partial_forward(names.index("softmax_label"))[0]
    np.testing.assert_array_equal(lab, np.zeros(SHAPE[0], np.float32))


# ----------------------------------------------------------- forward_async
def test_forward_async_pipeline_equals_forward(params):
    """Four tickets in flight, joined out of order, each equal to its own
    ``forward``; a fetched output cannot be fetched again, and
    ``get_output`` reads the latest forward."""
    p = _port(params)
    rs = np.random.RandomState(1)
    xs = [rs.normal(size=SHAPE).astype(np.float32) for _ in range(4)]
    want = [_outs(p, x)[0] for x in xs]
    tickets = [p.forward_async(data=x) for x in xs]
    for i in (2, 0, 3, 1):
        np.testing.assert_array_equal(p.get_async(tickets[i]), want[i])
    with pytest.raises(MXNetError, match="already-retired"):
        p.get_async(tickets[0])
    np.testing.assert_array_equal(p.get_output(0), want[3])
    # a multi-output ticket retires with its last output
    q = _port(params, output_index=["relu0_output", "fc1_output"])
    t = q.forward_async(data=xs[0])
    q.get_async(t, 1)
    with pytest.raises(MXNetError, match="already fetched"):
        q.get_async(t, 1)
    assert q.get_async(t, 0).shape == (4, 8, 8, 8)
    assert t not in q._inflight


def test_discard_and_in_flight_bound(params):
    p = _port(params)
    x = params[2]
    t = p.forward_async(data=x)
    p.discard_async(t)
    with pytest.raises(MXNetError):
        p.get_async(t)
    p.discard_async(12345)                   # unknown ticket: a no-op
    tickets = [p.forward_async(data=x) for _ in range(MAX_IN_FLIGHT + 6)]
    assert len(p._inflight) == MAX_IN_FLIGHT == 64
    with pytest.raises(MXNetError):
        p.get_async(tickets[0])              # evicted, oldest first
    assert p.get_async(tickets[-1]).shape == (4, 5)


# -------------------------------------------------------------------- int8
def test_predictor_int8_quantize_parity(params, tmp_path, monkeypatch):
    """``tests/test_predict.py::test_predictor_int8_quantize_parity``
    against the JAX package: the fold happens first, the quantized
    weights' ``q`` and ``scale`` are bit-equal to the JAX Predictor's,
    the device keeps them as int8 (their fp32 copies move to the host),
    and the outputs equal the JAX int8 outputs (the same dequantization
    in fp32) and stay near the fp32 ones; ``MXTPU_PREDICT_INT8=1`` and
    ``create(quantize=)`` take the same route."""
    x = params[2]
    j8, t8 = _jax(params, quantize="int8"), _port(params, quantize="int8")
    assert sorted(t8._qparams) == sorted(j8._qparams) \
        == ["conv0_weight", "fc1_weight"]
    for k, qt in t8._qparams.items():
        jq, js = j8._qparams[k]
        assert qt.q.dtype == torch.int8
        np.testing.assert_array_equal(qt.q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(js))
        assert k not in t8._params
        assert t8._exec.arg_dict[k].device.type == "cpu"
    o8 = _outs(t8, x)[0]
    np.testing.assert_allclose(o8, _outs(j8, x)[0], rtol=TOL, atol=TOL)
    o32 = _outs(_port(params), x)[0]
    assert np.allclose(o8.sum(1), 1.0, atol=1e-5)
    assert np.abs(o8 - o32).max() < 0.02
    monkeypatch.setenv("MXTPU_PREDICT_INT8", "1")
    penv = _port(params)
    assert penv._quantize == "int8"
    np.testing.assert_array_equal(_outs(penv, x)[0], o8)
    monkeypatch.delenv("MXTPU_PREDICT_INT8")
    # reshape keeps the int8 route
    penv.reshape({"data": (2,) + SHAPE[1:]})
    assert sorted(penv._qparams) == ["conv0_weight", "fc1_weight"]
    np.testing.assert_array_equal(_outs(penv, x[:2])[0], o8[:2])
    arg, aux, _ = params
    jmx.model.save_checkpoint(
        str(tmp_path / "m"), 1, _net(jsym),
        {k: jmx.nd.array(v) for k, v in arg.items()},
        {k: jmx.nd.array(v) for k, v in aux.items()})
    pc = tcreate(str(tmp_path / "m"), 1, {"data": SHAPE}, dev_type="cpu",
                 quantize="int8")
    np.testing.assert_array_equal(_outs(pc, x)[0], o8)


def test_predictor_int8_bf16_matches_jax(params):
    """int8 storage with bf16 compute: both packages dequantize in bf16;
    the libraries round their bf16 ops differently, so 2e-2 on the
    probabilities (the bf16 Predictor test's tolerance)."""
    x = params[2]
    j = _jax(params, quantize="int8", dtype="bfloat16")
    t = _port(params, quantize="int8", dtype="bfloat16")
    assert all(qt.dtype == torch.bfloat16 for qt in t._qparams.values())
    np.testing.assert_allclose(_outs(t, x)[0], _outs(j, x)[0], atol=2e-2)


def test_int8_cut_and_partial_forward(params):
    """``output_index`` and ``partial_forward`` compose with int8: the
    cut graph's weights are quantized, and ``partial_forward`` reads the
    fp32 weights (as the JAX Predictor's does)."""
    x = params[2]
    j = _jax(params, quantize="int8", output_index="fc1_output")
    t = _port(params, quantize="int8", output_index="fc1_output")
    np.testing.assert_allclose(_outs(t, x)[0], _outs(j, x)[0], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(t.partial_forward(100)[0],
                               j.partial_forward(100)[0], rtol=TOL,
                               atol=TOL)


def test_port_module_names_the_new_surface():
    assert mx.predict.MAX_IN_FLIGHT == 64

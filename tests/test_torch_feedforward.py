"""The port's ``FeedForward`` and ``DataParallelExecutorManager`` against
the JAX package's, on the CPU.

Mirrors ``tests/test_module.py::test_feedforward_api`` and
``tests/test_predict.py::test_executor_manager_train_step``; then holds
the port's ``FeedForward`` against the JAX one from the same parameters
(handed across as numpy, the two initializers draw differently): ``fit``
over numpy arrays under one numpy seed (the same shuffles), ``score``
and ``predict``, within 1e-5 (fp32, relative to each array's norm for
the parameters, absolute for probabilities); checkpoints written by
either package's ``save`` and read by the other's ``load``; the numpy
route's ``discard`` (training) and ``pad`` (inference) last batches;
``create``; the ``Uniform(0.01)`` default by its bounds; and the
manager's refusal of several devices (ROADMAP Queue 1 item 10).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.test_utils import get_synthetic_mnist

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import ndarray as nd
from mxnet_tpu_torch import symbol as sym

TOL = 1e-5


def _mlp(s, hidden=16):
    net = s.Flatten(s.Variable("data"))
    net = s.FullyConnected(net, name="fc1", num_hidden=hidden)
    net = s.Activation(net, act_type="relu")
    net = s.FullyConnected(net, name="fc2", num_hidden=10)
    return s.SoftmaxOutput(net, name="softmax")


def _np(v):
    return v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _params(seed=0, hidden=16):
    rs = np.random.RandomState(seed)
    return {"fc1_weight": rs.randn(hidden, 784).astype(np.float32) * 0.05,
            "fc1_bias": np.zeros(hidden, np.float32),
            "fc2_weight": rs.randn(10, hidden).astype(np.float32) * 0.1,
            "fc2_bias": np.zeros(10, np.float32)}


def _pair(**kw):
    """A JAX and a port FeedForward over the same MLP and parameters."""
    arg = _params()
    jm = jmx.model.FeedForward(_mlp(jmx.symbol), ctx=jmx.cpu(),
                               arg_params={k: jmx.nd.array(v)
                                           for k, v in arg.items()},
                               aux_params={}, **kw)
    tm = mx.model.FeedForward(_mlp(sym), ctx=mx.cpu(),
                              arg_params=dict(arg), aux_params={}, **kw)
    return jm, tm


# ------------------------------------------------ the reference's tests
def test_feedforward_api():
    (xtr, ytr), (xte, yte) = get_synthetic_mnist(512, 64)
    model = mx.model.FeedForward(_mlp(sym, 128), ctx=mx.cpu(), num_epoch=5,
                                 learning_rate=0.5, numpy_batch_size=64)
    model.fit(xtr, ytr)
    acc = model.score(xte, yte)
    assert acc > 0.9
    preds = model.predict(xte)
    assert preds.shape == (64, 10)


def test_executor_manager_train_step():
    from mxnet_tpu_torch.executor_manager import DataParallelExecutorManager

    def mlp():
        net = sym.FullyConnected(sym.Variable("data"), name="fc1",
                                 num_hidden=16)
        net = sym.Activation(net, act_type="relu")
        net = sym.FullyConnected(net, name="fc2", num_hidden=2)
        return sym.SoftmaxOutput(net, name="softmax")

    rs = np.random.RandomState(0)
    x = rs.uniform(size=(64, 8)).astype(np.float32)
    y = (x.sum(axis=1) > 4).astype(np.float32)
    it = mx.io.NDArrayIter(x, y, batch_size=32, label_name="softmax_label")
    # the port's cpu(i) is the one host device: one executor
    mgr = DataParallelExecutorManager(mlp(), [mx.cpu(0), mx.cpu(1)], it)

    arg_params, aux_params = {}, {}
    init = mx.init.Uniform(0.1)
    shapes = dict(zip(mgr.execgrp.arg_names,
                      mlp().infer_shape(data=(32, 8))[0]))
    for name in mgr.param_names:
        arr = nd.zeros(shapes[name], ctx="cpu")
        init(name, arr)
        arg_params[name] = arr
    mgr.set_params(arg_params, aux_params)

    metric = mx.metric.create("acc")
    it.reset()
    batch = next(it)
    mgr.load_data_batch(batch)
    mgr.forward(is_train=True)
    mgr.backward()
    assert all(g[0] is not None for g in mgr.grad_arrays)
    metric.reset()
    mgr.update_metric(metric, batch.label)
    assert 0.0 <= metric.get()[1] <= 1.0

    out_params, out_aux = {}, {}
    mgr.copy_to(out_params, out_aux)
    assert set(out_params) == set(mgr.param_names)


# ------------------------------------------- against the JAX FeedForward
def test_fit_score_predict_match_jax():
    (xtr, ytr), (xte, yte) = get_synthetic_mnist(96, 40, seed=3)
    jm, tm = _pair(num_epoch=2, learning_rate=0.1, numpy_batch_size=16,
                   momentum=0.9)
    for m in (jm, tm):
        np.random.seed(11)            # the same shuffles in both
        m.fit(xtr, ytr)
    for k in jm.arg_params:
        err = _rel(_np(tm.arg_params[k]), _np(jm.arg_params[k]))
        assert err <= TOL, (k, err)
    assert tm.score(xte, yte) == jm.score(xte, yte)
    np.testing.assert_allclose(tm.predict(xte), jm.predict(xte), atol=TOL)


def _jax_predict(m, x, y):
    """The JAX FeedForward's predict on ``x``: its Module is bound first
    by a ``fit`` of no epoch (``num_epoch == begin_epoch``), because its
    predict without one counts the label as a missing parameter and
    raises; the port's binds the label as an input (as MXNet's
    ``_init_predictor`` does)."""
    m.num_epoch = m.begin_epoch
    m.fit(x, y)
    return m.predict(x)


def test_predict_from_given_params_matches_jax():
    (_, _), (xte, yte) = get_synthetic_mnist(8, 37, seed=4)
    jm, tm = _pair(numpy_batch_size=16)
    got, want = tm.predict(xte), _jax_predict(jm, xte, yte)
    assert got.shape == want.shape == (37, 10)
    np.testing.assert_allclose(got, want, atol=TOL)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_and_load_cross_the_packages(tmp_path, writer):
    (_, _), (xte, yte) = get_synthetic_mnist(8, 24, seed=5)
    jm, tm = _pair(numpy_batch_size=8)
    prefix = str(tmp_path / "ff")
    (tm if writer == "port" else jm).save(prefix, 3)
    jl = jmx.model.FeedForward.load(prefix, 3, ctx=jmx.cpu(),
                                    numpy_batch_size=8)
    tl = mx.model.FeedForward.load(prefix, 3, ctx=mx.cpu(),
                                   numpy_batch_size=8)
    assert tl.begin_epoch == 3
    want = tm.predict(xte)
    np.testing.assert_allclose(_jax_predict(jm, xte, yte), want, atol=TOL)
    np.testing.assert_allclose(tl.predict(xte), want, atol=TOL)
    np.testing.assert_allclose(_jax_predict(jl, xte, yte), want, atol=TOL)


def test_numpy_route_discards_in_training_and_pads_in_inference():
    (x, y), _ = get_synthetic_mnist(70, 1, seed=6)
    model = mx.model.FeedForward(_mlp(sym), ctx=mx.cpu(), num_epoch=1,
                                 numpy_batch_size=32,
                                 arg_params=_params(), aux_params={})
    train = model._init_iter(x, y, is_train=True)
    assert train.batch_size == 32 and len(list(train)) == 2
    infer = model._init_iter(x, None, is_train=False)
    pads = [b.pad for b in infer]
    assert len(pads) == 3 and pads[-1] == 3 * 32 - 70
    assert model.predict(x).shape == (70, 10)
    assert model.predict(nd.array(x[:5], ctx="cpu")).shape == (5, 10)
    with pytest.raises(TypeError):
        model.predict([1, 2, 3])


def test_create_fits_and_default_initializer_is_uniform_001():
    (x, y), _ = get_synthetic_mnist(32, 1, seed=7)
    model = mx.model.FeedForward.create(_mlp(sym), x, y, ctx=mx.cpu(),
                                        num_epoch=0, numpy_batch_size=16)
    assert isinstance(model.initializer, mx.init.Uniform)
    for k, v in model.arg_params.items():
        a = _np(v)
        assert np.abs(a).max() <= 0.01, k
        if k.endswith("_weight"):
            assert np.abs(a).max() > 0.005, k


def test_manager_refuses_several_devices():
    from mxnet_tpu_torch.executor_manager import DataParallelExecutorManager

    it = mx.io.NDArrayIter(np.zeros((4, 3), np.float32),
                           np.zeros(4, np.float32), batch_size=2)
    net = sym.SoftmaxOutput(sym.FullyConnected(sym.Variable("data"),
                                               num_hidden=2, name="fc"),
                            name="softmax")
    with pytest.raises(MXNetError, match="item 10"):
        DataParallelExecutorManager(net, [mx.cpu(), torch.device("cuda", 0)],
                                    it)
    with pytest.raises(MXNetError, match="work load"):
        DataParallelExecutorManager(net, [mx.cpu()], it,
                                    work_load_list=[1, 1])

"""The rest of the port's Module path against the JAX package, on the
CPU: ``SequentialModule`` (the chain of
``examples/module/sequential_module.py``) and ``PythonLossModule`` from
the same weights over 3 batches, ``Monitor`` rows against the JAX
``Monitor``'s on the same batch, ``fit(monitor=)`` (rows on the window
batches only, host syncs that do not grow with the batch count),
``Symbol.get_internals``, and the initializers ``Orthogonal`` (by its
property), ``Bilinear``, ``Load``, ``Mixed`` and a variable's own
``__init__`` attr (exact).

Inputs and weights come from numpy seeds and go to both packages.
Tolerances: parameters after 3 SGD steps 1e-5 relative (fp32 GEMMs of
two libraries), monitor statistics 1e-6 relative; the rest is exact.
"""
import logging
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import initializer as jinit
from mxnet_tpu import symbol as jsym
from mxnet_tpu.module.python_module import PythonLossModule as JLoss

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.module import PythonLossModule as TLoss

CPU = "cpu"


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _data(n=150, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.uniform(0, 1, (n, 32)).astype(np.float32)
    w = rs.normal(size=(32, 5)).astype(np.float32)
    return x, (x @ w).argmax(axis=1).astype(np.float32)


def _batches(mx, x, y, batch=50):
    it = mx.io.NDArrayIter(x, y, batch_size=batch)
    return list(it)


def _trunk(s):
    return s.Activation(s.FullyConnected(s.Variable("data"), name="fc1",
                                         num_hidden=64),
                        name="relu1", act_type="relu")


def _head(s):
    return s.SoftmaxOutput(s.FullyConnected(s.Variable("fc1_output"),
                                            name="fc2", num_hidden=5),
                           name="softmax")


def _weights(seed=1):
    rs = np.random.RandomState(seed)
    return {"fc1_weight": rs.normal(0, 0.2, (64, 32)).astype(np.float32),
            "fc1_bias": rs.normal(0, 0.1, (64,)).astype(np.float32),
            "fc2_weight": rs.normal(0, 0.2, (5, 64)).astype(np.float32),
            "fc2_bias": rs.normal(0, 0.1, (5,)).astype(np.float32)}


def _close(a, b, rtol):
    for k in a:
        got, want = _np(a[k]), _np(b[k])
        scale = max(np.abs(want).max(), 1e-12)
        assert np.abs(got - want).max() <= rtol * scale, k


# ------------------------------------------------------ SequentialModule
def _sequential(mx, sym, head=None, **ctx):
    m1 = mx.mod.Module(_trunk(sym), label_names=[], **ctx)
    seq = mx.mod.SequentialModule()
    seq.add(m1)
    if head is None:
        seq.add(mx.mod.Module(_head(sym), data_names=["fc1_output"], **ctx),
                take_labels=True, auto_wiring=True)
    else:
        seq.add(head, take_labels=True)
    return seq


def _train(seq, mx, batches, weights, kvstore="local"):
    seq.bind(data_shapes=[("data", (50, 32))],
             label_shapes=[("softmax_label", (50,))])
    seq.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in weights.items()})
    seq.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params={"learning_rate": 0.2,
                                         "momentum": 0.9})
    metric = mx.metric.Accuracy()
    for b in batches:
        seq.forward_backward(b)
        seq.update()
        seq.update_metric(metric, b.label)
    return seq.get_params()[0], _np(seq.get_outputs()[0]), metric.get()


def test_sequential_module_like_jax():
    x, y = _data()
    w = _weights()
    jarg, jout, jacc = _train(_sequential(jmx, jsym, context=jmx.cpu()), jmx,
                              _batches(jmx, x, y), w)
    targ, tout, tacc = _train(_sequential(tmx, tsym, context=tmx.cpu()), tmx,
                              _batches(tmx, x, y), w)
    assert sorted(targ) == sorted(jarg) == sorted(w)
    _close(targ, jarg, 1e-5)
    np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-6)
    assert tacc == jacc


def test_sequential_module_wiring_and_input_grads():
    x, y = _data(50)
    seq = _sequential(tmx, tsym, context=tmx.cpu())
    assert seq.data_names == ["data"] and seq.output_names == [
        "softmax_output"]
    seq.bind(data_shapes=[("data", (50, 32))],
             label_shapes=[("softmax_label", (50,))], inputs_need_grad=True)
    m1, m2 = seq._modules
    assert m2.inputs_need_grad and m1.inputs_need_grad
    assert m2.data_shapes == [("fc1_output", (50, 64))]
    assert m1.label_shapes is None
    seq.init_params(arg_params=_weights())
    seq.forward_backward(_batches(tmx, x, y)[0])
    g = seq.get_input_grads()[0].asnumpy()
    assert g.shape == (50, 32) and np.abs(g).max() > 0


def test_sequential_module_fit_and_score():
    x, y = _data(1000)
    seq = _sequential(tmx, tsym, context=tmx.cpu())
    train = tio.NDArrayIter(x, y, batch_size=50, shuffle=True)
    seq.fit(train, optimizer="sgd",
            optimizer_params={"learning_rate": 0.2}, num_epoch=3,
            initializer=tinit.Xavier())
    (_, acc), = seq.score(train, "acc")
    assert acc > 0.5
    arg, aux = seq.get_params()
    assert sorted(arg) == sorted(_weights()) and aux == {}


def _softmax_grad(labels, scores):
    s = _np(scores)
    p = np.exp(s - s.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    p[np.arange(len(p)), _np(labels).astype(int)] -= 1.0
    return p


def _fc_head(s):
    return s.FullyConnected(s.Variable("fc1_output"), name="fc2",
                            num_hidden=5)


def test_python_loss_module_chain_like_jax():
    x, y = _data()
    w = _weights()
    out = []
    for mx, sym, loss in ((jmx, jsym, JLoss), (tmx, tsym, TLoss)):
        seq = mx.mod.SequentialModule()
        seq.add(mx.mod.Module(_trunk(sym), label_names=[],
                              context=mx.cpu()))
        seq.add(mx.mod.Module(_fc_head(sym), data_names=["fc1_output"],
                              label_names=[], context=mx.cpu()))
        seq.add(loss(grad_func=_softmax_grad), take_labels=True)
        out.append(_train(seq, mx, _batches(mx, x, y), w))
    _close(out[1][0], out[0][0], 1e-5)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-5, atol=1e-6)
    assert out[1][2] == out[0][2]


def test_python_module_surface():
    loss = TLoss(name="l")
    loss.bind(data_shapes=[("data", (4, 3))],
              label_shapes=[("softmax_label", (4,))])
    assert loss.output_shapes == [("l_output", (4, 3))]
    assert loss.get_params() == ({}, {})
    loss.init_params()
    loss.init_optimizer()
    assert loss.params_initialized and loss.optimizer_initialized
    scores = tnd.array(np.zeros((4, 3)), ctx=CPU)
    labels = tnd.array(np.array([0, 1, 2, 0]), ctx=CPU)
    loss.forward(tio.DataBatch([scores], [labels]), is_train=True)
    with pytest.raises(NotImplementedError):
        loss.backward()
    loss._grad_func = lambda lab, sc: torch.ones(4, 3)
    loss.backward()
    assert loss.get_input_grads()[0].shape == (4, 3)
    loss._grad_func = _softmax_grad
    loss.backward()
    assert loss.get_input_grads()[0].context == torch.device("cpu")
    with pytest.raises(NotImplementedError):
        tmx.mod.PythonModule(["data"], None, ["out"]).bind(
            [("data", (2,))])


# ---------------------------------------------------------------- Monitor
def _mlp(s):
    net = s.FullyConnected(s.Variable("data"), name="fc1", num_hidden=16)
    net = s.Activation(net, name="relu1", act_type="relu")
    net = s.FullyConnected(net, name="fc2", num_hidden=5)
    return s.SoftmaxOutput(net, name="softmax")


def _mlp_weights():
    rs = np.random.RandomState(2)
    return {"fc1_weight": rs.normal(0, 0.3, (16, 32)).astype(np.float32),
            "fc1_bias": rs.normal(0, 0.1, (16,)).astype(np.float32),
            "fc2_weight": rs.normal(0, 0.3, (5, 16)).astype(np.float32),
            "fc2_bias": rs.normal(0, 0.1, (5,)).astype(np.float32)}


@pytest.mark.parametrize("pattern,sort", [(".*", False), (".*weight", True),
                                          ("fc2_.*", False)])
def test_monitor_rows_like_jax(pattern, sort):
    x, y = _data(50)
    rows = []
    for mx, sym in ((jmx, jsym), (tmx, tsym)):
        mod = mx.mod.Module(_mlp(sym), context=mx.cpu())
        mod.bind(data_shapes=[("data", (50, 32))],
                 label_shapes=[("softmax_label", (50,))])
        mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                    for k, v in _mlp_weights().items()})
        mon = mx.mon.Monitor(1, pattern=pattern, sort=sort)
        mod.install_monitor(mon)
        mon.tic()
        mod.forward_backward(_batches(mx, x, y)[0])
        rows.append(mon.toc())
    jrows, trows = rows
    assert [(b, n) for b, n, _ in trows] == [(b, n) for b, n, _ in jrows]
    assert len(trows) > 0
    for (_, name, ts), (_, _, js) in zip(trows, jrows):
        t, j = float(ts.split("\t")[0]), float(js.split("\t")[0])
        assert abs(t - j) <= 1e-6 * max(abs(j), 1e-6), (name, t, j)


def test_get_internals_like_jax():
    jnet = _mlp(jsym)
    tnet = tsym.load_json(jnet.tojson())
    assert (tnet.get_internals().list_outputs()
            == jnet.get_internals().list_outputs())


def test_monitor_custom_stat_and_the_window():
    mon = tmx.Monitor(3, stat_func=lambda a: [a.shape[0], 2.0])
    exe = tsym.load_json(_mlp(jsym).tojson()).simple_bind(
        ctx=CPU, data=(2, 32), softmax_label=(2,))
    mon.install(exe)
    got = []
    for _ in range(4):
        mon.tic()
        exe.forward(is_train=False)
        got.append(mon.toc())
    assert [len(r) for r in got] == [len(got[0]), 0, 0, len(got[0])]
    assert got[0][0][2] == "2\t2.0\t"
    assert mon.exes == [exe]


def _fit_with_monitor(nbatch, interval, monkeypatch=None):
    x, y = _data(25 * nbatch)
    mod = tmx.mod.Module(_mlp(tsym), context=tmx.cpu())
    mon = tmx.Monitor(interval, pattern=".*weight")
    counts = []
    consumer = threading.current_thread()

    def count(name, orig):
        def f(*a, **k):
            if threading.current_thread() is consumer:
                counts.append(name)
            return orig(*a, **k)
        return f

    with monkeypatch.context() as mp:
        for name in ("item", "cpu", "tolist", "numpy", "__bool__",
                     "__float__", "__int__"):
            mp.setattr(torch.Tensor, name,
                       count(name, getattr(torch.Tensor, name)))
        mod.fit(tio.NDArrayIter(x, y, batch_size=25), num_epoch=1,
                optimizer="sgd", monitor=mon,
                optimizer_params={"learning_rate": 0.1})
    return len(counts)


def test_fit_monitor_reads_only_in_its_windows(monkeypatch, caplog):
    with caplog.at_level(logging.INFO):
        _fit_with_monitor(4, 2, monkeypatch)
    rows = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("Batch:")]
    # two windows (batches 0 and 2), a training step tapped once (after
    # its backward), two weights each
    assert len(rows) == 2 * 2
    assert {r.split()[1] for r in rows} == {"1", "3"}
    # a window every 100 batches: one window in either run
    assert (_fit_with_monitor(4, 100, monkeypatch)
            == _fit_with_monitor(16, 100, monkeypatch))


def test_bucketing_module_monitors_later_buckets():
    def sym_gen(key):
        return _mlp(tsym), ("data",), ("softmax_label",)

    mod = tmx.mod.BucketingModule(sym_gen, default_bucket_key=32,
                                  context=tmx.cpu())
    mod.bind(data_shapes=[("data", (4, 32))],
             label_shapes=[("softmax_label", (4,))])
    mon = tmx.Monitor(1)
    mod.install_monitor(mon)
    mod.switch_bucket(16, [("data", (4, 32))], [("softmax_label", (4,))])
    assert len(mon.exes) == 2


# ----------------------------------------------------------- initializers
@pytest.mark.parametrize("shape,scale,rand_type", [
    ((8, 20), 1.414, "uniform"), ((6, 3, 2, 2), 0.5, "normal"),
    ((12, 5), 2.0, "uniform")])
def test_orthogonal_by_its_property(shape, scale, rand_type):
    arr = torch.zeros(shape)
    tinit.Orthogonal(scale=scale, rand_type=rand_type)("fc_weight", arr)
    w = arr.reshape(shape[0], -1).double()
    if w.shape[0] <= w.shape[1]:
        gram = w @ w.T
    else:
        gram = w.T @ w
    np.testing.assert_allclose(gram.numpy(),
                               scale ** 2 * np.eye(gram.shape[0]),
                               atol=1e-5)


@pytest.mark.parametrize("name,shape", [("up_bilinear", (2, 3, 4, 4)),
                                        ("upsampling0_weight", (1, 1, 5, 5)),
                                        ("deconv_weight", (3, 1, 6, 6))])
def test_bilinear_exact_like_jax(name, shape):
    want = jmx.nd.zeros(shape)
    jinit.Bilinear()(name, want)
    got = torch.zeros(shape)
    tinit.Bilinear()(name, got)
    np.testing.assert_array_equal(got.numpy(), want.asnumpy())
    if name != "deconv_weight":
        other = torch.zeros(shape)
        tinit.Uniform()(name, other)   # the name picks bilinear
        np.testing.assert_array_equal(other.numpy(), want.asnumpy())


def test_load_and_mixed_exact(tmp_path):
    rs = np.random.RandomState(3)
    params = {"arg:fc1_weight": rs.normal(size=(4, 3)).astype(np.float32),
              "aux:bn_moving_mean": rs.normal(size=(4,)).astype(np.float32)}
    fname = str(tmp_path / "p.params")
    tnd.save(fname, {k: tnd.array(v, ctx=CPU) for k, v in params.items()})
    for src in (fname, params):
        load = tinit.Load(src, default_init=tinit.Constant(7.0))
        w = torch.zeros(4, 3)
        load("fc1_weight", w)
        np.testing.assert_array_equal(w.numpy(), params["arg:fc1_weight"])
        m = torch.zeros(4)
        load("bn_moving_mean", m)
        np.testing.assert_array_equal(m.numpy(),
                                      params["aux:bn_moving_mean"])
        other = torch.zeros(2)
        load("fc2_bias", other)
        assert (other == 7.0).all()
    with pytest.raises(MXNetError, match="shape mismatch"):
        tinit.Load(params)("fc1_weight", torch.zeros(3, 4))
    with pytest.raises(MXNetError, match="no init"):
        tinit.Load(params)("fc9_weight", torch.zeros(3))
    mixed = tinit.Mixed([".*bias", ".*"], [tinit.Constant(1.5),
                                           tinit.One()])
    b, w = torch.zeros(3), torch.zeros(2, 2)
    mixed("fc1_bias", b)
    mixed("fc1_weight", w)
    assert (b == 1.5).all() and (w == 1.0).all()
    with pytest.raises(MXNetError, match="no initializer pattern"):
        tinit.Mixed(["a.*"], [tinit.One()])("b", torch.zeros(1))
    with pytest.raises(MXNetError, match="pair up"):
        tinit.Mixed(["a"], [])


def test_variable_init_attr_honoured_like_jax():
    out = []
    for mx, sym, init in ((jmx, jsym, jinit), (tmx, tsym, tinit)):
        w = sym.Variable("fc1_weight", init=init.Constant(0.25))
        b = sym.Variable("fc1_bias", init=init.Bilinear())
        net = sym.FullyConnected(sym.Variable("data"), weight=w, bias=b,
                                 name="fc1", num_hidden=3)
        net = sym.SoftmaxOutput(net, name="softmax")
        mod = mx.mod.Module(net, context=mx.cpu())
        mod.bind(data_shapes=[("data", (2, 4))],
                 label_shapes=[("softmax_label", (2,))])
        mod.init_params(initializer=init.One())
        out.append({k: _np(v) for k, v in mod.get_params()[0].items()})
    for k in out[0]:
        np.testing.assert_array_equal(out[1][k], out[0][k])
    assert (out[1]["fc1_weight"] == 0.25).all()


@pytest.mark.parametrize("init", [
    tinit.Uniform(0.3), tinit.Normal(0.2), tinit.Xavier("gaussian", "in", 2),
    tinit.MSRAPrelu("out", 0.1), tinit.Orthogonal(0.9, "normal"),
    tinit.Constant(0.5), tinit.One(), tinit.Zero(), tinit.Bilinear()])
def test_dumps_and_create_round_trip_like_jax(init):
    again = tinit.create(init.dumps())
    assert type(again) is type(init)
    assert again.dumps() == init.dumps()
    jname = init.dumps()
    assert type(jinit.create(jname)).__name__ == type(init).__name__

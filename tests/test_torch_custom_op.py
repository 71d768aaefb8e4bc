"""The port's ``Custom`` op and ``mx.operator`` against the JAX package's,
on the CPU.

Mirrors ``tests/test_custom_op.py`` case for case on the port, then runs
the three ``examples/numpy-ops`` nets through both packages: each
example's source is loaded as it is for the JAX package and with
``mxnet_tpu`` renamed to ``mxnet_tpu_torch`` for the port, so the same
user code registers the same Props in each.  The nets — the
``CustomOp`` softmax MLP, the ``NumpyOp`` softmax and the weighted
logistic regression — take the same numpy inputs and weights in both,
and their outputs and every gradient agree within 1e-6 (fp32, absolute
and relative).  Also: ``FusedTrainer.step_multi`` refuses a graph with a
``Custom`` node; the op's calls and host syncs in one batch; ``add``
gradient requests; the Prop answering shape inference.
"""
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import symbol as jsym

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import ndarray as nd
from mxnet_tpu_torch import symbol as sym
from mxnet_tpu_torch.ops import custom as tcustom

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-6, atol=1e-6)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else t.asnumpy()


def _set(t, value):
    t.copy_(torch.from_numpy(np.asarray(value, np.float32)))


class _Softmax(mx.operator.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        x = in_data[0].asnumpy()
        y = np.exp(x - x.max(axis=1, keepdims=True))
        y /= y.sum(axis=1, keepdims=True)
        self.assign(out_data[0], req[0], y)

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        lab = in_data[1].asnumpy().ravel().astype(int)
        y = out_data[0].asnumpy().copy()
        y[np.arange(lab.shape[0]), lab] -= 1.0
        self.assign(in_grad[0], req[0], y)
        self.assign(in_grad[1], "null", None)


@mx.operator.register("test_softmax")
class _SoftmaxProp(mx.operator.CustomOpProp):
    def __init__(self):
        super().__init__(need_top_grad=False)

    def list_arguments(self):
        return ["data", "label"]

    def list_outputs(self):
        return ["output"]

    def infer_shape(self, in_shape):
        data_shape = in_shape[0]
        label_shape = [in_shape[0][0]]
        return [data_shape, label_shape], [data_shape], []

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return _Softmax()


def _softmax(x):
    y = np.exp(x - x.max(1, keepdims=True))
    return y / y.sum(1, keepdims=True)


# ------------------------------------------- tests/test_custom_op.py
def test_custom_op_imperative():
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, size=(4, 5)).astype(np.float32)
    lbl = np.array([0, 1, 2, 3], np.float32)
    out = nd.Custom(nd.array(x, ctx="cpu"), nd.array(lbl, ctx="cpu"),
                    op_type="test_softmax")
    np.testing.assert_allclose(out.asnumpy(), _softmax(x), rtol=1e-5)


def test_custom_op_symbolic_forward_backward():
    data = sym.Variable("data")
    label = sym.Variable("label")
    net = sym.Custom(data, label, op_type="test_softmax", name="csm")
    exe = net.simple_bind(ctx=mx.cpu(), data=(4, 5), label=(4,),
                          grad_req={"data": "write", "label": "null"})
    rs = np.random.RandomState(1)
    x = rs.uniform(-1, 1, size=(4, 5)).astype(np.float32)
    _set(exe.arg_dict["data"], x)
    _set(exe.arg_dict["label"], [1, 0, 3, 2])
    out = _np(exe.forward(is_train=True)[0])
    ref = _softmax(x)
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    exe.backward()
    expect = ref.copy()
    expect[np.arange(4), [1, 0, 3, 2]] -= 1.0
    np.testing.assert_allclose(_np(exe.grad_dict["data"]), expect,
                               rtol=1e-5, atol=1e-6)


def test_custom_op_in_module_fit():
    """A custom loss layer trains through Module.fit."""
    data = sym.Variable("data")
    fc = sym.FullyConnected(data, num_hidden=3, name="fc")
    net = sym.Custom(fc, sym.Variable("softmax_label"),
                     op_type="test_softmax", name="loss")
    rs = np.random.RandomState(2)
    X = rs.uniform(size=(32, 6)).astype(np.float32)
    Y = (X[:, 0] > 0.5).astype(np.float32) + (X[:, 1] > 0.5)
    it = mx.io.NDArrayIter(X, Y, batch_size=8, label_name="softmax_label")
    m = mx.mod.Module(net, context=mx.cpu(), label_names=("softmax_label",))
    m.fit(it, num_epoch=3, optimizer="sgd",
          optimizer_params={"learning_rate": 0.5})
    acc = mx.metric.Accuracy()
    m.score(it, acc)
    assert acc.get()[1] > 0.4


def test_custom_op_need_top_grad():
    """need_top_grad=True ops receive the true head gradient."""

    class _Scale(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0], in_data[0].asnumpy() * 2.0)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0].asnumpy() * 2.0)

    @mx.operator.register("test_scale2")
    class _ScaleProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=True)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return _Scale()

    data = sym.Variable("data")
    net = sym.sum(sym.Custom(data, op_type="test_scale2") * 3.0)
    exe = net.simple_bind(ctx=mx.cpu(), data=(2, 3))
    _set(exe.arg_dict["data"], np.ones((2, 3)))
    exe.forward(is_train=True)
    exe.backward()
    np.testing.assert_allclose(_np(exe.grad_dict["data"]),
                               np.full((2, 3), 6.0), rtol=1e-6)


def test_numpy_op_shim():
    class _Sq(mx.operator.NumpyOp):
        def forward(self, in_data, out_data):
            out_data[0][...] = in_data[0] ** 2

        def backward(self, out_grad, in_data, out_data, in_grad):
            in_grad[0][...] = 2.0 * in_data[0] * out_grad[0]

    op = _Sq()
    net = op(sym.Variable("data"), name="sq")
    exe = net.simple_bind(ctx=mx.cpu(), data=(3,))
    _set(exe.arg_dict["data"], [1.0, 2.0, 3.0])
    out = _np(exe.forward(is_train=True)[0])
    np.testing.assert_allclose(out, [1, 4, 9], rtol=1e-6)
    exe.backward()
    np.testing.assert_allclose(_np(exe.grad_dict["data"]), [2, 4, 6],
                               rtol=1e-6)


def test_unregistered_op_type_errors():
    with pytest.raises(MXNetError):
        nd.Custom(nd.array(np.zeros((2, 2), np.float32), ctx="cpu"),
                  op_type="nope")


def test_custom_prop_receives_symbol_kwargs_as_strings():
    """The sym.Custom call's extra kwargs reach the Prop's constructor
    as strings; framework attrs (op_type/num_args/name) never do."""
    seen = {}

    @mx.operator.register("kwarg_probe_op")
    class KwargProbeProp(mx.operator.CustomOpProp):
        def __init__(self, alpha, mode="x"):
            seen["alpha"] = alpha
            seen["mode"] = mode
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0]], [in_shape[0]]  # the 2-tuple form

        def create_operator(self, ctx, shapes, dtypes):
            class _Op(mx.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0],
                                mx.nd.array(in_data[0].asnumpy() * 2.0))

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                mx.nd.array(out_grad[0].asnumpy() * 2.0))

            return _Op()

    data = mx.sym.Variable("data")
    net = mx.sym.Custom(data, alpha=1.5, mode="fast",
                        op_type="kwarg_probe_op")
    exe = net.simple_bind(mx.cpu(), data=(2, 3))
    _set(exe.arg_dict["data"], np.ones((2, 3)))
    out = _np(exe.forward(is_train=True)[0])
    np.testing.assert_allclose(out, 2.0 * np.ones((2, 3)))
    assert seen["alpha"] == "1.5" and seen["mode"] == "fast", seen


# ------------------------------------------------ the port's own cases
def test_custom_infers_shapes_from_its_prop_without_running():
    """Shape inference asks the Prop (the label's shape from the data's)
    and never calls the user's code."""
    tcustom.reset_stats()
    net = sym.Custom(sym.FullyConnected(sym.Variable("data"), num_hidden=3,
                                        name="fc"),
                     sym.Variable("softmax_label"), op_type="test_softmax",
                     name="loss")
    args, outs, aux = net.infer_shape(data=(4, 5))
    assert dict(zip(net.list_arguments(), args)) == {
        "data": (4, 5), "fc_weight": (3, 5), "fc_bias": (3,),
        "softmax_label": (4,)}
    assert outs == [(4, 3)] and aux == []
    assert net.list_outputs() == ["loss_output"]
    assert tcustom.stats()["forward"] == 0


def test_grad_req_add_accumulates_the_custom_gradient():
    net = sym.Custom(sym.Variable("data"), sym.Variable("label"),
                     op_type="test_softmax")
    exe = net.simple_bind(mx.cpu(), data=(3, 4), label=(3,),
                          grad_req={"data": "add", "label": "null"})
    x = np.random.RandomState(3).randn(3, 4).astype(np.float32)
    _set(exe.arg_dict["data"], x)
    _set(exe.arg_dict["label"], [0, 1, 2])
    once = _softmax(x)
    once[np.arange(3), [0, 1, 2]] -= 1.0
    for _ in range(2):
        exe.forward(is_train=True)
        exe.backward()
    np.testing.assert_allclose(_np(exe.grad_dict["data"]), 2 * once,
                               rtol=1e-6, atol=1e-6)


def test_assign_honours_write_add_and_null():
    from mxnet_tpu_torch.operator import _HostArray

    op = mx.operator.CustomOp()
    dst = _HostArray(np.full(3, 2.0, np.float32))
    op.assign(dst, "add", nd.array(np.ones(3), ctx="cpu"))
    np.testing.assert_array_equal(dst.asnumpy(), [3, 3, 3])
    op.assign(dst, "write", np.arange(3))
    np.testing.assert_array_equal(dst.asnumpy(), [0, 1, 2])
    op.assign(dst, "null", None)
    np.testing.assert_array_equal(dst.asnumpy(), [0, 1, 2])


def test_reregister_drops_the_cached_output_count():
    class _One(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            raise AssertionError("not run")

    class _Two(_One):
        def list_outputs(self):
            return ["a", "b"]

    mx.operator.register("test_recount")(_One)
    assert len(sym.Custom(sym.Variable("d"), op_type="test_recount")
               .list_outputs()) == 1
    mx.operator.register("test_recount")(_Two)
    # the names follow the reference's rule for an op whose count
    # depends on its attrs
    assert sym.Custom(sym.Variable("d"), op_type="test_recount",
                      name="c").list_outputs() == ["c_output", "c_output1"]


def test_step_multi_refuses_a_graph_with_a_custom_op():
    from mxnet_tpu_torch.trainer import FusedTrainer

    net = sym.Custom(sym.FullyConnected(sym.Variable("data"), num_hidden=3,
                                        name="fc"),
                     sym.Variable("softmax_label"), op_type="test_softmax")
    tr = FusedTrainer(net, device="cpu").init(data=(4, 5))
    x = np.zeros((2, 4, 5), np.float32)
    y = np.zeros((2, 4), np.float32)
    with pytest.raises(MXNetError, match=r"Custom op test_softmax.*step\(\)"):
        tr.step_multi(data=x, softmax_label=y)
    out = tr.step(data=x[0], softmax_label=y[0])[0]
    assert out.shape == (4, 3)


def test_one_batch_calls_the_op_once_each_way_without_a_host_sync():
    """One training batch: one forward and one backward of the user's
    code.  On the CPU the inputs are host tensors, so the op makes no
    host sync (on the card it makes one each way:
    tests/test_torch_kernels_cuda.py)."""
    net = sym.Custom(sym.FullyConnected(sym.Variable("data"), num_hidden=3,
                                        name="fc"),
                     sym.Variable("softmax_label"), op_type="test_softmax")
    m = mx.mod.Module(net, context=mx.cpu())
    m.bind(data_shapes=[("data", (4, 5))],
           label_shapes=[("softmax_label", (4,))])
    m.init_params()
    m.init_optimizer()
    batch = mx.io.DataBatch(data=[nd.zeros((4, 5), ctx="cpu")],
                            label=[nd.zeros((4,), ctx="cpu")])
    tcustom.reset_stats()
    m.forward(batch, is_train=True)
    m.backward()
    m.update()
    st = tcustom.stats()
    assert (st["forward"], st["backward"], st["syncs"]) == (1, 1, 0), st
    assert st["host_s"] > 0


# ------------------------------------------------ examples/numpy-ops
def _load_example(name, port):
    """``examples/numpy-ops/<name>.py`` as a module of one package: as it
    is, or with ``mxnet_tpu`` renamed to ``mxnet_tpu_torch``."""
    path = os.path.join(REPO, "examples", "numpy-ops", f"{name}.py")
    mod_name = f"_numpy_ops_{name}_{'port' if port else 'jax'}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    if not port:
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
        return mod
    src = open(path).read().replace("mxnet_tpu", "mxnet_tpu_torch")
    mod = type(sys)(mod_name)
    mod.__file__ = path
    sys.modules[mod_name] = mod
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def _run_both(jnet, tnet, values, grad_names):
    """Bind each net on the CPU, set ``values``, one training forward
    and backward; returns ``(outputs, gradients)`` of each package."""
    shapes = {k: v.shape for k, v in values.items()}
    res = []
    jex = jnet.simple_bind(jmx.cpu(), **shapes)
    for k, v in values.items():
        jex.arg_dict[k][:] = v
    jex.forward(is_train=True)
    jex.backward()
    res.append(([o.asnumpy() for o in jex.outputs],
                {k: jex.grad_dict[k].asnumpy() for k in grad_names}))
    tex = tnet.simple_bind(mx.cpu(), **shapes)
    for k, v in values.items():
        _set(tex.arg_dict[k], v)
    tex.forward(is_train=True)
    tex.backward()
    res.append(([_np(o) for o in tex.outputs],
                {k: _np(tex.grad_dict[k]) for k in grad_names}))
    return res


def _assert_same(res):
    (jo, jg), (to, tg) = res
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a, b, **TOL)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], err_msg=k, **TOL)


def _mlp_values(batch, seed):
    from mxnet_tpu_torch.test_utils import get_synthetic_mnist

    (x, y), _ = get_synthetic_mnist(batch, 1, seed=seed)
    rs = np.random.RandomState(seed)
    return {"data": x, "softmax_label": y,
            "fc1_weight": rs.randn(16, 784).astype(np.float32) * 0.05,
            "fc1_bias": rs.randn(16).astype(np.float32) * 0.05,
            "fc2_weight": rs.randn(10, 16).astype(np.float32) * 0.2,
            "fc2_bias": rs.randn(10).astype(np.float32) * 0.2}


def test_example_custom_softmax_mlp_matches_jax():
    """custom_softmax.py's net (its hidden layer narrowed to 16) with the
    example's CustomOp softmax as the head."""
    for port in (False, True):
        _load_example("custom_softmax", port)

    def net(s):
        out = s.FullyConnected(s.Flatten(s.Variable("data")), name="fc1",
                               num_hidden=16)
        out = s.Activation(out, act_type="relu")
        out = s.FullyConnected(out, name="fc2", num_hidden=10)
        return s.Custom(out, s.Variable("softmax_label"), name="softmax",
                        op_type="softmax")

    vals = _mlp_values(8, 0)
    res = _run_both(net(jsym), net(sym), vals,
                    ["fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"])
    _assert_same(res)
    # the head's gradient is SoftmaxOutput's: its rows sum to 0
    assert abs(res[1][1]["fc2_bias"].sum()) < 1e-5


def test_example_numpy_softmax_matches_jax():
    """numpy_softmax.py's NumpyOp softmax over an FC layer."""
    mods = [_load_example("numpy_softmax", port) for port in (False, True)]

    def net(s, m):
        fc = s.FullyConnected(s.Flatten(s.Variable("data")), num_hidden=10,
                              name="fc")
        return m.NumpySoftmax()(fc, s.Variable("softmax_label"),
                                name="softmax")

    vals = _mlp_values(8, 1)
    rs = np.random.RandomState(1)
    vals = {"data": vals["data"], "softmax_label": vals["softmax_label"],
            "fc_weight": rs.randn(10, 784).astype(np.float32) * 0.05,
            "fc_bias": rs.randn(10).astype(np.float32) * 0.05}
    _assert_same(_run_both(net(jsym, mods[0]), net(sym, mods[1]), vals,
                           ["fc_weight", "fc_bias", "data"]))


@pytest.mark.parametrize("pos,neg", [(1.0, 0.1), (1.0, 1.0)])
def test_example_weighted_logistic_regression_matches_jax(pos, neg):
    """weighted_logistic_regression.py's op with its kwargs (strings at
    the Prop), against the JAX package and the example's closed form."""
    for port in (False, True):
        _load_example("weighted_logistic_regression", port)
    m, n = 2, 5
    rs = np.random.RandomState(0)
    x = rs.randn(2 * m, n).astype(np.float32)
    labels = np.vstack([np.ones([m, n]), np.zeros([m, n])]).astype(
        np.float32)

    def net(s):
        return s.Custom(s.Variable("data"), s.Variable("wlr_label"),
                        pos_grad_scale=pos, neg_grad_scale=neg, name="wlr",
                        op_type="weighted_logistic_regression")

    res = _run_both(net(jsym), net(sym), {"data": x, "wlr_label": labels},
                    ["data"])
    _assert_same(res)
    p = 1.0 / (1.0 + np.exp(-x))
    expect = ((p - 1) * labels * pos + p * (1 - labels) * neg) / n
    np.testing.assert_allclose(res[1][1]["data"], expect, rtol=1e-5,
                               atol=1e-6)

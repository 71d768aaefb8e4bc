"""The port's Executor in training against the JAX package's, on the CPU
(mirrors tests/test_executor.py:16-164, 369-410): ``bind`` and
``simple_bind`` with gradient buffers, ``forward(is_train=True)`` and
``backward`` on FC, convolution, BatchNorm and SoftmaxOutput nets,
``grad_req`` write/add/null, caller head gradients, the aux write-back,
``reshape`` and ``type_dict``, and the refusals of what is not ported.

Each graph is built by the JAX package and reaches the port as
``load_json(tojson())``, so both bind the same names; inputs come from
numpy seeds and go to both.  The JAX side runs its convolutions in true
fp32 (``MXTPU_CONV_PRECISION=float32``).  Tolerances are stated where
they are used.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu import symbol as jsym

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch import symbol as tsym

CPU = "cpu"


def _port(jnet):
    return tsym.load_json(jnet.tojson())


def _fill(jex, tex, seed, classes=None):
    """The same random values in both executors' arguments and aux
    states: labels are class ids, moving variances positive."""
    rs = np.random.RandomState(seed)
    for name, arr in jex.arg_dict.items():
        if name.endswith("_label"):
            v = rs.randint(0, classes, arr.shape).astype(np.float32)
        else:
            v = rs.normal(size=arr.shape).astype(np.float32)
        jex.arg_dict[name][:] = v
        tex.arg_dict[name].copy_(torch.from_numpy(v))
    for name, arr in jex.aux_dict.items():
        v = rs.uniform(0.5, 1.5, arr.shape).astype(np.float32)
        jex.aux_dict[name][:] = v
        tex.aux_dict[name].copy_(torch.from_numpy(v))


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else t.asnumpy()


# ------------------------------------------------------------- basics
def test_bind_forward_backward_matches_jax():
    a, b = jsym.Variable("a"), jsym.Variable("b")
    jnet = a * b
    x = np.array([[1.0, 2.0], [3.0, 4.0]], np.float32)
    y = np.array([[5.0, 6.0], [7.0, 8.0]], np.float32)
    jga, jgb = jnd.zeros((2, 2)), jnd.zeros((2, 2))
    jex = jnet.bind(jmx.cpu(), args=[jnd.array(x), jnd.array(y)],
                    args_grad=[jga, jgb])
    jout = jex.forward(is_train=True)[0].asnumpy()
    jex.backward([jnd.ones((2, 2))])
    # the port binds the NDArrays it is given: the gradients land there
    tga, tgb = tnd.zeros((2, 2), ctx=CPU), tnd.zeros((2, 2), ctx=CPU)
    tex = _port(jnet).bind(CPU, args=[tnd.array(x, ctx=CPU),
                                      tnd.array(y, ctx=CPU)],
                           args_grad=[tga, tgb])
    tout = tex.forward(is_train=True)[0]
    tex.backward([tnd.ones((2, 2), ctx=CPU)])
    # elementwise products of exact values: equal to the bit
    np.testing.assert_array_equal(_np(tout), jout)
    np.testing.assert_array_equal(tga.asnumpy(), jga.asnumpy())
    np.testing.assert_array_equal(tgb.asnumpy(), jgb.asnumpy())
    np.testing.assert_array_equal(tga.asnumpy(), y)


def test_grad_req_add_accumulates_as_jax():
    jnet = jsym.Variable("a") * 2.0
    jga, tga = jnd.zeros((3,)), tnd.zeros((3,), ctx=CPU)
    jex = jnet.bind(jmx.cpu(), args=[jnd.ones((3,))], args_grad=[jga],
                    grad_req="add")
    tex = _port(jnet).bind(CPU, args=[tnd.ones((3,), ctx=CPU)],
                           args_grad=[tga], grad_req="add")
    for _ in range(3):
        jex.forward(is_train=True)
        jex.backward([jnd.ones((3,))])
        tex.forward(is_train=True)
        tex.backward([tnd.ones((3,), ctx=CPU)])
    np.testing.assert_array_equal(tga.asnumpy(), jga.asnumpy())
    np.testing.assert_array_equal(tga.asnumpy(), [6.0, 6.0, 6.0])


def test_grad_req_null_leaves_no_buffer():
    jnet = jsym.Variable("a") + jsym.Variable("b")
    req = {"a": "write", "b": "null"}
    tex = _port(jnet).simple_bind(CPU, grad_req=req, a=(2,), b=(2,))
    tex.forward(is_train=True)
    tex.backward([np.ones(2, np.float32)])
    assert "b" not in tex.grad_dict
    np.testing.assert_array_equal(_np(tex.grad_dict["a"]), [1.0, 1.0])
    assert tex.grad_arrays == [tex.grad_dict["a"], None]


@pytest.mark.parametrize("req", [["write", "null"], ("add", "write")])
def test_grad_req_as_a_list(req):
    jnet = jsym.Variable("a") * jsym.Variable("b")
    tex = _port(jnet).simple_bind(CPU, grad_req=req, a=(2,), b=(2,))
    assert tex.grad_req == {"a": req[0], "b": req[1]}
    assert set(tex.grad_dict) == {n for n, r in zip("ab", req)
                                  if r != "null"}


def test_invalid_grad_req_raises():
    net = _port(jsym.Variable("a") * 2.0)
    with pytest.raises(MXNetError, match="invalid grad_req"):
        net.simple_bind(CPU, grad_req="sometimes", a=(2,))


# --------------------------------------------------- gradients of nets
def _fc_net(s):
    return s.SoftmaxOutput(s.FullyConnected(s.Variable("data"), name="fc",
                                            num_hidden=5), name="softmax")


def _mlp_net(s):
    h = s.Activation(s.FullyConnected(s.Variable("data"), name="fc1",
                                      num_hidden=8), act_type="tanh")
    return s.SoftmaxOutput(s.FullyConnected(h, name="fc2", num_hidden=4),
                           name="softmax")


def _conv_net(s):
    x = s.Convolution(s.Variable("data"), name="conv", kernel=(3, 3),
                      num_filter=4, pad=(1, 1))
    x = s.Pooling(s.Activation(x, act_type="relu"), kernel=(2, 2),
                  stride=(2, 2), pool_type="max")
    x = s.FullyConnected(s.Flatten(x), name="fc", num_hidden=3)
    return s.SoftmaxOutput(x, name="softmax")


def _bn_net(s):
    x = s.Convolution(s.Variable("data"), name="conv", kernel=(3, 3),
                      num_filter=4, no_bias=True)
    x = s.BatchNorm(x, name="bn", fix_gamma=False)
    x = s.Activation(x, act_type="relu")
    x = s.FullyConnected(s.Flatten(x), name="fc", num_hidden=3)
    return s.SoftmaxOutput(x, name="softmax", normalization="batch")


NETS = [(_fc_net, {"data": (6, 7)}, 5),
        (_mlp_net, {"data": (4, 6)}, 4),
        (_conv_net, {"data": (2, 3, 8, 8)}, 3),
        (_bn_net, {"data": (4, 2, 6, 6)}, 3)]


@pytest.mark.parametrize("make,shapes,classes", NETS,
                         ids=["fc", "mlp", "conv", "bn"])
def test_gradients_match_jax(monkeypatch, make, shapes, classes):
    monkeypatch.setenv("MXTPU_CONV_PRECISION", "float32")
    jnet = make(jsym)
    jex = jnet.simple_bind(jmx.cpu(), **shapes)
    tex = _port(jnet).simple_bind(CPU, **shapes)
    _fill(jex, tex, 3, classes)
    jout = jex.forward(is_train=True)[0].asnumpy()
    tout = tex.forward(is_train=True)[0]
    # outputs are readable between the forward and the backward
    np.testing.assert_allclose(_np(tout), jout, rtol=1e-5, atol=1e-6)
    jex.backward()
    tex.backward()
    assert set(tex.grad_dict) == set(jex.grad_dict)
    for k, g in jex.grad_dict.items():
        # fp32 both sides, a few layers: gradients agree to fp32
        # reassociation (1e-4 relative, 1e-5 absolute)
        np.testing.assert_allclose(_np(tex.grad_dict[k]), g.asnumpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for k, v in jex.aux_dict.items():
        # the train forward wrote the moving stats back
        np.testing.assert_allclose(_np(tex.aux_dict[k]), v.asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_softmax_output_gradient_is_p_minus_onehot():
    jnet = jsym.SoftmaxOutput(jsym.Variable("data"), name="softmax")
    tex = _port(jnet).simple_bind(CPU, data=(4, 5))
    x = np.random.RandomState(0).randn(4, 5).astype(np.float32)
    labels = np.array([0, 1, 2, 3], np.float32)
    tex.arg_dict["data"].copy_(torch.from_numpy(x))
    tex.arg_dict["softmax_label"].copy_(torch.from_numpy(labels))
    tex.forward(is_train=True)
    tex.backward()
    p = _np(tex.outputs[0])
    onehot = np.eye(5, dtype=np.float32)[labels.astype(int)]
    np.testing.assert_allclose(_np(tex.grad_dict["data"]), p - onehot,
                               rtol=1e-5)


def test_caller_head_gradients_match_jax():
    jnet = jsym.Activation(jsym.FullyConnected(
        jsym.Variable("data"), name="fc", num_hidden=3), act_type="tanh")
    shapes = {"data": (4, 5)}
    jex = jnet.simple_bind(jmx.cpu(), **shapes)
    tex = _port(jnet).simple_bind(CPU, **shapes)
    _fill(jex, tex, 5)
    head = np.random.RandomState(6).normal(size=(4, 3))
    jex.forward(is_train=True)
    jex.backward([jnd.array(head.astype(np.float32))])
    tex.forward(is_train=True)
    # a float64 head takes the output's dtype, as in the JAX package
    tex.backward(head)
    for k, g in jex.grad_dict.items():
        np.testing.assert_allclose(_np(tex.grad_dict[k]), g.asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_multi_output_heads_and_output_dict():
    d = jsym.Variable("data")
    jnet = jsym.Group([jsym.FullyConnected(d, name="fa", num_hidden=2),
                       jsym.FullyConnected(d, name="fb", num_hidden=3)])
    shapes = {"data": (2, 4)}
    jex = jnet.simple_bind(jmx.cpu(), **shapes)
    tex = _port(jnet).simple_bind(CPU, **shapes)
    _fill(jex, tex, 8)
    heads = [np.full((2, 2), 2.0, np.float32), np.ones((2, 3), np.float32)]
    jex.forward(is_train=True)
    jex.backward([jnd.array(h) for h in heads])
    tex.forward(is_train=True)
    assert sorted(tex.output_dict) == ["fa_output", "fb_output"]
    tex.backward([tnd.array(h, ctx=CPU) for h in heads])
    for k, g in jex.grad_dict.items():
        np.testing.assert_allclose(_np(tex.grad_dict[k]), g.asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    with pytest.raises(MXNetError, match="2 outputs"):
        tex.forward(is_train=True)
        tex.backward([heads[0]])


def test_backward_needs_a_train_forward():
    tex = _port(_fc_net(jsym)).simple_bind(CPU, data=(2, 3))
    with pytest.raises(MXNetError, match="requires forward"):
        tex.backward()
    tex.forward(is_train=False)
    with pytest.raises(MXNetError, match="requires forward"):
        tex.backward()
    tex.forward(is_train=True)
    tex.backward()
    # the graph is freed by the backward
    with pytest.raises(MXNetError, match="requires forward"):
        tex.backward()


def test_inference_forward_keeps_aux_and_grads():
    jnet = _bn_net(jsym)
    tex = _port(jnet).simple_bind(CPU, data=(4, 2, 6, 6))
    jex = jnet.simple_bind(jmx.cpu(), data=(4, 2, 6, 6))
    _fill(jex, tex, 9, 3)
    before = {k: _np(v).copy() for k, v in tex.aux_dict.items()}
    tex.forward(is_train=False)
    for k, v in tex.aux_dict.items():
        np.testing.assert_array_equal(_np(v), before[k])
    assert not any(bool(g.any()) for g in tex.grad_dict.values())


# ------------------------------------------------ reshape, type_dict
def test_reshape_shares_unchanged_arrays():
    jnet = jsym.FullyConnected(jsym.Variable("data"), name="fc",
                               num_hidden=4)
    tex = _port(jnet).simple_bind(CPU, data=(8, 6))
    jex = jnet.simple_bind(jmx.cpu(), data=(8, 6))
    _fill(jex, tex, 10)
    tex2 = tex.reshape(data=(2, 6))
    jex2 = jex.reshape(data=(2, 6))
    assert tex2.arg_dict["fc_weight"] is tex.arg_dict["fc_weight"]
    assert tuple(tex2.arg_dict["data"].shape) == (2, 6)
    x = np.ones((2, 6), np.float32)
    out = tex2.forward(data=x)[0]
    assert tuple(out.shape) == (2, 4)
    # the JAX reshape binds fresh zeros: give it the port's weights
    jex2.arg_dict["fc_weight"][:] = _np(tex.arg_dict["fc_weight"])
    jex2.arg_dict["fc_bias"][:] = _np(tex.arg_dict["fc_bias"])
    jout = jex2.forward(data=x)[0].asnumpy()
    np.testing.assert_allclose(_np(out), jout, rtol=1e-6, atol=1e-6)


def test_simple_bind_honours_type_dict():
    jnet = jsym.Variable("data") * jsym.Variable("w")
    tnet = _port(jnet)
    ex = tnet.simple_bind(CPU, type_dict={"data": np.int32}, data=(2, 2),
                          w=(2, 2))
    assert ex.arg_dict["data"].dtype == torch.int32
    assert ex.arg_dict["w"].dtype == torch.float32
    assert ex.grad_dict["w"].dtype == torch.float32
    ex16 = tnet.simple_bind(CPU, type_dict={"w": np.float16}, data=(2, 2),
                            w=(2, 2))
    assert ex16.arg_dict["w"].dtype == torch.float16
    assert ex16.grad_dict["w"].dtype == torch.float16
    jex = jnet.simple_bind(jmx.cpu(), type_dict={"w": np.float16},
                           data=(2, 2), w=(2, 2))
    assert np.dtype(jex.grad_dict["w"].dtype) == np.float16


def test_simple_bind_reads_the_dtype_attr():
    jnet = jsym.Variable("data", dtype=np.int32) * 2.0
    ex = _port(jnet).simple_bind(CPU, grad_req="null", data=(3,))
    assert ex.arg_dict["data"].dtype == torch.int32
    ex2 = _port(jnet).simple_bind(CPU, grad_req="null",
                                  type_dict={"data": np.float32}, data=(3,))
    assert ex2.arg_dict["data"].dtype == torch.float32


def test_bind_checks_its_arrays():
    jnet = jsym.Variable("a") * jsym.Variable("b")
    tnet = _port(jnet)
    with pytest.raises(MXNetError, match="expected 2 args"):
        tnet.bind(CPU, args=[tnd.ones((2,), ctx=CPU)])
    with pytest.raises(MXNetError, match="missing arguments"):
        tnet.bind(CPU, args={"a": tnd.ones((2,), ctx=CPU)})
    ex = tnet.bind(CPU, args={"a": np.ones(2), "b": np.ones(2)})
    assert ex.grad_req == {"a": "null", "b": "null"}


# ---------------------------------------------------------- refusals
def test_what_is_not_ported_raises():
    """ctx-group placement is ported: a ``group2ctx`` entry that no node
    is annotated with is ignored with the reference's warning, and a
    group mapped to a sharding raises naming ROADMAP Queue 1 item 10b,
    slice 5; the structural signature and row-sparse gradients are
    ported: the signature is the reference's digest, and a
    ``__grad_stype__="row_sparse"`` weight that no Embedding consumes
    keeps its dense gradient, as in the reference."""
    from mxnet_tpu_torch.parallel import mesh as tmesh

    jnet = _fc_net(jsym)
    tnet = _port(jnet)
    with pytest.warns(UserWarning, match="matches no ctx_group"):
        ex = tnet.simple_bind(CPU, group2ctx={"dev1_unused": CPU},
                              data=(2, 3))
    assert all(t.device.type == "cpu" for t in ex.arg_dict.values())
    with pytest.raises(MXNetError, match="item 10b, slice 5"):
        tnet.simple_bind(CPU, group2ctx={"dev1": tmesh.NamedSharding(
            None, ("data",))}, data=(2, 3))
    assert tnet.structural_signature() == \
        jsym.load_json(jnet.tojson()).structural_signature()
    w = tsym.Variable("w", attr={"__grad_stype__": "row_sparse"})
    emb = tsym.FullyConnected(tsym.Variable("data"), w, name="fc",
                              num_hidden=2, no_bias=True)
    ex = emb.simple_bind(CPU, data=(2, 3))
    assert getattr(ex.grad_dict["w"], "stype", "default") == "default"
    ex.forward(is_train=True, data=np.ones((2, 3), np.float32))
    ex.backward()
    assert float(ex.grad_dict["w"].abs().sum()) > 0

"""The port's Predictor against the JAX package's, on the CPU: ResNet-50
at full depth and width (10 classes, data 2 x 3 x 64 x 64), from the same
numpy weights, with the graph passes on (Conv+BN fold, residual
epilogues) and off, in fp32 and bf16.

At 64 x 64 the four fused epilogues see rows 512 / 128 / 32 / 8, all
inside ``supports()``, so the JAX side takes its kernel's lax twin
exactly where the port's CPU run takes the plain version.  The symbol
goes from the JAX package to the port as JSON.  The net is compared
with a second head on the logits (``fc1``), since the seeded He-normal
weights give logits of std ~50 and a softmax near one-hot; the
FullyConnected weights are scaled down so the softmax is informative
too.  The JAX side runs its convolutions in true fp32
(``MXTPU_CONV_PRECISION=float32``).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import executor as jexec
from mxnet_tpu import symbol as jsym
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu.predict import Predictor as JPredictor

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.models import resnet as tresnet
from mxnet_tpu_torch.ops import residual_epilogue as tre
from mxnet_tpu_torch.predict import Predictor

SHAPE = (2, 3, 64, 64)


@pytest.fixture(scope="module")
def net_and_params():
    jnet = jresnet.get_symbol(10, 50, SHAPE[1:])
    logits = jnet.get_internals()["fc1_output"]
    jnet = jsym.Group([jnet, logits])
    arg, aux = tresnet.random_params(tsym.load_json(jnet.tojson()), seed=0,
                                     data=SHAPE)
    rng = np.random.default_rng(2)
    for k in arg:
        if k.endswith("_gamma"):
            arg[k] = rng.uniform(0.8, 1.2, arg[k].shape).astype(np.float32)
        elif k.endswith("_beta"):
            arg[k] = rng.uniform(-0.1, 0.1, arg[k].shape).astype(np.float32)
    arg["fc1_weight"] = arg["fc1_weight"] * np.float32(0.02)
    x = rng.normal(size=SHAPE).astype(np.float32)
    return jnet, arg, aux, x


def _jax_outputs(jnet, arg, aux, x, dtype):
    jexec.program_cache_clear()
    p = JPredictor(symbol=jnet,
                   arg_params={k: mx.nd.array(v) for k, v in arg.items()},
                   aux_params={k: mx.nd.array(v) for k, v in aux.items()},
                   input_shapes={"data": SHAPE}, dtype=dtype)
    p.forward(data=x)
    return [p.get_output(i) for i in range(2)], p


def _port(jnet, arg, aux, dtype=None, **kw):
    return Predictor(symbol_json_str=jnet.tojson(), arg_params=arg,
                     aux_params=aux, input_shapes={"data": SHAPE},
                     dev_type="cpu", dtype=dtype, **kw)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# fp32: 53 convolutions, 14 BatchNorms and 4 fused epilogues in fp32, the
# two libraries summing in other orders: measured ~1e-6 relative on the
# logits; 1e-5 relative-norm and 1e-5 on the probabilities hold it.
# bf16: every op rounds to bf16 (8 significant bits) on both sides, but
# XLA fuses elementwise chains in fp32 where torch rounds each op, and
# the two conv libraries accumulate differently: the logits part by
# about 1e-2 relative; 5e-2 relative-norm and 2e-2 on the probabilities.
CASES = [("on", None, 1e-5, 1e-5), ("0", None, 1e-5, 1e-5),
         ("on", "bfloat16", 5e-2, 2e-2), ("0", "bfloat16", 5e-2, 2e-2)]


@pytest.mark.parametrize("passes,dtype,logit_tol,prob_tol", CASES)
def test_predictor_matches_jax(net_and_params, monkeypatch, passes, dtype,
                               logit_tol, prob_tol):
    monkeypatch.setenv("MXTPU_CONV_PRECISION", "float32")
    monkeypatch.setenv("MXTPU_GRAPH_PASSES", passes)
    jnet, arg, aux, x = net_and_params
    (jprob, jlogit), jp = _jax_outputs(jnet, arg, aux, x, dtype)
    p = _port(jnet, arg, aux, dtype)
    assert p._n_bn_folded == jp._n_bn_folded == (33 if passes == "on" else 0)
    ops = [n.op for n in p._exec._exec_symbol.nodes if not n.is_variable]
    assert ops.count("_residual_epilogue_bn") == (4 if passes == "on" else 0)
    p.forward(data=x)
    prob, logit = p.get_output(0), p.get_output(1)
    assert prob.dtype == logit.dtype == np.float32
    assert np.isfinite(prob).all() and np.isfinite(logit).all()
    assert _rel(logit, jlogit) <= logit_tol
    np.testing.assert_allclose(prob, jprob, rtol=0, atol=prob_tol)


def test_passes_on_and_off_agree_in_the_port(net_and_params, monkeypatch):
    """The fold and the fused epilogues change only rounding: fp32
    logits within 1e-5 relative of the unrewritten graph's."""
    jnet, arg, aux, x = net_and_params
    outs = []
    for passes in ("on", "0"):
        monkeypatch.setenv("MXTPU_GRAPH_PASSES", passes)
        p = _port(jnet, arg, aux)
        p.forward(data=x)
        outs.append(p.get_output(1))
    assert _rel(outs[0], outs[1]) <= 1e-5


def test_predictor_api(net_and_params, monkeypatch):
    monkeypatch.delenv("MXTPU_GRAPH_PASSES", raising=False)
    jnet, arg, aux, x = net_and_params
    p = _port(jnet, arg, aux)
    # before any forward
    assert p.num_outputs == 2
    assert p.get_output_shape(0) == (2, 10) and p.get_output_shape(1) == \
        (2, 10)
    assert p._input_names == ["data"]
    # the label was inferred and bound to zeros
    assert p._label_args == {"softmax_label"}
    assert p._exec.arg_dict["softmax_label"].shape == (2,)
    assert not p._exec.arg_dict["softmax_label"].any()
    # the folded convs gained biases from the fold, not from the params
    assert "conv0_bias" in p.symbol.list_arguments()
    # channels-last binds under the default layout
    assert p._exec.arg_dict["data"].is_contiguous(
        memory_format=torch.channels_last)
    # set_input + a parameterless get_output runs the forward
    p.set_input("data", x)
    first = p.get_output(1)
    p.forward(data=x)
    np.testing.assert_array_equal(p.get_output(1), first)
    with pytest.raises(MXNetError, match="unknown input"):
        p.set_input("fc1_weight", x)
    with pytest.raises(MXNetError, match="shape mismatch"):
        p.set_input("data", x[:1])
    # reshape keeps the folded params, the device and the dtype
    p.reshape({"data": (3,) + SHAPE[1:]})
    x3 = np.concatenate([x, x[:1]])
    p.forward(data=x3)
    assert p.get_output_shape(1) == (3, 10)
    np.testing.assert_allclose(p.get_output(1)[:2], first, rtol=1e-5,
                               atol=1e-4)


def test_predictor_without_the_fold_keeps_the_batch_norms(net_and_params,
                                                          monkeypatch):
    monkeypatch.setenv("MXTPU_GRAPH_PASSES", "cse,dce,residual_epilogue")
    jnet, arg, aux, x = net_and_params
    p = _port(jnet, arg, aux)
    assert p._n_bn_folded == 0
    ops = [n.op for n in p._exec._exec_symbol.nodes if not n.is_variable]
    assert ops.count("BatchNorm") == 51 - 4
    assert ops.count("_residual_epilogue_bn") == 4


def test_channels_last_off_matches(net_and_params, monkeypatch):
    """MXTPU_CONV_LAYOUT=NCHW binds contiguous tensors (the epilogue's
    plain version on the card, by the reference's gate)."""
    jnet, arg, aux, x = net_and_params
    outs = []
    for layout in ("NHWC", "NCHW"):
        monkeypatch.setenv("MXTPU_CONV_LAYOUT", layout)
        p = _port(jnet, arg, aux)
        assert p._exec.arg_dict["data"].is_contiguous(
            memory_format=torch.channels_last) == (layout == "NHWC")
        p.forward(data=x)
        outs.append(p.get_output(1))
    assert _rel(outs[0], outs[1]) <= 1e-5


def test_uncovered_weight_raises(net_and_params, monkeypatch):
    """A weight the params lack raises.  The JAX Predictor treats every
    argument missing from params and input_shapes as a label and binds
    zeros, so there the same params compute without a word (a fault of
    the reference the port does not copy)."""
    jnet, arg, aux, _ = net_and_params
    partial = {k: v for k, v in arg.items() if k != "fc1_bias"}
    with pytest.raises(MXNetError, match=r"cover no value for \['fc1_bias'\]"):
        _port(jnet, partial, aux)
    monkeypatch.setenv("MXTPU_GRAPH_PASSES", "0")
    jexec.program_cache_clear()
    JPredictor(symbol=jnet,
               arg_params={k: mx.nd.array(v) for k, v in partial.items()},
               aux_params={k: mx.nd.array(v) for k, v in aux.items()},
               input_shapes={"data": SHAPE})


def test_params_as_tensors_and_ndarrays(net_and_params):
    jnet, arg, aux, x = net_and_params
    p1 = _port(jnet, arg, aux)
    p2 = _port(jnet, {k: torch.from_numpy(v) for k, v in arg.items()},
               {k: mx.nd.array(v) for k, v in aux.items()})
    p1.forward(data=x)
    p2.forward(data=torch.from_numpy(x))
    np.testing.assert_array_equal(p1.get_output(1), p2.get_output(1))


def test_predict_dtype_env(net_and_params, monkeypatch):
    monkeypatch.setenv("MXTPU_PREDICT_DTYPE", "bfloat16")
    jnet, arg, aux, x = net_and_params
    p = _port(jnet, arg, aux)
    assert p._params["conv0_weight"].dtype == torch.bfloat16
    assert p._params["data"].dtype == torch.bfloat16
    p.forward(data=x)
    assert p.get_output(0).dtype == np.float32


def test_left_out_arguments_raise(net_and_params, monkeypatch):
    """What the Predictor still refuses: an unknown quantize mode (also
    through ``MXTPU_PREDICT_INT8``'s kwarg-less path), a bad
    ``output_index`` entry, a ticket it never issued, no symbol."""
    jnet, arg, aux, _ = net_and_params
    with pytest.raises(MXNetError, match="unknown quantize mode"):
        _port(jnet, arg, aux, quantize="int4")
    with pytest.raises(MXNetError, match="unknown output 'nope'"):
        _port(jnet, arg, aux, output_index="nope")
    with pytest.raises(MXNetError, match="int or str"):
        _port(jnet, arg, aux, output_index=[1.5])
    monkeypatch.setenv("MXTPU_PREDICT_INT8", "1")
    assert _port(jnet, arg, aux)._quantize == "int8"
    monkeypatch.delenv("MXTPU_PREDICT_INT8")
    p = _port(jnet, arg, aux)
    with pytest.raises(MXNetError, match="unknown or already-retired"):
        p.get_async(1)
    with pytest.raises(MXNetError, match="need symbol"):
        Predictor(arg_params=arg, dev_type="cpu")


def test_predictor_defaults_to_the_card(net_and_params, monkeypatch):
    """Without ``dev_type`` the Predictor binds on the card, and without
    a card it raises (the JAX Predictor defaults to the host)."""
    jnet, arg, aux, _ = net_and_params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        Predictor(symbol_json_str=jnet.tojson(), arg_params=arg,
                  aux_params=aux, input_shapes={"data": SHAPE})
    with pytest.raises(MXNetError, match="no CUDA device"):
        Predictor(symbol_json_str=jnet.tojson(), arg_params=arg,
                  aux_params=aux, input_shapes={"data": SHAPE},
                  dev_type="gpu")


def test_cpu_forward_launches_no_kernel(net_and_params):
    jnet, arg, aux, x = net_and_params
    n0 = tre.launch_count()
    p = _port(jnet, arg, aux)
    p.forward(data=x)
    p.get_output(0)
    assert tre.launch_count() == n0


def test_executor_forward_matches_the_predictor(net_and_params,
                                                monkeypatch):
    """The Executor the Predictor sits on, driven directly: the graph
    passes run at bind, forward keeps the outputs on the device, a
    backward needs a training forward, and what it does not port yet
    raises."""
    from mxnet_tpu_torch.executor import simple_bind

    monkeypatch.setenv("MXTPU_GRAPH_PASSES", "0")
    jnet, arg, aux, x = net_and_params
    tnet = tsym.load_json(jnet.tojson())
    ex = tnet.simple_bind("cpu", data=SHAPE)
    with pytest.raises(MXNetError, match="no forward"):
        ex.outputs
    ex.copy_params_from(arg, aux)
    outs = ex.forward(data=x)
    assert outs is ex.outputs and len(outs) == 2
    p = _port(jnet, arg, aux)
    p.forward(data=x)
    np.testing.assert_array_equal(outs[1].numpy(), p.get_output(1))
    with pytest.raises(MXNetError, match="unknown param"):
        ex.copy_params_from({"nope": x})
    ex.copy_params_from({"nope": x}, allow_extra_params=True)
    with pytest.raises(MXNetError, match="has shape"):
        ex.copy_params_from({"fc1_bias": np.zeros(3, np.float32)})
    with pytest.raises(MXNetError, match="unknown input"):
        ex.forward(nope=x)
    with pytest.raises(MXNetError, match="requires forward"):
        ex.backward()
    with pytest.warns(UserWarning, match="matches no ctx_group"):
        # ctx-group placement is ported; an unknown group is ignored
        simple_bind(tnet, "cpu", group2ctx={"a_unused": "cpu"}, data=SHAPE)
    with pytest.raises(MXNetError, match="cannot infer"):
        simple_bind(tnet, "cpu")

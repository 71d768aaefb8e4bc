"""The port's graph passes against the JAX package's, on the CPU.

Each graph is built with the JAX package's ``sym`` and carried to the
port as JSON (``tojson`` there, ``load_json`` here), so both sides start
from the same nodes, names and input order.  Each ported pass then runs
in both packages and the results are compared through ``tojson()``:
ops, names, attrs and input order.  ``fold_conv_bn``'s values are held
to the JAX fold's at 1e-6 (both fold in float64 and cast to float32).
Also: ``MXTPU_GRAPH_PASSES`` parsing (every name of the JAX pipeline
runs), the telemetry counters, and the Symbol JSON carry itself.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import passes as jpasses
from mxnet_tpu import symbol as jsym
from mxnet_tpu.models import resnet as jresnet

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import passes as tpasses
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch import telemetry as ttm
from mxnet_tpu_torch.models import resnet as tresnet


def _carry(jnet):
    return tsym.load_json(jnet.tojson())


def _graph(net):
    """The comparable content of ``net.tojson()``."""
    return {k: v for k, v in json.loads(net.tojson()).items()
            if k in ("nodes", "heads", "arg_nodes")}


# ---------------------------------------------------------------- graphs
def _resnet50():
    return jresnet.get_symbol(1000, 50, (3, 224, 224))


def _resnet18_small():
    return jresnet.get_symbol(10, 18, (3, 32, 32))


def _epilogue_net():
    """tests/test_amp.py's residual net: a relu(BN(add)) tail and a plain
    relu(add) tail over the same two convs."""
    d = jsym.Variable("data")
    c1 = jsym.Convolution(d, num_filter=8, kernel=(3, 3), pad=(1, 1),
                          no_bias=True, name="ep_c1")
    c2 = jsym.Convolution(d, num_filter=8, kernel=(1, 1), no_bias=True,
                          name="ep_c2")
    bn = jsym.BatchNorm(c1 + c2, fix_gamma=False, name="ep_bn")
    r = jsym.Activation(bn, act_type="relu", name="ep_r")
    r2 = jsym.Activation(c1 + c2, act_type="relu", name="ep_r2")
    return jsym.Group([r, r2])


def _convbn_net():
    """tests/test_passes.py's Conv+BN net (a biased conv with a learned
    gamma, a no-bias conv with fix_gamma)."""
    d = jsym.Variable("data")
    c1 = jsym.Convolution(d, num_filter=6, kernel=(3, 3), pad=(1, 1),
                          name="q_c1")
    b1 = jsym.BatchNorm(c1, fix_gamma=False, eps=2e-5, name="q_b1")
    a1 = jsym.Activation(b1, act_type="relu", name="q_r1")
    c2 = jsym.Convolution(a1, num_filter=4, kernel=(3, 3), pad=(1, 1),
                          no_bias=True, name="q_c2")
    b2 = jsym.BatchNorm(c2, name="q_b2")
    f = jsym.Flatten(b2, name="q_fl")
    fc = jsym.FullyConnected(f, num_hidden=3, name="q_fc")
    return jsym.SoftmaxOutput(fc, label=jsym.Variable("softmax_label"),
                              name="softmax")


def _dce_cse_net():
    """A transpose pair that cancels, a Reshape of a Reshape, a shared
    subexpression written twice, and a second head exposing an
    interior relu(add) (which the epilogue pass must leave alone)."""
    d = jsym.Variable("data")
    t = jsym.transpose(jsym.transpose(d, axes=(0, 2, 3, 1), name="t1"),
                       axes=(0, 3, 1, 2), name="t2")
    r1 = jsym.Activation(t, act_type="relu", name="dup_a")
    r2 = jsym.Activation(t, act_type="relu", name="dup_b")
    added = r1 + r2
    relu = jsym.Activation(added, act_type="relu", name="tail")
    rs = jsym.Reshape(jsym.Reshape(relu, shape=(0, -1), name="rs1"),
                      shape=(-1, 4), name="rs2")
    return jsym.Group([rs, added])


NETS = {"resnet50": _resnet50, "resnet18_small": _resnet18_small,
        "epilogue": _epilogue_net, "convbn": _convbn_net,
        "dce_cse": _dce_cse_net}
SELECTIONS = ["cse", "dce", "residual_epilogue", "cse,dce,residual_epilogue"]


@pytest.mark.parametrize("selection", SELECTIONS)
@pytest.mark.parametrize("net", sorted(NETS))
def test_pass_matches_jax(net, selection, monkeypatch):
    monkeypatch.setenv("MXTPU_GRAPH_PASSES", selection)
    jnet = NETS[net]()
    tnet = _carry(jnet)
    assert _graph(tnet) == _graph(jnet)
    want = jpasses.apply_graph_passes(jnet)
    got = tpasses.apply_graph_passes(tnet)
    assert _graph(got) == _graph(want)


def test_default_pipeline_matches_jax_on_resnet50(monkeypatch):
    """The JAX default also runs constant_fold, amp_cast and prefuse;
    on ResNet-50 with MXTPU_AMP unset they change nothing, so the port's
    shorter default gives the same graph."""
    monkeypatch.delenv("MXTPU_GRAPH_PASSES", raising=False)
    monkeypatch.delenv("MXTPU_AMP", raising=False)
    jnet = _resnet50()
    got = tpasses.apply_graph_passes(_carry(jnet))
    assert _graph(got) == _graph(jpasses.apply_graph_passes(jnet))
    fused = [n.name for n in got.nodes if n.op == "_residual_epilogue_bn"]
    assert fused == ["stage2_unit1_relu1", "stage3_unit1_relu1",
                     "stage4_unit1_relu1", "relu1"]
    jrows = {r["pass"]: r for r in jpasses.pipeline_report(jnet)}
    for row in tpasses.pipeline_report(_carry(jnet)):
        assert row == jrows[row["pass"]]


def test_passes_off_returns_the_symbol(monkeypatch):
    monkeypatch.setenv("MXTPU_GRAPH_PASSES", "0")
    tnet = _carry(_epilogue_net())
    assert tpasses.apply_graph_passes(tnet) is tnet
    assert tpasses.pipeline_report(tnet) == []


def test_env_selection_unknown_and_unported_names(monkeypatch):
    """Every pass of the JAX pipeline is ported: each name runs, in
    pipeline order, and MXTPU_AMP=bf16 under the default pipeline runs
    amp_cast; an unknown name still raises."""
    monkeypatch.delenv("MXTPU_AMP", raising=False)
    monkeypatch.setenv("MXTPU_GRAPH_PASSES", "dce,cse")
    assert tpasses.enabled_passes() == ["cse", "dce"]
    monkeypatch.setenv("MXTPU_GRAPH_PASSES", "off")
    assert tpasses.enabled_passes() == []
    monkeypatch.setenv("MXTPU_GRAPH_PASSES", "on")
    assert tpasses.enabled_passes() == jpasses.enabled_passes() == [
        "constant_fold", "cse", "dce", "residual_epilogue", "amp_cast",
        "prefuse", "convbn_fold"]
    monkeypatch.setenv("MXTPU_GRAPH_PASSES", "nope,cse")
    with pytest.raises(MXNetError, match="unknown passes"):
        tpasses.enabled_passes()
    for name in ("constant_fold", "amp_cast", "prefuse", "cse,prefuse"):
        monkeypatch.setenv("MXTPU_GRAPH_PASSES", name)
        assert tpasses.enabled_passes() == jpasses.enabled_passes()
        tpasses.apply_graph_passes(_carry(_epilogue_net()))
    monkeypatch.setenv("MXTPU_GRAPH_PASSES", "")
    monkeypatch.setenv("MXTPU_AMP", "bf16")
    got = tpasses.apply_graph_passes(_carry(_epilogue_net()))
    assert any(n.op == "Cast" for n in got.nodes)
    monkeypatch.setenv("MXTPU_GRAPH_PASSES", "cse,dce")
    got = tpasses.apply_graph_passes(_carry(_epilogue_net()))
    assert not any(n.op == "Cast" for n in got.nodes)  # not selected


def _params(jnet, seed, data_shape):
    """numpy params for a JAX net; NDArrays for the JAX side."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = jnet.infer_shape(data=data_shape)
    args = {k: rng.uniform(-0.5, 0.5, s).astype(np.float32)
            for k, s in zip(jnet.list_arguments(), arg_shapes)
            if k not in ("data", "softmax_label")}
    aux = {k: (rng.uniform(0.5, 1.5, s) if "var" in k
               else rng.uniform(-0.2, 0.2, s)).astype(np.float32)
           for k, s in zip(jnet.list_auxiliary_states(), aux_shapes)}
    return args, aux


@pytest.mark.parametrize("net,data_shape", [
    ("convbn", (2, 3, 8, 8)), ("resnet18_small", (1, 3, 32, 32))])
def test_fold_conv_bn_matches_jax(net, data_shape):
    jnet = NETS[net]()
    args, aux = _params(jnet, 3, data_shape)
    jout, jargs, jaux, jn = jpasses.fold_conv_bn(
        jnet, {k: mx.nd.array(v) for k, v in args.items()},
        {k: mx.nd.array(v) for k, v in aux.items()})
    tout, targs, taux, tn = tpasses.fold_conv_bn(_carry(jnet), args, aux)
    assert tn == jn > 0
    assert _graph(tout) == _graph(jout)
    assert sorted(targs) == sorted(jargs) and sorted(taux) == sorted(jaux)
    for k in jargs:
        np.testing.assert_allclose(targs[k], jargs[k].asnumpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    # torch tensors (bf16 included) fold to the same values
    targs_t = {k: torch.from_numpy(v) for k, v in args.items()}
    _, targs2, _, _ = tpasses.fold_conv_bn(_carry(jnet), targs_t, aux)
    for k in targs:
        np.testing.assert_array_equal(np.asarray(targs2[k]), targs[k])


def test_fold_conv_bn_skips_shared_activations():
    d = jsym.Variable("data")
    c = jsym.Convolution(d, num_filter=4, kernel=(1, 1), name="s_c")
    b = jsym.BatchNorm(c, name="s_b")
    net = _carry(jsym.Group([b, jsym.Activation(c, act_type="relu")]))
    args = {"s_c_weight": np.ones((4, 3, 1, 1), np.float32),
            "s_c_bias": np.ones(4, np.float32),
            "s_b_gamma": np.ones(4, np.float32),
            "s_b_beta": np.ones(4, np.float32)}
    aux = {"s_b_moving_mean": np.ones(4, np.float32),
           "s_b_moving_var": np.ones(4, np.float32)}
    out, new_args, _, n = tpasses.fold_conv_bn(net, args, aux)
    assert n == 0 and out is net and sorted(new_args) == sorted(args)


def test_convbn_fold_counts_in_telemetry(monkeypatch):
    monkeypatch.delenv("MXTPU_GRAPH_PASSES", raising=False)
    was = ttm.enabled()
    ttm.enable()
    try:
        counter = ttm.get_registry().get("graph_pass_convbn_folded_total")
        before = counter.total()
        jnet = _convbn_net()
        args, aux = _params(jnet, 4, (2, 3, 8, 8))
        _, _, _, n = tpasses.apply_convbn_fold(_carry(jnet), args, aux)
        assert n == 2 and counter.total() == before + 2
    finally:
        ttm.enable(was)
    monkeypatch.setenv("MXTPU_GRAPH_PASSES", "cse")
    _, _, _, n = tpasses.apply_convbn_fold(_carry(jnet), args, aux)
    assert n == 0


# ------------------------------------------------------- the JSON carry
def test_symbol_json_round_trip_and_getitem():
    jnet = _epilogue_net()
    tnet = _carry(jnet)
    assert tnet.list_arguments() == jnet.list_arguments()
    assert tnet.list_auxiliary_states() == jnet.list_auxiliary_states()
    assert tnet.list_outputs() == jnet.list_outputs()
    assert _graph(tsym.load_json(tnet.tojson())) == _graph(jnet)
    assert tnet["ep_r2_output"].name == "ep_r2" == tnet[1].name
    assert [s.name for s in tnet] == ["ep_r", "ep_r2"]
    with pytest.raises(MXNetError, match="no output named"):
        tnet["nope"]


def test_port_built_resnet_matches_the_jax_json():
    """The port's copy of the model builds the JAX graph: the same ops,
    attrs, inputs and variable names (op-node names aside: the unnamed
    Pooling/Flatten nodes take each package's own name counter)."""
    def strip(g):
        for n in g["nodes"]:
            if n["op"] != "null":
                n["name"] = None
        return g

    assert strip(_graph(tresnet.get_symbol(1000, 50, (3, 224, 224)))) == \
        strip(_graph(_resnet50()))


def test_load_json_refuses_what_it_cannot_read():
    # nnvm-format JSON is ported: it reads as the JAX package reads it
    nnvm = json.dumps({"nodes": [{"op": "null", "name": "x", "param": {}}],
                       "heads": [[0, 0, 0]]})
    assert tsym.load_json(nnvm).list_arguments() == \
        jsym.load_json(nnvm).list_arguments() == ["x"]
    bad = json.loads(_epilogue_net().tojson())
    bad["nodes"][-1]["op"] = "NoSuchOp"
    with pytest.raises(MXNetError, match="not registered"):
        tsym.load_json(json.dumps(bad))


# ------------------------------------- constant_fold, amp_cast, prefuse
def _const_chain_net(s):
    """A constant subgraph (``_ones + 1`` times ``_full``) added to the
    data, then an elementwise chain (abs, *0.5, exp, sqrt, clip) into a
    FullyConnected and the loss."""
    d = s.Variable("data")
    c = s._plus_scalar(s._ones(shape=(2, 3), name="k_ones"), scalar=1.0,
                       name="k_plus")
    c = s.broadcast_mul(c, s._full(shape=(1, 3), value=0.5, name="k_full"),
                        name="k_mul")
    x = s.elemwise_add(d, c, name="k_add")
    x = s.exp(s._mul_scalar(s.abs(x, name="k_abs"), scalar=0.5,
                            name="k_half"), name="k_exp")
    x = s.clip(s.sqrt(x, name="k_sqrt"), a_min=0.1, a_max=3.0, name="k_clip")
    fc = s.FullyConnected(x, num_hidden=4, name="k_fc")
    return s.SoftmaxOutput(fc, label=s.Variable("softmax_label"),
                           name="softmax")


def _lm():
    from mxnet_tpu.models import transformer as jtransformer

    return jtransformer.transformer_lm(num_layers=2, num_heads=2,
                                       d_model=16, seq_len=8, vocab_size=40)


NEW_NETS = {"resnet50": _resnet50, "transformer_lm": _lm,
            "const_chain": lambda: _const_chain_net(jsym)}


def _nodes(net):
    """``net``'s nodes as ``tojson`` writes them, with a ``_literal``'s
    bytes as hex (JSON has no bytes)."""
    def enc(v):
        if isinstance(v, bytes):
            return v.hex()
        return v if isinstance(v, str) else json.dumps(v)

    index = {id(n): i for i, n in enumerate(net.nodes)}
    return [{"op": n.op, "name": n.name,
             "attrs": {k: enc(v) for k, v in n.attrs.items()},
             "inputs": [[index[id(s)], i] for s, i in n.inputs]}
            for n in net.nodes] + [[index[id(n)], i] for n, i in net._outputs]


@pytest.mark.parametrize("amp", ["off", "bf16"])
@pytest.mark.parametrize("selection", ["constant_fold", "amp_cast", "prefuse",
                                       "default"])
@pytest.mark.parametrize("net", sorted(NEW_NETS))
def test_new_pass_matches_jax(net, selection, amp, monkeypatch):
    """constant_fold, amp_cast, prefuse and the default pipeline give the
    JAX package's graph (ops, names, attrs, edges), AMP off and bf16."""
    if amp == "off":
        monkeypatch.delenv("MXTPU_AMP", raising=False)
    else:
        monkeypatch.setenv("MXTPU_AMP", amp)
    monkeypatch.setenv("MXTPU_GRAPH_PASSES",
                       "" if selection == "default" else selection)
    jnet = NEW_NETS[net]()
    tnet = _carry(jnet)
    want = jpasses.apply_graph_passes(jnet)
    got = tpasses.apply_graph_passes(tnet)
    assert _nodes(got) == _nodes(want)
    ops = [n.op for n in got.nodes]
    if amp == "off" and selection == "amp_cast":
        assert got is tnet
    if net == "const_chain" and selection in ("constant_fold", "default"):
        assert ops.count("_literal") == 1 and "_ones" not in ops
    if net == "const_chain" and selection in ("prefuse", "default"):
        assert "_fused_elemwise" in ops


@pytest.mark.parametrize("amp", ["off", "bf16"])
@pytest.mark.parametrize("net", sorted(NEW_NETS))
def test_pipeline_report_matches_jax(net, amp, monkeypatch):
    monkeypatch.delenv("MXTPU_GRAPH_PASSES", raising=False)
    if amp == "off":
        monkeypatch.delenv("MXTPU_AMP", raising=False)
    else:
        monkeypatch.setenv("MXTPU_AMP", amp)
    jnet = NEW_NETS[net]()
    assert tpasses.pipeline_report(_carry(jnet)) == \
        jpasses.pipeline_report(jnet)


@pytest.mark.parametrize("amp", ["off", "bf16"])
def test_folded_and_fused_graph_computes_as_jax(amp, monkeypatch):
    """The hand graph after the default pipeline (a ``_literal`` and a
    ``_fused_elemwise``) runs forward and backward in both packages from
    the same weights: probabilities and weight gradients within 1e-5 in
    fp32, 2e-2 under AMP (bf16 rounding)."""
    if amp == "off":
        monkeypatch.delenv("MXTPU_AMP", raising=False)
    else:
        monkeypatch.setenv("MXTPU_AMP", amp)
    monkeypatch.delenv("MXTPU_GRAPH_PASSES", raising=False)
    monkeypatch.setenv("MXTPU_CONV_PRECISION", "float32")
    tol = 1e-5 if amp == "off" else 2e-2
    jnet = _const_chain_net(jsym)
    rng = np.random.RandomState(5)
    vals = {"data": rng.uniform(-2, 2, (2, 3)).astype(np.float32),
            "k_fc_weight": rng.uniform(-1, 1, (4, 3)).astype(np.float32),
            "k_fc_bias": rng.uniform(-1, 1, (4,)).astype(np.float32),
            "softmax_label": np.array([1, 3], np.float32)}
    shapes = {"data": (2, 3), "softmax_label": (2,)}
    jex = jnet.simple_bind(mx.cpu(), grad_req="write", **shapes)
    tex = _carry(jnet).simple_bind("cpu", grad_req="write", **shapes)
    assert "_literal" in [n.op for n in tex._exec_symbol.nodes]
    for k, v in vals.items():
        jex.arg_dict[k][:] = v
        tex.arg_dict[k].copy_(torch.from_numpy(v))
    jout = jex.forward(is_train=True)[0].asnumpy()
    jex.backward()
    tout = tex.forward(is_train=True)[0].numpy()
    tex.backward()
    np.testing.assert_allclose(tout, jout, rtol=tol, atol=tol)
    for k in ("k_fc_weight", "k_fc_bias", "data"):
        np.testing.assert_allclose(tex.grad_dict[k].numpy(),
                                   jex.grad_dict[k].asnumpy(), rtol=tol,
                                   atol=tol, err_msg=k)


def test_constant_fold_limits_and_literal_dtypes(monkeypatch):
    """A constant above FOLD_MAX_BYTES stays unfolded; a folded bf16
    constant keeps its dtype and value; a re-run folds nothing more."""
    from mxnet_tpu_torch.passes import constant_fold as tcf

    big = tsym._plus_scalar(tsym._ones(shape=(1 << 15,)), scalar=1.0)
    assert tcf.constant_fold(big).tojson() == big.tojson()
    small = tsym._mul_scalar(tsym._full(shape=(3,), value=1.5,
                                        dtype="bfloat16"), scalar=3.0)
    out = tcf.constant_fold(small)
    (lit,) = [n for n in out.nodes]
    assert lit.op == "_literal" and lit.attrs["dtype"] == "bfloat16"
    assert _nodes(tcf.constant_fold(out)) == _nodes(out)
    ex = out.simple_bind("cpu", grad_req="null")
    got = ex.forward()[0]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, torch.full((3,), 4.5, dtype=torch.bfloat16))

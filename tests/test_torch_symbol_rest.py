"""The rest of Symbol and Executor in the port against the JAX package:
the Symbol methods (``attr``/``list_attr``/``_set_attr``,
``get_children``, ``infer_type``, ``infer_shape_partial``, ``eval``,
copies, ``sym.zeros``/``ones``/``arange``), nnvm-format JSON, the
executor's program cache (``MXTPU_PROGRAM_CACHE``) and
``FusedTrainer(remat=True)``.

Symbol answers are compared exactly (names, shapes, types, JSON,
signatures).  ``remat=True`` must equal ``remat=False`` to the bit on
the CPU (the same operations run, the forward twice), with Dropout too
(the recompute replays the forward's masks); against the JAX trainer's
``remat=True`` the outputs and parameters after three steps agree to
1e-5 (fp32, no dropout: the packages' random streams differ).
"""
import copy
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import models as jmodels
from mxnet_tpu.models import transformer as jtrm
from mxnet_tpu.trainer import FusedTrainer as JTrainer

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import executor as texec
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch import telemetry as ttm
from mxnet_tpu_torch.models import transformer as ttrm
from mxnet_tpu_torch.trainer import FusedTrainer as TTrainer

CPU = "cpu"


def _net(s):
    data = s.Variable("data", shape=(2, 6), lr_mult=0.5)
    fc1 = s.FullyConnected(data, name="fc1", num_hidden=8,
                           attr={"ctx_group": "dev1"})
    act = s.Activation(fc1, name="relu1", act_type="relu")
    fc2 = s.FullyConnected(act, name="fc2", num_hidden=3)
    return s.SoftmaxOutput(fc2, name="softmax")


# --------------------------------------------------------- Symbol
def test_attrs_children_and_copies():
    j, t = _net(jmx.sym), _net(tsym)
    jfc1 = j.get_internals()["fc1_output"]
    tfc1 = t.get_internals()["fc1_output"]
    assert tfc1.attr("ctx_group") == jfc1.attr("ctx_group") == "dev1"
    assert tfc1.list_attr() == jfc1.list_attr()
    assert t.attr_dict() == j.attr_dict()
    tfc1._set_attr(lr_mult=2)
    jfc1._set_attr(lr_mult=2)
    assert tfc1.list_attr() == jfc1.list_attr()
    assert t.structural_signature() == j.structural_signature()
    assert t.get_children().list_outputs() == \
        j.get_children().list_outputs()
    var = t.get_internals()["data"]
    assert var.get_children() is None
    assert copy.copy(t).tojson() == t.tojson()
    deep = copy.deepcopy(t)
    assert deep.tojson() == t.tojson()
    assert deep.nodes[0] is not t.nodes[0]
    assert deep.structural_signature() == t.structural_signature()


def test_variable_annotations_match_the_reference():
    for kw in ({"dtype": "float16"}, {"shape": (3, 4)},
               {"grad_stype": "row_sparse"}, {"stype": "default"},
               {"lr_mult": 0.1, "wd_mult": 0.0}):
        assert tsym.Variable("v", **kw).list_attr() == \
            jmx.sym.Variable("v", **kw).list_attr(), kw
    with pytest.raises(tmx.MXNetError, match="storage type"):
        tsym.Variable("v", grad_stype="csr")


@pytest.mark.parametrize("name", ["resnet-50", "inception-v3", "alexnet",
                                  "transformer-lm"])
def test_infer_type_on_the_zoo(name):
    j = jmodels.get_symbol(name)
    t = tmodels.get_symbol(name)
    assert t.infer_type() == j.infer_type()
    assert t.infer_type(data=np.float16) == j.infer_type(data=np.float16)


def test_infer_shape_partial_with_unknowns():
    j, t = _net(jmx.sym), _net(tsym)
    # nothing but the declared data shape: the label stays unknown
    assert t.infer_shape_partial() == j.infer_shape_partial()
    label = jmx.sym.Variable("y")
    jx = jmx.sym.elemwise_add(
        jmx.sym.FullyConnected(jmx.sym.Variable("a"), num_hidden=4,
                               name="fca"), label)
    tx = tsym.elemwise_add(
        tsym.FullyConnected(tsym.Variable("a"), num_hidden=4, name="fca"),
        tsym.Variable("y"))
    got = tx.infer_shape_partial(a=(2, 5))
    assert got == jx.infer_shape_partial(a=(2, 5))
    assert got[0] == [(2, 5), (4, 5), (4,), None]
    assert tx.infer_shape(a=(2, 5)) == (None, None, None)


def test_eval_and_creators():
    x = np.random.RandomState(0).randn(2, 6).astype(np.float32)
    t = tsym.FullyConnected(tsym.Variable("x"), num_hidden=3, no_bias=True,
                            name="fc")
    w = np.random.RandomState(1).randn(3, 6).astype(np.float32)
    out = t.eval(ctx=CPU, x=tmx.nd.array(x, ctx=CPU),
                 fc_weight=tmx.nd.array(w, ctx=CPU))
    np.testing.assert_allclose(out[0].asnumpy(), x @ w.T, rtol=1e-6)
    for name, args in (("zeros", ((2, 3),)), ("ones", ((4,),)),
                       ("arange", (0, 5))):
        js = getattr(jmx.sym, name)(*args, name="c")
        ts = getattr(tsym, name)(*args, name="c")
        assert ts.tojson() == js.tojson()
        assert ts.structural_signature() == js.structural_signature()
    np.testing.assert_array_equal(
        tsym.arange(0, 5, step=2.0).eval(ctx=CPU)[0].asnumpy(),
        [0.0, 2.0, 4.0])


def _legacy_json():
    """A pre-0.9 nnvm JSON: params under ``param``, annotations under
    ``attr``, BatchNorm without its aux inputs, 2-element input refs."""
    def var(name, **extra):
        return {"op": "null", "param": {}, "name": name, "inputs": [],
                "backward_source_id": -1, **extra}

    return json.dumps({
        "nodes": [
            var("data"), var("fc1_weight", attr={"lr_mult": "0.2"}),
            var("fc1_bias"),
            {"op": "FullyConnected",
             "param": {"no_bias": "False", "num_hidden": "8"},
             "name": "fc1", "inputs": [[0, 0], [1, 0], [2, 0]],
             "backward_source_id": -1},
            var("bn_gamma"), var("bn_beta"),
            {"op": "BatchNorm_v1", "param": {"eps": "0.001"}, "name": "bn",
             "inputs": [[3, 0], [4, 0], [5, 0]], "backward_source_id": -1},
            {"op": "Activation", "param": {"act_type": "relu"},
             "name": "relu1", "inputs": [[6, 0]], "backward_source_id": -1},
            var("softmax_label"),
            {"op": "SoftmaxOutput", "param": {}, "name": "softmax",
             "inputs": [[7, 0], [8, 0]], "backward_source_id": -1},
        ],
        "arg_nodes": [0, 1, 2, 4, 5, 8],
        "node_row_ptr": list(range(11)),
        "heads": [[9, 0]],
    })


def test_nnvm_json_reads_as_in_the_reference(tmp_path):
    text = _legacy_json()
    t = tsym.load_json(text)
    j = jmx.sym.load_json(text)
    assert t.tojson() == j.tojson()
    assert t.structural_signature() == j.structural_signature()
    assert t.list_auxiliary_states() == ["bn_moving_mean", "bn_moving_var"]
    assert t.attr_dict() == {"fc1_weight": {"lr_mult": "0.2"}}
    p = tmp_path / "legacy-symbol.json"
    p.write_text(text)
    assert tsym.load(str(p)).tojson() == t.tojson()
    ex = t.simple_bind(CPU, data=(2, 6), softmax_label=(2,))
    out = ex.forward(is_train=False,
                     data=np.random.RandomState(0).rand(2, 6))[0]
    np.testing.assert_allclose(out.sum(1).numpy(), 1.0, rtol=1e-5)


# -------------------------------------------------- program cache
def _named_net(tag):
    data = tsym.Variable("data")
    fc = tsym.FullyConnected(data, weight=tsym.Variable(f"{tag}_weight"),
                             bias=tsym.Variable(f"{tag}_bias"), num_hidden=4)
    return tsym.SoftmaxOutput(fc, label=tsym.Variable(f"{tag}_label"),
                              name=f"{tag}_softmax")


@pytest.fixture
def _telemetry():
    was = ttm.enabled()
    ttm.enable()
    texec.program_cache_clear()
    yield ttm.get_registry().get("executor_graph_cache_total")
    texec.program_cache_clear()
    ttm.enable(was)


def _count(ctr, result):
    return dict(ctr.samples()).get((result,), 0)


def test_program_cache_rebind_hits(_telemetry):
    """A fresh but equal symbol (alpha-renamed op nodes included) reuses
    the post-pass symbol and graph function; a variable rename misses."""
    ctr = _telemetry
    ex1 = _named_net("pc0").simple_bind(CPU, data=(4, 6))
    hits, misses = _count(ctr, "hit"), _count(ctr, "miss")
    ex2 = _named_net("pc0").simple_bind(CPU, data=(4, 6))
    assert ex2._graph_fn is ex1._graph_fn
    assert ex2._exec_symbol is ex1._exec_symbol
    assert _count(ctr, "hit") == hits + 1
    assert _count(ctr, "miss") == misses
    ex2.forward(is_train=True, data=np.ones((4, 6), np.float32))
    ex2.backward()
    ex3 = _named_net("pc1").simple_bind(CPU, data=(4, 6))
    assert ex3._graph_fn is not ex1._graph_fn
    assert _count(ctr, "miss") == misses + 1
    # reshape lends its own graph function (shared_exec)
    assert ex1.reshape(data=(2, 6))._graph_fn is ex1._graph_fn


def test_program_cache_disable_knob(monkeypatch, _telemetry):
    monkeypatch.setenv("MXTPU_PROGRAM_CACHE", "off")
    assert texec.program_cache_capacity() == 0
    ex1 = _named_net("pc2").simple_bind(CPU, data=(2, 3))
    ex2 = _named_net("pc2").simple_bind(CPU, data=(2, 3))
    assert ex2._graph_fn is not ex1._graph_fn


def test_program_cache_lru_bound(monkeypatch, _telemetry):
    monkeypatch.setenv("MXTPU_PROGRAM_CACHE", "1")
    ex_a = _named_net("pc3a").simple_bind(CPU, data=(2, 3))
    ex_b = _named_net("pc3b").simple_bind(CPU, data=(2, 3))
    assert ex_b._graph_fn is not ex_a._graph_fn
    ex_a2 = _named_net("pc3a").simple_bind(CPU, data=(2, 3))
    assert ex_a2._graph_fn is not ex_a._graph_fn  # evicted by B
    ex_a3 = _named_net("pc3a").simple_bind(CPU, data=(2, 3))
    assert ex_a3._graph_fn is ex_a2._graph_fn
    for raw, cap in (("", 64), ("on", 64), ("7", 7), ("junk", 64)):
        monkeypatch.setenv("MXTPU_PROGRAM_CACHE", raw)
        assert texec.program_cache_capacity() == cap


def test_program_cache_key_is_the_post_pass_signature(_telemetry):
    """The passes run before the lookup: a graph with a duplicated
    subexpression (cse merges it) shares the entry of the graph written
    without it."""
    def net(dup):
        data = tsym.Variable("data")
        a = tsym.Activation(data, act_type="relu", name="r1")
        b = tsym.Activation(data, act_type="relu", name="r2") if dup else a
        return tsym.elemwise_add(a, b, name="add")

    ex1 = net(False).simple_bind(CPU, data=(2, 3))
    ex2 = net(True).simple_bind(CPU, data=(2, 3))
    assert ex2._graph_fn is ex1._graph_fn


# --------------------------------------------------------- remat
SMALL = dict(num_layers=2, num_heads=4, d_model=64, seq_len=32,
             vocab_size=97)


def _batch(seed=5, b=2):
    rs = np.random.RandomState(seed)
    d = rs.randint(0, SMALL["vocab_size"], (b, SMALL["seq_len"]))
    return d.astype(np.float32)


def _port_pair(dropout=0.0, optimizer="sgd"):
    shapes = {"data": (2, SMALL["seq_len"]),
              "softmax_label": (2, SMALL["seq_len"])}
    tts = [TTrainer(ttrm.transformer_lm(dropout=dropout, **SMALL),
                    optimizer=optimizer, optimizer_params={"lr": 0.1},
                    device=CPU, remat=r).init(**shapes)
           for r in (True, False)]
    convert.load_trainer_params(
        tts[1], {k: v.numpy() for k, v in tts[0].params.items()})
    return tts


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_remat_equals_plain_steps(dropout):
    """Three steps with ``remat=True`` equal three plain steps to the
    bit; with Dropout the generator is seeded alike before each run, and
    the recompute replays the forward's masks (a fresh draw would move
    the gradients)."""
    tts = _port_pair(dropout)
    d = _batch()
    outs = []
    for t in tts:
        tmx.random.seed(11)
        outs.append([t.step(data=d, softmax_label=d)[0] for _ in range(3)])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k in tts[0].params:
        torch.testing.assert_close(tts[0].params[k], tts[1].params[k],
                                   rtol=0, atol=0, msg=k)


def test_remat_with_dropout_recomputes_the_same_masks(monkeypatch):
    """The recompute really runs (the graph function is entered twice a
    step) and draws from the replay generator, which holds the state
    the trainer generator had when the step began."""
    t, _ = _port_pair(0.1)
    calls = []
    real = t._graph_fn

    def spy(args, aux, gen, is_train):
        calls.append(gen.get_state().clone())
        return real(args, aux, gen, is_train)

    monkeypatch.setattr(t, "_graph_fn", spy)
    d = _batch()
    t.step(data=d, softmax_label=d)
    assert len(calls) == 2
    torch.testing.assert_close(calls[0], calls[1], rtol=0, atol=0)


def test_remat_env_knob(monkeypatch):
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    assert TTrainer(ttrm.transformer_lm(**SMALL), device=CPU).remat
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "0")
    assert not TTrainer(ttrm.transformer_lm(**SMALL), device=CPU).remat


@pytest.fixture()
def jax_seed():
    """``seed(s)`` seeds the JAX package's key and numpy's global
    generator, which its initializers draw from; both are put back after
    the test, so neither this test's weights nor the next test's draws
    depend on what else ran in the process."""
    from mxnet_tpu import random as jrandom

    state, key = np.random.get_state(), jrandom._state["key"]
    yield jmx.random.seed
    np.random.set_state(state)
    jrandom._state["key"] = key


def test_remat_matches_the_jax_trainer(monkeypatch, jax_seed):
    """The port's recomputed LM step against the JAX trainer's
    ``remat=True`` (``jax.checkpoint`` of the forward) from the same
    weights, three SGD steps.

    The weights are drawn under a fixed seed: the JAX initializers draw
    from numpy's global generator, so unseeded they depend on the tests
    that ran before in the process.  Three SGD steps at lr 0.1 amplify
    fp32 rounding more for some draws than for others (see
    ``test_remat_parity_is_bound_by_rounding_on_an_ill_conditioned_draw``).
    """
    monkeypatch.setenv("MXTPU_CONV_PRECISION", "float32")
    jax_seed(0)
    shapes = {"data": (2, SMALL["seq_len"]),
              "softmax_label": (2, SMALL["seq_len"])}
    jt = JTrainer(jtrm.transformer_lm(**SMALL), optimizer="sgd",
                  optimizer_params={"lr": 0.1}, remat=True)
    jt.init(**shapes)
    tt = TTrainer(ttrm.transformer_lm(**SMALL), optimizer="sgd",
                  optimizer_params={"lr": 0.1}, device=CPU,
                  remat=True).init(**shapes)
    arg, aux = jt.get_params()
    convert.load_trainer_params(tt, {k: v.asnumpy() for k, v in arg.items()},
                                {k: v.asnumpy() for k, v in aux.items()})
    d = _batch()
    for _ in range(3):
        jo = np.asarray(jt.step(data=d, softmax_label=d)[0])
        to = tt.step(data=d, softmax_label=d)[0].numpy()
        np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    jarg, _ = jt.get_params()
    for k, v in tt.get_params()[0].items():
        np.testing.assert_allclose(v.numpy(), jarg[k].asnumpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_remat_parity_weights_do_not_depend_on_earlier_draws(jax_seed):
    """The parity test's weights are the same whatever numpy's global
    generator held before (152 is a draw whose 3-step divergence exceeds
    1e-5; 3 is one that does not)."""
    shapes = {"data": (2, SMALL["seq_len"]),
              "softmax_label": (2, SMALL["seq_len"])}
    weights = []
    for before in (152, 3):
        np.random.seed(before)
        jax_seed(0)
        jt = JTrainer(jtrm.transformer_lm(**SMALL), optimizer="sgd",
                      optimizer_params={"lr": 0.1}, remat=True)
        jt.init(**shapes)
        weights.append({k: v.asnumpy() for k, v in
                        jt.get_params()[0].items()})
    for k in weights[0]:
        np.testing.assert_array_equal(weights[0][k], weights[1][k])


def _remat_lm_steps(weights):
    """The port's recomputed LM step, three SGD steps from ``weights``:
    the parameters after them."""
    shapes = {"data": (2, SMALL["seq_len"]),
              "softmax_label": (2, SMALL["seq_len"])}
    tt = TTrainer(ttrm.transformer_lm(**SMALL), optimizer="sgd",
                  optimizer_params={"lr": 0.1}, device=CPU,
                  remat=True).init(**shapes)
    convert.load_trainer_params(tt, weights, {})
    d = _batch()
    for _ in range(3):
        tt.step(data=d, softmax_label=d)
    return {k: v.numpy() for k, v in tt.get_params()[0].items()}


def test_remat_parity_is_bound_by_rounding_on_an_ill_conditioned_draw(
        monkeypatch, jax_seed):
    """Why the parity test fixes its seed: from seed 152's weights the
    packages part beyond the 1e-5 tolerance in three steps, and moving
    the port's own starting weights by one ulp parts the port from
    itself by as much (at least half as far), so the gap is the step's
    conditioning, not a difference between the packages."""
    monkeypatch.setenv("MXTPU_CONV_PRECISION", "float32")
    jax_seed(152)
    shapes = {"data": (2, SMALL["seq_len"]),
              "softmax_label": (2, SMALL["seq_len"])}
    jt = JTrainer(jtrm.transformer_lm(**SMALL), optimizer="sgd",
                  optimizer_params={"lr": 0.1}, remat=True)
    jt.init(**shapes)
    w0 = {k: v.asnumpy() for k, v in jt.get_params()[0].items()}
    d = _batch()
    for _ in range(3):
        jt.step(data=d, softmax_label=d)
    jax_after = {k: v.asnumpy() for k, v in jt.get_params()[0].items()}
    port = _remat_lm_steps(w0)
    ulp = _remat_lm_steps({k: np.nextafter(v, np.float32(np.inf))
                           for k, v in w0.items()})
    gap = max(float(np.abs(port[k] - jax_after[k]).max()) for k in port)
    spread = max(float(np.abs(port[k] - ulp[k]).max()) for k in port)
    assert gap > 1e-5
    assert spread > 0.5 * gap, (gap, spread)

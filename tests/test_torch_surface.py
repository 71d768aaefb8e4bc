"""MXNet's classic top-level surface on the port, against the JAX package,
on the CPU: ``Context`` (equalities, hashing, ``with`` scoping of the
``nd`` creators, ``cpu_pinned``, ``num_devices``), ``mx.random``'s
samplers by statistics, the resource manager (``tests/test_resource.py``
mirrored, with the ``kRandom`` streams equal to the reference's for the
same seed), ``print_summary`` and ``plot_network`` giving the
reference's text on the zoo's resnet-18 and inception-bn,
``test_utils`` (``check_numeric_gradient`` on FC and tanh as
``tests/test_executor.py`` runs it, ``get_synthetic_mnist`` equal to the
reference's arrays), and the reference's top-level names: each is
exported by the port or listed here with the ROADMAP item it waits for.

Tolerances: the samplers' means and deviations within 0.05 over 20000
draws; the finite differences at the reference's own (eps 1e-2, rtol
5e-2); everything else exact.
"""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import models as jmodels

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import ndarray as nd
from mxnet_tpu_torch import symbol as sym
from mxnet_tpu_torch.resource import Resource, ResourceManager, \
    ResourceRequest

# the reference's top-level names the port does not export yet, with the
# ROADMAP Queue 1 item each waits for
WAITING = {"kvstore_server": 10}


# ------------------------------------------------------------- Context
def test_context_equalities_and_hash():
    assert mx.gpu(0) == mx.Context("gpu", 0)
    assert mx.Context("gpu", 0) == mx.gpu(0)
    assert mx.tpu(1) == mx.gpu(1) == mx.Context("tpu", 1)
    # a cpu Context of any id names the one host device
    assert mx.cpu() == mx.Context("cpu", 0) and mx.cpu() == \
        mx.Context("cpu", 3)
    assert mx.Context("gpu", 0) != mx.Context("tpu", 0)
    assert mx.Context("cpu", 0) != mx.Context("cpu", 1)
    assert mx.Context("gpu", 1) != mx.gpu(0)
    assert mx.cpu_pinned(0) != mx.cpu() and mx.cpu_pinned(0) != \
        mx.Context("cpu", 0)
    assert {mx.Context("gpu", 2): "x"}[mx.gpu(2)] == "x"
    assert hash(mx.Context("cpu", 1)) == hash(mx.cpu())
    assert mx.Context(mx.Context("tpu", 2)) == mx.Context("tpu", 2)
    assert mx.Context(torch.device("cuda", 1)) == mx.Context("gpu", 1)
    assert mx.Context("tpu", 3).device_type == "tpu"
    assert mx.Context("tpu", 3).device_id == 3
    assert repr(mx.Context("cpu_pinned", 1)) == "cpu_pinned(1)"
    assert mx.Context.devtype2str == jmx.Context.devtype2str
    assert mx.Context.devstr2type == jmx.Context.devstr2type
    with pytest.raises(MXNetError):
        mx.Context("fpga")


@pytest.fixture()
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks what the port does without a card")


def test_resolve_device_takes_contexts(no_card):
    assert mx.resolve_device(mx.Context("cpu", 2)) == torch.device("cpu")
    assert mx.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(MXNetError, match="no CUDA device"):
        mx.resolve_device(mx.Context("gpu", 0))
    with pytest.raises(MXNetError, match="no CUDA device"):
        mx.resolve_device("tpu")


def test_with_context_scopes_the_nd_creators(no_card):
    with pytest.raises(MXNetError):
        nd.zeros((2,))              # the card by default; there is none
    with mx.Context("cpu"):
        a = nd.zeros((2, 3))
        b = nd.array([1, 2])
        assert mx.current_context() == mx.cpu()
        with mx.Context("cpu", 1):
            assert nd.ones((1,)).context == torch.device("cpu")
    assert a.context == torch.device("cpu") and b.context.type == "cpu"
    with pytest.raises(MXNetError):
        mx.current_context()


def test_context_scope_is_per_thread():
    seen = []
    with mx.Context("cpu"):
        t = threading.Thread(target=lambda: seen.append(
            pytest.raises(MXNetError, mx.current_context)))
        t.start()
        t.join(timeout=30)
    assert not t.is_alive() and len(seen) == 1


def test_cpu_pinned_needs_a_card(no_card):
    with pytest.raises(MXNetError, match="pinned"):
        nd.zeros((4,), ctx=mx.cpu_pinned())
    with mx.cpu_pinned():
        with pytest.raises(MXNetError, match="pinned"):
            nd.array([1.0, 2.0])
    a = nd.ones((2,), ctx="cpu")
    with pytest.raises(MXNetError, match="pinned"):
        a.copyto(mx.cpu_pinned())


def test_num_devices():
    assert mx.num_devices("cpu") == 1 == mx.num_devices("cpu_pinned")
    assert mx.num_devices("gpu") == mx.num_devices() == (
        torch.cuda.device_count() if torch.cuda.is_available() else 0)
    with pytest.raises(MXNetError):
        mx.num_devices("fpga")


# -------------------------------------------------------------- random
def test_random_uniform_and_normal_statistics():
    mx.random.seed(3)
    u = mx.random.uniform(-1.0, 3.0, shape=(20000,), ctx="cpu").asnumpy()
    assert u.min() >= -1.0 and u.max() < 3.0
    assert abs(u.mean() - 1.0) < 0.05
    assert abs(u.std() - 4.0 / np.sqrt(12.0)) < 0.05
    n = mx.random.normal(2.0, 0.5, shape=(20000,), ctx="cpu").asnumpy()
    assert abs(n.mean() - 2.0) < 0.05 and abs(n.std() - 0.5) < 0.05
    mx.random.seed(3)
    again = mx.random.uniform(-1.0, 3.0, shape=(20000,), ctx="cpu")
    np.testing.assert_array_equal(again.asnumpy(), u)
    assert mx.random.uniform(shape=None, ctx="cpu").shape == (1,)


# ------------------------------------------------ tests/test_resource.py
def test_temp_space_reuse_and_growth():
    rm = ResourceManager.get()
    res = rm.request(mx.cpu(), ResourceRequest.kTempSpace)
    a = res.get_space((16,), np.float32)
    a[:] = 7.0
    b = res.get_space((8,), np.float32)
    assert b.ctypes.data == a.ctypes.data
    big = res.get_space((64, 64), np.float64)
    assert big.shape == (64, 64)
    assert big.nbytes >= 64 * 64 * 8


def test_temp_space_round_robin_bounded(monkeypatch):
    monkeypatch.setenv("MXNET_EXEC_NUM_TEMP", "2")
    rm = ResourceManager()
    r1 = rm.request(mx.cpu(), ResourceRequest.kTempSpace)
    r2 = rm.request(mx.cpu(), ResourceRequest.kTempSpace)
    r3 = rm.request(mx.cpu(), ResourceRequest.kTempSpace)
    r4 = rm.request(mx.cpu(), ResourceRequest.kTempSpace)
    assert r1 is not r2
    assert {id(r3), id(r4)} <= {id(r1), id(r2)}


def test_random_resource_seeding():
    rm = ResourceManager.get()
    res = rm.request(mx.cpu(), ResourceRequest.kRandom)
    mx.random.seed(42)
    x = res.generator().normal(size=4)
    mx.random.seed(42)
    y = res.generator().normal(size=4)
    assert np.allclose(x, y)
    assert rm.request(mx.cpu(), ResourceRequest.kRandom) is res


def test_request_accepts_strings_and_rejects_junk():
    rm = ResourceManager()
    assert isinstance(rm.request(mx.cpu(), "temp_space"), Resource)
    with pytest.raises(MXNetError):
        rm.request(mx.cpu(), "workspace")


def test_random_resource_streams_equal_the_reference():
    jres = jmx.resource.ResourceManager.get().request(
        jmx.cpu(), jmx.resource.ResourceRequest.kRandom)
    tres = ResourceManager.get().request(mx.cpu(), ResourceRequest.kRandom)
    for seed in (0, 42, 12345):
        jmx.random.seed(seed)
        mx.random.seed(seed)
        np.testing.assert_array_equal(tres.generator().normal(size=16),
                                      jres.generator().normal(size=16))
        np.testing.assert_array_equal(
            tres.generator().integers(0, 100, 8),
            jres.generator().integers(0, 100, 8))


# ------------------------------------------------------- visualization
def _zoo_pair(monkeypatch, name):
    """The zoo builder's symbol from each package, fresh auto-namers on
    both sides."""
    from mxnet_tpu import base as jbase
    from mxnet_tpu_torch import base as tbase

    monkeypatch.setattr(tbase, "_NAME_MANAGER", tbase.NameManager())
    with jbase.NameManager():
        jnet = jmodels.get_symbol(name, num_classes=10)
    return jnet, tmodels.get_symbol(name, num_classes=10)


@pytest.mark.parametrize("name", ["resnet-18", "inception-bn"])
def test_print_summary_is_the_reference_table(monkeypatch, capsys, name):
    jnet, tnet = _zoo_pair(monkeypatch, name)
    shape = {"data": (1, 3, 224, 224)}
    jtotal = jmx.viz.print_summary(jnet, shape=shape)
    want = capsys.readouterr().out
    total = mx.viz.print_summary(tnet, shape=shape)
    got = capsys.readouterr().out
    assert total == jtotal and got == want
    assert f"Total params: {total}" in got


@pytest.mark.parametrize("name", ["resnet-18", "inception-bn"])
@pytest.mark.parametrize("hide", [True, False])
def test_plot_network_is_the_reference_dot(monkeypatch, name, hide):
    jnet, tnet = _zoo_pair(monkeypatch, name)
    shape = {"data": (1, 3, 224, 224)}
    want = jmx.viz.plot_network(jnet, shape=shape, hide_weights=hide).source
    got = mx.viz.plot_network(tnet, shape=shape, hide_weights=hide).source
    assert got == want and got.startswith('digraph "plot"')


def test_visualization_refuses_what_is_not_a_symbol():
    with pytest.raises(MXNetError):
        mx.visualization.plot_network("net")
    with pytest.raises(MXNetError):
        mx.visualization.print_summary(None)


# ---------------------------------------------------------- test_utils
def test_check_numeric_gradient_fc():
    from mxnet_tpu_torch.test_utils import check_numeric_gradient

    fc = sym.FullyConnected(sym.Variable("data"), name="fc", num_hidden=4)
    rs = np.random.RandomState(3)
    loc = {"data": rs.randn(3, 5).astype(np.float32),
           "fc_weight": rs.randn(4, 5).astype(np.float32),
           "fc_bias": rs.randn(4).astype(np.float32)}
    check_numeric_gradient(fc, loc, numeric_eps=1e-2, rtol=5e-2,
                           ctx=mx.cpu())


def test_check_numeric_gradient_tanh():
    from mxnet_tpu_torch.test_utils import check_numeric_gradient

    net = sym.Activation(sym.Variable("data"), act_type="tanh")
    loc = {"data": np.random.RandomState(4).randn(4, 4).astype(np.float32)}
    with mx.Context("cpu"):
        check_numeric_gradient(net, loc, numeric_eps=1e-2, rtol=5e-2)


def test_check_numeric_gradient_fails_past_its_tolerance():
    """A coarse difference (eps 0.5) against tanh's exact gradient at a
    tolerance of 1e-6: the helper raises."""
    from mxnet_tpu_torch.test_utils import check_numeric_gradient

    net = sym.Activation(sym.Variable("data"), act_type="tanh")
    loc = {"data": np.random.RandomState(4).randn(3, 3).astype(np.float32)}
    with pytest.raises(AssertionError):
        check_numeric_gradient(net, loc, numeric_eps=0.5, rtol=1e-6,
                               atol=1e-6, ctx=mx.cpu())


def test_symbolic_forward_backward_and_consistency_helpers():
    from mxnet_tpu_torch import test_utils as tu

    net = sym.exp(sym.Variable("a"))
    x = np.random.RandomState(5).rand(3, 3).astype(np.float32)
    with mx.Context("cpu"):
        tu.check_symbolic_forward(net, {"a": x}, np.exp(x), rtol=1e-5)
        tu.check_symbolic_backward(net, {"a": x}, [np.ones_like(x)],
                                   {"a": np.exp(x)}, rtol=1e-5)
    res = tu.check_consistency(net, [{"ctx": mx.cpu(), "a": (3, 3)},
                                     {"ctx": mx.Context("cpu"), "a": (3, 3)}])
    assert len(res) == 2
    assert tu.almost_equal(x, x + 1e-7) and not tu.almost_equal(x, x + 1)
    tu.assert_almost_equal(nd.array(x, ctx="cpu"), x)
    assert tu.same(nd.array(x, ctx="cpu"), x)
    assert tu.default_tols(np.zeros(1, np.float16)) == (1e-2, 1e-3)
    assert tu.check_speed(net, {"a": x}, ctx=mx.cpu(), n=2) > 0
    assert tu.rand_ndarray((2, 2), ctx="cpu").shape == (2, 2)


def test_get_synthetic_mnist_is_the_reference():
    from mxnet_tpu.test_utils import get_synthetic_mnist as jmnist
    from mxnet_tpu_torch.test_utils import get_synthetic_mnist as tmnist

    for args in ((64, 16), (32, 8, 3)):
        for a, b in zip(tmnist(*args), jmnist(*args)):
            for x, y in zip(a, b):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


# ---------------------------------------------------- top-level names
def _reference_exports():
    """The public names ``mxnet_tpu/__init__.py`` binds (its imports;
    ``dir()`` would also hold whatever submodules other tests imported)."""
    import ast
    import os

    path = os.path.join(os.path.dirname(jmx.__file__), "__init__.py")
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)) and (
                not isinstance(node, ast.ImportFrom) or node.level == 1):
            names.update(a.asname or a.name.split(".")[0]
                         for a in node.names)
    return {n for n in names if not n.startswith("_")}


def test_top_level_names_are_exported_or_listed():
    jnames = _reference_exports()
    assert len(jnames) > 60 and "FeedForward" in jnames
    tnames = {n for n in dir(mx) if not n.startswith("_")}
    assert jnames - tnames == set(WAITING)
    for name in ("Context", "cpu_pinned", "tpu", "num_devices", "engine",
                 "random", "ops", "FeedForward", "executor_manager",
                 "resource", "ResourceRequest", "ResourceManager",
                 "operator", "profiler", "faults", "visualization", "viz",
                 "test_utils"):
        assert name in tnames, name
    assert mx.viz is mx.visualization
    assert mx.model.FeedForward is mx.FeedForward


# ------------------------------------------------------------ AttrScope
def _scoped_net(mxmod):
    s = mxmod.symbol
    with mxmod.AttrScope(ctx_group="dev1", lr="0.5"):
        data = s.Variable("data", attr={"lr": "2"})
        fc = s.FullyConnected(data, num_hidden=4, name="fc")
        with mxmod.AttrScope(ctx_group="dev2", tag=7):
            act = s.Activation(fc, act_type="relu", name="act")
            w = s.Variable("w")
    out = s.FullyConnected(act, weight=w, num_hidden=2, name="out")
    return s.Group([out, s.Variable("plain")])


def test_attr_scope_merges_like_the_reference():
    """Scoped attrs land on every new Variable and op node (the call's
    own ``attr`` winning), nested scopes merge outer then inner, and
    nodes outside every scope get none: the port's ``attr_dict()``
    equals the JAX package's."""
    t, j = _scoped_net(mx), _scoped_net(jmx)
    assert t.attr_dict() == j.attr_dict()
    got = t.attr_dict()
    assert got["data"] == {"ctx_group": "dev1", "lr": "2"}
    assert got["fc"] == {"ctx_group": "dev1", "lr": "0.5"}
    assert got["act"] == got["w"] == {"ctx_group": "dev2", "lr": "0.5",
                                      "tag": "7"}
    assert "out" not in got and "plain" not in got
    assert mx.base.current_attr_scope() is None
    # the weight FullyConnected creates for itself is scoped too
    assert got["fc_weight"] == {"ctx_group": "dev1", "lr": "0.5"}

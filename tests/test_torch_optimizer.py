"""The port's optimizers against the JAX package's, on the CPU: five
updates of each ported optimizer through its ``Updater`` from the same
weights and gradients, the lr and wd multipliers by name, the registry,
fp32 master weights, and ``Updater`` states pickled in one package and
loaded in the other.

Weights and gradients come from numpy seeds and go to both packages;
tolerances are stated where they are used.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu import nd as jnd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu import symbol as jsym

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch import symbol as tsym

CPU = "cpu"
SHAPES = [(3, 4), (5,), (2, 3, 2, 2)]


def _data(seed, steps=5):
    rs = np.random.RandomState(seed)
    ws = [rs.uniform(-1, 1, s).astype(np.float32) for s in SHAPES]
    gs = [[rs.uniform(-1, 1, s).astype(np.float32) for s in SHAPES]
          for _ in range(steps)]
    return ws, gs


def _run(pkg, name, kw, ws, gs):
    """Weights and states after ``len(gs)`` updater calls per key."""
    if pkg == "jax":
        o = jopt.create(name, **kw)
        upd = jopt.get_updater(o)
        arr = lambda a: jnd.array(a)  # noqa: E731
    else:
        o = topt.create(name, **kw)
        upd = topt.get_updater(o)
        arr = lambda a: tnd.array(a, ctx=CPU)  # noqa: E731
    weights = [arr(w) for w in ws]
    for step in gs:
        for i, g in enumerate(step):
            upd(i, arr(g), weights[i])
    return [w.asnumpy() for w in weights], upd


def _flat_states(upd):
    out = []
    for k in sorted(upd.states):
        st = upd.states[k]
        for s in (st if isinstance(st, tuple) else (st,)):
            if s is not None:
                out.append(s.asnumpy())
    return out


IDX2NAME = {0: "fc_weight", 1: "fc_bias", 2: "conv_weight"}
OPTIMIZERS = [
    ("sgd", {"learning_rate": 0.1}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-2,
             "rescale_grad": 0.5}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "clip_gradient": 0.3}),
    ("ccsgd", {"learning_rate": 0.05, "momentum": 0.5}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-2}),
    ("nag", {"learning_rate": 0.1, "clip_gradient": 0.2}),
    ("adam", {"learning_rate": 0.01, "wd": 1e-2, "rescale_grad": 0.5}),
    ("adam", {"learning_rate": 0.01, "clip_gradient": 0.3}),
    ("adagrad", {"learning_rate": 0.1, "wd": 1e-2}),
    ("rmsprop", {"learning_rate": 0.01, "wd": 1e-2}),
    ("rmsprop", {"learning_rate": 0.01, "clip_weights": 0.4}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True,
                 "clip_gradient": 0.5}),
    ("adadelta", {"wd": 1e-2}),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-2}),
    ("dcasgd", {"learning_rate": 0.1}),
    ("test", {"rescale_grad": 0.5}),
]


@pytest.mark.parametrize("name,kw", OPTIMIZERS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(OPTIMIZERS)])
def test_five_updates_match_jax(name, kw):
    ws, gs = _data(0)
    kw = dict(kw, param_idx2name=IDX2NAME)
    jw, jupd = _run("jax", name, kw, ws, gs)
    tw, tupd = _run("port", name, kw, ws, gs)
    # fp32 elementwise arithmetic, op for op, both sides: weights and
    # states agree to a few fp32 ulps over five steps
    for a, b in zip(tw, jw):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    for a, b in zip(_flat_states(tupd), _flat_states(jupd)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    assert any(not np.array_equal(a, w) for a, w in zip(tw, ws))


def test_sgld_noise_has_the_reference_scale():
    """SGLD draws its noise from each package's own generator; with a
    zero gradient the step is ``N(0, lr)`` noise in both."""
    w0 = [np.zeros((200, 200), np.float32)]
    stds = []
    for pkg in ("jax", "port"):
        mod = jopt if pkg == "jax" else topt
        arr = (jnd.array if pkg == "jax"
               else (lambda a: tnd.array(a, ctx=CPU)))
        o = mod.create("sgld", learning_rate=0.01)
        w = arr(w0[0])
        o.update(0, w, arr(np.zeros_like(w0[0])), None)
        stds.append(float(w.asnumpy().std()))
    # sqrt(0.01) = 0.1; 40000 draws: within 2 % of it
    for s in stds:
        assert s == pytest.approx(0.1, rel=0.02)


def test_multipliers_by_name_match_jax():
    d = jsym.Variable("data")
    w = jsym.Variable("fc_weight", lr_mult=2.0)
    b = jsym.Variable("fc_bias", wd_mult=3.0)
    jnet = jsym.FullyConnected(d, w, b, name="fc", num_hidden=2)
    jnet = jsym.BatchNorm(jnet, name="bn")
    tnet = tsym.load_json(jnet.tojson())
    names = [n for n in jnet.list_arguments() if n != "data"]
    idx2name = dict(enumerate(names))
    jo = jopt.create("sgd", learning_rate=0.5, wd=0.1, sym=jnet,
                     param_idx2name=idx2name)
    to = topt.create("sgd", learning_rate=0.5, wd=0.1, sym=tnet,
                     param_idx2name=idx2name)
    for i, n in idx2name.items():
        assert to._get_lr(i) == jo._get_lr(i), n
        assert to._get_wd(i) == jo._get_wd(i), n
    # the attrs win over the name rule; biases, betas decay not at all
    assert to._get_lr(0) == 1.0 and to._get_wd(1) == pytest.approx(0.3)
    assert to._get_wd(names.index("bn_beta")) == 0.0
    assert to._get_wd(names.index("bn_gamma")) == pytest.approx(0.1)
    to.set_lr_mult({"fc_weight": 0.0})
    assert to._get_lr(0) == 0.0


def test_lr_scheduler_drives_the_rate_as_jax():
    from mxnet_tpu import lr_scheduler as jlrs
    from mxnet_tpu_torch import lr_scheduler as tlrs

    deltas = {}
    for pkg, mod, lrs, arr in (
            ("jax", jopt, jlrs, jnd.array),
            ("port", topt, tlrs, lambda a: tnd.array(a, ctx=CPU))):
        o = mod.create("sgd", learning_rate=1.0,
                       lr_scheduler=lrs.FactorScheduler(step=2, factor=0.5))
        w = arr(np.zeros(1, np.float32))
        g = arr(np.ones(1, np.float32))
        out = []
        for _ in range(6):
            o.update(0, w, g, None)
            out.append(float(w.asnumpy()[0]))
        deltas[pkg] = out
    assert deltas["port"] == deltas["jax"]


def test_registry_has_the_reference_names():
    names = ("sgd", "nag", "sgld", "ccsgd", "adam", "adagrad", "rmsprop",
             "adadelta", "dcasgd", "test")
    for name in names:
        assert isinstance(topt.create(name), topt.Optimizer), name
        assert type(topt.create(name)).__name__ == \
            type(jopt.create(name)).__name__
    with pytest.raises(MXNetError, match="unknown optimizer"):
        topt.create("nosuch")
    assert topt.create("sgd", lr=0.3).lr == 0.3


@pytest.mark.parametrize("name,kw,want", [
    ("sgd", {"momentum": 0.9}, "sgd"), ("ccsgd", {}, "sgd"),
    ("adam", {}, "adam"), ("rmsprop", {}, "rmsprop"),
    ("nag", {"momentum": 0.9}, None), ("rmsprop", {"centered": True}, None),
    ("adagrad", {}, None)])
def test_fused_rule_gates_as_jax(name, kw, want):
    t, j = topt.create(name, **kw).fused_rule(), \
        jopt.create(name, **kw).fused_rule()
    assert (t and t[0]) == want == (j and j[0])
    if t is not None:
        assert t[1] == j[1]


def test_master_weights_follow_the_fp32_update():
    """bf16 weights with ``multi_precision``: the fp32 master (the last
    state slot) takes the fp32 update of the bf16 gradients; the weight
    is its cast."""
    ws, gs = _data(1)
    w32, _ = _run("port", "sgd", {"learning_rate": 0.1, "momentum": 0.9},
                  ws, gs)
    o = topt.create("sgd", learning_rate=0.1, momentum=0.9,
                    multi_precision=True)
    upd = topt.get_updater(o)
    weights = [tnd.NDArray(torch.from_numpy(w).bfloat16()) for w in ws]
    for step in gs:
        for i, g in enumerate(step):
            upd(i, tnd.NDArray(torch.from_numpy(g).bfloat16()), weights[i])
    for i, w in enumerate(weights):
        mom, master = upd.states[i]
        assert master.tensor.dtype == torch.float32
        assert w.tensor.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            w.tensor.float().numpy(), master.tensor.bfloat16().float().numpy())
        # the master saw bf16-rounded gradients: within bf16's 2^-8 of
        # the fp32 run after five steps
        np.testing.assert_allclose(master.asnumpy(), w32[i], rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("name,kw", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01}),
    ("dcasgd", {"learning_rate": 0.1})])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_updater_states_load_across_packages(name, kw, writer):
    """Two updates in ``writer``, its pickled states loaded by the other
    package, then three more updates each from the same weights: equal
    trajectories."""
    ws, gs = _data(2)
    reader = "port" if writer == "jax" else "jax"
    w_mid, upd = _run(writer, name, kw, ws, gs[:2])
    blob = upd.get_states()
    rest = gs[2:]
    want, _ = _run(writer, name, kw, ws, gs)
    mod = topt if reader == "port" else jopt
    arr = ((lambda a: tnd.array(a, ctx=CPU)) if reader == "port"
           else jnd.array)
    o = mod.create(name, **kw)
    if name == "adam":
        # Adam's bias correction counts updates per key: carry the count
        o._index_update_count = {i: 2 for i in range(len(SHAPES))}
        o.num_update = 2
    upd2 = mod.get_updater(o)
    upd2.set_states(blob)
    weights = [arr(w) for w in w_mid]
    for step in rest:
        for i, g in enumerate(step):
            upd2(i, arr(g), weights[i])
    for a, b in zip(weights, want):
        np.testing.assert_allclose(a.asnumpy(), b, rtol=1e-6, atol=1e-7)


def test_loaded_states_take_the_weights_layout():
    o = topt.create("sgd", learning_rate=0.1, momentum=0.9)
    upd = topt.get_updater(o)
    w = tnd.NDArray(torch.ones(2, 3, 4, 4).contiguous(
        memory_format=torch.channels_last))
    upd(0, tnd.NDArray(torch.ones(2, 3, 4, 4)), w)
    assert upd.states[0].tensor.is_contiguous(
        memory_format=torch.channels_last)
    upd2 = topt.get_updater(o)
    upd2.set_states(upd.get_states())
    st = upd2.ensure_state(0, w)
    assert st.tensor.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(st.asnumpy(), upd.states[0].asnumpy())
    with pytest.raises(MXNetError, match="shape"):
        upd3 = topt.get_updater(o)
        upd3.set_states(upd.get_states())
        upd3.ensure_state(0, tnd.zeros((5,), ctx=CPU))

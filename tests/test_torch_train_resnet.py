"""ResNet training in the port against the JAX package, on the CPU: the
``models.get_symbol`` dispatcher, ``FusedTrainer`` steps from the same
weights, ``step_multi`` against k calls of ``step``, the channels-last
weight storage and the initializers.

Weights go across as numpy arrays (``convert.load_trainer_params``);
batches come from numpy seeds.  The JAX side runs its convolutions in
true fp32 (``MXTPU_CONV_PRECISION=float32``).

Conditioning.  Deep pre-activation ResNets at small images and batches
are ill-conditioned: at resnet-20, 3 x 32 x 32, batch 16, the port's
own first SGD update moves by up to 1.2e-2 of its norm (median 6.7e-3)
when only its CPU convolution backend changes (mkldnn on against off),
so no fp32 tolerance can tell a fault from rounding there.  The fp32
parity runs where the step is well-conditioned instead: resnet-8 at
3 x 16 x 16, batch 32, He-normal weights and unit-normal data, where
the same backend swap moves the update by at most 4e-5 of its norm.
ResNet-50 at 2 x 3 x 64 x 64 in bf16 is chaotic (its first updates in
the two packages have a median cosine of 0.06), so it is held loosely,
on what does not depend on rounding.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import models as jmodels
from mxnet_tpu import symbol as jsym
from mxnet_tpu.trainer import FusedTrainer as JTrainer

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch import lr_scheduler as tlrs
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.trainer import FusedTrainer as TTrainer

SGD = {"lr": 0.1, "momentum": 0.9}


# ------------------------------------------------------------ get_symbol
@pytest.mark.parametrize("name,kw", [
    ("resnet-50", {}),
    ("resnet-50", {"num_classes": 10, "image_shape": (3, 64, 64)}),
    ("resnet-18", {"num_classes": 100}),
    ("resnet-20", {"num_classes": 10, "image_shape": (3, 32, 32)}),
    ("resnet", {"num_classes": 10, "num_layers": 8,
                "image_shape": (3, 16, 16)}),
    ("transformer-lm", {"num_classes": 97, "num_layers": 1, "num_heads": 2,
                        "d_model": 16, "seq_len": 8}),
    ("transformer-lm", {"num_classes": 97, "num_layers": 2, "num_heads": 2,
                        "d_model": 16, "seq_len": 8, "dropout": 0.1}),
    ("mlp", {"num_classes": 10}),
    ("lenet", {"num_classes": 10}),
    ("alexnet", {}),
    ("vgg", {}),
    ("googlenet", {}),
    ("inception-bn", {}),
    ("inception-v3", {}),
    ("inception-resnet-v2", {}),
    ("resnext", {}),
    ("resnext-50", {"num_classes": 10}),
])
def test_get_symbol_matches_jax(monkeypatch, name, kw):
    # fresh auto-namers on both sides: the residual adds are named by a
    # process-wide counter
    from mxnet_tpu import base as jbase
    from mxnet_tpu_torch import base as tbase

    monkeypatch.setattr(tbase, "_NAME_MANAGER", tbase.NameManager())
    with jbase.NameManager():
        want = jmodels.get_symbol(name, **kw).tojson()
    assert tmodels.get_symbol(name, **kw).tojson() == want


@pytest.mark.parametrize("name", ["ssd-vgg16"])
def test_get_symbol_refuses_builders_not_ported(monkeypatch, name):
    # no builder is left unported: the last one (ssd-vgg16, SSD's
    # training graph) builds the JAX dispatcher's graph
    from mxnet_tpu import base as jbase
    from mxnet_tpu_torch import base as tbase

    assert None not in tmodels._BUILDERS.values()
    monkeypatch.setattr(tbase, "_NAME_MANAGER", tbase.NameManager())
    with jbase.NameManager():
        want = jmodels.get_symbol(name).tojson()
    assert tmodels.get_symbol(name).tojson() == want


def test_get_symbol_unknown_name_raises_as_jax():
    with pytest.raises(ValueError) as jerr:
        jmodels.get_symbol("no-such-net")
    with pytest.raises(ValueError) as terr:
        tmodels.get_symbol("no-such-net")
    assert str(terr.value) == str(jerr.value)


# --------------------------------------------------------------- steps
def _pair(name, shape, batch, dtype, opt, init=None, classes=10, **kw):
    """A JAX and a port FusedTrainer over the same ResNet from the same
    weights (the JAX initializer's, copied across as numpy)."""
    jmx.random.seed(0)
    np.random.seed(0)
    jt = JTrainer(jmodels.get_symbol(name, num_classes=classes,
                                     image_shape=shape),
                  optimizer="sgd", optimizer_params=dict(opt),
                  initializer=init, dtype=dtype, **kw)
    jt.init(data=(batch,) + shape)
    tt = TTrainer(tmodels.get_symbol(name, num_classes=classes,
                                     image_shape=shape),
                  optimizer="sgd", optimizer_params=dict(opt),
                  dtype=dtype, device="cpu", **kw)
    tt.init(data=(batch,) + shape)
    arg, aux = jt.get_params()
    arg = {k: v.asnumpy() for k, v in arg.items()}
    aux = {k: v.asnumpy() for k, v in aux.items()}
    convert.load_trainer_params(tt, arg, aux)
    return jt, tt, arg


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_params(jt):
    arg, aux = jt.get_params()
    return ({k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()})


def test_resnet8_fp32_sgd_steps_match_jax(monkeypatch):
    monkeypatch.setenv("MXTPU_CONV_PRECISION", "float32")
    b, shape = 32, (3, 16, 16)
    he = jmx.init.Xavier(rnd_type="gaussian", factor_type="in",
                         magnitude=2)
    # no weight decay here (tests/test_torch_trainer.py holds it): over
    # several steps a ReLU or pooling choice that flips under a rounding
    # change moves some updates by ~1e-3 whatever the package, and with
    # wd 1e-4 these batches hit such a flip at step 2
    opt = dict(SGD, rescale_grad=1.0 / b)
    jt, tt, start = _pair("resnet-8", shape, b, "float32", opt, init=he)
    rs = np.random.RandomState(1)
    for _ in range(3):
        d = rs.normal(0, 1, (b,) + shape).astype(np.float32)
        lab = rs.randint(0, 10, b).astype(np.float32)
        jo = np.asarray(jt.step(data=d, softmax_label=lab)[0])
        to = tt.step(data=d, softmax_label=lab)[0].numpy()
        # same weights, fp32 both sides: the probabilities agree to fp32
        # reassociation over 8 layers (measured 8e-7 relative)
        assert _rel(to, jo) <= 1e-5
    jarg, jaux = _jax_params(jt)
    targ, taux = tt.get_params()
    for k, w in targ.items():
        # each parameter's 3-step change agrees to 1e-4 of the change
        # (measured 1.8e-5 at most), so also to 1e-4 of the parameter
        moved = jarg[k] - start[k]
        if np.linalg.norm(moved) == 0:  # bn_data_gamma: fix_gamma
            np.testing.assert_array_equal(w.numpy(), jarg[k])
            continue
        assert _rel(w.numpy() - start[k], moved) <= 1e-4, k
        assert _rel(w.numpy(), jarg[k]) <= 1e-4, k
    for k, v in taux.items():
        assert _rel(v.numpy(), jaux[k]) <= 1e-4, k
    # the momenta too: the JAX state of a channels-last (HWIO) weight is
    # stored transposed, so compare norms and the flattened OIHW copy
    for k, st in tt.opt_state.items():
        jm = np.asarray(jt.opt_state[k][0])
        if k in jt._hwio:
            jm = jm.transpose(3, 2, 0, 1)
        if np.linalg.norm(jm) == 0:
            continue
        assert _rel(st[0].numpy(), jm) <= 1e-4, k


def test_resnet50_bf16_steps_match_jax_loosely(monkeypatch):
    monkeypatch.setenv("MXTPU_CONV_PRECISION", "float32")
    b, shape = 2, (3, 64, 64)
    # lr 0.02: at 0.1 this batch of 2 overshoots on the third step in
    # one package and not the other (cross-entropy 2.45, 0.63, 3.57 in
    # the port, 2.45, 0.74, 0.016 in JAX), which says nothing of either
    jt, tt, start = _pair("resnet-50", shape, b, "bfloat16",
                          dict(SGD, lr=0.02, rescale_grad=1.0 / b))
    rs = np.random.RandomState(2)
    d = rs.uniform(0, 1, (b,) + shape).astype(np.float32)
    lab = np.array([3.0, 7.0], np.float32)
    jce, tce = [], []
    for _ in range(3):
        jo = np.asarray(jt.step(data=d, softmax_label=lab)[0], np.float32)
        to = tt.step(data=d, softmax_label=lab)[0].float().numpy()
        assert to.shape == jo.shape == (b, 10)
        assert np.isfinite(to).all()
        for ce, p in ((jce, jo), (tce, to)):
            ce.append(float(-np.log(np.maximum(
                p[np.arange(b), lab.astype(int)], 1e-30)).mean()))
    # the first step's forward runs on the same weights: its loss agrees
    # to 1e-2 (measured 2e-3); then both packages drive the loss of the
    # repeated batch down at every step (measured 2.45, 0.72, 0.11 in
    # the port and 2.45, 0.83, 0.10 in JAX)
    assert abs(tce[0] - jce[0]) <= 1e-2 * jce[0], (tce, jce)
    for ce in (tce, jce):
        assert ce[0] > ce[1] > ce[2], (tce, jce)
    # the state each step writes: bf16 copies of the new masters, fp32
    # masters and aux states that moved
    jarg, jaux = _jax_params(jt)
    targ, taux = tt.get_params()
    assert sorted(targ) == sorted(jarg) and sorted(taux) == sorted(jaux)
    for k, w in tt.params.items():
        assert w.dtype == torch.float32 and tuple(w.shape) == jarg[k].shape
        assert torch.equal(tt._cparams[k], w.to(torch.bfloat16)), k
    assert all(not np.array_equal(taux[k].numpy(), start.get(k, 0))
               for k in taux)


# ---------------------------------------------------------- step_multi
def _conv_net(tsym_or_jsym, classes=10):
    s = tsym_or_jsym
    data = s.Variable("data")
    net = s.Convolution(data, name="conv1", kernel=(3, 3), num_filter=8,
                        pad=(1, 1))
    net = s.BatchNorm(net, name="bn1", fix_gamma=False)
    net = s.Activation(net, act_type="relu")
    net = s.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = s.Convolution(net, name="conv2", kernel=(3, 3), num_filter=16)
    net = s.Activation(net, act_type="relu")
    net = s.Pooling(net, global_pool=True, kernel=(1, 1), pool_type="avg")
    net = s.FullyConnected(s.Flatten(net), name="fc", num_hidden=classes)
    return s.SoftmaxOutput(net, name="softmax")


def _batches(k, b, seed=0, shape=(1, 12, 12)):
    rs = np.random.RandomState(seed)
    return [(rs.normal(0, 1, (b,) + shape).astype(np.float32),
             rs.randint(0, 10, b).astype(np.float32)) for _ in range(k)]


def _port_trainer(dtype="bfloat16", sched=None, b=8, shape=(1, 12, 12)):
    t = TTrainer(_conv_net(tsym), optimizer="sgd",
                 optimizer_params=dict(SGD, rescale_grad=1.0 / b),
                 initializer=tinit.Xavier(generator=torch.Generator()
                                          .manual_seed(7)),
                 dtype=dtype, lr_scheduler=sched, device="cpu")
    return t.init(data=(b,) + shape)


@pytest.mark.parametrize("stacking", ["array", "tuple"])
def test_step_multi_equals_k_steps_under_a_schedule(stacking):
    # on the CPU step_multi runs its k steps through step(): the same
    # arithmetic in the same order, so the two land on the same bits
    k, b = 4, 8
    batches = _batches(k, b)
    seq = _port_trainer(sched=tlrs.FactorScheduler(step=2, factor=0.5))
    multi = _port_trainer(sched=tlrs.FactorScheduler(step=2, factor=0.5))
    want = [seq.step(data=x, softmax_label=y)[0] for x, y in batches]
    if stacking == "array":
        feed = {"data": np.stack([x for x, _ in batches]),
                "softmax_label": np.stack([y for _, y in batches])}
    else:
        feed = {"data": tuple(x for x, _ in batches),
                "softmax_label": tuple(y for _, y in batches)}
    outs = multi.step_multi(**feed)
    assert outs[0].shape == (k, b, 10)
    torch.testing.assert_close(outs[0], torch.stack(want), rtol=0, atol=0)
    assert multi._step == seq._step == k
    assert multi.current_lr() == seq.current_lr() == 0.1 * 0.5 ** 2
    for name in seq.params:
        torch.testing.assert_close(multi.params[name], seq.params[name],
                                   rtol=0, atol=0)
        torch.testing.assert_close(multi.aux.get(name, multi.params[name]),
                                   seq.aux.get(name, seq.params[name]))
    # a later plain step continues from the multi-step state
    x, y = batches[0]
    for t in (seq, multi):
        t.step(data=x, softmax_label=y)
    for name in seq.params:
        torch.testing.assert_close(multi.params[name], seq.params[name],
                                   rtol=0, atol=0)
    assert multi.current_lr() == seq.current_lr() == 0.1 * 0.5 ** 2


def test_step_multi_refuses_inputs_of_other_step_counts():
    t = _port_trainer()
    (x, y), = _batches(1, 8)
    with pytest.raises(MXNetError, match="same number of steps"):
        t.step_multi(data=np.stack([x, x]), softmax_label=y[None])
    with pytest.raises(MXNetError, match="differ in shape"):
        t.step_multi(data=(x, x[:4]), softmax_label=(y, y[:4]))
    assert t._step == 0
    with pytest.raises(MXNetError, match="init"):
        TTrainer(_conv_net(tsym), device="cpu").step_multi(data=x[None])


def test_step_multi_refuses_to_capture_random_ops():
    # a captured step would replay one draw: refused by name before any
    # work on the card, here for a net with a real Dropout
    data = tsym.Variable("data")
    net = tsym.FullyConnected(tsym.Flatten(data), num_hidden=16, name="fc1")
    net = tsym.Dropout(tsym.Activation(net, act_type="relu"), p=0.5)
    net = tsym.SoftmaxOutput(tsym.FullyConnected(net, num_hidden=10,
                                                 name="fc2"), name="softmax")
    t = TTrainer(net, optimizer="sgd", optimizer_params=dict(SGD),
                 device="cpu").init(data=(8, 1, 12, 12))
    with pytest.raises(MXNetError, match="random numbers.*Dropout"):
        t._capture({})
    # step() runs it, drawing from the trainer's generator
    x, y = _batches(1, 8)[0]
    a = t.step(data=x, softmax_label=y)[0]
    b = t.step(data=x, softmax_label=y)[0]
    assert bool(torch.isfinite(a).all()) and not torch.equal(a, b)


def test_step_state_keeps_its_storage():
    # what a captured step needs: every tensor the step reads or writes
    # is updated in place, never rebound
    t = _port_trainer()
    batches = _batches(3, 8)

    def ptrs():
        out = [v.data_ptr() for v in t._state()]
        out.append(t._lr.data_ptr())
        out += [v.data_ptr() for v in t._bufs.values()]
        return out

    x, y = batches[0]
    t.step(data=x, softmax_label=y)
    before = ptrs()
    aux0 = {k: v.clone() for k, v in t.aux.items()}
    t.step(data=batches[1][0], softmax_label=batches[1][1])
    t.step_multi(data=np.stack([x, x]), softmax_label=np.stack([y, y]))
    assert ptrs() == before
    assert all(not torch.equal(t.aux[k], aux0[k]) for k in aux0)
    assert float(t._lr) == np.float32(0.1)


@pytest.mark.parametrize("dtype,want", [("bfloat16", 1.0),
                                        ("float32", 1.0 + 2 ** -12)])
def test_aux_states_round_through_the_compute_dtype(dtype, want):
    # the reference hands the BN moving stats to the step in the compute
    # dtype and stores the update in fp32; with momentum 1 the update is
    # the stat itself, so bf16 rounds 1 + 2^-12 to 1 and fp32 keeps it
    data = tsym.Variable("data")
    net = tsym.BatchNorm(data, name="bn", fix_gamma=False, momentum=1.0)
    net = tsym.FullyConnected(tsym.Flatten(net), name="fc", num_hidden=3)
    t = TTrainer(tsym.SoftmaxOutput(net, name="softmax"), dtype=dtype,
                 device="cpu").init(data=(4, 2, 3, 3))
    t.aux["bn_moving_var"].fill_(1.0 + 2 ** -12)
    t.step(data=np.ones((4, 2, 3, 3), np.float32),
           softmax_label=np.zeros(4, np.float32))
    var = t.aux["bn_moving_var"]
    assert var.dtype == torch.float32
    assert var.tolist() == [want, want]


# ------------------------------------------------------ channels-last
def _tied_net(s):
    """c_weight feeds a conv and, squared, a second output: two kinds of
    consumer; c2_weight feeds only a conv."""
    data = s.Variable("data")
    w = s.Variable("c_weight")
    net = s.Convolution(data, weight=w, kernel=(3, 3), num_filter=4,
                        pad=(1, 1), name="c")
    plain = s.Convolution(net, kernel=(3, 3), num_filter=4, pad=(1, 1),
                          name="c2")
    pooled = s.Pooling(plain, global_pool=True, pool_type="avg",
                       kernel=(1, 1))
    head = s.SoftmaxOutput(s.FullyConnected(s.Flatten(pooled),
                                            num_hidden=3, name="fc"),
                           name="softmax")
    penalty = s.Flatten(s.elemwise_mul(w, w))
    return s.Group([head, penalty])


def test_channels_last_storage_leaves_out_multi_consumer_weights():
    jt = JTrainer(_tied_net(jsym), optimizer="sgd",
                  optimizer_params={"lr": 0.01})
    jt.init(data=(2, 3, 8, 8))
    tt = TTrainer(_tied_net(tsym), optimizer="sgd",
                  optimizer_params={"lr": 0.01, "momentum": 0.9},
                  dtype="bfloat16", device="cpu").init(data=(2, 3, 8, 8))
    assert tt._cl_params == jt._hwio == frozenset({"c2_weight"})
    cl = torch.channels_last
    for tensor in (tt.params["c2_weight"], tt._cparams["c2_weight"],
                   tt.opt_state["c2_weight"][0]):
        assert tensor.is_contiguous(memory_format=cl)
        assert not tensor.is_contiguous()
        assert tuple(tensor.shape) == (4, 4, 3, 3)  # logical OIHW
    for tensor in (tt.params["c_weight"], tt.opt_state["c_weight"][0],
                   tt.params["fc_weight"]):
        assert tensor.is_contiguous()
    rs = np.random.RandomState(0)
    outs = tt.step(data=rs.rand(2, 3, 8, 8).astype(np.float32),
                   softmax_label=rs.randint(0, 3, 2).astype(np.float32))
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    assert tt._bufs[("data", (2, 3, 8, 8), torch.float32)] \
        .is_contiguous(memory_format=cl)
    arg, _ = tt.get_params()
    for k, v in arg.items():
        assert v.is_contiguous() and torch.equal(v, tt.params[k]), k


@pytest.mark.parametrize("env", [{"MXTPU_HWIO_STORAGE": "0"},
                                 {"MXTPU_CONV_LAYOUT": "NCHW"}])
def test_channels_last_storage_opt_outs(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tt = TTrainer(_tied_net(tsym), device="cpu").init(data=(2, 3, 8, 8))
    assert tt._cl_params == frozenset()
    assert all(v.is_contiguous() for v in tt.params.values())
    tt.step(data=np.ones((2, 3, 8, 8), np.float32),
            softmax_label=np.zeros(2, np.float32))
    data_buf = tt._bufs[("data", (2, 3, 8, 8), torch.float32)]
    assert data_buf.is_contiguous() == ("MXTPU_CONV_LAYOUT" in env)


def test_channels_last_step_matches_nchw(monkeypatch):
    batches = _batches(2, 8, seed=3)
    cl = _port_trainer("float32")
    monkeypatch.setenv("MXTPU_CONV_LAYOUT", "NCHW")
    nchw = _port_trainer("float32")
    assert cl._cl_params == {"conv1_weight", "conv2_weight"}
    assert not nchw._cl_params
    for x, y in batches:
        a = cl.step(data=x, softmax_label=y)[0]
        b = nchw.step(data=x, softmax_label=y)[0]
        # fp32: the same arithmetic through other conv kernels
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    for k in cl.params:
        torch.testing.assert_close(cl.params[k], nchw.params[k], rtol=1e-5,
                                   atol=1e-6)


# --------------------------------------------------------- initializers
_JAX_INITS = {"Xavier": jmx.init.Xavier, "MSRAPrelu": jmx.init.MSRAPrelu,
              "Normal": jmx.init.Normal}


@pytest.mark.parametrize("cls,kw", [
    ("Xavier", {}), ("Xavier", {"rnd_type": "gaussian",
                                "factor_type": "in", "magnitude": 2}),
    ("Xavier", {"factor_type": "out"}), ("MSRAPrelu", {}),
    ("Normal", {"sigma": 0.05})])
def test_random_initializers_match_jax_statistics(cls, kw):
    # the two packages draw other numbers: compare the spread and the
    # bounds (200k draws: the sample std is within 1 % of the true one)
    shape = (64, 32, 10, 10)
    jarr = jmx.nd.zeros(shape)
    np.random.seed(0)
    _JAX_INITS[cls](**kw)("x_weight", jarr)
    tarr = torch.zeros(shape)
    getattr(tinit, cls)(generator=torch.Generator().manual_seed(0),
                        **kw)("x_weight", tarr)
    j, t = jarr.asnumpy(), tarr.numpy()
    assert abs(t.std() / j.std() - 1) < 2e-2
    assert abs(t.mean()) < 3e-3 * j.std() * 100 ** 0.5
    if kw.get("rnd_type", "uniform") == "uniform" and cls == "Xavier":
        assert abs(t.max() - j.max()) < 1e-3 * j.max()
        assert abs(t.min() - j.min()) < 1e-3 * j.max()


@pytest.mark.parametrize("cls,kw,name", [
    ("Constant", {"value": 0.25}, "x_gamma"), ("One", {}, "x_weight"),
    ("Zero", {}, "x_weight"), ("Xavier", {}, "x_bias"),
    ("Xavier", {}, "x_gamma"), ("Normal", {}, "x_moving_var")])
def test_deterministic_initializers_match_jax(cls, kw, name):
    jarr = jmx.nd.array(np.full((3, 4), 9.0, np.float32))
    getattr(jmx.init, cls)(**kw)(name, jarr)
    tarr = torch.full((3, 4), 9.0)
    getattr(tinit, cls)(**kw)(name, tarr)
    np.testing.assert_array_equal(tarr.numpy(), jarr.asnumpy())


def test_xavier_refuses_unknown_types():
    with pytest.raises(MXNetError, match="factor_type"):
        tinit.Xavier(factor_type="sideways")("x_weight", torch.zeros(2, 2))
    with pytest.raises(MXNetError, match="rnd_type"):
        tinit.Xavier(rnd_type="cauchy")("x_weight", torch.zeros(2, 2))

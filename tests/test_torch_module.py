"""The port's Module against the JAX package's, on the CPU: training
steps on an MLP and on resnet-8 from the same parameters, through the
module's own updater and through a local store instance (the bucketed
update); ``fit`` per epoch, ``score`` and ``predict``; checkpoints with
optimizer states across the two packages; the host syncs of ``fit``
(they must not grow with the batch count); and the refusals of what is
not ported.

Parameters go across as numpy arrays; batches come from numpy seeds.
The JAX side runs its convolutions in true fp32
(``MXTPU_CONV_PRECISION=float32``).  resnet-8 runs at 3 x 16 x 16 and
batch 32, where one step is well-conditioned (resnet-20 at 32 x 32 is
too ill-conditioned for an fp32 tolerance; see
tests/test_torch_train_resnet.py).  Tolerances are stated where they
are used.
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import models as jmodels
from mxnet_tpu import nd as jnd
from mxnet_tpu import symbol as jsym
from mxnet_tpu.test_utils import get_synthetic_mnist

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import callback as tcb
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch import symbol as tsym

CPU = "cpu"
SGD = {"learning_rate": 0.1, "momentum": 0.9}


def _mlp(s, num_hidden=16, classes=10):
    net = s.Flatten(s.Variable("data"))
    net = s.FullyConnected(net, name="fc1", num_hidden=num_hidden)
    net = s.Activation(net, act_type="relu")
    net = s.FullyConnected(net, name="fc2", num_hidden=classes)
    return s.SoftmaxOutput(net, name="softmax")


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _pair(jnet, shape, batch, init, kvstore, opt=SGD):
    """A bound JAX and port Module from the same parameters (the JAX
    initializer's, copied across as numpy)."""
    jmx.random.seed(0)
    np.random.seed(0)
    jmod = jmx.mod.Module(jnet, context=jmx.cpu())
    tmod = tmx.mod.Module(tsym.load_json(jnet.tojson()), context=tmx.cpu())
    for mod in (jmod, tmod):
        mod.bind(data_shapes=[("data", (batch,) + shape)],
                 label_shapes=[("softmax_label", (batch,))])
    jmod.init_params(initializer=init)
    arg, aux = jmod.get_params()
    arg = {k: v.asnumpy() for k, v in arg.items()}
    aux = {k: v.asnumpy() for k, v in aux.items()}
    tmod.init_params(arg_params=arg, aux_params=aux)
    for mod, mx in ((jmod, jmx), (tmod, tmx)):
        kv = mx.kv.create("local") if kvstore == "instance" else kvstore
        mod.init_optimizer(kvstore=kv, optimizer="sgd",
                           optimizer_params=dict(opt))
    return jmod, tmod, arg


def _batch(mx, x, y):
    arr = jnd.array if mx is jmx else (lambda a: tnd.array(a, ctx=CPU))
    return mx.io.DataBatch(data=[arr(x)], label=[arr(y)])


def _steps(jmod, tmod, shape, batch, classes, n=3, seed=1):
    rs = np.random.RandomState(seed)
    outs = []
    for _ in range(n):
        x = rs.normal(0, 1, (batch,) + shape).astype(np.float32)
        y = rs.randint(0, classes, batch).astype(np.float32)
        for mod, mx in ((jmod, jmx), (tmod, tmx)):
            mod.forward(_batch(mx, x, y), is_train=True)
            mod.backward()
            mod.update()
        outs.append((_np(tmod.get_outputs()[0]),
                     _np(jmod.get_outputs()[0])))
    return outs


@pytest.mark.parametrize("kvstore", ["local", "instance"])
def test_mlp_steps_match_jax(kvstore):
    jmod, tmod, _ = _pair(_mlp(jsym), (1, 6, 6), 16, jmx.init.Xavier(),
                          kvstore)
    # the two routes the reference takes: the module's own updater for
    # a store named by a string on one device, the store's bucketed
    # update for an instance
    assert (tmod._kvstore is None) == (kvstore == "local")
    assert (jmod._kvstore is None) == (kvstore == "local")
    for to, jo in _steps(jmod, tmod, (1, 6, 6), 16, 10):
        # fp32, two small layers: probabilities to fp32 rounding
        np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-6)
    targ, _ = tmod.get_params()
    jarg, _ = jmod.get_params()
    for k, v in jarg.items():
        np.testing.assert_allclose(targ[k].asnumpy(), v.asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    if kvstore == "instance":
        assert tmod._kvstore._fused.num_buckets == \
            jmod._kvstore._fused.num_buckets


@pytest.mark.parametrize("kvstore", ["local", "instance"])
def test_resnet8_steps_match_jax(monkeypatch, kvstore):
    monkeypatch.setenv("MXTPU_CONV_PRECISION", "float32")
    shape, b = (3, 16, 16), 32
    net = jmodels.get_symbol("resnet-8", num_classes=10, image_shape=shape)
    he = jmx.init.Xavier(rnd_type="gaussian", factor_type="in", magnitude=2)
    # SGD lr 0.1 as in test_torch_train_resnet.py.  At lr 0.05 these
    # batches make a beta's update at step 2 a sum that cancels to 1e-3
    # of its terms, which fp32 rounding in either package then moves by
    # 2e-3 of itself (measured with both re-synced before each step:
    # the other parameters agree to 5e-6 in the median)
    jmod, tmod, start = _pair(net, shape, b, he, kvstore)
    for to, jo in _steps(jmod, tmod, shape, b, 10):
        # the same weights, fp32 both sides: the probabilities agree to
        # fp32 reassociation over 8 layers (1e-5 relative)
        assert _rel(to, jo) <= 1e-5
    targ, taux = tmod.get_params()
    jarg, jaux = jmod.get_params()
    for k, w in targ.items():
        # each parameter's 3-step change agrees to 1e-4 of the change
        # (as the FusedTrainer's does in test_torch_train_resnet.py)
        moved = jarg[k].asnumpy() - start[k]
        if np.linalg.norm(moved) == 0:  # a gamma under fix_gamma
            np.testing.assert_array_equal(w.asnumpy(), jarg[k].asnumpy())
            continue
        assert _rel(w.asnumpy() - start[k], moved) <= 1e-4, k
    for k, v in taux.items():
        assert _rel(v.asnumpy(), jaux[k].asnumpy()) <= 1e-4, k


def _blobs(n, seed):
    (x, y), _ = get_synthetic_mnist(n, 16)
    return x[:n], y[:n]


def _fit_net(s):
    net = s.Convolution(s.Variable("data"), name="conv", kernel=(3, 3),
                        num_filter=4)
    net = s.Pooling(s.Activation(net, act_type="relu"), kernel=(2, 2),
                    stride=(2, 2), pool_type="max")
    net = s.FullyConnected(s.Flatten(net), name="fc", num_hidden=10)
    return s.SoftmaxOutput(net, name="softmax")


def test_fit_tracks_jax_per_epoch(monkeypatch):
    monkeypatch.setenv("MXTPU_CONV_PRECISION", "float32")
    (xtr, ytr), (xte, yte) = get_synthetic_mnist(128, 64)
    jnet = _fit_net(jsym)
    jmx.random.seed(0)
    probe = jmx.mod.Module(jnet, context=jmx.cpu())
    probe.bind(data_shapes=[("data", (32, 1, 28, 28))],
               label_shapes=[("softmax_label", (32,))])
    probe.init_params(initializer=jmx.init.Xavier())
    arg, aux = probe.get_params()
    arg = {k: v.asnumpy() for k, v in arg.items()}
    curves = {}
    for pkg, mx, net in (("jax", jmx, jnet),
                         ("port", tmx, tsym.load_json(jnet.tojson()))):
        mod = mx.mod.Module(net, context=mx.cpu())
        train = mx.io.NDArrayIter(xtr, ytr, batch_size=32)
        val = mx.io.NDArrayIter(xte, yte, batch_size=32)
        metric = mx.metric.create(["acc", "ce"])
        got = []
        params = (arg if pkg == "port"
                  else {k: jnd.array(v) for k, v in arg.items()})
        mod.fit(train, eval_data=val, eval_metric=metric,
                validation_metric="acc", num_epoch=3, arg_params=params,
                optimizer="sgd", optimizer_params=dict(SGD),
                epoch_end_callback=lambda *a, m=metric, g=got:
                g.append(m.get_global()[1]))
        curves[pkg] = (got, mod.score(val, "acc"))
    # fp32, the same weights and batches: per-epoch accuracy equal and
    # cross-entropy to 1e-4 relative; validation accuracy equal
    for (ja, jce), (ta, tce) in zip(curves["jax"][0], curves["port"][0]):
        assert ta == ja
        assert tce == pytest.approx(jce, rel=1e-4)
    assert curves["port"][1] == curves["jax"][1]
    assert curves["port"][0][-1][0] > curves["port"][0][0][0]


def test_score_and_predict_match_jax():
    x, y = _blobs(40, 0)
    jmod, tmod, _ = _pair(_mlp(jsym), (1, 28, 28), 16, jmx.init.Xavier(),
                          "local")
    res, preds = {}, {}
    for pkg, mx, mod in (("jax", jmx, jmod), ("port", tmx, tmod)):
        it = mx.io.NDArrayIter(x, y, batch_size=16)  # 3 batches, 8 pad
        res[pkg] = mod.score(it, ["acc", "ce"])
        preds[pkg] = mod.predict(it)
        batches = list(mod.iter_predict(it))
        assert [o[0].shape[0] for o, _, _ in batches] == [16, 16, 8]
    assert res["port"][0] == res["jax"][0]
    assert res["port"][1][1] == pytest.approx(res["jax"][1][1], rel=1e-5)
    assert preds["port"].shape == (40, 10)
    np.testing.assert_allclose(preds["port"].asnumpy(),
                               preds["jax"].asnumpy(), rtol=1e-5, atol=1e-6)
    listed = tmod.predict(tio.NDArrayIter(x, y, batch_size=16),
                          merge_batches=False)
    assert len(listed) == 3 and listed[2][0].shape == (8, 10)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX Module's ``save_checkpoint(prefix, 1,
    save_optimizer_states=True)``, then the port's ``Module.load(prefix,
    1, load_optimizer_states=True)``: the port's next step equals the
    JAX module's next step."""
    jmod, _, _ = _pair(_mlp(jsym), (1, 6, 6), 16, jmx.init.Xavier(), "local")
    rs = np.random.RandomState(3)
    batches = [(rs.normal(size=(16, 1, 6, 6)).astype(np.float32),
                rs.randint(0, 10, 16).astype(np.float32)) for _ in range(3)]
    for x, y in batches[:2]:
        jmod.forward_backward(_batch(jmx, x, y))
        jmod.update()
    prefix = str(tmp_path / "mlp")
    jmod.save_checkpoint(prefix, 1, save_optimizer_states=True)
    tmod = tmx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                               context=tmx.cpu())
    tmod.bind(data_shapes=[("data", (16, 1, 6, 6))],
              label_shapes=[("softmax_label", (16,))])
    tmod.init_optimizer(kvstore="local", optimizer="sgd",
                        optimizer_params=dict(SGD))
    x, y = batches[2]
    for mod, mx in ((jmod, jmx), (tmod, tmx)):
        mod.forward_backward(_batch(mx, x, y))
        mod.update()
    targ, _ = tmod.get_params()
    jarg, _ = jmod.get_params()
    for k, v in jarg.items():
        # the momentum came across: one more step from equal states,
        # fp32 rounding of the small layers (1e-5 relative)
        np.testing.assert_allclose(targ[k].asnumpy(), v.asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # without the states the step differs (the momentum matters here)
    fresh = tmx.mod.Module.load(prefix, 1, context=tmx.cpu())
    fresh.bind(data_shapes=[("data", (16, 1, 6, 6))],
               label_shapes=[("softmax_label", (16,))])
    fresh.init_optimizer(kvstore="local", optimizer="sgd",
                         optimizer_params=dict(SGD))
    fresh.forward_backward(_batch(tmx, x, y))
    fresh.update()
    assert not np.allclose(fresh.get_params()[0]["fc1_weight"].asnumpy(),
                           jarg["fc1_weight"].asnumpy(), rtol=1e-5)


def test_port_checkpoint_loads_in_jax(tmp_path):
    jmod, tmod, _ = _pair(_mlp(jsym), (1, 6, 6), 16, jmx.init.Xavier(),
                          "instance")
    x = np.random.RandomState(5).normal(size=(16, 1, 6, 6)).astype(
        np.float32)
    y = np.arange(16, dtype=np.float32) % 10
    tmod.forward_backward(_batch(tmx, x, y))
    tmod.update()
    prefix = str(tmp_path / "port")
    tmod.save_checkpoint(prefix, 3, save_optimizer_states=True)
    back = jmx.mod.Module.load(prefix, 3, load_optimizer_states=True,
                               context=jmx.cpu())
    back.bind(data_shapes=[("data", (16, 1, 6, 6))],
              label_shapes=[("softmax_label", (16,))])
    back.init_optimizer(kvstore=jmx.kv.create("local"), optimizer="sgd",
                        optimizer_params=dict(SGD))
    for mod, mx in ((back, jmx), (tmod, tmx)):
        mod.forward_backward(_batch(mx, x, y))
        mod.update()
    for k, v in back.get_params()[0].items():
        np.testing.assert_allclose(tmod.get_params()[0][k].asnumpy(),
                                   v.asnumpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_module_checkpoint_callback_and_reload(tmp_path):
    x, y = _blobs(64, 1)
    mod = tmx.mod.Module(tsym.load_json(_mlp(jsym).tojson()),
                         context=tmx.cpu())
    prefix = str(tmp_path / "m")
    it = tio.NDArrayIter(x, y, batch_size=16)
    mod.fit(it, num_epoch=2, optimizer="sgd", optimizer_params=dict(SGD),
            initializer=tmx.init.Xavier(),
            epoch_end_callback=tcb.module_checkpoint(
                mod, prefix, period=2, save_optimizer_states=True))
    for suffix in ("-symbol.json", "-0002.params", "-0002.states"):
        assert (tmp_path / ("m" + suffix)).exists(), suffix
    assert not (tmp_path / "m-0001.params").exists()
    ref = mod.score(it, "acc")
    loaded = tmx.mod.Module.load(prefix, 2, context=tmx.cpu())
    loaded.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
                for_training=False)
    assert loaded.score(it, "acc") == ref
    mod.bind(data_shapes=[("data", (32, 1, 28, 28))],
             label_shapes=[("softmax_label", (32,))], for_training=False,
             force_rebind=True)
    assert mod.score(tio.NDArrayIter(x, y, batch_size=32), "acc") == ref


_SYNCS = ("item", "cpu", "tolist", "numpy", "__bool__", "__float__",
          "__int__")


def _count_fit_syncs(monkeypatch, nbatch):
    counts = []

    def count(name, orig):
        def f(*a, **k):
            counts.append(name)
            return orig(*a, **k)
        return f

    (xtr, ytr), _ = get_synthetic_mnist(16 * nbatch, 16)
    mod = tmx.mod.Module(_fit_net(tsym), context=tmx.cpu())
    train = tio.NDArrayIter(xtr, ytr, batch_size=16)
    with monkeypatch.context() as mp:
        for name in _SYNCS:
            mp.setattr(torch.Tensor, name,
                       count(name, getattr(torch.Tensor, name)))
        mod.fit(train, eval_metric=["acc", "ce"], num_epoch=1,
                optimizer="sgd", optimizer_params=dict(SGD),
                batch_end_callback=tcb.Speedometer(16, frequent=100))
    return len(counts)


def test_fit_host_syncs_do_not_grow_with_batches(monkeypatch):
    small = _count_fit_syncs(monkeypatch, 4)
    large = _count_fit_syncs(monkeypatch, 16)
    # fused metrics: the syncs are the epoch boundary's metric reads only
    assert large == small <= 4, (small, large)


def test_inputs_need_grad_and_fixed_params():
    jnet = _mlp(jsym)
    x = np.random.RandomState(6).normal(size=(4, 1, 6, 6)).astype(
        np.float32)
    y = np.array([1, 2, 3, 4], np.float32)
    grads = {}
    for mx, net in ((jmx, jnet), (tmx, tsym.load_json(jnet.tojson()))):
        mod = mx.mod.Module(net, context=mx.cpu(),
                            fixed_param_names=["fc1_bias"])
        mod.bind(data_shapes=[("data", (4, 1, 6, 6))],
                 label_shapes=[("softmax_label", (4,))],
                 inputs_need_grad=True)
        mod.init_params(initializer=mx.init.One())
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 1.0})
        mod.forward_backward(_batch(mx, x, y))
        grads[mx] = mod.get_input_grads()[0].asnumpy()
        mod.update()
        assert mod.get_params()[0]["fc1_bias"].asnumpy().sum() == 0.0
        assert mod.output_shapes == [("softmax_output", (4, 10))]
    np.testing.assert_allclose(grads[tmx], grads[jmx], rtol=1e-5, atol=1e-6)


def test_borrow_optimizer_and_shared_module():
    net = tsym.load_json(_mlp(jsym).tojson())
    mod = tmx.mod.Module(net, context=tmx.cpu())
    mod.bind(data_shapes=[("data", (4, 1, 6, 6))],
             label_shapes=[("softmax_label", (4,))])
    mod.init_params(initializer=tmx.init.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(SGD))
    pred = tmx.mod.Module(net, context=tmx.cpu())
    pred.bind(data_shapes=[("data", (2, 1, 6, 6))],
              label_shapes=[("softmax_label", (2,))], for_training=False,
              shared_module=mod)
    pred.borrow_optimizer(mod)
    assert pred._updater is mod._updater
    x = np.ones((4, 1, 6, 6), np.float32)
    mod.forward_backward(_batch(tmx, x, np.zeros(4, np.float32)))
    mod.update()
    pred.forward(_batch(tmx, x[:2], np.zeros(2, np.float32)),
                 is_train=False)
    mod.forward(_batch(tmx, x, np.zeros(4, np.float32)), is_train=False)
    # the sharee reads the donor's updated storage
    np.testing.assert_allclose(pred.get_outputs()[0].asnumpy(),
                               mod.get_outputs()[0].asnumpy()[:2],
                               rtol=1e-6)


@pytest.mark.parametrize("what", ["contexts", "dist", "monitor",
                                  "checkpoint", "resume", "ckpt_dir",
                                  "fit_monitor"])
def test_refusals(monkeypatch, tmp_path, what):
    net = tsym.load_json(_mlp(jsym).tojson())
    x, y = _blobs(16, 2)
    it = tio.NDArrayIter(x, y, batch_size=8)
    if what == "contexts":
        with pytest.raises(MXNetError, match="item 10"):
            mod = tmx.mod.Module(net, context=[tmx.cpu(0), "meta"])
            mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label)
        return
    mod = tmx.mod.Module(net, context=tmx.cpu())
    if what == "dist":
        # the parameter-server stores and the collective dist_sync are
        # ported; several workers with neither servers nor a rendezvous
        # address were not started by a launcher, which the error names
        monkeypatch.delenv("MXTPU_PS_SERVERS", raising=False)
        monkeypatch.delenv("MXTPU_COORDINATOR", raising=False)
        monkeypatch.setenv("MXTPU_NUM_WORKERS", "2")
        with pytest.raises(MXNetError, match="mxnet_tpu_torch.launch -n 2 "
                                             "-s 0"):
            mod.fit(it, num_epoch=1, kvstore="dist_sync")
        return
    if what in ("monitor", "fit_monitor"):
        # monitor.py is ported: what was refused here now taps the
        # executor (tests/test_torch_module_more.py holds the rows)
        mon = tmx.Monitor(1, pattern=".*weight")
        if what == "monitor":
            mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label)
            mod.install_monitor(mon)
        else:
            mod.fit(it, num_epoch=1, monitor=mon)
        assert mon.exes == [mod._exec_group.execs[0]]
        return
    # checkpoints in fit are ported (ROADMAP Queue 1 item 7): a directory
    # or MXTPU_CKPT_DIR arms them, and resume=True without either raises
    # as the reference's does
    from mxnet_tpu_torch import checkpoint as tckpt

    where = str(tmp_path / "ck")
    if what == "resume":
        with pytest.raises(MXNetError, match="needs MXTPU_CKPT_DIR"):
            mod.fit(it, num_epoch=1, resume=True)
        return
    if what == "ckpt_dir":
        monkeypatch.setenv("MXTPU_CKPT_DIR", where)
    mod.fit(it, num_epoch=1,
            **({"checkpoint": where} if what == "checkpoint" else {}))
    (step, path), = tckpt.list_checkpoints(where)
    assert step == 2
    _, manifest = tckpt.load(path)
    assert manifest["meta"]["module"] == "Module"
    assert manifest["meta"]["signature"] == net.structural_signature()


def test_module_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default context is valid")
    with pytest.raises(MXNetError, match="no CUDA device"):
        tmx.mod.Module(tsym.load_json(_mlp(jsym).tojson()))


def test_top_level_names():
    assert tmx.sym is tsym and tmx.symbol is tsym
    assert isinstance(tmx.sym.Variable("d"), tmx.Symbol)
    assert tmx.mod.Module is tmx.Module and tmx.module.Module is tmx.Module
    assert tmx.kv is tmx.kvstore and tmx.Optimizer is \
        tmx.optimizer.Optimizer
    assert tmx.Executor is tmx.executor.Executor
    assert tmx.NDArray is tnd.NDArray and tmx.Group is tsym.Group


def test_fit_logs_as_jax(caplog):
    x, y = _blobs(32, 3)
    mod = tmx.mod.Module(tsym.load_json(_mlp(jsym).tojson()),
                         context=tmx.cpu(), logger=logging.getLogger())
    with caplog.at_level(logging.INFO):
        mod.fit(tio.NDArrayIter(x, y, batch_size=16),
                eval_data=tio.NDArrayIter(x, y, batch_size=16),
                num_epoch=1, optimizer_params=dict(SGD))
    assert "Epoch[0] Train-accuracy=" in caplog.text
    assert "Epoch[0] Validation-accuracy=" in caplog.text

"""The port's training loop against the JAX package, on the CPU: the
``io`` iterators, the ``metric`` module (fused and eager), the
``lr_scheduler`` module, the ``engine.AsyncWindow``, the ``callback``
module and ``FusedTrainer.fit`` — its metric per epoch from the same
weights, its host syncs (they must not grow with the batch count) and
its refusals of what is not ported.

Inputs come from numpy seeds and go to both packages.  Tolerances are
stated where they are used.
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import symbol as jsym
from mxnet_tpu.test_utils import get_synthetic_mnist
from mxnet_tpu.trainer import FusedTrainer as JTrainer

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import callback as tcb
from mxnet_tpu_torch import convert, engine
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import lr_scheduler as tlrs
from mxnet_tpu_torch import metric as tmetric
from mxnet_tpu_torch import model as tmodel
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.module import BatchEndParam
from mxnet_tpu_torch.trainer import FusedTrainer as TTrainer

CPU = "cpu"


# ------------------------------------------------------------------ io
def _arrays(n=10, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.normal(size=(n, 2, 3)).astype(np.float32),
            rs.randint(0, 5, n).astype(np.float32))


def _epochs(it, n=3):
    out = []
    for _ in range(n):
        it.reset()
        out.append([([d.asnumpy() for d in b.data],
                     [lab.asnumpy() for lab in b.label], b.pad) for b in it])
    return out


def _same_epochs(a, b):
    assert len(a) == len(b)
    for ea, eb in zip(a, b):
        assert len(ea) == len(eb)
        for (da, la, pa), (db, lb, pb) in zip(ea, eb):
            assert pa == pb
            for x, y in zip(da + la, db + lb):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("batch", [3, 5])
def test_ndarray_iter_matches_jax(handle, shuffle, batch):
    x, y = _arrays()
    np.random.seed(4)
    jit = jmx.io.NDArrayIter(x, y, batch_size=batch, shuffle=shuffle,
                             last_batch_handle=handle)
    np.random.seed(4)
    tit = tio.NDArrayIter(x, y, batch_size=batch, shuffle=shuffle,
                          last_batch_handle=handle)
    assert tit.provide_data == [tuple(d) for d in jit.provide_data]
    assert tit.provide_label == [tuple(d) for d in jit.provide_label]
    _same_epochs(_epochs(tit), _epochs(jit))
    # batches stay on the host
    tit.reset()
    assert next(tit).data[0].context == torch.device("cpu")


def test_ndarray_iter_dicts_and_lists_match_jax():
    x, y = _arrays()
    x2 = x[:, 0]
    for data in ({"a": x, "b": x2}, [x, x2]):
        jit = jmx.io.NDArrayIter(data, y, batch_size=4)
        tit = tio.NDArrayIter(data, y, batch_size=4)
        assert [d.name for d in tit.provide_data] \
            == [d[0] for d in jit.provide_data]
        _same_epochs(_epochs(tit, 1), _epochs(jit, 1))
    with pytest.raises(ValueError):
        tio.NDArrayIter(x, y, batch_size=11)


def test_resize_iter_matches_jax():
    x, y = _arrays()
    jit = jmx.io.ResizeIter(jmx.io.NDArrayIter(x, y, batch_size=4), 5)
    tit = tio.ResizeIter(tio.NDArrayIter(x, y, batch_size=4), 5)
    _same_epochs(_epochs(tit, 2), _epochs(jit, 2))


@pytest.mark.parametrize("drop", [False, True])
def test_step_multi_feeds_groups_batches(drop):
    x, y = _arrays(n=20)
    it = tio.NDArrayIter(x, y, batch_size=4)
    feeds = list(tio.step_multi_feeds(it, 2, drop_remainder=drop))
    assert [len(f["data"]) for f in feeds] == ([2, 2] if drop else [2, 2, 1])
    np.testing.assert_array_equal(feeds[1]["softmax_label"][1].asnumpy(),
                                  y[12:16])


# -------------------------------------------------------------- metrics
def _metric_inputs(seed=0, n=12, c=5):
    rs = np.random.RandomState(seed)
    pred = rs.dirichlet(np.ones(c), n).astype(np.float32)
    label = rs.randint(0, c, n).astype(np.float32)
    return label, pred


METRICS = [
    ("acc", {}, "cls"), ("accuracy", {"ignore_label": 2}, "cls"),
    ("top_k_accuracy_3", {}, "cls"), ("ce", {}, "cls"),
    ("perplexity", {}, "cls"), ("perplexity", {"ignore_label": 1}, "cls"),
    ("f1", {}, "binary"), ("mae", {}, "reg"), ("mse", {}, "reg"),
    ("rmse", {}, "reg"), ("loss", {}, "reg"), ("torch", {}, "reg"),
]


def _make(pkg, name, kw):
    return pkg.metric.create(name, **kw)


def _inputs(kind, seed):
    label, pred = _metric_inputs(seed)
    if kind == "binary":
        label = (label > 2).astype(np.float32)
        pred = np.stack([1 - pred[:, 0], pred[:, 0]], axis=1)
    elif kind == "reg":
        pred = pred[:, :1] * 4
        label = label[:, None]
    return label, pred


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("name,kw,kind", METRICS)
def test_metric_matches_jax(monkeypatch, fused, name, kw, kind):
    import mxnet_tpu_torch as tmx

    monkeypatch.setenv("MXTPU_FUSED_METRICS", fused)
    jm, tm = _make(jmx, name, kw), _make(tmx, name, kw)
    for seed in range(3):
        label, pred = _inputs(kind, seed)
        jm.update([jmx.nd.array(label)], [jmx.nd.array(pred)])
        tm.update([tnd.array(label, ctx=CPU)], [tnd.array(pred, ctx=CPU)])
        if seed == 1:
            # the local window folds into the global totals
            jm.reset_local()
            tm.reset_local()
    # fp32 sums of the same values in another order: 1e-6 relative
    (jn, jv), (tn, tv) = jm.get(), tm.get()
    assert tn == jn
    np.testing.assert_allclose(tv, jv, rtol=1e-6)
    np.testing.assert_allclose(tm.get_global()[1], jm.get_global()[1],
                               rtol=1e-6)
    assert type(tm.num_inst) is type(jm.num_inst)


def test_fused_metric_makes_no_host_sync_until_read(monkeypatch):
    calls = []

    def count(name):
        def f(*a, **k):
            calls.append(name)
            raise AssertionError(f"host sync through Tensor.{name}")
        return f

    m = tmetric.create(["acc", "ce", "top_k_accuracy_2"])
    label, pred = _metric_inputs()
    lab, p = torch.from_numpy(label), torch.from_numpy(pred)
    stamp = m.update_stamp()
    for name in ("item", "cpu", "tolist", "numpy", "__bool__", "__float__",
                 "__int__"):
        monkeypatch.setattr(torch.Tensor, name, count(name))
    for _ in range(3):
        m.update([lab], [tnd.NDArray(p)])
    monkeypatch.undo()
    assert calls == []
    assert m.update_stamp() != stamp
    names, values = m.get()
    assert names == ["accuracy", "cross-entropy", "top_k_accuracy_2"]
    assert values[0] == pytest.approx(
        float((pred.argmax(1) == label).mean()))


def test_metric_create_forms():
    def feval(label, pred):
        return float(np.abs(label - pred.argmax(1)).sum()), len(label)

    label, pred = _metric_inputs()
    jm = jmx.metric.create(feval)
    tm = tmetric.create(feval)
    jm.update([jmx.nd.array(label)], [jmx.nd.array(pred)])
    tm.update([tnd.array(label, ctx=CPU)], [tnd.array(pred, ctx=CPU)])
    assert tm.get() == jm.get()
    deco = tmetric.np(name="l1")(feval)
    assert deco.name == "l1"
    acc = tmetric.Accuracy()
    assert tmetric.create(acc) is acc
    with pytest.raises(MXNetError, match="unknown metric"):
        tmetric.create("no-such-metric")


# ----------------------------------------------------------- schedulers
@pytest.mark.parametrize("make", [
    lambda m: m.FactorScheduler(step=3, factor=0.5),
    lambda m: m.FactorScheduler(step=2, factor=0.1, stop_factor_lr=1e-4),
    lambda m: m.MultiFactorScheduler(step=[4, 9, 15], factor=0.3),
    lambda m: m.WarmupCosineScheduler(total_steps=20, warmup_steps=5,
                                      final_lr=1e-3),
    lambda m: m.WarmupCosineScheduler(total_steps=10),
])
def test_schedulers_match_jax(make):
    js, ts = make(jmx.lr_scheduler), make(tlrs)
    js.base_lr = ts.base_lr = 0.2
    assert [ts(n) for n in range(1, 30)] == [js(n) for n in range(1, 30)]


@pytest.mark.parametrize("make", [
    lambda m: m.FactorScheduler(step=0),
    lambda m: m.FactorScheduler(step=2, factor=2.0),
    lambda m: m.MultiFactorScheduler(step=[3, 2]),
    lambda m: m.WarmupCosineScheduler(total_steps=0),
    lambda m: m.WarmupCosineScheduler(total_steps=4, warmup_steps=4),
])
def test_schedulers_refuse_as_jax(make):
    with pytest.raises(ValueError):
        make(jmx.lr_scheduler)
    with pytest.raises(ValueError):
        make(tlrs)


# --------------------------------------------------------------- engine
class _FakeEvent:
    log = []
    made = 0

    def __init__(self):
        self.n = _FakeEvent.made
        _FakeEvent.made += 1
        _FakeEvent.log.append(("new", self.n))

    def record(self, stream):
        pass

    def synchronize(self):
        _FakeEvent.log.append(("wait", self.n))


def test_async_window_bounds_what_is_in_flight(monkeypatch):
    # a pushed step on a card records an event; past the depth the host
    # waits on the oldest one, and drain waits on the rest in order
    monkeypatch.setattr(engine, "_cuda_device", lambda h: "cuda:0")
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: None)
    _FakeEvent.log, _FakeEvent.made = [], 0
    w = engine.AsyncWindow(depth=2)
    for _ in range(5):
        w.push([torch.zeros(1)])
        assert len(w) <= 2
    assert [e for e in _FakeEvent.log if e[0] == "wait"] == [
        ("wait", 0), ("wait", 1), ("wait", 2)]
    w.drain()
    assert len(w) == 0 and w.waits == 5
    assert [n for k, n in _FakeEvent.log if k == "wait"] == [0, 1, 2, 3, 4]


def test_async_window_on_host_tensors_never_waits():
    w = engine.AsyncWindow(depth=1)
    for _ in range(3):
        w.push([tnd.zeros((2,), ctx=CPU)])
    w.drain()
    assert w.waits == 0


def test_async_depth_knobs(monkeypatch):
    monkeypatch.setenv("MXTPU_ASYNC_DEPTH", "5")
    assert engine.async_depth() == 5 == engine.AsyncWindow().depth
    monkeypatch.setenv("MXTPU_ASYNC_DEPTH", "0")
    assert engine.async_depth() == 1
    monkeypatch.setenv("MXTPU_ASYNC_DEPTH", "x")
    assert engine.async_depth() == 2
    monkeypatch.setenv("MXTPU_ASYNC_DEPTH", "5")
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    assert engine.async_depth() == 1


# ------------------------------------------------------------ callbacks
def test_speedometer_reads_the_metric_only_when_it_moved(monkeypatch,
                                                         caplog):
    reads = []
    m = tmetric.Accuracy()
    orig = m.get_name_value
    monkeypatch.setattr(m, "get_name_value",
                        lambda: reads.append(1) or orig())
    sp = tcb.Speedometer(batch_size=4, frequent=2, auto_reset=False)
    label, pred = _metric_inputs()
    caplog.set_level(logging.INFO)
    for nbatch in range(7):
        if nbatch < 3:
            m.update([torch.from_numpy(label)], [torch.from_numpy(pred)])
        sp(BatchEndParam(epoch=0, nbatch=nbatch, eval_metric=m,
                         locals=None))
    # reports at batches 2, 4 and 6; the metric moved only before 2
    assert len(reads) == 1
    assert sum("Speed" in r.message for r in caplog.records) == 3


def test_do_checkpoint_and_log_train_metric(tmp_path, caplog):
    x = tsym.Variable("data")
    net = tsym.FullyConnected(x, num_hidden=2, name="fc")
    arg = {"fc_weight": torch.ones(2, 3), "fc_bias": torch.zeros(2)}
    cb = tcb.do_checkpoint(str(tmp_path / "m"), period=2)
    cb(0, net, arg, {})
    cb(1, net, arg, {})
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "m-0002.params", "m-symbol.json"]
    _, args, _ = tmodel.load_checkpoint(str(tmp_path / "m"), 2, ctx=CPU)
    np.testing.assert_array_equal(args["fc_weight"].asnumpy(), np.ones((2, 3)))
    caplog.set_level(logging.INFO)
    m = tmetric.Accuracy()
    m.update([torch.zeros(2)], [torch.tensor([[1.0, 0.0], [0.0, 1.0]])])
    log = tcb.log_train_metric(1, auto_reset=True)
    log(BatchEndParam(epoch=0, nbatch=3, eval_metric=m, locals=None))
    assert "Train-accuracy=0.5" in caplog.text
    assert m.num_inst == 0 and m.get_global()[1] == 0.5
    tcb.ProgressBar(total=4)(BatchEndParam(0, 2, None, None))
    assert "50%" in caplog.text


# ------------------------------------------------------------------ fit
def _fit_net(s):
    data = s.Variable("data")
    net = s.Convolution(data, name="conv1", kernel=(3, 3), num_filter=8)
    net = s.BatchNorm(net, name="bn1", fix_gamma=False)
    net = s.Activation(net, act_type="relu")
    net = s.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = s.FullyConnected(s.Flatten(net), name="fc", num_hidden=10)
    return s.SoftmaxOutput(net, name="softmax")


def _fit_pair(nbatch=4, batch=32):
    """JAX and port trainers with the same weights, and the data."""
    (xtr, ytr), (xte, yte) = get_synthetic_mnist(batch * nbatch, 64)
    opt = {"lr": 0.1, "momentum": 0.9, "rescale_grad": 1.0 / batch}
    jt = JTrainer(_fit_net(jsym), optimizer="sgd", optimizer_params=opt)
    jt.init(data=(batch, 1, 28, 28))
    tt = TTrainer(_fit_net(tsym), optimizer="sgd", optimizer_params=opt,
                  device=CPU).init(data=(batch, 1, 28, 28))
    arg, aux = jt.get_params()
    convert.load_trainer_params(tt, {k: v.asnumpy() for k, v in arg.items()},
                                {k: v.asnumpy() for k, v in aux.items()})
    return jt, tt, (xtr, ytr), (xte, yte)


def test_fit_tracks_jax_per_epoch(monkeypatch):
    monkeypatch.setenv("MXTPU_CONV_PRECISION", "float32")
    jt, tt, (xtr, ytr), (xte, yte) = _fit_pair()
    curves = {}
    for pkg, tr in (("jax", jt), ("port", tt)):
        io = jmx.io if pkg == "jax" else tio
        mm = jmx.metric if pkg == "jax" else tmetric
        train = io.NDArrayIter(xtr, ytr, batch_size=32)
        val = io.NDArrayIter(xte, yte, batch_size=32)
        metric = mm.create(["acc", "ce"])
        got = []
        tr.fit(train, eval_data=val, eval_metric=metric,
               validation_metric=mm.create("acc"), num_epoch=3,
               epoch_end_callback=lambda *a, m=metric, g=got:
               g.append(m.get_global()[1]))
        curves[pkg] = got
    # fp32, the same weights and batches: per-epoch accuracy equal and
    # cross-entropy to 1e-4 relative (measured 2e-6 after 3 epochs);
    # training learns the blobs
    for (ja, jce), (ta, tce) in zip(curves["jax"], curves["port"]):
        assert ta == ja
        assert tce == pytest.approx(jce, rel=1e-4)
    assert curves["port"][-1][0] > curves["port"][0][0]
    arg, _ = tt.get_params()
    jarg, _ = jt.get_params()
    for k, v in arg.items():
        np.testing.assert_allclose(v.numpy(), jarg[k].asnumpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


def test_fit_inits_from_the_first_batch():
    (xtr, ytr), _ = get_synthetic_mnist(64, 16)
    tt = TTrainer(_fit_net(tsym), device=CPU)
    tt.fit(tio.NDArrayIter(xtr, ytr, batch_size=16), num_epoch=1)
    assert tt.params["fc_weight"].shape == (10, 8 * 13 * 13)
    assert tt._step == 4


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
    tt = TTrainer(_fit_net(tsym), device=CPU).init(data=(16, 1, 28, 28))
    train = tio.NDArrayIter(xtr, ytr, batch_size=16)
    with monkeypatch.context() as mp:
        for name in _SYNCS:
            mp.setattr(torch.Tensor, name, count(name, getattr(torch.Tensor,
                                                               name)))
        tt.fit(train, eval_metric=["acc", "ce"], num_epoch=1,
               batch_end_callback=tcb.Speedometer(16, frequent=100))
    return len(counts)


def test_fit_host_syncs_do_not_grow_with_batches(monkeypatch):
    small = _count_fit_syncs(monkeypatch, 4)
    large = _count_fit_syncs(monkeypatch, 16)
    # fused: the syncs are the epoch boundary's metric reads only, one
    # .cpu() of each metric's (sum, num) pair and the .tolist() of that
    # host copy
    assert large == small <= 4, (small, large)
    monkeypatch.setenv("MXTPU_FUSED_METRICS", "0")
    small_eager = _count_fit_syncs(monkeypatch, 4)
    large_eager = _count_fit_syncs(monkeypatch, 16)
    # eager: each batch reads labels and predictions on the host
    assert large_eager - small_eager >= 12


@pytest.mark.parametrize("kw,env,match", [
    ({"checkpoint": "ckpt"}, {}, "item 7"),
    ({"resume": True}, {}, "item 7"),
    ({}, {"MXTPU_CKPT_DIR": "/nonexistent"}, "item 7"),
    ({}, {"MXTPU_COORD_ADDR": "localhost:1"}, "item 10"),
    ({}, {"MXTPU_FLIGHT_RECORD": "1"}, "item 11"),
    ({}, {"MXTPU_PERF_ATTR": "1"}, "item 11"),
])
def test_fit_refuses_what_is_not_ported(monkeypatch, tmp_path, kw, env,
                                        match):
    """The item 10 case is ported: ``MXTPU_COORD_ADDR`` joins the
    coordinator before the first step, and one nobody runs is the named
    ``HostLostError`` (site "coordinator").  The item 7 cases are ported:
    ``checkpoint=`` and ``MXTPU_CKPT_DIR`` arm checkpoints (a terminal
    one lands), and ``resume=True`` with no directory raises as the
    reference's does.  The item 11 cases are ported too: the flight
    recorder and the perf plane take their batches."""
    monkeypatch.chdir(tmp_path)
    for k, v in env.items():
        # the checkpoint directory goes under the test's own tmp_path
        monkeypatch.setenv(k, str(tmp_path / "env") if k == "MXTPU_CKPT_DIR"
                           else v)
    (x, y), _ = get_synthetic_mnist(8, 8)
    tt = TTrainer(_fit_net(tsym), device=CPU)
    it = tio.NDArrayIter(x, y, batch_size=4)
    if match == "item 7" and "resume" not in kw:
        from mxnet_tpu_torch import checkpoint as tckpt

        tt.fit(it, **kw)
        where = tmp_path / ("ckpt" if kw else "env")
        (step, path), = tckpt.list_checkpoints(str(where))
        assert step == tt._step == 2
        _, manifest = tckpt.load(path)
        assert manifest["meta"]["epoch"] == 1
        assert manifest["meta"]["nbatch"] == -1
        return
    if match == "item 11":
        from mxnet_tpu_torch.telemetry import health, perf

        health._ring.clear()
        perf.reset()
        if "MXTPU_PERF_ATTR" in env:
            perf.enable()
        try:
            tt.fit(it)
            steps = [r for r in health.flight_ring()
                     if r.get("loop") == "fused"]
            assert [r["step"] for r in steps] == [1, 2]
            if "MXTPU_PERF_ATTR" in env:
                assert perf.bucket_table()["dispatch"]["count"] == 2
        finally:
            perf.disable()
            perf.reset()
        return
    if match == "item 7":
        match = "needs a checkpoint directory"
    if match == "item 10":
        match = "host lost at site 'coordinator': host=localhost:1"
    with pytest.raises(MXNetError, match=match):
        tt.fit(it, **kw)
    assert tt._step == 0


def test_fit_without_a_validation_metric_for_an_instance():
    x, y = _arrays()
    tt = TTrainer(_fit_net(tsym), device=CPU)
    it = tio.NDArrayIter(x, y, batch_size=2)
    with pytest.raises(ValueError, match="validation_metric"):
        tt.fit(it, eval_data=it, eval_metric=tmetric.Accuracy())

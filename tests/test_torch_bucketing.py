"""The LSTM language model of the port against the JAX package's, on the
CPU: ``models.lstm`` (``lstm_unroll``, ``get_symbol``), ``rnn.
BucketSentenceIter``, ``mod.BucketingModule`` (``fit``, switching,
compile buckets, the borrowed optimizer) and ``FusedTrainer`` over
``lstm_unroll``.

Sizes follow ``tests/test_rnn_bucketing.py``: vocab 30-60, hidden 8-16,
buckets 8/16, batch 4-8.  Weights go across as numpy arrays; both
iterators shuffle from one ``random.seed``/``np.random.seed``.

Tolerances: one epoch of ``BucketingModule.fit`` (SGD with momentum
over the epoch's batches, fp32) ``2e-5`` relative to each parameter's
norm and the perplexities ``1e-5`` relative (the same arithmetic, each
library's own summation order, compounded over the steps); padded
against unpadded compile buckets ``1e-6`` within the port (the padded
steps add exact zeros); three ``FusedTrainer`` steps ``1e-5``.
"""
import random

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import base as jbase
from mxnet_tpu.models import lstm as jlstm
from mxnet_tpu.trainer import FusedTrainer as JTrainer

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import base as tbase
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch.models import lstm as tlstm
from mxnet_tpu_torch.trainer import FusedTrainer as TTrainer

CPU = "cpu"
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-5}


def _corpus(n, vocab, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randint(1, vocab, rs.randint(4, 17)).tolist()
            for _ in range(n)]


def _states(layers, batch, hidden):
    return [(f"l{i}_init_{s}", (batch, hidden)) for i in range(layers)
            for s in "ch"]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


# ------------------------------------------------------------ symbols
@pytest.mark.parametrize("layers,seq_len,dropout,ignore", [
    (1, 8, 0.0, None), (2, 16, 0.2, None), (2, 5, 0.2, 0), (3, 4, 0.0, 0)])
def test_lstm_unroll_json_matches_jax(monkeypatch, layers, seq_len, dropout,
                                      ignore):
    monkeypatch.setattr(tbase, "_NAME_MANAGER", tbase.NameManager())
    with jbase.NameManager():
        want = jlstm.lstm_unroll(layers, seq_len, 40, 12, 10, 40,
                                 dropout=dropout,
                                 ignore_label=ignore).tojson()
    got = tlstm.lstm_unroll(layers, seq_len, 40, 12, 10, 40, dropout=dropout,
                            ignore_label=ignore).tojson()
    assert got == want


def test_lstm_get_symbol_matches_jax_and_stays_out_of_the_table(monkeypatch):
    monkeypatch.setattr(tbase, "_NAME_MANAGER", tbase.NameManager())
    with jbase.NameManager():
        want = jlstm.get_symbol(seq_len=6).tojson()
    assert tlstm.get_symbol(seq_len=6).tojson() == want
    with pytest.raises(ValueError):
        tmx.models.get_symbol("lstm")


# ----------------------------------------------------------- iterator
def _iters(sentences, batch, buckets, init_states=None, seed=5):
    """The JAX and the port iterator, each built after the same seeds."""
    random.seed(seed)
    np.random.seed(seed)
    jit = jmx.rnn.BucketSentenceIter(sentences, batch, buckets=list(buckets),
                                     invalid_label=0,
                                     init_states=init_states)
    random.seed(seed)
    np.random.seed(seed)
    tit = tmx.rnn.BucketSentenceIter(sentences, batch, buckets=list(buckets),
                                     invalid_label=0,
                                     init_states=init_states, ctx=CPU)
    return jit, tit


def _batches(it):
    return [(b.bucket_key, [_np(d) for d in b.data], [_np(l) for l in b.label],
             [tuple(d) for d in b.provide_data],
             [tuple(d) for d in b.provide_label]) for b in it]


@pytest.mark.parametrize("init_states", [None, _states(2, 4, 8)])
def test_bucket_sentence_iter_batches_equal_under_one_seed(init_states):
    sentences = _corpus(120, 40)
    jit, tit = _iters(sentences, 4, [8, 16], init_states)
    assert tit.default_bucket_key == jit.default_bucket_key == 16
    assert [tuple(d) for d in tit.provide_data] == [
        tuple(d) for d in jit.provide_data]
    for epoch in range(2):
        want, got = _batches(jit), _batches(tit)
        assert len(got) == len(want) > 10
        for (jk, jd, jl, jpd, jpl), (tk, td, tl, tpd, tpl) in zip(want, got):
            assert (tk, tpd, tpl) == (jk, jpd, jpl)
            for a, b in zip(td + tl, jd + jl):
                np.testing.assert_array_equal(a, b)
        random.seed(epoch)
        np.random.seed(epoch)
        jit.reset()
        random.seed(epoch)
        np.random.seed(epoch)
        tit.reset()


def test_bucket_sentence_iter_takes_its_own_rng():
    sentences = _corpus(80, 30, seed=2)
    runs = []
    for _ in range(2):
        it = tmx.rnn.BucketSentenceIter(sentences, 4, buckets=[8, 16],
                                        invalid_label=0, ctx=CPU,
                                        rng=np.random.RandomState(9))
        runs.append(_batches(it))
    assert [b[0] for b in runs[0]] == [b[0] for b in runs[1]]
    for a, b in zip(runs[0], runs[1]):
        np.testing.assert_array_equal(a[1][0], b[1][0])
    data, label = runs[0][0][1][0], runs[0][0][2][0]
    np.testing.assert_array_equal(label[:, :-1], data[:, 1:])
    assert (label[:, -1] == 0).all()


# -------------------------------------------------------------- fit
def _sym_gen(mx, vocab, hidden, layers, init_states, dropout=0.0,
             ignore_label=0):
    module = jlstm if mx is jmx else tlstm

    def sym_gen(seq_len):
        s = module.lstm_unroll(layers, seq_len, vocab, hidden, hidden, vocab,
                               dropout=dropout, ignore_label=ignore_label)
        return s, ("data",) + tuple(n for n, _ in init_states), \
            ("softmax_label",)
    return sym_gen


def _fit_both(compile_buckets, layers=2, vocab=40, hidden=8, batch=4,
              num_epoch=1):
    sentences = _corpus(100, vocab, seed=1)
    init_states = _states(layers, batch, hidden)
    jit, tit = _iters(sentences, batch, [8, 16], init_states)
    mods, metrics = {}, {}
    for mx, it in ((jmx, jit), (tmx, tit)):
        kw = {"context": mx.cpu()}
        mods[mx] = mx.mod.BucketingModule(
            _sym_gen(mx, vocab, hidden, layers, init_states),
            default_bucket_key=it.default_bucket_key,
            compile_buckets=compile_buckets, **kw)
    jmod = mods[jmx]
    jmod.bind(jit.provide_data, jit.provide_label)
    np.random.seed(3)
    jmod.init_params(initializer=jmx.init.Xavier(factor_type="in",
                                                 magnitude=2.34))
    arg, _ = jmod.get_params()
    arg = {k: v.asnumpy() for k, v in arg.items()}
    for mx, it in ((jmx, jit), (tmx, tit)):
        metrics[mx] = mx.metric.Perplexity(ignore_label=0)
        mods[mx].fit(it, eval_metric=metrics[mx], optimizer="sgd",
                     optimizer_params=dict(SGD), arg_params=arg,
                     num_epoch=num_epoch)
    return mods, metrics, arg


@pytest.mark.parametrize("compile_buckets", [True, None])
def test_bucketing_fit_matches_jax(compile_buckets):
    mods, metrics, start = _fit_both(compile_buckets)
    jarg, _ = mods[jmx].get_params()
    targ, _ = mods[tmx].get_params()
    assert sorted(targ) == sorted(jarg)
    for k in jarg:
        want, got = jarg[k].asnumpy(), targ[k].asnumpy()
        assert _rel(got, want) < 2e-5, (k, _rel(got, want))
        assert _rel(got, start[k]) > 1e-3, k      # it trained
    jname, jval = metrics[jmx].get()
    tname, tval = metrics[tmx].get()
    assert tname == jname == "Perplexity"
    assert np.isfinite(tval) and abs(tval - jval) <= 1e-5 * jval
    want = {16} if compile_buckets else {8, 16}
    assert set(mods[tmx]._buckets) == set(mods[jmx]._buckets) == want


class _TimeMajorPerplexity(tmx.metric.Perplexity):
    """Perplexity with each ``(N, T)`` label transposed to the time-major
    order of ``lstm_unroll``'s output rows (on the device, no sync)."""

    def update(self, labels, preds):
        super().update([tnd.NDArray(l.tensor.t().contiguous())
                        for l in labels], preds)


def test_perplexity_pairs_lstm_unroll_rows_as_the_reference_does():
    # lstm_unroll's output rows are time-major (the steps concatenated on
    # axis 0) while a bucket's labels are batch-major, and Perplexity
    # flattens labels as they come: its value pairs row t*N+n with label
    # n*T+t in both packages (the fit parity above).  Transposed labels
    # give the model's own cross-entropy.
    batch, seq, vocab = 3, 4, 6
    rs = np.random.RandomState(0)
    pred = rs.uniform(0.1, 1.0, (seq * batch, vocab)).astype(np.float32)
    pred /= pred.sum(1, keepdims=True)
    label = rs.randint(1, vocab, (batch, seq)).astype(np.float32)
    label[0, -1] = 0
    time_major = label.T.reshape(-1).astype(int)
    keep = time_major != 0
    nll = -np.log(pred[np.arange(seq * batch), time_major])[keep].mean()
    m = _TimeMajorPerplexity(ignore_label=0)
    m.update([tnd.array(label, ctx=CPU)], [tnd.array(pred, ctx=CPU)])
    np.testing.assert_allclose(m.get()[1], np.exp(nll), rtol=1e-5)
    jm, tm = jmx.metric.Perplexity(ignore_label=0), \
        tmx.metric.Perplexity(ignore_label=0)
    jm.update([jmx.nd.array(label)], [jmx.nd.array(pred)])
    tm.update([tnd.array(label, ctx=CPU)], [tnd.array(pred, ctx=CPU)])
    np.testing.assert_allclose(tm.get()[1], jm.get()[1], rtol=1e-6)
    assert abs(tm.get()[1] - m.get()[1]) > 1e-3


def test_bucketing_fit_perplexity_falls():
    vocab, hidden, batch = 30, 16, 8
    sentences = [[1 + (i + j) % (vocab - 1) for j in range(5 + i % 10)]
                 for i in range(160)]
    init_states = _states(1, batch, hidden)
    it = tmx.rnn.BucketSentenceIter(sentences, batch, buckets=[8, 16],
                                    invalid_label=0,
                                    init_states=init_states, ctx=CPU,
                                    rng=np.random.RandomState(0))
    mod = tmx.mod.BucketingModule(
        _sym_gen(tmx, vocab, hidden, 1, init_states),
        default_bucket_key=16, context=tmx.cpu())
    values = []
    for _ in range(3):
        metric = _TimeMajorPerplexity(ignore_label=0)
        mod.fit(it, eval_metric=metric, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=tmx.init.Xavier(factor_type="in",
                                            magnitude=2.34), num_epoch=1)
        values.append(metric.get()[1])
    assert values[2] < values[0] * 0.5, values


def _one_bucket_batch(mx, batch, seq_len, vocab, init_states, seed=3):
    rs = np.random.RandomState(seed)
    data = rs.randint(1, vocab, (batch, seq_len)).astype(np.float32)
    label = np.empty_like(data)
    label[:, :-1] = data[:, 1:]
    label[:, -1] = 0
    arr = (lambda a: mx.nd.array(a)) if mx is jmx \
        else (lambda a: tnd.array(a, ctx=CPU))
    return mx.io.DataBatch(
        [arr(data)] + [arr(np.zeros(s, np.float32)) for _, s in init_states],
        [arr(label)], pad=0, bucket_key=seq_len,
        provide_data=[mx.io.DataDesc("data", data.shape)]
        + [mx.io.DataDesc(n, s) for n, s in init_states],
        provide_label=[mx.io.DataDesc("softmax_label", label.shape)])


def test_compile_bucket_padding_matches_unpadded():
    """compile_buckets pads a short bucket to the default key; with an
    ignore_label symbol the padded step gives the update of the bucket's
    own executor, in the port and against the JAX package."""
    vocab, hidden, batch = 30, 8, 4
    init_states = _states(1, batch, hidden)
    default = ([("data", (batch, 16))] + init_states,
               [("softmax_label", (batch, 16))])
    results = {}
    for mx in (jmx, tmx):
        for sharing in (False, True):
            np.random.seed(7)
            mod = mx.mod.BucketingModule(
                _sym_gen(mx, vocab, hidden, 1, init_states), 16,
                context=mx.cpu(), compile_buckets=True if sharing else None)
            mod.bind(*default)
            if mx is jmx:
                mod.init_params()
                start, _ = mod.get_params()
                start = {k: v.asnumpy() for k, v in start.items()}
            else:
                mod.init_params(arg_params=start)
            mod.init_optimizer(optimizer="sgd",
                               optimizer_params={"learning_rate": 0.1})
            b = _one_bucket_batch(mx, batch, 5, vocab, init_states)
            mod.forward(b, is_train=True)
            mod.backward()
            mod.update()
            metric = mx.metric.Perplexity(ignore_label=0)
            mod.update_metric(metric, b.label)
            args, _ = mod.get_params()
            results[(mx, sharing)] = ({k: v.asnumpy()
                                       for k, v in args.items()},
                                      metric.get()[1])
            assert set(mod._buckets) == ({16} if sharing else {16, 5})
    for k, want in results[(tmx, False)][0].items():
        np.testing.assert_allclose(results[(tmx, True)][0][k], want,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(want, results[(jmx, False)][0][k],
                                   rtol=1e-5, atol=1e-6)
    ppl = [results[key][1] for key in results]
    np.testing.assert_allclose(ppl, ppl[0], rtol=1e-5)


def test_bucketing_module_fit_with_optimizer_borrow():
    """Buckets bound after init_optimizer share its optimizer; the
    buckets share the default bucket's parameter tensors."""
    vocab, hidden, batch = 60, 16, 8
    init_states = _states(1, batch, hidden)
    it = tmx.rnn.BucketSentenceIter(_corpus(200, vocab), batch,
                                    buckets=[8, 16], invalid_label=0,
                                    init_states=init_states, ctx=CPU)
    mod = tmx.mod.BucketingModule(
        _sym_gen(tmx, vocab, hidden, 1, init_states, ignore_label=None),
        default_bucket_key=it.default_bucket_key, context=tmx.cpu())
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05},
            eval_metric=tmx.metric.Perplexity(ignore_label=0))
    assert set(mod._buckets) == {8, 16}
    small, big = mod._buckets[8], mod._buckets[16]
    assert small._updater is big._updater and small.optimizer_initialized
    assert small._exec_group.shares_param_storage
    for name in ("embed_weight", "l0_i2h_weight", "cls_bias"):
        assert (small._exec_group.execs[0].arg_dict[name]
                is big._exec_group.execs[0].arg_dict[name])


def test_bucketing_refusals():
    mod = tmx.mod.BucketingModule(lambda k: None, default_bucket_key=8,
                                  context=tmx.cpu(), compile_buckets=[8])
    # install_monitor is ported (it was refused here before): the module
    # keeps the monitor for the buckets it binds later
    mon = tmx.Monitor(1)
    mod.install_monitor(mon)
    assert mod._monitor is mon
    with pytest.raises(MXNetError, match="exceeds every compile bucket"):
        mod._compile_key(12)


# ------------------------------------------------------------ metric
def test_perplexity_ignore_label_matches_jax():
    rs = np.random.RandomState(4)
    pred = rs.uniform(0.05, 1.0, (12, 7)).astype(np.float32)
    pred /= pred.sum(1, keepdims=True)
    label = rs.randint(0, 7, 12).astype(np.float32)
    label[[2, 5]] = 0
    out = []
    for mx, arr in ((jmx, jmx.nd.array),
                    (tmx, lambda a: tnd.array(a, ctx=CPU))):
        m = mx.metric.Perplexity(ignore_label=0)
        m.update([arr(label)], [arr(pred)])
        m.update([arr(label[:6])], [arr(pred[:6])])
        out.append(m.get())
    assert out[0][0] == out[1][0]
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-6)
    m = tmx.metric.create("perplexity", ignore_label=0)
    m.update([tnd.array(np.array([1, 2, 0, 3], np.float32), ctx=CPU)],
             [tnd.array(np.full((4, 5), 0.2, np.float32), ctx=CPU)])
    assert np.isclose(m.get()[1], 5.0, rtol=1e-5)


# ---------------------------------------------------------- host syncs
_SYNCS = ("item", "cpu", "tolist", "numpy", "__bool__", "__float__",
          "__int__")


def _count_fit_syncs(monkeypatch, nbatch, compile_buckets):
    vocab, hidden, batch = 30, 8, 4
    counts = []

    def count(name, orig):
        def f(*a, **k):
            counts.append(name)
            return orig(*a, **k)
        return f

    # nbatch batches: half in each bucket
    sentences = [[1 + j % (vocab - 1) for j in range(6 if i % 2 else 12)]
                 for i in range(nbatch * batch)]
    init_states = _states(1, batch, hidden)
    it = tmx.rnn.BucketSentenceIter(sentences, batch, buckets=[8, 16],
                                    invalid_label=0,
                                    init_states=init_states, ctx=CPU,
                                    rng=np.random.RandomState(0))
    mod = tmx.mod.BucketingModule(
        _sym_gen(tmx, vocab, hidden, 1, init_states), default_bucket_key=16,
        context=tmx.cpu(), compile_buckets=compile_buckets)
    with monkeypatch.context() as mp:
        for name in _SYNCS:
            mp.setattr(torch.Tensor, name, count(name, getattr(torch.Tensor,
                                                               name)))
        mod.fit(it, eval_metric=tmx.metric.Perplexity(ignore_label=0),
                num_epoch=1, optimizer="sgd",
                optimizer_params={"learning_rate": 0.1},
                batch_end_callback=tmx.callback.Speedometer(batch, 100))
    return len(counts)


@pytest.mark.parametrize("compile_buckets", [True, None])
def test_bucketing_fit_host_syncs_do_not_grow_with_batches(monkeypatch,
                                                           compile_buckets):
    small = _count_fit_syncs(monkeypatch, 4, compile_buckets)
    large = _count_fit_syncs(monkeypatch, 16, compile_buckets)
    # the epoch boundary's metric read only
    assert large == small <= 4, (small, large)


# ------------------------------------------------------- FusedTrainer
def test_fused_trainer_on_lstm_unroll_matches_jax():
    vocab, hidden, batch, seq, layers = 50, 12, 4, 8, 2
    states = [n for n, _ in _states(layers, batch, hidden)]
    nets = {mx: (jlstm if mx is jmx else tlstm).get_symbol(
        num_classes=vocab, seq_len=seq, num_hidden=hidden, num_embed=hidden,
        num_lstm_layer=layers, dropout=0.0) for mx in (jmx, tmx)}
    opt = {"lr": 1.0, "rescale_grad": 1.0 / batch}
    shapes = dict(data=(batch, seq), softmax_label=(batch, seq),
                  **{s: (batch, hidden) for s in states})
    np.random.seed(0)
    jt = JTrainer(nets[jmx], data_names=("data", *states), optimizer="sgd",
                  optimizer_params=dict(opt))
    jt.init(**shapes)
    tt = TTrainer(nets[tmx], data_names=("data", *states), optimizer="sgd",
                  optimizer_params=dict(opt), device=CPU).init(**shapes)
    arg, aux = jt.get_params()
    convert.load_trainer_params(tt, {k: v.asnumpy() for k, v in arg.items()})
    rs = np.random.RandomState(1)
    zeros = np.zeros((batch, hidden), np.float32)
    for step in range(3):
        feed = {"data": rs.randint(0, vocab, (batch, seq)).astype(np.float32),
                "softmax_label": rs.randint(0, vocab, (batch, seq)).astype(
                    np.float32), **{s: zeros for s in states}}
        jout = np.asarray(jt.step(**feed)[0])
        tout = tt.step(**feed)[0].numpy()
        np.testing.assert_allclose(tout, jout, rtol=1e-5, atol=1e-6)
    jarg, _ = jt.get_params()
    targ, _ = tt.get_params()
    for k, v in jarg.items():
        assert _rel(targ[k].numpy(), v.asnumpy()) < 1e-5, k


def test_fused_trainer_runs_the_dropout_graph_through_step():
    net = tlstm.get_symbol(num_classes=30, seq_len=6, num_hidden=8,
                           num_embed=8, num_lstm_layer=2)
    states = [n for n, _ in _states(2, 4, 8)]
    tt = TTrainer(net, data_names=("data", *states), optimizer="sgd",
                  optimizer_params={"lr": 1.0, "rescale_grad": 0.25},
                  device=CPU).init(data=(4, 6), softmax_label=(4, 6),
                                   **{s: (4, 8) for s in states})
    rs = np.random.RandomState(2)
    feed = {"data": rs.randint(0, 30, (4, 6)).astype(np.float32),
            "softmax_label": rs.randint(0, 30, (4, 6)).astype(np.float32),
            **{s: np.zeros((4, 8), np.float32) for s in states}}
    outs = tt.step_multi(**{k: np.stack([v] * 3) for k, v in feed.items()})
    assert outs[0].shape == (3, 24, 30)
    assert bool(torch.isfinite(outs[0]).all())
    assert not torch.equal(outs[0][1], outs[0][2])   # fresh masks a step

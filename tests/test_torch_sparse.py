"""Row-sparse training: the port's ``sparse`` against the JAX package's.

Mirrors ``tests/test_sparse.py`` case for case, less the mesh-sharded
table (several devices, ROADMAP Queue 1 item 10); its slow example smoke
runs here at a small size through the port's own copy of
``examples/recommenders/sparse_mf.py``'s graph.  Inputs are made with
numpy from a seed and handed to both packages.

Tolerances: storage, the Embedding's row-sparse gradient against the
dense one and the row pulls are exact (0); the fused sparse bucket
against the eager path, lazy state, ``MXTPU_SPARSE_UPDATE=0`` and the
optimizer-state round trip are bit-identical within the port; port
against JAX updates agree to rtol 1e-6 / atol 1e-7 in fp32 (the segment
sums may add in another order), the Module trainings to 1e-6 over three
batches (5e-6 absolute with Adam, whose step does not shrink with a
row's gradient); bf16 tables to one bf16 ulp of the update (rtol 2**-6, atol
2**-8), as the reference's own test allows.
"""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import amp as jamp
from mxnet_tpu import nd as jnd
from mxnet_tpu import sparse as jsparse
from mxnet_tpu import sym as jsym

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch import sparse as tsparse
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.sparse import RowSparseNDArray

CPU = "cpu"


def _rs(idx, vals, shape):
    return RowSparseNDArray(np.asarray(idx, np.int32),
                            torch.tensor(np.asarray(vals, np.float32)),
                            shape)


def _jrs(idx, vals, shape):
    return jsparse.RowSparseNDArray(
        jnd.NDArray(np.asarray(idx, np.int32)),
        jnd.NDArray(np.asarray(vals, np.float32)), shape)


def _eq(a, b, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


# ------------------------------------------------------------- storage
def test_row_sparse_array_construct_and_dense():
    a = tnd.sparse.row_sparse_array(
        (np.ones((2, 3), np.float32), [4, 1]), shape=(6, 3), ctx=CPU)
    j = jmx.nd.sparse.row_sparse_array(
        (np.ones((2, 3), np.float32), [4, 1]), shape=(6, 3))
    assert a.stype == "row_sparse" and a.shape == (6, 3)
    np.testing.assert_array_equal(a.indices.asnumpy(), [1, 4])
    np.testing.assert_array_equal(a.todense().asnumpy(),
                                  j.todense().asnumpy())
    back = tnd.sparse.row_sparse_array(a.todense(), shape=(6, 3), ctx=CPU)
    np.testing.assert_array_equal(back.indices.asnumpy(), [1, 4])
    dup = _rs([2, 2], np.ones((2, 3)), (4, 3))
    assert dup.todense().asnumpy()[2].sum() == 6.0


def test_sparse_zeros_and_tostype():
    z = tsparse.zeros("row_sparse", (5, 2), ctx=CPU)
    assert z.indices.shape == (0,)
    assert z.todense().asnumpy().sum() == 0.0
    d = z.tostype("default")
    assert getattr(d, "stype", "default") == "default"
    with pytest.raises(MXNetError):
        tsparse.zeros("csr", (5, 2), ctx=CPU)


def test_dense_read_of_sparse_raises():
    z = tsparse.zeros("row_sparse", (5, 2), ctx=CPU)
    with pytest.raises(MXNetError):
        z.tensor
    with pytest.raises(MXNetError):
        z[:] = 1.0


def test_save_load_round_trip(tmp_path):
    """The (indices, values, shape) triple both ways across the
    packages, in dicts and lists."""
    a = tnd.sparse.row_sparse_array(
        (np.arange(6, dtype=np.float32).reshape(2, 3), [0, 3]),
        shape=(7, 3), ctx=CPU)
    d = tnd.array(np.arange(4, dtype=np.float32), ctx=CPU)
    p = str(tmp_path / "mix.npz")
    tnd.save(p, {"a": a, "d": d})
    back = tnd.load(p, ctx=CPU)
    assert isinstance(back["a"], RowSparseNDArray)
    np.testing.assert_array_equal(back["a"].indices.asnumpy(), [0, 3])
    np.testing.assert_array_equal(back["a"].todense().asnumpy(),
                                  a.todense().asnumpy())
    np.testing.assert_array_equal(back["d"].asnumpy(), d.asnumpy())
    jback = jnd.load(p)
    assert isinstance(jback["a"], jsparse.RowSparseNDArray)
    np.testing.assert_array_equal(jback["a"].todense().asnumpy(),
                                  a.todense().asnumpy())
    tnd.save(p, [a, d])
    back = tnd.load(p, ctx=CPU)
    assert isinstance(back[0], RowSparseNDArray)
    np.testing.assert_array_equal(back[0].todense().asnumpy(),
                                  a.todense().asnumpy())
    np.testing.assert_array_equal(back[1].asnumpy(), d.asnumpy())
    jnd.save(p, [jsparse.row_sparse_array(
        (np.ones((1, 3), np.float32), [5]), shape=(7, 3)), jnd.zeros((2,))])
    back = tnd.load(p, ctx=CPU)
    assert isinstance(back[0], RowSparseNDArray)
    np.testing.assert_array_equal(back[0].indices.asnumpy(), [5])


# ------------------------------------------------- Embedding's backward
def _embed_net(s, grad_stype=None, n=12, d=4):
    data = s.Variable("data")
    w = s.Variable("embed_weight", grad_stype=grad_stype)
    e = s.Embedding(data, weight=w, input_dim=n, output_dim=d,
                    name="embed")
    return s.sum(e * e)


def _port_grad(gs, idx, W, n=12, d=4):
    ex = _embed_net(tsym, gs, n, d).simple_bind(CPU, data=idx.shape)
    ex.arg_dict["data"][:] = torch.tensor(idx)
    ex.arg_dict["embed_weight"][:] = torch.tensor(W)
    ex.forward(is_train=True)
    ex.backward()
    return ex.grad_dict["embed_weight"], ex.outputs[0].numpy()


def test_embedding_sparse_vs_dense_grad_parity():
    W = np.random.RandomState(0).randn(12, 4).astype(np.float32)
    idx = np.array([[1, 2, 2, 9], [0, 1, 3, 3]], np.float32)
    gd, fwd_d = _port_grad(None, idx, W)
    gs, fwd_s = _port_grad("row_sparse", idx, W)
    assert isinstance(gs, RowSparseNDArray)
    assert getattr(gd, "stype", "default") == "default"
    np.testing.assert_array_equal(fwd_s, fwd_d)
    np.testing.assert_array_equal(gs.todense().asnumpy(), gd.numpy())
    ids = gs.indices.asnumpy()
    assert (np.sort(ids) == ids).all() and ids.shape == (8,)
    assert set(ids) == {0, 1, 2, 3, 9}
    # the JAX executor's coalesced pair, slot for slot
    jex = _embed_net(jsym, "row_sparse").simple_bind(jmx.cpu(), data=(2, 4))
    jex.arg_dict["data"][:] = idx
    jex.arg_dict["embed_weight"][:] = W
    jex.forward(is_train=True)
    jex.backward()
    jg = jex.grad_dict["embed_weight"]
    np.testing.assert_array_equal(ids, jg.indices.asnumpy())
    _eq(gs.data.asnumpy(), jg.data.asnumpy(), 0, 0)


def test_embedding_clips_out_of_range_ids():
    W = np.random.RandomState(1).randn(5, 3).astype(np.float32)
    wild = np.array([[-7, 0, 4, 99]], np.float32)
    clipped = np.array([[0, 0, 4, 4]], np.float32)
    out_wild = tnd.Embedding(tnd.array(wild, ctx=CPU), tnd.array(W, ctx=CPU),
                             input_dim=5, output_dim=3).asnumpy()
    out_clip = tnd.Embedding(tnd.array(clipped, ctx=CPU),
                             tnd.array(W, ctx=CPU), input_dim=5,
                             output_dim=3).asnumpy()
    np.testing.assert_array_equal(out_wild, out_clip)
    g, _ = _port_grad("row_sparse", wild, W, n=5, d=3)
    ids = g.indices.asnumpy()
    assert ids.min() >= 0 and ids.max() <= 4


def test_one_hot_honors_dtype():
    x = tnd.array(np.array([0, 2], np.float32), ctx=CPU)
    assert tnd.one_hot(x, depth=3, dtype="int32").asnumpy().dtype == np.int32
    assert tnd.one_hot(tnd.array(np.array([1], np.float32), ctx=CPU),
                       depth=2, dtype="float16").asnumpy().dtype \
        == np.float16
    assert tnd.one_hot(tnd.array(np.zeros(1, np.float32), ctx=CPU),
                       depth=2).asnumpy().dtype == np.float32


def test_sparse_update_env_off_restores_dense(monkeypatch):
    monkeypatch.setenv("MXTPU_SPARSE_UPDATE", "0")
    ex = _embed_net(tsym, "row_sparse").simple_bind(CPU, data=(2, 4))
    assert getattr(ex.grad_dict["embed_weight"], "stype",
                   "default") == "default"


def test_tied_weight_falls_back_dense():
    data = tsym.Variable("data")
    w = tsym.Variable("w", grad_stype="row_sparse")
    e = tsym.Embedding(data, weight=w, input_dim=6, output_dim=3)
    out = tsym.sum(e) + tsym.sum(w * w)  # a second consumer
    ex = out.simple_bind(CPU, data=(2, 2))
    assert getattr(ex.grad_dict["w"], "stype", "default") == "default"
    assert tsparse.rs_plan(out) == {}


# ----------------------------------------------------- the kvstore
def _sparse_kv(pkg, optname="sgd", shape=(10, 4), **okw):
    W = (np.arange(np.prod(shape), dtype=np.float32)
         .reshape(shape) / np.prod(shape)).astype(np.float32)
    if pkg == "torch":
        kv = tmx.kv.create("local")
        kv.set_optimizer(tmx.optimizer.create(
            optname, learning_rate=0.05, rescale_grad=0.5, **okw))
        kv.init(0, tsparse.full_row_sparse(tnd.array(W, ctx=CPU)))
    else:
        kv = jmx.kv.create("local")
        kv.set_optimizer(jmx.optimizer.create(
            optname, learning_rate=0.05, rescale_grad=0.5, **okw))
        kv.init(0, jsparse.full_row_sparse(jnd.array(W)))
    return kv, W


def _pull(kv, pkg, shape):
    out = tnd.zeros(shape, ctx=CPU) if pkg == "torch" else jnd.zeros(shape)
    kv.pull([0], [out])
    return out.asnumpy()


def test_push_stype_mismatch_raises_both_ways():
    kv = tmx.kv.create("local")
    kv.set_optimizer(tmx.optimizer.create("sgd"))
    kv.init("dense", tnd.zeros((4, 2), ctx=CPU))
    kv.init("sparse", tsparse.full_row_sparse(tnd.zeros((4, 2), ctx=CPU)))
    with pytest.raises(MXNetError, match="row_sparse"):
        kv.push(["dense"], [[tsparse.zeros("row_sparse", (4, 2), ctx=CPU)]])
    with pytest.raises(MXNetError, match="default"):
        kv.push(["sparse"], [[tnd.zeros((4, 2), ctx=CPU)]])
    with pytest.raises(MXNetError, match="row_sparse"):
        kv.push("dense", tsparse.zeros("row_sparse", (4, 2), ctx=CPU))


def test_pull_rs_out_on_dense_key_raises():
    kv = tmx.kv.create("local")
    kv.init(0, tnd.zeros((4, 2), ctx=CPU))
    with pytest.raises(MXNetError, match="row_sparse_pull"):
        kv.pull([0], [tsparse.zeros("row_sparse", (4, 2), ctx=CPU)])


def test_row_sparse_pull_subsets():
    kv, W = _sparse_kv("torch")
    got = kv.row_sparse_pull(0, row_ids=tnd.array(
        np.array([7, 2, 2], np.float32), ctx=CPU))
    assert isinstance(got, RowSparseNDArray)
    np.testing.assert_array_equal(got.indices.asnumpy(), [7, 2, 2])
    np.testing.assert_array_equal(got.data.asnumpy(), W[[7, 2, 2]])
    out = tsparse.zeros("row_sparse", (10, 4), ctx=CPU)
    kv.row_sparse_pull(0, out=out, row_ids=np.array([0, 9]))
    np.testing.assert_array_equal(out.data.asnumpy(), W[[0, 9]])
    kv.init("dense", tnd.zeros((3, 2), ctx=CPU))
    with pytest.raises(MXNetError, match="row_sparse"):
        kv.row_sparse_pull("dense", row_ids=np.array([0]))
    with pytest.raises(MXNetError, match="row_ids"):
        kv.row_sparse_pull(0)


def test_pulled_rows_do_not_alias_the_table():
    """The port updates tables in place, so every pull copies: rows and
    weights pulled before a push keep their values after it (the JAX
    package donates the table instead and raises on a stale read)."""
    kv, W = _sparse_kv("torch")
    rows = kv.row_sparse_pull(0, row_ids=np.array([1, 2]))
    dense = tnd.zeros((10, 4), ctx=CPU)
    kv.pull([0], [dense])
    kv.push([0], [[_rs([1, 2], np.ones((2, 4)), (10, 4))]])
    np.testing.assert_array_equal(rows.data.asnumpy(), W[[1, 2]])
    np.testing.assert_array_equal(dense.asnumpy(), W)
    assert not np.array_equal(_pull(kv, "torch", (10, 4)), W)


def _push_steps(kv, pkg, shape, steps=4, lookups=6, seed=2):
    rs = np.random.RandomState(seed)
    make = _rs if pkg == "torch" else _jrs
    for _ in range(steps):
        idx = rs.randint(0, shape[0], lookups)
        vals = rs.randn(lookups, *shape[1:]).astype(np.float32)
        kv.push([0], [[make(idx, vals, shape)]])


@pytest.mark.parametrize("optname,okw", [
    ("sgd", {"momentum": 0.9}),
    ("adam", {}),
    ("rmsprop", {}),
])
def test_fused_sparse_bucket_vs_eager_bit_identical(monkeypatch, optname,
                                                    okw):
    """The fused sparse bucket and the eager per-key path run one row
    function: weights and lazy state match bit for bit; and both match
    the JAX store."""
    shape = (10, 4)

    def run(pkg, fused):
        monkeypatch.setenv("MXTPU_FUSED_UPDATE", "1" if fused else "0")
        kv, _ = _sparse_kv(pkg, optname, shape, **okw)
        _push_steps(kv, pkg, shape)
        slots = tsparse._state_slots(kv._updater.states.get(0))
        return _pull(kv, pkg, shape), [s.asnumpy() for s in slots]

    w_f, s_f = run("torch", True)
    w_e, s_e = run("torch", False)
    np.testing.assert_array_equal(w_f, w_e)
    assert len(s_f) == len(s_e)
    for a, b in zip(s_f, s_e):
        np.testing.assert_array_equal(a, b)
    w_j, s_j = run("jax", True)
    _eq(w_f, w_j)
    for a, b in zip(s_f, s_j):
        _eq(a, b)


def test_lazy_state_semantics():
    shape = (8, 3)
    kv, W = _sparse_kv("torch", "sgd", shape, momentum=0.9, wd=0.1)
    touched = [0, 2, 5]
    vals = np.ones((3, 3), np.float32)
    kv.push([0], [[_rs(touched, vals, shape)]])
    kv.push([0], [[_rs(touched, vals, shape)]])
    got = _pull(kv, "torch", shape)
    untouched = [i for i in range(8) if i not in touched]
    np.testing.assert_array_equal(got[untouched], W[untouched])
    assert not np.allclose(got[touched], W[touched])
    mom = tsparse._state_slots(kv._updater.states[0])[0].asnumpy()
    np.testing.assert_array_equal(mom[untouched], 0.0)
    assert np.abs(mom[touched]).sum() > 0


def test_duplicate_ids_sum_like_dense():
    """Duplicates coalesce first, then one rule application per row (so
    Adam's moments decay once)."""
    shape = (6, 2)

    def run(idx, vals, opt="sgd"):
        kv, _ = _sparse_kv("torch", opt, shape)
        kv.push([0], [[_rs(idx, vals, shape)]])
        return _pull(kv, "torch", shape), tsparse._state_slots(
            kv._updater.states.get(0))

    a, _ = run([3, 3, 1], [[1, 1], [2, 2], [5, 5]])
    b, _ = run([1, 3], [[5, 5], [3, 3]])
    _eq(a, b)
    a, sa = run([3, 3, 1], [[1, 1], [2, 2], [5, 5]], "adam")
    b, sb = run([1, 3], [[5, 5], [3, 3]], "adam")
    _eq(a, b)
    for x, y in zip(sa, sb):
        _eq(x.asnumpy(), y.asnumpy())


def test_multi_device_copies_segment_sum():
    shape = (9, 2)
    kv, W = _sparse_kv("torch", "sgd", shape)
    g1 = _rs([1, 4], np.ones((2, 2)), shape)
    g2 = _rs([4, 8], 2 * np.ones((2, 2)), shape)
    kv.push([0], [[g1, g2]])
    out = _pull(kv, "torch", shape)
    kv2, _ = _sparse_kv("torch", "sgd", shape)
    merged = g1.todense().asnumpy() + g2.todense().asnumpy()
    rows = np.flatnonzero(merged.any(axis=1))
    kv2.push([0], [[_rs(rows, merged[rows], shape)]])
    _eq(out, _pull(kv2, "torch", shape))


def test_zero_recompiles_after_warmup(monkeypatch):
    """The port compiles nothing, but its row functions are built once
    and kept, as the reference's programs are: after the first pushes no
    new one is built."""
    shape = (32, 4)
    kv, _ = _sparse_kv("torch", "adam", shape)
    _push_steps(kv, "torch", shape, steps=2)
    calls = []
    real = tsparse.make_row_program
    monkeypatch.setattr(tsparse, "make_row_program",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    _push_steps(kv, "torch", shape, steps=5, seed=7)
    assert calls == []


def test_mixed_dense_and_sparse_keys_one_push():
    kv = tmx.kv.create("local")
    kv.set_optimizer(tmx.optimizer.create("sgd", learning_rate=0.1,
                                          rescale_grad=1.0))
    Wd = np.ones((4, 2), np.float32)
    Ws = np.ones((6, 2), np.float32)
    kv.init([0, 1], [tnd.array(Wd, ctx=CPU),
                     tsparse.full_row_sparse(tnd.array(Ws, ctx=CPU))])
    g_dense = tnd.array(0.5 * np.ones((4, 2), np.float32), ctx=CPU)
    g_rs = _rs([2], np.ones((1, 2)), (6, 2))
    kv.push([0, 1], [[g_dense], [g_rs]])
    o0, o1 = tnd.zeros((4, 2), ctx=CPU), tnd.zeros((6, 2), ctx=CPU)
    kv.pull([0, 1], [o0, o1])
    np.testing.assert_allclose(o0.asnumpy(), Wd - 0.05, rtol=1e-6)
    expect = Ws.copy()
    expect[2] -= 0.1
    np.testing.assert_allclose(o1.asnumpy(), expect, rtol=1e-6)
    assert kv._fused is not None
    assert len(kv._fused._sparse_buckets) == 1
    assert kv._fused.num_buckets == 1


def test_optimizer_states_save_load_round_trip(tmp_path):
    shape = (10, 4)
    fname = str(tmp_path / "opt.states")
    kv, _ = _sparse_kv("torch", "sgd", shape, momentum=0.9)
    _push_steps(kv, "torch", shape, steps=4)
    want = _pull(kv, "torch", shape)
    kv1, _ = _sparse_kv("torch", "sgd", shape, momentum=0.9)
    _push_steps(kv1, "torch", shape, steps=2)
    kv1.save_optimizer_states(fname)
    mid = tnd.zeros(shape, ctx=CPU)
    kv1.pull([0], [mid])
    kv2 = tmx.kv.create("local")
    kv2.set_optimizer(tmx.optimizer.create(
        "sgd", learning_rate=0.05, rescale_grad=0.5, momentum=0.9))
    kv2.init(0, tsparse.full_row_sparse(mid))
    kv2.load_optimizer_states(fname)
    rs = np.random.RandomState(2)
    for _ in range(2):
        rs.randint(0, shape[0], 6)
        rs.randn(6, 4)
    for _ in range(2):
        idx = rs.randint(0, shape[0], 6)
        vals = rs.randn(6, 4).astype(np.float32)
        kv2.push([0], [[_rs(idx, vals, shape)]])
    np.testing.assert_array_equal(_pull(kv2, "torch", shape), want)


# ------------------------------------------------------------- Module
def _mf_net(s, grad_stype):
    data = s.Variable("data")
    w = s.Variable("embed_weight", grad_stype=grad_stype)
    e = s.Embedding(data, weight=w, input_dim=50, output_dim=8,
                    name="embed")
    f = s.sum(e, axis=1)
    fc = s.FullyConnected(f, num_hidden=3, name="fc")
    return s.SoftmaxOutput(fc, name="softmax")


def _mf_data():
    rs = np.random.RandomState(0)
    X = rs.randint(0, 50, (64, 5)).astype(np.float32)
    Y = rs.randint(0, 3, (64,)).astype(np.float32)
    init = {"embed_weight": rs.uniform(-.07, .07, (50, 8)).astype(np.float32),
            "fc_weight": rs.uniform(-.07, .07, (3, 8)).astype(np.float32),
            "fc_bias": np.zeros(3, np.float32)}
    return X, Y, init


def _mf_train(pkg, grad_stype, X, Y, init, nbatch=None, kvstore="local",
              optimizer="sgd", num_epoch=2):
    n = 64 if nbatch is None else 16 * nbatch
    if pkg == "torch":
        it = tmx.io.NDArrayIter(X[:n], Y[:n], batch_size=16)
        mod = tmx.mod.Module(_mf_net(tsym, grad_stype), context=tmx.cpu())
        params = {k: tnd.array(v, ctx=CPU) for k, v in init.items()}
    else:
        it = jmx.io.NDArrayIter(X[:n], Y[:n], batch_size=16)
        mod = jmx.mod.Module(_mf_net(jsym, grad_stype), context=jmx.cpu())
        params = {k: jnd.array(v) for k, v in init.items()}
    mod.fit(it, optimizer=optimizer, kvstore=kvstore,
            optimizer_params={"learning_rate": 0.1}, num_epoch=num_epoch,
            arg_params=params)
    return mod


def _params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_module_sparse_training_parity(monkeypatch):
    """Sparse Module training equals the dense module for plain SGD (wd
    0: lazy and dense coincide) and ``MXTPU_SPARSE_UPDATE=0`` restores
    the dense path exactly; the sparse module equals the JAX one over
    three batches with SGD and with Adam (lazy moments)."""
    X, Y, init = _mf_data()
    p_sparse = _params(_mf_train("torch", "row_sparse", X, Y, init))
    p_dense = _params(_mf_train("torch", None, X, Y, init))
    for k in p_dense:
        _eq(p_sparse[k], p_dense[k], 2e-6, 1e-7)
    monkeypatch.setenv("MXTPU_SPARSE_UPDATE", "0")
    p_off = _params(_mf_train("torch", "row_sparse", X, Y, init))
    for k in p_dense:
        np.testing.assert_array_equal(p_off[k], p_dense[k], err_msg=k)
    monkeypatch.delenv("MXTPU_SPARSE_UPDATE")
    # Adam's step m / sqrt(v) is about lr whatever the gradient's size,
    # so a row touched once with a tiny gradient carries the gradient's
    # last-bit difference into the weight at lr scale: 5e-6 there
    for opt, atol in (("sgd", 1e-6), ("adam", 5e-6)):
        got = _params(_mf_train("torch", "row_sparse", X, Y, init, nbatch=3,
                                optimizer=opt, num_epoch=1))
        ref = _params(_mf_train("jax", "row_sparse", X, Y, init, nbatch=3,
                                optimizer=opt, num_epoch=1))
        for k in ref:
            _eq(got[k], ref[k], 1e-6, atol)


def test_sparse_training_zero_per_batch_host_syncs(monkeypatch):
    """The sparse loop reads nothing on the host a batch: the host reads
    (``.item``/``.cpu``/``.tolist``/``.numpy``, truth and number
    conversions of tensors) are the same at 2 and 4 batches."""
    counts = {"n": 0}
    names = ("item", "cpu", "tolist", "numpy", "__bool__", "__float__",
             "__int__")

    def count(fn):
        def wrapper(*a, **k):
            counts["n"] += 1
            return fn(*a, **k)
        return wrapper

    X, Y, init = _mf_data()

    def run(nbatch):
        counts["n"] = 0
        with monkeypatch.context() as mp:
            for n in names:
                mp.setattr(torch.Tensor, n, count(getattr(torch.Tensor, n)))
            _mf_train("torch", "row_sparse", X, Y, init, nbatch=nbatch,
                      num_epoch=1)
        return counts["n"]

    assert run(2) == run(4)


def test_updater_local_vs_in_store_fused_path():
    X, Y, init = _mf_data()
    local = _params(_mf_train("torch", "row_sparse", X, Y, init,
                              kvstore=None))
    kv = tmx.kv.create("local")
    in_store = _params(_mf_train("torch", "row_sparse", X, Y, init,
                                 kvstore=kv))
    assert kv._fused is not None and len(kv._fused._sparse_buckets) == 1
    for k in local:
        np.testing.assert_array_equal(local[k], in_store[k], err_msg=k)


def test_eager_update_requires_fused_rule():
    opt = tmx.optimizer.create("adadelta")
    upd = tmx.optimizer.get_updater(opt)
    w = tnd.array(np.ones((4, 2), np.float32), ctx=CPU)
    g = tsparse.zeros("row_sparse", (4, 2), ctx=CPU)
    with pytest.raises(MXNetError, match="fused rule"):
        upd(0, g, w)


# ------------------------------------------------------------- AMP
@pytest.fixture
def _amp_env(monkeypatch):
    for k in ("MXTPU_AMP", "MXTPU_LOSS_SCALE", "MXTPU_LOSS_SCALE_WINDOW"):
        monkeypatch.delenv(k, raising=False)
    tamp.reset_scaler()
    jamp.reset_scaler()
    yield monkeypatch
    tamp.reset_scaler()
    jamp.reset_scaler()


def test_sparse_bf16_table_fp32_master_rows(_amp_env):
    """A bf16 table keeps fp32 master rows (``mp``): untouched rows of
    table and master are byte-identical, touched table rows are the
    cast of their master rows, and the master rows match the JAX
    store's."""
    import jax.numpy as jnp

    _amp_env.setenv("MXTPU_AMP", "bf16")
    rows, dim = 50, 8
    rng = np.random.RandomState(1)
    table = rng.uniform(-1, 1, (rows, dim)).astype(np.float32)
    idx = np.array([3, 7, 3, 20], np.int32)
    vals = rng.uniform(-1, 1, (4, dim)).astype(np.float32)
    kv = tmx.kv.create("local")
    kv.set_optimizer(tmx.optimizer.create("adam", learning_rate=0.05))
    kv.init(0, tsparse.full_row_sparse(
        tnd.array(table, ctx=CPU).astype("bfloat16")))
    before = kv._store[0].tensor.float().numpy().copy()
    for _ in range(3):
        kv.push([0], [_rs(idx, vals, (rows, dim))])
    after = kv._store[0].tensor.float().numpy()
    touched = sorted(set(idx.tolist()))
    untouched = [r for r in range(rows) if r not in touched]
    np.testing.assert_array_equal(before[untouched], after[untouched])
    master = kv._updater.states[0][-1].tensor
    assert master.dtype == torch.float32
    mnp = master.numpy()
    np.testing.assert_array_equal(
        mnp[untouched], torch.tensor(table[untouched]).bfloat16().float())
    cast = torch.tensor(mnp[touched]).bfloat16().float().numpy()
    np.testing.assert_allclose(after[touched], cast, rtol=2 ** -6,
                               atol=2 ** -8)
    jkv = jmx.kv.create("local")
    jkv.set_optimizer(jmx.optimizer.create("adam", learning_rate=0.05))
    jkv.init(0, jsparse.full_row_sparse(
        jnd.array(table).astype(jnp.bfloat16)))
    for _ in range(3):
        jkv.push([0], [_jrs(idx, vals, (rows, dim))])
    _eq(mnp, jkv._updater.states[0][-1].asnumpy(), 1e-5, 1e-6)


def test_sparse_loss_scaling_skip_step(_amp_env):
    """Loss scaling in the row update (``scaling``): pushed rows are
    unscaled in the update, a push with an inf leaves table and state
    as they were and halves the scale, and a clean push trains on —
    as in the JAX store."""
    _amp_env.setenv("MXTPU_AMP", "bf16")
    _amp_env.setenv("MXTPU_LOSS_SCALE", "1024")
    _amp_env.setenv("MXTPU_LOSS_SCALE_WINDOW", "2")
    tamp.reset_scaler()
    jamp.reset_scaler()
    shape = (10, 4)
    rng = np.random.RandomState(3)
    W = rng.uniform(-1, 1, shape).astype(np.float32)
    g = rng.uniform(-0.1, 0.1, (5, 4)).astype(np.float32)
    idx = np.array([1, 4, 4, 7, 9], np.int32)
    runs = {}
    for pkg, kvm, nd_, sp, make, amp_mod in (
            ("torch", tmx.kv, tnd, tsparse, _rs, tamp),
            ("jax", jmx.kv, jnd, jsparse, _jrs, jamp)):
        kv = kvm.create("local")
        opt_mod = tmx.optimizer if pkg == "torch" else jmx.optimizer
        kv.set_optimizer(opt_mod.create("sgd", learning_rate=0.1,
                                        momentum=0.9))
        arr = nd_.array(W, ctx=CPU) if pkg == "torch" else nd_.array(W)
        kv.init(0, sp.full_row_sparse(arr))
        outs = []
        for step in range(4):
            s = amp_mod.global_scaler().report()["scale"]
            v = np.full_like(g, np.inf) if step == 2 else g * s
            kv.push([0], [[make(idx, v, shape)]])
            outs.append(_pull(kv, pkg, shape))
        runs[pkg] = (outs, amp_mod.global_scaler().report())
    outs, rep = runs["torch"]
    np.testing.assert_array_equal(outs[1], outs[2])  # the skipped step
    assert not np.array_equal(outs[2], outs[3])
    assert rep["overflow_total"] == 1 and rep["skipped_steps_total"] == 1
    assert rep == runs["jax"][1]
    for a, b in zip(outs, runs["jax"][0]):
        _eq(a, b)


# ---------------------------------------------------------- example
def test_sparse_recommender_example_smoke():
    """``examples/recommenders/sparse_mf.py``'s graph and loop through
    the port at a small size: both tables' gradients stay row-sparse and
    the training rmse falls well under the ratings' spread."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "recommenders"))
    try:
        import sparse_mf
    finally:
        sys.path.pop(0)
    users, items, ratings = sparse_mf.synth(np.random.RandomState(0), 6000)
    user = tsym.Variable("user")
    item = tsym.Variable("item")
    uw = tsym.Variable("user_embed_weight", grad_stype="row_sparse")
    iw = tsym.Variable("item_embed_weight", grad_stype="row_sparse")
    u = tsym.Embedding(user, weight=uw, input_dim=sparse_mf.USERS,
                       output_dim=sparse_mf.RANK, name="user_embed")
    v = tsym.Embedding(item, weight=iw, input_dim=sparse_mf.ITEMS,
                       output_dim=sparse_mf.RANK, name="item_embed")
    net = tsym.LinearRegressionOutput(tsym.sum(u * v, axis=1),
                                      tsym.Variable("score_label"),
                                      name="score")
    assert net.structural_signature() == sparse_mf.build() \
        .structural_signature()
    mod = tmx.mod.Module(net, data_names=("user", "item"),
                         label_names=("score_label",), context=tmx.cpu())
    it = tmx.io.NDArrayIter({"user": users, "item": items},
                            {"score_label": ratings}, batch_size=256,
                            shuffle=True)
    mod.fit(it, num_epoch=3, optimizer="adam",
            optimizer_params={"learning_rate": 0.05},
            initializer=tmx.init.Normal(0.1), eval_metric="rmse")
    ex = mod._exec_group.execs[0]
    for w in ("user_embed_weight", "item_embed_weight"):
        assert getattr(ex.grad_dict[w], "stype", "default") == "row_sparse"
    rmse = dict(mod.score(it, tmx.metric.create("rmse")))["rmse"]
    assert rmse < 0.9 * float(np.std(ratings)), rmse

"""The port's imperative NDArray against the JAX package's, on the CPU:
every operator (same shape, broadcast, scalar, reverse, in place,
comparisons), views that write through, reshape/slice/T/astype/copyto,
the creators, generated ``nd.<op>`` functions (FullyConnected,
Convolution, BatchNorm in eval) and ``nd.save``/``nd.load`` in both
directions, including the reference's ``0x112`` binary.

Inputs are made with numpy from a seed and handed to both packages; the
port runs with ``ctx="cpu"``.  Tolerance: exact for elementwise
arithmetic (both sides run the same IEEE float32 operation per element)
except where a library function may round differently (``**``, division
by the reciprocal), 1e-6 relative there; 1e-6 relative for the layers,
where torch and XLA sum products in other orders.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import interop as jinterop
from mxnet_tpu import ndarray as jnd
from mxnet_tpu import sparse as jsparse

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch import ops as tops

CPU = "cpu"


def _data(seed, *shape, low=0.5, high=2.0):
    return np.random.default_rng(seed).uniform(low, high, shape).astype(
        np.float32)


def _both(a):
    return jnd.array(a), tnd.array(a, ctx=CPU)


def _same(port, ref, rtol=0.0):
    p, r = port.asnumpy(), np.asarray(ref.asnumpy())
    assert p.dtype == r.dtype, (p.dtype, r.dtype)
    assert p.shape == r.shape
    np.testing.assert_allclose(p, r, rtol=rtol, atol=0)


# ------------------------------------------------------------ operators
BINARY = [
    ("add", lambda x, y: x + y, 0.0), ("sub", lambda x, y: x - y, 0.0),
    ("mul", lambda x, y: x * y, 0.0), ("div", lambda x, y: x / y, 1e-6),
    ("pow", lambda x, y: x ** y, 1e-6),
]


@pytest.mark.parametrize("name,fn,rtol", BINARY, ids=[b[0] for b in BINARY])
def test_same_shape_operators(name, fn, rtol):
    (jx, tx), (jy, ty) = _both(_data(0, 3, 4)), _both(_data(1, 3, 4))
    _same(fn(tx, ty), fn(jx, jy), rtol)


@pytest.mark.parametrize("name,fn,rtol", BINARY[:4],
                         ids=[b[0] for b in BINARY[:4]])
@pytest.mark.parametrize("rshape", [(1, 4), (3, 1), (4,)])
def test_broadcast_operators(name, fn, rtol, rshape):
    (jx, tx), (jy, ty) = _both(_data(2, 3, 4)), _both(_data(3, *rshape))
    _same(fn(tx, ty), fn(jx, jy), rtol)
    _same(fn(ty, tx), fn(jy, jx), rtol)


SCALAR = [
    ("add", lambda x: x + 2.5, 0.0), ("radd", lambda x: 2.5 + x, 0.0),
    ("sub", lambda x: x - 2.5, 0.0), ("rsub", lambda x: 2.5 - x, 0.0),
    ("mul", lambda x: x * 3, 0.0), ("rmul", lambda x: 3 * x, 0.0),
    ("div", lambda x: x / 4, 1e-6), ("rdiv", lambda x: 4 / x, 1e-6),
    ("pow", lambda x: x ** 2, 1e-6), ("rpow", lambda x: 2 ** x, 1e-6),
    ("neg", lambda x: -x, 0.0),
]


@pytest.mark.parametrize("name,fn,rtol", SCALAR, ids=[s[0] for s in SCALAR])
def test_scalar_and_reverse_operators(name, fn, rtol):
    jx, tx = _both(_data(4, 2, 5))
    _same(fn(tx), fn(jx), rtol)


INPLACE = ["__iadd__", "__isub__", "__imul__", "__itruediv__"]


@pytest.mark.parametrize("method", INPLACE)
@pytest.mark.parametrize("other", ["array", "scalar"])
def test_inplace_operators_write_the_array_itself(method, other):
    (jx, tx), (jy, ty) = _both(_data(5, 3, 4)), _both(_data(6, 3, 4))
    jo, to = (jy, ty) if other == "array" else (1.5, 1.5)
    storage = tx.tensor.data_ptr()
    got = getattr(tx, method)(to)
    want = getattr(jx, method)(jo)
    assert got is tx and tx.tensor.data_ptr() == storage
    _same(tx, want, 1e-6)


CMP = [("eq", lambda x, y: x == y), ("ne", lambda x, y: x != y),
       ("gt", lambda x, y: x > y), ("ge", lambda x, y: x >= y),
       ("lt", lambda x, y: x < y), ("le", lambda x, y: x <= y)]


@pytest.mark.parametrize("name,fn", CMP, ids=[c[0] for c in CMP])
@pytest.mark.parametrize("kind", ["same", "broadcast", "scalar"])
def test_comparisons_return_the_input_dtype(name, fn, kind):
    a = np.round(_data(7, 3, 4) * 2) / 2           # ties on purpose
    jx, tx = _both(a)
    if kind == "same":
        jy, ty = _both(np.round(_data(8, 3, 4) * 2) / 2)
    elif kind == "broadcast":
        jy, ty = _both(a[:1])
    else:
        jy = ty = float(a[1, 2])
    got, want = fn(tx, ty), fn(jx, jy)
    assert got.dtype == np.float32
    _same(got, want)
    assert set(np.unique(got.asnumpy())) <= {0.0, 1.0}


def test_int_comparison_keeps_int_dtype():
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    jx, tx = jnd.array(a, dtype=np.int32), tnd.array(a, ctx=CPU,
                                                     dtype=np.int32)
    _same(tx > 2, jx > 2)
    assert (tx > 2).dtype == np.int32


@pytest.mark.parametrize("fn", [lambda x: x + 1.5, lambda x: x * 2.7,
                                lambda x: 2.5 - x, lambda x: x / 2,
                                lambda x: x ** 2])
def test_int_arrays_cast_the_scalar_first(fn):
    a = np.arange(5, dtype=np.int32)
    got = fn(tnd.array(a, ctx=CPU, dtype="int32"))
    _same(got, fn(jnd.array(a, dtype="int32")))


def test_elemwise_ops_refuse_other_shapes():
    tx, ty = tnd.zeros((2, 3), ctx=CPU), tnd.zeros((3,), ctx=CPU)
    with pytest.raises(MXNetError, match="use broadcast_sub"):
        tnd.elemwise_sub(tx, ty)
    with pytest.raises(MXNetError, match="differ"):
        tx ** ty


# ------------------------------------------------- views and reshaping
def test_axis0_views_write_through():
    a = _data(9, 4, 3)
    jx, tx = _both(a)
    for x in (jx, tx):
        x[1][:] = 7.0
        x.slice(2, 4)[:] = np.full((2, 3), -1.0, np.float32)
        x[0:1] += 1.0
    _same(tx, jx)
    assert tx[2].tensor.data_ptr() == tx.tensor.data_ptr() + 2 * 3 * 4


def test_reshape_views_write_through():
    a = _data(10, 2, 6)
    jx, tx = _both(a)
    # the JAX side is given the 4 itself: its reshape(-1) calls the
    # generated ``max`` op in place of the builtin and raises TypeError
    with pytest.raises(TypeError):
        jx.reshape((3, -1))
    for x, shape in ((jx, (3, 4)), (tx, (3, -1))):
        r = x.reshape(shape)
        r[1] = 5.0
        r[:] = r * 2
    _same(tx, jx)
    assert tx.reshape((4, 3)).shape == jx.reshape((4, 3)).shape == (4, 3)
    with pytest.raises(MXNetError, match="cannot reshape"):
        tx.reshape((5, 2))


def test_setitem_forms():
    a = _data(11, 3, 4)
    jx, tx = _both(a)
    for x in (jx, tx):
        x[:] = 2.0
        x[1, 2] = 9.0
        x[:, 0] = np.arange(3, dtype=np.float32)
        x[2] = np.ones(4, np.float32)
    _same(tx, jx)


def test_getitem_copies_except_axis0():
    jx, tx = _both(_data(12, 3, 4))
    col = tx[:, 1]
    col[:] = 0.0                     # a copy: the source keeps its column
    _same(tx, jx)
    _same(tx[1:, 2:], jx[1:, 2:])
    _same(tx[1], jx[1])


def test_copy_T_astype_copyto_as_in_context():
    jx, tx = _both(_data(13, 2, 3))
    for t, j in ((tx.T, jx.T), (tx.copy(), jx.copy()),
                 (tx.astype("int32"), jx.astype("int32")),
                 (tx.astype(np.float16), jx.astype(np.float16))):
        _same(t, j)
    t_copy = tx.copy()
    t_copy[:] = 0.0
    assert float(np.abs(tx.asnumpy()).sum()) > 0
    jdst, tdst = jnd.zeros((2, 3)), tnd.zeros((2, 3), ctx=CPU)
    assert tx.copyto(tdst) is tdst
    jx.copyto(jdst)
    _same(tdst, jdst)
    moved = tx.copyto(tmx.cpu())
    assert moved.tensor.data_ptr() != tx.tensor.data_ptr()
    assert tx.as_in_context(tmx.cpu()) is tx
    jr, tr = _both(_data(33, 1, 3))
    for shape in ((4, 3), (4, 0)):          # 0 keeps the source's dim
        _same(tr.broadcast_to(shape), jr.broadcast_to(shape))


def test_properties():
    jx, tx = _both(_data(14, 2, 3, 4))
    assert (tx.shape, tx.size, tx.ndim, len(tx)) == \
        (jx.shape, jx.size, jx.ndim, len(jx))
    assert tx.dtype is jx.dtype is np.float32
    assert tx.context == torch.device("cpu")
    s = tnd.array([3.5], ctx=CPU)
    assert s.asscalar() == jnd.array([3.5]).asscalar() == np.float32(3.5)
    assert bool(s)
    with pytest.raises(MXNetError, match="ambiguous"):
        bool(tx)
    np.testing.assert_array_equal(np.asarray(tx), tx.asnumpy())


# ------------------------------------------------------------ creators
def test_creators_match():
    pairs = [
        (tnd.array(np.arange(6).reshape(2, 3), ctx=CPU),
         jnd.array(np.arange(6).reshape(2, 3))),     # fp32 from int data
        (tnd.array([[1, 2], [3, 4]], ctx=CPU, dtype="int32"),
         jnd.array([[1, 2], [3, 4]], dtype="int32")),
        (tnd.zeros((2, 3), ctx=CPU), jnd.zeros((2, 3))),
        (tnd.ones((4,), ctx=CPU, dtype=np.int32),
         jnd.ones((4,), dtype=np.int32)),
        (tnd.full((2, 2), 7.5, ctx=CPU), jnd.full((2, 2), 7.5)),
        (tnd.empty((3,), ctx=CPU), jnd.empty((3,))),
        (tnd.arange(5, ctx=CPU), jnd.arange(5)),
        (tnd.arange(1, 4, 0.5, repeat=2, ctx=CPU),
         jnd.arange(1, 4, 0.5, repeat=2)),
        (tnd.arange(2, 11, 3, ctx=CPU, dtype=np.int32),
         jnd.arange(2, 11, 3, dtype=np.int32)),
    ]
    for t, j in pairs:
        _same(t, j)
    a, b = _data(15, 2, 3), _data(16, 1, 3)
    _same(tnd.concatenate([tnd.array(a, ctx=CPU), tnd.array(b, ctx=CPU)]),
          jnd.concatenate([jnd.array(a), jnd.array(b)]))
    idx = np.array([0, 2, 1, 3], np.float32)
    tout, jout = tnd.zeros((4, 4), ctx=CPU), jnd.zeros((4, 4))
    tnd.onehot_encode(tnd.array(idx, ctx=CPU), tout)
    jnd.onehot_encode(jnd.array(idx), jout)
    _same(tout, jout)
    _same(tnd.one_hot(tnd.array([0, 2, -1, 5], ctx=CPU), depth=3,
                      on_value=2.0, off_value=-1.0),
          jnd.one_hot(jnd.array([0, 2, -1, 5]), depth=3, on_value=2.0,
                      off_value=-1.0))


def test_creators_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tnd.zeros((2,)), lambda: tnd.array([1.0]),
                 lambda: tnd.arange(3), lambda: tnd.NDArray(np.ones(2)),
                 lambda: tnd.load("unused.params")):
        with pytest.raises(MXNetError, match="no CUDA device"):
            make()
    tnd.waitall()          # no card: nothing to wait for


def test_ndarray_from_numpy_canonicalises_like_jax():
    for a in (np.arange(4, dtype=np.int64), np.ones(3, np.float64)):
        t, j = tnd.NDArray(a, ctx=CPU), jnd.NDArray(a)
        assert t.dtype == j.dtype
        _same(t, j)


# --------------------------------------------------- generated op fns
def test_generated_functions_and_aliases():
    registered = set(tops.list_ops())
    for op in registered:
        assert getattr(tnd, op).__name__ == op
        low = op.lower()
        # a lowercase alias never shadows a real op of that name
        assert getattr(tnd, low).__name__ == (low if low in registered
                                              else op)
    assert tnd.slice is not tnd.NDArray.slice


def test_fully_connected_imperative():
    x, w, b = _data(17, 4, 6), _data(18, 5, 6), _data(19, 5)
    got = tnd.FullyConnected(*[tnd.array(v, ctx=CPU) for v in (x, w, b)],
                             num_hidden=5)
    want = jnd.FullyConnected(*[jnd.array(v) for v in (x, w, b)],
                              num_hidden=5)
    _same(got, want, 1e-6)
    got = tnd.fullyconnected(data=tnd.array(x, ctx=CPU),
                             weight=tnd.array(w, ctx=CPU), num_hidden=5,
                             no_bias=True)
    want = jnd.FullyConnected(data=jnd.array(x), weight=jnd.array(w),
                              num_hidden=5, no_bias=True)
    _same(got, want, 1e-6)


def test_convolution_imperative(monkeypatch):
    monkeypatch.setenv("MXTPU_CONV_PRECISION", "float32")
    x, w, b = _data(20, 2, 3, 8, 8), _data(21, 4, 3, 3, 3), _data(22, 4)
    kw = dict(kernel=(3, 3), num_filter=4, pad=(1, 1), stride=(2, 2))
    got = tnd.Convolution(*[tnd.array(v, ctx=CPU) for v in (x, w, b)], **kw)
    want = jnd.Convolution(*[jnd.array(v) for v in (x, w, b)], **kw)
    _same(got, want, 1e-6)
    # string attrs, as symbol JSON carries them
    got = tnd.Convolution(*[tnd.array(v, ctx=CPU) for v in (x, w, b)],
                          kernel="(3, 3)", num_filter="4", pad="(1, 1)",
                          stride="(2, 2)")
    _same(got, want, 1e-6)


def test_batch_norm_eval_imperative_drops_aux():
    x = _data(23, 2, 3, 4, 4)
    g, be, mm, mv = _data(24, 3), _data(25, 3), _data(26, 3), _data(27, 3)
    kw = dict(use_global_stats=True, fix_gamma=False, eps=1e-3)
    got = tnd.BatchNorm(*[tnd.array(v, ctx=CPU) for v in (x, g, be, mm, mv)],
                        **kw)
    want = jnd.BatchNorm(*[jnd.array(v) for v in (x, g, be, mm, mv)], **kw)
    assert isinstance(got, tnd.NDArray)
    _same(got, want, 1e-6)


def test_out_argument_writes_in_place():
    (jx, tx), (jy, ty) = _both(_data(28, 3)), _both(_data(29, 3))
    tout, jout = tnd.zeros((3,), ctx=CPU), jnd.zeros((3,))
    assert tnd.elemwise_mul(tx, ty, out=tout) is tout
    jnd.elemwise_mul(jx, jy, out=jout)
    _same(tout, jout)


def test_arithmetic_makes_no_host_sync(monkeypatch):
    """NDArray arithmetic, views, in-place updates and layers copy
    nothing to the host: ``asnumpy`` is the only sync point."""
    (_, tx), (_, ty) = _both(_data(30, 4, 3)), _both(_data(31, 4, 3))
    tw = tnd.array(_data(32, 2, 3), ctx=CPU)
    calls = []

    def count(name):
        def f(*a, **k):
            calls.append(name)
            raise AssertionError(f"host sync through Tensor.{name}")
        return f

    for name in ("item", "cpu", "tolist", "numpy", "__bool__", "__float__",
                 "__int__"):
        monkeypatch.setattr(torch.Tensor, name, count(name))
    z = (tx + ty) * 2 - 1 / tx
    z += ty
    z[1][:] = 3.0
    z = (z > ty) + tx ** 2 + (-z)
    z.reshape((3, 4))[0] = 1.0
    out = tnd.FullyConnected(z, tw, num_hidden=2, no_bias=True)
    tnd.broadcast_add(out, tnd.ones((1, 2), ctx=CPU))
    monkeypatch.undo()
    assert calls == []
    assert out.shape == (4, 2)


# ------------------------------------------------------------ save/load
def _payloads():
    a, b, c = _data(40, 2, 3), _data(41, 4), np.arange(6, dtype=np.int32)
    return {"w": a, "l:odd": b, "ids": c}, [a, b, c]


@pytest.mark.parametrize("kind", ["dict", "list"])
def test_jax_save_port_load(tmp_path, kind):
    d, lst = _payloads()
    fname = str(tmp_path / "x.nd")
    if kind == "dict":
        jnd.save(fname, {k: jnd.array(v, dtype=v.dtype) for k, v in d.items()})
        got = tnd.load(fname, ctx=CPU)
        assert sorted(got) == sorted(d)
        pairs = [(got[k], d[k]) for k in d]
    else:
        jnd.save(fname, [jnd.array(v, dtype=v.dtype) for v in lst])
        got = tnd.load(fname, ctx=CPU)
        assert isinstance(got, list) and len(got) == 3
        pairs = list(zip(got, lst))
    for t, v in pairs:
        assert t.dtype == v.dtype.type
        np.testing.assert_array_equal(t.asnumpy(), v)


@pytest.mark.parametrize("kind", ["dict", "list", "single"])
def test_port_save_jax_load(tmp_path, kind):
    d, lst = _payloads()
    fname = str(tmp_path / "y.params")
    if kind == "dict":
        tnd.save(fname, {k: tnd.array(v, ctx=CPU, dtype=v.dtype)
                         for k, v in d.items()})
        got = jnd.load(fname)
        assert sorted(got) == sorted(d)
        pairs = [(got[k], d[k]) for k in d]
    elif kind == "list":
        tnd.save(fname, [tnd.array(v, ctx=CPU, dtype=v.dtype) for v in lst])
        got = jnd.load(fname)
        pairs = list(zip(got, lst))
    else:
        tnd.save(fname, tnd.array(lst[0], ctx=CPU))
        got = jnd.load(fname)
        pairs = [(got[0], lst[0])]
    assert not (tmp_path / "y.params.npz").exists()
    for j, v in pairs:
        np.testing.assert_array_equal(j.asnumpy(), v)
    # and the port reads its own file back to the same values
    again = tnd.load(fname, ctx=CPU)
    items = again.values() if isinstance(again, dict) else again
    assert len(list(items)) == len(pairs)


def test_reference_binary_params_load(tmp_path):
    fname = str(tmp_path / "ref-0000.params")
    arg = {"fc_weight": _data(42, 3, 2), "fc_bias": _data(43, 3)}
    aux = {"bn_moving_var": _data(44, 3)}
    jinterop.save_params(fname, arg, aux)
    got = tnd.load(fname, ctx=CPU)
    want = jnd.load(fname)
    assert sorted(got) == sorted(want) == sorted(
        ["arg:fc_weight", "arg:fc_bias", "aux:bn_moving_var"])
    for k in got:
        np.testing.assert_array_equal(got[k].asnumpy(), want[k].asnumpy())
    with open(fname, "rb") as f:
        blob = f.read()
    with pytest.raises(MXNetError, match="truncated"):
        tnd.load_frombuffer(blob[:-5], CPU)


def test_row_sparse_and_remote_uris_are_not_ported(tmp_path):
    """Row-sparse entries are ported: the JAX package's file loads as a
    port RowSparseNDArray, and the port's file of it loads back in the
    JAX package.  Remote URIs are ported too (the stores against loopback
    doubles are in ``test_torch_filesystem_remote.py``): a ``mem://``
    object round-trips, row-sparse triple included, and a missing one
    raises."""
    from mxnet_tpu.sparse import RowSparseNDArray as JRS

    from mxnet_tpu_torch.sparse import RowSparseNDArray as TRS

    rs = jsparse.row_sparse_array((np.ones((2, 3), np.float32), [0, 2]),
                                  shape=(4, 3))
    fname = str(tmp_path / "rs.nd")
    jnd.save(fname, {"emb": rs})
    got = tnd.load(fname, ctx=CPU)["emb"]
    assert isinstance(got, TRS) and got.shape == (4, 3)
    np.testing.assert_array_equal(got.indices.asnumpy(), [0, 2])
    np.testing.assert_array_equal(got.todense().asnumpy(),
                                  rs.todense().asnumpy())
    tnd.save(str(tmp_path / "rs2.nd"), {"emb": got})
    back = jnd.load(str(tmp_path / "rs2.nd"))["emb"]
    assert isinstance(back, JRS)
    np.testing.assert_array_equal(back.todense().asnumpy(),
                                  rs.todense().asnumpy())
    tnd.save("mem://nd/x.params", {"emb": got, "z": tnd.zeros((2,), ctx=CPU)})
    back = tnd.load("mem://nd/x.params", ctx=CPU)
    assert isinstance(back["emb"], TRS)
    np.testing.assert_array_equal(back["emb"].todense().asnumpy(),
                                  rs.todense().asnumpy())
    np.testing.assert_array_equal(back["z"].asnumpy(), [0, 0])
    with pytest.raises(FileNotFoundError):
        tnd.load("mem://nd/missing.params", ctx=CPU)
    local = tmp_path / "f.nd"
    tnd.save("file://" + str(local), [tnd.ones((2,), ctx=CPU)])
    np.testing.assert_array_equal(
        tnd.load("file://" + str(local), ctx=CPU)[0].asnumpy(), [1, 1])


def test_bfloat16_files_are_refused_on_both_sides(tmp_path):
    """The JAX package writes bfloat16 as untyped |V2 records that its own
    load cannot read; the port refuses to write bfloat16 and names the
    untyped entry when reading."""
    fname = str(tmp_path / "bf.nd")
    jnd.save(fname, {"w": jnd.array(np.ones(3, np.float32)).astype(
        "bfloat16")})
    with np.load(fname) as f:
        assert f["d:w"].dtype.str == "|V2"
    with pytest.raises(TypeError):
        jnd.load(fname)
    with pytest.raises(MXNetError, match="untyped"):
        tnd.load(fname, ctx=CPU)
    with pytest.raises(MXNetError, match="bfloat16"):
        tnd.save(str(tmp_path / "bf2.nd"),
                 {"w": tnd.ones((3,), ctx=CPU, dtype="bfloat16")})
    b = tnd.ones((3,), ctx=CPU, dtype="bfloat16") * 3
    assert b.dtype is torch.bfloat16
    assert b.asnumpy().dtype == np.float32
    tnd.save(str(tmp_path / "ok.nd"), {"w": b.astype("float32")})


def test_save_refuses_other_payloads(tmp_path):
    with pytest.raises(TypeError, match="NDArray, list or dict"):
        tnd.save(str(tmp_path / "z"), 3)


def test_mx_namespace():
    assert tmx.nd is tnd
    x = tmx.nd.ones((2,), ctx=tmx.cpu())
    assert x.context == tmx.cpu()
    assert tmx.rtc.Rtc and tmx.model.save_checkpoint and tmx.predict.create
    assert mx.nd.NDArray is not tnd.NDArray


# --------------------------------------------------- Reshape's attrs
@pytest.mark.parametrize("key,shape", [("target_shape", (6, 4)),
                                       ("target_shape", (0, -1)),
                                       ("shape", (4, 0, 2))])
def test_reshape_reads_target_shape_like_jax(key, shape):
    """``target_shape`` is the v0.9.4 spelling of ``shape``; both packages
    read either (0 copies the input dim, -1 infers)."""
    a = _data(7, 2, 3, 4)
    jx, tx = _both(a)
    _same(tnd.Reshape(tx, **{key: shape}), jnd.Reshape(jx, **{key: shape}))


def test_reshape_target_shape_through_load_json():
    """A graph written with ``target_shape`` (as v0.9.4 JSON carries it,
    a tuple string) loads and runs in the port as the JAX package runs
    its own JSON."""
    import json

    from mxnet_tpu import symbol as jsym
    from mxnet_tpu_torch import symbol as tsym

    a = _data(8, 2, 3, 4)
    jnet = jsym.Reshape(jsym.Variable("data"), target_shape=(6, 4),
                        name="r")
    graph = json.loads(jnet.tojson())
    graph["nodes"][1]["attrs"]["target_shape"] = "(6,4)"
    tnet = tsym.load_json(json.dumps(graph))
    assert tnet.infer_shape(data=(2, 3, 4))[1] == [(6, 4)]
    exe = tnet.simple_bind(ctx=tmx.cpu(), data=(2, 3, 4))
    exe.forward(data=tnd.array(a, ctx=CPU))
    jexe = jnet.simple_bind(ctx=mx.context.cpu(), data=(2, 3, 4))
    jexe.forward(data=jnd.array(a))
    got = exe.outputs[0].numpy()
    want = np.asarray(jexe.outputs[0].asnumpy())
    assert got.dtype == want.dtype and got.shape == want.shape == (6, 4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("code", [-2, -3, -4])
def test_reshape_refuses_later_shape_codes(code):
    """-2/-3/-4 (MXNet's later codes) fail in the reference too (jnp
    raises TypeError); the port raises MXNetError naming the code."""
    a = _data(9, 2, 3, 4)
    jx, tx = _both(a)
    with pytest.raises(TypeError):
        jnd.Reshape(jx, shape=(code, 4))
    with pytest.raises(MXNetError, match=f"shape code {code}"):
        tnd.Reshape(tx, shape=(code, 4))
    with pytest.raises(MXNetError, match=f"shape code {code}"):
        tnd.Reshape(tx, target_shape=(2, code))

"""The port's local KVStore and its bucketed update engine against the
JAX package's, on the CPU (mirrors tests/test_kvstore_fused.py:70-312):
push and pull arithmetic, several values per key summed, bucketed
against eager updates across optimizers, the bucket plan against the
JAX plan under one ``MXTPU_KV_BUCKET_MB``, a key larger than the cap,
the fallbacks, eager and bucketed steps interleaved, optimizer states
round-tripped, the length checks and the refusals.

Weights and gradients come from numpy seeds and go to both packages;
tolerances are stated where they are used.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd
from mxnet_tpu.context import Context
from mxnet_tpu.ndarray import NDArray as JNDArray

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import kvstore_fused as tkvf
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch.model import _create_kvstore

CPU = "cpu"
SHAPES = [(4, 5), (16,), (3, 2, 2), (32, 8), (7,)]


def _make_data(seed, n_dev, steps, shapes):
    rng = np.random.RandomState(seed)
    weights = [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]
    grads = [[[rng.uniform(-1, 1, s).astype(np.float32)
               for _ in range(n_dev)] for s in shapes]
             for _ in range(steps)]
    return weights, grads


def _run(pkg, kv_type, opt_name, opt_kwargs, fused, monkeypatch, n_dev=1,
         steps=4, bucket_mb=None, shapes=SHAPES):
    """Weights after ``steps`` batched push/pull rounds, and the store."""
    monkeypatch.setenv("MXTPU_FUSED_UPDATE", "1" if fused else "0")
    if bucket_mb is None:
        monkeypatch.delenv("MXTPU_KV_BUCKET_MB", raising=False)
    else:
        monkeypatch.setenv("MXTPU_KV_BUCKET_MB", str(bucket_mb))
    weights, grads = _make_data(0, n_dev, steps, shapes)
    mx = jmx if pkg == "jax" else tmx
    kv = mx.kv.create(kv_type)
    kv.set_optimizer(mx.optimizer.create(opt_name, **dict(opt_kwargs)))
    keys = list(range(len(shapes)))
    if pkg == "jax":
        kv.init(keys, [jnd.array(w) for w in weights])
        outs = [jnd.zeros(s) for s in shapes]
    else:
        kv.init(keys, [tnd.array(w, ctx=CPU) for w in weights])
        outs = [tnd.zeros(s, ctx=CPU) for s in shapes]
    for t in range(steps):
        vals = []
        for i in range(len(shapes)):
            if pkg == "jax":
                vals.append([JNDArray(grads[t][i][d], ctx=Context("cpu", d))
                             for d in range(n_dev)])
            else:
                vals.append([tnd.array(grads[t][i][d], ctx=CPU)
                             for d in range(n_dev)])
        kv.push(keys, vals)
        kv.pull(keys, outs)
    return kv, [o.asnumpy() for o in outs]


OPTIMIZERS = [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
             "rescale_grad": 1.0 / 8}),
    ("sgd", {"learning_rate": 0.05, "clip_gradient": 0.5,
             "rescale_grad": 1.0 / 8}),
    ("adam", {"learning_rate": 0.01, "rescale_grad": 1.0 / 8}),
    ("rmsprop", {"learning_rate": 0.01, "rescale_grad": 1.0 / 8,
                 "clip_weights": 0.9}),
]


@pytest.mark.parametrize("kv_type", ["local", "device"])
@pytest.mark.parametrize("opt_name,opt_kwargs", OPTIMIZERS,
                         ids=["sgd-mom-wd", "sgd-clip", "adam", "rmsprop"])
def test_bucketed_matches_eager_and_jax(kv_type, opt_name, opt_kwargs,
                                        monkeypatch):
    kvf, fused = _run("port", kv_type, opt_name, opt_kwargs, True,
                      monkeypatch)
    assert kvf._fused is not None and kvf._fused.num_buckets >= 1
    kve, eager = _run("port", kv_type, opt_name, opt_kwargs, False,
                      monkeypatch)
    assert kve._fused is None
    _, jax_eager = _run("jax", kv_type, opt_name, opt_kwargs, False,
                        monkeypatch)
    for f, e, j in zip(fused, eager, jax_eager):
        # the bucketed rule is the eager arithmetic op for op: equal
        np.testing.assert_array_equal(f, e)
        # against the JAX store: fp32 ulps over four steps
        np.testing.assert_allclose(f, j, rtol=2e-6, atol=2e-7)


@pytest.mark.parametrize("kv_type", ["local", "device"])
def test_several_values_per_key_are_summed(kv_type, monkeypatch):
    """Per-device copies (3 here) are summed, in the bucketed path by one
    flat add per copy, as by the JAX store."""
    args = (kv_type, "sgd",
            {"learning_rate": 0.1, "momentum": 0.9, "rescale_grad": 1 / 3})
    kvf, fused = _run("port", *args, True, monkeypatch, n_dev=3)
    assert kvf._fused._plan_keys is not None
    _, eager = _run("port", *args, False, monkeypatch, n_dev=3)
    _, jax = _run("jax", *args, True, monkeypatch, n_dev=3)
    for f, e, j in zip(fused, eager, jax):
        # the three copies add in the same order on both sides
        np.testing.assert_array_equal(f, e)
        np.testing.assert_allclose(f, j, rtol=2e-6, atol=2e-7)


def test_push_pull_arithmetic_matches_jax():
    """Aggregation only (no optimizer): a push replaces the value with
    the sum of its copies; pull copies it out, to lists too."""
    rs = np.random.RandomState(4)
    vals = [rs.normal(size=(2, 3)).astype(np.float32) for _ in range(3)]
    got = {}
    for pkg, mx, arr in (("jax", jmx, jnd.array),
                         ("port", tmx, lambda a: tnd.array(a, ctx=CPU))):
        kv = mx.kv.create("local")
        kv.init(3, arr(np.zeros((2, 3), np.float32)))
        kv.init([4, 5], [arr(v) for v in vals[:2]])
        kv.push(3, [arr(v) for v in vals])
        kv.push([4, 5], [arr(vals[2]), [arr(vals[0]), arr(vals[1])]])
        out = arr(np.zeros((2, 3), np.float32))
        kv.pull(3, out=out)
        outs = [arr(np.zeros((2, 3), np.float32)) for _ in range(2)]
        kv.pull([4, 5], out=outs)
        fan = [arr(np.zeros((2, 3), np.float32)) for _ in range(2)]
        kv.pull(3, out=fan)
        got[pkg] = [out.asnumpy()] + [o.asnumpy() for o in outs + fan]
    for a, b in zip(got["port"], got["jax"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["port"][0], sum(vals), rtol=1e-6)


@pytest.mark.parametrize("bucket_mb", [None, 0.0005, 0.002])
def test_bucket_plan_matches_jax(bucket_mb, monkeypatch):
    shapes = [(40, 3), (200,), (8,), (16, 16), (5,), (64, 4), (3,)]
    opt = ("sgd", {"learning_rate": 0.1, "momentum": 0.9})
    tkv, tout = _run("port", "local", *opt, True, monkeypatch, steps=2,
                     bucket_mb=bucket_mb, shapes=shapes)
    jkv, jout = _run("jax", "local", *opt, True, monkeypatch, steps=2,
                     bucket_mb=bucket_mb, shapes=shapes)
    assert tkv._fused.num_buckets == jkv._fused.num_buckets
    assert [b.keys for b in tkv._fused._buckets] == \
        [list(b.keys) for b in jkv._fused._buckets]
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a, b, rtol=2e-6, atol=2e-7)


def test_a_key_larger_than_the_cap_gets_its_own_bucket(monkeypatch):
    shapes = [(8, 8)] * 3 + [(100000,)] + [(4,)] * 3  # 400 KB, 100 KB cap
    args = ("local", "adam", {"learning_rate": 0.01, "rescale_grad": 0.1})
    kvf, fused = _run("port", *args, True, monkeypatch, bucket_mb=0.1,
                      shapes=shapes)
    assert kvf._fused.num_buckets >= 3
    big = [b for b in kvf._fused._buckets if 3 in b.keys]
    assert len(big) == 1 and big[0].keys == [3]
    _, eager = _run("port", *args, False, monkeypatch, bucket_mb=0.1,
                    shapes=shapes)
    _, jax = _run("jax", *args, True, monkeypatch, bucket_mb=0.1,
                  shapes=shapes)
    for f, e, j in zip(fused, eager, jax):
        np.testing.assert_array_equal(f, e)
        np.testing.assert_allclose(f, j, rtol=2e-6, atol=2e-7)


def test_bucket_launches_do_not_grow_with_keys(monkeypatch):
    """The bucket step's foreach calls are the same for 4 and for 8 keys
    in one bucket."""
    calls = []
    names = [n for n in dir(torch) if n.startswith("_foreach_")]
    originals = {n: getattr(torch, n) for n in names}

    def counted(name):
        def f(*a, **k):
            calls.append(name)
            return originals[name](*a, **k)
        return f

    def count(nkeys):
        kv = tmx.kv.create("local")
        kv.set_optimizer(tmx.optimizer.create("sgd", learning_rate=0.1,
                                              momentum=0.9, wd=1e-3))
        keys = list(range(nkeys))
        kv.init(keys, [tnd.ones((4, 4), ctx=CPU) for _ in keys])
        g = [[tnd.ones((4, 4), ctx=CPU)] for _ in keys]
        kv.push(keys, g)
        calls.clear()
        with monkeypatch.context() as mp:
            for n in names:
                mp.setattr(torch, n, counted(n))
            kv.push(keys, g)
            kv.pull(keys, [tnd.zeros((4, 4), ctx=CPU) for _ in keys])
        assert kv._fused.num_buckets == 1
        return list(calls)

    monkeypatch.setenv("MXTPU_FUSED_UPDATE", "1")
    four, eight = count(4), count(8)
    assert four == eight and len(four) >= 5


def test_fallbacks(monkeypatch):
    monkeypatch.setenv("MXTPU_FUSED_UPDATE", "1")
    for name, kw in (("nag", {"momentum": 0.9}),
                     ("rmsprop", {"centered": True}), ("adagrad", {})):
        kv = tmx.kv.create("local")
        kv.set_optimizer(tmx.optimizer.create(name, **kw))
        assert kv._fused is None, name
    kv = tmx.kv.create("local")
    kv.set_optimizer(tmx.optimizer.create("sgd"))
    assert kv._fused is not None
    kv._set_updater(lambda k, g, w: None)
    assert kv._fused is None
    monkeypatch.setenv("MXTPU_FUSED_UPDATE", "0")
    kv = tmx.kv.create("local")
    kv.set_optimizer(tmx.optimizer.create("sgd"))
    assert kv._fused is None


def test_custom_updater_and_unregistered_keys_run_eagerly(monkeypatch):
    monkeypatch.setenv("MXTPU_FUSED_UPDATE", "1")
    seen = []
    kv = tmx.kv.create("local")
    kv.init([0, 1], [tnd.ones((2,), ctx=CPU)] * 2)
    kv._set_updater(lambda k, g, w: seen.append((k, float(g.asnumpy()[0]))))
    kv.push([0, 1], [[tnd.ones((2,), ctx=CPU)] * 2] * 2)
    assert seen == [(0, 2.0), (1, 2.0)]
    kv = tmx.kv.create("local")
    kv.set_optimizer(tmx.optimizer.create("sgd", learning_rate=1.0))
    kv.init(0, tnd.ones((2,), ctx=CPU))
    assert not kv._fused.handle_push([0, 9], [tnd.ones((2,), ctx=CPU)] * 2)
    with pytest.raises(MXNetError, match="never"):
        kv.push([0, 9], [tnd.ones((2,), ctx=CPU)] * 2)


def test_eager_and_bucketed_steps_interleave(monkeypatch):
    """Single-key (eager) pushes and batched (bucketed) pushes share the
    Updater's state: the sequence equals an all-eager run and JAX's."""
    def run(pkg, fused_mid):
        monkeypatch.setenv("MXTPU_FUSED_UPDATE", "1" if fused_mid else "0")
        mx = jmx if pkg == "jax" else tmx
        arr = (jnd.array if pkg == "jax"
               else (lambda a: tnd.array(a, ctx=CPU)))
        kv = mx.kv.create("local")
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1,
                                             momentum=0.9))
        keys = [0, 1]
        kv.init(keys, [arr(np.ones(4, np.float32)) for _ in keys])
        outs = [arr(np.zeros(4, np.float32)) for _ in keys]
        g = np.arange(4, dtype=np.float32)
        for k in keys:
            kv.push(k, [arr(g)])
        kv.push(keys, [[arr(g)] for _ in keys])
        kv.push(keys[0], arr(g))
        kv.pull(keys, outs)
        return [o.asnumpy() for o in outs]

    mixed, eager, jax = run("port", True), run("port", False), \
        run("jax", True)
    for m, e, j in zip(mixed, eager, jax):
        np.testing.assert_array_equal(m, e)
        np.testing.assert_allclose(m, j, rtol=2e-6, atol=2e-7)


def test_optimizer_states_round_trip(tmp_path, monkeypatch):
    """save/load_optimizer_states mid-run under the bucketed update; the
    file also loads into the JAX store."""
    monkeypatch.setenv("MXTPU_FUSED_UPDATE", "1")
    fname = str(tmp_path / "kv.states")
    keys = [0, 1]

    def fresh(mx, arr):
        kv = mx.kv.create("local")
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1,
                                             momentum=0.9))
        kv.init(keys, [arr(np.ones(4, np.float32)) for _ in keys])
        return kv

    tarr = lambda a: tnd.array(a, ctx=CPU)  # noqa: E731
    g = [[tarr(np.full(4, 0.5, np.float32))] for _ in keys]
    kv = fresh(tmx, tarr)
    kv.push(keys, g)
    kv.save_optimizer_states(fname)
    kv.push(keys, g)
    expect = [kv._store[k].asnumpy() for k in keys]
    kv2 = fresh(tmx, tarr)
    kv2.push(keys, g)
    kv2.load_optimizer_states(fname)
    kv2.push(keys, g)
    for k, e in zip(keys, expect):
        np.testing.assert_array_equal(kv2._store[k].asnumpy(), e)
    jkv = fresh(jmx, jnd.array)
    jg = [[jnd.array(np.full(4, 0.5, np.float32))] for _ in keys]
    jkv.push(keys, jg)
    jkv.load_optimizer_states(fname)
    jkv.push(keys, jg)
    for k, e in zip(keys, expect):
        np.testing.assert_allclose(jkv._store[k].asnumpy(), e, rtol=1e-6)


def test_length_mismatches_raise():
    kv = tmx.kv.create("local")
    with pytest.raises(MXNetError, match="3 keys but 1"):
        kv.init([3, 4, 5], [tnd.ones((2,), ctx=CPU)])
    kv.init([0, 1], [tnd.ones((2,), ctx=CPU), tnd.ones((2,), ctx=CPU)])
    with pytest.raises(MXNetError, match="2 keys but 1"):
        kv.push([0, 1], [tnd.ones((2,), ctx=CPU)])
    with pytest.raises(MXNetError, match="2 keys but 1"):
        kv.pull([0, 1], out=[tnd.zeros((2,), ctx=CPU)])
    with pytest.raises(MXNetError, match="2 keys but None"):
        kv.pull([0, 1], out=None)
    with pytest.raises(MXNetError, match="duplicate"):
        kv.init(0, tnd.ones((2,), ctx=CPU))


def test_store_surface_and_refusals(monkeypatch):
    kv = tmx.kv.create("device")
    assert (kv.type, kv.rank, kv.num_workers) == ("device", 0, 1)
    kv.barrier()
    with pytest.raises(MXNetError, match="no updater"):
        kv.save_optimizer_states("x")
    monkeypatch.delenv("MXTPU_PS_SERVERS", raising=False)
    monkeypatch.delenv("DMLC_NUM_WORKER", raising=False)
    monkeypatch.delenv("MXTPU_COORDINATOR", raising=False)
    for name in ("dist_sync", "dist_async", "dist_device_sync"):
        # one process without servers: the collective store at world 1
        # (dist_async keeps the local semantics, not collective)
        monkeypatch.delenv("MXTPU_NUM_WORKERS", raising=False)
        dkv = tmx.kv.create(name)
        assert (dkv.type, dkv.rank, dkv.num_workers) == (name, 0, 1)
        assert dkv.collective == ("async" not in name)
        assert dkv.get_num_dead_node(0) == 0
        # several workers without servers and without the launcher's
        # rendezvous: the sync stores name the launch command
        monkeypatch.setenv("MXTPU_NUM_WORKERS", "2")
        if "async" in name:
            assert tmx.kv.create(name).num_workers == 1
        else:
            with pytest.raises(MXNetError, match="launch -n 2 -s 0"):
                tmx.kv.create(name)
    with pytest.raises(MXNetError, match="unknown kvstore"):
        tmx.kv.create("nosuch")
    # row_sparse_pull is ported: a key that is not row-sparse refuses it
    kv.init(0, tmx.nd.zeros((3, 2), ctx=CPU))
    with pytest.raises(MXNetError, match="not 'row_sparse'"):
        kv.row_sparse_pull(0, row_ids=[0])


def test_knobs(monkeypatch):
    monkeypatch.setenv("MXTPU_KV_BUCKET_MB", "0.5")
    assert tkvf.bucket_cap_bytes() == 1 << 19
    monkeypatch.setenv("MXTPU_KV_BUCKET_MB", "junk")
    assert tkvf.bucket_cap_bytes() == 4 << 20
    monkeypatch.setenv("MXTPU_FUSED_UPDATE", "0")
    assert not tkvf.fused_update_enabled()
    # AMP loss scaling is ported: the engine takes the knob
    monkeypatch.setenv("MXTPU_LOSS_SCALE", "dynamic")
    assert tkvf.FusedUpdateEngine(None, None, None).num_buckets == 0
    monkeypatch.delenv("MXTPU_LOSS_SCALE")
    # the numerics sentinel is ported too: the engine takes the knob
    monkeypatch.setenv("MXTPU_SENTINEL", "1")
    assert tkvf.FusedUpdateEngine(None, None, None).num_buckets == 0


@pytest.mark.parametrize("kvstore,ndev,big,want", [
    (None, 1, False, (False, False)),
    ("local", 1, False, (False, False)),
    ("device", 1, False, (False, False)),
    ("instance", 1, False, (True, True)),
    ("local", 2, False, (True, True)),
    ("local", 2, True, (True, False)),
    ("device", 2, True, (True, True)),
])
def test_create_kvstore_decides_as_jax(kvstore, ndev, big, want):
    from mxnet_tpu.model import _create_kvstore as jcreate

    n = 1024 * 1024 * 16 + (1 if big else -1)
    shape = (n,)

    class P:
        def __init__(self):
            self.shape = shape

    for mx, fn in ((tmx, _create_kvstore), (jmx, jcreate)):
        arg = mx.kv.create("local") if kvstore == "instance" else kvstore
        kv, on_kv = fn(arg, ndev, {"w": P()})
        assert (kv is not None, on_kv) == want

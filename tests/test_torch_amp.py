"""The port's mixed precision against the JAX package's, on the CPU
(``tests/test_amp.py`` mirrored, less its sharded and row-sparse cases):

- ``MXTPU_AMP`` unset: ``amp_cast`` returns the same symbol object and
  two runs agree to the bit;
- the bf16 policy's Cast structure (the same graph as JAX's) and its
  telemetry counter; an unknown policy raises;
- resnet-8 through ``Module`` under AMP tracks fp32 (the reference's own
  tolerance, rtol 0.1 / atol 0.08) and the JAX Module under AMP;
- fp32 master weights, eager and bucketed, against fp32 arithmetic and
  the JAX package's masters; the warn-once for a bf16 weight without
  one;
- dynamic loss scaling: the scale lattice step for step against the JAX
  ``LossScaler`` on a scripted flag sequence; overflow -> skip-step ->
  halve -> recovery through the bucketed update, the overflowed
  bucket's weights, states and masters held to the bit; no host read
  over 5 Module steps; the eager ``Updater`` unscales;
- the passes inside ``FusedTrainer``: under AMP both packages' trainers
  run the ``amp_cast`` graph (a ``Cast`` before ``SoftmaxOutput``).

Parameters go across as numpy arrays; inputs come from numpy seeds.
Tolerances are stated where they are used.
"""
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import amp as jamp
from mxnet_tpu import models as jmodels
from mxnet_tpu import nd as jnd
from mxnet_tpu import symbol as jsym
from mxnet_tpu.trainer import FusedTrainer as JTrainer

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch import passes as tpasses
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch import telemetry as ttm
from mxnet_tpu_torch.passes.amp_cast import amp_cast
from mxnet_tpu_torch.trainer import FusedTrainer as TTrainer

CPU = "cpu"
BF16 = torch.bfloat16
ENV = ("MXTPU_AMP", "MXTPU_LOSS_SCALE", "MXTPU_LOSS_SCALE_WINDOW")


@pytest.fixture(autouse=True)
def _amp_isolation(monkeypatch):
    """Every test starts AMP-off with fresh scalers in both packages."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    tamp.reset_scaler()
    jamp.reset_scaler()
    yield
    tamp.reset_scaler()
    jamp.reset_scaler()


def _resnet8(classes=4, shape=(3, 8, 8)):
    return jmodels.get_symbol("resnet-8", num_classes=classes,
                              image_shape=shape)


def _blobs(seed=0, n=8, classes=4):
    """tests/test_amp.py's separable blobs: per-class channel means plus
    noise."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, classes, n)
    means = rng.uniform(-1, 1, (classes, 3))
    data = (means[labels][:, :, None, None]
            + rng.uniform(-0.2, 0.2, (n, 3, 8, 8))).astype(np.float32)
    return data, labels.astype(np.float32)


# ------------------------------------------------------------- the policy
def test_amp_off_is_bit_identical(monkeypatch):
    """AMP unset (or 0): amp_cast is the identity — the same object —
    and two training runs of the bound graph agree to the bit."""
    net = tsym.load_json(_resnet8().tojson())
    assert amp_cast(net) is net
    monkeypatch.setenv("MXTPU_AMP", "0")
    assert amp_cast(net) is net

    def run():
        ex = net.simple_bind(CPU, grad_req="write", data=(4, 3, 8, 8),
                             softmax_label=(4,))
        rng = np.random.RandomState(7)
        for k in sorted(ex.arg_dict):
            v = ex.arg_dict[k]
            v.copy_(torch.from_numpy(
                rng.randint(0, 4, v.shape) if k == "softmax_label"
                else rng.uniform(-0.3, 0.3, v.shape)).float())
        ex.forward(is_train=True)
        ex.backward()
        return ([o.clone() for o in ex.outputs],
                {k: g.clone() for k, g in ex.grad_dict.items()})

    a, b = run(), run()
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k


def _policy_net(s):
    d = s.Variable("data")
    c = s.Convolution(d, num_filter=8, kernel=(3, 3), name="ac_c")
    b = s.BatchNorm(c, fix_gamma=False, name="ac_b")
    f = s.FullyConnected(s.Flatten(b, name="ac_fl"), num_hidden=4,
                         name="ac_f")
    return s.SoftmaxOutput(f, label=s.Variable("softmax_label"),
                           name="softmax")


def test_amp_cast_policy_structure(monkeypatch):
    """bf16 policy: the tensor-core ops' inputs cast to bf16, the loss
    input cast back to fp32, the label untouched, the cast count in the
    telemetry counter; the same graph as the JAX pass's."""
    from mxnet_tpu import passes as jpasses

    monkeypatch.setenv("MXTPU_AMP", "bf16")
    monkeypatch.setenv("MXTPU_GRAPH_PASSES", "amp_cast")
    jnet = _policy_net(jsym)
    was = ttm.enabled()
    ttm.enable()
    try:
        fam = ttm.get_registry().get("amp_cast_nodes_total")
        before = fam.total()
        out = tpasses.apply_graph_passes(tsym.load_json(jnet.tojson()))
        casts = [n for n in out.nodes if n.op == "Cast"]
        assert fam.total() == before + len(casts)
    finally:
        ttm.enable(was)
    assert {str(n.attrs["dtype"]) for n in casts} == {"bfloat16", "float32"}
    # conv data + weight + bias and fc data + weight + bias
    assert sum(str(n.attrs["dtype"]) == "bfloat16" for n in casts) == 6
    soft = [n for n in out.nodes if n.op == "SoftmaxOutput"][0]
    src = soft.inputs[0][0]
    assert src.op == "Cast" and str(src.attrs["dtype"]) == "float32"
    assert soft.inputs[1][0].is_variable
    assert out.tojson() == jpasses.apply_graph_passes(jnet).tojson()


def test_amp_unknown_policy_raises(monkeypatch):
    monkeypatch.setenv("MXTPU_AMP", "fp8")
    with pytest.raises(MXNetError, match="unknown AMP policy"):
        tamp.amp_dtype()
    with pytest.raises(MXNetError):
        tpasses.apply_graph_passes(tsym.load_json(_resnet8().tojson()))
    monkeypatch.setenv("MXTPU_AMP", "bf16")
    monkeypatch.setenv("MXTPU_LOSS_SCALE", "-2")
    with pytest.raises(MXNetError, match="must be > 0"):
        tamp.loss_scale_config()
    monkeypatch.setenv("MXTPU_LOSS_SCALE", "lots")
    with pytest.raises(MXNetError, match="expected a number"):
        tamp.loss_scale_config()
    monkeypatch.setenv("MXTPU_LOSS_SCALE", "dynamic")
    assert tamp.loss_scale_config() == jamp.loss_scale_config() == (
        2.0 ** 15, 2000)
    assert tamp.scaling_active()


# ------------------------------------------ convergence through Module
def _train(mx, net, data, labels, arg, aux, steps, kvstore="local"):
    """``steps`` Module steps on one batch from the given parameters;
    the cross-entropy of each step's output."""
    ctx = mx.cpu()
    mod = mx.mod.Module(net, context=ctx)
    mod.bind(data_shapes=[("data", data.shape)],
             label_shapes=[("softmax_label", labels.shape)])
    mod.init_params(arg_params=arg, aux_params=aux)
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params={"learning_rate": 0.05})
    if mx is jmx:
        batch = mx.io.DataBatch(data=[jnd.array(data)],
                                label=[jnd.array(labels)])
    else:
        batch = mx.io.DataBatch(data=[tnd.array(data, ctx=CPU)],
                                label=[tnd.array(labels, ctx=CPU)])
    losses = []
    for _ in range(steps):
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        p = np.asarray(mod.get_outputs()[0].asnumpy(), np.float64)
        losses.append(float(np.mean(-np.log(np.maximum(
            p[np.arange(len(labels)), labels.astype(int)], 1e-8)))))
    return losses, mod


def _start(jnet, data_shape, nlabel):
    jmx.random.seed(0)
    probe = jmx.mod.Module(jnet, context=jmx.cpu())
    probe.bind(data_shapes=[("data", data_shape)],
               label_shapes=[("softmax_label", (nlabel,))])
    probe.init_params(initializer=jmx.init.Xavier(factor_type="in",
                                                  magnitude=2.0))
    arg, aux = probe.get_params()
    return ({k: v.asnumpy() for k, v in arg.items()},
            {k: v.asnumpy() for k, v in aux.items()})


def test_amp_vs_fp32_convergence_resnet(monkeypatch):
    """resnet-8 through the port's Module: the bf16 AMP run learns and
    tracks the fp32 run at the reference's tolerance (rtol 0.1, atol
    0.08), and tracks the JAX Module's AMP run from the same weights at
    the same tolerance."""
    data, labels = _blobs()
    jnet = _resnet8()
    tnet = tsym.load_json(jnet.tojson())
    arg, aux = _start(jnet, data.shape, len(labels))
    ref, _ = _train(tmx, tnet, data, labels, arg, aux, 6)
    monkeypatch.setenv("MXTPU_AMP", "bf16")
    got, mod = _train(tmx, tnet, data, labels, arg, aux, 6)
    assert got[-1] < got[0], got
    np.testing.assert_allclose(got, ref, rtol=0.1, atol=0.08)
    ex = mod._exec_group.execs[0]
    assert sum(n.op == "Cast" for n in ex._exec_symbol.nodes) > 0
    jgot, _ = _train(jmx, jnet, data, labels,
                     {k: jnd.array(v) for k, v in arg.items()},
                     {k: jnd.array(v) for k, v in aux.items()}, 6)
    np.testing.assert_allclose(got, jgot, rtol=0.1, atol=0.08)


# ------------------------------------------------------ fp32 masters
def _sgd_ref(w0, g, steps, lr=0.1, mom=0.9):
    ref, m = w0.copy(), np.zeros_like(w0)
    for _ in range(steps):
        m = mom * m - lr * g
        ref = ref + m
    return ref


def _bf16_np(a):
    return torch.from_numpy(a).to(BF16).float().numpy()


def test_multi_precision_eager_masters_match_fp32():
    """A bf16 weight updated eagerly with multi_precision=True: the fp32
    master follows fp32 SGD arithmetic (1e-6) and equals the JAX
    package's master (1e-6); the bf16 weight is within bf16 rounding of
    it (rtol 1e-2, atol 4e-3, the reference's bounds)."""
    rng = np.random.RandomState(0)
    w0 = rng.uniform(-1, 1, (16, 4)).astype(np.float32)
    g = rng.uniform(-0.1, 0.1, (16, 4)).astype(np.float32)
    masters = {}
    for pkg, mx, arr in (
            ("port", tmx, lambda a: tnd.array(a, ctx=CPU, dtype="bfloat16")),
            ("jax", jmx, lambda a: jnd.array(a).astype(jnp.bfloat16))):
        opt = mx.optimizer.create("sgd", learning_rate=0.1, momentum=0.9,
                                  multi_precision=True)
        upd = mx.optimizer.get_updater(opt)
        w = arr(w0)
        for _ in range(4):
            upd(0, arr(g), w)
        state = upd.states[0]
        assert isinstance(state, tuple) and len(state) == 2
        assert np.dtype(state[-1].asnumpy().dtype) == np.float32
        masters[pkg] = (state[-1].asnumpy(),
                        np.asarray(w.asnumpy(), np.float32))
    ref = _sgd_ref(_bf16_np(w0), _bf16_np(g), 4)
    master, w = masters["port"]
    np.testing.assert_allclose(master, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(master, masters["jax"][0], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(w, ref, rtol=1e-2, atol=4e-3)


def test_fused_bucket_masters_match_fp32(monkeypatch):
    """bf16 values through the bucketed update under MXTPU_AMP: fp32
    masters as the last state slot follow fp32 SGD (1e-5) and equal the
    JAX store's (1e-6); the pulled bf16 weights are their casts."""
    monkeypatch.setenv("MXTPU_AMP", "bf16")
    rng = np.random.RandomState(0)
    shapes = [(8, 4), (6,)]
    ws = [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]
    gs = [rng.uniform(-0.1, 0.1, s).astype(np.float32) for s in shapes]
    got = {}
    for pkg, mx, arr, cast in (
            ("port", tmx, lambda a: tnd.array(a, ctx=CPU),
             lambda a: a.astype("bfloat16")),
            ("jax", jmx, jnd.array, lambda a: a.astype(jnp.bfloat16))):
        kv = mx.kv.create("local")
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1,
                                             momentum=0.9))
        kv.init([0, 1], [cast(arr(w)) for w in ws])
        for _ in range(5):
            kv.push([0, 1], [[arr(g)] for g in gs])
        outs = [cast(arr(np.zeros(s, np.float32))) for s in shapes]
        kv.pull([0, 1], outs)
        got[pkg] = ([np.asarray(o.asnumpy(), np.float32) for o in outs],
                    [kv._updater.states[i][-1].asnumpy() for i in (0, 1)])
    for i in range(2):
        ref = _sgd_ref(_bf16_np(ws[i]), gs[i], 5)
        master = got["port"][1][i]
        assert master.dtype == np.float32
        np.testing.assert_allclose(master, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(master, got["jax"][1][i], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(got["port"][0][i], _bf16_np(master))


def test_warn_once_without_masters():
    """bf16 weights updating without masters warn exactly once per key."""
    opt = tmx.optimizer.create("sgd", learning_rate=0.1)
    upd = tmx.optimizer.get_updater(opt)
    w = tnd.zeros((4, 4), ctx=CPU, dtype="bfloat16")
    g = tnd.zeros((4, 4), ctx=CPU, dtype="bfloat16")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        upd(0, g, w)
        upd(0, g, w)
        upd(1, g, w)
    msgs = [w_ for w_ in rec if "master" in str(w_.message)]
    assert len(msgs) == 2   # keys 0 and 1, once each


# ------------------------------------------------ dynamic loss scaling
def _flags(seed, n, p_bad):
    return list(np.random.RandomState(seed).uniform(size=n) >= p_bad)


@pytest.mark.parametrize("window,init", [(1, 2.0 ** 23), (3, 4.0),
                                         (2000, 2.0 ** 15)])
def test_scale_lattice_follows_jax_step_for_step(window, init):
    """A scripted sequence of per-step flag lists (1 to 3 buckets, some
    overflowing) through both packages' LossScaler: every report equal,
    the scale clamped at 2^24 and 1 on the way."""
    import jax

    tsc = tamp.LossScaler(init_scale=init, window=window)
    jsc = jamp.LossScaler(init_scale=init, window=window)
    rs = np.random.RandomState(window)
    for step in range(40):
        flags = _flags(step, int(rs.randint(1, 4)), 0.25 if step < 20
                       else 0.6)
        tsc.end_step([torch.tensor(f) for f in flags])
        jsc.end_step([jax.numpy.asarray(f) for f in flags])
        assert tsc.report() == jsc.report(), step
    assert tsc._sync_count == 40
    # only the lattice reads nothing back
    before = tsc._sync_count
    tsc.end_step([torch.tensor(True)])
    tsc.end_step([])
    assert tsc._sync_count == before


def _scaled_push(kv, keys, gs, inf_key=None):
    s = tamp.global_scaler().report()["scale"]
    vals = [[tnd.array(np.full(g.shape, np.inf, np.float32)
                       if i == inf_key else g * s, ctx=CPU)]
            for i, g in enumerate(gs)]
    kv.push(keys, vals)


def _held(kv, key):
    """Copies of the stored weight and every state slot of ``key``."""
    st = kv._updater.states[key]
    st = st if isinstance(st, tuple) else (st,)
    return [kv._store[key].tensor.clone()] + [s.tensor.clone() for s in st]


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_loss_scale_overflow_skip_recovery(monkeypatch, momentum):
    """The bucketed update's lattice: grow after the window (1024 ->
    2048), skip and halve on an overflow (-> 1024; one overflow, one
    skip), recover (-> 2048); the overflowed bucket's bf16 weights,
    momentum and fp32 masters held to the bit; the scale sequence equal
    to the JAX store's on the same pushes."""
    monkeypatch.setenv("MXTPU_AMP", "bf16")
    monkeypatch.setenv("MXTPU_LOSS_SCALE", "1024")
    monkeypatch.setenv("MXTPU_LOSS_SCALE_WINDOW", "2")
    monkeypatch.setenv("MXTPU_KV_BUCKET_MB", "0.0001")  # one key a bucket
    rng = np.random.RandomState(0)
    shapes = [(8, 4), (6,)]
    ws = [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]
    gs = [rng.uniform(-0.1, 0.1, s).astype(np.float32) for s in shapes]
    kv = tmx.kv.create("local")
    kv.set_optimizer(tmx.optimizer.create("sgd", learning_rate=0.1,
                                          momentum=momentum))
    keys = [0, 1]
    kv.init(keys, [tnd.array(w, ctx=CPU).astype("bfloat16") for w in ws])
    scales = []
    for _ in range(2):
        _scaled_push(kv, keys, gs)
    rep = tamp.global_scaler().report()
    scales.append(rep["scale"])
    assert rep["scale"] == 2048.0 and rep["overflow_total"] == 0
    assert kv._fused.num_buckets == 2
    snap = [_held(kv, k) for k in keys]
    assert len(snap[0]) == (3 if momentum else 2)   # weight, mom, master
    _scaled_push(kv, keys, gs, inf_key=0)
    rep = tamp.global_scaler().report()
    scales.append(rep["scale"])
    assert rep["scale"] == 1024.0
    assert rep["overflow_total"] == 1 and rep["skipped_steps_total"] == 1
    for a, b in zip(snap[0], _held(kv, 0)):
        assert torch.equal(a, b)          # the overflowed bucket held
    assert not torch.equal(snap[1][0], _held(kv, 1)[0])  # the other moved
    for _ in range(2):
        _scaled_push(kv, keys, gs)
    rep = tamp.global_scaler().report()
    scales.append(rep["scale"])
    assert rep["scale"] == 2048.0
    assert not torch.equal(snap[0][-1], _held(kv, 0)[-1])
    # the JAX store on the same pushes gives the same scales
    jkv = jmx.kv.create("local")
    jkv.set_optimizer(jmx.optimizer.create("sgd", learning_rate=0.1,
                                           momentum=momentum))
    jkv.init(keys, [jnd.array(w).astype(jnp.bfloat16) for w in ws])
    jscales = []
    for inf_key, n in ((None, 2), (0, 1), (None, 2)):
        for _ in range(n):
            s = jamp.global_scaler().report()["scale"]
            jkv.push(keys, [[jnd.array(np.full(g.shape, np.inf, np.float32)
                                       if i == inf_key else g * s)]
                            for i, g in enumerate(gs)])
        jscales.append(jamp.global_scaler().report()["scale"])
    assert scales == jscales == [2048.0, 1024.0, 2048.0]


def test_zero_host_sync_over_module_steps_with_amp(monkeypatch):
    """5 Module steps with AMP and dynamic loss scaling through the
    bucketed update read nothing of the scaler back (``_sync_count``
    unchanged); the lattice counted 5 clean steps on the device."""
    monkeypatch.setenv("MXTPU_AMP", "bf16")
    monkeypatch.setenv("MXTPU_LOSS_SCALE", "dynamic")
    data, labels = _blobs(1)
    jnet = _resnet8()
    arg, aux = _start(jnet, data.shape, len(labels))
    scaler = tamp.global_scaler()
    base = scaler._sync_count
    _, mod = _train(tmx, tsym.load_json(jnet.tojson()), data, labels, arg,
                    aux, 5, kvstore=tmx.kv.create("local"))
    assert mod._kvstore._fused.num_buckets >= 1
    assert scaler._sync_count == base
    rep = scaler.report()
    assert scaler._sync_count == base + 1
    assert rep["overflow_total"] == 0 and rep["good_steps"] == 5
    assert rep["scale"] == 2.0 ** 15


def test_scaled_backward_then_unscaled_update_is_the_fp32_step(monkeypatch):
    """The executor multiplies each gradient by the scale after the
    backward (a power of two, so exactly), and both update routes divide
    it back out: one Module step under loss scaling equals the step
    without it, to the bit, on each route."""
    monkeypatch.setenv("MXTPU_AMP", "bf16")
    data, labels = _blobs(2)
    jnet = _resnet8()
    arg, aux = _start(jnet, data.shape, len(labels))
    tnet = tsym.load_json(jnet.tojson())
    for kvstore in ("local", "instance"):
        params = []
        for scale in (None, "1024"):
            if scale:
                monkeypatch.setenv("MXTPU_LOSS_SCALE", scale)
            else:
                monkeypatch.delenv("MXTPU_LOSS_SCALE", raising=False)
            tamp.reset_scaler()
            kv = tmx.kv.create("local") if kvstore == "instance" \
                else kvstore
            _, mod = _train(tmx, tnet, data, labels, arg, aux, 1,
                            kvstore=kv)
            params.append(mod.get_params()[0])
        for k, v in params[0].items():
            assert torch.equal(v.tensor, params[1][k].tensor), (kvstore, k)


def test_eager_fallback_unscales(monkeypatch):
    """The eager Updater sees unscaled gradients: the "test" optimizer
    adds the gradient, and a gradient of 512 under a scale of 512 adds
    1; the caller's gradient is not written."""
    monkeypatch.setenv("MXTPU_AMP", "bf16")
    monkeypatch.setenv("MXTPU_LOSS_SCALE", "512")
    upd = tmx.optimizer.get_updater(tmx.optimizer.create("test"))
    w = tnd.zeros((4,), ctx=CPU)
    g = tnd.array(np.full(4, 512.0, np.float32), ctx=CPU)
    upd(0, g, w)
    np.testing.assert_array_equal(w.asnumpy(), np.ones(4, np.float32))
    np.testing.assert_array_equal(g.asnumpy(), np.full(4, 512.0))


# -------------------------------------------- the passes in FusedTrainer
def test_fused_trainer_runs_the_amp_graph_as_jax(monkeypatch):
    """MXTPU_AMP=bf16: the port's FusedTrainer executes the pass
    pipeline's graph, as the JAX trainer does — the same post-pass JSON,
    a Cast to fp32 before SoftmaxOutput, the user's symbol unchanged —
    and 3 bf16 SGD steps from the same weights give the JAX trainer's
    probabilities within bf16 rounding (max |diff| 0.03)."""
    monkeypatch.setenv("MXTPU_AMP", "bf16")
    shape, b = (3, 8, 8), 8
    jnet = _resnet8(shape=shape)
    opt = {"lr": 0.05, "momentum": 0.9, "rescale_grad": 1.0 / b}
    jmx.random.seed(0)
    jt = JTrainer(jnet, optimizer="sgd", optimizer_params=dict(opt))
    jt.init(data=(b,) + shape)
    tnet = tsym.load_json(jnet.tojson())
    tt = TTrainer(tnet, optimizer="sgd", optimizer_params=dict(opt),
                  device=CPU)
    tt.init(data=(b,) + shape)
    assert tt.dtype == BF16 and tt.symbol is tnet
    assert tt._exec_symbol.tojson() == jt._exec_symbol.tojson()
    for tr in (tt, jt):
        soft = [n for n in tr._exec_symbol.nodes
                if n.op == "SoftmaxOutput"][0]
        src = soft.inputs[0][0]
        assert src.op == "Cast" and str(src.attrs["dtype"]) == "float32"
    arg, aux = jt.get_params()
    convert.load_trainer_params(tt, {k: v.asnumpy() for k, v in arg.items()},
                                {k: v.asnumpy() for k, v in aux.items()})
    data, labels = _blobs(3, n=b)
    for _ in range(3):
        jo = np.asarray(jt.step(data=data, softmax_label=labels)[0],
                        np.float32)
        to = tt.step(data=data, softmax_label=labels)[0]
        assert to.dtype == torch.float32    # the Cast before the loss
        assert np.abs(to.numpy() - jo).max() <= 0.03

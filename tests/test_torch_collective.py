"""The collective ``dist_sync``'s pieces in one process against the JAX
package, on the CPU: the sharded update's rule on a rank's slice, the
three telemetry
families, the collective store and the ``Module`` over it at world 1,
contexts that name one device, ``group2ctx`` placement and the
model-parallel LSTM's graph, and the launcher's race-free rendezvous.

Inputs are numpy-seeded; tolerances are stated where they are used.
The multi-rank cases are in ``tests/test_torch_collective_world.py``.
"""
import importlib.util
import json
import os
import socket
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import base as jbase
from mxnet_tpu import optim_rules as jrules
from mxnet_tpu import telemetry as jtm
from mxnet_tpu.test_utils import get_synthetic_mnist

import chip_smoke as cs
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import base as tbase
from mxnet_tpu_torch import executor as texec
from mxnet_tpu_torch import launch as tlaunch
from mxnet_tpu_torch import optim_rules as trules
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch import telemetry as ttm
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.kvstore_fused import (_Bucket, _slice_update,
                                           shard_update_enabled)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"

RULE_CASES = {
    "sgd_mom": ("sgd", {"momentum": 0.9, "wd": 1e-3, "rescale_grad": 0.5,
                        "clip_gradient": 0.8}),
    "sgd": ("sgd", {"wd": 1e-3, "rescale_grad": 2.0}),
    "adam": ("adam", {"wd": 1e-4, "rescale_grad": 0.5, "beta1": 0.8,
                      "beta2": 0.99, "epsilon": 1e-7}),
    "rmsprop": ("rmsprop", {"wd": 1e-4, "rescale_grad": 0.5,
                            "gamma1": 0.9, "clip_weights": 0.9}),
}
SHAPES = [(6, 5), (7,), (3, 2, 4)]
LRS, WD_MULTS = [0.1, 0.05, 0.2], [1.0, 0.0, 2.0]


def _rule_inputs(seed):
    rs = np.random.RandomState(seed)
    w = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    g = [rs.randn(*s).astype(np.float32) for s in SHAPES]
    st = [[np.abs(rs.randn(*s)).astype(np.float32) for s in SHAPES]
          for _ in range(2)]
    return w, g, st


def _flat(arrs):
    return torch.from_numpy(np.concatenate([a.reshape(-1) for a in arrs]))


def _slice_bucket(n_ranks, rank):
    """A bucket of ``SHAPES``'s keys as rank ``rank`` of ``n_ranks``
    shards it (``FusedUpdateEngine._maybe_shard``'s layout)."""
    b = _Bucket(torch.float32)
    b.keys = list(range(len(SHAPES)))
    b.sizes = [int(np.prod(s)) for s in SHAPES]
    b.offsets = [int(o) for o in np.cumsum([0] + b.sizes)[:-1]]
    b.shard_n = n_ranks
    b.padded = -(-b.total // n_ranks) * n_ranks
    b.lo = rank * (b.padded // n_ranks)
    return b


def _padded(flat, b):
    return torch.cat([flat, flat.new_zeros(b.padded - flat.numel())])


def _sliced_steps(name, params, n_ranks, steps=3):
    """The weights and state after ``steps`` sharded steps of ``SHAPES``'s
    keys: each rank's ``_slice_update`` (the bucket's multi-tensor rule)
    on its slice of the padded flat vectors, concatenated again."""
    nslots, update = trules.multi_rule(name, params)
    w, g, st = _rule_inputs(3)
    bs = [_slice_bucket(n_ranks, r) for r in range(n_ranks)]
    size = bs[0].padded // n_ranks
    fw = _padded(_flat(w), bs[0])
    fs = [_padded(_flat(s), bs[0]) for s in st[:nslots]]
    lrs = dict(enumerate(LRS))
    wds = {i: params["wd"] * m for i, m in enumerate(WD_MULTS)}
    for step in range(steps):
        fg = _padded(_flat([a * (step + 1) for a in g]), bs[0])
        for b in bs:
            sl = slice(b.lo, b.lo + size)
            _slice_update(b, update, fg[sl].clone(), fw[sl],
                          [s[sl] for s in fs], lrs, wds)
    n = bs[0].total
    return fw[:n], [s[:n] for s in fs]


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_slice_update_equals_per_key_rules_bitwise(case):
    """The sharded update's rule: the bucket's multi-tensor rule on each
    rank's slice of three keys as one flat tensor (``_slice_update``; at
    2 and 3 ranks keys are split between ranks, and the last slice holds
    padding), with the keys' own lrs and wds as per-element vectors (one
    wd 0), equals the per-key rule (``_RULES``, the ops the eager
    update runs) of each key to the bit, three steps in a row; within
    1e-6 of the JAX package's ``flat_rule`` (the reference's sharded
    rule) on the whole vectors."""
    name, params = RULE_CASES[case]
    _, per_key = trules._RULES[name](params)
    jslots, jupdate = jrules.flat_rule(name, params)
    w, g, st = _rule_inputs(3)
    kw = [torch.from_numpy(a.copy()) for a in w]
    ks = [[torch.from_numpy(st[j][i].copy()) for j in range(jslots)]
          for i in range(len(SHAPES))]
    sizes = [int(np.prod(s)) for s in SHAPES]
    lr = np.repeat(np.float32(LRS), sizes)
    wd = np.repeat(np.float32([params["wd"] * m for m in WD_MULTS]), sizes)
    # copies: a JAX CPU array may alias the numpy buffer it came from
    jw = jrules.jnp.asarray(_flat(w).numpy().copy())
    js = [jrules.jnp.asarray(_flat(s).numpy().copy()) for s in st[:jslots]]
    for step in range(3):
        grads = [a * (step + 1) for a in g]
        for i in range(len(SHAPES)):
            per_key(kw[i], torch.from_numpy(grads[i]), tuple(ks[i]),
                    LRS[i], WD_MULTS[i])
        jw, js = jupdate(jw, jrules.jnp.asarray(_flat(grads).numpy()),
                         tuple(js), jrules.jnp.asarray(lr),
                         jrules.jnp.asarray(wd))
    for n_ranks in (2, 3):
        fw, fs = _sliced_steps(name, params, n_ranks)
        assert len(fs) == jslots
        assert torch.equal(fw, torch.cat([t.reshape(-1) for t in kw]))
        for j in range(jslots):
            assert torch.equal(fs[j], torch.cat([k[j].reshape(-1)
                                                 for k in ks]))
        np.testing.assert_allclose(fw.numpy(), np.asarray(jw), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("case", ["sgd_mom", "adam"])
def test_slice_update_equals_the_replicated_bucket_step_bitwise(case):
    """Sharded against replicated in one process: the bucket's rule over
    whole keys (views of the flat gradient, as ``_step_bucket`` runs it)
    and the same rule over 2 ranks' slices give the same bits."""
    name, params = RULE_CASES[case]
    nslots, update = trules.multi_rule(name, params)
    w, g, st = _rule_inputs(3)
    ws = [torch.from_numpy(a.copy()) for a in w]
    states = [tuple(torch.from_numpy(st[j][i].copy())
                    for j in range(nslots)) for i in range(len(SHAPES))]
    for step in range(3):
        flat = _flat([a * (step + 1) for a in g])
        gs = [v.view(s) for v, s in zip(flat.split(
            [int(np.prod(s)) for s in SHAPES]), SHAPES)]
        update(flat, ws, gs, states, LRS,
               [params["wd"] * m for m in WD_MULTS])
    fw, fs = _sliced_steps(name, params, 2)
    assert torch.equal(fw, torch.cat([t.reshape(-1) for t in ws]))
    for j in range(nslots):
        assert torch.equal(fs[j], torch.cat([s[j].reshape(-1)
                                             for s in states]))


def test_slice_update_of_padding_only_is_a_no_op():
    """At 64 ranks the bucket's 61 elements leave the last ranks' slices
    all padding: their update runs no rule and moves nothing."""
    b = _slice_bucket(64, 63)
    assert b.overlaps(b.lo, b.lo + 1) == []

    def update(*_a):
        raise AssertionError("a rule ran on padding")

    w = torch.zeros(1)
    _slice_update(b, update, torch.ones(1), w, [torch.zeros(1)],
                  dict(enumerate(LRS)), dict(enumerate(WD_MULTS)))
    assert torch.equal(w, torch.zeros(1))


@pytest.mark.parametrize("raw,want", [(None, True), ("1", True),
                                      ("0", False)])
def test_shard_update_knob_reads_as_the_reference(monkeypatch, raw, want):
    from mxnet_tpu import kvstore_fused as jkvf

    if raw is None:
        monkeypatch.delenv("MXTPU_SHARD_UPDATE", raising=False)
    else:
        monkeypatch.setenv("MXTPU_SHARD_UPDATE", raw)
    assert shard_update_enabled() is want is jkvf.shard_update_enabled()


@pytest.mark.parametrize("name", ["dist_allreduce_bytes_total",
                                  "executor_collective_bytes_total",
                                  "kvstore_shard_gather_seconds"])
def test_collective_families_match_the_reference(name):
    # the modules that register the families
    import mxnet_tpu.executor  # noqa: F401
    import mxnet_tpu.kvstore_fused  # noqa: F401
    import mxnet_tpu.parallel.dist  # noqa: F401
    import mxnet_tpu_torch.kvstore_fused  # noqa: F401
    import mxnet_tpu_torch.parallel.dist  # noqa: F401

    j, t = jtm.get_registry().get(name), ttm.get_registry().get(name)
    assert j is not None and t is not None
    assert (t.typename, t.labelnames, t.help) == \
        (j.typename, j.labelnames, j.help)
    if hasattr(j, "buckets"):
        assert t.buckets == j.buckets


# --------------------------------------------------- the store at world 1
@pytest.fixture
def _one_process(monkeypatch):
    for k in ("MXTPU_PS_SERVERS", "MXTPU_NUM_WORKERS", "MXTPU_COORDINATOR",
              "DMLC_NUM_WORKER", "MXTPU_RANK"):
        monkeypatch.delenv(k, raising=False)


def test_collective_dist_sync_routes_through_fused_engine(_one_process):
    """``tests/test_dist.py::test_collective_dist_sync_routes_through_
    fused_engine`` in both packages: one process without servers is the
    collective store at world 1, with the bucketed engine; dist_async is
    not collective."""
    got = {}
    for mx in (jmx, tmx):
        kv = mx.kv.create("dist_sync")
        assert kv.collective and (kv.rank, kv.num_workers) == (0, 1)
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1,
                                             rescale_grad=1.0))
        assert kv._fused is not None
        with (tmx.Context(CPU) if mx is tmx else jbase.NameManager()):
            kv.init([0, 1], [mx.nd.ones((4, 5)), mx.nd.ones((8,))])
            kv.push([0, 1], [[mx.nd.ones((4, 5))], [mx.nd.ones((8,))]])
            outs = [mx.nd.zeros((4, 5)), mx.nd.zeros((8,))]
            kv.pull([0, 1], outs)
        got[mx.__name__] = [o.asnumpy() for o in outs]
        kv.barrier()
        assert kv.get_num_dead_node(0) == 0
        assert not mx.kv.create("dist_async").collective
    for a, b in zip(got["mxnet_tpu"], got["mxnet_tpu_torch"]):
        np.testing.assert_allclose(a, 0.9, rtol=1e-6)
        np.testing.assert_array_equal(a, b)


def _fit_params(mx, sym_mod, kv_name, ctx, rows=64):
    rs = np.random.RandomState(5)
    x = rs.uniform(-1, 1, (rows, 10)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.float32)
    net = sym_mod.SoftmaxOutput(sym_mod.FullyConnected(
        sym_mod.Variable("data"), num_hidden=4, name="fc1"), name="softmax")
    init = np.random.RandomState(6)
    arg = {"fc1_weight": init.normal(0, 0.1, (4, 10)).astype(np.float32),
           "fc1_bias": np.zeros(4, np.float32)}
    mod = mx.mod.Module(net, context=ctx)
    kv = mx.kv.create(kv_name)
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=16), optimizer="sgd",
            kvstore=kv, num_epoch=1,
            optimizer_params=(("learning_rate", 0.1), ("momentum", 0.9)),
            arg_params=_given(mx, arg))
    args, _ = mod.get_params()
    return kv, {k: v.asnumpy() for k, v in args.items()}


def _given(mx, arg):
    """Initial weights as each package's Module takes them (the port's
    as numpy, which stays on the module's device)."""
    return arg if mx is tmx else {k: mx.nd.array(v) for k, v in arg.items()}


def test_collective_module_matches_device_store(_one_process):
    """``tests/test_dist.py::test_collective_module_matches_device_store``:
    ``Module.fit`` over ``dist_sync`` at world 1 trains the ``device``
    store's trajectory (the port's bit for bit; the JAX package's within
    its rtol 1e-5, atol 1e-6)."""
    kv, port = _fit_params(tmx, tmx.sym, "dist_sync", tmx.cpu())
    assert kv.collective and kv._fused is not None
    _, device = _fit_params(tmx, tmx.sym, "device", tmx.cpu())
    _, jax_c = _fit_params(jmx, jmx.sym, "dist_sync", jmx.cpu(0))
    for k in port:
        np.testing.assert_array_equal(port[k], device[k], err_msg=k)
        np.testing.assert_allclose(port[k], jax_c[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


# ------------------------------------------------- contexts, one device
def _mnist_fit(mx, ctx):
    (x, y), _ = get_synthetic_mnist(256, 16)
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, name="fc1", num_hidden=32)
    act = mx.sym.Activation(fc1, act_type="relu")
    fc2 = mx.sym.FullyConnected(act, name="fc2", num_hidden=10)
    net = mx.sym.SoftmaxOutput(fc2, name="softmax")
    rs = np.random.RandomState(7)
    arg = {"fc1_weight": rs.normal(0, 0.05, (32, 784)).astype(np.float32),
           "fc1_bias": np.zeros(32, np.float32),
           "fc2_weight": rs.normal(0, 0.1, (10, 32)).astype(np.float32),
           "fc2_bias": np.zeros(10, np.float32)}
    mod = mx.mod.Module(net, context=ctx)
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=64, shuffle=False),
            optimizer="adam", kvstore="device", num_epoch=1,
            optimizer_params=(("learning_rate", 0.01),),
            arg_params=_given(mx, arg))
    args, _ = mod.get_params()
    return mod, {k: v.asnumpy() for k, v in args.items()}


def test_contexts_of_one_device_bind_one_executor_at_the_whole_batch():
    """``cpu(0)`` .. ``cpu(7)`` name the one host: one executor at the
    whole batch, equal to one context's to the bit, and to the JAX
    package's 8-device SPMD Module (``tests/test_parallel.py:446-505``)
    within its rtol 1e-4, atol 1e-5."""
    mod8, eight = _mnist_fit(tmx, [tmx.cpu(i) for i in range(8)])
    assert len(mod8._exec_group.execs) == 1
    assert mod8._exec_group.batch_size == 64
    _, one = _mnist_fit(tmx, tmx.cpu())
    _, jax8 = _mnist_fit(jmx, [jmx.cpu(i) for i in range(8)])
    for k in one:
        np.testing.assert_array_equal(eight[k], one[k], err_msg=k)
        np.testing.assert_allclose(eight[k], jax8[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)


def test_distinct_cards_in_one_process_name_the_launcher():
    """Several distinct devices in one process stay refused (BatchNorm's
    moments over the whole batch across cards is ROADMAP Queue 1 item
    10b, slice 5); the error names the launch command."""
    net = tsym.load_json(jmx.sym.SoftmaxOutput(jmx.sym.FullyConnected(
        jmx.sym.Variable("data"), num_hidden=2, name="fc"),
        name="softmax").tojson())
    mod = tmx.mod.Module(net, context=[tmx.cpu(0), "meta"])
    with pytest.raises(MXNetError, match=r"item 10b, slice 5.*launch -n 2 "
                                         r"-s 0"):
        mod.bind(data_shapes=[("data", (4, 3))],
                 label_shapes=[("softmax_label", (4,))])


# ------------------------------------------------------------- group2ctx
def _g2c_net():
    """``tests/test_parallel.py:_group2ctx_net`` (the JAX package's)."""
    with jmx.AttrScope(ctx_group="dev1"):
        a = jmx.sym.Variable("a")
        fc1 = jmx.sym.FullyConnected(a, name="fc1", num_hidden=8)
    with jmx.AttrScope(ctx_group="dev2"):
        act = jmx.sym.Activation(fc1, act_type="relu")
        fc2 = jmx.sym.FullyConnected(act, name="fc2", num_hidden=4)
    return fc2


def _g2c_vals():
    rs = np.random.RandomState(3)
    return {"a": rs.randn(2, 6).astype(np.float32),
            "fc1_weight": rs.randn(8, 6).astype(np.float32),
            "fc1_bias": rs.randn(8).astype(np.float32),
            "fc2_weight": rs.randn(4, 8).astype(np.float32),
            "fc2_bias": rs.randn(4).astype(np.float32)}


def _g2c_run_port(group2ctx):
    net = tsym.load_json(_g2c_net().tojson())
    ex = net.simple_bind(CPU, group2ctx=group2ctx, a=(2, 6))
    for k, v in _g2c_vals().items():
        ex.arg_dict[k].copy_(torch.from_numpy(v))
    ex.forward(is_train=True)
    ex.backward([torch.ones(2, 4)])
    return ex, ex.outputs[0].numpy().copy(), {
        k: g.numpy().copy() for k, g in ex.grad_dict.items()}


def test_group2ctx_matches_single_device_and_jax():
    """``tests/test_parallel.py:142-200``: the ctx-group plan puts each
    variable with its group (here both groups are the host: one torch
    device), and the placed run's output and gradients equal the
    unplaced run's to the bit and the JAX package's placed run
    (``cpu(0)``/``cpu(1)``) within its rtol 1e-5, atol 1e-6."""
    net = tsym.load_json(_g2c_net().tojson())
    g2c = {"dev1": tmx.cpu(0), "dev2": tmx.cpu(1)}
    node_dev, var_dev, n = texec.placement_plan(net, g2c, CPU)
    assert n == 1 and set(var_dev) == {"a", "fc1_weight", "fc1_bias",
                                       "fc2_weight", "fc2_bias"}
    ex, out_p, grads_p = _g2c_run_port(g2c)
    assert ex._group2ctx and all(t.device.type == "cpu"
                                 for t in ex.grad_dict.values())
    _, out_s, grads_s = _g2c_run_port(None)
    np.testing.assert_array_equal(out_p, out_s)
    for k in grads_s:
        np.testing.assert_array_equal(grads_p[k], grads_s[k], err_msg=k)
    jex = _g2c_net().simple_bind(
        jmx.cpu(0), group2ctx={"dev1": jmx.cpu(0), "dev2": jmx.cpu(1)},
        a=(2, 6))
    for k, v in _g2c_vals().items():
        jex.arg_dict[k][:] = v
    jex.forward(is_train=True)
    jex.backward(jmx.nd.ones((2, 4)))
    np.testing.assert_allclose(out_p, jex.outputs[0].asnumpy(), rtol=1e-5,
                               atol=1e-6)
    for k in grads_p:
        np.testing.assert_allclose(grads_p[k], jex.grad_dict[k].asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_placed_graph_copies_values_across_devices(monkeypatch):
    """The placed graph moves every input that lies on another device to
    its node's device, once per crossing: on the CPU the plan's devices
    are stand-ins counted at ``Tensor.to``, and a copy onto the host
    blocks (its ops read the buffer at once)."""
    from mxnet_tpu_torch.passes import apply_graph_passes

    net = tsym.load_json(_g2c_net().tojson())

    post = apply_graph_passes(net)
    node_dev, _, _ = texec.placement_plan(post, {"dev1": CPU, "dev2": CPU},
                                          CPU)
    # a second, distinct device for dev2's nodes: torch.device("cpu", 0)
    # differs from torch.device("cpu") and .to() between them is a copy
    other = torch.device("cpu", 0)
    for node in post.nodes:
        if node.extra_attrs.get("ctx_group") == "dev2" and \
                id(node) in node_dev:
            node_dev[id(node)] = other
    fn = texec._build_graph_fn(post, torch.device(CPU), node_dev)
    moves = []
    orig = torch.Tensor.to

    def to(self, *a, **kw):
        moves.append(kw.get("non_blocking"))
        return orig(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "to", to)
    vals = {k: torch.from_numpy(v) for k, v in _g2c_vals().items()}
    outs, _ = fn(vals, {}, None, False)
    monkeypatch.setattr(torch.Tensor, "to", orig)
    ref, _ = texec._build_graph_fn(post, torch.device(CPU))(vals, {}, None,
                                                            False)
    assert torch.equal(outs[0], ref[0])
    # fc1's output into dev2's Activation, and fc2's two weights, each
    # copied onto a host device: blocking copies
    assert len(moves) >= 3 and not any(moves)


def test_copies_onto_a_card_do_not_wait_and_onto_the_host_block(
        monkeypatch):
    """``_to_device``, the placed graph's crossing: ``non_blocking`` onto
    a CUDA device only.  A non-blocking copy from a card to the host
    returns before the values arrive, and the host op that reads them
    next would read an unfilled buffer.  The copies are recorded at
    ``Tensor.to`` (no card here)."""
    calls = []
    orig = torch.Tensor.to

    def to(self, dev, **kw):
        calls.append((torch.device(dev).type, kw.get("non_blocking")))
        return self if torch.device(dev).type == "cuda" else \
            orig(self, dev, **kw)

    monkeypatch.setattr(torch.Tensor, "to", to)
    x = torch.ones(3)
    texec._to_device(x, torch.device("cuda", 0))
    texec._to_device(x, torch.device("cpu"))
    monkeypatch.setattr(torch.Tensor, "to", orig)
    assert calls == [("cuda", True), ("cpu", False)]


def _example(rel, name):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "examples", rel))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_model_parallel_lstm_graph_and_placed_steps(monkeypatch):
    """``chip_smoke.mp_lstm_symbol`` (phase 47 (d)) is
    ``examples/model-parallel-lstm/lstm_ptb.py``'s graph, JSON for JSON
    under fresh name managers; bound with every group on the host it
    trains as the graph without groups, to the bit, at a small size."""
    monkeypatch.setattr(tbase, "_NAME_MANAGER", tbase.NameManager())
    ex_mod = _example("model-parallel-lstm/lstm_ptb.py", "mp_lstm_ptb")
    cfg = dict(num_layers=2, seq_len=4, vocab_size=20, num_hidden=8,
               num_embed=6)
    groups = ["layer0", "layer1"]
    with jbase.NameManager():
        jnet = ex_mod.model_parallel_lstm(group_per_layer=groups, **cfg)
    tnet = cs.mp_lstm_symbol(group_per_layer=groups, **cfg)
    assert json.loads(tnet.tojson()) == json.loads(jnet.tojson())
    rs = np.random.RandomState(0)
    data = torch.from_numpy(rs.randint(0, 20, (3, 4)).astype(np.float32))
    label = torch.from_numpy(rs.randint(0, 20, (3, 4)).astype(np.float32))
    runs = []
    for g2c in ({g: tmx.cpu() for g in groups + ["embed", "out"]}, None):
        shapes = {"data": (3, 4), "softmax_label": (3, 4)}
        for layer in range(2):
            for s in ("c", "h"):
                shapes[f"l{layer}_init_{s}"] = (3, 8)
        ex = tnet.simple_bind(CPU, group2ctx=g2c, **shapes)
        w = np.random.RandomState(1)
        for k in sorted(ex.arg_dict):
            if k not in shapes:
                ex.arg_dict[k].copy_(torch.from_numpy(
                    w.normal(0, 0.1, ex.arg_dict[k].shape).astype(
                        np.float32)))
        outs = []
        for _ in range(2):
            ex.forward(is_train=True, data=data, softmax_label=label)
            ex.backward()
            outs.append(ex.outputs[0].clone())
            for k, g in ex.grad_dict.items():
                if k not in shapes:
                    ex.arg_dict[k].sub_(0.1 * g)
        runs.append((outs, {k: v.clone() for k, v in ex.arg_dict.items()}))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    for k in runs[1][1]:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k


# ------------------------------------------------------------- launcher
LAUNCHED = """
import json, os, sys
import torch
import torch.distributed as td
sys.path.insert(0, os.environ["REPO"])
from mxnet_tpu_torch.parallel import dist
dist.init_from_env(device="cpu")
x = torch.ones(2) * (td.get_rank() + 1)
dist.all_reduce(x)
with open(os.path.join(sys.argv[1], "rank%d.json" % td.get_rank()), "w") as f:
    json.dump({"port": os.environ["MXTPU_COORDINATOR"].rsplit(":", 1)[1],
               "sum": x.tolist()}, f)
"""


def test_launcher_rendezvous_is_not_a_probed_port(tmp_path):
    """The race of ``launch -s 0``: a port found free by a bind-and-close
    probe and handed to the workers could be taken before rank 0 binds
    it.  Here every probed port is held by another listener before the
    world starts (the launcher runs in a child whose ``_free_ports``
    returns that port); the launcher binds and holds the rendezvous
    store itself, so the world forms on a port of its own.  With the
    probed port the world never formed (the ranks waited on the other
    listener until this test's time limit)."""
    import signal
    import subprocess

    held = socket.socket()
    held.bind(("127.0.0.1", 0))
    held.listen(1)
    port = held.getsockname()[1]
    script = tmp_path / "w.py"
    script.write_text(LAUNCHED)
    runner = ("import sys\n"
              "import mxnet_tpu_torch.launch as launch\n"
              f"launch._free_ports = lambda n: [{port}] * n\n"
              "sys.exit(launch.main(sys.argv[1:]))\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXTPU_", "DMLC_"))}
    env.update(REPO=REPO, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-c", runner, "-n", "2", "-s", "0", "--launcher",
         "local", sys.executable, str(script), str(tmp_path)],
        env=env, cwd=REPO, start_new_session=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        text, _ = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        text, _ = proc.communicate()
        pytest.fail("the world did not form in 120 s:\n" + text[-3000:])
    finally:
        held.close()
    assert proc.returncode == 0, text[-3000:]
    got = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(2)]
    assert [g["sum"] for g in got] == [[3.0, 3.0]] * 2
    assert got[0]["port"] == got[1]["port"] != str(port)

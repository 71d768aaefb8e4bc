"""The collective ``dist_sync`` across ranks against the JAX package and
against one process, on the CPU.

The port's side runs in one gloo world of 2 processes
(``tests/torch_mesh_worlds.py``'s ``collective_scenarios``); the JAX side
and the one-process oracles run here:

- the collective store: each rank pushes its own gradients and the
  weights are those of one process pushing their sum (bit-equal: a
  two-term sum is exact in either order, and the sharded slice runs the
  multi-tensor rule on the same elements), sharded (``MXTPU_SHARD_UPDATE=1``,
  buckets that straddle the ranks) or replicated, in SGD, Adam and
  RMSProp, fp32 and bf16 with fp32 masters under loss scaling with a
  skipped step; and within 1e-6 of the JAX store pushing the same sums;
- ``Module.fit`` through the collective store at world 2 against the
  reference's ``tests/test_parallel.py::
  test_sharded_module_matches_single_device`` (its tolerances) and
  ``::test_shard_update_off_restores_replicated_bitwise`` (bit-equal);
- the host reads of a collective ``Module.fit`` do not grow with the
  batches (after ``tests/test_dist.py:836``);
- ``FusedTrainer`` on a (2, 1) mesh: the sentinel's flags and norm, the
  fused metric window over the global batch, against one process;
- a row-sparse table split by rows over a (2,) mesh against the
  reference's ``tests/test_sparse.py::
  test_mesh_sharded_table_parity_vs_single_device``.
"""
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import sparse as jsparse
from mxnet_tpu.test_utils import get_synthetic_mnist

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import amp as tamp
from mxnet_tpu_torch import sparse as tsparse
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.trainer import FusedTrainer as TTrainer

import torch_mesh_worlds as worlds

SHAPES = [(5, 3), (7,), (4, 2, 3), (11,), (33,), (2, 9)]
# ~210 bytes a bucket: several buckets, most straddling the two ranks
SMALL_BUCKETS = {"MXTPU_KV_BUCKET_MB": "0.0002"}
STEPS = 3
NAMES = {0: "a_weight", 1: "a_bias", 2: "b_weight", 3: "b_bias",
         4: "c_weight", 5: "d_gamma"}
STORE_OPTS = {
    "sgd": ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-3,
                    "rescale_grad": 0.5, "clip_gradient": 2.0,
                    "param_idx2name": NAMES}),
    "adam": ("adam", {"learning_rate": 0.01, "wd": 1e-4,
                      "rescale_grad": 0.5}),
    "rmsprop": ("rmsprop", {"learning_rate": 0.01, "clip_weights": 1.5,
                            "rescale_grad": 0.5}),
}
LR_MULT = {1: 0.5, 4: 2.0}
AMP_ENV = {"MXTPU_AMP": "bf16", "MXTPU_LOSS_SCALE": "dynamic"}
FIT_OPTS = {"sgd": {"learning_rate": 0.1, "momentum": 0.9},
            "adam": {"learning_rate": 0.01}}
FIT_BATCH, FIT_SAMPLES, FIT_EPOCHS = 64, 512, 2


def _grads(nan_at=None):
    """``[step][rank][key]`` gradients; with ``nan_at``, rank 1's first
    key holds a NaN at that step (the skip-step's trigger)."""
    out = []
    for t in range(STEPS):
        per_rank = []
        for r in range(2):
            gs = [np.random.RandomState(1000 * t + 10 * i + r).randn(*s)
                  .astype(np.float32) for i, s in enumerate(SHAPES)]
            if nan_at == t and r == 1:
                gs[0][0, 0] = np.nan
            per_rank.append(gs)
        out.append(per_rank)
    return out


def _init():
    rs = np.random.RandomState(7)
    return [rs.randn(*s).astype(np.float32) for s in SHAPES]


def _store_cases():
    cases = []
    for opt, (name, params) in STORE_OPTS.items():
        for shard in ("0", "1"):
            cases.append(("store", f"{opt}_shard{shard}", {
                "opt": name, "opt_params": params, "init": _init(),
                "grads": _grads(), "lr_mult": LR_MULT,
                "env": dict(SMALL_BUCKETS, MXTPU_SHARD_UPDATE=shard)}))
    for shard in ("0", "1"):
        # an eager per-key step (which gathers the sharded states back)
        # and a save/load of the states between bucketed steps
        cases.append(("store", f"interleave_shard{shard}", {
            "opt": "adam", "opt_params": STORE_OPTS["adam"][1],
            "init": _init(), "grads": _grads(), "eager_steps": (1,),
            "reload_after": (0,),
            "env": dict(SMALL_BUCKETS, MXTPU_SHARD_UPDATE=shard)}))
    for shard in ("0", "1"):
        cases.append(("store", f"amp_shard{shard}", {
            "opt": "sgd", "opt_params": {"learning_rate": 0.1,
                                         "momentum": 0.9, "wd": 1e-3},
            "init": _init(), "grads": _grads(nan_at=1), "dtype": "bfloat16",
            "env": dict(SMALL_BUCKETS, MXTPU_SHARD_UPDATE=shard, **AMP_ENV)}))
    return cases


def _mlp(sym):
    data = sym.Variable("data")
    fc1 = sym.FullyConnected(data, name="fc1", num_hidden=32)
    act = sym.Activation(fc1, act_type="relu")
    fc2 = sym.FullyConnected(act, name="fc2", num_hidden=10)
    return sym.SoftmaxOutput(fc2, name="softmax")


def _fit_init():
    rs = np.random.RandomState(11)
    return {"fc1_weight": rs.normal(0, 0.05, (32, 784)).astype(np.float32),
            "fc1_bias": np.zeros(32, np.float32),
            "fc2_weight": rs.normal(0, 0.1, (10, 32)).astype(np.float32),
            "fc2_bias": np.zeros(10, np.float32)}


def _mnist():
    (x, y), _ = get_synthetic_mnist(FIT_SAMPLES, 16)
    return x, y


def _fit_cases():
    x, y = _mnist()
    net = _mlp(jmx.sym).tojson()
    return [("fit", f"fit_{opt}_shard{shard}", {
        "net": net, "data": (x, y), "batch": FIT_BATCH, "opt": opt,
        "opt_params": FIT_OPTS[opt], "epochs": FIT_EPOCHS,
        "arg_params": _fit_init(), "env": {"MXTPU_SHARD_UPDATE": shard}})
        for opt in ("sgd", "adam") for shard in ("0", "1")]


def _sync_net():
    return jmx.sym.SoftmaxOutput(jmx.sym.FullyConnected(
        jmx.sym.Variable("data"), num_hidden=4, name="zfc"),
        name="softmax").tojson()


MESH_BATCH = 8


def _mesh_case():
    rs = np.random.RandomState(21)
    w = {"fc1_weight": rs.normal(0, 0.05, (32, 784)).astype(np.float32),
         "fc1_bias": rs.normal(0, 0.05, 32).astype(np.float32),
         "fc2_weight": rs.normal(0, 0.1, (10, 32)).astype(np.float32),
         "fc2_bias": rs.normal(0, 0.1, 10).astype(np.float32)}
    x, y = _mnist()
    batches = [{"data": x[i:i + MESH_BATCH],
                "softmax_label": y[i:i + MESH_BATCH]}
               for i in range(0, 3 * MESH_BATCH, MESH_BATCH)]
    return {"net": _mlp(jmx.sym).tojson(), "weights": w,
            "shapes": {"data": (MESH_BATCH, 1, 28, 28),
                       "softmax_label": (MESH_BATCH,)},
            "opt_params": {"learning_rate": 0.1, "momentum": 0.9},
            "batches": batches, "fit": (x[:64], y[:64]),
            "fit_batch": 16}


TABLE_SHAPE = (64, 16)


def _table_case():
    table = np.random.RandomState(3).randn(*TABLE_SHAPE).astype(np.float32)
    rs = np.random.RandomState(4)
    pushes = []
    for _ in range(3):
        idx = rs.randint(0, TABLE_SHAPE[0], 32)
        vals = rs.randn(32, TABLE_SHAPE[1]).astype(np.float32)
        pushes.append((idx, vals))
    return {"table": table, "pushes": pushes}


@pytest.fixture(scope="module")
def world():
    spec = (_store_cases() + _fit_cases()
            + [("syncs", "syncs", {"net": _sync_net(), "nbatch": (4, 16)}),
               ("refusals", "refusals", {}),
               ("mesh", "mesh", _mesh_case()),
               ("table", "table", _table_case())])
    return worlds.run_world(2, "collective_scenarios", spec)


# ------------------------------------------------------------- the store
def _oracle_store(case, monkeypatch):
    """One port process pushing both ranks' gradients summed (in the
    gradient dtype, as the ranks' reduction adds them) to a ``device``
    store from rank 0's values."""
    for k, v in case.get("env", {}).items():
        monkeypatch.setenv(k, v)
    tamp.reset_scaler()
    dt = getattr(torch, case.get("dtype", "float32"))
    kv = tmx.kv.create("device")
    opt = tmx.optimizer.create(case["opt"], **case["opt_params"])
    opt.set_lr_mult(case.get("lr_mult", {}))
    kv.set_optimizer(opt)
    keys = list(range(len(SHAPES)))
    kv.init(keys, [tmx.nd.NDArray(torch.from_numpy(a).to(dt))
                   for a in case["init"]])
    outs = [tmx.nd.NDArray(torch.zeros(s, dtype=dt)) for s in SHAPES]
    for t, per_rank in enumerate(case["grads"]):
        summed = [torch.from_numpy(a).to(dt) + torch.from_numpy(b).to(dt)
                  for a, b in zip(*per_rank)]
        if t in case.get("eager_steps", ()):
            for k, g in zip(keys, summed):
                kv.push(k, tmx.nd.NDArray(g))
        else:
            kv.push(keys, [[tmx.nd.NDArray(g)] for g in summed])
        kv.pull(keys, outs)
    scaler = tamp.global_scaler().report() if tamp.scaling_active() else None
    tamp.reset_scaler()
    return [o.tensor.float().numpy() for o in outs], scaler


def _jax_store(case):
    """The JAX ``device`` store pushing the same sums (fp32)."""
    kv = jmx.kv.create("device")
    opt = jmx.optimizer.create(case["opt"], **case["opt_params"])
    opt.set_lr_mult(case.get("lr_mult", {}))
    kv.set_optimizer(opt)
    keys = list(range(len(SHAPES)))
    kv.init(keys, [jmx.nd.array(a) for a in case["init"]])
    outs = [jmx.nd.zeros(s) for s in SHAPES]
    for per_rank in case["grads"]:
        kv.push(keys, [[jmx.nd.array(a + b)] for a, b in zip(*per_rank)])
        kv.pull(keys, outs)
    return [o.asnumpy() for o in outs]


@pytest.mark.parametrize("opt", sorted(STORE_OPTS))
@pytest.mark.parametrize("shard", ["0", "1"])
def test_collective_store_equals_one_process_sum(world, opt, shard,
                                                 monkeypatch):
    name = f"{opt}_shard{shard}"
    got = world[name]
    case = dict(_store_cases()[[c[1] for c in _store_cases()].index(name)][2])
    assert got["collective"] and (got["rank"], got["size"]) == (0, 2)
    assert got["ranks_equal"]
    assert len(got["shard_n"]) > 2
    assert set(got["shard_n"]) == ({2} if shard == "1" else {1})
    want, _ = _oracle_store(case, monkeypatch)
    for g, w in zip(got["weights"], want):
        np.testing.assert_array_equal(g, w)
    for g, j in zip(got["weights"], _jax_store(case)):
        np.testing.assert_allclose(g, j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shard", ["0", "1"])
def test_sharded_state_survives_an_eager_step_and_a_reload(world, shard,
                                                          monkeypatch):
    """An eager per-key push between bucketed ones gathers the sharded
    states back first (``ensure_host_state``) and a save/load of the
    states drops the shards: the weights stay those of one process
    pushing the sums the same way, to the bit."""
    name = f"interleave_shard{shard}"
    got = world[name]
    case = _store_cases()[[c[1] for c in _store_cases()].index(name)][2]
    want, _ = _oracle_store(case, monkeypatch)
    assert got["ranks_equal"]
    for g, w in zip(got["weights"], want):
        np.testing.assert_array_equal(g, w)
    assert world["interleave_shard0"]["weights"][0].tobytes() == \
        world["interleave_shard1"]["weights"][0].tobytes()


def test_collective_refuses_row_sparse_pushes_over_the_world(world):
    """A row-sparse push over several workers of the collective store is
    refused, naming ROADMAP Queue 1 item 10b, slice 5."""
    msg = world["refusals"]["row_sparse"]
    assert msg and "item 10b, slice 5" in msg


def test_sharded_store_equals_replicated_bitwise(world):
    for opt in STORE_OPTS:
        a, b = world[f"{opt}_shard0"], world[f"{opt}_shard1"]
        for x, y in zip(a["weights"], b["weights"]):
            np.testing.assert_array_equal(x, y)
        # the gathered optimizer states equal the replicated ones
        sa, sb = pickle.loads(a["states"]), pickle.loads(b["states"])
        assert sa.keys() == sb.keys()
        for k in sa:
            for x, y in zip(np.atleast_1d(sa[k]) if not isinstance(
                    sa[k], tuple) else sa[k], np.atleast_1d(sb[k])
                    if not isinstance(sb[k], tuple) else sb[k]):
                np.testing.assert_array_equal(x, y)


def test_sharded_store_holds_half_the_state(world):
    for opt in STORE_OPTS:
        repl, shard = world[f"{opt}_shard0"], world[f"{opt}_shard1"]
        assert repl["state_bytes"] > 0
        # each rank's slices: half the padded buckets
        assert shard["state_bytes"] <= repl["state_bytes"] // 2 + 8 * len(
            shard["shard_n"]) * 4
        assert shard["state_bytes"] >= repl["state_bytes"] // 2


def test_collective_telemetry_counts_the_collectives(world):
    total = sum(int(np.prod(s)) for s in SHAPES) * 4 * STEPS
    repl, shard = world["sgd_shard0"], world["sgd_shard1"]
    # every gradient byte enters one all-reduce or one reduce-scatter
    assert repl["allreduce_bytes"] == total
    assert repl["collective_bytes"]["grad_allreduce"] == total
    assert repl["collective_bytes"]["kv_grad_shard"] == 0
    assert shard["allreduce_bytes"] >= total
    assert shard["collective_bytes"]["kv_param_allgather"] >= total
    assert shard["collective_bytes"]["kv_grad_shard"] >= total // 2
    # get_states gathered the shards once (timed); nothing to gather
    # on the replicated store
    assert shard["gather_count"] == 1 and repl["gather_count"] == 0


@pytest.mark.parametrize("shard", ["0", "1"])
def test_collective_store_amp_masters_and_skip_step(world, shard,
                                                    monkeypatch):
    name = f"amp_shard{shard}"
    got = world[name]
    case = _store_cases()[[c[1] for c in _store_cases()].index(name)][2]
    want, scaler = _oracle_store(case, monkeypatch)
    assert got["ranks_equal"]
    for g, w in zip(got["weights"], want):
        np.testing.assert_array_equal(g, w)
    # the NaN of rank 1 at step 2 skipped that step on both ranks
    assert got["scaler"]["skipped_steps_total"] == 1
    assert got["scaler"] == scaler


# ------------------------------------------------------------ the Module
def _jax_fit(ctx, opt, shard, monkeypatch):
    """``tests/test_parallel.py::_fit_params`` from the port's initial
    weights (the reference's Xavier draws differ from the port's)."""
    monkeypatch.setenv("MXTPU_SHARD_UPDATE", "1" if shard else "0")
    x, y = _mnist()
    it = jmx.io.NDArrayIter(x, y, batch_size=FIT_BATCH, shuffle=False)
    mod = jmx.mod.Module(_mlp(jmx.sym), context=ctx)
    mod.fit(it, optimizer=opt, kvstore="device",
            optimizer_params=tuple(FIT_OPTS[opt].items()),
            num_epoch=FIT_EPOCHS,
            arg_params={k: jmx.nd.array(v) for k, v in _fit_init().items()})
    args, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in args.items()}


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_collective_module_matches_single_device(world, opt, monkeypatch):
    """The reference's ``test_sharded_module_matches_single_device``
    (rtol 1e-4, atol 1e-5) with each rank fitting half of every batch
    through the collective store, sharded."""
    got = world[f"fit_{opt}_shard1"]
    assert got["ranks_equal"]
    assert got["rescale_grad"] == pytest.approx(1.0 / FIT_BATCH)
    single = _jax_fit(jmx.cpu(0), opt, False, monkeypatch)
    sharded = _jax_fit([jmx.cpu(i) for i in range(8)], opt, True,
                       monkeypatch)
    for k in single:
        np.testing.assert_allclose(got["params"][k], single[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got["params"][k], sharded[k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_collective_shard_update_off_restores_replicated_bitwise(world, opt):
    on, off = world[f"fit_{opt}_shard1"], world[f"fit_{opt}_shard0"]
    assert off["ranks_equal"]
    for k in on["params"]:
        np.testing.assert_array_equal(on["params"][k], off["params"][k],
                                      err_msg=k)


def test_collective_loop_host_syncs_do_not_grow(world):
    counts = world["syncs"]
    assert counts[16] == counts[4], counts


# ----------------------------------------------------- metric, sentinel
def _one_process_mesh_case(case):
    from mxnet_tpu_torch import convert
    from mxnet_tpu_torch import io as tio
    from mxnet_tpu_torch import metric as tmetric
    from mxnet_tpu_torch import telemetry as ttm

    tr = TTrainer(tsym.load_json(case["net"]), device="cpu",
                  optimizer="sgd", optimizer_params=case["opt_params"])
    tr.init(**case["shapes"])
    convert.load_trainer_params(tr, case["weights"])
    ttm.health._pending.clear()
    for b in case["batches"]:
        tr.step(**b)
    sent = [r["finite"].numpy().copy() for r in ttm.health._pending]
    ttm.health._pending.clear()
    x, y = case["fit"]
    metric = tmetric.create(["acc", "ce"])
    tr.fit(tio.NDArrayIter(x, y, batch_size=case["fit_batch"],
                           shuffle=False), eval_metric=metric, num_epoch=1)
    return sent, metric.get_global_name_value()


def test_mesh_sentinel_and_metric_window_match_one_process(world,
                                                           monkeypatch):
    """``FusedTrainer(mesh=(2, 1))`` with ``MXTPU_SENTINEL`` on: each
    step's flags equal, its norm within 1e-6 relative of one process
    (each rank's blocks summed in fp64, then over the world); the fused
    metrics over the global batches within 1e-6, read once an epoch."""
    monkeypatch.setenv("MXTPU_SENTINEL", "warn")
    got = world["mesh"]
    sent, metric = _one_process_mesh_case(_mesh_case())
    assert len(got["sentinel"]) == len(sent) == 3
    for g, w in zip(got["sentinel"], sent):
        np.testing.assert_array_equal(g[:-1], w[:-1])
        np.testing.assert_allclose(g[-1], w[-1], rtol=1e-6)
    for (gn, gv), (wn, wv) in zip(got["metric"], metric):
        assert gn == wn
        np.testing.assert_allclose(gv, wv, rtol=1e-6, atol=1e-7)
    # no host read between drains: one fold a metric, at the epoch's end
    assert got["metric_syncs"] == {"accuracy": 1, "cross-entropy": 1}


# --------------------------------------------------------- sparse table
def test_sharded_row_sparse_table_matches_single_device(world):
    """The reference's ``test_mesh_sharded_table_parity_vs_single_
    device``: the table split by rows over the 2 ranks keeps its
    placement through Adam's row updates and equals one device's (the
    port's bit for bit, the JAX store's within its 1e-6/1e-7)."""
    case = _table_case()
    got = world["table"]
    assert got["placements"] == "(Shard(dim=0),)"
    assert got["local_rows"] == TABLE_SHAPE[0] // 2
    kv = tmx.kv.create("device")
    kv.set_optimizer(tmx.optimizer.create("adam", learning_rate=0.05,
                                          rescale_grad=1.0))
    with tmx.Context("cpu"):
        kv.init(0, tsparse.full_row_sparse(tmx.nd.array(case["table"])))
        for idx, vals in case["pushes"]:
            kv.push([0], [[tsparse.RowSparseNDArray(
                torch.from_numpy(idx.astype(np.int32)),
                torch.from_numpy(vals), TABLE_SHAPE)]])
        out = tmx.nd.zeros(TABLE_SHAPE)
        kv.pull([0], [out])
    np.testing.assert_array_equal(got["table"], out.tensor.numpy())
    jkv = jmx.kv.create("device")
    jkv.set_optimizer(jmx.optimizer.create("adam", learning_rate=0.05,
                                           rescale_grad=1.0))
    jkv.init(0, jsparse.full_row_sparse(jmx.nd.array(case["table"])))
    for idx, vals in case["pushes"]:
        jkv.push([0], [[jsparse.RowSparseNDArray(
            jmx.nd.NDArray(idx.astype(np.int32)), jmx.nd.NDArray(vals),
            TABLE_SHAPE)]])
    jout = jmx.nd.zeros(TABLE_SHAPE)
    jkv.pull([0], [jout])
    np.testing.assert_allclose(got["table"], jout.asnumpy(), rtol=1e-6,
                               atol=1e-7)

"""The core telemetry families of the port against the JAX package's, on
the CPU: the catalog (every family the reference registers, less the
three mesh-bound ones, with the same type and label names, enumerated in
fresh subprocesses), the reference's loop tests of ``tests/test_telemetry.py``
run in both packages on the same numpy-seeded data and weights with every
deterministic value compared (sample, observation, forward/backward,
compile, bucket, metric-sync and Speedometer counts), nothing recorded
while telemetry is off, no host sync a batch while it is on, the
exporters' ``dump_json`` and ``LoggingReporter`` (its
``[rank/size@g<n>]`` prefix), ``Gauge.inc``/``dec``, and the autotuner's
confirmation of a winner by interleaved re-timing.
"""
import json
import logging
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu.kvstore_fused  # noqa: F401 — registers its families
import mxnet_tpu.module.base_module  # noqa: F401
import mxnet_tpu.trainer  # noqa: F401
from mxnet_tpu import engine as jengine
from mxnet_tpu import executor as jexec
from mxnet_tpu import nd as jnd
from mxnet_tpu import sym as jsym
from mxnet_tpu import telemetry as jtm

import mxnet_tpu_torch as tmx
import mxnet_tpu_torch.kvstore_fused  # noqa: F401 — registers its families
from mxnet_tpu_torch import autotune as tat
from mxnet_tpu_torch import callback as tcb
from mxnet_tpu_torch import engine as tengine
from mxnet_tpu_torch import executor as texec
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import kvstore as tkv
from mxnet_tpu_torch import metric as tmetric
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch import telemetry as ttm
from mxnet_tpu_torch.autotune import search as tsearch
from mxnet_tpu_torch.module import BatchEndParam
from mxnet_tpu_torch.parallel import dist as tdist
from mxnet_tpu_torch.trainer import FusedTrainer as TTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402 — phase 42's prediction of the loop
# the reference's families of the collective dist_sync and the sharded
# bucket update, which the port registers too; ``mesh_axis_size`` came
# with ``parallel/mesh.py``
MESH_FAMILIES = {"dist_allreduce_bytes_total",
                 "executor_collective_bytes_total",
                 "kvstore_shard_gather_seconds"}
CORE_FAMILIES = (
    "engine_naive_mode", "engine_pipeline_depth",
    "trainer_host_stall_seconds", "executor_forward_seconds",
    "executor_backward_seconds", "executor_compile_total",
    "executor_compile_seconds", "trainer_step_seconds",
    "trainer_samples_total", "kvstore_fused_update_seconds",
    "kvstore_bucket_count", "kvstore_bucket_bytes",
    "metric_fused_update_total", "metric_host_sync_total",
    "speedometer_samples_per_sec", "speedometer_samples_total")
SYNCS = ("item", "cpu", "tolist", "numpy", "__bool__", "__float__",
         "__int__")
CPU = "cpu"


@pytest.fixture(autouse=True)
def _telemetry_on():
    for tm in (jtm, ttm):
        tm.reset()
        tm.enable()
    jexec.program_cache_clear()
    texec.program_cache_clear()
    yield
    for tm in (jtm, ttm):
        tm.reset()
        tm.enable(False)


def _values(tm, names=CORE_FAMILIES):
    """Each family's deterministic content by label set: a counter's or
    a gauge's value, a histogram's observation count."""
    snap = tm.json_snapshot()["metrics"]
    out = {}
    for name in names:
        e = snap[name]
        out[name] = {tuple(sorted(s["labels"].items())):
                     s["count"] if "count" in s else s["value"]
                     for s in e["samples"]}
    return out


# ---------------------------------------------------------------- catalog
_CATALOG = (
    "import os, sys\n"
    "os.environ.pop('MXTPU_TELEMETRY_HTTP_PORT', None)\n"
    "pkg = sys.argv[1]\n"
    "import importlib\n"
    "for m in ('', '.trainer', '.kvstore_fused', '.mp_io',\n"
    "          '.module.base_module', '.serving', '.parallel.dist',\n"
    "          '.parallel.coordinator', '.autotune'):\n"
    "    importlib.import_module(pkg + m)\n"
    "tm = importlib.import_module(pkg + '.telemetry')\n"
    "for f in tm.get_registry().collect():\n"
    "    print(f.name, f.typename, ','.join(f.labelnames))\n")


def _catalog(pkg):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _CATALOG, pkg],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO, env=env)
    assert res.returncode == 0, res.stderr[-2000:]
    out = {}
    for line in res.stdout.splitlines():
        name, kind, labels = (line.split(" ") + [""])[:3]
        out[name] = (kind, labels)
    return out


def test_catalog_is_the_reference_less_the_mesh_families():
    """Since the collective dist_sync the port registers every family
    of the reference, the mesh families too, with the same type and
    labels."""
    ref, port = _catalog("mxnet_tpu"), _catalog("mxnet_tpu_torch")
    assert MESH_FAMILIES <= set(ref)
    assert set(port) == set(ref)
    assert port["mesh_axis_size"] == ref["mesh_axis_size"]
    assert {k: ref[k] for k in port} == port
    assert set(CORE_FAMILIES) <= set(port)


@pytest.mark.parametrize("name", CORE_FAMILIES)
def test_core_family_schema_matches_the_reference(name):
    j = jtm.get_registry().get(name)
    t = ttm.get_registry().get(name)
    assert j is not None and t is not None, name
    assert (t.typename, t.labelnames) == (j.typename, j.labelnames)
    if hasattr(j, "buckets"):
        assert t.buckets == j.buckets
    if not name.startswith(("executor_compile", "executor_forward")):
        # the port's own help says what it counts where that differs
        assert t.help == j.help


# ------------------------------------------------------- registry, exporters
def test_gauge_inc_and_dec():
    g = ttm.gauge("t_core_gauge", "help", labels=("k",))
    g.inc(k="a")
    g.inc(2.5, k="a")
    g.dec(k="a")
    g.dec(4, k="b")
    assert g.value(k="a") == 2.5 and g.value(k="b") == -4.0
    g.set(7, k="a")
    g.inc(k="a")
    assert g.value(k="a") == 8.0
    ttm.disable()
    g.inc(10, k="a")
    g.dec(10, k="b")
    assert g.value(k="a") == 8.0 and g.value(k="b") == -4.0


def test_dump_json_writes_the_snapshot(tmp_path):
    ttm.counter("t_core_total", "help", labels=("k",)).inc(3, k="x")
    ttm.histogram("t_core_seconds", "help").observe(0.01)
    path = str(tmp_path / "metrics.json")
    assert ttm.dump_json(path) == path
    with open(path) as f:
        got = json.load(f)
    want = ttm.json_snapshot()
    got.pop("timestamp")
    want.pop("timestamp")
    assert got == want
    assert got["metrics"]["t_core_total"]["samples"] == [
        {"labels": {"k": "x"}, "value": 3.0}]


@pytest.mark.parametrize("identity,prefix", [(None, ""),
                                             ((1, 2, 0), "[1/2@g0] "),
                                             ((3, 4, 2), "[3/4@g2] ")])
def test_logging_reporter_lines_carry_the_dist_prefix(monkeypatch, caplog,
                                                      identity, prefix):
    monkeypatch.setattr(tdist, "_log_identity", lambda: identity)
    ttm.counter("t_rep_total", "help", labels=("k",)).inc(2, k="a")
    ttm.gauge("t_rep_gauge", "help").set(1.5)
    ttm.histogram("t_rep_seconds", "help").observe(0.5)
    logger = logging.getLogger("t_core_reporter")
    with caplog.at_level(logging.INFO, logger="t_core_reporter"):
        ttm.LoggingReporter(logger=logger).report_once()
    lines = [r.getMessage() for r in caplog.records
             if r.name == "t_core_reporter"]
    assert len(lines) == 1
    line = lines[0]
    assert line.startswith(prefix + "telemetry: ")
    for part in ("t_rep_total{k=a}=2", "t_rep_gauge=1.5",
                 "t_rep_seconds n=1 mean=0.5s"):
        assert part in line, line


def test_logging_reporter_thread_reports_and_stops(caplog):
    ttm.counter("t_rep_thread_total", "help").inc()
    logger = logging.getLogger("t_core_thread")
    with caplog.at_level(logging.INFO, logger="t_core_thread"):
        rep = ttm.LoggingReporter(interval=0.01, logger=logger).start()
        assert rep.start() is rep
        deadline = __import__("time").time() + 10
        while not caplog.records and __import__("time").time() < deadline:
            __import__("time").sleep(0.01)
        rep.stop()
    assert rep._thread is None
    assert any("t_rep_thread_total=1" in r.getMessage()
               for r in caplog.records)


def test_speedometer_lines_carry_the_dist_prefix(monkeypatch, caplog):
    monkeypatch.setattr(tdist, "_log_identity", lambda: (0, 2, 5))
    sp = tcb.Speedometer(4, frequent=2)
    m = tmetric.Accuracy()
    clock = iter(range(100, 200))
    monkeypatch.setattr(tcb.time, "time", lambda: float(next(clock)))
    with caplog.at_level(logging.INFO):
        for nbatch in (0, 2):
            sp(BatchEndParam(epoch=0, nbatch=nbatch, eval_metric=m,
                             locals=None))
    lines = [r.getMessage() for r in caplog.records if "Speed" in
             r.getMessage()]
    assert lines and lines[0].startswith("[0/2@g5] Epoch[0] Batch [2]")
    assert ttm.get_registry().get("speedometer_samples_total").value() == 8
    assert ttm.get_registry().get(
        "speedometer_samples_per_sec").value() == 8.0


# ------------------------------------------------------------- executor
def test_executor_compile_and_cache_metrics():
    """tests/test_telemetry.py::test_executor_compile_and_cache_metrics
    in both packages: the same compile, cache and forward/backward
    counts."""
    got = {}
    for tag, sym, nd, ctx, extra in (
            ("jax", jsym, jnd, jmx.cpu(), {}),
            ("port", tsym, tmx.nd, tmx.cpu(), {})):
        tm = jtm if tag == "jax" else ttm
        reg = tm.get_registry()
        a = sym.Variable("a")
        ex = (a * 2.0).simple_bind(ctx, a=(2,))
        ex.forward(is_train=False)
        assert reg.get("executor_compile_total").value(kind="fwd") >= 1
        assert reg.get("executor_graph_cache_total").value(
            result="miss") >= 1
        assert reg.get("executor_forward_seconds").count() >= 1
        ex.reshape(a=(4,))
        assert reg.get("executor_graph_cache_total").value(
            result="hit") >= 1
        ex.forward(is_train=True)
        ex.backward([nd.ones((2,))] if tag == "jax"
                    else [torch.ones(2)])
        assert reg.get("executor_compile_total").value(kind="fwdbwd") >= 1
        assert reg.get("executor_backward_seconds").count() >= 1
        # a second pass at the same shapes compiles nothing
        before = reg.get("executor_compile_total").total()
        ex.forward(is_train=False)
        ex.forward(is_train=True)
        ex.backward([nd.ones((2,))] if tag == "jax"
                    else [torch.ones(2)])
        assert reg.get("executor_compile_total").total() == before
        got[tag] = _values(tm, ("executor_compile_total",
                                "executor_compile_seconds",
                                "executor_forward_seconds",
                                "executor_backward_seconds"))
    assert got["port"] == got["jax"]
    assert got["port"]["executor_compile_total"] == {
        (("kind", "fwd"),): 2.0, (("kind", "fwdbwd"),): 1.0}


def test_rebind_of_an_equal_graph_compiles_nothing():
    """tests/test_executor.py's program-cache cases: an equal graph bound
    again reuses the graph function and its first runs."""
    def net():
        fc = tsym.FullyConnected(tsym.Variable("data"), num_hidden=3,
                                 name="rb_fc")
        return tsym.SoftmaxOutput(fc, name="rb_softmax")

    reg = ttm.get_registry()
    x = np.ones((4, 6), np.float32)
    ex1 = net().simple_bind(CPU, data=(4, 6))
    ex1.forward(is_train=True, data=x)
    ex1.backward()
    compiles = reg.get("executor_compile_total").total()
    ex2 = net().simple_bind(CPU, data=(4, 6))
    for _ in range(3):
        ex2.forward(is_train=True, data=x)
        ex2.backward()
    assert reg.get("executor_compile_total").total() == compiles == 2
    ex3 = net().simple_bind(CPU, data=(2, 6))      # a new shape compiles
    ex3.forward(is_train=True, data=x[:2])
    assert reg.get("executor_compile_total").value(kind="fwd") == 2


def test_first_runs_count_once_across_threads():
    """Serving threads and the training loop share the first-run table:
    each (kind, signature) opens one compile event however many threads
    race for it."""
    import threading

    def program():
        pass

    opened = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for i in range(50):
                opened.append(texec._compile_start(program, "k", i))

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(opened) == 16 * 50
    assert sum(t is not None for t in opened) == 50


# ---------------------------------------------------------------- engine
def test_engine_metrics():
    """tests/test_telemetry.py::test_engine_metrics, and the async
    window's families in both packages over the same pushes."""
    arr = tmx.nd.ones((3,), ctx=tmx.cpu())
    arr.wait_to_read()
    reg = ttm.get_registry()
    assert reg.get("engine_live_arrays").value() >= 1
    assert reg.get("engine_naive_mode").value() == 0.0
    jnd.ones((3,)).wait_to_read()
    for w, item in ((jengine.AsyncWindow(depth=2), lambda: jnd.ones((2,))),
                    (tengine.AsyncWindow(depth=2), lambda: torch.ones(2))):
        for _ in range(5):
            w.push([item()])
        w.drain()
    fams = ("engine_naive_mode", "engine_pipeline_depth",
            "trainer_host_stall_seconds")
    assert _values(ttm, fams) == _values(jtm, fams)
    assert _values(ttm, fams)["trainer_host_stall_seconds"] == {
        (("site", "window"),): 3, (("site", "boundary"),): 2}


def test_naive_engine_sets_its_gauge(monkeypatch):
    monkeypatch.setenv("MXNET_ENGINE_TYPE", "NaiveEngine")
    assert tengine.async_depth() == 1
    assert ttm.get_registry().get("engine_naive_mode").value() == 1.0


# --------------------------------------------------------------- trainer
def _fc_net(sym):
    return sym.SoftmaxOutput(
        sym.FullyConnected(sym.Variable("data"), num_hidden=2),
        name="softmax")


def test_fused_trainer_metrics():
    """tests/test_telemetry.py::test_fused_trainer_metrics in both
    packages, then a 3-step ``step_multi``: one observation a call."""
    from mxnet_tpu.trainer import FusedTrainer as JTrainer

    x = np.random.RandomState(0).rand(3, 4, 6).astype(np.float32)
    y = np.zeros((3, 4), np.float32)
    for tr in (JTrainer(_fc_net(jsym), optimizer="sgd"),
               TTrainer(_fc_net(tsym), optimizer="sgd", device=CPU)):
        tr.init(data=(4, 6), softmax_label=(4,))
        tr.step(data=x[0], softmax_label=y[0])
        tr.step_multi(data=x, softmax_label=y)
    fams = ("trainer_samples_total", "trainer_step_seconds")
    assert _values(ttm, fams) == _values(jtm, fams) == {
        "trainer_samples_total": {(("loop", "fused"),): 16.0},
        "trainer_step_seconds": {(("loop", "fused"),): 2}}


# ------------------------------------------------------------ train loop
def _short_train_loop(pkg, epochs=2, frequent=2, batches=4):
    """tests/test_telemetry.py's acceptance loop, the same data and
    weights in either package: ``Module.fit`` over ``NDArrayIter`` (of
    ``batches`` batches of 8) with a local kvstore instance and a
    Speedometer."""
    rs = np.random.RandomState(0)
    data = rs.rand(8 * batches, 10).astype(np.float32)
    label = (rs.rand(8 * batches) > 0.5).astype(np.float32)
    arg = {"fc_weight": rs.normal(0, 0.1, (2, 10)).astype(np.float32),
           "fc_bias": np.zeros(2, np.float32)}
    mx = jmx if pkg == "jax" else tmx
    s = jsym if pkg == "jax" else tsym
    net = s.SoftmaxOutput(s.FullyConnected(s.Variable("data"), num_hidden=2,
                                           name="fc"), name="softmax")
    it = mx.io.NDArrayIter(data, label, batch_size=8)
    mod = mx.mod.Module(net, context=mx.cpu())
    if pkg == "jax":
        arg = {k: jnd.array(v) for k, v in arg.items()}
    mod.fit(it, num_epoch=epochs, kvstore=mx.kv.create("local"),
            arg_params=arg,
            batch_end_callback=mx.callback.Speedometer(8, frequent=frequent))
    return mod


_LOOP_FAMILIES = (
    "trainer_samples_total", "speedometer_samples_total",
    "kvstore_bucket_count", "kvstore_bucket_bytes",
    "kvstore_fused_update_seconds", "metric_fused_update_total",
    "metric_host_sync_total", "executor_forward_seconds",
    "executor_backward_seconds", "executor_compile_total",
    "trainer_host_stall_seconds", "engine_pipeline_depth",
    "engine_naive_mode")


def test_train_loop_populates_required_metrics():
    """tests/test_telemetry.py::test_train_loop_populates_required_metrics
    in both packages: every deterministic value of the loop's families
    equal, and the values the loop predicts."""
    got = {}
    for pkg, tm in (("jax", jtm), ("port", ttm)):
        _short_train_loop(pkg)
        got[pkg] = _values(tm, _LOOP_FAMILIES)
        # the JAX package traces its forward and fwd+bwd programs again
        # at the second batch (the first update's outputs replace the
        # bound weights), which the port's first-run count has no cause
        # to: those counts are held to the port's own prediction below
        compiles = got[pkg].pop("executor_compile_total")
        reg = tm.get_registry()
        assert reg.get("speedometer_samples_per_sec").value() > 0
        assert reg.get("kvstore_bucket_bytes").sum(store="local") == 88
        assert reg.get("data_batches_total").total() > 0
    assert got["port"] == got["jax"]
    # 2 epochs x 4 batches of 8; the Speedometer reports at batch 2 of
    # each epoch (2 batches of 8); the accuracy drains at that report and
    # at the epoch's end; depth 2 waits on batches 1 and 2 when 3 and 4
    # are pushed, and on 3 and 4 at the boundary.  chip_smoke.py's phase
    # 42 holds the card's Module loop to the same prediction
    predicted = chip_smoke.core_loop_counts(4, 8, 2, epochs=2)
    assert {k: got["port"][k] for k in predicted} == predicted
    want = {
        "trainer_samples_total": {(("loop", "module"),): 64.0},
        "speedometer_samples_total": {(): 32.0},
        "kvstore_bucket_count": {(("store", "local"),): 1.0},
        "kvstore_bucket_bytes": {(("store", "local"),): 1},
        "kvstore_fused_update_seconds": {(("store", "local"),): 8},
        "metric_fused_update_total": {(("metric", "accuracy"),): 8.0},
        "metric_host_sync_total": {(("metric", "accuracy"),): 4.0},
        "executor_forward_seconds": {(): 8},
        "executor_backward_seconds": {(): 8},
        "trainer_host_stall_seconds": {(("site", "window"),): 4,
                                       (("site", "boundary"),): 4},
        "engine_pipeline_depth": {(): 0.0},
        "engine_naive_mode": {(): 0.0},
    }
    assert got["port"] == want
    assert compiles == {(("kind", "fwd"),): 1.0, (("kind", "fwdbwd"),): 1.0,
                        (("kind", "kv_update"),): 1.0}
    text = ttm.generate_text()
    for line in text.splitlines():
        if line and not line.startswith("#"):
            assert re.match(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+$',
                            line), line


@pytest.mark.parametrize("batches,frequent", [(5, 2), (6, 2), (3, 5),
                                              (7, 3)])
def test_loop_counts_follow_phase_42s_prediction(batches, frequent):
    """The Module loop's families at other batch counts and reporting
    periods (a last batch that is a report, no report at all) equal
    ``chip_smoke.core_loop_counts``."""
    _short_train_loop("port", epochs=1, frequent=frequent, batches=batches)
    predicted = chip_smoke.core_loop_counts(batches, 8, frequent)
    assert _values(ttm, tuple(predicted)) == predicted


def test_train_loop_disabled_records_nothing():
    ttm.reset()
    ttm.disable()
    _short_train_loop("port", epochs=1)
    for fam in ttm.get_registry().collect():
        assert not fam.samples(), f"{fam.name} recorded while disabled"


@pytest.mark.parametrize("fused", ["1", "0"])
def test_metric_syncs_match_jax_fused_and_eager(monkeypatch, fused):
    """One sync a drain with updates pending (fused), one an update pair
    (eager), in both packages over the same updates and reads."""
    monkeypatch.setenv("MXTPU_FUSED_METRICS", fused)
    rs = np.random.RandomState(1)
    preds = [rs.rand(4, 3).astype(np.float32) for _ in range(5)]
    labels = [rs.randint(0, 3, 4).astype(np.float32) for _ in range(5)]
    for pkg in ("jax", "port"):
        m = (jmx.metric if pkg == "jax" else tmetric).create(["acc", "ce"])
        wrap = jnd.array if pkg == "jax" else torch.from_numpy
        for i, (p, y) in enumerate(zip(preds, labels)):
            m.update([wrap(y)], [wrap(p)])
            if i % 2:
                m.get()
        m.get()
        m.get()           # nothing pending: no sync
    fams = ("metric_fused_update_total", "metric_host_sync_total")
    assert _values(ttm, fams) == _values(jtm, fams)
    syncs = _values(ttm, fams)["metric_host_sync_total"]
    assert syncs[(("metric", "accuracy"),)] == (3.0 if fused == "1"
                                                else 5.0)


def test_kvstore_buckets_and_compiles_match_jax(monkeypatch):
    """A store of keys over several buckets (``MXTPU_KV_BUCKET_MB``): the
    plan's count and bytes, one update observation a push and one
    ``kv_update`` compile a bucket program, flat over later pushes, in
    both packages."""
    monkeypatch.setenv("MXTPU_KV_BUCKET_MB", "0.0001")
    monkeypatch.setenv("MXTPU_FUSED_UPDATE", "1")
    shapes = [(8, 4), (16,), (4, 4), (30,), (2, 2)]
    for pkg in ("jax", "port"):
        mx, nd = (jmx, jnd) if pkg == "jax" else (tmx, tmx.nd)
        ctx = mx.Context("cpu")
        ctx.__enter__()
        kv = mx.kv.create("local")
        kv.set_optimizer(mx.optimizer.create("sgd", learning_rate=0.1,
                                             momentum=0.9))
        keys = list(range(len(shapes)))
        kv.init(keys, [nd.ones(s) for s in shapes])
        outs = [nd.zeros(s) for s in shapes]
        for _ in range(3):
            kv.push(keys, [nd.ones(s) for s in shapes])
            kv.pull(keys, outs)
        ctx.__exit__(None, None, None)
    fams = ("kvstore_bucket_count", "kvstore_bucket_bytes",
            "kvstore_fused_update_seconds", "executor_compile_total")
    assert _values(ttm, fams) == _values(jtm, fams)
    reg = ttm.get_registry()
    n = reg.get("kvstore_bucket_count").value(store="local")
    assert n == 5
    assert reg.get("kvstore_bucket_bytes").sum(store="local") == 4 * sum(
        int(np.prod(s)) for s in shapes)
    assert reg.get("kvstore_fused_update_seconds").count(store="local") == 3


def _sync_marks(monkeypatch, run):
    """The host syncs (Tensor reads) counted at each batch's end."""
    calls, marks = [], []

    def count(name, orig):
        def f(*a, **k):
            calls.append(name)
            return orig(*a, **k)
        return f

    with monkeypatch.context() as mp:
        for name in SYNCS:
            mp.setattr(torch.Tensor, name,
                       count(name, getattr(torch.Tensor, name)))
        run(lambda param: marks.append(len(calls)))
    return marks


@pytest.mark.parametrize("loop", ["module", "fused"])
def test_families_on_add_no_host_sync_a_batch(monkeypatch, loop):
    rs = np.random.RandomState(2)
    x = rs.rand(48, 10).astype(np.float32)
    y = rs.randint(0, 2, 48).astype(np.float32)
    net = _fc_net(tsym)

    def run(mark):
        it = tio.NDArrayIter(x, y, batch_size=8)
        cbs = [tcb.Speedometer(8, frequent=100), mark]
        if loop == "module":
            tmx.mod.Module(net, context=tmx.cpu()).fit(
                it, num_epoch=1, kvstore=tkv.create("local"),
                batch_end_callback=cbs)
        else:
            TTrainer(net, optimizer="sgd", device=CPU).fit(
                it, num_epoch=1, batch_end_callback=cbs)

    marks = _sync_marks(monkeypatch, run)
    assert len(marks) == 6
    assert [b - a for a, b in zip(marks, marks[1:])] == [0] * 5
    reg = ttm.get_registry()
    assert reg.get("trainer_samples_total").total() == 48
    assert reg.get("trainer_host_stall_seconds").count(site="window") == 4
    if loop == "module":
        assert reg.get("executor_forward_seconds").count() == 6
    else:
        assert reg.get("trainer_step_seconds").count(loop="fused") == 6


# ---------------------------------------------------------------- decode
def test_decode_compile_counts_match_jax_and_stay_flat():
    """The slot API's first step, co-batched prefill and row adoption at
    a shape are ``decode_*`` compiles in both packages; later ticks at
    the same shapes add none."""
    from mxnet_tpu.models.decode import KVDecoder as JDecoder

    from mxnet_tpu_torch.models.decode import KVDecoder as TDecoder
    from mxnet_tpu_torch.models.transformer import (lm_param_shapes,
                                                    lm_random_params)

    L, H, D, V, T = 1, 2, 16, 32, 16
    params = lm_random_params(lm_param_shapes(L, H, D, 4 * D, V, T),
                              seed=3)
    for dec in (JDecoder({k: jnd.array(v) for k, v in params.items()},
                         num_layers=L, num_heads=H, max_len=T),
                TDecoder(params, num_layers=L, num_heads=H, max_len=T,
                         device=CPU)):
        cache = dec.init_slot_state(2)
        (kr, vr), _ = dec.prefill_padded(np.array([[0, 3, 4]]), [2])
        cache = dec.adopt_row(cache, (kr, vr), 1)
        start, cursor = np.array([0, 1]), np.array([1, 3])
        for _ in range(3):
            cache, _ = dec.step_slots(cache, np.array([1, 2]), start, cursor)
            cursor = cursor + 1
        dec.prefill_padded(np.array([[5, 6, 7]]), [3])
    fams = ("executor_compile_total",)
    assert _values(ttm, fams) == _values(jtm, fams) == {
        "executor_compile_total": {(("kind", "decode_prefill"),): 1.0,
                                   (("kind", "decode_adopt"),): 1.0,
                                   (("kind", "decode_step"),): 1.0}}


# ------------------------------------------------------------- autotuner
def test_autotune_records_the_default_when_the_gain_does_not_survive(
        tmp_path, monkeypatch):
    """The winner beats the default by more than the default's spread on
    the search's timings, then not on the interleaved re-timings: the
    default is recorded, and the four re-timings count as trials."""
    monkeypatch.setenv("MXTPU_SCHEDULE_CACHE",
                       "search:" + str(tmp_path / "s.json"))
    monkeypatch.delenv("MXTPU_AUTOTUNE_TRIALS", raising=False)
    tat.reset()
    scripted = {"d": [[10.0, 11.0, 12.0], [8.0, 9.0, 10.0],
                      [8.5, 9.0, 9.5]],
                "w": [[7.0, 7.0, 7.0], [8.5, 8.5, 8.5], [8.0, 8.0, 8.0]]}
    order = []

    def timings(fn, warmup, best_of):
        order.append(fn.name)
        return scripted[fn.name].pop(0)

    monkeypatch.setattr(tsearch, "_timings", timings)

    def bench(cand):
        fn = (lambda: None)
        fn.name = cand["impl"]
        return fn

    trials = ttm.get_registry().get("autotune_trials_total")
    d, w = {"impl": "d"}, {"impl": "w"}
    try:
        assert tat.ensure("k_retime", "sig", d, [d, w], bench) == d
        assert order == ["d", "w", "w", "d", "w", "d"]
        assert trials.value(kernel="k_retime") == 6
        with open(str(tmp_path / "s.json")) as f:
            ent = json.load(f)["entries"][tat.device_kind()]["k_retime|sig"]
        assert ent["schedule"] == d and ent["trials"] == 2
        assert ent["best_us"] == 8.0
        # a gain that survives is recorded: the winner's re-timed best
        scripted.update(d=[[10.0, 11.0, 12.0], [10.0, 10.5, 11.0],
                           [10.0, 10.0, 10.5]],
                        w=[[7.0, 7.0, 7.0], [7.2, 7.2, 7.2],
                           [7.1, 7.3, 7.4]])
        assert tat.ensure("k_keep", "sig", d, [d, w], bench) == w
        assert trials.value(kernel="k_keep") == 6
        # no room in the budget for the re-timings: the default stays
        monkeypatch.setenv("MXTPU_AUTOTUNE_TRIALS", "3")
        scripted.update(d=[[10.0, 11.0, 12.0]], w=[[7.0, 7.0, 7.0]])
        assert tat.ensure("k_budget", "sig", d, [d, w], bench) == d
        assert trials.value(kernel="k_budget") == 2
    finally:
        tat.reset()

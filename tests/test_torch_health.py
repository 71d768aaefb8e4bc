"""The port's health plane against the JAX package's, on the CPU.

Mirrors ``tests/test_health.py`` for ``mxnet_tpu_torch.telemetry.health``:
live-memory accounting and the program rows, the ranked memory report,
an allocator failure at a dispatch site re-raised with the report (and
other errors passed through), the numerics sentinel (raise, warn, the
window's drain, overflow, a clean push), zero per-batch host syncs with
the sentinel on, the bounded flight ring, the one-JSON flight dump and
the auto-dumps of ``Module.fit``/``FusedTrainer.fit``, ``/healthz`` and
the in-place bytes counter.  Across the packages: with one parameter
set to ``inf`` from the same numpy weights (or one gradient, for the
bucketed kvstore update), ``FusedTrainer.step``, ``step_multi`` and the
bucketed update name the same (step, key) offenders as the reference;
the dump's top-level keys and its per-step record keys, and the
``/healthz`` keys, equal the reference's.
"""
import json
import logging
import time
import urllib.request
import warnings

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import symbol as jsym
from mxnet_tpu import telemetry as jtm
from mxnet_tpu.telemetry import health as jhealth
from mxnet_tpu.trainer import FusedTrainer as JTrainer

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert, engine, faults
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import symbol as sym
from mxnet_tpu_torch import telemetry as tm
from mxnet_tpu_torch.executor import simple_bind
from mxnet_tpu_torch.kvstore import create as kv_create
from mxnet_tpu_torch.module import Module
from mxnet_tpu_torch.ndarray import NDArray
from mxnet_tpu_torch.optimizer import create as opt_create
from mxnet_tpu_torch.telemetry import health
from mxnet_tpu_torch.trainer import FusedTrainer

CPU = "cpu"
_SYNCS = ("item", "cpu", "tolist", "numpy", "__bool__", "__float__",
          "__int__")


def _clear():
    for h in (health, jhealth):
        h._pending.clear()
        h._ring.clear()
        with h._programs_lock:
            h._programs.clear()


@pytest.fixture(autouse=True)
def _health_isolation():
    """Telemetry on, zeroed registry, empty sentinel/ring state."""
    tm.reset()
    tm.enable()
    _clear()
    faults.reset()
    yield
    _clear()
    faults.reset()
    tm.reset()
    tm.disable()


def _mlp(s=sym):
    net = s.FullyConnected(s.Variable("data"), name="hfc1", num_hidden=8)
    net = s.Activation(net, act_type="relu")
    net = s.FullyConnected(net, name="hfc2", num_hidden=4)
    return s.SoftmaxOutput(net, name="softmax")


def _nd(a):
    return NDArray(torch.as_tensor(np.asarray(a, np.float32)))


# ---------------------------------------------------------------------------
# memory accounting
# ---------------------------------------------------------------------------
def test_engine_live_bytes_tracks_sizes():
    reg = tm.get_registry()
    before = reg.get("engine_live_bytes").value()
    keep = _nd(np.ones(1024))                      # 4096 bytes
    keep.wait_to_read()
    assert reg.get("engine_live_bytes").value() >= before + 4096
    stats = engine.live_memory(top=3)
    assert stats["arrays"] >= 1 and stats["bytes"] >= 4096
    assert stats["top"] and stats["top"][0]["bytes"] > 0
    del keep


def test_bind_records_program_memory():
    ex = simple_bind(_mlp(), CPU, data=(4, 16))
    rows = {r["program"]: r for r in health.program_table()}
    assert ex._program_label in rows
    assert ex._program_label.startswith("softmax[")
    row = rows[ex._program_label]
    assert row["argument_bytes"] > 0 and row["output_bytes"] > 0
    assert row["peak_bytes"] >= row["argument_bytes"]
    g = tm.get_registry().get("program_memory_bytes")
    assert g.value(program=ex._program_label, component="peak") \
        == row["peak_bytes"]


def test_memory_report_ranks_by_peak():
    simple_bind(_mlp(), CPU, data=(4, 16))
    simple_bind(_mlp(), CPU, data=(64, 16))
    report = health.memory_report()
    peaks = [r["peak_bytes"] for r in report["programs"]]
    assert peaks == sorted(peaks, reverse=True)
    assert report["allocator"] is None            # no card here
    text = health.format_memory_report(report)
    assert "ranked by peak" in text and "live device arrays" in text


@pytest.mark.parametrize("err", [
    torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 9.20 GiB"),
    RuntimeError("[enforce fail at alloc_cpu.cpp:127] DefaultCPUAllocator: "
                 "can't allocate memory: you tried to allocate 9876543210 "
                 "bytes"),
])
def test_oom_at_dispatch_reraises_with_ranked_report(monkeypatch, err):
    ex = simple_bind(_mlp(), CPU, data=(4, 16))

    def boom(*a, **k):
        raise err

    monkeypatch.setattr(ex, "_graph_fn", boom)
    with pytest.raises(tm.DeviceOOMError) as ei:
        ex.forward(is_train=False)
    assert ei.value.__cause__ is err
    assert "ranked by peak" in str(ei.value)
    assert ex._program_label in str(ei.value)
    assert tm.get_registry().get("device_memory_oom_total").value(
        site="executor.forward") == 1
    with pytest.raises(tm.DeviceOOMError):
        ex.forward(is_train=True)


def test_non_oom_errors_pass_through_unwrapped(monkeypatch):
    ex = simple_bind(_mlp(), CPU, data=(4, 16))

    def boom(*a, **k):
        raise ValueError("shapes do not line up")

    monkeypatch.setattr(ex, "_graph_fn", boom)
    with pytest.raises(ValueError, match="shapes do not line up"):
        ex.forward(is_train=False)
    assert tm.get_registry().get("device_memory_oom_total").total() == 0


def test_oom_in_fused_kv_push(monkeypatch):
    kv = kv_create("local")
    kv.set_optimizer(opt_create("sgd", learning_rate=0.1))
    kv.init([0], [_nd(np.ones(4))])
    assert kv._fused is not None

    def boom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(kv._fused, "_step_bucket", boom)
    with pytest.raises(tm.DeviceOOMError):
        kv.push([0], [[_nd(np.ones(4))]])
    assert tm.get_registry().get("device_memory_oom_total").value(
        site="kvstore_fused.push") == 1


def test_oom_in_trainer_step(monkeypatch):
    tr = FusedTrainer(_mlp(), optimizer="sgd", device=CPU)
    tr.init(data=(2, 16), softmax_label=(2,))

    def boom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(tr, "_train_step", boom)
    with pytest.raises(tm.DeviceOOMError, match="trainer.step"):
        tr.step(data=np.zeros((2, 16), np.float32),
                softmax_label=np.zeros(2, np.float32))
    assert any(r["program"] == "fused_step[softmax]"
               for r in health.program_table())


# ---------------------------------------------------------------------------
# numerics sentinel
# ---------------------------------------------------------------------------
def _kv_with_nan(monkeypatch, mode="1"):
    monkeypatch.setenv("MXTPU_SENTINEL", mode)
    kv = kv_create("local")
    kv.set_optimizer(opt_create(
        "sgd", learning_rate=0.1,
        param_idx2name={0: "clean_w", 1: "bad_w"}))
    kv.init([0, 1], [_nd(np.ones(4)), _nd(np.ones(4))])
    bad = _nd([1.0, np.nan, 1.0, 1.0])
    kv.push([0, 1], [[_nd(np.ones(4))], [bad]])
    return kv


def test_sentinel_raises_with_key_and_step(monkeypatch):
    _kv_with_nan(monkeypatch)
    assert health.sentinel_pending() > 0
    with pytest.raises(tm.NumericsError) as ei:
        health.sentinel_check()
    msg = str(ei.value)
    assert "bad_w" in msg and "clean_w" not in msg and "step 1" in msg
    reg = tm.get_registry()
    assert reg.get("sentinel_nonfinite_total").total() == 1
    assert reg.get("sentinel_records_total").total() >= 1


def test_sentinel_warn_mode(monkeypatch):
    _kv_with_nan(monkeypatch, mode="warn")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        offenders = health.sentinel_check()
    assert [(s, n) for s, _, n in offenders] == [(1, "bad_w")]
    assert any("bad_w" in str(x.message) for x in w)


def test_sentinel_check_via_window_drain(monkeypatch):
    _kv_with_nan(monkeypatch)
    with pytest.raises(tm.NumericsError, match="bad_w"):
        engine.AsyncWindow().drain()


def test_sentinel_check_via_wait_for_all(monkeypatch):
    _kv_with_nan(monkeypatch)
    with pytest.raises(tm.NumericsError, match="bad_w"):
        engine.wait_for_all()


def test_sentinel_clean_push_is_silent(monkeypatch):
    monkeypatch.setenv("MXTPU_SENTINEL", "1")
    kv = kv_create("local")
    kv.set_optimizer(opt_create("sgd", learning_rate=0.1))
    kv.init([0], [_nd(np.ones(4))])
    kv.push([0], [[_nd(np.ones(4))]])
    assert health.sentinel_check() == []
    assert tm.get_registry().get("sentinel_grad_norm").value(
        site="kv_bucket0") == pytest.approx(2.0)


def test_sentinel_fused_trainer_step_and_multi(monkeypatch):
    monkeypatch.setenv("MXTPU_SENTINEL", "1")
    net = sym.SoftmaxOutput(
        sym.FullyConnected(sym.Variable("data"), num_hidden=4, name="sfc"),
        name="softmax")
    tr = FusedTrainer(net, optimizer="sgd", device=CPU)
    tr.init(data=(2, 8), softmax_label=(2,))
    x = np.zeros((2, 8), np.float32)
    tr.step(data=x, softmax_label=np.zeros((2,), np.float32))
    assert health.sentinel_check() == []
    x[0, 0] = np.nan
    tr.step(data=x, softmax_label=np.zeros((2,), np.float32))
    with pytest.raises(tm.NumericsError) as ei:
        health.sentinel_check()
    assert "sfc_weight" in str(ei.value) and "step 2" in str(ei.value)
    tr2 = FusedTrainer(net, optimizer="sgd", device=CPU)
    tr2.init(data=(2, 8), softmax_label=(2,))
    xs = np.stack([np.zeros((2, 8), np.float32), x,
                   np.zeros((2, 8), np.float32)])
    tr2.step_multi(data=xs, softmax_label=np.zeros((3, 2), np.float32))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        monkeypatch.setenv("MXTPU_SENTINEL", "warn")
        offenders = health.sentinel_check()
    steps = {s for s, _, _ in offenders}
    assert 2 in steps and 1 not in steps
    assert {b for _, b, _ in offenders} == {"fused_step_multi"}
    assert "sfc_weight" in {n for _, _, n in offenders}


def _offenders(h):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return sorted(h.sentinel_check())


def _pair(monkeypatch):
    """JAX and port trainers from the same numpy weights, with one
    weight entry set to inf in both."""
    monkeypatch.setenv("MXTPU_SENTINEL", "warn")
    jt = JTrainer(_mlp(jsym), optimizer="sgd")
    jt.init(data=(4, 16), softmax_label=(4,))
    weights = {k: np.asarray(v).copy() for k, v in jt.params.items()}
    weights["hfc1_weight"][0, 0] = np.inf
    jt.params = {k: jt.params[k].at[...].set(v) for k, v in weights.items()}
    tt = FusedTrainer(_mlp(), optimizer="sgd", device=CPU)
    tt.init(data=(4, 16), softmax_label=(4,))
    convert.load_trainer_params(tt, weights)
    rs = np.random.RandomState(3)
    x = rs.uniform(-1, 1, (3, 4, 16)).astype(np.float32)
    y = rs.randint(0, 4, (3, 4)).astype(np.float32)
    return jt, tt, x, y


@pytest.mark.parametrize("route", ["step", "step_multi"])
def test_inf_parameter_names_the_same_key_and_step_as_the_reference(
        monkeypatch, route):
    jt, tt, x, y = _pair(monkeypatch)
    if route == "step":
        for i in range(2):
            jt.step(data=x[i], softmax_label=y[i])
            tt.step(data=x[i], softmax_label=y[i])
    else:
        import jax.numpy as jnp

        jt.step_multi(data=jnp.asarray(x), softmax_label=jnp.asarray(y))
        tt.step_multi(data=x, softmax_label=y)
    want = _offenders(jhealth)
    got = _offenders(health)
    assert want, "the reference flags the inf weight"
    # the first step is the one the inf weight poisons: its offenders
    # match key for key.  Later steps run on NaN weights, where the two
    # libraries' ReLU gradients part (JAX's select drops a NaN input,
    # torch's threshold passes it), so only the flagged steps match there
    first = min(s for s, _, _ in want)
    assert [o for o in got if o[0] == first] == \
        [o for o in want if o[0] == first]
    assert {s for s, _, _ in got} == {s for s, _, _ in want}
    monkeypatch.setenv("MXTPU_SENTINEL", "raise")
    tt.step(data=x[0], softmax_label=y[0])
    with pytest.raises(tm.NumericsError, match="hfc1_weight"):
        engine.AsyncWindow().drain()


def test_inf_gradient_in_the_bucketed_update_names_the_reference_key(
        monkeypatch):
    monkeypatch.setenv("MXTPU_SENTINEL", "warn")
    names = {0: "w_a", 1: "w_b", 2: "w_c"}
    grads = [np.ones(6, np.float32), np.ones(6, np.float32),
             np.ones(6, np.float32)]
    grads[2][3] = np.inf

    jkv = jmx.kv.create("local")
    jkv.set_optimizer(jmx.optimizer.create("sgd", learning_rate=0.1,
                                           param_idx2name=names))
    jkv.init([0, 1, 2], [jmx.nd.ones((6,)) for _ in range(3)])
    tkv = kv_create("local")
    tkv.set_optimizer(opt_create("sgd", learning_rate=0.1,
                                 param_idx2name=names))
    tkv.init([0, 1, 2], [_nd(np.ones(6)) for _ in range(3)])
    for _ in range(2):
        jkv.push([0, 1, 2], [[jmx.nd.array(g)] for g in grads])
        tkv.push([0, 1, 2], [[_nd(g)] for g in grads])
    want = _offenders(jhealth)
    got = _offenders(health)
    assert got == want == [(1, "kv_bucket0", "w_c"), (2, "kv_bucket0", "w_c")]


def _fit_module(nbatch, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.rand(16 * nbatch, 8).astype(np.float32)
    y = (rs.rand(16 * nbatch) > 0.5).astype(np.float32)
    it = tio.NDArrayIter(x, y, batch_size=16)
    mod = Module(sym.SoftmaxOutput(sym.FullyConnected(
        sym.Variable("data"), num_hidden=2), name="softmax"),
        context=mx.cpu())
    return mod, it


def test_sentinel_zero_per_batch_syncs(monkeypatch):
    """Sentinel on, a clean fused-metrics epoch performs no per-batch
    host sync: the Tensor reads and ``sentinel_sync_total`` grow per
    epoch, not per batch."""
    monkeypatch.setenv("MXTPU_SENTINEL", "1")
    reg = tm.get_registry()

    def run(nbatch):
        mod, it = _fit_module(nbatch)
        counts = []

        def count(name, orig):
            def f(*a, **k):
                counts.append(name)
                return orig(*a, **k)
            return f

        s0 = reg.get("sentinel_sync_total").total()
        with monkeypatch.context() as mp:
            for name in _SYNCS:
                mp.setattr(torch.Tensor, name,
                           count(name, getattr(torch.Tensor, name)))
            mod.fit(it, num_epoch=1, kvstore=kv_create("local"),
                    optimizer_params=(("learning_rate", 0.1),))
        return len(counts), reg.get("sentinel_sync_total").total() - s0

    small, s_small = run(4)
    large, s_large = run(16)
    assert large == small, (small, large)
    assert s_large == s_small >= 1
    assert reg.get("sentinel_records_total").total() >= 20


def test_sentinel_zero_per_batch_syncs_in_fused_trainer_fit(monkeypatch):
    monkeypatch.setenv("MXTPU_SENTINEL", "raise")
    monkeypatch.setenv("MXTPU_PERF_ATTR", "1")
    from mxnet_tpu_torch.telemetry import perf

    def run(nbatch):
        rs = np.random.RandomState(1)
        it = tio.NDArrayIter(rs.rand(16 * nbatch, 16).astype(np.float32),
                             rs.randint(0, 4, 16 * nbatch).astype(
                                 np.float32), batch_size=16)
        tr = FusedTrainer(_mlp(), optimizer="sgd", device=CPU)
        counts = []

        def count(name, orig):
            def f(*a, **k):
                counts.append(name)
                return orig(*a, **k)
            return f

        with monkeypatch.context() as mp:
            for name in _SYNCS:
                mp.setattr(torch.Tensor, name,
                           count(name, getattr(torch.Tensor, name)))
            tr.fit(it, num_epoch=1)
        return len(counts)

    perf.enable()
    try:
        assert run(4) == run(16)
    finally:
        perf.disable()
        perf.reset()


def test_sentinel_overflow_bounds_pending(monkeypatch):
    monkeypatch.setenv("MXTPU_SENTINEL", "warn")
    monkeypatch.setenv("MXTPU_SENTINEL_WINDOW", "8")
    fin = torch.ones(3)
    for i in range(20):
        health.sentinel_record(site="t", step=i, names=("a", "b", "c"),
                               finite=fin)
    assert health.sentinel_pending() <= 9
    assert tm.get_registry().get("sentinel_sync_total").value(
        site="overflow") >= 1


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------
def test_flight_ring_is_bounded(monkeypatch):
    monkeypatch.setenv("MXTPU_FLIGHT_RING", "16")
    for i in range(64):
        tm.record_step(loop="t", step=i)
    ring = tm.flight_ring()
    assert len(ring) == 16 and ring[-1]["step"] == 63
    assert tm.get_registry().get(
        "flight_recorder_records_total").value() == 64


def test_flight_record_disabled(monkeypatch):
    monkeypatch.setenv("MXTPU_FLIGHT_RECORD", "0")
    assert tm.record_step(loop="t", step=1) is None
    assert tm.flight_ring() == []


def _fused_fit(pkg_sym, trainer_cls, io_mod, **kw):
    rs = np.random.RandomState(0)
    it = io_mod.NDArrayIter(rs.rand(32, 16).astype(np.float32),
                            rs.randint(0, 4, 32).astype(np.float32),
                            batch_size=16)
    trainer_cls(_mlp(pkg_sym), optimizer="sgd", **kw).fit(it, num_epoch=1)


def test_dump_flight_record_one_json(tmp_path):
    """The dump holds the ring, the registry snapshot and the program
    table; its top-level keys and its fit records' keys equal the
    reference's."""
    simple_bind(_mlp(), CPU, data=(4, 16))
    tm.counter("t_flight_total", "help").inc(3)
    _fused_fit(sym, FusedTrainer, tio, device=CPU)
    for i in range(5):
        tm.record_step(loop="t", step=i, depth=2, dispatch_s=0.001)
    path = tm.dump_flight_record(str(tmp_path / "flight.json"))
    d = json.load(open(path))
    assert len(d["ring"]) >= 5 and d["ring"][-1]["step"] == 4
    assert d["registry"]["metrics"]["t_flight_total"]["samples"]
    progs = [r["program"] for r in d["memory"]["programs"]]
    assert any(p.startswith("softmax[") for p in progs)
    assert "entries" in d["program_cache"]
    assert d["sentinel"]["mode"] == "off"
    assert tm.get_registry().get("flight_recorder_dumps_total").value(
        trigger="manual") == 1
    # the reference's dump of the same run
    _fused_fit(jsym, JTrainer, jmx.io)
    jpath = jhealth.dump_flight_record(str(tmp_path / "jflight.json"))
    jd = json.load(open(jpath))
    assert set(d) == set(jd)
    assert set(d["identity"]) == set(jd["identity"])
    assert set(d["perf"]) == set(jd["perf"])

    def fused_keys(dump):
        return {frozenset(r) for r in dump["ring"]
                if r.get("loop") == "fused"}

    assert fused_keys(d) == fused_keys(jd) and len(fused_keys(d)) == 1


def test_module_fit_auto_dumps_on_exception(tmp_path, monkeypatch):
    target = tmp_path / "crash.json"
    monkeypatch.setenv("MXTPU_FLIGHT_RECORD", str(target))
    mod, it = _fit_module(4)

    def exploding_callback(param):
        if param.nbatch >= 2:
            raise RuntimeError("boom mid-epoch")

    with pytest.raises(RuntimeError, match="boom mid-epoch"):
        mod.fit(it, num_epoch=1, batch_end_callback=exploding_callback)
    d = json.load(open(target))
    assert d["trigger"] == "exception"
    module_steps = [r for r in d["ring"] if r.get("loop") == "module"]
    assert len(module_steps) >= 2
    assert {"step", "depth", "dispatch_s", "program"} <= set(module_steps[0])
    assert module_steps[0]["program"].startswith("softmax[")


def test_fused_trainer_fit_auto_dumps_on_exception(tmp_path, monkeypatch):
    target = tmp_path / "crash_fused.json"
    monkeypatch.setenv("MXTPU_FLIGHT_RECORD", str(target))
    rs = np.random.RandomState(0)
    it = tio.NDArrayIter(rs.rand(64, 8).astype(np.float32),
                         (rs.rand(64) > 0.5).astype(np.float32),
                         batch_size=16)
    net = sym.SoftmaxOutput(sym.FullyConnected(
        sym.Variable("data"), num_hidden=2), name="softmax")
    tr = FusedTrainer(net, optimizer="sgd", device=CPU)

    def exploding_callback(param):
        if param.nbatch >= 1:
            raise RuntimeError("boom fused")

    with pytest.raises(RuntimeError, match="boom fused"):
        tr.fit(it, num_epoch=1, batch_end_callback=exploding_callback)
    d = json.load(open(target))
    assert any(r.get("loop") == "fused" for r in d["ring"])


def test_injected_fault_writes_the_flight_record(tmp_path, monkeypatch):
    target = tmp_path / "fault.json"
    monkeypatch.setenv("MXTPU_FLIGHT_RECORD", str(target))
    monkeypatch.setenv("MXTPU_FAULT_PLAN", "kv_push:err_first:1")
    faults.reset()
    kv = kv_create("local")
    kv.init([0], [_nd(np.ones(4))])
    with pytest.raises(faults.InjectedFault, match="flight record"):
        kv.push([0], [[_nd(np.ones(4))]])
    dumps = list(tmp_path.glob("fault_step*.json"))
    assert len(dumps) == 1
    assert json.load(open(dumps[0]))["trigger"] == "fault"


def test_slow_step_fault_site_parks_the_record(monkeypatch):
    monkeypatch.setenv("MXTPU_FAULT_PLAN", "slow_step:drop_first:1")
    monkeypatch.setenv("MXTPU_FAULT_SLOW_S", "0.05")
    faults.reset()
    assert faults.fault_slow_s() == 0.05 == health._fault_slow_s()
    t0 = time.perf_counter()
    tm.record_step(loop="t", step=1)
    assert time.perf_counter() - t0 >= 0.05
    t0 = time.perf_counter()
    tm.record_step(loop="t", step=2)
    assert time.perf_counter() - t0 < 0.05
    stats = health.step_time_stats()
    assert stats["count"] == 2 and "last_step_t" in stats


def test_host_identity_and_clock_offset(monkeypatch):
    monkeypatch.setenv("MXTPU_RANK", "3")
    ident = health.host_identity()
    assert set(ident) == set(jhealth.host_identity())
    assert ident["rank"] == 3
    health.set_clock_offset(0.25, rtt_s=0.01, source="test")
    try:
        assert health.clock_offset()["offset_s"] == 0.25
        assert tm.spans_payload()["clock"]["source"] == "test"
        assert tm.spans_payload()["rank"] == 3
    finally:
        health.set_clock_offset(0.0, source="none")


def test_healthz_endpoint():
    tm.record_step(loop="t", step=1)
    srv = tm.start_http_server(0)
    jsrv = jtm.start_http_server(0)
    try:
        d = json.loads(urllib.request.urlopen(
            "http://127.0.0.1:%d/healthz" % srv.server_address[1],
            timeout=10).read())
        jd = json.loads(urllib.request.urlopen(
            "http://127.0.0.1:%d/healthz" % jsrv.server_address[1],
            timeout=10).read())
        assert d["status"] == "ok" and d["families"] > 0
        assert d["flight_ring_len"] >= 1
        assert set(d) == set(jd)
    finally:
        srv.shutdown()
        jsrv.shutdown()


def test_donation_savings_counter():
    net = sym.SoftmaxOutput(sym.FullyConnected(
        sym.Variable("data"), num_hidden=4), name="softmax")
    tr = FusedTrainer(net, optimizer="sgd", device=CPU)
    tr.init(data=(2, 8), softmax_label=(2,))
    for _ in range(2):
        tr.step(data=np.zeros((2, 8), np.float32),
                softmax_label=np.zeros((2,), np.float32))
    v = tm.get_registry().get("device_memory_donated_bytes_total").value(
        site="trainer_step")
    # the masters (weight 4x8 + bias 4 floats) updated in place, twice
    assert v == 2 * (32 + 4) * 4


def test_speedometer_line_unchanged_when_disarmed(caplog):
    from mxnet_tpu_torch import callback as tcb
    from mxnet_tpu_torch.module import BatchEndParam

    sp = tcb.Speedometer(4, frequent=1)
    with caplog.at_level(logging.INFO):
        sp(BatchEndParam(epoch=0, nbatch=0, eval_metric=None, locals=None))
        time.sleep(0.01)
        sp(BatchEndParam(epoch=0, nbatch=1, eval_metric=None, locals=None))
    assert caplog.records[-1].getMessage().endswith("samples/sec")


def test_sentinel_names_a_row_sparse_key_like_the_reference(monkeypatch):
    """A NaN in a row-sparse gradient: the bucketed update's sparse
    bucket names the key and step as the reference's does."""
    from mxnet_tpu import sparse as jsparse

    from mxnet_tpu_torch import sparse as tsparse

    monkeypatch.setenv("MXTPU_SENTINEL", "warn")
    names = {0: "dense_w", 1: "table_w"}
    rows = np.ones((2, 3), np.float32)
    rows[1, 2] = np.nan
    idx = np.array([1, 4], np.int64)
    jkv = jmx.kv.create("local")
    jkv.set_optimizer(jmx.optimizer.create("sgd", learning_rate=0.1,
                                           param_idx2name=names))
    jkv.init([0, 1], [jmx.nd.ones((4,)),
                      jsparse.full_row_sparse(jmx.nd.ones((6, 3)))])
    tkv = kv_create("local")
    tkv.set_optimizer(opt_create("sgd", learning_rate=0.1,
                                 param_idx2name=names))
    tkv.init([0, 1], [_nd(np.ones(4)),
                      tsparse.full_row_sparse(_nd(np.ones((6, 3))))])
    jkv.push([0, 1], [[jmx.nd.ones((4,))], [jsparse.RowSparseNDArray(
        jmx.nd.NDArray(idx.astype(np.int32)), jmx.nd.NDArray(rows),
        (6, 3))]])
    tkv.push([0, 1], [[_nd(np.ones(4))], [tsparse.RowSparseNDArray(
        idx.astype(np.int32), torch.as_tensor(rows), (6, 3))]])
    want = _offenders(jhealth)
    assert want == [(1, "kv_sparse0", "table_w")]
    assert _offenders(health) == want

"""The port's perf-attribution plane against the JAX package's, on the CPU.

Mirrors ``tests/test_perf_attr.py`` for ``mxnet_tpu_torch.telemetry.perf``:
the peak table, ``_derive`` giving the reference's MFU and roofline
numbers on the same rows, cost rows counted at the first dispatch (a
GEMM-only executor's FLOPs within 1 % of the reference's
``cost_analysis``), fit buckets that sum to the step wall, the metric
families, a disarmed plane recording nothing, ``/profile`` with the
reference's keys and ``topn``, the Speedometer suffix and an armed fit
with zero per-batch host syncs, the decode and paged cost rows, the
hand-written kernels' analytic counts, and ``tools/explain.py`` (stdlib
only, unchanged) rendering the port's profile and flight dump.
"""
import json
import logging
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import symbol as jsym
from mxnet_tpu.telemetry import perf as jperf

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import symbol as sym
from mxnet_tpu_torch import telemetry as tm
from mxnet_tpu_torch.executor import simple_bind
from mxnet_tpu_torch.module import BatchEndParam, Module
from mxnet_tpu_torch.ops import flash_attention as tfa
from mxnet_tpu_torch.telemetry import health, perf
from mxnet_tpu_torch.trainer import FusedTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
CPU = "cpu"
_SYNCS = ("item", "cpu", "tolist", "numpy", "__bool__", "__float__",
          "__int__")


@pytest.fixture
def plane():
    """Armed plane + live registry, fully reset around each test."""
    tm.enable()
    tm.reset()
    perf.reset()
    perf.enable()
    yield perf
    perf.disable()
    perf.reset()
    tm.reset()
    tm.disable()


def _mlp(s=sym):
    data = s.Variable("data")
    h = s.Activation(s.FullyConnected(data, num_hidden=16, name="fc1"),
                     act_type="relu")
    return s.SoftmaxOutput(s.FullyConnected(h, num_hidden=10, name="fc2"),
                           name="softmax")


def _fit(n_batches=6, num_epoch=1):
    rs = np.random.RandomState(7)
    x = rs.randn(16 * n_batches, 8).astype(np.float32)
    y = rs.randint(0, 10, (16 * n_batches,)).astype(np.float32)
    it = tio.NDArrayIter(x, y, batch_size=16, shuffle=False)
    mod = Module(_mlp(), context=mx.cpu())
    mod.fit(it, optimizer="sgd", optimizer_params=(("learning_rate", 0.1),),
            num_epoch=num_epoch)
    return mod


def _count_syncs(monkeypatch, fn):
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
        fn()
    return len(counts)


# ---------------------------------------------------------------------------
# peak table + derivation
# ---------------------------------------------------------------------------
def test_peak_table_matching_rules():
    assert perf.peak_flops("NVIDIA H100 80GB HBM3") == 989.0e12
    assert perf.peak_bytes_per_sec("NVIDIA H100 80GB HBM3") == 3350.0e9
    assert perf.peak_flops("cpu") == jperf.peak_flops("cpu") == 0.1e12
    assert perf.peak_bytes_per_sec("cpu") == \
        jperf.peak_bytes_per_sec("cpu")
    assert perf.peak_flops("quantum9000") is None
    assert perf.peak_flops("TPU v4") is None       # no TPU is a torch device
    assert perf.machine_balance("cpu") == pytest.approx(2.0)
    assert perf.machine_balance("NVIDIA H100 80GB HBM3") == \
        pytest.approx(989.0e12 / 3350.0e9)
    assert perf.machine_balance("quantum9000") is None
    assert perf.PEAK_TFLOPS[-1][0] == perf.PEAK_GBPS[-1][0] == "cpu"
    assert perf.device_kind() == jperf.device_kind() == "cpu"


@pytest.mark.parametrize("seed", range(4))
def test_derive_gives_the_references_numbers(seed):
    rs = np.random.RandomState(seed)
    rt = {"wall_s": float(rs.uniform(0.01, 3)),
          "dispatches": int(rs.randint(1, 50))}
    cost = {"flops": float(rs.uniform(1e6, 1e12)),
            "bytes_accessed": (None if seed == 3
                               else float(rs.uniform(1e5, 1e10)))}
    for kind in ("cpu", "quantum9000"):
        got = perf._derive(rt, cost, perf.peak_flops(kind),
                           perf.machine_balance(kind))
        want = jperf._derive(rt, cost, jperf.peak_flops(kind),
                             jperf.machine_balance(kind))
        assert got == want


# ---------------------------------------------------------------------------
# cost rows at the first dispatch
# ---------------------------------------------------------------------------
def test_gemm_executor_flops_match_the_references_cost_analysis(plane):
    """FullyConnected without bias: the counted FLOPs of the inference
    forward within 1 % of the JAX executor's ``cost_analysis``."""
    def net(s):
        return s.FullyConnected(s.Variable("data"), num_hidden=96,
                                no_bias=True, name="gemm")

    ex = simple_bind(net(sym), CPU, data=(32, 64))
    ex.forward(is_train=False)
    row, = [r for r in perf.cost_table() if r["program"] ==
            ex._program_label]
    assert row["source"] == "flop_counter"
    assert row["bytes_accessed"] is None          # nothing counts bytes
    jperf.reset()
    jperf.enable()
    try:
        jex = net(jsym).simple_bind(ctx=jmx.cpu(), grad_req="null",
                                    data=(32, 64))
        jex.forward(is_train=False)
        want = [r for r in jperf.cost_table()
                if r["program"] == jex._program_label][0]["flops"]
    finally:
        jperf.disable()
        jperf.reset()
    assert row["flops"] == 2 * 32 * 64 * 96
    assert abs(row["flops"] - want) <= 0.01 * want


def test_cpu_executor_gets_a_cost_row_and_mfu(plane):
    net = _mlp()
    ex = simple_bind(net, CPU, data=(8, 8))
    for _ in range(3):
        ex.forward(is_train=True)
        ex.backward()
    payload = plane.profile_payload()
    assert payload["device_kind"] == "cpu"
    row = payload["programs"][0]
    assert row["program"] == ex._program_label
    assert row["cost_source"] == "flop_counter"
    # the forward's 2 products and the backward's 4 (simple_bind gives
    # the data a gradient too)
    fwd = 2 * 8 * (8 * 16 + 16 * 10)
    assert row["flops"] == 3 * fwd
    assert row["mfu"] is not None and row["mfu"] > 0
    assert row["roofline"] == "unknown"           # no byte count
    assert row["dispatches"] == 3
    assert row["peak_memory"] == [
        r for r in health.program_table()
        if r["program"] == ex._program_label][0]["peak_bytes"]


def test_counting_adds_the_kernels_analytic_flops(plane):
    perf.kernel_flops(123)                        # no region open: dropped
    with perf.counting() as outer:
        with perf.counting() as inner:
            perf.kernel_flops(1000)
            torch.ones(4, 8) @ torch.ones(8, 2)
        perf.kernel_flops(10)
    assert inner.flops == 1000 + 2 * 4 * 8 * 2
    assert outer.flops == 1010 + 2 * 4 * 8 * 2
    q = torch.zeros(2, 3, 64, 16)
    for products, causal, pairs in ((2, True, 64 * 65 // 2),
                                    (3, False, 64 * 64), (4, True,
                                                          64 * 65 // 2)):
        with perf.counting() as c:
            tfa._kernel_flops(products, q, causal)
        assert c.flops == 2 * products * 2 * 3 * pairs * 16


def test_kernel_flops_count_in_their_own_thread_and_its_backward(plane):
    """A region counts the launches of its own thread, and those a
    backward reports to the regions its forward saw (autograd runs a
    CUDA backward on a thread of its own); another thread's launches,
    a concurrent serving tick's say, land in no region of this one."""
    import threading

    def run(fn):
        t = threading.Thread(target=fn)
        t.start()
        t.join()

    with perf.counting() as c:
        seen = perf.open_regions()
        run(lambda: perf.kernel_flops(5))

        def backward():
            with perf.reporting_to(seen):
                perf.kernel_flops(7)
            perf.kernel_flops(11)              # outside: its own regions

        run(backward)
        perf.kernel_flops(1)
    assert c.flops == 8
    assert perf.open_regions() == ()
    with perf.reporting_to(seen):               # a closed region
        perf.kernel_flops(3)
    assert c.flops == 8


def test_fused_trainer_cost_row_at_the_first_step(plane):
    tr = FusedTrainer(_mlp(), optimizer="sgd", device=CPU)
    tr.init(data=(16, 8), softmax_label=(16,))
    x = np.zeros((16, 8), np.float32)
    y = np.zeros(16, np.float32)
    for _ in range(3):
        tr.step(data=x, softmax_label=y)
    row, = [r for r in perf.cost_table()
            if r["program"] == "fused_step[softmax]"]
    fwd = 2 * 16 * (8 * 16 + 16 * 10)
    assert row["flops"] == fwd + 2 * 16 * (8 * 16 + 2 * 16 * 10)
    rt, = [r for r in perf.runtime_table()
           if r["program"] == "fused_step[softmax]"]
    assert rt["dispatches"] == 3


def test_decode_and_paged_cost_rows(plane):
    from mxnet_tpu_torch.models import transformer as ttr
    from mxnet_tpu_torch.models.decode import KVDecoder
    from mxnet_tpu_torch.serving.paged_kv import PagedSlots

    params = ttr.lm_random_params(ttr.lm_param_shapes(
        2, 2, 32, 128, 17, 32), seed=0)
    dec = KVDecoder(params, num_layers=2, num_heads=2, max_len=32,
                    device=CPU)
    cache = dec.init_slot_state(2)
    dec.step_slots(cache, np.zeros(2, np.int64), np.zeros(2, np.int64),
                   np.zeros(2, np.int64))
    dec.prefill_padded(np.zeros((1, 8), np.int64), [3])
    pg = PagedSlots(dec, 2, block=8, prefill_buckets=(8, 16, 32),
                    kernel="gather")
    pg.admit(0, np.arange(5))
    pg.step(np.array([1, 0]), np.array([True, False]))
    rows = {r["program"]: r for r in perf.cost_table()}
    for label in ("decode_step_slots", "decode_prefill[b8]",
                  "decode_step_paged", "decode_prefill_paged[b8]"):
        assert rows[label]["flops"] > 0, label
    # the step's dense products: 2 slots x (4 D^2 + 2 D d_ff + D V) x 2 L
    assert rows["decode_step_slots"]["flops"] >= 2 * 2 * 2 * (
        4 * 32 * 32 + 2 * 32 * 128)


def test_scheduler_tick_feeds_the_plane_and_the_ring(plane):
    from mxnet_tpu_torch.models import transformer as ttr
    from mxnet_tpu_torch.models.decode import KVDecoder
    from mxnet_tpu_torch.serving.scheduler import SlotScheduler
    from mxnet_tpu_torch.telemetry import tracing

    params = ttr.lm_random_params(ttr.lm_param_shapes(
        2, 2, 32, 128, 17, 32), seed=0)
    dec = KVDecoder(params, num_layers=2, num_heads=2, max_len=32,
                    device=CPU)
    health._ring.clear()
    tracing.enable_tracing(True)
    sched = SlotScheduler(dec, num_slots=2, queue_size=8, paged=True,
                          kv_block=8)
    try:
        sched.generate(np.arange(4), max_new_tokens=3, timeout=60,
                       trace="0af7651916cd43dd8448eb211c80319c",
                       sampled=True)
    finally:
        sched.close()
        tracing.enable_tracing(False)
    b = perf.bucket_table()
    assert b["dispatch"]["count"] == b["sample"]["count"] >= 2
    assert any(r["program"] == "decode_step_paged"
               for r in perf.runtime_table())
    serve = [r for r in health.flight_ring() if r.get("loop") == "serve"]
    assert serve and serve[-1]["outcome"] == "ok"


# ---------------------------------------------------------------------------
# runtime ledger + step decomposition
# ---------------------------------------------------------------------------
def test_fit_buckets_sum_to_step_wall(plane):
    _fit(n_batches=6, num_epoch=2)
    payload = plane.profile_payload()
    steps = payload["steps"]
    assert steps["count"] == 12 and steps["wall_s"] > 0
    in_sum = sum(b["seconds"] for b in payload["buckets"].values()
                 if b["in_step"])
    assert abs(in_sum - steps["wall_s"]) <= 0.10 * steps["wall_s"]
    assert {"data_wait", "dispatch", "window_stall"} <= \
        set(payload["buckets"])
    assert payload["buckets"]["boundary_sync"]["in_step"] is False
    prog = payload["programs"][0]
    assert prog["dispatches"] >= 12 and prog["mfu"] is not None


def test_fused_trainer_fit_buckets_sum_to_step_wall(plane):
    rs = np.random.RandomState(2)
    it = tio.NDArrayIter(rs.randn(64, 8).astype(np.float32),
                         rs.randint(0, 10, 64).astype(np.float32),
                         batch_size=16)
    FusedTrainer(_mlp(), optimizer="sgd", device=CPU).fit(it, num_epoch=2)
    payload = plane.profile_payload()
    assert payload["steps"]["count"] == 8
    in_sum = sum(b["seconds"] for b in payload["buckets"].values()
                 if b["in_step"])
    assert in_sum == pytest.approx(payload["steps"]["wall_s"], rel=0.10)
    assert payload["buckets"]["boundary_sync"]["count"] == 2
    assert payload["programs"][0]["program"] == "fused_step[softmax]"


def test_fit_publishes_metric_families(plane):
    _fit(n_batches=4)
    plane.publish_gauges()
    reg = tm.get_registry()
    assert reg.get("program_wall_seconds").total() > 0
    assert reg.get("step_time_seconds").total() > 0
    assert reg.get("program_mfu").samples()
    assert reg.get("program_cost").samples()
    assert reg.get("program_roofline") is not None


def test_disarmed_records_nothing():
    perf.reset()
    perf.disable()
    perf.record_dispatch("p", 0.5)
    perf.record_step_buckets(1.0, dispatch=1.0)
    perf.record_bucket("boundary_sync", 0.1)
    ex = simple_bind(_mlp(), CPU, data=(4, 8))
    ex.forward(is_train=False)
    assert perf.runtime_table() == [] and perf.cost_table() == []
    assert perf.bucket_table() == {}
    assert perf.speedometer_suffix() == ""


# ---------------------------------------------------------------------------
# surfaces: /profile, flight dump, Speedometer
# ---------------------------------------------------------------------------
def test_profile_endpoint_shape(plane):
    plane.record_cost("p1", flops=100.0, bytes_accessed=50.0,
                      source="flop_counter")
    plane.record_dispatch("p1", 0.25)
    plane.record_step_buckets(0.3, data_wait=0.05, dispatch=0.25)
    srv = tm.start_http_server(0)
    try:
        port = srv.server_address[1]
        doc = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/profile", timeout=10).read())
        assert doc["version"] == 1 and doc["armed"] is True
        assert doc["device_kind"] == "cpu" and doc["programs_total"] == 1
        p = doc["programs"][0]
        assert p["program"] == "p1" and p["dispatches"] == 1
        assert p["mfu"] == pytest.approx(100.0 / (0.25 * 0.1e12))
        assert p["roofline"] == "compute_bound"
        assert doc["buckets"]["dispatch"]["seconds"] == pytest.approx(0.25)
        assert doc["steps"] == {"count": 1, "wall_s": pytest.approx(0.3)}
        fams = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics.json", timeout=10).read()
        )["metrics"]
        assert fams["program_mfu"]["samples"]
        assert fams["program_roofline"]["samples"]
    finally:
        srv.shutdown()
    # the reference's document from the same rows has the same keys
    jperf.reset()
    jperf.enable()
    try:
        jperf.record_cost("p1", flops=100.0, bytes_accessed=50.0,
                          source="cost_analysis")
        jperf.record_dispatch("p1", 0.25)
        want = jperf.profile_payload()
    finally:
        jperf.disable()
        jperf.reset()
    assert set(doc) == set(want)
    assert set(p) == set(want["programs"][0])
    assert p["mfu"] == want["programs"][0]["mfu"]


def test_profile_topn_truncates_but_counts_all(plane, monkeypatch):
    for i in range(5):
        plane.record_dispatch("prog%d" % i, 0.1 * (i + 1))
    monkeypatch.setenv("MXTPU_PROFILE_TOPN", "2")
    doc = plane.profile_payload()
    assert doc["programs_total"] == 5 and len(doc["programs"]) == 2
    assert doc["programs"][0]["program"] == "prog4"
    assert len(plane.profile_payload(topn=0)["programs"]) == 5


def test_flight_dump_embeds_untruncated_profile(plane, tmp_path):
    for i in range(3):
        plane.record_dispatch("prog%d" % i, 0.1)
    path = health.dump_flight_record(str(tmp_path / "dump.json"),
                                     trigger="test")
    dump = json.load(open(path))
    assert dump["perf"]["programs_total"] == 3
    assert len(dump["perf"]["programs"]) == 3


def test_speedometer_suffix_rides_log_line_with_zero_syncs(
        plane, caplog, monkeypatch):
    from mxnet_tpu_torch.callback import Speedometer

    plane.record_cost("p1", flops=1e9, bytes_accessed=1e9,
                      source="flop_counter")
    plane.record_dispatch("p1", 0.1)
    plane.record_step_buckets(0.12, data_wait=0.02, dispatch=0.1)
    speedo = Speedometer(batch_size=16, frequent=2)

    def run():
        with caplog.at_level(logging.INFO):
            speedo(BatchEndParam(epoch=0, nbatch=0, eval_metric=None,
                                 locals=None))
            speedo(BatchEndParam(epoch=0, nbatch=2, eval_metric=None,
                                 locals=None))

    assert _count_syncs(monkeypatch, run) == 0
    line = "\n".join(r.getMessage() for r in caplog.records)
    assert "mfu=0.10" in line and "top=dispatch" in line
    perf.disable()
    caplog.clear()
    with caplog.at_level(logging.INFO):
        speedo(BatchEndParam(epoch=0, nbatch=4, eval_metric=None,
                             locals=None))
    line = "\n".join(r.getMessage() for r in caplog.records)
    assert "Speed:" in line and "mfu=" not in line


def test_perf_armed_fit_keeps_zero_per_batch_syncs(plane, monkeypatch):
    small = _count_syncs(monkeypatch, lambda: _fit(n_batches=4))
    large = _count_syncs(monkeypatch, lambda: _fit(n_batches=16))
    assert large == small, (small, large)


# ---------------------------------------------------------------------------
# tools/explain.py renders the port's documents
# ---------------------------------------------------------------------------
def _run_explain(*argv):
    return subprocess.run(
        [sys.executable, os.path.join(TOOLS, "explain.py"), *argv],
        capture_output=True, text=True, timeout=60)


def test_explain_renders_the_ports_profile_and_flight_dump(plane,
                                                           tmp_path):
    _fit(n_batches=4)
    prof = tmp_path / "prof.json"
    prof.write_text(json.dumps(plane.profile_payload(), default=str))
    r = _run_explain(str(prof))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "softmax[" in r.stdout and "sanity:" in r.stdout
    assert "DIVERGED" not in r.stdout
    assert "boundary_sync" in r.stdout
    dump = health.dump_flight_record(str(tmp_path / "dump.json"))
    r = _run_explain(dump)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "softmax[" in r.stdout

"""The port's profiler and the profiler-backed telemetry spans, on the CPU.

Mirrors ``tests/test_aux.py``'s three profiler tests against the port:
the chrome trace of imperative ops under ``mode="all"``, the executor's
``forward[...]``/``forward_backward[...]`` spans under ``"symbolic"``,
and imperative spans only under ``"all"`` (that test's ``data-io`` half,
the record iterators' batch spans, waits for their telemetry, ROADMAP
Queue 1 item 11).  Then the JAX package's profile and the port's are
held side by side (same event names for the same calls), the device
trace written under ``xla_trace_dir`` (here torch.profiler's host
events: there is no card), ``telemetry.span``/``timed`` into both sinks,
the autostart knobs, and the sync rule: with the profiler off no
profiled region waits for the device; with it on, each
``forward_backward`` span does once.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import ndarray as nd
from mxnet_tpu_torch import profiler
from mxnet_tpu_torch import symbol as sym
from mxnet_tpu_torch import telemetry as tm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reset_profilers():
    """Both packages' profilers stopped, at their default config, with
    empty buffers.  An earlier test file in the same worker may leave
    events behind in either module-level buffer (``tests/test_dist.py``
    records ``kvstore_push[p]``/``kvstore_pull[p]`` into the JAX
    profiler's and never clears it), and ``dump_profile`` would write
    them into this file's profiles."""
    for prof in (profiler, jmx.profiler):
        prof.profiler_set_state("stop")
        prof.profiler_set_config()
        prof.clear()


@pytest.fixture(autouse=True)
def _profiler_stopped():
    _reset_profilers()
    yield
    _reset_profilers()


def _events(fname):
    with open(fname) as f:
        return json.load(f)["traceEvents"]


def _fc_exec(mxmod, s):
    net = s.FullyConnected(s.Variable("data"), num_hidden=4, name="fc")
    exe = net.simple_bind(mxmod.cpu(), data=(2, 3))
    if mxmod is mx:
        exe.arg_dict["data"].fill_(1.0)
    else:
        exe.arg_dict["data"][:] = np.ones((2, 3), np.float32)
    return exe


# --------------------------------------------------- tests/test_aux.py
def test_profiler_chrome_trace(tmp_path):
    fname = str(tmp_path / "profile.json")
    profiler.profiler_set_config(mode="all", filename=fname)
    profiler.profiler_set_state("run")
    try:
        a = nd.array(np.ones((32, 32), np.float32), ctx="cpu")
        b = nd.dot(a, a)
        nd.sum(b).asnumpy()
    finally:
        profiler.profiler_set_state("stop")
    out = profiler.dump_profile()
    assert out == fname
    payload = _events(fname)
    names = [e["name"] for e in payload]
    assert "dot" in names and "sum" in names
    for e in payload:
        assert e["ph"] == "X" and e["dur"] >= 0


def test_profiler_symbolic_mode_records_executor_spans(tmp_path):
    fname = str(tmp_path / "p2.json")
    profiler.profiler_set_config(mode="symbolic", filename=fname)
    exe = _fc_exec(mx, sym)
    profiler.profiler_set_state("run")
    try:
        exe.forward(is_train=True)
        exe.backward()
        exe.forward(is_train=False)
    finally:
        profiler.profiler_set_state("stop")
    profiler.dump_profile()
    names = [e["name"] for e in _events(fname)]
    assert any(n.startswith("forward_backward[") for n in names)
    assert any(n.startswith("forward[") for n in names)


def test_profiler_mode_all_records_imperative_and_data_io(tmp_path):
    """``mode="all"`` records imperative ``nd`` ops (category
    ``imperative``) and ``"symbolic"`` does not.  The reference's test
    also reads a record iterator's batches under ``data-io``; the port's
    iterators record no spans until their telemetry is ported (ROADMAP
    Queue 1 item 11)."""
    a = nd.array(np.ones((8, 8), np.float32), ctx="cpu")
    fname = str(tmp_path / "prof_all.json")
    profiler.profiler_set_config(mode="all", filename=fname)
    profiler.profiler_set_state("run")
    nd.dot(a, a).wait_to_read()
    nd.exp(a).wait_to_read()
    profiler.profiler_set_state("stop")
    profiler.dump_profile()
    imp = {e["name"] for e in _events(fname) if e["cat"] == "imperative"}
    assert "dot" in imp and "exp" in imp, imp

    fname2 = str(tmp_path / "prof_sym.json")
    profiler.profiler_set_config(mode="symbolic", filename=fname2)
    profiler.profiler_set_state("run")
    nd.dot(a, a).wait_to_read()
    profiler.profiler_set_state("stop")
    profiler.dump_profile()
    assert not [e for e in _events(fname2) if e["cat"] == "imperative"]


# ------------------------------------------------ the port's own cases
def test_span_names_match_the_jax_package(tmp_path):
    """The same executor calls give the same span names and categories
    in both packages' profiles."""
    got = {}
    for mxmod, s in ((jmx, jmx.symbol), (mx, sym)):
        fname = str(tmp_path / f"{mxmod.__name__}.json")
        mxmod.profiler.profiler_set_config(mode="symbolic", filename=fname)
        exe = _fc_exec(mxmod, s)
        mxmod.profiler.profiler_set_state("run")
        try:
            exe.forward(is_train=True)
            exe.backward()
            exe.forward(is_train=False)
        finally:
            mxmod.profiler.profiler_set_state("stop")
        mxmod.profiler.dump_profile()
        got[mxmod.__name__] = sorted((e["name"], e["cat"], e["ph"])
                                     for e in _events(fname))
    assert got["mxnet_tpu_torch"] == got["mxnet_tpu"], (
        f"port {got['mxnet_tpu_torch']} != JAX {got['mxnet_tpu']}")


def test_trainer_step_span_and_device_trace(tmp_path):
    """``FusedTrainer.step`` is a ``forward_backward`` span; with
    ``xla_trace_dir`` a torch.profiler trace lands there, apart from
    ``profile.json``."""
    from mxnet_tpu_torch.trainer import FusedTrainer

    net = sym.SoftmaxOutput(sym.FullyConnected(sym.Variable("data"),
                                               num_hidden=4, name="fc"),
                            name="softmax")
    tr = FusedTrainer(net, device="cpu").init(data=(2, 3))
    x, y = np.ones((2, 3), np.float32), np.zeros(2, np.float32)
    fname = str(tmp_path / "profile.json")
    tdir = str(tmp_path / "trace")
    profiler.profiler_set_config(mode="symbolic", filename=fname,
                                 xla_trace_dir=tdir)
    before = len(profiler.device_trace_files())
    profiler.profiler_set_state("run")
    for _ in range(2):
        tr.step(data=x, softmax_label=y)
    profiler.profiler_set_state("stop")
    profiler.dump_profile()
    spans = [e for e in _events(fname)
             if e["name"] == "forward_backward[softmax]"]
    assert len(spans) == 2
    files = profiler.device_trace_files()[before:]
    assert len(files) == 1 and os.path.dirname(files[0]) == tdir
    trace = _events(files[0])
    names = {e.get("name") for e in trace}
    assert "FusedTrainer.update" in names and "aten::mm" in names
    # two timelines, two files: the host spans are not in the trace
    assert not any(e.get("name") == "forward_backward[softmax]"
                   for e in trace)


def test_telemetry_span_and_timed_feed_both_sinks(tmp_path):
    fname = str(tmp_path / "p.json")
    profiler.profiler_set_config(mode="symbolic", filename=fname)
    was = tm.enabled()
    tm.enable()
    try:
        profiler.profiler_set_state("run")
        with tm.span("unit.region", category="host", stage="a"):
            pass

        @tm.timed("unit.timed", category="host")
        def f(v):
            return v + 1

        assert f(1) == 2
        profiler.profiler_set_state("stop")
    finally:
        tm.enable(was)
    profiler.dump_profile()
    cats = {e["name"]: e["cat"] for e in _events(fname)}
    assert cats == {"unit.region": "host", "unit.timed": "host"}
    reg = tm.get_registry()
    assert tm.sanitize_name("unit.region") == "unit_region"
    assert reg.get("unit_region_seconds").count(stage="a") == 1
    assert reg.get("unit_timed_seconds").count() == 1


def test_telemetry_span_with_every_sink_off_records_nothing(tmp_path):
    assert not profiler.is_running()
    was = tm.enabled()
    tm.enable(False)
    try:
        with tm.span("unit.off"):
            pass
    finally:
        tm.enable(was)
    fname = profiler.dump_profile(str(tmp_path / "p.json"))
    assert _events(fname) == []
    assert tm.get_registry().get("unit_off_seconds") is None


def test_autostart_and_mode_knobs():
    code = ("import mxnet_tpu_torch.profiler as p; "
            "print(p.is_running(), p.mode())")
    env = dict(os.environ, MXNET_PROFILER_AUTOSTART="1",
               MXNET_PROFILER_MODE="all")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["True", "all"], out.stderr


def test_config_and_state_refuse_unknown_values():
    with pytest.raises(ValueError):
        profiler.profiler_set_config(mode="everything")
    with pytest.raises(ValueError):
        profiler.profiler_set_state("pause")


@pytest.mark.parametrize("running", [False, True])
def test_profiled_regions_wait_for_the_device_only_while_running(
        monkeypatch, running):
    """Module training steps through the executor: with the profiler off
    no region asks for a device sync (the loops keep zero host syncs a
    batch); on, each batch's ``forward_backward`` span asks once."""
    waits = []
    monkeypatch.setattr(profiler, "device_sync",
                        lambda device: lambda: waits.append(str(device)))
    net = sym.SoftmaxOutput(sym.FullyConnected(sym.Variable("data"),
                                               num_hidden=4, name="fc"),
                            name="softmax")
    m = mx.mod.Module(net, context=mx.cpu())
    m.bind(data_shapes=[("data", (2, 3))],
           label_shapes=[("softmax_label", (2,))])
    m.init_params()
    m.init_optimizer()
    batch = mx.io.DataBatch(data=[nd.ones((2, 3), ctx="cpu")],
                            label=[nd.zeros((2,), ctx="cpu")])
    if running:
        profiler.profiler_set_state("run")
    for _ in range(3):
        m.forward(batch, is_train=True)
        m.backward()
        m.update()
    profiler.profiler_set_state("stop")
    assert waits == (["cpu"] * 3 if running else []), waits


def test_device_sync_is_none_on_the_host():
    assert profiler.device_sync("cpu") is None
    assert profiler.device_sync(None) is None
    assert callable(profiler.device_sync(torch.device("cuda", 0)))

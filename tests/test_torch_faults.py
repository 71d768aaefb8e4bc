"""The port's fault injection (``MXTPU_FAULT_PLAN``) against the JAX
package's, on the CPU.

Mirrors the plan tests of ``tests/test_faults.py`` (the grammar, the
named refusals, determinism under ``MXTPU_FAULT_SEED``, the ``_first``
modes, an unlisted site, ``fault_injected_total``), then the port's
sites: an injected ``kv_push`` error is named in the raise and the next
push trains; ``kv_pull`` alike; ``serve_admit`` fails one request while
the engine serves the next; ``ckpt_write`` publishes nothing; and
``crash_after`` ends a child process with exit 137.  One plan and seed
fire at the same hits in both packages (both draw from Python's
``random.Random(MXTPU_FAULT_SEED)``).  The flight-record dump the
reference attaches to an injected error waits for the health plane
(ROADMAP Queue 1 item 11).
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from mxnet_tpu import faults as jfaults

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import checkpoint as ckpt
from mxnet_tpu_torch import faults
from mxnet_tpu_torch import telemetry as tm
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.faults import InjectedFault

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_plan(monkeypatch):
    monkeypatch.delenv("MXTPU_FAULT_PLAN", raising=False)
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


# ------------------------------------------------------ plan grammar
def test_plan_parses_the_documented_grammar(monkeypatch):
    monkeypatch.setenv(
        "MXTPU_FAULT_PLAN",
        "kv_push:err:0.01,dist_send:drop:0.05,ckpt_write:crash_after:3")
    p = faults.plan()
    assert p["kv_push"].mode == "err" and p["kv_push"].arg == 0.01
    assert p["dist_send"].mode == "drop" and p["dist_send"].arg == 0.05
    assert p["ckpt_write"].mode == "crash_after" and \
        p["ckpt_write"].arg == 3
    assert faults.active()


@pytest.mark.parametrize("bad", [
    "kv_push:err",            # missing arg
    "kv_push:explode:1",      # unknown mode
    "kv_push:err:2.0",        # probability out of range
    "kv_push:crash_after:-1",  # negative count
    "kv_push:err:x",          # non-numeric
])
def test_plan_rejects_bad_entries_with_named_error(monkeypatch, bad):
    monkeypatch.setenv("MXTPU_FAULT_PLAN", bad)
    faults.reset()
    with pytest.raises(MXNetError, match="MXTPU_FAULT_PLAN"):
        faults.plan()


def test_plan_is_deterministic_under_seed(monkeypatch):
    monkeypatch.setenv("MXTPU_FAULT_PLAN", "x:err:0.5")
    monkeypatch.setenv("MXTPU_FAULT_SEED", "42")

    def draw():
        faults.reset()
        return [faults.fire("x") for _ in range(32)]

    assert draw() == draw()


def test_first_n_modes_are_deterministic(monkeypatch):
    monkeypatch.setenv("MXTPU_FAULT_PLAN", "s:err_first:2")
    faults.reset()
    assert faults.fire("s") == "err"
    assert faults.fire("s") == "err"
    assert faults.fire("s") is None
    assert faults.fire("s") is None


def test_unlisted_site_never_fires(monkeypatch):
    monkeypatch.setenv("MXTPU_FAULT_PLAN", "s:err:1")
    faults.reset()
    assert faults.fire("other_site") is None


def test_injection_counts_telemetry(monkeypatch):
    monkeypatch.setenv("MXTPU_FAULT_PLAN", "s_tm:err_first:3")
    faults.reset()
    fam = tm.get_registry().get("fault_injected_total")

    def total():
        # samples are (label values in (site, mode) order, value)
        return sum(v for labels, v in fam.samples() if labels[0] == "s_tm")

    was = tm.enabled()
    before = total()
    tm.enable()
    try:
        for _ in range(5):
            faults.fire("s_tm")
    finally:
        tm.enable(was)
    assert total() - before == 3


# ---------------------------------------------- both packages, one seed
@pytest.mark.parametrize("plan,seed", [
    ("x:err:0.3,y:drop:0.5", "7"),
    ("x:drop:0.05,y:err_first:3", "0"),
    ("x:err:1,y:drop_first:2", "123"),
])
def test_same_plan_and_seed_fire_at_the_same_hits_in_both(monkeypatch,
                                                           plan, seed):
    monkeypatch.setenv("MXTPU_FAULT_PLAN", plan)
    monkeypatch.setenv("MXTPU_FAULT_SEED", seed)
    got = []
    for mod in (jfaults, faults):
        mod.reset()
        got.append([(site, mod.fire(site))
                    for site in ["x", "y", "x", "x", "y", "z"] * 20])
    assert got[0] == got[1]
    assert any(a for _, a in got[1])


# ------------------------------------------------------ the port's sites
def test_kv_push_injected_error_is_named(monkeypatch):
    monkeypatch.setenv("MXTPU_FAULT_PLAN", "kv_push:err_first:1")
    faults.reset()
    kv = mx.kv.create("local")
    kv.init("w", mx.nd.ones((2, 2), ctx="cpu"))
    with pytest.raises(InjectedFault, match="kv_push"):
        kv.push("w", mx.nd.ones((2, 2), ctx="cpu"))
    # recovery: the fault is spent, the next push lands
    kv.push("w", mx.nd.full((2, 2), 3.0, ctx="cpu"))
    out = mx.nd.zeros((2, 2), ctx="cpu")
    kv.pull("w", out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.full((2, 2), 3.0))


def test_kv_pull_injected_error_is_named(monkeypatch):
    kv = mx.kv.create("local")
    kv.init("w", mx.nd.ones((2, 2), ctx="cpu"))
    monkeypatch.setenv("MXTPU_FAULT_PLAN", "kv_pull:err_first:1")
    faults.reset()
    out = mx.nd.zeros((2, 2), ctx="cpu")
    with pytest.raises(InjectedFault, match="kv_pull"):
        kv.pull("w", out=out)
    kv.pull("w", out=out)
    np.testing.assert_array_equal(out.asnumpy(), np.ones((2, 2)))


def test_ckpt_write_fault_through_the_plan_publishes_nothing(
        tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_FAULT_PLAN", "ckpt_write:err_first:1")
    faults.reset()
    w = ckpt.save(str(tmp_path), 1, {"x": np.ones(3)}, background=True)
    with pytest.raises(InjectedFault, match="ckpt_write"):
        w.wait()
    assert ckpt.list_checkpoints(str(tmp_path)) == []
    ckpt.save(str(tmp_path), 2, {"x": np.ones(3)}, background=False)
    assert [s for s, _ in ckpt.list_checkpoints(str(tmp_path))] == [2]


def _tiny_decoder():
    from mxnet_tpu_torch.models import transformer
    from mxnet_tpu_torch.models.decode import KVDecoder

    net = transformer.transformer_lm(num_layers=1, num_heads=2, d_model=16,
                                     seq_len=16, vocab_size=11)
    args, _, _ = net.infer_shape(data=(1, 16), softmax_label=(1, 16))
    rs = np.random.RandomState(0)
    params = {n: rs.normal(0, 0.08, s).astype(np.float32)
              for n, s in zip(net.list_arguments(), args)
              if n not in ("data", "softmax_label")}
    return KVDecoder(params, num_layers=1, num_heads=2, max_len=16,
                     device="cpu")


def test_serve_admit_fault_kills_request_not_engine(monkeypatch):
    """An injected admission fault ends one request with outcome
    ``error``; the engine serves the next request."""
    from mxnet_tpu_torch.serving import SlotScheduler

    monkeypatch.setenv("MXTPU_FAULT_PLAN", "serve_admit:err_first:1")
    faults.reset()
    sched = SlotScheduler(_tiny_decoder(), num_slots=2, queue_size=4)
    try:
        rs = np.random.RandomState(2)
        bad = sched.generate(rs.randint(0, 11, 4), max_new_tokens=3,
                             timeout=60)
        assert bad.outcome == "error"
        assert isinstance(bad.error, InjectedFault)
        ok = sched.generate(rs.randint(0, 11, 4), max_new_tokens=3,
                            timeout=60)
        assert ok.outcome == "ok" and len(ok.tokens) == 3
    finally:
        sched.close()


def test_crash_after_ends_the_process_with_137(tmp_path):
    code = ("import mxnet_tpu_torch.faults as f\n"
            "for i in range(5):\n"
            "    f.fire('site')\n"
            "    print('hit', i, flush=True)\n")
    env = dict(os.environ, MXTPU_FAULT_PLAN="site:crash_after:2")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 137, out.stderr
    assert out.stdout.split("\n")[:2] == ["hit 0", "hit 1"]
    assert "hit 2" not in out.stdout

"""Checkpoints that survive a crash: the port's ``checkpoint`` layer,
``FusedTrainer.save_state``/``restore_state`` and ``fit(checkpoint=,
resume=)`` in both loops.

Mirrors ``tests/test_checkpoint.py`` case for case (the writer fails
through ``MXTPU_FAULT_PLAN``'s ``ckpt_write`` site; the sync counter
counts the host reads of tensors), and adds what crosses packages:
checkpoints written by either package resumed by the other, the
structural signature equal to the reference's on every zoo model and
on ``sparse_mf``'s graph, and the HWIO relayout.  The subprocess kill is
not a timing race: the victim prints its marker only after a published
manifest is on disk and before its next step, the test waits on that
marker, and each child has its own timeout.

Tolerances: resumes within one package are bit-identical (0); across
packages the next step's outputs agree to 1e-5 (fp32; JAX with
``MXTPU_CONV_PRECISION=float32``).
"""
import json
import os
import signal
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import models as jmodels
from mxnet_tpu.trainer import FusedTrainer as JTrainer

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import checkpoint as ckpt
from mxnet_tpu_torch import models as tmodels
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.trainer import FusedTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


def _mlp(s=tsym):
    data = s.Variable("data")
    fc1 = s.FullyConnected(data, num_hidden=16, name="fc1")
    act = s.Activation(fc1, act_type="relu")
    fc2 = s.FullyConnected(act, num_hidden=4, name="fc2")
    return s.SoftmaxOutput(fc2, name="softmax")


def _data(n=64, dim=8, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, dim).astype(np.float32),
            (rs.rand(n) * 4).astype(np.float32))


def _fixed_params(dim=8):
    rs = np.random.RandomState(3)
    return {
        "fc1_weight": tnd.array(rs.randn(16, dim).astype(np.float32) * 0.1,
                                ctx=CPU),
        "fc1_bias": tnd.zeros((16,), ctx=CPU),
        "fc2_weight": tnd.array(rs.randn(4, 16).astype(np.float32) * 0.1,
                                ctx=CPU),
        "fc2_bias": tnd.zeros((4,), ctx=CPU),
    }


def _trainer(optimizer="adam"):
    tmx.random.seed(7)
    t = FusedTrainer(_mlp(), optimizer=optimizer,
                     optimizer_params={"lr": 0.05}, device=CPU)
    t.init(data=(8, 8), softmax_label=(8,))
    return t


def _steps(t, lo, hi, X, Y):
    for i in range(lo, hi):
        b = slice((i % 8) * 8, (i % 8 + 1) * 8)
        t.step(data=X[b], softmax_label=Y[b])


def _same(a, b):
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


# ---------------------------------------------- format and atomicity
def test_save_load_roundtrip(tmp_path):
    arrays = {"a/x": np.arange(12, dtype=np.float32).reshape(3, 4),
              "b/y": np.ones((2,), np.int32),
              "c/z": torch.arange(6.0).reshape(2, 3)}
    w = ckpt.save(str(tmp_path), 5, arrays, meta={"epoch": 1},
                  background=True)
    w.wait()
    assert os.path.basename(w.path) == "ckpt-000000000005"
    loaded, manifest = ckpt.load(w.path)
    assert manifest["meta"]["epoch"] == 1 and manifest["step"] == 5
    for k in arrays:
        np.testing.assert_array_equal(np.asarray(arrays[k]), loaded[k])
        assert manifest["arrays"][k]["crc32"] >= 0
        assert manifest["arrays"][k]["sharding"]
    # the JAX package reads the same directory
    from mxnet_tpu import checkpoint as jckpt

    jarrays, _ = jckpt.load(w.path)
    np.testing.assert_array_equal(jarrays["c/z"], loaded["c/z"])


def test_incomplete_checkpoint_is_invisible(tmp_path):
    torn = tmp_path / "ckpt-000000000003"
    torn.mkdir()
    (torn / "a00000.npy").write_bytes(b"garbage")
    assert ckpt.list_checkpoints(str(tmp_path)) == []
    assert ckpt.latest(str(tmp_path)) is None


def test_failed_write_publishes_nothing(tmp_path, monkeypatch):
    """A writer that dies mid-write leaves no manifest and no temp
    directory a resume could trip on."""
    from mxnet_tpu_torch import faults

    monkeypatch.setenv("MXTPU_FAULT_PLAN", "ckpt_write:err:1")
    faults.reset()
    w = ckpt.save(str(tmp_path), 1, {"x": np.ones(3)}, background=True)
    with pytest.raises(faults.InjectedFault, match="ckpt_write"):
        w.wait()
    assert ckpt.list_checkpoints(str(tmp_path)) == []
    assert not [n for n in os.listdir(tmp_path) if n.startswith(".tmp")]
    monkeypatch.undo()
    faults.reset()
    ckpt.save(str(tmp_path), 2, {"x": np.ones(3)}, background=False)
    assert [s for s, _ in ckpt.list_checkpoints(str(tmp_path))] == [2]


def test_corrupt_checkpoint_falls_back_with_warning(tmp_path, caplog):
    ckpt.save(str(tmp_path), 1, {"x": np.full(8, 1.0)}, background=False)
    ckpt.save(str(tmp_path), 2, {"x": np.full(8, 2.0)}, background=False)
    newest = ckpt.list_checkpoints(str(tmp_path))[-1][1]
    fname = ckpt.validate(newest)["arrays"]["x"]["file"]
    with open(os.path.join(newest, fname), "r+b") as f:
        f.seek(-3, os.SEEK_END)
        f.write(b"\xff\xff\xff")
    with pytest.raises(ckpt.CheckpointCorrupt):
        ckpt.validate(newest)
    import logging

    with caplog.at_level(logging.WARNING, "mxnet_tpu_torch.checkpoint"):
        best = ckpt.latest(str(tmp_path))
    assert best is not None and best.endswith("ckpt-000000000001")
    assert any("corrupt" in r.message for r in caplog.records)
    arrays, _ = ckpt.load(best)
    np.testing.assert_array_equal(arrays["x"], np.full(8, 1.0))


def test_truncated_manifest_falls_back(tmp_path):
    ckpt.save(str(tmp_path), 1, {"x": np.zeros(4)}, background=False)
    ckpt.save(str(tmp_path), 2, {"x": np.ones(4)}, background=False)
    newest = ckpt.list_checkpoints(str(tmp_path))[-1][1]
    with open(os.path.join(newest, ckpt.MANIFEST), "r+b") as f:
        f.truncate(20)
    assert ckpt.latest(str(tmp_path)).endswith("ckpt-000000000001")


def test_retention_prunes_oldest(tmp_path):
    for step in range(1, 6):
        ckpt.save(str(tmp_path), step, {"x": np.full(4, step)}, keep=2,
                  background=False)
    assert [s for s, _ in ckpt.list_checkpoints(str(tmp_path))] == [4, 5]


def test_manager_due_and_single_inflight_writer(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), every=4, keep=2)
    assert not mgr.due(3)
    assert mgr.due(4)
    w = mgr.save(4, {"x": np.zeros(4)})
    assert not mgr.due(4)
    mgr.wait()
    assert w.exc is None


# ------------------------------------------------- FusedTrainer resume
def test_fused_trainer_kill_resume_step_parity(tmp_path):
    X, Y = _data()
    t1 = _trainer()
    _steps(t1, 0, 10, X, Y)
    t2 = _trainer()
    _steps(t2, 0, 6, X, Y)
    t2.save_state(str(tmp_path), epoch=0, nbatch=5, background=True).wait()
    t3 = _trainer()
    meta = t3.restore_state(str(tmp_path))
    assert meta["step"] == 6
    _steps(t3, 6, 10, X, Y)
    _same(t1.params, t3.params)
    for k, slots in t1.opt_state.items():
        for i, s in enumerate(slots):
            torch.testing.assert_close(s, t3.opt_state[k][i], rtol=0,
                                       atol=0)


def test_restore_rejects_signature_mismatch(tmp_path):
    t = _trainer()
    t.save_state(str(tmp_path), background=False)
    other = FusedTrainer(
        tsym.SoftmaxOutput(tsym.FullyConnected(
            tsym.Variable("data"), num_hidden=4), name="softmax"),
        optimizer="adam", device=CPU)
    other.init(data=(8, 8), softmax_label=(8,))
    with pytest.raises(ckpt.CheckpointError, match="different graph"):
        other.restore_state(str(tmp_path))


def test_fused_trainer_fit_resume_mid_epoch(tmp_path):
    X, Y = _data(n=80)

    def run(interrupt_after=None, resume=None):
        it = tmx.io.NDArrayIter(X, Y, batch_size=8, shuffle=False)
        t = _trainer()
        cb = None
        if interrupt_after is not None:
            def cb(param):
                if param.nbatch == interrupt_after:
                    raise KeyboardInterrupt
        mgr = ckpt.CheckpointManager(str(tmp_path), every=3, keep=5)
        try:
            t.fit(it, num_epoch=1, batch_end_callback=cb, checkpoint=mgr,
                  resume=resume)
        except KeyboardInterrupt:
            mgr.wait()
        return t

    straight = {k: v.clone() for k, v in run().params.items()}
    import shutil

    shutil.rmtree(tmp_path)
    os.makedirs(tmp_path)
    run(interrupt_after=7)
    assert ckpt.latest(str(tmp_path)) is not None
    _same(straight, run(resume=True).params)


def test_preempt_flag_saves_boundary_checkpoint(tmp_path):
    X, Y = _data()
    it = tmx.io.NDArrayIter(X, Y, batch_size=8, shuffle=False)
    t = _trainer()
    mgr = ckpt.CheckpointManager(str(tmp_path), every=0, keep=3)

    def cb(param):
        if param.nbatch == 2:
            mgr.preempted = True  # what the SIGTERM handler sets

    with pytest.raises(ckpt.Preempted, match="resume"):
        t.fit(it, num_epoch=1, batch_end_callback=cb, checkpoint=mgr)
    _, manifest = ckpt.load(ckpt.latest(str(tmp_path)))
    assert manifest["meta"]["nbatch"] == 3


# -------------------------------------------------------- Module resume
def _module_run(tmp_path, X, Y, num_epoch=2, resume=None, every=3,
                interrupt_at=None, optimizer="adam", kvstore="local"):
    it = tmx.io.NDArrayIter(X, Y, batch_size=8, shuffle=False)
    mod = tmx.mod.Module(_mlp(), context=tmx.cpu())
    cb = None
    if interrupt_at is not None:
        def cb(param):
            if (param.epoch, param.nbatch) == interrupt_at:
                raise KeyboardInterrupt
    mgr = ckpt.CheckpointManager(str(tmp_path), every=every, keep=8)
    try:
        mod.fit(it, optimizer=optimizer, kvstore=kvstore,
                optimizer_params=(("learning_rate", 0.05),),
                num_epoch=num_epoch, arg_params=_fixed_params(),
                checkpoint=mgr, resume=resume, batch_end_callback=cb)
    except KeyboardInterrupt:
        mgr.wait()
    arg, _ = mod.get_params()
    return {k: v.asnumpy() for k, v in arg.items()}


@pytest.mark.parametrize("route", ["updater", "store"])
def test_module_fit_kill_resume_parity(tmp_path, route):
    """Both update routes (the module's own updater; a store with the
    bucketed update): an interrupted and resumed run equals the straight
    one bit for bit."""
    X, Y = _data(n=64)
    kv = (lambda: "local") if route == "updater" else \
        (lambda: tmx.kv.create("local"))
    straight = _module_run(tmp_path / "a", X, Y, kvstore=kv())
    _module_run(tmp_path / "b", X, Y, interrupt_at=(1, 2), kvstore=kv())
    resumed = _module_run(tmp_path / "b", X, Y, resume=True, kvstore=kv())
    for k in straight:
        np.testing.assert_array_equal(straight[k], resumed[k], err_msg=k)


def test_module_resume_of_finished_run_is_noop(tmp_path):
    X, Y = _data(n=64)
    first = _module_run(tmp_path, X, Y)
    again = _module_run(tmp_path, X, Y, resume=True)
    for k in first:
        np.testing.assert_array_equal(first[k], again[k], err_msg=k)


def test_module_checkpoint_carries_the_loss_scaler(tmp_path, monkeypatch):
    """Under AMP loss scaling the scaler's state rides in the checkpoint
    (``amp/scale`` and its counters) and comes back on resume."""
    from mxnet_tpu_torch import amp as tamp

    monkeypatch.setenv("MXTPU_AMP", "bf16")
    monkeypatch.setenv("MXTPU_LOSS_SCALE", "dynamic")
    tamp.reset_scaler()
    try:
        X, Y = _data(n=32)
        _module_run(tmp_path, X, Y, num_epoch=1, every=2,
                    kvstore=tmx.kv.create("local"))
        arrays, _ = ckpt.load(ckpt.latest(str(tmp_path)))
        assert "amp/scale" in arrays
        want = float(arrays["amp/scale"])
        tamp.global_scaler()._scale.fill_(1.0)
        mod = tmx.mod.Module(_mlp(), context=tmx.cpu())
        mod.bind(data_shapes=[("data", (8, 8))],
                 label_shapes=[("softmax_label", (8,))])
        mod.init_params(arg_params=_fixed_params())
        mod.init_optimizer(kvstore=tmx.kv.create("local"), optimizer="adam")
        mod._restore_checkpoint(*ckpt.load(ckpt.latest(str(tmp_path))))
        assert float(tamp.global_scaler()._scale) == want
    finally:
        tamp.reset_scaler()


# ------------------------------------------------ zero host syncs armed
def test_ckpt_armed_keeps_zero_per_batch_syncs(tmp_path, monkeypatch):
    """``MXTPU_CKPT_EVERY`` armed adds no host read a batch: the capture
    clones behind the queued steps and the writer does the rest.  The
    writer's reads (on its thread, or in its place for the synchronous
    boundary saves) are the checkpoint's own, not the loop's, and are not
    counted."""
    import threading

    monkeypatch.setenv("MXTPU_CKPT_DIR", str(tmp_path))
    monkeypatch.setenv("MXTPU_CKPT_EVERY", "2")
    main = threading.main_thread()
    counts = {"n": 0}
    names = ("item", "cpu", "tolist", "numpy", "__bool__", "__float__",
             "__int__")

    def in_writer():
        f = sys._getframe(2)
        while f is not None:
            if (f.f_code.co_name == "_write"
                    and f.f_code.co_filename == ckpt.__file__):
                return True
            f = f.f_back
        return False

    def count(fn):
        def wrapper(*a, **k):
            if threading.current_thread() is main and not in_writer():
                counts["n"] += 1
            return fn(*a, **k)
        return wrapper

    def run(nbatch):
        counts["n"] = 0
        X, Y = _data(n=8 * nbatch)
        it = tmx.io.NDArrayIter(X, Y, batch_size=8, shuffle=False)
        mod = tmx.mod.Module(_mlp(), context=tmx.cpu())
        with monkeypatch.context() as mp:
            for n in names:
                mp.setattr(torch.Tensor, n, count(getattr(torch.Tensor, n)))
            mod.fit(it, optimizer="sgd",
                    optimizer_params=(("learning_rate", 0.1),), num_epoch=1,
                    arg_params=_fixed_params())
        return counts["n"]

    small = run(4)
    large = run(16)
    assert large == small, (small, large)
    assert ckpt.list_checkpoints(str(tmp_path))


# --------------------------------------------------- a real SIGKILL
_KILL_SCRIPT = textwrap.dedent("""
    import os, sys, json
    import numpy as np
    sys.path.insert(0, {repo!r})
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import checkpoint as ck

    mode, ckdir, outfile = sys.argv[1:4]

    def net():
        d = mx.sym.Variable("data")
        fc1 = mx.sym.FullyConnected(d, num_hidden=16, name="fc1")
        a = mx.sym.Activation(fc1, act_type="relu")
        fc2 = mx.sym.FullyConnected(a, num_hidden=4, name="fc2")
        return mx.sym.SoftmaxOutput(fc2, name="softmax")

    rs = np.random.RandomState(0)
    X = rs.randn(96, 8).astype(np.float32)
    Y = (rs.rand(96) * 4).astype(np.float32)
    it = mx.io.NDArrayIter(X, Y, batch_size=8, shuffle=False)
    mx.random.seed(7)
    mod = mx.mod.Module(net(), context=mx.cpu())
    mgr = ck.CheckpointManager(ckdir, every=3, keep=10)
    cb = None
    if mode == "victim":
        def cb(param):
            if param.epoch == 1 and param.nbatch == 4:
                # killable only once a complete checkpoint is published:
                # wait for the writer, then say so and stop here
                mgr.wait()
                assert ck.latest(ckdir) is not None
                print("KILLME", flush=True)
                import time
                time.sleep(120)
    if mode == "preempt":
        def cb(param):
            if param.epoch == 0 and param.nbatch == 2:
                print("TERMME", flush=True)
                import time
                # wait here for the SIGTERM the parent sends
                while not mgr.preempted:
                    time.sleep(0.01)
    try:
        mod.fit(it, num_epoch=2, optimizer="adam",
                optimizer_params={{"learning_rate": 0.05}},
                initializer=mx.init.Xavier(), checkpoint=mgr,
                resume=(mode == "resume"), batch_end_callback=cb)
    except ck.Preempted as e:
        print("PREEMPTED", e, flush=True)
        sys.exit(3)
    arg, _ = mod.get_params()
    with open(outfile, "w") as f:
        json.dump({{k: v.asnumpy().tolist() for k, v in arg.items()}}, f)
    print("DONE", flush=True)
""")


def _child(script, mode, ckdir, outfile, marker=None, sig=None):
    proc = subprocess.Popen(
        [sys.executable, str(script), mode, str(ckdir), str(outfile)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    if marker is None:
        out, _ = proc.communicate(timeout=240)
        return proc.returncode, out
    lines = []
    for line in proc.stdout:  # waits on the marker, never on a sleep
        lines.append(line)
        if marker in line:
            break
    else:
        proc.wait(timeout=60)
        pytest.fail(f"{mode} child ended without {marker}: "
                    + "".join(lines)[-3000:])
    os.kill(proc.pid, sig)
    out, _ = proc.communicate(timeout=120)
    return proc.returncode, "".join(lines) + out


def test_subprocess_sigkill_resume_parity(tmp_path):
    """SIGKILL a Module.fit run mid-epoch after a published checkpoint,
    resume it in a new process, and land on the uninterrupted run's
    parameters bit for bit; a SIGTERM leaves a boundary checkpoint and
    the run ends by ``Preempted``."""
    script = tmp_path / "train.py"
    script.write_text(_KILL_SCRIPT.format(repo=REPO))
    rc, out = _child(script, "straight", tmp_path / "ck_straight",
                     tmp_path / "straight.json")
    assert rc == 0, out[-3000:]
    ckdir = tmp_path / "ck"
    rc, out = _child(script, "victim", ckdir, tmp_path / "unused.json",
                     marker="KILLME", sig=signal.SIGKILL)
    assert rc == -signal.SIGKILL, out[-3000:]
    assert ckpt.latest(str(ckdir)) is not None
    rc, out = _child(script, "resume", ckdir, tmp_path / "resumed.json")
    assert rc == 0, out[-3000:]
    straight = json.loads((tmp_path / "straight.json").read_text())
    resumed = json.loads((tmp_path / "resumed.json").read_text())
    assert straight.keys() == resumed.keys()
    for k in straight:
        np.testing.assert_array_equal(np.asarray(straight[k]),
                                      np.asarray(resumed[k]), err_msg=k)
    pdir = tmp_path / "ck_term"
    rc, out = _child(script, "preempt", pdir, tmp_path / "unused2.json",
                     marker="TERMME", sig=signal.SIGTERM)
    assert rc == 3 and "PREEMPTED" in out, out[-3000:]
    _, manifest = ckpt.load(ckpt.latest(str(pdir)))
    # the boundary after the signal: the next batch's step, then the save
    assert (manifest["meta"]["epoch"], manifest["meta"]["nbatch"]) == (0, 3)


def test_resume_counts_telemetry(tmp_path):
    from mxnet_tpu_torch import telemetry as ttm

    was = ttm.enabled()
    ttm.enable()
    try:
        fam0 = {f.name: f for f in ttm.get_registry().collect()}
        before = sum(v for _, v in fam0["checkpoint_resume_total"].samples())
        t = _trainer()
        X, Y = _data()
        _steps(t, 0, 2, X, Y)
        t.save_state(str(tmp_path), background=False)
        _trainer().restore_state(str(tmp_path))
        fam = {f.name: f for f in ttm.get_registry().collect()}
        assert sum(v for _, v in fam["checkpoint_resume_total"].samples()) \
            >= before + 1
        assert "checkpoint_write_seconds" in fam
        assert sum(v for _, v in fam["checkpoint_bytes_total"].samples()) > 0
    finally:
        ttm.enable(was)


# ------------------------------------------------- across the packages
def _conv(s):
    d = s.Variable("data")
    c = s.Convolution(d, name="conv1", kernel=(3, 3), num_filter=4,
                      no_bias=True)
    b = s.BatchNorm(c, name="bn1", fix_gamma=False)
    a = s.Activation(b, act_type="relu")
    f = s.FullyConnected(s.Flatten(a), name="fc", num_hidden=3)
    return s.SoftmaxOutput(f, name="softmax")


@pytest.fixture
def _fp32_convs(monkeypatch):
    monkeypatch.setenv("MXTPU_CONV_PRECISION", "float32")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_packages(tmp_path, _fp32_convs, direction):
    """A survival checkpoint written by one package's FusedTrainer is
    restored by the other's (the JAX trainer stores the conv weight
    HWIO, the port OIHW: the ``hwio`` meta relays it out); the next
    step's outputs and parameters agree to 1e-5."""
    shapes = {"data": (4, 2, 6, 6), "softmax_label": (4,)}
    jt = JTrainer(_conv(jmx.sym), optimizer="adam",
                  optimizer_params={"lr": 0.01})
    jt.init(**shapes)
    tt = FusedTrainer(_conv(tsym), optimizer="adam",
                      optimizer_params={"lr": 0.01}, device=CPU).init(
        **shapes)
    assert "conv1_weight" in jt._hwio
    assert jt._exec_symbol.structural_signature() == tt.structural_signature()
    rs = np.random.RandomState(0)
    x = rs.randn(4, 2, 6, 6).astype(np.float32)
    y = np.array([0, 1, 2, 1], np.float32)
    if direction == "jax_to_port":
        for _ in range(2):
            jt.step(data=x, softmax_label=y)
        jt.save_state(str(tmp_path), background=False)
        meta = tt.restore_state(str(tmp_path))
    else:
        for _ in range(2):
            tt.step(data=x, softmax_label=y)
        tt.save_state(str(tmp_path), background=False)
        meta = jt.restore_state(str(tmp_path))
    assert meta["step"] == 2 and jt._step == tt._step == 2
    jo = np.asarray(jt.step(data=x, softmax_label=y)[0])
    to = tt.step(data=x, softmax_label=y)[0].numpy()
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    jarg, _ = jt.get_params()
    targ, _ = tt.get_params()
    for k in targ:
        np.testing.assert_allclose(targ[k].numpy(), jarg[k].asnumpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_hwio_relayout(tmp_path):
    """A checkpoint whose meta names a conv weight stored HWIO (as the
    JAX trainer stores it) is relaid to OIHW, optimizer slots too."""
    tt = FusedTrainer(_conv(tsym), optimizer="sgd",
                      optimizer_params={"lr": 0.1, "momentum": 0.9},
                      device=CPU).init(data=(2, 2, 6, 6), softmax_label=(2,))
    arrays = {k: v.clone() for k, v in tt._checkpoint_arrays().items()}
    rs = np.random.RandomState(4)
    oihw = rs.randn(*tt.params["conv1_weight"].shape).astype(np.float32)
    arrays["param/conv1_weight"] = np.transpose(oihw, (2, 3, 1, 0))
    arrays["opt/conv1_weight/0"] = np.transpose(2 * oihw, (2, 3, 1, 0))
    meta = tt._checkpoint_meta()
    meta["hwio"] = ["conv1_weight"]
    ckpt.save(str(tmp_path), 1, arrays, meta=meta, background=False)
    tt.restore_state(str(tmp_path))
    np.testing.assert_array_equal(tt.params["conv1_weight"].numpy(), oihw)
    np.testing.assert_array_equal(tt.opt_state["conv1_weight"][0].numpy(),
                                  2 * oihw)


_ZOO = ["alexnet", "vgg", "googlenet", "inception-bn", "inception-v3",
        "inception-resnet-v2", "resnext-50", "resnet-50", "resnet-152",
        "mlp", "lenet", "transformer-lm"]


@pytest.mark.parametrize("name", _ZOO)
def test_signature_is_the_references_on_the_zoo(name):
    """Built natively in each package, every zoo graph hashes to the
    reference's digest, as does its JSON read back by the port."""
    j = jmodels.get_symbol(name)
    t = tmodels.get_symbol(name)
    assert t.structural_signature() == j.structural_signature()
    assert tsym.load_json(j.tojson()).structural_signature() == \
        jmx.sym.load_json(j.tojson()).structural_signature()


def test_signature_is_the_references_on_sparse_mf():
    sys.path.insert(0, os.path.join(REPO, "examples", "recommenders"))
    try:
        import sparse_mf
    finally:
        sys.path.pop(0)
    j = sparse_mf.build()
    t = tsym.load_json(j.tojson())
    assert t.structural_signature() == \
        jmx.sym.load_json(j.tojson()).structural_signature()
    uw = tsym.Variable("user_embed_weight", grad_stype="row_sparse")
    assert uw.list_attr() == {"__grad_stype__": "row_sparse"}


def test_unported_module_resume_raises():
    """A module with no checkpoint provider refuses ``resume=``."""
    from mxnet_tpu_torch.module import PythonLossModule

    mod = PythonLossModule()
    with pytest.raises(MXNetError):
        mod.fit(tmx.io.NDArrayIter(*_data(n=8), batch_size=8),
                num_epoch=1, checkpoint="unused", resume=True)

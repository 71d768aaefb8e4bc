"""The port's multi-process runtime (``mxnet_tpu_torch.parallel.dist``)
and launcher (``python -m mxnet_tpu_torch.launch``), the cases of
``tests/test_dist.py:492-560, 680-720`` on ``torch.distributed``:
``init_from_env``'s validation, the barrier watchdog's named
``HostLostError``, the ``dist_barrier`` drop, ``elastic_main``'s exit 43,
a real 2-process gloo barrier, and the launcher's ``--max-restarts`` and
refusals.  Imports no JAX.
"""
import os
import socket
import subprocess
import sys
import textwrap
import time

import pytest

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import faults
from mxnet_tpu_torch.parallel import dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MXTPU_", "DMLC_"))}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)
    env.update(extra)
    return env


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_init_from_env_validation(monkeypatch):
    """A bad rank or coordinator address is a named error before any
    rendezvous could hang."""
    monkeypatch.setenv("MXTPU_COORDINATOR", "127.0.0.1:9999")
    monkeypatch.setenv("MXTPU_NUM_WORKERS", "2")
    monkeypatch.setenv("MXTPU_RANK", "2")
    with pytest.raises(MXNetError, match="MXTPU_RANK=2 out of range"):
        dist.init_from_env()
    monkeypatch.setenv("MXTPU_RANK", "-1")
    with pytest.raises(MXNetError, match="out of range"):
        dist.init_from_env()
    monkeypatch.setenv("MXTPU_RANK", "zero")
    with pytest.raises(MXNetError, match="must be integers"):
        dist.init_from_env()
    monkeypatch.setenv("MXTPU_RANK", "0")
    for bad in ("localhost", "host:notaport", "host:0", ":8476"):
        monkeypatch.setenv("MXTPU_COORDINATOR", bad)
        with pytest.raises(MXNetError, match="host:port"):
            dist.init_from_env()
    # one worker, or no coordinator: nothing to bring up
    monkeypatch.setenv("MXTPU_NUM_WORKERS", "1")
    dist.init_from_env()
    assert (dist.rank(), dist.num_workers(), dist.log_prefix()) == (0, 1, "")
    assert not dist.is_multi_host()


def test_barrier_watchdog_raises_named_host_lost(monkeypatch):
    """A dead peer parks the collective for good; the watchdog names
    rank and generation within the timeout."""
    monkeypatch.setattr(dist, "_world_size", lambda: 2)
    monkeypatch.setattr(dist, "_sync_global_devices",
                        lambda name: time.sleep(60))
    monkeypatch.setenv("MXTPU_DIST_GENERATION", "7")
    monkeypatch.setenv("MXTPU_RANK", "1")
    t0 = time.monotonic()
    with pytest.raises(dist.HostLostError) as ei:
        dist.barrier("t1_watchdog", timeout=0.3)
    assert time.monotonic() - t0 < 10
    assert ei.value.site == "barrier"
    assert ei.value.generation == 7 and ei.value.rank == 1
    assert "timed out" in str(ei.value)
    assert isinstance(ei.value, MXNetError)
    # a healthy barrier under the watchdog passes
    monkeypatch.setattr(dist, "_sync_global_devices", lambda name: None)
    dist.barrier("t1_ok", timeout=5.0)


def test_barrier_fault_injection_drop(monkeypatch):
    """``dist_barrier:drop`` is a dead peer without the wait."""
    monkeypatch.setattr(dist, "_world_size", lambda: 2)
    monkeypatch.setattr(dist, "_sync_global_devices", lambda name: None)
    monkeypatch.setenv("MXTPU_FAULT_PLAN", "dist_barrier:drop_first:1")
    faults.reset()
    try:
        with pytest.raises(dist.HostLostError, match="injected"):
            dist.barrier("t2")
        dist.barrier("t2")  # fails once, recovers
    finally:
        monkeypatch.delenv("MXTPU_FAULT_PLAN")
        faults.reset()


ELASTIC_CHILD = textwrap.dedent("""
    import sys
    from mxnet_tpu_torch.parallel import dist

    def main():
        if sys.argv[1] == "lost":
            raise dist.GenerationChanged("membership", host="c:1",
                                         detail="generation 0 -> 1")
        if sys.argv[1] == "crash":
            raise RuntimeError("a crash, not a membership change")
        print("generation", dist.generation(), "done", flush=True)

    dist.elastic_main(main)
""")


@pytest.mark.parametrize("mode,rc", [("lost", 43), ("crash", 1),
                                     ("ok", 0)])
def test_elastic_main_exit_contract(tmp_path, mode, rc):
    script = tmp_path / "child.py"
    script.write_text(ELASTIC_CHILD)
    proc = subprocess.run([sys.executable, str(script), mode],
                          env=_env(MXTPU_DIST_GENERATION="3"),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == rc, proc.stderr[-2000:]
    assert dist.EXIT_HOST_LOST == 43
    if mode == "ok":
        assert "generation 3 done" in proc.stdout


GLOO_CHILD = textwrap.dedent("""
    import time
    from mxnet_tpu_torch.parallel import dist

    dist.init_from_env()
    dist.init_from_env()          # a second call is a no-op
    if dist.rank() == 1:
        time.sleep(1.0)           # the barrier waits for the late rank
    t0 = time.monotonic()
    dist.barrier("gloo_test", timeout=60)
    print("rank", dist.rank(), "of", dist.num_workers(), "waited",
          round(time.monotonic() - t0, 2), "prefix", repr(dist.log_prefix()),
          "multi", dist.is_multi_host(), flush=True)
""")


def test_two_process_gloo_barrier(tmp_path):
    script = tmp_path / "gloo.py"
    script.write_text(GLOO_CHILD)
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(script)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        env=_env(MXTPU_COORDINATOR=coord, MXTPU_NUM_WORKERS="2",
                 MXTPU_RANK=str(r), MXTPU_DIST_GENERATION="2"))
        for r in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=120)
        outs.append(out)
        assert p.returncode == 0, out[-2000:]
    lines = [next(line for line in o.splitlines() if line.startswith("rank"))
             for o in outs]
    assert lines[0].startswith("rank 0 of 2") and \
        lines[1].startswith("rank 1 of 2")
    # rank 0 waited for the late rank 1 at the barrier
    assert float(lines[0].split()[5]) >= 0.5
    assert "prefix '[0/2@g2] '" in lines[0] and "multi True" in lines[0]


def test_launch_max_restarts_and_refusals(tmp_path):
    """``--max-restarts`` restarts a crashed worker with
    ``MXTPU_KV_RECOVERY=1``, logging its rank and exit code; ``pod`` and
    ``elastic`` are refused by name."""
    marker = tmp_path / "crashed_once"
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(f"""
        import os, pathlib, sys
        marker = pathlib.Path({str(marker)!r})
        if os.environ.get("MXTPU_RANK") == "1" and not marker.exists():
            marker.write_text("x")
            sys.exit(9)          # the first life crashes
        if marker.exists() and os.environ.get("MXTPU_RANK") == "1":
            assert os.environ.get("MXTPU_KV_RECOVERY") == "1", os.environ
            assert os.environ["DMLC_RANK"] == "1"
        assert os.environ["MXTPU_NUM_WORKERS"] == "2"
        sys.exit(0)
    """))
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "2",
           "-s", "0"]
    proc = subprocess.run(
        cmd + ["--max-restarts", "1", "--launcher", "local",
               sys.executable, str(script)],
        env=_env(), cwd=REPO, timeout=120, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    log = proc.stdout + proc.stderr
    assert "worker 1 exited with code 9" in log
    assert "MXTPU_KV_RECOVERY=1" in log
    for launcher in ("pod", "elastic"):
        proc = subprocess.run(
            cmd + ["--launcher", launcher, sys.executable, str(script)],
            env=_env(), cwd=REPO, timeout=120, capture_output=True,
            text=True)
        assert proc.returncode != 0
        assert "ROADMAP Queue 1 item 10b" in proc.stderr

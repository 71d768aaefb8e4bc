"""Cluster launcher of the port (mirrors the JAX repo's
``tools/launch.py:62-215, 443-482``; parity: MXNet's tools/launch.py and
the dmlc-core tracker)::

    python -m mxnet_tpu_torch.launch -n 2 -s 2 --launcher local \\
        python train.py --kv-store dist_sync

spawns ``-n`` worker and ``-s`` server processes that run the same
command, their roles given by the environment (``_role_env``): every
process gets ``MXTPU_ROLE``, ``MXTPU_NUM_WORKERS``, ``MXTPU_NUM_SERVERS``
and ``MXTPU_PS_SERVERS`` (with the ``DMLC_*`` aliases); servers
``MXTPU_SERVER_RANK``, workers ``MXTPU_RANK``.  Without servers (``-s
0``) the workers form one process group (a mesh,
:mod:`~mxnet_tpu_torch.parallel.mesh`, or the collective ``dist_sync``
store): the local launcher binds its rendezvous store itself (a
``torch.distributed.TCPStore`` on a loopback port the system picks) and
holds it while the workers run, giving them ``MXTPU_COORDINATOR`` and
torch's ``TORCHELASTIC_USE_AGENT_STORE=True``, so every rank joins it as
a client.  A port picked by a bind-and-close probe and bound later by
rank 0 could be taken by another process in between.  A server detects its
role inside ``import mxnet_tpu_torch`` and serves
(:mod:`~mxnet_tpu_torch.kvstore_server`); it never touches the card.
The contract is the JAX launcher's, so either launcher drives either
package.

Launchers:

- ``local`` (default): every process on this host.  ``--max-restarts
  R`` restarts a crashed worker up to R times with
  ``MXTPU_KV_RECOVERY=1`` (the recovery contract of
  kvstore_dist.h:35-39: no re-init, no re-barrier; the servers still
  hold the model), logging the rank and exit code of every death.
- ``ssh``: one process per host of ``-H hostfile`` (round-robin), the
  same environment over ``ssh -q``; server ports are probed on the host
  that binds them.

``pod`` and ``elastic`` (the collective dist_sync on a mesh, with
generation restarts) wait for ROADMAP Queue 1 item 10b and are refused
by name.  The exit code is the workers' (the last non-zero one).
"""
from __future__ import annotations

import argparse
import logging
import os
import signal
import socket
import subprocess
import sys
import time

__all__ = ["main", "launch_local", "launch_ssh"]

_log = logging.getLogger("mxnet_tpu_torch.launch")


def _rendezvous_store(world_size):
    """The collective world's rendezvous store, bound and listening
    before any worker starts (the caller keeps it alive)."""
    import torch.distributed as td

    return td.TCPStore("127.0.0.1", 0, world_size, True,
                       wait_for_workers=False)


def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


_REMOTE_PROBE = (
    "import socket\n"
    "ss=[socket.socket() for _ in range({n})]\n"
    "[s.bind(('0.0.0.0',0)) for s in ss]\n"
    "print(','.join(str(s.getsockname()[1]) for s in ss))\n"
    "[s.close() for s in ss]\n"
)


def _remote_free_ports(host, n):
    """``n`` free ports on ``host``, the machine that will bind them."""
    if n <= 0:
        return []
    out = subprocess.run(
        ["ssh", "-q", "-o", "StrictHostKeyChecking=no", host,
         f"python3 -c \"{_REMOTE_PROBE.format(n=n)}\""],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise SystemExit(
            f"port probe on {host} failed (rc={out.returncode}): "
            f"{out.stderr.strip()[:500]}")
    return [int(p) for p in out.stdout.strip().split(",")]


def _role_env(base, role, rank, args, servers):
    env = dict(base)
    env.update({
        "MXTPU_ROLE": role,
        "MXTPU_NUM_WORKERS": str(args.num_workers),
        "MXTPU_NUM_SERVERS": str(args.num_servers),
        "MXTPU_PS_SERVERS": ",".join(servers),
        # the DMLC aliases, for scripts that read MXNet's names
        "DMLC_ROLE": role,
        "DMLC_NUM_WORKER": str(args.num_workers),
        "DMLC_NUM_SERVER": str(args.num_servers),
    })
    if role == "server":
        env["MXTPU_SERVER_RANK"] = str(rank)
    else:
        env["MXTPU_RANK"] = str(rank)
        env["DMLC_RANK"] = str(rank)
    return env


def launch_local(args, command):
    servers = [f"127.0.0.1:{p}" for p in _free_ports(args.num_servers)]
    base = dict(os.environ)
    store = None
    if not servers and args.num_workers > 1:
        # a collective world: its process group meets in this store,
        # which listens from now until this function returns
        store = _rendezvous_store(args.num_workers)
        base["MXTPU_COORDINATOR"] = f"127.0.0.1:{store.port}"
        base["TORCHELASTIC_USE_AGENT_STORE"] = "True"
    procs, workers = [], {}
    try:
        for i in range(args.num_servers):
            procs.append(subprocess.Popen(
                command, env=_role_env(base, "server", i, args, servers)))
        restarts = {i: args.max_restarts for i in range(args.num_workers)}
        for i in range(args.num_workers):
            workers[i] = subprocess.Popen(
                command, env=_role_env(base, "worker", i, args, servers))
        rc = 0
        pending = set(workers)
        while pending:
            time.sleep(0.2)
            for i, p in enumerate(procs):
                src = p.poll()
                if src not in (None, 0):
                    # the workers would wait on this server for good
                    _log.error("server %d exited with code %d; stopping "
                               "the workers", i, src)
                    for w in workers.values():
                        if w.poll() is None:
                            w.kill()
                            w.wait()
                    return src
            for rank in sorted(pending):
                wrc = workers[rank].poll()
                if wrc is None:
                    continue
                if wrc != 0 and restarts.get(rank, 0) > 0:
                    restarts[rank] -= 1
                    _log.warning(
                        "worker %d exited with code %d; restarting with "
                        "MXTPU_KV_RECOVERY=1 (%d restart(s) left)",
                        rank, wrc, restarts[rank])
                    env = _role_env(base, "worker", rank, args, servers)
                    # the servers still hold the model: the restarted
                    # worker must not re-init keys or wait on barriers
                    # the others passed long ago
                    env["MXTPU_KV_RECOVERY"] = "1"
                    workers[rank] = subprocess.Popen(command, env=env)
                    continue
                if wrc != 0:
                    _log.error("worker %d exited with code %d "
                               "(no restarts left)", rank, wrc)
                rc = wrc or rc
                pending.discard(rank)
        for i, p in enumerate(procs):
            try:
                src = p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                _log.error("server %d did not stop; killing it", i)
                p.kill()
                p.wait()
                src = 1
            if src != 0:
                _log.error("server %d exited with code %d", i, src)
                rc = rc or src
        return rc
    except BaseException:
        for p in procs + list(workers.values()):
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        raise


def launch_ssh(args, command):
    if not args.hostfile:
        raise SystemExit("--launcher ssh requires -H/--hostfile")
    with open(args.hostfile) as f:
        hosts = [h.strip() for h in f if h.strip() and not h.startswith("#")]
    # the server ranks go round-robin over the hosts, and each host is
    # asked for as many free ports as it will run servers
    server_hosts = [hosts[i % len(hosts)] for i in range(args.num_servers)]
    per_host = {}
    for h in server_hosts:
        per_host[h] = per_host.get(h, 0) + 1
    host_ports = {h: _remote_free_ports(h, n) for h, n in per_host.items()}
    servers = [f"{h}:{host_ports[h].pop(0)}" for h in server_hosts]
    procs = []
    cmd_str = " ".join(command)

    def remote(host, env):
        env_str = " ".join(f"{k}={v}" for k, v in env.items()
                           if k.startswith(("MXTPU_", "DMLC_")))
        return subprocess.Popen(
            ["ssh", "-q", "-o", "StrictHostKeyChecking=no", host,
             f"cd {os.getcwd()} && env {env_str} {cmd_str}"])

    for i in range(args.num_servers):
        procs.append(remote(server_hosts[i],
                            _role_env({}, "server", i, args, servers)))
    rc = 0
    workers = []
    for i in range(args.num_workers):
        p = remote(hosts[i % len(hosts)],
                   _role_env({}, "worker", i, args, servers))
        procs.append(p)
        workers.append(p)
    for p in workers:
        rc = p.wait() or rc
    for p in procs:
        if p.poll() is None:
            p.terminate()
    return rc


def _parser():
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.launch",
        description="launch parameter-server training: workers and "
                    "servers running one command")
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("-s", "--num-servers", type=int, default=0)
    ap.add_argument("--launcher", default="local",
                    choices=["local", "ssh", "pod", "elastic"])
    ap.add_argument("-H", "--hostfile", default=None)
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="restart a crashed worker up to N times "
                         "(MXTPU_KV_RECOVERY=1)")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    return ap


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s launch %(message)s")
    args = _parser().parse_args(argv)
    command = [c for c in args.command if c != "--"]
    if not command:
        raise SystemExit("no command given")
    if args.launcher in ("pod", "elastic"):
        raise SystemExit(
            f"--launcher {args.launcher}: the collective dist_sync and its "
            "elastic generations are not ported yet (ROADMAP Queue 1 item "
            "10b); use --launcher local or ssh with -s <servers>")
    if args.launcher == "ssh":
        return launch_ssh(args, command)
    return launch_local(args, command)


if __name__ == "__main__":
    sys.exit(main())

"""Cluster coordinator of the port: generation-epoch membership that
survives host death (mirrors ``mxnet_tpu/parallel/coordinator.py``, pure
stdlib; its HTTP JSON wire format is the JAX package's, so a client of
either package joins a service of either).

MXNet's parameter server tracked liveness through ps-lite heartbeats
(``KVStore::get_num_dead_node``); membership needs an authority beyond
one store: who is in the cluster, which epoch ("generation") of it is
current, and who died.

- :class:`CoordinatorService` is that authority (hosted by rank 0 on
  ``MXTPU_COORD_PORT``, by a launcher, or as ``python -m
  mxnet_tpu_torch.parallel.coordinator``).  Members hold **leases**
  (``MXTPU_COORD_LEASE_S``) refreshed by heartbeats on a dedicated
  thread; a lease that lapses declares the host dead, records it and
  **publishes the next generation**.  ``GET /cluster`` is the status
  JSON.
- **Fleet observability** (:mod:`~mxnet_tpu_torch.telemetry.fleet`):
  joins carry each member's telemetry endpoint
  (``MXTPU_TELEMETRY_HTTP_PORT``), so the service federates every
  member's ``/metrics.json`` on a background scrape and serves the
  merged, host-labeled view at ``GET /fleet``.  Heartbeats carry the
  members' per-step wall and dispatch times from the flight ring; the
  lease monitor computes the generation's step-time skew, publishes
  ``dist_step_skew_ratio`` / ``dist_straggler_host`` and names a
  sustained straggler in ``/cluster`` and ``/fleet``.  Heartbeat replies
  carry the service's wall clock, and the client records the
  RTT-midpoint clock offset (``telemetry.health.set_clock_offset``).
- :class:`CoordinatorClient`: every worker joins, heartbeats in the
  background, and polls :meth:`CoordinatorClient.step_poll` from the
  training loops (a host-side flag check: nothing on the card).  A
  published generation other than the joined one means the membership
  changed: the loop checkpoints at the boundary and raises
  :class:`~mxnet_tpu_torch.parallel.dist.GenerationChanged`.  A worker
  wedged in a dead collective never reaches its next poll, so the
  heartbeat thread is also a **watchdog**: once a change is published
  and the loop stays silent past ``MXTPU_DIST_BARRIER_TIMEOUT_S``, it
  dumps the flight record and exits
  :data:`~mxnet_tpu_torch.parallel.dist.EXIT_HOST_LOST`.

Fault sites: ``coord_heartbeat`` (a drop loses a heartbeat, so the
lease lapses at the service) and ``host_crash`` (``crash_after:n`` is a
SIGKILL-shaped death mid-training, fired from ``step_poll``).

Every RPC carries a socket timeout; an unreachable coordinator is a
named :class:`~mxnet_tpu_torch.parallel.dist.HostLostError`
(site ``coordinator``) at the next loop boundary, never a hang.
"""
from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time

from ..base import MXNetError
from .. import telemetry as _tm
from ..telemetry import fleet as _fleet
from .dist import (EXIT_HOST_LOST, GenerationChanged, HostLostError,
                   barrier_timeout_s)

__all__ = ["CoordinatorService", "CoordinatorClient", "coord_lease_s",
           "coord_addr", "maybe_start_from_env", "client_from_env"]

_logger = logging.getLogger("mxnet_tpu_torch.parallel.coordinator")

# --- telemetry families (the JAX package's names) ---------------------------
_TM_GEN = _tm.gauge(
    "dist_generation",
    "current cluster generation epoch (bumped on every membership "
    "change: lease-expiry death, rejoin announcement, clean leave)")
_TM_ALIVE = _tm.gauge(
    "dist_hosts_alive",
    "hosts holding a live coordinator lease in the current generation")
_TM_EXPIRED = _tm.counter(
    "coordinator_lease_expired_total",
    "host leases the coordinator declared dead (no heartbeat within "
    "MXTPU_COORD_LEASE_S); each expiry publishes the next generation")


def coord_lease_s() -> float:
    """MXTPU_COORD_LEASE_S — membership lease (default 10s).  Heartbeats
    go every lease/3; a host silent for a full lease is declared dead."""
    try:
        return max(float(os.environ.get("MXTPU_COORD_LEASE_S", "10")), 0.2)
    except ValueError:
        return 10.0


def coord_addr():
    """MXTPU_COORD_ADDR — ``host:port`` of the coordinator service (set
    by a launcher), or None."""
    return os.environ.get("MXTPU_COORD_ADDR", "").strip() or None


class CoordinatorService:
    """Membership + generation authority (one per cluster, on rank 0 or
    a launcher).  Thread-safe; start() binds the HTTP server
    on a daemon thread and returns self."""

    def __init__(self, port=None, lease_s=None, generation=0):
        self.lease_s = coord_lease_s() if lease_s is None else float(lease_s)
        self.port = int(os.environ.get("MXTPU_COORD_PORT", "0") or 0) \
            if port is None else int(port)
        self._lock = threading.Lock()
        self.generation = int(generation)
        # member id -> {host, pid, rank, beat (monotonic), generation}
        self._members = {}
        # members announced for the NEXT generation (rejoiners): they
        # hold no lease yet — they enter when the launcher relaunches
        self._standby = {}
        self._dead = []      # [{member, host, generation, time}]
        self._events = []    # bounded human-readable history
        self._srv = None
        self._stop = threading.Event()
        self._monitor = None
        self.started = time.time()
        # fleet plane: metrics federation over the members' advertised
        # telemetry endpoints, and the step-skew straggler state
        self.scraper = _fleet.FleetScraper(self._scrape_targets)
        self._straggler = None        # flagged {member, host, ratio, ...}
        self._skew = 0.0              # latest skew ratio (worst/median)
        self._strag_streaks = {}      # member -> consecutive hot sweeps

    # -- state transitions (all under _lock) -------------------------------
    def _bump(self, why):
        # race-ok: every caller (join/leave/expire_leases) already holds
        # self._lock around this helper; it is never called bare
        self.generation += 1
        self._events.append(
            {"time": time.time(), "generation": self.generation,
             "why": why})
        del self._events[:-64]
        if _tm.enabled():
            _TM_GEN.set(self.generation)
            _TM_ALIVE.set(len(self._members))
        _logger.warning("coordinator: generation -> %d (%s)",
                        self.generation, why)

    def join(self, member, host="?", pid=0, rank=-1, generation=None,
             standby=False, telemetry_addr=None, role="train"):
        """Register a member.  A normal join enters the CURRENT
        generation (bring-up: the launcher started this world).  A
        ``standby`` join is a rejoin announcement: the host is back but
        must enter at the next generation boundary — it is recorded,
        the generation is bumped so running members leave their step
        loops at the boundary, and the launcher relaunches everyone.
        ``telemetry_addr`` (``host:port`` of the member's /metrics
        server) opts the member into the fleet federation scrape.
        ``role`` distinguishes training hosts (``"train"``) from
        serving replicas (``"serve"``): the serving router
        folds ``role="serve"`` members into its replica registry, so a
        replica's lease IS its registration."""
        with self._lock:
            info = {"host": host, "pid": int(pid), "rank": int(rank),
                    "beat": time.monotonic(),
                    "role": str(role or "train"),
                    "telemetry": (str(telemetry_addr)
                                  if telemetry_addr else None),
                    "generation": self.generation if generation is None
                    else int(generation)}
            if standby:
                self._standby[member] = info
                self._bump(f"rejoin announced: {member}")
            else:
                self._members[member] = info
                self._standby.pop(member, None)
                if _tm.enabled():
                    _TM_ALIVE.set(len(self._members))
                    _TM_GEN.set(self.generation)
            return {"generation": self.generation,
                    "lease_s": self.lease_s, "ok": True}

    def heartbeat(self, member, generation=None, progress=None, steps=None):
        with self._lock:
            m = self._members.get(member)
            if m is not None:
                m["beat"] = time.monotonic()
                if progress is not None:
                    # batches trained this incarnation: the elastic
                    # launcher gates rejoin announcements on the shrunk
                    # world having made real progress
                    m["progress"] = int(progress)
                if isinstance(steps, dict):
                    # per-step wall/dispatch timings from the member's
                    # flight ring — the straggler-detection feed
                    m["steps"] = {k: float(v) for k, v in steps.items()
                                  if isinstance(v, (int, float))
                                  and not isinstance(v, bool)}
            # server_time lets the member estimate its clock offset from
            # the RTT midpoint (merge-trace's common timebase)
            return {"generation": self.generation,
                    "server_time": time.time(),
                    "ok": m is not None
                    and (generation is None
                         or int(generation) == self.generation)}

    def leave(self, member, why="leave"):
        with self._lock:
            was = self._members.pop(member, None)
            self._standby.pop(member, None)
            if was is not None and self._members:
                # remaining members must react to the shrink; an empty
                # cluster (normal completion) has nobody left to tell
                self._bump(f"{why}: {member}")
            elif _tm.enabled():
                _TM_ALIVE.set(len(self._members))
            return {"generation": self.generation, "ok": was is not None}

    def advance(self, generation, why="relaunch"):
        """Launcher-driven generation sync: a launcher is
        about to (re)launch the world as ``generation``.  The service
        adopts the counter (never going backwards) and clears every
        stale lease and standby entry — members of dead incarnations
        must not expire INTO the new generation and push it out."""
        with self._lock:
            self.generation = max(self.generation, int(generation))
            self._members.clear()
            self._standby.clear()
            self._events.append(
                {"time": time.time(), "generation": self.generation,
                 "why": why})
            del self._events[:-64]
            if _tm.enabled():
                _TM_GEN.set(self.generation)
                _TM_ALIVE.set(0)
            return {"generation": self.generation, "ok": True}

    def expire_leases(self):
        """Declare members whose lease lapsed dead; one generation bump
        per sweep (a simultaneous multi-host failure is ONE membership
        change).  Called by the monitor thread and by tests."""
        now = time.monotonic()
        with self._lock:
            dead = [mid for mid, m in self._members.items()
                    if now - m["beat"] > self.lease_s]
            for mid in dead:
                m = self._members.pop(mid)
                self._dead.append({"member": mid, "host": m["host"],
                                   "generation": m["generation"],
                                   "time": time.time()})
                del self._dead[:-64]
                if _tm.enabled():
                    _TM_EXPIRED.inc()
                _logger.warning(
                    "coordinator: lease expired for %s (host %s) — "
                    "declared dead", mid, m["host"])
            if dead:
                self._bump("lease expired: " + ",".join(sorted(dead)))
            return dead

    # -- fleet plane ---------------------------------------------------------
    def _scrape_targets(self):
        """Live members' advertised telemetry endpoints (the federation
        sweep's target list — dead leases drop out automatically)."""
        with self._lock:
            return {mid: m["telemetry"] for mid, m in self._members.items()
                    if m.get("telemetry")}

    def eval_straggler(self):
        """Per-generation straggler detection from heartbeat timings.

        Skew = the slowest member's mean step wall over the fleet
        median.  A member above ``MXTPU_STRAGGLER_RATIO`` for
        ``STRAGGLER_SUSTAIN`` consecutive monitor sweeps (one GC pause
        is not a sick host) is *named*: logged, flagged in ``/cluster``
        and ``/fleet``, and set in ``dist_straggler_host``.  Called by
        the lease-monitor thread every lease/4 — detection latency is
        well inside one federation scrape interval."""
        import statistics

        with self._lock:
            stats = {}
            for mid, m in self._members.items():
                s = m.get("steps") or {}
                if (s.get("count", 0) >= _fleet.STRAGGLER_MIN_STEPS
                        and s.get("step_wall_s", 0) > 0):
                    stats[mid] = float(s["step_wall_s"])
            if len(stats) < 2:
                self._set_straggler(None, 0.0)
                return None
            worst = max(stats, key=stats.get)
            # the fleet median EXCLUDES the candidate: on a 2-host world
            # max/median(all) is bounded below 2x no matter how sick the
            # slow host is, which would blind the default threshold
            median = statistics.median(
                [v for mid, v in stats.items() if mid != worst])
            ratio = stats[worst] / median if median > 0 else 0.0
            threshold = _fleet.straggler_ratio()
            if threshold > 1.0 and ratio >= threshold:
                self._strag_streaks = {
                    worst: self._strag_streaks.get(worst, 0) + 1}
            else:
                self._strag_streaks = {}
            flagged = (self._strag_streaks.get(worst, 0)
                       >= _fleet.STRAGGLER_SUSTAIN)
            info = None
            if flagged:
                m = self._members[worst]
                info = {"member": worst, "host": m["host"],
                        "rank": m["rank"], "generation": self.generation,
                        "step_wall_s": round(stats[worst], 6),
                        "fleet_median_s": round(median, 6),
                        "ratio": round(ratio, 3)}
            self._set_straggler(info, ratio)
            return self._straggler

    def _set_straggler(self, info, ratio):
        # every caller (eval_straggler) already holds self._lock around
        # this helper; it is never called bare
        self._skew = float(ratio)  # race-ok: caller holds self._lock
        prev = self._straggler
        self._straggler = info  # race-ok: caller holds self._lock
        if _tm.enabled():
            _fleet._TM_SKEW.set(self._skew)
            if prev and (info is None or info["member"] != prev["member"]):
                _fleet._TM_STRAGGLER.set(0, host=prev["member"])
            if info:
                _fleet._TM_STRAGGLER.set(1, host=info["member"])
        if info and (prev is None or prev["member"] != info["member"]):
            _logger.warning(
                "coordinator: straggler detected: %s (host %s) at %.2fx "
                "the fleet median step time (%.1fms vs %.1fms)",
                info["member"], info["host"], info["ratio"],
                info["step_wall_s"] * 1e3, info["fleet_median_s"] * 1e3)

    def fleet(self):
        """The ``GET /fleet`` JSON: per-host rows (membership + latest
        scrape status + heartbeat step timings), the merged host-labeled
        metric families, and the generation/straggler state — the one
        view that used to be N disconnected dashboards."""
        cl = self.cluster()
        snaps = self.scraper.snapshot()
        hosts = {}
        for mid, m in cl["members"].items():
            row = dict(m)
            s = snaps.get(mid)
            row["scrape_ok"] = bool(s and s.get("ok"))
            if s:
                row["scraped_at"] = s.get("at")
                if s.get("error"):
                    row["scrape_error"] = s["error"]
            hosts[mid] = row
        merged = _fleet.merge_snapshots(
            {mid: s.get("metrics") or {} for mid, s in snaps.items()
             if s.get("ok") and mid in cl["members"]})
        return {
            "generation": cl["generation"],
            "hosts_alive": cl["hosts_alive"],
            "straggler": cl["straggler"],
            "step_skew_ratio": cl["step_skew_ratio"],
            "scrape_interval_s": self.scraper.interval_s,
            "dead": cl["dead"],
            "hosts": hosts,
            "metrics": merged,
        }

    def cluster(self):
        """The ``/cluster`` status JSON."""
        now = time.monotonic()
        with self._lock:
            return {
                "generation": self.generation,
                "lease_s": self.lease_s,
                "hosts_alive": len(self._members),
                "members": {
                    mid: {"host": m["host"], "pid": m["pid"],
                          "rank": m["rank"],
                          "role": m.get("role", "train"),
                          "joined_generation": m["generation"],
                          "progress": m.get("progress", 0),
                          "telemetry": m.get("telemetry"),
                          "steps": m.get("steps"),
                          "lease_age_s": round(now - m["beat"], 3)}
                    for mid, m in self._members.items()},
                "standby": sorted(self._standby),
                "dead": list(self._dead),
                "straggler": self._straggler,
                "step_skew_ratio": round(self._skew, 3),
                "events": list(self._events),
                "uptime_s": round(time.time() - self.started, 3),
            }

    # -- HTTP ---------------------------------------------------------------
    def start(self, addr="127.0.0.1"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        svc = self

        class _Handler(BaseHTTPRequestHandler):
            def _reply(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path in ("/", "/cluster"):
                    self._reply(svc.cluster())
                elif path == "/fleet":
                    self._reply(svc.fleet())
                elif path == "/healthz":
                    self._reply({"status": "ok",
                                 "generation": svc.generation})
                else:
                    self.send_error(404)

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                try:
                    n = int(self.headers.get("Content-Length", "0") or 0)
                    msg = json.loads(self.rfile.read(n) or b"{}")
                    member = str(msg.get("member", ""))
                    if not member and path in ("/join", "/heartbeat",
                                               "/leave"):
                        raise ValueError("missing 'member'")
                    if path == "/join":
                        self._reply(svc.join(
                            member, host=str(msg.get("host", "?")),
                            pid=int(msg.get("pid", 0)),
                            rank=int(msg.get("rank", -1)),
                            generation=msg.get("generation"),
                            standby=bool(msg.get("standby", False)),
                            telemetry_addr=msg.get("telemetry"),
                            role=str(msg.get("role", "train"))))
                    elif path == "/heartbeat":
                        self._reply(svc.heartbeat(
                            member, generation=msg.get("generation"),
                            progress=msg.get("progress"),
                            steps=msg.get("steps")))
                    elif path == "/leave":
                        self._reply(svc.leave(
                            member, why=str(msg.get("why", "leave"))))
                    elif path == "/advance":
                        self._reply(svc.advance(
                            int(msg.get("generation", 0)),
                            why=str(msg.get("why", "relaunch"))))
                    else:
                        self.send_error(404)
                except (ValueError, TypeError, json.JSONDecodeError) as exc:
                    self._reply({"ok": False, "error": str(exc)}, code=400)

            def log_message(self, *args):
                pass

        srv = ThreadingHTTPServer((addr, self.port), _Handler)
        srv.daemon_threads = True
        self.port = srv.server_address[1]
        self._srv = srv
        threading.Thread(target=srv.serve_forever, daemon=True,
                         name="mxtpu-coordinator-http").start()
        if _tm.enabled():
            _TM_GEN.set(self.generation)
            _TM_ALIVE.set(0)

        def _monitor():
            interval = max(self.lease_s / 4.0, 0.05)
            while not self._stop.wait(interval):
                try:
                    self.expire_leases()
                    self.eval_straggler()
                except Exception:  # noqa: BLE001 — monitor must survive
                    _logger.exception("coordinator lease monitor failed")

        self._monitor = threading.Thread(target=_monitor, daemon=True,
                                         name="mxtpu-coordinator-leases")
        self._monitor.start()
        self.scraper.start()
        _logger.info("coordinator serving on %s:%d (lease %.1fs, fleet "
                     "scrape every %.1fs)", addr, self.port, self.lease_s,
                     self.scraper.interval_s)
        return self

    @property
    def address(self) -> str:
        return f"127.0.0.1:{self.port}" if self._srv is not None else ""

    def stop(self):
        self._stop.set()
        self.scraper.stop()
        if self._srv is not None:
            self._srv.shutdown()
            self._srv.server_close()
            self._srv = None


def _http_json(addr, path, payload=None, timeout=5.0):
    """One JSON RPC to the coordinator with a bounded socket timeout —
    a dead coordinator must surface as an error, never a hang."""
    import http.client

    host, port = str(addr).rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        if payload is None:
            conn.request("GET", path)
        else:
            body = json.dumps(payload).encode()
            conn.request("POST", path, body,
                         {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise MXNetError(f"coordinator {addr}{path}: HTTP "
                             f"{resp.status}: {data[:200]!r}")
        return json.loads(data)
    finally:
        conn.close()


class CoordinatorClient:
    """Worker-side membership: join + background heartbeats + the
    step-loop poll.  One per process; built by
    :func:`client_from_env` when a launcher armed
    ``MXTPU_COORD_ADDR``."""

    _MISS_LIMIT = 5  # consecutive heartbeat failures = coordinator lost

    def __init__(self, addr, member=None, rank=None, generation=None,
                 standby=False, telemetry_addr=None, role="train"):
        from . import dist as _dist

        self.addr = str(addr)
        self.rank = _dist._rank_or_env() if rank is None else int(rank)
        self.role = str(role or "train")
        self.member = member or f"rank{self.rank}:{socket.gethostname()}" \
                                f":{os.getpid()}"
        self.generation = (_dist.generation() if generation is None
                           else int(generation))
        self.lease_s = coord_lease_s()
        # advertised /metrics endpoint for the fleet federation scrape
        # (default: the import-time MXTPU_TELEMETRY_HTTP_PORT server)
        self.telemetry_addr = (telemetry_addr if telemetry_addr is not None
                               else _tm.http_address())
        self._changed_at = None       # monotonic time a bump was seen
        self._seen_generation = self.generation
        self._polls = 0               # batches polled this incarnation
        self._lost = False            # coordinator unreachable
        self._misses = 0
        self._polled = False          # loop is actively polling
        self._last_poll = time.monotonic()
        self._stop = threading.Event()
        self._hb = None
        reply = self._rpc("/join", {"member": self.member,
                                    "host": socket.gethostname(),
                                    "pid": os.getpid(), "rank": self.rank,
                                    "generation": self.generation,
                                    "standby": bool(standby),
                                    "role": self.role,
                                    "telemetry": self.telemetry_addr})
        self.lease_s = float(reply.get("lease_s", self.lease_s))
        self._observe_generation(int(reply["generation"]))
        if not standby:
            self._hb = threading.Thread(target=self._heartbeat_loop,
                                        daemon=True,
                                        name="mxtpu-coord-heartbeat")
            self._hb.start()

    def _rpc(self, path, payload=None):
        try:
            return _http_json(self.addr, path, payload,
                              timeout=max(self.lease_s, 2.0))
        except (OSError, MXNetError, ValueError) as exc:
            raise HostLostError(
                "coordinator", host=self.addr, rank=self.rank,
                generation=self.generation,
                dump=_tm.health.auto_dump("fault"),
                detail=f"coordinator RPC {path} failed: {exc!r}") from exc

    def _observe_generation(self, gen):
        if gen != self._seen_generation:
            self._seen_generation = gen
            if self._changed_at is None:
                self._changed_at = time.monotonic()

    # -- background heartbeats + wedge watchdog -----------------------------
    def _heartbeat_loop(self):
        from .. import faults as _faults

        interval = max(self.lease_s / 3.0, 0.05)
        while not self._stop.wait(interval):
            try:
                if _faults.should_drop("coord_heartbeat"):
                    continue  # simulated lost heartbeat: lease decays
                # step-timing feed: per-step wall/dispatch
                # means from the flight ring — pure host-side reads, so
                # the straggler signal costs the hot loop nothing
                t_send = time.time()
                reply = _http_json(self.addr, "/heartbeat",
                                   {"member": self.member,
                                    "generation": self.generation,
                                    "progress": self._polls,
                                    "steps":
                                        _tm.health.step_time_stats()},
                                   timeout=max(interval, 2.0))
                t_recv = time.time()
                self._misses = 0
                self._observe_generation(int(reply["generation"]))
                server_time = reply.get("server_time")
                if server_time is not None:
                    # clock-offset estimate via the RTT midpoint: the
                    # common timebase fleetstat merge-trace aligns on
                    _tm.health.set_clock_offset(
                        float(server_time) - (t_send + t_recv) / 2.0,
                        rtt_s=t_recv - t_send)
            except Exception:  # noqa: BLE001 — counted, surfaced at poll
                self._misses += 1
                if self._misses >= self._MISS_LIMIT:
                    self._lost = True
            # wedge watchdog: a membership change was published but the
            # training loop never reached its next poll — it is parked
            # inside a dead collective.  Past the barrier timeout the
            # way out is a named exit; the last periodic checkpoint is
            # the resume point.
            if (self._changed_at is not None and self._polled
                    and not self._stop.is_set()):
                wedged_s = time.monotonic() - max(self._changed_at,
                                                  self._last_poll)
                timeout = barrier_timeout_s()
                if timeout > 0 and wedged_s > timeout:
                    dump = _tm.health.auto_dump("fault")
                    _logger.error(
                        "generation %d -> %d published %.1fs ago and the "
                        "step loop never surfaced (wedged collective); "
                        "exiting %d for the launcher%s",
                        self.generation, self._seen_generation, wedged_s,
                        EXIT_HOST_LOST,
                        f" (flight record: {dump})" if dump else "")
                    os._exit(EXIT_HOST_LOST)

    # -- loop-facing API ----------------------------------------------------
    def changed(self) -> bool:
        """True once the coordinator published a different generation
        (host death or rejoin) — the loop must leave at this boundary."""
        return self._changed_at is not None

    def step_poll(self) -> bool:
        """Per-batch poll from the training loops: pure host-side flag
        reads (never touches the device).  Fires the ``host_crash``
        chaos site, surfaces a lost coordinator as a named error, and
        returns :meth:`changed`."""
        from .. import faults as _faults

        _faults.maybe_fail("host_crash")
        self._polled = True
        self._polls += 1
        self._last_poll = time.monotonic()
        if self._lost:
            raise HostLostError(
                "coordinator", host=self.addr, rank=self.rank,
                generation=self.generation,
                dump=_tm.health.auto_dump("fault"),
                detail=f"{self._MISS_LIMIT} consecutive heartbeats failed")
        return self.changed()

    def raise_generation_changed(self, ckpt_path=None):
        """Build + raise the named boundary error (the fit loops call
        this AFTER their boundary checkpoint landed)."""
        raise GenerationChanged(
            "membership", host=self.addr, rank=self.rank,
            generation=self._seen_generation,
            dump=_tm.health.auto_dump("fault"),
            detail="cluster generation "
                   f"{self.generation} -> {self._seen_generation}"
                   + (f"; checkpoint: {ckpt_path}" if ckpt_path else
                      "; resume from the latest checkpoint"))

    def cluster(self):
        return self._rpc("/cluster")

    def leave(self, why="leave"):
        self._stop.set()
        try:
            self._rpc("/leave", {"member": self.member, "why": why})
        except HostLostError:
            pass  # leaving a dead coordinator is still leaving

    def stop(self):
        self._stop.set()
        if self._hb is not None:
            self._hb.join(timeout=2.0)


_default_client = None
_default_lock = threading.Lock()


def client_from_env():
    """The process-wide client when ``MXTPU_COORD_ADDR`` is armed (the
    launcher sets it), else None.  Built once; the fit loops
    call this per run, not per batch."""
    global _default_client
    addr = coord_addr()
    if not addr:
        return None
    with _default_lock:
        if _default_client is None or _default_client.addr != addr:
            _default_client = CoordinatorClient(addr)
        return _default_client


def maybe_start_from_env(generation=None):
    """Rank 0 hosts the membership endpoint when ``MXTPU_COORD_PORT``
    is set (bring-up without a launcher's coordinator);
    returns the service or None."""
    from . import dist as _dist

    port = os.environ.get("MXTPU_COORD_PORT", "").strip()
    if not port or _dist._rank_or_env() != 0:
        return None
    svc = CoordinatorService(
        port=int(port),
        generation=_dist.generation() if generation is None else generation)
    return svc.start()


def _main(argv=None):
    """Standalone coordinator: ``python -m mxnet_tpu_torch.parallel.coordinator
    --port P [--lease S]``: a launcher's failure detector."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.parallel.coordinator",
        description="cluster coordinator (membership, generations, fleet)")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--lease", type=float, default=None)
    ap.add_argument("--generation", type=int, default=0)
    args = ap.parse_args(argv)
    svc = CoordinatorService(port=args.port, lease_s=args.lease,
                             generation=args.generation).start()
    print(f"coordinator ready on {svc.address}", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        svc.stop()


if __name__ == "__main__":
    _main()

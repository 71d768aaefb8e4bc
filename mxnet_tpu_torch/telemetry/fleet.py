"""Fleet observability plane: metrics federation + straggler knobs.

A copy of ``mxnet_tpu/telemetry/fleet.py`` (pure stdlib):

- :func:`fetch_json` / :func:`post_json` / :func:`fetch_spans` — one
  bounded HTTP call against a member endpoint (a dead member costs at
  most ``timeout``); the serving router scrapes each replica's
  ``/healthz``, fans out ``/admin/drain`` and federates
  ``/metrics.json`` through them.
- :class:`FleetScraper` — a background thread that scrapes each
  member's ``/metrics.json`` every ``MXTPU_FLEET_SCRAPE_S`` and keeps
  the latest per-member snapshot; :func:`merge_snapshots` folds those
  into host-labeled families (the router's ``GET /fleet``).
- the straggler knobs (``MXTPU_STRAGGLER_RATIO``,
  :data:`STRAGGLER_MIN_STEPS`, :data:`STRAGGLER_SUSTAIN`) and the
  ``dist_step_skew_ratio`` / ``dist_straggler_host`` families, which the
  coordinator (:mod:`mxnet_tpu_torch.parallel.coordinator`) publishes
  from its members' heartbeat step times.

The scrape loop is pure host-side HTTP and never touches the device.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time

from . import registry as _reg

__all__ = [
    "FleetScraper", "merge_snapshots", "fleet_scrape_s", "straggler_ratio",
    "fetch_json", "post_json", "fetch_spans",
    "STRAGGLER_MIN_STEPS", "STRAGGLER_SUSTAIN",
]

_logger = logging.getLogger("mxnet_tpu_torch.telemetry.fleet")

# --- telemetry families (docs/telemetry.md) --------------------------------
_TM_SKEW = _reg.gauge(
    "dist_step_skew_ratio",
    "per-generation step-time skew: the slowest member's mean step wall "
    "time over the median of the OTHER members (heartbeat-reported "
    "flight-ring timings); sustained values above MXTPU_STRAGGLER_RATIO "
    "flag a straggler")
_TM_STRAGGLER = _reg.gauge(
    "dist_straggler_host",
    "1 while the labeled member is flagged as the sustained straggler of "
    "the current generation (0 once it recovers or leaves)",
    labels=("host",))
_TM_SCRAPE = _reg.counter(
    "fleet_scrape_total",
    "per-member /metrics.json federation scrapes by the coordinator's "
    "fleet thread", labels=("result",))
_TM_SCRAPE_SEC = _reg.histogram(
    "fleet_scrape_seconds",
    "wall time of one federation sweep over every member that "
    "advertised a telemetry endpoint")

#: A member's heartbeat step stats enter the skew computation only once
#: this many ring records back them (one noisy first step must not flag
#: a whole host).
STRAGGLER_MIN_STEPS = 3
#: Consecutive coordinator monitor sweeps the skew must stay above the
#: threshold before the straggler is *named* ("sustained": one GC pause
#: is not a sick host; sweeps run every lease/4 seconds).
STRAGGLER_SUSTAIN = 2


def fleet_scrape_s() -> float:
    """MXTPU_FLEET_SCRAPE_S — federation scrape interval (default 5s)."""
    try:
        return max(float(os.environ.get("MXTPU_FLEET_SCRAPE_S", "5")), 0.1)
    except ValueError:
        return 5.0


def straggler_ratio() -> float:
    """MXTPU_STRAGGLER_RATIO — step-wall skew over the fleet median at
    which a member counts as straggling (default 2.0; <=1 disables)."""
    try:
        return float(os.environ.get("MXTPU_STRAGGLER_RATIO", "2.0"))
    except ValueError:
        return 2.0


def fetch_json(addr: str, path: str, timeout: float):
    """One bounded GET against a member endpoint — a dead member must
    cost at most ``timeout``, never hang the sweep.  Shared by the
    federation scrape and the serving router (serving/router.py)."""
    import http.client

    host, port = str(addr).rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise OSError(f"{addr}{path}: HTTP {resp.status}")
        return json.loads(data)
    finally:
        conn.close()


def post_json(addr: str, path: str, payload: dict, timeout: float):
    """One bounded JSON POST against a member endpoint (the router's
    /admin/drain fan-out rides this)."""
    import http.client

    host, port = str(addr).rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        body = json.dumps(payload or {}).encode()
        conn.request("POST", path, body,
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        if resp.status != 200:
            raise OSError(f"{addr}{path}: HTTP {resp.status}")
        return json.loads(data)
    finally:
        conn.close()


def fetch_spans(addr: str, trace=None, timeout: float = 5.0):
    """One member's ``GET /spans.json`` payload (identity + clock
    offset + span buffer — telemetry/tracing.py), optionally filtered
    to one trace id client-side: sweep it over the router and every
    replica to join one request's spans."""
    payload = fetch_json(addr, "/spans.json", timeout=timeout)
    if trace is not None:
        payload["spans"] = [s for s in payload.get("spans") or []
                            if s.get("trace") == trace]
    return payload


class FleetScraper:
    """Background metrics federation.

    ``targets_fn`` returns the current ``{member: telemetry_addr}`` map
    (a coordinator would snapshot it from live leases, so dead members
    drop out of the sweep automatically).  Each sweep replaces the snapshot
    wholesale; a member that failed its scrape keeps an ``ok=False``
    row with the error, so ``/fleet`` distinguishes "no endpoint" from
    "endpoint dead".
    """

    def __init__(self, targets_fn, interval_s=None):
        self._targets_fn = targets_fn
        self.interval_s = (fleet_scrape_s() if interval_s is None
                          else float(interval_s))
        self._lock = threading.Lock()
        self._snap: dict = {}
        self._stop = threading.Event()
        self._thread = None

    def scrape_once(self) -> dict:
        """One federation sweep: GET every member's ``/metrics.json``.
        Pure host-side HTTP — never touches the device."""
        targets = dict(self._targets_fn() or {})
        t0 = time.perf_counter()
        results = {}
        for member, addr in targets.items():
            try:
                snap = fetch_json(addr, "/metrics.json",
                                   timeout=min(self.interval_s, 5.0))
                results[member] = {"addr": addr, "ok": True,
                                   "at": time.time(),
                                   "metrics": snap.get("metrics") or {}}
                if _reg.enabled():
                    _TM_SCRAPE.inc(result="ok")
            except Exception as exc:  # noqa: BLE001 — one dead member must not kill the sweep
                results[member] = {"addr": addr, "ok": False,
                                   "at": time.time(), "error": repr(exc)}
                if _reg.enabled():
                    _TM_SCRAPE.inc(result="error")
        if _reg.enabled():
            _TM_SCRAPE_SEC.observe(time.perf_counter() - t0)
        with self._lock:
            self._snap = results
        return results

    def snapshot(self) -> dict:
        """Latest per-member scrape results (member -> row)."""
        with self._lock:
            return {k: dict(v) for k, v in self._snap.items()}

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()

        def _loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.scrape_once()
                except Exception:  # noqa: BLE001 — the sweep must survive
                    _logger.exception("fleet scrape sweep failed")

        self._thread = threading.Thread(target=_loop, daemon=True,
                                        name="mxtpu-fleet-scrape")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


def merge_snapshots(per_member: dict) -> dict:
    """Fold per-member ``/metrics.json`` snapshots into ONE catalog of
    host-labeled families: every sample gains a leading ``host`` label
    carrying the member id, so `sum by (host) (...)`-style queries work
    on the merged view exactly as they would on a real federation
    endpoint.  ``per_member`` maps member id -> the ``metrics`` dict of
    that member's snapshot (exporters.json_snapshot shape)."""
    out: dict = {}
    for member in sorted(per_member):
        for name, fam in (per_member[member] or {}).items():
            dst = out.get(name)
            if dst is None:
                dst = out[name] = {
                    "type": fam.get("type", "untyped"),
                    "help": fam.get("help", ""),
                    "labelnames": ["host"] + list(fam.get("labelnames", ())),
                }
                if "buckets" in fam:
                    dst["buckets"] = list(fam["buckets"])
                dst["samples"] = []
            for s in fam.get("samples", ()):
                row = dict(s)
                row["labels"] = {"host": member, **(s.get("labels") or {})}
                dst["samples"].append(row)
    return out

"""Exporters of the port: Prometheus text exposition and JSON snapshot.

A trimmed copy of ``mxnet_tpu/telemetry/exporters.py``: the two
renderers the serving front-end's ``/metrics`` and ``/metrics.json``
endpoints call.  The text format follows the Prometheus exposition
format v0.0.4 (``# HELP`` / ``# TYPE`` headers, escaped label values,
cumulative histogram buckets with an explicit ``+Inf``).
"""
from __future__ import annotations

import time
from typing import Optional

from .registry import Histogram, Registry, get_registry

__all__ = ["generate_text", "json_snapshot"]


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_value(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    if f != f:
        return "NaN"
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _labels_str(names, values, extra=()):
    pairs = [f'{n}="{_escape_label(v)}"' for n, v in zip(names, values)]
    pairs += [f'{n}="{_escape_label(v)}"' for n, v in extra]
    return "{" + ",".join(pairs) + "}" if pairs else ""


def generate_text(registry: Optional[Registry] = None) -> str:
    """Render the registry in Prometheus text exposition format."""
    registry = registry or get_registry()
    out = []
    for fam in registry.collect():
        out.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
        out.append(f"# TYPE {fam.name} {fam.typename}")
        if isinstance(fam, Histogram):
            for key, s in fam.samples():
                cum = 0
                for ub, c in zip(fam.buckets, s.counts):
                    cum += c
                    le = _fmt_value(ub)
                    out.append(
                        f"{fam.name}_bucket"
                        f"{_labels_str(fam.labelnames, key, [('le', le)])}"
                        f" {cum}")
                cum += s.counts[-1]
                out.append(
                    f"{fam.name}_bucket"
                    f"{_labels_str(fam.labelnames, key, [('le', '+Inf')])}"
                    f" {cum}")
                ls = _labels_str(fam.labelnames, key)
                out.append(f"{fam.name}_sum{ls} {_fmt_value(s.sum)}")
                out.append(f"{fam.name}_count{ls} {s.count}")
        else:
            for key, v in fam.samples():
                ls = _labels_str(fam.labelnames, key)
                out.append(f"{fam.name}{ls} {_fmt_value(v)}")
    return "\n".join(out) + ("\n" if out else "")


def json_snapshot(registry: Optional[Registry] = None) -> dict:
    """Registry contents as one JSON-serializable dict."""
    registry = registry or get_registry()
    snap = {"timestamp": time.time(), "metrics": {}}
    for fam in registry.collect():
        entry = {"type": fam.typename, "help": fam.help,
                 "labelnames": list(fam.labelnames), "samples": []}
        if isinstance(fam, Histogram):
            entry["buckets"] = list(fam.buckets)
            for key, s in fam.samples():
                entry["samples"].append({
                    "labels": dict(zip(fam.labelnames, key)),
                    "counts": list(s.counts),
                    "sum": s.sum, "count": s.count,
                })
        else:
            for key, v in fam.samples():
                entry["samples"].append({
                    "labels": dict(zip(fam.labelnames, key)), "value": v})
        snap["metrics"][fam.name] = entry
    return snap

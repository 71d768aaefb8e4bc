"""Rule orchestration of the port lint (parity:
``mxnet_tpu/analysis/engine.py``): load → build graph → run rules →
suppress.

``run_all`` is the one entry both ``python -m mxnet_tpu_torch.analysis``
and ``tests/test_torch_lint.py`` call; it returns the full finding list
with suppression state applied (inline annotations first, then the
committed allowlist), sorted for stable output.
"""
import os

from . import annotations, env_docs, host_sync, locks, trace_purity
from .astutil import load_package
from .callgraph import CallGraph

RULES = {
    "host-sync": host_sync.run,
    "trace-purity": trace_purity.run,   # capture purity
    "locks": locks.run,                 # lock-order + shared-state
    "env-docs": env_docs.run,
}

DEFAULT_ALLOWLIST = os.path.join("mxnet_tpu_torch", "analysis",
                                 "allowlist.json")


def repo_root():
    """The repo root this package sits in
    (…/mxnet_tpu_torch/analysis/ -> …)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def run_all(root=None, rules=None, allowlist_path=None, index=None,
            graph=None):
    """Run the selected rule families; -> (findings, index, graph).

    Findings come back with ``suppressed_by`` already applied; callers
    gate on ``[f for f in findings if not f.suppressed]``.
    """
    root = root or repo_root()
    selected = list(RULES) if not rules else list(rules)
    for name in selected:
        if name not in RULES:
            raise ValueError(f"unknown rule family {name!r}; "
                             f"have {sorted(RULES)}")
    if index is None:
        index = load_package(root)
    if graph is None and any(r != "env-docs" for r in selected):
        # env-docs is a text scan; only the reachability rules pay for
        # the call graph
        graph = CallGraph(index)
    findings = []
    for name in selected:
        findings.extend(RULES[name](index, graph))
    extra = annotations.apply_annotations(index, findings)
    if set(selected) == set(RULES):
        # stray-annotation sweep only makes sense on a full run — a
        # partial run would see every other family's markers as stale
        extra += annotations.scan_stray_annotations(index, findings)
    if allowlist_path is None:
        allowlist_path = os.path.join(root, DEFAULT_ALLOWLIST)
    allow = annotations.load_allowlist(allowlist_path)
    extra += annotations.apply_allowlist(
        findings, allow, os.path.relpath(allowlist_path, root)
        if os.path.exists(allowlist_path) else "")
    findings.extend(extra)
    findings.sort(key=lambda f: (f.rule, f.path, f.line, f.symbol, f.detail))
    return findings, index, graph

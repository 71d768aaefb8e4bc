"""Knob check of the port lint (parity: ``mxnet_tpu/analysis/env_docs.py``,
in one direction).

Every ``MXTPU_*``/``BENCH_*`` environment variable named in
``mxnet_tpu_torch/`` must be documented in ``docs/how_to/env_var.md``.
The doc is the reference's and the port adds no knob of its own, so a
documented knob the port does not read is no finding.  A name that ends
in ``_`` (``MXTPU_SERVE_*`` written as a family) documents nothing:
name its members.  Plain text scan — a knob mentioned only in a comment
still names a real contract.
"""
import os
import re

from . import config
from .report import Finding


def _scan_file(path):
    """-> {var: first lineno} for env-pattern hits in one file."""
    out = {}
    try:
        with open(path, "r", encoding="utf-8") as fh:
            for ln, line in enumerate(fh, 1):
                for m in re.finditer(config.ENV_VAR_PATTERN, line):
                    out.setdefault(m.group(1), ln)
    except OSError:
        pass
    return out


def scan_source(root):
    """-> {var: (relpath, lineno)} over the port's package (less the
    analyzer, whose docs quote the pattern)."""
    hits = {}
    pkg = os.path.join(root, config.ENV_PACKAGE)
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in sorted(dirnames)
                       if d not in ("__pycache__", "analysis")]
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root)
            for var, ln in _scan_file(path).items():
                hits.setdefault(var, (rel, ln))
    return hits


def run(index, graph):
    root = index.root
    src = scan_source(root)
    doc = _scan_file(os.path.join(root, config.ENV_DOC))
    findings = []
    for var in sorted(src):
        rel, ln = src[var]
        if var.endswith("_"):
            findings.append(Finding(
                rule="env-docs", path=rel, line=ln, symbol=var,
                detail="prefix-family",
                message=f"{var}* names a family, not a knob: name its "
                        "members"))
        elif var not in doc:
            findings.append(Finding(
                rule="env-docs", path=rel, line=ln, symbol=var,
                detail="undocumented",
                message=f"{var} is read in the port but missing from "
                        f"{config.ENV_DOC}"))
    return findings

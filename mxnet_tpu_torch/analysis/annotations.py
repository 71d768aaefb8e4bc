"""Suppression grammar of the port lint (parity:
``mxnet_tpu/analysis/annotations.py``): inline annotations and the
committed allowlist.

Inline annotations live in source comments on the flagged line or the
line directly above it (for lines that are too long already):

    x = out.item()             # sync-ok: epoch boundary, window drained
    # trace-ok: capture-time constant, the same in every replay
    t0 = time.perf_counter()

Markers: ``sync-ok`` (host-sync), ``trace-ok`` (trace-purity, the
capture-purity rule), ``lock-ok`` (lock-order), ``race-ok``
(shared-state) — the reference's markers, so one comment grammar serves
both packages.  The reason after the colon is mandatory — an annotation
with an empty reason is reported as its own violation instead of
suppressing anything, so the reviewed-reason discipline is
machine-enforced.

The allowlist (``mxnet_tpu_torch/analysis/allowlist.json``) suppresses
findings by their stable ``key`` for cases where an inline comment
can't sit at the site (cross-file findings like lock cycles, or
generated evidence).
Entries are ``{"key": ..., "reason": ...}``; a missing/empty reason
invalidates the entry.  Unused entries are reported so the file can't
rot.
"""
import json
import os
import re

from .report import Finding

MARKERS = {
    "host-sync": "sync-ok",
    "trace-purity": "trace-ok",
    "lock-order": "lock-ok",
    "shared-state": "race-ok",
}

_ANN_RE = re.compile(r"#\s*(sync-ok|trace-ok|lock-ok|race-ok)\s*:?\s*(.*)")


def find_annotation(index, relpath, lineno, marker):
    """Return (reason, ann_lineno) if the flagged line carries the marker
    inline, or any line of the contiguous pure-comment block directly
    above it does; (None, 0) otherwise.  An empty reason returns
    ('', line).  The reason may continue onto following comment lines —
    only the marker line's text is machine-read."""
    candidates = [lineno]
    ln = lineno - 1
    while ln >= 1 and index.source_line(relpath, ln).strip().startswith("#"):
        candidates.append(ln)
        ln -= 1
    for ln in candidates:
        text = index.source_line(relpath, ln)
        m = _ANN_RE.search(text)
        if m and m.group(1) == marker:
            if ln != lineno and text.split("#")[0].strip():
                continue  # annotation lines above must be pure comments
            return m.group(2).strip().rstrip("."), ln
    return None, 0


_SITE_RE = re.compile(r"\(([^\s():]+\.py):(\d+)\)")


def _candidate_sites(f):
    """Annotation anchor points for a finding: its own site plus — for
    the multi-site rules (a race has two writes, a lock cycle has edge
    evidence across files) — every file:line its chain cites."""
    sites = []
    if f.path and f.line:
        sites.append((f.path, f.line))
    if f.rule in ("shared-state", "lock-order"):
        for step in f.chain:
            for m in _SITE_RE.finditer(step):
                sites.append((m.group(1), int(m.group(2))))
    return sites


def apply_annotations(index, findings):
    """Mark findings suppressed by a valid inline annotation; emit
    annotation-missing-reason findings for bare markers."""
    extra = []
    for f in findings:
        marker = MARKERS.get(f.rule)
        if not marker:
            continue
        for path, line in _candidate_sites(f):
            reason, ann_ln = find_annotation(index, path, line, marker)
            if reason is None:
                continue
            if reason:
                f.suppressed_by = f"annotation:{reason}"
            else:
                extra.append(Finding(
                    rule="annotation", path=path, line=ann_ln,
                    symbol=f.symbol, detail=f"bare-{marker}",
                    message=f"# {marker}: annotation without a reason "
                            f"(suppressing nothing; add the why)"))
            break
    return extra


def scan_stray_annotations(index, findings):
    """Annotations that no finding matched are likely stale (the code
    they excused moved or was fixed) — report them so they get cleaned."""
    claimed = set()
    for f in findings:
        if f.suppressed_by.startswith("annotation:"):
            marker = MARKERS[f.rule]
            for path, line in _candidate_sites(f):
                reason, ann_ln = find_annotation(index, path, line, marker)
                if reason:
                    claimed.add((path, ann_ln, marker))
                claimed.add((path, line, marker))
    extra = []
    for mi in index.modules.values():
        for ln, text in enumerate(mi.lines, 1):
            m = _ANN_RE.search(text)
            if not m:
                continue
            marker = m.group(1)
            if ((mi.relpath, ln, marker) in claimed or
                    (mi.relpath, ln + 1, marker) in claimed):
                continue
            extra.append(Finding(
                rule="annotation", path=mi.relpath, line=ln,
                symbol=mi.name, detail=f"stale-{marker}",
                message=f"# {marker}: annotation matches no current "
                        "finding — stale, remove it"))
    return extra


def load_allowlist(path):
    """-> {key: reason}; raises ValueError on malformed entries."""
    if not path or not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        doc = json.load(fh)
    out = {}
    for i, entry in enumerate(doc if isinstance(doc, list)
                              else doc.get("entries", [])):
        key = entry.get("key", "")
        reason = (entry.get("reason") or "").strip()
        if not key or not reason:
            raise ValueError(
                f"allowlist entry {i} needs both 'key' and a non-empty "
                f"'reason': {entry!r}")
        out[key] = reason
    return out


def apply_allowlist(findings, allowlist, allowlist_path=""):
    """Suppress findings whose key is allowlisted; report unused keys."""
    used = set()
    for f in findings:
        if f.suppressed:
            continue
        reason = allowlist.get(f.key)
        if reason is not None:
            f.suppressed_by = f"allowlist:{reason}"
            used.add(f.key)
    extra = []
    for key in sorted(set(allowlist) - used):
        extra.append(Finding(
            rule="annotation", path=allowlist_path, line=0, symbol=key,
            detail="stale-allowlist",
            message=f"allowlist entry matches no current finding "
                    f"(stale): {key}"))
    return extra

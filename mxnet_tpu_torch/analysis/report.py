"""Finding model and renderers of the port lint (parity:
``mxnet_tpu/analysis/report.py``).

A :class:`Finding` is one structured violation: rule id, location,
human message, the enclosing symbol, and (for the reachability rules)
the call chain from the entry point to the offending site.  ``key`` is
a *stable* fingerprint — no line numbers — so allowlist and baseline
entries survive unrelated edits to the file.
"""
import json
from dataclasses import dataclass, field


@dataclass
class Finding:
    rule: str                 # host-sync | trace-purity | lock-order | shared-state | env-docs | annotation
    path: str                 # repo-relative file path ('' for cross-file findings)
    line: int                 # 1-based; 0 when the finding has no single site
    symbol: str               # enclosing function qualname / env var / lock cycle id
    message: str              # one-line human statement of the defect
    chain: tuple = ()         # evidence: ("qualname (file:line)", ...) entry→site
    detail: str = ""          # fingerprint detail (primitive name, lock pair, ...)
    suppressed_by: str = ""   # "annotation:<reason>" | "allowlist:<reason>" | ""
    key: str = field(default="", compare=False)

    def __post_init__(self):
        if not self.key:
            self.key = f"{self.rule}|{self.path}|{self.symbol}|{self.detail}"

    @property
    def suppressed(self):
        return bool(self.suppressed_by)

    def to_dict(self):
        return {
            "rule": self.rule, "path": self.path, "line": self.line,
            "symbol": self.symbol, "message": self.message,
            "chain": list(self.chain), "detail": self.detail,
            "suppressed_by": self.suppressed_by, "key": self.key,
        }


def render_text(findings, verbose=False, show_suppressed=False):
    """Plain-text report: one block per active finding, grouped by rule."""
    lines = []
    active = [f for f in findings if not f.suppressed]
    shown = findings if show_suppressed else active
    by_rule = {}
    for f in shown:
        by_rule.setdefault(f.rule, []).append(f)
    for rule in sorted(by_rule):
        group = by_rule[rule]
        lines.append(f"== {rule} ({sum(1 for f in group if not f.suppressed)}"
                     f" violation(s), {sum(1 for f in group if f.suppressed)}"
                     " suppressed) ==")
        for f in group:
            mark = "  [suppressed: %s]" % f.suppressed_by if f.suppressed else ""
            loc = f"{f.path}:{f.line}" if f.path else "(repo)"
            lines.append(f"{loc}: {f.message}{mark}")
            if f.chain and (verbose or not f.suppressed):
                for i, step in enumerate(f.chain):
                    lines.append("    " + ("  " * i) + "-> " + step)
        lines.append("")
    lines.append(f"{len(active)} violation(s), "
                 f"{len(findings) - len(active)} suppressed.")
    return "\n".join(lines)


def render_json(findings, meta=None):
    active = [f for f in findings if not f.suppressed]
    doc = {
        "violations": len(active),
        "suppressed": len(findings) - len(active),
        "findings": [f.to_dict() for f in findings],
    }
    if meta:
        doc.update(meta)
    return json.dumps(doc, indent=2, sort_keys=True)

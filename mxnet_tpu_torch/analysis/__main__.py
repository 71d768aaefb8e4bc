"""The port lint's command line (parity: ``tools/lint.py``).

Runs the static rule families (host-sync escape analysis, capture
purity, lock-order/shared-state, the knob check) over
``mxnet_tpu_torch/`` and exits nonzero on any unsuppressed finding::

    python -m mxnet_tpu_torch.analysis                 # text report
    python -m mxnet_tpu_torch.analysis --rules host-sync,env-docs
    python -m mxnet_tpu_torch.analysis --json          # structured findings
    python -m mxnet_tpu_torch.analysis --write-baseline base.json
    python -m mxnet_tpu_torch.analysis --baseline base.json  # NEW only

Exit codes: 0 clean, 1 findings, 2 usage or internal error.

The analysis package is stdlib only, and ``mxnet_tpu_torch/__init__.py``
imports nothing while ``-m`` locates this module, so a lint never loads
torch (nor jax, nor ``mxnet_tpu``).
"""
import argparse
import json
import sys

from . import RULES, render_json, render_text, repo_root, run_all


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.analysis",
        description="static invariant lint over mxnet_tpu_torch/")
    ap.add_argument("--rules", default="",
                    help="comma list: host-sync,trace-purity,locks,env-docs "
                         "(default: all)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the structured finding list as JSON")
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--baseline", default="",
                       help="suppress findings whose keys are in this "
                            "baseline file (adopt-then-ratchet mode)")
    group.add_argument("--write-baseline", default="",
                       help="write the unsuppressed finding keys to this "
                            "file and exit 0")
    ap.add_argument("--allowlist", default=None,
                    help="override the allowlist path (default "
                         "mxnet_tpu_torch/analysis/allowlist.json)")
    ap.add_argument("--root", default=repo_root(), help=argparse.SUPPRESS)
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="show suppressed findings and full call chains")
    try:
        args = ap.parse_args(argv)
    except SystemExit as exc:       # argparse's usage errors exit 2
        return int(exc.code or 0)

    rules = [r.strip() for r in args.rules.split(",") if r.strip()] or None
    try:
        findings, _, _ = run_all(root=args.root, rules=rules,
                                 allowlist_path=args.allowlist)
    except (ValueError, OSError, SyntaxError) as e:
        print(f"lint: {e}", file=sys.stderr)
        return 2

    if args.baseline:
        try:
            with open(args.baseline, "r", encoding="utf-8") as fh:
                base = set(json.load(fh).get("keys", []))
        except (OSError, ValueError, AttributeError) as e:
            print(f"lint: cannot read baseline {args.baseline}: {e}",
                  file=sys.stderr)
            return 2
        for f in findings:
            if not f.suppressed and f.key in base:
                f.suppressed_by = f"baseline:{args.baseline}"

    active = [f for f in findings if not f.suppressed]
    if args.write_baseline:
        doc = {"keys": sorted({f.key for f in active})}
        with open(args.write_baseline, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, indent=2)
        print(f"lint: wrote {len(doc['keys'])} baseline key(s) to "
              f"{args.write_baseline}")
        return 0

    if args.as_json:
        print(render_json(findings, meta={"rules": rules or sorted(RULES)}))
    else:
        print(render_text(findings, verbose=args.verbose,
                          show_suppressed=args.verbose))
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's static invariant lint (parity: ``mxnet_tpu/analysis``).

The port's load-bearing guarantees — no device-to-host sync a batch on
the steady-state training and serving loops, nothing host-side inside a
CUDA-graph capture, and thread safety across the background machinery —
are sampled at run time only in the loops a test or ``chip_smoke.py``
counts under ``torch.cuda.set_sync_debug_mode``.  This package proves
the same invariants statically over the whole ``mxnet_tpu_torch`` source
tree.

Everything here is stdlib only (``ast`` and ``tokenize``): it imports
neither ``torch`` nor ``jax`` nor the package under analysis, and
``python -m mxnet_tpu_torch.analysis`` runs it without loading the
port (``mxnet_tpu_torch/__init__.py`` imports nothing while ``-m``
locates this package).

Rule families (see each module for its model and approximations):

- ``host_sync``    — no device-to-host sync primitive (``.item()``,
                     ``.cpu()``, ``.tolist()``, ``torch.cuda.synchronize``,
                     a tensor's truth value, ...) reachable from a
                     declared steady-state entry point;
- ``trace_purity`` — capture purity: code that runs under
                     ``torch.cuda.graph`` (and the op bodies, optimizer
                     rules and autograd Functions a replayed step runs)
                     must not read host clocks or RNGs, write telemetry,
                     sync, or write captured Python state: all of it
                     happens once at capture and never in a replay;
- ``locks``        — lock-acquisition-order cycles (deadlock candidates)
                     and attributes written from several thread domains
                     with no common lock (race candidates);
- ``env_docs``     — every ``MXTPU_*``/``BENCH_*`` knob the port reads is
                     documented in ``docs/how_to/env_var.md``.

Findings are suppressed only by an inline annotation with a reason
(``# sync-ok: <why>``, ``# trace-ok: <why>``, ``# lock-ok: <why>``,
``# race-ok: <why>``) or an entry of ``analysis/allowlist.json``; a bare
or stale annotation is itself a finding.
"""
from .report import Finding, render_text, render_json          # noqa: F401
from .astutil import PackageIndex, load_package                # noqa: F401
from .callgraph import CallGraph                               # noqa: F401
from .engine import run_all, RULES, repo_root                  # noqa: F401

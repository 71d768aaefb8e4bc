"""The port's own invariant lint (``mxnet_tpu_torch/analysis``,
``python -m mxnet_tpu_torch.analysis``).

1. fixtures in torch idiom, written to ``tmp_path``: each rule family
   catches its known-bad sites and stays quiet on the good ones — the
   sync primitives and the tensor-typed casts and tests (host-sync), the
   roots under ``torch.cuda.graph``, the registered ops, the optimizer
   rules and the autograd Functions they reach (capture purity), the
   host engine's tasks as thread entries (locks), the knob check in one
   direction (env-docs);
2. the suppression grammar: an annotation with a reason suppresses, a
   bare or stale one is a finding, the allowlist needs reasons;
3. against the reference: the JAX package's engine, loaded standalone as
   ``tools/lint.py`` loads it (no jax), and the port's give the same
   lock-order and shared-state findings on ``tests/fixtures/lint/``;
4. the repo gate: 0 unannotated findings over ``mxnet_tpu_torch/``, every
   suppression with a reason, every declared entry point and boundary
   present, the CLI's exit codes, and a child process whose path makes
   ``torch``, ``jax`` and ``mxnet_tpu`` raise on import.

Both analysis packages are loaded under private names from their files:
nothing here imports torch, jax or either package's ``__init__``.
"""
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import pytest

pytestmark = pytest.mark.lint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "lint")


def _load(name, pkg_dir):
    """The analysis package in ``pkg_dir`` as package ``name``, without
    its parent package's ``__init__``."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


_load("_port_lint", os.path.join(ROOT, "mxnet_tpu_torch", "analysis"))
_load("_reference_lint", os.path.join(ROOT, "mxnet_tpu", "analysis"))
from _port_lint import (annotations, astutil, callgraph, config,  # noqa: E402
                        engine, env_docs, trace_purity)

cli = importlib.import_module("_port_lint.__main__")


def _write(root, files):
    for rel, text in files.items():
        path = os.path.join(str(root), rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(textwrap.dedent(text).lstrip("\n"))
    return str(root)


def _run(root, rules, package="mxnet_tpu_torch", monkeypatch=None,
         entry=None, boundaries=None):
    if entry is not None:
        monkeypatch.setattr(config, "ENTRY_POINTS", tuple(entry))
        monkeypatch.setattr(config, "BOUNDARIES", dict(boundaries or {}))
    index = astutil.load_package(root, package=package)
    graph = callgraph.CallGraph(index)
    findings, _, _ = engine.run_all(root=root, rules=rules, index=index,
                                    graph=graph, allowlist_path="")
    return findings


def _active(findings, rule=None):
    return [f for f in findings if not f.suppressed
            and (rule is None or f.rule == rule)]


def _marked(root, rel, marker):
    """Line numbers of ``rel`` whose text holds ``marker``."""
    with open(os.path.join(root, rel)) as f:
        return [i for i, t in enumerate(f.read().splitlines(), 1)
                if marker in t]


# ------------------------------------------------------------- host-sync
HOT = {
    "hotpkg/__init__.py": "",
    "hotpkg/nd.py": """
        class NDArray:
            def __init__(self, t):
                self.t = t
    """,
    "hotpkg/hot.py": """
        import numpy as np
        import torch

        from . import nd


        def step(x, t: torch.Tensor, event, items):
            loss = t.sum()
            v = loss.item()                                 # BAD:item
            rows = t.tolist()                               # BAD:tolist
            h = t.cpu()                                     # BAD:cpu
            a = h.numpy()                                   # BAD:numpy
            torch.cuda.synchronize()                        # BAD:synchronize
            event.synchronize()                             # BAD:synchronize
            idx = t.nonzero()                               # BAD:nonzero
            sel = t.masked_select(t > 0)                    # BAD:masked_select
            u = torch.unique(t)                             # BAD:unique
            same = torch.equal(t, t)                        # BAD:equal
            rep = t.repeat_interleave(t)                    # BAD:repeat_interleave
            c = t.to("cpu")                                 # BAD:to-cpu
            up = torch.from_numpy(a).to("cuda")             # BAD:h2d-upload
            tt = torch.tensor(items, device="cuda")         # BAD:h2d-upload
            h0 = torch.from_numpy(a)
            h1 = h0.cuda()                                  # BAD:h2d-upload
            pin = torch.from_numpy(a).pin_memory().to(
                "cuda", non_blocking=True)                  # KNOWN-GOOD
            h2 = h0.to("cuda", non_blocking=True)           # KNOWN-GOOD
            h3 = h0.to(dtype=torch.float16)                 # KNOWN-GOOD
            tc = torch.tensor(items, device="cpu")          # KNOWN-GOOD
            z = torch.zeros(3, device="cuda")
            f = float(z)                                    # BAD:float
            w = nd.NDArray(t)
            wn = np.array(w)                                # BAD:np.array
            if t:                                           # BAD:tensor-test
                pass
            while z > 0:                                    # BAD:tensor-test
                break
            helper(t)
            narrowed(x)
            boundary_report(t)
            ok = x.repeat_interleave(2)                     # KNOWN-GOOD
            sized = t.repeat_interleave(t, output_size=8)   # KNOWN-GOOD
            g = t.to("cuda", non_blocking=True)             # KNOWN-GOOD
            n = len(items)
            m = float(n)                                    # KNOWN-GOOD
            arr = np.asarray(items)                         # KNOWN-GOOD
            if t is None:                                   # KNOWN-GOOD
                pass
            y = x.item()  # sync-ok: sanctioned epoch-boundary read
            return (v, rows, a, idx, sel, u, same, rep, c, f, wn, ok, sized,
                    up, tt, h1, pin, h2, h3, tc)


        def helper(t):
            t.wait_to_read()                                # BAD:wait_to_read


        def narrowed(x):
            if isinstance(x, torch.Tensor):
                return np.asarray(x)                        # BAD:np.asarray
            return np.asarray(x)                            # KNOWN-GOOD


        def boundary_report(t):
            return t.item()                                 # KNOWN-GOOD


        def cold_path(t):
            return t.item()                                 # KNOWN-GOOD
    """,
}
PRIMITIVES = ("item", "tolist", "cpu", "numpy", "synchronize", "nonzero",
              "masked_select", "unique", "equal", "repeat_interleave",
              "to-cpu", "h2d-upload", "float", "np.array", "tensor-test",
              "wait_to_read", "np.asarray")


@pytest.fixture()
def hot(tmp_path, monkeypatch):
    root = _write(tmp_path, HOT)
    findings = _run(root, ["host-sync"], "hotpkg", monkeypatch,
                    entry=("hotpkg.hot.step",),
                    boundaries={"hotpkg.hot.boundary_report": "fixture"})
    return root, findings


@pytest.mark.parametrize("prim", PRIMITIVES)
def test_host_sync_catches_each_primitive(hot, prim):
    root, findings = hot
    want = _marked(root, "hotpkg/hot.py", f"# BAD:{prim}")
    assert want, prim
    got = {f.line for f in _active(findings, "host-sync")
           if f.detail == prim}
    assert set(want) <= got, (prim, want, got)


def test_host_sync_good_sites_quiet(hot):
    root, findings = hot
    lines = {f.line for f in _active(findings, "host-sync")}
    good = _marked(root, "hotpkg/hot.py", "KNOWN-GOOD")
    assert good and not lines & set(good)
    assert not any(f.symbol.endswith(("boundary_report", "cold_path"))
                   for f in _active(findings))
    bad = {ln for p in PRIMITIVES
           for ln in _marked(root, "hotpkg/hot.py", f"# BAD:{p}")}
    assert lines == bad


def test_host_sync_chain_names_the_entry_point(hot):
    _, findings = hot
    chained = [f for f in _active(findings, "host-sync")
               if f.detail == "wait_to_read"]
    assert chained and chained[0].chain[0].startswith("hotpkg.hot.step ")
    assert "[entry]" in chained[0].chain[0]


def test_host_sync_annotation_with_a_reason_suppresses(hot):
    _, findings = hot
    sup = [f for f in findings if f.suppressed]
    assert [f.suppressed_by for f in sup] == [
        "annotation:sanctioned epoch-boundary read"]


def test_missing_entry_point_is_a_finding(tmp_path, monkeypatch):
    root = _write(tmp_path, HOT)
    findings = _run(root, ["host-sync"], "hotpkg", monkeypatch,
                    entry=("hotpkg.hot.not_a_function",))
    assert [f.detail for f in _active(findings)] == ["missing-entry"]


# --------------------------------------------------------- capture purity
CAPTURE = {
    "mxnet_tpu_torch/__init__.py": "",
    "mxnet_tpu_torch/telemetry/__init__.py": """
        def counter(name):
            return name


        def record(name):
            return name
    """,
    "mxnet_tpu_torch/ops/__init__.py": "",
    "mxnet_tpu_torch/ops/registry.py": """
        def register(name, **kw):
            def wrap(fn):
                return fn
            return wrap
    """,
    "mxnet_tpu_torch/ops/kernels.py": """
        import random
        import time

        import numpy as np
        import torch

        from .. import telemetry as _tm
        from .registry import register

        _TM_CALLS = _tm.counter("calls")
        _launches = {"double": 0}


        def _launch(x):
            _launches["double"] += 1                        # BAD:captured-mutation
            return x * 2


        class _Double(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                ctx.t0 = time.perf_counter()                # BAD:time
                return _launch(x)

            @staticmethod
            def backward(ctx, g):
                return g * 2


        @register("Double")
        def double_op(ctx, data, **attrs):
            return _Double.apply(data)


        @register("Noisy")
        def noisy_op(ctx, data, **attrs):
            scale = np.random.uniform()                     # BAD:numpy.random
            jitter = random.random()                        # BAD:random
            _TM_CALLS.inc()                                 # BAD:telemetry-instrument
            _tm.record("noisy")                             # BAD:mxnet_tpu_torch.telemetry
            print("noisy")                                  # BAD:print
            if data:                                        # BAD:tensor-branch
                scale = scale + 1
            return data * (scale + jitter)


        @register("Clean")
        def clean_op(ctx, data, **attrs):
            if data.shape[0] > 2:                           # KNOWN-GOOD
                data = data[:2]
            # trace-ok: sanctioned capture-time constant
            stamp = time.perf_counter()
            return data + 0 * stamp


        def eager_only(x):
            return time.perf_counter() + x.item()           # KNOWN-GOOD
    """,
    "mxnet_tpu_torch/optim_rules.py": """
        _STEPS = 0


        def sgd(w, g, lr):
            global _STEPS                                   # BAD:captured-mutation
            _STEPS += 1
            w.sub_(g * lr)


        def momentum(w, g, m, lr):
            m.mul_(0.9).add_(g)                             # KNOWN-GOOD
            w.sub_(m * lr)
    """,
    "mxnet_tpu_torch/trainer.py": """
        import time

        import torch


        class Trainer:
            def __init__(self):
                self.steps = 0

            def capture(self, x):
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    t0 = time.perf_counter()                # BAD:time
                    out = self._step(x)
                return graph, out, t0

            def _step(self, x):
                self.steps += 1                             # BAD:captured-mutation
                if x.sum().item() > 0:                      # BAD:sync:item
                    x = x * 2
                return x

            def eager(self, x):
                self.steps += 1                             # KNOWN-GOOD
                return time.perf_counter()
    """,
}


@pytest.fixture()
def capture(tmp_path):
    root = _write(tmp_path, CAPTURE)
    return root, _run(root, ["trace-purity"])


def test_capture_roots(tmp_path):
    root = _write(tmp_path, CAPTURE)
    index = astutil.load_package(root)
    graph = callgraph.CallGraph(index)
    roots = trace_purity.find_trace_roots(index, graph)
    p = "mxnet_tpu_torch."
    assert "torch.cuda.graph" in roots[p + "trainer.Trainer._step"]
    assert "@register" in roots[p + "ops.kernels.double_op"]
    assert "optim_rules" in roots[p + "optim_rules.sgd"]
    assert p + "trainer.Trainer.eager" not in roots
    assert p + "ops.kernels.eager_only" not in roots
    # the autograd Function's forward and backward through F.apply
    reached = graph.reachable(sorted(roots))
    assert p + "ops.kernels._Double.forward" in reached
    assert p + "ops.kernels._Double.backward" in reached


@pytest.mark.parametrize("kind", [
    "captured-mutation", "time", "numpy.random", "random",
    "telemetry-instrument", "mxnet_tpu_torch.telemetry", "print",
    "tensor-branch", "sync:item"])
def test_capture_purity_catches_each_kind(capture, kind):
    root, findings = capture
    want = set()
    for rel in CAPTURE:
        want |= {(rel, ln) for ln in _marked(root, rel, f"# BAD:{kind}")}
    got = {(f.path, f.line) for f in _active(findings, "trace-purity")
           if f.detail == kind}
    assert want and want <= got, (kind, want, got)


def test_capture_purity_good_sites_quiet_and_annotation_suppresses(capture):
    root, findings = capture
    for rel in CAPTURE:
        good = set(_marked(root, rel, "KNOWN-GOOD"))
        assert not good & {f.line for f in _active(findings)
                           if f.path == rel}, rel
    assert not any(f.symbol.endswith(("eager_only", "Trainer.eager"))
                   for f in findings)
    sup = [f for f in findings if f.suppressed]
    assert [(f.symbol.rsplit(".", 1)[-1], f.suppressed_by) for f in sup] \
        == [("clean_op", "annotation:sanctioned capture-time constant")]


def test_capture_finding_names_its_root(capture):
    _, findings = capture
    launch = [f for f in _active(findings) if f.symbol.endswith("_launch")]
    assert launch and "capture root: mxnet_tpu_torch.ops.kernels." \
        "double_op" in launch[0].message
    block = [f for f in _active(findings) if "<capture>" in f.symbol]
    assert [f.detail for f in block] == ["time"]
    assert "capture block mxnet_tpu_torch/trainer.py:" in block[0].message


# ----------------------------------------------------------------- locks
def _lock_findings(analysis):
    index = analysis.astutil.load_package(FIXTURES, package="lockpkg")
    graph = analysis.callgraph.CallGraph(index)
    findings, _, _ = analysis.engine.run_all(
        root=FIXTURES, rules=["locks"], index=index, graph=graph,
        allowlist_path="")
    return {(f.rule, f.path, f.line, f.symbol, f.detail, f.message,
             f.chain, f.suppressed_by) for f in findings}


def test_lock_findings_equal_the_reference_engines():
    port = _lock_findings(sys.modules["_port_lint"])
    ref = _lock_findings(sys.modules["_reference_lint"])
    assert port == ref
    rules = {f[0] for f in port}
    assert rules == {"lock-order", "shared-state"}
    details = {f[4] for f in port}
    assert "cycle" in details and "race:total" in details
    assert any(d.startswith("self-deadlock") for d in details)


ENGINE = {
    "mxnet_tpu_torch/__init__.py": "",
    "mxnet_tpu_torch/_native.py": """
        class NativeEngine:
            def push(self, fn, const_vars=(), mutable_vars=()):
                fn()
    """,
    "mxnet_tpu_torch/store.py": """
        import threading

        from . import _native


        class Racy:
            def __init__(self):
                self._engine = _native.NativeEngine()
                self.sent = None

            def push(self, k):
                self._engine.push(lambda: self._send(k))

            def _send(self, k):
                self.sent = k

            def reset(self):
                self.sent = None


        class Disciplined:
            def __init__(self):
                self._lock = threading.Lock()
                self._engine = _native.NativeEngine()
                self.sent = None

            def push(self, k):
                self._engine.push(lambda: self._send(k))

            def _send(self, k):
                with self._lock:
                    self.sent = k

            def reset(self):
                with self._lock:
                    self.sent = None
    """,
}


def test_host_engine_tasks_are_thread_entries(tmp_path):
    root = _write(tmp_path, ENGINE)
    findings = _run(root, ["locks"])
    races = _active(findings, "shared-state")
    assert [f.symbol for f in races] == ["mxnet_tpu_torch.store.Racy.sent"]
    assert "bg:mxnet_tpu_torch.store.Racy._send" in races[0].message


# -------------------------------------------------------------- env-docs
def test_knob_check_runs_in_one_direction(tmp_path):
    root = _write(tmp_path, {
        "mxnet_tpu_torch/__init__.py": "",
        "mxnet_tpu_torch/knobs.py": """
            import os
            # the MXTPU_FIXTURE_* family
            A = os.environ.get("MXTPU_FIXTURE_A", "")
            B = os.environ.get("MXTPU_FIXTURE_B", "")
        """,
        "docs/how_to/env_var.md": """
            * `MXTPU_FIXTURE_B` — read by the port.
            * `MXTPU_FIXTURE_C` — the reference's only: no finding.
        """,
    })
    index = astutil.load_package(root)
    got = {(f.symbol, f.detail) for f in env_docs.run(index, None)}
    assert got == {("MXTPU_FIXTURE_A", "undocumented"),
                   ("MXTPU_FIXTURE_", "prefix-family")}


def test_repo_knobs_all_documented():
    findings, _, _ = engine.run_all(root=ROOT, rules=["env-docs"])
    assert _active(findings) == [], [f.message for f in _active(findings)]


# ------------------------------------------- annotation/allowlist grammar
def _mini_root(tmp_path, line):
    return _write(tmp_path, {
        "mxnet_tpu_torch/__init__.py": "",
        "mxnet_tpu_torch/m.py": f"""
            def entry(x):
                {line}
                return x
        """})


def test_bare_annotation_is_its_own_finding(tmp_path, monkeypatch):
    root = _mini_root(tmp_path, "y = x.item()  # sync-ok:")
    monkeypatch.setattr(config, "ENTRY_POINTS", ("mxnet_tpu_torch.m.entry",))
    monkeypatch.setattr(config, "BOUNDARIES", {})
    findings, _, _ = engine.run_all(root=root, rules=["host-sync"],
                                    allowlist_path="")
    assert _active(findings, "host-sync")      # NOT suppressed
    assert [f.detail for f in _active(findings, "annotation")] == \
        ["bare-sync-ok"]


def test_stale_annotation_reported_on_a_full_run(tmp_path, monkeypatch):
    root = _mini_root(tmp_path, "y = x + 1  # trace-ok: nothing here")
    monkeypatch.setattr(config, "ENTRY_POINTS", ())
    monkeypatch.setattr(config, "BOUNDARIES", {})
    findings, _, _ = engine.run_all(root=root, allowlist_path="")
    assert [f.detail for f in _active(findings, "annotation")] == \
        ["stale-trace-ok"]


def test_allowlist_requires_a_reason_and_reports_stale(tmp_path,
                                                      monkeypatch):
    root = _mini_root(tmp_path, "y = x.cpu()")
    allow = tmp_path / "allow.json"
    allow.write_text(json.dumps([{"key": "nope"}]))
    with pytest.raises(ValueError, match="non-empty 'reason'"):
        annotations.load_allowlist(str(allow))
    monkeypatch.setattr(config, "ENTRY_POINTS", ("mxnet_tpu_torch.m.entry",))
    monkeypatch.setattr(config, "BOUNDARIES", {})
    findings, _, _ = engine.run_all(root=root, rules=["host-sync"],
                                    allowlist_path="")
    key = _active(findings, "host-sync")[0].key
    allow.write_text(json.dumps([{"key": key, "reason": "fixture-reviewed"},
                                 {"key": "stale-key", "reason": "old"}]))
    findings, _, _ = engine.run_all(root=root, rules=["host-sync"],
                                    allowlist_path=str(allow))
    assert not _active(findings, "host-sync")
    assert [f.detail for f in findings if f.rule == "annotation"] == \
        ["stale-allowlist"]


def test_unknown_rule_raises():
    with pytest.raises(ValueError, match="unknown rule family"):
        engine.run_all(root=ROOT, rules=["bogus"])


# -------------------------------------------------------- repo-wide gate
@pytest.fixture(scope="module")
def repo_json(tmp_path_factory):
    """``python -m mxnet_tpu_torch.analysis --json`` in a child whose
    path makes torch, jax and mxnet_tpu raise on import."""
    poison = tmp_path_factory.mktemp("poison")
    for pkg in ("torch", "jax", "mxnet_tpu"):
        (poison / pkg).mkdir()
        (poison / pkg / "__init__.py").write_text(
            f"raise ImportError('the lint imported {pkg}')\n")
    env = dict(os.environ, PYTHONPATH=str(poison))
    proc = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.analysis", "--json"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    return proc.returncode, proc.stdout, proc.stderr


def test_repo_has_no_unannotated_findings(repo_json):
    rc, out, err = repo_json
    doc = json.loads(out)
    active = [f for f in doc["findings"] if not f["suppressed_by"]]
    assert active == [], "port lint broken:\n" + "\n".join(
        f"{f['path']}:{f['line']} [{f['rule']}] {f['message']}"
        for f in active)
    assert rc == 0, err
    assert doc["rules"] == sorted(engine.RULES)


def test_repo_suppressions_all_carry_reasons(repo_json):
    _, out, _ = repo_json
    doc = json.loads(out)
    assert doc["suppressed"] > 0
    for f in doc["findings"]:
        kind, _, reason = f["suppressed_by"].partition(":")
        assert kind == "annotation" and reason.strip(), f
    with open(os.path.join(ROOT, engine.DEFAULT_ALLOWLIST)) as fh:
        assert json.load(fh) == []


@pytest.mark.parametrize("table", ["ENTRY_POINTS", "BOUNDARIES",
                                   "CAPTURE_BOUNDARIES"])
def test_repo_entry_points_and_boundaries_exist(table):
    index = astutil.load_package(ROOT)
    names = getattr(config, table)
    assert names
    for qn in names:
        assert qn in index.functions, f"stale {table} entry {qn}"
        if isinstance(names, dict):
            assert names[qn].strip(), f"{qn} needs a reason"


def test_cli_exit_codes(tmp_path, capsys):
    assert cli.main(["--rules", "bogus"]) == 2
    assert cli.main(["--baseline", "a", "--write-baseline", "b"]) == 2
    root = _write(tmp_path, {
        "mxnet_tpu_torch/__init__.py": "",
        "mxnet_tpu_torch/m.py": """
            import os
            X = os.environ.get("MXTPU_NOT_DOCUMENTED")
        """,
        "docs/how_to/env_var.md": "",
    })
    base = str(tmp_path / "base.json")
    args = ["--rules", "env-docs", "--root", root, "--allowlist", ""]
    assert cli.main(args) == 1                          # a finding
    assert cli.main(args + ["--write-baseline", base]) == 0
    assert cli.main(args + ["--baseline", base]) == 0   # adopted
    assert cli.main(args + ["--baseline", str(tmp_path / "nope")]) == 2
    os.remove(os.path.join(root, "mxnet_tpu_torch", "m.py"))
    assert cli.main(args) == 0                          # clean
    assert "0 violation(s)" in capsys.readouterr().out

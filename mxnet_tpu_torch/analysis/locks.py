"""Rule family 3 — lock-order and shared-state analyzer (parity:
``mxnet_tpu/analysis/locks.py``, the same model).

The port's threaded surface: the telemetry registry and its HTTP
exporters, the serving scheduler, server and router, the fleet
scraper, the coordinator's heartbeat, the checkpoint writer, the
parameter-server servers and their clients, the host engine's workers
and ``mp_io``'s consumer.  Two static checks over all of it:

lock-order (deadlock candidates)
    Lock identities are ``(owner, attr)`` — ``self.X =
    threading.Lock()/RLock()/Condition()`` class attributes and
    module-global locks.  ``threading.Condition(self.lock)`` aliases
    the lock it wraps.  A walk of every function tracks the
    ``with``-stack of held locks; acquiring B while holding A adds an
    order edge A→B, both lexically and through resolved calls (callee
    summaries, fixpoint).  Cycles in the order graph are deadlock
    candidates; re-acquiring a held non-reentrant Lock is a
    self-deadlock candidate.

shared-state (race candidates)
    Thread entry points: ``threading.Thread(target=…)`` /
    ``Timer(…)`` targets, ``signal.signal`` / ``atexit.register`` /
    ``weakref.finalize`` callbacks, ``do_*``/``handle`` HTTP handler
    methods, ``run`` on Thread subclasses, and the tasks pushed to the
    host engine (``NativeEngine.push``/``engine.push``: a function, or
    the calls of a lambda), which run on its worker threads.  For every
    class that owns a background entry, each ``self.attr`` write site is
    placed in the thread domains that reach it (the background roots'
    call closures, plus "main" for the public API closure).  An
    attribute written from two different domains with no common lock
    held at the two sites is a race candidate.  ``__init__`` writes are
    construction-time and skipped.
"""
import ast
from collections import defaultdict

from . import config
from .astutil import dotted
from .callgraph import iter_body_calls, resolve_fn_ref
from .report import Finding

REENTRANT = ("RLock", "Condition")  # Condition() wraps an RLock by default


# --------------------------------------------------------------- discovery
def _lock_ctor(call, mi):
    """-> ('Lock'|'RLock'|'Condition', wrapped_attr_or_None) or None."""
    if not isinstance(call, ast.Call):
        return None
    text = dotted(call.func)
    if not text:
        return None
    head = text.split(".")[0]
    resolved = text.replace(head, mi.imports.get(head, head), 1)
    base = text.rsplit(".", 1)[-1]
    if text in config.LOCK_CONSTRUCTORS or \
            resolved in ("threading." + b for b in
                         ("Lock", "RLock", "Condition")):
        wrapped = None
        if base == "Condition" and call.args:
            a = call.args[0]
            if isinstance(a, ast.Attribute) and \
                    isinstance(a.value, ast.Name) and a.value.id == "self":
                wrapped = a.attr
        return base, wrapped
    return None


def discover_locks(index):
    """-> locks: {(owner, attr): kind}, aliases: {(owner, attr): (owner, attr)}
    where owner is a class qualname or module name."""
    locks, aliases = {}, {}
    for cqn, ci in index.classes.items():
        mi = index.modules[ci.module]
        for node in ast.walk(ci.node):
            if not isinstance(node, ast.Assign):
                continue
            got = _lock_ctor(node.value, mi)
            if not got:
                continue
            kind, wrapped = got
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute) and \
                        isinstance(tgt.value, ast.Name) and \
                        tgt.value.id == "self":
                    ident = (cqn, tgt.attr)
                    locks[ident] = kind
                    if wrapped:
                        aliases[ident] = (cqn, wrapped)
    for modname, mi in index.modules.items():
        for node in ast.iter_child_nodes(mi.tree):
            if not isinstance(node, ast.Assign):
                continue
            got = _lock_ctor(node.value, mi)
            if not got:
                continue
            kind, _ = got
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    locks[(modname, tgt.id)] = kind
    return locks, aliases


def _canon(ident, aliases):
    seen = set()
    while ident in aliases and ident not in seen:
        seen.add(ident)
        ident = aliases[ident]
    return ident


class LockModel:
    def __init__(self, index, graph):
        self.index = index
        self.graph = graph
        self.locks, self.aliases = discover_locks(index)
        # per-function: [(held_tuple, acquired_ident, lineno)]
        self.acquisitions = defaultdict(list)
        # per-function: [(held_tuple, CallSite)]
        self.calls_under = defaultdict(list)
        # per-function: [(held_tuple, attr_name, lineno)] self-writes
        self.self_writes = defaultdict(list)
        for qn, fi in index.functions.items():
            self._walk_function(qn, fi)
        self.summary = self._fixpoint_summaries()

    # ---------------------------------------------------------- per-function
    def _resolve_lock_expr(self, fi, node):
        """with-item / receiver expression -> lock ident or None."""
        idx = self.index
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and node.value.id == "self":
            cls = fi.cls
            while cls:
                ident = (cls, node.attr)
                if ident in self.locks:
                    return _canon(ident, self.aliases)
                ci = idx.classes.get(cls)
                cls = (idx.resolve_class(ci.bases[0], idx.modules[ci.module])
                       if ci and ci.bases else None)
            return None
        if isinstance(node, ast.Name):
            ident = (fi.module, node.id)
            if ident in self.locks:
                return _canon(ident, self.aliases)
            target = self.index.modules[fi.module].imports.get(node.id, "")
            if "." in target:
                mod, name = target.rsplit(".", 1)
                ident = (mod, name)
                if ident in self.locks:
                    return _canon(ident, self.aliases)
        # self._attr.lock style / typed attr receivers
        text = dotted(node)
        if text.startswith("self.") and fi.cls and text.count(".") == 2:
            _, attr, lockattr = text.split(".")
            ci = idx.classes.get(fi.cls)
            cls = ci.attr_types.get(attr) if ci else None
            if cls and (cls, lockattr) in self.locks:
                return _canon((cls, lockattr), self.aliases)
        return None

    def _walk_function(self, qn, fi):
        def visit(stmts, held):
            for st in stmts:
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                    continue
                if isinstance(st, ast.With):
                    new = list(held)
                    for item in st.items:
                        ident = self._resolve_lock_expr(fi, item.context_expr)
                        if ident:
                            self.acquisitions[qn].append(
                                (tuple(new), ident, st.lineno))
                            new.append(ident)
                    self._scan_exprs(qn, fi, st.items, held)
                    visit(st.body, new)
                    continue
                # .acquire() outside a with
                for call in ast.walk(st):
                    if isinstance(call, ast.Call) and \
                            isinstance(call.func, ast.Attribute) and \
                            call.func.attr == "acquire":
                        ident = self._resolve_lock_expr(fi, call.func.value)
                        if ident:
                            self.acquisitions[qn].append(
                                (tuple(held), ident, call.lineno))
                self._scan_stmt(qn, fi, st, held)
                for attr in ("body", "orelse", "finalbody"):
                    sub = getattr(st, attr, None)
                    if sub:
                        visit(sub, held)
                for h in getattr(st, "handlers", []) or []:
                    visit(h.body, held)

        visit(fi.node.body, [])

    def _scan_stmt(self, qn, fi, st, held):
        """Record calls + self-attr writes at this held context, without
        descending into compound-statement bodies (visit() does that)."""
        shallow = [st]
        if isinstance(st, (ast.If, ast.While)):
            shallow = [st.test]
        elif isinstance(st, ast.For):
            shallow = [st.iter, st.target]
        elif isinstance(st, ast.Try):
            shallow = []
        self._scan_exprs(qn, fi, shallow, held)
        if isinstance(st, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            tgts = st.targets if isinstance(st, ast.Assign) else [st.target]
            for tgt in tgts:
                els = tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]
                for el in els:
                    # self.x = … and container writes self.x[i] = …
                    if isinstance(el, ast.Subscript):
                        el = el.value
                    if isinstance(el, ast.Attribute) and \
                            isinstance(el.value, ast.Name) and \
                            el.value.id == "self":
                        self.self_writes[qn].append(
                            (tuple(held), el.attr, el.lineno))

    def _scan_exprs(self, qn, fi, nodes, held):
        sites = {id(s.node): s for s in self.graph.sites(qn)}
        for root in nodes:
            if root is None or isinstance(root, str):
                continue
            for sub in ast.walk(root if not hasattr(root, "context_expr")
                                else root.context_expr):
                if isinstance(sub, ast.Call) and id(sub) in sites:
                    self.calls_under[qn].append((tuple(held), sites[id(sub)]))

    # -------------------------------------------------------------- summaries
    def _fixpoint_summaries(self):
        """qualname -> set of lock idents acquired transitively inside."""
        summary = {qn: {a[1] for a in acqs}
                   for qn, acqs in self.acquisitions.items()}
        for qn in self.index.functions:
            summary.setdefault(qn, set())
        for _ in range(12):  # bounded fixpoint; call depth in-package is small
            changed = False
            for qn in self.index.functions:
                acc = summary[qn]
                before = len(acc)
                for _, site in self.calls_under.get(qn, ()):
                    for tgt in site.targets:
                        acc |= summary.get(tgt, set())
                if len(acc) != before:
                    changed = True
            if not changed:
                break
        return summary


def _lock_name(ident):
    owner, attr = ident
    return f"{owner.rsplit('.', 1)[-1]}.{attr}" if "." in owner else \
        f"{owner}.{attr}"


def lock_order_findings(index, graph, model):
    edges = defaultdict(list)   # (A, B) -> evidence strings
    findings = []
    for qn, acqs in model.acquisitions.items():
        fi = index.functions[qn]
        for held, ident, lineno in acqs:
            for h in held:
                if h == ident:
                    if model.locks.get(ident) not in REENTRANT:
                        findings.append(Finding(
                            rule="lock-order", path=fi.relpath, line=lineno,
                            symbol=qn,
                            detail=f"self-deadlock:{_lock_name(ident)}",
                            message=f"re-acquires non-reentrant "
                                    f"{_lock_name(ident)} already held in "
                                    f"{qn} — self-deadlock"))
                    continue
                edges[(h, ident)].append(
                    f"{qn} ({fi.relpath}:{lineno}) holds "
                    f"{_lock_name(h)} then takes {_lock_name(ident)}")
    # inter-procedural edges: call under held lock -> callee acquisitions
    seen_self = set()
    for qn, pairs in model.calls_under.items():
        fi = index.functions[qn]
        for held, site in pairs:
            if not held:
                continue
            for tgt in site.targets:
                for ident in model.summary.get(tgt, ()):
                    for h in held:
                        if h == ident:
                            # re-entry through a call chain: deadlock
                            # for a non-reentrant Lock
                            if model.locks.get(ident) in REENTRANT or \
                                    (qn, tgt, ident) in seen_self:
                                continue
                            seen_self.add((qn, tgt, ident))
                            findings.append(Finding(
                                rule="lock-order", path=fi.relpath,
                                line=site.lineno, symbol=qn,
                                detail=("self-deadlock:"
                                        f"{_lock_name(ident)}"),
                                message=f"{qn} holds non-reentrant "
                                        f"{_lock_name(ident)} and calls "
                                        f"{tgt}, which re-acquires it — "
                                        "self-deadlock candidate"))
                            continue
                        edges[(h, ident)].append(
                            f"{qn} ({fi.relpath}:{site.lineno}) holds "
                            f"{_lock_name(h)} and calls {tgt} which "
                            f"acquires {_lock_name(ident)}")
    # cycle detection (DFS over the order graph)
    adj = defaultdict(set)
    for (a, b) in edges:
        adj[a].add(b)
    findings.extend(_cycles(adj, edges))
    return findings


def _cycles(adj, edges):
    findings = []
    seen_cycles = set()
    for start in sorted(adj):
        stack = [(start, [start])]
        while stack:
            node, path = stack.pop()
            for nxt in sorted(adj.get(node, ())):
                if nxt == start and len(path) > 1:
                    cyc = frozenset(path)
                    if cyc in seen_cycles:
                        continue
                    seen_cycles.add(cyc)
                    names = " -> ".join(_lock_name(p) for p in
                                        path + [start])
                    ev = []
                    hops = list(zip(path, path[1:] + [start]))
                    for hop in hops:
                        ev.extend(edges.get(hop, [])[:2])
                    findings.append(Finding(
                        rule="lock-order", path="", line=0,
                        symbol="cycle:" + "|".join(
                            sorted(_lock_name(p) for p in path)),
                        detail="cycle",
                        message=f"lock-order cycle (deadlock candidate): "
                                f"{names}",
                        chain=tuple(ev)))
                elif nxt not in path and len(path) < 6:
                    stack.append((nxt, path + [nxt]))
    return findings


# ------------------------------------------------------------ shared state
def thread_entries(index, graph):
    """-> {qualname: how} background-thread entry functions."""
    out = {}
    for qn, fi in index.functions.items():
        mi = index.modules[fi.module]
        for call in iter_body_calls(fi.node):
            text = dotted(call.func)
            if not text:
                continue
            head = text.split(".")[0]
            resolved = text.replace(head, mi.imports.get(head, head), 1)
            base = text.rsplit(".", 1)[-1]
            refs = []
            if base in ("Thread", "Timer") and (
                    resolved.startswith("threading.") or text == base):
                refs = [kw.value for kw in call.keywords
                        if kw.arg in ("target", "function")]
                if base == "Timer" and len(call.args) >= 2:
                    refs.append(call.args[1])
            elif resolved in config.THREAD_REGISTER_CALLS or \
                    text in config.THREAD_REGISTER_CALLS:
                if base == "finalize" and len(call.args) >= 2:
                    refs = [call.args[1]]
                elif base == "signal" and len(call.args) >= 2:
                    refs = [call.args[1]]
                else:
                    refs = call.args[:1]
            for r in refs:
                ref = resolve_fn_ref(index, fi, r)
                if ref:
                    out.setdefault(
                        ref, f"{base} target at {fi.relpath}:{call.lineno}")
        out.update({k: v for k, v in _engine_tasks(index, graph, qn, fi)
                    if k not in out})
    for cqn, ci in index.classes.items():
        thread_subclass = any(b.rsplit(".", 1)[-1] == "Thread"
                              for b in ci.bases)
        handler = any("Handler" in b or "Server" in b for b in ci.bases)
        for name, mqn in ci.methods.items():
            if name == "run" and thread_subclass:
                out.setdefault(mqn, "Thread subclass run()")
            elif name in config.THREAD_ENTRY_METHOD_NAMES and \
                    name != "run" and handler:
                out.setdefault(mqn, f"handler method {name}()")
    return out


def _engine_tasks(index, graph, qn, fi):
    """Yield (qualname, how) for the tasks ``qn`` pushes to the host
    engine: a function reference, or every call a lambda task makes."""
    sites = {id(s.node): s for s in graph.sites(qn)}
    for site in graph.sites(qn):
        call = site.node
        if not isinstance(call, ast.Call) or \
                not config.ENGINE_PUSH_TARGETS.intersection(site.targets):
            continue
        tasks = call.args[:1] + [kw.value for kw in call.keywords
                                 if kw.arg == "fn"]
        how = f"host-engine task pushed at {fi.relpath}:{call.lineno}"
        for task in tasks:
            if isinstance(task, ast.Lambda):
                for sub in ast.walk(task.body):
                    inner = sites.get(id(sub))
                    for tgt in inner.targets if inner else ():
                        yield tgt, how
                continue
            ref = resolve_fn_ref(index, fi, task)
            if ref:
                yield ref, how


def shared_state_findings(index, graph, model):
    entries = thread_entries(index, graph)
    if not entries:
        return []
    # closure of each background root over the call graph
    bg_reach = {}
    for root in entries:
        bg_reach[root] = set(graph.reachable((root,)))
    findings = []
    by_class = defaultdict(list)   # class qualname -> bg roots in that class
    for root in entries:
        fi = index.functions[root]
        cls = fi.cls
        if not cls and fi.parent:
            cls = index.functions[fi.parent].cls
        if cls:
            by_class[cls].append(root)
    for cqn, roots in sorted(by_class.items()):
        ci = index.classes[cqn]
        # main domain: the PUBLIC API only — private helpers join a
        # domain by being reached from a public method or a bg root
        mains = [mqn for name, mqn in ci.methods.items()
                 if mqn not in entries and not name.startswith("_")]
        main_reach = set(graph.reachable(mains))
        # collect write sites per attr from methods + their nested defs
        writes = defaultdict(list)  # attr -> (domain, qn, line, held)
        members = [qn for qn in index.functions
                   if qn.startswith(cqn + ".")]
        for qn in members:
            if qn.endswith(".__init__") or ".__init__." in qn:
                continue
            for held, attr, lineno in model.self_writes.get(qn, ()):
                domains = {r for r in roots if qn in bg_reach[r]}
                if qn in main_reach:
                    domains.add("main")
                for d in domains:
                    writes[attr].append((d, qn, lineno, frozenset(held)))
        for attr, sites in sorted(writes.items()):
            domains = {d for d, *_ in sites}
            if len(domains) < 2:
                continue
            # find a conflicting pair: different domains, no common lock
            conflict = None
            for i, (d1, q1, l1, h1) in enumerate(sites):
                for d2, q2, l2, h2 in sites[i + 1:]:
                    if d1 != d2 and not (h1 & h2):
                        conflict = ((d1, q1, l1, h1), (d2, q2, l2, h2))
                        break
                if conflict:
                    break
            if not conflict:
                continue
            (d1, q1, l1, h1), (d2, q2, l2, h2) = conflict
            fi1, fi2 = index.functions[q1], index.functions[q2]

            def _dom(d):
                return "main thread" if d == "main" else f"bg:{d}"

            def _held(h):
                return ("{" + ", ".join(sorted(_lock_name(x) for x in h))
                        + "}") if h else "no lock"
            findings.append(Finding(
                rule="shared-state", path=fi1.relpath, line=l1,
                symbol=f"{cqn}.{attr}", detail=f"race:{attr}",
                message=f"self.{attr} written from {_dom(d1)} "
                        f"({q1}:{l1}, {_held(h1)}) and {_dom(d2)} "
                        f"({fi2.relpath}:{l2} in {q2}, {_held(h2)}) "
                        "with no common lock — race candidate",
                chain=(f"{q1} ({fi1.relpath}:{l1}) holds {_held(h1)}",
                       f"{q2} ({fi2.relpath}:{l2}) holds {_held(h2)}")))
    return findings


def run(index, graph):
    model = LockModel(index, graph)
    return lock_order_findings(index, graph, model) + \
        shared_state_findings(index, graph, model)

"""Approximate whole-package call graph of the port (parity:
``mxnet_tpu/analysis/callgraph.py``).

Resolution strategy, in decreasing precision (every edge remembers how
it was made so reports can say "virtual" when the match was by name):

1.  plain names — local nested def, module-level def, or an imported
    function (``from .x import f``) resolved through the import map;
2.  ``self.m(...)`` — the enclosing class's method table, walking
    package-local base classes (single inheritance is all the package
    uses);
3.  ``self._attr.m(...)`` / local-var ``v.m(...)`` — cheap receiver
    typing: ``self._attr = ClassName(...)`` bindings collected at
    index time, plus per-function ``v = ClassName(...)`` assignments;
4.  ``F.apply(...)`` on a ``torch.autograd.Function`` subclass of the
    package resolves to its ``forward`` and ``backward`` (autograd runs
    the backward later, on the same loop);
5.  virtual fallback — any ``x.m(...)`` whose bare name is defined by
    at most ``virtual_max`` package functions resolves to all of them,
    unless the name sits on the stoplist of ubiquitous method names
    (those would wire the graph into a hairball of false edges).

This over-approximates (extra edges) by design: for invariant linting
a false edge costs a reviewed annotation, a missing edge costs a
silent invariant hole.  The stoplist + boundaries keep the noise
bounded in practice.
"""
import ast
from dataclasses import dataclass

from . import config
from .astutil import dotted

# Method names too common to fan out on: resolving `x.get()` to every
# `get` in the package would connect unrelated subsystems.  The second
# block is the tensor-method names of torch and numpy — `x.reshape(...)`
# is a tensor op, not `Executor.reshape`.
VIRTUAL_STOPLIST = frozenset({
    "get", "set", "put", "add", "items", "keys", "values", "append",
    "extend", "pop", "copy", "close", "read", "write", "run", "start",
    "join", "send", "recv", "open", "flush", "next", "reset", "clear",
    "remove", "insert", "index", "count", "sort", "split", "strip",
    "format", "encode", "decode", "update", "load", "save", "create",
    "name", "shape", "dtype", "wait", "stop", "step", "push", "pull",
    "__init__", "__call__", "__enter__", "__exit__",
    # generic callable names (op.fn, self._func, cb(...) …): fanning
    # out on these invents edges between unrelated subsystems
    "fn", "f", "func", "function", "callback", "hook", "thunk",
    # tensor-method names (torch, numpy and NDArray surface)
    "reshape", "astype", "transpose", "take", "sum", "mean", "max",
    "min", "prod", "dot", "flatten", "ravel", "squeeze", "clip",
    "round", "repeat", "cumsum", "argmax", "argmin", "any", "all",
    "broadcast_to", "swapaxes", "view", "fill", "flip", "nonzero",
    "to", "cuda", "cpu", "float", "half", "bfloat16", "int", "long",
    "bool", "contiguous", "detach", "clone", "numel", "size", "dim",
    "permute", "unsqueeze", "expand", "expand_as", "view_as", "zero_",
    "copy_", "fill_", "add_", "mul_", "div_", "sub_", "clamp", "abs",
    "exp", "log", "sqrt", "norm", "item", "tolist", "numpy", "record",
    "record_stream", "wait_stream", "wait_event", "synchronize",
    "query", "replay", "forward", "backward", "apply",
})


@dataclass
class CallSite:
    caller: str          # qualname of the function containing the call
    name: str            # bare called name ('' when the callee is opaque)
    recv: str            # receiver text: '', 'self', 'self._engine', 'np', …
    lineno: int
    node: object         # the ast.Call
    targets: tuple = ()  # resolved qualnames
    virtual: bool = False


def iter_body_calls(fn_node):
    """Every ast.Call lexically in this function, NOT descending into
    nested def/class bodies (their calls belong to the nested scope).
    Lambdas stay with the enclosing function."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        if isinstance(node, ast.Call):
            yield node
        stack.extend(ast.iter_child_nodes(node))


def iter_body_nodes(fn_node):
    """All statement/expression nodes of a function body, not descending
    into nested defs/classes."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def resolve_fn_ref(index, fi, node):
    """Resolve an expression used as a function *reference* (not call)
    to a qualname, mirroring the call-graph's name resolution."""
    if isinstance(node, ast.Name):
        name = node.id
        nested = f"{fi.qualname}.<locals>.{name}"
        if nested in index.functions:
            return nested
        if fi.parent:
            sibling = f"{fi.parent}.<locals>.{name}"
            if sibling in index.functions:
                return sibling
        flat = f"{fi.module}.{name}"
        if flat in index.functions:
            return flat
        target = index.modules[fi.module].imports.get(name)
        if target in index.functions:
            return target
    elif isinstance(node, ast.Attribute):
        recv = dotted(node.value)
        if recv == "self" and fi.cls:
            return index.mro_method(fi.cls, node.attr)
        if recv and isinstance(node.value, ast.Name):
            # local object: v = ClassName(...); Thread(target=v.method)
            mi = index.modules[fi.module]
            for sub in iter_body_nodes(fi.node):
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                        and isinstance(sub.targets[0], ast.Name) \
                        and sub.targets[0].id == recv \
                        and isinstance(sub.value, ast.Call):
                    cls = index.resolve_class(dotted(sub.value.func), mi)
                    if cls:
                        return index.mro_method(cls, node.attr)
    return None


def _is_autograd_function(index, cls_qn):
    """True for a class whose base is ``torch.autograd.Function`` (or a
    package class that is one)."""
    ci = index.classes.get(cls_qn)
    seen = set()
    while ci is not None and ci.qualname not in seen:
        seen.add(ci.qualname)
        if any(b.rsplit(".", 1)[-1] == "Function" for b in ci.bases):
            return True
        base = (index.resolve_class(ci.bases[0], index.modules[ci.module])
                if ci.bases else None)
        ci = index.classes.get(base) if base else None
    return False


class CallGraph:
    def __init__(self, index, virtual_max=4, stoplist=VIRTUAL_STOPLIST):
        self.index = index
        self.virtual_max = virtual_max
        self.stoplist = stoplist
        self.calls = {}          # qualname -> [CallSite]
        self._toplevels = {m.split(".")[0] for m in index.modules}
        self._build()

    # ------------------------------------------------------------- build
    def _build(self):
        for qn, fi in self.index.functions.items():
            local_types = self._local_types(fi)
            sites = []
            for call in iter_body_calls(fi.node):
                site = self._resolve(fi, call, local_types)
                sites.append(site)
                sites.extend(self._ref_sites(fi, call, site))
            self.calls[qn] = sites

    def _ref_sites(self, fi, call, site):
        """Edges to package functions passed as arguments (``_on(q,
        plain, _cuda_fwd)``, ``sorted(key=f)``): the callee may call
        them on this thread.  A thread's target, a signal or atexit
        callback and a host-engine task run elsewhere and get none (the
        locks rule takes them as thread entries)."""
        text = dotted(call.func)
        if text in config.THREAD_TARGET_CALLS or \
                text in config.THREAD_REGISTER_CALLS or \
                config.ENGINE_PUSH_TARGETS.intersection(site.targets):
            return []
        out = []
        for arg in list(call.args) + [kw.value for kw in call.keywords]:
            if not isinstance(arg, (ast.Name, ast.Attribute)):
                continue
            ref = resolve_fn_ref(self.index, fi, arg)
            if ref:
                out.append(CallSite(fi.qualname, f"<ref {dotted(arg)}>",
                                    "", call.lineno, arg, (ref,)))
        return out

    def _local_types(self, fi):
        """name -> class qualname for `v = ClassName(...)` and
        `v = self._attr` (typed attr) assignments in this function."""
        mi = self.index.modules[fi.module]
        ci = self.index.classes.get(fi.cls)
        out = {}
        for node in iter_body_nodes(fi.node):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            tgt = node.targets[0]
            if not isinstance(tgt, ast.Name):
                continue
            if isinstance(node.value, ast.Call):
                cls = self.index.resolve_class(dotted(node.value.func), mi)
                if cls:
                    out[tgt.id] = cls
            elif (ci is not None and isinstance(node.value, ast.Attribute)
                  and isinstance(node.value.value, ast.Name)
                  and node.value.value.id == "self"):
                cls = ci.attr_types.get(node.value.attr)
                if cls:
                    out[tgt.id] = cls
        return out

    def _resolve(self, fi, call, local_types):
        idx = self.index
        mi = idx.modules[fi.module]
        func = call.func
        if isinstance(func, ast.Name):
            name = func.id
            # nested def in this very function
            nested = f"{fi.qualname}.<locals>.{name}"
            if nested in idx.functions:
                return CallSite(fi.qualname, name, "", call.lineno, call,
                                (nested,))
            # module-level def
            flat = f"{fi.module}.{name}"
            if flat in idx.functions:
                return CallSite(fi.qualname, name, "", call.lineno, call,
                                (flat,))
            target = mi.imports.get(name)
            if target:
                if target in idx.functions:
                    return CallSite(fi.qualname, name, "", call.lineno, call,
                                    (target,))
                if target in idx.classes:
                    init = idx.mro_method(target, "__init__")
                    return CallSite(fi.qualname, name, "", call.lineno, call,
                                    (init,) if init else ())
            # constructor by bare class name in same module
            cls = idx.resolve_class(name, mi)
            if cls:
                init = idx.mro_method(cls, "__init__")
                return CallSite(fi.qualname, name, "", call.lineno, call,
                                (init,) if init else ())
            return CallSite(fi.qualname, name, "", call.lineno, call)
        if isinstance(func, ast.Attribute):
            name = func.attr
            recv = dotted(func.value) or ""
            targets, virtual = self._resolve_attr(fi, mi, recv, name,
                                                  local_types)
            return CallSite(fi.qualname, name, recv, call.lineno, call,
                            tuple(targets), virtual)
        return CallSite(fi.qualname, "", "", call.lineno, call)

    def _resolve_attr(self, fi, mi, recv, name, local_types):
        idx = self.index
        if name == "apply" and recv:
            # F.apply(...) of a package autograd.Function: its forward
            # now and its backward when autograd runs it
            fn_cls = idx.resolve_class(recv, mi)
            if fn_cls and _is_autograd_function(idx, fn_cls):
                ci = idx.classes[fn_cls]
                hits = [ci.methods[m] for m in ("forward", "backward")
                        if m in ci.methods]
                if hits:
                    return hits, False
        # module alias receiver: np.foo, _tm.span, checkpoint.save, …
        head = recv.split(".")[0] if recv else ""
        if recv and head in mi.imports:
            target = mi.imports[head]
            rest = recv[len(head) + 1:] if "." in recv else ""
            base = target + ("." + rest if rest else "")
            cand = f"{base}.{name}"
            if cand in idx.functions:
                return [cand], False
            if base in idx.classes:
                m = idx.mro_method(base, name)
                if m:
                    return [m], False
            if target.split(".")[0] not in self._toplevels:
                # external module (torch.zeros, np.pad, …): the callee
                # lives outside the package — fanning out to same-named
                # package functions would invent edges
                return [], False
        # self.m()
        if recv == "self" and fi.cls:
            m = idx.mro_method(fi.cls, name)
            if m:
                return [m], False
        # self._attr.m() through attr types
        if recv.startswith("self.") and fi.cls and recv.count(".") == 1:
            ci = idx.classes.get(fi.cls)
            cls = ci.attr_types.get(recv.split(".", 1)[1]) if ci else None
            if cls:
                m = idx.mro_method(cls, name)
                if m:
                    return [m], False
        # typed local receiver
        if recv in local_types:
            m = idx.mro_method(local_types[recv], name)
            if m:
                return [m], False
        # virtual fan-out by bare name
        if name not in self.stoplist:
            hits = idx.by_name.get(name, [])
            if 0 < len(hits) <= self.virtual_max:
                return list(hits), True
        return [], False

    # ----------------------------------------------------------- queries
    def sites(self, qualname):
        return self.calls.get(qualname, ())

    def reachable(self, roots, boundaries=frozenset(), into_nested=True):
        """BFS from ``roots``; returns {qualname: (parent_qualname,
        CallSite)} witness tree (roots map to (None, None)).  Traversal
        does not descend INTO boundary functions (they may sync/branch
        by contract) but boundaries themselves appear in the result.
        Nested defs of a reached function are NOT auto-included — they
        run only if called (or jitted, which rules handle separately)."""
        seen = {}
        queue = []
        for r in roots:
            if r in self.index.functions and r not in seen:
                seen[r] = (None, None)
                queue.append(r)
        while queue:
            qn = queue.pop(0)
            if qn in boundaries:
                continue
            for site in self.sites(qn):
                for tgt in site.targets:
                    if tgt not in seen and tgt in self.index.functions:
                        seen[tgt] = (qn, site)
                        queue.append(tgt)
        return seen

    def chain(self, witness, qualname):
        """Entry→qualname evidence chain as printable steps."""
        steps = []
        cur = qualname
        while cur is not None:
            parent, site = witness.get(cur, (None, None))
            fi = self.index.functions.get(cur)
            if site is not None and parent is not None:
                pfi = self.index.functions[parent]
                steps.append(f"{parent} calls {site.name or '<call>'} "
                             f"({pfi.relpath}:{site.lineno})")
            elif fi is not None:
                steps.append(f"{cur} ({fi.relpath}:{fi.lineno}) [entry]")
            cur = parent
        return tuple(reversed(steps))

"""Rule family 2 — capture purity (parity:
``mxnet_tpu/analysis/trace_purity.py``, re-rooted for CUDA graphs).

The port's traced code is what runs while ``torch.cuda.graph`` captures:
Python runs ONCE, at capture, and every replay repeats only the
recorded kernels.  Host side effects there (telemetry, clocks, host
RNG, writes to captured Python state) happen once and vanish from the
replays, and a host sync raises under capture.  The reference's roots
(``jit``, ``pallas_call``, ``scan``, ``custom_vjp``, ...) are JAX's and
match nothing here; the port's are:

capture roots
    - the functions called inside a ``with torch.cuda.graph(...)``
      block (the trainer's captured step, the epilogue's tuning pass),
      and the block's own statements;
    - every op implementation registered via ``@register(...)`` under
      ``mxnet_tpu_torch/ops/`` (``step_multi`` replays them);
    - every function of the modules in ``config.TRACED_MODULES``
      (``optim_rules``: the bucket, sentinel and loss-scale updates);
    - through the call graph, the ``forward``/``backward`` of each
      ``torch.autograd.Function`` those reach (``F.apply``).

checks, per reached function
    - calls into banned host modules (``time``, ``numpy.random``,
      ``random``, ``mxnet_tpu_torch.telemetry``) and ``print``;
    - calls on module-global telemetry instruments (``_TM_X.inc``);
    - host-sync primitives (shared with the host-sync rule), which
      raise under capture;
    - writes to captured state (``self.attr = …``, ``global`` writes,
      subscript/attr stores into closed-over names);
    - on roots, where parameterhood is known, Python branching on a
      tensor parameter (its truth value is a sync).

Every violation names the capture root that reaches it.
"""
import ast

from . import config
from .astutil import dotted
from .callgraph import iter_body_calls, iter_body_nodes
from .host_sync import sync_sites
from .report import Finding

def _is_capture_context(mi, expr):
    """True for ``torch.cuda.graph(...)`` (through any import alias)."""
    if not isinstance(expr, ast.Call):
        return False
    text = dotted(expr.func)
    if not text:
        return False
    head = text.split(".")[0]
    full = text.replace(head, mi.imports.get(head, head), 1)
    return full in config.CAPTURE_CONTEXTS


class _CaptureBlock:
    """FunctionInfo stand-in for the statements of one ``with
    torch.cuda.graph(...)`` block, checked as code that runs once."""

    def __init__(self, fi, with_node):
        self.qualname = f"{fi.qualname}.<capture>"
        self.module = fi.module
        self.cls = fi.cls
        self.parent = fi.qualname
        self.name = "<capture>"
        self.relpath = fi.relpath
        self.lineno = with_node.lineno
        self.node = ast.FunctionDef(
            name="<capture>", args=ast.arguments(
                posonlyargs=[], args=[], vararg=None, kwonlyargs=[],
                kw_defaults=[], kwarg=None, defaults=[]),
            body=with_node.body, decorator_list=[], lineno=with_node.lineno)


def capture_blocks(index):
    """-> [(FunctionInfo, ast.With)] for every ``with torch.cuda.graph``
    block in the package."""
    out = []
    for fi in index.functions.values():
        mi = index.modules[fi.module]
        for node in iter_body_nodes(fi.node):
            if isinstance(node, ast.With) and any(
                    _is_capture_context(mi, item.context_expr)
                    for item in node.items):
                out.append((fi, node))
    return out


def find_trace_roots(index, graph):
    """-> {qualname: how} for every function that runs under capture by
    construction (see the module docstring)."""
    roots = {}
    for qn, fi in index.functions.items():
        if fi.module in config.TRACED_MODULES:
            roots.setdefault(qn, f"function in captured module {fi.module}")
    for qn, fi in index.functions.items():
        if not fi.module.startswith(config.ENV_PACKAGE + ".ops"):
            continue
        for dec in fi.decorators:
            if dec in config.OP_REGISTER_DECORATORS or \
                    dec.endswith(".register()"):
                roots.setdefault(qn, "op implementation (@register), "
                                     "replayed by step_multi")
    for fi, node in capture_blocks(index):
        inside = {id(c) for st in node.body for c in ast.walk(st)}
        for site in graph.sites(fi.qualname):
            if id(site.node) not in inside:
                continue
            for tgt in site.targets:
                roots.setdefault(tgt, f"called under torch.cuda.graph at "
                                      f"{fi.relpath}:{node.lineno}")
    return roots


def _module_instruments(index):
    """Per module: names of module-global telemetry instrument objects
    (assigned from a call into mxnet_tpu_torch.telemetry*)."""
    prefix = config.ENV_PACKAGE + ".telemetry"
    out = {}
    for modname, mi in index.modules.items():
        names = set()
        for node in ast.iter_child_nodes(mi.tree):
            if not (isinstance(node, ast.Assign) and
                    isinstance(node.value, ast.Call)):
                continue
            text = dotted(node.value.func)
            head = text.split(".")[0] if text else ""
            target = mi.imports.get(head, head)
            full = text.replace(head, target, 1) if text else ""
            if target.startswith(prefix) or full.startswith(prefix):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        names.add(tgt.id)
        out[modname] = names
    return out


def _local_names(fn_node):
    """Names bound in the function scope (params, assignments, loop and
    with targets, nested defs, imports)."""
    names = set()
    args = fn_node.args
    for a in (args.posonlyargs + args.args + args.kwonlyargs +
              ([args.vararg] if args.vararg else []) +
              ([args.kwarg] if args.kwarg else [])):
        names.add(a.arg)
    for node in iter_body_nodes(fn_node):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            names.add(node.id)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                names.add((a.asname or a.name).split(".")[0])
    for child in ast.iter_child_nodes(fn_node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names.add(child.name)
    return names


def _traced_params(fi):
    args = fi.node.args
    pos = [a.arg for a in (args.posonlyargs + args.args)]
    return {p for p in pos if p not in config.UNTRACED_PARAM_NAMES
            and not p.startswith("_")
            # static selector/config params by naming convention
            and not p.endswith(("_name", "_names", "_params", "_attrs"))}


def purity_violations(index, fi, instruments, is_root, mutations=True):
    mi = index.modules[fi.module]
    # --- banned calls
    for call in iter_body_calls(fi.node):
        func = call.func
        if isinstance(func, ast.Name) and func.id == "print":
            yield (call.lineno, "print", "print() under capture runs at "
                   "capture only")
            continue
        if not isinstance(func, ast.Attribute):
            continue
        recv = dotted(func.value)
        if not recv:
            continue
        head = recv.split(".")[0]
        target = mi.imports.get(head, head)
        resolved = recv.replace(head, target, 1)
        full = f"{resolved}.{func.attr}"
        for prefix, why in config.TRACE_BANNED_MODULE_PREFIXES:
            if resolved == prefix or resolved.startswith(prefix + ".") or \
                    full == prefix:
                yield (call.lineno, prefix, f"{recv}.{func.attr}(): {why}")
                break
        else:
            if (recv in instruments.get(fi.module, ()) and
                    func.attr in config.TELEMETRY_INSTRUMENT_METHODS):
                yield (call.lineno, "telemetry-instrument",
                       f"{recv}.{func.attr}() telemetry write under "
                       "capture — move it to the replay site")
    # --- host syncs under capture
    for lineno, prim, desc in sync_sites(index, fi):
        yield (lineno, f"sync:{prim}",
               f"{desc} — a sync raises under capture")
    # --- captured-state writes (constructors exempt: __init__ writes
    # populate a brand-new object, they don't mutate captured state)
    if not mutations or fi.name in ("__init__", "__new__",
                                    "__post_init__"):
        return
    local = None
    for node in iter_body_nodes(fi.node):
        if isinstance(node, ast.Global):
            yield (node.lineno, "captured-mutation",
                   f"global statement writes module state under capture "
                   f"({', '.join(node.names)}): once, not in replays")
        tgt_list = []
        if isinstance(node, ast.Assign):
            tgt_list = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            tgt_list = [node.target]
        for tgt in tgt_list:
            if isinstance(tgt, ast.Attribute):
                base = dotted(tgt.value).split(".")[0]
                if base == "self":
                    yield (tgt.lineno, "captured-mutation",
                           f"self.{tgt.attr} = … writes captured object "
                           "state under capture: once, not in replays")
                    continue
            if isinstance(tgt, (ast.Attribute, ast.Subscript)):
                base = dotted(tgt.value).split(".")[0] if \
                    dotted(tgt.value) else (
                        tgt.value.id if isinstance(tgt.value, ast.Name)
                        else "")
                if not base:
                    continue
                if local is None:
                    local = _local_names(fi.node)
                if base not in local and base != "self":
                    yield (tgt.lineno, "captured-mutation",
                           f"store into captured/global '{base}' under "
                           "capture: once, not in replays")
    # --- host branching on tensor params (roots only: parameterhood
    # known)
    if is_root:
        params = _traced_params(fi)
        for node in iter_body_nodes(fi.node):
            if not isinstance(node, (ast.If, ast.While)):
                continue
            bad = _branch_on_param(node.test, params)
            if bad:
                yield (node.lineno, "tensor-branch",
                       f"Python branch on tensor '{bad}' — its truth "
                       "value syncs (use torch.where; static facts like "
                       ".shape are fine and not flagged)")


def _branch_on_param(test, params):
    if isinstance(test, ast.Name) and test.id in params:
        return test.id
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _branch_on_param(test.operand, params)
    if isinstance(test, ast.BoolOp):
        for v in test.values:
            bad = _branch_on_param(v, params)
            if bad:
                return bad
    if isinstance(test, ast.Compare):
        ops = test.ops
        if any(isinstance(o, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
               for o in ops):
            return None
        for side in [test.left] + list(test.comparators):
            if isinstance(side, ast.Name) and side.id in params:
                return side.id
    return None


def _boundaries(index):
    """config.CAPTURE_BOUNDARIES plus every function of the telemetry
    package: the call into it is the finding, its interior is not."""
    prefix = config.ENV_PACKAGE + ".telemetry"
    return frozenset(config.CAPTURE_BOUNDARIES) | {
        qn for qn, fi in index.functions.items()
        if fi.module == prefix or fi.module.startswith(prefix + ".")}


def run(index, graph):
    roots = find_trace_roots(index, graph)
    instruments = _module_instruments(index)
    boundaries = _boundaries(index)
    witness = graph.reachable(sorted(roots), boundaries=boundaries)
    findings = []
    # the capture blocks' own statements: no mutation check (they run
    # once by design, binding the graph's static outputs)
    for fi, node in capture_blocks(index):
        block = _CaptureBlock(fi, node)
        for lineno, kind, desc in purity_violations(
                index, block, instruments, is_root=False, mutations=False):
            findings.append(Finding(
                rule="trace-purity", path=fi.relpath, line=lineno,
                symbol=block.qualname, detail=kind,
                message=f"impure captured code: {desc} [capture block "
                        f"{fi.relpath}:{node.lineno}]"))
    for qn in sorted(witness):
        if qn in boundaries:
            continue
        fi = index.functions[qn]
        # find the root whose witness chain reaches qn
        root = qn
        while witness.get(root, (None, None))[0] is not None:
            root = witness[root][0]
        how = roots.get(root, "")
        for lineno, kind, desc in purity_violations(
                index, fi, instruments, is_root=qn in roots):
            findings.append(Finding(
                rule="trace-purity", path=fi.relpath, line=lineno,
                symbol=qn, detail=kind,
                message=f"impure captured code: {desc} "
                        f"[capture root: {root} — {how or 'transitive'}]",
                chain=graph.chain(witness, qn)))
    return findings

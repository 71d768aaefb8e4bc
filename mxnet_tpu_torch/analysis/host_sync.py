"""Rule family 1 — host-sync escape analysis (parity:
``mxnet_tpu/analysis/host_sync.py``).

No device-to-host wait may run on a steady-state path: from a declared
entry point (``Module.fit``'s step body, the fused trainer's step, a
serving tick, a fused kvstore push or pull, a checkpoint capture, the
parameter-server stores, ...) no sync primitive may execute.  The CPU
tests count syncs in the loops they drive and ``chip_smoke.py`` samples
a few under ``torch.cuda.set_sync_debug_mode``; this rule proves it
over the whole call graph:

    flag every sync primitive lexically inside any function reachable
    from an entry point, unless the site carries ``# sync-ok: <why>``
    or the traversal was stopped by a registered boundary function.

Primitives (``config.py``): ``.item() / .tolist() / .cpu() / .numpy() /
.asnumpy() / .wait_to_read() / .synchronize() / .nonzero() /
.masked_select() / .unique() / .equal()`` on anything (``torch.nonzero``
and ``torch.cuda.synchronize`` too), ``.to("cpu")``,
``repeat_interleave`` of tensor repeats without ``output_size=``, an
upload from pageable host memory (``torch.from_numpy(a).to(dev)``,
``torch.tensor(x, device=dev)``: the card flags it, since the copy waits
for the stream), and — through a branch-sensitive local type walk —
``np.asarray``-family calls, ``float()/int()/bool()`` casts and
``if``/``while`` tests on values known to be tensors (those go through
``Tensor.__array__``/``__float__``/``__bool__``, which copy to the host).
"""
import ast

from . import config
from .astutil import dotted
from .callgraph import iter_body_calls, iter_body_nodes
from .report import Finding


def _tensor_annotation(ann):
    text = dotted(ann) if ann is not None else ""
    return bool(text) and text.rsplit(".", 1)[-1] in config.TENSOR_CLASSES


def _is_tensor_ctor(mi, value):
    """True when ``value`` builds a tensor: a tensor class's constructor
    or a torch factory (``torch.zeros(...)``)."""
    if not isinstance(value, ast.Call):
        return False
    text = dotted(value.func)
    if not text:
        return False
    base = text.rsplit(".", 1)[-1]
    if base in config.TENSOR_CLASSES:
        return True
    head = text.split(".")[0]
    target = mi.imports.get(head, head) if mi is not None else head
    return target == "torch" and "." in text and \
        base in config.TENSOR_FACTORIES


def _narrowed_tensorish(fn_node, mi=None):
    """-> {node id: set of tensor-ish names in scope at that node}, for
    every ast.Call and every ``if``/``while`` statement.

    Branch-sensitive: ``isinstance(x, torch.Tensor)`` narrows x inside
    the if-body only (and un-narrows it in the else); ``x = torch.zeros(
    ...)`` or ``x = NDArray(...)`` narrows x for the rest of the block; a
    ``x: torch.Tensor`` parameter is a tensor from the start.  Cheap and
    local by design — it exists to catch the ``np.asarray(t)`` /
    ``float(t)`` / ``if t:`` shapes of sync, not to type the package.
    """
    out = {}

    def isinstance_target(test):
        if (isinstance(test, ast.Call) and isinstance(test.func, ast.Name)
                and test.func.id == "isinstance"
                and len(test.args) == 2
                and isinstance(test.args[0], ast.Name)):
            classes = test.args[1]
            names = ([dotted(classes)] if not isinstance(classes, ast.Tuple)
                     else [dotted(e) for e in classes.elts])
            if any(n.rsplit(".", 1)[-1] in config.TENSOR_CLASSES
                   for n in names if n):
                return test.args[0].id
        return None

    def mark(node, env):
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                out.setdefault(id(sub), set()).update(env)

    def visit_block(stmts, env):
        env = set(env)
        for st in stmts:
            if isinstance(st, ast.If):
                tgt = isinstance_target(st.test)
                out.setdefault(id(st), set()).update(env)
                mark(st.test, env)
                visit_block(st.body, env | {tgt} if tgt else env)
                visit_block(st.orelse, env - {tgt} if tgt else env)
                continue
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue
            if isinstance(st, ast.Assign) and len(st.targets) == 1 and \
                    isinstance(st.targets[0], ast.Name):
                name = st.targets[0].id
                mark(st.value, env)
                if _is_tensor_ctor(mi, st.value):
                    env.add(name)
                else:
                    env.discard(name)
                continue
            if isinstance(st, (ast.For, ast.While, ast.With, ast.Try)):
                if isinstance(st, ast.While):
                    out.setdefault(id(st), set()).update(env)
                mark(getattr(st, "test", None) or getattr(st, "iter", None)
                     or st, env)
                for attr in ("body", "orelse", "finalbody"):
                    visit_block(getattr(st, attr, []) or [], env)
                for h in getattr(st, "handlers", []) or []:
                    visit_block(h.body, env)
                continue
            mark(st, env)
        return env

    args = fn_node.args
    params = {a.arg for a in (args.posonlyargs + args.args + args.kwonlyargs)
              if _tensor_annotation(a.annotation)}
    visit_block(fn_node.body, params)
    return out


def _tensor_test(test, names):
    """The tensor-ish name whose truth value ``test`` asks for, or None:
    a bare name, ``not name``, a boolean operand, or a side of an
    ordering/equality comparison (``is``/``in`` compare no values)."""
    if isinstance(test, ast.Name) and test.id in names:
        return test.id
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _tensor_test(test.operand, names)
    if isinstance(test, ast.BoolOp):
        for v in test.values:
            bad = _tensor_test(v, names)
            if bad:
                return bad
    if isinstance(test, ast.Compare):
        if any(isinstance(o, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
               for o in test.ops):
            return None
        for side in [test.left] + list(test.comparators):
            if isinstance(side, ast.Name) and side.id in names:
                return side.id
    return None


def _to_host(call):
    """True for ``.to("cpu")``/``.to(device="cpu")``/``.to(torch.device(
    "cpu"))``: a constant host device."""
    dev = call.args[0] if call.args else next(
        (kw.value for kw in call.keywords if kw.arg == "device"), None)
    if isinstance(dev, ast.Call) and dotted(dev.func).endswith("device") \
            and dev.args:
        dev = dev.args[0]
    return isinstance(dev, ast.Constant) and isinstance(dev.value, str) \
        and dev.value.split(":")[0] in config.HOST_DEVICES


def _torch_call(mi, node, names):
    """True when ``node`` calls ``torch.<one of names>``."""
    if not isinstance(node, ast.Call):
        return False
    text = dotted(node.func)
    head = text.split(".")[0] if text else ""
    return mi.imports.get(head, head) == "torch" and \
        text.count(".") == 1 and text.rsplit(".", 1)[-1] in names


def _kw(call, name):
    return next((kw.value for kw in call.keywords if kw.arg == name), None)


def _host_tensor_names(fn_node, mi):
    """Names bound (anywhere in the function) to a host tensor made
    there: torch.from_numpy/tensor/as_tensor with no device."""
    out = set()
    for node in iter_body_nodes(fn_node):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                _torch_call(mi, node.value, config.HOST_TENSOR_CALLS) and \
                _kw(node.value, "device") is None:
            out.add(node.targets[0].id)
    return out


def _pageable_upload(call, mi, host_names):
    """True for an upload that waits: ``torch.tensor/as_tensor(...,
    device=<not the host>)``, or ``.to(<device>)``/``.cuda()`` without
    ``non_blocking=True`` of a host tensor made in the function."""
    func = call.func
    if _torch_call(mi, call, config.HOST_TENSOR_CALLS - {"from_numpy"}):
        dev = _kw(call, "device")
        return dev is not None and not (
            isinstance(dev, ast.Constant) and isinstance(dev.value, str)
            and dev.value.split(":")[0] in config.HOST_DEVICES)
    if not (isinstance(func, ast.Attribute)
            and func.attr in config.UPLOAD_METHODS):
        return False
    recv = func.value
    host = _torch_call(mi, recv, config.HOST_TENSOR_CALLS) and \
        _kw(recv, "device") is None or \
        isinstance(recv, ast.Name) and recv.id in host_names
    if not host or _to_host(call):
        return False
    if func.attr == "to" and not call.args and _kw(call, "device") is None:
        return False            # .to(dtype=...) copies on the host
    nb = _kw(call, "non_blocking")
    return not (isinstance(nb, ast.Constant) and nb.value is True)


def _sized_sync(call, name, recv, mi, names):
    """True when ``repeat_interleave`` sizes its output from the card:
    no ``output_size=`` and repeats that may be a tensor (absent, a
    tensor-ish name, or an expression that is not ``int()``/``len()``;
    a plain name or a constant is taken for a Python int)."""
    if any(kw.arg == config.SIZED_SYNC_METHODS[name]
           for kw in call.keywords):
        return False
    head = recv.split(".")[0] if recv else ""
    is_fn = mi.imports.get(head, head) == "torch" and "." not in recv
    pos = 1 if is_fn else 0
    rep = call.args[pos] if len(call.args) > pos else next(
        (kw.value for kw in call.keywords if kw.arg == "repeats"), None)
    if rep is None:
        return True
    if isinstance(rep, ast.Name):
        return rep.id in names
    if isinstance(rep, ast.Constant):
        return False
    return not (isinstance(rep, ast.Call) and isinstance(rep.func, ast.Name)
                and rep.func.id in ("int", "len"))


def _numpy_recv(recv, mi):
    head = recv.split(".")[0] if recv else ""
    target = mi.imports.get(head, "")
    return target.split(".")[0] in config.NUMPY_MODULES


def _arg_name(call):
    if call.args and isinstance(call.args[0], ast.Name):
        return call.args[0].id
    return None


def sync_sites(index, fi):
    """All sync-primitive sites lexically in one function:
    yields (lineno, primitive, description)."""
    mi = index.modules[fi.module]
    tensorish = None
    host_names = _host_tensor_names(fi.node, mi)
    for call in iter_body_calls(fi.node):
        func = call.func
        if _pageable_upload(call, mi, host_names):
            yield (call.lineno, "h2d-upload",
                   "an upload from pageable host memory waits for the "
                   "stream (pin it and pass non_blocking=True)")
            continue
        if isinstance(func, ast.Attribute):
            name = func.attr
            recv = dotted(func.value)
            if name in config.SYNC_METHODS:
                yield (call.lineno, name,
                       f".{name}() on {recv or 'expression'}")
                continue
            if name in config.HOST_COPY_METHODS and _to_host(call):
                yield (call.lineno, f"{name}-cpu",
                       f".{name}(\"cpu\") on {recv or 'expression'} "
                       "copies to the host")
                continue
            if name in config.SIZED_SYNC_METHODS:
                if tensorish is None:
                    tensorish = _narrowed_tensorish(fi.node, mi)
                if _sized_sync(call, name, recv, mi,
                               tensorish.get(id(call), ())):
                    yield (call.lineno, name,
                           f".{name}() of tensor repeats without "
                           f"{config.SIZED_SYNC_METHODS[name]}= sizes its "
                           "output from the card's values")
                continue
            head = recv.split(".")[0] if recv else ""
            resolved = mi.imports.get(head, head)
            full = recv.replace(head, resolved, 1) if recv else ""
            if f"{full}.{name}" in config.SYNC_CALLS:
                yield (call.lineno, name, f"{recv}.{name}() waits for "
                       "the card")
                continue
            if (_numpy_recv(recv, mi) and
                    name in config.NUMPY_SYNC_FUNCS):
                if tensorish is None:
                    tensorish = _narrowed_tensorish(fi.node, mi)
                arg = _arg_name(call)
                if arg and arg in tensorish.get(id(call), ()):
                    yield (call.lineno, f"np.{name}",
                           f"np.{name}({arg}) on a tensor goes through "
                           "__array__ -> a copy to the host")
        elif isinstance(func, ast.Name) and func.id in config.BUILTIN_CASTS:
            if tensorish is None:
                tensorish = _narrowed_tensorish(fi.node, mi)
            arg = _arg_name(call)
            if arg and arg in tensorish.get(id(call), ()):
                yield (call.lineno, func.id,
                       f"{func.id}({arg}) on a tensor calls "
                       f"__{func.id}__ -> host sync")
    for node in iter_body_nodes(fi.node):
        if not isinstance(node, (ast.If, ast.While)):
            continue
        if tensorish is None:
            tensorish = _narrowed_tensorish(fi.node, mi)
        bad = _tensor_test(node.test, tensorish.get(id(node), ()))
        if bad:
            kw = "while" if isinstance(node, ast.While) else "if"
            yield (node.lineno, "tensor-test",
                   f"`{kw}` on tensor '{bad}' calls __bool__ -> host sync")


def run(index, graph):
    boundaries = frozenset(config.BOUNDARIES)
    witness = graph.reachable(config.ENTRY_POINTS, boundaries=boundaries)
    findings = []
    missing = [e for e in config.ENTRY_POINTS
               if e not in index.functions]
    for e in missing:
        findings.append(Finding(
            rule="host-sync", path="", line=0, symbol=e,
            detail="missing-entry",
            message=f"declared steady-state entry point {e} does not "
                    "exist — update mxnet_tpu_torch/analysis/config.py"))
    for qn in sorted(witness):
        if qn in boundaries:
            continue  # interior excused by registration
        fi = index.functions[qn]
        for lineno, prim, desc in sync_sites(index, fi):
            findings.append(Finding(
                rule="host-sync", path=fi.relpath, line=lineno,
                symbol=qn, detail=prim,
                message=f"host sync on a steady-state path: {desc} "
                        f"(in {qn})",
                chain=graph.chain(witness, qn)))
    return findings

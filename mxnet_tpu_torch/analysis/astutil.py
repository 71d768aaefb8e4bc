"""AST loading and indexing for the port lint (parity:
``mxnet_tpu/analysis/astutil.py``).

Parses every module of the package under analysis (stdlib ``ast`` only
— nothing is imported or executed) and builds the indexes every rule
family shares:

- modules:   dotted name -> :class:`ModuleInfo` (tree, source lines,
             import alias map)
- functions: qualname -> :class:`FunctionInfo` for every ``def`` —
             module functions, methods, *and* nested functions (the
             step bodies built inside factories live there); nested
             defs are qualified ``parent.<locals>.name`` like the
             runtime does.
- classes:   qualname -> :class:`ClassInfo` with a method table, base
             names, and ``self.x = ClassName(...)`` attribute-type
             bindings (the call graph's cheap receiver-type inference).

Qualnames are source-level, e.g.
``mxnet_tpu_torch.trainer.FusedTrainer.step``.
"""
import ast
import os
from dataclasses import dataclass, field


@dataclass
class ModuleInfo:
    name: str                     # dotted module name
    path: str                     # absolute file path
    relpath: str                  # repo-relative path (report currency)
    tree: ast.Module
    lines: list                   # raw source lines (1-based access via line())
    imports: dict = field(default_factory=dict)   # alias -> dotted target

    def line(self, lineno):
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


@dataclass
class FunctionInfo:
    qualname: str
    module: str                   # owning module dotted name
    cls: str                      # owning class qualname or ""
    name: str                     # bare name
    node: object                  # ast.FunctionDef / AsyncFunctionDef
    relpath: str
    lineno: int
    parent: str = ""              # enclosing function qualname (nested defs)
    decorators: tuple = ()        # decorator source dumps for cheap matching

    @property
    def is_method(self):
        return bool(self.cls) and not self.parent


@dataclass
class ClassInfo:
    qualname: str
    module: str
    name: str
    node: object
    bases: tuple = ()             # base-class names as written (dotted text)
    methods: dict = field(default_factory=dict)      # bare -> qualname
    attr_types: dict = field(default_factory=dict)   # self attr -> class qualname


def _expr_text(node):
    """Compact source-ish text for an expression (dotted names only)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _expr_text(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Call):
        return _expr_text(node.func) + "()"
    if isinstance(node, ast.Subscript):
        return _expr_text(node.value) + "[]"
    return ""


def dotted(node):
    """Dotted-name text for Name/Attribute chains, else ''."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted(node.value)
        return f"{base}.{node.attr}" if base else ""
    return ""


class PackageIndex:
    def __init__(self, root):
        self.root = root                      # repo root (for relpaths)
        self.modules = {}                     # dotted -> ModuleInfo
        self.functions = {}                   # qualname -> FunctionInfo
        self.by_name = {}                     # bare fn name -> [qualname]
        self.classes = {}                     # class qualname -> ClassInfo
        self.class_by_name = {}               # bare class name -> [qualname]
        self._relpath_mod = {}                # relpath -> ModuleInfo

    # ------------------------------------------------------------ loading
    def add_module(self, modname, path, is_pkg=False):
        with open(path, "r", encoding="utf-8") as fh:
            src = fh.read()
        tree = ast.parse(src, filename=path)
        relpath = os.path.relpath(path, self.root)
        mi = ModuleInfo(modname, path, relpath, tree, src.splitlines())
        mi.imports = _import_map(tree, modname, is_pkg)
        self.modules[modname] = mi
        self._relpath_mod[relpath] = mi
        self._index_defs(mi)
        return mi

    def _index_defs(self, mi):
        def visit(node, scope, cls, parent_fn):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qn = f"{scope}.{child.name}"
                    fi = FunctionInfo(
                        qualname=qn, module=mi.name, cls=cls, name=child.name,
                        node=child, relpath=mi.relpath, lineno=child.lineno,
                        parent=parent_fn,
                        decorators=tuple(_expr_text(d) or ast.dump(d)
                                         for d in child.decorator_list))
                    self.functions[qn] = fi
                    self.by_name.setdefault(child.name, []).append(qn)
                    visit(child, qn + ".<locals>", cls, qn)
                elif isinstance(child, ast.ClassDef):
                    cqn = f"{scope}.{child.name}"
                    ci = ClassInfo(qualname=cqn, module=mi.name,
                                   name=child.name, node=child,
                                   bases=tuple(dotted(b) for b in child.bases))
                    self.classes[cqn] = ci
                    self.class_by_name.setdefault(child.name, []).append(cqn)
                    visit(child, cqn, cqn, parent_fn)
                else:
                    visit(child, scope, cls, parent_fn)

        visit(mi.tree, mi.name, "", "")
        # method tables + self.x = ClassName(...) attribute types
        for cqn, ci in self.classes.items():
            if ci.module != mi.name:
                continue
            for m in ast.iter_child_nodes(ci.node):
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    ci.methods[m.name] = f"{cqn}.{m.name}"
            for sub in ast.walk(ci.node):
                if not (isinstance(sub, ast.Assign) and
                        isinstance(sub.value, ast.Call)):
                    continue
                ctor = self.resolve_class(dotted(sub.value.func), mi)
                if not ctor:
                    continue
                for tgt in sub.targets:
                    if (isinstance(tgt, ast.Attribute) and
                            isinstance(tgt.value, ast.Name) and
                            tgt.value.id == "self"):
                        ci.attr_types[tgt.attr] = ctor

    # ---------------------------------------------------------- resolution
    def resolve_class(self, text, mi):
        """Resolve dotted constructor text in module mi to a class qualname."""
        if not text:
            return None
        head, _, rest = text.partition(".")
        target = mi.imports.get(head)
        if target:
            cand = target + ("." + rest if rest else "")
        elif not rest:
            cand = f"{mi.name}.{head}"
        else:
            cand = None
        if cand and cand in self.classes:
            return cand
        # unique bare-name fallback inside the package
        bare = text.rsplit(".", 1)[-1]
        hits = self.class_by_name.get(bare, [])
        return hits[0] if len(hits) == 1 else None

    def module_of(self, fi):
        return self.modules[fi.module]

    def source_line(self, relpath, lineno):
        mi = self._relpath_mod.get(relpath)
        return mi.line(lineno) if mi else ""

    def class_of(self, fi):
        return self.classes.get(fi.cls)

    def mro_method(self, cls_qn, name):
        """Resolve a method by walking package-local base classes."""
        seen = set()
        stack = [cls_qn]
        while stack:
            cqn = stack.pop(0)
            if cqn in seen:
                continue
            seen.add(cqn)
            ci = self.classes.get(cqn)
            if ci is None:
                continue
            if name in ci.methods:
                return ci.methods[name]
            for b in ci.bases:
                base = self.resolve_class(b, self.modules[ci.module])
                if base:
                    stack.append(base)
        return None


def _import_map(tree, modname, is_pkg=False):
    """alias -> absolute dotted target for every import in the module."""
    out = {}
    # the package a level-1 relative import refers to
    parts = modname.split(".") if is_pkg else modname.split(".")[:-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    out[a.name.split(".")[0]] = a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = parts[:len(parts) - (node.level - 1)]
                prefix = ".".join(base + ([node.module] if node.module else []))
            else:
                prefix = node.module or ""
            for a in node.names:
                if a.name == "*":
                    continue
                out[a.asname or a.name] = (f"{prefix}.{a.name}"
                                           if prefix else a.name)
    return out


def load_package(repo_root, package="mxnet_tpu_torch", extra_files=(),
                 exclude_dirs=("analysis",)):
    """Parse every .py under ``repo_root/package`` (plus ``extra_files``,
    repo-relative, loaded as pseudo-modules) into a PackageIndex.
    ``exclude_dirs`` (package-relative subdir names) defaults to the
    analyzer itself: its docstrings/config quote the very markers and
    primitives it hunts, and fixture tests cover it instead."""
    idx = PackageIndex(repo_root)
    pkg_dir = os.path.join(repo_root, package)
    for dirpath, dirnames, filenames in os.walk(pkg_dir):
        rel_dir = os.path.relpath(dirpath, pkg_dir)
        top = rel_dir.split(os.sep)[0]
        if top in exclude_dirs:
            continue
        dirnames[:] = [d for d in sorted(dirnames)
                       if d not in ("__pycache__",)]
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, repo_root)
            mod = rel[:-3].replace(os.sep, ".")
            is_pkg = mod.endswith(".__init__")
            if is_pkg:
                mod = mod[: -len(".__init__")]
            idx.add_module(mod, path, is_pkg=is_pkg)
    for rel in extra_files:
        path = os.path.join(repo_root, rel)
        if not os.path.exists(path):
            continue
        mod = rel[:-3].replace(os.sep, ".") if rel.endswith(".py") else rel
        idx.add_module(mod, path)
    return idx

"""The public names of the reference's remote stores, params interop and
plugins in the port, each against the JAX package's: every public
top-level name of ``mxnet_tpu/filesystem.py``, ``interop.py`` and
``plugins/*.py`` (read from the source, so a name the reference adds
shows up here) exists in the port's module of the same path, a function
with the same parameters, a class with the same public methods and
their parameters, a constant with the same value; and no message of the
port still says that remote stores, the params writer or the plugins
wait on their ROADMAP item.
"""
import ast
import importlib
import inspect
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = ("filesystem", "interop", "plugins", "plugins.torch_plugin",
           "plugins.opencv_plugin")
# private helpers the port keeps under the reference's name (the S3
# double of chip_smoke.py signs with it)
PRIVATE = {"filesystem": ("_sigv4_headers",)}


def _source(module):
    rel = module.replace(".", "/")
    path = os.path.join(ROOT, "mxnet_tpu", rel + ".py")
    if not os.path.exists(path):
        path = os.path.join(ROOT, "mxnet_tpu", rel, "__init__.py")
    return path


def _public(module):
    with open(_source(module)) as f:
        tree = ast.parse(f.read())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return [n for n in names if not n.startswith("_")] + list(
        PRIVATE.get(module, ()))


CASES = [(m, n) for m in MODULES for n in _public(m)]


def _sig(obj):
    return str(inspect.signature(obj))


@pytest.mark.parametrize("module,name", CASES,
                         ids=[f"{m}.{n}" for m, n in CASES])
def test_public_name_exists_with_the_same_parameters(module, name):
    ref = importlib.import_module("mxnet_tpu." + module)
    port = importlib.import_module("mxnet_tpu_torch." + module)
    assert hasattr(port, name), f"mxnet_tpu_torch.{module}.{name}"
    want, got = getattr(ref, name), getattr(port, name)
    if inspect.isclass(want):
        assert inspect.isclass(got)
        assert _sig(got) == _sig(want)
        for attr, member in vars(want).items():
            if attr.startswith("_") or not callable(member):
                continue
            assert callable(getattr(got, attr, None)), f"{name}.{attr}"
            assert _sig(getattr(got, attr)) == _sig(member), \
                f"{name}.{attr}"
    elif callable(want):
        assert callable(got) and _sig(got) == _sig(want)
    else:
        assert got == want


def test_every_reference_module_has_a_port_file():
    for module in MODULES:
        rel = module.replace(".", "/")
        assert os.path.exists(os.path.join(ROOT, "mxnet_tpu_torch",
                                           rel + ".py")) or \
            os.path.exists(os.path.join(ROOT, "mxnet_tpu_torch", rel,
                                        "__init__.py")), module


def test_no_remote_store_or_plugin_refusal_is_left():
    """The messages that sent remote URIs, the params writer and the
    plugins to "ROADMAP Queue 1 item 11" are gone with their refusals."""
    hits = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "mxnet_tpu_torch")):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            with open(path) as f:
                for i, line in enumerate(f, 1):
                    if "item 11" in line or "_NotPorted" in line:
                        hits.append(f"{os.path.relpath(path, ROOT)}:{i}")
    assert not hits, hits

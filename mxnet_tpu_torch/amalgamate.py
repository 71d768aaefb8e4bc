"""One translation unit of the port's native runtime (parity:
``amalgamation/amalgamate.py``, the reference's single-file build).

Fuses ``src/mxtpu.h``, ``src/engine.cc``, ``recordio.cc`` and
``storage.cc`` — the core library ``_native`` builds — and, with
``--predict``, the port's predict ABI (``csrc/py_embed.h`` and
``csrc/c_predict.cc``: ``MXPredCreate`` ... ``MXPredFree`` over
``mxnet_tpu_torch._c_api_impl``, the math on the card) into ONE file that
compiles with one ``g++`` line and no build system::

    python -m mxnet_tpu_torch.amalgamate [--predict] -o mxtpu-all.cc

The command prints that line: with ``--predict`` it carries
:func:`libinfo.embed_flags`, since the library embeds this interpreter,
and a C program (or a Perl one, ``bindings/perl``) runs it with
:func:`libinfo.client_env`'s ``PYTHONPATH``.  The command needs the
standard library alone: ``python -m`` runs it without importing torch.
"""
from __future__ import annotations

import argparse
import os
import re

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_PKG), "src")
_CSRC = os.path.join(_PKG, "csrc")
CORE = ("engine.cc", "recordio.cc", "storage.cc")
PREDICT = "c_predict.cc"

_LOCAL_INCLUDE = re.compile(r'#include\s+"(mxtpu|py_embed)\.h"\n')


def _read(path):
    with open(path) as f:
        return _LOCAL_INCLUDE.sub("", f.read())


def sources(predict=False):
    """The fused files in their order (paths): ``py_embed.h`` first with
    ``--predict`` (``Python.h`` goes before any standard header), then
    ``mxtpu.h``, the core, and the predict ABI last."""
    files = [os.path.join(_CSRC, "py_embed.h")] if predict else []
    files.append(os.path.join(_SRC, "mxtpu.h"))
    files += [os.path.join(_SRC, f) for f in CORE]
    if predict:
        files.append(os.path.join(_CSRC, PREDICT))
    return files


def amalgamate(out, predict=False) -> int:
    """Write the fused translation unit to ``out``; returns its bytes."""
    parts = ["// mxtpu amalgamation of the PyTorch port — generated by "
             "python -m mxnet_tpu_torch.amalgamate\n"]
    for path in sources(predict):
        rel = os.path.relpath(path, os.path.dirname(_PKG))
        parts.append(f"\n// ---- {rel} ----\n" + _read(path))
    data = "\n".join(parts).encode()
    with open(out, "wb") as f:
        f.write(data)
    return len(data)


def build_command(src, lib, predict=False) -> list:
    """The one ``g++`` line that builds ``src`` into the shared library
    ``lib`` (the interpreter's embed flags with ``--predict``)."""
    cmd = ["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-pthread"]
    ldflags = []
    if predict:
        from .libinfo import embed_flags

        cflags, ldflags = embed_flags()
        cmd += cflags
    return cmd + [src, "-o", lib] + ldflags


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.amalgamate",
        description="fuse the port's native runtime (and with --predict "
                    "its predict ABI) into one translation unit")
    ap.add_argument("--predict", action="store_true",
                    help="also fuse the predict ABI (embeds CPython)")
    ap.add_argument("-o", "--out", default="mxtpu-all.cc")
    args = ap.parse_args(argv)
    size = amalgamate(args.out, predict=args.predict)
    names = " ".join(os.path.basename(p) for p in sources(args.predict))
    lib = "libmxtpu_predict.so" if args.predict else "libmxtpu.so"
    print(f"wrote {args.out} ({size} bytes: {names})")
    print("build: " + " ".join(build_command(args.out, lib, args.predict)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Reader of the reference's NDArray-list binary (mirrors the reading
half of ``mxnet_tpu/interop.py``, copied rather than imported).

The format behind ``prefix-0001.params`` (src/ndarray/ndarray.cc:593-694
of the reference): uint64 magic ``0x112`` + reserved, then a dmlc
vector of arrays — each a TShape (uint32 ndim + uint32 dims), a Context
(int32 dev_type + int32 dev_id), an int32 mshadow type flag and the raw
row-major bytes — then a dmlc vector of name strings (``arg:``/``aux:``
prefixed by ``model.save_checkpoint``).  :func:`mxnet_tpu_torch.ndarray.
load` routes such files here.

:func:`load_symbol_json` reads the reference's nnvm symbol JSON (every
vintage the JAX package reads: op params under ``param``, ``attr`` or
``attrs``, 2- or 3-element input references, the pre-0.9 op names and
their missing aux inputs); :func:`mxnet_tpu_torch.symbol.load_json`
routes such files here.  Writing the binary format is not ported.
"""
from __future__ import annotations

import json
import struct
from typing import Dict

import numpy as np

from .base import MXNetError

_MAGIC = 0x112
# mshadow type flags (mshadow/base.h TypeFlag)
_DTYPES = {0: np.float32, 1: np.float64, 2: np.float16, 3: np.uint8,
           4: np.int32}


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def take(self, n):
        if self.o + n > len(self.d):
            raise MXNetError("truncated .params file")
        out = self.d[self.o:self.o + n]
        self.o += n
        return out

    def u64(self):
        return struct.unpack("<Q", self.take(8))[0]

    def u32(self):
        return struct.unpack("<I", self.take(4))[0]

    def i32(self):
        return struct.unpack("<i", self.take(4))[0]


def _read_ndarray(r: _Reader):
    ndim = r.u32()                       # TShape::Save
    if ndim == 0:
        return None                      # is_none() array
    shape = struct.unpack("<%dI" % ndim, r.take(4 * ndim))
    r.i32()                              # Context dev_type (ignored)
    r.i32()                              # Context dev_id
    flag = r.i32()
    dt = _DTYPES.get(flag)
    if dt is None:
        raise MXNetError(f"unknown mshadow type flag {flag}")
    count = int(np.prod(shape))
    raw = r.take(count * np.dtype(dt).itemsize)
    return np.frombuffer(raw, dtype=dt).reshape(shape)


def _read_names(r: _Reader):
    n = r.u64()
    return [r.take(r.u64()).decode() for _ in range(n)]


def load_params_raw(blob: bytes, ctx=None) -> Dict:
    """The contents of a reference NDArray-list file -> ``{name:
    NDArray}`` on ``ctx`` (names exactly as stored, ``arg:``/``aux:``
    prefixes included; unnamed arrays are keyed ``"0"``, ``"1"``, ...)."""
    from .ndarray import NDArray

    r = _Reader(blob)
    if r.u64() != _MAGIC:
        raise MXNetError("not a reference NDArray file (bad magic)")
    r.u64()  # reserved
    n = r.u64()
    arrays = [_read_ndarray(r) for _ in range(n)]
    names = _read_names(r)
    if names and len(names) != len(arrays):
        raise MXNetError(f"{len(arrays)} arrays but {len(names)} names")
    if not names:
        names = [str(i) for i in range(len(arrays))]
    return {name: NDArray(a, ctx=ctx) for name, a in zip(names, arrays)
            if a is not None}


_OP_RENAMES = {
    # pre-0.9 names upgraded by legacy_json_util.cc
    "BatchNorm_v1": "BatchNorm",
    "Convolution_v1": "Convolution",
    "Pooling_v1": "Pooling",
}


def _node_attrs(jn):
    """Op parameters: pre-0.9 files keep them under ``param`` (with user
    annotations apart under ``attr``); newer files merge everything into
    ``attrs``."""
    if "param" in jn:
        return dict(jn["param"])
    return dict(jn.get("attrs") or jn.get("attr") or {})


def _extra_attrs(jn):
    """User annotations, separable only in the legacy layout."""
    if "param" in jn:
        return dict(jn.get("attr") or {})
    return {}


def load_symbol_json(text: str):
    """A Symbol from reference/nnvm JSON (the JAX package's
    ``interop.load_symbol_json``): aux inputs are recognised from the op
    registry, and pre-0.9 files get the default-named aux variables
    their BatchNorm nodes lack."""
    from . import ops
    from .symbol import Symbol, _Node

    data = json.loads(text)
    if "nodes" not in data:
        raise MXNetError("not a symbol JSON file (no 'nodes')")
    jnodes = data["nodes"]
    aux_entries = set()
    for jn in jnodes:
        opname = _OP_RENAMES.get(jn["op"], jn["op"])
        if opname == "null":
            continue
        od = ops.get(opname)  # an op the port lacks fails here, by name
        if not od.aux_names:
            continue
        attrs = _node_attrs(jn)
        arg_names = list(od.resolve_arg_names(attrs)) + list(od.aux_names)
        for pos, ref in enumerate(jn["inputs"]):
            if pos < len(arg_names) and arg_names[pos] in od.aux_names:
                aux_entries.add(ref[0])
    nodes = []
    for i, jn in enumerate(jnodes):
        opname = _OP_RENAMES.get(jn["op"], jn["op"])
        if opname == "null":
            node = _Node(None, jn["name"], is_aux=i in aux_entries,
                         extra_attrs=_extra_attrs(jn))
        else:
            attrs = _node_attrs(jn)
            node = _Node(opname, jn["name"], attrs=attrs,
                         extra_attrs=_extra_attrs(jn))
            node.inputs = [(nodes[ref[0]], ref[1] if len(ref) > 1 else 0)
                           for ref in jn["inputs"]]
            od = ops.get(opname)
            expected = (list(od.resolve_arg_names(attrs))
                        + list(od.aux_names))
            while len(node.inputs) < len(expected):
                arg_name = expected[len(node.inputs)]
                var = _Node(None, f"{jn['name']}_{arg_name}",
                            is_aux=arg_name in od.aux_names)
                node.inputs.append((var, 0))
        nodes.append(node)
    heads = data.get("heads") or [[len(nodes) - 1, 0, 0]]
    return Symbol([(nodes[h[0]], h[1] if len(h) > 1 else 0) for h in heads])

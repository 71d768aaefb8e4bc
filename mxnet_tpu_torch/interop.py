"""Reference-checkpoint interoperability (mirrors
``mxnet_tpu/interop.py``, copied rather than imported): the
reference's on-disk formats, read and written.

- :func:`load_params` / :func:`save_params` — the NDArray-list binary
  behind ``prefix-0001.params`` (src/ndarray/ndarray.cc:593-694 of the
  reference): uint64 magic ``0x112`` + reserved, then a dmlc vector of
  arrays — each a TShape (uint32 ndim + uint32 dims), a Context (int32
  dev_type + int32 dev_id), an int32 mshadow type flag and the raw
  row-major bytes — then a dmlc vector of name strings (``arg:``/
  ``aux:`` prefixed by ``model.save_checkpoint``).  The writer is the
  JAX package's byte for byte: a cpu context, scalars stored as
  ``(1,)`` (ndim 0 means "none" in the format), and every dtype the
  format lacks (bfloat16, int64, bool, ...) cast to float32.
  :func:`mxnet_tpu_torch.ndarray.load` routes such files here.
- :func:`load_symbol_json` reads the reference's nnvm symbol JSON
  (every vintage the JAX package reads: op params under ``param``,
  ``attr`` or ``attrs``, 2- or 3-element input references, the pre-0.9
  op names and their missing aux inputs);
  :func:`mxnet_tpu_torch.symbol.load_json` routes such files here.
- :func:`load_checkpoint` — the pair, as ``model.load_checkpoint``.

Local files only, like the JAX package's: ``nd.load`` of a remote URI
reads the object and sniffs the magic itself.  The arrays land on the
current context (the card, or the innermost ``with mx.Context(...)``).
"""
from __future__ import annotations

import json
import struct
from typing import Dict, Tuple

import numpy as np
import torch

from .base import MXNetError

_MAGIC = 0x112
# mshadow type flags (mshadow/base.h TypeFlag)
_DTYPES = {0: np.float32, 1: np.float64, 2: np.float16, 3: np.uint8,
           4: np.int32}
_FLAGS = {np.dtype(v): k for k, v in _DTYPES.items()}


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


def _load_blob(blob: bytes, ctx=None, what="") -> Dict:
    """The contents of a reference NDArray-list file -> ``{name:
    NDArray}`` on ``ctx`` (names exactly as stored, ``arg:``/``aux:``
    prefixes included; unnamed arrays are keyed ``"0"``, ``"1"``, ...)."""
    from .ndarray import NDArray

    pre = f"{what}: " if what else ""
    r = _Reader(blob)
    if r.u64() != _MAGIC:
        raise MXNetError(f"{pre}not a reference NDArray file (bad magic)")
    r.u64()  # reserved
    n = r.u64()
    arrays = [_read_ndarray(r) for _ in range(n)]
    names = _read_names(r)
    if names and len(names) != len(arrays):
        raise MXNetError(f"{pre}{len(arrays)} arrays but {len(names)} "
                         "names")
    if not names:
        names = [str(i) for i in range(len(arrays))]
    return {name: NDArray(a, ctx=ctx) for name, a in zip(names, arrays)
            if a is not None}


def load_params_raw(fname: str) -> Dict:
    """Read a reference NDArray-list file -> ``{original_name: NDArray}``
    (names exactly as stored, including any ``arg:``/``aux:``
    prefixes)."""
    with open(fname, "rb") as f:
        return _load_blob(f.read(), what=fname)


def load_params(fname: str) -> Tuple[Dict, Dict]:
    """Read a reference ``.params`` file -> ``(arg_params, aux_params)``,
    splitting the ``arg:``/``aux:`` name prefixes the reference's
    ``save_checkpoint`` writes (unprefixed names land in arg_params)."""
    arg, aux = {}, {}
    for name, v in load_params_raw(fname).items():
        if name.startswith("aux:"):
            aux[name[4:]] = v
        elif name.startswith("arg:"):
            arg[name[4:]] = v
        else:
            arg[name] = v
    return arg, aux


def _host(v) -> np.ndarray:
    """``v`` (a port NDArray or tensor, a JAX package NDArray, anything
    numpy takes) as a contiguous host array in a dtype the format has:
    others, bfloat16 among them, become float32."""
    t = getattr(v, "tensor", v)
    if isinstance(t, torch.Tensor):
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        a = t.cpu().numpy()
    else:
        a = np.asarray(v.asnumpy() if hasattr(v, "asnumpy") else v)
    if a.dtype not in _FLAGS:
        a = a.astype(np.float32)
    return np.ascontiguousarray(a)


def save_params(fname: str, arg_params: Dict, aux_params: Dict = None):
    """Write arg/aux dicts in the reference's binary format (the inverse
    of :func:`load_params`; lets checkpoints flow back to the
    reference)."""
    chunks = [struct.pack("<QQ", _MAGIC, 0)]
    items = [("arg:" + k, v) for k, v in (arg_params or {}).items()]
    items += [("aux:" + k, v) for k, v in (aux_params or {}).items()]
    chunks.append(struct.pack("<Q", len(items)))
    for _, v in items:
        a = _host(v)
        if a.ndim == 0:
            # ndim 0 is a "none" array in the format (the reader stops
            # after the shape): a scalar is stored as (1,)
            a = a.reshape(1)
        chunks.append(struct.pack("<I", a.ndim))
        chunks.append(struct.pack("<%dI" % a.ndim, *a.shape))
        chunks.append(struct.pack("<ii", 1, 0))     # cpu context
        chunks.append(struct.pack("<i", _FLAGS[a.dtype]))
        chunks.append(a.tobytes())
    chunks.append(struct.pack("<Q", len(items)))
    for name, _ in items:
        b = name.encode()
        chunks.append(struct.pack("<Q", len(b)))
        chunks.append(b)
    with open(fname, "wb") as f:
        f.write(b"".join(chunks))


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


def load_symbol(fname: str):
    """The Symbol in the reference/nnvm JSON file ``fname``."""
    with open(fname) as f:
        return load_symbol_json(f.read())


def load_checkpoint(prefix: str, epoch: int):
    """Parity: ``model.load_checkpoint`` over reference-format files:
    ``prefix-symbol.json`` + ``prefix-%04d.params``."""
    sym = load_symbol(f"{prefix}-symbol.json")
    arg, aux = load_params("%s-%04d.params" % (prefix, epoch))
    return sym, arg, aux

"""The reference's binary ``.params`` writer and its reader names in the
port against the JAX package's, on the CPU.

``interop.save_params`` writes byte for byte what the JAX package's
writes for the same dicts — fp32, fp64, fp16, uint8 and int32 arrays,
scalars (stored as ``(1,)``), a dtype the format lacks (int64, bool:
cast to fp32) and bfloat16 (a port tensor, the JAX side's ml_dtypes
array: both cast to fp32) — given numpy arrays, port NDArrays and
tensors, or the JAX package's NDArrays.  Files cross both ways;
``load_params_raw(fname)``, ``load_params``, ``load_symbol`` and
``load_checkpoint`` read as the reference's names do; and a small ResNet
checkpoint written by the port's ``Module`` (its npz layout and the
binary one) loads into the JAX ``Module`` with equal outputs.

Comparisons are exact (bytes, arrays, names), except the two packages'
ResNet forwards: 1e-5 relative (norm) on the probabilities, fp32 convs
on both sides (``MXTPU_CONV_PRECISION=float32``), measured near 1e-7.
"""
import inspect

import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import interop as jinterop
from mxnet_tpu import model as jmodel
from mxnet_tpu import models as jmodels
from mxnet_tpu import ndarray as jnd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import interop as tinterop
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch import symbol as tsym

CPU = "cpu"


def _case(name):
    rs = np.random.RandomState(len(name))
    bf = rs.normal(size=(3, 5)).astype(np.float32)
    return {
        "fp32": ({"w": rs.normal(size=(4, 3)).astype(np.float32)},
                 {"m": rs.normal(size=(3,)).astype(np.float32)}),
        "fp64": ({"w": rs.normal(size=(2, 2, 3))}, {}),
        "fp16": ({"w": rs.normal(size=(7,)).astype(np.float16)}, None),
        "uint8": ({"img": rs.randint(0, 256, (2, 3, 4)).astype(np.uint8)},
                  {}),
        "int32": ({"ids": rs.randint(-9, 9, (5, 1)).astype(np.int32)}, {}),
        "scalars": ({"s": np.float32(2.5), "t": np.array(7, np.int32)},
                    {"u": np.float64(-1.0)}),
        "unsupported": ({"i64": np.arange(6).reshape(2, 3),
                         "mask": np.array([True, False, True])}, {}),
        "bf16": ({"w": bf}, {}),
        "empty": ({}, {}),
    }[name]


CASES = ["fp32", "fp64", "fp16", "uint8", "int32", "scalars",
         "unsupported", "bf16", "empty"]


def _port_values(name, d, how):
    """``d`` as the port side gets it: numpy, port NDArrays or tensors."""
    if d is None:
        return None
    out = {}
    for k, v in d.items():
        a = np.asarray(v)
        if name == "bf16":
            t = torch.from_numpy(a).to(torch.bfloat16)
            out[k] = tnd.NDArray(t, ctx=CPU) if how == "ndarray" else t
        elif how == "numpy":
            out[k] = v
        elif how == "tensor":
            out[k] = torch.from_numpy(np.array(a))
        else:
            out[k] = tnd.array(a, ctx=CPU, dtype=a.dtype)
    return out


def _jax_values(name, d, port):
    """The JAX side's numpy values: ml_dtypes' bfloat16 for the bf16
    case, else what the port side's values hold (a port NDArray keeps
    the dtype it was made in)."""
    if d is None:
        return d
    if name == "bf16":
        return {k: np.asarray(v).astype(ml_dtypes.bfloat16)
                for k, v in d.items()}
    return {k: v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)
            for k, v in port.items()}


# numpy has no bfloat16: the port's bfloat16 comes as a tensor or NDArray
@pytest.mark.parametrize("name,how", [
    (name, how) for name in CASES for how in ("numpy", "ndarray", "tensor")
    if not (name == "bf16" and how == "numpy")])
def test_save_params_bytes_equal_the_reference(tmp_path, name, how):
    arg, aux = _case(name)
    jpath, tpath = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    targ, taux = _port_values(name, arg, how), _port_values(name, aux, how)
    jinterop.save_params(jpath, _jax_values(name, arg, targ),
                         _jax_values(name, aux, taux))
    tinterop.save_params(tpath, targ, taux)
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()


def test_save_params_takes_the_jax_packages_ndarrays(tmp_path):
    arg, aux = _case("fp32")
    jpath, tpath = str(tmp_path / "j.params"), str(tmp_path / "t.params")
    jinterop.save_params(jpath, arg, aux)
    tinterop.save_params(tpath, {k: jnd.array(v) for k, v in arg.items()},
                         {k: jnd.array(v) for k, v in aux.items()})
    with open(jpath, "rb") as a, open(tpath, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("name", ["fp32", "fp64", "fp16", "uint8", "int32",
                                  "scalars", "unsupported"])
def test_round_trips_both_ways(tmp_path, name):
    arg, aux = _case(name)
    aux = aux or {}
    path = str(tmp_path / "t.params")
    tinterop.save_params(path, arg, aux)
    jarg, jaux = jinterop.load_params(path)
    with tmx.Context(CPU):
        targ, taux = tinterop.load_params(path)
    for want, got_j, got_t in ((arg, jarg, targ), (aux, jaux, taux)):
        assert sorted(got_j) == sorted(got_t) == sorted(want)
        for k, v in want.items():
            a = np.asarray(v)
            a = a.reshape(1) if a.ndim == 0 else a
            a = a if a.dtype in tinterop._FLAGS else a.astype(np.float32)
            # NDArrays of either package hold float64 as float32
            a = a.astype(np.float32) if a.dtype == np.float64 else a
            np.testing.assert_array_equal(got_j[k].asnumpy(), a)
            np.testing.assert_array_equal(got_t[k].asnumpy(), a)
            assert got_t[k].asnumpy().dtype == got_j[k].asnumpy().dtype \
                == a.dtype
            assert got_t[k].context.type == "cpu"
    path = str(tmp_path / "j.params")
    jinterop.save_params(path, arg, aux)
    with tmx.Context(CPU):
        back = tnd.load(path)
    assert sorted(back) == sorted(["arg:" + k for k in arg]
                                  + ["aux:" + k for k in aux])


def test_the_four_reader_names(tmp_path):
    """``load_params_raw(fname)`` keeps the stored names (unnamed arrays
    keyed by position), ``load_params`` splits the prefixes (unprefixed
    names are args), ``load_symbol`` and ``load_checkpoint`` read the
    reference's pair; every name has the reference's signature."""
    for name in ("load_params_raw", "load_params", "save_params",
                 "load_symbol", "load_symbol_json", "load_checkpoint"):
        assert str(inspect.signature(getattr(tinterop, name))) == \
            str(inspect.signature(getattr(jinterop, name))), name
    arg, aux = _case("fp32")
    path = str(tmp_path / "m-0002.params")
    jinterop.save_params(path, arg, aux)
    with tmx.Context(CPU):
        raw = tinterop.load_params_raw(path)
    assert sorted(raw) == sorted(jinterop.load_params_raw(path)) == \
        ["arg:w", "aux:m"]
    # a file with unprefixed and with no names at all
    import struct

    def blob(names):
        a = np.arange(3, dtype=np.float32)
        out = struct.pack("<QQQ", 0x112, 0, 1) + struct.pack("<I", 1) + \
            struct.pack("<I", 3) + struct.pack("<iii", 1, 0, 0) + \
            a.tobytes() + struct.pack("<Q", len(names))
        for n in names:
            out += struct.pack("<Q", len(n)) + n.encode()
        return out

    for names, want in ((["plain"], {"plain"}), ([], {"0"})):
        p = str(tmp_path / "x.params")
        with open(p, "wb") as f:
            f.write(blob(names))
        with tmx.Context(CPU):
            got = tinterop.load_params(p)
        assert set(got[0]) == want and got[1] == {}
        assert set(jinterop.load_params(p)[0]) == want
    bad = str(tmp_path / "bad.params")
    with open(bad, "wb") as f:
        f.write(b"\0" * 16)
    with pytest.raises(MXNetError, match="bad magic"):
        tinterop.load_params_raw(bad)
    net = jmodels.get_symbol("resnet-8", num_classes=10,
                             image_shape=(3, 16, 16))
    net.save(str(tmp_path / "m-symbol.json"))
    tnet = tinterop.load_symbol(str(tmp_path / "m-symbol.json"))
    assert tnet.tojson() == tsym.load_json(net.tojson()).tojson()
    with tmx.Context(CPU):
        sym, targ, taux = tinterop.load_checkpoint(str(tmp_path / "m"), 2)
    _, jarg, jaux = jinterop.load_checkpoint(str(tmp_path / "m"), 2)
    assert sym.list_arguments() == net.list_arguments()
    assert sorted(targ) == sorted(jarg) and sorted(taux) == sorted(jaux)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("fmt", ["npz", "binary"])
def test_port_module_checkpoint_loads_in_the_jax_module(tmp_path,
                                                        monkeypatch, fmt):
    """resnet-8 at 3 x 16 x 16: the port's Module takes one SGD step and
    writes its checkpoint (``Module.save_checkpoint``, or its params by
    ``interop.save_params`` beside the symbol); the JAX Module built from
    that checkpoint gives the port Module's outputs."""
    monkeypatch.setenv("MXTPU_CONV_PRECISION", "float32")
    shape, b = (3, 16, 16), 8
    jnet = jmodels.get_symbol("resnet-8", num_classes=10, image_shape=shape)
    tnet = tsym.load_json(jnet.tojson())
    rs = np.random.RandomState(0)
    x = rs.normal(size=(b,) + shape).astype(np.float32)
    y = rs.randint(0, 10, b).astype(np.float32)
    tmx.random.seed(0)
    tmod = tmx.mod.Module(tnet, context=tmx.cpu())
    tmod.bind(data_shapes=[("data", (b,) + shape)],
              label_shapes=[("softmax_label", (b,))])
    tmod.init_params(initializer=tmx.init.Xavier(rnd_type="gaussian",
                                                 factor_type="in",
                                                 magnitude=2))
    tmod.init_optimizer(optimizer="sgd",
                        optimizer_params={"learning_rate": 0.1})
    batch = tmx.io.DataBatch(data=[tnd.array(x, ctx=CPU)],
                             label=[tnd.array(y, ctx=CPU)])
    tmod.forward(batch, is_train=True)
    tmod.backward()
    tmod.update()
    prefix = str(tmp_path / "r8")
    if fmt == "npz":
        tmod.save_checkpoint(prefix, 1)
    else:
        tnet.save(f"{prefix}-symbol.json")
        arg, aux = tmod.get_params()
        tinterop.save_params(f"{prefix}-0001.params", arg, aux)
        with open(f"{prefix}-0001.params", "rb") as f:
            assert f.read(8) == (0x112).to_bytes(8, "little")
    tmod.forward(tmx.io.DataBatch(data=[tnd.array(x, ctx=CPU)]),
                 is_train=False)
    want = tmod.get_outputs()[0].asnumpy()
    sym, arg, aux = jmodel.load_checkpoint(prefix, 1)
    jmod = jmx.mod.Module(sym, context=jmx.cpu())
    jmod.bind(data_shapes=[("data", (b,) + shape)], for_training=False)
    jmod.set_params(arg, aux)
    jmod.forward(jmx.io.DataBatch(data=[jnd.array(x)]), is_train=False)
    got = jmod.get_outputs()[0].asnumpy()
    assert _rel(want, got) <= 1e-5
    for k, v in tmod.get_params()[0].items():
        np.testing.assert_array_equal(arg[k].asnumpy(), v.asnumpy())

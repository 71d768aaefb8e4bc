"""The port's amalgamation (``python -m mxnet_tpu_torch.amalgamate``): the
native core fused into one translation unit, built with one ``g++`` line
and driven through recordio and the engine (as ``tests/
test_amalgamation.py`` drives the JAX package's), and with ``--predict``
the port's predict ABI fused in, loaded here by ``ctypes`` and run on the
CPU (``dev_type`` 1) over ``tests/test_perl_binding.py``'s 4 x 8
FullyConnected net: its outputs equal the port's ``Predictor`` exactly
and the JAX package's within 1e-5 on the same params, carried across as
numpy arrays.
"""
import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from torch_tiny_predict import JAX_TOL, SHAPE, oracles, tiny_net

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="g++ unavailable")


def _build(tmp_path, predict):
    """The CLI in a child whose path makes torch, jax and mxnet_tpu raise
    on import (it needs the standard library alone), then its one g++
    line."""
    from mxnet_tpu_torch import amalgamate

    src = str(tmp_path / ("all-predict.cc" if predict else "all.cc"))
    lib = str(tmp_path / ("libamal-predict.so" if predict
                          else "libamal.so"))
    poison = tmp_path / "poison"
    for pkg in ("torch", "jax", "mxnet_tpu"):
        (poison / pkg).mkdir(parents=True)
        (poison / pkg / "__init__.py").write_text(
            f"raise ImportError('the amalgamation imported {pkg}')\n")
    args = [sys.executable, "-m", "mxnet_tpu_torch.amalgamate", "-o", src]
    r = subprocess.run(args + (["--predict"] if predict else []),
                       capture_output=True, text=True, cwd=REPO,
                       timeout=120, env=dict(os.environ,
                                             PYTHONPATH=str(poison)))
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith(f"wrote {src}"), r.stdout
    cmd = amalgamate.build_command(src, lib, predict=predict)
    assert r.stdout.splitlines()[-1].split()[0] == "build:"
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return src, lib


def _recordio_and_engine(lib, tmp_path):
    m = ctypes.CDLL(lib)
    m.mxr_writer_open.restype = ctypes.c_void_p
    m.mxr_writer_open.argtypes = [ctypes.c_char_p]
    m.mxr_write.argtypes = [ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64]
    m.mxr_writer_close.argtypes = [ctypes.c_void_p]
    m.mxr_open.restype = ctypes.c_void_p
    m.mxr_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    m.mxr_next.restype = ctypes.POINTER(ctypes.c_uint8)
    m.mxr_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64)]
    m.mxr_close.argtypes = [ctypes.c_void_p]

    rec = str(tmp_path / "t.rec").encode()
    w = m.mxr_writer_open(rec)
    payloads = [bytes([i]) * (5 + i) for i in range(8)]
    for p in payloads:
        buf = (ctypes.c_uint8 * len(p)).from_buffer_copy(p)
        m.mxr_write(w, buf, len(p))
    m.mxr_writer_close(w)
    rd = m.mxr_open(rec, 0, 1)
    n = ctypes.c_uint64()
    got = []
    while True:
        ptr = m.mxr_next(rd, ctypes.byref(n))
        if not ptr:
            break
        got.append(bytes(ctypes.cast(
            ptr, ctypes.POINTER(ctypes.c_uint8 * n.value)).contents))
    m.mxr_close(rd)
    assert got == payloads

    # the port's native records read the amalgamated library's file
    from mxnet_tpu_torch import recordio as trec

    reader = trec.MXRecordIO(rec.decode(), "r")
    assert [reader.read() for _ in payloads] == payloads
    reader.close()

    m.mxe_create.restype = ctypes.c_void_p
    m.mxe_create.argtypes = [ctypes.c_int]
    m.mxe_destroy.argtypes = [ctypes.c_void_p]
    eng = m.mxe_create(2)
    assert eng
    m.mxe_destroy(eng)
    return m


def test_core_amalgamation_builds_and_drives_recordio_and_the_engine(
        tmp_path):
    src, lib = _build(tmp_path, predict=False)
    text = open(src).read()
    assert "---- src/engine.cc ----" in text
    assert "c_predict.cc" not in text and "Python.h" not in text
    _recordio_and_engine(lib, tmp_path)


def test_predict_amalgamation_matches_both_predictors(tmp_path):
    src, lib = _build(tmp_path, predict=True)
    text = open(src).read()
    assert text.index("mxnet_tpu_torch/csrc/py_embed.h") < \
        text.index("src/mxtpu.h") < \
        text.index("mxnet_tpu_torch/csrc/c_predict.cc")
    m = _recordio_and_engine(lib, tmp_path)   # the core is fused in too
    json_str, params, arg = tiny_net(tmp_path)
    x = (np.arange(32, dtype=np.float32) / 32.0).reshape(SHAPE)
    m.MXPredGetLastError.restype = ctypes.c_char_p
    m.MXPredCreate.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint32, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_void_p)]
    m.MXPredSetInput.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_void_p, ctypes.c_uint32]
    m.MXPredForward.argtypes = [ctypes.c_void_p]
    m.MXPredGetOutput.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                  ctypes.c_void_p, ctypes.c_uint32]
    m.MXPredFree.argtypes = [ctypes.c_void_p]
    with open(params, "rb") as f:
        blob = f.read()
    h = ctypes.c_void_p()
    rc = m.MXPredCreate(json_str.encode(), blob, len(blob), 1, 0, 1,
                        (ctypes.c_char_p * 1)(b"data"),
                        (ctypes.c_uint32 * 2)(0, 2),
                        (ctypes.c_uint32 * 2)(*SHAPE), ctypes.byref(h))
    assert rc == 0, m.MXPredGetLastError()
    got = np.empty((SHAPE[0], 3), np.float32)
    assert m.MXPredSetInput(h, b"data", x.ctypes.data_as(ctypes.c_void_p),
                            x.size) == 0
    assert m.MXPredForward(h) == 0
    assert m.MXPredGetOutput(h, 0, got.ctypes.data_as(ctypes.c_void_p),
                             got.size) == 0
    m.MXPredFree(h)
    port, jax = oracles(json_str, params, arg, x)
    np.testing.assert_array_equal(got, port)
    np.testing.assert_allclose(got, jax, rtol=0, atol=JAX_TOL)
    assert np.allclose(got.sum(1), 1.0, atol=1e-6)

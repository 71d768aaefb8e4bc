"""The port's ``rtc.Rtc`` on the CPU, where it cannot run: MXRtc's
decoration of a kernel body (golden text for MXNet's own docstring
example), the checks a construction and a ``push`` make before any
CUDA call, and the named refusals — no card, CPU templates, no NVRTC.
The kernels themselves run in ``tests/test_torch_kernels_cuda.py`` on
the card.

The JAX package's ``Rtc`` runs Pallas source in interpret mode here; the
last test holds its axpy against the plain twin that the card tests and
``chip_smoke.py`` hold the CUDA axpy to (exact: one multiply by 2, which
is exact, and one add, in float32).
"""
import ctypes.util

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import ndarray as jnd

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch import ndarray as tnd
from mxnet_tpu_torch import rtc
from mxnet_tpu_torch.ops import _nvrtc

DOC_BODY = """
    __shared__ float s_rec[10];
    s_rec[threadIdx.x] = x[threadIdx.x];
    y[threadIdx.x] = expf(s_rec[threadIdx.x]*5.0);"""

# what src/common/mxrtc.cc's MXRtc::decorate prints for the example
DOC_GOLDEN = ('\nextern "C" __global__ void abc(const float* x,float* y) {\n'
              "const int x_ndim = 1;\n"
              "const int x_dims[] = {10};\n"
              "const int y_ndim = 1;\n"
              "const int y_dims[] = {10};\n"
              + DOC_BODY + "\n}\n")


def _cpu(shape, dtype=np.float32):
    return tnd.zeros(shape, ctx="cpu", dtype=dtype)


def test_decorate_matches_mxrtc_golden_text():
    x, y = _cpu((10,)), _cpu((10,))
    assert rtc.decorate("abc", [("x", x)], [("y", y)], DOC_BODY) == \
        DOC_GOLDEN


def test_decorate_types_dims_and_headers():
    src = rtc.decorate(
        "k", [("a", _cpu((2, 3, 4), "float16")),
              ("b", _cpu((5,), "bfloat16")), ("c", _cpu((1,), np.int32)),
              ("d", _cpu((7,), np.int8)), ("e", _cpu((2,), np.float64))],
        [("o", _cpu((6, 1), np.uint8))], "o[0] = 1;")
    assert src.startswith("#include <cuda_fp16.h>\n#include <cuda_bf16.h>\n")
    assert ('void k(const __half* a,const __nv_bfloat16* b,const int* c,'
            'const signed char* d,const double* e,unsigned char* o) {') in src
    assert "const int a_ndim = 3;\nconst int a_dims[] = {2,3,4};\n" in src
    assert "const int o_ndim = 2;\nconst int o_dims[] = {6,1};\n" in src
    assert src.endswith("o[0] = 1;\n}\n")
    # tensors serve as templates too
    assert "const float* t" in rtc.decorate(
        "k", [("t", torch.zeros(3))], [("o", torch.zeros(3))], "")


@pytest.mark.parametrize("name,ins,outs,match", [
    ("1abc", [("x", (2,))], [("y", (2,))], "not a C identifier"),
    ("a-b", [("x", (2,))], [("y", (2,))], "not a C identifier"),
    ("k", [("x y", (2,))], [("y", (2,))], "argname 'x y'"),
    ("k", [("x", (2,))], [("x", (2,))], "repeats"),
    ("k", [("x", ())], [("y", (2,))], "0-d"),
])
def test_decorate_refuses_bad_names_and_shapes(name, ins, outs, match):
    with pytest.raises(MXNetError, match=match):
        rtc.decorate(name, [(n, _cpu(s)) for n, s in ins],
                     [(n, _cpu(s)) for n, s in outs], "")


def test_decorate_refuses_dtypes_without_a_c_type():
    with pytest.raises(MXNetError, match="no C type"):
        rtc.decorate("k", [("x", torch.zeros(2, dtype=torch.bool))],
                     [("y", _cpu((2,)))], "")


def test_construction_on_the_host_raises():
    with pytest.raises(MXNetError,
                       match="Rtc compiles CUDA C and runs on a CUDA device"):
        rtc.Rtc("abc", [("x", _cpu((10,)))], [("y", _cpu((10,)))], DOC_BODY)


def test_construction_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="runs on a CUDA device.*no card"):
        rtc.Rtc("abc", [("x", _cpu((10,)))], [("y", _cpu((10,)))], DOC_BODY)
    with pytest.raises(MXNetError, match="not a C identifier"):
        rtc.Rtc("a b", [("x", _cpu((10,)))], [("y", _cpu((10,)))], "")


def test_push_argument_checks():
    cpu = torch.device("cpu")
    tmpl = [("x", torch.zeros(4, 3)), ("y", torch.zeros(4))]
    ok = rtc._check_args("k", "input", tmpl,
                         [_cpu((4, 3)), np.ones(4)], cpu, upload=True)
    assert [tuple(t.shape) for t in ok] == [(4, 3), (4,)]
    assert ok[1].dtype == torch.float32     # float64 numpy, as JAX holds it
    for values, match in (
            ([_cpu((4, 3))], "expects 2 inputs, got 1"),
            ([_cpu((3, 4)), _cpu((4,))], r"is \(3, 4\)"),
            ([_cpu((4, 3), np.int32), _cpu((4,))], "torch.int32"),
            ([torch.zeros(3, 4).t(), _cpu((4,))], "not contiguous")):
        with pytest.raises(MXNetError, match=match):
            rtc._check_args("k", "input", tmpl, values, cpu, upload=True)
    with pytest.raises(MXNetError, match="runs on a CUDA device"):
        rtc._check_args("k", "input", tmpl, [_cpu((4, 3)), _cpu((4,))],
                        torch.device("cuda", 0), upload=True)
    with pytest.raises(MXNetError, match="must be an NDArray"):
        rtc._check_args("k", "output", tmpl[:1], [np.zeros((4, 3))], cpu,
                        upload=False)


@pytest.mark.parametrize("dims,match", [
    (None, "a CUDA launch has no default"), ((1, 1), "3 positive ints"),
    ((1, 0, 1), "3 positive ints"), ((1.0, 1, 1), "3 positive ints")])
def test_launch_dims_are_required(dims, match):
    with pytest.raises(MXNetError, match=match):
        rtc._dims("grid_dims", dims)
    assert rtc._dims("block_dims", (np.int64(4), 2, 1)) == (4, 2, 1)


def test_missing_nvrtc_raises_by_name(monkeypatch, tmp_path):
    monkeypatch.setattr(_nvrtc, "_libs", {})
    monkeypatch.setattr(_nvrtc, "_nvrtc_dirs", lambda: [str(tmp_path)])
    monkeypatch.setattr(ctypes.util, "find_library", lambda name: None)
    with pytest.raises(MXNetError, match="libnvrtc.*not found; searched: "
                       + str(tmp_path)):
        _nvrtc.compile_cubin(DOC_GOLDEN, "abc", "sm_90")
    assert _nvrtc.compile_count() == 0


def test_rtc_module_imports_no_cuda_library():
    assert "nvrtc" not in _nvrtc._libs and "cuda" not in _nvrtc._libs
    assert rtc.launch_count() == 0


def test_jax_rtc_axpy_matches_the_plain_twin():
    src = """
def axpy(x_ref, y_ref, o_ref):
    o_ref[...] = 2.0 * x_ref[...] + y_ref[...]
"""
    rng = np.random.default_rng(0)
    x, y = (rng.normal(size=257).astype(np.float32) for _ in range(2))
    jx, jy, jo = jnd.array(x), jnd.array(y), jnd.empty((257,))
    mx.rtc.Rtc("axpy", [("x", jx), ("y", jy)], [("o", jo)], src).push(
        [jx, jy], [jo])
    plain = 2 * torch.from_numpy(x) + torch.from_numpy(y)
    np.testing.assert_array_equal(jo.asnumpy(), plain.numpy())

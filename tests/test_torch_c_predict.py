"""The port's predict ABI (``csrc/c_predict.cc``) from a C program, on
the CPU: a client compiled against ``src/mxtpu.h`` and the library of
``libinfo.find_lib_path("predict")`` runs a resnet-8 at 3 x 16 x 16
(``dev_type`` 1) from the symbol's JSON and the bytes of a ``.params``
file the JAX package wrote with ``nd.save``.  Its probabilities are held
against the JAX package's ``Predictor`` on the same JSON, bytes and
input at ``tests/test_torch_predict.py``'s fp32 tolerance (1e-5; the
JAX side's convolutions in true fp32), and against the port's own
``Predictor`` in process (the same arithmetic: 1e-6).  The client also
runs ``MXPredForwardAsync``/``GetOutputAsync``, ``MXPredReshape`` to
batch 1, a bad input key and a too-small output buffer
(``MXPredGetLastError``), a buffer freed right after ``SetInput``,
``dev_type`` 2 without a card, and an unknown ``dev_type``.

The client's embedded interpreter runs with a ``PYTHONPATH`` whose
first entry holds ``jax`` and ``mxnet_tpu`` packages that raise on
import: the run succeeds only if neither is imported.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.models import resnet as jresnet
from mxnet_tpu.predict import Predictor as JPredictor

from mxnet_tpu_torch import libinfo
from mxnet_tpu_torch import symbol as tsym
from mxnet_tpu_torch.models import resnet as tresnet
from mxnet_tpu_torch.predict import Predictor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (4, 3, 16, 16)
PROB_TOL = 1e-5     # tests/test_torch_predict.py's fp32 prob_tol
SAME_TOL = 1e-6     # the port in process: the same arithmetic

CLIENT = textwrap.dedent(r"""
    #include <stdint.h>
    #include <stdio.h>
    #include <stdlib.h>
    #include <string.h>
    #include "mxtpu.h"

    /* MXNet's c_predict_api.h declares it; mxtpu.h does not */
    int MXPredReshape(uint32_t num_input_nodes, const char **input_keys,
                      const uint32_t *input_shape_indptr,
                      const uint32_t *input_shape_data, void *handle,
                      void **out);

    static char *slurp(const char *path, long *size) {
      FILE *f = fopen(path, "rb");
      if (!f) return NULL;
      fseek(f, 0, SEEK_END);
      *size = ftell(f);
      fseek(f, 0, SEEK_SET);
      char *buf = malloc(*size + 1);
      if (fread(buf, 1, *size, f) != (size_t)*size) return NULL;
      buf[*size] = 0;
      fclose(f);
      return buf;
    }

    static int dump(const char *path, const float *x, size_t n) {
      FILE *f = fopen(path, "wb");
      if (!f || fwrite(x, 4, n, f) != n) return 1;
      fclose(f);
      return 0;
    }

    #define CHECK(x) if ((x) != 0) { \
        fprintf(stderr, "%s: %s\n", #x, MXPredGetLastError()); return 3; }

    int main(int argc, char **argv) {
      /* argv: symbol.json params input.f32 out_dir dev_type */
      long ns, np_, nx;
      char *sym = slurp(argv[1], &ns);
      char *params = slurp(argv[2], &np_);
      float *x = (float *)slurp(argv[3], &nx);
      int dev_type = atoi(argv[5]);
      char path[4096];
      const char *keys[] = {"data"};
      uint32_t indptr[] = {0, 4};
      uint32_t shape[] = {4, 3, 16, 16};
      void *h = NULL;
      if (MXPredCreate(sym, params, (int)np_, dev_type, 0, 1, keys, indptr,
                       shape, &h) != 0) {
        printf("CREATE FAILED %s\n", MXPredGetLastError());
        return 0;
      }
      /* SetInput copies: the buffer is scribbled on and freed at once */
      float *copy = malloc(nx);
      memcpy(copy, x, nx);
      CHECK(MXPredSetInput(h, "data", copy, (uint32_t)(nx / 4)));
      memset(copy, 0x7f, nx);
      free(copy);
      CHECK(MXPredForward(h));
      uint32_t *oshape, ondim;
      CHECK(MXPredGetOutputShape(h, 0, &oshape, &ondim));
      uint32_t total = 1;
      for (uint32_t i = 0; i < ondim; ++i) total *= oshape[i];
      printf("shape %u %u %u\n", ondim, oshape[0], oshape[1]);
      float *out = malloc(total * 4);
      CHECK(MXPredGetOutput(h, 0, out, total));
      snprintf(path, sizeof path, "%s/probs.f32", argv[4]);
      if (dump(path, out, total)) return 4;

      /* too small a buffer, a bad key: -1 and the error text */
      if (MXPredGetOutput(h, 0, out, total - 1) == 0) return 5;
      printf("SMALL %s\n", MXPredGetLastError());
      if (MXPredSetInput(h, "no_such_input", x, 4) == 0) return 6;
      printf("BADKEY %s\n", MXPredGetLastError());

      /* two tickets in flight reproduce the synchronous output */
      int64_t t0, t1;
      CHECK(MXPredForwardAsync(h, &t0));
      CHECK(MXPredForwardAsync(h, &t1));
      float *a1 = malloc(total * 4), *a0 = malloc(total * 4);
      CHECK(MXPredGetOutputAsync(h, t1, 0, a1, total));
      CHECK(MXPredGetOutputAsync(h, t0, 0, a0, total));
      if (memcmp(a0, out, total * 4) || memcmp(a1, out, total * 4)) {
        fprintf(stderr, "async outputs differ\n");
        return 7;
      }

      /* a second handle at batch 1 over the same weights */
      uint32_t shape1[] = {1, 3, 16, 16};
      void *h1 = NULL;
      CHECK(MXPredReshape(1, keys, indptr, shape1, h, &h1));
      CHECK(MXPredSetInput(h1, "data", x, 3 * 16 * 16));
      CHECK(MXPredForward(h1));
      CHECK(MXPredGetOutputShape(h1, 0, &oshape, &ondim));
      printf("reshaped %u %u\n", oshape[0], oshape[1]);
      CHECK(MXPredGetOutput(h1, 0, a1, oshape[0] * oshape[1]));
      snprintf(path, sizeof path, "%s/probs1.f32", argv[4]);
      if (dump(path, a1, oshape[0] * oshape[1])) return 8;
      /* the first handle is untouched by the reshape */
      CHECK(MXPredGetOutputShape(h, 0, &oshape, &ondim));
      printf("original %u %u\n", oshape[0], oshape[1]);
      MXPredFree(h1);
      MXPredFree(h);
      printf("C PREDICT OK\n");
      return 0;
    }
""")


@pytest.fixture(scope="module")
def deployment(tmp_path_factory):
    """resnet-8's JSON, a JAX-written ``.params`` file, an input."""
    tmp = tmp_path_factory.mktemp("cpredict")
    jnet = jresnet.get_symbol(10, 8, SHAPE[1:])
    json_str = jnet.tojson()
    arg, aux = tresnet.random_params(tsym.load_json(json_str), seed=0,
                                     data=SHAPE)
    rng = np.random.default_rng(4)
    arg["fc1_weight"] = arg["fc1_weight"] * np.float32(0.05)
    params = str(tmp / "net.params")
    jmx.nd.save(params, {**{f"arg:{k}": jmx.nd.array(v)
                            for k, v in arg.items()},
                         **{f"aux:{k}": jmx.nd.array(v)
                            for k, v in aux.items()}})
    (tmp / "net.json").write_text(json_str)
    x = rng.normal(size=SHAPE).astype(np.float32)
    x.tofile(str(tmp / "x.f32"))
    return tmp, json_str, params, x


@pytest.fixture(scope="module")
def client(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cclient")
    lib = libinfo.find_lib_path("predict")
    (tmp / "client.c").write_text(CLIENT)
    exe = str(tmp / "client")
    r = subprocess.run(
        ["gcc", str(tmp / "client.c"),
         *(f"-I{d}" for d in libinfo.include_dirs()), lib, "-o", exe,
         f"-Wl,-rpath,{os.path.dirname(lib)}"],
        capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    # jax and mxnet_tpu that fail on import, first on the path
    poison = tmp / "poison"
    for pkg in ("jax", "mxnet_tpu"):
        (poison / pkg).mkdir(parents=True)
        (poison / pkg / "__init__.py").write_text(
            f"raise ImportError('the port imported {pkg}')\n")
    env = libinfo.client_env()
    env["PYTHONPATH"] = str(poison) + os.pathsep + env["PYTHONPATH"]
    env["MXTPU_CONV_PRECISION"] = "float32"
    return exe, env


def _run(client, deployment, dev_type):
    exe, env = client
    tmp, _, params, _ = deployment
    r = subprocess.run([exe, str(tmp / "net.json"), params,
                        str(tmp / "x.f32"), str(tmp), str(dev_type)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


@pytest.fixture(scope="module")
def cpu_run(client, deployment):
    return _run(client, deployment, 1)


def test_c_client_matches_the_jax_predictor(cpu_run, deployment,
                                            monkeypatch):
    monkeypatch.setenv("MXTPU_CONV_PRECISION", "float32")
    tmp, json_str, params, x = deployment
    out = cpu_run
    assert "C PREDICT OK" in out, out
    assert "shape 2 4 10" in out and "reshaped 1 10" in out
    assert "original 4 10" in out
    probs = np.fromfile(str(tmp / "probs.f32"), np.float32).reshape(4, 10)
    probs1 = np.fromfile(str(tmp / "probs1.f32"), np.float32).reshape(1, 10)
    with open(params, "rb") as f:
        blob = f.read()
    jp = JPredictor(symbol_json_str=json_str, param_bytes=blob,
                    input_shapes={"data": SHAPE}, dev_type="cpu")
    jp.forward(data=x)
    want = jp.get_output(0)
    np.testing.assert_allclose(probs, want, rtol=0, atol=PROB_TOL)
    tp = Predictor(symbol_json_str=json_str, param_bytes=blob,
                   input_shapes={"data": SHAPE}, dev_type="cpu")
    tp.forward(data=x)
    np.testing.assert_allclose(probs, tp.get_output(0), rtol=0,
                               atol=SAME_TOL)
    # batch 1 through the reshaped handle: the first image's row
    np.testing.assert_allclose(probs1[0], probs[0], rtol=0, atol=SAME_TOL)
    assert np.allclose(probs.sum(1), 1.0, atol=1e-5)


def test_c_client_errors_name_their_cause(cpu_run):
    out = cpu_run
    assert "SMALL MXPredGetOutput: the output holds 40 values" in out
    assert "BADKEY MXPredSetInput: unknown input no_such_input" in out


@pytest.mark.skipif(__import__("torch").cuda.is_available(),
                    reason="the refusal needs a host without a card")
def test_dev_type_2_without_a_card_raises(client, deployment):
    out = _run(client, deployment, 2)
    assert "CREATE FAILED MXPredCreate: dev_type 2 asks for the card, but " \
           "no CUDA device is available" in out


def test_unknown_dev_type_is_refused(client, deployment):
    out = _run(client, deployment, 7)
    assert "CREATE FAILED MXPredCreate: unknown dev_type 7" in out


PROBE = textwrap.dedent(r"""
    import ctypes, json, sys
    import numpy as np
    from mxnet_tpu_torch import libinfo
    pred = ctypes.CDLL(libinfo.find_lib_path("predict"))
    capi = ctypes.CDLL(libinfo.find_lib_path("capi"))
    pred.MXPredGetLastError.restype = ctypes.c_char_p
    capi.MXGetLastError.restype = ctypes.c_char_p
    sym = open(sys.argv[1], "rb").read() + b"\0"
    params = open(sys.argv[2], "rb").read()
    keys = (ctypes.c_char_p * 1)(b"data")
    indptr = (ctypes.c_uint32 * 2)(0, 4)
    shape = (ctypes.c_uint32 * 4)(4, 3, 16, 16)
    h = ctypes.c_void_p()
    rc = pred.MXPredCreate(sym, params, len(params), 1, 0, 1, keys, indptr,
                           shape, ctypes.byref(h))
    assert rc == 0, pred.MXPredGetLastError()
    x = np.fromfile(sys.argv[3], np.float32)
    assert pred.MXPredSetInput(h, b"data", x.ctypes.data_as(
        ctypes.c_void_p), x.size) == 0
    assert pred.MXPredForward(h) == 0
    out = np.empty(40, np.float32)
    assert pred.MXPredGetOutput(h, 0, out.ctypes.data_as(ctypes.c_void_p),
                                40) == 0
    pred.MXPredFree(h)
    v = ctypes.c_void_p()
    assert capi.MXSymbolCreateVariable(b"data", ctypes.byref(v)) == 0
    capi.MXSymbolFree(v)
    print(json.dumps({"rows": out.reshape(4, 10).sum(1).tolist(),
                      "leaked": sorted(m for m in sys.modules
                                       if m.split(".")[0] in
                                       ("jax", "jaxlib", "mxnet_tpu"))}))
""")


def test_ctypes_in_a_python_process_keeps_jax_out(deployment, tmp_path):
    """Both libraries loaded by ``ctypes`` into a running interpreter
    (the GIL released by ctypes, taken back by each call): a forward
    runs, and neither ``jax`` nor ``mxnet_tpu`` is in ``sys.modules``."""
    import json

    tmp, _, params, _ = deployment
    probe = tmp_path / "probe.py"
    probe.write_text(PROBE)
    r = subprocess.run([sys.executable, str(probe), str(tmp / "net.json"),
                        params, str(tmp / "x.f32")],
                       env=libinfo.client_env(), capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["leaked"] == []
    np.testing.assert_allclose(got["rows"], 1.0, atol=1e-5)

/*
 * The predict ABI of the port (mirrors src/c_predict.cc; parity:
 * include/mxnet/c_predict_api.h + src/c_api/c_predict_api.cc): a C
 * program runs inference through MXPredCreate / SetInput / Forward /
 * GetOutput with the math on the card.
 *
 * The library embeds CPython and forwards each call to
 * mxnet_tpu_torch._c_api_impl, which drives predict.Predictor: the first
 * MXPredCreate starts an interpreter where none runs, and from SetInput
 * on the work is the port's (CUDA kernels, cuDNN, cuBLAS); the
 * interpreter marshals buffers.  The declarations are src/mxtpu.h's,
 * unchanged, so a C client compiles against either package's library.
 *
 * dev_type is MXNet's: 1 the CPU, 2 the card cuda:<dev_id> (an error
 * where there is none); anything else is refused.  SetInput copies the
 * caller's buffer before it returns; GetOutput waits for the card.
 * MXPredReshape (declared by MXNet's c_predict_api.h, not by mxtpu.h)
 * binds a new handle to new input shapes over the same weights.
 *
 * Every function returns 0 on success, -1 on failure, with the text in
 * MXPredGetLastError (thread-local).
 */
#include "mxtpu.h"

#include "py_embed.h"

#include <cstdint>
#include <vector>

using mxtpu_embed::Call;
using mxtpu_embed::CopyOut;
using mxtpu_embed::CsrShapes;
using mxtpu_embed::EnsurePython;
using mxtpu_embed::Fail;
using mxtpu_embed::GilGuard;
using mxtpu_embed::last_error;
using mxtpu_embed::StrList;

namespace {

struct PredHandle {
  PyObject *predictor = nullptr;  // mxnet_tpu_torch.predict.Predictor
  std::vector<uint32_t> shape;    // the last GetOutputShape's answer
};

PyObject *Pred(void *handle) {
  return static_cast<PredHandle *>(handle)->predictor;
}

int Wrap(PyObject *pred, void **out) {
  auto *h = new PredHandle;
  h->predictor = pred;
  *out = h;
  return 0;
}

}  // namespace

extern "C" {

const char *MXPredGetLastError() { return last_error.c_str(); }

int MXPredCreate(const char *symbol_json, const void *param_bytes,
                 int param_size, int dev_type, int dev_id,
                 uint32_t num_input_nodes, const char **input_keys,
                 const uint32_t *input_shape_indptr,
                 const uint32_t *input_shape_data, void **out) {
  EnsurePython();
  GilGuard gil;
  PyObject *params =
      param_bytes ? PyBytes_FromStringAndSize(
                        static_cast<const char *>(param_bytes), param_size)
                  : Py_NewRef(Py_None);
  PyObject *r = Call(
      "pred_create",
      Py_BuildValue("(sNNNii)", symbol_json, params,
                    StrList(input_keys, num_input_nodes),
                    CsrShapes(num_input_nodes, input_shape_indptr,
                              input_shape_data),
                    dev_type, dev_id));
  if (!r) return Fail("MXPredCreate");
  return Wrap(r, out);
}

int MXPredReshape(uint32_t num_input_nodes, const char **input_keys,
                  const uint32_t *input_shape_indptr,
                  const uint32_t *input_shape_data, void *handle,
                  void **out) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call(
      "pred_reshape",
      Py_BuildValue("(ONN)", Pred(handle),
                    StrList(input_keys, num_input_nodes),
                    CsrShapes(num_input_nodes, input_shape_indptr,
                              input_shape_data)));
  if (!r) return Fail("MXPredReshape");
  return Wrap(r, out);
}

int MXPredSetInput(void *handle, const char *key, const float *data,
                   uint32_t size) {
  EnsurePython();
  GilGuard gil;
  // the caller's memory, borrowed for this call: set_input copies it
  // before returning.  Writable only so that torch.from_numpy takes it
  // without a warning; nothing writes through it.
  PyObject *mem = PyMemoryView_FromMemory(
      reinterpret_cast<char *>(const_cast<float *>(data)),
      static_cast<Py_ssize_t>(size) * 4, PyBUF_WRITE);
  PyObject *r = Call("pred_set_input",
                     Py_BuildValue("(OsN)", Pred(handle), key, mem));
  if (!r) return Fail("MXPredSetInput");
  Py_DECREF(r);
  return 0;
}

int MXPredForward(void *handle) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("pred_forward", Py_BuildValue("(O)", Pred(handle)));
  if (!r) return Fail("MXPredForward");
  Py_DECREF(r);
  return 0;
}

int MXPredForwardAsync(void *handle, int64_t *out_ticket) {
  EnsurePython();
  GilGuard gil;
  PyObject *t =
      Call("pred_forward_async", Py_BuildValue("(O)", Pred(handle)));
  if (!t) return Fail("MXPredForwardAsync");
  *out_ticket = PyLong_AsLongLong(t);
  Py_DECREF(t);
  if (PyErr_Occurred()) return Fail("MXPredForwardAsync");
  return 0;
}

int MXPredGetOutputAsync(void *handle, int64_t ticket, uint32_t index,
                         float *data, uint32_t size) {
  EnsurePython();
  GilGuard gil;
  return CopyOut(Call("pred_get_async",
                      Py_BuildValue("(OLI)", Pred(handle),
                                    static_cast<long long>(ticket), index)),
                 data, size, "MXPredGetOutputAsync", false);
}

int MXPredGetOutputShape(void *handle, uint32_t index, uint32_t **shape_data,
                         uint32_t *shape_ndim) {
  EnsurePython();
  GilGuard gil;
  PyObject *shp = Call("pred_get_output_shape",
                       Py_BuildValue("(OI)", Pred(handle), index));
  if (!shp) return Fail("MXPredGetOutputShape");
  auto *h = static_cast<PredHandle *>(handle);
  Py_ssize_t n = PyTuple_Size(shp);
  h->shape.resize(static_cast<size_t>(n));
  for (Py_ssize_t i = 0; i < n; ++i)
    h->shape[i] = static_cast<uint32_t>(
        PyLong_AsUnsignedLong(PyTuple_GetItem(shp, i)));
  Py_DECREF(shp);
  *shape_data = h->shape.data();
  *shape_ndim = static_cast<uint32_t>(n);
  return 0;
}

int MXPredGetOutput(void *handle, uint32_t index, float *data,
                    uint32_t size) {
  EnsurePython();
  GilGuard gil;
  return CopyOut(Call("pred_get_output",
                      Py_BuildValue("(OI)", Pred(handle), index)),
                 data, size, "MXPredGetOutput", false);
}

int MXPredFree(void *handle) {
  auto *h = static_cast<PredHandle *>(handle);
  {
    EnsurePython();
    GilGuard gil;
    Py_XDECREF(h->predictor);
  }
  delete h;
  return 0;
}

}  // extern "C"

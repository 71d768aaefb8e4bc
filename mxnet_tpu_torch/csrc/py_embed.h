/*
 * CPython embedding shared by the port's C ABIs (c_predict.cc, c_api.cc;
 * mirrors src/py_embed.h).  Each library that includes it gets its own
 * thread-local error text and interpreter bootstrap: Py_InitializeEx runs
 * only where no interpreter is running, so a C program gets one at its
 * first call, and a Python process that loads the library through ctypes
 * keeps its own (ctypes releases the GIL around the call; GilGuard takes
 * it back).
 *
 * Every call goes to mxnet_tpu_torch._c_api_impl; nothing here imports
 * the JAX package.
 */
#ifndef MXTPU_TORCH_PY_EMBED_H_
#define MXTPU_TORCH_PY_EMBED_H_

#include <Python.h>

#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>

namespace mxtpu_embed {

inline thread_local std::string last_error;

inline void EnsurePython() {
  static std::once_flag flag;
  std::call_once(flag, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      // release the GIL taken by initialization so GilGuard works the
      // same for an embedding program and a host interpreter
      PyEval_SaveThread();
    }
  });
}

struct GilGuard {
  PyGILState_STATE st;
  GilGuard() { st = PyGILState_Ensure(); }
  ~GilGuard() { PyGILState_Release(st); }
};

/* The pending Python exception as last_error; returns -1. */
inline int Fail(const char *where) {
  PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
  PyErr_Fetch(&type, &value, &trace);
  last_error = where;
  if (value) {
    PyObject *s = PyObject_Str(value);
    if (s) {
      const char *text = PyUnicode_AsUTF8(s);
      if (text) {
        last_error += ": ";
        last_error += text;
      }
      Py_DECREF(s);
    }
  }
  PyErr_Clear();
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(trace);
  return -1;
}

/* mxnet_tpu_torch._c_api_impl, imported once (the GIL held). */
inline PyObject *Impl() {
  static PyObject *impl = nullptr;  // process lifetime
  if (!impl) impl = PyImport_ImportModule("mxnet_tpu_torch._c_api_impl");
  return impl;
}

/* impl.<fn>(*args): a new reference, or nullptr with the exception set.
 * Consumes args (nullptr: no arguments). */
inline PyObject *Call(const char *fn, PyObject *args) {
  PyObject *impl = Impl();
  PyObject *f = impl ? PyObject_GetAttrString(impl, fn) : nullptr;
  PyObject *r = nullptr;
  if (f) {
    r = args ? PyObject_CallObject(f, args) : PyObject_CallNoArgs(f);
    Py_DECREF(f);
  }
  Py_XDECREF(args);
  return r;
}

inline PyObject *ShapeList(const uint32_t *shape, uint32_t ndim) {
  PyObject *lst = PyList_New(ndim);
  for (uint32_t i = 0; i < ndim; ++i)
    PyList_SET_ITEM(lst, i, PyLong_FromUnsignedLong(shape[i]));
  return lst;
}

inline PyObject *StrList(const char **strs, uint32_t n) {
  PyObject *lst = PyList_New(n);
  for (uint32_t i = 0; i < n; ++i)
    PyList_SET_ITEM(lst, i, PyUnicode_FromString(strs[i]));
  return lst;
}

/* CSR (ind_ptr / shape_data) -> a list of shape lists */
inline PyObject *CsrShapes(uint32_t num, const uint32_t *ind_ptr,
                           const uint32_t *shape_data) {
  PyObject *lst = PyList_New(num);
  for (uint32_t i = 0; i < num; ++i) {
    uint32_t lo = ind_ptr[i], hi = ind_ptr[i + 1];
    PyList_SET_ITEM(lst, i, ShapeList(shape_data + lo, hi - lo));
  }
  return lst;
}

/* Copy a contiguous Python buffer (a float32 array, bytes) into a C
 * buffer of `size` floats; -1 with last_error when it does not fit.
 * Consumes obj. */
inline int CopyOut(PyObject *obj, float *data, uint64_t size,
                   const char *where, bool exact) {
  if (!obj) return Fail(where);
  Py_buffer view;
  if (PyObject_GetBuffer(obj, &view, PyBUF_C_CONTIGUOUS) != 0) {
    Py_DECREF(obj);
    return Fail(where);
  }
  uint64_t want = size * sizeof(float);
  uint64_t have = static_cast<uint64_t>(view.len);
  int rc = 0;
  if (exact ? have != want : have > want) {
    last_error = std::string(where) + ": the output holds " +
                 std::to_string(have / sizeof(float)) +
                 " values, the buffer " + std::to_string(size);
    rc = -1;
  } else {
    std::memcpy(data, view.buf, have);
  }
  PyBuffer_Release(&view);
  Py_DECREF(obj);
  return rc;
}

}  // namespace mxtpu_embed

#endif  // MXTPU_TORCH_PY_EMBED_H_

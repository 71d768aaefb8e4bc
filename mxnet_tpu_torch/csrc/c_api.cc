/*
 * The general C API of the port (mirrors src/c_api.cc; parity:
 * include/mxnet/c_api.h + src/c_api/c_api.cc): the training-capable ABI
 * that language bindings consume (bindings/cpp/mxtpu.hpp) over the
 * declarations of src/mxtpu_capi.h, unchanged, so a client compiles
 * against either package's library.
 *
 * The library embeds CPython like the predict ABI (c_predict.cc) and
 * delegates to mxnet_tpu_torch._c_api_impl: symbols, executors,
 * kvstores and NDArrays are the port's, on the CPU (dev_type 1) or the
 * card cuda:<dev_id> (dev_type 2, an error where there is none).
 * Handles are PyObject* owned through their reference counts.
 *
 * Threading: every entry point takes the GIL (GilGuard), so the ABI may
 * be called from any host thread, serialised like the reference's
 * global lock in the MXAPIThreadLocalEntry paths.
 */
#include "mxtpu_capi.h"

#include "py_embed.h"

#include <cstdint>
#include <string>
#include <unordered_map>
#include <vector>

using mxtpu_embed::Call;
using mxtpu_embed::CopyOut;
using mxtpu_embed::CsrShapes;
using mxtpu_embed::EnsurePython;
using mxtpu_embed::Fail;
using mxtpu_embed::GilGuard;
using mxtpu_embed::last_error;
using mxtpu_embed::ShapeList;
using mxtpu_embed::StrList;

namespace {

/* Per-handle string cache for the List* / SaveToJSON returns.  Keyed by
 * the handle; entries die with MX*Free. */
struct StrCache {
  std::vector<std::string> strings;
  std::vector<const char *> ptrs;
  std::string json;
};
std::unordered_map<void *, StrCache> &Caches() {
  static std::unordered_map<void *, StrCache> caches;
  return caches;
}

int ReturnStrList(void *handle, PyObject *list, uint32_t *out_size,
                  const char ***out_array, const char *where) {
  if (!list) return Fail(where);
  StrCache &c = Caches()[handle];
  c.strings.clear();
  c.ptrs.clear();
  Py_ssize_t n = PyList_Size(list);
  for (Py_ssize_t i = 0; i < n; ++i)
    c.strings.emplace_back(PyUnicode_AsUTF8(PyList_GetItem(list, i)));
  for (auto &s : c.strings) c.ptrs.push_back(s.c_str());
  Py_DECREF(list);
  *out_size = static_cast<uint32_t>(n);
  *out_array = c.ptrs.data();
  return 0;
}

int FreeHandle(void *handle) {
  if (!handle) return 0;
  EnsurePython();
  GilGuard gil;
  Caches().erase(handle);
  Py_DECREF(reinterpret_cast<PyObject *>(handle));
  return 0;
}

/* thread-local InferShape result: [arg_shapes, out_shapes, aux_shapes] */
thread_local std::vector<std::vector<std::vector<uint32_t>>> infer_result;

}  // namespace

extern "C" {

const char *MXGetLastError(void) { return last_error.c_str(); }

int MXRandomSeed(int seed) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("random_seed", Py_BuildValue("(i)", seed));
  if (!r) return Fail("MXRandomSeed");
  Py_DECREF(r);
  return 0;
}

int MXNDArrayWaitAll(void) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("ndarray_wait_all", nullptr);
  if (!r) return Fail("MXNDArrayWaitAll");
  Py_DECREF(r);
  return 0;
}

/* ------------------------------------------------------------- NDArray */
int MXNDArrayCreate(const uint32_t *shape, uint32_t ndim, int dev_type,
                    int dev_id, NDArrayHandle *out) {
  EnsurePython();
  GilGuard gil;
  PyObject *args = PyTuple_Pack(3, ShapeList(shape, ndim),
                                PyLong_FromLong(dev_type),
                                PyLong_FromLong(dev_id));
  /* PyTuple_Pack INCREFs; drop our refs */
  for (int i = 0; i < 3; ++i) Py_DECREF(PyTuple_GetItem(args, i));
  PyObject *r = Call("ndarray_create", args);  // Call consumes args
  if (!r) return Fail("MXNDArrayCreate");
  *out = r;  // ownership to caller
  return 0;
}

int MXNDArrayFree(NDArrayHandle handle) { return FreeHandle(handle); }

int MXNDArrayGetShape(NDArrayHandle handle, uint32_t *out_ndim,
                      uint32_t *shape_buf, uint32_t buf_cap) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("ndarray_shape",
                     Py_BuildValue("(O)", reinterpret_cast<PyObject *>(handle)));
  if (!r) return Fail("MXNDArrayGetShape");
  Py_ssize_t n = PyList_Size(r);
  *out_ndim = static_cast<uint32_t>(n);
  for (Py_ssize_t i = 0; i < n && i < static_cast<Py_ssize_t>(buf_cap); ++i)
    shape_buf[i] = static_cast<uint32_t>(
        PyLong_AsUnsignedLong(PyList_GetItem(r, i)));
  Py_DECREF(r);
  return 0;
}

int MXNDArraySyncCopyFromCPU(NDArrayHandle handle, const float *data,
                             uint64_t size) {
  EnsurePython();
  GilGuard gil;
  PyObject *mem = PyMemoryView_FromMemory(
      const_cast<char *>(reinterpret_cast<const char *>(data)),
      static_cast<Py_ssize_t>(size * sizeof(float)), PyBUF_READ);
  PyObject *r = Call("ndarray_sync_copy_from",
                     Py_BuildValue("(ON)",
                                   reinterpret_cast<PyObject *>(handle), mem));
  if (!r) return Fail("MXNDArraySyncCopyFromCPU");
  Py_DECREF(r);
  return 0;
}

int MXNDArraySyncCopyToCPU(NDArrayHandle handle, float *data, uint64_t size) {
  EnsurePython();
  GilGuard gil;
  return CopyOut(Call("ndarray_sync_copy_to",
                      Py_BuildValue("(O)",
                                    reinterpret_cast<PyObject *>(handle))),
                 data, size, "MXNDArraySyncCopyToCPU", true);
}

/* -------------------------------------------------------------- Symbol */
int MXSymbolListAtomicSymbolCreators(uint32_t *out_size,
                                     const char ***out_array) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("symbol_list_atomic_creators", nullptr);
  /* cache key: the function itself (stable) */
  return ReturnStrList(reinterpret_cast<void *>(
                           const_cast<char *>("atomic_creators")),
                       r, out_size, out_array,
                       "MXSymbolListAtomicSymbolCreators");
}

int MXSymbolCreateAtomicSymbol(const char *op, uint32_t num_param,
                               const char **keys, const char **vals,
                               SymbolHandle *out) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("symbol_create_atomic",
                     Py_BuildValue("(sNN)", op, StrList(keys, num_param),
                                   StrList(vals, num_param)));
  if (!r) return Fail("MXSymbolCreateAtomicSymbol");
  *out = r;
  return 0;
}

int MXSymbolCreateVariable(const char *name, SymbolHandle *out) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("symbol_create_variable", Py_BuildValue("(s)", name));
  if (!r) return Fail("MXSymbolCreateVariable");
  *out = r;
  return 0;
}

int MXSymbolCompose(SymbolHandle sym, const char *name, uint32_t num_args,
                    const char **keys, SymbolHandle *args) {
  EnsurePython();
  GilGuard gil;
  PyObject *key_list = keys ? StrList(keys, num_args)
                            : (Py_INCREF(Py_None), Py_None);
  PyObject *arg_list = PyList_New(num_args);
  for (uint32_t i = 0; i < num_args; ++i) {
    PyObject *a = reinterpret_cast<PyObject *>(args[i]);
    Py_INCREF(a);
    PyList_SET_ITEM(arg_list, i, a);
  }
  PyObject *r = Call("symbol_compose",
                     Py_BuildValue("(OsNN)", reinterpret_cast<PyObject *>(sym),
                                   name ? name : "", key_list, arg_list));
  if (!r) return Fail("MXSymbolCompose");
  Py_DECREF(r);  // compose mutates sym in place
  return 0;
}

int MXSymbolCreateFromJSON(const char *json, SymbolHandle *out) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("symbol_from_json", Py_BuildValue("(s)", json));
  if (!r) return Fail("MXSymbolCreateFromJSON");
  *out = r;
  return 0;
}

int MXSymbolSaveToJSON(SymbolHandle sym, const char **out_json) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("symbol_to_json",
                     Py_BuildValue("(O)", reinterpret_cast<PyObject *>(sym)));
  if (!r) return Fail("MXSymbolSaveToJSON");
  StrCache &c = Caches()[sym];
  c.json = PyUnicode_AsUTF8(r);
  Py_DECREF(r);
  *out_json = c.json.c_str();
  return 0;
}

#define LIST_FN(CNAME, PYNAME)                                              \
  int CNAME(SymbolHandle sym, uint32_t *out_size, const char ***out_array) { \
    EnsurePython();                                                         \
    GilGuard gil;                                                           \
    PyObject *r = Call(PYNAME, Py_BuildValue(                               \
        "(O)", reinterpret_cast<PyObject *>(sym)));                         \
    return ReturnStrList(sym, r, out_size, out_array, #CNAME);              \
  }

LIST_FN(MXSymbolListArguments, "symbol_list_arguments")
LIST_FN(MXSymbolListOutputs, "symbol_list_outputs")
LIST_FN(MXSymbolListAuxiliaryStates, "symbol_list_auxiliary_states")
#undef LIST_FN

int MXSymbolInferShape(SymbolHandle sym, uint32_t num_known,
                       const char **keys, const uint32_t *arg_ind_ptr,
                       const uint32_t *arg_shape_data, uint32_t *arg_count,
                       uint32_t *out_count, uint32_t *aux_count) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("symbol_infer_shape",
                     Py_BuildValue("(ONN)", reinterpret_cast<PyObject *>(sym),
                                   StrList(keys, num_known),
                                   CsrShapes(num_known, arg_ind_ptr,
                                             arg_shape_data)));
  if (!r) return Fail("MXSymbolInferShape");
  infer_result.assign(3, {});
  for (int g = 0; g < 3; ++g) {
    PyObject *group = PyTuple_GetItem(r, g);
    Py_ssize_t n = PyList_Size(group);
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject *shp = PyList_GetItem(group, i);
      std::vector<uint32_t> dims;
      for (Py_ssize_t d = 0; d < PyList_Size(shp); ++d)
        dims.push_back(static_cast<uint32_t>(
            PyLong_AsUnsignedLong(PyList_GetItem(shp, d))));
      infer_result[g].push_back(std::move(dims));
    }
  }
  Py_DECREF(r);
  *arg_count = static_cast<uint32_t>(infer_result[0].size());
  *out_count = static_cast<uint32_t>(infer_result[1].size());
  *aux_count = static_cast<uint32_t>(infer_result[2].size());
  return 0;
}

int MXSymbolInferShapeGet(int which, uint32_t index, uint32_t *out_ndim,
                          uint32_t *shape_buf, uint32_t buf_cap) {
  if (which < 0 || which > 2 || infer_result.size() != 3 ||
      index >= infer_result[static_cast<size_t>(which)].size()) {
    last_error = "MXSymbolInferShapeGet: no InferShape result on this "
                 "thread or index out of range";
    return -1;
  }
  auto &dims = infer_result[static_cast<size_t>(which)][index];
  *out_ndim = static_cast<uint32_t>(dims.size());
  for (uint32_t i = 0; i < dims.size() && i < buf_cap; ++i)
    shape_buf[i] = dims[i];
  return 0;
}

int MXSymbolFree(SymbolHandle sym) { return FreeHandle(sym); }

/* ------------------------------------------------------------ Executor */
int MXExecutorSimpleBind(SymbolHandle sym, int dev_type, int dev_id,
                         const char *grad_req, uint32_t num_args,
                         const char **keys, const uint32_t *arg_ind_ptr,
                         const uint32_t *arg_shape_data,
                         ExecutorHandle *out) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("executor_simple_bind",
                     Py_BuildValue("(OiisNN)",
                                   reinterpret_cast<PyObject *>(sym),
                                   dev_type, dev_id, grad_req,
                                   StrList(keys, num_args),
                                   CsrShapes(num_args, arg_ind_ptr,
                                             arg_shape_data)));
  if (!r) return Fail("MXExecutorSimpleBind");
  *out = r;
  return 0;
}

int MXExecutorForward(ExecutorHandle handle, int is_train) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("executor_forward",
                     Py_BuildValue("(Oi)",
                                   reinterpret_cast<PyObject *>(handle),
                                   is_train));
  if (!r) return Fail("MXExecutorForward");
  Py_DECREF(r);
  return 0;
}

int MXExecutorBackward(ExecutorHandle handle) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("executor_backward",
                     Py_BuildValue("(O)",
                                   reinterpret_cast<PyObject *>(handle)));
  if (!r) return Fail("MXExecutorBackward");
  Py_DECREF(r);
  return 0;
}

int MXExecutorNumOutputs(ExecutorHandle handle, uint32_t *out) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("executor_num_outputs",
                     Py_BuildValue("(O)",
                                   reinterpret_cast<PyObject *>(handle)));
  if (!r) return Fail("MXExecutorNumOutputs");
  *out = static_cast<uint32_t>(PyLong_AsUnsignedLong(r));
  Py_DECREF(r);
  return 0;
}

namespace {
/* Executor NDArray lookups return OWNED handles (the Python side may
 * construct a fresh wrapper per call); the caller frees each with
 * MXNDArrayFree.  The underlying buffer stays shared with the executor,
 * so writes through the handle are visible to subsequent forwards. */
int ExecLookup(const char *pyfn, ExecutorHandle handle, PyObject *arg2,
               NDArrayHandle *out, const char *where) {
  PyObject *r = Call(pyfn, Py_BuildValue(
      "(ON)", reinterpret_cast<PyObject *>(handle), arg2));
  if (!r) return Fail(where);
  *out = r;
  return 0;
}
}  // namespace

int MXExecutorOutput(ExecutorHandle handle, uint32_t index,
                     NDArrayHandle *out) {
  EnsurePython();
  GilGuard gil;
  return ExecLookup("executor_output", handle,
                    PyLong_FromUnsignedLong(index), out, "MXExecutorOutput");
}

int MXExecutorArgArray(ExecutorHandle handle, const char *name,
                       NDArrayHandle *out) {
  EnsurePython();
  GilGuard gil;
  return ExecLookup("executor_arg_array", handle,
                    PyUnicode_FromString(name), out, "MXExecutorArgArray");
}

int MXExecutorGradArray(ExecutorHandle handle, const char *name,
                        NDArrayHandle *out) {
  EnsurePython();
  GilGuard gil;
  return ExecLookup("executor_grad_array", handle,
                    PyUnicode_FromString(name), out, "MXExecutorGradArray");
}

int MXExecutorFree(ExecutorHandle handle) { return FreeHandle(handle); }

/* ------------------------------------------------------------- KVStore */
int MXKVStoreCreate(const char *type, KVStoreHandle *out) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("kvstore_create", Py_BuildValue("(s)", type));
  if (!r) return Fail("MXKVStoreCreate");
  *out = r;
  return 0;
}

int MXKVStoreFree(KVStoreHandle handle) { return FreeHandle(handle); }

namespace {
PyObject *IntList(const int *keys, uint32_t n) {
  PyObject *lst = PyList_New(n);
  for (uint32_t i = 0; i < n; ++i)
    PyList_SET_ITEM(lst, i, PyLong_FromLong(keys[i]));
  return lst;
}

PyObject *HandleList(NDArrayHandle *vals, uint32_t n) {
  PyObject *lst = PyList_New(n);
  for (uint32_t i = 0; i < n; ++i) {
    PyObject *v = reinterpret_cast<PyObject *>(vals[i]);
    Py_INCREF(v);
    PyList_SET_ITEM(lst, i, v);
  }
  return lst;
}
}  // namespace

int MXKVStoreInit(KVStoreHandle handle, uint32_t num, const int *keys,
                  NDArrayHandle *vals) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("kvstore_init",
                     Py_BuildValue("(ONN)",
                                   reinterpret_cast<PyObject *>(handle),
                                   IntList(keys, num), HandleList(vals, num)));
  if (!r) return Fail("MXKVStoreInit");
  Py_DECREF(r);
  return 0;
}

int MXKVStorePush(KVStoreHandle handle, uint32_t num, const int *keys,
                  NDArrayHandle *vals, int priority) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("kvstore_push",
                     Py_BuildValue("(ONNi)",
                                   reinterpret_cast<PyObject *>(handle),
                                   IntList(keys, num), HandleList(vals, num),
                                   priority));
  if (!r) return Fail("MXKVStorePush");
  Py_DECREF(r);
  return 0;
}

int MXKVStorePull(KVStoreHandle handle, uint32_t num, const int *keys,
                  NDArrayHandle *outs, int priority) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("kvstore_pull",
                     Py_BuildValue("(ONNi)",
                                   reinterpret_cast<PyObject *>(handle),
                                   IntList(keys, num), HandleList(outs, num),
                                   priority));
  if (!r) return Fail("MXKVStorePull");
  Py_DECREF(r);
  return 0;
}

namespace {
/* Trampoline: a PyCFunction whose capsule self carries the C updater. */
struct UpdaterClosure {
  MXKVStoreUpdater fn;
  void *handle;
};

PyObject *UpdaterTrampoline(PyObject *self, PyObject *args) {
  auto *cl = static_cast<UpdaterClosure *>(
      PyCapsule_GetPointer(self, "mxtpu.updater"));
  int key = 0;
  PyObject *recv = nullptr, *local = nullptr;
  if (!PyArg_ParseTuple(args, "iOO", &key, &recv, &local)) return nullptr;
  /* release the GIL? no: the C updater will call back into the ABI,
   * which re-acquires; keeping it held avoids a handoff race. */
  cl->fn(key, recv, local, cl->handle);
  Py_RETURN_NONE;
}

PyMethodDef updater_def = {"mxtpu_updater", UpdaterTrampoline, METH_VARARGS,
                           "C kvstore updater trampoline"};

void UpdaterCapsuleFree(PyObject *cap) {
  delete static_cast<UpdaterClosure *>(
      PyCapsule_GetPointer(cap, "mxtpu.updater"));
}
}  // namespace

int MXKVStoreSetUpdater(KVStoreHandle handle, MXKVStoreUpdater updater,
                        void *updater_handle) {
  EnsurePython();
  GilGuard gil;
  auto *cl = new UpdaterClosure{updater, updater_handle};
  PyObject *cap = PyCapsule_New(cl, "mxtpu.updater", UpdaterCapsuleFree);
  PyObject *fn = PyCFunction_New(&updater_def, cap);
  Py_DECREF(cap);  // fn owns it now
  PyObject *r = Call("kvstore_set_updater",
                     Py_BuildValue("(ON)",
                                   reinterpret_cast<PyObject *>(handle), fn));
  if (!r) return Fail("MXKVStoreSetUpdater");
  Py_DECREF(r);
  return 0;
}

int MXKVStoreGetRank(KVStoreHandle handle, int *rank) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("kvstore_rank",
                     Py_BuildValue("(O)",
                                   reinterpret_cast<PyObject *>(handle)));
  if (!r) return Fail("MXKVStoreGetRank");
  *rank = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int MXKVStoreGetGroupSize(KVStoreHandle handle, int *size) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("kvstore_num_workers",
                     Py_BuildValue("(O)",
                                   reinterpret_cast<PyObject *>(handle)));
  if (!r) return Fail("MXKVStoreGetGroupSize");
  *size = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int MXImperativeInvoke(const char *op, uint32_t num_inputs,
                       NDArrayHandle *inputs, uint32_t num_params,
                       const char **keys, const char **vals,
                       uint32_t out_capacity, uint32_t *num_outputs,
                       NDArrayHandle *outputs) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("imperative_invoke",
                     Py_BuildValue("(sNNN)", op,
                                   HandleList(inputs, num_inputs),
                                   StrList(keys, num_params),
                                   StrList(vals, num_params)));
  if (!r) return Fail("MXImperativeInvoke");
  Py_ssize_t n = PyList_Size(r);
  if (static_cast<uint32_t>(n) > out_capacity) {
    Py_DECREF(r);
    last_error = "MXImperativeInvoke: output buffer too small";
    return -1;
  }
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject *o = PyList_GetItem(r, i);
    Py_INCREF(o);
    outputs[i] = o;
  }
  *num_outputs = static_cast<uint32_t>(n);
  Py_DECREF(r);
  return 0;
}

int MXListDataIters(uint32_t *out_size, const char ***out_names) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("list_data_iters", PyTuple_New(0));
  /* cached under a process-stable key (nullptr handle slot) */
  return ReturnStrList(nullptr, r, out_size, out_names, "MXListDataIters");
}

int MXDataIterCreateIter(const char *name, uint32_t num_param,
                         const char **keys, const char **vals,
                         DataIterHandle *out) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("data_iter_create",
                     Py_BuildValue("(sNN)", name, StrList(keys, num_param),
                                   StrList(vals, num_param)));
  if (!r) return Fail("MXDataIterCreateIter");
  *out = r;
  return 0;
}

int MXDataIterNext(DataIterHandle handle, int *out) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("data_iter_next",
                     Py_BuildValue("(O)",
                                   reinterpret_cast<PyObject *>(handle)));
  if (!r) return Fail("MXDataIterNext");
  *out = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int MXDataIterBeforeFirst(DataIterHandle handle) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("data_iter_before_first",
                     Py_BuildValue("(O)",
                                   reinterpret_cast<PyObject *>(handle)));
  if (!r) return Fail("MXDataIterBeforeFirst");
  Py_DECREF(r);
  return 0;
}

namespace {
int IterPart(const char *fn, const char *where, DataIterHandle handle,
             NDArrayHandle *out) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call(fn, Py_BuildValue(
      "(O)", reinterpret_cast<PyObject *>(handle)));
  if (!r) return Fail(where);
  *out = r;  // new NDArray handle, caller frees
  return 0;
}
}  // namespace

int MXDataIterGetData(DataIterHandle handle, NDArrayHandle *out) {
  return IterPart("data_iter_data", "MXDataIterGetData", handle, out);
}

int MXDataIterGetLabel(DataIterHandle handle, NDArrayHandle *out) {
  return IterPart("data_iter_label", "MXDataIterGetLabel", handle, out);
}

int MXDataIterGetPadNum(DataIterHandle handle, int *pad) {
  EnsurePython();
  GilGuard gil;
  PyObject *r = Call("data_iter_pad",
                     Py_BuildValue("(O)",
                                   reinterpret_cast<PyObject *>(handle)));
  if (!r) return Fail("MXDataIterGetPadNum");
  *pad = static_cast<int>(PyLong_AsLong(r));
  Py_DECREF(r);
  return 0;
}

int MXDataIterFree(DataIterHandle handle) { return FreeHandle(handle); }

}  // extern "C"

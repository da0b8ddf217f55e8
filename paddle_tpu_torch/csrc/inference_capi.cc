// The port's C inference API (pd_c_api.h; reference paddle/fluid/
// inference/capi/c_api.cc: PD_NewPredictor / PD_PredictorRun /
// PD_DeletePredictor over PD_Tensor).
//
// The predictor is paddle_tpu_torch.inference.Predictor reached through an
// embedded CPython: a saved torch.export program run on the CUDA card
// (kernel K2, the op paddle_tpu_torch::flash_fwd, where the program holds
// it) or, when the caller asks, on the CPU. The C surface is the JAX
// package's csrc/inference_capi.cc: an opaque handle, a run over raw
// float32 buffers and shapes, outputs malloc'd for the caller,
// PD_GetLastError; plus PD_NewPredictorWithDevice.
//
// The interpreter. The build (paddle_tpu_torch/inference/capi.py)
// compiles in the Python that built the library (PD_PYTHON_EXECUTABLE)
// and the directory that holds the package (PD_PACKAGE_ROOT). The
// interpreter is configured with that executable as its program name, so
// it computes that Python's prefix and site-packages (a venv's too, from
// its pyvenv.cfg) and finds torch and numpy there; the package root goes
// first on sys.path. The GIL is released between calls and taken by each
// call (PyGILState), so the threads the runtime starts keep running.
#include <Python.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>

#include "pd_c_api.h"

#ifndef PD_PYTHON_EXECUTABLE
#error "build with -DPD_PYTHON_EXECUTABLE=\"...\" (inference/capi.py)"
#endif
#ifndef PD_PACKAGE_ROOT
#error "build with -DPD_PACKAGE_ROOT=\"...\" (inference/capi.py)"
#endif

static std::string g_err;

// The pending Python exception as "Type: message" in g_err.
static void set_err_from_python() {
  PyObject *t = nullptr, *v = nullptr, *tb = nullptr;
  PyErr_Fetch(&t, &v, &tb);
  PyErr_NormalizeException(&t, &v, &tb);
  std::string msg;
  if (t) {
    PyObject* name = PyObject_GetAttrString(t, "__name__");
    const char* c = name ? PyUnicode_AsUTF8(name) : nullptr;
    if (c) msg = std::string(c) + ": ";
    Py_XDECREF(name);
  }
  PyObject* s = v ? PyObject_Str(v) : nullptr;
  const char* c = s ? PyUnicode_AsUTF8(s) : nullptr;
  msg += c ? c : "unknown python error";
  g_err = msg;
  PyErr_Clear();
  Py_XDECREF(s);
  Py_XDECREF(t);
  Py_XDECREF(v);
  Py_XDECREF(tb);
}

// Start the interpreter once; false (and g_err) if it did not start.
static bool ensure_python() {
  if (Py_IsInitialized()) return true;
  PyConfig config;
  PyConfig_InitPythonConfig(&config);
  config.install_signal_handlers = 0;
  PyStatus st = PyConfig_SetBytesString(&config, &config.program_name,
                                        PD_PYTHON_EXECUTABLE);
  if (!PyStatus_Exception(st)) st = Py_InitializeFromConfig(&config);
  PyConfig_Clear(&config);
  if (PyStatus_Exception(st)) {
    g_err = std::string("failed to start the Python interpreter: ") +
            (st.err_msg ? st.err_msg : "unknown");
    return false;
  }
  PyObject* sys_path = PySys_GetObject("path");  // borrowed
  PyObject* root = PyUnicode_FromString(PD_PACKAGE_ROOT);
  if (!sys_path || !root || PyList_Insert(sys_path, 0, root) != 0) {
    Py_XDECREF(root);
    set_err_from_python();
    PyEval_SaveThread();
    return false;
  }
  Py_DECREF(root);
  PyEval_SaveThread();  // calls take the GIL through PyGILState_Ensure
  return true;
}

extern "C" {

struct PD_Predictor {
  PyObject* pred;
};

const char* PD_GetLastError() { return g_err.c_str(); }

static PD_Predictor* new_predictor(const char* model_prefix, bool named,
                                   int device_id) {
  if (!ensure_python()) return nullptr;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* mod = PyImport_ImportModule("paddle_tpu_torch.inference");
  PyObject* cfg = nullptr;
  PyObject* pred = nullptr;
  PyObject* r = nullptr;
  if (mod) cfg = PyObject_CallMethod(mod, "Config", "s", model_prefix);
  if (cfg && named) {
    r = device_id < 0
            ? PyObject_CallMethod(cfg, "disable_gpu", nullptr)
            : PyObject_CallMethod(cfg, "enable_use_gpu", "ii", 100,
                                  device_id);
    if (!r) Py_CLEAR(cfg);
    Py_XDECREF(r);
  }
  if (cfg) pred = PyObject_CallMethod(mod, "create_predictor", "O", cfg);
  if (!pred) set_err_from_python();
  Py_XDECREF(cfg);
  Py_XDECREF(mod);
  PyGILState_Release(gil);
  if (!pred) return nullptr;
  PD_Predictor* h = new PD_Predictor();
  h->pred = pred;
  return h;
}

PD_Predictor* PD_NewPredictor(const char* model_prefix) {
  return new_predictor(model_prefix, false, 0);
}

PD_Predictor* PD_NewPredictorWithDevice(const char* model_prefix,
                                        int device_id) {
  return new_predictor(model_prefix, true, device_id);
}

// Run with one float32 input; copies the first output to the host.
int PD_PredictorRun(PD_Predictor* h, const float* input,
                    const int64_t* shape, int ndim, float** out_data,
                    int64_t* out_shape, int* out_ndim) {
  if (!h || !h->pred) {
    g_err = "null predictor";
    return 1;
  }
  int64_t total = 1;
  for (int i = 0; i < ndim; ++i) total *= shape[i];
  PyGILState_STATE gil = PyGILState_Ensure();
  int rc = 0;
  PyObject* np = PyImport_ImportModule("numpy");
  PyObject* mv = nullptr;
  PyObject* flat = nullptr;
  PyObject* pyshape = nullptr;
  PyObject* arr = nullptr;
  PyObject* out_list = nullptr;
  if (!np) {
    set_err_from_python();
    rc = 2;
  } else {
    mv = PyMemoryView_FromMemory(
        const_cast<char*>(reinterpret_cast<const char*>(input)),
        total * static_cast<int64_t>(sizeof(float)), PyBUF_READ);
    flat = mv ? PyObject_CallMethod(np, "frombuffer", "Os", mv, "float32")
              : nullptr;
    pyshape = PyTuple_New(ndim);
    for (int i = 0; pyshape && i < ndim; ++i)
      PyTuple_SetItem(pyshape, i, PyLong_FromLongLong(shape[i]));
    // a copy the caller's buffer does not back (torch refuses to wrap a
    // read-only array without a warning)
    PyObject* view = flat && pyshape
                         ? PyObject_CallMethod(flat, "reshape", "O", pyshape)
                         : nullptr;
    arr = view ? PyObject_CallMethod(view, "copy", nullptr) : nullptr;
    Py_XDECREF(view);
    // Predictor.run copies every output to the host (numpy)
    out_list = arr ? PyObject_CallMethod(h->pred, "run", "[O]", arr)
                   : nullptr;
    if (!out_list || !PyList_Check(out_list) ||
        PyList_Size(out_list) < 1) {
      if (PyErr_Occurred()) {
        set_err_from_python();
      } else {
        g_err = "the predictor returned no output";
      }
      rc = 3;
    }
  }
  if (rc == 0) {
    PyObject* out0 = PyList_GetItem(out_list, 0);  // borrowed
    PyObject* cont =
        PyObject_CallMethod(np, "ascontiguousarray", "Os", out0, "float32");
    PyObject* oshape =
        cont ? PyObject_GetAttrString(cont, "shape") : nullptr;
    PyObject* bytes = nullptr;
    if (!oshape) {
      set_err_from_python();
      rc = 4;
    } else if (PyTuple_Size(oshape) > 8) {
      g_err = "output rank > 8 unsupported by the C API";
      rc = 5;
    } else {
      bytes = PyObject_CallMethod(cont, "tobytes", nullptr);
      char* buf = nullptr;
      Py_ssize_t blen = 0;
      if (!bytes || PyBytes_AsStringAndSize(bytes, &buf, &blen) != 0) {
        set_err_from_python();
        rc = 4;
      } else {
        *out_data = static_cast<float*>(malloc(blen > 0 ? blen : 1));
        memcpy(*out_data, buf, blen);
        *out_ndim = static_cast<int>(PyTuple_Size(oshape));
        for (int i = 0; i < *out_ndim; ++i)
          out_shape[i] = PyLong_AsLongLong(PyTuple_GetItem(oshape, i));
      }
    }
    Py_XDECREF(bytes);
    Py_XDECREF(oshape);
    Py_XDECREF(cont);
  }
  Py_XDECREF(out_list);
  Py_XDECREF(arr);
  Py_XDECREF(pyshape);
  Py_XDECREF(flat);
  Py_XDECREF(mv);
  Py_XDECREF(np);
  PyGILState_Release(gil);
  return rc;
}

void PD_FreeBuffer(void* p) { free(p); }

void PD_DeletePredictor(PD_Predictor* h) {
  if (!h) return;
  if (h->pred && Py_IsInitialized()) {
    PyGILState_STATE gil = PyGILState_Ensure();
    Py_CLEAR(h->pred);
    PyGILState_Release(gil);
  }
  delete h;
}

}  // extern "C"

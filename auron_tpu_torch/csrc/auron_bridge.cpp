/*
 * auron_tpu_torch host-engine bridge: C ABI implementation.
 *
 * A copy of native/auron_bridge.cpp (the JAX package's bridge) that embeds
 * CPython and calls auron_tpu_torch.bridge.api instead of
 * auron_tpu.bridge.api; auron_call_native goes through call_native_c, on
 * the device init_c_abi chose (cuda, or the CPU when the host set
 * AURON_TORCH_DEVICE=cpu). Batches cross the boundary as Arrow IPC stream
 * bytes or Arrow C structs. The analog of the reference's JNI entry points
 * (auron-core JniBridge.java:49-80, auron/src/exec.rs:42-122): a JVM shim
 * binds these symbols instead of JNI natives.
 *
 * The library does not link libpython: a host executable links it (the
 * harness does), and a Python process that loads the library with ctypes
 * lends it its own interpreter, which the bridge then uses as it is
 * (native/auron_bridge.cpp:66-90 handles a running interpreter the same way).
 *
 * Threading: every entry point acquires the GIL via PyGILState_Ensure, so
 * the ABI is callable from any host thread (the engine's own pump threads
 * run under the embedded interpreter as usual). Returned buffers are
 * per-handle and stay valid until the next call on the same handle,
 * matching the header contract.
 */

#include "auron_bridge.h"

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdlib>
#include <deque>
#include <mutex>
#include <string>
#include <unordered_map>

static PyObject* g_api = nullptr; /* auron_tpu_torch.bridge.api module */
static std::once_flag g_init_once;

static thread_local std::string tl_error;

/* per-handle buffers: the header promises pointers stay valid until the
 * NEXT CALL ON THE SAME HANDLE, so they cannot live in thread-local
 * storage (another handle's call on the same thread must not clobber
 * them). Batch buffers are dropped at finalize; metrics buffers at the
 * next finalize on the handle or at on_exit. */
static std::mutex g_buf_mutex;
static std::unordered_map<int64_t, std::string> g_batch_buf;
static std::unordered_map<int64_t, std::string> g_metrics_buf;
/* handles are never reused, so metrics buffers need bounded retention:
 * oldest entries (beyond what any sane host still references) drop first */
static std::deque<int64_t> g_metrics_order;
static const size_t kMaxMetricsBufs = 64;
/* init failure message; immutable after call_once, readable by any thread */
static std::string g_init_error;

static void capture_python_error() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  tl_error = "python error";
  if (value != nullptr) {
    PyObject* s = PyObject_Str(value);
    if (s != nullptr) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c != nullptr) tl_error = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

static void init_interpreter() {
  bool was_initialized = Py_IsInitialized();
  if (!was_initialized) {
    Py_InitializeEx(0);
  }
  PyGILState_STATE st = PyGILState_LOCKED;
  if (was_initialized) st = PyGILState_Ensure();

  /* engine root: AURON_TORCH_ROOT (host-provided) else the working directory */
  const char* root = getenv("AURON_TORCH_ROOT");
  PyObject* sys_path = PySys_GetObject("path"); /* borrowed */
  PyObject* dir = nullptr;
  if (root != nullptr && root[0] != '\0') {
    dir = PyUnicode_DecodeFSDefault(root);
  } else {
    PyObject* os = PyImport_ImportModule("os");
    if (os != nullptr) {
      dir = PyObject_CallMethod(os, "getcwd", nullptr);
      Py_DECREF(os);
    }
  }
  if (dir == nullptr || sys_path == nullptr || PyList_Insert(sys_path, 0, dir) != 0) {
    capture_python_error();
    g_init_error = "cannot put the engine root on sys.path: " + tl_error;
  } else {
    g_api = PyImport_ImportModule("auron_tpu_torch.bridge.api");
    PyObject* res = nullptr;
    if (g_api != nullptr) res = PyObject_CallMethod(g_api, "init_c_abi", nullptr);
    if (res == nullptr) {
      capture_python_error();
      g_init_error = tl_error;
      Py_CLEAR(g_api);
    } else {
      Py_DECREF(res);
    }
  }
  Py_XDECREF(dir);

  if (was_initialized) {
    PyGILState_Release(st);
  } else {
    /* release the GIL held since Py_InitializeEx so any host thread can
       enter through PyGILState_Ensure */
    PyEval_SaveThread();
  }
}

static bool ensure_init() {
  std::call_once(g_init_once, init_interpreter);
  if (g_api == nullptr) {
    tl_error = g_init_error; /* visible from every calling thread */
    return false;
  }
  return true;
}

extern "C" {

int auron_init(void) { return ensure_init() ? 0 : -1; }

auron_task_handle auron_call_native(const uint8_t* task_def, size_t len) {
  if (!ensure_init()) return -1;
  PyGILState_STATE st = PyGILState_Ensure();
  auron_task_handle h = -1;
  PyObject* res = PyObject_CallMethod(
      g_api, "call_native_c", "y#", reinterpret_cast<const char*>(task_def),
      static_cast<Py_ssize_t>(len));
  if (res != nullptr) {
    h = PyLong_AsLongLong(res);
    Py_DECREF(res);
    if (PyErr_Occurred() != nullptr) {
      capture_python_error(); /* non-int / overflowing result */
      h = -1;
    } else if (h < 0) {
      tl_error = "call_native returned a negative handle";
    }
  } else {
    capture_python_error();
  }
  PyGILState_Release(st);
  return h;
}

int auron_next_batch(auron_task_handle h, const uint8_t** data, size_t* len) {
  if (!ensure_init()) return -1;
  PyGILState_STATE st = PyGILState_Ensure();
  int rc = -1;
  PyObject* res =
      PyObject_CallMethod(g_api, "next_batch_ipc", "L", (long long)h);
  if (res != nullptr) {
    if (res == Py_None) {
      rc = 0; /* end of stream */
    } else {
      char* buf = nullptr;
      Py_ssize_t n = 0;
      if (PyBytes_AsStringAndSize(res, &buf, &n) == 0) {
        std::lock_guard<std::mutex> lk(g_buf_mutex);
        std::string& slot = g_batch_buf[h];
        slot.assign(buf, static_cast<size_t>(n));
        *data = reinterpret_cast<const uint8_t*>(slot.data());
        *len = slot.size();
        rc = 1;
      } else {
        capture_python_error();
      }
    }
    Py_DECREF(res);
  } else {
    capture_python_error();
  }
  PyGILState_Release(st);
  return rc;
}

int auron_finalize_native(auron_task_handle h, const uint8_t** metrics_json,
                          size_t* len) {
  if (!ensure_init()) return -1;
  PyGILState_STATE st = PyGILState_Ensure();
  int rc = -1;
  PyObject* res =
      PyObject_CallMethod(g_api, "finalize_native_json", "L", (long long)h);
  if (res != nullptr) {
    char* buf = nullptr;
    Py_ssize_t n = 0;
    if (PyBytes_AsStringAndSize(res, &buf, &n) == 0) {
      std::lock_guard<std::mutex> lk(g_buf_mutex);
      g_batch_buf.erase(h); /* stream is over */
      if (g_metrics_buf.find(h) == g_metrics_buf.end()) {
        g_metrics_order.push_back(h);
        while (g_metrics_order.size() > kMaxMetricsBufs) {
          g_metrics_buf.erase(g_metrics_order.front());
          g_metrics_order.pop_front();
        }
      }
      std::string& slot = g_metrics_buf[h];
      slot.assign(buf, static_cast<size_t>(n));
      if (metrics_json != nullptr) {
        *metrics_json = reinterpret_cast<const uint8_t*>(slot.data());
        *len = slot.size();
      }
      rc = 0;
    } else {
      capture_python_error();
    }
    Py_DECREF(res);
  } else {
    capture_python_error();
  }
  PyGILState_Release(st);
  return rc;
}

void auron_on_exit(void) {
  if (!ensure_init()) return;
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* res = PyObject_CallMethod(g_api, "on_exit", nullptr);
  if (res == nullptr) {
    capture_python_error();
  } else {
    Py_DECREF(res);
  }
  PyGILState_Release(st);
  std::lock_guard<std::mutex> lk(g_buf_mutex);
  g_batch_buf.clear();
  g_metrics_buf.clear();
  g_metrics_order.clear();
}

int auron_put_resource(const char* key, const uint8_t* value, size_t len) {
  if (!ensure_init()) return -1;
  PyGILState_STATE st = PyGILState_Ensure();
  int rc = -1;
  PyObject* res = PyObject_CallMethod(
      g_api, "put_resource_ipc", "sy#", key,
      reinterpret_cast<const char*>(value), static_cast<Py_ssize_t>(len));
  if (res != nullptr) {
    rc = 0;
    Py_DECREF(res);
  } else {
    capture_python_error();
  }
  PyGILState_Release(st);
  return rc;
}

int auron_put_resource_bytes(const char* key, const uint8_t* value,
                             size_t len) {
  if (!ensure_init()) return -1;
  PyGILState_STATE st = PyGILState_Ensure();
  int rc = -1;
  PyObject* res = PyObject_CallMethod(
      g_api, "put_resource", "sy#", key,
      reinterpret_cast<const char*>(value), static_cast<Py_ssize_t>(len));
  if (res != nullptr) {
    rc = 0;
    Py_DECREF(res);
  } else {
    capture_python_error();
  }
  PyGILState_Release(st);
  return rc;
}

int auron_put_resource_arrow(const char* key, void* stream) {
  if (!ensure_init()) return -1;
  PyGILState_STATE st = PyGILState_Ensure();
  int rc = -1;
  /* the pointer crosses as an integer; bridge/api.py imports it through
   * columnar/arrow_c.py, which assumes ownership per the ArrowArrayStream
   * spec: no serialization, no copy */
  PyObject* res = PyObject_CallMethod(
      g_api, "put_resource_c_stream", "sK", key,
      static_cast<unsigned long long>(reinterpret_cast<uintptr_t>(stream)));
  if (res != nullptr) {
    rc = 0;
    Py_DECREF(res);
  } else {
    capture_python_error();
  }
  PyGILState_Release(st);
  return rc;
}

int auron_next_batch_arrow(auron_task_handle h, void* out_array,
                           void* out_schema) {
  if (!ensure_init()) return -1;
  PyGILState_STATE st = PyGILState_Ensure();
  int rc = -1;
  PyObject* res = PyObject_CallMethod(
      g_api, "next_batch_c", "LKK", (long long)h,
      static_cast<unsigned long long>(reinterpret_cast<uintptr_t>(out_array)),
      static_cast<unsigned long long>(
          reinterpret_cast<uintptr_t>(out_schema)));
  if (res != nullptr) {
    rc = static_cast<int>(PyLong_AsLong(res));
    Py_DECREF(res);
    if (PyErr_Occurred() != nullptr) {
      capture_python_error();
      rc = -1;
    }
  } else {
    capture_python_error();
  }
  PyGILState_Release(st);
  return rc;
}

int auron_put_resource_shuffle(const char* key, const uint8_t* manifest,
                               size_t len) {
  if (!ensure_init()) return -1;
  PyGILState_STATE st = PyGILState_Ensure();
  int rc = -1;
  PyObject* res = PyObject_CallMethod(
      g_api, "put_resource_shuffle", "sy#", key,
      reinterpret_cast<const char*>(manifest), static_cast<Py_ssize_t>(len));
  if (res != nullptr) {
    rc = 0;
    Py_DECREF(res);
  } else {
    capture_python_error();
  }
  PyGILState_Release(st);
  return rc;
}

int auron_remove_resource(const char* key) {
  if (!ensure_init()) return -1;
  PyGILState_STATE st = PyGILState_Ensure();
  int rc = -1;
  PyObject* res = PyObject_CallMethod(g_api, "remove_resource", "s", key);
  if (res != nullptr) {
    rc = 0;
    Py_DECREF(res);
  } else {
    capture_python_error();
  }
  PyGILState_Release(st);
  return rc;
}

/* conversion-response buffer: thread-local (like tl_error) so concurrent
 * conversions on different host threads never clobber each other; the
 * pointer stays valid until this thread's next auron_convert_plan call */
static thread_local std::string tl_convert_buf;

int auron_convert_plan(const uint8_t* host_plan_json, size_t len,
                       const uint8_t** response_json, size_t* response_len) {
  if (!ensure_init()) return -1;
  PyGILState_STATE st = PyGILState_Ensure();
  int rc = -1;
  PyObject* res = PyObject_CallMethod(
      g_api, "convert_plan_json", "y#",
      reinterpret_cast<const char*>(host_plan_json),
      static_cast<Py_ssize_t>(len));
  if (res != nullptr) {
    char* buf = nullptr;
    Py_ssize_t n = 0;
    if (PyBytes_AsStringAndSize(res, &buf, &n) == 0) {
      tl_convert_buf.assign(buf, static_cast<size_t>(n));
      *response_json = reinterpret_cast<const uint8_t*>(tl_convert_buf.data());
      *response_len = tl_convert_buf.size();
      rc = 0;
    } else {
      capture_python_error();
    }
    Py_DECREF(res);
  } else {
    capture_python_error();
  }
  PyGILState_Release(st);
  return rc;
}

int auron_register_udf_callback(auron_udf_eval_fn fn) {
  if (!ensure_init()) return -1;
  PyGILState_STATE st = PyGILState_Ensure();
  int rc = -1;
  /* hand the raw pointer to the engine (bridge/udf.py install_c_callback) */
  PyObject* res = PyObject_CallMethod(
      g_api, "install_udf_callback", "K",
      static_cast<unsigned long long>(reinterpret_cast<uintptr_t>(fn)));
  if (res != nullptr) {
    rc = 0;
    Py_DECREF(res);
  } else {
    capture_python_error();
  }
  PyGILState_Release(st);
  return rc;
}

const char* auron_last_error(void) { return tl_error.c_str(); }

} /* extern "C" */

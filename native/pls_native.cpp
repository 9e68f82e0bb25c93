// pls_tpu._native — native runtime components (C++17, CPython C API).
//
// The reference's runtime layer (CSV data-loader, RNG pipeline) is C++
// (/root/reference/src/pls.cpp:23-67, std::mt19937+std::shuffle in
// /root/reference/src/main.cpp:38 + pls.cpp:218-227).  This extension
// provides the JAX build's native equivalents:
//
//   read_matrix(filename, sep=",") -> np.float64[rows, cols]
//       Headerless-CSV parser with the reference's validation semantics
//       (ragged rows raise ValueError with the reference's exact message);
//       ~10x faster than Python line splitting on large matrices.
//
//   gcc_shuffle_trace(seed, n, reps) -> np.int64[reps, n]
//       Replays the reference CLI's LSO partition stream by literally
//       calling libstdc++'s std::shuffle on a live std::mt19937 — the
//       ground truth the pure-Python emulator (pls_tpu/utils/gcc_rng.py)
//       is validated against.
//
//   mt19937_raw(seed, n) -> np.uint32[n]
//       Raw generator draws, for emulator validation.
//
// This is new code, not copied from the reference; reference lines are
// cited for behavioral parity only.

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <algorithm>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <fstream>
#include <mutex>
#include <numeric>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

// Parse one CSV line into `out`; returns column count, or -1 with `err`
// set (reference-parity diagnostics, /root/reference/src/pls.cpp:23-67).
long parse_line(const std::string &line_in, char sc, long row_index,
                const char *filename, std::vector<double> &out,
                std::string &err) {
    std::string line = line_in;
    if (!line.empty() && line.back() == '\r') line.pop_back();
    long cols = 0;
    const char *p = line.c_str();
    const char *end = p + line.size();
    while (true) {
        char *next = nullptr;
        double v = std::strtod(p, &next);
        if (next == p) {
            err = "non-numeric field in " + std::string(filename) + " row " +
                  std::to_string(row_index);
            return -1;
        }
        out.push_back(v);
        cols++;
        p = next;
        while (p < end && (*p == ' ' || *p == '\t')) p++;
        if (p >= end) break;
        if (*p != sc) {
            err = std::string("unexpected character '") + *p + "' in " +
                  filename + " row " + std::to_string(row_index);
            return -1;
        }
        p++;
    }
    return cols;
}

// ---------------------------------------------------------------- read_matrix
PyObject *read_matrix(PyObject *, PyObject *args) {
    const char *filename;
    const char *sep = ",";
    if (!PyArg_ParseTuple(args, "s|s", &filename, &sep)) return nullptr;
    if (sep[0] == '\0' || sep[1] != '\0') {
        PyErr_SetString(PyExc_ValueError, "separator must be a single character");
        return nullptr;
    }
    const char sc = sep[0];

    std::ifstream in(filename);
    if (!in.is_open()) {
        PyErr_Format(PyExc_OSError, "cannot open %s", filename);
        return nullptr;
    }

    std::vector<double> data;
    std::string line;
    npy_intp nrows = 0;
    npy_intp ncols = -1;
    while (std::getline(in, line)) {
        std::string err;
        npy_intp cols = parse_line(line, sc, (long)nrows, filename, data, err);
        if (cols < 0) {
            // mirrors the reference's stod failure on non-numeric input
            // (pls.cpp:53, documented at pls.h:92)
            PyErr_SetString(PyExc_ValueError, err.c_str());
            return nullptr;
        }
        if (ncols >= 0 && cols != ncols) {
            // the reference's exact diagnostic (pls.cpp:56)
            PyErr_Format(
                PyExc_ValueError,
                "Error: row %ld has %ld columns, but previous row(s) have %ld "
                "columns.",
                (long)nrows, (long)cols, (long)ncols);
            return nullptr;
        }
        if (ncols < 0) ncols = cols;
        nrows++;
    }
    if (nrows == 0) {
        PyErr_Format(PyExc_ValueError, "%s is empty", filename);
        return nullptr;
    }

    npy_intp dims[2] = {nrows, ncols};
    PyObject *arr = PyArray_SimpleNew(2, dims, NPY_DOUBLE);
    if (!arr) return nullptr;
    std::copy(data.begin(), data.end(),
              static_cast<double *>(PyArray_DATA((PyArrayObject *)arr)));
    return arr;
}

// ---------------------------------------------------------------- ChunkReader
// Threaded out-of-core CSV chunk iterator: a background std::thread parses
// the NEXT chunk_rows rows while the consumer (Python / the device input
// pipeline) works on the current chunk — classic double-buffered data
// loading, the native runtime component the streaming fit
// (pls_tpu/models/streaming.py) consumes for designs too large for memory.
// The reference's data-loader is C++ and whole-file
// (/root/reference/src/pls.cpp:37-67); this is its streaming equivalent
// with the same validation diagnostics.

struct ChunkState {
    std::ifstream in;
    std::mutex mu;
    std::condition_variable cv;
    std::thread worker;
    std::vector<double> ready;
    long ready_rows = 0;
    bool ready_valid = false;
    bool done = false;   // worker exhausted the file or hit an error
    bool stop = false;   // consumer is shutting down
    std::string error;   // nonempty => raise after queued chunks drain
    long chunk_rows = 0;
    long ncols = -1;
    long row_index = 0;  // global row counter (diagnostics)
    char sep = ',';
    std::string filename;
};

void chunk_worker(ChunkState *st) {
    for (;;) {
        std::vector<double> buf;
        long rows = 0;
        std::string err;
        std::string line;
        while (rows < st->chunk_rows && std::getline(st->in, line)) {
            long cols = parse_line(line, st->sep, st->row_index,
                                   st->filename.c_str(), buf, err);
            if (cols < 0) break;
            if (st->ncols >= 0 && cols != st->ncols) {
                err = "Error: row " + std::to_string(st->row_index) + " has " +
                      std::to_string(cols) + " columns, but previous row(s) " +
                      "have " + std::to_string(st->ncols) + " columns.";
                break;
            }
            if (st->ncols < 0) st->ncols = cols;
            st->row_index++;
            rows++;
        }
        bool failed = !err.empty();
        bool eof = !failed && rows < st->chunk_rows;
        if (failed) { buf.clear(); rows = 0; }  // drop the partial chunk
        if (!failed && rows == 0 && st->row_index == 0)
            err = st->filename + " is empty", failed = true;

        std::unique_lock<std::mutex> lk(st->mu);
        if (rows > 0) {
            st->cv.wait(lk, [st] { return !st->ready_valid || st->stop; });
            if (st->stop) return;
            st->ready = std::move(buf);
            st->ready_rows = rows;
            st->ready_valid = true;
        }
        if (failed) st->error = err;
        if (failed || eof) {
            st->done = true;
            st->cv.notify_all();
            return;
        }
        st->cv.notify_all();
        if (st->stop) return;
    }
}

struct ChunkReaderObj {
    PyObject_HEAD
    ChunkState *st;
};

PyObject *chunkreader_iternext(PyObject *self) {
    ChunkState *st = reinterpret_cast<ChunkReaderObj *>(self)->st;
    std::vector<double> buf;
    long rows = 0;
    bool have = false;
    std::string err;
    Py_BEGIN_ALLOW_THREADS {
        std::unique_lock<std::mutex> lk(st->mu);
        st->cv.wait(lk, [st] { return st->ready_valid || st->done; });
        if (st->ready_valid) {
            buf = std::move(st->ready);
            rows = st->ready_rows;
            st->ready_valid = false;
            have = true;
            st->cv.notify_all();
        } else {
            err = st->error;
        }
    }
    Py_END_ALLOW_THREADS
    if (have) {
        npy_intp dims[2] = {rows, st->ncols};
        PyObject *arr = PyArray_SimpleNew(2, dims, NPY_DOUBLE);
        if (!arr) return nullptr;
        std::copy(buf.begin(), buf.end(),
                  static_cast<double *>(PyArray_DATA((PyArrayObject *)arr)));
        return arr;
    }
    if (!err.empty()) {
        PyErr_SetString(PyExc_ValueError, err.c_str());
        return nullptr;
    }
    return nullptr;  // no error set => StopIteration
}

void chunkreader_dealloc(PyObject *self) {
    ChunkState *st = reinterpret_cast<ChunkReaderObj *>(self)->st;
    if (st) {
        {
            std::unique_lock<std::mutex> lk(st->mu);
            st->stop = true;
            st->ready_valid = false;  // unblock a worker waiting to publish
            st->cv.notify_all();
        }
        if (st->worker.joinable()) st->worker.join();
        delete st;
    }
    Py_TYPE(self)->tp_free(self);
}

PyTypeObject ChunkReaderType = []() {
    PyTypeObject t = {PyVarObject_HEAD_INIT(nullptr, 0) "pls_tpu._native.ChunkReader"};
    t.tp_basicsize = sizeof(ChunkReaderObj);
    t.tp_dealloc = chunkreader_dealloc;
    t.tp_flags = Py_TPFLAGS_DEFAULT;
    t.tp_doc = PyDoc_STR("Threaded CSV chunk iterator (create via chunk_reader())");
    t.tp_iter = PyObject_SelfIter;
    t.tp_iternext = chunkreader_iternext;
    return t;
}();

PyObject *chunk_reader(PyObject *, PyObject *args) {
    const char *filename;
    long chunk_rows;
    const char *sep = ",";
    if (!PyArg_ParseTuple(args, "sl|s", &filename, &chunk_rows, &sep))
        return nullptr;
    if (chunk_rows <= 0) {
        PyErr_SetString(PyExc_ValueError, "chunk_rows must be positive");
        return nullptr;
    }
    if (sep[0] == '\0' || sep[1] != '\0') {
        PyErr_SetString(PyExc_ValueError, "separator must be a single character");
        return nullptr;
    }
    auto *st = new ChunkState();
    st->filename = filename;
    st->chunk_rows = chunk_rows;
    st->sep = sep[0];
    st->in.open(filename);
    if (!st->in.is_open()) {
        delete st;
        PyErr_Format(PyExc_OSError, "cannot open %s", filename);
        return nullptr;
    }
    ChunkReaderObj *obj = PyObject_New(ChunkReaderObj, &ChunkReaderType);
    if (!obj) {
        delete st;
        return nullptr;
    }
    st->worker = std::thread(chunk_worker, st);
    obj->st = st;
    return reinterpret_cast<PyObject *>(obj);
}

// --------------------------------------------------------- gcc_shuffle_trace
PyObject *gcc_shuffle_trace(PyObject *, PyObject *args) {
    unsigned long seed;
    long n, reps;
    if (!PyArg_ParseTuple(args, "kll", &seed, &n, &reps)) return nullptr;
    if (n <= 0 || reps <= 0) {
        PyErr_SetString(PyExc_ValueError, "n and reps must be positive");
        return nullptr;
    }
    std::mt19937 rng(static_cast<std::mt19937::result_type>(seed));
    std::vector<int64_t> v(n);
    std::iota(v.begin(), v.end(), 0);

    npy_intp dims[2] = {reps, n};
    PyObject *arr = PyArray_SimpleNew(2, dims, NPY_INT64);
    if (!arr) return nullptr;
    auto *out = static_cast<int64_t *>(PyArray_DATA((PyArrayObject *)arr));
    for (long r = 0; r < reps; r++) {
        std::shuffle(v.begin(), v.end(), rng);  // real libstdc++ semantics
        std::copy(v.begin(), v.end(), out + r * n);
    }
    return arr;
}

// ---------------------------------------------------------------- mt19937_raw
PyObject *mt19937_raw(PyObject *, PyObject *args) {
    unsigned long seed;
    long n;
    if (!PyArg_ParseTuple(args, "kl", &seed, &n)) return nullptr;
    std::mt19937 rng(static_cast<std::mt19937::result_type>(seed));
    npy_intp dims[1] = {n};
    PyObject *arr = PyArray_SimpleNew(1, dims, NPY_UINT32);
    if (!arr) return nullptr;
    auto *out = static_cast<uint32_t *>(PyArray_DATA((PyArrayObject *)arr));
    for (long i = 0; i < n; i++) out[i] = static_cast<uint32_t>(rng());
    return arr;
}

PyMethodDef methods[] = {
    {"read_matrix", read_matrix, METH_VARARGS,
     "read_matrix(filename, sep=',') -> float64 ndarray"},
    {"chunk_reader", chunk_reader, METH_VARARGS,
     "chunk_reader(filename, chunk_rows, sep=',') -> iterator of float64 "
     "(rows<=chunk_rows, cols) chunks with background-thread prefetch"},
    {"gcc_shuffle_trace", gcc_shuffle_trace, METH_VARARGS,
     "gcc_shuffle_trace(seed, n, reps) -> int64[reps, n]"},
    {"mt19937_raw", mt19937_raw, METH_VARARGS,
     "mt19937_raw(seed, n) -> uint32[n]"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "pls_tpu._native",
    "Native runtime components for pls-tpu", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__native(void) {
    import_array();
    if (PyType_Ready(&ChunkReaderType) < 0) return nullptr;
    return PyModule_Create(&moduledef);
}

"""The native host library: the port's copy of ``rectpu/io/native``.

C++ for the host's hot paths, bound with ctypes: FarmHash bucket hashing
(``farmhash.cc``), the serving request's JSON-to-columns parse
(``json_columns.cc``) and the CSV parse and feature encode
(``csv_loader.cc``, through ``csv_bridge``). The library is built with g++
at first use (``build.py``) and loaded once a process. Unlike rectpu, whose
entry points fall back to Python when its library is unbuilt or fails to
load, a failed build or load raises here: nothing hides the native path.
The Python versions stay where their callers ask for them
(``use_native=False``), as the plain versions they are held against.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

_LIB = None
_LOCK = threading.Lock()

_SIGNATURES = {
    "rectpu_fingerprint64": ([ctypes.c_char_p, ctypes.c_size_t], ctypes.c_uint64),
    "rectpu_hash_strings": (
        [ctypes.POINTER(ctypes.c_char_p), ctypes.c_size_t, ctypes.c_int64,
         ctypes.POINTER(ctypes.c_int32)], None),
    "rectpu_hash_ints": (
        [ctypes.POINTER(ctypes.c_int64), ctypes.c_size_t, ctypes.c_int64,
         ctypes.POINTER(ctypes.c_int32)], None),
    "rectpu_hash_strings_fixed": (
        [ctypes.POINTER(ctypes.c_char), ctypes.c_int64, ctypes.c_size_t, ctypes.c_int64,
         ctypes.POINTER(ctypes.c_int32)], None),
    "rectpu_json_parse": ([ctypes.c_char_p, ctypes.c_int64], ctypes.c_void_p),
    "rectpu_json_error": ([ctypes.c_void_p], ctypes.c_char_p),
    "rectpu_json_rows": ([ctypes.c_void_p], ctypes.c_int64),
    "rectpu_json_cols": ([ctypes.c_void_p], ctypes.c_int64),
    "rectpu_json_col_info": (
        [ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_char_p),
         ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
         ctypes.POINTER(ctypes.c_int64)], ctypes.c_int),
    "rectpu_json_col_copy": ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p], ctypes.c_int),
    "rectpu_json_free": ([ctypes.c_void_p], None),
    "rectpu_csv_open": ([ctypes.c_char_p, ctypes.c_int], ctypes.c_void_p),
    "rectpu_csv_open_mem": ([ctypes.c_char_p, ctypes.c_int64, ctypes.c_int], ctypes.c_void_p),
    "rectpu_csv_rows": ([ctypes.c_void_p], ctypes.c_int64),
    "rectpu_csv_error": ([ctypes.c_void_p], ctypes.c_char_p),
    "rectpu_csv_encode": (
        [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
         ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)], ctypes.c_int),
    "rectpu_csv_free": ([ctypes.c_void_p], None),
}


def load() -> ctypes.CDLL:
    """The loaded library, built on first use. Raises if g++ fails or the
    library does not load."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            from rectpu_torch.io.native.build import build

            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for fn, (argtypes, restype) in _SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LIB = lib
        return _LIB


def fingerprint64(s: bytes) -> int:
    return int(load().rectpu_fingerprint64(s, len(s)))


def hash_ints(values: np.ndarray, num_buckets: int) -> np.ndarray:
    """Hash int64 values (stringified in decimal in C++) into buckets."""
    lib = load()
    values = np.ascontiguousarray(values, dtype=np.int64)
    out = np.empty(values.shape, dtype=np.int32)
    lib.rectpu_hash_ints(values.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), values.size,
                         num_buckets, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def hash_strings(values, num_buckets: int) -> np.ndarray:
    """Hash each element's bytes (bytes as they are, anything else as its
    str's UTF-8): one C call over an array of pointers."""
    lib = load()
    encoded = [bytes(v) if isinstance(v, (bytes, np.bytes_)) else str(v).encode("utf-8")
               for v in values]
    arr = (ctypes.c_char_p * len(encoded))(*encoded)
    out = np.empty(len(encoded), dtype=np.int32)
    lib.rectpu_hash_strings(arr, len(encoded), num_buckets,
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def hash_strings_array(values: np.ndarray, num_buckets: int) -> np.ndarray:
    """Hash an S-dtype (NUL-padded bytes) array in one fixed-stride C call
    over its buffer; each element's bytes up to its padding are hashed."""
    lib = load()
    values = np.ascontiguousarray(values)
    if values.dtype.kind != "S":
        raise TypeError(f"hash_strings_array takes an S-dtype array, got {values.dtype}")
    out = np.empty(values.size, dtype=np.int32)
    lib.rectpu_hash_strings_fixed(values.ctypes.data_as(ctypes.POINTER(ctypes.c_char)),
                                  values.dtype.itemsize, values.size, num_buckets,
                                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out.reshape(values.shape)


def parse_json_instances(body: bytes):
    """The serving request's fast path: ``{"instances": [{...}, ...]}`` bytes
    straight into columns (int64 and float64 vectors, NUL-padded S-dtype byte
    columns), with no Python object a value.

    Returns ``(columns, n_rows)``, or ``None`` for a body outside the fast
    shape (nested values, mixed string and number columns, inconsistent
    keys, null, lone surrogates or NULs, malformed JSON): the caller then
    parses it with ``json.loads``, which defines the behaviour."""
    lib = load()
    h = lib.rectpu_json_parse(body, len(body))
    try:
        if lib.rectpu_json_error(h) is not None:
            return None
        rows = int(lib.rectpu_json_rows(h))
        columns = {}
        for i in range(int(lib.rectpu_json_cols(h))):
            name, name_len = ctypes.c_char_p(), ctypes.c_int64()
            kind, stride = ctypes.c_int64(), ctypes.c_int64()
            if lib.rectpu_json_col_info(h, i, ctypes.byref(name), ctypes.byref(name_len),
                                        ctypes.byref(kind), ctypes.byref(stride)) != 0:
                return None
            if kind.value == 0:
                out = np.empty(rows, dtype=np.int64)
            elif kind.value == 1:
                out = np.empty(rows, dtype=np.float64)
            else:
                # zeroed here: the C side writes each value's bytes, not the padding
                out = np.zeros(rows, dtype=f"S{stride.value}")
            if rows and lib.rectpu_json_col_copy(h, i, out.ctypes.data_as(ctypes.c_void_p)):
                return None
            columns[name.value.decode("utf-8")] = out
        return columns, rows
    finally:
        lib.rectpu_json_free(h)

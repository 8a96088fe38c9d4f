"""ctypes binding of the native host runtime (``native/src/lmpc_runtime.cpp``).

Port of ``racing_lmpc_tpu/native/__init__.py``: the same C ABI, the same
ctypes signatures and the same wrappers (``load_table``, ``KdTree2D``,
``NativeSafeSet``, ``CycleProfiler``, ``Bus``).  The source is the port's
own copy of the reference's, byte for byte (a test holds the two equal).

The library is compiled on first use with ``g++`` and the reference's flags
into ``build/`` at the repository root (never into the package); its file
name carries a hash of the source, the compiler and the flags, so an edited
source is rebuilt.  Unlike the reference there is no quiet fallback: a
wrapper raises, with the compiler's log, when the library cannot be built;
a consumer takes its numpy path only when its caller asks for it
(``use_native=False``).  The build and the load run under a lock, since the
bus calls back into Python from a thread of its own.
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "lmpc_runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
             "-fvisibility=hidden")

_lock = threading.Lock()
_lib = None
_lib_file: Path | None = None
_build_error: str | None = None

_SIGS = {
    "lr_table_load": (ct.c_void_p, [ct.c_char_p]),
    "lr_table_rows": (ct.c_int64, [ct.c_void_p]),
    "lr_table_cols": (ct.c_int64, [ct.c_void_p]),
    "lr_table_copy": (None, [ct.c_void_p, ct.POINTER(ct.c_double)]),
    "lr_table_free": (None, [ct.c_void_p]),
    "lr_kdtree_build": (ct.c_void_p, [ct.POINTER(ct.c_float), ct.c_int64]),
    "lr_kdtree_knn": (None, [ct.c_void_p, ct.POINTER(ct.c_float), ct.c_int64,
                             ct.c_int32, ct.POINTER(ct.c_int32),
                             ct.POINTER(ct.c_float)]),
    "lr_kdtree_free": (None, [ct.c_void_p]),
    "lr_ss_new": (ct.c_void_p, [ct.c_int64, ct.c_int64]),
    "lr_ss_free": (None, [ct.c_void_p]),
    "lr_ss_add_lap": (None, [ct.c_void_p, ct.POINTER(ct.c_float), ct.c_int64,
                             ct.c_double]),
    "lr_ss_num_laps": (ct.c_int64, [ct.c_void_p]),
    "lr_ss_query": (ct.c_int64, [ct.c_void_p, ct.POINTER(ct.c_float), ct.c_int32,
                                 ct.c_int32, ct.POINTER(ct.c_float),
                                 ct.POINTER(ct.c_float)]),
    "lr_prof_new": (ct.c_void_p, [ct.c_int64]),
    "lr_prof_free": (None, [ct.c_void_p]),
    "lr_prof_add": (None, [ct.c_void_p, ct.c_double]),
    "lr_prof_stats": (None, [ct.c_void_p, ct.POINTER(ct.c_double)]),
    "lr_bus_new": (ct.c_void_p, []),
    "lr_bus_free": (None, [ct.c_void_p]),
    "lr_bus_subscribe": (None, [ct.c_void_p, ct.c_char_p, ct.c_void_p, ct.c_void_p]),
    "lr_bus_publish": (None, [ct.c_void_p, ct.c_char_p, ct.POINTER(ct.c_uint8),
                              ct.c_int64]),
    "lr_bus_flush": (None, [ct.c_void_p, ct.c_double]),
    "lr_bus_delivered": (ct.c_int64, [ct.c_void_p]),
}


def library_path() -> Path:
    """The shared library of the current source, compiler and flags."""
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join((CXX,) + CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"liblmpc_runtime_{digest}.so"


def _build(lib: Path) -> str | None:
    """Compile ``lib`` if it is missing.  Returns the error (with the
    compiler's log) or None."""
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.SubprocessError) as e:
        return f"{CXX} could not run: {e}"
    if proc.returncode != 0:
        return f"{CXX} exited {proc.returncode}:\n{proc.stderr[-4000:]}"
    os.replace(tmp, lib)
    return None


def _load() -> None:
    global _lib, _lib_file, _build_error
    path = library_path()
    with _lock:
        if path == _lib_file:
            return
        _lib, _lib_file, _build_error = None, path, _build(path)
        if _build_error is not None:
            return
        lib = ct.CDLL(str(path))
        for name, (res, args) in _SIGS.items():
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib


def available() -> bool:
    """Whether the library is built and loaded (building it if needed)."""
    _load()
    return _lib is not None


def build_error() -> str | None:
    """The build's error with the compiler's log, or None."""
    _load()
    return _build_error


def library():
    """The loaded library; raises with the build's error when it cannot be
    built."""
    _load()
    if _lib is None:
        raise RuntimeError(f"native runtime unavailable: {_build_error}")
    return _lib


def _np_f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ct.POINTER(ctype))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def load_table(path: str | os.PathLike) -> np.ndarray:
    """Native whitespace-table loader (tracks / recorded laps)."""
    lib = library()
    h = lib.lr_table_load(str(path).encode())
    if not h:
        raise OSError(f"failed to parse table: {path}")
    try:
        out = np.empty((lib.lr_table_rows(h), lib.lr_table_cols(h)), dtype=np.float64)
        lib.lr_table_copy(h, _ptr(out, ct.c_double))
        return out
    finally:
        lib.lr_table_free(h)


class KdTree2D:
    """Static 2-D KD-tree (CGAL replacement, trajectory_kd_tree.hpp:69-121)."""

    def __init__(self, xy: np.ndarray):
        self._lib = library()
        xy = _np_f32(xy).reshape(-1, 2)
        self.n = xy.shape[0]
        self._h = self._lib.lr_kdtree_build(_ptr(xy, ct.c_float), self.n)

    def knn(self, q_xy: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        """(nq, 2) queries -> ((nq, k) indices, (nq, k) squared distances),
        nearest first; -1 and inf past the tree's size."""
        q = _np_f32(q_xy).reshape(-1, 2)
        nq = q.shape[0]
        idx = np.empty((nq, k), dtype=np.int32)
        d2 = np.empty((nq, k), dtype=np.float32)
        self._lib.lr_kdtree_knn(self._h, _ptr(q, ct.c_float), nq, k,
                                _ptr(idx, ct.c_int32), _ptr(d2, ct.c_float))
        return idx, d2

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.lr_kdtree_free(self._h)


class NativeSafeSet:
    """Native padded-lap store + threaded k-NN query (safe_set.cpp:33-191)."""

    def __init__(self, max_laps: int, nx: int):
        self._lib = library()
        self.nx = nx
        self._h = self._lib.lr_ss_new(max_laps, nx)

    def add_lap(self, x: np.ndarray, total_length: float):
        x = _np_f32(x)
        self._lib.lr_ss_add_lap(self._h, _ptr(x, ct.c_float), x.shape[0],
                                float(total_length))

    @property
    def num_laps(self) -> int:
        return int(self._lib.lr_ss_num_laps(self._h))

    def query(self, q_xy: np.ndarray, max_total: int, max_per_lap: int
              ) -> tuple[np.ndarray, np.ndarray]:
        """Per-lap k nearest in the (s, t) plane, newest lap first, each lap
        ordered by (squared distance, index), truncated to ``max_total``."""
        q = _np_f32(q_xy).reshape(2)
        out_x = np.empty((max_total, self.nx), dtype=np.float32)
        out_J = np.empty((max_total,), dtype=np.float32)
        num = self._lib.lr_ss_query(self._h, _ptr(q, ct.c_float), max_total,
                                    max_per_lap, _ptr(out_x, ct.c_float),
                                    _ptr(out_J, ct.c_float))
        return out_x[:num], out_J[:num]

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.lr_ss_free(self._h)


class CycleProfiler:
    """Windowed min/mean/max cycle statistics (cycle_profiler.hpp:69-136)."""

    def __init__(self, capacity: int):
        self._lib = library()
        self._h = self._lib.lr_prof_new(capacity)

    def add(self, value: float):
        self._lib.lr_prof_add(self._h, float(value))

    def stats(self) -> dict:
        out = np.zeros(4, dtype=np.float64)
        self._lib.lr_prof_stats(self._h, _ptr(out, ct.c_double))
        return {"min": out[0], "mean": out[1], "max": out[2], "count": int(out[3])}

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.lr_prof_free(self._h)


_BUS_CB = ct.CFUNCTYPE(None, ct.c_char_p, ct.POINTER(ct.c_uint8), ct.c_int64,
                       ct.c_void_p)


class Bus:
    """Intra-process pub/sub with a serialized dispatch thread — the
    DDS/rclcpp-executor replacement wiring simulator to controller
    (racing_mpc_node.cpp:92-118).

    Subscribers run on the bus's dispatch thread, which C++ created: Python
    sees it as a thread of its own, with every thread-local default (torch's
    grad mode, CUDA device and stream) fresh.  ``close`` joins that thread,
    so it raises when called from a subscriber instead of deadlocking."""

    def __init__(self):
        self._lib = library()
        self._h = self._lib.lr_bus_new()
        self._keep = []  # keep callback trampolines alive
        self._dispatch_ident = None

    def subscribe(self, topic: str, fn):
        """fn(topic: str, payload: bytes) — called on the dispatch thread."""
        def tramp(t, data, length, _user):
            self._dispatch_ident = threading.get_ident()
            fn(t.decode(), ct.string_at(data, length))
        cb = _BUS_CB(tramp)
        self._keep.append(cb)
        self._lib.lr_bus_subscribe(self._h, topic.encode(), ct.cast(cb, ct.c_void_p), None)

    def publish(self, topic: str, payload: bytes):
        buf = (ct.c_uint8 * len(payload)).from_buffer_copy(payload)
        self._lib.lr_bus_publish(self._h, topic.encode(), buf, len(payload))

    def flush(self, timeout_s: float = 5.0):
        """Block until every message published so far is delivered."""
        self._lib.lr_bus_flush(self._h, timeout_s)

    @property
    def delivered(self) -> int:
        return int(self._lib.lr_bus_delivered(self._h))

    def close(self):
        """Deliver what is queued, stop and join the dispatch thread."""
        if not self._h:
            return
        if threading.get_ident() == self._dispatch_ident:
            raise RuntimeError("Bus.close() called from the bus's dispatch "
                               "thread would join that thread from itself")
        self._lib.lr_bus_free(self._h)
        self._h = None

    def __del__(self):
        if getattr(self, "_h", None) and threading.get_ident() != self._dispatch_ident:
            self.close()

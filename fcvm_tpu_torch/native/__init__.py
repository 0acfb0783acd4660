"""ctypes bindings for the native mesh-ingest/graph/formatting library.

The port's copy of :mod:`fcvm_tpu.native`.  :func:`build` compiles
``fcvm_native.cpp`` (beside this file) with ``g++`` into
``fcvm_tpu_torch/_build/libfcvm_native.so`` at first use; every entry point
has a pure-numpy version beside it, which runs when the library cannot be
built and which the tests hold the native one against.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).parent / "fcvm_native.cpp"
BUILD_DIR = Path(__file__).parent.parent / "_build"
_LIB_PATH = BUILD_DIR / "libfcvm_native.so"
_lib = None


class _FcvmMesh(ctypes.Structure):
    _fields_ = [
        ("nn", ctypes.c_int64),
        ("ne", ctypes.c_int64),
        ("coords", ctypes.POINTER(ctypes.c_double)),
        ("elnodes", ctypes.POINTER(ctypes.c_int64)),
    ]


def build(force: bool = False) -> bool:
    """Compile the shared library (when missing or older than its source);
    returns True on success.  The library is written under a per-process
    name and renamed into place, so concurrent first uses do not race."""
    if (_LIB_PATH.exists() and not force
            and _LIB_PATH.stat().st_mtime >= _SRC.stat().st_mtime):
        return True
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".libfcvm_native.{os.getpid()}.so"
    try:
        subprocess.run([cxx, "-O3", "-fPIC", "-std=c++17", "-Wall", "-shared",
                        "-o", str(tmp), str(_SRC)], check=True, capture_output=True)
        os.replace(tmp, _LIB_PATH)
    except (subprocess.CalledProcessError, OSError):
        tmp.unlink(missing_ok=True)
        return False
    return True


def load():
    """Load (building if needed); returns the ctypes lib or None."""
    global _lib
    if _lib is not None:
        return _lib
    if not build():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.fcvm_read_gmsh.restype = ctypes.POINTER(_FcvmMesh)
    lib.fcvm_read_gmsh.argtypes = [ctypes.c_char_p]
    lib.fcvm_read_unv.restype = ctypes.POINTER(_FcvmMesh)
    lib.fcvm_read_unv.argtypes = [ctypes.c_char_p]
    lib.fcvm_mesh_free.argtypes = [ctypes.POINTER(_FcvmMesh)]
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.fcvm_rcm_order.restype = ctypes.c_int
    lib.fcvm_rcm_order.argtypes = [ctypes.c_int64, ctypes.c_int64, i64, i64]
    lib.fcvm_node_element_counts.restype = ctypes.c_int
    lib.fcvm_node_element_counts.argtypes = [ctypes.c_int64, ctypes.c_int64, i64, i64]
    lib.fcvm_bandwidth.restype = ctypes.c_int64
    lib.fcvm_bandwidth.argtypes = [ctypes.c_int64, ctypes.c_int64, i64]
    lib.fcvm_format_doubles.restype = ctypes.c_void_p
    lib.fcvm_format_doubles.argtypes = [
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.fcvm_format_cells.restype = ctypes.c_void_p
    lib.fcvm_format_cells.argtypes = [i64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    lib.fcvm_free_str.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return load() is not None


def _extract(mesh_ptr):
    m = mesh_ptr.contents
    coords = np.ctypeslib.as_array(m.coords, shape=(m.nn, 3)).copy()
    elnodes = np.ctypeslib.as_array(m.elnodes, shape=(m.ne, 10)).copy()
    load().fcvm_mesh_free(mesh_ptr)
    return coords, elnodes


def read_gmsh_native(path: str):
    """Returns (coords, elnodes) or None if unavailable/failed."""
    lib = load()
    if lib is None:
        return None
    ptr = lib.fcvm_read_gmsh(os.fsencode(str(path)))
    if not ptr:
        return None
    return _extract(ptr)


def read_unv_native(path: str):
    lib = load()
    if lib is None:
        return None
    ptr = lib.fcvm_read_unv(os.fsencode(str(path)))
    if not ptr:
        return None
    return _extract(ptr)


def rcm_order(elnodes: np.ndarray, nn: int) -> np.ndarray:
    """Reverse Cuthill-McKee permutation: perm[new] = old.

    Native when available, else the Python BFS of :func:`_rcm_python`.
    """
    elnodes = np.ascontiguousarray(elnodes, dtype=np.int64)
    lib = load()
    if lib is not None:
        perm = np.empty(nn, dtype=np.int64)
        lib.fcvm_rcm_order(nn, len(elnodes), elnodes, perm)
        return perm
    return _rcm_python(elnodes, nn)


def bandwidth(elnodes: np.ndarray, nn: int) -> int:
    elnodes = np.ascontiguousarray(elnodes, dtype=np.int64)
    lib = load()
    if lib is not None:
        return int(lib.fcvm_bandwidth(nn, len(elnodes), elnodes))
    d = np.abs(elnodes[:, :, None] - elnodes[:, None, :])
    return int(d.max())


def _rcm_python(elnodes: np.ndarray, nn: int) -> np.ndarray:
    import collections

    nbr = [set() for _ in range(nn)]
    for row in elnodes:
        for i in row:
            nbr[i].update(row)
    for i in range(nn):
        nbr[i].discard(i)
    degree = np.array([len(s) for s in nbr])
    visited = np.zeros(nn, dtype=bool)
    order = []
    while len(order) < nn:
        remaining = np.where(~visited)[0]
        seed = remaining[np.argmin(degree[remaining])]
        q = collections.deque([seed])
        visited[seed] = True
        while q:
            n = q.popleft()
            order.append(n)
            nxt = sorted((v for v in nbr[n] if not visited[v]), key=lambda v: degree[v])
            for v in nxt:
                visited[v] = True
                q.append(v)
    return np.array(order[::-1], dtype=np.int64)


def apply_node_permutation(coords, elnodes, perm):
    """Renumber nodes by ``perm[new] = old``; returns (coords, elnodes)."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return coords[perm], inv[elnodes]


def format_doubles(values: np.ndarray, per_line: int = 9):
    """%.10g-format a flat float array into newline-wrapped ASCII bytes
    (native).  Returns ``None`` when the native library is unavailable
    (the caller then takes :func:`format_doubles_py`)."""
    lib = load()
    if lib is None:
        return None
    v = np.ascontiguousarray(np.asarray(values, dtype=np.float64).reshape(-1))
    n_out = ctypes.c_int64(0)
    ptr = lib.fcvm_format_doubles(v, len(v), per_line, ctypes.byref(n_out))
    if not ptr:
        return None
    try:
        return ctypes.string_at(ptr, n_out.value)
    finally:
        lib.fcvm_free_str(ptr)


def format_doubles_py(values: np.ndarray, per_line: int = 9) -> bytes:
    """The Python version of :func:`format_doubles`: the same bytes."""
    flat = np.asarray(values, dtype=np.float64).reshape(-1)
    return "\n".join(" ".join(f"{v:.10g}" for v in flat[i:i + per_line])
                     for i in range(0, len(flat), per_line)).encode("ascii")


def format_tet10_cells(elnodes: np.ndarray):
    """Legacy-VTK tet10 cell lines ("10 n0 ... n9") as ASCII bytes, or
    ``None`` when the native library is unavailable."""
    lib = load()
    if lib is None:
        return None
    e = np.ascontiguousarray(np.asarray(elnodes, dtype=np.int64))
    n_out = ctypes.c_int64(0)
    ptr = lib.fcvm_format_cells(e, len(e), ctypes.byref(n_out))
    if not ptr:
        return None
    try:
        return ctypes.string_at(ptr, n_out.value)
    finally:
        lib.fcvm_free_str(ptr)


def format_tet10_cells_py(elnodes: np.ndarray) -> bytes:
    """The Python version of :func:`format_tet10_cells`: the same bytes."""
    e = np.asarray(elnodes, dtype=np.int64)
    return "\n".join("10 " + " ".join(str(v) for v in row) for row in e).encode("ascii")

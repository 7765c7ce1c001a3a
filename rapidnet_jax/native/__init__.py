"""Native (C++) runtime components with lazy compilation.

The reference's host runtime is C++ (rapidjson parsing + pointer-array
bookkeeping); this package provides the JAX framework's native
counterparts — a fast JSON array parser and the fan-layout tree
preprocessor — compiled on first use with g++ and loaded via ctypes.
Everything has a pure-Python fallback, so the framework works without a
compiler.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "jsonfast.cpp")
_LIB = os.path.join(_HERE, "_rapidnet_native.so")
_lib = None
_tried = False


def _build() -> bool:
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC,
           "-o", _LIB]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception as exc:  # noqa: BLE001
        print(f"[rapidnet_jax.native] build failed: {exc}",
              file=sys.stderr)
        return False


def get_lib():
    """Return the loaded ctypes library, building it if necessary."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        return None
    _tried = True
    if (not os.path.exists(_LIB) or
            os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError as exc:
        print(f"[rapidnet_jax.native] load failed: {exc}", file=sys.stderr)
        return None
    lib.jf_parse.restype = ctypes.c_void_p
    lib.jf_parse.argtypes = [ctypes.c_char_p]
    lib.jf_num_keys.restype = ctypes.c_int64
    lib.jf_num_keys.argtypes = [ctypes.c_void_p]
    lib.jf_key_name.restype = ctypes.c_char_p
    lib.jf_key_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.jf_array_len.restype = ctypes.c_int64
    lib.jf_array_len.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.jf_get_array.restype = ctypes.c_int64
    lib.jf_get_array.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_void_p]
    lib.jf_get_string.restype = ctypes.c_char_p
    lib.jf_get_string.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.jf_free.argtypes = [ctypes.c_void_p]
    lib.tree_fan_layout.restype = ctypes.c_int64
    lib.tree_fan_layout.argtypes = [ctypes.c_void_p] * 3 + \
        [ctypes.c_int64] * 3 + [ctypes.c_void_p] * 2
    lib.tree_prefix_agg.restype = None
    lib.tree_prefix_agg.argtypes = [ctypes.c_void_p] * 3 + \
        [ctypes.c_int64] * 2 + [ctypes.c_void_p]
    _lib = lib
    return _lib

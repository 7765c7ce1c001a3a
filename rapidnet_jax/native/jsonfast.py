"""Python wrapper over the native JSON parser (dict-compatible output)."""

from __future__ import annotations

import numpy as np

from rapidnet_jax.native import get_lib


def load(path: str) -> dict:
    """Parse a reference-format JSON document into a plain dict.

    Arrays come back as Python lists of floats (matching json.load on
    these files), strings as str.  Raises if the native lib is
    unavailable or parsing fails (caller falls back to stdlib json).
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native json library unavailable")
    h = lib.jf_parse(path.encode())
    if not h:
        raise ValueError(f"native parse failed for {path}")
    try:
        doc: dict = {}
        n = lib.jf_num_keys(h)
        for i in range(n):
            key = lib.jf_key_name(h, i).decode()
            alen = lib.jf_array_len(h, key.encode())
            if alen >= 0:
                out = np.empty(alen, np.float64)
                lib.jf_get_array(h, key.encode(), out.ctypes.data)
                doc[key] = out.tolist()
            else:
                doc[key] = lib.jf_get_string(h, key.encode()).decode()
        return doc
    finally:
        lib.jf_free(h)

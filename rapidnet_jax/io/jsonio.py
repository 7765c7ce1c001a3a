"""JSON I/O helpers compatible with the reference's file formats.

The reference (GPUEngineering/RapidNet) stores every problem object as a
JSON document of flat numeric arrays parsed with rapidjson
(src/DwnNetwork.cu:30-117, src/ScenarioTree.cu:32-127, ...).  Matrices are
stored flat in column-major (cuBLAS) order.  These helpers load such files
and reshape into row-major numpy arrays.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np

_NATIVE_PARSER = None
_NATIVE_CHECKED = False


def _native_parser():
    """Optional C++ fast-path for large array-heavy JSON files."""
    global _NATIVE_PARSER, _NATIVE_CHECKED
    if not _NATIVE_CHECKED:
        _NATIVE_CHECKED = True
        try:
            from rapidnet_jax.native import jsonfast

            _NATIVE_PARSER = jsonfast
        except Exception:
            _NATIVE_PARSER = None
    return _NATIVE_PARSER


def load_json(path: str | os.PathLike) -> dict[str, Any]:
    """Load a JSON document (native C++ parser when available)."""
    native = _native_parser()
    if native is not None:
        try:
            return native.load(str(path))
        except Exception:
            pass
    with open(path, "r") as f:
        return json.load(f)


def scalar(doc: dict, key: str, cast=int):
    """Reference scalars are stored as one-element arrays (e.g. "nx": [3])."""
    v = doc[key]
    if isinstance(v, (list, tuple)):
        v = v[0]
    return cast(v)


def vector(doc: dict, key: str, dtype=np.float32) -> np.ndarray:
    return np.asarray(doc[key], dtype=dtype).reshape(-1)


def matrix_colmajor(doc: dict, key: str, rows: int, cols: int,
                    dtype=np.float32) -> np.ndarray:
    """Read a flat column-major (rows x cols) matrix -> row-major ndarray.

    The reference feeds these arrays straight into cuBLAS with
    ``lda = rows`` (e.g. matB at src/Engine.cu:405, matL at
    src/SmpcConfiguration.cu:59-66), i.e. element (i, j) lives at
    ``flat[i + j*rows]``.
    """
    flat = np.asarray(doc[key], dtype=dtype).reshape(-1)
    if flat.size != rows * cols:
        raise ValueError(
            f"key '{key}': expected {rows}x{cols}={rows*cols} entries, "
            f"got {flat.size}")
    return flat.reshape(cols, rows).T.copy()


def dump_json(path: str | os.PathLike, doc: dict) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, default=_np_default)


def _np_default(o):
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    raise TypeError(f"not JSON serializable: {type(o)}")

"""Checkpoint IO for the flax msgpack files the JAX package writes.

Counterpart of `mri2speech_tpu/train/checkpoint.py:24-48`, without flax. The
format: nested dicts stay msgpack maps; each ndarray is msgpack ext type 1
whose payload is the msgpack tuple ``(shape, dtype name, C-order bytes)``;
a numpy scalar is ext type 3 with the same payload. (flax also splits
arrays above 2**30 bytes into chunks; no model here has one.)
"""
from __future__ import annotations

import os
from typing import Any

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _array_from_payload(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buf = msgpack.unpackb(data, raw=True)
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if name == "bfloat16":
        raise TypeError("bfloat16 arrays need a bfloat16 numpy dtype; not supported here")
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _EXT_NDARRAY:
        return _array_from_payload(data)
    if code == _EXT_NPSCALAR:
        return _array_from_payload(data)[()]
    raise ValueError(f"unsupported msgpack extension type {code}")


def msgpack_restore(data: bytes) -> Any:
    """Bytes written by `flax.serialization.to_bytes` -> nested dicts of numpy arrays."""
    import msgpack

    return msgpack.unpackb(data, ext_hook=_ext_hook, raw=False)


def _array_payload(arr: np.ndarray) -> bytes:
    import msgpack

    if arr.dtype.hasobject:
        raise ValueError("object arrays cannot be serialised")
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")), use_bin_type=True)


def _default(x):
    import msgpack

    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _array_payload(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _array_payload(np.asarray(x)))
    raise TypeError(f"cannot serialise {type(x).__name__}")


def _prepare(tree):
    if isinstance(tree, dict):  # sorted keys, as flax's tree_map writes them
        return {str(k): _prepare(tree[k]) for k in sorted(tree, key=str)}
    return tree


def msgpack_serialize(tree: Any) -> bytes:
    """Nested dicts of arrays and scalars -> the bytes flax writes for the same tree."""
    import msgpack

    return msgpack.packb(_prepare(tree), default=_default, strict_types=True)


def save_checkpoint(filepath: str, obj: Any) -> None:
    """Atomic msgpack save of a nested dict of arrays."""
    os.makedirs(os.path.dirname(os.path.abspath(filepath)), exist_ok=True)
    data = msgpack_serialize(obj)
    tmp = filepath + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, filepath)


def load_checkpoint_raw(filepath: str) -> Any:
    """Structure-free restore (nested dicts / numpy arrays)."""
    if not os.path.isfile(filepath):
        raise FileNotFoundError(filepath)
    with open(filepath, "rb") as f:
        return msgpack_restore(f.read())

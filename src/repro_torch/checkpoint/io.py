"""Checkpoint files of trees of tensors — port of ``repro.checkpoint.io``,
in the reference's format byte for byte:

    8-byte little-endian header length | msgpack header | raw buffers

The header is a msgpack list of maps ``{"key", "dtype", "shape",
"nbytes"}``, one a leaf, in the reference's leaf order (JAX's
``tree_flatten_with_path``: dict keys sorted, sequences by index,
NamedTuples by field, ``None`` skipped), and the buffers follow in that
order, little-endian, C order. A key joins the path's parts with ``/``:
``k:<dict key>``, ``i:<index>``, ``a:<NamedTuple field>``. So a tree saved
by either package loads in the other, and a TrainState the JAX package
wrote reads here (``read``, then ``convert.train_state_from_arrays``).

The header's msgpack (the subset it uses: arrays, maps, strings,
non-negative integers) is encoded and decoded here: the machine with the
card has no ``msgpack`` package. bfloat16 leaves are written as the
reference writes them (numpy dtype ``<V2``, the raw 2-byte values).
Files are replaced atomically (written beside, then renamed).
"""
from __future__ import annotations

import os
import pathlib
import struct
from typing import Any, Mapping

import numpy as np
import torch

_BF16 = "<V2"


# ---------------------------------------------------------------------------
# msgpack, the header's subset
# ---------------------------------------------------------------------------

def _pack(obj, out: bytearray) -> None:
    if isinstance(obj, bool) or obj is None:
        raise TypeError(f"the header codec has no {type(obj).__name__}")
    if isinstance(obj, int):
        if obj < 0:
            raise ValueError(f"the header codec takes non-negative ints; "
                             f"got {obj}")
        if obj < 0x80:
            out.append(obj)
        elif obj < 1 << 8:
            out += b"\xcc" + struct.pack(">B", obj)
        elif obj < 1 << 16:
            out += b"\xcd" + struct.pack(">H", obj)
        elif obj < 1 << 32:
            out += b"\xce" + struct.pack(">I", obj)
        else:
            out += b"\xcf" + struct.pack(">Q", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 1 << 8:
            out += b"\xd9" + struct.pack(">B", n)
        elif n < 1 << 16:
            out += b"\xda" + struct.pack(">H", n)
        else:
            out += b"\xdb" + struct.pack(">I", n)
        out += raw
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(0x90 | n)
        elif n < 1 << 16:
            out += b"\xdc" + struct.pack(">H", n)
        else:
            out += b"\xdd" + struct.pack(">I", n)
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, Mapping):
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        elif n < 1 << 16:
            out += b"\xde" + struct.pack(">H", n)
        else:
            out += b"\xdf" + struct.pack(">I", n)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"the header codec has no {type(obj).__name__}")


def packb(obj) -> bytes:
    """``obj`` (lists, dicts, str, non-negative int) as msgpack bytes, the
    smallest form of each, as ``msgpack.packb`` writes them."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _unpack(buf: bytes, pos: int):
    tag = buf[pos]
    pos += 1

    def take(fmt):
        n = struct.calcsize(fmt)
        return struct.unpack(fmt, buf[pos:pos + n])[0], pos + n

    if tag < 0x80:
        return tag, pos
    if tag in (0xCC, 0xCD, 0xCE, 0xCF):
        return take({0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}[tag])
    if 0xA0 <= tag <= 0xBF or tag in (0xD9, 0xDA, 0xDB):
        if tag <= 0xBF:
            n = tag & 0x1F
        else:
            n, pos = take({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[tag])
        return buf[pos:pos + n].decode("utf-8"), pos + n
    if 0x90 <= tag <= 0x9F or tag in (0xDC, 0xDD):
        if tag <= 0x9F:
            n = tag & 0x0F
        else:
            n, pos = take(">H" if tag == 0xDC else ">I")
        items = []
        for _ in range(n):
            x, pos = _unpack(buf, pos)
            items.append(x)
        return items, pos
    if 0x80 <= tag <= 0x8F or tag in (0xDE, 0xDF):
        if tag <= 0x8F:
            n = tag & 0x0F
        else:
            n, pos = take(">H" if tag == 0xDE else ">I")
        d = {}
        for _ in range(n):
            k, pos = _unpack(buf, pos)
            d[k], pos = _unpack(buf, pos)
        return d, pos
    raise ValueError(f"checkpoint header: msgpack type 0x{tag:02x} is not "
                     f"one the format uses")


def unpackb(buf: bytes):
    obj, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise ValueError(f"checkpoint header: {len(buf) - pos} trailing "
                         f"bytes")
    return obj


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(key, leaf) pairs in the reference's order (see the module
    docstring); ``None`` has no leaf."""
    if tree is None:
        return []
    join = (lambda part: f"{prefix}/{part}") if prefix else (lambda p: p)
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in flatten(getattr(tree, f), join(f"a:{f}"))]
    if isinstance(tree, Mapping):
        return [kv for k in sorted(tree)
                for kv in flatten(tree[k], join(f"k:{k}"))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in flatten(x, join(f"i:{i}"))]
    return [(prefix, tree)]


def map_leaves(fn, tree, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(key, leaf)``."""
    if tree is None:
        return None
    join = (lambda part: f"{prefix}/{part}") if prefix else (lambda p: p)
    if _is_namedtuple(tree):
        return type(tree)(*(map_leaves(fn, getattr(tree, f), join(f"a:{f}"))
                            for f in tree._fields))
    if isinstance(tree, Mapping):
        return {k: map_leaves(fn, tree[k], join(f"k:{k}")) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, x, join(f"i:{i}"))
                          for i, x in enumerate(tree))
    return fn(prefix, tree)


def to_numpy(leaf) -> np.ndarray:
    """A leaf as host numpy (a copy of a tensor; bfloat16 as ``<V2``)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16)
        return t.numpy()
    return np.asarray(leaf)


def _is_bf16(arr: np.ndarray) -> bool:
    return arr.dtype.kind == "V" and arr.dtype.itemsize == 2


def _dtype_str(arr: np.ndarray) -> str:
    """numpy's name of ``arr``'s dtype, bfloat16 (raw 2-byte values) as the
    reference's ml_dtypes names it."""
    return _BF16 if _is_bf16(arr) else arr.dtype.str


def save(path: str | pathlib.Path, tree) -> None:
    """Write ``tree``'s leaves (tensors or arrays) to ``path``, replacing
    it atomically."""
    path = pathlib.Path(path)
    tmp = path.with_suffix(".tmp")
    entries, blobs = [], []
    for key, leaf in flatten(tree):
        arr = to_numpy(leaf)
        blobs.append(arr.tobytes(order="C"))
        entries.append({"key": key, "dtype": _dtype_str(arr),
                        "shape": list(arr.shape), "nbytes": len(blobs[-1])})
    header = packb(entries)
    with open(tmp, "wb") as f:
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        for b in blobs:
            f.write(b)
    os.replace(tmp, path)


def read(path: str | pathlib.Path) -> dict[str, np.ndarray]:
    """Every leaf of the file at ``path``: {key: numpy array}, in file
    order."""
    with open(path, "rb") as f:
        hlen = int.from_bytes(f.read(8), "little")
        header = unpackb(f.read(hlen))
        out = {}
        for ent in header:
            buf = f.read(ent["nbytes"])
            if len(buf) != ent["nbytes"]:
                raise ValueError(f"{path}: leaf {ent['key']!r} is cut short")
            out[ent["key"]] = np.frombuffer(
                buf, dtype=np.dtype(ent["dtype"])).reshape(ent["shape"])
    return out


def _as_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if _is_bf16(arr):
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(device=like.device, dtype=like.dtype)


def load(path: str | pathlib.Path, tree_like, *, device=None):
    """The file's leaves in the structure of ``tree_like``: each tensor leaf
    becomes a tensor of its dtype on its device (or on ``device``), each
    other leaf a numpy array. Raises if a leaf is missing or its shape
    differs."""
    by_key = read(path)

    def one(key, like):
        if key not in by_key:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = by_key[key]
        if tuple(arr.shape) != tuple(np.shape(like)):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(np.shape(like))}")
        if isinstance(like, torch.Tensor):
            t = _as_tensor(arr, like)
            return t if device is None else t.to(device)
        return np.asarray(arr, dtype=np.asarray(like).dtype)

    return map_leaves(one, tree_like)


def nest(flat: Mapping[str, Any]) -> dict:
    """``read``'s {key: leaf} as nested dicts and lists (a NamedTuple's
    fields as dict entries), for callers that rebuild a tree by name, such
    as ``convert.train_state_from_arrays``."""
    root: dict = {}
    for key, leaf in flat.items():
        parts = key.split("/")
        node = root
        for i, part in enumerate(parts):
            kind, name = part.split(":", 1)
            idx = int(name) if kind == "i" else name
            last = i == len(parts) - 1
            nxt = parts[i + 1].split(":", 1)[0] if not last else None
            if isinstance(node, list):
                while len(node) <= idx:
                    node.append(None)
            if last:
                node[idx] = leaf
                continue
            child = node[idx] if (isinstance(node, list)
                                  or idx in node) else None
            if child is None:
                child = [] if nxt == "i" else {}
                node[idx] = child
            node = child
    return root

"""Fault-tolerant, layout-agnostic checkpointing (``repro.ckpt.checkpoint``),
in the reference's format on disk, so that a checkpoint written by either
package restores in the other.

* **atomic**: a step is written to ``step_%010d.tmp`` and published by
  ``os.replace`` to ``step_%010d``; a crash mid-write never corrupts the
  newest checkpoint, and restore reads the newest *complete* step;
* **format**: one ``arr_%05d.npy`` a leaf and ``manifest.msgpack`` holding
  ``{"step", "arrays": [{"key", "file", "dtype", "shape"}]}``; a leaf's key
  is its path in the tree as ``jax.tree_util`` names it (dict keys sorted,
  ``0``/``1`` for a tuple's items, ``.step`` for a named tuple's field),
  joined by ``/``; bf16 (and fp8) leaves are stored as same-width unsigned
  integers under their own dtype name;
* **async**: :func:`save_async` copies the tree to host memory at once and
  writes it on a background thread; :func:`wait_pending` joins the writers
  and raises the first error one met;
* retention: the ``keep`` newest checkpoints stay.

The manifest goes through this module's own msgpack codec (maps, arrays,
strings, integers up to 64 bits, nil, booleans), which encodes as
``msgpack.packb`` does, so the port needs neither ``msgpack`` nor
``ml_dtypes``.  Leaves may be torch tensors or numpy arrays; restore gives
torch tensors.
"""
from __future__ import annotations

import os
import shutil
import struct
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

SEP = "/"

# numpy has no bf16 or fp8: such leaves are stored as same-width unsigned
# integers and restored from the manifest's dtype name.  Each entry: the
# torch dtype, the stored numpy type, and the integer types numpy and torch
# read the bits through
_EXOTIC = {
    "bfloat16": (torch.bfloat16, np.uint16, np.int16, torch.int16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, np.uint8, torch.uint8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8, np.uint8, torch.uint8),
}


# ---------------------------------------------------------------------------
# msgpack (the subset a manifest uses)
# ---------------------------------------------------------------------------

def packb(obj: Any) -> bytes:
    """``obj`` (dicts, lists or tuples, str, int, bool, None) in msgpack,
    each value in its smallest encoding, as ``msgpack.packb`` writes it."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(n: int, fix: int, fix_max: int, codes: Tuple[int, int, int],
              out: bytearray) -> None:
    if n < fix_max:
        out.append(fix | n)
    elif codes[0] and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    else:
        out += struct.pack(">BI", codes[2], n)


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (0, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (0, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 128:
        out.append(n)
    elif n >= 0:
        for code, fmt, bits in ((0xCC, ">BB", 8), (0xCD, ">BH", 16),
                                (0xCE, ">BI", 32), (0xCF, ">BQ", 64)):
            if n < 1 << bits:
                out += struct.pack(fmt, code, n)
                return
        raise OverflowError(f"{n} does not fit 64 bits")
    elif n >= -32:
        out.append(n & 0xFF)
    else:
        for code, fmt, bits in ((0xD0, ">Bb", 8), (0xD1, ">Bh", 16),
                                (0xD2, ">Bi", 32), (0xD3, ">Bq", 64)):
            if n >= -(1 << (bits - 1)):
                out += struct.pack(fmt, code, n)
                return
        raise OverflowError(f"{n} does not fit 64 bits")


# (struct format, size) of the fixed-size values and length prefixes
_FIXED = {0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
          0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8)}
_STR = {0xD9: (">B", 1), 0xDA: (">H", 2), 0xDB: (">I", 4)}
_ARRAY = {0xDC: (">H", 2), 0xDD: (">I", 4)}
_MAP = {0xDE: (">H", 2), 0xDF: (">I", 4)}


def unpackb(data: bytes) -> Any:
    """The object msgpack ``data`` encodes (the subset :func:`packb`
    writes); raises ValueError on anything else or trailing bytes."""
    obj, pos = _unpack(memoryview(data), 0)
    if pos != len(data):
        raise ValueError(f"{len(data) - pos} trailing bytes after msgpack")
    return obj


def _read(buf, pos: int, fmt_size) -> Tuple[int, int]:
    fmt, size = fmt_size
    return struct.unpack_from(fmt, buf, pos)[0], pos + size


def _unpack(buf, pos: int) -> Tuple[Any, int]:
    if pos >= len(buf):
        raise ValueError("truncated msgpack")
    c = buf[pos]
    pos += 1
    if c < 0x80:
        return c, pos
    if c >= 0xE0:
        return c - 0x100, pos
    if 0xA0 <= c < 0xC0 or c in _STR:
        n, pos = (c & 0x1F, pos) if c < 0xC0 else _read(buf, pos, _STR[c])
        return bytes(buf[pos:pos + n]).decode("utf-8"), pos + n
    if 0x90 <= c < 0xA0 or c in _ARRAY:
        n, pos = (c & 0x0F, pos) if c < 0xA0 else _read(buf, pos, _ARRAY[c])
        out = []
        for _ in range(n):
            v, pos = _unpack(buf, pos)
            out.append(v)
        return out, pos
    if 0x80 <= c < 0x90 or c in _MAP:
        n, pos = (c & 0x0F, pos) if c < 0x90 else _read(buf, pos, _MAP[c])
        out = {}
        for _ in range(n):
            k, pos = _unpack(buf, pos)
            out[k], pos = _unpack(buf, pos)
        return out, pos
    if c in _FIXED:
        return _read(buf, pos, _FIXED[c])
    if c in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[c], pos
    raise ValueError(f"unsupported msgpack type byte 0x{c:02x}")


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _children(node: Any) -> Optional[List[Tuple[str, Any]]]:
    """(key, child) pairs of a tree node as ``jax.tree_util`` orders and
    names them, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [("." + f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(key, leaf)]`` in ``jax.tree_util``'s order; None is an empty
    subtree, as in JAX."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, child in kids:
        out += _flatten(child, f"{prefix}{SEP}{key}" if prefix else key)
    return out


def _unflatten(tree: Any, leaves: List) -> Any:
    """``tree``'s structure with its leaves replaced, in order, by
    ``leaves`` (consumed from the front)."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return leaves.pop(0)
    vals = [_unflatten(child, leaves) for _, child in kids]
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), vals))
    if hasattr(tree, "_fields"):
        return type(tree)(*vals)
    return type(tree)(vals)


def _host(leaf: Any) -> Tuple[np.ndarray, str]:
    """A host copy of ``leaf`` as numpy (a bf16 or fp8 one as its unsigned
    integer bits) and its dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        name = str(t.dtype).removeprefix("torch.")
        if name in _EXOTIC:
            _, stored, _, torch_bits = _EXOTIC[name]
            return t.view(torch_bits).numpy().view(stored), name
        return t.numpy(), name
    arr = np.array(leaf)
    name = str(arr.dtype)
    if name in _EXOTIC:
        arr = arr.view(_EXOTIC[name][1])
    return arr, name


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------

def _write(directory: str, step: int, items: List[Tuple[str, np.ndarray,
                                                        str]],
           keep: int) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "arrays": []}
    for i, (key, arr, dtype_name) in enumerate(items):
        fname = f"arr_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["arrays"].append({"key": key, "file": fname,
                                   "dtype": dtype_name,
                                   "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(packb(manifest))
    os.replace(tmp, final)          # atomic publish
    _gc(directory, keep)
    return final


def _snapshot(tree: Any) -> List[Tuple[str, np.ndarray, str]]:
    return [(key, *_host(leaf)) for key, leaf in _flatten(tree)]


def save(directory: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Synchronous atomic save of ``tree``'s leaves; returns the path."""
    return _write(directory, step, _snapshot(tree), keep)


_PENDING: List[threading.Thread] = []
# the errors of save_async writers not yet raised by wait_pending
_ERRORS: List[BaseException] = []


def _write_noting(*args) -> None:
    try:
        _write(*args)
    except BaseException as e:  # noqa: BLE001 -- re-raised by wait_pending
        _ERRORS.append(e)


def save_async(directory: str, step: int, tree: Any, *, keep: int = 3
               ) -> threading.Thread:
    """Copy ``tree`` to host memory now; write it on a background thread
    (:func:`wait_pending` joins every such thread and raises the first
    error of one)."""
    items = _snapshot(tree)
    t = threading.Thread(target=_write_noting,
                         args=(directory, step, items, keep), daemon=True)
    t.start()
    _PENDING.append(t)
    return t


def wait_pending() -> None:
    """Join every :func:`save_async` writer still running, then raise the
    first error a writer met since the last call (a step that already
    exists is not replaced: ``os.replace`` onto its directory fails), if
    any."""
    while _PENDING:
        _PENDING.pop().join()
    if _ERRORS:
        errors = list(_ERRORS)
        _ERRORS.clear()
        raise errors[0]


def _steps(directory: str) -> List[int]:
    return [int(d.split("_")[1]) for d in os.listdir(directory)
            if d.startswith("step_") and not d.endswith(".tmp")]


def latest_step(directory: str) -> Optional[int]:
    """The newest complete step in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return max(steps) if steps else None


def restore(directory: str, like: Any, *, step: Optional[int] = None,
            device=None) -> Tuple[Any, int]:
    """The checkpoint of ``step`` (the newest by default) in ``like``'s
    structure, as torch tensors: on ``device`` when given, else each on the
    device of ``like``'s leaf where that is a tensor, else on the CPU.
    Raises when a leaf's shape differs from ``like``'s.  Returns (tree,
    step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        by_key = {a["key"]: a for a in unpackb(f.read())["arrays"]}
    out = []
    for key, leaf in _flatten(like):
        meta = by_key[key]
        arr = np.load(os.path.join(path, meta["file"]))
        if meta["dtype"] in _EXOTIC:
            dt, _, np_bits, _ = _EXOTIC[meta["dtype"]]
            t = torch.from_numpy(arr.view(np_bits)).view(dt)
        else:
            t = torch.from_numpy(arr)
        shape = getattr(leaf, "shape", None)
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{key}: checkpoint {tuple(t.shape)} != "
                             f"model {tuple(shape)}")
        dev = device if device is not None else (
            leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
        out.append(t.to(dev))
    return _unflatten(like, out), step


def _gc(directory: str, keep: int) -> None:
    for s in sorted(_steps(directory))[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:010d}"),
                      ignore_errors=True)

"""Pytree checkpoints without external dependencies (port of
``repro.checkpointing.checkpoint``): one ``.npz`` per step plus a JSON
manifest, in the reference's format, so that a file written by either
package loads in the other.

A pytree is nested dicts, tuples and lists with tensor (or numpy) leaves;
``None`` holds no leaf.  A leaf's key is the ``"/"``-join of its dict keys
and sequence indices; the leaves are stored as ``a{i}``, numbered over the
sorted keys, and the manifest maps each key to ``{"idx", "dtype"}``.
bfloat16 is stored as its ``uint16`` bit pattern under the dtype string
``"bfloat16"``.  :func:`load_pytree` rebuilds the structure of a template
and puts each leaf on the device of the template's leaf.

The ``.npz`` is the one ``np.savez`` writes (uncompressed ``a{i}.npy``
members, ZIP64), but each array goes to and from the file in one call on
its own buffer: ``np.savez`` and ``np.load`` copy a member through the
zip stream in chunks.  On an H100's host, 4.8 GB from the card and back
(``tools/checkpoint_io_probe.py``): ``np.savez`` 0.60 GB/s, ``np.load``
0.40 GB/s, this reader 1.83 GB/s, a plain read of the file 2.1 GB/s.  A
member written otherwise (compressed, or a ``.npy`` header of version 3)
is read by ``np.load``.
"""
from __future__ import annotations

import json
import os
import re
import struct
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch


def _items(node):
    """A node's children as (key, child) pairs, or None for a leaf; dict
    keys in sorted order, as the reference's pytree flattening."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return list(enumerate(node))
    return None


def flatten_pytree(tree) -> Dict[str, Any]:
    """``{"/".join(path): leaf}`` over every leaf of ``tree``: the key
    scheme of every checkpoint file (run states, client-store entries)."""
    out: Dict[str, Any] = {}

    def visit(node, path):
        if node is None:
            return
        kids = _items(node)
        if kids is None:
            out["/".join(str(p) for p in path)] = node
            return
        for k, v in kids:
            visit(v, (*path, k))
    visit(tree, ())
    return out


def map_pytree(fn: Callable, tree, *rest):
    """``tree`` with every leaf replaced by ``fn(leaf, *matching leaves of
    rest)``; the structure (and dict key order) is ``tree``'s."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_pytree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_pytree(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def _to_numpy(leaf):
    """(array, dtype string) of one leaf as the file stores it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    """A tensor of ``arr`` (a fresh array, whose buffer it takes over) on
    ``device``."""
    if dtype == "bfloat16":
        arr = np.asarray(arr, np.uint16)
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = np.array(arr, order="C")
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def _write_npz(path: str, arrays: Iterable[Tuple[str, np.ndarray]]
               ) -> None:
    """The file ``np.savez(path, **dict(arrays))`` writes, byte for byte
    but for the members' time stamps: a C-ordered array's data goes to its
    member in one write."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, arr in arrays:
            with zf.open(name + ".npy", "w", force_zip64=True) as fp:
                if not arr.flags.c_contiguous or arr.dtype.hasobject:
                    np.lib.format.write_array(fp, arr, allow_pickle=False)
                    continue
                np.lib.format.write_array_header_1_0(
                    fp, np.lib.format.header_data_from_array_1_0(arr))
                fp.write(arr.reshape(-1).view(np.uint8).data)


def _read_stored(f, info: zipfile.ZipInfo) -> Optional[np.ndarray]:
    """The array of an uncompressed ``.npy`` member, read from the open
    file ``f`` straight into its buffer; None where the member is not
    one :func:`_write_npz` or ``np.savez`` writes."""
    if info.compress_type != zipfile.ZIP_STORED:
        return None
    f.seek(info.header_offset)
    head = f.read(30)
    if head[:4] != b"PK\x03\x04":
        raise zipfile.BadZipFile(f"{info.filename}: no local header")
    name_len, extra_len = struct.unpack("<HH", head[26:30])
    f.seek(info.header_offset + 30 + name_len + extra_len)
    version = np.lib.format.read_magic(f)
    if version == (1, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
    elif version == (2, 0):
        shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
    else:
        return None
    if dtype.hasobject:
        return None
    arr = np.empty(shape[::-1] if fortran else shape, dtype)
    got = f.readinto(arr.reshape(-1).view(np.uint8).data)
    if got != arr.nbytes:
        raise zipfile.BadZipFile(f"{info.filename}: {got} of {arr.nbytes} "
                                 "bytes")
    return arr.T if fortran else arr


def save_pytree(path: str, tree: Any) -> None:
    """Write ``tree`` to ``path.npz`` and its manifest to ``path.json``.
    The leaves go one at a time, each one's copy to the host made on a
    second thread while the one before is written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves = sorted(flatten_pytree(tree).items())
    meta = {}

    def arrays():
        with ThreadPoolExecutor(1) as pool:
            ahead = [pool.submit(_to_numpy, leaf) for _, leaf in leaves[:1]]
            for i, (key, _) in enumerate(leaves):
                arr, dtype = ahead.pop().result()
                if i + 1 < len(leaves):
                    ahead.append(pool.submit(_to_numpy, leaves[i + 1][1]))
                meta[key] = {"idx": i, "dtype": dtype}
                yield f"a{i}", arr
    _write_npz(path + ".npz", arrays())
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def load_pytree(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (a template: only its keys
    and leaf devices are read): tensors on the device of each template
    leaf (the CPU for a non-tensor leaf), in the stored dtype."""
    with open(path + ".json") as f:
        meta = json.load(f)
    with zipfile.ZipFile(path + ".npz") as zf, \
            open(path + ".npz", "rb") as raw, \
            np.load(path + ".npz") as data:
        def restore(leaf, key):
            m = meta[key]
            name = f"a{m['idx']}"
            arr = _read_stored(raw, zf.getinfo(name + ".npy"))
            if arr is None:
                arr = data[name]
            dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
            return _to_tensor(arr, m["dtype"], dev)
        return _rebuild(like, (), restore)


def _rebuild(node, path, restore):
    """``node``'s structure with each leaf replaced by ``restore(leaf,
    key)``."""
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _rebuild(v, (*path, k), restore) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return type(node)(_rebuild(v, (*path, i), restore)
                          for i, v in enumerate(node))
    return restore(node, "/".join(str(p) for p in path))


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest step saved in ``ckpt_dir`` (None if there is none)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)\.npz$", f))]
    return max(steps) if steps else None


class CheckpointManager:
    """Step-indexed checkpoints ``step_<n>.npz`` / ``.json`` in one
    directory, keeping the newest ``keep``."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        os.makedirs(ckpt_dir, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step}")

    def save(self, step: int, tree: Any) -> None:
        save_pytree(self.path(step), tree)
        self._gc()

    def restore(self, like: Any, step: Optional[int] = None) -> Any:
        step = latest_step(self.dir) if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return load_pytree(self.path(step), like)

    def _gc(self):
        steps = sorted(int(m.group(1)) for f in os.listdir(self.dir)
                       if (m := re.match(r"step_(\d+)\.npz$", f)))
        for s in steps[:-self.keep]:
            for ext in (".npz", ".json"):
                try:
                    os.remove(self.path(s) + ext)
                except OSError:
                    pass

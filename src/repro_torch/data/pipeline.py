"""Batching for the loop engine (port of the parts of
``repro.data.pipeline`` it uses): numpy index streams and gathers, copied
as they are, and batches handed over as tensors on the runner's device.

* :func:`_index_stream` — infinite per-epoch-shuffled index batches;
* :func:`_gather_np` — host batch assembly with the device's modality
  mask applied in numpy (unobservable features zeroed);
* :func:`np_eval_batches` — finite, in-order eval batches padded to the
  batch size, with a ``row_valid`` mask;
* :class:`ClientStreams` — the bank of named shuffle streams (one per
  client and data split, plus the server's).
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

_FIELDS = ("tokens", "loss_mask", "modality_feats", "label", "template_start")


def _index_stream(n: int, batch_size: int, seed: int) -> Iterator[np.ndarray]:
    """Infinite per-epoch-shuffled index batches (drop-last)."""
    if n < batch_size:
        raise ValueError(
            f"shard of {n} rows cannot fill a single batch of "
            f"{batch_size} (drop-last) — lower batch_size or grow the "
            "shard")
    rng = np.random.default_rng(seed)
    while True:
        perm = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            yield perm[i:i + batch_size]


def _gather_np(data: Dict[str, np.ndarray], idx,
               modality_mask: Optional[np.ndarray]) -> Dict[str, np.ndarray]:
    """Host-side batch assembly; modality masking applied in numpy."""
    b = {k: data[k][idx] for k in _FIELDS}
    B, M = b["modality_feats"].shape[:2]
    if modality_mask is None:
        mm = np.ones((B, M), bool)
    else:
        mm = np.broadcast_to(np.asarray(modality_mask, bool), (B, M))
    b["modality_mask"] = mm
    # zero features the device cannot observe
    b["modality_feats"] = b["modality_feats"] * mm[..., None]
    return b


def to_tensors(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device`` (int32 ids become int64)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if t.dtype == torch.int32:
            t = t.long()
        out[k] = t.to(device)
    return out


def _eval_index_blocks(n: int, batch_size: int, n_blocks: Optional[int] = None):
    """In-order index blocks of exactly ``batch_size`` rows with a validity
    mask per row; a partial final block (and any block past
    ``ceil(n / batch_size)`` when ``n_blocks`` forces more) repeats the
    last row with zero validity.  Yields ``(idx, row_valid)``."""
    total = -(-n // batch_size) if n_blocks is None else n_blocks
    for i in range(total):
        start = i * batch_size
        idx = np.arange(start, min(start + batch_size, n))
        valid = np.ones(len(idx), np.float32)
        if len(idx) < batch_size:       # pad to keep shapes static
            pad = batch_size - len(idx)
            fill = idx[-1] if len(idx) else n - 1
            idx = np.concatenate([idx, np.full(pad, fill, idx.dtype
                                               if len(idx) else np.int64)])
            valid = np.concatenate([valid, np.zeros(pad, np.float32)])
        yield idx, valid


def np_eval_batches(data: Dict[str, np.ndarray], batch_size: int,
                    modality_mask: Optional[np.ndarray] = None,
                    n_blocks: Optional[int] = None
                    ) -> Iterator[Dict[str, np.ndarray]]:
    """Finite in-order eval batches of exactly ``batch_size`` rows, each
    with a ``row_valid`` (B,) float mask (0.0 on padding rows)."""
    n = data["tokens"].shape[0]
    for idx, valid in _eval_index_blocks(n, batch_size, n_blocks):
        b = _gather_np(data, idx, modality_mask)
        b["row_valid"] = valid
        yield b


class ClientStreams:
    """A bank of named infinite shuffle streams (``"pub/<j>"``,
    ``"priv/<j>"``, ``"server"``), each created lazily from its seed and
    advanced only when pulled, so a stream's position is the number of
    batches taken from it."""

    def __init__(self):
        self._cfg: Dict[str, tuple] = {}
        self._streams: Dict[str, Iterator[np.ndarray]] = {}
        self._pulled: Dict[str, int] = {}

    def register(self, name: str, data: Dict[str, np.ndarray],
                 batch_size: int, seed: int,
                 mask: Optional[np.ndarray] = None) -> None:
        """Declare stream ``name``."""
        self._cfg[name] = (data, int(batch_size), int(seed), mask)

    def _stream(self, name: str) -> Iterator[np.ndarray]:
        if name not in self._streams:
            data, bs, seed, _ = self._cfg[name]
            self._streams[name] = _index_stream(
                data["tokens"].shape[0], bs, seed)
            self._pulled.setdefault(name, 0)
        return self._streams[name]

    def pull(self, name: str) -> Dict[str, np.ndarray]:
        """Next host batch of stream ``name`` (advances its position)."""
        data, _, _, mask = self._cfg[name]
        idx = next(self._stream(name))
        self._pulled[name] += 1
        return _gather_np(data, idx, mask)

    def advance(self, name: str, k: int) -> None:
        """Skip ``k`` batches without assembling them."""
        s = self._stream(name)
        for _ in range(k):
            next(s)
        self._pulled[name] += k

    def pulled(self, name: str) -> int:
        """Batches consumed from ``name`` so far (0 if never pulled)."""
        return self._pulled.get(name, 0)

"""Batching for the trainer and the loop and vectorized engines (port of
``repro.data.pipeline``): numpy index streams and gathers, copied as they
are, and batches handed over as tensors on the runner's device.

* :func:`_index_stream` — infinite per-epoch-shuffled index batches;
* :func:`_gather_np` — host batch assembly with the device's modality
  mask applied in numpy (unobservable features zeroed);
* :func:`batches` / :func:`np_batches` — infinite shuffled train batches
  (tensors on a device / numpy), the trainer's ``data_iter``;
* :func:`np_eval_batches` / :func:`eval_batches` — finite, in-order eval
  batches padded to the batch size, with a ``row_valid`` mask;
* :func:`stacked_batches` / :func:`stack_steps`,
  :func:`stacked_eval_batches` / :func:`stack_eval_steps` — the same
  streams stacked on a leading client axis (and a leading step axis), for
  the vectorized engine: client j's sub-stream is bit-identical to its
  own unstacked stream;
* :class:`ClientStreams` — the bank of named shuffle streams (one per
  client and data split, plus the server's);
* :class:`RoundPrefetcher` — round assembly on a worker thread, ahead of
  the consumer (the overlap engine's host pipeline).

Stacks stay numpy here; :func:`to_tensors` hands a whole stack to the
device in one transfer.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

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


def batches(data: Dict[str, np.ndarray], batch_size: int, seed: int = 0,
            modality_mask: Optional[np.ndarray] = None, device="cuda"
            ) -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite shuffled batches as tensors on ``device``."""
    for b in np_batches(data, batch_size, seed, modality_mask):
        yield to_tensors(b, device)


def np_batches(data: Dict[str, np.ndarray], batch_size: int, seed: int = 0,
               modality_mask: Optional[np.ndarray] = None
               ) -> Iterator[Dict[str, np.ndarray]]:
    """Numpy twin of :func:`batches` (the same index stream)."""
    n = data["tokens"].shape[0]
    for idx in _index_stream(n, batch_size, seed):
        yield _gather_np(data, idx, modality_mask)


def stacked_batches(datas: Sequence[Dict[str, np.ndarray]], batch_size: int,
                    seeds: Sequence[int],
                    masks: Optional[np.ndarray] = None
                    ) -> Iterator[Dict[str, np.ndarray]]:
    """Client-stacked batch iterator: numpy leaves (N, B, ...).  Client
    j's sub-stream (``datas[j]``, ``seeds[j]``, ``masks[j]``) is
    bit-identical to its own shuffle stream."""
    n_dev = len(datas)
    if len(seeds) != n_dev:
        raise ValueError(f"{len(seeds)} seeds for {n_dev} clients")
    streams = [_index_stream(d["tokens"].shape[0], batch_size, s)
               for d, s in zip(datas, seeds)]
    while True:
        per_dev = [_gather_np(datas[j], next(streams[j]),
                              None if masks is None else masks[j])
                   for j in range(n_dev)]
        yield _stack(per_dev)


def _stack(batches: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack host batches on a new leading axis."""
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def stack_steps(it: Iterator[Dict[str, np.ndarray]], k: int
                ) -> Dict[str, np.ndarray]:
    """Pull ``k`` batches and stack them on a new leading step axis."""
    return _stack([next(it) for _ in range(k)])


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


def eval_batches(data: Dict[str, np.ndarray], batch_size: int,
                 modality_mask: Optional[np.ndarray] = None, device="cuda"
                 ) -> Iterator[Dict[str, torch.Tensor]]:
    """:func:`np_eval_batches` as tensors on ``device``."""
    for b in np_eval_batches(data, batch_size, modality_mask):
        yield to_tensors(b, device)


def stacked_eval_batches(datas: Sequence[Dict[str, np.ndarray]],
                         batch_size: int,
                         masks: Optional[np.ndarray] = None,
                         n_blocks: Optional[int] = None
                         ) -> Iterator[Dict[str, np.ndarray]]:
    """Client-stacked eval shards, (N, B, ...) numpy leaves: every client
    padded to the largest client's block count (or ``n_blocks``), with
    ``row_valid`` (N, B) zeroing the tail padding and whole past-the-end
    blocks, so client j's masked sums equal those of its own
    :func:`np_eval_batches`."""
    sizes = [d["tokens"].shape[0] for d in datas]
    if n_blocks is None:
        n_blocks = max(-(-n // batch_size) for n in sizes)
    iters = [np_eval_batches(d, batch_size,
                             None if masks is None else masks[j],
                             n_blocks=n_blocks)
             for j, d in enumerate(datas)]
    for per_dev in zip(*iters):
        yield _stack(list(per_dev))


def stack_eval_steps(it: Iterator[Dict[str, np.ndarray]]
                     ) -> Dict[str, np.ndarray]:
    """Exhaust a finite eval iterator and stack it on a leading step axis
    ((T, B, ...), or (T, N, B, ...) for stacked shards)."""
    steps = list(it)
    if not steps:
        raise ValueError("empty eval iterator")
    return _stack(steps)


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

    def reset(self) -> None:
        """Drop every stream's position (streams re-create lazily at 0):
        the checkpoint restore's start before it replays the pulls."""
        self._streams.clear()
        self._pulled.clear()

    def stack_steps(self, name: str, k: int) -> Dict[str, np.ndarray]:
        """``k`` batches of one stream stacked (k, B, ...)."""
        return _stack([self.pull(name) for _ in range(k)])

    def gather_steps(self, names: Sequence[str], k: int
                     ) -> Dict[str, np.ndarray]:
        """``k`` steps of ``len(names)`` clients stacked (k, N, B, ...),
        pulled client-major within each step (client 0 step t, client 1
        step t, ...), as :func:`stacked_batches` + :func:`stack_steps`."""
        return _stack([_stack([self.pull(n) for n in names])
                       for _ in range(k)])


class RoundPrefetcher:
    """Runs ``make_round`` on a daemon worker thread, ahead of the
    consumer: ``next(prefetcher)`` returns the rounds in the order the
    worker made them, so a single worker consumes stateful streams in the
    order the synchronous path would.

    * ``depth`` bounds the assembled rounds waiting in the queue (default
      1: double buffering).
    * A worker exception is re-raised at the next ``next()`` as
      ``RuntimeError("round prefetch worker died")`` (the cause chained).
    * ``make_round`` returning None ends the stream: ``next()`` then
      raises ``StopIteration``, also when called again.
    * ``alive`` is probed between waits; the worker stops once it returns
      False (a consumer held weakly can be collected).
    * :meth:`close` stops the worker and drops the buffered rounds.
    """

    _STOP = object()
    _END = object()

    def __init__(self, make_round: Callable[[], Any], depth: int = 1,
                 alive: Optional[Callable[[], bool]] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._alive = alive or (lambda: True)

        def put_guarded(item) -> None:
            while not self._stop.is_set() and self._alive():
                try:
                    self._q.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        def work() -> None:
            try:
                while not self._stop.is_set() and self._alive():
                    item = make_round()
                    if item is None:
                        put_guarded(self._END)
                        return
                    put_guarded(item)
            except Exception as e:  # noqa: BLE001 — re-raised at next()
                self._err = e
                put_guarded(self._STOP)

        self._thread = threading.Thread(target=work, name="round-prefetch",
                                        daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._STOP:
            self._q.put(self._STOP)     # keep raising on repeated next()
            raise RuntimeError("round prefetch worker died") from self._err
        if item is self._END:
            self._q.put(self._END)
            raise StopIteration
        return item

    def close(self) -> None:
        """Stop the worker and drop the buffered rounds; returns once the
        worker has ended."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join()

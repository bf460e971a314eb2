"""Continuous-batching serving engine over the paged KV cache (port of
``repro.launch.serve_engine.ServingEngine``).

* **Fixed decode slots**: ``n_slots`` sequences decode together in one
  step; sampling, the paged cache write, the done mask and the slot
  release all stay on the device.
* **Paged KV pool + host free lists**: requests own pages, not a
  contiguous region; admission needs ``ceil(ctx / page_size)`` free pages,
  and eviction returns them as soon as a sequence finishes.
* **Admission control**: pending requests are admitted whenever a slot and
  enough pages are free; prompts are right-padded to prefill buckets.
* **Mid-flight eviction**: a sequence that reaches its budget (or
  ``eos_id``) has its block-table row zeroed on the device, so later
  unconditional cache writes land on scratch page 0, and its pages freed
  on the host.

Greedy decoding takes ``argmax`` on the device.  Temperature sampling draws
from a ``torch.Generator`` seeded with ``EngineConfig.seed``; it cannot
reproduce the reference's ``jax.random`` bits.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.lora import flatten, merge_lora
from repro_torch.models import paged
from repro_torch.models.model import ModelBundle


@dataclasses.dataclass
class EngineConfig:
    """Engine sizes and sampling; ``device`` is where everything lives."""
    n_slots: int = 8                 # concurrent decode lanes
    page_size: int = 16              # cache entries per page
    n_pages: int = 128               # physical pool (page 0 = scratch)
    max_pages_per_seq: int = 16      # block-table width
    max_out: int = 64                # output buffer capacity per slot
    temperature: float = 0.0         # 0 = greedy (argmax on the device)
    eos_id: int = -1                 # -1 = never stop early
    buckets: Tuple[int, ...] = (16, 32, 64, 128)   # prefill lengths
    seed: int = 0
    device: str = "cuda"

    def __post_init__(self):
        if self.page_size < 1 or self.n_pages < 2:
            raise ValueError("need page_size >= 1 and n_pages >= 2 "
                             "(page 0 is the scratch page)")
        if self.max_pages_per_seq * self.page_size < max(self.buckets):
            raise ValueError("max_pages_per_seq * page_size must cover the "
                             "largest prefill bucket")


@dataclasses.dataclass
class Request:
    """One generation request and, once served, its output."""
    tokens: np.ndarray               # (S,) int32 prompt
    max_new: int = 16
    prefix_embeds: Optional[torch.Tensor] = None   # (P, d) ML-ECS soft prompt
                                                   # (tensor or array)
    rid: int = -1
    # filled by the engine
    t_submit: float = 0.0
    t_done: float = 0.0
    out: Optional[np.ndarray] = None

    @property
    def latency(self) -> float:
        """Seconds from submit to the last token."""
        return self.t_done - self.t_submit


def _resolve_device(name) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"EngineConfig.device={name!r} but CUDA is not available; "
                "pass device='cpu' to serve on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class ServingEngine:
    """Continuous batching for one dense-family model.

    ``params`` must already lie on ``econf.device``; with ``merge`` the
    LoRA adapters are folded into the weights first.  Besides the
    reference's state the engine keeps wall-clock totals of its prefills
    (``n_prefills``, ``prefill_seconds``) and decode steps (``n_steps``,
    ``decode_seconds``), each taken at a point where the host has already
    waited for the device.
    """

    def __init__(self, bundle: ModelBundle, params,
                 econf: Optional[EngineConfig] = None, merge: bool = True):
        self.bundle, self.cfg = bundle, bundle.cfg
        self.econf = ec = econf or EngineConfig()
        self.device = dev = _resolve_device(ec.device)
        off = [k for k, v in flatten(params).items() if v.device != dev]
        if off:
            raise ValueError(f"params not on {dev}: {off[:3]}...")
        with torch.no_grad():
            self.params = merge_lora(params, self.cfg) if merge else params
        self.pstate = bundle.init_paged(ec.n_slots, ec.n_pages, ec.page_size,
                                        dev)
        n = ec.n_slots

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.sched = {
            "block_tables": zeros(n, ec.max_pages_per_seq),
            "seq_lens": zeros(n),
            "active": zeros(n, dtype=torch.bool),
            "last_tok": zeros(n),
            "out_buf": zeros(n, ec.max_out),
            "n_out": zeros(n),
            "budget": zeros(n),
        }
        self.gen = torch.Generator(device=dev).manual_seed(ec.seed)
        self.pending: collections.deque = collections.deque()
        self.finished: Dict[int, Request] = {}
        self._free_pages: List[int] = list(range(ec.n_pages - 1, 0, -1))
        self._free_slots: List[int] = list(range(n))
        self._slot_req: Dict[int, Request] = {}
        self._slot_pages: Dict[int, List[int]] = {}
        self._rids = itertools.count()
        self.n_steps = 0
        self.n_prefills = 0
        self.prefill_seconds = 0.0
        self.decode_seconds = 0.0

    # ------------------------------------------------------------------
    # sampling and the decode step

    def _sample(self, logits):
        """(n, V) float32 logits -> (n,) token ids on the device."""
        T = self.econf.temperature
        if T > 0:
            probs = torch.softmax(logits / T, dim=-1)
            return torch.multinomial(probs, 1, generator=self.gen)[:, 0]
        return torch.argmax(logits, dim=-1)

    def _step(self):
        ec, sd = self.econf, self.sched
        logits, self.pstate = self.bundle.decode_paged(
            self.params, self.pstate, sd["block_tables"], sd["seq_lens"],
            sd["last_tok"][:, None], sd["active"])
        tok = self._sample(logits).int()
        act = sd["active"]
        step = act.int()
        row = torch.arange(ec.n_slots, device=self.device)
        idx = sd["n_out"].clamp(max=ec.max_out - 1).long()
        out_buf = sd["out_buf"].clone()
        out_buf[row, idx] = torch.where(act, tok, out_buf[row, idx])
        n_out = sd["n_out"] + step
        done = act & ((n_out >= sd["budget"]) | (tok == ec.eos_id))
        self.sched = {
            # release: a zeroed row points every later write at the
            # scratch page; the host frees the physical pages
            "block_tables": torch.where(done[:, None],
                                        torch.zeros_like(sd["block_tables"]),
                                        sd["block_tables"]),
            "seq_lens": sd["seq_lens"] + step,
            "active": act & ~done,
            "last_tok": torch.where(act, tok, sd["last_tok"]),
            "out_buf": out_buf,
            "n_out": n_out,
            "budget": sd["budget"],
        }

    # ------------------------------------------------------------------
    # admission

    def submit(self, tokens, max_new: int = 16, prefix_embeds=None) -> int:
        """Queue a prompt (with an optional (P, d) soft prompt); returns
        the request id."""
        req = Request(np.array(tokens, np.int32).reshape(-1),
                      min(max_new, self.econf.max_out), prefix_embeds,
                      rid=next(self._rids))
        req.t_submit = time.perf_counter()
        self.pending.append(req)
        return req.rid

    def _bucket_len(self, n: int) -> int:
        for b in sorted(self.econf.buckets):
            if b >= n:
                return b
        return n

    @torch.no_grad()
    def _try_admit(self) -> int:
        ec, dev = self.econf, self.device
        admitted = 0
        while self.pending and self._free_slots:
            req = self.pending[0]
            S = int(req.tokens.shape[0])
            P = 0 if req.prefix_embeds is None else int(req.prefix_embeds.shape[0])
            S_pad = self._bucket_len(S)
            ctx = P + S_pad + req.max_new
            if ctx > ec.max_pages_per_seq * ec.page_size:
                raise ValueError(
                    f"request needs {ctx} cache entries > block-table "
                    f"capacity {ec.max_pages_per_seq * ec.page_size}")
            n_req = paged.pages_for(ctx, ec.page_size)
            if n_req > len(self._free_pages):
                break                       # wait for an eviction
            self.pending.popleft()
            slot = self._free_slots.pop()
            pages = [self._free_pages.pop() for _ in range(n_req)]

            t0 = time.perf_counter()
            toks = np.zeros((1, S_pad), np.int64)
            toks[0, :S] = req.tokens
            batch = {"tokens": torch.from_numpy(toks).to(dev)}
            if req.prefix_embeds is not None:
                batch["prefix_embeds"] = torch.as_tensor(
                    req.prefix_embeds, device=dev)[None]
            last, pack, _ = self.bundle.prefill_paged(self.params, batch, S)
            tok0 = int(self._sample(last)[0])
            self.n_prefills += 1
            self.prefill_seconds += time.perf_counter() - t0

            if req.max_new <= 1 or tok0 == ec.eos_id:
                self._free_pages.extend(pages)
                self._free_slots.append(slot)
                req.out = np.array([tok0], np.int32)
                req.t_done = time.perf_counter()
                self.finished[req.rid] = req
                admitted += 1
                continue

            n_used = paged.pages_for(P + S_pad, ec.page_size)
            page_ids = torch.tensor(pages[:n_used], dtype=torch.long,
                                    device=dev)
            self.pstate = self.bundle.insert_paged(self.pstate, pack, slot,
                                                   page_ids)
            bt_row = np.zeros((ec.max_pages_per_seq,), np.int32)
            bt_row[:n_req] = pages
            sd = self.sched
            sd["block_tables"][slot] = torch.from_numpy(bt_row).to(dev)
            sd["seq_lens"][slot] = P + S
            sd["active"][slot] = True
            sd["last_tok"][slot] = tok0
            sd["out_buf"][slot, 0] = tok0
            sd["n_out"][slot] = 1
            sd["budget"][slot] = req.max_new
            self._slot_req[slot] = req
            self._slot_pages[slot] = pages
            admitted += 1
        return admitted

    # ------------------------------------------------------------------
    # the serving loop

    @property
    def busy(self) -> bool:
        """True while a request is pending or decoding."""
        return bool(self.pending or self._slot_req)

    @torch.no_grad()
    def step_once(self):
        """One decode step for all slots + host collection of the slots
        that finished in it."""
        t0 = time.perf_counter()
        prev_active = self.sched["active"].cpu().numpy()
        self._step()
        act = self.sched["active"].cpu().numpy()
        self.n_steps += 1
        self.decode_seconds += time.perf_counter() - t0
        newly = np.nonzero(prev_active & ~act)[0]
        if len(newly):
            n_out = self.sched["n_out"].cpu().numpy()
            rows = self.sched["out_buf"][torch.from_numpy(newly).to(
                self.device)].cpu().numpy()
            for i, slot in enumerate(newly):
                self._finish(int(slot), rows[i, :n_out[slot]])

    def _finish(self, slot: int, tokens):
        req = self._slot_req.pop(slot)
        req.out = np.array(tokens, np.int32)
        req.t_done = time.perf_counter()
        self.finished[req.rid] = req
        self._free_pages.extend(self._slot_pages.pop(slot))
        self._free_slots.append(slot)

    def tick(self) -> bool:
        """Admit what fits, then decode one step.  Returns ``busy``."""
        self._try_admit()
        if self._slot_req:
            self.step_once()
        return self.busy

    def run(self) -> Dict[int, Request]:
        """Drive everything submitted so far to completion."""
        while self.busy:
            self.tick()
        return self.finished

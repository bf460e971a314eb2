"""Plain PyTorch oracles for the attention and SSD kernels: the same
functions as ``repro.kernels.ref.attention_ref``, ``paged_attention_ref``,
``ssd_chunk_ref`` and ``ssd_recurrent_ref``, in float32.

They copy nothing from the host once called, so a CUDA graph can capture
them (``chip_smoke.py`` times them that way)."""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q, k, v, causal: bool = True,
                  window: Optional[int] = None):
    """q: (B,H,Sq,D)  k,v: (B,H,Sk,D) (kv already repeated to H heads).

    Queries align to the end of the KV sequence.  Returns float32
    (B,H,Sq,D)."""
    D = q.shape[-1]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        / math.sqrt(D)
    Sq, Sk = q.shape[2], k.shape[2]
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None and window > 0:
        mask &= (qpos - kpos) < window
    logits = logits.masked_fill(~mask[None, None], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float())


def paged_rows(k_pages, v_pages, block_tables, B: int):
    """Each row's keys and values (B, n, K, D) and n: the pages of its
    block table in order, or, with ``block_tables`` None (a ring: the pool
    is B pages, row b's only page is page b), the pool itself, read in
    place with no index."""
    P, ps, K, D = k_pages.shape
    if block_tables is None:
        if P != B:
            raise ValueError(f"a ring needs one page a row: {P} pages, "
                             f"{B} rows")
        return k_pages, v_pages, ps
    M = block_tables.shape[1]
    bt = block_tables.long()
    return (k_pages[bt].reshape(B, M * ps, K, D),
            v_pages[bt].reshape(B, M * ps, K, D), M * ps)


def paged_attention_ref(q, k_pages, v_pages, block_tables, lens,
                        window: Optional[int] = None):
    """Decode-mode oracle.  q: (B,1,H,D);  k_pages/v_pages: (P,ps,K,D);
    block_tables: (B,M) page ids, or None for a ring (P = B, row b's only
    page is page b, :func:`paged_rows`);  lens: (B,) valid entries incl.
    the newest token.  KV heads are grouped (GQA); idle slots (len 0)
    return zeros.  Returns (B, 1, H, D) in q's dtype."""
    B, _, H, D = q.shape
    K = k_pages.shape[2]
    G = H // K
    k, v, n = paged_rows(k_pages, v_pages, block_tables, B)
    k, v = k.float(), v.float()
    qf = q.float().reshape(B, K, G, D)
    logits = torch.einsum("bkgd,bskd->bkgs", qf, k) / math.sqrt(D)
    qpos = lens.long()[:, None] - 1
    kpos = torch.arange(n, device=q.device)[None, :]
    mask = kpos <= qpos
    if window is not None and window > 0:
        mask &= (qpos - kpos) < window
    logits = logits.masked_fill(~mask[:, None, None], NEG_INF)
    w = torch.softmax(logits, dim=-1)
    w = w.masked_fill((lens <= 0)[:, None, None, None], 0.0)   # idle slots
    out = torch.einsum("bkgs,bskd->bkgd", w, v)
    return out.reshape(B, 1, H, D).to(q.dtype)


def ssd_chunk_ref(x, dt, cum, B_, C_):
    """Intra-chunk SSD term + end-of-chunk state for ONE chunk.

    x: (L,P)  dt: (L,)  cum: (L,) cumulative a=dt*A  B_,C_: (L,N)
    y[i] = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
    state = sum_j exp(cum_L - cum_j) dt_j outer(x_j, B_j)
    """
    L = x.shape[0]
    x, dt, cum, B_, C_ = (t.float() for t in (x, dt, cum, B_, C_))
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(cum[:, None] - cum[None, :]).masked_fill(~causal, 0.0)
    att = (C_ @ B_.T) * decay * dt[None, :]
    y = att @ x
    decay_end = torch.exp(cum[-1] - cum)
    state = torch.einsum("l,lp,ln->pn", decay_end * dt, x, B_)
    return y, state


def ssd_recurrent_ref(x, dt, A, B_, C_, return_state: bool = False):
    """Brute-force token-by-token SSD recurrence, ground truth for the
    chunked algorithm itself.  x: (B,S,H,P)  dt: (B,S,H)  A: (H,)
    B_,C_: (B,S,G,N).  Returns y (B,S,H,P) f32 and, with
    ``return_state``, the final state (B,H,P,N) f32."""
    Bsz, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    Bh = B_.repeat_interleave(rep, dim=2).float()
    Ch = C_.repeat_interleave(rep, dim=2).float()
    A = A.float()
    h = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dtt = dt[:, t].float()                                   # (B,H)
        decay = torch.exp(dtt * A)
        h = h * decay[:, :, None, None] \
            + (dtt[:, :, None] * x[:, t].float())[..., None] \
            * Bh[:, t][:, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    y = torch.stack(ys, dim=1)
    return (y, h) if return_state else y

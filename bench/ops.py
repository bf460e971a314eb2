"""Operations and bytes: per kernel launch (the rooflines), per round (the
launches a round makes and the model FLOPs behind ``round_mfu``), and the
card's peaks.

A launch's bound time is the larger of its operations over the peak rate
and its bytes over the HBM rate, each input byte read once and each
output byte written once.  The operations are those the shapes need, not
a route's: kernel C's FMA route and its wgmma route count the same work
at the same shape, and a sequence counts its real rows (not the SSD
chunk's padding).  The arithmetic is that of the port's kernel table
(``PERF.md``), copied here so the yardstick stays put.
"""
from __future__ import annotations

from typing import Dict, List

PEAK_BF16 = 989e12         # FLOP/s, dense bf16, NVIDIA H100 SXM data sheet
HBM = 3.35e12              # bytes/s

BIG_WINDOW = 1 << 30


def bound_s(flops: float, bytes_: float) -> float:
    """The least time a launch can take on the card."""
    return max(flops / PEAK_BF16, bytes_ / HBM)


# ---------------------------------------------------------------------------
# one launch

def lora_matmul(G: int, Mg: int, K: int, N: int, r: int, es: int = 2):
    """Kernel C, grouped over G clients of Mg rows (G = 1: one client):
    y_g = x_g W + s (x_g A_g) B_g, x (G Mg, K), W (K, N).  A dx launch is
    the same call with K and N swapped.  Returns (flops, bytes)."""
    M = G * Mg
    flops = 2 * M * K * N + 2 * M * K * r + 2 * M * r * N
    bytes_ = (M * K + K * N + G * K * r + G * r * N + M * N) * es
    return flops, bytes_


def causal_pairs(S: int, window: int = BIG_WINDOW) -> int:
    """Query-key pairs a causal row of S positions attends under a
    window."""
    w = min(window or BIG_WINDOW, BIG_WINDOW)
    if w >= S:
        return S * (S + 1) // 2
    return w * (w + 1) // 2 + (S - w) * w


def flash_attention_backward(B: int, S: int, H: int, K: int, D: int,
                             window: int = BIG_WINDOW, es: int = 2):
    """Kernel B′ (dQ, dK, dV of causal attention, the scores recomputed):
    reads q, k, v, o, dO and the log-sum-exp, writes dQ, dK, dV."""
    pairs = causal_pairs(S, window)
    nq, nk = B * S * H * D, B * S * K * D
    flops = 10 * D * B * H * pairs
    bytes_ = (3 * nq + 2 * nk) * es + B * H * S * 4 + (nq + 2 * nk) * es
    return flops, bytes_


def ssd_chunk_bwd(B: int, S: int, H: int, P: int, G: int, N: int,
                  chunk: int, dstates: bool = False, es: int = 2):
    """Kernel G′ (the SSD chunk scan's backward: dx, ddt, dcum, dB, dC)
    over B rows of S real positions in chunks of ``chunk``."""
    sizes = [min(chunk, S - s) for s in range(0, S, chunk)]
    nc = len(sizes)
    tri = sum(L * (L + 1) // 2 for L in sizes)
    rows_h, rows_g = B * S * H, B * S * G * N
    flops = 2 * B * (G * tri * N + H * tri * (2 * P + 2 * N)) + (
        2 * B * nc * 2 * H * chunk * P * N if dstates else 0)
    bytes_ = (rows_h * P * es + 2 * rows_g * es + 2 * rows_h * 4
              + rows_h * P * 4 + (B * nc * H * P * N * 4 if dstates else 0)
              + rows_h * P * 4 + 2 * rows_h * 4 + 2 * rows_g * 4)
    return flops, bytes_


# ---------------------------------------------------------------------------
# a model's shapes

def padded_vocab(m: Dict) -> int:
    return ((m["vocab_size"] + 255) // 256) * 256


def d_inner(m: Dict) -> int:
    return m["ssm_expand"] * m["d_model"]


def ssm_heads(m: Dict) -> int:
    return d_inner(m) // m["ssm_head_dim"]


def targets(m: Dict) -> Dict[str, tuple]:
    """(K, N) of each projection of one layer (the adapted ones among
    them are ``m["lora_targets"]``)."""
    d = m["d_model"]
    out = {}
    if m["family"] != "ssm":
        H, K, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
        out.update(wq=(d, H * hd), wk=(d, K * hd), wv=(d, K * hd),
                   wo=(H * hd, d))
        mult = 3 if m["activation"] in ("silu", "geglu") else 2
        out["mlp"] = (d, mult * m["d_ff"])       # the MLP's products, as one
    if m["family"] in ("ssm", "hybrid"):
        di, N, G = d_inner(m), m["ssm_state"], m["ssm_groups"]
        out.update(in_proj=(d, 2 * di + 2 * G * N + ssm_heads(m)),
                   out_proj=(di, d))
    return out


def windows(m: Dict) -> List[int]:
    w = m.get("sliding_window", 0)
    g = m.get("global_every", 0)
    return [BIG_WINDOW if not w or (g and (i + 1) % g == 0) else w
            for i in range(m["n_layers"])]


def connector_flops(m: Dict) -> int:
    """Forward FLOPs of the connector for one row."""
    M, fd, d = m["n_modalities"], m["modality_dim"], m["d_model"]
    c = m.get("connector_dim") or d
    return 2 * (M * fd * c + M * c * c + c * c + c * d)


def pass_flops(m: Dict, rows: int, S: int, prefix: bool = True) -> float:
    """Model FLOPs of one trained pass of ``rows`` rows of S positions:
    2 P T forward, 2 P T more for the activations' gradient through the
    frozen backbone, LoRA's and the connector's weight gradients, and
    attention's and the SSD's quadratic terms (backward twice the
    forward); the recompute under remat is not counted.  ``prefix``: the
    connector made a soft prompt for the pass."""
    T = rows * S
    r, L = m["lora_rank"], m["n_layers"]
    dense = sum(k * n for k, n in targets(m).values()) * L \
        + m["d_model"] * padded_vocab(m)
    lora = sum(k * r + r * n for t, (k, n) in targets(m).items()
               if t in m["lora_targets"]) * L
    fwd = 2 * (dense + lora) * T
    quad = 0
    if m["family"] != "ssm":
        quad += sum(4 * m["head_dim"] * m["n_heads"] * causal_pairs(S, w)
                    for w in windows(m)) * rows
    if m["family"] in ("ssm", "hybrid"):
        quad += 2 * (m["ssm_groups"] * m["ssm_state"]
                     + ssm_heads(m) * m["ssm_head_dim"]) \
            * causal_pairs(S) * L * rows
    conn = connector_flops(m) * rows if prefix else 0
    fwd += quad + conn
    return fwd + 2 * dense * T + 2 * 2 * lora * T + 2 * quad + 2 * conn


# ---------------------------------------------------------------------------
# a round

def round_passes(models: Dict, traffic: Dict) -> List[Dict]:
    """The passes one round makes: each cohort's stacked CCL and AMT steps
    (its G clients' rows behind the soft prompt), and each SE-CCL step's
    four trained passes (the server LLM and SLM, with the soft prompt and
    on the raw batch)."""
    B = traffic["batch_size"]
    S = traffic["corpus"]["seq_len"]
    out = []
    for m, coh in zip(models["edge"], traffic["cohorts"]):
        P = m["n_soft_tokens"]
        steps = traffic["local_steps_ccl"] + traffic["local_steps_amt"]
        for _ in range(steps):
            out.append(dict(model=m, clients=coh["clients"], rows=B,
                            S=S + P, grouped=True, prefix=True))
    for _ in range(traffic["server_steps"]):
        for m in (models["server_llm"], models["server_slm"]):
            out.append(dict(model=m, clients=1, rows=B,
                            S=S + m["n_soft_tokens"], grouped=False,
                            prefix=True))
            out.append(dict(model=m, clients=1, rows=B, S=S, grouped=False,
                            prefix=False))
    return out


def round_model_flops(models: Dict, traffic: Dict) -> float:
    """Model FLOPs of one round: every trained pass, and the anchors (the
    server LLM's connector on every client's public rows)."""
    total = sum(pass_flops(p["model"], p["clients"] * p["rows"], p["S"],
                           p["prefix"])
                for p in round_passes(models, traffic))
    llm = models["server_llm"]
    rows = sum(c["clients"] for c in traffic["cohorts"]) \
        * traffic["batch_size"] * traffic["local_steps_ccl"]
    M, fd = llm["n_modalities"], llm["modality_dim"]
    c = llm.get("connector_dim") or llm["d_model"]
    return total + 2 * (M * fd * c + M * c * c + c * c) * rows


def round_launches(models: Dict, traffic: Dict) -> Dict[str, List[tuple]]:
    """Each kernel's launches in one round as (flops, bytes) pairs, from
    the step structure (the port's launch plan): per trained pass and
    layer, every adapted projection launches C twice forward under remat
    and once for dx (the grouped form in a cohort's step), attention
    launches B′ once and the SSD G′ once."""
    out = {"lora_matmul_grouped": [], "flash_attention_backward": [],
           "ssd_chunk_bwd": []}
    for p in round_passes(models, traffic):
        m, G, B, S = p["model"], p["clients"], p["rows"], p["S"]
        L, r = m["n_layers"], m["lora_rank"]
        rem = 2 if m.get("remat", True) else 1
        if p["grouped"]:
            for t, (k, n) in targets(m).items():
                if t in m["lora_targets"]:
                    out["lora_matmul_grouped"] += \
                        [lora_matmul(G, B * S, k, n, r)] * (L * rem) \
                        + [lora_matmul(G, B * S, n, k, r)] * L
        if m["family"] != "ssm":
            out["flash_attention_backward"] += [
                flash_attention_backward(G * B, S, m["n_heads"],
                                         m["n_kv_heads"], m["head_dim"], w)
                for w in windows(m)]
        if m["family"] in ("ssm", "hybrid"):
            out["ssd_chunk_bwd"] += [ssd_chunk_bwd(
                G * B, S, ssm_heads(m), m["ssm_head_dim"], m["ssm_groups"],
                m["ssm_state"], m["ssm_chunk"])] * L
    return out


def round_bound_s(models: Dict, traffic: Dict) -> Dict[str, float]:
    """Each kernel's summed bound time over one round's launches."""
    return {k: sum(bound_s(f, b) for f, b in v)
            for k, v in round_launches(models, traffic).items()}


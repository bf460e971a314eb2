"""Plain PyTorch reference of the round's models, in float32.

The dense and hybrid trunks (RMSNorm in its ``1 + scale`` form, RoPE,
causal attention with a per-layer window, GELU or SiLU-gated MLP, LoRA on
the adapted projections), the Mamba2 SSD stack (depthwise causal conv, the
exact quadratic form of the SSD over the whole sequence, gated RMSNorm),
the ML-ECS connector (per-modality projectors, fusion MLP, soft-prompt
generator), the Gram-volume contrastive loss, the token cross-entropy and
the pooled KL of SE-CCL.  No kernel, cache or routine of the program is
used: every product is an ``@`` or ``einsum`` in float32 with TF32 off.

Parameters are flat dicts keyed as the program keys its trees
(``layers/attn/wq``), layers stacked on axis 0.  A few clients of one
cohort go through one call: their trainable leaves (LoRA, connector) carry
a leading client axis C, the frozen ones are shared, and the batch is (C,
B, ...).  :class:`Numerics` decides the precision of every product:
``"f32"`` for the reference, ``"fp8"`` for the control (each operand
rounded to float8 e4m3 under a per-tensor scale; the frozen weights once,
layer by layer, the rest on the fly with a straight-through gradient).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BIG_WINDOW = 1 << 30
FP8_MAX = 448.0


def padded_vocab(vocab_size: int) -> int:
    """The vocabulary rounded up to a multiple of 256."""
    return ((vocab_size + 255) // 256) * 256


def latent_dim(m: Dict) -> int:
    return m.get("connector_dim") or m["d_model"]


def d_inner(m: Dict) -> int:
    return m["ssm_expand"] * m["d_model"]


def ssm_heads(m: Dict) -> int:
    return d_inner(m) // m["ssm_head_dim"]


def window_for_layer(m: Dict, i: int) -> int:
    """Layer ``i``'s window (BIG_WINDOW: full attention); every
    ``global_every``-th layer is global."""
    w = m.get("sliding_window", 0)
    g = m.get("global_every", 0)
    if not w or (g and (i + 1) % g == 0):
        return BIG_WINDOW
    return w


def _fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale (its largest |value| maps
    to 448), back in float32."""
    scale = torch.clamp(x.detach().abs().amax(), min=1e-30) / FP8_MAX
    return (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale


class Numerics:
    """The precision of the products: ``"f32"`` or ``"fp8"``."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A frozen leaf as the products read it: float32 (a new tensor),
        matrices rounded to fp8 one layer at a time in the control."""
        w = w.float().clone() if w.dtype == torch.float32 else w.float()
        if self.kind == "fp8" and w.dim() >= 2:
            for s in w.reshape(-1, *w.shape[-2:]):
                s.copy_(_fake_fp8(s))
        return w

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An operand computed in the step (an activation or a trainable
        leaf); fp8 with a straight-through gradient in the control."""
        if self.kind == "f32":
            return x
        return x + (_fake_fp8(x) - x).detach()

    def mm(self, x, w):
        return self.act(x) @ (self.act(w) if w.requires_grad else w)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.act(a), self.act(b))


# ---------------------------------------------------------------------------
# parameter layout

def _normal(*shape, fan_in=None, std=None):
    std = std if std is not None else 1.0 / math.sqrt(
        fan_in if fan_in is not None else shape[0])
    return ("normal", tuple(shape), std)


def _const(kind, *shape):
    return (kind, tuple(shape), None)


def attn_targets(m: Dict) -> Dict[str, tuple]:
    d, H, K, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    return {"wq": (d, H * hd), "wk": (d, K * hd), "wv": (d, K * hd),
            "wo": (H * hd, d)}


def ssm_targets(m: Dict) -> Dict[str, tuple]:
    d, di = m["d_model"], d_inner(m)
    N, G, H = m["ssm_state"], m["ssm_groups"], ssm_heads(m)
    return {"in_proj": (d, 2 * di + 2 * G * N + H), "out_proj": (di, d)}


def param_layout(m: Dict) -> Dict[str, tuple]:
    """{flat key: (init kind, shape, std)} of one unified model (backbone
    and connector), layers stacked on axis 0: the program's keys, shapes
    and initial distributions (normal with std 1/sqrt(fan-in) unless
    given; norms, biases and LoRA B zero)."""
    L, d, V = m["n_layers"], m["d_model"], padded_vocab(m["vocab_size"])
    r = m["lora_rank"]
    fam = m["family"]
    out = {"tok/embed": _normal(V, d, std=1.0 / math.sqrt(d)),
           "final_norm": _const("zeros", d),
           "layers/ln1": _const("zeros", L, d)}
    if not m["tie_embeddings"]:
        out["tok/unembed"] = _normal(d, V)
    if fam != "ssm":
        out["layers/ln2"] = _const("zeros", L, d)
        f = m["d_ff"]
        out["layers/mlp/w_up"] = _normal(L, d, f, fan_in=d)
        out["layers/mlp/w_down"] = _normal(L, f, d, fan_in=f)
        if m["activation"] in ("silu", "geglu"):
            out["layers/mlp/w_gate"] = _normal(L, d, f, fan_in=d)
    targets = {}
    if fam != "ssm":
        targets.update({f"layers/attn/{t}": s
                        for t, s in attn_targets(m).items()})
    if fam in ("ssm", "hybrid"):
        di, N, G = d_inner(m), m["ssm_state"], m["ssm_groups"]
        H, W = ssm_heads(m), m["ssm_conv"]
        conv_dim = di + 2 * G * N
        out["layers/ssm/conv_w"] = _normal(L, conv_dim, W, std=0.5)
        out["layers/ssm/conv_b"] = _const("zeros", L, conv_dim)
        out["layers/ssm/A_log"] = _const("a_log", L, H)
        out["layers/ssm/dt_bias"] = _const("zeros32", L, H)
        out["layers/ssm/D_skip"] = _const("ones32", L, H)
        out["layers/ssm/ssm_norm"] = _const("zeros", L, di)
        targets.update({f"layers/ssm/{t}": s
                        for t, s in ssm_targets(m).items()})
    for key, (i, o) in targets.items():
        out[key] = _normal(L, i, o, fan_in=i)
        if key.rsplit("/", 1)[1] in m["lora_targets"]:
            out[key + "_lora_a"] = _normal(L, i, r, fan_in=i)
            out[key + "_lora_b"] = _const("zeros", L, r, o)
    if m.get("n_modalities", 0) > 0:
        M, fd, c = m["n_modalities"], m["modality_dim"], latent_dim(m)
        P = m["n_soft_tokens"]
        out.update({
            "connector/proj_w": _normal(M, fd, c, fan_in=M),
            "connector/proj_b": _const("zeros", M, c),
            "connector/fuse_w1": _normal(M * c, c),
            "connector/fuse_w2": _normal(c, c),
            "connector/spg_w1": _normal(c, d),
            "connector/spg_scale": _const("ones", P, d),
            "connector/spg_bias": _normal(P, d, std=0.02)})
    return out


def is_lora(key: str) -> bool:
    return "_lora_a" in key or "_lora_b" in key


def is_trainable(key: str) -> bool:
    """LoRA adapters and the connector (the paper's AMT set)."""
    return is_lora(key) or key.startswith("connector")


# ---------------------------------------------------------------------------
# layers; x is (C, B, S, d): C clients of B rows

def rms_norm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x, theta):
    """x (..., S, H, D) rotated at positions 0..S-1 (half-split form)."""
    S, half = x.shape[-3], x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def proj(num: Numerics, p: Dict, key: str, i: int, x, m: Dict):
    """x @ W (+ (alpha / r) (x @ A) @ B, each client its own A and B,
    where the target is adapted); x (C, B, S, K)."""
    C = x.shape[0]
    flat = x.reshape(C, -1, x.shape[-1])
    y = num.mm(flat, p[key][i])
    a = p.get(key + "_lora_a")
    if a is not None:
        y = y + (m["lora_alpha"] / m["lora_rank"]) * num.mm(
            num.mm(flat, a[:, i]), p[key + "_lora_b"][:, i])
    return y.reshape(*x.shape[:-1], y.shape[-1])


def attention(num: Numerics, q, k, v, window: int):
    """Causal attention, queries and keys aligned, keys within
    ``window``; q (N, S, H, D), k, v (N, S, K, D) -> (N, S, H*D)."""
    N, S, H, D = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = num.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(D)
    pos = torch.arange(S, device=q.device)
    keep = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :]
                                              < window)
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    return num.einsum("bhqk,bkhd->bqhd", p, v).reshape(N, S, H * D)


def self_attention(num, p, m, i, h):
    C, B, S, _ = h.shape
    H, K, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = proj(num, p, "layers/attn/wq", i, h, m).reshape(C * B, S, H, hd)
    k = proj(num, p, "layers/attn/wk", i, h, m).reshape(C * B, S, K, hd)
    v = proj(num, p, "layers/attn/wv", i, h, m).reshape(C * B, S, K, hd)
    q, k = rope(q, m["rope_theta"]), rope(k, m["rope_theta"])
    out = attention(num, q, k, v, window_for_layer(m, i))
    return proj(num, p, "layers/attn/wo", i, out.reshape(C, B, S, -1), m)


def mlp(num, p, m, i, x):
    up = num.mm(x, p["layers/mlp/w_up"][i])
    if m["activation"] == "silu":
        h = F.silu(num.mm(x, p["layers/mlp/w_gate"][i])) * up
    elif m["activation"] == "geglu":
        h = F.gelu(num.mm(x, p["layers/mlp/w_gate"][i]),
                   approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    return num.mm(h, p["layers/mlp/w_down"][i])


def ssd(x, dt, A, B_, C_):
    """The SSD over the whole sequence in its quadratic form:
    y_t = sum_{s <= t} (C_t . B_s) exp(sum_{s < u <= t} dt_u A) dt_s x_s.
    x (N, S, H, P), dt (N, S, H), A (H,), B_, C_ (N, S, G, N_state)."""
    S, H, G = x.shape[1], x.shape[2], B_.shape[2]
    cum = torch.cumsum(dt * A, dim=1).transpose(1, 2)           # (N, H, S)
    cb = torch.einsum("bign,bjgn->bgij", C_, B_).repeat_interleave(H // G, 1)
    causal = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(
        ~causal, float("-inf")))
    att = cb * decay * dt.transpose(1, 2)[..., None, :]         # (N, H, S, S)
    return torch.einsum("bhij,bjhp->bihp", att, x)


def causal_conv(x, w, b):
    """Depthwise causal conv: x (N, S, D), w (D, W), b (D,)."""
    W = w.shape[-1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    return sum(xp[:, j:j + x.shape[1], :] * w[:, j] for j in range(W)) + b


def ssm_block(num, p, m, i, x):
    """The Mamba2 mixer of layer ``i`` on its normed input x (C, B, S, d)."""
    di, N, G = d_inner(m), m["ssm_state"], m["ssm_groups"]
    H, P = ssm_heads(m), m["ssm_head_dim"]
    C, B, S, _ = x.shape
    zx = proj(num, p, "layers/ssm/in_proj", i, x, m).reshape(C * B, S, -1)
    z, xbc, dt = zx[..., :di], zx[..., di:2 * di + 2 * G * N], zx[..., -H:]
    xbc = F.silu(causal_conv(xbc, p["layers/ssm/conv_w"][i],
                             p["layers/ssm/conv_b"][i]))
    xs = xbc[..., :di].reshape(C * B, S, H, P)
    B_ = xbc[..., di:di + G * N].reshape(C * B, S, G, N)
    C_ = xbc[..., di + G * N:].reshape(C * B, S, G, N)
    dt = F.softplus(dt + p["layers/ssm/dt_bias"][i])
    A = -torch.exp(p["layers/ssm/A_log"][i])
    y = ssd(xs, dt, A, B_, C_) + p["layers/ssm/D_skip"][i][:, None] * xs
    y = y.reshape(C * B, S, di) * F.silu(z)
    y = rms_norm(y, p["layers/ssm/ssm_norm"][i], m["norm_eps"])
    return proj(num, p, "layers/ssm/out_proj", i, y.reshape(C, B, S, di), m)


def forward(num: Numerics, p: Dict, m: Dict, tokens, prefix=None):
    """Logits (C, B, P + S, V_padded): tokens (C, B, S), prefix (C, B, P,
    d) the soft prompt or None."""
    eps = m["norm_eps"]
    x = p["tok/embed"][tokens]
    if prefix is not None:
        x = torch.cat([prefix, x], dim=2)

    def layer(x, i):
        h = rms_norm(x, p["layers/ln1"][i], eps)
        if m["family"] == "ssm":
            return x + ssm_block(num, p, m, i, h)
        a = self_attention(num, p, m, i, h)
        if m["family"] == "hybrid":
            a = 0.5 * (a + ssm_block(num, p, m, i, h))
        x = x + a
        return x + mlp(num, p, m, i, rms_norm(x, p["layers/ln2"][i], eps))
    for i in range(m["n_layers"]):
        # each layer recomputed in the backward, so that a few clients'
        # rows fit beside the float32 weights
        x = checkpoint(layer, x, i, use_reentrant=False) \
            if torch.is_grad_enabled() else layer(x, i)
    x = rms_norm(x, p["final_norm"], eps)
    w = p["tok/embed"].t() if m["tie_embeddings"] else p["tok/unembed"]
    return num.mm(x, w)


# ---------------------------------------------------------------------------
# connector (Eq. 4, 9, 10); leaves (C, ...), inputs (C, B, ...)

def project_modalities(num, p, feats, mask):
    h = num.einsum("cbmf,cmfd->cbmd", feats, p["connector/proj_w"]) \
        + p["connector/proj_b"][:, None]
    return h * mask[..., None].float()


def fuse(num, p, h, mask):
    flat = (h * mask[..., None].float()).reshape(*h.shape[:2], -1)
    return num.mm(F.gelu(num.mm(flat, p["connector/fuse_w1"]),
                         approximate="tanh"), p["connector/fuse_w2"])


def soft_prompt(num, p, fused):
    g = F.gelu(num.mm(fused, p["connector/spg_w1"]), approximate="tanh")
    return g[..., None, :] * p["connector/spg_scale"][:, None] \
        + p["connector/spg_bias"][:, None]


def connector_prefix(num, p, feats, mask):
    h = project_modalities(num, p, feats, mask)
    s = fuse(num, p, h, mask)
    return soft_prompt(num, p, s), h, s


# ---------------------------------------------------------------------------
# losses, one value a client: (C,)

def lm_loss(num, p, m, batch, prefix):
    """Each client's token CE, a masked mean over its own rows."""
    tokens, mask = batch["tokens"], batch["loss_mask"][..., 1:]
    logits = forward(num, p, m, tokens, prefix)
    S = tokens.shape[-1]
    P = logits.shape[2] - S
    logp = torch.log_softmax(logits[:, :, P:P + S - 1], dim=-1)
    nll = -torch.gather(logp, -1, tokens[..., 1:, None])[..., 0]
    return torch.sum(nll * mask, dim=(1, 2)) / torch.clamp(
        torch.sum(mask, dim=(1, 2)), min=1.0)


def log_volume(vs, mask, eps: float = 1e-5):
    """0.5 logdet of the masked Gram of the normalized rows of vs (N, k,
    d) (+ eps I); absent rows and columns are identity."""
    v = vs * torch.rsqrt(torch.sum(vs * vs, -1, keepdim=True) + 1e-12)
    g = torch.einsum("bkd,bld->bkl", v, v)
    k = vs.shape[1]
    eye = torch.eye(k, dtype=torch.float32, device=vs.device)
    g = torch.where(mask[:, :, None] & mask[:, None, :], g, eye) + eps * eye
    return torch.sum(torch.log(torch.diagonal(torch.linalg.cholesky(g),
                                              dim1=-2, dim2=-1)), dim=-1)


def contrastive_loss(anchor, mods, mask, n_negatives):
    """0.5 (L_O2A + L_A2O) of each client: InfoNCE over negated
    log-volumes of the positive set and U in-batch negatives (rolled
    along the client's own rows).  anchor (C, B, c), mods (C, B, M, c),
    mask (C, B, M)."""
    C, B = anchor.shape[:2]
    U = max(1, min(n_negatives, B - 1))
    ones = torch.ones((C, B, 1), dtype=torch.bool, device=anchor.device)

    def vol(a, md, mk):
        vs = torch.cat([a[:, :, None, :], md], 2)
        return log_volume(vs.reshape(C * B, *vs.shape[2:]),
                          torch.cat([ones, mk], 2).reshape(C * B, -1)
                          ).reshape(C, B)

    o2a = [vol(anchor, mods, mask)] + [
        vol(anchor, torch.roll(mods, u, 1), torch.roll(mask, u, 1))
        for u in range(1, U + 1)]
    a2o = [vol(anchor, mods, mask)] + [
        vol(torch.roll(anchor, u, 1), mods, mask) for u in range(1, U + 1)]
    out = 0.0
    for side in (o2a, a2o):
        logits = -torch.stack(side, dim=-1)
        out = out + torch.mean(-torch.log_softmax(logits, -1)[..., 0], -1)
    return 0.5 * out


def pooled_kl(student, teacher, temperature: float = 2.0):
    """Eq. 14: KL(teacher || student) summed over positions pooled to
    the shorter sequence and the smaller vocabulary, mean over rows;
    logits (B, S, V)."""
    def pool(x, target, axis):
        n = x.shape[axis]
        if n == target:
            return x
        crop = (n // target) * target
        x = x.narrow(axis, 0, crop)
        shape = list(x.shape)
        shape[axis:axis + 1] = [target, crop // target]
        return x.reshape(shape).mean(axis + 1)
    S = min(student.shape[1], teacher.shape[1])
    V = min(student.shape[2], teacher.shape[2])
    s = pool(pool(student, S, 1), V, 2) / temperature
    t = pool(pool(teacher, S, 1), V, 2) / temperature
    logp_s = torch.log_softmax(s, -1)
    logp_t = torch.log_softmax(t, -1)
    kl = torch.sum(torch.exp(logp_t) * (logp_t - logp_s), -1)
    return torch.mean(torch.sum(kl, -1))

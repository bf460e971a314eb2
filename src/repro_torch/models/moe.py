"""Mixture-of-Experts FFN with capacity-based dispatch (port of
``repro.models.moe``).

Top-k routing over ``n_experts``, each expert holding at most C tokens of
a call: C = max(4, int(T * top_k * capacity_factor) // n_experts), T every
row times position of the call.  An assignment's slot in its expert is its
rank among the earlier assignments to that expert, token-major then k
(the reference's one-hot cumsum); assignments ranked C or later are
dropped and add nothing.  In a stacked call (``clients`` = G: a cohort's
rows at once) every client is its own call, as under the reference's
``vmap``.  So the output of a token depends on the other tokens of the
call: in a paged decode step, the idle slots' rows route
too and take capacity ahead of the later slots (ROADMAP, reference fault
3.9), as in the reference.

The router runs in float32 on x cast to float32 (the router leaf stays
float32 in a bf16 model).  The expert FFN, silu(x W_gate) * (x W_up)
then W_down, runs on the (E, C, d) buffers for every expert, as the
reference's three einsums do outside any Pallas kernel: here three
``torch.bmm``.  The kept assignments are written into the buffers with
no accumulation (their (expert, slot) pairs are unique) and the dropped
ones into a spare row that is never read, so the buffers are the
reference's without atomics and without a host sync.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _dense_init
from repro_torch.sharding.partition import constrain


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """The router (d, E) float32 and the experts' stacked gate / up (E, d,
    f) and down (E, f, d) in the param dtype (the reference's fan-in rule:
    std 1/sqrt(shape[0]))."""
    d, f, E = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    dt = cfg.torch_dtype
    return {"router": _dense_init(gen, (d, E), torch.float32),
            "we_gate": _dense_init(gen, (E, d, f), dt),
            "we_up": _dense_init(gen, (E, d, f), dt),
            "we_down": _dense_init(gen, (E, f, d), dt)}


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Tokens an expert holds in a call of ``n_tokens`` tokens."""
    return max(4, int(n_tokens * cfg.top_k * cfg.capacity_factor)
               // cfg.n_experts)


def route(p, cfg: ModelConfig, xf):
    """Top-k routing of xf (T, d): (probs (T, E) f32, gates (T, K) f32
    renormalised over the picks, expert ids (T, K), descending by
    probability as ``jax.lax.top_k``)."""
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)
    gate, idx = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, gate / gate.sum(dim=-1, keepdim=True), idx


def slots(idx, n_experts: int):
    """Each assignment's rank among the earlier assignments to its expert,
    token-major then k: idx ([G,] T, K) -> ([G,] T*K,) int64, counted
    within each client's tokens."""
    flat = idx.reshape(*idx.shape[:-2], -1)
    onehot = F.one_hot(flat, n_experts)
    ranks = torch.cumsum(onehot, dim=-2).gather(-1, flat[..., None])
    return ranks[..., 0] - 1


def moe_mlp(p, cfg: ModelConfig, x, clients: int | None = None):
    """x: (B, S, d) -> (y (B, S, d) in x's dtype, aux f32 scalar), the
    Switch load-balance loss E * sum(mean probs * mean assignment
    counts).

    With ``clients`` = G, x holds G clients' rows in order, B / G each,
    and each client routes as the reference's ``vmap`` routes it: over its
    own T = B / G * S tokens, with its own capacity C, its slots ranked
    within its own assignments, and its own aux, so aux is (G,).  All G
    clients' experts run as one set of three ``torch.bmm`` on (E, G * C,
    d) buffers, client g's slots at rows g * C .. g * C + C - 1 of each
    expert.

    An unstacked call constrains its (E, C, d) buffers and the experts'
    outputs as the reference does (experts over "model"; a no-op outside
    a ``sharding_context``); the stacked form keeps its layout, as the
    reference's constraint under ``vmap`` has no counterpart here."""
    Bsz, S, d = x.shape
    G = clients or 1
    T = Bsz * S // G
    E, K = cfg.n_experts, cfg.top_k
    C = capacity(cfg, T)
    xf = x.reshape(G * T, d)
    probs, gate, idx = route(p, cfg, xf)
    counts = F.one_hot(idx, E).float().sum(dim=1)                # (GT, E)
    aux = E * torch.sum(probs.view(G, T, E).mean(dim=1)
                        * counts.view(G, T, E).mean(dim=1), dim=1)

    e = idx.reshape(G, T * K)
    pos = slots(idx.view(G, T, K), E)
    keep = pos < C
    client = torch.arange(G, device=x.device)[:, None]
    row = (e * G + client) * C + pos.clamp(max=C - 1)   # (expert, slot)
    keep, row = keep.reshape(-1), row.reshape(-1)
    # the kept rows are unique; every dropped one goes to the spare row
    buf = xf.new_zeros((E * G * C + 1, d))
    buf[torch.where(keep, row, E * G * C)] = xf.repeat_interleave(K, dim=0)
    buf = buf[:E * G * C].view(E, G * C, d)
    if not clients:
        buf = constrain(buf, "act_experts", "batch", None)

    h = F.silu(torch.bmm(buf, p["we_gate"])) * torch.bmm(buf, p["we_up"])
    out = torch.bmm(h, p["we_down"])
    if not clients:
        out = constrain(out, "act_experts", "batch", None)
    out = out.view(E * G * C, d)

    w = (keep.float() * gate.reshape(G * T * K)).to(out.dtype)
    y = (out[row] * w[:, None]).view(G * T, K, d).sum(dim=1)
    return y.view(Bsz, S, d), aux if clients else aux[0]


# ---------------------------------------------------------------------------
# expert parallelism (the reference's shard_map form, here one process a
# rank): every "model" rank runs its E / m experts on its data block's
# tokens, and the ranks' partial outputs are summed

def moe_mlp_sharded(p, cfg: ModelConfig, x, clients: int | None = None):
    """:func:`moe_mlp` with its experts split over the "model" axis of the
    active :func:`~repro_torch.sharding.partition.sharding_context`'s
    mesh, and its tokens over the rules' batch axes: the reference's
    ``moe_mlp_sharded``.  Outside a context it is :func:`moe_mlp`.

    Every rank passes the same x (B, S, d) and replicated weights, and
    gets the whole (y, aux).  Each rank routes its data block's tokens
    (capacity from the LOCAL token count), keeps the assignments to its
    own experts [r E/m, (r+1) E/m) (views of the replicated expert
    weights) in per-expert slots ranked among them, and runs them; one
    all-reduce over the model group sums the partial outputs, and the
    data blocks are gathered back (the port's layers around the experts
    run on the whole batch).  The Switch statistics (mean probs, mean
    assignment counts) are averaged over the data group before their
    product.  Where the experts do not split evenly or the batch does not
    divide the data size it is :func:`moe_mlp`, as in the reference.  A
    stacked call (``clients``) raises ``NotImplementedError`` inside a
    context.

    The collectives are differentiable (``sharding/collectives.py``): x
    and the weights enter as replicated inputs (their gradients summed
    over the mesh), the partial outputs' sum and the statistics' average
    pass the gradient on, the gather keeps this rank's block.  The mean
    probs feed aux's gradient from the model axis's first rank only: the
    other model ranks of a data block compute the same term, which the
    mesh-wide sum would count again."""
    from repro_torch.sharding import collectives as coll
    from repro_torch.sharding.partition import current_context, mesh_sizes
    ctx = current_context()
    if ctx is None:
        return moe_mlp(p, cfg, x, clients)
    if clients:
        raise NotImplementedError("a stacked (clients=G) moe call inside a "
                                  "sharding context")
    mesh, rules = ctx
    sizes = mesh_sizes(mesh)
    msz = sizes.get("model", 1)
    E, K = cfg.n_experts, cfg.top_k
    batch = rules.axis("batch")
    data_axes = tuple(a for a in (batch if isinstance(batch, tuple)
                                  else (batch,)) if a in sizes)
    n_data = 1
    for a in data_axes:
        n_data *= sizes[a]
    Bsz, S, d = x.shape
    if E % msz or Bsz % n_data:
        return moe_mlp(p, cfg, x)
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not on the sharding context's mesh")
    names = list(mesh.mesh_dim_names)
    data_groups = [mesh.get_group(a) for a in data_axes]
    model_group = [mesh.get_group("model")] if msz > 1 else []
    m_rank = coord[names.index("model")] if "model" in names else 0
    if msz * n_data > 1:
        # the ranks of the data and model axes enter with the same x and
        # weights
        every = [mesh.get_group(a) for a in (*data_axes, "model")
                 if sizes.get(a, 1) > 1]
        x = coll.enter_replicated(x, every)
        p = {k: coll.enter_replicated(v, every) if v.requires_grad else v
             for k, v in p.items()}
    blk = 0
    for a in data_axes:
        blk = blk * sizes[a] + coord[names.index(a)]
    B_loc = Bsz // n_data
    xb = x[blk * B_loc:(blk + 1) * B_loc]
    T = B_loc * S
    E_loc = E // msz
    C = capacity(cfg, T)
    xf = xb.reshape(T, d)
    probs, gate, idx = route(p, cfg, xf)
    me = probs.mean(dim=0)
    if m_rank:
        me = me.detach()
    ce = F.one_hot(idx, E).float().sum(dim=1).mean(dim=0)
    if n_data > 1:
        me = coll.reduce_partials(me, data_groups) / n_data
        ce = coll.reduce_partials(ce, data_groups) / n_data
    aux = E * torch.sum(me * ce)

    # the assignments to this rank's experts, ranked within each of them
    lo = m_rank * E_loc
    e = idx.reshape(T * K) - lo
    mine = (e >= 0) & (e < E_loc)
    e = e.clamp(0, E_loc - 1)
    onehot = F.one_hot(e, E_loc) * mine[:, None]
    pos = torch.cumsum(onehot, dim=0).gather(-1, e[:, None])[:, 0] - 1
    keep = mine & (pos < C)
    row = e * C + pos.clamp(0, C - 1)
    buf = xf.new_zeros((E_loc * C + 1, d))
    buf[torch.where(keep, row, E_loc * C)] = xf.repeat_interleave(K, dim=0)
    buf = buf[:E_loc * C].view(E_loc, C, d)
    w_gate, w_up, w_down = (p[k][lo:lo + E_loc]
                            for k in ("we_gate", "we_up", "we_down"))
    h = F.silu(torch.bmm(buf, w_gate)) * torch.bmm(buf, w_up)
    out = torch.bmm(h, w_down).view(E_loc * C, d)
    w = (keep.float() * gate.reshape(T * K)).to(out.dtype)
    y = (out[row] * w[:, None]).view(T, K, d).sum(dim=1)
    if model_group:
        y = coll.reduce_partials(y, model_group)
    y = y.view(B_loc, S, d)
    if n_data > 1:
        y = coll.gather_blocks(y, data_groups, blk, n_data)
    return y, aux

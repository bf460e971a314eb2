"""The port's activation constraints and its dry run's split ops, and the
dry run held against the reference's own dry run, on the CPU.

* ``constrain`` / ``constrain_kv_cache`` at the reference's eleven call
  sites (outside ``banded.py``): outside a ``sharding_context`` each call
  returns its argument itself, for every site's function on a toy config;
* inside a context on a fake-group mesh, a DTensor comes out at the
  placements of the sanitized spec (the KV cache's from ``kv_cache_axes``)
  and its gradient goes back on those placements;
* ``launch.dryrun``'s table of DTensor ops it splits as GSPMD does: each
  one installed for the dry run only; ``new_zeros`` follows ``self``;
  the full CE's gradient comes out placed like its logits;
* one toy cell through both packages' ``dryrun_one`` in child processes
  (``tools/dryrun_compare.py``): the port's temp and collective bytes a
  rank within 4x of the reference's, its argument bytes equal; and the
  toy's two decode cells (a batch over data, and one row whose ring
  splits over both axes) held alike;
* the reference's own dry run refuses its Explicit-axes mesh (ROADMAP
  fault 3.11 of the reference).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import _mesh, fake_world
from repro_torch.launch.train import per_example_ce
from repro_torch.models import layers, moe, ssm, transformer
from repro_torch.models.model import build_model
from repro_torch.sharding import partition as part
from repro_torch.sharding import rules

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

DENSE = dict(name="toy", family="dense", n_layers=2, d_model=32, n_heads=4,
             n_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
             lora_rank=4, remat=False, activation="silu", dtype="float32")
MOE = dict(DENSE, family="moe", n_experts=4, top_k=2, d_ff_expert=16,
           capacity_factor=1.25)
SSM = dict(name="toy-ssm", family="ssm", n_layers=2, d_model=32,
           vocab_size=64, ssm_state=8, ssm_head_dim=16, ssm_chunk=8,
           lora_rank=4, lora_targets=("in_proj", "out_proj"), remat=False,
           dtype="float32")

# each site: (module holding the call, the function that calls it)
SITES = [(transformer, "forward"), (transformer, "_block"),
         (transformer, "decode_step"), (layers, "mlp"), (layers, "unembed"),
         (layers, "decode_attention"), (moe, "moe_mlp"), (ssm, "ssm_block"),
         (ssm, "forward")]


def _spy(monkeypatch):
    """Every constrain call of the model modules: (caller, out is x)."""
    calls = []

    def wrap(fn):
        def spy(x, *a):
            out = fn(x, *a)
            calls.append((sys._getframe(1).f_code.co_name, out is x))
            return out
        return spy
    for mod in (transformer, layers, moe, ssm):
        monkeypatch.setattr(mod, "constrain", wrap(part.constrain))
    monkeypatch.setattr(layers, "constrain_kv_cache",
                        wrap(part.constrain_kv_cache))
    return calls


def _run_family(kw):
    """prefill, one decode step and a forward with logits of a toy model of
    ``kw``, on the CPU."""
    bundle = build_model(ModelConfig(**kw))
    params = bundle.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, kw["vocab_size"], (2, 6)))
    logits, cache = bundle.prefill(params, {"tokens": tokens})
    bundle.decode_step(params, cache, tokens[:, :1], 6)
    bundle.logits(params, {"tokens": tokens})
    return logits


@pytest.mark.parametrize("module,site", SITES,
                         ids=[f"{m.__name__.split('.')[-1]}.{s}"
                              for m, s in SITES])
def test_constrain_outside_a_context_returns_its_argument(module, site,
                                                         monkeypatch):
    calls = _spy(monkeypatch)
    kw = MOE if module is moe else SSM if module is ssm else DENSE
    _run_family(kw)
    at_site = [same for caller, same in calls if caller == site]
    assert at_site and all(at_site), (site, calls)


@pytest.fixture
def mesh16():
    """A (4, 4) ("data", "model") mesh over a fake 16-rank group."""
    fake_world(16)
    try:
        yield _mesh("cpu", range(16), (4, 4), ("data", "model"))
    finally:
        dist.destroy_process_group()


def _replicated(mesh, t):
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * 2, run_check=False)


def test_constrain_places_a_dtensor_and_its_gradient(mesh16):
    """("batch", "seq", "act_ff") on (8, 3, 16): batch over data, the
    hidden dim over model; a dim the axis does not divide (6 over 4)
    stays whole.  The gradient, arriving replicated, goes back at the
    constrained placements (DTensor's own ``redistribute`` would send it
    back replicated, as its input was).  A plain tensor, and a DTensor
    already placed that needs no gradient, come back as they are."""
    from torch.distributed.tensor import Replicate, Shard
    ctx = (mesh16, rules.TRAIN_RULES)
    x = _replicated(mesh16, torch.randn(8, 3, 16)).requires_grad_()
    with part.sharding_context(*ctx):
        y = part.constrain(x, "batch", "seq", "act_ff")
        assert y.placements == (Shard(0), Shard(2))
        assert y.to_local().shape == (2, 3, 4)
        odd = part.constrain(_replicated(mesh16, torch.zeros(8, 3, 6)),
                             "batch", "seq", "act_ff")
        assert odd.placements == (Shard(0), Replicate())
        again = part.constrain(y.detach(), "batch", "seq", "act_ff")
        assert again.placements == y.placements
        plain = torch.zeros(8, 3, 16)
        assert part.constrain(plain, "batch", "seq", "act_ff") is plain
        with pytest.raises(ValueError, match="rank 3"):
            part.constrain(x, "batch", "seq")
    y.backward(_replicated(mesh16, torch.ones(8, 3, 16)))
    assert x.grad.placements == (Shard(0), Shard(2))
    np.testing.assert_array_equal(x.grad.full_tensor().numpy(),
                                  np.ones((8, 3, 16), np.float32))


def test_constrain_kv_cache_takes_the_cache_policy(mesh16):
    """(B 8, Sc 16, K 2, hd 4) on (4, 4): the batch over data; 2 kv heads
    do not divide over model, so the sequence splits there, as
    ``kv_cache_axes`` says."""
    from torch.distributed.tensor import Shard
    sizes = {"data": 4, "model": 4}
    assert part.kv_cache_axes(8, 16, 2, sizes, False) == \
        (("data",), ("model",), None)
    cache = _replicated(mesh16, torch.zeros(8, 16, 2, 4))
    with part.sharding_context(mesh16, rules.DECODE_RULES):
        out = part.constrain_kv_cache(cache)
    assert out.placements == (Shard(0), Shard(1))
    assert out.to_local().shape == (2, 4, 2, 4)


def test_split_ops_are_the_dry_runs_only(mesh16):
    """Each op of the table is DTensor's own outside ``counting`` and the
    dry run's inside; ``new_zeros`` follows ``self``'s splits where the
    size is kept, and splits over the mesh dims ``self`` copies a dim
    ``self`` holds at size 1."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    table = DTensor._op_dispatcher._custom_op_handlers
    ops = set(D._handlers())
    assert {str(op) for op in ops} >= {
        "aten.new_zeros.default", "aten.scatter_add.default",
        "aten._log_softmax.default", "aten._log_softmax_backward_data."
        "default", "aten.mm.default", "aten.view.default",
        "aten.select.int", "aten.index.Tensor", "aten.slice.Tensor"}
    before = dict(table)
    assert not ops & set(before)
    with FakeTensorMode(allow_non_fake_inputs=True):
        g = DTensor.from_local(torch.empty(2, 31, 1), mesh16,
                               [Shard(0), Replicate()], run_check=False,
                               shape=(8, 31, 1), stride=(31, 1, 1))
        same = DTensor.from_local(torch.empty(2, 4), mesh16,
                                  [Shard(0), Shard(1)], run_check=False,
                                  shape=(8, 16), stride=(16, 1))
        with D.counting(D.RankCost()):
            assert ops <= set(table)
            grown = g.new_zeros((8, 31, 64))
            kept = same.new_zeros((8, 16))
        outside = g.new_zeros((8, 31, 64))
    assert dict(table) == before
    assert grown.placements == (Shard(0), Shard(2))
    assert grown.to_local().shape == (2, 31, 16)
    assert kept.placements == (Shard(0), Shard(1))
    assert outside.placements == (Replicate(), Replicate())


def test_full_ce_gradient_is_placed_like_its_logits(mesh16):
    """The full CE of logits split (batch over data, vocab over model):
    its log-softmax, gather and their gradients stay split, no op runs
    replicated but DTensor's one ``neg`` of a masked partial sum (a few
    bytes a row), and no collective moves a whole row of the vocab."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    B, S, V = 8, 32, 64
    with FakeTensorMode(allow_non_fake_inputs=True):
        logits = DTensor.from_local(
            torch.empty(B // 4, S, V // 4), mesh16, [Shard(0), Shard(2)],
            run_check=False, shape=(B, S, V),
            stride=(S * V, V, 1)).requires_grad_()
        rows = [Shard(0), Replicate()]
        tokens = DTensor.from_local(torch.empty(B // 4, S, dtype=torch.int32),
                                    mesh16, rows, run_check=False,
                                    shape=(B, S), stride=(S, 1))
        mask = DTensor.from_local(torch.empty(B // 4, S), mesh16, rows,
                                  run_check=False, shape=(B, S),
                                  stride=(S, 1))
        cost = D.RankCost()
        with D.counting(cost):
            per_example_ce(logits, tokens, mask).sum().backward()
    assert logits.grad.placements == (Shard(0), Shard(2))
    assert logits.grad.to_local().shape == (B // 4, S, V // 4)
    assert set(cost.replicated) <= {"aten.neg.default"}
    row = S * V * 4 // 4        # one data block's f32 row of the vocab
    assert all(c.nbytes < row for c in cost.collectives), cost.collectives


TOY_MODEL = ["--arch", "gemma-2b", "--mesh", "4x4",
             "--set", "n_layers=2", "--set", "d_model=128", "--set",
             "n_heads=8", "--set", "n_kv_heads=1", "--set", "head_dim=32",
             "--set", "d_ff=256", "--set", "vocab_size=1024"]
TOY_CELL = TOY_MODEL + ["--shape", "train_4k", "--seq-len", "64",
                        "--batch", "16"]


def _compare(cell, out):
    """``tools/dryrun_compare.py`` on ``cell``: its fields, port / ref."""
    subprocess.run([sys.executable, str(ROOT / "tools" / "dryrun_compare.py"),
                    *cell, "--out-dir", str(out)], check=True,
                   cwd=ROOT, timeout=240)
    assert sorted(os.listdir(out)) == ["compare.json", "port.json",
                                       "ref.json"]
    return json.loads((out / "compare.json").read_text())["fields"]


def test_toy_cell_against_the_reference_dry_run(tmp_path):
    """gemma-2b's shape cut to 2 layers of width 128 (8 heads over a model
    axis of 4, one kv head), 16 x 64 tokens a step, on a (4, 4) mesh:
    the reference (Auto axes) and the port in child processes."""
    out = tmp_path / "cmp"
    fields = _compare(TOY_CELL, out)
    assert fields["argument bytes"]["ratio"] == 1.0
    for name in ("temp bytes", "collective bytes"):
        assert 0.25 <= fields[name]["ratio"] <= 4.0, (name, fields[name])
    port = json.loads((out / "port.json").read_text())
    assert port["torch"] == torch.__version__
    assert port["replicated_ops"] == {"aten.neg.default": 1}


# the toy's decode cells, in float32: the reference's CPU backend converts
# every bf16 operand of a dot to an f32 copy (the stacked weights of all
# layers at once, the cache), which would outweigh the toy's own buffers
TOY_DECODE = {
    # batch 8 over the data axis of 4; the cache's sequence over model
    "decode_32k": ["--shape", "decode_32k", "--seq-len", "4096",
                   "--batch", "8"],
    # one row: the ring (the sliding-window variant's 4,096 slots) over
    # data and model
    "long_500k": ["--shape", "long_500k", "--seq-len", "4096",
                  "--batch", "1"],
}


@pytest.mark.parametrize("shape", list(TOY_DECODE))
def test_toy_decode_cell_against_the_reference_dry_run(tmp_path, shape):
    """The toy's decode step on the (4, 4) mesh: the port's temp and
    collective bytes a rank within 4x of the reference's (its two layers'
    collectives: the reference's own count takes its layer loop's once,
    ROADMAP 3.12), and its arguments equal but the reference's 4-byte
    ``pos`` scalar (the port's step takes the position as a host int).  Decode reads the ring in
    place (``ops.paged_attention`` with no block table), as the
    reference's ``mha`` reads it; through a block table DTensor moved the
    cache block for the index (38x the reference's collectives at
    decode_32k)."""
    fields = _compare(TOY_MODEL + TOY_DECODE[shape]
                      + ["--set", "dtype=float32"], tmp_path / "cmp")
    args = fields["argument bytes"]
    assert args["ref"] - args["port"] == 4, args
    for name in ("temp bytes", "collective bytes, loops x trips"):
        assert 0.25 <= fields[name]["ratio"] <= 4.0, (name, fields[name])


def test_reference_dryrun_refuses_explicit_axes():
    """The reference's own production mesh (``jax.make_mesh``: Explicit
    axes on JAX 0.9) meets its own ``with_sharding_constraint``
    (``repro/sharding/partition.py:69``), which takes Auto axes only: its
    ``dryrun_one`` fails before it lowers (fault 3.11 of the reference)."""
    code = ("from repro.launch import dryrun as D\n"
            "D.dryrun_one('gemma-2b', 'train_4k', overrides=['n_layers=1', "
            "'d_model=128', 'n_heads=8', 'n_kv_heads=1', 'head_dim=32', "
            "'d_ff=256', 'vocab_size=1024'])\n")
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode != 0
    assert "can only refer to Auto axes" in res.stderr
    assert "Explicit" in res.stderr


# ---------------------------------------------------------------------------
# the ops whose DTensor handling differs between torch versions (the card
# host's 2.11, this CPU's 2.13): each run on DTensors placed as in its
# dry-run cell, on the (4, 4) mesh, under the dry run's counting

def _placed(mesh, shape, placements, dtype=torch.float32):
    """A DTensor of global ``shape`` whose block is a fresh fake tensor."""
    from torch.distributed.tensor import DTensor
    local = list(shape)
    for n, p in zip(mesh.shape, placements):
        if p.is_shard():
            local[p.dim] //= n
    stride, k = [], 1
    for s in reversed(shape):
        stride.insert(0, k)
        k *= s
    return DTensor.from_local(torch.empty(local, dtype=dtype), mesh,
                              list(placements), run_check=False,
                              shape=tuple(shape), stride=tuple(stride))


def _counted(fn):
    """``fn()`` under the dry run's counting (inside a fake mode): its
    result, the collective bytes a rank and the ops run replicated."""
    cost = D.RankCost()
    with D.counting(cost):
        out = fn()
    return out, D.collective_bytes(cost.collectives)["total_bytes"], \
        cost.replicated


def test_ring_attention_keeps_batch_and_heads_split(mesh16):
    """A's twin on a ring split on batch (data) and kv heads (model), as
    at whisper-medium decode_32k: its two einsums merge batch and heads
    into one batch of a ``bmm``, a strided split of the merged dim, and
    cut it back, so each rank keeps its rows and heads: no byte moves
    (torch 2.11's DTensor gathered the heads of the whole ring: 2,013,
    281,280 B a rank in that cell)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.kernels import ref
    split = (Shard(0), Shard(2))
    with FakeTensorMode(allow_non_fake_inputs=True):
        q = _placed(mesh16, (8, 1, 8, 16), split)
        k = _placed(mesh16, (8, 32, 4, 16), split)
        v = _placed(mesh16, (8, 32, 4, 16), split)
        lens = _placed(mesh16, (8,), (Shard(0), Replicate()), torch.int32)
        out, moved, replicated = _counted(
            lambda: ref.paged_attention_ref(q, k, v, None, lens))
    assert out.placements == split and out.shape == (8, 1, 8, 16)
    assert moved == 0 and replicated == {}


def test_ssm_decode_keeps_batch_and_heads_split(mesh16):
    """mamba2's decode step as at decode_32k (batch over data, the fused
    projection and the heads over model): ``_split``'s three cuts of the
    projection gather its last dim alike on both torch versions (the
    batch does not divide over all 16 ranks, so the split cannot move to
    it), and the state einsum over batch and heads moves nothing (torch
    2.11's DTensor gathered the heads of the state: 19,660,800 B a rank in
    that cell)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Shard
    cfg = ModelConfig(**SSM)
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    width = 2 * di + 2 * cfg.ssm_groups * N + H
    split = (Shard(0), Shard(1))
    with FakeTensorMode(allow_non_fake_inputs=True):
        zxbcdt = _placed(mesh16, (8, width), split)
        h = _placed(mesh16, (8, H, P, N), split)
        c = _placed(mesh16, (8, H, N), split)
        (z, xbc, dt), cut, rep_cut = _counted(lambda: ssm._split(cfg, zxbcdt))
        y, moved, replicated = _counted(
            lambda: torch.einsum("bhpn,bhn->bhp", h, c))
    block = 8 // 4 * width // 4 * 4          # one rank's f32 block, bytes
    assert cut == 3 * block * 4 * 3 / 4      # three all-gathers over model
    assert [t.shape[-1] for t in (z, xbc, dt)] == [di, di + 2 * N, H]
    assert y.placements == split and moved == 0
    assert rep_cut == {} and replicated == {}


def test_merged_rows_are_gathered_before_a_matmul(mesh16):
    """Batch and sequence, split over data and model (the sequence holds
    the model split where the heads are fewer than its ranks), merged
    into the rows of a projection whose weight is split on its
    contracting dim, as at gemma-2b prefill_32k: the rows' strided split
    is all-gathered, the product's partial sums reduce-scattered over its
    columns, as torch 2.13's DTensor lays it out (2.11's ran the product
    on whole tensors)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = _placed(mesh16, (8, 16, 32), (Shard(0), Shard(1)))
        w = _placed(mesh16, (32, 32), (Replicate(), Shard(0)))
        out, moved, replicated = _counted(lambda: x.reshape(128, 32) @ w)
    assert out.placements == (Shard(0), Shard(1)) and replicated == {}
    block = 128 // 16 * 32 * 4              # one rank's f32 rows, bytes
    # an all-gather of the rows over model, a reduce-scatter of the sums
    assert moved == 4 * block * 3 / 4 + block * 3


def test_product_cuts_the_copy_to_the_split(mesh16):
    """hymba's SSM input (batch over data, its channels whole) times its
    conv weight (channels over model), as at prefill_32k: the input is cut
    to the weight's split, a local slice, no byte moved and the product
    split over model, as torch 2.13's DTensor lays it out (2.11's gathered
    the weight, and the SSD path after it ran copied over model: 0.144x
    2.13's collectives in that cell)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = _placed(mesh16, (8, 6, 32), (Shard(0), Replicate()))
        w = _placed(mesh16, (32,), (Replicate(), Shard(0)))
        out, moved, replicated = _counted(lambda: x * w)
    assert out.placements == (Shard(0), Shard(2))
    assert moved == 0 and replicated == {}


def test_moe_buffer_write_gathers_only_the_rows(mesh16):
    """The moe's scatter of routed rows into its (E·C + 1, d) buffer, as
    at qwen3-moe decode_32k (rows over data, d over model, the buffer's
    rows whole): the indices and the rows are gathered over data and each
    rank writes its columns; the gradient's write into a copy moves the
    values' split off the indexed dim.  torch 2.11's DTensor ran both on
    whole tensors (4.95x 2.13's collectives in that cell)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    TK, d, rows_ = 32, 16, 41
    cols = (Replicate(), Shard(1))
    with FakeTensorMode(allow_non_fake_inputs=True):
        buf = _placed(mesh16, (rows_, d), cols)
        idx = _placed(mesh16, (TK,), (Shard(0), Replicate()), torch.int64)
        vals = _placed(mesh16, (TK, d), (Shard(0), Shard(1)))

        def write():
            buf[idx] = vals
            return buf
        out, moved, replicated = _counted(write)
        grad = _placed(mesh16, (TK, d), (Shard(0), Shard(0)))
        copy, moved_copy, rep_copy = _counted(
            lambda: torch.ops.aten.index_put.default(buf, [idx], grad))
    assert out is buf and out.placements == cols
    # all-gathers over data of the indices (8 B each) and of the rows'
    # blocks of d
    assert moved == (TK * 8 + TK * d // 4 * 4) * 3 / 4
    assert copy.placements == cols and rep_copy == {} and replicated == {}
    assert 0 < moved_copy < TK * d * 4


def test_roll_and_pad_move_the_split_off_their_dims(mesh16):
    """``roll`` along a batch split over data (the CCL loss's negatives):
    the split moves to the innermost other dim it divides (an all-to-all)
    or, where none divides, is gathered; ``constant_pad_nd`` and ``flip``
    along a split sequence (the SSD's chunks) alike.  torch 2.11's DTensor
    ran each on whole tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    rows = (Shard(0), Replicate())
    with FakeTensorMode(allow_non_fake_inputs=True):
        mods = _placed(mesh16, (16, 3, 8), rows)
        mask = _placed(mesh16, (16, 3), rows)
        seq = _placed(mesh16, (2, 16, 8), (Replicate(), Shard(1)))
        r, moved, rep = _counted(lambda: torch.roll(mods, 1, 0))
        m, moved_m, rep_m = _counted(lambda: torch.roll(mask, 1, 0))
        p, moved_p, rep_p = _counted(
            lambda: torch.nn.functional.pad(seq, (0, 0, 0, 4)))
        f, moved_f, rep_f = _counted(lambda: torch.flip(seq, (1,)))
    assert r.placements == (Shard(2), Replicate())
    assert moved == 16 * 3 * 8 * 4 / 4 * 3 / 4     # one all-to-all
    assert m.placements == (Replicate(), Replicate())
    assert moved_m == 16 * 3 * 4 * 3 / 4           # one all-gather
    assert p.shape == (2, 20, 8) and p.placements == (Replicate(), Shard(2))
    assert f.placements == (Replicate(), Shard(2))
    assert moved_p == moved_f == 2 * 16 * 8 * 4 / 4 * 3 / 4
    assert rep == rep_m == rep_p == rep_f == {}


def test_gram_linalg_maps_over_the_batch(mesh16):
    """The Gram log-volume's linalg (kernel D's twin and its gradient) on
    samples split over data: the Cholesky, the triangular solve of its
    gradient, the diagonal's gradient and ``cholesky_inverse`` (D's
    backward from the dots) each work on every rank's own samples, no
    byte moved, and the whole log-volume and its gradient run nothing
    replicated (torch 2.11's DTensor ran the linalg on whole tensors)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.kernels.gram_volume import gram_log_volume_plain
    aten = torch.ops.aten
    rows = (Shard(0), Replicate())
    with FakeTensorMode(allow_non_fake_inputs=True):
        g = _placed(mesh16, (16, 4, 4), rows)
        diag = _placed(mesh16, (16, 4), rows)
        ops = {
            "cholesky_ex": lambda: torch.linalg.cholesky_ex(g).L,
            "cholesky_inverse": lambda: torch.cholesky_inverse(g),
            "solve_triangular": lambda: torch.linalg.solve_triangular(
                g, g, upper=False),
            "diagonal_backward": lambda: aten.diagonal_backward(
                diag, [16, 4, 4], 0, -2, -1)}
        done = {name: _counted(fn) for name, fn in ops.items()}
        vs = _placed(mesh16, (16, 4, 8), rows).requires_grad_()
        mask = _placed(mesh16, (16, 4), rows, torch.bool)

        def step():
            lv = gram_log_volume_plain(vs, mask)
            lv.backward(torch.ones_like(lv))
            return lv
        _, _, replicated = _counted(step)
    for name, (out, moved, rep) in done.items():
        assert out.placements == rows and out.shape == (16, 4, 4), name
        assert moved == 0 and rep == {}, (name, moved, rep)
    assert replicated == {} and vs.grad.placements == rows


def test_masked_sum_is_reduced_before_an_add(mesh16):
    """A gather from a vocab-split row (the full CE's: each rank's vocab
    block, a masked partial sum over model) met by an add of a plain
    tensor (the loss's aux term, in the train cells): the masked sum is
    all-reduced over model first and nothing runs replicated (torch
    2.11's DTensor reduced it through the gather's mask, which the summed
    loss no longer fits, and failed)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    with FakeTensorMode(allow_non_fake_inputs=True):
        logp = _placed(mesh16, (8, 6, 64), (Shard(0), Shard(2)))
        tgt = _placed(mesh16, (8, 6, 1), (Shard(0), Replicate()),
                      torch.int64)
        aux = torch.zeros(())
        out, moved, replicated = _counted(
            lambda: torch.gather(logp, -1, tgt)[..., 0] + aux)
    assert out.placements == (Shard(0), Replicate())
    assert replicated == {}
    assert moved == 2 * (2 * 6 * 4) * 3 / 4     # one all-reduce over model


@pytest.mark.parametrize("key", list(D.VERSION_GAPS))
def test_version_gap_has_an_answer_and_a_test(key):
    """Each entry of the dry run's table of torch-version gaps names what
    DTensor does, where it was seen, the dry run's answer (the handler of
    each op it keys) and a test of this file that holds it."""
    gap = D.VERSION_GAPS[key]
    assert gap.wrong and gap.seen_on
    answer = getattr(D, gap.answer)
    assert callable(answer) and callable(globals()[gap.test])
    table = {str(op): fn for op, fn in D._handlers().items()}
    for op in key.split():
        assert table.get(op, answer) is answer, (op, table.get(op))

"""Port parity for the wire codec and for prefill attention's gradient.

* Kernels E/F: the plain versions of ``quantize_rows`` / ``dequantize_rows``
  equal the JAX package's Pallas kernels (interpret mode, through
  ``repro.kernels.ops``) bit for bit: the round's uplink (8,640 x 128) and
  downlink (2,880 x 128) tile shapes and ragged ones, all-zero rows, exact
  half-way ties, qmax 127 and 7, f32 and bf16 input.
* ``Channel``: encode / decode / roundtrip / ``roundtrip_tree`` and the
  error-feedback state equal the JAX channel's bit for bit over several
  rounds (int8 / int4, EF on and off, f32 and bf16 leaves, ragged leaf
  lengths, ``block=64``); ``bytes_on_wire`` and ``communicated_fraction``
  equal the reference's for all four codecs; EF telescopes.  (The
  sketch codec's parity is tests/test_torch_sketch.py.)
* Kernel B's backward: ``flash_attention_backward_plain`` (the function the
  backward kernel computes) against ``jax.grad`` of
  ``repro.models.layers.mha`` (GQA, a window, Sq < Sk; f32, 1e-5).

On the CPU the port's ``ops`` wrappers take the plain versions; the CUDA
kernels are held to the same plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core import lora as jlora
from repro.core.channel import ChannelSpec as JChannelSpec
from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro.models.model import build_model as jbuild
from repro_torch.configs.base import ModelConfig
from repro_torch.core import lora
from repro_torch.core.channel import ChannelSpec, TensorSpec
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    flash_attention_backward_plain, flash_attention_plain)
from repro_torch.kernels.quantize import (dequantize_rows_plain,
                                          quantize_rows_plain)
from repro_torch.models.model import build_model

torch.set_num_threads(1)

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _bits(a) -> np.ndarray:
    """The bit pattern of a float32/bf16 array or tensor, for exact
    comparison (NaN-safe, -0.0 distinct from 0.0)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().float().numpy()
    return np.asarray(a, np.float32).view(np.uint32)


def tile_rows(R, L, qmax, seed):
    """(R, L) f32 tiles: random rows over six decades of scale, all-zero
    rows, and rows of exact half-way ties (absmax = qmax * 2^e makes the
    scale exactly 2^e, and (k + 1/2) * 2^e divides to k + 1/2)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(R, L) * 10.0 ** rng.uniform(-3, 2, (R, 1))
    x[0] = 0.0
    if R > 2:
        x[R // 2] = 0.0
    for i in range(1, R, 5):
        e = 2.0 ** rng.randint(-6, 4)
        k = rng.randint(1 - qmax, qmax - 1, L) + 0.5       # |k| < qmax
        x[i] = k * e
        x[i, rng.randint(L)] = qmax * e * rng.choice([-1, 1])
    return x.astype(np.float32)


QUANT_SHAPES = [(8640, 128), (2880, 128), (129, 131), (7, 3), (1, 257)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("qmax", [127, 7])
@pytest.mark.parametrize("R,L", QUANT_SHAPES)
def test_quantize_pair_plain_equals_pallas_bitwise(R, L, qmax, dtype):
    x = tile_rows(R, L, qmax, seed=R + L + qmax)
    tx = torch.from_numpy(x).to(dtype)
    jx = jnp.asarray(x).astype(_JDT[dtype])
    q, s = quantize_rows_plain(tx, qmax)
    jq, js = jops.quantize(jx, qmax=qmax, use_kernel=True, interpret=True)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(s), _bits(js))
    assert (s[0] == 0).item() and (q[0] == 0).all()       # all-zero row
    if R > 1:                                             # ties were hit
        xs = tx[1].float() / s[1]
        assert bool((xs - xs.floor() == 0.5).any())
    dq = dequantize_rows_plain(q, s)
    jdq = jops.dequantize(jq, js, use_kernel=True, interpret=True)
    np.testing.assert_array_equal(_bits(dq), _bits(jdq))
    # the ops wrappers take the plain versions for CPU tensors
    q2, s2 = ops.quantize(tx, qmax)
    assert torch.equal(q2, q) and torch.equal(s2, s)
    assert torch.equal(ops.dequantize(q, s), dq)


def test_quantize_rejects_a_bad_qmax():
    with pytest.raises(ValueError, match="qmax"):
        quantize_rows_plain(torch.zeros((2, 4)), 128)


# ---------------------------------------------------------------------------
# the channel against the reference's

LEAVES = {                                   # (stacked shape, dtype)
    "layers/attn/wq_lora_a": ((3, 2, 48, 4), torch.float32),
    "layers/attn/wq_lora_b": ((3, 2, 4, 48), torch.bfloat16),
    "layers/attn/wo_lora_a": ((3, 2, 37, 3), torch.float32),   # ragged L
    "layers/mlp/w1_lora_b": ((3, 7, 5), torch.bfloat16),       # L < block
}


def uploads(seed):
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*shape) * 0.05).astype(np.float32)
            for k, (shape, _) in LEAVES.items()}


def both(flat_np):
    """The same numpy uploads as torch and JAX dicts in each leaf's dtype."""
    t = {k: torch.from_numpy(v).to(LEAVES[k][1]) for k, v in flat_np.items()}
    j = {k: jnp.asarray(v).astype(_JDT[LEAVES[k][1]])
         for k, v in flat_np.items()}
    return t, j


def assert_same(tdict, jdict):
    assert sorted(tdict) == sorted(jdict)
    for k in tdict:
        assert tdict[k].shape == tuple(jdict[k].shape), k
        np.testing.assert_array_equal(_bits(tdict[k]), _bits(jdict[k]),
                                      err_msg=k)


CODEC_CASES = [
    dict(codec="int8"),
    dict(codec="int4"),
    dict(codec="int8", error_feedback=False),
    dict(codec="int4", block=64),
    dict(codec="int8", block=64, error_feedback=False),
]


@pytest.mark.parametrize("kw", CODEC_CASES,
                         ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_channel_rounds_equal_reference_bitwise(kw):
    """Three rounds of the uplink roundtrip with the residuals carried,
    then the stateless downlink: payload codes and scales, decoded leaves
    (in their own dtype) and EF residuals bit-equal to JAX's."""
    ch, jch = ChannelSpec(**kw).make(), JChannelSpec(**kw).make()
    assert ch.stateful == jch.stateful == kw.get("error_feedback", True)
    like = {k: TensorSpec(shape, dt) for k, (shape, dt) in LEAVES.items()}
    jlike = {k: jax.ShapeDtypeStruct(shape, _JDT[dt])
             for k, (shape, dt) in LEAVES.items()}
    st, jst = ch.init_state(like), jch.init_state(jlike)
    assert_same(st, jst)
    for rnd in range(3):
        t, j = both(uploads(rnd))
        payload, _ = ch.encode(t, st, rnd)
        jpayload, _ = jch.encode(j, jst, rnd)
        for k in t:
            np.testing.assert_array_equal(payload[k]["q"].numpy(),
                                          np.asarray(jpayload[k]["q"]))
            np.testing.assert_array_equal(_bits(payload[k]["s"]),
                                          _bits(jpayload[k]["s"]))
        dec, st = ch.roundtrip(t, st, rnd)
        jdec, jst = jch.roundtrip(j, jst, rnd)
        for k in t:
            assert dec[k].dtype == LEAVES[k][1]
        assert_same(dec, jdec)
        assert_same(st, jst)
        if ch.stateful:
            assert any(bool((v != 0).any()) for v in st.values())
    tree = {k: v[0] for k, v in t.items()}
    down = ch.roundtrip_tree(tree, 3)
    jdown = jch.roundtrip_tree({k: v[0] for k, v in j.items()}, 3)
    assert_same(down, jdown)
    assert ch.bytes_on_wire(like) == jch.bytes_on_wire(jlike)


def test_identity_passes_through():
    t, _ = both(uploads(0))
    ident = ChannelSpec().make()
    dec, st = ident.roundtrip(t, None)
    assert all(dec[k] is t[k] for k in t) and st == {}
    assert ident.roundtrip_tree(t) is t and ident.init_state(t) == {}


@pytest.mark.parametrize("kw", [dict(codec="x"), dict(block=0),
                                dict(sketch_rank=0)])
def test_channel_spec_validates_like_reference(kw):
    with pytest.raises(ValueError) as ours:
        ChannelSpec(**kw)
    with pytest.raises(ValueError) as theirs:
        JChannelSpec(**kw)
    assert str(ours.value) == str(theirs.value)


SMALL = JConfig(name="chan-slm", family="dense", n_layers=2, d_model=48,
                n_heads=4, n_kv_heads=2, head_dim=12, d_ff=96,
                n_modalities=3, modality_dim=32, n_soft_tokens=4,
                connector_dim=48, lora_rank=4, remat=False,
                activation="gelu", vocab_size=128, dtype="bfloat16")


@pytest.mark.parametrize("codec", ["identity", "int8", "int4", "sketch"])
def test_bytes_on_wire_and_communicated_fraction_match(codec):
    kw = dict(codec=codec, block=64, sketch_rank=4)
    jparams = jbuild(SMALL).init(jax.random.key(0))
    params = build_model(ModelConfig(**dataclasses.asdict(SMALL))).init(
        torch.Generator().manual_seed(0))
    ups = lora.partition(params, lora.is_lora_leaf)
    jups = {jlora.path_str(p): x for p, x in
            jax.tree_util.tree_flatten_with_path(
                jlora.partition(jparams, jlora.is_lora_leaf))[0]}
    assert sorted(ups) == sorted(jups) and ups
    like = {k: TensorSpec((3, *v.shape), v.dtype) for k, v in ups.items()}
    jlike = {k: jax.ShapeDtypeStruct((3, *v.shape), v.dtype)
             for k, v in jups.items()}
    ch, jch = ChannelSpec(**kw).make(), JChannelSpec(**kw).make()
    assert ch.bytes_on_wire(like) == jch.bytes_on_wire(jlike)
    got = lora.communicated_fraction(params, channel=ChannelSpec(**kw))
    want = jlora.communicated_fraction(jparams, channel=JChannelSpec(**kw))
    assert got == pytest.approx(want, rel=1e-12)
    assert lora.communicated_fraction(params) == pytest.approx(
        jlora.communicated_fraction(jparams), rel=1e-12)


def test_error_feedback_residual_telescopes():
    """e1 = x - d1 (from e0 = 0) and d1 + d2 = 2x - e2: the quantization
    error is carried to the next round, not accumulated."""
    ch = ChannelSpec(codec="int8").make()
    x = {"w": torch.from_numpy(
        np.random.RandomState(1).randn(2, 300).astype(np.float32))}
    st0 = ch.init_state(x)
    assert bool((st0["w"] == 0).all())
    d1, st1 = ch.roundtrip(x, st0, 0)
    np.testing.assert_allclose(st1["w"].numpy(), (x["w"] - d1["w"]).numpy(),
                               rtol=0, atol=1e-6)
    d2, st2 = ch.roundtrip(x, st1, 1)
    np.testing.assert_allclose((d1["w"] + d2["w"]).numpy(),
                               (2 * x["w"] - st2["w"]).numpy(), rtol=0,
                               atol=1e-5)
    # each residual is within half a quantization step of its tile
    rows = ch._to_rows(x["w"] + st1["w"])
    _, s = ops.quantize(rows, 127)
    assert bool((ch._to_rows(st2["w"]).abs()
                 <= 0.5 * s[:, None] * (1 + 1e-6)).all())


# ---------------------------------------------------------------------------
# kernel B's backward: the explicit formulas against jax.grad of mha

@pytest.mark.parametrize("B,Sq,Sk,H,K,D,window", [
    (2, 13, 13, 4, 2, 8, 0),          # GQA, causal
    (1, 9, 21, 6, 3, 16, 7),          # Sq < Sk, a window
    (2, 17, 17, 4, 4, 8, 5),          # MHA, a window
])
def test_flash_backward_plain_matches_jax_grad_of_mha(B, Sq, Sk, H, K, D,
                                                      window):
    rng = np.random.RandomState(Sq + Sk + H)
    q = rng.randn(B, Sq, H, D).astype(np.float32)
    k = rng.randn(B, Sk, K, D).astype(np.float32)
    v = rng.randn(B, Sk, K, D).astype(np.float32)
    do = rng.randn(B, Sq, H, D).astype(np.float32)
    pos_q = jnp.arange(Sq) + (Sk - Sq)
    mask = jlayers.causal_window_mask(pos_q, jnp.arange(Sk),
                                      window or jlayers.BIG_WINDOW)[None, None]

    def loss(q_, k_, v_):
        out = jlayers.mha(q_, k_, v_, mask)
        return jnp.sum(out * jnp.asarray(do).reshape(B, Sq, H * D))

    jg = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_plain(tq, tk, tv, True, window, with_lse=True)
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    got = flash_attention_backward_plain(tq, tk, tv, o, tdo, lse, True,
                                         window)
    for name, g, want in zip("qkv", got, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5, err_msg=f"d{name}")
    # and against the plain forward's own autograd
    ins = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    flash_attention_plain(*ins, True, window).backward(tdo)
    for g, t in zip(got, ins):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), atol=1e-5,
                                   rtol=1e-5)

"""Port parity for the sketch wire codec.

* :mod:`repro_torch.core.threefry` against ``jax.random`` (JAX 0.9.0,
  partitionable threefry, no x64): keys and ``fold_in`` equal, 32-bit
  bits equal bit for bit at seeds 0, 2**31 - 1 and 2**32 + 5 (which JAX
  cuts to the key ``[0, 5]``), several ``(idx, rnd)`` pairs and shapes
  (1280, 8), (37, 3) and (300, 300) (above 2**16 elements); normals
  within 4 float32 ulp.
* The bases against ``repro.core.channel.Channel._basis`` (1e-6), and
  orthonormal.
* ``Channel.encode`` / ``decode`` / ``roundtrip`` / ``roundtrip_tree``
  against the JAX channel, per client and stacked, over leaves of each
  projection mode ("right", "left", "raw"): the sketches and decoded
  leaves at atol 1e-6 / rtol 1e-5, the round carried in the payload, raw
  leaves passed as they are (a bf16 leaf decodes to its dtype within one
  bf16 rounding of the reference's).  The decoded leaf is a projection:
  sketching it again gives it back.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.channel import ChannelSpec as JChannelSpec
from repro_torch.core import threefry
from repro_torch.core.channel import ChannelSpec, TensorSpec

torch.set_num_threads(1)

SEEDS = (0, 2**31 - 1, 2**32 + 5)
PAIRS = ((0, 0), (3, 1), (11, 7), (5, 123456))
SHAPES = ((1280, 8), (37, 3), (300, 300))
NORMAL_ULP = 4
TOL = dict(atol=1e-6, rtol=1e-5)


def _jkey(seed, idx, rnd):
    return jax.random.fold_in(jax.random.fold_in(jax.random.key(seed), idx),
                              jnp.asarray(rnd, jnp.int32))


def _key(seed, idx, rnd):
    return threefry.fold_in(threefry.fold_in(threefry.key(seed), idx), rnd)


def _ulp(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in_equal_jax(seed):
    np.testing.assert_array_equal(
        threefry.key(seed), np.asarray(jax.random.key_data(
            jax.random.key(seed))))
    for idx, rnd in PAIRS:
        np.testing.assert_array_equal(
            _key(seed, idx, rnd),
            np.asarray(jax.random.key_data(_jkey(seed, idx, rnd))))
    if seed == 2**32 + 5:
        np.testing.assert_array_equal(threefry.key(seed), [0, 5])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_equal_jax_bit_for_bit(seed, shape):
    for idx, rnd in PAIRS:
        got = threefry.random_bits(_key(seed, idx, rnd), shape)
        want = np.asarray(jax.random.bits(_jkey(seed, idx, rnd), shape,
                                          jnp.uint32))
        assert got.dtype == np.uint32 and got.shape == shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("seed", SEEDS)
def test_normals_within_four_ulp_of_jax(seed, shape):
    for idx, rnd in PAIRS:
        got = threefry.normal(_key(seed, idx, rnd), shape)
        want = np.asarray(jax.random.normal(_jkey(seed, idx, rnd), shape,
                                            jnp.float32))
        assert got.dtype == np.float32
        assert _ulp(got, want) <= NORMAL_ULP


@pytest.mark.parametrize("dim,idx,rnd", [(1280, 0, 0), (1280, 3, 2),
                                         (46080, 1, 5), (37, 2, 1)])
def test_bases_match_reference(dim, idx, rnd):
    ch = ChannelSpec(codec="sketch", sketch_rank=8, seed=7).make()
    jch = JChannelSpec(codec="sketch", sketch_rank=8, seed=7).make()
    q = ch._basis(dim, idx, rnd, "cpu")
    want = np.asarray(jch._basis(dim, idx, jnp.asarray(rnd, jnp.int32)))
    assert q.dtype == torch.float32 and tuple(q.shape) == (dim, 8)
    np.testing.assert_allclose(q.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose((q.T @ q).numpy(), np.eye(8), rtol=0,
                               atol=1e-5)
    # cached for the round, replaced when the round moves on
    assert ch._basis(dim, idx, rnd, "cpu") is q
    ch._basis(dim, idx, rnd + 1, "cpu")
    assert all(k[2] == rnd + 1 for k in ch._bases)


# ---------------------------------------------------------------------------
# the codec against the reference's

RANK = 4
LEAVES = {                                   # (per-client shape, dtype)
    "layers/attn/wq_lora_a": ((2, 48, 4), torch.float32),    # left
    "layers/attn/wq_lora_b": ((2, 4, 48), torch.float32),    # right
    "layers/attn/wo_lora_a": ((2, 2, 3), torch.float32),     # raw
    "layers/mlp/w1_lora_b": ((7, 5), torch.bfloat16),        # right, bf16
    "connector/b": ((6,), torch.float32),                    # raw (1-D)
}
MODES = {"layers/attn/wq_lora_a": "left", "layers/attn/wq_lora_b": "right",
         "layers/attn/wo_lora_a": "raw", "layers/mlp/w1_lora_b": "right",
         "connector/b": "raw"}
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def uploads(n, seed):
    rng = np.random.RandomState(seed)
    flat = {k: (rng.randn(n, *shape) * 0.05).astype(np.float32)
            for k, (shape, _) in LEAVES.items()}
    t = {k: torch.from_numpy(v).to(LEAVES[k][1]) for k, v in flat.items()}
    j = {k: jnp.asarray(v).astype(_JDT[LEAVES[k][1]])
         for k, v in flat.items()}
    return t, j


def codecs(seed=3):
    kw = dict(codec="sketch", sketch_rank=RANK, seed=seed)
    return ChannelSpec(**kw).make(), JChannelSpec(**kw).make()


def assert_decoded(got, want):
    """Decoded leaves at TOL; a bf16 leaf within one bf16 rounding of its
    value (an f32 result a hair either side of a rounding boundary)."""
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        w = np.asarray(want[k], np.float32)
        assert tuple(v.shape) == w.shape and v.dtype == LEAVES[k][1], k
        tol = dict(TOL)
        if v.dtype == torch.bfloat16:
            tol["atol"] = TOL["atol"] + float(np.abs(w).max()) * 2.0**-8
        np.testing.assert_allclose(v.float().numpy(), w, err_msg=k, **tol)


@pytest.mark.parametrize("n", [1, 3], ids=["per-client", "stacked"])
def test_encode_and_decode_match_reference(n):
    ch, jch = codecs()
    like = {k: TensorSpec((n, *shape), dt)
            for k, (shape, dt) in LEAVES.items()}
    jlike = {k: jax.ShapeDtypeStruct((n, *shape), _JDT[dt])
             for k, (shape, dt) in LEAVES.items()}
    for rnd in (0, 4):
        t, j = uploads(n, rnd)
        payload, st = ch.encode(t, None, rnd)
        jpayload, _ = jch.encode(j, None, rnd)
        assert st == {} and sorted(payload) == sorted(jpayload)
        for k, mode in MODES.items():
            if mode == "raw":
                assert payload[k]["raw"] is t[k]
                continue
            got, want = payload[k]["s"], np.asarray(jpayload[k]["s"])
            m, d = int(np.prod(LEAVES[k][0][:-1])), LEAVES[k][0][-1]
            assert tuple(got.shape) == ((n, m, RANK) if mode == "right"
                                        else (n, RANK, d)), k
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, err_msg=k, **TOL)
            assert int(payload[k]["rnd"]) == int(jpayload[k]["rnd"]) == rnd
        assert_decoded(ch.decode(payload, like), jch.decode(jpayload, jlike))
        dec, _ = ch.roundtrip(t, None, rnd)
        jdec, _ = jch.roundtrip(j, None, rnd)
        assert_decoded(dec, jdec)
        assert ch.bytes_on_wire(like) == jch.bytes_on_wire(jlike)


def test_roundtrip_tree_matches_reference():
    """The downlink: one unstacked tree through the codec."""
    ch, jch = codecs(seed=0)
    t, j = uploads(1, 9)
    tree = {k: v[0] for k, v in t.items()}
    got = ch.roundtrip_tree(tree, 2)
    want = jch.roundtrip_tree({k: v[0] for k, v in j.items()}, 2)
    assert_decoded({k: v[None] for k, v in got.items()},
                   {k: np.asarray(v, np.float32)[None]
                    for k, v in want.items()})
    assert torch.equal(got["connector/b"], tree["connector/b"])


def test_decoded_leaf_is_a_projection():
    """Each projected leaf decodes onto the round's basis: sketching the
    decoded leaf again in the same round gives it back (f32, 1e-5); in
    another round it does not."""
    ch, _ = codecs()
    t, _ = uploads(3, 1)
    t = {k: v.float() for k, v in t.items()}
    dec, _ = ch.roundtrip(t, None, 6)
    again, _ = ch.roundtrip(dec, None, 6)
    other, _ = ch.roundtrip(dec, None, 7)
    for k, mode in MODES.items():
        torch.testing.assert_close(again[k], dec[k], atol=1e-5, rtol=0)
        if mode != "raw":
            assert not torch.allclose(dec[k], t[k], atol=1e-3)
            assert not torch.allclose(other[k], dec[k], atol=1e-4)

"""The communication channel: one wire format for every tree that crosses
the edge-cloud boundary (port of ``repro.core.channel``).

Uplink (client -> server LoRA uploads) and downlink (server -> client
redistribution) traffic goes through :meth:`Channel.encode` /
:meth:`Channel.decode`, and :meth:`Channel.bytes_on_wire` gives the exact
byte count of a payload.

Codecs (:class:`ChannelSpec.codec`):

* ``"identity"``: uploads pass through untouched.
* ``"int8"`` / ``"int4"``: per-tile symmetric abs-max quantization.  Each
  leaf is flattened per client, zero-padded to a multiple of ``block``,
  and every ``block``-wide tile is quantized against its own abs-max by
  the kernel pair behind :func:`repro_torch.kernels.ops.quantize` /
  ``dequantize``.  int4 codes are held in int8 tensors, but
  :meth:`bytes_on_wire` counts packed nibbles.  With ``error_feedback``
  each client keeps an f32 residual ``e``, transmits ``Q(u + e)`` and
  carries ``e' = (u + e) - deQ(Q(u + e))`` to the next round.
* ``"sketch"``: accepted by :class:`ChannelSpec` and counted by
  :meth:`bytes_on_wire`, but not ported: its bases come from JAX's
  threefry generator, so :meth:`encode` / :meth:`decode` raise
  ``NotImplementedError``.

Tiles never cross the client axis, so encoding a stacked ``(N, ...)``
upload equals encoding each client alone.  Encoding and decoding keep the
reference's op sequence and its sorted key order, which makes the port's
codes and residuals bit-equal to the reference's on the same inputs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ops

CODECS = ("identity", "int8", "int4", "sketch")

_QMAX = {"int8": 127, "int4": 7}


class TensorSpec(NamedTuple):
    """Shape and dtype of a stacked upload leaf (a template that holds no
    data, like the reference's ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """Wire-codec selection, validated at construction.

    * ``codec``: one of ``identity | int8 | int4 | sketch``.
    * ``block``: quantization tile width; one f32 scale crosses the wire
      per ``block`` elements (per client, per leaf).
    * ``error_feedback``: per-client f32 residuals for the quantized
      codecs (ignored by ``identity`` / ``sketch``).
    * ``sketch_rank``: rank of the sketch re-projection.
    * ``seed``: seed of the sketch basis stream.
    """

    codec: str = "identity"
    block: int = 128
    error_feedback: bool = True
    sketch_rank: int = 8
    seed: int = 0

    def __post_init__(self):
        if self.codec not in CODECS:
            raise ValueError(
                f"unknown codec {self.codec!r}; expected one of {CODECS}")
        if self.block < 1:
            raise ValueError(f"block must be >= 1; got {self.block}")
        if self.sketch_rank < 1:
            raise ValueError(
                f"sketch_rank must be >= 1; got {self.sketch_rank}")

    def make(self) -> "Channel":
        """The runtime codec for this spec."""
        return Channel(self)


def _leaf_dims(shape) -> Tuple[int, int]:
    """(N, L): leading client axis and flattened per-client length."""
    return int(shape[0]), math.prod(int(d) for d in shape[1:])


class Channel:
    """Runtime wire codec over flat ``{key: (N, ...)}`` upload dicts.

    The leading axis is the client axis; the downlink multicast wraps its
    single tree with :meth:`roundtrip_tree`."""

    def __init__(self, spec: ChannelSpec):
        self.spec = spec

    @property
    def is_identity(self) -> bool:
        """True for the pass-through codec."""
        return self.spec.codec == "identity"

    @property
    def stateful(self) -> bool:
        """True when the codec carries per-client error-feedback residuals
        between rounds (quantized codecs with EF on)."""
        return self.spec.codec in _QMAX and self.spec.error_feedback

    def init_state(self, like: Dict, device=None) -> Dict:
        """Zero f32 error-feedback residuals shaped like the stacked
        upload templates (empty for stateless codecs)."""
        if not self.stateful:
            return {}
        return {k: torch.zeros(tuple(v.shape), dtype=torch.float32,
                               device=device) for k, v in like.items()}

    # -- tiling (quantized codecs) -------------------------------------
    def _tiles(self, ell: int) -> int:
        return -(-ell // self.spec.block)

    def _to_rows(self, u):
        """(N, ...) f32 -> (N*T, block) tile rows, zero-padded per client."""
        n, ell = _leaf_dims(u.shape)
        t = self._tiles(ell)
        rows = u.reshape(n, ell)
        pad = t * self.spec.block - ell
        if pad:
            rows = torch.cat([rows, rows.new_zeros((n, pad))], dim=1)
        return rows.reshape(n * t, self.spec.block).contiguous()

    def _from_rows(self, rows, shape):
        """Inverse of :meth:`_to_rows` back to ``shape`` (still f32)."""
        n, ell = _leaf_dims(shape)
        t = self._tiles(ell)
        return rows.reshape(n, t * self.spec.block)[:, :ell].reshape(shape)

    def _refuse_sketch(self):
        raise NotImplementedError(
            "the sketch codec is not ported (its bases come from JAX's "
            "threefry generator); use identity, int8 or int4")

    # -- encode / decode -------------------------------------------------
    def encode(self, flat: Dict, state: Optional[Dict] = None, rnd=0
               ) -> Tuple[Dict, Dict]:
        """Encode a stacked upload dict -> ``(payload, new_state)``.

        ``state`` is the per-client error-feedback residual dict (``None``
        or ``{}`` disables EF: the downlink mode).  ``rnd`` is the round
        index, which only the sketch codec reads."""
        codec = self.spec.codec
        if codec == "identity":
            return flat, (state if state is not None else {})
        if codec == "sketch":
            self._refuse_sketch()
        return self._encode_quant(flat, state, _QMAX[codec])

    def _encode_quant(self, flat, state, qmax):
        ef = self.stateful and bool(state)
        payload, new_state = {}, {}
        for k in sorted(flat):
            u = flat[k].float()
            if ef:
                u = u + state[k]
            q, s = ops.quantize(self._to_rows(u), qmax)
            payload[k] = {"q": q, "s": s}
            if ef:
                new_state[k] = u - self._from_rows(ops.dequantize(q, s),
                                                   u.shape)
        return payload, (new_state if ef else
                         (state if state is not None else {}))

    def decode(self, payload: Dict, like: Dict) -> Dict:
        """Decode a payload back to dense leaves.  ``like`` maps each key to
        a tensor or :class:`TensorSpec` with the original stacked shape and
        dtype."""
        codec = self.spec.codec
        if codec == "identity":
            return payload
        if codec == "sketch":
            self._refuse_sketch()
        out = {}
        for k in sorted(payload):
            tmpl = like[k]
            rows = ops.dequantize(payload[k]["q"], payload[k]["s"])
            out[k] = self._from_rows(rows, tuple(tmpl.shape)).to(tmpl.dtype)
        return out

    def roundtrip(self, flat: Dict, state: Optional[Dict] = None, rnd=0
                  ) -> Tuple[Dict, Dict]:
        """encode -> decode: what the server receives for a stacked
        upload, and the advanced error-feedback state."""
        like = {k: TensorSpec(tuple(v.shape), v.dtype)
                for k, v in flat.items()}
        payload, new_state = self.encode(flat, state, rnd)
        return self.decode(payload, like), new_state

    def roundtrip_tree(self, tree: Dict, rnd=0) -> Dict:
        """Stateless encode -> decode of a single (unstacked) tree: the
        downlink multicast, one payload for the whole cohort."""
        if self.is_identity:
            return tree
        flat = {k: v[None] for k, v in tree.items()}
        dec, _ = self.roundtrip(flat, None, rnd)
        return {k: v[0] for k, v in dec.items()}

    # -- accounting -------------------------------------------------------
    def _sketch_mode(self, shape) -> str:
        """'right' (project the last dim), 'left' (the stacked middle
        dims) or 'raw' (nothing exceeds the rank)."""
        if len(shape) < 3:
            return "raw"
        m = math.prod(int(d) for d in shape[1:-1])
        n = int(shape[-1])
        r = self.spec.sketch_rank
        if n > r:
            return "right"
        if m > r:
            return "left"
        return "raw"

    def bytes_on_wire(self, like: Dict) -> int:
        """Exact wire bytes for encoding ``like`` (tensors or templates
        with the stacked client axis): int8 = one byte per element + one
        f32 scale per tile; int4 = packed nibbles (``ceil(L/2)`` bytes) +
        scales; sketch = f32 sketch entries for projected leaves, dense
        bytes for pass-through leaves; identity = the dense leaf bytes.
        Every term is linear in the client axis."""
        codec = self.spec.codec
        total = 0
        for tmpl in like.values():
            shape = tuple(tmpl.shape)
            n, ell = _leaf_dims(shape)
            dense = n * ell * tmpl.dtype.itemsize
            if codec == "identity":
                total += dense
            elif codec == "int8":
                total += n * (ell + 4 * self._tiles(ell))
            elif codec == "int4":
                total += n * (-(-ell // 2) + 4 * self._tiles(ell))
            else:
                mode = self._sketch_mode(shape)
                if mode == "raw":
                    total += dense
                else:
                    m = math.prod(shape[1:-1])
                    r = self.spec.sketch_rank
                    total += n * 4 * (m * r if mode == "right"
                                      else r * shape[-1])
        return int(total)

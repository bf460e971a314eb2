"""FaultSchedule — the per-round realization of a :class:`FaultSpec`
(a numpy copy of ``repro.core.faults``; the draws are bit-identical).

All randomness is host-side numpy, seeded from ``(spec.seed, round)``
only, so the schedule is a pure function of the round index and touches
none of the init or shuffle streams.  The Byzantine set is drawn once.
Straggle events persist: an event starting at round ``r0`` with delay
``d`` keeps the client's uploads out of rounds ``r0 .. r0+d-1``;
:meth:`FaultSchedule.round_masks` replays the last ``max_delay`` rounds'
draws, so no state is carried.  Every round has at least one present,
on-time client (the mass MMA renormalizes over is never empty).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.spec import FaultSpec


class FaultSchedule:
    """Per-round (present, ontime) masks + the fixed Byzantine set for a
    federation of ``n`` clients (global client order)."""

    def __init__(self, spec: FaultSpec, n: int):
        self.spec = spec
        self.n = int(n)
        rng = np.random.default_rng([spec.seed, 0xB12A17])
        n_byz = int(round(spec.byzantine * self.n))
        byz = np.zeros(self.n, bool)
        byz[rng.permutation(self.n)[:n_byz]] = True
        self.byzantine = byz

    def _draws(self, rnd: int):
        """Round ``rnd``'s raw uniforms and delays (stateless)."""
        rng = np.random.default_rng([self.spec.seed, 0xF0A17, int(rnd)])
        u_drop = rng.random(self.n)
        u_strag = rng.random(self.n)
        delays = rng.integers(1, self.spec.max_delay + 1, size=self.n)
        pick = int(rng.integers(self.n))
        return u_drop, u_strag, delays, pick

    def round_masks(self, rnd: int) -> Tuple[np.ndarray, np.ndarray]:
        """``(present, ontime)`` bool masks for round ``rnd``: ``present``
        gates training and redistribution, ``ontime`` only the upload; the
        aggregation mass is ``present & ontime``, never empty."""
        spec = self.spec
        u_drop, _, _, pick = self._draws(rnd)
        present = u_drop >= spec.dropout
        late = np.zeros(self.n, bool)
        if spec.straggler > 0.0:
            for r0 in range(max(0, rnd - spec.max_delay + 1), rnd + 1):
                _, u_strag, delays, _ = self._draws(r0)
                late |= (u_strag < spec.straggler) & (r0 + delays > rnd)
        ontime = ~late
        if not (present & ontime).any():
            present[pick] = True
            ontime[pick] = True
        return present, ontime

"""The comparison that decides ``correct``: the program's readings against
the plain reference's, three numbers, each against its limit.

* ``loss_gap``: every step's loss in the rounds followed (each client's
  CCL and AMT losses, the server's SE-CCL losses and KT terms);
* ``grad_gap``: the norm of each trainable leaf's first gradient as the
  optimizer took it, read from its AdamW first moment right after the
  leaf's model took its first step (0.1 times the clipped gradient);
* ``moment_gap``: the norm of each trainable leaf's AdamW first moment
  after the first round (each client's two steps, the server's one);
* ``change_gap``: the norm of each trainable leaf's change over the
  rounds followed;
* ``first_loss_gap``: the losses of each model's first step alone;
  ``grad_median_gap`` and ``change_median_gap``: the median leaf's gap of
  the two leaf numbers (steady from seed to seed where the worst leaf's
  swings).

Each is the worst entry's gap |program - reference| measured against the
reference's value of that entry or the median entry, whichever is larger.
A leaf whose reference first moment lies under a thousandth of the median
leaf's (a gradient that is nought to rounding, which Adam turns into
steps of round-off: the soft-prompt leaves of an SSD model, whose state
has forgotten the prefix by the template) is left out of both leaf
numbers.  A missing or non-finite entry reads infinite.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, Tuple

NEGLIGIBLE = 1e-3


def negligible(moments: Dict[str, float]) -> set:
    """The leaves whose reference gradient is nought to rounding."""
    med = statistics.median(abs(v) for v in moments.values())
    return {k for k, v in moments.items() if abs(v) < NEGLIGIBLE * med}


def gaps(prog: Dict[str, float], ref: Dict[str, float],
         skip=frozenset()) -> Dict[str, float]:
    """Each entry's gap, leaving out ``skip``; a missing or non-finite
    entry's is infinite."""
    med = statistics.median(abs(v) for k, v in ref.items() if k not in skip)
    out = {}
    for k, r in ref.items():
        if k in skip:
            continue
        p = prog.get(k)
        if p is None or not math.isfinite(p) or not math.isfinite(r):
            out[k] = math.inf
        else:
            out[k] = abs(p - r) / max(abs(r), med, 1e-30)
    return out


def _first_losses(losses: Dict[str, float]) -> Dict[str, float]:
    """The losses of each model's first step: each cohort's first local
    step of round 0 (its CCL step where it takes one) and the server's
    first SE-CCL step."""
    def first(r, who, step):
        if r != "r0":
            return False
        if who.startswith("server"):
            return who == "server0"
        ccl = any(k.startswith(f"r0/{who}/ccl0/") for k in losses)
        return step == ("ccl0" if ccl else "amt0")
    return {k: v for k, v in losses.items() if first(*k.split("/")[:3])}


def readings(prog: Dict[str, Dict], ref: Dict[str, Dict]) -> Dict:
    """{number: {"value", "entry", "entries"}} from both sides' "losses",
    "moments" and "changes"."""
    out = {}
    tiny = negligible(ref["moments"])
    first = {"prog": _first_losses(prog["losses"]),
             "ref": _first_losses(ref["losses"])}
    for name, pv, rv, skip in (
            ("loss_gap", prog["losses"], ref["losses"], frozenset()),
            ("first_loss_gap", first["prog"], first["ref"], frozenset()),
            ("grad_gap", prog["first"], ref["first"],
             negligible(ref["first"])),
            ("moment_gap", prog["moments"], ref["moments"], tiny),
            ("change_gap", prog["changes"], ref["changes"], tiny)):
        g = gaps(pv, rv, skip)
        where = max(g, key=g.get)
        out[name] = {"value": g[where], "entry": where, "entries": len(g)}
        if name in ("grad_gap", "change_gap"):
            out[name.replace("_gap", "_median_gap")] = {
                "value": statistics.median(g.values()), "entry": None,
                "entries": len(g)}
    return out


def decide(read: Dict, limits: Dict) -> Tuple[bool, Dict]:
    """(correct, {number: {"value", "limit"}}): every compared number at
    or under its limit; a number whose limit is null is reported and not
    compared."""
    checks, ok = {}, True
    for name, r in read.items():
        lim = limits.get(name)
        checks[name] = {"value": r["value"], "limit": lim}
        if lim is not None and not r["value"] <= lim:
            ok = False
    return ok, checks

"""The comparison that decides ``correct`` for a training cell.

Both sides give the same readings of the first three steps from one
initial state on the same batches and draws:

  loss1   the first step's loss (the forward pass's precision alone),
  loss    each step's loss,
  grad1   each leaf's norm of the first gradient as the optimizer got it
          (clipped), the program's worked out from its optimizer state
          after one step,
  delta3  each leaf's norm of the parameters' change after three steps.

Each number compared is the worst over steps or leaves: for a loss
|program - reference| / |reference|, for a leaf |norm_p - norm_r| /
max(norm_r, the median leaf's norm_r). Leaves whose reference gradient is
under ``ZERO_SHARE`` of the median leaf's move by round-off alone (a bias
under a softmax) and are left out of grad1 and delta3, by that rule and not
by name.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Tuple

ZERO_SHARE = 1e-3
NAMES = ("loss1", "loss", "grad1", "delta3")


def _gap(p: float, r: float, scale: float) -> float:
    if not (math.isfinite(p) and math.isfinite(r)):
        return math.inf
    return abs(p - r) / scale if scale > 0 else (0.0 if p == r else math.inf)


def counted_leaves(ref: Dict) -> list:
    """The leaves whose reference gradient is not nought to rounding."""
    g = ref["grad1"]
    med = statistics.median(g.values())
    return sorted(k for k, v in g.items() if v >= ZERO_SHARE * med)


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], leaves):
    med = statistics.median(ref[k] for k in leaves)
    worst, at = -1.0, None
    for k in leaves:
        gap = _gap(prog.get(k, math.nan), ref[k], max(ref[k], med))
        if gap > worst:
            worst, at = gap, k
    return worst, at


def numbers(prog: Dict, ref: Dict) -> Dict[str, Tuple[float, str]]:
    """{name: (number, where)} of the readings compared."""
    leaves = counted_leaves(ref)
    loss = [(_gap(p, r, abs(r)), "step {}".format(i + 1))
            for i, (p, r) in enumerate(zip(prog["loss"], ref["loss"]))]
    if len(prog["loss"]) != len(ref["loss"]):
        loss.append((math.inf, "steps differ"))
    out = {"loss1": loss[0], "loss": max(loss)}
    for name in ("grad1", "delta3"):
        out[name] = worst_leaf(prog[name], ref[name], leaves)
    return out


def judge(nums: Dict[str, Tuple[float, str]], limits: Dict[str, float]):
    """(correct, {name: [number, limit]}): every number within its limit."""
    checks = {k: [nums[k][0], limits[k]] for k in NAMES}
    ok = all(math.isfinite(v) and v <= lim for v, lim in checks.values())
    return ok, checks

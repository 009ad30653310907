"""The output check: the program's first three gradient ticks against the
reference's, in three numbers.

  * ``first_loss_gap`` the relative gap between the program's and the
    reference's mean worker loss at the first tick (the weights as made;
    later ticks carry each side's rounding forward, and on the ResNet
    their gaps reach what the TF32 control reads, so they are not
    compared);
  * ``grad_gap``   the first gradient, as the program's state shows it
    ((x0 - x1) / gamma), against the reference's, by the worst leaf of
    the worst worker: the gap between the two norms, over the reference's
    norm of that leaf or its median leaf's, whichever is larger;
  * ``change_gap`` the same of each buffer's change after three ticks
    (x3 - x0 and x~3 - x0), over both buffers.

A leaf is left out of the two leaf numbers where its float32 state cannot
show its step: with a the norm of the leaf's float32 spacing at x0 over
gamma times its first reference gradient's norm, a reading of the step's
norm from the state is off by about a / sqrt(12 n) + a^2 / 24 (rounding
to the nearest of n values); a leaf where that is over ``READ_NOISE`` (a
GroupNorm scale at 1 moved by 1e-5 keeps 7 of its bits), or whose
gradient is 0 (a leaf the model never reads), is left out.  The losses
cover them.
"""
from __future__ import annotations

import numpy as np

NAMES = ("first_loss_gap", "grad_gap", "change_gap")
# the largest error of reading a leaf's step from its float32 state that a
# leaf number takes
READ_NOISE = 1e-4


def _worst(prog: dict, ref: dict, keep) -> tuple[float, str]:
    """Worst leaf gap of {path: (W,) norms} and its path, per worker
    against the larger of the leaf's reference norm and the median
    leaf's, over the leaves ``keep`` ((leaves, W) bool) holds."""
    paths = sorted(ref)
    r = np.stack([ref[p] for p in paths])           # (leaves, W)
    p = np.stack([prog[p] for p in paths])
    scale = np.maximum(r, np.median(r, axis=0, keepdims=True))
    gap = np.where(keep, np.abs(p - r) / np.where(scale > 0, scale, 1.0),
                   0.0)
    leaf = int(np.argmax(gap.max(axis=1)))
    return float(gap.max()), paths[leaf]


def compare(prog: dict, ref: dict) -> tuple[dict, dict]:
    """The three numbers of ``prog`` against ``ref``, and the leaf each
    leaf number was read at.  ``prog`` holds ``loss`` (3,), ``grad``,
    ``change_x``, ``change_xt`` ({path: (W,)}); ``ref`` the same,
    ``resolution`` ({path: the norm of the leaf's float32 spacing at x0
    over gamma}) and ``size`` ({path: elements})."""
    lp, lr = np.asarray(prog["loss"]), np.asarray(ref["loss"])
    paths = sorted(ref["grad"])
    keep = []
    for p in paths:
        g = ref["grad"][p]
        a = ref["resolution"][p] / np.where(g > 0, g, 1.0)
        noise = a / np.sqrt(12 * ref["size"][p]) + a * a / 24
        keep.append((g > 0) & (noise <= READ_NOISE))
    keep = np.stack(keep)

    grad = _worst(prog["grad"], ref["grad"], keep)
    change = max(_worst(prog["change_x"], ref["change_x"], keep),
                 _worst(prog["change_xt"], ref["change_xt"], keep))
    return ({"first_loss_gap": float(abs(lp[0] - lr[0]) / abs(lr[0])),
             "grad_gap": grad[0], "change_gap": change[0]},
            {"grad_gap": grad[1], "change_gap": change[1],
             "left_out": [p for p, k in zip(paths, keep) if not k.all()]})


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """True when every number is finite and within its limit."""
    return all(np.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in NAMES)

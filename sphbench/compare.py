"""The comparison that decides ``correct``: the program's answers against
the reference's, as a few numbers, each held to a limit of its own.

- ``map_max_rel``: the widest gap of a projected map, max |a - b| / max |b|,
  over its pixels;
- ``map_l1_rel``: the summed gap of a projected map, sum |a - b| / sum |b|;
- ``block_l1_rel``: the worst block of a projected map, over its blocks of
  ``BLOCK`` x ``BLOCK`` pixels, of the block's summed gap over the larger of
  the block's own reference sum and the median block's: a wrong tile or a
  wrong pixel, which the summed gap of a whole map dilutes, while the
  placement noise of float32 coordinates averages out within a block;
- ``mean_l1_rel``: the summed gap of a derived ``mean_*`` map, each pixel
  weighted by the reference's surface density there (a mean over a pixel
  that only a support's far edge reaches divides two numbers near zero).

Each is the worst over the maps of every answer compared. A map that is
missing, of another shape or not finite reads infinity.
"""

from __future__ import annotations

import math

import numpy as np

NUMBERS = ("map_max_rel", "map_l1_rel", "block_l1_rel", "mean_l1_rel")
#: the side of ``block_l1_rel``'s blocks, in pixels
BLOCK = 32


def _block_sums(m: np.ndarray) -> np.ndarray:
    """Sums over the BLOCK x BLOCK blocks of a map (a ragged edge is a
    block of its own)."""
    ny, nx = m.shape
    by, bx = -(-ny // BLOCK), -(-nx // BLOCK)
    padded = np.zeros((by * BLOCK, bx * BLOCK))
    padded[:ny, :nx] = m
    return padded.reshape(by, BLOCK, bx, BLOCK).sum(axis=(1, 3))


def block_gap(a, b) -> float:
    """``block_l1_rel`` of one map ``a`` against its reference ``b``."""
    if a is None or np.shape(a) != np.shape(b) or not np.isfinite(a).all():
        return math.inf
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    gap, ref = _block_sums(np.abs(a - b)), _block_sums(np.abs(b))
    return float((gap / np.maximum(np.maximum(ref, np.median(ref)), 1e-300)).max())


def _gaps(a, b, weight=None) -> tuple:
    if a is None or np.shape(a) != np.shape(b) or not np.isfinite(a).all():
        return math.inf, math.inf
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    diff = np.abs(a - b)
    if weight is not None:
        return math.inf, float((weight * diff).sum() / max((weight * np.abs(b)).sum(), 1e-300))
    return float(diff.max() / max(np.abs(b).max(), 1e-300)), float(diff.sum() / max(np.abs(b).sum(), 1e-300))


def numbers(answers: list, reference: list) -> dict:
    """The compared numbers of one product's answers (a list of {map name:
    map}) against the reference's answers, in the same order."""
    out = dict.fromkeys(NUMBERS, 0.0)
    if len(answers) != len(reference):
        return dict.fromkeys(NUMBERS, math.inf)
    for got, ref in zip(answers, reference):
        sd = np.asarray(ref["surface_density"], np.float64)
        for name, b in ref.items():
            a = got.get(name)
            if name.startswith("mean_"):
                out["mean_l1_rel"] = max(out["mean_l1_rel"], _gaps(a, b, sd)[1])
            else:
                widest, summed = _gaps(a, b)
                out["map_max_rel"] = max(out["map_max_rel"], widest)
                out["map_l1_rel"] = max(out["map_l1_rel"], summed)
                out["block_l1_rel"] = max(out["block_l1_rel"], block_gap(a, b))
    return out


def worst(readings: list) -> dict:
    """Each number's worst over several products' readings."""
    return {k: max(r[k] for r in readings) for k in NUMBERS} if readings else dict.fromkeys(NUMBERS, math.inf)


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {number: {"value", "limit"}}) for the numbers that have a
    limit. A number above its limit, or not finite, is not correct."""
    checks = {k: {"value": values.get(k, math.inf), "limit": float(lim)} for k, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks

"""Products that stand in the program's place to show that the comparison
fails them: the control, and the faults a map cell can have.

Each is an entry ``setup(ctx)`` for ``harness.run(..., product=...)``.

- ``control``: the reference one precision below the configurations'
  float32 (``reference.scatter``: float32 placement, bfloat16 per-pair
  arithmetic, float32 sums);
- ``unchanged``: the entry's answers with every map left as it was
  initialised (zeros): a step that returns its state unchanged;
- ``half_batch``: the entry on every other particle, each payload doubled:
  half of the batch left out, the mean taken over the rest;
- ``altered``: the entry's answers with one pixel (the centre) of the
  first answer's first map raised by a tenth of that map's maximum: an
  answer altered where it is produced, which ``map_l1_rel`` alone passes;
- ``dropped_tile``: the entry's answers with the emptiest block of
  ``compare.BLOCK`` x ``compare.BLOCK`` pixels of the first answer's first
  map set to 0: a tile of the map lost in a low-density region, which
  ``map_l1_rel`` alone passes as well.

No cell runs on several chips yet, so the fault of an exchange between
chips left out has no cell to break.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sphbench import compare
from sphbench.harness import HERE, load_module


def control(ctx):
    reference = load_module(HERE / "reference" / f"{ctx.config['product']['kind']}.py")

    def call():
        return reference.maps(ctx.inputs, ctx.config, ctx.device, control=True), {}

    return call


def _entry(ctx):
    return load_module(HERE / "entries" / f"{ctx.traffic['entry']}.py").setup


def unchanged(ctx):
    real = _entry(ctx)(ctx)

    def call():
        answers, timings = real()
        return [{k: np.zeros_like(v) for k, v in a.items()} for a in answers], timings

    return call


def half_batch(ctx):
    inputs = dict(ctx.inputs)
    for k, v in ctx.inputs.items():
        if isinstance(v, torch.Tensor) and v.shape[:1] == ctx.inputs["masses"].shape[:1]:
            inputs[k] = v[::2].contiguous()
    inputs["masses"] = 2 * inputs["masses"]
    return _entry(ctx)(dataclasses.replace(ctx, inputs=inputs))


def _first_map_changed(ctx, change):
    """The entry, with ``change`` applied to a copy of the first answer's
    first map."""
    real = _entry(ctx)(ctx)

    def call():
        answers, timings = real()
        first = dict(answers[0])
        name = next(iter(first))
        first[name] = change(np.array(first[name], dtype=np.float64, copy=True))
        return [first] + list(answers[1:]), timings

    return call


def _raise_centre(m):
    m.flat[m.size // 2] += 0.1 * float(np.abs(m).max())
    return m


def _drop_emptiest_block(m):
    b = compare.BLOCK
    sums = compare._block_sums(np.abs(m))
    by, bx = np.unravel_index(int(np.argmin(sums)), sums.shape)
    m[by * b:(by + 1) * b, bx * b:(bx + 1) * b] = 0.0
    return m


def altered(ctx):
    return _first_map_changed(ctx, _raise_centre)


def dropped_tile(ctx):
    return _first_map_changed(ctx, _drop_emptiest_block)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered, "dropped_tile": dropped_tile}

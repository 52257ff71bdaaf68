"""A transfer-function slider: one TF ``field`` dragged in a triangle from
the configuration's value up by ``span`` and back over ``steps`` steps,
from a drawn phase, each value moved by a drawn jitter below
``jitter_steps`` of a step, so that no two edits are equal. Each act is
one ``update_transfer_function``, which rebuilds the occupancy and
distance maps.

``slider`` is a frozen copy (commit 6863543) of
``vkvolume_tpu_torch/bench/session.py``'s ``slider``.
"""

from __future__ import annotations

import dataclasses


def slider(i: int, n: int, span: float) -> float:
    """The slider's offset at step ``i`` of ``n``: a triangle from 0 up to
    ``span`` and back."""
    frac = i / max(n - 1, 1)
    return span * (2 * frac if frac <= 0.5 else 2 * (1 - frac))


class Move:
    edits = True

    def __init__(self, params: dict, rng, scene):
        self.field = params["field"]
        self.span = float(params["span"])
        self.steps = int(params["steps"])
        self.base = float(scene.tf[self.field])
        self.phase = int(rng.integers(self.steps))
        self.jitter = (2.0 * self.span / (self.steps - 1)
                       * float(params["jitter_steps"]))

    def at(self, n: int, rng, scene, warmup: bool):
        k = (self.phase + n) % self.steps
        value = (self.base + slider(k, self.steps, self.span)
                 + float(rng.random()) * self.jitter)
        return dataclasses.replace(scene,
                                   tf=dict(scene.tf, **{self.field: value}))

    def apply(self, engine, volume, scene) -> None:
        setattr(volume.options, self.field, scene.tf[self.field])
        engine.update_transfer_function(volume)

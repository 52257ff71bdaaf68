"""The one traffic generator: it reads a mix's parameters
(``vkbench/traffic/<mix>.json``) and the seed, and gives the interactions
of a closed loop with one interaction in flight.

A mix is data: a list of ``moves``, each naming a kind of interaction
(``vkbench/moves/<kind>.py``, found by name, as the per-layer metrics
are) with its parameters; ``warmup``, the number of set-up interactions;
and ``require_renderer``, null or the renderer every timed frame must
take. A new kind of interaction is a new file under ``moves/``; a new mix
is a new data file; neither edits a file that is there.

An interaction is the ``Scene`` its frame shows (the camera pose, the TF
fields, the volume's model matrix) and the moves that changed the
engine's state for it, which ``run.py`` applies before the frame: each
editing move whose act changed the scene's TF or model matrix. Every
move acts on every interaction, in the mix's order.

A move module defines ``Move(params, rng, scene)`` with
``at(n, rng, scene, warmup) -> Scene`` (the scene of interaction ``n``)
and ``edits`` (whether it changes the engine's state). An editing move
also defines ``apply(engine, volume, scene)``, the calls into the engine
that make its change.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os

import numpy as np

from .pose import Pose

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass(frozen=True)
class Scene:
    pose: Pose | None
    tf: dict               # the volume's TF fields
    model: np.ndarray      # (4, 4): the unit texture cube to world
    aspect: float          # the image's width over its height


@dataclasses.dataclass(frozen=True)
class Interaction:
    scene: Scene
    edits: tuple           # the editing moves that acted, in mix order


def draw(spec, rng) -> float:
    """A parameter: a number is fixed, a pair ``[lo, hi]`` is drawn from
    ``rng`` uniformly."""
    if isinstance(spec, (list, tuple)):
        lo, hi = spec
        return float(lo) if hi == lo else float(rng.uniform(lo, hi))
    return float(spec)


def load_move(kind: str, root: str = ROOT):
    """The module ``vkbench/moves/<kind>.py``."""
    path = os.path.join(root, "vkbench", "moves", f"{kind}.py")
    spec = importlib.util.spec_from_file_location(
        "vkbench_move_" + kind.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Mix:
    """The interactions of one mix for one seed, from ``scene``, the
    configuration's (no pose yet, its TF, its model matrix, its image's
    aspect)."""

    def __init__(self, params: dict, seed: int, scene: Scene,
                 root: str = ROOT):
        self.params = params
        self.seed = int(seed) % (1 << 64)   # numpy takes no negative seed
        self.scene = scene
        self.require_renderer = params.get("require_renderer")
        self.moves = [
            load_move(entry["kind"], root).Move(
                entry, np.random.default_rng((self.seed, 0, i)), scene)
            for i, entry in enumerate(params["moves"])]
        self.edits = any(m.edits for m in self.moves)

    def _run(self, count, warmup: bool):
        tag = 1 if warmup else 2
        rngs = [np.random.default_rng((self.seed, tag, i))
                for i in range(len(self.moves))]
        scene = self.scene
        n = 0
        while count is None or n < count:
            edits = []
            for move, rng in zip(self.moves, rngs):
                before, scene = scene, move.at(n, rng, scene, warmup)
                changed = (scene.tf != before.tf
                           or not np.array_equal(scene.model, before.model))
                if move.edits and changed:
                    edits.append(move)
            yield Interaction(scene, tuple(edits))
            n += 1

    def interactions(self):
        """The window's interactions, as many as the loop asks for."""
        return self._run(None, False)

    def warmup(self) -> list[Interaction]:
        """Set-up's interactions: every move's kind of work, at poses and
        values that each move draws apart from the window's."""
        return list(self._run(int(self.params["warmup"]), True))

"""The camera on an orbit round the volume: the azimuth advances
``azimuth_step_deg`` plus a drawn ``step_offset_deg`` each time the move
acts, from a drawn start ``azimuth_deg``, at ``elevation_deg``; a step of
0 is a still camera. A moving camera never repeats a pose in the window
(checked), so every frame pays its host plan. Its warm-up walks a
revolution at ``warmup_step_deg``, half a step off the start, apart from
the window's poses.
"""

from __future__ import annotations

import dataclasses

from vkbench.generator import draw
from vkbench.pose import orbit_pose


class Move:
    edits = False

    def __init__(self, params: dict, rng, scene):
        self.az0 = draw(params["azimuth_deg"], rng)
        self.step = float(params.get("azimuth_step_deg", 0.0)) + draw(
            params.get("step_offset_deg", 0.0), rng)
        self.elevation = draw(params["elevation_deg"], rng)
        self.warm_step = (float(params.get("warmup_step_deg", 0.0))
                          if self.step else 0.0)
        self.seen: set[float] = set()

    def at(self, n: int, rng, scene, warmup: bool):
        if warmup:
            az = self.az0 + (n + 0.5) * self.warm_step
        else:
            az = self.az0 + n * self.step
            if self.step:
                if az in self.seen:
                    raise RuntimeError(f"orbit pose repeats at {az} deg")
                self.seen.add(az)
        return dataclasses.replace(
            scene, pose=orbit_pose(az, self.elevation, scene.aspect))

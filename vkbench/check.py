"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference (``reference.py``) worked out again from
the volume, the transfer function and the camera.

Three numbers, each with its limit in the configuration's ``check``:

* ``map_cells_differ``: the cells in which the maps the program holds
  (after set-up, and after the window's last edit) differ from the
  reference's occupancy and distance maps for the same TF. Exact: limit 0;
* ``frame_px_gt8_pct``: over the frames kept from the window, the largest
  share (% of the image) of pixels whose colour differs from the
  reference march's by more than 8/255 in some channel. The program's
  w-grid frame resamples a grid image at pixel centres, so it differs from
  a per-ray march by design on a small share of pixels, mostly at
  silhouettes; the limit lies between the program's readings and the
  control's (``PERF.md``);
* ``frame_mean_abs_255``: over the same frames, the largest mean over the
  image of that per-pixel difference, in units of 1/255: it reads a
  fault spread thinly over many pixels, which the share can miss.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference

NAMES = ("map_cells_differ", "frame_px_gt8_pct", "frame_mean_abs_255")


def model_matrix(cfg: dict) -> np.ndarray:
    """The volume's model matrix: its unit texture cube stretched to the
    100-unit cube at the origin (the stretch fit, src/volume_render.cpp:
    224-233)."""
    if cfg["fit"] != "stretch":
        raise ValueError(f"fit {cfg['fit']!r}: only 'stretch'")
    m = np.eye(4)
    m[0, 0] = m[1, 1] = m[2, 2] = 100.0
    return m


def _grad(vol, tfs, dtype):
    if any(t["gradient_max"] != t["gradient_min"] for t in tfs):
        return reference.gradient_map(vol, dtype)
    return None


def _render(vol, grad, scene, cfg: dict, dtype=torch.float32):
    pose = scene.pose
    return reference.render(
        vol, grad, scene.tf, pose.view, pose.proj, scene.model, cfg["width"],
        cfg["height"], clip_distance=cfg["clip_distance"],
        ert=cfg["early_ray_termination"], dtype=dtype)


def readings(vol: torch.Tensor, cfg: dict, maps: list, frames: list
             ) -> dict:
    """The three numbers for ``maps`` [(tf, program maps)] and ``frames``
    [(scene, program colour)] (``generator.Scene``: pose, TF, model
    matrix), and, to show what the frames held, the share of each
    reference frame with alpha above 8/255 (``covered_pct``)."""
    grad = _grad(vol, [t for t, _ in maps] + [s.tf for s, _ in frames],
                 torch.float32)
    differ = 0
    for tf, got in maps:
        want = reference.distance_maps(vol, grad, tf, cfg["block_size"],
                                       cfg["skipmode"])
        if want.shape != got.shape:
            differ = max(differ, want.numel())
        else:
            differ = max(differ, int((want != got.to(want.device)).sum()))
    worst = mean_abs = 0.0
    covered = []
    for scene, color in frames:
        want = _render(vol, grad, scene, cfg)
        diff = (color.to(want.device) - want).abs().amax(-1)
        worst = max(worst, 100.0 * float((diff > 8.0 / 255.0).to(
            torch.float64).mean()))
        mean_abs = max(mean_abs, 255.0 * float(diff.to(torch.float64)
                                               .mean()))
        covered.append(100.0 * float((want[..., 3] > 8.0 / 255.0).to(
            torch.float64).mean()))
    return {"map_cells_differ": differ, "frame_px_gt8_pct": worst,
            "frame_mean_abs_255": mean_abs, "covered_pct": covered}


def control_outputs(vol: torch.Tensor, cfg: dict, maps: list, frames: list,
                    dtype=torch.bfloat16) -> tuple[list, list]:
    """The control: the reference put in the program's place, computed in
    ``dtype`` (bfloat16, the precision below the configuration's
    float32), for the same TFs and scenes."""
    grad = _grad(vol, [t for t, _ in maps] + [s.tf for s, _ in frames],
                 dtype)
    c_maps = [(tf, reference.distance_maps(vol, grad, tf, cfg["block_size"],
                                           cfg["skipmode"], dtype))
              for tf, _ in maps]
    c_frames = [(scene, _render(vol, grad, scene, cfg, dtype))
                for scene, _ in frames]
    return c_maps, c_frames


def verdict(numbers: dict, cfg: dict) -> bool:
    return all(numbers[k] <= cfg["check"][k] for k in NAMES)

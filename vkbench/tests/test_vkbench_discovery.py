"""A configuration, a traffic mix with a new kind of interaction, a
per-layer metric and a cell added as files are found by name: no file of
the harness changes."""

import json
import os
import shutil

from vkbench import check, generator, run

TUMBLE = '''
import dataclasses

from vkbench.generator import draw
from vkbench.pose import orbit_pose


class Move:
    """The camera dragged up and down: the elevation walks a triangle
    between the two ends, at a drawn azimuth."""
    edits = False

    def __init__(self, params, rng, scene):
        self.lo, self.hi = params["elevation_deg"]
        self.steps = int(params["steps"])
        self.azimuth = draw(params["azimuth_deg"], rng)

    def at(self, n, rng, scene, warmup):
        k = n % (2 * self.steps)
        frac = (k if k <= self.steps else 2 * self.steps - k) / self.steps
        el = self.lo + (self.hi - self.lo) * frac
        return dataclasses.replace(
            scene, pose=orbit_pose(self.azimuth, el, scene.aspect))
'''


def test_new_files_found_by_name(tmp_path):
    root = tmp_path
    for kind in ("configs", "traffic", "metrics", "moves"):
        os.makedirs(root / "vkbench" / kind)
    manifest = run.load_manifest()
    cfg = run.load_config("beetle-tfa-aniso")
    cfg.update(name="beetle-tfa-block", skipmode=1,
               tf=dict(cfg["tf"], intensity_min=0.1))
    (root / "vkbench" / "configs" / "beetle-tfa-block.json").write_text(
        json.dumps(cfg))
    (root / "vkbench" / "moves" / "tumble.py").write_text(TUMBLE)
    mix = {"moves": [
        {"kind": "tumble", "elevation_deg": [5.0, 60.0], "steps": 11,
         "azimuth_deg": [20.0, 40.0]},
        {"kind": "slider", "field": "intensity_min", "span": 0.1,
         "steps": 8, "jitter_steps": 1.0}],
        "require_renderer": None, "warmup": 2}
    (root / "vkbench" / "traffic" / "tumble_edit.json").write_text(
        json.dumps(mix))
    (root / "vkbench" / "metrics" / "frames_traced.py").write_text(
        "def read(trace):\n"
        "    n = trace.count('vkbench.render')\n"
        "    return n or None\n")
    manifest["configs"].append({
        "name": "beetle-tfa-block", "source": cfg["source"],
        "file": "vkbench/configs/beetle-tfa-block.json", "reduced": [],
        "why": "block skipping"})
    manifest["workloads"].append({
        "name": "beetle-tfa-block.tumble_edit",
        "config": "beetle-tfa-block", "traffic": "tumble_edit",
        "chips": 1, "why": "elevation drags, a TF edit with each"})
    manifest["per_layer"].append({
        "name": "frames_traced", "unit": "frames", "better": "higher",
        "source": "program_counter", "layer": "engine and host plan",
        "moves": "fps", "workloads": ["beetle-tfa-block.tumble_edit"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    for kind in ("metrics", "moves"):
        for name in os.listdir(os.path.join(run.HERE, kind)):
            if name.endswith(".py"):
                shutil.copy(os.path.join(run.HERE, kind, name),
                            root / "vkbench" / kind / name)

    assert run.load_config("beetle-tfa-block", str(root))["skipmode"] == 1
    scene = generator.Scene(pose=None, tf={"intensity_min": 0.1},
                            model=check.model_matrix(cfg), aspect=1.0)
    its = [it for it, _ in zip(generator.Mix(
        run.load_mix("tumble_edit", str(root)), 4, scene,
        str(root)).interactions(), range(30))]
    els = [it.scene.pose.elevation_deg for it in its]
    assert min(els) == 5.0 and max(els) == 60.0
    assert all(len(it.edits) == 1 for it in its)
    names = [m["name"] for m in run.cell_metrics(
        run.load_manifest(str(root)), "beetle-tfa-block.tumble_edit",
        "per_layer")]
    assert "frames_traced" in names and "map_update_ms" not in names

    res, _ = run.run_cell("beetle-tfa-block.tumble_edit", 4, 1.0, True,
                          root=str(root), device="cpu", scale=0.08,
                          size=(128, 128))
    assert res["attempted"] >= 1 and set(res["check"]) == set(check.NAMES)
    assert res["metrics"]["frames_traced"]["value"] >= 1
    assert res["metrics"]["frames_traced"]["unit"] == "frames"

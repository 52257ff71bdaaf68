"""The control of ``correct``: the reference put in the program's place and
computed in bfloat16, the precision below the float32 the configurations
state, judged by the same comparison (``check.py``) as the program.

    python3 vkbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it makes the cell's volume, takes the mix's first
interactions (its poses and TFs, as the window would send them), and
prints one JSON line with the numbers the comparison reads and whether
they pass the configuration's limits. The benchmark's own runs do not run
it: it sets the upper end of each limit (``PERF.md``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from vkbench import check, data, generator, run  # noqa: E402


def control_numbers(workload: str, seed: int, *, root: str = run.ROOT,
                    device: str = "cuda", scale: float = 1.0,
                    size: tuple | None = None) -> dict:
    """The comparison's numbers for the control on one seed."""
    manifest = run.load_manifest(root)
    cell = next(w for w in manifest["workloads"] if w["name"] == workload)
    cfg = run.load_config(cell["config"], root)
    if size is not None:
        cfg = dict(cfg, width=size[0], height=size[1])
    params = run.load_mix(cell["traffic"], root)
    vol, _ = data.make_volume(cfg["volume"], seed, device, scale)
    tf0 = dict(cfg["tf"])
    mix = generator.Mix(params, seed, generator.Scene(
        pose=None, tf=tf0, model=check.model_matrix(cfg),
        aspect=cfg["width"] / cfg["height"]), root)
    sent = [(it.scene, None) for it, _ in zip(mix.interactions(),
                                              range(run.KEPT_FRAMES))]
    maps = [(tf0, None)] + ([(sent[-1][0].tf, None)] if mix.edits else [])
    c_maps, c_frames = check.control_outputs(vol, cfg, maps, sent)
    numbers = check.readings(vol, cfg, c_maps, c_frames)
    return dict(workload=workload, seed=seed, **numbers,
                limits=cfg["check"], passes=check.verdict(numbers, cfg))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(control_numbers(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark once.

    python3 vkbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a configuration
(``vkbench/configs/<config>.json``) under a traffic mix
(``vkbench/traffic/<traffic>.json``, read by ``generator.py``, whose kinds
of interaction are ``vkbench/moves/<kind>.py``). The run
makes the volume on the card from the seed, loads it into the program's
engine (``vkvolume_tpu_torch``, through its public API only), warms up the
mix's kinds of work, then runs a closed loop with one interaction in
flight for ``--seconds``: each interaction's calls into the engine, then
``torch.cuda.synchronize()``, then the next. It then checks what the
window produced against the plain reference (``check.py``) and prints:

* earlier lines on standard output: the card, the counts, the occupancy,
  the renderers used, the peak memory;
* as the last line of standard output, one JSON object: ``correct``,
  ``attempted``, ``failed``, ``metrics`` (``--trace 0``: the cell's
  end-to-end metrics; ``--trace 1``: its per-layer metrics, read by the
  readers in ``vkbench/metrics/`` from a profiled sub-window), ``device``,
  with ``--trace 1`` ``breakdown``, and last ``check``: each number
  compared, with its limit;
* as the last lines of standard error, the same numbers and limits.

It exits with another code than 0, printing no result, without a CUDA
device, when the cell asks for more cards than there are, or when
``jax``, ``jaxlib``, ``flax`` or ``vkvolume_tpu`` is loaded once the
window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import warnings  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from vkbench import check, data, generator, pose as pose_mod  # noqa: E402
from vkbench import trace as trace_mod  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "vkvolume_tpu")
PROFILE_S = 2.0         # the traced run's profiled sub-window, at most
PROFILE_LEAD = 4        # interactions under the profiler before it counts
KEPT_FRAMES = 3         # window frames the check compares, besides its last


def forbidden_modules(modules=None) -> list:
    """The forbidden packages among ``modules`` (default: the loaded
    ones), compared by whole top-level name: ``vkvolume_tpu_torch`` is
    not ``vkvolume_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _json(root: str, kind: str, name: str) -> dict:
    with open(os.path.join(root, "vkbench", kind, f"{name}.json")) as fh:
        return json.load(fh)


def load_config(name: str, root: str = ROOT) -> dict:
    return _json(root, "configs", name)


def load_mix(name: str, root: str = ROOT) -> dict:
    return _json(root, "traffic", name)


def load_metric(name: str, root: str = ROOT):
    """The reader module ``vkbench/metrics/<name>.py``."""
    path = os.path.join(root, "vkbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "vkbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(manifest: dict, workload: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that apply to the
    cell."""
    return [m for m in manifest[kind]
            if "workloads" not in m or workload in m["workloads"]]


def card_line(torch, dev) -> dict:
    """The card's name and power limit (``nvidia-smi``)."""
    if dev.type != "cuda":
        return {"kind": "cpu", "power_limit": None}
    try:
        power = subprocess.run(
            ["nvidia-smi", "-i", str(dev.index or 0),
             "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        power = None
    return {"kind": torch.cuda.get_device_name(dev), "power_limit": power}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             root: str = ROOT, device: str = "cuda", scale: float = 1.0,
             size: tuple | None = None, t_start: float | None = None,
             out=None) -> tuple[dict, list]:
    """One run of ``workload``; returns the result object and the check
    lines. ``scale`` and ``size`` shrink the volume and the image, and
    ``device="cpu"`` runs the program's plain versions: for the CPU
    tests only."""
    t_start = time.perf_counter() if t_start is None else t_start
    manifest = load_manifest(root)
    cell = next(w for w in manifest["workloads"] if w["name"] == workload)
    cfg = load_config(cell["config"], root)
    if size is not None:
        cfg = dict(cfg, width=size[0], height=size[1])
    mix_params = load_mix(cell["traffic"], root)

    import torch

    from vkvolume_tpu_torch.camera import Camera
    from vkvolume_tpu_torch.engine import (Engine, RenderOptions,
                                           SkippingType, VolumeOptions,
                                           from_array)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def say(line):
        print(line, file=out or sys.stdout, flush=True)

    W, H = cfg["width"], cfg["height"]
    vol_u8, made = data.make_volume(cfg["volume"], seed, dev, scale)
    sync()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    tf0 = dict(cfg["tf"])
    eng = Engine(RenderOptions(
        skipping_type=SkippingType(cfg["skipmode"]),
        clip_distance=cfg["clip_distance"],
        early_ray_termination=cfg["early_ray_termination"]),
        renderer="pallas", device=dev)
    with warnings.catch_warnings():
        # from_array copies its array with torch.tensor, which warns when
        # handed a tensor.
        warnings.simplefilter("ignore", UserWarning)
        vol = from_array(vol_u8, VolumeOptions(**tf0),
                         block_size=cfg["block_size"], device=dev)
    d, h, w = vol_u8.shape
    vol.set_scale((100.0 / w, 100.0 / h, 100.0 / d))
    eng.add_volume(vol)
    setup_maps = vol.dist_maps.clone()

    mix = generator.Mix(mix_params, seed, generator.Scene(
        pose=None, tf=tf0, model=check.model_matrix(cfg), aspect=W / H),
        root)

    def camera(p):
        return Camera(view=p.view, proj=p.proj,
                      fovy_rad=float(np.deg2rad(pose_mod.FOVY_DEG)),
                      near=pose_mod.NEAR, far=pose_mod.FAR)

    def interact(it, ranges: bool, tag: str = "vkbench"):
        cam = camera(it.scene.pose)
        t0 = time.perf_counter()
        if it.edits:
            with trace_mod.ranged(tag + ".edit", ranges):
                for move in it.edits:
                    move.apply(eng, vol, it.scene)
        th0 = time.perf_counter()
        with trace_mod.ranged(tag + ".render", ranges):
            frame = eng.render(cam, W, H)
        th1 = time.perf_counter()
        with trace_mod.ranged(tag + ".wait", ranges):
            sync()
        t1 = time.perf_counter()
        if (mix.require_renderer is not None
                and eng.last_renderer != mix.require_renderer):
            raise RuntimeError(
                f"a frame took the {eng.last_renderer!r} renderer, the mix "
                f"requires {mix.require_renderer!r} (azimuth "
                f"{it.scene.pose.azimuth_deg})")
        return frame.color, (t1 - t0) * 1e3, (th1 - th0) * 1e3

    for it in mix.warmup():
        interact(it, False)
    counts0 = dict(eng.renderer_counts)

    prof = trace_mod.Profiler() if trace else None
    if prof is not None:
        # The profiler's first ranges pay its own start-up: a lead of
        # interactions under other names, outside the profiled window.
        prof.start()
        for it in mix.warmup()[:PROFILE_LEAD]:
            interact(it, True, "vkbench.lead")
    profiling = prof is not None
    setup_s = time.perf_counter() - t_start

    k = KEPT_FRAMES
    pick = np.random.default_rng((mix.seed, 2))
    kept, lat, host = [], [], []
    n = 0
    w_start = time.perf_counter()
    for it in mix.interactions():
        color, lat_ms, host_ms = interact(it, profiling)
        n += 1
        lat.append(lat_ms)
        if not profiling:
            host.append(host_ms)
        item = (it.scene, color)
        if len(kept) < k:
            kept.append(item)
        else:
            j = int(pick.integers(n))
            if j < k:
                kept[j] = item
        last = item
        now = time.perf_counter()
        if profiling and now - w_start >= min(PROFILE_S, seconds / 2):
            prof.stop()
            profiling = False
        if now - w_start >= seconds:
            break
    w_end = time.perf_counter()
    if profiling:
        prof.stop()

    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    counts = {r: c - counts0.get(r, 0)
              for r, c in eng.renderer_counts.items()}
    card = card_line(torch, dev)
    say(f"card {card['kind']} power.limit {card['power_limit']}")
    say(f"volume {w}x{h}x{d} occupied {made['occupied_pct']:.4f} % "
        f"(gradient TF {made['grad_occupied_pct']:.4f} %, c "
        f"{made['calib_c']:.4f}, rho {made['calib_rho']})")
    say(f"interactions {n} in {w_end - w_start:.3f} s; renderers {counts}")
    say(f"memory_peak_bytes {peak}")

    result = {"correct": False, "attempted": n, "failed": 0, "metrics": {},
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": card["kind"], "count": 1,
                         "memory_peak_bytes": int(peak)}}
    if trace:
        tr = prof.trace({"render_host_ms": host,
                         "map_shape_zyx": tuple(vol.map_shape_zyx),
                         "skipmode": cfg["skipmode"]})
        busy_s = tr.busy_us() / 1e6
        window_s = (tr.window[1] - tr.window[0]) / 1e6
        result["device"].update(busy_s=busy_s, window_s=window_s)
        for m in cell_metrics(manifest, workload, "per_layer"):
            value = load_metric(m["name"], root).read(tr)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["breakdown"] = trace_mod.breakdown(tr)
        say(f"traced {tr.count('vkbench.render')} frames, "
            f"{tr.count('vkbench.edit')} edits, {len(tr.ops)} device ops "
            f"in {window_s:.4f} s; peaks: HBM 3.35e12 B/s, float32 "
            f"67e12 op/s (H100 SXM, 700 W); card power.limit "
            f"{card['power_limit']}")
    else:
        e2e = {"fps": n / (w_end - w_start),
               "latency_p95_ms": float(np.percentile(lat, 95)),
               "setup_s": setup_s}
        for m in cell_metrics(manifest, workload, "end_to_end"):
            result["metrics"][m["name"]] = {"value": e2e[m["name"]],
                                            "unit": m["unit"]}
        say(f"latency ms: median {float(np.median(lat)):.4f} p95 "
            f"{e2e['latency_p95_ms']:.4f} max {max(lat):.4f} over {n}")

    # The program's outputs to judge; then its state goes.
    maps = [(tf0, setup_maps)]
    if mix.edits:
        maps.append((last[0].tf, vol.dist_maps))
    frames = kept + [last]
    del eng, vol, color, item, it
    if cuda:
        torch.cuda.empty_cache()
    numbers = check.readings(vol_u8, cfg, maps, frames)
    say(f"checked {len(maps)} map states and {len(frames)} frames; "
        f"% of each reference frame above alpha 8/255: "
        f"{[round(c, 4) for c in numbers['covered_pct']]}")
    result["correct"] = check.verdict(numbers, cfg)
    result["check"] = {name: {"value": numbers[name],
                              "limit": cfg["check"][name]}
                       for name in check.NAMES}
    lines = [f"check {name} {numbers[name]} limit {cfg['check'][name]}"
             for name in check.NAMES]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    manifest = load_manifest()
    cell = next((w for w in manifest["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result, lines = run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

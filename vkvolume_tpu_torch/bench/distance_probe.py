"""What the distance kernels (K3-K6) spend their time on, at the beetle's
maps.

    python -m vkvolume_tpu_torch.bench.distance_probe [--reps N]

Loads the full-scale synthetic beetle (494x832x832 u8, block size 4: maps
of 124x208x208) the way ``chip_smoke.py`` phases 2 and 4 do and builds
the occupancy map of two TF edits: bench.py's (intensity TF, skipmode 3)
and the CLI's default (gradient TF, skipmode 2). On those it times every
distance kernel through its wrapper, as the map build calls it:

- K3 on bench.py's occupancy, K4 x8 on K3's four maps;
- K5 on the CLI's occupancy, the two-sided K4 on K5's map, K6 (two-sided,
  along z) on the same map;
- K5's y-relaxation alone: K6 two-sided along y on the two-sided x-scan
  of the CLI's occupancy (the plain x-scan, made once); K5's x-scan is
  the rest of K5.

For each it prints one JSON line: whether the kernel's output equals its
plain version's (bit for bit), ms (median over ``--reps`` calls, each
between two CUDA events: the wrapper's host time included), device_ms
(20 calls queued behind a sleep on the card: the card's time alone; see
``device_ms``), the loop steps a per-cell loop that stops at
the answer takes (each output cell's distance per loop: the sum that
``chip_smoke.py`` charged before its bounds were re-based), the mean
steps per output cell, ps per step, and the card. Then each path's
``map_update_ms`` (one TF edit: occupancy + distance maps; bench.py's
engine: the median of its benchmark-mode means over 20 queued builds;
the CLI's: the median of 5 CUDA-event means over 20 builds), each split
into the card's time for the occupancy map (its kernel), the distance
kernels and the whole build (``edit_breakdown``; the rest is host time), and the
ptxas lines (registers, spills) of ``csrc/distance.cu`` from this
process's build (none when the library was already built). Needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import torch

REPS = 5
SLEEP_CYCLES = 10_000_000     # about 5 ms of the card's clock


def gpu_median_ms(fn, n: int) -> float:
    """Median ms of ``n`` calls of ``fn``, each between two CUDA events,
    after one warm call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, n: int) -> float:
    """Median over REPS of the mean ms of ``n`` calls of ``fn`` queued
    behind a sleep on the card, so that the host has issued them all
    before the first starts: the card's time without the wrapper's host
    time between calls."""
    fn()
    torch.cuda.synchronize()
    reps = []
    for _ in range(REPS):
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        reps.append(start.elapsed_time(end) / n)
    return statistics.median(reps)


def total(t: torch.Tensor) -> int:
    return int(t.to(torch.int64).sum())


def occupancy(volume, use_gradient: bool) -> torch.Tensor:
    """The u8 occupancy map of the volume's TF (OCCUPIED = 0)."""
    from ..accel.occupancy import _occupancy_u8, _tf_thresholds

    o = volume.options
    ti, tg = _tf_thresholds(None, (o.intensity_min, o.intensity_max,
                                   o.gradient_min, o.gradient_max))
    return _occupancy_u8(volume.density,
                         volume.gradient if use_gradient else None,
                         volume.map_shape_zyx, ti, tg)


def edit_breakdown(volume, use_gradient: bool, map_update_ms: float) -> dict:
    """One TF edit's map build split on the card (``device_ms``, 20
    builds): the occupancy map alone, the distance kernels alone
    and the whole build; the rest of ``map_update_ms`` (the host clock
    over queued builds) is time the card waits for the host."""
    from ..accel import distance_cuda as dc

    occ = occupancy(volume, use_gradient)
    maps = (dc.isotropic_distance_cuda if use_gradient
            else dc.anisotropic_distance_cuda)
    build = device_ms(lambda: maps(occupancy(volume, use_gradient)), 20)
    return {"occupancy": device_ms(lambda: occupancy(volume, use_gradient),
                                   20),
            "distance_kernels": device_ms(lambda: maps(occ), 20),
            "build": build, "map_update_ms": map_update_ms,
            "host_rest": map_update_ms - build}


def kernel_rows(occ3: torch.Tensor, occ2: torch.Tensor):
    """(label, wrapper call, its plain version, steps, output cells) of
    every probed kernel."""
    from ..accel import distance as dp, distance_cuda as dc

    xy3 = dc.scan_and_relax_multi(occ3)
    z3 = dc.relax_z_direct_multi(xy3)
    xy2 = dc.scan_and_relax(occ2)
    iso = dc.relax_z_direct(xy2[0])
    xs2 = dp.axis_scan(occ2, 2, 0).clamp(max=255).to(torch.uint8)
    ys2 = dc.relax(xs2, 1, 0)
    # Steps of per-cell loops that stop at the answer (the kernels'
    # earlier design): an x-scan loop and a y-relax loop per output cell,
    # each bounded by the output; a two-sided loop takes two senses per
    # step.
    return [
        ("K3", lambda: dc.scan_and_relax_multi(occ3),
         lambda: dp.scan_and_relax_multi(occ3), 2 * total(xy3), xy3.numel()),
        ("K4 x8", lambda: dc.relax_z_direct_multi(xy3),
         lambda: dp.relax_z_direct_multi(xy3), total(z3), z3.numel()),
        ("K5", lambda: dc.scan_and_relax(occ2),
         lambda: dp.scan_and_relax(occ2, 0, (0,)), 4 * total(xy2),
         xy2.numel()),
        ("K5 y-relax (K6 along y)", lambda: dc.relax(xs2, 1, 0),
         lambda: dp.relax(xs2, 1, 0).to(torch.uint8), 2 * total(ys2),
         ys2.numel()),
        ("K4 two-sided", lambda: dc.relax_z_direct(xy2[0]),
         lambda: dp.relax_z_direct(xy2[0], (0,)), 2 * total(iso),
         iso.numel()),
        ("K6 (z, two-sided)", lambda: dc.relax(xy2[0], 0, 0),
         lambda: dp.relax(xy2[0], 0, 0).to(torch.uint8), 2 * total(iso),
         iso.numel()),
    ]


def ptxas_lines(log: str):
    """The ptxas report of csrc/distance.cu in an nvcc build log."""
    out, on = [], False
    for ln in log.splitlines():
        if ln.startswith("== "):
            on = ln.strip() == "== distance.cu"
        elif on and ("Compiling entry" in ln or "registers" in ln
                     or "spill" in ln):
            out.append(ln.strip())
    return out


def main(argv=None) -> int:
    from .. import cli
    from ..bench.datasets import DATASETS, synthesize
    from ..bench.harness import make_engine
    from ..utils import cuda_build

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("distance_probe needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cuda_build.load_kernels()
    build_log = cuda_build.build_log

    vol = synthesize(DATASETS["beetle"], seed=0, scale=1.0)
    eng3, _, _, _ = make_engine("beetle", 3, 4, volume_u8=vol,
                                renderer="pallas", device="cuda")
    occ3 = occupancy(eng3.volumes[0], False)
    update_ms = {"bench.py (skipmode 3)": statistics.median(
        eng3.update_transfer_function(eng3.volumes[0]).map_update_ms
        for _ in range(REPS))}
    split = edit_breakdown(eng3.volumes[0], False,
                           update_ms["bench.py (skipmode 3)"])
    del eng3
    eng2, vols = cli.setup_engine(cli.build_parser().parse_args(
        ["--synth", "beetle"]))
    eng2.add_volume(vols[0])
    occ2 = occupancy(eng2.volumes[0], True)

    def cli_update():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            eng2.update_transfer_function(eng2.volumes[0])
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 20

    cli_update()
    update_ms["CLI (skipmode 2)"] = statistics.median(
        cli_update() for _ in range(REPS))

    device = torch.cuda.get_device_name(0)
    for label, fn, plain, steps, cells in kernel_rows(occ3, occ2):
        exact = torch.equal(fn(), plain())
        ms = gpu_median_ms(fn, args.reps)
        print(json.dumps({"kernel": label, "exact": exact, "ms": ms,
                          "device_ms": device_ms(fn, 20),
                          "steps": steps,
                          "steps_per_cell": steps / cells,
                          "ps_per_step": ms * 1e9 / steps,
                          "maps": list(occ3.shape), "device": device,
                          "card": card}), flush=True)
    print(json.dumps({"map_update_ms": update_ms, "device": device,
                      "card": card}), flush=True)
    split["CLI (skipmode 2)"] = edit_breakdown(
        eng2.volumes[0], True, update_ms["CLI (skipmode 2)"])
    print(json.dumps({"tf_edit_breakdown_ms": split, "device": device,
                      "card": card}), flush=True)
    for ln in ptxas_lines(build_log) or ["(library built by an earlier "
                                         "process: no ptxas report)"]:
        print(f"ptxas: {ln}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

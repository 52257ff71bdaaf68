"""What the two-pass warp costs a frame on the card, at two frames' shapes.

    python -m vkvolume_tpu_torch.bench.warp_probe [--reps N]

Renders bench.py's frame (the full-scale synthetic beetle, skipmode 3,
1920x1080, the benchmark camera) and the CLI's default frame (1280x720)
once each, capturing what the frame hands its two-pass warp: the stacked
grid channels, both passes' positions, the scales and the variant. On
those it prints one JSON line per frame: the warp stage's device ms
(``warp_two_pass[_b]`` from the channel tensor to the (C, Hp, W) result,
``--reps`` calls queued behind a sleep: the card's time alone), the
kernels and copies one call puts on the card (``torch.profiler``), the
frame's shapes and the card. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

SLEEP_CYCLES = 10_000_000     # about 5 ms of the card's clock


def capture_warp(engine, camera, width: int, height: int) -> dict:
    """The arguments of the two-pass warp in one render of the pose."""
    from ..render import warp_cuda

    got = {}
    saved = warp_cuda.warp_two_pass, warp_cuda.warp_two_pass_b

    def recorder(variant, fn):
        def record(chans, pos1, pos2, *, scales):
            got.update(variant=variant, fn=fn, scales=list(scales),
                       args=(chans.clone(), pos1.clone(), pos2.clone()))
            return fn(chans, pos1, pos2, scales=scales)
        return record

    warp_cuda.warp_two_pass = recorder("A", saved[0])
    warp_cuda.warp_two_pass_b = recorder("B", saved[1])
    try:
        engine.render(camera, width, height)
    finally:
        warp_cuda.warp_two_pass, warp_cuda.warp_two_pass_b = saved
    if not got:
        raise RuntimeError("the frame took no two-pass warp")
    return got


def device_ms(fn, n: int) -> float:
    """Mean ms of ``n`` calls of ``fn`` queued behind a sleep on the card."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_work(fn) -> dict:
    """The kernels and memory copies one call of ``fn`` runs on the card,
    by name, from a ``torch.profiler`` trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return {"device_events": len(names),
            "copies": sum(1 for n in names if "emcpy" in n
                          or "emset" in n),
            "names": sorted(set(n[:80] for n in names))}


def main(argv=None) -> int:
    from .. import cli
    from ..bench.datasets import DATASETS, synthesize
    from ..bench.harness import benchmark_camera, make_engine

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("warp_probe needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    vol = synthesize(DATASETS["beetle"], seed=0, scale=1.0)
    eng3, _, _, _ = make_engine("beetle", 3, 4, volume_u8=vol,
                                renderer="pallas", device="cuda")
    frames = [("bench.py (1920x1080)", eng3,
               benchmark_camera(aspect=1920 / 1080), 1920, 1080)]
    eng2, vols = cli.setup_engine(cli.build_parser().parse_args(
        ["--synth", "beetle"]))
    eng2.add_volume(vols[0])
    frames.append(("CLI default (1280x720)", eng2,
                   cli.cli_camera(1280, 720), 1280, 720))
    for label, eng, cam, w, h in frames:
        got = capture_warp(eng, cam, w, h)
        chans, pos1, pos2 = got["args"]

        def warp():
            return got["fn"](chans, pos1, pos2, scales=got["scales"])

        print(json.dumps({
            "frame": label, "variant": got["variant"],
            "warp_device_ms": device_ms(warp, args.reps), **device_work(warp),
            "chans": list(chans.shape), "pos1": list(pos1.shape),
            "pos2": list(pos2.shape), "out": list(warp().shape),
            "device": torch.cuda.get_device_name(0), "card": card}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

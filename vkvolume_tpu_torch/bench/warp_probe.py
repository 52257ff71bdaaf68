"""What the warps cost a frame on the card, at the frames' own inputs.

    python -m vkvolume_tpu_torch.bench.warp_probe [--reps N] [--warp k8]

The two-pass warp (default): renders bench.py's frame (the full-scale
synthetic beetle, skipmode 3, 1920x1080, the benchmark camera) and the
CLI's default frame (1280x720) once each, capturing what the frame hands
its two-pass warp: the stacked grid channels, both passes' positions, the
scales and the variant. On those it prints one JSON line per frame: the
warp stage's device ms (``warp_two_pass[_b]`` from the channel tensor to
the (C, Hp, W) result, ``--reps`` calls queued behind a sleep: the card's
time alone), the kernels and copies one call puts on the card
(``torch.profiler``), the frame's shapes and the card.

The single-pass warp K8 (``--warp k8``): captures what ``warp_to_pixels``
gets in the CLI's side view (``--azimuth 80 --sampling 0.25``) and in the
benchmark orbit's azimuth-90 frame (1280x720 each) and prints one JSON
line per frame with the split of K8's time: the kernel warm (the same
inputs every call, so the grid comes from L2) and cold (a rotation over
copies of the inputs three times the 50 MB L2); the same with every
covered pixel moved onto one texel (what the taps' gathers cost is the
gap); a cold ``Tensor.copy_`` of as many bytes (the card's streaming rate
here); ``grid_sample`` and the plain version; the bytes of the bound
(grid sectors the taps touch, gx, the gy sectors that hold a covered
pixel, outputs); where the tree's K8 has them, the tile paths (the
kernel's counters). It runs on an older tree too (copy it in).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import subprocess
import sys

import torch

SLEEP_CYCLES = 10_000_000     # about 5 ms of the card's clock
L2_BYTES = 50e6               # the H100's L2
HBM_BYTES_PER_S = 3.35e12     # the H100 SXM's device-memory rate
CLI_WIDTH, CLI_HEIGHT = 1280, 720


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
    by name, from a ``torch.profiler`` trace. The port's ``vkv.*`` spans,
    which the trace also shows on the card's timeline, are ranges round
    that work and are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and not e.name.startswith("vkv.")]
    return {"device_events": len(names),
            "copies": sum(1 for n in names if "emcpy" in n
                          or "emset" in n),
            "names": sorted(set(n[:80] for n in names))}


def capture_k8(engine, camera, width: int, height: int) -> tuple:
    """(chans, gx, gy) that one render of the pose hands K8."""
    from ..render import warp_cuda

    got = []
    saved = warp_cuda.warp_to_pixels

    def record(chans, gx, gy, **kw):
        got.append((chans.clone(), gx.clone(), gy.clone()))
        return saved(chans, gx, gy, **kw)

    warp_cuda.warp_to_pixels = record
    try:
        engine.render(camera, width, height)
    finally:
        warp_cuda.warp_to_pixels = saved
    if not got:
        raise RuntimeError("the frame took no single-pass warp")
    return got[-1]


def rotated_ms(fn, args: list, n: int) -> float:
    """Mean ms of ``n`` calls of ``fn`` queued behind a sleep, call i on
    ``args[i % len(args)]``: with enough copies of the inputs between two
    uses of one (``cold_copies``), each call finds them out of L2."""
    for a in args:
        fn(*a)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        fn(*args[i % len(args)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def cold_copies(tensors, nbytes: float) -> list:
    """Copies of ``tensors`` whose rotation passes three times the L2
    between two uses of one: calls of ``nbytes`` each find it cold."""
    k = math.ceil(3 * L2_BYTES / nbytes) + 1
    return [tuple(t.clone() for t in tensors) for _ in range(k)]


def tap_sector_bytes(chans: torch.Tensor, gx: torch.Tensor,
                     gy: torch.Tensor) -> int:
    """Bytes of the 32-byte grid sectors the covered pixels' taps touch,
    all channels (the grid's share of K8's bound)."""
    C, Hi, Wi = chans.shape
    inside = gx > -5.0
    xc = torch.clamp(gx[inside], 0.0, Wi - 1.0)
    yc = torch.clamp(gy[inside], 0.0, Hi - 1.0)
    x0 = torch.floor(xc).to(torch.int64).clamp(0, Wi - 1)
    y0 = torch.floor(yc).to(torch.int64).clamp(0, Hi - 1)
    x1, y1 = (x0 + 1).clamp(max=Wi - 1), (y0 + 1).clamp(max=Hi - 1)
    taps = torch.cat([y * Wi + x for y in (y0, y1) for x in (x0, x1)])
    base = chans.data_ptr() // 4
    return 32 * sum(int(torch.unique((base + c * Hi * Wi + taps) // 8)
                        .numel()) for c in range(C))


def k8_bytes(chans, gx, gy) -> dict:
    """K8's bytes: the grid sectors its taps touch, gx for every pixel, gy
    in the 32-byte sectors that hold a covered pixel (an uncovered pixel's
    output is 0 whatever its gy), the outputs; their sum ``bound``, and
    ``whole``: the whole grid and both positions of every pixel, the
    bound's figure before sectors were counted."""
    n_pix = gx.numel()
    covered = torch.nonzero((gx > -5.0).flatten()).flatten()
    gy_sectors = 32 * int(torch.unique(
        (gy.data_ptr() // 4 + covered) // 8).numel())
    nb = {"grid_sectors": tap_sector_bytes(chans, gx, gy),
          "grid_whole": 4 * chans.numel(), "gx": 4 * n_pix,
          "gy_sectors": gy_sectors, "out": 4 * chans.shape[0] * n_pix}
    nb["bound"] = (nb["grid_sectors"] + nb["gx"] + nb["gy_sectors"]
                   + nb["out"])
    nb["whole"] = nb["grid_whole"] + 8 * n_pix + nb["out"]
    return nb


def grid_sample_positions(gx, gy, Hi: int, Wi: int) -> torch.Tensor:
    """(1, H, W, 2) positions normalised for ``grid_sample``
    (``align_corners=True``)."""
    return torch.stack([gx / (Wi - 1) * 2.0 - 1.0,
                        gy / (Hi - 1) * 2.0 - 1.0], -1)[None]


def grid_sample_warp(chans, grid, gx) -> torch.Tensor:
    """K8's function as one library call: ``grid_sample`` (bilinear,
    border padding: the clamps) at ``grid_sample_positions``, then 0 where
    the pixel is uncovered."""
    o = torch.nn.functional.grid_sample(
        chans[None], grid, mode="bilinear", padding_mode="border",
        align_corners=True)[0]
    return torch.where((gx > -5.0)[None], o, 0.0)


def map_steps(gx, gy) -> dict:
    """Median |step| of gx and of gy from a covered pixel to its covered
    neighbour along x and along y: how the pixel -> grid map turns."""
    inside = gx > -5.0
    out = {}
    for name, g in (("gx", gx), ("gy", gy)):
        for axis, d in (("x", 1), ("y", 0)):
            n = g.shape[d] - 1
            both = inside.narrow(d, 1, n) & inside.narrow(d, 0, n)
            step = (g.narrow(d, 1, n) - g.narrow(d, 0, n)).abs()[both]
            out[f"d{name}/d{axis}"] = float(step.median())
    return out


def one_texel(chans, gx, gy):
    """The positions with every covered pixel of a 16 x 32-pixel tile on
    one texel, the tiles' texels spread over the grid (so that no one
    sector serves every tile)."""
    C, Hi, Wi = chans.shape
    H, W = gx.shape
    ty = torch.arange(H, device=gx.device)[:, None] // 16
    tx = torch.arange(W, device=gx.device)[None, :] // 32
    px = ((tx * 37 + ty * 11) % max(Wi - 1, 1)).float()
    py = ((ty * 13 + tx * 7) % max(Hi - 1, 1)).float()
    inside = gx > -5.0
    return (torch.where(inside, px, gx).contiguous(),
            torch.where(inside, py, gy).contiguous())


def k8_frames():
    """(label, chans, gx, gy) of the CLI's side view and the benchmark
    orbit's azimuth-90 frame."""
    from .. import cli
    from .harness import benchmark_camera

    def engine(*flags):
        eng, vols = cli.setup_engine(cli.build_parser().parse_args(
            ["--synth", "beetle", *flags]))
        eng.add_volume(vols[0])
        return eng

    eng = engine("--azimuth", "80", "--sampling", "0.25")
    yield ("side view (--azimuth 80 --sampling 0.25, 1280x720)",
           *capture_k8(eng, cli.cli_camera(CLI_WIDTH, CLI_HEIGHT, 80.0),
                       CLI_WIDTH, CLI_HEIGHT))
    del eng
    eng = engine("--benchmark", "20", "--orbit", "5")
    yield ("orbit azimuth 90 (--benchmark 20 --orbit 5, 1280x720)",
           *capture_k8(eng, benchmark_camera(CLI_WIDTH / CLI_HEIGHT, 90.0,
                                             20.0), CLI_WIDTH, CLI_HEIGHT))


def probe_k8(label, chans, gx, gy, reps: int) -> dict:
    """The split of K8's time on one frame's inputs (see the module)."""
    from ..render import warp_cuda

    k8 = warp_cuda.warp_to_pixels
    has_paths = "tile_paths" in inspect.signature(k8).parameters
    want = warp_cuda.warp_to_pixels_plain(chans, gx, gy)
    assert torch.equal(k8(chans, gx, gy), want), "K8 differs from plain"
    C, Hi, Wi = chans.shape
    nb = k8_bytes(chans, gx, gy)
    call_bytes = nb["whole"]
    real = cold_copies((chans, gx, gy), call_bytes)
    tex = cold_copies((chans, *one_texel(chans, gx, gy)), call_bytes)
    lib = cold_copies((chans, grid_sample_positions(gx, gy, Hi, Wi), gx),
                      call_bytes)
    bufs = [(torch.empty(call_bytes // 4, device=chans.device),
             torch.empty(call_bytes // 4, device=chans.device))
            for _ in range(math.ceil(6 * L2_BYTES / call_bytes) + 1)]
    out = {"frame": label, "chans": list(chans.shape),
           "pixels": list(gx.shape),
           "covered": float((gx > -5.0).float().mean()),
           "map": map_steps(gx, gy), "bytes": nb,
           "bound_ms": nb["bound"] / HBM_BYTES_PER_S * 1e3,
           "bound_ms_whole_grid": call_bytes / HBM_BYTES_PER_S * 1e3,
           "k8_warm_ms": rotated_ms(k8, real[:1], reps),
           "k8_cold_ms": rotated_ms(k8, real, reps),
           "one_texel_warm_ms": rotated_ms(k8, tex[:1], reps),
           "one_texel_cold_ms": rotated_ms(k8, tex, reps),
           "copy_cold_ms": rotated_ms(lambda d, s: d.copy_(s), bufs, reps),
           "copy_bytes": 2 * call_bytes,
           "grid_sample_warm_ms": rotated_ms(grid_sample_warp, lib[:1],
                                             reps),
           "grid_sample_cold_ms": rotated_ms(grid_sample_warp, lib, reps),
           "plain_ms": rotated_ms(warp_cuda.warp_to_pixels_plain, real[:1],
                                  max(1, reps // 10))}
    out["copy_GB_per_s"] = out["copy_bytes"] / out["copy_cold_ms"] / 1e6
    out["stream_bound_ms"] = nb["bound"] / out["copy_GB_per_s"] / 1e6
    if has_paths:
        paths = torch.zeros(4, dtype=torch.int32, device=chans.device)
        k8(chans, gx, gy, tile_paths=paths)
        out["tile_paths"] = dict(zip(("empty", "staged", "two_passes",
                                      "direct"), paths.tolist()))
    return out


def main(argv=None) -> int:
    from .. import cli
    from ..bench.datasets import DATASETS, synthesize
    from ..bench.harness import benchmark_camera, make_engine

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--warp", choices=("two-pass", "k8"), default="two-pass")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("warp_probe needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    if args.warp == "k8":
        for label, chans, gx, gy in k8_frames():
            print(json.dumps({**probe_k8(label, chans, gx, gy, args.reps),
                              "device": torch.cuda.get_device_name(0),
                              "card": card}), flush=True)
        return 0
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

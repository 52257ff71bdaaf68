"""A scripted interactive session, the reference's GUI loop headless —
port of ``scripts/interactive_session.py``.

    python -m vkvolume_tpu_torch.bench.session [--dataset beetle]
        [--scale 1.0] [--width 1920] [--height 1080] [--edits 12]
        [--skipmode 2] [--no-extras] [--out docs/h100/interactive.json]
        [--device cuda|cpu]

Dragging a TF slider in the reference runs ``update_transfer_function``
(the occupancy and distance maps rebuilt) and the next frame renders with
the new maps (src/volume_render.cpp:447-547 draw_gui, then :392-445).
The session loads the volume into an interactive engine (shaded image,
ERT on, the pallas renderer), renders once, then:

* sweeps ``intensity_min`` over ``edits`` positions, up by 0.25 and back
  down (a triangle), each edit ``update_transfer_function`` then a frame
  synchronised with the host: ``update_ms``, ``render_ms``, ``total_ms``
  (host clock);
* the pipelined cadence: ``max(4, edits // 2)`` edits and frames queued
  back to back with one synchronise, per edit;
* writes the core result, then the other GUI edit classes, each an edit
  and its undo ("and back"): ``sampling_factor`` 1.5 (with a map
  rebuild), a translation by +8 in x, a spin of 15°, and the ESS method
  (skipmode 3 through ``Engine.set_skipping_type``, whose map rebuild is
  in ``update_ms``). Each extra records ``equals_before``: whether its
  frame equals, bit for bit, the frame before its pair's first edit (an
  undo must give it back, and so must the ESS toggle, since skipping is
  exact). The file is rewritten after every extra.

There is no prewarm: ``prewarm_interactive`` compiles the TPU kernels'
specialisations ahead and is not ported, so ``prewarm_s`` is null and
the first frame's time is ``first_frame_s``. ``--device cuda`` (the
default) raises without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..engine.volume import resolve_device
from ..options import SkippingType
from .harness import benchmark_camera, card, make_engine, save_json

DEFAULT_OUT = "docs/h100/interactive.json"
SLIDER_SPAN = 0.25      # intensity_min rises by this much at the peak
PROTOCOL = ("per edit: set intensity_min -> update_transfer_function "
            "(occupancy + distance rebuild, engine dirty-tracking) -> "
            "render -> forced host sync; mirrors "
            "src/volume_render.cpp:447-547 -> :392-445")


def slider(i: int, n: int) -> float:
    """The slider's offset at edit ``i`` of ``n``: a triangle from 0 up to
    SLIDER_SPAN and back."""
    frac = i / max(n - 1, 1)
    return SLIDER_SPAN * (2 * frac if frac <= 0.5 else 2 * (1 - frac))


def run(*, dataset: str = "beetle", scale: float = 1.0, width: int = 1920,
        height: int = 1080, n_edits: int = 12, skipmode: int = 2,
        extras: bool = True, out: str = DEFAULT_OUT, device="cuda",
        log=print, on_frame=None) -> dict:
    """The session; returns what it writes to ``out``. ``on_frame(label,
    frame)`` sees every synchronised frame."""
    device = resolve_device(device)
    name, power_limit = card(device)
    t0 = time.perf_counter()
    eng = make_engine(dataset, skipmode, 4, scale=scale,
                      benchmark_mode=False, renderer="pallas",
                      device=device)[0]
    vol = eng.volumes[0]
    load_s = time.perf_counter() - t0
    cam = benchmark_camera(aspect=width / height)

    def render_synced(label):
        frame = eng.render(cam, width, height)
        eng._sync()
        if on_frame is not None:
            on_frame(label, frame)
        return frame

    t0 = time.perf_counter()
    render_synced("first")
    first_s = time.perf_counter() - t0
    log(f"loaded in {load_s:.1f} s, first frame {first_s:.1f} s")

    imin0 = vol.options.intensity_min
    edits = []
    for i in range(n_edits):
        imin = imin0 + slider(i, n_edits)
        t0 = time.perf_counter()
        vol.options.intensity_min = imin
        eng.update_transfer_function(vol)
        t_update = time.perf_counter() - t0
        t1 = time.perf_counter()
        render_synced(f"imin={imin}")
        t_render = time.perf_counter() - t1
        edits.append(dict(imin=imin, update_ms=t_update * 1e3,
                          render_ms=t_render * 1e3,
                          total_ms=(t_update + t_render) * 1e3,
                          renderer=eng.last_renderer))
        log(f"edit {i}: imin={imin:.3f} update {t_update * 1e3:.1f} ms "
            f"render {t_render * 1e3:.1f} ms ({eng.last_renderer})")

    # A GUI loop queues edits against the device and never reads back
    # between an edit and the next draw (volume_render.cpp:392-445).
    n_pipe = max(4, n_edits // 2)
    t0 = time.perf_counter()
    for i in range(n_pipe):
        vol.options.intensity_min = imin0 + slider(i, n_pipe)
        eng.update_transfer_function(vol)
        eng.render(cam, width, height)
    eng._sync()
    pipelined_ms = (time.perf_counter() - t0) * 1e3 / n_pipe
    vol.options.intensity_min = imin0
    eng.update_transfer_function(vol)
    log(f"pipelined TF-edit cadence: {pipelined_ms:.1f} ms/edit ({n_pipe} "
        f"edits, one sync)")

    totals = [e["total_ms"] for e in edits]
    result = dict(
        dataset=dataset, scale=scale, width=width, height=height,
        skipmode=skipmode, n_edits=n_edits,
        total_ms_median=sorted(totals)[len(totals) // 2],
        total_ms_max=max(totals), prewarm_s=None,
        pipelined_ms_per_edit=pipelined_ms,
        renderer_counts=dict(eng.renderer_counts), edits=edits,
        protocol=PROTOCOL, load_s=load_s, first_frame_s=first_s,
        device=name, power_limit=power_limit)
    save_json(out, result)

    if extras:
        result["extra_edits"] = []
        start = render_synced("start").color.clone()

        def timed_edit(label, apply_fn, rebuild=False):
            t0 = time.perf_counter()
            apply_fn()
            if rebuild:
                eng.update_transfer_function(vol)
            upd_ms = (time.perf_counter() - t0) * 1e3
            t1 = time.perf_counter()
            frame = render_synced(label)
            rnd_ms = (time.perf_counter() - t1) * 1e3
            e = dict(edit=label, update_ms=upd_ms, render_ms=rnd_ms,
                     total_ms=upd_ms + rnd_ms, renderer=eng.last_renderer,
                     equals_before=torch.equal(frame.color, start))
            log(f"extra {label}: update {upd_ms:.1f} ms render "
                f"{rnd_ms:.1f} ms ({eng.last_renderer}), equal to the "
                f"frame before: {e['equals_before']}")
            result["extra_edits"].append(e)
            result["renderer_counts"] = dict(eng.renderer_counts)
            save_json(out, result)

        samp0 = vol.options.sampling_factor
        timed_edit("sampling=1.5", lambda: setattr(
            vol.options, "sampling_factor", 1.5), rebuild=True)
        timed_edit(f"sampling={samp0}", lambda: setattr(
            vol.options, "sampling_factor", samp0), rebuild=True)
        xyz0 = vol.get_translation()
        timed_edit("translate+8x", lambda: vol.set_translation(
            xyz0 + np.asarray([8.0, 0.0, 0.0])))
        timed_edit("translate-back", lambda: vol.set_translation(xyz0))
        timed_edit("spin15", lambda: vol.set_spin(np.deg2rad(15.0)))
        timed_edit("spin0", lambda: vol.set_spin(0.0))
        st0 = eng.options.skipping_type
        timed_edit("skipmode=3", lambda: eng.set_skipping_type(
            SkippingType.ANISOTROPIC_DISTANCE))
        timed_edit(f"skipmode={int(st0)}",
                   lambda: eng.set_skipping_type(st0))
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m vkvolume_tpu_torch.bench.session",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", default="beetle")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--edits", type=int, default=12)
    p.add_argument("--skipmode", type=int, default=2)
    p.add_argument("--no-extras", action="store_true",
                   help="leave out the sampling, translation, spin and ESS "
                        "edits")
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu (plain versions)")
    args = p.parse_args(argv)
    r = run(dataset=args.dataset, scale=args.scale, width=args.width,
            height=args.height, n_edits=args.edits, skipmode=args.skipmode,
            extras=not args.no_extras, out=args.out, device=args.device,
            log=lambda m: print(m, file=sys.stderr, flush=True))
    print(json.dumps({k: r[k] for k in ("total_ms_median", "total_ms_max",
                                        "renderer_counts")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

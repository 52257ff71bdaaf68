"""Interactive viewer: the reference's GUI loop as a local HTTP app —
port of ``vkvolume_tpu/viewer.py``.

Dragging one of the reference's ImGui TF sliders triggers
``update_transfer_function`` (the occupancy and distance-map rebuild) and
the next frame renders with the new maps (src/volume_render.cpp:447-547
``draw_gui`` → :392-445). Here a browser page with the same sliders
fetches ``/frame.png`` on every input; the server applies the edit
(rebuilding the maps only when the TF, or the ESS method, changed),
renders, and sends the PNG back with the update and render times in
``X-*`` headers. ``/voldefaults`` serves a volume's slider values and
``/stats`` the last frame's numbers.

Usage::

    python -m vkvolume_tpu_torch.viewer --synth beetle --width 960 --height 540
    # then open http://localhost:8787/

Every flag of ``vkvolume_tpu_torch.cli`` applies (dataset, TF, skipmode,
renderer, ``--device``: the card by default, ``--device cpu`` for the
plain versions), plus ``--port`` and ``--host``. The JAX viewer's prewarm
(``--no-prewarm``, ``Engine.prewarm_interactive``) is not ported: it
exists to compile the TPU kernels' variants before the first edit, and
the CUDA kernels are built once, with no per-shape variants.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from .options import SkippingType, Test

_PAGE = """<!doctype html>
<html><head><title>vkvolume_tpu_torch viewer</title><style>
 body { font-family: sans-serif; margin: 1.2em; background: #111; color: #ddd; }
 .row { margin: .3em 0; }
 label { display: inline-block; width: 8em; }
 input[type=range] { width: 22em; vertical-align: middle; }
 #stats { margin-top: .6em; color: #8c8; font-family: monospace; }
 img { border: 1px solid #333; margin-top: .8em; image-rendering: pixelated; }
</style></head><body>
<h3>vkvolume_tpu_torch &mdash; interactive viewer</h3>
<div id="sliders"></div>
<div id="stats">&nbsp;</div>
<img id="frame" width="__W__" height="__H__"/>
<script>
// Engine-level state + the default volume's per-volume state (the SAME
// JSON /voldefaults serves — one serialisation, no drift).
const P = Object.assign(
  {azimuth:30, elevation:20, scene:0, clip:__CLIP__,
   skipmode:__SKIP__, ert:__ERT__, test:__TEST__, spin:0,
   vol:__VOLIDX__},
  __VOL0__);
const DEFS = [
 ["imin", 0, 1, 0.001], ["imax", 0, 1, 0.001],
 ["gmin", 0, 1, 0.001], ["gmax", 0, 1, 0.001],
 // sampling (0.5-3) / alpha (0-2) / clip (5-500): the reference GUI's
 // Sampling, Alpha and Clip dist sliders (volume_render.cpp:447-547)
 ["sampling", 0.5, 3, 0.01], ["alpha", 0, 2, 0.01], ["clip", 5, 500, 1],
 ["azimuth", -180, 180, 1], ["elevation", -89, 89, 1],
 // per-volume XYZ translation (the reference GUI's DragFloat3,
 // src/volume_render.cpp:464-468)
 ["tx", -100, 100, 0.5], ["ty", -100, 100, 0.5], ["tz", -100, 100, 0.5]];
const box = document.getElementById("sliders");
function checkbox(k) {
  const row = document.createElement("div"); row.className = "row";
  row.innerHTML = `<label>${k}</label>
    <input type="checkbox" id="${k}" ${P[k] ? "checked" : ""}/>`;
  box.appendChild(row);
  row.querySelector("input").addEventListener("input", e => {
    P[k] = e.target.checked ? 1 : 0;
    refresh();
  });
}
function radio(k, names) {
  const row = document.createElement("div"); row.className = "row";
  row.innerHTML = `<label>${k}</label>` + names.map((nm, i) =>
    `<label style="width:auto;margin-right:.8em"><input type="radio"
      name="${k}" value="${i}" ${P[k] == i ? "checked" : ""}/>${nm}</label>`
  ).join("");
  box.appendChild(row);
  row.querySelectorAll("input").forEach(el =>
    el.addEventListener("input", e => {
      P[k] = parseInt(e.target.value);
      refresh();
    }));
}
// scene = render-sponza toggle; ert / spin = the reference checkboxes;
// skipmode / test = the reference's ESS-method and Test radios.
checkbox("scene"); checkbox("ert"); checkbox("spin");
radio("skipmode", ["none", "block", "distance", "aniso"]);
radio("test", ["none", "entry", "exit", "samples"]);
// Per-volume sections (reference GUI: one collapsible per volume): a
// selector — switching volumes reloads THAT volume's TF/translation
// values so edits never leak across volumes.
const NVOL = __NVOL__;
if (NVOL > 1) {
  // NOT the generic radio(): the selected volume's OWN state must load
  // into P BEFORE P.vol flips (and before any refresh) — otherwise a
  // slider drag or the spin tick racing the fetch would apply the old
  // volume's values to the new one.
  const row = document.createElement("div"); row.className = "row";
  row.innerHTML = `<label>volume</label>` +
    Array.from({length: NVOL}, (_, i) =>
      `<label style="width:auto;margin-right:.8em"><input type="radio"
        name="vol" value="${i}" ${i == P.vol ? "checked" : ""}/>vol${i}</label>`
    ).join("");
  box.appendChild(row);
  row.querySelectorAll("input").forEach(el =>
    el.addEventListener("input", async e => {
      const nv = parseInt(e.target.value);
      const d = await (await fetch("/voldefaults?vol=" + nv)).json();
      for (const k in d) {
        P[k] = d[k];
        const s = document.getElementById(k);
        if (s) { s.value = d[k];
                 document.getElementById(k + "v").textContent = d[k]; }
      }
      P.vol = nv;
      refresh();
    }));
}
// Spin animation: the reference rotates 90 deg/s in update()
// (volume_render.cpp:256-271); here each tick advances the angle and
// re-fetches through the same render path.
setInterval(() => {
  if (P.spin) { P.spinangle = (P.spinangle + 9) % 360; refresh(); }
}, 250);
for (const [k, lo, hi, st] of DEFS) {
  const row = document.createElement("div"); row.className = "row";
  row.innerHTML = `<label>${k}</label>
    <input type="range" id="${k}" min="${lo}" max="${hi}" step="${st}"
           value="${P[k]}"/> <span id="${k}v">${P[k]}</span>`;
  box.appendChild(row);
  row.querySelector("input").addEventListener("input", e => {
    P[k] = parseFloat(e.target.value);
    document.getElementById(k + "v").textContent = e.target.value;
    refresh();
  });
}
let inflight = false, dirty = false;
async function refresh() {
  if (inflight) { dirty = true; return; }
  inflight = true;
  const q = new URLSearchParams(P).toString();
  const r = await fetch("/frame.png?" + q);
  const blob = await r.blob();
  document.getElementById("frame").src = URL.createObjectURL(blob);
  document.getElementById("stats").textContent =
    `update ${r.headers.get("X-Update-Ms")} ms | ` +
    `render ${r.headers.get("X-Render-Ms")} ms | ` +
    `renderer ${r.headers.get("X-Renderer")} | ` +
    `occupied ${r.headers.get("X-Occupied-Pct")} %`;
  inflight = false;
  if (dirty) { dirty = false; refresh(); }
}
refresh();
</script></body></html>
"""


class ViewerServer:
    """HTTP app around an Engine and its volumes. One lock serialises the
    requests (the device runs one frame at a time; the page coalesces
    slider events while a frame is in flight)."""

    def __init__(self, engine, volume, width: int, height: int,
                 host: str = "127.0.0.1", port: int = 8787):
        from .camera import fit_distance

        self.engine = engine
        self.volume = volume
        self.width = width
        self.height = height
        self.radius = fit_distance(
            50.0, np.deg2rad(60.0), width / height) * 1.3
        self.lock = threading.Lock()
        self._scene_mesh = None
        self.last = dict(update_ms=0.0, render_ms=0.0, renderer="",
                         occupied_pct=None, frames=0)
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, body: bytes, ctype: str, headers=()):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                q = {k: float(v[0]) for k, v in parse_qs(u.query).items()}
                if u.path == "/":
                    self._send(viewer.page().encode(),
                               "text/html; charset=utf-8")
                elif u.path == "/frame.png":
                    png, hdrs = viewer.frame(q)
                    self._send(png, "image/png", hdrs.items())
                elif u.path == "/voldefaults":
                    self._send(json.dumps(viewer.vol_defaults(
                        int(q.get("vol", 0)))).encode(), "application/json")
                elif u.path == "/stats":
                    self._send(json.dumps(viewer.last).encode(),
                               "application/json")
                else:
                    self.send_error(404)

        self.httpd = ThreadingHTTPServer((host, port), Handler)

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def _volumes(self) -> list:
        return self.engine.volumes or [self.volume]

    def _vol_index(self, q: dict) -> int:
        """The target volume's index, clamped; by default the constructor's
        volume (the page always sends ``vol``)."""
        vols = self._volumes()
        try:
            dflt = vols.index(self.volume)
        except ValueError:
            dflt = 0
        return min(max(int(q.get("vol", dflt)), 0), len(vols) - 1)

    def page(self) -> str:
        eo = self.engine.options
        return (_PAGE
                .replace("__W__", str(self.width))
                .replace("__H__", str(self.height))
                # The per-volume fields are /voldefaults' serialisation.
                .replace("__VOL0__",
                         json.dumps(self.vol_defaults(self._vol_index({}))))
                .replace("__VOLIDX__", str(self._vol_index({})))
                .replace("__CLIP__", repr(eo.clip_distance))
                .replace("__SKIP__", str(int(eo.skipping_type)))
                .replace("__TEST__", str(int(eo.test)))
                .replace("__ERT__",
                         "1" if eo.early_ray_termination else "0")
                .replace("__NVOL__", str(len(self._volumes()))))

    def vol_defaults(self, idx: int) -> dict:
        """The TF, translation and spin of volume ``idx`` (clamped), which
        the page loads when its volume selector switches, so that no edit
        leaks across volumes (the reference GUI has one section per
        volume)."""
        vols = self._volumes()
        v = vols[min(max(idx, 0), len(vols) - 1)]
        o = v.options
        t = v.get_translation()
        return dict(imin=o.intensity_min, imax=o.intensity_max,
                    gmin=o.gradient_min, gmax=o.gradient_max,
                    sampling=o.sampling_factor, alpha=o.voxel_alpha_factor,
                    tx=float(t[0]), ty=float(t[1]), tz=float(t[2]),
                    spinangle=float(getattr(v, "_viewer_spin_deg", 0.0)))

    def frame(self, q: dict) -> tuple[bytes, dict]:
        """Apply the page's state, render one frame, return (png, headers).

        A TF edit goes through ``Engine.update_transfer_function``, as the
        reference's GUI callback does; an unchanged TF rebuilds nothing."""
        from .camera import orbit_camera
        from .utils.image import encode_png

        with self.lock:
            # TF, translation and spin edits target the selected volume.
            vol = self._volumes()[self._vol_index(q)]
            o = vol.options
            eo = self.engine.options
            tf_new = (q.get("imin", o.intensity_min),
                      q.get("imax", o.intensity_max),
                      q.get("gmin", o.gradient_min),
                      q.get("gmax", o.gradient_max),
                      q.get("sampling", o.sampling_factor),
                      q.get("alpha", o.voxel_alpha_factor))
            update_ms = 0.0
            occupied = self.last["occupied_pct"]
            tf_changed = tf_new != (
                o.intensity_min, o.intensity_max,
                o.gradient_min, o.gradient_max,
                o.sampling_factor, o.voxel_alpha_factor)
            (o.intensity_min, o.intensity_max,
             o.gradient_min, o.gradient_max,
             o.sampling_factor, o.voxel_alpha_factor) = tf_new
            # The ESS radio first (src/volume_render.cpp:512-518): it
            # rebuilds every volume with the new TF already applied, so a
            # TF and ESS edit in one request pays one rebuild. Each rebuild
            # is synchronised, so X-Update-Ms is its time on the device,
            # not its dispatch.
            st_new = SkippingType(int(q.get("skipmode", int(
                eo.skipping_type))))
            if st_new != eo.skipping_type:
                t0 = time.perf_counter()
                self.engine.set_skipping_type(st_new)
                self.engine._sync()
                update_ms = (time.perf_counter() - t0) * 1e3
            elif tf_changed:
                t0 = time.perf_counter()
                stats = self.engine.update_transfer_function(
                    vol, timed_runs=1)
                self.engine._sync()
                update_ms = (time.perf_counter() - t0) * 1e3
                occupied = stats.occupied_voxel_percent
            # ERT, Test and the clip distance take effect in the next
            # frame; nothing to rebuild.
            eo.early_ray_termination = q.get(
                "ert", 1.0 if eo.early_ray_termination else 0.0) > 0.0
            eo.test = Test(int(q.get("test", int(eo.test))))
            eo.clip_distance = float(q.get("clip", eo.clip_distance))
            # Spin is kept per volume: a selector switch neither carries
            # one volume's angle to another nor resets it.
            if "spinangle" in q:
                ang = float(q["spinangle"])
                if ang != getattr(vol, "_viewer_spin_deg", 0.0):
                    vol.set_spin(float(np.deg2rad(ang)))
                    vol._viewer_spin_deg = ang
            t_cur = vol.get_translation()
            t_new = (q.get("tx", float(t_cur[0])),
                     q.get("ty", float(t_cur[1])),
                     q.get("tz", float(t_cur[2])))
            if not np.allclose(t_new, t_cur):
                # The per-volume XYZ drag (src/volume_render.cpp:464-468);
                # the engine's pose cache keys on the model matrix.
                vol.set_translation(t_new)
            cam = orbit_camera(
                radius=self.radius,
                azimuth_deg=q.get("azimuth", 30.0),
                elevation_deg=q.get("elevation", 20.0),
                aspect=self.width / self.height)
            mesh = None
            if q.get("scene", 0.0) > 0.0:
                from .render.forward import sponza_lite

                if self._scene_mesh is None:
                    self._scene_mesh = sponza_lite()
                mesh = self._scene_mesh
            t0 = time.perf_counter()
            rgb = self.engine.render_image(cam, self.width, self.height,
                                           scene_mesh=mesh)
            render_ms = (time.perf_counter() - t0) * 1e3
            self.last = dict(
                update_ms=round(update_ms, 2),
                render_ms=round(render_ms, 2),
                renderer=self.engine.last_renderer,
                occupied_pct=occupied,
                frames=self.last["frames"] + 1)
        return encode_png(rgb), {
            "X-Update-Ms": f"{update_ms:.1f}",
            "X-Render-Ms": f"{render_ms:.1f}",
            "X-Renderer": str(self.engine.last_renderer),
            "X-Occupied-Pct": str(occupied),
            "Cache-Control": "no-store",
        }

    def serve_forever(self):
        print(f"viewer listening on http://{self.httpd.server_address[0]}:"
              f"{self.port}/", flush=True)
        self.httpd.serve_forever()

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def main(argv=None) -> int:
    from .cli import build_parser, setup_engine

    p = build_parser()
    p.add_argument("--port", type=int, default=8787)
    p.add_argument("--host", default="127.0.0.1")
    args = p.parse_args(argv)
    engine, volumes = setup_engine(args)
    t0 = time.perf_counter()
    for volume in volumes:
        engine.add_volume(volume)
    print(f"Prepared in {time.perf_counter() - t0:.2f}s", flush=True)
    # The page edits the first volume; /frame.png?vol=<i> reaches the
    # others.
    srv = ViewerServer(engine, volumes[0], args.width, args.height,
                       host=args.host, port=args.port)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())

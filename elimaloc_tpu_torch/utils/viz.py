"""Interactive replay visualization — the rviz-profile equivalent (a copy of
``elimaloc_tpu.utils.viz``; the page is the same).

The reference ships an rviz configuration showing the map cloud, the fused
pose, GNSS markers, covariance ellipsoids and 12 Float32 plot topics
(reference: src/app/localization/ekf_localization/rviz/
ekf_localization_rviz.rviz; publishers at ekf_localization.cpp:64-84,
426-502, 613-640 and pcm_matching.cpp:103-113, 826-898). This module renders
the same content without ROS: one SELF-CONTAINED interactive HTML file
(canvas top-down view with pan/zoom/hover + time-series strips), viewable in
any browser, no network access or dependencies.
"""

from __future__ import annotations

import json

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>elimaloc_tpu replay</title>{refresh}
<style>
 body { margin:0; background:#14151a; color:#d8dae0;
        font:13px/1.4 system-ui, sans-serif; }
 #wrap { display:flex; height:100vh; }
 #left { flex:1 1 70%; position:relative; }
 canvas { display:block; width:100%; height:100%; cursor:grab; }
 #side { flex:0 0 320px; padding:10px 14px; overflow-y:auto;
         border-left:1px solid #2a2c33; }
 .strip { margin-bottom:10px; }
 .strip .lbl { color:#9aa0ac; margin-bottom:2px; }
 .strip canvas { height:54px; background:#1b1d23; border-radius:4px; }
 #hud { position:absolute; left:10px; top:8px; color:#9aa0ac;
        pointer-events:none; white-space:pre; }
 h3 { margin:4px 0 10px; font-size:14px; color:#fff; }
</style></head><body>
<div id="wrap">
 <div id="left"><canvas id="view"></canvas><div id="hud"></div></div>
 <div id="side"><h3>elimaloc_tpu replay</h3><div id="strips"></div></div>
</div>
<script>
const DATA = __DATA__;
const view = document.getElementById('view');
const hud = document.getElementById('hud');
const ctx = view.getContext('2d');
let scale = 4, ox = 0, oy = 0, drag = null;

function fit() {
  const xs = DATA.est.map(p => p[0]), ys = DATA.est.map(p => p[1]);
  const cx = (Math.min(...xs) + Math.max(...xs)) / 2;
  const cy = (Math.min(...ys) + Math.max(...ys)) / 2;
  const span = Math.max(Math.max(...xs) - Math.min(...xs),
                        Math.max(...ys) - Math.min(...ys), 10);
  scale = Math.min(view.width, view.height) / (span * 1.3);
  ox = view.width / 2 - cx * scale;
  oy = view.height / 2 + cy * scale;
}
function W(p) { return [p[0] * scale + ox, -p[1] * scale + oy]; }

function draw() {
  const w = view.clientWidth, h = view.clientHeight;
  if (view.width !== w) { view.width = w; view.height = h; }
  ctx.fillStyle = '#14151a'; ctx.fillRect(0, 0, w, h);
  ctx.fillStyle = '#343843';
  for (const p of DATA.map) {
    const [x, y] = W(p);
    if (x > -2 && x < w + 2 && y > -2 && y < h + 2) ctx.fillRect(x, y, 1.5, 1.5);
  }
  // covariance ellipses (2-sigma), reference's cov-ellipsoid markers
  ctx.strokeStyle = 'rgba(255,184,76,.8)';
  for (const e of DATA.cov) {
    const [x, y] = W(e);
    ctx.beginPath();
    ctx.ellipse(x, y, Math.max(e[2] * scale * 2, 1.5),
                Math.max(e[3] * scale * 2, 1.5), -e[4], 0, 6.2832);
    ctx.stroke();
  }
  function path(pts, color, lw) {
    ctx.strokeStyle = color; ctx.lineWidth = lw; ctx.beginPath();
    pts.forEach((p, i) => { const [x, y] = W(p);
      i ? ctx.lineTo(x, y) : ctx.moveTo(x, y); });
    ctx.stroke();
  }
  if (DATA.truth.length) path(DATA.truth, '#51d88a', 1.2);
  path(DATA.est, '#5aa7ff', 1.8);
  const last = W(DATA.est[DATA.est.length - 1]);
  ctx.fillStyle = '#5aa7ff'; ctx.beginPath();
  ctx.arc(last[0], last[1], 4, 0, 6.2832); ctx.fill();
  hud.textContent = `est (blue) ${DATA.est.length} poses` +
    (DATA.truth.length ? ' · truth (green)' : '') +
    (DATA.cov.length ? ' · 2sigma cov (amber)' : '') +
    `\\nscroll: zoom · drag: pan`;
}
view.addEventListener('wheel', ev => {
  ev.preventDefault();
  const f = ev.deltaY < 0 ? 1.15 : 1 / 1.15;
  ox = ev.offsetX - (ev.offsetX - ox) * f;
  oy = ev.offsetY - (ev.offsetY - oy) * f;
  scale *= f; draw();
});
view.addEventListener('mousedown', ev => drag = [ev.clientX, ev.clientY]);
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('mousemove', ev => {
  if (!drag) return;
  ox += ev.clientX - drag[0]; oy += ev.clientY - drag[1];
  drag = [ev.clientX, ev.clientY]; draw();
});
function strip(name, vals, color) {
  const div = document.createElement('div'); div.className = 'strip';
  div.innerHTML = `<div class="lbl">${name}</div>`;
  const c = document.createElement('canvas');
  div.appendChild(c); document.getElementById('strips').appendChild(div);
  c.width = c.clientWidth || 292; c.height = 54;
  const g = c.getContext('2d');
  const lo = Math.min(...vals), hi = Math.max(...vals), sp = (hi - lo) || 1;
  g.strokeStyle = color; g.beginPath();
  vals.forEach((v, i) => {
    const x = i / (vals.length - 1 || 1) * c.width;
    const y = c.height - 4 - (v - lo) / sp * (c.height - 8);
    i ? g.lineTo(x, y) : g.moveTo(x, y);
  });
  g.stroke();
  g.fillStyle = '#9aa0ac'; g.font = '10px system-ui';
  g.fillText(hi.toPrecision(3), 2, 10);
  g.fillText(lo.toPrecision(3), 2, c.height - 2);
}
window.addEventListener('resize', draw);
fit(); draw();
for (const [name, vals, color] of DATA.strips) strip(name, vals, color);
</script></body></html>
"""


def export_viz_html(path, est_pos, *, map_points=None, truth_pos=None,
                    scans=None, cov=None, max_map_points: int = 60_000,
                    live_refresh_s: float | None = None):
    """Write a self-contained interactive HTML replay view.
    ``live_refresh_s``: inject a meta-refresh so an open browser tab follows
    a run that keeps re-exporting the file (see :class:`LiveViz`).

    Args:
      est_pos: [N,3] estimated trajectory.
      map_points: optional [M,3] map cloud (subsampled for display).
      truth_pos: optional [K,3] ground-truth trajectory.
      scans: optional list of per-scan diagnostics dicts (the replay's
        ``traj["scans"]``) -> rendered as time-series strips (the Float32
        plot-topic analog: fitness, iterations, overlap, applied).
      cov: optional [N,5] per-pose (x, y, sx, sy, angle_rad) 2D covariance
        ellipse parameters.
    """
    est = np.asarray(est_pos, float)
    if est.size == 0:
        raise ValueError(
            "export_viz_html: empty estimated trajectory (no scan events "
            "fired?) — nothing to render"
        )
    data = {
        "est": est[:, :2].round(3).tolist(),
        "truth": [],
        "map": [],
        "cov": [],
        "strips": [],
    }
    if truth_pos is not None:
        data["truth"] = np.asarray(truth_pos, float)[:, :2].round(3).tolist()
    if map_points is not None:
        mp = np.asarray(map_points, float)
        if len(mp) > max_map_points:
            idx = np.random.default_rng(0).choice(
                len(mp), max_map_points, replace=False)
            mp = mp[idx]
        data["map"] = mp[:, :2].round(2).tolist()
    if cov is not None:
        data["cov"] = np.asarray(cov, float).round(4).tolist()
    if scans:
        def series(key, cast=float):
            return [cast(s[key]) for s in scans if s and key in s]

        for name, key, color in (
            ("ICP fitness", "fitness", "#ffb84c"),
            ("ICP iterations", "iterations", "#5aa7ff"),
            ("correspondence overlap", "overlap", "#51d88a"),
            ("measurement applied", "applied", "#d072e0"),
        ):
            vals = series(key)
            if vals:
                data["strips"].append([name, vals, color])
    refresh = (
        f'<meta http-equiv="refresh" content="{max(live_refresh_s, 0.2):g}">'
        if live_refresh_s is not None else ""
    )
    html = _PAGE.replace("{refresh}", refresh)
    html = html.replace("__DATA__", json.dumps(data))
    with open(path, "w") as fh:
        fh.write(html)
    return path


class LiveViz:
    """Watch a replay converge MID-RUN (the operator experience of the
    reference's continuously-published rviz markers and plot topics,
    ekf_localization.cpp:426-640): pass ``on_scan=LiveViz(...).on_scan`` to
    ``LocalizationPipeline.run`` / ``run_frames`` and open the HTML in a
    browser — it re-exports (throttled) after each scan and auto-refreshes.

    Reading the per-scan pose back costs one device sync per scan; use for
    interactive/monitored runs, not throughput benchmarks.
    """

    def __init__(self, path, *, map_points=None, truth_pos=None,
                 refresh_s: float = 1.0, max_map_points: int = 60_000):
        import time as _time

        self.path = path
        self.refresh_s = refresh_s
        self._time = _time
        self._last = 0.0
        self._map = None
        if map_points is not None:
            mp = np.asarray(map_points, float)
            if len(mp) > max_map_points:
                idx = np.random.default_rng(0).choice(
                    len(mp), max_map_points, replace=False)
                mp = mp[idx]
            self._map = mp
        self._truth = truth_pos
        self.positions = []
        self.scans = []

    def on_scan(self, out):
        """Per-scan observer: ``out`` is the scan_step output dict plus
        ego_pos/ego_t (device or host arrays)."""
        self.positions.append(np.asarray(out["ego_pos"], float))
        self.scans.append({
            k: np.asarray(v) for k, v in out.items()
            if k in ("fitness", "iterations", "overlap", "applied")
        })
        now = self._time.time()
        if now - self._last >= self.refresh_s:
            self._last = now
            self._write(live=True)

    def finish(self):
        """Final (non-refreshing) export."""
        self._write(live=False)

    def _write(self, live: bool):
        export_viz_html(
            self.path, np.stack(self.positions),
            map_points=self._map, truth_pos=self._truth, scans=self.scans,
            live_refresh_s=self.refresh_s if live else None,
        )

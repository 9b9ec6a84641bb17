"""Live training dashboard, the replacement of the reference's visdom panels.

A copy of ``feature_intertwiner_tpu/utils/monitor.py`` (standard library
only). The reference serves four visdom panels while it trains: a loss line
plot, the config, a status line and the validation AP.

- :func:`write_dashboard` writes a self-contained ``dashboard.html`` (and
  ``config.json``) into the run folder. The page polls ``metrics.jsonl`` and
  ``config.json`` every 2.5 s and draws the four panels as SVG: the loss
  curves with a hover crosshair and tooltip, the run's status (epoch, iter,
  lr, how long ago the last record came), the validation AP and the config.
  The series it plots are keys of the train lines that the trainer writes
  to ``metrics.jsonl``. Open the page through any static file server.
- :func:`serve` starts such a server (``http.server`` on a daemon thread,
  no-cache headers); :func:`maybe_serve` starts it under
  ``MISC.USE_VISDOM`` on ``MISC.VIS.PORT``.

The trainer writes the dashboard when it is built and serves it under
``MISC.USE_VISDOM`` (``train/workflow.py::Trainer``).
"""

from __future__ import annotations

import functools
import http.server
import json
import os
import threading
from typing import Optional

# Categorical palette (validated light/dark pairs; identity-stable slots:
# each loss component keeps its hue regardless of which series are toggled)
_SERIES = [
    ("total_loss", "total", "#2a78d6", "#3987e5"),
    ("rpn_class_loss", "rpn_cls", "#eb6834", "#d95926"),
    ("rpn_bbox_loss", "rpn_box", "#1baf7a", "#199e70"),
    ("mrcnn_class_loss", "cls", "#eda100", "#c98500"),
    ("mrcnn_bbox_loss", "bbox", "#e87ba4", "#d55181"),
    ("mrcnn_mask_loss", "mask", "#008300", "#008300"),
    ("meta_loss", "meta", "#4a3aa7", "#9085e9"),
    ("big_loss", "big", "#e34948", "#e66767"),
]
_AP_SERIES = [
    ("AP", "AP", "#2a78d6", "#3987e5"),
    ("AP50", "AP50", "#eb6834", "#d95926"),
    ("AP_small", "AP_small", "#1baf7a", "#199e70"),
]

_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>InterNet run monitor</title>
<style>
.viz-root {
  color-scheme: light;
  --surface-1: #fcfcfb; --surface-2: #f0efec;
  --text-primary: #0b0b0b; --text-secondary: #52514e;
  --grid: #e3e2de;
}
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .viz-root {
    color-scheme: dark;
    --surface-1: #1a1a19; --surface-2: #262625;
    --text-primary: #ffffff; --text-secondary: #c3c2b7;
    --grid: #383835;
  }
}
body { margin: 0; font: 13px/1.45 system-ui, sans-serif; }
.viz-root { background: var(--surface-1); color: var(--text-primary);
  min-height: 100vh; padding: 16px 20px; box-sizing: border-box; }
h1 { font-size: 16px; margin: 0 0 2px; }
h2 { font-size: 13px; margin: 0 0 6px; color: var(--text-secondary);
  font-weight: 600; }
.sub { color: var(--text-secondary); margin-bottom: 14px; }
.grid { display: grid; grid-template-columns: 2fr 1fr; gap: 16px; }
.panel { background: var(--surface-2); border-radius: 8px; padding: 12px; }
.legend { display: flex; flex-wrap: wrap; gap: 4px 12px; margin: 6px 0 0; }
.legend label { display: inline-flex; align-items: center; gap: 5px;
  color: var(--text-secondary); cursor: pointer; user-select: none; }
.legend .sw { width: 10px; height: 10px; border-radius: 2px;
  display: inline-block; }
.legend input { margin: 0; }
svg text { fill: var(--text-secondary); font: 11px system-ui, sans-serif; }
svg .gridline { stroke: var(--grid); stroke-width: 1; }
svg .axis { stroke: var(--grid); stroke-width: 1; }
.tip { position: fixed; pointer-events: none; background: var(--surface-1);
  border: 1px solid var(--grid); border-radius: 6px; padding: 6px 9px;
  font-size: 12px; display: none; z-index: 10; max-width: 260px; }
.tip b { color: var(--text-primary); }
.status td { padding: 1px 10px 1px 0; color: var(--text-secondary); }
.status td:last-child { color: var(--text-primary);
  font-variant-numeric: tabular-nums; }
pre { white-space: pre-wrap; font-size: 11px; max-height: 340px;
  overflow: auto; color: var(--text-secondary); margin: 0; }
.stale { color: #e34948; font-weight: 600; }
details summary { cursor: pointer; color: var(--text-secondary); }
table.data { border-collapse: collapse; font-size: 11px; }
table.data td, table.data th { border: 1px solid var(--grid);
  padding: 2px 6px; font-variant-numeric: tabular-nums; }
.toggles { margin: 4px 0 0; color: var(--text-secondary); }
</style></head>
<body><div class="viz-root">
<h1>InterNet run monitor</h1>
<div class="sub" id="runinfo">waiting for metrics.jsonl …</div>
<div class="grid">
  <div class="panel"><h2>Training loss</h2>
    <svg id="loss" width="100%" height="300"></svg>
    <div class="legend" id="losslegend"></div>
    <div class="toggles"><label><input type="checkbox" id="logy">
      log y</label></div>
  </div>
  <div>
    <div class="panel" style="margin-bottom:16px"><h2>Status</h2>
      <table class="status" id="status"></table></div>
    <div class="panel"><h2>Validation AP</h2>
      <svg id="ap" width="100%" height="170"></svg>
      <div class="legend" id="aplegend"></div></div>
  </div>
</div>
<div class="grid" style="margin-top:16px">
  <div class="panel"><details><summary>Last records (table view)</summary>
    <table class="data" id="table"></table></details></div>
  <div class="panel"><details open><summary>Config</summary>
    <pre id="config">…</pre></details></div>
</div>
<div class="tip" id="tip"></div>
<script>
const SERIES = __SERIES__;
const AP_SERIES = __AP_SERIES__;
const dark = () => matchMedia('(prefers-color-scheme: dark)').matches;
const col = s => dark() ? s[3] : s[2];
const on = Object.fromEntries(SERIES.map((s,i) => [s[0], i < 7]));
let recs = [], evals = [];

function legend(el, series, state) {
  el.innerHTML = '';
  for (const s of series) {
    const lab = document.createElement('label');
    const sw = `<span class="sw" style="background:${col(s)}"></span>`;
    if (state) {
      lab.innerHTML = `<input type="checkbox" ${state[s[0]]?'checked':''}>` +
        sw + s[1];
      lab.querySelector('input').onchange = e => {
        state[s[0]] = e.target.checked; draw(); };
    } else lab.innerHTML = sw + s[1];
    el.appendChild(lab);
  }
}
legend(document.getElementById('losslegend'), SERIES, on);
legend(document.getElementById('aplegend'), AP_SERIES, null);
document.getElementById('logy').onchange = draw;

function chart(svg, pts, series, active, fmt) {
  // pts: [{x, <key>: value}]; draws 2px lines, recessive grid, no dual axis
  const W = svg.clientWidth || 600, H = +svg.getAttribute('height');
  const m = {t: 8, r: 10, b: 20, l: 46};
  svg.setAttribute('viewBox', `0 0 ${W} ${H}`);
  const logy = document.getElementById('logy').checked && svg.id === 'loss';
  let lo = Infinity, hi = -Infinity;
  for (const p of pts) for (const s of series) {
    if (!active(s[0])) continue;
    let v = p[s[0]]; if (v == null || !isFinite(v)) continue;
    if (logy && v <= 0) continue;
    if (logy) v = Math.log10(v);
    if (v < lo) lo = v; if (v > hi) hi = v;
  }
  if (!(hi > lo)) { lo = 0; hi = 1; }
  const pad = (hi - lo) * 0.05 || 0.5; lo -= pad; hi += pad;
  const X = i => m.l + (W - m.l - m.r) * (pts.length < 2 ? 0.5
      : i / (pts.length - 1));
  const Y = v => { if (logy) v = Math.log10(Math.max(v, 1e-12));
    return m.t + (H - m.t - m.b) * (1 - (v - lo) / (hi - lo)); };
  let g = '';
  for (let k = 0; k <= 4; k++) {
    const v = lo + (hi - lo) * k / 4, y = m.t + (H - m.t - m.b) * (1 - k/4);
    const lbl = logy ? Math.pow(10, v) : v;
    g += `<line class="gridline" x1="${m.l}" x2="${W-m.r}" y1="${y}"` +
         ` y2="${y}"/><text x="${m.l-6}" y="${y+3}" text-anchor="end">` +
         `${fmt(lbl)}</text>`;
  }
  for (const s of series) {
    if (!active(s[0])) continue;
    let d = '', pen = false;
    for (let i = 0; i < pts.length; i++) {
      const v = pts[i][s[0]];
      if (v == null || !isFinite(v) || (logy && v <= 0)) { pen = false;
        continue; }
      d += (pen ? 'L' : 'M') + X(i).toFixed(1) + ' ' + Y(v).toFixed(1);
      pen = true;
    }
    if (d) g += `<path d="${d}" fill="none" stroke="${col(s)}"` +
                ` stroke-width="2" stroke-linejoin="round"/>`;
  }
  g += `<line class="axis" x1="${m.l}" x2="${W-m.r}" y1="${H-m.b}"` +
       ` y2="${H-m.b}"/>`;
  svg.innerHTML = g;
  svg.onmousemove = e => {
    if (!pts.length) return;
    const r = svg.getBoundingClientRect();
    const fx = (e.clientX - r.left - m.l) / (W - m.l - m.r);
    const i = Math.max(0, Math.min(pts.length - 1,
        Math.round(fx * (pts.length - 1))));
    const tip = document.getElementById('tip');
    let html = `<b>${pts[i].label || ('step ' + (i+1))}</b><br>`;
    for (const s of series) {
      const v = pts[i][s[0]];
      if (v == null || !active(s[0])) continue;
      html += `<span class="sw" style="background:${col(s)};display:` +
        `inline-block;width:8px;height:8px;border-radius:2px"></span> ` +
        `${s[1]}: <b>${fmt(v)}</b><br>`;
    }
    tip.innerHTML = html;
    tip.style.display = 'block';
    tip.style.left = Math.min(e.clientX + 14, innerWidth - 280) + 'px';
    tip.style.top = (e.clientY + 12) + 'px';
    const old = svg.querySelector('.cross'); if (old) old.remove();
    svg.insertAdjacentHTML('beforeend', `<line class="cross axis"` +
      ` x1="${X(i)}" x2="${X(i)}" y1="${m.t}" y2="${H-m.b}"/>`);
  };
  svg.onmouseleave = () => {
    document.getElementById('tip').style.display = 'none';
    const old = svg.querySelector('.cross'); if (old) old.remove();
  };
}

function draw() {
  const MAX = 1500, stride = Math.max(1, Math.ceil(recs.length / MAX));
  const pts = recs.filter((_, i) => i % stride === 0 ||
      i === recs.length - 1).map(r => ({...r,
      label: `ep ${r.epoch ?? '?'} iter ${r.iter ?? '?'}`}));
  chart(document.getElementById('loss'), pts, SERIES, k => on[k],
        v => v >= 100 ? v.toFixed(0) : v.toFixed(v >= 1 ? 2 : 4));
  const apts = evals.map(r => ({...r, label: `ep ${r.epoch ?? '?'}`}));
  chart(document.getElementById('ap'), apts, AP_SERIES, () => true,
        v => v.toFixed(3));
  const st = document.getElementById('status');
  const last = recs[recs.length - 1];
  if (last) {
    const ago = (Date.now() / 1000) - last.time;
    const agoStr = ago < 90 ? `${ago.toFixed(0)}s ago`
        : `<span class="stale">${(ago/60).toFixed(1)} min ago — ` +
          `stalled?</span>`;
    st.innerHTML =
      `<tr><td>epoch / iter</td><td>${last.epoch} / ${last.iter}</td></tr>` +
      `<tr><td>lr</td><td>${(last.lr ?? 0).toExponential(2)}</td></tr>` +
      `<tr><td>total loss</td><td>${(last.total_loss ?? 0).toFixed(4)}` +
      `</td></tr><tr><td>meta loss</td><td>` +
      `${(last.meta_loss ?? 0).toFixed(4)}</td></tr>` +
      `<tr><td>last update</td><td>${agoStr}</td></tr>` +
      `<tr><td>records</td><td>${recs.length}</td></tr>`;
  }
  const tbl = document.getElementById('table');
  const lastN = recs.slice(-12);
  if (lastN.length) {
    const keys = ['epoch','iter','lr','total_loss','meta_loss'];
    tbl.innerHTML = '<tr>' + keys.map(k => `<th>${k}</th>`).join('') +
      '</tr>' + lastN.map(r => '<tr>' + keys.map(k =>
        `<td>${typeof r[k] === 'number' ? +r[k].toFixed(5) : r[k] ?? ''}` +
        `</td>`).join('') + '</tr>').join('');
  }
}

async function poll() {
  try {
    const txt = await (await fetch('metrics.jsonl',
        {cache: 'no-store'})).text();
    const rows = txt.split('\\n').filter(Boolean).map(JSON.parse);
    recs = rows.filter(r => 'total_loss' in r);
    evals = rows.filter(r => 'AP' in r);
    document.getElementById('runinfo').textContent =
      `${recs.length} train records · ${evals.length} evals · ` +
      `polling every 2.5 s`;
    draw();
  } catch (e) { /* metrics not written yet */ }
}
(async () => {
  try {
    const cfg = await (await fetch('config.json', {cache:'no-store'})).json();
    document.getElementById('config').textContent =
        JSON.stringify(cfg, null, 1);
  } catch (e) { document.getElementById('config').textContent =
      'config.json not found'; }
  await poll(); setInterval(poll, 2500);
})();
addEventListener('resize', draw);
</script></div></body></html>
"""


def dashboard_html() -> str:
    return (_HTML
            .replace("__SERIES__", json.dumps(_SERIES))
            .replace("__AP_SERIES__", json.dumps(_AP_SERIES)))


def write_dashboard(folder: str, config=None) -> str:
    """Write dashboard.html (+ config.json) into the run folder."""
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, "dashboard.html")
    with open(path, "w") as f:
        f.write(dashboard_html())
    if config is not None:
        try:
            dump = config.to_dict() if hasattr(config, "to_dict") else dict(
                config)
        except Exception:
            dump = {"repr": repr(config)}
        with open(os.path.join(folder, "config.json"), "w") as f:
            json.dump(dump, f, indent=1, default=str)
    return path


class _Handler(http.server.SimpleHTTPRequestHandler):
    def end_headers(self):
        self.send_header("Cache-Control", "no-store")
        super().end_headers()

    def log_message(self, *a):  # quiet
        pass


def serve(folder: str, port: int = 8097,
          host: str = "127.0.0.1") -> "http.server.ThreadingHTTPServer":
    """Serve the run folder on a daemon thread; returns the server
    (call ``server.shutdown()`` to stop it).

    Port default 8097 matches visdom's (the panel system this replaces).
    Port 0 picks a free port — read it back from ``server.server_address``.
    Binds loopback by default: the run folder holds checkpoints and config,
    which should not be exposed to the network unasked."""
    handler = functools.partial(_Handler, directory=folder)
    srv = http.server.ThreadingHTTPServer((host, port), handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv


def maybe_serve(cfg, folder: str) -> Optional["http.server.ThreadingHTTPServer"]:
    """Start the live monitor when MISC.USE_VISDOM is set (config parity:
    the reference's visdom switch + CTRL.VIS ports, lib/config.py:332-351).

    Never fatal: a taken port (another Trainer in this process, a parallel
    run, a real visdom) degrades to the file-only dashboard with a note —
    monitoring must not kill training."""
    if not cfg.MISC.get("USE_VISDOM", False):
        return None
    port = int(cfg.MISC.VIS.PORT)
    port = port if port > 0 else 8097
    try:
        srv = serve(folder, port)
    except OSError as exc:
        print(f"[monitor] port {port} unavailable ({exc}); "
              f"open {os.path.join(folder, 'dashboard.html')} directly")
        return None
    print(f"[monitor] live dashboard: "
          f"http://localhost:{srv.server_address[1]}/dashboard.html")
    return srv

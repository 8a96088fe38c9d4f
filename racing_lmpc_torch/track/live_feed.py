"""Live operator visualization feed — the lmpc.foxglove.json equivalent.

Port of ``racing_lmpc_tpu/track/live_feed.py`` (stdlib HTTP, the same
snapshot schema).  The reference ships a Foxglove layout fed by ROS topics:
track polygons (ros_trajectory_visualizer.cpp:92-142), the predicted and
reference paths and the green safe-set MarkerArray
(racing_mpc_node.cpp:405-472), diagnostics and telemetry.  This module
serves the same scene over plain HTTP from the in-process runners:

- ``GET /scene``  -> one JSON snapshot {track, prediction, reference,
  safe_set, vehicle, telemetry, seq}, schema-stable so any dashboard can
  poll it;
- ``GET /stream`` -> server-sent-events (SSE) stream of the same snapshots,
  pushed on every ``update()``;
- ``GET /``       -> a self-contained HTML canvas viewer (no external
  assets) drawing the track, boundaries, predicted path, safe-set markers
  and the vehicle polygon live.

Thread-safe: the co-simulation calls ``update()`` from its thread; the HTTP
server runs daemon threads.  Start with ``feed = LiveFeed(visualizer);
feed.start(port)``; runners wire it via ``attach_live_feed``.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

_VIEWER_HTML = """<!DOCTYPE html>
<html><head><title>racing-lmpc live</title><style>
body{background:#111;color:#ddd;font-family:monospace;margin:0}
#hud{position:fixed;top:8px;left:8px;white-space:pre}
canvas{display:block}
</style></head><body>
<div id="hud"></div><canvas id="c"></canvas><script>
const cv=document.getElementById('c'),cx=cv.getContext('2d');
function fit(){cv.width=innerWidth;cv.height=innerHeight}addEventListener('resize',fit);fit();
let scene=null;
const es=new EventSource('/stream');
es.onmessage=e=>{scene=JSON.parse(e.data);draw()};
function draw(){if(!scene)return;const s=scene;cx.clearRect(0,0,cv.width,cv.height);
 const pts=s.track.center;let xs=pts.map(p=>p[0]),ys=pts.map(p=>p[1]);
 const x0=Math.min(...xs),x1=Math.max(...xs),y0=Math.min(...ys),y1=Math.max(...ys);
 const m=40,sc=Math.min((cv.width-2*m)/(x1-x0),(cv.height-2*m)/(y1-y0));
 const T=p=>[m+(p[0]-x0)*sc,cv.height-m-(p[1]-y0)*sc];
 const line=(ps,col,w)=>{cx.strokeStyle=col;cx.lineWidth=w;cx.beginPath();
  ps.forEach((p,i)=>{const q=T(p);i?cx.lineTo(q[0],q[1]):cx.moveTo(q[0],q[1])});cx.stroke()};
 line(s.track.left,'#555',1);line(s.track.right,'#555',1);line(s.track.center,'#333',1);
 if(s.reference)line(s.reference,'#46f',2);
 if(s.prediction)line(s.prediction,'#fa0',2);
 if(s.safe_set)s.safe_set.forEach(p=>{const q=T(p);cx.fillStyle='#0f0';
  cx.fillRect(q[0]-2,q[1]-2,4,4)});
 if(s.vehicle){cx.fillStyle='#f33';cx.beginPath();
  s.vehicle.forEach((p,i)=>{const q=T(p);i?cx.lineTo(q[0],q[1]):cx.moveTo(q[0],q[1])});
  cx.closePath();cx.fill()}
 document.getElementById('hud').textContent=JSON.stringify(s.telemetry||{},null,1)}
</script></body></html>"""


class LiveFeed:
    """Holds the latest scene snapshot and serves it over HTTP/SSE."""

    def __init__(self, visualizer=None):
        self._lock = threading.Lock()
        self._seq = 0
        self._cond = threading.Condition(self._lock)
        self._scene = {"track": {"center": [], "left": [], "right": []}}
        self._server = None
        if visualizer is not None:
            self.set_track(visualizer)

    # -- producers ------------------------------------------------------
    def set_track(self, visualizer):
        """Load the track polylines (1000-sample polylines, matching
        ROSTrajectoryVisualizer's sampling)."""
        pl = visualizer.polylines()
        with self._cond:
            self._scene["track"] = {
                k: np.asarray(pl[k])[:, :2].tolist()
                for k in ("center", "left", "right")}

    def update(self, prediction=None, reference=None, safe_set=None,
               vehicle=None, telemetry=None):
        """Push a new snapshot (arrays are (n, 2) global xy)."""
        with self._cond:
            if prediction is not None:
                self._scene["prediction"] = np.asarray(prediction)[:, :2].tolist()
            if reference is not None:
                self._scene["reference"] = np.asarray(reference)[:, :2].tolist()
            if safe_set is not None:
                self._scene["safe_set"] = np.asarray(safe_set)[:, :2].tolist()
            if vehicle is not None:
                self._scene["vehicle"] = np.asarray(vehicle)[:, :2].tolist()
            if telemetry is not None:
                self._scene["telemetry"] = telemetry
            self._seq += 1
            self._cond.notify_all()

    def snapshot(self) -> dict:
        with self._lock:
            return json.loads(json.dumps({**self._scene, "seq": self._seq}))

    def wait_seq(self, after: int, timeout: float = 10.0):
        """Block until a snapshot newer than ``after`` exists (SSE path)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._seq <= after:
                left = deadline - time.monotonic()
                if left <= 0:
                    return None
                self._cond.wait(left)
            return {**json.loads(json.dumps(self._scene)), "seq": self._seq}

    # -- server ----------------------------------------------------------
    def start(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """Start the HTTP server on a daemon thread; returns the bound port."""
        feed = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/":
                    body = _VIEWER_HTML.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/scene":
                    body = json.dumps(feed.snapshot()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    seq = -1
                    try:
                        while True:
                            scene = feed.wait_seq(seq, timeout=30.0)
                            if scene is None:
                                self.wfile.write(b": keepalive\n\n")
                                self.wfile.flush()
                                continue
                            seq = scene["seq"]
                            self.wfile.write(
                                b"data: " + json.dumps(scene).encode() + b"\n\n")
                            self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError):
                        return
                else:
                    self.send_error(404)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()
        return self._server.server_address[1]

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server = None


def attach_live_feed(cosim, port: int = 0):
    """Wire a LiveFeed into a CoSimulation: every controller cycle pushes
    the predicted path, safe-set markers and vehicle polygon (the topics of
    racing_mpc_node.cpp:405-472).  The plan and the plant state live on the
    co-simulation's device: each cycle copies them to the host once, inside
    the wrapped ``controller_cycle``; the geometry runs on the track's host
    twins.  Returns (feed, port)."""
    from racing_lmpc_torch.track.visualizer import TrajectoryVisualizer

    viz = TrajectoryVisualizer(cosim.track)
    feed = LiveFeed(viz)
    bound = feed.start(port)
    ctrl = cosim.controller
    orig_cycle = cosim.controller_cycle

    def cycle(msg):
        act = orig_cycle(msg)
        st = ctrl.state
        if st is not None:
            n = st.last_X.numel()
            host = torch.cat([st.last_X.reshape(-1),
                              cosim.simulator.x.reshape(-1).to(st.last_X)]).cpu().numpy()
            last_X = host[:n].reshape(st.last_X.shape)
            pred = viz.prediction_path(last_X)
            ch = ctrl.model.base_config.chassis
            veh = viz.vehicle_polygon(host[n:n + 3], 1.2 * ch.wheel_base, ch.b)
            ss = None
            if ctrl.ss_manager is not None and ctrl.ss_manager.num_laps:
                ss_x, _, found = ctrl.ss_manager.query_padded(
                    last_X[-1], ctrl.mpc.K or 8,
                    max(ctrl.config.num_ss_pts_per_lap, 1))
                if found:
                    ss = viz.safe_set_markers(ss_x)
            tel = cosim.telemetry[-1].to_dict() if cosim.telemetry else None
            feed.update(prediction=pred, safe_set=ss, vehicle=veh,
                        telemetry=tel)
        return act

    cosim.controller_cycle = cycle
    return feed, bound

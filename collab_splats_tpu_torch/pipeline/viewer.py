"""Interactive splat viewer: dependency-free HTTP and canvas orbit controls.

Counterpart of the JAX package's ``pipeline/viewer.py``, filling the role of
the reference's ``ns-viewer``: inspect a trained splat interactively.  The
model's own rasterizer renders every mode it outputs (rgb / depth / median
depth / normals / accumulation) on the viewer's device, served over plain
``http.server`` with a small HTML page (drag to orbit, wheel to zoom), so
it needs no websocket or viewer dependency.  Frames go out as PNG through
the port's own codec (``data/png.py``).

Grad mode is thread-local: the server's handler threads render under
``torch.no_grad`` (:meth:`SplatViewer.render`), so no request builds an
autograd graph over the Gaussians.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..core.cameras import make_camera
from ..data.png import encode_png
from ..data.synthetic import look_at_c2w
from ..models import rade_gs
from ..utils.device import resolve_device
from ..utils.visualization import visualize_splat

_PAGE = """<!DOCTYPE html>
<html><head><title>collab-splats-tpu viewer</title><style>
body { margin:0; background:#111; color:#ddd; font-family:monospace; }
#hud { position:fixed; top:8px; left:8px; }
select { background:#222; color:#ddd; }
</style></head><body>
<div id="hud">mode <select id="mode">
<option>rgb</option><option>depth</option><option>median_depth</option>
<option>normals</option><option>accumulation</option></select>
<span id="stat"></span></div>
<img id="view" draggable="false" style="user-select:none"/>
<script>
let theta = 0.8, phi = 0.5, radius = 3.0, drag = null, inflight = false;
const img = document.getElementById('view');
const stat = document.getElementById('stat');
function refresh() {
  if (inflight) return; inflight = true;
  const mode = document.getElementById('mode').value;
  const t0 = performance.now();
  const u = `/render?theta=${theta}&phi=${phi}&r=${radius}&mode=${mode}`;
  fetch(u).then(r => r.blob()).then(b => {
    img.src = URL.createObjectURL(b);
    stat.textContent = ` ${(performance.now()-t0).toFixed(0)}ms`;
    inflight = false;
  }).catch(() => { inflight = false; });
}
window.addEventListener('mousedown', e => drag = [e.clientX, e.clientY]);
window.addEventListener('mouseup', () => drag = null);
window.addEventListener('mousemove', e => {
  if (!drag) return;
  theta += (e.clientX - drag[0]) * 0.01;
  phi = Math.max(-1.4, Math.min(1.4, phi + (e.clientY - drag[1]) * 0.01));
  drag = [e.clientX, e.clientY];
  refresh();
});
window.addEventListener('wheel', e => {
  radius = Math.max(0.3, radius * (e.deltaY > 0 ? 1.1 : 0.9)); refresh();
});
document.getElementById('mode').addEventListener('change', refresh);
refresh();
</script></body></html>"""


class SplatViewer:
    """Serve an interactive view of a trained splat.

    ``params`` and ``alive`` move to ``device`` (the card by default)."""

    def __init__(
        self,
        params,
        alive,
        model_config: Optional[rade_gs.RadeGSConfig] = None,
        width: int = 640,
        height: int = 480,
        focal: Optional[float] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.params = {k: v.detach().to(self.device)
                       for k, v in params.items()}
        self.alive = alive.to(self.device, torch.bool)
        self.config = model_config or rade_gs.RadeGSConfig(
            sh_degree=0, background="black")
        self.width = width
        self.height = height
        self.focal = focal or 0.9 * max(width, height)
        means = self.params["means"][self.alive].cpu().numpy()
        self.center = means.mean(axis=0)
        self._server: Optional[ThreadingHTTPServer] = None

    def render(self, theta: float, phi: float, radius: float,
               mode: str = "rgb") -> np.ndarray:
        """[H, W, 3] float32 in [0, 1]: the view from ``radius`` at azimuth
        ``theta`` and elevation ``phi`` around the splat's centre."""
        eye = self.center + radius * np.array([
            np.cos(phi) * np.cos(theta),
            np.cos(phi) * np.sin(theta),
            np.sin(phi),
        ])
        cam = make_camera(
            self.focal, self.focal, self.width / 2, self.height / 2,
            self.width, self.height, look_at_c2w(eye, self.center),
            device=self.device,
        )
        with torch.no_grad():
            return visualize_splat(self.params, self.alive, cam, self.config,
                                   mode)

    def png(self, theta: float, phi: float, radius: float,
            mode: str = "rgb") -> bytes:
        """:meth:`render`'s image as PNG bytes (uint8, as served)."""
        img = self.render(theta, phi, radius, mode)
        return encode_png((np.clip(img, 0, 1) * 255).astype(np.uint8))

    def _handler(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, body: bytes, content_type: str):
                self.send_response(200)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/":
                    self._send(_PAGE.encode(), "text/html")
                    return
                if url.path == "/render":
                    q = parse_qs(url.query)
                    self._send(viewer.png(
                        float(q.get("theta", ["0.8"])[0]),
                        float(q.get("phi", ["0.5"])[0]),
                        float(q.get("r", ["3.0"])[0]),
                        q.get("mode", ["rgb"])[0],
                    ), "image/png")
                    return
                if url.path == "/info":
                    self._send(json.dumps({
                        "num_gaussians": int(viewer.alive.sum()),
                        "center": viewer.center.tolist(),
                    }).encode(), "application/json")
                    return
                self.send_response(404)
                self.end_headers()

        return Handler

    def serve(self, port: int = 7007, blocking: bool = True) -> int:
        """Start serving; returns the bound port."""
        self._server = ThreadingHTTPServer(("0.0.0.0", port),
                                           self._handler())
        port = self._server.server_address[1]
        print(f"splat viewer on http://localhost:{port}")
        if blocking:
            self._server.serve_forever()
        else:
            threading.Thread(target=self._server.serve_forever,
                             daemon=True).start()
        return port

    def shutdown(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None

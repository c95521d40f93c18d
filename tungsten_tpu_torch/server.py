"""tungsten_server equivalent (port of tungsten_tpu/server.py): render
with an embedded HTTP status server.

Endpoints (parity with ref src/tungsten-server/tungsten-server.cpp:67-118):
  /status  -> JSON {state, current_spp, next_spp, total_spp, queue, ...}
  /render  -> PNG of the live (tonemapped) framebuffer
  /log     -> plain-text log tail

Usage: python -m tungsten_tpu_torch.server [--port 8080] [--device cpu]
       scene.json ...
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class RenderStatus:
    """What the endpoints report; one per server, shared with the render
    loop under its lock."""

    def __init__(self):
        self.lock = threading.Lock()
        self.state = "idle"
        self.current_spp = 0
        self.next_spp = 0
        self.total_spp = 0
        self.scene = ""
        self.queue = []
        self.framebuffer = None       # numpy HDR
        self.tonemap = "gamma"
        self.log_lines: list[str] = []
        self.start_time = time.time()
        # observability (SURVEY §5.5): per-chip throughput + gradient
        # norm (differentiable sessions); updated per spp round
        self.n_chips = 1
        self.rays_total = 0
        self.mrays_per_s = 0.0
        self.mrays_per_s_per_chip = 0.0
        self.grad_norm = None

    def log(self, msg):
        line = f"[{time.strftime('%H:%M:%S')}] {msg}"
        with self.lock:
            self.log_lines.append(line)
            self.log_lines = self.log_lines[-500:]
        print(line)

    def to_json(self):
        with self.lock:
            return json.dumps({
                "state": self.state,
                "current_spp": self.current_spp,
                "next_spp": self.next_spp,
                "total_spp": self.total_spp,
                "current_scene": self.scene,
                "queued_scenes": list(self.queue),
                "uptime_s": round(time.time() - self.start_time, 1),
                "n_chips": self.n_chips,
                "rays_total": self.rays_total,
                "mrays_per_s": round(self.mrays_per_s, 3),
                "mrays_per_s_per_chip": round(self.mrays_per_s_per_chip,
                                              3),
                "grad_norm": self.grad_norm,
            })

    def record_round(self, rays, seconds):
        """Per-round throughput accounting (per-chip rays/s is the
        north-star metric; chips = the CUDA devices in view)."""
        with self.lock:
            self.rays_total += int(rays)
            if seconds > 0:
                self.mrays_per_s = rays / seconds / 1e6
                self.mrays_per_s_per_chip = \
                    self.mrays_per_s / max(self.n_chips, 1)

    def render_png(self):
        import numpy as np
        from tungsten_tpu_torch.cameras.camera import tonemap_image
        from tungsten_tpu_torch.io.image import encode_png
        with self.lock:
            fb = None if self.framebuffer is None else self.framebuffer.copy()
            tm = self.tonemap
        if fb is None:
            fb = np.zeros((16, 16, 3), np.float32)
        return encode_png(tonemap_image(tm, fb))


class Handler(BaseHTTPRequestHandler):
    """The three endpoints over the server's RenderStatus."""

    def log_message(self, *args):
        pass

    def do_GET(self):
        status = self.server.status
        if self.path.startswith("/status"):
            body = status.to_json().encode()
            ctype = "application/json"
        elif self.path.startswith("/render"):
            body = status.render_png()
            ctype = "image/png"
        elif self.path.startswith("/log"):
            with status.lock:
                body = "\n".join(status.log_lines).encode()
            ctype = "text/plain"
        else:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def serve(port: int, host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """Start the HTTP server on a daemon thread; `httpd.status` is its
    RenderStatus.  Stop it with httpd.shutdown()."""
    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.status = RenderStatus()
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    httpd.status.log(f"HTTP server listening on :{port}")
    return httpd


def render_with_server(scene_paths, port=8080, spp=None, device=None,
                       host: str = "0.0.0.0") -> ThreadingHTTPServer:
    """Serve the status endpoints and render each scene in spp_step
    rounds on `device` (None = CUDA), publishing the framebuffer after
    every round.  Returns the running server (its status says "done")."""
    import numpy as np
    import torch
    from dataclasses import replace
    from tungsten_tpu_torch.device import resolve_device
    from tungsten_tpu_torch.render import render_pass
    from tungsten_tpu_torch.scene.flatten import load_flat_scene

    dev = resolve_device(device)
    httpd = serve(port, host=host)
    st = httpd.status
    st.queue = list(scene_paths)
    for path in scene_paths:
        with st.lock:
            st.queue.remove(path)
            st.scene = path
            st.state = "loading"
        st.log(f"Loading {path}")
        scene, settings = load_flat_scene(path, dev)
        if spp:
            settings = replace(settings, spp=spp)
        with st.lock:
            st.total_spp = settings.spp
            st.current_spp = 0
            st.tonemap = settings.tonemap
            st.state = "rendering"
            st.n_chips = torch.cuda.device_count() \
                if dev.type == "cuda" else 1
        acc = np.zeros((settings.height, settings.width, 3))
        done = 0
        step = max(1, settings.spp_step)
        while done < settings.spp:
            chunk = min(step, settings.spp - done)
            with st.lock:
                st.next_spp = done + chunk
            t0 = time.time()
            out, rays = render_pass(scene, settings, done, settings.seed,
                                    spp_chunk=chunk)
            acc += out.cpu().numpy()
            st.record_round(rays, time.time() - t0)
            done += chunk
            with st.lock:
                st.current_spp = done
                st.framebuffer = acc / done
            st.log(f"Completed {done}/{settings.spp} spp")
        with st.lock:
            st.state = "done"
        st.log(f"Finished {path}")
    return httpd


def main(argv=None):
    p = argparse.ArgumentParser(prog="tungsten_tpu_torch.server")
    p.add_argument("scenes", nargs="+")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch path)")
    args = p.parse_args(argv)
    render_with_server(args.scenes, port=args.port, spp=args.spp,
                       device=args.device)
    # keep serving after render completes
    while True:
        time.sleep(3600)


if __name__ == "__main__":
    main()

"""Serving entry point: a resident HTTP molecule-generation server (PyTorch).

Port of ``bio_diffusion_tpu/cli/serve.py``.  Composes ``configs/serve.yaml``
with the port's config loader (a copy of the JAX package's), builds its model on
``device``, warms the buckets and serves requests (see
``bio_diffusion_torch/serve.py``).

Usage:
  python -m bio_diffusion_torch.cli.serve device=cuda [ckpt_path=<ckpt>] \
      [port=8080] [serving_batch_size=8] [num_timesteps=1000] \
      [warmup_buckets=[20,29]] [precision=bf16|fp32] [k=v ...]

``ckpt_path`` is a reference ``.ckpt``, a checkpoint directory of the port's
Trainer (its EMA weights) or a params file; ``ckpt_path=null`` serves
weights drawn from ``seed``.  ``device`` defaults to ``cuda``; there is no
fallback to the CPU.

Endpoints:
  GET  /healthz   -> server + device status, buckets, stats
  GET  /stats     -> same payload
  POST /generate  -> JSON {"num_samples": N, "num_nodes"?: n,
                           "num_timesteps"?: T, "seed"?: s}
"""

from __future__ import annotations

import json
import logging
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from bio_diffusion_torch.cli.common import (
    device_of,
    load_model,
    nodes_distribution_for,
    parse_cli,
    precision_of,
    with_precision,
)
from bio_diffusion_torch.config.build import build_experiment, get_dataset_info_for
from bio_diffusion_torch.serve import MoleculeServer

log = logging.getLogger(__name__)


def build_server(cfg) -> MoleculeServer:
    """The server of a composed ``serve`` config: the model of ``ckpt_path``
    (see ``cli.common.load_model``) on ``device``, in ``precision``
    (default bf16)."""
    exp = build_experiment(with_precision(cfg, precision_of(cfg, default="bf16")))
    if exp.module_cfg.conditioning:
        raise ValueError("cli.serve serves unconditional models")
    device = device_of(cfg)
    seed = int(cfg.get("seed", 0))
    evd = load_model(exp, cfg.get("ckpt_path"), device, seed=seed)
    num_timesteps = cfg.get("num_timesteps")
    return MoleculeServer(
        evd, get_dataset_info_for(exp), nodes_distribution_for(exp),
        device=device,
        batch_size=int(cfg.get("serving_batch_size", 8)),
        buckets=cfg.get("buckets"),
        num_timesteps=int(num_timesteps) if num_timesteps else None,
        max_wait_ms=float(cfg.get("max_wait_ms", 5.0)),
        max_job_age_s=float(cfg.get("max_job_age_s", 30.0)),
        seed=seed,
        max_request_mols=int(cfg.get("max_request_mols", 10_000)),
    )


def make_handler(server: MoleculeServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            log.debug("http: " + fmt % args)

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/healthz", "/stats", "/"):
                self._send(200, server.describe())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                out = server.generate(
                    int(req.get("num_samples", 1)),
                    num_nodes=req.get("num_nodes"),
                    num_timesteps=req.get("num_timesteps"),
                    seed=req.get("seed"),
                    timeout=float(req.get("timeout_s", 600.0)),
                )
                self._send(200, out)
            except (ValueError, TypeError, KeyError, json.JSONDecodeError) as e:
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
            except TimeoutError as e:
                self._send(503, {"error": f"TimeoutError: {e}"})
            except Exception as e:  # noqa: BLE001 — a server-side fault becomes a 500
                log.exception("generate failed")
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def main(argv=None):
    cfg, flags = parse_cli(list(sys.argv[1:] if argv is None else argv), "serve", __doc__)
    server = build_server(cfg)
    if bool(cfg.get("warmup", True)):
        server.warmup(cfg.get("warmup_buckets"))
    host = str(cfg.get("host", "0.0.0.0"))
    port = int(cfg.get("port", 8080))
    httpd = ThreadingHTTPServer((host, port), make_handler(server))
    log.info("Serving on %s:%s (batch=%d, buckets=%s, device=%s)", host,
             httpd.server_address[1], server.batch_size, server.buckets, server.device)
    if flags.get("background") == "thread":  # returns the running server to the caller
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        return httpd, server
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        server.close()


if __name__ == "__main__":
    main()

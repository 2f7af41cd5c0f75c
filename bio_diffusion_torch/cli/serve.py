"""Serving entry point: a resident HTTP molecule-generation server (PyTorch).

Port of ``bio_diffusion_tpu/cli/serve.py``.  Composes ``configs/serve.yaml``
with the JAX package's jax-free config loader, builds the port's model on
``device``, warms the buckets and serves requests (see
``bio_diffusion_torch/serve.py``).

Usage:
  python -m bio_diffusion_torch.cli.serve device=cuda [ckpt_path=<ckpt>] \
      [port=8080] [serving_batch_size=8] [num_timesteps=1000] \
      [warmup_buckets=[20,29]] [precision=bf16|fp32] [k=v ...]

``ckpt_path=null`` serves weights drawn from ``seed``.  ``device`` defaults
to ``cuda``; there is no fallback to the CPU.

Endpoints:
  GET  /healthz   -> server + device status, buckets, stats
  GET  /stats     -> same payload
  POST /generate  -> JSON {"num_samples": N, "num_nodes"?: n,
                           "num_timesteps"?: T, "seed"?: s}
"""

from __future__ import annotations

import json
import logging
import math
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import torch

from bio_diffusion_tpu.config.build import ExperimentConfig, build_experiment
from bio_diffusion_tpu.config.loader import default_config_dir, load_config
from bio_diffusion_torch.data.dataset_info import get_dataset_info
from bio_diffusion_torch.models.diffusion import EquivariantVariationalDiffusion
from bio_diffusion_torch.models.distributions import NumNodesDistribution
from bio_diffusion_torch.models.gcpnet import GCPNetDynamics
from bio_diffusion_torch.serve import MoleculeServer
from bio_diffusion_torch.train.torch_import import load_reference_checkpoint

log = logging.getLogger(__name__)


def parse_cli(argv: List[str], config_name: str) -> Tuple[Dict[str, Any], Dict[str, str]]:
    """Split args into ``key=value`` config overrides and ``--flags``; compose the config."""
    overrides, flags = [], {}
    for arg in argv:
        if arg.startswith("--"):
            k, _, v = arg[2:].partition("=")
            flags[k] = v
        else:
            overrides.append(arg)
    if "help" in flags:
        print(__doc__.strip())
        raise SystemExit(0)
    return load_config(default_config_dir(), config_name, overrides), flags


def serving_precision(cfg) -> str:
    """An explicit ``trainer.precision`` wins over the top-level ``precision``
    key (default bf16)."""
    trainer = cfg.get("trainer")
    explicit = trainer.get("precision") if isinstance(trainer, dict) else None
    value = explicit if explicit is not None else cfg.get("precision", "bf16")
    return "bf16" if str(value).lower() in ("bf16", "bfloat16") else "fp32"


def init_random_weights(module: torch.nn.Module, seed: int) -> None:
    """Draw every Linear's weight and bias from U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    (PyTorch's default Linear distribution) with a generator seeded by ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features) if m.in_features > 0 else 0.0
                m.weight.copy_(torch.empty(m.weight.shape).uniform_(-bound, bound, generator=gen))
                if m.bias is not None:
                    m.bias.copy_(torch.empty(m.bias.shape).uniform_(-bound, bound, generator=gen))


def build_model(exp: ExperimentConfig, ckpt_path: Optional[str], device, seed: int = 0
                ) -> EquivariantVariationalDiffusion:
    """The port's EVD with the configured denoiser, on ``device``, weights
    from a reference ``.ckpt`` or (``ckpt_path=None``) drawn from ``seed``."""
    if exp.diffusion_cfg.dynamics_network != "gcpnet":
        raise NotImplementedError(f"dynamics network {exp.diffusion_cfg.dynamics_network!r} is not ported yet")
    compute_dtype = "bfloat16" if exp.trainer.precision in ("bf16", "bfloat16") else None
    dynamics = GCPNetDynamics(exp.model_cfg, exp.module_cfg, exp.layer_cfg, exp.diffusion_cfg,
                              exp.dataloader_cfg, compute_dtype=compute_dtype)
    evd = EquivariantVariationalDiffusion(dynamics, exp.diffusion_cfg, exp.dataloader_cfg)
    if ckpt_path is None:
        log.warning("No ckpt_path given: serving weights drawn from seed %d", seed)
        init_random_weights(evd, seed)
    elif str(ckpt_path).endswith((".ckpt", ".pt", ".pth")):
        load_reference_checkpoint(evd, str(ckpt_path))
    else:
        raise ValueError(f"the port loads reference .ckpt files, not {ckpt_path!r}")
    return evd.to(device).eval()


def dataset_info_for(exp: ExperimentConfig) -> Dict[str, Any]:
    dataset = exp.dataloader_cfg.dataset
    if dataset not in ("QM9", "synthetic"):
        raise NotImplementedError(f"dataset {dataset!r} is not ported yet (QM9 only)")
    return get_dataset_info("QM9", exp.dataloader_cfg.remove_h)


def build_server(cfg) -> MoleculeServer:
    if serving_precision(cfg) == "bf16":
        cfg = dict(cfg)
        cfg["trainer"] = {**cfg.get("trainer", {}), "precision": "bf16"}
    exp = build_experiment(cfg)
    if exp.module_cfg.conditioning:
        raise ValueError("cli.serve serves unconditional models")
    device = torch.device(str(cfg.get("device", "cuda")))
    seed = int(cfg.get("seed", 0))
    evd = build_model(exp, cfg.get("ckpt_path"), device, seed)
    info = dataset_info_for(exp)
    num_timesteps = cfg.get("num_timesteps")
    return MoleculeServer(
        evd, info,
        NumNodesDistribution({int(k): int(v) for k, v in info["n_nodes"].items()}),
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
    cfg, flags = parse_cli(list(sys.argv[1:] if argv is None else argv), "serve")
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

"""Serving benchmark: sustained throughput and request latency (PyTorch).

Port of ``scripts/bench_serve.py``: measures the resident server
(``bio_diffusion_torch/serve.py``) end to end -- micro-batching, device
execution, host-side decode -- as a deployment sees it.  It builds the
server with ``cli.serve.build_server`` on ``configs/serve.yaml``, warms
it, then drives ``MoleculeServer.generate`` from client threads.

  python -m bio_diffusion_torch.cli.bench_serve
  SERVE_BATCH=250 SERVE_STEPS=1000 SERVE_NODES=19 SERVE_REQUESTS=8 \\
  SERVE_CONCURRENCY=4 python -m bio_diffusion_torch.cli.bench_serve

The environment knobs and defaults are the JAX script's: ``SERVE_BATCH``
(250), ``SERVE_STEPS`` (1000), ``SERVE_NODES`` (19; ``dist`` draws each
molecule's size from the dataset's size distribution over the server's
full bucket ladder), ``SERVE_REQUESTS`` (8), ``SERVE_CONCURRENCY`` (4),
``SERVE_REQ_MOLS`` (molecules a request, default the batch),
``SERVE_BUCKETS`` (a bucket list such as ``19,29``) and
``SERVE_PRECISION`` (bf16; fp32 is the exact-parity body).
``SERVE_EXPERIMENT`` (unset: ``serve.yaml``'s QM9 model) is passed to the
config as ``experiment=``, e.g. ``geom_mol_gen_ddpm`` serves GEOM-Drugs.
The JAX script's ``SERVE_MESH`` is not read: the server runs on one card
unless ``inference_devices=K`` (or ``all``) is passed as a ``key=value``
override, which splits each batch over K cards (``cli.serve.build_server``).
Extra ``key=value`` arguments are further config overrides, applied last:
the device is ``cuda`` unless one of them is ``device=cpu``; there is no
fallback to the CPU.

Prints one JSON line with the JAX script's keys -- ``value`` (molecules
per second), ``denoiser_evals_per_s``, ``latency_s`` (p50, p95, max),
``unit``, ``vs_baseline`` (against the reference README's 833 denoiser
evaluations per second on one GPU) and the server's ``stats`` -- plus
``card``, the card's name and power limit as ``nvidia-smi`` prints them
(null without a card).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from bio_diffusion_torch.cli.serve import build_server
from bio_diffusion_torch.config.loader import default_config_dir, load_config

BASELINE_EVALS_PER_S = 833.0  # reference README: one GPU, 250 molecules x 1000 steps in ~5 min


def card_line() -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the first card, or None."""
    if shutil.which("nvidia-smi") is None:
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def serve_overrides(env: Dict[str, str]) -> List[str]:
    """The ``serve`` config overrides that the ``SERVE_*`` knobs ask for."""
    batch = int(env.get("SERVE_BATCH", 250))
    nodes = env.get("SERVE_NODES", "19")
    if env.get("SERVE_BUCKETS"):
        buckets = f"buckets=[{env['SERVE_BUCKETS']}]"
    else:
        buckets = "buckets=null" if nodes == "dist" else f"buckets=[{int(nodes)}]"
    # the experiment's own dataset names its statistics (serving reads no
    # data files); serve.yaml's QM9 model runs on the synthetic stand-in, as
    # in the JAX script
    if env.get("SERVE_EXPERIMENT"):
        out = [f"experiment={env['SERVE_EXPERIMENT']}"]
    else:
        out = ["datamodule.dataloader_cfg.dataset=synthetic"]
    return out + [
        f"serving_batch_size={batch}",
        buckets,
        f"num_timesteps={int(env.get('SERVE_STEPS', 1000))}",
        f"precision={env.get('SERVE_PRECISION', 'bf16')}",
        "device=cuda",
    ]


def main(argv=None, env=None) -> Dict[str, Any]:
    env = dict(os.environ if env is None else env)
    argv = list(sys.argv[1:] if argv is None else argv)
    batch = int(env.get("SERVE_BATCH", 250))
    steps = int(env.get("SERVE_STEPS", 1000))
    nodes_env = env.get("SERVE_NODES", "19")
    nodes = None if nodes_env == "dist" else int(nodes_env)
    n_requests = int(env.get("SERVE_REQUESTS", 8))
    concurrency = int(env.get("SERVE_CONCURRENCY", 4))
    if n_requests < concurrency:
        raise SystemExit(f"SERVE_REQUESTS ({n_requests}) must be >= SERVE_CONCURRENCY ({concurrency})")
    mols_per_request = int(env.get("SERVE_REQ_MOLS", batch))

    server = build_server(load_config(default_config_dir(), "serve", serve_overrides(env) + argv))
    try:
        t0 = time.time()
        server.warmup()
        print(f"# warmup {time.time() - t0:.1f}s device={server.describe()['device']}", file=sys.stderr)

        latencies: List[float] = []
        errors: List[BaseException] = []
        lock = threading.Lock()

        def client():
            try:
                for _ in range(n_requests // concurrency):
                    t = time.time()
                    # nodes=None: each molecule's size drawn from the dataset's distribution
                    out = server.generate(mols_per_request, num_nodes=nodes, timeout=3600)
                    if out["num_molecules"] != mols_per_request:
                        raise AssertionError(f"asked for {mols_per_request} molecules, got {out['num_molecules']}")
                    with lock:
                        latencies.append(time.time() - t)
            except BaseException as e:  # noqa: BLE001 — raised on the main thread below
                with lock:
                    errors.append(e)

        t0 = time.time()
        threads = [threading.Thread(target=client) for _ in range(concurrency)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.time() - t0
        if errors:
            raise errors[0]
        stats = server.describe()["stats"]
    finally:
        server.close()

    total_mols = (n_requests // concurrency) * concurrency * mols_per_request
    lat = sorted(latencies)
    result = {
        "metric": "serving_molecules_per_s",
        "value": round(total_mols / wall, 3),
        "denoiser_evals_per_s": round(total_mols * steps / wall, 1),
        "latency_s": {
            "p50": round(lat[len(lat) // 2], 3),
            "p95": round(lat[min(len(lat) - 1, int(0.95 * len(lat)))], 3),
            "max": round(lat[-1], 3),
        },
        "unit": f"molecules/s ({total_mols} mols x {steps} steps, "
                f"{'dist-sampled sizes' if nodes is None else f'{nodes} atoms'}, "
                f"{concurrency} concurrent clients, batch {batch})",
        "vs_baseline": round(total_mols * steps / wall / BASELINE_EVALS_PER_S, 3),
        "stats": stats,
        "card": card_line(),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

"""The port's serving path on the CPU at a tiny width, and its import boundary.

* ``bio_diffusion_torch.cli.serve.build_server`` on ``configs/serve.yaml``
  (tiny overrides, ``device=cpu``) answers requests; a seeded request
  repeats exactly; the HTTP front end round-trips.
* Bucketed sampling runs through the port's sampler, and the port's numpy
  copies (size distribution, stability analysis) match the JAX package's.
* Importing the port (serving modules included) loads neither jax nor flax.
"""

import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

from test_torch_common import TINY_OVERRIDES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE = TINY_OVERRIDES + ["serving_batch_size=2", "buckets=[6]", "device=cpu", "precision=fp32",
                          "max_wait_ms=50"]


@pytest.fixture(scope="module")
def server():
    from bio_diffusion_tpu.config.loader import default_config_dir, load_config
    from bio_diffusion_torch.cli.serve import build_server

    srv = build_server(load_config(default_config_dir(), "serve", SERVE))
    yield srv
    srv.close()


def test_generate_answers_requests(server):
    assert server.warmup() == [6]
    out = server.generate(3, num_nodes=6)
    assert out["num_molecules"] == 3
    for mol in out["molecules"]:
        pos = np.asarray(mol["positions"])
        assert mol["size"] == 6 and len(mol["atoms"]) == 6 and pos.shape == (6, 3)
        assert np.isfinite(pos).all()
        assert np.abs(pos.mean(0)).max() <= 1e-3 * max(1.0, np.abs(pos).max())
        assert all(isinstance(c, int) for c in mol["charges"])
    out2 = server.generate(2)  # sizes from the QM9 histogram, clipped to the bucket
    assert out2["num_molecules"] == 2
    assert server.stats["batches"] >= 3  # 3 jobs at batch 2, then 2 more
    desc = server.describe()
    assert desc["device"] == "cpu" and desc["batch_size"] == 2 and desc["buckets"] == [6]


def test_seeded_request_repeats_exactly(server):
    a = server.generate(3, seed=11, num_timesteps=4)
    b = server.generate(3, seed=11, num_timesteps=4)
    c = server.generate(3, seed=12, num_timesteps=4)
    assert a["molecules"] == b["molecules"]
    assert a["molecules"] != c["molecules"]


def test_request_validation(server):
    with pytest.raises(ValueError):
        server.generate(0)
    with pytest.raises(ValueError):
        server.generate(1, num_nodes=7)  # above the largest bucket


def test_sample_molecules_and_analysis_match_jax(server):
    """Bucketed batch sampling through the port's sampler, and the port's
    numpy copies (size distribution, stability/KL analysis) against the JAX
    package's on the same inputs."""
    import torch

    from bio_diffusion_tpu.models.distributions import NumNodesDistribution as JaxNodes
    from bio_diffusion_tpu.train.sampling import analyze_samples as jax_analyze
    from bio_diffusion_torch.models.distributions import NumNodesDistribution
    from bio_diffusion_torch.train.sampling import analyze_samples, sample_molecules

    hist = {int(k): int(v) for k, v in server.dataset_info["n_nodes"].items()}
    ours, ref = NumNodesDistribution(hist), JaxNodes(hist)
    np.testing.assert_array_equal(ours.sample(50, np.random.default_rng(3)),
                                  ref.sample(50, np.random.default_rng(3)))
    small = NumNodesDistribution({3: 1, 4: 2, 6: 1})
    xh, mask, sizes = sample_molecules(server.sampler, torch.Generator().manual_seed(0), 5, small,
                                       np.random.default_rng(1), batch_size=2, num_timesteps=3)
    assert xh.shape[0] == 5 and mask.shape == xh.shape[:2] and list(sizes) == sorted(sizes, reverse=True)
    assert np.array_equal(mask.sum(1), sizes) and np.all(xh[mask == 0] == 0)
    assert analyze_samples(xh, mask, server.dataset_info) == {
        k: v for k, v in jax_analyze(xh, mask, server.dataset_info).items()
        if k in ("mol_stable", "atm_stable", "kl_div_atom_types")
    }


def test_http_roundtrip():
    from bio_diffusion_torch.cli.serve import main

    httpd, srv = main(SERVE + ["warmup=false", "port=0", "host=127.0.0.1", "--background=thread"])
    try:
        port = httpd.server_address[1]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as r:
            assert json.loads(r.read())["status"] == "ok"
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps({"num_samples": 2, "num_nodes": 5, "seed": 1, "num_timesteps": 3}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            out = json.loads(r.read())
        assert out["num_molecules"] == 2 and len(out["molecules"][0]["atoms"]) == 5
    finally:
        httpd.shutdown()
        srv.close()


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import bio_diffusion_torch, bio_diffusion_torch.serve, bio_diffusion_torch.cli.serve\n"
        "import bio_diffusion_torch.ops.build, bio_diffusion_torch.ops.message_layer\n"
        "import bio_diffusion_torch.models.gcpnet, bio_diffusion_torch.models.diffusion\n"
        "import bio_diffusion_torch.train.sampling, bio_diffusion_torch.train.torch_import\n"
        "import bio_diffusion_torch.data.dataset_info, bio_diffusion_torch.ops.schedules\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

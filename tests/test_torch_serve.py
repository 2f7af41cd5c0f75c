"""The port's serving path on the CPU at a tiny width, and its import boundary.

* ``bio_diffusion_torch.cli.serve.build_server`` on ``configs/serve.yaml``
  (tiny overrides, ``device=cpu``) answers requests; a seeded request
  repeats exactly; the HTTP front end round-trips.
* Bucketed sampling runs through the port's sampler, and the port's numpy
  copies (size distribution, stability analysis) match the JAX package's.
* GEOM-Drugs serving: ``build_server`` with ``experiment=geom_mol_gen_ddpm``
  (the override the JAX package's ``build_server`` takes) holds the GEOM
  dataset info, size distribution and bucket ladder up to 181 that the JAX
  server holds, serves molecules without charges, and its size draws and
  stability analysis equal the JAX package's.
* ``cli.bench_serve`` at the tiny width prints the JAX script's keys, for
  QM9 and with ``SERVE_EXPERIMENT=geom_mol_gen_ddpm``.
* Importing the port (serving modules and `chip_smoke.py` included) loads
  neither jax, flax or optax nor anything of the JAX package.
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
    from bio_diffusion_torch.config.loader import default_config_dir, load_config
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
    # the third job waited at least for the first batch's run
    assert desc["stats"]["queue_wait_s"] >= desc["stats"]["max_queue_wait_s"] > 0


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


GEOM_TINY = ["experiment=geom_mol_gen_ddpm", "model.model_cfg.h_hidden_dim=16", "model.model_cfg.chi_hidden_dim=8",
             "model.model_cfg.e_hidden_dim=4", "model.model_cfg.xi_hidden_dim=2",
             "model.model_cfg.num_encoder_layers=1", "model.diffusion_cfg.num_timesteps=4", "precision=fp32",
             "serving_batch_size=2", "max_wait_ms=50"]


def test_geom_serving_matches_jax(monkeypatch):
    import jax
    import torch

    from bio_diffusion_tpu.cli import common as jax_common
    from bio_diffusion_tpu.cli.serve import build_server as jax_build_server
    from bio_diffusion_tpu.config.loader import load_config as jax_load_config
    from bio_diffusion_tpu.train.sampling import analyze_samples as jax_analyze
    from bio_diffusion_torch.cli.serve import build_server
    from bio_diffusion_torch.config.loader import default_config_dir, load_config
    from bio_diffusion_torch.train.sampling import analyze_samples, sample_molecules

    # the JAX server's config decisions, with a zeros template for its weights
    # (its eager init is not what is compared)
    init = jax_common.init_params
    monkeypatch.setattr(jax_common, "init_params", lambda exp, evd: jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype), jax.eval_shape(lambda: init(exp, evd))))
    theirs = jax_build_server(jax_load_config(default_config_dir(), "serve", GEOM_TINY + ["use_mesh=false"]))
    ours = build_server(load_config(default_config_dir(), "serve", GEOM_TINY + ["device=cpu"]))
    try:
        assert ours.buckets == theirs.buckets and ours.buckets[-1] == 181 and len(ours.buckets) == 91
        assert not ours.include_charges and not theirs.include_charges
        for key in ("atom_decoder", "n_nodes", "max_n_nodes"):
            assert ours.dataset_info[key] == theirs.dataset_info[key]
        assert len(ours.dataset_info["atom_decoder"]) == 16
        np.testing.assert_array_equal(ours.nodes_dist.sample(64, np.random.default_rng(5)),
                                      theirs.nodes_dist.sample(64, np.random.default_rng(5)))
        out = ours.generate(3, num_nodes=6)
        decoder = set(ours.dataset_info["atom_decoder"])
        for mol in out["molecules"]:
            assert "charges" not in mol and set(mol["atoms"]) <= decoder and mol["size"] == 6
            assert np.isfinite(np.asarray(mol["positions"])).all()
        small = type(ours.nodes_dist)({5: 1, 7: 2, 9: 1})
        xh, mask, _ = sample_molecules(ours.sampler, torch.Generator().manual_seed(0), 4, small,
                                       np.random.default_rng(1), batch_size=2, num_timesteps=2)
        assert xh.shape[-1] == 3 + 16 and np.all(xh[mask == 0] == 0)
        assert analyze_samples(xh, mask, ours.dataset_info, include_charges=False) == {
            k: v for k, v in jax_analyze(xh, mask, theirs.dataset_info, include_charges=False).items()
            if k in ("mol_stable", "atm_stable", "kl_div_atom_types")}
    finally:
        ours.close()
        theirs.close()


@pytest.mark.parametrize("experiment", [None, "geom_mol_gen_ddpm"])
def test_bench_serve_prints_the_jax_keys(experiment, capsys):
    from bio_diffusion_torch.cli import bench_serve

    env = {"SERVE_BATCH": "2", "SERVE_STEPS": "2", "SERVE_REQUESTS": "4",
           "SERVE_CONCURRENCY": "2", "SERVE_PRECISION": "fp32", "SERVE_REQ_MOLS": "3"}
    argv = [o for o in TINY_OVERRIDES if "dataset=" not in o] + ["device=cpu"]
    if experiment:
        env.update(SERVE_EXPERIMENT=experiment, SERVE_NODES="dist", SERVE_BUCKETS="8,12,16")
        argv = GEOM_TINY[1:5] + ["device=cpu"]
    result = bench_serve.main(argv, env=env)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(result))
    assert {"metric", "value", "denoiser_evals_per_s", "latency_s", "unit", "vs_baseline", "stats"} <= set(result)
    assert set(result["latency_s"]) == {"p50", "p95", "max"} and result["value"] > 0
    assert result["stats"]["molecules"] == 12 and result["stats"]["requests"] == 4
    assert result["card"] is None  # no card here
    assert result["unit"] == ("molecules/s (12 mols x 2 steps, "
                              + ("dist-sampled sizes" if experiment else "19 atoms")
                              + ", 2 concurrent clients, batch 2)")
    if experiment:
        assert set(result["stats"]["bucket_batches"]) <= {8, 12, 16}


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
        "import bio_diffusion_torch.config.build, bio_diffusion_torch.config.loader\n"
        "import bio_diffusion_torch.chem.stability, bio_diffusion_torch.ops.gcp2_chain\n"
        "import bio_diffusion_torch.ops.passes, bio_diffusion_torch.cli.bench_passes\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'bio_diffusion_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

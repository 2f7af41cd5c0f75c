"""Port parity: RePaint inpainting, pocket-conditional generation, the
inpainting and pocket modes of ``mol_gen_sample`` and the pocket
experiment's training, against the JAX package.

Random streams differ between the frameworks, so the JAX draws are rebuilt
from its key splits (``inpaint``: ``key, k_init = split(key)``, per step
``key, k_known, k_unknown, k_sc, k_jump = split(key, 5)``, then ``key,
k_final = split(key)``; each key's ``sample_noise`` draws) and handed to
the port.  Two tiny models: the QM9 one of ``test_torch_common`` (S=16, 2
layers, T=10, charges) and the ``pocket_mol_gen_ddpm`` experiment cut to
the JAX pocket tests' sizes (S=16, V=4, Se=8, Ve=2, 1 layer, T=8; 30 atom
types, no charges), its weights drawn by the port and carried into JAX by
the JAX package's reference-name import.  Float32, CPU (the port's plain
message layer; JAX's pure-jnp path).

* The RePaint schedule and its step arrays: exactly equal over a grid of
  (resamplings, jump length, T).
* ``sample_p_zt_given_zs``: within 1e-5; ``inpaint`` and
  ``generate_ligands_in_pocket`` (displaced pockets): positions within
  1e-4, or 1e-5 of max|JAX| where the untrained chain scales positions
  up; atom types, pocket rows and masks identical.
* The CLI modes on the CPU: xyz files, metric keys equal to the JAX CLI's;
  in the pocket mode ``pockets.json`` and the ligand sizes equal to the JAX
  CLI's for the same seed (synthetic, JSON and PDB pockets).
* Two steps of ``cli.train experiment=pocket_mol_gen_ddpm``: the collated
  batches equal to the JAX Trainer's for the same seed, in the config's
  buckets.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_diffusion_tpu.config.build import build_datasets as jax_build_datasets
from bio_diffusion_tpu.config.build import build_experiment as jax_build_experiment
from bio_diffusion_tpu.config.loader import load_config as jax_load_config
from bio_diffusion_tpu.models.diffusion import EquivariantVariationalDiffusion as JaxEVD
from bio_diffusion_tpu.ops.geometry import centralize as jax_centralize
from bio_diffusion_tpu.train.loop import Trainer as JaxTrainer
from bio_diffusion_tpu.train.sampling import generate_ligands_in_pocket as jax_generate_ligands_in_pocket
from bio_diffusion_tpu.train.torch_import import import_state_dict
from bio_diffusion_torch.config.build import build_evd, build_experiment
from bio_diffusion_torch.config.loader import default_config_dir, load_config
from bio_diffusion_torch.data.pocket import get_pocket_dataset_info, synthetic_pockets
from bio_diffusion_torch.models.diffusion import EquivariantVariationalDiffusion
from bio_diffusion_torch.train.sampling import generate_ligands_in_pocket
from bio_diffusion_torch.train.torch_import import init_random_weights
from test_pocket_generation import _write_fixture_pdb
from test_torch_common import TINY_OVERRIDES, build_jax_and_port

ATOL = 1e-4
TOL_REL = 1e-5  # of max|JAX| where the untrained chain scales positions up
POCKET_TINY = [
    "experiment=pocket_mol_gen_ddpm",
    "datamodule.dataloader_cfg.batch_size=8",
    "datamodule.dataloader_cfg.num_train=24",
    "datamodule.dataloader_cfg.num_valid=8",
    "datamodule.dataloader_cfg.num_test=8",
    "model.model_cfg.h_hidden_dim=16",
    "model.model_cfg.chi_hidden_dim=4",
    "model.model_cfg.e_hidden_dim=8",
    "model.model_cfg.xi_hidden_dim=2",
    "model.model_cfg.num_encoder_layers=1",
    "model.diffusion_cfg.num_timesteps=8",
    "model.diffusion_cfg.sample_during_training=false",
]
JAX_ONLY = ["trainer.use_mesh=false", "use_mesh=false", "extras.print_config=false"]
KL = 10  # ligand atom types of bindingmoad


def assert_positions_close(ours, ref, what):
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(ours, ref, rtol=0, atol=max(ATOL, TOL_REL * scale), err_msg=what)


def raw_noise(key, b, n, f):
    """The standard-normal draws ``EVD.sample_noise(key, ...)`` makes."""
    kx, kh = jax.random.split(key)
    zx = jax.random.normal(kx, (b, n, 3))
    zh = jax.random.normal(kh, (b, n, f))
    return torch.from_numpy(np.concatenate([np.asarray(zx), np.asarray(zh)], -1))


def inpaint_draws(key, steps, b, n, f):
    """JAX ``inpaint``'s draws from ``key`` in the port's order: prior,
    (known, reverse, self-conditioning, jump) a step, decode."""
    key, k_init = jax.random.split(key)
    noises = [raw_noise(k_init, b, n, f)]
    for _ in range(steps):
        key, k_known, k_unknown, k_sc, k_jump = jax.random.split(key, 5)
        noises += [raw_noise(k, b, n, f) for k in (k_known, k_unknown, k_sc, k_jump)]
    key, k_final = jax.random.split(key)
    return noises + [raw_noise(k_final, b, n, f)]


@pytest.mark.parametrize("r,j,T", [(1, 1, 1000), (2, 10, 100), (3, 1, 50), (2, 2, 8), (1, 3, 10), (4, 5, 23),
                                   (2, 8, 8), (3, 9, 8)])
def test_repaint_schedule_matches_jax(r, j, T):
    ours = EquivariantVariationalDiffusion.get_repaint_schedule(r, j, T)
    ref = JaxEVD.get_repaint_schedule(r, j, T)
    assert ours == ref
    s, flags = EquivariantVariationalDiffusion.repaint_step_arrays(ours, j)
    rs, rflags = JaxEVD.repaint_step_arrays(ref, j)
    assert s.dtype == rs.dtype and flags.dtype == rflags.dtype
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(flags, rflags)
    # every step ends at s = 0; r resamplings of each jump
    assert s[-1] == 0 and not flags[-1]
    if (r, j, T) == (2, 10, 100):
        assert (len(s), int(flags.sum())) == (190, 9)
    if (r, j, T) == (1, 1, 1000):
        assert (len(s), int(flags.sum())) == (1000, 0)


@pytest.fixture(scope="module")
def qm9_models():
    return build_jax_and_port(seed=3)


def qm9_inputs(b=3, n=7):
    """Node masks with padded rows and the first two nodes of each molecule
    fixed at seeded positions; one-hot types and integer charges on every
    node."""
    rng = np.random.default_rng(12)
    mask = (np.arange(n)[None] < np.array([n, n - 2, 4])[:b, None]).astype(np.float32)
    fixed = np.zeros_like(mask)
    fixed[:, :2] = 1.0
    x0 = rng.normal(size=(b, n, 3)).astype(np.float32) * mask[..., None]
    h0c = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (b, n))] * mask[..., None]
    h0i = rng.integers(1, 9, (b, n, 1)).astype(np.float32) * mask[..., None]
    return x0, h0c, h0i, mask, fixed


def test_sample_p_zt_given_zs_matches_jax(qm9_models):
    *_, jax_evd, params, evd = qm9_models
    x0, h0c, h0i, mask, _ = qm9_inputs()
    b, n = mask.shape
    zs = np.concatenate([x0, h0c, h0i], -1)
    g_s, g_t = np.array([[-4.0], [-1.0], [2.0]], np.float32), np.array([[-2.5], [0.5], [4.0]], np.float32)
    key = jax.random.PRNGKey(4)
    ref = jax_evd.apply(params, *(jnp.asarray(a) for a in (zs, mask, g_t, g_s)), key,
                        method=JaxEVD.sample_p_zt_given_zs)
    ours = evd.sample_p_zt_given_zs(*(torch.from_numpy(a) for a in (zs, mask, g_t, g_s)),
                                    noise=raw_noise(key, b, n, 6))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    _, com = jax_centralize(jnp.asarray(ours.numpy()[..., :3]), jnp.asarray(mask))
    np.testing.assert_allclose(np.asarray(com), ours.numpy()[..., :3], atol=1e-6)


@pytest.mark.parametrize("r,j,T", [(2, 2, None), (1, 1, 6)])
def test_inpaint_matches_jax(qm9_models, r, j, T):
    *_, jax_evd, params, evd = qm9_models
    x0, h0c, h0i, mask, fixed = qm9_inputs()
    b, n = mask.shape
    key = jax.random.PRNGKey(21)
    run = jax.jit(lambda p, k, *a: jax_evd.apply(p, k, *a, r, j, T, method=JaxEVD.inpaint))
    ref = np.asarray(run(params, key, *(jnp.asarray(a) for a in (x0, h0c, h0i, mask, fixed))))
    steps = len(JaxEVD.repaint_step_arrays(JaxEVD.get_repaint_schedule(r, j, T or evd.T), j)[0])
    noises = inpaint_draws(key, steps, b, n, 6)
    with torch.inference_mode():
        ours = evd.inpaint(*(torch.from_numpy(a) for a in (x0, h0c, h0i, mask, fixed)), r, j, T,
                           noises=noises).numpy()
        with pytest.raises(ValueError, match="noises"):
            evd.inpaint(*(torch.from_numpy(a) for a in (x0, h0c, h0i, mask, fixed)), r, j, T, noises=noises[:-1])
    assert ours.shape == ref.shape == (b, n, 3 + 5 + 1)
    assert_positions_close(ours[..., :3], ref[..., :3], "positions")
    np.testing.assert_array_equal(ours[..., 3:], ref[..., 3:])  # one-hot and charges
    assert np.all(ours[mask == 0] == 0)
    np.testing.assert_array_equal(ours[..., 3:8].sum(-1), mask)
    # the fixed part keeps its geometry (the generated part's positions are
    # the untrained chain's, hundreds of A)
    np.testing.assert_allclose(np.linalg.norm(ours[:, 0, :3] - ours[:, 1, :3], axis=-1),
                               np.linalg.norm(x0[:, 0] - x0[:, 1], axis=-1), atol=0.05)


def pocket_experiments(extra=()):
    exp = build_experiment(load_config(default_config_dir(), "train", POCKET_TINY + list(extra)))
    jexp = jax_build_experiment(jax_load_config(default_config_dir(), "train", POCKET_TINY + list(extra)))
    return exp, jexp


@pytest.fixture(scope="module")
def pocket_models():
    """The tiny pocket experiment in both packages with the same weights."""
    from bio_diffusion_tpu.config.build import build_evd as jax_build_evd

    exp, jexp = pocket_experiments()
    evd_j = jax_build_evd(jexp, remat=False)
    key = jax.random.PRNGKey(0)
    x0 = jnp.zeros((2, 6, 3))
    shapes = jax.eval_shape(lambda: evd_j.init(key, x0, jnp.zeros((2, 6, 30)), jnp.zeros((2, 6, 0)),
                                               jnp.ones((2, 6)), key, training=False))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    evd = build_evd(exp)
    init_random_weights(evd, 8)
    sd = {"ddpm." + k: v.numpy() for k, v in evd.state_dict().items()}
    params = jax.tree.map(jnp.asarray, import_state_dict(sd, template))
    return exp, evd_j, params, evd.eval()


def test_pocket_experiment_composes_as_in_jax(pocket_models):
    exp, evd_j, _, evd = pocket_models
    _, jexp = pocket_experiments()
    dl = exp.dataloader_cfg
    assert (dl.dataset, dl.num_atom_types, dl.include_charges, tuple(dl.bucket_sizes)) == \
        ("bindingmoad", 30, False, (48, 64, 96, 128, 144))
    assert evd.num_node_scalar_features == 30 and evd.T == 8
    assert tuple(exp.diffusion_cfg.norm_values) == tuple(jexp.diffusion_cfg.norm_values) == (1.0, 4.0, 10.0)


@pytest.mark.parametrize("r,j", [(2, 2), (1, 1)])
def test_generate_ligands_in_pocket_matches_jax(pocket_models, r, j):
    _, evd_j, params, evd = pocket_models
    pocket_x, pocket_aa, pocket_mask = synthetic_pockets("bindingmoad", np.array([6, 8]), np.random.default_rng(0))
    # displaced pockets: the result must come back in the input frame
    pocket_x = (pocket_x + np.array([[[5.0, -3.0, 2.0]], [[-4.0, 6.0, 1.0]]], np.float32)) * pocket_mask[..., None]
    ligand_sizes = np.array([4, 5])
    kw = dict(pocket_x=pocket_x, pocket_types=pocket_aa, pocket_mask=pocket_mask, ligand_sizes=ligand_sizes,
              num_ligand_atom_types=KL, num_resamplings=r, jump_length=j)
    key = jax.random.PRNGKey(7)
    ref = jax_generate_ligands_in_pocket(evd_j, params, key, **kw)
    steps = len(JaxEVD.repaint_step_arrays(JaxEVD.get_repaint_schedule(r, j, evd.T), j)[0])
    ours = generate_ligands_in_pocket(evd, None, noises=inpaint_draws(key, steps, 2, 5 + 8, 30), **kw)
    assert set(ours) == set(ref)
    for f in ("ligand_one_hot", "ligand_mask", "node_mask", "fixed_mask"):
        np.testing.assert_array_equal(ours[f], np.asarray(ref[f]), err_msg=f)
    assert_positions_close(ours["ligand_x"], np.asarray(ref["ligand_x"]), "ligand_x")
    joint, joint_ref = ours["joint_xh"], np.asarray(ref["joint_xh"])
    assert_positions_close(joint[..., :3], joint_ref[..., :3], "joint positions")
    np.testing.assert_array_equal(joint[..., 3:], joint_ref[..., 3:])
    # the pocket rows are the input, bit-exact; one ligand type a real atom
    np.testing.assert_array_equal(joint[:, 5:, :3], pocket_x)
    np.testing.assert_array_equal(joint[:, 5:, 3 + KL:], np.eye(20, dtype=np.float32)[pocket_aa]
                                  * pocket_mask[..., None])
    np.testing.assert_array_equal(ours["ligand_one_hot"].sum(-1), ours["ligand_mask"])


def newest_run(out_dir):
    runs = sorted(os.listdir(out_dir))
    assert len(runs) == 1
    return os.path.join(out_dir, runs[0])


def xyz_sizes(run):
    return [int(open(os.path.join(run, f)).readline()) for f in sorted(os.listdir(run)) if f.endswith(".xyz")]


def run_both(tmp_path, args):
    """The sample CLI of both packages on ``args`` -> (metrics, run dir) each."""
    from bio_diffusion_tpu.cli.mol_gen_sample import main as jax_main
    from bio_diffusion_torch.cli.mol_gen_sample import main

    out = []
    for tag, fn, extra in (("port", main, ["device=cpu"]), ("jax", jax_main, JAX_ONLY)):
        out_dir = str(tmp_path / tag)
        out.append((fn(args + extra + [f"output_dir={out_dir}"]), newest_run(out_dir)))
    return out


@pytest.mark.parametrize("source", ["synthetic", "json", "pdb"])
def test_pocket_cli_matches_jax(tmp_path, source):
    args = POCKET_TINY + ["ddpm_mode=pocket", "num_samples=3", "num_timesteps=4", "num_resamplings=2",
                          "jump_length=2"]
    if source == "json":
        rng = np.random.default_rng(1)
        spec = {"coords": (rng.normal(size=(7, 3)) * 4.0 + [10.0, 0.0, -5.0]).tolist(),
                "residues": ["A", "C", "D", "G", "L", "S", "W"]}
        path = str(tmp_path / "pocket.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        args += [f"pocket_file={path}", "num_nodes=4"]
    elif source == "pdb":
        path = str(tmp_path / "site.pdb")
        _write_fixture_pdb(path, np.random.default_rng(0))
        args += [f"pocket_file={path}", "pocket_ligand=LIG"]
    else:
        args += ["pocket_size=9"]
    (metrics, run), (jax_metrics, jax_run) = run_both(tmp_path, args)
    assert set(metrics) == set(jax_metrics) >= {"mol_stable", "atm_stable", "lig_nn_dist", "lig_center_rms"}
    assert all(np.isfinite(v) for v in metrics.values())
    with open(os.path.join(run, "pockets.json")) as f, open(os.path.join(jax_run, "pockets.json")) as g:
        assert json.load(f) == json.load(g)
    sizes = xyz_sizes(run)
    assert len(sizes) == 3 and sizes == xyz_sizes(jax_run)
    elements = set(get_pocket_dataset_info("bindingmoad")["atom_decoder"])
    for name in sorted(os.listdir(run)):
        if name.endswith(".xyz"):
            lines = open(os.path.join(run, name)).read().strip().splitlines()
            assert all(ln.split()[0] in elements for ln in lines[2:])


def test_inpainting_cli_matches_jax(tmp_path):
    args = TINY_OVERRIDES + ["ddpm_mode=inpainting", "num_samples=3", "num_timesteps=4", "num_resamplings=2",
                             "jump_length=2"]
    (metrics, run), (jax_metrics, jax_run) = run_both(tmp_path, args)
    assert set(metrics) == set(jax_metrics)
    sizes = xyz_sizes(run)
    assert len(sizes) == 3 and sizes == xyz_sizes(jax_run)


def test_inpaint_first_node_draws_from_a_generator(qm9_models):
    """The inpainting mode's batch (first node fixed at the origin) with
    draws from a ``torch.Generator``: finite, CoM-free, one type a real
    atom, padded rows 0, and the same generator seed gives the same batch."""
    from bio_diffusion_torch.cli.mol_gen_sample import inpaint_first_node

    *_, evd = qm9_models
    sizes = np.array([7, 5, 6])
    cfg = {"num_resamplings": 2, "jump_length": 2}
    xh, mask = inpaint_first_node(evd, cfg, sizes, 5, None, torch.Generator().manual_seed(0))
    again, _ = inpaint_first_node(evd, cfg, sizes, 5, None, torch.Generator().manual_seed(0))
    assert xh.shape == (3, 7, 9) and np.isfinite(xh).all()
    np.testing.assert_array_equal(xh, again)
    np.testing.assert_array_equal(xh[..., 3:8].sum(-1), mask)
    assert np.all(xh[mask == 0] == 0)
    np.testing.assert_allclose(xh[..., :3].sum(1), 0.0, atol=1e-3)


def test_pocket_training_batches_match_jax(tmp_path, monkeypatch):
    """Two Trainer steps of the pocket experiment on the CPU: the batches it
    trains on equal the JAX Trainer's for the same seed and datasets, each
    padded to its bucket."""
    from bio_diffusion_torch.cli.train import main
    from bio_diffusion_torch.train import loop

    seen = []
    make = loop.make_train_step

    def recording(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(state, batch, generator):
            seen.append(batch)
            return step(state, batch, generator)
        return run

    monkeypatch.setattr(loop, "make_train_step", recording)
    trainer = main(POCKET_TINY + ["--device=cpu", "--max-steps=2", f"--workdir={tmp_path}"])
    assert trainer.stats["steps"] == 2 and len(seen) == 2
    _, jexp = pocket_experiments()
    dl = jexp.dataloader_cfg
    stub = types.SimpleNamespace(
        exp=types.SimpleNamespace(dataloader_cfg=dl), datasets=jax_build_datasets(jexp),
        rng=np.random.default_rng(jexp.seed), conditioning=(), props_norms=None)
    ref = [b for _, b in zip(range(2), JaxTrainer._batch_iter(stub, "train"))]
    for ours, b in zip(seen, ref):
        for f in ("x", "one_hot", "charges", "node_mask"):
            np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(b, f)), err_msg=f)
        n, largest = ours.node_mask.shape[1], int(ours.node_mask.sum(1).max())
        assert n == min(k for k in dl.bucket_sizes if k >= largest)
    losses = [r["train/loss"] for r in trainer.loggers.loggers[0].rows if "train/loss" in r]
    assert losses and np.isfinite(losses).all()


def test_bench_pocket_quality_tiny_on_the_cpu(tmp_path, monkeypatch):
    """The pocket-quality benchmark's tiny preset end to end on the CPU:
    the JSON line's rows and columns, the steps it trained, and the data
    row's geometry (bonded-scale spacing inside the pocket)."""
    from bio_diffusion_torch.cli import bench_pocket_quality

    monkeypatch.setenv("POCKET_PRESET", "tiny")
    monkeypatch.setenv("POCKET_WORKDIR", str(tmp_path))
    result = bench_pocket_quality.main(["device=cpu"])
    assert (result["device"], result["preset"], result["steps"]) == ("cpu", "tiny", 6)
    columns = {"atm_stable", "mol_stable", "kl_div_atom_types", "lig_nn_dist", "lig_center_rms"}
    for row in ("data", "trained", "random"):
        assert set(result[row]) >= columns and all(np.isfinite(v) for v in result[row].values()), row
    assert 0.8 < result["data"]["lig_nn_dist"] < 1.6 and result["data"]["lig_center_rms"] < 8.0
    assert np.isfinite(result["final_loss"]) and np.isfinite(result["first_loss"])

"""Port parity: the pocket data module and protein features, against the JAX package.

Everything here is numpy, so it must match exactly: the Binding MOAD /
CrossDocked tables (the port's own copy of the assets), the ligand and
joint statistics tables and their bond tables, joint size draws, synthetic
pockets and joint datasets for the same seed, the joint batch, the pocket
branch of ``build_datasets``, and ``load_pocket_pdb`` on the JAX package's
fixture and on one with HETATM and ATOM MSE, PTR and alternate locations
(coordinates, types, warning text and errors; a HETATM CA is dropped
uncounted, in both).  The protein features (torch) within 1e-5 of JAX's.
"""

import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_diffusion_tpu.chem.stability import ensure_bond_tables as jax_ensure_bond_tables
from bio_diffusion_tpu.config.build import build_datasets as jax_build_datasets
from bio_diffusion_tpu.config.build import build_experiment as jax_build_experiment
from bio_diffusion_tpu.config.build import get_dataset_info_for as jax_get_dataset_info_for
from bio_diffusion_tpu.config.loader import load_config as jax_load_config
from bio_diffusion_tpu.data import pocket as jax_pocket
from bio_diffusion_tpu.data import protein_features as jax_features
from bio_diffusion_torch.chem.stability import ensure_bond_tables
from bio_diffusion_torch.config.build import build_datasets, build_experiment, get_dataset_info_for
from bio_diffusion_torch.config.loader import default_config_dir, load_config
from bio_diffusion_torch.data import pocket
from bio_diffusion_torch.data import protein_features as features
from test_pocket_generation import _pdb_line, _write_fixture_pdb

DATASETS = ("bindingmoad", "crossdock", "crossdock_full")


def assert_same(a, b, path="info"):
    """Equal nested tables: dicts, lists, scalars and arrays, exactly."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            assert_same(u, v, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def test_assets_are_a_copy():
    for name in ("pocket_dataset_params.json.gz", "pocket_dataset_params.npz"):
        ours = os.path.join(os.path.dirname(pocket.__file__), "assets", name)
        ref = os.path.join(os.path.dirname(jax_pocket.__file__), "assets", name)
        assert ours != ref and open(ours, "rb").read() == open(ref, "rb").read()


@pytest.mark.parametrize("name", DATASETS)
def test_dataset_tables_match_jax(name):
    assert_same(pocket.get_pocket_dataset_info(name), jax_pocket.get_pocket_dataset_info(name))
    assert_same(pocket.ligand_dataset_info(name), jax_pocket.ligand_dataset_info(name))
    joint = pocket.joint_dataset_info(name)
    assert_same(joint, jax_pocket.joint_dataset_info(name))
    # the sampling evaluation installs bond tables into the joint table
    tables = ensure_bond_tables(joint)
    ref = jax_ensure_bond_tables(jax_pocket.joint_dataset_info(name))
    k = len(joint["atom_decoder"])
    for bonds in ("bonds1", "bonds2", "bonds3"):
        assert tables[bonds].shape == (k, k)
        np.testing.assert_array_equal(tables[bonds], ref[bonds])
    with pytest.raises(ValueError, match="Unknown pocket dataset"):
        pocket.get_pocket_dataset_info(name + "_x")


@pytest.mark.parametrize("pocket_size", [None, 30])
def test_joint_sizes_and_synthetic_pockets_match_jax(pocket_size):
    ours = pocket.sample_joint_sizes("bindingmoad", 50, np.random.default_rng(4), pocket_size=pocket_size)
    ref = jax_pocket.sample_joint_sizes("bindingmoad", 50, np.random.default_rng(4), pocket_size=pocket_size)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert (ours[0] > 0).all() and (ours[1] > 0).all()
    sizes = np.array([6, 11, 3])
    rng_a, rng_b = np.random.default_rng(9), np.random.default_rng(9)
    for a, b in zip(pocket.synthetic_pockets("crossdock", sizes, rng_a),
                    jax_pocket.synthetic_pockets("crossdock", sizes, rng_b)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert rng_a.random() == rng_b.random()  # the same draws were consumed


@pytest.mark.parametrize("seed,cap", [(0, None), (3, 60)])
def test_synthetic_joint_dataset_matches_jax(seed, cap):
    ours = pocket.synthetic_pocket_joint_dataset("bindingmoad", num_graphs=12, seed=seed, max_total_nodes=cap)
    ref = jax_pocket.synthetic_pocket_joint_dataset("bindingmoad", num_graphs=12, seed=seed, max_total_nodes=cap)
    assert_same(ours.data, ref.data)
    np.testing.assert_array_equal(ours.included_species, ref.included_species)
    if cap:
        assert ours.data["num_atoms"].max() <= cap


def test_joint_batch_matches_jax():
    rng = np.random.default_rng(1)
    lig_mask = (np.arange(4)[None] < np.array([4, 2])[:, None]).astype(np.float32)
    poc_mask = (np.arange(5)[None] < np.array([3, 5])[:, None]).astype(np.float32)
    args = (rng.normal(size=(2, 4, 3)).astype(np.float32), np.eye(10, dtype=np.float32)[rng.integers(0, 10, (2, 4))],
            lig_mask, rng.normal(size=(2, 5, 3)).astype(np.float32),
            np.eye(20, dtype=np.float32)[rng.integers(0, 20, (2, 5))], poc_mask)
    ours, ref = pocket.JointLigandPocketBatch(*args), jax_pocket.JointLigandPocketBatch(*args)
    for f in ("x", "one_hot", "node_mask", "fixed_mask", "num_ligand_nodes", "num_pocket_nodes"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f), err_msg=f)
    a, b = ours.as_dense_batch(), ref.as_dense_batch()
    for f in ("x", "one_hot", "charges", "node_mask"):
        np.testing.assert_array_equal(getattr(a, f), np.asarray(getattr(b, f)), err_msg=f)
    assert a.context is None and b.context is None


def call_both(path, **kwargs):
    """``load_pocket_pdb`` of both packages -> ((x, aa) or the error text,
    the warnings' texts) each."""
    out = []
    for fn in (pocket.load_pocket_pdb, jax_pocket.load_pocket_pdb):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                result = fn(path, **kwargs)
            except ValueError as e:
                result = str(e)
        out.append((result, [str(w.message) for w in caught]))
    return out


PDB_CASES = [{}, {"chain": "A"}, {"chain": "B"}, {"ligand_resname": "LIG"}, {"ligand_resname": "XYZ"},
             {"center": np.array([10.0, 0.0, -5.0]), "radius": 3.0}, {"chain": "C"},
             {"ligand_resname": "LIG", "radius": 60.0}, {"pocket_name": "crossdock"}]


@pytest.mark.parametrize("kwargs", PDB_CASES)
def test_load_pocket_pdb_matches_jax_on_its_fixture(tmp_path, kwargs):
    path = str(tmp_path / "site.pdb")
    _write_fixture_pdb(path, np.random.default_rng(0))
    (ours, our_warn), (ref, ref_warn) = call_both(path, **kwargs)
    assert our_warn == ref_warn
    if isinstance(ref, str):
        assert ours == ref
        return
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def write_mse_fixture(path):
    """ATOM ALA; HETATM MSE; GLY with altlocs A and B; ATOM PTR; HETATM
    PTR; ATOM MSE; a HETATM ligand; a second model that must not be read."""
    lines = [
        _pdb_line(1, "ALA", "A", 1, 0.0, 0.0, 0.0),
        _pdb_line(2, "MSE", "A", 2, 3.8, 0.0, 0.0, rec="HETATM"),
        _pdb_line(3, "GLY", "A", 3, 7.6, 0.0, 0.0, altloc="A"),
        _pdb_line(4, "GLY", "A", 3, 7.9, 0.5, 0.0, altloc="B"),
        _pdb_line(5, "PTR", "A", 4, 11.4, 0.0, 0.0),
        _pdb_line(6, "PTR", "A", 5, 15.2, 0.0, 0.0, rec="HETATM"),
        _pdb_line(7, "MSE", "A", 6, 19.0, 0.0, 0.0),
        _pdb_line(8, "LIG", "A", 99, 8.0, 2.0, 0.0, rec="HETATM", name=" C1 "),
        "ENDMDL",
        _pdb_line(9, "TRP", "A", 1, 50.0, 50.0, 50.0),
        "END",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("kwargs", [{}, {"ligand_resname": "LIG"}, {"chain": "A"}])
def test_load_pocket_pdb_mse_ptr_altloc_matches_jax(tmp_path, kwargs):
    path = str(tmp_path / "mse.pdb")
    write_mse_fixture(path)
    (ours, our_warn), (ref, ref_warn) = call_both(path, **kwargs)
    assert our_warn == ref_warn
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    enc = pocket.get_pocket_dataset_info("bindingmoad")["aa_encoder"]
    if not kwargs:
        # kept: ALA, GLY altloc A, ATOM MSE (as M); dropped: both HETATM CAs
        # (uncounted), GLY altloc B (uncounted) and ATOM PTR (counted: 1)
        np.testing.assert_array_equal(ours[1], [enc["A"], enc["G"], enc["M"]])
        np.testing.assert_array_equal(ours[0][:, 0], np.array([0.0, 7.6, 19.0], np.float32))
        assert len(our_warn) == 1 and "skipped 1 CA" in our_warn[0]


def test_protein_features_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(7, 3, 3)).astype(np.float32) * 2.0
    tx = torch.from_numpy(x)
    for ours, ref in ((features.dihedrals(tx), jax_features.dihedrals(jnp.asarray(x))),
                      (features.sidechains(tx), jax_features.sidechains(jnp.asarray(x)))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)
    d = np.array([0.0, 1.3, 10.0, 19.5, 25.0], np.float32)
    np.testing.assert_allclose(features.rbf(torch.from_numpy(d)).numpy(), np.asarray(jax_features.rbf(jnp.asarray(d))),
                               atol=1e-5)
    off = np.array([-3.0, 0.0, 2.0, 7.0], np.float32)
    np.testing.assert_allclose(features.positional_embeddings(torch.from_numpy(off)).numpy(),
                               np.asarray(jax_features.positional_embeddings(jnp.asarray(off))), atol=1e-5)
    pts = rng.normal(size=(9, 3)).astype(np.float32) * 3.0
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 1, 1], np.float32)
    for k in (2, 5, 8):
        idx, m = features.masked_knn_graph(torch.from_numpy(pts), torch.from_numpy(mask), k)
        ridx, rm = jax_features.masked_knn_graph(jnp.asarray(pts), jnp.asarray(mask), k)
        np.testing.assert_array_equal(m.numpy(), np.asarray(rm))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
        assert idx.dtype == torch.int32
    idx, m = features.masked_radius_graph(torch.from_numpy(pts), torch.from_numpy(mask), 4.0, 4)
    ridx, rm = jax_features.masked_radius_graph(jnp.asarray(pts), jnp.asarray(mask), 4.0, 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(m.numpy(), np.asarray(rm))


POCKET_DATA = ["experiment=pocket_mol_gen_ddpm", "datamodule.dataloader_cfg.num_train=10",
               "datamodule.dataloader_cfg.num_valid=4", "datamodule.dataloader_cfg.num_test=-1"]


def test_pocket_build_datasets_match_jax():
    exp = build_experiment(load_config(default_config_dir(), "train", POCKET_DATA))
    jexp = jax_build_experiment(jax_load_config(default_config_dir(), "train", POCKET_DATA))
    assert exp.dataloader_cfg.dataset == "bindingmoad" and exp.dataloader_cfg.num_atom_types == 30
    assert_same(get_dataset_info_for(exp), jax_get_dataset_info_for(jexp))
    ours, ref = build_datasets(exp), jax_build_datasets(jexp)
    assert set(ours) == set(ref) == {"train", "valid", "test"}
    assert [len(ours[s]) for s in ("train", "valid", "test")] == [10, 4, 128]
    for split in ours:
        assert_same(ours[split].data, ref[split].data, split)


@pytest.mark.parametrize("module", ["data/pocket.py", "data/protein_features.py", "cli/bench_pocket_quality.py"])
def test_pocket_modules_import_nothing_of_jax(module):
    """The AST scan of tests/test_torch_config.py covers the new modules,
    and they import neither jax nor the JAX package."""
    import ast
    import pathlib

    from test_torch_config import _port_sources

    path = pathlib.Path(pocket.__file__).parent.parent / module
    assert path in _port_sources()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
            assert not any(n.split(".")[0] in ("jax", "bio_diffusion_tpu") for n in names), (module, names)

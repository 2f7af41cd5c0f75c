"""Port parity: the GEOM-Drugs data path against the JAX package.

* ``write_geom_layout`` writes the conformer files ``extract_conformers``
  writes (``[total_atoms, 5]`` mol_id, Z, x, y, z; atom counts; one SMILES
  a molecule), from a seed, with GEOM-Drugs' sizes and atom types.
* ``load_split_data`` and ``load_geom_datasets`` give the JAX package's
  splits, order, dense arrays and one-hot exactly, with the permutation file
  present and absent (the file written byte-equal to JAX's), with
  ``filter_size`` and with ``remove_h`` (``GEOM_NO_H``); without the files
  the loader raises and never downloads.
* ``extract_conformers`` on a small msgpack written here writes the JAX
  package's three files byte for byte (with and without hydrogens).
* The GEOM statistics tables and ``get_dataset_info_for`` equal the JAX
  package's; the SMILES list is read from GEOM's text file.
* ``node_budget_batches`` gives the JAX function's batches for the same rng
  and bucket ladder.
* The Trainer's ``_batch_iter`` pads GEOM batches to their buckets and QM9
  and synthetic batches to the dataset's width, as the JAX Trainer does.
"""

import filecmp
import os
import types

import numpy as np
import pytest

from bio_diffusion_tpu.data import dataset_info as jax_info
from bio_diffusion_tpu.data import geom as jax_geom
from bio_diffusion_tpu.data.samplers import node_budget_batches as jax_node_budget_batches
from bio_diffusion_tpu.train.loop import Trainer as JaxTrainer
from bio_diffusion_torch.config.build import build_experiment
from bio_diffusion_torch.config.loader import default_config_dir, load_config
from bio_diffusion_torch.data import dataset_info, geom
from bio_diffusion_torch.data.samplers import node_budget_batches
from bio_diffusion_torch.data.synthetic import write_geom_layout
from bio_diffusion_torch.train.loop import Trainer

BUCKETS = (48, 64, 96, 128, 192)


@pytest.fixture(scope="module")
def geom_dir(tmp_path_factory):
    """Seeded GEOM-layout files (150 conformers), no permutation file yet."""
    root = str(tmp_path_factory.mktemp("geom"))
    write_geom_layout(root, num_conformers=150, seed=4)
    return root


def copy_files(src_dir, dst_dir, names):
    os.makedirs(dst_dir, exist_ok=True)
    for name in names:
        with open(os.path.join(src_dir, name), "rb") as f, open(os.path.join(dst_dir, name), "wb") as g:
            g.write(f.read())


def assert_same_splits(ours, ref):
    assert list(ours) == list(ref)
    for split in ref:
        assert len(ours[split]) == len(ref[split]), split
        for a, b in zip(ours[split], ref[split]):
            assert a.dtype == b.dtype and np.array_equal(a, b), split


def assert_same_datasets(ours, ref):
    assert list(ours) == list(ref)
    for split in ref:
        a, b = ours[split], ref[split]
        assert sorted(a.data) == sorted(b.data), split
        for key in b.data:
            assert a.data[key].dtype == b.data[key].dtype, (split, key)
            np.testing.assert_array_equal(a.data[key], b.data[key], err_msg=f"{split}/{key}")
        np.testing.assert_array_equal(a.included_species, b.included_species)


def test_written_layout(geom_dir):
    gdir = os.path.join(geom_dir, "GEOM")
    arr = np.load(os.path.join(gdir, "GEOM_drugs_30.npy"))
    counts = np.load(os.path.join(gdir, "GEOM_drugs_n_30.npy"))
    with open(os.path.join(gdir, "GEOM_drugs_smiles.txt")) as f:
        smiles = f.read().splitlines()
    assert arr.shape == (counts.sum(), 5) and arr.dtype == np.float64 and len(counts) == 150
    ids = arr[:, 0].astype(int)
    assert np.array_equal(np.unique(ids), np.arange(150)) and np.array_equal(np.bincount(ids), counts)
    assert counts.min() >= 3 and counts.max() <= 181
    assert set(np.unique(arr[:, 1]).astype(int)) <= set(dataset_info.GEOM_WITH_H["atomic_nb"])
    assert (arr[:, 1] == 1).any() and 50 <= len(smiles) < 150  # hydrogens; 1-3 conformers a molecule
    assert not os.path.exists(os.path.join(gdir, "GEOM_permutation.npy"))
    # the same seed writes the same bytes
    again = os.path.join(geom_dir, "again")
    write_geom_layout(again, num_conformers=150, seed=4)
    for name in ("GEOM_drugs_30.npy", "GEOM_drugs_n_30.npy", "GEOM_drugs_smiles.txt"):
        assert filecmp.cmp(os.path.join(gdir, name), os.path.join(again, "GEOM", name), shallow=False)


@pytest.mark.parametrize("filter_size", [None, 40])
def test_split_data_matches_jax_with_and_without_permutation(geom_dir, tmp_path, filter_size):
    names = ("GEOM_drugs_30.npy", "GEOM_drugs_n_30.npy", "GEOM_drugs_smiles.txt")
    src = os.path.join(geom_dir, "GEOM")
    ours_dir, jax_dir = str(tmp_path / "ours"), str(tmp_path / "jax")
    copy_files(src, ours_dir, names)
    copy_files(src, jax_dir, names)
    # no permutation file: each package writes one from RandomState(0)
    ours = geom.load_split_data(os.path.join(ours_dir, names[0]), filter_size=filter_size)
    ref = jax_geom.load_split_data(os.path.join(jax_dir, names[0]), filter_size=filter_size)
    assert_same_splits(ours, ref)
    perm = "GEOM_permutation.npy"
    assert filecmp.cmp(os.path.join(ours_dir, perm), os.path.join(jax_dir, perm), shallow=False)
    # with the file present, both read it
    assert_same_splits(geom.load_split_data(os.path.join(ours_dir, names[0]), filter_size=filter_size),
                       jax_geom.load_split_data(os.path.join(jax_dir, names[0]), filter_size=filter_size))
    total = sum(len(v) for v in ours.values())
    assert (len(ours["valid"]), len(ours["test"])) == (int(total * 0.1), int(total * 0.1))
    if filter_size:
        assert all(len(m) <= filter_size for v in ours.values() for m in v) and total < 150


def test_geom_datasets_match_jax(geom_dir, tmp_path):
    ours = geom.load_geom_datasets(geom_dir)
    assert_same_datasets(ours, jax_geom.load_geom_datasets(geom_dir))
    train = ours["train"]
    assert train.num_species == 16 and train.data["one_hot"].shape[-1] == 16
    real = train.data["charges"] > 0
    assert np.array_equal(train.data["one_hot"].sum(-1), real.astype(np.float32))
    assert np.array_equal(real.sum(1), train.data["num_atoms"])
    with pytest.raises(FileNotFoundError, match="does not download"):
        geom.load_geom_datasets(str(tmp_path))


def write_msgpack(path, seed):
    """A tiny GEOM crude file: two chunks of molecules with 2-4 conformers
    each (xyz rows Z, x, y, z, hydrogens included)."""
    import msgpack

    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for chunk in range(2):
            mols = {}
            for m in range(3):
                n = int(rng.integers(4, 9))
                z = rng.choice([1, 6, 7, 8, 16], size=n).astype(float)
                confs = [{"totalenergy": float(rng.normal()),
                          "xyz": np.concatenate([z[:, None], rng.normal(size=(n, 3))], 1).tolist()}
                         for _ in range(int(rng.integers(2, 5)))]
                mols[f"C{chunk}{m}" + "O" * m] = {"conformers": confs}
            f.write(msgpack.packb(mols))


@pytest.mark.parametrize("remove_h", [False, True])
def test_extract_conformers_matches_jax(tmp_path, remove_h):
    pytest.importorskip("msgpack")
    ours_dir, jax_dir = tmp_path / "ours", tmp_path / "jax"
    for d in (ours_dir, jax_dir):
        d.mkdir()
        write_msgpack(str(d / "drugs_crude.msgpack"), seed=2)
    geom.extract_conformers(str(ours_dir), conformations=3, remove_h=remove_h)
    jax_geom.extract_conformers(str(jax_dir), conformations=3, remove_h=remove_h)
    tag = "no_h_" if remove_h else ""
    names = [f"GEOM_drugs_{tag}3.npy", f"GEOM_drugs_n_{tag}3.npy", "GEOM_drugs_smiles.txt"]
    for name in names:
        assert filecmp.cmp(ours_dir / name, jax_dir / name, shallow=False), name
    arr = np.load(ours_dir / names[0])
    assert (arr[:, 1] != 1).all() if remove_h else (arr[:, 1] == 1).any()
    # the extracted file loads through the GEOM loader, hydrogens removed or not
    gdir = tmp_path / "data" / "GEOM"
    gdir.mkdir(parents=True)
    os.replace(ours_dir / names[0], gdir / f"GEOM_drugs_{tag}30.npy")
    ours = geom.load_geom_datasets(str(tmp_path / "data"), remove_h=remove_h)
    info = dataset_info.GEOM_NO_H if remove_h else dataset_info.GEOM_WITH_H
    assert ours["train"].num_species == len(info["atomic_nb"])
    assert_same_datasets(ours, jax_geom.load_geom_datasets(str(tmp_path / "data"), remove_h=remove_h))


def test_geom_tables_and_info_match_jax(geom_dir):
    from bio_diffusion_tpu.config.build import build_experiment as jax_build_experiment
    from bio_diffusion_tpu.config.build import get_dataset_info_for as jax_info_for
    from bio_diffusion_torch.chem.rdkit_bridge import load_smiles_list
    from bio_diffusion_torch.config.build import build_datasets, get_dataset_info_for

    assert dataset_info.GEOM_WITH_H == jax_info.GEOM_WITH_H
    assert dataset_info.GEOM_NO_H == jax_info.GEOM_NO_H
    assert dataset_info.get_dataset_info("GEOM", True) is dataset_info.GEOM_NO_H
    for remove_h in (False, True):
        cfg = load_config(default_config_dir(), "train", ["experiment=geom_mol_gen_ddpm",
                                                          f"datamodule.dataloader_cfg.remove_h={remove_h}"])
        assert get_dataset_info_for(build_experiment(cfg)) == jax_info_for(jax_build_experiment(cfg))
    cfg = load_config(default_config_dir(), "train", ["experiment=geom_mol_gen_ddpm",
                                                      f"datamodule.dataloader_cfg.data_dir={geom_dir}"])
    exp = build_experiment(cfg)
    assert_same_datasets(build_datasets(exp), jax_geom.load_geom_datasets(geom_dir))
    smiles = load_smiles_list(exp.dataloader_cfg.smiles_filepath)
    with open(os.path.join(geom_dir, "GEOM", "GEOM_drugs_smiles.txt")) as f:
        assert smiles == f.read().split()
    cfg["datamodule"]["dataloader_cfg"]["force_download"] = True
    with pytest.raises(RuntimeError, match="does not download"):
        build_datasets(build_experiment(cfg))


@pytest.mark.parametrize("buckets", [None, BUCKETS])
@pytest.mark.parametrize("shuffle", [True, False])
def test_node_budget_batches_match_jax(geom_dir, buckets, shuffle):
    sizes = geom.load_geom_datasets(geom_dir)["train"].data["num_atoms"]
    kw = dict(max_nodes_per_batch=1024, shuffle=shuffle, bucket_sizes=buckets)
    ours = list(node_budget_batches(sizes, rng=np.random.default_rng(5), **kw))
    ref = list(jax_node_budget_batches(sizes, rng=np.random.default_rng(5), **kw))
    assert len(ours) == len(ref) > 1
    assert all(np.array_equal(a, b) for a, b in zip(ours, ref))
    assert sorted(np.concatenate(ours).tolist()) == list(range(len(sizes)))


def trainer_stub(dataset, datasets, seed=3):
    dl = types.SimpleNamespace(dataset=dataset, batch_size=8, shuffle=True, drop_last=True, pad_to_multiple=1,
                               bucket_sizes=BUCKETS)
    return types.SimpleNamespace(exp=types.SimpleNamespace(dataloader_cfg=dl), datasets=datasets,
                                 rng=np.random.default_rng(seed), conditioning=(), props_norms=None)


@pytest.mark.parametrize("dataset", ["GEOM", "QM9", "synthetic"])
@pytest.mark.parametrize("split", ["train", "valid"])
def test_trainer_batches_pad_as_jax(geom_dir, dataset, split):
    if dataset == "GEOM":
        datasets = geom.load_geom_datasets(geom_dir)
    else:
        from bio_diffusion_torch.data.synthetic import synthetic_qm9_like

        datasets = {"train": synthetic_qm9_like(40, seed=1), "valid": synthetic_qm9_like(20, seed=2)}
    ours = list(Trainer._batch_iter(trainer_stub(dataset, datasets), split))
    ref = list(JaxTrainer._batch_iter(trainer_stub(dataset, datasets), split))
    assert len(ours) == len(ref) > 1
    width = datasets[split].data["positions"].shape[1]
    for a, b in zip(ours, ref):
        for f in ("x", "one_hot", "charges", "node_mask"):
            np.testing.assert_array_equal(getattr(a, f), np.asarray(getattr(b, f)), err_msg=f)
        n = a.node_mask.shape[1]
        largest = int(a.node_mask.sum(1).max())
        if dataset == "GEOM":
            assert n == min(b for b in BUCKETS if b >= largest)
        else:
            assert n == width


@pytest.mark.parametrize("module", ["data/geom.py", "data/samplers.py", "data/dataset_info.py"])
def test_geom_modules_import_nothing_of_jax(module):
    """The AST scan of tests/test_torch_config.py covers the GEOM modules,
    and they import neither jax nor the JAX package."""
    import ast
    import pathlib

    from test_torch_config import _port_sources

    path = pathlib.Path(geom.__file__).parent.parent / module
    assert path in _port_sources()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else [node.module or ""]
            assert not any(n.split(".")[0] in ("jax", "bio_diffusion_tpu") for n in names), (module, names)

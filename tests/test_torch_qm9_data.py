"""The port's QM9 loader and the Trainer's batch limits against the JAX package.

* On processed npz files that the test writes (the EDM keys, hydrogens,
  ``*_thermo`` columns), ``load_qm9_datasets`` of the port and of the JAX
  package give equal arrays (``np.array_equal``, same dtypes) and the same
  species, with and without hydrogens, for both half re-splits, with
  ``num_pts`` and without thermo subtraction; the ``DenseDataset`` helpers
  agree too.
* A 3-record GDB9 tarball with ``uncharacterized.txt`` and ``atomref.txt``
  gives equal arrays through ``gen_splits_gdb9``, ``process_gdb9_tar`` and
  ``parse_thermo``, and the port processes it into npz files when only the
  raw files are on disk.
* With no files on disk the port raises and never touches ``urllib``.
* ``Trainer._limited`` (batch limits, ``fast_dev_run``) yields the same
  batches as the JAX package's, both run unbound on a stub; ``overfit_batches``
  repeats the first unshuffled batches every epoch.
"""

import io
import tarfile
import types

import numpy as np
import pytest

from bio_diffusion_tpu.data import qm9 as jax_qm9
from bio_diffusion_tpu.train.loop import Trainer as JaxTrainer
from bio_diffusion_torch.data import qm9
from bio_diffusion_torch.data.synthetic import write_qm9_layout
from bio_diffusion_torch.train.loop import Trainer


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("edm")
    write_qm9_layout(str(d), counts=(48, 12, 12), seed=5)
    return str(d)


def assert_same_datasets(ours, ref):
    assert set(ours) == set(ref) == {"train", "valid", "test"}
    for split in ref:
        a, b = ours[split], ref[split]
        assert set(a.data) == set(b.data), split
        for k, v in b.data.items():
            assert a.data[k].dtype == v.dtype and np.array_equal(a.data[k], v), (split, k)
        assert np.array_equal(a.included_species, b.included_species)
        assert (a.num_species, a.max_charge, a.stats()) == (b.num_species, b.max_charge, b.stats())
        assert np.array_equal(a.property_values("U0"), b.property_values("U0"))


@pytest.mark.parametrize("dataset,remove_h,subtract_thermo,num_pts", [
    ("QM9", False, True, None),
    ("QM9", True, True, None),
    ("QM9_first_half", False, True, None),
    ("QM9_second_half", True, False, None),
    ("QM9", False, True, {"train": 10, "valid": 5, "test": -1}),
])
def test_loader_matches_jax(data_dir, dataset, remove_h, subtract_thermo, num_pts):
    kw = dict(dataset=dataset, remove_h=remove_h, subtract_thermo=subtract_thermo, num_pts=num_pts)
    ours = qm9.load_qm9_datasets(data_dir, **kw)
    assert_same_datasets(ours, jax_qm9.load_qm9_datasets(data_dir, **kw))
    if remove_h:
        assert all((d.data["charges"] != 1).all() for d in ours.values())
    if num_pts:
        assert (len(ours["train"]), len(ours["valid"])) == (10, 5)


@pytest.mark.parametrize("dataset,remove_h", [("QM9", False), ("QM9", True), ("QM9_first_half", False),
                                               ("QM9_second_half", False), ("synthetic", False)])
def test_dataset_info_for_matches_jax(dataset, remove_h):
    from bio_diffusion_tpu.config.build import build_experiment as jax_build_experiment
    from bio_diffusion_tpu.config.build import get_dataset_info_for as jax_info_for
    from bio_diffusion_torch.config.build import build_experiment, get_dataset_info_for
    from bio_diffusion_torch.config.loader import default_config_dir, load_config

    cfg = load_config(default_config_dir(), "train", [f"datamodule.dataloader_cfg.dataset={dataset}",
                                                      f"datamodule.dataloader_cfg.remove_h={remove_h}"])
    assert get_dataset_info_for(build_experiment(cfg)) == jax_info_for(jax_build_experiment(cfg))


def gdb9_record(index, atoms, rng):
    lines = [f"{len(atoms)}\n",
             "gdb {} {}\n".format(index, "\t".join(f"{v:.6f}" for v in rng.normal(size=15)))]
    for k, a in enumerate(atoms):
        x, y, z = rng.normal(size=3)
        # GDB9 writes some exponents as Mathematica's "*^"
        xs = f"{x * 10:.8f}*^-1" if k == 0 else f"{x:.10f}"
        lines.append(f"{a}\t{xs}\t{y:.10f}\t{z:.10f}\t{rng.normal():.6f}\n")
    lines.append("\t".join(f"{w:.4f}" for w in rng.uniform(100, 4000, size=3 * len(atoms) - 6)) + "\n")
    lines += ["C\tC\n", "InChI=1S/x\tInChI=1S/x\n"]
    return "".join(lines)


@pytest.fixture(scope="module")
def gdb9_dir(tmp_path_factory):
    """``<dir>/QM9`` with a 3-record tarball and the two text files."""
    root = tmp_path_factory.mktemp("gdb9")
    qm9_dir = root / "QM9"
    qm9_dir.mkdir()
    rng = np.random.default_rng(0)
    with tarfile.open(qm9_dir / qm9.GDB9_TAR, "w:bz2") as tar:
        for i, atoms in enumerate((["C", "H", "H", "H", "H"], ["N", "H", "H", "H"], ["O", "C", "F", "H"])):
            data = gdb9_record(i + 1, atoms, rng).encode()
            info = tarfile.TarInfo(f"dsgdb9nsd_{i + 1:06d}.xyz")
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    excluded = rng.choice(np.arange(4, qm9.NUM_GDB9 + 1), size=qm9.NUM_EXCLUDED, replace=False)
    (qm9_dir / qm9.GDB9_EXCLUDED).write_text(
        "Uncharacterized molecules\n  Index  Name\n" + "".join(f"{i:7d}  x\n" for i in sorted(excluded)))
    (qm9_dir / qm9.GDB9_THERMO).write_text(
        "Element ZPVE U(0K) U(298.15K) H G Cv\n"
        + "".join(f"{el}  0.000000  {u:.6f}  {u + 0.001:.6f}  {u + 0.002:.6f}  {u - 0.01:.6f}  2.981\n"
                  for el, u in (("H", -0.5), ("C", -37.8), ("N", -54.5), ("O", -75.0), ("F", -99.7))))
    return root


def test_gdb9_files_match_jax(gdb9_dir, monkeypatch):
    qm9_dir = gdb9_dir / "QM9"
    lines = (qm9_dir / qm9.GDB9_EXCLUDED).read_text().splitlines(keepends=True)
    splits, ref_splits = qm9.gen_splits_gdb9(lines), jax_qm9.gen_splits_gdb9(lines)
    for split in ("train", "valid", "test"):
        assert np.array_equal(splits[split], ref_splits[split])
    atomref = (qm9_dir / qm9.GDB9_THERMO).read_text().splitlines(keepends=True)
    therm = qm9.parse_thermo(atomref)
    assert therm == jax_qm9.parse_thermo(atomref) and therm["U0"][6] == -37.8

    small = {"train": np.array([0, 2]), "valid": np.array([1]), "test": np.array([1, 2])}
    tar = str(qm9_dir / qm9.GDB9_TAR)
    ours, ref = qm9.process_gdb9_tar(tar, small), jax_qm9.process_gdb9_tar(tar, small)
    for split in small:
        assert set(ours[split]) == set(ref[split])
        for k, v in ref[split].items():
            assert ours[split][k].dtype == v.dtype and np.array_equal(ours[split][k], v), (split, k)
    assert list(ours["train"]["num_atoms"]) == [5, 4] and ours["train"]["positions"].shape == (2, 5, 3)

    # only the raw files on disk: the port processes them into the npz layout
    monkeypatch.setattr(qm9, "gen_splits_gdb9", lambda _: small)
    loaded = qm9.load_qm9_datasets(str(gdb9_dir), subtract_thermo=False, convert_to_ev=False)
    for split in small:
        expect = jax_qm9.add_thermo_targets(ref[split], jax_qm9.parse_thermo(atomref))
        with np.load(qm9_dir / f"{split}.npz") as f:
            assert set(f) == set(expect) and all(np.array_equal(f[k], v) for k, v in expect.items())
        assert np.array_equal(loaded[split].data["positions"], expect["positions"])


def test_missing_files_raise_without_download(tmp_path, monkeypatch):
    import urllib.request

    def no_network(*args, **kwargs):
        raise AssertionError("the port must not download")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_network)
    monkeypatch.setattr(urllib.request, "urlopen", no_network)
    with pytest.raises(RuntimeError, match="does not download"):
        qm9.load_qm9_datasets(str(tmp_path))
    assert not (tmp_path / "QM9").exists()

    from bio_diffusion_torch.config.build import build_datasets, build_experiment
    from bio_diffusion_torch.config.loader import default_config_dir, load_config

    cfg = load_config(default_config_dir(), "train", [f"datamodule.dataloader_cfg.data_dir={tmp_path}"])
    with pytest.raises(RuntimeError, match="does not download"):
        build_datasets(build_experiment(cfg))
    cfg["datamodule"]["dataloader_cfg"]["force_download"] = True
    with pytest.raises(RuntimeError, match="does not download"):
        build_datasets(build_experiment(cfg))


def limit_stub(raw_limit, split, fast_dev_run=False, m=30, batch_size=4, drop_last=True):
    key = {"train": "limit_train_batches", "valid": "limit_val_batches"}[split]
    return types.SimpleNamespace(
        exp=types.SimpleNamespace(
            trainer=types.SimpleNamespace(fast_dev_run=fast_dev_run),
            raw={"trainer": {key: raw_limit}},
            dataloader_cfg=types.SimpleNamespace(batch_size=batch_size, drop_last=drop_last)),
        datasets={split: list(range(m))})


@pytest.mark.parametrize("fast_dev_run", [False, True])
@pytest.mark.parametrize("split", ["train", "valid"])
@pytest.mark.parametrize("raw_limit,expected", [
    # int 1 is one batch, 1.0 the whole split (8 batches of 4 of 30 molecules),
    # a fraction counts from the split's length (7 full train batches)
    (1, {"train": 1, "valid": 1}), (1.0, {"train": 8, "valid": 8}),
    (0.25, {"train": 1, "valid": 2}), (3, {"train": 3, "valid": 3}),
])
def test_batch_limits_match_jax(raw_limit, expected, split, fast_dev_run):
    stub = limit_stub(raw_limit, split, fast_dev_run)
    ours = list(Trainer._limited(stub, iter(range(8)), float(raw_limit), split))
    ref = list(JaxTrainer._limited(stub, iter(range(8)), float(raw_limit), split))
    assert ours == ref
    assert len(ours) == (1 if fast_dev_run else expected[split])


def test_overfit_batches_repeat_the_first_unshuffled_batches():
    calls = []

    def batch_iter(split, shuffle=True):
        calls.append((split, shuffle))
        return iter(range(10))

    stub = types.SimpleNamespace(exp=types.SimpleNamespace(trainer=types.SimpleNamespace(overfit_batches=3)),
                                 _overfit_cache=None, _batch_iter=batch_iter)
    epochs = [list(Trainer._train_batches(stub)) for _ in range(3)]
    assert epochs == [[0, 1, 2]] * 3 and calls == [("train", False)]

"""The port's tool paths against the JAX package's: the native xyz parser and
batch collation (bit for bit), ``iterate_dense_batches`` through it, where
its library is built, the hyperparameter search over the tiny CPU train
line, the shape-sweep and train-step benchmarks at the tiny width on the
CPU, and ``first_contact`` on a tiny reference-layout checkpoint."""

import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from bio_diffusion_torch.data import batch as port_batch
from bio_diffusion_torch.data import native_loader as port_native
from bio_diffusion_torch.ops import build
from test_torch_common import TINY_OVERRIDES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_MODEL = [o for o in TINY_OVERRIDES if o.startswith("model.model_cfg.")]


def _record(rng, n):
    """A GDB9-format xyz record (the JAX package's test_native_loader's)."""
    els = rng.choice(["H", "C", "N", "O", "F"], size=n)
    props = rng.normal(size=15)
    lines = [f"{n}", "gdb 42 " + " ".join(f"{p:.6f}" for p in props)]
    for e in els:
        x, y, z, q = rng.normal(size=4)
        xs = f"{x:.6f}" if rng.random() > 0.3 else f"{x:.4f}*^-2"
        lines.append(f"{e}\t{xs}\t{y:.6f}\t{z:.6f}\t{q:.4f}")
    lines.append("100.5 2500.25 3001.0")
    lines.append("InChI=1S/stub")
    return ("\n".join(lines) + "\n").encode()


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _native_tree():
    native = os.path.join(REPO, "native")
    return {name: (os.stat(os.path.join(native, name)).st_mtime_ns,
                   hashlib.sha256(open(os.path.join(native, name), "rb").read()).hexdigest())
            for name in sorted(os.listdir(native))}


def test_native_parser_and_collation_bit_identical_to_jax():
    """``parse_gdb9_records`` and ``collate_dense_native`` give the JAX
    package's arrays bit for bit (a bad record included); the library comes
    from the package's own build directory and ``native/`` is untouched."""
    from bio_diffusion_tpu.data import native_loader as jax_native

    before = _native_tree()
    rng = np.random.default_rng(0)
    records = [_record(rng, int(rng.integers(3, 29))) for _ in range(24)] + [b"3\ngdb 1 x\nbroken\n"]
    got, want = port_native.parse_gdb9_records(records), jax_native.parse_gdb9_records(records)
    assert sorted(got) == sorted(want) and got["num_atoms"][-1] == -1 and (got["num_atoms"][:-1] > 0).all()
    assert all(_bits_equal(got[k], want[k]) for k in want)

    m, n_src = 12, 14
    species = np.array([1, 6, 7, 8, 9], np.int64)
    charges = np.zeros((m, n_src), np.int64)
    positions = np.zeros((m, n_src, 3))
    for i in range(m):
        n = rng.integers(3, n_src + 1)
        charges[i, :n] = rng.choice(species, n)
        positions[i, :n] = rng.normal(size=(n, 3))
    sel = rng.permutation(m)[:5].astype(np.int64)
    for n_pad in (10, 14, 16):  # truncating, exact and padding
        got = port_native.collate_dense_native(positions, charges, sel, n_pad, species)
        want = jax_native.collate_dense_native(positions, charges, sel, n_pad, species)
        assert all(_bits_equal(g, w) for g, w in zip(got, want))
    for mod in (port_native, jax_native):  # a layout that would need a whole copy: the caller's numpy path
        assert mod.collate_dense_native(positions.astype(np.float32), charges, sel, 16, species) is None

    lib_path = port_native.load_native()._name
    assert os.path.dirname(lib_path) == str(build.BUILD_DIR) and os.path.basename(lib_path).startswith("libxyz_parser-")
    assert port_native.native_available()
    assert _native_tree() == before


def test_failed_host_compile_raises(tmp_path):
    bad = tmp_path / "broken.cc"
    bad.write_text('extern "C" int f() { return undeclared; }\n')
    with pytest.raises(RuntimeError, match="g\\+\\+ failed on .*broken.cc") as err:
        build.compile_host_source(bad, build_dir=tmp_path / "build")
    assert "undeclared" in str(err.value)
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("kind", ["qm9_layout", "conditioned_buckets"])
def test_iterate_dense_batches_native_equals_numpy_and_jax(kind, tmp_path, monkeypatch):
    """The Trainer's batches through the native collation equal the numpy
    collation's and the JAX package's, bit for bit, context included: the
    QM9-layout files of the user path (padded to the dataset's N), and
    synthetic data in buckets with a property context."""
    from bio_diffusion_torch.data.synthetic import synthetic_qm9_like, write_qm9_layout
    from bio_diffusion_tpu.data.batch import DenseDataset as JaxDataset
    from bio_diffusion_tpu.data.batch import iterate_dense_batches as jax_iterate

    if kind == "qm9_layout":
        from bio_diffusion_torch.data.qm9 import load_qm9_datasets

        write_qm9_layout(str(tmp_path), (48, 8, 8))
        ds = load_qm9_datasets(str(tmp_path))["train"]
        kw = dict(pad_to=ds.data["positions"].shape[1])
    else:
        ds = synthetic_qm9_like(40, seed=3)
        kw = dict(bucket_sizes=[12, 20, 29], conditioning=("alpha", "mu"),
                  property_norms={"alpha": {"mean": 70.0, "mad": 5.0}, "mu": {"mean": 2.5, "mad": 1.0}})
    assert ds.data["positions"].dtype == np.float64 and ds.data["charges"].dtype == np.int64
    jax_ds = JaxDataset(ds.data, ds.included_species)
    calls = []
    orig = port_native.collate_dense_native
    monkeypatch.setattr(port_native, "collate_dense_native", lambda *a: calls.append(a[2]) or orig(*a))
    native = list(port_batch.iterate_dense_batches(ds, 8, rng=np.random.default_rng(1), drop_last=False, **kw))
    monkeypatch.setattr(port_native, "native_available", lambda: False)  # the numpy collation
    plain = list(port_batch.iterate_dense_batches(ds, 8, rng=np.random.default_rng(1), drop_last=False, **kw))
    jax = list(jax_iterate(jax_ds, 8, rng=np.random.default_rng(1), drop_last=False, **kw))
    assert len(calls) == len(native) == len(plain) == len(jax) > 3
    fields = ("x", "one_hot", "charges", "node_mask", "context")
    for a, b, c in zip(native, plain, jax):
        for f in fields:
            if getattr(c, f) is None:
                assert getattr(a, f) is None and getattr(b, f) is None
                continue
            assert _bits_equal(getattr(a, f), getattr(b, f)) and _bits_equal(getattr(a, f), np.asarray(getattr(c, f)))
    assert (native[0].context is not None) == (kind == "conditioned_buckets")


def test_hparam_search_runs_tiny_cpu_trials(tmp_path):
    """Two random trials of the tiny CPU train line, one step each: the
    study holds 2 complete trials with finite values and a best trial."""
    from bio_diffusion_torch.cli import hparam_search

    space = tmp_path / "space.json"
    space.write_text(json.dumps({"model.optimizer.lr": "choice(0.001, 0.0001)"}))
    out = tmp_path / "search"
    study = hparam_search.main([
        str(space), str(out), "--n-trials", "2", "--metric", "train/loss", "--sampler", "random",
        "--max-steps", "1", "--device", "cpu", "--",
        *TINY_OVERRIDES, "datamodule.dataloader_cfg.batch_size=8", "model.diffusion_cfg.sample_during_training=false",
        "extras.print_config=false",
    ])
    saved = json.loads((out / "study.json").read_text())
    done = [t for t in saved["trials"] if t.get("value") is not None]
    assert len(done) == 2 and all(np.isfinite(t["value"]) for t in done)
    assert json.loads((out / "best_trial.json").read_text()) == study.best_trial()
    assert all((out / f"trial_{i:04d}" / "metrics.csv").exists() for i in range(2))


def test_bench_shape_sweep_tiny_cpu(capsys):
    from bio_diffusion_torch.cli import bench_shape_sweep

    result = bench_shape_sweep.main(["--device", "cpu", "--cross", "--steps", "2", "--batches", "2", "3", "4",
                                     "--nodes", "5", "6", *TINY_MODEL])
    assert [(r["batch"], r["nodes"]) for r in result["rows"]] == [(2, 6), (3, 6), (4, 6), (4, 5)]
    assert all(r["launches"] == 0 and r["evals_per_s"] > 0 for r in result["rows"])  # no kernel on the CPU
    assert result["fit_batch"] == 4 and result["n_exponent"] is not None and result["steps"] == 2
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == result


def test_bench_train_step_tiny_cpu():
    """``module`` and ``plain`` from the same weights and draws give the same
    step-1 loss; the ``kernel`` path and ``--remat`` / ``--donate`` refuse."""
    from bio_diffusion_torch.cli import bench_train_step

    args = ["--device", "cpu", "--batch", "3", "--nodes", "6", "--layers", "2", "--precision", "fp32",
            "--steps", "1", *TINY_MODEL]
    with pytest.raises(SystemExit, match="kernel path needs a CUDA device"):
        bench_train_step.main(args)
    for flag in ("--remat", "--donate"):
        with pytest.raises(SystemExit, match=f"{flag} has no meaning"):
            bench_train_step.main(args + [flag])
    out = bench_train_step.main(args + ["--paths", "module,plain", "--split"])
    module, plain = out["paths"]["module"], out["paths"]["plain"]
    assert np.isfinite(module["loss_step1"]) and plain["loss_step1"] == pytest.approx(module["loss_step1"], rel=1e-5)
    assert all(r["launches"] == {"message_layer": 0, "message_layer_bwd": 0} for r in out["paths"].values())
    split = out["split"]
    assert split["path"] == "plain" and split["flops_fwd_bwd"] > 2 * split["flops_fwd"] > 0
    assert split["step_ms"] == pytest.approx(plain["ms_per_step"]) and out["layers"] == 2


def test_first_contact_tiny_checkpoint_against_jax(tmp_path, monkeypatch):
    """One tiny reference-layout ``.ckpt`` loaded by both packages: equal
    import leaf counts; the JAX script, its sampler stubbed with the port's
    molecules, reports the same checks, metrics and verdict with the same
    tolerances (the port adds the target and tolerance to a check it cannot
    compute); the exit code follows the verdict."""
    import jax

    from bio_diffusion_torch.cli import first_contact
    from bio_diffusion_torch.config.build import build_evd, build_experiment
    from bio_diffusion_torch.config.loader import default_config_dir, load_config
    from bio_diffusion_torch.train.checkpoints import reference_state_dict
    from bio_diffusion_torch.train.torch_import import init_random_weights
    from bio_diffusion_tpu.cli import common as jax_common
    from bio_diffusion_tpu.train import sampling as jax_sampling

    exp = build_experiment(load_config(default_config_dir(), "mol_gen_eval", TINY_OVERRIDES))
    evd = build_evd(exp)
    init_random_weights(evd, 5)
    ckpt = tmp_path / "tiny-EMA.ckpt"
    torch.save({"state_dict": reference_state_dict(evd), "epoch": 0}, str(ckpt))

    sampled = []
    port_sample = first_contact.sample_molecules
    monkeypatch.setattr(first_contact, "sample_molecules", lambda *a, **k: sampled.append(port_sample(*a, **k))
                        or sampled[-1])
    args = ["--ckpt", str(ckpt), "--num-samples", "5", "--num-timesteps", "3", "--batch", "5"]
    rc = first_contact.main(args + ["--device", "cpu", "--out", str(tmp_path / "port.json")] + TINY_OVERRIDES)
    port = json.loads((tmp_path / "port.json").read_text())

    # the JAX script: its strict import into a zeros template (no eager flax
    # init), the port's molecules in place of its sampler
    init_params = jax_common.init_params
    monkeypatch.setattr(jax_common, "init_params", lambda e, m: jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(lambda: init_params(e, m))))
    monkeypatch.setattr(jax_sampling, "SegmentedSampler", lambda evd, params: None)
    monkeypatch.setattr(jax_sampling, "sample_molecules", lambda *a, **k: sampled[0])
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import first_contact as jax_first_contact
    finally:
        sys.path.pop(0)
    monkeypatch.setattr("bio_diffusion_tpu.utils.compilation_cache.enable_compilation_cache", lambda: None)
    jax_rc = jax_first_contact.main(args + ["--out", str(tmp_path / "jax.json")] + TINY_OVERRIDES)
    want = json.loads((tmp_path / "jax.json").read_text())

    assert set(port) == set(want) and set(port["checks"]) == set(want["checks"])
    assert port["checks"]["import"] == want["checks"]["import"] == {"ok": True, "leaves": 110}
    assert port["metrics"] == want["metrics"] and port["pass"] is want["pass"] is False and rc == jax_rc == 1
    for name, check in want["checks"].items():
        if check.get("ok") is None and name in first_contact.TARGETS:
            assert port["checks"][name] == dict(check, target=first_contact.TARGETS[name],
                                                tolerance=round(first_contact.tolerance(first_contact.TARGETS[name],
                                                                                        5), 4))
        else:
            assert port["checks"][name] == check
    assert first_contact.TARGETS == jax_first_contact.TARGETS
    for target in first_contact.TARGETS.values():
        for n in (1, 16, 250, 10000):
            assert first_contact.tolerance(target, n) == jax_first_contact.tolerance(target, n)

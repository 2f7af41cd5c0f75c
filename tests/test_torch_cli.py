"""The port's user path on the CPU at a tiny width: QM9 files on disk ->
``cli.train`` (and its resume) -> ``cli.mol_gen_sample`` / ``cli.mol_gen_eval``
and ``cli.serve`` from the checkpoint directory.

* ``cli.train.main`` trains on QM9-layout files, writes a checkpoint, and a
  second run on the same workdir resumes at the saved step.
* ``cli.mol_gen_sample.main`` draws the same molecule sizes as the JAX
  package's ``sample_molecules`` for the same seed, writes one xyz file per
  molecule and returns the JAX package's metric keys; ``save_xyz_files``
  writes byte-identical files to the JAX package's on the same arrays; every
  mode of the JAX CLI is ported, and a mode neither package has raises.
* ``cli.mol_gen_eval.main`` writes ``eval_results.json`` with the JAX
  package's keys and ``num_test_passes`` finite NLLs.
* Trainer behaviour as the JAX package's tests have it: early stopping after
  ``patience`` checks, the halt file, the sampling evaluation's ``val/``
  metrics and xyz files.
* ``--help`` prints each entry point's docstring and default config.
* The CLIs refuse ``device=cuda`` without a card; importing them loads
  nothing of jax or of the JAX package.
"""

import csv
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_common import TINY_OVERRIDES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_QM9 = [o for o in TINY_OVERRIDES if "dataset=" not in o] + ["datamodule.dataloader_cfg.batch_size=8"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """QM9-layout files and a workdir trained on them for 2 steps, then
    resumed for 2 more -> (data_dir, workdir, first trainer, resumed trainer)."""
    from bio_diffusion_torch.cli.train import main
    from bio_diffusion_torch.data.synthetic import write_qm9_layout

    root = tmp_path_factory.mktemp("user_path")
    data_dir = str(root / "data")
    write_qm9_layout(data_dir, counts=(32, 8, 8), seed=1)
    workdir = str(root / "train")
    args = ["experiment=qm9_mol_gen_ddpm"] + TINY_QM9 + [
        "datamodule.dataloader_cfg.dataset=QM9", f"datamodule.dataloader_cfg.data_dir={data_dir}",
        "model.diffusion_cfg.sample_during_training=false", "trainer.check_val_every_n_epoch=1",
        "trainer.limit_train_batches=2", "--device=cpu", "--max-epochs=1", f"--workdir={workdir}"]
    first = main(args)
    resumed = main(args)
    return data_dir, workdir, first, resumed


def test_train_on_qm9_files_then_resume(run):
    _, workdir, first, resumed = run
    assert first.state.count == 2 and first.stats["micro_batches"] == 2 and first.stats["eval_batches"] == 1
    assert sorted(os.listdir(os.path.join(workdir, "checkpoints"))) == ["step_2.pt", "step_4.pt"]
    assert resumed.start_step == 2 and resumed.state.count == 4 and resumed.stats["steps"] == 2
    with open(os.path.join(workdir, "metrics.csv")) as f:
        steps = [int(r["step"]) for r in csv.DictReader(f) if r["train/loss"]]
    assert steps == [4]  # the second run's log (each run writes its own)


def sample_args(workdir, out_dir, *extra):
    return TINY_QM9 + [f"ckpt_path={os.path.join(workdir, 'checkpoints')}", "device=cpu",
                       f"output_dir={out_dir}", *extra]


def xyz_files(out_dir):
    return sorted(os.path.join(root, f) for root, _, fs in os.walk(out_dir) for f in fs if f.endswith(".xyz"))


def test_mol_gen_sample_matches_jax_sizes(run, tmp_path):
    import jax

    from bio_diffusion_tpu.cli.common import nodes_distribution_for as jax_nodes_distribution_for
    from bio_diffusion_tpu.config.build import build_experiment as jax_build_experiment
    from bio_diffusion_tpu.config.loader import default_config_dir, load_config
    from bio_diffusion_tpu.data.dataset_info import get_dataset_info
    from bio_diffusion_tpu.train.sampling import analyze_samples as jax_analyze
    from bio_diffusion_tpu.train.sampling import sample_molecules as jax_sample_molecules
    from bio_diffusion_torch.cli.mol_gen_sample import main

    _, workdir, _, _ = run
    out_dir = str(tmp_path / "samples")
    metrics = main(sample_args(workdir, out_dir, "num_samples=5"))
    files = xyz_files(out_dir)
    assert len(files) == 5
    sizes = [int(open(f).readline()) for f in files]

    class ShapeOnly:  # the JAX package's batching without its reverse loop
        def run(self, key, node_mask, num_timesteps=None, context=None):
            return np.zeros(node_mask.shape + (9,), np.float32)

    jexp = jax_build_experiment(load_config(default_config_dir(), "mol_gen_sample", TINY_QM9))
    _, _, jax_sizes = jax_sample_molecules(ShapeOnly(), jax.random.PRNGKey(0), 5,
                                           jax_nodes_distribution_for(jexp),
                                           np.random.default_rng(jexp.seed), batch_size=5)
    assert sizes == list(jax_sizes)
    xh = np.zeros((2, 4, 9), np.float32)
    xh[..., 3] = 1
    assert set(metrics) == set(jax_analyze(xh, np.ones((2, 4), np.float32), get_dataset_info("QM9")))


@pytest.mark.parametrize("kw", [dict(batch_size=4), dict(batch_size=4, pad_to=29),
                                dict(batch_size=3, sort_sizes=False), dict(batch_size=5, pad_to_multiple=1)])
def test_sample_molecules_batching_matches_jax(kw):
    """Sizes, padding and batch order of ``sample_molecules`` against the JAX
    package's for the same numpy draws (shape-only samplers)."""
    import jax

    from bio_diffusion_tpu.models.distributions import NumNodesDistribution as JaxNodes
    from bio_diffusion_tpu.train.sampling import sample_molecules as jax_sample_molecules
    from bio_diffusion_torch.data.dataset_info import get_dataset_info
    from bio_diffusion_torch.models.distributions import NumNodesDistribution
    from bio_diffusion_torch.train.sampling import sample_molecules

    class Ours:
        def run(self, node_mask, generator, num_timesteps=None, context=None):
            return np.repeat(node_mask[..., None], 9, axis=-1)

    class Ref:
        def run(self, key, node_mask, num_timesteps=None, context=None):
            return np.repeat(np.asarray(node_mask)[..., None], 9, axis=-1)

    hist = {int(k): int(v) for k, v in get_dataset_info("QM9")["n_nodes"].items()}
    ours = sample_molecules(Ours(), None, 10, NumNodesDistribution(hist), np.random.default_rng(7), **kw)
    ref = jax_sample_molecules(Ref(), jax.random.PRNGKey(0), 10, JaxNodes(hist), np.random.default_rng(7), **kw)
    for a, b in zip(ours, ref):
        assert a.shape == b.shape and np.array_equal(a, b)


def test_mol_gen_sample_fixed_size(run, tmp_path):
    from bio_diffusion_torch.cli.mol_gen_sample import main

    _, workdir, _, _ = run
    main(sample_args(workdir, str(tmp_path), "num_samples=3", "num_nodes=6"))
    assert [int(open(f).readline()) for f in xyz_files(tmp_path)] == [6, 6, 6]


def test_xyz_files_byte_identical_to_jax(tmp_path):
    from bio_diffusion_tpu.chem.molecule import load_molecule_xyz as jax_load_xyz
    from bio_diffusion_tpu.chem.molecule import save_xyz_files as jax_save_xyz
    from bio_diffusion_torch.chem.molecule import load_molecule_xyz, save_xyz_files
    from bio_diffusion_torch.data.dataset_info import get_dataset_info

    rng = np.random.default_rng(2)
    info = get_dataset_info("QM9")
    x = rng.normal(size=(3, 7, 3)).astype(np.float32) * 3
    one_hot = np.eye(5, dtype=np.float32)[rng.integers(0, 5, size=(3, 7))]
    mask = (np.arange(7)[None] < np.array([7, 5, 2])[:, None]).astype(np.float32)
    ours = save_xyz_files(str(tmp_path / "port"), x, one_hot, mask, info, id_from=3)
    ref = jax_save_xyz(str(tmp_path / "jax"), x, one_hot, mask, info, id_from=3)
    assert [os.path.basename(f) for f in ours] == [os.path.basename(f) for f in ref]
    for a, b in zip(ours, ref):
        assert open(a, "rb").read() == open(b, "rb").read()
        for u, v in zip(load_molecule_xyz(a, info), jax_load_xyz(b, info)):
            assert np.array_equal(u, v)


@pytest.mark.parametrize("mode", ["chain"])
def test_mol_gen_sample_unported_modes_raise(mode, tmp_path):
    """Every mode of the JAX CLI is ported (``chain`` last; it runs in
    ``test_torch_visualization.py``): a mode that neither package has raises."""
    from bio_diffusion_torch.cli.mol_gen_sample import MODES, main

    assert mode in MODES
    with pytest.raises(ValueError, match="unknown ddpm_mode"):
        main(TINY_QM9 + [f"ddpm_mode={mode}_gif", "device=cpu", f"output_dir={tmp_path}"])


@pytest.mark.parametrize("fast_nll", [False, True])
def test_mol_gen_eval_writes_results(run, tmp_path, fast_nll):
    from bio_diffusion_torch.cli.mol_gen_eval import main

    data_dir, workdir, _, _ = run
    out_dir = str(tmp_path / "eval")
    metrics = main(sample_args(workdir, out_dir, "num_samples=4", "sampling_batch_size=4", "num_test_passes=2",
                               "save_molecules=true", f"datamodule.dataloader_cfg.data_dir={data_dir}",
                               f"fast_nll={str(fast_nll).lower()}"))
    with open(os.path.join(out_dir, "eval_results.json")) as f:
        saved = json.load(f)
    # the JAX package's keys without RDKit
    assert set(saved) == {"mol_stable", "atm_stable", "kl_div_atom_types", "test_nll", "test_nll_passes"}
    assert saved == metrics and len(saved["test_nll_passes"]) == 2
    assert np.isfinite(saved["test_nll_passes"]).all() and saved["test_nll"] == np.mean(saved["test_nll_passes"])
    assert len(xyz_files(os.path.join(out_dir, "molecules"))) == 4


def test_serve_from_checkpoint_dir(run):
    from bio_diffusion_torch.cli.serve import build_server
    from bio_diffusion_torch.config.loader import default_config_dir, load_config

    _, workdir, _, resumed = run
    cfg = load_config(default_config_dir(), "serve", TINY_OVERRIDES + [
        f"ckpt_path={os.path.join(workdir, 'checkpoints')}", "device=cpu", "precision=fp32",
        "serving_batch_size=2", "buckets=[6]", "max_wait_ms=50"])
    server = build_server(cfg)
    try:
        assert all(torch.equal(a, b) for a, b in zip(server.sampler.evd.parameters(),
                                                     resumed.evd_ema.parameters()))
        out = server.generate(2, num_nodes=5, num_timesteps=3, seed=0)
        assert out["num_molecules"] == 2
    finally:
        server.close()


TRAIN_SYNTH = ["experiment=qm9_mol_gen_ddpm"] + TINY_OVERRIDES + [
    "datamodule.dataloader_cfg.batch_size=16", "trainer.limit_train_batches=2", "trainer.limit_val_batches=1",
    "--device=cpu"]


def metrics_rows(workdir):
    with open(os.path.join(workdir, "metrics.csv")) as f:
        return list(csv.DictReader(f))


def test_early_stopping_patience(tmp_path):
    """lr=0: the monitored val loss never improves, so training stops after
    ``patience`` checks (tests/test_train_features.py::test_early_stopping_patience)."""
    from bio_diffusion_torch.cli.train import main

    trainer = main(TRAIN_SYNTH + [
        "model.diffusion_cfg.sample_during_training=false", "model.optimizer.lr=0.0", "trainer.min_epochs=0",
        "trainer.check_val_every_n_epoch=1", "trainer.early_stopping_monitor=val/loss",
        "trainer.early_stopping_patience=2", f"--workdir={tmp_path}", "--max-epochs=50"])
    epochs = [int(r["epoch"]) for r in metrics_rows(tmp_path) if r["epoch"] not in (None, "")]
    assert max(epochs) == 2 and trainer.state.count == 6


def test_halt_file_and_loggers(tmp_path, monkeypatch):
    """tests/test_cli.py::test_train_with_halt_file; the ``logger`` group's
    JSONL backend beside the CSV log, and a service backend whose package is
    missing built disabled (it logs and finishes as a no-op)."""
    from bio_diffusion_torch.cli.train import main
    from bio_diffusion_torch.utils.logging import build_loggers

    grid_dir = tmp_path / "grid"
    trainer = main(TRAIN_SYNTH + ["model.diffusion_cfg.sample_during_training=false", "logger=jsonl",
                                  f"paths.grid_search_script_dir={grid_dir}", "task_name=gridrun",
                                  f"--workdir={tmp_path / 'run'}", "--max-epochs=1"])
    assert (grid_dir / "gridrun.done").read_text() == "`on_fit_end` has been called."
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    csv_rows = trainer.loggers.loggers[0].rows
    assert len(rows) == len(csv_rows) == 1 and rows[0]["step"] == 2 and "train/loss" in rows[0]
    assert [{k: v for k, v in r.items() if k != "time"} for r in rows] == \
        [{k: v for k, v in r.items() if k != "time"} for r in csv_rows]
    monkeypatch.setitem(sys.modules, "wandb", None)
    loggers = build_loggers({"wandb": {}}, str(tmp_path))
    assert [type(lg).__name__ for lg in loggers.loggers] == ["CSVLogger", "WandbLogger"]
    assert loggers.loggers[1].run is None
    loggers.log({"train/loss": 1.0}, step=1)
    loggers.finish()


def test_sampling_eval_logs_val_metrics(tmp_path):
    """tests/test_train_features.py::test_in_training_sampling_eval_and_viz
    (xyz files only: PNG rendering is not ported)."""
    from bio_diffusion_torch.cli.train import main

    trainer = main(TRAIN_SYNTH + [
        "model.diffusion_cfg.sample_during_training=true", "model.diffusion_cfg.eval_epochs=1",
        "trainer.check_val_every_n_epoch=1", "model.diffusion_cfg.num_eval_samples=4",
        "model.diffusion_cfg.eval_batch_size=4", "model.diffusion_cfg.visualize_sample_epochs=1",
        "model.diffusion_cfg.num_visualization_samples=1", "trainer.early_stopping_monitor=",
        f"--workdir={tmp_path}", "--max-epochs=1"])
    stab = [r for r in metrics_rows(tmp_path) if r.get("val/mol_stable")]
    assert stab and 0.0 <= float(stab[-1]["val/mol_stable"]) <= 1.0
    assert {"val/atm_stable", "val/kl_div_atom_types"} <= set(stab[-1])
    assert trainer.stats["sample_batches"] == 1
    assert len(xyz_files(tmp_path / "media" / "epoch_0")) == 1


@pytest.mark.parametrize("preset,steps,eval_batches,checkpoints", [
    ("fdr", 1, 1, False),  # fast_dev_run: 1 train + 1 val batch, no checkpoint
    ("overfit", 6, 0, True),  # overfit_batches=3: the same 3 batches each epoch
])
def test_debug_presets(tmp_path, preset, steps, eval_batches, checkpoints):
    """configs/debug/{fdr,overfit}.yaml (tests/test_debug_presets.py)."""
    from bio_diffusion_torch.cli.train import main

    trainer = main([a for a in TRAIN_SYNTH if "limit_" not in a] + [
        f"debug={preset}", "model.diffusion_cfg.sample_during_training=false", f"--workdir={tmp_path}",
        "--max-epochs=2"])
    assert (trainer.stats["steps"], trainer.stats["eval_batches"]) == (steps, eval_batches)
    assert os.path.isdir(trainer.ckpt_dir) == checkpoints
    if preset == "overfit":
        assert len(trainer._overfit_cache) == 3


@pytest.mark.parametrize("cli", ["train", "mol_gen_sample", "mol_gen_eval", "serve"])
def test_cli_help_prints_its_usage(cli, capsys):
    """``--help`` prints the entry point's own docstring, then its default config."""
    import importlib

    module = importlib.import_module(f"bio_diffusion_torch.cli.{cli}")
    with pytest.raises(SystemExit) as exit_info:
        module.main(["--help"])
    out = capsys.readouterr().out
    assert exit_info.value.code == 0
    assert out.startswith(module.__doc__.strip()) and f"Default config ({cli}.yaml" in out


@pytest.mark.parametrize("cli", ["mol_gen_sample", "mol_gen_eval"])
def test_cli_refuses_cuda_without_a_card(cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import importlib

    main = importlib.import_module(f"bio_diffusion_torch.cli.{cli}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(TINY_QM9 + ["num_samples=1"])


def test_user_path_imports_no_jax():
    code = (
        "import sys\n"
        "import bio_diffusion_torch.cli.mol_gen_sample, bio_diffusion_torch.cli.mol_gen_eval\n"
        "import bio_diffusion_torch.cli.common, bio_diffusion_torch.cli.train, bio_diffusion_torch.cli.serve\n"
        "import bio_diffusion_torch.data.qm9, bio_diffusion_torch.train.checkpoints\n"
        "import bio_diffusion_torch.chem.molecule, bio_diffusion_torch.chem.rdkit_bridge\n"
        "import bio_diffusion_torch.utils.logging\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'bio_diffusion_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

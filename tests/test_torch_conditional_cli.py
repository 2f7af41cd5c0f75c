"""The port's property-conditioning user path on the CPU at a tiny width:
QM9-layout files -> ``cli.train experiment=qm9_mol_gen_conditional_ddpm``
-> ``cli.train_classifier`` -> ``cli.mol_gen_eval_conditional_qm9`` ->
``cli.mol_gen_eval_optimization_qm9``.

* The conditional Trainer normalizes with the valid split of
  ``QM9_second_half``, feeds contexts to every batch, checkpoints, and its
  checkpoint restores with the wider embedding through ``load_model``.
* ``train_classifier`` trains on ``QM9_first_half`` and writes the
  ``classifier.npz`` / ``classifier.json`` layout and ``history.json``.
* The conditional evaluation writes ``conditional_eval_<prop>.json``; its
  drawn sizes and contexts are those of the JAX package's CLI for the same
  seed (the JAX CLI runs with its model loading and sampler replaced by a
  recorder).
* ``task=qualitative`` (or ``sweep_property_values=true``) writes the
  property sweep's xyz files and GIF, as the JAX CLI's test counts them.
* ``sample_molecules`` with a ``PropertiesDistribution`` draws the JAX
  package's sizes and contexts in the JAX package's order.
* The optimization CLI generates the starting molecules
  (``generate_molecules_only``), runs the round trips with the JAX
  package's contexts and writes ``optimization_eval_<prop>.json``; it also
  starts from pregenerated xyz files.
* Both evaluation CLIs raise on a ``classifier_model_dir`` that is not a
  directory.
"""

import json
import os

import numpy as np
import pytest
import torch

from test_torch_common import TINY_OVERRIDES

TINY = [o for o in TINY_OVERRIDES if "dataset=" not in o]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """QM9-layout files, a conditional model trained on them for 2 steps
    (with a sampling evaluation of 4 molecules) and a classifier trained
    for 2 epochs -> (root, data_dir, trainer, classifier result)."""
    from bio_diffusion_torch.cli import train, train_classifier
    from bio_diffusion_torch.data.synthetic import write_qm9_layout

    root = tmp_path_factory.mktemp("conditional")
    data_dir = str(root / "data")
    write_qm9_layout(data_dir, counts=(400, 48, 48), seed=1)
    data = [f"datamodule.dataloader_cfg.data_dir={data_dir}"]
    trainer = train.main(["experiment=qm9_mol_gen_conditional_ddpm", *TINY, *data,
                          "datamodule.dataloader_cfg.batch_size=8", "trainer.limit_train_batches=2",
                          "trainer.limit_val_batches=1", "model.diffusion_cfg.sample_during_training=true",
                          "model.diffusion_cfg.eval_epochs=1", "model.diffusion_cfg.num_eval_samples=4",
                          "model.diffusion_cfg.eval_batch_size=4", "--device=cpu", "--max-epochs=1",
                          f"--workdir={root / 'train'}"])
    cls = train_classifier.main(["property=alpha", *data, "hidden_nf=16", "n_layers=2", "epochs=2", "batch_size=16",
                                 "device=cpu", f"output_dir={root / 'classifier'}"])
    return root, data_dir, trainer, cls


def test_conditional_trainer(run):
    from bio_diffusion_torch.cli.common import load_model
    from bio_diffusion_torch.models.distributions import compute_mean_mad

    _, _, trainer, _ = run
    assert trainer.exp.dataloader_cfg.dataset == "QM9_second_half"
    assert not trainer.exp.dataloader_cfg.include_charges and trainer.conditioning == ("alpha",)
    assert trainer.props_norms == {"alpha": compute_mean_mad(trainer.datasets["valid"].property_values("alpha"))}
    assert trainer.stats == {"steps": 2, "micro_batches": 2, "eval_batches": 1, "sample_batches": 1}
    batch = next(trainer._batch_iter("train"))
    norms = trainer.props_norms["alpha"]
    assert batch.context.shape == batch.node_mask.shape + (1,)
    assert np.all(batch.context[batch.node_mask == 0] == 0)
    real = batch.context[..., 0][batch.node_mask > 0]
    assert np.all(np.isfinite(real)) and np.abs(real * norms["mad"] + norms["mean"]).max() > 1
    val = [r for r in trainer.loggers.loggers[0].rows if "val/mol_stable" in r]
    assert val and np.isfinite(val[-1]["val/kl_div_atom_types"])
    # the checkpoint restores into the conditional model (wider embedding)
    evd = load_model(trainer.exp, trainer.ckpt_dir, "cpu")
    for (name, p), q in zip(evd.named_parameters(), trainer.evd_ema.parameters()):
        assert torch.equal(p, q), name


def test_train_classifier_cli(run):
    root, _, _, cls = run
    out = cls["model_dir"]
    assert out == str(root / "classifier" / "alpha")
    assert sorted(os.listdir(out)) == ["classifier.json", "classifier.npz", "history.json"]
    with open(os.path.join(out, "classifier.json")) as f:
        meta = json.load(f)
    assert meta["dataset"] == "QM9_first_half" and meta["property"] == "alpha" and meta["hidden_nf"] == 16
    with open(os.path.join(out, "history.json")) as f:
        history = json.load(f)
    assert len(history["train_loss"]) == len(history["valid_mae"]) == 2
    assert cls["best_valid_mae"] == min(history["valid_mae"])


def record_port_runs(monkeypatch):
    from bio_diffusion_torch.train.sampling import SegmentedSampler

    calls, orig = [], SegmentedSampler.run

    def run(self, node_mask, generator, num_timesteps=None, fix_noise=False, context=None, noises=None):
        calls.append((np.array(node_mask), None if context is None else np.array(context)))
        return orig(self, node_mask, generator, num_timesteps, fix_noise, context, noises)

    monkeypatch.setattr(SegmentedSampler, "run", run)
    return calls


def test_conditional_eval_cli_draws_match_jax(run, tmp_path, monkeypatch):
    from bio_diffusion_torch.cli import mol_gen_eval_conditional_qm9 as cli
    from bio_diffusion_tpu.cli import mol_gen_eval_conditional_qm9 as jax_cli

    root, data_dir, trainer, cls = run
    args = [*TINY, f"datamodule.dataloader_cfg.data_dir={data_dir}", "iterations=2", "batch_size=5"]
    ours = record_port_runs(monkeypatch)
    result = cli.main(args + [f"generator_model_filepath={trainer.ckpt_dir}",
                              f"classifier_model_dir={cls['model_dir']}", "device=cpu", "save_molecules=true",
                              f"output_dir={tmp_path / 'ours'}"])
    with open(tmp_path / "ours" / "conditional_eval_alpha.json") as f:
        assert json.load(f) == result
    assert len(result["mae_per_iteration"]) == 2 and np.isfinite(result["mae"])
    assert len(os.listdir(tmp_path / "ours" / "molecules" / "iteration_1")) == 5

    theirs = []

    class Recorder:
        def __init__(self, *a, **kw):
            pass

        def run(self, key, node_mask, num_timesteps=None, context=None, fix_noise=False):
            theirs.append((np.asarray(node_mask), np.asarray(context)))
            return np.zeros(node_mask.shape + (8,), np.float32)

    monkeypatch.setattr(jax_cli, "load_model", lambda exp, path: (None, None))
    monkeypatch.setattr(jax_cli, "SegmentedSampler", Recorder)
    jax_cli.main(args + ["use_mesh=false", f"output_dir={tmp_path / 'theirs'}"])
    assert len(ours) == len(theirs) == 2
    for (m, c), (m_j, c_j) in zip(ours, theirs):
        np.testing.assert_array_equal(m, m_j)
        assert c.shape == m.shape + (1,)
        np.testing.assert_array_equal(c, c_j)
    # the sizes were drawn up front and sorted, each batch padded to its bucket
    sizes = np.concatenate([m.sum(1) for m, _ in ours])
    assert list(sizes) == sorted(sizes, reverse=True)


@pytest.mark.parametrize("switch", ["task=qualitative", "sweep_property_values=true"])
def test_conditional_sweep_cli(run, tmp_path, monkeypatch, switch):
    """JAX ``test_eval_clis.py::test_conditional_sweep_mode``'s case: one
    sweep of 4 frames writes 4 xyz files and a GIF and returns the same
    dict; the sweep's contexts are JAX's linspace over the property's range
    at 19 atoms, and its molecules share one noise draw."""
    from bio_diffusion_torch.cli import mol_gen_eval_conditional_qm9 as cli

    root, data_dir, trainer, _ = run
    ours = record_port_runs(monkeypatch)
    res = cli.main([*TINY, f"datamodule.dataloader_cfg.data_dir={data_dir}", switch, "num_sweeps=1",
                    "sweep_n_frames=4", f"generator_model_filepath={trainer.ckpt_dir}", "device=cpu",
                    f"output_dir={tmp_path}"])
    assert res == {"property": "alpha", "sweeps": 1}
    files = [f for _, _, fs in os.walk(tmp_path) for f in fs]
    assert len([f for f in files if f.startswith("conditional_") and f.endswith(".xyz")]) == 4
    assert len([f for f in files if f.endswith(".gif")]) == 1
    assert os.path.isdir(tmp_path / "alpha" / "sweep_0")
    (mask, context), = ours
    assert mask.shape == (4, 19) and mask.all()
    lo, hi = trainer.props_distr.distributions["alpha"][19]["params"]
    norms = trainer.props_norms["alpha"]
    np.testing.assert_allclose(context[:, 0, 0], (np.linspace(lo, hi, 4) - norms["mean"]) / norms["mad"],
                               rtol=1e-6)


def test_sample_molecules_contexts_match_jax():
    import jax

    from bio_diffusion_tpu.models.distributions import NumNodesDistribution as JaxNodes
    from bio_diffusion_tpu.models.distributions import PropertiesDistribution as JaxProps
    from bio_diffusion_tpu.train.sampling import sample_molecules as jax_sample_molecules
    from bio_diffusion_torch.data.synthetic import synthetic_qm9_like
    from bio_diffusion_torch.models.distributions import NumNodesDistribution, PropertiesDistribution
    from bio_diffusion_torch.train.sampling import sample_molecules

    ds = synthetic_qm9_like(300, seed=2)
    hist = {int(n): int(c) for n, c in zip(*np.unique(ds.data["num_atoms"], return_counts=True))}
    norms = {"alpha": {"mean": 10.0, "mad": 4.0}}
    props = {"alpha": ds.property_values("alpha")}
    ours, theirs = [], []

    class Ours:
        def run(self, node_mask, generator, num_timesteps=None, context=None):
            ours.append(context)
            return np.repeat(node_mask[..., None], 8, axis=-1)

    class Ref:
        def run(self, key, node_mask, num_timesteps=None, context=None):
            theirs.append(np.asarray(context))
            return np.repeat(np.asarray(node_mask)[..., None], 8, axis=-1)

    a = sample_molecules(Ours(), None, 11, NumNodesDistribution(hist), np.random.default_rng(3), batch_size=4,
                         props_distr=PropertiesDistribution(ds.data["num_atoms"], props, normalizer=norms))
    b = jax_sample_molecules(Ref(), jax.random.PRNGKey(0), 11, JaxNodes(hist), np.random.default_rng(3),
                             batch_size=4, props_distr=JaxProps(ds.data["num_atoms"], props, normalizer=norms))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert len(ours) == len(theirs) == 3
    for c, c_j in zip(ours, theirs):
        np.testing.assert_array_equal(c, c_j)


def test_optimization_cli(run, tmp_path, monkeypatch):
    from bio_diffusion_torch.cli import mol_gen_eval_optimization_qm9 as cli
    from bio_diffusion_torch.config.build import build_datasets, build_experiment
    from bio_diffusion_torch.config.loader import default_config_dir, load_config
    from bio_diffusion_torch.models.diffusion import EquivariantVariationalDiffusion
    from bio_diffusion_tpu.models.distributions import PropertiesDistribution as JaxProps
    from bio_diffusion_tpu.models.distributions import compute_mean_mad as jax_mean_mad

    _, data_dir, trainer, cls = run
    args = [*TINY, f"datamodule.dataloader_cfg.data_dir={data_dir}", "num_samples=6", "batch_size=4",
            "num_gen_timesteps=3", "num_optimization_timesteps=4", "iterations=2", "device=cpu"]
    gen_runs = record_port_runs(monkeypatch)
    out = str(tmp_path / "gen")
    assert cli.main(args + ["generate_molecules_only=true", f"output_dir={out}"]) == {"generated": 6}
    assert len(gen_runs) == 2 and [m.shape for m, _ in gen_runs] == [(4, 19), (2, 19)]
    assert len(os.listdir(os.path.join(out, "initial_molecules"))) == 6

    contexts = []
    orig = EquivariantVariationalDiffusion.mol_gen_optimize

    def optimize(self, x, h_cat, node_mask, num_timesteps, context=None, **kw):
        contexts.append(context.numpy().copy())
        assert num_timesteps == 4
        return orig(self, x, h_cat, node_mask, num_timesteps, context, **kw)

    monkeypatch.setattr(EquivariantVariationalDiffusion, "mol_gen_optimize", optimize)
    result = cli.main(args + [f"conditional_generator_model_filepath={trainer.ckpt_dir}",
                              f"classifier_model_dir={cls['model_dir']}", f"output_dir={tmp_path / 'opt'}"])
    with open(tmp_path / "opt" / "optimization_eval_alpha.json") as f:
        assert json.load(f) == result
    assert [e["iteration"] for e in result["history"]] == [1, 2] and result["final"] == result["history"][-1]
    assert all(set(e) == {"iteration", "mol_stable", "atm_stable", "mae"} for e in result["history"])
    # 2 iterations x 2 batches, each with the same fixed contexts: the JAX
    # package's draw (one sample_batch of the 19-atom sizes from the seed)
    assert len(contexts) == 4
    exp = build_experiment(load_config(default_config_dir(), "mol_gen_eval_optimization_qm9", args + [
        "model.module_cfg.conditioning=[alpha]", "datamodule.dataloader_cfg.dataset=QM9_second_half",
        "datamodule.dataloader_cfg.include_charges=false"]))
    ds = build_datasets(exp)
    norms = {"alpha": jax_mean_mad(ds["valid"].property_values("alpha"))}
    ctx = JaxProps(ds["train"].data["num_atoms"], {"alpha": ds["train"].property_values("alpha")},
                   normalizer=norms).sample_batch(np.full(6, 19), np.random.default_rng(exp.seed))
    expected = np.broadcast_to(ctx[:, None, :], (6, 19, 1))
    for it in range(2):
        np.testing.assert_array_equal(np.concatenate(contexts[2 * it: 2 * it + 2]), expected)

    pre = cli.main(args + ["use_pregenerated_molecules=true", f"pregenerated_molecules_dir={out}/initial_molecules",
                           f"conditional_generator_model_filepath={trainer.ckpt_dir}", "iterations=1",
                           f"output_dir={tmp_path / 'pre'}"])
    assert [e["iteration"] for e in pre["history"]] == [1]


EVAL_CLI_ARGS = {
    "mol_gen_eval_conditional_qm9": ["iterations=1", "batch_size=2"],
    "mol_gen_eval_optimization_qm9": ["num_samples=2", "batch_size=2", "num_gen_timesteps=2", "iterations=1"],
}


@pytest.mark.parametrize("cli", sorted(EVAL_CLI_ARGS))
def test_eval_cli_refuses_a_missing_classifier_dir(run, tmp_path, cli):
    """A ``classifier_model_dir`` that is not a directory raises: no MAE is
    reported from a classifier with random weights."""
    import importlib

    module = importlib.import_module(f"bio_diffusion_torch.cli.{cli}")
    _, data_dir, trainer, _ = run
    with pytest.raises(FileNotFoundError, match="classifier_model_dir"):
        module.main([*TINY, f"datamodule.dataloader_cfg.data_dir={data_dir}", *EVAL_CLI_ARGS[cli], "device=cpu",
                     f"generator_model_filepath={trainer.ckpt_dir}",
                     f"conditional_generator_model_filepath={trainer.ckpt_dir}",
                     f"classifier_model_dir={tmp_path / 'missing'}", f"output_dir={tmp_path / 'out'}"])
    assert not any(n.endswith(".json") for _, _, names in os.walk(tmp_path) for n in names)


NEW_CLIS = ["train_classifier", "mol_gen_eval_conditional_qm9", "mol_gen_eval_optimization_qm9"]


@pytest.mark.parametrize("cli", NEW_CLIS)
def test_cli_help_prints_its_usage(cli, capsys):
    """``--help`` prints the entry point's own docstring, then its default config."""
    import importlib

    module = importlib.import_module(f"bio_diffusion_torch.cli.{cli}")
    with pytest.raises(SystemExit) as exit_info:
        module.main(["--help"])
    out = capsys.readouterr().out
    assert exit_info.value.code == 0
    assert out.startswith(module.__doc__.strip()) and f"Default config ({cli}.yaml" in out


@pytest.mark.parametrize("cli", NEW_CLIS)
def test_cli_refuses_cuda_without_a_card(cli):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import importlib

    main = importlib.import_module(f"bio_diffusion_torch.cli.{cli}").main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(TINY + ["datamodule.dataloader_cfg.dataset=synthetic", "epochs=1"])


def test_conditioning_modules_import_no_jax():
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import bio_diffusion_torch.cli.train_classifier, bio_diffusion_torch.cli.mol_gen_eval_conditional_qm9\n"
        "import bio_diffusion_torch.cli.mol_gen_eval_optimization_qm9, bio_diffusion_torch.models.classifier\n"
        "import bio_diffusion_torch.train.classifier_train, bio_diffusion_torch.models.distributions\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'bio_diffusion_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

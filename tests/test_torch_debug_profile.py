"""The port's debug invariants and training profiler, on the CPU at a tiny width.

* ``utils/debug.py`` through ``train/step.py``: the cases of JAX
  ``test_warm_start_debug.py`` (a clean batch passes, a nonzero padded row
  trips the masked-input check, with the switch off the corrupted batch runs
  through, the eval step checks too) plus a corrupted micro-batch under
  gradient accumulation, each given the verdict that the JAX package's own
  loss under ``checkify`` gives on the same batch with the same weights (1
  layer, S=16, T=10), with the same message text.  Disabled checks
  touch nothing.
* ``utils/profiling.py``: ``profile_trace`` writes a Chrome trace, the
  program's spans in it (and is a no-op for None).
* ``cli.train``: ``trainer.detect_anomaly=true``, ``--profile=DIR``,
  ``trainer.profile=true``, ``--dump-graph`` (the denoiser's module tree
  and op sequence with shapes) and ``exec_time.log``.
"""

import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import TINY_OVERRIDES, jax_tiny_configs, tiny_configs

CASES = ["clean_batch_passes", "corrupted_mask_trips", "off_by_default_ignores_corruption", "eval_step",
         "accumulated_micro_batch_trips"]


def one_layer(cfgs, debug):
    mc, mod, lc, dc, dl = cfgs
    return (dataclasses.replace(mc, num_encoder_layers=1), mod, lc,
            dataclasses.replace(dc, debug_invariants=debug), dl)


def corrupt_padding(batch):
    """Garbage in a padded node row of x (JAX test_warm_start_debug's)."""
    x = np.asarray(batch.x).copy()
    bi, ni = np.argwhere(np.asarray(batch.node_mask) == 0)[0]
    x[bi, ni] = 7.7
    return dataclasses.replace(batch, x=x)


@pytest.fixture(scope="module")
def setup():
    """A batch of 8 synthetic molecules padded to 8, the port's weights and
    the JAX package's loss under checkify with the same weights."""
    from jax.experimental import checkify

    from bio_diffusion_tpu.data.batch import DenseMolBatch as JaxBatch
    from bio_diffusion_tpu.models.diffusion import EquivariantVariationalDiffusion as JaxEVD
    from bio_diffusion_tpu.models.gcpnet import GCPNetDynamics as JaxDynamics
    from bio_diffusion_tpu.ops.geometry import centralize as jax_centralize
    from bio_diffusion_tpu.train.step import make_loss_fn as jax_make_loss_fn
    from bio_diffusion_tpu.train.torch_import import import_state_dict
    from bio_diffusion_tpu.utils.debug import user_checks
    from bio_diffusion_torch.data.batch import iterate_dense_batches
    from bio_diffusion_torch.data.synthetic import synthetic_qm9_like
    from bio_diffusion_torch.models.distributions import NumNodesDistribution
    from bio_diffusion_torch.models.diffusion import EquivariantVariationalDiffusion
    from bio_diffusion_torch.models.gcpnet import GCPNetDynamics
    from bio_diffusion_torch.train.torch_import import init_random_weights

    ds = synthetic_qm9_like(num_molecules=8, max_nodes=8, seed=0)
    batch = next(iterate_dense_batches(ds, batch_size=8, rng=np.random.default_rng(0), shuffle=False, pad_to=8))
    assert (batch.node_mask == 0).any()
    hist = {int(n): int(c) for n, c in zip(*np.unique(ds.data["num_atoms"], return_counts=True))}
    table = NumNodesDistribution(hist).log_prob_table

    cfgs = one_layer(tiny_configs(), True)
    evd = EquivariantVariationalDiffusion(GCPNetDynamics(*cfgs), cfgs[3], cfgs[4])
    init_random_weights(evd, 0)
    state_dict = {k: v.clone() for k, v in evd.state_dict().items()}

    jcfgs = one_layer(jax_tiny_configs(), True)
    evd_j = JaxEVD(dynamics=JaxDynamics(*jcfgs, remat_interactions=False), diffusion_cfg=jcfgs[3],
                   dataloader_cfg=jcfgs[4])
    jb = JaxBatch(*(jnp.asarray(a) for a in (batch.x, batch.one_hot, batch.charges, batch.node_mask)))
    key = jax.random.PRNGKey(0)
    _, x0 = jax_centralize(jb.x, jb.node_mask)
    shapes = jax.eval_shape(lambda: evd_j.init(key, x0, jb.one_hot, jb.charges, jb.node_mask, key, training=True))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params = jax.tree.map(jnp.asarray, import_state_dict(
        {"ddpm." + k: v.numpy() for k, v in state_dict.items()}, template))
    jax_checked = {training: jax.jit(checkify.checkify(
        jax_make_loss_fn(evd_j, jcfgs[3], jcfgs[4], table, training=training), errors=user_checks))
        for training in (True, False)}

    def jax_verdict(b, training):
        """The JAX package's first failed check on batch ``b``, or None."""
        jbb = JaxBatch(*(jnp.asarray(a) for a in (b.x, b.one_hot, b.charges, b.node_mask)))
        err, _ = jax_checked[training](params, jbb, key)
        return err.get()

    return batch, table, state_dict, jax_verdict


def port_steps(table, state_dict, debug, accumulate=1):
    from bio_diffusion_torch.config.schema import OptimizerConfig
    from bio_diffusion_torch.models.diffusion import EquivariantVariationalDiffusion
    from bio_diffusion_torch.models.gcpnet import GCPNetDynamics
    from bio_diffusion_torch.train.state import TrainState
    from bio_diffusion_torch.train.step import make_eval_step, make_train_step

    cfgs = one_layer(tiny_configs(), debug)
    evd = EquivariantVariationalDiffusion(GCPNetDynamics(*cfgs), cfgs[3], cfgs[4])
    evd.load_state_dict(state_dict)
    state = TrainState(list(evd.parameters()), [p.detach().clone() for p in evd.parameters()], OptimizerConfig())
    train = make_train_step(evd, cfgs[3], cfgs[4], table, accumulate_grad_batches=accumulate)
    return state, train, make_eval_step(evd, cfgs[3], cfgs[4], table)


def torch_batch(b):
    return dataclasses.replace(b, **{f: torch.as_tensor(getattr(b, f)) for f in ("x", "one_hot", "charges",
                                                                                  "node_mask")})


@pytest.mark.parametrize("case", CASES)
def test_debug_invariants(setup, case):
    from bio_diffusion_torch.utils.debug import InvariantError

    batch, table, state_dict, jax_verdict = setup
    bad = corrupt_padding(batch)
    gen = torch.Generator().manual_seed(1)
    if case == "off_by_default_ignores_corruption":
        state, train, _ = port_steps(table, state_dict, debug=False)
        metrics = train(state, torch_batch(bad), gen)
        assert "loss" in metrics
        assert "not correctly masked" in str(jax_verdict(bad, True))  # what the switch would have caught
        return
    accumulate = 2 if case == "accumulated_micro_batch_trips" else 1
    state, train, evaluate = port_steps(table, state_dict, debug=True, accumulate=accumulate)
    if case == "clean_batch_passes":
        assert jax_verdict(batch, True) is None
        metrics = train(state, torch_batch(batch), gen)
        assert np.isfinite(float(metrics["loss"]))
        return
    if case == "eval_step":
        assert jax_verdict(batch, False) is None
        assert np.isfinite(float(evaluate(torch_batch(batch), gen)["loss"]))
        step, args = evaluate, (torch_batch(bad), gen)
        verdict = str(jax_verdict(bad, False))
    elif case == "corrupted_mask_trips":
        step, args = train, (state, torch_batch(bad), gen)
        verdict = str(jax_verdict(bad, True))
    else:  # the second micro-batch is corrupted; JAX checks each one's grad
        step, args = train, (state, [torch_batch(batch), torch_batch(bad)], gen)
        verdict = str(jax_verdict(bad, True))
    assert verdict.startswith("input x is not correctly masked (max |pad| = 7.69999")
    with pytest.raises(InvariantError) as raised:
        step(*args)
    assert str(raised.value) == verdict.removesuffix(" (`check` failed)")  # JAX's message, word for word


def test_disabled_checks_touch_nothing():
    from bio_diffusion_torch.utils import debug

    # off: no tensor op at all (None would fail any)
    debug.check_correctly_masked(False, None, None)
    debug.check_mean_zero_with_mask(False, None, None)
    debug.check_finite(False, None)
    # on, outside a collecting block: raises at once
    with pytest.raises(debug.InvariantError, match="v contains non-finite values"):
        debug.check_finite(True, torch.tensor([1.0, float("nan")]), "v")
    with debug.collecting() as rec:
        debug.check_mean_zero_with_mask(True, torch.tensor([[[1.0], [-1.0], [5.0]]]), torch.tensor([[1.0, 1.0, 0.0]]),
                                        "x")
        debug.check_correctly_masked(True, torch.tensor([[[1.0], [-1.0], [5.0]]]), torch.tensor([[1.0, 1.0, 0.0]]),
                                     "x")
    assert len(rec.checks) == 2
    with pytest.raises(debug.InvariantError, match=re.escape("x is not correctly masked (max |pad| = 5.0)")):
        rec.throw()


def test_profile_trace_writes_a_trace(tmp_path):
    from bio_diffusion_torch.utils.profiling import profile_trace, span

    with profile_trace(None):
        pass
    with profile_trace(str(tmp_path / "prof")):
        with span("trainer.step"):
            torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    with open(tmp_path / "prof" / "trace.json") as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"aten::mm", "trainer.step"} <= names


@pytest.fixture(scope="module")
def train_run(tmp_path_factory):
    """``cli.train`` at the tiny width, 2 steps with the invariants on, a
    profile and the graph dump; a second run with ``trainer.profile=true``."""
    from bio_diffusion_torch.cli.train import main

    root = tmp_path_factory.mktemp("train_debug")
    args = TINY_OVERRIDES + ["datamodule.dataloader_cfg.batch_size=8", "model.diffusion_cfg.sample_during_training=false",
                             "--device=cpu", "--max-steps=2"]
    trainer = main(args + ["trainer.detect_anomaly=true", f"--profile={root / 'prof'}", "--dump-graph",
                           f"--workdir={root / 'a'}"])
    main(args + ["trainer.profile=true", f"--workdir={root / 'b'}"])
    return root, trainer


def test_train_cli_profile(train_run):
    root, trainer = train_run
    assert trainer.exp.diffusion_cfg.debug_invariants and trainer.stats["steps"] == 2
    for path in (root / "prof" / "trace.json", root / "b" / "profile" / "trace.json"):
        with open(path) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert "aten::mm" in names


def test_train_cli_dump_graph(train_run):
    root, _ = train_run
    with open(root / "a" / "graph" / "dynamics.modules.txt") as f:
        modules = f.read()
    assert modules.startswith("GCPNetDynamics(")
    with open(root / "a" / "graph" / "dynamics.ops.txt") as f:
        ops = f.read().splitlines()
    assert len(ops) > 100 and all(re.match(r"^\S+ \[.*\]$", line) for line in ops)
    # one call at B=2 and the dataset's largest N (29), 5 types + charge + 3
    assert any(line.startswith("aten::") and "[2, 29, 9]" in line for line in ops)


def test_train_cli_dump_graph_keeps_fast_dev_run_fresh(train_run, tmp_path):
    """``--dump-graph`` initializes the weights as ``fit`` would: a
    fast_dev_run on a workdir with a checkpoint still starts from step 0."""
    import shutil

    from bio_diffusion_torch.cli.train import main

    root, trainer = train_run
    workdir = tmp_path / "fdr"
    shutil.copytree(root / "a", workdir)
    args = TINY_OVERRIDES + ["datamodule.dataloader_cfg.batch_size=8", "model.diffusion_cfg.sample_during_training=false",
                             "--device=cpu", "trainer.fast_dev_run=true", "--dump-graph", f"--workdir={workdir}"]
    assert trainer.state.count == 2 and main(args).state.count == 1
    assert (workdir / "graph" / "dynamics.ops.txt").exists()


def test_train_cli_exec_time_log(train_run):
    root, _ = train_run
    for run in ("a", "b"):
        with open(root / run / "exec_time.log") as f:
            assert re.fullmatch(r"\d+\.\d\ds\n", f.read())

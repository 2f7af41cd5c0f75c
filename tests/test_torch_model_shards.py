"""The ``model`` axis of the port (``bio_diffusion_torch/parallel/mesh.py``) on the CPU.

Ranks are processes of a gloo group (``torch_parallel_workers``), each group
run once for the module:

* the sharding rule against JAX's ``param_sharding_rules`` leaf for leaf,
  on ``make_mesh(data=4, model=2)`` and ``make_mesh(data=2, model=4)``;
* 3 train steps at world 2 (1 data x 2 model) and world 4 (2 x 2) against
  world 1 on the global batches (B=8, which 4 divides, and a ragged B=5,
  which every rank takes whole), from JAX's draws and from a seeded
  generator, with ``accumulate_grad_batches`` 1 and 2: the metrics, and the
  gathered parameters, EMA and AMSGrad moments, at the data-parallel tests'
  tolerances (summation order only);
* world 4 with JAX's draws against JAX's step on ``make_mesh(data=2,
  model=2)`` with the state placed by ``shard_pytree(param_sharding_rules(
  ...))``, at ``test_dp_step_matches_jax_mesh``'s tolerances;
* the state at rest: exactly ``replicated + sharded / M`` elements over the
  five copies, the full parameters' storage released;
* ``cli.train`` resumed across shard counts: 2 steps at M = 2, then 2 more
  at M = 1 (world 2, and world 1) and at M = 2, each equal to 4
  uninterrupted steps at world 1; the file has a world-1 checkpoint's keys
  and shapes;
* a sampling evaluation after a sharded step (a learned schedule, so both
  caches of weights are on the path) equals world 1's bit for bit and
  differs from the same evaluation before the step; so does one after a
  change to the sharded EMA leaves alone, which moves no version counter
  that the caches could key on.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import jax_tiny_configs, tiny_configs
from test_torch_parallel import jax_batch
from test_torch_parallel_cli import BASE, SAME_BATCHES
from test_torch_train_step import jax_draws
from torch_parallel_workers import run_group, run_steps, trainer_summary

LR = 1e-4  # OptimizerConfig().lr
STEPS = 3
# sharded against world 1: summation order only (the data-parallel tests')
TOL_PARAMS = dict(rtol=0, atol=1e-6)
# the AMSGrad moments: mu ~ |g| (~1e-2), nu ~ g^2, each a float32 sum in
# another order; relative to the element, floored at a float32 ulp of 1e-3
TOL_MOMENTS = dict(rtol=1e-5, atol=1e-10)
M2 = ["trainer.num_model_shards=2"]
# the sampling evaluation around a step: the learned schedule (its table is
# cached), the EMA weights taking the step's parameters (decay 0), and a
# batch of 5, which 2 ranks do not divide: each takes it whole, so the
# mean of their gradients is exact and the step's weights equal world 1's
# bit for bit (the untrained sampler would amplify a last-bit difference)
SAMPLING = ["model.diffusion_cfg.noise_schedule=learned", "model.diffusion_cfg.loss_type=vlb",
            "model.diffusion_cfg.num_eval_samples=4", "model.diffusion_cfg.eval_batch_size=4",
            "trainer.ema_decay=0.0", "datamodule.dataloader_cfg.batch_size=5"]


def flat_jax_leaves(tree, prefix=()):
    """``(path, leaf)`` pairs of a nested dict, in its order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat_jax_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def nest(path, leaf):
    out = leaf
    for k in reversed(path):
        out = {k: out}
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Weights drawn by the port and imported into the JAX model, batches,
    JAX's steps on a 2 x 2 mesh and their draws, world 1 here and worlds 2
    and 4 in gloo groups (world 2 also runs the CLI and the sampling
    evaluation)."""
    from bio_diffusion_tpu.config.schema import OptimizerConfig as JaxOptimizerConfig
    from bio_diffusion_tpu.models.diffusion import EquivariantVariationalDiffusion as JaxEVD
    from bio_diffusion_tpu.models.gcpnet import GCPNetDynamics as JaxDynamics
    from bio_diffusion_tpu.models.gcpnet_fast import FastGCPNetDynamics
    from bio_diffusion_tpu.parallel.mesh import make_mesh, param_sharding_rules, shard_batch, shard_pytree
    from bio_diffusion_tpu.train import state as jax_state
    from bio_diffusion_tpu.train.step import make_train_step as jax_make_train_step
    from bio_diffusion_tpu.train.torch_import import import_state_dict
    from bio_diffusion_torch.data.batch import iterate_dense_batches
    from bio_diffusion_torch.data.synthetic import synthetic_qm9_like
    from bio_diffusion_torch.models.diffusion import EquivariantVariationalDiffusion
    from bio_diffusion_torch.models.distributions import NumNodesDistribution
    from bio_diffusion_torch.models.gcpnet import GCPNetDynamics
    from bio_diffusion_torch.train.checkpoints import reference_state_dict
    from bio_diffusion_torch.train.torch_import import init_random_weights

    cfgs = tiny_configs()
    mc, mod, lc, dc, dl = jax_tiny_configs()
    ds = synthetic_qm9_like(num_molecules=24, max_nodes=7, seed=0)
    batches = [b.to("cpu") for b in iterate_dense_batches(ds, batch_size=8, shuffle=False, pad_to=7)]
    ragged = next(iterate_dense_batches(ds, batch_size=5, shuffle=False, pad_to=7)).to("cpu")
    hist = {int(n): int(c) for n, c in zip(*np.unique(ds.data["num_atoms"], return_counts=True))}
    table = NumNodesDistribution(hist).log_prob_table
    evd = EquivariantVariationalDiffusion(GCPNetDynamics(*cfgs), cfgs[3], cfgs[4])
    init_random_weights(evd, 2)
    state_dict = reference_state_dict(evd)

    evd_j = JaxEVD(dynamics=JaxDynamics(mc, mod, lc, dc, dl, remat_interactions=False), diffusion_cfg=dc,
                   dataloader_cfg=dl)
    key = jax.random.PRNGKey(0)
    bj = jax_batch(batches[0])
    shapes = jax.eval_shape(lambda: evd_j.init(key, bj.x, bj.one_hot, bj.charges, bj.node_mask, key, training=True))
    params = jax.tree.map(jnp.asarray, import_state_dict(
        {k: v.numpy() for k, v in state_dict.items()}, jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)))

    # JAX: 3 steps on a 2 x 2 mesh, the state placed by param_sharding_rules
    mesh = make_mesh(num_devices=4, data=2, model=2)
    fast = evd_j.clone(dynamics=FastGCPNetDynamics(mc, mod, lc, dc, dl, use_pallas=False))
    optimizer = jax_state.make_optimizer(JaxOptimizerConfig())
    step_j = jax_make_train_step(fast, optimizer, dc, dl, table, donate=False)
    state_j = jax_state.create_train_state(shard_pytree(params, param_sharding_rules(params, mesh)), optimizer)
    key = jax.random.PRNGKey(11)
    metrics, draws = [], []
    for s, batch in enumerate(batches):
        draws.append(jax_draws(evd_j, params, jax.random.fold_in(key, s), jax_batch(batch).node_mask, True))
        state_j, m = step_j(state_j, shard_batch(mesh, jax_batch(batch)), key)
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "max_grad_norm")})
    jax_run = {"metrics": metrics, "params": jax.device_get(state_j.params),
               "ema": jax.device_get(state_j.ema_params)}

    base = {"state_dict": state_dict, "table": table, "accum": 1, "draws": None, "seed": 5}
    cases = {"jax": dict(base, draws=draws, steps=batches),
             "seeded": dict(base, steps=batches),
             "accum2": dict(base, accum=2, steps=[[batches[i], batches[(i + 1) % 3]] for i in range(STEPS)]),
             "ragged": dict(base, steps=[ragged] * STEPS)}
    world1 = {name: run_steps(None, case) for name, case in cases.items()}

    root = tmp_path_factory.mktemp("model_shards")
    cli_plans = [("m2_first_a", BASE + SAME_BATCHES + M2 + ["--max-steps=2", f"--workdir={root}/a"]),
                 ("m2_first_b", BASE + SAME_BATCHES + M2 + ["--max-steps=2", f"--workdir={root}/b"]),
                 ("m1_resumed", BASE + SAME_BATCHES + ["--max-steps=4", f"--workdir={root}/a"]),
                 ("m2_resumed", BASE + SAME_BATCHES + M2 + ["--max-steps=4", f"--workdir={root}/b"])]
    names, args = zip(*cli_plans)
    world2 = run_group("chain", 2, str(root / "group2"), [
        ("train_steps", (cases, 2)), ("cli_runs", (list(args),)), ("sampling_around_a_step", (SAMPLING, 2))],
        timeout=180.0)
    world4 = run_group("train_steps", 4, str(root / "group4"), cases, 2, timeout=180.0)
    return {"cases": cases, "world1": world1, "jax": jax_run, "params": params, "evd": evd, "root": root,
            "steps": {2: [r[0] for r in world2], 4: world4},
            "cli": [dict(zip(names, r[1])) for r in world2], "sampling": world2[0][2]}


@pytest.mark.parametrize("data,model", [(4, 2), (2, 4)])
def test_sharding_rule_matches_jax(setup, data, model):
    """Every leaf of the tiny model: JAX's rule on ``make_mesh(data, model)``
    shards it iff the port's rule shards its counterpart, along a dimension
    of the same length (a flax kernel is the transpose of its Linear)."""
    from bio_diffusion_tpu.parallel.mesh import make_mesh, param_sharding_rules
    from bio_diffusion_torch.parallel.mesh import shard_dim
    from bio_diffusion_torch.train.torch_import import state_dict_from_jax_params

    ours = {"ddpm." + n: (tuple(p.shape), shard_dim(p.shape, model)) for n, p in setup["evd"].named_parameters()}
    rules = param_sharding_rules(setup["params"], make_mesh(data=data, model=model))
    seen, sharded = set(), 0
    for (path, leaf), (_, rule) in zip(flat_jax_leaves(setup["params"]), flat_jax_leaves(rules)):
        (name, _), = state_dict_from_jax_params(nest(path, np.zeros(leaf.shape, np.float32))).items()
        spec = tuple(rule.spec) + (None,) * (leaf.ndim - len(rule.spec))
        jax_dim = spec.index("model") if "model" in spec else None
        shape, dim = ours[name]
        assert (jax_dim is None) == (dim is None), name
        if dim is not None:
            assert leaf.shape[jax_dim] == shape[dim] and shape[dim] % model == 0, name
            sharded += 1
        seen.add(name)
    assert seen == set(ours) and 0 < sharded < len(ours)


def assert_step_equal(ours, ref, what):
    for s, (a, b) in enumerate(zip(ours["metrics"], ref["metrics"])):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6, err_msg=f"{what} step {s}")
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5, err_msg=f"{what} step {s}")
    for key in ("params", "ema"):
        for n in ref[key]:
            np.testing.assert_allclose(ours[key][n], ref[key][n], **TOL_PARAMS, err_msg=f"{what} {key} {n}")
    for key in ("mu", "nu", "nu_max"):
        for n in ref["moments"][key]:
            np.testing.assert_allclose(ours["moments"][key][n], ref["moments"][key][n], **TOL_MOMENTS,
                                       err_msg=f"{what} {key} {n}")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["jax", "seeded", "accum2", "ragged"])
def test_sharded_steps_equal_world_one(setup, world, name):
    """3 steps at world 2 (1 x 2) and 4 (2 x 2) equal world 1 on the same
    global batches and draws; every rank gathers the same state."""
    ranks = [r[name] for r in setup["steps"][world]]
    w1 = setup["world1"][name]
    assert all(r["count"] == w1["count"] == STEPS for r in ranks)
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        for key in ("params", "ema"):
            for n in w1[key]:
                np.testing.assert_array_equal(r[key][n], ranks[0][key][n], err_msg=f"{key} {n}")
    assert_step_equal(ranks[0], w1, f"world {world}")


def test_sharded_step_matches_jax_mesh(setup):
    """World 4 (2 x 2) with JAX's draws against JAX's step on
    ``make_mesh(data=2, model=2)`` with the state sharded by its rule:
    loss, grad norm and clip threshold rtol 1e-4; parameters and EMA within
    2 lr a step, the median far closer."""
    from bio_diffusion_torch.train.torch_import import state_dict_from_jax_params

    ref, ours = setup["jax"], setup["steps"][4][0]["jax"]
    for s, (a, b) in enumerate(zip(ours["metrics"], ref["metrics"])):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=f"step {s}: {k}")
    tol = 2 * LR * STEPS
    for key in ("params", "ema"):
        tree = {k[len("ddpm."):]: v for k, v in state_dict_from_jax_params(ref[key]).items()}
        diffs = []
        for n, p in ours[key].items():
            np.testing.assert_allclose(p, tree[n], rtol=0, atol=tol, err_msg=n)
            diffs.append(np.abs(p - tree[n]).ravel())
        assert np.median(np.concatenate(diffs)) <= 1e-3 * LR


@pytest.mark.parametrize("world", [2, 4])
def test_state_at_rest_is_one_shard(setup, world):
    """After a step each rank's five copies (parameter and EMA shards, the
    three moments) hold exactly ``replicated + sharded / M`` elements each,
    and the model's and EMA twin's sharded parameters hold no storage."""
    from bio_diffusion_torch.parallel.mesh import shard_dim

    shapes = [tuple(p.shape) for p in setup["evd"].parameters()]
    dims = [shard_dim(s, 2) for s in shapes]
    numel = [int(np.prod(s)) for s in shapes]
    expected = 5 * (sum(n for n, d in zip(numel, dims) if d is None) + sum(n for n, d in zip(numel, dims)
                                                                         if d is not None) // 2)
    assert expected < 5 * sum(numel)
    for r in setup["steps"][world]:
        rest = r["seeded"]["at_rest"]
        assert rest["dims"] == dims and rest["shapes"] == shapes
        assert rest["copies"] == expected and rest["released"] == 0


def read_checkpoint(path):
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """4 steps of ``cli.train`` at world 1 on the resume tests' batches."""
    from bio_diffusion_torch.cli import train

    workdir = tmp_path_factory.mktemp("uninterrupted")
    return trainer_summary(train.main(BASE + SAME_BATCHES + ["--max-steps=4", f"--workdir={workdir}"])), workdir


@pytest.mark.parametrize("resumed", ["m1_resumed", "m2_resumed", "world1_m1"])
def test_resume_across_shard_counts(setup, uninterrupted, tmp_path, resumed):
    """2 steps at M = 2 (world 2), then 2 more at M = 1 (world 2, or world 1
    from a copy of the file) or at M = 2, on the same batches, equal 4
    uninterrupted steps at world 1; the M = 2 file holds a world-1
    checkpoint's keys and shapes."""
    from bio_diffusion_torch.cli import train

    reference, ref_dir = uninterrupted
    if resumed == "world1_m1":
        os.makedirs(tmp_path / "w1" / "checkpoints")
        shutil.copy(setup["root"] / "b" / "checkpoints" / "step_2.pt", tmp_path / "w1" / "checkpoints")
        runs = [trainer_summary(train.main(BASE + SAME_BATCHES + ["--max-steps=4", f"--workdir={tmp_path}/w1"]))]
    else:
        runs = [r[resumed] for r in setup["cli"]]
        first = [r["m2_first_a" if resumed == "m1_resumed" else "m2_first_b"] for r in setup["cli"]]
        assert [r["count"] for r in first] == [2, 2]
    for r in runs:
        assert (r["start_step"], r["count"]) == (2, 4)
        for key in ("params", "ema"):
            for i, (x, y) in enumerate(zip(r[key], reference[key])):
                np.testing.assert_allclose(x, y, **TOL_PARAMS, err_msg=f"{resumed}: {key} {i}")
    ours, ref = (read_checkpoint(p) for p in (setup["root"] / "a" / "checkpoints" / "step_2.pt",
                                               ref_dir / "checkpoints" / "step_4.pt"))

    def layout(payload):
        return {k: {n: tuple(t.shape) for n, t in v.items()} if isinstance(v, dict) else type(v).__name__
                for k, v in payload.items() if k not in ("optimizer", "gradnorm")} | {
            "optimizer": {k: ({n: tuple(t.shape) for n, t in v.items()} if isinstance(v, dict) else type(v).__name__)
                          for k, v in payload["optimizer"].items()}}

    assert layout(ours) == layout(ref)


def test_sampling_evaluation_after_a_sharded_step(setup, tmp_path):
    """A sampling evaluation, a step, the same sampling evaluation again,
    then the sharded EMA leaves scaled and the evaluation once more, at
    world 2 with two model shards equal the same at world 1 bit for bit;
    each evaluation reads the EMA weights of its time (each differs from
    the one before).  The third changes only sharded leaves, whose full
    tensors the gather rewrites while every replicated leaf, and so every
    version counter outside the gather, stays as it was: a packed-weight
    cache or a learned schedule's table kept across it would be stale."""
    from torch_parallel_workers import sampling_around_a_step

    ref = sampling_around_a_step(0, 1, f"file://{tmp_path}/w1", SAMPLING, 2)
    ours = setup["sampling"]
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(ref[1], ref[0])
    assert not np.array_equal(ref[2], ref[1])

"""Data parallelism of the port (``bio_diffusion_torch/parallel``) on the CPU.

* ``shard_indices`` against the JAX package's, exactly.
* The data-parallel train step at world 2 (two ranks of a gloo group, one
  process each, joined through a ``FileStore``; ``torch_parallel_workers``)
  against world 1 on the whole batch: 2 steps with ``accumulate_grad_batches``
  1 and 2 (JAX's draws), 2 steps drawing from a seeded generator, a ragged
  batch (B=3 on 2 ranks: every rank takes the whole batch) and a GEOM-style
  batch padded to its bucket; float32, atol 1e-6 on the parameters and rtol
  1e-6 on the loss, as ``test_accumulated_step_equals_the_big_batch_step``.
* The same steps against the JAX step on a 2-device CPU mesh
  (``make_mesh(num_devices=2)`` + ``shard_batch``) with JAX's draws, at the
  tolerances of ``test_three_train_steps_match_jax``.
* Ranks whose weights were drawn from different seeds agree after
  ``init_state``'s broadcast.
* The sampler on ``[cpu]`` (bit for bit) and ``[cpu, cpu]`` against the
  reverse process called on the EVD directly (B=4, and B=5 for the padding
  rule), and against JAX's ``SegmentedSampler(mesh=...)`` with JAX's draws;
  inpainting and the optimization round trip likewise against their EVD
  methods; ``MoleculeServer(devices=)`` and
  ``generate_ligands_in_pocket(devices=)`` against their single-device runs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_diffusion_torch.parallel import distributed
from test_torch_common import TINY_OVERRIDES, jax_tiny_configs, tiny_configs
from test_torch_train_step import jax_draws
from torch_parallel_workers import run_group, run_steps

LR = 1e-4  # OptimizerConfig().lr
# the step at world 2 against world 1: summation order only
TOL_PARAMS = dict(rtol=0, atol=1e-6)
# the multi-device sampler against one device: each replica's matrix
# products run over fewer rows (another blocking, float32); absolute, at
# least 1e-5 and 1e-6 of the largest magnitude (untrained weights make the
# states grow to ~1e2 in 10 steps)
TOL_SAMPLES_ABS, TOL_SAMPLES_REL = 1e-5, 1e-6


def assert_close(ours, ref, what=""):
    atol = max(TOL_SAMPLES_ABS, TOL_SAMPLES_REL * float(np.abs(ref).max()))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=atol, err_msg=what)


# -- shard_indices -----------------------------------------------------------------------


@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("process_count", [1, 2, 3])
@pytest.mark.parametrize("epoch", [0, 3])
@pytest.mark.parametrize("num_examples", [10, 11])
def test_shard_indices_match_jax(num_examples, epoch, process_count, shuffle, drop_remainder):
    from bio_diffusion_torch.data.samplers import shard_indices
    from bio_diffusion_tpu.data.samplers import shard_indices as jax_shard_indices

    kw = dict(seed=4, process_count=process_count, shuffle=shuffle, drop_remainder=drop_remainder)
    for pi in range(process_count):
        ours = shard_indices(num_examples, epoch, process_index=pi, **kw)
        np.testing.assert_array_equal(ours, jax_shard_indices(num_examples, epoch, process_index=pi, **kw))


def test_shard_indices_default_to_one_process_without_a_group():
    from bio_diffusion_torch.data.samplers import shard_indices

    np.testing.assert_array_equal(shard_indices(7, 1), shard_indices(7, 1, process_index=0, process_count=1))


def test_row_rules():
    """Contiguous rows where the batch divides, the whole batch where not
    (JAX's replicated rule), on tensors, arrays, dataclasses and dicts."""
    from bio_diffusion_torch.data.batch import DenseMolBatch

    assert distributed.row_slice(6, 1, 2) == slice(3, 6)
    assert distributed.row_slice(6, 2, 3) == slice(4, 6)
    assert distributed.row_slice(5, 1, 2) == slice(0, 5)
    b = DenseMolBatch(np.arange(6), torch.arange(6), np.zeros((6, 2)), np.ones((6, 3)), None)
    half = distributed.shard_rows(b, 1, 2)
    np.testing.assert_array_equal(half.x, [3, 4, 5])
    assert torch.equal(half.one_hot, torch.tensor([3, 4, 5])) and half.context is None
    assert distributed.shard_rows({"a": torch.arange(4)}, 0, 2)["a"].tolist() == [0, 1]


def test_model_shards_raise():
    distributed.check_model_shards(1)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        distributed.check_model_shards(2)


def test_inference_devices(monkeypatch):
    """One device unless ``inference_devices`` asks for more cards; the
    JAX CLIs' ``use_mesh`` does not split the port's batches."""
    cpu = torch.device("cpu")
    assert distributed.inference_devices({"device": "cpu"}) == [cpu]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert distributed.inference_devices({}) == [torch.device("cuda")]
    assert distributed.inference_devices({"use_mesh": True}) == [torch.device("cuda")]
    assert distributed.inference_devices({"inference_devices": "all"}) == [torch.device("cuda", i) for i in range(3)]
    assert distributed.inference_devices({"inference_devices": 2}) == [torch.device("cuda", i) for i in range(2)]
    assert distributed.inference_devices({"device": "cuda:1"}) == [torch.device("cuda", 1)]
    with pytest.raises(ValueError, match="3 card"):
        distributed.inference_devices({"inference_devices": 4})
    with pytest.raises(ValueError, match="device=cuda"):
        distributed.inference_devices({"inference_devices": 2, "device": "cuda:1"})


def test_replicas_split_rows_and_keep_one_copy():
    """``Replicas`` on the module's own device holds the module itself (no
    copy); rows padded with copies of the first, contiguous blocks, a
    ``[1, ...]`` array whole to each device, the padding sliced off."""
    lin = torch.nn.Linear(2, 2)
    reps = distributed.Replicas(lin, ["cpu", "cpu"])
    assert reps.modules == [lin, lin] and distributed.Replicas(lin).modules == [lin]
    a = np.arange(5, dtype=np.float32)[:, None]
    assert [p.flatten().tolist() for p in reps.scatter(a, 5)] == [[0, 1, 2], [3, 4, 0]]
    assert [p.tolist() for p in reps.scatter(np.ones((1, 2)), 5)] == [[[1, 1]], [[1, 1]]]
    assert reps.scatter(None, 5) == [None, None]
    assert reps.gather(reps.scatter(a, 5), 5).flatten().tolist() == [0, 1, 2, 3, 4]


# -- the train step ---------------------------------------------------------------------------


def jax_batch(batch):
    from bio_diffusion_tpu.data.batch import DenseMolBatch as JaxBatch

    return JaxBatch(*(jnp.asarray(a) for a in (batch.x, batch.one_hot, batch.charges, batch.node_mask)))


@pytest.fixture(scope="module")
def step_setup(tmp_path_factory):
    """Weights drawn by the port and imported into the JAX model, batches,
    JAX's mesh steps and draws, world 1 in this process and world 2 in two."""
    from bio_diffusion_tpu.config.schema import OptimizerConfig as JaxOptimizerConfig
    from bio_diffusion_tpu.models.diffusion import EquivariantVariationalDiffusion as JaxEVD
    from bio_diffusion_tpu.models.gcpnet import GCPNetDynamics as JaxDynamics
    from bio_diffusion_tpu.models.gcpnet_fast import FastGCPNetDynamics
    from bio_diffusion_tpu.parallel.mesh import make_mesh, shard_batch
    from bio_diffusion_tpu.train import state as jax_state
    from bio_diffusion_tpu.train.step import make_train_step as jax_make_train_step
    from bio_diffusion_tpu.train.torch_import import import_state_dict
    from bio_diffusion_torch.data.batch import iterate_dense_batches
    from bio_diffusion_torch.data.synthetic import synthetic_qm9_like
    from bio_diffusion_torch.models.diffusion import EquivariantVariationalDiffusion
    from bio_diffusion_torch.models.distributions import NumNodesDistribution
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P
    from bio_diffusion_torch.models.gcpnet import GCPNetDynamics
    from bio_diffusion_torch.train.checkpoints import reference_state_dict
    from bio_diffusion_torch.train.torch_import import init_random_weights

    cfgs = tiny_configs()
    mc, mod, lc, dc, dl = jax_tiny_configs()
    ds = synthetic_qm9_like(num_molecules=12, max_nodes=7, seed=0)
    first, second = [b.to("cpu") for b in iterate_dense_batches(ds, batch_size=6, shuffle=False, pad_to=7)]
    hist = {int(n): int(c) for n, c in zip(*np.unique(ds.data["num_atoms"], return_counts=True))}
    table = NumNodesDistribution(hist).log_prob_table
    evd = EquivariantVariationalDiffusion(GCPNetDynamics(*cfgs), cfgs[3], cfgs[4])
    init_random_weights(evd, 2)
    state_dict = reference_state_dict(evd)

    evd_j = JaxEVD(dynamics=JaxDynamics(mc, mod, lc, dc, dl, remat_interactions=False), diffusion_cfg=dc,
                   dataloader_cfg=dl)
    key = jax.random.PRNGKey(0)
    bj = jax_batch(first)
    shapes = jax.eval_shape(lambda: evd_j.init(key, bj.x, bj.one_hot, bj.charges, bj.node_mask, key, training=True))
    params = jax.tree.map(jnp.asarray, import_state_dict(
        {k: v.numpy() for k, v in state_dict.items()}, jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)))

    # JAX: 2 steps on a 2-device mesh, accumulate_grad_batches 1 and 2
    mesh = make_mesh(num_devices=2)
    fast = evd_j.clone(dynamics=FastGCPNetDynamics(mc, mod, lc, dc, dl, use_pallas=False))
    optimizer = jax_state.make_optimizer(JaxOptimizerConfig())
    key = jax.random.PRNGKey(11)
    jax_runs, cases = {}, {}
    for accum, micro in ((1, [first]), (2, [first, second])):
        step_j = jax_make_train_step(fast, optimizer, dc, dl, table, donate=False, accumulate_grad_batches=accum)
        # the state replicated on the mesh, as the step returns it (one compile)
        state_j = jax.device_put(jax_state.create_train_state(params, optimizer), NamedSharding(mesh, P()))
        sharded = [shard_batch(mesh, jax_batch(b)) for b in micro]
        metrics, draws = [], []
        for s in range(2):
            rng = jax.random.fold_in(key, s)
            if accum == 1:
                draws.append(jax_draws(evd_j, params, rng, bj.node_mask, True))
                state_j, m = step_j(state_j, sharded[0], key)
            else:
                draws.append([jax_draws(evd_j, params, jax.random.fold_in(rng, i), jb.node_mask, True)
                              for i, jb in enumerate(sharded)])
                state_j, m = step_j(state_j, sharded, key)
            metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "max_grad_norm")})
        jax_runs[f"accum{accum}"] = {"metrics": metrics, "params": jax.device_get(state_j.params),
                                     "ema": jax.device_get(state_j.ema_params)}
        cases[f"accum{accum}"] = {"state_dict": state_dict, "table": table, "accum": accum, "draws": draws,
                                  "steps": [micro[0] if accum == 1 else micro] * 2}

    # draws from a seeded generator: the whole batch, a ragged one, and GEOM-style
    # batches padded to their bucket (N = 8 or 12)
    geom_ds = synthetic_qm9_like(num_molecules=8, max_nodes=11, min_nodes=5, seed=3)
    geom = [b.to("cpu") for b in iterate_dense_batches(geom_ds, batch_size=4, shuffle=False, bucket_sizes=[8, 12])]
    ragged = next(iterate_dense_batches(ds, batch_size=3, shuffle=False, pad_to=7)).to("cpu")
    for name, steps in (("seeded", [first, second]), ("ragged", [ragged, ragged]), ("geom", geom)):
        cases[name] = {"state_dict": state_dict, "table": table, "accum": 1, "draws": None, "steps": steps,
                       "seed": 5}
    # the loss normalized by the whole batch's largest molecule (rank 0's rows
    # hold 7, 6, 6 atoms, rank 1's 5, 5, 4), and the invariant checks on
    for name, diffusion in (("max_nodes", {"norm_training_by_max_nodes": True}),
                            ("checked", {"debug_invariants": True})):
        cases[name] = dict(cases["seeded"], diffusion=diffusion)
    # a padded row of x set in molecule 5 (4 atoms; rank 1's rows): the
    # masked-input check fails on rank 1 alone
    corrupted = dataclasses.replace(first, x=first.x.clone())
    corrupted.x[5, 6] = 7.7
    cases["corrupted"] = dict(cases["checked"], steps=[corrupted])
    world1 = {name: run_steps(None, case) for name, case in cases.items()}
    world2 = run_group("train_steps", 2, str(tmp_path_factory.mktemp("dp_steps")), cases)
    return {"cases": cases, "world1": world1, "world2": world2, "jax": jax_runs, "geom": geom}


@pytest.mark.parametrize("name", ["accum1", "accum2", "seeded", "ragged", "geom", "max_nodes", "checked"])
def test_dp_step_equals_world_one(step_setup, name):
    """Two steps at world 2 equal two steps at world 1 on the global batches
    with the same draws; the two ranks hold identical states."""
    w1, (r0, r1) = step_setup["world1"][name], [w[name] for w in step_setup["world2"]]
    assert r0["count"] == r1["count"] == w1["count"] == 2
    for a, b in zip(r0["metrics"], r1["metrics"]):
        assert a == b
    for s, (a, b) in enumerate(zip(r0["metrics"], w1["metrics"])):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6, err_msg=f"step {s}")
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5, err_msg=f"step {s}")
    for key in ("params", "ema"):
        for n in w1[key]:
            np.testing.assert_array_equal(r0[key][n], r1[key][n], err_msg=n)
            np.testing.assert_allclose(r0[key][n], w1[key][n], **TOL_PARAMS, err_msg=n)


def test_a_failed_invariant_raises_on_every_rank(step_setup):
    """A check that fails on rank 1's rows alone raises on both ranks, with
    the message world 1 raises (the flags and values are reduced first)."""
    w1, (r0, r1) = step_setup["world1"]["corrupted"], [w["corrupted"] for w in step_setup["world2"]]
    assert "input x is not correctly masked" in w1["error"]
    assert r0 == r1 == w1


def test_geom_batches_are_bucketed_and_split(step_setup):
    """The GEOM-style batches hold molecules of different sizes padded to
    their bucket; both ranks' rows share that N."""
    widths = [b.node_mask.shape[1] for b in step_setup["geom"]]
    assert all(w in (8, 12) for w in widths) and all(b.node_mask.shape[0] == 4 for b in step_setup["geom"])
    sizes = step_setup["geom"][0].node_mask.sum(-1)
    assert len(set(sizes.tolist())) > 1


@pytest.mark.parametrize("name", ["accum1", "accum2"])
def test_dp_step_matches_jax_mesh(step_setup, name):
    """World 2 with JAX's draws against the JAX step on a 2-device mesh:
    loss, grad norm and clip threshold per step rtol 1e-4; parameters and
    EMA within 2 lr per step (AMSGrad moves a near-zero-gradient element by
    +lr in one framework and -lr in the other), most far closer."""
    from bio_diffusion_torch.train.torch_import import state_dict_from_jax_params

    ref, ours = step_setup["jax"][name], step_setup["world2"][0][name]
    for s, (a, b) in enumerate(zip(ours["metrics"], ref["metrics"])):
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=f"step {s}: {k}")
    tol = 2 * LR * 2
    for key in ("params", "ema"):
        tree = {k[len("ddpm."):]: v for k, v in state_dict_from_jax_params(ref[key]).items()}
        diffs = []
        for n, p in ours[key].items():
            np.testing.assert_allclose(p, tree[n], rtol=0, atol=tol, err_msg=n)
            diffs.append(np.abs(p - tree[n]).ravel())
        assert np.median(np.concatenate(diffs)) <= 1e-3 * LR


def test_ranks_agree_after_init_state_broadcast(tmp_path):
    """Ranks that drew their weights from seeds 0 and 5 hold rank 0's
    parameters, EMA and optimizer state after ``init_state``."""
    from bio_diffusion_torch.config.build import build_evd, build_experiment
    from bio_diffusion_torch.config.loader import default_config_dir, load_config
    from bio_diffusion_torch.train.torch_import import init_random_weights

    r0, r1 = run_group("broadcast_init", 2, str(tmp_path), [0, 5])
    for key in r0:
        for a, b in zip(r0[key], r1[key]):
            np.testing.assert_array_equal(a, b, err_msg=key)
    fresh = {}
    for seed in (0, 5):
        evd = build_evd(build_experiment(load_config(default_config_dir(), "train", TINY_OVERRIDES)))
        init_random_weights(evd, seed)
        fresh[seed] = [p.detach().numpy() for p in evd.parameters()]
    for a, b in zip(r1["params"], fresh[0]):
        np.testing.assert_array_equal(a, b)
    assert any(not np.array_equal(a, b) for a, b in zip(r1["params"], fresh[5]))


# -- the multi-device sampler ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def sampler_models():
    """The tiny QM9 model in both packages with the same weights."""
    from bio_diffusion_tpu.models.diffusion import EquivariantVariationalDiffusion as JaxEVD
    from bio_diffusion_tpu.models.gcpnet import GCPNetDynamics as JaxDynamics
    from bio_diffusion_tpu.train.torch_import import import_state_dict
    from bio_diffusion_torch.models.diffusion import EquivariantVariationalDiffusion
    from bio_diffusion_torch.models.gcpnet import GCPNetDynamics
    from bio_diffusion_torch.train.torch_import import init_random_weights

    cfgs, jcfgs = tiny_configs(), jax_tiny_configs()
    jax_evd = JaxEVD(dynamics=JaxDynamics(*jcfgs, remat_interactions=False), diffusion_cfg=jcfgs[3],
                     dataloader_cfg=jcfgs[4])
    key, mask = jax.random.PRNGKey(0), jnp.ones((2, 6))
    shapes = jax.eval_shape(lambda: jax_evd.init(key, jnp.zeros((2, 6, 3)), jnp.zeros((2, 6, 5)),
                                                 jnp.zeros((2, 6, 1)), mask, key, training=False))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    evd = EquivariantVariationalDiffusion(GCPNetDynamics(*cfgs), cfgs[3], cfgs[4])
    init_random_weights(evd, 3)
    params = jax.tree.map(jnp.asarray, import_state_dict(
        {"ddpm." + k: v.numpy() for k, v in evd.state_dict().items()}, template))
    return jax_evd, params, evd.eval()


def sizes_mask(b, n=7):
    from bio_diffusion_torch.train.sampling import make_node_mask

    return make_node_mask(np.array([7, 5, 6, 4, 7, 3, 6][:b]), n)


def assert_samples_close(ours, ref):
    assert_close(ours[..., :3], ref[..., :3], "positions")
    np.testing.assert_array_equal(ours[..., 3:], ref[..., 3:])


def direct_sample(evd, mask, generator, fix_noise=False, frame_steps=None):
    """The reverse process called on the EVD directly, its draws from
    ``generator`` (no sampler, no replicas) -> (xh, frames or None)."""
    mask = torch.as_tensor(mask)
    with torch.inference_mode():
        z = evd.init_sample_noise(mask, generator, fix_noise)
        frames = None if frame_steps is None else torch.empty((len(frame_steps),) + z.shape)
        s_values = np.arange(evd.T - 1, -1, -1, dtype=np.float32)
        z = evd.reverse_segment(z, s_values / evd.T, (s_values + 1) / evd.T, mask, generator, fix_noise,
                                frames=frames, frame_steps=frame_steps)
        xh = evd.decode_sample(z, mask, generator, fix_noise).numpy()
    return xh, None if frames is None else frames.numpy()


@pytest.mark.parametrize("b", [4, 5])
def test_multi_device_sampler_equals_one_device(sampler_models, b):
    """[cpu] (bit for bit) and [cpu, cpu] against the reverse process called
    on the EVD directly with the same seed: the draws are the one-device
    run's (B=5 is padded to 6 with a copy of the first molecule, sliced
    off), the generator ends in the same state; also the kept chain frames."""
    from bio_diffusion_torch.train.sampling import SegmentedSampler

    *_, evd = sampler_models
    mask = sizes_mask(b)
    gen = torch.Generator().manual_seed(9)
    xh0, f0 = direct_sample(evd, mask, gen, frame_steps=[0, 4, 9])
    for devices in (["cpu"], ["cpu", "cpu"]):
        sampler = SegmentedSampler(evd, devices=devices)
        g = torch.Generator().manual_seed(9)
        xh, f = sampler.run(mask, g, frame_steps=[0, 4, 9])
        assert sampler.runs == 1 and torch.equal(g.get_state(), gen.get_state())
        assert xh.shape == xh0.shape == (b, 7, 9) and f.shape == f0.shape == (3, b, 7, 9)
        if len(devices) == 1:
            np.testing.assert_array_equal(xh, xh0)
            np.testing.assert_array_equal(f, f0)
        assert_samples_close(xh, xh0)
        assert_close(f, f0, "frames")
        assert np.all(xh[mask == 0] == 0)


def test_multi_device_sampler_fix_noise_and_context(sampler_models):
    """fix_noise (one [1, N, F] draw for every molecule) on one and two
    devices against the EVD called directly."""
    from bio_diffusion_torch.train.sampling import SegmentedSampler

    *_, evd = sampler_models
    mask = sizes_mask(3)
    ref, _ = direct_sample(evd, mask, torch.Generator().manual_seed(2), fix_noise=True)
    one, two = (SegmentedSampler(evd, devices=d).run(mask, torch.Generator().manual_seed(2), fix_noise=True)
                for d in (["cpu"], ["cpu", "cpu"]))
    np.testing.assert_array_equal(one, ref)
    assert_samples_close(two, ref)


def jax_sampler_draws(key, b, n, steps):
    """The raw draws of JAX ``SegmentedSampler.run(key, ...)`` with one
    segment: ``key, k_init = split(key)``, ``key, k_seg = split(key)``, per
    step ``carry, k1, _ = split(carry, 3)`` from ``k_seg``, then ``key, k_dec
    = split(key)``."""
    from test_torch_diffusion import jax_raw_noise

    key, k_init = jax.random.split(key)
    draws = [jax_raw_noise(k_init, b, n)]
    key, carry = jax.random.split(key)
    for _ in range(steps):
        carry, k1, _ = jax.random.split(carry, 3)
        draws.append(jax_raw_noise(k1, b, n))
    key, k_dec = jax.random.split(key)
    return draws + [jax_raw_noise(k_dec, b, n)]


def test_multi_device_sampler_matches_jax_mesh(sampler_models):
    """[cpu, cpu] with JAX's draws against JAX's sampler on a 2-device mesh:
    positions atol 1e-4 (tests/test_torch_diffusion.py), types identical."""
    from bio_diffusion_tpu.parallel.mesh import make_mesh
    from bio_diffusion_tpu.train.sampling import SegmentedSampler as JaxSampler
    from bio_diffusion_torch.train.sampling import SegmentedSampler

    jax_evd, params, evd = sampler_models
    mask = sizes_mask(4)
    key = jax.random.PRNGKey(21)
    ref = JaxSampler(jax_evd, params, mesh=make_mesh(num_devices=2)).run(key, jnp.asarray(mask))
    ours = SegmentedSampler(evd, devices=["cpu", "cpu"]).run(mask, None, noises=jax_sampler_draws(key, 4, 7, evd.T))
    np.testing.assert_allclose(ours[..., :3], ref[..., :3], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ours[..., 3:], ref[..., 3:])


def test_server_on_two_devices_equals_one():
    """A seeded request on ``MoleculeServer(devices=[cpu, cpu])`` (batch 3,
    padded to 4 across the two) returns the molecules of the one-device
    server (positions as served, rounded to 1e-6)."""
    from bio_diffusion_torch.cli.serve import build_server
    from bio_diffusion_torch.config.loader import default_config_dir, load_config
    from bio_diffusion_torch.serve import MoleculeServer

    cfg = load_config(default_config_dir(), "serve", TINY_OVERRIDES + [
        "device=cpu", "precision=fp32", "serving_batch_size=3", "buckets=[6]"])
    one = build_server(cfg)
    two = MoleculeServer(one.sampler.evd, one.dataset_info, one.nodes_dist, device="cpu", devices=["cpu", "cpu"],
                         batch_size=3, buckets=[6])
    try:
        assert one.devices == [torch.device("cpu")]
        a, b = (s.generate(3, num_timesteps=4, seed=7) for s in (one, two))
        assert "cpu, cpu" in two.describe()["device"]
    finally:
        one.close()
        two.close()
    for m1, m2 in zip(a["molecules"], b["molecules"]):
        assert m1["atoms"] == m2["atoms"] and m1["size"] == m2["size"]
        np.testing.assert_allclose(m2["positions"], m1["positions"], rtol=0, atol=2e-5)


def test_pocket_generation_on_two_devices_equals_one():
    """``generate_ligands_in_pocket(devices=[cpu, cpu])`` (3 pockets, padded
    to 4; 2 resamplings, jumps of 2, so jump draws are in the stream)
    against one device with the same seed."""
    from bio_diffusion_torch.config.build import build_evd, build_experiment
    from bio_diffusion_torch.config.loader import default_config_dir, load_config
    from bio_diffusion_torch.data.pocket import synthetic_pockets
    from bio_diffusion_torch.train.sampling import generate_ligands_in_pocket
    from bio_diffusion_torch.train.torch_import import init_random_weights
    from test_torch_inpaint import KL, POCKET_TINY

    evd = build_evd(build_experiment(load_config(default_config_dir(), "train", POCKET_TINY)))
    init_random_weights(evd, 8)
    evd.eval()
    pocket_x, pocket_aa, pocket_mask = synthetic_pockets("bindingmoad", np.array([6, 8, 7]),
                                                         np.random.default_rng(0))
    kw = dict(pocket_x=pocket_x, pocket_types=pocket_aa, pocket_mask=pocket_mask, ligand_sizes=np.array([4, 5, 3]),
              num_ligand_atom_types=KL, num_resamplings=2, jump_length=2, num_timesteps=4)
    one = generate_ligands_in_pocket(evd, torch.Generator().manual_seed(3), **kw)
    two = generate_ligands_in_pocket(evd, torch.Generator().manual_seed(3), devices=["cpu", "cpu"], **kw)
    assert set(one) == set(two)
    for k in one:
        if k in ("ligand_x", "joint_xh"):
            assert_close(two[k], one[k], k)
        else:
            np.testing.assert_array_equal(two[k], one[k], err_msg=k)


def test_inpainting_on_two_devices_equals_one(sampler_models):
    """``mol_gen_sample``'s inpainting mode (``inpaint_first_node``) on one
    device (bit for bit) and with its rows split over [cpu, cpu] (3
    molecules, padded to 4; 2 resamplings, jumps of 2) against
    ``evd.inpaint`` called directly with the same seed."""
    from bio_diffusion_torch.cli.mol_gen_sample import inpaint_first_node

    *_, evd = sampler_models
    cfg = {"num_resamplings": 2, "jump_length": 2}
    sizes = np.array([5, 4, 6])
    (one, m1), (two, m2) = (inpaint_first_node(evd, cfg, sizes, 5, 4, torch.Generator().manual_seed(6), devices)
                            for devices in (None, ["cpu", "cpu"]))
    fixed = np.zeros_like(m1)
    fixed[:, 0] = 1.0
    inputs = [np.zeros((3, 6, 3)), np.zeros((3, 6, 5)), np.zeros((3, 6, 1)), m1, fixed]
    with torch.inference_mode():
        ref = evd.inpaint(*(torch.as_tensor(a, dtype=torch.float32) for a in inputs), 2, 2, 4,
                          generator=torch.Generator().manual_seed(6)).numpy()
    np.testing.assert_array_equal(m2, m1)
    np.testing.assert_array_equal(one, ref)
    assert_samples_close(two, ref)


def test_optimization_round_trip_on_two_devices_equals_one():
    """``mol_gen_optimize_rows`` (the guided-optimization CLI's round trip)
    on one device (bit for bit) and over two against ``mol_gen_optimize``
    called directly, same seed, on the tiny conditional model (no charge
    channel, one context)."""
    from bio_diffusion_torch.config.build import build_evd, build_experiment
    from bio_diffusion_torch.config.loader import default_config_dir, load_config
    from bio_diffusion_torch.ops.geometry import centralize
    from bio_diffusion_torch.train.sampling import make_node_mask, mol_gen_optimize_rows
    from bio_diffusion_torch.train.torch_import import init_random_weights

    model = [o for o in TINY_OVERRIDES if o.startswith("model.")]
    evd = build_evd(build_experiment(load_config(default_config_dir(), "train", [
        "experiment=qm9_mol_gen_conditional_ddpm"] + model)))
    init_random_weights(evd, 4)
    evd.eval()
    rng = np.random.default_rng(0)
    mask = torch.as_tensor(make_node_mask(np.array([6, 4, 5]), 6))
    _, x = centralize(torch.as_tensor(rng.normal(size=(3, 6, 3)), dtype=torch.float32) * mask[..., None], mask)
    h = torch.nn.functional.one_hot(torch.as_tensor(rng.integers(0, 5, (3, 6))), 5).float() * mask[..., None]
    ctx = torch.as_tensor(rng.normal(size=(3, 1, 1)), dtype=torch.float32).expand(3, 6, 1) * mask[..., None]
    with torch.inference_mode():
        ref = evd.mol_gen_optimize(x, h, mask, 4, ctx, generator=torch.Generator().manual_seed(8))
        one, two = (mol_gen_optimize_rows(distributed.Replicas(evd, d), x, h, mask, 4, ctx,
                                          torch.Generator().manual_seed(8)) for d in (None, ["cpu", "cpu"]))
    np.testing.assert_array_equal(one.numpy(), ref.numpy())
    assert_samples_close(two.numpy(), ref.numpy())

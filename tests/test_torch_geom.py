"""Port parity: the GEOM-Drugs model, its training step, the chunked
backward and the GEOM user path, against the JAX package.

The ``geom_mol_gen_ddpm`` experiment as both packages compose it, cut to a
tiny width with GEOM's ratios (16 atom types, no charge channel, norm values
[1, 4, 10], edges narrower than nodes: S=16, V=8, Se=4, Ve=2) and 2 layers,
T=10.  The weights are drawn by the port from a seed and carried into JAX
through the JAX package's own reference-name import, so the same weights
run in both; molecules come from seeded GEOM-layout files, batched as the
Trainer batches them (each padded to its bucket).  Float32, CPU (the port's
plain message layer).

* The denoiser against JAX ``make_fast_dynamics(use_pallas=True,
  interpret=True)`` at the 48 bucket (JAX's whole-molecule kernel body) and
  the 64 bucket (n * n > 2600: its sub-molecule body, nodes padded to a
  multiple of 8): within 1e-5 of max|JAX output|.
* ``loss_terms`` (rtol 1e-5, atol 1e-6; the KL prior atol 2e-5) and the full loss's parameter
  gradients (rtol 2e-3, atol 2e-5, as ``test_torch_train_step.py``) on a
  bucketed batch.
* The message layer's backward walked in chunks of molecules (1, 2 and one
  a molecule) against the whole batch: one chunk bit-identical; in more,
  node and edge cotangents within 1e-7 of max|·| (the CPU's products round
  by row count), weight grads within 1e-6 (the kernel's chunks are held
  bit-identical on the card in ``test_torch_kernel.py``).
* ``cli.train`` -> ``cli.mol_gen_sample`` -> ``cli.mol_gen_eval`` on seeded
  GEOM-layout files (``--device=cpu``): one message layer per layer per
  denoiser call, GEOM's element symbols in the xyz files, a finite test NLL.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_diffusion_tpu.config.build import build_experiment as jax_build_experiment
from bio_diffusion_tpu.config.loader import load_config as jax_load_config
from bio_diffusion_tpu.data.batch import DenseMolBatch as JaxBatch
from bio_diffusion_tpu.models.diffusion import EquivariantVariationalDiffusion as JaxEVD
from bio_diffusion_tpu.models.gcpnet import GCPNetDynamics as JaxDynamics
from bio_diffusion_tpu.models.gcpnet_fast import make_fast_dynamics
from bio_diffusion_tpu.ops.geometry import centralize as jax_centralize
from bio_diffusion_tpu.train.step import make_loss_fn as jax_make_loss_fn
from bio_diffusion_tpu.train.torch_import import import_state_dict
from bio_diffusion_torch.config.build import build_evd, build_experiment
from bio_diffusion_torch.config.loader import default_config_dir, load_config
from bio_diffusion_torch.data.batch import iterate_dense_batches
from bio_diffusion_torch.data.geom import load_geom_datasets
from bio_diffusion_torch.data.synthetic import write_geom_layout
from bio_diffusion_torch.models.distributions import NumNodesDistribution
from bio_diffusion_torch.ops import message_layer as ml
from bio_diffusion_torch.train.step import make_loss_fn
from bio_diffusion_torch.train.torch_import import (
    init_random_weights,
    load_reference_state_dict,
    state_dict_from_jax_params,
)

GEOM_TINY = [
    "experiment=geom_mol_gen_ddpm",
    "model.model_cfg.h_hidden_dim=16",
    "model.model_cfg.chi_hidden_dim=8",
    "model.model_cfg.e_hidden_dim=4",
    "model.model_cfg.xi_hidden_dim=2",
    "model.model_cfg.num_encoder_layers=2",
    "model.diffusion_cfg.num_timesteps=10",
]
NUM_FEATURES = 16  # sixteen atom types, no charge channel
TOL_OUT_REL = 1e-5  # of max|JAX output|
TOL_TERMS = dict(rtol=1e-5, atol=1e-6)  # as tests/test_torch_conditioning.py
# the KL prior (~1e-2 here) is a difference of terms that grow with the sum
# of |x|^2 over a molecule (GEOM: tens of atoms, |x| up to ~8 A), so it
# carries their float32 rounding as an absolute error: on the 48-bucket batch
# both packages lie within 1.2e-5 of the float64 value
TOL_KL_PRIOR = dict(rtol=1e-5, atol=2e-5)
TOL_GRAD = dict(rtol=2e-3, atol=2e-5)  # as tests/test_torch_train_step.py
TOL_CHUNK_REL = 1e-6  # chunked weight grads, of max|whole|
TOL_NODE_REL = 1e-7  # chunked node and edge cotangents on the CPU, of max|whole|


def pick_batch(ds, sizes_ok, b, bucket_sizes=None, pad_to=None):
    """The first ``b`` molecules whose sizes pass ``sizes_ok``, batched as
    the Trainer batches GEOM (padded to their bucket), or padded to
    ``pad_to`` as a sampler batch is."""
    from bio_diffusion_torch.data.batch import DenseDataset

    idx = [i for i, n in enumerate(ds.data["num_atoms"]) if sizes_ok(n)][:b]
    sub = DenseDataset({k: v[idx] for k, v in ds.data.items()}, ds.included_species)
    return next(iterate_dense_batches(sub, batch_size=b, shuffle=False, bucket_sizes=bucket_sizes,
                                      pad_to=pad_to))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Port and JAX GEOM EVDs with the same weights, the seeded GEOM data,
    and three batches: two bucketed (48 and 64 atoms), one of 51-54 atoms
    padded to 54 as the sampler pads (JAX pads it to 56 for its kernel)."""
    exp = build_experiment(load_config(default_config_dir(), "train", GEOM_TINY))
    jexp = jax_build_experiment(jax_load_config(default_config_dir(), "train", GEOM_TINY))
    data_dir = str(tmp_path_factory.mktemp("geom"))
    write_geom_layout(data_dir, num_conformers=120, seed=3)
    ds = load_geom_datasets(data_dir)["train"]
    buckets = exp.dataloader_cfg.bucket_sizes
    small = pick_batch(ds, lambda n: n <= 40, 3, buckets)
    big = pick_batch(ds, lambda n: 51 <= n <= 60, 2, buckets)
    odd = pick_batch(ds, lambda n: 51 <= n <= 54, 2, pad_to=54)
    net = JaxDynamics(jexp.model_cfg, jexp.module_cfg, jexp.layer_cfg, jexp.diffusion_cfg, jexp.dataloader_cfg,
                      remat_interactions=False)
    evd_j = JaxEVD(dynamics=net, diffusion_cfg=jexp.diffusion_cfg, dataloader_cfg=jexp.dataloader_cfg)
    bj = JaxBatch(*(jnp.asarray(a) for a in (small.x, small.one_hot, small.charges, small.node_mask)))
    key = jax.random.PRNGKey(0)
    _, x0 = jax_centralize(bj.x, bj.node_mask)
    shapes = jax.eval_shape(lambda: evd_j.init(key, x0, bj.one_hot, bj.charges, bj.node_mask, key, training=True))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    evd = build_evd(exp)
    init_random_weights(evd, 11)
    sd = {"ddpm." + k: v.numpy() for k, v in evd.state_dict().items()}
    params = jax.tree.map(jnp.asarray, import_state_dict(sd, template))
    return exp, jexp, ds, {"small": small, "big": big, "odd": odd}, net, evd_j, params, evd.eval()


def jax_batch(batch):
    return JaxBatch(*(jnp.asarray(a) for a in (batch.x, batch.one_hot, batch.charges, batch.node_mask)))


def test_geom_experiment_composes_as_in_jax(setup):
    exp, jexp, ds, batches, _, _, _, evd = setup
    for part in ("model_cfg", "module_cfg", "diffusion_cfg", "dataloader_cfg"):
        assert dataclasses.asdict(getattr(exp, part)) == dataclasses.asdict(getattr(jexp, part)), part
    dl = exp.dataloader_cfg
    assert (dl.dataset, dl.num_atom_types, dl.include_charges, tuple(dl.bucket_sizes)) == \
        ("GEOM", NUM_FEATURES, False, (48, 64, 96, 128, 192))
    assert tuple(exp.diffusion_cfg.norm_values) == (1.0, 4.0, 10.0)
    assert {k: b.node_mask.shape for k, b in batches.items()} == {"small": (3, 48), "big": (2, 64), "odd": (2, 54)}
    assert batches["small"].one_hot.shape[-1] == NUM_FEATURES and ds.num_species == NUM_FEATURES
    assert len(evd.dynamics_network.interaction_layers) == 2


@pytest.mark.parametrize("which", ["small", "big", "odd"])
def test_geom_denoiser_matches_jax_kernel(setup, which):
    """The 48 bucket runs JAX's whole-molecule kernel body, the 64 bucket
    (64 * 64 > 2600) its sub-molecule body in target tiles, and N=54 that
    body on nodes padded to 56."""
    exp, jexp, _, batches, _, _, params, evd = setup
    batch = batches[which]
    rng = np.random.default_rng(5)
    mask = batch.node_mask
    _, x = jax_centralize(jnp.asarray(batch.x), jnp.asarray(mask))
    h = rng.normal(size=batch.one_hot.shape).astype(np.float32)
    xh = np.concatenate([np.asarray(x), h], -1) * mask[..., None]
    t = np.full((len(mask), 1), 0.45, np.float32)
    fast = make_fast_dynamics(jexp.model_cfg, jexp.module_cfg, jexp.layer_cfg, jexp.diffusion_cfg,
                              jexp.dataloader_cfg, params, compute_dtype=None, use_pallas=True, interpret=True)
    ref = np.asarray(fast(jnp.asarray(xh), jnp.asarray(t), jnp.asarray(mask)))
    with torch.inference_mode():
        out = evd.dynamics_network(torch.from_numpy(xh), torch.from_numpy(t), torch.from_numpy(mask)).numpy()
    assert out.shape == xh.shape and np.isfinite(out).all()
    assert np.abs(out - ref).max() <= TOL_OUT_REL * np.abs(ref).max()


def loss_draws(evd_j, params, rng, node_mask, training):
    """The draws ``loss_terms`` makes from ``rng`` (as in
    tests/test_torch_conditioning.py)."""
    key_t, key_eps, _, _, key_eps0 = jax.random.split(rng, 5)
    b = node_mask.shape[0]
    t_int = jax.random.randint(key_t, (b, 1), 0 if training else 1, evd_j.diffusion_cfg.num_timesteps + 1)
    noise = lambda k: evd_j.apply(params, k, node_mask, method=JaxEVD.sample_noise)  # noqa: E731
    draws = {"t_int": t_int.astype(jnp.float32), "eps_t": noise(key_eps)}
    if not training:
        draws["eps_0"] = noise(key_eps0)
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


@pytest.mark.parametrize("training", [True, False])
def test_geom_loss_terms_match_jax(setup, training):
    _, _, _, batches, _, evd_j, params, evd = setup
    batch = batches["small"]
    bj = jax_batch(batch)
    rng = jax.random.PRNGKey(7)
    _, x_j = jax_centralize(bj.x, bj.node_mask)
    ref = jax.jit(lambda p, *a: evd_j.apply(p, *a, training=training))(
        params, x_j, bj.one_hot, bj.charges, bj.node_mask, rng)
    b = batch.to("cpu")
    with torch.no_grad():
        terms = evd.loss_terms(torch.from_numpy(np.array(x_j)), b.one_hot, b.charges, b.node_mask, training,
                               **loss_draws(evd_j, params, rng, bj.node_mask, training))
    assert set(terms) == set(ref)
    for k in ref:
        tol = TOL_KL_PRIOR if k == "kl_prior" else TOL_TERMS
        np.testing.assert_allclose(terms[k].numpy(), np.asarray(ref[k]), **tol, err_msg=k)


def test_geom_loss_gradients_match_jax(setup):
    """One train step's loss and the gradient of every parameter on a
    bucketed GEOM batch (the 64 bucket)."""
    exp, jexp, ds, batches, _, evd_j, params, _ = setup
    batch = batches["big"]
    bj = jax_batch(batch)
    hist = {int(n): int(c) for n, c in zip(*np.unique(ds.data["num_atoms"], return_counts=True))}
    table = NumNodesDistribution(hist).log_prob_table
    loss_j = jax_make_loss_fn(evd_j, jexp.diffusion_cfg, jexp.dataloader_cfg, table, training=True)
    rng = jax.random.PRNGKey(3)
    (lj, _), g_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params, bj, rng)
    evd = build_evd(exp)
    load_reference_state_dict(evd, state_dict_from_jax_params(jax.device_get(params)))
    evd.train()
    loss, _ = make_loss_fn(evd, exp.diffusion_cfg, exp.dataloader_cfg, table, training=True)(
        batch.to("cpu"), None, loss_draws(evd_j, params, rng, bj.node_mask, True))
    names = [n for n, _ in evd.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in evd.named_parameters()])
    np.testing.assert_allclose(loss.item(), float(lj), rtol=1e-5)
    ref = {k[len("ddpm."):]: v for k, v in state_dict_from_jax_params(jax.device_get(g_j)).items()}
    for name, g in zip(names, grads):
        assert g.abs().max() > 0, f"{name}: no gradient reached it"
        np.testing.assert_allclose(g.numpy(), ref[name], **TOL_GRAD, err_msg=name)


def geom_layer(evd, b, n, seed, dtype=torch.float32, device="cpu"):
    """Layer 0's packed weights of ``evd`` and seeded node and edge inputs
    (the last molecule with 3 padded rows), cotangents included."""
    mc = evd.dynamics_network.model_cfg
    mp = evd.dynamics_network.interaction_layers[0].interaction
    g1, chain = ml.detached(ml.pack_message_stack(mp, mc.h_hidden_dim, mc.chi_hidden_dim, mc.xi_hidden_dim, dtype))
    g1 = {k: v.to(device) for k, v in g1.items()}
    chain = tuple(c.to(device) for c in chain)
    gen = torch.Generator().manual_seed(seed)
    se, ve, s_dim, v3 = mc.e_hidden_dim, mc.xi_hidden_dim, mc.h_hidden_dim, 3 * mc.chi_hidden_dim
    mask = torch.ones(b, n)
    mask[-1, n - 3:] = 0
    em = (mask[:, :, None] * mask[:, None, :]).reshape(b, n * n, 1)
    epack = torch.cat([torch.randn(b, n * n, se, generator=gen), torch.randn(b, n * n, 3 * ve, generator=gen),
                       torch.rand(b, n * n, 9, generator=gen) * 2 - 1, em], dim=-1) * em
    s = torch.randn(b, n, s_dim, generator=gen) * mask[..., None]
    v = torch.randn(b, n, v3, generator=gen) * mask[..., None]
    ct = (torch.randn(b, n, s_dim, generator=gen), torch.randn(b, n, v3, generator=gen))
    on = lambda t: t.to(device=device, dtype=dtype)  # noqa: E731
    return (on(s), on(v), on(epack), g1, chain), tuple(on(c) for c in ct), ve


def plain_bwd_in_chunks(args, ct, ve, chunk):
    """:func:`message_layer_bwd_plain` over the molecules in chunks of
    ``chunk``, as the kernel's wrapper cuts the batch: each chunk's node and
    edge cotangents in place, the weight grads summed in chunk order in
    float32."""
    s, v, epack, g1, chain = args
    parts = [ml.bwd_outputs(ml.message_layer_bwd_plain(
        s[b0:b0 + chunk], v[b0:b0 + chunk], epack[b0:b0 + chunk], g1, chain,
        (ct[0][b0:b0 + chunk], ct[1][b0:b0 + chunk]), ve_dim=ve)) for b0 in range(0, s.shape[0], chunk)]
    out = []
    for i, (name, first) in enumerate(parts[0]):
        tensors = [part[i][1] for part in parts]
        if name.startswith(("d_g1", "d_chain")):
            total = tensors[0].float().clone()
            for t in tensors[1:]:
                total += t.float()
            out.append((name, total.to(first.dtype)))
        else:
            out.append((name, torch.cat(tensors)))
    return out


@pytest.mark.parametrize("chunk", [5, 3, 2, 1])
def test_chunked_backward_equals_whole_batch(setup, chunk):
    """The backward cut into chunks of ``chunk`` molecules (5: one chunk; 3:
    two; 2: three, the last ragged; 1: a chunk a molecule) against the
    whole batch of 5: the decomposition the kernel's wrapper
    makes (molecules independent, weight grads summed over the chunks).
    One chunk is the whole batch's call, bit for bit.  In more chunks each
    molecule's node and edge cotangents are its own (a wrong slice would
    differ by O(1)), but the CPU's matrix products round by their row count,
    so they agree to one float32 rounding (1e-7 of max|·|);
    ``test_torch_kernel.py`` holds the kernel's own walk bit-identical on
    the card."""
    *_, evd = setup
    args, ct, ve = geom_layer(evd, 5, 9, seed=chunk)
    whole = ml.bwd_outputs(ml.message_layer_bwd_plain(*args, ct, ve_dim=ve))
    chunked = plain_bwd_in_chunks(args, ct, ve, chunk)
    assert [k for k, _ in chunked] == [k for k, _ in whole]
    for (name, got), (_, ref) in zip(chunked, whole):
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        if chunk == 5:
            assert torch.equal(got, ref), name
        elif not name.startswith(("d_g1", "d_chain")):
            assert (got - ref).abs().max() <= TOL_NODE_REL * ref.abs().max(), name
        else:
            assert (got - ref).abs().max() <= TOL_CHUNK_REL * ref.abs().max(), name


def test_chunk_plan():
    """The budget's arithmetic at the kernel's row widths (floats a row of scratch): QM9's training shape
    (width 6,128 at S=256, V=32, Se=64, Ve=16) stays one chunk, GEOM's
    192 bucket (6,040 at Se=16, Ve=8) walks 16 chunks of 4 molecules."""
    assert ml.BWD_SCRATCH_BUDGET == 4 << 30
    assert ml.bwd_chunk_molecules(29, 6128) == 208
    assert ml.bwd_chunk_molecules(192, 6040) == 4
    assert ml.bwd_chunk_molecules(96, 6040) == 19
    assert ml.bwd_chunk_molecules(400, 6040) == 1  # never fewer than one molecule


def test_geom_user_path_on_cpu(tmp_path, monkeypatch):
    """GEOM-layout files -> ``cli.train`` (bucketed batches, EMA validation,
    a sampling evaluation) -> ``cli.mol_gen_sample`` and ``cli.mol_gen_eval``
    from the checkpoint directory, at the tiny width on the CPU.  Every
    denoiser call runs one message layer a layer."""
    from bio_diffusion_torch.chem.molecule import load_molecule_xyz
    from bio_diffusion_torch.cli import mol_gen_eval, mol_gen_sample, train
    from bio_diffusion_torch.data.dataset_info import GEOM_WITH_H
    from bio_diffusion_torch.models.gcpnet import GCPNetDynamics

    data_dir = str(tmp_path / "data")
    write_geom_layout(data_dir, num_conformers=100, seed=9)
    calls = {"denoiser": 0, "layer": 0}

    def counting(fn, key):
        def wrapped(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(GCPNetDynamics, "forward", counting(GCPNetDynamics.forward, "denoiser"))
    monkeypatch.setattr(ml, "fused_message_layer", counting(ml.fused_message_layer, "layer"))
    shapes = []

    data = [f"datamodule.dataloader_cfg.data_dir={data_dir}", "datamodule.dataloader_cfg.batch_size=8"]
    trainer = train.main(GEOM_TINY + data + [
        "trainer.check_val_every_n_epoch=1", "trainer.limit_train_batches=2", "trainer.limit_val_batches=1",
        "model.diffusion_cfg.num_eval_samples=3", "model.diffusion_cfg.eval_batch_size=3",
        "--device=cpu", "--max-epochs=1", f"--workdir={tmp_path / 'train'}"])
    layers = trainer.exp.model_cfg.num_encoder_layers
    st = trainer.stats
    assert (st["steps"], st["eval_batches"], st["sample_batches"]) == (2, 1, 1)
    assert calls["denoiser"] > 0 and calls["layer"] == layers * calls["denoiser"]
    rows = trainer.loggers.loggers[0].rows
    assert np.isfinite([r["train/loss"] for r in rows if "train/loss" in r]).all()
    assert any("val/mol_stable" in r for r in rows)
    for batch in trainer._batch_iter("train"):
        n_max = int(batch.node_mask.sum(1).max())
        shapes.append((batch.node_mask.shape[1], n_max))
    assert all(pad == min(b for b in (48, 64, 96, 128, 192) if b >= n) for pad, n in shapes)

    ckpt = [f"ckpt_path={tmp_path / 'train' / 'checkpoints'}", "device=cpu", "num_samples=4",
            "sampling_batch_size=4"]
    calls.update(denoiser=0, layer=0)
    mol_gen_sample.main(GEOM_TINY + ckpt + [f"output_dir={tmp_path / 'samples'}"])
    assert calls["denoiser"] == 11 and calls["layer"] == layers * 11  # T=10: prior to decode
    files = sorted(str(p) for p in (tmp_path / "samples").rglob("*.xyz"))
    assert len(files) == 4
    symbols = set()
    for path in files:
        pos, one_hot = load_molecule_xyz(path, GEOM_WITH_H)
        assert one_hot.shape[-1] == NUM_FEATURES and np.isfinite(pos).all()
        with open(path) as f:
            symbols |= {line.split()[0] for line in f.read().splitlines()[2:] if line.strip()}
    assert symbols and symbols <= set(GEOM_WITH_H["atom_decoder"])

    calls.update(denoiser=0, layer=0)
    metrics = mol_gen_eval.main(GEOM_TINY + ckpt + data + ["num_test_passes=1",
                                                           f"output_dir={tmp_path / 'eval'}"])
    with open(tmp_path / "eval" / "eval_results.json") as f:
        saved = json.load(f)
    assert saved == metrics and np.isfinite(saved["test_nll"])
    assert calls["layer"] == layers * calls["denoiser"]

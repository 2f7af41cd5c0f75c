"""Port parity: property conditioning, against the JAX package.

The conditional QM9 configuration at the tiny width (S=16, V=4, Se=8, Ve=2,
2 layers, T=10): ``conditioning=[alpha]``, ``include_charges=False``,
``norm_values=[1, 8, 1]``.  The weights are drawn by the port from a seed
and carried into JAX through the JAX package's own reference-name import
(its template by ``jax.eval_shape``), so the same weights run in both; the
JAX draws (timesteps, noise) are rebuilt from its key splits and passed to
the port.  Float32, CPU (the port's plain message layer).

* The weight converter carries the conditional model, its wider node
  embedding included.
* The denoiser with a context against JAX ``make_fast_dynamics(interpret=
  True)`` and the JAX module path: atol 1e-4; without a context it raises.
* ``loss_terms`` with a context (training and evaluation): rtol 1e-5,
  atol 1e-6 (the KL prior); the full loss's gradients at the tolerance of
  ``test_torch_train_step.py``.
* 5 reverse steps and the decode with a context: atol 1e-4, decoded types
  identical; ``mol_gen_optimize`` over 5 steps: atol 1e-4; the fixed-noise
  property sweep of ``task=qualitative`` against the JAX sampler: atol
  1e-4, types identical.
* ``PropertiesDistribution``, ``compute_mean_mad`` and the batch contexts
  exactly equal to the JAX package's for the same seed.
* One conditional train step against JAX's ``make_train_step``.
* The empty charge channel: normalize, pack, unnormalize and
  ``analyze_samples`` equal JAX's.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_diffusion_tpu.config.schema import OptimizerConfig as JaxOptimizerConfig
from bio_diffusion_tpu.data.batch import DenseMolBatch as JaxBatch
from bio_diffusion_tpu.models.diffusion import EquivariantVariationalDiffusion as JaxEVD
from bio_diffusion_tpu.models.gcpnet import GCPNetDynamics as JaxDynamics
from bio_diffusion_tpu.models.gcpnet_fast import make_fast_dynamics
from bio_diffusion_tpu.ops.geometry import centralize as jax_centralize
from bio_diffusion_tpu.train import state as jax_state
from bio_diffusion_tpu.train.step import make_loss_fn as jax_make_loss_fn
from bio_diffusion_tpu.train.step import make_train_step as jax_make_train_step
from bio_diffusion_tpu.train.torch_import import import_state_dict
from bio_diffusion_torch.config.schema import OptimizerConfig
from bio_diffusion_torch.data.batch import iterate_dense_batches
from bio_diffusion_torch.data.synthetic import synthetic_qm9_like
from bio_diffusion_torch.models.diffusion import EquivariantVariationalDiffusion
from bio_diffusion_torch.models.distributions import NumNodesDistribution, compute_mean_mad
from bio_diffusion_torch.models.gcpnet import GCPNetDynamics
from bio_diffusion_torch.train.state import TrainState
from bio_diffusion_torch.train.step import make_loss_fn, make_train_step
from bio_diffusion_torch.train.torch_import import (
    init_random_weights,
    load_reference_state_dict,
    state_dict_from_jax_params,
)
from test_torch_common import jax_tiny_configs, tiny_configs

ATOL = 1e-4
NUM_FEATURES = 5  # five atom types, no charge channel
# the KL prior (~1e-4) is a difference of terms ~1, so it carries their
# float32 rounding (~5e-7) as an absolute error
TOL_TERMS = dict(rtol=1e-5, atol=1e-6)
TOL_GRAD = dict(rtol=2e-3, atol=2e-5)  # as tests/test_torch_train_step.py


def conditional(cfgs):
    mc, mod, lc, dc, dl = cfgs
    return (mc, dataclasses.replace(mod, conditioning=("alpha",)), lc,
            dataclasses.replace(dc, norm_values=(1.0, 8.0, 1.0)), dataclasses.replace(dl, include_charges=False))


@pytest.fixture(scope="module")
def setup():
    """Port and JAX conditional EVDs with the same weights, and a batch of 6
    synthetic molecules (N=7, padded rows) with their alpha contexts."""
    cfgs = conditional(tiny_configs())
    jcfgs = conditional(jax_tiny_configs())
    ds = synthetic_qm9_like(num_molecules=6, max_nodes=7, seed=0)
    norms = {"alpha": compute_mean_mad(ds.property_values("alpha"))}
    batch = next(iterate_dense_batches(ds, batch_size=6, shuffle=False, pad_to=7, conditioning=("alpha",),
                                       property_norms=norms))
    batch_j = JaxBatch(*(jnp.asarray(a) for a in (batch.x, batch.one_hot, batch.charges, batch.node_mask)),
                       context=jnp.asarray(batch.context))
    net = JaxDynamics(*jcfgs, remat_interactions=False)
    evd_j = JaxEVD(dynamics=net, diffusion_cfg=jcfgs[3], dataloader_cfg=jcfgs[4])
    key = jax.random.PRNGKey(0)
    _, x0 = jax_centralize(batch_j.x, batch_j.node_mask)
    shapes = jax.eval_shape(lambda: evd_j.init(key, x0, batch_j.one_hot, batch_j.charges, batch_j.node_mask,
                                               key, training=True, context=batch_j.context))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    evd = EquivariantVariationalDiffusion(GCPNetDynamics(*cfgs), cfgs[3], cfgs[4])
    init_random_weights(evd, 5)
    sd = {"ddpm." + k: v.numpy() for k, v in evd.state_dict().items()}
    params = jax.tree.map(jnp.asarray, import_state_dict(sd, template))
    hist = {int(n): int(c) for n, c in zip(*np.unique(ds.data["num_atoms"], return_counts=True))}
    table = NumNodesDistribution(hist).log_prob_table
    return cfgs, jcfgs, batch, batch_j, net, evd_j, params, evd.eval(), table


def port_evd(cfgs, params):
    evd = EquivariantVariationalDiffusion(GCPNetDynamics(*cfgs), cfgs[3], cfgs[4])
    load_reference_state_dict(evd, state_dict_from_jax_params(jax.device_get(params)))
    return evd


def raw_noise(key, b, n):
    """The standard-normal draws ``EVD.sample_noise(key, ...)`` makes."""
    kx, kh = jax.random.split(key)
    zx = jax.random.normal(kx, (b, n, 3))
    zh = jax.random.normal(kh, (b, n, NUM_FEATURES))
    return torch.from_numpy(np.concatenate([np.asarray(zx), np.asarray(zh)], -1))


def loss_draws(evd_j, params, rng, node_mask, training):
    """The draws ``loss_terms`` makes from ``rng``."""
    key_t, key_eps, _, _, key_eps0 = jax.random.split(rng, 5)
    b = node_mask.shape[0]
    t_int = jax.random.randint(key_t, (b, 1), 0 if training else 1, evd_j.diffusion_cfg.num_timesteps + 1)
    noise = lambda k: evd_j.apply(params, k, node_mask, method=JaxEVD.sample_noise)  # noqa: E731
    draws = {"t_int": t_int.astype(jnp.float32), "eps_t": noise(key_eps)}
    if not training:
        draws["eps_0"] = noise(key_eps0)
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def test_converter_carries_the_conditional_model(setup):
    cfgs, _, _, _, _, _, params, evd, _ = setup
    ours = state_dict_from_jax_params(jax.device_get(params))
    own = evd.state_dict()
    assert set(ours) == {"ddpm." + k for k in own}
    for k, v in own.items():
        np.testing.assert_array_equal(ours["ddpm." + k], v.numpy(), err_msg=k)
    # against the unconditional model, the node embedding takes one more
    # input scalar (alpha) and the output projection gives one more back
    mc, mod, lc, dc, dl = cfgs
    plain = GCPNetDynamics(mc, dataclasses.replace(mod, conditioning=()), lc, dc, dl).state_dict()
    wider = {k: (tuple(plain[k].shape), tuple(v.shape)) for k, v in evd.dynamics_network.state_dict().items()
             if plain[k].shape != v.shape}
    emb, proj = "gcp_embedding.node_embedding.scalar_out.weight", "scalar_node_projection_gcp.scalar_out"
    (e_out, e_in), (p_out, p_in) = wider[emb][0], wider[proj + ".weight"][0]
    assert wider == {emb: ((e_out, e_in), (e_out, e_in + 1)),
                     proj + ".weight": ((NUM_FEATURES + 1, p_in), (NUM_FEATURES + 2, p_in)),
                     proj + ".bias": ((NUM_FEATURES + 1,), (NUM_FEATURES + 2,))}
    reloaded = port_evd(cfgs, params)
    assert all(torch.equal(a, b) for a, b in zip(reloaded.state_dict().values(), own.values()))


def test_conditional_denoiser_matches_jax(setup):
    _, jcfgs, batch, batch_j, net, _, params, evd, _ = setup
    rng = np.random.default_rng(1)
    mask = batch.node_mask
    xh = np.concatenate([batch.x, rng.normal(size=batch.one_hot.shape).astype(np.float32)], -1) * mask[..., None]
    t = np.full((len(mask), 1), 0.6, np.float32)
    dyn = {"params": params["params"]["dynamics"]}
    args = (jnp.asarray(xh), jnp.asarray(t), jnp.asarray(mask))
    expected_module = np.asarray(jax.jit(lambda p, *a: net.apply(p, *a, context=batch_j.context))(dyn, *args))
    fast = make_fast_dynamics(*jcfgs, params, compute_dtype=None, use_pallas=True, interpret=True)
    expected_kernel = np.asarray(fast(*args, batch_j.context))
    with torch.inference_mode():
        out = evd.dynamics_network(torch.from_numpy(xh), torch.from_numpy(t), torch.from_numpy(mask),
                                   torch.from_numpy(batch.context)).numpy()
        with pytest.raises(ValueError, match="context"):
            evd.dynamics_network(torch.from_numpy(xh), torch.from_numpy(t), torch.from_numpy(mask))
    assert out.shape == xh.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, expected_kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, expected_module, atol=ATOL, rtol=0)
    # the context moves the output: it is read, not dropped
    with torch.inference_mode():
        other = evd.dynamics_network(torch.from_numpy(xh), torch.from_numpy(t), torch.from_numpy(mask),
                                     torch.from_numpy(batch.context) + 1.0).numpy()
    assert np.abs(other - out).max() > 1e-3


@pytest.mark.parametrize("training", [True, False])
def test_conditional_loss_terms_match_jax(setup, training):
    _, _, batch, batch_j, _, evd_j, params, evd, _ = setup
    rng = jax.random.PRNGKey(7)
    _, x_j = jax_centralize(batch_j.x, batch_j.node_mask)
    ref = jax.jit(lambda p, *a: evd_j.apply(p, *a, training=training, context=batch_j.context))(
        params, x_j, batch_j.one_hot, batch_j.charges, batch_j.node_mask, rng)
    draws = loss_draws(evd_j, params, rng, batch_j.node_mask, training)
    b = batch.to("cpu")
    with torch.no_grad():
        terms = evd.loss_terms(torch.from_numpy(np.array(x_j)), b.one_hot, b.charges, b.node_mask, training,
                               context=b.context, **draws)
    assert set(terms) == set(ref)
    for k in ref:
        np.testing.assert_allclose(terms[k].numpy(), np.asarray(ref[k]), **TOL_TERMS, err_msg=k)


def test_conditional_loss_gradients_match_jax(setup):
    cfgs, jcfgs, batch, batch_j, _, evd_j, params, _, table = setup
    loss_j = jax_make_loss_fn(evd_j, jcfgs[3], jcfgs[4], table, training=True)
    rng = jax.random.PRNGKey(3)
    (lj, _), g_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(params, batch_j, rng)
    evd = port_evd(cfgs, params).train()
    loss, _ = make_loss_fn(evd, cfgs[3], cfgs[4], table, training=True)(
        batch.to("cpu"), None, loss_draws(evd_j, params, rng, batch_j.node_mask, True))
    names = [n for n, _ in evd.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in evd.named_parameters()])
    np.testing.assert_allclose(loss.item(), float(lj), rtol=1e-5)
    ref = {k[len("ddpm."):]: v for k, v in state_dict_from_jax_params(jax.device_get(g_j)).items()}
    for name, g in zip(names, grads):
        assert g.abs().max() > 0, f"{name}: no gradient reached it"
        np.testing.assert_allclose(g.numpy(), ref[name], **TOL_GRAD, err_msg=name)


def test_reverse_steps_with_context_match_jax(setup):
    _, _, batch, batch_j, _, evd_j, params, evd, _ = setup
    mask, jm, ctx = batch.node_mask, batch_j.node_mask, batch_j.context
    b, n = mask.shape
    s_vals = np.arange(4, -1, -1, dtype=np.float32) / 10
    t_vals = (np.arange(4, -1, -1, dtype=np.float32) + 1) / 10
    key = jax.random.PRNGKey(9)
    key, k_init = jax.random.split(key)
    z0 = evd_j.apply(params, k_init, jm, method=JaxEVD.init_sample_noise)
    key, k_seg = jax.random.split(key)
    z_j, _, _ = evd_j.apply(params, z0, None, k_seg, jnp.asarray(s_vals), jnp.asarray(t_vals), jm, ctx,
                            method=JaxEVD.reverse_segment)
    key, k_dec = jax.random.split(key)
    xh_j = np.asarray(evd_j.apply(params, z_j, None, k_dec, jm, ctx, method=JaxEVD.decode_sample))
    noises, carry = [], k_seg
    for _ in range(5):
        carry, k1, _ = jax.random.split(carry, 3)
        noises.append(raw_noise(k1, b, n))
    tm, tc = torch.from_numpy(mask), torch.from_numpy(batch.context)
    with torch.inference_mode():
        z, _ = evd.reverse_segment(torch.from_numpy(np.array(z0)), s_vals, t_vals, tm, noises=noises, context=tc)
        np.testing.assert_allclose(z.numpy(), np.asarray(z_j), atol=ATOL, rtol=0)
        xh = evd.decode_sample(z, tm, noise=raw_noise(k_dec, b, n), context=tc).numpy()
    assert xh.shape == (b, n, 3 + NUM_FEATURES)  # no charge column
    np.testing.assert_allclose(xh[..., :3], xh_j[..., :3], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(xh[..., 3:], xh_j[..., 3:])


def test_property_sweep_matches_jax(setup):
    """``task=qualitative``'s sweep (``cli.mol_gen_eval_conditional_qm9.
    property_sweep``) against the JAX CLI's: JAX ``SegmentedSampler.run(key,
    mask, context=linspace contexts, fix_noise=True)`` at 4 frames of 19
    atoms, its draws (one ``[1, N, F]`` row each, shared by the batch) passed
    to the port: positions within 1e-4, types identical; two frames of equal
    context give bit-identical molecules, two of different context differ."""
    from bio_diffusion_tpu.train.sampling import SegmentedSampler as JaxSampler
    from bio_diffusion_torch.cli.mol_gen_eval_conditional_qm9 import SWEEP_NODES, property_sweep
    from bio_diffusion_torch.train.sampling import SegmentedSampler

    *_, evd_j, params, evd, _ = setup
    frames, n, T = 4, SWEEP_NODES, evd.T
    lo, hi, mean, mad = 10.0, 90.0, 75.0, 6.0
    props = types.SimpleNamespace(distributions={"alpha": {n: {"params": (lo, hi)}}})
    ctx = ((np.linspace(lo, hi, frames) - mean) / mad).astype(np.float32)
    jm = jnp.ones((frames, n))
    key = jax.random.PRNGKey(4)
    xh_j = JaxSampler(evd_j, params, fast="off").run(
        key, jm, context=jnp.asarray(np.broadcast_to(ctx[:, None, None], (frames, n, 1)).copy()), fix_noise=True)
    key, k_init = jax.random.split(key)
    key, k_seg = jax.random.split(key)
    draws, carry = [raw_noise(k_init, 1, n)], k_seg
    for _ in range(T):
        carry, k1, _ = jax.random.split(carry, 3)
        draws.append(raw_noise(k1, 1, n))
    key, k_dec = jax.random.split(key)
    draws.append(raw_noise(k_dec, 1, n))

    sampler = SegmentedSampler(evd, "cpu")
    xh, mask = property_sweep(sampler, None, props, "alpha", mean, mad, frames, noises=draws)
    assert mask.shape == (frames, n) and mask.all()
    np.testing.assert_allclose(xh[..., :3], xh_j[..., :3], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(xh[..., 3:], xh_j[..., 3:])
    # one noise draw for all frames: equal contexts, equal molecules
    same = np.broadcast_to(ctx[[1, 1, 2, 2]][:, None, None], (frames, n, 1)).copy()
    xs = sampler.run(mask, None, context=same, fix_noise=True, noises=draws)
    assert np.array_equal(xs[0], xs[1]) and np.array_equal(xs[2], xs[3]) and not np.array_equal(xs[1], xs[2])
    np.testing.assert_array_equal(xs[1], xh[1])


def test_mol_gen_optimize_matches_jax(setup):
    cfgs, _, batch, batch_j, _, evd_j, params, evd, _ = setup
    b, n = batch.node_mask.shape
    _, x_j = jax_centralize(batch_j.x, batch_j.node_mask)
    key = jax.random.PRNGKey(13)
    ref = np.asarray(evd_j.apply(params, key, x_j, batch_j.one_hot, batch_j.node_mask, 5, batch_j.context,
                                 method=JaxEVD.mol_gen_optimize))
    noises, carry = [], key
    for _ in range(5):
        carry, k1, _ = jax.random.split(carry, 3)
        noises.append(raw_noise(k1, b, n))
    _, k_final = jax.random.split(carry)
    noises.append(raw_noise(k_final, b, n))
    with torch.inference_mode():
        out = evd.mol_gen_optimize(torch.from_numpy(np.array(x_j)), torch.from_numpy(batch.one_hot),
                                   torch.from_numpy(batch.node_mask), 5, torch.from_numpy(batch.context),
                                   noises=noises).numpy()
    np.testing.assert_allclose(out[..., :3], ref[..., :3], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(out[..., 3:], ref[..., 3:])
    # a model with the charge channel refuses, as JAX's does
    mc, mod, lc, dc, dl = cfgs
    charged = EquivariantVariationalDiffusion(GCPNetDynamics(mc, mod, lc, dc, dataclasses.replace(
        dl, include_charges=True)), dc, dataclasses.replace(dl, include_charges=True))
    with pytest.raises(ValueError, match="include_charges"):
        charged.mol_gen_optimize(torch.zeros(1, 3, 3), torch.zeros(1, 3, 5), torch.ones(1, 3), 2)


def test_properties_and_contexts_equal_jax():
    from bio_diffusion_tpu.data.batch import collate_dense as jax_collate
    from bio_diffusion_tpu.data.batch import iterate_dense_batches as jax_iterate
    from bio_diffusion_tpu.models.distributions import PropertiesDistribution as JaxProps
    from bio_diffusion_tpu.models.distributions import compute_mean_mad as jax_mean_mad
    from bio_diffusion_torch.data.batch import broadcast_context
    from bio_diffusion_torch.models.distributions import PropertiesDistribution

    ds = synthetic_qm9_like(num_molecules=200, seed=3)
    props = {p: ds.property_values(p) for p in ("alpha", "gap")}
    norms = {p: compute_mean_mad(v) for p, v in props.items()}
    assert norms == {p: jax_mean_mad(v) for p, v in props.items()}
    ours = PropertiesDistribution(ds.data["num_atoms"], props, normalizer=norms)
    ref = JaxProps(ds.data["num_atoms"], props, normalizer=norms)
    sizes = np.random.default_rng(0).choice(sorted(ours.distributions["alpha"]), size=40)
    a = ours.sample_batch(sizes, np.random.default_rng(4))
    b = ref.sample_batch(sizes, np.random.default_rng(4))
    assert a.dtype == b.dtype == np.float32 and a.shape == (40, 2)
    np.testing.assert_array_equal(a, b)

    kw = dict(batch_size=16, pad_to=29, conditioning=("alpha", "gap"), property_norms=norms)
    for mine, theirs in zip(iterate_dense_batches(ds, rng=np.random.default_rng(2), **kw),
                            jax_iterate(ds, rng=np.random.default_rng(2), **kw)):
        assert mine.context.shape == (16, 29, 2)
        for f in ("x", "one_hot", "charges", "node_mask", "context"):
            np.testing.assert_array_equal(getattr(mine, f), np.asarray(getattr(theirs, f)), err_msg=f)
    # the sampler's contexts: drawn values broadcast to the nodes and masked
    mols = [ds.data["positions"][i, :n] for i, n in enumerate(ds.data["num_atoms"][:3])]
    ohs = [ds.data["one_hot"][i, :n] for i, n in enumerate(ds.data["num_atoms"][:3])]
    theirs = jax_collate(mols, ohs, None, 29, context=a[:3])
    np.testing.assert_array_equal(broadcast_context(a[:3], np.asarray(theirs.node_mask)),
                                  np.asarray(theirs.context))


def test_conditional_train_step_matches_jax(setup):
    cfgs, jcfgs, batch, batch_j, _, evd_j, params, _, table = setup
    optimizer = jax_state.make_optimizer(JaxOptimizerConfig())
    step_j = jax_make_train_step(evd_j, optimizer, jcfgs[3], jcfgs[4], table, donate=False)
    state_j, m_j = step_j(jax_state.create_train_state(params, optimizer), batch_j, jax.random.PRNGKey(11))

    opt_cfg = OptimizerConfig()
    evd = port_evd(cfgs, params).train()
    ema = port_evd(cfgs, params).requires_grad_(False)
    state = TrainState(list(evd.parameters()), list(ema.parameters()), opt_cfg)
    draws = loss_draws(evd_j, params, jax.random.fold_in(jax.random.PRNGKey(11), 0), batch_j.node_mask, True)
    m = make_train_step(evd, cfgs[3], cfgs[4], table)(state, batch.to("cpu"), None, draws)
    for k in ("loss", "grad_norm", "max_grad_norm"):
        np.testing.assert_allclose(m[k].item(), float(m_j[k]), rtol=1e-4, err_msg=k)
    # one AMSGrad step moves an element by about lr whatever its gradient:
    # an element with a gradient near 0 may move +lr in one and -lr in the other
    ref = {k[len("ddpm."):]: v for k, v in state_dict_from_jax_params(jax.device_get(state_j.params)).items()}
    diffs = []
    for name, p in evd.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=0, atol=2 * opt_cfg.lr, err_msg=name)
        diffs.append(np.abs(p.detach().numpy() - ref[name]).ravel())
    assert np.median(np.concatenate(diffs)) <= 1e-3 * opt_cfg.lr


def test_empty_charge_channel_matches_jax(setup):
    from bio_diffusion_tpu.data.dataset_info import get_dataset_info as jax_info
    from bio_diffusion_tpu.train.sampling import analyze_samples as jax_analyze
    from bio_diffusion_torch.train.sampling import analyze_samples

    _, _, batch, batch_j, _, evd_j, params, evd, _ = setup
    args_j = (batch_j.x, batch_j.one_hot, batch_j.charges, batch_j.node_mask)
    norm_j = evd_j.apply(params, *args_j, method=JaxEVD.normalize)
    b = batch.to("cpu")
    norm = evd.normalize(b.x, b.one_hot, b.charges, b.node_mask)
    for a, r in zip(norm, norm_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-6, atol=0)
    xh = evd.pack_xh(*norm)
    assert xh.shape[-1] == 3 + NUM_FEATURES
    np.testing.assert_allclose(xh.numpy(), np.asarray(evd_j.apply(params, *norm_j, method=JaxEVD.pack_xh)),
                               rtol=1e-6, atol=0)
    un = evd.unnormalize(norm[0], b.node_mask, norm[1], norm[2])
    un_j = evd_j.apply(params, norm_j[0], batch_j.node_mask, norm_j[1], norm_j[2], method=JaxEVD.unnormalize)
    for a, r in zip(un, un_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)
    samples = np.concatenate([batch.x, batch.one_hot], -1)  # [x | one-hot], as the conditional model decodes
    info = jax_info("QM9_second_half", False)
    assert analyze_samples(samples, batch.node_mask, info, include_charges=False) == {
        k: v for k, v in jax_analyze(samples, batch.node_mask, info, include_charges=False).items()
        if k in ("mol_stable", "atm_stable", "kl_div_atom_types")}

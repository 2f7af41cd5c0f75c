"""Port parity: self-conditioning, against the JAX package.

The tiny QM9 model of ``test_torch_common`` (S=16, V=4, Se=8, Ve=2, 2 layers,
T=10, charges) with ``self_condition=True``, and its property-conditioned
variant (``conditioning=[alpha]``, no charge channel) for the context and
for ``mol_gen_optimize``.  The weights are drawn by the port from a seed and
carried into JAX through the JAX package's reference-name import (its
template by ``jax.eval_shape``); the JAX draws are rebuilt from its key
splits and passed to the port (``loss_terms``: ``key_t, key_eps, key_sc,
key_bern, key_eps0``, the pass's ``k_noise, k_step`` from ``key_sc``; the
reverse loops: ``k1, k2`` a step).  Float32, CPU (the port's plain message
layer; JAX's module path, and ``make_fast_dynamics`` with the Pallas kernel
in interpret mode for the denoiser).

* The denoiser with a nonzero ``xh_self_cond``, with and without a
  property context, against the JAX module and the fast path: atol 1e-4
  (as ``test_torch_denoiser.py``); None reads as zeros; the doubled
  embedding inputs carry across by name.
* ``loss_terms`` in training with the self-conditioning pass taken, not
  taken, and refused because a row's t_int is T, and in evaluation:
  ``test_torch_train_step.py``'s tolerances; the full loss's gradients in
  the first two cases at the same file's gradient tolerance.
* Three AMSGrad train steps against the JAX step (as
  ``test_torch_train_step.py``).
* ``SegmentedSampler.run`` against JAX ``mol_gen_sample`` at T=10, with and
  without ``fix_noise``; ``inpaint`` (2 resamplings, jumps of 2) and
  ``mol_gen_optimize`` (5 steps, with a context): positions atol 1e-4 (or
  1e-5 of max|JAX| where the untrained chain scales them up), decoded types
  identical, charges within 1e-4 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_diffusion_tpu.config.schema import OptimizerConfig as JaxOptimizerConfig
from bio_diffusion_tpu.data.batch import DenseMolBatch as JaxBatch
from bio_diffusion_tpu.models.diffusion import EquivariantVariationalDiffusion as JaxEVD
from bio_diffusion_tpu.models.gcpnet import GCPNetDynamics as JaxDynamics
from bio_diffusion_tpu.models.gcpnet_fast import FastGCPNetDynamics, make_fast_dynamics
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
TOL_TERMS = dict(rtol=2e-4, atol=2e-4)  # as tests/test_torch_train_step.py
TOL_GRAD = dict(rtol=2e-3, atol=2e-5)  # as tests/test_torch_train_step.py


def self_conditioned(cfgs, conditional=False, learned=False):
    """The tiny configs with self-conditioning (and, optionally, one property
    context without the charge channel, or the learned VLB schedule)."""
    mc, mod, lc, dc, dl = cfgs
    dc = dataclasses.replace(dc, self_condition=True)
    if learned:
        dc = dataclasses.replace(dc, noise_schedule="learned", loss_type="vlb")
    if conditional:
        mod = dataclasses.replace(mod, conditioning=("alpha",))
        dc = dataclasses.replace(dc, norm_values=(1.0, 8.0, 1.0))
        dl = dataclasses.replace(dl, include_charges=False)
    return mc, mod, lc, dc, dl


def learned_only(cfgs):
    mc, mod, lc, dc, dl = cfgs
    return mc, mod, lc, dataclasses.replace(dc, noise_schedule="learned", loss_type="vlb"), dl


class Models:
    """A port EVD and a JAX EVD with the same weights (drawn by the port
    from ``seed``), a batch of 6 synthetic molecules (N=7, padded rows; with
    alpha contexts for a conditioned model) and its log p(N) table."""

    def __init__(self, configure, seed):
        self.cfgs, self.jcfgs = configure(tiny_configs()), configure(jax_tiny_configs())
        conditioning = tuple(self.cfgs[1].conditioning)
        ds = synthetic_qm9_like(num_molecules=6, max_nodes=7, seed=0)
        norms = {p: compute_mean_mad(ds.property_values(p)) for p in conditioning}
        self.batch = next(iterate_dense_batches(ds, batch_size=6, shuffle=False, pad_to=7,
                                                conditioning=conditioning, property_norms=norms))
        self.tbatch = self.batch.to("cpu")  # the same as torch tensors
        b = self.batch
        self.context_j = None if b.context is None else jnp.asarray(b.context)
        self.batch_j = JaxBatch(*(jnp.asarray(np.asarray(a)) for a in (b.x, b.one_hot, b.charges, b.node_mask)),
                                context=self.context_j)
        self.net = JaxDynamics(*self.jcfgs, remat_interactions=False)
        self.evd_j = JaxEVD(dynamics=self.net, diffusion_cfg=self.jcfgs[3], dataloader_cfg=self.jcfgs[4])
        key = jax.random.PRNGKey(0)
        bj = self.batch_j
        _, self.x_j = jax_centralize(bj.x, bj.node_mask)
        shapes = jax.eval_shape(lambda: self.evd_j.init(key, self.x_j, bj.one_hot, bj.charges, bj.node_mask, key,
                                                        training=True, context=self.context_j))
        self.evd = EquivariantVariationalDiffusion(GCPNetDynamics(*self.cfgs), self.cfgs[3], self.cfgs[4])
        init_random_weights(self.evd, seed)
        self.evd.eval()
        sd = {"ddpm." + k: v.numpy() for k, v in self.evd.state_dict().items()}
        self.params = jax.tree.map(jnp.asarray, import_state_dict(
            sd, jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)))
        hist = {int(n): int(c) for n, c in zip(*np.unique(ds.data["num_atoms"], return_counts=True))}
        self.table = NumNodesDistribution(hist).log_prob_table
        self.nf = self.evd.num_node_scalar_features

    @property
    def T(self):
        return self.evd.T

    def fresh_port_evd(self):
        evd = EquivariantVariationalDiffusion(GCPNetDynamics(*self.cfgs), self.cfgs[3], self.cfgs[4])
        load_reference_state_dict(evd, state_dict_from_jax_params(jax.device_get(self.params)))
        return evd

    def raw_noise(self, key, b=None, n=None):
        """The standard-normal draws ``EVD.sample_noise(key, ...)`` makes."""
        b0, n0 = self.batch.node_mask.shape
        b, n = b or b0, n or n0
        kx, kh = jax.random.split(key)
        zx, zh = jax.random.normal(kx, (b, n, 3)), jax.random.normal(kh, (b, n, self.nf))
        return torch.from_numpy(np.concatenate([np.asarray(zx), np.asarray(zh)], -1))

    def loss_draws(self, rng, training):
        """The draws JAX ``loss_terms`` makes from ``rng``, as the port takes them."""
        key_t, key_eps, key_sc, key_bern, key_eps0 = jax.random.split(rng, 5)
        b = self.batch.node_mask.shape[0]
        t_int = jax.random.randint(key_t, (b, 1), 0 if training else 1, self.T + 1)
        draws = {"t_int": torch.from_numpy(np.array(t_int, np.float32)), "eps_t": self.raw_noise(key_eps)}
        if training and self.cfgs[3].self_condition:
            k_noise, k_step = jax.random.split(key_sc)
            draws.update(sc_take=bool(jax.random.bernoulli(key_bern, 0.5)), eps_sc=self.raw_noise(k_noise),
                         eps_sc_step=self.raw_noise(k_step))
        if not training:
            draws["eps_0"] = self.raw_noise(key_eps0)
        return draws

    def sc_runs(self, rng):
        """Whether JAX ``loss_terms`` in training runs the self-conditioning
        pass for ``rng``: the Bernoulli draw and no t_int equal to T."""
        d = self.loss_draws(rng, True)
        return d["sc_take"] and not bool((d["t_int"] == self.T).any())

    def find_rng(self, want):
        """The first ``PRNGKey(i)`` whose training draws satisfy ``want(draws)``."""
        for i in range(200):
            rng = jax.random.PRNGKey(i)
            if want(self.loss_draws(rng, True)):
                return rng
        raise AssertionError("no key among the first 200 gives the wanted draws")

    def reverse_draws(self, key, steps, fix_noise=False):
        """JAX ``mol_gen_sample``'s draws from ``key`` in the port's order:
        prior, (step, self-conditioning step) a reverse step, decode."""
        b = 1 if fix_noise else None
        key, k_init = jax.random.split(key)
        draws = [self.raw_noise(k_init, b)]
        for _ in range(steps):
            key, k1, k2 = jax.random.split(key, 3)
            draws += [self.raw_noise(k1, b), self.raw_noise(k2, b)]
        _, k_final = jax.random.split(key)
        return draws + [self.raw_noise(k_final, b)]


_MODELS = {}


def models(name):
    """Built once a module: ``sc`` (QM9 with charges) and ``sc_cond``."""
    if name not in _MODELS:
        configure = {"sc": self_conditioned,
                     "sc_cond": lambda c: self_conditioned(c, conditional=True)}[name]
        _MODELS[name] = Models(configure, seed={"sc": 3, "sc_cond": 5}[name])
    return _MODELS[name]


def assert_decoded_close(out, ref, m):
    """Decoded molecules: positions within 1e-4, or 1e-5 of max|JAX| where
    the untrained chain scales them up; one-hot types identical; charges
    (rounded) within 1e-4 relative, since an unrounded value near 1e5 carries
    float32 rounding enough to round to the neighbouring integer."""
    np.testing.assert_allclose(out[..., :3], ref[..., :3], atol=max(ATOL, 1e-5 * np.abs(ref[..., :3]).max()),
                               rtol=0)
    k = 3 + m.evd.num_atom_types
    np.testing.assert_array_equal(out[..., 3:k], ref[..., 3:k])
    np.testing.assert_allclose(out[..., k:], ref[..., k:], rtol=1e-4, atol=0)


def denoiser_inputs(m, seed):
    rng = np.random.default_rng(seed)
    mask = m.batch.node_mask
    b, n = mask.shape
    xh = np.concatenate([m.batch.x, rng.normal(size=(b, n, m.nf)).astype(np.float32)], -1) * mask[..., None]
    sc = rng.normal(size=(b, n, 3 + m.nf)).astype(np.float32) * mask[..., None]
    t = np.full((b, 1), 0.6, np.float32)
    return xh, sc, t, mask


@pytest.mark.parametrize("name", ["sc", "sc_cond"])
def test_self_conditioned_denoiser_matches_jax(name):
    m = models(name)
    xh, sc, t, mask = denoiser_inputs(m, seed=1)
    ctx = m.context_j
    args = (jnp.asarray(xh), jnp.asarray(t), jnp.asarray(mask))
    dyn = {"params": m.params["params"]["dynamics"]}
    module = jax.jit(lambda p, *a, s: m.net.apply(p, *a, context=ctx, xh_self_cond=s))
    expected_module = np.asarray(module(dyn, *args, s=jnp.asarray(sc)))
    fast = make_fast_dynamics(*m.jcfgs, m.params, compute_dtype=None, use_pallas=True, interpret=True)
    expected_kernel = np.asarray(fast(*args, ctx, jnp.asarray(sc)))
    tctx = None if m.batch.context is None else torch.from_numpy(m.batch.context)
    with torch.inference_mode():
        out = m.evd.dynamics_network(torch.from_numpy(xh), torch.from_numpy(t), torch.from_numpy(mask), tctx,
                                     xh_self_cond=torch.from_numpy(sc)).numpy()
        zeros = m.evd.dynamics_network(torch.from_numpy(xh), torch.from_numpy(t), torch.from_numpy(mask), tctx,
                                       xh_self_cond=torch.zeros(xh.shape)).numpy()
        none = m.evd.dynamics_network(torch.from_numpy(xh), torch.from_numpy(t), torch.from_numpy(mask),
                                      tctx).numpy()
    assert out.shape == xh.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, expected_kernel, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, expected_module, atol=ATOL, rtol=0)
    # the estimate is read (it moves the output), and None is zeros
    np.testing.assert_array_equal(none, zeros)
    assert np.abs(out - zeros).max() > 1e-3
    np.testing.assert_allclose(zeros, np.asarray(module(dyn, *args, s=None)), atol=ATOL, rtol=0)


def test_doubled_inputs_carry_across():
    """Every input block of the embeddings is doubled, the output projection
    is not; the converter carries the model by name, strictly."""
    m = models("sc")
    mc, mod, lc, dc, dl = m.cfgs
    plain = GCPNetDynamics(mc, mod, lc, dataclasses.replace(dc, self_condition=False), dl).state_dict()
    ours = m.evd.dynamics_network.state_dict()
    wider = {k for k in ours if plain[k].shape != ours[k].shape}
    assert wider == {"gcp_embedding.edge_embedding.vector_down.weight",
                     "gcp_embedding.edge_embedding.vector_down_frames.weight",
                     "gcp_embedding.edge_embedding.scalar_out.weight",
                     "gcp_embedding.node_embedding.vector_down.weight",
                     "gcp_embedding.node_embedding.vector_down_frames.weight",
                     "gcp_embedding.node_embedding.scalar_out.weight"}
    # the node embedding takes the estimate's 6 features as 6 more scalars
    assert ours["gcp_embedding.node_embedding.scalar_out.weight"].shape[1] - \
        plain["gcp_embedding.node_embedding.scalar_out.weight"].shape[1] == 6
    converted = state_dict_from_jax_params(jax.device_get(m.params))
    assert set(converted) == {"ddpm." + k for k in m.evd.state_dict()}
    reloaded = m.fresh_port_evd()
    assert all(torch.equal(a, b) for a, b in zip(reloaded.state_dict().values(), m.evd.state_dict().values()))


def loss_cases(m):
    return {
        "taken": m.find_rng(lambda d: d["sc_take"] and not (d["t_int"] == m.T).any()),
        "not_taken": m.find_rng(lambda d: not d["sc_take"] and not (d["t_int"] == m.T).any()),
        "t_is_T": m.find_rng(lambda d: d["sc_take"] and (d["t_int"] == m.T).any()),
    }


def check_loss_terms(m, rng, training, tol=TOL_TERMS):
    bj = m.batch_j
    ref = jax.jit(lambda p, r: m.evd_j.apply(p, m.x_j, bj.one_hot, bj.charges, bj.node_mask, r,
                                             training=training, context=m.context_j))(m.params, rng)
    b = m.batch
    ctx = None if b.context is None else torch.from_numpy(b.context)
    evd = m.fresh_port_evd().train(training)
    with torch.no_grad():
        terms = evd.loss_terms(torch.from_numpy(np.array(m.x_j)), torch.from_numpy(b.one_hot),
                               torch.from_numpy(b.charges), torch.from_numpy(b.node_mask), training,
                               context=ctx, **m.loss_draws(rng, training))
    assert set(terms) == set(ref)
    for k in ref:
        np.testing.assert_allclose(terms[k].numpy(), np.asarray(ref[k]), **tol, err_msg=k)


@pytest.mark.parametrize("case", ["taken", "not_taken", "t_is_T", "eval"])
def test_self_conditioned_loss_terms_match_jax(case):
    m = models("sc")
    if case == "eval":
        check_loss_terms(m, jax.random.PRNGKey(7), training=False)
        return
    rng = loss_cases(m)[case]
    assert m.sc_runs(rng) == (case == "taken")
    check_loss_terms(m, rng, training=True)


def test_the_pass_moves_the_loss():
    """With the pass taken, the loss differs from the same draws without it
    (the estimate reaches the denoiser)."""
    m = models("sc")
    draws = m.loss_draws(loss_cases(m)["taken"], True)
    b = m.batch
    args = [torch.from_numpy(np.array(m.x_j)), torch.from_numpy(b.one_hot), torch.from_numpy(b.charges),
            torch.from_numpy(b.node_mask), True]
    with torch.no_grad():
        on = m.evd.loss_terms(*args, **draws)["error_t"]
        off = m.evd.loss_terms(*args, **dict(draws, sc_take=False))["error_t"]
    assert (on - off).abs().max() > 1e-4


def check_loss_gradients(m, rng, loss_rtol=1e-5, tol=TOL_GRAD, atol_of_max=0.0, rounding_bound=()):
    """The full training loss and its gradients against JAX's; each
    parameter also within ``atol_of_max`` of its largest JAX gradient; the
    gradients of ``rounding_bound`` only finite (their float32 values are
    rounding-bound in both frameworks)."""
    loss_j = jax_make_loss_fn(m.evd_j, m.jcfgs[3], m.jcfgs[4], m.table, training=True)
    (lj, _), g_j = jax.jit(jax.value_and_grad(loss_j, has_aux=True))(m.params, m.batch_j, rng)
    evd = m.fresh_port_evd().train()
    loss, _ = make_loss_fn(evd, m.cfgs[3], m.cfgs[4], m.table, training=True)(m.tbatch, None,
                                                                              m.loss_draws(rng, True))
    names = [n for n, _ in evd.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in evd.named_parameters()])
    np.testing.assert_allclose(loss.item(), float(lj), rtol=loss_rtol)
    ref = {k[len("ddpm."):]: v for k, v in state_dict_from_jax_params(jax.device_get(g_j)).items()}
    assert set(ref) == set(names)
    for name, g in zip(names, grads):
        assert bool(torch.isfinite(g).all()), name
        if name in rounding_bound:
            continue
        assert g.abs().max() > 0, f"{name}: no gradient reached it"
        atol = max(tol["atol"], atol_of_max * float(np.abs(ref[name]).max()))
        np.testing.assert_allclose(g.numpy(), ref[name], rtol=tol["rtol"], atol=atol, err_msg=name)


@pytest.mark.parametrize("case", ["taken", "not_taken"])
def test_self_conditioned_loss_gradients_match_jax(case):
    m = models("sc")
    check_loss_gradients(m, loss_cases(m)[case])


def check_three_steps(m, key):
    """Three train steps of the JAX step (the packed forward) and the
    port's from the same weights with JAX's draws: loss, grad norm and clip
    threshold per step rtol 1e-4, the parameters and EMA within 2 lr a step
    (test_torch_train_step.py) -> the port's parameters by name."""
    mc, mod, lc, dc, dl = m.jcfgs
    fast = FastGCPNetDynamics(mc, mod, lc, dc, dl, use_pallas=False)
    optimizer = jax_state.make_optimizer(JaxOptimizerConfig())
    step_j = jax_make_train_step(m.evd_j.clone(dynamics=fast), optimizer, dc, dl, m.table, donate=False)
    state_j = jax_state.create_train_state(m.params, optimizer)
    opt_cfg = OptimizerConfig()
    evd, ema = m.fresh_port_evd().train(), m.fresh_port_evd().requires_grad_(False)
    state = TrainState(list(evd.parameters()), list(ema.parameters()), opt_cfg)
    step = make_train_step(evd, m.cfgs[3], m.cfgs[4], m.table)
    for s in range(3):
        state_j, m_j = step_j(state_j, m.batch_j, key)
        metrics = step(state, m.tbatch, None, m.loss_draws(jax.random.fold_in(key, s), True))
        for k in ("loss", "grad_norm", "max_grad_norm"):
            np.testing.assert_allclose(metrics[k].item(), float(m_j[k]), rtol=1e-4, err_msg=f"step {s}: {k}")
    assert state.count == int(state_j.step) == 3
    tol = 2 * opt_cfg.lr * 3
    for tree, module in ((state_j.params, evd), (state_j.ema_params, ema)):
        ref = {k[len("ddpm."):]: v for k, v in state_dict_from_jax_params(jax.device_get(tree)).items()}
        diffs = []
        for name, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), ref[name], rtol=0, atol=tol, err_msg=name)
            diffs.append(np.abs(p.detach().numpy() - ref[name]).ravel())
        assert np.median(np.concatenate(diffs)) <= 1e-3 * opt_cfg.lr
    return dict(evd.named_parameters())


def mixed_key(m):
    """A key whose three steps take the pass at least once and skip it at least once."""
    for i in range(200):
        key = jax.random.PRNGKey(i)
        runs = {m.sc_runs(jax.random.fold_in(key, s)) for s in range(3)}
        if runs == {True, False}:
            return key
    raise AssertionError("no key among the first 200 mixes the two branches")


def test_self_conditioned_train_steps_match_jax():
    m = models("sc")
    check_three_steps(m, mixed_key(m))


def check_sampler(m, fix_noise, num_timesteps=None, key=jax.random.PRNGKey(21)):
    """``SegmentedSampler.run`` against JAX ``mol_gen_sample`` (the EVD's
    scanned loop; ``fix_self_conditioning_noise`` = ``fix_noise``)."""
    from bio_diffusion_torch.train.sampling import SegmentedSampler

    mask = m.batch.node_mask
    T_s = m.T if num_timesteps is None else num_timesteps
    xh_j, _ = jax.jit(lambda p, k, msk: m.evd_j.apply(
        p, k, msk, num_timesteps, m.context_j, fix_noise, fix_noise, method=JaxEVD.mol_gen_sample))(
        m.params, key, jnp.asarray(mask))
    xh_j = np.asarray(xh_j)
    ctx = None if m.batch.context is None else m.batch.context
    draws = m.reverse_draws(key, T_s, fix_noise)
    xh = SegmentedSampler(m.evd, "cpu").run(mask, None, num_timesteps, fix_noise, ctx, noises=draws)
    assert xh.shape == xh_j.shape and np.isfinite(xh).all()
    assert_decoded_close(xh, xh_j, m)
    real = mask > 0
    assert np.all(xh[~real] == 0)
    with pytest.raises(ValueError, match="noises"):
        SegmentedSampler(m.evd, "cpu").run(mask, None, num_timesteps, fix_noise, ctx, noises=draws[:-1])
    return xh


@pytest.mark.parametrize("fix_noise", [False, True])
def test_self_conditioned_sampler_matches_jax(fix_noise):
    check_sampler(models("sc"), fix_noise)


def inpaint_draws(m, key, steps):
    """JAX ``inpaint``'s draws from ``key``: prior, (known, reverse,
    self-conditioning, jump) a step, decode."""
    key, k_init = jax.random.split(key)
    draws = [m.raw_noise(k_init)]
    for _ in range(steps):
        key, k_known, k_unknown, k_sc, k_jump = jax.random.split(key, 5)
        draws += [m.raw_noise(k) for k in (k_known, k_unknown, k_sc, k_jump)]
    _, k_final = jax.random.split(key)
    return draws + [m.raw_noise(k_final)]


def check_inpaint(m, r=2, j=2, jax_evd=None, jax_params=None):
    """``inpaint`` against JAX's on ``jax_evd`` (default: the module-path EVD)."""
    evd_j, params = (m.evd_j, m.params) if jax_evd is None else (jax_evd, jax_params)
    b = m.batch
    fixed = np.zeros_like(b.node_mask)
    fixed[:, :2] = 1.0
    args = (b.x, b.one_hot, b.charges, b.node_mask, fixed)
    key = jax.random.PRNGKey(17)
    ref = np.asarray(jax.jit(lambda p, k, *a: evd_j.apply(p, k, *a, r, j, None, m.context_j,
                                                          method=JaxEVD.inpaint))(
        params, key, *(jnp.asarray(np.asarray(a)) for a in args)))
    steps = len(m.evd.repaint_step_arrays(m.evd.get_repaint_schedule(r, j, m.T), j)[0])
    ctx = None if b.context is None else torch.from_numpy(b.context)
    with torch.inference_mode():
        out = m.evd.inpaint(*(torch.from_numpy(np.asarray(a)) for a in args), r, j, context=ctx,
                            noises=inpaint_draws(m, key, steps)).numpy()
    assert_decoded_close(out, ref, m)


def test_self_conditioned_inpaint_matches_jax():
    check_inpaint(models("sc"))


def check_optimize(m, steps=5, jax_evd=None, jax_params=None):
    """``mol_gen_optimize`` against JAX's on ``jax_evd`` (default: the module-path EVD)."""
    evd_j, params = (m.evd_j, m.params) if jax_evd is None else (jax_evd, jax_params)
    b = m.batch
    key = jax.random.PRNGKey(13)
    ref = np.asarray(jax.jit(lambda p, k: evd_j.apply(p, k, m.x_j, m.batch_j.one_hot, m.batch_j.node_mask, steps,
                                                      m.context_j, method=JaxEVD.mol_gen_optimize))(params, key))
    draws, carry = [], key
    for _ in range(steps):
        carry, k1, k2 = jax.random.split(carry, 3)
        draws += [m.raw_noise(k1), m.raw_noise(k2)]
    _, k_final = jax.random.split(carry)
    draws.append(m.raw_noise(k_final))
    args = (torch.from_numpy(np.array(m.x_j)), torch.from_numpy(b.one_hot), torch.from_numpy(b.node_mask), steps,
            torch.from_numpy(b.context))
    with torch.inference_mode():
        out = m.evd.mol_gen_optimize(*args, noises=draws).numpy()
        with pytest.raises(ValueError, match=f"need {2 * steps + 1} draws"):
            m.evd.mol_gen_optimize(*args, noises=draws[:steps + 1])
    assert_decoded_close(out, ref, m)


def test_self_conditioned_mol_gen_optimize_matches_jax():
    check_optimize(models("sc_cond"))

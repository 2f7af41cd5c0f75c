"""The port's checkpoints, resume, warm start and ``load_model``.

* A save/restore round trip is bit-identical: weights, EMA weights, the
  AMSGrad moments and count, the grad-norm queue and its position;
  ``max_to_keep`` holds; a Trainer on the same workdir resumes at the saved
  step and trains on from it.
* A reference ``.ckpt`` that the JAX package's ``export_state_dict`` writes
  from a 2-layer model warm-starts a 3-layer port model: the loaded and the
  skipped names are those of the JAX package's name-and-shape intersection
  (``merge_partial`` over the converted checkpoint), mapped through the
  reference names, and the loaded weights equal the JAX ``warm_start_params``
  result.
* ``cli.common.load_model`` and the JAX package's load the same exported
  ``.ckpt`` and give the same denoiser output (float32, within 1e-5 of
  max|out|); a port checkpoint directory loads the trainer's EMA weights
  (or, asked, its raw weights) and a params file its weights, bit for bit.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bio_diffusion_torch.config.build import build_experiment
from bio_diffusion_torch.config.loader import default_config_dir, load_config
from bio_diffusion_torch.train import checkpoints as ck
from bio_diffusion_torch.train.loop import Trainer
from test_torch_common import TINY_OVERRIDES, jax_tiny_configs, tiny_batch

TRAIN = ["experiment=qm9_mol_gen_ddpm"] + TINY_OVERRIDES + [
    "datamodule.dataloader_cfg.batch_size=16", "model.diffusion_cfg.sample_during_training=false",
    "trainer.check_val_every_n_epoch=1", "trainer.limit_val_batches=1"]


def port_trainer(workdir, extra=()):
    exp = build_experiment(load_config(default_config_dir(), "train", TRAIN + list(extra)))
    return Trainer(exp, str(workdir), "cpu")


def train_state_tensors(trainer):
    st = trainer.state
    return {"params": list(trainer.evd.parameters()), "ema": list(trainer.evd_ema.parameters()),
            "mu": st.mu, "nu": st.nu, "nu_max": st.nu_max, "gradnorm": [st.gradnorm_buffer]}


def test_round_trip_is_exact_and_resume_continues(tmp_path):
    trainer = port_trainer(tmp_path)
    trainer.fit(max_epochs=1, max_steps=3)
    assert trainer.state.count == 3 and ck.latest_step(trainer.ckpt_dir) == 3
    saved = {k: [t.detach().clone() for t in v] for k, v in train_state_tensors(trainer).items()}

    resumed = port_trainer(tmp_path)
    resumed.init_state()
    assert resumed.start_step == 3 and resumed.state.count == 3
    assert resumed.state.gradnorm_count == trainer.state.gradnorm_count
    for key, tensors in train_state_tensors(resumed).items():
        assert len(tensors) == len(saved[key])
        for a, b in zip(tensors, saved[key]):
            assert a.dtype == b.dtype and torch.equal(a, b), key
    # the payload is also a reference-style checkpoint of the raw weights
    payload = ck.load_checkpoint(trainer.ckpt_dir)
    assert set(payload) == {"state_dict", "ema_state_dict", "optimizer", "gradnorm", "step"}
    assert all(k.startswith("ddpm.dynamics_network.") for k in payload["state_dict"])

    resumed.fit(max_epochs=1, max_steps=5)
    assert resumed.state.count == 5 and resumed.stats["steps"] == 2
    assert [r["step"] for r in resumed.loggers.loggers[0].rows if "train/loss" in r] == [5]
    assert ck.latest_step(trainer.ckpt_dir) == 5


def test_max_to_keep(tmp_path):
    trainer = port_trainer(tmp_path)
    trainer.init_state()
    for step in range(1, 6):
        ck.save_checkpoint(trainer.ckpt_dir, trainer.evd, trainer.evd_ema, trainer.state,
                           trainer.state.full_moments(), step=step)
    assert sorted(os.listdir(trainer.ckpt_dir)) == ["step_3.pt", "step_4.pt", "step_5.pt"]
    assert ck.latest_step(trainer.ckpt_dir) == 5 and ck.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ck.load_checkpoint(str(tmp_path / "none"))


def shaped_like(tree, seed, scale=0.2):
    """numpy arrays of the shapes of ``tree`` (ShapeDtypeStructs), drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: (scale * rng.normal(size=s.shape)).astype(s.dtype), tree)


def jax_params(layers, seed):
    """The JAX EVD params tree of a ``layers``-layer tiny GCPNet, with values
    drawn from ``seed`` (its shapes by ``jax.eval_shape``: an eager flax init
    takes tens of seconds on the CPU)."""
    from bio_diffusion_tpu.models.gcpnet import GCPNetDynamics as JaxDynamics

    mc, mod, lc, dc, dl = jax_tiny_configs()
    net = JaxDynamics(dataclasses.replace(mc, num_encoder_layers=layers), mod, lc, dc, dl,
                      remat_interactions=False)
    xh, t, mask = tiny_batch()
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0), jnp.asarray(xh), jnp.asarray(t), jnp.asarray(mask))
    return {"params": {"dynamics": shaped_like(shapes["params"], seed)}}


def export_ckpt(params, path):
    from bio_diffusion_tpu.train.torch_import import export_state_dict

    sd = {k: torch.from_numpy(np.array(v)) for k, v in export_state_dict(params).items()}
    torch.save({"state_dict": sd}, path)
    return sd


def reference_names(jax_paths, params):
    """The reference names of the leaves of ``params`` at or under the JAX
    params paths ("/params/dynamics/..."; a skipped subtree is one path)."""
    from bio_diffusion_tpu.train.torch_import import export_state_dict, flatten_params, unflatten

    leaves = flatten_params(params)
    picked = {k: np.zeros(1) for k in leaves
              if any(k == p.strip("/") or k.startswith(p.strip("/") + "/") for p in jax_paths)}
    return sorted(export_state_dict(unflatten(picked)))


def test_warm_start_matches_jax(tmp_path):
    from bio_diffusion_tpu.train.checkpoints import merge_partial as jax_merge_partial
    from bio_diffusion_tpu.train.checkpoints import warm_start_params as jax_warm_start
    from bio_diffusion_tpu.train.torch_import import convert_state_dict, export_state_dict, unflatten

    ckpt = str(tmp_path / "two_layers.ckpt")
    sd = export_ckpt(jax_params(2, seed=0), ckpt)
    p3 = jax_params(3, seed=1)
    _, jax_loaded, jax_skipped = jax_merge_partial(p3, {"params": unflatten(convert_state_dict(sd))})
    jax_merged, _, _ = jax_warm_start(ckpt, p3)

    trainer = port_trainer(tmp_path / "run", ["model.model_cfg.num_encoder_layers=3",
                                              f"trainer.warm_start_ckpt={ckpt}"])
    template = ck.reference_state_dict(trainer.evd)
    merged, n_loaded, skipped = ck.warm_start_params(ckpt, template)
    assert reference_names(jax_loaded, p3) == sorted(k for k in template if k not in skipped)
    assert reference_names(jax_skipped, p3) == sorted(skipped)
    assert n_loaded == len(jax_loaded) == 110 and len(skipped) == 46
    assert all(".interaction_layers.2." in k for k in skipped)

    trainer.init_state()  # the Trainer warm-starts from trainer.warm_start_ckpt
    ours = ck.reference_state_dict(trainer.evd)
    ema = ck.reference_state_dict(trainer.evd_ema)
    ref = export_state_dict(jax_merged)
    for name in template:
        if name in skipped:
            assert torch.equal(ours[name], template[name]), name  # kept fresh
        else:
            assert torch.equal(ours[name], sd[name]) and np.array_equal(ours[name].numpy(), ref[name]), name
        assert torch.equal(ema[name], ours[name])


def test_load_model_matches_jax_and_reads_port_checkpoints(tmp_path, monkeypatch):
    from bio_diffusion_tpu.cli import common as jax_common
    from bio_diffusion_tpu.config.build import build_experiment as jax_build_experiment
    from bio_diffusion_tpu.config.loader import load_config as jax_load_config
    from bio_diffusion_torch.cli.common import load_model

    ckpt = str(tmp_path / "exported.ckpt")
    export_ckpt(jax_params(2, seed=3), ckpt)
    # JAX's load_model imports the checkpoint strictly into a template of
    # init_params's tree; a template of zeros of the same shapes gives the
    # same params without the eager flax init
    init_params = jax_common.init_params
    monkeypatch.setattr(jax_common, "init_params", lambda exp, evd: jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), jax.eval_shape(lambda: init_params(exp, evd))))
    overrides = TINY_OVERRIDES + ["precision=fp32"]
    jexp = jax_build_experiment(jax_load_config(default_config_dir(), "mol_gen_sample", overrides))
    jevd, params = jax_common.load_model(jexp, ckpt)
    exp = build_experiment(load_config(default_config_dir(), "mol_gen_sample", overrides))
    evd = load_model(exp, ckpt, "cpu")

    xh, t, mask = tiny_batch(b=3, n=6, seed=4)
    denoise = jax.jit(lambda p, *a: jevd.apply(p, *a, method=lambda m, *b: m.dynamics(*b)))
    ref = np.asarray(denoise(params, jnp.asarray(xh), jnp.asarray(t), jnp.asarray(mask)))
    with torch.no_grad():
        out = evd.dynamics_network(*(torch.from_numpy(a) for a in (xh, t, mask))).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()

    trainer = port_trainer(tmp_path / "run")
    trainer.fit(max_epochs=1, max_steps=2)
    for prefer_ema, model in ((True, trainer.evd_ema), (False, trainer.evd)):
        loaded = load_model(trainer.exp, trainer.ckpt_dir, "cpu", prefer_ema=prefer_ema)
        assert all(torch.equal(a, b) for a, b in zip(loaded.parameters(), model.parameters()))
    step_file = ck.checkpoint_path(trainer.ckpt_dir, ck.latest_step(trainer.ckpt_dir))
    loaded = load_model(trainer.exp, step_file, "cpu")  # a step file read as a reference .ckpt
    assert all(torch.equal(a, b) for a, b in zip(loaded.parameters(), trainer.evd.parameters()))
    params_file = str(tmp_path / "ema_params")
    ck.save_params(params_file, trainer.evd_ema)
    loaded = load_model(trainer.exp, params_file, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(loaded.parameters(), trainer.evd_ema.parameters()))
    raw = load_model(trainer.exp, step_file, "cpu")
    ck.restore_params(params_file, raw)  # the raw weights overwritten by the EMA's
    assert all(torch.equal(a, b) for a, b in zip(raw.parameters(), trainer.evd_ema.parameters()))

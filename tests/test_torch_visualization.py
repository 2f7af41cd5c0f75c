"""Port parity: the denoising chain and its renderings, against the JAX package.

* ``chem/visualization.py``: ``save_chain_frames`` writes the same files as
  the JAX package's for the same frame array (T divisible by
  ``keep_frames`` or not; the last *selected* frame repeated 10 times),
  byte for byte; frames the port selected already pass through unchanged;
  the scalar ``get_bond_order`` equals JAX's and the batch version; the PNG
  and GIF round trip of JAX ``test_visualization_roundtrip`` gives the same
  pixels; without matplotlib or imageio ``can_render`` says so once.
* The chain itself: ``SegmentedSampler.run(frame_steps=)`` with the JAX draws
  (rebuilt from ``mol_gen_sample``'s key splits) against JAX
  ``mol_gen_sample(return_frames=T)`` at the tiny width: the decoded
  molecule within 1e-4 (one-hot identical); the kept frames within 1e-4 or
  1e-5 of max|JAX| of the frame's positions or features, whichever is
  larger (the untrained chain scales the state up to ~6e3 in 10 steps,
  float32 rounding then exceeds 1e-4).
* ``ddpm_mode=chain`` end to end on the CPU: JAX ``test_cli.py::
  test_sample_cli_chain_mode``'s counts (T=10, ``keep_frames=5``: 15 frame
  files, one GIF) and the metrics tail.
"""

import filecmp
import glob
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_common import TINY_OVERRIDES, jax_tiny_configs, tiny_configs
from test_torch_diffusion import jax_raw_noise

ATOL = 1e-4
TOL_REL = 1e-5  # of max|JAX| where the untrained chain scales the state up


def assert_state_close(ours, ref, what):
    """Positions and features apart, each within max(ATOL, TOL_REL * max|ref|)."""
    for part, sl in (("positions", slice(0, 3)), ("features", slice(3, None))):
        scale = float(np.abs(ref[..., sl]).max())
        np.testing.assert_allclose(ours[..., sl], ref[..., sl], rtol=0, atol=max(ATOL, TOL_REL * scale),
                                   err_msg=f"{what} {part}")


def qm9_info():
    from bio_diffusion_torch.data.dataset_info import QM9_WITH_H

    return QM9_WITH_H


@pytest.mark.parametrize("t,keep", [(8, 4), (10, 3), (7, 100), (1000, 100)])
def test_save_chain_frames_matches_jax(tmp_path, t, keep):
    from bio_diffusion_torch.chem.visualization import chain_frame_steps, save_chain_frames
    from bio_diffusion_tpu.chem.visualization import save_chain_frames as jax_save_chain_frames

    rng = np.random.default_rng(t)
    n = 5
    frames = rng.normal(size=(t, n, 9)).astype(np.float32)
    mask = np.ones(n, np.float32)
    mask[-1] = 0
    ours = save_chain_frames(frames, mask, qm9_info(), str(tmp_path / "ours"), keep_frames=keep)
    theirs = jax_save_chain_frames(frames, mask, qm9_info(), str(tmp_path / "theirs"), keep_frames=keep)
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
    assert all(filecmp.cmp(a, b, shallow=False) for a, b in zip(ours, theirs))
    steps = chain_frame_steps(t, keep)
    assert len(ours) == len(steps) + 10
    # the repeated frame is the last selected step's state: at T=1000 the
    # state after step 990, not step 999's
    assert filecmp.cmp(ours[-1], ours[len(steps) - 1], shallow=False)
    assert steps[-1] == {(8, 4): 6, (10, 3): 9, (7, 100): 6, (1000, 100): 990}[(t, keep)]
    # frames selected already pass through with keep_frames=len
    again = save_chain_frames(frames[steps], mask, qm9_info(), str(tmp_path / "again"), keep_frames=len(steps))
    assert all(filecmp.cmp(a, b, shallow=False) for a, b in zip(again, ours))


def test_get_bond_order_matches_jax_and_the_batch_version():
    from bio_diffusion_torch.chem.stability import get_bond_order, get_bond_order_batch, ensure_bond_tables
    from bio_diffusion_tpu.chem.stability import get_bond_order as jax_get_bond_order

    info = ensure_bond_tables(dict(qm9_info()))
    decoder = info["atom_decoder"]
    rng = np.random.default_rng(0)
    a1, a2 = rng.integers(0, len(decoder), 400), rng.integers(0, len(decoder), 400)
    dist = rng.uniform(0.6, 2.2, 400)
    ours = [get_bond_order(decoder[i], decoder[j], d) for i, j, d in zip(a1, a2, dist)]
    assert ours == [jax_get_bond_order(decoder[i], decoder[j], d) for i, j, d in zip(a1, a2, dist)]
    assert ours == list(get_bond_order_batch(a1, a2, dist, info))
    assert set(ours) >= {0, 1, 2, 3}


def test_visualization_roundtrip(tmp_path):
    """JAX ``test_aux_components.py::test_visualization_roundtrip``'s case in
    both packages: the same PNGs (pixels) and a GIF of the chain."""
    import imageio.v2 as imageio

    from bio_diffusion_torch.chem.molecule import save_xyz_files
    from bio_diffusion_torch.chem.visualization import save_chain_frames, visualize_chain, visualize_mols
    from bio_diffusion_tpu.chem import visualization as jax_viz

    rng = np.random.default_rng(0)
    n = 5
    pos = rng.normal(size=(2, n, 3)) * 1.5
    one_hot = np.eye(5)[rng.integers(0, 5, (2, n))]
    mask = np.ones((2, n))
    for who in ("ours", "theirs"):
        save_xyz_files(str(tmp_path / who), pos, one_hot, mask, qm9_info())
    pngs = visualize_mols(str(tmp_path / "ours"), qm9_info(), max_num=2)
    jax_pngs = jax_viz.visualize_mols(str(tmp_path / "theirs"), qm9_info(), max_num=2)
    assert len(pngs) == 2 and all(os.path.exists(p) for p in pngs)
    for a, b in zip(pngs, jax_pngs):
        np.testing.assert_array_equal(imageio.imread(a), imageio.imread(b))

    frames = rng.normal(size=(8, n, 9))
    save_chain_frames(frames, mask[0], qm9_info(), str(tmp_path / "chain"), keep_frames=4)
    jax_viz.save_chain_frames(frames, mask[0], qm9_info(), str(tmp_path / "jax_chain"), keep_frames=4)
    gif = visualize_chain(str(tmp_path / "chain"), qm9_info())
    jax_gif = jax_viz.visualize_chain(str(tmp_path / "jax_chain"), qm9_info())
    assert gif and os.path.exists(gif)
    assert len(glob.glob(str(tmp_path / "chain" / "chain_*.png"))) == 14
    ours, theirs = imageio.mimread(gif), imageio.mimread(jax_gif)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_can_render_explains_once(monkeypatch, caplog):
    import importlib.util

    from bio_diffusion_torch.chem import visualization as viz

    assert viz.can_render()  # both installed here
    monkeypatch.setattr(viz, "_explained", False)
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None if name == "imageio" else object())
    monkeypatch.setattr(viz.log, "propagate", True)
    with caplog.at_level(logging.WARNING, logger=viz.log.name):
        assert not viz.can_render() and not viz.can_render()
    assert [r.getMessage() for r in caplog.records] == [
        "No PNG or GIF renderings: imageio not installed (the xyz files are written)"]


@pytest.fixture(scope="module")
def models():
    """The tiny QM9 EVD in both packages with the same weights: drawn by the
    port, carried into a ``jax.eval_shape`` template by the JAX package's
    reference-name import (no eager flax init)."""
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


def jax_chain_draws(key, b, n, steps):
    """The raw draws of JAX ``mol_gen_sample(key, ...)``: ``key, k_init =
    split(key)``, per step ``key, k1, k2 = split(key, 3)`` (k1's), then
    ``key, k_final = split(key)``."""
    key, k_init = jax.random.split(key)
    draws = [jax_raw_noise(k_init, b, n)]
    for _ in range(steps):
        key, k1, _ = jax.random.split(key, 3)
        draws.append(jax_raw_noise(k1, b, n))
    key, k_final = jax.random.split(key)
    return draws + [jax_raw_noise(k_final, b, n)]


@pytest.mark.parametrize("keep", [5, 3])
def test_chain_frames_match_jax(models, tmp_path, keep):
    from bio_diffusion_torch.chem.molecule import load_molecule_xyz
    from bio_diffusion_torch.chem.visualization import chain_frame_steps
    from bio_diffusion_torch.cli.mol_gen_sample import sample_chain
    from bio_diffusion_torch.train.sampling import SegmentedSampler, make_node_mask

    jax_evd, evd_params, evd = models
    T = evd.T
    mask = make_node_mask(np.array([6]), 7)
    key = jax.random.PRNGKey(11)
    xh_j, frames_j = jax.jit(lambda p, k, m: jax_evd.apply(p, k, m, num_timesteps=T, return_frames=T,
                                                           method=jax_evd.mol_gen_sample))(
        evd_params, key, jnp.asarray(mask))
    xh_j, frames_j = np.asarray(xh_j), np.asarray(frames_j)
    draws = jax_chain_draws(key, 1, 7, T)

    steps = chain_frame_steps(T, keep)
    xh, frames = SegmentedSampler(evd, "cpu").run(mask, None, T, noises=draws, frame_steps=steps)
    assert frames.shape == (len(steps), 1, 7, 9)
    for i, k in enumerate(steps):
        assert_state_close(frames[i], frames_j[k], f"frame of step {k}")
    assert np.all(frames[:, 0, 6] == 0)  # the padded row
    np.testing.assert_allclose(xh[..., :3], xh_j[..., :3], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(xh[..., 3:], xh_j[..., 3:])

    # the files the CLI writes: the kept frames, then the last kept one 10 times
    out = sample_chain(SegmentedSampler(evd, "cpu"), mask, None, T, keep, qm9_info(), str(tmp_path), noises=draws)
    np.testing.assert_array_equal(out, xh)
    files = sorted(f for f in os.listdir(tmp_path) if f.endswith(".xyz"))
    assert len(files) == len(steps) + 10
    for i, f in enumerate(files):
        pos, one_hot = load_molecule_xyz(str(tmp_path / f), qm9_info())
        ours = frames[min(i, len(steps) - 1), 0, :6]
        np.testing.assert_allclose(pos, ours[:, :3], rtol=0, atol=1e-6 * max(1.0, np.abs(ours).max()))
        np.testing.assert_array_equal(one_hot.argmax(-1), ours[:, 3:8].argmax(-1))


def test_chain_mode_cli(tmp_path):
    """JAX ``test_sample_cli_chain_mode``'s case on the port's CLI."""
    from bio_diffusion_torch.cli.mol_gen_sample import main

    tiny = [o for o in TINY_OVERRIDES if "dataset=" not in o]
    metrics = main(tiny + ["ddpm_mode=chain", "num_nodes=6", "keep_frames=5", "device=cpu",
                           f"output_dir={tmp_path}"])
    assert "mol_stable" in metrics
    walk = [(root, f) for root, _, fs in os.walk(tmp_path) for f in fs]
    frames = [f for _, f in walk if f.startswith("chain") and f.endswith(".xyz")]
    assert len(frames) == 15  # 5 kept frames (stride 2 over T=10) + 10 repeats
    assert len([f for _, f in walk if f.endswith(".gif")]) == 1
    assert len([f for _, f in walk if f.startswith("molecule") and f.endswith(".xyz")]) == 1


def test_new_modules_import_no_jax_and_no_render_packages():
    """The modules of the chain, sweep, debug, profiling and serving
    benchmark import nothing of JAX; matplotlib and imageio load only when
    something is rendered."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "import bio_diffusion_torch.chem.visualization, bio_diffusion_torch.utils.debug\n"
        "import bio_diffusion_torch.utils.profiling, bio_diffusion_torch.cli.bench_serve\n"
        "import bio_diffusion_torch.cli.mol_gen_sample, bio_diffusion_torch.cli.mol_gen_eval_conditional_qm9\n"
        "import bio_diffusion_torch.cli.train, bio_diffusion_torch.train.loop\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'bio_diffusion_tpu', 'matplotlib', 'imageio'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

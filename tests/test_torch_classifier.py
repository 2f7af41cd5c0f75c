"""Port parity: the EGNN property classifier, its directories and its training.

* The port's ``EGNNClassifier`` against the JAX package's on the same
  weights (``classifier_state_dict_from_jax_params``), with and without node
  attributes, on a padded batch: atol 1e-5.
* Its prediction is E(3)-invariant and ignores padded rows: atol 1e-4 (the
  JAX package's own test's tolerance).
* A reference directory (``args.pickle`` + ``best_checkpoint.npy``)
  written from JAX params loads strictly, and predicts as JAX does.
* ``classifier.npz`` / ``classifier.json`` directories cross both ways:
  written by either package, loaded by the other, equal predictions and
  normalizers.
* Three ``train_property_classifier`` steps (one epoch, cosine decay over
  its three updates) from the same initial weights and batches as the JAX
  package's optax AdamW: losses, validation MAE and parameters at rtol 1e-5
  (parameters also atol 3e-8, the rounding of three updates of size lr).
"""

import pickle
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from bio_diffusion_tpu.models.classifier import EGNNClassifier as JaxClassifier
from bio_diffusion_torch.models.classifier import EGNNClassifier, load_reference_classifier
from bio_diffusion_torch.train.torch_import import classifier_state_dict_from_jax_params


def jax_classifier(node_attr=0, hidden_nf=16, n_layers=2, seed=0):
    """A JAX classifier and params of its shapes (``jax.eval_shape``) drawn
    from ``seed`` with the torch-default Linear scale."""
    model = JaxClassifier(in_node_nf=5, hidden_nf=hidden_nf, n_layers=n_layers, attention=True,
                          node_attr=node_attr)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 4, 5)), jnp.zeros((1, 4, 3)),
                            jnp.ones((1, 4)))
    rng = np.random.default_rng(seed)

    def draw(s):
        bound = 1.0 / np.sqrt(s.shape[0] if len(s.shape) == 2 else hidden_nf)
        return rng.uniform(-bound, bound, size=s.shape).astype(np.float32)

    return model, jax.tree.map(draw, shapes)


def port_classifier(params, node_attr=0, hidden_nf=16, n_layers=2):
    model = EGNNClassifier(in_node_nf=5, hidden_nf=hidden_nf, n_layers=n_layers, attention=True,
                           node_attr=node_attr)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in classifier_state_dict_from_jax_params(params).items()}
    model.load_state_dict(sd, strict=True)
    return model.eval()


def molecules(b=3, n=7, seed=0):
    rng = np.random.default_rng(seed)
    mask = np.zeros((b, n), np.float32)
    for i, k in enumerate([n, n - 2, n - 3][:b]):
        mask[i, :k] = 1
    h = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (b, n))] * mask[..., None]
    x = rng.normal(size=(b, n, 3)).astype(np.float32) * mask[..., None]
    return h, x, mask


def predict(model, h, x, mask):
    with torch.no_grad():
        return model(*(torch.from_numpy(np.asarray(a, np.float32)) for a in (h, x, mask))).numpy()


@pytest.mark.parametrize("node_attr", [0, 1])
def test_classifier_matches_jax(node_attr):
    model_j, params = jax_classifier(node_attr)
    model = port_classifier(params, node_attr)
    assert set(model.state_dict()) >= {"embedding.weight", "gcl_0.edge_mlp.0.weight", "gcl_0.edge_mlp.2.bias",
                                       "gcl_1.node_mlp.2.weight", "gcl_0.att_mlp.0.weight", "node_dec.0.weight",
                                       "graph_dec.2.bias"}
    h, x, mask = molecules()
    ref = np.asarray(jax.jit(model_j.apply)(params, jnp.asarray(h), jnp.asarray(x), jnp.asarray(mask)))
    out = predict(model, h, x, mask)
    assert out.shape == (3,)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_classifier_invariance_and_padding():
    model = port_classifier(jax_classifier(node_attr=1, seed=1)[1], node_attr=1)
    h, x, mask = molecules(seed=2)
    pred = predict(model, h, x, mask)
    rot = Rotation.random(random_state=1).as_matrix().astype(np.float32)
    moved = (x @ rot.T + np.array([1.5, -2.0, 0.3], np.float32)) * mask[..., None]
    np.testing.assert_allclose(predict(model, h, moved, mask), pred, atol=1e-4, rtol=0)
    pad = ((0, 0), (0, 3), (0, 0))
    np.testing.assert_allclose(predict(model, np.pad(h, pad), np.pad(x, pad), np.pad(mask, ((0, 0), (0, 3)))),
                               pred, atol=1e-4, rtol=0)


def test_reference_directory_loads_strictly(tmp_path):
    from bio_diffusion_tpu.models.classifier import load_torch_classifier

    model_j, params = jax_classifier(node_attr=1, hidden_nf=8, n_layers=1, seed=3)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in classifier_state_dict_from_jax_params(params).items()}
    with open(tmp_path / "args.pickle", "wb") as f:
        pickle.dump(Namespace(nf=8, n_layers=1, attention=True, node_attr=1, device="cpu"), f)
    torch.save(sd, tmp_path / "best_checkpoint.npy")
    model = load_reference_classifier(str(tmp_path))
    h, x, mask = molecules(seed=4)
    ref = np.asarray(model_j.apply(params, jnp.asarray(h), jnp.asarray(x), jnp.asarray(mask)))
    np.testing.assert_allclose(predict(model, h, x, mask), ref, atol=1e-5, rtol=0)
    # the JAX package reads the same directory to the same params
    _, params_j = load_torch_classifier(str(tmp_path))
    for a, b in zip(jax.tree.leaves(params_j), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # a missing tensor is refused
    sd.pop("graph_dec.2.bias")
    torch.save(sd, tmp_path / "best_checkpoint.npy")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_reference_classifier(str(tmp_path))


def test_jax_layout_directories_cross_both_ways(tmp_path):
    from bio_diffusion_tpu.train.classifier_train import load_jax_classifier as jax_load
    from bio_diffusion_tpu.train.classifier_train import save_jax_classifier as jax_save
    from bio_diffusion_torch.train.classifier_train import (
        is_jax_classifier_dir, load_jax_classifier, save_jax_classifier,
    )

    norms = {"mean": 12.5, "mad": 3.25}
    h, x, mask = molecules(seed=5)
    model_j, params = jax_classifier(seed=6)
    jax_dir = jax_save(str(tmp_path / "from_jax"), model_j, params, norms, "alpha", extra={"dataset": "synthetic"})
    assert is_jax_classifier_dir(jax_dir)
    ours, meta = load_jax_classifier(jax_dir)
    assert meta["property"] == "alpha" and (meta["mean"], meta["mad"]) == (12.5, 3.25)
    ref = np.asarray(model_j.apply(params, jnp.asarray(h), jnp.asarray(x), jnp.asarray(mask)))
    np.testing.assert_allclose(predict(ours, h, x, mask), ref, atol=1e-5, rtol=0)

    port_dir = save_jax_classifier(str(tmp_path / "from_port"), ours, norms, "alpha", extra={"dataset": "synthetic"})
    with np.load(f"{jax_dir}/classifier.npz") as a, np.load(f"{port_dir}/classifier.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with open(f"{jax_dir}/classifier.json") as a, open(f"{port_dir}/classifier.json") as b:
        assert a.read() == b.read()
    model_j2, params_j2, meta_j = jax_load(port_dir)
    assert meta_j == meta
    np.testing.assert_array_equal(
        np.asarray(model_j2.apply(params_j2, jnp.asarray(h), jnp.asarray(x), jnp.asarray(mask))), ref)


def test_three_training_steps_match_jax():
    from bio_diffusion_tpu.train.classifier_train import train_property_classifier as jax_train
    from bio_diffusion_torch.data.synthetic import synthetic_qm9_like
    from bio_diffusion_torch.train.classifier_train import cosine_decay, train_property_classifier

    datasets = {"train": synthetic_qm9_like(24, max_nodes=9, seed=0),
                "valid": synthetic_qm9_like(10, max_nodes=9, seed=1)}
    kw = dict(num_atom_types=5, hidden_nf=16, n_layers=2, epochs=1, batch_size=8, lr=1e-3, seed=0)
    model_j, params_j, norms_j, hist_j = jax_train(datasets, "alpha", **kw)
    # the JAX package's initial weights: its init from PRNGKey(seed) at pad_to
    init = model_j.init(jax.random.PRNGKey(0), jnp.zeros((1, 9, 5)), jnp.zeros((1, 9, 3)), jnp.ones((1, 9)))
    model, norms, hist = train_property_classifier(
        datasets, "alpha", **kw, device="cpu", state_dict=classifier_state_dict_from_jax_params(init))
    assert norms == norms_j
    assert [cosine_decay(1e-3, 3, c) for c in range(3)] == pytest.approx([1e-3, 7.5e-4, 2.5e-4], rel=1e-12)
    np.testing.assert_allclose(hist["train_loss"], hist_j["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(hist["valid_mae"], hist_j["valid_mae"], rtol=1e-5)
    assert hist["best_valid_mae"] == pytest.approx(hist_j["best_valid_mae"], rel=1e-5)
    ref = classifier_state_dict_from_jax_params(jax.device_get(params_j))
    start = classifier_state_dict_from_jax_params(init)
    moved = 0
    for name, p in model.state_dict().items():
        # the three updates (each at most ~lr = 1e-3) round at ~1e-5 of their size
        np.testing.assert_allclose(p.numpy(), ref[name], rtol=1e-5, atol=1e-5 * 1e-3 * 3, err_msg=name)
        moved += int((p.numpy() != start[name]).sum())
    assert moved > 0.9 * sum(p.numel() for p in model.parameters())

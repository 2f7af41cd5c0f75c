"""Host-side sampling drivers: the reverse-diffusion loop, batching, analysis.

Port of ``bio_diffusion_tpu/train/sampling.py`` (``SegmentedSampler``,
``make_node_mask``, ``sample_molecules``, ``analyze_samples``,
``ligand_pocket_geometry``, ``generate_ligands_in_pocket``) with the JAX
package's signatures, property contexts included; a ``torch.Generator``
takes the place of the JAX key and a list of ``devices`` that of the
data-parallel ``mesh``; ``generate_ligands_in_pocket`` pads the ligand
block to its largest ligand (JAX's ``pad_to_multiple``, which no caller
sets, is left out).  PyTorch runs eagerly, so the sampler is a Python loop
over the reverse steps; randomness comes from the ``torch.Generator`` each
call is given.

Every driver runs on ``parallel.distributed.Replicas``: one replica of the
EVD a device (the EVD itself on one device), a batch's rows split over
them, and each replica handed its rows of the draws the one-device run
makes, so the same seed gives the same molecules on any number of devices.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from bio_diffusion_torch.chem.stability import batch_molecular_stability, ensure_bond_tables
from bio_diffusion_torch.data.batch import broadcast_context
from bio_diffusion_torch.models.distributions import CategoricalDistribution, NumNodesDistribution
from bio_diffusion_torch.parallel.distributed import Replicas


class SegmentedSampler:
    """Reverse diffusion for one EVD: prior draw, T ancestral steps, decode.
    ``runs`` counts the batches it has sampled.  ``devices`` (the JAX
    sampler's ``mesh``; default the EVD's device): each batch is split over
    a replica of ``evd`` on each (``parallel.distributed.Replicas``, built
    once; ``evd`` itself serves the device it lies on)."""

    def __init__(self, evd, device=None, devices: Optional[Sequence] = None):
        if devices is None and device is not None:
            devices = [device]
        self.evd = evd
        self.replicas = Replicas(evd, devices)
        self.devices = self.replicas.devices
        self.device = self.devices[0]
        self.runs = 0

    @torch.inference_mode()
    def run(self, node_mask, generator: torch.Generator, num_timesteps: Optional[int] = None,
            fix_noise: bool = False, context=None, noises: Optional[Sequence[torch.Tensor]] = None,
            frame_steps: Optional[Sequence[int]] = None):
        """Sample xh ``[B, N, 3+F]`` on the data scale (numpy, float32);
        ``context [B, N, C]`` for a property-conditioned model; ``noises``:
        the raw draws instead of drawing from ``generator``, one for the
        prior, one a reverse step, one for the decode.  With ``frame_steps``
        the denoising chain is kept too -> ``(xh, frames)``: ``frames
        [len(frame_steps), B, N, 3+F]`` (numpy) are the data-scale states
        after the reverse steps ``frame_steps`` (0 = the first step),
        gathered on the device and copied to the host once.

        The replicas take each reverse step in turn, and a step reads
        nothing back to the host, so one thread's launches overlap across
        cards; every replica sees the draws of the one-device run
        (``Replicas.draws``), so a seed gives the same molecules on any
        number of devices."""
        evd, reps = self.evd, self.replicas
        T_s = evd.T if num_timesteps is None else int(num_timesteps)
        node_mask = np.asarray(node_mask, dtype=np.float32)
        b, n = node_mask.shape
        masks, ctxs = reps.scatter(node_mask, b), reps.scatter(context, b)
        nf = evd.num_x_dims + evd.num_node_scalar_features
        draws = reps.draws(b, (1 if fix_noise else b, n, nf), T_s + 2, generator, noises)
        zs = [m.init_sample_noise(mask, None, fix_noise, d[0]) for m, mask, d in zip(reps.modules, masks, draws)]
        slot = {} if frame_steps is None else {int(k): i for i, k in enumerate(frame_steps)}
        frames = None if frame_steps is None else [
            torch.empty((len(frame_steps),) + z.shape, dtype=z.dtype, device=z.device) for z in zs]
        s_values = np.arange(T_s - 1, -1, -1, dtype=np.float32)
        s_norm, t_norm = s_values / T_s, (s_values + 1) / T_s
        for k in range(T_s):
            for i, m in enumerate(reps.modules):
                zs[i] = m.reverse_segment(zs[i], s_norm[k: k + 1], t_norm[k: k + 1], masks[i], None, fix_noise,
                                          [draws[i][k + 1]], context=ctxs[i])
                if k in slot:
                    frames[i][slot[k]].copy_(m.unnormalize_z(zs[i], masks[i]))
        xh = reps.gather([m.decode_sample(z, mask, None, fix_noise, d[-1], context=c)
                          for m, z, mask, d, c in zip(reps.modules, zs, masks, draws, ctxs)], b)
        self.runs += 1
        if frames is None:
            return xh
        return xh, np.concatenate([f.cpu().numpy() for f in frames], axis=1)[:, :b]


def make_node_mask(num_nodes: Sequence[int], pad_to: Optional[int] = None) -> np.ndarray:
    num_nodes = np.asarray(num_nodes)
    n = int(pad_to if pad_to is not None else num_nodes.max())
    return (np.arange(n)[None, :] < num_nodes[:, None]).astype(np.float32)


def select_bucket(n: int, bucket_sizes: Optional[Sequence[int]] = None, pad_to_multiple: int = 1) -> int:
    """Smallest configured bucket >= n, else n rounded up to ``pad_to_multiple``."""
    if bucket_sizes:
        for b in sorted(bucket_sizes):
            if n <= b:
                return int(b)
    return int(-(-n // pad_to_multiple) * pad_to_multiple)


def sample_molecules(
    sampler: SegmentedSampler,
    generator: torch.Generator,
    num_samples: int,
    nodes_dist: NumNodesDistribution,
    rng: np.random.Generator,
    batch_size: int = 100,
    pad_to: Optional[int] = None,
    num_timesteps: Optional[int] = None,
    props_distr=None,
    bucket_sizes: Optional[Sequence[int]] = None,
    pad_to_multiple: int = 2,
    sort_sizes: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sample in batches -> ``(xh [M, N, .], node_mask [M, N], num_nodes [M])``.

    All sizes are drawn up front; by default they are sorted descending and
    each batch is padded only to its own bucket (its largest size rounded up
    to ``pad_to_multiple``, or the ``bucket_sizes`` ladder, never past the
    dataset's largest molecule).  ``pad_to`` pins one padded size for every
    batch and keeps the drawn order.  A conditioned model's contexts come
    from ``props_distr`` (one ``sample_batch`` per batch from ``rng``, after
    the sizes)."""
    sizes_all = nodes_dist.sample(num_samples, rng)
    if pad_to is None and sort_sizes:
        sizes_all = np.sort(sizes_all)[::-1]
    xs, masks, sizes = [], [], []
    for start in range(0, num_samples, batch_size):
        num_nodes = sizes_all[start: start + batch_size]
        if pad_to is not None:
            n_pad = pad_to
        else:
            n_pad = select_bucket(int(num_nodes.max()), bucket_sizes, pad_to_multiple)
            n_pad = min(n_pad, max(int(nodes_dist.max_n), int(num_nodes.max())))
        node_mask = make_node_mask(num_nodes, n_pad)
        context = None
        if props_distr is not None:
            context = broadcast_context(props_distr.sample_batch(num_nodes, rng), node_mask)
        xs.append(sampler.run(node_mask, generator, num_timesteps=num_timesteps, context=context))
        masks.append(node_mask)
        sizes.append(num_nodes)
    n_max = max(x.shape[1] for x in xs)

    def pad_n(a):
        return np.pad(a, [(0, 0), (0, n_max - a.shape[1])] + [(0, 0)] * (a.ndim - 2))

    return (np.concatenate([pad_n(x) for x in xs]), np.concatenate([pad_n(m) for m in masks]),
            np.concatenate(sizes))


def analyze_samples(xh: np.ndarray, node_mask: np.ndarray, dataset_info: Dict[str, Any],
                    include_charges: bool = True, molecular_metrics=None) -> Dict[str, float]:
    """Molecule/atom stability and the atom-type KL of sampled molecules;
    validity, uniqueness and novelty when an RDKit metrics object
    (``chem.rdkit_bridge.build_molecular_metrics``) is given.
    ``include_charges`` is accepted for the JAX package's signature: the
    metrics read positions and atom types only."""
    dataset_info = ensure_bond_tables(dataset_info)
    k = len(dataset_info["atom_decoder"])
    x = xh[..., :3]
    atom_types = xh[..., 3: 3 + k].argmax(-1)
    mol_stable, stable_atoms, num_atoms = batch_molecular_stability(x, atom_types, node_mask, dataset_info)
    type_dist = CategoricalDistribution(dataset_info["atom_types"], dataset_info["atom_encoder"])
    metrics = {
        "mol_stable": float(mol_stable.mean()),
        "atm_stable": float(stable_atoms.sum() / max(num_atoms.sum(), 1)),
        "kl_div_atom_types": type_dist.kl_divergence(atom_types[node_mask > 0].astype(int).tolist()),
    }
    if molecular_metrics is not None:
        mols = [(x[i][node_mask[i] > 0], atom_types[i][node_mask[i] > 0]) for i in range(len(x))]
        validity, uniqueness, novelty = molecular_metrics.evaluate(mols)[:3]
        metrics.update(validity=validity, uniqueness=uniqueness, novelty=novelty)
    return metrics


def ligand_pocket_geometry(ligand_x: np.ndarray, ligand_mask: np.ndarray, pocket_x: np.ndarray,
                           pocket_mask: np.ndarray) -> Dict[str, float]:
    """Geometry of ligands generated into pockets (host side):
    ``lig_nn_dist``, the mean nearest-neighbour distance among a ligand's
    atoms (A), and ``lig_center_rms``, the RMS distance of its atoms from
    the pocket's centroid (A), each averaged over the molecules with at
    least 2 ligand atoms and a pocket; ``{}`` when there is none.  Valence
    stability tells nothing on the synthetic random-walk ligands (their own
    chains score ~0); these two tell trained from untrained models."""
    nn_dists, center_rms = [], []
    for i in range(len(ligand_x)):
        lm, pm = ligand_mask[i] > 0, pocket_mask[i] > 0
        x = np.asarray(ligand_x[i][lm], dtype=np.float64)
        if len(x) < 2 or pm.sum() == 0:
            continue
        dm = np.linalg.norm(x[:, None] - x[None], axis=-1)
        np.fill_diagonal(dm, np.inf)
        nn_dists.append(dm.min(axis=1).mean())
        center = np.asarray(pocket_x[i][pm], dtype=np.float64).mean(axis=0)
        center_rms.append(np.sqrt(((x - center) ** 2).sum(-1).mean()))
    if not nn_dists:
        return {}
    return {"lig_nn_dist": float(np.mean(nn_dists)), "lig_center_rms": float(np.mean(center_rms))}


def generate_ligands_in_pocket(evd, generator: torch.Generator, pocket_x: np.ndarray, pocket_types: np.ndarray,
                               pocket_mask: np.ndarray, ligand_sizes: np.ndarray, num_ligand_atom_types: int,
                               num_resamplings: int = 1, jump_length: int = 1,
                               num_timesteps: Optional[int] = None,
                               noises: Optional[Sequence[torch.Tensor]] = None,
                               devices: Optional[Sequence] = None) -> Dict[str, np.ndarray]:
    """Ligands generated into pockets: RePaint inpainting (``evd.inpaint``,
    on the EVD's device) over the joint ligand+pocket graph with the pocket
    rows fixed.

    ``pocket_x [B, Np, 3]`` CA coordinates in any frame, ``pocket_types
    [B, Np]`` residue indices, ``pocket_mask [B, Np]``, ``ligand_sizes [B]``
    atoms to generate; ``num_ligand_atom_types`` is Kl, the width of the
    ligand block of the joint one-hot.  ``noises`` go to ``inpaint``.
    ``devices`` (the JAX function's ``mesh``; default the EVD's device):
    the rows are split over a replica of ``evd`` on each (``inpaint_rows``).
    Returns host arrays: ``ligand_x [B, Nl, 3]`` in the input pocket's
    frame (the best-fit translation of the decoded pocket onto the input),
    ``ligand_one_hot [B, Nl, Kl]`` (types taken over the ligand block
    only), ``ligand_mask``, ``joint_xh [B, Nl + Np, 3 + K]`` with the
    pocket rows restored bit-exact, ``node_mask`` and ``fixed_mask``."""
    from bio_diffusion_torch.config.schema import compute_num_atom_types
    from bio_diffusion_torch.data.pocket import JointLigandPocketBatch

    ligand_sizes = np.asarray(ligand_sizes, dtype=np.int64)
    pocket_x = np.asarray(pocket_x, dtype=np.float32)
    pocket_mask = np.asarray(pocket_mask, dtype=np.float32)
    b, np_pad = pocket_mask.shape
    nl_pad = int(ligand_sizes.max())
    k_total = compute_num_atom_types(evd.dataloader_cfg)
    kl = int(num_ligand_atom_types)
    kp = k_total - kl
    if kp <= 0:
        raise ValueError(f"model atom-type width {k_total} does not leave room for a pocket block after {kl} "
                         "ligand types")
    pocket_one_hot = np.eye(kp, dtype=np.float32)[np.asarray(pocket_types, dtype=np.int64)] * pocket_mask[..., None]
    pocket_x = pocket_x * pocket_mask[..., None]
    ligand_mask = make_node_mask(ligand_sizes, nl_pad)
    joint = JointLigandPocketBatch(
        ligand_x=np.zeros((b, nl_pad, 3), np.float32), ligand_one_hot=np.zeros((b, nl_pad, kl), np.float32),
        ligand_mask=ligand_mask, pocket_x=pocket_x, pocket_one_hot=pocket_one_hot, pocket_mask=pocket_mask)

    charges = np.zeros((b, nl_pad + np_pad, int(evd.dataloader_cfg.include_charges)), np.float32)
    inputs = (joint.x, joint.one_hot, charges, joint.node_mask, joint.fixed_mask)
    with torch.inference_mode():
        xh = inpaint_rows(Replicas(evd, devices), inputs, num_resamplings, jump_length, num_timesteps, generator,
                          noises)

    # inpaint's output is centred on the joint CoM: move it by the best-fit
    # translation of the decoded pocket onto the input pocket, then restore
    # the pocket rows exactly (conditioning, not a sample)
    count = np.maximum(pocket_mask.sum(axis=1, keepdims=True), 1.0)
    shift = ((pocket_x - xh[:, nl_pad:, :3]) * pocket_mask[..., None]).sum(axis=1) / count
    xh[..., :3] += shift[:, None, :]
    xh[..., :3] *= joint.node_mask[..., None]
    xh[:, nl_pad:, :3] = pocket_x
    xh[:, nl_pad:, 3: 3 + k_total] = joint.one_hot[:, nl_pad:]

    # a generated row takes its best type of the ligand block
    lig_types = xh[:, :nl_pad, 3: 3 + kl].argmax(-1)
    ligand_one_hot = np.eye(kl, dtype=np.float32)[lig_types] * ligand_mask[..., None]
    xh[:, :nl_pad, 3: 3 + k_total] = 0.0
    xh[:, :nl_pad, 3: 3 + kl] = ligand_one_hot
    return {
        "ligand_x": xh[:, :nl_pad, :3] * ligand_mask[..., None],
        "ligand_one_hot": ligand_one_hot,
        "ligand_mask": ligand_mask,
        "joint_xh": xh,
        "node_mask": joint.node_mask,
        "fixed_mask": joint.fixed_mask,
    }


def inpaint_rows(reps: Replicas, inputs: Sequence, num_resamplings: int, jump_length: int,
                 num_timesteps: Optional[int], generator: Optional[torch.Generator] = None,
                 noises: Optional[Sequence] = None) -> np.ndarray:
    """``evd.inpaint`` of ``inputs`` (host arrays ``[B, ...]``: x, one_hot,
    charges, node_mask, fixed_mask) on ``reps``, each replica its rows and
    its rows of the one-device run's draws (from ``generator`` in
    ``inpaint``'s order, or ``noises``) -> host ``[B, N, 3+F]``."""
    evd = reps.modules[0]
    T_s = evd.T if num_timesteps is None else int(num_timesteps)
    s_vals, _ = evd.repaint_step_arrays(evd.get_repaint_schedule(num_resamplings, jump_length, T_s), jump_length)
    b, n = np.shape(inputs[3])
    draws = reps.draws(b, (b, n, evd.num_x_dims + evd.num_node_scalar_features), 3 * len(s_vals) + 2, generator,
                       noises)
    return reps.map(lambda m, args, eps: m.inpaint(*args, num_resamplings, jump_length, num_timesteps, noises=eps),
                    inputs, draws)


def mol_gen_optimize_rows(reps: Replicas, x: torch.Tensor, h_cat: torch.Tensor, node_mask: torch.Tensor,
                          num_timesteps: int, context: Optional[torch.Tensor],
                          generator: Optional[torch.Generator]) -> torch.Tensor:
    """``evd.mol_gen_optimize`` on ``reps``, each replica its rows and its
    rows of the one-device run's draws (one a step, one for the decode)
    -> ``[B, N, 3+K]`` on the first device."""
    evd = reps.modules[0]
    b, n = node_mask.shape
    draws = reps.draws(b, (b, n, evd.num_x_dims + evd.num_node_scalar_features), int(num_timesteps) + 1, generator)
    out = reps.map(lambda m, args, eps: m.mol_gen_optimize(args[0], args[1], args[2], num_timesteps, args[3],
                                                           noises=eps), [x, h_cat, node_mask, context], draws)
    return torch.as_tensor(out, device=reps.devices[0])

"""Typed configuration schema mirroring the reference's Hydra config groups.

Copy of ``bio_diffusion_tpu/config/schema.py`` (the port imports nothing of
the JAX package).  Group and field names are the reference's
(configs/model/{model_cfg,module_cfg,layer_cfg,diffusion_cfg}/*.yaml and
configs/datamodule/dataloader_cfg/*.yaml), so the shared ``configs/`` tree
composes into the same values for both packages; fields the port does not
read yet keep their names and defaults for that parity.  Defaults are the
QM9 unconditional GCDM values.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Dict, Optional, Tuple


@dataclasses.dataclass
class MPConfig:
    """Message-passing sub-config (reference layer_cfg/mp_cfg)."""

    edge_encoder: bool = False
    edge_gate: bool = False
    num_message_layers: int = 4
    message_residual: int = 0
    message_ff_multiplier: int = 1
    self_message: bool = True
    use_residual_message_gcp: bool = True


@dataclasses.dataclass
class LayerConfig:
    """Interaction-layer config (reference layer_cfg)."""

    mp_cfg: MPConfig = dataclasses.field(default_factory=MPConfig)
    pre_norm: bool = False
    use_gcp_norm: bool = False
    use_gcp_dropout: bool = False
    use_scalar_message_attention: bool = True
    num_feedforward_layers: int = 1
    dropout: float = 0.0
    nonlinearity_slope: float = 1e-2


@dataclasses.dataclass
class ModuleConfig:
    """GCP module config (reference module_cfg)."""

    selected_gcp: str = "gcp2"  # "gcp" | "gcp2"
    norm_x_diff: bool = True
    scalar_gate: int = 0
    vector_gate: bool = True
    vector_residual: bool = False
    vector_frame_residual: bool = False
    frame_gate: bool = False
    sigma_frame_gate: bool = False
    scalar_nonlinearity: Optional[str] = "silu"
    vector_nonlinearity: Optional[str] = "silu"
    bottleneck: int = 4
    vector_linear: bool = True
    vector_identity: bool = True
    default_vector_residual: bool = False
    default_bottleneck: int = 4
    node_positions_weight: float = 1.0
    update_positions_with_vector_sum: bool = False
    ablate_frame_updates: bool = False
    ablate_scalars: bool = False
    ablate_vectors: bool = False
    conditioning: Tuple[str, ...] = ()
    clip_gradients: bool = True
    log_grad_flow_steps: int = 500

    @property
    def nonlinearities(self) -> Tuple[Optional[str], Optional[str]]:
        return (self.scalar_nonlinearity, self.vector_nonlinearity)


@dataclasses.dataclass
class ModelConfig:
    """Denoiser architecture dims (reference model_cfg)."""

    h_input_dim: int = 0  # only used for non node-feature diffusion targets
    chi_input_dim: int = 2
    e_input_dim: int = 1
    xi_input_dim: int = 1
    h_hidden_dim: int = 256
    chi_hidden_dim: int = 32
    e_hidden_dim: int = 64
    xi_hidden_dim: int = 16
    num_encoder_layers: int = 9
    num_decoder_layers: int = 3  # unused by GCPNetDynamics; kept for config parity
    dropout: float = 0.0


@dataclasses.dataclass
class DiffusionConfig:
    """DDPM config (reference diffusion_cfg)."""

    ddpm_mode: str = "unconditional"  # [unconditional, inpainting]
    dynamics_network: str = "gcpnet"  # [gcpnet, egnn]
    diffusion_target: str = "atom_types_and_coords"
    num_timesteps: int = 1000
    parametrization: str = "eps"
    noise_schedule: str = "polynomial_2"  # [cosine, polynomial_n, learned]
    noise_precision: float = 1e-5
    loss_type: str = "l2"  # [l2, vlb]
    norm_values: Tuple[float, float, float] = (1.0, 4.0, 10.0)
    norm_biases: Tuple[Optional[float], float, float] = (None, 0.0, 0.0)
    condition_on_time: bool = True
    self_condition: bool = False
    norm_training_by_max_nodes: bool = False
    sample_during_training: bool = True
    eval_epochs: int = 20
    visualize_sample_epochs: int = 20
    visualize_chain_epochs: int = 20
    num_eval_samples: int = 1000
    eval_batch_size: int = 100
    num_visualization_samples: int = 5
    keep_frames: int = 100
    # invariant checks in the loss path (reference assert_mean_zero_with_mask /
    # assert_correctly_masked); off by default
    debug_invariants: bool = False


@dataclasses.dataclass
class DataloaderConfig:
    """Dataset / loader config (reference dataloader_cfg)."""

    dataset: str = "QM9"  # [QM9, QM9_second_half, GEOM, synthetic]
    data_dir: str = "data/EDM"
    smiles_filepath: Optional[str] = None
    num_atom_types: int = 5
    num_x_dims: int = 3
    remove_h: bool = False
    create_pyg_graphs: bool = True  # config parity; dense graphs are always created
    num_train: int = -1
    num_valid: int = -1
    num_test: int = -1
    subtract_thermo: bool = True
    filter_n_atoms: Optional[int] = None
    include_charges: bool = True
    filter_molecule_size: Optional[int] = None
    sequential: bool = False
    device: str = "cpu"
    force_download: bool = False
    num_radials: int = 1
    batch_size: int = 64
    num_workers: int = 4
    shuffle: bool = True
    drop_last: bool = True
    pin_memory: bool = False
    pad_to_multiple: int = 1  # node-axis padding granularity within a bucket
    bucket_sizes: Optional[Tuple[int, ...]] = None  # e.g. (32, 64, 96, 128, 192) for GEOM


@dataclasses.dataclass
class OptimizerConfig:
    name: str = "adamw_amsgrad"
    lr: float = 1e-4
    weight_decay: float = 1e-12
    amsgrad: bool = True
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    # optional lr schedule, in optimizer steps; config values may be
    # arithmetic strings like "${trainer.min_epochs} // 8", evaluated by
    # ``build.safe_arith``
    scheduler: str = ""  # ["", step, cosine, linear_warmup]
    step_size: int = 1000  # step: decay interval; cosine: decay horizon
    gamma: float = 0.9  # step: multiplicative decay factor
    warmup_steps: int = 0  # linear warmup prepended to any schedule


@dataclasses.dataclass
class TrainerConfig:
    min_epochs: int = 50
    max_epochs: int = 3000
    accumulate_grad_batches: int = 1
    check_val_every_n_epoch: int = 20
    precision: str = "fp32"  # [fp32, bf16]
    seed: int = 42
    devices: int = 1
    ema_decay: float = 0.9999
    ckpt_every_n_epochs: int = 1
    ckpt_dir: str = "checkpoints"
    log_every_n_steps: int = 50
    # distribution (reference trainer/ddp.yaml)
    use_mesh: bool = True
    num_model_shards: int = 1
    num_nodes: int = 1
    multihost: bool = False
    # early stopping (reference configs/callbacks/early_stopping.yaml): an
    # empty monitor disables it
    early_stopping_monitor: str = ""
    early_stopping_patience: int = 5
    early_stopping_min_delta: float = 0.0
    early_stopping_mode: str = "min"  # [min, max]
    early_stopping_check_finite: bool = True
    # debug presets (reference configs/debug/*): batch limits are a fraction
    # (<1.0) or an absolute count (>=1)
    limit_train_batches: float = 1.0
    limit_val_batches: float = 1.0
    limit_test_batches: float = 1.0
    overfit_batches: int = 0
    fast_dev_run: bool = False
    detect_anomaly: bool = False
    profile: bool = False
    fast_train: str = "auto"  # [auto, on, pallas, off]
    # warm start from a checkpoint: leaves that match by path and shape load
    warm_start_ckpt: str = ""
    warm_start_source: str = "params"  # [params, ema_params]


def compute_num_atom_types(dataloader_cfg: DataloaderConfig) -> int:
    """The effective atom-type count after optional hydrogen removal
    (reference qm9_mol_gen_ddpm.py:82-87 adjusts this before model build)."""
    return dataloader_cfg.num_atom_types - 1 if dataloader_cfg.remove_h else dataloader_cfg.num_atom_types


def _to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_to_dict(v) for v in obj]
    return obj


def to_dict(cfg: Any) -> Dict[str, Any]:
    return _to_dict(cfg)


def _coerce(value: Any, reference: Any) -> Any:
    """Coerce YAML-parsed values to the field's default type (YAML 1.1 reads
    '1e-4' as a string; bools/ints similarly need care)."""
    if value is None or reference is None:
        return value
    if isinstance(reference, bool):
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(reference, float) and isinstance(value, (str, int)):
        return float(value)
    if isinstance(reference, int) and isinstance(value, (str, float)) and not isinstance(value, bool):
        return int(float(value))
    return value


def from_dict(cls, data: Dict[str, Any]):
    """Build a (possibly nested) dataclass from a plain dict, ignoring
    unknown keys (forward/backward config compatibility)."""
    if data is None:
        return cls()
    defaults = cls()
    known = {f.name for f in dataclasses.fields(cls)}
    meta = {"_target_", "_partial_", "_convert_", "_recursive_", "defaults"}
    for k in data:
        if k not in known and k not in meta and not k.startswith("_"):
            logging.getLogger(__name__).warning(f"{cls.__name__}: ignoring unknown config key '{k}'")
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        value = data[f.name]
        if f.name == "mp_cfg":
            kwargs[f.name] = from_dict(MPConfig, value)
        elif isinstance(value, list):
            ref_item = None
            ref = getattr(defaults, f.name)
            if isinstance(ref, (list, tuple)) and len(ref) > 0:
                ref_item = ref[0]
            kwargs[f.name] = tuple(_coerce(v, ref_item) for v in value)
        else:
            kwargs[f.name] = _coerce(value, getattr(defaults, f.name))
    return cls(**kwargs)

"""The program's spans (``utils/profiling.py::span``) on the CPU at a tiny width.

* With no profiler running, ``span`` hands back one shared no-op.
* Under a profiler that records the program's spans alone (user
  annotations, no host operation), a two-step epoch of a small packed QM9
  Trainer records ``trainer.epoch`` holding, a step, ``trainer.data``,
  ``trainer.h2d`` and ``trainer.step``, which holds ``step.forward`` (one
  ``message_layer.forward`` a layer), ``step.backward`` (one
  ``message_layer.backward`` a layer), ``step.clip``, ``step.optimizer``
  and ``step.ema``; then one ``trainer.readback``.  The epoch's losses and
  parameters equal, bit for bit, those of the same epoch untraced.
* A 3-step ``SegmentedSampler.run`` with a kept frame records one prior,
  three steps (one ``message_layer.forward`` a layer in each), one decode
  and one read-back.
"""

import contextlib

import numpy as np
import torch

from bio_diffusion_torch.config.build import build_experiment
from bio_diffusion_torch.config.loader import default_config_dir, load_config
from bio_diffusion_torch.models.diffusion import EquivariantVariationalDiffusion
from bio_diffusion_torch.models.gcpnet import GCPNetDynamics
from bio_diffusion_torch.train.loop import Trainer
from bio_diffusion_torch.train.sampling import SegmentedSampler, make_node_mask
from bio_diffusion_torch.train.torch_import import init_random_weights
from bio_diffusion_torch.utils import profiling
from test_torch_common import TINY_OVERRIDES, tiny_configs

LAYERS = 2  # TINY_OVERRIDES' num_encoder_layers
TRAIN = (["experiment=qm9_mol_gen_ddpm"] + TINY_OVERRIDES
         + ["datamodule.dataloader_cfg.batch_size=4", "datamodule.dataloader_cfg.num_train=16"])


@contextlib.contextmanager
def user_spans():
    """A profiler whose record scope is user annotations alone -> the list of
    ``(name, start_ns, end_ns)`` it recorded, filled when the block ends."""
    from torch._C._autograd import _disable_profiler, _enable_profiler, _prepare_profiler
    from torch._C._profiler import ProfilerActivity, ProfilerConfig, ProfilerState, RecordScope, _ExperimentalConfig

    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False, _ExperimentalConfig())
    acts = {ProfilerActivity.CPU}
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
    spans = []
    try:
        yield spans
    finally:
        spans.extend((e.name(), e.start_ns(), e.end_ns()) for e in _disable_profiler().events())


def tree(spans):
    """Nested spans -> ``[(name, children)]`` in order of start."""
    root, stack = [], []
    for name, start, end in sorted(spans, key=lambda s: (s[1], -s[2])):
        while stack and stack[-1][0] <= start:
            stack.pop()
        node = (name, [])
        (stack[-1][1] if stack else root).append(node)
        stack.append((end, node[1]))
    return root


def names(nodes):
    return [name for name, _ in nodes]


def test_span_is_a_shared_no_op_without_a_profiler():
    a, b = profiling.span("trainer.step"), profiling.span("sampler.step")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with a:
        pass
    with user_spans():
        assert profiling.span("trainer.step") is not a


def epoch(tmp_path):
    tr = Trainer(build_experiment(load_config(default_config_dir(), "train", TRAIN)), str(tmp_path), "cpu")
    tr.init_state(resume=False)
    out = tr.train_epoch(0, max_steps=2)
    return out, [p.detach().clone() for p in tr.evd.parameters()]


def test_trainer_epoch_spans_and_an_untouched_result(tmp_path):
    with user_spans() as spans:
        traced, params = epoch(tmp_path / "traced")
    plain, params_plain = epoch(tmp_path / "plain")
    assert traced == plain
    for a, b in zip(params, params_plain):
        assert torch.equal(a, b)

    [(top, children)] = tree(spans)
    assert top == "trainer.epoch"
    assert names(children) == ["trainer.data", "trainer.h2d", "trainer.step"] * 2 + ["trainer.readback"]
    for name, inner in children:
        if name != "trainer.step":
            assert inner == [], name
            continue
        assert names(inner) == ["step.forward", "step.backward", "step.clip", "step.optimizer", "step.ema"]
        forward, backward = inner[0][1], inner[1][1]
        assert names(forward) == ["message_layer.forward"] * LAYERS
        assert names(backward) == ["message_layer.backward"] * LAYERS


def test_sampler_run_spans():
    cfgs = tiny_configs()
    evd = EquivariantVariationalDiffusion(GCPNetDynamics(*cfgs), cfgs[3], cfgs[4]).eval()
    init_random_weights(evd, 0)
    sampler = SegmentedSampler(evd, torch.device("cpu"))
    gen = torch.Generator().manual_seed(0)
    with user_spans() as spans:
        xh, frames = sampler.run(make_node_mask(np.array([5, 4]), 6), gen, num_timesteps=3, frame_steps=[1])
    assert xh.shape[:2] == (2, 6) and frames.shape[:3] == (1, 2, 6)
    nodes = tree(spans)
    assert names(nodes) == ["sampler.prior"] + ["sampler.step"] * 3 + ["sampler.decode", "sampler.readback"]
    for _, inner in nodes[1:4]:
        assert names(inner) == ["message_layer.forward"] * LAYERS

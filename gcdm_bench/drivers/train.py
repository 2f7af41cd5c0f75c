"""Training cells: whole ``Trainer.train_epoch`` calls, each step through
the Trainer's own ``train_step`` fed the benchmark's draws."""

from __future__ import annotations

import math
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from gcdm_bench import checks, traffic, yardstick
from gcdm_bench.program import Run, bound_s, experiment, num_features, peak_bytes, peak_flops, reset_peak, sync, \
    traced_passes, weights

STEPS = 3  # the steps of an epoch the reference follows
MOMENTS = ("mu", "nu", "nu_max")


@dataclass
class Record:
    """An epoch's first ``STEPS`` optimizer steps as the reference follows
    them: the optimizer's state at the epoch's start (none: the benchmark's
    own weights, fresh), each step's draws and loss, the first moment after
    the first step, and the parameters and EMA after the last.  The state is
    copied to pinned host buffers in the stream's order: the host never
    waits for it inside the window."""

    device: torch.device
    numel: int
    fresh: bool
    draws: List[Dict[str, torch.Tensor]] = field(default_factory=list)
    losses: List[torch.Tensor] = field(default_factory=list)
    host: Dict[str, torch.Tensor] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    def reserve(self, st) -> None:
        """Allocate the host buffers (at set-up, not inside the window)."""
        keys = ["mu1", "params", "ema"]
        if not self.fresh:
            keys += [f"start.{key}" for key in ("params", "ema_params") + MOMENTS]
            self.host["start.gradnorm"] = self._empty(st.gradnorm_buffer.numel())
        for key in keys:
            self.host[key] = self._empty(self.numel)

    def _empty(self, size: int) -> torch.Tensor:
        return torch.empty(size, dtype=torch.float32, pin_memory=self.device.type == "cuda")

    def _copy(self, key: str, tensors) -> None:
        self.host[key].copy_(torch.cat([t.detach().reshape(-1).float() for t in tensors]), non_blocking=True)

    def begin(self, st) -> None:
        """The epoch starts from ``st``."""
        self.draws, self.losses = [], []
        if self.fresh:
            return
        for key in ("params", "ema_params") + MOMENTS:
            self._copy(f"start.{key}", getattr(st, key))
        self._copy("start.gradnorm", [st.gradnorm_buffer])
        self.counts = {"count": int(st.count), "gradnorm": int(st.gradnorm_count)}

    def step(self, st, draws: Dict[str, torch.Tensor], loss: torch.Tensor) -> None:
        """After the optimizer step ``st`` took on ``draws``."""
        k = len(self.draws)
        if k >= STEPS:
            return
        self.draws.append(draws)
        self.losses.append(loss.detach())
        if k == 0:
            self._copy("mu1", st.mu)
        if k == STEPS - 1:
            self._copy("params", st.params)
            self._copy("ema", st.ema_params)

    def leaves(self, key: str, names: List[str], shapes: List[torch.Size]) -> Dict[str, torch.Tensor]:
        """A host buffer split back into named leaves (after a sync)."""
        out, off = {}, 0
        for name, shape in zip(names, shapes):
            size = math.prod(shape)
            out[name] = self.host[key][off: off + size].view(shape).clone()
            off += size
        return out


def drive(run: Run) -> Dict:
    from bio_diffusion_torch.data.batch import DenseDataset
    from bio_diffusion_torch.train.loop import Trainer
    from bio_diffusion_torch.utils.logging import MetricLoggers

    cfg, dev, spec = run.config, run.device, run.spec
    tr = traffic.train_traffic(spec, run.seed)
    exp = experiment(cfg, run.seed, spec)
    data = {"num_atoms": tr.num_atoms, "positions": tr.positions, "charges": tr.charges,
            "index": np.arange(len(tr.num_atoms), dtype=np.int64),
            "one_hot": (tr.charges[..., None] == tr.atomic_nb[None, None, :]).astype(np.float32)}
    dataset = DenseDataset(data, included_species=tr.atomic_nb)
    state = weights(cfg, run.seed, dev)
    nf, T, b = num_features(cfg), int(cfg["diffusion_cfg"]["num_timesteps"]), tr.batch_size
    gen = torch.Generator(device=dev).manual_seed(traffic.torch_seed(run.seed, 40))

    with tempfile.TemporaryDirectory() as workdir:
        trainer = Trainer(exp, workdir, dev, datasets={"train": dataset, "valid": dataset, "test": dataset},
                          loggers=MetricLoggers())
        trainer.init_state(state_dict=state, resume=False)
        names = [n for n, _ in trainer.evd.named_parameters()]
        shapes = [p.shape for p in trainer.state.params]
        numel = sum(p.numel() for p in trainer.state.params)
        setup, newest = Record(dev, numel, fresh=True), Record(dev, numel, fresh=False)
        setup.reserve(trainer.state)
        newest.reserve(trainer.state)
        current = [setup]
        inner = trainer.train_step

        def fed(st, batch, generator, draws=None):
            d = {"t_int": torch.randint(0, T + 1, (b, 1), generator=gen, device=dev),
                 "eps_t": torch.randn((b, batch.node_mask.shape[1], nf), generator=gen, device=dev)}
            if run.fault == "frozen" or (run.fault == "frozen_in_window" and current[0] is newest):
                st.count += 1
                metrics = {"loss": torch.zeros((), device=dev)}
            elif run.fault == "half_batch":
                half = slice(0, b // 2)
                metrics = inner(st, type(batch)(batch.x[half], batch.one_hot[half], batch.charges[half],
                                                batch.node_mask[half]), generator,
                                draws={k: v[half] for k, v in d.items()})
            else:
                metrics = inner(st, batch, generator, draws=d)
            current[0].step(st, d, metrics["loss"])
            return metrics

        trainer.train_step = fed
        reset_peak(dev)
        trainer.train_epoch(0, max_steps=tr.prefix)
        if trainer.stats["steps"] != tr.prefix:
            raise RuntimeError(f"set-up took {trainer.stats['steps']} of {tr.prefix} steps")
        sync(dev)
        setup_s = time.perf_counter() - run.t_start
        steps0 = trainer.stats["steps"]
        epochs = [0]

        def epoch() -> None:
            epochs[0] += 1
            current[0] = newest
            newest.begin(trainer.state)
            trainer.train_epoch(epochs[0])

        t0 = time.perf_counter()
        marks = [t0]
        while True:
            epoch()
            marks.append(time.perf_counter())
            if marks[-1] - t0 >= run.seconds:
                break
        window_s = marks[-1] - t0
        print(f"epoch seconds: {[round(b - a, 4) for a, b in zip(marks, marks[1:])]}", file=sys.stderr)
        steps = trainer.stats["steps"] - steps0
        summary = None
        if run.traced:  # then two more epochs, each under the profiler
            summary = traced_passes(run, epoch, set())
        sync(dev)
        peak = peak_bytes(dev)
        del trainer, inner
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    epoch_sizes = [tr.num_atoms[tr.batch_rows(k)] for k in range(tr.num_batches)]
    layers = cfg["model_cfg"]["num_encoder_layers"]
    b1_flops = sum(yardstick.message_layer_flops(cfg, s) for s in epoch_sizes) * layers
    b1_bytes = sum(yardstick.message_layer_bytes(cfg, s, False) for s in epoch_sizes) * layers
    b2_bytes = sum(yardstick.message_layer_bytes(cfg, s, True) for s in epoch_sizes) * layers
    records = {"setup": setup, "window": newest}
    readings = checks.train_readings(run, tr, records, names, shapes, state)
    losses = [float(x) for r in records.values() for x in r.losses]
    failed = sum(int(not math.isfinite(x)) for x in losses)
    run.out.update(
        setup_s=setup_s, window_s=window_s, peak_bytes=peak, attempted=steps, failed=failed,
        e2e={"train_mols_per_s": steps * b / window_s, "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
        readings=readings, trace=summary,
        ctx={"trace": summary, "window_s": window_s, "optimizer_steps": tr.num_batches,
             "model_flops": 3 * sum(yardstick.denoiser_flops(cfg, s) for s in epoch_sizes) * (steps // tr.num_batches),
             "b1_bound_s": bound_s(run, b1_flops, b1_bytes),
             "b2_bound_s": bound_s(run, 2 * b1_flops, b2_bytes), "peak_flops": peak_flops(run)})
    return run.out

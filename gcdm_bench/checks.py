"""The comparisons that decide ``correct``: what the window produced against
the plain reference, on the benchmark's own draws and weights.

Sampling: a sample of the window's molecules, drawn from the seed with the
largest among them.  With random weights the reverse process does not
denoise, and over 100 steps its states grow by many orders of magnitude,
so a free-running reference would follow round-off as much as the model.
The reference therefore follows the program step by step, from the
program's own chain of states (the sampler's frames), and its judge is
the reference in float64.  Three gaps are taken over the checked
molecules' real atoms, each a relative root-mean-square gap from the
judge: the positions and the features of every reverse step (the first
from the prior the reference makes from the raw draws itself, each later
one from the program's state before it), and the decoded positions, or
the share of decoded atoms whose type or charge differs where that is
larger (a type or charge the judge puts within ``TIE``, relative, of a
tie may round either way and is not counted).  ``chain_gap`` is the
largest of the three, each in units of what float32 round-off alone
moves it: the larger of the same gap of the reference in float32 (TF32
off) and of the judge's gap when the states it is handed are off by one
rounding (the frames hold the charges times 10, rounded once).  Random
weights make the exploding states ill-conditioned to a degree that changes
from seed to seed by three orders of magnitude; the unit takes that out,
so sound runs read about 1 on every seed.

Training: the reference follows two runs of three optimizer steps (loss,
adaptive clip, AMSGrad, EMA) on the same batches and draws, in blocks of
molecules: set-up's first steps, from the benchmark's own weights with a
fresh optimizer (the start, checked by itself), and the first steps of the
newest epoch the window (or the traced pass) ran, from the program's state
at that epoch's start (parameters, moments, EMA, step count and grad-norm
history, copied to the host in the stream's order).  Each number is the
worse of the two.  ``loss_gap``: the worst step's relative loss gap.
``grad_gap``: the first step's clipped gradient as the optimizer holds it
(its first moment's change over 1 - b1), the worst leaf's gap of norms
against the larger of that leaf's and the median leaf's reference norm.
``change_gap``: the same of the parameters' change over the three steps,
over the leaves whose reference gradient is at least a thousandth of the
median leaf's (the others move by round-off alone).  ``ema_gap``: the
median leaf's gap of the EMA's change over those leaves (the EMA moves by
a few float32 steps of a weight, so the worst leaf's gap is a small leaf's
round-off).

With ``Run.control`` the reference in TF32 is read the same way in the
program's place: the control each limit must separate.
"""

from __future__ import annotations

import math
import sys
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from gcdm_bench import traffic
from gcdm_bench.reference import gcdm as ref

TIE = 1e-3
MOVED = 1e-3
ULP = 2.0 ** -24  # float32's unit round-off: the least a round-off gap is counted as


def _ref_diffusion(run, state, device, dtype=torch.float32) -> ref.Diffusion:
    from gcdm_bench.program import load_reference

    cfg = run.config
    net = load_reference(cfg, {k: v.to(dtype) for k, v in state.items()}, device).to(dtype)
    return ref.Diffusion(net, cfg["diffusion_cfg"], cfg["include_charges"], cfg["num_atom_types"], device, dtype)


# -- sampling ------------------------------------------------------------------------


def _rms(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor) -> float:
    """The root-mean-square gap of ``a`` from ``b`` over the real rows, over
    the root-mean-square of ``b`` there (inf where either is not finite)."""
    m = mask[..., None].double()
    a, b = a.double(), b.double()
    out = math.sqrt(float((((a - b) ** 2) * m).sum()) / max(float(((b ** 2) * m).sum()), 1e-300))
    return out if math.isfinite(out) else math.inf


def decoded_gap(prog: Sequence[np.ndarray], x: torch.Tensor, h_cat: torch.Tensor, h_int: torch.Tensor,
                sizes: Sequence[int], include_charges: bool) -> float:
    """The gap of the decoded ``prog`` rows from the reference's continuous
    decode, rounded as the sampler rounds it: the positions' relative
    root-mean-square gap, or the share of atoms whose type or charge
    differs, whichever is larger."""
    k = h_cat.shape[-1]
    x, h_cat, h_int = (t.double().cpu().numpy() for t in (x, h_cat, h_int))
    num = den = 0.0
    wrong = atoms = 0
    for j, n in enumerate(sizes):
        p = np.asarray(prog[j][:n], dtype=np.float64)
        if not np.isfinite(p).all() or not np.isfinite(x[j, :n]).all():
            return math.inf
        num += float(((p[:, :3] - x[j, :n]) ** 2).sum())
        den += float((x[j, :n] ** 2).sum())
        top2 = np.sort(h_cat[j, :n], axis=-1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) >= TIE * np.maximum(1.0, np.abs(top2[:, 1]))
        bad = (p[:, 3:3 + k].argmax(-1) != h_cat[j, :n].argmax(-1)) & decided
        if include_charges:
            c = h_int[j, :n, 0]
            decided = np.abs(np.abs(c - np.floor(c)) - 0.5) >= TIE * np.maximum(1.0, np.abs(c))
            bad |= (p[:, 3 + k] != np.round(c)) & decided
        wrong += int(bad.sum())
        atoms += n
    return max(math.sqrt(num / max(den, 1e-300)), wrong / atoms)


def sample_readings(run, tr, outputs: List[tuple], state: Dict, draws: Callable) -> Dict[str, float]:
    """``chain_gap``: the worst of each reverse step of the checked molecules
    taken by the reference from the program's state before it (the prior,
    for the first step, from the raw draws), against the program's state
    after it, and of the reference's decode of the program's last state
    against the program's decoded molecules."""
    cfg, dev = run.config, run.device
    T = tr.num_timesteps
    flat = [(k, i, int(n)) for k in range(len(outputs)) for i, n in enumerate(tr.batches[k % len(tr.batches)])]
    longest = max(range(len(flat)), key=lambda j: flat[j][2])
    pick = [flat[j] for j in traffic.selected(flat, int(run.spec["checked_molecules"]),
                                              traffic.rng_for(run.seed, 50), must=longest)]
    sizes = [n for _, _, n in pick]
    n_ref, nf = max(sizes), 3 + cfg["num_atom_types"] + int(cfg["include_charges"])
    mask = torch.zeros((len(pick), n_ref), device=dev)
    d = torch.zeros((T + 2, len(pick), n_ref, nf), device=dev)
    chain = torch.zeros((T, len(pick), n_ref, nf), device=dev)
    for j, (k, i, n) in enumerate(pick):
        mask[j, :n] = 1.0
        d[:, j, :n] = draws(k, T, tr.pads[k % len(tr.pads)])[:, i, :n]
        chain[:, j, :n] = torch.as_tensor(outputs[k][1][:, i, :n], device=dev)
    nv = [float(v) for v in cfg["diffusion_cfg"]["norm_values"]]
    k_types = cfg["num_atom_types"]
    chain[..., :3] /= nv[0]
    chain[..., 3:3 + k_types] /= nv[1]
    chain[..., 3 + k_types:] /= nv[2]
    prog = [outputs[k][0][i] for k, i, _ in pick]
    from gcdm_bench.program import fp32_reference

    def follow(dtype, tf32: bool = False, states: torch.Tensor = chain):
        """-> (each step's output from ``states``, the decode of the last)."""
        diffusion = _ref_diffusion(run, state, dev, dtype)
        zs, dd, mm = states.to(dtype), d.to(dtype), mask.to(dtype)
        steps = []
        with torch.no_grad(), fp32_reference(tf32):
            for k in range(T):
                s_int = T - 1 - k
                s = torch.full((len(pick), 1), s_int / T, device=dev, dtype=dtype)
                t = torch.full((len(pick), 1), (s_int + 1) / T, device=dev, dtype=dtype)
                z = diffusion.noise(dd[0], mm) if k == 0 else zs[k - 1]
                steps.append(diffusion.reverse_step(z, s, t, mm, dd[1 + k]))
            return torch.stack(steps), diffusion.decode(zs[-1], mm, dd[-1])

    judge_steps, judge_decoded = follow(torch.float64)
    m = mask[None].expand(T, -1, -1)

    def gaps(steps, prog_decoded):
        return (_rms(steps[..., :3], judge_steps[..., :3], m), _rms(steps[..., 3:], judge_steps[..., 3:], m),
                decoded_gap(prog_decoded, *judge_decoded, sizes, cfg["include_charges"]))

    def discrete(decoded):
        x, h_cat, h_int = decoded
        return list(torch.cat([x.float(), torch.nn.functional.one_hot(h_cat.argmax(-1), k_types).float(),
                               torch.round(h_int).float()], -1).cpu().numpy())

    # the unit: what float32 round-off alone moves, in the computation (the
    # reference in float32) and in the states handed over (the frames are on
    # the data scale, the charges times 10: one rounding)
    ref_steps, ref_decoded = follow(torch.float32)
    gen = torch.Generator(device=dev).manual_seed(traffic.torch_seed(run.seed, 51))
    nudged = chain.clone()
    c = 3 + k_types
    nudged[..., c:] = torch.nextafter(chain[..., c:], torch.where(
        torch.rand(chain[..., c:].shape, generator=gen, device=dev) < 0.5, -math.inf, math.inf))
    in_steps, in_decoded = follow(torch.float64, states=nudged)
    unit = [max(a, b, ULP) for a, b in zip(gaps(ref_steps, discrete(ref_decoded)),
                                           gaps(in_steps, discrete(in_decoded)))]

    def chain_gap(steps, prog_decoded):
        parts = gaps(steps, prog_decoded)
        print("chain_gap parts (positions, features, decode) over their units: "
              f"{[p / u for p, u in zip(parts, unit)]} units {unit}", file=sys.stderr)
        return max(p / u for p, u in zip(parts, unit))

    out = {"chain_gap": chain_gap(chain, prog)}
    if run.control:
        ctrl_steps, ctrl_decoded = follow(torch.float32, tf32=True)
        out["control.chain_gap"] = chain_gap(ctrl_steps, discrete(ctrl_decoded))
    return out


# -- training ------------------------------------------------------------------------


def log_pn_table(sizes_hist: str) -> np.ndarray:
    hist = traffic.Histogram.load(sizes_hist)
    table = np.full(hist.max_n + 1, 1e-30, dtype=np.float64)
    table[hist.sizes] = hist.prob + 1e-30
    return np.log(table).astype(np.float32)


def batch_tensors(tr, k: int, device):
    """Batch ``k`` of the epoch collated by the reference: float32, padded to its size."""
    rows, pad = tr.batch_rows(k), tr.pads[k]
    pos = np.zeros((tr.batch_size, pad, 3), dtype=np.float64)
    ch = np.zeros((tr.batch_size, pad), dtype=np.int64)
    width = min(pad, tr.positions.shape[1])
    pos[:, :width] = tr.positions[rows, :width]
    ch[:, :width] = tr.charges[rows, :width]
    mask = torch.as_tensor(ch > 0, dtype=torch.float32, device=device)
    x = torch.as_tensor(pos, dtype=torch.float32, device=device) * mask[..., None]
    one_hot = torch.as_tensor(ch[..., None] == tr.atomic_nb[None, None, :], dtype=torch.float32, device=device)
    charges = torch.as_tensor(ch, dtype=torch.float32, device=device)[..., None]
    return x, one_hot, charges, mask


def chronological(buffer: torch.Tensor, pushed: int) -> List[float]:
    """The grad-norm history of a ring of ``len(buffer)`` entries after
    ``pushed`` pushes, oldest first."""
    values = [float(v) for v in buffer]
    if pushed <= len(values):
        return values[:pushed]
    i = pushed % len(values)
    return values[i:] + values[:i]


def reference_steps(run, tr, draws: List[Dict], start: Dict, tf32: bool) -> Dict:
    """The reference's steps over the epoch's first batches from ``start``
    (``params`` and ``ema`` by name; without ``mu``, a fresh optimizer) ->
    losses, first moment after the first step, parameters and EMA after the
    last (by name)."""
    from gcdm_bench.program import fp32_reference

    cfg, dev = run.config, run.device
    diffusion = _ref_diffusion(run, start["params"], dev)
    named = list(diffusion.net.named_parameters())
    names = [f"dynamics_network.{n}" for n, _ in named]
    opt_cfg = cfg["optimizer"]
    opt = ref.Optimizer([p for _, p in named], float(opt_cfg["lr"]), float(opt_cfg.get("b1", 0.9)),
                        float(opt_cfg.get("b2", 0.999)), float(opt_cfg.get("eps", 1e-8)),
                        float(opt_cfg["weight_decay"]), float(cfg["trainer"]["ema_decay"]))
    if "mu" in start:
        with torch.no_grad():
            for key in ("mu", "nu", "nu_max", "ema"):
                for t, n in zip(getattr(opt, key), names):
                    t.copy_(start[key][n])
        opt.count, opt.queue = start["count"], list(start["queue"])
    table = torch.as_tensor(log_pn_table(run.spec["sizes"]), device=dev)
    losses, mu1 = [], None
    with fp32_reference(tf32):
        for k in range(len(draws)):
            x, one_hot, charges, mask = batch_tensors(tr, k, dev)
            b, pad = mask.shape
            per = max(1, int(run.spec["reference_rows"]) // (pad * pad))
            for p in opt.params:
                p.grad = None
            total = 0.0
            for lo in range(0, b, per):
                sl = slice(lo, lo + per)
                m = mask[sl]
                n = m.sum(-1).long()
                nll = diffusion.l2_nll(ref.remove_mean(x[sl], m), one_hot[sl], charges[sl], m,
                                       draws[k]["t_int"][sl].to(dev), draws[k]["eps_t"][sl].to(dev),
                                       table[n.clamp(0, len(table) - 1)])
                (nll.sum() / b).backward()
                total += float(nll.detach().double().sum())
            losses.append(total / b)
            opt.step([p.grad if p.grad is not None else torch.zeros_like(p) for p in opt.params])
            if k == 0:
                mu1 = [m.detach().cpu().clone() for m in opt.mu]
    return {"losses": losses,
            "mu1": dict(zip(names, mu1)),
            "params": {n: p.detach().cpu().clone() for n, p in zip(names, opt.params)},
            "ema": {n: e.cpu().clone() for n, e in zip(names, opt.ema)}}


def _leaf_gaps(prog: Dict[str, torch.Tensor], refd: Dict[str, torch.Tensor], leaves: Sequence[str]) -> List[float]:
    """Each leaf's gap of norms over the larger of its and the median leaf's reference norm."""
    pn = {k: float(prog[k].double().norm()) for k in leaves}
    rn = {k: float(refd[k].double().norm()) for k in leaves}
    med = float(np.median(list(rn.values())))
    return [abs(pn[k] - rn[k]) / max(rn[k], med) if max(rn[k], med) > 0 else math.inf for k in leaves]


def step_readings(prog: Dict, reference: Dict, start: Dict, b1: float) -> Dict[str, float]:
    """The four numbers of a training cell, ``prog`` and ``reference`` as
    :func:`reference_steps` returns them, both from ``start``."""
    out = {"loss_gap": max(abs(p - r) / abs(r) if math.isfinite(p) else math.inf
                           for p, r in zip(prog["losses"], reference["losses"]))}
    leaves = list(reference["mu1"])
    mu0 = start.get("mu", {k: torch.zeros_like(v) for k, v in reference["mu1"].items()})

    def first_grad(mu1):  # the first step's clipped gradient, from the first moment before and after it
        return {k: (v - b1 * mu0[k]) / (1.0 - b1) for k, v in mu1.items()}

    grads = first_grad(reference["mu1"])
    out["grad_gap"] = max(_leaf_gaps(first_grad(prog["mu1"]), grads, leaves))
    norms = {k: float(v.double().norm()) for k, v in grads.items()}
    med = float(np.median(list(norms.values())))
    moved = [k for k in leaves if norms[k] >= MOVED * med]
    p0, e0 = start["params"], start["ema"]
    out["change_gap"] = max(_leaf_gaps({k: prog["params"][k] - p0[k].cpu() for k in moved},
                                       {k: reference["params"][k] - p0[k].cpu() for k in moved}, moved))
    # the EMA moves by (1 - decay) of its gap to the parameters, a few float32
    # steps of a weight: a small leaf's gap is its round-off, so the median leaf's is read
    out["ema_gap"] = float(np.median(_leaf_gaps({k: prog["ema"][k] - e0[k].cpu() for k in moved},
                                                {k: reference["ema"][k] - e0[k].cpu() for k in moved}, moved)))
    return out


def train_readings(run, tr, records: Dict, names: List[str], shapes: List, state: Dict) -> Dict[str, float]:
    """Each number the worse of set-up's first steps, from the benchmark's
    weights with a fresh optimizer, and the newest epoch's first steps, from
    the program's state at that epoch's start."""
    b1 = float(run.config["optimizer"].get("b1", 0.9))
    out: Dict[str, float] = {}
    for phase, rec in records.items():
        prog = {"losses": [float(x) for x in rec.losses], "mu1": rec.leaves("mu1", names, shapes),
                "params": rec.leaves("params", names, shapes), "ema": rec.leaves("ema", names, shapes)}
        if rec.fresh:
            start = {"params": state, "ema": state}
        else:
            start = {"params": rec.leaves("start.params", names, shapes),
                     "ema": rec.leaves("start.ema_params", names, shapes),
                     "mu": rec.leaves("start.mu", names, shapes), "nu": rec.leaves("start.nu", names, shapes),
                     "nu_max": rec.leaves("start.nu_max", names, shapes), "count": rec.counts["count"],
                     "queue": chronological(rec.host["start.gradnorm"], rec.counts["gradnorm"])}
        reference = reference_steps(run, tr, rec.draws, start, tf32=False)
        parts = {"": step_readings(prog, reference, start, b1)}
        if run.control:
            parts["control."] = step_readings(reference_steps(run, tr, rec.draws, start, tf32=True), reference,
                                              start, b1)
        for prefix, readings in parts.items():
            print(f"{prefix}{phase} steps: {readings}", file=sys.stderr)
            for k, v in readings.items():
                out[prefix + k] = max(out.get(prefix + k, -math.inf), v)
    return out

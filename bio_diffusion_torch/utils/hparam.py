"""Hyperparameter search: random + TPE-lite samplers over dotted config keys.

The PyTorch package's copy of ``bio_diffusion_tpu/utils/hparam.py`` (numpy
only; the same seed and the same recorded values give the same suggestions,
and ``study.json`` has the same format, so either package resumes the
other's study).  Counterpart of the reference's Optuna sweeper integration
(configs/hparams_search/qm9_optuna.yaml of the reference: TPESampler with
n_startup_trials random warmup, direction minimize, n_trials budget, a
params dict of ``interval(lo, hi)`` / ``choice(a, b, ...)`` specs).  Optuna
is not a dependency here; the study is a JSON file and the samplers are
self-contained:

  * ``random``: independent draws from each dimension.
  * ``tpe``: after ``n_startup_trials`` random trials, split observed trials
    into good/bad by the gamma-quantile of the objective and sample each
    dimension from a kernel density over the good trials, scored by the
    good/bad likelihood ratio (the core of Bergstra et al.'s TPE, one
    dimension at a time).

Search-space spec (JSON or dict), values mirroring the Hydra/Optuna syntax:

  {"model.optimizer.lr": "interval(1e-5, 1e-2, log)",
   "datamodule.dataloader_cfg.batch_size": "choice(32, 64, 128)",
   "model.model_cfg.num_encoder_layers": "int_interval(2, 9)"}
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


# ---------------------------------------------------------------------------
# search-space parsing
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Dimension:
    kind: str  # [choice, interval, int_interval]
    choices: Optional[List[Any]] = None
    low: float = 0.0
    high: float = 1.0
    log: bool = False

    def sample(self, rng: np.random.Generator) -> Any:
        if self.kind == "choice":
            return self.choices[int(rng.integers(len(self.choices)))]
        if self.log:
            v = math.exp(rng.uniform(math.log(self.low), math.log(self.high)))
        else:
            v = rng.uniform(self.low, self.high)
        if self.kind == "int_interval":
            return int(round(v))
        return float(v)


def _parse_scalar(tok: str) -> Any:
    tok = tok.strip()
    for cast in (int, float):
        try:
            return cast(tok)
        except ValueError:
            continue
    if tok.lower() in ("true", "false"):
        return tok.lower() == "true"
    return tok.strip("'\"")


def parse_dimension(spec: Any) -> Dimension:
    """Parse one search-space value: a list => choice; an
    ``interval(lo, hi[, log])`` / ``choice(...)`` / ``int_interval(lo, hi)``
    string mirrors the reference's Optuna params syntax."""
    if isinstance(spec, (list, tuple)):
        return Dimension(kind="choice", choices=list(spec))
    if not isinstance(spec, str):
        return Dimension(kind="choice", choices=[spec])
    m = re.match(r"^\s*(choice|interval|int_interval)\s*\((.*)\)\s*$", spec)
    if not m:
        return Dimension(kind="choice", choices=[_parse_scalar(spec)])
    fn, body = m.group(1), m.group(2)
    toks = [t for t in (s.strip() for s in body.split(",")) if t]
    if fn == "choice":
        return Dimension(kind="choice", choices=[_parse_scalar(t) for t in toks])
    log = len(toks) > 2 and toks[2].lower() in ("log", "true")
    return Dimension(kind=fn, low=float(toks[0]), high=float(toks[1]), log=log)


def parse_space(space: Dict[str, Any]) -> Dict[str, Dimension]:
    return {k: parse_dimension(v) for k, v in space.items()}


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


def _tpe_sample_dim(
    dim: Dimension,
    good: List[Any],
    bad: List[Any],
    rng: np.random.Generator,
    n_candidates: int = 24,
) -> Any:
    """One-dimensional TPE: draw candidates from the good-trial KDE and keep
    the one maximizing l(x)/g(x)."""
    if dim.kind == "choice":
        k = len(dim.choices)
        idx = {repr(c): i for i, c in enumerate(dim.choices)}
        gc = np.ones(k)
        bc = np.ones(k)
        for v in good:
            gc[idx.get(repr(v), 0)] += 1
        for v in bad:
            bc[idx.get(repr(v), 0)] += 1
        score = (gc / gc.sum()) / (bc / bc.sum())
        probs = (gc / gc.sum()) * score
        probs /= probs.sum()
        return dim.choices[int(rng.choice(k, p=probs))]

    def to_u(v):
        v = float(v)
        return math.log(v) if dim.log else v

    lo, hi = to_u(dim.low), to_u(dim.high)
    g = np.asarray([to_u(v) for v in good]) if good else np.asarray([0.5 * (lo + hi)])
    b = np.asarray([to_u(v) for v in bad]) if bad else np.asarray([0.5 * (lo + hi)])
    bw = max((hi - lo) / max(len(g), 1) * 1.2, (hi - lo) * 0.05)

    def kde(x, pts):
        d = (x[:, None] - pts[None, :]) / bw
        return np.exp(-0.5 * d * d).sum(axis=1) / (len(pts) * bw) + 1e-12

    centers = g[rng.integers(len(g), size=n_candidates)]
    cands = np.clip(centers + rng.normal(0, bw, size=n_candidates), lo, hi)
    ratio = kde(cands, g) / kde(cands, b)
    best = float(cands[int(np.argmax(ratio))])
    v = math.exp(best) if dim.log else best
    if dim.kind == "int_interval":
        return int(round(v))
    return float(v)


class Study:
    """A persistent hyperparameter study (JSON file).

    API mirrors the Optuna essentials: :meth:`suggest` a params dict,
    :meth:`record` an objective for it, :meth:`best_trial`.
    """

    def __init__(
        self,
        space: Dict[str, Any],
        direction: str = "minimize",
        sampler: str = "tpe",
        n_startup_trials: int = 10,
        gamma: float = 0.25,
        seed: int = 42,
        path: Optional[str] = None,
    ):
        assert direction in ("minimize", "maximize")
        assert sampler in ("random", "tpe")
        self.space = parse_space(space)
        self.raw_space = dict(space)
        self.direction = direction
        self.sampler = sampler
        self.n_startup_trials = n_startup_trials
        self.gamma = gamma
        self.seed = seed
        self.path = path
        self.trials: List[Dict[str, Any]] = []
        if path and os.path.exists(path):
            with open(path) as f:
                saved = json.load(f)
            self.trials = saved["trials"]

    # -- persistence --------------------------------------------------------

    def save(self):
        if not self.path:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "w") as f:
            json.dump(
                {
                    "space": self.raw_space,
                    "direction": self.direction,
                    "sampler": self.sampler,
                    "trials": self.trials,
                },
                f,
                indent=2,
            )

    # -- core ----------------------------------------------------------------

    def _completed(self) -> List[Dict[str, Any]]:
        return [t for t in self.trials if t.get("value") is not None]

    def suggest(self) -> Dict[str, Any]:
        """Sample the next trial's params and append a pending trial."""
        rng = np.random.default_rng(self.seed + len(self.trials))
        done = self._completed()
        if self.sampler == "random" or len(done) < self.n_startup_trials:
            params = {k: d.sample(rng) for k, d in self.space.items()}
        else:
            sign = 1.0 if self.direction == "minimize" else -1.0
            ranked = sorted(done, key=lambda t: sign * t["value"])
            n_good = max(1, int(math.ceil(self.gamma * len(ranked))))
            good, bad = ranked[:n_good], ranked[n_good:] or ranked[-1:]
            params = {
                k: _tpe_sample_dim(
                    d, [t["params"][k] for t in good], [t["params"][k] for t in bad], rng
                )
                for k, d in self.space.items()
            }
        self.trials.append({"number": len(self.trials), "params": params, "value": None})
        self.save()
        return params

    def record(self, params: Dict[str, Any], value: float):
        for t in self.trials:
            if t["params"] == params and t.get("value") is None:
                t["value"] = float(value)
                self.save()
                return
        self.trials.append({"number": len(self.trials), "params": params, "value": float(value)})
        self.save()

    def best_trial(self) -> Optional[Dict[str, Any]]:
        done = self._completed()
        if not done:
            return None
        pick = min if self.direction == "minimize" else max
        return pick(done, key=lambda t: t["value"])

    # -- driving -------------------------------------------------------------

    def optimize(self, objective, n_trials: int):
        """In-process loop: objective(params) -> float."""
        for _ in range(n_trials):
            params = self.suggest()
            value = objective(params)
            self.record(params, value)
        return self.best_trial()


def read_metric_from_csv(metrics_csv: str, metric: str, reduce: str = "last") -> float:
    """Pull the optimized metric out of a run's metrics.csv
    (reference optimized_metric, hparams_search/qm9_optuna.yaml)."""
    import csv

    values = []
    with open(metrics_csv) as f:
        for row in csv.DictReader(f):
            v = row.get(metric)
            if v not in (None, ""):
                values.append(float(v))
    if not values:
        raise KeyError(f"metric {metric!r} not found in {metrics_csv}")
    if reduce == "last":
        return values[-1]
    if reduce == "min":
        return min(values)
    if reduce == "max":
        return max(values)
    raise ValueError(f"unknown reduce {reduce!r}")

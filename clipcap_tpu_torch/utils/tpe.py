"""Tree-structured Parzen Estimator (TPE) for sweep optimization (a copy of
clipcap_tpu/utils/tpe.py: pure Python, so for the same seed and
observations its suggestions are the JAX package's).

The reference runs its sampling sweeps as wandb bayesian sweeps maximizing
Bleu_4 (reference blip_coco_val_sample_sweep_bayes_01.yaml:2-6). wandb is
a hosted service; this is the local equivalent: a TPE optimizer (Bergstra
et al. 2011, the algorithm behind hyperopt and wandb's bayes method) over
the same wandb-style parameter-space schema:

    {"top_p": {"min": 0.1, "max": 0.9},            # uniform float
     "min_len": {"min": 5, "max": 30},             # uniform int
     "lr": {"min": 1e-5, "max": 1e-2,
            "distribution": "log_uniform_values"}, # log-uniform
     "mode": {"values": ["ITM", "ITC"]},           # categorical
     "batch_size": {"value": 40}}                  # constant

Usage:
    opt = TPEOptimizer(space, seed=0)
    for _ in range(trials):
        params = opt.suggest()
        opt.observe(params, objective(params))
    best_params, best_value = opt.best()

Algorithm: after `n_startup` random trials, observations are split at the
`gamma` quantile into good/bad sets; each is modeled with a per-dimension
Parzen window (Gaussian KDE for numeric dims — in log space for
log-uniform — and a Laplace-smoothed histogram for categorical dims).
`n_candidates` draws from the good model are scored by
log l(x) - log g(x) and the argmax becomes the next trial.
"""

from __future__ import annotations

import math
import random
from typing import Dict, List, Optional, Tuple


class _Dim:
    """One parameter dimension parsed from a wandb-style spec."""

    def __init__(self, name: str, spec: dict):
        self.name = name
        if "value" in spec:
            self.kind = "const"
            self.value = spec["value"]
        elif "values" in spec:
            self.kind = "cat"
            self.choices = list(spec["values"])
        elif "min" in spec and "max" in spec:
            lo, hi = spec["min"], spec["max"]
            self.lo, self.hi = float(lo), float(hi)
            self.log = "log" in str(spec.get("distribution", ""))
            self.int = isinstance(lo, int) and isinstance(hi, int) and not self.log
            self.kind = "num"
        else:
            raise ValueError(f"unsupported parameter spec for {name!r}: {spec}")

    # numeric dims work in an internal coordinate (log space when log-uniform)
    def _to_internal(self, v: float) -> float:
        return math.log(v) if self.log else float(v)

    def _from_internal(self, u: float) -> float:
        v = math.exp(u) if self.log else u
        v = min(max(v, self.lo), self.hi)
        return int(round(v)) if self.int else v

    def sample_prior(self, rng: random.Random):
        if self.kind == "const":
            return self.value
        if self.kind == "cat":
            return rng.choice(self.choices)
        if self.int:
            return rng.randint(int(self.lo), int(self.hi))
        if self.log:
            return self._from_internal(rng.uniform(math.log(self.lo), math.log(self.hi)))
        return rng.uniform(self.lo, self.hi)

    # ---- Parzen models ----------------------------------------------------
    def _bandwidth(self, n_obs: int) -> float:
        span = self._to_internal(self.hi) - self._to_internal(self.lo)
        return max(span / max(math.sqrt(n_obs), 1.0), 1e-3 * max(span, 1e-12))

    def sample_model(self, obs: list, rng: random.Random):
        """Draw from the Parzen window fitted to `obs` (good set)."""
        if self.kind == "const":
            return self.value
        if self.kind == "cat":
            # Laplace-smoothed categorical: counts + 1
            weights = [1.0 + sum(1 for o in obs if o == c) for c in self.choices]
            return rng.choices(self.choices, weights=weights)[0]
        if not obs:
            return self.sample_prior(rng)
        center = self._to_internal(rng.choice(obs))
        return self._from_internal(rng.gauss(center, self._bandwidth(len(obs))))

    def log_density(self, v, obs: list) -> float:
        """log density of v under the Parzen window fitted to `obs`."""
        if self.kind == "const":
            return 0.0
        if self.kind == "cat":
            weights = [1.0 + sum(1 for o in obs if o == c) for c in self.choices]
            total = sum(weights)
            try:
                i = self.choices.index(v)
            except ValueError:
                return -math.inf
            return math.log(weights[i] / total)
        if not obs:  # uniform prior over the range
            span = self._to_internal(self.hi) - self._to_internal(self.lo)
            return -math.log(max(span, 1e-12))
        u = self._to_internal(v)
        bw = self._bandwidth(len(obs))
        # mixture of Gaussians at the observations (+ the uniform prior as
        # one extra component, hyperopt-style, so densities never hit zero)
        span = self._to_internal(self.hi) - self._to_internal(self.lo)
        comps = [
            -0.5 * ((u - self._to_internal(o)) / bw) ** 2
            - math.log(bw * math.sqrt(2 * math.pi))
            for o in obs
        ]
        comps.append(-math.log(max(span, 1e-12)))
        m = max(comps)
        return m + math.log(sum(math.exp(c - m) for c in comps)) - math.log(len(comps))


class TPEOptimizer:
    def __init__(
        self,
        space: Dict[str, dict],
        seed: int = 0,
        n_startup: int = 5,
        gamma: float = 0.25,
        n_candidates: int = 24,
        maximize: bool = True,
    ):
        self.dims = [_Dim(k, v) for k, v in space.items()]
        self.rng = random.Random(seed)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.maximize = maximize
        self.trials: List[Tuple[dict, float]] = []

    def suggest(self) -> dict:
        if len(self.trials) < self.n_startup:
            return {d.name: d.sample_prior(self.rng) for d in self.dims}

        ordered = sorted(
            self.trials, key=lambda t: t[1], reverse=self.maximize
        )
        n_good = max(1, int(math.ceil(self.gamma * len(ordered))))
        good = [t[0] for t in ordered[:n_good]]
        bad = [t[0] for t in ordered[n_good:]] or good

        best_cand, best_score = None, -math.inf
        for _ in range(self.n_candidates):
            cand = {
                d.name: d.sample_model([g[d.name] for g in good], self.rng)
                for d in self.dims
            }
            score = sum(
                d.log_density(cand[d.name], [g[d.name] for g in good])
                - d.log_density(cand[d.name], [b[d.name] for b in bad])
                for d in self.dims
            )
            if score > best_score:
                best_cand, best_score = cand, score
        return best_cand

    def observe(self, params: dict, value: float) -> None:
        if value == value:  # drop NaN trials
            self.trials.append((dict(params), float(value)))

    def best(self) -> Tuple[Optional[dict], float]:
        if not self.trials:
            return None, -math.inf if self.maximize else math.inf
        pick = max if self.maximize else min
        params, value = pick(self.trials, key=lambda t: t[1])
        return params, value

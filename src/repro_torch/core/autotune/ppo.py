"""PPO-based design-space exploration (paper Algo. 3), in PyTorch.

MDP: state s = [config p, predicted metrics m]; action a = bounded delta on
the normalized config vector; reward R = wᵀm (task-priority weights) with a
large negative penalty outside hardware constraints.  Gaussian policy +
value MLP on ``device``, clipped-objective PPO with GAE(λ)/TD value
targets, updated by plain SGD (``p ← p − lr·g``) as the JAX package does.

One ``torch.Generator`` seeded with ``PPOConfig.seed`` draws the initial
weights (then moved to ``device``) and every action's noise on the CPU, so
a card run and a CPU run of one seed start from the same numbers.  The
rollout reads the policy mean and the value back to the host once a step,
as the JAX agent does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.autotune.space import Space

VIOLATION_REWARD = -100.0      # "-inf" of Algo. 3, kept finite for stability


class MLP(nn.Module):
    """``x @ w + b`` per layer, tanh between layers.  Weights are ``(in,
    out)``, the JAX package's layout, so converted weights map as they
    are."""

    def __init__(self, layers: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
        super().__init__()
        self.w = nn.ParameterList([nn.Parameter(w) for w, _ in layers])
        self.b = nn.ParameterList([nn.Parameter(b) for _, b in layers])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.w)
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            x = x @ w + b
            if i < n - 1:
                x = torch.tanh(x)
        return x


def mlp_init(gen: torch.Generator, sizes: Sequence[int], device) -> MLP:
    """Weights ``randn(i, o) / sqrt(i)`` drawn from ``gen``, zero biases."""
    layers = [(torch.randn(i, o, generator=gen) / math.sqrt(i),
               torch.zeros(o)) for i, o in zip(sizes[:-1], sizes[1:])]
    return MLP(layers).to(device)


@dataclass
class PPOConfig:
    action_scale: float = 0.3
    clip_eps: float = 0.2
    gamma: float = 0.95
    lam: float = 0.9
    lr: float = 5e-3
    epochs_per_update: int = 4
    horizon: int = 16
    updates: int = 20
    hidden: int = 64
    init_log_std: float = -0.7
    seed: int = 0


class PPOAgent:
    """Explores the space against a (surrogate) evaluator.

    ``evaluate(cfg_dict) -> {"throughput","memory","accuracy"}``
    ``constraint(metrics) -> bool`` — True if feasible.
    """

    def __init__(self, space: Space, evaluate: Callable[[Dict], Dict],
                 w: Dict[str, float], constraint: Callable[[Dict], bool],
                 cfg: PPOConfig = PPOConfig(), device="cuda"):
        self.space = space
        self.evaluate = evaluate
        self.w = w
        self.constraint = constraint
        self.cfg = cfg
        self.device = torch.device(device)
        self._gen = torch.Generator().manual_seed(cfg.seed)
        sdim = space.dim + 3                      # state = config ⊕ metrics
        self.pi = mlp_init(self._gen, [sdim, cfg.hidden, cfg.hidden,
                                       space.dim], self.device)
        self.log_std = nn.Parameter(torch.full((space.dim,), cfg.init_log_std,
                                               device=self.device))
        self.vf = mlp_init(self._gen, [sdim, cfg.hidden, cfg.hidden, 1],
                           self.device)
        self.best_cfg: Optional[Dict] = None
        self.best_u: Optional[np.ndarray] = None
        self.best_reward = -np.inf
        self.history: List[Tuple[Dict, Dict, float]] = []
        self.evals = 0

    def parameters(self) -> List[nn.Parameter]:
        """Policy weights, ``log_std``, value weights — the update's order."""
        return [*self.pi.parameters(), self.log_std, *self.vf.parameters()]

    # -- reward --------------------------------------------------------------
    def reward(self, metrics: Dict) -> float:
        if not self.constraint(metrics):
            return VIOLATION_REWARD
        m = np.array([metrics["throughput"], -metrics["memory"],
                      metrics["accuracy"]])
        wv = np.array([self.w.get("throughput", 0.0), self.w.get("memory", 0.0),
                       self.w.get("accuracy", 0.0)])
        return float(wv @ m)

    def _metrics_vec(self, metrics: Dict) -> np.ndarray:
        return np.array([np.log(max(metrics["throughput"], 1e-9)),
                         np.log(max(metrics["memory"], 1.0)) / 20.0,
                         metrics["accuracy"]])

    def _state(self, u: np.ndarray, metrics: Dict) -> np.ndarray:
        return np.concatenate([u, self._metrics_vec(metrics)])

    def _f32(self, x) -> torch.Tensor:
        # the rollout's arrays are float64 numpy; the nets run in float32
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=self.device)

    # -- rollout -------------------------------------------------------------
    def _rollout(self, u0: np.ndarray):
        cfgc = self.cfg
        states, actions, logps, rewards, values = [], [], [], [], []
        u = u0.copy()
        std = np.exp(self.log_std.detach().cpu().numpy())
        cfg0 = self.space.decode(u)
        metrics = self.evaluate(cfg0)
        self.evals += 1
        r0 = self.reward(metrics)
        self.history.append((cfg0, metrics, r0))
        if r0 > self.best_reward:
            self.best_reward, self.best_cfg, self.best_u = r0, cfg0, u.copy()
        for _ in range(cfgc.horizon):
            s = self._state(u, metrics)
            noise = torch.randn(self.space.dim, generator=self._gen).numpy()
            with torch.no_grad():
                st = self._f32(s)
                # one read back to the host per step, as the JAX agent's
                mu_v = torch.cat([self.pi(st), self.vf(st)]).cpu().numpy()
            mu, v = mu_v[:-1], float(mu_v[-1])
            a = mu + std * noise
            logp = float(-0.5 * (((a - mu) / std) ** 2
                                 + 2 * np.log(std) + np.log(2 * np.pi)).sum())
            # apply action (Algo. 3 line 4: clip to valid range)
            u = self.space.clip(u + cfgc.action_scale * np.tanh(a))
            cfg_dict = self.space.decode(u)
            metrics = self.evaluate(cfg_dict)
            self.evals += 1
            r = self.reward(metrics)
            self.history.append((cfg_dict, metrics, r))
            if r > self.best_reward:
                self.best_reward, self.best_cfg = r, cfg_dict
                self.best_u = u.copy()
            states.append(s)
            actions.append(a)
            logps.append(logp)
            rewards.append(r)
            values.append(v)
        return (np.array(states), np.array(actions), np.array(logps),
                np.array(rewards), np.array(values))

    # -- PPO update ----------------------------------------------------------
    def _loss(self, s, a, logp_old, ret, adv) -> torch.Tensor:
        cfgc = self.cfg
        mu = self.pi(s)
        log_std = self.log_std
        std = torch.exp(log_std)
        logp = (-0.5 * (((a - mu) / std) ** 2 + 2 * log_std
                        + math.log(2 * math.pi))).sum(-1)
        ratio = torch.exp(logp - logp_old)
        # the population std, as jnp.std
        adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        l_clip = -torch.mean(torch.minimum(
            ratio * adv_n,
            torch.clamp(ratio, 1 - cfgc.clip_eps, 1 + cfgc.clip_eps) * adv_n))
        v = self.vf(s)[:, 0]
        l_v = torch.mean((v - ret) ** 2)
        return l_clip + 0.5 * l_v - 0.001 * torch.mean(log_std)

    def _update(self, batch):
        s, a, logp_old, ret, adv = [self._f32(x) for x in batch]
        params = self.parameters()
        grads = torch.autograd.grad(self._loss(s, a, logp_old, ret, adv),
                                    params)
        lr = self.cfg.lr
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(lr * g)
            self.log_std.clamp_(-2.5, 0.0)

    def _gae(self, rewards, values):
        cfgc = self.cfg
        adv = np.zeros_like(rewards)
        last = 0.0
        for t in reversed(range(len(rewards))):
            nxt = values[t + 1] if t + 1 < len(values) else 0.0
            delta = rewards[t] + cfgc.gamma * nxt - values[t]
            last = delta + cfgc.gamma * cfgc.lam * last
            adv[t] = last
        return adv, adv + values

    # -- main loop (Algo. 3) ---------------------------------------------------
    def run(self, rng: Optional[np.random.Generator] = None) -> Dict:
        rng = rng or np.random.default_rng(self.cfg.seed)
        for upd in range(self.cfg.updates):
            # explore from a fresh random config half the time; otherwise
            # continue the trajectory from the incumbent (Algo. 3 keeps
            # refining p* while the clipped policy update keeps exploring)
            if self.best_u is None or upd % 2 == 0:
                u0 = rng.random(self.space.dim)
            else:
                u0 = self.space.clip(self.best_u
                                     + 0.05 * rng.standard_normal(self.space.dim))
            s, a, logp, r, v = self._rollout(u0)
            adv, ret = self._gae(r, v)
            for _ in range(self.cfg.epochs_per_update):
                self._update((s, a, logp, ret, adv))
        return self.best_cfg

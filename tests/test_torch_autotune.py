"""The auto-tuner's offline tools, the port against the JAX package on the
same numpy inputs: the design space, the Pareto tools and the surrogate
bit-equal (the same numpy code); PPO from the JAX agent's converted
parameters (``models/convert.ppo_params_from_jax``): the policy mean and
the value within 1e-6, one or four SGD updates on a fixed rollout within
1e-5 (f32 on two frameworks' CPU kernels), GAE and the reward exactly.
Whole PPO runs draw from another random stream than ``jax.random``, so
they are held by the behaviour tests of ``tests/test_autotune.py``,
ported as they are."""
import jax
import numpy as np
import pytest
import torch

from repro.core.autotune import pareto as jx_pareto
from repro.core.autotune import surrogate as jx_sur
from repro.core.autotune.ppo import PPOAgent as JxAgent
from repro.core.autotune.ppo import PPOConfig as JxConfig
from repro.core.autotune.ppo import _mlp as jx_mlp
from repro.core.autotune.space import Space as JxSpace
from repro.core.autotune.space import design_space as jx_design_space
from repro_torch.core.autotune import pareto, surrogate
from repro_torch.core.autotune.pareto import (grid_search, pareto_front,
                                              select_endpoints)
from repro_torch.core.autotune.ppo import (VIOLATION_REWARD, PPOAgent,
                                           PPOConfig)
from repro_torch.core.autotune.space import Space, design_space
from repro_torch.core.autotune.surrogate import GBDT, Ridge, Surrogate, r2_score
from repro_torch.models.convert import ppo_params_from_jax


def _synthetic_perf(u):
    """The response surface of ``tests/test_autotune.py``."""
    thr = 0.1 + 0.5 * u[:, 0] + 0.8 * u[:, 4] * u[:, 6] + 0.2 * u[:, 2]
    mem = 50e6 * (1 + 3 * u[:, 4] * (u[:, 6] > 0.33) + 2 * u[:, 5] + u[:, 0])
    acc = 0.75 - 0.05 * u[:, 2] ** 2 + 0.01 * u[:, 5]
    return {"throughput": thr, "memory": mem, "accuracy": acc}


def _evaluator(sp):
    def evaluate(cfg):
        m = _synthetic_perf(sp.encode(cfg)[None])
        return {k: float(v[0]) for k, v in m.items()}
    return evaluate


W = {"throughput": 1.0, "memory": 1e-9, "accuracy": 0.5}


# ---------------------------------------------------------------------------
# space, pareto, surrogate: bit-equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"max_partitions": 2, "max_workers": 3,
                                     "max_cache_mb": 64.0}])
def test_space_matches_jax(kw):
    sp, jsp = Space(design_space(**kw)), JxSpace(jx_design_space(**kw))
    u = np.random.default_rng(0).random((64, sp.dim))
    u[:4] = [[0.0] * sp.dim, [1.0] * sp.dim, [0.5] * sp.dim, [1.2] * sp.dim]
    for row in u:
        assert sp.decode(row) == jsp.decode(row)
        assert np.array_equal(sp.encode(sp.decode(row)),
                              jsp.encode(jsp.decode(row)))
    assert np.array_equal(sp.clip(u * 2 - 0.5), jsp.clip(u * 2 - 0.5))
    assert np.array_equal(sp.grid(3), jsp.grid(3))
    assert np.array_equal(sp.sample(np.random.default_rng(5), 7),
                          jsp.sample(np.random.default_rng(5), 7))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pareto_tools_match_jax(seed):
    rng = np.random.default_rng(seed)
    pts = rng.random((40, 3))
    pts[5] = pts[6]                                 # a tie
    assert np.array_equal(pareto_front(pts), jx_pareto.pareto_front(pts))
    hist = [({"i": i}, {"throughput": float(t), "memory": float(m) * 1e8,
                        "accuracy": float(a)}, 0.0)
            for i, (t, m, a) in enumerate(rng.random((25, 3)))]
    assert pareto.front_from_history(hist) == \
        jx_pareto.front_from_history(hist)
    assert select_endpoints(hist) == jx_pareto.select_endpoints(hist)
    sp, jsp = Space(), JxSpace()
    ev = _evaluator(sp)

    def reward(m):
        return m["throughput"] - 1e-9 * m["memory"]
    assert grid_search(sp, ev, reward, 2, target=0.9) == \
        jx_pareto.grid_search(jsp, ev, reward, 2, target=0.9)


def test_surrogate_matches_jax():
    rng = np.random.default_rng(0)
    sp = Space()
    X, Xte = sp.sample(rng, 200), sp.sample(rng, 50)
    Y = {k: v * (1 + 0.02 * rng.normal(size=len(v)))
         for k, v in _synthetic_perf(X).items()}
    s = Surrogate(n_trees=12).fit(X, Y)
    js = jx_sur.Surrogate(n_trees=12).fit(X, Y)
    got, want = s.predict(Xte), js.predict(Xte)
    assert got.keys() == want.keys()
    for m in got:
        assert np.array_equal(got[m], want[m]), m
    assert s.r2(Xte, _synthetic_perf(Xte)) == \
        js.r2(Xte, _synthetic_perf(Xte))
    y = np.sin(6 * X[:, 0]) + X[:, 1] * X[:, 2]
    assert np.array_equal(GBDT(n_trees=10).fit(X, y).predict(Xte),
                          jx_sur.GBDT(n_trees=10).fit(X, y).predict(Xte))
    assert np.array_equal(Ridge(0.5).fit(X, y).predict(Xte),
                          jx_sur.Ridge(0.5).fit(X, y).predict(Xte))
    pred = Ridge().fit(X, y).predict(X)
    assert r2_score(y, pred) == jx_sur.r2_score(y, pred)
    assert surrogate.METRICS == jx_sur.METRICS


# ---------------------------------------------------------------------------
# PPO: from the JAX agent's parameters
# ---------------------------------------------------------------------------

def _agents(constraint=lambda m: True):
    jsp, sp = JxSpace(), Space()
    jx = JxAgent(jsp, _evaluator(jsp), W, constraint, JxConfig(seed=0))
    pt = PPOAgent(sp, _evaluator(sp), W, constraint, PPOConfig(seed=0),
                  device="cpu")
    pt.pi, pt.log_std, pt.vf = ppo_params_from_jax(
        jax.tree.map(np.asarray, jx.pi), np.asarray(jx.log_std),
        jax.tree.map(np.asarray, jx.vf), "cpu")
    return jx, pt


def test_converted_policy_and_value_match_jax():
    jx, pt = _agents()
    # jax.tree.leaves orders each layer's dict b, w; the port's
    # parameters() lists every w, then every b — compare by name instead
    for mod, layers in ((pt.pi, jx.pi), (pt.vf, jx.vf)):
        for w, b, p in zip(mod.w, mod.b, layers, strict=True):
            assert np.array_equal(w.detach().numpy(), np.asarray(p["w"]))
            assert np.array_equal(b.detach().numpy(), np.asarray(p["b"]))
    s = np.random.default_rng(0).random((32, jx.space.dim + 3))
    with torch.no_grad():
        st = torch.as_tensor(s, dtype=torch.float32)
        mu, v = pt.pi(st).numpy(), pt.vf(st).numpy()
    mu_j = np.asarray(jax.vmap(lambda x: jx_mlp(jx.pi, x))(s))
    v_j = np.asarray(jax.vmap(lambda x: jx_mlp(jx.vf, x))(s))
    assert mu.dtype == np.float32
    np.testing.assert_allclose(mu, mu_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(v, v_j, rtol=0, atol=1e-6)


@pytest.mark.parametrize("updates", [1, 4])
def test_ppo_update_matches_jax(updates):
    """``updates`` SGD steps on one rollout of the JAX agent (float64 numpy,
    cast to float32 by both) — every parameter and ``log_std`` within 1e-5;
    after the first, ratios leave 1 and clip.  A sample std of the
    advantages (``torch.std``'s default) in place of JAX's population std
    fails this."""
    jx, pt = _agents()
    s, a, logp, r, v = jx._rollout(np.random.default_rng(3).random(7))
    assert s.dtype == np.float64 and a.dtype == np.float32
    adv, ret = jx._gae(r, v)
    adv_t, ret_t = pt._gae(r, v)
    assert np.array_equal(adv, adv_t) and np.array_equal(ret, ret_t)
    for _ in range(updates):
        jx._update((s, a, logp, ret, adv))
        pt._update((s, a, logp, ret, adv))
    for mod, layers in ((pt.pi, jx.pi), (pt.vf, jx.vf)):
        for w, b, p in zip(mod.w, mod.b, layers, strict=True):
            np.testing.assert_allclose(w.detach().numpy(), np.asarray(p["w"]),
                                       rtol=0, atol=1e-5)
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(p["b"]),
                                       rtol=0, atol=1e-5)
    np.testing.assert_allclose(pt.log_std.detach().numpy(),
                               np.asarray(jx.log_std), rtol=0, atol=1e-5)
    assert all(p.dtype == torch.float32 for p in pt.parameters())


def test_gae_and_reward_match_jax():
    limit = 150e6
    jx, pt = _agents(constraint=lambda m: m["memory"] < limit)
    rng = np.random.default_rng(2)
    r, v = rng.normal(size=9), rng.normal(size=9)
    for got, want in zip(pt._gae(r, v), jx._gae(r, v)):
        assert np.array_equal(got, want)
    ev = _evaluator(pt.space)
    for u in pt.space.sample(rng, 20):
        m = ev(pt.space.decode(u))
        assert pt.reward(m) == jx.reward(m)
    assert pt.reward({"throughput": 1.0, "memory": 2 * limit,
                      "accuracy": 1.0}) == VIOLATION_REWARD


def test_agent_seeds_its_own_stream():
    """One seed, one generator: the same initial weights and noise every
    time, on whichever device the nets live."""
    a = PPOAgent(Space(), lambda c: {}, W, lambda m: True,
                 PPOConfig(seed=3), device="cpu")
    b = PPOAgent(Space(), lambda c: {}, W, lambda m: True,
                 PPOConfig(seed=3), device="cpu")
    for x, y in zip(a.parameters(), b.parameters(), strict=True):
        assert torch.equal(x, y) and x.device.type == "cpu"
    assert torch.equal(torch.randn(7, generator=a._gen),
                       torch.randn(7, generator=b._gen))


# ---------------------------------------------------------------------------
# whole runs: tests/test_autotune.py:130-168, ported as they are
# ---------------------------------------------------------------------------

def _make_agent(w=None, constraint=None, updates=6):
    sp = Space()
    evaluate = _evaluator(sp)
    w = w or W
    constraint = constraint or (lambda m: True)
    return PPOAgent(sp, evaluate, w, constraint,
                    PPOConfig(updates=updates, horizon=8, seed=0),
                    device="cpu"), sp, evaluate


def test_ppo_improves_over_random():
    agent, sp, evaluate = _make_agent(updates=32)
    best = agent.run()
    assert best is not None
    # PPO's incumbent beats the 90th percentile of a 200-point random sweep
    rng = np.random.default_rng(0)
    rand = sorted(agent.reward(evaluate(sp.decode(u)))
                  for u in sp.sample(rng, 200))
    assert agent.best_reward >= rand[int(0.9 * len(rand))]


def test_ppo_respects_constraints():
    """Algo. 3 line 7-8: constraint violations get the -inf reward and are
    never selected as the recommendation."""
    limit = 150e6
    agent, sp, evaluate = _make_agent(
        constraint=lambda m: m["memory"] < limit, updates=6)
    best = agent.run()
    assert evaluate(best)["memory"] < limit
    viol = [r for _, m, r in agent.history if m["memory"] >= limit]
    assert all(r == VIOLATION_REWARD for r in viol)


def test_ppo_faster_than_grid():
    """The paper's 2.1× exploration-efficiency claim, measured as
    evaluations needed to reach (near-)grid-best reward."""
    agent, sp, evaluate = _make_agent(updates=32)
    agent.run()

    def reward(m):
        return agent.reward(m)
    _, grid_best, grid_evals, _ = grid_search(sp, evaluate, reward,
                                              points_per_dim=3)
    to_match = None
    for i, (_, m, r) in enumerate(agent.history):
        if r >= grid_best * 0.9:
            to_match = i + 1
            break
    assert to_match is not None, \
        f"PPO never reached 0.9×grid ({agent.best_reward} vs {grid_best})"
    assert to_match < grid_evals / 2, (to_match, grid_evals)

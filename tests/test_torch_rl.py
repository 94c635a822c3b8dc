"""Port parity: ray_tpu_torch.rl against ray_tpu.rl, on the CPU.

The numpy pieces (CartPole, GAE, replay sampling) must equal the JAX
package's exactly. The modules run on weights converted from JAX's init.
The learners take one update each on the same weights and the same numpy
batch, in f32 on both sides. The runners sample with the same weights and
seed. A local PPO loop, driven by hand as ``ray_tpu/rl/ppo.py`` drives it,
must reach JAX's learning bar.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rl import dqn as jdqn
from ray_tpu.rl import env as jenv
from ray_tpu.rl import learner as jlearner
from ray_tpu.rl import module as jmodule
from ray_tpu.rl import replay_buffers as jreplay
from ray_tpu.rl import sample_batch as jsb
from ray_tpu.rl import vector_env as jvec
from ray_tpu_torch import rl
from ray_tpu_torch.rl import module as tmodule
from ray_tpu_torch.rl import sample_batch as SB

torch.set_num_threads(2)

# Module forward, f32 on both sides: logits and values to 1e-6.
FWD_ATOL = 1e-6
# One update's stats (losses, entropy, KL, mean rho, TD error) to 1e-5
# relative.
STATS_RTOL = 1e-5
# The updated parameters, normwise per tensor: ||p_port - p_jax||_F <=
# PARAM_RTOL * ||p_jax||_F, the bound of chip_smoke.py's phase 12(a) (card
# against CPU). Adam's first step is lr * g / (|g| + eps), close to
# lr * sign(g), so a gradient element at rounding level could come out with
# the other sign. Largest readings on an 8-core Intel Xeon, 2 threads: 3.1e-7
# (PPO), 2.6e-7 (V-trace), 5.4e-7 (loss_fn=), 2.0e-7 (clipped), 9.7e-7 (DQN,
# online and target, over 5 updates); the card against the CPU read at most
# 3.9e-7. The bound is about twice the largest.
PARAM_RTOL = 2e-6

OBS, ACTIONS = 4, 2


def _jax_weights(kind="policy", hidden=(64, 64), seed=0):
    cls = (jmodule.DiscretePolicyModule if kind == "policy"
           else jmodule.QNetworkModule)
    m = cls(OBS, ACTIONS, hidden=hidden)
    return m, jax.tree_util.tree_map(np.asarray,
                                     m.init(jax.random.PRNGKey(seed)))


def _port_module(kind="policy", hidden=(64, 64), weights=None):
    cls = (tmodule.DiscretePolicyModule if kind == "policy"
           else tmodule.QNetworkModule)
    m = cls(OBS, ACTIONS, hidden=hidden)
    if weights is not None:
        m.load_state_dict(rl.params_from_jax(weights))
    return m


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_params_close(port_nested, jax_nested):
    for (path, p), (_, j) in zip(
            jax.tree_util.tree_leaves_with_path(port_nested),
            jax.tree_util.tree_leaves_with_path(jax_nested)):
        j = np.asarray(j)
        err = np.linalg.norm(p - j)
        assert err <= PARAM_RTOL * np.linalg.norm(j), (path, err)


def _assert_stats_close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=STATS_RTOL,
                                   err_msg=k)


# --- numpy copies -----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_cartpole_trajectory_equals_jax(seed):
    actions = np.random.default_rng(seed + 100).integers(0, 2, 300)

    def run(env):
        out = [env.reset()[0]]
        for a in actions:
            obs, r, term, trunc, _ = env.step(int(a))
            out.append(np.concatenate([obs, [r, term, trunc]]))
            if term or trunc:
                out.append(env.reset()[0])
        return out

    want = run(jenv.CartPoleEnv(seed=seed))
    got = run(rl.CartPoleEnv(seed=seed))
    assert len(got) == len(want) > 301
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_random_env_equals_jax():
    envs = [jenv.RandomEnv(episode_len=5, seed=1),
            rl.RandomEnv(episode_len=5, seed=1)]
    for j, t in zip(*(e.reset() for e in envs)):
        np.testing.assert_array_equal(j, t)
    for a in range(12):
        for j, t in zip(*(e.step(a % 2) for e in envs)):
            np.testing.assert_array_equal(j, t)


def test_compute_gae_equals_jax():
    rng = np.random.default_rng(0)
    n = 200
    cols = {SB.REWARDS: rng.normal(size=n).astype(np.float32),
            SB.VF_PREDS: rng.normal(size=n).astype(np.float32),
            SB.DONES: rng.random(n) < 0.05}
    for last in (0.0, 1.7):
        want = jsb.compute_gae(jsb.SampleBatch(cols), gamma=0.97, lam=0.9,
                               last_value=last)
        got = rl.compute_gae(rl.SampleBatch(cols), gamma=0.97, lam=0.9,
                             last_value=last)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # shuffle, minibatches and concat are the same numpy code
    want = jsb.concat_batches(list(jsb.SampleBatch(cols).shuffle(seed=4)
                                   .minibatches(64)))
    got = rl.concat_batches(list(rl.SampleBatch(cols).shuffle(seed=4)
                                 .minibatches(64)))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_uniform_replay_sampling_equals_jax():
    bufs = [jreplay.ReplayBuffer(50, seed=3), rl.ReplayBuffer(50, seed=3)]
    for i in range(80):                      # wraps the ring
        for b in bufs:
            b.add(i)
    for n in (1, 7, 40):
        assert bufs[0].sample(n) == bufs[1].sample(n)
    assert bufs[0].stats() == bufs[1].stats()
    assert rl.ReplayBuffer(4).sample(3) == []


def test_prioritized_replay_sampling_equals_jax():
    bufs = [jreplay.PrioritizedReplayBuffer(30, alpha=0.7, seed=5),
            rl.PrioritizedReplayBuffer(30, alpha=0.7, seed=5)]
    prios = np.random.default_rng(1).normal(size=45)
    for i, p in enumerate(prios):
        for b in bufs:
            b.add(i, priority=None if i % 4 == 0 else p)
    for beta in (0.4, 1.0):
        (ji, jidx, jw), (ti, tidx, tw) = (b.sample(16, beta=beta)
                                          for b in bufs)
        assert ji == ti
        np.testing.assert_array_equal(jidx, tidx)
        np.testing.assert_array_equal(jw, tw)
        td = np.random.default_rng(2).normal(size=len(jidx))
        for b in bufs:
            b.update_priorities(jidx, td)
    np.testing.assert_array_equal(bufs[0]._prios, bufs[1]._prios)


# --- modules and weights ----------------------------------------------------

@pytest.mark.parametrize("kind", ["policy", "q"])
@pytest.mark.parametrize("hidden", [(64, 64), (8,)], ids=["64x64", "8"])
def test_module_forward_matches_jax(kind, hidden):
    jm, w = _jax_weights(kind, hidden)
    tm = _port_module(kind, hidden, w)
    obs = np.random.default_rng(0).normal(size=(33, OBS)).astype(np.float32)
    want = jm.forward(_jnp(w), jnp.asarray(obs))
    got = tm(torch.from_numpy(obs))
    for g, j in zip(got if kind == "policy" else [got],
                    want if kind == "policy" else [want]):
        assert tuple(g.shape) == j.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(j),
                                   rtol=0, atol=FWD_ATOL)


def test_params_round_trip_and_layout():
    for kind in ("policy", "q"):
        _, w = _jax_weights(kind, (16, 8))
        state = rl.params_from_jax(w)
        assert set(state) == set(dict(_port_module(
            kind, (16, 8)).named_parameters()))
        back = rl.params_to_jax(state)
        assert jax.tree_util.tree_structure(back) == \
            jax.tree_util.tree_structure(w)
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(w)):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    assert set(rl.params_from_jax(w)) == {"torso.0.w", "torso.0.b",
                                          "torso.1.w", "torso.1.b",
                                          "q.w", "q.b"}


@pytest.mark.parametrize("shape", [(4, 64), (64, 64), (64, 2), (3, 8)])
def test_init_is_jax_orthogonal_init(shape):
    """The same construction as JAX's _dense_init: orthonormal columns
    (rows when n_in < n_out, tiled by jnp.resize), scaled, zero bias."""
    q = np.random.default_rng(0).normal(
        size=(min(shape), min(shape))).astype(np.float32)
    np.testing.assert_array_equal(
        tmodule._resize(torch.from_numpy(q), shape).numpy(),
        np.asarray(jnp.resize(jnp.asarray(q), shape)))
    w = tmodule._orthogonal(torch.Generator().manual_seed(1), *shape,
                            2.0).double()
    k = min(shape)
    core = w if shape[0] >= shape[1] else w.reshape(-1)[:k * k].reshape(k, k)
    gram = core.T @ core
    np.testing.assert_allclose(gram.numpy(), 4.0 * np.eye(k), atol=1e-5)
    if shape[0] < shape[1]:
        flat = w.reshape(-1)
        np.testing.assert_array_equal(flat[shape[0] ** 2:].numpy(),
                                      flat[:flat.numel() - shape[0] ** 2]
                                      .numpy())
    m = tmodule.DiscretePolicyModule(OBS, ACTIONS)
    before = {n: p.clone() for n, p in m.named_parameters()}
    m.init_weights(0)
    assert all(torch.equal(before[n], p) for n, p in m.named_parameters())
    m.init_weights(1)
    assert not torch.equal(before["torso.0.w"], m.torso[0].w)
    assert not m.pi.b.any() and not m.vf.b.any()


def test_action_dist_logp_and_value_match_jax():
    jm, w = _jax_weights()
    tm = _port_module(weights=w)
    obs = np.random.default_rng(0).normal(size=(500, OBS)).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    action, logp, value = tm.action_dist(torch.from_numpy(obs), gen)
    assert action.dtype == torch.int64 and set(action.tolist()) == {0, 1}
    logits, jvalue = jm.forward(_jnp(w), jnp.asarray(obs))
    jlogp = np.asarray(jax.nn.log_softmax(logits))[np.arange(500),
                                                   action.numpy()]
    np.testing.assert_allclose(logp.detach().numpy(), jlogp, atol=FWD_ATOL)
    np.testing.assert_allclose(value.detach().numpy(), np.asarray(jvalue),
                               atol=FWD_ATOL)
    again = tm.action_dist(torch.from_numpy(obs),
                           torch.Generator().manual_seed(0))[0]
    assert torch.equal(action, again)


# --- learners ---------------------------------------------------------------

def _ppo_batch(n=256, seed=0):
    rng = np.random.default_rng(seed)
    return {SB.OBS: rng.normal(size=(n, OBS)).astype(np.float32),
            SB.ACTIONS: rng.integers(0, ACTIONS, n).astype(np.int32),
            SB.LOGP: (np.log(0.5) + 0.3 * rng.normal(size=n))
            .astype(np.float32),
            SB.ADVANTAGES: rng.normal(size=n).astype(np.float32),
            SB.VALUE_TARGETS: rng.normal(size=n).astype(np.float32)}


def _vtrace_batch(b=2, t=64, seed=0):
    rng = np.random.default_rng(seed)
    dones = rng.random((b, t)) < 0.05
    dones[0, t // 6] = dones[-1, 2 * t // 3] = True
    return {SB.OBS: rng.normal(size=(b, t, OBS)).astype(np.float32),
            SB.ACTIONS: rng.integers(0, ACTIONS, (b, t)).astype(np.int32),
            SB.REWARDS: rng.normal(size=(b, t)).astype(np.float32),
            SB.DONES: dones,
            SB.LOGP: (np.log(0.5) + 0.3 * rng.normal(size=(b, t)))
            .astype(np.float32),
            "bootstrap_obs": rng.normal(size=(b, OBS)).astype(np.float32)}


def _learners(loss="ppo", jax_loss_fn=None, port_loss_fn=None, **kw):
    jm, w = _jax_weights()
    jl = jlearner.Learner(jm, loss=loss, loss_fn=jax_loss_fn, **kw)
    jl.set_weights(w)
    tl = rl.Learner(rl.DiscretePolicyModule(OBS, ACTIONS), loss=loss,
                    loss_fn=port_loss_fn, device="cpu", **kw)
    tl.set_weights(w)
    return jl, tl


def _value_loss_jax(params, batch):
    logits, values = jmodule.DiscretePolicyModule(OBS, ACTIONS).forward(
        params, batch[SB.OBS])
    loss = ((values - batch[SB.VALUE_TARGETS]) ** 2).mean() \
        + 0.01 * (logits ** 2).mean()
    return loss, {"loss": loss, "value_mean": values.mean()}


def _value_loss_port(module, batch):
    logits, values = module(batch[SB.OBS])
    loss = ((values - batch[SB.VALUE_TARGETS]) ** 2).mean() \
        + 0.01 * (logits ** 2).mean()
    return loss, {"loss": loss, "value_mean": values.mean()}


UPDATES = {
    "ppo": (dict(loss="ppo", lr=1e-3, entropy_coeff=0.01), _ppo_batch),
    "vtrace": (dict(loss="vtrace", lr=1e-3, entropy_coeff=0.01, gamma=0.9,
                    rho_clip=1.0, c_clip=0.9), _vtrace_batch),
    # grad_clip below the gradient's norm: optax's clip decides the step
    "ppo_clipped": (dict(loss="ppo", lr=1e-3, grad_clip=1e-3), _ppo_batch),
    "loss_fn": (dict(jax_loss_fn=_value_loss_jax,
                     port_loss_fn=_value_loss_port, lr=1e-3, grad_clip=0.1),
                _ppo_batch),
}


@pytest.mark.parametrize("case", list(UPDATES))
def test_learner_update_matches_jax(case):
    kw, make_batch = UPDATES[case]
    jl, tl = _learners(**kw)
    for step in range(2):
        batch = make_batch(seed=step)
        _assert_stats_close(tl.update(batch), jl.update(batch))
        _assert_params_close(tl.get_weights(), jl.get_weights())


def test_vtrace_targets_match_jax(monkeypatch):
    """vs and the policy-gradient advantages against the two values JAX's
    loss puts under stop_gradient, on fragments with dones inside."""
    jl, tl = _learners(loss="vtrace", gamma=0.95, c_clip=0.8)
    batch = _vtrace_batch(b=3, t=32, seed=7)
    seen = []
    real = jax.lax.stop_gradient

    def record(x):
        seen.append(np.asarray(x))
        return real(x)

    monkeypatch.setattr(jax.lax, "stop_gradient", record)
    jl._vtrace_loss(jl.params, {k: jnp.asarray(v)
                                for k, v in batch.items()})
    monkeypatch.undo()
    want_adv, want_vs = seen
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        logits, values = tl.module(tb[SB.OBS].reshape(-1, OBS))
        tlogp = torch.log_softmax(logits, -1).gather(
            -1, tb[SB.ACTIONS].long().reshape(-1, 1)).reshape(3, 32)
        rho = torch.exp(tlogp - tb[SB.LOGP])
        _, boot = tl.module(tb["bootstrap_obs"])
        vs, adv = tl.vtrace_targets(values.reshape(3, 32), boot, rho, tb)
    np.testing.assert_allclose(vs.numpy(), want_vs, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(adv.numpy(), want_adv, rtol=1e-5, atol=1e-6)


def _dqn_batch(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return {SB.OBS: rng.normal(size=(n, OBS)).astype(np.float32),
            SB.ACTIONS: rng.integers(0, ACTIONS, n).astype(np.int32),
            SB.REWARDS: rng.normal(size=n).astype(np.float32),
            jdqn.NEXT_OBS: rng.normal(size=(n, OBS)).astype(np.float32),
            SB.DONES: rng.random(n) < 0.1}


def test_dqn_updates_and_target_sync_match_jax():
    """5 double-DQN updates at target_update_freq=2 (two syncs): the stats
    of each, the online params after each, and the target params equal to
    JAX's after each sync (and unchanged between syncs)."""
    assert rl.NEXT_OBS == jdqn.NEXT_OBS
    jm, w = _jax_weights("q")
    jl = jdqn.DQNLearner(jm, lr=1e-2, gamma=0.9, target_update_freq=2,
                         huber_delta=0.5)
    jl.params = _jnp(w)
    jl.target_params = _jnp(w)
    jl.opt_state = jl.opt.init(jl.params)
    tl = rl.DQNLearner(rl.QNetworkModule(OBS, ACTIONS), lr=1e-2, gamma=0.9,
                       target_update_freq=2, huber_delta=0.5, device="cpu")
    for m in (tl.module, tl.target_module):
        m.load_state_dict(rl.params_from_jax(w))
    target = rl.params_to_jax(tl.target_module.state_dict())
    for step in range(5):
        batch = _dqn_batch(seed=step)
        _assert_stats_close(tl.update(batch), jl.update(batch))
        _assert_params_close(tl.get_weights(), jl.get_weights())
        now = rl.params_to_jax(tl.target_module.state_dict())
        if (step + 1) % 2 == 0:
            _assert_params_close(
                now, jax.tree_util.tree_map(np.asarray, jl.target_params))
            for a, b in zip(jax.tree_util.tree_leaves(now),
                            jax.tree_util.tree_leaves(tl.get_weights())):
                np.testing.assert_array_equal(a, b)
            target = now
        else:
            for a, b in zip(jax.tree_util.tree_leaves(now),
                            jax.tree_util.tree_leaves(target)):
                np.testing.assert_array_equal(a, b)
    assert not any(p.requires_grad for p in tl.target_module.parameters())


# --- env runners -------------------------------------------------------------

def test_epsilon_greedy_batches_equal_jax_runner():
    """The JAX runner's body (the class under its ActorClass) and the
    port's runner on the same weights and seed: the same batches, since
    the greedy actions come from the same Q values and the epsilon draws
    from the same numpy generator."""
    _, w = _jax_weights("q")
    cfg = {"observation_size": OBS, "action_size": ACTIONS,
           "hidden": (64, 64)}
    jr = jvec.EnvRunner._cls(jenv.CartPoleEnv, cfg, num_envs=3,
                             module_kind="q", seed=11)
    tr = rl.EnvRunner(rl.CartPoleEnv, cfg, num_envs=3, module_kind="q",
                      seed=11, device="cpu")
    for epsilon in (0.3, 0.0, 1.0):
        (jb, js), (tb, ts) = (r.sample_epsilon_greedy(w, 40, epsilon)
                              for r in (jr, tr))
        assert set(jb) == set(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype, k
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        assert js == ts


def test_env_runner_sample_matches_jax_module():
    """The port's sample (actions from its own generator): logp and value
    against the JAX module at the port's obs and actions, the truncation
    bootstrap folded into the reward with JAX's value of the final obs,
    and the GAE columns against JAX's compute_gae."""
    jm, w = _jax_weights()
    cfg = {"observation_size": OBS, "action_size": ACTIONS,
           "hidden": (64, 64)}
    env = functools.partial(rl.RandomEnv, episode_len=10)
    n, t, gamma = 2, 25, 0.9
    runner = rl.EnvRunner(env, cfg, num_envs=n, gamma=gamma, lam=0.8,
                          seed=3, device="cpu")
    batch, stats = runner.sample(w, t)
    assert batch[SB.ACTIONS].dtype == np.int32
    assert stats["episodes_total"] == n * (t // 10)
    logits, value = jm.forward(_jnp(w), jnp.asarray(batch[SB.OBS]))
    rows = np.arange(n * t)
    jlogp = np.asarray(jax.nn.log_softmax(logits))[rows, batch[SB.ACTIONS]]
    np.testing.assert_allclose(batch[SB.LOGP], jlogp, atol=FWD_ATOL)
    np.testing.assert_allclose(batch[SB.VF_PREDS], np.asarray(value),
                               atol=FWD_ATOL)
    # replay the envs with the port's actions: truncated steps carry
    # gamma * V(final obs) on top of the env's reward
    venv = rl.VectorEnv(env, n, seed=3)
    venv.reset_all()
    acts = batch[SB.ACTIONS].reshape(n, t)
    rewards = batch[SB.REWARDS].reshape(n, t)
    for step in range(t):
        _, r, term, trunc, final = venv.step(acts[:, step])
        _, boot = jm.forward(_jnp(w), jnp.asarray(final))
        want = r + np.where(trunc & ~term, gamma * np.asarray(boot), 0.0)
        np.testing.assert_allclose(rewards[:, step], want, atol=FWD_ATOL)
    assert (batch[SB.DONES].reshape(n, t)[:, 9::10]).all()
    # GAE per env, bootstrapped from the port's value of the last obs
    with torch.no_grad():
        _, last = runner.module(torch.from_numpy(stats["bootstrap_obs"]))
    for i in range(n):
        frag = {k: batch[k][i * t:(i + 1) * t]
                for k in (SB.REWARDS, SB.VF_PREDS, SB.DONES)}
        want = jsb.compute_gae(
            jsb.SampleBatch(frag), gamma=gamma, lam=0.8,
            last_value=0.0 if frag[SB.DONES][-1] else float(last[i]))
        for k in (SB.ADVANTAGES, SB.VALUE_TARGETS):
            np.testing.assert_array_equal(batch[k][i * t:(i + 1) * t],
                                          want[k])
    frags, fstats = runner.sample(w, 7, compute_advantages=False)
    assert frags[SB.OBS].shape == (n, 7, OBS)
    assert frags[SB.ACTIONS].shape == frags[SB.DONES].shape == (n, 7)
    assert fstats["bootstrap_obs"].shape == (n, OBS)


def test_ppo_loop_learns_cartpole():
    """JAX's learning test (tests/test_rl.py:84-106) with the learner and
    runners in this process on the CPU, the loop of ray_tpu/rl/ppo.py's
    train: best episode_reward_mean >= 80 within 40 iterations."""
    cfg = {"observation_size": OBS, "action_size": ACTIONS,
           "hidden": (64, 64)}
    learner = rl.Learner(rl.DiscretePolicyModule(**cfg), lr=1e-3,
                         entropy_coeff=0.01, device="cpu")
    runners = [rl.EnvRunner(rl.CartPoleEnv, cfg, seed=i * 1000,
                            device="cpu") for i in range(2)]
    best = -np.inf
    for iteration in range(40):
        weights = learner.get_weights()
        results = [r.sample(weights, 512) for r in runners]
        batch = rl.concat_batches([rl.SampleBatch(b) for b, _ in results])
        for _ in range(10):
            for mb in batch.shuffle(seed=iteration).minibatches(256):
                stats = learner.update(mb)
        rewards = [s["episode_reward_mean"] for _, s in results
                   if not np.isnan(s["episode_reward_mean"])]
        if rewards:
            best = max(best, float(np.mean(rewards)))
        if best >= 80:
            break
    assert np.isfinite(stats["total_loss"])
    assert best >= 80, f"PPO failed to learn: best={best}"

"""Tune tests aimed at ray_tpu_torch.tune (copies of tests/test_tune.py;
reference model: ``python/ray/tune/tests/`` — variant generation, trial
execution, ASHA early stop, PBT exploit, resume)."""

import math
import os

import pytest

import ray_tpu_torch
from ray_tpu_torch import tune
from ray_tpu_torch.train import Checkpoint, RunConfig
from ray_tpu_torch.tune import (ASHAScheduler, PopulationBasedTraining,
                                TuneConfig, Tuner)
from ray_tpu_torch.tune.search import BasicVariantGenerator


@pytest.fixture
def rtpu_init():
    """The port's runtime per test, as conftest's is ray_tpu's."""
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()
    # conftest reports only ray_tpu's sanitizers: hold the port's here
    from ray_tpu_torch._private import fieldsan, locksan
    assert locksan.violations() == []
    assert fieldsan.violations() == []


def test_variant_generator_grid_and_random():
    space = {
        "lr": tune.grid_search([0.1, 0.01]),
        "wd": tune.grid_search([0.0, 0.1]),
        "seed": tune.randint(0, 1000),
        "nested": {"dropout": tune.uniform(0.0, 0.5)},
        "static": 7,
    }
    variants = list(BasicVariantGenerator(space, num_samples=3).variants())
    assert len(variants) == 12          # 2 x 2 grid x 3 samples
    for v in variants:
        assert v["lr"] in (0.1, 0.01) and v["wd"] in (0.0, 0.1)
        assert 0 <= v["seed"] < 1000
        assert 0.0 <= v["nested"]["dropout"] <= 0.5
        assert v["static"] == 7


def test_tuner_minimizes(rtpu_init, tmp_path):
    def objective(config):
        score = (config["x"] - 3) ** 2
        tune.report({"score": score})

    tuner = Tuner(
        objective,
        param_space={"x": tune.grid_search([0, 1, 2, 3, 4])},
        tune_config=TuneConfig(metric="score", mode="min",
                               max_concurrent_trials=3),
        run_config=RunConfig(name="quad", storage_path=str(tmp_path)))
    grid = tuner.fit()
    assert len(grid) == 5
    best = grid.get_best_result()
    assert best.metrics["score"] == 0


def test_asha_early_stops_bad_trials(rtpu_init, tmp_path):
    def objective(config):
        import time
        for i in range(9):
            # paced so the controller can intervene between reports
            time.sleep(0.1)
            tune.report({"loss": config["level"] + 1.0 / (i + 1)})

    tuner = Tuner(
        objective,
        param_space={"level": tune.grid_search([0.0, 5.0, 10.0, 20.0])},
        tune_config=TuneConfig(
            # sequential: each trial is judged against fully-recorded
            # rungs, so the early-stop outcome is deterministic (async
            # ASHA with concurrent arrivals can legitimately keep a
            # worst-first arrival order — load-dependent flake)
            metric="loss", mode="min", max_concurrent_trials=1,
            scheduler=ASHAScheduler(metric="loss", mode="min", max_t=9,
                                    grace_period=2,
                                    reduction_factor=2)),
        run_config=RunConfig(name="asha", storage_path=str(tmp_path)))
    grid = tuner.fit()
    best = grid.get_best_result()
    assert best.metrics["loss"] < 2.0
    # at least one poor trial must have been cut before 9 iterations
    lengths = [len(r.metrics_history) for r in grid]
    assert min(lengths) < 9
    assert max(lengths) == 9


def test_pbt_exploits(rtpu_init, tmp_path):
    def objective(config):
        resume = tune.get_checkpoint()
        score = resume.to_dict()["score"] if resume else 0.0
        for _ in range(6):
            score += config["rate"]
            tune.report({"score": score},
                        checkpoint=Checkpoint.from_dict({"score": score}))

    tuner = Tuner(
        objective,
        param_space={"rate": tune.grid_search([0.1, 1.0])},
        tune_config=TuneConfig(
            metric="score", mode="max", max_concurrent_trials=2,
            scheduler=PopulationBasedTraining(
                metric="score", mode="max", perturbation_interval=2,
                hyperparam_mutations={"rate": [0.1, 1.0, 2.0]},
                quantile_fraction=0.5)),
        run_config=RunConfig(name="pbt", storage_path=str(tmp_path)))
    grid = tuner.fit()
    best = grid.get_best_result()
    assert best.metrics["score"] >= 6.0


def test_tuner_restore_reruns_unfinished(rtpu_init, tmp_path):
    marker = os.path.join(str(tmp_path), "fail_once")
    open(marker, "w").close()

    def objective(config):
        if config["x"] == 1 and os.path.exists(marker):
            raise RuntimeError("flaky")
        tune.report({"score": config["x"]})

    run = RunConfig(name="resume", storage_path=str(tmp_path))
    tuner = Tuner(objective,
                  param_space={"x": tune.grid_search([0, 1])},
                  tune_config=TuneConfig(metric="score", mode="max"),
                  run_config=run)
    grid = tuner.fit()
    assert len(grid.errors) == 1

    os.remove(marker)
    restored = Tuner.restore(os.path.join(str(tmp_path), "resume"),
                             objective)
    grid2 = restored.fit()
    assert not grid2.errors
    assert grid2.get_best_result().metrics["score"] == 1


def test_asha_judges_trials_that_skip_rung_values():
    """Trials whose time_attr jumps over a rung value must still face
    the halving decision at the first report past it (ADVICE r1 #5)."""
    from ray_tpu_torch.tune.schedulers import CONTINUE, STOP, ASHAScheduler

    s = ASHAScheduler(metric="loss", mode="min", max_t=30,
                      grace_period=1, reduction_factor=3.0)
    assert s.rungs == [1, 3, 9, 27]

    # seed rung 1 and 3 with good peers (even reports: t = 2, 4, ...)
    for trial in ("good_a", "good_b", "good_c"):
        assert s.on_result(trial, {"training_iteration": 2,
                                   "loss": 0.1}) == CONTINUE
        assert s.on_result(trial, {"training_iteration": 4,
                                   "loss": 0.1}) == CONTINUE

    # a bad trial reporting only even iterations never hits t == rung
    # exactly; it must still be stopped
    decisions = []
    for t in (2, 4, 6, 8, 10):
        d = s.on_result("bad", {"training_iteration": t, "loss": 9.9})
        decisions.append(d)
        if d == STOP:
            break
    assert STOP in decisions, f"bad trial never halved: {decisions}"

    # each rung judges a trial at most once: a good trial reporting
    # t=2 twice is only recorded once at rung 1
    before = len(s._recorded[1])
    s.on_result("good_a", {"training_iteration": 2, "loss": 0.1})
    assert len(s._recorded[1]) == before


def test_tpe_beats_random_on_seeded_objective():
    """Suggestion-based search finds a better optimum than random under
    the same budget (reference: tune/search/searcher.py suggest loop).
    Pure searcher-protocol test — no cluster."""
    import random as _random

    from ray_tpu_torch.tune import TPESearcher

    def objective(cfg):
        return (cfg["x"] - 0.7) ** 2 + (cfg["y"] + 0.3) ** 2

    space = {"x": tune.uniform(-2.0, 2.0), "y": tune.uniform(-2.0, 2.0)}
    budget = 40

    s = TPESearcher(seed=5, n_initial=8)
    s.set_search_properties("score", "min", space)
    tpe_best = float("inf")
    for i in range(budget):
        cfg = s.suggest(f"t{i}")
        score = objective(cfg)
        tpe_best = min(tpe_best, score)
        s.on_trial_complete(f"t{i}", {"score": score})

    rng = _random.Random(5)
    rand_best = min(
        objective({"x": rng.uniform(-2, 2), "y": rng.uniform(-2, 2)})
        for _ in range(budget))

    assert tpe_best < rand_best
    assert tpe_best < 0.05


def test_concurrency_limiter_caps_inflight():
    from ray_tpu_torch.tune import BasicVariantSearcher, ConcurrencyLimiter
    from ray_tpu_torch.tune.searcher import FINISHED

    inner = BasicVariantSearcher({"x": tune.uniform(0, 1)},
                                 num_samples=5, seed=0)
    lim = ConcurrencyLimiter(inner, max_concurrent=2)
    lim.set_search_properties("m", "min", {"x": tune.uniform(0, 1)})
    assert lim.suggest("a") is not None
    assert lim.suggest("b") is not None
    assert lim.suggest("c") is None          # at cap
    lim.on_trial_complete("a", {"m": 1.0})
    assert lim.suggest("c") is not None      # slot freed
    for tid in ("b", "c"):
        lim.on_trial_complete(tid, {"m": 1.0})
    assert lim.suggest("d") is not None
    assert lim.suggest("e") is not None
    lim.on_trial_complete("d", {"m": 1.0})
    assert lim.suggest("f") is FINISHED      # 5 samples exhausted


def test_tuner_with_search_alg(rtpu_init, tmp_path):
    from ray_tpu_torch.tune import ConcurrencyLimiter, TPESearcher

    def trainable(config):
        tune.report({"score": (config["x"] - 0.5) ** 2})

    searcher = ConcurrencyLimiter(TPESearcher(seed=0, n_initial=4),
                                  max_concurrent=2)
    tuner = Tuner(
        trainable,
        param_space={"x": tune.uniform(0.0, 1.0)},
        tune_config=TuneConfig(metric="score", mode="min",
                               num_samples=8, max_concurrent_trials=2,
                               search_alg=searcher),
        run_config=RunConfig(name="tpe_e2e", storage_path=str(tmp_path)))
    grid = tuner.fit()
    assert len(grid) == 8
    best = grid.get_best_result()
    assert best.metrics["score"] < 0.1
    assert os.path.exists(os.path.join(str(tmp_path), "tpe_e2e",
                                       "searcher_state.pkl"))


def test_optuna_searcher_gated():
    from ray_tpu_torch.tune import OptunaSearcher
    try:
        import optuna  # noqa: F401
        pytest.skip("optuna present; gate not exercised")
    except ImportError:
        pass
    with pytest.raises(ImportError, match="optuna"):
        OptunaSearcher()


# --- parity: the same seeds give ray_tpu.tune's decisions exactly ----------

def _space(tune_mod):
    return {"lr": tune_mod.loguniform(1e-4, 1e-1),
            "wd": tune_mod.uniform(0.0, 0.3),
            "layers": tune_mod.randint(1, 9),
            "width": tune_mod.qrandint(32, 256, 32),
            "drop": tune_mod.quniform(0.0, 0.5, 0.1),
            "act": tune_mod.choice(["relu", "gelu", "silu"]),
            "opt": tune_mod.grid_search(["adam", "sgd"]),
            "nested": {"beta": tune_mod.uniform(0.8, 0.99)},
            "static": 7}


def test_variant_generator_equals_jax():
    from ray_tpu import tune as jtune
    from ray_tpu.tune.search import BasicVariantGenerator as JaxGenerator

    for seed in (0, 3):
        got = list(BasicVariantGenerator(_space(tune), num_samples=4,
                                         seed=seed).variants())
        want = list(JaxGenerator(_space(jtune), num_samples=4,
                                 seed=seed).variants())
        assert len(got) == 8 and got == want


def _searcher_run(tune_mod, searcher):
    """40 suggestions of `searcher` on a seeded objective, each completed
    before the next: the configs in order."""
    searcher.set_search_properties("score", "min", {
        "x": tune_mod.uniform(-2.0, 2.0), "y": tune_mod.loguniform(0.01, 10),
        "k": tune_mod.choice([1, 2, 3])})
    configs = []
    for i in range(40):
        cfg = searcher.suggest(f"t{i}")
        configs.append(cfg)
        score = (cfg["x"] - 0.7) ** 2 + abs(math.log(cfg["y"])) + cfg["k"]
        searcher.on_trial_complete(f"t{i}", {"score": score})
    return configs


def test_tpe_and_basic_searchers_equal_jax():
    from ray_tpu import tune as jtune

    for seed in (0, 5):
        got = _searcher_run(tune, tune.TPESearcher(seed=seed, n_initial=8))
        want = _searcher_run(jtune, jtune.TPESearcher(seed=seed,
                                                      n_initial=8))
        assert got == want
    got = _searcher_run(tune, tune.BasicVariantSearcher(
        {"x": tune.uniform(-2.0, 2.0), "y": tune.loguniform(0.01, 10),
         "k": tune.choice([1, 2, 3])}, num_samples=40, seed=2))
    want = _searcher_run(jtune, jtune.BasicVariantSearcher(
        {"x": jtune.uniform(-2.0, 2.0), "y": jtune.loguniform(0.01, 10),
         "k": jtune.choice([1, 2, 3])}, num_samples=40, seed=2))
    assert got == want


def _scripted_results(n_trials, n_iters, seed):
    """A seeded interleaving of `n_trials` trials' results: (trial,
    iteration, value) in report order."""
    import numpy as np
    rng = np.random.default_rng(seed)
    levels = rng.uniform(0, 10, n_trials)
    next_iter = [1] * n_trials
    out = []
    while any(t <= n_iters for t in next_iter):
        live = [i for i in range(n_trials) if next_iter[i] <= n_iters]
        i = int(rng.choice(live))
        t = next_iter[i]
        out.append((f"trial{i}", t, float(levels[i] + 3.0 / t
                                          + rng.normal(0, 0.5))))
        next_iter[i] += 1
    return out


def _asha_decisions(sched_mod, seed):
    s = sched_mod.ASHAScheduler(metric="loss", mode="min", max_t=9,
                                grace_period=1, reduction_factor=2)
    stopped, out = set(), []
    for trial, t, value in _scripted_results(8, 9, seed):
        if trial in stopped:
            continue
        d = s.on_result(trial, {"training_iteration": t, "loss": value})
        out.append((trial, t, d))
        if d == sched_mod.STOP:
            stopped.add(trial)
            s.on_trial_complete(trial)
    return out


def test_asha_stops_equal_jax():
    from ray_tpu.tune import schedulers as jsched
    from ray_tpu_torch.tune import schedulers as sched

    for seed in range(3):
        got, want = _asha_decisions(sched, seed), _asha_decisions(jsched,
                                                                  seed)
        assert got == want
        assert any(d == sched.STOP for _, t, d in got if t < 9)


def _pbt_decisions(sched_mod, tune_mod, seed):
    """PBT on scripted scores: each EXPLOIT's clone target and explored
    config, and every decision, in order."""
    s = sched_mod.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=2,
        hyperparam_mutations={"rate": [0.1, 1.0, 2.0],
                              "wd": tune_mod.uniform(0.0, 0.1),
                              "width": 64},
        quantile_fraction=0.25, seed=seed)
    configs = {f"trial{i}": {"rate": 0.5 * (i + 1), "wd": 0.01,
                             "momentum": 0.9, "width": 64}
               for i in range(6)}
    out = []
    for trial, t, value in _scripted_results(6, 8, seed):
        d = s.on_result(trial, {"training_iteration": t, "score": -value})
        out.append((trial, t, d))
        if d == sched_mod.EXPLOIT:
            target = s.exploit_target(trial)
            configs[trial] = s.explore(dict(configs[target]))
            out.append((trial, target, dict(configs[trial])))
    return out


def test_pbt_exploits_equal_jax():
    from ray_tpu import tune as jtune
    from ray_tpu.tune import schedulers as jsched
    from ray_tpu_torch.tune import schedulers as sched

    for seed in range(3):
        got = _pbt_decisions(sched, tune, seed)
        want = _pbt_decisions(jsched, jtune, seed)
        assert got == want
        assert any(d == sched.EXPLOIT for _, _, d in got)


def _paced_objective(tune_mod):
    def objective(config):
        import time
        for i in range(9):
            time.sleep(0.02)
            tune_mod.report({"loss": config["level"] + 1.0 / (i + 1)})
    return objective


def _asha_tuner(runtime, tune_mod, train_mod, storage):
    runtime.init(num_cpus=4)
    try:
        grid = tune_mod.Tuner(
            _paced_objective(tune_mod),
            param_space={"level": tune_mod.grid_search(
                [3.0, 0.0, 5.0, 1.0, 20.0, 2.0])},
            tune_config=tune_mod.TuneConfig(
                metric="loss", mode="min", max_concurrent_trials=1,
                scheduler=tune_mod.ASHAScheduler(
                    metric="loss", mode="min", max_t=9, grace_period=2,
                    reduction_factor=2)),
            run_config=train_mod.RunConfig(name="asha_parity",
                                           storage_path=storage)).fit()
    finally:
        runtime.shutdown()
    return [[(h["training_iteration"], h["loss"])
             for h in r.metrics_history] for r in grid]


def test_tuner_asha_run_equals_jax(tmp_path):
    """One ASHA tuning run, trials in series, on each runtime in turn: the
    same trials keep going and stop at the same iterations, with the same
    reported values."""
    import ray_tpu
    from ray_tpu import train as jtrain
    from ray_tpu import tune as jtune
    from ray_tpu_torch import train

    got = _asha_tuner(ray_tpu_torch, tune, train, str(tmp_path / "port"))
    want = _asha_tuner(ray_tpu, jtune, jtrain, str(tmp_path / "jax"))
    assert got == want
    lengths = [len(h) for h in got]
    assert min(lengths) < 9 and max(lengths) == 9

# A copy of tests/test_user_journey.py on ray_tpu_torch's runtime: the same
# tests under the same names, with the port's names (ray_tpu_torch, rtpt_*, GPU
# slots) and the fixtures of torch_runtime_fixtures.py, which also hold the
# port's locksan and fieldsan to no violation at teardown.
"""One end-to-end user journey across the library surface.

The shape a reference user expects to carry over unchanged: ETL with
Data, hyperparameter search with Tune (suggestion-based), model
serving with Serve (handle + gRPC ingress), all on one cluster
session. Each library has its own deep suite; this pins that they
compose.
"""

import numpy as np
import pytest

import ray_tpu_torch
from ray_tpu_torch import data as rd
from ray_tpu_torch import serve, tune
from ray_tpu_torch.train import RunConfig
from ray_tpu_torch.tune import (ConcurrencyLimiter, TPESearcher, TuneConfig,
                                Tuner)
from torch_runtime_fixtures import (port_sanitizers, rtpu_cluster,  # noqa: F401
                                    rtpu_init)


def test_data_tune_serve_journey(rtpu_init, tmp_path):
    # --- Data: ETL a labeled regression set, write + re-read it -------
    rng = np.random.default_rng(0)
    x = rng.normal(size=1000).astype(np.float64)
    raw = rd.from_numpy({"x": x, "y": 3.0 * x + 1.0}, num_blocks=8)
    clean = raw.add_column("x2", lambda b: b["x"] * b["x"])
    clean.write_csv(str(tmp_path / "etl"))
    ds = rd.read_csv(str(tmp_path / "etl"))
    assert ds.count() == 1000
    stats = ds.aggregate(rd.Mean("y"))
    assert abs(stats["mean(y)"] - 1.0) < 0.5

    # --- Tune: fit the slope with a TPE-suggested search --------------
    blocks = list(ds.iter_blocks())

    def trainable(config):
        w = config["w"]
        mse = float(np.mean([
            np.mean((blk["y"] - (w * blk["x"] + 1.0)) ** 2)
            for blk in blocks]))
        tune.report({"mse": mse})

    grid = Tuner(
        trainable,
        param_space={"w": tune.uniform(0.0, 6.0)},
        tune_config=TuneConfig(
            metric="mse", mode="min", num_samples=12,
            max_concurrent_trials=2,
            search_alg=ConcurrencyLimiter(TPESearcher(seed=3,
                                                     n_initial=4), 2)),
        run_config=RunConfig(name="journey",
                             storage_path=str(tmp_path))).fit()
    best_w = None
    best_mse = np.inf
    for r in grid:
        if r.metrics.get("mse", np.inf) < best_mse:
            best_mse = r.metrics["mse"]
            best_w = r.config["w"] if hasattr(r, "config") else None
    assert best_mse < 1.0          # found ~3.0 against noise-free data

    # --- Serve: deploy the fitted model, query via handle and gRPC ----
    fitted = {"w": 3.0 if best_w is None else best_w, "b": 1.0}

    @serve.deployment(num_replicas=1)
    def predictor(payload):
        xv = (payload or {}).get("x", 0.0)
        return {"y": fitted["w"] * xv + fitted["b"]}

    try:
        handle = serve.run(predictor.bind())
        out = handle.remote({"x": 2.0}).result()
        assert out["y"] == pytest.approx(fitted["w"] * 2.0 + 1.0)
        addr = serve.start_grpc()
        out = serve.grpc_call(addr, "predictor", {"x": -1.0})
        assert out["result"]["y"] == pytest.approx(
            -fitted["w"] + 1.0, rel=1e-6)
    finally:
        serve.shutdown()

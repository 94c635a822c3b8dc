"""Seconds from `TorchTrainer.fit()` in the benchmark's process to the first
step in the gang worker (the train loop's stamp): the gang's placement,
the worker's start, its rendezvous and the model's build."""


def read(run):
    return run["counters"].get("trainer_ready_s")

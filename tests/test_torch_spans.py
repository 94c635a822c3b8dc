"""The port's spans: the one span API (`ray_tpu_torch.util.tracing`) on the
profiler's clock, and the spans it opens at the train, runtime and model
step boundaries.

A span costs nothing where neither tracing nor torch's profiler is on (and
imports no torch); under `torch.profiler` it is a range of the profiler's
own, enclosing the operations run inside it, with tracing on or off. The
train step names its forward, backward and update, the model its build,
the trainer its gang, rendezvous, loop and reports, and the runtime's
client its submits, gets and puts, each a child of the span it runs in.
This file imports no JAX.
"""

import os
import subprocess
import sys
import time
import types

import pytest
import torch

import ray_tpu_torch
import torch_dist_worker
from ray_tpu_torch._private.config import CONFIG
from ray_tpu_torch.models import (GPT, init_train_state, make_optimizer,
                                  make_train_step)
from ray_tpu_torch.models.gpt import llama_tiny
from ray_tpu_torch.scripts import check_metrics
from ray_tpu_torch.state import api as state_api
from ray_tpu_torch.util import tracing
from test_torch_tracing_events import traced_init  # noqa: F401
from torch_runtime_fixtures import port_sanitizers  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_SPANS = ["model::forward", "model::backward", "model::update"]


@pytest.fixture
def tracing_on(request):
    """`tracing_enabled` as the test's parameter, restored after it."""
    old = CONFIG._values["tracing_enabled"]
    CONFIG._values["tracing_enabled"] = request.param
    tracing.drain()
    yield request.param
    CONFIG._values["tracing_enabled"] = old
    tracing.drain()


def _profile():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU])


def _events(prof, prefix):
    return sorted((e for e in prof.events() if e.name.startswith(prefix)),
                  key=lambda e: e.time_range.start)


# --- the span API ------------------------------------------------------------

def test_untraced_span_records_and_imports_nothing():
    """Tracing off, no profiler: a span yields None and buffers nothing,
    and a fresh interpreter that opens one never loads torch."""
    assert not CONFIG.tracing_enabled
    tracing.drain()
    with tracing.start_span("model::" + "probe") as span:
        assert span is None
    assert tracing.drain() == []
    code = ("import sys\n"
            "from ray_tpu_torch.util import tracing\n"
            "with tracing.start_span('model::' + 'probe') as span:\n"
            "    assert span is None\n"
            "assert tracing.drain() == []\n"
            "assert 'torch' not in sys.modules, 'torch was imported'\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("RTPU_TRACING_ENABLED", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_profiler_check_survives_a_partial_torch(monkeypatch):
    """A torch module still being imported (no `autograd` yet) reads as no
    profiler, never as an error on the caller's path."""
    monkeypatch.setitem(sys.modules, "torch", types.ModuleType("torch"))
    assert tracing._profiling() is False
    with tracing.start_span("runtime::" + "probe") as span:
        assert span is None


@pytest.mark.parametrize("tracing_on", [False, True], indirect=True,
                         ids=["tracing_off", "tracing_on"])
def test_span_is_a_profiler_range_enclosing_its_ops(tracing_on):
    a = torch.randn(64, 64)
    with _profile() as prof:
        with tracing.start_span("model::" + "probe") as span:
            torch.mm(a, a)
        torch.mm(a, a)
    (rng,) = _events(prof, "model::probe")
    inside = [e for e in prof.events() if e.name == "aten::mm"
              and e.thread == rng.thread
              and rng.time_range.start <= e.time_range.start
              and e.time_range.end <= rng.time_range.end]
    assert len(inside) == 1
    buffered = [s["name"] for s in tracing.drain()]
    if tracing_on:
        assert span is not None and span["name"] == "model::probe"
        assert buffered == ["model::probe"]
    else:
        assert span is None and buffered == []


def test_stackless_span_is_a_profiler_range():
    """`begin_span`/`end_span` open and close the profiler's range too, and
    the span that reaches the buffer holds no profiler object."""
    tracing.drain()
    with _profile() as prof:
        span = tracing.begin_span("request::" + "probe", None)
        torch.ones(8).sum()
        tracing.end_span(span)
    assert len(_events(prof, "request::probe")) == 1
    (buffered,) = tracing.drain()
    assert set(buffered) == set(tracing._new_span("x", None, None))


def test_span_error_status_and_profiler_range_close():
    old = CONFIG._values["tracing_enabled"]
    CONFIG._values["tracing_enabled"] = True
    tracing.drain()
    try:
        with _profile() as prof:
            with pytest.raises(ValueError):
                with tracing.start_span("model::" + "boom"):
                    raise ValueError("boom")
        (span,) = tracing.drain()
        assert span["status"] == "ERROR:ValueError"
        assert tracing.current_span() is None
        (rng,) = _events(prof, "model::boom")
        assert rng.time_range.end >= rng.time_range.start
    finally:
        CONFIG._values["tracing_enabled"] = old
        tracing.drain()


# --- the model step ----------------------------------------------------------

def _tiny_step(profiled: bool):
    """A tiny llama's two train steps on the CPU, built (and run) under
    the profiler when `profiled`: (profiler, params, metrics)."""
    import contextlib

    torch_dist_worker.settle()
    cfg = llama_tiny(dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(1))
    with (_profile() if profiled else contextlib.nullcontext()) as prof:
        model = GPT(cfg, device="cpu", seed=0)
        optim = make_optimizer(learning_rate=1e-3, warmup_steps=1,
                               total_steps=10)
        state = init_train_state(model, optim, device="cpu")
        step = make_train_step(model, optim, device="cpu")
        metrics = []
        for _ in range(2):
            state, m = step(state, {"tokens": tokens})
            metrics.append({k: v.clone() for k, v in m.items()})
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return prof, params, metrics


def test_train_step_spans_in_order_and_bit_equal():
    prof, params, metrics = _tiny_step(profiled=True)
    spans = _events(prof, "model::")
    assert [e.name for e in spans] == (["model::init"] + STEP_SPANS * 2)
    assert len({e.thread for e in spans}) == 1
    for a, b in zip(spans, spans[1:]):
        assert a.time_range.end <= b.time_range.start
    # the step's products run inside its forward and backward ranges
    fwd, bwd = spans[1], spans[2]
    mms = [e for e in prof.events() if e.name in ("aten::mm", "aten::bmm")
           and fwd.time_range.start <= e.time_range.start
           and e.time_range.end <= bwd.time_range.end]
    assert mms
    _, params0, metrics0 = _tiny_step(profiled=False)
    assert params.keys() == params0.keys()
    for name in params:
        assert torch.equal(params[name], params0[name]), name
    for m, m0 in zip(metrics, metrics0):
        for k in m:
            assert torch.equal(m[k], m0[k]), k


@pytest.mark.parametrize("tracing_on", [True], indirect=True,
                         ids=["tracing_on"])
@pytest.mark.parametrize("vocab, pad", [(500, 12), (512, 0)])
def test_init_span_carries_head_pad_rows(tracing_on, vocab, pad):
    """The model's build span holds the rows its head pads, the model's
    own count."""
    import dataclasses

    model = GPT(dataclasses.replace(llama_tiny(), vocab_size=vocab),
                device="cpu")
    (span,) = [s for s in tracing.drain() if s["name"] == "model::init"]
    assert span["attributes"]["head_pad_rows"] == model.head_pad_rows == pad


# --- the trainer and the runtime ---------------------------------------------

def _loop(config):
    from ray_tpu_torch import train
    for i in range(config["reports"]):
        train.report({"i": i})


def _spans_until(done, timeout=30.0):
    """Poll the control plane's spans until `done(spans)` holds (workers
    ship theirs when their task ends)."""
    spans = []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        spans = state_api.list_spans()
        if done(spans):
            break
        time.sleep(0.2)
    return spans


def test_trainer_spans_with_parent_links(traced_init, tmp_path):  # noqa: F811
    from ray_tpu_torch.train import RunConfig, ScalingConfig, TorchTrainer

    reports = 2
    result = TorchTrainer(
        _loop, train_loop_config={"reports": reports},
        scaling_config=ScalingConfig(num_workers=1, use_gpu=False),
        run_config=RunConfig(name="spans", storage_path=str(tmp_path))
    ).fit()
    assert result.error is None

    def by_name(spans, name):
        return [s for s in spans if s["name"] == name]

    spans = _spans_until(lambda s: len(by_name(s, "train::report")) == reports
                         and by_name(s, "train::fit"))
    (fit,) = by_name(spans, "train::fit")
    (gang,) = by_name(spans, "train::gang")
    (rendezvous,) = by_name(spans, "train::rendezvous")
    (loop,) = by_name(spans, "train::loop")
    report = by_name(spans, "train::report")
    assert len(report) == reports
    (run,) = [s for s in spans if s["name"].startswith("actor_call::")
              and s["name"].endswith("run")]
    assert fit["parent_id"] is None
    assert gang["parent_id"] == fit["span_id"]
    assert run["parent_id"] == fit["span_id"]
    assert rendezvous["parent_id"] == run["span_id"]
    assert loop["parent_id"] == run["span_id"]
    assert rendezvous["end_time"] <= loop["start_time"]
    for r in report:
        assert r["parent_id"] == loop["span_id"]
        assert loop["start_time"] <= r["start_time"] <= r["end_time"] \
            <= loop["end_time"]
        under = {s["name"] for s in spans if s["parent_id"] == r["span_id"]}
        # the report's queue put: one actor call submitted, its answer got
        assert {"runtime::submit", "runtime::get"} <= under, under
    # the gang's start: the workers' node ids, asked and got under it
    under_gang = {s["name"] for s in spans
                  if s["parent_id"] == gang["span_id"]}
    assert {"runtime::submit", "runtime::get"} <= under_gang, under_gang
    assert {s["trace_id"] for s in [fit, gang, run, rendezvous, loop,
                                    *report]} == {fit["trace_id"]}


def test_runtime_put_span_and_task_parent(traced_init):  # noqa: F811
    """A put opens `runtime::put`; a task's own span stays the child of
    the caller's span, beside the submit's."""
    @ray_tpu_torch.remote
    def one():
        return 1

    with tracing.start_span("driver-op") as root:
        ray_tpu_torch.put(b"x")
        assert ray_tpu_torch.get(one.remote(), timeout=60) == 1
    spans = _spans_until(lambda s: any(x["name"].startswith("task::")
                                       for x in s))
    under = {s["name"] for s in spans if s["parent_id"] == root["span_id"]}
    assert {"runtime::put", "runtime::submit", "runtime::get"} <= under
    assert any(n.startswith("task::") and n.endswith("one") for n in under)


# --- the registry ------------------------------------------------------------

def test_port_only_span_prefixes_are_read_from_the_port_line(tmp_path):
    pkg = tmp_path / "ray_tpu_torch"
    pkg.mkdir()
    (pkg / "m.py").write_text(
        'define("counter", "rtpu_ok_total", "x")\n'
        'self.events.info("KNOWN", "ok")\n'
        'tracing.start_span("train::" + "fit")\n')
    registry = ("`rtpu_ok_total`\n\n### Cluster event & span registry\n\n"
                "`KNOWN`\n\n## PyTorch/CUDA port (`ray_tpu_torch`)\n\n")
    (tmp_path / "README.md").write_text(registry)
    assert any("'train::'" in p and "not documented" in p
               for p in check_metrics.check(str(tmp_path)))
    (tmp_path / "README.md").write_text(
        registry + check_metrics._PORT_SPANS_PREFIX
        + " `train::<stage>`, `model::<phase>`.\n")
    problems = check_metrics.check(str(tmp_path))
    assert not any("'train::'" in p for p in problems), problems
    assert any("'model::'" in p and "no start_span" in p for p in problems)
    assert check_metrics.port_span_prefixes(
        os.path.join(REPO, "README.md")) == {"train::", "runtime::",
                                             "model::"}

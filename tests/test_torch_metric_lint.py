"""Tier-1 wiring of the port's metric-registry lint
(ray_tpu_torch/scripts/check_metrics.py; copies of
tests/test_metric_lint.py): every runtime metric the port defines must be
a valid Prometheus name and documented in the README.md Observability
registry."""

import os

from ray_tpu_torch.scripts import check_metrics


def test_runtime_metric_registry_is_clean():
    problems = check_metrics.check()
    assert problems == [], "\n".join(problems)


def test_scanner_sees_known_metrics():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    defined = check_metrics.collect_defined_metrics(
        os.path.join(root, "ray_tpu_torch"))
    # spot-check one metric per subsystem so a broken scanner can't
    # vacuously pass the registry check
    for name in ("rtpu_scheduler_tasks_submitted_total",
                 "rtpu_object_store_put_bytes_total",
                 "rtpu_collective_latency_seconds",
                 "rtpu_serve_request_latency_seconds",
                 "rtpu_data_blocks_total",
                 "rtpu_device_hbm_bytes_in_use"):
        assert name in defined, name


def test_grammar_rejects_bad_names(tmp_path):
    pkg = tmp_path / "ray_tpu_torch"
    pkg.mkdir()
    (pkg / "bad.py").write_text(
        'define("counter", "rtpu_Bad-Name", "x")\n')
    (tmp_path / "README.md").write_text("`rtpu_Bad-Name`\n")
    problems = check_metrics.check(str(tmp_path))
    assert any("grammar" in p for p in problems)


def test_undocumented_metric_fails(tmp_path):
    pkg = tmp_path / "ray_tpu_torch"
    pkg.mkdir()
    (pkg / "m.py").write_text(
        'define("counter", "rtpu_new_thing_total", "x")\n')
    (tmp_path / "README.md").write_text("# no registry here\n")
    problems = check_metrics.check(str(tmp_path))
    assert any("not documented" in p for p in problems)


def test_scanner_sees_known_event_labels_and_spans():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(root, "ray_tpu_torch")
    labels = check_metrics.collect_event_labels(pkg)
    for label in ("NODE_START", "OOM_KILL", "ACTOR_DEATH",
                  "TASK_STALL", "DEBUG_STACKS", "DEBUG_PROFILE"):
        assert label in labels, label
    spans = check_metrics.collect_span_prefixes(pkg)
    assert {"task::", "actor_create::", "actor_call::"} <= set(spans)


def test_undocumented_event_label_fails(tmp_path):
    pkg = tmp_path / "ray_tpu_torch"
    pkg.mkdir()
    (pkg / "m.py").write_text(
        'define("counter", "rtpu_ok_total", "x")\n'
        'self.events.warning("NEW_SURPRISE", "boom")\n')
    (tmp_path / "README.md").write_text(
        "`rtpu_ok_total`\n\n### Cluster event & span registry\n\n"
        "(nothing documented)\n")
    problems = check_metrics.check(str(tmp_path))
    assert any("NEW_SURPRISE" in p and "not documented" in p
               for p in problems)


def test_undocumented_span_prefix_fails(tmp_path):
    pkg = tmp_path / "ray_tpu_torch"
    pkg.mkdir()
    (pkg / "m.py").write_text(
        'define("counter", "rtpu_ok_total", "x")\n'
        'self.events.info("KNOWN", "ok")\n'
        'tracing.start_span("mystery::" + name)\n')
    (tmp_path / "README.md").write_text(
        "`rtpu_ok_total`\n\n### Cluster event & span registry\n\n"
        "`KNOWN`\n")
    problems = check_metrics.check(str(tmp_path))
    assert any("mystery::" in p for p in problems)

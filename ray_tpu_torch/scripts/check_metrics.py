"""Observability-registry lint: every runtime metric the code defines
must be a valid Prometheus name AND documented in README.md's
Observability registry; every cluster-event label and span-name prefix
must appear in the README's event & span registry — new instrumentation
(including the ``debug/*`` events) can't ship undocumented.

Wired in as a tier-1 test (``tests/test_metric_lint.py``); also runnable
standalone: ``python -m ray_tpu_torch.scripts.check_metrics``.

This is ``ray_tpu``'s lint aimed at ``ray_tpu_torch/``. The port shares
the README's registries with ``ray_tpu`` (the metric names and event
labels are the same); the names of ``ray_tpu``'s registry that the port
does not define are listed in the README's port section on the line
that starts with ``_PORT_ABSENT_PREFIX``, and only those may be absent.
The span-name prefixes only the port opens are on the port section's
line that starts with ``_PORT_SPANS_PREFIX`` (the shared registry may
hold only prefixes that ``ray_tpu`` opens).
"""

from __future__ import annotations

import ast
import os
import re
import sys
from typing import Dict, List, Set, Tuple

# Prometheus metric-name grammar (https://prometheus.io/docs/concepts/
# data_model/) narrowed to this repo's convention: rtpu_ prefix,
# lower-snake-case. `_bucket`/`_sum`/`_count`/`_total` suffixes are part
# of the name as defined.
_NAME_RE = re.compile(r"^rtpu_[a-z][a-z0-9_]*$")
_README_NAME_RE = re.compile(r"`(rtpu_[A-Za-z0-9_:]+)`")

# Cluster-event labels (UPPER_SNAKE) and span-name prefixes
# (``lower_snake::``), validated against the README's
# "Cluster event & span registry" section only — scanning the whole
# README would catch unrelated backticked identifiers.
_LABEL_RE = re.compile(r"^[A-Z][A-Z0-9_]*$")
_SPAN_PREFIX_RE = re.compile(r"^[a-z][a-z0-9_]*::$")
_README_LABEL_RE = re.compile(r"`([A-Z][A-Z0-9_]+)`")
_README_SPAN_RE = re.compile(r"`([a-z][a-z0-9_]*::)")
_REGISTRY_HEADING = "### Cluster event & span registry"
_PORT_HEADING = "## PyTorch/CUDA port"
_PORT_ABSENT_PREFIX = "Registry names the port does not define:"
_PORT_SPANS_PREFIX = "Span prefixes only the port opens:"

# the package under analysis
_PKG = "ray_tpu_torch"


def _repo_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def collect_defined_metrics(pkg_dir: str,
                            files=None) -> Dict[str, str]:
    """All metric names registered via ``telemetry.define(kind, name,
    ...)`` anywhere under the package, mapped to the defining file."""
    out: Dict[str, str] = {}
    for rel, tree in (files if files is not None
                      else _walk_files(pkg_dir)):
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else None)
            if name != "define" or len(node.args) < 2:
                continue
            arg = node.args[1]
            if (isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str)
                    and arg.value.startswith("rtpu_")):
                out[arg.value] = rel
    return out


def readme_metric_names(readme_path: str) -> Set[str]:
    try:
        with open(readme_path) as f:
            return set(_README_NAME_RE.findall(f.read()))
    except OSError:
        return set()


_REGISTRY_ROW_RE = re.compile(
    r"^\|\s*`(rtpu_[a-z0-9_]+)`\s*\|\s*(\w+)\s*\|", re.MULTILINE)
_REGISTRY_LABEL_ROW_RE = re.compile(
    r"^\|\s*`(rtpu_[a-z0-9_]+)`\s*\|\s*\w+\s*\|\s*([^|]*)\|", re.MULTILINE)
_LABEL_NAME_RE = re.compile(r"`([a-z][a-z0-9_]*)`")
_TAG_KEY_RE = re.compile(r"^[a-z][a-z0-9_]*$")


def readme_registry_rows(readme_path: str) -> List[Tuple[str, str]]:
    """Every (metric, declared type) registry-table row IN ORDER,
    duplicates included — two rows for one metric would silently shadow
    each other in the dict-shaped type/label views. Empty when the
    README has no such table (the name-presence check still applies)."""
    try:
        with open(readme_path) as f:
            text = f.read()
    except OSError:
        return []
    return _REGISTRY_ROW_RE.findall(text)


def readme_registry_types(readme_path: str) -> Dict[str, str]:
    """Metric name -> declared type (counter/gauge/histogram)."""
    return dict(readme_registry_rows(readme_path))


def collect_defined_metric_kinds(pkg_dir: str,
                                 files=None) -> Dict[str, Tuple[str, str]]:
    """Metric name -> (kind, file) for every ``telemetry.define(kind,
    name, ...)`` with literal kind and name."""
    out: Dict[str, Tuple[str, str]] = {}
    for rel, tree in (files if files is not None
                      else _walk_files(pkg_dir)):
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else None)
            if name != "define" or len(node.args) < 2:
                continue
            kind_arg, name_arg = node.args[0], node.args[1]
            if (isinstance(kind_arg, ast.Constant)
                    and isinstance(kind_arg.value, str)
                    and isinstance(name_arg, ast.Constant)
                    and isinstance(name_arg.value, str)
                    and name_arg.value.startswith("rtpu_")):
                out[name_arg.value] = (kind_arg.value, rel)
    return out


_ANY_LABEL_TOKEN_RE = re.compile(r"`([^`]+)`")


def readme_registry_labels(readme_path: str) -> Dict[str, Set[str]]:
    """Metric name -> documented label set from the registry table's
    labels column (``—`` rows map to the empty set)."""
    try:
        with open(readme_path) as f:
            text = f.read()
    except OSError:
        return {}
    return {name: set(_LABEL_NAME_RE.findall(cell))
            for name, cell in _REGISTRY_LABEL_ROW_RE.findall(text)}


def readme_registry_label_cells(readme_path: str) -> List[Tuple[str, str]]:
    """(metric name, RAW labels-column cell) per registry row — for the
    label-naming lint, which must see malformed tokens that the
    well-formed-only ``_LABEL_NAME_RE`` extraction would drop."""
    try:
        with open(readme_path) as f:
            text = f.read()
    except OSError:
        return []
    return _REGISTRY_LABEL_ROW_RE.findall(text)


def collect_used_tag_keys(pkg_dir: str,
                          files=None) -> Dict[str, Dict[str, str]]:
    """Metric name -> {tag key -> file} for every literal ``tags=(("k",
    v), ...)`` passed to ``counter_inc``/``gauge_set``/``hist_observe``/
    ``digest_observe``/``digest_series`` whose metric argument is a name
    bound by ``X = telemetry.define(kind, "rtpu_...", ...)``. Dynamic
    tag expressions are skipped — the lint only judges what it can read
    statically."""
    files = list(files if files is not None else _walk_files(pkg_dir))
    # pass 1: variable name -> metric name (module-scope define binds)
    var_to_metric: Dict[str, str] = {}
    for _rel, tree in files:
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Call)):
                continue
            fn = node.value.func
            fname = (fn.attr if isinstance(fn, ast.Attribute)
                     else fn.id if isinstance(fn, ast.Name) else None)
            if fname != "define" or len(node.value.args) < 2:
                continue
            arg = node.value.args[1]
            if (isinstance(arg, ast.Constant) and isinstance(arg.value, str)
                    and arg.value.startswith("rtpu_")):
                var_to_metric[node.targets[0].id] = arg.value
    # pass 2: record-site tag keys
    out: Dict[str, Dict[str, str]] = {}
    for rel, tree in files:
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fn = node.func
            fname = (fn.attr if isinstance(fn, ast.Attribute)
                     else fn.id if isinstance(fn, ast.Name) else None)
            if fname not in ("counter_inc", "gauge_set", "hist_observe",
                             "digest_observe", "digest_series"):
                continue
            metric_arg = node.args[0]
            var = (metric_arg.attr if isinstance(metric_arg, ast.Attribute)
                   else metric_arg.id if isinstance(metric_arg, ast.Name)
                   else None)
            metric = var_to_metric.get(var or "")
            if metric is None:
                continue
            # digest_series prebinds (metric, tags) — the hot-path
            # digest_record sites carry no tags of their own, so the
            # prebind is where those series' keys are declared
            tag_pos = 1 if fname == "digest_series" else 2
            tags_node = None
            if len(node.args) > tag_pos:
                tags_node = node.args[tag_pos]
            for kw in node.keywords:
                if kw.arg == "tags":
                    tags_node = kw.value
            if not isinstance(tags_node, (ast.Tuple, ast.List)):
                continue
            for pair in tags_node.elts:
                if not (isinstance(pair, (ast.Tuple, ast.List))
                        and pair.elts
                        and isinstance(pair.elts[0], ast.Constant)
                        and isinstance(pair.elts[0].value, str)):
                    continue
                out.setdefault(metric, {})[pair.elts[0].value] = rel
    return out


def _walk_files(pkg_dir: str):
    for dirpath, _dirs, files in os.walk(pkg_dir):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            try:
                with open(path) as f:
                    tree = ast.parse(f.read(), filename=path)
            except (SyntaxError, OSError):
                continue
            yield os.path.relpath(path, pkg_dir), tree


def collect_event_labels(pkg_dir: str, files=None) -> Dict[str, str]:
    """Labels of every structured cluster event emitted through an
    EventLogger (``<x>.events.info/warning/error("LABEL", ...)`` and
    ``<x>.events.emit(sev, "LABEL", ...)``), mapped to the file."""
    out: Dict[str, str] = {}
    for rel, tree in (files if files is not None
                      else _walk_files(pkg_dir)):
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not (isinstance(fn, ast.Attribute)
                    and isinstance(fn.value, ast.Attribute)
                    and fn.value.attr == "events"):
                continue
            if fn.attr in ("info", "warning", "error"):
                arg_idx = 0
            elif fn.attr == "emit":
                arg_idx = 1
            else:
                continue
            if len(node.args) <= arg_idx:
                continue
            arg = node.args[arg_idx]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                out[arg.value] = rel
    return out


def collect_span_prefixes(pkg_dir: str, files=None) -> Dict[str, str]:
    """Span-name prefixes (``xxx::``) appearing as string constants in
    the name argument of ``start_span``/``begin_span`` calls."""
    out: Dict[str, str] = {}
    for rel, tree in (files if files is not None
                      else _walk_files(pkg_dir)):
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fn = node.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else None)
            if name not in ("start_span", "begin_span"):
                continue
            for sub in ast.walk(node.args[0]):
                if (isinstance(sub, ast.Constant)
                        and isinstance(sub.value, str)
                        and _SPAN_PREFIX_RE.match(sub.value)):
                    out[sub.value] = rel
    return out


def readme_event_registry(readme_path: str) -> Tuple[Set[str], Set[str]]:
    """(labels, span prefixes) documented in the README's
    "Cluster event & span registry" section."""
    try:
        with open(readme_path) as f:
            text = f.read()
    except OSError:
        return set(), set()
    start = text.find(_REGISTRY_HEADING)
    if start < 0:
        return set(), set()
    body = text[start + len(_REGISTRY_HEADING):]
    # section ends at the next heading of any level
    end = re.search(r"\n#{2,3} ", body)
    if end:
        body = body[:end.start()]
    return (set(_README_LABEL_RE.findall(body)),
            set(_README_SPAN_RE.findall(body)))


def _port_line(readme_path: str, prefix: str) -> str:
    """The README port section's line that starts with `prefix` ("" when
    there is none)."""
    try:
        with open(readme_path) as f:
            text = f.read()
    except OSError:
        return ""
    start = text.find(_PORT_HEADING)
    if start < 0:
        return ""
    for line in text[start:].splitlines():
        if line.startswith(prefix):
            return line
    return ""


def port_absent_names(readme_path: str) -> Set[str]:
    """Metric names of the README's registry that the port does not
    define: the backticked names on the port section's line that starts
    with ``_PORT_ABSENT_PREFIX``."""
    return set(_README_NAME_RE.findall(
        _port_line(readme_path, _PORT_ABSENT_PREFIX)))


def port_span_prefixes(readme_path: str) -> Set[str]:
    """Span-name prefixes only the port opens: the backticked prefixes on
    the port section's line that starts with ``_PORT_SPANS_PREFIX``."""
    return set(_README_SPAN_RE.findall(
        _port_line(readme_path, _PORT_SPANS_PREFIX)))


def check(repo_root: str = None) -> List[str]:
    """Returns a list of problems (empty = clean)."""
    root = repo_root or _repo_root()
    # one walk+parse of the package, shared by all three collectors
    files = list(_walk_files(os.path.join(root, _PKG)))
    defined = collect_defined_metrics(os.path.join(root, _PKG),
                                      files)
    documented = readme_metric_names(os.path.join(root, "README.md"))
    problems: List[str] = []
    if not defined:
        problems.append("no telemetry.define() metric names found under "
                        "ray_tpu_torch/ — the scanner is broken")
    for name, where in sorted(defined.items()):
        if not _NAME_RE.match(name):
            problems.append(
                f"{name} ({where}): violates the Prometheus naming "
                "grammar / rtpu_ lower-snake-case convention")
        if name not in documented:
            problems.append(
                f"{name} ({where}): not documented in the README.md "
                "Observability metric registry")
    absent = port_absent_names(os.path.join(root, "README.md"))
    for name in sorted(absent & set(defined)):
        problems.append(
            f"{name}: listed as not defined by the port in the README's "
            "port section, but a telemetry.define() registers it")
    for name in sorted(documented - set(defined) - absent):
        problems.append(
            f"{name}: listed in the README registry but no "
            "telemetry.define() in ray_tpu_torch/ registers it")
    # type column of the registry table must match the define() kind
    # (a histogram documented as a counter misleads every dashboard),
    # and the kind itself must be one the telemetry core implements —
    # a typo'd kind would otherwise record nothing, silently
    kinds = collect_defined_metric_kinds(os.path.join(root, _PKG),
                                         files)
    rows = readme_registry_rows(os.path.join(root, "README.md"))
    row_types = dict(rows)
    valid_kinds = ("counter", "gauge", "histogram", "digest")
    for name, (kind, where) in sorted(kinds.items()):
        if kind not in valid_kinds:
            problems.append(
                f"{name} ({where}): defined with unknown kind "
                f"{kind!r} (valid: {', '.join(valid_kinds)})")
        doc_type = row_types.get(name)
        if doc_type is not None and doc_type != kind:
            problems.append(
                f"{name} ({where}): defined as {kind} but the README "
                f"registry row says {doc_type}")
    # duplicate registry rows: the dict-shaped views keep only the LAST
    # row per metric, so a duplicate would silently make the type/label
    # lints judge against the wrong declaration
    seen_rows: Set[str] = set()
    for name, _type in rows:
        if name in seen_rows:
            problems.append(
                f"{name}: appears in more than one README registry row")
        seen_rows.add(name)
    # labels column: every tag key a record site attaches (statically
    # readable literal tuples) must be declared for that metric — an
    # undeclared label is invisible cardinality no dashboard knows about
    doc_labels = readme_registry_labels(os.path.join(root, "README.md"))
    # naming lint over the RAW label cells: the doc_labels extraction
    # above only keeps well-formed tokens, so a malformed declared
    # label (`node-id`, `nodeID`) would silently vanish from it
    for name, cell in readme_registry_label_cells(
            os.path.join(root, "README.md")):
        for tok in _ANY_LABEL_TOKEN_RE.findall(cell):
            if not _TAG_KEY_RE.match(tok):
                problems.append(
                    f"{name}: README registry declares label {tok!r}, "
                    "which violates the lower_snake label naming "
                    "convention")
    used_tags = collect_used_tag_keys(os.path.join(root, _PKG),
                                      files)
    for name, keys in sorted(used_tags.items()):
        declared = doc_labels.get(name)
        for key, where in sorted(keys.items()):
            if not _TAG_KEY_RE.match(key):
                problems.append(
                    f"{name} ({where}): tag key {key!r} violates the "
                    "lower_snake label naming convention")
            if declared is not None and key not in declared:
                problems.append(
                    f"{name} ({where}): records tag {key!r} but the "
                    "README registry row does not declare that label")
    problems += check_events(root, files)
    problems += check_bundle_sections(root, files)
    return problems


def check_bundle_sections(root: str, files=None) -> List[str]:
    """Debug-bundle registry lint (both directions, like the config-knob
    registry): every name in ``debug_bundle.BUNDLE_SECTIONS`` (the
    manifest's section list) must have a ``_capture_<name>`` function
    AND a ``_CAPTURERS`` dispatch entry, and every capturer must be
    listed — a new observability surface can't silently miss the
    bundle, and a dead section can't linger in the manifest schema."""
    pkg = os.path.join(root, _PKG)
    if files is None:
        files = list(_walk_files(pkg))
    tree = None
    for rel, t in files:
        if rel.replace(os.sep, "/") == "_private/debug_bundle.py":
            tree = t
            break
    if tree is None:
        return ["_private/debug_bundle.py not found — the bundle "
                "section lint has nothing to check"]
    sections: List[str] = []
    capturers: Set[str] = set()
    dispatch: Set[str] = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            target = node.targets[0].id
            if target == "BUNDLE_SECTIONS" and isinstance(
                    node.value, (ast.Tuple, ast.List)):
                for elt in node.value.elts:
                    if (isinstance(elt, ast.Constant)
                            and isinstance(elt.value, str)):
                        sections.append(elt.value)
            elif target == "_CAPTURERS" and isinstance(node.value,
                                                       ast.Dict):
                for k in node.value.keys:
                    if (isinstance(k, ast.Constant)
                            and isinstance(k.value, str)):
                        dispatch.add(k.value)
        elif (isinstance(node, ast.FunctionDef)
                and node.name.startswith("_capture_")):
            capturers.add(node.name[len("_capture_"):])
    problems: List[str] = []
    if not sections:
        problems.append("debug_bundle.BUNDLE_SECTIONS is empty or not a "
                        "literal tuple — the bundle scanner is broken")
    dupes = {s for s in sections if sections.count(s) > 1}
    for s in sorted(dupes):
        problems.append(f"bundle section {s!r}: listed more than once "
                        "in BUNDLE_SECTIONS")
    listed = set(sections)
    for s in sorted(listed - capturers):
        problems.append(f"bundle section {s!r}: in BUNDLE_SECTIONS but "
                        "no _capture_ function captures it")
    for s in sorted(capturers - listed):
        problems.append(f"bundle capturer _capture_{s}: not listed in "
                        "BUNDLE_SECTIONS (the manifest would omit it)")
    for s in sorted(listed - dispatch):
        problems.append(f"bundle section {s!r}: missing from the "
                        "_CAPTURERS dispatch table")
    for s in sorted(dispatch - listed):
        problems.append(f"bundle dispatch entry {s!r}: not listed in "
                        "BUNDLE_SECTIONS")
    return problems


def check_events(root: str, files=None) -> List[str]:
    """Event-label + span-name half of the lint."""
    pkg = os.path.join(root, _PKG)
    if files is None:
        files = list(_walk_files(pkg))
    labels = collect_event_labels(pkg, files)
    spans = collect_span_prefixes(pkg, files)
    doc_labels, doc_spans = readme_event_registry(
        os.path.join(root, "README.md"))
    doc_spans |= port_span_prefixes(os.path.join(root, "README.md"))
    problems: List[str] = []
    if not labels:
        problems.append("no EventLogger emit sites found under ray_tpu_torch/ "
                        "— the event scanner is broken")
    for label, where in sorted(labels.items()):
        if not _LABEL_RE.match(label):
            problems.append(
                f"{label} ({where}): event labels must be UPPER_SNAKE")
        if label not in doc_labels:
            problems.append(
                f"{label} ({where}): not documented in the README.md "
                "cluster event & span registry")
    for label in sorted(doc_labels - set(labels)):
        problems.append(
            f"{label}: in the README event registry but never emitted "
            "under ray_tpu_torch/")
    for prefix, where in sorted(spans.items()):
        if prefix not in doc_spans:
            problems.append(
                f"span prefix {prefix!r} ({where}): not documented in "
                "the README.md cluster event & span registry")
    for prefix in sorted(doc_spans - set(spans)):
        problems.append(
            f"span prefix {prefix!r}: in the README registry but no "
            "start_span/begin_span under ray_tpu_torch/ uses it")
    return problems


def main() -> int:
    problems = check()
    for p in problems:
        print(f"metric-lint: {p}", file=sys.stderr)
    if problems:
        print(f"metric-lint: {len(problems)} problem(s)", file=sys.stderr)
        return 1
    print("metric-lint: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())

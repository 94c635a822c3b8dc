"""ResultGrid (reference: ``tune/result_grid.py``)."""

from __future__ import annotations

from typing import List, Optional

from ..train.result import Result


class ResultGrid:
    def __init__(self, results: List[Result], metric: str = "loss",
                 mode: str = "min"):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def errors(self):
        return [r.error for r in self._results if r.error is not None]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        scored = [r for r in self._results
                  if r.metrics and metric in r.metrics]
        if not scored:
            raise ValueError(f"no trial reported metric {metric!r}")
        return (max if mode == "max" else min)(
            scored, key=lambda r: r.metrics[metric])

    def get_dataframe(self):
        rows = []
        for r in self._results:
            row = dict(r.metrics)
            row["path"] = r.path
            rows.append(row)
        try:
            import pandas as pd
            return pd.DataFrame(rows)
        except ImportError:
            return rows

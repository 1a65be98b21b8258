"""Experiment records: JSONL logs and summary CSVs.

Port of ``avex_tpu/utils/tracking.py`` (reference
``avex/utils/experiment_tracking.py``): every (experiment × evaluation set)
result is appended to a JSONL log with a run id and a timestamp, the
training side keeps a metadata CSV per checkpoint with the config snapshot,
and flattened metric rows make the summary CSVs.
"""

from __future__ import annotations

import csv
import json
import time
import uuid
from pathlib import Path
from typing import Any, Dict, List, Sequence, Union

__all__ = [
    "SIMPLE_SUMMARY_METRICS",
    "append_jsonl",
    "create_experiment_summary_csvs",
    "get_config_from_metadata",
    "load_experiment_metadata",
    "read_jsonl",
    "save_experiment_metadata",
    "write_summary_csv",
]


def _jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if hasattr(obj, "item"):
        return obj.item()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


def append_jsonl(path: Union[str, Path], record: Dict[str, Any]) -> None:
    """Append one run record with id + timestamp."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    record = dict(record)
    record.setdefault("run_id", uuid.uuid4().hex[:12])
    record.setdefault("timestamp", time.strftime("%Y-%m-%dT%H:%M:%S"))
    with open(path, "a") as f:
        f.write(json.dumps(_jsonable(record)) + "\n")


def _flatten(prefix: str, value: Any, row: Dict[str, Any]) -> None:
    if isinstance(value, dict):
        for k, v in value.items():
            _flatten(f"{prefix}.{k}" if prefix else str(k), v, row)
    elif isinstance(value, (int, float)):
        row[prefix] = value


def write_summary_csv(path: Union[str, Path], results: Sequence[Dict[str, Any]]) -> None:
    """Flatten result records into one CSV (experiment × set rows)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    rows: List[Dict[str, Any]] = []
    for result in results:
        row: Dict[str, Any] = {
            "experiment": result.get("experiment"),
            "evaluation_set": result.get("evaluation_set"),
        }
        _flatten("", result.get("metrics", {}), row)
        rows.append(row)
    if not rows:
        return
    fields: List[str] = []
    for row in rows:
        for key in row:
            if key not in fields:
                fields.append(key)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields)
        writer.writeheader()
        writer.writerows(rows)


def read_jsonl(path: Union[str, Path]) -> List[Dict[str, Any]]:
    """Read all records of a JSONL file (empty list when absent)."""
    path = Path(path)
    if not path.exists():
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ---------------------------------------------------------------------------
# Training-side experiment metadata
# ---------------------------------------------------------------------------


def _rewrite_csv(path: Path, rows: List[Dict[str, Any]]) -> None:
    """Write rows with the union of all columns (order-preserving)."""
    fields: List[str] = []
    for row in rows:
        for key in row:
            if key not in fields:
                fields.append(key)
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=fields)
        writer.writeheader()
        writer.writerows(rows)


def save_experiment_metadata(
    output_dir: Union[str, Path],
    config: Any,
    checkpoint_name: str,
    metrics: Union[Dict[str, float], None] = None,
    is_best: bool = False,
    is_final: bool = False,
) -> Path:
    """Append one checkpoint's metadata row (run id, config snapshot, metrics).

    Every best, periodic or final checkpoint gets a row in
    ``<output_dir>/metadata/experiment_metadata.csv`` with the whole config
    as a JSON snapshot, so that a run can be rebuilt from its artifacts.
    Each append rewrites the file with the union of the rows' columns.
    """
    metadata_dir = Path(output_dir) / "metadata"
    metadata_dir.mkdir(parents=True, exist_ok=True)
    config_dict = config.to_dict() if hasattr(config, "to_dict") else dict(config)
    run_id = (
        config_dict.get("run_name")
        or config_dict.get("run_id")
        or uuid.uuid4().hex[:12]
    )
    row: Dict[str, Any] = {
        "id": run_id,
        "end_timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "checkpoint_name": checkpoint_name,
        "is_best": is_best,
        "is_final": is_final,
        "config": json.dumps(_jsonable(config_dict), sort_keys=True),
    }
    if metrics:
        row.update({k: _jsonable(v) for k, v in metrics.items()})
    path = metadata_dir / "experiment_metadata.csv"
    rows = load_experiment_metadata(output_dir)
    rows.append(row)
    _rewrite_csv(path, rows)
    return path


def load_experiment_metadata(output_dir: Union[str, Path]) -> List[Dict[str, Any]]:
    """Rows of ``metadata/experiment_metadata.csv`` with booleans restored."""
    path = Path(output_dir) / "metadata" / "experiment_metadata.csv"
    if not path.exists():
        return []
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    for row in rows:
        for key in ("is_best", "is_final"):
            if key in row:
                row[key] = str(row[key]).lower() == "true"
    return rows


def get_config_from_metadata(
    rows: Sequence[Dict[str, Any]], prefer: str = "final"
) -> Union[Dict[str, Any], None]:
    """The config snapshot of the final (``prefer="final"``) or best row, else the last row's."""
    if not rows:
        return None
    flag = "is_final" if prefer == "final" else "is_best"
    chosen = next((r for r in reversed(list(rows)) if r.get(flag)), rows[-1])
    raw = chosen.get("config")
    if not raw:
        return None
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return None


# ---------------------------------------------------------------------------
# Evaluation summaries
# ---------------------------------------------------------------------------

#: key metrics for the simple summary, in leaderboard order
SIMPLE_SUMMARY_METRICS = (
    "probe.test_accuracy",
    "probe.test_balanced_accuracy",
    "probe.test_map",
    "retrieval.roc_auc",
    "retrieval.precision_at_1",
    "clustering.ari",
    "clustering.nmi",
)


def create_experiment_summary_csvs(
    results: Sequence[Dict[str, Any]],
    save_dir: Union[str, Path],
    global_csv_path: Union[str, Path, None] = None,
) -> None:
    """Write the full + simple summaries and per-dataset CSVs.

    Artifacts (all leaderboard-readable):
      - ``summary.csv``: one row per experiment × evaluation set, every metric
      - ``summary_simple.csv``: key metrics only (SIMPLE_SUMMARY_METRICS)
      - ``summaries/<evaluation_set>.csv``: per-dataset slices
      - optional global CSV accumulating across invocations
    """
    save_dir = Path(save_dir)
    write_summary_csv(save_dir / "summary.csv", results)

    simple_rows = []
    for result in results:
        flat: Dict[str, Any] = {}
        _flatten("", result.get("metrics", {}), flat)
        simple_rows.append(
            {
                "experiment": result.get("experiment"),
                "evaluation_set": result.get("evaluation_set"),
                **{m: flat.get(m) for m in SIMPLE_SUMMARY_METRICS if m in flat},
            }
        )
    if simple_rows:
        _rewrite_csv(save_dir / "summary_simple.csv", simple_rows)

    by_set: Dict[str, List[Dict[str, Any]]] = {}
    for result in results:
        by_set.setdefault(str(result.get("evaluation_set")), []).append(result)
    per_set_dir = save_dir / "summaries"
    per_set_dir.mkdir(parents=True, exist_ok=True)
    for set_name, set_results in by_set.items():
        write_summary_csv(per_set_dir / f"{set_name}.csv", set_results)

    if global_csv_path:
        global_path = Path(global_csv_path)
        existing: List[Dict[str, Any]] = []
        if global_path.exists():
            with open(global_path, newline="") as f:
                existing = list(csv.DictReader(f))
        new_rows = []
        for result in results:
            row: Dict[str, Any] = {
                "experiment": result.get("experiment"),
                "evaluation_set": result.get("evaluation_set"),
                "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
            }
            _flatten("", result.get("metrics", {}), row)
            new_rows.append(row)
        global_path.parent.mkdir(parents=True, exist_ok=True)
        _rewrite_csv(global_path, existing + new_rows)

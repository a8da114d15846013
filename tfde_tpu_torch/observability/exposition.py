"""Exposition: render a metric snapshot for operators — the part of
`tfde_tpu/observability/exposition.py` that the cluster aggregator
(observability/aggregate.py) needs:

- **Prometheus text** (`to_prometheus_text`): the scrape format, classic
  histograms included (`_bucket{le="..."}` / `_sum` / `_count`);
  `parse_prometheus_text` is the inverse;
- `prom_name`: slash-namespaced metric names ("train/data_wait")
  sanitize to ``tfde_train_data_wait``.

The text is the JAX package's for the same snapshot. The HTTP endpoint
(`MetricsServer`, a RunConfig's ``metrics_port``) and the JSONL event
log (`JsonlMetricsLog`) are not ported yet (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

import re
from typing import Dict, Optional

from tfde_tpu_torch.observability import metrics

PROM_PREFIX = "tfde_"
PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_INVALID = re.compile(r"[^a-zA-Z0-9_:]")


def prom_name(name: str, prefix: str = PROM_PREFIX) -> str:
    """'train/data_wait' -> 'tfde_train_data_wait' (Prometheus charset)."""
    out = _INVALID.sub("_", f"{prefix}{name}")
    if out[0].isdigit():
        out = f"_{out}"
    return out


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    return repr(float(v))


def to_prometheus_text(snapshot: Optional[Dict[str, dict]] = None,
                       registry: Optional[metrics.Registry] = None,
                       prefix: str = PROM_PREFIX) -> str:
    """Render a `Registry.snapshot()` (or the registry's current state) as
    Prometheus text exposition format. Counters get the conventional
    `_total` suffix; histograms render classic cumulative buckets."""
    if snapshot is None:
        snapshot = (registry or metrics.default_registry()).snapshot()
    lines = []
    for name in sorted(snapshot):
        data = snapshot[name]
        kind = data["type"]
        pname = prom_name(name, prefix)
        if kind == "counter":
            pname = f"{pname}_total"
            lines.append(f"# TYPE {pname} counter")
            lines.append(f"{pname} {_fmt(data['value'])}")
        elif kind == "gauge":
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_fmt(data['value'])}")
        else:  # histogram
            lines.append(f"# TYPE {pname} histogram")
            cum = 0
            for le, cum in data["buckets"]:
                lines.append(f'{pname}_bucket{{le="{_fmt(le)}"}} {cum}')
            lines.append(f'{pname}_bucket{{le="+Inf"}} {data["count"]}')
            lines.append(f"{pname}_sum {_fmt(data['sum'])}")
            lines.append(f"{pname}_count {data['count']}")
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> Dict[str, dict]:
    """Inverse of `to_prometheus_text` for the families it emits. Returns
    {prom_name: {"type": ..., "value": float}} for counters (name keeps its
    `_total` suffix) and gauges, and {"type": "histogram", "buckets":
    [(le, cum)], "sum": float, "count": int} for histograms."""
    types: Dict[str, str] = {}
    out: Dict[str, dict] = {}
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split()
            if len(parts) >= 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        name_part, _, val_part = line.rpartition(" ")
        value = float(val_part)
        if "{" in name_part:
            base, _, rest = name_part.partition("{")
            labels = rest.rstrip("}")
            if base.endswith("_bucket"):
                hname = base[: -len("_bucket")]
                h = out.setdefault(
                    hname, {"type": "histogram", "buckets": [],
                            "sum": 0.0, "count": 0})
                m = re.search(r'le="([^"]+)"', labels)
                le = float(m.group(1)) if m.group(1) != "+Inf" else float("inf")
                h["buckets"].append((le, int(value)))
            continue
        if name_part.endswith("_sum") and name_part[: -4] in out:
            out[name_part[: -4]]["sum"] = value
        elif name_part.endswith("_count") and name_part[: -6] in out:
            out[name_part[: -6]]["count"] = int(value)
        else:
            out[name_part] = {"type": types.get(name_part, "untyped"),
                              "value": value}
    # the +Inf bucket duplicates _count; drop it for a clean comparison
    for h in out.values():
        if h.get("type") == "histogram":
            h["buckets"] = [(le, c) for le, c in h["buckets"]
                            if le != float("inf")]
    return out

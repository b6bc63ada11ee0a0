"""Cross-run regression tracking: a run index over bench records +
manifests (port of ``gossipprotocol_tpu/obs/history.py``, host only).

Every recorded bench session leaves a ``BENCH_rNN.json`` at the repo
root and (since the observatory) a persisted telemetry dir under
``artifacts/bench_telemetry_rNN/``; every ``--telemetry-dir`` run leaves
a ``run.json`` manifest. :func:`build_index` sweeps both into one
chronological ``artifacts/run_index.jsonl`` — a flat, append-friendly
record stream any later tool (or a human with ``jq``) can diff.

``python -m gossipprotocol_tpu_torch history [ROOT]`` rebuilds the index and
prints the headline-metric trajectory: one line per bench round with the
value, the delta against the previous round, and the predicted-vs-actual
round ratio when the manifest recorded one. ``--metric SUBSTR`` filters
to matching metric names. Exit 0 on success, 2 when ROOT has no bench
records at all.
"""

from __future__ import annotations

import glob
import json
import os
import re
import sys
from typing import Any, Dict, List, Optional, TextIO

from gossipprotocol_tpu_torch.utils.metrics import SCHEMA_VERSION

INDEX_RELPATH = os.path.join("artifacts", "run_index.jsonl")

_BENCH_RE = re.compile(r"BENCH_r(\d+)\.json$")


def _load_json(path: str) -> Optional[Dict[str, Any]]:
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, json.JSONDecodeError):
        return None


def _bench_records(root: str) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    for path in sorted(glob.glob(os.path.join(root, "BENCH_r*.json"))):
        m = _BENCH_RE.search(os.path.basename(path))
        doc = _load_json(path)
        if m is None or doc is None:
            continue
        parsed = doc.get("parsed") or {}
        rec: Dict[str, Any] = {
            "v": SCHEMA_VERSION,
            "kind": "bench",
            "seq": int(m.group(1)),
            "source": os.path.basename(path),
            "metric": parsed.get("metric"),
            "value": parsed.get("value"),
            "unit": parsed.get("unit"),
            "rounds": parsed.get("rounds"),
            "nodes": parsed.get("nodes"),
            "backend": parsed.get("backend"),
            "rc": doc.get("rc"),
        }
        if isinstance(parsed.get("phase_s"), dict):
            rec["phase_s"] = parsed["phase_s"]
        if parsed.get("prediction_ratio") is not None:
            rec["prediction_ratio"] = parsed["prediction_ratio"]
        # infra-outcome stamp (same metric names the /metrics exporter
        # uses, so bench infra-failures join daemon retry totals)
        for key in ("infra_failure", "probe_attempts", "infra_outcome",
                    "gossip_infra_retries_total",
                    "gossip_retry_backoff_seconds_total"):
            if parsed.get(key) is not None:
                rec[key] = parsed[key]
        out.append(rec)
    return out


def _manifest_records(root: str) -> List[Dict[str, Any]]:
    """Manifests under ``artifacts/`` (persisted bench telemetry and any
    run the user parked there), up to two levels deep."""
    out: List[Dict[str, Any]] = []
    pats = (os.path.join(root, "artifacts", "*", "run.json"),
            os.path.join(root, "artifacts", "*", "*", "run.json"))
    seen = set()
    for pat in pats:
        for path in sorted(glob.glob(pat)):
            # realpath: a symlinked artifacts dir must not index the
            # same manifest twice under two spellings
            real = os.path.realpath(path)
            if real in seen:
                continue
            seen.add(real)
            doc = _load_json(path)
            if doc is None or doc.get("kind") != "run_manifest":
                continue
            cfg = doc.get("config") or {}
            topo = doc.get("topology") or {}
            result = doc.get("result") or {}
            pred = doc.get("prediction") or {}
            rec = {
                "v": SCHEMA_VERSION,
                "kind": "run",
                "source": os.path.relpath(path, root),
                "algorithm": cfg.get("algorithm"),
                "topology": topo.get("kind"),
                "num_nodes": topo.get("num_nodes"),
                "backend": doc.get("backend"),
                "converged": result.get("converged"),
                "rounds": result.get("rounds"),
                "wall_ms": result.get("wall_ms"),
                "predicted_rounds": pred.get("predicted_rounds"),
                "actual_over_predicted": pred.get("actual_over_predicted"),
                "request_id": doc.get("request_id"),
            }
            rec.update(_resource_metrics(os.path.dirname(path)))
            out.append(rec)
            out.extend(_sweep_records(doc, rec["source"]))
    return out


def _sweep_records(doc: Dict[str, Any],
                   source: str) -> List[Dict[str, Any]]:
    """Sweep manifests fan out into the index: one ``sweep_lane`` record
    per lane (so lane outcomes diff like standalone runs) plus one
    ``sweep`` rollup row with the converged-lane fraction and the round
    percentiles. Non-sweep manifests contribute nothing here."""
    sweep = doc.get("sweep")
    if not isinstance(sweep, dict):
        return []
    cfg = doc.get("config") or {}
    topo = doc.get("topology") or {}
    base = {
        "v": SCHEMA_VERSION,
        "source": source,
        "algorithm": cfg.get("algorithm"),
        "topology": topo.get("kind"),
        "num_nodes": topo.get("num_nodes"),
        "backend": doc.get("backend"),
    }
    out: List[Dict[str, Any]] = []
    for lane in sweep.get("per_lane") or []:
        out.append({
            **base,
            "kind": "sweep_lane",
            "lane": lane.get("lane"),
            "seed": lane.get("seed"),
            "overrides": lane.get("overrides"),
            "converged": lane.get("converged"),
            "rounds": lane.get("rounds"),
        })
    out.append({
        **base,
        "kind": "sweep",
        "lanes": sweep.get("lanes"),
        "converged_fraction": sweep.get("converged_fraction"),
        "rounds_p50": sweep.get("rounds_p50"),
        "rounds_p95": sweep.get("rounds_p95"),
        "rounds_max": sweep.get("rounds_max"),
        "over_budget": sweep.get("over_budget"),
    })
    return out


def _resource_metrics(tel_dir: str) -> Dict[str, Any]:
    """Headline resource figures from a sibling ``resources.json``
    (resource observatory): peak host RSS and the chunk program's
    FLOPs / per-device argument bytes. Empty when the dir predates the
    observatory — old records index unchanged."""
    doc = _load_json(os.path.join(tel_dir, "resources.json"))
    if not doc or doc.get("kind") != "run_resources":
        return {}
    out: Dict[str, Any] = {}
    peak = (doc.get("host") or {}).get("peak_rss_bytes")
    if peak is not None:
        out["peak_rss_bytes"] = peak
    for prog in doc.get("programs") or []:
        if prog.get("label") != "chunk":
            continue
        flops = (prog.get("cost") or {}).get("flops")
        if flops is not None:
            out["chunk_flops"] = flops
        arg = (prog.get("memory") or {}).get("argument_size_in_bytes")
        if arg is not None:
            out["chunk_argument_bytes"] = arg
        break
    return out


def _journal_records(root: str) -> List[Dict[str, Any]]:
    """Daemon request records from serve/ queue-dir journals: one
    ``request`` row per request (id, admission verdict, queue wait,
    terminal phase, outcome) so daemon traffic diffs next to standalone
    runs. Journals are found at ROOT itself (ROOT *is* a queue dir),
    one level down, and under ``artifacts/``."""
    from gossipprotocol_tpu_torch.serve import journal as journal_mod

    pats = (os.path.join(root, "journal.jsonl"),
            os.path.join(root, "*", "journal.jsonl"),
            os.path.join(root, "artifacts", "*", "journal.jsonl"))
    seen = set()
    out: List[Dict[str, Any]] = []
    for pat in pats:
        for path in sorted(glob.glob(pat)):
            real = os.path.realpath(path)
            if real in seen:
                continue
            seen.add(real)
            states = journal_mod.replay(journal_mod.read_journal(path))
            for st in states.values():
                last = st.last
                out.append({
                    "v": SCHEMA_VERSION,
                    "kind": "request",
                    "source": os.path.relpath(path, root),
                    "request_id": st.id,
                    "verdict": st.verdict,
                    "phase": st.phase,
                    "queue_wait_s": st.queue_wait_s,
                    "reason": last.get("reason"),
                    "converged": last.get("converged"),
                    "rounds": last.get("rounds"),
                    "batch": (st.first("batched") or {}).get("batch"),
                })
    return out


def _index_key(rec: Dict[str, Any], root: str) -> tuple:
    """Identity of an index record: kind + the *resolved* source path +
    the in-file id (request/lane). Two glob spellings of one artifact —
    symlinked dirs, a queue dir that is both ROOT and under artifacts/ —
    collapse to one key, so re-indexing never multiplies rows."""
    kind = rec.get("kind")
    src = os.path.realpath(os.path.join(root, rec.get("source") or ""))
    if kind == "bench":
        return (kind, rec.get("seq"), rec.get("metric"))
    if kind == "request":
        return (kind, src, rec.get("request_id"))
    if kind == "sweep_lane":
        return (kind, src, rec.get("lane"))
    return (kind, src, rec.get("request_id"))


def _dedupe(records: List[Dict[str, Any]],
            root: str) -> List[Dict[str, Any]]:
    seen = set()
    out: List[Dict[str, Any]] = []
    for rec in records:
        key = _index_key(rec, root)
        if key in seen:
            continue
        seen.add(key)
        out.append(rec)
    return out


def build_index(root: str, write: bool = True) -> List[Dict[str, Any]]:
    """Sweep ROOT for bench records, manifests, and daemon journals;
    optionally (re)write ``artifacts/run_index.jsonl`` (atomic
    tmp+rename — the index is a derived artifact, rebuilt whole each
    time). Records are deduped on (kind, resolved source, id) so
    overlapping sweep patterns and symlinked dirs index once."""
    records = _dedupe(_bench_records(root) + _manifest_records(root)
                      + _journal_records(root), root)
    if write and records:
        path = os.path.join(root, INDEX_RELPATH)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            for rec in records:
                fh.write(json.dumps(rec) + "\n")
        os.replace(tmp, path)
    return records


def _fmt_delta(cur: Any, prev: Any) -> str:
    if not isinstance(cur, (int, float)) or not isinstance(prev, (int, float)):
        return ""
    if prev <= 0:
        return ""
    d = (cur - prev) / prev
    return f"  {d:+.1%}"


def render_history(records: List[Dict[str, Any]], out: TextIO,
                   metric_filter: Optional[str] = None) -> None:
    benches = [r for r in records if r["kind"] == "bench"
               and r.get("metric")
               and (metric_filter is None or metric_filter in r["metric"])]
    by_metric: Dict[str, List[Dict[str, Any]]] = {}
    for r in benches:
        by_metric.setdefault(r["metric"], []).append(r)
    for metric, rows in by_metric.items():
        rows.sort(key=lambda r: r["seq"])
        out.write(f"{metric}:\n")
        prev = None
        for r in rows:
            val = r.get("value")
            line = (f"  r{r['seq']:02d}  "
                    + (f"{val:10.3f} {r.get('unit') or ''}"
                       if isinstance(val, (int, float)) else f"{val!r:>10}"))
            if r.get("rounds") is not None:
                line += f"  {r['rounds']} rounds"
            if r.get("backend"):
                line += f"  [{r['backend']}]"
            line += _fmt_delta(val, (prev or {}).get("value"))
            if r.get("prediction_ratio") is not None:
                line += f"  pred-ratio {r['prediction_ratio']:.2f}"
            if r.get("gossip_infra_retries_total"):
                line += (f"  infra-retries "
                         f"{r['gossip_infra_retries_total']}")
            if r.get("infra_failure") or (
                    r.get("infra_outcome") == "infra_failure"):
                line += "  INFRA-FAILURE"
            out.write(line + "\n")
            prev = r
        out.write("\n")
    runs = [r for r in records if r["kind"] == "run"]
    if runs:
        out.write(f"indexed manifests ({len(runs)}):\n")
        for r in runs:
            line = (f"  {r.get('algorithm', '?')} on "
                    f"{r.get('topology', '?')}-{r.get('num_nodes', '?')}: ")
            if r.get("rounds") is not None:
                line += f"{r['rounds']} rounds"
            if isinstance(r.get("wall_ms"), (int, float)):
                line += f", {r['wall_ms']:.1f} ms"
            if r.get("actual_over_predicted") is not None:
                line += f", {r['actual_over_predicted']:.2f}x predicted"
            if isinstance(r.get("peak_rss_bytes"), (int, float)):
                line += f", peak RSS {r['peak_rss_bytes'] / 2**20:.0f} MiB"
            line += f"  ({r['source']})"
            out.write(line + "\n")
    sweeps = [r for r in records if r["kind"] == "sweep"]
    if sweeps:
        out.write(f"\nindexed sweeps ({len(sweeps)}):\n")
        for r in sweeps:
            line = (f"  {r.get('algorithm', '?')} on "
                    f"{r.get('topology', '?')}-{r.get('num_nodes', '?')}: "
                    f"{r.get('lanes', '?')} lanes")
            if isinstance(r.get("converged_fraction"), (int, float)):
                line += f", {r['converged_fraction']:.0%} converged"
            if r.get("rounds_p50") is not None:
                line += (f", rounds p50 {r['rounds_p50']:.0f}"
                         f" / p95 {r['rounds_p95']:.0f}")
            if r.get("over_budget"):
                line += ", OVER BUDGET"
            line += f"  ({r['source']})"
            out.write(line + "\n")
    requests = [r for r in records if r["kind"] == "request"]
    if requests:
        out.write(f"\nindexed daemon requests ({len(requests)}):\n")
        for r in requests:
            line = f"  {r.get('request_id')}  {r.get('phase')}"
            if r.get("verdict") == "refused":
                line += f"  ({r.get('reason')})"
            elif r.get("phase") == "finished":
                line += (f"  converged={r.get('converged')}"
                         f" rounds={r.get('rounds')}")
            if r.get("queue_wait_s") is not None:
                line += f"  queue_wait={r['queue_wait_s']:.2f}s"
            if r.get("batch"):
                line += f"  batch={r['batch']}"
            line += f"  ({r['source']})"
            out.write(line + "\n")


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("-h", "--help"):
        print("usage: python -m gossipprotocol_tpu_torch history [ROOT] "
              "[--metric SUBSTR] [--no-write]")
        return 0
    root = "."
    metric: Optional[str] = None
    write = True
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--metric":
            if i + 1 >= len(argv):
                print("history: --metric needs a value", file=sys.stderr)
                return 2
            metric = argv[i + 1]
            i += 2
        elif a == "--no-write":
            write = False
            i += 1
        else:
            root = a
            i += 1
    if not os.path.isdir(root):
        print(f"history: {root!r} is not a directory", file=sys.stderr)
        return 2
    records = build_index(root, write=write)
    if not records:
        print(f"history: no BENCH_r*.json or manifests under {root!r}",
              file=sys.stderr)
        return 2
    render_history(records, sys.stdout, metric_filter=metric)
    if write:
        print(f"index: {os.path.join(root, INDEX_RELPATH)} "
              f"({len(records)} records)")
    return 0

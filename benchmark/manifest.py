"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration's file is the one ``configs`` gives; the traffic mix is
``traffic/<traffic>.json``; each metric, end-to-end or per-layer, is read by
``metrics/<name>.py``; the backbone and the DensePose head a configuration
names are files under ``reference/`` (``parts.py``). So a configuration, a
mix, a cell, a metric or a model part is added with new files and entries,
and no existing file changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = {"host_clock", "device_trace", "program_span", "program_counter"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def load(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            with open(ROOT / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def metrics_of(manifest: dict, cell_name: str, trace: bool) -> List[dict]:
    """The metrics a run of the cell reports: the end-to-end ones without
    a trace, the per-layer ones with; each in the cells its ``workloads``
    lists, or in every cell where it has none."""
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if "workloads" not in m or cell_name in m["workloads"]]


def reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    return load_file(HERE / "metrics" / f"{name}.py", f"benchmark.metrics.{name}").read


def load_file(path: Path, module_name: str):
    """The module that the Python file ``path`` holds, loaded as
    ``module_name`` (not entered in ``sys.modules``)."""
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _line(s, limit=200) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= limit and "\n" not in s and "\t" not in s


def problems(m: dict) -> List[str]:
    """What in the manifest breaks the benchmark's rules (empty if nothing)."""
    out: List[str] = []
    if set(m) != KEYS:
        out.append(f"keys {sorted(m)}")
        return out
    cmd = m["command"]
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)):
        out.append("command")
    if any(w.startswith("/") or ".." in w.split("/") for w in cmd):
        out.append("command leaves the checkout")
    if not (1 <= len(m["paths"]) <= 16 and all(PATH.match(p) and ".." not in p.split("/")
                                              for p in m["paths"])):
        out.append("paths")
    if not (isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51):
        out.append("run_seconds")
    names = {}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in m[group]:
            if not NAME.match(str(e.get("name", ""))):
                out.append(f"{group}: name {e.get('name')!r}")
            kind = "config" if group == "configs" else "cell" if group == "workloads" else "metric"
            if (kind, e.get("name")) in names:
                out.append(f"{kind} {e.get('name')} twice")
            names[(kind, e.get("name"))] = e
    configs = {c["name"]: c for c in m["configs"]}
    files = [c["file"] for c in m["configs"]]
    if len(set(files)) != len(files):
        out.append("two configurations share a file")
    for c in m["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            out.append(f"config {c['name']}: keys")
        if not _line(c["source"]) or not _line(c["why"]):
            out.append(f"config {c['name']}: source or why")
        if not any(c["file"].startswith(p.rstrip("/") + "/") for p in m["paths"]):
            out.append(f"config {c['name']}: file outside paths")
        if len(c["reduced"]) > 16 or not all(NAME.match(k) for k in c["reduced"]):
            out.append(f"config {c['name']}: reduced")
    used = set()
    pairs = set()
    for w in m["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            out.append(f"cell {w['name']}: keys")
        if w["config"] not in configs:
            out.append(f"cell {w['name']}: no configuration {w['config']}")
        if not NAME.match(w["traffic"]) or w["chips"] not in (1, 4) or not _line(w["why"]):
            out.append(f"cell {w['name']}: traffic, chips or why")
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"cell {w['name']}: configuration and traffic twice")
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    for c in configs:
        if c not in used:
            out.append(f"config {c}: no cell")
    cells = [w["name"] for w in m["workloads"]]
    e2e = {e["name"]: e for e in m["end_to_end"]}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for group, sources in (("end_to_end", SOURCES_E2E), ("per_layer", SOURCES)):
        for e in m[group]:
            allowed = {"name", "unit", "better", "source", "workloads"}
            allowed |= {"bound"} if group == "end_to_end" else {"layer", "moves"}
            if not set(e) <= allowed or not set(allowed - {"workloads"}) <= set(e):
                out.append(f"{e['name']}: keys")
            if not UNIT.match(str(e.get("unit", ""))) or e.get("better") not in ("lower", "higher"):
                out.append(f"{e['name']}: unit or better")
            if e.get("source") not in sources:
                out.append(f"{e['name']}: source")
            if any(c not in cells for c in e.get("workloads", [])):
                out.append(f"{e['name']}: workloads")
    for e in m["end_to_end"]:
        if not 0 < e.get("bound", 0) <= 0.25:
            out.append(f"{e['name']}: bound")
    for e in m["per_layer"]:
        if not _line(e.get("layer")):
            out.append(f"{e['name']}: layer")
        moved = e2e.get(e.get("moves"))
        if moved is None:
            out.append(f"{e['name']}: moves {e.get('moves')!r}")
            continue
        for c in e.get("workloads", cells):
            if c not in moved.get("workloads", cells):
                out.append(f"{e['name']}: {c} does not report {e['moves']}")
    for c in cells:
        reported = [e for e in m["end_to_end"] if c in e.get("workloads", cells)]
        if len(reported) < 2 or not any(c in e.get("workloads", cells) for e in m["per_layer"]):
            out.append(f"cell {c}: too few metrics")
    if len(json.dumps(m)) > 64 * 1024:
        out.append("larger than 64 KiB")
    return out


def check_config(run_cfg: dict, program_cfg) -> Dict[str, tuple]:
    """Keys of the configuration file's ``model`` section whose value the
    program's config does not hold: {key: (file's, program's)}."""
    bad = {}
    for key, want in run_cfg["model"].items():
        node = program_cfg
        for part in key.split("."):
            node = node[part]
        got = json.loads(json.dumps(node, default=list))
        if got != want:
            bad[key] = (want, got)
    return bad

"""Finds a cell's files by the names in ``BENCHMARK.json``.

* ``benchmark/configs/<config>.json``: the configuration as it is run
  (``config``), its source and what was changed from it;
* ``benchmark/workloads/<cell>.json``: the cell's parameters and the
  limits of its correctness check;
* ``benchmark/traffic/<traffic>.json``: the traffic mix, whose ``driver``
  names ``benchmark/drivers/<driver>.py``;
* ``benchmark/metrics/<metric>.py``: one per-layer metric's reader.

A later change adds a cell, configuration, traffic mix or metric as new
files and a new entry; no file here needs an edit for it.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Any, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _load(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def _named(kind: str, name: str, ext: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = os.path.join(BENCH_DIR, kind, name + ext)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return path


def benchmark() -> Dict[str, Any]:
    return _load(os.path.join(ROOT, "BENCHMARK.json"))


def cell(name: str, bench: Dict[str, Any] = None) -> Dict[str, Any]:
    """The cell's entry in ``BENCHMARK.json`` with its workload file's
    ``params`` and ``limits``, its configuration and its traffic mix."""
    bench = bench or benchmark()
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"workload {name!r} is not in BENCHMARK.json")
    out = dict(entries[0])
    out.update(_load(_named("workloads", name, ".json")))
    out["config_file"] = _load(_named("configs", out["config"], ".json"))
    out["traffic_mix"] = _load(_named("traffic", out["traffic"], ".json"))
    return out


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = _named(kind, name, ".py")
    mod_name = f"bench_{kind}_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def end_to_end_for(name: str, bench: Dict[str, Any] = None) -> List[Dict[str, Any]]:
    """The end-to-end metrics this cell reports."""
    bench = bench or benchmark()
    return [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]


def per_layer_for(name: str, bench: Dict[str, Any] = None) -> List[Dict[str, Any]]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    bench = bench or benchmark()
    mine = {m["name"] for m in end_to_end_for(name, bench)}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m else m["moves"] in mine)]

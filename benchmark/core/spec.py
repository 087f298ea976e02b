"""Find a cell's files by name: BENCHMARK.json at the checkout's root,
`configs/<config>.json`, `workloads/<cell>.json`, `modes/<mode>.py`,
`metrics/<metric>.py` and the reference module a configuration names.
Adding a cell, a configuration or a metric adds files and entries; no
file here names one."""

import importlib
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    """Import the Python file `path` under the module name `name` (file
    names may hold dots, as metric names do)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One cell with its files loaded: an entry of BENCHMARK.json's
    workloads, its workload file and its configuration's file."""

    def __init__(self, name, bench_dir=BENCH_DIR):
        self.bench_dir = bench_dir
        root = os.path.dirname(bench_dir)
        self.benchmark = load_json(os.path.join(root, "BENCHMARK.json"))
        self.name = name
        self.workload = load_json(os.path.join(bench_dir, "workloads",
                                               f"{name}.json"))
        self.entry = {w["name"]: w
                      for w in self.benchmark["workloads"]}[name]
        configs = {c["name"]: c["file"] for c in self.benchmark["configs"]}
        cfg = self.entry["config"]
        self.config = load_json(os.path.join(root, configs[cfg]))
        self.config["name"] = cfg

    def mode(self):
        return load_module(os.path.join(self.bench_dir, "modes",
                                        f"{self.workload['mode']}.py"),
                           f"bench_mode_{self.workload['mode']}")

    def reference(self):
        """The configuration's plain reference, `reference/<name>.py`."""
        return importlib.import_module(
            f"reference.{self.config['reference']}")

    def end_to_end(self):
        """This cell's end-to-end metric entries."""
        return [m for m in self.benchmark["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self):
        """This cell's per-layer metric entries: those that list it, and
        those without a list whose end-to-end metric this cell reports."""
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.benchmark["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]

    def reader(self, metric):
        return load_module(os.path.join(self.bench_dir, "metrics",
                                        f"{metric}.py"),
                           f"bench_metric_{metric.replace('.', '_')}")

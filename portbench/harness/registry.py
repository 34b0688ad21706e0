"""Find the benchmark's pieces by name, each in a file of its own:

  workloads/<cell>.json   config, traffic, chips, why, limits
  configs/<name>.json     the configuration as it is run (`model`), its
                          precision, peak and control
  traffic/<mix>.json      the loop that drives the program and its
                          parameters
  loops/<loop>.py         a loop: LOOP, a `harness.loopkit.Loop` that
                          drives the program, states its FLOPs a slice,
                          its kernels' shapes and its reference, and
                          gives the numbers its check compares
  metrics/<name>.py       a per-layer metric's reader: UNIT, and
                          read(readings), which returns a number, or
                          None where it finds nothing to read
  layers/<name>.json      name lists that readers match against

A later cell, mix, loop, configuration or metric is a new file: nothing here
lists them. `roots` are searched in order, so a test can add pieces from
a directory of its own.
"""

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Registry:
    def __init__(self, roots=None):
        self.roots = list(roots or []) + [BENCH_DIR]

    def path(self, kind: str, name: str, ext: str = ".json") -> str:
        for root in self.roots:
            p = os.path.join(root, kind, name + ext)
            if os.path.isfile(p):
                return p
        raise KeyError(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r} "
                       f"under {self.roots}")

    def load(self, kind: str, name: str) -> dict:
        with open(self.path(kind, name)) as f:
            return json.load(f)

    def cell(self, name: str) -> dict:
        """The cell `name` with its configuration and traffic mix loaded."""
        w = self.load("workloads", name)
        return {"name": name, "workload": w, "config": self.load("configs", w["config"]),
                "traffic": self.load("traffic", w["traffic"])}

    def _modules(self, kind: str) -> dict:
        """{name: module} of every <kind>/*.py, the first root's file
        winning a name."""
        out = {}
        for root in self.roots:
            d = os.path.join(root, kind)
            if not os.path.isdir(d):
                continue
            for f in sorted(os.listdir(d)):
                if f.endswith(".py") and f[:-3] not in out:
                    out[f[:-3]] = os.path.join(d, f)
        return out

    @staticmethod
    def _import(kind: str, name: str, path: str):
        spec = importlib.util.spec_from_file_location(
            f"portbench_{kind}_" + name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def readers(self) -> dict:
        """{metric name: (read function, unit)} of every metrics/*.py."""
        out = {}
        for name, path in self._modules("metrics").items():
            mod = self._import("metrics", name, path)
            out[name] = (mod.read, mod.UNIT)
        return out

    def loop(self, name: str):
        """The loop class of loops/<name>.py."""
        path = self._modules("loops").get(name)
        if path is None:
            raise KeyError(f"no loop named {name!r} under {self.roots}")
        return self._import("loops", name, path).LOOP

    def loops(self) -> dict:
        """{name: loop class} of every loops/*.py."""
        return {name: self._import("loops", name, path).LOOP
                for name, path in self._modules("loops").items()}

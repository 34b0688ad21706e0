"""Every cell, configuration, traffic mix and metric that BENCHMARK.json
names is found by name, each in a file of its own; a cell added as new
files in another directory is found without an edit to any file."""

import json
import os
import shutil

import pytest

from harness.cell import Run, run_cell
from harness.registry import BENCH_DIR, Registry

ROOT = os.path.dirname(BENCH_DIR)


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_cell_config_and_mix_is_found(bench):
    reg = Registry()
    names = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        cell = reg.cell(w["name"])
        assert cell["workload"]["config"] == w["config"] and w["config"] in names
        assert cell["workload"]["traffic"] == w["traffic"]
        assert cell["workload"]["chips"] == w["chips"] and cell["workload"]["why"] == w["why"]
        assert cell["traffic"]["loop"] in Registry().loops()
        assert cell["workload"]["limits"], "a cell compares at least one number"
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]


def test_every_metric_has_a_reader_with_its_unit(bench):
    readers = Registry().readers()
    for m in bench["per_layer"]:
        read, unit = readers[m["name"]]
        assert unit == m["unit"], m["name"]
    assert set(readers) == {m["name"] for m in bench["per_layer"]}
    for m in bench["end_to_end"]:
        units = {u for loop in Registry().loops().values() for k, u in loop.UNITS.items()
                 if k == m["name"]}
        assert units == {m["unit"]}, m["name"]


def test_a_cell_added_as_new_files_is_found(tmp_path):
    for kind in ("workloads", "traffic", "configs", "metrics"):
        (tmp_path / kind).mkdir()
    shutil.copy(os.path.join(BENCH_DIR, "configs", "san_f32.json"),
                tmp_path / "configs" / "san_f32_2coil.json")
    (tmp_path / "traffic" / "serve_closed_b4.json").write_text(json.dumps(
        {"loop": "serve_closed", "batch": 4, "pool": 2, "warmup": 1, "keep_every": 1,
         "max_kept": 2, "profiled": 2}))
    (tmp_path / "workloads" / "serve_new.json").write_text(json.dumps(
        {"config": "san_f32_2coil", "traffic": "serve_closed_b4", "chips": 1, "why": "a test",
         "limits": {"rec_rel_l2": 1.0}}))
    (tmp_path / "metrics" / "requests.serve.py").write_text(
        'UNIT = "1"\n\n\ndef read(r):\n    return r.stretch.get("requests") if r.kind == "serve" else None\n')
    before = sorted(os.listdir(os.path.join(BENCH_DIR, "workloads")))
    reg = Registry(roots=[str(tmp_path)])
    cell = reg.cell("serve_new")
    assert cell["traffic"]["batch"] == 4 and cell["config"]["model"]["shape"] == 320
    assert "requests.serve" in reg.readers() and "mfu.serve" in reg.readers()
    assert reg.cell("serve_f32_b8")["workload"]["config"] == "san_f32"
    assert sorted(os.listdir(os.path.join(BENCH_DIR, "workloads"))) == before
    with pytest.raises(KeyError):
        Registry().cell("serve_new")


TOY_LOOP = """
import time

from harness.loopkit import Loop


class Sums(Loop):
    kind = "serve"
    UNITS = {"slices_per_s": "slices/s", "request_ms_p95": "ms", "setup_s": "s"}

    def setup(self, plant=None):
        self.marks = [("start", time.perf_counter())]
        self.model = sum
        self.answers = []

    def window(self, seconds, timed=False):
        n = 0
        while n < 3:
            self.answers.append(self.model(range(self.batch)))
            n += 1
        return {"requests": n, "slices_per_s": n * self.batch / seconds,
                "latency_ms": [1.0, 2.0, 3.0]}

    def end_to_end(self, rec):
        return {"slices_per_s": rec["slices_per_s"], "request_ms_p95": 2.9}

    def units(self):
        return 1

    def flops_per_slice(self):
        return 2.0 * self.batch

    def check(self):
        want = sum(range(self.batch))
        return {"worst_gap": max(abs(a - want) for a in self.answers)}


LOOP = Sums
"""


def test_a_loop_added_as_new_files_drives_a_run(tmp_path):
    """A new loop, its mix and its cell, all in a directory of their own:
    found by name and run to its result, no existing file edited."""
    for kind in ("workloads", "traffic", "loops"):
        (tmp_path / kind).mkdir()
    (tmp_path / "loops" / "sums.py").write_text(TOY_LOOP)
    (tmp_path / "traffic" / "sums_b5.json").write_text(json.dumps({"loop": "sums", "batch": 5}))
    (tmp_path / "workloads" / "sums_cell.json").write_text(json.dumps(
        {"config": "san_f32", "traffic": "sums_b5", "chips": 1, "why": "a test",
         "limits": {"worst_gap": 0}}))
    before = {d: sorted(os.listdir(os.path.join(BENCH_DIR, d))) for d in ("loops", "traffic")}
    reg = Registry(roots=[str(tmp_path)])
    assert set(reg.loops()) == {"sums", "serve_closed", "train_step"}
    out = run_cell(reg.cell("sums_cell"), 7, 1.0, False, "cpu", registry=reg)
    assert out["correct"] is True and out["attempted"] == 3
    assert out["metrics"]["slices_per_s"] == (15.0, "slices/s")
    loop = reg.loop("sums")(Run(reg.cell("sums_cell"), 7, "cpu"))
    assert loop.flops_per_slice() == 10.0 and loop.kernel_work() == []
    assert {d: sorted(os.listdir(os.path.join(BENCH_DIR, d))) for d in before} == before
    with pytest.raises(KeyError):
        Registry().loop("sums")


def test_a_regime_the_reference_lacks_is_refused():
    reg = Registry()
    cell = reg.cell("train_mixed_f32_b4")
    cell["config"] = dict(cell["config"], model=dict(cell["config"]["model"], reg="Rec"))
    with pytest.raises(ValueError, match="no 'Rec' step"):
        reg.loop("train_step")(Run(cell, 1, "cpu"))

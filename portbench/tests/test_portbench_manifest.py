"""BENCHMARK.json against the contract's rules of names and units, and
every cell, configuration, mix and metric found by name in files of its
own."""

import json
import os
import re

import pytest

from portbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _bench():
    return manifest.benchmark()


def _one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_names_units_and_keys():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert len(json.dumps(b).encode()) <= 64 * 1024
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p for p in b["paths"])
    assert len(b["command"]) <= 32 and all(_one_line(w) for w in b["command"])
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                          "workloads"}
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _one_line(m["layer"])
    for c in b["configs"]:
        assert NAME.match(c["name"]) and _one_line(c["source"]) and _one_line(c["why"])
        assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_every_cell_is_found_by_name_and_agrees_with_its_file():
    b = _bench()
    used = set()
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and _one_line(w["why"]) and w["chips"] in (1, 4)
        f = manifest.workload(w["name"])
        assert {k: f[k] for k in ("config", "traffic", "chips", "why")} == \
            {k: w[k] for k in ("config", "traffic", "chips", "why")}
        cfg = manifest.config(w["config"])
        mix = manifest.traffic(w["traffic"])
        assert callable(manifest.driver(mix["driver"]).Driver)
        assert callable(manifest.generator(mix["generator"]).requests)
        fam = manifest.family(cfg["family"])
        assert callable(manifest.layout(fam.FIXTURE).write)
        used.add(w["config"])
        e2e, layer = manifest.metrics_of(b, w["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
        for m in layer:
            assert callable(manifest.reader(m["name"]).read)
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        cf = manifest.config(c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert cf["source"] == c["source"] and cf["reduced"] == c["reduced"]
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(b["workloads"]) // 4)


def test_a_cell_added_as_a_file_alone(tiny_bench):
    cell = {"name": "latr-base.serve-flood-b", "config": "latr-base", "traffic": "serve-flood",
            "chips": 1, "why": "a second flood cell"}
    _add_cell(tiny_bench, cell, "latr-base.serve-flood", {"served_gap": 1e-3})
    from .conftest import run_tiny

    result, _ = run_tiny(cell["name"], seconds=1.0)
    assert result["correct"] and set(result["metrics"]) == {"answers_per_s", "setup_s"}


def _add_cell(root, cell, like, limits):
    """Adds ``cell`` to the copy's BENCHMARK.json, reporting every metric
    that the cell ``like`` reports, and writes its workload file."""
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["workloads"].append({k: cell[k] for k in ("name", "config", "traffic", "chips", "why")})
    for m in b["end_to_end"] + b["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(cell["name"])
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    (root / "portbench" / "workloads" / f"{cell['name']}.json").write_text(json.dumps(
        dict({k: v for k, v in cell.items() if k != "name"}, limits=limits)))


LONE_DRIVER = '''"""One client at a time over the gathered engine."""

from portbench import manifest

closed = manifest.driver("closed")


class Driver(closed.Driver):

    def window(self):
        self.run.mix["clients"] = 1
        self.run.note("lone client")
        super().window()
'''


def test_a_driver_added_as_a_file_alone(tiny_bench):
    """A new loop is one new file under ``drivers/``, a mix naming it and a
    cell: no file of the core changes."""
    (tiny_bench / "portbench" / "drivers" / "lone.py").write_text(LONE_DRIVER)
    mix = json.loads((tiny_bench / "portbench" / "traffic" / "serve-flood.json").read_text())
    (tiny_bench / "portbench" / "traffic" / "serve-lone.json").write_text(json.dumps(
        dict(mix, driver="lone")))
    cell = {"name": "latr-base.serve-lone", "config": "latr-base", "traffic": "serve-lone",
            "chips": 1, "why": "one client at a time"}
    _add_cell(tiny_bench, cell, "latr-base.serve-flood", {"served_gap": 1e-3})
    from .conftest import run_tiny

    result, lines = run_tiny(cell["name"], seconds=1.0)
    assert result["correct"] and "note: lone client" in lines, lines
    assert set(result["metrics"]) == {"answers_per_s", "setup_s"}


def test_a_serving_cell_of_the_other_family_added_as_files_alone(tiny_bench):
    """PhonemeSaL under the flood mix (the first further cell PERF.md
    lists): a workload file and entries in BENCHMARK.json alone; its
    per-layer metrics read from the family's counted work."""
    cell = {"name": "phonemesal-base.serve-flood", "config": "phonemesal-base",
            "traffic": "serve-flood", "chips": 1, "why": "the SaL kernel and custom decoder served"}
    _add_cell(tiny_bench, cell, "latr-base.serve-flood", {"served_gap": 1e-4})
    from .conftest import run_tiny

    result, lines = run_tiny(cell["name"], seconds=1.0)
    assert result["correct"] and set(result["metrics"]) == {"answers_per_s", "setup_s"}, lines
    result, lines = run_tiny(cell["name"], seconds=4.0, trace=1)
    assert result["correct"], lines
    assert {"serve.mfu", "engine.resolve_share.flood", "device_idle.serve"} <= \
        set(result["metrics"]), result["metrics"]
    assert 0 < result["metrics"]["serve.mfu"]["value"]


@pytest.mark.parametrize("bad", ["a b", "x/y", ".x", "a" * 65, "é"])
def test_bad_names_are_refused(bad):
    with pytest.raises(manifest.ManifestError):
        manifest.workload(bad)


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(os.path.dirname(manifest.HERE), "portbench", "reference")
    ref = os.path.join(manifest.HERE, "reference")
    for d, _, files in os.walk(ref):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(d, f), encoding="utf-8").read()
                assert not re.search(r"^\s*(from|import)\s+(phoneme_vqa|jax|flax)", text, re.M), f

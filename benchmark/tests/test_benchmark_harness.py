"""The benchmark's files and its runs on the CPU at tiny sizes: the spec
resolves and keeps the contract's shape, each mix prints a well-formed
last line, a new cell needs only new files, and every planted fault of the
timed path turns ``correct`` false."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark_tiny import CELLS, PENDING, ROOT, tiny_context

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def bench():
    return harness.spec()


def test_spec_keys_names_and_bounds():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        names.add(c["name"])
    assert {w["config"] for w in b["workloads"]} == names
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and LINE.match(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    metric_names = []
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        metric_names.append(m["name"])
    assert "setup_s" in metric_names
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert LINE.match(m["layer"])
        metric_names.append(m["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(metric_names) == len(set(metric_names))
    assert len(json.dumps(b)) < 64 * 1024


def test_every_name_resolves_to_its_files():
    b = bench()
    for c in b["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"]
        assert len(cfg["source"]) <= 200
    for w in b["workloads"] + [{"name": k, **v} for k, v in PENDING.items()]:
        traffic = harness.traffic_file(w["traffic"])
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "mixes",
                                           traffic["kind"] + ".py"))
        assert hasattr(harness.mix_module(traffic["kind"]), "run")
        limits = harness.limits_file(w["name"])
        assert limits and all(v > 0 for v in limits.values())
    for m in b["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_each_cell_reports_what_its_layers_move():
    b = bench()
    for w in b["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(b, w["name"],
                                                      "end_to_end")}
        layers = harness.cell_metrics(b, w["name"], "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2 and layers
        for m in layers:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_config_files_are_what_the_port_runs():
    from benchmark.weights import PORT_KEYS, port_config
    for c in bench()["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        port = port_config(cfg)
        for key, value in cfg["sizes"].items():
            if key in PORT_KEYS:
                section, field = PORT_KEYS[key].split(".")
                assert getattr(getattr(port, section), field) == value, key


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cpu_run_prints_a_well_formed_line(cell, trace, capsys):
    ctx = tiny_context(cell, trace=trace)
    rc = harness.emit(ctx, harness.run_mix(ctx))
    assert rc == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["device"]["platform"] == "cpu"
    assert line["metrics"] == {}
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["checks"]) == set(ctx.limits)
    assert err.strip().splitlines()[-1].startswith("check ")


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A throwaway cell from a copy of the checkout's benchmark: a traffic
    file, a limits file, a per-layer reader and entries, no edit."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    traffic = harness.traffic_file("kitti-batch8")
    traffic["batch"] = 4
    (tmp_path / "benchmark" / "traffic" / "kitti-batch4.json").write_text(
        json.dumps(traffic))
    (tmp_path / "benchmark" / "limits" / "kitti-som.detect4.json").write_text(
        json.dumps(harness.limits_file("kitti-som.detect")))
    (tmp_path / "benchmark" / "metrics" / "clouds_done.detect.py").write_text(
        "def read(w):\n    return float(w.work) if w.work else None\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "kitti-som.detect4",
                              "config": "kitti-som",
                              "traffic": "kitti-batch4", "chips": 1,
                              "why": "a throwaway cell"})
    spec["per_layer"].append({"name": "clouds_done.detect", "unit": "clouds",
                              "better": "higher", "source": "host_clock",
                              "layer": "eval forward",
                              "moves": "detect_clouds_per_s",
                              "workloads": ["kitti-som.detect4"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    ctx = tiny_context("kitti-som.detect4", root=str(tmp_path))
    outcome = harness.run_mix(ctx)
    assert outcome.checks and all(c.ok for c in outcome.checks)
    reader = harness.metric_reader("clouds_done.detect", str(tmp_path))
    assert reader(ctx.window) == ctx.window.work > 0


def test_run_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
         "--workload", "kitti-som.detect", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_runs_load_no_jax_module():
    """In a fresh interpreter, a CPU run of every mix, the program with it,
    loads no module of JAX or of the JAX package (top-level names compared
    whole)."""
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from benchmark_tiny import CELLS, tiny_context\n"
        "from benchmark import harness\n"
        "import benchmark.run\n"
        "for cell in CELLS:\n"
        "    harness.run_mix(tiny_context(cell, seconds=0.3))\n"
        "print(harness.forbidden_modules())\n"
        % (ROOT, os.path.dirname(os.path.abspath(__file__))))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT, timeout=900)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def _frozen_step(make):
    """A train-step factory whose step runs but leaves the parameters as
    they were."""
    def factory(*args, **kwargs):
        step = make(*args, **kwargs)

        def faulty(state, *rest, **kw):
            before = [p.detach().clone()
                      for p in state.model.parameters()]
            out = step(state, *rest, **kw)
            with torch.no_grad():
                for p, b in zip(state.model.parameters(), before):
                    p.copy_(b)
            return out
        return faulty
    return factory


def _half_detector_step(make):
    def factory(*args, **kwargs):
        step = make(*args, **kwargs)

        def faulty(state, batch, epoch, *, draws=None, **kw):
            from usip_tpu_torch.train.steps import ParentBatch, draws_rows
            b = batch[0].shape[0]
            h = b // 2
            if draws is not None:
                draws = draws_rows(draws, slice(0, h), b)
            return step(state, ParentBatch(batch.pc[:h], batch.sn[:h]),
                        epoch, draws=draws, **kw)
        return faulty
    return factory


def _half_descriptor_step(make):
    def factory(*args, **kwargs):
        step = make(*args, **kwargs)

        def faulty(state, detector, batch, epoch, *, draws=None, **kw):
            from usip_tpu_torch.train.steps import PackedPairBatch, draws_rows
            b = batch.x.shape[0]
            h = b // 2
            if draws is not None:
                draws = draws_rows(draws, slice(0, h), b)
            neg = (torch.arange(h, device=batch.x.device) + 1) % h
            return step(state, detector, PackedPairBatch(batch.x[:h], neg),
                        epoch, draws=draws, **kw)
        return faulty
    return factory


def _altered_infer(infer):
    def faulty(self, pc, sn):
        kp, sig = infer(self, pc, sn)
        return kp.roll(1, dims=0), sig
    return faulty


def _half_infer(infer):
    def faulty(self, pc, sn):
        h = pc.shape[0] // 2
        kp, sig = infer(self, pc[:h], sn[:h])
        return kp.repeat(2, 1, 1), sig.repeat(2, 1)
    return faulty


def _altered_reply(detect_and_describe):
    def faulty(self, *args, **kwargs):
        kp, desc = detect_and_describe(self, *args, **kwargs)
        return kp, desc[::-1].copy()
    return faulty


FAULTS = {
    "kitti-som.train": [
        ("usip_tpu_torch.train.loop", "make_detector_train_step",
         _frozen_step),
        ("usip_tpu_torch.train.loop", "make_detector_train_step",
         _half_detector_step)],
    "kitti-desc.train": [
        ("usip_tpu_torch.train.descriptor_loop", "make_descriptor_train_step",
         _frozen_step),
        ("usip_tpu_torch.train.descriptor_loop", "make_descriptor_train_step",
         _half_descriptor_step)],
    "kitti-som.detect": [
        ("usip_tpu_torch.inference.KeypointPipeline", "infer",
         _altered_infer),
        ("usip_tpu_torch.inference.KeypointPipeline", "infer", _half_infer)],
    "kitti-desc.serve": [
        ("usip_tpu_torch.inference.KeypointPipeline", "detect_and_describe",
         _altered_reply)],
}


def _target(path):
    import importlib
    try:
        return importlib.import_module(path)
    except ModuleNotFoundError:
        module, _, cls = path.rpartition(".")
        return getattr(importlib.import_module(module), cls)


@pytest.mark.parametrize("cell,fault", [
    (cell, i) for cell, faults in FAULTS.items() for i in range(len(faults))])
def test_planted_fault_turns_correct_false(cell, fault, monkeypatch):
    """The run, past the look for a card, with the timed path broken
    underneath: a step that leaves its state unchanged, half of the batch
    left out, an answer altered where it is produced."""
    path, name, plant = FAULTS[cell][fault]
    target = _target(path)
    monkeypatch.setattr(target, name, plant(getattr(target, name)))
    outcome = harness.run_mix(tiny_context(cell))
    assert not all(c.ok for c in outcome.checks), [
        (c.name, c.value, c.limit) for c in outcome.checks]

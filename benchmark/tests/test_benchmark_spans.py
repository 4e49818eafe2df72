"""The readers of the idle shares by the program's spans
(``benchmark/metrics/idle_in.*``) on hand-made windows: None without a
trace or without a span of the program, 0.0 for a span that held no gap,
and each span's gaps with torch's ``Optimizer.*`` annotations inside it,
over the traced window."""

from __future__ import annotations

import pytest

from benchmark_tiny import ROOT

from benchmark import harness

TRAIN = ("idle_in.wait_batch.train", "idle_in.step_inputs.train",
         "idle_in.step_forward.train", "idle_in.step_losses.train",
         "idle_in.step_backward.train", "idle_in.step_optimizer.train")
DETECT = ("idle_in.nodes.detect", "idle_in.trunk.detect",
          "idle_in.fusion.detect", "idle_in.head.detect")


def window(gaps, window_s=2.0):
    trace = None if gaps is None else {
        "busy_s": window_s - sum(s for _, s in gaps), "window_s": window_s,
        "device_ops": [], "idle_gaps": [list(g) for g in gaps],
        "kernel_s": {}}
    return harness.Window(wall_s=1.0, work=8, spans_s={}, events_ms={},
                          trace=trace)


def read(name, w):
    return harness.metric_reader(name, ROOT)(w)


def test_every_reader_is_an_entry_of_its_cell():
    per_layer = {m["name"]: m for m in harness.spec()["per_layer"]}
    for names, cell, moves in ((TRAIN, "kitti-som.train",
                                "train_clouds_per_s"),
                               (DETECT, "kitti-som.detect",
                                "detect_clouds_per_s")):
        for name in names:
            m = per_layer[name]
            assert m["workloads"] == [cell] and m["moves"] == moves
            assert (m["unit"], m["better"], m["source"]) == (
                "%", "lower", "device_trace")


@pytest.mark.parametrize("name", TRAIN + DETECT)
def test_none_without_the_programs_spans(name):
    """No trace (an untraced or CPU run), or a trace whose gaps carry only
    the benchmark's and torch's labels (a program without spans)."""
    assert read(name, window(None)) is None
    assert read(name, window([("benchmark.train_step", 0.5),
                              ("Optimizer.step#Adam.step", 0.1),
                              ("host: outside the benchmark's spans",
                               0.1)])) is None


def test_train_readers_split_the_step():
    w = window([("usip.step.backward", 0.4), ("usip.step.forward", 0.3),
                ("Optimizer.zero_grad#Adam.zero_grad", 0.02),
                ("usip.step.optimizer", 0.05),
                ("Optimizer.step#Adam.step", 0.03),
                ("usip.engine.wait_batch", 0.01),
                ("benchmark.train_step", 0.04)])
    got = {name: read(name, w) for name in TRAIN}
    assert got == pytest.approx({
        "idle_in.wait_batch.train": 0.5, "idle_in.step_inputs.train": 0.0,
        "idle_in.step_forward.train": 16.0,
        "idle_in.step_losses.train": 0.0,
        "idle_in.step_backward.train": 20.0,
        "idle_in.step_optimizer.train": 4.0})
    assert got["idle_in.step_inputs.train"] == 0.0


def test_detect_readers_split_infer():
    w = window([("usip.infer.trunk", 0.6), ("usip.infer.nodes", 0.2),
                ("usip.infer.fusion", 0.1), ("benchmark.to_host", 0.05),
                ("benchmark.infer", 0.02)], window_s=4.0)
    got = {name: read(name, w) for name in DETECT}
    assert got == pytest.approx({
        "idle_in.nodes.detect": 5.0, "idle_in.trunk.detect": 15.0,
        "idle_in.fusion.detect": 2.5, "idle_in.head.detect": 0.0})


def test_a_cut_list_reads_none_for_the_labels_it_lost():
    """With ``BREAKDOWN_TOP`` labels the list may have been cut: a reader
    whose labels are all missing reads None, not 0.0; one whose labels
    are there reads its share."""
    w = window([(f"usip.step.{p}", 0.1) for p in (
        "inputs", "forward", "losses", "backward")]
        + [("usip.engine.wait_batch", 0.05), ("benchmark.train_step", 0.05),
           ("Optimizer.zero_grad#Adam.zero_grad", 0.02)]
        + [(f"torch.other.{i}", 0.01) for i in range(3)])
    assert len(w.trace["idle_gaps"]) == harness.BREAKDOWN_TOP
    assert read("idle_in.step_optimizer.train", w) is None
    assert read("idle_in.step_forward.train", w) == pytest.approx(6.0)
    assert read("idle_in.wait_batch.train", w) == pytest.approx(2.5)
    # one label fewer: nothing was cut, so a missing span held no gap
    w.trace["idle_gaps"].pop()
    assert read("idle_in.step_optimizer.train", w) == 0.0

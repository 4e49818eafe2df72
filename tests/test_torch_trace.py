"""The port's spans (``utils.logging.span``): nothing but flag reads
while no trace or record is taken, on torch.profiler's timeline while it
runs, nested as the benchmark's breakdown reads them, kept by
``recording()`` in the order they open, and absent from the
``torch.export`` graphs."""

import contextlib
import json

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from usip_tpu_torch.config import get_config
from usip_tpu_torch.data.pipeline import BatchLoader
from usip_tpu_torch.inference import KeypointPipeline
from usip_tpu_torch.models import Detector, fused_infer
from usip_tpu_torch.ops.kernels import fusion_chain_params, prepare_chain
from usip_tpu_torch.train import loop
from usip_tpu_torch.utils.logging import recording, span
from usip_tpu_torch.weights import seeded_state_dict

torch.set_num_threads(1)

TINY = {"data.input_pc_num": 128, "data.node_num": 16, "detector.c1": 16,
        "detector.c2": 32, "detector.node_knn_k": 4,
        "descriptor.descriptor_len": 16, "descriptor.ball_nsamples": 8,
        "train.log_every": 1000}
STEP = ["usip.step." + p for p in ("inputs", "forward", "losses",
                                   "backward", "optimizer")]
INFER = ["usip.infer." + p for p in ("nodes", "trunk", "fusion", "head")]


class _Frames:
    """``n`` siamese items of the tiny width, made from a seed."""

    def __init__(self, n, cfg, seed=0):
        rng = np.random.default_rng(seed)
        shape = (cfg.data.input_pc_num, 3)
        self.items = [{k: rng.normal(size=shape).astype(np.float32)
                       for k in ("src_pc", "src_sn", "dst_pc", "dst_sn")}
                      for _ in range(n)]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _engine(tmp_path, steps=2, batch=4, profile_dir=None):
    cfg = get_config("modelnet", **{**TINY, "train.batch_size": batch,
                                    "train.checkpoint_dir": str(tmp_path)})
    loader = BatchLoader(_Frames(steps * batch, cfg), batch, shuffle=False,
                         num_workers=1)
    return loop.DetectorEngine(cfg, loader, None, device="cpu",
                               profile_dir=profile_dir)


def _torch_weights(sd):
    return {k: torch.tensor(v) for k, v in sd.items()}


def _pipeline():
    cfg = get_config("kitti", **TINY)
    return cfg, KeypointPipeline(
        cfg, _torch_weights(seeded_state_dict(cfg.detector, 0)), "cpu",
        seed=3)


def _clouds(cfg, b=2, seed=0):
    rng = np.random.default_rng(seed)
    n, s = cfg.data.input_pc_num, cfg.detector.surface_normal_len
    return (torch.from_numpy(rng.normal(size=(b, n, 3)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(b, n, s)).astype(np.float32)))


def test_spans_off_call_no_record_function(tmp_path, monkeypatch):
    """With no profiler running, neither an engine epoch nor ``infer``
    enters ``torch.profiler.record_function``, also while ``recording()``
    keeps the spans."""
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: calls.append(a))
    eng = _engine(tmp_path)
    cfg, pipe = _pipeline()
    pc, sn = _clouds(cfg)
    eng.train_epoch(0)
    pipe.infer(pc, sn)
    with recording() as rec:
        pipe.infer(pc, sn)
    assert calls == []
    assert rec.names() == INFER


def _innermost(spans, s, e):
    """The shortest span of ``spans`` ``[(start, end, name)]`` that holds
    ``[s, e]`` and is not it, or None."""
    holders = [(b - a, n) for a, b, n in spans
               if a <= s and e <= b and (b - a) > (e - s)]
    return min(holders)[1] if holders else None


def test_profiler_sees_the_spans_nested(tmp_path):
    """Under a CPU ``torch.profiler.profile``, one engine epoch of two
    steps and one ``infer`` give the ``usip.*`` user annotations in the
    kineto events, each step's five parts once each and in order, none
    inside another."""
    eng = _engine(tmp_path)
    cfg, pipe = _pipeline()
    pc, sn = _clouds(cfg)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.train_epoch(0)
        pipe.infer(pc, sn)
    spans = sorted((e.start_ns(), e.end_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation() and e.name().startswith("usip."))
    names = [n for _, _, n in spans]
    assert [n for n in names if n.startswith("usip.step.")] == STEP * 2
    # two batches and the end of the epoch
    assert names.count("usip.engine.wait_batch") == 3
    assert [n for n in names if n.startswith("usip.infer.")] == INFER
    for s, e, n in spans:
        assert _innermost(spans, s, e) is None, n


def test_profiled_step_trace_carries_the_step_spans(tmp_path):
    """The engine's ``--profile-dir`` chrome trace of step 10 holds the
    step's five spans, once each and in order, with the step count as
    their identifier."""
    eng = _engine(tmp_path, steps=11, batch=2, profile_dir=str(tmp_path))
    eng.train_epoch(0)
    with open(tmp_path / "train_step_10.json") as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["name"], e.get("args", {}))
                   for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("usip."))
    assert [n for _, n, _ in spans] == STEP


def test_recording_keeps_the_spans_of_its_block():
    """``recording()`` keeps the names of the spans opened inside its
    block, nested ones too, in the order they open, with no CUDA events
    while CUDA is not initialised; a span after the block is not kept."""
    with recording() as rec:
        with span("usip.a", 7):
            with span("usip.b"):
                pass
        with span("usip.c"):
            pass
    with span("usip.d"):
        pass
    assert rec.names() == ["usip.a", "usip.b", "usip.c"]
    assert rec.device_ms() == {}


def test_export_graph_is_the_same_with_spans(monkeypatch):
    """A ``torch.export`` of ``detector_infer_fused`` with its spans equals
    the one with the spans taken out, also when it is exported under the
    profiler and ``recording()``."""
    cfg = get_config("kitti", **TINY)
    det = Detector(cfg.detector)
    det.load_state_dict(_torch_weights(seeded_state_dict(cfg.detector, 0)))
    det.eval()
    chain = prepare_chain(*fusion_chain_params(det.knnlayer_1))
    pc, sn = _clouds(cfg)
    node = pc[:, :cfg.data.node_num].contiguous()

    class Program(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.det = det

        def forward(self, pc, sn, node):
            return fused_infer.detector_infer_fused(self.det, pc, sn, node,
                                                    chain)

    def graph():
        with torch.no_grad():
            return torch.export.export(Program(),
                                       (pc, sn, node)).graph_module.code

    with_spans = graph()
    with profile(activities=[ProfilerActivity.CPU]), recording() as rec:
        traced = graph()
    assert rec.names() == []
    monkeypatch.setattr(fused_infer, "span",
                        lambda name, args=None: contextlib.nullcontext())
    assert graph() == with_spans == traced
    assert "usip.fusion_chain" in with_spans

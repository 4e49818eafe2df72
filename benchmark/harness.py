"""What every cell's run shares: finding the cell's files, the device and
its limits, the set-up's split, spans and CUDA events around the program's
calls, the traced window and its reduction to device busy time, kernel time
and idle gaps, the per-layer readers, the result line, and the check that
no JAX module was loaded.

The driver of a traffic kind (``benchmark/mixes/<kind>.py``) has one
function, ``run(ctx) -> Outcome``: it sets up through ``ctx.phase``,
measures its window between ``ctx.window_start()`` and
``ctx.window_stop()``, reads ``ctx.read_memory()`` and then checks its
outputs against the reference.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the top-level module names that no run may load: JAX, its libraries and
# the JAX package this port was made from (compared whole: the port's own
# name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "usip_tpu")
# the traced run keeps the profiler on for this much of its window: enough
# for hundreds of steps or batches, small enough to reduce in seconds
TRACE_SECONDS = 3.0
# the breakdown's lists hold at most this many entries
BREAKDOWN_TOP = 10


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def spec(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json; cells: "
                     + ", ".join(c["name"] for c in bench["workloads"]))


def config_file(bench: dict, name: str, root: str = ROOT) -> dict:
    for cfg in bench["configs"]:
        if cfg["name"] == name:
            return load_json(os.path.join(root, cfg["file"]))
    raise SystemExit(f"no config {name!r} in BENCHMARK.json")


def traffic_file(name: str, root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "benchmark", "traffic",
                                  name + ".json"))


def limits_file(cell: str, root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "benchmark", "limits",
                                  cell + ".json"))


def load_module(path: str, name: str):
    """A module of the benchmark loaded from its file (names hold dots)."""
    spec_ = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def mix_module(kind: str, root: str = ROOT):
    return load_module(os.path.join(root, "benchmark", "mixes", kind + ".py"),
                       f"benchmark_mix_{kind}")


def metric_reader(name: str, root: str = ROOT) -> Callable:
    return load_module(os.path.join(root, "benchmark", "metrics",
                                    name + ".py"),
                       "benchmark_metric_" + name.replace(".", "_")).read


def cell_metrics(bench: dict, cell: str, section: str) -> List[dict]:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those listing it, and those with no list."""
    return [m for m in bench[section]
            if cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def cache_dirs(root: str = ROOT) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's nvcc and g++ libraries go to ``build/usip_tpu_torch``)."""
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(build, "inductor")


def scratch_dir(cell: str) -> str:
    """The run's data directory under ``TMPDIR`` (fixed per cell)."""
    base = os.environ.get("TMPDIR") or "/tmp"
    path = os.path.join(base, "usip-benchmark", cell)
    os.makedirs(path, exist_ok=True)
    return path


def gpu_facts() -> Dict[str, str]:
    """The card's name, power limit, clocks and draw from nvidia-smi
    (empty where it cannot be read)."""
    q = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return {}
    lines = out.splitlines()
    if not lines:
        return {}
    return dict(zip(q.split(","), (v.strip() for v in lines[0].split(","))))


@dataclasses.dataclass
class Check:
    """One number compared with its limit: correct while ``value <=
    limit``."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a mix's run hands back: the work attempted and failed, its
    end-to-end numbers by metric name, and its checks."""
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: List[Check]


class Recorder:
    """Host-clock spans and CUDA-event spans of the calls the benchmark
    wraps, kept in memory; a span is recorded only while ``on``."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.on = False
        self.traced = False
        self.host: Dict[str, List[float]] = {}
        self._events: Dict[str, list] = {}

    @contextlib.contextmanager
    def host_span(self, name: str):
        """A host-clock span while ``on``; a span of the trace while the
        profiler runs (``traced``)."""
        if self.traced:
            import torch
            with torch.profiler.record_function(name):
                yield
            return
        if not self.on:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.host.setdefault(name, []).append(time.perf_counter() - t0)

    @contextlib.contextmanager
    def device_span(self, name: str):
        if not (self.on and self.cuda):
            yield
            return
        import torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            self._events.setdefault(name, []).append((start, end))

    def device_ms(self) -> Dict[str, List[float]]:
        """Each CUDA-event span's milliseconds (synchronises)."""
        if not self._events:
            return {}
        import torch
        torch.cuda.synchronize()
        return {k: [s.elapsed_time(e) for s, e in v]
                for k, v in self._events.items()}


@dataclasses.dataclass
class Window:
    """The measured window as the per-layer readers see it.

    ``wall_s`` and ``work`` (the cell's units of work completed: clouds,
    requests) are of the part measured untraced (the whole window in an
    untraced run); ``spans_s`` and ``events_ms`` too. ``trace`` is the
    reduction of the traced part (None untraced, or on the CPU), with its
    own ``work``; ``flops_per_work`` the model FLOPs a unit of work;
    ``bounds`` kernel name -> ``(least ms a launch, launches in the traced
    part)``."""
    wall_s: float
    work: int
    spans_s: Dict[str, List[float]]
    events_ms: Dict[str, List[float]]
    flops_per_work: float = 0.0
    trace: Optional[dict] = None
    bounds: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    extra: Dict[str, float] = dataclasses.field(default_factory=dict)


def _union(intervals):
    """Merge ``[(start, end)]`` (sorted by start) into disjoint
    intervals."""
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_trace(prof, window_name: str) -> dict:
    """The device's busy time, its time by operation, and its idle gaps
    by what the host was doing, inside the user span ``window_name`` of a
    torch.profiler trace (kineto's events: kernels, copies and sets on the
    device, operators and the benchmark's spans on the host)."""
    events = prof.profiler.kineto_results.events()
    # the host's spans are mirrored on the device's timeline as annotations
    # of the same names: they are no device work
    annotations = {e.name() for e in events
                   if e.device_type().name != "CUDA"
                   and e.is_user_annotation()}
    window = None
    device, host = [], []
    for e in events:
        if e.device_type().name == "CUDA":
            annotation = e.is_user_annotation() or e.name() in annotations
            if e.duration_ns() > 0 and not annotation:
                device.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.name() == window_name and e.is_user_annotation():
            window = (e.start_ns(), e.end_ns())
        else:
            host.append((e.start_ns(), e.end_ns(), e.name(),
                         e.is_user_annotation()))
    if window is None:
        raise RuntimeError(f"the trace holds no span {window_name!r}")
    w0, w1 = window
    device = [(max(s, w0), min(e, w1), n) for s, e, n in device
              if e > w0 and s < w1]
    device.sort()
    by_op: Dict[str, float] = {}
    for s, e, n in device:
        by_op[n] = by_op.get(n, 0.0) + (e - s) * 1e-9
    busy = _union([(s, e) for s, e, _ in device])
    busy_s = sum(e - s for s, e in busy) * 1e-9
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    spans = sorted((s, e, n) for s, e, n, user in host if user)
    starts = [s for s, _, _ in spans]
    by_gap: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) // 2
        label = "host: outside the benchmark's spans"
        # the innermost benchmark span holding the gap's middle: the latest
        # start among the few spans that begin before it
        i = bisect.bisect_right(starts, mid) - 1
        for s, e, n in reversed(spans[max(i - 8, 0):i + 1]):
            if e >= mid:
                label = n
                break
        by_gap[label] = by_gap.get(label, 0.0) + (b - a) * 1e-9
    top = lambda d: sorted(([k[:160], v] for k, v in d.items()),  # noqa: E731
                           key=lambda kv: -kv[1])[:BREAKDOWN_TOP]
    return {"busy_s": busy_s, "window_s": (w1 - w0) * 1e-9,
            "device_ops": top(by_op), "idle_gaps": top(by_gap),
            "kernel_s": by_op}


class RunContext:
    """One run: its arguments, the cell's files, the device, the set-up's
    split and the window's records."""

    def __init__(self, args, process_start: float, device: str = "cuda",
                 config: Optional[dict] = None,
                 traffic: Optional[dict] = None,
                 limits: Optional[dict] = None, root: str = ROOT,
                 bench: Optional[dict] = None):
        self.args = args
        self.root = root
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(args.trace)
        self.device = device
        self.cuda = device == "cuda"
        self.bench = bench or spec(root)
        self.cell = find_cell(self.bench, args.workload)
        self.config = config or config_file(self.bench, self.cell["config"],
                                            root)
        self.traffic = traffic or traffic_file(self.cell["traffic"], root)
        self.limits = limits or limits_file(self.cell["name"], root)
        self.process_start = process_start
        self.setup_split: Dict[str, float] = {}
        self.rec = Recorder(self.cuda)
        self.window: Optional[Window] = None
        self.memory_peak = 0
        self._phase_t = process_start
        self._prof = None
        self._t_window = None
        self.setup_s = None

    # -- set-up ------------------------------------------------------------
    def phase(self, name: str) -> None:
        """Close the set-up part running since the last call (or process
        start) under ``name``."""
        now = time.perf_counter()
        self.setup_split[name] = self.setup_split.get(name, 0.0) + (
            now - self._phase_t)
        self._phase_t = now

    def sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize()

    # -- the window --------------------------------------------------------
    def window_start(self) -> float:
        """End set-up, start the window (and, in a traced run, the
        profiler); returns the window's start on the host clock."""
        self.sync()
        self.phase("warmup")
        now = time.perf_counter()
        self.setup_s = now - self.process_start
        if self.trace and self.cuda:
            from torch.profiler import ProfilerActivity, profile
            import torch
            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._window_span = torch.profiler.record_function(
                "benchmark.window")
            self._window_span.__enter__()
        self.rec.on = self.trace and self._prof is None
        self.rec.traced = self._prof is not None
        self._t_window = time.perf_counter()
        return self._t_window

    def tracing(self) -> bool:
        return self._prof is not None

    def trace_due(self, now: float) -> bool:
        """Whether the traced part of the window is over."""
        return self._prof is not None and (
            now - self._t_window >= min(TRACE_SECONDS, self.seconds))

    def stop_trace(self, work: int) -> None:
        """End the traced part (after the device finishes its work) and
        start the untraced rest, whose spans the recorder keeps."""
        self.sync()
        self._window_span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self._traced_work = work
        self._traced_wall = time.perf_counter() - self._t_window
        self._trace = reduce_trace(self._prof, "benchmark.window")
        self._trace["work"] = work
        self._prof = None
        self.rec.traced = False
        self.rec.on = True
        self._t_rest = time.perf_counter()
        self._work_rest = work

    def mark_end(self) -> None:
        """The window ends now, once the device finishes what was queued:
        later host work (a loader shutting down) is outside it."""
        self.sync()
        self._t_end = time.perf_counter()

    def window_stop(self, work: int, flops_per_work: float = 0.0,
                    bounds: Optional[Dict[str, tuple]] = None,
                    extra: Optional[Dict[str, float]] = None) -> Window:
        """End the window after the device finishes: ``work`` units done
        in it."""
        self.sync()
        if self._prof is not None:
            self.stop_trace(work)
        end = getattr(self, "_t_end", None) or time.perf_counter()
        trace = getattr(self, "_trace", None)
        if trace is not None and end - self._t_rest > 0.5:
            wall, done = end - self._t_rest, work - self._work_rest
        elif trace is not None:
            wall, done = self._traced_wall, self._traced_work
        else:
            wall, done = end - self._t_window, work
        self.rec.on = False
        self.window = Window(wall_s=wall, work=done,
                             spans_s=dict(self.rec.host),
                             events_ms=self.rec.device_ms(),
                             flops_per_work=flops_per_work, trace=trace,
                             bounds=bounds or {}, extra=extra or {})
        self.full_window_s = end - self._t_window
        self.full_work = work
        return self.window

    def read_memory(self) -> None:
        if self.cuda:
            import torch
            self.memory_peak = int(torch.cuda.max_memory_allocated())


def device_block(ctx: RunContext) -> dict:
    if not ctx.cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    import torch
    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": int(ctx.cell["chips"]),
           "memory_peak_bytes": ctx.memory_peak}
    trace = ctx.window.trace if ctx.window else None
    if ctx.trace and trace is not None:
        out["busy_s"] = trace["busy_s"]
        out["window_s"] = trace["window_s"]
    return out


def result_line(ctx: RunContext, outcome: Outcome) -> dict:
    """The run's last line: correct, attempted, failed, metrics, device,
    the breakdown of a traced run, and each compared number with its
    limit (last)."""
    metrics = {}
    if not ctx.cuda:
        pass  # a CPU run (the tests') reports no metric: none is the card's
    elif not ctx.trace:
        for m in cell_metrics(ctx.bench, ctx.cell["name"], "end_to_end"):
            value = (ctx.setup_s if m["name"] == "setup_s"
                     else outcome.end_to_end.get(m["name"]))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    elif ctx.window is not None:
        for m in cell_metrics(ctx.bench, ctx.cell["name"], "per_layer"):
            value = metric_reader(m["name"], ctx.root)(ctx.window)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": all(c.ok for c in outcome.checks)
            and bool(outcome.checks),
            "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device_block(ctx)}
    trace = ctx.window.trace if ctx.window else None
    if ctx.trace and trace is not None:
        line["breakdown"] = {"device_ops": trace["device_ops"],
                             "idle_gaps": trace["idle_gaps"]}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in outcome.checks}
    return line


def emit(ctx: RunContext, outcome: Outcome) -> int:
    """Print the earlier lines, the checks on standard error, and the
    result line last; 0, or 3 where a forbidden module was loaded."""
    line = result_line(ctx, outcome)
    print("setup_split " + json.dumps(
        {k: round(v, 4) for k, v in ctx.setup_split.items()}), flush=True)
    if ctx.window is not None:
        print("window " + json.dumps(
            {"seconds": ctx.full_window_s, "work": ctx.full_work,
             "measured_wall_s": ctx.window.wall_s,
             "measured_work": ctx.window.work, **ctx.window.extra}),
            flush=True)
    bad = forbidden_modules()
    if bad:
        print("refused: the run loaded " + ", ".join(bad), file=sys.stderr,
              flush=True)
        return 3
    for c in outcome.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


def run_cell(args, process_start: float) -> int:
    """The driver's entry: a run of one cell on the card."""
    cache_dirs()
    import torch
    if not torch.cuda.is_available():
        print("refused: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    bench = spec()
    cell = find_cell(bench, args.workload)
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"refused: {torch.cuda.device_count()} devices, the cell "
              f"asks for {cell['chips']}", file=sys.stderr)
        return 2
    ctx = RunContext(args, process_start)
    ctx.phase("python_imports")
    torch.cuda.init()
    torch.zeros(1, device="cuda")
    ctx.phase("cuda_context")
    facts = gpu_facts()
    print("card " + json.dumps(facts), flush=True)
    return emit(ctx, run_mix(ctx))


def run_mix(ctx: RunContext) -> Outcome:
    """The cell's run by the driver of its traffic's kind."""
    return mix_module(ctx.traffic["kind"], ctx.root).run(ctx)

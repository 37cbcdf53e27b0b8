"""The port's tracing (tracing.py) in the training loop: spans recorded only
while a profiler records, the spans of one epoch with their parents, steps
and atom buckets, the host clock shared with the profiler's events, the
epoch's counters against the samples and ``bucket_size`` (and the
transformer layers' FFN rows), the same losses
with tracing on and off, nothing recorded, kept or synchronised with it
off, and the CLI's trace with the spans in it. On the card (marker
``cuda``): every span's device interval present and positive, the phases
and the loop's idle tiling the epoch, and no event recorded while a stream
captures a graph.

Small size on the CPU: hidden 16, 1 processor, 1 transformer layer a
stack, 17 bins, 20 crystals of 4-40 atoms at batch 4, so each atom bucket
8-64 ends in a batch padded with dummy graphs."""

import json
import math
import tracemalloc

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import (  # noqa: E402
    ProfilerActivity,
    profile,
    record_function,
)

from dostransformer_tpu_torch import tracing  # noqa: E402
from dostransformer_tpu_torch.cli import main_edos  # noqa: E402
from dostransformer_tpu_torch.data.datasets import GraphLoader  # noqa: E402
from dostransformer_tpu_torch.data.graph import bucket_size  # noqa: E402
from dostransformer_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_edos_samples,
)
from dostransformer_tpu_torch.models.dostransformer import (  # noqa: E402
    DOSTransformerEDOS,
)
from dostransformer_tpu_torch.models.registry import build_model  # noqa: E402
from dostransformer_tpu_torch.train.device_dataset import (  # noqa: E402
    BucketedDeviceDataset,
    DeviceDataset,
)
from dostransformer_tpu_torch.train.trainer import Trainer  # noqa: E402

PHASES = ["step.input", "step.forward", "step.backward", "step.optimizer"]
NAMES = {"train.epoch", "train.step", *PHASES}
BATCH, BINS = 4, 17


def _samples():
    return synthetic_edos_samples(20, seed=1, max_atoms=40, n_bins=BINS)


def _trainer(device="cpu"):
    model = build_model("edos", "DOSTransformer", layers=1, t_layers=1,
                        hidden=16, n_bins=BINS, node_in=200, edge_in=41,
                        glob_in=2, device=device,
                        generator=torch.Generator().manual_seed(0))
    return Trainer(model, seed=0)


def _epoch(trainer, kind, samples, epoch, device="cpu"):
    """One epoch of ``kind``: bucketed or flat device data, or a host
    loader; the step losses."""
    if kind == "buckets":
        data = BucketedDeviceDataset.from_samples(samples, BATCH,
                                                  device=device)
        return trainer.train_epoch_buckets(data, 0, epoch)
    if kind == "device":
        data = DeviceDataset.from_samples(samples, BATCH, device=device)
        return trainer.train_epoch_device(data, 0, epoch)
    return trainer.train_epoch(GraphLoader(samples, BATCH), epoch)


def _profiled(fn, activities=(ProfilerActivity.CPU,)):
    """``fn`` under a profiler, in a record of its own (a window that follows
    another with no span outside a profiler between them adds to it)."""
    tracing.record().clear()
    with profile(activities=list(activities)) as prof:
        out = fn()
    return prof, out


def _expected_steps(samples, kind):
    """[(atom bucket, real graphs, real atom rows)] of each step, in the
    order the epoch takes its buckets."""
    if kind == "buckets":
        groups = {}
        for s in samples:
            groups.setdefault(bucket_size(s.n_nodes), []).append(s)
    else:
        groups = {bucket_size(max(s.n_nodes for s in samples)): samples}
    return {a: g for a, g in sorted(groups.items())}


def test_spans_are_recorded_only_under_the_profiler():
    trainer, samples = _trainer(), _samples()
    tracing.record().clear()
    _epoch(trainer, "buckets", samples, 0)
    assert tracing.record().spans == []  # off: nothing recorded
    with profile(activities=[ProfilerActivity.CPU]):
        _epoch(trainer, "buckets", samples, 1)
    first = list(tracing.record().spans)
    assert first and {s.name for s in first} == NAMES
    _epoch(trainer, "buckets", samples, 2)  # off again: the record stays
    assert tracing.record().spans == first
    with profile(activities=[ProfilerActivity.CPU]):
        _epoch(trainer, "buckets", samples, 3)
    again = tracing.record().spans  # cleared: the latest window alone
    assert len(again) == len(first)
    assert {s.step[0] for s in again if s.step} == {3}


@pytest.mark.parametrize("kind", ["buckets", "device", "host"])
def test_one_epoch_gives_the_spans_of_the_table(kind):
    """An epoch span, then each step with its four phases: parents, step
    identifiers (epoch, step) and atom buckets as the data give them, and
    phases that tile their step at five shared boundaries."""
    trainer, samples = _trainer(), _samples()
    _profiled(lambda: _epoch(trainer, kind, samples, 5))
    spans = tracing.record().spans
    assert spans[0].name == "train.epoch" and spans[0].parent is None
    assert spans[0].attrs == {"epoch": 5} and spans[0].step is None
    buckets = [a for a, g in _expected_steps(samples, kind).items()
               for _ in range(math.ceil(len(g) / BATCH))]
    rest = spans[1:]
    assert len(rest) == 5 * len(buckets)
    for i, bucket in enumerate(buckets):
        step, *phases = rest[5 * i:5 * i + 5]
        index = spans.index(step)
        assert (step.name, step.parent, step.step, step.attrs) == (
            "train.step", 0, (5, i), {"bucket": bucket})
        assert [p.name for p in phases] == PHASES
        assert all(p.parent == index and p.step == (5, i) for p in phases)
        assert phases[0].start is step.start and phases[-1].end is step.end
        for a, b in zip(phases, phases[1:]):
            assert a.end is b.start
        assert step.start.host_ns < step.end.host_ns
    assert all(s.end is not None for s in spans)


def test_forward_span_holds_its_forward_events_on_the_profiler_clock(
        monkeypatch):
    """Each step.forward's host interval, on the clock of ``time.time_ns``,
    contains its forward's profiler events (the model's call and every
    aten:: op inside it), placed by ``trace_start_ns()``; the forward ends
    before the step's backward begins. No span is a profiler event."""
    forward = DOSTransformerEDOS.forward

    def marked(self, *args, **kwargs):
        with record_function("test.forward"):
            return forward(self, *args, **kwargs)

    monkeypatch.setattr(DOSTransformerEDOS, "forward", marked)
    trainer, samples = _trainer(), _samples()
    prof, _ = _profiled(lambda: _epoch(trainer, "buckets", samples, 0))
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    events = prof.events()
    assert not {e.name for e in events} & NAMES
    marks = sorted((e for e in events if e.name == "test.forward"),
                   key=lambda e: e.time_range.start)
    ops = [e for e in events if e.name.startswith("aten::")]
    spans = tracing.record().spans
    fwd = [s for s in spans if s.name == "step.forward"]
    bwd = [s for s in spans if s.name == "step.backward"]
    assert len(marks) == len(fwd) > 0

    def us(ns):  # a host time stamp on the profiler's time base
        return (ns - start_ns) / 1e3

    for mark, f, b in zip(marks, fwd, bwd):
        lo, hi = mark.time_range.start, mark.time_range.end
        inside = [e for e in ops
                  if lo <= e.time_range.start and e.time_range.end <= hi]
        assert inside
        assert us(f.start.host_ns) <= lo and hi <= us(f.end.host_ns)
        assert all(us(f.start.host_ns) <= e.time_range.start
                   and e.time_range.end <= us(f.end.host_ns)
                   for e in inside)
        assert hi <= us(b.start.host_ns)


def linear_rows(b, atoms, edges, bins, layers=1, t_layers=1):
    """The rows of every linear of one eDOS forward at b graph slots of
    ``atoms`` node and ``edges`` edge slots, where no FFN call takes #8:
    the node and edge encoders (two layers each, at node and edge count),
    the global encoder and decoder (b rows each, three layers), each
    processor's edge projections (two at node count, one at edge count) and
    node MLP (three at node count), the heads' fc and fc_prompt (b bins
    each) and out_layer (2b bins), and the FFN's fc1 and fc2 in the cross
    stack (b bins) and the self and source stacks (2b bins)."""
    return b * (atoms * (2 + 5 * layers) + edges * (2 + layers) + 3
                + bins * (4 + 10 * t_layers))


def layer_norm_rows(b, atoms, bins, layers=1, t_layers=1):
    """The rows of every default LayerNorm of one eDOS forward at b graph
    slots of ``atoms`` node slots: each processor's node MLP (node count),
    per layer ln0 on the keys (the cross stack's atoms, the source stack's
    twice as many) and, in bins rows a slot, ln0 on the queries and ln1 in
    the cross stack, ln0 on keys and queries and ln1 in the self stack and
    ln0 and ln1 in the source stack (the heads' stacks at 2b slots), and
    each stack's final LayerNorm."""
    return b * ((layers + 3 * t_layers) * atoms
                + bins * (12 * t_layers + 5))


@pytest.mark.parametrize("kind", ["buckets", "device", "host"])
def test_counters_are_the_counts_of_the_samples(kind):
    trainer, samples = _trainer(), _samples()
    shapes = []
    trainer.model.register_forward_pre_hook(
        lambda m, args: shapes.append((*args[0].nodes.shape[:2],
                                       args[0].edges.shape[1])))
    _profiled(lambda: _epoch(trainer, kind, samples, 0))
    want = dict.fromkeys(["train.steps", "train.graphs",
                          "train.graph_slots", "train.atom_rows",
                          "train.atom_slots"], 0)
    for bucket, group in _expected_steps(samples, kind).items():
        steps = math.ceil(len(group) / BATCH)
        want["train.steps"] += steps
        want["train.graphs"] += len(group)
        want["train.graph_slots"] += steps * BATCH
        want["train.atom_rows"] += sum(s.n_nodes for s in group)
        want["train.atom_slots"] += steps * BATCH * bucket
    # the layers' FFN rows: a graph slot's bins rows through the cross
    # stack and, twice, through each head's stack (one layer a stack); on
    # the CPU none takes kernel #8, so ffn.kernel_rows stays unset
    want["ffn.rows"] = want["train.graph_slots"] * BINS * 5
    # every linear's rows, at each step's node and edge slots; on the CPU
    # none takes kernel #9, so linear.kernel_rows stays unset
    assert len(shapes) == want["train.steps"]
    want["linear.rows"] = sum(linear_rows(b, a, e, BINS)
                              for b, a, e in shapes)
    # every LayerNorm's rows; on the CPU none takes the kernels, so
    # layer_norm.kernel_rows stays unset
    want["layer_norm.rows"] = sum(layer_norm_rows(b, a, BINS)
                                  for b, a, _ in shapes)
    want["train.steps_replayed"] = 0  # the CPU replays no step
    assert tracing.record().counters == want
    assert want["train.atom_rows"] < want["train.atom_slots"]


@pytest.mark.parametrize("kind", ["buckets", "device", "host"])
def test_replayed_share_reads_zero_for_eager_epochs(kind):
    """The benchmark's reader of the replayed steps' share over a traced
    epoch of eager steps (the CPU's) reads 0, not nothing: a program that
    falls back to the eager step shows there. Without the counter (a
    program that keeps none) it reads nothing."""
    import importlib.util
    import pathlib

    path = (pathlib.Path(__file__).resolve().parents[1] / "perfbench"
            / "metrics" / "replayed_steps_pct.train.py")
    spec = importlib.util.spec_from_file_location("replayed_steps_pct",
                                                  path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    trainer, samples = _trainer(), _samples()
    _profiled(lambda: _epoch(trainer, kind, samples, 0))
    assert reader.read(None) == 0.0
    del tracing.record().counters["train.steps_replayed"]
    assert reader.read(None) is None


def test_losses_and_weights_are_bit_equal_with_tracing_on_and_off():
    samples = _samples()
    off, on = _trainer(), _trainer()
    losses_off = [_epoch(off, "buckets", samples, e) for e in range(2)]
    losses_on = [_profiled(lambda e=e: _epoch(on, "buckets", samples, e))[1]
                 for e in range(2)]
    for a, b in zip(losses_off, losses_on):
        assert torch.equal(a, b)
    for a, b in zip(off.model.parameters(), on.model.parameters()):
        assert torch.equal(a, b)


def test_off_a_span_records_keeps_and_syncs_nothing(monkeypatch):
    """With no profiler recording, a span is the one shared no-op context
    and a phase returns at once: the record does not change, no event is
    made or synchronised, and 10,000 spans leave no memory behind."""
    assert not torch.autograd.profiler._is_profiler_enabled

    def refused(*args, **kwargs):
        raise AssertionError("tracing off touched the card")

    monkeypatch.setattr(torch.cuda, "synchronize", refused)
    monkeypatch.setattr(torch.cuda, "Event", refused)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", refused)
    rec = tracing.record()
    spans, counters = list(rec.spans), dict(rec.counters)
    assert tracing.span("a") is tracing.span("b", step=(0, 1), bucket=8)
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        for i in range(10_000):
            with tracing.span("train.step", step=(0, i), device="cuda",
                              bucket=8):
                tracing.phase("step.input")
                tracing.phase("step.forward")
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # the loop's last int is all that stays; a call's keywords come and go
    assert after - before < 256 and peak - before < 1024
    assert rec.spans == spans and rec.counters == counters


def test_profile_dir_trace_holds_the_spans_and_counters(tmp_path,
                                                        monkeypatch):
    """main_edos --profile_dir: trace.json holds the spans as complete
    events on a row of their own, and the counters; each step.forward
    event encloses its forward's events, on the trace's own time base."""
    forward = DOSTransformerEDOS.forward

    def marked(self, *args, **kwargs):
        with record_function("test.forward"):
            return forward(self, *args, **kwargs)

    monkeypatch.setattr(DOSTransformerEDOS, "forward", marked)
    main_edos.main([
        "--synthetic", "24", "--epochs", "1", "--eval", "1", "--hidden",
        "16", "--layers", "1", "--transformer", "1", "--batch_size",
        str(BATCH), "--device", "cpu", "--results_dir", str(tmp_path),
        "--bucketed", "--profile_dir", str(tmp_path / "prof")])
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    mine = [e for e in events if e.get("cat") == "program"]
    assert {e["name"] for e in mine} == NAMES
    assert all(e["ph"] == "X" for e in mine)
    assert len({(e["pid"], e["tid"]) for e in mine}) == 1
    row = (mine[0]["pid"], mine[0]["tid"])
    assert not any((e.get("pid"), e.get("tid")) == row for e in events
                   if e.get("cat") not in ("program", None))
    (counters,) = [e for e in events if e.get("name") == "train counters"]
    assert counters["ph"] == "C"
    assert counters["args"]["train.graphs"] > 0
    assert (counters["args"]["train.atom_rows"]
            < counters["args"]["train.atom_slots"])
    fwd = sorted((e for e in mine if e["name"] == "step.forward"),
                 key=lambda e: e["ts"])
    marks = sorted((e for e in events if e.get("name") == "test.forward"
                    and e.get("ph") == "X"), key=lambda e: e["ts"])
    # the steps' forwards come first, the evaluation's after them
    assert len(marks) > len(fwd) > 0
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("name", "").startswith("aten::")]
    for f, m in zip(fwd, marks):
        lo, hi = m["ts"], m["ts"] + m["dur"]
        assert f["ts"] <= lo and hi <= f["ts"] + f["dur"]
        inside = [e for e in ops if lo <= e["ts"]
                  and e["ts"] + e["dur"] <= hi and e["tid"] == m["tid"]]
        assert inside and all(f["ts"] <= e["ts"] and e["ts"] + e["dur"]
                              <= f["ts"] + f["dur"] for e in inside)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_times_are_present_positive_and_tile_the_epoch(card,
                                                              monkeypatch):
    """A traced epoch of replayed steps on the card: no synchronise (of the
    card, a stream or an event: ATen's sync check set to raise) and no
    event read inside it, every step a replay and no capture; afterwards
    every span's device interval, and the phases and the loop's idle tile
    the steps."""
    trainer, samples = _trainer(card), _samples()
    assert trainer.replays
    data = BucketedDeviceDataset.from_samples(samples, BATCH, device=card)
    trainer.train_epoch_buckets(data, 0, 0)  # builds, warms and captures

    def refused(*args, **kwargs):
        raise AssertionError("tracing waited for the card")

    def epoch():
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "synchronize", refused)
            for name in ("synchronize", "query", "elapsed_time"):
                m.setattr(torch.cuda.Event, name, refused)
            torch.cuda.set_sync_debug_mode("error")
            try:
                return trainer.train_epoch_buckets(data, 0, 1)
            finally:
                torch.cuda.set_sync_debug_mode("default")

    _profiled(epoch, (ProfilerActivity.CPU, ProfilerActivity.CUDA))
    torch.cuda.synchronize()
    rec = tracing.record()
    assert rec.counters["train.steps_replayed"] == rec.counters["train.steps"]
    assert "train.captures" not in rec.counters
    intervals = [rec.device_interval(s) for s in rec.spans]
    assert all(i is not None and i[1] > i[0] for i in intervals)
    assert all(s.start.event is not None for s in rec.spans)
    steps = [(rec.device_interval(s), s) for s in rec.spans
             if s.name == "train.step"]
    phases = sum(b - a for (a, b), s in
                 ((rec.device_interval(s), s) for s in rec.spans)
                 if s.name in PHASES)
    idle = sum(b[0][0] - a[0][1] for a, b in zip(steps, steps[1:]))
    assert idle >= 0
    first, last = steps[0][0][0], steps[-1][0][1]
    assert phases + idle == pytest.approx(last - first, rel=1e-6)


@pytest.mark.cuda
def test_no_event_is_recorded_while_a_stream_captures(card):
    x = torch.zeros(64, device=card)
    graph = torch.cuda.CUDAGraph()
    tracing.record().clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("outer", device=card):
            x.add_(1)
            with torch.cuda.graph(graph):
                with tracing.span("captured"):
                    tracing.phase("a")
                    x.add_(1)
                    tracing.phase("b")
                    x.mul_(2)
            x.add_(1)
    torch.cuda.synchronize()
    rec = tracing.record()
    outer, captured, a, b = rec.spans
    assert outer.start.event is not None and outer.end.event is not None
    assert rec.device_interval(outer)[1] > rec.device_interval(outer)[0]
    for s in (captured, a, b):
        assert s.start.event is None and s.end.event is None
        assert rec.device_interval(s) is None
    graph.replay()
    torch.cuda.synchronize()
    assert float(x[0]) == ((1 + 1) + 1) * 2  # the capture ran nothing

"""The port's span recorder (``utils/profiling.span``), its spans in the train step and predict
call, and the benchmark's reading of them (``portbench/program_spans.py``), on the CPU.

The step cases run unet_plain at 64^2, batch 2: the recorder is off without a
profiler, and under one records each phase once a step, in order, inside
``step.train``. The reader's arithmetic runs on a hand-made chrome trace.
"""

import threading

import numpy as np
import pytest
import torch

from portbench import counts, program_spans
from portbench.trace import Trace
from unet_embroidery_seg_torch import predict as port_predict
from unet_embroidery_seg_torch.engine import steps
from unet_embroidery_seg_torch.models import build_model
from unet_embroidery_seg_torch.ops import schedules
from unet_embroidery_seg_torch.utils import profiling

SIZE, BATCH = 64, 2
PHASES = ["step.forward", "step.loss", "step.backward", "step.optimizer"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs, restored after: the suite's parallel
    workers would otherwise oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


@pytest.fixture(scope="module")
def plain():
    """unet_plain with the binary steps' diff head and with two logits, and one batch."""
    torch.manual_seed(0)
    models = {"diff": build_model("unet_plain", 2, diff_head=True, device="cpu"),
              "two": build_model("unet_plain", 2, device="cpu")}
    rng = np.random.default_rng(0)
    images = rng.random((BATCH, SIZE, SIZE, 3), dtype=np.float32)
    pngs = (rng.random((BATCH, SIZE, SIZE)) > 0.7).astype(np.int64)
    return models, images, pngs, np.ones(BATCH, np.float32)


def _step(models, loss):
    model = models["two" if loss == "ce" else "diff"]
    opt = schedules.make_train_optimizer(model.parameters(), 1e-4)
    if loss == "ce":
        return steps.make_multiclass_train_step(model, opt, 2, amp=False)
    return steps.make_binary_train_step(model, opt, loss, 3.0, amp=False)


def _cpu_profiler():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_span_without_a_profiler_is_one_shared_no_op(plain):
    models, images, pngs, sm = plain
    assert profiling.span("step.train") is profiling.span("op.conv3x3")
    with profiling.span("a"), profiling.span("b"):
        pass
    _step(models, "bce")(images, pngs, sm)
    assert profiling.spans() == []


@pytest.mark.parametrize("loss", ["bce", "ce"])
def test_train_step_records_its_phases_in_order_inside_step_train(plain, loss):
    models, images, pngs, sm = plain
    step = _step(models, loss)
    with _cpu_profiler():
        step(images, pngs, sm)
    got = profiling.spans()
    top = [s for s in got if s[0].startswith("step.")]
    assert [s[0] for s in top] == PHASES + ["step.train"]  # in the order they end
    (root,) = top[-1:]
    assert root[4] is None
    for (name, t0, t1, tid, parent), nxt in zip(top[:4], top[1:5]):
        assert parent == "step.train" and tid == root[3]
        assert root[1] <= t0 <= t1 <= root[2]
        assert t1 <= nxt[1] or nxt[0] == "step.train"
    ops = {name: [s for s in got if s[0] == name] for name in ("op.conv3x3", "op.conv3x3_dgrad")}
    # unet_plain: 9 square convs, each forward and backward once
    assert {k: len(v) for k, v in ops.items()} == {"op.conv3x3": 9, "op.conv3x3_dgrad": 9}
    assert {s[4] for s in ops["op.conv3x3"]} == {"step.forward"}
    # the CPU runs autograd's backward on the calling thread: its operators nest in the phase
    assert {s[4] for s in ops["op.conv3x3_dgrad"]} == {"step.backward"}


def test_predict_probs_records_the_call_and_its_three_parts(plain):
    models, images, _, _ = plain
    fn = steps.make_predict_fn(models["two"], amp=False)
    with _cpu_profiler():
        probs = port_predict.predict_probs(fn, images)
        port_predict.predict_probs(fn, images)
    assert probs.shape == (BATCH, SIZE, SIZE, 2)
    got = [s for s in profiling.spans() if s[0].startswith("predict.")]
    names = [s[0] for s in got]
    assert names == ["predict.h2d", "predict.forward", "predict.d2h", "predict.call"] * 2
    for call in (got[:4], got[4:]):
        root = call[-1]
        assert [s[4] for s in call] == ["predict.call"] * 3 + [None]
        assert all(root[1] <= s[1] <= s[2] <= root[2] for s in call[:3])
        assert call[0][2] <= call[1][1] and call[1][2] <= call[2][1]


def test_a_span_on_another_thread_is_kept_with_its_thread_id():
    seen = {}

    def work():
        seen["tid"] = threading.get_ident()
        with profiling.span("op.conv3x3_dgrad"):
            pass

    with _cpu_profiler():
        with profiling.span("step.backward"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    (other,) = [s for s in profiling.spans() if s[0] == "op.conv3x3_dgrad"]
    (mine,) = [s for s in profiling.spans() if s[0] == "step.backward"]
    assert other[3] == seen["tid"] != mine[3] == threading.get_ident()
    assert other[4] is None  # no parent on its own thread: a reader places it by time
    assert mine[1] <= other[1] <= other[2] <= mine[2]


def test_spans_show_by_name_in_a_host_trace_and_the_buffer_is_bounded():
    with _cpu_profiler() as prof:
        with profiling.span("step.train"):
            with profiling.span("step.loss"):
                torch.ones(4).add_(1)
    assert {"step.train", "step.loss"} <= {e.key for e in prof.key_averages()}
    assert [(s[0], s[4]) for s in profiling.spans()] == [("step.loss", "step.train"),
                                                         ("step.train", None)]
    profiling.clear_spans()
    assert profiling.spans() == []
    with _cpu_profiler():
        for _ in range(profiling.SPAN_BUFFER + 5):
            with profiling.span("input.batch"):
                pass
    assert len(profiling.spans()) == profiling.SPAN_BUFFER


# --- the reader, on a hand-made chrome trace -------------------------------------------------
BASE = 1_700_000_000_000_000_000  # the trace's zero, wall-clock ns
SITES = [{"channels": 64, "stride": 1, "bias": True}]


def _wall(us: float) -> int:
    return BASE + int(us * 1000)


# One step of a chunk: card busy [0, 10), [30, 45), [70, 95) us of the stretch [0, 100).
KERNELS = [(0.0, 10.0, 3.0), (30.0, 15.0, 27.0), (70.0, 25.0, 62.0)]  # (ts, dur, launch)
PROGRAM = [("input.batch", 5, 15), ("step.forward", 20, 40), ("op.conv3x3", 25, 30),
           ("step.loss", 40, 50), ("op.conv3x3_dgrad", 60, 65), ("step.backward", 50, 80),
           ("step.optimizer", 80, 88), ("step.train", 20, 90), ("input.batch", 200, 210)]


class _Tracer:
    def __init__(self, spans):
        self._spans = spans


class _Run:
    def __init__(self, program, steps=1):
        harness = [("portbench.train_step", _wall(20), _wall(90)),
                   ("portbench.chunk", _wall(0), _wall(100))]
        events = []
        for k, (ts, dur, launch) in enumerate(KERNELS):
            events.append({"ph": "X", "cat": "kernel", "name": f"k{k}", "ts": ts, "dur": dur,
                           "args": {"correlation": k}})
            events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                           "ts": launch, "dur": 1.0, "args": {"correlation": k}})
        doc = {"traceEvents": events, "baseTimeNanoseconds": BASE}
        self.tracer = _Tracer(harness)
        self.trace_data = Trace.from_chrome(doc, harness)
        self.stretch_span = "chunk"
        self.stats = {"profiled_steps": steps}
        self.config = {"square_conv_sites": SITES}
        self.cell = {"size": 64, "batch": 2, "dtype": "bf16"}
        self.raw = [(n, _wall(a), _wall(b), 1, None) for n, a, b in program]


@pytest.fixture
def run(monkeypatch):
    r = _Run(PROGRAM)
    monkeypatch.setattr(program_spans, "recorded", lambda: r.raw)
    return r


def test_reader_recovers_the_trace_clock_from_a_harness_span(run):
    assert program_spans.base_ns(run) == BASE
    placed = program_spans.placed(run)
    assert [(o.ts, o.end) for o in placed["step.train"]] == [(20.0, 90.0)]
    assert len(placed["input.batch"]) == 1  # the one after the stretch is left out


def test_idle_is_split_by_exact_overlap_between_phases(run):
    got = {p: program_spans.phase_idle_ms(run, p) for p in program_spans.TRAIN_PHASES}
    # idle [10, 30): input 5 us, none 5, forward 10 (the conv's own span counts as forward);
    # [45, 70) crosses loss (5) into backward (20), where a midpoint would give backward all 25
    assert got == {"input.batch": 0.005, "step.forward": 0.010, "step.loss": 0.005,
                   "step.backward": 0.020, "step.optimizer": 0.0}


def test_idle_outside_every_program_span_is_counted_in_none(run):
    trace = run.trace_data
    idle = program_spans.idle_intervals(trace, 0.0, 100.0)
    assert idle == [(10.0, 30.0), (45.0, 70.0), (95.0, 100.0)]
    ranges = [o for ops in program_spans.placed(run).values() for o in ops
              if o.name in program_spans.TRAIN_SPLIT]
    split = program_spans.split_idle(idle, ranges)
    assert sum(split.values()) == pytest.approx(40.0)  # of 50: [15, 20) and [95, 100) in none
    assert split.get("step.train", 0.0) == 0.0


def test_launches_and_the_operator_roofline_count_what_the_spans_launched(run):
    assert program_spans.step_launches(run) == 2  # k1 and k2 launched inside step.train
    _, least = counts.conv3x3_work(SITES, 64, 2, "bf16", dgrad=True)
    # k1 (15 us) launched in op.conv3x3, k2 (25 us) in op.conv3x3_dgrad
    assert program_spans.conv3x3_op_roofline(run) == pytest.approx(100 * least * 1e6 / 40.0)


def test_readers_are_silent_without_spans_or_when_counts_do_not_match(monkeypatch):
    short = _Run([s for s in PROGRAM if s[0] != "step.loss"])
    monkeypatch.setattr(program_spans, "recorded", lambda: short.raw)
    assert program_spans.phase_idle_ms(short, "step.forward") is None
    assert program_spans.step_launches(short) == 2
    two = _Run(PROGRAM, steps=2)
    monkeypatch.setattr(program_spans, "recorded", lambda: two.raw)
    assert program_spans.step_launches(two) is None
    assert program_spans.conv3x3_op_roofline(two) is None
    monkeypatch.setattr(program_spans, "recorded", lambda: None)  # a program with no spans
    assert program_spans.phase_idle_ms(_Run(PROGRAM), "step.loss") is None
    assert program_spans.copy_host_ms(_Run(PROGRAM)) is None

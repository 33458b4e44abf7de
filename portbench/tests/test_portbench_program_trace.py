"""The readers of the program's spans and counts (`program_trace.py` and
the metrics that use it) on a hand-built Chrome-trace event list: ranges
outside the window, or on another thread than the window's, are left
out, and a trace without the program's ranges reads nothing."""
import pytest

from portbench import program_trace, run
from portbench.trace import WINDOW, Trace

MAIN, OTHER = 1, 2


def rng(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "tid": tid}


def kernel(ts, dur):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur,
            "tid": 7}


# the window is [0, 1000] us; the device is busy inside it on
# [0, 10], [100, 300], [500, 600] and [900, 1000]
DEVICE = [kernel(-50, 60), kernel(100, 100), kernel(150, 150),
          kernel(500, 100), kernel(900, 200)]


def trace(*ranges):
    return Trace([rng(WINDOW, 0, 1000)] + DEVICE + list(ranges), 1.0)


def counts_(name, values, tid=MAIN, at=20):
    return [rng(f"{name}={v}", at + i, 0, tid) for i, v in enumerate(values)]


SPANS = [rng("s", 50, 350), rng("s", 300, 150), rng("s", 650, 50),
         rng("s", 0, 1000, OTHER), rng("s", 1200, 100)]


def test_ranges_keep_the_window_and_its_thread():
    t = trace(*SPANS)
    assert [r["ts"] for r in program_trace.ranges(t, "s")] == [50, 300, 650]
    assert program_trace.host_s(t, "s") == pytest.approx(550e-6)


def test_idle_under_a_span_merges_the_span_and_subtracts_the_busy_time():
    # span [50, 450] u [650, 700]: 400 + 50 us, busy 200 of them
    assert program_trace.idle_s(trace(*SPANS), "s") == pytest.approx(250e-6)
    # a span across the window's end is cut at it: [950, 1000] is busy
    t = trace(rng("e", 800, 400))
    assert program_trace.idle_s(t, "e") == pytest.approx(100e-6)


def test_counts_read_the_value_in_the_name():
    t = trace(*counts_("c", [3, 0, 3]), *counts_("c", [9], tid=OTHER),
              *counts_("c", [9], at=1500), *counts_("cc", [9]))
    assert sorted(program_trace.counts(t, "c")) == [0, 3, 3]


EVAL = [*counts_("cluster/ms_steps_run", [50, 50]),
        *counts_("cluster/ms_steps_needed", [30, 50], at=40),
        *counts_("cluster/ms_steps_run", [50], tid=OTHER),
        *counts_("cluster/guard_retries", [0, 3], at=60),
        *counts_("lobpcg/iterations", [4, 10, 7], at=80),
        rng("predict_shapes/lobpcg", 50, 350),
        rng("predict_shapes/lobpcg", 0, 1000, OTHER)]
TRAIN = [rng("data/prefetch_wait", 700, 50), rng("data/prefetch_wait", 760, 40),
         rng("data/prefetch_wait", 0, 900, OTHER),
         *counts_("data/assemble_us", [1500, 2500], at=705),
         rng("train_step/forward_loss", 50, 350),
         rng("train_step/backward", 450, 250),
         rng("train_step/optimizer", 10, 40), rng("train_step/optimizer", 800, 150)]


@pytest.mark.parametrize("metric,events,want", [
    ("ms_steps_needed_pct.eval", EVAL, 80.0),
    ("guard_retries_per_batch.eval", EVAL, 1.5),
    ("lobpcg_iters.eval", EVAL, 7.0),
    # 150 us idle under the span, two batches
    ("lobpcg_idle_ms.eval", EVAL, 0.075),
    # 90 us over three steps
    ("data_wait_ms.train", TRAIN, 0.03),
    ("batch_assemble_ms.train", TRAIN, 2.0),
    # [50, 400]: 150 us idle; [450, 700]: 150; [10, 50] u [800, 950]: 140
    ("forward_idle_ms.train", TRAIN, 0.05),
    ("backward_idle_ms.train", TRAIN, 0.05),
    ("optimizer_idle_ms.train", TRAIN, 140e-3 / 3),
])
def test_reader_gives_the_hand_worked_value(metric, events, want):
    ctx = {"trace": trace(*events), "pulled": 2, "steps": 3}
    assert run.metric_reader(metric).read(ctx) == pytest.approx(want)


@pytest.mark.parametrize("metric", [
    "ms_steps_needed_pct.eval", "guard_retries_per_batch.eval",
    "lobpcg_iters.eval", "lobpcg_idle_ms.eval", "data_wait_ms.train",
    "batch_assemble_ms.train", "forward_idle_ms.train",
    "backward_idle_ms.train", "optimizer_idle_ms.train"])
def test_reader_reads_nothing_where_the_program_recorded_nothing(metric):
    # a program without these spans and counts; theirs on another thread
    t = trace(*(dict(e, tid=OTHER) for e in EVAL + TRAIN))
    assert run.metric_reader(metric).read(
        {"trace": t, "pulled": 2, "steps": 3}) is None

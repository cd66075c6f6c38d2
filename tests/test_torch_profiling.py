"""``--autotune`` and ``--profile-dir`` through the port's trainer CLI on the
CPU, the trace they write (``rectpu_torch.utils.profiling``) and the
autotuner's CUDA-event timer (``rectpu_torch.utils.timing``, with a fake
card)."""

import json
import logging

import pytest
import torch

from rectpu_torch.data.synthetic import write_synthetic_dataset
from rectpu_torch.ops import fm as t_fm
from rectpu_torch.ops import interaction as t_int
from rectpu_torch.ops import scatter_rows as t_sc
from rectpu_torch.trainers import deep_fm as deep_fm_cli
from rectpu_torch.utils import profiling, timing

PINS = (t_fm._FLAT_AUTO, t_int._INTERACT_AUTO, t_sc._AUTO_CHUNK)


@pytest.fixture(autouse=True)
def _restore_pins():
    saved = [dict(p) for p in PINS]
    yield
    for pin, copy in zip(PINS, saved):
        pin.clear()
        pin.update(copy)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_cli_autotune_and_profile_dir_write_a_trace(tmp_path):
    """A 4-step CPU run with --autotune --profile-dir (windows of 2 steps):
    the autotuner logs its picks, the second window is traced into the
    directory, and the trainer clears the field once the trace is out."""
    data = write_synthetic_dataset(tmp_path / "data", train_rows=400, test_rows=100, seed=2)
    prof = tmp_path / "profile"
    args = deep_fm_cli.build_parser().parse_args(
        ["--device", "cpu", "--train-csv", data["train"], "--test-csv", data["test"],
         "--job-dir", str(tmp_path / "job"), "--train-steps", "4", "--batch-size", "32",
         "--steps-per-loop", "2", "--save-checkpoints-steps", "4", "--autotune",
         "--profile-dir", str(prof)])
    log = _Lines()
    root = logging.getLogger("rectpu_torch")
    root.addHandler(log)
    try:
        metrics, trainer = deep_fm_cli.train_and_evaluate(args)
    finally:
        root.removeHandler(log)
    assert len(trainer.step_losses) == 4 and 0.0 <= metrics["auc"] <= 1.0
    assert sum(m.startswith("autotune on cpu:") for m in log.lines) == 1
    traces = list(prof.glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert any(m == f"profile trace written to {traces[0]}" for m in log.lines)
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    assert trainer.profile_dir is None


def test_trace_and_annotate_write_a_chrome_trace(tmp_path):
    """A region named with ``torch.profiler.record_function`` shows in the
    trace."""
    with profiling.trace(tmp_path) as capture:
        with torch.profiler.record_function("rectpu_torch_region"):
            torch.ones(8).add_(1.0)
    assert capture.path.parent == tmp_path and capture.path.name.endswith(".pt.trace.json")
    assert "rectpu_torch_region" in capture.path.read_text()


def test_trace_of_the_card_without_device_events_raises(tmp_path, monkeypatch):
    """A capture that asked for the card's activity and got none (no CUPTI)
    raises rather than writing a trace without the card."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="no CUDA activity"):
        with profiling.trace(tmp_path, cuda=True):
            torch.ones(8).add_(1.0)
    assert not list(tmp_path.glob("*.json"))


def test_a_block_that_raises_leaves_no_trace(tmp_path):
    with pytest.raises(KeyError):
        with profiling.trace(tmp_path) as capture:
            raise KeyError("step")
    assert capture.path is None and not list(tmp_path.glob("*.json"))
    with profiling.trace(tmp_path) as capture:  # the profiler was stopped
        torch.ones(8).add_(1.0)
    assert capture.path.exists()


class _FakeCard:
    """torch.cuda's events, sleep and synchronize: each event pair reads
    0.25 ms, and the sleeps' cycle counts are kept."""

    def __init__(self, monkeypatch):
        self.sleeps = []

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing

            def record(self):
                pass

            def elapsed_time(self, end):
                return 0.25

        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "_sleep", self.sleeps.append)
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


@pytest.mark.parametrize("host_s", [0.0, 0.002])
def test_event_ms_sleeps_while_the_host_queues_every_call(host_s, monkeypatch):
    """The sleep ahead of the timed calls lasts at least twice the host time
    of queueing them (a slow call on a loaded host), and never less than
    SLEEP_MIN_S. The host clock is a fake one that only the calls advance,
    by ``host_s`` each, so the reading does not depend on the host's load."""
    card = _FakeCard(monkeypatch)
    calls = []
    clock = [0.0]
    monkeypatch.setattr(timing.time, "perf_counter", lambda: clock[0])

    def fn():
        calls.append(1)
        clock[0] += host_s

    assert timing.event_ms(fn, iters=20) == 0.25
    assert len(calls) == 3 + 20 and len(card.sleeps) == 1
    assert card.sleeps[0] >= int(max(timing.SLEEP_MIN_S, 2 * 20 * host_s) * timing.CLOCK_HZ)
    if host_s == 0.0:
        assert card.sleeps[0] < 2 * timing.SLEEP_MIN_S * timing.CLOCK_HZ

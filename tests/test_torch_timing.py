"""The device-only reading of ``kernel_bench.timed_ms`` and its gate, on the
CPU: the loop driven with a fake of the device's operations (the sleep
kernel, the events, the synchronize), and the bench's launch count, which
leaves out the calls that the gate adds. No test touches CUDA."""

import pytest
import torch

from tpu_ray_tracer_torch import bench, kernel_bench
from tpu_ray_tracer_torch.kernel_bench import (CYCLES_PER_S, GATE_MAX_CYCLES, GATE_MIN_CYCLES,
                                               _timed_ms, timed_ms)
from tpu_ray_tracer_torch.render.fwd_kernel import render_fwd

FRAMES = 4


class FakeCuda:
    """``torch.cuda``'s ``synchronize``, ``_sleep`` and ``Event`` for
    ``_timed_ms``, with a host clock that each call of ``fn`` advances.

    ``gate`` gives what the start event's ``query()`` returns, run by run
    (True: the device had reached it); run i's events span ``10 (i + 1)``
    ms, so a reading says which run it came from."""

    def __init__(self, gate, call_ms=1.0):
        self.gate = iter(gate)
        self.call_ms = call_ms
        self.now_ms = 0.0
        self.sleeps, self.queries, self.runs, self.calls = [], 0, 0, 0

    def synchronize(self):
        pass

    def _sleep(self, cycles):
        self.sleeps.append(cycles)

    def Event(self, enable_timing=False):  # noqa: N802 (torch.cuda.Event)
        assert enable_timing
        fake = self

        class Event:
            run = self.runs // 2  # the start and the end event of one run

            def record(self):
                pass

            def query(self):
                fake.queries += 1
                return next(fake.gate)

            def elapsed_time(self, end):
                assert end.run == self.run
                return 10.0 * (self.run + 1)

        self.runs += 1
        return Event()

    def clock(self):
        return self.now_ms / 1e3

    def fn(self, k):
        self.calls += 1
        self.now_ms += self.call_ms


def test_gate_discards_a_run_the_device_reached_early():
    """A start event already reached when the last call was queued: the run
    is discarded, the sleep doubled, and the second run's reading returned."""
    cuda = FakeCuda([True, False])
    ms = _timed_ms(cuda.fn, FRAMES, True, cuda, cuda.clock)
    assert ms == 20.0 / FRAMES  # the second run's events
    assert cuda.sleeps == [GATE_MIN_CYCLES, 2 * GATE_MIN_CYCLES]
    assert cuda.queries == 2
    # the sizing pass, the discarded run and the accepted one
    assert cuda.calls == 3 * FRAMES
    assert timed_ms.last_gate == kernel_bench.Gate(2 * GATE_MIN_CYCLES, 1, 2 * FRAMES, 1.0)


@pytest.mark.parametrize("call_ms,first", [
    (1.0, GATE_MIN_CYCLES),                                     # quick: the floor
    (50.0, int(2 * FRAMES * 50e-3 * CYCLES_PER_S)),             # twice the sizing pass
    (2000.0, GATE_MAX_CYCLES),                                  # past the cap: the cap
])
def test_first_sleep_is_twice_the_sizing_pass(call_ms, first):
    """The first sleep is twice the host's time to queue the untimed pass,
    in cycles, at least GATE_MIN_CYCLES and at most GATE_MAX_CYCLES; a run
    that passes the gate at once is returned with no rerun."""
    cuda = FakeCuda([False], call_ms)
    assert _timed_ms(cuda.fn, FRAMES, True, cuda, cuda.clock) == 10.0 / FRAMES
    assert cuda.sleeps == [first]
    assert timed_ms.last_gate.reruns == 0 and timed_ms.last_gate.extra_calls == FRAMES


def test_gate_raises_after_the_cap():
    """A start event that is always reached (as with an ``fn`` that waits
    for the device): the sleep doubles up to the cap and the helper raises,
    naming the frames, never returning a reading."""
    cuda = FakeCuda(iter(lambda: True, None))
    with pytest.raises(kernel_bench.GateRefused,
                       match=f"before {FRAMES} calls were queued") as exc:
        _timed_ms(cuda.fn, FRAMES, True, cuda, cuda.clock)
    assert f"sleep of {GATE_MAX_CYCLES} cycles" in str(exc.value)
    doubled = [GATE_MIN_CYCLES]
    while doubled[-1] < GATE_MAX_CYCLES:
        doubled.append(min(2 * doubled[-1], GATE_MAX_CYCLES))
    assert cuda.sleeps == doubled and len(doubled) == cuda.queries == 11
    assert timed_ms.last_gate is None


def test_whole_call_reading_never_queries_the_gate():
    """``device_only=False`` times one run with the host's gaps: no sizing
    pass, no sleep, no gate."""
    cuda = FakeCuda([])
    timed_ms.last_gate = kernel_bench.Gate(1, 0, 0, 0.0)
    assert _timed_ms(cuda.fn, FRAMES, False, cuda, cuda.clock) == 10.0 / FRAMES
    assert cuda.queries == 0 and cuda.sleeps == [] and cuda.calls == FRAMES
    assert timed_ms.last_gate is None


@pytest.mark.parametrize("device_only", [True, False])
def test_needs_a_card(monkeypatch, device_only):
    """Without CUDA, ``timed_ms`` raises before calling ``fn``: it never
    returns a host-clock number as a device time."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        timed_ms(calls.append, FRAMES, device_only=device_only)
    assert calls == []


def test_bench_leaves_the_gates_calls_out_of_its_launches(monkeypatch):
    """The bench's kernel reading counts the launches of the gate's sizing
    pass and discarded runs apart, so that ``launches`` holds the accepted
    run's alone."""
    monkeypatch.setattr(render_fwd, "launches", 0)
    monkeypatch.setattr(render_fwd, "launches_by_variant", {"main": 0, "main_chain": 0,
                                                            "generic": 0})

    def launch(k):  # what one render_fwd launch of the main instantiation counts
        render_fwd.launches += 1
        render_fwd.launches_by_variant["main"] += 1

    def fake_timed_ms(fn, frames, device_only):
        assert device_only
        for k in range(3 * frames):  # the sizing pass, one discarded run, the accepted one
            fn(k % frames)
        fake_timed_ms.last_gate = kernel_bench.Gate(GATE_MIN_CYCLES, 1, 2 * frames, 0.01)
        return 0.125

    monkeypatch.setattr(bench, "timed_ms", fake_timed_ms)
    extra = {"render_fwd": 5}
    with bench._Progress() as progress:
        assert bench._kernel_ms(progress, launch, FRAMES, extra) == 0.125
    assert {k: v for k, v in extra.items() if v} == {"render_fwd": 5 + 2 * FRAMES,
                                                      "render_fwd.main": 2 * FRAMES}
    assert render_fwd.launches == 3 * FRAMES

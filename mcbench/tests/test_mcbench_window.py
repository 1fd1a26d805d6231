"""Whole-sample counting: the window ends at the end of the last sample
that finishes within --seconds; no sample counts in part."""
import pytest

from mcbench import harness


def _fake(monkeypatch, durations, reads=100):
    clock = [0.0]
    it = iter(durations)

    def run_sample(engine, cfg, cmd, vcf, reset, spans):
        t0 = clock[0]
        clock[0] += next(it)
        return dict(start=t0, end=clock[0], seconds=clock[0] - t0,
                    reads=reads, vcf=vcf, stages=None, call_s=0.0)

    monkeypatch.setattr(harness, "run_sample", run_sample)
    monkeypatch.setattr(harness.time, "perf_counter", lambda: clock[0])


@pytest.mark.parametrize("durations,seconds,counted,window", [
    ([4, 4, 4, 4], 10, 2, 8),     # a third would end at 12: not started
    ([3, 3, 5, 9], 10, 2, 6),     # the third ends at 11: late, not counted
    ([2, 2, 2, 2, 2, 2], 10, 5, 10),
    ([6, 6], 10, 1, 6),           # fewer than two: the run fails
])
def test_whole_samples(monkeypatch, durations, seconds, counted, window):
    _fake(monkeypatch, durations)
    done, late = harness.run_window(None, None, "", "/nonexistent", seconds,
                                    False)
    assert len(done) == counted
    assert done[-1]["end"] == window
    assert all(s["end"] <= seconds for s in done)
    assert all(s["end"] > seconds for s in late)
    rate = sum(s["reads"] for s in done) / done[-1]["end"]
    assert rate == 100 * counted / window

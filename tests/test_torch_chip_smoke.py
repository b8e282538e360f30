"""chip_smoke.py's device-time yardstick on the CPU: ``device_trace`` (under
``device_ms``) profiles one call, then ``calls`` calls, and sums a trace
only when it holds ``calls`` times each kernel's records a call (the most
any window has shown, and at least the launches the port's wrappers
counted); otherwise it tries again, up to three times.  After three, a
trace that held every kernel gives each kernel its mean over the records
it holds times its records a call; where none did, it raises.  The
profiler is replaced by recorded rows, so no card is needed;
``_window_rows`` runs on the CPU's own events."""
import importlib.util
import pathlib
from types import SimpleNamespace

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke_yardstick",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    return mod


def _profiler(smoke, monkeypatch, traces):
    """Run each profiled window's calls and hand out ``traces`` ({name:
    (count, us)}) in turn for them; return the windows' call counts as they
    are asked for."""
    asked = []

    def fake(fn, calls):
        asked.append(calls)
        for _ in range(calls):
            fn()
        return {k: SimpleNamespace(key=k, count=n, self_device_time_total=us)
                for k, (n, us) in traces[len(asked) - 1].items() if n}
    monkeypatch.setattr(smoke, "_device_rows", fake)
    return asked


ONE = {"prep": (1, 10.0), "kernel": (1, 90.0)}
FULL = {"prep": (10, 100.0), "kernel": (10, 900.0)}
# a trace that lost half the kernel's records: their mean is the same
SHORT = {"prep": (10, 100.0), "kernel": (5, 450.0)}
PREP_ONLY = {"prep": (10, 100.0)}


def test_a_whole_trace_is_summed_at_once(smoke, monkeypatch):
    asked = _profiler(smoke, monkeypatch, [ONE, FULL])
    assert smoke.device_ms(lambda: None, 10) == pytest.approx(0.1)
    assert asked == [1, 10]


def test_a_short_trace_is_taken_again(smoke, monkeypatch):
    asked = _profiler(smoke, monkeypatch, [ONE, SHORT, ONE, FULL])
    assert smoke.device_trace(lambda: None, 10) == {"prep": pytest.approx(0.01),
                                                    "kernel": pytest.approx(0.09)}
    assert asked == [1, 10, 1, 10]


def test_three_short_traces_give_the_fullest_ones_means_times_the_records_a_call(
        smoke, monkeypatch):
    """The sum of a short trace would read 0.055 ms a call; the means of
    the records the fullest holds, times one record a call each, read the
    0.1 ms a call of a whole trace."""
    shorter = {"prep": (4, 40.0), "kernel": (4, 360.0)}
    asked = _profiler(smoke, monkeypatch, [ONE, shorter, ONE, SHORT, ONE, shorter])
    assert smoke.device_ms(lambda: None, 10) == pytest.approx(0.1)
    assert asked == [1, 10] * 3


def test_the_records_a_call_come_from_a_one_call_window(smoke, monkeypatch):
    """A kernel launched twice a call whose traces lost more than ``calls``
    of its records: its count in the traces, rounded up, reads one record
    a call; the one-call window's two are taken."""
    one = {"prep": (1, 10.0), "kernel": (2, 180.0)}
    lossy = {"prep": (10, 100.0), "kernel": (9, 810.0)}
    _profiler(smoke, monkeypatch, [one, lossy] * 3)
    assert smoke.device_trace(lambda: None, 10) == {"prep": pytest.approx(0.01),
                                                    "kernel": pytest.approx(0.18)}


def test_a_trace_that_shows_more_records_a_call_raises_the_count(smoke, monkeypatch):
    """A one-call window that lost one of a kernel's two records: a whole
    trace of 20 shows two a call, and is summed."""
    asked = _profiler(smoke, monkeypatch, [ONE, {"prep": (10, 100.0), "kernel": (20, 1800.0)}])
    assert smoke.device_ms(lambda: None, 10) == pytest.approx(0.19)
    assert asked == [1, 10]


@pytest.mark.parametrize("warm_up", [{}, {"kernel": (1, 90.0)}])
def test_a_whole_trace_makes_up_for_a_lossy_one_call_window(smoke, monkeypatch, warm_up):
    asked = _profiler(smoke, monkeypatch, [warm_up, FULL])
    assert smoke.device_ms(lambda: None, 10) == pytest.approx(0.1)
    assert asked == [1, 10]


def test_a_kernel_missing_from_every_trace_raises(smoke, monkeypatch):
    _profiler(smoke, monkeypatch, [ONE, PREP_ONLY] * 3)
    with pytest.raises(RuntimeError, match="lost a kernel of the call"):
        smoke.device_ms(lambda: None, 10)


def test_the_wrappers_counters_outvote_windows_that_all_lost_a_kernel(smoke, monkeypatch):
    """Every window lost the wrapper's second kernel: the traces look whole
    for the one kernel they hold, but the wrappers counted two launches a
    call, so none is summed and the yardstick raises."""
    from fairygen_tpu_torch.ops import _kernels

    def call():
        _kernels.launches["flash_fwd_prep_f32"] += 1
        _kernels.launches["flash_fwd_lse_f32"] += 1

    _kernels.reset_launches()
    asked = _profiler(smoke, monkeypatch, [{"prep": (1, 10.0)}, PREP_ONLY] * 3)
    with pytest.raises(RuntimeError, match="2 launches counted"):
        smoke.device_ms(call, 10)
    assert asked == [1, 10] * 3
    _kernels.reset_launches()


def test_traces_without_device_time_raise(smoke, monkeypatch):
    idle = {"prep": (10, 0.0), "kernel": (10, 0.0)}
    _profiler(smoke, monkeypatch, [ONE, {}, ONE, idle, ONE, {}])
    with pytest.raises(RuntimeError, match="lost a kernel of the call"):
        smoke.device_ms(lambda: None, 10)


def test_a_trace_without_device_time_is_taken_again(smoke, monkeypatch):
    idle = {"prep": (10, 0.0), "kernel": (10, 0.0)}
    asked = _profiler(smoke, monkeypatch, [ONE, idle, ONE, FULL])
    assert smoke.device_ms(lambda: None, 10) == pytest.approx(0.1)
    assert asked == [1, 10, 1, 10]


def test_the_profiler_window_records_the_calls_not_its_spin(smoke, monkeypatch):
    """A window holds its calls' events and not its opening spin kernel's
    (CPU ops stand in for kernels)."""
    def spin(cycles):
        with torch.profiler.record_function("at::spin_kernel(long)"):
            torch.ones(1)

    monkeypatch.setattr(torch.cuda, "_sleep", spin)

    def fn():
        with torch.profiler.record_function("window_call"):
            torch.ones(3).add_(1)

    rows = smoke._window_rows(fn, 4, [torch.profiler.ProfilerActivity.CPU])
    assert sum(e.count for e in rows if e.key == "window_call") == 4
    assert not [e for e in rows if "spin" in e.key]

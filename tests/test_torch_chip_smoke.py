"""chip_smoke.py's census of a profiled replay, on the CPU with the
profiler replaced by a stub: a reading that drops kernel records is taken
again, a reading that is short every time fails, and the first reading
that holds exactly the census is the one returned."""

import pytest

import chip_smoke


def reading(counts, ms=1.0):
    """A kernel_profile result whose per-call kernel counts are `counts`
    ({kernel name: launches per call})."""
    by_name = {name: ms for name in counts}
    return sum(by_name.values()), sum(counts.values()), by_name, dict(counts)


def census(**per_kernel):
    want = {name: 0 for name in chip_smoke.launch_counts()}
    want.update(per_kernel)
    return want


WALK = census(ntt_fwd=4, ntt_inv=3, behz_tensor=1)
FULL = {"ntt_fwd_kernel<0>": 2.0, "ntt_fwd_kernel<1>": 2.0,
        "ntt_inv_kernel<0>": 3.0, "behz_tensor_kernel": 1.0,
        "elementwise_kernel": 40.0}
SHORT = dict(FULL, **{"ntt_fwd_kernel<1>": 1.0})


def stub_profiles(monkeypatch, readings):
    calls = []

    def kernel_profile(fn, reps=5):
        calls.append(reps)
        return readings[min(len(calls), len(readings)) - 1]

    monkeypatch.setattr(chip_smoke, "kernel_profile", kernel_profile)
    return calls


@pytest.mark.parametrize("lost", [0, 1, 4])
def test_a_reading_that_dropped_records_is_taken_again(monkeypatch, lost):
    calls = stub_profiles(monkeypatch,
                          [reading(SHORT)] * lost + [reading(FULL)])
    prof, tries = chip_smoke.census_profile(lambda: None, WALK, "a replay",
                                            reps=3)
    assert tries == lost + 1 and calls == [3] * (lost + 1)
    assert chip_smoke.in_profile(prof) == WALK and prof[1] == 48.0


@pytest.mark.parametrize("counts", [SHORT, dict(FULL, behz_to_bsk_k=2.0)],
                         ids=["short", "extra"])
def test_a_graph_that_differs_every_time_fails(monkeypatch, counts):
    calls = stub_profiles(monkeypatch, [reading(counts)])
    with pytest.raises(AssertionError, match="in 5 profiles, not"):
        chip_smoke.census_profile(lambda: None, WALK, "a replay")
    assert len(calls) == 5


def test_an_empty_trace_fails(monkeypatch):
    stub_profiles(monkeypatch, [None])
    with pytest.raises(AssertionError, match="no device activity"):
        chip_smoke.census_profile(lambda: None, WALK, "a replay")


@pytest.mark.parametrize("bound_ms,under", [(0.003, "warm"),
                                            (0.005, "warm and cold"),
                                            (0.001, None)])
def test_a_timing_under_its_bound_is_marked(monkeypatch, bound_ms, under):
    """_timed keeps the warm and the cold (L2 flushed) readings and the
    library call's time, and marks a device time under the DRAM bound as
    L2-resident instead of presenting it against the bound."""
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda fn, reps=10, cold=False: 0.5 if cold else 0.25)
    monkeypatch.setattr(
        chip_smoke, "kernel_profile",
        lambda fn, reps=5, cold=False: reading({"k": 1.0},
                                               0.004 if cold else 0.002))
    st = {}
    line = chip_smoke._timed(st, None, None, [1], (bound_ms, "bytes"),
                             library=lambda: None)
    assert (st["ms"], st["cold_ms"], st["library_ms"]) == (0.25, 0.5, 0.25)
    assert (st["device_ms"], st["cold_device_ms"]) == (0.002, 0.004)
    if under is None:
        assert "UNDER" not in line
    else:
        assert f"; {under} device time UNDER the bound" in line
    st = {}
    chip_smoke._timed(st, None, None, [1], (bound_ms, "bytes"))
    assert "library_ms" not in st


@pytest.mark.parametrize("seen,want", [(5, 0.2), (3, 0.2), (10, 0.4),
                                       (9, 0.4)])
def test_lost_records_scale_to_whole_launches(seen, want):
    """kernel_profile's ms a call: a kernel launched once a call whose
    trace kept 3 of 5 records reads its whole time (the mean of the records
    seen), and one launched twice a call reads two means."""
    got = chip_smoke.per_call_ms({"k": 0.2 * seen}, {"k": seen / 5}, 5)
    assert got["k"] == pytest.approx(want)


def test_a_timing_under_an_operations_bound_is_marked(monkeypatch):
    """An operations bound a kernel beats is not read as L2 residency: it
    is a fault of the bound's operation count."""
    monkeypatch.setattr(chip_smoke, "cuda_ms",
                        lambda fn, reps=10, cold=False: 0.25)
    monkeypatch.setattr(chip_smoke, "kernel_profile",
                        lambda fn, reps=5, cold=False: reading({"k": 1.0},
                                                               0.002))
    line = chip_smoke._timed({}, None, None, [1], (0.003, "operations"))
    assert "warm and cold device time UNDER the bound: the bound counts " \
        "more operations than the kernel issues" in line and \
        "L2-resident" not in line

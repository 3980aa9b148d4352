"""abc_tpu_torch's measurement entry point (bench.py, benchsuite.py, entry.py,
scripts/hybrid_ks_ab.py, utils/timing.py) on the CPU at small sizes.

The device measurements themselves run on a CUDA device (`python -m
abc_tpu_torch.bench`); these tests hold what does not need one: the ports of
the reference's harness cases (tests/test_bench_harness.py: the compact
digest, the compact line's length, the suite registry, the floor model's
arithmetic), the timer's handling of an invalid measurement, every config's
code path with its correctness field, and that nothing runs on the CPU
unless it is asked to.
"""

import contextlib
import io
import json
import math

import pytest
import torch

from abc_tpu.benchsuite import CONFIGS as REF_CONFIGS
from abc_tpu_torch import bench, benchsuite, entry
from abc_tpu_torch.crypto.bfv import BfvCiphertext
from abc_tpu_torch.scripts import hybrid_ks_ab
from abc_tpu_torch.utils import timing

pytestmark = pytest.mark.filterwarnings(
    "ignore:.*HE-standard 128-bit-security budget:UserWarning")


# ------------------------------------------------------ the harness's format

def test_compact_suite_digest_keeps_units_and_errors():
    suite = {
        "config4": {"value": 6, "unit": "mult-depth (sorting_gt16)"},
        "config6": {"value": 55.3, "unit": "ms t_computation",
                    "csv_schema": {"t_keygen": 345.1}},
        "config2": {"value": float("nan"), "unit": "-", "error": "x" * 200},
    }
    d = bench._compact_suite(suite)
    assert d["config4"]["unit"] == "mult-depth (sorting_gt16)"
    assert d["config6"]["csv"] == {"t_keygen": 345.1}
    assert len(d["config2"]["error"]) <= 60
    assert math.isnan(d["config2"]["value"])
    assert bench._compact_suite(None) == "suite failed"


def _representative_record(n_configs=6, note=""):
    rows = {str(b): {"chain": 32, "ntt_fwd": {
        "us_per_transform": 5.554, "Gbf_s": 1038.123456, "spread_us":
        [5.5, 5.6], "fixed_dispatch_ms": 0.01}, "ntt_inv": {
        "us_per_transform": 7.895, "Gbf_s": 1103.123456, "spread_us":
        [7.8, 7.9], "fixed_dispatch_ms": 0.01}} for b in bench.BATCHES}
    ops = {str(b): 123456.789 for b in bench.BATCHES}
    census = bench.mult_relin_census(8192, 6, 1)
    suite = {f"config{i}": {"value": 12345.678901, "unit": "ops/s",
                            "correct": True, "note": note}
             for i in range(1, n_configs + 1)}
    suite["config6"] = {"value": 23.123456, "unit": "ms t_computation",
                        "csv_schema": {"t_keygen": 300.123456,
                                       "t_input_encryption": 5.123456,
                                       "t_computation": 23.123456,
                                       "t_decryption": 1.234567}}
    full = {
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                   "nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W"},
        "timer": "cuda_graph",
        "headline_ntt": {"metric": "rns_ntt_butterflies_per_s_n16384_L14 "
                                   "(NVIDIA H100 80GB HBM3)",
                         "value": 289.123456, "unit": "Gbutterflies/s",
                         "spread_Gbf_s": [288.1, 290.2],
                         "batch_curve": rows},
        "mult_relin": {"batch_curve": {b: {"ops_per_s": v,
                                           "fixed_ms": 0.123456}
                                       for b, v in ops.items()},
                       "speed_of_light": bench.mult_relin_floor(census, ops)},
        "suite": suite,
    }
    full["problems"] = bench.problems(full)
    full["nan_headlines"] = bench.nan_headlines(full)
    return full


def test_compact_line_fits_1500_characters():
    """A representative compact line stays under the 1500 characters the
    bench enforces, and a longer one drops the suite digest."""
    full = _representative_record()
    line = bench.compact_line(full)
    assert len(line) < 1500
    parsed = json.loads(line)
    assert parsed["ok"] is True
    assert parsed["suite"]["config6"]["csv"]["t_keygen"] == 300.123
    assert parsed["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    for i in range(1, 6):
        full["suite"][f"config{i}"]["error"] = "e" * 300
        full["suite"][f"config{i}"]["unit"] = "u" * 100
    full["problems"] = bench.problems(full)
    line = bench.compact_line(full)
    assert len(line) < 1500
    assert json.loads(line)["ok"] is False


def test_suite_registry_covers_six_configs():
    assert sorted(benchsuite.CONFIGS) == [1, 2, 3, 4, 5, 6]
    assert {k: f.__name__ for k, f in benchsuite.CONFIGS.items()} == \
        {k: f.__name__ for k, f in REF_CONFIGS.items()}


def test_mult_relin_floor_model_hand_worked():
    """The census at n=8192, L=6, k=1 (K = 8 Bsk primes, 7 columns of q ∪ P,
    6 digits) against numbers worked by hand, and the floor's arithmetic
    with the card's two rates."""
    c = bench.mult_relin_census(8192, 6, 1)
    assert (c["ntt_fwd_rows"], c["ntt_inv_rows"]) == (4 * 14 + 42, 3 * 14 + 14)
    assert c["ntt_rows"] == 154
    assert c["butterflies"] == 154 * 4096 * 13 == 8_200_192
    assert c["ntt_scale_products"] == 56 * 8192
    # to_bsk 4 x 77, fast_floor 3 x 70, from_bsk 3 x 63, mod switch 2 x 6
    assert c["per_coefficient"]["mul_table"] == 308 + 210 + 189 + 12 == 719
    # tensor 4 x 14, inner product 2 x 6 x 7
    assert c["per_coefficient"]["mul_var"] == 56 + 84
    assert c["per_coefficient"]["add"] == \
        4 * 62 + 14 + 3 * 48 + 3 * 61 + 42 + 70 + 36 + 12 == 749
    # operands 2 x 2 x 6 rows, key 2 x 6 x 7, result 2 x 6, words of 4 bytes
    assert c["bytes"] == 4 * 8192 * (24 + 84 + 12) == 3_932_160

    sol = bench.mult_relin_floor(c, {"1": 930.0, "8": 4000.0,
                                     "64": float("nan")})
    imads = 3 * 8_200_192 + 3 * 458_752 + 8192 * (3 * 719 + 5 * 140 + 2 * 749)
    assert sol["integer_multiply_adds"] == imads == 61_652_992
    assert sol["operations_floor_us"] == pytest.approx(
        61_652_992 / (132 * 64 * 1.98e9) * 1e6) == pytest.approx(3.68583,
                                                                  rel=1e-5)
    assert sol["bytes_floor_us"] == pytest.approx(3_932_160 / 3.35e12 * 1e6)
    assert sol["floor_us"] == sol["operations_floor_us"]
    assert sol["bound_by"] == "operations"
    assert sol["ntt_rows"] == 154
    # 930 ops/s is 1075.27 us per op
    assert sol["pct_of_floor"] == pytest.approx(100 * 3.68583 / 1075.2688,
                                                rel=1e-4)
    assert set(sol["pct_of_floor_by_batch"]) == {"1", "8"}     # nan left out
    assert 0 < sol["pct_of_floor"] < sol["pct_of_floor_by_batch"]["8"] < 100


def test_census_is_a_function_of_the_parameters_alone():
    k2 = bench.mult_relin_census(8192, 6, 2)
    # alpha = 3 digits over 8 columns: 24 decomposition rows against 42
    assert k2["ntt_fwd_rows"] == 4 * 14 + 24 and k2["ntt_inv_rows"] == 58
    assert k2["chains"]["decompose"]["mul_table"] == 6 + 3 * 2 * 8
    assert k2["chains"]["mod_switch_down"]["mul_table"] == 6 + 7
    assert bench.mult_relin_census(8192, 6, 1) == \
        bench.mult_relin_census(8192, 6, 1)


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(argv)
    return rc, out.getvalue().strip().splitlines()


def test_main_on_cpu_prints_a_parseable_last_line():
    rc, lines = _main(["--device", "cpu", "--n", "1024", "--ntt-n", "1024",
                       "--batches", "1", "2", "--chain", "2", "--ntt-chain",
                       "4", "--k-est", "1", "--suite", "1"])
    assert rc == 0
    line, full = json.loads(lines[-1]), json.loads(lines[-2])
    assert len(lines[-1]) < 1500
    assert line["timer"] == "host" and line["card"] == "cpu"
    assert line["ok"] is True
    assert set(line["mult_relin_ops_s_by_batch"]) == {"1", "2"}
    assert set(line["ntt_inv_Gbf_s_by_batch"]) == {"1", "2"}
    assert line["suite"]["config1"]["unit"] == "ms"
    assert full["mult_relin"]["census"]["ntt_rows"] == \
        4 * 12 + 5 * 6 + 3 * 12 + 2 * 6          # L = 5 at n=1024
    assert full["mult_relin"]["batch_curve"]["2"]["ntt_launches_per_step"] \
        == [5, 3]
    assert "vs_baseline" not in json.dumps(full)


def test_main_exits_nonzero_on_a_failed_config(monkeypatch):
    def broken(device="cuda"):
        raise ValueError("boom")

    monkeypatch.setitem(benchsuite.CONFIGS, 1, broken)
    rc, lines = _main(["--device", "cpu", "--n", "1024", "--ntt-n", "1024",
                       "--batches", "1", "--chain", "2", "--ntt-chain", "2",
                       "--k-est", "1", "--suite", "1"])
    assert rc == 1
    line = json.loads(lines[-1])
    assert line["ok"] is False
    assert line["suite"]["config1"]["error"] == "ValueError: boom"


# ------------------------------------------------------------------ the timer

def test_estimates_gives_nan_when_every_pair_is_inverted():
    """A stub chain that takes the longer the shorter it is: every pair is
    inverted, 3 x k_est pairs are tried, and the result is nan, not a
    clamped value."""
    calls = []

    def make_chain(c):
        def run(x):
            calls.append(c)
            t = timing.time.perf_counter()
            while timing.time.perf_counter() - t < 0.02 / (c * c):
                pass
            return x
        return run

    got = timing.estimates(make_chain, torch.zeros(1), 4, k_est=2)
    assert all(math.isnan(v) for v in got) and len(got) == 4
    # 6 pairs, each chain length run 1 + REPEATS times per measurement
    assert calls.count(4) == calls.count(2) == 6 * (1 + timing.REPEATS)


def test_estimates_on_a_valid_stub(monkeypatch):
    """The two-point arithmetic on a stub whose runs advance a fake host
    clock by exact amounts: a run of c steps in pair p takes c * step[p] +
    FIXED seconds (dyadic, so every difference is exact). Each pair's
    estimate is then step[p] per step and FIXED fixed, and the summary
    their median, least and largest, whatever the host's load."""
    unit = 2.0 ** -10
    step, fixed_s = (3 * unit, unit, 2 * unit), 2 * unit
    clock = [0.0]
    monkeypatch.setattr(timing.time, "perf_counter", lambda: clock[0])
    runs = {4: 0, 2: 0}

    def make_chain(c):
        def run(x):
            # host_s runs a chain 1 + REPEATS times per measurement, and
            # valid_pairs measures the full chain, then the half, per pair
            pair = runs[c] // (1 + timing.REPEATS)
            runs[c] += 1
            clock[0] += c * step[pair] + fixed_s
            return x
        return run

    med, lo, hi, fixed = timing.estimates(make_chain, torch.zeros(1), 4, 3)
    assert (med, lo, hi) == (2 * unit, unit, 3 * unit)
    assert fixed == fixed_s
    assert runs == {4: 3 * (1 + timing.REPEATS), 2: 3 * (1 + timing.REPEATS)}
    with pytest.raises(ValueError):
        timing.estimates(make_chain, torch.zeros(1), 1)


def test_nan_is_reported_not_clamped(monkeypatch):
    """An invalid measurement reaches the record as nan and is listed."""
    monkeypatch.setattr(benchsuite, "estimates",
                        lambda *a, **k: timing.NAN4)
    rec = benchsuite.config2_bfv_mult_relin(chain=2, device="cpu", n=1024,
                                            k_est=1)
    assert math.isnan(rec["value"]) and math.isnan(rec["ops_per_s_max"])
    full = _representative_record()
    full["suite"]["config2"] = rec
    assert bench.nan_headlines(full) == ["config2"]


# ---------------------------------------------------------------- the configs

def test_config1_cardio_on_the_dummy_scheme():
    rec = benchsuite.config1_cardio_dummy()
    assert rec["correct"] is True and rec["value"] > 0


def test_config2_mult_relin_on_cpu():
    rec = benchsuite.config2_bfv_mult_relin(chain=2, device="cpu", n=1024,
                                            k_est=1)
    assert rec["correct"] is True
    assert rec["timer"] == "host" and rec["unit"] == "ops/s"
    assert rec["ops_per_s_min"] <= rec["value"] <= rec["ops_per_s_max"]


def test_config3_hamming_on_cpu():
    rec = benchsuite.config3_batched_hamming(chain=2, device="cpu", n=1024,
                                             k_est=1)
    assert rec["correct"] is True
    assert rec["ntt_launches_per_step"] == [5, 5]


def test_config4_static_table_and_measured_runtime_on_cpu():
    rec = benchsuite.config4_cone_rewriting(measure_runtime=False)
    assert rec["value"] < rec["depth_before"]
    assert set(rec["circuits"]) == {"chi_squared", "sorting_gt16",
                                    "sorting_gt32", "cardio_netlist",
                                    "sorting_network_4x4"}
    m = benchsuite._cone_measured_runtime(bits=4, n=1024, repeats=1,
                                          device="cpu")
    assert m["decrypt_equal"] is True
    assert m["after"]["depth"] <= m["before"]["depth"]
    assert m["timer"] == "host"
    assert math.isfinite(m["measured_speedup"])


def test_config5_ckks_on_cpu():
    rec = benchsuite.config5_ckks_sharded(chain=2, device="cpu", n=1024,
                                          levels=3, k_est=1)
    assert rec["correct"] is True
    assert rec["ntt_launches_per_step"] == [3, 2]
    assert rec["sharded"]["word_exact"] is True
    assert rec["sharded"]["coeff_shards"] == 8


def test_config6_laplace_on_cpu():
    rec = benchsuite.config6_laplace_n16384_e2e(device="cpu", slots=1024,
                                                runs=1, passes=1)
    assert rec["correct"] is True
    assert set(rec["csv_schema"]) == {"t_keygen", "t_input_encryption",
                                      "t_computation", "t_decryption"}
    assert all(v > 0 for v in rec["csv_schema"].values())
    assert "key_put" not in rec["setup_phase_ms"]
    assert "warmup_ms" in rec and "capture_ms" in rec


def test_run_suite_dict_records_an_error_and_goes_on(monkeypatch):
    def broken(device="cuda"):
        raise ValueError("boom")

    monkeypatch.setitem(benchsuite.CONFIGS, 4, broken)
    out = benchsuite.run_suite_dict([1, 4], device="cpu")
    assert out["config4"]["error"] == "ValueError: boom"
    assert math.isnan(out["config4"]["value"])
    assert out["config1"]["correct"] is True


def test_chain_steps_do_the_whole_op(monkeypatch):
    """The census of a chain step is held against the launch counter: a step
    served from a cache raises."""
    from abc_tpu_torch.ops import ntt_kernels

    class Ctx:
        fresh_caches = staticmethod(contextlib.nullcontext)

    class OnCard:
        is_cuda = True

    def step(v):
        ntt_kernels.launches["ntt_fwd"] += step.fwd
        ntt_kernels.launches["ntt_inv"] += 3
        return v

    before = dict(ntt_kernels.launches)
    try:
        step.fwd = 5
        chain = benchsuite.whole_op_chain(Ctx, step, census=(5, 3))(3)
        assert isinstance(chain(OnCard()), OnCard)
        step.fwd = 3                      # two transforms came from a cache
        with pytest.raises(AssertionError, match="served from a cache"):
            chain(OnCard())
    finally:
        ntt_kernels.launches.update(before)


# ------------------------------------------------- entry and the key-switch A/B

def test_entry_step_on_cpu():
    fn, (a, b) = entry.entry("cpu")
    assert a.shape == b.shape == (2, 6, 8192) and a.dtype == torch.int32
    out = fn(a, b)
    ctx = fn.context
    assert ctx.decode(ctx.decrypt(BfvCiphertext(out)))[:4] == [5, 12, 21, 32]
    assert callable(entry.dryrun_multichip)


def test_hybrid_ks_ab_on_cpu():
    out = hybrid_ks_ab.run("cpu", n=1024, chain=2, k_est=1,
                           log=lambda *a: None)
    assert out["timer"] == "host"
    assert out["k1"]["estimates"] <= 1 and out["k2"]["estimates"] <= 1
    r = out["hybrid_k2_speedup_over_k1"]
    assert math.isnan(r) or r > 0


def test_op_traffic_counts_bytes_from_shapes():
    """The unfused chains' bytes per op: the same torch ops at every batch
    size, bytes that grow with the batch, far above what a fused op moves."""
    from abc_tpu_torch.scripts import op_traffic

    got = op_traffic.count(1024, (1, 4))
    one, four = got["by_batch"]["1"], got["by_batch"]["4"]
    assert one["torch_ops"] == four["torch_ops"] > 300
    assert 3.5 * one["bytes_per_step"] < four["bytes_per_step"] \
        <= 4 * one["bytes_per_step"]
    assert one["bytes_per_op"] > 50 * bench.mult_relin_census(
        1024, got["L"], 1)["bytes"]


# ------------------------------------------------------------ no CPU fallback

@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_bench_raises_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--quick", "--suite", "1"])


@pytest.mark.parametrize("k", [2, 3, 5, 6])
def test_configs_raise_without_a_card(no_card, k):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchsuite.CONFIGS[k]()


def test_suite_entry_and_ab_raise_without_a_card(no_card):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchsuite.run_suite_dict([1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchsuite.config4_cone_rewriting()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hybrid_ks_ab.run()


@pytest.mark.parametrize("enabled", [True, False], ids=["gc_on", "gc_off"])
@pytest.mark.parametrize("raises", [False, True], ids=["ends", "raises"])
def test_capture_holds_the_collector_off(monkeypatch, enabled, raises):
    """utils/timing.capture_graph: the cyclic collector is off for as long as
    torch.cuda.graph's capture runs (a stub here) and back as it was after,
    also when the captured code raises."""
    import gc
    seen = []

    @contextlib.contextmanager
    def graph(g, **kwargs):
        seen.append(("enter", g, kwargs, gc.isenabled()))
        yield
        seen.append(("exit", gc.isenabled()))

    monkeypatch.setattr(torch.cuda, "graph", graph)
    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        with contextlib.suppress(ValueError):
            with timing.capture_graph("g", pool="p") as got:
                assert got == "g" and not gc.isenabled()
                if raises:
                    raise ValueError
        assert gc.isenabled() == enabled
    finally:
        (gc.enable if was else gc.disable)()
    assert seen[0] == ("enter", "g", {"pool": "p"}, False)
    assert seen[1:] == ([] if raises else [("exit", False)])


def test_graph_lifetime_raises_without_a_card(no_card):
    from abc_tpu_torch.scripts import graph_lifetime
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graph_lifetime.main([])


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_graph_of_holds_what_it_reads(cuda):
    """A graph captured on an input that nothing else holds, replayed after
    another capture emptied the allocator's cache: graph_of keeps the input
    alive, so the replay reads it (utils/timing.graph_of's note)."""
    x = torch.arange(1 << 16, device=cuda, dtype=torch.int32)
    want = x * 3 + 1
    g = timing.graph_of(lambda v: v * 3 + 1, x.clone())
    timing.graph_of(lambda v: v + 1, x)      # its capture empties the cache
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(g.output, want)


@pytest.mark.gpu
def test_a_capture_survives_a_collected_graph(cuda):
    """utils/timing.capture_graph with the collector due inside it and a
    graph of an earlier capture that only a reference cycle holds (scripts/
    graph_lifetime.py, "guarded"): the capture holds, its replay is equal,
    the old graph is destroyed after it."""
    from abc_tpu_torch.scripts import graph_lifetime
    assert "replayed equal" in graph_lifetime.collected_in_capture(True)


@pytest.mark.gpu
def test_two_contexts_chain_graphs_replay_in_turns(cuda):
    """hybrid_ks_ab's first form (scripts/graph_lifetime.py, "held"): the
    k=1 and k=2 chain graphs alive together, replayed in turns, equal to
    their eager chains."""
    from abc_tpu_torch.scripts import graph_lifetime
    assert "every replay equal" in graph_lifetime.replay_in_turns(
        "held", rounds=2, log=lambda _: None)

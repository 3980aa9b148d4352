"""chip_smoke.py on the CPU: the census of a captured CUDA graph read from
its node list (cudaGraphDebugDotPrint's text, here written by a stub graph)
and the timing helpers with the profiler replaced by a stub."""

import pytest

import chip_smoke
from abc_tpu_torch.ops import _build


def reading(counts, ms=1.0):
    """A kernel_profile result whose per-call kernel counts are `counts`
    ({kernel name: launches per call})."""
    by_name = {name: ms for name in counts}
    return sum(by_name.values()), sum(counts.values()), by_name, dict(counts)


def census(**per_kernel):
    want = {name: 0 for name in chip_smoke.launch_counts()}
    want.update(per_kernel)
    return want


# kernel symbols as an H100's cudaGraphDebugDotPrint names them
FWD = "_ZN38_GLOBAL__N__6ef05030_6_ntt_cu_74daac2414ntt_fwd_kernelILi3EEEvPKjPjS2_S2_S2_ii"
INV = "_ZN38_GLOBAL__N__6ef05030_6_ntt_cu_74daac2414ntt_inv_kernelEPKjPjS1_S1_S1_S1_S1_iii"
TENSOR = ("_ZN39_GLOBAL__N__5e5558ba_7_behz_cu_012d4fe618behz_tensor_kernelENS"
          "_10TensorBaseES0_xi")
RELIN = ("_ZN45_GLOBAL__N__7cec5a32_12_keyswitch_cu_93d77fa924ks_mod_down_relin"
         "_kernelILi1EEEvPKjPjS2_xxiiiNS_8TailArgsE")
PLAIN_DOWN = ("_ZN45_GLOBAL__N__7cec5a32_12_keyswitch_cu_93d77fa918ks_mod_down"
              "_kernelEPKjPjS1_xxiii")
TORCH = ("_ZN2at6native29vectorized_elementwise_kernelILi4ENS0_11FillFunctor"
         "IiEESt5arrayIPcLm1EEEEvT_T0_T1_")
WALK = census(ntt_fwd=2, ntt_inv=1, behz_tensor=1, ks_mod_down_relin=1)
NODES = [FWD, FWD, INV, TENSOR, RELIN]


def dot(nodes, memsets=0):
    """A graph's node list in cudaGraphDebugDotPrint's verbose form: the
    kernel nodes `nodes` (symbols), `memsets` MEMSET nodes, a chain of
    edges."""
    out = ["digraph dot {", "subgraph cluster_1 {",
           'label="graph_1" graph[style="dashed"];']
    for i, sym in enumerate(nodes):
        out.append(
            f'"graph_1_node_{i}"[style="bold" shape="record" label="{{KERNEL\n'
            f"| {{ID | {i} (topoId: {len(nodes) - i}) | {sym}"
            "\\<\\<\\<96,128,4608\\>\\>\\>}\n"
            "| {{node handle | func handle} | {0x000000000C939FF0 | "
            "0x0000000008B96990}}\n| {cooperative | 0}\n| {priority | 0}\n"
            '}"];\n')
    for j in range(memsets):
        out.append(
            f'"graph_1_node_{len(nodes) + j}"[style="solid" shape="record" '
            'label="{MEMSET\n| {{ID | node handle} | {7 (topoId: 0) | '
            '0x000000000C93A758}}\n| {dptr | 0x7f0000000000}\n}"];\n')
    total = len(nodes) + memsets
    out += [f'"graph_1_node_{i}" -> "graph_1_node_{i + 1}" [headlabel=0];'
            for i in range(total - 1)]
    return "\n".join(out + ["}", "}", ""])


class StubGraph:
    """A captured graph whose debug_dump writes `text` (None: writes
    nothing, as a graph captured without keep_graph)."""

    def __init__(self, text):
        self.text = text

    def debug_dump(self, path):
        if self.text is not None:
            with open(path, "w") as f:
                f.write(self.text)


@pytest.fixture
def build_dir(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    return tmp_path


def test_a_graph_node_list_reads_back():
    """Kernel nodes count by their symbols, other nodes by their type; the
    edges are no nodes."""
    kernels, others = chip_smoke.dot_nodes(dot(NODES + [TORCH], memsets=2))
    assert kernels == {FWD: 2, INV: 1, TENSOR: 1, RELIN: 1, TORCH: 1}
    assert others == {"MEMSET": 2}


@pytest.mark.parametrize("memsets", [0, 1])
def test_a_graph_holding_exactly_the_census_passes(build_dir, memsets):
    """A relinearization's tail counts for ks_mod_down_relin and not for
    ks_mod_down; MEMSET nodes are reported, not counted as kernels; the
    dump is removed after it is read."""
    kernels, other, others = chip_smoke.graph_census(
        StubGraph(dot(NODES, memsets)), WALK, "a replay")
    assert (kernels, other) == (5, {})
    assert others == ({"MEMSET": memsets} if memsets else {})
    assert list(build_dir.iterdir()) == []


@pytest.mark.parametrize("nodes", [NODES[1:], NODES + [INV],
                                   NODES[:-1] + [PLAIN_DOWN]],
                         ids=["short", "extra", "plain_tail"])
def test_a_graph_that_lacks_or_adds_a_kernel_fails(build_dir, nodes):
    with pytest.raises(AssertionError, match="holds the hand-written "
                                             "kernels"):
        chip_smoke.graph_census(StubGraph(dot(nodes)), WALK, "a replay")


def test_a_kernel_that_is_not_hand_written_is_named(build_dir):
    """graph_census returns a library or torch kernel node beside the
    census; op_graph fails on it."""
    _, other, _ = chip_smoke.graph_census(StubGraph(dot(NODES + [TORCH])),
                                          WALK, "a replay")
    assert other == {TORCH: 1}


@pytest.mark.parametrize("text,match", [(None, "was not written"),
                                        (dot([], memsets=1), "no kernel")],
                         ids=["no_dump", "no_kernel"])
def test_an_empty_node_list_fails(build_dir, text, match):
    with pytest.raises(AssertionError, match=match):
        chip_smoke.graph_census(StubGraph(text), WALK, "a replay")


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

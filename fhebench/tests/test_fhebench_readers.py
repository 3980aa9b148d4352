"""The readers' arithmetic on records made by hand: the traced slice's
reduction, a layer's roofline share, and the FHE operations it is
charged."""

from types import SimpleNamespace

import pytest
import torch

from _tiny import REPO  # noqa: F401  (puts the repository on the path)
from fhebench.harness import census, readers, spec, trace
from fhebench.rooflines import bounds, fhe_ops

LAYERS = {"ntt": {"layer": "NTT", "kernels": ["ntt_fwd", "ntt_inv"],
                  "roofline": "ntt"}}
SHAPE = {"n": 16384, "L": 13, "k": 1, "B": 1}


def event(name, start, end, on_device=True):
    device = torch.autograd.DeviceType.CUDA if on_device else \
        torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end))


def test_reduce_profile_merges_and_names_the_gaps():
    events = [event("void ntt_fwd_kernel<1>(...)", 0, 10),
              event("void ntt_inv_kernel<2>(...)", 5, 20),
              event("Memcpy DtoD", 20, 25),
              event("cudaGraphLaunch", 24, 60, on_device=False),
              event("void ntt_fwd_kernel<1>(...)", 55, 65)]
    out = trace.reduce_profile(events, ["ntt_fwd", "ntt_inv"])
    assert out["busy_s"] == pytest.approx(35e-6)
    assert out["window_s"] == pytest.approx(65e-6)
    assert out["mean_s"] == pytest.approx({"ntt_fwd": 10e-6,
                                           "ntt_inv": 15e-6})
    assert out["idle_gaps"] == [["cudaGraphLaunch", pytest.approx(30e-6)]]
    assert trace.reduce_profile([event("Memcpy DtoD", 0, 5)], []) is None


def record(**kw):
    base = dict(phase_ms={}, factory_ms=0.0, layers=LAYERS, shape=SHAPE)
    return readers.RunRecord(**dict(base, **kw))


def test_roofline_share_is_least_time_over_device_time():
    counts = {"operand": 0, "multiply": 0, "decompose": 1, "key_switch": 0,
              "plain_product": 0, "plain_scalar": 0}
    least = fhe_ops.least_ms("ntt", counts, **SHAPE)
    # one forward kernel of 2 x least each, in 1 graph node
    run = record(trace={"mean_s": {"ntt_fwd": 2 * least * 1e-3}},
                 graph_kernels={"ntt_fwd_kernel<1>": 1}, census=counts)
    assert readers.roofline_pct(run, "ntt") == pytest.approx(50.0)
    # a family of the graph that the slice never saw: not measured
    run.graph_kernels["ntt_inv_kernel<1>"] = 1
    assert readers.roofline_pct(run, "ntt") is None


@pytest.mark.parametrize("values,scalar", [([3], True), ([2, 2, 2], True),
                                           ([], True), ([0, 1], False),
                                           ([1, 1, 0], False),
                                           ([0.5, 0.5], True),
                                           ([0.3, 0.7], False),
                                           ([0.3, 0.30000000000000004],
                                            False)])
def test_a_plaintext_of_one_value_is_a_scalar(values, scalar):
    assert census.is_scalar(SimpleNamespace(values=values)) is scalar


@pytest.mark.parametrize("shape", [(16384, 13, 1, 1), (8192, 6, 1, 64)])
def test_a_product_by_a_scalar_needs_no_transform(shape):
    n, L, k, B = shape
    words = B * L * n
    assert fhe_ops.least_ms("ntt", {"plain_scalar": 1}, *shape) == 0
    # the ciphertext read and written once
    assert fhe_ops.least_ms("elementwise", {"plain_scalar": 1}, *shape) \
        == pytest.approx(16 * words / bounds.HBM_BYTES_S * 1e3)
    # a product by a vector transforms the ciphertext both ways, and reads
    # and writes it
    vec = fhe_ops.least_ms("ntt", {"plain_product": 1}, *shape)
    rows = 2 * B * L
    assert vec >= bounds.ntt_bound(n, L, rows, False)[0] + \
        bounds.ntt_bound(n, L, rows, True)[0] - \
        2 * 4 * rows * n / bounds.HBM_BYTES_S * 1e3


def test_ckks_roofline_reads_its_census_by_level():
    counts = {"ckks_multiply@7": 1, "ckks_rescale@7": 1,
              "ckks_plain_scalar@8": 18}
    shape = {"n": 32768, "L": 8, "k": 2, "B": 1}
    least = fhe_ops.least_ms("ntt", counts, **shape)
    assert least == pytest.approx(fhe_ops.least_ms(
        "ntt", {"ckks_multiply@7": 1}, **shape))
    run = record(trace={"mean_s": {"ntt_fwd": 4 * least * 1e-3}},
                 graph_kernels={"ntt_fwd_kernel<1>": 1}, census=counts,
                 shape=shape)
    assert readers.roofline_pct(run, "ntt") == pytest.approx(25.0)


def test_a_quantity_split_by_suffix_has_one_reader():
    cell = spec.load_cell("laplace.single")
    a = spec.reader(cell, "ntt_roofline.single")
    b = spec.reader(cell, "ntt_roofline.batch")
    assert a.__code__.co_code == b.__code__.co_code

"""DSL programs on the port's CKKS (approximate float) backend: the port of
tests/test_runtime_ckks.py. Each program runs through the port's executor and
CkksCiphertextFactory on the CPU and through abc_tpu's with its np64 factory
of the same seed; decrypted values meet the reference test's tolerance
(1e-2), and the output words, levels, scales and op counters are identical
(no tolerance).
"""

import numpy as np
import pytest

from abc_tpu.runtime.ckks_backend import CkksCiphertextFactory as RefFactory
from abc_tpu_torch.runtime.ckks_backend import (CkksCiphertextFactory,
                                                TorchCkksCiphertext)
from abc_tpu_torch.runtime.values import Cleartext
from abc_tpu_torch.utils.datatype import Type
from abc_tpu_torch.utils.errors import RuntimeExecutionError
from helpers import run_program
from test_torch_slice import _run_program_port, _words


def approx(got, expected, tol=1e-2):
    assert len(got) >= len(expected)
    for g, e in zip(got, expected):
        assert abs(g - e) <= tol, f"{got[:len(expected)]} != {expected}"


# name: (inputs, program, outputs, {output: leading decrypted slots})
PROGRAMS = {
    "float_add_mul": (
        "secret double a = {1.5, 2.0, -0.5}; secret double b = {0.5, 0.25, 4.0};",
        "secret double s = a +++ b; secret double p = a *** b;",
        "ys = s; yp = p;",
        {"ys": [2.0, 2.25, 3.5], "yp": [0.75, 0.5, -2.0]}),
    "float_polynomial": (
        "secret double a = {2.0, 3.0};",
        "secret double y = a *** a;",
        "y = y;", {"y": [4.0, 9.0]}),
    "float_rotation": (
        "secret double v = {1.0, 2.0, 3.0, 4.0};",
        "v = rotate(v, 1);",
        "y = v;", {"y": [2.0, 3.0, 4.0]}),
    "plain_minus_ciphertext": (
        "secret double a = {1.0, 2.0}; double p = {10.0, 10.0};",
        "secret double d = p --- a;",
        "y = d;", {"y": [9.0, 8.0]}),
    # plaintext operands at the operand's current scale, a product feeding a
    # multiply (one relin, one rescale), and a rotation of a raw product
    "plain_ops_and_depth_two": (
        "secret double a = {1.0, 2.0, 3.0}; double w = {0.5, 0.5, 2.0};",
        "secret double t = a *** w; t = t +++ 1.0; t = t --- w;"
        "secret double u = (a *** a) *** a; u = rotate(u, 1);",
        "yt = t; yu = u;",
        {"yt": [1.0, 1.5, 5.0], "yu": [8.0, 27.0]}),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_equals_reference_values_and_words(name):
    inputs, program, outputs, expected = PROGRAMS[name]
    port = CkksCiphertextFactory(n=512, levels=3, seed=2, device="cpu")
    ref = RefFactory(n=512, levels=3, seed=2)
    _, pairs = _run_program_port(inputs, program, outputs, port)
    _, ref_pairs = run_program(inputs, program, outputs, ref)
    assert [k for k, _ in pairs] == [k for k, _ in ref_pairs] == \
        list(expected)
    for (ident, value), (_, ref_value) in zip(pairs, ref_pairs):
        assert isinstance(value, TorchCkksCiphertext)
        approx(port.decrypt(value), expected[ident])
        np.testing.assert_array_equal(_words(value), _words(ref_value))
        assert (value.ct.level, value.ct.scale) == \
            (ref_value.ct.level, ref_value.ct.scale)
        assert value.level == ref_value.level
        assert port.decrypt(value) == ref.decrypt(ref_value)
    assert port.context.counters == ref.context.counters


def test_lazy_relin_and_rescale_counts():
    """The CKKS runtime defers relinearization AND rescale: a sum of products
    decrypts directly from the size-3 form — 0 relins, 0 rescales; a product
    that feeds another multiply pays exactly one of each."""
    factory = CkksCiphertextFactory(n=1024, levels=3, seed=4, device="cpu")
    ctx = factory.context

    def enc(vals):
        return factory.create_ciphertext(Cleartext(list(vals), Type.DOUBLE))

    a, b, c, d = (enc([v] * 4) for v in (1.5, 2.0, 3.0, 0.5))
    for k in ctx.counters:
        ctx.counters[k] = 0
    s = a.multiply(b).add(c.multiply(d))        # 1.5*2 + 3*0.5 = 4.5
    assert s.ct.size == 3 and s.level == ctx.params.L
    assert s.ct.scale == ctx.params.scale ** 2  # no rescale either
    got = factory.decrypt(s)[0]
    assert abs(got - 4.5) < 1e-2
    assert ctx.counters["mult"] == 2
    assert ctx.counters["relin"] == 0           # decrypted from size-3

    for k in ctx.counters:
        ctx.counters[k] = 0
    deep = a.multiply(b).multiply(c)            # (1.5*2)*3 = 9
    assert abs(factory.decrypt(deep)[0] - 9.0) < 1e-2
    assert ctx.counters["relin"] == 1           # only the inner product
    assert deep.level == ctx.params.L - 1       # and one rescale


def test_factory_surface():
    factory = CkksCiphertextFactory(n=512, levels=2, seed=1, device="cpu",
                                    scale_bits=27)
    assert factory.slot_count == 256
    assert factory.params.ks_digits == 1 and factory.params.scale == 2 ** 27
    same = CkksCiphertextFactory(context=factory.context)
    assert same.params is factory.params
    x = factory.create_ciphertext(2.5)
    approx(factory.decrypt(x), [2.5] * 3)         # last-element padding
    ys = factory.create_many([[1.0, -1.0], Cleartext([4.0], Type.FLOAT)])
    approx(factory.decrypt(ys[0].clone()), [1.0, -1.0, -1.0])
    approx(factory.decrypt(ys[1]), [4.0, 4.0])
    tensor, meta = factory.jit_pack(x)
    assert meta == (2, float(2 ** 27)) and tensor is x.ct.data
    again = factory.jit_unpack(tensor, meta)
    assert again.ct.data is tensor and again.level == 2
    with pytest.raises(RuntimeExecutionError, match="its own ciphertexts"):
        factory.decrypt(object())

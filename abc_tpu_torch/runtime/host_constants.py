"""Host-made constants of a whole-program run, shared by the BFV and CKKS
factories (runtime/bfv_backend.py, runtime/ckks_backend.py).

A program's evaluation meets values that are made on the host and copied to
the device: plaintext operands and encryptions inside the program. Under
jax.jit these are trace constants. A CUDA graph cannot hold a host copy, so
the whole-program executor (runtime/jit_executor.py) records them from one
eager run and serves them again, in the same order, to the run it captures:
a HostConstants tape, switched on with `factory.host_constants(tape)`.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import torch

from abc_tpu_torch.runtime.backend import AbstractCiphertextFactory
from abc_tpu_torch.utils.errors import RuntimeExecutionError


def zero_pad(data: torch.Tensor, size: int) -> torch.Tensor:
    """Pad a [..., k, L, n] ciphertext component stack with zero
    components."""
    pad = data.new_zeros(tuple(data.shape[:-3]) + (size - data.shape[-3],) +
                         tuple(data.shape[-2:]))
    return torch.cat([data, pad], dim=-3)


class HostConstants:
    """The device values a program run makes from host data, in the order
    the run asks for them. The first run under a tape records; every later
    run gets the recorded values back, each checked against the key it was
    recorded under (the program's control flow is cleartext-driven, so
    every run asks in the same order). The tape keeps the tensors alive for
    as long as a CUDA graph reads them."""

    def __init__(self):
        self.items: list = []
        self._pos: Optional[int] = None          # None: recording

    def take(self, key, make):
        if self._pos is None:
            value = make()
            self.items.append((key, value))
            return value
        if self._pos >= len(self.items) or self.items[self._pos][0] != key:
            raise RuntimeExecutionError(
                "the program asked for another host-made constant than its "
                f"recorded run did at position {self._pos}: whole-program "
                "execution needs cleartext-driven control flow")
        value = self.items[self._pos][1]
        self._pos += 1
        return value

    def end_run(self, completed: bool) -> None:
        """Ready the tape for the next run: a completed recording turns to
        serving, a failed one is forgotten; a served run that left recorded
        values unasked took another path than the recorded one."""
        if self._pos is None:
            if completed:
                self._pos = 0
            else:
                self.items.clear()
            return
        short = completed and self._pos != len(self.items)
        self._pos = 0
        if short:
            raise RuntimeExecutionError(
                "the program asked for fewer host-made constants than its "
                "recorded run did")


class TapedFactory(AbstractCiphertextFactory):
    """A ciphertext factory whose host-made values can go through a
    HostConstants tape: the whole-program protocol's half that does not
    depend on the scheme."""

    def __init__(self):
        self._tape: Optional[HostConstants] = None

    @contextmanager
    def host_constants(self, tape: HostConstants):
        """Run one program run with its plaintext operands and in-program
        encryptions going through `tape`: recorded by the tape's first run,
        served again to every later one."""
        self._tape = tape
        completed = False
        try:
            yield
            completed = True
        finally:
            self._tape = None
            tape.end_run(completed)

    def _host_made(self, key, make):
        return make() if self._tape is None else self._tape.take(key, make)

"""Backend factory interface.

Reference: include/ast_opt/runtime/AbstractCiphertextFactory.h:13-52
(createCiphertext from vector/scalar/Cleartext, decryptCiphertext, getString).
"""

from __future__ import annotations

from typing import Any, List, Sequence, Union

from abc_tpu_torch.runtime.values import AbstractCiphertext, Cleartext


class AbstractCiphertextFactory:
    """Creates/decrypts ciphertexts for one FHE scheme instance."""

    def create_ciphertext(self, value: Union[Cleartext, Sequence[int], int]
                          ) -> AbstractCiphertext:
        raise NotImplementedError

    def decrypt(self, ciphertext: AbstractCiphertext) -> List[int]:
        """Decrypt + decode to the full slot vector."""
        raise NotImplementedError

    def get_string(self, ciphertext: AbstractCiphertext) -> str:
        return str(self.decrypt(ciphertext))

    @property
    def slot_count(self) -> int:
        raise NotImplementedError

    def expand_vector(self, values: Sequence[Any]) -> List[Any]:
        """Pad a value vector to the slot count by repeating the LAST element
        (ref: SealCiphertextFactory::expandVector, SealCiphertextFactory.cpp:102-115)."""
        vals = list(values)
        if len(vals) > self.slot_count:
            raise ValueError(
                f"input size {len(vals)} exceeds slot count {self.slot_count}")
        if vals:
            vals.extend([vals[-1]] * (self.slot_count - len(vals)))
        else:
            vals = [0] * self.slot_count
        return vals

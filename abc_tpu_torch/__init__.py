"""abc_tpu_torch — the PyTorch/CUDA port of abc_tpu's encrypted execution path.

The JAX package `abc_tpu` stays the reference. This package reuses its
JAX-free layers (parser, compiler passes, RuntimeVisitor, parameter presets,
the np64 host half of BFV: keygen, encode, encrypt, decrypt) by import, and
ports the device half: modular arithmetic, the negacyclic NTT (hand-written
CUDA kernels for Hopper, csrc/ntt.cu), BEHZ ct·ct multiplication, key
switching, Galois rotations and the BFV ciphertext factory.

Storage rule: residues are `torch.int32` tensors holding values in [0, q)
with every prime below 2^30; arithmetic widens to int64, and the CUDA
kernels reinterpret the storage as uint32.

Layout:
  ops/modarith.py      — elementwise RNS arithmetic (torch engine)
  ops/ntt_kernels.py   — NTT kernel wrappers + their plain torch versions
  crypto/ntt.py        — NttContext over [..., L, n] residues
  crypto/behz.py       — BEHZ full-RNS ct·ct multiply
  crypto/bfv.py        — BFV evaluation (mult, relin, rotations, plain ops)
  runtime/bfv_backend.py — ciphertext factory for RuntimeVisitor
  convert.py           — context_from_reference: np64 BfvContext → device
"""

__version__ = "0.1.0"

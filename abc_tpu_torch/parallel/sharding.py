"""Sharding of FHE evaluation over a mesh (port of
abc_tpu/parallel/sharding.py).

The mesh's axes (parallel/mesh.py):

  * dp   — data parallelism over a BATCH of ciphertexts (independent rows);
  * limb — key-switch decomposition parallelism: the hybrid key-switch inner
           product Σ_i D_i ⊙ ksk_i contracts over the L decomposition limbs;
           sharding i makes each shard lift, transform and multiply only its
           slice of the switching key, and one modular psum combines the
           [L+1, n] accumulators: the O(L·(L+1)·n) transform and multiply
           work is split over the shards while 2·(L+1)·n words cross the
           interconnect.

The reference's functions are shard_map bodies; here the body is the
context's own key switch in its limb mode (BfvContext.set_limb_sharding),
which runs on this process's shards in the layout of parallel/mesh.py: every
shard of a LocalComm mesh at once (one kernel launch for all of them), one
shard per rank under DistComm. k = 1 only, as in the reference.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from abc_tpu_torch.crypto.bfv import BfvCiphertext, BfvContext
from abc_tpu_torch.parallel.mesh import Mesh, make_local_mesh


def make_mesh(dp: int = 1, limb: int = 1, comm=None, device="cuda") -> Mesh:
    """A ("dp", "limb") mesh: dp × limb shards on `device` (LocalComm), or,
    with comm=DistComm(), the process group's ranks laid out row-major
    (rank = dp index · limb + limb index), which must number dp · limb."""
    if comm is None:
        return make_local_mesh({"dp": dp, "limb": limb}, device)
    if dp * limb != comm.world:
        raise ValueError(f"mesh {dp}x{limb} needs {dp * limb} ranks, the "
                         f"process group has {comm.world}")
    return Mesh(np.arange(dp * limb).reshape(dp, limb), ("dp", "limb"), comm)


def _check_k1(ctx: BfvContext) -> None:
    if ctx.params.ks_digits != 1:
        raise ValueError(
            "limb-sharded key switching implements the k=1 layout; build "
            "the context with ks_digits=1")


def _check(ctx: BfvContext, mesh: Mesh) -> None:
    _check_k1(ctx)
    if ctx.params.L % mesh.shape["limb"]:
        raise ValueError(f"limb mesh axis ({mesh.shape['limb']}) must "
                         f"divide L ({ctx.params.L})")


def _local_key_switch_partials(ctx: BfvContext, d, ksk_b, ksk_a,
                               perm_eval=None) -> Tuple:
    """Per-shard key-switch work: lift + NTT + multiply the shard's
    decomposition limbs, returning partial accumulators over the full base
    (the shard's half of BfvContext._ks_inner in limb mode).

    d:      [..., Lk, n]    the shard's decomposition-limb residues
    ksk_*:  [Lk, L+1, n]    the shard's slice of the switching key
    perm_eval: optional NTT-domain Galois permutation applied to the
               decomposition AFTER its forward NTTs (the hoisted rotation
               formulation, matching BfvContext.apply_galois)
    returns ([..., L+1, n], [..., L+1, n]) partial sums (before the psum)
    """
    _check_k1(ctx)
    D = ctx._lift_ntt(d)
    if perm_eval is not None:
        D = D.index_select(-1, perm_eval)
    return ctx._ks_partials(D, ksk_b, ksk_a)


def _psum_mod(x, q, mesh: Mesh, axis: str):
    """Modular psum: residues x < q < 2^30 summed over the mesh axis (an
    int64 sum reduced once: mesh.psum_mod)."""
    return mesh.psum_mod(x, q, axis)


def sharded_key_switch(ctx: BfvContext, mesh: Mesh, d, ksk) -> Tuple:
    """Key switch with the decomposition axis sharded over mesh axis "limb".

    d: [..., L, n] whole on every process; ksk: ([L, L+1, n], [L, L+1, n])
    whole (each process reads its shards of the digit rows). Returns
    (k0, k1) [..., L, n] coefficient domain, whole on every process."""
    _check(ctx, mesh)
    with ctx.limb_sharded(mesh):
        return ctx._key_switch(d, ksk)


def sharded_rotate_rows(ctx: BfvContext, mesh: Mesh, ct_data, steps: int):
    """Galois rotation with the key-switch contraction sharded over "limb",
    in the HOISTED formulation (decompose the untouched c1, permute the
    decomposition in the NTT domain): the words of the single-device
    BfvContext.rotate_rows. ct_data: [..., 2, L, n]."""
    _check(ctx, mesh)
    with ctx.limb_sharded(mesh):
        return ctx.rotate_rows(BfvCiphertext(ct_data), steps).data

"""A mesh of shards with named axes: the port's counterpart of
jax.sharding.Mesh together with what shard_map gives a kernel body
(axis_index, psum, ppermute) in abc_tpu/parallel/.

A Mesh is a grid of shard ids with one named axis per dimension
(("dp", "limb") or ("coeff",)) and a communicator that says where the shards
live:

* LocalComm: every shard lives in this process, on one device. A sharded
  tensor carries its shards as a tensor axis, so a collective is tensor
  arithmetic on that axis: psum a modular sum over it, axis_index an
  arange; an exchange moves no words (the distributed NTT's combine reads
  each partner shard in place; Mesh.count_permutes counts it). This is
  what the reference's virtual devices were, and the only form one card
  can hold; a program on it can be captured as one CUDA graph.
* DistComm: one shard per rank of torch.distributed, each on its own device
  (under NCCL the card of its index on its machine, the CPU under gloo).
  Every mesh axis is a process subgroup; psum is an int64 all_reduce,
  ppermute a batch_isend_irecv.

The layout rule that makes one body serve both. A tensor [..., R, C]
sharded over an axis of D shards along its rows (dim=-2) is [..., D, R/D, C]
under LocalComm and [..., R/D, C] on a rank; along its columns (dim=-1) it is
[..., D, R, C/D] and [..., R, C/D]. A [..., K, R, C] tensor sharded along
dim=-3 follows the row rule ([..., D, K/D, R, C]). The shard axis is
therefore a batch axis in front of the [R, C] block, and elementwise code
with [R, 1] columns of moduli is the same code on both communicators.
Collectives find the shard axis at dim=-3 (psum, axis_index).

Residues are int32 below 2^30. psum is the mesh kernel rns_psum_mod
(ops/mesh_kernels.py): under LocalComm it adds the shards' residues mod q
along the shard axis; on a rank an int64 all_reduce sums them (any mesh
fits) and the kernel reduces each sum mod q once (the reference splits
uint32 words into 16-bit halves instead; all give the canonical words).

Each mesh keeps a census of the collectives it ran, by the reference's kind
names (parallel/report.py reads it): ops and the bytes one shard puts on
the interconnect per op.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from abc_tpu_torch.ops import mesh_kernels as mk


class LocalComm:
    """All shards of a mesh in this process, on `device`."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device} requested but no CUDA "
                               "device is available")

    def bind(self, mesh: "Mesh") -> None:
        mesh.shard_index = {
            name: torch.arange(size, device=self.device).reshape(size, 1, 1)
            for name, size in mesh.shape.items()}

    def scatter(self, mesh, x, axis, dim):
        D = mesh.shape[axis]
        if dim == -1:
            return x.unflatten(-1, (D, x.shape[-1] // D)).movedim(-2, -3)
        return x.unflatten(dim, (D, x.shape[dim] // D))

    def gather(self, mesh, x, axis, dim):
        if dim == -1:
            return x.movedim(-3, -2).flatten(-2)
        return x.flatten(dim - 1, dim)

    def shard_table(self, mesh, t, axis):
        return t

    def local_slice(self, mesh, axis, size) -> slice:
        return slice(0, size)

    def psum_mod(self, mesh, x, q, axis, out):
        return mk.rns_psum_mod(x, q, out)

    def world_count(self, mesh) -> int:
        ones = torch.ones(mesh.size, dtype=torch.int64, device=self.device)
        return int(ones.sum().item())


def rank_device() -> torch.device:
    """This rank's device: under NCCL the card init_process_group_for made
    current (the rank's index on its machine), under gloo the CPU."""
    import torch.distributed as dist
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class DistComm:
    """One shard per rank of an initialised torch.distributed process group,
    on rank_device()."""

    def __init__(self):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("DistComm needs torch.distributed initialised "
                               "(parallel.mesh.init_process_group_for)")
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.device = rank_device()

    def bind(self, mesh: "Mesh") -> None:
        import torch.distributed as dist
        if mesh.size != self.world:
            raise ValueError(f"a {dict(mesh.shape)} mesh has {mesh.size} "
                             f"shards, the process group {self.world} ranks")
        where = np.argwhere(mesh.grid == self.rank)[0]
        mesh.coord = {name: int(c) for name, c in zip(mesh.axis_names, where)}
        mesh.groups, mesh.group_ranks = {}, {}
        # every rank creates every group, in the same order
        for a, name in enumerate(mesh.axis_names):
            lines = np.moveaxis(mesh.grid, a, -1).reshape(
                -1, mesh.grid.shape[a])
            for line in lines:
                ranks = [int(r) for r in line]
                group = (dist.group.WORLD if sorted(ranks) == ranks
                         and len(ranks) == self.world
                         else dist.new_group(ranks))
                if self.rank in ranks:
                    mesh.groups[name] = group
                    mesh.group_ranks[name] = ranks

    def scatter(self, mesh, x, axis, dim):
        chunk = x.shape[dim] // mesh.shape[axis]
        return x.narrow(dim, mesh.coord[axis] * chunk, chunk)

    def gather(self, mesh, x, axis, dim):
        import torch.distributed as dist
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.shape[axis])]
        dist.all_gather(parts, x, group=mesh.groups[axis])
        mesh.count("all-gather", x.numel() * x.element_size() * len(parts))
        # parts come in the group's rank order (sorted global ranks)
        ranks = mesh.group_ranks[axis]
        order = sorted(ranks)
        return torch.cat([parts[order.index(r)] for r in ranks], dim=dim)

    def shard_table(self, mesh, t, axis):
        return t[mesh.coord[axis]]

    def local_slice(self, mesh, axis, size) -> slice:
        chunk = size // mesh.shape[axis]
        c = mesh.coord[axis]
        return slice(c * chunk, (c + 1) * chunk)

    def psum_mod(self, mesh, x, q, axis, out):
        import torch.distributed as dist
        wide = x.to(torch.int64)
        dist.all_reduce(wide, group=mesh.groups[axis])
        return mk.rns_psum_mod(wide, q, out)

    def ppermute_start(self, mesh, x, axis, pairs):
        import torch.distributed as dist
        ranks = mesh.group_ranks[axis]
        me = mesh.coord[axis]
        x = x.contiguous()
        out = torch.zeros_like(x)
        ops = []
        for src, dst in pairs:
            if src == me:
                ops.append(dist.P2POp(dist.isend, x, ranks[dst]))
            if dst == me:
                ops.append(dist.P2POp(dist.irecv, out, ranks[src]))
        works = dist.batch_isend_irecv(ops) if ops else []

        def wait():
            for w in works:
                w.wait()
            return out
        return wait

    def world_count(self, mesh) -> int:
        import torch.distributed as dist
        one = torch.ones(1, dtype=torch.int64, device=self.device)
        dist.all_reduce(one)
        return int(one.item())


class Mesh:
    """A grid of shards with named axes and a communicator.

    grid: an integer array with one dimension per axis name; its entries are
    the shards' ids (the ranks under DistComm, positions under LocalComm).
    `shape` maps each axis name to its size, as jax's Mesh.shape does."""

    def __init__(self, grid, axis_names: Sequence[str], comm):
        self.grid = np.asarray(grid, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.grid.ndim != len(self.axis_names):
            raise ValueError(f"grid of shape {self.grid.shape} for axes "
                             f"{self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.grid.shape))
        self.size = int(self.grid.size)
        self.comm = comm
        self.device = comm.device
        self.census: Dict[str, Dict[str, int]] = {}
        comm.bind(self)

    @property
    def is_local(self) -> bool:
        return isinstance(self.comm, LocalComm)

    def count(self, kind: str, nbytes: int) -> None:
        entry = self.census.setdefault(kind, {"ops": 0, "bytes": 0})
        entry["ops"] += 1
        entry["bytes"] += int(nbytes)

    # --- layout ----------------------------------------------------------
    def scatter(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """This process's shards of a whole tensor, split along `dim` (-1, -2
        or -3) over `axis`, in the layout of the module note. A view."""
        if x.shape[dim] % self.shape[axis]:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {self.shape[axis]} shards of {axis!r}")
        return self.comm.scatter(self, x, axis, dim)

    def gather(self, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
        """The whole tensor from its shards (the inverse of scatter); an
        all_gather on a rank."""
        return self.comm.gather(self, x, axis, dim)

    def shard_table(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Per-shard table t [D, ...] (first axis: the shard along `axis`) as
        this process uses it: whole under LocalComm (the shard axis then
        lines up with dim -3 of the data when t is [D, R, C]), t[coord] on a
        rank."""
        return self.comm.shard_table(self, t, axis)

    def local_slice(self, axis: str, size: int) -> slice:
        """The indices of a length-`size` axis sharded over `axis` that this
        process holds: all of them under LocalComm."""
        return self.comm.local_slice(self, axis, size)

    def axis_index(self, axis: str):
        """The shard's position along `axis`: a [D, 1, 1] arange under
        LocalComm (aligned with the shard axis at dim -3), an int on a
        rank."""
        if self.is_local:
            return self.shard_index[axis]
        return self.coord[axis]

    # --- collectives -------------------------------------------------------
    def psum_mod(self, x: torch.Tensor, q: torch.Tensor, axis: str,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Σ over the shards of `axis` of residues x < q, reduced mod q (q
        an [L, 1] column of x's last two dims): one launch of the mesh
        kernel (ops/mesh_kernels.py: rns_psum_mod) over the shard axis, or
        on a rank over the words an int64 all_reduce summed. Into `out`
        where given (a view of the result's shape)."""
        per_shard = x.numel() // (self.shape[axis] if self.is_local else 1)
        self.count("all-reduce", per_shard * 8)
        return self.comm.psum_mod(self, x, q, axis, out)

    def ppermute_start(self, x: torch.Tensor, axis: str,
                       pairs: Sequence[Tuple[int, int]]):
        """Start sending this rank's block to its partner (DistComm): pairs
        (src, dst) of positions along `axis`. Returns a function that waits
        and gives the received block; several exchanges may be in flight at
        once."""
        self.count("collective-permute", x.numel() * x.element_size())
        return self.comm.ppermute_start(self, x, axis, pairs)

    def count_permutes(self, x: torch.Tensor, axis: str, chunks: int
                       ) -> None:
        """Count, as ppermute_start does on a rank, `chunks` exchanges that
        together move x's blocks over `axis`: under LocalComm the
        distributed NTT's combine reads each shard's partner where it lies,
        and the exchange still counts as the reference's schedule makes
        it."""
        per_shard = x.numel() // (self.shape[axis] if self.is_local else 1)
        for _ in range(chunks):
            self.count("collective-permute",
                       per_shard // chunks * x.element_size())

    def world_count(self) -> int:
        """Every shard contributes one to a sum: the number that answered."""
        return self.comm.world_count(self)


def same_device(a, b) -> bool:
    """Whether two torch devices name the same device ("cuda" is the
    current CUDA device, index 0 unless set otherwise)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (cur if a.index is None else a.index) == \
        (cur if b.index is None else b.index)


def init_process_group_for(address: str, world: int, rank: int,
                           device: str = "cuda",
                           ranks_per_machine: Optional[int] = None) -> None:
    """torch.distributed for one rank, its backend following its device:
    NCCL on a card, gloo on the CPU. `address` is `host:port` or a `tcp://`
    URL.

    On cuda, the ranks of a machine are `ranks_per_machine` consecutive
    ones (default: the whole world on one machine), and a rank takes the
    card `rank % ranks_per_machine` of its machine. More ranks on a machine
    than it has visible cards raises before any process group exists:
    NCCL refuses two ranks on one GPU, and gloo on CUDA tensors has no
    send/recv, so there is no such mode."""
    import torch.distributed as dist
    kind = torch.device(device).type
    if kind == "cuda":
        per = world if ranks_per_machine is None else int(ranks_per_machine)
        if per < 1 or world % per:
            raise ValueError(f"{world} ranks do not split into machines of "
                             f"{per}")
        have = torch.cuda.device_count()
        if per > have:
            raise RuntimeError(
                f"{per} ranks on one machine on cuda need {per} CUDA "
                f"devices, {have} visible: NCCL refuses two ranks on one GPU "
                "(\"Duplicate GPU detected\"), and gloo on CUDA tensors has "
                "no send/recv for the NTT's exchanges")
        torch.cuda.set_device(rank % per)
        backend = "nccl"
    elif kind == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for device {device!r}")
    url = address if "://" in address else f"tcp://{address}"
    dist.init_process_group(backend, init_method=url, world_size=world,
                            rank=rank)


def make_local_mesh(shape: Dict[str, int], device="cuda") -> Mesh:
    """A mesh of `shape` (axis name → size) on one device."""
    sizes = tuple(shape.values())
    return Mesh(np.arange(int(np.prod(sizes))).reshape(sizes), tuple(shape),
                LocalComm(device))


def coeff_mesh(D: Optional[int] = None, comm=None, device="cuda") -> Mesh:
    """A one-axis ("coeff",) mesh: D shards on one device, or every rank of
    the process group with comm=DistComm()."""
    if comm is None:
        return make_local_mesh({"coeff": D}, device)
    return Mesh(np.arange(comm.world), ("coeff",), comm)

"""The device mesh as ``torch.distributed`` process groups
(counterpart of ``compactfusion_tpu/parallel/mesh.py``).

The JAX package names one mesh axis per parallel dimension and lays the
devices out with ``np.reshape(devices, shape)`` in the axis order
``(dp, cfg, pp, ring, ulysses, tp)``: the trailing axes vary fastest.  Here
the ranks take exactly the places the devices take there
(:func:`rank_grid`), and :func:`make_mesh` builds one process group per
line of ranks along each axis of size > 1.  A collective over an axis is a
collective over this rank's group of that axis.

The backend is the caller's choice: NCCL when each rank has its own GPU;
gloo when several ranks share one GPU (NCCL refuses two ranks on one
device) or run on the CPU.  Under gloo, CUDA tensors travel through host
copies (:meth:`Mesh.wire`).

With ``vae_parallel_size`` the process group holds that many more ranks
after the mesh's (the reference's separate VAE ranks,
``parallel_state.py:297-308``): :func:`make_mesh` gives them no mesh, and
:func:`make_vae_mesh` gives every rank the one-axis ``vae`` mesh of the
tail, which decodes in height bands (``parallel/vae.py``).
"""

from __future__ import annotations

import dataclasses
import queue
import time
import traceback
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from compactfusion_tpu_torch import envs
from compactfusion_tpu_torch.config import ParallelConfig

AXIS_DP = "dp"
AXIS_CFG = "cfg"
AXIS_PP = "pp"
AXIS_RING = "ring"
AXIS_ULYSSES = "ulysses"
AXIS_TP = "tp"

MESH_AXIS_ORDER = (AXIS_DP, AXIS_CFG, AXIS_PP, AXIS_RING, AXIS_ULYSSES, AXIS_TP)
#: the axis of the VAE tail ranks (:func:`make_vae_mesh`)
AXIS_VAE = "vae"


def mesh_shape(parallel: ParallelConfig) -> tuple:
    """Axis sizes in ``MESH_AXIS_ORDER``."""
    p = parallel
    return (p.dp_degree, p.cfg_degree, p.pp_degree, p.ring_degree, p.ulysses_degree, p.tp_degree)


def rank_grid(parallel: ParallelConfig) -> np.ndarray:
    """Global ranks laid out on the mesh: ``grid[dp, cfg, pp, ring, ulysses,
    tp]`` is the rank at those coordinates (the JAX ``make_mesh`` puts
    device i where this puts rank i)."""
    return np.arange(parallel.world_size).reshape(mesh_shape(parallel))


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for part in tree for leaf in _leaves(part)]


def _rebuild(tree, leaves):
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    parts = [_rebuild(part, leaves) for part in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(parts)


def pack_tree(tree):
    """A tensor tree (a tensor, a tuple, a NamedTuple payload) as one uint8
    buffer, leaves largest element size first so each starts aligned to it:
    its bytes are exactly the leaves' bytes (``codecs.payload_nbytes``).
    Returns (buffer, unpack): ``unpack(got)`` rebuilds a tree of the same
    structure, shapes and dtypes, on the leaves' device, from a received
    buffer, or from (W, nbytes) stacked ones as leaves with a leading W
    axis.  Every rebuilt leaf starts 16-byte aligned: one that lies at an
    offset that is not (after a leaf of an odd row count, CogVideoX's 8,775
    or 17,550 rows of bf16 scales) is copied out, since the quant kernels'
    vector plan takes aligned operands only."""
    leaves = _leaves(tree)
    order = sorted(range(len(leaves)), key=lambda i: -leaves[i].element_size())
    flat = torch.cat([leaves[i].contiguous().reshape(-1).view(torch.uint8) for i in order])
    device = leaves[0].device

    def unpack(got):
        got = got.to(device)
        lead = tuple(got.shape[:-1])
        out, off = [None] * len(leaves), 0
        for i in order:
            t = leaves[i]
            n = t.numel() * t.element_size()
            part = got[..., off:off + n].contiguous()
            if part.data_ptr() % 16:
                part = part.clone()
            out[i] = part.view(t.dtype).reshape(lead + tuple(t.shape))
            off += n
        return _rebuild(tree, iter(out))

    return flat, unpack


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of the mesh: its coordinate on every axis and one
    process group per axis of size > 1 (None for size 1)."""

    parallel: ParallelConfig
    rank: int
    backend: Optional[str]
    coords: Dict[str, int]
    groups: Dict[str, Optional[dist.ProcessGroup]]
    #: global ranks of this rank's line along each axis, in axis order
    lines: Dict[str, List[int]]

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def axis_size(self, axis: str) -> int:
        return len(self.lines[axis])

    def peer(self, axis: str, shift: int) -> int:
        """Global rank ``shift`` places along ``axis`` (wrapping)."""
        line = self.lines[axis]
        return line[(self.coords[axis] + shift) % len(line)]

    def wire(self, t: torch.Tensor) -> torch.Tensor:
        """The buffer a collective of this mesh's backend takes for ``t``:
        a host copy of a CUDA tensor under gloo, else ``t`` itself."""
        return t.cpu() if self.backend == "gloo" and t.is_cuda else t

    def all_reduce_sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum of ``t`` over the axis group, on ``t``'s device."""
        if self.axis_size(axis) == 1:
            return t.clone()
        buf = self.wire(t).clone()
        dist.all_reduce(buf, group=self.groups[axis])
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor, axis: str) -> List[torch.Tensor]:
        """Every rank's ``t`` along the axis, in axis order."""
        if self.axis_size(axis) == 1:
            return [t]
        buf = self.wire(t.contiguous())
        parts = [torch.empty_like(buf) for _ in range(self.axis_size(axis))]
        dist.all_gather(parts, buf, group=self.groups[axis])
        return [p.to(t.device) for p in parts]

    def all_to_all(self, t: torch.Tensor, axis: str, split_dim: int, concat_dim: int) -> torch.Tensor:
        """The tiled all-to-all of JAX's ``lax.all_to_all(..., tiled=True)``:
        block i of ``t`` along ``split_dim`` goes to rank i of ``axis``, and
        the blocks this rank receives are concatenated along ``concat_dim``
        in source-rank order.  The blocks travel as one contiguous (U, ...)
        byte buffer (``dist.all_to_all_single``), so gloo's dtype coverage
        does not matter.  ``Mesh.all_to_all.nbytes`` counts the bytes sent
        to the other ranks."""
        n = self.axis_size(axis)
        if n == 1:
            return t
        if t.shape[split_dim] % n:
            raise ValueError(f"all_to_all: dim {split_dim} of {tuple(t.shape)} does not split into {n}")
        blocks = torch.stack(t.chunk(n, dim=split_dim))  # (U, *block), contiguous
        buf = self.wire(blocks.reshape(-1).view(torch.uint8))
        recv = torch.empty_like(buf)
        dist.all_to_all_single(recv, buf, group=self.groups[axis])
        Mesh.all_to_all.nbytes += buf.numel() * (n - 1) // n
        got = recv.to(t.device).view(t.dtype).reshape(blocks.shape)
        return torch.cat(got.unbind(0), dim=concat_dim)

    def all_gather_tree(self, tree, axis: str, async_op: bool = False):
        """Every rank's tensor tree (a tensor, a tuple, a NamedTuple payload)
        along ``axis``, as one tree of the same structure whose leaves have
        a leading axis of size W in source-rank order (JAX's
        ``lax.all_gather`` of a pytree).  The leaves travel as one byte
        buffer (:func:`pack_tree`).  ``async_op``: start the gather and
        return a ``wait()`` that finishes it and returns the tree, so
        compute can run in between.  ``Mesh.all_gather_tree.nbytes`` counts
        the gathered bytes (W times the tree's)."""
        n = self.axis_size(axis)
        flat, unpack = pack_tree(tree)
        buf = self.wire(flat)
        parts = [buf] if n == 1 else [torch.empty_like(buf) for _ in range(n)]
        work = None if n == 1 else dist.all_gather(parts, buf, group=self.groups[axis], async_op=True)
        Mesh.all_gather_tree.nbytes += buf.numel() * n

        def wait():
            if work is not None:
                work.wait()
            return unpack(torch.stack(parts))

        return wait if async_op else wait()

    def send_tree(self, tree, axis: str, index: int) -> None:
        """Send a tensor tree, as one byte buffer (:func:`pack_tree`), to
        the rank at ``index`` of ``axis``."""
        flat, _ = pack_tree(tree)
        dist.send(self.wire(flat), self.lines[axis][index], group=self.groups[axis])

    def recv_tree(self, like, axis: str, index: int):
        """The tree that the rank at ``index`` of ``axis`` sends with
        :meth:`send_tree`: the structure, shapes and dtypes of ``like``, on
        its leaves' device."""
        flat, unpack = pack_tree(like)
        buf = torch.empty(flat.shape, dtype=torch.uint8,
                          device="cpu" if self.backend == "gloo" else flat.device)
        dist.recv(buf, self.lines[axis][index], group=self.groups[axis])
        return unpack(buf)

    def broadcast_tree(self, tree, axis: str, index: int):
        """The tree of the rank at ``index`` of ``axis``, bit for bit, on
        every rank of the axis (JAX's ``psum`` of it masked to that rank).
        Every rank passes a tree of the same structure, shapes and dtypes."""
        if self.axis_size(axis) == 1:
            return tree
        flat, unpack = pack_tree(tree)
        buf = self.wire(flat)
        dist.broadcast(buf, self.lines[axis][index], group=self.groups[axis])
        return unpack(buf)


#: bytes the all-to-alls sent to other ranks since the count was last set to 0
Mesh.all_to_all.nbytes = 0
#: bytes the tree gathers gathered since the count was last set to 0
Mesh.all_gather_tree.nbytes = 0


def make_mesh(parallel: ParallelConfig) -> Optional[Mesh]:
    """Build this rank's mesh.  With ``world_size > 1`` the default process
    group must be initialised (``init_distributed_environment`` or
    ``spawn_local``) with at least ``parallel.world_size`` ranks; every rank
    must call this, in the same order as its other group creations, since
    each group is created collectively.  The groups take the default
    group's backend.  A rank past the mesh's ``world_size`` ranks (the VAE
    tail, :func:`make_vae_mesh`, or a rank the configuration leaves idle, as
    the JAX ``make_mesh`` leaves the devices past its mesh) takes part in
    creating the groups and gets None."""
    grid = rank_grid(parallel)
    world = parallel.world_size
    if world == 1 and not dist.is_initialized():
        rank, backend = 0, None
    else:
        if not dist.is_initialized():
            raise RuntimeError(f"a mesh of {world} ranks needs torch.distributed initialised first")
        rank = dist.get_rank()
        if dist.get_world_size() < world:
            raise ValueError(f"mesh needs {world} ranks, the process group has {dist.get_world_size()}")
        backend = dist.get_backend()
    tail = rank >= world
    where = None if tail else np.argwhere(grid == rank)[0]
    coords, groups, lines = {}, {}, {}
    for ax, name in enumerate(MESH_AXIS_ORDER):
        moved = np.moveaxis(grid, ax, -1).reshape(-1, grid.shape[ax])
        for line in moved:
            members = [int(r) for r in line]
            # every rank creates every group of the axis, in one order
            g = dist.new_group(members) if len(members) > 1 else None
            if rank in members:
                groups[name], lines[name] = g, members
        if not tail:
            coords[name] = int(where[ax])
    return None if tail else Mesh(parallel, rank, backend, coords, groups, lines)


def make_vae_mesh(parallel: ParallelConfig) -> Optional[Mesh]:
    """The VAE tail: ranks ``[world_size, world_size + vae_parallel_size)``
    of the process group as one group (the JAX ``make_vae_mesh``; reference
    ``parallel_state.py:297-308``), None without VAE ranks.  Every rank
    calls it after :func:`make_mesh` (the group is created collectively).
    On a tail rank it is a one-axis mesh (``AXIS_VAE``) whose coordinate is
    the rank's band; on a DiT rank the coordinate is -1 and the group None,
    and ``lines[AXIS_VAE]`` names the tail's ranks for the hand-off."""
    n = parallel.vae_parallel_size
    if n == 0:
        return None
    world = parallel.world_size
    if not dist.is_initialized():
        raise RuntimeError(f"VAE ranks need torch.distributed initialised first ({world} + {n} ranks)")
    if dist.get_world_size() < world + n:
        raise ValueError(f"{world} DiT ranks and {n} VAE ranks need {world + n} ranks, the process group "
                         f"has {dist.get_world_size()}")
    rank = dist.get_rank()
    members = list(range(world, world + n))
    g = dist.new_group(members) if n > 1 else None
    mine = rank in members
    return Mesh(parallel, rank, dist.get_backend(), {AXIS_VAE: rank - world if mine else -1},
                {AXIS_VAE: g if mine else None}, {AXIS_VAE: members})


def init_distributed_environment(backend: str, device: str = "cuda") -> torch.device:
    """Join the process group that ``torchrun`` describes (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``) and bind this
    rank's device.  ``backend``: "nccl" with one GPU per rank, "gloo"
    otherwise.  ``device``: "cuda" binds ``cuda:<local_rank % device_count>``
    and raises ``RuntimeError`` where no CUDA device is visible; "cpu" keeps
    the rank on the CPU.  A single process (no ``WORLD_SIZE`` or 1) joins no
    group.  Returns the device."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    world = envs.WORLD_SIZE or 1
    rank = envs.RANK or 0
    local = rank if envs.LOCAL_RANK is None else envs.LOCAL_RANK
    if device == "cpu":
        bound = torch.device("cpu")
    elif not torch.cuda.is_available():
        raise RuntimeError("init_distributed_environment: no CUDA device is visible to this rank; "
                           "pass device='cpu' to run it on the CPU")
    else:
        bound = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(bound)
    if world > 1 and not dist.is_initialized():
        addr, port = envs.MASTER_ADDR, envs.MASTER_PORT
        if addr is None or port is None:
            raise KeyError("MASTER_ADDR and MASTER_PORT must be set for WORLD_SIZE > 1")
        dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}", rank=rank,
                                world_size=world)
    return bound


def _rank_main(fn, rank, world_size, backend, port, args, threads, results):
    ok = False
    try:
        if threads:
            torch.set_num_threads(threads)
        if torch.cuda.is_available():
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.TCPStore("127.0.0.1", port, is_master=False)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
        results.put((rank, True, fn(rank, world_size, *args)))
        ok = True
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    if ok:
        dist.destroy_process_group()
    else:
        raise SystemExit(1)


def spawn_local(fn, world_size: int, backend: str, *args, threads: Optional[int] = None,
                timeout: float = 3600.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes
    joined in one process group of ``backend``, on this host; returns their
    results in rank order.

    The rendezvous store binds port 0, so the OS picks a free port and
    concurrent callers never collide.  ``fn`` must be picklable (a module
    level function) and return picklable CPU data.  Each rank binds
    ``cuda:<rank % device_count>`` where there is a GPU; ``threads`` sets
    each rank's torch CPU threads.  If a rank fails, the others are stopped
    and a RuntimeError carries its traceback."""
    import torch.multiprocessing as mp

    store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, backend, store.port, args, threads, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout
    try:
        while len(out) < world_size:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} before returning")
                if time.monotonic() > deadline:
                    raise RuntimeError(f"ranks timed out after {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
    return [out[r] for r in range(world_size)]

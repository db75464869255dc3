"""Tensor-parallel groups of the engine, and a launcher for their ranks.

Counterpart of ``repro.launch.mesh``'s engine half: :func:`engine_group`
is ``engine_mesh`` (one group per tensor-parallel degree, cached, so
every tp=k instance of a process shares it) and
:func:`make_engine_shard_ctx` is ``make_engine_shard_ctx``.  The
reference's per-instance mesh is a set of JAX devices; here it is a set
of ``torch.distributed`` ranks, each a process that runs the same host
code over its own shard (SPMD).  A process group needs its ranks
launched first: :func:`spawn` starts them (``torch.multiprocessing``,
"spawn", a file store in a temporary directory), as ``torchrun
--nproc-per-node k`` would.  The backend is named by the caller, never
chosen by what the machine has: NCCL for one rank per card, gloo on the
CPU and for ranks that share one card (NCCL refuses two ranks on one
device).

The production (Megatron) layout's half: :func:`make_production_mesh`,
:func:`small_mesh` and :func:`make_shard_ctx`.  A :class:`Mesh` here is
the shape of the reference's JAX mesh (its axis names and sizes) laid
over the ranks of this process group, as
``jax.sharding.Mesh(np.array(devices).reshape(shape), axes)`` lays
devices: rank r sits at the row-major coordinates of r, ``model``
fastest (:func:`rank_coords`).  It carries one process group per axis
as this rank sees it: the ``model`` group (the ranks that differ only in
their ``model`` index), the ``data`` group (the FSDP group), the
``pod`` group, and the data-parallel group over ``pod`` and ``data``
(the ranks with this rank's ``model`` index), which sums the batch's
terms and the gradients.  Every rank creates every group in the same
order, as ``torch.distributed.new_group`` requires.  The mesh functions
take a process group of exactly the mesh's ranks and raise otherwise;
:func:`make_production_mesh` raises, as the reference's
``_check_devices`` does, when the process group has too few ranks.
"""
from __future__ import annotations

import os
import tempfile
from functools import lru_cache
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.sharding import ShardCtx

LAUNCH_HINT = ("launch one process per rank and join them with "
               "torch.distributed.init_process_group first: "
               "repro_torch.launch.mesh.spawn(fn, world=k, backend=...) "
               "or torchrun --nproc-per-node k")


def _world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def _check_ranks(needed: int, what: str) -> None:
    have = _world()
    if needed > have:
        raise ValueError(f"{what} needs {needed} ranks but this process "
                         f"group has {have}; {LAUNCH_HINT}")


@lru_cache(maxsize=None)
def engine_group(tp: int) -> ShardCtx:
    """The tensor-parallel group of one rollout ``Instance`` of degree
    ``tp``, as this rank sees it, with the engine's exact context.

    tp = 1 is a one-rank group: no collective runs.  tp > 1 is the
    whole process group, which must have exactly tp ranks.  Cached per
    degree: every tp=k instance shares one group and one set of step
    functions."""
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if tp == 1:
        return make_engine_shard_ctx(None, 1, 0)
    _check_ranks(tp, f"engine group (tp={tp})")
    import torch.distributed as dist
    if dist.get_world_size() != tp:
        raise ValueError(f"tp={tp} runs on a process group of exactly {tp} "
                         f"ranks, not {dist.get_world_size()}")
    backend = dist.get_backend()
    # the lockstep digests are host tensors: a gloo group carries them
    host = dist.group.WORLD if backend == "gloo" else dist.new_group(
        backend="gloo")
    return make_engine_shard_ctx(dist.group.WORLD, tp, dist.get_rank(),
                                 host_group=host, backend=backend)


def make_engine_shard_ctx(group, tp_size: int, rank: int, *,
                          host_group=None, backend: str = "gloo"
                          ) -> ShardCtx:
    """The engine hot path's context: column-parallel weights and KV
    heads over the group, batch and sequence replicated (``dp=()``,
    ``seq_shard=False``), and ``exact`` execution, so a tp>1 step samples
    bitwise the same tokens as one device."""
    return ShardCtx(group=group, tp_size=tp_size, rank=rank,
                    host_group=host_group, backend=backend, dp=(),
                    fsdp=None, seq_shard=False, exact=True)


class Mesh(NamedTuple):
    """A production mesh: ``shape`` the size of each axis of
    ``axis_names`` (the reference's mesh arguments), and as this rank
    sees it: ``group`` the process group of the ``model`` axis and
    ``rank`` this rank's index in it, ``coords`` its index on every axis,
    ``data_group`` / ``pod_group`` the groups along ``data`` / ``pod``,
    ``dp_group`` the data-parallel group over both and ``dp_rank`` this
    rank's place in it (row-major).  A group is None where its axes span
    one rank."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    group: object = None
    rank: int = 0
    backend: str = "gloo"
    coords: Tuple[int, ...] = ()
    data_group: object = None
    pod_group: object = None
    dp_group: object = None
    dp_rank: int = 0

    def size(self, axis: str) -> int:
        return dict(zip(self.axis_names, self.shape)).get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's index on ``axis``."""
        return dict(zip(self.axis_names, self.coords)).get(axis, 0)


def rank_coords(shape, rank: int) -> Tuple[int, ...]:
    """Rank ``rank``'s index on each axis of a mesh of ``shape``:
    row-major, the last axis fastest, as a JAX mesh built from
    ``np.array(devices).reshape(shape)`` places device ``rank``."""
    out = []
    for n in reversed(tuple(shape)):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def axis_groups(shape, axes, along) -> list:
    """The ranks of a mesh of ``shape`` on ``axes`` grouped along the
    axes ``along``: each group the ranks that share every other index,
    in increasing order (row-major over ``along``); the groups in the
    order of their first rank."""
    along = [axes.index(a) for a in along if a in axes]
    world = 1
    for n in shape:
        world *= n
    groups: dict = {}
    for r in range(world):
        c = rank_coords(shape, r)
        key = tuple(x for i, x in enumerate(c) if i not in along)
        groups.setdefault(key, []).append(r)
    return list(groups.values())


def _mesh(shape, axes, what: str) -> Mesh:
    """A mesh of ``shape`` over this process group, which must have
    exactly its ranks."""
    needed = 1
    for n in shape:
        needed *= n
    _check_ranks(needed, what)
    if needed == 1:
        return Mesh(tuple(shape), tuple(axes), coords=(0,) * len(shape))
    if _world() != needed:
        raise ValueError(f"{what}: a mesh of {needed} ranks runs on a "
                         f"process group of exactly {needed} ranks, not "
                         f"{_world()}")
    return _groups(tuple(shape), tuple(axes))


@lru_cache(maxsize=None)
def _groups(shape, axes) -> Mesh:
    """The mesh with this rank's group along each axis, made once per
    shape: every rank creates every group of more than one rank, in the
    same order (a group of the whole process group is the world's own);
    groups of the same ranks are one group."""
    import torch.distributed as dist
    me = dist.get_rank()
    world = dist.get_world_size()
    made: dict = {}

    def mine(along):
        found = None
        for ranks in axis_groups(shape, axes, along):
            if len(ranks) == 1:
                continue
            key = tuple(ranks)
            if key not in made:
                made[key] = (dist.group.WORLD if len(ranks) == world
                             else dist.new_group(list(ranks)))
            if me in ranks:
                found = made[key]
        return found
    coords = rank_coords(shape, me)
    at = dict(zip(axes, coords))
    dp_rank = 0
    for a in ("pod", "data"):
        if a in axes:
            dp_rank = dp_rank * shape[axes.index(a)] + at[a]
    return Mesh(shape, axes, mine(("model",)), at.get("model", 0),
                dist.get_backend(), coords, mine(("data",)), mine(("pod",)),
                mine(("pod", "data")), dp_rank)


def make_mesh(shape, axes) -> Mesh:
    """A mesh of ``shape`` on the axes ``axes`` (of "pod", "data",
    "model") over this process group, which must have exactly its ranks
    (the reference's ``jax.sharding.Mesh`` of as many devices)."""
    return _mesh(tuple(shape), tuple(axes), f"mesh {tuple(shape)}")


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's pod mesh, (data=16, model=16), or with ``multi_pod``
    (pod=2, data=16, model=16): 256 or 512 ranks, which this process
    group must have."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, f"production mesh {shape}")


def small_mesh(n_model: Optional[int] = None) -> Mesh:
    """A debug mesh over the ranks there are: (world // m, m) on
    ("data", "model") with m = ``n_model`` (default 1)."""
    n = _world()
    m = n_model or 1
    what = f"small mesh (model={m})"
    _check_ranks(m, what)
    return _mesh((n // m, m), ("data", "model"), what)


def make_shard_ctx(mesh: Mesh, *, train: bool,
                   seq_shard_prefill: bool = False) -> ShardCtx:
    """The production context on ``mesh``: batch over its ``pod`` /
    ``data`` axes (the data-parallel group), tensor parallelism on
    ``model``, the ``embed`` axis on ``data`` in training (FSDP, with the
    ``data`` group), and the residual stream split along the sequence in
    training (or in prefill with ``seq_shard_prefill``)."""
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return ShardCtx(group=mesh.group, tp_size=mesh.size("model"),
                    rank=mesh.rank,
                    host_group=mesh.group if mesh.backend == "gloo" else None,
                    backend=mesh.backend, dp=dp, tp="model",
                    fsdp="data" if train else None,
                    seq_shard=train or seq_shard_prefill, exact=False,
                    axis_sizes=tuple((a, mesh.size(a)) for a in dp),
                    coords=tuple((a, mesh.index(a)) for a in dp),
                    dp_group=mesh.dp_group, dp_rank=mesh.dp_rank,
                    fsdp_group=mesh.data_group if train else None,
                    pod_group=mesh.pod_group)


def _rank_main(rank: int, fn: Callable, world: int, backend: str,
               device: str, store: str, args: tuple) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        fn(rank, world, dev, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *, backend: str, device: str,
          args: tuple = ()) -> None:
    """Run ``fn(rank, world, device, *args)`` in ``world`` fresh
    processes joined in one process group over ``backend`` ("gloo" or
    "nccl"), each on ``device``: "cpu", "cuda" (rank r on card r) or
    "cuda:i" (every rank on card i; gloo only).  ``fn`` must be
    importable by name (a module-level function), and takes one thread
    per rank.  Returns when every rank has; raises if one failed."""
    import torch.multiprocessing as mp
    if backend == "nccl" and ":" in device:
        raise ValueError("NCCL takes one rank per card; ranks that share "
                         "a card need backend='gloo'")
    with tempfile.TemporaryDirectory(prefix="tp_store_") as tmp:
        store = os.path.join(tmp, "store")
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, backend, device, store, args),
            nprocs=world, join=False, start_method="spawn")
        while not ctx.join():
            pass

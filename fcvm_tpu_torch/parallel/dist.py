"""The process group of the multi-device backend and its collectives.

The JAX package drives an ``N``-device mesh from one process
(``jax.sharding.Mesh``, ``shard_map``, ``psum``) and joins hosts through
``jax.distributed.initialize``.  The port runs one process per device
instead, joined by ``torch.distributed``:

* the backend is ``"nccl"`` on CUDA and ``"gloo"`` on the CPU;
* each rank owns ``cuda:local_rank`` (``LOCAL_RANK`` from a ``torchrun``
  launch, else the rank), or a device the caller names, or the CPU;
* the group starts from ``env://`` (a ``torchrun`` launch), from a
  ``tcp://`` address, or, for a world of one, from a free localhost port.

Gloo on CUDA tensors (two ranks sharing one card, where NCCL refuses) is
chosen explicitly, once, when the group starts: every collective then
stages its tensor through a host copy (``Group.staged``).  Nothing falls
back from one way to the other at run time.

The collectives the backend uses are :func:`all_reduce` (sum),
:func:`all_gather` and :func:`reduce_scatter` along the first axis, and
:func:`broadcast` from rank 0.  Without a group each is the identity, as a
``psum`` over a one-device mesh is.  :func:`spawn` starts a local world of
ranks, each in its own process, and returns what each rank's function
returned.
"""

from __future__ import annotations

import os
import queue
import socket
import time
import traceback
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

# torch >= 2.13 names the single-tensor forms *_single and warns on the old
# names; older releases have only the old ones
_ALL_GATHER = getattr(tdist, "all_gather_single", None) or tdist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(tdist, "reduce_scatter_single", None) or tdist.reduce_scatter_tensor


class Group(NamedTuple):
    """The process group as this rank sees it."""

    rank: int
    world_size: int
    device: torch.device  # this rank's device
    backend: str  # "nccl" or "gloo"
    staged: bool  # gloo on CUDA tensors: every collective goes through the host


_group: Optional[Group] = None


def free_port() -> int:
    """A free TCP port on localhost (for a local rendezvous)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_process_group(device="cuda", backend: Optional[str] = None,
                       init_method: Optional[str] = None, world_size: Optional[int] = None,
                       rank: Optional[int] = None) -> Group:
    """Start the process group of this rank and pick its device.

    Args:
      device: ``"cuda"`` (this rank's card, ``cuda:local_rank``), ``"cuda:k"``
        (card ``k``, which ranks may share only over gloo), or ``"cpu"``.
      backend: ``None`` = ``"nccl"`` on CUDA, ``"gloo"`` on the CPU;
        ``"gloo"`` on CUDA stages every collective through the host.
      init_method: ``"env://"`` (``torchrun``'s ``MASTER_ADDR``, ``RANK``,
        ``WORLD_SIZE``), ``"tcp://host:port"``, or ``None``: ``env://`` when
        ``MASTER_ADDR`` is set, else a world of one on a free localhost port.
      world_size, rank: for ``tcp://`` (``env://`` reads them from the
        environment).

    Raises when a group is already running, or when this rank's card does
    not exist: a world never runs on fewer devices than it asked for.
    """
    global _group
    if _group is not None or tdist.is_initialized():
        raise RuntimeError("a process group is already running in this process")
    if init_method is None:
        if "MASTER_ADDR" in os.environ:
            init_method = "env://"
        elif world_size in (None, 1):
            init_method, world_size, rank = f"tcp://127.0.0.1:{free_port()}", 1, 0
        else:
            raise ValueError(f"world_size={world_size} needs an init_method "
                             "(env:// or tcp://host:port)")
    if init_method == "env://":
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise ValueError("env:// needs RANK and WORLD_SIZE in the environment (a "
                             "torchrun launch), or give --coordinator")
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    dev = torch.device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        idx = dev.index if dev.index is not None else int(os.environ.get("LOCAL_RANK", rank))
        if idx >= count:
            raise RuntimeError(
                f"rank {rank} of {world_size} asks for cuda:{idx}, found {count} CUDA "
                "device(s); launch at most one rank per card")
        torch.cuda.set_device(idx)
        dev = torch.device("cuda", idx)
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda', 'cuda:k' or 'cpu', got {device!r}")
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo") or (backend == "nccl" and dev.type != "cuda"):
        raise ValueError(f"backend {backend!r} on {dev}")
    tdist.init_process_group(backend, init_method=init_method, world_size=world_size,
                             rank=rank)
    _group = Group(tdist.get_rank(), tdist.get_world_size(), dev, backend,
                   backend == "gloo" and dev.type == "cuda")
    return _group


def destroy_process_group() -> None:
    global _group
    if _group is not None:
        tdist.destroy_process_group()
        _group = None


def group() -> Optional[Group]:
    """The running group, or ``None``."""
    return _group


def rank() -> int:
    """This process's rank; 0 without a group."""
    return 0 if _group is None else _group.rank


def world_size() -> int:
    return 1 if _group is None else _group.world_size


def require(world: int, device: torch.device) -> Group:
    """The group of a sharded run of ``world`` ranks on ``device``'s type.

    A world of one starts its own group when none is running; a larger one
    must have been started (:func:`spawn`, the CLI's ``--devices`` or
    ``--distributed``, or :func:`init_process_group` on every rank).  Raises
    when the running group has another size or device type."""
    g = _group
    if g is None:
        if world > 1:
            raise RuntimeError(
                f"n_devices={world} needs a process group of {world} ranks and none is "
                "running: launch with `python -m fcvm_tpu_torch run --devices N`, "
                "torchrun ... -m fcvm_tpu_torch run --distributed, or call "
                "fcvm_tpu_torch.parallel.dist.init_process_group on every rank")
        g = init_process_group(device)
    if g.world_size != world:
        raise RuntimeError(f"requested {world} devices, the process group has "
                           f"{g.world_size} ranks")
    if g.device.type != torch.device(device).type:
        raise RuntimeError(f"the analysis asks for {device}, this rank's group runs on "
                           f"{g.device}")
    return g


def _staged(t: torch.Tensor):
    return _group.staged and t.device.type == "cuda"


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place; returns ``t``."""
    if _group is None:
        return t
    if _staged(t):
        h = t.cpu()
        tdist.all_reduce(h)
        return t.copy_(h)
    tdist.all_reduce(t)
    return t


def broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank, in place; returns ``t``."""
    if _group is None:
        return t
    if _staged(t):
        h = t.cpu()
        tdist.broadcast(h, src)
        return t.copy_(h)
    tdist.broadcast(t, src)
    return t


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """The ranks' ``t`` concatenated along the first axis, rank order."""
    if _group is None:
        return t
    t = t.contiguous()
    dev = torch.device("cpu") if _staged(t) else t.device
    out = torch.empty((_group.world_size * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=dev)
    _ALL_GATHER(out, t.to(dev))
    return out.to(t.device)


def reduce_scatter(t: torch.Tensor) -> torch.Tensor:
    """This rank's slice (along the first axis) of the sum of ``t`` over
    the ranks; the first axis must divide by the world size."""
    if _group is None:
        return t
    n = _group.world_size
    if t.shape[0] % n:
        raise ValueError(f"reduce_scatter: {t.shape[0]} rows do not divide by {n} ranks")
    t = t.contiguous()
    dev = torch.device("cpu") if _staged(t) else t.device
    out = torch.empty((t.shape[0] // n,) + tuple(t.shape[1:]), dtype=t.dtype, device=dev)
    _REDUCE_SCATTER(out, t.to(dev))
    return out.to(t.device)


def _rank_main(rank_id, fn, world, port, device, backend, threads, args, results):
    if threads:
        torch.set_num_threads(threads)
    try:
        init_process_group(device, backend, f"tcp://127.0.0.1:{port}", world, rank_id)
        results.put((rank_id, True, fn(*args)))
    except BaseException:
        results.put((rank_id, False, traceback.format_exc()))
        raise
    finally:
        destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (), device="cpu",
          backend: Optional[str] = None, threads: Optional[int] = None,
          timeout: float = 3600.0) -> list:
    """Run ``fn(*args)`` on ``world`` local ranks, each a new process with
    its group started (:func:`init_process_group` with ``device`` and
    ``backend`` on a free localhost port), and return each rank's return
    value, rank order.  ``fn`` and its results must pickle.  A rank that
    raises, dies or outlives ``timeout`` seconds stops every rank and
    raises here.  ``threads``: intra-op threads per rank (default: the
    host's cores shared out on the CPU, untouched on CUDA)."""
    if threads is None and torch.device(device).type == "cpu":
        threads = max(1, (os.cpu_count() or 1) // world)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=False,
                         args=(r, fn, world, port, device, backend, threads, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, deadline, failure = {}, time.monotonic() + timeout, None
    try:
        while len(out) < world and failure is None:
            try:
                r, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [i for i, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and i not in out]
                if dead:
                    failure = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                elif time.monotonic() > deadline:
                    failure = f"ranks still running after {timeout:.0f} s"
                continue
            if ok:
                out[r] = value
            else:
                failure = f"rank {r} raised:\n{value}"
    finally:
        if failure is not None:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join()
    if failure is not None:
        raise RuntimeError(f"spawned world of {world} failed: {failure}")
    return [out[r] for r in range(world)]

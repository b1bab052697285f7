"""Rank meshes over ``torch.distributed`` (the twin of the JAX package's
``launch/mesh.py``).

One process is one device of the reference's mesh.  :func:`make_mesh`
lays the world's ranks out row-major over named axes, as a JAX mesh
built from its devices in order does, and makes a process group for
every axis and every tuple of axes: the ranks that share every other
coordinate.  A group's rank is then the row-major index over its axes,
which is what ``jax.lax.axis_index(axes)`` gives inside a shard_map.

:func:`launch` spawns one process a rank with a ``file://`` store (no
network) and returns each rank's result.  The backend is chosen
explicitly and printed.  On one card every rank runs on ``cuda:0``:
NCCL refuses two ranks on one device, so the group is gloo, which
takes CUDA tensors and stages them through the host itself.  Asking
for NCCL with more ranks than cards raises.  Entry points run on the
card unless the caller asks for the CPU.
"""
from __future__ import annotations

import itertools
import math
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Callable, Tuple

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
# the allocator setting of ranks that share a card: four caching
# allocators on one H100 reserved 82.4 GB with fixed segments at 12.2-21.7
# GB held a rank (qwen3-0.6b, chip_smoke phase 7i)
SHARED_CARD_ALLOC = "expandable_segments:True"


class Mesh:
    """This rank's view of a mesh of ranks: the axis names and sizes,
    its coordinates, its device, and a process group for every tuple of
    axes (in mesh order)."""

    def __init__(self, shape, axis_names, rank: int, groups: dict,
                 device: torch.device, backend: str):
        self.shape = tuple(shape)
        self.axis_names = tuple(axis_names)
        self.rank = rank
        self.coords = dict(zip(self.axis_names,
                               np.unravel_index(rank, self.shape)))
        self.groups = groups
        self.device = device
        self.backend = backend

    @property
    def sizes(self) -> dict:
        return dict(zip(self.axis_names, self.shape))

    def _axes(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown:
            raise ValueError(f"axes {unknown} not in mesh {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def size(self, axes) -> int:
        """The number of ranks along ``axes`` (1 for no axes)."""
        return math.prod(self.sizes[a] for a in self._axes(axes))

    def index(self, axes) -> int:
        """This rank's row-major index over ``axes``
        (``jax.lax.axis_index(axes)``)."""
        idx = 0
        for a in self._axes(axes):
            idx = idx * self.sizes[a] + int(self.coords[a])
        return idx

    def group(self, axes):
        """The process group over ``axes`` that holds this rank."""
        return self.groups[self._axes(axes)]


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device=None) -> Mesh:
    """This rank's :class:`Mesh` of ``shape`` over ``axes`` in the
    initialised world (whose size must be the product of ``shape``).
    Every rank makes every group, in the same order, as
    ``torch.distributed.new_group`` requires.  ``device`` defaults to
    ``cuda:rank % cards`` (every rank on ``cuda:0`` on one card) and
    raises without a card; the CPU runs only when the caller passes
    ``device="cpu"``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(launch() makes one a rank)")
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} do not match")
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the "
                         f"world has {world}")
    if device is None:
        from .. import resolve_device
        resolve_device("cuda")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    backend = dist.get_backend()
    groups = {}
    for r in range(1, len(axes) + 1):
        for sub in itertools.combinations(range(len(axes)), r):
            rest = [i for i in range(len(axes)) if i not in sub]
            for fixed in itertools.product(*(range(shape[i]) for i in rest)):
                coord = [0] * len(axes)
                for i, c in zip(rest, fixed):
                    coord[i] = c
                ranks = []
                for inner in itertools.product(*(range(shape[i])
                                                 for i in sub)):
                    for i, c in zip(sub, inner):
                        coord[i] = c
                    ranks.append(int(np.ravel_multi_index(coord, shape)))
                g = dist.new_group(ranks, backend=backend)
                if rank in ranks:
                    groups[tuple(axes[i] for i in sub)] = g
                    # row-major ranks are ascending, so a group's rank is
                    # the row-major index over its axes
                    if dist.get_rank(g) != ranks.index(rank):
                        raise RuntimeError(f"group {ranks}: rank order")
    return Mesh(shape, axes, rank, groups, torch.device(device), backend)


def parse_mesh(spec: str) -> tuple:
    """``"4"`` -> ((4,), ("data",)); ``"2x2"`` -> ((2, 2), ("data",
    "model")): the JAX launcher's ``--mesh`` spelling."""
    shape = tuple(int(x) for x in spec.split("x"))
    if len(shape) > 2 or min(shape) < 1:
        raise ValueError(f"mesh {spec!r}: give N or NxM (data x model)")
    return shape, ("data", "model")[:len(shape)]


def worker_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Mesh axes that index Byzantine workers in the global scope: every
    axis but 'model' (a 'model' axis splits a worker's leaves)."""
    return tuple(a for a in mesh.axis_names if a != "model")


def n_workers(mesh: Mesh) -> int:
    return mesh.size(worker_axes(mesh))


# ---------------------------------------------------------------------------
# the rank launcher
# ---------------------------------------------------------------------------

def check_backend(backend: str, world: int, device: str) -> None:
    """Refuse a backend the ranks cannot run: an unknown one, or NCCL
    with more ranks than cards (NCCL refuses two ranks on one device)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from "
                         f"{BACKENDS}")
    if backend == "nccl":
        if torch.device(device).type != "cuda":
            raise ValueError("the nccl backend needs device='cuda'")
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(
                f"nccl refuses two ranks on one device: {world} ranks on "
                f"{cards} card(s); use backend='gloo'")


def _rank_main(rank, world, init_file, backend, device, threads, fn, args,
               results):
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            from .. import resolve_device
            resolve_device("cuda")
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                rank=rank, world_size=world)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn: Callable, world: int, args=(), backend: str = "gloo",
           device: str = "cuda", threads: int = 0,
           timeout_s: float = 1800.0, verbose: bool = True) -> list:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes, each in an
    initialised process group of ``backend`` over a ``file://`` store,
    and return the results in rank order.  ``fn`` and its arguments and
    result are pickled (a module-level function).  ``device="cuda"``
    (the default) needs a card; ``threads`` > 0 sets each rank's torch
    thread count.  A rank that raises, dies or outlasts ``timeout_s``
    fails the call (every rank is stopped).  Ranks that share a card
    get growable allocator segments (``PYTORCH_CUDA_ALLOC_CONF``, unless
    the caller set it), so that each caching allocator reserves near
    what its rank holds."""
    check_backend(backend, world, device)
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the ranks on the CPU")
    env = {}
    if (torch.device(device).type == "cuda"
            and world > torch.cuda.device_count()
            and "PYTORCH_CUDA_ALLOC_CONF" not in os.environ):
        env["PYTORCH_CUDA_ALLOC_CONF"] = SHARED_CARD_ALLOC
    if verbose:
        print(f"launch: backend={backend} ranks={world} device={device}"
              + "".join(f" {k}={v}" for k, v in env.items()), flush=True)
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    init_file = os.path.join(tmp, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=False,
                         args=(r, world, init_file, backend, device, threads,
                               fn, tuple(args), results))
             for r in range(world)]
    got, errors = {}, []
    try:
        # the ranks inherit the environment as it is when they start
        os.environ.update(env)
        try:
            for p in procs:
                p.start()
        finally:
            for k in env:
                os.environ.pop(k)
        deadline = time.monotonic() + timeout_s
        while len(got) + len(errors) < world:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after "
                                       f"{timeout_s} s") from None
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(
                        f"rank(s) {[procs.index(p) for p in dead]} died with "
                        f"exit code(s) {[p.exitcode for p in dead]}")
                continue
            if ok:
                got[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
        if errors:
            raise RuntimeError("a rank failed\n" + "\n".join(errors))
        for p in procs:
            p.join(timeout=60)
        return [got[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
        shutil.rmtree(tmp, ignore_errors=True)

"""The collectives the sharded layouts run, over a :class:`Mesh`'s
groups, each counted where it is issued.

``counts()`` reads, since the last ``reset()``, how many of each the
process issued, the bytes each sent (the ring algorithms' payload:
(n-1)·|x| for an all_gather, (n-1)/n·|x| for an all_to_all,
2(n-1)/n·|x| for an all_reduce) and the device types of every tensor
handed to one.  A failed collective raises; none is retried or staged
through another device.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

KINDS = ("all_gather", "all_to_all", "all_reduce")

COUNTS = {k: 0 for k in KINDS}
BYTES = {k: 0 for k in KINDS}
DEVICE_TYPES: set = set()

# torch 2.13 names it all_gather_single; earlier ones all_gather_into_tensor
_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def reset() -> None:
    for k in KINDS:
        COUNTS[k] = BYTES[k] = 0
    DEVICE_TYPES.clear()


def counts() -> dict:
    """{"all_gather": n, "all_to_all": n, "all_reduce": n, "bytes_sent":
    {kind: bytes}, "device_types": [...]} since the last :func:`reset`."""
    return {**COUNTS, "bytes_sent": dict(BYTES),
            "device_types": sorted(DEVICE_TYPES)}


def _note(kind: str, x, n: int, share: float) -> None:
    COUNTS[kind] += 1
    BYTES[kind] += int(x.numel() * x.element_size() * (n - 1) * share)
    DEVICE_TYPES.add(x.device.type)


def all_gather(x, mesh, axes):
    """[n, *x.shape]: every rank's ``x`` over ``axes``, row r from the
    rank of index r."""
    n = mesh.size(axes)
    x = x.contiguous()
    out = torch.empty((n * x.numel(),), dtype=x.dtype, device=x.device)
    _note("all_gather", x, n, 1.0)
    _gather_into(out, x.view(-1), group=mesh.group(axes))
    return out.view((n,) + tuple(x.shape))


def all_to_all(x, mesh, axes):
    """x [n, c] -> [n, c]: row r of the result is row ``index`` of rank
    r's x (``lax.all_to_all(split_axis=0, concat_axis=0)``)."""
    n = mesh.size(axes)
    x = x.contiguous()
    out = torch.empty_like(x)
    _note("all_to_all", x, n, 1.0 / n)
    dist.all_to_all_single(out, x, group=mesh.group(axes))
    return out


def all_reduce(x, mesh, axes):
    """The sum of ``x`` over ``axes`` (``psum``), written into x, which
    is returned."""
    n = mesh.size(axes)
    _note("all_reduce", x, n, 2.0 / n)
    dist.all_reduce(x, group=mesh.group(axes))
    return x

"""Data-parallel training over processes (port of
fenerf_tpu/train/sharding.py, on torch.distributed).

The reference's only distributed feature is DDP data parallelism
(train_double_latent_semantic.py:58-63,148-150; SURVEY.md §2.3). The JAX
package runs one SPMD program over a device mesh and lets XLA insert the
all-reduce; here each process drives one device and the step makes its
collectives itself (train/loop.py::train_step with `group`):

  * every rank makes the same GLOBAL draws of a step from one seed and
    takes its share of every microbatch (shard_step_draws);
  * each rank's loss is its share of the global loss (means of its own
    elements divided by the world size), and the gradients are SUMMED over
    the ranks, once per phase, as one flat f32 buffer, before the clip and
    Adam, so every rank applies the same update;
  * the G phase's top-k decides its kept set from the whole chunk: the
    detached scores are exchanged by an all-reduce of a zero-padded
    vector (exact: it only adds zeros), which NCCL and gloo serve on the
    CPU and on CUDA alike.

Parameters are dict trees, not nn.Modules, and the step runs three
optimizers, so the collectives are explicit rather than
nn.parallel.DistributedDataParallel's.

A process group comes from init_distributed (NCCL for CUDA, gloo for the
CPU); its host barrier runs on a separate gloo group, so it is never a
device collective. Group(...) without a process group is world size 1.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from fenerf_tpu_torch.compat.jax_bridge import tree_leaves, tree_unflatten
from fenerf_tpu_torch.models.generator import RayNoise, RenderDraws
from fenerf_tpu_torch.train import loop as looplib
from fenerf_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class Group:
    """This process's place in the data-parallel group: its rank, the world
    size, its device, and the gloo group of the host barrier (None at world
    size 1, where every collective is skipped)."""
    rank: int = 0
    world: int = 1
    device: torch.device = torch.device("cpu")
    host: Any = None

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM):
        """In place over the ranks (a no-op at world size 1)."""
        if self.world > 1:
            dist.all_reduce(t, op=op)
        return t

    def sum_tree(self, tree):
        """The sum over the ranks of a tree of tensors (a gradient), through
        one flat f32 all-reduce (the span fenerf/train/allreduce, counting
        its bytes); a new tree of f32 leaves."""
        if self.world <= 1:
            return tree
        leaves = tree_leaves(tree)
        buf = _flat(leaves, torch.float32)
        with span("fenerf/train/allreduce", bytes=4 * buf.numel()):
            self.all_reduce(buf)
        out, off = [], 0
        for t in leaves:
            out.append(buf[off:off + t.numel()].view(t.shape))
            off += t.numel()
        return tree_unflatten(tree, out)


_LOOPBACK = ("localhost", "127.", "::1", "[::1]")


def local_gpu(coordinator: str, num_processes: int, process_id: int,
              visible: int) -> int:
    """This rank's GPU index on its host, of `visible`: LOCAL_RANK where
    torchrun sets it, else the rank modulo the host's GPUs (each host
    starts one process per GPU, its ranks contiguous). Raises where a host
    would hold more ranks than GPUs: LOCAL_RANK beyond them, or a world
    larger than them behind a coordinator on this host (loopback)."""
    if "LOCAL_RANK" in os.environ:
        local = int(os.environ["LOCAL_RANK"])
        if local >= visible:
            raise RuntimeError(
                f"LOCAL_RANK {local} needs cuda:{local}, but this host has "
                f"{visible} visible GPU(s): start at most {visible} "
                f"process(es) per host (one GPU each)")
        return local
    host = coordinator.split("://")[-1].rsplit(":", 1)[0]
    if host.startswith(_LOOPBACK) and num_processes > visible:
        raise RuntimeError(
            f"{num_processes} processes with a coordinator on this host "
            f"({coordinator}) need {num_processes} GPUs, but it has "
            f"{visible} visible: one GPU per process")
    return process_id % visible


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     backend: str | None = None, device_type: str = "cuda",
                     device: torch.device | None = None) -> Group:
    """Join the group at `coordinator` ("host:port", or a URL such as
    tcp://host:port or env://) as rank `process_id` of `num_processes`.
    The backend is NCCL for CUDA and gloo for the CPU; a CUDA rank's device
    is cuda:local_gpu(...) (LOCAL_RANK as torchrun sets it, else the rank
    modulo the host's GPUs), unless `device` names it (gloo ranks may share
    a GPU; NCCL refuses two ranks on one)."""
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
    elif device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass --device cpu to "
                               "train over gloo on the CPU")
        device = torch.device("cuda", local_gpu(
            coordinator, num_processes, process_id,
            torch.cuda.device_count()))
        torch.cuda.set_device(device)
    else:
        device = torch.device(device_type)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    if not dist.is_initialized():
        kw = {"device_id": device} if backend == "nccl" else {}
        # the step's collectives wait as long as the host barrier: a rank's
        # first step may build its kernels for minutes before its first
        # all-reduce
        dist.init_process_group(
            backend, init_method=url, world_size=num_processes,
            rank=process_id,
            timeout=datetime.timedelta(milliseconds=deadline_ms()), **kw)
    host = dist.new_group(backend="gloo") if num_processes > 1 else None
    return Group(process_id, num_processes, device, host)


def shutdown() -> None:
    """Leave the process group (after the last collective)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def deadline_ms() -> int:
    """FENERF_BARRIER_TIMEOUT_MS, default 1,200,000 (20 min), as the JAX
    package's host barrier reads it."""
    return int(os.environ.get("FENERF_BARRIER_TIMEOUT_MS", 1_200_000))


def host_barrier(group: Group, name: str,
                 timeout_ms: int | None = None) -> None:
    """Cross-process rendezvous on the host's gloo group, never a device
    collective. The deadline (FENERF_BARRIER_TIMEOUT_MS, default 20 min)
    covers work that only some ranks do, such as rank 0's FID; a rank that
    does not arrive in time fails the barrier with its name. Does nothing
    at world size 1."""
    if group.world <= 1:
        return
    if timeout_ms is None:
        timeout_ms = deadline_ms()
    try:
        dist.monitored_barrier(
            group=group.host, wait_all_ranks=True,
            timeout=datetime.timedelta(milliseconds=timeout_ms))
    except RuntimeError as e:
        raise RuntimeError(f"host barrier {name!r} failed: {e}") from e


def per_rank(group: Group, n: int) -> int:
    """Each rank's share of n examples."""
    if n % group.world:
        raise ValueError(f"batch {n} not divisible by {group.world} ranks")
    return n // group.world


def shard_slice(group: Group, n: int) -> slice:
    """This rank's contiguous share of n examples."""
    per = per_rank(group, n)
    return slice(group.rank * per, (group.rank + 1) * per)


def shard_batch(group: Group, *arrays):
    """This rank's contiguous slice of each GLOBAL array (numpy or
    tensor), on its device. (The trainer's loader gives each rank its own
    batches directly: data/celeba_mask.py::iterate_batches with
    host_index / n_hosts.)"""
    out = []
    for a in arrays:
        a = a[shard_slice(group, a.shape[0])]
        t = torch.from_numpy(np.ascontiguousarray(a)) \
            if isinstance(a, np.ndarray) else a
        out.append(t.to(group.device))
    return tuple(out) if len(out) > 1 else out[0]


def _flat(leaves: list[torch.Tensor], dtype) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).to(dtype) for t in leaves])


def replicate(group: Group, tree):
    """Broadcast every tensor of `tree` from rank 0, in place (one flat
    buffer per dtype); other leaves (counts) are left as they are. Returns
    the tree."""
    if group.world <= 1:
        return tree
    by_dtype: dict = {}
    for _, t in _paths(tree):
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for dtype, leaves in by_dtype.items():
            buf = _flat(leaves, dtype)
            dist.broadcast(buf, src=0)
            off = 0
            for t in leaves:
                t.copy_(buf[off:off + t.numel()].view_as(t))
                off += t.numel()
    return tree


def _paths(tree, prefix=""):
    """(name, tensor) for every tensor leaf, in tree_leaves order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _paths(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    elif isinstance(tree, torch.Tensor):
        yield prefix or "/", tree


def check_replica_consistency(group: Group, tree, atol: float = 0.0) -> None:
    """Raise AssertionError naming the first leaf of `tree` on which some
    rank differs from rank 0 by more than `atol` (the reference's vendored
    check_ddp_consistency, siren/torch_utils/misc.py:178-190). NaN equals
    NaN. Every rank must call it; rank 0's values travel in one flat buffer
    per dtype."""
    if group.world <= 1:
        return
    named = list(_paths(tree))
    if not named:
        return
    worst = torch.zeros(len(named), dtype=torch.float64)
    by_dtype: dict = {}
    for i, (_, t) in enumerate(named):
        by_dtype.setdefault(t.dtype, []).append(i)
    with torch.no_grad():
        for dtype, ids in by_dtype.items():
            mine = _flat([named[i][1] for i in ids], dtype)
            ref = mine.clone()
            dist.broadcast(ref, src=0)
            off = 0
            for i in ids:
                n = named[i][1].numel()
                a, b = mine[off:off + n], ref[off:off + n]
                off += n
                if not n:
                    continue
                if a.is_floating_point():
                    diff = (a - b).abs()
                    diff = torch.where(torch.isnan(a) & torch.isnan(b),
                                       torch.zeros_like(diff), diff)
                    diff = torch.nan_to_num(diff, nan=float("inf"))
                else:
                    diff = (a.double() - b.double()).abs()
                worst[i] = diff.max().double().cpu()
        dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=group.host)
    bad = (worst > atol).nonzero()
    if len(bad):
        i = int(bad[0])
        raise AssertionError(f"replica divergence at {named[i][0]}: a rank "
                             f"differs from rank 0 by {float(worst[i])}")


# ---------------------------------------------------------------------------
# The sharded step
# ---------------------------------------------------------------------------

def share_rows(batch: int, n_chunks: int, rank: int, world: int
               ) -> torch.Tensor:
    """The global rows of rank `rank`'s share of every chunk: chunk c of
    `batch` rows (c < n_chunks) gives its rows
    c * m + [rank * m / world, (rank + 1) * m / world), m = batch /
    n_chunks, in chunk order."""
    if batch % (n_chunks * world):
        raise ValueError(f"global batch {batch} not divisible by "
                         f"{n_chunks} chunks x {world} ranks")
    m = batch // n_chunks
    per = m // world
    return torch.cat([torch.arange(c * m + rank * per, c * m + (rank + 1) *
                                   per) for c in range(n_chunks)])


def _rows(x, idx):
    """Rows `idx` of a draw (tensor, tuple / list of tensors, or None)."""
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return type(x)(_rows(t, idx) for t in x)
    return x[idx.to(x.device)]


def _slice_render(d: RenderDraws, idx) -> RenderDraws:
    """Rows `idx` of every draw with a batch axis; the ray permutation and
    the hybrid camera's coin are one per batch and stay whole."""
    return RenderDraws(_rows(d.jitter, idx), _rows(d.cam_h, idx),
                       _rows(d.cam_v, idx),
                       RayNoise(*(_rows(t, idx) for t in d.noise)),
                       d.ray_perm, d.cam_coin)


def _slice_list(parts: list, idx, batch: int, fn):
    """Render j of `parts` covers global rows [j * batch / n, (j + 1) *
    batch / n): each keeps the rows of `idx` inside its range."""
    n = len(parts)
    per = batch // n
    return [fn(p, idx[(idx >= j * per) & (idx < (j + 1) * per)] - j * per)
            for j, p in enumerate(parts)]


def shard_step_draws(draws, meta, batch: int, rank: int, world: int):
    """This rank's share of a step's GLOBAL draws (train/loop.py::
    StepDraws for `batch` examples): its rows of every microbatch (of every
    top-k chunk in full_batch mode). D_img's augmentation keeps the fakes'
    rows in `aug_d` and the reals' (the rank's contiguous slice, as the
    loader deals them) in `aug_real`."""
    if world == 1:
        return draws
    idx = share_rows(batch, meta.batch_split, rank, world)
    renders = lambda parts: None if parts is None else _slice_list(
        parts, idx, batch, _slice_render)
    aug_real = None
    if draws.aug_d is not None:
        per = batch // world
        aug_real = _rows(draws.aug_d, torch.arange(rank * per,
                                                   (rank + 1) * per))
    return draws._replace(
        z_img=_rows(draws.z_img, idx), fakes_img=renders(draws.fakes_img),
        z_seg=_rows(draws.z_seg, idx), fakes_seg=renders(draws.fakes_seg),
        z_g=_rows(draws.z_g, idx), g_renders=renders(draws.g_renders),
        aug_d=_rows(draws.aug_d, idx),
        aug_g=(None if draws.aug_g is None else _slice_list(
            draws.aug_g, idx, batch, _rows)),
        aug_real=aug_real)


def train_step_sharded(state, real_imgs, real_labels, scal, meta,
                       group: Group, generator: torch.Generator | None = None,
                       draws=None):
    """One data-parallel step: real_imgs / real_labels are this rank's
    examples (the global batch is world times as many); `draws` are the
    step's GLOBAL draws, else made from `generator` (the same seed on
    every rank). Returns (state, metrics), both the same on every rank."""
    batch = real_imgs.shape[0] * group.world
    if draws is None:
        if generator is None:
            generator = torch.Generator(device=group.device).manual_seed(
                state.step)
        draws = looplib.make_step_draws(generator, meta, batch,
                                        scal.noise_std, group.device)
    local = shard_step_draws(draws, meta, batch, group.rank, group.world)
    return looplib.train_step(state, real_imgs, real_labels, scal, meta,
                              draws=local, group=group)


"""Ray parallelism over GPUs with ``torch.distributed`` (port of
``nope_nerf_tpu/parallel/mesh.py``).

One process per GPU, launched by ``torch.distributed.run``:

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        -m nope_nerf_tpu_torch.train <cfg with tpu.n_devices: N>

The JAX package's recipe, in processes instead of a ``shard_map``:

* **Replicated.** The parameters and the Adam state are identical on every
  rank (:func:`replicate` broadcasts them from rank 0 at the start and at a
  resume). Every rank draws the whole global batch from the same seeded
  generators (frame order, ray indices, stratified jitter) and runs the
  per-frame set-up, the reference-pair branch and the pose and distortion
  terms on all of it.
* **Sharded.** A per-ray or per-point array is split on its leading axis
  into contiguous row blocks, one per rank (:func:`shard_rays`); Kernel A,
  or Kernel C and the compositing, and the Chamfer argmins (Kernels B, D)
  run on the rank's rows only.
* **Values global, gradients averaged.** Every value that a loss reads is
  global on every rank: sums over sharded rows are all-reduced in the
  forward (:func:`mesh_sums`, :func:`mesh_mean`, :func:`gather_rays`).
  Each rank's backward then gives a gradient whose mean over the ranks is
  the one-device gradient, and :func:`all_reduce_grads` forms that mean
  before Adam, in one collective per step. This holds because everything
  downstream of a global value is computed alike on every rank, so its
  cotangent is the same on every rank, and the backward of a global sum
  multiplies it by the world size instead of summing it across ranks.

With ``tpu.n_devices: 1`` none of this runs: the mesh is None and no
``torch.distributed`` call is made.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

RAY_AXIS = "rays"


@dataclass(frozen=True)
class RayMesh:
    """This process's place in a 1-D ray mesh: its ``rank`` of ``size``
    ranks, its ``device``, the process-group ``backend`` and the axis
    name (``tpu.mesh_axis``). The default process group carries the
    collectives."""

    rank: int
    size: int
    device: torch.device
    backend: str
    axis_name: str = RAY_AXIS


def make_ray_mesh(n_devices: int, axis_name: str = RAY_AXIS,
                  allow_shared_device: bool = False,
                  device: str = "cuda") -> RayMesh:
    """A 1-D mesh of ``n_devices`` ranks, one process each.

    On CUDA each rank takes card ``LOCAL_RANK`` and the ranks talk over
    NCCL. Fewer cards than ranks raises ``ValueError`` unless
    ``allow_shared_device``, which puts the ranks on shared cards and
    talks over gloo (NCCL refuses two ranks on one card): tests and the
    smoke run only; production training keeps it False. On the CPU the
    ranks talk over gloo.

    Uses the process group when one exists (its backend must be the one
    above), else starts it from ``torch.distributed.run``'s environment.
    Its world size must equal ``n_devices``.
    """
    n_devices = int(n_devices)
    dev = torch.device(device)
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        shared = n_cards < n_devices
        if shared and not allow_shared_device:
            raise ValueError(
                f"need {n_devices} CUDA devices, have {n_cards}; ranks share "
                "a card only with allow_shared_device=True (tests)")
        backend = "gloo" if shared else "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"make_ray_mesh: unsupported device {dev}")
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                f"tpu.n_devices {n_devices} runs one process per GPU: launch "
                "with python -m torch.distributed.run --standalone "
                f"--nproc-per-node {n_devices} -m nope_nerf_tpu_torch.train "
                "<cfg>")
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                                  % torch.cuda.device_count())
        dist.init_process_group(backend, init_method="env://")
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, this "
                         f"mesh needs {backend}")
    size, rank = dist.get_world_size(), dist.get_rank()
    if size != n_devices:
        raise ValueError(f"world size {size} != tpu.n_devices {n_devices}")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return RayMesh(rank=rank, size=size, device=dev, backend=backend,
                   axis_name=axis_name)


def rank_rows(n, mesh: RayMesh | None):
    """This rank's contiguous block of ``n`` rows as a slice: ceil(n /
    size) rows per rank, the last blocks short or empty (all ``n`` without
    a mesh)."""
    if mesh is None:
        return slice(0, n)
    per = -(-n // mesh.size)
    return slice(min(mesh.rank * per, n), min((mesh.rank + 1) * per, n))


def shard_rays(x, mesh: RayMesh | None):
    """The rank's block of :func:`rank_rows` of ``x`` (identity without a
    mesh)."""
    if mesh is None:
        return x
    return x[rank_rows(x.shape[0], mesh)]


def gather_rays(x, n, mesh: RayMesh | None):
    """The global ``n`` rows from every rank's block ``x`` of
    :func:`shard_rays` (one all-reduce of a zero-filled buffer, so the rows
    keep their bits; identity without a mesh). Autograd passes this rank's
    block of the cotangent back, times the world size (the mean convention
    of the module docstring)."""
    if mesh is None:
        return x
    return _GatherRows.apply(x, n, mesh)


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.size = mesh.size
        y = x.detach().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return (g * ctx.size if ctx.size > 1 else g), None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n, mesh):
        ctx.rows, ctx.size = rank_rows(n, mesh), mesh.size
        buf = x.new_zeros((n,) + tuple(x.shape[1:]))
        buf[ctx.rows] = x
        dist.all_reduce(buf)
        return buf

    @staticmethod
    def backward(ctx, g):
        g = g[ctx.rows]
        return (g * ctx.size if ctx.size > 1 else g), None, None


def mesh_sums(xs, mesh: RayMesh | None):
    """The sums over ranks of the scalars ``xs``, in one all-reduce (``xs``
    as they are without a mesh)."""
    if mesh is None:
        return tuple(xs)
    return tuple(_Sum.apply(torch.stack(tuple(xs)), mesh).unbind())


def mesh_mean(x, mesh: RayMesh | None, numel: int):
    """``torch.mean`` of the global tensor whose rank part is ``x``, of
    ``numel`` elements in all: this rank's mean weighted by its share,
    summed over ranks (with one rank, exactly ``torch.mean(x)``)."""
    if mesh is None:
        return torch.mean(x)
    if x.numel() == 0:
        return _Sum.apply(x.sum(), mesh)
    share = x.numel() / numel
    local = torch.mean(x)
    return _Sum.apply(local * share if share != 1.0 else local, mesh)


def replicate(tensors, mesh: RayMesh | None):
    """Broadcast ``tensors`` in place from rank 0 (no-op without a
    mesh)."""
    if mesh is None:
        return
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0)


def barrier(mesh: RayMesh | None):
    """Wait for every rank (no-op without a mesh)."""
    if mesh is not None:
        dist.barrier()


def all_reduce_grads(grads, mesh: RayMesh | None):
    """Replace each tensor of ``grads`` (same dtype, on one device) by its
    mean over the ranks: one all-reduce of their concatenation."""
    if mesh is None or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    if mesh.size > 1:
        flat.div_(mesh.size)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def warm_up_collectives(mesh: RayMesh | None):
    """One all-reduce on the mesh's device (no-op without a mesh), so that
    the communicator exists before a CUDA graph of the step captures the
    step's all-reduces (NCCL; gloo's cannot be captured)."""
    if mesh is not None:
        dist.all_reduce(torch.zeros(1, device=mesh.device))


def shard_train_step(cfg, render_cfg, init_c2w, mesh: RayMesh):
    """The training step under ``mesh`` (the JAX ``shard_train_step``):
    :func:`..training.trainer.make_train_step` with the mesh."""
    from ..training.trainer import make_train_step

    return make_train_step(cfg, render_cfg, init_c2w, mesh=mesh)

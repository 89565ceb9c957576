"""The device mesh and its collectives (port of
super_resolution_tpu/parallel/mesh.py; ref: basicsr/utils/dist_util.py,
base_model.py:95-98).

One process a device, started by ``torchrun``: :func:`init_distributed`
joins the process group (``init_method="env://"``: torch reads ``RANK``,
``WORLD_SIZE`` and ``MASTER_ADDR`` itself), and :func:`make_mesh` /
:func:`make_mesh_from_spec` build a ``DeviceMesh`` over the ranks with
JAX's axis names. There is no single-process fallback: a mesh that cannot
be built raises.

On the card the backend is NCCL; on the CPU, and for several ranks that
share one card, gloo, which stages the collectives of CUDA tensors through
the host itself but not a point-to-point send: :func:`exchange` stages
those through host memory.

Autograd through the collectives: :func:`copy_to_group` (identity forward,
all-reduce backward) and :func:`reduce_from_group` (all-reduce forward,
identity backward) are Megatron's pair. Every rank computes the same loss,
so a plain differentiable all-reduce would count each rank's gradient once
a rank.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from super_resolution_tpu_torch.utils.logger import get_root_logger


def init_distributed(backend: str | None = None,
                     device_type: str = "cuda") -> tuple[int, int]:
    """Join the process group where it is not joined yet (NCCL for
    ``cuda``, gloo for ``cpu`` unless ``backend`` says otherwise) and, on
    the card, make ``cuda:<rank % cards>`` the current device. Returns
    (rank, world size)."""
    if not dist.is_initialized():
        if backend is None:
            backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, init_method="env://")
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return dist.get_rank(), dist.get_world_size()


def resolve_mesh_spec(spec: dict, n_devices: int) -> dict:
    """{axis: size} of a YAML ``mesh:`` block over ``n_devices``: one axis
    may be -1 (the devices the others leave). An undersized spec warns, as
    the chips it leaves sit idle; a spec that needs more raises."""
    sizes = {str(a): int(s) for a, s in dict(spec).items()}
    fills = [a for a, s in sizes.items() if s == -1]
    if len(fills) > 1:
        raise ValueError(f"mesh spec {spec}: only one axis may be -1")
    fixed = int(np.prod([s for s in sizes.values() if s != -1]))
    if fills:
        if n_devices % fixed:
            raise ValueError(f"mesh spec {spec} does not divide "
                             f"{n_devices} devices")
        sizes[fills[0]] = n_devices // fixed
    n = int(np.prod(list(sizes.values())))
    if n > n_devices:
        raise ValueError(f"mesh spec {spec} needs {n} devices, "
                         f"found {n_devices}")
    if n < n_devices:
        get_root_logger().warning(
            f"mesh spec {spec} covers {n} of {n_devices} devices; "
            f"{n_devices - n} chips will sit idle (use -1 on one axis to "
            f"fill the slice)")
    return sizes


def _device_mesh(device_type: str, sizes: dict):
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    shape = tuple(sizes.values())
    names = tuple(sizes)
    if int(np.prod(shape)) == dist.get_world_size():
        return init_device_mesh(device_type, shape, mesh_dim_names=names)
    return DeviceMesh(device_type,
                      torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=names)


def make_mesh(n_devices: int | None = None, axis: str = "data",
              device_type: str = "cuda"):
    """A 1-D mesh over the first ``n_devices`` ranks, all by default;
    joins the process group first."""
    init_distributed(device_type=device_type)
    n = n_devices or dist.get_world_size()
    return _device_mesh(device_type,
                        resolve_mesh_spec({axis: n}, dist.get_world_size()))


def make_mesh_from_spec(spec: dict, device_type: str = "cuda"):
    """The mesh of a YAML ``mesh:`` block, ordered {axis: size}: e.g.
    ``mesh: {data: -1}`` (data parallel over every rank) or ``mesh: {data:
    2, model: 2}`` (the DP x TP rectangle). Joins the process group
    first."""
    init_distributed(device_type=device_type)
    return _device_mesh(device_type,
                        resolve_mesh_spec(spec, dist.get_world_size()))


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis``; 1 for a mesh without it (or no mesh)."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return 1
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 where the mesh lacks it)."""
    if axis_size(mesh, axis) == 1:
        return 0
    return int(mesh.get_local_rank(axis))


# -------------------------------------------------------------- collectives
def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In-place all-reduce of ``t`` over ``group``."""
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors (equal shapes), concatenated along ``dim`` in
    group-rank order."""
    src = t.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim)


def broadcast_(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """In-place broadcast from the group's rank ``src``."""
    dist.broadcast(t, dist.get_global_rank(group, src), group=group)
    return t


def exchange(sends: dict, recvs: dict, group) -> dict:
    """Point-to-point in one batch: ``sends`` {group rank: tensor} go out,
    ``recvs`` {group rank: (shape, dtype, device)} come in. Returns {group
    rank: tensor} of what came in. Under gloo, CUDA tensors travel through
    host copies (gloo sends device memory as if it were the host's)."""
    out = {r: torch.empty(s, dtype=d, device=dev)
           for r, (s, d, dev) in recvs.items()}
    gloo = dist.get_backend(group) == "gloo"
    staged = {r: gloo and t.is_cuda for r, t in sends.items()}
    staged.update({r: gloo and t.is_cuda for r, t in out.items()})
    bufs = {("s", r): (t.detach().cpu() if staged[r] else t.contiguous())
            for r, t in sends.items()}
    bufs.update({("r", r): (torch.empty(t.shape, dtype=t.dtype)
                            if staged[r] else t) for r, t in out.items()})
    ops = [dist.P2POp(dist.isend, bufs[("s", r)],
                      dist.get_global_rank(group, r), group)
           for r in sorted(sends)]
    ops += [dist.P2POp(dist.irecv, bufs[("r", r)],
                       dist.get_global_rank(group, r), group)
            for r in sorted(out)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for r, t in out.items():
        if staged[r]:
            t.copy_(bufs[("r", r)])
    return out


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over ``group``
    (a replicated input that each rank's partial result reads)."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` forward; the backward passes the gradient on as
    it is (every rank holds the same loss of the sum)."""
    return _ReduceFromGroup.apply(x, group)


def all_sum_across_processes(values: dict, group=None) -> dict:
    """Sum a dict of floats over the processes (float64; the metric sums of
    process-sharded validation)."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return dict(values)
    keys = sorted(values)
    t = torch.tensor([float(values[k]) for k in keys], dtype=torch.float64,
                     device="cuda" if dist.get_backend(group) == "nccl"
                     else "cpu")
    dist.all_reduce(t, group=group)
    return {k: float(v) for k, v in zip(keys, t.tolist())}


# ------------------------------------------------------------ data parallel
def _leaves(tree, fn):
    if isinstance(tree, dict):
        return {k: _leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and tree and not isinstance(
            tree[0], str):
        return type(tree)(_leaves(v, fn) for v in tree)
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    return tree


def shard_batch(batch: Any, mesh, axis: str = "data") -> Any:
    """This rank's slice of a global batch: the leading dim of every array
    split into ``axis``-size equal parts (JAX's device_put with the batch
    dim sharded, seen from one process). The batch must divide."""
    n, r = axis_size(mesh, axis), axis_rank(mesh, axis)

    def part(x):
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} does not divide the "
                             f"{axis!r} axis ({n} ranks)")
        k = x.shape[0] // n
        return x[r * k:(r + 1) * k]

    return _leaves(batch, part)


def pad_batch_to_multiple(batch: Any, multiple: int):
    """Pad the batch dim to a multiple of ``multiple`` with copies of the
    last item (edge batches in evaluation). Returns (padded batch, original
    size)."""
    sizes = []
    _leaves(batch, lambda x: sizes.append(x.shape[0]))
    n = sizes[0]
    pad = (-n) % multiple
    if pad == 0:
        return batch, n

    def grow(x):
        tail = x[-1:]
        if isinstance(x, np.ndarray):
            return np.concatenate([x, np.repeat(tail, pad, axis=0)])
        return torch.cat([x, tail.expand(pad, *x.shape[1:])])

    return _leaves(batch, grow), n


def data_group(mesh):
    """The group of the mesh's ``data`` axis, or None where it has none."""
    if mesh is None or "data" not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group("data")


def replicate_module(module: torch.nn.Module, group) -> None:
    """Broadcast the parameters and buffers from the group's first rank, so
    that every replica starts equal (DDP's first step)."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            broadcast_(t.data, group)


def attach_data_parallel(mesh, modules: Sequence[torch.nn.Module],
                         optimizers: Sequence[torch.optim.Optimizer]):
    """Data parallelism over the mesh's ``data`` axis: the modules start
    equal on every rank, and each optimizer's gradients are averaged over
    the axis before its update (``train_loop.fill_missing_grads`` reads
    the group it carries). With equal local batches the average is the
    gradient of JAX's global-batch mean. Returns the group (None without
    a ``data`` axis)."""
    group = data_group(mesh)
    if group is None:
        return None
    for m in modules:
        if m is not None:
            replicate_module(m, group)
    for opt in optimizers:
        opt.data_parallel_group = group
    return group


def all_reduce_mean_(grads: list, group) -> None:
    """Average ``grads`` over ``group`` in place (one flat all-reduce a
    dtype)."""
    n = dist.get_world_size(group)
    by_dtype: dict = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for gs in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        all_reduce_(flat, group)
        flat /= n
        torch._foreach_copy_(gs, [f.view_as(g) for f, g in zip(
            flat.split([g.numel() for g in gs]), gs)])


def shard_apply(apply_fn, x: torch.Tensor, group) -> torch.Tensor:
    """``apply_fn`` on this rank's equal part of the batch ``x`` (whose
    leading dim divides the group), the parts gathered back: every rank
    returns ``apply_fn(x)``."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[0] % n:
        raise ValueError(f"batch {x.shape[0]} does not divide {n} ranks")
    k = x.shape[0] // n
    return all_gather_cat(apply_fn(x[r * k:(r + 1) * k]), group)

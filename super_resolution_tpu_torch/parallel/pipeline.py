"""Pipeline parallelism over the residual-group stack: GPipe (port of
super_resolution_tpu/parallel/pipeline.py).

The deep middle of HAT, HATClassic, SwinIR, SRFormer and ATD is a stack of
structurally identical, shape-preserving groups (``net.layers``), between
the shell's ``head`` and ``tail`` (``arch_util.SRShell``). Rank r of the
``pipe`` axis holds groups [r S / P, (r + 1) S / P); the head and the tail
are replicated.

Schedule: plain GPipe, as JAX's: M microbatches, M + P - 1 ticks; at tick
t rank r applies its groups to microbatch t - r and hands the activation to
rank r + 1 (``mesh.exchange``: one isend / irecv pair). Every rank runs
every tick, and the last rank's finished microbatches are summed over the
axis (the others add zeros), so every rank returns the whole output.

The backward is autograd through the same schedule: the hand-over's
backward sends the activation's gradient from rank r + 1 back to r, in
reverse tick order; the input enters through ``copy_to_group`` (only rank
0 reads it, the others add a zero multiple, so its gradient sums to rank
0's) and the output leaves through ``reduce_from_group``. Each rank's
groups accumulate their gradient over the microbatches: GPipe's
accumulation, derived by autograd. Groups run deterministically (no drop
path), as in JAX.
"""

from __future__ import annotations

import copy
from typing import Callable, Sequence

import torch
from torch import nn

from super_resolution_tpu_torch.parallel.mesh import (all_reduce_, axis_rank,
                                                      axis_size, broadcast_,
                                                      copy_to_group, exchange,
                                                      reduce_from_group)
from super_resolution_tpu_torch.parallel.tp import tp_attention

PIPELINED_ARCHS = ("HAT", "HATClassic", "SwinIR", "SRFormer", "ATD")


def stack_stage_params(state: dict, names: Sequence[str]) -> dict:
    """{suffix: (S, ...) tensor}: the entries ``<name>.<suffix>`` of the
    stages ``names`` stacked stage-major. Raises where the stages' entries
    differ in names or shapes (unequal group configs cannot be pipelined
    this way)."""
    subs = []
    for n in names:
        pre = n + "."
        subs.append({k[len(pre):]: v for k, v in state.items()
                     if k.startswith(pre)})
    layouts = {tuple((k, tuple(v.shape)) for k, v in sorted(s.items()))
               for s in subs}
    if len(layouts) != 1:
        raise ValueError(
            "pipeline stages must be structurally identical; got "
            f"{len(layouts)} distinct parameter layouts across {list(names)}")
    return {k: torch.stack([s[k] for s in subs]) for k in subs[0]}


def split_stage_params(state: dict, names: Sequence[str]):
    """(stacked stage entries, the rest of the state dict)."""
    prefixes = tuple(n + "." for n in names)
    rest = {k: v for k, v in state.items() if not k.startswith(prefixes)}
    return stack_stage_params(state, names), rest


def merge_stage_params(stacked: dict, rest: dict,
                       names: Sequence[str]) -> dict:
    """Inverse of :func:`split_stage_params`: the whole state dict."""
    out = dict(rest)
    for i, n in enumerate(names):
        out.update({f"{n}.{k}": v[i] for k, v in stacked.items()})
    return out


def pp_stage(net: nn.Module):
    """(stage names, stage_apply) of a supported arch's group stack:
    ``layers.<i>`` for each group, and ``stage_apply(group, a)`` running
    one group deterministically. The groups must be configured alike
    (equal depths and heads)."""
    if type(net).__name__ not in PIPELINED_ARCHS:
        raise NotImplementedError(
            f"pipeline stages for {type(net).__name__}; the group stacks of "
            f"{', '.join(PIPELINED_ARCHS)} are supported")
    names = [f"layers.{i}" for i in range(len(net.layers))]
    stack_stage_params(net.state_dict(), names)
    return names, stage_apply


def stage_apply(group: nn.Module, a: torch.Tensor) -> torch.Tensor:
    """One group, in eval mode: no drop path inside the pipeline."""
    training = group.training
    group.eval()
    try:
        return group(a)
    finally:
        group.train(training)


class _HandOver(torch.autograd.Function):
    """Forward: send ``y`` to the next rank of the axis and return what the
    previous rank sent (zeros on rank 0). Backward: the reverse."""

    @staticmethod
    def forward(ctx, y, group, rank: int, size: int):
        ctx.group, ctx.rank, ctx.size = group, rank, size
        sends = {rank + 1: y} if rank + 1 < size else {}
        recvs = ({rank - 1: (y.shape, y.dtype, y.device)} if rank > 0
                 else {})
        got = exchange(sends, recvs, group)
        return got[rank - 1] if rank > 0 else torch.zeros_like(y)

    @staticmethod
    def backward(ctx, g):
        rank, size = ctx.rank, ctx.size
        sends = {rank - 1: g.contiguous()} if rank > 0 else {}
        recvs = ({rank + 1: (g.shape, g.dtype, g.device)}
                 if rank + 1 < size else {})
        got = exchange(sends, recvs, ctx.group)
        return (got[rank + 1] if rank + 1 < size else torch.zeros_like(g),
                None, None, None)


def pipeline_apply(stage_fn: Callable, local_stages: Sequence[nn.Module],
                   x: torch.Tensor, mesh, axis: str = "pipe",
                   microbatches: int | None = None) -> torch.Tensor:
    """Run x through the stages pipelined over mesh[axis].

    stage_fn(stage, a) -> a' of a's shape; local_stages: this rank's
    consecutive stages (an equal share of the stack on every rank);
    x: (B, ...), B a multiple of ``microbatches`` (default: one a pipe
    rank, the fewest that fill the ring). Equal to the stages in series;
    every rank returns the whole output.
    """
    npipe = axis_size(mesh, axis)

    def chain(a):
        for st in local_stages:
            a = stage_fn(st, a)
        return a

    if npipe == 1:
        return chain(x)
    group, r = mesh.get_group(axis), axis_rank(mesh, axis)
    m = microbatches or min(npipe, x.shape[0])
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} must divide microbatches {m}")
    mbs = copy_to_group(x, group).chunk(m)
    first = 1.0 if r == 0 else 0.0
    last = r == npipe - 1
    state = torch.zeros_like(mbs[0])
    outs = []
    ticks = m + npipe - 1
    for t in range(ticks):
        # rank 0 takes microbatch t (clamped: its late ticks are unused);
        # the others what came in; both stay in the graph, as jnp.where
        state = mbs[min(t, m - 1)] * first + state * (1.0 - first)
        y = chain(state)
        if t >= npipe - 1:
            outs.append(y)
        if t + 1 < ticks:
            state = _HandOver.apply(y, group, r, npipe)
    out = torch.cat(outs)
    return reduce_from_group(out if last else out * 0.0, group)


def pipeline_forward(net: nn.Module, x: torch.Tensor, mesh,
                     axis: str = "pipe", microbatches: int | None = None,
                     local_stages: Sequence[nn.Module] | None = None):
    """Whole-model pipelined forward: the replicated head and tail of
    ``net`` (``SRShell.head`` / ``tail``), its group stack pipelined over
    mesh[axis]. ``local_stages``: this rank's groups (default: its share
    of ``net.layers``)."""
    if local_stages is None:
        pp_stage(net)
        local_stages = _local_share(list(net.layers), mesh, axis)
    feat, body = net.head(x)
    body = pipeline_apply(stage_apply, local_stages, body, mesh, axis,
                          microbatches)
    return net.tail(body, feat, x)


def _local_share(layers: list, mesh, axis: str) -> list:
    npipe, r = axis_size(mesh, axis), axis_rank(mesh, axis)
    if len(layers) % npipe:
        raise ValueError(f"{len(layers)} stages don't divide {npipe} pipe "
                         f"ranks")
    k = len(layers) // npipe
    return layers[r * k:(r + 1) * k]


class _Shared:
    """Held by reference through ``copy.deepcopy`` (the mesh of a
    :class:`PipelineModel` and of its EMA copy)."""

    def __init__(self, value):
        self.value = value

    def __deepcopy__(self, memo):
        return self


class PipelineModel(nn.Module):
    """The PP layout of a network (JAX ``init_pp_params``): ``rest`` is a
    copy of the network without its groups (head and tail, replicated),
    ``stages`` copies of this rank's share of the groups. Its parameters
    are what an optimizer of a pipe rank updates. ``tp_axis``: also run
    the groups head- and hidden-parallel over that axis (TP x PP)."""

    def __init__(self, net: nn.Module, mesh, axis: str = "pipe",
                 tp_axis: str | None = None,
                 microbatches: int | None = None):
        super().__init__()
        self.names, _ = pp_stage(net)
        self._mesh = _Shared(mesh)
        self.axis, self.tp_axis = axis, tp_axis
        self.microbatches = microbatches
        layers = net.layers
        share = _local_share(list(layers), mesh, axis)
        net.layers = nn.ModuleList()
        try:
            self.rest = copy.deepcopy(net)
        finally:
            net.layers = layers
        self.stages = copy.deepcopy(nn.ModuleList(share))

    @property
    def mesh(self):
        return self._mesh.value

    def forward(self, x):
        with tp_attention(self.mesh if self.tp_axis else None,
                          self.tp_axis or "model"):
            return pipeline_forward(self.rest, x, self.mesh, self.axis,
                                    self.microbatches,
                                    local_stages=list(self.stages))


def init_pp_params(net: nn.Module, mesh, axis: str = "pipe",
                   tp_axis: str | None = None,
                   microbatches: int | None = None) -> PipelineModel:
    """The PP layout of ``net`` (:class:`PipelineModel`)."""
    return PipelineModel(net, mesh, axis, tp_axis, microbatches)


@torch.no_grad()
def merge_pp_params(pp: PipelineModel, net: nn.Module) -> nn.Module:
    """Load the PP layout back into the whole network ``net`` on every
    rank (collective over the pipe axis: each group is broadcast from the
    rank that holds it). Returns ``net``."""
    group = pp.mesh.get_group(pp.axis)
    npipe = axis_size(pp.mesh, pp.axis)
    r = axis_rank(pp.mesh, pp.axis)
    k = len(pp.names) // npipe
    rest = pp.rest.state_dict()
    own = net.state_dict()
    for name, t in own.items():
        if name in rest:
            t.copy_(rest[name])
    for i in range(len(pp.names)):
        owner, j = divmod(i, k)
        target = net.layers[i].state_dict()
        if owner == r:
            for name, t in pp.stages[j].state_dict().items():
                target[name].copy_(t)
        for t in target.values():
            broadcast_(t, group, src=owner)
    return net


@torch.no_grad()
def load_pp_params(pp: PipelineModel, net: nn.Module) -> PipelineModel:
    """Load the whole network ``net`` into this rank's part of the PP
    layout (the inverse of :func:`merge_pp_params`; a resumed run)."""
    npipe = axis_size(pp.mesh, pp.axis)
    k = len(pp.names) // npipe
    lo = axis_rank(pp.mesh, pp.axis) * k
    own = net.state_dict()
    for name, t in pp.rest.state_dict().items():
        t.copy_(own[name])
    for j, stage in enumerate(pp.stages):
        src = net.layers[lo + j].state_dict()
        for name, t in stage.state_dict().items():
            t.copy_(src[name])
    return pp


def make_hat_pp_train_step(train_opt: dict):
    """The GPipe training step (JAX ``make_hat_pp_train_step``):
    f(state, batch) -> logs, ``state`` a ``train_loop.TrainState`` over a
    :class:`PipelineModel`. The loss of the pipelined forward, the backward
    through the schedule, one optimizer update of each rank's own
    parameters (its groups, and the replicated head and tail, whose
    gradients are equal on every rank); drop path inactive."""
    from super_resolution_tpu_torch.runtime.train_loop import (
        apply_update, build_pixel_criterion, filled_grads)
    from super_resolution_tpu_torch.utils.precision import cast_parameters

    cri_pix = build_pixel_criterion(train_opt)
    ema_decay = train_opt.get("ema_decay", 0)
    use_amp = bool(train_opt.get("use_amp", False))
    clip = train_opt.get("grad_clip_norm")

    def train_step(state, batch: dict, generator=None) -> dict:
        del generator                    # drop path inactive in the stack
        state.optimizer.zero_grad(set_to_none=False)
        lq = batch["lq"]
        if use_amp:
            with cast_parameters(state.net, torch.bfloat16):
                sr = state.net(lq.to(torch.bfloat16)).float()
                l_pix = cri_pix(sr, batch["gt"])
                l_pix.backward()
        else:
            l_pix = cri_pix(state.net(lq).float(), batch["gt"])
            l_pix.backward()
        grads = filled_grads(state)
        if clip:
            clip_pp_global_norm(state.net, clip)
        apply_update(state, ema_decay)
        return {"l_pix": l_pix.detach()}

    return train_step


def clip_pp_global_norm(pp: PipelineModel, max_norm: float) -> None:
    """``optax.clip_by_global_norm`` over the whole network: the groups'
    squared norms summed over the pipe axis, the replicated rest's counted
    once."""
    stage = [p.grad for p in pp.stages.parameters()]
    rest = [p.grad for p in pp.rest.parameters()]

    def sq(gs):
        return sum((g.float().pow(2).sum() for g in gs),
                   torch.zeros((), device=gs[0].device))

    total = all_reduce_(sq(stage), pp.mesh.get_group(pp.axis)) + sq(rest)
    norm = total.sqrt()
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(stage + rest, scale)


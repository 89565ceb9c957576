"""Tensor parallelism for the window-transformer family (port of
super_resolution_tpu/parallel/tp.py; Megatron layout).

Layout (Megatron-LM), over the port's state-dict names; a torch
``Linear.weight`` is (out, in), so column-parallel shards dim 0 and
row-parallel dim 1:

  qkv / fc1 ... weight (kC, C) -> dim 0   activations become feature-sharded,
  qkv / fc1 ... bias   (kC,)   -> dim 0   the nonlinearity stays local and
  proj / fc2 ... weight (C, kC) -> dim 1  the second matmul contracts the
  proj / fc2 ... bias           -> none   sharded dim (one all-reduce).

Convolutions and norms stay replicated.

The kernels compose with TP through the HEAD dim (``tp_attention.py``: a
rank slices its head group's qkv columns, proj rows and bias heads out of
the replicated weights and runs the fused kernel on them) and the MLP
HIDDEN dim (``tp_ffn.py``), each with one all-reduce over ``model``. While
:func:`tp_attention` is active the modules take those routes where the
model axis divides their heads or hidden dim (:func:`tp_route_for`).

:func:`shard_params_tp` holds the weights of the Megatron layout as DTensor
shards over ``model`` (``ColwiseParallel`` / ``RowwiseParallel``) where
their module is called as a module. A block that hands its weights whole to
its kernels (``arch_util.KernelOperands``) keeps them replicated and, where
no head- or hidden-parallel route covers it, launches its kernels on them
whole on every rank (replicated compute).
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np
from torch import nn

# (mesh, axis) while a tensor-parallel forward runs; a contextvar so one TP
# model cannot leak its routing into later models of the process
_TP_ATTN_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "sr_torch_tp_attention", default=None)


@contextlib.contextmanager
def tp_attention(mesh, axis: str = "model"):
    """Route the attention and MLP tails head- and hidden-parallel over
    mesh[axis] for forwards run inside (no-op if mesh is None)."""
    token = _TP_ATTN_CTX.set(None if mesh is None else (mesh, axis))
    try:
        yield
    finally:
        _TP_ATTN_CTX.reset(token)


def tp_attention_ctx():
    """(mesh, axis) while inside :func:`tp_attention`, else None."""
    return _TP_ATTN_CTX.get()


def tp_active() -> bool:
    return _TP_ATTN_CTX.get() is not None


def tp_route_for(n: int):
    """(mesh, axis) where TP is active and its size divides ``n`` (the
    heads, or the hidden dim), else None: the gate of the head- and
    hidden-parallel routes."""
    from super_resolution_tpu_torch.parallel.mesh import axis_size

    ctx = _TP_ATTN_CTX.get()
    if ctx is None or n % axis_size(*ctx):
        return None
    return ctx


# module names whose weights are column-parallel (out dim sharded) /
# row-parallel (in dim sharded): attention in-projections and MLP fc1 /
# out-projections and fc2 (timm naming), ATD's wq/wk/wv, SRFormer's
# linear1/linear2, the Sequential MLP's 0 / 2 under ``mlp``
_COL_PARALLEL = frozenset({"qkv", "q", "kv", "q_proj", "kv_proj", "wqkv",
                           "wq", "wk", "wv", "fc1", "mlp_0", "linear1"})
_ROW_PARALLEL = frozenset({"proj", "fc2", "mlp_2", "linear2"})


def _module_name(names: list) -> str:
    """The module's name for the rules: ``mlp.0`` reads as ``mlp_0``."""
    if len(names) >= 3 and names[-3] == "mlp" and names[-2] in ("0", "2"):
        return f"mlp_{names[-2]}"
    return names[-2]


def tp_spec(name: str, shape) -> int | None:
    """The dim of the parameter ``name`` (a state-dict name) that the
    Megatron layout shards, None for replicated."""
    names = name.split(".")
    if len(names) < 2:
        return None
    module, param = _module_name(names), names[-1]
    ndim = len(shape)
    if module in _COL_PARALLEL and ((param == "weight" and ndim == 2)
                                    or (param == "bias" and ndim == 1)):
        return 0
    if module in _ROW_PARALLEL and param == "weight" and ndim == 2:
        return 1
    return None


def tp_param_specs(state: dict) -> dict:
    """{name: sharded dim or None} of a state dict."""
    return {k: tp_spec(k, tuple(v.shape)) for k, v in state.items()}


def tp_sharded_fraction(state: dict) -> float:
    """Fraction of the parameter bytes the layout shards (a layout probe:
    about 2/3 of a HAT transformer block's bytes)."""
    total = sharded = 0
    for k, v in state.items():
        nbytes = v.numel() * v.element_size() if v.dim() else 0
        total += nbytes
        if tp_spec(k, tuple(v.shape)) is not None:
            sharded += nbytes
    return sharded / max(total, 1)


def _is_mlp_fc1(names: list) -> bool:
    return (len(names) >= 3 and names[-3] == "mlp"
            and names[-2] in ("fc1", "0")) or names[-2] == "mlp_0"


def mlp_hidden_divisible(state: dict, ntp: int) -> bool:
    """True when every fused-routable MLP hidden dim (``mlp.fc1`` or the
    Sequential ``mlp.0`` weights) divides ntp: the gate of the
    hidden-parallel route. False where the state has none."""
    found = False
    for k, v in state.items():
        names = k.split(".")
        if names[-1] == "weight" and v.dim() == 2 and _is_mlp_fc1(names):
            found = True
            if v.shape[0] % ntp:
                return False
    return found


def _kept_replicated(names: list, head_parallel_attn: bool,
                     hidden_parallel_mlp: bool) -> bool:
    if head_parallel_attn and len(names) >= 2 and names[-2] in (
            "attn", "overlap_attn"):
        return True
    return hidden_parallel_mlp and len(names) >= 2 and names[-2] == "mlp"


def tp_plan(net: nn.Module, ntp: int, head_parallel_attn: bool = False,
            hidden_parallel_mlp: bool = False) -> dict:
    """{module name: 'colwise' | 'rowwise'} of the Linear modules the
    Megatron layout shards over ``ntp`` ranks: those the rules name, whose
    sharded dim divides ntp, outside the head- and hidden-parallel routes'
    modules (kept replicated, as JAX's flags keep them) and outside any
    ``KernelOperands`` block (which reads its weights whole)."""
    from super_resolution_tpu_torch.models.arch_util import KernelOperands

    kernel_blocks = [n for n, m in net.named_modules()
                     if isinstance(m, KernelOperands)]
    plan = {}
    for name, mod in net.named_modules():
        if not isinstance(mod, nn.Linear) or not name:
            continue
        names = name.split(".")
        if _kept_replicated(names, head_parallel_attn, hidden_parallel_mlp):
            continue
        if any(b == "" or name.startswith(b + ".") for b in kernel_blocks):
            continue
        dim = tp_spec(name + ".weight", tuple(mod.weight.shape))
        if dim is None or mod.weight.shape[dim] % ntp:
            continue
        plan[name] = "colwise" if dim == 0 else "rowwise"
    return plan


def shard_params_tp(net: nn.Module, mesh, axis: str = "model",
                    head_parallel_attn: bool = False,
                    hidden_parallel_mlp: bool = False) -> dict:
    """Hold the weights of :func:`tp_plan` as DTensor shards over
    mesh[axis] (``parallelize_module`` with ``ColwiseParallel`` /
    ``RowwiseParallel``: the column module's output stays sharded on its
    last dim, the row module all-reduces its partials). Every other
    parameter stays replicated. Returns the plan."""
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   RowwiseParallel,
                                                   parallelize_module)

    from super_resolution_tpu_torch.parallel.mesh import axis_size

    plan = tp_plan(net, axis_size(mesh, axis), head_parallel_attn,
                   hidden_parallel_mlp)
    if plan:
        styles = {k: ColwiseParallel() if v == "colwise"
                  else RowwiseParallel() for k, v in plan.items()}
        sub = mesh[axis] if len(mesh.mesh_dim_names) > 1 else mesh
        parallelize_module(net, sub, styles)
    return plan


def full_state_dict(net: nn.Module) -> dict:
    """``net.state_dict()`` with every DTensor shard gathered whole (for
    checkpoints and the one-process inference path)."""
    from torch.distributed.tensor import DTensor

    return {k: (v.full_tensor() if isinstance(v, DTensor) else v)
            for k, v in net.state_dict().items()}



def heads_divide(heads, ntp: int) -> bool:
    """Whether every group's head count divides ntp (the gate of the
    head-parallel route in ``SRModel.setup_training``)."""
    hs = np.atleast_1d(heads or ())
    return bool(len(hs)) and all(int(h) % ntp == 0 for h in hs)

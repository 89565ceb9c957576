"""The rank functions of the port's parallel tests (``tests/
test_torch_parallel_*.py``), run by ``torch_dist.run_ranks`` on gloo ranks
of the CPU. This module imports no JAX: the parents compute JAX's results
and hand them over in ``payload``; each function returns numpy arrays."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a)).clone().requires_grad_(grad)


def _np(t):
    """A numpy copy of ``t`` (later in-place updates do not reach it)."""
    return t.detach().cpu().numpy().copy()


def _value_and_grads(fn, args):
    """fn(*args) and the gradients of sum(out ** 2) for every input."""
    ins = [_t(a, True) for a in args]
    out = fn(*ins)
    (out ** 2).sum().backward()
    return _np(out), [_np(t.grad) for t in ins]


# ------------------------------------------------------------ tensor parallel
def tp_functions(rank, world, p):
    """The four head- and hidden-parallel functions (and the shifted
    forms) over a (model: world) mesh: output and gradients of each, the
    refusals, the route gate and a DTensor Megatron MLP."""
    from super_resolution_tpu_torch.parallel import tp
    from super_resolution_tpu_torch.parallel.tp_attention import (
        head_parallel_msa_block, head_parallel_ocab_block)
    from super_resolution_tpu_torch.parallel.tp_ffn import (
        hidden_parallel_mlp_block, hidden_parallel_mlp_sum3)

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
    m, o, f = p["msa"], p["ocab"], p["ffn"]
    res = {}
    kw = dict(heads=int(m["heads"]), window_size=int(m["ws"]), mesh=mesh)
    res["msa"] = _value_and_grads(
        lambda *a: head_parallel_msa_block(*a, _t(m["mask0"]), **kw),
        [m[k] for k in ("x", "w_qkv", "b_qkv", "w_proj", "b_proj", "bias")])
    res["msa_shifted"] = _value_and_grads(
        lambda *a: head_parallel_msa_block(*a, _t(m["mask"]), **kw,
                                           shift=int(m["shift"])),
        [m[k] for k in ("x", "w_qkv", "b_qkv", "w_proj", "b_proj", "bias")])
    res["ocab"] = _value_and_grads(
        lambda *a: head_parallel_ocab_block(
            *a, heads=int(o["heads"]), window_size=int(o["ws"]),
            overlap_win=int(o["ow"]), mesh=mesh),
        [o[k] for k in ("x", "lns", "lnb", "w_q", "b_q", "w_kv", "b_kv",
                        "w_proj", "b_proj", "bias")])
    tail = [f[k] for k in ("gamma", "beta", "w1", "b1", "w2", "b2")]
    res["mlp"] = _value_and_grads(
        lambda *a: hidden_parallel_mlp_block(*a, mesh=mesh), [f["x"]] + tail)
    three = [f["x"], f["x"] * 0.5, f["x"] * -0.25]
    res["sum3"] = _value_and_grads(
        lambda *a: hidden_parallel_mlp_sum3(*a, conv_scale=0.01, mesh=mesh),
        three + tail)
    res["sum3_shifted"] = _value_and_grads(
        lambda *a: hidden_parallel_mlp_sum3(*a, conv_scale=0.01, mesh=mesh,
                                            shift=int(m["shift"])),
        [f["x"], f["attn_rolled"], f["x"] * -0.25] + tail)
    out = {k: {"out": v[0], "grads": v[1]} for k, v in res.items()}

    refused = {}
    for case, call in {
        "heads": lambda: head_parallel_msa_block(
            *(_t(m[k]) for k in ("x", "w_qkv", "b_qkv", "w_proj", "b_proj")),
            _t(m["bias"][:3]), None, heads=3, window_size=int(m["ws"]),
            mesh=mesh),
        "hidden": lambda: hidden_parallel_mlp_block(
            _t(f["x"]), _t(f["gamma"]), _t(f["beta"]), _t(f["w1"][:, :5]),
            _t(f["b1"][:5]), _t(f["w2"][:5]), _t(f["b2"]), mesh=mesh),
    }.items():
        try:
            call()
            refused[case] = ""
        except ValueError as e:
            refused[case] = str(e)
    out["refused"] = refused

    with tp.tp_attention(mesh):
        route = [tp.tp_active(), tp.tp_route_for(4) is not None,
                 tp.tp_route_for(3) is not None]
    route += [tp.tp_active(), tp.tp_route_for(4) is not None]
    out["route"] = route

    out["plain_routes"] = _fork_routes_under_tp(mesh, p["fork"])

    # a Megatron MLP as DTensor shards: fc1 column-, fc2 row-parallel
    torch.manual_seed(0)
    net = _TinyMlp()
    ref_in = torch.randn(4, 16)
    ref_out = net(ref_in)
    ref_out.square().sum().backward()
    ref_grads = [p.grad.clone() for p in net.parameters()]
    net.zero_grad()
    plan = tp.shard_params_tp(net, mesh)
    y = net(ref_in)
    y.square().sum().backward()
    out["dtensor"] = {
        "plan": plan, "out_err": float((y - ref_out).abs().max()),
        "grad_err": max(float((p.grad.full_tensor() - g).abs().max())
                        for p, g in zip(net.parameters(), ref_grads)),
        "sharded": [type(p).__name__ for p in net.parameters()]}
    return out


def _fork_routes_under_tp(mesh, net_opt):
    """The fork's HAT forward without and under ``tp_attention``: the calls
    of its kernel wrappers (the routes without a TP composition call them
    on the whole weights, the OCAB tail on the rank's hidden slice) and
    the output of each."""
    from super_resolution_tpu_torch.models import build_network
    from super_resolution_tpu_torch.models.arch_util import init_weights
    from super_resolution_tpu_torch.ops import (cuda_attention, cuda_ffn,
                                                cuda_hab)
    from super_resolution_tpu_torch.parallel.tp import tp_attention

    net = build_network(dict(net_opt))
    init_weights(net, torch.Generator().manual_seed(0))
    calls = {}
    for mod, name in ((cuda_ffn, "gated_dconv_ffn_block"),
                      (cuda_hab, "ln_split"),
                      (cuda_attention, "fused_ocab_attention"),
                      (cuda_ffn, "mlp_block")):
        orig = getattr(mod, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*a, **k)
        setattr(mod, name, spy)
    x = torch.rand((1, 16, 16, 3), generator=torch.Generator().manual_seed(1))
    res = {}
    for label, ctx in (("plain", None), ("tp", mesh)):
        calls.clear()
        with torch.no_grad(), tp_attention(ctx):
            res[label] = {"out": _np(net.eval()(x)), "calls": dict(calls)}
    return res


class _TinyMlp(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.mlp = torch.nn.Module()
        self.mlp.fc1 = torch.nn.Linear(16, 32)
        self.mlp.fc2 = torch.nn.Linear(32, 16)

    def forward(self, x):
        return self.mlp.fc2(torch.nn.functional.gelu(self.mlp.fc1(x)))


def _sr_model(opt):
    from super_resolution_tpu_torch.runtime.sr_model import HATModel

    return HATModel(opt, device="cpu")


def tp_hat_classic(rank, world, p):
    """A HATClassic forward under ``tp_attention`` (the split and the
    fused_hab_block routes) and one TP train step through
    ``SRModel.setup_training`` on a (model: world) mesh."""
    from super_resolution_tpu_torch.models import hat_classic_arch as hc
    from super_resolution_tpu_torch.parallel.tp import tp_attention

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
    model = _sr_model(p["opt"])
    x = _t(p["lq"])
    calls = {}
    for name in ("head_parallel_msa_block", "head_parallel_ocab_block",
                 "hidden_parallel_mlp_sum3", "hidden_parallel_mlp_block",
                 "fused_hab_block_ad", "fused_msa_block_ad"):
        orig = getattr(hc, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*a, **k)
        setattr(hc, name, spy)
    with torch.no_grad(), tp_attention(mesh):
        out = model.net_g(x)
        for blk in model.net_g.modules():
            if hasattr(blk, "hab_route"):
                blk.hab_route = "fused_hab_block"
        out_fused = model.net_g(x)
        for blk in model.net_g.modules():
            if hasattr(blk, "hab_route"):
                blk.hab_route = "split"
    model.setup_training(mesh)
    model.optimize_parameters({"lq": p["lq"], "gt": p["gt"]}, 1)
    return {"out": _np(out), "out_fused": _np(out_fused),
            "calls": calls, "loss": float(model.log_dict["l_pix"]),
            "params": {k: _np(v) for k, v in
                       model.net_g.state_dict().items()},
            "head_par": model._tp_head_par, "hid_par": model._tp_hid_par}


def tp_all(rank, world, p):
    """:func:`tp_functions` and :func:`tp_hat_classic` in one spawn."""
    return {"functions": tp_functions(rank, world, p),
            "classic": tp_hat_classic(rank, world, p["classic"])}


# ------------------------------------------------------------- data parallel
def dp_runner(rank, world, p):
    """One data-parallel SRModel step on this rank's share of the batch;
    process-sharded against whole-set validation; multi-rank tiled and
    bucketed evaluation."""
    from super_resolution_tpu_torch.parallel.mesh import (make_mesh_from_spec,
                                                          shard_batch)

    mesh = make_mesh_from_spec({"data": -1}, device_type="cpu")
    model = _sr_model(p["opt"])
    model.setup_training(mesh)
    batch = shard_batch({"lq": p["lq"], "gt": p["gt"]}, mesh)
    model.optimize_parameters(batch, 1)
    out = {"params": {k: _np(v) for k, v in
                      model.net_g.state_dict().items()},
           "ema": {k: _np(v) for k, v in
                   model.state.ema.state_dict().items()},
           "log": model.get_current_log()}

    val = _ListLoader(p["val"])
    model.validation(val, 1)
    out["dist_metrics"] = dict(model.metric_results)
    model.nondist_validation(val, 1, False)
    out["nondist_metrics"] = dict(model.metric_results)

    tiled = _sr_model(dict(p["opt"], tile=dict(p["tile"], multichip=True)))
    tiled.feed_data({"lq": p["val"][0]["lq"][None]})
    tiled._run_inference()
    out["tiled"] = _np(tiled.output)
    lqs = [torch.from_numpy(v["lq"][None]) for v in p["val"]]
    with torch.inference_mode():
        from super_resolution_tpu_torch.runtime.batched_eval import \
            bucketed_tile_eval
        outs = bucketed_tile_eval(tiled._apply_fn(), lqs, 2,
                                  p["tile"]["tile_size"],
                                  p["tile"]["tile_pad"], chunk=3,
                                  mesh=tiled._tile_mesh())
    out["bucketed"] = [_np(o) for o in outs]
    return out


class _ListLoader:
    """An eval loader over a list of {'lq', 'gt', 'lq_path'} items."""

    def __init__(self, items):
        self.items = items
        self.dataset = self

    opt = {"name": "tiny_val"}

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def __iter__(self):
        for it in self.items:
            yield {"lq": it["lq"][None], "gt": it["gt"][None],
                   "lq_path": [it["lq_path"]]}


# ---------------------------------------------------------- pipeline, spatial
def pp_and_spatial(rank, world, p):
    """Pipelined forwards of the five archs and a GPipe train step over a
    (pipe: world) mesh; the row-sharded forward of a small CNN and its
    refusals over a (data: world) mesh."""
    from super_resolution_tpu_torch.models import build_network
    from super_resolution_tpu_torch.models.arch_util import init_weights
    from super_resolution_tpu_torch.parallel.pipeline import (
        merge_pp_params, pipeline_forward)
    from super_resolution_tpu_torch.parallel.spatial import \
        spatial_shard_forward

    pipe = init_device_mesh("cpu", (world,), mesh_dim_names=("pipe",))
    out = {"forward": {}}
    for name, net_opt in p["nets"].items():
        net = build_network(dict(net_opt))
        init_weights(net, torch.Generator().manual_seed(0))
        with torch.no_grad():
            out["forward"][name] = _np(pipeline_forward(
                net.eval(), _t(p["x"]), pipe, microbatches=2))

    model = _sr_model(p["opt"])
    model.setup_training(pipe)
    model.optimize_parameters({"lq": p["lq"], "gt": p["gt"]}, 1)
    out["loss"] = float(model.log_dict["l_pix"])
    out["params"] = {k: _np(v) for k, v in model.net_g.state_dict().items()}
    merge_pp_params(model.state.net, model.net_g)
    out["resume"] = _pp_resume(model, pipe, p)

    data = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    ks = [_t(k) for k in p["cnn"]]

    def cnn(x):
        y = x.permute(0, 3, 1, 2)
        for k in ks[:-1]:
            y = torch.nn.functional.leaky_relu(
                torch.nn.functional.conv2d(y, k, padding=k.shape[-1] // 2))
        y = torch.nn.functional.conv2d(y, ks[-1], padding=1)
        y = torch.nn.functional.pixel_shuffle(y, 2)
        return y.permute(0, 2, 3, 1)

    img = _t(p["img"])
    out["spatial"] = _np(spatial_shard_forward(cnn, img, 2, data, halo=8))
    out["cnn"] = _np(cnn(img))
    refused = []
    band = img.shape[1] // world
    for bad in (dict(img=img[:, :-1], halo=2), dict(img=img, halo=band)):
        try:
            spatial_shard_forward(cnn, bad["img"], 2, data, halo=bad["halo"])
            refused.append("")
        except ValueError as e:
            refused.append(str(e))
    out["refused"] = refused
    return out


def _pp_resume(model, pipe, p) -> dict:
    """The runner after step 1 checkpointed (every rank builds the tree,
    rank 0 writes it), then step 2 run on; two new runners resumed from
    the checkpoint, with and without its per-pipe-rank optimizer state,
    take step 2 too. Returns each one's weights."""
    from super_resolution_tpu_torch.runtime import checkpoint

    path = os.path.join(p["ckpt"], "net_g_1")
    checkpoint.save_params(path, model.checkpoint_tree(0, 1))
    dist.barrier()
    tree = checkpoint.load_tree(path)
    step2 = {"lq": p["lq2"], "gt": p["gt2"]}
    model.optimize_parameters(step2, 2)
    out = {"straight": model.net_g.state_dict()}
    for label, t in (("resumed", tree),
                     ("no_moments", {k: v for k, v in tree.items()
                                     if k != "opt_state_pp"})):
        resumed = _sr_model(p["opt"])
        resumed.setup_training(pipe)
        resumed.resume_from_tree(t)
        resumed.optimize_parameters(step2, 2)
        out[label] = resumed.net_g.state_dict()
    out["pipe_ranks_saved"] = len(tree["opt_state_pp"])
    return {k: ({n: _np(v) for n, v in sd.items()} if isinstance(sd, dict)
                else sd) for k, sd in out.items()}


def tp_pp(rank, world, p):
    """One GPipe step with tensor-parallel stages over (pipe 2, model 2)."""
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pipe", "model"))
    model = _sr_model(p["opt"])
    model.setup_training(mesh)
    model.optimize_parameters({"lq": p["lq"], "gt": p["gt"]}, 1)
    return {"loss": float(model.log_dict["l_pix"]),
            "params": {k: _np(v) for k, v in
                       model.net_g.state_dict().items()}}


def world_size_check(rank, world, p):
    return {"world": dist.get_world_size()}


def runner_nets(model) -> dict:
    """{'g', 'd', 'ema' where the runner has them: state dict as numpy}."""
    nets = {"g": model.net_g, "d": getattr(model, "net_d", None),
            "ema": getattr(model, "net_g_ema", None)}
    state = getattr(model, "state", None)
    if state is not None and getattr(state, "ema", None) is not None:
        nets["ema"] = state.ema
    return {k: {n: _np(v) for n, v in net.state_dict().items()}
            for k, net in nets.items() if net is not None}


def runner_grads(model) -> dict:
    """{'g', 'd' where the runner has it: the gradients its last update
    applied (each step zeroes them first and keeps them), as numpy}."""
    nets = {"g": model.net_g, "d": getattr(model, "net_d", None)}
    return {k: {n: _np(p.grad) for n, p in net.named_parameters()
                if p.grad is not None}
            for k, net in nets.items() if net is not None}


def runner_iteration(model, batch: dict, current_iter: int):
    """One iteration of a runner on ``batch``; a runner that draws
    (``make_draws``: StyleGAN2Model) draws here and the draws are
    returned (else None)."""
    if not hasattr(model, "make_draws"):
        model.optimize_parameters(batch, current_iter)
        return None
    model.feed_data(batch)
    draws = model.make_draws(model.real_img.shape[0], current_iter)
    model.train_iteration(draws, current_iter)
    return draws


def runners_dp(rank, world, p):
    """One data-parallel iteration of each runner of ``p['cases']`` over a
    (data: world) mesh, each rank on its share of the batch: the networks
    after it, the gradients of their last updates, the draws it made,
    whether G moved, and the running path length (StyleGAN2Model)."""
    from super_resolution_tpu_torch.parallel.mesh import shard_batch
    from super_resolution_tpu_torch.runtime import build_model

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    out = {}
    for name, case in p["cases"].items():
        model = build_model(dict(case["opt"]), "cpu")
        before = {k: v.clone() for k, v in model.net_g.state_dict().items()}
        model.setup_training(mesh)
        draws = runner_iteration(model, shard_batch(case["batch"], mesh),
                                 case["iter"])
        out[name] = {
            "nets": runner_nets(model), "grads": runner_grads(model),
            "draws": draws,
            "moved": any(not torch.equal(v, before[k]) for k, v in
                         model.net_g.state_dict().items()),
            "extra": float(getattr(model, "mean_path_length", 0.0))}
    return out

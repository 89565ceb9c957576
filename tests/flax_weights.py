"""Random flax parameters of a module's shapes, carried into a port module
by the flax bridge: the weights of the port tests that hold a module
against its JAX counterpart without a flax init (``jax.eval_shape`` gives
the tree's shapes; an init costs seconds a network)."""

import jax
import jax.numpy as jnp
import numpy as np

from super_resolution_tpu_torch.convert.flax_bridge import flax_to_state_dict


def random_params(shapes, rng):
    """A param tree of the shapes' structure, every leaf non-zero: kernels
    N(0, 1 / fan_in), the large-kernel OIHW filters likewise, LayerNorm
    scales 1 + N(0, 0.1), biases and other vectors N(0, 0.1), RPB tables
    N(0, 1)."""
    def draw(path, s):
        name = jax.tree_util.keystr(path)
        shape = tuple(s.shape)
        z = rng.standard_normal(shape).astype(np.float32)
        if "relative_position_bias_table" in name:
            return z
        if name.endswith("['scale']"):
            return 1.0 + 0.1 * z
        if len(shape) <= 1:
            return 0.1 * z
        fan = (np.prod(shape[1:]) if name.endswith(("plk_filter']",
                                                    "esc_plk']"))
               else np.prod(shape[:-1]))
        return z / np.sqrt(fan)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def bridge(jmod, tmod, rng, *args, **kw):
    """Random params of ``jmod`` applied to ``args`` (numpy arrays), loaded
    strict into ``tmod``; returns the flax params."""
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args), **kw))
    params = random_params(shapes["params"], rng)
    tmod.load_state_dict(flax_to_state_dict(params, tmod), strict=True)
    return params


def converge_sn(tree, rng, iterations: int = 30):
    """Set every spectral-norm conv's stored ``weight_u`` / ``weight_v`` of
    a flax tree to the power iteration's on its ``weight_orig``, in place,
    as a trained checkpoint holds them: drawn at random, u . (W v) can be
    near 0 and the conv's weight W / sigma huge. Returns the tree."""
    for value in tree.values():
        if not isinstance(value, dict):
            continue
        if "weight_orig" not in value:
            converge_sn(value, rng, iterations)
            continue
        w = np.asarray(value["weight_orig"], np.float64)
        w = w.reshape(w.shape[0], -1)
        v = rng.standard_normal(w.shape[1])
        for _ in range(iterations):
            u = w @ v
            u /= np.linalg.norm(u)
            v = w.T @ u
            v /= np.linalg.norm(v)
        u = w @ v
        value["weight_u"] = (u / np.linalg.norm(u)).astype(np.float32)
        value["weight_v"] = v.astype(np.float32)
    return tree

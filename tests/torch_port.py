"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py).

Both packages get the same numbers: JAX variables are drawn with numpy from a
seed on the shapes ``jax.eval_shape`` reports for ``model.init`` (nothing
compiles), then carried into the port with ``state_dict_from_jax``. Weights
are drawn at U(+-sqrt(3 / fan_in)) with BatchNorm statistics away from the
identity, so the head's logits carry signal: at the default init they are
the bias alone and their order would be decided by float rounding.
"""

from __future__ import annotations

import numpy as np


def jax_spec(name: str, scale: str = ""):
    from bsyolo_tpu.cfg import model_yaml_path
    from bsyolo_tpu.nn import load_model_yaml, parse_model_yaml

    d = load_model_yaml(model_yaml_path(name))
    return parse_model_yaml(d, scale=scale or d.get("scale", ""))


def port_spec(name: str, scale: str = ""):
    from bsyolo_tpu_torch.cfg import model_yaml_path
    from bsyolo_tpu_torch.nn.parser import load_model_yaml, parse_model_yaml

    d = load_model_yaml(model_yaml_path(name))
    return parse_model_yaml(d, scale=scale or d.get("scale", ""))


def variable_shapes(module, x_shape):
    """Variable shapes of a flax module's init, without compiling it."""
    import jax
    import jax.numpy as jnp

    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.zeros(x_shape, jnp.float32), train=False))


def random_variables(shapes, seed: int = 0):
    """Fill a variables shape-tree with seeded numpy draws (see module docstring)."""
    import jax

    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf = path[-1].key
        shape = tuple(s.shape)
        if leaf == "kernel":
            b = np.sqrt(3.0 / int(np.prod(shape[:-1])))
            v = rng.uniform(-b, b, shape)
        elif leaf in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf in ("ch_weight", "sp_weight", "res_weight"):
            v = rng.uniform(-1.0, 1.0, shape)
        else:  # bias, mean
            v = rng.uniform(-0.1, 0.1, shape)
        return v.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return jax.tree_util.tree_map(np.asarray, tree)


def to_plain_dict(tree):
    """Nested mappings (flax FrozenDict included) -> nested dicts."""
    if hasattr(tree, "items"):
        return {k: to_plain_dict(v) for k, v in tree.items()}
    return tree


def port_module_from_jax(module, variables):
    """Load JAX ``variables`` into a port ``module`` with every key matched; eval mode."""
    from bsyolo_tpu_torch.utils.weights import state_dict_from_jax

    module.load_state_dict(state_dict_from_jax(to_plain_dict(variables)), strict=True)
    return module.eval()


def nchw(x):
    return np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2))


def nhwc(x):
    return np.ascontiguousarray(np.asarray(x).transpose(0, 2, 3, 1))

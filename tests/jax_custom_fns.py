"""JAX functions that the JAX package's custom-layer tests name by import
path (``jax_custom_fns:<name>``): the counterparts of
``torch_custom_fns``."""

import jax
import jax.numpy as jnp


def scaled_tanh(x, scale=1.0):
    return jnp.tanh(x) * scale


def affine_init(key, input_shape, n_out=3):
    return {"w": jax.random.normal(key, (input_shape[-1], n_out)) * 0.3,
            "b": jnp.zeros((n_out,))}


def affine(params, x, *, training=False, shift=0.0, n_out=3):
    y = x @ params["w"] + params["b"] + shift
    return y if training else jax.nn.relu(y)

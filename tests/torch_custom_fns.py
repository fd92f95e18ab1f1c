"""PyTorch functions that the port's custom-layer tests name by import
path (``torch_custom_fns:<name>``); ``jax_custom_fns`` holds the JAX
package's counterparts."""

import torch


def scaled_tanh(x, scale=1.0):
    return torch.tanh(x) * scale


def affine_init(gen, input_shape, n_out=3):
    g = torch.Generator().manual_seed(0) if gen is None else gen
    return {"w": torch.randn((input_shape[-1], n_out), generator=g) * 0.3,
            "b": torch.zeros((n_out,))}


def affine(params, x, *, training=False, shift=0.0, n_out=3):
    y = x @ params["w"] + params["b"] + shift
    return y if training else torch.relu(y)

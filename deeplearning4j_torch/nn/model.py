"""Sequential network container — counterpart of ``Sequential``,
``SequentialBuilder`` and ``NetConfig`` in ``deeplearning4j_tpu/nn/model.py``.

A container is a config plus pure functions over a params dict keyed by
layer name (``layer_i`` unless the layer is named), the reference's tree:
params cross between the packages key for key. ``to_json``/``from_json``
write and read the reference's ``deeplearning4j_tpu/sequential/v1`` format.

Mixed precision follows the reference: with ``compute_dtype`` set, each
layer's float params are cast to it at the layer, a float input is cast,
and the output is cast back to ``dtype``. ``score`` runs every layer but
the last that way and then the output layer on the f32 features with its
uncast params, as the reference does: a bf16 model's training loss (the
head and its log-softmax) is f32. ``NetConfig.remat`` checkpoints each
layer through ``torch.utils.checkpoint``. ``Graph`` comes in a later slice.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.utils.checkpoint

from ..device import DeviceLike, resolve_device
from ..ops.losses import reduction_mass
from .api import Layer, Params, Shape, State, layer_from_dict

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64}
FORMAT = "deeplearning4j_tpu/sequential/v1"


def _cast_floats(tree, cdt):
    if isinstance(tree, dict):
        return {k: _cast_floats(v, cdt) for k, v in tree.items()}
    return tree.to(cdt) if tree.is_floating_point() else tree


@dataclass
class NetConfig:
    """Global config (the reference's fields, so its JSON round-trips)."""

    seed: int = 12345
    dtype: str = "float32"
    updater: Union[str, dict] = field(
        default_factory=lambda: {"type": "sgd", "learning_rate": 1e-1})
    l1: float = 0.0
    l2: float = 0.0
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    tbptt_length: int = 0
    compute_dtype: Optional[str] = None  # e.g. "bfloat16"
    remat: bool = False

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(**d)


def _layer_key(i: int, layer: Layer) -> str:
    return layer.name or f"layer_{i}"


def _is_loss_layer(layer) -> bool:
    return hasattr(layer, "score")


def _apply_layer(cfg: NetConfig, layer: Layer, p, s, x, *, training, rng,
                 mask):
    """One layer, checkpointed when ``cfg.remat`` asks for it — unless the
    layer checkpoints itself (its own ``remat=True``): nesting would
    recompute twice for no memory saved. Checkpointing only applies while
    autograd records."""
    if cfg.remat and not getattr(layer, "remat", False) \
            and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(
            lambda p_, x_: layer.apply(p_, s, x_, training=training, rng=rng,
                                       mask=mask),
            p, x, use_reentrant=False)
    return layer.apply(p, s, x, training=training, rng=rng, mask=mask)


class Sequential:
    """An ordered stack of layers on one device (the card unless
    ``device`` names another)."""

    def __init__(self, config: NetConfig, layers: Sequence[Layer],
                 input_shape: Shape, device: DeviceLike = None):
        self.config = config
        self.layers = list(layers)
        self.input_shape = tuple(input_shape)
        self.device = resolve_device(device)
        self.dtype = DTYPES[config.dtype]
        self._shapes = [self.input_shape]
        for layer in self.layers:
            self._shapes.append(tuple(layer.output_shape(self._shapes[-1])))
        self.params: Optional[Params] = None
        self.state: Optional[State] = None

    @property
    def output_shape(self) -> Shape:
        return self._shapes[-1]

    def _init_on(self, gen, device) -> Tuple[Params, State]:
        params: Params = {}
        state: State = {}
        for i, layer in enumerate(self.layers):
            p, s = layer.init(gen, self._shapes[i], self.dtype, device)
            if p:
                params[_layer_key(i, layer)] = p
            if s:
                state[_layer_key(i, layer)] = s
        return params, state

    def init(self, seed: Optional[int] = None) -> Tuple[Params, State]:
        """Random params on the model's device from a ``torch.Generator``
        seeded with ``seed`` (default ``config.seed``)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.config.seed if seed is None else seed)
        self.params, self.state = self._init_on(gen, self.device)
        return self.params, self.state

    def param_shapes(self) -> Dict[str, dict]:
        """The params tree's shapes, computed without allocating."""
        params, _ = self._init_on(None, torch.device("meta"))

        def shapes(tree):
            if isinstance(tree, dict):
                return {k: shapes(v) for k, v in tree.items()}
            return tuple(tree.shape)

        return shapes(params)

    def param_count(self) -> int:
        if self.params is None:
            raise ValueError("call init() first")

        def count(tree):
            if isinstance(tree, dict):
                return sum(count(v) for v in tree.values())
            return tree.numel()

        return count(self.params)

    def forward(self, params: Params, state: State, x: torch.Tensor, *,
                training: bool = False, rng: Optional[torch.Generator] = None,
                mask: Optional[torch.Tensor] = None,
                up_to: Optional[int] = None, return_mask: bool = False):
        """Apply the first ``up_to`` layers (default all); returns
        ``(y, new_state)``, plus the layer-propagated mask with
        ``return_mask=True`` (the mask the loss reduces with)."""
        n = len(self.layers) if up_to is None else up_to
        new_state = dict(state)
        cdt = DTYPES[self.config.compute_dtype] if self.config.compute_dtype else None
        if cdt is not None and x.is_floating_point():
            x = x.to(cdt)
        for i in range(n):
            layer = self.layers[i]
            k = _layer_key(i, layer)
            p = params.get(k, {})
            if cdt is not None:
                p = _cast_floats(p, cdt)
            x, s_out, mask = _apply_layer(self.config, layer, p,
                                          state.get(k, {}), x,
                                          training=training, rng=rng,
                                          mask=mask)
            if s_out:
                new_state[k] = s_out
        if cdt is not None:
            x = x.to(self.dtype)
        if return_mask:
            return x, new_state, mask
        return x, new_state

    def score(self, params: Params, state: State, x: torch.Tensor,
              labels: torch.Tensor, *, training: bool = True,
              rng: Optional[torch.Generator] = None,
              mask: Optional[torch.Tensor] = None,
              label_mask: Optional[torch.Tensor] = None,
              with_mass: bool = False):
        """Training loss (a 0-d f32 tensor) and the new state. The loss
        reduces with ``label_mask`` when given, else with the
        layer-propagated feature mask. The output layer scores the f32
        features with its f32 params, whatever ``compute_dtype`` is.
        ``with_mass=True`` also returns ``losses.reduction_mass``."""
        out_layer = self.layers[-1]
        if not _is_loss_layer(out_layer):
            raise ValueError("Last layer must be an Output/Loss layer to "
                             "compute score")
        feats, new_state, prop_mask = self.forward(
            params, state, x, training=training, rng=rng, mask=mask,
            up_to=len(self.layers) - 1, return_mask=True)
        k = _layer_key(len(self.layers) - 1, out_layer)
        eff_mask = label_mask if label_mask is not None else prop_mask
        loss = out_layer.score(params.get(k, {}), state.get(k, {}), feats,
                               labels, mask=eff_mask)
        if with_mass:
            return loss, new_state, reduction_mass(labels, eff_mask)
        return loss, new_state

    def output(self, x, params: Optional[Params] = None,
               state: Optional[State] = None, mask=None) -> torch.Tensor:
        """Inference on ``x`` (a tensor or array; moved to the model's
        device) with the given or the model's own params."""
        p = params if params is not None else self.params
        s = state if state is not None else self.state
        if p is None:
            raise ValueError("call init() first")
        x = torch.as_tensor(x, device=self.device)
        with torch.inference_mode():
            y, _ = self.forward(p, s, x, training=False, mask=mask)
        return y

    def to_json(self) -> str:
        return json.dumps({
            "format": FORMAT,
            "config": self.config.to_dict(),
            "input_shape": list(self.input_shape),
            "layers": [l.to_dict() for l in self.layers],
        }, indent=2)

    @classmethod
    def from_json(cls, s: str, device: DeviceLike = None) -> "Sequential":
        d = json.loads(s)
        if "sequential" not in d.get("format", ""):
            raise ValueError(f"not a Sequential config: format "
                             f"{d.get('format')!r} (Graph is not ported yet)")
        return cls(NetConfig.from_dict(d["config"]),
                   [layer_from_dict(ld) for ld in d["layers"]],
                   tuple(d["input_shape"]), device=device)


class SequentialBuilder:
    """Fluent builder: ``.input_shape(...).layer(...).build()``."""

    def __init__(self, config: Optional[NetConfig] = None,
                 device: DeviceLike = None):
        self.config = config or NetConfig()
        self.device = device
        self._layers: List[Layer] = []
        self._input_shape: Optional[Shape] = None

    def input_shape(self, *shape: int) -> "SequentialBuilder":
        self._input_shape = tuple(shape)
        return self

    def layer(self, layer: Layer) -> "SequentialBuilder":
        self._layers.append(layer)
        return self

    def build(self) -> Sequential:
        if self._input_shape is None:
            raise ValueError("set input_shape first")
        return Sequential(self.config, self._layers, self._input_shape,
                          device=self.device)

"""The reference's parameter init rule (``repro.parallel.sharding.
ParamCollector.param``), drawn with a ``torch.Generator`` on the target
device.

* ``"normal"``: standard normal x 0.02;
* ``"scaled"``: standard normal x ``1/sqrt(shape[0])`` of the reference's
  shape, whose leading dimension is the stacked layer count for block
  weights: ``fan`` carries it here, where block weights live per layer;
* ``"ones"`` and ``"zeros"``: what they say.

Draws are float32, then cast to the parameter dtype. The numbers differ
from ``jax.random``'s; the shapes and the distribution are the reference's.
"""
from __future__ import annotations

import math

import torch

INIT_SCALE = 0.02
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name."""
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


class ParamInit:
    """Draws parameters in call order from one seeded generator on
    ``device`` (so a full-size model is drawn on the card, not the host)."""

    def __init__(self, seed: int, device: torch.device,
                 param_dtype: str = "float32"):
        self.device = device
        self.dtype = torch_dtype(param_dtype)
        self.generator = torch.Generator(device=device).manual_seed(seed)

    def param(self, shape: tuple[int, ...], init: str = "normal", *,
              fan: int | None = None) -> torch.Tensor:
        """One parameter of ``shape``; ``fan`` is the reference's
        ``shape[0]`` for ``"scaled"`` (default: this shape's own)."""
        if init == "zeros":
            return torch.zeros(shape, dtype=self.dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=self.dtype, device=self.device)
        if init == "normal":
            scale = INIT_SCALE
        elif init == "scaled":
            scale = 1.0 / math.sqrt(max(fan if fan is not None else shape[0],
                                        1))
        else:
            raise ValueError(f"unknown init {init!r}")
        t = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                        device=self.device)
        return t.mul_(scale).to(self.dtype)

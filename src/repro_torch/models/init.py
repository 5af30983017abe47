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

Each ``param`` call names its logical axes (``axes=``, copied from the
reference's init site without the stacked-layer ``None``: the port keeps
one dict a layer), and ``axes_of(tree)`` gives them by tree path, the
reference's ``ParamCollector.axes``, for ``parallel.tree_shardings``. On
``torch.device("meta")`` nothing is drawn or allocated (the reference's
``abstract=True``), so a full-size tree can be laid out on any host.
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
    ``device`` (so a full-size model is drawn on the card, not the host),
    and records each one's logical axes."""

    def __init__(self, seed: int, device: torch.device,
                 param_dtype: str = "float32"):
        self.device = torch.device(device)
        self.dtype = torch_dtype(param_dtype)
        self.generator = (None if self.device.type == "meta" else
                          torch.Generator(device=device).manual_seed(seed))
        self._axes: dict[int, tuple] = {}     # id -> (tensor, axes)

    def param(self, shape: tuple[int, ...], init: str = "normal", *,
              axes: tuple[str | None, ...] | None = None,
              fan: int | None = None) -> torch.Tensor:
        """One parameter of ``shape`` whose dims carry the logical ``axes``
        (none recorded: replicated); ``fan`` is the reference's ``shape[0]``
        for ``"scaled"`` (default: this shape's own)."""
        if axes is not None and len(axes) != len(shape):
            raise ValueError(f"axes {axes} for shape {shape}")
        t = self._draw(shape, init, fan)
        if axes is not None:
            self._axes[id(t)] = (t, tuple(axes))
        return t

    def axes_of(self, tree) -> dict[str, tuple]:
        """{path: axes} of the parameters of ``tree`` drawn here: dict keys
        joined by ``/``; a segment's layers (list items) share one path,
        so they must record the same axes."""
        out: dict[str, tuple] = {}

        def walk(t, prefix):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, f"{prefix}/{k}" if prefix else k)
            elif isinstance(t, list):
                for v in t:
                    walk(v, prefix)
            elif id(t) in self._axes:
                ax = self._axes[id(t)][1]
                if out.setdefault(prefix, ax) != ax:
                    raise ValueError(f"{prefix}: layers record {ax} and "
                                     f"{out[prefix]}")
        walk(tree, "")
        return out

    def _draw(self, shape, init, fan) -> torch.Tensor:
        if init not in ("zeros", "ones", "normal", "scaled"):
            raise ValueError(f"unknown init {init!r}")
        if self.generator is None:
            return torch.empty(shape, dtype=self.dtype, device=self.device)
        if init == "zeros":
            return torch.zeros(shape, dtype=self.dtype, device=self.device)
        if init == "ones":
            return torch.ones(shape, dtype=self.dtype, device=self.device)
        if init == "normal":
            scale = INIT_SCALE
        else:
            scale = 1.0 / math.sqrt(max(fan if fan is not None else shape[0],
                                        1))
        t = torch.randn(shape, generator=self.generator, dtype=torch.float32,
                        device=self.device)
        return t.mul_(scale).to(self.dtype)

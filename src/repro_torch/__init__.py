"""PyTorch + CUDA port of the PLEX serving system (``repro`` is the JAX
reference it is held against).

The host build (spline, auto-tune, radix/CHT layer, sharded snapshot) stays
numpy; lookups run on an NVIDIA GPU through the hand-written CUDA kernel in
``kernels/csrc/stacked_lookup.cu``, with a plain PyTorch version of the same
pipeline for CPU tensors. The LM substrate (``configs``, ``layers``,
``models``, ``serving.engine``, ``launch.serve``) serves every config of
the registry, its GQA prefill attention through the hand-written
flash-attention kernels (``kernels/csrc/flash_attention_sm90.cu`` in
bfloat16, ``kernels/csrc/flash_attention.cu`` in float32), and trains on
one card (``models.steps``, ``optim``, ``checkpoint``, ``data.packing``,
``launch.train``), the training forward keeping those kernels.
Backend names resolve through ``kernels.backends``; ``persist`` writes and
reads the reference's on-disk generations, and ``resilience`` holds the
fault-injection points and circuit breakers of the service's fallback
chain. Entry points default to the CUDA device and raise without one unless
``device="cpu"`` is passed.
"""
from .device import resolve_device

__all__ = ["resolve_device"]

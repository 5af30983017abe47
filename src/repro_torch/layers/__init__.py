"""The LM substrate's layers in PyTorch, the port of ``repro.layers`` for
the dense-attention architectures: RMSNorm, RoPE and M-RoPE, gated MLPs and
grouped-query attention (whose prefill runs the K5 kernel)."""

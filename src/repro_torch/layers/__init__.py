"""The LM substrate's layers in PyTorch, the port of ``repro.layers``:
RMSNorm, RoPE and M-RoPE, gated MLPs, grouped-query attention (whose
prefill runs the K5 kernel), Multi-head Latent Attention and the
capacity-dropping MoE."""

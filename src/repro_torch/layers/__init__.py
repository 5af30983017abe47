"""The LM substrate's layers in PyTorch, the port of ``repro.layers``:
RMSNorm, RoPE and M-RoPE, gated MLPs, grouped-query attention (whose
prefill runs the K5 kernel), Multi-head Latent Attention, the
capacity-dropping MoE, RWKV6's time and channel mix and the RG-LRU (both
over the log-depth ``scan.linear_scan``)."""

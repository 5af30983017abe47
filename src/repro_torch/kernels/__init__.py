"""Device side of the port: key representation (``keys``), device planes
(``planes``), the fused stacked lookup with its plain PyTorch version and
CUDA kernel (``stacked_lookup``, ``csrc/``), and the kernel build
(``_build``). Kernels are compiled and loaded at first launch, never at
import."""

from .sosd import DATASETS, generate

__all__ = ["DATASETS", "generate"]

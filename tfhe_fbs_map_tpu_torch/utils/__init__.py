from .profiling import torch_trace

__all__ = ["torch_trace"]

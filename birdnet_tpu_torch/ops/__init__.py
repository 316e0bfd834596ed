"""Device-side ops: the fused sigmoid top-K and the CUDA kernels (the audio
frontend, the fused int8 1x1 conv + requantize)."""

from .topk import fused_sigmoid_topk  # noqa: F401

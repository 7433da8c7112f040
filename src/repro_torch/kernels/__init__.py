"""Hand-written CUDA kernels for Hopper, each beside its plain version.

Importing this package builds nothing: a kernel is compiled on its first
launch (or by `build.build_all()`)."""
from .flash_attention import flash_attention, flash_attention_ref

__all__ = ["flash_attention", "flash_attention_ref"]

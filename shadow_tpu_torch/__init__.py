"""shadow_tpu_torch — the simulator's port to PyTorch and CUDA.

A second package beside ``shadow_tpu`` (JAX), held bit for bit against it:
the same committed event history (audit chains), counters, final pool and
host state. It imports ``torch`` and never ``jax`` or ``shadow_tpu``.

Simulated time is int64 nanoseconds. Entry points run on the CUDA card
unless the caller passes ``device="cpu"``; on the CPU every kernel runs
its plain PyTorch version. ``ROADMAP.md`` lists what is ported so far.
"""

from shadow_tpu_torch.core import simtime, units
from shadow_tpu_torch.core.config import Config, load_config

__version__ = "0.1.0"

__all__ = ["simtime", "units", "Config", "load_config", "__version__"]

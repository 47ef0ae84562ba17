"""Hand-written CUDA kernels for the device layer, each beside its plain
torch version.

Each kernel package has a ``ref.py`` (plain torch, any device) and an
``ops.py`` whose public function dispatches on ``impl``: ``"cuda"``
launches the kernel (CUDA tensors only, compute capability 9.0), ``"ref"``
runs the plain version, and ``"auto"`` follows the tensors' device.  There
is no fall back: a CUDA tensor on another card, or a kernel that fails to
build, raises.  :data:`LAUNCHES` counts the kernel launches.
"""
from .cuda_lib import LAUNCHES, reset_launch_counts

__all__ = ["LAUNCHES", "reset_launch_counts"]

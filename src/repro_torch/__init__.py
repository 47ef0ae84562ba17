"""repro_torch — D4M (Dynamic Distributed Dimensional Data Model) on
PyTorch and CUDA.

The PyTorch/CUDA port of the ``repro`` package: the same associative-array
algebra (host ``Assoc``, device ``AssocTensor``, lazy expressions and the
planner) with the device layer on torch tensors and its kernels written by
hand in CUDA C++ for Hopper (``csrc/``).  It imports neither JAX nor
``repro``; the tests hold it against ``repro`` on the same inputs.
"""

__version__ = "0.1.0"

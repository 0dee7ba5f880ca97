"""PyTorch/CUDA port of the BBC large-k ANN system (``src/repro``).

Module names mirror the JAX package's, so each counterpart is easy to find.
The port imports neither JAX nor the JAX package.  Importing it switches
TF32 off (``kernels.platform``).  Entry points run on CUDA unless the caller
passes ``device="cpu"``.
"""
from repro_torch.kernels import platform as _platform  # noqa: F401  (fp32 policy)

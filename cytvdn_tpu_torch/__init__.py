"""cytvdn_tpu_torch — total-variation denoising for 3D/4D microscopy data on
PyTorch and NVIDIA Hopper GPUs.

The port of ``cytvdn_tpu`` (JAX/Pallas on TPU) to PyTorch with hand-written
CUDA kernels. It imports neither ``jax`` nor ``cytvdn_tpu``. Public API, the
same as ``cytvdn_tpu``'s plus a ``device`` keyword:

- :func:`denoise3D`  — 3D anisotropic TV denoising
- :func:`denoise4D`  — 4D anisotropic / half-isotropic TV denoising
- :func:`check_memory` — memory-requirement advisor (GPU + host RAM)
- :func:`denoise_sharded` / :func:`run_sharded` — runs on a mesh of
  processes split along the scan axes (:class:`MeshComm`, halos over
  ``torch.distributed``; :func:`init_distributed` joins the group)
- :class:`BCMode` — boundary-condition enum (periodic / mirror / Jia-Zhao)
"""

from cytvdn_tpu_torch.config import BCMode, SolverOptions
from cytvdn_tpu_torch.api import denoise3D, denoise4D, denoise
from cytvdn_tpu_torch.utils.memory import check_memory
from cytvdn_tpu_torch.parallel import (
    MeshComm,
    denoise_sharded,
    init_distributed,
    run_sharded,
)

__version__ = "0.1.0"

__all__ = [
    "BCMode",
    "SolverOptions",
    "denoise3D",
    "denoise4D",
    "denoise",
    "check_memory",
    "denoise_sharded",
    "run_sharded",
    "MeshComm",
    "init_distributed",
]

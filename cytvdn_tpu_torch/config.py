"""Configuration types for the TV-denoising solver (PyTorch port).

Counterpart of ``cytvdn_tpu/config.py``: ``BCMode`` keeps the reference's
integer convention, ``SolverOptions`` the same keyword surface and the same
``__post_init__`` rejections.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple


class BCMode(enum.IntEnum):
    """Boundary conditions for the difference operators.

    Values match the reference's integer convention
    (reference cyTVDN/anisotropic.pyx:20-23):

    - ``PERIODIC`` (0): index wraparound on both difference operators.
    - ``MIRROR`` (1): the backward difference at index 0 reads ``a_1``; the
      forward difference at the last index is zero (the *corrected* mirror;
      the reference's mirror branch is defective, utils.pyx:117-120).
    - ``JIA_ZHAO`` (2, default): the difference at the domain edge is zero
      (Jia & Zhao, Adv Comp Math 2010 33:231-241). The accumulator slab at
      index 0 along its axis stays identically zero (SURVEY.md §8.1).
    """

    PERIODIC = 0
    MIRROR = 1
    JIA_ZHAO = 2


class Backend(enum.Enum):
    """Compute backend for the iteration body.

    - ``AUTO``: the CUDA kernel for a CUDA tensor, the plain spec for a CPU
      tensor.
    - ``TORCH``: the plain PyTorch spec (``ops/stencil.py``) on any device.
    - ``CUDA``: the hand-written CUDA kernel; a CPU tensor raises.
    - ``CPP``: the native C++/OpenMP host kernels (``cpp/``, through
      ctypes) on host arrays; the API runs it before any copy to a device,
      and never picks it by itself.
    """

    AUTO = "auto"
    TORCH = "torch"
    CUDA = "cuda"
    CPP = "cpp"


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Static solver configuration.

    Mirrors the reference's ``denoise3D``/``denoise4D`` keyword surface
    (reference cyTVDN/cyTVDN.py:19-31, 250-260).
    """

    ndim: int
    iterations_fista: int
    iterations_unacc: int
    bc_mode: BCMode = BCMode.JIA_ZHAO
    stopping_relative_change: Optional[float] = None
    isotropic_R: bool = False  # pair axes (0,1), 4D only
    isotropic_Q: bool = False  # pair axes (2,3), 4D only
    calculate_mse: bool = False
    backend: Backend = Backend.AUTO
    # Adaptive FISTA restart (opt-in, beyond the reference): reset the
    # momentum whenever the relative change increases.
    fista_restart: bool = False
    # Temporal blocking (two or K iterations per memory pass) and the
    # whole-run resident kernel are throughput choices, bit-identical to
    # one iteration per pass. All three are on by default, as in
    # cytvdn_tpu; ``temporal_k`` pins the K-step depth (None: the H100
    # rule of kernels/kstep.py::best_kstep); the resident kernel serves
    # the states kernels/resident.py::resident_supported admits.
    temporal_pairs: bool = True
    temporal_kstep: bool = True
    temporal_k: Optional[int] = None
    vmem_resident: bool = True
    # LOSSY opt-in: store the FISTA shadow duals (``d``) as bfloat16, compute
    # in float32; ``d`` is rounded to nearest even at every iteration's
    # store and widened exactly at every load. Not bitwise an exact run
    # (the JAX package measured ~6.8e-4 rel-L2 of drift, which is why it is
    # never a default); chunked, resumed, mesh and out-of-core lossy runs
    # are bitwise the single-device lossy run. Float32 Jia-Zhao anisotropic
    # FISTA runs, as in cytvdn_tpu (``config.py:143-149``).
    lossy_duals: bool = False

    def __post_init__(self):
        if not isinstance(self.backend, Backend):
            object.__setattr__(self, "backend", Backend(self.backend))
        if not isinstance(self.bc_mode, BCMode):
            object.__setattr__(self, "bc_mode", BCMode(self.bc_mode))
        if self.ndim not in (3, 4):
            raise ValueError(f"ndim must be 3 or 4, got {self.ndim}")
        if self.ndim == 3 and (self.isotropic_R or self.isotropic_Q):
            raise ValueError("half-isotropic mode is 4D-only (as in reference)")
        if self.lossy_duals:
            if self.isotropic_R or self.isotropic_Q:
                raise ValueError(
                    "lossy_duals does not cover half-isotropic runs")
            if self.bc_mode != BCMode.JIA_ZHAO:
                raise ValueError(
                    "lossy_duals covers Jia-Zhao anisotropic runs only")

    @property
    def fista(self) -> bool:
        return self.iterations_fista > 0

    @property
    def total_iterations(self) -> int:
        return self.iterations_fista + self.iterations_unacc


def normalize_iterations(iterations, fista: bool) -> Tuple[int, int]:
    """Resolve the reference's ``iterations`` convention.

    An int runs ``iterations`` of whichever phase ``FISTA`` selects; a
    2-sequence ``(n_fista, n_unacc)`` runs a hybrid schedule, overriding the
    FISTA flag (reference cyTVDN/cyTVDN.py:100-108).
    """
    if isinstance(iterations, (list, tuple)):
        if len(iterations) != 2:
            raise ValueError(
                "iterations must be an int or a 2-sequence (n_fista, n_unacc)"
            )
        return int(iterations[0]), int(iterations[1])
    n = int(iterations)
    return (n, 0) if fista else (0, n)

"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version. Sources live in ``cytvdn_tpu_torch/csrc``; ``build.py`` compiles
them on first use. Nothing here builds or imports CUDA code at import
time."""

from cytvdn_tpu_torch.kernels.fused import (
    fused_iteration,
    fused_iteration_reference,
    fused_supported,
)
from cytvdn_tpu_torch.kernels.kstep import (
    KSTEP_CANDIDATES,
    best_kstep,
    fused_kstep_iteration,
    fused_kstep_iteration_reference,
    kstep_supported,
)
from cytvdn_tpu_torch.kernels.resident import (
    RESIDENT_BYTES,
    resident_solve,
    resident_solve_reference,
    resident_supported,
)
from cytvdn_tpu_torch.kernels.temporal import (
    fused_pair_iteration,
    fused_pair_iteration_reference,
    pair_supported,
)

__all__ = [
    "fused_iteration",
    "fused_iteration_reference",
    "fused_supported",
    "fused_pair_iteration",
    "fused_pair_iteration_reference",
    "pair_supported",
    "KSTEP_CANDIDATES",
    "best_kstep",
    "fused_kstep_iteration",
    "fused_kstep_iteration_reference",
    "kstep_supported",
    "RESIDENT_BYTES",
    "resident_solve",
    "resident_solve_reference",
    "resident_supported",
]

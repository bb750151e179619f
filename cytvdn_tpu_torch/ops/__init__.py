from cytvdn_tpu_torch.ops.stencil import (
    accumulator_update,
    accumulator_update_fista,
    iso_accumulator_update,
    iso_accumulator_update_fista,
    datacube_update,
    sum_square_error,
    shift_backward,
    shift_forward,
    tv_energy,
)

__all__ = [
    "accumulator_update",
    "accumulator_update_fista",
    "iso_accumulator_update",
    "iso_accumulator_update_fista",
    "datacube_update",
    "sum_square_error",
    "shift_backward",
    "shift_forward",
    "tv_energy",
]

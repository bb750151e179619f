"""The native C++/OpenMP CPU backend (``backend="cpp"``): the shared
``csrc/tvdn_cpu.cpp`` built at first use, and the host solver loop."""

from cytvdn_tpu_torch.cpp.backend import (
    native_available,
    native_num_threads,
    solve_cpp,
)

__all__ = ["native_available", "native_num_threads", "solve_cpp"]

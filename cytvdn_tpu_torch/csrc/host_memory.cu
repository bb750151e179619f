// Page-locked host memory for out-of-core runs (solver/outofcore.py).
//
// The state of an out-of-core run lives in host memory and is copied to
// and from the card slab by slab; a copy is asynchronous only from
// page-locked memory. PyTorch's pinned allocator (pin_memory=True) rounds
// each allocation up to a power of two and keeps freed blocks locked in
// its cache, which at a 10 GiB cube would lock 16 GiB per array and keep
// it after the run; registering ordinary pages (cudaHostRegister) locked
// the 40 GiB of a 256^2 x 128^2 FISTA state in 33 s on an H100's host,
// against 10.5-13 s for allocating and filling it here. So the runs
// allocate each array here, exactly sized, and free it when the last
// numpy view of it goes.

#include <cuda_runtime.h>
#include <stddef.h>

extern "C" int tv_host_alloc(size_t bytes, void** ptr) {
  return static_cast<int>(cudaHostAlloc(ptr, bytes, cudaHostAllocDefault));
}

extern "C" int tv_host_free(void* ptr) {
  return static_cast<int>(cudaFreeHost(ptr));
}

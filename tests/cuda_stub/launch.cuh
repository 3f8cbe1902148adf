// Host stand-in for csrc/launch.cuh (same include guard, so the real header
// is skipped when this one is force-included first): runs the kernel through
// cuda_runtime.h's thread-per-CUDA-thread emulation.
#ifndef ERGODIC_LAUNCH_CUH
#define ERGODIC_LAUNCH_CUH

#include <cuda_runtime.h>

// An H100's opt-in limit of dynamic shared memory a block (bytes).
inline int max_dynamic_smem() { return 232448; }

template <class P, class B>
inline cudaError_t launch_kernel(void (*kernel)(P, B), dim3 grid, dim3 block, size_t smem,
                                 cudaStream_t, P& p, B& b) {
    host_stub::run(grid, block, smem, [&] { kernel(p, b); });
    return cudaSuccess;
}

#endif  // ERGODIC_LAUNCH_CUH

// Launch helper shared by the three kernel libraries: every kernel of this
// package takes its parameter block and its buffer block by value.
#ifndef ERGODIC_LAUNCH_CUH
#define ERGODIC_LAUNCH_CUH

#include <cuda_runtime.h>

// Dynamic shared memory a block may opt in to on the current device, in bytes
// (cudaDevAttrMaxSharedMemoryPerBlockOptin: 232448 on an H100), queried once
// per device; 0 where the query fails.
inline int max_dynamic_smem() {
    static int cache[64] = {0};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
    if (cache[dev] == 0) {
        int v = 0;
        if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
            cudaSuccess)
            return 0;
        cache[dev] = v;
    }
    return cache[dev];
}

// Launch `kernel(p, b)` on `st` with `smem` bytes of dynamic shared memory
// (raising the kernel's limit where that is over the default 48 KB). Returns
// the launch's error code; does not synchronize.
template <class P, class B>
inline cudaError_t launch_kernel(void (*kernel)(P, B), dim3 grid, dim3 block, size_t smem,
                                 cudaStream_t st, P& p, B& b) {
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute((const void*)kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return e;
    }
    void* args[] = {&p, &b};
    return cudaLaunchKernel((const void*)kernel, grid, block, args, smem, st);
}

#endif  // ERGODIC_LAUNCH_CUH

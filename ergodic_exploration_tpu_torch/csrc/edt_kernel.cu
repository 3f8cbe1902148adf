// E — the Euclidean distance transform of the world rebuild and its
// gradient, for NVIDIA Hopper.
//
// Replaces no Pallas kernel: the XLA program that the JAX package compiles
// for ergodic_exploration_tpu/ops/distance.py::edt (:33-54, two dense
// min-plus reductions against an (n, n) squared-offset matrix) and the
// central-difference gradient of DistanceField.from_grid (:78-95). Built by
// nvcc for sm_90a (utils/cuda_build.py) and called through the plain C entry
// point at the end of this file from ops/edt_kernel.py, whose plain version
// (ops/distance.py: edt, then central_gradient) gives the same bits.
//
// What it computes, for every map (data (h, w), resolution res):
//   occ      = data >= thr
//   g[i, j]  = min over occupied i' of column j of (i - i')^2, else big
//   d2[i, j] = min_k g[i, k] + (j - k)^2
//   dist     = d2 >= big ? FAR : sqrtf(d2) * res          (big = 4 max(h, w)^2)
//   grad     = the central differences of dist along x and y, one-sided at
//              the borders, divided by 2 res (by res at the borders), zero
//              where dist >= FAR
// Every squared distance is an integer under 2^24 for maps under 1832 cells
// a side, so any exact algorithm gives the plain version's d2: the kernel's
// values equal the plain version's bit for bit.
//
// What bounds it on an H100: bytes. The data is read once and dist and grad
// written once: 16 bytes a cell, 655 MB at S = 4096, 100 x 100, 0.196 ms at
// 3.35 TB/s. The plain version materialises (maps, n, n, n) floats for each
// pass. The operations depend on the data: the row pass below examines, for
// each cell, the offsets whose square is under its distance (a cell near a
// wall stops after a few; an empty map's cells scan the row).
//
// What the design does about it: one block per map (256 threads). The block
// reads the map once, all threads on consecutive cells, into a plane of
// 0 (occupied) or big. Columns: a thread per column sweeps the plane down
// and up in place (threads on consecutive banks). Rows: a warp per row; a lane's cell
// starts from g at its own column and widens its search one offset at a
// time while the offset's square is under its best sum. The row pass writes
// dist to device memory; after the block's barrier the gradient reads it
// back (the block's own writes, hot in L1). The plane is the block's shared
// memory where the map fits (100 x 100: 40 KB, 200 x 200: 160 KB), else it
// is the map's own grad output, which the gradient overwrites only after
// the plane's last read (the global-memory form, same passes and barriers).
//
// Rounding contract (-fmad=false): the finishing steps are the plain
// version's operations one by one: sqrtf then the product with res, and the
// gradient's subtraction then an IEEE division by (2 res) or res.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"

namespace edtk {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

struct EdtParams {
    int S, h, w;
    int plane_global;  // the plane in the map's grad output instead of shared memory
    float thr;         // occupied_threshold
    float big;         // 4 max(h, w)^2
    float far;         // FAR
};

struct EdtBuffers {
    const float* data;  // (S, h, w)
    const float* res;   // (S,)
    float* dist;        // (S, h, w)
    float* grad;        // (S, h, w, 2)
};

}  // namespace edtk

using namespace edtk;

template <bool PLANE_GLOBAL>
__global__ void __launch_bounds__(THREADS) edt_kernel(EdtParams p, EdtBuffers b) {
    extern __shared__ float smem_plane[];
    const int s = blockIdx.x;
    const int h = p.h, w = p.w;
    const long long hw = (long long)h * w;
    const float* data = b.data + s * hw;
    float* dist = b.dist + s * hw;
    float* grad = b.grad + 2 * s * hw;
    float* plane = PLANE_GLOBAL ? grad : smem_plane;
    const float res = b.res[s];

    // the map into the plane, all threads on consecutive cells: 0 where
    // occupied, else big
    for (long long c = threadIdx.x; c < hw; c += THREADS)
        plane[c] = data[c] >= p.thr ? 0.0f : p.big;
    __syncthreads();

    // columns: the squared distance to the nearest occupied cell of the
    // column, from above (first sweep) and below (second sweep); a cell is
    // occupied exactly where its plane value is 0 in both sweeps
    for (int j = threadIdx.x; j < w; j += THREADS) {
        int last = -1;
        for (int i = 0; i < h; ++i) {
            float& g = plane[(long long)i * w + j];
            if (g == 0.0f) last = i;
            g = last >= 0 ? (float)((i - last) * (i - last)) : p.big;
        }
        int next = -1;
        for (int i = h - 1; i >= 0; --i) {
            float& g = plane[(long long)i * w + j];
            if (g == 0.0f) next = i;
            if (next >= 0) g = fminf(g, (float)((next - i) * (next - i)));
        }
    }
    __syncthreads();

    // rows: d2 = min_k g[k] + (j - k)^2. g >= 0, so no offset whose square
    // reaches the best sum so far can lower it.
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int i = warp; i < h; i += WARPS) {
        const float* row = plane + (long long)i * w;
        for (int j = lane; j < w; j += 32) {
            float best = row[j];
            const int reach = max(j, w - 1 - j);
            for (int off = 1; off <= reach; ++off) {
                const float o2 = (float)(off * off);
                if (!(o2 < best)) break;
                if (j - off >= 0) best = fminf(best, row[j - off] + o2);
                if (j + off < w) best = fminf(best, row[j + off] + o2);
            }
            dist[(long long)i * w + j] = best >= p.big ? p.far : sqrtf(best) * res;
        }
    }
    __syncthreads();

    // the gradient: central differences, one-sided at the borders, zero on
    // the FAR plateau
    const float two_r = 2.0f * res;
    for (long long c = threadIdx.x; c < hw; c += THREADS) {
        const int i = (int)(c / w), j = (int)(c - (long long)i * w);
        // the neighbours before and after, the cell itself at a border
        const float* d = dist + (long long)i * w;
        const int left = j == 0 ? j : j - 1, right = j == w - 1 ? j : j + 1;
        const float* up = i == 0 ? d : d - w;
        const float* down = i == h - 1 ? d : d + w;
        const float gx = (d[right] - d[left]) / (right - left == 2 ? two_r : res);
        const float gy = (down[j] - up[j]) / (i == 0 || i == h - 1 ? res : two_r);
        const bool far = d[j] >= p.far;
        grad[2 * c] = far ? 0.0f : gx;
        grad[2 * c + 1] = far ? 0.0f : gy;
    }
}

// Launch the EDT and gradient of p->S maps on `stream`; returns the CUDA
// error code (0 on success). Does not synchronize.
extern "C" int edt_field(const EdtParams* params, const EdtBuffers* buffers, void* stream) {
    EdtParams p = *params;
    EdtBuffers b = *buffers;
    if (p.S <= 0) return 0;
    if (p.h < 2 || p.w < 2) return (int)cudaErrorInvalidValue;
    const size_t smem = p.plane_global ? 0 : (size_t)p.h * p.w * sizeof(float);
    if (smem > (size_t)max_dynamic_smem()) return (int)cudaErrorInvalidValue;
    cudaError_t e = p.plane_global
                        ? launch_kernel(edt_kernel<true>, dim3(p.S), dim3(THREADS), 0,
                                        (cudaStream_t)stream, p, b)
                        : launch_kernel(edt_kernel<false>, dim3(p.S), dim3(THREADS), smem,
                                        (cudaStream_t)stream, p, b);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

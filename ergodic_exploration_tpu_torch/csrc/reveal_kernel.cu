// R — the occlusion-aware ray-cast reveal of the mapping loop, for NVIDIA
// Hopper.
//
// Replaces no Pallas kernel: the XLA program that the JAX package compiles
// for ergodic_exploration_tpu/ops/sensor.py::reveal_raycast (:50-142), which
// builds the window from one-hot row and column products, decides blocker
// membership as a dense (cells x angle bins) matrix, and blends back through
// transposed one-hot selectors. Built by nvcc for sm_90a
// (utils/cuda_build.py) and called through the plain C entry point at the
// end of this file from ops/reveal_kernel.py, whose plain version
// (ops/sensor.py::reveal_raycast_plain) gives the same cells.
//
// What it computes, for every scenario s (belief, truth (h, w), pose, the
// map's origin and resolution):
//   the P x P window around the pose, edge-clamped rows and columns;
//   for each window cell its radius r and angle about the sensor, its angle
//   bin floor((ang + pi) / 2pi * n_bins) and its radius step round(r / res);
//   an OCCUPIED cell (truth >= thr) blocks every bin b whose centre c_b
//   passes |remainder(ang - c_b + pi, 2pi) - pi| <= atan(0.55 / max(r/res,
//   0.5)); first[b] = the least radius step of a blocker of bin b (n_r when
//   none);
//   a window cell is seen when its step <= first[its bin] and r <= range;
//   the output is the belief with the seen cells set to the truth.
//
// What bounds it on an H100: bytes. The belief is read and the output
// written once (2 x 4 h w bytes a scenario), the truth only in the window
// (4 P^2): 392.7 MB at S = 4096, 100 x 100, P = 63, 0.117 ms at 3.35 TB/s.
// The plain version materialises every (cell x bin) pair, 3969 x 256 a
// scenario, several times over in device memory.
//
// What the design does about it: one block per scenario. The block copies
// the belief row-major into the output, keeps first[n_bins] in shared
// memory (1 KB at 256 bins; in a global workspace of the wrapper's where
// the table would not fit a block), and visits the window twice: each
// occupied cell tests only the bins near its own, a margin wide enough to
// hold every bin the test can pass (about 70 of 256 at r = 0.5 cell), and
// lowers first[] there with a shared atomicMin; after the barrier every
// window cell recomputes its bin and step and writes the truth where it is
// seen. Edge-clamped duplicate window cells compute the same values, so
// their writes agree. No (cell x bin) pair reaches device memory.
//
// Rounding contract (-fmad=false): every multiply, add and division rounds
// on its own as PyTorch's elementwise kernels round them, in the plain
// version's order; atan2f, atanf, sqrtf, fmodf, floorf and rintf are the
// functions PyTorch's CUDA kernels call for torch.atan2, atan, sqrt,
// remainder, floor and round; 0.55 / x is PyTorch's reciprocal times 0.55
// (Tensor.__rtruediv__), the divisions by the resolution and by 2 pi are
// true divisions by device tensors; the bin centres come from the wrapper,
// computed by the plain version's own torch expression on the same device.
// So the card's output equals the plain version's on the card cell for cell.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"

namespace reveal {

constexpr int THREADS = 256;
constexpr float PI_F = 3.14159265358979323846f;  // (float) pi, as torch casts math.pi
constexpr float TWO_PI_F = 6.28318530717958647692f;  // (float) 2 pi = 2 (float) pi

struct RevealParams {
    int S, h, w;
    int P;            // window side: min(window_cells, h, w)
    int n_bins;
    int n_r;          // radius steps: P / 2 + 2
    int pose_stride;  // floats between two scenarios' poses (>= 2)
    int table_global; // first[] in b.first (S x n_bins ints) instead of shared memory
    float sensor_range;
    float thr;  // occupied_threshold
};

struct RevealBuffers {
    const float* belief;   // (S, h, w)
    const float* truth;    // (S, h, w)
    const float* origin;   // (S, 2)
    const float* res;      // (S,)
    const float* pose;     // (S, pose_stride): x, y first
    const float* centers;  // (n_bins,) bin centres
    int* first;            // (S, n_bins) workspace when table_global, else unused
    float* out;            // (S, h, w)
};

// The window geometry of one scenario: the first row and column of the
// window (before clamping), the origin, resolution and pose.
struct Geometry {
    long long sx, sy;
    float ox, oy, res, px, py;
};

// One window cell: its map index, radius, angle bin, radius step, and the
// radius over the resolution (for the blocker's half-width).
struct Cell {
    long long idx;
    float r, rc, ang;
    int bin, q;
};

__device__ __forceinline__ Geometry geometry(const RevealParams& p, const RevealBuffers& b,
                                             int s) {
    Geometry g;
    g.ox = b.origin[2 * s];
    g.oy = b.origin[2 * s + 1];
    g.res = b.res[s];
    g.px = b.pose[(long long)s * p.pose_stride];
    g.py = b.pose[(long long)s * p.pose_stride + 1];
    // cf = (pose - origin) / res - 0.5; start = round(cf) - P // 2
    const float cfx = (g.px - g.ox) / g.res - 0.5f;
    const float cfy = (g.py - g.oy) / g.res - 0.5f;
    g.sx = (long long)rintf(cfx) - p.P / 2;
    g.sy = (long long)rintf(cfy) - p.P / 2;
    return g;
}

__device__ __forceinline__ Cell cell_at(const RevealParams& p, const Geometry& g, int t) {
    const int iy = t / p.P, ix = t - iy * p.P;
    const long long row = min(max(g.sy + iy, 0LL), (long long)p.h - 1);
    const long long col = min(max(g.sx + ix, 0LL), (long long)p.w - 1);
    Cell c;
    c.idx = row * p.w + col;
    const float gx = g.ox + ((float)col + 0.5f) * g.res;
    const float gy = g.oy + ((float)row + 0.5f) * g.res;
    const float dx = gx - g.px, dy = gy - g.py;
    c.r = sqrtf(dx * dx + dy * dy);
    c.ang = atan2f(dy, dx);
    const float bf = floorf(((c.ang + PI_F) / TWO_PI_F) * (float)p.n_bins);
    c.bin = (int)fminf(fmaxf(bf, 0.0f), (float)(p.n_bins - 1));
    c.rc = c.r / g.res;
    c.q = (int)fminf(fmaxf(rintf(c.rc), 0.0f), (float)(p.n_r - 1));
    return c;
}

// torch.remainder on floats: fmod, then the divisor added where the signs differ
__device__ __forceinline__ float torch_remainder(float a, float m) {
    float r = fmodf(a, m);
    if (r != 0.0f && ((m < 0.0f) != (r < 0.0f))) r += m;
    return r;
}

}  // namespace reveal

using namespace reveal;

template <bool TABLE_GLOBAL>
__global__ void __launch_bounds__(THREADS) reveal_kernel(RevealParams p, RevealBuffers b) {
    extern __shared__ int smem_first[];
    const int s = blockIdx.x;
    const long long hw = (long long)p.h * p.w;
    const float* belief = b.belief + s * hw;
    const float* truth = b.truth + s * hw;
    float* out = b.out + s * hw;
    int* first = TABLE_GLOBAL ? b.first + (long long)s * p.n_bins : smem_first;

    for (long long i = threadIdx.x; i < hw; i += THREADS) out[i] = belief[i];
    for (int k = threadIdx.x; k < p.n_bins; k += THREADS) first[k] = p.n_r;
    __syncthreads();

    const Geometry g = geometry(p, b, s);
    const int cells = p.P * p.P;
    // blockers: each occupied window cell lowers first[] over the bins near
    // its own bin that pass the interval test. A bin the test passes lies
    // within half_w / (2 pi / n_bins) + 1/2 bins of the cell's: the margin m
    // holds it with room for rounding.
    for (int t = threadIdx.x; t < cells; t += THREADS) {
        const Cell c = cell_at(p, g, t);
        if (!(truth[c.idx] >= p.thr)) continue;
        const float half_w = atanf((1.0f / fmaxf(c.rc, 0.5f)) * 0.55f);
        const int m = (int)(half_w * (float)p.n_bins * 0.15915494f) + 3;
        const bool all = 2 * m + 1 >= p.n_bins;
        const int lo = all ? 0 : c.bin - m, hi = all ? p.n_bins - 1 : c.bin + m;
        for (int k = lo; k <= hi; ++k) {
            const int bb = k < 0 ? k + p.n_bins : k >= p.n_bins ? k - p.n_bins : k;
            const float dang =
                fabsf(torch_remainder((c.ang - b.centers[bb]) + PI_F, TWO_PI_F) - PI_F);
            if (dang <= half_w) atomicMin(&first[bb], c.q);
        }
    }
    __syncthreads();

    // visibility: strictly behind the first blocker of its bin, or out of
    // range, a cell stays as the belief has it
    for (int t = threadIdx.x; t < cells; t += THREADS) {
        const Cell c = cell_at(p, g, t);
        if (c.q <= first[c.bin] && c.r <= p.sensor_range) out[c.idx] = truth[c.idx];
    }
}

// Launch the reveal for p->S scenarios on `stream`; returns the CUDA error
// code (0 on success). Does not synchronize.
extern "C" int reveal_raycast(const RevealParams* params, const RevealBuffers* buffers,
                              void* stream) {
    RevealParams p = *params;
    RevealBuffers b = *buffers;
    if (p.S <= 0) return 0;
    if (p.h < 1 || p.w < 1 || p.P < 1 || p.P > p.h || p.P > p.w || p.n_bins < 1 ||
        p.n_r != p.P / 2 + 2 || p.pose_stride < 2 || (p.table_global && b.first == nullptr))
        return (int)cudaErrorInvalidValue;
    const size_t smem = p.table_global ? 0 : (size_t)p.n_bins * sizeof(int);
    if (smem > (size_t)max_dynamic_smem()) return (int)cudaErrorInvalidValue;
    cudaError_t e = p.table_global
                        ? launch_kernel(reveal_kernel<true>, dim3(p.S), dim3(THREADS), 0,
                                        (cudaStream_t)stream, p, b)
                        : launch_kernel(reveal_kernel<false>, dim3(p.S), dim3(THREADS), smem,
                                        (cudaStream_t)stream, p, b);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

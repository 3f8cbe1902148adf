// K2 — batched GMM target coefficients phi_k for NVIDIA Hopper.
//
// Replaces the TPU kernel ergodic_exploration_tpu/ops/pallas_kernels.py::
// phik_from_gmm_pallas (Pallas bodies _phik_gmm_kernel and
// _phik_gmm_masked_kernel via _phik_gmm_body): for every scenario, evaluate
// its Gaussian mixture on the shared sample lattice, multiply by an optional
// per-scenario (S, N) free mask, contract with the dense basis table
// D (N, K^2), divide by the mixture's mass, and fall back to a uniform target
// where the mass underflows (uniform over the mask when masked, over the
// lattice otherwise). Built by nvcc for sm_90a (utils/cuda_build.py) and
// called through the plain C entry point at the end of this file from
// ops/gmm_kernel.py.
//
// What bounds it on an H100: arithmetic. S * Npad * K^2 multiply-adds in
// float32 outside the tensor cores (4.1 G at S=4096, Npad=10,048, K=10; exact
// float32 is part of the parity budget, so TF32 is no option) plus
// S * Npad * J expf; the bytes (D once, the mask once: 164 MB at that size)
// take less time than the operations.
//
// What the design does about it:
//   k2_partial  grid (scenario tiles of 64) x (lattice splits) x (slabs of
//               256 coefficients). A block runs gmm_refresh.cuh's part over
//               its share of the lattice and its slab of the table (that
//               header describes the tile: 8 x 4 register tiles fed by
//               128-bit shared loads, the table staged by cp.async into two
//               buffers, two blocks an SM). The TPU kernel carries its sums
//               across a sequential grid axis; here blocks run in no order,
//               so every split writes its partial (acc, tot) to scratch. The
//               split count is chosen by the wrapper
//               (ops/solve_kernel.py::lattice_split, shared with K1's
//               refresh) so that small batches still fill the card (S=1 would
//               otherwise be one block walking all 157 chunks of a 100 x 100 lattice).
//   k2_finish   one block per scenario adds the partial sums in split order
//               (no atomics: two runs give the same bits), normalizes, and
//               computes the fallback ONLY for a scenario whose mass is
//               <= 1e-12 (a block-uniform branch). The TPU kernel's masked
//               body runs the mask's own contraction for every scenario just
//               to have the fallback ready.
//
// Built with K1's flags (utils/cuda_build.py, -fmad=false): K2's own parity
// budget (2e-5) does not need them, but gmm_refresh.cuh is shared with K1,
// whose rounding contract does, and one set of flags keeps the shared code
// one build configuration.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gmm_refresh.cuh"
#include "launch.cuh"

using namespace k1;

constexpr int FIN_THREADS = 128;

// Mirror of ops/gmm_kernel.py::_Params (same field order).
struct K2Params {
    int S, J, KK, Npad, n_real, nsplit, chunks_per_split, masked;
};

// Mirror of ops/gmm_kernel.py::_Buffers (device pointers, same order).
struct K2Buffers {
    const float *means, *covs, *weights, *pts, *D, *mask;
    float *part_acc, *part_tot, *out;
};

template <int TILES, bool CUT>
__global__ void __launch_bounds__(RT_THREADS, TILES == 1 ? RT_MIN_BLOCKS : 1)
k2_partial(K2Params p, K2Buffers b) {
    extern __shared__ __align__(16) float sm[];
    const int sp = blockIdx.y;
    const int n_begin = sp * p.chunks_per_split * RT_N;
    const int n_end = min(p.Npad, n_begin + p.chunks_per_split * RT_N);
    gmm_refresh_part<TILES, CUT>(blockIdx.x * RT_S, p.S, p.J, p.KK, blockIdx.z, n_begin, n_end,
                                 b.means, b.covs, b.weights, b.pts, b.D,
                                 p.masked ? b.mask : nullptr, p.n_real, sm,
                                 b.part_acc + (size_t)sp * p.S * p.KK,
                                 b.part_tot + (size_t)sp * p.S);
}

__global__ void __launch_bounds__(FIN_THREADS) k2_finish(K2Params p, K2Buffers b) {
    const int s = blockIdx.x;
    const int KK = p.KK;
    float tot = 0.0f;
    for (int sp = 0; sp < p.nsplit; ++sp) tot += b.part_tot[(size_t)sp * p.S + s];
    for (int k = threadIdx.x; k < KK; k += FIN_THREADS) {
        float out;
        if (tot > 1e-12f) {
            float acc = 0.0f;
            for (int sp = 0; sp < p.nsplit; ++sp)
                acc += b.part_acc[((size_t)sp * p.S + s) * KK + k];
            out = acc / fmaxf(tot, 1e-12f);
        } else {
            // no mass: uniform over the mask (accm / max(totm, 1)) or over
            // the lattice (colsum(D) / N); sums blocked by chunk
            const float* mrow = p.masked ? b.mask + (size_t)s * p.n_real : nullptr;
            float accm = 0.0f, totm = 0.0f;
            for (int n0 = 0; n0 < p.n_real; n0 += RT_N) {
                float pa = 0.0f, pt = 0.0f;
                const int n1 = min(p.n_real, n0 + RT_N);
                for (int n = n0; n < n1; ++n) {
                    const float m = mrow ? mrow[n] : 1.0f;
                    pa += m * b.D[(size_t)n * KK + k];
                    pt += m;
                }
                accm += pa;
                totm += pt;
            }
            out = p.masked ? accm / fmaxf(totm, 1.0f) : accm / (float)p.n_real;
        }
        b.out[(size_t)s * KK + k] = out;
    }
}

// Launch K2 for p->S scenarios on `stream`; returns the CUDA error code
// (0 on success). Does not synchronize.
extern "C" int k2_phik_from_gmm(const K2Params* params, const K2Buffers* buffers,
                                void* stream) {
    K2Params p = *params;
    K2Buffers b = *buffers;
    cudaStream_t st = (cudaStream_t)stream;
    if (p.S <= 0) return 0;
    const size_t smem = refresh_smem_floats(p.KK, p.J) * sizeof(float);
    if (p.KK < 1 || p.J < 1 || p.Npad % RT_N || p.nsplit < 1 || p.nsplit > 65535 ||
        p.nsplit * p.chunks_per_split * RT_N < p.Npad || refresh_slabs(p.KK) > 65535 ||
        smem > (size_t)max_dynamic_smem())
        return (int)cudaErrorInvalidValue;
    const dim3 grid((p.S + RT_S - 1) / RT_S, p.nsplit, refresh_slabs(p.KK));
    const bool cut = refresh_cut(p.KK, p.J);
    cudaError_t e = launch_kernel(
        refresh_tiles(p.KK) == 1 ? (cut ? k2_partial<1, true> : k2_partial<1, false>)
                                 : (cut ? k2_partial<2, true> : k2_partial<2, false>),
        grid, dim3(RT_THREADS), smem, st, p, b);
    if (e != cudaSuccess) return (int)e;
    e = launch_kernel(k2_finish, dim3(p.S), dim3(FIN_THREADS), 0, st, p, b);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

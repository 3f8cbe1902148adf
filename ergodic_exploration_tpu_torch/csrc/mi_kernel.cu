// K3 — mutual-information target coefficients phi_k straight from the belief
// maps, for NVIDIA Hopper.
//
// Replaces the TPU kernel ergodic_exploration_tpu/ops/mi_kernel.py::
// phik_from_grid_pallas (Pallas body _make_kernel) together with the
// normalization that follows its pallas_call: for every scenario, from its
// (h, w) belief map b (-1 unknown, else occupancy probability),
//
//   p     = clip(b < 0 ? 0.5 : b, eps, 1 - eps)
//   e     = -(p log p + (1 - p) log1p(-p))                 Bernoulli entropy
//   t2    = sum over the edge-clamped (2r+1)^2 box of e     (unscaled)
//   cnt   = number of known-free cells (0 <= b < thr) in the edge-clamped
//           (2fc+1)^2 box                                   (fc > 0 only)
//   vals  = max((b < thr) && (fc == 0 || cnt > 0) ? t2 : 0, 0)
//   raw   = cxA^T vals^T cyA^T   i.e. raw[k1][k2] = sum_ij vals[i][j] cxA[j][k1] cyA[k2][i]
//   total = raw[0][0] * hk[0][0]
//   out   = total > 1e-12 ? raw / max(total, 1e-12) : fallback
//
// cxA (w, K) and cyA (K, h) are the cosine tables with the nearest-cell
// lattice sampling folded in (ops/mi_kernel.py::mi_operands); fallback (K, K)
// is the uniform target over the lattice. Built by nvcc for sm_90a
// (utils/cuda_build.py) and called through the plain C entry point at the end
// of this file from ops/mi_kernel.py.
//
// What bounds it on an H100: bytes, on paper. Each belief map is read once
// (S * h * w * 4 B: 164 MB at S = 4096, 100 x 100, 0.049 ms at 3.35 TB/s) and
// K^2 floats come back; the arithmetic (two logs per cell, two separable
// clamped sums of two fields, two small contractions: 0.6 MFLOP a scenario)
// would take 0.037 ms at the float32 peak. In practice the logs and the
// shared-memory traffic of the sums and contractions dominate.
//
// What the design does about it: one block per scenario keeps the whole
// pipeline in shared memory, so device memory sees the map once and the
// result once (the TPU kernel does the same per chunk of scenarios in VMEM;
// its lane padding, count-matrix dots, sublane rolls and bf16 split dots are
// Mosaic's and are not carried over). Planes per block: entropy (float),
// one scratch plane for the separable sums (float), a flag byte per cell
// (bit 0 free, bit 1 known-free) and a byte plane of x-direction known-free
// counts: 10 bytes a cell, 100 KB at 100 x 100, so two blocks share an SM.
// The sums are direct clamped sums of 2r+1 terms per axis in ascending index
// order (ops/target.py::blur_count_matrix's semantics; prefix sums would
// cancel differently); the frontier count is an integer. Every output is
// summed by one thread in a fixed order and nothing is atomic: two launches
// give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int K3_THREADS = 512;
constexpr int K3_MAX_SMEM = 232448;  // dynamic shared memory a block can have on sm_90

// Mirror of ops/mi_kernel.py::_Params (same field order).
struct K3Params {
    int S, h, w, K, r, fc;
    float thr, eps;
};

// Mirror of ops/mi_kernel.py::_Buffers (device pointers, same order).
struct K3Buffers {
    const float *data, *cxA, *cyA, *fallback, *hk00;
    float* out;
};

// Bytes of dynamic shared memory for one (h, w) map and K basis functions;
// mirrored by ops/mi_kernel.py::smem_bytes.
__host__ __device__ inline size_t k3_smem_bytes(int h, int w, int K) {
    const size_t cells = (size_t)h * w;
    return sizeof(float) * (2 * cells + (size_t)w * K + (size_t)K * h) + 2 * cells;
}

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

__global__ void __launch_bounds__(K3_THREADS, 2) k3_phik_grid(K3Params p, K3Buffers b) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int h = p.h, w = p.w, K = p.K, r = p.r, fc = p.fc;
    const int cells = h * w;
    float* E = reinterpret_cast<float*>(smem_raw);  // entropy, then vals, then raw
    float* T = E + cells;                           // x sums, then w1 (h, K)
    float* cxA = T + cells;                         // (w, K)
    float* cyA = cxA + w * K;                       // (K, h)
    uint8_t* flags = reinterpret_cast<uint8_t*>(cyA + K * h);
    uint8_t* cnt1 = flags + cells;                  // x-direction known-free counts
    const int tid = threadIdx.x;
    const float* map = b.data + (size_t)blockIdx.x * cells;

    // A. entropy and the two masks of every cell; the tables
    for (int idx = tid; idx < cells; idx += K3_THREADS) {
        const float v = map[idx];
        float q = v < 0.0f ? 0.5f : v;
        q = fminf(fmaxf(q, p.eps), 1.0f - p.eps);
        E[idx] = -(q * logf(q) + (1.0f - q) * log1pf(-q));
        const bool is_free = v < p.thr;
        flags[idx] = (uint8_t)((is_free ? 1 : 0) | ((is_free && v >= 0.0f) ? 2 : 0));
    }
    for (int i = tid; i < w * K; i += K3_THREADS) cxA[i] = b.cxA[i];
    for (int i = tid; i < K * h; i += K3_THREADS) cyA[i] = b.cyA[i];
    __syncthreads();

    // B. sums along x, edge-clamped, ascending index order
    for (int idx = tid; idx < cells; idx += K3_THREADS) {
        const int i = idx / w, j = idx - i * w;
        const float* row = E + i * w;
        float t = 0.0f;
        for (int k = j - r; k <= j + r; ++k) t += row[clampi(k, w - 1)];
        T[idx] = t;
        if (fc > 0) {
            const uint8_t* frow = flags + i * w;
            int c = 0;
            for (int k = j - fc; k <= j + fc; ++k) c += (frow[clampi(k, w - 1)] >> 1) & 1;
            cnt1[idx] = (uint8_t)c;
        }
    }
    __syncthreads();

    // C. sums along y, the frontier and free masks: vals into E
    for (int idx = tid; idx < cells; idx += K3_THREADS) {
        const int i = idx / w, j = idx - i * w;
        float t = 0.0f;
        for (int k = i - r; k <= i + r; ++k) t += T[clampi(k, h - 1) * w + j];
        bool keep = (flags[idx] & 1) != 0;
        if (fc > 0) {
            int c = 0;
            for (int k = i - fc; k <= i + fc; ++k) c += cnt1[clampi(k, h - 1) * w + j];
            keep = keep && c > 0;
        }
        E[idx] = fmaxf(keep ? t : 0.0f, 0.0f);
    }
    __syncthreads();

    // D. contraction along x: w1[i][k1] = sum_j vals[i][j] cxA[j][k1], into T
    for (int o = tid; o < h * K; o += K3_THREADS) {
        const int i = o / K, k1 = o - i * K;
        const float* row = E + i * w;
        float acc = 0.0f;
        for (int j = 0; j < w; ++j) acc += row[j] * cxA[j * K + k1];
        T[o] = acc;
    }
    __syncthreads();

    // E. contraction along y: raw[k1][k2] = sum_i cyA[k2][i] w1[i][k1], into E
    for (int o = tid; o < K * K; o += K3_THREADS) {
        const int k1 = o / K, k2 = o - k1 * K;
        const float* crow = cyA + k2 * h;
        float acc = 0.0f;
        for (int i = 0; i < h; ++i) acc += crow[i] * T[i * K + k1];
        E[o] = acc;
    }
    __syncthreads();

    // F. normalize by the target's mass, or fall back to the uniform target
    const float total = E[0] * b.hk00[0];
    float* out = b.out + (size_t)blockIdx.x * K * K;
    for (int o = tid; o < K * K; o += K3_THREADS)
        out[o] = total > 1e-12f ? E[o] / fmaxf(total, 1e-12f) : b.fallback[o];
}

// Launch K3 for p->S scenarios on `stream`; returns the CUDA error code
// (0 on success). Does not synchronize.
extern "C" int k3_phik_from_grid(const K3Params* params, const K3Buffers* buffers,
                                 void* stream) {
    K3Params p = *params;
    K3Buffers b = *buffers;
    if (p.S <= 0) return 0;
    const size_t smem = k3_smem_bytes(p.h, p.w, p.K);
    // K <= min(h, w) keeps w1 (h, K) and raw (K, K) inside one plane; counts fit a byte
    if (p.h < 1 || p.w < 1 || p.K < 1 || p.K > p.w || p.K > p.h || p.r < 0 || p.fc < 0 ||
        2 * p.fc + 1 > 255 || smem > (size_t)K3_MAX_SMEM)
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute((const void*)k3_phik_grid,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    void* args[] = {&p, &b};
    e = cudaLaunchKernel((const void*)k3_phik_grid, dim3(p.S), dim3(K3_THREADS), args, smem,
                         (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

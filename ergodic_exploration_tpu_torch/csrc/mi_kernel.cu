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
//
// A map whose planes do not fit one block (over ~22,800 cells at K = 10; the
// TPU kernel shrinks its scenario chunk for these, _pick_sc) takes the
// row-band form: k3_phik_band, grid (scenarios, bands). A block owns rows
// [y0, y1) of one scenario and loads them with a halo of max(r, fc) rows on
// each side, cut at the map's edges. It runs the same stages on its rows (the
// box sums and the frontier count clamp at the MAP's edge, never at a band's:
// the halo holds every row a band row's sums reach) and writes its
// unnormalized (K, K) partial contraction to scratch (S, bands, K, K); the
// partial mass is that partial's element (0, 0) times hk[0][0]. k3_finish, a
// block per scenario, adds the partials in band order, normalizes and applies
// the fallback: again no atomics, two launches give the same bits. The band
// height is chosen by the wrapper (ops/mi_kernel.py::band_plan); a map that
// fits one block keeps the single launch of k3_phik_grid.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

constexpr int K3_THREADS = 512;
constexpr int K3_MAX_SMEM = 232448;  // dynamic shared memory a block can have on sm_90

// Mirror of ops/mi_kernel.py::_Params (same field order).
struct K3Params {
    int S, h, w, K, r, fc;
    int bh, n_bands;  // band height and count of the row-band form (n_bands = 0: whole map)
    float thr, eps;
};

// Mirror of ops/mi_kernel.py::_Buffers (device pointers, same order).
struct K3Buffers {
    const float *data, *cxA, *cyA, *fallback, *hk00;
    float* out;
    float* part;  // (S, n_bands, K, K) partial contractions of the row-band form
};

// Bytes of dynamic shared memory of a block that holds `nl` rows of a w-wide
// map (its band with the halo) and contracts `bh` of them; the whole map is
// nl = bh = h. Mirrored by ops/mi_kernel.py::smem_bytes.
__host__ __device__ inline size_t k3_smem_bytes(int nl, int bh, int w, int K) {
    const size_t cells = (size_t)nl * w;
    return sizeof(float) * (2 * cells + (size_t)w * K + (size_t)K * bh) + 2 * cells;
}

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// Stages A-E for rows [y0, y1) of scenario s. BANDED: the block holds rows
// [a0, a1) = the band with its halo and writes the partial contraction to
// `raw_out` in device memory; else it holds the whole map and leaves raw in
// the first K * K floats of shared memory. Called by all threads of the block.
template <bool BANDED>
__device__ __forceinline__ void k3_rows(const K3Params& p, const K3Buffers& b, int s, int y0,
                                        int y1, unsigned char* smem_raw, float* raw_out) {
    const int h = p.h, w = p.w, K = p.K, r = p.r, fc = p.fc;
    const int m = r > fc ? r : fc;
    const int a0 = BANDED ? max(0, y0 - m) : 0;
    const int a1 = BANDED ? min(h, y1 + m) : h;
    const int bh = y1 - y0, cells = (a1 - a0) * w;
    float* E = reinterpret_cast<float*>(smem_raw);  // entropy, then vals, then raw
    float* T = E + cells;                           // x sums, then w1 (bh, K)
    float* cxA = T + cells;                         // (w, K)
    float* cyA = cxA + w * K;                       // (K, bh): columns y0 .. y1 of the table
    uint8_t* flags = reinterpret_cast<uint8_t*>(cyA + K * bh);
    uint8_t* cnt1 = flags + cells;                  // x-direction known-free counts
    const int tid = threadIdx.x;
    const float* map = b.data + ((size_t)s * h + a0) * w;

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
    for (int i = tid; i < K * bh; i += K3_THREADS) cyA[i] = b.cyA[(i / bh) * h + y0 + i % bh];
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

    // C. sums along y (clamped at the map's edge), the frontier and free
    // masks: vals of rows y0 .. y1 into E
    for (int o = tid; o < bh * w; o += K3_THREADS) {
        const int i = y0 + o / w, j = o % w;
        const int idx = (i - a0) * w + j;
        float t = 0.0f;
        for (int k = i - r; k <= i + r; ++k) t += T[(clampi(k, h - 1) - a0) * w + j];
        bool keep = (flags[idx] & 1) != 0;
        if (fc > 0) {
            int c = 0;
            for (int k = i - fc; k <= i + fc; ++k) c += cnt1[(clampi(k, h - 1) - a0) * w + j];
            keep = keep && c > 0;
        }
        E[idx] = fmaxf(keep ? t : 0.0f, 0.0f);
    }
    __syncthreads();

    // D. contraction along x: w1[i][k1] = sum_j vals[i][j] cxA[j][k1], into T
    for (int o = tid; o < bh * K; o += K3_THREADS) {
        const int i = o / K, k1 = o - i * K;
        const float* row = E + (y0 - a0 + i) * w;
        float acc = 0.0f;
        for (int j = 0; j < w; ++j) acc += row[j] * cxA[j * K + k1];
        T[o] = acc;
    }
    __syncthreads();

    // E. contraction along y: raw[k1][k2] = sum_i cyA[k2][i] w1[i][k1]
    for (int o = tid; o < K * K; o += K3_THREADS) {
        const int k1 = o / K, k2 = o - k1 * K;
        const float* crow = cyA + k2 * bh;
        float acc = 0.0f;
        for (int i = 0; i < bh; ++i) acc += crow[i] * T[i * K + k1];
        if (BANDED) raw_out[o] = acc;
        else E[o] = acc;
    }
}

// F. normalize by the target's mass, or fall back to the uniform target
__device__ __forceinline__ float k3_normalize(const K3Buffers& b, float raw, float raw00, int o) {
    const float total = raw00 * b.hk00[0];
    return total > 1e-12f ? raw / fmaxf(total, 1e-12f) : b.fallback[o];
}

__global__ void __launch_bounds__(K3_THREADS, 2) k3_phik_grid(K3Params p, K3Buffers b) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    k3_rows<false>(p, b, blockIdx.x, 0, p.h, smem_raw, nullptr);
    __syncthreads();
    const float* raw = reinterpret_cast<const float*>(smem_raw);
    float* out = b.out + (size_t)blockIdx.x * p.K * p.K;
    for (int o = threadIdx.x; o < p.K * p.K; o += K3_THREADS)
        out[o] = k3_normalize(b, raw[o], raw[0], o);
}

__global__ void __launch_bounds__(K3_THREADS) k3_phik_band(K3Params p, K3Buffers b) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int s = blockIdx.x, band = blockIdx.y;
    const int y0 = band * p.bh, y1 = min(p.h, y0 + p.bh);
    k3_rows<true>(p, b, s, y0, y1, smem_raw,
                  b.part + ((size_t)s * p.n_bands + band) * p.K * p.K);
}

__global__ void __launch_bounds__(128) k3_finish(K3Params p, K3Buffers b) {
    const int KK = p.K * p.K;
    const float* part = b.part + (size_t)blockIdx.x * p.n_bands * KK;
    float raw00 = 0.0f;
    for (int band = 0; band < p.n_bands; ++band) raw00 += part[band * KK];
    for (int o = threadIdx.x; o < KK; o += 128) {
        float raw = 0.0f;
        for (int band = 0; band < p.n_bands; ++band) raw += part[band * KK + o];
        b.out[(size_t)blockIdx.x * KK + o] = k3_normalize(b, raw, raw00, o);
    }
}

// Launch K3 for p->S scenarios on `stream`: the whole-map kernel when
// p->n_bands = 0, else the row-band kernel and its finish. Returns the CUDA
// error code (0 on success). Does not synchronize.
extern "C" int k3_phik_from_grid(const K3Params* params, const K3Buffers* buffers,
                                 void* stream) {
    K3Params p = *params;
    K3Buffers b = *buffers;
    cudaStream_t st = (cudaStream_t)stream;
    if (p.S <= 0) return 0;
    // counts fit a byte; the whole-map form keeps raw (K, K) and w1 (h, K) inside one plane
    if (p.h < 1 || p.w < 1 || p.K < 1 || p.K > p.w || p.r < 0 || p.fc < 0 ||
        2 * p.fc + 1 > 255 || p.n_bands < 0)
        return (int)cudaErrorInvalidValue;
    cudaError_t e;
    if (p.n_bands == 0) {
        const size_t smem = k3_smem_bytes(p.h, p.h, p.w, p.K);
        if (p.K > p.h || smem > (size_t)K3_MAX_SMEM) return (int)cudaErrorInvalidValue;
        e = launch_kernel(k3_phik_grid, dim3(p.S), dim3(K3_THREADS), smem, st, p, b);
    } else {
        const int m = p.r > p.fc ? p.r : p.fc;
        const int nl = p.bh + 2 * m < p.h ? p.bh + 2 * m : p.h;
        const size_t smem = k3_smem_bytes(nl, p.bh, p.w, p.K);
        if (p.bh < 1 || (size_t)p.bh * p.n_bands < (size_t)p.h ||
            (size_t)p.bh * (p.n_bands - 1) >= (size_t)p.h || p.n_bands > 65535 ||
            smem > (size_t)K3_MAX_SMEM)
            return (int)cudaErrorInvalidValue;
        e = launch_kernel(k3_phik_band, dim3(p.S, p.n_bands), dim3(K3_THREADS), smem, st, p, b);
        if (e != cudaSuccess) return (int)e;
        e = launch_kernel(k3_finish, dim3(p.S), dim3(128), 0, st, p, b);
    }
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

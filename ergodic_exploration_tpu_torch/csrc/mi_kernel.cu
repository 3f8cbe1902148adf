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
//   near  = some known-free cell (0 <= b < thr) lies in the edge-clamped
//           (2fc+1)^2 box                                   (fc > 0 only)
//   vals  = max((b < thr) && (fc == 0 || near) ? t2 : 0, 0)
//   raw   = cxA^T vals^T cyA^T   i.e. raw[k1][k2] = sum_ij vals[i][j] cxA[j][k1] cyA[k2][i]
//   total = raw[0][0] * hk[0][0]
//   out   = total > 1e-12 ? raw / max(total, 1e-12) : fallback
//
// cxA (w, K) and cyA (K, h) are the cosine tables with the nearest-cell
// lattice sampling folded in (ops/mi_kernel.py::mi_operands); fallback (K, K)
// is the uniform target over the lattice. Any K <= 128 (the TPU kernel's
// limit), any map with h, w >= 1, any r, fc >= 0. Built by nvcc for sm_90a
// (utils/cuda_build.py) and called through the plain C entry point at the end
// of this file from ops/mi_kernel.py.
//
// What bounds it on an H100: bytes, on paper. Each belief map is read once
// (S * h * w * 4 B: 164 MB at S = 4096, 100 x 100, 0.049 ms at 3.35 TB/s) and
// K^2 floats come back. In practice the work per cell (an entropy, a clamped
// sum along each axis, K multiply-adds) and the latency of the block's
// barrier-separated stages bound it, at about six times the byte bound.
//
// What the design does about it: one block per scenario (or per row band,
// below) keeps the whole pipeline in shared memory, so device memory sees
// the map once and the result once. A block of 256 threads holds one float
// plane (the entropy, overwritten in place by its x sums), three bit planes
// of 32-bit words (free, known-free, the dilated known-free) and the two
// tables: 4.4 bytes a cell, 54,000 bytes at 100 x 100 and K = 10, so four
// blocks share an SM (64 registers a thread). Stages:
//   copy   the block's rows of the map into the float plane and the tables
//          beside it (cyA transposed, padded to whole float4s), by cp.async
//          (16 bytes a copy where the rows allow: on an H100, 3-5 % less
//          time than 4-byte copies of path E's maps), nothing through
//          registers;
//   A      a warp per row: the entropy (cells at -1, 0 or 1, most of a map,
//          take one of three values computed with the same expression, the
//          same bits), both flags as words through __ballot_sync;
//   B      the frontier mask as an exact bitwise dilation: an edge-clamped box
//          only repeats cells inside the truncated window, so "some
//          known-free cell in the box" is an OR of shifted words along x
//          (funnel shifts across words) and then of 2fc+1 row words along y,
//          cut at the map's edges: no count, no limit on fc;
//   C      x box sums in place, a warp per row: a lane owns 5 consecutive
//          cells (a stride of 5 words is free of bank conflicts), loads them
//          and their 2r halo into registers once and adds each output's
//          2r+1 terms in ascending index order, the same bits as the plain
//          version; a row wider than 160 cells goes in passes, the raw halo
//          carried from lane 31 to lane 0;
//   D      y box sums, masks and the y contraction, fused: a lane owns a
//          column and a run of rows, slides a register window of 2r+1 x sums
//          down the run (one shared load per output, ascending order), forms
//          vals from one mask word (the y dilation ANDs the free bits in) and
//          adds cyA[k2][i] * vals into K register accumulators, 12 at a time
//          (every lane of a warp is on the same row, so the table row is a
//          broadcast float4 load); vals never goes to shared memory;
//   E      the runs' partial sums added in run order, then the x contraction:
//          up to 32 lanes an output, each on a range of j, and a fixed
//          butterfly over the ranges.
// r = 3, the sensor radius every caller passes, is a template argument
// (registers hold its windows); any other r takes the generic instance, which
// reads its terms from shared memory, into a second float plane. The
// association is y-then-x where the plain version goes x-then-y (within
// rtol 2e-4 / atol 2e-5, the JAX package's budget for its kernel). Every
// output is summed in a fixed order and nothing is atomic: two launches give
// the same bits.
//
// A map too large for one block at four blocks an SM takes the row-band form:
// grid (scenarios, bands). A block owns rows [y0, y1) of one scenario and
// loads them with a halo of max(r, fc) rows on each side, cut at the map's
// edges. It runs the same stages on its rows (box sums and dilations clamp at
// the MAP's edge, never at a band's: the halo holds every row a band row
// reaches) and writes its unnormalized (K, K) partial contraction to scratch
// (S, bands, K, K); k3_finish, a block per scenario, adds the partials in band
// order, normalizes and applies the fallback. The band height is chosen by
// the wrapper (ops/mi_kernel.py::band_plan).

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

constexpr int K3_THREADS = 256;
constexpr int K3_WARPS = K3_THREADS / 32;
constexpr int K3_BLOCKS_PER_SM = 4;  // at most 64 registers a thread
constexpr int K3_MAX_SMEM = 232448;  // dynamic shared memory a block can have on sm_90
constexpr int K3_KMAX = 128;         // the TPU kernel's limit on K
constexpr int K3_RX = 5;             // cells of a row a lane sums along x
constexpr int K3_KC = 12;            // coefficients k2 a lane accumulates at a time
constexpr int K3_RWIN = 3;           // the radius whose sums run in register windows

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

// Shared memory of a block that holds `nl` rows of a w-wide map (its band with
// the halo) and contracts `bh` of them; the whole map is nl = bh = h. Offsets
// in 4-byte words. Mirrored by ops/mi_kernel.py::smem_bytes.
struct K3Layout {
    int ww;        // words of a bit-plane row, and the column warps of stage D
    int ry;        // runs of rows in stage D
    int kp, kc;    // K padded to whole float4s; coefficients a chunk holds
    bool overlap;  // the runs' partials P reuse the float plane(s)
    size_t cyT, X, T, P, cxA, raw, F, KF, DX, words;
};

// x sums of a radius without a register window go to a second float plane
__host__ __device__ inline bool k3_second_plane(int r) { return r > 0 && r != K3_RWIN; }

__host__ __device__ inline K3Layout k3_layout(int nl, int bh, int w, int K, int r) {
    K3Layout L;
    L.ww = (w + 31) / 32;
    L.ry = L.ww < K3_WARPS ? K3_WARPS / L.ww : 1;
    L.kp = (K + 3) / 4 * 4;
    L.kc = L.kp < K3_KC ? L.kp : K3_KC;
    L.overlap = L.kp <= K3_KC && L.ww <= K3_WARPS;
    const size_t cells = (size_t)nl * w;
    const size_t planes = cells * (k3_second_plane(r) ? 2 : 1);
    const size_t part = (size_t)L.ry * L.kc * w;
    L.cyT = 0;  // (bh, kp), 16-byte aligned
    L.X = L.cyT + (size_t)bh * L.kp;
    L.T = k3_second_plane(r) ? L.X + cells : L.X;
    L.P = L.overlap ? L.X : L.X + planes;
    L.cxA = L.overlap ? L.X + (planes > part ? planes : part) : L.P + part;
    L.raw = L.cxA + (size_t)w * K;
    L.F = L.raw + (size_t)K * K;
    L.KF = L.F + (size_t)nl * L.ww;
    L.DX = L.KF + (size_t)nl * L.ww;
    L.words = L.DX + (size_t)nl * L.ww;
    return L;
}

__device__ __forceinline__ int clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// Asynchronous copies global -> shared (cp.async); k3_copy_wait waits for all
// of this thread's.
__device__ __forceinline__ void k3_copy16(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src));
#else
    for (int i = 0; i < 4; ++i) dst[i] = src[i];
#endif
}
__device__ __forceinline__ void k3_copy4(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src));
#else
    *dst = *src;
#endif
}
__device__ __forceinline__ void k3_copy_wait() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_all;\n" ::);
#endif
}

__device__ __forceinline__ float k3_clampq(float v, float eps) {
    const float q = v < 0.0f ? 0.5f : v;
    return fminf(fmaxf(q, eps), 1.0f - eps);
}

__device__ __forceinline__ float k3_entropy(float q) {
    return -(q * logf(q) + (1.0f - q) * log1pf(-q));
}

// 32 bits of a row of `nw` words starting at bit `start` (bits outside the
// row read as 0).
__device__ __forceinline__ uint32_t k3_bits_at(const uint32_t* row, int nw, int start) {
    const int q = start >> 5;
    const uint32_t lo = (q >= 0 && q < nw) ? row[q] : 0u;
    const uint32_t hi = (q + 1 >= 0 && q + 1 < nw) ? row[q + 1] : 0u;
    return __funnelshift_r(lo, hi, (unsigned)start & 31u);
}

// C. x box sums of radius R of the nl rows of E, in place: a warp per row,
// a lane per run of K3_RX cells.
template <int R>
__device__ __forceinline__ void k3_xsums(float* E, int nl, int w, int lane, int wid) {
    constexpr int N = K3_RX + 2 * R;
    for (int i = wid; i < nl; i += K3_WARPS) {
        float* row = E + (size_t)i * w;
        float carry[R];
        for (int base = 0; base < w; base += 32 * K3_RX) {
            const int j0 = base + lane * K3_RX;
            float win[N];
#pragma unroll
            for (int q = 0; q < N; ++q) win[q] = row[clampi(j0 - R + q, w - 1)];
            if (base > 0 && lane == 0) {  // the cells left of the pass were overwritten
#pragma unroll
                for (int q = 0; q < R; ++q) win[q] = carry[q];
            }
#pragma unroll
            for (int q = 0; q < R; ++q) carry[q] = __shfl_sync(0xffffffffu, win[K3_RX + q], 31);
            __syncwarp();
#pragma unroll
            for (int o = 0; o < K3_RX; ++o) {
                if (j0 + o < w) {
                    float t = win[o];
#pragma unroll
                    for (int q = 1; q <= 2 * R; ++q) t += win[o + q];
                    row[j0 + o] = t;
                }
            }
            __syncwarp();
        }
    }
}

// vals of cell (i, j) from its y box sum t and the mask bit; acc[k] +=
// cyT[i][c0 + k] * vals for the ng float4 groups of the chunk
__device__ __forceinline__ void k3_accumulate(float t, uint32_t mword, int lane, const float* cyrow,
                                              int ng, float* acc) {
    const float v = fmaxf(((mword >> lane) & 1u) ? t : 0.0f, 0.0f);
    if (v != 0.0f) {  // a zero adds nothing: the same bits
        const float4* cy = reinterpret_cast<const float4*>(cyrow);
#pragma unroll
        for (int g = 0; g < K3_KC / 4; ++g) {
            if (g < ng) {
                const float4 c = cy[g];
                acc[4 * g] = fmaf(c.x, v, acc[4 * g]);
                acc[4 * g + 1] = fmaf(c.y, v, acc[4 * g + 1]);
                acc[4 * g + 2] = fmaf(c.z, v, acc[4 * g + 2]);
                acc[4 * g + 3] = fmaf(c.w, v, acc[4 * g + 3]);
            }
        }
    }
}

// D. For column j and rows [i0, i1): y box sums of the x sums X, the mask
// bit of M (row i at word (i - m0) * ww + cw) and k3_accumulate. R > 0: a
// window of 2R+1 registers slides down the rows (one shared load a row);
// R = 0: radius r read term by term, the row loop not unrolled (unrolled,
// the generic loop spills past 64 registers).
template <int R>
__device__ __forceinline__ void k3_column(const float* X, const uint32_t* M, const float* cyT,
                                          int j, int lane, int cw, int i0, int i1, int y0,
                                          int a0, int m0, int h, int w, int ww, int kp, int c0,
                                          int ng, int r, float* acc) {
    const float* col = X + j;
    if constexpr (R > 0) {
        float win[2 * R + 1];
#pragma unroll
        for (int q = 0; q < 2 * R; ++q) win[q] = col[(size_t)(clampi(i0 - R + q, h - 1) - a0) * w];
        for (int i = i0; i < i1; ++i) {
            win[2 * R] = col[(size_t)(clampi(i + R, h - 1) - a0) * w];
            float t = win[0];
#pragma unroll
            for (int q = 1; q <= 2 * R; ++q) t += win[q];
#pragma unroll
            for (int q = 0; q < 2 * R; ++q) win[q] = win[q + 1];
            k3_accumulate(t, M[(size_t)(i - m0) * ww + cw], lane,
                          cyT + (size_t)(i - y0) * kp + c0, ng, acc);
        }
    } else {
#pragma unroll 1
        for (int i = i0; i < i1; ++i) {
            float t = 0.0f;
#pragma unroll 1
            for (int k = i - r; k <= i + r; ++k) t += col[(size_t)(clampi(k, h - 1) - a0) * w];
            k3_accumulate(t, M[(size_t)(i - m0) * ww + cw], lane,
                          cyT + (size_t)(i - y0) * kp + c0, ng, acc);
        }
    }
}

// Every stage for rows [y0, y1) of scenario s; the block holds rows
// [a0, a1) = those rows with their halo. raw_out: where the unnormalized
// (K, K) contraction goes (device memory for a band; the whole map leaves it
// in shared memory at L.raw). Called by all threads of the block.
template <int R>
__device__ __forceinline__ void k3_rows(const K3Params& p, const K3Buffers& b, int s, int y0,
                                        int y1, unsigned char* smem_raw, float* raw_out) {
    const int h = p.h, w = p.w, K = p.K, r = p.r, fc = p.fc;
    const int m = r > fc ? r : fc;
    const int a0 = max(0, y0 - m), a1 = min(h, y1 + m);
    const int nl = a1 - a0, bh = y1 - y0;
    const K3Layout L = k3_layout(nl, bh, w, K, r);
    const int ww = L.ww, kp = L.kp;
    float* smf = reinterpret_cast<float*>(smem_raw);
    uint32_t* smu = reinterpret_cast<uint32_t*>(smem_raw);
    float* cyT = smf + L.cyT;
    float* E = smf + L.X;  // beliefs, then entropy, then (R > 0) its x sums
    float* X = smf + L.T;  // the x sums that stage D reads
    float* P = smf + L.P;
    float* cxA = smf + L.cxA;
    uint32_t* F = smu + L.F;
    uint32_t* KF = smu + L.KF;  // known-free, then (rows y0 .. y1) its dilation
    uint32_t* DX = smu + L.DX;
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    const int n = nl * w;
    const float* map = b.data + ((size_t)s * h + a0) * w;

    // copy: the rows into E (asynchronously), the tables
    if ((reinterpret_cast<uintptr_t>(map) & 15u) == 0 && (n & 3) == 0) {
        for (int q = tid; q < n / 4; q += K3_THREADS) k3_copy16(E + 4 * q, map + 4 * q);
    } else {
        for (int q = tid; q < n; q += K3_THREADS) k3_copy4(E + q, map + q);
    }
    for (int q = tid; q < w * K; q += K3_THREADS) k3_copy4(cxA + q, b.cxA + q);
    for (int q = tid; q < K * bh; q += K3_THREADS) {  // cyT[i][k] = cyA[k][y0 + i]
        const int k = q / bh, i = q - k * bh;
        k3_copy4(cyT + i * kp + k, b.cyA + (size_t)k * h + y0 + i);
    }
    for (int q = tid; q < (kp - K) * bh; q += K3_THREADS) {  // zero for K <= k < kp
        const int k = q / bh, i = q - k * bh;
        cyT[i * kp + K + k] = 0.0f;
    }
    k3_copy_wait();
    __syncthreads();

    // A. a warp per row: entropy in place, free and known-free words; the
    // entropies of the exact beliefs -1, 0 and 1 first
    const float qa = k3_clampq(-1.0f, p.eps), qb = k3_clampq(0.0f, p.eps),
                qc = k3_clampq(1.0f, p.eps);
    const float ea = k3_entropy(qa), eb = k3_entropy(qb), ec = k3_entropy(qc);
    for (int i = wid; i < nl; i += K3_WARPS) {
        float* row = E + (size_t)i * w;
        for (int c0 = 0; c0 < ww; c0 += 4) {  // four words a step, without branches
            float v[4], e[4];
            bool other = false;  // a cell whose entropy takes the logs
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int j = (c0 + u) * 32 + lane;
                v[u] = j < w ? row[j] : 0.0f;
                const float q = k3_clampq(v[u], p.eps);
                e[u] = q == qa ? ea : (q == qb ? eb : ec);
                other = other || (j < w && q != qa && q != qb && q != qc);
            }
            if (__any_sync(0xffffffffu, other)) {
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const float q = k3_clampq(v[u], p.eps);
                    if ((c0 + u) * 32 + lane < w && q != qa && q != qb && q != qc)
                        e[u] = k3_entropy(q);
                }
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int j = (c0 + u) * 32 + lane;
                const bool in = j < w, is_free = in && v[u] < p.thr;
                if (in) row[j] = e[u];
                const uint32_t fw = __ballot_sync(0xffffffffu, is_free);
                const uint32_t kw = __ballot_sync(0xffffffffu, is_free && v[u] >= 0.0f);
                if (lane == 0 && c0 + u < ww) {
                    F[i * ww + c0 + u] = fw;
                    KF[i * ww + c0 + u] = kw;
                }
            }
        }
    }
    __syncthreads();

    // B (along x) and C
    if (fc > 0) {
        const int fx = min(fc, w - 1);
        for (int q = tid; q < nl * ww; q += K3_THREADS) {
            const int i = q / ww, c = q - i * ww;
            uint32_t acc = 0u;
            for (int d = -fx; d <= fx; ++d) acc |= k3_bits_at(KF + i * ww, ww, c * 32 + d);
            DX[q] = acc;
        }
    }
    if constexpr (R > 0) {
        k3_xsums<R>(E, nl, w, lane, wid);
    } else if (r > 0) {  // a radius without a register window: into the second plane
        for (int i = wid; i < nl; i += K3_WARPS) {
            const float* row = E + (size_t)i * w;
            for (int j = lane; j < w; j += 32) {
                float t = 0.0f;
                for (int k = j - r; k <= j + r; ++k) t += row[clampi(k, w - 1)];
                X[(size_t)i * w + j] = t;
            }
        }
    }
    __syncthreads();

    // B along y: the dilated known-free words of rows y0 .. y1, and with
    // them the free words: the whole mask, into KF
    if (fc > 0) {
        for (int q = tid; q < bh * ww; q += K3_THREADS) {
            const int il = q / ww, c = q - il * ww, i = y0 + il;
            const int k1 = min(h - 1, i + fc);
            uint32_t acc = 0u;
            for (int k = max(0, i - fc); k <= k1; ++k) acc |= DX[(k - a0) * ww + c];
            KF[q] = acc & F[(i - a0) * ww + c];
        }
        __syncthreads();
    }
    // the mask words of row i are M[(i - m0) * ww + c]
    const uint32_t* M = fc > 0 ? KF : F;
    const int m0 = fc > 0 ? y0 : a0;

    // D and E, chunk by chunk of K3_KC coefficients k2
    const int ry = L.ry, rpr = (bh + ry - 1) / ry, units = ww * ry;
    const size_t pstride = (size_t)L.kc * w;  // floats of one run's partials
    for (int c0 = 0; c0 < kp; c0 += K3_KC) {
        const int kcn = min(L.kc, kp - c0), kv = min(kcn, K - c0);
        float acc[K3_KC];
        bool held = false;  // overlap: this warp's unit waits for the barrier
        for (int u = wid; u < units; u += K3_WARPS) {
            const int cw = u % ww, run = u / ww, j = cw * 32 + lane;
            const int i0 = y0 + run * rpr, i1 = min(y1, i0 + rpr);
#pragma unroll
            for (int k = 0; k < K3_KC; ++k) acc[k] = 0.0f;
            if (j < w)
                k3_column<R>(X, M, cyT, j, lane, cw, i0, i1, y0, a0, m0, h, w, ww, kp, c0,
                             kcn / 4, r, acc);
            if (L.overlap) {
                held = true;
            } else if (j < w) {
#pragma unroll
                for (int k = 0; k < K3_KC; ++k)
                    if (k < kcn) P[run * pstride + (size_t)k * w + j] = acc[k];
            }
        }
        if (L.overlap) {
            __syncthreads();  // every lane is done reading the plane P overwrites
            const int cw = wid % ww, run = wid / ww, j = cw * 32 + lane;
            if (held && j < w) {
#pragma unroll
                for (int k = 0; k < K3_KC; ++k)
                    if (k < kcn) P[run * pstride + (size_t)k * w + j] = acc[k];
            }
        }
        __syncthreads();
        if (ry > 1) {  // the runs' partials, added in run order, into run 0's
            for (int q = tid; q < kcn * w; q += K3_THREADS) {
                float v = P[q];
                for (int run = 1; run < ry; ++run) v += P[run * pstride + q];
                P[q] = v;
            }
            __syncthreads();
        }
        // x contraction: raw[k1][c0 + k] = sum_j cxA[j][k1] P[k][j]; nq lanes
        // (a power of two) per output, each on a range of j in ascending
        // order, then a fixed butterfly over the ranges
        const int n_out = K * kv;
        int nq = 1;
        while (nq < 32 && 2 * nq * n_out <= K3_THREADS) nq *= 2;
        const int span = (w + nq - 1) / nq;
        for (int t0 = 0; t0 < n_out * nq; t0 += K3_THREADS) {
            const int t = t0 + tid, o = t / nq, part = t - o * nq;
            float acc_o = 0.0f;
            if (o < n_out) {
                const int k1 = o / kv, k = o - k1 * kv;
                const int j1 = min(w, (part + 1) * span);
                for (int j = part * span; j < j1; ++j)
                    acc_o = fmaf(cxA[j * K + k1], P[(size_t)k * w + j], acc_o);
            }
            for (int off = 1; off < nq; off <<= 1) acc_o += __shfl_xor_sync(0xffffffffu, acc_o, off);
            if (o < n_out && part == 0) raw_out[(o / kv) * K + c0 + o % kv] = acc_o;
        }
        __syncthreads();
    }
}

// F. normalize by the target's mass, or fall back to the uniform target
__device__ __forceinline__ float k3_normalize(const K3Buffers& b, float raw, float raw00, int o) {
    const float total = raw00 * b.hk00[0];
    return total > 1e-12f ? raw / fmaxf(total, 1e-12f) : b.fallback[o];
}

// grid (S) for the whole map, (S, n_bands) for the row-band form
template <int R>
__global__ void __launch_bounds__(K3_THREADS, K3_BLOCKS_PER_SM) k3_phik(K3Params p, K3Buffers b) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int s = blockIdx.x, KK = p.K * p.K;
    if (p.n_bands > 0) {
        const int y0 = blockIdx.y * p.bh, y1 = min(p.h, y0 + p.bh);
        k3_rows<R>(p, b, s, y0, y1, smem_raw, b.part + ((size_t)s * p.n_bands + blockIdx.y) * KK);
        return;
    }
    const K3Layout L = k3_layout(p.h, p.h, p.w, p.K, p.r);
    float* raw = reinterpret_cast<float*>(smem_raw) + L.raw;
    k3_rows<R>(p, b, s, 0, p.h, smem_raw, raw);
    float* out = b.out + (size_t)s * KK;
    for (int o = threadIdx.x; o < KK; o += K3_THREADS) out[o] = k3_normalize(b, raw[o], raw[0], o);
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

// Bytes of dynamic shared memory a block of K3 uses (the wrapper's
// smem_bytes mirrors it; the tests hold the two against each other).
extern "C" size_t k3_shared_bytes(int nl, int bh, int w, int K, int r) {
    return 4 * k3_layout(nl, bh, w, K, r).words;
}

// Launch K3 for p->S scenarios on `stream`: the whole-map form when
// p->n_bands = 0, else the row-band form and its finish. Returns the CUDA
// error code (0 on success). Does not synchronize.
extern "C" int k3_phik_from_grid(const K3Params* params, const K3Buffers* buffers,
                                 void* stream) {
    K3Params p = *params;
    K3Buffers b = *buffers;
    cudaStream_t st = (cudaStream_t)stream;
    if (p.S <= 0) return 0;
    if (p.h < 1 || p.w < 1 || p.K < 1 || p.K > K3_KMAX || p.r < 0 || p.fc < 0 || p.n_bands < 0)
        return (int)cudaErrorInvalidValue;
    int nl = p.h, bh = p.h;
    if (p.n_bands > 0) {
        const int m = p.r > p.fc ? p.r : p.fc;
        bh = p.bh;
        nl = (size_t)p.bh + 2 * (size_t)m < (size_t)p.h ? p.bh + 2 * m : p.h;
        if (p.bh < 1 || (size_t)p.bh * p.n_bands < (size_t)p.h ||
            (size_t)p.bh * (p.n_bands - 1) >= (size_t)p.h || p.n_bands > 65535)
            return (int)cudaErrorInvalidValue;
    }
    const size_t smem = k3_shared_bytes(nl, bh, p.w, p.K, p.r);
    if (smem > (size_t)K3_MAX_SMEM) return (int)cudaErrorInvalidValue;
    void (*kernel)(K3Params, K3Buffers) = p.r == K3_RWIN ? k3_phik<K3_RWIN> : k3_phik<0>;
    const dim3 grid(p.S, p.n_bands > 0 ? p.n_bands : 1);
    cudaError_t e = launch_kernel(kernel, grid, dim3(K3_THREADS), smem, st, p, b);
    if (e != cudaSuccess) return (int)e;
    if (p.n_bands > 0) {
        e = launch_kernel(k3_finish, dim3(p.S), dim3(128), 0, st, p, b);
        if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaGetLastError();
}

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
// What the design does about it: one block per scenario. The block keeps
// first[n_bins] and one packed word a window cell (its bin, its radius step,
// whether it is in range: 16 KB at P = 63) in shared memory (in a global
// workspace of the wrapper's where they would not fit a block). One
// geometry pass: each window cell computes its centre, radius, step, angle
// and bin once (a cell out of range that blocks nothing skips the angle);
// an edge-clamped duplicate of a cell (a later window row or column that
// clamps to the same map row or column) names the same map cell and would
// compute the same values, so it is skipped, and each map cell is decided
// once (the OR of the JAX version's transposed selectors over equal values).
// The occupied cells that can hide a cell in range go into their warp's
// list (a ballot and a prefix count: angle, half-width, bin, step, margin);
// when the list fills, the warp takes its blockers one by one, or 2, 4 or 8
// at a time where each tests few bins, its lanes on a blocker's bins near its
// own (about 70 of 256 at r = 0.5 cell), lowering first[] with a shared
// atomicMin. After the barrier one pass writes the output: the belief, 16
// bytes a thread where the rows are aligned, with the truth where a window
// cell's word says it is seen. No (cell x bin) pair reaches device memory,
// and no bin test calls fmodf: the remainder's argument lies in (-pi, 3pi),
// where torch's fmod-based remainder by 2 pi is one branch
// (remainder_two_pi).
//
// Rounding contract (-fmad=false): every multiply, add and division rounds
// on its own as PyTorch's elementwise kernels round them, in the plain
// version's order; atan2f, atanf, sqrtf, floorf and rintf are the functions
// PyTorch's CUDA kernels call for torch.atan2, atan, sqrt, floor and round,
// and remainder_two_pi gives torch.remainder's bits over its argument's
// range; 0.55 / x is PyTorch's reciprocal times 0.55 (Tensor.__rtruediv__),
// the divisions by the resolution and by 2 pi are true divisions by device
// tensors; the bin centres come from the wrapper, computed by the plain
// version's own torch expression on the same device. So the card's output
// equals the plain version's on the card cell for cell.
//
// Beside it, the coverage (coverage_kernel): the share of the beliefs' cells
// that are not UNKNOWN, the mapping loops' fraction_known. It replaces no
// Pallas kernel either: the mean in the JAX package's fused refresh program
// (ergodic_exploration_tpu/ops/sensor.py::fraction_known, :151-153). It
// counts in integers and writes float32((double) count / n), as its plain
// version (ops/sensor.py::fraction_known_plain) defines it: the same bits.
// What bounds it: bytes, the beliefs read once (4 n: 164 MB at S = 4096,
// 100 x 100, 0.049 ms at 3.35 TB/s). A grid of at most COVER_BLOCKS blocks
// strides over the cells 16 bytes a thread; a warp adds its lanes' counts by
// shuffles, a block its warps'; each block adds its count to a 64-bit total
// with one atomicAdd (integers: any order gives the same total) and takes a
// ticket, and the block that takes the last one writes the share and zeroes
// the total and the ticket for the next launch. One launch, no host sync.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"

namespace reveal {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LIST = 64;  // entries of a warp's blocker list
constexpr float PI_F = 3.14159265358979323846f;  // (float) pi, as torch casts math.pi
constexpr float TWO_PI_F = 6.28318530717958647692f;  // (float) 2 pi = 2 (float) pi

struct RevealParams {
    int S, h, w;
    int P;            // window side: min(window_cells, h, w)
    int n_bins;
    int n_r;          // radius steps: P / 2 + 2
    int pose_stride;  // floats between two scenarios' poses (>= 2)
    int table_global; // first[] and the cell words in b.tables instead of shared memory
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
    int* tables;           // (S, n_bins + P^2) workspace when table_global, else unused
    float* out;            // (S, h, w)
};

// The window geometry of one scenario: the first row and column of the
// window (before clamping), the origin, resolution and pose.
struct Geometry {
    long long sx, sy;
    float ox, oy, res, px, py;
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

// Window index k (row or column, start + k before clamping to [0, n - 1])
// is the first of the window's indices that clamp to its map index.
__device__ __forceinline__ bool first_of_its_cell(long long start, int k, int n) {
    return k == 0 || (start + k >= 1 && start + k <= n - 1);
}

// The first window index whose map index (row or column) is i, for an i
// the window covers.
__device__ __forceinline__ int window_index(long long start, int i) {
    return i == 0 ? 0 : (int)max((long long)i - start, 0LL);
}

// torch.remainder on floats: fmod, then the divisor added where the signs
// differ (ATen's CUDA and CPU kernels)
__host__ __device__ inline float torch_remainder(float a, float m) {
    float r = fmodf(a, m);
    if (r != 0.0f && ((m < 0.0f) != (r < 0.0f))) r += m;
    return r;
}

// torch_remainder(a, 2 pi) for a in (-2 pi, 4 pi), the bin test's range: in
// [2 pi, 4 pi) fmod is a - 2 pi, exact (Sterbenz); in [0, 2 pi) it is a; in
// (-2 pi, 0) it is a, and the sign fix adds 2 pi, rounded once. (-0 stays -0.)
__host__ __device__ inline float remainder_two_pi(float a) {
    return a >= TWO_PI_F ? a - TWO_PI_F : a < 0.0f ? a + TWO_PI_F : a;
}

}  // namespace reveal

using namespace reveal;

template <bool TABLE_GLOBAL>
__global__ void __launch_bounds__(THREADS) reveal_kernel(RevealParams p, RevealBuffers b) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int s = blockIdx.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int h = p.h, w = p.w, P = p.P, cells = P * P, n_bins = p.n_bins;
    const long long hw = (long long)h * w;
    const float* belief = b.belief + s * hw;
    const float* truth = b.truth + s * hw;
    float* out = b.out + s * hw;
    int* first = TABLE_GLOBAL ? b.tables + (long long)s * (n_bins + cells)
                              : reinterpret_cast<int*>(smem);
    // a window cell's word: bin << 16 | step << 1 | (the first of its map cell, in range)
    uint32_t* cell_word = reinterpret_cast<uint32_t*>(first + n_bins);
    float* lists = TABLE_GLOBAL ? reinterpret_cast<float*>(smem)
                                : reinterpret_cast<float*>(cell_word + cells);
    float* l_ang = lists + warp * LIST;
    float* l_half = lists + (WARPS + warp) * LIST;
    uint32_t* l_bin_q = reinterpret_cast<uint32_t*>(lists) + (2 * WARPS + warp) * LIST;
    int* l_m = reinterpret_cast<int*>(lists) + (3 * WARPS + warp) * LIST;

    for (int k = tid; k < n_bins; k += THREADS) first[k] = p.n_r;
    __syncthreads();

    // the blockers of this warp's list: a blocker a time, its bins near its
    // own over the lanes; 2, 4 or 8 blockers at a time where each tests at
    // most 16, 8 or 4 bins. A bin the test passes lies within half_w / (2 pi
    // / n_bins) + 1/2 bins of the cell's (and rounding moves that by far less
    // than a bin): the margin m holds it.
    auto drain = [&](int n) {
        __syncwarp();
        for (int e = 0; e < n;) {
            const int mine = e + lane < n ? l_m[e + lane] : 1 << 20;
            const unsigned m1 = __ballot_sync(0xffffffffu, mine <= 1);
            const unsigned m3 = __ballot_sync(0xffffffffu, mine <= 3);
            const unsigned m7 = __ballot_sync(0xffffffffu, mine <= 7);
            const int take = (m1 & 0xFFu) == 0xFFu ? 8 : (m3 & 0xFu) == 0xFu ? 4
                                                    : (m7 & 0x3u) == 0x3u ? 2 : 1;
            const int width = 32 / take, me = e + lane / width;
            const float ang = l_ang[me], half_w = l_half[me];
            const int bin = (int)(l_bin_q[me] >> 16), q = (int)(l_bin_q[me] & 0xFFFFu), m = l_m[me];
            const bool all = 2 * m + 1 >= n_bins;
            const int lo = all ? 0 : bin - m, hi = all ? n_bins - 1 : bin + m;
            for (int k = lo + lane % width; k <= hi; k += width) {
                const int bb = k < 0 ? k + n_bins : k >= n_bins ? k - n_bins : k;
                const float dang = fabsf(remainder_two_pi((ang - b.centers[bb]) + PI_F) - PI_F);
                if (dang <= half_w) atomicMin(&first[bb], q);
            }
            e += take;
        }
        __syncwarp();
    };

    // geometry: each window cell once, a warp on 32 consecutive cells; a cell
    // out of range needs its bin only where it blocks. A blocker at step
    // q_far or beyond hides no cell in range (their steps are at most
    // rint(range / res) < q_far), so it is not listed.
    const Geometry g = geometry(p, b, s);
    const int q_far = (int)ceilf(p.sensor_range / g.res) + 1;
    int listed = 0;  // entries in this warp's list (the same in every lane)
    for (int base = warp * 32; base < cells; base += THREADS) {
        const int t = base + lane;
        bool blocker = false;
        float ang = 0.0f, half_w = 0.0f;
        uint32_t bin_q = 0;
        int m = 0;
        if (t < cells) {
            const int iy = t / P, ix = t - iy * P;
            uint32_t word = 0;
            if (first_of_its_cell(g.sy, iy, h) && first_of_its_cell(g.sx, ix, w)) {
                const long long row = min(max(g.sy + iy, 0LL), (long long)h - 1);
                const long long col = min(max(g.sx + ix, 0LL), (long long)w - 1);
                const bool occupied = truth[row * w + col] >= p.thr;
                const float gx = g.ox + ((float)col + 0.5f) * g.res;
                const float gy = g.oy + ((float)row + 0.5f) * g.res;
                const float dx = gx - g.px, dy = gy - g.py;
                const float r = sqrtf(dx * dx + dy * dy);
                const bool in_range = r <= p.sensor_range;
                const float rc = r / g.res;
                const int q = (int)fminf(fmaxf(rintf(rc), 0.0f), (float)(p.n_r - 1));
                if (in_range || (occupied && q < q_far)) {
                    ang = atan2f(dy, dx);
                    const float bf = floorf(((ang + PI_F) / TWO_PI_F) * (float)n_bins);
                    const int bin = (int)fminf(fmaxf(bf, 0.0f), (float)(n_bins - 1));
                    word = (uint32_t)bin << 16 | (uint32_t)q << 1 | (in_range ? 1u : 0u);
                    if (occupied && q < q_far) {
                        blocker = true;
                        half_w = atanf((1.0f / fmaxf(rc, 0.5f)) * 0.55f);
                        m = (int)(half_w * (float)n_bins * 0.15915494f + 0.5f) + 1;
                        bin_q = (uint32_t)bin << 16 | (uint32_t)q;
                    }
                }
            }
            cell_word[t] = word;
        }
        const unsigned mask = __ballot_sync(0xffffffffu, blocker);
        if (blocker) {
            const int at = listed + __popc(mask & ((1u << lane) - 1u));
            l_ang[at] = ang;
            l_half[at] = half_w;
            l_bin_q[at] = bin_q;
            l_m[at] = m;
        }
        listed += __popc(mask);
        if (listed > LIST - 32) {
            drain(listed);
            listed = 0;
        }
    }
    drain(listed);
    __syncthreads();

    // the output: the belief, with the truth where a window cell is seen
    // (its step <= first[its bin], in range); 16 bytes a thread where the
    // rows are 16-byte aligned
    const int rlo = (int)min(max(g.sy, 0LL), (long long)h - 1);
    const int rhi = (int)min(max(g.sy + P - 1, 0LL), (long long)h - 1);
    const int clo = (int)min(max(g.sx, 0LL), (long long)w - 1);
    const int chi = (int)min(max(g.sx + P - 1, 0LL), (long long)w - 1);
    auto seen = [&](int i, int j) {
        if (i < rlo || i > rhi || j < clo || j > chi) return false;
        const uint32_t word = cell_word[window_index(g.sy, i) * P + window_index(g.sx, j)];
        return (word & 1u) && (int)(word >> 1 & 0x7FFFu) <= first[word >> 16];
    };
    const uintptr_t bases = reinterpret_cast<uintptr_t>(b.belief) |
                            reinterpret_cast<uintptr_t>(b.truth) |
                            reinterpret_cast<uintptr_t>(b.out);
    if (w % 4 == 0 && bases % 16 == 0) {
        for (long long q4 = tid; q4 < hw / 4; q4 += THREADS) {
            const int i = (int)(4 * q4 / w), j = (int)(4 * q4 - (long long)i * w);
            float4 v = reinterpret_cast<const float4*>(belief)[q4];
            if (i >= rlo && i <= rhi && j + 3 >= clo && j <= chi) {
                const bool s0 = seen(i, j), s1 = seen(i, j + 1), s2 = seen(i, j + 2),
                           s3 = seen(i, j + 3);
                if (s0 || s1 || s2 || s3) {
                    const float4 t = reinterpret_cast<const float4*>(truth)[q4];
                    v = make_float4(s0 ? t.x : v.x, s1 ? t.y : v.y, s2 ? t.z : v.z,
                                    s3 ? t.w : v.w);
                }
            }
            reinterpret_cast<float4*>(out)[q4] = v;
        }
    } else {
        int i = tid / w, j = tid - (tid / w) * w;
        for (long long c = tid; c < hw; c += THREADS) {
            out[c] = seen(i, j) ? truth[c] : belief[c];
            for (j += THREADS; j >= w; j -= w) ++i;
        }
    }
}

// ---------------------------------------------------------------------------
// the coverage
// ---------------------------------------------------------------------------

constexpr int COVER_THREADS = 256;
constexpr int COVER_BLOCKS = 1056;  // eight blocks on each of an H100's 132 SMs, at most
constexpr float UNKNOWN = -1.0f;    // grid.py: a cell no sensor has seen

// Mirror of ops/reveal_kernel.py::_CoverParams.
struct CoverParams {
    long long n;  // cells
};

// Mirror of ops/reveal_kernel.py::_CoverBuffers (device pointers).
struct CoverBuffers {
    const float* data;         // (n,) beliefs
    unsigned long long* work;  // the running count and the blocks done: 0 between launches
    float* out;                // () the share of known cells
};

__device__ __forceinline__ unsigned long long known(float v) { return v != UNKNOWN ? 1ull : 0ull; }

// VEC: the cells' first address 16-byte aligned (four cells a load)
template <bool VEC>
__global__ void __launch_bounds__(COVER_THREADS) coverage_kernel(CoverParams p, CoverBuffers b) {
    extern __shared__ __align__(16) unsigned long long csm[];  // a count a warp
    const long long stride = (long long)gridDim.x * COVER_THREADS;
    const long long tid = (long long)blockIdx.x * COVER_THREADS + threadIdx.x;
    unsigned long long cnt = 0;
    long long tail = 0;  // the first cell the scalar loop takes
    if constexpr (VEC) {
        const float4* d4 = reinterpret_cast<const float4*>(b.data);
        const long long n4 = p.n / 4;
        for (long long i = tid; i < n4; i += stride) {
            const float4 v = d4[i];
            cnt += known(v.x) + known(v.y) + known(v.z) + known(v.w);
        }
        tail = 4 * n4;
    }
    for (long long i = tail + tid; i < p.n; i += stride) cnt += known(b.data[i]);
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
    if ((threadIdx.x & 31) == 0) csm[threadIdx.x >> 5] = cnt;
    __syncthreads();
    if (threadIdx.x != 0) return;
    unsigned long long blk = 0;
    for (int w = 0; w < COVER_THREADS / 32; ++w) blk += csm[w];
    atomicAdd(b.work, blk);
    __threadfence();
    if (atomicAdd(b.work + 1, 1ull) != (unsigned long long)gridDim.x - 1) return;
    const unsigned long long total = atomicAdd(b.work, 0ull);  // every block's count is in
    *b.out = (float)((double)total / (double)p.n);
    b.work[0] = 0;
    b.work[1] = 0;
}

// Launch the coverage of p->n cells on `stream`; returns the CUDA error code
// (0 on success). Does not synchronize. Launches on one stream run in order,
// so they may share `work`; launches on two streams at once may not.
extern "C" int reveal_coverage(const CoverParams* params, const CoverBuffers* buffers,
                               void* stream) {
    CoverParams p = *params;
    CoverBuffers b = *buffers;
    if (p.n < 1 || b.work == nullptr || b.out == nullptr) return (int)cudaErrorInvalidValue;
    const long long want = (p.n + 4LL * COVER_THREADS - 1) / (4LL * COVER_THREADS);
    const int blocks = want < COVER_BLOCKS ? (int)want : COVER_BLOCKS;
    const bool vec = (uintptr_t)b.data % 16 == 0;
    const size_t smem = COVER_THREADS / 32 * sizeof(unsigned long long);
    cudaError_t e = vec ? launch_kernel(coverage_kernel<true>, dim3(blocks), dim3(COVER_THREADS),
                                        smem, (cudaStream_t)stream, p, b)
                        : launch_kernel(coverage_kernel<false>, dim3(blocks),
                                        dim3(COVER_THREADS), smem, (cudaStream_t)stream, p, b);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// Bytes of shared memory a block needs: the warps' blocker lists, and
// first[] and the cell words unless they live in the global workspace.
extern "C" long long reveal_smem_bytes(int P, int n_bins, int table_global) {
    const long long lists = 4LL * THREADS / 32 * LIST * 4;
    return lists + (table_global ? 0 : 4LL * (n_bins + (long long)P * P));
}

// The bin test's remainder against torch's over `n` arguments: branch[i] =
// remainder_two_pi(a[i]), fmod[i] = torch_remainder(a[i], 2 pi), on the host
// (a check of the branch's range; the kernel never calls it).
extern "C" void reveal_remainder_check(const float* a, float* branch, float* fmod_fix, int n) {
    for (int i = 0; i < n; ++i) {
        branch[i] = remainder_two_pi(a[i]);
        fmod_fix[i] = torch_remainder(a[i], TWO_PI_F);
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
        p.n_bins > 65536 || p.n_r != p.P / 2 + 2 || p.n_r > 32768 || p.pose_stride < 2 ||
        (p.table_global && b.tables == nullptr))
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)reveal_smem_bytes(p.P, p.n_bins, p.table_global);
    if (smem > (size_t)max_dynamic_smem()) return (int)cudaErrorInvalidValue;
    cudaError_t e = p.table_global
                        ? launch_kernel(reveal_kernel<true>, dim3(p.S), dim3(THREADS), smem,
                                        (cudaStream_t)stream, p, b)
                        : launch_kernel(reveal_kernel<false>, dim3(p.S), dim3(THREADS), smem,
                                        (cudaStream_t)stream, p, b);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

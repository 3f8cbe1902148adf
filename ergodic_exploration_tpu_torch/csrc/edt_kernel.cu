// E — the world rebuild of the mapping loop, for NVIDIA Hopper: the
// Euclidean distance transform of each map, its gradient and, optionally,
// the free-space mask at the phi lattice, in one launch for the batch.
//
// Replaces no Pallas kernel: the XLA program that the JAX package compiles
// for ergodic_exploration_tpu/engine.py::_world_one (:279-294, vmapped at
// :148 and :1067): ops/distance.py::edt (:33-54, two dense min-plus
// reductions against an (n, n) squared-offset matrix), the central-difference
// gradient of DistanceField.from_grid (:78-95) and _free_mask_one (:271-277,
// the map's occupancy sampled at the lattice). Built by nvcc for sm_90a
// (utils/cuda_build.py) and called through the plain C entry point at the end
// of this file from ops/edt_kernel.py, whose plain versions (edt_field_plain:
// ops/distance.py's edt, then central_gradient; world_plain: that and
// GridMap.occupancy_at of Domain.sample_lattice) give the same bits.
//
// What it computes, for every map (data (h, w), origin, resolution res):
//   occ      = data >= thr
//   d2[i, j] = min over occupied (i', j') of (i - i')^2 + (j - j')^2, else big
//   dist     = d2 >= big ? FAR : sqrtf(d2) * res          (big = 4 max(h, w)^2)
//   grad     = the central differences of dist along x and y, one-sided at
//              the borders, divided by 2 res (by res at the borders), zero
//              where dist >= FAR
//   free[n]  = data[cell of lattice point n] < thr ? 1 : 0   (with the mask)
// Every squared distance is an integer under 2^24 for maps under 1832 cells
// a side, so any exact algorithm gives the plain version's d2 (its two
// passes, columns then rows, in either order): the kernel's values equal the
// plain version's bit for bit.
//
// What bounds it on an H100: bytes. The data is read once and dist, grad
// (and free) written once: 16 bytes a cell (and 4 a lattice point), 819 MB at
// S = 4096, 100 x 100, N = 10^4 with the mask, 0.245 ms at 3.35 TB/s. The
// plain version materialises (maps, n, n, n) floats for each pass and (S, N,
// 2) int64 indices for the mask.
//
// What the design does about it: one block per map (256 threads), every
// pass O(h w) whatever the map. The block reads the map once, all threads on
// consecutive cells, 16 bytes a thread, into a plane of 8-bit markers in
// shared memory (16-bit past 254 cells a side): 0 occupied, NONE free, HELD
// neither (NaN); with the mask it also maps each lattice column and row to
// its map column and row once (nsx + nsy points, not nsx nsy). Rows: each
// row is cut into as many segments as the block has threads for (2 at 100 x
// 100); a segment's thread notes its first and last occupied column, then
// sweeps the segment left and right in place with the carries from the
// other segments: the plane holds
// each cell's distance along its row. Columns: a thread per column (the
// first warps of the block) builds the exact lower envelope of the parabolas
// (x - v)^2 + g(v)^2 of the rows v with an occupied cell (Felzenszwalb and
// Huttenlocher's, its intersections compared as exact integer fractions, no
// float boundary), its stack of row indices in shared memory beside the
// plane, then walks the column backwards, popping a parabola as soon as the
// one under it is no worse, and writes dist: neighbouring threads on
// neighbouring columns, so each step's stores are coalesced. The free mask
// is read from the markers at the nsx nsy lattice cells, between the load
// and the row sweeps that overwrite them, so nothing of the mask grows with
// the map. After the barrier the gradient reads dist back (the block's own writes,
// L2-hot), four cells of a row a thread in 16-byte loads and stores; a zero
// difference skips the IEEE division, whose slow path zeros take. Shared
// memory with the mask: 24 KB at 100 x 100 (eight blocks an SM), 86 KB at
// 200 x 200; past 227 KB (512 x 512) the plane and the stack live in a
// workspace the wrapper allocates (the global-memory form, same passes and
// barriers). What stays in shared memory then is 4 bytes a lattice column
// and row and 4 a row segment (16.8 KB at 4000 x 4000 with a 100 x 100
// lattice; under 232448 bytes for every map under 32768 cells a side with
// a lattice of up to 25,000 columns and rows together).
//
// Rounding contract (-fmad=false): the finishing steps are the plain
// version's operations one by one: sqrtf then the product with res, the
// gradient's subtraction then an IEEE division by (2 res) or res; the mask's
// lattice point origin + f lengths (the product, then the sum, f from the
// wrapper by the plain version's own expression on the same device), then
// (p - map origin) / res - 0.5, rintf (half-even, as torch.round), the clamp
// to the map, and data < thr (a NaN cell is not free, though the EDT counts
// it unoccupied).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"

namespace edtk {

constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 8;  // blocks an SM: 2048 threads, 32 registers a thread
constexpr int SMALL = 254;     // maps up to this many cells a side take 8-bit planes

// The plane's markers after the load: 0 occupied (data >= thr), NONE free
// (data < thr), HELD neither (NaN); after the row pass a cell's distance
// along its row, or NONE where the row has no occupied cell.
template <class T>
struct Mark {
    static constexpr int NONE = (int)(T)~0u;
    static constexpr int HELD = NONE - 1;
};

struct EdtParams {
    int S, h, w;
    int plane_global;  // the plane and stack in the map's grad output instead of shared memory
    int nsx, nsy;      // the free mask's lattice; 0 x 0: no mask
    float thr;         // occupied_threshold
    float far;         // FAR
};

struct EdtBuffers {
    const float* data;         // (S, h, w)
    const float* res;          // (S,)
    const float* map_origin;   // (S, 2) with the mask
    const float* dom_origin;   // (S, 2) with the mask
    const float* dom_lengths;  // (S, 2) with the mask
    const float* fx;           // (nsx,) lattice fractions (k + 0.5) / nsx, with the mask
    const float* fy;           // (nsy,)
    float* dist;               // (S, h, w)
    float* grad;               // (S, h, w, 2)
    float* free;               // (S, nsx * nsy) with the mask
    unsigned char* work;       // (S, plane bytes) in the global-memory form
};

// Row stride of a plane of T: >= w and 4 mod 8 bytes, so that the threads of
// a warp on consecutive rows hit distinct banks.
template <class T>
__host__ __device__ inline int plane_stride(int w) {
    const int unit = 8 / (int)sizeof(T), want = 4 / (int)sizeof(T);
    return w + ((want - w % unit) % unit + unit) % unit;
}

// Warps' column groups of the column pass: 32 columns each.
__host__ __device__ inline int column_groups(int w) { return (w + 31) / 32; }

// Row stride of the column pass's stacks, in elements of T: a lane each,
// 4 mod 8 bytes so that lanes at different depths spread over the banks.
template <class T>
__host__ __device__ inline int stack_stride(int w) {
    return 32 * column_groups(w) + 4 / (int)sizeof(T);
}

// Segments a row is cut into for the row pass.
__host__ __device__ inline int row_segments(int h) { return h >= THREADS ? 1 : THREADS / h; }

// Bytes of shared memory besides the plane: the mask's lattice-to-cell
// tables (with the mask), the rows' summaries.
__host__ __device__ inline long long table_bytes(int h, int nsx, int nsy) {
    return (nsx > 0 ? 4LL * (nsx + nsy) : 0) + 4LL * row_segments(h) * h;
}

// Bytes of the plane and the stack (shared memory unless the global form).
template <class T>
__host__ __device__ inline long long plane_bytes(int h, int w) {
    return (long long)sizeof(T) * h * (plane_stride<T>(w) + stack_stride<T>(w));
}

// A rounded lattice coordinate clamped to [0, n - 1] (NaN to 0, as the plain
// version's int64 conversion and clamp give).
__device__ __forceinline__ int clamp_index(float r, int n) {
    return !(r >= 0.0f) ? 0 : r >= (float)(n - 1) ? n - 1 : (int)r;
}

// num / den (den > 0 and finite) without the division where num is zero,
// as it often is on flat stretches of a distance field: num * den is the
// same signed zero, and skipping the IEEE division measured faster on F's
// beliefs
__device__ __forceinline__ float quotient(float num, float den) {
    float q;
    if (num != 0.0f)
        q = num / den;
    else
        q = num * den;
    return q;
}

}  // namespace edtk

using namespace edtk;

template <class T, bool PLANE_GLOBAL, bool MASK>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) edt_kernel(EdtParams p, EdtBuffers b) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int NONE = Mark<T>::NONE, HELD = Mark<T>::HELD;
    const int s = blockIdx.x, tid = threadIdx.x;
    const int h = p.h, w = p.w, ws = plane_stride<T>(w), nsx = MASK ? p.nsx : 0,
              nsy = MASK ? p.nsy : 0, groups = column_groups(w);
    const long long hw = (long long)h * w, work_stride = plane_bytes<T>(h, w);
    const float* data = b.data + s * hw;
    float* dist = b.dist + s * hw;
    float* grad = b.grad + 2 * s * hw;
    const float res = b.res[s], two_r = 2.0f * res;
    int* col_of = reinterpret_cast<int*>(smem);  // lattice column ix -> map column
    int* row_of = col_of + nsx;                    // lattice row iy -> map row
    const int nseg = row_segments(h), seg_len = (w + nseg - 1) / nseg;
    int16_t* seg_first = reinterpret_cast<int16_t*>(row_of + nsy);
    int16_t* seg_last = seg_first + nseg * h;
    T* plane = PLANE_GLOBAL ? reinterpret_cast<T*>(b.work + s * (long long)work_stride)
                            : reinterpret_cast<T*>(seg_last + nseg * h);
    T* stack = plane + (long long)h * ws;  // stack[k * sst + column]
    const int sst = stack_stride<T>(w);

    // the map into the plane, all threads on consecutive cells (16 bytes a
    // thread where the maps are 16-byte aligned)
    auto mark = [&](float v) { return (T)(v >= p.thr ? 0 : v < p.thr ? NONE : HELD); };
    if (hw % 4 == 0 && reinterpret_cast<uintptr_t>(b.data) % 16 == 0) {
        const float4* src = reinterpret_cast<const float4*>(data);
        for (long long q = tid; q < hw / 4; q += THREADS) {
            const float4 v = src[q];
            int i = (int)(4 * q / w), j = (int)(4 * q - (long long)i * w);
            const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                plane[(long long)i * ws + j] = mark(vs[e]);
                if (++j == w) {
                    j = 0;
                    ++i;
                }
            }
        }
    } else {
        int i = tid / w, j = tid - (tid / w) * w;
        for (long long c = tid; c < hw; c += THREADS) {
            plane[(long long)i * ws + j] = mark(data[c]);
            for (j += THREADS; j >= w; j -= w) ++i;
        }
    }
    // the free mask's cell of each lattice column and row: the lattice point
    // (origin + f lengths), then (p - map origin) / res - 0.5, rounded half-even
    // and clamped to the map
    if (MASK) {
        const float dox = b.dom_origin[2 * s], doy = b.dom_origin[2 * s + 1];
        const float dlx = b.dom_lengths[2 * s], dly = b.dom_lengths[2 * s + 1];
        const float mox = b.map_origin[2 * s], moy = b.map_origin[2 * s + 1];
        for (int k = tid; k < nsx; k += THREADS)
            col_of[k] = clamp_index(rintf((dox + b.fx[k] * dlx - mox) / res - 0.5f), w);
        for (int k = tid; k < nsy; k += THREADS)
            row_of[k] = clamp_index(rintf((doy + b.fy[k] * dly - moy) / res - 0.5f), h);
    }
    __syncthreads();

    // rows: the first and last occupied column of each (segment, row)
    for (int t = tid; t < nseg * h; t += THREADS) {
        const int k = t / h, i = t - k * h;
        const int j0 = k * seg_len, j1 = min(w, j0 + seg_len);
        const T* row = plane + (long long)i * ws;
        int f = -1, l = -1;
        for (int j = j0; j < j1; ++j) {
            if (row[j] == 0) {
                if (f < 0) f = j;
                l = j;
            }
        }
        seg_first[t] = (int16_t)f;
        seg_last[t] = (int16_t)l;
    }
    // the free mask, x-major (point n = ix nsy + iy), read from the markers
    // before the row pass overwrites them: NONE where data < thr at the
    // point's cell (a NaN cell is HELD, not free)
    if (MASK) {
        float* fr = b.free + (long long)s * nsx * nsy;
        int ix = tid / nsy, iy = tid - (tid / nsy) * nsy;
        for (int n = tid; n < nsx * nsy; n += THREADS) {
            fr[n] = plane[(long long)row_of[iy] * ws + col_of[ix]] == NONE ? 1.0f : 0.0f;
            for (iy += THREADS; iy >= nsy; iy -= nsy) ++ix;
        }
    }
    __syncthreads();
    // each segment swept left then right, the nearest occupied columns of the
    // other segments carried in; a cell is occupied exactly where its plane
    // value is 0 in both sweeps
    for (int t = tid; t < nseg * h; t += THREADS) {
        const int k = t / h, i = t - k * h;
        const int j0 = k * seg_len, j1 = min(w, j0 + seg_len);
        T* row = plane + (long long)i * ws;
        int last = -1, next = -1;
        for (int kk = k - 1; kk >= 0 && last < 0; --kk) last = seg_last[kk * h + i];
        for (int kk = k + 1; kk < nseg && next < 0; ++kk) next = seg_first[kk * h + i];
        for (int j = j0; j < j1; ++j) {
            if (row[j] == 0) last = j;
            row[j] = (T)(last >= 0 ? j - last : NONE);
        }
        for (int j = j1 - 1; j >= j0; --j) {
            if (row[j] == 0) next = j;
            if (next >= 0 && next - j < (int)row[j]) row[j] = (T)(next - j);
        }
    }
    __syncthreads();

    // columns, a warp on a group of 32: d2[x] = min over the rows v with an
    // occupied cell of g(v)^2 + (x - v)^2, g the distance along the row, by
    // the lower envelope of those parabolas (any of them is below every big +
    // (x - v)^2, so the rows without an occupied cell take no part; a map
    // without one is FAR). H(v) = g(v)^2 + v^2; the parabolas of u < v meet at
    // (H(v) - H(u)) / (2 (v - u)), a fraction kept as its numerator and
    // (positive) denominator.
    for (int j = tid; j < 32 * groups; j += THREADS) {
        if (j >= w) continue;
        const T* col = plane + j;
        T* st = stack + j;
        auto H = [&](int v) {
            const int g = col[(long long)v * ws];
            return g * g + v * v;
        };
        // forward: the envelope; the top (vt, Ht) and the one under it (vs,
        // Hs) in registers, the top's left boundary zn / zd (none at k = 0)
        int k = -1, vt = 0, Ht = 0, vs = 0, Hs = 0, zn = 0, zd = 1;
        for (int x = 0; x < h; ++x) {
            const int g = col[(long long)x * ws];
            if (g == NONE) continue;
            const int Hx = g * g + x * x;
            int n1 = 0, d1 = 1;
            while (k >= 0) {
                n1 = Hx - Ht;
                d1 = 2 * (x - vt);
                // pop the top while x's intersection with it is not right of
                // its left boundary
                if (k == 0 || (long long)n1 * zd > (long long)zn * d1) break;
                --k;
                vt = vs;
                Ht = Hs;
                if (k >= 1) {
                    vs = st[(long long)(k - 1) * sst];
                    Hs = H(vs);
                    zn = Ht - Hs;
                    zd = 2 * (vt - vs);
                }
            }
            ++k;
            st[(long long)k * sst] = (T)x;
            vs = vt;
            Hs = Ht;
            vt = x;
            Ht = Hx;
            zn = n1;
            zd = d1;
        }
        // backward: the top is the nearest parabola at x once the one under
        // it is worse there
        for (int x = h - 1; x >= 0; --x) {
            float d = p.far;
            if (k >= 0) {
                int ft = (x - vt) * (x - vt) + Ht - vt * vt;
                while (k >= 1) {
                    const int fs = (x - vs) * (x - vs) + Hs - vs * vs;
                    if (fs > ft) break;
                    --k;
                    vt = vs;
                    Ht = Hs;
                    ft = fs;
                    if (k >= 1) {
                        vs = st[(long long)(k - 1) * sst];
                        Hs = H(vs);
                    }
                }
                d = sqrtf((float)ft) * res;
            }
            dist[(long long)x * w + j] = d;
        }
    }

    __syncthreads();

    // the gradient: central differences, one-sided at the borders, zero on
    // the FAR plateau; dist read back (the block's own writes, L2-hot). Four
    // cells of a row a thread, in 16-byte loads and stores, where the rows
    // are 16-byte aligned.
    auto gx_of = [&](float left, float right, bool border) {
        return quotient(right - left, border ? res : two_r);
    };
    if (w % 4 == 0 && (reinterpret_cast<uintptr_t>(b.dist) | reinterpret_cast<uintptr_t>(b.grad)) %
                          16 == 0) {
        const int w4 = w / 4;
        for (long long q = tid; q < hw / 4; q += THREADS) {
            const int i = (int)(q / w4), j = 4 * (int)(q - (long long)i * w4);
            const float* d = dist + (long long)i * w;
            const float4 c = *reinterpret_cast<const float4*>(d + j);
            const float4 u = i == 0 ? c : *reinterpret_cast<const float4*>(d - w + j);
            const float4 n = i == h - 1 ? c : *reinterpret_cast<const float4*>(d + w + j);
            const float dl = j == 0 ? c.x : d[j - 1], dr = j + 4 == w ? c.w : d[j + 4];
            const bool row_border = i == 0 || i == h - 1;
            const float cv[4] = {c.x, c.y, c.z, c.w}, uv[4] = {u.x, u.y, u.z, u.w},
                        nv[4] = {n.x, n.y, n.z, n.w};
            float g[8];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float l = e == 0 ? dl : cv[e - 1], r = e == 3 ? dr : cv[e + 1];
                const bool col_border = (e == 0 && j == 0) || (e == 3 && j + 4 == w);
                const bool far = cv[e] >= p.far;
                g[2 * e] = far ? 0.0f : gx_of(l, r, col_border);
                g[2 * e + 1] = far ? 0.0f : quotient(nv[e] - uv[e], row_border ? res : two_r);
            }
            float4* out = reinterpret_cast<float4*>(grad + 2 * (4 * q));
            out[0] = make_float4(g[0], g[1], g[2], g[3]);
            out[1] = make_float4(g[4], g[5], g[6], g[7]);
        }
    } else {
        int i = tid / w, j = tid - (tid / w) * w;
        for (long long c = tid; c < hw; c += THREADS) {
            // the neighbours before and after, the cell itself at a border
            const float* d = dist + (long long)i * w;
            const int left = j == 0 ? j : j - 1, right = j == w - 1 ? j : j + 1;
            const float* up = i == 0 ? d : d - w;
            const float* down = i == h - 1 ? d : d + w;
            const float gx = gx_of(d[left], d[right], right - left != 2);
            const float gy = quotient(down[j] - up[j], i == 0 || i == h - 1 ? res : two_r);
            reinterpret_cast<float2*>(grad)[c] =
                d[j] >= p.far ? float2{0.0f, 0.0f} : float2{gx, gy};
            for (j += THREADS; j >= w; j -= w) ++i;
        }
    }
}

// Bytes of shared memory a block needs for (h, w) maps and an nsx x nsy mask
// (0 x 0 without): with the plane and stack when `plane_shared` (their bytes
// are also what a map takes of the global form's workspace).
extern "C" long long edt_smem_bytes(int h, int w, int nsx, int nsy, int plane_shared) {
    const long long plane = max(h, w) <= SMALL ? plane_bytes<uint8_t>(h, w)
                                               : plane_bytes<uint16_t>(h, w);
    return table_bytes(h, nsx, nsy) + (plane_shared ? plane : 0);
}

template <class T>
static cudaError_t launch_typed(const EdtParams& cp, const EdtBuffers& cb, size_t smem,
                                cudaStream_t st) {
    EdtParams p = cp;
    EdtBuffers b = cb;
    const dim3 grid(p.S), block(THREADS);
    const bool mask = p.nsx > 0;
    if (p.plane_global)
        return mask ? launch_kernel(edt_kernel<T, true, true>, grid, block, smem, st, p, b)
                    : launch_kernel(edt_kernel<T, true, false>, grid, block, smem, st, p, b);
    return mask ? launch_kernel(edt_kernel<T, false, true>, grid, block, smem, st, p, b)
                : launch_kernel(edt_kernel<T, false, false>, grid, block, smem, st, p, b);
}

// Launch the world rebuild of p->S maps on `stream` (the free mask where
// p->nsx, p->nsy > 0); returns the CUDA error code (0 on success). Does not
// synchronize.
extern "C" int edt_field(const EdtParams* params, const EdtBuffers* buffers, void* stream) {
    EdtParams p = *params;
    const EdtBuffers& b = *buffers;
    if (p.S <= 0) return 0;
    if (p.nsx <= 0 || p.nsy <= 0) p.nsx = p.nsy = 0;
    const bool mask = p.nsx > 0;
    if (p.h < 2 || p.w < 2 || p.h >= 32768 || p.w >= 32768 ||
        (mask && (b.free == nullptr || b.fx == nullptr || b.fy == nullptr)))
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)edt_smem_bytes(p.h, p.w, p.nsx, p.nsy, !p.plane_global);
    if (smem > (size_t)max_dynamic_smem() || (p.plane_global && b.work == nullptr))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const cudaError_t e = max(p.h, p.w) <= SMALL ? launch_typed<uint8_t>(p, b, smem, st)
                                                 : launch_typed<uint16_t>(p, b, smem, st);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

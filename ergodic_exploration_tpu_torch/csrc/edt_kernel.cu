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
// What the design does about it, for maps whose plane fits a block's
// shared memory (up to 512 x 512 with the mask): one block per map (256
// threads), every pass O(h w) whatever the map. The block reads the map once,
// all threads on consecutive cells, 16 bytes a thread, into a plane of 8-bit
// markers in shared memory (16-bit past 254 cells a side): 0 occupied, NONE
// free, HELD neither (NaN); with the mask it also maps each lattice column
// and row to its map column and row once (nsx + nsy points, not nsx nsy).
// Rows: each row is cut into as many segments as the block has threads for
// (2 at 100 x 100); a segment's thread notes its first and last occupied
// column, then sweeps the segment left and right in place with the carries
// from the other segments: the plane holds each cell's distance along its
// row. Columns: a thread per column (the first warps of the block) builds the
// exact lower envelope of the parabolas (x - v)^2 + g(v)^2 of the rows v with
// an occupied cell (Felzenszwalb and Huttenlocher's, its intersections
// compared as exact integer fractions, no float boundary), its stack of row
// indices in shared memory beside the plane, then walks the column
// backwards, popping a parabola as soon as the one under it is no worse, and
// writes dist: neighbouring threads on neighbouring columns, so each step's
// stores are coalesced. The free mask is read from the markers at the nsx
// nsy lattice cells, between the load and the row sweeps that overwrite
// them. After the barrier the gradient reads dist back (the block's own
// writes, L2-hot), four cells of a row a thread in 16-byte loads and stores;
// a zero difference skips the IEEE division, whose slow path zeros take.
// Shared memory with the mask: 24 KB at 100 x 100 (eight blocks an SM), 86
// KB at 200 x 200.
//
// Past 227 KB of plane (the many-block form: 1400 x 1400 and gmapping's
// 4000 x 4000 maps, or wherever the wrapper's limit sends a map) one block a
// map would run on S of the 132 SMs and walk whole rows of a plane in device
// memory, neighbouring threads 8 KB apart. There the same two exact passes
// run as three kernels over many blocks a map, launched one after another on
// the stream (no grid-wide barrier), the plane (T) and the stacks (packed
// row and row distance, 32 bits an entry) in a workspace the wrapper
// allocates, nothing in shared memory:
//   edt_rows     a warp per map row (8 a block): the row's distances in two
//                sweeps of chunks of 512 cells, 16 consecutive cells a lane
//                (16-byte stores of the plane), the nearest occupied column
//                to the left by a warp prefix maximum carried from chunk to
//                chunk, then to the right by a suffix minimum, the plane's
//                row written and read back by the same lanes;
//   edt_columns  a warp per 32 columns of a map: the envelope pass above, a
//                thread a column, its stack entries interleaved by column
//                (lanes at one depth share a line), the plane's rows loaded
//                eight ahead of the envelope, dist stored coalesced;
//   edt_finish   every cell's gradient (the code above, a grid-stride loop
//                over the map) and the free mask from the data at the lattice
//                cells.
// The integers are those of the one-block form (each row distance and each
// stack entry under 2^15, every square and sum of two squares under 2^31,
// the intersections compared in 64 bits), so both forms give the same bits.
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
constexpr int ROW_WARPS = THREADS / 32;  // map rows a block of edt_rows
constexpr int ROW_CELLS = 16;            // consecutive cells a lane of edt_rows takes a chunk
constexpr int AHEAD = 8;                 // plane rows edt_columns loads ahead of its envelope
constexpr int SMS = 132;                 // an H100's SMs: edt_finish takes about 8 blocks each

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
    int many_blocks;   // the many-block form: the planes and stacks in the workspace
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
    unsigned char* work;       // (S, edt_work_bytes) in the many-block form
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

// Bytes of the plane and the stack in shared memory (the one-block form).
template <class T>
__host__ __device__ inline long long plane_bytes(int h, int w) {
    return (long long)sizeof(T) * h * (plane_stride<T>(w) + stack_stride<T>(w));
}

// Row stride of a plane in the many-block form's workspace: a multiple of 16
// cells, so that its rows and each lane's run of edt_rows are 16-byte aligned.
__host__ __device__ inline int work_stride(int w) {
    return (w + ROW_CELLS - 1) / ROW_CELLS * ROW_CELLS;
}

// Bytes of a map's plane in the many-block form's workspace, a multiple of
// 16; its stacks (h w entries of 32 bits, interleaved by column) follow.
template <class T>
__host__ __device__ inline long long work_plane_bytes(int h, int w) {
    return (long long)sizeof(T) * h * work_stride(w);
}

// Bytes of workspace a map takes in the many-block form: its plane, then its
// stacks (h w entries of 32 bits), a multiple of 16.
template <class T>
__host__ __device__ inline long long edt_work_bytes_of(int h, int w) {
    return (work_plane_bytes<T>(h, w) + 4LL * h * w + 15) / 16 * 16;
}

// A rounded lattice coordinate clamped to [0, n - 1] (NaN to 0, as the plain
// version's int64 conversion and clamp give).
__device__ __forceinline__ int clamp_index(float r, int n) {
    return !(r >= 0.0f) ? 0 : r >= (float)(n - 1) ? n - 1 : (int)r;
}

// The map cell (along one axis of n cells) of the lattice point origin + f
// lengths: (p - map origin) / res - 0.5, rounded half-even and clamped.
__device__ __forceinline__ int lattice_cell(float origin, float f, float length, float map_origin,
                                            float res, int n) {
    return clamp_index(rintf((origin + f * length - map_origin) / res - 0.5f), n);
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

// The gradient of map s's dist: central differences, one-sided at the
// borders, zero on the FAR plateau. Four cells of a row a thread, in 16-byte
// loads and stores, where the rows are 16-byte aligned. The block's threads
// take the map's cells (or groups of four) in turn; with GRID the grid's
// blocks of map s take them together.
template <bool GRID>
__device__ __forceinline__ void gradient(const EdtParams& p, const EdtBuffers& b, int s) {
    const int h = p.h, w = p.w, tid = threadIdx.x;
    const long long hw = (long long)h * w;
    const long long first = GRID ? (long long)blockIdx.x * THREADS + tid : tid;
    const long long step = GRID ? (long long)gridDim.x * THREADS : THREADS;
    const float* dist = b.dist + s * hw;
    float* grad = b.grad + 2 * s * hw;
    const float res = b.res[s], two_r = 2.0f * res;
    auto gx_of = [&](float left, float right, bool border) {
        return quotient(right - left, border ? res : two_r);
    };
    if (w % 4 == 0 && (reinterpret_cast<uintptr_t>(b.dist) | reinterpret_cast<uintptr_t>(b.grad)) %
                          16 == 0) {
        const int w4 = w / 4;
        for (long long q = first; q < hw / 4; q += step) {
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
        int i = (int)(first / w), j = (int)(first - (long long)(first / w) * w);
        for (long long c = first; c < hw; c += step) {
            // the neighbours before and after, the cell itself at a border
            const float* d = dist + (long long)i * w;
            const int left = j == 0 ? j : j - 1, right = j == w - 1 ? j : j + 1;
            const float* up = i == 0 ? d : d - w;
            const float* down = i == h - 1 ? d : d + w;
            const float gx = gx_of(d[left], d[right], right - left != 2);
            const float gy = quotient(down[j] - up[j], i == 0 || i == h - 1 ? res : two_r);
            reinterpret_cast<float2*>(grad)[c] =
                d[j] >= p.far ? float2{0.0f, 0.0f} : float2{gx, gy};
            for (j += (int)step; j >= w; j -= w) ++i;
        }
    }
}

}  // namespace edtk

using namespace edtk;

// ---------------------------------------------------------------------------
// the one-block form: a block a map, the plane in shared memory
// ---------------------------------------------------------------------------

template <class T, bool MASK>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) edt_kernel(EdtParams p, EdtBuffers b) {
    extern __shared__ __align__(16) unsigned char smem[];
    constexpr int NONE = Mark<T>::NONE, HELD = Mark<T>::HELD;
    const int s = blockIdx.x, tid = threadIdx.x;
    const int h = p.h, w = p.w, ws = plane_stride<T>(w), nsx = MASK ? p.nsx : 0,
              nsy = MASK ? p.nsy : 0, groups = column_groups(w);
    const long long hw = (long long)h * w;
    const float* data = b.data + s * hw;
    float* dist = b.dist + s * hw;
    const float res = b.res[s];
    int* col_of = reinterpret_cast<int*>(smem);  // lattice column ix -> map column
    int* row_of = col_of + nsx;                    // lattice row iy -> map row
    const int nseg = row_segments(h), seg_len = (w + nseg - 1) / nseg;
    int16_t* seg_first = reinterpret_cast<int16_t*>(row_of + nsy);
    int16_t* seg_last = seg_first + nseg * h;
    T* plane = reinterpret_cast<T*>(seg_last + nseg * h);
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
    // the free mask's cell of each lattice column and row
    if (MASK) {
        const float dox = b.dom_origin[2 * s], doy = b.dom_origin[2 * s + 1];
        const float dlx = b.dom_lengths[2 * s], dly = b.dom_lengths[2 * s + 1];
        const float mox = b.map_origin[2 * s], moy = b.map_origin[2 * s + 1];
        for (int k = tid; k < nsx; k += THREADS)
            col_of[k] = lattice_cell(dox, b.fx[k], dlx, mox, res, w);
        for (int k = tid; k < nsy; k += THREADS)
            row_of[k] = lattice_cell(doy, b.fy[k], dly, moy, res, h);
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
    // the gradient, dist read back (the block's own writes, L2-hot)
    gradient<false>(p, b, s);
}

// ---------------------------------------------------------------------------
// the many-block form: three kernels over many blocks a map, the plane and
// the stacks in the workspace
// ---------------------------------------------------------------------------

// grid (ceil(h / ROW_WARPS), S): each map row's distances along the row into
// the plane, a warp a row, a lane ROW_CELLS consecutive cells of a chunk
template <class T>
__global__ void __launch_bounds__(THREADS) edt_rows(EdtParams p, EdtBuffers b) {
    constexpr int NONE = Mark<T>::NONE, PER = 4 / (int)sizeof(T), WORDS = ROW_CELLS / PER;
    const int s = blockIdx.y, lane = threadIdx.x & 31;
    const int i = blockIdx.x * ROW_WARPS + (threadIdx.x >> 5);
    if (i >= p.h) return;  // a whole warp: no shuffle below is left short
    const int w = p.w;
    const float* row = b.data + ((long long)s * p.h + i) * w;
    T* plane = reinterpret_cast<T*>(b.work + s * edt_work_bytes_of<T>(p.h, w)) +
               (long long)i * work_stride(w);
    // a lane's cells [j0, j0 + ROW_CELLS) of the plane row, in 16-byte
    // stores and loads where the chunk is whole (rows and lanes' runs are
    // 16-byte aligned), else cell by cell
    auto put = [&](int j0, const int (&g)[ROW_CELLS]) {
        if (j0 + ROW_CELLS <= w) {
            uint32_t wd[WORDS];
#pragma unroll
            for (int k = 0; k < WORDS; ++k) {
                wd[k] = 0u;
#pragma unroll
                for (int q = 0; q < PER; ++q)
                    wd[k] |= (uint32_t)(T)g[k * PER + q] << (8 * (int)sizeof(T) * q);
            }
            uint4* dst = reinterpret_cast<uint4*>(plane + j0);
#pragma unroll
            for (int k = 0; k < WORDS / 4; ++k)
                dst[k] = make_uint4(wd[4 * k], wd[4 * k + 1], wd[4 * k + 2], wd[4 * k + 3]);
        } else {
            for (int e = 0; e < ROW_CELLS && j0 + e < w; ++e) plane[j0 + e] = (T)g[e];
        }
    };
    auto get = [&](int j0, int (&g)[ROW_CELLS]) {
        if (j0 + ROW_CELLS <= w) {
            const uint4* src = reinterpret_cast<const uint4*>(plane + j0);
#pragma unroll
            for (int k = 0; k < WORDS / 4; ++k) {
                const uint4 v = src[k];
                const uint32_t wd[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int m = 0; m < 4; ++m)
#pragma unroll
                    for (int q = 0; q < PER; ++q)
                        g[(4 * k + m) * PER + q] =
                            (int)(T)(wd[m] >> (8 * (int)sizeof(T) * q));
            }
        } else {
#pragma unroll
            for (int e = 0; e < ROW_CELLS; ++e) g[e] = j0 + e < w ? (int)plane[j0 + e] : NONE;
        }
    };
    // left to right: j minus the nearest occupied column at or before j, the
    // lanes' last occupied columns combined by a warp prefix maximum and
    // carried from chunk to chunk
    int last = -1;
    for (int c0 = 0; c0 < w; c0 += 32 * ROW_CELLS) {
        const int j0 = c0 + lane * ROW_CELLS;
        bool occ[ROW_CELLS];
        int mine = -1;
#pragma unroll
        for (int e = 0; e < ROW_CELLS; ++e) {
            occ[e] = j0 + e < w && row[j0 + e] >= p.thr;
            if (occ[e]) mine = j0 + e;
        }
        int incl = mine;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl = max(incl, v);
        }
        const int before = __shfl_up_sync(0xffffffffu, incl, 1);
        int L = max(last, lane > 0 ? before : -1);
        last = max(last, __shfl_sync(0xffffffffu, incl, 31));
        int g[ROW_CELLS];
#pragma unroll
        for (int e = 0; e < ROW_CELLS; ++e) {
            if (occ[e]) L = j0 + e;
            g[e] = L >= 0 ? j0 + e - L : NONE;
        }
        put(j0, g);
    }
    // right to left: the nearest occupied column at or after j, where nearer
    // (each lane reads back the cells it wrote: 0 exactly where occupied)
    int next = INT32_MAX;
    for (int c0 = (w - 1) / (32 * ROW_CELLS) * (32 * ROW_CELLS); c0 >= 0; c0 -= 32 * ROW_CELLS) {
        const int j0 = c0 + lane * ROW_CELLS;
        int g[ROW_CELLS];
        get(j0, g);
        int mine = INT32_MAX;
#pragma unroll
        for (int e = ROW_CELLS - 1; e >= 0; --e)
            if (g[e] == 0) mine = j0 + e;
        int incl = mine;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_down_sync(0xffffffffu, incl, o);
            if (lane + o < 32) incl = min(incl, v);
        }
        const int after = __shfl_down_sync(0xffffffffu, incl, 1);
        int R = min(next, lane < 31 ? after : INT32_MAX);
        next = min(next, __shfl_sync(0xffffffffu, incl, 0));
        bool moved = false;
#pragma unroll
        for (int e = ROW_CELLS - 1; e >= 0; --e) {
            if (g[e] == 0) R = j0 + e;
            if (R != INT32_MAX && R - (j0 + e) < g[e]) {
                g[e] = R - (j0 + e);
                moved = true;
            }
        }
        if (moved) put(j0, g);
    }
}

// grid (column_groups(w), S), a warp a block: the lower envelope down each
// column (the one-block form's column pass), its stack in the workspace
template <class T>
__global__ void __launch_bounds__(32) edt_columns(EdtParams p, EdtBuffers b) {
    constexpr int NONE = Mark<T>::NONE;
    const int s = blockIdx.y, j = blockIdx.x * 32 + threadIdx.x;
    const int h = p.h, w = p.w, ws = work_stride(w);
    if (j >= w) return;
    const long long pb = edt_work_bytes_of<T>(h, w);
    unsigned char* base = b.work + s * pb;
    const T* col = reinterpret_cast<const T*>(base) + j;
    uint32_t* st = reinterpret_cast<uint32_t*>(base + work_plane_bytes<T>(h, w)) + j;
    float* dist = b.dist + (long long)s * h * w + j;
    const float res = b.res[s];
    // an entry: the row v in the high half, its distance g along the row in the low
    auto pack = [](int v, int g) { return ((uint32_t)v << 16) | (uint32_t)g; };
    // the top (vt, gt, Ht = gt^2 + vt^2) and the one under it (vs, gs, Hs) in
    // registers, the top's left boundary zn / zd (none at k = 0)
    int k = -1, vt = 0, gt = 0, Ht = 0, vs = 0, gs = 0, Hs = 0, zn = 0, zd = 1;
    auto pop = [&]() {
        --k;
        vt = vs;
        gt = gs;
        Ht = Hs;
        if (k >= 1) {
            const uint32_t e = st[(long long)(k - 1) * w];
            vs = (int)(e >> 16);
            gs = (int)(e & 0xffffu);
            Hs = gs * gs + vs * vs;
        }
    };
    // forward: the envelope of the rows with an occupied cell
    for (int x0 = 0; x0 < h; x0 += AHEAD) {
        int gv[AHEAD];
#pragma unroll
        for (int e = 0; e < AHEAD; ++e)
            gv[e] = x0 + e < h ? (int)col[(long long)(x0 + e) * ws] : NONE;
#pragma unroll
        for (int e = 0; e < AHEAD; ++e) {
            const int x = x0 + e, g = gv[e];
            if (g == NONE) continue;
            const int Hx = g * g + x * x;
            int n1 = 0, d1 = 1;
            while (k >= 0) {
                n1 = Hx - Ht;
                d1 = 2 * (x - vt);
                if (k == 0 || (long long)n1 * zd > (long long)zn * d1) break;
                pop();
                if (k >= 1) {
                    zn = Ht - Hs;
                    zd = 2 * (vt - vs);
                }
            }
            ++k;
            st[(long long)k * w] = pack(x, g);
            vs = vt;
            gs = gt;
            Hs = Ht;
            vt = x;
            gt = g;
            Ht = Hx;
            zn = n1;
            zd = d1;
        }
    }
    // backward: the top is the nearest parabola at x once the one under it
    // is worse there; d2 = (x - v)^2 + g^2, each term under 2^30
    for (int x = h - 1; x >= 0; --x) {
        float d = p.far;
        if (k >= 0) {
            int ft = (x - vt) * (x - vt) + gt * gt;
            while (k >= 1) {
                const int fs = (x - vs) * (x - vs) + gs * gs;
                if (fs > ft) break;
                ft = fs;
                pop();
            }
            d = sqrtf((float)ft) * res;
        }
        dist[(long long)x * w] = d;
    }
}

// grid (blocks a map, S): the gradient of every cell and, with the mask,
// the free mask from the data at the lattice cells (data < thr: a NaN cell
// is not free)
template <bool MASK>
__global__ void __launch_bounds__(THREADS) edt_finish(EdtParams p, EdtBuffers b) {
    const int s = blockIdx.y;
    gradient<true>(p, b, s);
    if (MASK) {
        const long long first = (long long)blockIdx.x * THREADS + threadIdx.x,
                        step = (long long)gridDim.x * THREADS;
        const int nsx = p.nsx, nsy = p.nsy, h = p.h, w = p.w;
        const float res = b.res[s];
        const float dox = b.dom_origin[2 * s], doy = b.dom_origin[2 * s + 1];
        const float dlx = b.dom_lengths[2 * s], dly = b.dom_lengths[2 * s + 1];
        const float mox = b.map_origin[2 * s], moy = b.map_origin[2 * s + 1];
        const float* data = b.data + (long long)s * h * w;
        float* fr = b.free + (long long)s * nsx * nsy;
        for (long long n = first; n < (long long)nsx * nsy; n += step) {
            const int ix = (int)(n / nsy), iy = (int)(n - (long long)ix * nsy);
            const int j = lattice_cell(dox, b.fx[ix], dlx, mox, res, w);
            const int i = lattice_cell(doy, b.fy[iy], dly, moy, res, h);
            fr[n] = data[(long long)i * w + j] < p.thr ? 1.0f : 0.0f;
        }
    }
}

// Bytes of shared memory a block of the one-block form needs for (h, w) maps
// and an nsx x nsy mask (0 x 0 without), with the plane and stack when
// `plane_shared`; the many-block form (`plane_shared` 0) takes none.
extern "C" long long edt_smem_bytes(int h, int w, int nsx, int nsy, int plane_shared) {
    if (!plane_shared) return 0;
    const long long plane = max(h, w) <= SMALL ? plane_bytes<uint8_t>(h, w)
                                               : plane_bytes<uint16_t>(h, w);
    return table_bytes(h, nsx, nsy) + plane;
}

// Bytes of workspace a map takes in the many-block form: its plane and its
// stacks.
extern "C" long long edt_work_bytes(int h, int w) {
    return max(h, w) <= SMALL ? edt_work_bytes_of<uint8_t>(h, w)
                              : edt_work_bytes_of<uint16_t>(h, w);
}

template <class T>
static cudaError_t launch_typed(const EdtParams& cp, const EdtBuffers& cb, size_t smem,
                                cudaStream_t st) {
    EdtParams p = cp;
    EdtBuffers b = cb;
    const bool mask = p.nsx > 0;
    if (!p.many_blocks)
        return mask ? launch_kernel(edt_kernel<T, true>, dim3(p.S), dim3(THREADS), smem, st, p, b)
                    : launch_kernel(edt_kernel<T, false>, dim3(p.S), dim3(THREADS), smem, st, p,
                                    b);
    cudaError_t e = launch_kernel(edt_rows<T>, dim3((p.h + ROW_WARPS - 1) / ROW_WARPS, p.S),
                                  dim3(THREADS), 0, st, p, b);
    if (e == cudaSuccess)
        e = launch_kernel(edt_columns<T>, dim3(column_groups(p.w), p.S), dim3(32), 0, st, p, b);
    if (e != cudaSuccess) return e;
    // enough blocks a map for about eight an SM in all, each thread at least
    // 64 cells
    const long long cells = (long long)p.h * p.w;
    const int per_map = (int)max(1LL, min((8LL * SMS + p.S - 1) / p.S, cells / (64 * THREADS)));
    const dim3 grid(per_map, p.S);
    return mask ? launch_kernel(edt_finish<true>, grid, dim3(THREADS), 0, st, p, b)
                : launch_kernel(edt_finish<false>, grid, dim3(THREADS), 0, st, p, b);
}

// Launch the world rebuild of p->S maps on `stream` (the free mask where
// p->nsx, p->nsy > 0): one kernel in the one-block form, three in the
// many-block form (p->many_blocks); returns the CUDA error code (0 on
// success). Does not synchronize.
extern "C" int edt_field(const EdtParams* params, const EdtBuffers* buffers, void* stream) {
    EdtParams p = *params;
    const EdtBuffers& b = *buffers;
    if (p.S <= 0) return 0;
    if (p.nsx <= 0 || p.nsy <= 0) p.nsx = p.nsy = 0;
    const bool mask = p.nsx > 0;
    if (p.h < 2 || p.w < 2 || p.h >= 32768 || p.w >= 32768 ||
        (p.many_blocks && p.S > 65535) ||
        (mask && (b.free == nullptr || b.fx == nullptr || b.fy == nullptr)))
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)edt_smem_bytes(p.h, p.w, p.nsx, p.nsy, !p.many_blocks);
    if (smem > (size_t)max_dynamic_smem() || (p.many_blocks && b.work == nullptr))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const cudaError_t e = max(p.h, p.w) <= SMALL ? launch_typed<uint8_t>(p, b, smem, st)
                                                 : launch_typed<uint16_t>(p, b, smem, st);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

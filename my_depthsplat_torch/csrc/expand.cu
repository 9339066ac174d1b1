// Duplicate-with-keys: one (tile, gaussian) instance per tile a gaussian
// really reaches, with its sort key and the gaussian's index.
//
// Replaces the TPU kernel my_depthsplat_tpu/render/expand.py:_expand_kernel
// (:70, launched by expand_keys :130). That kernel expanded each depth-sorted
// slot over a capped, tiered set of candidate tiles into int32 keys padded
// to (8, 512) register tiles. Here allocation is dynamic: a count pass gives
// each gaussian's surviving tile count, the caller takes an exclusive
// prefix sum (torch.cumsum), and a write pass emits the keys and the
// gaussian's flat index for every surviving (gaussian, tile) pair, in
// gaussian-major, rect row-major order (expand_plain's order), so gaussian
// i's instances are the contiguous range [offset[i], offset[i] + counts[i]).
// Two key formats:
//   - 64-bit, any batch of views: ((view * n_tiles + tile) << 32) | slot,
//     `slot` the gaussian's rank in the stable depth sort over the flat
//     b * G + g index; one sort yields tile-major runs in depth order;
//   - tile only, int16 or int32 (the wrapper's shape rule): one view whose
//     gaussians arrive in depth-rank order (a depth group). Emission order
//     within every tile is then already rank order, so a stable sort on the
//     tile index gives the permutation the 64-bit sort gives, with 2 or 4
//     bytes written per key instead of 8 and fewer radix passes.
//
// Cull: a candidate tile is dropped when the conic's quadratic form stays
// above 2 ln(opacity / ALPHA_MIN) + 1e-3 over the whole tile rect (the
// composite's alpha >= 1/255 gate would zero it); a conic that is not
// positive definite is never culled (expand.py:43-67, 94-121). The float
// arithmetic is written in the same order as expand_plain and compiled with
// -fmad=false, so the instance set matches the plain version bit for bit.
//
// Bound on the H100: bytes. Each gaussian reads 41 bytes of cull fields and
// writes its 4-byte count (count pass); each instance writes its key (8, 4
// or 2 bytes) and 4-byte id (write pass). The cull is ~60 float operations
// per candidate tile (4 of them IEEE divisions), below the memory time only
// if little else is done per candidate and the stores are coalesced.
//
// Design. Both passes walk a gaussian's rect row-major with the two edge
// quotients of each row (qy0, qy1) computed once per row, not per tile.
// - Count pass: one thread per gaussian, its fields in registers, no
//   shared memory: the cheapest walk per candidate. A walk that spread the
//   candidates evenly over the threads paid more in owner search and set-up
//   per candidate than the uneven rect sizes cost this one (PERF.md).
// - Write pass: a block takes THREADS consecutive gaussians, loads their
//   fields into shared memory and scans their rect areas. A sparse block
//   (fewer than DENSE candidates per gaussian) writes as the count pass
//   walks: a gaussian's few stores land near its neighbours'. A dense
//   block spreads its candidates over its threads, K consecutive ones
//   each (one binary search of the scanned areas finds the owner of a
//   thread's first candidate, then the thread steps on), places a chunk's
//   survivors by a block-wide scan of the threads' survivor counts, stages
//   them in shared memory and stores them as one contiguous run: one thread
//   per gaussian scattered each lane's stores over its own range of tens
//   of instances, which is what made the write pass slow.
// No tensor cores, no TMA: integer and float work over an indirect
// expansion.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr int THREADS = 256;  // gaussians per block
constexpr int WARPS = THREADS / 32;
constexpr int K = 4;          // consecutive candidate tiles per thread (dense write)
constexpr int CHUNK = K * THREADS;
constexpr int DENSE = 6;      // candidates per gaussian from which a block writes balanced
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float quad(float ca, float cb, float cc, float xe, float ye) {
    return ca * xe * xe + 2.0f * cb * xe * ye + cc * ye * ye;
}

__device__ __forceinline__ float clip(float v, float lo, float hi) {
    return fminf(fmaxf(v, lo), hi);
}

// One gaussian's cull (render/expand.py:rect_quadratic_min and _cull_setup):
// the float operations of expand_plain in its order.
struct Cull {
    float xs, ys, ca, cb, cc, ca_s, cc_s, thr;
    int rx, ry, x_end, y_end;  // tile rect [rx, x_end) x [ry, y_end)
    bool pd;

    __device__ __forceinline__ void load(int i, const float* xy, const float* conic,
                                         const float* opacity, const int* rect) {
        const int4 r = reinterpret_cast<const int4*>(rect)[i];
        const float2 p = reinterpret_cast<const float2*>(xy)[i];
        xs = p.x;
        ys = p.y;
        ca = conic[3 * i + 0];
        cb = conic[3 * i + 1];
        cc = conic[3 * i + 2];
        ca_s = ca > 0.0f ? ca : 1.0f;
        cc_s = cc > 0.0f ? cc : 1.0f;
        pd = (ca > 0.0f) && (cc > 0.0f) && (ca * cc - cb * cb > 0.0f);
        thr = 2.0f * logf(fmaxf(opacity[i], 1e-12f) / ALPHA_MIN) + 1e-3f;
        rx = r.x;
        ry = r.y;
        x_end = r.z;
        y_end = r.w;
    }
};

// A row ty of the rect: its edges and their unclamped minimizers.
struct Row {
    float y0, y1, qy0, qy1;

    __device__ __forceinline__ Row(const Cull& c, int ty) {
        y0 = (float)(ty * TILE) - c.ys;
        y1 = y0 + (float)(TILE - 1);
        qy0 = -c.cb * y0 / c.ca_s;
        qy1 = -c.cb * y1 / c.ca_s;
    }
};

// Tile (tx, row) survives the cull: the min of the conic's quadratic form
// over the tile rect, 0 if the rect holds the centre, else the min over its
// four edges, each a clamped 1-D quadratic, is at most thr; a conic that is
// not positive definite is never culled.
__device__ __forceinline__ bool survives(const Cull& c, const Row& r, int tx) {
    if (!c.pd) return true;
    const float x0 = (float)(tx * TILE) - c.xs;
    const float x1 = x0 + (float)(TILE - 1);
    const bool inside = (x0 <= 0.0f) && (x1 >= 0.0f) && (r.y0 <= 0.0f) && (r.y1 >= 0.0f);
    const float ex0 = quad(c.ca, c.cb, c.cc, x0, clip(-c.cb * x0 / c.cc_s, r.y0, r.y1));
    const float ex1 = quad(c.ca, c.cb, c.cc, x1, clip(-c.cb * x1 / c.cc_s, r.y0, r.y1));
    const float ey0 = quad(c.ca, c.cb, c.cc, clip(r.qy0, x0, x1), r.y0);
    const float ey1 = quad(c.ca, c.cb, c.cc, clip(r.qy1, x0, x1), r.y1);
    const float q = fminf(fminf(ex0, ex1), fminf(ey0, ey1));
    return (inside ? 0.0f : q) <= c.thr;
}

// Calls emit(tile) for each surviving tile of c's rect, row-major. The
// inner loop stays rolled: unrolled, the count pass needs 50 registers
// instead of 40 and ran slower at small rects.
template <typename F>
__device__ __forceinline__ void walk_rect(const Cull& c, int grid_x, F emit) {
    for (int ty = c.ry; ty < c.y_end; ++ty) {
        const Row r(c, ty);
#pragma unroll 1
        for (int tx = c.rx; tx < c.x_end; ++tx) {
            if (survives(c, r, tx)) emit(ty * grid_x + tx);
        }
    }
}

__global__ void __launch_bounds__(THREADS) count_kernel(
    const float* __restrict__ xy, const float* __restrict__ conic,
    const float* __restrict__ opacity, const int* __restrict__ rect,
    const uint8_t* __restrict__ valid, int n, int grid_x, int* __restrict__ counts) {
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    int count = 0;
    if (valid[i]) {
        Cull c;
        c.load(i, xy, conic, opacity, rect);
        walk_rect(c, grid_x, [&](int) { ++count; });
    }
    counts[i] = count;
}

// What a write block keeps of each of its gaussians.
struct Block {
    Cull cull[THREADS];
    int end[THREADS];        // inclusive prefix of the rect areas (0 if invalid)
    int64_t kbase[THREADS];  // (view * n_tiles) << 32 | slot (64-bit keys)
    int warp_sum[WARPS];
};

// A chunk's survivors, staged for coalesced stores.
template <typename KEY>
struct Stage {
    KEY key[CHUNK];
    int gid[CHUNK];
};

// Inclusive block-wide prefix sum of v; every thread gets the block's total.
__device__ __forceinline__ int block_scan(int v, int* warp_sum, int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(FULL, v, d);
        if (lane >= d) v += u;
    }
    if (lane == 31) warp_sum[warp] = v;
    __syncthreads();
    int before = 0, all = 0;
    for (int k = 0; k < WARPS; ++k) {
        const int s = warp_sum[k];
        before += k < warp ? s : 0;
        all += s;
    }
    __syncthreads();  // warp_sum is reused by the next scan
    *total = all;
    return v + before;
}

// KEY: int64_t (64-bit keys ((view * n_tiles + tile) << 32) | slot), int32_t
// or int16_t (the tile index of one view in rank order).
template <typename KEY>
__global__ void __launch_bounds__(THREADS) write_kernel(
    const float* __restrict__ xy, const float* __restrict__ conic,
    const float* __restrict__ opacity, const int* __restrict__ rect,
    const uint8_t* __restrict__ valid,
    const int64_t* __restrict__ slot,   // (N,) depth rank (64-bit keys)
    const int64_t* __restrict__ offset, // (N,) exclusive prefix of the counts
    int n, int g_per_view, int grid_x, int n_tiles,
    KEY* __restrict__ keys, int* __restrict__ gid) {
    __shared__ Block s;
    __shared__ Stage<KEY> st;
    const int tid = threadIdx.x;
    const int g0 = blockIdx.x * THREADS;
    const int i = g0 + tid;

    // both paths' output positions, loaded with the fields (one latency)
    const int64_t first = i < n ? offset[i] : 0;
    const int64_t block_first = offset[g0];
    int area = 0;
    Cull c;
    if (i < n && valid[i]) {
        c.load(i, xy, conic, opacity, rect);
        s.cull[tid] = c;
        area = (c.x_end - c.rx) * (c.y_end - c.ry);
        if constexpr (sizeof(KEY) == 8) s.kbase[tid] = (((int64_t)(i / g_per_view) * n_tiles) << 32) | slot[i];
    }
    int total;
    s.end[tid] = block_scan(area, s.warp_sum, &total);
    if (total < DENSE * min(THREADS, n - g0)) {
        // sparse: each thread writes its own gaussian's range
        if (area > 0) {
            int64_t out = first;
            const int64_t kb = sizeof(KEY) == 8 ? s.kbase[tid] : 0;
            walk_rect(c, grid_x, [&](int tile) {
                if constexpr (sizeof(KEY) == 8) {
                    keys[out] = kb + ((int64_t)tile << 32);
                } else {
                    keys[out] = (KEY)tile;
                }
                gid[out] = i;
                ++out;
            });
        }
        return;  // uniform over the block
    }
    __syncthreads();

    int64_t out = block_first;  // the block's next output position
    for (int c0 = 0; c0 < total; c0 += CHUNK) {
        const int j0 = c0 + tid * K;
        const int mine = min(K, total - j0);  // this thread's candidates (<= 0: none)
        unsigned bits = 0;
        int tiles[K], owners[K];
        if (mine > 0) {
            // the owner of j0: the first gaussian whose inclusive end exceeds it
            int lo = 0, hi = THREADS - 1;
            while (lo < hi) {
                const int mid = (lo + hi) >> 1;
                if (s.end[mid] > j0) hi = mid; else lo = mid + 1;
            }
            int g = lo;
            Cull o = s.cull[g];
            const int w = o.x_end - o.rx;
            const int jl = j0 - (g ? s.end[g - 1] : 0);
            const int jdiv = jl / w;
            int ty = o.ry + jdiv, tx = o.rx + (jl - jdiv * w);
            Row r(o, ty);
#pragma unroll
            for (int m = 0; m < K; ++m) {
                if (m < mine) {
                    bits |= (unsigned)survives(o, r, tx) << m;
                    tiles[m] = ty * grid_x + tx;
                    owners[m] = g;
                    if (m + 1 < mine && ++tx == o.x_end) {  // rect row-major, then the next gaussian
                        if (++ty == o.y_end) {
                            do ++g; while (s.end[g] <= j0 + m + 1);  // skip rects of no tile
                            o = s.cull[g];
                            ty = o.ry;
                        }
                        tx = o.rx;
                        r = Row(o, ty);
                    }
                }
            }
        }
        // the chunk's survivors in candidate order: staged, then stored
        int n_chunk;
        int at = block_scan(__popc(bits), s.warp_sum, &n_chunk) - __popc(bits);
#pragma unroll
        for (int m = 0; m < K; ++m) {
            if (bits >> m & 1u) {
                if constexpr (sizeof(KEY) == 8) {
                    st.key[at] = s.kbase[owners[m]] + ((int64_t)tiles[m] << 32);
                } else {
                    st.key[at] = (KEY)tiles[m];
                }
                st.gid[at] = g0 + owners[m];
                ++at;
            }
        }
        __syncthreads();
        for (int k = tid; k < n_chunk; k += THREADS) {
            keys[out + k] = st.key[k];
            gid[out + k] = st.gid[k];
        }
        out += n_chunk;
        __syncthreads();  // the stage is rewritten by the next chunk
    }
}

int blocks(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

extern "C" int expand_count(
    const float* xy, const float* conic, const float* opacity, const int* rect,
    const uint8_t* valid, int n, int g_per_view, int grid_x, int n_tiles,
    int* counts, void* stream) {
    count_kernel<<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
        xy, conic, opacity, rect, valid, n, grid_x, counts);
    return (int)cudaGetLastError();
}

extern "C" int expand_write(
    const float* xy, const float* conic, const float* opacity, const int* rect,
    const uint8_t* valid, const int64_t* slot, const int64_t* offset, int n,
    int g_per_view, int grid_x, int n_tiles, int64_t* keys, int* gid, void* stream) {
    write_kernel<int64_t><<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
        xy, conic, opacity, rect, valid, slot, offset, n, g_per_view, grid_x, n_tiles, keys, gid);
    return (int)cudaGetLastError();
}

// Tile-only keys of one view in depth-rank order: key_bytes 2 (int16) or 4
// (int32), as the wrapper's shape rule chose.
extern "C" int expand_write_tiles(
    const float* xy, const float* conic, const float* opacity, const int* rect,
    const uint8_t* valid, const int64_t* offset, int n, int grid_x, int n_tiles,
    int key_bytes, void* keys, int* gid, void* stream) {
    if (key_bytes == 2) {
        write_kernel<int16_t><<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
            xy, conic, opacity, rect, valid, nullptr, offset, n, n, grid_x, n_tiles, (int16_t*)keys, gid);
    } else if (key_bytes == 4) {
        write_kernel<int32_t><<<blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
            xy, conic, opacity, rect, valid, nullptr, offset, n, n, grid_x, n_tiles, (int32_t*)keys, gid);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

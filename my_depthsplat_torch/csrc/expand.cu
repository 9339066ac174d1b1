// Duplicate-with-keys: one (tile, gaussian) instance per tile a gaussian
// really reaches, with a 64-bit sort key.
//
// Replaces the TPU kernel my_depthsplat_tpu/render/expand.py:_expand_kernel
// (:70, launched by expand_keys :130). That kernel expanded each depth-sorted
// slot over a capped, tiered set of candidate tiles into int32 keys padded
// to (8, 512) register tiles. Here allocation is dynamic: a count pass gives
// each gaussian's surviving tile count, the caller takes an exclusive
// prefix sum (torch.cumsum), and a write pass emits
//     key = ((view * n_tiles + ty * grid_x + tx) << 32) | slot
// and the gaussian's flat index for every surviving (gaussian, tile) pair.
// `slot` is the gaussian's rank in the stable depth sort over the flat
// b * G + g index, so one sort of the keys yields tile-major runs in depth
// order, ties broken exactly as the JAX package breaks them.
//
// Cull: a candidate tile is dropped when the conic's quadratic form stays
// above 2 ln(opacity / ALPHA_MIN) + 1e-3 over the whole tile rect (the
// composite's alpha >= 1/255 gate would zero it); a conic that is not
// positive definite is never culled (expand.py:43-67, 94-121). The float
// arithmetic is written in the same order as expand_plain and compiled with
// -fmad=false, so the instance set matches the plain version bit for bit.
//
// Bound on the H100: bytes. Each gaussian reads 41 bytes of inputs (xy,
// conic, opacity, rect, valid) plus its 8-byte slot and offset in the write
// pass, and each instance writes 12 bytes (key, id); the cull is ~60 float
// operations per candidate tile, far below the memory time. Design: one
// thread per gaussian walks its rect in registers; consecutive threads read
// consecutive gaussians (coalesced loads); writes go to a contiguous range
// per gaussian. Simple before fast: large gaussians serialise their thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr int THREADS = 256;

__device__ __forceinline__ float quad(float ca, float cb, float cc, float xe, float ye) {
    return ca * xe * xe + 2.0f * cb * xe * ye + cc * ye * ye;
}

__device__ __forceinline__ float clip(float v, float lo, float hi) {
    return fminf(fmaxf(v, lo), hi);
}

// Min of q(x, y) = ca x^2 + 2 cb x y + cc y^2 over [x0, x1] x [y0, y1]
// (render/expand.py:rect_quadratic_min).
__device__ __forceinline__ float rect_quadratic_min(
    float ca, float cb, float cc, float x0, float x1, float y0, float y1) {
    const bool inside = (x0 <= 0.0f) && (x1 >= 0.0f) && (y0 <= 0.0f) && (y1 >= 0.0f);
    const float ca_s = ca > 0.0f ? ca : 1.0f;
    const float cc_s = cc > 0.0f ? cc : 1.0f;
    const float qx0 = quad(ca, cb, cc, x0, clip(-cb * x0 / cc_s, y0, y1));
    const float qx1 = quad(ca, cb, cc, x1, clip(-cb * x1 / cc_s, y0, y1));
    const float qy0 = quad(ca, cb, cc, clip(-cb * y0 / ca_s, x0, x1), y0);
    const float qy1 = quad(ca, cb, cc, clip(-cb * y1 / ca_s, x0, x1), y1);
    const float q = fminf(fminf(qx0, qx1), fminf(qy0, qy1));
    return inside ? 0.0f : q;
}

template <bool WRITE>
__global__ void __launch_bounds__(THREADS) expand_kernel(
    const float* __restrict__ xy,       // (N, 2)
    const float* __restrict__ conic,    // (N, 3)
    const float* __restrict__ opacity,  // (N,)
    const int* __restrict__ rect,       // (N, 4) min_x, min_y, max_x, max_y
    const uint8_t* __restrict__ valid,  // (N,)
    const int64_t* __restrict__ slot,   // (N,) depth rank (write pass)
    const int64_t* __restrict__ offset, // (N,) exclusive prefix of counts (write pass)
    int n, int g_per_view, int grid_x, int n_tiles,
    int* __restrict__ counts,           // (N,) (count pass)
    int64_t* __restrict__ keys,         // (L,) (write pass)
    int* __restrict__ gid) {            // (L,) (write pass)
    const int i = blockIdx.x * THREADS + threadIdx.x;
    if (i >= n) return;
    if (!valid[i]) {
        if (!WRITE) counts[i] = 0;
        return;
    }
    const int rx = rect[4 * i + 0];
    const int ry = rect[4 * i + 1];
    const int rx1 = rect[4 * i + 2];
    const int ry1 = rect[4 * i + 3];
    const float xs = xy[2 * i + 0];
    const float ys = xy[2 * i + 1];
    const float ca = conic[3 * i + 0];
    const float cb = conic[3 * i + 1];
    const float cc = conic[3 * i + 2];
    const bool pd = (ca > 0.0f) && (cc > 0.0f) && (ca * cc - cb * cb > 0.0f);
    const float thr = 2.0f * logf(fmaxf(opacity[i], 1e-12f) / ALPHA_MIN) + 1e-3f;

    const int64_t tile0 = (int64_t)(i / g_per_view) * n_tiles;
    int64_t out = WRITE ? offset[i] : 0;
    const int64_t s = WRITE ? slot[i] : 0;
    int c = 0;
    for (int ty = ry; ty < ry1; ++ty) {
        const float y0 = (float)(ty * TILE) - ys;
        const float y1 = y0 + (float)(TILE - 1);
        for (int tx = rx; tx < rx1; ++tx) {
            const float x0 = (float)(tx * TILE) - xs;
            const float x1 = x0 + (float)(TILE - 1);
            const bool ok = !pd || rect_quadratic_min(ca, cb, cc, x0, x1, y0, y1) <= thr;
            if (!ok) continue;
            if (WRITE) {
                keys[out] = ((tile0 + (int64_t)ty * grid_x + tx) << 32) | s;
                gid[out] = i;
                ++out;
            }
            ++c;
        }
    }
    if (!WRITE) counts[i] = c;
}

}  // namespace

extern "C" int expand_count(
    const float* xy, const float* conic, const float* opacity, const int* rect,
    const uint8_t* valid, int n, int g_per_view, int grid_x, int n_tiles,
    int* counts, void* stream) {
    const int blocks = (n + THREADS - 1) / THREADS;
    expand_kernel<false><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        xy, conic, opacity, rect, valid, nullptr, nullptr, n, g_per_view, grid_x,
        n_tiles, counts, nullptr, nullptr);
    return (int)cudaGetLastError();
}

extern "C" int expand_write(
    const float* xy, const float* conic, const float* opacity, const int* rect,
    const uint8_t* valid, const int64_t* slot, const int64_t* offset, int n,
    int g_per_view, int grid_x, int n_tiles, int64_t* keys, int* gid, void* stream) {
    const int blocks = (n + THREADS - 1) / THREADS;
    expand_kernel<true><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        xy, conic, opacity, rect, valid, slot, offset, n, g_per_view, grid_x,
        n_tiles, nullptr, keys, gid);
    return (int)cudaGetLastError();
}

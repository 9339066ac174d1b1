// Plane-sweep correlation, forward: the UniMatch cost volume in one pass.
//
// Replaces no TPU kernel: my_depthsplat_tpu/ops/grid_sample.py:
// plane_sweep_correlation (:134) is XLA ops (a warp, four row gathers and a
// dot) outside any Pallas kernel. The port's plain version
// (ops/grid_sample.py:_sweep_plain) gathers each bilinear tap's source rows
// for a chunk of pairs into device memory, (k, D, H*W, C) a tap, widens them
// to float32 and dots them with the reference rows: at re10k_720p_fast's
// served shapes (24 (view, source) pairs; scale 0 64x120 with C = 128 and
// D = 128, scale 1 128x240 with C = 64 and D = 32) some 360 GB of
// device-memory traffic a scene.
//
// For each (pair, reference pixel, candidate) the kernel computes the source
// pixel, reads the 4 bilinear taps' rows, dots them with the reference row
// in float32 and writes the cost alone:
//     g = (x, y, 1);  P = R (K^-1 g) * depth + t;  q = K P
//     (sx, sy) = (q0, q1) / max(q2, clamp_min_depth)
//     cost = sum over the taps (x0, y0), (x0+1, y0), (x0, y0+1), (x0+1, y0+1)
//            of (ref_row . src_row[tap]) * w_tap,  w_tap = 0 off the image
// in _warp_pixel_coords' order of operations (R (K^-1 g), then times depth,
// plus t, then K, then the division): each 3x3 product is a chain of fused
// multiply-adds over k = 0, 1, 2, the depth product and the translation round
// apart (the library builds with -fmad=false), the division is IEEE; the
// weighted taps are added in the plain version's order. The fma chains do not
// round as the plain version's batched 3x3 matmuls do: at the served shapes
// about a third of the warp's coordinates differ by an ulp or more. Against
// the same operations in float64 (chip_smoke.py phase 36, H100) the kernel's
// cost is off by 2.18e-5 (scale 0) and 5.10e-5 (scale 1) of the largest
// entry and the plain version's by 2.58e-5 and 5.98e-5: the two differ by up
// to 4.3e-5, and each is as close to the exact cost as the other. A tap's in-image test is made on the floored float
// coordinate before any conversion to an integer, so a point behind the
// camera (its depth clamped, its coordinates far off the image) cannot
// overflow an index.
//
// What bounds it on the H100, at the served shapes (both scales): device-
// memory bytes ~0.66 GB (the pixel-major rows read once, 142 MB a side; the
// float32 candidates, 189 MB; the float32 cost written, 189 MB), ~0.2 ms at
// 3.35 TB/s; operations ~38 GFLOP (4 taps x 2C a sample, plus the warp),
// ~0.57 ms at 67 TFLOP/s of float32. The traffic the kernel cannot avoid is
// the tap rows' through L1 and L2: 4 rows of C a sample, ~36 GB a scene in
// bf16. So the design keeps every tap row out of device memory and aims its
// reads at L1:
// - Layout: the wrapper hands pixel-major rows (N, H*W, C), so a tap is one
//   contiguous row. A group of G lanes (8, 16 or 32: the power of two that
//   covers the row's 16-byte vectors, at least 8) owns one reference pixel
//   and splits C in 16-byte vectors, so a row is one coalesced read (256 B
//   at C = 128 in bf16, 128 B at C = 64); a row of more than G vectors is
//   taken in slices of G.
// - The reference row stays in registers across all D candidates (one
//   slice: every served shape); the source rows come through the read-only
//   path.
// - A CTA of 256 threads holds a 2-D tile of 256 / G reference pixels (4x4
//   at G = 16, 8x4 at G = 8, 4x2 at G = 32) that walk the candidates in
//   step, so neighbouring pixels, and consecutive candidates along the
//   epipolar line, read the same source rows out of L1.
// - Each lane keeps its partial costs of a batch of G candidates; a
//   transposing butterfly (G - 1 shuffles for G sums, composite_bwd.cu's
//   fold) leaves lane j of the group with candidate j's cost, which it
//   writes.
// - Every lane of a group computes its pixel's warp: ~40 float operations a
//   candidate, against 4 x 2C / G of dot a lane.
// The cost is written in float32; the wrapper rounds it to the features'
// dtype once, as the plain version does. All N pairs go in one launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

struct Bf16 {};  // bfloat16 features, 8 to a 16-byte vector

// A 16-byte vector of features unpacked to float32 (exact for bf16).
template <typename T>
struct Vec;

template <>
struct Vec<float> {
    static constexpr int N = 4;
    __device__ static void unpack(const uint4 u, float (&f)[N]) {
        f[0] = __uint_as_float(u.x);
        f[1] = __uint_as_float(u.y);
        f[2] = __uint_as_float(u.z);
        f[3] = __uint_as_float(u.w);
    }
};

template <>
struct Vec<Bf16> {
    static constexpr int N = 8;
    __device__ static void unpack(const uint4 u, float (&f)[N]) {
        const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {  // element 2i is the low half of word i
            f[2 * i] = __uint_as_float(w[i] << 16);
            f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
    }
};

template <typename T>
__device__ __forceinline__ void load_vec(const uint4* p, bool has, float (&f)[Vec<T>::N]) {
    Vec<T>::unpack(has ? __ldg(p) : make_uint4(0u, 0u, 0u, 0u), f);
}

// One slice of the 4 taps' dots: vector v of each in-image tap's source row
// against the same vector of the reference row, added to acc.
template <typename T>
__device__ __forceinline__ void dot_taps(const uint4* src_n, const int (&rows)[4], const bool (&ok)[4], int nv,
                                         int v, const float (&r)[Vec<T>::N], float (&acc)[4]) {
    constexpr int N = Vec<T>::N;
    uint4 u[4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
        u[t] = ok[t] && v < nv ? __ldg(src_n + (int64_t)rows[t] * nv + v) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
        float f[N];
        Vec<T>::unpack(u[t], f);
#pragma unroll
        for (int e = 0; e < N; ++e) acc[t] = fmaf(r[e], f[e], acc[t]);
    }
}

// One transposing step over 2H values: a lane with bit H set keeps values
// H..2H-1 (moved to 0..H-1) and sends 0..H-1; its partner the reverse. From
// H = G/2 down to 1, lane j of the group ends with value j summed over the
// group in a[0].
template <int H, int G>
__device__ __forceinline__ void fold(float (&a)[G], int lane) {
    if constexpr (H > 0) {
        const bool up = lane & H;
#pragma unroll
        for (int i = 0; i < H; ++i) {
            const float send = up ? a[i] : a[i + H];
            const float keep = up ? a[i + H] : a[i];
            a[i] = keep + __shfl_xor_sync(FULL, send, H);
        }
        fold<H / 2, G>(a, lane);
    }
}

template <int G>
struct Tile {
    static constexpr int PIXELS = THREADS / G;
    static constexpr int W = PIXELS >= 32 ? 8 : 4;
    static constexpr int H = PIXELS / W;
};

// SLICED: a row of more than G vectors (G = 32), taken a slice of 32 at a
// time with the reference row's slice read again for every candidate.
template <typename T, int G, bool SLICED>
__global__ void __launch_bounds__(THREADS) plane_sweep_kernel(
    const uint4* __restrict__ src,     // (N, H*W, C) pixel-major source rows, as 16-byte vectors
    const uint4* __restrict__ ref,     // (N, H*W, C) reference rows
    const float* __restrict__ kinv,    // (N, 3, 3) inverse intrinsics
    const float* __restrict__ intr,    // (N, 3, 3) intrinsics
    const float* __restrict__ pose,    // (N, 4, 4) reference camera -> source camera
    const float* __restrict__ depth,   // (N, D, H*W) candidates
    int d_count, int h, int w, int nv, int tiles_x, float clamp_min_depth,
    float* __restrict__ out) {         // (N, D, H*W) float32 cost
    constexpr int N = Vec<T>::N;
    const int n = blockIdx.y;
    const int lane = threadIdx.x & (G - 1);
    const int pix = threadIdx.x / G;
    const int px = (int)(blockIdx.x % tiles_x) * Tile<G>::W + pix % Tile<G>::W;
    const int py = (int)(blockIdx.x / tiles_x) * Tile<G>::H + pix / Tile<G>::W;
    const bool live = px < w && py < h;
    const int x = min(px, w - 1), y = min(py, h - 1);  // a lane off the image computes its edge pixel
    const int64_t hw = (int64_t)h * w;
    const int64_t p = (int64_t)y * w + x;

    // R (K^-1 g) and t: the pixel's ray in the source camera
    const float* ki = kinv + 9 * n;
    const float* m = pose + 16 * n;
    const float gx = (float)x, gy = (float)y;
    float a[3], b[3], t[3], k[9];
#pragma unroll
    for (int i = 0; i < 3; ++i) a[i] = fmaf(ki[3 * i + 2], 1.0f, fmaf(ki[3 * i + 1], gy, ki[3 * i] * gx));
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        b[i] = fmaf(m[4 * i + 2], a[2], fmaf(m[4 * i + 1], a[1], m[4 * i] * a[0]));
        t[i] = m[4 * i + 3];
    }
#pragma unroll
    for (int i = 0; i < 9; ++i) k[i] = intr[9 * n + i];
    const float xmax = (float)(w - 1), ymax = (float)(h - 1);

    const uint4* src_n = src + (int64_t)n * hw * nv;
    const uint4* ref_p = ref + ((int64_t)n * hw + p) * nv;
    const float* dep = depth + (int64_t)n * d_count * hw + p;
    float* o = out + (int64_t)n * d_count * hw + p;
    float r0[N];  // the reference row (its first slice where SLICED), kept across the candidates
    load_vec<T>(ref_p + lane, lane < nv, r0);

    for (int d0 = 0; d0 < d_count; d0 += G) {
        float part[G];
#pragma unroll
        for (int j = 0; j < G; ++j) {
            const float z = __ldg(dep + (int64_t)min(d0 + j, d_count - 1) * hw);
            float pt[3], q[3];
#pragma unroll
            for (int i = 0; i < 3; ++i) pt[i] = __fadd_rn(__fmul_rn(b[i], z), t[i]);
#pragma unroll
            for (int i = 0; i < 3; ++i) q[i] = fmaf(k[3 * i + 2], pt[2], fmaf(k[3 * i + 1], pt[1], k[3 * i] * pt[0]));
            const float zc = fmaxf(q[2], clamp_min_depth);
            const float sx = __fdiv_rn(q[0], zc), sy = __fdiv_rn(q[1], zc);
            const float x0 = floorf(sx), y0 = floorf(sy);
            const float x1 = x0 + 1.0f, y1 = y0 + 1.0f;
            const float wx1 = sx - x0, wy1 = sy - y0;
            const float wx0 = 1.0f - wx1, wy0 = 1.0f - wy1;
            const bool inx0 = x0 >= 0.0f && x0 <= xmax, inx1 = x1 >= 0.0f && x1 <= xmax;
            const bool iny0 = y0 >= 0.0f && y0 <= ymax, iny1 = y1 >= 0.0f && y1 <= ymax;
            const int cx0 = (int)fminf(fmaxf(x0, 0.0f), xmax), cx1 = (int)fminf(fmaxf(x1, 0.0f), xmax);
            const int cy0 = (int)fminf(fmaxf(y0, 0.0f), ymax), cy1 = (int)fminf(fmaxf(y1, 0.0f), ymax);
            const bool ok[4] = {inx0 && iny0, inx1 && iny0, inx0 && iny1, inx1 && iny1};
            const int rows[4] = {cy0 * w + cx0, cy0 * w + cx1, cy1 * w + cx0, cy1 * w + cx1};
            const float wt[4] = {wx0 * wy0, wx1 * wy0, wx0 * wy1, wx1 * wy1};
            float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            dot_taps<T>(src_n, rows, ok, nv, lane, r0, acc);
            if constexpr (SLICED) {
                for (int s = G; s < nv; s += G) {
                    const int v = s + lane;
                    float r[N];
                    load_vec<T>(ref_p + v, v < nv, r);
                    dot_taps<T>(src_n, rows, ok, nv, v, r, acc);
                }
            }
            float cost = acc[0] * (ok[0] ? wt[0] : 0.0f);
#pragma unroll
            for (int tap = 1; tap < 4; ++tap) cost = cost + acc[tap] * (ok[tap] ? wt[tap] : 0.0f);
            part[j] = cost;
        }
        fold<G / 2, G>(part, lane);
        if (live && d0 + lane < d_count) o[(int64_t)(d0 + lane) * hw] = part[0];
    }
}

template <typename T, int G, bool SLICED>
int launch(const void* src, const void* ref, const float* kinv, const float* intr, const float* pose,
           const float* depth, int n, int d, int h, int w, int nv, float clamp_min_depth, float* out,
           void* stream) {
    const int tiles_x = (w + Tile<G>::W - 1) / Tile<G>::W;
    const int tiles_y = (h + Tile<G>::H - 1) / Tile<G>::H;
    const dim3 grid(tiles_x * tiles_y, n);
    plane_sweep_kernel<T, G, SLICED><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint4*)src, (const uint4*)ref, kinv, intr, pose, depth, d, h, w, nv, tiles_x, clamp_min_depth, out);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_lanes(const void* src, const void* ref, const float* kinv, const float* intr, const float* pose,
                 const float* depth, int n, int d, int h, int w, int nv, float clamp_min_depth, float* out,
                 void* stream) {
#define PLANE_SWEEP_ARGS src, ref, kinv, intr, pose, depth, n, d, h, w, nv, clamp_min_depth, out, stream
    if (nv <= 8) return launch<T, 8, false>(PLANE_SWEEP_ARGS);
    if (nv <= 16) return launch<T, 16, false>(PLANE_SWEEP_ARGS);
    if (nv <= 32) return launch<T, 32, false>(PLANE_SWEEP_ARGS);
    return launch<T, 32, true>(PLANE_SWEEP_ARGS);
#undef PLANE_SWEEP_ARGS
}

}  // namespace

// cost (N, D, H, W) float32 of src, ref (N, H*W, C) pixel-major, float32 or
// (bf16 != 0) bfloat16, C a multiple of 8; kinv and intr (N, 3, 3), pose
// (N, 4, 4), depth (N, D, H, W) float32. Every size > 0, N <= 65535.
// Returns the cudaError_t of the launch.
extern "C" int plane_sweep(
    const void* src, const void* ref, const float* kinv, const float* intr, const float* pose,
    const float* depth, int bf16, int n, int d, int h, int w, int c, float clamp_min_depth, float* out,
    void* stream) {
    if (bf16)
        return launch_lanes<Bf16>(src, ref, kinv, intr, pose, depth, n, d, h, w, c / 8, clamp_min_depth, out, stream);
    return launch_lanes<float>(src, ref, kinv, intr, pose, depth, n, d, h, w, c / 4, clamp_min_depth, out, stream);
}

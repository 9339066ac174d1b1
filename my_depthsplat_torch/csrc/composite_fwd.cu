// Tile composite, forward: front-to-back alpha blending of each 16x16
// tile's depth-sorted instance run.
//
// Replaces the TPU kernel my_depthsplat_tpu/render/pallas_raster.py:_fwd_kernel
// (:162) in flat mode (chained=False), launched by _composite_fwd_impl (:544).
// The TPU kernel DMA'd 128-lane-aligned windows of a packed (16, L) instance
// array into VMEM and composited a (256 pixels x CHUNK instances) block at a
// time with doubling-scan cumulative products. Here one CTA of 256 threads
// owns one (view, tile), one thread per pixel; the run is staged through
// shared memory in batches of 256 instances (one instance per thread, read
// through the sorted gaussian-id list), and every pixel composites the batch
// sequentially with exactly the JAX gates (pallas_raster.py:129-159,
// 218-279):
//     power = -0.5 (a dx^2 + c dy^2) - b dx dy,   skip unless power <= 0
//     alpha = min(0.99, opacity * exp(power)),     skip unless alpha >= 1/255
//     stop for good once T (1 - alpha) < 1e-4 (that instance excluded)
// Pixel coordinates follow the JAX convention px = tx * 16 + col (no +0.5).
// Outputs: rgb + T * background, the final transmittance T, and n_contrib,
// the 1-based run position of the last contributing instance (what a
// backward pass needs). Pixels past the image edge are masked and count as
// done. The CTA leaves early once __syncthreads_count says every pixel is
// done.
//
// The same kernel, instantiated with CHAINED, replaces _fwd_kernel's chained
// mode (:172-182, :281-289, :308-318; launched with init=state,
// add_bg=False by _render_grouped_impl :687): one depth group of a view with
// millions of gaussians, resumed from the state the nearer groups left. The
// TPU kernel carried a tile-major (gy, gx, 256, 8) block; here the state is
// three image-layout arrays that the kernel reads at entry and overwrites at
// exit: rgb (B, H, W, 3), the frozen transmittance T (B, H, W) and p_raw
// (B, H, W). The sticky stop survives the launch boundary through p_raw: a
// pixel enters done iff its p_raw < 1e-4; a pixel that stops at
// T (1 - alpha) < 1e-4 stores that product as p_raw and keeps T; a pixel that
// has not stopped stores p_raw = T. No background (the caller adds T * bg once
// after the last group); n_contrib is local to the launch. A pixel that had
// stopped before the launch costs one read of p_raw and one write of
// n_contrib = 0: its rgb and T are left as they are. Flat and chained
// share the per-pixel loop below, so a pixel performs the same float32
// operations in the same order over the concatenated runs either way.
//
// Bound on the H100: the instance x pixel evaluations up to n_contrib (~12
// float operations for the gate of each, ~13 more for each that passes both
// gates, against 67 TFLOP/s of non-tensor float32) or the bytes (36 bytes of
// gaussian row + 4 bytes of id per instance read, 20 bytes per pixel
// written; chained, in every launch: 20 bytes of state read and 24 written
// for a pixel still live on entry, 4 read (p_raw) and 4 written (n_contrib)
// for one that has stopped, which decides when a group leaves few instances
// per tile), whichever is larger for the scene. Design: each instance row is
// read from device memory once per tile into shared memory and then
// broadcast to all 256 pixels, so memory traffic is per instance and not per
// evaluation; the evaluations run from registers and shared memory. Built
// without --use_fast_math and with -fmad=false so expf and the rounding match
// the plain PyTorch version. Simple before fast: no cp.async/TMA pipelining.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int ROWS = 9;  // x, y, conic a, b, c, opacity, r, g, b
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float TRANSMITTANCE_EPS = 1e-4f;

template <bool CHAINED>
__global__ void __launch_bounds__(NPIX) composite_fwd_kernel(
    const float* __restrict__ rows,    // (N, 9) per-gaussian screen rows
    const int* __restrict__ gid,       // (L,) sorted instance -> gaussian
    const int* __restrict__ starts,    // (B * gy * gx,)
    const int* __restrict__ counts,    // (B * gy * gx,)
    const float* __restrict__ bg,      // (B, 3); unused when CHAINED
    int gy, int gx, int h, int w,
    float* __restrict__ image,         // (B, H, W, 3); in and out when CHAINED
    float* __restrict__ t_final,       // (B, H, W); in and out when CHAINED
    float* __restrict__ p_raw,         // (B, H, W) in and out; CHAINED only
    int* __restrict__ n_contrib) {     // (B, H, W)
    __shared__ float s_row[ROWS][NPIX];

    const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
    const int tile = (b * gy + ty) * gx + tx;
    const int t = threadIdx.x;
    const int pxi = tx * TILE + t % TILE;
    const int pyi = ty * TILE + t / TILE;
    const bool inside = pxi < w && pyi < h;
    const float px = (float)pxi;
    const float py = (float)pyi;
    const int start = starts[tile];
    const int count = counts[tile];

    const size_t p = ((size_t)b * h + pyi) * w + pxi;  // meaningful if inside

    float T = 1.0f;
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
    float praw = 1.0f;
    int last = 0;
    bool done = !inside;
    bool stopped_on_entry = false;  // CHAINED: its state is neither read nor rewritten
    if (CHAINED && inside) {
        praw = p_raw[p];
        done = stopped_on_entry = praw < TRANSMITTANCE_EPS;
        if (!done) {
            c0 = image[3 * p + 0];
            c1 = image[3 * p + 1];
            c2 = image[3 * p + 2];
            T = t_final[p];
        }
    }

    for (int base = 0; base < count; base += NPIX) {
        // barrier: the previous batch is consumed before it is overwritten
        if (__syncthreads_count(done) == NPIX) break;
        if (base + t < count) {
            const float* r = rows + (size_t)gid[start + base + t] * ROWS;
#pragma unroll
            for (int k = 0; k < ROWS; ++k) s_row[k][t] = r[k];
        }
        __syncthreads();
        const int n = min(NPIX, count - base);
        for (int j = 0; j < n && !done; ++j) {
            const float dx = px - s_row[0][j];
            const float dy = py - s_row[1][j];
            const float ca = s_row[2][j], cb = s_row[3][j], cc = s_row[4][j];
            const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
            if (!(power <= 0.0f)) continue;
            const float v = s_row[5][j] * expf(power);
            const float alpha = v > ALPHA_MAX ? ALPHA_MAX : v;
            if (!(alpha >= ALPHA_MIN)) continue;
            const float test_t = T * (1.0f - alpha);
            if (test_t < TRANSMITTANCE_EPS) {
                done = true;
                praw = test_t;
                break;
            }
            const float wgt = alpha * T;
            c0 += wgt * s_row[6][j];
            c1 += wgt * s_row[7][j];
            c2 += wgt * s_row[8][j];
            T = test_t;
            last = base + j + 1;
        }
    }
    if (!inside) return;
    if (stopped_on_entry) {
        n_contrib[p] = 0;
        return;
    }
    if (CHAINED) {
        image[3 * p + 0] = c0;
        image[3 * p + 1] = c1;
        image[3 * p + 2] = c2;
        p_raw[p] = done ? praw : T;
    } else {
        image[3 * p + 0] = c0 + T * bg[3 * b + 0];
        image[3 * p + 1] = c1 + T * bg[3 * b + 1];
        image[3 * p + 2] = c2 + T * bg[3 * b + 2];
    }
    t_final[p] = T;
    n_contrib[p] = last;
}

}  // namespace

extern "C" int composite_fwd(
    const float* rows, const int* gid, const int* starts, const int* counts,
    const float* bg, int b, int gy, int gx, int h, int w, float* image,
    float* t_final, int* n_contrib, void* stream) {
    const dim3 grid(gx, gy, b);
    composite_fwd_kernel<false><<<grid, NPIX, 0, (cudaStream_t)stream>>>(
        rows, gid, starts, counts, bg, gy, gx, h, w, image, t_final, nullptr, n_contrib);
    return (int)cudaGetLastError();
}

// One depth group resumed from, and written back into, the state arrays rgb,
// t_frozen and p_raw; n_contrib is written anew (local to this launch).
extern "C" int composite_fwd_chained(
    const float* rows, const int* gid, const int* starts, const int* counts,
    int b, int gy, int gx, int h, int w, float* rgb, float* t_frozen,
    float* p_raw, int* n_contrib, void* stream) {
    const dim3 grid(gx, gy, b);
    composite_fwd_kernel<true><<<grid, NPIX, 0, (cudaStream_t)stream>>>(
        rows, gid, starts, counts, nullptr, gy, gx, h, w, rgb, t_frozen, p_raw, n_contrib);
    return (int)cudaGetLastError();
}

// Tile composite, forward: front-to-back alpha blending of each 16x16
// tile's depth-sorted instance run.
//
// Replaces the TPU kernel my_depthsplat_tpu/render/pallas_raster.py:_fwd_kernel
// (:162) in flat mode (chained=False), launched by _composite_fwd_impl (:544).
// The TPU kernel DMA'd 128-lane-aligned windows of a packed (16, L) instance
// array into VMEM and composited a (256 pixels x CHUNK instances) block at a
// time with doubling-scan cumulative products. Here one CTA of 256 threads
// owns one (view, tile), one thread per pixel; the run is staged through
// shared memory in batches of 256 instances (read through the sorted
// gaussian-id list), and every pixel composites the batch sequentially with
// exactly the JAX gates (pallas_raster.py:129-159, 218-279):
//     power = -0.5 (a dx^2 + c dy^2) - b dx dy,   skip unless power <= 0
//     alpha = min(0.99, opacity * exp(power)),     skip unless alpha >= 1/255
//     stop for good once T (1 - alpha) < 1e-4 (that instance excluded)
// Pixel coordinates follow the JAX convention px = tx * 16 + col (no +0.5).
// Outputs: rgb + T * background, the final transmittance T, and n_contrib,
// the 1-based run position of the last contributing instance (what a
// backward pass needs). Pixels past the image edge are masked and count as
// done. The CTA leaves once __syncthreads_count says every pixel is done.
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
// n_contrib = 0: its rgb and T are left as they are.
// On exit the kernel adds the number of pixels still live (p_raw >= 1e-4)
// to *live when the caller passes it: the grouped render reads it with the
// next group's instance count and stops the walk once no pixel is live.
// Flat and chained share the per-pixel walk below, so a pixel performs the
// same float32 operations in the same order over the concatenated runs
// either way.
//
// What bounds it on the H100: operations, the instance x pixel evaluations
// (~12 float operations for the gate of each, ~13 more for each that passes
// both gates, against 67 TFLOP/s of non-tensor float32) more than the bytes
// (36 B of gaussian row + 4 B of id per instance read, 20 B per pixel
// written; chained, 20 B of state read and 24 B written for a pixel live on
// entry, 4 + 4 B for one that has stopped). A pixel keeps evaluating until it
// stops, so the instruction issue rate of the walk sets the pace.
//
// Design.
// - Staging: 256 instances per batch, one per thread: each thread reads
//   its instance's id and the 9 floats of its row (a 36-byte row is only
//   4-byte aligned) and stores them into shared memory; a barrier, then
//   the walk. One buffer: the barrier before each batch is the
//   __syncthreads_count that tells the CTA whether every pixel is done, so
//   the previous batch is walked before it is overwritten and a CTA whose
//   pixels are all done stages nothing more. Other CTAs on the SM walk
//   while one stages (12 KB of shared memory per CTA leaves registers to
//   bound the occupancy).
// - Reads: rows sit in shared memory padded to 12 floats, so a pixel reads
//   an instance with two 128-bit loads (a third for the colour of a hit),
//   all lanes at the same address (a broadcast), instead of nine scalar
//   loads.
// - Gate: a pair whose power is below -5.55 (opacity <= 1) fails the alpha
//   gate without expf (may_pass, composite_common.cuh, the backward's test).
// - A warp whose 32 pixels have all stopped leaves the walk of a batch at
//   once (every lane's loop ends) and only stages.
// - Measured and taken back (PERF.md): batches of 64 and 128 instances
//   (more barriers, each waiting on the slowest warp), the backward's
//   per-warp strip cull (strip_may_pass and a ballot per 32 instances; at
//   these splat sizes it removes few pairs and costs registers), a cheaper
//   cull by each instance's reachable rows, and double-buffered staging,
//   with cp.async (faster on some inputs, slower on others: no clear gain
//   for the code) or with plain loads (slower on the chained kernel).
// - None of this changes a pixel's arithmetic: the same instances in the
//   same order through the same expressions (-fmad=false, expf, no fast
//   math); the gate skips only pairs that it rejects. The outputs are bit
//   for bit those of the one-pair-at-a-time walk without staging overlap
//   that this design replaced.
// - No TMA: Hopper's tensor maps copy regular boxes of a tensor, and the row
//   copy is an indirect gather through the ids; the ids are 1 KB per batch,
//   too small to pay for a tensor map and an mbarrier. No tensor cores: the
//   gates must decide every pair exactly in float32, and the per-pixel walk
//   is a sequential scan with a data-dependent stop, not a product.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using namespace composite;

constexpr int BATCH = NPIX;  // instances staged per step: one per thread
constexpr int RSTRIDE = 12;  // floats per row in shared memory: three float4

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
    int* __restrict__ n_contrib,       // (B, H, W)
    int* __restrict__ live) {          // (1,) pixels live on exit, added; CHAINED, may be null
    __shared__ __align__(16) float s_row[BATCH * RSTRIDE];

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

    const float4* s = reinterpret_cast<const float4*>(s_row);
    for (int base = 0; base < count; base += BATCH) {
        // barrier: the previous batch is walked before it is overwritten
        if (__syncthreads_count(done) == NPIX) break;
        if (base + t < count) {
            const float* src = rows + (size_t)gid[start + base + t] * ROWS;
#pragma unroll
            for (int k = 0; k < ROWS; ++k) s_row[t * RSTRIDE + k] = src[k];
        }
        __syncthreads();
        const int n = min(BATCH, count - base);
        // a warp whose 32 pixels have all stopped leaves the loop at once
        for (int j = 0; j < n && !done; ++j) {
            const float4 r0 = s[3 * j];      // x, y, conic a, b
            const float4 r1 = s[3 * j + 1];  // conic c, opacity, r, g
            const float dx = px - r0.x;
            const float dy = py - r0.y;
            const float power = -0.5f * (r0.z * dx * dx + r1.x * dy * dy) - r0.w * dx * dy;
            if (!(power <= 0.0f && may_pass(power, r1.y))) continue;
            const float v = r1.y * expf(power);
            const float alpha = v > ALPHA_MAX ? ALPHA_MAX : v;
            if (!(alpha >= ALPHA_MIN)) continue;
            const float test_t = T * (1.0f - alpha);
            if (test_t < TRANSMITTANCE_EPS) {
                done = true;
                praw = test_t;
                break;
            }
            const float wgt = alpha * T;
            c0 += wgt * r1.z;
            c1 += wgt * r1.w;
            c2 += wgt * s[3 * j + 2].x;
            T = test_t;
            last = base + j + 1;
        }
    }
    if (CHAINED && live != nullptr) {
        const int n_live = __syncthreads_count(!done);  // outside pixels count as done
        if (t == 0 && n_live > 0) atomicAdd(live, n_live);
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
        rows, gid, starts, counts, bg, gy, gx, h, w, image, t_final, nullptr, n_contrib, nullptr);
    return (int)cudaGetLastError();
}

// One depth group resumed from, and written back into, the state arrays rgb,
// t_frozen and p_raw; n_contrib is written anew (local to this launch). When
// live is not null, the number of pixels live on exit is added to *live
// (the caller zeroes it first). live comes after the stream so that the
// arguments before it are those of the chained entry without the count.
extern "C" int composite_fwd_chained(
    const float* rows, const int* gid, const int* starts, const int* counts,
    int b, int gy, int gx, int h, int w, float* rgb, float* t_frozen,
    float* p_raw, int* n_contrib, void* stream, int* live) {
    const dim3 grid(gx, gy, b);
    composite_fwd_kernel<true><<<grid, NPIX, 0, (cudaStream_t)stream>>>(
        rows, gid, starts, counts, nullptr, gy, gx, h, w, rgb, t_frozen, p_raw, n_contrib, live);
    return (int)cudaGetLastError();
}

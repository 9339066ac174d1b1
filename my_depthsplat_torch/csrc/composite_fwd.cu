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
//
// bfloat16 (composite_fwd_bf16, composite_fwd_chained_bf16; the reference's
// composite_dtype="bfloat16", pallas_raster.py:197-279): a kernel of its
// own, composite_fwd_bf16_kernel below, that follows the reference's
// association, redesigned for Hopper.
// - Semantics: a run is walked in windows of 256 slots of the launch's
//   instance array starting at start - start % 128 (the reference's
//   128-aligned DMA windows; on the grouped route start is local to the
//   group's launch); slots outside the run hold alpha 0. Per window and
//   pixel: the factors bf16(1 - alpha) (1 where the gate fails), the
//   reference's doubling scan of them (shifts 1, 2, ..., 64, each level a
//   bf16 multiply: s; the last level, shift 128, kept unrounded as the
//   jitted reference widens it: s_full), P the float32 product carried from
//   the earlier windows. A slot is included while P s_full >= 1e-4, each
//   slot on its own (the scan's roundings are not monotone); a hit there
//   weighs alpha P s_(i-1); T becomes the least included P s_full of the
//   window, or of those and the T before it where a slot is not included
//   (reference :274-276); P <- P s_full(255) at the window's end.
// - What bounds it on the H100: operations. Per pixel and window with a
//   hit: the gate of every slot of the warp's candidate groups (a bf16x2
//   quadratic and two expf a word of two slots), the scan's 1,665 bf16
//   multiplies on 833 packed words, a compare a slot for T and a dozen
//   operations a slot of the hit groups; the bytes are the float32 kernel's
//   (36 B of row and 4 B of id an instance, 20 B a pixel written). The
//   earlier design kept each pixel's window in a 256 x 256 bf16
//   table in shared memory (128 KB, one CTA of 8 warps an SM), sent each
//   column through shared memory three times and walked all 256 slots of a
//   window with a hit, gating each hit twice.
// - The window lives in a thread's registers (128 words of two bf16 slots)
//   from its factors through its scan to its hit pass: no per-pixel table,
//   no column in shared memory. The registers (about 200 a thread, no
//   spills) bound the occupancy instead, so a CTA holds half a tile (8 rows,
//   128 threads) and two CTAs share an SM: one stages its window's rows
//   while the other computes.
// - A register array is indexed only by constants (an index known at run
//   time puts the array in local memory). The factor and hit passes loop
//   over 32-slot groups with the group known at run time, so a group's 16
//   (17) words move between the window and a small array g by selects on
//   the group index, and the work on g is unrolled over its words and
//   slots with constant indices. Both passes are free of branches inside a
//   group (predicated stores and selects), so that the scheduler overlaps
//   the words' long dependency chains (shared loads, the bf16 quadratic,
//   expf); a branch a word held the warp to one chain at a time.
// - Per window: the 256 slots' rows are staged in shared memory (their
//   conics also rounded to bf16, and the strip test's per-instance part:
//   logf(ALPHA_MIN / op), 1 / a, 1 / c); each warp takes as candidates the
//   run's slots that a pixel of its 16x2 strip may hit (strip_may_pass's
//   test with the bf16 slack), in 8 ballots.
// - Factor pass: in each group with a candidate of the warp, each thread
//   gates all 16 words, two slots at a time with the quadratic on packed
//   bf16x2 (gate_power2) and gate_all (gate_tail without its branch; a
//   slot that is no candidate stays at 1), records one hit bit a slot and
//   keeps each hit's float alpha in a per-pixel list in shared memory (the
//   first ALPHA_CAP hits of the window; a hit past them is gated again in
//   the hit pass, by the same expressions). A pixel without a hit in the
//   window includes every slot at P: T becomes P, and it skips the rest.
// - Scan: scan_window (composite_common.cuh) in registers; the groups below
//   the warp's first group with a hit hold (1, 1) at every level and are
//   skipped.
// - T (window_t): fl(P x) is monotone in x for P > 0, so a slot is included
//   iff s_full >= x, the least float with fl(P x) >= 1e-4 (included_from),
//   and the least included P s_full is fl(P times the least included
//   s_full): a compare and a min a slot, no product. Words m and m + 64 go
//   together, the lower being the upper's partner in the last level, and
//   the upper word is then replaced by its s_full rounded to bf16, the
//   value the slot after it reads.
// - Hit pass: the groups in which a pixel of the warp has a hit, in slot
//   order; a thread weighs its own included hits, alpha (from the list)
//   times P times the rounded scan at the slot before.
// - Chained: as the float32 kernel, but p_raw is P (the reference's
//   carried raw product), not T.
// - Shared memory: 12 KB rows + 1.5 KB bf16 conics + 8 KB hit and
//   included-hit bits + 80.5 KB alphas (ALPHA_CAP + 1 rows) + 128 B
//   candidates (104,576 B) a CTA of 128 threads: two CTAs an SM, the
//   registers' limit too.

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
            float dx, dy, e, alpha;
            if (!gate(px, py, r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, dx, dy, e, alpha)) continue;
            const float test_t = T * (1.0f - alpha);
            const float wgt = alpha * T;
            if (test_t < TRANSMITTANCE_EPS) {
                done = true;
                praw = test_t;
                break;
            }
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

// ---- bfloat16 ----

constexpr int BF16_ROWS = 8;                     // pixel rows of a tile a CTA holds
constexpr int BF16_THREADS = TILE * BF16_ROWS;   // one thread a pixel
constexpr int BF16_SPLIT = TILE / BF16_ROWS;     // CTAs a tile
constexpr int BF16_WARPS = BF16_THREADS / 32;
constexpr int GROUPS = CHUNK / 32;               // 32-slot groups a window
constexpr int ALPHA_CAP = 160;                   // hits' alphas kept a pixel and window

// rows, bf16 conics, candidates, hit bits, included hit bits, alphas
constexpr size_t BF16_SMEM = CHUNK * RSTRIDE * 4 + 3 * CHUNK * 2 + BF16_WARPS * GROUPS * 4 +
                             2 * GROUPS * BF16_THREADS * 4 + (ALPHA_CAP + 1) * BF16_THREADS * 4;

// The alpha gate once the bf16 power is known (gate_tail's expressions)
// without its branch: expf is taken for every pair, so that the slots of a
// group are gated as independent streams of instructions; alpha is
// meaningful where the gate passes. (may_pass only spares gate_tail an
// expf: where it fails, alpha < 1/255 fails the gate all the same.)
__device__ __forceinline__ bool gate_all(float power, float op, float& alpha) {
    const float v = op * expf(power);
    alpha = v > ALPHA_MAX ? ALPHA_MAX : v;
    return power <= 0.0f && alpha >= ALPHA_MIN;
}

// g[i] for i in [0, 16] known at run time, by a tree of selects on the
// bits of i (an array indexed at run time would live in local memory).
__device__ __forceinline__ unsigned pick17(const unsigned (&g)[17], int i) {
    unsigned v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = i & 1 ? g[2 * j + 1] : g[2 * j];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = i & 2 ? v[2 * j + 1] : v[2 * j];
#pragma unroll
    for (int j = 0; j < 2; ++j) v[j] = i & 4 ? v[2 * j + 1] : v[2 * j];
    const unsigned low16 = i & 8 ? v[1] : v[0];
    return i & 16 ? g[16] : low16;
}

// The bf16 strip cull (strip_may_pass<true>, composite_common.cuh) with its
// per-instance part computed once a window, by the thread that stages the
// row, instead of once a warp: r[9] = logf(ALPHA_MIN / op), or -inf where
// the conic is no ellipse (every strip then passes, as strip_may_pass
// decides), r[10] = 1 / c, r[11] = 1 / a (the edges' optima are then a
// product, -b u (1 / c), where strip_may_pass divides: the same point to an
// ulp, and the slack is many times that).
__device__ __forceinline__ void strip_prepare(float* r) {
    const float a = r[2], b = r[3], c = r[4], op = r[5];
    r[9] = a > 0.0f && c > 0.0f && a * c > b * b ? logf(ALPHA_MIN / op) : -__int_as_float(0x7f800000);
    r[10] = 1.0f / c;
    r[11] = 1.0f / a;
}

__device__ __forceinline__ float edge_max_staged(float u, float lo, float hi, float a, float b, float c, float inv_c) {
    const float d = fminf(fmaxf(-b * u * inv_c, lo), hi);
    return -0.5f * (a * u * u + c * d * d) - b * u * d;
}

__device__ __forceinline__ bool strip_may_pass_staged(const float* r, float x0, float y0) {
    const float a = r[2], b = r[3], c = r[4];
    const float lx = x0 - r[0], hx = lx + (TILE - 1);
    const float ly = y0 - r[1], hy = ly + 1.0f;
    float top = 0.0f;
    if (lx > 0.0f || hx < 0.0f || ly > 0.0f || hy < 0.0f)
        top = fmaxf(fmaxf(edge_max_staged(lx, ly, hy, a, b, c, r[10]), edge_max_staged(hx, ly, hy, a, b, c, r[10])),
                    fmaxf(edge_max_staged(ly, lx, hx, c, b, a, r[11]), edge_max_staged(hy, lx, hx, c, b, a, r[11])));
    const float X = fmaxf(fabsf(lx), fabsf(hx)), Y = fmaxf(fabsf(ly), fabsf(hy));
    const float slack = 1e-3f + 0.0625f * (a * X * X + c * Y * Y + fabsf(b) * X * Y);
    return !(top < r[9] - slack);
}

// The least float x with fl(P x) >= 1e-4, for 1e-4 <= P <= 1: fl(P x) is
// monotone in x, so a slot is included (P s_full >= 1e-4) iff s_full >= x.
// The rounded quotient is within an ulp or two of it: a few steps up or
// down find it (bounded, so that a NaN P cannot loop).
__device__ __forceinline__ float included_from(float P) {
    float x = TRANSMITTANCE_EPS / P;
    for (int i = 0; i < 4 && !(P * x >= TRANSMITTANCE_EPS); ++i) x = __int_as_float(__float_as_int(x) + 1);
    for (int i = 0; i < 4 && P * __int_as_float(__float_as_int(x) - 1) >= TRANSMITTANCE_EPS; ++i)
        x = __int_as_float(__float_as_int(x) - 1);
    return x;
}

// A scanned window's T and its included hits: per slot whether it is
// included (s_full at least included_from(P)), the least included s_full,
// and the included slots among the hits ``hit`` (group k at hit[k *
// BF16_THREADS]) written to ``inc``. T is the least included P s_full, which
// is fl(P times the least included s_full) (monotone again), or that and
// the T before where a slot is not included (+inf where none is). Word m
// and word m + 64 are taken together (the lower word is the upper one's
// partner in the last level, so each is unpacked once), and the upper word
// is then replaced by its s_full rounded to bf16, what the hit pass reads.
__device__ __forceinline__ float window_t(unsigned (&r)[WORDS], float P, float T, const unsigned* hit,
                                          unsigned* inc) {
    const float x = included_from(P);
    float least = __int_as_float(0x7f800000);
    bool every = true;
#pragma unroll
    for (int k = 0; k < GROUPS / 2; ++k) {
        unsigned low_mask = 0, high_mask = 0;
#pragma unroll
        for (int mm = 0; mm < 16; ++mm) {
            const int m = k * 16 + mm, u = m + WORDS / 2;
            const float f0 = bf16_lo(r[m]), f1 = bf16_hi(r[m]);  // s_full of slots 2m, 2m + 1
            const float g0 = bf16_lo(r[u]) * f0, g1 = bf16_hi(r[u]) * f1;  // and of slots 2u, 2u + 1: exact
            if (f0 >= x) {
                least = fminf(least, f0);
                low_mask |= 1u << (2 * mm);
            }
            if (f1 >= x) {
                least = fminf(least, f1);
                low_mask |= 2u << (2 * mm);
            }
            if (g0 >= x) {
                least = fminf(least, g0);
                high_mask |= 1u << (2 * mm);
            }
            if (g1 >= x) {
                least = fminf(least, g1);
                high_mask |= 2u << (2 * mm);
            }
            r[u] = bf16_mul2(r[u], r[m]);
        }
        inc[k * BF16_THREADS] = hit[k * BF16_THREADS] & low_mask;
        inc[(k + GROUPS / 2) * BF16_THREADS] = hit[(k + GROUPS / 2) * BF16_THREADS] & high_mask;
        every = every && (low_mask & high_mask) == FULL;
    }
    const float least_p = P * least;
    return every ? least_p : fminf(T, least_p);
}

template <bool CHAINED>
__global__ void __launch_bounds__(BF16_THREADS, 256 / BF16_THREADS) composite_fwd_bf16_kernel(
    const float* __restrict__ rows, const int* __restrict__ gid, const int* __restrict__ starts,
    const int* __restrict__ counts, const float* __restrict__ bg, int gy, int gx, int h, int w,
    float* __restrict__ image, float* __restrict__ t_final, float* __restrict__ p_raw,
    int* __restrict__ n_contrib, int* __restrict__ live) {
    extern __shared__ __align__(16) unsigned char smem[];
    float* s_row = reinterpret_cast<float*>(smem);                                       // [CHUNK][RSTRIDE]
    unsigned short* s_con = reinterpret_cast<unsigned short*>(s_row + CHUNK * RSTRIDE);  // [3][CHUNK] bf16 a, b, c
    unsigned* s_cand = reinterpret_cast<unsigned*>(s_con + 3 * CHUNK);                   // [BF16_WARPS][GROUPS]
    unsigned* s_hit = s_cand + BF16_WARPS * GROUPS;                                      // [GROUPS][BF16_THREADS]
    unsigned* s_inc = s_hit + GROUPS * BF16_THREADS;                                     // [GROUPS][BF16_THREADS]
    float* s_alpha = reinterpret_cast<float*>(s_inc + GROUPS * BF16_THREADS);  // [ALPHA_CAP + 1][BF16_THREADS]

    const int tx = blockIdx.x, ty = blockIdx.y / BF16_SPLIT, b = blockIdx.z;
    const int row0 = (blockIdx.y % BF16_SPLIT) * BF16_ROWS;  // the CTA's first pixel row in its tile
    const int tile = (b * gy + ty) * gx + tx;
    const int t = threadIdx.x;
    const int pxi = tx * TILE + t % TILE;
    const int pyi = ty * TILE + row0 + t / TILE;
    const bool inside = pxi < w && pyi < h;
    const float px = (float)pxi;
    const float py = (float)pyi;
    const int start = starts[tile];
    const int count = counts[tile];
    const size_t p = ((size_t)b * h + pyi) * w + pxi;

    float T = 1.0f, P = 1.0f;
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
    int last = 0;
    bool done = !inside;
    bool stopped_on_entry = false;
    if (CHAINED && inside) {
        P = p_raw[p];
        done = stopped_on_entry = P < TRANSMITTANCE_EPS;
        if (!done) {
            c0 = image[3 * p + 0];
            c1 = image[3 * p + 1];
            c2 = image[3 * p + 2];
            T = t_final[p];
        }
    }

    const int lead = start % ALIGN;
    const int n_chunks = count > 0 ? (lead + count + CHUNK - 1) / CHUNK : 0;
    const int lane = t & 31, warp = t >> 5;
    unsigned* cand = s_cand + warp * GROUPS;
    const float x0 = (float)(tx * TILE), y0 = (float)(ty * TILE + row0 + 2 * warp);  // the warp's 16x2 strip
    const unsigned* ca = reinterpret_cast<const unsigned*>(s_con);
    const unsigned* cb = ca + CHUNK / 2;
    const unsigned* cc = cb + CHUNK / 2;
    unsigned r[WORDS];  // the pixel's window: its factors, then their scan
    for (int c = 0; c < n_chunks; ++c) {
        // barrier: the previous window is walked before it is overwritten
        if (__syncthreads_count(done) == BF16_THREADS) break;
        const int first = c * CHUNK - lead;  // run position of slot 0
        const int lo = max(0, -first), hi = min(CHUNK, count - first);  // the run's slots
        for (int j = t; j < CHUNK; j += BF16_THREADS) {
            if (j >= lo && j < hi) {
                const float* src = rows + (size_t)gid[start + first + j] * ROWS;
#pragma unroll
                for (int k = 0; k < ROWS; ++k) s_row[j * RSTRIDE + k] = src[k];
#pragma unroll
                for (int k = 0; k < 3; ++k) s_con[k * CHUNK + j] = bf16_bits(src[2 + k]);
                strip_prepare(s_row + j * RSTRIDE);
            } else {
                // no instance: the hit pass adds 0 times its colour
#pragma unroll
                for (int k = 6; k < ROWS; ++k) s_row[j * RSTRIDE + k] = 0.0f;
            }
        }
        __syncthreads();
        // a warp whose pixels have all stopped takes no part (the same in every lane)
        if (!__any_sync(FULL, !done)) continue;
        // the warp's candidates: the run's slots that a pixel of its 16x2
        // strip may hit
#pragma unroll 1
        for (int k = 0; k < GROUPS; ++k) {
            const int j = k * 32 + lane;
            const unsigned bal =
                __ballot_sync(FULL, j >= lo && j < hi && strip_may_pass_staged(s_row + j * RSTRIDE, x0, y0));
            if (lane == 0) cand[k] = bal;
        }
        __syncwarp();

        // factor pass: bf16(1 - alpha) of the candidate words, two slots at a
        // time; a word with a hit goes into its register, the others stay (1, 1)
#pragma unroll
        for (int m = 0; m < WORDS; ++m) r[m] = BF16_ONE2;
        unsigned groups = 0;  // bit k: the pixel has a hit in group k
        int n_hits = 0;
        for (int k = 0; k < GROUPS; ++k) {
            const unsigned cw = cand[k];  // the same in every lane
            unsigned bits = 0;
            if (cw != 0 && !done) {
                // the group's 16 words, every word gated (two slots at a time);
                // a slot that is no candidate of the warp stays at 1
                unsigned g[16];
#pragma unroll
                for (int i = 0; i < 16; ++i) {
                    const int m = k * 16 + i;
                    const float* r0 = s_row + 2 * m * RSTRIDE;
                    const float* r1 = r0 + RSTRIDE;
                    const float2 xy0 = *reinterpret_cast<const float2*>(r0);
                    const float2 xy1 = *reinterpret_cast<const float2*>(r1);
                    float p0, p1, a0, a1;
                    gate_power2(px - xy0.x, px - xy1.x, py - xy0.y, py - xy1.y, ca[m], cb[m], cc[m], p0, p1);
                    const bool h0 = gate_all(p0, r0[5], a0) & ((cw >> (2 * i) & 1u) != 0);
                    const bool h1 = gate_all(p1, r1[5], a1) & ((cw >> (2 * i + 1) & 1u) != 0);
                    g[i] = bf16_pack2(h0 ? 1.0f - a0 : 1.0f, h1 ? 1.0f - a1 : 1.0f);
                    // the hits' alphas in slot order; row ALPHA_CAP takes those past the list
                    if (h0) s_alpha[min(n_hits, ALPHA_CAP) * BF16_THREADS + t] = a0;
                    n_hits += h0;
                    if (h1) s_alpha[min(n_hits, ALPHA_CAP) * BF16_THREADS + t] = a1;
                    n_hits += h1;
                    bits |= (h0 ? 1u : 0u) << (2 * i) | (h1 ? 2u : 0u) << (2 * i);
                }
                // into the group's registers (k is known at run time only)
#pragma unroll
                for (int kk = 0; kk < GROUPS; ++kk) {
#pragma unroll
                    for (int i = 0; i < 16; ++i) r[kk * 16 + i] = k == kk ? g[i] : r[kk * 16 + i];
                }
            }
            s_hit[k * BF16_THREADS + t] = bits;
            groups |= (bits != 0 ? 1u : 0u) << k;
        }
        // the warp's first group with a hit: the groups below hold (1, 1) in
        // every lane (a pixel that has stopped has no hit)
        const unsigned warp_groups = __reduce_or_sync(FULL, groups);
        const int k0 = warp_groups != 0 ? __ffs(warp_groups) - 1 : GROUPS;
        float P_next = P;
        if (groups == 0) {
            // no hit in the window: every slot included at P
            if (!done) T = P;
        } else {
            scan_window(r, k0);
            P_next = P * (bf16_hi(r[WORDS - 1]) * bf16_hi(r[WORDS / 2 - 1]));  // P s_full(255)
            T = window_t(r, P, T, s_hit + t, s_inc + t);
        }
        // hit pass: the groups in which a pixel of the warp has a hit, in
        // slot order; each thread weighs its own included hits, from the
        // rounded scan at the slot before and the alpha kept above
        int n_seen = 0;
        for (int k = k0; k < GROUPS; ++k) {
            const unsigned bits = s_hit[k * BF16_THREADS + t];
            const unsigned warp_bits = __reduce_or_sync(FULL, bits);  // the same in every lane
            if (warp_bits == 0) continue;
            const unsigned inc = s_inc[k * BF16_THREADS + t];
            // g[i]: word 16 k - 1 + i ((1, 1) below word 0), picked by selects
            unsigned g[17];
#pragma unroll
            for (int i = 0; i < 17; ++i) {
                unsigned v = i == 0 ? BF16_ONE2 : r[i - 1];
#pragma unroll
                for (int kk = 1; kk < GROUPS; ++kk) v = k == kk ? r[kk * 16 - 1 + i] : v;
                g[i] = v;
            }
            if (bits == 0) continue;
            const int seen = n_seen;  // the pixel's hits before the group
            // every slot of the group, without a branch: a slot that is no
            // included hit of the pixel adds nothing
#pragma unroll
            for (int q = 0; q < 32; ++q) {
                const bool own = bits >> q & 1u;
                const int kept = n_seen;
                n_seen += own;
                const int j = k * 32 + q;
                const float before = q & 1 ? bf16_lo(g[q / 2 + 1]) : bf16_hi(g[q / 2]);
                const float* rj = s_row + j * RSTRIDE;
                const float wgt = s_alpha[min(kept, ALPHA_CAP) * BF16_THREADS + t] * (P * before);
                const bool add = own && (inc >> q & 1u) && kept < ALPHA_CAP && wgt > 0.0f;
                const float wa = add ? wgt : 0.0f;
                c0 += wa * rj[6];
                c1 += wa * rj[7];
                c2 += wa * rj[8];
                last = add ? first + j + 1 : last;
            }
            if (n_seen > ALPHA_CAP) {
                // the included hits past the list: gated again (the factor
                // pass's expressions), in slot order
                int kept = seen;
                for (int q = 0; q < 32; ++q) {
                    if (!(bits >> q & 1u)) continue;
                    if (kept++ < ALPHA_CAP || !(inc >> q & 1u)) continue;
                    const int j = k * 32 + q;
                    const float* rj = s_row + j * RSTRIDE;
                    const float before = q & 1 ? bf16_lo(pick17(g, q / 2 + 1)) : bf16_hi(pick17(g, q / 2));
                    const unsigned pa = 0x00010001u * (unsigned)s_con[j];  // (a, a): slot j alone
                    const unsigned pb = 0x00010001u * (unsigned)s_con[CHUNK + j];
                    const unsigned pcc = 0x00010001u * (unsigned)s_con[2 * CHUNK + j];
                    float power, unused, alpha;
                    const float dx = px - rj[0], dy = py - rj[1];
                    gate_power2(dx, dx, dy, dy, pa, pb, pcc, power, unused);
                    gate_all(power, rj[5], alpha);  // passes: the same expressions passed above
                    const float wgt = alpha * (P * before);
                    if (wgt > 0.0f) {
                        c0 += wgt * rj[6];
                        c1 += wgt * rj[7];
                        c2 += wgt * rj[8];
                        last = max(last, first + j + 1);
                    }
                }
            }
        }
        P = P_next;
        done = done || P < TRANSMITTANCE_EPS;
    }
    if (CHAINED && live != nullptr) {
        const int n_live = __syncthreads_count(!done);
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
        p_raw[p] = P;
    } else {
        image[3 * p + 0] = c0 + T * bg[3 * b + 0];
        image[3 * p + 1] = c1 + T * bg[3 * b + 1];
        image[3 * p + 2] = c2 + T * bg[3 * b + 2];
    }
    t_final[p] = T;
    n_contrib[p] = last;
}

// Above the 48 KB of shared memory a launch gets unasked.
template <bool CHAINED>
cudaError_t allow_bf16_smem() {
    return cudaFuncSetAttribute(composite_fwd_bf16_kernel<CHAINED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)BF16_SMEM);
}

template <bool BF16>
int launch_flat(
    const float* rows, const int* gid, const int* starts, const int* counts,
    const float* bg, int b, int gy, int gx, int h, int w, float* image,
    float* t_final, int* n_contrib, void* stream) {
    const dim3 grid(gx, gy, b);
    if constexpr (BF16) {
        const cudaError_t err = allow_bf16_smem<false>();
        if (err != cudaSuccess) return (int)err;
        composite_fwd_bf16_kernel<false><<<dim3(gx, gy * BF16_SPLIT, b), BF16_THREADS, BF16_SMEM,
                                           (cudaStream_t)stream>>>(
            rows, gid, starts, counts, bg, gy, gx, h, w, image, t_final, nullptr, n_contrib, nullptr);
    } else {
        composite_fwd_kernel<false><<<grid, NPIX, 0, (cudaStream_t)stream>>>(
            rows, gid, starts, counts, bg, gy, gx, h, w, image, t_final, nullptr, n_contrib, nullptr);
    }
    return (int)cudaGetLastError();
}

template <bool BF16>
int launch_chained(
    const float* rows, const int* gid, const int* starts, const int* counts,
    int b, int gy, int gx, int h, int w, float* rgb, float* t_frozen,
    float* p_raw, int* n_contrib, void* stream, int* live) {
    const dim3 grid(gx, gy, b);
    if constexpr (BF16) {
        const cudaError_t err = allow_bf16_smem<true>();
        if (err != cudaSuccess) return (int)err;
        composite_fwd_bf16_kernel<true><<<dim3(gx, gy * BF16_SPLIT, b), BF16_THREADS, BF16_SMEM,
                                          (cudaStream_t)stream>>>(
            rows, gid, starts, counts, nullptr, gy, gx, h, w, rgb, t_frozen, p_raw, n_contrib, live);
    } else {
        composite_fwd_kernel<true><<<grid, NPIX, 0, (cudaStream_t)stream>>>(
            rows, gid, starts, counts, nullptr, gy, gx, h, w, rgb, t_frozen, p_raw, n_contrib, live);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int composite_fwd(
    const float* rows, const int* gid, const int* starts, const int* counts,
    const float* bg, int b, int gy, int gx, int h, int w, float* image,
    float* t_final, int* n_contrib, void* stream) {
    return launch_flat<false>(rows, gid, starts, counts, bg, b, gy, gx, h, w, image, t_final, n_contrib, stream);
}

// The bf16 kernel, same arguments.
extern "C" int composite_fwd_bf16(
    const float* rows, const int* gid, const int* starts, const int* counts,
    const float* bg, int b, int gy, int gx, int h, int w, float* image,
    float* t_final, int* n_contrib, void* stream) {
    return launch_flat<true>(rows, gid, starts, counts, bg, b, gy, gx, h, w, image, t_final, n_contrib, stream);
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
    return launch_chained<false>(rows, gid, starts, counts, b, gy, gx, h, w, rgb, t_frozen, p_raw, n_contrib,
                                 stream, live);
}

// The bf16 kernel, same arguments.
extern "C" int composite_fwd_chained_bf16(
    const float* rows, const int* gid, const int* starts, const int* counts,
    int b, int gy, int gx, int h, int w, float* rgb, float* t_frozen,
    float* p_raw, int* n_contrib, void* stream, int* live) {
    return launch_chained<true>(rows, gid, starts, counts, b, gy, gx, h, w, rgb, t_frozen, p_raw, n_contrib,
                                stream, live);
}

// What a forward kernel holds on the card (kernel_resources,
// composite_common.cuh): out[0..5] = threads a CTA, registers a thread,
// local memory a thread, static and dynamic shared memory a CTA, CTAs an SM.
// bf16 selects the bf16 kernel, chained the CHAINED one. Returns the
// cudaError_t.
extern "C" int composite_fwd_resources(int bf16, int chained, int* out) {
    if (bf16) {
        const cudaError_t err = chained ? allow_bf16_smem<true>() : allow_bf16_smem<false>();
        if (err != cudaSuccess) return (int)err;
        return chained ? kernel_resources(composite_fwd_bf16_kernel<true>, BF16_THREADS, (int)BF16_SMEM, out)
                       : kernel_resources(composite_fwd_bf16_kernel<false>, BF16_THREADS, (int)BF16_SMEM, out);
    }
    return chained ? kernel_resources(composite_fwd_kernel<true>, NPIX, 0, out)
                   : kernel_resources(composite_fwd_kernel<false>, NPIX, 0, out);
}

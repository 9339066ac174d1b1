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
// association. Right first; its speed is measured in PERF.md.
// - Windows: a run is walked in windows of 256 slots of the launch's
//   instance array starting at start - start % 128 (the reference's
//   128-aligned DMA windows; on the grouped route start is local to the
//   group's launch); slots outside the run hold alpha 0.
// - Per window, one CTA: the 256 slots' rows are staged in shared memory
//   (with their conics rounded to bf16); each warp takes as candidates the
//   run's slots that a pixel of its 16x2 strip may hit (strip_may_pass with
//   the bf16 slack, composite_common.cuh); each thread (pixel) gates the
//   candidates two at a time, the quadratic on packed bf16x2 (gate_power2),
//   and writes bf16(1 - alpha) (1 where no hit) into its own column of a
//   256 x 256 bf16 table (128 KB of shared memory), in the 32-slot groups
//   that hold a candidate, with one hit bit a slot. A pixel without a hit
//   in the window includes every slot at P, so its T becomes P and the rest
//   is skipped. Otherwise it scans its column, the
//   reference's doubling scan (shifts 1, 2, ..., 64: 1,665 bf16 multiplies
//   on 833 packed bf16x2 words per pixel and window), in registers: the
//   column is read once and written back once (a column without a hit is
//   skipped); the last level (shift 128) is formed as the float32 product
//   of two table entries where it is read, as the jitted reference keeps it
//   unrounded.
// - Then the pixel walks the window's 256 slots in order: s_full the
//   unrounded scan, P the float32 product carried from the earlier
//   windows; a slot is included while P s_full >= 1e-4, each slot on its
//   own (the scan's roundings are not monotone), a hit there (gated again:
//   two evaluations a hit, one a non-hit) weighs alpha P s_(i-1) with
//   s_(i-1) the rounded scan; T becomes the least included P s_full of
//   the window, or of those and the T before it where a slot is not
//   included (reference :274-276); P <- P s_full(255) at the window's end.
//   A pixel whose P is below 1e-4 has stopped for good; the CTA leaves once
//   every pixel has.
// - Chained: as the float32 kernel, but p_raw is P (the reference's
//   carried raw product), not T.
// - Shared memory: 128 KB table + 8 KB hit bits + 12 KB rows + 1.5 KB
//   bf16 conics + 256 B candidates (153,344 B), so one CTA (8 warps) an
//   SM, against six to eight of the float32 kernel.

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

// the table, hit bits, rows, bf16 conics, candidates
constexpr size_t BF16_SMEM =
    (size_t)WORDS * NPIX * 4 + 8 * NPIX * 4 + CHUNK * RSTRIDE * 4 + 3 * CHUNK * 2 + NWARP * (CHUNK / 32) * 4;

template <bool CHAINED>
__global__ void __launch_bounds__(NPIX, 1) composite_fwd_bf16_kernel(
    const float* __restrict__ rows, const int* __restrict__ gid, const int* __restrict__ starts,
    const int* __restrict__ counts, const float* __restrict__ bg, int gy, int gx, int h, int w,
    float* __restrict__ image, float* __restrict__ t_final, float* __restrict__ p_raw,
    int* __restrict__ n_contrib, int* __restrict__ live) {
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned* s_f = reinterpret_cast<unsigned*>(smem);  // [WORDS][NPIX]: factors, then the scan
    unsigned* s_hit = s_f + WORDS * NPIX;                // [CHUNK / 32][NPIX]: hit bits
    float* s_row = reinterpret_cast<float*>(s_hit + (CHUNK / 32) * NPIX);  // [CHUNK][RSTRIDE]
    unsigned short* s_con = reinterpret_cast<unsigned short*>(s_row + CHUNK * RSTRIDE);  // [3][CHUNK] bf16 a, b, c
    unsigned* s_cand = reinterpret_cast<unsigned*>(s_con + 3 * CHUNK);  // [NWARP][CHUNK / 32]

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
    unsigned* col = s_f + t;
    unsigned* hitcol = s_hit + t;
    const int lane = t & 31, warp = t >> 5;
    unsigned* cand = s_cand + warp * (CHUNK / 32);
    const float x0 = (float)(tx * TILE), y0 = (float)(ty * TILE + 2 * warp);
    for (int c = 0; c < n_chunks; ++c) {
        // barrier: the previous window is walked before it is overwritten
        if (__syncthreads_count(done) == NPIX) break;
        const int first = c * CHUNK - lead;  // run position of slot 0
        const int lo = max(0, -first), hi = min(CHUNK, count - first);  // the run's slots
        if (t >= lo && t < hi) {
            const float* src = rows + (size_t)gid[start + first + t] * ROWS;
#pragma unroll
            for (int k = 0; k < ROWS; ++k) s_row[t * RSTRIDE + k] = src[k];
#pragma unroll
            for (int k = 0; k < 3; ++k) s_con[k * CHUNK + t] = bf16_bits(src[2 + k]);
        }
        __syncthreads();
        // the warp's candidates: the run's slots that a pixel of its 16x2
        // strip may hit (a warp whose pixels have all stopped takes none)
        const bool warp_live = __any_sync(FULL, !done);
#pragma unroll
        for (int k = 0; k < CHUNK / 32; ++k) {
            const int j = k * 32 + lane;
            const unsigned bal = __ballot_sync(
                FULL, warp_live && j >= lo && j < hi && strip_may_pass<true>(s_row + j * RSTRIDE, x0, y0));
            if (lane == 0) cand[k] = bal;
        }
        __syncwarp();
        if (done) continue;
        const unsigned* ca = reinterpret_cast<const unsigned*>(s_con);
        const unsigned* cb = ca + CHUNK / 2;
        const unsigned* cc = cb + CHUNK / 2;
        // the factors bf16(1 - alpha), two slots at a time, in the words of
        // the 32-slot groups that hold a candidate of the warp; (1, 1) where
        // neither slot of a word is a candidate (the other groups are not
        // written: the scan takes them as (1, 1))
        bool any = false;
        unsigned groups = 0;
        for (int k = 0; k < CHUNK / 32; ++k) {
            const unsigned cw = cand[k];  // the same in every lane
            unsigned bits = 0;
            if (cw != 0) {
                groups |= 1u << k;
                for (int mm = 0; mm < 16; ++mm) {
                    const unsigned pc = cw >> (2 * mm) & 3u;
                    const int j = k * 32 + 2 * mm;
                    unsigned word = BF16_ONE2;
                    if (pc != 0) {
                        const float* r0 = s_row + j * RSTRIDE;
                        const float* r1 = r0 + RSTRIDE;
                        const int m = j >> 1;
                        float p0, p1, e, alpha, f0 = 1.0f, f1 = 1.0f;
                        gate_power2(px - r0[0], px - r1[0], py - r0[1], py - r1[1], ca[m], cb[m], cc[m], p0, p1);
                        if ((pc & 1u) && gate_tail(p0, r0[5], e, alpha)) {
                            f0 = 1.0f - alpha;
                            bits |= 1u << (2 * mm);
                        }
                        if ((pc & 2u) && gate_tail(p1, r1[5], e, alpha)) {
                            f1 = 1.0f - alpha;
                            bits |= 2u << (2 * mm);
                        }
                        word = bf16_pack2(f0, f1);
                    }
                    col[(k * 16 + mm) * NPIX] = word;
                }
            }
            hitcol[k * NPIX] = bits;
            any |= bits != 0;
        }
        // a pixel without a hit in the window includes every slot at P: T
        // becomes P and P stays (its column, all ones, is neither scanned
        // nor read)
        if (!any) {
            T = P;
            continue;
        }
        scan_column(col, groups);
        // the walk over the window's slots, in order
        float least = __int_as_float(0x7f800000), prev = 1.0f;  // prev: the scan at the slot before (unrounded)
        bool keeps = false;                    // a slot is not included: the T before the window takes part
        for (int j = 0; j < CHUNK; ++j) {
            const float full = scan_full(col, j);
            const float pf = P * full;
            const bool incl = pf >= TRANSMITTANCE_EPS;
            if (incl) least = fminf(least, pf);
            else keeps = true;
            if (incl && (hitcol[(j >> 5) * NPIX] >> (j & 31) & 1u)) {
                const float* r = s_row + j * RSTRIDE;
                const unsigned pair = 0x00010001u * (unsigned)s_con[j];  // (a, a) for slot j alone
                const unsigned pb = 0x00010001u * (unsigned)s_con[CHUNK + j];
                const unsigned pc = 0x00010001u * (unsigned)s_con[2 * CHUNK + j];
                float power, unused, e, alpha;
                const float dx = px - r[0], dy = py - r[1];
                gate_power2(dx, dx, dy, dy, pair, pb, pc, power, unused);
                gate_tail(power, r[5], e, alpha);  // passes: the same expressions passed above
                const float rounded = j == 0 ? 1.0f : __bfloat162float(__float2bfloat16_rn(prev));
                const float wgt = alpha * (P * rounded);
                if (wgt > 0.0f) {
                    c0 += wgt * r[6];
                    c1 += wgt * r[7];
                    c2 += wgt * r[8];
                    last = first + j + 1;
                }
            }
            prev = full;
        }
        T = keeps ? fminf(T, least) : least;
        P = P * prev;  // the window's end: the unrounded scan at slot 255
        done = P < TRANSMITTANCE_EPS;
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
        composite_fwd_bf16_kernel<false><<<grid, NPIX, BF16_SMEM, (cudaStream_t)stream>>>(
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
        composite_fwd_bf16_kernel<true><<<grid, NPIX, BF16_SMEM, (cudaStream_t)stream>>>(
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

// The CTAs of a forward kernel that one SM holds at once (the CUDA
// occupancy calculator on its registers and shared memory), or minus the
// cudaError_t: bf16 selects the bf16 kernel, chained the CHAINED one.
extern "C" int composite_fwd_blocks_per_sm(int bf16, int chained) {
    int n = 0;
    cudaError_t err;
    if (bf16) {
        err = chained ? allow_bf16_smem<true>() : allow_bf16_smem<false>();
        if (err == cudaSuccess)
            err = chained ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, composite_fwd_bf16_kernel<true>, NPIX, BF16_SMEM)
                          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, composite_fwd_bf16_kernel<false>, NPIX, BF16_SMEM);
    } else {
        err = chained ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, composite_fwd_kernel<true>, NPIX, 0)
                      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, composite_fwd_kernel<false>, NPIX, 0);
    }
    return err == cudaSuccess ? n : -(int)err;
}

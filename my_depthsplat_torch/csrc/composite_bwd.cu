// Tile composite, backward: per-instance gradient of the 9 screen rows.
//
// Replaces the TPU kernel my_depthsplat_tpu/render/pallas_raster.py:_bwd_kernel
// (:322) in flat mode (chained=False), launched by _composite_bwd_impl (:577).
// The TPU kernel walked 128-lane-aligned windows of the packed instance array
// back to front with double-buffered DMAs, rebuilt the transmittance of a
// whole chunk with doubling scans, and read-modify-wrote the windows that
// straddle two tiles' runs. None of that is carried over. Here one CTA of
// 256 threads owns one (view, tile), one thread per pixel, as the forward
// kernel does; the tile's live range (up to the largest n_contrib of its
// pixels) is staged 64 instances at a time, from its end, into shared memory
// through the sorted gaussian-id list, and every pixel walks the batch
// backwards in registers (pallas_raster.py:441-503):
//     alpha and the gates exactly as composite_fwd.cu, and the instance's
//     1-based position <= n_contrib[pixel];
//     om  = max(1 - alpha, 1e-6)
//     T_i = T_after / om                  (starting from T_final[pixel])
//     w   = alpha * T_i,   gc = g . colour_i
//     da  = T_i * gc - g_dot_r / om       (g_dot_r: g . colour behind i,
//                                          seeded with (g . bg) * T_final)
//     d_op = exp(power) * da,  d_power = op * exp(power) * da   (the 0.99
//     clamp is ignored in the gradient, as the JAX kernel ignores it)
//     d_x, d_y, d_conic from d_power;  d_colour = w * g
// Gate rule: power and alpha are computed with the same expressions in the
// same order as composite_fwd.cu (the whole library builds with -fmad=false,
// expf, no fast math; the gate's constants and the cull helpers are
// composite_common.cuh, which both sources include), so the backward counts
// exactly the hits the forward counted; an instance the forward skipped
// contributes nothing here.
//
// The same kernel, instantiated with CHAINED, replaces _bwd_kernel's chained
// mode (carry_in/carry_out; :342-344, :368-377, :521-526), launched once per
// depth group by _render_grouped_bwd (:752) as it walks a view's groups
// farthest first. The TPU kernel read and wrote a tile-major (gy, gx, 256, 8)
// carry block; here the carry is two image-layout arrays that the kernel
// updates in place: ta (B, H, W), the transmittance after the group's last
// included instance, and g_dot_ra (B, H, W), g . (colour behind it). The
// walk is the flat one from the carried ta instead of T_final and from the
// carried g_dot_ra instead of (g . bg) * T_final, with the group-LOCAL
// n_contrib (what the chained forward returned for the group) as the
// positional mask; on exit a pixel's ta is the transmittance before the
// group's first instance and its g_dot_ra includes the group's colour. A
// pixel with n_contrib = 0 reads neither its cotangent nor its carry, and
// its carry passes through unwritten. No background, no T_final. Walking
// the groups farthest first repeats the flat kernel's divisions and
// additions in the same order, so grouped and flat gradients agree to
// rounding: kernel D sums each group apart. A group where no pixel is live
// is not launched at all (pallas_raster.py, _GroupedComposite.backward).
//
// What bounds it on the H100. Flat (kernel C, a training batch of many small
// views): operations, the instance x pixel evaluations up to n_contrib (~12
// float operations for the gate of each, ~38 more for each gated hit,
// against 67 TFLOP/s of non-tensor float32). Chained (row 5, a 512x960 view
// in 2^18-gaussian groups, launched for the live groups only): bytes, most
// of them the 36 B of output row of every instance (written once, as zeros
// where no pixel reaches it), the rest the reads of the live instances (4 B
// of id, 8 B of destination, 36 B per referenced gaussian) and of the live
// pixels (12 B of cotangent, 8 B of carry read and written, 4 B of
// n_contrib).
//
// Design.
// - Zero-fill: the wrapper allocates the output with torch.zeros (one
//   contiguous memset), and the kernel writes only the rows of instances up
//   to its tile's live range, each once, through the destination. A tile
//   whose live range is 0 returns after reading its n_contrib.
// - Walk: a warp evaluates only the instances up to its own 32 pixels'
//   largest n_contrib, and of those only the ones that some pixel of its
//   16x2 strip may hit: before the walk of a batch its 32 lanes test 32
//   instances at a time, the concave power's largest value over the strip
//   against logf(ALPHA_MIN / op) with a margin (strip_may_pass), and a
//   ballot gives the warp the instances to walk. A pair whose power is below
//   -5.55 (opacity <= 1) fails the alpha gate without expf. A warp's
//   partials are zeroed before its walk of a batch, and a warp in which no
//   pixel hits an instance neither shuffles nor stores. None of this
//   changes a sum: the gate decides every pair as composite_fwd.cu does.
// - Reduction: the 9 values of an instance are summed over the tile's 256
//   pixels in two levels. Inside a warp, values 0-7 go through a transposing
//   butterfly (xor 16, 8, 4: each step a lane keeps half of its values and
//   trades the other half with its partner, 4 + 2 + 1 shuffles) that leaves
//   lane l with value l/4 summed over 8 lanes, then xor 2 and 1; value 8
//   takes a plain xor butterfly: 14 shuffles per warp and instance instead
//   of 45 (9 values x 5 steps). A warp in which no pixel hits skips them.
//   Across warps, the 8 per-warp partials stay in shared memory and one
//   thread per output value adds them in warp order. Every addition happens
//   in a fixed order, so the result is bit-reproducible; no atomics.
// - Staging: a three-stage pipeline with one __syncthreads per batch, the
//   same in both instantiations. While batch q is walked, cp.async copies
//   are in flight for batch q+1's rows (4-byte copies: a 36-byte row is only
//   4-byte aligned, gathered through the ids) and for batch q+2's ids and
//   destinations (contiguous), and the output rows of batch q-1 are summed
//   and written.
//   Rows, partials and ids are double-buffered, destinations in 4 buffers (a
//   batch's destination is staged two batches ahead and read one behind).
// - No TMA: Hopper's tensor maps copy regular boxes of a tensor, and the row
//   copy is an indirect gather through the ids; the contiguous ids and
//   destinations are 256 B and 512 B per batch, too small to pay for a
//   tensor map and an mbarrier.
// - No tensor cores: the per-instance sums must stay within 1e-5 of the
//   float32 plain version's largest entry, and TF32 keeps about three
//   digits; besides, the per-pixel terms live one per thread, so feeding
//   mma fragments would cost a pass through shared memory per batch.
//
// Instance l's row goes to d_inst[dst[l]]: the caller passes the key sort's
// permutation, so the rows land in gaussian-major order for the segmented
// reduction that follows (scatter_reduce.cu).
//
// bfloat16 (composite_bwd_bf16, composite_bwd_chained_bf16; the reference's
// composite_dtype="bfloat16", pallas_raster.py:354-503), redesigned for
// Hopper: composite_bwd_bf16_kernel below, a kernel of its own. Per the
// reference, a run is walked in windows of 256 slots of the launch's
// instance array starting at start - start % 128, farthest first; in a
// window T_i = (ta / Q) s_(i-1), s the doubling scan (shifts 1, 2, ..., 128,
// each a bf16 multiply, the last kept unrounded as the jitted reference
// widens it) of bf16(max(1 - alpha, 1e-6)) over the pixel's hits up to its
// n_contrib (1 elsewhere), Q its value at slot 255. The scan needs no
// forward walk and no division per hit: the reference's formula is built
// for a back-to-front walk. Per window:
// - staging: the window's rows (read through the ids) and destinations in
//   shared memory, one slot a thread; the next window's rows are copied by
//   cp.async while this one is walked (two buffers);
// - candidates: each warp tests the slots below its pixels' largest
//   n_contrib against its 16x2 strip (strip_may_pass with the bf16 slack),
//   8 ballots;
// - factors (the first of two gate evaluations): each thread (pixel) gates
//   the candidate slots two at a time, the quadratic on packed bf16x2
//   (gate_power2, composite_common.cuh), and writes the factors into its
//   own column of a 256 x 256 bf16 table (a word of two slots), in the
//   32-slot groups that hold a candidate of its warp below its n_contrib
//   (a non-candidate word there is (1, 1); the other groups are not
//   written), and one hit bit a slot;
// - scan: each thread scans its column in registers: the 128 words read
//   once, 1,665 bf16 multiplies on 833 packed bf16x2 words over 7 levels
//   (shift 1 within and across words, then word shifts 1 to 32, from the
//   top so that every partner is read before it is overwritten), written
//   back once (the groups not written are taken as (1, 1)); a column
//   without a hit is neither scanned nor read. (Scanned in place in
//   shared memory, a word read and written per multiply, it took 1,666
//   shared-memory accesses a pixel and window against 256.) The last level
//   (shift 128) is the float32 product of two table entries, formed where
//   it is read: Q at slot 255, s_(i-1) at a hit;
// - walk (the second evaluation, for hits only): the window's batches of
//   64 slots that hold live slots, from the top; a warp visits the slots
//   where one of its pixels hits (the OR of their hit bits), and the rows
//   are summed and written as in the float32 kernel (warp_sum_rows, the 8
//   warps' partials added in warp order, no atomics), with one barrier a
//   batch (partials in two buffers).
// Nothing passes through the rows in global memory more than once, and the
// gate is evaluated at most twice a pair. What bounds it: the table. Every
// pixel needs its 256 scanned bf16 values (512 B) while its window is
// walked, so a CTA holds 198,912 B of dynamic shared memory (the table 128
// KB, rows 18 KB, destinations 4 KB, partials 36 KB, hit bits 8 KB,
// candidates 256 B) and an SM one CTA (8 warps; 113 registers a thread),
// against four of the float32 kernel (44 KB, 64 registers). At that
// occupancy the walk's latencies are not hidden, and the bf16 kernel does
// more per pair than the float32 one (the factor pass, the second gate of
// a hit, the scan); PERF.md has its times beside the float32 kernel's. The
// colour behind, the row gradients and the carries are float32, as in the
// float32 kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite_common.cuh"

namespace {

using namespace composite;

constexpr int BATCH = 64;  // instances staged per step

// One transposing step over 2H values: a lane with bit 4H set keeps values
// H..2H-1 (moved to 0..H-1) and sends 0..H-1; its partner the reverse.
template <int H>
__device__ __forceinline__ void fold(float (&a)[8], int lane) {
    const bool up = lane & (4 * H);
#pragma unroll
    for (int i = 0; i < H; ++i) {
        const float send = up ? a[i] : a[i + H];
        const float keep = up ? a[i + H] : a[i];
        a[i] = keep + __shfl_xor_sync(FULL, send, 4 * H);
    }
}

// The warp's sums of v[0..8] into out[0..8] (shared memory). The partials
// are zero before the walk, and a warp without a hit stores nothing.
__device__ __forceinline__ void warp_sum_rows(const float (&v)[ROWS], bool hit, int lane, float* out) {
    if (!__any_sync(FULL, hit)) return;
    float a[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] = v[k];
    fold<4>(a, lane);
    fold<2>(a, lane);
    fold<1>(a, lane);
    float r = a[0];  // value lane / 4, summed over the 8 lanes that share lane % 4
    r += __shfl_xor_sync(FULL, r, 2);
    r += __shfl_xor_sync(FULL, r, 1);
    float r8 = v[8];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) r8 += __shfl_xor_sync(FULL, r8, s);
    if ((lane & 3) == 0) out[lane >> 2] = r;
    if (lane == 1) out[8] = r8;
}

template <bool CHAINED>
__global__ void __launch_bounds__(NPIX) composite_bwd_kernel(
    const float* __restrict__ rows,      // (N, 9) per-gaussian screen rows
    const int* __restrict__ gid,         // (L,) sorted instance -> gaussian
    const int64_t* __restrict__ dst,     // (L,) sorted instance -> output row
    const int* __restrict__ starts,      // (B * gy * gx,)
    const int* __restrict__ counts,      // (B * gy * gx,)
    const float* __restrict__ bg,        // (B, 3); unused when CHAINED
    const float* __restrict__ t_final,   // (B, H, W); unused when CHAINED
    const int* __restrict__ n_contrib,   // (B, H, W); group-local when CHAINED
    const float* __restrict__ g_img,     // (B, H, W, 3) image cotangent
    int gy, int gx, int h, int w,
    float* __restrict__ ta_carry,        // (B, H, W) in and out; CHAINED only
    float* __restrict__ gdr_carry,       // (B, H, W) in and out; CHAINED only
    float* __restrict__ d_inst) {        // (L, 9), zero on entry
    __shared__ float s_row[2][BATCH * ROWS];
    __shared__ __align__(16) float s_part[2][NWARP][BATCH * ROWS];
    __shared__ int s_gid[2][BATCH];
    __shared__ int64_t s_dst[4][BATCH];
    __shared__ int s_max[NWARP];

    const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
    const int tile = (b * gy + ty) * gx + tx;
    const int t = threadIdx.x;
    const int lane = t & 31, warp = t >> 5;
    const int pxi = tx * TILE + t % TILE;
    const int pyi = ty * TILE + t / TILE;
    const bool inside = pxi < w && pyi < h;
    const float px = (float)pxi;
    const float py = (float)pyi;
    const int start = starts[tile];
    const int count = counts[tile];
    if (count == 0) return;

    const size_t p = ((size_t)b * h + pyi) * w + pxi;  // meaningful if inside
    int ncon = 0;
    float T = 1.0f, g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
    // g . (colour behind the current instance)
    float gdr = 0.0f;
    if (inside) ncon = n_contrib[p];
    // a pixel without a contributor never hits: nothing else of it is read
    if (ncon > 0) {
        g0 = g_img[3 * p + 0];
        g1 = g_img[3 * p + 1];
        g2 = g_img[3 * p + 2];
        if (CHAINED) {
            T = ta_carry[p];
            gdr = gdr_carry[p];
        } else {
            // seeded by the background term
            T = t_final[p];
            gdr = (g0 * bg[3 * b + 0] + g1 * bg[3 * b + 1] + g2 * bg[3 * b + 2]) * T;
        }
    }

    const int wmax = __reduce_max_sync(FULL, ncon);
    if (lane == 0) s_max[warp] = wmax;
    __syncthreads();
    int live = 0;
#pragma unroll
    for (int k = 0; k < NWARP; ++k) live = max(live, s_max[k]);
    live = min(live, count);
    // instances past the live range keep their zero rows
    if (live == 0) return;

    // batch q of the walk: instances [base(q), base(q) + size(q)) of the run,
    // batch 0 the last ones
    const int nq = (live + BATCH - 1) / BATCH;
    auto base_of = [&](int q) { return (nq - 1 - q) * BATCH; };
    auto size_of = [&](int q) { return min(BATCH, live - base_of(q)); };
    auto stage_ids = [&](int q) {
        if (q < nq && t < size_of(q)) {
            const int l = start + base_of(q) + t;
            copy_async(&s_gid[q & 1][t], gid + l);
            copy_async(&s_dst[q & 3][t], dst + l);
        }
    };
    auto stage_rows = [&](int q) {
        if (q >= nq) return;
        const int n = size_of(q);
        for (int i = t; i < n * ROWS; i += NPIX)
            copy_async(&s_row[q & 1][i], rows + (size_t)s_gid[q & 1][i / ROWS] * ROWS + i % ROWS);
    };
    // the 8 warps' partials of batch q, added in warp order, to the output
    auto write_rows = [&](int q) {
        const int n = size_of(q);
        for (int i = t; i < n * ROWS; i += NPIX) {
            float sum = 0.0f;
#pragma unroll
            for (int k = 0; k < NWARP; ++k) sum += s_part[q & 1][k][i];
            d_inst[s_dst[q & 3][i / ROWS] * ROWS + i % ROWS] = sum;
        }
    };

    stage_ids(0);
    wait_copies();
    __syncthreads();
    stage_ids(1);
    stage_rows(0);
    for (int q = 0; q < nq; ++q) {
        // batch q's rows and batch q+1's ids have landed; batch q-1's
        // partials are complete; every reader of the buffers refilled below
        // (rows of q-1, ids of q, destinations of q-2, partials of q-2) is done
        wait_copies();
        __syncthreads();
        stage_ids(q + 2);
        stage_rows(q + 1);
        if (q > 0) write_rows(q - 1);

        const int base = base_of(q);
        const float* s = s_row[q & 1];
        float* part = s_part[q & 1][warp];
        const int n = size_of(q);
        // the warp walks up to its own pixels' largest n_contrib; past it
        // its partials stay zero
        const int m = max(0, min(n, wmax - base));
        for (int i = lane; i < BATCH * ROWS / 4; i += 32)
            reinterpret_cast<float4*>(part)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        __syncwarp();
        // the instances of 0..m-1 that a pixel of the warp's 16x2 strip may
        // hit, one lane testing each; walked last first
        const float x0 = (float)(tx * TILE), y0 = (float)(ty * TILE + 2 * warp);
        const unsigned lo = __ballot_sync(FULL, lane < m && strip_may_pass(s + lane * ROWS, x0, y0));
        const unsigned hi = __ballot_sync(FULL, lane + 32 < m && strip_may_pass(s + (lane + 32) * ROWS, x0, y0));
        unsigned long long todo = (unsigned long long)hi << 32 | lo;
        while (todo) {
            const int j = 63 - __clzll(todo);
            todo ^= 1ull << j;
            const float* r = s + j * ROWS;
            float v[ROWS];
            bool hit = false;
            if (base + j < ncon) {
                const float dx = px - r[0];
                const float dy = py - r[1];
                const float ca = r[2], cb = r[3], cc = r[4], op = r[5];
                const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
                if (power <= 0.0f && may_pass(power, op)) {
                    const float e = expf(power);
                    const float u = op * e;
                    const float alpha = u > ALPHA_MAX ? ALPHA_MAX : u;
                    if (alpha >= ALPHA_MIN) {
                        hit = true;
                        const float om = fmaxf(1.0f - alpha, 1e-6f);
                        const float t_i = T / om;
                        const float wgt = alpha * t_i;
                        const float gc = g0 * r[6] + g1 * r[7] + g2 * r[8];
                        const float da = t_i * gc - gdr / om;
                        const float d_power = op * e * da;
                        v[0] = d_power * (ca * dx + cb * dy);
                        v[1] = d_power * (cc * dy + cb * dx);
                        v[2] = d_power * (-0.5f * dx * dx);
                        v[3] = d_power * (-dx * dy);
                        v[4] = d_power * (-0.5f * dy * dy);
                        v[5] = e * da;
                        v[6] = wgt * g0;
                        v[7] = wgt * g1;
                        v[8] = wgt * g2;
                        gdr += gc * wgt;
                        T = t_i;
                    }
                }
            }
            if (!hit) {
#pragma unroll
                for (int k = 0; k < ROWS; ++k) v[k] = 0.0f;
            }
            warp_sum_rows(v, hit, lane, part + j * ROWS);
        }
    }
    __syncthreads();
    write_rows(nq - 1);
    if (CHAINED && ncon > 0) {
        ta_carry[p] = T;
        gdr_carry[p] = gdr;
    }
}

// ---- bfloat16 ----

constexpr int HITW = CHUNK / 32;  // hit-bit words per pixel
constexpr size_t BF16_SMEM = (size_t)WORDS * NPIX * 4  // the table
                             + 2 * CHUNK * 8            // destinations, two windows
                             + 2 * NWARP * BATCH * ROWS * 4  // partials, two batches
                             + 2 * CHUNK * ROWS * 4     // rows, two windows
                             + HITW * NPIX * 4          // hit bits
                             + NWARP * HITW * 4;        // candidates

template <bool CHAINED>
__global__ void __launch_bounds__(NPIX, 1) composite_bwd_bf16_kernel(
    const float* __restrict__ rows, const int* __restrict__ gid, const int64_t* __restrict__ dst,
    const int* __restrict__ starts, const int* __restrict__ counts, const float* __restrict__ bg,
    const float* __restrict__ t_final, const int* __restrict__ n_contrib, const float* __restrict__ g_img,
    int gy, int gx, int h, int w, float* __restrict__ ta_carry, float* __restrict__ gdr_carry,
    float* __restrict__ d_inst) {
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned* s_f = reinterpret_cast<unsigned*>(smem);                    // [WORDS][NPIX]: factors, then the scan
    int64_t* s_dst = reinterpret_cast<int64_t*>(s_f + WORDS * NPIX);      // [2][CHUNK]
    float* s_part = reinterpret_cast<float*>(s_dst + 2 * CHUNK);          // [2][NWARP][BATCH * ROWS]
    float* s_row = s_part + 2 * NWARP * BATCH * ROWS;                     // [2][CHUNK * ROWS]
    unsigned* s_hit = reinterpret_cast<unsigned*>(s_row + 2 * CHUNK * ROWS);  // [HITW][NPIX]
    unsigned* s_cand = s_hit + HITW * NPIX;                               // [NWARP][HITW]
    __shared__ int s_max[NWARP];

    const int tx = blockIdx.x, ty = blockIdx.y, b = blockIdx.z;
    const int tile = (b * gy + ty) * gx + tx;
    const int t = threadIdx.x;
    const int lane = t & 31, warp = t >> 5;
    const int pxi = tx * TILE + t % TILE;
    const int pyi = ty * TILE + t / TILE;
    const bool inside = pxi < w && pyi < h;
    const float px = (float)pxi;
    const float py = (float)pyi;
    const int start = starts[tile];
    const int count = counts[tile];
    if (count == 0) return;

    const size_t p = ((size_t)b * h + pyi) * w + pxi;
    int ncon = 0;
    float T = 1.0f, g0 = 0.0f, g1 = 0.0f, g2 = 0.0f, gdr = 0.0f;
    if (inside) ncon = n_contrib[p];
    if (ncon > 0) {
        g0 = g_img[3 * p + 0];
        g1 = g_img[3 * p + 1];
        g2 = g_img[3 * p + 2];
        if (CHAINED) {
            T = ta_carry[p];
            gdr = gdr_carry[p];
        } else {
            T = t_final[p];
            gdr = (g0 * bg[3 * b + 0] + g1 * bg[3 * b + 1] + g2 * bg[3 * b + 2]) * T;
        }
    }
    const int wmax = __reduce_max_sync(FULL, ncon);
    if (lane == 0) s_max[warp] = wmax;
    __syncthreads();
    int live = 0;
#pragma unroll
    for (int k = 0; k < NWARP; ++k) live = max(live, s_max[k]);
    live = min(live, count);
    if (live == 0) return;

    const int lead = start % ALIGN;
    const int n_chunks = (lead + live + CHUNK - 1) / CHUNK;
    unsigned* col = s_f + t;
    unsigned* hitcol = s_hit + t;
    unsigned* cand = s_cand + warp * HITW;
    const float x0 = (float)(tx * TILE), y0 = (float)(ty * TILE + 2 * warp);
    // window c's slots of the live range: [lo, hi) (run positions first + slot)
    auto first_of = [&](int c) { return c * CHUNK - lead; };
    auto lo_of = [&](int c) { return max(0, lead - c * CHUNK); };
    auto hi_of = [&](int c) { return min(CHUNK, live - first_of(c)); };
    // window c's rows (through the ids) by cp.async, its destinations by a
    // plain store, into buffer c & 1; the id is loaded before (idv)
    auto stage_rows = [&](int c, int idv, int64_t dv) {
        if (c < 0 || t < lo_of(c) || t >= hi_of(c)) return;
        float* dstrow = s_row + (c & 1) * CHUNK * ROWS + t * ROWS;
        const float* src = rows + (size_t)idv * ROWS;
#pragma unroll
        for (int k = 0; k < ROWS; ++k) copy_async(dstrow + k, src + k);
        s_dst[(c & 1) * CHUNK + t] = dv;
    };
    {
        const int c = n_chunks - 1;
        int idv = 0;
        int64_t dv = 0;
        if (t >= lo_of(c) && t < hi_of(c)) {
            idv = gid[start + first_of(c) + t];
            dv = dst[start + first_of(c) + t];
        }
        stage_rows(c, idv, dv);
    }
    for (int c = n_chunks - 1; c >= 0; --c) {
        const int first = first_of(c), lo = lo_of(c), hi = hi_of(c);
        // window c's rows have landed; every reader of the buffers refilled
        // below (window c + 1's rows and destinations) is done
        wait_copies();
        __syncthreads();
        // the next window's id and destination, used after the factors
        int idn = 0;
        int64_t dn = 0;
        if (c > 0 && t >= lo_of(c - 1) && t < hi_of(c - 1)) {
            idn = gid[start + first_of(c - 1) + t];
            dn = dst[start + first_of(c - 1) + t];
        }
        const float* srow = s_row + (c & 1) * CHUNK * ROWS;
        const int64_t* sdst = s_dst + (c & 1) * CHUNK;
        // the warp's candidates: slots below its pixels' largest n_contrib
        // that a pixel of its strip may hit
        const int top = min(hi, wmax - first);
#pragma unroll
        for (int k = 0; k < HITW; ++k) {
            const int j = k * 32 + lane;
            const unsigned bal =
                __ballot_sync(FULL, j >= lo && j < top && strip_may_pass<true>(srow + j * ROWS, x0, y0));
            if (lane == 0) cand[k] = bal;
        }
        __syncwarp();
        // the factors bf16(max(1 - alpha, 1e-6)) of the pixel's hits below
        // its n_contrib, two slots at a time, in the words of the 32-slot
        // groups that hold a candidate of the warp; (1, 1) where neither slot
        // of a word is a candidate
        const int mine = ncon - first;
        bool any = false;
        unsigned groups = 0;
        for (int k = 0; k < HITW; ++k) {
            const unsigned cw = cand[k];  // the same in every lane
            unsigned bits = 0;
            if (cw == 0 || mine <= k * 32) {
                hitcol[k * NPIX] = 0;
                continue;
            }
            groups |= 1u << k;
#pragma unroll 2
            for (int mm = 0; mm < 16; ++mm) {
                const unsigned pc = cw >> (2 * mm) & 3u;
                const int j = k * 32 + 2 * mm;
                unsigned word = BF16_ONE2;
                if (pc != 0 && j < mine) {
                    const float* r0 = srow + j * ROWS;
                    const float* r1 = r0 + ROWS;
                    float p0, p1, e, alpha, f0 = 1.0f, f1 = 1.0f;
                    gate_power2(px - r0[0], px - r1[0], py - r0[1], py - r1[1], bf16_pack2(r0[2], r1[2]),
                                bf16_pack2(r0[3], r1[3]), bf16_pack2(r0[4], r1[4]), p0, p1);
                    if ((pc & 1u) && gate_tail(p0, r0[5], e, alpha)) {
                        f0 = fmaxf(1.0f - alpha, 1e-6f);
                        bits |= 1u << (2 * mm);
                    }
                    if ((pc & 2u) && j + 1 < mine && gate_tail(p1, r1[5], e, alpha)) {
                        f1 = fmaxf(1.0f - alpha, 1e-6f);
                        bits |= 2u << (2 * mm);
                    }
                    word = bf16_pack2(f0, f1);
                }
                col[(k * 16 + mm) * NPIX] = word;
            }
            hitcol[k * NPIX] = bits;
            any |= bits != 0;
        }
        // a column without a hit is all ones, its own scan: it is neither
        // scanned nor read
        if (any) scan_column(col, groups);
        const float ta_before = any ? T / scan_full(col, CHUNK - 1) : T;
        // the next window's rows land while this one is walked
        stage_rows(c - 1, idn, dn);
        // the walk, back to front, a batch of 64 slots at a time, over the
        // batches that hold live slots; partials in two buffers, so that
        // one barrier a batch orders the walk, the sums and the next zeroing
        for (int q = (hi - 1) / BATCH; q >= lo / BATCH; --q) {
            float* part = s_part + ((q & 1) * NWARP + warp) * BATCH * ROWS;
            for (int i = lane; i < BATCH * ROWS / 4; i += 32)
                reinterpret_cast<float4*>(part)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            __syncwarp();
            const unsigned mlo = hitcol[(2 * q) * NPIX], mhi = hitcol[(2 * q + 1) * NPIX];
            const unsigned long long mask = (unsigned long long)mhi << 32 | mlo;
            // the slots where a pixel of the warp hits, last first
            unsigned long long todo =
                (unsigned long long)__reduce_or_sync(FULL, mhi) << 32 | __reduce_or_sync(FULL, mlo);
            while (todo) {
                const int jj = 63 - __clzll(todo);
                todo ^= 1ull << jj;
                const int j = q * BATCH + jj;
                float v[ROWS];
                const bool hit = mask >> jj & 1ull;
                if (hit) {
                    const float* r = srow + j * ROWS;
                    const float ca_ = r[2], cb_ = r[3], cc_ = r[4], op = r[5];
                    const float dx = px - r[0], dy = py - r[1];
                    float power, unused, e, alpha;
                    gate_power2(dx, dx, dy, dy, bf16_pack2(ca_, ca_), bf16_pack2(cb_, cb_), bf16_pack2(cc_, cc_),
                                power, unused);
                    gate_tail(power, op, e, alpha);  // passes: the same expressions passed above
                    const float om = fmaxf(1.0f - alpha, 1e-6f);
                    const float t_i = ta_before * (j == 0 ? 1.0f : scan_full(col, j - 1));
                    const float wgt = alpha * t_i;
                    const float gc = g0 * r[6] + g1 * r[7] + g2 * r[8];
                    const float da = t_i * gc - gdr / om;
                    const float d_power = op * e * da;
                    v[0] = d_power * (ca_ * dx + cb_ * dy);
                    v[1] = d_power * (cc_ * dy + cb_ * dx);
                    v[2] = d_power * (-0.5f * dx * dx);
                    v[3] = d_power * (-dx * dy);
                    v[4] = d_power * (-0.5f * dy * dy);
                    v[5] = e * da;
                    v[6] = wgt * g0;
                    v[7] = wgt * g1;
                    v[8] = wgt * g2;
                    gdr += gc * wgt;
                } else {
#pragma unroll
                    for (int k = 0; k < ROWS; ++k) v[k] = 0.0f;
                }
                warp_sum_rows(v, hit, lane, part + jj * ROWS);
            }
            __syncthreads();
            // the batch's rows: the 8 warps' partials added in warp order
            const float* parts = s_part + (q & 1) * NWARP * BATCH * ROWS;
            const int b0 = max(lo, q * BATCH), b1 = min(hi, (q + 1) * BATCH);
            for (int i = t; i < (b1 - b0) * ROWS; i += NPIX) {
                const int jj = b0 - q * BATCH + i / ROWS, k = i % ROWS;
                float sum = 0.0f;
#pragma unroll
                for (int u = 0; u < NWARP; ++u) sum += parts[(u * BATCH + jj) * ROWS + k];
                d_inst[sdst[q * BATCH + jj] * ROWS + k] = sum;
            }
        }
        T = ta_before;
    }
    if (CHAINED && ncon > 0) {
        ta_carry[p] = T;
        gdr_carry[p] = gdr;
    }
}

template <bool CHAINED, bool BF16>
int launch(
    const float* rows, const int* gid, const int64_t* dst, const int* starts, const int* counts,
    const float* bg, const float* t_final, const int* n_contrib, const float* g_img, int b, int gy,
    int gx, int h, int w, float* ta, float* g_dot_ra, float* d_inst, void* stream) {
    const dim3 grid(gx, gy, b);
    if constexpr (BF16) {
        // above the 48 KB of shared memory a launch gets unasked
        const cudaError_t err = cudaFuncSetAttribute(
            composite_bwd_bf16_kernel<CHAINED>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BF16_SMEM);
        if (err != cudaSuccess) return (int)err;
        composite_bwd_bf16_kernel<CHAINED><<<grid, NPIX, BF16_SMEM, (cudaStream_t)stream>>>(
            rows, gid, dst, starts, counts, bg, t_final, n_contrib, g_img, gy, gx, h, w, ta, g_dot_ra, d_inst);
    } else {
        composite_bwd_kernel<CHAINED><<<grid, NPIX, 0, (cudaStream_t)stream>>>(
            rows, gid, dst, starts, counts, bg, t_final, n_contrib, g_img, gy, gx, h, w, ta, g_dot_ra, d_inst);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int composite_bwd(
    const float* rows, const int* gid, const int64_t* dst, const int* starts,
    const int* counts, const float* bg, const float* t_final, const int* n_contrib,
    const float* g_img, int b, int gy, int gx, int h, int w, float* d_inst,
    void* stream) {
    return launch<false, false>(rows, gid, dst, starts, counts, bg, t_final, n_contrib, g_img, b, gy, gx, h, w,
                                nullptr, nullptr, d_inst, stream);
}

// The bf16 kernel, same arguments.
extern "C" int composite_bwd_bf16(
    const float* rows, const int* gid, const int64_t* dst, const int* starts,
    const int* counts, const float* bg, const float* t_final, const int* n_contrib,
    const float* g_img, int b, int gy, int gx, int h, int w, float* d_inst,
    void* stream) {
    return launch<false, true>(rows, gid, dst, starts, counts, bg, t_final, n_contrib, g_img, b, gy, gx, h, w,
                               nullptr, nullptr, d_inst, stream);
}

// One depth group of the reverse walk: resumed from, and written back into,
// the carry arrays ta and g_dot_ra; n_contrib is the group's own.
extern "C" int composite_bwd_chained(
    const float* rows, const int* gid, const int64_t* dst, const int* starts,
    const int* counts, const int* n_contrib, const float* g_img, int b, int gy,
    int gx, int h, int w, float* ta, float* g_dot_ra, float* d_inst, void* stream) {
    return launch<true, false>(rows, gid, dst, starts, counts, nullptr, nullptr, n_contrib, g_img, b, gy, gx, h, w,
                               ta, g_dot_ra, d_inst, stream);
}

// The bf16 kernel, same arguments.
extern "C" int composite_bwd_chained_bf16(
    const float* rows, const int* gid, const int64_t* dst, const int* starts,
    const int* counts, const int* n_contrib, const float* g_img, int b, int gy,
    int gx, int h, int w, float* ta, float* g_dot_ra, float* d_inst, void* stream) {
    return launch<true, true>(rows, gid, dst, starts, counts, nullptr, nullptr, n_contrib, g_img, b, gy, gx, h, w,
                              ta, g_dot_ra, d_inst, stream);
}

// What a backward kernel holds on the card (kernel_resources,
// composite_common.cuh): out[0..5] = threads a CTA, registers a thread,
// local memory a thread, static and dynamic shared memory a CTA, CTAs an SM.
// bf16 selects the bf16 kernel, chained the CHAINED one. Returns the
// cudaError_t.
extern "C" int composite_bwd_resources(int bf16, int chained, int* out) {
    if (bf16) {
        const cudaError_t err = chained ? cudaFuncSetAttribute(composite_bwd_bf16_kernel<true>,
                                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BF16_SMEM)
                                        : cudaFuncSetAttribute(composite_bwd_bf16_kernel<false>,
                                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BF16_SMEM);
        if (err != cudaSuccess) return (int)err;
        return chained ? kernel_resources(composite_bwd_bf16_kernel<true>, NPIX, (int)BF16_SMEM, out)
                       : kernel_resources(composite_bwd_bf16_kernel<false>, NPIX, (int)BF16_SMEM, out);
    }
    return chained ? kernel_resources(composite_bwd_kernel<true>, NPIX, 0, out)
                   : kernel_resources(composite_bwd_kernel<false>, NPIX, 0, out);
}

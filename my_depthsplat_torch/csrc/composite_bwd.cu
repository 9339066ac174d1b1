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

}  // namespace

extern "C" int composite_bwd(
    const float* rows, const int* gid, const int64_t* dst, const int* starts,
    const int* counts, const float* bg, const float* t_final, const int* n_contrib,
    const float* g_img, int b, int gy, int gx, int h, int w, float* d_inst,
    void* stream) {
    const dim3 grid(gx, gy, b);
    composite_bwd_kernel<false><<<grid, NPIX, 0, (cudaStream_t)stream>>>(
        rows, gid, dst, starts, counts, bg, t_final, n_contrib, g_img, gy, gx, h, w,
        nullptr, nullptr, d_inst);
    return (int)cudaGetLastError();
}

// One depth group of the reverse walk: resumed from, and written back into,
// the carry arrays ta and g_dot_ra; n_contrib is the group's own.
extern "C" int composite_bwd_chained(
    const float* rows, const int* gid, const int64_t* dst, const int* starts,
    const int* counts, const int* n_contrib, const float* g_img, int b, int gy,
    int gx, int h, int w, float* ta, float* g_dot_ra, float* d_inst, void* stream) {
    const dim3 grid(gx, gy, b);
    composite_bwd_kernel<true><<<grid, NPIX, 0, (cudaStream_t)stream>>>(
        rows, gid, dst, starts, counts, nullptr, nullptr, n_contrib, g_img, gy, gx, h, w,
        ta, g_dot_ra, d_inst);
    return (int)cudaGetLastError();
}

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
//     alpha and the gates exactly as composite_fwd.cu (same expression order,
//     -fmad=false), and the instance's 1-based position <= n_contrib[pixel];
//     om  = max(1 - alpha, 1e-6)
//     T_i = T_after / om                  (starting from T_final[pixel])
//     w   = alpha * T_i,   gc = g . colour_i
//     da  = T_i * gc - g_dot_r / om       (g_dot_r: g . colour behind i,
//                                          seeded with (g . bg) * T_final)
//     d_op = exp(power) * da,  d_power = op * exp(power) * da   (the 0.99
//     clamp is ignored in the gradient, as the JAX kernel ignores it)
//     d_x, d_y, d_conic from d_power;  d_colour = w * g
// The 9 values of an instance are summed over the tile's 256 pixels: warp
// shuffles, then one partial per warp in shared memory (a warp in which no
// pixel contributes writes zeros without shuffling), then a fixed-order sum
// across the 8 warps. Every instance belongs to exactly one tile, so each
// output row is written exactly once, by one CTA, in a fixed order: no
// atomics, no zero-initialised output, and the result is bit-reproducible.
// Instances past the live range get zero rows. Instance l's row goes to
// d_inst[dst[l]]: the caller passes the key sort's permutation, so the rows
// land in gaussian-major order for the segmented reduction that follows
// (scatter_reduce.cu).
//
// Bound on the H100: the instance x pixel evaluations up to n_contrib (~12
// float operations for the gate of each, ~38 more with the gradient assembly
// for each that passes both gates, against 67 TFLOP/s of non-tensor float32)
// or the bytes (36 read per gaussian row, 4 of id + 8 of
// destination read and 36 written per instance, 20 read per pixel),
// whichever is larger for the scene. Design: rows are read once per tile
// into shared memory and broadcast to the pixels; the reduction never leaves
// the SM. Simple before fast: no cp.async/TMA pipelining, and the shuffle
// reduction (45 shuffles per contributing warp and instance) is the known
// cost to attack later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int NWARP = NPIX / 32;
constexpr int ROWS = 9;    // x, y, conic a, b, c, opacity, r, g, b
constexpr int BATCH = 64;  // instances staged per step
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(NPIX) composite_bwd_kernel(
    const float* __restrict__ rows,      // (N, 9) per-gaussian screen rows
    const int* __restrict__ gid,         // (L,) sorted instance -> gaussian
    const int64_t* __restrict__ dst,     // (L,) sorted instance -> output row
    const int* __restrict__ starts,      // (B * gy * gx,)
    const int* __restrict__ counts,      // (B * gy * gx,)
    const float* __restrict__ bg,        // (B, 3)
    const float* __restrict__ t_final,   // (B, H, W)
    const int* __restrict__ n_contrib,   // (B, H, W)
    const float* __restrict__ g_img,     // (B, H, W, 3) image cotangent
    int gy, int gx, int h, int w,
    float* __restrict__ d_inst) {        // (L, 9)
    __shared__ float s_row[BATCH * ROWS];
    __shared__ float s_part[NWARP][BATCH * ROWS];
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

    int ncon = 0;
    float T = 1.0f, g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
    if (inside) {
        const size_t p = ((size_t)b * h + pyi) * w + pxi;
        ncon = n_contrib[p];
        T = t_final[p];
        g0 = g_img[3 * p + 0];
        g1 = g_img[3 * p + 1];
        g2 = g_img[3 * p + 2];
    }
    // g . (colour behind the current instance), seeded by the background term
    float gdr = (g0 * bg[3 * b + 0] + g1 * bg[3 * b + 1] + g2 * bg[3 * b + 2]) * T;

    const int wmax = __reduce_max_sync(FULL, ncon);
    if (lane == 0) s_max[warp] = wmax;
    __syncthreads();
    int live = 0;
#pragma unroll
    for (int k = 0; k < NWARP; ++k) live = max(live, s_max[k]);
    live = min(live, count);

    // instances past the tile's last contributor carry no gradient
    for (int i = live * ROWS + t; i < count * ROWS; i += NPIX)
        d_inst[dst[start + i / ROWS] * ROWS + i % ROWS] = 0.0f;

    const int n_batches = (live + BATCH - 1) / BATCH;
    for (int bi = n_batches - 1; bi >= 0; --bi) {
        const int base = bi * BATCH;
        const int n = min(BATCH, live - base);
        for (int i = t; i < n * ROWS; i += NPIX)
            s_row[i] = rows[(size_t)gid[start + base + i / ROWS] * ROWS + i % ROWS];
        __syncthreads();
        for (int j = n - 1; j >= 0; --j) {
            const float* r = s_row + j * ROWS;
            float v[ROWS];
            bool hit = false;
            if (base + j < ncon) {
                const float dx = px - r[0];
                const float dy = py - r[1];
                const float ca = r[2], cb = r[3], cc = r[4], op = r[5];
                const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
                if (power <= 0.0f) {
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
            if (__any_sync(FULL, hit)) {
#pragma unroll
                for (int k = 0; k < ROWS; ++k) {
#pragma unroll
                    for (int s = 16; s > 0; s >>= 1) v[k] += __shfl_down_sync(FULL, v[k], s);
                }
            }
            if (lane == 0) {
#pragma unroll
                for (int k = 0; k < ROWS; ++k) s_part[warp][j * ROWS + k] = v[k];
            }
        }
        __syncthreads();
        for (int i = t; i < n * ROWS; i += NPIX) {
            float sum = 0.0f;
#pragma unroll
            for (int k = 0; k < NWARP; ++k) sum += s_part[k][i];
            d_inst[dst[start + base + i / ROWS] * ROWS + i % ROWS] = sum;
        }
        // the next batch overwrites s_row and s_part
        __syncthreads();
    }
}

}  // namespace

extern "C" int composite_bwd(
    const float* rows, const int* gid, const int64_t* dst, const int* starts,
    const int* counts, const float* bg, const float* t_final, const int* n_contrib,
    const float* g_img, int b, int gy, int gx, int h, int w, float* d_inst,
    void* stream) {
    const dim3 grid(gx, gy, b);
    composite_bwd_kernel<<<grid, NPIX, 0, (cudaStream_t)stream>>>(
        rows, gid, dst, starts, counts, bg, t_final, n_contrib, g_img, gy, gx, h, w,
        d_inst);
    return (int)cudaGetLastError();
}

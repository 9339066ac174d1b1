// What the forward and the backward composite share (composite_fwd.cu,
// composite_bwd.cu): the tile, the gates' constants and the cull helpers
// that decide a pair without expf where the gate cannot pass (may_pass in
// both; strip_may_pass, the per-warp cull, and the cp.async staging
// primitives in the backward only: the forward measured no gain from
// either). Both sources include this one header, so the
// forward's and the backward's gates stay one piece of code: every pair is
// decided by the same expressions in both, which is what lets the backward
// count exactly the hits the forward counted.

#pragma once

#include <cuda_runtime.h>

namespace composite {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int NWARP = NPIX / 32;
constexpr int ROWS = 9;  // x, y, conic a, b, c, opacity, r, g, b
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float ALPHA_MAX = 0.99f;
constexpr float TRANSMITTANCE_EPS = 1e-4f;
// expf(-5.55) = 0.003888 < 1/255: below this power no opacity <= 1 passes the
// alpha gate
constexpr float POWER_MIN = -5.55f;
constexpr unsigned FULL = 0xffffffffu;

template <typename T>
__device__ __forceinline__ void copy_async(T* smem, const T* gmem) {
    static_assert(sizeof(T) == 4 || sizeof(T) == 8, "cp.async.ca copies 4, 8 or 16 bytes");
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(sizeof(T)) : "memory");
}

__device__ __forceinline__ void wait_copies() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// Whether the pair may pass the alpha gate, decided without expf where it
// cannot.
__device__ __forceinline__ bool may_pass(float power, float op) { return power >= POWER_MIN || op > 1.0f; }

// The largest power -0.5 (a u^2 + c d^2) - b u d for d in [lo, hi]: along an
// edge of a box where the other offset is fixed at u.
__device__ __forceinline__ float edge_max(float u, float lo, float hi, float a, float b, float c) {
    const float d = fminf(fmaxf(-b * u / c, lo), hi);
    return -0.5f * (a * u * u + c * d * d) - b * u * d;
}

// Whether some pixel of the strip [x0, x0 + 15] x [y0, y0 + 1] may pass the
// alpha gate of the instance with row r (x, y, conic a, b, c, opacity at
// r[0..5]). The power is concave: its largest value over the strip is 0
// where the mean lies inside, else the largest of the four edges' clamped
// maxima. Below logf(ALPHA_MIN / op), op * expf(power) < ALPHA_MIN; the
// slack, 1e-3 plus 1e-5 of the terms' largest magnitude over the strip, is
// 20 times the float rounding of this bound and of the gate's own power. A
// conic that is no ellipse, or op < 0 (a NaN threshold), decides nothing.
__device__ __forceinline__ bool strip_may_pass(const float* r, float x0, float y0) {
    const float a = r[2], b = r[3], c = r[4], op = r[5];
    if (!(a > 0.0f && c > 0.0f && a * c > b * b)) return true;
    const float lx = x0 - r[0], hx = lx + (TILE - 1);
    const float ly = y0 - r[1], hy = ly + 1.0f;
    float top = 0.0f;
    if (lx > 0.0f || hx < 0.0f || ly > 0.0f || hy < 0.0f)
        top = fmaxf(fmaxf(edge_max(lx, ly, hy, a, b, c), edge_max(hx, ly, hy, a, b, c)),
                    fmaxf(edge_max(ly, lx, hx, c, b, a), edge_max(hy, lx, hx, c, b, a)));
    const float X = fmaxf(fabsf(lx), fabsf(hx)), Y = fmaxf(fabsf(ly), fabsf(hy));
    const float slack = 1e-3f + 1e-5f * (a * X * X + c * Y * Y + fabsf(b) * X * Y);
    return !(top < logf(ALPHA_MIN / op) - slack);
}

}  // namespace composite

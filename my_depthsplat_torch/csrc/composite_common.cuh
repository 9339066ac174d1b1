// What the forward and the backward composite share (composite_fwd.cu,
// composite_bwd.cu): the tile, the gates' constants, the gate itself
// (gate, in a float32 and a bfloat16 instantiation) and the cull helpers
// that decide a pair without expf where the gate cannot pass (may_pass in
// both; strip_may_pass, the per-warp cull, and the cp.async staging
// primitives in the backward only: the forward measured no gain from
// either). Both sources include this one header, so the
// forward's and the backward's gates stay one piece of code: every pair is
// decided by the same expressions in both, which is what lets the backward
// count exactly the hits the forward counted.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

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

// x rounded to the nearest value of the compute type C (float or
// __nv_bfloat16; ties to even), held in a float. A float product of two
// bf16 values is exact and a float sum of two rounds only where the smaller
// one lies below the larger's last bf16 bit, so computing in float and
// rounding once gives C's own operation.
template <typename C>
__device__ __forceinline__ float rnd(float x) {
    if constexpr (std::is_same_v<C, float>) return x;
    else return __bfloat162float(__float2bfloat16_rn(x));
}

// The gate's power -0.5 (a dx^2 + c dy^2) - b dx dy (reference
// pallas_raster.py:140-158). float: one expression, as it always was. bf16:
// the float deltas and the conic rounded to bf16, then every product and
// sum rounded in the reference's order; the power is used as a float.
template <typename C>
__device__ __forceinline__ float gate_power(float dx, float dy, float a, float b, float c) {
    if constexpr (std::is_same_v<C, float>) {
        return -0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy;
    } else {
        const float x = rnd<C>(dx), y = rnd<C>(dy), ra = rnd<C>(a), rb = rnd<C>(b), rc = rnd<C>(c);
        const float s = rnd<C>(rnd<C>(rnd<C>(ra * x) * x) + rnd<C>(rnd<C>(rc * y) * y));
        return rnd<C>(rnd<C>(-0.5f * s) - rnd<C>(rnd<C>(rb * x) * y));
    }
}

// The alpha gate of pixel (px, py) against an instance (x, y, conic a, b,
// c, opacity op), shared by the forward and the backward so that both
// decide every pair alike: the power (gate_power), skipped unless power <=
// 0 (and without expf where may_pass says it cannot pass), then e =
// expf(power) and alpha = min(0.99, op e), passed if alpha >= 1/255. Sets
// the float deltas dx, dy always, e and alpha when the power passes.
template <typename C>
__device__ __forceinline__ bool gate(float px, float py, float x, float y, float a, float b, float c, float op,
                                     float& dx, float& dy, float& e, float& alpha) {
    dx = px - x;
    dy = py - y;
    const float power = gate_power<C>(dx, dy, a, b, c);
    if (!(power <= 0.0f && may_pass(power, op))) return false;
    e = expf(power);
    const float v = op * e;
    alpha = v > ALPHA_MAX ? ALPHA_MAX : v;
    return alpha >= ALPHA_MIN;
}

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
// With a bf16 gate (C = __nv_bfloat16) the gate's power rounds each of its
// nine operations to 8 significant bits: its error is within 7 * 2^-8 (2.7
// %) of the terms' magnitude (five roundings on a product of three
// factors, one on their sum, one on the difference), so the slack's
// relative part is 2^-4 (6.25 %), more than twice that.
template <typename C = float>
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
    constexpr float rel = std::is_same_v<C, float> ? 1e-5f : 0.0625f;
    const float slack = 1e-3f + rel * (a * X * X + c * Y * Y + fabsf(b) * X * Y);
    return !(top < logf(ALPHA_MIN / op) - slack);
}

}  // namespace composite

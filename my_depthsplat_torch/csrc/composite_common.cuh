// What the forward and the backward composite share (composite_fwd.cu,
// composite_bwd.cu): the tile, the gates' constants, the float32 gate
// (gate), the bfloat16 gate's pieces (the packed bf16x2 arithmetic, the
// power of two slots at once, gate_tail), the bf16 windows' doubling scan
// (scan_column and scan_full in the backward, scan_window in the forward),
// the cull helpers that decide a pair without expf where the gate cannot
// pass (may_pass in both; strip_may_pass, the per-warp cull, in the
// backward, and its test with the per-instance part staged once a window
// in the bf16 forward, composite_fwd.cu; the float32 forward measured no
// gain from a cull), the cp.async staging primitives (the backward only:
// the float32 forward measured no gain from them) and kernel_resources. Both
// sources include this one header, so the forward's and the backward's
// gates stay one piece of code: every pair is decided by the same
// expressions in both, which is what lets the backward count exactly the
// hits the forward counted.

#pragma once

#include <cuda_bf16.h>
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

// The alpha gate once the power is known: skipped unless power <= 0 (and
// without expf where may_pass says it cannot pass), then e = expf(power)
// and alpha = min(0.99, op e), passed if alpha >= 1/255.
__device__ __forceinline__ bool gate_tail(float power, float op, float& e, float& alpha) {
    if (!(power <= 0.0f && may_pass(power, op))) return false;
    e = expf(power);
    const float v = op * e;
    alpha = v > ALPHA_MAX ? ALPHA_MAX : v;
    return alpha >= ALPHA_MIN;
}

// The float32 alpha gate of pixel (px, py) against an instance (x, y, conic
// a, b, c, opacity op) (reference pallas_raster.py:140-158), shared by the
// forward and the backward so that both decide every pair alike. Sets the
// deltas dx, dy always, e and alpha when the power passes.
__device__ __forceinline__ bool gate(float px, float py, float x, float y, float a, float b, float c, float op,
                                     float& dx, float& dy, float& e, float& alpha) {
    dx = px - x;
    dy = py - y;
    const float power = -0.5f * (a * dx * dx + c * dy * dy) - b * dx * dy;
    return gate_tail(power, op, e, alpha);
}

// ---- bfloat16 (the reference's composite_dtype="bfloat16"): two bf16
// values packed in 32 bits, the first slot in the low half. Each operation
// is one correctly rounded bf16x2 instruction (round to nearest, ties to
// even): a product as fma with -0 added, a sum as fma by 1, so nothing can
// be contracted with a neighbour.
constexpr unsigned BF16_ONE2 = 0x3F803F80u;  // (1, 1)

__device__ __forceinline__ unsigned bf16_mul2(unsigned a, unsigned b) {
    unsigned d;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(0x80008000u));
    return d;
}

__device__ __forceinline__ unsigned bf16_add2(unsigned a, unsigned b) {
    unsigned d;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(BF16_ONE2), "r"(b));
    return d;
}

// (lo, hi) rounded to bf16 and packed
__device__ __forceinline__ unsigned bf16_pack2(float lo, float hi) {
    unsigned d;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
    return d;
}

__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xFFFF0000u); }
__device__ __forceinline__ unsigned short bf16_bits(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// The bf16 gate's powers of two slots against one pixel (reference
// _chunk_alpha :140-158 as XLA computes it jitted): the float deltas rounded
// to bf16, the conics (A, B, C: two slots' bf16 a, b, c, packed), then
// s = a x x + c y y, m = -0.5 s and t = b x y, rounded after every
// operation in the reference's order; the power is the float32 difference
// m - t (its bf16 rounding is dropped where the reference widens it).
__device__ __forceinline__ void gate_power2(float dx0, float dx1, float dy0, float dy1, unsigned A, unsigned B,
                                            unsigned C, float& p0, float& p1) {
    const unsigned X = bf16_pack2(dx0, dx1), Y = bf16_pack2(dy0, dy1);
    const unsigned s = bf16_add2(bf16_mul2(bf16_mul2(A, X), X), bf16_mul2(bf16_mul2(C, Y), Y));
    const unsigned m = bf16_mul2(s, 0xBF00BF00u);  // (-0.5, -0.5)
    const unsigned t = bf16_mul2(bf16_mul2(B, X), Y);
    p0 = bf16_lo(m) - bf16_lo(t);
    p1 = bf16_hi(m) - bf16_hi(t);
}

// ---- the bf16 windows and their doubling scan (both bf16 kernels). A
// window is 256 slots of a launch's instance array; a run's first window
// starts at start - start % 128 (the reference's CHUNK and _ALIGN). Each
// thread (pixel) keeps a column of the window's 256 bf16 values in shared
// memory, two slots a word, words NPIX apart: its factors, then their scan.
constexpr int CHUNK = 256;
constexpr int ALIGN = 128;
constexpr int WORDS = CHUNK / 2;

// Slot j of a pixel's column.
__device__ __forceinline__ float slot_value(const unsigned* col, int j) {
    const unsigned w = col[(j >> 1) * NPIX];
    return (j & 1) ? bf16_hi(w) : bf16_lo(w);
}

// The unrounded scan at slot j: the 7-level scan times the one 128 slots
// before it (1 below slot 128), a float32 product of two bf16 values, exact:
// the last level, kept unrounded where the jitted reference widens it.
__device__ __forceinline__ float scan_full(const unsigned* col, int j) {
    const float a = slot_value(col, j);
    return j >= ALIGN ? a * slot_value(col, j - ALIGN) : a;
}

// A level of shift 2 D slots (D words): every word times the word D below
// it, from the top so that each partner is read before it is overwritten.
template <int D>
__device__ __forceinline__ void scan_words(unsigned (&r)[WORDS]) {
#pragma unroll
    for (int m = WORDS - 1; m >= D; --m) r[m] = bf16_mul2(r[m], r[m - D]);
}

// The reference's doubling scan (_lane_cumprod) of a pixel's column, shifts
// 1 to 64 (the last, 128, is scan_full's product), in registers: the 128
// words are read once, scanned (1,665 bf16 multiplies on 833 words) and
// written back once. Bit k of ``groups`` says that words 16 k to 16 k + 15
// were written; the others hold (1, 1) and are not read.
__device__ __forceinline__ void scan_column(unsigned* col, unsigned groups) {
    unsigned r[WORDS];
#pragma unroll
    for (int m = 0; m < WORDS; ++m) r[m] = (groups >> (m / 16) & 1u) ? col[m * NPIX] : BF16_ONE2;
    // shift 1: slot i times slot i - 1, for a word's low half the high half
    // of the word below
#pragma unroll
    for (int m = WORDS - 1; m >= 0; --m) r[m] = bf16_mul2(r[m], __byte_perm(m > 0 ? r[m - 1] : BF16_ONE2, r[m], 0x5432));
    scan_words<1>(r);
    scan_words<2>(r);
    scan_words<4>(r);
    scan_words<8>(r);
    scan_words<16>(r);
    scan_words<32>(r);
#pragma unroll
    for (int m = 0; m < WORDS; ++m) col[m * NPIX] = r[m];
}

// One level of scan_window: shift 2 D slots (D words), every word times the
// word D below it, from the top; the groups below k0 are not touched.
template <int D>
__device__ __forceinline__ void scan_level(unsigned (&r)[WORDS], int k0) {
#pragma unroll
    for (int g = WORDS / 16 - 1; g >= 0; --g) {
        if (g >= k0) {
#pragma unroll
            for (int mm = 15; mm >= 0; --mm) {
                const int m = 16 * g + mm;
                if (m >= D) r[m] = bf16_mul2(r[m], r[m - D]);
            }
        }
    }
}

// scan_column's doubling scan (shifts 1 to 64) of a window that lives in
// registers from its factors to its hit pass, in place. The words of the 32-slot
// groups (16 words each) below k0 hold (1, 1), which every level keeps: they
// are skipped, the same products as scan_column's.
__device__ __forceinline__ void scan_window(unsigned (&r)[WORDS], int k0) {
#pragma unroll
    for (int g = WORDS / 16 - 1; g >= 0; --g) {
        if (g >= k0) {
#pragma unroll
            for (int mm = 15; mm >= 0; --mm) {
                const int m = 16 * g + mm;
                r[m] = bf16_mul2(r[m], __byte_perm(m > 0 ? r[m - 1] : BF16_ONE2, r[m], 0x5432));
            }
        }
    }
    scan_level<1>(r, k0);
    scan_level<2>(r, k0);
    scan_level<4>(r, k0);
    scan_level<8>(r, k0);
    scan_level<16>(r, k0);
    scan_level<32>(r, k0);
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
// With a bf16 gate (BF16) the gate's power rounds eight of its nine
// operations to 8 significant bits: its error is within 6 * 2^-8 (2.3 %) of
// the terms' magnitude (five roundings on a product of three factors, one
// on their sum; the difference is float32), so the slack's relative part
// is 2^-4 (6.25 %), more than twice that.
template <bool BF16 = false>
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
    constexpr float rel = BF16 ? 0.0625f : 1e-5f;
    const float slack = 1e-3f + rel * (a * X * X + c * Y * Y + fabsf(b) * X * Y);
    return !(top < logf(ALPHA_MIN / op) - slack);
}

// What a kernel launched with ``threads`` a CTA and ``dynamic_smem`` bytes of
// dynamic shared memory holds on the card (cudaFuncGetAttributes and the
// occupancy calculator): out[0..5] = threads a CTA, registers a thread,
// local memory a thread (bytes), static and dynamic shared memory a CTA
// (bytes), CTAs an SM. Returns the cudaError_t.
template <typename Kernel>
int kernel_resources(Kernel kernel, int threads, int dynamic_smem, int* out) {
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, kernel);
    int n = 0;
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, dynamic_smem);
    out[0] = threads;
    out[1] = a.numRegs;
    out[2] = (int)a.localSizeBytes;
    out[3] = (int)a.sharedSizeBytes;
    out[4] = dynamic_smem;
    out[5] = n;
    return (int)err;
}

}  // namespace composite

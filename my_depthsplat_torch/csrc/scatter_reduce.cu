// Instance -> gaussian gradient reduction: out[g, :] = sum of the rows of
// gaussian g's instances.
//
// Replaces the TPU kernel scripts/profile_pallas_scatter.py:_scatter_kernel
// (:46, launched by pallas_scatter :99), the per-lane scatter reduction
// out[slot[l], :] += g[l, :] that the JAX package otherwise leaves to an XLA
// scatter-add (render/instances.py:120-127). That kernel walked the lanes one
// by one on the scalar core, read-modify-writing a VMEM-resident output. Here
// no scatter is left: the expansion kernel writes each gaussian's instances
// contiguously (gaussian-major, before the key sort), and the composite
// backward writes instance rows back in that order, so the reduction is a
// segmented sum over the contiguous rows [offset[g], offset[g] + count[g]).
// One thread owns one (gaussian, column) output and adds its rows in order:
// no atomics, so the result is deterministic and bit-reproducible.
//
// Bound on the H100: bytes (36 per instance row read, 12 per gaussian of
// offset and count read, 36 per gaussian written; one add per value).
// Design: thread i handles output element i = g * 9 + k, so a warp reads and
// writes consecutive addresses (the rows of neighbouring gaussians are
// neighbours in memory). Simple before fast: a gaussian with very many
// instances serialises its 9 threads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 9;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) scatter_reduce_kernel(
    const float* __restrict__ d_inst,    // (L, 9) gaussian-major instance rows
    const int64_t* __restrict__ offset,  // (N,) first row of each gaussian
    const int* __restrict__ counts,      // (N,) rows of each gaussian
    int64_t n_out,                       // N * 9
    float* __restrict__ out) {           // (N, 9)
    const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (i >= n_out) return;
    const int64_t g = i / ROWS;
    const int k = (int)(i - g * ROWS);
    const float* src = d_inst + offset[g] * ROWS + k;
    const int c = counts[g];
    float sum = 0.0f;
    for (int j = 0; j < c; ++j) sum += src[(int64_t)j * ROWS];
    out[i] = sum;
}

}  // namespace

extern "C" int scatter_reduce(
    const float* d_inst, const int64_t* offset, const int* counts, int n,
    float* out, void* stream) {
    const int64_t n_out = (int64_t)n * ROWS;
    const int64_t blocks = (n_out + THREADS - 1) / THREADS;
    if (blocks == 0) return 0;
    scatter_reduce_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        d_inst, offset, counts, n_out, out);
    return (int)cudaGetLastError();
}

// Affine-gap alignment DP (Gotoh) for Hopper (sm_90a): one CTA per pair,
// global (Needleman-Wunsch) or local (Smith-Waterman) mode, over the
// anti-diagonals d = 1 .. L1 + L2 of the padded batch.
//
// Replaces the TPU kernel ginfinity_tpu/ops/pallas_dp.py::_kernel and
// computes what it computes: for every cell (i, j = d - i) of diagonal d
//   E  = max(H[i-1, j] + go, E[i-1, j] + ge)    TE = 1 iff extend > open
//   F  = max(H[i, j-1] + go, F[i, j-1] + ge)    TF = 1 iff extend > open
//   H  = diag if diag >= E and diag >= F, else E if E >= F, else F,
//        with diag = H[i-1, j-1] + s[i-1, j-1]
//   local mode: H <= 0 gives H = 0 and code 3 (stop)
// and writes the traceback code TH | TE << 2 | TF << 3 of every cell, the
// best score (global: H[l1, l2]; local: the first maximum, smallest d,
// then smallest i) and its cell.
//
// What bounds it on this card: the chain of L1 + L2 dependent diagonal
// steps.  Its bytes (the scores read once, one code byte written per
// cell) take ~17 us at 3.35 TB/s for 64 pairs of 384 x 384, and its
// arithmetic (~20 operations per cell) less; each step waits for the
// previous one through shared memory and a CTA barrier, so the chain of
// barrier rounds is the floor a one-CTA-per-pair design cannot go below.
//
// What the design does about it (a simple, correct first version):
//  * One CTA per pair, one thread per row i of a diagonal (a thread loops
//    over rows i, i + blockDim, ... when L1 + 1 > 1024).  The diagonals
//    H(d-1), H(d-2), E(d-1), F(d-1) live in shared memory: three rotating
//    H buffers and two each for E and F, so a step reads only the
//    previous diagonals and writes the current one, and the rows of one
//    thread may be visited in any order.  shift_down is a read of row i-1.
//  * The score of a cell is read straight from the padded [B, L1, L2]
//    tensor; the TPU kernel's sheared copy existed because Mosaic cannot
//    gather.
//  * Codes are written as uint8 [B, D, L1 + 1], coalesced along i.
//  * Local best: each thread keeps its own (max H, first d, its i) under a
//    strict >, and one block reduction at the end takes the largest value,
//    then the smallest d, then the smallest i: the sequential "cmax > best,
//    first-max argmin i" of the TPU kernel without a reduction per diagonal.
//  * Several pairs per CTA for short RNAs, fewer barriers and TMA prefetch
//    of score rows are later work.
//
// Where trouble is likely, and what is done about it:
//  * Tie rules: the comparisons are written as in the plain version (>=
//    for H, strict < for TE/TF), never as a max followed by an equality
//    test, which would change paths on integer score matrices.
//  * Global boundaries go + (j - 1) ge and go + (i - 1) ge are one
//    __fmaf_rn, rounded once: XLA contracts the JAX package's expression
//    into a fused multiply-add, and the plain version rounds it once too
//    (in float64).  A separate product and sum differ in the last bit (with
//    ge = -0.3, for 2 of the first 40 k), which can flip a tie.
//  * Cells outside i <= l1, 0 <= j <= l2 hold NEG in H, E and F.
//  * Shared memory: 7 diagonals of L1 + 1 floats plus the reduction
//    scratch; above 48 KB the launch asks for the opt-in limit (227 KB on
//    Hopper), so L1 + 1 <= 8288.  The host gate dp_kernel_ok checks it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr size_t kDefaultSmem = 48 * 1024;

// (v, d, i) comes before (v2, d2, i2): larger value, then smaller d, then
// smaller i.
__device__ __forceinline__ bool before(float v, int d, int i, float v2, int d2, int i2) {
  return v > v2 || (v == v2 && (d < d2 || (d == d2 && i < i2)));
}

__global__ void dp_wavefront_kernel(const float* __restrict__ scores,
                                    const int* __restrict__ l1s,
                                    const int* __restrict__ l2s, int L1, int L2,
                                    float go, float ge, int local,
                                    uint8_t* __restrict__ codes,
                                    float* __restrict__ best_out,
                                    int* __restrict__ bi_out,
                                    int* __restrict__ bj_out) {
  extern __shared__ float smem[];
  const int I = L1 + 1;
  const int D = L1 + L2;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int l1 = l1s[b], l2 = l2s[b];
  const float* S = scores + (size_t)b * L1 * L2;
  uint8_t* C = codes + (size_t)b * D * I;
  // H(d) in slot d % 3, E(d) in slot 3 + d % 2, F(d) in slot 5 + d % 2
  float* red_v = smem + 7 * I;
  int* red_d = reinterpret_cast<int*>(red_v + kMaxWarps);
  int* red_i = red_d + kMaxWarps;

  for (int i = tid; i < I; i += blockDim.x) {
    smem[i] = i == 0 ? 0.f : kNeg;  // diagonal 0: only cell (0, 0)
    smem[2 * I + i] = kNeg;          // diagonal -1
    smem[3 * I + i] = kNeg;
    smem[5 * I + i] = kNeg;
  }
  if (tid == 0) best_out[b] = local ? 0.f : kNeg;
  __syncthreads();

  float my_v = 0.f;  // local mode: this thread's first maximum
  int my_d = 0, my_i = 0;

  for (int d = 1; d <= D; ++d) {
    const float* h1 = smem + ((d - 1) % 3) * I;
    const float* h2 = smem + ((d + 1) % 3) * I;
    const float* e1 = smem + (3 + ((d - 1) & 1)) * I;
    const float* f1 = smem + (5 + ((d - 1) & 1)) * I;
    float* hc = smem + (d % 3) * I;
    float* ec = smem + (3 + (d & 1)) * I;
    float* fc = smem + (5 + (d & 1)) * I;
    uint8_t* cd = C + (size_t)(d - 1) * I;

    for (int i = tid; i < I; i += blockDim.x) {
      const int j = d - i;
      const bool valid = i <= l1 && j >= 0 && j <= l2;
      const bool on_bound = i == 0 || j == 0;
      const float hup = i > 0 ? h1[i - 1] : kNeg;
      const float eup = i > 0 ? e1[i - 1] : kNeg;
      const float hdiag = i > 0 ? h2[i - 1] : kNeg;
      const float s = (valid && !on_bound) ? S[(size_t)(i - 1) * L2 + (j - 1)] : 0.f;

      const float e_from_h = hup + go;
      const float e_from_e = eup + ge;
      const int te = e_from_h < e_from_e;  // ties -> from H
      float E = te ? e_from_e : e_from_h;

      const float f_from_h = h1[i] + go;
      const float f_from_f = f1[i] + ge;
      const int tf = f_from_h < f_from_f;
      float F = tf ? f_from_f : f_from_h;

      const float diag = hdiag + s;
      float H;
      int th;
      if (diag >= E && diag >= F) {
        H = diag;
        th = 0;
      } else if (E >= F) {
        H = E;
        th = 1;
      } else {
        H = F;
        th = 2;
      }
      if (local && H <= 0.f) {
        H = 0.f;
        th = 3;
      }
      if (on_bound) {
        if (local) {
          H = 0.f;
          th = 3;
        } else if (i == 0) {
          H = __fmaf_rn((float)j - 1.f, ge, go);  // H[0, j]
          th = 2;
        } else {
          H = __fmaf_rn((float)i - 1.f, ge, go);  // H[i, 0]
          th = 1;
        }
        E = kNeg;
        F = kNeg;
      }
      if (!valid) {
        H = kNeg;
        E = kNeg;
        F = kNeg;
      }
      hc[i] = H;
      ec[i] = E;
      fc[i] = F;
      cd[i] = (uint8_t)(th | (te << 2) | (tf << 3));

      if (local) {
        if (valid && !on_bound && H > my_v) {
          my_v = H;
          my_d = d;
          my_i = i;
        }
      } else if (i == l1 && j == l2) {
        best_out[b] = H;
      }
    }
    __syncthreads();
  }

  if (!local) {
    if (tid == 0) {
      bi_out[b] = l1;
      bj_out[b] = l2;
    }
    return;
  }
  // block reduction of the local best: within each warp, then over warps
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_down_sync(0xffffffffu, my_v, off);
    const int dd = __shfl_down_sync(0xffffffffu, my_d, off);
    const int ii = __shfl_down_sync(0xffffffffu, my_i, off);
    if (before(v, dd, ii, my_v, my_d, my_i)) {
      my_v = v;
      my_d = dd;
      my_i = ii;
    }
  }
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) {
    red_v[warp] = my_v;
    red_d[warp] = my_d;
    red_i[warp] = my_i;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
      if (before(red_v[w], red_d[w], red_i[w], my_v, my_d, my_i)) {
        my_v = red_v[w];
        my_d = red_d[w];
        my_i = red_i[w];
      }
    }
    best_out[b] = my_v;
    bi_out[b] = my_i;
    bj_out[b] = my_d - my_i;
  }
}

// A chain of dependent steps with the kernel's shape and nothing else:
// each step reads row i - 1 of the previous diagonal from shared memory,
// writes row i of the next, and waits at the CTA barrier.  Its time over
// `steps` is the cost of one diagonal step that no work can hide.
__global__ void dp_barrier_probe_kernel(int steps, int I, float* __restrict__ out) {
  extern __shared__ float smem[];
  for (int i = threadIdx.x; i < 2 * I; i += blockDim.x) smem[i] = (float)i;
  __syncthreads();
  for (int d = 1; d <= steps; ++d) {
    const float* prev = smem + ((d - 1) & 1) * I;
    float* cur = smem + (d & 1) * I;
    for (int i = threadIdx.x; i < I; i += blockDim.x)
      cur[i] = (i > 0 ? prev[i - 1] : prev[I - 1]) + 1.f;
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = smem[(steps & 1) * I];
}

int threads_for(int I) {
  const int t = (I + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one pair's CTA at padded length L1.
size_t dp_wavefront_smem_bytes(int L1) {
  return (size_t)7 * (L1 + 1) * sizeof(float) + 3 * kMaxWarps * sizeof(float);
}

// The opt-in shared memory per block of `device`, in bytes (negative: a
// CUDA error).
int dp_wavefront_smem_optin(int device) {
  int v = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? v : -(int)err;
}

int dp_wavefront_launch(const void* scores, const void* l1, const void* l2, int B,
                        int L1, int L2, float go, float ge, int local, void* codes,
                        void* best, void* bi, void* bj, void* stream) {
  const size_t smem = dp_wavefront_smem_bytes(L1);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        dp_wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dp_wavefront_kernel<<<B, threads_for(L1 + 1), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scores), static_cast<const int*>(l1),
      static_cast<const int*>(l2), L1, L2, go, ge, local,
      static_cast<uint8_t*>(codes), static_cast<float*>(best), static_cast<int*>(bi),
      static_cast<int*>(bj));
  return (int)cudaGetLastError();
}

// `blocks` CTAs of the kernel's thread count at padded length L1, each
// running `steps` dependent steps.
int dp_barrier_probe_launch(int blocks, int steps, int L1, void* out, void* stream) {
  const int I = L1 + 1;
  const size_t smem = (size_t)2 * I * sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        dp_barrier_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dp_barrier_probe_kernel<<<blocks, threads_for(I), smem, static_cast<cudaStream_t>(stream)>>>(
      steps, I, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"

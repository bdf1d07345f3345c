// Fused window encoder for Hopper (sm_90a): every GINE layer of a chunk of
// sliding windows, then the node norm, the pooling and the fc head.
//
// Replaces the TPU kernel ginfinity_tpu/ops/pallas_windows.py::_kernel and
// computes what it computes, window by window:
//   per layer  agg  = relu(x_next + e_next) + relu(x_prev + e_prev)     (backbone)
//                   + bp * relu(x[j_local] + e_bp)                      (in-window pair)
//                   + pulled * relu(x[L + i] + e_bp)                    (pulled partner)
//              h    = relu(relu(((1 + eps) x + agg) W0 + b0) W1 + b1)
//              x    = GraphNorm_window(h) (+ x when the widths match)
//   then       zscore / l2 node norm, masked add or mean pool, fc head.
//
// What bounds it on this card: the two dense products of every layer,
// about 95% of its floating-point work, which run here in IEEE float32 on
// the FMA units (67 TFLOP/s at most): TF32 or bf16 tensor cores would
// break the float32 parity the JAX package holds (matmul precision
// "highest").  Its bytes are small beside that: the encoder input is read
// once and one row per window is written.
//
// What the design does about it:
//  * One CTA of 256 threads per window.  The window's activations live in a
//    global workspace [C, 3, 2L, max_width] that the wrapper allocates (at a
//    chunk of 128 flagship windows it is 47 MB and stays in the 50 MB L2);
//    the flags, the active-row list and the per-column statistics live in
//    shared memory.  The TPU kernel's 8 VMEM-resident windows do not fit a
//    CTA's 227 KB.
//  * Only active rows are computed: the L window rows and the pulled-partner
//    slots that hold a node.  Empty slots are masked out of every sum in the
//    TPU kernel, so skipping them changes no result and removes about half
//    of the product work at the flagship shape.
//  * The in-window partner row is read by index (x[j_local[i]]); the TPU
//    kernel's one-hot [L, L] product only avoided a gather.
//  * The products are 64 x 128 output tiles staged through shared memory in
//    32-deep slices; each thread holds an 8 x 4 block of sums.  No tensor
//    cores, no TMA: those belong to a later, faster version.
//  * Column sums (GraphNorm, pooling) are split over the 8 warps and then
//    combined, in a fixed order, so a run is deterministic.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int BM = 64;   // rows of a product tile: 8 warps x 8 rows
constexpr int BN = 128;  // columns of a product tile: 32 lanes x 4 columns
constexpr int BK = 32;   // depth of one staged slice
constexpr int kLayerMeta = 8;  // w0, w1, b0, b1, eb, gn offsets; din; dout

__device__ __forceinline__ float relu(float v) { return fmaxf(v, 0.f); }

// out[rows[r], n] = relu(sum_k in[rows[r], k] * w[k, n] + b[n])
// for r < n_rows and n < dout; din is a multiple of BK, dout of BN.
__device__ void dense_relu(const float* __restrict__ in, float* __restrict__ out,
                           int ld, const int* rows, int n_rows,
                           const float* __restrict__ w,
                           const float* __restrict__ b, int din, int dout,
                           float* As, float* Ws) {
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  for (int m0 = 0; m0 < n_rows; m0 += BM) {
    for (int n0 = 0; n0 < dout; n0 += BN) {
      float acc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int k0 = 0; k0 < din; k0 += BK) {
        for (int e = tid; e < BM * BK; e += kThreads) {
          const int r = e / BK, k = e % BK;
          As[r * (BK + 1) + k] =
              (m0 + r < n_rows) ? in[rows[m0 + r] * ld + k0 + k] : 0.f;
        }
        for (int e = tid; e < BK * BN; e += kThreads) {
          const int k = e / BN, n = e % BN;
          Ws[e] = w[(size_t)(k0 + k) * dout + n0 + n];
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < BK; ++k) {
          float a[8], bv[4];
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = As[(ty * 8 + i) * (BK + 1) + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Ws[k * BN + tx + 32 * j];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = m0 + ty * 8 + i;
        if (r < n_rows) {
          float* o = out + rows[r] * ld;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int n = n0 + tx + 32 * j;
            o[n] = relu(acc[i][j] + b[n]);
          }
        }
      }
    }
  }
}

// dst[c] = sum over r < n_rows of value(r, c), for c < width.  Each warp
// sums a strided share of the rows, lanes on neighbouring columns; the
// warps' partial sums are then added in warp order.  Ends synchronised.
template <typename F>
__device__ void column_sums(F value, int n_rows, int width, float* red,
                            float* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int c = lane; c < width; c += 32) {
    float s = 0.f;
    for (int r = warp; r < n_rows; r += kWarps) s += value(r, c);
    red[warp * width + c] = s;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < width; c += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * width + c];
    dst[c] = s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
windows_encoder_kernel(const float* __restrict__ x0, const int* __restrict__ j_local,
                       const float* __restrict__ bp_in, const float* __restrict__ pulled,
                       const float* __restrict__ fwd_w, const float* __restrict__ fwd_p,
                       const float* __restrict__ params, const long long* __restrict__ meta,
                       float* __restrict__ workspace, float* __restrict__ out,
                       int L, int n_layers, int mw, int out_dim, int mean_pool,
                       int norm_mode, int use_res, float eps) {
  extern __shared__ float smem[];
  float* As = smem;
  float* Ws = As + BM * (BK + 1);
  float* red = Ws + BK * BN;
  float* s_a = red + kWarps * mw;
  float* s_b = s_a + mw;
  float* f_bp = s_b + mw;
  float* f_pl = f_bp + L;
  float* f_fw = f_pl + L;
  float* f_fp = f_fw + L;
  float* nrm = f_fp + L;
  int* f_jl = reinterpret_cast<int*>(nrm + 2 * L);
  int* rows = f_jl + L;
  __shared__ int s_n_rows;

  const int tid = threadIdx.x;
  const size_t win = blockIdx.x;
  const int plane = 2 * L * mw;
  float* X = workspace + win * 3 * (size_t)plane;  // layer input / output
  float* H = X + plane;                            // aggregate, then MLP out
  float* T = H + plane;                            // MLP hidden

  for (int i = tid; i < L; i += kThreads) {
    const size_t k = win * L + i;
    f_jl[i] = j_local[k];
    f_bp[i] = bp_in[k];
    f_pl[i] = pulled[k];
    f_fw[i] = fwd_w[k];
    f_fp[i] = fwd_p[k];
    rows[i] = i;
  }
  __syncthreads();
  if (tid == 0) {  // active pulled slots, in position order
    int n = L;
    for (int i = 0; i < L; ++i)
      if (f_pl[i] != 0.f) rows[n++] = L + i;
    s_n_rows = n;
  }
  __syncthreads();
  const int n_rows = s_n_rows;
  const float cnt = (float)n_rows;  // L + sum(pulled)

  const int h0 = (int)meta[6];
  for (int e = tid; e < n_rows * h0; e += kThreads) {
    const int row = rows[e / h0], c = e % h0;
    X[row * mw + c] = x0[(win * 2 * L + row) * h0 + c];
  }
  __syncthreads();

  for (int li = 0; li < n_layers; ++li) {
    const long long* m = meta + kLayerMeta * li;
    const float* W0 = params + m[0];
    const float* W1 = params + m[1];
    const float* b0 = params + m[2];
    const float* b1 = params + m[3];
    const float* eb = params + m[4];  // [5, din]: next, prev, bp_f, bp_b, 1+eps
    const float* gn = params + m[5];  // [3, dout]: weight, bias, mean_scale
    const int din = (int)m[6], dout = (int)m[7];
    const float* eb_next = eb;
    const float* eb_prev = eb + din;
    const float* eb_f = eb + 2 * din;
    const float* eb_b = eb + 3 * din;
    const float* one_eps = eb + 4 * din;

    // messages: H = (1 + eps) x + agg, summed in the TPU kernel's order
    for (int e = tid; e < n_rows * din; e += kThreads) {
      const int row = rows[e / din], c = e % din;
      float agg;
      if (row < L) {
        const int i = row;
        const float a1 = (i <= L - 2) ? relu(X[(i + 1) * mw + c] + eb_next[c]) : 0.f;
        const float a2 = (i >= 1) ? relu(X[(i - 1) * mw + c] + eb_prev[c]) : 0.f;
        agg = a1 + a2;
        const float e_w = (f_fw[i] != 0.f) ? eb_f[c] : eb_b[c];
        if (f_bp[i] != 0.f) agg = agg + relu(X[f_jl[i] * mw + c] + e_w);
        if (f_pl[i] != 0.f) agg = agg + relu(X[(L + i) * mw + c] + e_w);
      } else {
        const int i = row - L;
        const float e_p = (f_fp[i] != 0.f) ? eb_f[c] : eb_b[c];
        agg = relu(X[i * mw + c] + e_p);
      }
      H[row * mw + c] = __fmul_rn(one_eps[c], X[row * mw + c]) + agg;
    }
    __syncthreads();

    dense_relu(H, T, mw, rows, n_rows, W0, b0, din, dout, As, Ws);
    __syncthreads();
    dense_relu(T, H, mw, rows, n_rows, W1, b1, dout, dout, As, Ws);
    __syncthreads();

    // GraphNorm over the window's active rows (variance eps 1e-5)
    column_sums([&](int r, int c) { return H[rows[r] * mw + c]; }, n_rows, dout,
                red, s_a);
    for (int c = tid; c < dout; c += kThreads) s_a[c] = (s_a[c] / cnt) * gn[2 * dout + c];
    __syncthreads();
    column_sums(
        [&](int r, int c) {
          const float o = H[rows[r] * mw + c] - s_a[c];
          return o * o;
        },
        n_rows, dout, red, s_b);
    for (int c = tid; c < dout; c += kThreads) s_b[c] = sqrtf(s_b[c] / cnt + 1e-5f);
    __syncthreads();
    const bool res = use_res && din == dout;
    for (int e = tid; e < n_rows * dout; e += kThreads) {
      const int row = rows[e / dout], c = e % dout;
      const float o = H[row * mw + c] - s_a[c];
      const float y = __fdiv_rn(__fmul_rn(gn[c], o), s_b[c]) + gn[dout + c];
      X[row * mw + c] = res ? y + X[row * mw + c] : y;
    }
    __syncthreads();
  }

  const int h_last = (int)meta[kLayerMeta * (n_layers - 1) + 7];
  const float* mu = params + meta[kLayerMeta * n_layers];
  const float* sigma = mu + h_last;
  const float* fcw = params + meta[kLayerMeta * n_layers + 1];
  const float* fcb = params + meta[kLayerMeta * n_layers + 2];

  if (norm_mode & 2) {  // zscore with the model's buffers
    for (int e = tid; e < n_rows * h_last; e += kThreads) {
      const int row = rows[e / h_last], c = e % h_last;
      X[row * mw + c] = (X[row * mw + c] - mu[c]) / (sigma[c] + eps);
    }
    __syncthreads();
  }
  {  // row L2 norms (1 when the mode has no l2)
    const int lane = tid & 31, warp = tid >> 5;
    for (int r = warp; r < n_rows; r += kWarps) {
      float s = 0.f;
      if (norm_mode & 1) {
        const float* xr = X + rows[r] * mw;
        for (int c = lane; c < h_last; c += 32) s += xr[c] * xr[c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      }
      if (lane == 0) nrm[r] = (norm_mode & 1) ? fmaxf(sqrtf(s), eps) : 1.f;
    }
    __syncthreads();
  }
  column_sums([&](int r, int c) { return X[rows[r] * mw + c] / nrm[r]; }, n_rows,
              h_last, red, s_a);
  if (mean_pool) {
    for (int c = tid; c < h_last; c += kThreads) s_a[c] = s_a[c] / cnt;
    __syncthreads();
  }
  for (int o = tid; o < out_dim; o += kThreads) {
    float acc = 0.f;
    for (int f = 0; f < h_last; ++f) acc = fmaf(s_a[f], fcw[(size_t)f * out_dim + o], acc);
    out[win * out_dim + o] = acc + fcb[o];
  }
}

size_t smem_bytes(int L, int mw) {
  return sizeof(float) * ((size_t)BM * (BK + 1) + (size_t)BK * BN +
                          (size_t)(kWarps + 2) * mw + 6 * (size_t)L) +
         sizeof(int) * 3 * (size_t)L;
}

}  // namespace

extern "C" {

// Dynamic shared memory one window's CTA needs at window length L and
// widest layer mw.
size_t windows_encoder_smem_bytes(int L, int mw) { return smem_bytes(L, mw); }

// Launches the encoder over C windows on `stream`; allocates nothing.
// params/meta: the flat parameter buffer and its int64 offset table
// (ops/windows_encoder.py::pack_params).  workspace: [C, 3, 2L, mw] f32.
// norm_mode: bit 0 = l2, bit 1 = zscore.  Returns a cudaError_t.
int windows_encoder_launch(const float* x0, const int* j_local, const float* bp_in,
                           const float* pulled, const float* fwd_w, const float* fwd_p,
                           const float* params, const long long* meta, float* workspace,
                           float* out, int C, int L, int n_layers, int mw, int out_dim,
                           int mean_pool, int norm_mode, int use_res, float eps,
                           void* stream) {
  if (C == 0) return 0;
  const size_t smem = smem_bytes(L, mw);
  cudaError_t err = cudaFuncSetAttribute(
      windows_encoder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  windows_encoder_kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x0, j_local, bp_in, pulled, fwd_w, fwd_p, params, meta, workspace, out, L,
      n_layers, mw, out_dim, mean_pool, norm_mode, use_res, eps);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

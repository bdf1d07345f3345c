// Alignment-contrastive loss for Hopper (sm_90a): the loss of
// ginfinity_tpu_torch/training/losses.py::alignment_contrastive_loss and its
// gradient, tiled, so that no M x M tensor is ever made.
//
// Replaces no TPU kernel: the JAX package leaves this loss to XLA as M x M
// masked tensors (ginfinity_tpu/training/losses.py), and the port's plain
// version on the card made a dozen of them, 1-4 GB each at M = 32k, plus
// autograd's copies for the backward.  The kernel takes the normalised rows
// x [M, Dp] (Dp a multiple of 32 in float32, 16 in float64, zero columns
// past D) and, per row, the label, the graph, and the flags valid (bit 0)
// and conserved (bit 1).  For i != j with both rows valid, the pair is
// positive (P) when the labels match, the graphs differ and both rows are
// conserved, negative (N) when the labels differ, and out of the loss
// otherwise.  With l = cos / T:
//   loss = [sum_P (1 - cos) - sum_P l + sum_i p_i lse_i] / max(n_pos, 1)
//        + [margin > 0] sum_N max(l - margin, 0) / max(n_neg, 1)
// (0 when n_pos is 0), lse_i the log-sum-exp of row i's l over P and N, p_i
// its positives.  Its gradient with respect to cos is G below, and that with
// respect to x is (G + G^T) x, every mask being symmetric:
//   (G + G^T)_ij = [P] (-2 / pd) (1 + 1 / T)
//                + (p_i exp(l - lse_i) + p_j exp(l - lse_j)) [P or N] / (T pd)
//                + [N] [l - margin >= 0] 2 / (T nn)       (margin > 0 only)
// with pd = max(n_pos, 1), nn = max(n_neg, 1); the last term takes clamp's
// gradient at the kink (>= 0), as torch.clamp does.
//
// What bounds it on this card: three M x M x D products, 2 M^2 D operations
// each (the forward's cosines, the backward's recomputed cosines, and
// (G + G^T) x): 3.3e12 at M = 32k, D = 512, ~20 ms at the 3xTF32 tensor-core
// rate (495 / 3 TFLOP/s), ~49 ms at the FP32 FMA rate (67 TFLOP/s).  Its
// bytes are small beside that: x is read from L2 tile by tile, and per row
// two numbers are written.
//
// What the design does about it (float32, namespace tf32):
//  * Products on the tensor cores as 3xTF32, as the window encoder computes
//    its float32 products (hi = tf32(a), lo = tf32(a - hi) for both
//    operands, lo*hi' + hi*lo' + hi*hi' in float32), by warpgroup MMA
//    (wgmma m64nNk8 tf32) with both operands in shared memory.  The split is
//    made once a call: a pack kernel writes the hi and lo planes of x, and
//    for the backward of x^T (tf32 wgmma takes both operands K-major, and
//    the product (G + G^T)_IJ x_J runs K over J), into global scratch in the
//    tensor cores' core-matrix order, so that one bulk copy (TMA) moves a
//    block of rows and no thread touches an operand on its way in.
//  * Warp-specialised CTAs: one thread of a producer warpgroup keeps a ring
//    of stages in flight (bulk copies completing on mbarriers, each slot
//    released by the consumer warps once their products are done with it),
//    and two consumer warpgroups multiply; setmaxnreg hands the producer's
//    registers to the consumers (240 a thread).  A CTA owns 64 rows.
//  * Cosines: the three products of each k8 block (forward) or of each two
//    (backward, whose cosines only weigh the gradient) are summed apart in
//    the tensor cores, then added to the running sum with a rounded add:
//    the tensor cores round their float32 sums toward zero, and a long
//    chain drifts toward zero (~1e-5 relative over a 512-deep cosine; two
//    blocks a chain in the forward would triple the loss's gap to float64,
//    to ~3e-7 at M = 32k); single-pass TF32 would miss the float32 loss by
//    ~5e-6 relative.  Each chain waits for its products before the next is
//    issued: a second chain in flight took ~45 registers more than a
//    consumer has (ptxas then serialised the wgmmas), or, as two halves of
//    N / 2 columns in the same registers, was slower (16.3 against 15.9 ms
//    forward at M = 32k).
//  * The epilogues (masks, online log-sum-exp, sums; (G + G^T)) take every
//    decision by select, not by branch: divergent branches per element cost
//    the forward 5.3 ms at M = 32k, more than their arithmetic.
//  * Forward: per 256-column tile each warpgroup sums its 128 columns'
//    cosines, then its rows' masks, online log-sum-exp of l over P and N,
//    positive counts, and sums of (1 - cos) and l over P and of
//    max(l - margin, 0) over N; row sums in float64.  The CTA writes lse_i
//    and p_i of its rows and one record of partial sums; a one-warp kernel
//    adds the records in block order and writes the loss and the scalars of
//    the backward.
//  * Backward: per 128-column tile each warpgroup recomputes the cosines of
//    its 64 columns, forms their (G + G^T) from the row statistics of both
//    sides and writes it, split, into shared memory; then each adds
//    (G + G^T)_IJ x_J into its half of the CTA's 512 gradient columns, kept
//    in the tensor cores' accumulator: no atomics, no second pass.  Every
//    kFlush tiles (512 columns of J) the accumulator is added to dx with a
//    rounded add.  The chain costs precision (the gradient's norm off
//    float64's by 2.1e-6 at M = 32k, 3.8e-6 with 8 tiles; the plain float32
//    loss 4.9e-8), but a part summed apart every one or two k8 steps needs as
//    many registers again as the 64 x 256 gradient: as two halves in turn
//    it spilled and took the backward from 28 to 39 ms (3.8e-7).
//  * The margin's kink: (G + G^T) steps by 2 / (T nn) where l = margin, so
//    a pair's side of it is a decision, not a rounding.  A negative pair
//    whose recomputed cosine lies within kKinkBand of the kink (a bound on
//    the tensor cores' error) is decided again from its two rows of x in
//    float64, as the float64 twin decides it, and its weight in shared
//    memory patched: 68,126 pairs at the smoke's M = 32k, 1.3 ms of the
//    backward.
//  * Deterministic: every sum runs in a fixed order (shuffle trees, then
//    warps and blocks in index order), so a run repeats bit for bit.
//  * Nothing on the host: n_pos and n_neg stay on the card, in 64 bits, as
//    do tile offsets (M^2 passes 2^31 at M = 46,341).
// float64 inputs keep the earlier design: 256-thread CTAs of mma.sync f64
// tiles (m8n8k4, four to an m16n8k8 step) fed by a cp.async ring, the same
// masks, sums and order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

// the float64 route's CTAs
constexpr int kThreads = 256;  // 8 warps
constexpr int BM = 64;         // rows a CTA owns
constexpr int BN = 128;        // columns of a tile
constexpr int kStages = 3;     // depth of the cp.async ring
constexpr int kChunkRows = 16; // rows of x_J a backward product stage holds (two k8 steps)
constexpr unsigned kFull = 0xffffffffu;

// One row's metadata (in shared memory, and in the float32 route's scratch);
// lse and p only in the backward.
struct Meta {
  long long lab, grp;
  double lse;
  int flags, p;
};

template <typename T>
struct Cfg;
template <>
struct Cfg<double> {
  static constexpr int BK = 16;   // depth of a cosine stage
  static constexpr int DC = 128;  // gradient columns a backward CTA owns
};

template <typename T>
struct Layout {
  static constexpr int BK = Cfg<T>::BK, DC = Cfg<T>::DC;
  static constexpr int VE = 16 / sizeof(T);  // elements of a 16-byte copy
  static constexpr int SA = BK + 4;          // row stride of a cosine stage
  static constexpr int SC = DC + 8;          // row stride of a product stage
  static constexpr int SW = BN + 4;          // row stride of the (G + G^T) tile
  static constexpr int NC = DC / 32;         // n8 tiles of a warp's gradient slice
  static constexpr int kStageA = (BM + BN) * SA;
  static constexpr int kStageC = kChunkRows * SC;
  static constexpr int kBuf = kStages * (kStageA > kStageC ? kStageA : kStageC);
  static constexpr size_t kBufBytes = sizeof(T) * kBuf;
  static constexpr size_t kRingABytes = sizeof(T) * kStages * kStageA;  // the forward's ring
  static constexpr size_t kWBytes = sizeof(T) * BM * SW;
  static constexpr size_t kMetaBytes = sizeof(Meta) * (BM + BN);
  static_assert(BK / VE == 8, "a cosine stage row is eight 16-byte copies");
  static_assert(kBufBytes % 16 == 0 && kWBytes % 16 == 0 && kRingABytes % 16 == 0,
                "16-byte aligned regions");
};

// ---- arithmetic ----------------------------------------------------------

__device__ __forceinline__ float ex(float v) { return expf(v); }
__device__ __forceinline__ double ex(double v) { return exp(v); }
template <typename T>
__device__ __forceinline__ T mx(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T neg_inf() { return -static_cast<T>(INFINITY); }

template <typename T>
struct FragA;
template <typename T>
struct FragB;
template <>
struct FragA<double> {
  double v[4];
};
template <>
struct FragB<double> {
  double v[2];
};

// m16n8k8 fragments (g = lane / 4, t = lane % 4): A holds rows g, g + 8 at
// columns t, t + 4 in the order (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); B holds rows t, t + 4 of column g; C holds row g, then
// g + 8, at columns 2t and 2t + 1.
__device__ __forceinline__ void set_a(FragA<double>& f, double a0, double a1, double a2,
                                      double a3) {
  f.v[0] = a0;
  f.v[1] = a1;
  f.v[2] = a2;
  f.v[3] = a3;
}
__device__ __forceinline__ void set_b(FragB<double>& f, double b0, double b1) {
  f.v[0] = b0;
  f.v[1] = b1;
}

// m8n8k4 in float64: A row g column t, B row t column g, C row g at columns
// 2t and 2t + 1, so an m16n8k8 step is four of them on the same fragments
__device__ __forceinline__ void dmma(double& d0, double& d1, double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}
__device__ __forceinline__ void mma_more(double (&p)[4], const FragA<double>& a,
                                         const FragB<double>& b) {
  dmma(p[0], p[1], a.v[0], b.v[0]);
  dmma(p[0], p[1], a.v[2], b.v[1]);
  dmma(p[2], p[3], a.v[1], b.v[0]);
  dmma(p[2], p[3], a.v[3], b.v[1]);
}
__device__ __forceinline__ void mma_start(double (&p)[4], const FragA<double>& a,
                                          const FragB<double>& b) {
  p[0] = p[1] = p[2] = p[3] = 0.0;
  mma_more(p, a, b);
}

// d += a * b, one k8 step summed apart
template <typename T>
__device__ __forceinline__ void mma(T (&d)[4], const FragA<T>& a, const FragB<T>& b) {
  T p[4];
  mma_start(p, a, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += p[i];
}

// a / b rounded to nearest, given rb = 1 / b rounded to nearest: by
// Markstein's theorem the bits of __fdiv_rn(a, b) for normal operands, in a
// multiply and two fmas
__device__ __forceinline__ float quot(float a, float b, float rb) {
  const float q = __fmul_rn(a, rb);
  return __fmaf_rn(__fmaf_rn(-b, q, a), rb, q);
}
__device__ __forceinline__ double quot(double a, double b, double) { return a / b; }
__device__ __forceinline__ float recip(float b) { return __frcp_rn(b); }
__device__ __forceinline__ double recip(double b) { return 1.0 / b; }

// ---- copies ----------------------------------------------------------------

// 16 bytes global -> shared, or 16 zero bytes where !ok
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [base, base + n) of the metadata; rows past M have no flags
__device__ __forceinline__ void load_meta(Meta* dst, int n, int base, int M,
                                          const long long* __restrict__ lab,
                                          const long long* __restrict__ grp,
                                          const int* __restrict__ flags,
                                          const double* __restrict__ lse,
                                          const int* __restrict__ pcount) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int gi = base + i;
    Meta m{0, 0, 0.0, 0, 0};
    if (gi < M) {
      m.lab = lab[gi];
      m.grp = grp[gi];
      m.flags = flags[gi];
      if (lse != nullptr) {
        m.lse = lse[gi];
        m.p = pcount[gi];
      }
    }
    dst[i] = m;
  }
}

// 0: out of the loss, 1: positive, 2: negative
__device__ __forceinline__ int classify(int i, const Meta& a, int j, const Meta& b) {
  const int both = a.flags & b.flags;
  if (i == j || !(both & 1)) return 0;
  if (a.lab != b.lab) return 2;
  return (a.grp != b.grp && (both & 2)) ? 1 : 0;
}

// ---- the two products --------------------------------------------------------

// Warps: wm = warp / 4 takes rows 32 wm .. 32 wm + 31 of both products; wn =
// warp % 4 takes columns 32 wn .. of the cosine tile and the slice
// wn DC / 4 .. of the CTA's gradient columns.

// acc = x[r0 + 0..63] . x[c0 + 0..127]^T over all Dp, the warp's 32 x 32
template <typename T>
__device__ __forceinline__ void cos_tile(T (&acc)[2][4][4], const T* __restrict__ x, int M,
                                         int Dp, int r0, int c0, T* sbuf) {
  using L = Layout<T>;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = T(0);
  const int nk = Dp / L::BK;
  auto load = [&](int slot, int k) {
    T* dst = sbuf + slot * L::kStageA;
    const int k0 = k * L::BK;
#pragma unroll
    for (int u = 0; u < (BM + BN) * 8 / kThreads; ++u) {
      const int v = tid + u * kThreads;
      const int row = v >> 3, seg = v & 7;
      const int grow = row < BM ? r0 + row : c0 + row - BM;
      const bool ok = grow < M;
      const T* src = x + (ok ? static_cast<long long>(grow) * Dp + k0 + seg * L::VE : 0);
      cp16(dst + row * L::SA + seg * L::VE, src, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_commit();
  }
  for (int k = 0; k < nk; ++k) {
    cp_wait<kStages - 2>();
    __syncthreads();
    const int kn = k + kStages - 1;
    if (kn < nk) load(kn % kStages, kn);
    cp_commit();
    const T* st = sbuf + (k % kStages) * L::kStageA;
#pragma unroll
    for (int kk = 0; kk < L::BK / 8; ++kk) {
      FragA<T> a[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const T* p = st + (wm * 32 + mt * 16 + g) * L::SA + kk * 8 + t;
        set_a(a[mt], p[0], p[8 * L::SA], p[4], p[8 * L::SA + 4]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const T* q = st + (BM + wn * 32 + nt * 8 + g) * L::SA + kk * 8 + t;
        FragB<T> b;
        set_b(b, q[0], q[4]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma(acc[mt][nt], a[mt], b);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();
}

// accd += W[0..63][0..127] . x[c0 + 0..127][d0 + slice], W in shared memory
template <typename T>
__device__ __forceinline__ void dx_tile(T (&accd)[2][Layout<T>::NC][4],
                                        const T* __restrict__ x, int M, int Dp, int c0,
                                        int d0, const T* Ws, T* sbuf) {
  using L = Layout<T>;
  constexpr int NK = BN / kChunkRows;
  constexpr int kVecs = kChunkRows * L::DC / L::VE;
  static_assert(kVecs % kThreads == 0, "whole copies a thread");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wd = warp & 3;
  auto load = [&](int slot, int k) {
    T* dst = sbuf + slot * L::kStageC;
#pragma unroll
    for (int u = 0; u < kVecs / kThreads; ++u) {
      const int v = tid + u * kThreads;
      const int row = v / (L::DC / L::VE), seg = v % (L::DC / L::VE);
      const int grow = c0 + k * kChunkRows + row, col = d0 + seg * L::VE;
      const bool ok = grow < M && col < Dp;
      const T* src = x + (ok ? static_cast<long long>(grow) * Dp + col : 0);
      cp16(dst + row * L::SC + seg * L::VE, src, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    load(s, s);
    cp_commit();
  }
  for (int k = 0; k < NK; ++k) {
    cp_wait<kStages - 2>();
    __syncthreads();
    const int kn = k + kStages - 1;
    if (kn < NK) load(kn % kStages, kn);
    cp_commit();
    const T* st = sbuf + (k % kStages) * L::kStageC;
    FragA<T> a[2][2];  // [k8 step][m16 tile]
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const T* p = Ws + (wm * 32 + mt * 16 + g) * L::SW + k * kChunkRows + kk * 8 + t;
        set_a(a[kk][mt], p[0], p[8 * L::SW], p[4], p[8 * L::SW + 4]);
      }
#pragma unroll
    for (int nc = 0; nc < L::NC; ++nc) {
      const T* q = st + t * L::SC + wd * (L::DC / 4) + nc * 8 + g;
      FragB<T> b[2];
      set_b(b[0], q[0], q[4 * L::SC]);
      set_b(b[1], q[8 * L::SC], q[12 * L::SC]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        T p[4];
        mma_start(p, a[0][mt], b[0]);
        mma_more(p, a[1][mt], b[1]);
#pragma unroll
        for (int i = 0; i < 4; ++i) accd[mt][nc][i] += p[i];
      }
    }
  }
  cp_wait<0>();
  __syncthreads();
}

// (m, s) <- the log-sum-exp pair of both; s in float64
template <typename T>
__device__ __forceinline__ void lse_merge(T& m, double& s, T mo, double so) {
  const T mn = mx(m, mo);
  if (mn == neg_inf<T>()) return;  // both empty
  s = s * exp(static_cast<double>(m) - static_cast<double>(mn)) +
      so * exp(static_cast<double>(mo) - static_cast<double>(mn));
  m = mn;
}

// ---- forward -------------------------------------------------------------------

template <typename T>
struct RowPart {
  double s;
  T m;
  int p;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    contrastive_fwd_kernel(const T* __restrict__ x, int M, int Dp,
                           const long long* __restrict__ lab, const long long* __restrict__ grp,
                           const int* __restrict__ flags, T temp, T margin, int has_margin,
                           double* __restrict__ lse_out, int* __restrict__ p_out,
                           double* __restrict__ part_f, long long* __restrict__ part_i) {
  using L = Layout<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sbuf = reinterpret_cast<T*>(smem);
  Meta* srow = reinterpret_cast<Meta*>(smem + L::kRingABytes);
  Meta* scol = srow + BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
  const int r0 = blockIdx.x * BM;
  const T rtemp = recip(temp);
  load_meta(srow, BM, r0, M, lab, grp, flags, nullptr, nullptr);

  // this thread's rows: r = 2 mt + h is row 32 wm + 16 mt + 8 h + g
  T m[4];
  double s[4];
  int p[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = neg_inf<T>();
    s[r] = 0.0;
    p[r] = 0;
  }
  double pos_cos = 0.0, pos_l = 0.0, pen = 0.0;
  long long nneg = 0;

  const int nJ = (M + BN - 1) / BN;
  for (int jt = 0; jt < nJ; ++jt) {
    const int c0 = jt * BN;
    __syncthreads();  // the last tile's readers of scol are done
    load_meta(scol, BN, c0, M, lab, grp, flags, nullptr, nullptr);
    T acc[2][4][4];
    cos_tile<T>(acc, x, M, Dp, r0, c0, sbuf);  // its barriers publish scol
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 2 * mt + h;
        const int il = wm * 32 + mt * 16 + h * 8 + g;
        const Meta ri = srow[il];
        T lv[8];
        unsigned vm = 0;
        T tmax = neg_inf<T>(), pen_t = T(0);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int jl = wn * 32 + nt * 8 + 2 * t + e, k = 2 * nt + e;
            const int cls = classify(r0 + il, ri, c0 + jl, scol[jl]);
            const T cs = acc[mt][nt][2 * h + e];
            const T l = quot(cs, temp, rtemp);
            lv[k] = l;
            if (cls != 0) {
              vm |= 1u << k;
              tmax = mx(tmax, l);
            }
            if (cls == 1) {
              ++p[r];
              pos_cos += static_cast<double>(T(1) - cs);
              pos_l += static_cast<double>(l);
            } else if (cls == 2) {
              ++nneg;
              if (has_margin) {
                const T d = l - margin;
                if (d > T(0)) pen_t += d;
              }
            }
          }
        if (vm != 0) {
          const T mn = mx(m[r], tmax);
          T ps = T(0);
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if ((vm >> k) & 1u) ps += ex(lv[k] - mn);
          s[r] = s[r] * static_cast<double>(ex(m[r] - mn)) + static_cast<double>(ps);
          m[r] = mn;
        }
        pen += static_cast<double>(pen_t);
      }
  }

  // rows across the quad, then across the four column warps in order
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const T mo = __shfl_xor_sync(kFull, m[r], off);
      const double so = __shfl_xor_sync(kFull, s[r], off);
      p[r] += __shfl_xor_sync(kFull, p[r], off);
      lse_merge(m[r], s[r], mo, so);
    }
  RowPart<T>* part = reinterpret_cast<RowPart<T>*>(sbuf);  // the ring is idle now
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int il = wm * 32 + (r >> 1) * 16 + (r & 1) * 8 + g;
      part[wn * BM + il] = RowPart<T>{s[r], m[r], p[r]};
    }
  }
  __syncthreads();
  double plse = 0.0;
  long long npos = 0;
  if (tid < BM) {
    T mm = part[tid].m;
    double ss = part[tid].s;
    int pp = part[tid].p;
    for (int w = 1; w < 4; ++w) {
      lse_merge(mm, ss, part[w * BM + tid].m, part[w * BM + tid].s);
      pp += part[w * BM + tid].p;
    }
    const double lse = ss > 0.0 ? static_cast<double>(mm) + log(ss) : 0.0;
    const int gi = r0 + tid;
    if (gi < M) {
      lse_out[gi] = lse;
      p_out[gi] = pp;
    }
    plse = pp * lse;
    npos = pp;
  }

  // the CTA's record: shuffle trees, then the warps in order
  double v[4] = {pos_cos, pos_l, pen, plse};
  long long c[2] = {npos, nneg};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] += __shfl_down_sync(kFull, v[k], off);
    c[0] += __shfl_down_sync(kFull, c[0], off);
    c[1] += __shfl_down_sync(kFull, c[1], off);
  }
  double* wf = reinterpret_cast<double*>(part + 4 * BM);
  long long* wi = reinterpret_cast<long long*>(wf + 4 * (kThreads / 32));
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) wf[4 * warp + k] = v[k];
    wi[2 * warp] = c[0];
    wi[2 * warp + 1] = c[1];
  }
  __syncthreads();
  if (tid == 0) {
    double a[4] = {0.0, 0.0, 0.0, 0.0};
    long long b[2] = {0, 0};
    for (int w = 0; w < kThreads / 32; ++w) {
      for (int k = 0; k < 4; ++k) a[k] += wf[4 * w + k];
      b[0] += wi[2 * w];
      b[1] += wi[2 * w + 1];
    }
    for (int k = 0; k < 4; ++k) part_f[4 * static_cast<long long>(blockIdx.x) + k] = a[k];
    part_i[2 * static_cast<long long>(blockIdx.x)] = b[0];
    part_i[2 * static_cast<long long>(blockIdx.x) + 1] = b[1];
  }
}

// One warp: the CTAs' records in block order, then the loss, and for the
// backward {n_pos > 0, max(n_pos, 1), max(n_neg, 1)}.
template <typename T>
__global__ void contrastive_finalize_kernel(const double* __restrict__ part_f,
                                            const long long* __restrict__ part_i, int nblk,
                                            int has_margin, T* __restrict__ loss,
                                            double* __restrict__ stats) {
  const int lane = threadIdx.x;
  double v[4] = {0.0, 0.0, 0.0, 0.0};
  long long c[2] = {0, 0};
  for (int b = lane; b < nblk; b += 32) {
    for (int k = 0; k < 4; ++k) v[k] += part_f[4 * static_cast<long long>(b) + k];
    c[0] += part_i[2 * static_cast<long long>(b)];
    c[1] += part_i[2 * static_cast<long long>(b) + 1];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] += __shfl_down_sync(kFull, v[k], off);
    c[0] += __shfl_down_sync(kFull, c[0], off);
    c[1] += __shfl_down_sync(kFull, c[1], off);
  }
  if (lane == 0) {
    const double pd = c[0] > 1 ? static_cast<double>(c[0]) : 1.0;
    const double nn = c[1] > 1 ? static_cast<double>(c[1]) : 1.0;
    // mean (1 - cos) over P, then the InfoNCE term -(sum_P l - sum_i p_i lse_i) / pd
    double total = v[0] / pd + (v[3] - v[1]) / pd;
    if (has_margin) total += v[2] / nn;
    *loss = c[0] > 0 ? static_cast<T>(total) : T(0);
    stats[0] = c[0] > 0 ? 1.0 : 0.0;
    stats[1] = pd;
    stats[2] = nn;
  }
}

// ---- backward -------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    contrastive_bwd_kernel(const T* __restrict__ x, int M, int Dp,
                           const long long* __restrict__ lab, const long long* __restrict__ grp,
                           const int* __restrict__ flags, T temp, T margin, int has_margin,
                           const double* __restrict__ lse, const int* __restrict__ pcount,
                           const double* __restrict__ stats, const T* __restrict__ gout,
                           T* __restrict__ dx) {
  using L = Layout<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sbuf = reinterpret_cast<T*>(smem);
  T* Ws = reinterpret_cast<T*>(smem + L::kBufBytes);
  Meta* srow = reinterpret_cast<Meta*>(smem + L::kBufBytes + L::kWBytes);
  Meta* scol = srow + BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
  const int r0 = blockIdx.x * BM, d0 = blockIdx.y * L::DC;
  const T rtemp = recip(temp);
  load_meta(srow, BM, r0, M, lab, grp, flags, lse, pcount);

  // the upstream gradient and the loss's scalars folded into three weights
  const double on = stats[0], pd = stats[1], nn = stats[2];
  const double gd = static_cast<double>(gout[0]), td = static_cast<double>(temp);
  const T cP = static_cast<T>(on * gd * (-2.0 / pd) * (1.0 + 1.0 / td));
  const T cS = static_cast<T>(on * gd / (td * pd));
  const T cN = has_margin ? static_cast<T>(on * gd * 2.0 / (td * nn)) : T(0);

  T accd[2][L::NC][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < L::NC; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) accd[a][b][c] = T(0);

  const int nJ = (M + BN - 1) / BN;
  for (int jt = 0; jt < nJ; ++jt) {
    const int c0 = jt * BN;
    __syncthreads();  // the last tile's readers of scol are done
    load_meta(scol, BN, c0, M, lab, grp, flags, lse, pcount);
    T acc[2][4][4];
    cos_tile<T>(acc, x, M, Dp, r0, c0, sbuf);  // its barriers publish scol
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int il = wm * 32 + mt * 16 + h * 8 + g;
        const Meta ri = srow[il];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int jl = wn * 32 + nt * 8 + 2 * t + e;
            const Meta cj = scol[jl];
            const int cls = classify(r0 + il, ri, c0 + jl, cj);
            T w = T(0);
            if (cls != 0) {
              const T l = quot(acc[mt][nt][2 * h + e], temp, rtemp);
              const T si = ex(static_cast<T>(static_cast<double>(l) - ri.lse));
              const T sj = ex(static_cast<T>(static_cast<double>(l) - cj.lse));
              w = cS * (static_cast<T>(ri.p) * si + static_cast<T>(cj.p) * sj);
              if (cls == 1)
                w += cP;
              else if (has_margin && l - margin >= T(0))
                w += cN;
            }
            Ws[il * L::SW + jl] = w;
          }
      }
    dx_tile<T>(accd, x, M, Dp, c0, d0, Ws, sbuf);  // its first barrier publishes Ws
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nc = 0; nc < L::NC; ++nc)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = r0 + wm * 32 + mt * 16 + g + 8 * (c >> 1);
        const int col = d0 + wn * (L::DC / 4) + nc * 8 + 2 * t + (c & 1);
        if (row < M && col < Dp) dx[static_cast<long long>(row) * Dp + col] = accd[mt][nc][c];
      }
}

template <typename T>
int run_forward(const void* x, int M, int Dp, const void* lab, const void* grp, const void* flags,
            double temperature, double margin, int has_margin, void* lse, void* pcount,
            void* part_f, void* part_i, void* loss, void* stats, cudaStream_t stream) {
  using L = Layout<T>;
  const int nblk = (M + BM - 1) / BM;
  if (nblk > 0) {
    const size_t smem = L::kRingABytes + L::kMetaBytes;
    cudaError_t e = cudaFuncSetAttribute(contrastive_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    contrastive_fwd_kernel<T><<<nblk, kThreads, smem, stream>>>(
        static_cast<const T*>(x), M, Dp, static_cast<const long long*>(lab),
        static_cast<const long long*>(grp), static_cast<const int*>(flags),
        static_cast<T>(temperature), static_cast<T>(margin), has_margin,
        static_cast<double*>(lse), static_cast<int*>(pcount), static_cast<double*>(part_f),
        static_cast<long long*>(part_i));
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  contrastive_finalize_kernel<T><<<1, 32, 0, stream>>>(
      static_cast<const double*>(part_f), static_cast<const long long*>(part_i), nblk,
      has_margin, static_cast<T*>(loss), static_cast<double*>(stats));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_backward(const void* x, int M, int Dp, const void* lab, const void* grp, const void* flags,
             double temperature, double margin, int has_margin, const void* lse,
             const void* pcount, const void* stats, const void* gout, void* dx,
             cudaStream_t stream) {
  using L = Layout<T>;
  if (M == 0) return 0;
  const size_t smem = L::kBufBytes + L::kWBytes + L::kMetaBytes;
  cudaError_t e = cudaFuncSetAttribute(contrastive_bwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((M + BM - 1) / BM, (Dp + L::DC - 1) / L::DC);
  contrastive_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), M, Dp, static_cast<const long long*>(lab),
      static_cast<const long long*>(grp), static_cast<const int*>(flags),
      static_cast<T>(temperature), static_cast<T>(margin), has_margin,
      static_cast<const double*>(lse), static_cast<const int*>(pcount),
      static_cast<const double*>(stats), static_cast<const T*>(gout), static_cast<T*>(dx));
  return static_cast<int>(cudaGetLastError());
}

// ---- float32: 3xTF32 on warpgroup MMA -------------------------------------

namespace tf32 {

constexpr int kConsumers = 2;                            // warpgroups that multiply
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kConsumerWarps = kConsumerThreads / 32;
// and a producer warpgroup, so that setmaxnreg can hand its registers to the
// consumers: all 384 threads enter with 168 registers (65,536 / 384), the
// producer keeps 24 of its threads' and the consumers take 72 more each
constexpr int kThreads = kConsumerThreads + 128;
constexpr int kRegsAtEntry = 168, kProducerRegs = 24, kConsumerRegs = 240;
static_assert((kRegsAtEntry - kProducerRegs) * 128 ==
                  (kConsumerRegs - kRegsAtEntry) * kConsumerThreads,
              "the producer frees what the consumers take");
constexpr int BM = 64;                                   // rows a CTA owns
constexpr int kFwdCols = 256, kBwdCols = 128;            // columns of a tile
constexpr int kRowAlign = 256;                           // planes' rows: M rounded up to it
constexpr int KS = 16;                                   // depth of a cosine stage: two k8 blocks
constexpr int kFwdSlots = 5, kBwdSlots = 4;              // depth of the rings
constexpr int kFwdSlotFloats = 4 * (BM + kFwdCols) * 8;  // a stage: hi, lo of x_I and x_J, 40 KB
constexpr int kBwdSlotFloats = 8192;                     // the larger of a cosine stage (24 KB)
                                                         // and a product stage (<= 32 KB)
constexpr int kFlush = 4;                                // column tiles between gradient flushes
constexpr int kWFloats = BM * kBwdCols;                  // one plane of (G + G^T) of a tile
constexpr int DC = 512;  // gradient columns a backward CTA owns (its two warpgroups half each)

// Offset in floats of element (r, k) of a K-major plane of R rows (R a
// multiple of 8): blocks of 8 k one after another, each R rows x 8 k in the
// tensor cores' core-matrix order (a core matrix is 8 rows x 4 k, 16 bytes a
// row; a row group's two sit side by side), so rows [r0, r0 + n) of a block
// are n * 32 contiguous bytes, which one bulk copy moves.
__host__ __device__ __forceinline__ long long plane_at(int r, int k, int R) {
  return static_cast<long long>(k >> 3) * R * 8 + (r >> 3) * 64 + ((k >> 2) & 1) * 32 +
         (r & 7) * 4 + (k & 3);
}

// classify's positive (1) and negative (2) as flags, without branches: a
// divergent branch per element cost the epilogues more than their arithmetic
struct PairClass {
  bool pos, neg;
};
__device__ __forceinline__ PairClass pair_class(int i, const Meta& a, int j, const Meta& b) {
  const int both = a.flags & b.flags;
  const bool pair = (i != j) & ((both & 1) != 0);
  const bool same = a.lab == b.lab;
  PairClass c;
  c.pos = pair & same & (a.grp != b.grp) & ((both & 2) != 0);
  c.neg = pair & !same;
  return c;
}

// The scratch of a call, carved from one buffer: every row's metadata, the
// hi and lo planes of x [Mp x Dp] and, for the backward, of x^T [Dpp x Mp]
struct Planes {
  Meta* meta;
  float *xh, *xl, *th, *tl;
  int Mp, Dp, Dpp;
};

__host__ __device__ __forceinline__ long long round_up(long long v, long long m) {
  return (v + m - 1) / m * m;
}

inline size_t scratch_bytes(int M, int Dp, bool backward) {
  const long long Mp = round_up(M, kRowAlign), Dpp = round_up(Dp, DC);
  return static_cast<size_t>(Mp * sizeof(Meta) + 2 * Mp * Dp * 4 +
                             (backward ? 2 * Dpp * Mp * 4 : 0));
}

inline Planes carve(void* scratch, int M, int Dp, bool backward) {
  Planes P;
  P.Mp = static_cast<int>(round_up(M, kRowAlign));
  P.Dp = Dp;
  P.Dpp = static_cast<int>(round_up(Dp, DC));
  P.meta = static_cast<Meta*>(scratch);
  P.xh = reinterpret_cast<float*>(P.meta + P.Mp);
  P.xl = P.xh + static_cast<long long>(P.Mp) * Dp;
  P.th = backward ? P.xl + static_cast<long long>(P.Mp) * Dp : nullptr;
  P.tl = backward ? P.th + static_cast<long long>(P.Dpp) * P.Mp : nullptr;
  return P;
}

// A ring's slot and the parity of its current round
template <int N>
struct Pipe {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void advance() {
    if (++slot == N) {
      slot = 0;
      phase ^= 1u;
    }
  }
};

// the consumer warpgroups' named barrier (the producer takes no part)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumerThreads) : "memory");
}

// ---- wgmma

// Matrix descriptor of a block of rows x 8 k at p in plane order: core
// matrices 128 bytes apart along K (lbo), row groups 256 bytes apart (sbo)
__device__ __forceinline__ uint64_t desc(const float* p) { return make_desc(p, 128, 256); }

// Both operands from shared memory, K-major in core-matrix order.

// d[64 x 64] += a[64 x 8] * b[8 x 64] (d = a * b where scale_d is 0)
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d)
      : "memory");
}

// d[64 x 128] += a[64 x 8] * b[8 x 128] (d = a * b where scale_d is 0)
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d)
      : "memory");
}

// d[64 x 256] += a[64 x 8] * b[8 x 256] (d = a * b where scale_d is 0)
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (N == 64)
    wgmma_n64(d, a, b, scale_d);
  else if constexpr (N == 128)
    wgmma_n128(d, a, b, scale_d);
  else
    wgmma_n256(d, a, b, scale_d);
}
// d (+)= a * b in 3xTF32, the small terms first: lo * hi', hi * lo', hi * hi';
// scale_d 0 starts a new sum
template <int N>
__device__ __forceinline__ void wgmma3(float (&d)[N / 2], const float* a, int a_lo,
                                       const float* b, int b_lo, int scale_d) {
  const uint64_t ah = desc(a), al = desc(a + a_lo), bh = desc(b), bl = desc(b + b_lo);
  wgmma<N>(d, al, bh, scale_d);
  wgmma<N>(d, ah, bl, 1);
  wgmma<N>(d, ah, bh, 1);
}

// acc = x_I . x_J^T of one tile, over its nK stages of two k8 blocks: the
// three products of kChain blocks at a time summed apart in the tensor
// cores (in part), then added to acc with a rounded add.  The tensor cores
// round their own sums toward zero, so a long chain of them drifts toward
// zero.  Offsets in floats within a stage: a_off, b_off to this
// warpgroup's rows of the first hi blocks of x_I and x_J, a_lo, b_lo from a
// hi block to its lo block, a_k, b_k from a stage's first k8 block to its
// second.  Each stage is released once its products are done.
template <int N, int kSlots, int kChain>
__device__ __forceinline__ void cosine_tile(float (&acc)[N / 2], float (&part)[N / 2],
                                            const float* ring, int slot_floats,
                                            Pipe<kSlots>& in, uint64_t* full, uint64_t* empty,
                                            int nK, int lane, int a_off, int a_lo, int a_k,
                                            int b_off, int b_lo, int b_k) {
  static_assert(kChain == 1 || kChain == 2, "one or both blocks of a stage a chain");
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  for (int ks = 0; ks < nK; ++ks) {
    mbar_wait(&full[in.slot], in.phase);
    const float* st = ring + in.slot * slot_floats;
#pragma unroll
    for (int kk = 0; kk < 2; kk += kChain) {
      wgmma_fence();
      wgmma3<N>(part, st + a_off + kk * a_k, a_lo, st + b_off + kk * b_k, b_lo, 0);
      if constexpr (kChain == 2)
        wgmma3<N>(part, st + a_off + a_k, a_lo, st + b_off + b_k, b_lo, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] += part[i];
    }
    if (lane == 0) mbar_arrive(&empty[in.slot]);
    in.advance();
  }
}

// The float32 route's cosines lie within this of those of x's rows (unit
// rows: a bound on the 3xTF32 split, the dropped lo * lo', the tensor
// cores' sums toward zero and the rounded adds, at Dp 512)
constexpr float kKinkBand = 4e-6f;

// x_i . x_j in float64 (each product exact) over Dp columns, by a warp's
// 32 lanes, four columns a lane a step, their sums added in a fixed tree;
// every lane returns lane 0's sum
__device__ __forceinline__ double warp_cosine64(const float* __restrict__ x, int Dp, int i, int j,
                                                int lane) {
  const float* a = x + static_cast<long long>(i) * Dp;
  const float* b = x + static_cast<long long>(j) * Dp;
  double s = 0.0;
#pragma unroll 4
  for (int c = 4 * lane; c < Dp; c += 128) {
    const float4 u = *reinterpret_cast<const float4*>(a + c);
    const float4 v = *reinterpret_cast<const float4*>(b + c);
    s = fma(static_cast<double>(u.x), static_cast<double>(v.x), s);
    s = fma(static_cast<double>(u.y), static_cast<double>(v.y), s);
    s = fma(static_cast<double>(u.z), static_cast<double>(v.z), s);
    s = fma(static_cast<double>(u.w), static_cast<double>(v.w), s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(kFull, s, off);
  return __shfl_sync(kFull, s, 0);
}

// ---- the planes

// hi = tf32(v), lo = tf32(v - hi) of four values
__device__ __forceinline__ void split4(const float4& v, float4& hi, float4& lo) {
  hi = make_float4(__uint_as_float(to_tf32(v.x)), __uint_as_float(to_tf32(v.y)),
                   __uint_as_float(to_tf32(v.z)), __uint_as_float(to_tf32(v.w)));
  lo = make_float4(__uint_as_float(to_tf32(v.x - hi.x)), __uint_as_float(to_tf32(v.y - hi.y)),
                   __uint_as_float(to_tf32(v.z - hi.z)), __uint_as_float(to_tf32(v.w - hi.w)));
}

// x [M, Dp] (Dp a multiple of 32) into the hi and lo planes of x (Mp rows,
// K = Dp) and, when th is set, of x^T (Dpp rows, K = Mp), zero past M and
// Dp; one 32 x 32 tile a block
__global__ void __launch_bounds__(256) pack_planes_kernel(const float* __restrict__ x, int M,
                                                          Planes P) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.x * 32, c0 = blockIdx.y * 32;
  const int rr = threadIdx.x >> 3, cq = (threadIdx.x & 7) * 4;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r0 + rr < M && c0 + cq < P.Dp)
    v = *reinterpret_cast<const float4*>(x + static_cast<long long>(r0 + rr) * P.Dp + c0 + cq);
  float4 hi, lo;
  if (c0 < P.Dp) {
    split4(v, hi, lo);
    const long long o = plane_at(r0 + rr, c0 + cq, P.Mp);
    *reinterpret_cast<float4*>(P.xh + o) = hi;
    *reinterpret_cast<float4*>(P.xl + o) = lo;
  }
  if (P.th != nullptr) {
    tile[rr][cq] = v.x;
    tile[rr][cq + 1] = v.y;
    tile[rr][cq + 2] = v.z;
    tile[rr][cq + 3] = v.w;
    __syncthreads();
    // x^T's row c0 + rr at k = r0 + cq ..: x's rows r0 + cq .. at column c0 + rr
    split4(make_float4(tile[cq][rr], tile[cq + 1][rr], tile[cq + 2][rr], tile[cq + 3][rr]), hi,
           lo);
    const long long o = plane_at(c0 + rr, r0 + cq, P.Dpp);
    *reinterpret_cast<float4*>(P.th + o) = hi;
    *reinterpret_cast<float4*>(P.tl + o) = lo;
  }
}

// Every row's metadata, rows past M without flags; lse and p where given
__global__ void pack_meta_kernel(int M, Planes P, const long long* __restrict__ lab,
                                 const long long* __restrict__ grp,
                                 const int* __restrict__ flags, const double* __restrict__ lse,
                                 const int* __restrict__ pcount) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.Mp) return;
  Meta m{0, 0, 0.0, 0, 0};
  if (i < M) {
    m.lab = lab[i];
    m.grp = grp[i];
    m.flags = flags[i];
    if (lse != nullptr) {
      m.lse = lse[i];
      m.p = pcount[i];
    }
  }
  P.meta[i] = m;
}

// ---- forward

constexpr size_t kFwdSmem = sizeof(float) * kFwdSlots * kFwdSlotFloats  // the ring
                            + sizeof(Meta) * 2 * kFwdCols                // column metadata
                            + sizeof(RowPart<float>) * 2 * BM            // rows, per warpgroup
                            + 8 * 6 * kConsumerWarps                     // the CTA's record
                            + 8 * 2 * (kFwdSlots + 2);                   // barriers

// A CTA owns 64 rows and walks 256-column tiles; warpgroup w takes columns
// 128 w .. 128 w + 127 of each.  Per stage of 16 k the producer copies the
// hi and lo blocks of x_I and x_J; each warpgroup's 64 x 128 cosines sum in
// registers, then feed the online log-sum-exp of its rows.
__global__ void __launch_bounds__(kThreads, 1)
    contrastive_fwd_wgmma_kernel(Planes P, int M, float temp, float margin, int has_margin,
                                 double* __restrict__ lse_out, int* __restrict__ p_out,
                                 double* __restrict__ part_f, long long* __restrict__ part_i) {
  extern __shared__ __align__(1024) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  Meta* smeta = reinterpret_cast<Meta*>(ring + kFwdSlots * kFwdSlotFloats);
  RowPart<float>* rows = reinterpret_cast<RowPart<float>*>(smeta + 2 * kFwdCols);
  double* rec_f = reinterpret_cast<double*>(rows + 2 * BM);                // [warp][4]
  long long* rec_i = reinterpret_cast<long long*>(rec_f + 4 * kConsumerWarps);  // [warp][2]
  uint64_t* full = reinterpret_cast<uint64_t*>(rec_i + 2 * kConsumerWarps);
  uint64_t* empty = full + kFwdSlots;
  uint64_t* mfull = empty + kFwdSlots;
  uint64_t* mempty = mfull + 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * BM;
  const int nJ = P.Mp / kFwdCols, nK = P.Dp / KS;
  if (tid == 0) {
    for (int s = 0; s < kFwdSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&mfull[s], 1);
      mbar_init(&mempty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp != kConsumerWarps || lane != 0) return;
    Pipe<kFwdSlots> in;
    for (int jt = 0; jt < nJ; ++jt) {
      const int c0 = jt * kFwdCols, ms = jt & 1;
      mbar_wait(&mempty[ms], ((jt >> 1) & 1) ^ 1u);
      mbar_expect_tx(&mfull[ms], sizeof(Meta) * kFwdCols);
      bulk_load(smeta + ms * kFwdCols, P.meta + c0, sizeof(Meta) * kFwdCols, &mfull[ms]);
      for (int ks = 0; ks < nK; ++ks) {
        mbar_wait(&empty[in.slot], in.phase ^ 1u);
        float* st = ring + in.slot * kFwdSlotFloats;
        mbar_expect_tx(&full[in.slot], 4 * 32 * (BM + kFwdCols));
#pragma unroll
        for (int b = 0; b < 4; ++b) {  // hi k0, hi k1, lo k0, lo k1
          const float* plane = b < 2 ? P.xh : P.xl;
          const int k = KS * ks + 8 * (b & 1);
          bulk_load(st + b * BM * 8, plane + plane_at(r0, k, P.Mp), 32 * BM, &full[in.slot]);
          bulk_load(st + 4 * BM * 8 + b * kFwdCols * 8, plane + plane_at(c0, k, P.Mp),
                    32 * kFwdCols, &full[in.slot]);
        }
        in.advance();
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = warp >> 2, q = warp & 3, g = lane >> 2, t = lane & 3;
  const float rtemp = recip(temp);
  // this thread's rows: h = 0, 1 is row 16 q + g + 8 h; its columns of a
  // tile 128 wg + 8 n + 2 t + e, held in acc[4 n + 2 h + e]
  Meta ri[2];
  float m[2];
  double s[2];
  int p[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ri[h] = P.meta[r0 + 16 * q + g + 8 * h];
    m[h] = neg_inf<float>();
    s[h] = 0.0;
    p[h] = 0;
  }
  double pos_cos = 0.0, pos_l = 0.0, pen = 0.0;
  int nneg = 0;  // this thread's: at most 64 a tile
  float acc[64], part[64];
  Pipe<kFwdSlots> in;
  for (int jt = 0; jt < nJ; ++jt) {
    const int c0 = jt * kFwdCols;
    cosine_tile<128, kFwdSlots, 1>(acc, part, ring, kFwdSlotFloats, in, full, empty, nK, lane,
                                   0, 2 * BM * 8, BM * 8, 4 * BM * 8 + wg * 128 * 8,
                                   2 * kFwdCols * 8, kFwdCols * 8);
    mbar_wait(&mfull[jt & 1], (jt >> 1) & 1);
    const Meta* scol = smeta + (jt & 1) * kFwdCols + 128 * wg;
    const int cb = c0 + 128 * wg;
#pragma unroll
    for (int b = 0; b < 4; ++b) {  // groups of eight columns, each column's metadata read once
      float lv[2][8], tmax[2], pc_t[2], pl_t[2], pen_t[2];
      unsigned vm[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tmax[h] = neg_inf<float>();
        pc_t[h] = pl_t[h] = pen_t[h] = 0.f;
        vm[h] = 0;
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = 4 * b + a, k = 2 * a + e, jl = 8 * n + 2 * t + e;
          const Meta cj = scol[jl];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const PairClass c = pair_class(r0 + 16 * q + g + 8 * h, ri[h], cb + jl, cj);
            const float cs = acc[4 * n + 2 * h + e];
            const float l = quot(cs, temp, rtemp);
            lv[h][k] = l;
            vm[h] |= static_cast<unsigned>(c.pos | c.neg) << k;
            tmax[h] = c.pos | c.neg ? mx(tmax[h], l) : tmax[h];
            p[h] += c.pos;
            pc_t[h] += c.pos ? 1.f - cs : 0.f;
            pl_t[h] += c.pos ? l : 0.f;
            nneg += c.neg;
            pen_t[h] += c.neg && has_margin ? fmaxf(l - margin, 0.f) : 0.f;
          }
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (vm[h] != 0) {
          const float mn = mx(m[h], tmax[h]);
          float ps = 0.f;
#pragma unroll
          for (int k = 0; k < 8; ++k) ps += (vm[h] >> k) & 1u ? ex(lv[h][k] - mn) : 0.f;
          s[h] = s[h] * static_cast<double>(ex(m[h] - mn)) + static_cast<double>(ps);
          m[h] = mn;
        }
        pos_cos += static_cast<double>(pc_t[h]);
        pos_l += static_cast<double>(pl_t[h]);
        pen += static_cast<double>(pen_t[h]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&mempty[jt & 1]);
  }

  // rows across the quad, then the two warpgroups in order
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float mo = __shfl_xor_sync(kFull, m[h], off);
      const double so = __shfl_xor_sync(kFull, s[h], off);
      p[h] += __shfl_xor_sync(kFull, p[h], off);
      lse_merge(m[h], s[h], mo, so);
    }
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rows[wg * BM + 16 * q + g + 8 * h] = RowPart<float>{s[h], m[h], p[h]};
  }
  consumers_sync();
  double plse = 0.0;
  long long npos = 0;
  if (tid < BM) {
    float mm = rows[tid].m;
    double ss = rows[tid].s;
    lse_merge(mm, ss, rows[BM + tid].m, rows[BM + tid].s);
    const int pp = rows[tid].p + rows[BM + tid].p;
    const double lse = ss > 0.0 ? static_cast<double>(mm) + log(ss) : 0.0;
    const int gi = r0 + tid;
    if (gi < M) {
      lse_out[gi] = lse;
      p_out[gi] = pp;
    }
    plse = pp * lse;
    npos = pp;
  }

  // the CTA's record: shuffle trees, then the warps in order
  double v[4] = {pos_cos, pos_l, pen, plse};
  long long c[2] = {npos, nneg};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] += __shfl_down_sync(kFull, v[k], off);
    c[0] += __shfl_down_sync(kFull, c[0], off);
    c[1] += __shfl_down_sync(kFull, c[1], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) rec_f[4 * warp + k] = v[k];
    rec_i[2 * warp] = c[0];
    rec_i[2 * warp + 1] = c[1];
  }
  consumers_sync();
  if (tid == 0) {
    double a[4] = {0.0, 0.0, 0.0, 0.0};
    long long b[2] = {0, 0};
    for (int w = 0; w < kConsumerWarps; ++w) {
      for (int k = 0; k < 4; ++k) a[k] += rec_f[4 * w + k];
      b[0] += rec_i[2 * w];
      b[1] += rec_i[2 * w + 1];
    }
    for (int k = 0; k < 4; ++k) part_f[4 * static_cast<long long>(blockIdx.x) + k] = a[k];
    part_i[2 * static_cast<long long>(blockIdx.x)] = b[0];
    part_i[2 * static_cast<long long>(blockIdx.x) + 1] = b[1];
  }
}

// ---- backward

constexpr size_t kBwdSmem = sizeof(float) * kBwdSlots * kBwdSlotFloats  // the ring
                            + sizeof(float) * 2 * kWFloats               // (G + G^T), hi and lo
                            + sizeof(Meta) * (2 * kBwdCols + BM)         // columns', rows' metadata
                            + 8 * 2 * (kBwdSlots + 2);                   // barriers

// A CTA owns 64 rows and DC gradient columns, and walks 128-column tiles.
// Per tile, warpgroup w: the cosines of the tile's columns 64 w .. 64 w + 63
// (stages of 16 k, as the forward), their (G + G^T) into shared memory, hi
// and lo in plane order; then, once both halves are there, (G + G^T)_IJ
// x_J into its DC / 2 gradient columns, one stage of x^T's hi and lo
// blocks per k8 of J.  The gradient stays in the tensor cores' accumulator
// for kFlush tiles, then is added to dx with a rounded add (written the
// first time): no atomics, one fixed order.
__global__ void __launch_bounds__(kThreads, 1)
    contrastive_bwd_wgmma_kernel(Planes P, const float* __restrict__ x, int M, float temp,
                                 float margin, double temp64, double margin64, int has_margin,
                                 const double* __restrict__ stats,
                                 const float* __restrict__ gout, float* __restrict__ dx_out) {
  constexpr int NW = DC / 2;  // gradient columns of a warpgroup
  extern __shared__ __align__(1024) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* W = ring + kBwdSlots * kBwdSlotFloats;  // hi plane, then lo: 64 rows, K = 128
  Meta* smeta = reinterpret_cast<Meta*>(W + 2 * kWFloats);
  Meta* srow = smeta + 2 * kBwdCols;
  uint64_t* full = reinterpret_cast<uint64_t*>(srow + BM);
  uint64_t* empty = full + kBwdSlots;
  uint64_t* mfull = empty + kBwdSlots;
  uint64_t* mempty = mfull + 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * BM, d0 = blockIdx.y * DC;
  const int nJ = P.Mp / kBwdCols, nK = P.Dp / KS;
  if (tid == 0) {
    for (int s = 0; s < kBwdSlots; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumerWarps);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&mfull[s], 1);
      mbar_init(&mempty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (warp != kConsumerWarps || lane != 0) return;
    Pipe<kBwdSlots> in;
    for (int jt = 0; jt < nJ; ++jt) {
      const int c0 = jt * kBwdCols, ms = jt & 1;
      mbar_wait(&mempty[ms], ((jt >> 1) & 1) ^ 1u);
      mbar_expect_tx(&mfull[ms], sizeof(Meta) * kBwdCols);
      bulk_load(smeta + ms * kBwdCols, P.meta + c0, sizeof(Meta) * kBwdCols, &mfull[ms]);
      for (int ks = 0; ks < nK; ++ks) {  // cosine stages
        mbar_wait(&empty[in.slot], in.phase ^ 1u);
        float* st = ring + in.slot * kBwdSlotFloats;
        mbar_expect_tx(&full[in.slot], 4 * 32 * (BM + kBwdCols));
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const float* plane = b < 2 ? P.xh : P.xl;
          const int k = KS * ks + 8 * (b & 1);
          bulk_load(st + b * BM * 8, plane + plane_at(r0, k, P.Mp), 32 * BM, &full[in.slot]);
          bulk_load(st + 4 * BM * 8 + b * kBwdCols * 8, plane + plane_at(c0, k, P.Mp),
                    32 * kBwdCols, &full[in.slot]);
        }
        in.advance();
      }
      for (int jb = 0; jb < kBwdCols / 8; ++jb) {  // product stages: x^T at J's k8 block
        mbar_wait(&empty[in.slot], in.phase ^ 1u);
        float* st = ring + in.slot * kBwdSlotFloats;
        const long long o = plane_at(d0, c0 + 8 * jb, P.Dpp);
        mbar_expect_tx(&full[in.slot], 2 * 32 * DC);
        bulk_load(st, P.th + o, 32 * DC, &full[in.slot]);
        bulk_load(st + DC * 8, P.tl + o, 32 * DC, &full[in.slot]);
        in.advance();
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = warp >> 2, q = warp & 3, g = lane >> 2, t = lane & 3;
  const float rtemp = recip(temp);
  for (int i = tid; i < BM; i += kConsumerThreads) srow[i] = P.meta[r0 + i];
  // the upstream gradient and the loss's scalars folded into three weights
  const double on = stats[0], pd = stats[1], nn = stats[2];
  const double gd = static_cast<double>(gout[0]), td = static_cast<double>(temp);
  const float cP = static_cast<float>(on * gd * (-2.0 / pd) * (1.0 + 1.0 / td));
  const float cS = static_cast<float>(on * gd / (td * pd));
  const float cN = has_margin ? static_cast<float>(on * gd * 2.0 / (td * nn)) : 0.f;
  const float kink = margin * temp;  // the cosine at l = margin
  consumers_sync();  // srow

  // dx[4 n + 2 h + e]: row 16 q + g + 8 h, column d0 + NW wg + 8 n + 2 t + e;
  // acc likewise at tile column 64 wg + 8 n + 2 t + e
  float dx[NW / 2], acc[32], part[32];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) dx[i] = 0.f;
  bool fresh = true, first = true;  // dx holds nothing yet; dx_out holds nothing yet
  Pipe<kBwdSlots> in;
  for (int jt = 0; jt < nJ; ++jt) {
    const int c0 = jt * kBwdCols;
    cosine_tile<64, kBwdSlots, 2>(acc, part, ring, kBwdSlotFloats, in, full, empty, nK, lane, 0,
                                  2 * BM * 8, BM * 8, 4 * BM * 8 + wg * 64 * 8,
                                  2 * kBwdCols * 8, kBwdCols * 8);
    mbar_wait(&mfull[jt & 1], (jt >> 1) & 1);
    const Meta* scol = smeta + (jt & 1) * kBwdCols;
    if (jt > 0) consumers_sync();  // both warpgroups' products are done with W
    // bit 4 n + 2 h + e: a negative pair whose cosine lies within kKinkBand
    // of the margin's kink, its side left to the float64 check below
    uint32_t near = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int il = 16 * q + g + 8 * h;
      const Meta ri = srow[il];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        float hi[2], lo[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jl = 64 * wg + 8 * n + 2 * t + e;
          const Meta cj = scol[jl];
          const PairClass c = pair_class(r0 + il, ri, c0 + jl, cj);
          // every term computed, the pair's kept: no branch on the class
          const float l = quot(acc[4 * n + 2 * h + e], temp, rtemp);
          const float si = ex(static_cast<float>(static_cast<double>(l) - ri.lse));
          const float sj = ex(static_cast<float>(static_cast<double>(l) - cj.lse));
          float w = cS * (static_cast<float>(ri.p) * si + static_cast<float>(cj.p) * sj);
          w += c.pos ? cP : 0.f;
          const bool close =
              c.neg && has_margin && fabsf(acc[4 * n + 2 * h + e] - kink) <= kKinkBand;
          near |= static_cast<uint32_t>(close) << (4 * n + 2 * h + e);
          w += c.neg && has_margin && !close && l - margin >= 0.f ? cN : 0.f;
          w = c.pos | c.neg ? w : 0.f;
          const uint32_t wh = to_tf32(w);
          hi[e] = __uint_as_float(wh);
          lo[e] = __uint_as_float(to_tf32(w - hi[e]));
        }
        // plane order: block 8 wg + n, row group 2 q + h, core matrix t / 2
        const int o =
            (8 * wg + n) * BM * 8 + (2 * q + h) * 64 + (t >> 1) * 32 + g * 4 + 2 * (t & 1);
        *reinterpret_cast<float2*>(W + o) = make_float2(hi[0], hi[1]);
        *reinterpret_cast<float2*>(W + kWFloats + o) = make_float2(lo[0], lo[1]);
      }
    }
    // The margin's kink: (G + G^T) steps by cN where l = margin, so a pair
    // near it takes its side from its rows of x in float64, as the float64
    // twin decides it, the warp deciding each marked pair of each lane in
    // turn; a pair past the kink gets cN added to its weight in W.
    for (unsigned lanes = __ballot_sync(kFull, near != 0); lanes != 0; lanes &= lanes - 1) {
      const int src = __ffs(lanes) - 1;
      for (uint32_t rest = __shfl_sync(kFull, near, src); rest != 0; rest &= rest - 1) {
        const int b = __ffs(rest) - 1, n = b >> 2, h = (b >> 1) & 1, e = b & 1;
        const int i = r0 + 16 * q + (src >> 2) + 8 * h;
        const int j = c0 + 64 * wg + 8 * n + 2 * (src & 3) + e;
        const double cs = warp_cosine64(x, P.Dp, i, j, lane);
        if (lane == src && cs / temp64 - margin64 >= 0.0) {
          const int o = (8 * wg + n) * BM * 8 + (2 * q + h) * 64 + (t >> 1) * 32 + g * 4 +
                        2 * (t & 1) + e;
          const float w = W[o] + W[kWFloats + o] + cN;
          const float hi = __uint_as_float(to_tf32(w));
          W[o] = hi;
          W[kWFloats + o] = __uint_as_float(to_tf32(w - hi));
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&mempty[jt & 1]);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // W, for the tensor cores
    consumers_sync();

    int held = -1;  // the slot whose products may still be reading
    for (int jb = 0; jb < kBwdCols / 8; ++jb) {
      mbar_wait(&full[in.slot], in.phase);
      const float* st = ring + in.slot * kBwdSlotFloats;
      wgmma_fence();
      wgmma3<NW>(dx, W + jb * BM * 8, kWFloats, st + wg * NW * 8, DC * 8,
                 (fresh && jb == 0) ? 0 : 1);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
      held = in.slot;
      in.advance();
    }
    wgmma_wait<0>();
    fence_regs(dx);
    if (lane == 0) mbar_arrive(&empty[held]);
    fresh = false;

    if ((jt + 1) % kFlush == 0 || jt + 1 == nJ) {
      const int col0 = d0 + NW * wg + 2 * t;
#pragma unroll
      for (int n0 = 0; n0 < NW / 8; n0 += 8) {  // eight n8 blocks at a time: loads in flight
        float2 old[8][2];
        if (!first) {
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = r0 + 16 * q + g + 8 * h, col = col0 + 8 * (n0 + n);
              old[n][h] = row < M && col < P.Dp
                              ? *reinterpret_cast<const float2*>(
                                    dx_out + static_cast<long long>(row) * P.Dp + col)
                              : make_float2(0.f, 0.f);
            }
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r0 + 16 * q + g + 8 * h, col = col0 + 8 * (n0 + n);
            float2 v = make_float2(dx[4 * (n0 + n) + 2 * h], dx[4 * (n0 + n) + 2 * h + 1]);
            if (!first) {
              v.x = old[n][h].x + v.x;
              v.y = old[n][h].y + v.y;
            }
            if (row < M && col < P.Dp)
              *reinterpret_cast<float2*>(dx_out + static_cast<long long>(row) * P.Dp + col) = v;
          }
      }
      first = false;
      fresh = true;
    }
  }
}

// A kernel's shared memory, after checking its register count: setmaxnreg's
// sums hold only at kRegsAtEntry registers a thread, and with any other the
// consumers' request could wait forever
template <class Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  if (attr.numRegs != kRegsAtEntry) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

int forward(const float* x, int M, int Dp, const void* lab, const void* grp, const void* flags,
            double temperature, double margin, int has_margin, void* lse, void* pcount,
            void* part_f, void* part_i, void* loss, void* stats, void* scratch,
            cudaStream_t stream) {
  if (Dp % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nblk = (M + BM - 1) / BM;
  if (nblk > 0) {
    const Planes P = carve(scratch, M, Dp, false);
    pack_meta_kernel<<<(P.Mp + 255) / 256, 256, 0, stream>>>(
        M, P, static_cast<const long long*>(lab), static_cast<const long long*>(grp),
        static_cast<const int*>(flags), nullptr, nullptr);
    pack_planes_kernel<<<dim3(P.Mp / 32, Dp / 32), 256, 0, stream>>>(x, M, P);
    cudaError_t e = prepare(contrastive_fwd_wgmma_kernel, kFwdSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    contrastive_fwd_wgmma_kernel<<<nblk, kThreads, kFwdSmem, stream>>>(
        P, M, static_cast<float>(temperature), static_cast<float>(margin), has_margin,
        static_cast<double*>(lse), static_cast<int*>(pcount), static_cast<double*>(part_f),
        static_cast<long long*>(part_i));
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  contrastive_finalize_kernel<float><<<1, 32, 0, stream>>>(
      static_cast<const double*>(part_f), static_cast<const long long*>(part_i), nblk,
      has_margin, static_cast<float*>(loss), static_cast<double*>(stats));
  return static_cast<int>(cudaGetLastError());
}

int backward(const float* x, int M, int Dp, const void* lab, const void* grp, const void* flags,
             double temperature, double margin, int has_margin, const void* lse,
             const void* pcount, const void* stats, const void* gout, void* dx, void* scratch,
             cudaStream_t stream) {
  if (Dp % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  const Planes P = carve(scratch, M, Dp, true);
  pack_meta_kernel<<<(P.Mp + 255) / 256, 256, 0, stream>>>(
      M, P, static_cast<const long long*>(lab), static_cast<const long long*>(grp),
      static_cast<const int*>(flags), static_cast<const double*>(lse),
      static_cast<const int*>(pcount));
  pack_planes_kernel<<<dim3(P.Mp / 32, P.Dpp / 32), 256, 0, stream>>>(x, M, P);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = prepare(contrastive_bwd_wgmma_kernel, kBwdSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((M + BM - 1) / BM, P.Dpp / DC);
  contrastive_bwd_wgmma_kernel<<<grid, kThreads, kBwdSmem, stream>>>(
      P, x, M, static_cast<float>(temperature), static_cast<float>(margin), temperature, margin,
      has_margin, static_cast<const double*>(stats), static_cast<const float*>(gout),
      static_cast<float*>(dx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tf32

}  // namespace

extern "C" {

// Bytes of scratch a call takes: for float32 every row's metadata and the
// hi and lo planes of x, and for the backward (backward != 0) of x^T; none
// for float64.
size_t contrastive_loss_scratch_bytes(int is_double, int M, int Dp, int backward) {
  return is_double || M <= 0 ? 0 : tf32::scratch_bytes(M, Dp, backward != 0);
}

// The loss of the normalised rows x [M, Dp] (float32, or float64 when
// is_double) into loss (0-d, x's type), with per row lse (float64) and p
// (int32), the CTAs' records part_f (float64 [nblk, 4]) and part_i (int64
// [nblk, 2]), nblk = ceil(M / 64), stats (float64 [3]) for the backward,
// and contrastive_loss_scratch_bytes(is_double, M, Dp, 0) bytes of scratch.
// Returns a cudaError_t (0 on success).
int contrastive_loss_forward(int is_double, const void* x, int M, int Dp, const void* lab,
                             const void* grp, const void* flags, double temperature,
                             double margin, int has_margin, void* lse, void* pcount,
                             void* part_f, void* part_i, void* loss, void* stats,
                             void* scratch, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return is_double ? run_forward<double>(x, M, Dp, lab, grp, flags, temperature, margin,
                                         has_margin, lse, pcount, part_f, part_i, loss, stats, s)
                   : tf32::forward(static_cast<const float*>(x), M, Dp, lab, grp, flags,
                                   temperature, margin, has_margin, lse, pcount, part_f, part_i,
                                   loss, stats, scratch, s);
}

// dx [M, Dp] = d loss / d x times the upstream gradient gout (0-d, x's type),
// from the forward's lse, p and stats, with
// contrastive_loss_scratch_bytes(is_double, M, Dp, 1) bytes of scratch.
int contrastive_loss_backward(int is_double, const void* x, int M, int Dp, const void* lab,
                              const void* grp, const void* flags, double temperature,
                              double margin, int has_margin, const void* lse,
                              const void* pcount, const void* stats, const void* gout,
                              void* dx, void* scratch, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  return is_double ? run_backward<double>(x, M, Dp, lab, grp, flags, temperature, margin,
                                          has_margin, lse, pcount, stats, gout, dx, s)
                   : tf32::backward(static_cast<const float*>(x), M, Dp, lab, grp, flags,
                                    temperature, margin, has_margin, lse, pcount, stats, gout,
                                    dx, scratch, s);
}

}  // extern "C"

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
// What bounds it on this card: the two dense products of every layer, about
// 95% of its floating-point work.  The TPU kernel takes a precision, and so
// does this one, as two routes of one template (kBf16):
//  * Precision.HIGHEST, several bf16 passes that emulate float32 on the TPU,
//    runs on the tensor cores as 3xTF32, Hopper's counterpart of that
//    emulation: hi = tf32(a), lo = tf32(a - hi) for both operands and
//    acc += lo*hi' + hi*lo' + hi*hi' in float32 (495 / 3 TFLOP/s at most).
//  * Precision.DEFAULT, one bf16 pass with float32 sums on the TPU, runs as
//    one bf16 wgmma (m64n128k16, 989 TFLOP/s at most): the activations are
//    rounded to bf16 (cvt.rn, to nearest even, as the TPU and torch round)
//    as the A fragments are built, the weights were rounded once when
//    packed.  The TPU kernel's other products follow it on this route: the
//    in-window partner rows x[j_local], which it gathers as a product with
//    a one-hot matrix, are read as bf16(x[j]), and the fc head's operands
//    are rounded to bf16.  Every other step stays float32.
// Its bytes are small beside that: the encoder input is read once and one
// row per window is written.
//
// What the design does about it:
//  * One CTA per window: three warpgroups, each on its own 64-row tile (a
//    flagship window has up to 162 active rows).  Only active rows are
//    computed, in a compact order: the L window rows, then the
//    pulled-partner slots that hold a node.  Empty slots are masked out of
//    every sum in the TPU kernel, so skipping them changes no result.
//  * The window's state stays on chip: at width 128 the X plane (layer
//    input, which every message reads) of every window lives in shared
//    memory across all layers, as the TPU kernel kept it in VMEM, and so
//    does the H plane (messages, hidden layer and MLP output in turn) of
//    every window whose two planes fit (up to 163 active rows at L = 120:
//    every window of the flagship's seeded corpus, whose largest has 162).
//    The H plane of a larger window, and every plane of a model wider than
//    128, point at the window's slice of a global workspace, chosen per
//    window inside the kernel from its row count: the same code, generic
//    loads and stores.
//  * Products: wgmma m64n128k8 tf32, A from registers, B (the weights) from
//    shared memory; each warpgroup owns a 64-row tile of the window.  The
//    messages (1 + eps) x + agg of a tile's rows are built once per layer,
//    four columns a lane, into its rows of the H plane, which the first
//    product then overwrites with its output.  Built inside the product's
//    k loop instead, they put five gathers per element on every k8 step's
//    path to the tensor cores, and the kernel ran slower on the card.
//  * Weights arrive asynchronously: pack_params stores each W transposed
//    ([dout, din], K-major, as tf32 wgmma takes it), split into hi and lo and
//    cut into 128 x 16 stage images in the tensor cores' core-matrix order
//    (the bf16 route: rounded to bf16, one part, 128 x 64 stage images of
//    the same 16 KB), so one thread moves one stage with one bulk copy
//    (TMA) into a 3-stage ring: the last warp done with a slot refills it with the stage three
//    further on, and an mbarrier says when its bytes have landed, so the
//    next stages load while the current one is multiplied (and the next
//    layer's first stages during GraphNorm).
//  * Column sums (GraphNorm, pooling) are split over three row groups and
//    combined in a fixed order, with no atomics: every run gives the same
//    bits.  __fmul_rn and a correctly rounded division (div_rn) stand where
//    the plain version rounds separately.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kGroups = 3;                   // warpgroups
constexpr int kThreads = 128 * kGroups;
constexpr int kWarps = kThreads / 32;
constexpr int BM = 64;                       // rows of a wgmma tile
constexpr int BN = 128;                      // columns of a wgmma tile
constexpr int BK = 16;                       // depth of one weight stage (3xTF32)
constexpr int BK_BF16 = 64;                  // depth of one weight stage (bf16)
constexpr int kStages = 3;
constexpr int kPartFloats = BN * BK;         // one of hi / lo: 8 KB
constexpr int kStageFloats = 2 * kPartFloats;
constexpr uint32_t kStageBytes = 4u * kStageFloats;
static_assert(2 * BN * BK_BF16 == 4 * kStageFloats, "a bf16 stage fills one ring slot");
constexpr int kPad = 4;                      // floats of padding per plane row
constexpr int kLayerMeta = 8;  // w0, w1, b0, b1, eb, gn offsets; din; dout
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float relu(float v) { return fmaxf(v, 0.f); }

// a / b rounded to nearest, given rb = __frcp_rn(b).  By Markstein's theorem
// (rb the correctly rounded reciprocal, q within an ulp of a / b, the
// remainder exact in an fma) this is the correctly rounded quotient, the
// bits of __fdiv_rn(a, b), for normal operands; with rb computed once per
// column or row it costs a multiply and two fmas where __fdiv_rn costs a
// subroutine.
__device__ __forceinline__ float div_rn(float a, float b, float rb) {
  const float q = __fmul_rn(a, rb);
  return __fmaf_rn(__fmaf_rn(-b, q, a), rb, q);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and the bulk copy ----------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the phase of the given parity completes; a phase that never
// completes (a lost arrival) traps after about a second instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// named barrier 2 + g: the 128 threads of warpgroup g
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, 128;" ::"r"(2 + g) : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Shared-memory matrix descriptor, no swizzle: 8 x 16-byte core matrices;
// lbo = bytes between core matrices along K, sbo = along M/N.
__device__ __forceinline__ uint64_t make_desc(const float* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// {lo, hi} rounded to bf16 (to nearest, ties to even) and packed into one
// register, lo in the low half: the element of the lower column, as a bf16
// wgmma A fragment holds two neighbouring columns.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// v rounded to bf16 (to nearest, ties to even), as a float
__device__ __forceinline__ float round_bf16(float v) {
  return __uint_as_float(pack_bf16(v, 0.f) << 16);
}

// v rounded to tf32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), in two integer operations on the integer pipe (256 roundings
// per thread a layer at width 128).
__device__ __forceinline__ uint32_t to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += a[64 x 8] (registers, tf32) * b[8 x 128] (shared, K-major)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
      : "memory");
}

// d[64 x 128] += a[64 x 16] (registers, bf16) * b[16 x 128] (shared, bf16,
// K-major: imm-trans-b 0), float32 sums
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)
      : "memory");
}

// ---- the weight ring --------------------------------------------------------

// The weight stages in the order the products take them: per layer, per
// round of tiles, W0 then W1, each by 128-column tile, then by stage of
// `depth` inputs (BK, or BK_BF16 on the bf16 route).
struct Feed {
  const float* params;
  const long long* meta;   // kLayerMeta per layer
  const long long* tmeta;  // w0t, w1t offsets per layer
  int n_layers, rounds, depth;
  int li, rd, mat, u, units;
  __device__ __forceinline__ void set_units() {
    const int din = (int)meta[kLayerMeta * li + 6], dout = (int)meta[kLayerMeta * li + 7];
    units = (dout / BN) * ((mat ? dout : din) / depth);
  }
  __device__ __forceinline__ bool done() const { return li >= n_layers; }
  __device__ __forceinline__ const float* src() const {
    return params + tmeta[2 * li + mat] + (size_t)u * kStageFloats;
  }
  __device__ __forceinline__ void next() {
    if (++u < units) return;
    u = 0;
    if (++mat == 2) {
      mat = 0;
      if (++rd == rounds) {
        rd = 0;
        ++li;
      }
    }
    if (li < n_layers) set_units();
  }
};

// kStages slots of [hi, lo] x [BN x BK] core-matrix images (bf16 route:
// one [BN x BK_BF16] image of the same bytes).  A slot's full
// barrier completes when its bytes land; each warp adds one to the slot's
// release count when its wgmmas are done with it, and the warp that makes
// the count kWarps refills the slot with the stage kStages further on
// (every warp walks its own copy of the feed, kStages ahead of what it
// computes).
struct Ring {
  float* buf;
  uint64_t* full;
  int* released;
  int stage;
  uint32_t phase;
  Feed feed;
  __device__ __forceinline__ void load(int slot) {
    mbar_expect_tx(&full[slot], kStageBytes);
    bulk_load(buf + slot * kStageFloats, feed.src(), kStageBytes, &full[slot]);
  }
  __device__ __forceinline__ void release(int slot, int lane) {
    if (lane == 0 && atomicAdd(&released[slot], 1) == kWarps - 1) {
      released[slot] = 0;
      if (!feed.done()) load(slot);
    }
    if (!feed.done()) feed.next();
  }
  __device__ __forceinline__ void advance() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// Timing hook, compiled in only with -DK1_PROFILE: thread 0 of each CTA
// writes the global nanosecond clock at a few points of the kernel.
#ifdef K1_PROFILE
constexpr int kStamps = 16;
__device__ unsigned long long k1_stamps[4096 * kStamps];
#define K1_STAMP(i)                                                         \
  do {                                                                      \
    if (threadIdx.x == 0) {                                                 \
      unsigned long long t_;                                                \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));               \
      k1_stamps[blockIdx.x * kStamps + (i)] = t_;                           \
    }                                                                       \
  } while (0)
#else
#define K1_STAMP(i) \
  do {              \
  } while (0)
#endif

struct Tile {
  int base;   // first compact row of this warpgroup's 64-row tile
  int r[2];   // this thread's two rows in it (groupID, groupID + 8)
};

// One product of a warpgroup's 64-row tile with one 128-column tile of a
// weight matrix: acc = A[tile, :kdim] * W[:kdim, n-tile], the weights taken
// stage by stage from the ring.  load(q, c) gives A at this thread's row q
// (0 or 1) and column c, 0 past the window's rows.  Each stage's A is built
// (and split into hi and lo, or rounded to bf16) while the previous stage's
// wgmmas run.  Every warpgroup runs every product, one past the window's
// rows on zeros: a wgmma under a branch on the row count would be
// serialised, and a chunk takes as long as its largest window anyway.
template <bool kBf16, class LoadA>
__device__ __forceinline__ void tile_product(float (&acc)[64], int kdim, const LoadA& load,
                                             Ring& ring, int lane) {
  static_assert(BK == 16, "two k8 steps per stage");
  static_assert(BK_BF16 == 64, "four k16 steps per stage");
  constexpr int kDepth = kBf16 ? BK_BF16 : BK;
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_acc(acc);  // the accumulators are touched only here and after the
                   // last wait: a use while a wgmma is in flight would wait
  const int t = lane & 3;
  // [buffer] then 3xTF32: [k8 step][hi, lo][fragment]; bf16: [k16 step][fragment]
  using Frags = typename std::conditional<kBf16, uint32_t[4][4], uint32_t[2][2][4]>::type;
  Frags a[2];
  int held = -1;           // stage whose wgmmas may still be reading
  auto stage_step = [&](int k0, Frags& ab) {
    if constexpr (kBf16) {
      // A of the stage's four k16 steps; fragment f: row q = f & 1
      // (groupID, + 8), columns 2t + 8 (f >> 1) and the next, lower in the
      // low half
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int c = k0 + 16 * kk + 2 * t + 8 * (f >> 1);
          ab[kk][f] = pack_bf16(load(f & 1, c), load(f & 1, c + 1));
        }
      }
    } else {
    // A of the stage's two k8 steps; fragment f: row q = f & 1 (groupID,
    // + 8), column t + 4 (f >> 1)
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float v = load(f & 1, k0 + 8 * kk + t + 4 * (f >> 1));
        const uint32_t hi = to_tf32(v);
        ab[kk][0][f] = hi;
        ab[kk][1][f] = to_tf32(v - __uint_as_float(hi));
      }
    }
    }
    mbar_wait(&ring.full[ring.stage], ring.phase);
    const float* hi_b = ring.buf + ring.stage * kStageFloats;
    wgmma_fence();
    if constexpr (kBf16) {
      // the stage: 16 groups of 8 columns, each 8 chunks of 8 inputs
      // (128 B core matrices: lbo 128 B along K, sbo 1024 B along N); a
      // k16 step reads two chunks, 256 B on
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_bf16(acc, ab[kk], make_desc(hi_b + 64 * kk, 128, 128 * (BK_BF16 / 8)));
    } else {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t dh = make_desc(hi_b + 64 * kk, 128, 128 * (BK / 4));
      const uint64_t dl = make_desc(hi_b + kPartFloats + 64 * kk, 128, 128 * (BK / 4));
      wgmma_tf32(acc, ab[kk][1], dh);  // lo * hi'
      wgmma_tf32(acc, ab[kk][0], dl);  // hi * lo'
      wgmma_tf32(acc, ab[kk][0], dh);  // hi * hi'
    }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage is done: its A buffer and slot are free
    if (held >= 0) ring.release(held, lane);
    held = ring.stage;
    ring.advance();
  };
  for (int k0 = 0; k0 < kdim; k0 += 2 * kDepth) {  // kdim is a multiple of 128
    stage_step(k0, a[0]);
    stage_step(k0 + kDepth, a[1]);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  ring.release(held, lane);
}

// out[r, n0 + n] = relu(acc + b[n0 + n]) for this thread's rows < n_rows.
__device__ __forceinline__ void store_relu(const float (&acc)[64], float* out, int ld,
                                           const Tile& tile, int n_rows,
                                           const float* __restrict__ b, int n0, int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int r = tile.r[q];
    if (r >= n_rows) continue;
    float* o = out + (size_t)r * ld + n0;
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int n = 8 * i + 2 * t;
      const float2 bb = *reinterpret_cast<const float2*>(b + n0 + n);
      *reinterpret_cast<float2*>(o + n) =
          make_float2(relu(acc[4 * i + 2 * q] + bb.x), relu(acc[4 * i + 2 * q + 1] + bb.y));
    }
  }
}

// dst[c] = sum over r < n_rows of value(r, c), for c < width.  Thread
// (row group rg, column c) sums the rows r = rg mod kGroups; the kGroups
// partial sums are then added in order.  Ends synchronised.
template <typename F>
__device__ __forceinline__ void column_sums(F value, int n_rows, int width, float* red,
                                            float* dst) {
  const int cq = threadIdx.x & 127, rg = threadIdx.x >> 7;
  for (int c = cq; c < width; c += 128) {
    float sum = 0.f;
#pragma unroll 4
    for (int r = rg; r < n_rows; r += kGroups) sum += value(r, c);
    red[rg * width + c] = sum;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < width; c += kThreads) {
    float sum = red[c];
#pragma unroll
    for (int q = 1; q < kGroups; ++q) sum += red[q * width + c];
    dst[c] = sum;
  }
  __syncthreads();
}

struct Smem {
  float* ring;
  uint64_t* full;
  int* released;
  float* eb;     // [5, mw]: the layer's edge rows and 1 + eps
  float* red;    // [kGroups, mw]
  float* s_a;    // [mw]
  float* s_b;    // [mw]
  float* nrm;    // [2, 2L]: row norms, then their reciprocals
  int4* src;     // [2L]: rows the messages come from (-1: none): next,
                 // prev, in-window / puller partner, pulled partner
  unsigned char* fwd;  // [2L]: the bp edge they carry is the forward one
  int* slot;     // [2L]: the aligned-layout slot of each compact row
  int* pidx;     // [L]: compact row of position i's pulled partner, or -1
  int* f_jl;     // [L] window inputs: in-window partner, then 0/1 flags
  unsigned char* f_bp;
  unsigned char* f_pl;
  unsigned char* f_fw;
  unsigned char* f_fp;
  float* planes; // [pool]: X (rows of mw), then H (rows of mw + kPad) if it fits
  int* n_rows;
};

__host__ __device__ inline size_t align_up(size_t v, size_t a) { return (v + a - 1) / a * a; }

// The shared-memory carve-up; with base == nullptr it only sizes it.
__host__ __device__ inline size_t carve(char* base, int L, int mw, size_t pool, Smem* s) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off = align_up(off + bytes, 16);
    return p;
  };
  char* ring = take(sizeof(float) * kStages * kStageFloats);
  char* full = take(sizeof(uint64_t) * kStages);
  char* released = take(sizeof(int) * kStages);
  char* eb = take(sizeof(float) * 5 * mw);
  char* red = take(sizeof(float) * kGroups * mw);
  char* s_a = take(sizeof(float) * mw);
  char* s_b = take(sizeof(float) * mw);
  char* nrm = take(sizeof(float) * 4 * L);
  char* src = take(sizeof(int4) * 2 * L);
  char* fwd = take(2 * L);
  char* slot = take(sizeof(int) * 2 * L);
  char* pidx = take(sizeof(int) * L);
  char* fl = take((sizeof(int) + 4) * L);
  char* nr = take(sizeof(int));
  char* planes = take(sizeof(float) * pool);
  if (s) {
    s->ring = reinterpret_cast<float*>(ring);
    s->full = reinterpret_cast<uint64_t*>(full);
    s->released = reinterpret_cast<int*>(released);
    s->eb = reinterpret_cast<float*>(eb);
    s->red = reinterpret_cast<float*>(red);
    s->s_a = reinterpret_cast<float*>(s_a);
    s->s_b = reinterpret_cast<float*>(s_b);
    s->nrm = reinterpret_cast<float*>(nrm);
    s->src = reinterpret_cast<int4*>(src);
    s->fwd = reinterpret_cast<unsigned char*>(fwd);
    s->slot = reinterpret_cast<int*>(slot);
    s->pidx = reinterpret_cast<int*>(pidx);
    s->f_jl = reinterpret_cast<int*>(fl);
    s->f_bp = reinterpret_cast<unsigned char*>(s->f_jl + L);
    s->f_pl = s->f_bp + L;
    s->f_fw = s->f_pl + L;
    s->f_fp = s->f_fw + L;
    s->n_rows = reinterpret_cast<int*>(nr);
    s->planes = reinterpret_cast<float*>(planes);
  }
  return off;
}

// Floats of shared memory for the planes beside the rest: room for the X
// plane of any window (2L rows) and for as many rows of the H plane as fit
// (up to 2L).  0 for models wider than 128, or when not even X fits: those
// use the workspace.
inline size_t pool_for(int L, int mw) {
  if (mw != BN) return 0;
  const size_t fixed = carve(nullptr, L, mw, 0, nullptr);
  const size_t x_plane = (size_t)2 * L * mw;
  if (fixed + sizeof(float) * x_plane > (size_t)kMaxSmem) return 0;
  const size_t room = ((size_t)kMaxSmem - fixed) / sizeof(float);
  const size_t most = x_plane + (size_t)2 * L * (mw + kPad);
  return (room < most ? room : most) / 4 * 4;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
windows_encoder_kernel(const float* __restrict__ x0, const int* __restrict__ j_local,
                       const float* __restrict__ bp_in, const float* __restrict__ pulled,
                       const float* __restrict__ fwd_w, const float* __restrict__ fwd_p,
                       const float* __restrict__ params, const long long* __restrict__ meta,
                       float* __restrict__ workspace, float* __restrict__ out, int L,
                       int n_layers, int mw, int out_dim, int mean_pool, int norm_mode,
                       int use_res, float eps, long long pool) {
  extern __shared__ __align__(1024) char smem_raw[];
  Smem s;
  carve(smem_raw, L, mw, (size_t)pool, &s);
  K1_STAMP(0);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t win = blockIdx.x;
  const long long* tmeta = meta + kLayerMeta * n_layers + 3;  // w0t, w1t per layer

  for (int i = tid; i < L; i += kThreads) {
    const size_t k = win * L + i;
    s.f_jl[i] = j_local[k];
    s.f_bp[i] = bp_in[k] != 0.f;
    s.f_pl[i] = pulled[k] != 0.f;
    s.f_fw[i] = fwd_w[k] != 0.f;
    s.f_fp[i] = fwd_p[k] != 0.f;
    s.slot[i] = i;
  }
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&s.full[st], 1);
      s.released[st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {  // active pulled slots, in position order
    int n = L;
    for (int i0 = 0; i0 < L; i0 += 32) {
      const int i = i0 + lane;
      const bool pl = i < L && s.f_pl[i];
      const unsigned m = __ballot_sync(0xffffffffu, pl);
      const int at = n + __popc(m & ((1u << lane) - 1u));
      if (i < L) s.pidx[i] = pl ? at : -1;
      if (pl) s.slot[at] = L + i;
      n += __popc(m);
    }
    if (lane == 0) *s.n_rows = n;
  }
  __syncthreads();
  const int n_rows = *s.n_rows;
  const int n_tiles = (n_rows + BM - 1) / BM;
  const int rounds = (n_tiles + kGroups - 1) / kGroups;

  Ring ring{s.ring, s.full, s.released, 0, 0u,
            Feed{params, meta, tmeta, n_layers, rounds, kBf16 ? BK_BF16 : BK, 0, 0, 0, 0, 0}};
  ring.feed.set_units();
  for (int st = 0; st < kStages; ++st) {  // the first stages, then kStages ahead
    if (tid == 0 && !ring.feed.done()) ring.load(st);
    if (!ring.feed.done()) ring.feed.next();
  }

  for (int r = tid; r < n_rows; r += kThreads) {
    if (r < L) {
      s.src[r] = make_int4(r <= L - 2 ? r + 1 : -1, r >= 1 ? r - 1 : -1,
                           s.f_bp[r] ? s.f_jl[r] : -1, s.pidx[r]);
      s.fwd[r] = s.f_fw[r];
    } else {
      const int i = s.slot[r] - L;
      s.src[r] = make_int4(-1, -1, i, -1);
      s.fwd[r] = s.f_fp[i];
    }
  }

  // Planes, by compact row: X [n_rows, mw] the layer input; M the messages,
  // T the hidden layer and H the MLP output, each [n_rows, ld] (padded rows:
  // the wgmma A fragments read them column-wise).  With one 128-column tile
  // (every width 128) a warpgroup's product only reads its own tile's rows,
  // so M, T and H share one plane, each overwritten in place.
  const int ld = mw + kPad;
  const size_t plane = (size_t)2 * L * ld;
  float* ws = workspace + win * 4 * plane;
  float* X = pool ? s.planes : ws;
  const bool h_on_chip = (size_t)n_rows * (mw + ld) <= (size_t)pool;
  float* H = h_on_chip ? s.planes + (size_t)n_rows * mw : ws + plane;
  float* T = mw == BN ? H : ws + 2 * plane;
  float* M = mw == BN ? H : ws + 3 * plane;

  const int cq = tid & 127, rg = tid >> 7;  // column in a 128 block, row group
  const int h0 = (int)meta[6];
  for (int r = warp; r < n_rows; r += kWarps) {  // x0 rows, 16 bytes a lane
    const float4* src = reinterpret_cast<const float4*>(x0 + (win * 2 * L + s.slot[r]) * h0);
    float4* dst = reinterpret_cast<float4*>(X + (size_t)r * mw);
    for (int c = lane; c < h0 / 4; c += 32) dst[c] = src[c];
  }

  K1_STAMP(1);
  const int g = warp >> 2;  // warpgroup
  const int gt = tid & 127;  // thread in it
  const int row_in = 16 * (warp & 3) + (lane >> 2);
  const float cnt = (float)n_rows;  // L + sum(pulled)
  float acc[64];

  for (int li = 0; li < n_layers; ++li) {
    const long long* m = meta + kLayerMeta * li;
    const float* b0 = params + m[2];
    const float* b1 = params + m[3];
    const float* ebg = params + m[4];  // [5, din]: next, prev, bp_f, bp_b, 1+eps
    const float* gn = params + m[5];   // [3, dout]: weight, bias, mean_scale
    const int din = (int)m[6], dout = (int)m[7];
    for (int e = tid; e < 5 * din; e += kThreads) s.eb[(e / din) * mw + e % din] = ebg[e];
    __syncthreads();  // eb, X and the row sources are in place

    for (int rd = 0; rd < rounds; ++rd) {
      Tile tile;
      tile.base = (kGroups * rd + g) * BM;
      tile.r[0] = tile.base + row_in;
      tile.r[1] = tile.r[0] + 8;
      const bool live0 = tile.r[0] < n_rows, live1 = tile.r[1] < n_rows;

      // messages (1 + eps) x + agg of the tile's rows, summed in the TPU
      // kernel's order, four columns a lane
      const int r_end = min(tile.base + BM, n_rows);
      for (int r = tile.base + (gt >> 5); r < r_end; r += 4) {
        const int4 nb = s.src[r];
        const bool fw = s.fwd[r];
        for (int c = 4 * lane; c < din; c += 128) {
          const float4 e_n = *reinterpret_cast<const float4*>(s.eb + c);
          const float4 e_p = *reinterpret_cast<const float4*>(s.eb + mw + c);
          const float4 e_b = *reinterpret_cast<const float4*>(s.eb + (fw ? 2 : 3) * mw + c);
          const float4 one = *reinterpret_cast<const float4*>(s.eb + 4 * mw + c);
          const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
          auto row = [&](int i) {
            return i >= 0 ? *reinterpret_cast<const float4*>(X + (size_t)i * mw + c) : zero;
          };
          const float4 xs = row(r), xn = row(nb.x), xp = row(nb.y), xq = row(nb.w);
          float4 xj = row(nb.z);
          if (kBf16 && r < L) {  // the in-window partner, bf16 as the TPU's G @ x
            xj = make_float4(round_bf16(xj.x), round_bf16(xj.y), round_bf16(xj.z),
                             round_bf16(xj.w));
          }
          auto msg = [&](float x, float n, float p, float j, float q, float en, float ep,
                         float eb, float o) {
            float agg = (nb.x >= 0 ? relu(n + en) : 0.f) + (nb.y >= 0 ? relu(p + ep) : 0.f);
            if (nb.z >= 0) agg = agg + relu(j + eb);
            if (nb.w >= 0) agg = agg + relu(q + eb);
            return __fmul_rn(o, x) + agg;
          };
          *reinterpret_cast<float4*>(M + (size_t)r * ld + c) = make_float4(
              msg(xs.x, xn.x, xp.x, xj.x, xq.x, e_n.x, e_p.x, e_b.x, one.x),
              msg(xs.y, xn.y, xp.y, xj.y, xq.y, e_n.y, e_p.y, e_b.y, one.y),
              msg(xs.z, xn.z, xp.z, xj.z, xq.z, e_n.z, e_p.z, e_b.z, one.z),
              msg(xs.w, xn.w, xp.w, xj.w, xq.w, e_n.w, e_p.w, e_b.w, one.w));
        }
      }
      group_sync(g);  // M of the tile is whole
      auto plane = [&](const float* P) {
        return [=](int q, int c) -> float {
          return (q ? live1 : live0) ? P[(size_t)tile.r[q] * ld + c] : 0.f;
        };
      };
      for (int n0 = 0; n0 < dout; n0 += BN) {
        tile_product<kBf16>(acc, din, plane(M), ring, lane);
        group_sync(g);  // every warp has read M before T (maybe M) is written
        store_relu(acc, T, ld, tile, n_rows, b0, n0, lane);
      }
      group_sync(g);  // T of the tile is whole
      for (int n0 = 0; n0 < dout; n0 += BN) {
        tile_product<kBf16>(acc, dout, plane(T), ring, lane);
        group_sync(g);  // every warp has read T before H (maybe T) is written
        store_relu(acc, H, ld, tile, n_rows, b1, n0, lane);
      }
    }
    __syncthreads();
    K1_STAMP(2 + 2 * li);

    // GraphNorm over the window's active rows (variance eps 1e-5)
    column_sums([&](int r, int c) { return H[(size_t)r * ld + c]; }, n_rows, dout, s.red,
                s.s_a);
    for (int c = tid; c < dout; c += kThreads) s.s_a[c] = (s.s_a[c] / cnt) * gn[2 * dout + c];
    __syncthreads();
    column_sums(
        [&](int r, int c) {
          const float o = H[(size_t)r * ld + c] - s.s_a[c];
          return o * o;
        },
        n_rows, dout, s.red, s.s_b);
    for (int c = tid; c < dout; c += kThreads) s.s_b[c] = sqrtf(s.s_b[c] / cnt + 1e-5f);
    __syncthreads();
    const bool res = use_res && din == dout;
    for (int c = cq; c < dout; c += 128) {
      const float mean = s.s_a[c], sd = s.s_b[c], rsd = __frcp_rn(sd), w = gn[c],
                  b = gn[dout + c];
#pragma unroll 4
      for (int r = rg; r < n_rows; r += kGroups) {
        const float y = div_rn(__fmul_rn(w, H[(size_t)r * ld + c] - mean), sd, rsd) + b;
        float* x = X + (size_t)r * mw + c;
        *x = res ? y + *x : y;
      }
    }
    __syncthreads();
    K1_STAMP(3 + 2 * li);
  }

  const int h_last = (int)meta[kLayerMeta * (n_layers - 1) + 7];
  const float* mu = params + meta[kLayerMeta * n_layers];
  const float* sigma = mu + h_last;
  const float* fcw = params + meta[kLayerMeta * n_layers + 1];
  const float* fcb = params + meta[kLayerMeta * n_layers + 2];

  if (norm_mode & 2) {  // zscore with the model's buffers
    for (int c = cq; c < h_last; c += 128) {
      const float mc = mu[c], sd = sigma[c] + eps, rsd = __frcp_rn(sd);
#pragma unroll 4
      for (int r = rg; r < n_rows; r += kGroups) {
        float* x = X + (size_t)r * mw + c;
        *x = div_rn(*x - mc, sd, rsd);
      }
    }
    __syncthreads();
  }
  for (int r = warp; r < n_rows; r += kWarps) {  // row L2 norms (1 without l2)
    float sq = 0.f;
    if (norm_mode & 1) {
      const float* xr = X + (size_t)r * mw;
      for (int c = lane; c < h_last; c += 32) sq += xr[c] * xr[c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    }
    if (lane == 0) {
      const float nr = (norm_mode & 1) ? fmaxf(sqrtf(sq), eps) : 1.f;
      s.nrm[r] = nr;
      s.nrm[2 * L + r] = __frcp_rn(nr);
    }
  }
  __syncthreads();
  column_sums(
      [&](int r, int c) { return div_rn(X[(size_t)r * mw + c], s.nrm[r], s.nrm[2 * L + r]); },
      n_rows, h_last, s.red, s.s_a);
  if (mean_pool || kBf16) {  // the bf16 route's fc head reads bf16(pooled)
    for (int c = tid; c < h_last; c += kThreads) {
      const float v = mean_pool ? s.s_a[c] / cnt : s.s_a[c];
      s.s_a[c] = kBf16 ? round_bf16(v) : v;
    }
    __syncthreads();
  }
  for (int o = tid; o < out_dim; o += kThreads) {
    float a = 0.f;
#pragma unroll 8
    for (int f = 0; f < h_last; ++f) {
      const float w = fcw[(size_t)f * out_dim + o];
      a = fmaf(s.s_a[f], kBf16 ? round_bf16(w) : w, a);  // bf16 products are exact
    }
    out[win * out_dim + o] = a + fcb[o];
  }
  K1_STAMP(15);
}

}  // namespace

extern "C" {

// Dynamic shared memory one window's CTA takes at window length L and
// widest layer mw.
size_t windows_encoder_smem_bytes(int L, int mw) {
  return carve(nullptr, L, mw, pool_for(L, mw), nullptr);
}

// Active rows up to which a window keeps both its X and H planes in shared
// memory (X alone stays there for any window when this is not 0).
int windows_encoder_smem_rows(int L, int mw) {
  return (int)(pool_for(L, mw) / (2 * (size_t)mw + kPad));
}

#ifdef K1_PROFILE
// The timing hook's stamps of the last launch: n values, 16 per window.
int windows_encoder_stamps(unsigned long long* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, k1_stamps, sizeof(unsigned long long) * n);
}
#endif

// Launches the encoder over C windows on `stream`; allocates nothing.
// params/meta: the flat parameter buffer and its int64 offset table
// (ops/windows_encoder.py::pack_params).  workspace: [C, 4, 2L, mw + 4] f32,
// used by the windows whose planes do not fit in shared memory.
// norm_mode: bit 0 = l2, bit 1 = zscore.  route: 0 = 3xTF32 (the TPU
// kernel's Precision.HIGHEST), 1 = bf16 (Precision.DEFAULT), with params
// packed for that route.  Returns a cudaError_t.
int windows_encoder_launch(const float* x0, const int* j_local, const float* bp_in,
                           const float* pulled, const float* fwd_w, const float* fwd_p,
                           const float* params, const long long* meta, float* workspace,
                           float* out, int C, int L, int n_layers, int mw, int out_dim,
                           int mean_pool, int norm_mode, int use_res, int route, float eps,
                           void* stream) {
  if (C == 0) return 0;
  if (route != 0 && route != 1) return (int)cudaErrorInvalidValue;
  const size_t pool = pool_for(L, mw);
  const size_t smem = carve(nullptr, L, mw, pool, nullptr);
  const auto kernel = route ? windows_encoder_kernel<true> : windows_encoder_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<C, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x0, j_local, bp_in, pulled, fwd_w, fwd_p, params, meta, workspace, out, L,
      n_layers, mw, out_dim, mean_pool, norm_mode, use_res, eps, (long long)pool);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

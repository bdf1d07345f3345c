// Affine-gap alignment DP (Gotoh) for Hopper (sm_90a), global
// (Needleman-Wunsch) or local (Smith-Waterman) mode, over the
// anti-diagonals d = 1 .. l1 + l2 of each pair, in two routes chosen by
// the padded length L1 alone (ops/dp_wavefront.py::route):
//   warp route, L1 + 1 <= 512 rows: one warp per pair, state in registers;
//   CTA route, larger L1 (up to the gate, L1 + 1 <= 8288): one CTA per
//     pair, diagonals in shared memory.
//
// Replaces the TPU kernel ginfinity_tpu/ops/pallas_dp.py::_kernel (:48)
// and computes what it computes: for every cell (i, j = d - i) of diagonal d
//   E  = max(H[i-1, j] + go, E[i-1, j] + ge)    TE = 1 iff extend > open
//   F  = max(H[i, j-1] + go, F[i, j-1] + ge)    TF = 1 iff extend > open
//   H  = diag if diag >= E and diag >= F, else E if E >= F, else F,
//        with diag = H[i-1, j-1] + s[i-1, j-1]
//   local mode: H <= 0 gives H = 0 and code 3 (stop)
// and writes the traceback code TH | TE << 2 | TF << 3 of every cell of
// the pair's rectangle into the sheared uint8 [B, L1 + L2, L1 + 1] codes
// (row d - 1, column i), the best score (global: H[l1, l2]; local: the
// first maximum, smallest d, then smallest i) and its cell.  Codes
// outside each pair's rectangle are not part of the result: the host's
// traceback never reads them.
//
// What bounds it on this card.  Its bytes, the scores of real cells read
// once and the codes of each pair's rectangle written once, take 6.84 us
// at 3.35 TB/s for the align path's batch (64 pairs padded to 300 x 338,
// 22.9 MB); its arithmetic (~10 float32 operations a cell) less.  But the
// l1 + l2 diagonals of a pair are a chain of dependent steps, so what
// bounds a design is the time of one step times the steps.  In the CTA
// route a step is a CTA barrier round (117 ns alone,
// dp_barrier_probe_kernel) plus the score load and five shared-memory
// reads behind it: ~506 ns.  The warp route has no barrier: its step is
// what one warp issues for its R cells, each some twenty compares,
// selects and adds that depend on one another, in one of the SM's four
// sub-partitions.  chip_smoke.py reads the align batch at 0.222 ms on the
// warp route against 0.347 ms on the CTA route (NVIDIA H100 80GB HBM3, 700
// W): ~348 ns a step over the ~638 steps of a pair.  At the CLI's 64
// pairs a batch most of the card idles; and since every lane computes
// its R rows on every diagonal, about half the cells computed (the two
// triangles outside the diagonal band) are outside the pair.
//
// What the warp route does about it:
//  * Lane t owns rows i = tR .. tR + R - 1 of every diagonal, R the
//    smallest even number with 32 R >= L1 + 1 (a template parameter,
//    2 .. 16).  H(d-1), H(d-2), E(d-1), F(d-1) of its rows are register
//    arrays indexed only by unrolled loops, so nothing goes to local
//    memory (build.log: no stack, no spills).
//  * The only values from outside the lane are row tR - 1's: H(d-1) and
//    E(d-1) by __shfl_up_sync from lane t - 1, and H(d-2), the value
//    received on the step before.  No __syncthreads.  Cells are updated
//    in place, in decreasing r, and the two H diagonals swap roles every
//    step (the loop is unrolled by two), so no register is copied.
//  * The loop runs to the pair's own l1 + l2, the same count in every
//    lane (a full-mask shuffle needs all 32); lanes whose rows lie past
//    l1 store nothing.
//  * Cells outside the pair's rectangle are not masked to NEG: none of
//    them feeds a cell inside (a cell reads rows i-1, i and columns j-1,
//    j only), except for the TF bit of the boundary cell (i, 0), which
//    dp_cell takes as if (i, -1) held NEG, as the plain version's does.
//    A mask would add selects to every cell of the step.
//  * The cell is written with selects, not branches: a branch ends the
//    compiler's scheduling region, and a step needs its R cells
//    interleaved.
//  * Scores come through shared memory, 32 diagonals at a time: for the
//    block d0 .. d0 + 31, row i needs the 32 floats S[i-1][d0-i-1 ..],
//    which one cp.async of the warp (4 bytes a lane, one 128-byte run)
//    copies into a row of the tile, rotated by the row's owner lane so
//    that reads and copies are free of bank conflicts.  Two tiles: the
//    next block's copies are in flight while this block is computed, so
//    no step waits on memory.  (Read straight from the matrix, one step
//    ahead, each of a lane's R loads touched 32 lines, one row a lane,
//    and the route was no faster than the CTA route.)  32 R rows x 32
//    floats x 2 tiles = 8 R KB a warp, so one pair (one warp) a CTA: the
//    64 pairs of a CLI batch spread over 64 SMs.
//  * A lane's R cells of diagonal d are the bytes codes[b, d-1, tR ..
//    tR + R - 1], so a warp stores one contiguous run of 32 R bytes a
//    step, in the sheared layout the host reads.
//  * Local best: each lane keeps (v, d, i) under a strict >, visiting
//    its rows in increasing i; a warp reduction then takes the largest
//    value, then the smallest d, then the smallest i.  Global best: the
//    lane that owns row l1 stores H(l1 + l2) of that row.
//
// Where trouble is likely, and what is done about it:
//  * Tie rules and boundaries live in one function, dp_cell, that both
//    routes call: the comparisons are written as in the plain version
//    (>= for H, strict < for TE/TF), never as a max followed by an
//    equality test, which would change paths on integer score matrices.
//  * Global boundaries go + (j - 1) ge and go + (i - 1) ge are one
//    __fmaf_rn, rounded once: XLA contracts the JAX package's expression
//    into a fused multiply-add, and the plain version rounds it once too
//    (in float64).  A separate product and sum differ in the last bit (with
//    ge = -0.3, for 2 of the first 40 k), which can flip a tie.
//  * Each cell runs the same float32 operations in the same order as the
//    plain version, whatever order the cells are visited in, so scores
//    agree exactly.
//  * Shared memory that no copy filled holds anything; only a cell inside
//    the rectangle, whose score is always copied, reads a score that
//    matters (tests/test_torch_dp.py runs a model of the route with NaN
//    and random values there).
//  * CTA route: cells outside i <= l1, 0 <= j <= l2 hold NEG in H, E and
//    F.  Its shared memory is 7 diagonals of L1 + 1 floats plus the
//    reduction scratch; above 48 KB the launch asks for the opt-in limit
//    (227 KB on Hopper), so L1 + 1 <= 8288.  The host gate dp_kernel_ok
//    checks it.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e9f;
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr unsigned kFullMask = 0xffffffffu;

// Dynamic shared memory of the warp route's CTA with R rows a lane: two
// score tiles of 32 R rows x 32 floats.
constexpr size_t warp_smem_bytes(int R) { return (size_t)2 * 32 * R * 32 * sizeof(float); }

// (v, d, i) comes before (v2, d2, i2): larger value, then smaller d, then
// smaller i.
__device__ __forceinline__ bool before(float v, int d, int i, float v2, int d2, int i2) {
  return v > v2 || (v == v2 && (d < d2 || (d == d2 && i < i2)));
}

// One cell (i, j) of diagonal d = i + j.  hup, eup: H and E of (i-1, j);
// hdiag: H of (i-1, j-1); hleft, fleft: H and F of (i, j-1); s: the score
// of (i, j), read only for an interior cell of the pair's rectangle
// (valid and not on_bound).  Sets H, E, F of the cell and returns its
// traceback code.
__device__ __forceinline__ uint8_t dp_cell(float hup, float eup, float hdiag, float hleft,
                                           float fleft, float s, int i, int j, bool valid,
                                           bool on_bound, float go, float ge, bool local,
                                           float& H, float& E, float& F) {
  const float e_from_h = hup + go;
  const float e_from_e = eup + ge;
  const int te = e_from_h < e_from_e;  // ties -> from H
  E = te ? e_from_e : e_from_h;

  const float f_from_h = hleft + go;
  const float f_from_f = fleft + ge;
  // cell (i, 0) takes its TF bit from cell (i, -1), outside every pair's
  // rectangle: NEG in the plain version, whatever the warp route left there
  const int tf = j == 0 && i > 0 ? kNeg + go < kNeg + ge : f_from_h < f_from_f;
  F = f_from_h < f_from_f ? f_from_f : f_from_h;

  // selects, not branches: a branch ends the scheduler's region, and the
  // warp route needs the R cells of a step interleaved
  const float diag = hdiag + s;
  const bool take_diag = diag >= E && diag >= F;
  const bool e_ge_f = E >= F;
  H = take_diag ? diag : e_ge_f ? E : F;
  int th = take_diag ? 0 : e_ge_f ? 1 : 2;
  if (local) {
    const bool stop = H <= 0.f;
    H = stop ? 0.f : H;
    th = stop ? 3 : th;
  }
  // H[0, j] = go + (j - 1) ge and H[i, 0] = go + (i - 1) ge
  const float h_bound = local ? 0.f : __fmaf_rn((float)(i == 0 ? j : i) - 1.f, ge, go);
  const int th_bound = local ? 3 : i == 0 ? 2 : 1;
  H = on_bound ? h_bound : H;
  th = on_bound ? th_bound : th;
  E = on_bound ? kNeg : E;
  F = on_bound ? kNeg : F;
  H = valid ? H : kNeg;
  E = valid ? E : kNeg;
  F = valid ? F : kNeg;
  return (uint8_t)(th | (te << 2) | (tf << 3));
}

// The CTA route: one CTA per pair, one thread per row i of a diagonal (a
// thread loops over rows i, i + blockDim, ... when L1 + 1 > 1024).
// H(d-1), H(d-2), E(d-1), F(d-1) live in shared memory: three rotating H
// buffers and two each for E and F, so a step reads only the previous
// diagonals and writes the current one.  It runs over the padded D.
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
      float H, E, F;
      cd[i] = dp_cell(hup, eup, hdiag, h1[i], f1[i], s, i, j, valid, on_bound, go, ge,
                      local, H, E, F);
      hc[i] = H;
      ec[i] = E;
      fc[i] = F;

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
    const float v = __shfl_down_sync(kFullMask, my_v, off);
    const int dd = __shfl_down_sync(kFullMask, my_d, off);
    const int ii = __shfl_down_sync(kFullMask, my_i, off);
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

// The warp route's score tiles: for a block of kWarpSteps diagonals
// d0 .. d0 + 31, row i of the pair needs the scores S[i-1][d0-i-1 ..
// d0-i+30] (one row of the block's sheared window).  Row i's 32 floats sit
// in tile row i, rotated by its owner lane i / R, so that a step's reads
// (lane t: rows tR .. tR+R-1, one column) and a row's copy (lane k: column
// k) each touch 32 distinct banks.
constexpr int kWarpSteps = 32;

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned saddr = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Start the copies of the score window of the block of diagonals d0 .. d0
// + 31 into `tile`: row i for every i in lo .. hi, the rows 1 .. l1 whose
// window meets the pair's columns, zeros for columns past them.  A block
// past the pair's last diagonal (the loop prefetches two blocks ahead)
// has lo > hi and copies nothing.  The rows go lane group by lane group
// (R rows each), so the address of a row is one multiply-add from its
// group's; a copy of zero bytes reads nothing, so the address of a
// skipped row or column need not lie in the tensor.
template <int R>
__device__ __forceinline__ void warp_load_tile(float* tile, const float* S, int L2, int l1,
                                               int l2, int d0, int lane) {
  const int lo = max(1, d0 - l2), hi = min(l1, d0 + kWarpSteps - 2);
  for (int g = lo / R; g * R <= hi; ++g) {
    const int i0 = g * R;
    float* dst = tile + i0 * kWarpSteps + ((lane + g) & (kWarpSteps - 1));
    const int c0 = d0 - i0 - 1 + lane;  // row i0's column; row i0 + r's is c0 - r
    const float* src = S + (ptrdiff_t)(i0 - 1) * L2 + c0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // signed: lo > hi past the last diagonal, and then no row is copied
      const bool ok = i0 + r >= lo && i0 + r <= hi && (unsigned)(c0 - r) < (unsigned)l2;
      cp_async4(dst + r * kWarpSteps, src + (ptrdiff_t)r * (L2 - 1), ok);
    }
  }
  cp_async_commit();
}

// One diagonal d of the warp route, for the lane's rows i0 .. i0 + R - 1:
// hc holds H(d-1); ho holds H(d-2) and receives H(d); e and f hold E(d-1)
// and F(d-1) and receive E(d) and F(d).  Cells are visited in decreasing
// r, so each reads its row-above values before they are overwritten.
template <int R, bool LOCAL>
__device__ __forceinline__ void warp_step(int d, int i0, int lane, int l1, int l2, float go,
                                          float ge, const float* srow, int col,
                                          const float (&hc)[R], float (&ho)[R], float (&e)[R],
                                          float (&f)[R], float& up_h2, uint8_t* cd,
                                          float& my_v, int& my_d, int& my_i) {
  // H(d-1) and E(d-1) of row i0 - 1, from the lane above (row -1: NEG)
  float up_h1 = __shfl_up_sync(kFullMask, hc[R - 1], 1);
  float up_e1 = __shfl_up_sync(kFullMask, e[R - 1], 1);
  if (lane == 0) {
    up_h1 = kNeg;
    up_e1 = kNeg;
  }
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    const int i = i0 + r, j = d - i;
    const bool on_bound = i == 0 || j == 0;
    const float s = srow[r * kWarpSteps + col];
    float H, E, F;
    // valid = true: a cell outside the pair's rectangle feeds only cells
    // outside it (and the TF bit of (i, 0), which dp_cell fixes), so it
    // is left unmasked
    const uint8_t code = dp_cell(r ? hc[r - 1] : up_h1, r ? e[r - 1] : up_e1,
                                 r ? ho[r - 1] : up_h2, hc[r], f[r], s, i, j, true,
                                 on_bound, go, ge, LOCAL, H, E, F);
    ho[r] = H;
    e[r] = E;
    f[r] = F;
    if (i <= l1) cd[r] = code;
  }
  if (LOCAL) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r, j = d - i;
      const bool take = i >= 1 && i <= l1 && j >= 1 && j <= l2 && ho[r] > my_v;
      my_v = take ? ho[r] : my_v;
      my_d = take ? d : my_d;
      my_i = take ? i : my_i;
    }
  }
  up_h2 = up_h1;
}

// The warp route: one warp (one CTA) per pair; lane t owns rows tR .. tR +
// R - 1 (see the note at the top).  Dynamic shared memory: two score
// tiles of 32 R rows x kWarpSteps floats.
template <int R, bool LOCAL>
__global__ void __launch_bounds__(32, 1)
dp_warp_kernel(const float* __restrict__ scores, const int* __restrict__ l1s,
               const int* __restrict__ l2s, int L1, int L2, float go, float ge,
               uint8_t* __restrict__ codes, float* __restrict__ best_out,
               int* __restrict__ bi_out, int* __restrict__ bj_out) {
  extern __shared__ float tiles[];
  constexpr int kTile = 32 * R * kWarpSteps;
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int I = L1 + 1;
  const int l1 = l1s[b], l2 = l2s[b];
  const int D = l1 + l2;
  const int i0 = lane * R;
  __builtin_assume(i0 >= 0);  // so i0 + r > 0 for r > 0, and the boundary
                              // H[i, 0] of those rows is computed once
  const float* S = scores + (size_t)b * L1 * L2;
  uint8_t* C = codes + (size_t)b * (L1 + L2) * I + i0;

  warp_load_tile<R>(tiles, S, L2, l1, l2, 1, lane);
  warp_load_tile<R>(tiles + kTile, S, L2, l1, l2, 1 + kWarpSteps, lane);

  // ha, hb: H of the last two diagonals, their roles swapping every step
  float ha[R], hb[R], e[R], f[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    ha[r] = i0 + r == 0 ? 0.f : kNeg;  // diagonal 0: only cell (0, 0)
    hb[r] = kNeg;                      // diagonal -1
    e[r] = kNeg;
    f[r] = kNeg;
  }
  float up_h2 = kNeg;  // H(d-2) of row i0 - 1
  float my_v = 0.f;    // local mode: this lane's first maximum
  int my_d = 0, my_i = 0;

  for (int d0 = 1, blk = 0; d0 <= D; d0 += kWarpSteps, ++blk) {
    float* tile = tiles + (blk & 1) * kTile;
    cp_async_wait_all_but_one();  // this block's window has landed
    __syncwarp();
    const float* srow = tile + i0 * kWarpSteps;
    const int n = min(kWarpSteps, D - d0 + 1);
    int dd = 0;
    for (; dd + 1 < n; dd += 2) {  // two steps: H(d) into hb, then H(d+1) into ha
      const int d = d0 + dd;
      warp_step<R, LOCAL>(d, i0, lane, l1, l2, go, ge, srow, (dd + lane) & (kWarpSteps - 1),
                          ha, hb, e, f, up_h2, C + (size_t)(d - 1) * I, my_v, my_d, my_i);
      warp_step<R, LOCAL>(d + 1, i0, lane, l1, l2, go, ge, srow,
                          (dd + 1 + lane) & (kWarpSteps - 1), hb, ha, e, f, up_h2,
                          C + (size_t)d * I, my_v, my_d, my_i);
    }
    if (dd < n) {  // the last diagonal of an odd D: H(D) ends in hb
      const int d = d0 + dd;
      warp_step<R, LOCAL>(d, i0, lane, l1, l2, go, ge, srow, (dd + lane) & (kWarpSteps - 1),
                          ha, hb, e, f, up_h2, C + (size_t)(d - 1) * I, my_v, my_d, my_i);
    }
    __syncwarp();  // every lane is done with this tile
    warp_load_tile<R>(tile, S, L2, l1, l2, d0 + 2 * kWarpSteps, lane);
  }
  cp_async_wait_all();  // no copy outlives the kernel (the last two copy nothing)

  if (!LOCAL) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (i0 + r == l1) {
        best_out[b] = D == 0 ? kNeg : (D & 1) ? hb[r] : ha[r];  // H(l1 + l2) of row l1
        bi_out[b] = l1;
        bj_out[b] = l2;
      }
    }
    return;
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_down_sync(kFullMask, my_v, off);
    const int dd = __shfl_down_sync(kFullMask, my_d, off);
    const int ii = __shfl_down_sync(kFullMask, my_i, off);
    if (before(v, dd, ii, my_v, my_d, my_i)) {
      my_v = v;
      my_d = dd;
      my_i = ii;
    }
  }
  if (lane == 0) {
    best_out[b] = my_v;
    bi_out[b] = my_i;
    bj_out[b] = my_d - my_i;
  }
}

template <int R, bool LOCAL>
int launch_warp(const float* scores, const int* l1, const int* l2, int B, int L1, int L2,
                float go, float ge, uint8_t* codes, float* best, int* bi, int* bj,
                cudaStream_t stream) {
  const size_t smem = warp_smem_bytes(R);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        dp_warp_kernel<R, LOCAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dp_warp_kernel<R, LOCAL><<<B, 32, smem, stream>>>(scores, l1, l2, L1, L2, go, ge, codes,
                                                    best, bi, bj);
  return (int)cudaGetLastError();
}

template <int R>
int launch_warp_rows(const void* scores, const void* l1, const void* l2, int B, int L1,
                     int L2, float go, float ge, int local, void* codes, void* best,
                     void* bi, void* bj, void* stream) {
  auto* f = local ? launch_warp<R, true> : launch_warp<R, false>;
  return f(static_cast<const float*>(scores), static_cast<const int*>(l1),
           static_cast<const int*>(l2), B, L1, L2, go, ge, static_cast<uint8_t*>(codes),
           static_cast<float*>(best), static_cast<int*>(bi), static_cast<int*>(bj),
           static_cast<cudaStream_t>(stream));
}

// A chain of dependent steps with the CTA route's shape and nothing else:
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

// Dynamic shared memory of one pair's CTA at padded length L1 (CTA route).
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

// The CTA route.
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

// The warp route with R rows a lane: R even, 2 <= R <= 16, 32 R >= L1 + 1
// (else cudaErrorInvalidValue, and nothing is launched).
int dp_wavefront_warp_launch(const void* scores, const void* l1, const void* l2, int B,
                             int L1, int L2, float go, float ge, int local, int R,
                             void* codes, void* best, void* bi, void* bj, void* stream) {
  if (32 * R < L1 + 1) return (int)cudaErrorInvalidValue;
  switch (R) {
#define DP_WARP_CASE(n)                                                                  \
  case n:                                                                                \
    return launch_warp_rows<n>(scores, l1, l2, B, L1, L2, go, ge, local, codes, best, bi, \
                               bj, stream);
    DP_WARP_CASE(2)
    DP_WARP_CASE(4)
    DP_WARP_CASE(6)
    DP_WARP_CASE(8)
    DP_WARP_CASE(10)
    DP_WARP_CASE(12)
    DP_WARP_CASE(14)
    DP_WARP_CASE(16)
#undef DP_WARP_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// `blocks` CTAs of the CTA route's thread count at padded length L1, each
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

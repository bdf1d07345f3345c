// Traceback of the affine-gap alignment DP for Hopper (sm_90a): each
// pair's path, walked on the card on the sheared code planes that K2
// (dp_wavefront.cu) or the plain wavefront wrote, so that the planes never
// leave the card.
//
// Replaces no TPU kernel: the JAX package downloads its codes and walks
// them on the host (ginfinity_tpu/ops/dp.py::_traceback_global and
// _traceback_local), and so does the port on a CPU device
// (ops/dp.py::paths_from_codes), with the same rules this kernel follows.
// Cell (i, j) of pair b is codes[b, i + j - 1, i], a byte
// TH | TE << 2 | TF << 3; cell (0, 0), which has no diagonal, reads 0.
//
//   global, from (l1, l2), state = TH(l1, l2):
//     state 0 (diag): stop if i == 0 or j == 0; emit (i-1, j-1); step to
//       (i-1, j-1); state = TH there
//     state 1 (up):   stop if i == 0; emit (i-1, -); state = TE(i, j) ? 1
//       : 0; step to (i-1, j)
//     else (left):    stop if j == 0; emit (-, j-1); state = TF(i, j) ? 2
//       : 0; step to (i, j-1)
//     until (0, 0)
//   local, from the best cell (bi, bj), while i > 0 and j > 0:
//     TH(i, j) 3 stops; 0 emits (i-1, j-1), 1 emits (i-1, -), 2 emits
//     (-, j-1), each stepping there
//
// A path of n steps is written in forward order to the last n entries of
// its rows of path_i and path_j (int32 [B, L1 + L2], -1 for a gap), with
// n in len[b]; the entries before them are not written.
//
// What bounds it on this card.  Its bytes are few: one code byte read and
// two int32 written a step (~9 bytes; 0.26 MB for 64 pairs of ~450
// steps, 0.08 us at 3.35 TB/s).  But each step's address depends on the
// step before, so a pair is a chain of up to l1 + l2 dependent loads: the
// bound is the load latency times the steps.  The planes were just
// written by K2 (~22 MB for 64 pairs of 300 x 340, inside the 50 MB L2),
// so a load is an L2 hit.  The design does not hide the chain: one thread
// walks one pair, each step one load whose address is computed without a
// branch (the cell it reads is the new cell on a diagonal step and the
// current cell on a gap step), and the pairs of a batch run side by side.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void dp_traceback_kernel(const uint8_t* __restrict__ codes,
                                    const int* __restrict__ l1,
                                    const int* __restrict__ l2,
                                    const int* __restrict__ bi,
                                    const int* __restrict__ bj, int B, int L1, int L2,
                                    int local, int* __restrict__ path_i,
                                    int* __restrict__ path_j, int* __restrict__ len) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long D = (long long)L1 + L2;  // diagonals of a plane
  const long long W = L1 + 1;              // cells of a diagonal
  const uint8_t* plane = codes + (long long)b * D * W;
  int* out_i = path_i + (long long)b * D;
  int* out_j = path_j + (long long)b * D;
  long long t = D;  // the next step goes to entry t - 1
  if (local) {
    int i = bi[b], j = bj[b];
    while (i > 0 && j > 0) {
      const int tb = plane[(long long)(i + j - 1) * W + i] & 3;
      if (tb == 3) break;
      const bool di = tb != 2, dj = tb != 1;
      --t;
      out_i[t] = di ? i - 1 : -1;
      out_j[t] = dj ? j - 1 : -1;
      i -= di;
      j -= dj;
    }
  } else {
    int i = l1[b], j = l2[b];
    int state = (i || j) ? plane[(long long)(i + j - 1) * W + i] & 3 : 0;
    while (i > 0 || j > 0) {
      const bool diag = state == 0, up = state == 1;
      if ((diag && (i == 0 || j == 0)) || (up && i == 0) || (!diag && !up && j == 0)) break;
      const bool di = diag || up, dj = !up;
      --t;
      out_i[t] = di ? i - 1 : -1;
      out_j[t] = dj ? j - 1 : -1;
      const int ni = i - di, nj = j - dj;
      // a diagonal step reads TH of the cell it reaches, a gap step TE or
      // TF of the cell it leaves
      const int ci = diag ? ni : i, cj = diag ? nj : j;
      const int c = (ci || cj) ? plane[(long long)(ci + cj - 1) * W + ci] : 0;
      state = diag ? c & 3 : up ? ((c >> 2) & 1) : 2 * ((c >> 3) & 1);
      i = ni;
      j = nj;
    }
  }
  len[b] = (int)(D - t);
}

}  // namespace

extern "C" {

// One launch over B pairs (local != 0: local mode, from (bi, bj)); returns
// a cudaError_t (0 on success).
int dp_traceback_launch(const void* codes, const void* l1, const void* l2, const void* bi,
                        const void* bj, int B, int L1, int L2, int local, void* path_i,
                        void* path_j, void* len, void* stream) {
  constexpr int kThreads = 32;
  dp_traceback_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int*>(l1),
      static_cast<const int*>(l2), static_cast<const int*>(bi), static_cast<const int*>(bj),
      B, L1, L2, local, static_cast<int*>(path_i), static_cast<int*>(path_j),
      static_cast<int*>(len));
  return (int)cudaGetLastError();
}

}  // extern "C"

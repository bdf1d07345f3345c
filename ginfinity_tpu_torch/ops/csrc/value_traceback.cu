// Value-based traceback of the profile DP for Hopper (sm_90a): the op
// codes of a batch of merges, read straight from the DP's diagonal
// states, so that they never leave the card.
//
// Stands for ginfinity_tpu/ops/pairhmm.py::_value_traceback (:470), which
// XLA lowers on the TPU (no Pallas kernel): the reference's traceback with
// its strict-greater priority M, then X, then Y.  From (l1, l2) of merge
// b, each step looks at the cell (i, j):
//   best = M[i, j] if i > 0 and j > 0 else -1e30, state 0
//   X[i, j] (i > 0)  > best: state 1, best = X
//   Y[i, j] (j > 0)  > best: state 2
// writes the state and steps to (i-1, j-1), (i-1, j) or (i, j-1); once at
// (0, 0) it writes 3 (padding) to the end.  The codes are int8
// [B, L1 + L2] in traceback (reverse) order.
//
// The states are ginfinity_tpu_torch/ops/pairhmm.py::_profile_states'
// float32 [D + 1, 3 (X, M, Y), B, L1 + 2] with D = L1 + L2: cell (i, j)
// of merge b sits at [i + j, :, b, i + 1], so no un-shear is needed.
//
// What bounds it on this card.  Its bytes are few: three floats read a
// step, one byte written a step (0.59 MB for 64 merges at P = 384, 0.2 us
// at 3.35 TB/s), and its arithmetic is a handful of compares a step.  But
// each step's address depends on the step before, so a merge is a chain
// of up to l1 + l2 dependent loads, and the states (228 MB at B = 64,
// P = 384) are far larger than the 50 MB L2: the bound is the load
// latency times the 2P steps.  The design does not hide it: one thread
// walks one merge, its three loads of a step issued together, and the
// merges of a batch run side by side.  As an eager torch loop the walk
// would cost ~10 launches a step, ~7,700 a level at P = 384.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;

__global__ void value_traceback_kernel(const float* __restrict__ st,
                                       const int* __restrict__ l1,
                                       const int* __restrict__ l2, int B, int L1,
                                       int n_steps, int8_t* __restrict__ ops) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long width = L1 + 2;             // cells of one state row
  const long long plane = (long long)B * width;  // one state of a diagonal
  // lengths past the states (a pool merge that outgrew P: an overflow the
  // host reports after the run) are clamped into them
  int i = min(max(l1[b], 0), L1);
  int j = min(max(l2[b], 0), n_steps - L1);
  int8_t* out = ops + (long long)b * n_steps;
  for (int t = 0; t < n_steps; ++t) {
    if (i == 0 && j == 0) {
      out[t] = 3;
      continue;
    }
    const float* cell = st + (long long)(i + j) * 3 * plane + (long long)b * width + (i + 1);
    const float x = cell[0];
    const float m = cell[plane];
    const float y = cell[2 * plane];
    float best = (i > 0 && j > 0) ? m : kNeg;
    int state = 0;
    const float cx = i > 0 ? x : kNeg;
    if (cx > best) {
      state = 1;
      best = cx;
    }
    const float cy = j > 0 ? y : kNeg;
    if (cy > best) state = 2;
    out[t] = (int8_t)state;
    if (state != 2) --i;
    if (state != 1) --j;
  }
}

}  // namespace

extern "C" {

// One launch over B merges; returns a cudaError_t (0 on success).
int value_traceback_launch(const void* st, const void* l1, const void* l2, int B, int L1,
                           int n_steps, void* ops, void* stream) {
  constexpr int kThreads = 64;
  value_traceback_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(st), static_cast<const int*>(l1),
      static_cast<const int*>(l2), B, L1, n_steps, static_cast<int8_t*>(ops));
  return (int)cudaGetLastError();
}

}  // extern "C"

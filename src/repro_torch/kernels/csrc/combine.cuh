// The gather and onehot combines, shared by the single-step megakernel
// (taskbench_step.cu) and the temporal-blocked one (taskbench_blocked.cu),
// so both follow one index rule. The plain PyTorch twin is
// taskbench_step.py::_slot_combine.
//
// Index rule (the reference's, src/repro/kernels/taskbench_step.py):
//   gather  src[idx] as jnp indexing reads it: a negative index counts once
//           from the end (i + S), then the row is clamped to [0, S - 1];
//   onehot  the one-hot matrix (idx == column) matches no column for an
//           index outside [0, S), so such a slot adds nothing; duplicate
//           slots merge into one row carrying their summed weight.
#pragma once

#include <cuda_runtime.h>

namespace tb {

__device__ __forceinline__ int gather_row(int r, int S) {
  if (r < 0) r += S;
  return r < 0 ? 0 : (r >= S ? S - 1 : r);
}

// Slots onehot's merge keeps in registers: a row of up to MERGE_REGS slots
// reads its indices and weights once; a row of more merges from memory.
constexpr int MERGE_REGS = 8;

// The D slots (ir, wr) of one output row under the index rule, in slot
// order: fn(row, weight) once per slot that contributes, with its source
// row (always in [0, S)) and its weight (onehot: the summed weight of every
// slot naming that row, at the first of them, summed in slot order).
// Depends on the row alone, so a caller that combines several columns of a
// row walks the slots once.
template <bool ONEHOT, class Fn>
__device__ __forceinline__ void for_each_slot(const int* __restrict__ ir,
                                              const float* __restrict__ wr,
                                              int S, int D, Fn fn) {
  if constexpr (!ONEHOT) {
    for (int j = 0; j < D; ++j) fn(gather_row(ir[j], S), wr[j]);
  } else if (D <= MERGE_REGS) {
    // padding slots name row -1, which no in-range slot matches
    int r[MERGE_REGS];
    float w[MERGE_REGS];
#pragma unroll
    for (int j = 0; j < MERGE_REGS; ++j) {
      r[j] = j < D ? ir[j] : -1;
      w[j] = j < D ? wr[j] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < MERGE_REGS; ++j) {
      if (r[j] < 0 || r[j] >= S) continue;
      bool seen = false;
#pragma unroll
      for (int i = 0; i < j; ++i) seen |= r[i] == r[j];
      if (seen) continue;
      float ws = 0.f;
#pragma unroll
      for (int i = j; i < MERGE_REGS; ++i)
        if (r[i] == r[j]) ws += w[i];
      fn(r[j], ws);
    }
  } else {
    // slot j contributes once per distinct in-range row, carrying the
    // summed weight of every slot that names that row
    for (int j = 0; j < D; ++j) {
      const int r = ir[j];
      if (r < 0 || r >= S) continue;
      bool seen = false;
      for (int i = 0; i < j; ++i) seen |= ir[i] == r;
      if (seen) continue;
      float ws = 0.f;
      for (int i = j; i < D; ++i)
        if (ir[i] == r) ws += wr[i];
      fn(r, ws);
    }
  }
}

// Weighted sum over the D slots (ir, wr) of one output row, on an S-row
// source read through `read(row)`: the value at the caller's column of
// source row `row` (always in [0, S)).
template <bool ONEHOT, class Read>
__device__ __forceinline__ float combine_slots_by(Read read,
                                                  const int* __restrict__ ir,
                                                  const float* __restrict__ wr,
                                                  int S, int D) {
  float acc = 0.f;
  for_each_slot<ONEHOT>(ir, wr, S, D,
                        [&](int r, float w) { acc = fmaf(read(r), w, acc); });
  return acc;
}

// combine_slots_by at column c of an S-row, P-column source in memory.
template <bool ONEHOT>
__device__ __forceinline__ float combine_slots(const float* __restrict__ src,
                                               const int* __restrict__ ir,
                                               const float* __restrict__ wr,
                                               int S, int P, int D, int c) {
  return combine_slots_by<ONEHOT>(
      [=](int r) { return src[static_cast<size_t>(r) * P + c]; }, ir, wr, S, D);
}

}  // namespace tb

// Sample positions and bilinear taps of the TF crop_and_resize sampling,
// shared by the RoIAlign forward (roi_align_fwd.cu) and its backward
// (roi_align_bwd.cu), so that the backward scatters to exactly the taps the
// forward gathered from, with the same lerps.
//
// For a box (c0, c1) on a map axis of extent `dim`, sample i of `crop`:
//   pos = c0*(dim-1) + i*((c1-c0)*(dim-1)/(crop-1))   (centre when crop == 1)
// rounded as XLA compiles ops/roi_align.py::_multilevel_gather: the division
// is a multiply by the float32 reciprocal `inv` of (crop-1), and
// `i*step + c0*(dim-1)` is one fused multiply-add. With `xla` (the
// backward's mode for the single-level crop) the step is rounded as XLA
// compiles the jitted ops/roi_align.py::crop_and_resize instead: it folds
// (dim-1) and `inv` into one constant first, step = (c1-c0) * ((dim-1)*inv),
// which is another float than ((c1-c0)*(dim-1))*inv for some boxes (a box
// that ends at 1.0 may tap the last row or not). The including file is
// compiled with -fmad=false, so nothing else is contracted.

#pragma once

#include <cuda_runtime.h>

namespace {

struct Taps {
  int lo;
  int hi;
  float lerp;
  bool valid;
};

__device__ __forceinline__ float sample_position(float c0, float c1, int crop,
                                                 float inv, int i, float dim,
                                                 bool xla = false) {
  const float dm1 = dim - 1.0f;
  if (crop > 1) {
    const float step = xla ? __fmul_rn(c1 - c0, __fmul_rn(dm1, inv))
                           : __fmul_rn(__fmul_rn(c1 - c0, dm1), inv);
    return __fmaf_rn((float)i, step, __fmul_rn(c0, dm1));
  }
  return __fmul_rn(__fmul_rn(0.5f, c0 + c1), dm1);
}

__device__ __forceinline__ Taps corner_taps(float pos, float dim) {
  const float dm1 = dim - 1.0f;
  Taps t;
  t.valid = (pos >= 0.0f) && (pos <= dm1);
  const float lo = floorf(pos);
  const float hi = ceilf(pos);
  t.lerp = pos - lo;
  // Clamped in float first, so that a position far outside the map never
  // converts out of int range. In-range taps are unchanged by the clamp.
  t.lo = (int)fminf(fmaxf(lo, 0.0f), dm1);
  t.hi = (int)fminf(fmaxf(hi, 0.0f), dm1);
  return t;
}

}  // namespace

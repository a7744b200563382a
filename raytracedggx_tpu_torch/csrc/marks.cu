// Stage marks: one empty kernel per stage of the frame, named after it.
//
// A frame captured into a CUDA graph (Renderer.step_n) replays its kernels
// by name but keeps no host scope, so a profiler cannot tell which stage
// of the frame a replayed torch operation belongs to.  Each mark is a
// <<<1, 1>>> launch on the frame's stream at the start of its stage
// (engine/spans.py), captured with the frame as a kernel node: in a
// device trace, a stage runs from its mark's start to the next mark's.
// The marks read and write nothing, so the frame's outputs do not depend
// on them.

#include <cuda_runtime.h>

extern "C" {

__global__ void rtggx_mark_refit() {}
__global__ void rtggx_mark_primary() {}
__global__ void rtggx_mark_reflection() {}
__global__ void rtggx_mark_diffuse() {}
__global__ void rtggx_mark_spatial() {}
__global__ void rtggx_mark_taa() {}
__global__ void rtggx_mark_tonemap() {}
__global__ void rtggx_mark_end() {}

// Launches mark `stage` (spans.STAGES' order: refit, primary, reflection,
// diffuse, spatial, taa, tonemap, end) on `stream`.
int rtggx_mark(int stage, void* stream) {
  static const void* const marks[] = {
      (const void*)rtggx_mark_refit,      (const void*)rtggx_mark_primary,
      (const void*)rtggx_mark_reflection, (const void*)rtggx_mark_diffuse,
      (const void*)rtggx_mark_spatial,    (const void*)rtggx_mark_taa,
      (const void*)rtggx_mark_tonemap,    (const void*)rtggx_mark_end};
  if (stage < 0 || stage >= (int)(sizeof(marks) / sizeof(marks[0])))
    return (int)cudaErrorInvalidValue;
  return (int)cudaLaunchKernel(marks[stage], dim3(1), dim3(1), nullptr, 0,
                               (cudaStream_t)stream);
}

}  // extern "C"

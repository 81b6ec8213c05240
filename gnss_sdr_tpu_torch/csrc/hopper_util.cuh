// Device helpers shared by the trackers (csrc/track_loop.cuh) and the
// primitive-cost probe (csrc/probe.cu): the reduced-range sine and cosine,
// and the mbarrier and 1-D bulk-copy (TMA) primitives.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// sin and cos of a phase of at most a few thousand radians: reduce to
// [-pi, pi] with 2 pi split in two floats (each product exact in the fma,
// so the reduction adds two roundings of |r| <= pi), then the hardware's
// __sincosf, accurate to ~4e-7 there. Replaces sincosf, whose slow-path
// argument reduction (a loop over the 2/pi table, through the stack in K2)
// sat in the trackers' sample loop.
__device__ __forceinline__ void sincos_reduced(float ph, float* s, float* c) {
  const float m = rintf(ph * 0.159154943f);          // ph / (2 pi)
  float r = fmaf(-m, 6.28318548f, ph);               // float32(2 pi)
  r = fmaf(-m, -1.74845553e-7f, r);                  // 2 pi - float32(2 pi)
  __sincosf(r, s, c);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n\t.reg .b64 state;\n\t"
               "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("{\n\t.reg .b64 state;\n\t"
               "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n\t}"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// 1-D bulk copy (TMA) of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into this CTA's shared memory, completing
// on the mbarrier's transaction count
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

}  // namespace

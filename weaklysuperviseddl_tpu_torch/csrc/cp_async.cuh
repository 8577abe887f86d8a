// cp.async, shared by the kernels that stage tiles in shared memory: 16 bytes
// from global to shared memory without passing through registers, and the
// waits for the copies this thread started.

#pragma once

#include <cuda_runtime.h>

namespace wsdl {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;" ::"n"(N)); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;"); }

}  // namespace wsdl

// Hopper (sm_90a) building blocks shared by the kernels that use the Tensor
// Memory Accelerator and warpgroup products: mbarriers, TMA and bulk copies,
// wgmma fences and shared-memory descriptors, and cuTensorMapEncodeTiled,
// fetched from the libcuda the process has already loaded (no link against
// it). Inline PTX, as the rest of the package writes mma.sync and ldmatrix.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <atomic>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

// makes the initialised barriers visible to the async proxy
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity) : "memory");
}

// contiguous bytes global -> shared, completion counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2) : "memory");
}

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1) : "memory");
}

// barrier `id` (1..15) over the 128 threads of one warpgroup
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins a register in program order against the asynchronous products:
// reads of an accumulator stay after the wait that completes it, writes
// before the fence that hands it to the next product.
template <typename T>
__device__ __forceinline__ void fence_operand(T& x) {
  asm volatile("" : "+r"(x)::"memory");
}

__device__ __forceinline__ void fence_operand(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

// Shared-memory descriptor of a K-major operand without swizzle: core
// matrices of 8 rows x 16 bytes, `lbo` bytes between the two core matrices
// of one k-step, `sbo` bytes between groups of 8 rows.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, uint32_t lbo,
                                                uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The last result of a host query that costs microseconds (an occupancy
// calculation) and repeats with the same arguments at every launch: one
// (key, value) pair packed in an atomic word, so launches from several
// threads always read a pair that belongs together. Keys below 2^31,
// values below 2^32.
class HostMemo {
 public:
  // the value for `key`: the cached one, or f(&value) (a CUDA error code)
  template <class F>
  cudaError_t get(uint32_t key, int* value, F f) {
    const uint64_t w = word_.load(std::memory_order_relaxed);
    if ((w >> 32) == (uint64_t)key + 1) {
      *value = (int)(uint32_t)w;
      return cudaSuccess;
    }
    const cudaError_t err = f(value);
    if (err == cudaSuccess)
      word_.store((((uint64_t)key + 1) << 32) | (uint32_t)*value,
                  std::memory_order_relaxed);
    return err;
  }

 private:
  std::atomic<uint64_t> word_{0};
};

// cuTensorMapEncodeTiled from the libcuda the CUDA runtime loaded
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

}  // namespace sm90

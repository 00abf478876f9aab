// CPU stand-in for the CUDA runtime, so the port's .cu sources compile with
// g++ and run on the CPU in tests (tests/test_torch_port_cuda_emu.py).
//
// Each CUDA thread of a block runs as one std::thread; __syncthreads() is a
// std::barrier over the block; blocks run one after another, so a single
// static buffer serves as the block's shared memory. The test rewrites
// `kernel<<<grid, block, smem, stream>>>(args)` into
// `emu_launch(grid, block, smem, [&] { kernel(args); })` and
// `extern __shared__ float smem[];` into a pointer to that buffer. The
// asynchronous copies of cuda_pipeline_primitives.h copy at once, so every
// wait is already satisfied. Only what the port's sources use is provided.
#pragma once
#include <barrier>
#include <cmath>
#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <stdexcept>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint4 { uint32_t x, y, z, w; };
struct uint2 { uint32_t x, y; };
struct int4 { int x, y, z, w; };
struct uchar4 { uint8_t x, y, z, w; };
struct float4 { float x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }

inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) >> 32);
}
// volatile keeps each product and sum rounded on its own (no contraction)
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
using std::max;
using std::min;
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) {
  std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline int atomicMin(int* p, int v) {
  std::atomic_ref<int> a(*p);
  int old = a.load();
  while (old > v && !a.compare_exchange_weak(old, v)) {}
  return old;
}
inline int atomicMax(int* p, int v) {
  std::atomic_ref<int> a(*p);
  int old = a.load();
  while (old < v && !a.compare_exchange_weak(old, v)) {}
  return old;
}
inline void __pipeline_wait_prior(size_t) {}
inline void sincospif(float x, float* s, float* c) {
  *s = std::sin(static_cast<float>(M_PI) * x);
  *c = std::cos(static_cast<float>(M_PI) * x);
}

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
alignas(16) inline float emu_shared[1 << 16];
inline std::barrier<>* emu_barrier = nullptr;
inline void __syncthreads() { emu_barrier->arrive_and_wait(); }

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == cudaSuccess ? "no error" : "invalid argument";
}

inline void emu_launch(dim3 grid, dim3 block, size_t smem,
                       const std::function<void()>& body) {
  if (smem > sizeof(emu_shared)) throw std::runtime_error("shared memory");
  blockDim = block;
  gridDim = grid;
  const unsigned n = block.x * block.y * block.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> bar(n);
        emu_barrier = &bar;
        std::vector<std::thread> threads;
        for (unsigned tz = 0; tz < block.z; ++tz)
          for (unsigned ty = 0; ty < block.y; ++ty)
            for (unsigned tx = 0; tx < block.x; ++tx)
              threads.emplace_back([&, bx, by, bz, tx, ty, tz] {
                blockIdx = dim3(bx, by, bz);
                threadIdx = dim3(tx, ty, tz);
                body();
                bar.arrive_and_drop();  // an early return leaves the barrier
              });
        for (auto& t : threads) t.join();
      }
}


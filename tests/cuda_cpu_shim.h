// A CPU stand-in for the CUDA a hand kernel uses, so that a kernel's
// source compiles with g++ and runs under AddressSanitizer: every CUDA
// thread is a std::thread, block, warp and grid barriers are std::barrier,
// a warp's shuffles go through an exchange array between two warp
// barriers, cp.async is a plain copy, bf16 rounds to nearest even, and a
// CTA's dynamic shared memory is a heap buffer of exactly the launch's
// size. Used by tests/test_torch_jfa_source.py and
// tests/test_torch_lk_flow_source.py.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __align__(n) alignas(n)
#define __shared__
#define CUDART_INF_F INFINITY

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
inline thread_local std::barrier<>* shim_cta_barrier;
inline std::barrier<>* shim_grid_barrier;
inline thread_local void* shim_smem;
inline unsigned shim_smem_bytes;     // the running launch's shared memory

// a warp: its lanes' barrier and the exchange array of its shuffles
struct ShimWarp {
  std::barrier<> bar;
  float ex[32];
  explicit ShimWarp(int lanes) : bar(lanes) {}
};
inline thread_local ShimWarp* shim_warp;

inline void __syncthreads() { shim_cta_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  shim_warp->bar.arrive_and_wait();
}
// every lane of the warp calls a shuffle together, as the kernels do
inline float shim_shuffle(float v, int from) {
  const int lane = threadIdx.x & 31;
  shim_warp->ex[lane] = v;
  shim_warp->bar.arrive_and_wait();
  const float r = shim_warp->ex[from & 31];
  shim_warp->bar.arrive_and_wait();
  return r;
}
inline float __shfl_xor_sync(unsigned, float v, int o) {
  return shim_shuffle(v, (threadIdx.x & 31) ^ o);
}
inline float __shfl_sync(unsigned, float v, int src) {
  return shim_shuffle(v, src);
}
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n) {
  std::memcpy(dst, src, n);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(int) {}
inline void __trap() { std::abort(); }
namespace cooperative_groups {
struct grid_group {
  void sync() { shim_grid_barrier->arrive_and_wait(); }
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups

struct float2 { float x, y; };
struct int2 { int x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline int2 make_int2(int a, int b) { return {a, b}; }
// each product and sum rounded on its own, as the intrinsics do
inline float __fmul_rn(float a, float b) { volatile float r = a * b; return r; }
inline float __fadd_rn(float a, float b) { volatile float r = a + b; return r; }
inline float __fsub_rn(float a, float b) { volatile float r = a - b; return r; }
inline float __fdiv_rn(float a, float b) { volatile float r = a / b; return r; }
inline float __fsqrt_rn(float a) { volatile float r = std::sqrt(a); return r; }
inline int __float2int_rd(float a) { return (int)std::floor(a); }
inline float __int_as_float(int i) {
  float f;
  std::memcpy(&f, &i, 4);
  return f;
}
// bf16: the upper half of a float32, rounded to nearest even
struct __nv_bfloat16 {
  uint16_t bits;
};
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = (uint32_t)h.bits << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
template <class T> inline T __ldcg(const T* p) { return *p; }
using std::max;
using std::min;

// Launch a grid of CTAs of T threads, each CTA with `smem` bytes of shared
// memory: all CTAs at once (a grid barrier needs them), or with
// `one_cta_at_a_time` each CTA's threads after the last CTA's have ended
// (fewer threads, for kernels with no grid barrier).
inline void shim_launch(dim3 grid_dim, int T, size_t smem,
                        const std::function<void()>& body,
                        bool one_cta_at_a_time = false) {
  const int G = (int)(grid_dim.x * grid_dim.y * grid_dim.z);
  gridDim = grid_dim;
  blockDim = dim3(T);
  shim_smem_bytes = (unsigned)smem;
  std::barrier<> grid(one_cta_at_a_time ? T : G * T);
  shim_grid_barrier = &grid;
  const int W = (T + 31) / 32;
  std::vector<std::thread> threads;
  auto run = [&](int g0, int g1) {
    std::vector<std::unique_ptr<std::barrier<>>> cta;
    std::vector<std::vector<char>> mem(g1 - g0, std::vector<char>(smem));
    std::vector<std::unique_ptr<ShimWarp>> warps;
    for (int g = g0; g < g1; ++g) {
      cta.emplace_back(new std::barrier<>(T));
      for (int w = 0; w < W; ++w)
        warps.emplace_back(new ShimWarp(std::min(32, T - 32 * w)));
    }
    for (int g = g0; g < g1; ++g)
      for (int t = 0; t < T; ++t)
        threads.emplace_back([&, g, t] {
          const int i = g - g0;
          blockIdx = dim3(g % grid_dim.x, g / grid_dim.x % grid_dim.y,
                          g / (grid_dim.x * grid_dim.y));
          threadIdx = dim3(t);
          shim_cta_barrier = cta[i].get();
          shim_warp = warps[(size_t)i * W + t / 32].get();
          shim_smem = mem[i].data();
          body();
        });
    for (auto& th : threads) th.join();
    threads.clear();
  };
  if (one_cta_at_a_time)
    for (int g = 0; g < G; ++g) run(g, g + 1);
  else
    run(0, G);
}

inline void shim_launch(int G, int T, size_t smem,
                        const std::function<void()>& body) {
  shim_launch(dim3(G), T, smem, body);
}

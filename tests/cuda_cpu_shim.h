// A CPU stand-in for the CUDA a hand kernel uses, so that a kernel's
// source compiles with g++ and runs under AddressSanitizer: every CUDA
// thread is a std::thread, block and grid barriers are std::barrier, and a
// CTA's dynamic shared memory is a heap buffer of exactly the launch's
// size. Used by tests/test_torch_jfa_source.py.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
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

inline void __syncthreads() { shim_cta_barrier->arrive_and_wait(); }
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
template <class T> inline T __ldcg(const T* p) { return *p; }
using std::max;
using std::min;

// Launch G CTAs of T threads, each CTA with `smem` bytes of shared memory.
inline void shim_launch(int G, int T, size_t smem,
                        const std::function<void()>& body) {
  gridDim = dim3(G);
  blockDim = dim3(T);
  std::barrier<> grid(G * T);
  shim_grid_barrier = &grid;
  std::vector<std::unique_ptr<std::barrier<>>> cta;
  std::vector<std::vector<char>> mem(G, std::vector<char>(smem));
  for (int g = 0; g < G; ++g) cta.emplace_back(new std::barrier<>(T));
  std::vector<std::thread> threads;
  for (int g = 0; g < G; ++g)
    for (int t = 0; t < T; ++t)
      threads.emplace_back([&, g, t] {
        blockIdx = dim3(g);
        threadIdx = dim3(t);
        shim_cta_barrier = cta[g].get();
        shim_smem = mem[g].data();
        body();
      });
  for (auto& th : threads) th.join();
}

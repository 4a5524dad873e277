// A CPU stand-in for the CUDA a hand kernel uses, so that a kernel's
// source compiles with g++ and runs under AddressSanitizer: every CUDA
// thread is a std::thread, block, warp and grid barriers are std::barrier,
// a warp's shuffles go through an exchange array between two warp
// barriers, cp.async is a plain copy, bf16 rounds to nearest even, and a
// CTA's dynamic shared memory is a heap buffer of exactly the launch's
// size. A thread block cluster (shim_launch's cluster_x) has a barrier of
// its own, and map_shared_rank maps an address in one CTA's buffer to the
// same offset in another's. Warp votes and reductions, __syncthreads_or
// and the int atomics go through the same exchanges and std::atomic_ref.
// Used by tests/test_torch_jfa_source.py, tests/test_torch_lk_flow_source.py
// and tests/test_torch_ba_mapvote_source.py.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __host__
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
inline std::vector<void*> shim_cta_smem;   // every CTA's, by linear index
inline thread_local int shim_cta;          // this CTA's linear index
inline thread_local std::atomic<int>* shim_cta_int;  // __syncthreads_or's
inline int shim_cluster_x = 1;             // CTAs a cluster, along x
inline thread_local std::barrier<>* shim_cluster_barrier;

// a warp: its lanes' barrier and the exchange array of its shuffles
struct ShimWarp {
  std::barrier<> bar;
  unsigned long long ex[32];
  explicit ShimWarp(int lanes) : bar(lanes) {}
};
inline thread_local ShimWarp* shim_warp;

inline void __syncthreads() { shim_cta_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  shim_warp->bar.arrive_and_wait();
}
// every lane of the warp calls a shuffle together, as the kernels do: each
// lane's value into the exchange, a barrier, fn(the 32 values), a barrier
template <class T, class F>
inline auto shim_exchange(T v, F fn) {
  static_assert(sizeof(T) <= 8);
  const int lane = threadIdx.x & 31;
  unsigned long long u = 0;
  std::memcpy(&u, &v, sizeof(T));
  shim_warp->ex[lane] = u;
  shim_warp->bar.arrive_and_wait();
  T all[32];
  for (int i = 0; i < 32; ++i) std::memcpy(&all[i], &shim_warp->ex[i],
                                           sizeof(T));
  const auto r = fn(all, lane);
  shim_warp->bar.arrive_and_wait();
  return r;
}
template <class T> inline T shim_shuffle(T v, int from) {
  return shim_exchange(v, [&](const T* all, int) { return all[from & 31]; });
}
template <class T> inline T __shfl_xor_sync(unsigned, T v, int o) {
  return shim_shuffle(v, (threadIdx.x & 31) ^ o);
}
template <class T> inline T __shfl_sync(unsigned, T v, int src) {
  return shim_shuffle(v, src);
}
template <class T> inline T __shfl_up_sync(unsigned, T v, unsigned d) {
  return shim_exchange(v, [&](const T* all, int lane) {
    return lane >= (int)d ? all[lane - d] : all[lane];
  });
}
template <class T> inline T __shfl_down_sync(unsigned, T v, unsigned d) {
  return shim_exchange(v, [&](const T* all, int lane) {
    return lane + (int)d < 32 ? all[lane + d] : all[lane];
  });
}
inline unsigned __match_any_sync(unsigned, int v) {
  return shim_exchange(v, [&](const int* all, int lane) {
    unsigned m = 0u;
    for (int i = 0; i < 32; ++i) m |= all[i] == all[lane] ? 1u << i : 0u;
    return m;
  });
}
inline unsigned __ballot_sync(unsigned, int p) {
  return shim_exchange(p != 0, [&](const bool* all, int) {
    unsigned m = 0u;
    for (int i = 0; i < 32; ++i) m |= all[i] ? 1u << i : 0u;
    return m;
  });
}
template <class T> inline T __reduce_max_sync(unsigned, T v) {
  return shim_exchange(v, [&](const T* all, int) {
    return *std::max_element(all, all + 32);
  });
}
template <class T> inline T __reduce_min_sync(unsigned, T v) {
  return shim_exchange(v, [&](const T* all, int) {
    return *std::min_element(all, all + 32);
  });
}
template <class T> inline T __reduce_add_sync(unsigned, T v) {
  return shim_exchange(v, [&](const T* all, int) {
    T s = 0;
    for (int i = 0; i < 32; ++i) s += all[i];
    return s;
  });
}
inline int __syncthreads_or(int p) {
  __syncthreads();                 // the last call's readers are done
  if (threadIdx.x == 0) shim_cta_int->store(0);
  __syncthreads();
  if (p) shim_cta_int->fetch_or(1);
  __syncthreads();
  return shim_cta_int->load();
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(int v) { return __builtin_ffs(v); }
inline long long clock64() { return 0; }
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
}
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_or(v);
}
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline double rsqrt(double x) { return 1.0 / std::sqrt(x); }
using std::isfinite;
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
// a cluster of shim_cluster_x CTAs along x
struct cluster_group {
  unsigned block_rank() const { return blockIdx.x % shim_cluster_x; }
  unsigned num_blocks() const { return shim_cluster_x; }
  void sync() { shim_cluster_barrier->arrive_and_wait(); }
  // the same offset in CTA `rank` of this cluster's shared memory
  template <class T> T* map_shared_rank(T* p, int rank) const {
    const std::ptrdiff_t off = reinterpret_cast<char*>(p) -
                               static_cast<char*>(shim_smem);
    const int cta = shim_cta - (int)block_rank() + rank;
    return reinterpret_cast<T*>(static_cast<char*>(shim_cta_smem[cta]) + off);
  }
};
inline cluster_group this_cluster() { return {}; }
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
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline double __longlong_as_double(long long i) {
  double d;
  std::memcpy(&d, &i, 8);
  return d;
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
// (fewer threads, for kernels with no grid barrier). `cluster_x` CTAs
// along x make a cluster (all CTAs at once).
inline void shim_launch(dim3 grid_dim, int T, size_t smem,
                        const std::function<void()>& body,
                        bool one_cta_at_a_time = false, int cluster_x = 1) {
  const int G = (int)(grid_dim.x * grid_dim.y * grid_dim.z);
  gridDim = grid_dim;
  blockDim = dim3(T);
  shim_smem_bytes = (unsigned)smem;
  shim_cluster_x = cluster_x;
  shim_cta_smem.assign(G, nullptr);
  std::barrier<> grid(one_cta_at_a_time ? T : G * T);
  shim_grid_barrier = &grid;
  const int W = (T + 31) / 32;
  std::vector<std::thread> threads;
  auto run = [&](int g0, int g1) {
    std::vector<std::unique_ptr<std::barrier<>>> cta, clusters;
    std::vector<std::unique_ptr<std::atomic<int>>> ors;
    std::vector<std::vector<char>> mem(g1 - g0, std::vector<char>(smem));
    std::vector<std::unique_ptr<ShimWarp>> warps;
    for (int g = g0; g < g1; ++g) {
      cta.emplace_back(new std::barrier<>(T));
      ors.emplace_back(new std::atomic<int>(0));
      shim_cta_smem[g] = mem[g - g0].data();
      if ((g - g0) % cluster_x == 0)
        clusters.emplace_back(new std::barrier<>(cluster_x * T));
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
          shim_cta = g;
          shim_cta_barrier = cta[i].get();
          shim_cta_int = ors[i].get();
          shim_cluster_barrier = clusters[i / cluster_x].get();
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

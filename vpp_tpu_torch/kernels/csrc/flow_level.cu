// K1 — one pyramid level of semi-dense optical flow, in two launches.
//
// Replaces vpp_tpu/algorithms/flow.py:_flow_level_xla (:224) with
// _warp_by_cell_flow (:102), _cost_volume (:156) and _volume_lookup (:196).
//
// What the level computes, per grid cell (gy, gx) and displacement k of the
// displacement table (smallest first, flow.py:_displacement_table):
//   cost[k] = sum over the ws x ws window at (r0 + gy*patch, r0 + gx*patch)
//             of bf16(|bf16(a1[y, x]) - bf16(a2w[y + dr_k, x + dc_k])|),
//             summed in float32, coordinates clamped to the buffer (the JAX
//             edge padding), where a2w is a2 backward-warped by the clipped
//             per-cell prediction: the column shift first, then the row
//             shift read at the shifted column, both wrapping like jnp.roll;
//   best    = first k of minimum cost, flow = pred + d_best, dist = cost,
//             reset to (pred, 1e30) where the matched window centre leaves
//             the level domain (for a column slice of a wider level, the
//             sharded tracker's, the wide level's columns: col0, w_total);
//   then prop_iters Jacobi passes: every cell scores its 8 neighbours'
//   flows (_C8 order) against its own volume and adopts a strictly better
//   one that differs by more than 2 px.
//
// Launch A, flow_volume_kernel — replaces _warp_by_cell_flow and
// _cost_volume. A block takes a tile of Tile x Tile cells (8 x 8 with 256
// threads, or 4 x 4 with 128: flow.py:_k1_plan chooses) and a chunk of the
// displacement table. It loads the tile's window region of a1, and the
// same region of a2 with an R-pixel halo, into shared memory once, rounded
// to bf16; each a2 pixel is warped once on the way in. Per displacement it
// forms every region pixel's |diff| once (kept as bf16, which is exact),
// sums ws rows at stride patch, then ws columns at stride patch (the JAX
// level's P·diff·Q), and writes vol[k, gy, gx] with neighbouring threads on
// neighbouring gx. Where a level has too few tiles to fill the card's SMs
// (the coarse levels), blocks also split the displacement table. Each
// block also writes its chunk's first minimum (cost, k) per cell, the
// first half of the argmin.
//
// Launch B, flow_select_kernel — replaces the argmin, the in-domain
// rejection and the propagation loop over _volume_lookup. A block owns a
// tile x tile square of cells and holds a halo of prop_iters cells of flow
// and dist in shared memory. The argmin combines launch A's chunk minima as
// (cost, k) in lexicographic order, so it is the first minimum whatever the
// order. The passes run inside the block on the shrinking halo, so pass p is
// exact on the tile; flow and dist are written once.
//
// Bound on the H100: the level must read a1 and a2 once and write flow and
// dist once: about 3.5 MB for the three levels of a 640x480 frame, 1.2 us
// at 3.35 TB/s; the separable sums are ~25 M operations, under 0.4 us at
// 67 TFLOP/s. Both are far below what a launch costs, so the floor is two
// launches a level, six a tracker frame. Launch A runs well above that
// floor: a block's phases are chains of dependent loads and barriers with
// few blocks on an SM, so it sits at its blocks' latency (measured times:
// PERF.md, from chip_smoke.py and k1_tiles.py).
//
// Streams: both launches take S levels of one geometry at once, launch A
// with the stream and the chunk in blockIdx.z (z = stream * chunks +
// chunk), launch B with the stream in blockIdx.z; each stream reads and
// writes its own buffers. A window sums in one order whatever the tile,
// chunk or stream count, so S levels in one launch give the bits of S
// launches.
//
// Shared memory: flow.py:_k1_plan sizes each launch's dynamic shared
// memory for the layout that the kernel's head carves; a block that is
// given less stops the launch with a trap rather than overrun it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kInf = 1e30f;
constexpr int kMaxD2 = 1024;
constexpr int kSelectThreads = 256;        // launch B
constexpr int kBatch = 8;                  // most displacements per batch
constexpr int kLoads = 16;                 // global loads in flight a thread
constexpr int kSmemDefault = 48 * 1024;    // above this, opt in per kernel
constexpr int kSmemMax = 232448;           // 227 KB: one block on Hopper
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// bytes of dynamic shared memory the running launch was given
__device__ __forceinline__ unsigned dynamic_smem_bytes() {
  unsigned n;
  asm volatile("mov.u32 %0, %%dynamic_smem_size;" : "=r"(n));
  return n;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// v mod n in [0, n), like jnp.roll's wrap: selects for a shift within one
// buffer width (every shift the warp clip allows on a buffer wider than the
// clip), a division only beyond that
__device__ __forceinline__ int wrap(int v, int n) {
  int m = v + (v < 0 ? n : 0);
  m -= m >= n ? n : 0;
  if ((unsigned)m >= (unsigned)n) {
    m = v % n;
    m += m < 0 ? n : 0;
  }
  return m;
}

struct LevelGeom {
  int hb, wb, b, h, w;
  int patch, gh, gw, ph, pw;  // ph/pw: pixel extent of the cell repeat
  int pred_bound;
  float inv_patch;            // 1 / patch, rounded to float
};

// floor(v / patch) for 0 <= v < 2^16: (v + 1/2) / patch lies at least
// 1/(2 patch) from an integer, far more than the float product's error
__device__ __forceinline__ int cell_of(const LevelGeom& g, int v) {
  return __float2int_rd(((float)v + 0.5f) * g.inv_patch);
}

__device__ __forceinline__ int cell_row(const LevelGeom& g, int y) {
  return cell_of(g, clampi(y - g.b, 0, g.ph - 1));
}

// Where a2 backward-warped by the clipped per-cell prediction reads for
// buffer pixel (y, x), as an offset into a2. Mirrors
// flow.py:_warp_by_cell_flow: the row pass, then the column pass over the
// row-warped buffer, each a select over even shifts k in
// [-pred_bound, pred_bound], k != 0, rolled with wrap-around. Both reads
// of the prediction are in the cell row of y.
__device__ __forceinline__ int warped_at(const int* __restrict__ pred,
                                         const LevelGeom& g, int y, int x) {
  if (g.pred_bound == 0) return y * g.wb + x;
  const int pb = g.pred_bound;
  const int* row = pred + cell_row(g, y) * g.gw * 2;
  const int cx = cell_of(g, clampi(x - g.b, 0, g.pw - 1));
  const int s1 = clampi(row[cx * 2 + 1], -pb, pb);
  const int x1 =
      s1 != 0 && ((s1 + pb) & 1) == 0 ? wrap(x + s1, g.wb) : x;
  const int cx1 = cell_of(g, clampi(x1 - g.b, 0, g.pw - 1));
  const int s0 = clampi(row[cx1 * 2], -pb, pb);
  const int y1 =
      s0 != 0 && ((s0 + pb) & 1) == 0 ? wrap(y + s0, g.hb) : y;
  return y1 * g.wb + x1;
}

// Fills dst (rows x cols, row-major) with bf16(src[at(r, c)]), kLoads
// elements per thread at a time: a round computes its offsets, then issues
// every load, without a branch, then stores, so a thread waits on the
// memory once a round, not once an element. at takes r up to rows - 1.
template <int Threads, typename At>
__device__ __forceinline__ void load_region(float* dst, int rows, int cols,
                                            const float* __restrict__ src,
                                            At at) {
  const int step_r = Threads / cols, step_c = Threads % cols;
  int r = threadIdx.x / cols, c = threadIdx.x % cols;
  while (r < rows) {
    int rr[kLoads], cc[kLoads], off[kLoads];
    float v[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      rr[k] = r;
      cc[k] = c;
      c += step_c;
      r += step_r;
      if (c >= cols) {
        c -= cols;
        ++r;
      }
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) off[k] = at(min(rr[k], rows - 1), cc[k]);
#pragma unroll
    for (int k = 0; k < kLoads; ++k) v[k] = src[off[k]];
#pragma unroll
    for (int k = 0; k < kLoads; ++k)
      if (rr[k] < rows) dst[rr[k] * cols + cc[k]] = bf16_round(v[k]);
  }
}

// Launch A. Shared memory: a1 region (span x span float), warped a2 region
// with an R halo (hs x hs float), column sums (kb x Tile x span float),
// the slots' running minima (Threads float), the chunk's displacements as
// offsets into the a2 region (kc int), the slots' argmins (Threads int),
// |diffs| (kb x span x span bf16). Besides vol it writes, per cell, the
// first minimum (cost, k) of its chunk: part_cost/part_k[chunk][cell].
template <int Tile, int Threads>
__global__ void __launch_bounds__(Threads)
flow_volume_kernel(const float* __restrict__ a1, const float* __restrict__ a2,
                   const int* __restrict__ pred, const int* __restrict__ disp,
                   int d2, LevelGeom g, int ws, int r0, int R, int kc, int kb,
                   int nchunk, float* __restrict__ vol,
                   float* __restrict__ part_cost, int* __restrict__ part_k) {
  constexpr int kSlots = Threads / (Tile * Tile);
  // stream blockIdx.z / nchunk: its buffers, prediction, volume and minima
  const int stream = blockIdx.z / nchunk, chunk = blockIdx.z % nchunk;
  const size_t ncell_s = (size_t)g.gh * g.gw;
  a1 += (size_t)stream * g.hb * g.wb;
  a2 += (size_t)stream * g.hb * g.wb;
  pred += (size_t)stream * 2 * ncell_s;
  vol += (size_t)stream * d2 * ncell_s;
  part_cost += (size_t)stream * nchunk * ncell_s;
  part_k += (size_t)stream * nchunk * ncell_s;
  extern __shared__ __align__(16) unsigned char smem[];
  const int span = (Tile - 1) * g.patch + ws, hs = span + 2 * R;
  const int npx = span * span, ncol = Tile * span;
  float* s_a1 = reinterpret_cast<float*>(smem);
  float* s_a2 = s_a1 + npx;
  float* s_col = s_a2 + hs * hs;
  float* s_pm = s_col + kb * ncol;
  int* s_off = reinterpret_cast<int*>(s_pm + Threads);
  int* s_pk = s_off + kc;
  __nv_bfloat16* s_diff = reinterpret_cast<__nv_bfloat16*>(s_pk + Threads);
  if ((unsigned)(reinterpret_cast<unsigned char*>(s_diff + kb * npx) - smem) >
      dynamic_smem_bytes())
    __trap();
  const int tid = threadIdx.x;
  const int gy0 = blockIdx.y * Tile, gx0 = blockIdx.x * Tile;
  const int y0 = r0 + gy0 * g.patch, x0 = r0 + gx0 * g.patch;
  const int k_begin = chunk * kc, k_end = min(d2, k_begin + kc);
  const int ncell = g.gh * g.gw;

  for (int q = tid; q < k_end - k_begin; q += Threads)
    s_off[q] = disp[2 * (k_begin + q)] * hs + disp[2 * (k_begin + q) + 1];
  load_region<Threads>(s_a1, span, span, a1, [&](int r, int c) {
    return clampi(y0 + r, 0, g.hb - 1) * g.wb + clampi(x0 + c, 0, g.wb - 1);
  });
  load_region<Threads>(s_a2, hs, hs, a2, [&](int r, int c) {
    const int y = clampi(y0 - R + r, 0, g.hb - 1);
    return warped_at(pred, g, y, clampi(x0 - R + c, 0, g.wb - 1));
  });
  __syncthreads();

  // pass 3's thread: one cell of the tile, every kSlots-th displacement
  const int cell_t = tid % (Tile * Tile), slot = tid / (Tile * Tile);
  const int ty = cell_t / Tile, tx = cell_t % Tile;
  const int gy = gy0 + ty, gx = gx0 + tx;
  const bool in_grid = gy < g.gh && gx < g.gw;
  float best = __int_as_float(0x7f800000);
  int best_k = d2;
  for (int k0 = k_begin; k0 < k_end; k0 += kb) {
    const int nk = min(kb, k_end - k0);
    // the batch's offsets in registers; every load of a pixel's batch is
    // issued before its stores
    int off[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      off[q] = q < nk ? s_off[k0 - k_begin + q] : 0;
    // |diff| once per region pixel and displacement
    for (int p = tid; p < npx; p += Threads) {
      const int r = p / span, c = p - r * span;
      const float va = s_a1[p];
      const float* b = s_a2 + (r + R) * hs + (c + R);
      float vb[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) vb[q] = b[off[q]];
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
        if (q < nk)
          s_diff[q * npx + p] = __float2bfloat16_rn(fabsf(va - vb[q]));
    }
    __syncthreads();
    // sums over ws rows at stride patch: one per cell row, region column
    // and displacement, the batch's sums side by side in registers
    for (int j = tid; j < ncol; j += Threads) {
      const int cr = j / span, c = j - cr * span;
      const __nv_bfloat16* d = s_diff + cr * g.patch * span + c;
      float acc[kBatch];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) acc[q] = 0.0f;
      for (int r = 0; r < ws; ++r) {
#pragma unroll
        for (int q = 0; q < kBatch; ++q)
          if (q < nk) acc[q] += __bfloat162float(d[q * npx + r * span]);
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q)
        if (q < nk) s_col[q * ncol + j] = acc[q];
    }
    __syncthreads();
    // sums over ws columns at stride patch, neighbouring gx on neighbouring
    // threads; each slot keeps the first minimum of its displacements (in
    // ascending k). The next batch rewrites s_col only after its barrier.
    for (int q = slot; q < nk; q += kSlots) {
      const float* cs = s_col + q * ncol + ty * span + tx * g.patch;
      float s = 0.0f;
      for (int j = 0; j < ws; ++j) s += cs[j];
      if (in_grid) vol[(size_t)(k0 + q) * ncell + gy * g.gw + gx] = s;
      if (s < best) {
        best = s;
        best_k = k0 + q;
      }
    }
  }
  s_pm[tid] = best;
  s_pk[tid] = best_k;
  __syncthreads();
  if (slot == 0 && in_grid) {
    for (int t = 1; t < kSlots; ++t) {
      const float c = s_pm[t * Tile * Tile + cell_t];
      const int k = s_pk[t * Tile * Tile + cell_t];
      if (c < best || (c == best && k < best_k)) {
        best = c;
        best_k = k;
      }
    }
    part_cost[(size_t)chunk * ncell + gy * g.gw + gx] = best;
    part_k[(size_t)chunk * ncell + gy * g.gw + gx] = best_k;
  }
}

// Launch B. Shared memory: flow (2 x nr int2) and dist (2 x nr float),
// double-buffered over the passes, the prediction (nr int2) and flat_to_k
// ((2R+1)^2 int); nr = (tile + 2 iters)^2 cells.
// flow_in == nullptr: start from the argmin over launch A's nchunk partial
// minima and the rejection; otherwise from flow_in/dist_in.
__global__ void __launch_bounds__(kSelectThreads)
flow_select_kernel(const float* __restrict__ vol,
                   const float* __restrict__ part_cost,
                   const int* __restrict__ part_k, int nchunk,
                   const int* __restrict__ pred, const int* __restrict__ disp,
                   const int* __restrict__ flat_to_k,
                   const int* __restrict__ flow_in,
                   const float* __restrict__ dist_in, int R, int gh, int gw,
                   int h, int patch, int col0, int w_total, int tile,
                   int iters, int* __restrict__ flow_out,
                   float* __restrict__ dist_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  {  // stream blockIdx.z: its volume, minima, prediction, flows and dists
    const size_t nc = (size_t)gh * gw, st = blockIdx.z;
    const size_t d2 = (size_t)(2 * R + 1) * (2 * R + 1);
    vol += st * d2 * nc;
    if (part_cost != nullptr) part_cost += st * nchunk * nc;
    if (part_k != nullptr) part_k += st * nchunk * nc;
    pred += st * 2 * nc;
    if (flow_in != nullptr) flow_in += st * 2 * nc;
    if (dist_in != nullptr) dist_in += st * nc;
    flow_out += st * 2 * nc;
    dist_out += st * nc;
  }
  const int side = tile + 2 * iters, nr = side * side;
  const int dd = 2 * R + 1;
  int2* s_flow = reinterpret_cast<int2*>(smem);
  int2* s_pred = s_flow + 2 * nr;
  float* s_dist = reinterpret_cast<float*>(s_pred + nr);
  int* s_ftk = reinterpret_cast<int*>(s_dist + 2 * nr);
  if ((unsigned)(reinterpret_cast<unsigned char*>(s_ftk + dd * dd) - smem) >
      dynamic_smem_bytes())
    __trap();
  const int tid = threadIdx.x;
  const int gy0 = blockIdx.y * tile - iters, gx0 = blockIdx.x * tile - iters;
  const int ncell = gh * gw;

  for (int i = tid; i < dd * dd; i += kSelectThreads) s_ftk[i] = flat_to_k[i];
  for (int r = tid; r < nr; r += kSelectThreads) {
    const int gy = gy0 + r / side, gx = gx0 + r % side;
    if (gy < 0 || gy >= gh || gx < 0 || gx >= gw) continue;
    const int cell = gy * gw + gx;
    const int p0 = pred[2 * cell], p1 = pred[2 * cell + 1];
    s_pred[r] = make_int2(p0, p1);
    if (flow_in != nullptr) {
      s_flow[r] = make_int2(flow_in[2 * cell], flow_in[2 * cell + 1]);
      s_dist[r] = dist_in[cell];
      continue;
    }
    // the chunks' first minima, combined as (cost, k) in lexicographic
    // order: the first minimum of the whole table
    float bv = part_cost[cell];
    int bk = part_k[cell];
    for (int c = 1; c < nchunk; ++c) {
      const float v = part_cost[(size_t)c * ncell + cell];
      const int k = part_k[(size_t)c * ncell + cell];
      if (v < bv || (v == bv && k < bk)) {
        bv = v;
        bk = k;
      }
    }
    const int f0 = p0 + disp[2 * bk], f1 = p1 + disp[2 * bk + 1];
    const int tr = gy * patch + patch / 2 + f0;
    const int tc = col0 + gx * patch + patch / 2 + f1;
    const bool in_dom =
        tr >= 0 && tr <= h - 1 && tc >= 0 && tc <= w_total - 1;
    s_flow[r] = in_dom ? make_int2(f0, f1) : make_int2(p0, p1);
    s_dist[r] = in_dom ? bv : kInf;
  }
  __syncthreads();

  const int c8r[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
  const int c8c[8] = {-1, 0, 1, -1, 1, -1, 0, 1};
  for (int p = 1; p <= iters; ++p) {
    const int2* f_src = s_flow + ((p - 1) & 1) * nr;
    const float* d_src = s_dist + ((p - 1) & 1) * nr;
    int2* f_dst = s_flow + (p & 1) * nr;
    float* d_dst = s_dist + (p & 1) * nr;
    const int n = side - 2 * p;  // pass p is exact p cells in from the edge
    for (int i = tid; i < n * n; i += kSelectThreads) {
      const int ry = p + i / n, rx = p + i % n;
      const int gy = gy0 + ry, gx = gx0 + rx;
      if (gy < 0 || gy >= gh || gx < 0 || gx >= gw) continue;
      const int r = ry * side + rx, cell = gy * gw + gx;
      const int2 f = f_src[r];
      const int p0 = s_pred[r].x, p1 = s_pred[r].y;
      // every neighbour's cost is fetched before the ordered decisions
      int2 nf[8];
      float cand[8];
      bool ok[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int ny = gy + c8r[q], nx = gx + c8c[q];
        ok[q] = ny >= 0 && ny < gh && nx >= 0 && nx < gw;
        nf[q] = f_src[ok[q] ? r + c8r[q] * side + c8c[q] : r];
        const int q0 = nf[q].x - p0, q1 = nf[q].y - p1;
        const int e0 = f.x - nf[q].x, e1 = f.y - nf[q].y;
        ok[q] = ok[q] && e0 * e0 + e1 * e1 > 4;
        cand[q] = ok[q] && q0 >= -R && q0 <= R && q1 >= -R && q1 <= R
                      ? vol[(size_t)s_ftk[(q0 + R) * dd + (q1 + R)] * ncell +
                            cell]
                      : kInf;
      }
      int2 best = f;
      float bd = d_src[r];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (ok[q] && cand[q] < bd) {
          best = nf[q];
          bd = cand[q];
        }
      }
      f_dst[r] = best;
      d_dst[r] = bd;
    }
    __syncthreads();
  }

  const int2* f_fin = s_flow + (iters & 1) * nr;
  const float* d_fin = s_dist + (iters & 1) * nr;
  for (int i = tid; i < tile * tile; i += kSelectThreads) {
    const int ry = iters + i / tile, rx = iters + i % tile;
    const int gy = gy0 + ry, gx = gx0 + rx;
    if (gy >= gh || gx >= gw) continue;
    const int r = ry * side + rx, cell = gy * gw + gx;
    flow_out[2 * cell] = f_fin[r].x;
    flow_out[2 * cell + 1] = f_fin[r].y;
    dist_out[cell] = d_fin[r];
  }
}

// Opts a kernel into more than 48 KB of dynamic shared memory, once per
// device and size (so a launch under graph capture sets nothing).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int* granted) {
  if (bytes <= kSmemDefault) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (granted[dev] >= bytes) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) granted[dev] = bytes;
  return e;
}

int g_select_smem[kMaxDevices];

// Launch A at one of its (Tile, Threads) instantiations.
template <int Tile, int Threads>
cudaError_t launch_volume(const float* a1, const float* a2, const int* pred,
                          const int* disp, int d2, const LevelGeom& g, int ws,
                          int r0, int R, int kc, int kb, int smem_bytes,
                          int n_streams, float* vol, float* part_cost,
                          int* part_k, cudaStream_t stream) {
  static int granted[kMaxDevices];
  auto kernel = flow_volume_kernel<Tile, Threads>;
  cudaError_t e = allow_smem(kernel, smem_bytes, granted);
  if (e != cudaSuccess) return e;
  const int nchunk = (d2 + kc - 1) / kc;
  dim3 grid((g.gw + Tile - 1) / Tile, (g.gh + Tile - 1) / Tile,
            nchunk * n_streams);
  kernel<<<grid, Threads, smem_bytes, stream>>>(
      a1, a2, pred, disp, d2, g, ws, r0, R, kc, kb, nchunk, vol, part_cost,
      part_k);
  return cudaGetLastError();
}

}  // namespace

// Launch A on S levels (every operand but disp with a leading S). a1, a2:
// hb x wb float32 level buffers with border b around an h x w domain;
// pred: gh x gw x 2 int32; disp: d2 x 2 int32 displacement table; vol:
// d2 x gh x gw float32; part_cost, part_k: nchunk x gh x gw float32 /
// int32, nchunk = ceil(d2 / kc). Tiles of `tile` cells a side
// with `threads` threads a block (8 and 256, or 4 and 128), kc
// displacements per block, kb per shared-memory batch, smem_bytes of
// dynamic shared memory (flow.py:_k1_plan).
extern "C" int vpp_flow_volume(const float* a1, const float* a2,
                               const int* pred, const int* disp, int d2,
                               int hb, int wb, int b, int h, int w, int ws,
                               int patch, int gh, int gw, int R,
                               int pred_bound, int tile, int threads, int kc,
                               int kb, int smem_bytes, int n_streams,
                               float* vol, float* part_cost, int* part_k,
                               void* stream) {
  if (gh <= 0 || gw <= 0) return 0;
  if (d2 != (2 * R + 1) * (2 * R + 1) || d2 > kMaxD2 || kc <= 0 || kb <= 0 ||
      kb > kc || kb > kBatch || patch <= 0 || ws <= 0 || h >= (1 << 16) ||
      w >= (1 << 16) || (long long)hb * wb >= (1LL << 31) || smem_bytes <= 0 ||
      smem_bytes > kSmemMax || n_streams < 1 ||
      (long long)n_streams * ((d2 + kc - 1) / kc) > 65535)
    return (int)cudaErrorInvalidValue;
  LevelGeom g;
  g.hb = hb;
  g.wb = wb;
  g.b = b;
  g.h = h;
  g.w = w;
  g.patch = patch;
  g.gh = gh;
  g.gw = gw;
  g.ph = h < gh * patch ? h : gh * patch;
  g.pw = w < gw * patch ? w : gw * patch;
  g.pred_bound = pred_bound;
  g.inv_patch = 1.0f / (float)patch;
  const int r0 = b - (ws / 2 - patch / 2);
  const cudaStream_t st = (cudaStream_t)stream;
  if (tile == 8 && threads == 256)
    return (int)launch_volume<8, 256>(a1, a2, pred, disp, d2, g, ws, r0, R,
                                      kc, kb, smem_bytes, n_streams, vol,
                                      part_cost, part_k, st);
  if (tile == 4 && threads == 128)
    return (int)launch_volume<4, 128>(a1, a2, pred, disp, d2, g, ws, r0, R,
                                      kc, kb, smem_bytes, n_streams, vol,
                                      part_cost, part_k, st);
  return (int)cudaErrorInvalidValue;
}

// Launch B on S levels (every operand but disp and flat_to_k with a
// leading S). vol: d2 x gh x gw float32 and part_cost, part_k: nchunk x gh
// x gw (launch A's); pred, flow_in, flow_out: gh x gw x 2 int32; dist_in,
// dist_out: gh x gw float32; flat_to_k: (2R+1)^2 int32, row-major
// displacement id -> volume index. flow_in == dist_in == NULL starts from
// the argmin and the rejection (h, patch: the level's rows and the cell
// size; col0, w_total: the level's first column and the width of the
// whole level, whose columns the rejection tests: 0 and the level's width
// w, or a column slice's origin and the wide level's width); otherwise
// from the given flow, and part_* are not read. Tiles of
// `tile` cells a side, iters passes, smem_bytes of dynamic shared memory
// (flow.py:_k1_plan).
extern "C" int vpp_flow_select(const float* vol, const float* part_cost,
                               const int* part_k, int nchunk, const int* pred,
                               const int* disp, const int* flat_to_k,
                               const int* flow_in, const float* dist_in,
                               int d2, int R, int gh, int gw, int h,
                               int patch, int col0, int w_total, int tile,
                               int iters, int smem_bytes, int n_streams,
                               int* flow_out, float* dist_out, void* stream) {
  if (gh <= 0 || gw <= 0) return 0;
  const bool given = flow_in != nullptr;
  if (d2 != (2 * R + 1) * (2 * R + 1) || d2 > kMaxD2 || tile <= 0 ||
      iters < 0 || given != (dist_in != nullptr) ||
      (!given && (part_cost == nullptr || part_k == nullptr || nchunk < 1)) ||
      smem_bytes <= 0 || smem_bytes > kSmemMax || n_streams < 1 ||
      n_streams > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem(flow_select_kernel, smem_bytes, g_select_smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((gw + tile - 1) / tile, (gh + tile - 1) / tile, n_streams);
  flow_select_kernel<<<grid, kSelectThreads, smem_bytes,
                       (cudaStream_t)stream>>>(
      vol, part_cost, part_k, nchunk, pred, disp, flat_to_k, flow_in, dist_in,
      R, gh, gw, h, patch, col0, w_total, tile, iters, flow_out, dist_out);
  return (int)cudaGetLastError();
}

// BatchNorm training moments for Hopper (sm_90a): per-channel column sums of
// a channels-last (R, C) activation, fp32 accumulation, bf16 or fp32 input.
//
// Replaces the two Pallas kernels of litemkd_tpu/ops/pallas_bn.py:
//   bn_sums      ← `_sums_pallas`      (R, C) x        → (2, C) [Σx, Σx²]
//   bn_bwd_sums  ← `_bwd_sums_pallas`  (R, C) dy and x, per-channel μ and σ⁻¹
//                                      → (2, C) [Σdy, Σdy·x̂], x̂ = (x − μ)·σ⁻¹
//
// What bounds them. Each element is read once and costs two or four flops,
// so both are bound by the bytes they read: at the stem of the flagship
// trunk (R = 20,070,400 rows of 64 bf16 channels, 2.57 GB) the forward sum
// cannot beat 0.77 ms at 3.35 TB/s and the backward sum, which reads dy and
// x, 1.53 ms. The design keeps every byte of HBM traffic useful and enough
// loads in flight to cover its latency:
// - neighbouring threads hold neighbouring channels, so a warp reads whole
//   rows; with C a multiple of 8 (bf16) or 4 (fp32) each thread loads one
//   16-byte word of 8 or 4 channels, else one element (ragged C, such as
//   100, takes this narrower path instead of being refused);
// - a block of 256 threads covers 256 words of a row group, several rows a
//   pass when C is narrow (C = 64 bf16: 8 words a row, 32 rows a pass); the
//   rows are split over up to 1024 blocks (about eight per SM on 132 SMs)
//   and each thread keeps four rows' loads in flight;
// - the TPU kernel carried its sum across a sequential grid in VMEM. Blocks
//   here run in parallel and in no order, so each block writes its fp32
//   partial sums to a workspace and a second pass adds the partials in a
//   fixed order. There are no float atomics: every result is bitwise the
//   same from run to run. The block count depends only on (R, C) and the
//   load width, never on the card.
// Ragged tails need no mask: a thread reads only rows below R. The wrapper
// (litemkd_torch/ops/batch_norm.py) allocates the workspace and the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;         // row blocks × channel blocks
constexpr int kMinRowsPerThread = 16;    // below this, fewer row blocks
constexpr int kUnroll = 4;               // rows in flight per thread
constexpr int kFinalCols = 32;           // second pass: columns per block
constexpr int kFinalRows = 8;            // second pass: partials split 8 ways

struct Geo {
  long long R;
  int C;
  int nvec;             // load words per row: C / V
  int cw;               // words per block along the row: min(nvec, kThreads)
  int rpp;              // rows per pass of a block: kThreads / cw
  int gy;               // blocks along the channels
  int gx;               // blocks along the rows
  long long rows_per_block;
};

Geo geometry(long long R, int C, int V) {
  Geo g;
  g.R = R;
  g.C = C;
  g.nvec = C / V;
  g.cw = g.nvec < kThreads ? g.nvec : kThreads;
  g.rpp = kThreads / g.cw;
  g.gy = (g.nvec + g.cw - 1) / g.cw;
  long long gx_max = kMaxBlocks / g.gy;
  if (gx_max < 1) gx_max = 1;
  const long long per_pass = (long long)g.rpp * kMinRowsPerThread;
  long long gx = (R + per_pass - 1) / per_pass;
  if (gx > gx_max) gx = gx_max;
  if (gx < 1) gx = 1;
  long long rows = (R + gx - 1) / gx;
  rows = (rows + g.rpp - 1) / g.rpp * g.rpp;
  g.rows_per_block = rows;
  g.gx = (int)((R + rows - 1) / rows);
  return g;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// V consecutive elements as floats: one 16-byte streaming load, or one element.
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = to_float(p[0]);
  } else {
    static_assert(V * sizeof(T) == 16, "vector loads are 16 bytes");
    const uint4 raw = __ldcs(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = to_float(e[i]);
  }
}

// One block: rows [blockIdx.x·rows_per_block, +rows_per_block) of the
// channel words [blockIdx.y·cw, +cw). Writes part[blockIdx.x][k][c] for
// k = 0, 1 (the two sums). kBwd: the inputs are dy (a) and x (b), with
// per-channel mean and inv; otherwise x (a) alone.
template <typename T, int V, bool kBwd>
__global__ void __launch_bounds__(kThreads)
moments_kernel(const T* __restrict__ a, const T* __restrict__ b,
               const float* __restrict__ mean, const float* __restrict__ inv,
               Geo g, float* __restrict__ part) {
  __shared__ float red[2][kThreads * V];
  const int tid = threadIdx.x;
  const int lane = tid % g.cw;
  const int slot = tid / g.cw;
  const int word = blockIdx.y * g.cw + lane;
  float s0[V], s1[V], mu[V], iv[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s0[i] = 0.f;
    s1[i] = 0.f;
    mu[i] = 0.f;
    iv[i] = 0.f;
  }
  if (slot < g.rpp && word < g.nvec) {
    if constexpr (kBwd) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        mu[i] = mean[word * V + i];
        iv[i] = inv[word * V + i];
      }
    }
    const long long r0 = (long long)blockIdx.x * g.rows_per_block;
    const long long r1 =
        r0 + g.rows_per_block < g.R ? r0 + g.rows_per_block : g.R;
    const long long step = g.rpp;
    const size_t col = (size_t)word * V;
    long long r = r0 + slot;
    for (; r + (kUnroll - 1) * step < r1; r += kUnroll * step) {
      float va[kUnroll][V];
      float vb[kUnroll][V];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const size_t off = (size_t)(r + u * step) * g.C + col;
        load_vec<T, V>(a + off, va[u]);
        if constexpr (kBwd) load_vec<T, V>(b + off, vb[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          if constexpr (kBwd) {
            const float xh = (vb[u][i] - mu[i]) * iv[i];
            s0[i] += va[u][i];
            s1[i] += va[u][i] * xh;
          } else {
            s0[i] += va[u][i];
            s1[i] += va[u][i] * va[u][i];
          }
        }
      }
    }
    for (; r < r1; r += step) {
      float va[V];
      float vb[V];
      const size_t off = (size_t)r * g.C + col;
      load_vec<T, V>(a + off, va);
      if constexpr (kBwd) load_vec<T, V>(b + off, vb);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if constexpr (kBwd) {
          const float xh = (vb[i] - mu[i]) * iv[i];
          s0[i] += va[i];
          s1[i] += va[i] * xh;
        } else {
          s0[i] += va[i];
          s1[i] += va[i] * va[i];
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    red[0][tid * V + i] = s0[i];
    red[1][tid * V + i] = s1[i];
  }
  __syncthreads();
  // add the row slots of each channel element in slot order
  const int elems = g.cw * V;
  for (int e = tid; e < 2 * elems; e += kThreads) {
    const int k = e / elems;
    const int ce = e % elems;
    const int ln = ce / V;
    const int i = ce % V;
    float t = 0.f;
    for (int sl = 0; sl < g.rpp; ++sl) t += red[k][(sl * g.cw + ln) * V + i];
    const int c = (blockIdx.y * g.cw + ln) * V + i;
    if (c < g.C) part[((size_t)blockIdx.x * 2 + k) * g.C + c] = t;
  }
}

// out[j] = Σ_b part[b][j] over the gx row blocks, j < n = 2·C: each thread
// adds a fixed eighth of the blocks in order, then the eighths are added in
// order, so the result does not depend on scheduling.
__global__ void __launch_bounds__(kFinalCols * kFinalRows)
finalize_kernel(const float* __restrict__ part, int gx, int n,
                float* __restrict__ out) {
  __shared__ float red[kFinalRows][kFinalCols + 1];
  const int j = blockIdx.x * kFinalCols + threadIdx.x;
  float acc = 0.f;
  if (j < n) {
    for (int b = threadIdx.y; b < gx; b += kFinalRows)
      acc += part[(size_t)b * n + j];
  }
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && j < n) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kFinalRows; ++k) t += red[k][threadIdx.x];
    out[j] = t;
  }
}

template <typename T, int V, bool kBwd>
int launch_typed(const void* a, const void* b, const float* mean,
                 const float* inv, long long R, int C, float* ws, float* out,
                 cudaStream_t stream) {
  const Geo g = geometry(R, C, V);
  moments_kernel<T, V, kBwd><<<dim3(g.gx, g.gy), kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), mean, inv, g, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = 2 * C;
  finalize_kernel<<<(n + kFinalCols - 1) / kFinalCols,
                    dim3(kFinalCols, kFinalRows), 0, stream>>>(ws, g.gx, n,
                                                                out);
  return (int)cudaGetLastError();
}

// dtype 0: float32, 1: bfloat16; vec 1, or 16 bytes' worth of elements
template <bool kBwd>
int launch(const void* a, const void* b, const float* mean, const float* inv,
           long long R, int C, int dtype, int vec, float* ws, float* out,
           cudaStream_t stream) {
  if (R < 1 || C < 1) return -1;
  if (dtype == 0) {
    if (vec == 4)
      return launch_typed<float, 4, kBwd>(a, b, mean, inv, R, C, ws, out,
                                          stream);
    if (vec == 1)
      return launch_typed<float, 1, kBwd>(a, b, mean, inv, R, C, ws, out,
                                          stream);
  } else if (dtype == 1) {
    if (vec == 8)
      return launch_typed<__nv_bfloat16, 8, kBwd>(a, b, mean, inv, R, C, ws,
                                                   out, stream);
    if (vec == 1)
      return launch_typed<__nv_bfloat16, 1, kBwd>(a, b, mean, inv, R, C, ws,
                                                   out, stream);
  }
  return -1;
}

}  // namespace

extern "C" {

// Floats of fp32 workspace that bn_sums / bn_bwd_sums need for (R, C) at
// this load width: (row blocks) × 2 × C.
long long bn_moments_workspace_floats(long long R, int C, int vec) {
  if (R < 1 || C < 1 || vec < 1 || C % vec != 0) return -1;
  const Geo g = geometry(R, C, vec);
  return (long long)g.gx * 2 * C;
}

int bn_sums(const void* x, long long R, int C, int dtype, int vec, float* ws,
            float* out, void* stream) {
  return launch<false>(x, nullptr, nullptr, nullptr, R, C, dtype, vec, ws, out,
                       static_cast<cudaStream_t>(stream));
}

int bn_bwd_sums(const void* dy, const void* x, const float* mean,
                const float* inv, long long R, int C, int dtype, int vec,
                float* ws, float* out, void* stream) {
  return launch<true>(dy, x, mean, inv, R, C, dtype, vec, ws, out,
                      static_cast<cudaStream_t>(stream));
}

}  // extern "C"

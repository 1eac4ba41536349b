// Fused TRX cross-attention core for Hopper (sm_90a), fp32 throughout.
//
// Replaces the Pallas kernel `_kernel` of litemkd_tpu/ops/pallas_tct.py
// (launched by `tct_attention_pallas`). For every episode e, query q and
// class w it computes
//
//     scores = q_k[e,q] · class_k[e,w]^T / sqrt(dk)   (U, S·U)
//     attn   = row-softmax(scores)                    joint (shot × tuple) axis
//     proto  = attn · class_v[e,w]                    (U, dk)
//     out[e,q,w] = -Σ_u ‖q_v[e,q,u] - proto[u]‖² / U
//
// The (U, S·U) attention tile and the (U, dk) prototype tile live in shared
// memory and registers only: neither reaches device memory, which is the
// point of the kernel (the plain version materialises both for every
// (e, q, w)). The TPU kernel's 128-lane output padding and its n_way <= 128
// limit are gone: the output is written unpadded, one float per block.
//
// What bounds it. Per (e, q, w) it does 2·(U·S·U·dk) multiply-adds and reads
// 2·U·dk + 2·S·U·dk floats, most of them shared with other blocks through
// L2; at the flagship shape (U=28, S=5, dk=1152) that is about 19 flop per
// byte of its unique inputs, so without tensor cores (fp32, no TF32) it is
// bound by the fp32 FMA rate, not by the 3.35 TB/s of HBM. The design keeps
// the FMA units fed: shared-memory operands are read as float4 with one
// side broadcast across the warp, and every global load is an asynchronous
// copy (cp.async) issued one slice ahead of the arithmetic that needs it.
//
// Design.
// - One block of 256 threads per (e, q, w) cell. At eval (E=8, Q=5, W=5)
//   that is 200 blocks for 132 SMs, each ~9 M FMAs; a cell per block keeps
//   the per-query distance sum inside one block, so the result is
//   deterministic (no atomics) and needs no second pass.
// - Phase 1 streams dk in slices of 32 through two shared-memory stages:
//   the query's U rows and the class's S·U key rows, stored k-major. Each
//   thread owns up to MAXT 4×4 score tiles and keeps them in registers over
//   the whole dk loop; the score tile is written to shared memory once.
// - Phase 2: one warp per row, max / exp / sum softmax in place.
// - Phase 3 streams the value columns in slices of DC (64, or 32/16 when
//   the rows are many) through two stages; the first slice is in flight
//   during the softmax. The key axis is split between the two halves of
//   the block, so every thread owns one 4×4 prototype tile over half the
//   keys; half 0 adds half 1's partial tile, subtracts the sum from q_v and
//   folds the squared difference into a per-(row, column group) partial,
//   summed in a fixed order at the end.
// - Every edge is masked: U and S·U are padded to multiples of 4 with zeros
//   (cp.async zero-fills what lies outside the tensors), and dk need not be
//   a multiple of anything.
// Shared memory at the flagship shape is ~97 KB, so two blocks share an SM.
// With one block of 8 warps per SM the kernel waits on latency more than on
// any unit, so slices stay narrow enough for two (timings in PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKC = 32;                    // dk depth of one score slice (phase 1)
constexpr size_t kMaxSmem = 232448;        // dynamic shared memory per block on sm_90
constexpr int kMaxTiles = 4 * kThreads;    // phase-1 4×4 tiles: at most 4 per thread
constexpr int kRedFloats = 16 * (kThreads / 2);  // one 4×4 tile per thread of a half

struct Dims {
  int E, Q, W, S, U, dk;
  int SU;    // S·U keys per class
  int Up;    // U rounded up to a multiple of 4
  int SUp;   // S·U rounded up to a multiple of 4
  int DC;    // value columns per phase-3 slice: 64, 32 or 16
  int lgDC;  // log2(DC), so slice indexing shifts instead of dividing
};

inline int round4(int x) { return (x + 3) & ~3; }

// scores + distance partials + half 1's prototype tiles + the larger of the
// two double-buffered stages
size_t smem_floats(int Up, int SUp, int DC) {
  const size_t stage1 = 2 * (size_t)kKC * (Up + SUp);
  const size_t stage3 = 2 * (size_t)SUp * DC;
  return (size_t)SUp * Up + (size_t)Up * (DC / 4) + kRedFloats +
         (stage1 > stage3 ? stage1 : stage3);
}

// The widest value slice (at most 64 columns, so that two blocks share an SM
// at the flagship shape) whose prototype tiles fit one half of the block and
// whose stages fit shared memory; 0 when none does.
int pick_dc(int Up, int SUp) {
  for (int dc = 64; dc >= 16; dc /= 2)
    if ((Up / 4) * (dc / 4) <= kThreads / 2 &&
        smem_floats(Up, SUp, dc) * sizeof(float) <= kMaxSmem)
      return dc;
  return 0;
}

// 4-byte asynchronous global → shared copy; zero-fills when !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {   // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 a, const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// Phase-1 slice k0: rows of A (U × dk) and B (S·U × dk) into k-major stages.
__device__ __forceinline__ void load_scores_slice(float* As, float* Bs, const float* qk_p,
                                                  const float* ck_p, const Dims& d, int k0) {
  for (int i = threadIdx.x; i < kKC * d.Up; i += kThreads) {
    const int r = i / kKC, k = i % kKC;   // neighbouring threads read along k
    const bool ok = r < d.U && k0 + k < d.dk;
    cp_async4(As + k * d.Up + r, ok ? qk_p + (size_t)r * d.dk + k0 + k : qk_p, ok);
  }
  for (int i = threadIdx.x; i < kKC * d.SUp; i += kThreads) {
    const int r = i / kKC, k = i % kKC;
    const bool ok = r < d.SU && k0 + k < d.dk;
    cp_async4(Bs + k * d.SUp + r, ok ? ck_p + (size_t)r * d.dk + k0 + k : ck_p, ok);
  }
}

// Phase-3 slice d0: value columns [d0, d0 + DC) of all S·U keys, row-major.
__device__ __forceinline__ void load_values_slice(float* Vs, const float* cv_p,
                                                  const Dims& d, int d0) {
  for (int i = threadIdx.x; i < d.SUp * d.DC; i += kThreads) {
    const int j = i >> d.lgDC, c = i & (d.DC - 1);
    const bool ok = j < d.SU && d0 + c < d.dk;
    cp_async4(Vs + i, ok ? cv_p + (size_t)j * d.dk + d0 + c : cv_p, ok);
  }
}

template <int MAXT>
__global__ void __launch_bounds__(kThreads)
tct_attention_kernel(const float* __restrict__ qk, const float* __restrict__ qv,
                     const float* __restrict__ ck, const float* __restrict__ cv,
                     float* __restrict__ out, const Dims d, const float sqrt_dk) {
  extern __shared__ __align__(16) float smem[];
  const int Up = d.Up, SUp = d.SUp, G = d.DC / 4;
  float* st = smem;                           // scores, then attention: [SUp][Up]
  float* part = st + (size_t)SUp * Up;        // squared distance per (row, group): [Up][G]
  float4* red = reinterpret_cast<float4*>(part + (size_t)Up * G);  // [4][tiles3] partial protos
  float* work = part + (size_t)Up * G + kRedFloats;  // two stages of phase 1 or 3

  const int cell = blockIdx.x;                // ((e·Q + q)·W + w): w fastest
  const int w = cell % d.W;
  const int eq = cell / d.W;                  // e·Q + q
  const int e = eq / d.Q;
  const int tid = threadIdx.x;

  const float* qk_p = qk + (size_t)eq * d.U * d.dk;
  const float* qv_p = qv + (size_t)eq * d.U * d.dk;
  const float* ck_p = ck + ((size_t)e * d.W + w) * d.SU * d.dk;
  const float* cv_p = cv + ((size_t)e * d.W + w) * d.SU * d.dk;

  for (int i = tid; i < Up * G; i += kThreads) part[i] = 0.f;

  // ---- phase 1: scores[j][u] = Σ_k q_k[u][k] · k[j][k], in registers ----
  const int stage1 = kKC * (Up + SUp);
  const int n_cg = SUp / 4;
  const int tiles = (Up / 4) * n_cg;
  float acc[MAXT][4][4];
#pragma unroll
  for (int tt = 0; tt < MAXT; ++tt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[tt][i][j] = 0.f;

  const int n_k = (d.dk + kKC - 1) / kKC;
  load_scores_slice(work, work + kKC * Up, qk_p, ck_p, d, 0);
  cp_async_commit();
  for (int s = 0; s < n_k; ++s) {
    if (s + 1 < n_k) {
      float* nxt = work + ((s + 1) & 1) * stage1;
      load_scores_slice(nxt, nxt + kKC * Up, qk_p, ck_p, d, (s + 1) * kKC);
    }
    cp_async_commit();                        // possibly empty: keeps the count uniform
    cp_async_wait_one();
    __syncthreads();                          // slice s landed for every thread
    const float* As = work + (s & 1) * stage1;
    const float* Bs = As + kKC * Up;
#pragma unroll
    for (int tt = 0; tt < MAXT; ++tt) {
      const int t = tid + tt * kThreads;
      if (t < tiles) {
        const int rg = t / n_cg, cg = t % n_cg;
#pragma unroll 8
        for (int k = 0; k < kKC; ++k) {
          const float4 a = *reinterpret_cast<const float4*>(As + k * Up + rg * 4);
          const float4 b = *reinterpret_cast<const float4*>(Bs + k * SUp + cg * 4);
          fma4x4(acc[tt], a, b);
        }
      }
    }
    __syncthreads();                          // stage s&1 free for slice s+2
  }

  // the first value slice flies while the scores are stored and softmaxed
  const int stage3 = SUp * d.DC;
  const int n_d = (d.dk + d.DC - 1) / d.DC;
  load_values_slice(work, cv_p, d, 0);
  cp_async_commit();

#pragma unroll
  for (int tt = 0; tt < MAXT; ++tt) {
    const int t = tid + tt * kThreads;
    if (t < tiles) {
      const int rg = t / n_cg, cg = t % n_cg;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[(cg * 4 + j) * Up + rg * 4 + i] = acc[tt][i][j];
    }
  }
  __syncthreads();

  // ---- phase 2: softmax over the S·U keys of each query row ----
  {
    const int warp = tid / 32, lane = tid % 32;
    for (int u = warp; u < d.U; u += kThreads / 32) {
      float m = -INFINITY;
      for (int j = lane; j < d.SU; j += 32) {
        const float sc = st[j * Up + u] / sqrt_dk;
        st[j * Up + u] = sc;
        m = fmaxf(m, sc);
      }
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      float sum = 0.f;
      for (int j = lane; j < d.SU; j += 32) {
        const float p = expf(st[j * Up + u] - m);
        st[j * Up + u] = p;
        sum += p;
      }
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      for (int j = lane; j < d.SU; j += 32) st[j * Up + u] /= sum;
    }
  }

  // ---- phase 3: proto = attn · V per slice of DC columns, fused distance ----
  // The key axis is split between the two halves of the block: each thread
  // owns one 4×4 prototype tile over half the keys. Half 1 leaves its
  // partial tile in `red`; half 0 adds it and folds the squared difference
  // from q_v into `part`.
  const int tiles3 = (Up / 4) * G;            // <= kThreads / 2 (pick_dc)
  const int half = tid / (kThreads / 2), ht = tid % (kThreads / 2);
  const bool has_tile = ht < tiles3;
  const int rg3 = ht >> (d.lgDC - 2), cg3 = ht & (G - 1);
  const int j0 = half ? SUp / 2 : 0, j1 = half ? SUp : SUp / 2;
  for (int s = 0; s < n_d; ++s) {
    if (s + 1 < n_d) load_values_slice(work + ((s + 1) & 1) * stage3, cv_p, d, (s + 1) * d.DC);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();                          // slice s landed; softmax done
    const float* Vs = work + (s & 1) * stage3;
    const int d0 = s * d.DC;
    float qvr[4][4];
    float pacc[4][4] = {};
    if (has_tile) {
      if (half == 0) {                        // issued before the key loop: latency hidden
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int u = rg3 * 4 + i, c = d0 + cg3 * 4 + jj;
            qvr[i][jj] = (u < d.U && c < d.dk) ? qv_p[(size_t)u * d.dk + c] : 0.f;
          }
      }
#pragma unroll 4
      for (int j = j0; j < j1; ++j) {
        const float4 a = *reinterpret_cast<const float4*>(st + j * Up + rg3 * 4);
        const float4 b = *reinterpret_cast<const float4*>(Vs + j * d.DC + cg3 * 4);
        fma4x4(pacc, a, b);
      }
      if (half == 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          red[i * tiles3 + ht] = make_float4(pacc[i][0], pacc[i][1], pacc[i][2], pacc[i][3]);
      }
    }
    __syncthreads();                          // half 1's partial tiles are in `red`
    if (has_tile && half == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = rg3 * 4 + i;
        if (u >= d.U) continue;
        const float4 o = red[i * tiles3 + ht];
        const float other[4] = {o.x, o.y, o.z, o.w};
        float sq = 0.f;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          if (d0 + cg3 * 4 + jj < d.dk) {
            const float diff = qvr[i][jj] - (pacc[i][jj] + other[jj]);
            sq = fmaf(diff, diff, sq);
          }
        }
        part[u * G + cg3] += sq;
      }
    }
    __syncthreads();                          // stage s&1 and `red` free again
  }

  if (tid == 0) {
    float total = 0.f;
    for (int u = 0; u < d.U; ++u) {
      float row = 0.f;
      for (int g = 0; g < G; ++g) row += part[u * G + g];
      total += row;
    }
    out[cell] = -total / (float)d.U;
  }
}

template <int MAXT>
cudaError_t launch(const float* q_k, const float* q_v, const float* class_k,
                   const float* class_v, float* out, const Dims& d, size_t smem,
                   unsigned cells, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tct_attention_kernel<MAXT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  tct_attention_kernel<MAXT><<<cells, kThreads, smem, stream>>>(
      q_k, q_v, class_k, class_v, out, d, sqrtf((float)d.dk));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for S shots of U tuples,
// or 0 when no configuration of the kernel takes that shape.
size_t tct_attention_smem_bytes(int S, int U) {
  const int Up = round4(U), SUp = round4(S * U);
  const int dc = pick_dc(Up, SUp);
  if (dc == 0 || (Up / 4) * (SUp / 4) > kMaxTiles) return 0;
  return smem_floats(Up, SUp, dc) * sizeof(float);
}

// q_k, q_v: (E, Q, U, dk); class_k, class_v: (E, W, S, U, dk); out: (E, Q, W).
// All fp32, contiguous, on the current device. Launches on `stream` and
// returns cudaGetLastError() (0 on success); does not synchronise.
int tct_attention_forward(const float* q_k, const float* q_v, const float* class_k,
                          const float* class_v, float* out, int E, int Q, int W,
                          int S, int U, int dk, void* stream) {
  const int Up = round4(U), SUp = round4(S * U);
  const int dc = pick_dc(Up, SUp);
  const Dims d{E, Q, W, S, U, dk, S * U, Up, SUp, dc, dc == 64 ? 6 : dc == 32 ? 5 : 4};
  const int tiles = (Up / 4) * (SUp / 4);
  if (d.DC == 0 || tiles > kMaxTiles || dk <= 0) return (int)cudaErrorInvalidValue;
  const long long cells = (long long)E * Q * W;
  if (cells == 0) return 0;
  const size_t smem = smem_floats(Up, SUp, d.DC) * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (tiles <= kThreads)
    err = launch<1>(q_k, q_v, class_k, class_v, out, d, smem, (unsigned)cells, s);
  else if (tiles <= 2 * kThreads)
    err = launch<2>(q_k, q_v, class_k, class_v, out, d, smem, (unsigned)cells, s);
  else
    err = launch<4>(q_k, q_v, class_k, class_v, out, d, smem, (unsigned)cells, s);
  return (int)err;
}

}  // extern "C"

// Fused TRX cross-attention core for Hopper (sm_90a), on the tensor cores in
// split TF32 ("3xTF32"), fp32-accurate.
//
// Replaces the Pallas kernel `_kernel` of litemkd_tpu/ops/pallas_tct.py:61
// (launched by `tct_attention_pallas`). For every episode e, query q and
// class w it computes
//
//     scores = q_k[e,q] · class_k[e,w]^T / sqrt(dk)   (U, S·U)
//     attn   = row-softmax(scores)                    joint (shot × tuple) axis
//     proto  = attn · class_v[e,w]                    (U, dk)
//     out[e,q,w] = -Σ_u ‖q_v[e,q,u] - proto[u]‖² / U
//
// The attention tile and the prototypes live in shared memory and registers
// only; neither reaches device memory. The TPU kernel's 128-lane output
// padding and its n_way <= 128 limit are gone.
//
// What bounds it. Both products are fp32 and must stay fp32-accurate (the
// port turns TF32 off everywhere and its reference is fp32). Split TF32 keeps
// that accuracy on the tensor cores: each operand x is hi = tf32(x), rounded
// to nearest, plus lo = x - hi, which the tensor core reads truncated to
// TF32; each product accumulates lo·hi + hi·lo + hi·hi in fp32, three TF32
// products for one fp32 product (the error of one is ~2^-21 of |x|·|y|,
// against ~2^-11 for a single TF32 pass). At the training shape (E=4, Q=25,
// W=5, S=5, U=28, dk=1152) the two products are 9.03 GFLOP, 27.1 GFLOP of
// TF32, 0.055 ms at the H100's 494.7 TFLOP/s dense TF32; the unique inputs
// are 51.6 MB, 0.015 ms at 3.35 TB/s. So the kernel is bound by tensor-core
// operations, about 525 TF32 operations per unique byte. Warp-level mma.sync
// reaches only part of that rate (wgmma is the rest of the way), and the
// splits and operand loads compete with it for issue slots, so the design
// keeps both per product low.
//
// Design.
// - One block of 8 warps per (episode e, group of G consecutive queries,
//   class w). The group's G·U query rows are stacked into M rows, padded with
//   zeros to a multiple of 16; the class's S·U keys are padded to a multiple
//   of 8 and the padded keys get attention weight exactly 0. A class tile is
//   read from L2 once per group instead of once per query. G comes from the
//   wrapper (ops/tct_attention.py `group_size`); a tail group masks the
//   queries it lacks, skips their all-zero row tiles and writes nothing for
//   them.
// - Both products run as mma.sync.m16n8k8 .tf32 (warp level), fed from
//   padded shared memory by plain loads, so any operand layout works (the
//   proto product's B operand, class_v, is MN-major). Within each k-step of
//   8, lane t takes the physical columns 2t and 2t+1 as its two k indices for
//   both operands (a product contracts over k, so any common order of k is
//   the same product): a row-major operand's fragment pair is one 8-byte load.
//   Row strides make every fragment load free of bank conflicts.
// - Phase 1 (scores, M × S·U): dk streams in slices of 32 through two stages.
//   Warps form a WM × WN grid; each owns one 16-row band and TN n8 tiles,
//   whose accumulators stay in registers over the whole dk loop. Shapes whose
//   tiles exceed one such pass take more passes over dk.
// - Phase 2: one warp per row, max / exp / sum softmax in place, in fp32.
// - Phase 3 (proto, M × DC per slice of DC value columns): each 16-row band
//   is split into KS key halves × WN3 column groups of TN3 n8 tiles, so each
//   attention fragment a warp splits serves TN3 tiles; half 1 hands its
//   partial protos to half 0 through shared memory. The epilogue subtracts
//   the proto from q_v, squares and reduces in a fixed order: a thread's own
//   fragments, the quad by shuffles, then per-(row, column group) partials in
//   shared memory; the last step sums each query's U rows. No atomics: two
//   runs are bitwise equal.
// - Within a k-step the products go term by term over all of a warp's tiles,
//   so independent products separate two on the same accumulator.
// - Every copy is cp.async issued one slice ahead of the products that need
//   it: 16 bytes when dk % 4 == 0 and every operand is 16-byte aligned (the
//   wrapper checks), else 4 bytes, in the same kernel. Out-of-range rows and
//   columns are zero-filled by the copy's src-size operand.
// Shared memory, registers and the G sweep at the flagship shape are in
// PERF.md.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 32;                    // dk depth of one score slice (phase 1)
constexpr int kLgKC = 5;                   // log2(kKC)
constexpr int kLd1 = kKC + 8;              // phase-1 stage row stride (≡ 8 mod 32)
constexpr size_t kMaxSmem = 232448;        // dynamic shared memory per block on sm_90
constexpr size_t kTwoBlocks = 115712;      // per block, for two blocks an SM (228 KB)

struct Dims {
  int E, Q, W, S, U, dk;
  int SU;              // S·U keys per class
  int G, NG;           // queries per group, groups per episode
  int Mp, MT;          // G·U rows padded to 16, m16 tiles
  int Np, NT;          // S·U keys padded to 8, n8 tiles
  int ldS;             // score row stride: Np rounded up to 16, + 8
  int WM, WN, tn;      // phase 1: warp grid (WM 16-row bands), n8 tiles a warp (TN)
  int KS, WN3;         // phase 3: key halves and column groups a band
  int tn3, DC, lgDC;   // phase 3: n8 tiles a warp (TN3), columns per slice
  int vec;             // 1: 16-byte copies, 0: 4-byte copies
};

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// phase-3 partial protos of the second key half: one n8 tile of every lane
// of every (band, column group), TN3 tiles each
size_t red_floats(const Dims& d) {
  return d.KS == 2 ? (size_t)(d.WM * d.WN3) * d.tn3 * 32 * 4 : 0;
}

size_t smem_floats(const Dims& d) {
  const size_t stage1 = 2 * (size_t)kLd1 * (d.WM * 16 + d.WN * d.tn * 8);
  const size_t stage3 = 2 * (size_t)d.Np * (d.DC + 4) + red_floats(d);
  return (size_t)d.Mp * d.ldS + (size_t)d.Mp * d.WN3 +
         (stage1 > stage3 ? stage1 : stage3);
}

// Tiling for S shots of U tuples in groups of G queries. Phase 1: WM × WN
// warps, each one 16-row band and TN n8 score tiles (one of kTNs). Phase 3:
// the same WM bands, each split into KS key halves × WN3 column groups of TN3
// n8 proto tiles (1, 2 or 4); a slice is DC = 8·WN3·TN3 value columns. Tile
// counts are compile-time, so the tile loops carry no guards. Prefers one
// phase-1 pass and two blocks an SM, then one pass, then fewer tiles a pass;
// returns false when no tiling fits shared memory.
constexpr int kTNs[] = {2, 5, 9, 18};

bool plan(int S, int U, int G, Dims& d) {
  if (S <= 0 || U <= 0 || G <= 0) return false;
  d.S = S; d.U = U; d.G = G; d.SU = S * U;
  d.Mp = round_up(G * U, 16); d.MT = d.Mp / 16;
  d.Np = round_up(d.SU, 8); d.NT = d.Np / 8;
  d.ldS = round_up(d.Np, 16) + 8;
  d.WM = 1;
  while (d.WM < d.MT && d.WM < kWarps) d.WM *= 2;
  d.WN = kWarps / d.WM;
  d.KS = d.WM <= kWarps / 2 ? 2 : 1;
  d.WN3 = kWarps / (d.WM * d.KS);
  const int tn_full = cdiv(d.NT, d.WN);
  int first = 3;
  while (first > 0 && kTNs[first - 1] >= tn_full) --first;
  for (int pass = 0; pass < 2; ++pass) {
    const size_t budget = pass == 0 ? kTwoBlocks : kMaxSmem;
    for (int i = first; i >= 0; --i) {
      for (int tn3 = 4; tn3 >= 1; tn3 /= 2) {
        const int dc = 8 * d.WN3 * tn3;
        if (dc > 64) continue;
        d.tn = kTNs[i]; d.DC = dc; d.tn3 = tn3;
        d.lgDC = dc == 64 ? 6 : dc == 32 ? 5 : dc == 16 ? 4 : 3;
        if (smem_floats(d) * sizeof(float) <= budget) return true;
      }
      if (pass == 0) break;                   // two blocks only at one pass
    }
  }
  return false;
}

// ---- asynchronous copies ----

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {   // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// rows × (1 << lgw) floats from row-major global rows of dk floats, starting
// at column c0, into shared rows of stride ld. Rows >= valid and columns >= dk
// are zero-filled; `safe` is a valid address for the copies that read nothing.
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          const float* safe, int rows, int valid,
                                          int lgw, int c0, int dk, int vec) {
  if (vec) {                                  // 16 bytes: dk % 4 == 0, aligned
    const int lgc = lgw - 2;
    for (int i = threadIdx.x; i < rows << lgc; i += kThreads) {
      const int r = i >> lgc, c = (i & ((1 << lgc) - 1)) * 4;
      const bool ok = r < valid && c0 + c < dk;
      cp_async16(dst + r * ld + c, ok ? src + (size_t)r * dk + c0 + c : safe, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows << lgw; i += kThreads) {
      const int r = i >> lgw, c = i & ((1 << lgw) - 1);
      const bool ok = r < valid && c0 + c < dk;
      cp_async4(dst + r * ld + c, ok ? src + (size_t)r * dk + c0 + c : safe, ok);
    }
  }
}

// ---- split TF32 on the tensor cores ----

// hi: x rounded to TF32, to nearest with ties away from zero (what
// cvt.rna.tf32.f32 gives for every finite x), in two integer instructions:
// add half of the 13 dropped bits to the bit pattern, then clear them.
// lo: x - hi, exact in fp32; the tensor core reads its top 19 bits.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
__device__ __forceinline__ void split2(float2 x, uint32_t& h0, uint32_t& l0, uint32_t& h1,
                                       uint32_t& l1) {
  split(x.x, h0, l0);
  split(x.y, h1, l1);
}

// c += a · b, one m16n8k8 TF32 product with fp32 accumulation (the asm of
// CUTLASS's SM80_16x8x8_F32TF32TF32F32_TN).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp: acc[j] += A(16 rows, 8·ksteps) · B(8·ksteps, n8 tile j) for all
// TN tiles, in split TF32, small terms first. A is row-major with stride lda
// (even), at the warp's band and first k. B's element (k, n) is at
// B[n·ldb + k] when B_KROWS (k contiguous, as A) and at B[k·ldb + n]
// otherwise, at the warp's first tile and first k. Lane (g, t) takes the
// physical k columns 2t and 2t+1 of each k-step for the fragment's k = t and
// t + 4. The products go term by term over the tiles (every lo·hi, then every
// hi·lo, then every hi·hi); the volatile mma asm keeps that order.
template <int TN, bool B_KROWS>
__device__ __forceinline__ void warp_mma(float (&acc)[TN][4], const float* A, int lda,
                                         const float* B, int ldb, int ksteps) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* a_p = A + g * lda + 2 * t;
  const float* b_p = B_KROWS ? B + g * ldb + 2 * t : B + 2 * t * ldb + g;
#pragma unroll 4
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k = ks * 8;
    uint32_t ah[4], al[4], bh[TN][2], bl[TN][2];
    split2(*reinterpret_cast<const float2*>(a_p + k), ah[0], al[0], ah[2], al[2]);
    split2(*reinterpret_cast<const float2*>(a_p + 8 * lda + k), ah[1], al[1], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      if (B_KROWS) {
        const float2 b = *reinterpret_cast<const float2*>(b_p + j * 8 * ldb + k);
        split2(b, bh[j][0], bl[j][0], bh[j][1], bl[j][1]);
      } else {
        const float* b = b_p + k * ldb + j * 8;
        split(b[0], bh[j][0], bl[j][0]);
        split(b[ldb], bh[j][1], bl[j][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) mma_tf32(acc[j], al, bh[j][0], bh[j][1]);
#pragma unroll
    for (int j = 0; j < TN; ++j) mma_tf32(acc[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
    for (int j = 0; j < TN; ++j) mma_tf32(acc[j], ah, bh[j][0], bh[j][1]);
  }
}

template <int TN, int TN3>
__global__ void __launch_bounds__(kThreads, TN <= 9 ? 2 : 1)
tct_attention_kernel(const float* __restrict__ qk, const float* __restrict__ qv,
                     const float* __restrict__ ck, const float* __restrict__ cv,
                     float* __restrict__ out, const Dims d, const float sqrt_dk) {
  extern __shared__ __align__(16) float smem[];
  float* st = smem;                                 // scores, then attention: [Mp][ldS]
  float* part = st + (size_t)d.Mp * d.ldS;          // squared distance: [Mp][WN3]
  float* work = part + (size_t)d.Mp * d.WN3;        // two stages of phase 1 or 3

  const int w = blockIdx.x % d.W;
  const int eg = blockIdx.x / d.W;                  // e·NG + group
  const int e = eg / d.NG, q0 = (eg % d.NG) * d.G;
  const int nq = min(d.G, d.Q - q0);                // queries in this group
  const int rows = nq * d.U;                        // valid query rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / d.WN, wn = warp % d.WN;

  const size_t q_row0 = ((size_t)e * d.Q + q0) * d.U;
  const float* qk_p = qk + q_row0 * d.dk;
  const float* qv_p = qv + q_row0 * d.dk;
  const float* ck_p = ck + ((size_t)e * d.W + w) * d.SU * d.dk;
  const float* cv_p = cv + ((size_t)e * d.W + w) * d.SU * d.dk;

  for (int i = tid; i < d.Mp * d.WN3; i += kThreads) part[i] = 0.f;

  // ---- phase 1: scores = q_k · class_k^T over dk, in registers ----
  const int rows_a = d.WM * 16, cols_b = d.WN * TN * 8;
  const int stage1 = kLd1 * (rows_a + cols_b);
  const int n_k = (d.dk + kKC - 1) / kKC;
  for (int m0 = 0; m0 < d.Mp; m0 += rows_a) {
    for (int n0 = 0; n0 < d.Np; n0 += cols_b) {
      const int mt = m0 / 16 + wm;                  // this warp's m16 tile
      const int nt0 = n0 / 8 + wn * TN;             // and its first n8 tile
      // m16 tiles wholly past the valid rows (a tail group's) are skipped
      const int ntiles = mt * 16 < rows ? max(0, min(TN, d.NT - nt0)) : 0;
      float acc[TN][4];
#pragma unroll
      for (int j = 0; j < TN; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

      auto issue = [&](int slice) {                 // slice `slice` into its stage
        if (slice < n_k) {
          float* dst = work + (slice & 1) * stage1;
          load_tile(dst, kLd1, qk_p + (size_t)m0 * d.dk, qk, rows_a, rows - m0, kLgKC,
                    slice * kKC, d.dk, d.vec);
          load_tile(dst + kLd1 * rows_a, kLd1, ck_p + (size_t)n0 * d.dk, ck, cols_b,
                    d.SU - n0, kLgKC, slice * kKC, d.dk, d.vec);
        }
        cp_async_commit();                          // possibly empty: keeps the count uniform
      };
      issue(0);
      for (int s = 0; s < n_k; ++s) {
        issue(s + 1);                               // into the stage of slice s - 1
        cp_async_wait_one();
        __syncthreads();                            // slice s landed for every thread
        const float* As = work + (s & 1) * stage1;
        const float* Bs = As + kLd1 * rows_a;
        if (ntiles > 0)                             // tiles past NT read zero-filled rows
          warp_mma<TN, true>(acc, As + wm * 16 * kLd1, kLd1, Bs + wn * TN * 8 * kLd1, kLd1,
                             kKC / 8);
        __syncthreads();                            // stage s&1 free for slice s+2
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        if (j < ntiles) {
          float* p = st + (size_t)(mt * 16 + g) * d.ldS + (nt0 + j) * 8 + 2 * t;
          *reinterpret_cast<float2*>(p) = make_float2(acc[j][0], acc[j][1]);
          *reinterpret_cast<float2*>(p + 8 * d.ldS) = make_float2(acc[j][2], acc[j][3]);
        }
      }
    }
  }

  // the first value slice flies while the softmax runs
  const int ldV = d.DC + 4;                         // ≡ 4 mod 16: rows 2t, 2t+1 conflict-free
  const int stage3 = d.Np * ldV;
  const int n_d = (d.dk + d.DC - 1) / d.DC;
  load_tile(work, ldV, cv_p, cv, d.Np, d.SU, d.lgDC, 0, d.dk, d.vec);
  cp_async_commit();
  __syncthreads();                                  // every score stored

  // ---- phase 2: softmax over the S·U keys of each valid row; padded keys 0 ----
  for (int m = warp; m < rows; m += kWarps) {
    float* r = st + (size_t)m * d.ldS;
    float mx = -INFINITY;
    for (int j = lane; j < d.SU; j += 32) {
      const float sc = r[j] / sqrt_dk;
      r[j] = sc;
      mx = fmaxf(mx, sc);
    }
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int j = lane; j < d.SU; j += 32) {
      const float p = expf(r[j] - mx);
      r[j] = p;
      sum += p;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int j = lane; j < d.SU; j += 32) r[j] /= sum;
    for (int j = d.SU + lane; j < d.Np; j += 32) r[j] = 0.f;
  }

  // ---- phase 3: proto = attn · V per slice of DC columns, fused distance ----
  // Warp (wm3, kh, wn3) multiplies band wm3 over key half kh into column
  // group wn3. With two halves (one row pass then), half 1 leaves its partial
  // protos in `red` and half 0 adds them: a fixed order.
  const int wn3 = warp % d.WN3, kh = warp / d.WN3 % d.KS, wm3 = warp / (d.WN3 * d.KS);
  const int ksteps = d.Np / 8, kh0 = (ksteps + 1) / 2;
  const int k_first = kh ? kh0 : 0, k_count = d.KS == 1 ? ksteps : kh ? ksteps - kh0 : kh0;
  float4* red = reinterpret_cast<float4*>(work + 2 * stage3) +
                (size_t)(wm3 * d.WN3 + wn3) * TN3 * 32 + lane;
  const int nt0 = wn3 * TN3;                        // DC = 8·WN3·TN3: every tile in the slice
  for (int s = 0; s < n_d; ++s) {
    if (s + 1 < n_d)
      load_tile(work + ((s + 1) & 1) * stage3, ldV, cv_p, cv, d.Np, d.SU, d.lgDC,
                (s + 1) * d.DC, d.dk, d.vec);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();                                // slice s landed; softmax done
    const float* Vs = work + (s & 1) * stage3;
    const int d0 = s * d.DC;
    for (int m0 = 0; m0 < d.Mp; m0 += d.WM * 16) {
      const int mt = m0 / 16 + wm3;
      const bool active = mt * 16 < rows;           // never read: rows past a tail group
      const int r0 = mt * 16 + g;
      // q_v for the epilogue, issued before the products; zero outside
      float qvr[TN3][4];
#pragma unroll
      for (int j = 0; j < TN3; ++j) {
        const int c = d0 + (nt0 + j) * 8 + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          const bool ok = active && kh == 0 && r < rows;
          const float* p = qv_p + (size_t)r * d.dk + c;
          qvr[j][2 * h] = ok && c < d.dk ? p[0] : 0.f;
          qvr[j][2 * h + 1] = ok && c + 1 < d.dk ? p[1] : 0.f;
        }
      }
      float acc[TN3][4];
#pragma unroll
      for (int j = 0; j < TN3; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
      if (active)
        warp_mma<TN3, false>(acc, st + (size_t)mt * 16 * d.ldS + k_first * 8, d.ldS,
                             Vs + (size_t)k_first * 8 * ldV + nt0 * 8, ldV, k_count);
      if (d.KS == 2) {                              // one row pass: every warp gets here
        if (active && kh == 1) {
#pragma unroll
          for (int j = 0; j < TN3; ++j)
            red[j * 32] = make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        }
        __syncthreads();                            // half 1's partial protos are in `red`
        if (active && kh == 0) {
#pragma unroll
          for (int j = 0; j < TN3; ++j) {
            const float4 o = red[j * 32];
            acc[j][0] += o.x;
            acc[j][1] += o.y;
            acc[j][2] += o.z;
            acc[j][3] += o.w;
          }
        }
      }
      if (!active || kh != 0) continue;
      // columns >= dk hold 0 in both q_v and proto, so they add exactly 0
      float sq[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < TN3; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float diff = qvr[j][i] - acc[j][i];
          sq[i >> 1] = fmaf(diff, diff, sq[i >> 1]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 1);
        sq[h] += __shfl_xor_sync(0xffffffffu, sq[h], 2);
      }
      if (t == 0) {
        part[r0 * d.WN3 + wn3] += sq[0];
        part[(r0 + 8) * d.WN3 + wn3] += sq[1];
      }
    }
    __syncthreads();                                // stage s&1 and `red` free again
  }

  // ---- each query's U rows, summed in a fixed order ----
  for (int i = tid; i < nq; i += kThreads) {
    float total = 0.f;
    for (int u = 0; u < d.U; ++u) {
      const float* p = part + (size_t)(i * d.U + u) * d.WN3;
      float row = 0.f;
      for (int c = 0; c < d.WN3; ++c) row += p[c];
      total += row;
    }
    out[((size_t)e * d.Q + q0 + i) * d.W + w] = -total / (float)d.U;
  }
}

template <int TN, int TN3>
cudaError_t launch(const float* q_k, const float* q_v, const float* class_k,
                   const float* class_v, float* out, const Dims& d, size_t smem,
                   unsigned blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(tct_attention_kernel<TN, TN3>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  tct_attention_kernel<TN, TN3><<<blocks, kThreads, smem, stream>>>(
      q_k, q_v, class_k, class_v, out, d, sqrtf((float)d.dk));
  return cudaGetLastError();
}

template <int TN>
cudaError_t launch_tn3(const float* q_k, const float* q_v, const float* class_k,
                       const float* class_v, float* out, const Dims& d, size_t smem,
                       unsigned blocks, cudaStream_t stream) {
  switch (d.tn3) {
    case 1: return launch<TN, 1>(q_k, q_v, class_k, class_v, out, d, smem, blocks, stream);
    case 2: return launch<TN, 2>(q_k, q_v, class_k, class_v, out, d, smem, blocks, stream);
    default: return launch<TN, 4>(q_k, q_v, class_k, class_v, out, d, smem, blocks, stream);
  }
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs for S shots of U tuples in
// groups of G queries, or 0 when no tiling of the kernel fits that shape.
size_t tct_attention_smem_bytes(int S, int U, int G) {
  Dims d{};
  if (!plan(S, U, G, d)) return 0;
  return smem_floats(d) * sizeof(float);
}

// q_k, q_v: (E, Q, U, dk); class_k, class_v: (E, W, S, U, dk); out: (E, Q, W).
// All fp32, contiguous, on the current device; G queries per block; vec16 != 0
// asks for 16-byte copies, which need dk % 4 == 0 and 16-byte aligned
// operands. Launches on `stream` and returns cudaGetLastError() (0 on
// success); does not synchronise.
int tct_attention_forward(const float* q_k, const float* q_v, const float* class_k,
                          const float* class_v, float* out, int E, int Q, int W,
                          int S, int U, int dk, int G, int vec16, void* stream) {
  Dims d{};
  if (dk <= 0 || !plan(S, U, G, d)) return (int)cudaErrorInvalidValue;
  if (vec16 && dk % 4 != 0) return (int)cudaErrorInvalidValue;
  d.E = E; d.Q = Q; d.W = W; d.dk = dk;
  d.NG = cdiv(Q, G);
  d.vec = vec16 ? 1 : 0;
  const long long blocks = (long long)E * d.NG * W;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(d) * sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned b = (unsigned)blocks;
  cudaError_t err;
  switch (d.tn) {
    case 2: err = launch_tn3<2>(q_k, q_v, class_k, class_v, out, d, smem, b, s); break;
    case 5: err = launch_tn3<5>(q_k, q_v, class_k, class_v, out, d, smem, b, s); break;
    case 9: err = launch_tn3<9>(q_k, q_v, class_k, class_v, out, d, smem, b, s); break;
    default: err = launch_tn3<18>(q_k, q_v, class_k, class_v, out, d, smem, b, s);
  }
  return (int)err;
}

}  // extern "C"

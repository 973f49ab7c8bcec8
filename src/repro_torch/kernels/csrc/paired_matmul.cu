// Paired subtractor GEMM with a fused epilogue, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel built by
// src/repro/kernels/paired_matmul.py::_build_paired_call (reached from
// paired_matmul_pallas, paired_matmul_blocked_pallas and dense_matmul_pallas).
// One kernel, in two forms, covers every shape the JAX package launches:
//
//   y = (x[:, :P] - x[:, P:2P]) @ Kmat + x[:, 2P:] @ W_res        (fp32 accumulate)
//   y = act(y + bias) -> optional 2x2 max/avg over a window-major (4, M, K)
//       operand -> optional fp32 residual add -> one cast, one store.
//
// The operand is the one permuted (..., M, K) buffer, K = 2P + R, read at
// column offsets 0, P and 2P.  "Effective lane" e < P + R is the pair
// x[e] - x[P+e] (e < P) or the residual x[P+e] (e >= P).  P == 0 is the dense
// GEMM, R == 0 drops the residual segment, and P + R == 0 runs no contraction
// step: the epilogue alone, on zero accumulators.  The column-blocked form
// gives each of B column blocks its own [I | J | resid] lanes: x is
// (B, [4,] M, K'), Kmat (B, P, bn), W_res (B, R, bn); the structured form is
// B == 1, bn == N.  Padded lanes of the blocked layout carry zero weights.
// The subtract rounds at input precision (a bf16 difference is rounded to
// bf16 before the multiply); the epilogue keeps the reference order bias ->
// activation -> pool -> residual and casts once; gelu is the tanh form.
//
// What bounds it on this card.  Both regimes sit far below the H100's ridge
// (about 295 FLOP per byte in bf16): LeNet's conv GEMMs do about 2 FLOP per
// byte of activation, a decode GEMM at M = 4 about 4 FLOP per weight byte.
// So the kernel is bound by bytes in flight, by filling 132 SMs and by the
// latency of each step, not by arithmetic: fp32 FMA on the CUDA cores (tensor
// cores buy nothing at these shapes, and TF32 would break the 1e-5 parity
// gate at rounding 0).  The host picks a plan per call (kernels/tuning.py:
// form, tile, columns per thread, K-split, lanes, ring depth) and the entry
// point checks it and lays out the shared memory it implies (skinny_layout,
// tall_layout; paired_matmul_smem reports the bytes).
//
// * skinny (decode and prefill rows, M <= 64, no pool).  The weights are the
//   bytes: 1-20 rows of x against 1.5-15 MB of Kmat/W_res.  A CTA of 128
//   threads owns `cols` columns of one block and one contiguous slice of the
//   effective lanes; each thread holds TN adjacent columns for MR rows (more
//   rows run in passes).  The slice of x is copied with cp.async ahead of
//   the weights and subtracted once into shared memory.  Each thread streams
//   its own weight rows as 8- or 16-byte vectors through a 5-stage cp.async
//   ring that only it reads, so no barrier paces the loads.  The slices of
//   one column tile are the CTAs of one thread-block cluster (up to 8, so
//   that a launch puts two CTAs on every SM: wk/wv at N = 256 split K, not
//   only N).  Row groups are reduced by warp shuffles and one shared-memory
//   pass; each rank stores its partial sums into the leader's shared memory
//   (distributed shared memory, once a first cluster barrier, passed while
//   the first copies fly, has shown every rank started), and after one
//   more cluster barrier the leader adds them in rank order and runs the
//   epilogue.  One launch, no workspace, no atomics, the same bits on every
//   launch.
// * tall (LeNet: 1 000-196 000 rows, K' = 25-462, bn = 1-120; pooled or
//   not).  The activations are the bytes.  A CTA owns TN columns of one
//   block and walks sub-tiles of `rows` pooled rows.  A sub-tile's whole
//   rows are, per window, one contiguous span of x, so it is copied as
//   16-byte cp.async units from the aligned address below it (no per-element
//   index arithmetic, any row length) through a ring of up to 3 stages.  The
//   slice's weights are staged once, as fp32.  `lanes` threads share a
//   window-row and split its lanes (as many as keep the rows a warp reads on
//   different banks); each thread holds RM window-rows x TN columns, so a
//   weight it loads feeds RM * TN multiply-adds; the lane groups meet by
//   shuffles, and the 2x2 pool is a shuffle across the window lanes.  Where
//   the grid would leave SMs idle, K is split over a cluster as above.
//
// Left for later: gathering the blocked activations in the kernel through the
// (B, K') index matrix (the B-fold copy of x is most of LeNet's bytes), a
// tile cache tuned per shape, tensor-core bf16 tiles for large M, and the
// dense (P = 0) tall shapes, where cuBLAS's register tiling still wins.
//
// C interface (bound with ctypes): paired_matmul_launch returns
// cudaGetLastError() after the launch, 0 on success, and cudaErrorInvalidValue
// for a shape or plan out of range (nothing is launched then).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;  // both forms
constexpr int kSkinnyStages = 5, kSkinnyUnroll = 4;
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 232448;  // 227 KB, the opt-in dynamic shared memory

enum Act { kNone = 0, kRelu = 1, kGelu = 2, kSilu = 3, kTanh = 4 };
enum Pool { kNoPool = 0, kMax2 = 1, kAvg2 = 2 };

struct Args {
  const void* x;
  const void* kmat;
  const void* wres;
  const float* bias;     // (n_cols,) fp32 or null
  const void* residual;  // (M, n_cols) or null
  void* out;             // (M, n_cols)
  int64_t M;
  int P, R, bn, n_cols;
  int pool, act, res_bf16;
};

// tuning.Plan: skinny rows = MR, cols = columns per CTA; tall rows = pooled
// rows per sub-tile, cols = tn, lanes = lane groups per window-row.  The
// dynamic shared memory follows from it (skinny_layout, tall_layout).
struct Plan {
  int rows, cols, tn, splits, lanes, subtiles, stages;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The subtractor works at input precision: round the difference to T.
template <typename T>
__device__ __forceinline__ float sub_at_input_precision(float a, float b) {
  return to_f(from_f<T>(a - b));
}

__device__ __forceinline__ float activation(float v, int act) {
  switch (act) {
    case kRelu:
      return v > 0.f ? v : 0.f;
    case kGelu: {
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * v * (1.f + tanhf(c * (v + 0.044715f * v * v * v)));
    }
    case kSilu:
      return v / (1.f + expf(-v));
    case kTanh:
      return tanhf(v);
    default:
      return v;
  }
}

// The fp32 (or bf16) residual at flat output index o.
__device__ __forceinline__ float residual_at(const Args& a, int64_t o) {
  return a.res_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.residual)[o])
                    : static_cast<const float*>(a.residual)[o];
}

// bias -> activation -> residual -> one cast (the skinny form's epilogue).
template <typename T>
__device__ __forceinline__ void store_out(const Args& a, int64_t m, int col, float s) {
  float v = activation(s + (a.bias ? a.bias[col] : 0.f), a.act);
  const int64_t o = m * a.n_cols + col;
  if (a.residual) v += residual_at(a, o);
  static_cast<T*>(a.out)[o] = from_f<T>(v);
}

// cp.async of BYTES (4, 8 or 16) into shared memory; `n` < BYTES source bytes
// zero-fill the rest (n == 0: no read at all).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int n) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(BYTES), "r"(n)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A cluster barrier that orders no memory: past it, every CTA of the
// cluster has started, and only then may a CTA touch another's shared memory.
__device__ __forceinline__ void cluster_started() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Lanes per K-slice: ceil(KE / S) (tuning.slice_step).
__host__ __device__ __forceinline__ int slice_step(int ke, int splits) {
  return (ke + splits - 1) / splits;
}

// ---------------------------------------------------------------------------
// skinny form
// ---------------------------------------------------------------------------

// 16-byte units that hold `lanes` elements at any alignment
__host__ __device__ __forceinline__ int skinny_units(int lanes, int itemsize) {
  return (lanes * itemsize + 15) / 16 + 1;
}

// The skinny form's shared memory, byte offsets from 0: the slice of x,
// subtracted ([MR][step] fp32, at 0); the weight ring, which the row-group
// reduction reuses ([4][MR][cols] fp32) after the loop; the gather of every
// rank's partial sums ([S][MR][cols] fp32, used in the leader); x's raw
// segments per row ([MR][u0 + u1] 16-byte units).  tuning._skinny_smem
// models `total` for the planner.
struct SkinnyLayout {
  int64_t ring, gather, raw, total;
};
__host__ __device__ __forceinline__ SkinnyLayout skinny_layout(int mr, int cols, int tn,
                                                               int itemsize, int P, int step,
                                                               int splits) {
  const int64_t ring = int64_t(kSkinnyStages) * kSkinnyUnroll * kThreads * tn * itemsize;
  const int64_t red = int64_t(4) * mr * cols * 4;
  SkinnyLayout l;
  l.ring = int64_t(mr) * step * 4;
  l.gather = l.ring + (ring > red ? ring : red);
  l.raw = l.gather + int64_t(splits) * mr * cols * 4;
  l.total = l.raw + int64_t(mr) * (skinny_units(step < P ? step : P, itemsize) +
                                   skinny_units(step, itemsize)) * 16;
  return l;
}

template <typename T, int MR, int TN>
__global__ void __launch_bounds__(kThreads) paired_matmul_kernel_skinny(Args a, Plan p) {
  constexpr int VB = TN * static_cast<int>(sizeof(T));  // bytes per weight vector
  using Vec = typename std::conditional<VB == 16, uint4, uint2>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, lane = tid % 32;
  const int S = p.splits, CT = p.cols;
  const int tpr = CT / TN;         // threads across one weight row
  const int G = kThreads / tpr;    // row groups: lanes read at once
  const int Q = G < 4 ? G : 4;     // partial sums per column after the shuffles
  const int cgi = tid % tpr, rg = tid / tpr;
  const int tiles_n = (a.bn + CT - 1) / CT;
  const int b = blockIdx.y / tiles_n;
  const int c0 = (blockIdx.y % tiles_n) * CT;
  const int col = c0 + cgi * TN;   // this thread's first column in the block
  const int M = static_cast<int>(a.M);
  const int K = 2 * a.P + a.R, KE = a.P + a.R;
  const int step = slice_step(KE, S);
  const int rank = static_cast<int>(cluster.block_rank());
  const int e_begin = min(KE, rank * step);
  const int len = min(KE, e_begin + step) - e_begin;

  const SkinnyLayout L = skinny_layout(MR, CT, TN, sizeof(T), a.P, step, S);
  float* xs = reinterpret_cast<float*>(smem);  // [MR][step], subtracted
  unsigned char* ring = smem + L.ring;         // [stage][unroll][thread] vectors
  float* red = reinterpret_cast<float*>(ring);  // [Q][MR][CT], after the loop
  // [S][MR][CT]: every rank's partial sums, gathered in the leader's copy
  float* gather = reinterpret_cast<float*>(smem + L.gather);
  // raw x of the slice, per row: [I lanes of the pairs | J lanes and residual
  // lanes], each copied as the 16-byte units around it
  const int u0 = skinny_units(min(step, a.P), sizeof(T)), u1 = skinny_units(step, sizeof(T));
  unsigned char* raw = smem + L.raw;  // [MR][u0+u1][16]
  const int pe = min(e_begin + len, a.P);  // pairs [e_begin, pe)

  const T* x = static_cast<const T*>(a.x) + static_cast<int64_t>(b) * a.M * K;
  const T* km = static_cast<const T*>(a.kmat) + static_cast<int64_t>(b) * a.P * a.bn;
  const T* wr = static_cast<const T*>(a.wres) + static_cast<int64_t>(b) * a.R * a.bn;

  // this thread's weight vectors of stage k: slice lanes (k*U + u)*G + rg
  auto issue = [&](int k) {
    const int slot = k % kSkinnyStages;
#pragma unroll
    for (int u = 0; u < kSkinnyUnroll; ++u) {
      const int j = (k * kSkinnyUnroll + u) * G + rg;
      const int e = e_begin + j;
      const bool ok = j < len && col < a.bn;
      const T* src = km;
      if (ok)
        src = e < a.P ? km + static_cast<int64_t>(e) * a.bn + col
                      : wr + static_cast<int64_t>(e - a.P) * a.bn + col;
      cp_async<VB>(ring + ((slot * kSkinnyUnroll + u) * kThreads + tid) * VB, src, ok ? VB : 0);
    }
    cp_async_commit();
  };
  const int nk = (len + G * kSkinnyUnroll - 1) / (G * kSkinnyUnroll);

  // rows in passes of MR (prefill); decode is one pass
  for (int m0 = 0; m0 < M; m0 += MR) {
    const int rows = min(MR, M - m0);
    // x first (its own cp.async group), then the weight ring behind it
    for (int i = tid; i < rows * (u0 + u1); i += kThreads) {
      const int m = i / (u0 + u1), u = i - m * (u0 + u1);
      const T* row = x + static_cast<int64_t>(m0 + m) * K;
      const bool first = u < u0;
      const int n = first ? max(0, pe - e_begin) : len;
      const uintptr_t ga = reinterpret_cast<uintptr_t>(first ? row + e_begin : row + a.P + e_begin);
      const uintptr_t ua = (ga & ~uintptr_t(15)) + (first ? u : u - u0) * 16;
      const int64_t left = static_cast<int64_t>(ga + n * sizeof(T)) - static_cast<int64_t>(ua);
      if (left > 0)
        cp_async<16>(raw + (m * (u0 + u1) + u) * 16, reinterpret_cast<const void*>(ua),
                     left < 16 ? static_cast<int>(left) : 16);
    }
    cp_async_commit();
#pragma unroll
    for (int k = 0; k < kSkinnyStages - 1; ++k) issue(k);
    // the stores into the leader's shared memory below need the whole
    // cluster started: wait for it while the copies fly (later passes
    // follow the cluster barrier that ends the one before)
    if (S > 1 && m0 == 0) cluster_started();

    // x's slice, subtracted, once the x group has landed (the weight stages
    // stay in flight); rows past the pass are zeros
    cp_async_wait<kSkinnyStages - 1>();
    __syncthreads();
    for (int i = tid; i < MR * len; i += kThreads) {
      const int m = i / len, j = i - m * len;
      float v = 0.f;
      if (m < rows) {
        const unsigned char* rr = raw + m * (u0 + u1) * 16;
        const uintptr_t row = reinterpret_cast<uintptr_t>(x + static_cast<int64_t>(m0 + m) * K);
        const T* ia = reinterpret_cast<const T*>(rr + ((row + e_begin * sizeof(T)) & 15));
        const T* jb = reinterpret_cast<const T*>(rr + u0 * 16 +
                                                 ((row + (a.P + e_begin) * sizeof(T)) & 15));
        v = e_begin + j < a.P ? sub_at_input_precision<T>(to_f(ia[j]), to_f(jb[j])) : to_f(jb[j]);
      }
      xs[m * step + j] = v;
    }
    __syncthreads();

    float acc[MR][TN];
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[m][c] = 0.f;

    for (int k = 0; k < nk; ++k) {
      cp_async_wait<kSkinnyStages - 2>();  // this thread's stage k has landed
      issue(k + kSkinnyStages - 1);        // into the slot it read at k - 1
      const int slot = k % kSkinnyStages;
#pragma unroll
      for (int u = 0; u < kSkinnyUnroll; ++u) {
        const int j = (k * kSkinnyUnroll + u) * G + rg;
        if (j >= len) break;
        const Vec raw = *reinterpret_cast<const Vec*>(
            ring + ((slot * kSkinnyUnroll + u) * kThreads + tid) * VB);
        const T* wv = reinterpret_cast<const T*>(&raw);
        float w[TN];
#pragma unroll
        for (int c = 0; c < TN; ++c) w[c] = to_f(wv[c]);
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          const float xv = xs[m * step + j];
#pragma unroll
          for (int c = 0; c < TN; ++c) acc[m][c] = fmaf(xv, w[c], acc[m][c]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();

    // row groups -> the CTA's partial sum: the row groups inside a warp by
    // shuffles, then at most four partials in order (warps, or row groups)
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int c = 0; c < TN; ++c)
        for (int off = tpr; off < 32; off <<= 1)
          acc[m][c] += __shfl_xor_sync(0xffffffffu, acc[m][c], off);
    const int q = tpr < 32 ? tid / 32 : rg;
    if (tpr >= 32 || lane < tpr) {
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int c = 0; c < TN; ++c) red[(q * MR + m) * CT + cgi * TN + c] = acc[m][c];
    }
    __syncthreads();
    // each rank stores its partial sums into the leader's shared memory
    float* dst = (S > 1 ? cluster.map_shared_rank(gather, 0) : gather) + rank * MR * CT;
    for (int i = tid; i < MR * CT; i += kThreads) {
      float s = red[i];
      for (int qq = 1; qq < Q; ++qq) s += red[qq * MR * CT + i];
      dst[i] = s;
    }
    if (S > 1) cluster.sync(); else __syncthreads();

    if (rank == 0) {  // the leader adds the ranks in order and finishes
      for (int i = tid; i < rows * CT; i += kThreads) {
        const int m = i / CT, c = c0 + i % CT;
        const int colg = b * a.bn + c;
        if (c >= a.bn || colg >= a.n_cols) continue;
        float s = gather[i];
        for (int r = 1; r < S; ++r) s += gather[r * MR * CT + i];
        store_out<T>(a, m0 + m, colg, s);
      }
    }
    if (m0 + MR < M) {  // the next pass reuses the ring and the leader's gather
      if (S > 1) cluster.sync(); else __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// tall form
// ---------------------------------------------------------------------------

// TN weights from shared memory (16-byte reads where TN allows)
template <int TN>
__device__ __forceinline__ void load_row(float (&wv)[TN], const float* w) {
  if constexpr (TN % 4 == 0) {
#pragma unroll
    for (int c = 0; c < TN; c += 4) {
      const float4 q = *reinterpret_cast<const float4*>(w + c);
      wv[c] = q.x;
      wv[c + 1] = q.y;
      wv[c + 2] = q.z;
      wv[c + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < TN; ++c) wv[c] = w[c];
  }
}

// Window-rows a tall thread holds at once (tuning.tall_rows_per_thread): each
// weight it loads feeds RM * TN multiply-adds.
__host__ __device__ constexpr int tall_rows_per_thread(int tn) {
  return tn == 1 ? 1 : 2;
}

// The tall form's shared memory, byte offsets from 0: the slice's weights
// ([step][TN] fp32, at 0); the ring (`stages` slots of W blocks, one a
// window: its `rows` whole rows of K elements are contiguous in x, copied as
// the 16-byte units around them); the partial sums of a K split ([W * rows][TN]
// fp32).  tuning._tall_smem models `total` for the planner.
struct TallLayout {
  int64_t block, ring, part, total;
};
__host__ __device__ __forceinline__ TallLayout tall_layout(int window, int rows, int K,
                                                           int itemsize, int tn, int step,
                                                           int splits, int stages) {
  TallLayout l;
  l.block = (int64_t(rows) * K * itemsize + 15) / 16 * 16 + 16;
  l.ring = (int64_t(step) * tn * 4 + 15) / 16 * 16;
  l.part = l.ring + int64_t(stages) * window * l.block;
  l.total = l.part + (splits > 1 ? int64_t(window) * rows * tn * 4 : 0);
  return l;
}

// First byte of window w's rows from ms in x (b's block, (W, M, K)).
template <typename T>
__device__ __forceinline__ uintptr_t tall_rows(const T* x, int64_t M, int K, int w, int64_t ms) {
  return reinterpret_cast<uintptr_t>(x + (static_cast<int64_t>(w) * M + ms) * K);
}

// A sub-tile into its slot: each window's rows from ms (at most RS of them)
// are one contiguous span of x, copied as 16-byte units from the aligned
// address below it; the last unit copies only the span's own bytes.
template <typename T, int W>
__device__ __forceinline__ void tall_issue(unsigned char* st, const T* x, int64_t M, int K,
                                           int64_t ms, int RS, int block) {
  const int64_t nbytes = min(static_cast<int64_t>(RS), M - ms) * K * static_cast<int>(sizeof(T));
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const uintptr_t ga = tall_rows(x, M, K, w, ms), ua = ga & ~uintptr_t(15);
    const int units = static_cast<int>((ga - ua + nbytes + 15) / 16);
    for (int u = threadIdx.x; u < units; u += kThreads) {
      const int64_t left = static_cast<int64_t>(ga + nbytes) - static_cast<int64_t>(ua + u * 16);
      cp_async<16>(st + w * block + u * 16, reinterpret_cast<const void*>(ua + u * 16),
                   left < 16 ? static_cast<int>(left) : 16);
    }
  }
}

// The tall form's epilogue for one window-row's TN sums (in every lane of
// its group): bias -> activation -> pool over the window lanes (the W
// window-rows of a row sit LG lanes apart) -> residual -> one cast; lane g
// stores the columns c = g mod LG of the group starting at block column cg.
template <typename T, int W, int TN>
__device__ __forceinline__ void tall_finish(const Args& a, const float (&acc)[TN], int64_t m,
                                            int w, int b, int cg, int g, int LG) {
  float v[TN];
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    const int cb = cg + c, colg = b * a.bn + cb;
    const float bias = a.bias && cb < a.bn && colg < a.n_cols ? a.bias[colg] : 0.f;
    v[c] = activation(acc[c] + bias, a.act);
    if constexpr (W == 4) {
      for (int off = LG; off < 4 * LG; off <<= 1) {
        const float u = __shfl_xor_sync(0xffffffffu, v[c], off);
        v[c] = a.pool == kMax2 ? fmaxf(v[c], u) : v[c] + u;
      }
      if (a.pool == kAvg2) v[c] *= 0.25f;
    }
  }
  if (w != 0 || m >= a.M) return;
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    const int cb = cg + c, colg = b * a.bn + cb;
    if (c % LG != g || cb >= a.bn || colg >= a.n_cols) continue;
    const int64_t o = m * a.n_cols + colg;
    const float y = a.residual ? v[c] + residual_at(a, o) : v[c];
    static_cast<T*>(a.out)[o] = from_f<T>(y);
  }
}

template <typename T, int W, int TN>
__global__ void __launch_bounds__(kThreads) paired_matmul_kernel_tall(Args a, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int SZ = static_cast<int>(sizeof(T));

  const int tid = threadIdx.x;
  constexpr int RM = tall_rows_per_thread(TN);
  const int S = p.splits, LG = p.lanes, RS = p.rows, NS = p.stages;
  const int WRG = kThreads / LG;                // window-rows the threads take at once
  const int g = tid % LG, wrow = tid / LG;      // lane group, first window-row
  const int K = 2 * a.P + a.R, KE = a.P + a.R;
  const int tiles_n = (a.bn + TN - 1) / TN;
  const int b = blockIdx.y / tiles_n, c0 = (blockIdx.y % tiles_n) * TN;
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t n_sub = (a.M + RS - 1) / RS;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x / S) * p.subtiles;
  const int SUB = static_cast<int>(min(static_cast<int64_t>(p.subtiles), n_sub - s0));
  const int step = slice_step(KE, S);
  const int e_begin = min(KE, rank * step), e_end = min(KE, e_begin + step);
  const int KS = e_end - e_begin;

  const TallLayout L = tall_layout(W, RS, K, SZ, TN, step, S, NS);
  const int block = static_cast<int>(L.block), stage_bytes = W * block;
  float* ws = reinterpret_cast<float*>(smem);  // [slice lane][TN], fp32
  unsigned char* ring = smem + L.ring;
  float* part = reinterpret_cast<float*>(smem + L.part);  // [W * RS][TN], K split

  const T* x = static_cast<const T*>(a.x) + static_cast<int64_t>(b) * W * a.M * K;
  const T* km = static_cast<const T*>(a.kmat) + static_cast<int64_t>(b) * a.P * a.bn;
  const T* wres = static_cast<const T*>(a.wres) + static_cast<int64_t>(b) * a.R * a.bn;
  // the slice's weights for this column tile, fp32, once: fp32 weights are
  // copied in the first stage's group, bf16 ones converted while it lands
  for (int j = tid; j < KS; j += kThreads) {
    const int e = e_begin + j;
    const T* src = e < a.P ? km + static_cast<int64_t>(e) * a.bn + c0
                           : wres + static_cast<int64_t>(e - a.P) * a.bn + c0;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const bool live = c0 + c < a.bn;
      if constexpr (SZ == 4)
        cp_async<4>(ws + j * TN + c, live ? src + c : km, live ? 4 : 0);
      else
        ws[j * TN + c] = live ? to_f(src[c]) : 0.f;
    }
  }
  // sub-tile k into its slot (past the last: an empty group)
#define PM_TALL_ISSUE(k)                                                                      \
  do {                                                                                        \
    if ((k) < SUB)                                                                            \
      tall_issue<T, W>(ring + ((k) % NS) * stage_bytes, x, a.M, K, (s0 + (k)) * RS, RS, block); \
    cp_async_commit();                                                                        \
  } while (0)
  for (int k = 0; k < NS - 1; ++k) PM_TALL_ISSUE(k);

  for (int k = 0; k < SUB; ++k) {
    if (NS == 1) {  // one slot: refill it only after everyone has read it
      __syncthreads();
      PM_TALL_ISSUE(k);
      cp_async_wait<0>();
    } else if (NS == 2) {
      cp_async_wait<0>();
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();  // sub-tile k visible to all; the slot of k - 1 free to refill
    if (NS > 1) PM_TALL_ISSUE(k + NS - 1);
    const unsigned char* st = ring + (k % NS) * stage_bytes;
    const int64_t ms = (s0 + k) * RS;
    // window-row wr = r * W + w: the W windows of a row are neighbours.  A
    // thread takes RM window-rows WRG apart, so each weight it loads feeds
    // RM * TN multiply-adds.
    for (int wr0 = wrow; wr0 < W * RS; wr0 += WRG * RM) {
      const T* row[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int wr = wr0 + i * WRG, w = wr % W;
        row[i] = reinterpret_cast<const T*>(st + w * block + (tall_rows(x, a.M, K, w, ms) & 15)) +
                 (wr / W) * K;
      }
      float acc[RM][TN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[i][c] = 0.f;
      for (int j = g; j < KS; j += LG) {
        const int e = e_begin + j;
        float wv[TN];
        load_row<TN>(wv, ws + j * TN);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float v = e < a.P
              ? sub_at_input_precision<T>(to_f(row[i][e]), to_f(row[i][a.P + e]))
              : to_f(row[i][a.P + e]);
#pragma unroll
          for (int c = 0; c < TN; ++c) acc[i][c] = fmaf(v, wv[c], acc[i][c]);
        }
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int wr = wr0 + i * WRG;
        // the lane groups of the window-row -> its sums, in every lane of the group
#pragma unroll
        for (int c = 0; c < TN; ++c)
          for (int off = 1; off < LG; off <<= 1)
            acc[i][c] += __shfl_xor_sync(0xffffffffu, acc[i][c], off);
        if (S == 1) {
          tall_finish<T, W, TN>(a, acc[i], ms + wr / W, wr % W, b, c0, g, LG);
        } else if (g == 0) {
#pragma unroll
          for (int c = 0; c < TN; ++c) part[wr * TN + c] = acc[i][c];
        }
      }
    }
  }

  if (S > 1) {  // K split over the cluster (one sub-tile a CTA): the leader adds in rank order
    cluster.sync();
    if (rank == 0) {
      const int64_t ms = s0 * RS;
      for (int wr = wrow; wr < W * RS; wr += WRG) {
        float acc[TN];
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[c] = part[wr * TN + c];
        for (int rr = 1; rr < S; ++rr) {
          const float* remote = cluster.map_shared_rank(part, rr);
#pragma unroll
          for (int c = 0; c < TN; ++c) acc[c] += remote[wr * TN + c];
        }
        tall_finish<T, W, TN>(a, acc, ms + wr / W, wr % W, b, c0, g, LG);
      }
    }
    cluster.sync();
  }
#undef PM_TALL_ISSUE
}

// ---------------------------------------------------------------------------
// host side: plan checks and launch
// ---------------------------------------------------------------------------

// One instantiation per kernel, so the shared-memory limit is raised once each.
template <auto kernel>
int launch(dim3 grid, int64_t smem, cudaStream_t stream, const Args& a, const Plan& p) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = static_cast<unsigned>(p.splits);  // the K-slices of a tile
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = p.splits > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, a, p));
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }
bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % static_cast<uintptr_t>(bytes) == 0;
}

// (MR, TN) instances of the skinny form (tuning.SKINNY_SHAPES)
// dry: the checks alone, 0 where the plan has an instance, nothing launched
template <typename T>
int launch_skinny(const Args& a, const Plan& p, int n_blocks, cudaStream_t s, bool dry) {
  const int ke = a.P + a.R;
  const int step = slice_step(ke, p.splits);
  const int vb = p.tn * static_cast<int>(sizeof(T));
  const int64_t smem =
      skinny_layout(p.rows, p.cols, p.tn, sizeof(T), a.P, step, p.splits).total;
  const long long tiles = static_cast<long long>(n_blocks) * ((a.bn + p.cols - 1) / p.cols);
  if (ke < 1 || !pow2(p.cols) || a.bn % p.tn || p.cols % p.tn || p.cols / p.tn > kThreads ||
      p.stages != kSkinnyStages || p.subtiles != 1 || (p.splits - 1) * step >= ke ||
      smem > kMaxSmem || tiles > 65535 || !aligned(a.x, 16) || !aligned(a.kmat, vb) ||
      !aligned(a.wres, vb))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(p.splits, static_cast<unsigned>(tiles));
  constexpr bool bf = sizeof(T) == 2;
  if constexpr (bf)
    if (p.rows == 4 && p.tn == 8)
      return dry ? 0 : launch<paired_matmul_kernel_skinny<T, 4, 8>>(grid, smem, s, a, p);
  if (p.rows == 4 && p.tn == 4)
    return dry ? 0 : launch<paired_matmul_kernel_skinny<T, 4, 4>>(grid, smem, s, a, p);
  if (p.rows == 16 && p.tn == 4)
    return dry ? 0 : launch<paired_matmul_kernel_skinny<T, 16, 4>>(grid, smem, s, a, p);
  return static_cast<int>(cudaErrorInvalidValue);
}

// (W, TN) instances of the tall form (tuning.TALL_TN)
template <typename T>
int launch_tall(const Args& a, const Plan& p, int window, int n_blocks, cudaStream_t s,
                bool dry) {
  const int ke = a.P + a.R, K = 2 * a.P + a.R;
  const int step = slice_step(ke, p.splits);
  if (p.lanes < 1 || !pow2(p.lanes) || p.lanes * window > 32 || p.cols != p.tn ||
      p.rows < 1 || (window * p.rows) % (kThreads / p.lanes * tall_rows_per_thread(p.tn)) ||
      p.stages < 1 || p.stages > 3 ||
      p.subtiles < 1 || (p.splits > 1 && p.subtiles != 1) ||
      (ke > 0 && (p.splits - 1) * step >= ke) || (ke == 0 && p.splits != 1) ||
      !aligned(a.x, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem =
      tall_layout(window, p.rows, K, sizeof(T), p.tn, step, p.splits, p.stages).total;
  const long long n_sub = (a.M + p.rows - 1) / p.rows;
  const long long groups = (n_sub + p.subtiles - 1) / p.subtiles;
  const long long tiles = static_cast<long long>(n_blocks) * ((a.bn + p.tn - 1) / p.tn);
  if (smem > kMaxSmem || tiles > 65535 || groups * p.splits > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(groups * p.splits), static_cast<unsigned>(tiles));
#define PM_TALL(W_, TN_)           \
  if (window == W_ && p.tn == TN_) \
    return dry ? 0 : launch<paired_matmul_kernel_tall<T, W_, TN_>>(grid, smem, s, a, p);
  PM_TALL(1, 1) PM_TALL(1, 4) PM_TALL(1, 8) PM_TALL(4, 1) PM_TALL(4, 4) PM_TALL(4, 8)
#undef PM_TALL
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch's range checks, then its form's (dry: nothing launched).
int run(const Args& a, int n_blocks, int window, int bf16, int skinny, const Plan& p,
        cudaStream_t s, bool dry) {
  if (a.M <= 0 || a.P < 0 || a.R < 0 || n_blocks < 1 || a.bn < 1 || a.n_cols < 1 ||
      a.n_cols > n_blocks * a.bn || (window != 1 && window != 4) ||
      (window == 4) != (a.pool == kMax2 || a.pool == kAvg2) || a.act < kNone ||
      a.act > kTanh || p.rows < 1 || p.rows > 65536 || p.cols < 1 || !pow2(p.tn) ||
      p.splits < 1 || p.splits > kMaxCluster || (skinny && window != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (skinny)
    return bf16 ? launch_skinny<__nv_bfloat16>(a, p, n_blocks, s, dry)
                : launch_skinny<float>(a, p, n_blocks, s, dry);
  return bf16 ? launch_tall<__nv_bfloat16>(a, p, window, n_blocks, s, dry)
              : launch_tall<float>(a, p, window, n_blocks, s, dry);
}

}  // namespace

extern "C" int paired_matmul_launch(
    const void* x, const void* kmat, const void* wres, const void* bias,
    const void* residual, void* out, long long M, int P, int R, int n_blocks,
    int bn, int n_cols, int window, int pool, int act, int bf16, int res_bf16,
    int skinny, int rows, int cols, int tn, int splits, int lanes, int subtiles, int stages,
    void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  Args a{x, kmat, wres, static_cast<const float*>(bias), residual, out,
         static_cast<int64_t>(M), P, R, bn, n_cols, pool, act, res_bf16};
  const Plan p{rows, cols, tn, splits, lanes, subtiles, stages};
  const int err = run(a, n_blocks, window, bf16, skinny, p, static_cast<cudaStream_t>(stream),
                      false);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// paired_matmul_launch's checks of a plan for one problem, nothing launched:
// 0 where it would take the plan, else the error it would return
// (tuning.refusal is the host's copy of these checks).
extern "C" int paired_matmul_check(long long M, int P, int R, int n_blocks, int bn, int window,
                                   int bf16, int skinny, int rows, int cols, int tn, int splits,
                                   int lanes, int subtiles, int stages) {
  Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, static_cast<int64_t>(M), P, R,
         bn, n_blocks * bn, window == 4 ? kMax2 : 0, kNone, 0};
  const Plan p{rows, cols, tn, splits, lanes, subtiles, stages};
  return run(a, n_blocks, window, bf16, skinny, p, nullptr, true);
}

// The dynamic shared memory, in bytes, that a plan's launch lays out (what
// tuning.Plan.smem models).
extern "C" long long paired_matmul_smem(int P, int R, int window, int bf16, int skinny, int rows,
                                        int cols, int tn, int splits, int stages) {
  const int itemsize = bf16 ? 2 : 4;
  const int step = slice_step(P + R, splits < 1 ? 1 : splits);
  return skinny ? skinny_layout(rows, cols, tn, itemsize, P, step, splits).total
                : tall_layout(window, rows, 2 * P + R, itemsize, tn, step, splits, stages).total;
}

extern "C" const char* paired_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

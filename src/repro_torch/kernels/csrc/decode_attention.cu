// Single-token decode attention fused into the paired out-projection, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention.py::
// _decode_attn_kernel (reached from decode_attention_fwd, proj=False, and
// fused_decode_attention, proj=True).  For every slot b, with one query row
// q (H, D), a KV cache (S, KH, D) and the slot's position pos:
//
//   s[h, k] = q[h] . K[k, h / G] / sqrt(D)    for keys k passing the mask
//             k <= pos  and  (k > pos - window  or  k < n_sink)  (window > 0)
//   o[h]    = softmax(s[h]) @ V[:, h / G]     online, fp32; zeros for a slot
//                                             whose mask admits no key
//   proj=False:  out[b] = o                   (B, H, D), the I/O dtype
//   proj=True:   o is rounded to the I/O dtype, then per column block w
//                y[w] = (o[I[w]] - o[J[w]]) . kmat[w] + o[R[w]] . w_res[w]
//                out[b] = y[:n_cols] (+ residual[b], added in fp32)
//
// What bounds it on this card.  One decode step reads each live KV row once
// and the out-projection's segments once, and does about two FLOP per byte:
// far below the H100's ridge point, so it is bound by bytes, and at the
// serving shapes (a few dozen live keys, 1.5-3 MB of segments, warm in L2)
// by the latency of its dependent steps.  The design shortens that chain and
// reads every byte once:
//
//   * A thread-block cluster (kernels/tuning.py: k2_plan; at most 8 CTAs,
//     launched with cudaLaunchKernelEx and a cluster-dimension attribute)
//     owns `slots` slots.  Their attention is cut into work items (slot,
//     unit, key range) dealt round-robin over the ranks: no CTA walks a
//     slot's attention alone.  A unit is one KV head with its G query heads,
//     or, where G heads' scratch would not fit, one of `groups` groups of
//     G / groups of them (each group reads the KV head's keys again); each
//     head's arithmetic is the same in any grouping.  The key ranges are cut
//     in the kernel from pos (the plan depends only on S, so no host read of
//     pos breaks graph capture): the live prefix [0, min(pos, S-1) + 1) in `splits` ranges of
//     whole 32-key tiles; tiles that the window and sinks leave dead are
//     skipped.  Both forms cut the keys alike and spell out every fused
//     multiply-add, so the fused form attends bit for bit as the bare one.
//   * K and V rows of a tile come in as 16-byte cp.async copies through a
//     ring of 2-3 stages in shared memory (rows past the range are never
//     read; rows padded by 16 bytes, so 32 lanes reading 32 rows hit every
//     bank).  Scores: a lane per key, a warp per eighth of D; each lane dots
//     its key's slice with the slice of each of its unit's queries
//     (broadcast reads), and the eight warps' partial dots meet once
//     per (key, head) in the softmax step, summed in warp order: no shuffle
//     reductions.  A warp per head updates the online softmax (lane per
//     key); PV reads V from shared memory, a thread owning four adjacent
//     dims of one head.
//   * Each rank keeps its items' partial (m, l, acc) in shared memory; the
//     partials of a (slot, unit) pair meet in one rank, pair % cluster:
//     with one key range the pair's only item already lives there, with more
//     the other ranks push theirs into its shared memory (distributed shared
//     memory stores, after a barrier that shows every rank started).  After
//     a cluster barrier that all ranks have passed, each rank merges its
//     pairs in split order, which is rank order (a relaunch gives the same
//     bits); flush o = acc / max(l, 1e-30).  Stores are posted and reads
//     through distributed shared memory wait a round trip each, so data
//     moves between ranks only by stores.
//   * Bare form: each rank stores its merged pairs.  Fused form: each rank
//     rounds its merged vectors to the I/O dtype (the TPU kernel's rounding
//     point) and pushes them into every rank; after one more cluster barrier
//     every rank holds the attended vectors of all its cluster's slots and
//     owns `cols` adjacent columns of one column block for all of them (K1's
//     skinny form with M = slots), so the segments are read once a launch,
//     not once per slot.  Each thread owns `tn` adjacent columns (16-byte
//     kmat / w_res vectors) of every `cols / tn`-th lane and streams them
//     through its own cp.async ring, issued before the attention, so the
//     weights arrive while it runs; the block's I/J/R lanes are staged in
//     shared memory and the gathers o[I] - o[J], o[R] of all slots are made
//     once a CTA into a [lane][slot] table, `chunk` lanes at a time where
//     the whole block's would not fit (the first chunk staged before the
//     attention; the sums run in the same order either way).  The attended
//     vectors stay in the I/O dtype they were rounded to.  Row groups meet
//     by warp shuffles and one ordered pass over the warps; the residual is
//     added in fp32 and each output stored once.
//
// Padded lanes of the blocked layout point at row 0 and carry zero weights,
// so they add exact zeros; the short last block's padded columns are never
// stored.
//
// Shared memory is laid out by the plan (tuning.k2_plan), which the kernel
// follows: its offsets and strides come in with the launch.
//
// C interface (bound with ctypes): decode_attention_launch returns
// cudaGetLastError() after the launch, 0 on success, and cudaErrorInvalidValue
// for a shape or plan out of range (nothing is launched then).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;          // keys a tile: a lane per key
constexpr int kMaxD = 256;
constexpr int kMaxCluster = 8;     // portable cluster size
constexpr int kMaxSlots = 4;       // slots a cluster: the projection's rows (a float4 of lanes)
constexpr int kWStagesMax = 8;     // weight ring: 16-byte slots a thread (plan: 4 or 8)
constexpr int kCopy = 4;           // lanes a thread gathers at once
constexpr int kMaxSmem = 232448;   // 227 KB, the opt-in dynamic shared memory

struct Args {
  const void* q;         // (B, H, D)
  const void* k;         // (B, S, KH, D)
  const void* v;         // (B, S, KH, D)
  const int* pos;        // (B,)
  const int* idx_i;      // (Bw, P)
  const int* idx_j;      // (Bw, P)
  const int* idx_r;      // (Bw, R)
  const void* kmat;      // (Bw, P, bn), the I/O dtype
  const void* wres;      // (Bw, R, bn), the I/O dtype
  const void* residual;  // (B, n_cols) in the output dtype, or null
  void* out;             // proj: (B, n_cols); else (B, H, D)
  int B, S, H, KH, D, window, n_sink;
  int P, R, bn, n_blocks, n_cols, proj, kv16;
  float scale;
};

// tuning.K2Plan, which also lays out shared memory: `cluster` CTAs own
// `slots` slots; each KV head's G query heads are cut in `groups` groups of
// gc = G / groups (the work of KH * groups heads of gc queries, the same K/V
// read once a group); each (slot, KV head, group) unit's keys are cut in
// `splits` ranges; fused form: `cols` columns a CTA, `tn` adjacent columns a
// thread, `wstages` weight ring slots a thread, the block's lanes gathered
// `chunk` at a time; `stages` K/V ring slots.  Then the strides of the
// regions (floats of an item's partial, bytes of a K/V row, floats of a
// query row) and the byte offset of each region, `total` their end.
// Regions: the weight ring ([wstages][thread] 16-byte slots, fused), the K/V
// ring ([stage][K, V][kTile] rows), the chunk's first and second lane
// indices ([2][chunk]: I or R, then J; fused), the attended vectors of the
// cluster's slots ([slots][H*D], the I/O dtype, fused) and the chunk's
// gathered lanes ([lane][kMaxSlots] fp32: o[I] - o[J] or o[R], fused), the
// rank's partials ([item][acc gc*D | m gc | l gc] fp32), the split partials
// other ranks push to it for the units it merges ([unit][split], when
// splits > 1), their merge weights ([unit][split + 1][gc]: w, then
// max(l, 1e-30)), the item's queries ([gc][dq] fp32), scores
// ([warp][gc][kTile] partial dots, then [gc][kTile] probabilities),
// corrections ([gc]) and the projection's warp partials
// ([warp][slots][cols], fused).  The attended vectors and the gathered
// lanes are written only after every rank's attention is done, so the plan
// may place them inside the K/V ring.
struct Plan {
  int cluster, slots, splits, groups, cols, tn, stages, wstages, chunk;
  int isz, row_bytes, dq;
  int wring, kv, idx, vec, xg, part, gath, coef, qs, sc, corr, red, total;
};
constexpr int kPlanLen = sizeof(Plan) / sizeof(int);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ bool in_window(int key, int pos, int window, int n_sink) {
  if (!window) return true;
  return key > pos - window || key < n_sink;
}

// cp.async of BYTES (4, 8 or 16) into shared memory; n < BYTES source bytes
// zero-fill the rest (n == 0: no read at all)
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

// four consecutive elements of a K row in shared memory (d % 4 == 0)
__device__ __forceinline__ void lds4(const float* row, int d, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(row + d);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}
__device__ __forceinline__ void lds4(const __nv_bfloat16* row, int d, float (&x)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(row + d);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
}

// Cluster barriers (a CTA alone syncs its threads): `sync` orders every
// store into another rank's shared memory before the barrier ahead of the
// reads after it; `started` orders nothing: past it every CTA of the
// cluster has started, and only then may a CTA store into another's memory.
__device__ __forceinline__ void cluster_sync(int C) {
  if (C > 1) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  } else {
    __syncthreads();
  }
}
__device__ __forceinline__ void cluster_started(int C) {
  if (C > 1) {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  }
}

// four values of the I/O dtype stored as one vector (8 or 16 bytes)
__device__ __forceinline__ void st4(float* dst, const float (&o)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void st4(__nv_bfloat16* dst, const float (&o)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]), hi = __floats2bfloat162_rn(o[2], o[3]);
  uint2 t;
  t.x = *reinterpret_cast<const unsigned*>(&lo);
  t.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(dst) = t;
}

// T: dtype of q, the cache and the segments; O: dtype of the output (and of
// the residual, when there is one); TN: adjacent columns a thread.
template <typename T, typename O, int TN>
__global__ void __launch_bounds__(kThreads, 1) decode_attention_kernel(Args a, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = p.cluster, rank = C > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  // unit kvv of a slot: the gc query heads kvv * gc, ... of KV head kvv / groups
  const int gc = a.H / a.KH / p.groups, KV = a.KH * p.groups;
  const int D = a.D, HD = a.H * D;
  const int RB = p.row_bytes, dq = p.dq, isz = p.isz;
  // scores: dims a warp (a multiple of 4); PV: 4-dim groups a head
  const int dw = ((D + kWarps - 1) / kWarps + 3) & ~3, nq4 = (D + 3) / 4;
  const int slot0 = blockIdx.y * p.slots;
  const int n_slots = min(p.slots, a.B - slot0);

  float* part = reinterpret_cast<float*>(smem + p.part);
  float* gath = reinterpret_cast<float*>(smem + p.gath);
  float* qs = reinterpret_cast<float*>(smem + p.qs);
  float* sc = reinterpret_cast<float*>(smem + p.sc);  // [warp][gc][kTile] partial dots
  float* pt = sc;                                      // [gc][kTile] probabilities, after
  float* corr = reinterpret_cast<float*>(smem + p.corr);
  T* vec = reinterpret_cast<T*>(smem + p.vec);
  unsigned char* kv = smem + p.kv;

  // ---- the fused form's column tile: stage its lanes, start its weights ----
  const int tpr = p.cols / TN, cgi = tid % tpr, rg = tid / tpr, RG = kThreads / tpr;
  const int tiles_per_block = a.proj ? (a.bn + p.cols - 1) / p.cols : 1;  // bare: bn is 0
  const int blk = blockIdx.x / tiles_per_block;
  const int c0 = (blockIdx.x - blk * tiles_per_block) * p.cols;
  const bool has_tile = a.proj && blk < a.n_blocks;
  const int col = c0 + cgi * TN;  // this thread's first column in the block
  const bool col_ok = has_tile && col < a.bn;
  const int KE = a.P + a.R;
  const int n_rows = rg < KE ? (KE - rg + RG - 1) / RG : 0;  // this thread's lanes
  int* lane_a = reinterpret_cast<int*>(smem + p.idx);  // the chunk's I or R lanes
  int* lane_b = lane_a + p.chunk;                       // ... and J lanes (pairs)
  const T* km = static_cast<const T*>(a.kmat) + static_cast<int64_t>(blk) * a.P * a.bn + col;
  const T* wr = static_cast<const T*>(a.wres) + static_cast<int64_t>(blk) * a.R * a.bn + col;
  constexpr bool kRing = TN * sizeof(T) == 16;  // 16-byte weight vectors through the ring
  unsigned char* wring = smem + p.wring;
  auto w_src = [&](int e) {
    return e < a.P ? km + static_cast<int64_t>(e) * a.bn : wr + static_cast<int64_t>(e - a.P) * a.bn;
  };
  auto issue_w = [&](int k) {  // this thread's lane k into its ring slot
    if constexpr (kRing) {
      const bool ok = col_ok && k < n_rows;
      cp_async<16>(wring + ((k % p.wstages) * kThreads + tid) * 16, ok ? w_src(rg + RG * k) : km,
                   ok ? 16 : 0);
    }
    cp_async_commit();
  };
  // the block's lanes [e0, e0 + n) into lane_a / lane_b: the first chunk by
  // cp.async before the attention, later ones by loads between chunks
  auto stage_lanes = [&](int e0, int n, bool async) {
    for (int i = tid; i < 2 * n; i += kThreads) {
      const int second = i >= n, le = i - second * n, e = e0 + le;
      if (second && e >= a.P) continue;  // a residual lane has no J
      const int* src = e < a.P ? (second ? a.idx_j : a.idx_i) + static_cast<int64_t>(blk) * a.P + e
                               : a.idx_r + static_cast<int64_t>(blk) * a.R + e - a.P;
      int* dst = (second ? lane_b : lane_a) + le;
      if (async)
        cp_async<4>(dst, src, 4);
      else
        *dst = *src;
    }
  };
  if (has_tile) stage_lanes(0, min(KE, p.chunk), true);
  // the residual of this thread's outputs (i = tid + r * kThreads of the
  // tile's slots x cols), read now and added at the end
  float res_pre[kMaxSlots * 32 * 8 / kThreads];
#pragma unroll
  for (int r = 0; r < kMaxSlots * 32 * 8 / kThreads; ++r) {
    const int i = tid + r * kThreads, sr = i / p.cols, cc = i - sr * p.cols;
    const int colb = c0 + cc, colg = blk * a.bn + colb;
    res_pre[r] = has_tile && a.residual && sr < n_slots && colb < a.bn && colg < a.n_cols
                     ? to_f(static_cast<const O*>(a.residual)[static_cast<int64_t>(slot0 + sr) *
                                                                a.n_cols + colg])
                     : 0.f;
  }
  if (a.proj) {
#pragma unroll
    for (int k = 0; k < p.wstages - 1; ++k) issue_w(k);  // land while the attention runs
  }

  // ---- attention: this rank's work items (slot, unit, key range) ----
  const int n_items = p.slots * KV * p.splits;
  const int items = (n_items + C - 1) / C;
  for (int ii = 0; ii < items; ++ii) {
    const int it = rank + C * ii;
    float* acc = part + static_cast<int64_t>(ii) * isz;
    float* m_s = acc + gc * D;
    float* l_s = m_s + gc;
    const int sl = it / (KV * p.splits), kvv = (it / p.splits) % KV, split = it % p.splits;
    const int kvh = kvv / p.groups;
    const bool valid = it < n_items && sl < n_slots;
    const int b = slot0 + (valid ? sl : 0);
    int lo = 0, hi = 0, pos = 0;
    if (valid) {
      pos = a.pos[b];
      const int n_live = pos < 0 ? 0 : min(pos, a.S - 1) + 1;
      const int tiles = (n_live + kTile - 1) / kTile;
      const int step = (tiles + p.splits - 1) / p.splits * kTile;
      lo = min(n_live, split * step);
      hi = min(n_live, lo + step);
    }
    for (int i = tid; i < gc * D; i += kThreads) acc[i] = 0.f;
    for (int g = tid; g < gc; g += kThreads) {
      m_s[g] = -INFINITY;
      l_s[g] = 0.f;
    }
    // the first live tile at or after `base` (tiles the window and sinks
    // leave dead are skipped whole)
    const int first = pos - a.window + 1;
    const int tb = first > 0 ? first / kTile * kTile : 0;
    auto next_live = [&](int base) {
      return !a.window || base < a.n_sink ? base : max(base, tb);
    };
    const int64_t row = static_cast<int64_t>(a.KH) * D;  // one key's stride
    const T* kc = static_cast<const T*>(a.k) + static_cast<int64_t>(b) * a.S * row + kvh * D;
    const T* vc = static_cast<const T*>(a.v) + static_cast<int64_t>(b) * a.S * row + kvh * D;
    int issue_base = next_live(lo), n_issued = 0;
    auto issue_kv = [&]() {  // the next live tile into its ring stage
      if (issue_base < hi) {
        unsigned char* ks = kv + (n_issued % p.stages) * 2 * kTile * RB;
        unsigned char* vs = ks + kTile * RB;
        const int rows = min(kTile, hi - issue_base);
        if (a.kv16) {
          const int ch = D * static_cast<int>(sizeof(T)) / 16;
          for (int i = tid; i < rows * ch; i += kThreads) {
            const int j = i / ch, c = i - j * ch;
            const int64_t off = (issue_base + j) * row;
            cp_async<16>(ks + j * RB + c * 16, reinterpret_cast<const unsigned char*>(kc + off) + c * 16, 16);
            cp_async<16>(vs + j * RB + c * 16, reinterpret_cast<const unsigned char*>(vc + off) + c * 16, 16);
          }
        } else {  // rows not 16-byte aligned: element copies
          for (int i = tid; i < rows * D; i += kThreads) {
            const int j = i / D, d = i - j * D;
            const int64_t off = (issue_base + j) * row + d;
            reinterpret_cast<T*>(ks + j * RB)[d] = kc[off];
            reinterpret_cast<T*>(vs + j * RB)[d] = vc[off];
          }
        }
        issue_base = next_live(issue_base + kTile);
      }
      ++n_issued;
      cp_async_commit();  // an empty group keeps the count
    };
    for (int s = 0; s < p.stages - 1; ++s) issue_kv();
    {  // the queries, while the first tiles fly
      const T* q = static_cast<const T*>(a.q) + (static_cast<int64_t>(b) * a.H + kvv * gc) * D;
      for (int i = tid; i < gc * dq; i += kThreads) {
        const int g = i / dq, d = i - g * dq;
        qs[i] = valid && d < D ? to_f(q[g * D + d]) : 0.f;
      }
    }
    __syncthreads();  // qs, acc, m, l initialised

    int base = next_live(lo);
    for (int k = 0; base < hi; ++k) {
      if (p.stages == 3) cp_async_wait<1>(); else cp_async_wait<0>();  // tile k has landed
      __syncthreads();  // ... for every thread; tile k - 1's slot is free
      issue_kv();       // tile k + stages - 1, into that slot
      const unsigned char* ks = kv + (k % p.stages) * 2 * kTile * RB;
      const unsigned char* vs = ks + kTile * RB;
      const int nk = min(kTile, hi - base);

      // scores: warp w takes dims [w * dw, (w + 1) * dw) of the tile's keys
      // (lane = key; rows padded by 16 bytes, so the lanes' rows start on
      // other banks) against the unit's gc queries (broadcast)
      {
        const int j = lane, d0 = warp * dw;
        const T* kr_s = reinterpret_cast<const T*>(ks + j * RB);
        float kr[kMaxD / kWarps];
#pragma unroll
        for (int c = 0; c < kMaxD / kWarps; c += 4) {
          const int d = d0 + c;
          if (c < dw && j < nk && d + 4 <= D) {
            float x[4];
            lds4(kr_s, d, x);
#pragma unroll
            for (int u = 0; u < 4; ++u) kr[c + u] = x[u];
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) kr[c + u] = c < dw && j < nk && d + u < D ? to_f(kr_s[d + u]) : 0.f;
          }
        }
        for (int g0 = 0; g0 < gc; g0 += 4) {  // four heads' dots at once
          float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int c = 0; c < kMaxD / kWarps; c += 4) {
            if (c < dw && d0 + c < dq) {
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                if (g0 + u < gc) {
                  const float4 qv = *reinterpret_cast<const float4*>(qs + (g0 + u) * dq + d0 + c);
                  dot[u] = fmaf(qv.x, kr[c], dot[u]);
                  dot[u] = fmaf(qv.y, kr[c + 1], dot[u]);
                  dot[u] = fmaf(qv.z, kr[c + 2], dot[u]);
                  dot[u] = fmaf(qv.w, kr[c + 3], dot[u]);
                }
              }
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)  // [warp][head][key] partial dots
            if (g0 + u < gc) sc[(warp * gc + g0 + u) * kTile + j] = dot[u];
        }
      }
      __syncthreads();

      // online softmax: warp per head, lane per key; the warps' partial dots
      // summed in order
      for (int h = warp; h < gc; h += kWarps) {
        const int key = base + lane;
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += sc[(w * gc + h) * kTile + lane];
        s = lane < nk && in_window(key, pos, a.window, a.n_sink) ? s * a.scale : -INFINITY;
        const float m_prev = m_s[h];
        const float m_new = fmaxf(m_prev, warp_max(s));
        const float m_safe = isfinite(m_new) ? m_new : 0.f;
        const float pr = isfinite(s) ? expf(s - m_safe) : 0.f;
        const float c = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.f;
        const float psum = warp_sum(pr);
        pt[h * kTile + lane] = pr;
        if (lane == 0) {
          l_s[h] = fmaf(l_s[h], c, psum);
          m_s[h] = m_new;
          corr[h] = c;
        }
      }
      __syncthreads();

      // acc = acc * corr + p @ V: a thread owns 4 adjacent dims of one head
      // (one vector load of V a key, p broadcast); V from shared memory
      for (int i = tid; i < gc * nq4; i += kThreads) {
        const int g = i / nq4, d0 = (i - g * nq4) * 4;
        const float* pg = pt + g * kTile;
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
        if (d0 + 4 <= D) {
#pragma unroll 4
          for (int j = 0; j < nk; ++j) {
            float vv[4];
            lds4(reinterpret_cast<const T*>(vs + j * RB), d0, vv);
            const float pj = pg[j];
#pragma unroll
            for (int u = 0; u < 4; ++u) pv[u] = fmaf(pj, vv[u], pv[u]);
          }
        } else {
          for (int j = 0; j < nk; ++j) {
            const T* vr = reinterpret_cast<const T*>(vs + j * RB);
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (d0 + u < D) pv[u] = fmaf(pg[j], to_f(vr[d0 + u]), pv[u]);
          }
        }
        float* ag = acc + g * D + d0;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (d0 + u < D) ag[u] = fmaf(ag[u], corr[g], pv[u]);
      }
      base = next_live(base + kTile);
    }
    cp_async_wait<0>();
    __syncthreads();
    if (p.splits > 1 && it < n_items) {  // the partial, pushed to the rank that merges its unit
      if (ii == 0) cluster_started(C);  // remote stores only once every rank has started
      const int pr = it / p.splits;
      float* dst = (C > 1 ? cluster.map_shared_rank(gath, pr % C) : gath) +
                   static_cast<int64_t>((pr / C) * p.splits + split) * isz;
      for (int i = tid; i < isz / 4; i += kThreads)
        reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(acc)[i];
    } else if (p.splits > 1 && ii == 0) {
      cluster_started(C);
    }
  }

  // ---- merge: each rank merges its units rank, rank + C, ... in split order ----
  cluster_sync(C);  // every partial is written (pushed, with splits > 1)
  const int n_units = p.slots * KV;
  const int my_units = rank < n_units ? (n_units - rank + C - 1) / C : 0;
  // unit pk's split sp: its own item (one split: item = unit), or the pushed copy
  auto mpart = [&](int pk, int sp) -> const float* {
    return p.splits > 1 ? gath + static_cast<int64_t>(pk * p.splits + sp) * isz
                        : part + static_cast<int64_t>(pk) * isz;
  };
  // per (unit, head): the split weights exp(m - m_max), and max(l, 1e-30)
  float* coef = reinterpret_cast<float*>(smem + p.coef);  // [unit][split + 1][gc]
  for (int i = tid; i < my_units * gc; i += kThreads) {
    const int pk = i / gc, g = i - pk * gc;
    float m_max = -INFINITY;
    for (int sp = 0; sp < p.splits; ++sp) m_max = fmaxf(m_max, mpart(pk, sp)[gc * D + g]);
    const float m_safe = isfinite(m_max) ? m_max : 0.f;
    float l = 0.f;
    for (int sp = 0; sp < p.splits; ++sp) {
      const float m = mpart(pk, sp)[gc * D + g];
      const float w = isfinite(m) ? expf(m - m_safe) : 0.f;
      coef[(pk * (p.splits + 1) + sp) * gc + g] = w;
      l = fmaf(w, mpart(pk, sp)[gc * D + gc + g], l);
    }
    coef[(pk * (p.splits + 1) + p.splits) * gc + g] = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  // o = sum_split w * acc / max(l, 1e-30), four dims at a time: bare stores
  // it; fused rounds it to the I/O dtype (the TPU kernel's rounding point) and
  // pushes it into every rank's attended vectors
  O* out = static_cast<O*>(a.out);
  {
    const int vw = D % 4 == 0 ? 4 : 1;  // dims at a time
    const int per = gc * D / vw;
    for (int i = tid; i < my_units * per; i += kThreads) {
      const int pk = i / per, e = (i - pk * per) * vw, g = e / D;
      const float* cf = coef + pk * (p.splits + 1) * gc + g;
      float o[4] = {0.f, 0.f, 0.f, 0.f};
      for (int sp = 0; sp < p.splits; ++sp) {
        const float* src = mpart(pk, sp) + e;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c < vw) o[c] = fmaf(cf[sp * gc], src[c], o[c]);
      }
      const int pr = rank + pk * C, sl = pr / KV, kvv = pr - sl * KV;
      const int64_t at = static_cast<int64_t>(kvv) * gc * D + e;  // h * D + d
#pragma unroll
      for (int c = 0; c < 4; ++c) o[c] /= cf[p.splits * gc];
      if (a.proj) {
        for (int r = 0; r < C; ++r) {
          T* dst = (C > 1 ? cluster.map_shared_rank(vec, r) : vec) + sl * HD + at;
          if (vw == 4)
            st4(dst, o);
          else
            *dst = from_f<T>(o[0]);
        }
      } else if (sl < n_slots) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c < vw) out[static_cast<int64_t>(slot0 + sl) * HD + at + c] = from_f<O>(o[c]);
      }
    }
  }
  // bare: done (every store into this rank's shared memory preceded the
  // barrier above); fused: one more barrier, and every rank holds the
  // attended vectors of all the cluster's slots
  if (!a.proj) return;
  cluster_sync(C);

  // ---- paired out-projection of this CTA's columns, for every slot ----
  // the block's lanes a chunk at a time, each chunk's lanes of every slot
  // gathered once: o[I] - o[J] (pairs; the difference in fp32 of the rounded
  // values) or o[R] (residual lanes).  A chunk short of all lanes is a
  // multiple of kThreads, so of RG: thread lanes never straddle two chunks.
  float4* xg = reinterpret_cast<float4*>(smem + p.xg);  // [chunk lane] (slot 0..3)
  float y[kMaxSlots][TN];
#pragma unroll
  for (int s = 0; s < kMaxSlots; ++s)
#pragma unroll
    for (int c = 0; c < TN; ++c) y[s][c] = 0.f;
  int k = 0;  // this thread's next lane: rg + RG * k
  for (int e_lo = 0; e_lo < KE; e_lo += p.chunk) {
    const int n = min(p.chunk, KE - e_lo);
    if (e_lo > 0) {  // (the first chunk landed with the attention's copies)
      __syncthreads();  // every thread is done with the last chunk's lanes
      if (has_tile) stage_lanes(e_lo, n, false);
      __syncthreads();
    }
    if (has_tile) {
      for (int e0 = tid; e0 < n; e0 += kCopy * kThreads) {  // gathers first, then stores
        float x[kCopy][kMaxSlots];
#pragma unroll
        for (int u = 0; u < kCopy; ++u) {
          const int le = min(e0 + u * kThreads, n - 1), e = e_lo + le;
          const int i0 = lane_a[le], j0 = e < a.P ? lane_b[le] : 0;
#pragma unroll
          for (int s = 0; s < kMaxSlots; ++s) {
            const T* o = vec + s * HD;
            x[u][s] = s >= n_slots ? 0.f : e < a.P ? to_f(o[i0]) - to_f(o[j0]) : to_f(o[i0]);
          }
        }
#pragma unroll
        for (int u = 0; u < kCopy; ++u)
          if (e0 + u * kThreads < n) xg[e0 + u * kThreads] = make_float4(x[u][0], x[u][1], x[u][2], x[u][3]);
      }
    }
    __syncthreads();
    for (; k < n_rows && rg + RG * k < e_lo + n; ++k) {
      float w[TN];
      if constexpr (kRing) {
        if (p.wstages == kWStagesMax) cp_async_wait<kWStagesMax - 2>(); else cp_async_wait<2>();
        issue_w(k + p.wstages - 1);  // into the slot lane k - 1 used (lane k has landed)
        const uint4 raw = *reinterpret_cast<const uint4*>(wring + ((k % p.wstages) * kThreads + tid) * 16);
        const T* wv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int c = 0; c < TN; ++c) w[c] = col_ok ? to_f(wv[c]) : 0.f;
      } else {
        const T* src = w_src(rg + RG * k);
#pragma unroll
        for (int c = 0; c < TN; ++c) w[c] = col_ok ? to_f(src[c]) : 0.f;
      }
      const float4 xv = xg[rg + RG * k - e_lo];
      const float x[kMaxSlots] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int s = 0; s < kMaxSlots; ++s)
#pragma unroll
        for (int c = 0; c < TN; ++c) y[s][c] = fmaf(x[s], w[c], y[s][c]);
    }
  }
  // row groups: inside a warp by shuffles, then the warps in order
  float* red = reinterpret_cast<float*>(smem + p.red);  // [warp][slots][cols]
  for (int off = tpr; off < 32; off <<= 1)  // a level's shuffles are independent
#pragma unroll
    for (int s = 0; s < kMaxSlots; ++s)
#pragma unroll
      for (int c = 0; c < TN; ++c) y[s][c] += __shfl_xor_sync(0xffffffffu, y[s][c], off);
  if (lane < tpr) {
#pragma unroll
    for (int s = 0; s < kMaxSlots; ++s)
      if (s < p.slots)
#pragma unroll
        for (int c = 0; c < TN; ++c) red[(warp * p.slots + s) * p.cols + cgi * TN + c] = y[s][c];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kMaxSlots * 32 * 8 / kThreads; ++r) {
    const int i = tid + r * kThreads, s = i / p.cols, cc = i - s * p.cols;
    const int colb = c0 + cc, colg = blk * a.bn + colb;
    if (s >= n_slots || !has_tile || colb >= a.bn || colg >= a.n_cols) continue;
    float v = 0.f;
    for (int ww = 0; ww < kWarps; ++ww) v += red[(ww * p.slots + s) * p.cols + cc];
    if (a.residual) v += res_pre[r];
    out[static_cast<int64_t>(slot0 + s) * a.n_cols + colg] = from_f<O>(v);
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// host side: plan checks and launch
// ---------------------------------------------------------------------------

// One instantiation per kernel, so the shared-memory limit is raised once each
// (a launch captured in a CUDA graph makes no attribute call).
template <auto kernel>
int launch(dim3 grid, int smem, cudaStream_t stream, const Args& a, const Plan& p) {
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
  at[0].val.clusterDim.x = static_cast<unsigned>(p.cluster);  // the ranks of a slot group
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, a, p));
}

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }
bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <typename T, typename O>
int launch_tn(const Args& a, const Plan& p, cudaStream_t s) {
  constexpr int vec = 16 / static_cast<int>(sizeof(T));
  const int tiles = a.proj ? a.n_blocks * ((a.bn + p.cols - 1) / p.cols) : p.cluster;
  const int clusters = (tiles + p.cluster - 1) / p.cluster;
  const dim3 grid(static_cast<unsigned>(clusters * p.cluster),
                  static_cast<unsigned>((a.B + p.slots - 1) / p.slots));
  if (p.tn == vec) {
    if (a.proj && (a.bn % vec || !aligned16(a.kmat) || !aligned16(a.wres)))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch<decode_attention_kernel<T, O, vec>>(grid, p.total, s, a, p);
  }
  if (p.tn == 1) return launch<decode_attention_kernel<T, O, 1>>(grid, p.total, s, a, p);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The plan's checks: its counts in range, and its strides and regions able
// to hold what the kernel puts there (the plan lays them out; this checks
// that each region starts 16-byte aligned inside `total` <= 227 KB and that
// the strides are wide enough).
bool plan_ok(const Plan& p, int H, int KH, int D, int P, int R, int bn, int n_blocks, int itemsize,
             int proj) {
  if (p.cluster < 1 || p.cluster > kMaxCluster || p.slots < 1 || p.slots > kMaxSlots ||
      p.splits < 1 || p.splits > kMaxCluster || p.groups < 1 || (H / KH) % p.groups != 0 ||
      p.stages < 2 || p.stages > 3 || (p.wstages != 4 && p.wstages != kWStagesMax))
    return false;
  if (proj && (!pow2(p.cols) || !pow2(p.tn) || p.cols % p.tn || p.cols / p.tn > 32 ||
               p.cols >= 2 * bn || p.chunk < 1 ||
               (p.chunk < P + R && p.chunk % kThreads != 0)))
    return false;
  const int gc = H / KH / p.groups;
  if (p.isz < gc * (D + 2) || p.isz % 4 || p.row_bytes < D * itemsize || p.row_bytes % 16 ||
      p.dq < D || p.dq % 4)
    return false;
  const int regions[] = {p.wring, p.kv, p.idx, p.vec, p.xg, p.part, p.gath,
                         p.coef,  p.qs, p.sc,  p.corr, p.red};
  for (int o : regions)
    if (o < 0 || o % 16 || o > p.total) return false;
  const long long ctas = proj ? static_cast<long long>(n_blocks) * ((bn + p.cols - 1) / p.cols)
                              : p.cluster;
  return p.total <= kMaxSmem && ctas + p.cluster <= 0x7fffffffLL;
}

}  // namespace

// bf16: q, the cache and the segments are bf16 (else fp32).  res_kind: 0 no
// residual, 1 fp32, 2 bf16; with proj the output takes the residual's dtype
// (the I/O dtype when there is none), without proj the I/O dtype.  scale is
// 1/sqrt(D), rounded to fp32 by the caller.  plan: the kPlanLen ints of
// tuning.K2Plan.as_args(), in the order of struct Plan.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const int* pos, const int* idx_i,
    const int* idx_j, const int* idx_r, const void* kmat, const void* wres,
    const void* residual, void* out, int B, int S, int H, int KH, int D, int window,
    int n_sink, int P, int R, int bn, int n_blocks, int n_cols, int proj, int bf16,
    int res_kind, float scale, const int* plan, int plan_len, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  if (plan == nullptr || plan_len != kPlanLen) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  memcpy(&p, plan, sizeof(Plan));
  const int itemsize = bf16 ? 2 : 4;
  if (B < 1 || B > 65535 || S < 1 || H < 1 || KH < 1 || H % KH != 0 || D < 1 || D > kMaxD ||
      window < 0 || n_sink < 0 || res_kind < 0 || res_kind > 2 ||
      (proj && (P < 0 || R < 0 || bn < 1 || n_blocks < 1 || n_cols < 1 ||
                n_cols > static_cast<long long>(n_blocks) * bn)) ||
      (!proj && res_kind != 0) || static_cast<long long>(S) * KH * D > 0x7fffffffLL ||
      !plan_ok(p, H, KH, D, P, R, bn, n_blocks, itemsize, proj) ||
      (B + p.slots - 1) / p.slots > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int kv16 = (D * itemsize) % 16 == 0 && aligned16(k) && aligned16(v);
  Args a{q, k, v, pos, idx_i, idx_j, idx_r, kmat, wres, residual, out,
         B, S, H, KH, D, window, n_sink, P, R, bn, n_blocks, n_cols, proj, kv16, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool out_bf16 = proj && res_kind ? res_kind == 2 : bf16;
  int err;
  if (bf16)
    err = out_bf16 ? launch_tn<__nv_bfloat16, __nv_bfloat16>(a, p, s)
                   : launch_tn<__nv_bfloat16, float>(a, p, s);
  else
    err = out_bf16 ? launch_tn<float, __nv_bfloat16>(a, p, s)
                   : launch_tn<float, float>(a, p, s);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

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
// far below the H100's ridge point, so it is bound by bytes.  The design
// keeps the attended vector out of device memory:
//
//   * Grid (column tiles, slots).  A CTA of 256 threads owns one slot and 64
//     output columns.  It runs the whole attention of its slot (all H heads)
//     itself, so the attended H*D vector lives only in its shared memory.
//     Every column tile of a slot recomputes the attention: at the serving
//     shapes the KV rows come from L2 after the first tile reads them.
//     Splitting the attention across a thread-block cluster and sharing the
//     vector through distributed shared memory is a later redesign.
//   * The cache is walked in tiles of 32 keys, one key per lane in the
//     softmax step, one softmax pass per tile: each warp scores its keys
//     against all heads (lanes across D, a warp-shuffle sum), each warp
//     then updates the running max / sum of a head (lanes across the 32
//     keys), and all threads rescale and accumulate o[h, d] with V rows read
//     along D (coalesced).  Tiles that no key of the mask reaches are skipped
//     whole, and the walk stops at the slot's position.
//   * Flush: o = acc / max(l, 1e-30), as the TPU kernel does.  With proj the
//     vector is cast to the I/O dtype and back (the TPU kernel's rounding
//     point) and stays in shared memory; each column is contracted by four
//     thread groups over interleaved lanes, reduced through shared memory,
//     the residual added in fp32, and stored once.  Gathers of o by the
//     [I | J | resid] lanes read shared memory; column-consecutive threads
//     read consecutive kmat / w_res entries.
//
// Padded lanes of the blocked layout point at row 0 and carry zero weights,
// so they add exact zeros; the short last block's padded columns are never
// stored.
//
// C interface (bound with ctypes): decode_attention_launch returns
// cudaGetLastError() after the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                  // keys per tile: one per lane
constexpr int kCols = 64;                  // output columns per CTA
constexpr int kGroups = kThreads / kCols;  // thread groups per column
constexpr int kMaxDPerLane = 8;            // head_dim <= 256
constexpr int kMaxSmem = 227 * 1024;

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
  int S, H, KH, D, window, n_sink;
  int P, R, bn, n_cols, proj;
  float scale;
};

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

// T: dtype of q, the cache and the segments; O: dtype of the output (and of
// the residual, when there is one).
template <typename T, typename O>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(Args a) {
  extern __shared__ float smem[];
  const int HD = a.H * a.D;
  float* qs = smem;                 // (H*D) the query, then the attended vector
  float* acc = qs + HD;             // (H*D) running sum of p * V
  float* sc = acc + HD;             // (H, kTile) scores, then probabilities
  float* m_s = sc + a.H * kTile;    // (H) running max
  float* l_s = m_s + a.H;           // (H) running sum of p
  float* corr = l_s + a.H;          // (H) this tile's rescale of acc and l
  float* part = corr + a.H;         // (2, kGroups, kCols) projection partials

  const int b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.H / a.KH;
  const int pos = a.pos[b];
  const int64_t row = static_cast<int64_t>(a.KH) * a.D;  // one key's stride
  const T* q = static_cast<const T*>(a.q) + static_cast<int64_t>(b) * HD;
  const T* kc = static_cast<const T*>(a.k) + static_cast<int64_t>(b) * a.S * row;
  const T* vc = static_cast<const T*>(a.v) + static_cast<int64_t>(b) * a.S * row;

  for (int i = tid; i < HD; i += kThreads) {
    qs[i] = to_f(q[i]);
    acc[i] = 0.f;
  }
  for (int h = tid; h < a.H; h += kThreads) {
    m_s[h] = -INFINITY;
    l_s[h] = 0.f;
  }
  __syncthreads();

  const int last = min(pos, a.S - 1);  // keys past the position are masked
  for (int base = 0; base <= last; base += kTile) {
    if (a.window && !(base + kTile - 1 > pos - a.window || base < a.n_sink)) continue;

    // scores: warp w scores keys base + w, base + w + kWarps, ... against
    // every head; lanes split D, a shuffle sums
    for (int j = warp; j < kTile; j += kWarps) {
      const int key = base + j;
      const bool ok = key <= last && in_window(key, pos, a.window, a.n_sink);
      for (int kh = 0; kh < a.KH; ++kh) {
        float kr[kMaxDPerLane];
#pragma unroll
        for (int t = 0; t < kMaxDPerLane; ++t) {
          const int d = lane + 32 * t;
          kr[t] = ok && d < a.D ? to_f(kc[key * row + kh * a.D + d]) : 0.f;
        }
        for (int g = 0; g < G; ++g) {
          const int h = kh * G + g;
          float s = 0.f;
#pragma unroll
          for (int t = 0; t < kMaxDPerLane; ++t) {
            const int d = lane + 32 * t;
            if (d < a.D) s = fmaf(qs[h * a.D + d], kr[t], s);
          }
          s = warp_sum(s);
          if (lane == 0) sc[h * kTile + j] = ok ? s * a.scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax: warp per head, lane per key
    for (int h = warp; h < a.H; h += kWarps) {
      const float s = sc[h * kTile + lane];
      const float m_prev = m_s[h];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float p = isfinite(s) ? expf(s - m_safe) : 0.f;
      const float c = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.f;
      const float psum = warp_sum(p);
      sc[h * kTile + lane] = p;
      if (lane == 0) {
        l_s[h] = l_s[h] * c + psum;
        m_s[h] = m_new;
        corr[h] = c;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ V, threads along (h, d)
    const int nk = min(kTile, a.S - base);
    for (int i = tid; i < HD; i += kThreads) {
      const int h = i / a.D, d = i - h * a.D;
      const T* vcol = vc + base * row + (h / G) * a.D + d;
      const float* p = sc + h * kTile;
      float pv = 0.f;
      for (int j = 0; j < nk; ++j) pv = fmaf(p[j], to_f(vcol[j * row]), pv);
      acc[i] = acc[i] * corr[h] + pv;
    }
    __syncthreads();
  }

  // flush: o = acc / max(l, 1e-30)
  O* out = static_cast<O*>(a.out);
  for (int i = tid; i < HD; i += kThreads) {
    const float o = acc[i] / fmaxf(l_s[i / a.D], 1e-30f);
    if (a.proj)
      qs[i] = to_f(from_f<T>(o));  // the attended vector at the I/O dtype
    else
      out[static_cast<int64_t>(b) * HD + i] = from_f<O>(o);
  }
  if (!a.proj) return;
  __syncthreads();

  // paired out-projection of this CTA's kCols columns: group g contracts
  // lanes g, g + kGroups, ... of each column
  const int c = tid % kCols, grp = tid / kCols;
  const int col = blockIdx.x * kCols + c;
  float yp = 0.f, yr = 0.f;
  if (col < a.n_cols) {
    const int blk = col / a.bn, cb = col - blk * a.bn;
    const int* I = a.idx_i + static_cast<int64_t>(blk) * a.P;
    const int* J = a.idx_j + static_cast<int64_t>(blk) * a.P;
    const int* Rl = a.idx_r + static_cast<int64_t>(blk) * a.R;
    const T* km = static_cast<const T*>(a.kmat) + static_cast<int64_t>(blk) * a.P * a.bn + cb;
    const T* wr = static_cast<const T*>(a.wres) + static_cast<int64_t>(blk) * a.R * a.bn + cb;
    for (int p = grp; p < a.P; p += kGroups)
      yp = fmaf(qs[I[p]] - qs[J[p]], to_f(km[static_cast<int64_t>(p) * a.bn]), yp);
    for (int r = grp; r < a.R; r += kGroups)
      yr = fmaf(qs[Rl[r]], to_f(wr[static_cast<int64_t>(r) * a.bn]), yr);
  }
  part[grp * kCols + c] = yp;
  part[(kGroups + grp) * kCols + c] = yr;
  __syncthreads();
  if (grp == 0 && col < a.n_cols) {
    float sp = 0.f, sr = 0.f;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      sp += part[g * kCols + c];
      sr += part[(kGroups + g) * kCols + c];
    }
    float y = sp + sr;
    const int64_t o = static_cast<int64_t>(b) * a.n_cols + col;
    if (a.residual) y += to_f(static_cast<const O*>(a.residual)[o]);
    out[o] = from_f<O>(y);
  }
}

template <typename T, typename O>
cudaError_t launch(const Args& a, int B, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attention_kernel<T, O>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const unsigned tiles = a.proj ? static_cast<unsigned>((a.n_cols + kCols - 1) / kCols) : 1u;
  decode_attention_kernel<T, O><<<dim3(tiles, B), kThreads, smem, stream>>>(a);
  return cudaSuccess;
}

}  // namespace

// bf16: q, the cache and the segments are bf16 (else fp32).  res_kind: 0 no
// residual, 1 fp32, 2 bf16; with proj the output takes the residual's dtype
// (the I/O dtype when there is none), without proj the I/O dtype.  scale is
// 1/sqrt(D), rounded to fp32 by the caller.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const int* pos, const int* idx_i,
    const int* idx_j, const int* idx_r, const void* kmat, const void* wres,
    const void* residual, void* out, int B, int S, int H, int KH, int D, int window,
    int n_sink, int P, int R, int bn, int n_cols, int proj, int bf16, int res_kind,
    float scale, void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  if (B < 1 || B > 65535 || S < 1 || H < 1 || KH < 1 || H % KH != 0 || D < 1 ||
      D > 32 * kMaxDPerLane || window < 0 || n_sink < 0 || res_kind < 0 || res_kind > 2 ||
      (proj && (P < 0 || R < 0 || bn < 1 || n_cols < 1)) || (!proj && res_kind != 0) ||
      static_cast<long long>(S) * KH * D > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      sizeof(float) * (2 * static_cast<size_t>(H) * D + static_cast<size_t>(H) * kTile +
                       3 * static_cast<size_t>(H) + 2 * kGroups * kCols);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, pos, idx_i, idx_j, idx_r, kmat, wres, residual, out,
         S, H, KH, D, window, n_sink, P, R, bn, n_cols, proj, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool out_bf16 = proj && res_kind ? res_kind == 2 : bf16;
  cudaError_t e;
  if (bf16)
    e = out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(a, B, smem, s)
                 : launch<__nv_bfloat16, float>(a, B, smem, s);
  else
    e = out_bf16 ? launch<float, __nv_bfloat16>(a, B, smem, s)
                 : launch<float, float>(a, B, smem, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

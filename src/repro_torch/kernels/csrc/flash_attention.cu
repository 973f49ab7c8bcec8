// Flash-attention forward (GQA, causal or full), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// _flash_fwd_kernel (reached from flash_attention_fwd).  For q (B, Sq, H, D)
// and k, v (B, Sk, KH, D), query head h reads KV head h / G (G = H / KH):
//
//   s[i, j] = (q[i] . k[j]) * scale       q, k, v cast to fp32 first;
//                                          scale = 1/sqrt(D), an fp32
//   live    = j < Sk and (not causal or j <= i)   (top-left: i and j both
//                                          counted from 0, also when Sq != Sk)
//   o[i]    = softmax over live j of s[i, :] @ v   online, fp32; p stays fp32
//   out[i]  = acc / max(l, 1e-30), stored once in q's dtype at (B, Sq, H, D)
//
// What bounds it on this card.  Attention over S keys does 4·S·D FLOP per
// query row and reads each q, k, v row once: at qwen2's head_dim of 128 and
// S = 2048 that is about 900 FLOP per byte, far above the ridge point, so
// the work is bound by operations.  This kernel does them with fp32 FMAs on
// the CUDA cores (67 TFLOP/s peak), not on the tensor cores (989 TFLOP/s in
// bf16): the TPU kernel keeps p in fp32 for the PV product, and a first port
// keeps that rounding point.  The design is the simple one that is right:
//
//   * Grid (64-query tiles, H, B); a CTA of 256 threads owns one head of 64
//     query rows, four threads per row.  A thread keeps its quarter of the
//     row's q and of the running acc in registers (D/4 floats each, as
//     float4 slices interleaved across the four threads, so a warp's
//     shared-memory reads of one K or V row hit distinct banks), and the
//     row's running max m and sum l.
//   * The CTA walks 64-key tiles of its KV head: K and V tiles are staged in
//     dynamic shared memory as fp32 (2 * 64 * D * 4 bytes: 64 KB at D = 128,
//     above the 48 KB default, so the launch raises the limit).  Each thread
//     scores all 64 keys of the tile against its quarter of q, two
//     warp shuffles sum the quarters, and the row's 64 scores stay in
//     registers for the online-softmax update and the PV product.
//   * The causal walk stops at min(Sk, the tile's last row + 1); keys past
//     Sk and past the row are masked to -inf, and the guards of the TPU
//     kernel (m_safe, isfinite(s), the correction term) keep a row without a
//     live key in a tile finite.  Rows past Sq are computed on zeros and
//     never stored, so the host pads nothing.
//   * q, k and v are read through their (batch, seq, head) strides, the head
//     dimension contiguous.
//
// Later redesigns: wgmma on bf16 tiles, TMA loads in a ring of stages, and
// one K/V tile shared by the G query heads of a KV head.
//
// C interface (bound with ctypes): flash_attention_launch returns
// cudaGetLastError() after the launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                 // query rows per CTA
constexpr int kKeys = 64;                 // keys per tile
constexpr int kParts = 4;                 // threads per query row
constexpr int kThreads = kRows * kParts;  // 256

struct Args {
  const void* q;  // (B, Sq, H, D) at strides (sqb, sqs, sqh, 1)
  const void* k;  // (B, Sk, KH, D) at strides (skb, sks, skh, 1)
  const void* v;  // (B, Sk, KH, D) at strides (svb, svs, svh, 1)
  void* out;      // (B, Sq, H, D) contiguous, q's dtype
  int Sq, Sk, H, KH;
  int64_t sqb, sqs, sqh, skb, sks, skh, svb, svs, svh;
  int causal;
  float scale;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// A thread's slice of a D-wide row: kNV vectors of kW floats; vector n of
// part t starts at dim kW * (t + kParts * n).
template <int D> struct Slice {
  static constexpr int kDPT = D / kParts;
  static constexpr int kW = kDPT < 4 ? kDPT : 4;
  static constexpr int kNV = kDPT / kW;
  static __device__ __forceinline__ int dim(int part, int n) { return kW * (part + kParts * n); }
};

// kW consecutive floats of shared memory (aligned to kW * 4 bytes).
template <int W> __device__ __forceinline__ void lds(const float* p, float (&x)[W]);
template <> __device__ __forceinline__ void lds<4>(const float* p, float (&x)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
}
template <> __device__ __forceinline__ void lds<2>(const float* p, float (&x)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  x[0] = t.x; x[1] = t.y;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(Args a) {
  using S = Slice<D>;
  extern __shared__ float smem[];
  float* ks = smem;              // (kKeys, D) this tile's keys, fp32
  float* vs = smem + kKeys * D;  // (kKeys, D) this tile's values, fp32

  const int tid = threadIdx.x, part = tid % kParts;
  const int q0 = blockIdx.x * kRows, row = q0 + tid / kParts;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KH);
  const T* kb = static_cast<const T*>(a.k) + b * a.skb + kvh * a.skh;
  const T* vb = static_cast<const T*>(a.v) + b * a.svb + kvh * a.svh;

  float q[S::kNV][S::kW], acc[S::kNV][S::kW];
  {
    const T* qr = static_cast<const T*>(a.q) + b * a.sqb + h * a.sqh;
#pragma unroll
    for (int n = 0; n < S::kNV; ++n)
#pragma unroll
      for (int c = 0; c < S::kW; ++c) {
        q[n][c] = row < a.Sq ? to_f(qr[row * a.sqs + S::dim(part, n) + c]) : 0.f;
        acc[n][c] = 0.f;
      }
  }
  float m = -INFINITY, l = 0.f;

  // causal: no row of this tile sees a key at or past its last row + 1
  const int k_end = a.causal ? min(a.Sk, min(q0 + kRows, a.Sq)) : a.Sk;
  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kKeys * D; i += kThreads) {
      const int j = i / D, d = i - j * D, key = k0 + j;
      const bool in = key < a.Sk;
      ks[i] = in ? to_f(kb[key * a.sks + d]) : 0.f;
      vs[i] = in ? to_f(vb[key * a.svs + d]) : 0.f;
    }
    __syncthreads();

    // scores of the row against the tile's keys
    float s[kKeys];
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int n = 0; n < S::kNV; ++n) {
        float kv[S::kW];
        lds<S::kW>(ks + j * D + S::dim(part, n), kv);
#pragma unroll
        for (int c = 0; c < S::kW; ++c) dot = fmaf(q[n][c], kv[c], dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int key = k0 + j;
      const bool live = key < a.Sk && (!a.causal || key <= row);
      s[j] = live ? dot * a.scale : -INFINITY;
    }

    // online softmax, the TPU kernel's guards
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) m_tile = fmaxf(m_tile, s[j]);
    const float m_new = fmaxf(m, m_tile);
    const float m_safe = isfinite(m_new) ? m_new : 0.f;
    const float corr = isfinite(m) ? expf(m - m_safe) : 0.f;
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      s[j] = isfinite(s[j]) ? expf(s[j] - m_safe) : 0.f;
      p_sum += s[j];
    }
    l = l * corr + p_sum;
    m = m_new;

    // acc = acc * corr + p @ V, p in fp32
#pragma unroll
    for (int n = 0; n < S::kNV; ++n)
#pragma unroll
      for (int c = 0; c < S::kW; ++c) acc[n][c] *= corr;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
#pragma unroll
      for (int n = 0; n < S::kNV; ++n) {
        float vv[S::kW];
        lds<S::kW>(vs + j * D + S::dim(part, n), vv);
#pragma unroll
        for (int c = 0; c < S::kW; ++c) acc[n][c] = fmaf(s[j], vv[c], acc[n][c]);
      }
    }
  }

  if (row >= a.Sq) return;
  const float den = fmaxf(l, 1e-30f);
  T* o = static_cast<T*>(a.out) + ((static_cast<int64_t>(b) * a.Sq + row) * a.H + h) * D;
#pragma unroll
  for (int n = 0; n < S::kNV; ++n)
#pragma unroll
    for (int c = 0; c < S::kW; ++c) o[S::dim(part, n) + c] = from_f<T>(acc[n][c] / den);
}

template <typename T, int D>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = 2 * sizeof(float) * kKeys * D;
  if (smem > 48 * 1024) {
    // once per instantiation (thread-safe static init), so that a launch
    // captured in a CUDA graph makes no attribute call
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return attr;
  }
  const dim3 grid((a.Sq + kRows - 1) / kRows, a.H, B);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_d(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 8: return launch<T, 8>(a, B, stream);
    case 16: return launch<T, 16>(a, B, stream);
    case 32: return launch<T, 32>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16: q, k, v and the output are bf16 (else fp32).  Strides are in
// elements; the head dimension is contiguous.  scale is 1/sqrt(D), rounded
// to fp32 by the caller.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int B, int Sq, int Sk, int H,
    int KH, int D, int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb, int64_t sks,
    int64_t skh, int64_t svb, int64_t svs, int64_t svh, int causal, int bf16, float scale,
    void* stream) {
  cudaGetLastError();  // clear a stale error so the return value is this launch's
  if (B < 1 || B > 65535 || Sq < 1 || Sk < 1 || H < 1 || H > 65535 || KH < 1 ||
      H % KH != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q, k, v, out, Sq, Sk, H, KH, sqb, sqs, sqh, skb, sks, skh, svb, svs, svh,
         causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = bf16 ? launch_d<__nv_bfloat16>(a, B, D, s) : launch_d<float>(a, B, D, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

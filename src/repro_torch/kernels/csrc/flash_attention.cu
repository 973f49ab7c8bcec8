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
// the work is bound by operations: by the tensor cores (989 TFLOP/s in
// bf16) where the inputs allow them.  Two forms, chosen by the entry point
// from (dtype, D) (flash_attention.py: kernel_form names the same choice):
//
// * tensor-core form (bf16, D in {16, 32, 64, 128}).  A CTA of two
//   warpgroups serves two query heads of one KV head (GQA: both read the
//   same K/V tiles) over the same 64 query rows; a third head of an odd G
//   leaves its warpgroup idle.  Each warpgroup:
//     - keeps its 64 x D Q tile in shared memory, loaded once;
//     - computes S = Q K^T with wgmma m64n64k16 (fp32 accumulators; a
//       bf16 x bf16 product is exact in fp32, as the TPU kernel's fp32 dot
//       of the cast inputs);
//     - runs the online softmax in registers in the accumulator layout (a
//       thread holds two rows' values; row max and sum by quad shuffles),
//       in the log2 domain: s2 = dot * (scale * log2 e), p = exp2f(s2 - m2),
//       corr = exp2f(m2_old - m2_safe), which is exp(s - m) of the TPU
//       kernel up to exp2f's rounding; the m_safe, isfinite(s) and corr
//       guards are the TPU kernel's;
//     - keeps p in fp32 for PV, as the TPU kernel does: p is split in
//       registers into p_hi = bf16(p) and p_lo = bf16(p - p_hi) (relative
//       error about 2^-17, far inside the bf16 output's half ulp), and
//       O += p_hi V + p_lo V runs as two wgmma m64nDk16 with A from
//       registers (S's accumulator fragment is the A-fragment layout) and V
//       MN-major (transposed B) from shared memory.
//   K and V tiles of 64 keys pass through a ring of 2 stages as 16-byte
//   cp.async copies into 128-byte-swizzled bf16 tiles, the layout wgmma's
//   descriptors read: the next tile is in flight while the current one
//   computes.  K/V are never staged as fp32.  Keys past Sk are zero-filled
//   and masked by key < Sk; causal tiles wholly above the diagonal are
//   skipped and only tiles that cross it (or Sk) are masked; q-tiles are
//   launched heaviest first (reversed index).  Rows past Sq are zero-filled
//   and never stored.  D < 64 pads the tiles to 64 columns in shared memory:
//   QK^T issues only D/16 k-steps, and PV's padded output columns (from
//   unread V columns) are never stored.
// * FMA form (fp32, and bf16 at D = 8, below wgmma's depth of 16; TF32
//   would break the fp32 gate).  Grid (64-query tiles, H, B); a CTA of 256
//   threads owns one head of 64 query rows, four threads per row, each
//   keeping a quarter of the row's q and acc in registers; 64-key tiles are
//   staged in shared memory as fp32 and the row's 64 scores stay in
//   registers; fp32 FMAs on the CUDA cores (67 TFLOP/s peak).
//
// q, k and v are read through their (batch, seq, head) strides, the head
// dimension contiguous (the tensor-core form needs 16-byte-aligned rows:
// strides that are multiples of 8 and aligned pointers; the entry point
// refuses others and the wrapper copies them first).
//
// C interface (bound with ctypes): flash_attention_launch returns
// cudaGetLastError() after the launch, 0 on success, cudaErrorInvalidValue
// for a shape out of range (nothing is launched then).

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

// ---------------------------------------------------------------------------
// FMA form (fp32; bf16 at D = 8)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel_fma(Args a) {
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

// ---------------------------------------------------------------------------
// tensor-core form (bf16, D a multiple of 16)
// ---------------------------------------------------------------------------

constexpr int kTcRows = 64;              // query rows of a warpgroup (wgmma's M)
constexpr int kTcKeys = 64;              // keys a tile (S's N, PV's K)
constexpr int kTcHeads = 2;              // warpgroups a CTA: query heads of one KV head
constexpr int kTcThreads = 128 * kTcHeads;
constexpr int kTcStages = 2;             // K/V ring depth
constexpr int kAtom = 64 * 128;          // 64 rows of one 128-byte swizzle atom, bytes

__host__ __device__ constexpr int tc_width(int d) { return d < 64 ? 64 : d; }  // padded D
// dynamic shared memory of the tensor-core form: Q of each warpgroup, then
// the ring's K and V tiles, plus 1 KB to align the tiles to 1024 bytes
__host__ __device__ constexpr int tc_smem(int d) {
  return (kTcHeads + 2 * kTcStages) * (tc_width(d) / 64) * kAtom + 1024;
}

// Byte offset of 16-byte chunk c (of 8 bf16) of row r in a tile of 64-column
// atoms (128-byte rows, 64 rows an atom), swizzled as wgmma's 128B mode reads
// it: chunk c % 8 of row r lands at chunk (c % 8) ^ (r % 8).
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 3) * kAtom + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (given in bytes, encoded in 16-byte units).
// K-major tiles (Q, K) step 8-row groups by the stride offset (1024 bytes);
// MN-major V steps them by the stride offset too and its 64-column atoms by
// the leading offset.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D(64x64) (+)= A(64x16, shared, K-major) * B(16x64, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64x64) += A(64x16, registers) * B(16x64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64x128) += A(64x16, registers) * B(16x128, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2], const uint32_t (&a)[4], uint64_t dv) {
  if constexpr (DP == 64) wgmma_rs_n64(o, a, dv); else wgmma_rs_n128(o, a, dv);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1) flash_attention_kernel_tc(Args a) {
  constexpr int DP = tc_width(D), CH = D / 8;   // padded width; 16-byte chunks of a row
  constexpr int TILE = (DP / 64) * kAtom;       // bytes of one 64-row tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t q_s = base;                    // [kTcHeads] Q tiles
  const uint32_t kv_s = base + kTcHeads * TILE; // [kTcStages][K, V] tiles

  const int tid = threadIdx.x, wg = tid >> 7, w = (tid & 127) >> 5, lane = tid & 31;
  const int G = a.H / a.KH, pairs = (G + kTcHeads - 1) / kTcHeads;
  const int kvh = blockIdx.y / pairs, g0 = (blockIdx.y - kvh * pairs) * kTcHeads;
  const int b = blockIdx.z;
  const int nq = (a.Sq + kTcRows - 1) / kTcRows;
  // causal: the longest q-tiles (the last) are launched first
  const int q0 = (a.causal ? nq - 1 - static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x)) * kTcRows;
  const int k_end = a.causal ? min(a.Sk, min(q0 + kTcRows, a.Sq)) : a.Sk;
  const int nt = (k_end + kTcKeys - 1) / kTcKeys;
  const bool active = g0 + wg < G;  // uniform over the warpgroup
  const int h = kvh * G + g0 + wg;

  using bf = __nv_bfloat16;
  const bf* qb = static_cast<const bf*>(a.q) + b * a.sqb;
  const bf* kb = static_cast<const bf*>(a.k) + b * a.skb + kvh * a.skh;
  const bf* vb = static_cast<const bf*>(a.v) + b * a.svb + kvh * a.svh;

  // Q of both heads, rows past Sq (and an idle head) zero-filled
  for (int i = tid; i < kTcHeads * kTcRows * CH; i += kTcThreads) {
    const int hh = i / (kTcRows * CH), rem = i - hh * (kTcRows * CH);
    const int r = rem / CH, c = rem - r * CH, row = q0 + r;
    const bool in = g0 + hh < G && row < a.Sq;
    const bf* src = qb + c * 8 + (in ? row * a.sqs + (kvh * G + g0 + hh) * a.sqh : 0);
    cp_async16(q_s + hh * TILE + swz(r, c), src, in);
  }
  // one K/V tile into a ring stage, keys past Sk zero-filled
  auto load_kv = [&](int tile, int stage) {
    const uint32_t ks = kv_s + stage * 2 * TILE, vs = ks + TILE;
    const int k0 = tile * kTcKeys;
    for (int i = tid; i < kTcKeys * CH; i += kTcThreads) {
      const int r = i / CH, c = i - r * CH, key = k0 + r;
      const bool in = key < a.Sk;
      const int64_t kk = in ? key : 0;
      cp_async16(ks + swz(r, c), kb + kk * a.sks + c * 8, in);
      cp_async16(vs + swz(r, c), vb + kk * a.svs + c * 8, in);
    }
  };
  load_kv(0, 0);
  cp_async_commit();

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  // a thread's rows in the accumulator layout: row0 and row0 + 8; its
  // columns of each 8-column block: col0 and col0 + 1
  const int row0 = q0 + 16 * w + (lane >> 2), col0 = 2 * (lane & 3);
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};  // l: this thread's columns
  const float scale_log2 = a.scale * 1.4426950408889634f;

  for (int it = 0; it < nt; ++it) {
    const int st = it & 1;
    if (it + 1 < nt) {  // the next tile flies while this one computes
      load_kv(it + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // this thread's copies are done; make them visible to wgmma (async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (active) {
      const uint32_t ks = kv_s + st * 2 * TILE, vs = ks + TILE, qs = q_s + wg * TILE;
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {  // S = Q K^T over D in k-steps of 16
        const uint32_t off = (k >> 2) * kAtom + (k & 3) * 32;
        wgmma_ss_n64(s, desc(qs + off, 16, 1024), desc(ks + off, 16, 1024), k);
      }
      wgmma_commit();
      wgmma_wait0();

      // mask (tiles crossing the diagonal or Sk only), row max by quad shuffles
      const int k0 = it * kTcKeys;
      const bool edge = k0 + kTcKeys > a.Sk || (a.causal && k0 + kTcKeys - 1 > q0);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = s[4 * j + e] * scale_log2;
          if (edge) {
            const int key = k0 + 8 * j + col0 + (e & 1), row = row0 + 8 * (e >> 1);
            if (key >= a.Sk || (a.causal && key > row)) v = -INFINITY;
          }
          s[4 * j + e] = v;
          mx[e >> 1] = fmaxf(mx[e >> 1], v);
        }
      float corr[2], m_safe[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_r[r], mx[r]);
        m_safe[r] = isfinite(m_new) ? m_new : 0.f;
        corr[r] = isfinite(m_r[r]) ? exp2f(m_r[r] - m_safe[r]) : 0.f;
        m_r[r] = m_new;
        l_r[r] *= corr[r];
      }
      // p in fp32, split into bf16 hi + lo A-fragments: keys 16kk + [0, 8)
      // are registers 0 (row0) and 1 (row0 + 8), keys 16kk + [8, 16) 2 and 3
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p[4], r[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[4 * j + e];
          p[e] = isfinite(x) ? exp2f(x - m_safe[e >> 1]) : 0.f;
          l_r[e >> 1] += p[e];
          r[e] = p[e] - __bfloat162float(__float2bfloat16_rn(p[e]));
        }
        const int kk = j >> 1, hf = (j & 1) * 2;
        hi[kk][hf] = pack_bf16(p[0], p[1]);
        hi[kk][hf + 1] = pack_bf16(p[2], p[3]);
        lo[kk][hf] = pack_bf16(r[0], r[1]);
        lo[kk][hf + 1] = pack_bf16(r[2], r[3]);
      }
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
      // O += p_hi V + p_lo V: V MN-major, 8-key groups 1024 bytes apart,
      // 64-column atoms kAtom apart
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcKeys / 16; ++kk) {
        const uint64_t dv = desc(vs + kk * 16 * 128, kAtom, 1024);
        wgmma_pv<DP>(o, hi[kk], dv);
        wgmma_pv<DP>(o, lo[kk], dv);
      }
      wgmma_commit();
      wgmma_wait0();
    }
    __syncthreads();  // the stage is free for the tile after next
  }
  if (!active) return;

  // flush: acc / max(l, 1e-30), once, in bf16; rows past Sq are not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.Sq) continue;
    const float den = fmaxf(l_r[r], 1e-30f);
    bf* out = static_cast<bf*>(a.out) + ((static_cast<int64_t>(b) * a.Sq + row) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      if (8 * j < D)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + col0) =
            __floats2bfloat162_rn(o[4 * j + 2 * r] / den, o[4 * j + 2 * r + 1] / den);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// The shared-memory limit is raised once per instance (thread-safe static
// init), so that a launch captured in a CUDA graph makes no attribute call.
template <typename T, int D>
cudaError_t launch_fma(const Args& a, int B, cudaStream_t stream) {
  constexpr size_t smem = 2 * sizeof(float) * kKeys * D;
  if (smem > 48 * 1024) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_attention_kernel_fma<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return attr;
  }
  const dim3 grid((a.Sq + kRows - 1) / kRows, a.H, B);
  flash_attention_kernel_fma<T, D><<<grid, kThreads, smem, stream>>>(a);
  return cudaSuccess;
}

template <int D>
cudaError_t launch_tc(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = tc_smem(D);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int pairs = (a.H / a.KH + kTcHeads - 1) / kTcHeads;
  const dim3 grid((a.Sq + kTcRows - 1) / kTcRows, a.KH * pairs, B);
  flash_attention_kernel_tc<D><<<grid, kTcThreads, smem, stream>>>(a);
  return cudaSuccess;
}

cudaError_t launch_fma_d(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 8: return launch_fma<float, 8>(a, B, stream);
    case 16: return launch_fma<float, 16>(a, B, stream);
    case 32: return launch_fma<float, 32>(a, B, stream);
    case 64: return launch_fma<float, 64>(a, B, stream);
    case 128: return launch_fma<float, 128>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

// bf16: the tensor-core form at D a multiple of 16, the FMA form at D = 8
cudaError_t launch_bf16_d(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 8: return launch_fma<__nv_bfloat16, 8>(a, B, stream);
    case 16: return launch_tc<16>(a, B, stream);
    case 32: return launch_tc<32>(a, B, stream);
    case 64: return launch_tc<64>(a, B, stream);
    case 128: return launch_tc<128>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// bf16: q, k, v and the output are bf16 (else fp32); bf16 at D a multiple
// of 16 runs the tensor-core form, which needs 16-byte-aligned rows.
// Strides are in elements; the head dimension is contiguous.  scale is
// 1/sqrt(D), rounded to fp32 by the caller.
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
  if (bf16 && D % 16 == 0 &&
      (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out) ||
       (sqb | sqs | sqh | skb | sks | skh | svb | svs | svh) % 8 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q, k, v, out, Sq, Sk, H, KH, sqb, sqs, sqh, skb, sks, skh, svb, svs, svh,
         causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = bf16 ? launch_bf16_d(a, B, D, s) : launch_fma_d(a, B, D, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

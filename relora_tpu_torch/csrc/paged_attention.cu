// Paged attention straight out of the KV page pool, for sm_90a.
//
// Two kernels share one block body:
//
//   paged_decode_kernel  replaces relora_tpu/ops/attention.py:244
//                        _paged_decode_kernel (paged_decode_attention, :331):
//                        small-S decode/verify attention, q (B, S, N, H), S <= 16.
//   packed_paged_kernel  replaces relora_tpu/ops/attention.py:447
//                        _packed_paged_kernel (packed_paged_attention, :532):
//                        the same per packed token, q (1, T, N, H), with row_map
//                        (T,) picking each token's block-table row.
//
// Design.  One CUDA block per (query row or packed token, kv_head).  The block
// holds the g*S queries of its kv-head group (g = N / n_kv; S = 1 for packed
// tokens) head-major, as the TPU kernel lays them out.  On the TPU the grid
// walks the W pages of a row in order and carries the online-softmax state
// (m, l, acc) across grid steps; Hopper runs blocks in no order, so the page
// walk is a loop inside the block.  The block stops after the last page any of
// its queries can see: a fully masked page adds exactly 0 to the online
// softmax (m unchanged, alpha = 1, p = 0), so stopping early is exact.  Per
// page, K and V of the block's kv head are staged in shared memory as f32
// (int8 codes dequantised by the page's (page, kv_head) scale), scores and the
// softmax update are f32, and the output is written in q's dtype.  Masked
// logits are -1e30 and p is masked too, not only the logits; the final
// division is guarded by max(l, 1e-30) so pad rows stay finite.
//
// Bound.  Memory-bound: the work per K/V byte is 2 flops per query of the
// group, far below the H100's ~295 flops/byte balance point.  The least time
// is the bytes of the K/V pages the blocks must read (plus q, out, tables)
// over 3.35 TB/s.  This first version is written to be right, not fast: it
// stages each page with plain loads and computes dot products with scalar
// FMAs; making it reach the bound is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kMasked = -1e30f;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

__device__ __forceinline__ void store_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store_f32(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

struct Args {
  const void* q;          // (R, S, N, H) in TQ
  const void* pool_k;     // (P, ps, n_kv, H) in TKV
  const void* pool_v;
  const int32_t* bt;      // (rows, W) block tables
  const int32_t* row_map; // (R,) table row per query row, or null (row = r)
  const int32_t* pos;     // (R, S) absolute positions
  const float* k_scale;   // (P, n_kv) or null (unquantised)
  const float* v_scale;
  void* out;              // (R, S, N, H) in TQ
  int S, N, n_kv, H, W, ps;
  float sm_scale;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory, in floats: q (G*H), K page (ps*H), V page (ps*H),
// scores/probabilities (G*ps), acc (G*H), m, l, alpha (G each), then G ints
// of query positions.
__host__ __device__ inline size_t smem_bytes(int G, int H, int ps) {
  return sizeof(float) * (2 * (size_t)G * H + 2 * (size_t)ps * H + (size_t)G * ps + 3 * (size_t)G) +
         sizeof(int) * (size_t)G;
}

template <typename TQ, typename TKV>
__device__ void attend_pages(const Args& a) {
  extern __shared__ float smem[];
  __shared__ int n_walk;
  const int r = blockIdx.x;
  const int j = blockIdx.y;
  const int H = a.H, ps = a.ps, S = a.S;
  const int g = a.N / a.n_kv;
  const int G = g * S;
  const int tid = threadIdx.x;

  float* qs = smem;
  float* ks = qs + G * H;
  float* vs = ks + ps * H;
  float* sc = vs + ps * H;
  float* acc = sc + G * ps;
  float* m = acc + G * H;
  float* l = m + G;
  float* alpha = l + G;
  int* qpos = reinterpret_cast<int*>(alpha + G);

  const TQ* q = static_cast<const TQ*>(a.q);
  // query qi = h*S + s holds token s of head j*g + h (head-major group block)
  for (int idx = tid; idx < G * H; idx += blockDim.x) {
    const int qi = idx / H, d = idx % H;
    const int h = qi / S, s = qi % S;
    qs[idx] = to_f32(q[((size_t)(r * S + s) * a.N + j * g + h) * H + d]);
    acc[idx] = 0.f;
  }
  for (int qi = tid; qi < G; qi += blockDim.x) {
    qpos[qi] = a.pos[r * S + qi % S];
    m[qi] = kMasked;
    l[qi] = 0.f;
  }
  if (tid == 0) {
    int mx = -1;
    for (int s = 0; s < S; ++s) mx = max(mx, a.pos[r * S + s]);
    n_walk = mx < 0 ? 0 : min(a.W, mx / ps + 1);
  }
  __syncthreads();

  const int row = a.row_map ? a.row_map[r] : r;
  const int32_t* bt_row = a.bt + (size_t)row * a.W;
  const TKV* pk = static_cast<const TKV*>(a.pool_k);
  const TKV* pv = static_cast<const TKV*>(a.pool_v);
  const int warp = tid / 32, lane = tid % 32, n_warps = blockDim.x / 32;

  for (int w = 0; w < n_walk; ++w) {
    const int page = bt_row[w];
    const float kscale = a.k_scale ? a.k_scale[(size_t)page * a.n_kv + j] : 1.f;
    const float vscale = a.v_scale ? a.v_scale[(size_t)page * a.n_kv + j] : 1.f;
    for (int idx = tid; idx < ps * H; idx += blockDim.x) {
      const int i = idx / H, d = idx % H;
      const size_t off = (((size_t)page * ps + i) * a.n_kv + j) * H + d;
      ks[idx] = to_f32(pk[off]) * kscale;
      vs[idx] = to_f32(pv[off]) * vscale;
    }
    __syncthreads();

    for (int idx = tid; idx < G * ps; idx += blockDim.x) {
      const int qi = idx / ps, i = idx % ps;
      float dot = 0.f;
      for (int d = 0; d < H; ++d) dot = fmaf(qs[qi * H + d], ks[i * H + d], dot);
      sc[idx] = (w * ps + i <= qpos[qi]) ? dot * a.sm_scale : kMasked;
    }
    __syncthreads();

    // online-softmax update, one warp per query row
    for (int qi = warp; qi < G; qi += n_warps) {
      float mx = kMasked;
      for (int i = lane; i < ps; i += 32) mx = fmaxf(mx, sc[qi * ps + i]);
      mx = warp_max(mx);
      const float m_prev = m[qi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int i = lane; i < ps; i += 32) {
        const float p = (w * ps + i <= qpos[qi]) ? expf(sc[qi * ps + i] - m_new) : 0.f;
        sc[qi * ps + i] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float al = expf(m_prev - m_new);
        alpha[qi] = al;
        l[qi] = l[qi] * al + sum;
        m[qi] = m_new;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < G * H; idx += blockDim.x) {
      const int qi = idx / H, d = idx % H;
      float pvsum = 0.f;
      for (int i = 0; i < ps; ++i) pvsum = fmaf(sc[qi * ps + i], vs[i * H + d], pvsum);
      acc[idx] = acc[idx] * alpha[qi] + pvsum;
    }
    __syncthreads();
  }

  TQ* out = static_cast<TQ*>(a.out);
  for (int idx = tid; idx < G * H; idx += blockDim.x) {
    const int qi = idx / H, d = idx % H;
    const int h = qi / S, s = qi % S;
    store_f32(acc[idx] / fmaxf(l[qi], 1e-30f),
              &out[((size_t)(r * S + s) * a.N + j * g + h) * H + d]);
  }
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(Args a) {
  attend_pages<TQ, TKV>(a);
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) packed_paged_kernel(Args a) {
  attend_pages<TQ, TKV>(a);
}

template <typename TQ, typename TKV>
int launch(bool packed, const Args& a, int R, cudaStream_t stream) {
  const int G = (a.N / a.n_kv) * a.S;
  const size_t smem = smem_bytes(G, a.H, a.ps);
  void (*kern)(Args) = packed ? packed_paged_kernel<TQ, TKV> : paged_decode_kernel<TQ, TKV>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(R, a.n_kv);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16, 2 = int8 (pool only)
template <typename TQ>
int launch_kv(int kv_dtype, bool packed, const Args& a, int R, cudaStream_t stream) {
  switch (kv_dtype) {
    case 0: return launch<TQ, float>(packed, a, R, stream);
    case 1: return launch<TQ, __nv_bfloat16>(packed, a, R, stream);
    case 2: return launch<TQ, int8_t>(packed, a, R, stream);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_any(int q_dtype, int kv_dtype, bool packed, const Args& a, int R,
               cudaStream_t stream) {
  if (R == 0) return (int)cudaSuccess;
  switch (q_dtype) {
    case 0: return launch_kv<float>(kv_dtype, packed, a, R, stream);
    case 1: return launch_kv<__nv_bfloat16>(kv_dtype, packed, a, R, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

size_t paged_attention_smem_bytes(int G, int H, int ps) { return smem_bytes(G, H, ps); }

const char* paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, S, N, H); bt (B, W); pos (B, S); out (B, S, N, H)
int paged_decode_attention_launch(const void* q, const void* pool_k, const void* pool_v,
                                  const int32_t* bt, const int32_t* pos,
                                  const float* k_scale, const float* v_scale, void* out,
                                  int B, int S, int N, int n_kv, int H, int W, int ps,
                                  float sm_scale, int q_dtype, int kv_dtype, void* stream) {
  Args a{q, pool_k, pool_v, bt, nullptr, pos, k_scale, v_scale, out,
         S, N, n_kv, H, W, ps, sm_scale};
  return launch_any(q_dtype, kv_dtype, false, a, B, static_cast<cudaStream_t>(stream));
}

// q (T, N, H); bt (rows, W); row_map (T,); pos (T,); out (T, N, H)
int packed_paged_attention_launch(const void* q, const void* pool_k, const void* pool_v,
                                  const int32_t* bt, const int32_t* row_map,
                                  const int32_t* pos, const float* k_scale,
                                  const float* v_scale, void* out, int T, int N, int n_kv,
                                  int H, int W, int ps, float sm_scale, int q_dtype,
                                  int kv_dtype, void* stream) {
  Args a{q, pool_k, pool_v, bt, row_map, pos, k_scale, v_scale, out,
         1, N, n_kv, H, W, ps, sm_scale};
  return launch_any(q_dtype, kv_dtype, true, a, T, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

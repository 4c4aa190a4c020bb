// Causal flash attention, forward and backward, for sm_90a.
//
// Replaces the TPU flash kernel that relora_tpu/ops/attention.py:84
// (_pallas_attention) reaches through JAX's Pallas library
// (jax/experimental/pallas/ops/tpu/flash_attention.py: _flash_attention_impl,
// _flash_attention_bwd_dkv, _flash_attention_bwd_dq):
//
//   flash_fwd_kernel       out (B, S, N, H) and lse (B, N, S) f32
//   flash_bwd_dkdv_kernel  dK, dV (B, S, n_kv, H)
//   flash_bwd_dq_kernel    dQ (B, S, N, H)
//
// q is (B, S, N, H), k and v are (B, S, n_kv, H) with N a multiple of n_kv
// (grouped-query attention: query head h reads kv head h / (N / n_kv)), all in
// f32 or bf16; the softmax scale is given.  Key j is visible to query i iff
// j <= i.  The backward takes the forward's lse and delta = rowsum(dO * O)
// (B, N, S) f32, so neither backward kernel needs the forward's output.
//
// Design.  Tiles of 64 query rows and 64 key rows.  One block of 256 threads
// owns one output tile and loops over the tiles it needs, keeping its running
// state on chip: the forward block (b, head, query tile) walks the key tiles
// up to the diagonal with an online softmax (m, l and the output accumulator in
// registers); the dK/dV block (b, kv head, key tile) walks, for each of the g
// query heads of its group, the query tiles from the diagonal down, recomputes
// P from lse and sums dK and dV in registers, so no two blocks write the same
// output and no atomics are needed; the dQ block (b, head, query tile) walks
// the key tiles up to the diagonal.  Tiles above the diagonal are never
// visited.  Rows and columns past S are masked, so any S works.  Tiles are
// staged in shared memory as f32 with a row stride of H + 1 (conflict-free
// column reads); each thread computes a 4 x 4 block of scores and a 4 x H/16
// block of the output with f32 FMAs, and reductions over a score row run
// across the 16 lanes of a half-warp.
//
// Bound.  At llama_250m training shapes (S = 512, H = 48) the work is
// 2 B N S^2 H causal flops forward and 5 B N S^2 H backward, against 2 bytes
// for each element of q, k, v and out (and dO, dq, dk, dv backward): S / 4 =
// 128 flops per byte forward, below the H100's ~295 bf16 balance point, so
// even on tensor cores each kernel is bound by the bytes it must move (the
// least time is bytes / 3.35 TB/s).  These kernels run on the f32 CUDA
// cores from shared memory (no tensor cores, no TMA), so they are bound by
// shared-memory bandwidth and FMA throughput, far from that bound: they are
// written to be right; mma.sync/wgmma tiles fed by TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;              // query rows and key rows per tile
constexpr int kThreads = 256;          // 16 row groups of 4 x 16 column lanes
constexpr int kMaxH = 128;             // largest head_dim
constexpr int kCols = kMaxH / 16;      // head_dim columns a thread owns
constexpr int kPld = kTile + 1;        // row stride of score tiles in smem
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store_f32(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

// max / sum over the 16 lanes of a half-warp (lanes that share a row group)
__device__ __forceinline__ float row_max(float v) {
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  const void* q;       // (B, S, N, H)
  const void* k;       // (B, S, n_kv, H)
  const void* v;
  const void* dout;    // (B, S, N, H), backward only
  const float* lse;    // (B, N, S): written by the forward, read by the backward
  const float* delta;  // (B, N, S) rowsum(dO * O), backward only
  void* out;           // forward: out (B, S, N, H); dq kernel: dq
  float* lse_out;      // forward only
  void* dk;            // (B, S, n_kv, H), dkdv only
  void* dv;
  int B, S, N, n_kv, H;
  float scale;
};

// rows [row0, row0 + kTile) of a (S, row_stride)-strided head slice into smem
// as f32 with row stride ld; rows past S read as zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, int row0, int S,
                                          int row_stride, int H) {
  for (int idx = threadIdx.x; idx < kTile * H; idx += kThreads) {
    const int r = idx / H, d = idx - r * H;
    const int row = row0 + r;
    dst[r * ld + d] = row < S ? to_f32(src[(size_t)row * row_stride + d]) : 0.f;
  }
}

// lse and delta of query rows [row0, row0 + kTile) of one head; zero past S
__device__ __forceinline__ void load_rows(float* lse_s, float* dl_s, const float* lse,
                                          const float* delta, int row0, int S) {
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    const int row = row0 + r;
    lse_s[r] = row < S ? lse[row] : 0.f;
    dl_s[r] = row < S ? delta[row] : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  const int H = a.H, ld = H + 1, S = a.S;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.N / a.n_kv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qt * kTile;
  float* qs = smem;
  float* ks = qs + kTile * ld;
  float* vs = ks + kTile * ld;
  float* ps = vs + kTile * ld;

  const T* q = static_cast<const T*>(a.q) + ((size_t)b * S * a.N + h) * H;
  const T* k = static_cast<const T*>(a.k) + ((size_t)b * S * a.n_kv + kh) * H;
  const T* v = static_cast<const T*>(a.v) + ((size_t)b * S * a.n_kv + kh) * H;
  load_tile(qs, ld, q, q0, S, a.N * H, H);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile(ks, ld, k, k0, S, a.n_kv * H, H);
    load_tile(vs, ld, v, k0, S, a.n_kv * H, H);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < H; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        s[i][j] = (col <= row && col < S) ? s[i][j] * a.scale : kMasked;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const float p = (col <= row && col < S) ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty * 4 + i) * kPld + tx + 16 * j] = p;
        sum += p;
      }
      sum = row_sum(sum);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < kTile; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * kPld + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = tx + 16 * c;
        if (d < H) {
          const float vv = vs[kk * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

  T* out = static_cast<T*>(a.out) + ((size_t)b * S * a.N + h) * H;
  float* lse = a.lse_out + ((size_t)b * a.N + h) * S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 16 * c;
      if (d < H) store_f32(acc[i][c] * inv, &out[(size_t)row * a.N * H + d]);
    }
    if (tx == 0) lse[row] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv_kernel(Args a) {
  extern __shared__ float smem[];
  const int H = a.H, ld = H + 1, S = a.S;
  const int kt = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int g = a.N / a.n_kv;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int k0 = kt * kTile;
  const int n_qt = (S + kTile - 1) / kTile;
  float* ks = smem;
  float* vs = ks + kTile * ld;
  float* qs = vs + kTile * ld;
  float* dos = qs + kTile * ld;
  float* pt = dos + kTile * ld;   // P^T tile (key row, query col)
  float* dst = pt + kTile * kPld; // dS^T tile
  float* lse_s = dst + kTile * kPld;
  float* dl_s = lse_s + kTile;

  const size_t kv_off = ((size_t)b * S * a.n_kv + kh) * H;
  load_tile(ks, ld, static_cast<const T*>(a.k) + kv_off, k0, S, a.n_kv * H, H);
  load_tile(vs, ld, static_cast<const T*>(a.v) + kv_off, k0, S, a.n_kv * H, H);

  float dk[4][kCols], dv[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int hq = kh * g; hq < (kh + 1) * g; ++hq) {
    const size_t q_off = ((size_t)b * S * a.N + hq) * H;
    const T* q = static_cast<const T*>(a.q) + q_off;
    const T* dout = static_cast<const T*>(a.dout) + q_off;
    const float* lse = a.lse + ((size_t)b * a.N + hq) * S;
    const float* delta = a.delta + ((size_t)b * a.N + hq) * S;
    for (int qt = kt; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();  // the previous tile's Q, dO, P^T and dS^T are no longer read
      load_tile(qs, ld, q, q0, S, a.N * H, H);
      load_tile(dos, ld, dout, q0, S, a.N * H, H);
      load_rows(lse_s, dl_s, lse, delta, q0, S);
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T for key rows ty*4+i, query cols tx+16j
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
      for (int d = 0; d < H; ++d) {
        float kv[4], vv[4], qv[4], dov[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kv[i] = ks[(ty * 4 + i) * ld + d];
          vv[i] = vs[(ty * 4 + i) * ld + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qv[j] = qs[(tx + 16 * j) * ld + d];
          dov[j] = dos[(tx + 16 * j) * ld + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            st[i][j] = fmaf(kv[i], qv[j], st[i][j]);
            dpt[i][j] = fmaf(vv[i], dov[j], dpt[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int krow = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = tx + 16 * j;
          const int qrow = q0 + qc;
          const float p =
              (qrow < S && krow <= qrow) ? expf(st[i][j] * a.scale - lse_s[qc]) : 0.f;
          pt[(ty * 4 + i) * kPld + qc] = p;
          dst[(ty * 4 + i) * kPld + qc] = p * (dpt[i][j] - dl_s[qc]);
        }
      }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q for key rows ty*4+i, dims tx+16c
      for (int qq = 0; qq < kTile; ++qq) {
        float pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = pt[(ty * 4 + i) * kPld + qq];
          dsv[i] = dst[(ty * 4 + i) * kPld + qq];
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = tx + 16 * c;
          if (d < H) {
            const float dov = dos[qq * ld + d];
            const float qv = qs[qq * ld + d];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              dv[i][c] = fmaf(pv[i], dov, dv[i][c]);
              dk[i][c] = fmaf(dsv[i], qv, dk[i][c]);
            }
          }
        }
      }
    }
  }

  T* dk_out = static_cast<T*>(a.dk) + kv_off;
  T* dv_out = static_cast<T*>(a.dv) + kv_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 16 * c;
      if (d < H) {
        store_f32(dk[i][c] * a.scale, &dk_out[(size_t)row * a.n_kv * H + d]);
        store_f32(dv[i][c], &dv_out[(size_t)row * a.n_kv * H + d]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Args a) {
  extern __shared__ float smem[];
  const int H = a.H, ld = H + 1, S = a.S;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (a.N / a.n_kv);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q0 = qt * kTile;
  float* qs = smem;
  float* dos = qs + kTile * ld;
  float* ks = dos + kTile * ld;
  float* vs = ks + kTile * ld;
  float* dss = vs + kTile * ld;  // dS tile (query row, key col)
  float* lse_s = dss + kTile * kPld;
  float* dl_s = lse_s + kTile;

  const size_t q_off = ((size_t)b * S * a.N + h) * H;
  const size_t kv_off = ((size_t)b * S * a.n_kv + kh) * H;
  load_tile(qs, ld, static_cast<const T*>(a.q) + q_off, q0, S, a.N * H, H);
  load_tile(dos, ld, static_cast<const T*>(a.dout) + q_off, q0, S, a.N * H, H);
  load_rows(lse_s, dl_s, a.lse + ((size_t)b * a.N + h) * S,
            a.delta + ((size_t)b * a.N + h) * S, q0, S);
  const T* k = static_cast<const T*>(a.k) + kv_off;
  const T* v = static_cast<const T*>(a.v) + kv_off;

  float dq[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[i][c] = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the previous tile's K and dS are no longer read
    load_tile(ks, ld, k, k0, S, a.n_kv * H, H);
    load_tile(vs, ld, v, k0, S, a.n_kv * H, H);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < H; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty * 4 + i) * ld + d];
        dov[i] = dos[(ty * 4 + i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 16 * j) * ld + d];
        vv[j] = vs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qrow = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const float p = (qrow < S && col <= qrow) ? expf(s[i][j] * a.scale - lse_s[r]) : 0.f;
        dss[r * kPld + tx + 16 * j] = p * (dp[i][j] - dl_s[r]);
      }
    }
    __syncthreads();

    for (int kk = 0; kk < kTile; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty * 4 + i) * kPld + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = tx + 16 * c;
        if (d < H) {
          const float kv = ks[kk * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) dq[i][c] = fmaf(dsv[i], kv, dq[i][c]);
        }
      }
    }
  }

  T* dq_out = static_cast<T*>(a.out) + q_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 16 * c;
      if (d < H) store_f32(dq[i][c] * a.scale, &dq_out[(size_t)row * a.N * H + d]);
    }
  }
}

enum Which { kForward = 0, kBwdDkdv = 1, kBwdDq = 2 };

// dynamic shared memory of one block, in bytes
size_t smem_bytes(int which, int H) {
  const size_t tile = (size_t)kTile * (H + 1);
  const size_t scores = (size_t)kTile * kPld;
  switch (which) {
    case kForward: return sizeof(float) * (3 * tile + scores);
    case kBwdDkdv: return sizeof(float) * (4 * tile + 2 * scores + 2 * kTile);
    case kBwdDq: return sizeof(float) * (4 * tile + scores + 2 * kTile);
  }
  return 0;
}

template <typename T>
int launch_t(int which, const Args& a, cudaStream_t stream) {
  void (*kern)(Args) = &flash_bwd_dq_kernel<T>;
  if (which == kForward) kern = &flash_fwd_kernel<T>;
  if (which == kBwdDkdv) kern = &flash_bwd_dkdv_kernel<T>;
  const size_t smem = smem_bytes(which, a.H);
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int tiles = (a.S + kTile - 1) / kTile;
  dim3 grid(tiles, which == kBwdDkdv ? a.n_kv : a.N, a.B);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// dtype codes: 0 = float32, 1 = bfloat16
int launch(int which, int dtype, const Args& a, cudaStream_t stream) {
  if (a.H > kMaxH || a.H % 2 || a.n_kv <= 0 || a.N % a.n_kv) return (int)cudaErrorInvalidValue;
  if (a.B == 0 || a.S == 0) return (int)cudaSuccess;
  switch (dtype) {
    case 0: return launch_t<float>(which, a, stream);
    case 1: return launch_t<__nv_bfloat16>(which, a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

size_t flash_attention_smem_bytes(int which, int H) { return smem_bytes(which, H); }

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q (B, S, N, H); k, v (B, S, n_kv, H); out (B, S, N, H); lse (B, N, S) f32
int flash_attention_forward_launch(const void* q, const void* k, const void* v, void* out,
                                   float* lse, int B, int S, int N, int n_kv, int H,
                                   float scale, int dtype, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, out, lse, nullptr, nullptr, B, S, N, n_kv, H, scale};
  return launch(kForward, dtype, a, static_cast<cudaStream_t>(stream));
}

// dout (B, S, N, H); lse, delta (B, N, S) f32; dk, dv (B, S, n_kv, H)
int flash_attention_bwd_dkdv_launch(const void* q, const void* k, const void* v,
                                    const void* dout, const float* lse, const float* delta,
                                    void* dk, void* dv, int B, int S, int N, int n_kv, int H,
                                    float scale, int dtype, void* stream) {
  Args a{q, k, v, dout, lse, delta, nullptr, nullptr, dk, dv, B, S, N, n_kv, H, scale};
  return launch(kBwdDkdv, dtype, a, static_cast<cudaStream_t>(stream));
}

// dq (B, S, N, H)
int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse, const float* delta,
                                  void* dq, int B, int S, int N, int n_kv, int H, float scale,
                                  int dtype, void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, nullptr, B, S, N, n_kv, H, scale};
  return launch(kBwdDq, dtype, a, static_cast<cudaStream_t>(stream));
}

}  // extern "C"

// Causal flash attention, forward and backward, for sm_90a.
//
// Replaces the TPU flash kernel that relora_tpu/ops/attention.py:84
// (_pallas_attention) reaches through JAX's Pallas library
// (jax/experimental/pallas/ops/tpu/flash_attention.py: _flash_attention_impl,
// _flash_attention_bwd_dkv, _flash_attention_bwd_dq):
//
//   forward  out (B, S, N, H) and lse (B, N, S) f32
//   dK/dV    dK, dV (B, S, n_kv, H)
//   dQ       dQ (B, S, N, H)
//
// q is (B, S, N, H), k and v are (B, S, n_kv, H) with N a multiple of n_kv
// (grouped-query attention: query head h reads kv head h / (N / n_kv)), all in
// f32 or bf16; the softmax scale is given.  Key j is visible to query i iff
// j <= i.  The backward takes the forward's lse and delta = rowsum(dO * O)
// (B, N, S) f32, so neither backward kernel needs the forward's output.  Any
// B and S, any even H <= 128.
//
// Two kernel sets, chosen by dtype alone, never by shape: a bf16 call always
// runs the tensor-core kernels (and raises where they cannot run), an f32 call
// always runs the FMA kernels.
//
// Shared tiling.  One block owns one output tile and loops over the tiles it
// needs, keeping its running state on chip: the forward block (b, head, query
// tile) walks the key tiles up to the diagonal with an online softmax; the
// dK/dV block (b, kv head, key tile) walks, for each of the g query heads of
// its group, the query tiles from the diagonal down, recomputing P from lse;
// the dQ block (b, head, query tile) walks the key tiles up to the diagonal.
// No two blocks write the same output, so there are no atomics and the sums
// are deterministic.  Tiles above the diagonal are never visited, and only
// tiles that cross the diagonal or the end of S are masked.
//
// bf16: flash_{fwd,bwd_dkdv,bwd_dq}_tc_kernel, FlashAttention-2 on Hopper's
// tensor cores through mma.sync.m16n8k16 (bf16 in, f32 accumulate).  Blocks of
// 4 warps; each warp owns 16 rows of the block's 64-row tile.  The head is
// padded in shared memory to HP = H rounded up to 16 (the mma depth) with
// zero columns, which add nothing to any product; outputs are written for the
// H real columns only.  Tiles are bf16 in shared memory at a row stride of
// HP + 8 (an odd multiple of 16 bytes, so the 8 rows an ldmatrix reads fall
// in 8 different bank groups), loaded with cp.async (16-, 8- or 4-byte copies,
// the widest that H and the pointers' alignment allow: H = 52 takes 8-byte
// ones) and double-buffered, so the next tile streams in while this one is
// multiplied.  Rows past S are zero-filled by the copy.
//   forward: Q's fragments stay in registers; S = Q Kᵀ on the tensor cores,
//     the online softmax on the accumulator fragments (row max and sum over
//     the 4 lanes of a quad, exp2f with scale * log2 e folded in), P rounded
//     to bf16 in registers is the A operand of P V (V read by ldmatrix.trans),
//     O accumulates in f32 registers; O / l goes out as bf16 through shared
//     memory with coalesced stores, lse as f32.  The grid's slowest axis is the
//     query tile, heaviest (last) first, so the long causal rows start early
//     and the short ones fill in across the 132 SMs.
//   dK/dV: the block computes Sᵀ = K Qᵀ and dPᵀ = V dOᵀ with key rows, so the
//     accumulators of Pᵀ = exp(Sᵀ scale - lse) and dSᵀ = Pᵀ (dPᵀ - delta) are
//     already in the A-operand layout of dV += Pᵀ dO and dK += dSᵀ Q: they are
//     rounded to bf16 in registers and never staged in shared memory.  Q and
//     dO are read by ldmatrix (plain for the scores, .trans for the updates).
//   dQ: rows are queries; Q and dO fragments stay in registers, S = Q Kᵀ and
//     dP = dO Vᵀ, dS = P (dP - delta) rounded to bf16 is the A operand of
//     dQ += dS K (K by ldmatrix.trans).
//   At HP > 64 the backward kernels walk 32-row tiles of the other operand
//   instead of 64, to keep their accumulators in registers.
//
// f32: flash_{fwd,bwd_dkdv,bwd_dq}_kernel, 256 threads on 64 x 64 tiles
// staged in shared memory as f32 (row stride H + 1, conflict-free column
// reads); each thread computes a 4 x 4 block of scores and a 4 x H/16 block of
// the output with f32 FMAs on the CUDA cores, so the f32 path is exact to
// summation order (no bf16 or TF32 products), which the f32 training checks
// need.
//
// Bound.  At llama_250m training shapes (S = 512, H = 48) the work is
// 2 B N S^2 H causal flops forward and 5 B N S^2 H backward, against 2 bytes
// for each element of q, k, v and out (and dO, dq, dk, dv backward): S / 4 =
// 128 flops per byte forward, below the H100's ~295 bf16 balance point, so on
// the tensor cores each kernel is bound by the bytes it must move (the least
// time is bytes / 3.35 TB/s).  What the bf16 design does about it: every
// input byte is read from device memory once per block that needs it and
// every intermediate (S, P, dS) lives in registers, so the traffic is the
// inputs re-read per tile (K and V once per query tile, from L2) plus the
// outputs once.  What still separates it from the bound is latency, not
// bandwidth: a block's key loop is serial, 4 warps of mma.sync reach a
// fraction of the wgmma rate, and at S = 512 the causal grid is small.  The
// f32 kernels are bound by shared-memory bandwidth and FMA throughput.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;              // f32: query rows and key rows per tile
constexpr int kThreads = 256;          // f32: 16 row groups of 4 x 16 column lanes
constexpr int kMaxH = 128;             // largest head_dim
constexpr int kCols = kMaxH / 16;      // f32: head_dim columns a thread owns
constexpr int kPld = kTile + 1;        // f32: row stride of score tiles in smem
constexpr float kMasked = -1e30f;

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

// ---------------------------------------------------------------------------
// f32: FMA kernels
// ---------------------------------------------------------------------------

// rows [row0, row0 + kTile) of a (S, row_stride)-strided head slice into smem
// with row stride ld; rows past S read as zero
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src, int row0, int S,
                                          int row_stride, int H) {
  for (int idx = threadIdx.x; idx < kTile * H; idx += kThreads) {
    const int r = idx / H, d = idx - r * H;
    const int row = row0 + r;
    dst[r * ld + d] = row < S ? src[(size_t)row * row_stride + d] : 0.f;
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

  const float* q = static_cast<const float*>(a.q) + ((size_t)b * S * a.N + h) * H;
  const float* k = static_cast<const float*>(a.k) + ((size_t)b * S * a.n_kv + kh) * H;
  const float* v = static_cast<const float*>(a.v) + ((size_t)b * S * a.n_kv + kh) * H;
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

  float* out = static_cast<float*>(a.out) + ((size_t)b * S * a.N + h) * H;
  float* lse = a.lse_out + ((size_t)b * a.N + h) * S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 16 * c;
      if (d < H) out[(size_t)row * a.N * H + d] = acc[i][c] * inv;
    }
    if (tx == 0) lse[row] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

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
  load_tile(ks, ld, static_cast<const float*>(a.k) + kv_off, k0, S, a.n_kv * H, H);
  load_tile(vs, ld, static_cast<const float*>(a.v) + kv_off, k0, S, a.n_kv * H, H);

  float dk[4][kCols], dv[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int hq = kh * g; hq < (kh + 1) * g; ++hq) {
    const size_t q_off = ((size_t)b * S * a.N + hq) * H;
    const float* q = static_cast<const float*>(a.q) + q_off;
    const float* dout = static_cast<const float*>(a.dout) + q_off;
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

  float* dk_out = static_cast<float*>(a.dk) + kv_off;
  float* dv_out = static_cast<float*>(a.dv) + kv_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty * 4 + i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 16 * c;
      if (d < H) {
        dk_out[(size_t)row * a.n_kv * H + d] = dk[i][c] * a.scale;
        dv_out[(size_t)row * a.n_kv * H + d] = dv[i][c];
      }
    }
  }
}

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
  load_tile(qs, ld, static_cast<const float*>(a.q) + q_off, q0, S, a.N * H, H);
  load_tile(dos, ld, static_cast<const float*>(a.dout) + q_off, q0, S, a.N * H, H);
  load_rows(lse_s, dl_s, a.lse + ((size_t)b * a.N + h) * S,
            a.delta + ((size_t)b * a.N + h) * S, q0, S);
  const float* k = static_cast<const float*>(a.k) + kv_off;
  const float* v = static_cast<const float*>(a.v) + kv_off;

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

  float* dq_out = static_cast<float*>(a.out) + q_off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 16 * c;
      if (d < H) dq_out[(size_t)row * a.N * H + d] = dq[i][c] * a.scale;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernels
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;  // 4 warps, 16 rows of the 64-row tile each
constexpr int kTcRows = 64;      // rows of the tile a block owns
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// rows of the other operand's tiles a block walks (64, or 32 past HP = 64 in
// the backward kernels, whose accumulators would not fit in registers)
template <int HP>
struct TcShape {
  static constexpr int LD = HP + 8;  // smem row stride, elements
  static constexpr int KSTEPS = HP / 16;
  static constexpr int BWD_TILE = HP <= 64 ? 64 : 32;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d (16 x 8 f32) += a (16 x 16 bf16, row) b (16 x 8 bf16, col)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as one bf16x2 register, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment of a 16 x 16 slice from two 16 x 8 accumulator tiles
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [row0, row0 + rows) of one head (row stride `stride` elements) into an
// smem tile of row stride ld, columns [0, H), by cp.async of vec elements
// (8, 4 or 2: 16-, 8- or 4-byte copies); rows past S are zero-filled
__device__ __forceinline__ void load_tile_async(bf16* dst, int ld, const bf16* src, int row0,
                                                int rows, int S, long long stride, int H,
                                                int vec) {
  const int per_row = H / vec;
  for (int i = threadIdx.x; i < rows * per_row; i += kTcThreads) {
    const int r = i / per_row, c = (i - r * per_row) * vec;
    const bool ok = row0 + r < S;
    const bf16* g = ok ? src + (long long)(row0 + r) * stride + c : src;
    const uint32_t s = smem_addr(dst + r * ld + c);
    if (vec == 8)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(g),
                   "r"(ok ? 16 : 0));
    else if (vec == 4)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(g),
                   "r"(ok ? 8 : 0));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(g),
                   "r"(ok ? 4 : 0));
  }
}

// f32 values [row0, row0 + rows) of one head's (S,) row into smem; zero past S
__device__ __forceinline__ void load_vec_async(float* dst, const float* src, int row0, int rows,
                                               int S) {
  for (int r = threadIdx.x; r < rows; r += kTcThreads) {
    const bool ok = row0 + r < S;
    const float* g = ok ? src + row0 + r : src;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst + r)),
                 "l"(g), "r"(ok ? 4 : 0));
  }
}

// zero columns [H, HP) of `rows` smem rows: the head's padding, which the
// copies never write, so it is zeroed once per block
__device__ __forceinline__ void zero_pad(bf16* base, int rows, int ld, int H, int HP) {
  const int w = HP - H;
  if (w == 0) return;
  for (int i = threadIdx.x; i < rows * w; i += kTcThreads) {
    const int r = i / w;
    base[r * ld + H + (i - r * w)] = __float2bfloat16_rn(0.f);
  }
}

// the warp's 16 x HP accumulator, rows scaled by f0 (row g) and f1 (row g+8),
// as bf16 into its 16 rows of an smem tile
template <int HP>
__device__ __forceinline__ void stage_acc(bf16* tile, const float (&acc)[HP / 8][4], float f0,
                                          float f1) {
  constexpr int LD = TcShape<HP>::LD;
  const int lane = threadIdx.x % 32;
  const int r = (threadIdx.x / 32) * 16 + lane / 4, c = (lane % 4) * 2;
#pragma unroll
  for (int dt = 0; dt < HP / 8; ++dt) {
    *reinterpret_cast<__nv_bfloat162*>(tile + r * LD + dt * 8 + c) =
        __floats2bfloat162_rn(acc[dt][0] * f0, acc[dt][1] * f0);
    *reinterpret_cast<__nv_bfloat162*>(tile + (r + 8) * LD + dt * 8 + c) =
        __floats2bfloat162_rn(acc[dt][2] * f1, acc[dt][3] * f1);
  }
}

// rows [row0, row0 + rows) of an smem tile (row stride ld) to one head's rows
// in device memory (row stride `stride`), columns [0, H), rows < S only, vec
// elements per store: each warp writes whole rows, neighbouring lanes on
// neighbouring addresses
__device__ __forceinline__ void store_tile(bf16* dst, long long stride, const bf16* src, int ld,
                                           int row0, int rows, int S, int H, int vec) {
  const int per_row = H / vec;
  for (int i = threadIdx.x; i < rows * per_row; i += kTcThreads) {
    const int r = i / per_row, c = (i - r * per_row) * vec;
    if (row0 + r >= S) continue;
    bf16* g = dst + (long long)(row0 + r) * stride + c;
    const bf16* s = src + r * ld + c;
    if (vec == 8)
      *reinterpret_cast<uint4*>(g) = *reinterpret_cast<const uint4*>(s);
    else if (vec == 4)
      *reinterpret_cast<uint2*>(g) = *reinterpret_cast<const uint2*>(s);
    else
      *reinterpret_cast<uint32_t*>(g) = *reinterpret_cast<const uint32_t*>(s);
  }
}

// lane offsets of ldmatrix x4 addresses, in (row, column) of the stored tile:
//   A (16 x 16 row-major, a0..a3):           row lane % 16, column (lane / 16) * 8
//   B from [n][k] storage, plain (two n8):   row lane % 8 + (lane / 16) * 8,
//                                            column ((lane / 8) % 2) * 8
//   B from [k][n] storage, .trans (two n8):  row lane % 8 + ((lane / 8) % 2) * 8,
//                                            column (lane / 16) * 8
__device__ __forceinline__ int a_row(int lane) { return lane % 16; }
__device__ __forceinline__ int a_col(int lane) { return (lane / 16) * 8; }
__device__ __forceinline__ int bn_row(int lane) { return lane % 8 + (lane / 16) * 8; }
__device__ __forceinline__ int bn_col(int lane) { return ((lane / 8) % 2) * 8; }
__device__ __forceinline__ int bt_row(int lane) { return lane % 8 + ((lane / 8) % 2) * 8; }
__device__ __forceinline__ int bt_col(int lane) { return (lane / 16) * 8; }

template <int HP>
__global__ void __launch_bounds__(kTcThreads) flash_fwd_tc_kernel(Args a, int vec) {
  using Sh = TcShape<HP>;
  constexpr int LD = Sh::LD, BM = kTcRows, BN = 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ks = qs + BM * LD;      // two buffers
  bf16* vs = ks + 2 * BN * LD;  // two buffers
  const int S = a.S, H = a.H;
  const int n_qt = (S + BM - 1) / BM;
  const int qt = n_qt - 1 - blockIdx.z;  // heaviest tiles first
  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / (a.N / a.n_kv);
  const int q0 = qt * BM;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, gr = lane / 4, tq = lane % 4;
  const long long q_stride = (long long)a.N * H, kv_stride = (long long)a.n_kv * H;
  const bf16* q = static_cast<const bf16*>(a.q) + ((long long)b * S * a.N + h) * H;
  const bf16* k = static_cast<const bf16*>(a.k) + ((long long)b * S * a.n_kv + kh) * H;
  const bf16* v = static_cast<const bf16*>(a.v) + ((long long)b * S * a.n_kv + kh) * H;

  zero_pad(qs, BM + 4 * BN, LD, H, HP);
  load_tile_async(qs, LD, q, q0, BM, S, q_stride, H, vec);
  load_tile_async(ks, LD, k, 0, BN, S, kv_stride, H, vec);
  load_tile_async(vs, LD, v, 0, BN, S, kv_stride, H, vec);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[Sh::KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < Sh::KSTEPS; ++kk)
    ldsm_x4(qf[kk], qs + (w * 16 + a_row(lane)) * LD + kk * 16 + a_col(lane));

  float o[HP / 8][4];
#pragma unroll
  for (int dt = 0; dt < HP / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = a.scale * kLog2e;
  const int row_lo = q0 + w * 16;  // the warp's first query row
  const int last = min(q0 + BM - 1, S - 1) / BN;

  for (int kt = 0; kt <= last; ++kt) {
    const int buf = kt & 1;
    if (kt < last) {
      load_tile_async(ks + (buf ^ 1) * BN * LD, LD, k, (kt + 1) * BN, BN, S, kv_stride, H, vec);
      load_tile_async(vs + (buf ^ 1) * BN * LD, LD, v, (kt + 1) * BN, BN, S, kv_stride, H, vec);
    }
    cp_async_commit();
    const bf16* kb = ks + buf * BN * LD;
    const bf16* vb = vs + buf * BN * LD;
    const int k0 = kt * BN;

    // S = Q K^T, 16 x 64 per warp
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < Sh::KSTEPS; ++kk)
#pragma unroll
      for (int p = 0; p < BN / 16; ++p) {
        uint32_t bq[4];
        ldsm_x4(bq, kb + (p * 16 + bn_row(lane)) * LD + kk * 16 + bn_col(lane));
        mma(s[2 * p], qf[kk], bq[0], bq[1]);
        mma(s[2 * p + 1], qf[kk], bq[2], bq[3]);
      }

    // online softmax over the warp's rows gr (i = 0) and gr + 8 (i = 1)
    const bool masked = k0 + BN - 1 > row_lo;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_lo + gr + 8 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[j][2 * i + e] * sl2;
          if (masked && k0 + j * 8 + 2 * tq + e > row) x = -INFINITY;
          s[j][2 * i + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[i] - base);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[j][2 * i + e] - base);
          s[j][2 * i + e] = p;
          sum += p;
        }
      l[i] = l[i] * alpha + sum;  // this lane's columns; summed over the quad at the end
#pragma unroll
      for (int dt = 0; dt < HP / 8; ++dt) {
        o[dt][2 * i] *= alpha;
        o[dt][2 * i + 1] *= alpha;
      }
    }

    // O += P V, P as bf16 A fragments straight from the score accumulators
#pragma unroll
    for (int c = 0; c < BN / 16; ++c) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * c], s[2 * c + 1]);
#pragma unroll
      for (int dp = 0; dp < HP / 16; ++dp) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vb + (c * 16 + bt_row(lane)) * LD + dp * 16 + bt_col(lane));
        mma(o[2 * dp], pa, bv[0], bv[1]);
        mma(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();  // the next tile has landed; this one is no longer read
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / l[i];
  }
  stage_acc<HP>(qs, o, inv[0], inv[1]);  // Q's tile is free: its fragments are in registers
  __syncthreads();
  store_tile(static_cast<bf16*>(a.out) + ((long long)b * S * a.N + h) * H, q_stride, qs, LD, q0,
             BM, S, H, vec);
  if (tq == 0) {
    float* lse = a.lse_out + ((long long)b * a.N + h) * S;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_lo + gr + 8 * i;
      if (row < S) lse[row] = m[i] * kLn2 + logf(l[i]);  // m is in log2 units
    }
  }
}

template <int HP>
__global__ void __launch_bounds__(kTcThreads) flash_bwd_dkdv_tc_kernel(Args a, int vec) {
  using Sh = TcShape<HP>;
  constexpr int LD = Sh::LD, BN = kTcRows, BQ = Sh::BWD_TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + BN * LD;
  bf16* qs = vs + BN * LD;       // two buffers
  bf16* dos = qs + 2 * BQ * LD;  // two buffers
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BQ * LD);  // two buffers
  float* dl_s = lse_s + 2 * BQ;                                // two buffers
  const int S = a.S, H = a.H;
  const int kt = blockIdx.z;  // key tile 0 sees every query: heaviest first
  const int kh = blockIdx.x, b = blockIdx.y;
  const int g = a.N / a.n_kv;
  const int k0 = kt * BN;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, gr = lane / 4, tq = lane % 4;
  const long long q_stride = (long long)a.N * H, kv_stride = (long long)a.n_kv * H;
  const long long kv_off = ((long long)b * S * a.n_kv + kh) * H;
  const int qt0 = k0 / BQ;  // the first query tile that sees this key tile
  const int per_head = (S + BQ - 1) / BQ - qt0;
  const int total = g * per_head;

  auto load_q = [&](int i, int buf) {
    const int hq = kh * g + i / per_head, q0 = (qt0 + i % per_head) * BQ;
    const long long q_off = ((long long)b * S * a.N + hq) * H;
    const long long r_off = ((long long)b * a.N + hq) * S;
    load_tile_async(qs + buf * BQ * LD, LD, static_cast<const bf16*>(a.q) + q_off, q0, BQ, S,
                    q_stride, H, vec);
    load_tile_async(dos + buf * BQ * LD, LD, static_cast<const bf16*>(a.dout) + q_off, q0, BQ,
                    S, q_stride, H, vec);
    load_vec_async(lse_s + buf * BQ, a.lse + r_off, q0, BQ, S);
    load_vec_async(dl_s + buf * BQ, a.delta + r_off, q0, BQ, S);
  };

  zero_pad(ks, 2 * BN + 4 * BQ, LD, H, HP);
  load_tile_async(ks, LD, static_cast<const bf16*>(a.k) + kv_off, k0, BN, S, kv_stride, H, vec);
  load_tile_async(vs, LD, static_cast<const bf16*>(a.v) + kv_off, k0, BN, S, kv_stride, H, vec);
  load_q(0, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  float dk[HP / 8][4], dv[HP / 8][4];
#pragma unroll
  for (int dt = 0; dt < HP / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;
  const float sl2 = a.scale * kLog2e;
  const int key_hi = k0 + w * 16 + 15;  // the warp's last key row

  for (int i = 0; i < total; ++i) {
    const int buf = i & 1;
    if (i + 1 < total) load_q(i + 1, buf ^ 1);
    cp_async_commit();
    const int q0 = (qt0 + i % per_head) * BQ;
    const bf16* qb = qs + buf * BQ * LD;
    const bf16* dob = dos + buf * BQ * LD;
    const float* lse_b = lse_s + buf * BQ;
    const float* dl_b = dl_s + buf * BQ;

    // S^T = K Q^T and dP^T = V dO^T, 16 keys x BQ queries per warp
    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < Sh::KSTEPS; ++kk) {
      uint32_t ka[4], va[4];
      ldsm_x4(ka, ks + (w * 16 + a_row(lane)) * LD + kk * 16 + a_col(lane));
      ldsm_x4(va, vs + (w * 16 + a_row(lane)) * LD + kk * 16 + a_col(lane));
#pragma unroll
      for (int p = 0; p < BQ / 16; ++p) {
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, qb + (p * 16 + bn_row(lane)) * LD + kk * 16 + bn_col(lane));
        mma(st[2 * p], ka, bq[0], bq[1]);
        mma(st[2 * p + 1], ka, bq[2], bq[3]);
        ldsm_x4(bo, dob + (p * 16 + bn_row(lane)) * LD + kk * 16 + bn_col(lane));
        mma(dpt[2 * p], va, bo[0], bo[1]);
        mma(dpt[2 * p + 1], va, bo[2], bo[3]);
      }
    }

    // P^T = exp(S^T scale - lse), dS^T = P^T (dP^T - delta); a query sees a key
    // at or before it, and queries past S see nothing
    const bool masked = q0 < key_hi || q0 + BQ > S;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ql = j * 8 + 2 * tq + e;
        const float lse_q = lse_b[ql] * kLog2e, dl_q = dl_b[ql];
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          const int key = k0 + w * 16 + gr + 8 * i2;
          float p = exp2f(st[j][2 * i2 + e] * sl2 - lse_q);
          if (masked && (key > q0 + ql || q0 + ql >= S)) p = 0.f;
          st[j][2 * i2 + e] = p;
          dpt[j][2 * i2 + e] = p * (dpt[j][2 * i2 + e] - dl_q);
        }
      }

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T as bf16 A fragments
#pragma unroll
    for (int c = 0; c < BQ / 16; ++c) {
      uint32_t pa[4], da[4];
      acc_to_a(pa, st[2 * c], st[2 * c + 1]);
      acc_to_a(da, dpt[2 * c], dpt[2 * c + 1]);
#pragma unroll
      for (int dp = 0; dp < HP / 16; ++dp) {
        uint32_t bo[4], bq[4];
        ldsm_x4_t(bo, dob + (c * 16 + bt_row(lane)) * LD + dp * 16 + bt_col(lane));
        mma(dv[2 * dp], pa, bo[0], bo[1]);
        mma(dv[2 * dp + 1], pa, bo[2], bo[3]);
        ldsm_x4_t(bq, qb + (c * 16 + bt_row(lane)) * LD + dp * 16 + bt_col(lane));
        mma(dk[2 * dp], da, bq[0], bq[1]);
        mma(dk[2 * dp + 1], da, bq[2], bq[3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  // K's and V's tiles are free after the loop's last barrier
  stage_acc<HP>(ks, dk, a.scale, a.scale);
  stage_acc<HP>(vs, dv, 1.f, 1.f);
  __syncthreads();
  store_tile(static_cast<bf16*>(a.dk) + kv_off, kv_stride, ks, LD, k0, BN, S, H, vec);
  store_tile(static_cast<bf16*>(a.dv) + kv_off, kv_stride, vs, LD, k0, BN, S, H, vec);
}

template <int HP>
__global__ void __launch_bounds__(kTcThreads) flash_bwd_dq_tc_kernel(Args a, int vec) {
  using Sh = TcShape<HP>;
  constexpr int LD = Sh::LD, BM = kTcRows, BN = Sh::BWD_TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + BM * LD;
  bf16* ks = dos + BM * LD;     // two buffers
  bf16* vs = ks + 2 * BN * LD;  // two buffers
  const int S = a.S, H = a.H;
  const int n_qt = (S + BM - 1) / BM;
  const int qt = n_qt - 1 - blockIdx.z;  // heaviest tiles first
  const int h = blockIdx.x, b = blockIdx.y;
  const int kh = h / (a.N / a.n_kv);
  const int q0 = qt * BM;
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32, gr = lane / 4, tq = lane % 4;
  const long long q_stride = (long long)a.N * H, kv_stride = (long long)a.n_kv * H;
  const long long q_off = ((long long)b * S * a.N + h) * H;
  const bf16* k = static_cast<const bf16*>(a.k) + ((long long)b * S * a.n_kv + kh) * H;
  const bf16* v = static_cast<const bf16*>(a.v) + ((long long)b * S * a.n_kv + kh) * H;

  zero_pad(qs, 2 * BM + 4 * BN, LD, H, HP);
  load_tile_async(qs, LD, static_cast<const bf16*>(a.q) + q_off, q0, BM, S, q_stride, H, vec);
  load_tile_async(dos, LD, static_cast<const bf16*>(a.dout) + q_off, q0, BM, S, q_stride, H, vec);
  load_tile_async(ks, LD, k, 0, BN, S, kv_stride, H, vec);
  load_tile_async(vs, LD, v, 0, BN, S, kv_stride, H, vec);
  cp_async_commit();

  const int row_lo = q0 + w * 16;
  float lse_r[2], dl_r[2];
  {
    const long long r_off = ((long long)b * a.N + h) * S;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row_lo + gr + 8 * i;
      lse_r[i] = row < S ? a.lse[r_off + row] * kLog2e : 0.f;
      dl_r[i] = row < S ? a.delta[r_off + row] : 0.f;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  uint32_t qf[Sh::KSTEPS][4], df[Sh::KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < Sh::KSTEPS; ++kk) {
    ldsm_x4(qf[kk], qs + (w * 16 + a_row(lane)) * LD + kk * 16 + a_col(lane));
    ldsm_x4(df[kk], dos + (w * 16 + a_row(lane)) * LD + kk * 16 + a_col(lane));
  }

  float dq[HP / 8][4];
#pragma unroll
  for (int dt = 0; dt < HP / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[dt][e] = 0.f;
  const float sl2 = a.scale * kLog2e;
  const int last = min(q0 + BM - 1, S - 1) / BN;

  for (int kt = 0; kt <= last; ++kt) {
    const int buf = kt & 1;
    if (kt < last) {
      load_tile_async(ks + (buf ^ 1) * BN * LD, LD, k, (kt + 1) * BN, BN, S, kv_stride, H, vec);
      load_tile_async(vs + (buf ^ 1) * BN * LD, LD, v, (kt + 1) * BN, BN, S, kv_stride, H, vec);
    }
    cp_async_commit();
    const bf16* kb = ks + buf * BN * LD;
    const bf16* vb = vs + buf * BN * LD;
    const int k0 = kt * BN;

    // S = Q K^T and dP = dO V^T, 16 queries x BN keys per warp
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < Sh::KSTEPS; ++kk)
#pragma unroll
      for (int p = 0; p < BN / 16; ++p) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, kb + (p * 16 + bn_row(lane)) * LD + kk * 16 + bn_col(lane));
        mma(s[2 * p], qf[kk], bk[0], bk[1]);
        mma(s[2 * p + 1], qf[kk], bk[2], bk[3]);
        ldsm_x4(bv, vb + (p * 16 + bn_row(lane)) * LD + kk * 16 + bn_col(lane));
        mma(dp[2 * p], df[kk], bv[0], bv[1]);
        mma(dp[2 * p + 1], df[kk], bv[2], bv[3]);
      }

    // dS = P (dP - delta), P = exp(S scale - lse), into s
    const bool masked = k0 + BN - 1 > row_lo;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float p = exp2f(s[j][2 * i + e] * sl2 - lse_r[i]);
          if (masked && k0 + j * 8 + 2 * tq + e > row_lo + gr + 8 * i) p = 0.f;
          s[j][2 * i + e] = p * (dp[j][2 * i + e] - dl_r[i]);
        }

    // dQ += dS K, dS as bf16 A fragments, K by ldmatrix.trans
#pragma unroll
    for (int c = 0; c < BN / 16; ++c) {
      uint32_t da[4];
      acc_to_a(da, s[2 * c], s[2 * c + 1]);
#pragma unroll
      for (int dd = 0; dd < HP / 16; ++dd) {
        uint32_t bk[4];
        ldsm_x4_t(bk, kb + (c * 16 + bt_row(lane)) * LD + dd * 16 + bt_col(lane));
        mma(dq[2 * dd], da, bk[0], bk[1]);
        mma(dq[2 * dd + 1], da, bk[2], bk[3]);
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  stage_acc<HP>(qs, dq, a.scale, a.scale);  // Q's tile is free: its fragments are in registers
  __syncthreads();
  store_tile(static_cast<bf16*>(a.out) + q_off, q_stride, qs, LD, q0, BM, S, H, vec);
}

enum Which { kForward = 0, kBwdDkdv = 1, kBwdDq = 2 };
enum Dtype { kF32 = 0, kBF16 = 1 };

// f(std::integral_constant<int, HP>()) for the tensor-core kernels' padded
// head dim HP = H rounded up to 16; `otherwise` when H is past kMaxH
template <typename R, typename F>
R with_padded_head(int H, R otherwise, F&& f) {
  switch ((H + 15) / 16) {
    case 1: return f(std::integral_constant<int, 16>());
    case 2: return f(std::integral_constant<int, 32>());
    case 3: return f(std::integral_constant<int, 48>());
    case 4: return f(std::integral_constant<int, 64>());
    case 5: return f(std::integral_constant<int, 80>());
    case 6: return f(std::integral_constant<int, 96>());
    case 7: return f(std::integral_constant<int, 112>());
    case 8: return f(std::integral_constant<int, 128>());
  }
  return otherwise;
}

// dynamic shared memory of one block, in bytes; the tile layouts are the
// kernels' own
size_t smem_bytes(int which, int H, int dtype) {
  if (dtype == kBF16) {
    return with_padded_head(H, (size_t)0, [&](auto hp) -> size_t {
      using Sh = TcShape<decltype(hp)::value>;
      const size_t row = sizeof(bf16) * Sh::LD, other = Sh::BWD_TILE;
      switch (which) {
        case kForward: return row * (kTcRows + 4 * 64);
        case kBwdDkdv: return row * (2 * kTcRows + 4 * other) + sizeof(float) * 4 * other;
        case kBwdDq: return row * (2 * kTcRows + 4 * other);
      }
      return 0;
    });
  }
  const size_t tile = (size_t)kTile * (H + 1);
  const size_t scores = (size_t)kTile * kPld;
  switch (which) {
    case kForward: return sizeof(float) * (3 * tile + scores);
    case kBwdDkdv: return sizeof(float) * (4 * tile + 2 * scores + 2 * kTile);
    case kBwdDq: return sizeof(float) * (4 * tile + scores + 2 * kTile);
  }
  return 0;
}

int set_smem(const void* kern, size_t smem) {
  if (smem <= 48 * 1024) return (int)cudaSuccess;
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int launch_f32(int which, const Args& a, cudaStream_t stream) {
  void (*kern)(Args) = &flash_bwd_dq_kernel;
  if (which == kForward) kern = &flash_fwd_kernel;
  if (which == kBwdDkdv) kern = &flash_bwd_dkdv_kernel;
  const size_t smem = smem_bytes(which, a.H, kF32);
  if (int e = set_smem((const void*)kern, smem)) return e;
  const int tiles = (a.S + kTile - 1) / kTile;
  dim3 grid(tiles, which == kBwdDkdv ? a.n_kv : a.N, a.B);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int HP>
int launch_tc_hp(int which, const Args& a, int vec, cudaStream_t stream) {
  void (*kern)(Args, int) = &flash_bwd_dq_tc_kernel<HP>;
  if (which == kForward) kern = &flash_fwd_tc_kernel<HP>;
  if (which == kBwdDkdv) kern = &flash_bwd_dkdv_tc_kernel<HP>;
  const size_t smem = smem_bytes(which, a.H, kBF16);
  if (int e = set_smem((const void*)kern, smem)) return e;
  // the tile axis is the slowest, so blocks are handed out heaviest tiles first
  const int tiles = (a.S + kTcRows - 1) / kTcRows;
  if (tiles > 65535 || a.B > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(which == kBwdDkdv ? a.n_kv : a.N, a.B, tiles);
  kern<<<grid, kTcThreads, smem, stream>>>(a, vec);
  return (int)cudaGetLastError();
}

// elements per global copy: the widest of 8, 4, 2 that divides H and keeps
// every bf16 pointer of the call aligned to the copy; 0 if none does
int copy_width(const Args& a) {
  const uintptr_t bits = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v | (uintptr_t)a.dout |
                         (uintptr_t)a.out | (uintptr_t)a.dk | (uintptr_t)a.dv;
  for (int vec = 8; vec >= 2; vec /= 2)
    if (a.H % vec == 0 && bits % (sizeof(bf16) * vec) == 0) return vec;
  return 0;
}

int launch_tc(int which, const Args& a, cudaStream_t stream) {
  const int vec = copy_width(a);
  if (vec == 0) return (int)cudaErrorMisalignedAddress;
  return with_padded_head(a.H, (int)cudaErrorInvalidValue, [&](auto hp) {
    return launch_tc_hp<decltype(hp)::value>(which, a, vec, stream);
  });
}

// dtype codes: 0 = float32 (FMA kernels), 1 = bfloat16 (tensor-core kernels)
int launch(int which, int dtype, const Args& a, cudaStream_t stream) {
  if (a.H <= 0 || a.H > kMaxH || a.H % 2 || a.n_kv <= 0 || a.N % a.n_kv)
    return (int)cudaErrorInvalidValue;
  if (a.B == 0 || a.S == 0) return (int)cudaSuccess;
  switch (dtype) {
    case kF32: return launch_f32(which, a, stream);
    case kBF16: return launch_tc(which, a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dynamic shared memory of one block of kernel `which` (0 forward, 1 dK/dV,
// 2 dQ) at head_dim H for dtype code `dtype`, in bytes
size_t flash_attention_smem_bytes(int which, int H, int dtype) {
  return smem_bytes(which, H, dtype);
}

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

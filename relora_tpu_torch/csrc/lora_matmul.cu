// The fused LoRA composite y = x@W + ((x@A)@B)*s and its backward, its
// grouped multi-tenant forward, and the int8 dequant matmul, for sm_90a.
//
// Replaces the TPU kernels of relora_tpu/ops/pallas_lora_matmul.py and
// relora_tpu/ops/pallas_quant_matmul.py:
//
//   fused_lora_forward_launch       kernel 4, _forward (:102) -> pallas_call :113
//                                   (_fused_lora_kernel :73): y (M, N) in x's
//                                   dtype and z = x@A (M, r) f32, the residual
//                                   of the backward
//   fused_lora_int8_forward_launch  kernel 4, int8 base (_fused_lora_int8_kernel
//                                   :88): the same with W = q * qscale
//   fused_lora_bwd_dx_launch        kernel 6, _backward_dx (:317) -> :327
//                                   (_bwd_dx_kernel :263): dx = g@W^T + s*(g@B^T)@A^T
//                                   in x's dtype, and u = g@B^T (M, r) f32
//   fused_lora_int8_bwd_dx_launch   kernel 6, int8 base (_bwd_dx_int8_kernel :279)
//   fused_lora_bwd_dab_launch       kernel 7, _backward_dab (:343) -> :347
//                                   (_bwd_dab_kernel :292): dA = s*x^T u (K, r) and
//                                   dB = s*z^T g (r, N), f32; it never reads W, so
//                                   it serves both bases
//   dequant_matmul_launch           kernel 8, pallas_quant_matmul.py _pallas_forward
//                                   (:46) -> :49 (_dequant_matmul_kernel :35):
//                                   y = x @ (q * scale) in x's dtype
//   grouped_lora_forward_launch     kernel 5, _grouped_forward (:161) -> :180
//                                   (_grouped_lora_kernel :142): y[m] = x[m]@W +
//                                   ((x[m]@A[idx[m]])@B[idx[m]])*s[idx[m]] in x's
//                                   dtype, one adapter slot per row; inference only
//
// x (M, K), g (M, N), A (K, r) and B (r, N) are row-major; W is the logical
// (K, N) base with any element strides (the port passes the (N, K) weight's
// transpose as a view).  Inputs are f32 or bf16 and are widened to f32 as they
// are staged; an int8 base is q (K, N) int8 codes, again at any strides, with
// qscale (1, N) f32 per output column: each code is widened and multiplied by
// its column's scale as the tile is staged, the f32 value the TPU kernel
// forms in VMEM, so no dequantized copy of W is ever written.  s is read from
// a device pointer (the trainable tanh(lora_s)) or given by value, so no call
// needs a host sync.  Any M, K, N and r (a rank past 256 included, as the
// TPU kernels take it: the GEMM's contraction segments have no rank limit and
// kernel 5's z pass walks the rank in chunks of 256): ragged tiles are masked.
//
// Design.  One tiled GEMM kernel, lora_gemm_kernel, computes
//     C = P1 @ Q1 + P2 @ (s * Q2)
// over two contraction segments for strided f32/bf16/scaled-int8 operands,
// and each TPU kernel is a short sequence of its launches on one stream:
//   forward:  z = x@A (f32), then y = x@W + z@(s*B)   (contraction K + r)
//   dx:       u = g@B^T (f32), then dx = g@W^T + u@(s*A^T)   (contraction N + r)
//   dA/dB:    partials of x^T u and z^T g over chunks of 512 rows of M, then
//             one reduce pass sums the chunks in a fixed order and scales by s
//   dequant:  y = x@(q*scale), one segment
// An operand is (pointer, two strides, type) plus, for int8, a scale pointer
// with two strides of its own: in the forward and kernel 8 the scale runs
// along the logical N columns of W (strides 0, 1); in dx the operand is W^T
// (N, K), so the same scale runs along its rows, the contraction axis
// (strides 1, 0).
// On the TPU every (i, j) program of the forward recomputes z for its M stripe
// and every (i, k) program of dx recomputes u; here each is computed once per
// row, written once as f32 (2 MB at M=4096, r=128) and read back from L2 by
// the second launch, whose grid is the full 2-D (M, N) tiling.  dx hands u on
// to dA/dB, which then skips its own u pass.  On the TPU dA and dB sum across
// a sequential grid; Hopper blocks run in no order, so the sum over M is
// split over blocks (the chunk index is blockIdx.z) into an f32 scratch the
// wrapper allocates, and reduced in a second pass: deterministic, no atomics.
//
// The GEMM block is 256 threads on a 64x64 or 128x128 output tile (128x128
// when that still gives two blocks per SM), with 16-deep slices of both
// operands staged in shared memory as f32 (k-major, so each thread reads its
// 4 or 8 rows and columns as float4s); each thread owns a 4x4 or 8x8 block of
// C in registers.  All math is f32 FMAs on the CUDA cores: no TF32, so the f32
// path is exact to summation order.  Tensor cores (mma.sync or wgmma fed by
// TMA) are later work.
//
// Bound.  At llama_250m training shapes (M = 4096, r = 128; (K, N) = (768,
// 768), (768, 2560), (2560, 768)) the forward and dx do 2M(KN + Kr + rN) flops
// over ~2(MK + KN + MN) bytes, about 600 flops per byte: above the H100's ~295
// bf16 balance point, so on tensor cores they would be bound by operations;
// dA/dB does 2Mr(K + N) flops over ~2M(K + N) + 4Mr bytes, below it, so bound
// by bytes.  Kernel 8 does 2MKN flops over 2MK + KN + 2MN bytes (int8 W): bound
// by operations too; the int8 base saves bytes that do not bound it here.
// These kernels use the f32 CUDA cores (67 TFLOP/s peak), so all are far
// from that bound by construction.
//
// Kernel 5 (grouped).  Multi-tenant serving stacks every adapter as slabs
// A (S, K, r), B (S, r, N), s (S,) f32, and each row m of a batch names its
// slot idx[m] (int32, read on the device).  The TPU kernel steers its DMAs by
// the prefetched idx so that no gathered A[idx] / B[idx] copy is written; here
// too each row reads its own slot's factors in place, and z is computed once
// per row, not once per N stripe as the TPU grid (M, N/bn) does.  Two launches:
//   z:  part[c, m, :] = x[m, chunk c] @ A[idx[m]][chunk c], chunks of 256 rows
//       of K, so that even M = 8 decode rows spread over many blocks; a thread
//       owns one rank column, the columns taken 256 at a time, so any r;
//   y:  lora_gemm_kernel's tiling: x @ W with one W tile per block for all its
//       rows, then, for each slot present among the block's rows, z (summed
//       over the chunks in order) of that slot's rows times s * B[slot]; a
//       slot no row of the block uses costs nothing, a used one is read once.
// Bound: at serving shapes (M <= 72) the bytes of W and of the distinct slots'
// factors dominate (2M(KN + Kr + rN) flops over ~2KN bytes is M flops per byte,
// far below the ~295 balance point), so it is bound by bytes; the f32 FMA
// tiles at M <= 72 leave most SMs idle (a 64 x 64 tile grid of N / 64 blocks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kBK = 16;        // contraction depth of one staged slice
constexpr int kChunk = 512;    // rows of M per dA/dB partial
constexpr int kZChunk = 256;   // rows of K per partial of kernel 5's z

enum { kF32 = 0, kBF16 = 1, kI8 = 2 };

struct Mat {  // a logical (rows x cols) operand
  const void* p;
  long long s0, s1;  // element strides of a row step and a column step
  int type;          // kF32, kBF16, or kI8: int8 codes times a per-element scale
  const float* sc;   // kI8: element (i, j) is p[i*s0 + j*s1] * sc[i*c0 + j*c1]
  long long c0, c1;
};

struct Gemm {
  // C[m, n] = sum_{k < K1} P1[m, k] Q1[k, n] + s * sum_{k < K2} P2[m, k] Q2[k, n]
  Mat p1, q1, p2, q2;
  int M, N, K1, K2;
  const float* s_ptr;  // device scalar; when null, s_val is s
  float s_val;
  void* c;             // C[m, n] at c + z * c_zstride + m * c_ld + n
  int c_bf16;
  long long c_ld, c_zstride;
  int kchunk;          // > 0: block z contracts segment 1 over [z * kchunk, (z + 1) * kchunk)
};

// element (i, j) of m as f32; an int8 code is widened, then scaled in f32
__device__ __forceinline__ float load(const Mat& m, long long i, long long j) {
  const long long off = i * m.s0 + j * m.s1;
  if (m.type == kBF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(m.p)[off]);
  if (m.type == kI8)
    return static_cast<float>(static_cast<const int8_t*>(m.p)[off]) * m.sc[i * m.c0 + j * m.c1];
  return static_cast<const float*>(m.p)[off];
}

// acc += ps^T qs over one staged kBK-deep slice: the thread owns rows ty*4 +
// 64*gi + {0..3} and columns tx*4 + 64*gj + {0..3}, so each quarter-warp reads
// 128 contiguous bytes, free of bank conflicts
template <int BM, int BN>
__device__ __forceinline__ void tile_fma(const float (&ps)[kBK][BM + 4],
                                         const float (&qs)[kBK][BN + 4],
                                         float (&acc)[BM / 16][BN / 16], int tx, int ty) {
  constexpr int TM = BM / 16, TN = BN / 16;
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    float pa[TM], qb[TN];
#pragma unroll
    for (int gi = 0; gi < TM / 4; ++gi) {
      const float4 v = *reinterpret_cast<const float4*>(&ps[kk][gi * 64 + ty * 4]);
      pa[gi * 4 + 0] = v.x;
      pa[gi * 4 + 1] = v.y;
      pa[gi * 4 + 2] = v.z;
      pa[gi * 4 + 3] = v.w;
    }
#pragma unroll
    for (int gj = 0; gj < TN / 4; ++gj) {
      const float4 v = *reinterpret_cast<const float4*>(&qs[kk][gj * 64 + tx * 4]);
      qb[gj * 4 + 0] = v.x;
      qb[gj * 4 + 1] = v.y;
      qb[gj * 4 + 2] = v.z;
      qb[gj * 4 + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(pa[i], qb[j], acc[i][j]);
  }
}

// the thread's block of C into c[zoff + m * c_ld + n], f32 or rounded to bf16
template <int BM, int BN>
__device__ __forceinline__ void store_tile(const float (&acc)[BM / 16][BN / 16], void* c,
                                           int c_bf16, long long c_ld, long long zoff, int M,
                                           int N, int m0, int n0, int tx, int ty) {
  constexpr int TM = BM / 16, TN = BN / 16;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + (j / 4) * 64 + tx * 4 + j % 4;
      if (n >= N) continue;
      const long long off = zoff + (long long)m * c_ld + n;
      if (c_bf16)
        static_cast<__nv_bfloat16*>(c)[off] = __float2bfloat16_rn(acc[i][j]);
      else
        static_cast<float*>(c)[off] = acc[i][j];
    }
  }
}

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 2) lora_gemm_kernel(Gemm g) {
  constexpr int TM = BM / 16, TN = BN / 16;  // rows and columns a thread owns
  __shared__ __align__(16) float ps[kBK][BM + 4];
  __shared__ __align__(16) float qs[kBK][BN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const float s = g.s_ptr ? *g.s_ptr : g.s_val;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int seg = 0; seg < 2; ++seg) {
    const Mat P = seg ? g.p2 : g.p1;
    const Mat Q = seg ? g.q2 : g.q1;
    const float qscale = seg ? s : 1.f;
    int k_begin = 0, k_end = seg ? g.K2 : g.K1;
    if (seg == 0 && g.kchunk > 0) {
      k_begin = blockIdx.z * g.kchunk;
      k_end = min(k_end, k_begin + g.kchunk);
    }
    for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
      // P slice (BM x kBK) and Q slice (kBK x BN), k-major, zero past the edges;
      // neighbouring threads walk the operand's unit-stride dimension
      for (int idx = tid; idx < BM * kBK; idx += kThreads) {
        int i, kk;
        if (P.s1 == 1) {
          kk = idx % kBK;
          i = idx / kBK;
        } else {
          i = idx % BM;
          kk = idx / BM;
        }
        const int m = m0 + i, k = k0 + kk;
        ps[kk][i] = (m < g.M && k < k_end) ? load(P, m, k) : 0.f;
      }
      for (int idx = tid; idx < kBK * BN; idx += kThreads) {
        int kk, j;
        if (Q.s1 == 1) {
          j = idx % BN;
          kk = idx / BN;
        } else {
          kk = idx % kBK;
          j = idx / kBK;
        }
        const int n = n0 + j, k = k0 + kk;
        qs[kk][j] = (n < g.N && k < k_end) ? qscale * load(Q, k, n) : 0.f;
      }
      __syncthreads();

      tile_fma<BM, BN>(ps, qs, acc, tx, ty);
      __syncthreads();
    }
  }

  store_tile<BM, BN>(acc, g.c, g.c_bf16, g.c_ld, (long long)blockIdx.z * g.c_zstride, g.M, g.N,
                     m0, n0, tx, ty);
}

// da[i] (i < n_da) and db[i - n_da] = s * sum over chunks of part[chunk, i],
// chunks summed in order
__global__ void lora_dab_reduce_kernel(const float* part, int chunks, long long len,
                                       long long n_da, const float* s_ptr, float s_val,
                                       float* da, float* db) {
  const float s = s_ptr ? *s_ptr : s_val;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < len;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < chunks; ++c) acc += part[c * len + i];
    acc *= s;
    if (i < n_da)
      da[i] = acc;
    else
      db[i - n_da] = acc;
  }
}

// Kernel 5, pass 1: part[c, m, j] = sum over k in chunk c of x[m, k] *
// A[idx[m], k, j], chunks of kZChunk rows of K; a row whose slot is outside
// [0, slots) gets zeros.  Block (c, m-stride): x's chunk of the row is staged
// in shared memory; the rank columns go in chunks of up to 256 (one chunk up
// to r = 256, so any r): within a chunk of rc columns, thread t owns column
// j = t % rp (rp = rc rounded up to 32, so a warp reads 32 neighbouring
// elements of A's row) and every (256 / rp)-th k of the chunk; the k groups
// are summed in a fixed order.
__global__ void __launch_bounds__(kThreads) grouped_z_kernel(const void* x, const void* a,
                                                            const int* idx, int slots,
                                                            float* part, int M, int K, int r,
                                                            int dtype) {
  __shared__ float xs[kZChunk];
  __shared__ float red[kThreads];
  const int c = blockIdx.x, tid = threadIdx.x;
  const int k0 = c * kZChunk, k1 = min(K, k0 + kZChunk);
  const Mat xm = {x, K, 1, dtype, nullptr, 0, 0};
  const Mat am = {a, r, 1, dtype, nullptr, 0, 0};  // slot s, row k is row s*K + k
  for (int m = blockIdx.y; m < M; m += gridDim.y) {
    const int slot = idx[m];
    const bool live = slot >= 0 && slot < slots;
    for (int k = k0 + tid; k < k1; k += kThreads) xs[k - k0] = live ? load(xm, m, k) : 0.f;
    __syncthreads();
    for (int j0 = 0; j0 < r; j0 += kThreads) {
      const int rc = min(kThreads, r - j0);
      const int rp = (rc + 31) / 32 * 32, groups = kThreads / rp;
      const int j = tid % rp, grp = tid / rp;
      float acc = 0.f;
      if (live && j < rc && grp < groups)
        for (int k = k0 + grp; k < k1; k += groups)
          acc = fmaf(xs[k - k0], load(am, (long long)slot * K + k, j0 + j), acc);
      red[tid] = acc;
      __syncthreads();
      if (grp == 0 && j < rc) {
        float sum = 0.f;
        for (int q = 0; q < groups; ++q) sum += red[q * rp + j];
        part[((long long)c * M + m) * r + j0 + j] = sum;
      }
      __syncthreads();  // red, and after the last chunk xs, are free again
    }
  }
}

struct GroupedY {
  // y[m, n] = sum_k x[m, k] W[k, n] + s[idx[m]] * sum_j z[m, j] B[idx[m], j, n]
  Mat x, w, b;         // b: (slots * r, N), slot s's row j at s*r + j
  const float* part;   // z as (chunks, M, r) f32 partials, summed in chunk order
  const float* s;      // (slots,) f32
  const int* idx;      // (M,) int32
  int slots, chunks, M, K, N, r;
  void* y;
  int y_bf16;
};

// Kernel 5, pass 2: lora_gemm_kernel's tiling.  The base segment stages one W
// tile for every row of the block, whatever their slots.  The adapter segment
// runs once for each slot present among the block's rows: it stages that
// slot's B tile times its scale, and z for the rows of that slot (zeros for
// the others), so each distinct slot's B is read once per block and a row
// only ever meets its own adapter.
template <int BM, int BN>
__global__ void __launch_bounds__(kThreads, 2) grouped_lora_kernel(GroupedY g) {
  __shared__ __align__(16) float ps[kBK][BM + 4];
  __shared__ __align__(16) float qs[kBK][BN + 4];
  __shared__ int sidx[BM];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  for (int i = tid; i < BM; i += kThreads) sidx[i] = m0 + i < g.M ? g.idx[m0 + i] : -1;

  float acc[BM / 16][BN / 16];
#pragma unroll
  for (int i = 0; i < BM / 16; ++i)
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < g.K; k0 += kBK) {
    for (int e = tid; e < BM * kBK; e += kThreads) {
      const int i = e / kBK, kk = e % kBK, m = m0 + i, k = k0 + kk;
      ps[kk][i] = (m < g.M && k < g.K) ? load(g.x, m, k) : 0.f;
    }
    for (int e = tid; e < kBK * BN; e += kThreads) {
      int kk, j;
      if (g.w.s1 == 1) {
        j = e % BN;
        kk = e / BN;
      } else {
        kk = e % kBK;
        j = e / kBK;
      }
      const int n = n0 + j, k = k0 + kk;
      qs[kk][j] = (n < g.N && k < g.K) ? load(g.w, k, n) : 0.f;
    }
    __syncthreads();
    tile_fma<BM, BN>(ps, qs, acc, tx, ty);
    __syncthreads();
  }

  for (int slot = 0; slot < g.slots; ++slot) {
    if (!__syncthreads_or(tid < BM && sidx[tid] == slot)) continue;
    const float s = g.s[slot];
    for (int k0 = 0; k0 < g.r; k0 += kBK) {
      for (int e = tid; e < BM * kBK; e += kThreads) {
        const int i = e / kBK, kk = e % kBK, m = m0 + i, k = k0 + kk;
        float z = 0.f;
        if (sidx[i] == slot && k < g.r)
          for (int c = 0; c < g.chunks; ++c) z += g.part[((long long)c * g.M + m) * g.r + k];
        ps[kk][i] = z;
      }
      for (int e = tid; e < kBK * BN; e += kThreads) {
        const int j = e % BN, kk = e / BN, n = n0 + j, k = k0 + kk;
        qs[kk][j] = (n < g.N && k < g.r) ? s * load(g.b, (long long)slot * g.r + k, n) : 0.f;
      }
      __syncthreads();
      tile_fma<BM, BN>(ps, qs, acc, tx, ty);
      __syncthreads();
    }
  }

  store_tile<BM, BN>(acc, g.y, g.y_bf16, g.N, 0, g.M, g.N, m0, n0, tx, ty);
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      count = 132;
  }
  return count;
}

int tiles(int n, int b) { return (n + b - 1) / b; }

int run_gemm(const Gemm& g, int chunks, cudaStream_t stream) {
  if (g.M == 0 || g.N == 0) return (int)cudaSuccess;
  // 128 x 128 tiles while they still give two blocks per SM, else 64 x 64
  const bool big = (long long)tiles(g.M, 128) * tiles(g.N, 128) * chunks >= 2LL * sm_count();
  const int bm = big ? 128 : 64;
  if (tiles(g.M, bm) > 65535 || chunks > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(tiles(g.N, bm), tiles(g.M, bm), chunks);
  if (big)
    lora_gemm_kernel<128, 128><<<grid, kThreads, 0, stream>>>(g);
  else
    lora_gemm_kernel<64, 64><<<grid, kThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

Mat mat(const void* p, long long s0, long long s1, int type) {
  return Mat{p, s0, s1, type, nullptr, 0, 0};
}

// int8 codes at strides (s0, s1) with their f32 scales at strides (c0, c1)
Mat qmat(const void* p, long long s0, long long s1, const float* sc, long long c0, long long c1) {
  return Mat{p, s0, s1, kI8, sc, c0, c1};
}

Gemm gemm(int M, int N, const float* s_ptr, float s_val, void* c, int c_bf16, long long c_ld) {
  Gemm g{};
  g.M = M;
  g.N = N;
  g.s_ptr = s_ptr;
  g.s_val = s_val;
  g.c = c;
  g.c_bf16 = c_bf16;
  g.c_ld = c_ld;
  return g;
}

// u = g @ B^T (M, r) f32
int u_pass(const void* g, const void* b, float* u, int M, int N, int r, int bf, cudaStream_t st) {
  Gemm q = gemm(M, r, nullptr, 1.f, u, 0, r);
  q.p1 = mat(g, N, 1, bf);
  q.q1 = mat(b, 1, N, bf);  // B^T (N, r)
  q.K1 = N;
  return run_gemm(q, 1, st);
}

bool bad_args(int M, int K, int N, int r, int dtype) {
  return M < 0 || K <= 0 || N <= 0 || r <= 0 || (dtype != kF32 && dtype != kBF16);
}

// z = x @ A, then y = x @ W + z @ (s * B); w is the logical (K, N) base
int fwd_pass(const void* x, const Mat& w, const void* a, const void* b, const float* s_ptr,
             float s_val, void* y, float* z, int M, int K, int N, int r, int dtype,
             cudaStream_t st) {
  Gemm zg = gemm(M, r, nullptr, 1.f, z, 0, r);
  zg.p1 = mat(x, K, 1, dtype);
  zg.q1 = mat(a, r, 1, dtype);
  zg.K1 = K;
  int err = run_gemm(zg, 1, st);
  if (err) return err;
  Gemm yg = gemm(M, N, s_ptr, s_val, y, dtype, N);
  yg.p1 = mat(x, K, 1, dtype);
  yg.q1 = w;
  yg.K1 = K;
  yg.p2 = mat(z, r, 1, kF32);
  yg.q2 = mat(b, N, 1, dtype);
  yg.K2 = r;
  return run_gemm(yg, 1, st);
}

// u = g @ B^T, then dx = g @ W^T + u @ (s * A^T); wt is the logical (N, K) W^T
int dx_pass(const void* g, const Mat& wt, const void* a, const void* b, const float* s_ptr,
            float s_val, void* dx, float* u, int M, int K, int N, int r, int dtype,
            cudaStream_t st) {
  int err = u_pass(g, b, u, M, N, r, dtype, st);
  if (err) return err;
  Gemm dg = gemm(M, K, s_ptr, s_val, dx, dtype, K);
  dg.p1 = mat(g, N, 1, dtype);
  dg.q1 = wt;
  dg.K1 = N;
  dg.p2 = mat(u, r, 1, kF32);
  dg.q2 = mat(a, 1, r, dtype);  // A^T (r, K)
  dg.K2 = r;
  return run_gemm(dg, 1, st);
}

}  // namespace

extern "C" {

const char* lora_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// rows of M per dA/dB partial: the wrapper sizes the scratch as
// (ceil(M / chunk), K*r + r*N) f32
int lora_matmul_dab_chunk() { return kChunk; }

// rows of K per partial of kernel 5's z: the wrapper sizes the scratch as
// (ceil(K / chunk), M, r) f32
int grouped_lora_z_chunk() { return kZChunk; }

// x (M, K); W logical (K, N) at element strides (w_s0, w_s1); A (K, r); B (r, N);
// y (M, N) in the inputs' dtype; z (M, r) f32.  dtype: 0 float32, 1 bfloat16.
int fused_lora_forward_launch(const void* x, const void* w, long long w_s0, long long w_s1,
                              const void* a, const void* b, const float* s_ptr, float s_val,
                              void* y, float* z, int M, int K, int N, int r, int dtype,
                              void* stream) {
  if (bad_args(M, K, N, r, dtype)) return (int)cudaErrorInvalidValue;
  return fwd_pass(x, mat(w, w_s0, w_s1, dtype), a, b, s_ptr, s_val, y, z, M, K, N, r, dtype,
                  static_cast<cudaStream_t>(stream));
}

// the same over an int8 base: q logical (K, N) int8 at element strides
// (q_s0, q_s1), qscale (1, N) f32 contiguous
int fused_lora_int8_forward_launch(const void* x, const void* q, long long q_s0, long long q_s1,
                                   const float* qscale, const void* a, const void* b,
                                   const float* s_ptr, float s_val, void* y, float* z, int M,
                                   int K, int N, int r, int dtype, void* stream) {
  if (bad_args(M, K, N, r, dtype)) return (int)cudaErrorInvalidValue;
  return fwd_pass(x, qmat(q, q_s0, q_s1, qscale, 0, 1), a, b, s_ptr, s_val, y, z, M, K, N, r,
                  dtype, static_cast<cudaStream_t>(stream));
}

// g (M, N); dx (M, K) in the inputs' dtype; u (M, r) f32 = g @ B^T, written
// for fused_lora_bwd_dab_launch
int fused_lora_bwd_dx_launch(const void* g, const void* w, long long w_s0, long long w_s1,
                             const void* a, const void* b, const float* s_ptr, float s_val,
                             void* dx, float* u, int M, int K, int N, int r, int dtype,
                             void* stream) {
  if (bad_args(M, K, N, r, dtype)) return (int)cudaErrorInvalidValue;
  return dx_pass(g, mat(w, w_s1, w_s0, dtype), a, b, s_ptr, s_val, dx, u, M, K, N, r, dtype,
                 static_cast<cudaStream_t>(stream));
}

// the same over an int8 base (q, qscale as in fused_lora_int8_forward_launch):
// in W^T the column scale runs along the contraction axis
int fused_lora_int8_bwd_dx_launch(const void* g, const void* q, long long q_s0, long long q_s1,
                                  const float* qscale, const void* a, const void* b,
                                  const float* s_ptr, float s_val, void* dx, float* u, int M,
                                  int K, int N, int r, int dtype, void* stream) {
  if (bad_args(M, K, N, r, dtype)) return (int)cudaErrorInvalidValue;
  return dx_pass(g, qmat(q, q_s1, q_s0, qscale, 1, 0), a, b, s_ptr, s_val, dx, u, M, K, N, r,
                 dtype, static_cast<cudaStream_t>(stream));
}

// kernel 8: y (M, N) = x (M, K) @ (q * qscale), q logical (K, N) int8 at element
// strides (q_s0, q_s1), qscale (1, N) f32; y in x's dtype
int dequant_matmul_launch(const void* x, const void* q, long long q_s0, long long q_s1,
                          const float* qscale, void* y, int M, int K, int N, int dtype,
                          void* stream) {
  if (bad_args(M, K, N, 1, dtype)) return (int)cudaErrorInvalidValue;
  Gemm yg = gemm(M, N, nullptr, 1.f, y, dtype, N);
  yg.p1 = mat(x, K, 1, dtype);
  yg.q1 = qmat(q, q_s0, q_s1, qscale, 0, 1);
  yg.K1 = K;
  return run_gemm(yg, 1, static_cast<cudaStream_t>(stream));
}

// g (M, N); x (M, K); z, u (M, r) f32 (u is computed here first unless
// have_u); part (chunks, K*r + r*N) f32 scratch with chunks = ceil(M / 512)
// (at least 1); dA (K, r) and dB (r, N) f32.
int fused_lora_bwd_dab_launch(const void* g, const void* x, const float* z, float* u, int have_u,
                              const void* b, const float* s_ptr, float s_val, float* part,
                              float* da, float* db, int M, int K, int N, int r, int dtype,
                              void* stream) {
  if (bad_args(M, K, N, r, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = have_u ? 0 : u_pass(g, b, u, M, N, r, dtype, st);
  if (err) return err;
  const int chunks = M > 0 ? tiles(M, kChunk) : 1;
  const long long len = (long long)K * r + (long long)r * N;
  Gemm ag = gemm(K, r, nullptr, 1.f, part, 0, r);  // x^T u, per chunk
  ag.p1 = mat(x, 1, K, dtype);                      // x^T (K, M)
  ag.q1 = mat(u, r, 1, 0);
  ag.K1 = M;
  ag.kchunk = kChunk;
  ag.c_zstride = len;
  if ((err = run_gemm(ag, chunks, st))) return err;
  Gemm bg = gemm(r, N, nullptr, 1.f, part + (long long)K * r, 0, N);  // z^T g, per chunk
  bg.p1 = mat(z, 1, r, 0);                                            // z^T (r, M)
  bg.q1 = mat(g, N, 1, dtype);
  bg.K1 = M;
  bg.kchunk = kChunk;
  bg.c_zstride = len;
  if ((err = run_gemm(bg, chunks, st))) return err;
  const long long want = (len + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 4096 ? want : 4096);
  lora_dab_reduce_kernel<<<blocks, kThreads, 0, st>>>(part, chunks, len, (long long)K * r, s_ptr,
                                                      s_val, da, db);
  return (int)cudaGetLastError();
}

// kernel 5: x (M, K); W logical (K, N) at element strides (w_s0, w_s1);
// a_stack (slots, K, r) and b_stack (slots, r, N) contiguous; s (slots,) f32;
// idx (M,) int32; part (ceil(K / 256), M, r) f32 scratch; y (M, N) in the
// inputs' dtype.  A row whose idx is outside [0, slots) gets x @ W alone.
int grouped_lora_forward_launch(const void* x, const void* w, long long w_s0, long long w_s1,
                                const void* a, const void* b, const float* s, const int* idx,
                                float* part, void* y, int M, int K, int N, int r, int slots,
                                int dtype, void* stream) {
  if (bad_args(M, K, N, r, dtype) || slots <= 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = tiles(K, kZChunk);
  dim3 zgrid(chunks, M < 65535 ? M : 65535);
  grouped_z_kernel<<<zgrid, kThreads, 0, st>>>(x, a, idx, slots, part, M, K, r, dtype);
  int err = (int)cudaGetLastError();
  if (err) return err;
  GroupedY g;
  g.x = mat(x, K, 1, dtype);
  g.w = mat(w, w_s0, w_s1, dtype);
  g.b = mat(b, N, 1, dtype);
  g.part = part;
  g.s = s;
  g.idx = idx;
  g.slots = slots;
  g.chunks = chunks;
  g.M = M;
  g.K = K;
  g.N = N;
  g.r = r;
  g.y = y;
  g.y_bf16 = dtype == kBF16;
  const bool big = (long long)tiles(M, 128) * tiles(N, 128) >= 2LL * sm_count();
  const int bm = big ? 128 : 64;
  if (tiles(M, bm) > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid(tiles(N, bm), tiles(M, bm));
  if (big)
    grouped_lora_kernel<128, 128><<<grid, kThreads, 0, st>>>(g);
  else
    grouped_lora_kernel<64, 64><<<grid, kThreads, 0, st>>>(g);
  return (int)cudaGetLastError();
}

}  // extern "C"

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
// are staged (the bf16 paths of kernels 4, 5 and 6 excepted: they feed bf16
// to the tensor cores, see their notes below); an int8 base is q (K, N) int8
// codes, again at any strides, with qscale (1, N) f32 per output column: each
// code is widened and multiplied by its column's scale as the tile is staged
// (kernel 4-int8's tensor-core path scales its accumulators per column
// instead; 6-int8's widens each staged tile into bf16 in shared memory), so
// no dequantized copy of W is ever written.  s is read from
// a device pointer (the trainable tanh(lora_s)) or given by value, so no call
// needs a host sync.  Any M, K, N and r (a rank past 256 included, as the
// TPU kernels take it: the GEMM's contraction segments have no rank limit and
// kernel 5 walks the rank in tiles of 64): ragged tiles are masked.
//
// Design.  One tiled GEMM kernel, lora_gemm_kernel, computes
//     C = P1 @ Q1 + P2 @ (s * Q2)
// over two contraction segments for strided f32/bf16/scaled-int8 operands,
// and each TPU kernel but the bf16 forward, dx and kernel 8 (below) is a short
// sequence of its launches on one stream:
//   forward:  z = x@A (f32), then y = x@W + z@(s*B)   (contraction K + r)
//   dx:       u = g@B^T (f32), then dx = g@W^T + u@(s*A^T)   (contraction N + r)
//   dA/dB:    partials of x^T u and z^T g over chunks of 512 rows of M, then
//             one reduce pass sums the chunks in a fixed order and scales by s
//   dequant:  y = x@(q*scale), one segment (f32 and the other layouts)
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
// path is exact to summation order.
//
// Bound.  At llama_250m training shapes (M = 4096, r = 128; (K, N) = (768,
// 768), (768, 2560), (2560, 768)) the forward and dx do 2M(KN + Kr + rN) flops
// over ~2(MK + KN + MN) bytes, about 600 flops per byte: above the H100's ~295
// bf16 balance point, so on tensor cores they are bound by operations (0.0855
// ms a decoder layer at 989 TFLOP/s); dA/dB does 2Mr(K + N) flops over ~2M(K +
// N) + 4Mr bytes, below it, so bound by bytes.  Kernel 8 does 2MKN flops over
// 2MK + KN + 2MN bytes (int8 W): bound by operations too; the int8 base saves
// bytes that do not bound it here.  lora_gemm_kernel uses the f32 CUDA cores
// (67 TFLOP/s peak), so dA/dB and the f32 forward, dx and kernel 8 are far
// from that bound by construction.
//
// Kernels 4 and 6 and their int8 variants on the tensor cores.  The bf16
// forward and dx with the base as the k-contiguous (N, K) storage (the
// transposed view the model passes; bf16 W or int8 codes) and K, N, r
// multiples of 8 run mma.sync m16n8k16, bf16 in, f32 accumulate, fed by
// cp.async and ldmatrix, each in two launches (TcArgs; dx is the forward's
// pair with x = g contracted over N, a = B, b = A, y = dx and z = u):
//   1. fused_fwd_z_tc_kernel (z = x@A) / fused_dx_u_tc_kernel (u = g@B^T):
//      (M, r) f32 in 64x64 tiles, 4 warps of 32x32, so that r = 128 gives 128
//      blocks at M = 4096, one wave of the 132 SMs.  A (K, r) row-major is a
//      [k][j] tile (ldmatrix.trans); B (r, N) row-major is B^T as a [j][k]
//      tile, the contraction contiguous (plain ldmatrix).  It signals
//      griddepcontrol.launch_dependents at once.
//   2. fused_fwd_y_tc_{bf16,int8}_kernel / fused_dx_tc_{bf16,int8}_kernel, a
//      programmatic dependent launch (PDL) of the first: 128x128 output
//      tiles, 8 warps of 64x32, two blocks an SM (128 registers a thread),
//      k-steps of 32 through a 4-stage cp.async ring.  Segment 1 is x@W (g@W^T):
//      x and g stage with cp.async and read with plain ldmatrix; the (N, K)
//      storage is [output][contraction] for the forward (plain ldmatrix) and
//      [contraction][output] for dx (16-byte cp.async along K, then
//      ldmatrix.trans).  Only then griddepcontrol.wait: segment 1 overlaps
//      the first launch.  Segment 2 stages z (u) from L2 as f32 (cp.async,
//      one step of 32 rank columns ahead), multiplies it by s (read on the
//      device) and splits it into hi = bf16(s z) and lo = bf16(s z - hi) as
//      it converts it into bf16 tiles; each half meets the factor in its own
//      MMA: B ((r, N) row-major, [j][n], ldmatrix.trans) for the forward, A
//      ((K, r) row-major, A^T as [n][j], plain ldmatrix) for dx, staged by
//      cp.async one step ahead, before the wait (inputs).  So the LoRA term
//      carries ~2^-16 relative error, not bf16's 2^-9, for 2r/K more MMAs.
//      The output rounds once to bf16.  Shared-memory rows are padded to an
//      odd multiple of 16 bytes (80, 144, 272), so ldmatrix is conflict-free.
// int8 base, forward: the (N, K) codes stage with 8-byte cp.async (half the
// bytes of bf16; a row of K = 8 mod 16 codes is only 8-byte aligned) and widen
// to bf16 in registers as the B fragments are formed (|q| <= 127 is exact in
// bf16).  sum_k x q scale[n] = scale[n] sum_k x q, so the f32 accumulators
// are scaled per output column after segment 1 and before segment 2: no
// per-element scale load, and no dequantized tile anywhere (the TPU kernel
// forms q * scale in VMEM).
// int8 base, dx: the scale runs along the contraction, so it cannot wait for
// the accumulators, and sm_90 has no 8-bit ldmatrix.trans to pair codes of
// two neighbouring rows into a B fragment.  So the codes' [k][n] tile stages
// with 8-byte cp.async, and one pass of the block widens it into a bf16
// [k][n] tile, each element bf16(q * scale[k]) formed in f32 and rounded
// once (a bf16 W carries the same one rounding by storage), which the dense
// path's ldmatrix.trans then reads.  The pass runs one stage ahead (stage kt
// + 1 widened while stage kt's MMAs run, into one of two tiles), so the ring
// keeps one barrier a step; the widened tile lives only in shared memory.
// Kernel 8 (bf16 x, the codes the same (N, K) view, K and N multiples of 8)
// is the int8 forward's y kernel cut to segment 1: dequant_matmul_tc_kernel,
// one launch of the same 128x128 tiles and 4-stage ring, the codes widened in
// registers, the accumulators scaled per column, y rounded once to bf16.  It
// reuses tc_seg1 and the epilogue helpers, so the four kernels above keep
// their code.
// Kernel 7 (bf16 g, x, K, N and r multiples of 8, aligned pointers) takes
// the tensor cores in three launches:
//   1. dab_split_kernel: u and z (M, r) f32 into hi = bf16(v) and lo =
//      bf16(v - hi) halves, (4, M, r) bf16 scratch (8 M r bytes, read from
//      L2 by launch 2).
//   2. dab_tc_kernel: dA = x^T u (K, r) and dB^T = g^T z (N, r) are the same
//      product C = L^T R over the rows of M, L bf16 and exact, R the two
//      halves, so both outputs' tiles share one grid: 128 x 128 tiles
//      (output rows x rank columns), 8 warps of 64 x 32, x blockIdx.y = the
//      chunk of kChunk rows of M.  The chunks come from M alone, never from
//      the card.  Stages of 64 rows of M through a 3-stage cp.async ring; L's
//      [m][p] tile is the transposed A operand and the halves' [m][j] tiles
//      the B operand, all by ldmatrix.trans; each L fragment meets hi and lo
//      in its own MMA, so the f32 operand carries ~2^-16 of its value into
//      the product, not bf16's 2^-9.  Each block writes its f32 partial,
//      dB's transposed, into the chunk's slice of part.
//   3. dab_reduce_kernel, a programmatic dependent launch of the second:
//      reads s (an input), waits for the partials, and sums the chunks in
//      order, four elements a thread with eight chunks' loads in flight, then
//      scales: deterministic, no atomics, no host sync.
//   On the card (tools/dab_variants.py) 64-row stages, one barrier per 64
//   rows, beat 32-row ones; 128 x 64 tiles, 256-row chunks and a fourth
//   stage did not help.
//   At llama_250m (M = 4096, r = 128) a (768, 768) projection is 12 tiles x 8
//   chunks, a (768, 2560) one 26 x 8.  Bytes still bound the function: the
//   halves double its 2 M r (K + N) products, which at 989 TFLOP/s stay
//   below the time of its bytes; the partials, 4 (K + N) r bytes a chunk,
//   are written and read once more on top.
// The wrappers pick these paths by one rule (ops/lora_matmul.forward_path,
// with no rank test for kernel 8, no base for kernel 7); every other forward,
// dx, dA/dB or kernel 8 (f32, a contiguous (K, N) base, ragged widths,
// unaligned pointers) runs lora_gemm_kernel, exact to summation order.
//
// Kernel 5 (grouped).  Multi-tenant serving stacks every adapter as slabs
// A (S, K, r), B (S, r, N), s (S,) f32, and each row m of a batch names its
// slot idx[m] (int32, read on the device).  The TPU kernel steers its DMAs by
// the prefetched idx so that no gathered A[idx] / B[idx] copy is written; here
// too each slot's factors are read in place, and a slot no row uses is never
// read.
// Bound: at serving shapes (M = 8 decode rows, 64 a prefill chunk, 72 a packed
// step; r = 128) 2M(KN + Kr + rN) operations over ~2(KN + used (Kr + rN))
// bytes is about M operations per byte, far below the H100's ~295: kernel 5 is
// bound by the bytes of W and of the used slots' factors (~33 MB a llama_250m
// layer, ~0.01 ms at 3.35 TB/s), and at these sizes by the latency of
// reaching them.  So the design spreads W over the whole card and reads each
// used slot's factors once.  Two launches, the second a programmatic
// dependent launch (PDL) that starts while the first runs and waits for its
// writes with griddepcontrol.wait:
//   1. grouped_*_base_shrink: two kinds of block in one grid.
//      Base blocks: y^T = W^T x^T split over K.  A block owns 16 rows of N
//      (one m16 tile) and one K chunk of the split schedule (kc rows, the
//      splits chosen from K and N alone, never from M or the slots, so that
//      at llama_250m every shape launches 288-320 base blocks); its 4 warps
//      take interleaved 32-row groups of the chunk and sum in warp order
//      through shared memory; the f32 partial goes to part[split, m, n].
//      Shrink blocks: one per (slot, 256 rows of K, 64 rank columns); a block
//      whose slot no row uses returns at once; the others stage that slot's A
//      chunk once for all their rows and write z partials (f32) of the rows of
//      their slot to zpart[chunk, m, j].
//   2. grouped_*_reduce: one block per (64 columns of N, 64 rows of M, slot),
//      slot S standing for the rows without one; a block whose slot has no
//      row in its tile returns at once.  The others read that slot's B tile
//      once (before waiting on pass 1: it is an input), sum their rows' base
//      partials in split order and z in chunk order (so a row's result never
//      depends on the other rows of its batch), scale z by s and add
//      (s z) @ B[slot].  The f32 path's reduce takes (N, M) tiles and each row
//      its own slot's B column by column.
// bf16 (W the transposed view of a contiguous (N, K) weight, the model's
// layout, and K, N, r multiples of 8): the tensor cores, mma.sync m16n8k16
// bf16 in, f32 accumulate, as y^T = W^T x^T, so the decode rows fill the
// n = 8 side of the tile exactly.  Base blocks read W and x straight into
// registers with 16-byte loads: lane (g, t) loads elements 8t..8t+7 of its
// rows' 32-element group, which are the fragments of two k16 steps under
// one permutation of k applied to both operands (a sum does not care about
// order).  Shrink and reduce stage the A, x and B tiles in shared memory with
// 16-byte cp.async and read them with ldmatrix (.trans for A and B).  z meets
// B as two bf16 halves, hi = bf16(s z) and lo = bf16(s z - hi): the pair carries z to
// ~2^-16 of its value, so the LoRA term adds ~2^-16 relative error (one
// bf16 rounding would add 2^-9); y rounds once to bf16 at the end.  Every
// other case (f32, a contiguous (K, N) W, ragged alignment) runs the same
// grid and split schedule on exact f32 FMAs: there sums differ from the
// twin in order only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kBK = 16;        // contraction depth of one staged slice
constexpr int kChunk = 512;    // rows of M per dA/dB partial

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

// ---------------------------------------------------------------------------
// Kernel 5: the grouped multi-tenant forward (design in the header note)
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kG5Threads = 128;  // 4 warps
constexpr int kG5Rows = 16;      // N rows of a base block: one m16 tile of y^T
constexpr int kG5MTile = 64;     // M columns a warp holds at once: 8 n8 tiles
constexpr int kG5Batch = 2;      // 32-row K groups a warp has in flight
constexpr int kG5ZChunk = 256;   // rows of K per shrink partial
constexpr int kG5Tile = 64;      // rank columns of a shrink block; N, M of a reduce block
constexpr int kG5Ld = kG5Tile + 8;  // smem row stride (bf16): 144 bytes, an odd multiple
                                    // of 16, so ldmatrix reads are conflict-free
constexpr int kG5RedLd = kG5Rows + 1;  // f32 row stride of the warps' partials in smem
constexpr int kG5XLd = kG5ZChunk + 8;   // smem row stride (bf16) of a shrink block's x chunk
constexpr int kG5Pass = 128;            // rank rows a reduce block stages at once
constexpr int kG5PLd = kG5Pass + 8;     // smem row stride (bf16) of the reduce block's z halves
constexpr int kG5YLd = kG5Tile + 4;     // f32 row stride of the reduce block's base sums
// dynamic shared memory of the tensor-core passes: pass 1's A tile and x
// chunk (a base block uses the front for its warps' partials); pass 2's B
// rows, the z halves and the base sums
constexpr int kG5Smem1 = (kG5ZChunk * kG5Ld + kG5Tile * kG5XLd) * 2 + kG5MTile * 4;
constexpr int kG5Smem2 = (kG5Pass * kG5Ld + 2 * kG5Tile * kG5PLd) * 2 + kG5Tile * kG5YLd * 4;
constexpr int kG5Loads = 8;  // partials a thread loads at once before summing them in order

struct Grouped {
  // y[m, n] = sum_k x[m, k] W[k, n] + s[idx[m]] * sum_j z[m, j] B[idx[m], j, n],
  // z[m, j] = sum_k x[m, k] A[idx[m], k, j]
  const void* x;   // (M, K) row-major
  const void* w;   // logical (K, N) at element strides (ws0, ws1)
  long long ws0, ws1;
  const void* a;   // (S, K, r) row-major
  const void* b;   // (S, r, N) row-major
  const float* s;  // (S,)
  const int* idx;  // (M,)
  float* part;     // (splits, M, N) base partials
  float* zpart;    // (zchunks, M, r) shrink partials, each row under its own slot
  void* y;         // (M, N) in the inputs' dtype
  int M, K, N, r, S;
  int splits, kc;         // split s contracts K rows [s * kc, (s + 1) * kc)
  int zchunks, rtiles;    // shrink blocks per slot: zchunks x rtiles
  int bf16;
};

// mma.sync helpers, as in flash_attention.cu
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d (16 x 8 f32) += a (16 x 16 bf16, row) b (16 x 8 bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bytes from src to smem dst by cp.async, or zeros when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// A-operand address of ldmatrix.x4.trans for a 16 x 16 slice stored [k][row]:
// row k0 + lane % 8 + (lane / 16) * 8, column (lane / 8) % 2 * 8
__device__ __forceinline__ const bf16* a_trans(const bf16* tile, int k0, int col0, int lane) {
  return tile + (k0 + lane % 8 + (lane / 16) * 8) * kG5Ld + col0 + ((lane / 8) % 2) * 8;
}

__device__ __forceinline__ uint4 ld16(const bf16* p, bool ok) {
  return ok ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0, 0, 0, 0);
}

__device__ __forceinline__ int g5_ntiles(const Grouped& g) { return (g.N + kG5Rows - 1) / kG5Rows; }

// the accumulator element e of an m16n8 tile j: (row, column) within the tile
__device__ __forceinline__ int acc_row(int lane, int e) { return lane / 4 + (e >> 1) * 8; }
__device__ __forceinline__ int acc_col(int lane, int j, int e) {
  return 8 * j + 2 * (lane % 4) + (e & 1);
}

// base block (tile nt of 16 N rows, split q) on the tensor cores.  Warp w takes
// the chunk's 32-row groups w, w + 4, ...; lane (gr, t) loads W^T rows gr and
// gr + 8 and x row gr of each n8 tile at elements 8t..8t+7 of the group: one
// 16-byte load each, the fragments of two k16 steps under one permutation of k
__device__ void base_tc(const Grouped& g, int nt, int q, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gr = lane / 4, t = lane % 4;
  const int n0 = nt * kG5Rows, k_begin = q * g.kc, k_end = min(g.K, k_begin + g.kc);
  const int groups = (k_end - k_begin + 31) / 32;
  const bf16* x = static_cast<const bf16*>(g.x);
  const bf16* wt = static_cast<const bf16*>(g.w);  // W^T (N, K): W[k, n] at n * ws1 + k
  const bool oka = n0 + gr < g.N, okb = n0 + gr + 8 < g.N;
  const bf16* wa_row = wt + (long long)(oka ? n0 + gr : 0) * g.ws1;
  const bf16* wb_row = wt + (long long)(okb ? n0 + gr + 8 : 0) * g.ws1;
  for (int m0 = 0; m0 < g.M; m0 += kG5MTile) {
    const int mt = min(kG5MTile, g.M - m0), n8 = (mt + 7) / 8;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int g0 = warp; g0 < groups; g0 += 4 * kG5Batch) {
      uint4 wa[kG5Batch], wb[kG5Batch];
      int kk[kG5Batch];
      bool ok[kG5Batch];
#pragma unroll
      for (int u = 0; u < kG5Batch; ++u) {
        kk[u] = k_begin + (g0 + 4 * u) * 32 + 8 * t;
        ok[u] = g0 + 4 * u < groups && kk[u] < k_end;
        wa[u] = ld16(wa_row + kk[u], ok[u] && oka);
        wb[u] = ld16(wb_row + kk[u], ok[u] && okb);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= n8) break;
        const int m = m0 + 8 * j + gr;
        const bf16* xr = x + (long long)(m < g.M ? m : 0) * g.K;
        uint4 xv[kG5Batch];
#pragma unroll
        for (int u = 0; u < kG5Batch; ++u) xv[u] = ld16(xr + kk[u], ok[u] && m < g.M);
#pragma unroll
        for (int u = 0; u < kG5Batch; ++u) {
          mma16816(acc[j], wa[u].x, wb[u].x, wa[u].y, wb[u].y, xv[u].x, xv[u].y);
          mma16816(acc[j], wa[u].z, wb[u].z, wa[u].w, wb[u].w, xv[u].z, xv[u].w);
        }
      }
    }
    float* mine = red + warp * kG5MTile * kG5RedLd;  // [m][n]
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= n8) break;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mine[acc_col(lane, j, e) * kG5RedLd + acc_row(lane, e)] = acc[j][e];
    }
    __syncthreads();
    for (int e = threadIdx.x; e < mt * kG5Rows; e += kG5Threads) {
      const int mm = e / kG5Rows, nn = e % kG5Rows, o = mm * kG5RedLd + nn;
      const int span = kG5MTile * kG5RedLd;
      if (n0 + nn < g.N)
        g.part[((long long)q * g.M + m0 + mm) * g.N + n0 + nn] =
            ((red[o] + red[span + o]) + red[2 * span + o]) + red[3 * span + o];
    }
    __syncthreads();
  }
}

// base block on f32 FMAs, for any layout and dtype: thread (n = tid / 8,
// lane kl = tid % 8) takes every 8th K row of the chunk from k_begin + kl, M in
// tiles of 8; the 8 lanes are summed by a fixed shuffle tree
__device__ void base_fma(const Grouped& g, int nt, int q) {
  const int type = g.bf16 ? kBF16 : kF32;
  const Mat x = {g.x, g.K, 1, type, nullptr, 0, 0};
  const Mat w = {g.w, g.ws0, g.ws1, type, nullptr, 0, 0};
  const int n = nt * kG5Rows + threadIdx.x / 8, kl = threadIdx.x % 8;
  const int k_begin = q * g.kc, k_end = min(g.K, k_begin + g.kc);
  for (int m0 = 0; m0 < g.M; m0 += 8) {
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    if (n < g.N)
      for (int k = k_begin + kl; k < k_end; k += 8) {
        const float wv = load(w, k, n);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (m0 + i < g.M) acc[i] = fmaf(load(x, m0 + i, k), wv, acc[i]);
      }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = acc[i];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      if (kl == 0 && n < g.N && m0 + i < g.M) g.part[((long long)q * g.M + m0 + i) * g.N + n] = v;
    }
  }
}

// does any row use `slot`?  (block-wide)
__device__ bool slot_used(const Grouped& g, int slot) {
  bool any = false;
  for (int m = threadIdx.x; m < g.M; m += kG5Threads) any |= g.idx[m] == slot;
  return __syncthreads_or(any);
}

// shrink block (slot, K chunk c, rank tile rt) on the tensor cores:
// z^T = A[slot]^T x^T over the chunk.  A's (256 x 64) tile is staged once and
// read by ldmatrix.trans; per 64 rows of M, x's (rows x 256) chunk is staged
// beside it and read by ldmatrix (both by cp.async, zero past M, K and r);
// warp w owns rank columns rt * 64 + 16w..+16, and stores its slot's rows only
__device__ void shrink_tc(const Grouped& g, int slot, int c, int rt, bf16* as, bf16* xs,
                          int* sidx) {
  if (!slot_used(g, slot)) return;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = c * kG5ZChunk, j0 = rt * kG5Tile;
  const bf16* a = static_cast<const bf16*>(g.a) + (long long)slot * g.K * g.r;
  const bf16* x = static_cast<const bf16*>(g.x);
  for (int e = threadIdx.x; e < kG5ZChunk * (kG5Tile / 8); e += kG5Threads) {
    const int kk = e / (kG5Tile / 8), cc = (e % (kG5Tile / 8)) * 8;
    const bool ok = k0 + kk < g.K && j0 + cc < g.r;
    cp_async16(as + kk * kG5Ld + cc, ok ? a + (long long)(k0 + kk) * g.r + j0 + cc : a, ok);
  }
  for (int m0 = 0; m0 < g.M; m0 += kG5MTile) {
    const int mt = min(kG5MTile, g.M - m0), n8 = (mt + 7) / 8, n16 = (mt + 15) / 16;
    if (m0 > 0) __syncthreads();  // xs is free
    for (int e = threadIdx.x; e < n16 * 16 * (kG5ZChunk / 8); e += kG5Threads) {
      const int mm = e / (kG5ZChunk / 8), cc = (e % (kG5ZChunk / 8)) * 8;
      const bool ok = m0 + mm < g.M && k0 + cc < g.K;
      cp_async16(xs + mm * kG5XLd + cc, ok ? x + (long long)(m0 + mm) * g.K + k0 + cc : x, ok);
    }
    for (int i = threadIdx.x; i < kG5MTile; i += kG5Threads) sidx[i] = i < mt ? g.idx[m0 + i] : -1;
    cp_async_wait();
    __syncthreads();
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kG5ZChunk / 16; ++ks) {
      uint32_t af[4];
      ldsm_x4_t(af, a_trans(as, ks * 16, warp * 16, lane));
#pragma unroll
      for (int p = 0; p < 4; ++p) {  // n8 tiles 2p and 2p + 1
        if (p >= n16) break;
        uint32_t bx[4];
        ldsm_x4(bx, xs + (p * 16 + lane % 8 + (lane / 16) * 8) * kG5XLd + ks * 16 +
                        ((lane / 8) % 2) * 8);
        mma16816(acc[2 * p], af[0], af[1], af[2], af[3], bx[0], bx[1]);
        mma16816(acc[2 * p + 1], af[0], af[1], af[2], af[3], bx[2], bx[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j >= n8) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = acc_col(lane, j, e), jj = j0 + warp * 16 + acc_row(lane, e);
        if (jj < g.r && sidx[col] == slot)
          g.zpart[((long long)c * g.M + m0 + col) * g.r + jj] = acc[j][e];
      }
    }
  }
}

// shrink block on f32 FMAs: thread (column j = tid % 64, half = tid / 64)
// sums every other K row of the chunk for each row of the slot; halves added in order
__device__ void shrink_fma(const Grouped& g, int slot, int c, int rt, float* red) {
  if (!slot_used(g, slot)) return;
  const int type = g.bf16 ? kBF16 : kF32;
  const Mat x = {g.x, g.K, 1, type, nullptr, 0, 0};
  const Mat a = {g.a, g.r, 1, type, nullptr, 0, 0};  // slot s, row k is row s*K + k
  const int jj = threadIdx.x % kG5Tile, half = threadIdx.x / kG5Tile, j = rt * kG5Tile + jj;
  const int k0 = c * kG5ZChunk, k1 = min(g.K, k0 + kG5ZChunk);
  for (int m = 0; m < g.M; ++m) {
    if (g.idx[m] != slot) continue;  // the same for every thread
    float acc = 0.f;
    if (j < g.r)
      for (int k = k0 + half; k < k1; k += 2)
        acc = fmaf(load(x, m, k), load(a, (long long)slot * g.K + k, j), acc);
    red[threadIdx.x] = acc;
    __syncthreads();
    if (half == 0 && j < g.r)
      g.zpart[((long long)c * g.M + m) * g.r + j] = red[jj] + red[kG5Tile + jj];
    __syncthreads();
  }
}

// pass 1: base blocks first, then shrink blocks, in one 1-D grid
__global__ void __launch_bounds__(kG5Threads, 3) grouped_tc_base_shrink_kernel(Grouped g) {
  extern __shared__ __align__(16) unsigned char smem[];
  static_assert(4 * kG5MTile * kG5RedLd * sizeof(float) <= kG5Smem1, "base partials fit");
  // the reduce pass may launch now: it waits for this grid's writes itself
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int base = g5_ntiles(g) * g.splits;
  if ((int)blockIdx.x < base) {
    base_tc(g, blockIdx.x % g5_ntiles(g), blockIdx.x / g5_ntiles(g),
            reinterpret_cast<float*>(smem));
  } else {
    const int b = blockIdx.x - base;
    bf16* as = reinterpret_cast<bf16*>(smem);
    bf16* xs = as + kG5ZChunk * kG5Ld;
    shrink_tc(g, b / (g.rtiles * g.zchunks), (b / g.rtiles) % g.zchunks, b % g.rtiles, as, xs,
              reinterpret_cast<int*>(xs + kG5Tile * kG5XLd));
  }
}

__global__ void __launch_bounds__(kG5Threads) grouped_fma_base_shrink_kernel(Grouped g) {
  __shared__ float red[kG5Threads];
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int base = g5_ntiles(g) * g.splits;
  if ((int)blockIdx.x < base) {
    base_fma(g, blockIdx.x % g5_ntiles(g), blockIdx.x / g5_ntiles(g));
  } else {
    const int b = blockIdx.x - base;
    shrink_fma(g, b / (g.rtiles * g.zchunks), (b / g.rtiles) % g.zchunks, b % g.rtiles, red);
  }
}

// slot and scale of the tile's rows (-1 and 0 past M or for a slot outside
// [0, S)); these are inputs, so they are read before the wait on pass 1
__device__ void tile_rows(const Grouped& g, int m0, int* sidx, float* sscale) {
  for (int i = threadIdx.x; i < kG5Tile; i += kG5Threads) {
    const int slot = m0 + i < g.M ? g.idx[m0 + i] : -1;
    const bool live = slot >= 0 && slot < g.S;
    sidx[i] = live ? slot : -1;
    sscale[i] = live ? g.s[slot] : 0.f;
  }
}

// row m's base, summed over the splits in order
__device__ __forceinline__ float base_sum(const Grouped& g, int m, int n) {
  float v = 0.f;
#pragma unroll 4
  for (int q = 0; q < g.splits; ++q) v += g.part[((long long)q * g.M + m) * g.N + n];
  return v;
}

// s[idx[m]] * z[m, j], z summed over the shrink chunks in order (0 for a row without a slot)
__device__ __forceinline__ float scaled_z(const Grouped& g, const int* sidx, const float* sscale,
                                          int m0, int mm, int j) {
  if (sidx[mm] < 0 || j >= g.r) return 0.f;
  float v = 0.f;
#pragma unroll 4
  for (int c = 0; c < g.zchunks; ++c) v += g.zpart[((long long)c * g.M + m0 + mm) * g.r + j];
  return v * sscale[mm];
}

// sums over `count` f32x4 partials at p, p + stride, ... in order, for two
// series at once, so that their loads are in flight together
__device__ __forceinline__ void sum4_pair(const float* p0, const float* p1, long long stride,
                                          int count, float4& a0, float4& a1) {
  a0 = a1 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < count; c0 += kG5Loads) {
    float4 v0[kG5Loads], v1[kG5Loads];
#pragma unroll
    for (int u = 0; u < kG5Loads; ++u) {
      const bool ok = c0 + u < count;
      const long long o = (c0 + u) * stride;
      v0[u] = ok ? __ldcg(reinterpret_cast<const float4*>(p0 + o)) : a0;
      v1[u] = ok ? __ldcg(reinterpret_cast<const float4*>(p1 + o)) : a1;
    }
#pragma unroll
    for (int u = 0; u < kG5Loads; ++u) {
      if (c0 + u >= count) break;
      a0 = make_float4(a0.x + v0[u].x, a0.y + v0[u].y, a0.z + v0[u].z, a0.w + v0[u].w);
      a1 = make_float4(a1.x + v1[u].x, a1.y + v1[u].y, a1.z + v1[u].z, a1.w + v1[u].w);
    }
  }
}

// the hi and lo bf16 halves of v into h[0] and l[0]
__device__ __forceinline__ void split_bf16(float v, bf16* h, bf16* l) {
  const bf16 hi = __float2bfloat16_rn(v);
  *h = hi;
  *l = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// pass 2 on the tensor cores: block (64 columns of N, 64 rows of M, slot),
// slot S taking the rows without one; a block with none of its slot's rows
// returns at once.  Warp w owns N rows n0 + 16w..+16 of y^T.  The slot's B
// rows [j][n] are staged (cp.async, before the wait: they are inputs) 256 at
// a time and read by ldmatrix.trans; (s z) of the slot's rows as bf16 hi and
// lo halves [m][j] (zero for the other rows) is the B operand; each of the
// slot's rows gets its base sum plus its LoRA term.
__global__ void __launch_bounds__(kG5Threads) grouped_tc_reduce_kernel(Grouped g) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* bs = reinterpret_cast<bf16*>(smem);
  bf16* zh = bs + kG5Pass * kG5Ld;
  bf16* zl = zh + kG5Tile * kG5PLd;
  float* ys = reinterpret_cast<float*>(zl + kG5Tile * kG5PLd);
  __shared__ int sidx[kG5Tile];
  __shared__ float sscale[kG5Tile];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, slot = blockIdx.z;
  const int n0 = blockIdx.x * kG5Tile, m0 = blockIdx.y * kG5Tile;
  const int mt = min(kG5Tile, g.M - m0), n8 = (mt + 7) / 8;
  tile_rows(g, m0, sidx, sscale);
  __syncthreads();
  auto own = [&](int i) { return i < mt && sidx[i] == (slot < g.S ? slot : -1); };
  if (!__syncthreads_or((int)threadIdx.x < kG5Tile && own(threadIdx.x))) return;
  __shared__ int rows[kG5Tile];  // the slot's rows, in order, so that all threads share them
  __shared__ int n_own;
  if (threadIdx.x == 0) {
    int n = 0;
    for (int i = 0; i < mt; ++i)
      if (own(i)) rows[n++] = i;
    n_own = n;
  }
  const bf16* b = static_cast<const bf16*>(g.b) + (long long)min(slot, g.S - 1) * g.r * g.N;
  auto stage_b = [&](int r0) {
    for (int e = threadIdx.x; e < kG5Pass * (kG5Tile / 8); e += kG5Threads) {
      const int jj = e / (kG5Tile / 8), cc = (e % (kG5Tile / 8)) * 8;
      const bool ok = r0 + jj < g.r && n0 + cc < g.N;
      cp_async16(bs + jj * kG5Ld + cc, ok ? b + (long long)(r0 + jj) * g.N + n0 + cc : b, ok);
    }
  };
  if (slot < g.S) stage_b(0);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");

  // zero z halves: the other rows' columns of the B operand stay zero
  for (int e = threadIdx.x; e < 2 * kG5Tile * kG5PLd / 8; e += kG5Threads)
    reinterpret_cast<uint4*>(zh)[e] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  // the slot's rows' base, summed over the splits in order, 4 columns an item
  // and two items a thread at a time; items go to the threads from the last
  // down, so that at few rows these loads and z's below run on other warps
  const int quads_n = kG5Tile / 4, items_n = n_own * quads_n;
  for (int e = kG5Threads - 1 - threadIdx.x; e < items_n; e += 2 * kG5Threads) {
    const float* p[2];
    float* dst[2];
    for (int u = 0; u < 2; ++u) {  // an item past the end, or past N, reads a dummy
      const int item = e + u * kG5Threads, mm = rows[min(item, items_n - 1) / quads_n];
      const int nn = (item % quads_n) * 4;
      const bool live = item < items_n && n0 + nn < g.N;
      p[u] = live ? g.part + (long long)(m0 + mm) * g.N + n0 + nn : g.part;
      dst[u] = live ? ys + mm * kG5YLd + nn : nullptr;
    }
    float4 v[2];
    sum4_pair(p[0], p[1], (long long)g.M * g.N, g.splits, v[0], v[1]);
    for (int u = 0; u < 2; ++u)
      if (dst[u]) *reinterpret_cast<float4*>(dst[u]) = v[u];
  }
  float lora[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) lora[j][e] = 0.f;
  for (int r0 = 0; slot < g.S && r0 < g.r; r0 += kG5Pass) {
    if (r0 > 0) {
      __syncthreads();  // bs, zh and zl are free
      stage_b(r0);
    }
    // (s z) of the slot's rows, 4 rank columns an item and two items a
    // thread at a time, z summed over the shrink chunks in order; zero past r
    const int ksteps = (min(kG5Pass, g.r - r0) + 15) / 16, quads = ksteps * 4;
    const int items = n_own * quads;
    for (int e = threadIdx.x; e < items; e += 2 * kG5Threads) {
      int mm[2], jj[2];
      bool live[2];
      const float* p[2];
      for (int u = 0; u < 2; ++u) {  // an item past the end, or past r, reads a dummy
        const int item = e + u * kG5Threads;
        mm[u] = rows[min(item, items - 1) / quads];
        jj[u] = (item % quads) * 4;
        live[u] = item < items && r0 + jj[u] < g.r;
        p[u] = live[u] ? g.zpart + (long long)(m0 + mm[u]) * g.r + r0 + jj[u] : g.zpart;
      }
      float4 v[2];
      sum4_pair(p[0], p[1], (long long)g.M * g.r, g.zchunks, v[0], v[1]);
      for (int u = 0; u < 2; ++u) {
        if (e + u * kG5Threads >= items) break;
        const float s = live[u] ? sscale[mm[u]] : 0.f;
        bf16* h = zh + mm[u] * kG5PLd + jj[u];
        bf16* l = zl + mm[u] * kG5PLd + jj[u];
        split_bf16(v[u].x * s, h, l);
        split_bf16(v[u].y * s, h + 1, l + 1);
        split_bf16(v[u].z * s, h + 2, l + 2);
        split_bf16(v[u].w * s, h + 3, l + 3);
      }
    }
    cp_async_wait();
    __syncthreads();
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t af[4];
      ldsm_x4_t(af, a_trans(bs, ks * 16, warp * 16, lane));
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= n8) break;
        const int o = (8 * j + lane / 4) * kG5PLd + ks * 16 + 2 * (lane % 4);
        const uint32_t* h = reinterpret_cast<const uint32_t*>(zh + o);
        const uint32_t* l = reinterpret_cast<const uint32_t*>(zl + o);
        mma16816(lora[j], af[0], af[1], af[2], af[3], h[0], h[4]);
        mma16816(lora[j], af[0], af[1], af[2], af[3], l[0], l[4]);
      }
    }
  }
  __syncthreads();  // ys is complete

  bf16* y = static_cast<bf16*>(g.y);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j >= n8) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = acc_col(lane, j, e), n = n0 + warp * 16 + acc_row(lane, e);
      if (own(col) && n < g.N)
        y[(long long)(m0 + col) * g.N + n] =
            __float2bfloat16_rn(ys[col * kG5YLd + n - n0] + lora[j][e]);
    }
  }
}

// pass 2 on f32 FMAs: block (64 columns of N, 64 rows of M); thread (n = tid %
// 64, rows tid / 64 + 2i) accumulates its rows' LoRA terms in smem, per 64
// rank columns of (s z) staged as f32, reading its row's slot of B
__global__ void __launch_bounds__(kG5Threads) grouped_fma_reduce_kernel(Grouped g) {
  __shared__ float zs[kG5Tile][kG5Tile + 1];
  __shared__ float lo[kG5Tile][kG5Tile];
  __shared__ int sidx[kG5Tile];
  __shared__ float sscale[kG5Tile];
  const int type = g.bf16 ? kBF16 : kF32;
  const Mat b = {g.b, g.N, 1, type, nullptr, 0, 0};  // slot s, row j is row s*r + j
  const int n0 = blockIdx.x * kG5Tile, m0 = blockIdx.y * kG5Tile;
  const int mt = min(kG5Tile, g.M - m0);
  const int nn = threadIdx.x % kG5Tile, n = n0 + nn, row0 = threadIdx.x / kG5Tile;
  constexpr int kStep = kG5Threads / kG5Tile;
  tile_rows(g, m0, sidx, sscale);
  for (int mm = row0; mm < kG5Tile; mm += kStep) lo[mm][nn] = 0.f;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  __syncthreads();
  for (int r0 = 0; r0 < g.r; r0 += kG5Tile) {
    for (int e = threadIdx.x; e < kG5Tile * kG5Tile; e += kG5Threads) {
      const int mm = e / kG5Tile, jj = e % kG5Tile;
      zs[mm][jj] = mm < mt ? scaled_z(g, sidx, sscale, m0, mm, r0 + jj) : 0.f;
    }
    __syncthreads();
    const int rc = min(kG5Tile, g.r - r0);
    for (int mm = row0; mm < mt; mm += kStep) {
      const int slot = sidx[mm];
      if (slot < 0 || n >= g.N) continue;
      float acc = lo[mm][nn];
      for (int jj = 0; jj < rc; ++jj)
        acc = fmaf(zs[mm][jj], load(b, (long long)slot * g.r + r0 + jj, n), acc);
      lo[mm][nn] = acc;
    }
    __syncthreads();
  }
  for (int mm = row0; mm < mt; mm += kStep) {
    if (n >= g.N) continue;
    const float v = base_sum(g, m0 + mm, n) + lo[mm][nn];
    const long long off = (long long)(m0 + mm) * g.N + n;
    if (g.bf16)
      static_cast<bf16*>(g.y)[off] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(g.y)[off] = v;
  }
}

// ---------------------------------------------------------------------------
// Kernels 4, 4-int8, 6 and 6-int8 on the tensor cores (design in the header note)
// ---------------------------------------------------------------------------

constexpr int kFwdBK = 32;            // contraction depth of one stage
constexpr int kFwdStages = 4;         // cp.async ring depth
constexpr int kFwdKLd = kFwdBK + 8;   // bf16 row stride of a [row][k] tile: 80 bytes
constexpr int kFwdQLd = kFwdBK + 16;  // int8 row stride of the codes' [n][k] tile: 48 bytes
constexpr int kFwdZLd = kFwdBK + 4;   // f32 row stride of z's [m][j] tile: 144 bytes
constexpr int kZThreads = 128, kZBM = 64, kZBN = 64;  // z launch: 4 warps of 32 x 32
constexpr int kZNLd = kZBN + 8;                       // bf16 row stride of A's [k][j] tile: 144 bytes
constexpr int kYThreads = 256, kYBM = 128, kYBN = 128;  // y launch: 8 warps of 64 x 32
constexpr int kYWarpsN = kYBN / 32;
constexpr int kYNLd = kYBN + 8;  // bf16 row stride of B's [j][n] tile: 272 bytes
// y's dynamic shared memory: segment 1's ring of (x tile, base tile) stages,
// then, reused, segment 2's two buffers of (hi and lo z tiles, B tile) and
// its f32 z tile
constexpr int kYTile = kYBM * kFwdKLd * 2;  // bytes of a 128-row [row][k] bf16 tile
constexpr int kYStage = 2 * kYTile;
constexpr int kY2Buf = 2 * kYTile + kFwdBK * kYNLd * 2;
constexpr int kYSmem2 = 2 * kY2Buf + kYBM * kFwdZLd * 4;
constexpr int kYSmem = kFwdStages * kYStage > kYSmem2 ? kFwdStages * kYStage : kYSmem2;
static_assert(kYBN * kFwdQLd <= kYTile, "the int8 code tile fits in a base slot");
// dx over int8 codes: a stage holds the g tile and the codes' [k][n] tile
// (row stride 144 bytes), and two bf16 [k][n] tiles beside the ring take the
// widened, scaled codes
constexpr int kDxQLd = kYBN + 16;
constexpr int kDxQTile = kFwdBK * kDxQLd;
constexpr int kDxWTile = kFwdBK * kYNLd * 2;
static_assert(kFwdStages * (kYTile + kDxQTile) + 2 * kDxWTile <= kYSmem, "the int8 dx ring fits");
static_assert(2 * (3 * kYTile) + kYBM * kFwdZLd * 4 <= kYSmem, "the dx's segment 2 fits");

struct TcArgs {
  // one tensor-core pair of launches: z = x @ a (M, r) f32, then
  // y = x @ base + (s z) @ b (M, N), contracted over K.
  // Forward (kernel 4): x (M, K), a = A (K, r), b = B (r, N), the base's (N,
  // K) storage read as [output][contraction]; y, z.
  // dx (kernel 6): x = g (M, N'), a = B (r, N') read as B^T, b = A (K', r)
  // read as A^T, the same (N', K') storage read as [contraction][output];
  // y = dx, z = u; K = N' and N = K' (primes: the model's widths).
  const bf16* x;        // (M, K) row-major
  const void* wt;       // bf16, or int8 codes, rows at stride ws
  long long ws;
  const float* qscale;  // int8: one f32 per row of the storage: per output column
                        // of the forward, per contraction row of dx
  const bf16* a;
  const bf16* b;
  const float* s_ptr;   // device scalar; when null, s_val is s
  float s_val;
  bf16* y;              // (M, N)
  float* z;             // (M, r)
  int M, K, N, r;
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A operand (16 x 16) at rows row0.., columns k0.. of a [row][k] bf16 tile
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* t, int ld, int row0, int k0,
                                       int lane) {
  ldsm_x4(a, t + (row0 + lane % 16) * ld + k0 + (lane / 16) * 8);
}
// B operands of the n8 tiles n0 (b[0], b[1]) and n0 + 8 (b[2], b[3]) over k0..k0+15,
// from a [n][k] tile
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], const bf16* t, int ld, int n0, int k0,
                                          int lane) {
  ldsm_x4(b, t + (n0 + lane % 8 + (lane / 16) * 8) * ld + k0 + ((lane / 8) % 2) * 8);
}
// the same from a [k][n] tile, through ldmatrix.trans
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], const bf16* t, int ld, int n0, int k0,
                                          int lane) {
  ldsm_x4_t(b, t + (k0 + lane % 8 + ((lane / 8) % 2) * 8) * ld + n0 + (lane / 16) * 8);
}
// the B operands of a [k][n] tile (kKN) or a [n][k] tile, as b[n8 tile][2]
// for the warp's four n8 tiles at n0..n0+31 over k0..k0+15
template <bool kKN>
__device__ __forceinline__ void frags_b(uint32_t (&b)[4][2], const bf16* t, int ld, int n0, int k0,
                                        int lane) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    uint32_t r4[4];
    if constexpr (kKN)
      frag_b_kn(r4, t, ld, n0 + 16 * p, k0, lane);
    else
      frag_b_nk(r4, t, ld, n0 + 16 * p, k0, lane);
    b[2 * p][0] = r4[0];
    b[2 * p][1] = r4[1];
    b[2 * p + 1][0] = r4[2];
    b[2 * p + 1][1] = r4[3];
  }
}
// two neighbouring int8 codes as a bf16 pair (exact: |q| <= 127)
__device__ __forceinline__ uint32_t widen2(const int8_t* p) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  __nv_bfloat162 h = __floats2bfloat162_rn(static_cast<float>(v.x), static_cast<float>(v.y));
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  __nv_bfloat162 h;
  h.x = lo;
  h.y = hi;
  return *reinterpret_cast<uint32_t*>(&h);
}
// codes c[i] (byte i of w0, then of w1) as eight bf16 values bf16(c[i] * sc):
// each product in f32, rounded once
__device__ __forceinline__ uint4 widen8_scaled(uint32_t w0, uint32_t w1, float sc) {
  float v[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = static_cast<float>(static_cast<int8_t>(w0 >> (8 * i))) * sc;
    v[4 + i] = static_cast<float>(static_cast<int8_t>(w1 >> (8 * i))) * sc;
  }
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    o[i] = *reinterpret_cast<uint32_t*>(&h);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// launch 1: z = x @ a, block (64 rank columns, 64 rows of M), warp w the 32 x 32
// at rows 32 (w / 2), columns 32 (w % 2).  Forward: A (K, r) row-major is a
// [k][j] tile (ldmatrix.trans); dx: B (r, K) row-major is a [j][k] tile (plain
// ldmatrix)
template <bool kDx>
__device__ __forceinline__ void tc_z(const TcArgs& f) {
  constexpr int kOpTile = kDx ? kZBN * kFwdKLd : kFwdBK * kZNLd;
  __shared__ __align__(16) bf16 xs[kFwdStages][kZBM * kFwdKLd];
  __shared__ __align__(16) bf16 as[kFwdStages][kOpTile];
  // the y launch may start now: it waits for this grid's writes itself
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * kZBM, j0 = blockIdx.x * kZBN;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  auto stage = [&](int st, int k0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {  // x: 64 rows x 4 chunks of 8; A: 32 rows x 8 chunks
      const int e = tid + u * kZThreads;
      const int row = e / 4, c = (e % 4) * 8;
      const bool okx = m0 + row < f.M && k0 + c < f.K;
      cp_async16(&xs[st][row * kFwdKLd + c], okx ? f.x + (long long)(m0 + row) * f.K + k0 + c : f.x,
                 okx);
      if constexpr (kDx) {  // B: 64 rank rows x 4 chunks of 8
        const bool okb = j0 + row < f.r && k0 + c < f.K;
        cp_async16(&as[st][row * kFwdKLd + c],
                   okb ? f.a + (long long)(j0 + row) * f.K + k0 + c : f.a, okb);
      } else {
        const int kk = e / 8, cj = (e % 8) * 8;
        const bool oka = k0 + kk < f.K && j0 + cj < f.r;
        cp_async16(&as[st][kk * kZNLd + cj], oka ? f.a + (long long)(k0 + kk) * f.r + j0 + cj : f.a,
                   oka);
      }
    }
  };
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int nk = (f.K + kFwdBK - 1) / kFwdBK;
#pragma unroll
  for (int st = 0; st < kFwdStages - 1; ++st) {
    if (st < nk) stage(st, st * kFwdBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait_n<kFwdStages - 2>();
    __syncthreads();  // stage kt has landed, and every warp is done with stage kt - 1
    const int pre = kt + kFwdStages - 1;
    if (pre < nk) stage(pre % kFwdStages, pre * kFwdBK);
    cp_async_commit();
    const bf16* xt = xs[kt % kFwdStages];
    const bf16* at = as[kt % kFwdStages];
#pragma unroll
    for (int ks = 0; ks < kFwdBK; ks += 16) {
      uint32_t a[2][4], b[4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) frag_a(a[mi], xt, kFwdKLd, wm + 16 * mi, ks, lane);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        if constexpr (kDx)
          frag_b_nk(b, at, kFwdKLd, wn + 16 * p, ks, lane);
        else
          frag_b_kn(b, at, kZNLd, wn + 16 * p, ks, lane);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma16816(acc[mi][2 * p], a[mi][0], a[mi][1], a[mi][2], a[mi][3], b[0], b[1]);
          mma16816(acc[mi][2 * p + 1], a[mi][0], a[mi][1], a[mi][2], a[mi][3], b[2], b[3]);
        }
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int j = j0 + wn + acc_col(lane, nj, 0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * mi + acc_row(lane, 2 * h);
        if (m < f.M && j < f.r)
          *reinterpret_cast<float2*>(f.z + (long long)m * f.r + j) =
              make_float2(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
      }
    }
}

__global__ void __launch_bounds__(kZThreads) fused_fwd_z_tc_kernel(TcArgs f) { tc_z<false>(f); }
__global__ void __launch_bounds__(kZThreads) fused_dx_u_tc_kernel(TcArgs f) { tc_z<true>(f); }

// the thread's index and its block's (m0, n0) read anew from the special
// registers: indices derived from them after segment 1 are recomputed rather
// than held across its loop (at 128 registers a thread they would be spilled)
struct YIds {
  int tid, m0, n0;
};
__device__ __forceinline__ YIds fresh_ids() {
  int tid, bx, by;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(tid));
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(bx));
  asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(by));
  return YIds{tid, by * kYBM, bx * kYBN};
}

// launch 2: y, block (128 columns of N, 128 rows of M), warp w the 64 x 32 at
// rows 64 (w / 4), columns 32 (w % 4).  Segment 1: acc = x @ base through the
// ring.  Forward: the base's [n][k] tile (plain ldmatrix, or int8 codes
// widened in registers).  dx: its [k][n] tile (ldmatrix.trans); int8 codes
// are first widened and scaled by their rows' scales into a bf16 [k][n] tile,
// one stage ahead of the MMAs that read it
template <bool kInt8, bool kDx>
__device__ __forceinline__ void tc_seg1(const TcArgs& f, float (&acc)[4][4][4]) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kWiden = kInt8 && kDx;
  constexpr int kStage = kWiden ? kYTile + kDxQTile : kYStage;
  const YIds id = fresh_ids();
  const int tid = id.tid, m0 = id.m0, n0 = id.n0, warp = tid / 32, lane = tid % 32;
  const int wm = (warp / kYWarpsN) * 64, wn = (warp % kYWarpsN) * 32;
  auto xs = [&](int st) { return reinterpret_cast<bf16*>(smem + st * kStage); };
  auto bs = [&](int st) { return smem + st * kStage + kYTile; };  // the base's tile
  auto wide = [&](int buf) {
    return reinterpret_cast<bf16*>(smem + kFwdStages * kStage + buf * kDxWTile);
  };
  auto stage = [&](int st, int k0) {
#pragma unroll
    for (int u = 0; u < kYBM * 4 / kYThreads; ++u) {  // 128 rows x 4 chunks of 8 elements
      const int e = tid + u * kYThreads, row = e / 4, c = (e % 4) * 8;
      const bool okx = m0 + row < f.M && k0 + c < f.K;
      cp_async16(xs(st) + row * kFwdKLd + c, okx ? f.x + (long long)(m0 + row) * f.K + k0 + c : f.x,
                 okx);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if constexpr (kDx) {  // the base: 32 contraction rows x 16 chunks of 8 output columns
        const int e = tid + u * kYThreads, kk = e / 16, c = (e % 16) * 8;
        const bool okw = k0 + kk < f.K && n0 + c < f.N;
        const long long off = (long long)(k0 + kk) * f.ws + n0 + c;
        if constexpr (kInt8) {
          const int8_t* q = static_cast<const int8_t*>(f.wt);
          cp_async8(bs(st) + kk * kDxQLd + c, okw ? q + off : q, okw);
        } else {
          const bf16* w = static_cast<const bf16*>(f.wt);
          cp_async16(reinterpret_cast<bf16*>(bs(st)) + kk * kYNLd + c, okw ? w + off : w, okw);
        }
      } else {  // the base: 128 rows x 4 chunks of 8 elements
        const int e = tid + u * kYThreads, row = e / 4, c = (e % 4) * 8;
        const bool okw = n0 + row < f.N && k0 + c < f.K;
        const long long off = (long long)(n0 + row) * f.ws + k0 + c;
        if constexpr (kInt8) {
          const int8_t* q = static_cast<const int8_t*>(f.wt);
          cp_async8(bs(st) + row * kFwdQLd + c, okw ? q + off : q, okw);
        } else {
          const bf16* w = static_cast<const bf16*>(f.wt);
          cp_async16(reinterpret_cast<bf16*>(bs(st)) + row * kFwdKLd + c, okw ? w + off : w, okw);
        }
      }
    }
  };
  // the codes of stage st times their rows' scales into the bf16 tile dst:
  // thread t takes 16 codes of row t / 8; quarter-warps store their halves in
  // two orders, so that each 16-byte store of 8 lanes fills distinct banks
  auto widen = [&](int st, int k0, bf16* dst) {
    const int row = tid / 8, c = (tid % 8) * 16;
    const float sc = k0 + row < f.K ? __ldg(f.qscale + k0 + row) : 0.f;
    const uint4 v = *reinterpret_cast<const uint4*>(bs(st) + row * kDxQLd + c);
    const uint4 h0 = widen8_scaled(v.x, v.y, sc), h1 = widen8_scaled(v.z, v.w, sc);
    const bool swap = (tid / 4) % 2;
    bf16* d = dst + row * kYNLd + c;
    *reinterpret_cast<uint4*>(d + (swap ? 8 : 0)) = swap ? h1 : h0;
    *reinterpret_cast<uint4*>(d + (swap ? 0 : 8)) = swap ? h0 : h1;
  };
  const int nk = (f.K + kFwdBK - 1) / kFwdBK;
#pragma unroll
  for (int st = 0; st < kFwdStages - 1; ++st) {
    if (st < nk) stage(st, st * kFwdBK);
    cp_async_commit();
  }
  if constexpr (kWiden) {
    cp_async_wait_n<kFwdStages - 2>();
    __syncthreads();  // stage 0 has landed
    widen(0, 0, wide(0));
  }
  const int g = lane / 4, t = lane % 4;
  for (int kt = 0; kt < nk; ++kt) {
    // stage kt (dx int8: kt + 1 too) has landed, and every warp is done with
    // stage kt - 1 (and the widened tile of kt - 1)
    cp_async_wait_n<kWiden ? kFwdStages - 3 : kFwdStages - 2>();
    __syncthreads();
    const int pre = kt + kFwdStages - 1;
    if (pre < nk) stage(pre % kFwdStages, pre * kFwdBK);
    cp_async_commit();
    if constexpr (kWiden) {
      if (kt + 1 < nk) widen((kt + 1) % kFwdStages, (kt + 1) * kFwdBK, wide((kt + 1) % 2));
    }
    const bf16* xt = xs(kt % kFwdStages);
    // k16 halves one after the other, not interleaved: the y kernel stays within
    // 128 registers a thread
#pragma unroll 1
    for (int ks = 0; ks < kFwdBK; ks += 16) {
      uint32_t b[4][2];
      if constexpr (kDx) {
        const bf16* bt = kWiden ? wide(kt % 2) : reinterpret_cast<const bf16*>(bs(kt % kFwdStages));
        frags_b<true>(b, bt, kYNLd, wn, ks, lane);
      } else if constexpr (kInt8) {
        const int8_t* qt = reinterpret_cast<const int8_t*>(bs(kt % kFwdStages));
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const int8_t* p = qt + (wn + 8 * nj + g) * kFwdQLd + ks + 2 * t;
          b[nj][0] = widen2(p);
          b[nj][1] = widen2(p + 8);
        }
      } else {
        frags_b<false>(b, reinterpret_cast<const bf16*>(bs(kt % kFwdStages)), kFwdKLd, wn, ks, lane);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        uint32_t a[4];
        frag_a(a, xt, kFwdKLd, wm + 16 * mi, ks, lane);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) mma16816(acc[mi][nj], a[0], a[1], a[2], a[3], b[nj][0], b[nj][1]);
      }
    }
  }
  cp_async_wait_n<0>();
}

// the int8 forward's column scales on the accumulators of the warp's 64 x 32
// at columns n0 + wn: sum_k x q scale[n] = scale[n] sum_k x q
__device__ __forceinline__ void scale_columns(const TcArgs& f, float (&acc)[4][4][4], int n0,
                                              int wn, int lane) {
#pragma unroll
  for (int nj = 0; nj < 4; ++nj) {
    const int n = n0 + wn + acc_col(lane, nj, 0);
    const float c0 = n < f.N ? f.qscale[n] : 0.f, c1 = n < f.N ? f.qscale[n + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      acc[mi][nj][0] *= c0;
      acc[mi][nj][1] *= c1;
      acc[mi][nj][2] *= c0;
      acc[mi][nj][3] *= c1;
    }
  }
}

// the warp's 64 x 32 of y at rows m0 + wm, columns n0 + wn, rounded to bf16
__device__ __forceinline__ void store_y(const TcArgs& f, const float (&acc)[4][4][4], int m0,
                                        int n0, int wm, int wn, int lane) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int n = n0 + wn + acc_col(lane, nj, 0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + 16 * mi + acc_row(lane, 2 * h);
        if (m < f.M && n < f.N)
          *reinterpret_cast<__nv_bfloat162*>(f.y + (long long)m * f.N + n) =
              __floats2bfloat162_rn(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
      }
    }
}

// the forward's int8 column scales, then segment 2: acc += (s z) @ b, and y.
// b's tile: the forward's B (r, N) as [j][n] (ldmatrix.trans), the dx's A
// (N, r) as [n][j] (plain ldmatrix)
template <bool kInt8, bool kDx>
__device__ __forceinline__ void tc_seg2(const TcArgs& f, float (&acc)[4][4][4]) {
  extern __shared__ __align__(16) unsigned char smem[];
  const YIds id = fresh_ids();
  const int tid = id.tid, m0 = id.m0, n0 = id.n0, warp = tid / 32, lane = tid % 32;
  const int wm = (warp / kYWarpsN) * 64, wn = (warp % kYWarpsN) * 32;
  if constexpr (kInt8 && !kDx) scale_columns(f, acc, n0, wn, lane);

  // segment 2: (s z) @ b, 32 rank columns a step, two buffers of (z hi, z lo,
  // b) and z's f32 tile, staged one step ahead
  constexpr int kBuf = kDx ? 3 * kYTile : kY2Buf;
  auto zh = [&](int buf) { return reinterpret_cast<bf16*>(smem + buf * kBuf); };
  auto zl = [&](int buf) { return zh(buf) + kYBM * kFwdKLd; };
  auto bt = [&](int buf) { return zl(buf) + kYBM * kFwdKLd; };
  float* zf = reinterpret_cast<float*>(smem + 2 * kBuf);
  auto stage_b = [&](int buf, int j0) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = tid + u * kYThreads;
      if constexpr (kDx) {  // A: 128 output rows x 4 chunks of 8 rank columns
        const int row = e / 4, c = (e % 4) * 8;
        const bool ok = n0 + row < f.N && j0 + c < f.r;
        cp_async16(bt(buf) + row * kFwdKLd + c, ok ? f.b + (long long)(n0 + row) * f.r + j0 + c : f.b,
                   ok);
      } else {  // B: 32 rank rows x kYBN / 8 chunks of 8 columns
        const int jj = e / (kYBN / 8), c = (e % (kYBN / 8)) * 8;
        const bool ok = j0 + jj < f.r && n0 + c < f.N;
        cp_async16(bt(buf) + jj * kYNLd + c, ok ? f.b + (long long)(j0 + jj) * f.N + n0 + c : f.b, ok);
      }
    }
  };
  const int nr = (f.r + kFwdBK - 1) / kFwdBK;
  stage_b(0, 0);  // b is an input: staged before the wait
  cp_async_commit();
  const float s = f.s_ptr ? *f.s_ptr : f.s_val;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // z is complete

  auto stage_z = [&](int j0) {
    // the dx reads its ids anew here: its [n][j] b tile's addresses take the
    // registers that z's held across the loop (else 8 bytes spill)
    const YIds zi = kDx ? fresh_ids() : id;
    const int tid = zi.tid, m0 = zi.m0;
#pragma unroll
    for (int u = 0; u < kYBM * 8 / kYThreads; ++u) {  // 128 rows x 8 chunks of 4 floats
      const int e = tid + u * kYThreads, row = e / 8, c = (e % 8) * 4;
      const bool ok = m0 + row < f.M && j0 + c < f.r;
      cp_async16(zf + row * kFwdZLd + c, ok ? f.z + (long long)(m0 + row) * f.r + j0 + c : f.z, ok);
    }
  };
  stage_z(0);
  cp_async_commit();
  for (int jt = 0; jt < nr; ++jt) {
    const int buf = jt % 2;
    cp_async_wait_n<0>();
    __syncthreads();  // z and b of step jt have landed; every warp is done with step jt - 1
#pragma unroll
    for (int u = 0; u < kYBM * 8 / kYThreads; ++u) {  // hi and lo bf16 halves of s z
      const int e = tid + u * kYThreads, row = e / 8, c = (e % 8) * 4;
      const float4 z4 = *reinterpret_cast<const float4*>(zf + row * kFwdZLd + c);
      const float v[4] = {z4.x * s, z4.y * s, z4.z * s, z4.w * s};
      bf16 h[4], l[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_bf16(v[i], h + i, l + i);
      *reinterpret_cast<uint2*>(zh(buf) + row * kFwdKLd + c) =
          make_uint2(pack2(h[0], h[1]), pack2(h[2], h[3]));
      *reinterpret_cast<uint2*>(zl(buf) + row * kFwdKLd + c) =
          make_uint2(pack2(l[0], l[1]), pack2(l[2], l[3]));
    }
    __syncthreads();  // the halves are complete, and zf is free
    if (jt + 1 < nr) {
      stage_z((jt + 1) * kFwdBK);
      stage_b(buf ^ 1, (jt + 1) * kFwdBK);
    }
    cp_async_commit();
#pragma unroll 1
    for (int ks = 0; ks < kFwdBK; ks += 16) {
      uint32_t b[4][2];
      if constexpr (kDx)
        frags_b<false>(b, bt(buf), kFwdKLd, wn, ks, lane);
      else
        frags_b<true>(b, bt(buf), kYNLd, wn, ks, lane);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        uint32_t ah[4], al[4];
        frag_a(ah, zh(buf), kFwdKLd, wm + 16 * mi, ks, lane);
        frag_a(al, zl(buf), kFwdKLd, wm + 16 * mi, ks, lane);
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          mma16816(acc[mi][nj], ah[0], ah[1], ah[2], ah[3], b[nj][0], b[nj][1]);
          mma16816(acc[mi][nj], al[0], al[1], al[2], al[3], b[nj][0], b[nj][1]);
        }
      }
    }
  }

  store_y(f, acc, m0, n0, wm, wn, lane);
}

__device__ __forceinline__ void zero_acc(float (&acc)[4][4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
}

template <bool kInt8, bool kDx>
__device__ __forceinline__ void tc_y(const TcArgs& f) {
  float acc[4][4][4];
  zero_acc(acc);
  tc_seg1<kInt8, kDx>(f, acc);
  __syncthreads();  // the ring is free for segment 2
  tc_seg2<kInt8, kDx>(f, acc);
}

__global__ void __launch_bounds__(kYThreads, 2) fused_fwd_y_tc_bf16_kernel(TcArgs f) {
  tc_y<false, false>(f);
}
__global__ void __launch_bounds__(kYThreads, 2) fused_fwd_y_tc_int8_kernel(TcArgs f) {
  tc_y<true, false>(f);
}
__global__ void __launch_bounds__(kYThreads, 2) fused_dx_tc_bf16_kernel(TcArgs f) {
  tc_y<false, true>(f);
}
__global__ void __launch_bounds__(kYThreads, 2) fused_dx_tc_int8_kernel(TcArgs f) {
  tc_y<true, true>(f);
}

// kernel 8 on the tensor cores: the int8 forward's segment 1 alone (x @ q
// through the ring, the codes widened to bf16 in registers), its column
// scales on the accumulators, y in bf16.  One launch: no z, no PDL, no
// segment 2
__global__ void __launch_bounds__(kYThreads, 2) dequant_matmul_tc_kernel(TcArgs f) {
  float acc[4][4][4];
  zero_acc(acc);
  tc_seg1<true, false>(f, acc);
  const YIds id = fresh_ids();
  const int warp = id.tid / 32, lane = id.tid % 32;
  const int wm = (warp / kYWarpsN) * 64, wn = (warp % kYWarpsN) * 32;
  scale_columns(f, acc, id.n0, wn, lane);
  store_y(f, acc, id.m0, id.n0, wm, wn, lane);
}

// ---------------------------------------------------------------------------
// Kernel 7 on the tensor cores (design in the header note)
// ---------------------------------------------------------------------------

constexpr int kDabRows = 128;                 // output rows (K or N) of a block
constexpr int kDabCols = 128;                 // rank columns of a block
constexpr int kDabWarpsR = 2;                 // warps along the rows; 8 / kDabWarpsR along the rank
constexpr int kDabMI = kDabRows / kDabWarpsR / 16;  // m16 tiles of a warp (its n8 tiles: 4)
constexpr int kDabBK = 64;                    // rows of M a stage
constexpr int kDabStages = 3;                 // cp.async ring depth
constexpr int kDabLdL = kDabRows + 8;         // bf16 row stride of L's [m][p] tile: 272 bytes
constexpr int kDabLdR = kDabCols + 8;         // bf16 row stride of a half's [m][j] tile
constexpr int kDabStage = kDabBK * (kDabLdL + 2 * kDabLdR) * 2;  // bytes: L, R hi, R lo
constexpr int kDabSmem = kDabStages * kDabStage;
constexpr int kDabThreads = 256;              // 8 warps of 16 kDabMI x 32
constexpr int kDabLoads = 8;                  // partials a thread loads at once before summing
static_assert(kDabCols == (kDabThreads / 32 / kDabWarpsR) * 32, "a warp takes 32 rank columns");

struct DabArgs {
  // part[chunk] of dA = x^T u (K, r) and of dB = z^T g (r, N), computed as
  // dB^T = g^T z so that both are C (P, r) = L^T R over the chunk's rows of M,
  // L bf16 (M, P) and R = hi + lo, two bf16 (M, r) halves
  const bf16* x;      // (M, K)
  const bf16* g;      // (M, N)
  const bf16* split;  // (4, M, r): u hi, u lo, z hi, z lo
  float* part;        // (chunks, K r + r N)
  int M, K, N, r;
  int a_tiles, rtiles;  // blocks of dA's output (the first a_tiles), rank tiles
};

// launch 1: hi = bf16(v) and lo = bf16(v - hi) of every element of u and z
// (M, r) f32, four at a time, into split
__global__ void __launch_bounds__(kThreads) dab_split_kernel(const float* u, const float* z,
                                                             bf16* split, long long n) {
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n / 2;
       i += (long long)gridDim.x * kThreads) {
    const bool is_z = i >= n / 4;
    const long long e = (is_z ? i - n / 4 : i) * 4;
    const float4 v = *reinterpret_cast<const float4*>((is_z ? z : u) + e);
    bf16 h[4], l[4];
    split_bf16(v.x, h, l);
    split_bf16(v.y, h + 1, l + 1);
    split_bf16(v.z, h + 2, l + 2);
    split_bf16(v.w, h + 3, l + 3);
    bf16* hi = split + (is_z ? 2 * n : 0) + e;
    *reinterpret_cast<uint2*>(hi) = make_uint2(pack2(h[0], h[1]), pack2(h[2], h[3]));
    *reinterpret_cast<uint2*>(hi + n) = make_uint2(pack2(l[0], l[1]), pack2(l[2], l[3]));
  }
}

// launch 2: block (output tile, chunk of kChunk rows of M); warp w the
// 16 kDabMI x 32 at output rows 16 kDabMI (w / (8 / kDabWarpsR)), rank
// columns 32 (w % (8 / kDabWarpsR)).  Stages of 32 rows of M: L's [m][p] tile
// is the transposed A operand (ldmatrix.trans), R's hi and lo [m][j] tiles
// the B operand (ldmatrix.trans); each L fragment meets both halves in its
// own MMA
__global__ void __launch_bounds__(kDabThreads, 1) dab_tc_kernel(DabArgs d) {
  extern __shared__ __align__(16) unsigned char smem[];
  // the reduce may launch now: it waits for this grid's writes itself
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const bool is_a = (int)blockIdx.x < d.a_tiles;
  const int t = is_a ? blockIdx.x : blockIdx.x - d.a_tiles;
  const int P = is_a ? d.K : d.N;
  const bf16* L = is_a ? d.x : d.g;
  const long long mr = (long long)d.M * d.r;
  const bf16* rh = d.split + (is_a ? 0 : 2 * mr);
  const int p0 = (t / d.rtiles) * kDabRows, j0 = (t % d.rtiles) * kDabCols;
  const int m_begin = blockIdx.y * kChunk, m_end = min(d.M, m_begin + kChunk);
  constexpr int kWarpsC = kDabThreads / 32 / kDabWarpsR;
  const int wm = (warp / kWarpsC) * 16 * kDabMI, wn = (warp % kWarpsC) * 32;
  auto tile_l = [&](int st) { return reinterpret_cast<bf16*>(smem + st * kDabStage); };
  auto tile_r = [&](int st, int half) {  // half: 0 hi, 1 lo
    return tile_l(st) + kDabBK * kDabLdL + half * kDabBK * kDabLdR;
  };
  // 32 rows x chunks of 8 columns of L (width P) or of both R halves (width r)
  auto stage_l = [&](int st, int m0) {
    constexpr int kPerRow = kDabRows / 8;
#pragma unroll
    for (int u = 0; u < kDabBK * kPerRow / kDabThreads; ++u) {
      const int e = tid + u * kDabThreads, row = e / kPerRow, c = (e % kPerRow) * 8;
      const bool ok = m0 + row < m_end && p0 + c < P;
      cp_async16(tile_l(st) + row * kDabLdL + c, ok ? L + (long long)(m0 + row) * P + p0 + c : L,
                 ok);
    }
  };
  auto stage_r = [&](int st, int m0) {
    constexpr int kPerRow = kDabCols / 8;
#pragma unroll
    for (int u = 0; u < kDabBK * kPerRow / kDabThreads; ++u) {
      const int e = tid + u * kDabThreads, row = e / kPerRow, c = (e % kPerRow) * 8;
      const bool ok = m0 + row < m_end && j0 + c < d.r;
      const long long off = ok ? (long long)(m0 + row) * d.r + j0 + c : 0;
      cp_async16(tile_r(st, 0) + row * kDabLdR + c, rh + off, ok);
      cp_async16(tile_r(st, 1) + row * kDabLdR + c, rh + mr + off, ok);
    }
  };
  float acc[kDabMI][4][4];
#pragma unroll
  for (int i = 0; i < kDabMI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int nk = (m_end - m_begin + kDabBK - 1) / kDabBK;
#pragma unroll
  for (int st = 0; st < kDabStages - 1; ++st) {
    if (st < nk) {
      stage_l(st, m_begin + st * kDabBK);
      stage_r(st, m_begin + st * kDabBK);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait_n<kDabStages - 2>();
    __syncthreads();  // stage kt has landed, and every warp is done with stage kt - 1
    const int pre = kt + kDabStages - 1;
    if (pre < nk) {
      stage_l(pre % kDabStages, m_begin + pre * kDabBK);
      stage_r(pre % kDabStages, m_begin + pre * kDabBK);
    }
    cp_async_commit();
    const int st = kt % kDabStages;
#pragma unroll
    for (int ks = 0; ks < kDabBK; ks += 16) {
      uint32_t bh[4][2], bl[4][2];
      frags_b<true>(bh, tile_r(st, 0), kDabLdR, wn, ks, lane);
      frags_b<true>(bl, tile_r(st, 1), kDabLdR, wn, ks, lane);
      uint32_t a[kDabMI][4];  // L^T rows wm + 16 mi.., contraction ks..: L stored [m][p]
#pragma unroll
      for (int mi = 0; mi < kDabMI; ++mi)
        ldsm_x4_t(a[mi], tile_l(st) + (ks + lane % 8 + (lane / 16) * 8) * kDabLdL + wm +
                             16 * mi + ((lane / 8) % 2) * 8);
      // every hi product, then every lo one, so no two MMAs in a row share
      // an accumulator
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int mi = 0; mi < kDabMI; ++mi)
#pragma unroll
          for (int nj = 0; nj < 4; ++nj) {
            const uint32_t(&b)[2] = half ? bl[nj] : bh[nj];
            mma16816(acc[mi][nj], a[mi][0], a[mi][1], a[mi][2], a[mi][3], b[0], b[1]);
          }
    }
  }
  cp_async_wait_n<0>();
  // dA's partial [p][j] as pairs of columns; dB's [j][p], transposed
  float* out = d.part + (long long)blockIdx.y * ((long long)d.K * d.r + (long long)d.r * d.N);
#pragma unroll
  for (int mi = 0; mi < kDabMI; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int j = j0 + wn + acc_col(lane, nj, 0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = p0 + wm + 16 * mi + acc_row(lane, 2 * h);
        if (p >= P || j >= d.r) continue;
        if (is_a) {
          *reinterpret_cast<float2*>(out + (long long)p * d.r + j) =
              make_float2(acc[mi][nj][2 * h], acc[mi][nj][2 * h + 1]);
        } else {
          float* db = out + (long long)d.K * d.r;
          db[(long long)j * d.N + p] = acc[mi][nj][2 * h];
          db[(long long)(j + 1) * d.N + p] = acc[mi][nj][2 * h + 1];
        }
      }
    }
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

// launch 3: da[i] (i < n_da) and db[i - n_da] = s * the sum of part[chunk, i]
// over the chunks in order, four elements a thread (len and n_da are
// multiples of 4), kDabLoads chunks' loads in flight before they are summed.
// s is an input, read before the wait for launch 2's partials
__global__ void __launch_bounds__(kThreads) dab_reduce_kernel(const float* part, int chunks,
                                                              long long len, long long n_da,
                                                              const float* s_ptr, float s_val,
                                                              float* da, float* db) {
  const float s = s_ptr ? *s_ptr : s_val;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (long long i = (blockIdx.x * (long long)kThreads + threadIdx.x) * 4; i < len;
       i += (long long)gridDim.x * kThreads * 4) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = 0; c0 < chunks; c0 += kDabLoads) {
      float4 v[kDabLoads];
#pragma unroll
      for (int u = 0; u < kDabLoads; ++u)
        v[u] = c0 + u < chunks ? __ldcg(reinterpret_cast<const float4*>(part + (c0 + u) * len + i))
                               : acc;
#pragma unroll
      for (int u = 0; u < kDabLoads; ++u) {
        if (c0 + u >= chunks) break;
        acc = make_float4(acc.x + v[u].x, acc.y + v[u].y, acc.z + v[u].z, acc.w + v[u].w);
      }
    }
    float* dst = i < n_da ? da + i : db + (i - n_da);
    *reinterpret_cast<float4*>(dst) = make_float4(acc.x * s, acc.y * s, acc.z * s, acc.w * s);
  }
}

// kernel 7's three launches on the tensor cores, the reduce a programmatic
// dependent of the partials.  Refuses inputs that break the path's
// conditions: K, N and r multiples of 8, every pointer 16-byte aligned
int dab_tc(const void* g, const void* x, const float* z, const float* u, float* part, void* split,
           const float* s_ptr, float s_val, float* da, float* db, int M, int K, int N, int r,
           cudaStream_t st) {
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (K % 8 || N % 8 || r % 8 || !aligned(g) || !aligned(x) || !aligned(z) || !aligned(u) ||
      !aligned(part) || !aligned(split) || !aligned(da) || !aligned(db) ||
      tiles(M, kChunk) > 65535)
    return (int)cudaErrorInvalidValue;
  const int chunks = tiles(M, kChunk);  // 0 at M = 0: the reduce writes zeros
  if (M > 0) {
    const long long n = (long long)M * r;
    const long long want = (n / 2 + kThreads - 1) / kThreads;
    dab_split_kernel<<<(int)(want < 4096 ? want : 4096), kThreads, 0, st>>>(u, z,
                                                                           static_cast<bf16*>(split), n);
    int err = (int)cudaGetLastError();
    if (err) return err;
    static const bool sized = cudaFuncSetAttribute(dab_tc_kernel,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   kDabSmem) == cudaSuccess;
    if (!sized) return (int)cudaErrorInvalidValue;
    DabArgs d{static_cast<const bf16*>(x), static_cast<const bf16*>(g),
              static_cast<const bf16*>(split), part, M, K, N, r,
              tiles(K, kDabRows) * tiles(r, kDabCols), tiles(r, kDabCols)};
    dab_tc_kernel<<<dim3(d.a_tiles + tiles(N, kDabRows) * d.rtiles, chunks), kDabThreads, kDabSmem,
                    st>>>(d);
    if ((err = (int)cudaGetLastError())) return err;
  }
  // the reduce as a programmatic dependent launch of the partials' grid
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  const long long len = (long long)K * r + (long long)r * N;
  const long long want = (len / 4 + kThreads - 1) / kThreads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((int)(want < 4096 ? want : 4096));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, dab_reduce_kernel, (const float*)part, chunks, len,
                                 (long long)K * r, s_ptr, s_val, da, db);
}

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

// a tensor-core pair: the z (dx: u) launch, then the y (dx) launch as its
// programmatic dependent.  Refuses inputs that break the path's conditions:
// bf16 operands, the base the k-contiguous view of its storage (w_s0 == 1)
// with a row stride, K, N and r multiples of 8, every pointer 16-byte aligned
int tc_pair(const TcArgs& f, bool dx, bool int8, long long w_s0, int dtype, cudaStream_t st) {
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (dtype != kBF16 || w_s0 != 1 || f.ws % 8 || f.K % 8 || f.N % 8 || f.r % 8 ||
      !aligned(f.x) || !aligned(f.wt) || !aligned(f.a) || !aligned(f.b) || !aligned(f.y) ||
      !aligned(f.z) || tiles(f.M, kZBM) > 65535)
    return (int)cudaErrorInvalidValue;
  if (f.M == 0) return (int)cudaSuccess;
  void (*first)(TcArgs) = dx ? fused_dx_u_tc_kernel : fused_fwd_z_tc_kernel;
  first<<<dim3(tiles(f.r, kZBN), tiles(f.M, kZBM)), kZThreads, 0, st>>>(f);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  static const bool sized =  // once: the second launch takes more than 48 KB of shared memory
      cudaFuncSetAttribute(fused_fwd_y_tc_bf16_kernel, attr, kYSmem) == cudaSuccess &&
      cudaFuncSetAttribute(fused_fwd_y_tc_int8_kernel, attr, kYSmem) == cudaSuccess &&
      cudaFuncSetAttribute(fused_dx_tc_bf16_kernel, attr, kYSmem) == cudaSuccess &&
      cudaFuncSetAttribute(fused_dx_tc_int8_kernel, attr, kYSmem) == cudaSuccess;
  if (!sized) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles(f.N, kYBN), tiles(f.M, kYBM));
  cfg.blockDim = dim3(kYThreads);
  cfg.dynamicSmemBytes = kYSmem;
  cfg.stream = st;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  void (*kernel)(TcArgs) = dx ? (int8 ? fused_dx_tc_int8_kernel : fused_dx_tc_bf16_kernel)
                              : (int8 ? fused_fwd_y_tc_int8_kernel : fused_fwd_y_tc_bf16_kernel);
  return (int)cudaLaunchKernelEx(&cfg, kernel, f);
}

// kernel 8's one launch on the tensor cores.  Refuses inputs that break the
// path's conditions: tc_pair's, with no LoRA factor
int dequant_tc(const TcArgs& f, long long q_s0, int dtype, cudaStream_t st) {
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  if (dtype != kBF16 || q_s0 != 1 || f.ws % 8 || f.K % 8 || f.N % 8 || !aligned(f.x) ||
      !aligned(f.wt) || !aligned(f.y) || tiles(f.M, kYBM) > 65535)
    return (int)cudaErrorInvalidValue;
  if (f.M == 0) return (int)cudaSuccess;
  constexpr int kSmem = kFwdStages * kYStage;  // segment 1's ring alone
  static const bool sized = cudaFuncSetAttribute(dequant_matmul_tc_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 kSmem) == cudaSuccess;
  if (!sized) return (int)cudaErrorInvalidValue;
  dequant_matmul_tc_kernel<<<dim3(tiles(f.N, kYBN), tiles(f.M, kYBM)), kYThreads, kSmem, st>>>(f);
  return (int)cudaGetLastError();
}

// the forward's arguments: x (M, K), the base's (N, K) storage, A, B, y, z
TcArgs fwd_tc_args(const void* x, const void* wt, long long ws, const float* qscale, const void* a,
                   const void* b, const float* s_ptr, float s_val, void* y, float* z, int M, int K,
                   int N, int r) {
  return TcArgs{static_cast<const bf16*>(x), wt, ws, qscale, static_cast<const bf16*>(a),
                static_cast<const bf16*>(b), s_ptr, s_val, static_cast<bf16*>(y), z, M, K, N, r};
}

// dx's: g (M, N) is contracted over N, against the same (N, K) storage read
// by rows; u = g @ B^T takes the first launch, (s u) @ A^T segment 2
TcArgs dx_tc_args(const void* g, const void* wt, long long ws, const float* qscale, const void* a,
                  const void* b, const float* s_ptr, float s_val, void* dx, float* u, int M, int K,
                  int N, int r) {
  return fwd_tc_args(g, wt, ws, qscale, b, a, s_ptr, s_val, dx, u, M, N, K, r);
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

// x (M, K); W logical (K, N) at element strides (w_s0, w_s1); A (K, r); B (r, N);
// y (M, N) in the inputs' dtype; z (M, r) f32.  dtype: 0 float32, 1 bfloat16.
// tc: 1 runs the tensor-core path (its conditions at tc_pair, which refuses
// what breaks them), 0 lora_gemm_kernel.
int fused_lora_forward_launch(const void* x, const void* w, long long w_s0, long long w_s1,
                              const void* a, const void* b, const float* s_ptr, float s_val,
                              void* y, float* z, int M, int K, int N, int r, int dtype, int tc,
                              void* stream) {
  if (bad_args(M, K, N, r, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc)
    return tc_pair(fwd_tc_args(x, w, w_s1, nullptr, a, b, s_ptr, s_val, y, z, M, K, N, r), false,
                   false, w_s0, dtype, st);
  return fwd_pass(x, mat(w, w_s0, w_s1, dtype), a, b, s_ptr, s_val, y, z, M, K, N, r, dtype, st);
}

// the same over an int8 base: q logical (K, N) int8 at element strides
// (q_s0, q_s1), qscale (1, N) f32 contiguous
int fused_lora_int8_forward_launch(const void* x, const void* q, long long q_s0, long long q_s1,
                                   const float* qscale, const void* a, const void* b,
                                   const float* s_ptr, float s_val, void* y, float* z, int M,
                                   int K, int N, int r, int dtype, int tc, void* stream) {
  if (bad_args(M, K, N, r, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc)
    return tc_pair(fwd_tc_args(x, q, q_s1, qscale, a, b, s_ptr, s_val, y, z, M, K, N, r), false,
                   true, q_s0, dtype, st);
  return fwd_pass(x, qmat(q, q_s0, q_s1, qscale, 0, 1), a, b, s_ptr, s_val, y, z, M, K, N, r,
                  dtype, st);
}

// g (M, N); dx (M, K) in the inputs' dtype; u (M, r) f32 = g @ B^T, written
// for fused_lora_bwd_dab_launch.  tc as in fused_lora_forward_launch: 1 runs
// the tensor-core pair (the same conditions), 0 lora_gemm_kernel.
int fused_lora_bwd_dx_launch(const void* g, const void* w, long long w_s0, long long w_s1,
                             const void* a, const void* b, const float* s_ptr, float s_val,
                             void* dx, float* u, int M, int K, int N, int r, int dtype, int tc,
                             void* stream) {
  if (bad_args(M, K, N, r, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc)
    return tc_pair(dx_tc_args(g, w, w_s1, nullptr, a, b, s_ptr, s_val, dx, u, M, K, N, r), true,
                   false, w_s0, dtype, st);
  return dx_pass(g, mat(w, w_s1, w_s0, dtype), a, b, s_ptr, s_val, dx, u, M, K, N, r, dtype, st);
}

// the same over an int8 base (q, qscale as in fused_lora_int8_forward_launch):
// in W^T the column scale runs along the contraction axis
int fused_lora_int8_bwd_dx_launch(const void* g, const void* q, long long q_s0, long long q_s1,
                                  const float* qscale, const void* a, const void* b,
                                  const float* s_ptr, float s_val, void* dx, float* u, int M,
                                  int K, int N, int r, int dtype, int tc, void* stream) {
  if (bad_args(M, K, N, r, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc)
    return tc_pair(dx_tc_args(g, q, q_s1, qscale, a, b, s_ptr, s_val, dx, u, M, K, N, r), true,
                   true, q_s0, dtype, st);
  return dx_pass(g, qmat(q, q_s1, q_s0, qscale, 1, 0), a, b, s_ptr, s_val, dx, u, M, K, N, r,
                 dtype, st);
}

// kernel 8: y (M, N) = x (M, K) @ (q * qscale), q logical (K, N) int8 at element
// strides (q_s0, q_s1), qscale (1, N) f32; y in x's dtype.  tc: 1 runs
// dequant_matmul_tc_kernel (its conditions at dequant_tc, which refuses what
// breaks them), 0 lora_gemm_kernel.
int dequant_matmul_launch(const void* x, const void* q, long long q_s0, long long q_s1,
                          const float* qscale, void* y, int M, int K, int N, int dtype, int tc,
                          void* stream) {
  if (bad_args(M, K, N, 1, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc)
    return dequant_tc(fwd_tc_args(x, q, q_s1, qscale, nullptr, nullptr, nullptr, 1.f, y, nullptr,
                                  M, K, N, 0),
                      q_s0, dtype, st);
  Gemm yg = gemm(M, N, nullptr, 1.f, y, dtype, N);
  yg.p1 = mat(x, K, 1, dtype);
  yg.q1 = qmat(q, q_s0, q_s1, qscale, 0, 1);
  yg.K1 = K;
  return run_gemm(yg, 1, st);
}

// g (M, N); x (M, K); z, u (M, r) f32 (u is computed here first unless
// have_u); part (chunks, K*r + r*N) f32 scratch with chunks = ceil(M / 512)
// (at least 1); dA (K, r) and dB (r, N) f32.  tc: 1 runs the bf16 tensor-core
// path (its conditions at dab_tc, which refuses what breaks them; split is
// its (4, M, r) bf16 scratch), 0 lora_gemm_kernel.
int fused_lora_bwd_dab_launch(const void* g, const void* x, const float* z, float* u, int have_u,
                              const void* b, const float* s_ptr, float s_val, float* part,
                              void* split, float* da, float* db, int M, int K, int N, int r,
                              int dtype, int tc, void* stream) {
  if (bad_args(M, K, N, r, dtype) || (tc && dtype != kBF16)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = have_u ? 0 : u_pass(g, b, u, M, N, r, dtype, st);
  if (err) return err;
  if (tc) return dab_tc(g, x, z, u, part, split, s_ptr, s_val, da, db, M, K, N, r, st);
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
// idx (M,) int32; y (M, N) in the inputs' dtype.  The split schedule (splits
// chunks of kc rows of K, kc a multiple of 32) comes from the wrapper, which
// chooses it from K and N alone; scratch holds splits * M * N + ceil(K / 256)
// * M * r f32 (the base and shrink partials).  A row whose idx is outside
// [0, slots) gets x @ W alone.
int grouped_lora_forward_launch(const void* x, const void* w, long long w_s0, long long w_s1,
                                const void* a, const void* b, const float* s, const int* idx,
                                float* scratch, void* y, int M, int K, int N, int r, int slots,
                                int splits, int kc, int dtype, void* stream) {
  if (bad_args(M, K, N, r, dtype) || slots <= 0 || kc <= 0 || kc % 32 || splits <= 0 ||
      (long long)splits * kc < K || (long long)(splits - 1) * kc >= K)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Grouped g{};
  g.x = x;
  g.w = w;
  g.ws0 = w_s0;
  g.ws1 = w_s1;
  g.a = a;
  g.b = b;
  g.s = s;
  g.idx = idx;
  g.part = scratch;
  g.zpart = scratch + (long long)splits * M * N;
  g.y = y;
  g.M = M;
  g.K = K;
  g.N = N;
  g.r = r;
  g.S = slots;
  g.splits = splits;
  g.kc = kc;
  g.zchunks = tiles(K, kG5ZChunk);
  g.rtiles = tiles(r, kG5Tile);
  g.bf16 = dtype == kBF16;
  auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const bool tc = dtype == kBF16 && w_s0 == 1 && w_s1 % 8 == 0 && K % 8 == 0 && N % 8 == 0 &&
                  r % 8 == 0 && aligned(x) && aligned(w) && aligned(a) && aligned(b) &&
                  aligned(scratch);
  const long long blocks = (long long)tiles(N, kG5Rows) * splits +
                           (long long)slots * g.zchunks * g.rtiles;
  if (blocks > 0x7fffffffLL || tiles(M, kG5Tile) > 65535 || slots >= 65535)
    return (int)cudaErrorInvalidValue;
  if (tc) {
    const auto attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
    static const bool sized =  // once: both passes take more than 48 KB of shared memory
        cudaFuncSetAttribute(grouped_tc_base_shrink_kernel, attr, kG5Smem1) == cudaSuccess &&
        cudaFuncSetAttribute(grouped_tc_reduce_kernel, attr, kG5Smem2) == cudaSuccess;
    if (!sized) return (int)cudaErrorInvalidValue;
    grouped_tc_base_shrink_kernel<<<(unsigned)blocks, kG5Threads, kG5Smem1, st>>>(g);
  } else {
    grouped_fma_base_shrink_kernel<<<(unsigned)blocks, kG5Threads, 0, st>>>(g);
  }
  int err = (int)cudaGetLastError();
  if (err) return err;
  // the reduce pass as a programmatic dependent launch: it is scheduled while
  // pass 1 runs and waits for pass 1's writes (griddepcontrol.wait)
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles(N, kG5Tile), tiles(M, kG5Tile), tc ? slots + 1 : 1);
  cfg.blockDim = dim3(kG5Threads);
  cfg.dynamicSmemBytes = tc ? kG5Smem2 : 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)(tc ? cudaLaunchKernelEx(&cfg, grouped_tc_reduce_kernel, g)
                  : cudaLaunchKernelEx(&cfg, grouped_fma_reduce_kernel, g));
}

}  // extern "C"

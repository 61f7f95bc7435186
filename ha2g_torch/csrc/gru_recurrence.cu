// Bidirectional GRU recurrence of one layer, forward and backward, as
// thread-block-cluster kernels for NVIDIA Hopper (sm_90a).
//
// Forward: replaces the TPU kernel ha2g_tpu/ops/pallas_gru.py::_kernel, with
// the layout contract of its _pallas_forward:
//   xp   (T, 2, B, 3H)  input projections, direction 1 already time-reversed
//   h0   (2, B, H)      initial hidden state
//   w_hh (2, H, 3H)     recurrent weights, b_hh (2, 3H) recurrent bias
//   out  (T, 2, B, H)   hidden state after every step
// per step and direction, in torch gate order r, z, n:
//   hh = h . w_hh + b_hh (fp32 accumulate)
//   r = sigmoid(x_r + hh_r), z = sigmoid(x_z + hh_z)
//   n = tanh(x_n + r * hh_n), h' = (1 - z) n + z h
// Gates are computed in fp32; the carry is rounded to the storage type
// (fp32 or bf16) every step, before it is shared, as the Pallas kernel
// rounds its VMEM carry.
//
// Backward: the reverse scan of the JAX hand VJP
// ha2g_tpu/ops/gru.py::_gru_scan_bwd (the JAX package has no Pallas
// backward), for one layer and both directions, the gate math in fp32
// (the d_gh . w_hh^T product as the design below says):
//   g = dh + d_out[t]; r, z, n, h_n recomputed from x[t], hh[t], h_prev[t]
//   d_gx = (g f_r, g f_z, g f_n), d_gh = (g f_r, g f_z, g f_n r)
//   dh_prev = g z + d_gh . w_hh^T
// with f_n = (1-z)(1-n^2), f_z = (h_prev-n) z (1-z), f_r = f_n h_n r (1-r).
// hh = h_prev . w_hh + b_hh for all T, d_w_hh and d_b_hh stay outside as
// single products (ops/gru_kernel.py), as the JAX package left them outside
// its scan.
//
// Design.  On the TPU the grid over T ran in order on one core with w_hh
// resident in VMEM.  w_hh of one direction (H x 3H: 540 KB bf16, 1.08 MB
// fp32 at H = 300) does not fit one SM's 227 KB of shared memory, so each
// (direction, group of RB rows) is one thread-block cluster of CS = 8 CTAs
// and CTA k owns the hidden units J_k = [k hs, (k+1) hs), hs = ceil(H/CS)
// (38 at H = 300, the last slice ragged), and with them the three gate
// columns C_k = {j, H+j, 2H+j : j in J_k} of w_hh.  The T loop runs inside
// the cluster; w_hh is read from device memory once per launch per cluster.
// - Forward: CTA k computes hh for its columns C_k and all its rows, forms
//   h'[J_k] (no gate crosses CTAs, since a CTA owns whole units) and writes
//   it into every peer's double-buffered copy of h through distributed
//   shared memory; one cluster barrier a step.  bf16: the product is
//   mma.sync m16n8k16 (bf16 in, fp32 accumulate, rows padded to 16) with
//   the w_hh slice held in registers as B fragments for the whole launch
//   and h read from shared memory.  fp32 (no TF32): register-tiled FFMA
//   with the slice in shared memory.
// - Backward: CTA k forms d_gh[:, C_k] for its units, and multiplies it by
//   w_hh[:, C_k]^T for ALL H units (K = 3 hs, N = H): a partial of dh_prev
//   over its own columns.  It sends each peer q only that peer's units,
//   partial[:, J_q], into a slot of its own in q's shared memory (recv[k])
//   with st.async stores (two floats where hs is even) that count their
//   bytes on q's mbarrier of that recv buffer; q waits for the bytes of all
//   8 sources and sums dh = g z + recv[0] + ... + recv[7] in that fixed
//   order (deterministic).  No cluster barrier in the step loop: recv is
//   double-buffered, and a CTA can send step s + 2's partials only after
//   every peer's step s + 1 ones, sent after that peer read recv of step
//   s, so a buffer is never overwritten unread; its owner re-arms the
//   barrier once it has read it.  BWD_THREADS = 512 threads (16
//   warps, each 3 n-tiles of 8 units), rows 16 a cluster (one m-tile,
//   padded), 32 in bf16 above a batch of 112 so that batch 128 runs as 8
//   clusters in one wave (the card holds 15); fp32 keeps 16 (its w_hh
//   slice takes 150 KB of shared memory).  The rule is a fixed function of
//   the batch (dispatch_backward).
//   bf16 storage: mma.sync m16n8k16, the w_hh[:, C_k]^T B fragments in
//   registers for the whole launch (3 n-tiles x 8 k-steps a warp, loaded
//   once by ldmatrix from a [n][c] copy of the slice) and d_gh split once
//   into hi = bf16(d_gh) and lo = bf16(d_gh - hi) (w_hh is exact in bf16),
//   A fragments by ldmatrix; the hi and lo chains accumulate apart and are
//   added in fp32: ~2^-17 relative to an fp32 product, where d_gh rounded
//   to bf16 alone would be 2^-9 and leave the plain version's tolerance.
//   fp32 storage: 3xTF32 mma.sync m16n8k8 (hi.hi, lo.hi, hi.lo in three
//   chains, both operands split at use into a TF32 truncation and the
//   rest), w_hh[:, C_k] in shared memory (its fragments do not fit the
//   registers).  The choice is the storage type's, made at compile time.
//   The next steps' inputs (x, d_out, hh, h_prev of the cluster's rows and
//   units J_k) are staged in shared memory with cp.async ahead of use:
//   16-byte chunks from the 16-byte boundary below each row's slice (xp's
//   bf16 rows of 3H are not 16-byte multiples, so no TMA), two buffers in
//   bf16 (two steps ahead), one in fp32 (one step ahead; shared memory),
//   issued while the partials travel.  The gate math uses __expf and
//   __fdividef (~1e-7 relative).
//
// Bound.  A layer moves ~2.4 MB at the serving shape (T = 34, H = 300,
// B = 8, bf16): under a microsecond of HBM time; the backward at the train
// shape (34, 96, 300) moves ~95 MB (fp32 d_gx and d_gh out): ~28 us, and
// its product at the bf16 tensor-core rate takes ~7 us.  What bounds both
// designs is the 34 serial steps.  A forward step is one cluster barrier,
// one exchange of h (2 B H bytes to every peer) and a product from
// registers.  A backward step is the wait for the peers' partials, the
// gate math, the product and the partials' trip through distributed
// shared memory (7/8 of RB H floats a CTA).  The previous forward (one block per
// direction and 4 rows, w_hh re-read from L2 every step, 2 SMs at B = 1)
// took 0.40 ms a launch at B = 1 and 0.97 ms at B = 8 and 96 in bf16; the
// previous backward (w_hh rows J_k in shared memory, d_gh broadcast to all
// 8 CTAs as scalar stores, an FFMA product over all 3H columns split along
// K, 16 rows, two cluster barriers a step in fp32) 0.37 ms at
// (34, 96, 300) and 0.70 ms at batch 128 (two waves); the times of this
// design are in PERF.md.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int CS = 8;          // CTAs per cluster (the largest portable size)
constexpr int THREADS = 256;
constexpr int MAX_ITEMS = 4;   // (row, unit) items a thread: RB * hs <= 1024
constexpr size_t SMEM_LIMIT = 232448;   // 227 KB of dynamic shared memory

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int rup(int a, int b) { return cdiv(a, b) * b; }
__host__ __device__ inline size_t rup16(size_t n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid_f32(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Shapes of one CTA's share of the work.  FFMA product (ffma_tile): lanes
// over LN columns, RB / R row tiles of R rows, KS = THREADS / (LN RB / R)
// slices of kc (a multiple of 4) along K, w_s [N][ldw] (k contiguous, ldw =
// K4 or K4 + 4 so that ldw / 4 is odd and 8 neighbouring columns' 4-value
// loads fall on distinct banks); the forward (fp32 only) has N = 3 hs gate
// columns, K4 = H4, LN = 32, R <= 8.  mma product (bf16 forward, rows
// padded to 16): the w_hh slice lives in registers as mma B fragments
// (n-tiles warp and warp + 8, up to MMA_KSTEPS k-steps of 16); h is
// [16][KP], KP = H rounded up to 16, plus 8 so that rows of 32-bit words
// start on banks 4 apart; NP = 3 hs rounded up to 8 columns of hh.
constexpr int FWD_LN = 32, FWD_RMAX = 8, FWD_CMAX = 4;   // N <= 128
constexpr int MMA_ROWS = 16, MMA_KSTEPS = 20;           // H <= 320

struct Plan {
  int hs, N, H4, KS, kc, ldw, NP, KP;
};

__host__ __device__ inline Plan make_plan(int H, int RB) {
  Plan p;
  p.hs = cdiv(H, CS);
  p.H4 = rup(H, 4);
  p.N = 3 * p.hs;
  p.KS = THREADS / (FWD_LN * (RB / min(RB, FWD_RMAX)));
  p.kc = rup(cdiv(p.H4, p.KS), 4);
  p.ldw = p.H4 / 4 % 2 ? p.H4 : p.H4 + 4;
  p.NP = rup(3 * p.hs, 8);
  p.KP = rup(H, 16) + 8;
  return p;
}

template <typename T, int RB, bool MMA>
size_t forward_smem(int H) {
  const Plan p = make_plan(H, RB);
  if (MMA)
    return rup16((size_t)p.NP * 4) + rup16((size_t)2 * MMA_ROWS * p.KP * 2) +
           (size_t)MMA_ROWS * p.NP * 4;
  return rup16((size_t)p.N * p.ldw * sizeof(T)) + rup16((size_t)p.N * 4) +
         rup16((size_t)2 * RB * p.H4 * 4) + (size_t)p.KS * RB * p.N * 4;
}

// Four consecutive values of w_s as floats: one 16-byte load in fp32, one
// 8-byte load in bf16.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

// Register-tiled FFMA: part[ks][r][n] = sum over k in slice ks of
// a[r][k] * w[n][k], r < RB, n < N.  a: fp32 [RB][lda], 16-byte aligned,
// lda % 4 == 0, zero past K; w: [N][ldw], zero past K.  Thread
// (ln, rg, ks) = (tid % LN, tid / LN % RG, tid / (LN RG)) keeps an R x C
// tile: rows rg R .. rg R + R - 1, columns ln + LN c.  Each 4-value load of
// h feeds 4 C FMAs and each of w 4 R, so few shared memory loads feed each
// FMA.
template <typename T, int RB, int R, int LN, int C>
__device__ __forceinline__ void ffma_tile(const float* a, int lda,
                                          const T* w, int ldw, int N, int K4,
                                          int kc, float* part) {
  constexpr int RG = RB / R;
  const int tid = threadIdx.x;
  const int ln = tid % LN, rg = (tid / LN) % RG, ks = tid / (LN * RG);
  const int k0 = ks * kc;
  const int k1 = min(K4, k0 + kc);
  const float* ar = a + rg * R * lda;
  float acc[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.0f;
#pragma unroll 2
  for (int k = k0; k < k1; k += 4) {
    float4 wv[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int n = ln + LN * c;
      wv[c] = n < N ? load4(w + (size_t)n * ldw + k)
                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 h = *reinterpret_cast<const float4*>(ar + r * lda + k);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[r][c] = fmaf(h.x, wv[c].x, acc[r][c]);
        acc[r][c] = fmaf(h.y, wv[c].y, acc[r][c]);
        acc[r][c] = fmaf(h.z, wv[c].z, acc[r][c]);
        acc[r][c] = fmaf(h.w, wv[c].w, acc[r][c]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int n = ln + LN * c;
      if (n < N) part[(ks * RB + rg * R + r) * N + n] = acc[r][c];
    }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Forward.  Grid (CS, row groups, 2 directions), clusters of (CS, 1, 1).
template <typename T, int RB, bool MMA>
__global__ void __launch_bounds__(THREADS)
    gru_recurrence_kernel(const T* __restrict__ xp, const T* __restrict__ h0,
                          const T* __restrict__ w_hh,
                          const T* __restrict__ b_hh, T* __restrict__ out,
                          int n_steps, int B, int H) {
  using HT = typename std::conditional<MMA, __nv_bfloat16, float>::type;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int d = blockIdx.z, row0 = blockIdx.y * RB;
  const int rows = min(RB, B - row0);
  const int G = 3 * H;
  const Plan p = make_plan(H, RB);
  const int hs = p.hs, j0 = rank * hs;
  const int nk = max(0, min(H, j0 + hs) - j0);
  // rows of the h buffers (the mma tile pads them to 16), row stride of h
  // and of the per-row hh sums
  constexpr int RM = MMA ? MMA_ROWS : RB;
  const int ldh = MMA ? p.KP : p.H4;
  const int ldc = MMA ? p.NP : p.N;
  const int KS = MMA ? 1 : p.KS;

  extern __shared__ __align__(16) unsigned char smem[];
  T* w_s = reinterpret_cast<T*>(smem);                  // FFMA: [N][ldw]
  size_t off = MMA ? 0 : rup16((size_t)p.N * p.ldw * sizeof(T));
  float* b_s = reinterpret_cast<float*>(smem + off);
  off += rup16((size_t)(MMA ? p.NP : p.N) * 4);
  HT* h_s = reinterpret_cast<HT*>(smem + off);          // [2][RM][ldh]
  off += rup16((size_t)2 * RM * ldh * sizeof(HT));
  float* part = reinterpret_cast<float*>(smem + off);    // [KS][RB][ldc]

  const T* w = w_hh + (size_t)d * H * G;
  const int lane = tid % 32, grp = lane >> 2, tig = lane & 3;
  const int warp = tid / 32;
  // mma: this lane's B fragments of the n-tiles warp and warp + 8 (gate
  // column c = g hs + u of the slice), for every k-step, held in registers
  // for the whole launch
  uint32_t bfr[2][MMA_KSTEPS][2];
  if constexpr (MMA) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = (warp + THREADS / 32 * j) * 8 + grp;
      const int g = c / hs, u = c - g * hs;
      const bool col = g < 3 && u < nk;
      const T* wc = w + g * H + j0 + u;
#pragma unroll
      for (int ks = 0; ks < MMA_KSTEPS; ++ks)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int k = ks * 16 + q * 8 + tig * 2;
          bfr[j][ks][q] = pack_bf16(
              col && k < H ? to_f32(wc[(size_t)k * G]) : 0.0f,
              col && k + 1 < H ? to_f32(wc[(size_t)(k + 1) * G]) : 0.0f);
        }
    }
  } else {
    // w_s[c][k], c = g hs + u: read along c (coalesced), written transposed
    for (int i = tid; i < p.ldw * p.N; i += THREADS) {
      const int k = i / p.N, c = i - k * p.N;
      const int g = c / hs, u = c - g * hs;
      w_s[(size_t)c * p.ldw + k] = (k < H && u < nk)
                                       ? w[(size_t)k * G + g * H + j0 + u]
                                       : from_f32<T>(0.0f);
    }
  }
  for (int c = tid; c < ldc; c += THREADS) {
    const int g = c / hs, u = c - g * hs;
    b_s[c] = (g < 3 && u < nk) ? to_f32(b_hh[(size_t)d * G + g * H + j0 + u])
                               : 0.0f;
  }
  for (int i = tid; i < 2 * RM * ldh; i += THREADS) {
    const int r = (i / ldh) % RM, k = i % ldh;
    const bool first = i < RM * ldh;
    const float v =
        first && r < rows && k < H
            ? to_f32(h0[((size_t)d * B + row0 + r) * H + k])
            : 0.0f;
    h_s[i] = static_cast<HT>(v);
  }
  // every peer's shared memory is set up before any remote write
  cluster.sync();

  // items (r, u) of the gate phase: fixed per thread across steps
  // raw values: converted at use, so the loads stay in flight
  T x[MAX_ITEMS][3], xn[MAX_ITEMS][3];
  auto load_x = [&](T (&dst)[MAX_ITEMS][3], int t) {
#pragma unroll
    for (int s = 0; s < MAX_ITEMS; ++s) {
      const int i = tid + s * THREADS, r = i / hs, u = i - r * hs;
      if (r < rows && u < nk) {
        const T* xr = xp + (((size_t)t * 2 + d) * B + row0 + r) * G + j0 + u;
        dst[s][0] = xr[0];
        dst[s][1] = xr[H];
        dst[s][2] = xr[2 * H];
      }
    }
  };
  load_x(x, 0);

  for (int t = 0; t < n_steps; ++t) {
    const int cur = t & 1;
    HT* h_cur = h_s + (size_t)cur * RM * ldh;
    HT* h_next = h_s + (size_t)(cur ^ 1) * RM * ldh;
    if (t + 1 < n_steps) load_x(xn, t + 1);
    if constexpr (MMA) {
      // hh = h . w for 16 rows: A fragments from shared memory, B from
      // registers; accumulators alternate along k (four chains a warp)
      float c[2][2][4] = {};
      const HT* ha = h_cur + grp * p.KP + tig * 2;
#pragma unroll
      for (int ks = 0; ks < MMA_KSTEPS; ++ks) {
        if (ks * 16 < H) {
          const int k = ks * 16;
          const uint32_t a0 = ld32(ha + k), a1 = ld32(ha + 8 * p.KP + k);
          const uint32_t a2 = ld32(ha + k + 8);
          const uint32_t a3 = ld32(ha + 8 * p.KP + k + 8);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            mma_bf16(c[j][ks & 1], a0, a1, a2, a3, bfr[j][ks][0],
                     bfr[j][ks][1]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = (warp + THREADS / 32 * j) * 8 + tig * 2;
        if (col < p.NP) {
          part[grp * p.NP + col] = c[j][0][0] + c[j][1][0];
          part[grp * p.NP + col + 1] = c[j][0][1] + c[j][1][1];
          part[(grp + 8) * p.NP + col] = c[j][0][2] + c[j][1][2];
          part[(grp + 8) * p.NP + col + 1] = c[j][0][3] + c[j][1][3];
        }
      }
    } else {
      ffma_tile<T, RB, (RB < FWD_RMAX ? RB : FWD_RMAX), FWD_LN, FWD_CMAX>(
          h_cur, p.H4, w_s, p.ldw, p.N, p.H4, p.kc, part);
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < MAX_ITEMS; ++s) {
      const int i = tid + s * THREADS, r = i / hs, u = i - r * hs;
      if (r < rows && u < nk) {
        float hh[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          const int c = g * hs + u;
          float acc = b_s[c];
          for (int ks = 0; ks < KS; ++ks) acc += part[(ks * RB + r) * ldc + c];
          hh[g] = acc;
        }
        const float rg = sigmoid_f32(to_f32(x[s][0]) + hh[0]);
        const float zg = sigmoid_f32(to_f32(x[s][1]) + hh[1]);
        const float ng = tanhf(to_f32(x[s][2]) + rg * hh[2]);
        const float hp = to_f32(h_cur[r * ldh + j0 + u]);
        const T h_new = from_f32<T>((1.0f - zg) * ng + zg * hp);
        out[(((size_t)t * 2 + d) * B + row0 + r) * H + j0 + u] = h_new;
        const HT hv = static_cast<HT>(to_f32(h_new));
#pragma unroll
        for (int q = 0; q < CS; ++q)
          cluster.map_shared_rank(h_next, q)[r * ldh + j0 + u] = hv;
      }
    }
    cluster.sync();
#pragma unroll
    for (int s = 0; s < MAX_ITEMS; ++s)
#pragma unroll
      for (int g = 0; g < 3; ++g) x[s][g] = xn[s][g];
  }
}

// Backward plan (mirrored by ops/gru_kernel.py::cluster_plan).  A cluster
// carries RB = 16 MT rows (MT m-tiles of 16); CTA k the units J_k and the
// K = 3 hs gate columns c = g hs + u (g = r, z, n; u < hs) of d_gh; the
// product's N = H units are NT n-tiles of 8, warp w taking w + 16 j.
constexpr int BWD_THREADS = 512;
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_NT = (320 / 8 + BWD_WARPS - 1) / BWD_WARPS;   // H <= 320
constexpr int BWD_KMAX = 128;              // 3 hs <= 128 (8 bf16 k-steps)
constexpr int BWD_HSMAX = BWD_KMAX / 3;    // 42 units a CTA
constexpr int BWD_KA = BWD_KMAX + 8;       // bf16 d_gh row: 272 bytes, so
                                           // ldmatrix rows hit distinct banks
constexpr int BWD_SPLIT_BATCH = 112;       // bf16: 32 rows above this batch

template <typename T>
__host__ __device__ constexpr bool is_bf16() {
  return std::is_same<T, __nv_bfloat16>::value;
}

// hs units a CTA, NT n-tiles, kw the fp32 row stride of d_gh and of the
// w_hh slice (K rounded to 8, plus 4: fragment loads hit distinct banks),
// sx / sf the bytes of one staged row slice of the storage-type inputs
// (x_r, x_z, x_n, d_out; bf16 w_hh rows at the start) / of the fp32 ones
// (hh_r, hh_z, hh_n, h_prev): whole 16-byte chunks from the boundary at or
// below the slice's start.
struct BwdPlan {
  int hs, NT, kw, sx, sf;
};

template <typename T>
__host__ __device__ inline BwdPlan bwd_plan(int H) {
  BwdPlan p;
  p.hs = cdiv(H, CS);
  p.NT = cdiv(H, 8);
  p.kw = rup(3 * p.hs, 8) + 4;
  constexpr int V = 16 / sizeof(T);
  p.sx = 16 * cdiv(p.hs + V - 1, V);
  p.sf = 16 * cdiv(p.hs + 3, 4);
  return p;
}

// Byte offsets of the shared memory regions: w (fp32 only: w_hh[:, C_k]
// as [H][kw]), a (d_gh of the step: bf16 hi and lo [2][RB][BWD_KA], or fp32
// [RB][kw]), recv ([2][CS][RB][hs] partials, a slot per source CTA), gz
// ([RB][hs]: g z of the step), stage (NST buffers of staged inputs), bar
// (an mbarrier for each recv buffer).  bf16 stages w_hh[:, C_k] from recv
// on at the start (w_t below).
struct BwdSmem {
  int a, recv, gz, stage, stage_bytes, w_t, bar, total;
};

template <typename T, int MT>
__host__ __device__ inline BwdSmem bwd_smem(int H) {
  constexpr int RB = 16 * MT, NST = is_bf16<T>() ? 2 : 1;
  const BwdPlan p = bwd_plan<T>(H);
  BwdSmem s;
  s.a = is_bf16<T>() ? 0 : (int)rup16((size_t)H * p.kw * 4);
  s.recv = s.a + (int)(is_bf16<T>() ? rup16((size_t)2 * RB * BWD_KA * 2)
                                    : rup16((size_t)RB * p.kw * 4));
  s.gz = s.recv + 2 * CS * RB * p.hs * 4;
  s.stage = s.gz + (int)rup16((size_t)RB * p.hs * 4);
  s.stage_bytes = RB * 4 * (p.sx + p.sf);
  s.total = s.stage + NST * s.stage_bytes;
  // bf16 first stages w_hh[:, C_k] from recv on: raw row slices, then
  // w_t[n][c] (rows of BWD_KA) for ldmatrix
  s.w_t = s.recv + (int)rup16((size_t)H * 3 * p.sx);
  if (is_bf16<T>() && s.w_t + rup(H, 8) * BWD_KA * 2 > s.total)
    s.total = s.w_t + rup(H, 8) * BWD_KA * 2;
  s.bar = (int)rup16(s.total);   // the two mbarriers of recv
  s.total = s.bar + 16;
  return s;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = smem_addr(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// v = hi + lo: hi the TF32 truncation of v, lo the exact rest (the tensor
// cores read its top 11 bits: 2^-21 of v)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, of which the first `bytes` are read (the rest
// zero-filled); 4 bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = smem_addr(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = smem_addr(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// The partials' transport: st.async stores into a peer's shared memory
// that count their bytes on the peer's mbarrier (complete_tx); the owner
// arms the barrier of a recv buffer with the bytes it expects
// (arrive.expect_tx) and waits on its phase.  A wait that outlasts ~2^22
// polls traps (a fault, not a hang).
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_async(uint32_t addr, uint32_t bar,
                                         float v) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async2(uint32_t addr, uint32_t bar,
                                          float v0, float v1) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr),
      "r"(__float_as_uint(v0)), "r"(__float_as_uint(v1)), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_arm(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (int spin = 0; !done; ++spin) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spin > (1 << 22)) __trap();
  }
}

// Stage the slices [j0, j0 + nk) of `rows` rows of the segments
// q = 0..NSEG-1 into dst.  Segment q < 3 of row r starts at element
// seg(q, r) of base3 (n3 elements), q = 3 at seg(3, r) of base1 (n1); both
// bases 16-byte aligned.  Slot (r, q) of `slot` bytes gets the 16-byte
// chunks from the boundary at or below the slice's start, so value u
// lands at index (start % V) + u, V = 16 / sizeof(E); a chunk reaching
// past its tensor's end reads only up to it.  P (a power of two) >= the
// chunks of a slot.
template <int NSEG, int P, typename E, typename Seg>
__device__ __forceinline__ void stage_rows(unsigned char* dst, int slot,
                                           int rows, int nk, Seg seg,
                                           const E* base3, int n3,
                                           const E* base1, int n1) {
  constexpr int V = 16 / sizeof(E);
  for (int i = threadIdx.x; i < rows * NSEG * P; i += BWD_THREADS) {
    const int s = i / P, c = i % P, q = s % NSEG;
    const int start = seg(q, s / NSEG), lead = start % V;
    if (c * V < lead + nk) {
      const int e0 = start - lead + V * c, left = (q < 3 ? n3 : n1) - e0;
      cp_async16(dst + s * slot + 16 * c, (q < 3 ? base3 : base1) + e0,
                 left < V ? left * (int)sizeof(E) : 16);
    }
  }
}

// The backward's gate math: sigmoid and tanh through __expf and
// __fdividef (a few ulp, ~1e-7 relative; the limits at +-inf exact)
__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.0f - __fdividef(2.0f, __expf(2.0f * x) + 1.0f);
}

// c / hs for c < 512 and hs <= 42: the quotient through a float, exact
// since (c + 1/2) / hs lies at least 1 / 84 from an integer
__device__ __forceinline__ int div_small(int c, float inv_hs) {
  return __float2int_rz(((float)c + 0.5f) * inv_hs);
}

// Backward.  Same grid and clusters as the forward, with RB = 16 MT rows
// and BWD_THREADS threads.
template <typename T, int MT>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    gru_backward_kernel(const T* __restrict__ xp, const float* __restrict__ hh,
                        const float* __restrict__ h_prev,
                        const T* __restrict__ w_hh,
                        const T* __restrict__ d_outs,
                        float* __restrict__ d_gx, float* __restrict__ d_gh,
                        float* __restrict__ d_h0, int n_steps, int B, int H) {
  constexpr bool BF16 = is_bf16<T>();
  constexpr int RB = 16 * MT, NST = BF16 ? 2 : 1;
  constexpr int NCH = BF16 ? 2 : 3;   // accumulator chains of the product
  // (row, unit) items of a thread, fixed across steps
  constexpr int ITEMS = (RB * BWD_HSMAX + BWD_THREADS - 1) / BWD_THREADS;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int grp = lane >> 2, tig = lane & 3;
  const int d = blockIdx.z, row0 = blockIdx.y * RB;
  const int rows = min(RB, B - row0);
  const int G = 3 * H;
  const BwdPlan p = bwd_plan<T>(H);
  const BwdSmem sm = bwd_smem<T, MT>(H);
  const int hs = p.hs, j0 = rank * hs, K = 3 * hs;
  const int nk = max(0, min(H, j0 + hs) - j0);
  const float inv_hs = 1.0f / (float)hs;

  extern __shared__ __align__(16) unsigned char smem[];
  float* w_s = reinterpret_cast<float*>(smem);                // fp32 [H][kw]
  unsigned char* a_s = smem + sm.a;
  float* recv = reinterpret_cast<float*>(smem + sm.recv);  // [2][CS][RB][hs]
  float* gz = reinterpret_cast<float*>(smem + sm.gz);      // [RB][hs]

  // d_gh is zero outside rows < rows, units < nk and columns < K for the
  // whole launch
  for (int i = 16 * tid; i < sm.recv - sm.a; i += 16 * BWD_THREADS)
    *reinterpret_cast<uint4*>(a_s + i) = make_uint4(0u, 0u, 0u, 0u);
  // w_hh[:, C_k] into shared memory: bf16 as staged row slices (from recv
  // on, turned into register fragments below), fp32 as w_s[n][c]
  const T* w = w_hh + (size_t)d * H * G;
  if constexpr (BF16) {
    stage_rows<3, 8>(
        smem + sm.recv, p.sx, H, nk,
        [&](int q, int n) { return (d * H + n) * G + q * H + j0; }, w_hh,
        2 * H * G, w_hh, 0);
  } else {
    int col[5];   // c = lane + 32 i: w_hh column, or -1 past the slice
#pragma unroll
    for (int i = 0; i < 5; ++i) {
      const int c = lane + 32 * i, g = div_small(c, inv_hs), u = c - g * hs;
      col[i] = c < p.kw && g < 3 && u < nk ? g * H + j0 + u : -1;
    }
    for (int n = warp; n < H; n += BWD_WARPS)
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const int c = lane + 32 * i;
        if (col[i] >= 0)
          cp_async4(w_s + (size_t)n * p.kw + c, w + (size_t)n * G + col[i]);
        else if (c < p.kw)
          w_s[(size_t)n * p.kw + c] = 0.0f;
      }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // bf16: w_t[n][c] = w_hh[n][C_k] from the slices (zero past H, K and the
  // slice), two columns a 32-bit word, then this lane's B fragments of it (n-tiles warp + W j, k-steps
  // of 16 local columns) by ldmatrix, in registers for the whole launch
  uint32_t bfr[BWD_NT][BWD_KMAX / 16][2];
  if constexpr (BF16) {
    const T* raw = reinterpret_cast<const T*>(smem + sm.recv);
    const T* w_t = reinterpret_cast<const T*>(smem + sm.w_t);
    // word wd = lane + 32 i of a row holds columns 2 wd, 2 wd + 1: their
    // gate (3 past K and the slice) and unit
    constexpr int WORDS = BWD_KA / 2, PASSES = (WORDS + 31) / 32;
    int gc[PASSES][2], uc[PASSES][2];
#pragma unroll
    for (int i = 0; i < PASSES; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * (lane + 32 * i) + e, g = div_small(c, inv_hs);
        uc[i][e] = c - g * hs;
        gc[i][e] = c < K && uc[i][e] < nk ? g : 3;
      }
    for (int n = warp; n < rup(H, 8); n += BWD_WARPS) {
      const int e0 = (d * H + n) * G + j0;   // w_hh element of (n, 0, j0)
#pragma unroll
      for (int i = 0; i < PASSES; ++i) {
        if (lane + 32 * i >= WORDS) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int g = gc[i][e];
          v[e] = n < H && g < 3 ? to_f32(raw[(n * 3 + g) * (p.sx / 2) +
                                             (e0 + g * H) % 8 + uc[i][e]])
                                : 0.0f;
        }
        reinterpret_cast<uint32_t*>(smem + sm.w_t)[n * WORDS + lane + 32 * i] =
            pack_bf16(v[0], v[1]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < BWD_NT; ++j) {
      if (warp + BWD_WARPS * j >= p.NT) continue;
      // matrix m = lane / 8: rows n of the n-tile, columns 16 ks + 8 m
      const T* row = w_t + ((warp + BWD_WARPS * j) * 8 + lane % 8) * BWD_KA +
                     8 * (lane / 8);
#pragma unroll
      for (int ks = 0; ks < BWD_KMAX / 16; ks += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, row + 16 * ks);
        bfr[j][ks][0] = r[0];
        bfr[j][ks][1] = r[1];
        bfr[j][ks + 1][0] = r[2];
        bfr[j][ks + 1][1] = r[3];
      }
    }
    __syncthreads();   // the staged inputs overwrite w_t
  }
  int item[ITEMS];   // r << 8 | u, or -1
#pragma unroll
  for (int s = 0; s < ITEMS; ++s) {
    const int i = tid + s * BWD_THREADS, r = i / hs, u = i - r * hs;
    item[s] = r < rows && u < nk ? r << 8 | u : -1;
  }

  // first element of slice q of row r at step t, in xp and hh (q < 3:
  // the r, z, n columns) or in d_outs and h_prev (q = 3); element offsets
  // fit an int (the entry point checks)
  auto seg = [&](int t, int q, int r) {
    const int row = (t * 2 + d) * B + row0 + r;
    return q < 3 ? row * G + q * H + j0 : row * H + j0;
  };
  const int n_rows = n_steps * 2 * B;
  auto stage = [&](int t, int buf) {
    unsigned char* st = smem + sm.stage + buf * sm.stage_bytes;
    auto seg_t = [&](int q, int r) { return seg(t, q, r); };
    stage_rows<4, (BF16 ? 8 : 16)>(st, p.sx, rows, nk, seg_t, xp, n_rows * G,
                                   d_outs, n_rows * H);
    stage_rows<4, 16>(st + RB * 4 * p.sx, p.sf, rows, nk, seg_t, hh,
                      n_rows * G, h_prev, n_rows * H);
  };
  // inputs of the first NST steps in flight
  stage(n_steps - 1, 0);
  cp_async_commit();
  if (NST == 2 && n_steps > 1) stage(n_steps - 2, 1);
  cp_async_commit();
  // recv buffer b receives the partials of steps b, b + 2, ...: 8 sources'
  // rows x nk floats; armed for steps 0 and 1 here, for step s + 1 once
  // step s has read step s - 1's
  const uint32_t bar = smem_addr(smem + sm.bar);
  const uint32_t bytes = (uint32_t)(CS * rows * nk * 4);
  if (tid == 0) {
    mbar_init(bar);
    mbar_init(bar + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_arm(bar, bytes);
    mbar_arm(bar + 8, bytes);
  }
  // every peer's shared memory and barriers are set up before any remote
  // write
  cluster.sync();

  for (int step = 0; step < n_steps; ++step) {
    const int t = n_steps - 1 - step;
    const int cur = NST == 2 ? step & 1 : 0;
    // the previous step's partials, from all 8 CTAs
    if (step > 0) mbar_wait(bar + 8 * ((step - 1) & 1), ((step - 1) >> 1) & 1);
    // this step's inputs: the second newest group (NST == 2) or the newest
    if constexpr (NST == 2)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    // gate phase: items (r, u) of this CTA's units; the incoming dh of
    // every item first
    const unsigned char* __restrict__ st =
        smem + sm.stage + cur * sm.stage_bytes;
    const float* __restrict__ rv = recv + ((step + 1) & 1) * CS * RB * hs;
    float dh[ITEMS];
#pragma unroll
    for (int s = 0; s < ITEMS; ++s) {
      const int r = item[s] >> 8, u = item[s] & 255;
      dh[s] = 0.0f;
      if (step > 0 && item[s] >= 0) {
        dh[s] = gz[r * hs + u];
#pragma unroll
        for (int k = 0; k < CS; ++k) dh[s] += rv[(k * RB + r) * hs + u];
      }
    }
    constexpr int VX = 16 / sizeof(T);
#pragma unroll
    for (int s = 0; s < ITEMS; ++s) {
      if (item[s] < 0) continue;
      const int r = item[s] >> 8, u = item[s] & 255;
      float x[4], f[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = seg(t, q, r);
        x[q] = to_f32(reinterpret_cast<const T*>(
            st + (r * 4 + q) * p.sx)[e % VX + u]);
        f[q] = reinterpret_cast<const float*>(
            st + RB * 4 * p.sx + (r * 4 + q) * p.sf)[e % 4 + u];
      }
      const float g = dh[s] + x[3];
      const float rg = sigmoid_fast(x[0] + f[0]);
      const float zg = sigmoid_fast(x[1] + f[1]);
      const float h_n = f[2];
      const float ng = tanh_fast(x[2] + rg * h_n);
      const float f_n = (1.0f - zg) * (1.0f - ng * ng);
      const float f_z = (f[3] - ng) * zg * (1.0f - zg);
      const float f_r = f_n * h_n * rg * (1.0f - rg);
      const float dv[3] = {g * f_r, g * f_z, g * f_n * rg};
      const int base = seg(t, 0, r) + u;
      d_gx[base] = dv[0];
      d_gx[base + H] = dv[1];
      d_gx[base + 2 * H] = g * f_n;
      d_gh[base] = dv[0];
      d_gh[base + H] = dv[1];
      d_gh[base + 2 * H] = dv[2];
      gz[r * hs + u] = g * zg;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const int c = q * hs + u;
        if constexpr (BF16) {
          __nv_bfloat16* a = reinterpret_cast<__nv_bfloat16*>(a_s);
          const __nv_bfloat16 hi = __float2bfloat16_rn(dv[q]);
          a[r * BWD_KA + c] = hi;
          a[(RB + r) * BWD_KA + c] =
              __float2bfloat16_rn(dv[q] - __bfloat162float(hi));
        } else {
          reinterpret_cast<float*>(a_s)[r * p.kw + c] = dv[q];
        }
      }
    }
    __syncthreads();
    // product: partial[r][n] = sum_c d_gh[r][c] w_hh[n][c] over this CTA's
    // columns, in NCH chains (bf16: hi, lo; fp32: hi.hi, lo.hi, hi.lo)
    // added in that order, sent to the owners of the units
    // recv of step - 1 is read: arm its barrier for step + 1
    if (tid == 0 && step > 0 && step + 1 < n_steps)
      mbar_arm(bar + 8 * ((step + 1) & 1), bytes);
    const uint32_t out = smem_addr(recv + ((step & 1) * CS + rank) * RB * hs);
    const uint32_t out_bar = bar + 8 * (step & 1);
#pragma unroll 1
    for (int m = 0; m < MT; ++m) {
      float acc[BWD_NT][NCH][4] = {};
      if constexpr (BF16) {
        const __nv_bfloat16* ah =
            reinterpret_cast<const __nv_bfloat16*>(a_s) +
            (m * 16 + lane % 16) * BWD_KA + (lane / 16) * 8;
        const __nv_bfloat16* al = ah + RB * BWD_KA;
#pragma unroll
        for (int ks = 0; ks < BWD_KMAX / 16; ++ks) {
          if (ks * 16 < K) {
            uint32_t a[4], b[4];
            ldmatrix_x4(a, ah + ks * 16);
            ldmatrix_x4(b, al + ks * 16);
#pragma unroll
            for (int j = 0; j < BWD_NT; ++j)
              if (warp + BWD_WARPS * j < p.NT) {
                mma_bf16(acc[j][0], a[0], a[1], a[2], a[3], bfr[j][ks][0],
                         bfr[j][ks][1]);
                mma_bf16(acc[j][1], b[0], b[1], b[2], b[3], bfr[j][ks][0],
                         bfr[j][ks][1]);
              }
          }
        }
      } else {
        const float* a32 = reinterpret_cast<const float*>(a_s);
#pragma unroll
        for (int ks = 0; ks < BWD_KMAX / 8; ++ks) {
          if (ks * 8 < K) {
            const float* ar = a32 + grp * p.kw + ks * 8 + tig;
            uint32_t a_hi[4], a_lo[4];
            split_tf32(ar[0], a_hi[0], a_lo[0]);
            split_tf32(ar[8 * p.kw], a_hi[1], a_lo[1]);
            split_tf32(ar[4], a_hi[2], a_lo[2]);
            split_tf32(ar[8 * p.kw + 4], a_hi[3], a_lo[3]);
#pragma unroll
            for (int j = 0; j < BWD_NT; ++j)
              if (warp + BWD_WARPS * j < p.NT) {
                const int n = (warp + BWD_WARPS * j) * 8 + grp;
                const float* wr = w_s + (size_t)n * p.kw + ks * 8 + tig;
                uint32_t h0, l0, h1, l1;
                split_tf32(n < H ? wr[0] : 0.0f, h0, l0);
                split_tf32(n < H ? wr[4] : 0.0f, h1, l1);
                mma_tf32(acc[j][0], a_hi, h0, h1);
                mma_tf32(acc[j][1], a_lo, h0, h1);
                mma_tf32(acc[j][2], a_hi, l0, l1);
              }
          }
        }
      }
      // c[2 h + e]: row m 16 + grp + 8 h, unit (warp + 16 j) 8 + tig 2 + e
#pragma unroll
      for (int j = 0; j < BWD_NT; ++j) {
        const int u0 = (warp + BWD_WARPS * j) * 8 + tig * 2;
        if (warp + BWD_WARPS * j >= p.NT || u0 >= H) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m * 16 + grp + 8 * h;
          if (r >= rows) continue;
          float v0 = acc[j][0][2 * h], v1 = acc[j][0][2 * h + 1];
#pragma unroll
          for (int ch = 1; ch < NCH; ++ch) {
            v0 += acc[j][ch][2 * h];
            v1 += acc[j][ch][2 * h + 1];
          }
          // unit u of owner q: its slot for this CTA, row r
          auto at = [&](int q, int u) {
            return peer_addr(out + 4 * (r * hs + u), q);
          };
          const int q = div_small(u0, inv_hs), u = u0 - q * hs;
          if (hs % 2 == 0 && u0 + 1 < H) {
            st_async2(at(q, u), peer_addr(out_bar, q), v0, v1);
          } else {
            st_async(at(q, u), peer_addr(out_bar, q), v0);
            if (u0 + 1 < H) {
              const int q1 = u + 1 == hs ? q + 1 : q;
              st_async(at(q1, u + 1 == hs ? 0 : u + 1), peer_addr(out_bar, q1),
                       v1);
            }
          }
        }
      }
    }
    // the buffer this step read is free: stage the inputs of step
    // t - NST into it while the partials travel
    if (t >= NST) stage(t - NST, cur);
    cp_async_commit();
  }
  mbar_wait(bar + 8 * ((n_steps - 1) & 1), ((n_steps - 1) >> 1) & 1);
  const float* rv = recv + ((n_steps + 1) & 1) * CS * RB * hs;
#pragma unroll
  for (int s = 0; s < ITEMS; ++s) {
    if (item[s] < 0) continue;
    const int r = item[s] >> 8, u = item[s] & 255;
    float dh = gz[r * hs + u];
#pragma unroll
    for (int k = 0; k < CS; ++k) dh += rv[(k * RB + r) * hs + u];
    d_h0[((size_t)d * B + row0 + r) * H + j0 + u] = dh;
  }
  // no CTA leaves while a peer may still address its shared memory
  cluster.sync();
}

int rows_per_group(int B) {
  return B <= 1 ? 1 : B <= 2 ? 2 : B <= 4 ? 4 : B <= 8 ? 8 : 16;
}

cudaLaunchConfig_t cluster_config(int B, int RB, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CS, cdiv(B, RB), 2);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CS;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch (query == nullptr) or, with query, store the number of clusters
// that can be co-resident for this shape (cudaOccupancyMaxActiveClusters).
template <typename T, int RB, bool MMA>
cudaError_t forward_launch(const void* xp, const void* h0, const void* w_hh,
                           const void* b_hh, void* out, int n_steps, int B,
                           int H, cudaStream_t stream, int* query) {
  const size_t smem = forward_smem<T, RB, MMA>(H);
  if (smem > SMEM_LIMIT || RB * cdiv(H, CS) > MAX_ITEMS * THREADS ||
      3 * cdiv(H, CS) > FWD_LN * FWD_CMAX ||
      (MMA && cdiv(H, 16) > MMA_KSTEPS))
    return cudaErrorInvalidValue;
  auto kernel = gru_recurrence_kernel<T, RB, MMA>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(B, RB, smem, stream, &attr);
  if (query) return cudaOccupancyMaxActiveClusters(query, kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(xp),
                           static_cast<const T*>(h0),
                           static_cast<const T*>(w_hh),
                           static_cast<const T*>(b_hh), static_cast<T*>(out),
                           n_steps, B, H);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int MT>
cudaError_t backward_launch(const void* xp, const void* hh,
                            const void* h_prev, const void* w_hh,
                            const void* d_outs, void* d_gx, void* d_gh,
                            void* d_h0, int n_steps, int B, int H,
                            cudaStream_t stream, int* query) {
  const size_t smem = bwd_smem<T, MT>(H).total;
  const BwdPlan p = bwd_plan<T>(H);
  if (smem > SMEM_LIMIT || 3 * p.hs > BWD_KMAX || p.NT > BWD_WARPS * BWD_NT)
    return cudaErrorInvalidValue;
  auto kernel = gru_backward_kernel<T, MT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(B, 16 * MT, smem, stream, &attr);
  cfg.blockDim = dim3(BWD_THREADS);
  if (query) return cudaOccupancyMaxActiveClusters(query, kernel, &cfg);
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(xp), static_cast<const float*>(hh),
      static_cast<const float*>(h_prev), static_cast<const T*>(w_hh),
      static_cast<const T*>(d_outs), static_cast<float*>(d_gx),
      static_cast<float*>(d_gh), static_cast<float*>(d_h0), n_steps, B, H);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The backward's launch for the storage type (dtype 0 = float32,
// 1 = bfloat16) and batch: 16 rows a cluster, 32 in bf16 above
// BWD_SPLIT_BATCH (as ops/gru_kernel.py::rows_backward).
template <typename... A>
cudaError_t dispatch_backward(int dtype, int B, A... args) {
  if (dtype == 0) return backward_launch<float, 1>(args...);
  if (dtype != 1) return cudaErrorInvalidValue;
  return B > BWD_SPLIT_BATCH ? backward_launch<__nv_bfloat16, 2>(args...)
                             : backward_launch<__nv_bfloat16, 1>(args...);
}

// Calls fn(T{}, std::integral_constant<int, RB>{}) for the storage type T
// (dtype 0 = float32, 1 = bfloat16) and the batch's rows per group RB.
template <typename F>
cudaError_t dispatch(int dtype, int B, F&& fn) {
  auto rows = [&](auto t) -> cudaError_t {
    switch (rows_per_group(B)) {
      case 1: return fn(t, std::integral_constant<int, 1>{});
      case 2: return fn(t, std::integral_constant<int, 2>{});
      case 4: return fn(t, std::integral_constant<int, 4>{});
      case 8: return fn(t, std::integral_constant<int, 8>{});
      default: return fn(t, std::integral_constant<int, 16>{});
    }
  };
  if (dtype == 0) return rows(float{});
  if (dtype == 1) return rows(__nv_bfloat16{});
  return cudaErrorInvalidValue;
}

// bf16 runs the forward on the tensor cores at every row count, fp32 on
// FFMA
template <typename T, int RB>
cudaError_t forward(const void* xp, const void* h0, const void* w_hh,
                    const void* b_hh, void* out, int n_steps, int B, int H,
                    cudaStream_t stream, int* query) {
  return forward_launch<T, RB, std::is_same<T, __nv_bfloat16>::value>(
      xp, h0, w_hh, b_hh, out, n_steps, B, H, stream, query);
}

bool bad_shape(int n_steps, int B, int H) {
  return n_steps <= 0 || B <= 0 || H <= 0 || cdiv(B, 16) > 65535;
}

}  // namespace

// Plain C entry points, loaded with ctypes.  dtype: 0 = float32,
// 1 = bfloat16.  Each returns the cudaError_t of the launch (0 = success);
// a shape whose shared memory exceeds 227 KB returns cudaErrorInvalidValue.
extern "C" int ha2g_gru_recurrence(const void* xp, const void* h0,
                                   const void* w_hh, const void* b_hh,
                                   void* out, int n_steps, int B, int H,
                                   int dtype, void* stream) {
  if (bad_shape(n_steps, B, H)) return (int)cudaErrorInvalidValue;
  return (int)dispatch(dtype, B, [&](auto t, auto rb) {
    return forward<decltype(t), decltype(rb)::value>(
        xp, h0, w_hh, b_hh, out, n_steps, B, H,
        static_cast<cudaStream_t>(stream), nullptr);
  });
}

// xp, w_hh, d_outs in the storage type; hh, h_prev and the outputs d_gx,
// d_gh (T, 2, B, 3H) and d_h0 (2, B, H) in float32; the inputs 16-byte
// aligned.
extern "C" int ha2g_gru_backward(const void* xp, const void* hh,
                                 const void* h_prev, const void* w_hh,
                                 const void* d_outs, void* d_gx, void* d_gh,
                                 void* d_h0, int n_steps, int B, int H,
                                 int dtype, void* stream) {
  if (bad_shape(n_steps, B, H) || (size_t)n_steps * 2 * B * 3 * H > INT_MAX)
    return (int)cudaErrorInvalidValue;
  for (const void* ptr : {xp, hh, h_prev, w_hh, d_outs})
    if (reinterpret_cast<uintptr_t>(ptr) % 16)
      return (int)cudaErrorMisalignedAddress;
  return (int)dispatch_backward(dtype, B, xp, hh, h_prev, w_hh, d_outs, d_gx, d_gh,
                       d_h0, n_steps, B, H,
                       static_cast<cudaStream_t>(stream), (int*)nullptr);
}

// cudaOccupancyMaxActiveClusters for the launch of one shape: the forward
// (backward == 0) or the backward.  Returns the count, or minus the
// cudaError_t.
extern "C" int ha2g_gru_max_active_clusters(int B, int H, int dtype,
                                            int backward) {
  if (bad_shape(1, B, H)) return -(int)cudaErrorInvalidValue;
  int n = 0;
  const cudaError_t err =
      backward ? dispatch_backward(dtype, B, (const void*)nullptr,
                            (const void*)nullptr, (const void*)nullptr,
                            (const void*)nullptr, (const void*)nullptr,
                            (void*)nullptr, (void*)nullptr, (void*)nullptr, 1,
                            B, H, (cudaStream_t) nullptr, &n)
               : dispatch(dtype, B, [&](auto t, auto rb) {
                   return forward<decltype(t), decltype(rb)::value>(
                       nullptr, nullptr, nullptr, nullptr, nullptr, 1, B, H,
                       nullptr, &n);
                 });
  return err == cudaSuccess ? n : -(int)err;
}

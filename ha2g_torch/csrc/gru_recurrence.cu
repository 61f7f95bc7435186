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
// backward), for one layer and both directions, all math in fp32:
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
// (38 at H = 300, the last slice ragged).  The T loop runs inside the
// cluster; w_hh is read from device memory once per launch per cluster.
// - Forward: CTA k owns the three gate columns {j, H+j, 2H+j : j in J_k}
//   of w_hh (and of b_hh), computes hh for them and all its rows, forms
//   h'[J_k] (no gate crosses CTAs, since a CTA owns whole units) and writes
//   it into every peer's double-buffered copy of h through distributed
//   shared memory; one cluster barrier a step.  bf16: the product is
//   mma.sync m16n8k16 (bf16 in, fp32 accumulate, rows padded to 16) with
//   the w_hh slice held in registers as B fragments for the whole launch
//   and h read from shared memory.  fp32 (no TF32): register-tiled FFMA
//   with the slice in shared memory.
// - Backward: CTA k keeps rows J_k of w_hh (all 3H columns) in shared
//   memory, forms d_gh for its units' three columns, broadcasts it to its
//   peers through distributed shared memory, and after one cluster barrier
//   computes dh[J_k] = g z + sum_c d_gh[c] w_hh[J_k, c] locally (FFMA,
//   fp32: d_gh rounded to bf16 would leave the plain version's tolerance).
//   d_gh is double-buffered where shared memory allows (bf16 at H = 300),
//   else one buffer and a second barrier a step (fp32).
// The next step's inputs are loaded into registers, unconverted, while the
// current step computes.
//
// Bound.  A layer moves ~2.4 MB at the serving shape (T = 34, H = 300,
// B = 8, bf16): under a microsecond of HBM time.  What bounds this design is
// the 34 serial steps: each is one cluster barrier and one exchange of h
// (2 B H bytes) or of d_gh through distributed shared memory, plus the
// step's product on 8 SMs a cluster (the backward's FFMA product, 16 rows
// x 38 units x 900 at B = 96, is its largest part).  The previous design (one
// block per direction and 4 rows, w_hh re-read from L2 every step, 2 SMs
// at B = 1) took 0.40 ms a launch at B = 1 and 0.97 ms at B = 8 and 96 in
// bf16; this design's times are in PERF.md.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
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
// columns, K4 = H4, LN = 32, R <= 8; the backward N = hs units, K4 = G4,
// LN = 8, R <= 4.  mma product (bf16 forward, rows padded to 16): the w_hh
// slice lives in registers as mma B fragments (n-tiles warp and warp + 8,
// up to MMA_KSTEPS k-steps of 16); h is [16][KP], KP = H rounded up to 16,
// plus 8 so that rows of 32-bit words start on banks 4 apart; NP = 3 hs
// rounded up to 8 columns of hh.
constexpr int FWD_LN = 32, FWD_RMAX = 8, FWD_CMAX = 4;   // N <= 128
constexpr int BWD_LN = 8, BWD_RMAX = 4, BWD_CMAX = 5;    // hs <= 40
constexpr int MMA_ROWS = 16, MMA_KSTEPS = 20;           // H <= 320

struct Plan {
  int hs, N, H4, G4, KS, kc, ldw, NP, KP;
};

__host__ __device__ inline Plan make_plan(int H, int RB, bool backward) {
  Plan p;
  p.hs = cdiv(H, CS);
  p.H4 = rup(H, 4);
  p.G4 = rup(3 * H, 4);
  p.N = backward ? p.hs : 3 * p.hs;
  const int ln = backward ? BWD_LN : FWD_LN;
  const int r = min(RB, backward ? BWD_RMAX : FWD_RMAX);
  p.KS = THREADS / (ln * (RB / r));
  const int k4 = backward ? p.G4 : p.H4;
  p.kc = rup(cdiv(k4, p.KS), 4);
  p.ldw = k4 / 4 % 2 ? k4 : k4 + 4;
  p.NP = rup(3 * p.hs, 8);
  p.KP = rup(H, 16) + 8;
  return p;
}

template <typename T, int RB, bool MMA>
size_t forward_smem(int H) {
  const Plan p = make_plan(H, RB, false);
  if (MMA)
    return rup16((size_t)p.NP * 4) + rup16((size_t)2 * MMA_ROWS * p.KP * 2) +
           (size_t)MMA_ROWS * p.NP * 4;
  return rup16((size_t)p.N * p.ldw * sizeof(T)) + rup16((size_t)p.N * 4) +
         rup16((size_t)2 * RB * p.H4 * 4) + (size_t)p.KS * RB * p.N * 4;
}

template <typename T, int RB>
size_t backward_smem(int H, int nbuf) {
  const Plan p = make_plan(H, RB, true);
  return rup16((size_t)p.hs * p.ldw * sizeof(T)) +
         rup16((size_t)nbuf * RB * p.G4 * 4) + (size_t)p.KS * RB * p.hs * 4;
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
  const Plan p = make_plan(H, RB, false);
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

// Backward.  Same grid and clusters as the forward.  nbuf (1 or 2) d_gh
// buffers in shared memory.
template <typename T, int RB>
__global__ void __launch_bounds__(THREADS)
    gru_backward_kernel(const T* __restrict__ xp, const float* __restrict__ hh,
                        const float* __restrict__ h_prev,
                        const T* __restrict__ w_hh,
                        const T* __restrict__ d_outs,
                        float* __restrict__ d_gx, float* __restrict__ d_gh,
                        float* __restrict__ d_h0, int n_steps, int B, int H,
                        int nbuf) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int d = blockIdx.z, row0 = blockIdx.y * RB;
  const int rows = min(RB, B - row0);
  const int G = 3 * H;
  const Plan p = make_plan(H, RB, true);
  const int hs = p.hs, j0 = rank * hs;
  const int nk = max(0, min(H, j0 + hs) - j0);

  extern __shared__ __align__(16) unsigned char smem[];
  T* w_s = reinterpret_cast<T*>(smem);                 // [hs][ldw]
  size_t off = rup16((size_t)hs * p.ldw * sizeof(T));
  float* gb = reinterpret_cast<float*>(smem + off);    // [nbuf][RB][G4]
  off += rup16((size_t)nbuf * RB * p.G4 * 4);
  float* part = reinterpret_cast<float*>(smem + off);  // [KS][RB][hs]

  // w_s[u][c] = w_hh[d][j0 + u][c]
  const T* w = w_hh + (size_t)d * H * G;
  for (int i = tid; i < hs * p.ldw; i += THREADS) {
    const int u = i / p.ldw, c = i - u * p.ldw;
    w_s[i] = (u < nk && c < G) ? w[(size_t)(j0 + u) * G + c]
                               : from_f32<T>(0.0f);
  }
  for (int i = tid; i < nbuf * RB * p.G4; i += THREADS) gb[i] = 0.0f;
  cluster.sync();

  // per item and step: x_r, x_z, x_n, d_out (raw, converted at use, so the
  // loads stay in flight) and hh_r, hh_z, hh_n, h_prev
  T v[MAX_ITEMS][4], vn[MAX_ITEMS][4];
  float f[MAX_ITEMS][4], fn[MAX_ITEMS][4], gz[MAX_ITEMS];
  auto load_v = [&](T (&dst)[MAX_ITEMS][4], float (&dstf)[MAX_ITEMS][4],
                    int t) {
#pragma unroll
    for (int s = 0; s < MAX_ITEMS; ++s) {
      const int i = tid + s * THREADS, r = i / hs, u = i - r * hs;
      if (r < rows && u < nk) {
        const size_t row = ((size_t)t * 2 + d) * B + row0 + r;
        const T* xr = xp + row * G + j0 + u;
        const float* hr = hh + row * G + j0 + u;
        dst[s][0] = xr[0];
        dst[s][1] = xr[H];
        dst[s][2] = xr[2 * H];
        dst[s][3] = d_outs[row * H + j0 + u];
        dstf[s][0] = hr[0];
        dstf[s][1] = hr[H];
        dstf[s][2] = hr[2 * H];
        dstf[s][3] = h_prev[row * H + j0 + u];
      }
    }
  };
  load_v(v, f, n_steps - 1);

  for (int step = 0; step < n_steps; ++step) {
    const int t = n_steps - 1 - step;
    float* g_buf = gb + (size_t)(nbuf == 2 ? step & 1 : 0) * RB * p.G4;
    if (t > 0) load_v(vn, fn, t - 1);
#pragma unroll
    for (int s = 0; s < MAX_ITEMS; ++s) {
      const int i = tid + s * THREADS, r = i / hs, u = i - r * hs;
      if (r < rows && u < nk) {
        float dh = 0.0f;
        if (step > 0) {
          dh = gz[s];
          for (int ks = 0; ks < p.KS; ++ks) dh += part[(ks * RB + r) * hs + u];
        }
        const float g = dh + to_f32(v[s][3]);
        const float rg = sigmoid_f32(to_f32(v[s][0]) + f[s][0]);
        const float zg = sigmoid_f32(to_f32(v[s][1]) + f[s][1]);
        const float h_n = f[s][2];
        const float ng = tanhf(to_f32(v[s][2]) + rg * h_n);
        const float f_n = (1.0f - zg) * (1.0f - ng * ng);
        const float f_z = (f[s][3] - ng) * zg * (1.0f - zg);
        const float f_r = f_n * h_n * rg * (1.0f - rg);
        const float dr = g * f_r, dz = g * f_z, dn = g * f_n;
        const size_t base = (((size_t)t * 2 + d) * B + row0 + r) * G + j0 + u;
        d_gx[base] = dr;
        d_gx[base + H] = dz;
        d_gx[base + 2 * H] = dn;
        d_gh[base] = dr;
        d_gh[base + H] = dz;
        d_gh[base + 2 * H] = dn * rg;
        gz[s] = g * zg;
#pragma unroll
        for (int q = 0; q < CS; ++q) {
          float* dst = cluster.map_shared_rank(g_buf, q) + r * p.G4 + j0 + u;
          dst[0] = dr;
          dst[H] = dz;
          dst[2 * H] = dn * rg;
        }
      }
    }
    cluster.sync();
    ffma_tile<T, RB, (RB < BWD_RMAX ? RB : BWD_RMAX), BWD_LN, BWD_CMAX>(
        g_buf, p.G4, w_s, p.ldw, hs, p.G4, p.kc, part);
    if (nbuf == 1)
      cluster.sync();   // peers write the one buffer again next step
    else
      __syncthreads();
#pragma unroll
    for (int s = 0; s < MAX_ITEMS; ++s)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[s][k] = vn[s][k];
        f[s][k] = fn[s][k];
      }
  }
#pragma unroll
  for (int s = 0; s < MAX_ITEMS; ++s) {
    const int i = tid + s * THREADS, r = i / hs, u = i - r * hs;
    if (r < rows && u < nk) {
      float dh = gz[s];
      for (int ks = 0; ks < p.KS; ++ks) dh += part[(ks * RB + r) * hs + u];
      d_h0[((size_t)d * B + row0 + r) * H + j0 + u] = dh;
    }
  }
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

template <typename T, int RB>
cudaError_t backward_launch(const void* xp, const void* hh,
                            const void* h_prev, const void* w_hh,
                            const void* d_outs, void* d_gx, void* d_gh,
                            void* d_h0, int n_steps, int B, int H,
                            cudaStream_t stream, int* query) {
  // two d_gh buffers (one barrier a step) where they fit, else one
  int nbuf = 2;
  size_t smem = backward_smem<T, RB>(H, 2);
  if (smem > SMEM_LIMIT) {
    nbuf = 1;
    smem = backward_smem<T, RB>(H, 1);
  }
  if (smem > SMEM_LIMIT || RB * cdiv(H, CS) > MAX_ITEMS * THREADS ||
      cdiv(H, CS) > BWD_LN * BWD_CMAX)
    return cudaErrorInvalidValue;
  auto kernel = gru_backward_kernel<T, RB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(B, RB, smem, stream, &attr);
  if (query) return cudaOccupancyMaxActiveClusters(query, kernel, &cfg);
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(xp), static_cast<const float*>(hh),
      static_cast<const float*>(h_prev), static_cast<const T*>(w_hh),
      static_cast<const T*>(d_outs), static_cast<float*>(d_gx),
      static_cast<float*>(d_gh), static_cast<float*>(d_h0), n_steps, B, H,
      nbuf);
  return err != cudaSuccess ? err : cudaGetLastError();
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
// d_gh (T, 2, B, 3H) and d_h0 (2, B, H) in float32.
extern "C" int ha2g_gru_backward(const void* xp, const void* hh,
                                 const void* h_prev, const void* w_hh,
                                 const void* d_outs, void* d_gx, void* d_gh,
                                 void* d_h0, int n_steps, int B, int H,
                                 int dtype, void* stream) {
  if (bad_shape(n_steps, B, H)) return (int)cudaErrorInvalidValue;
  return (int)dispatch(dtype, B, [&](auto t, auto rb) {
    return backward_launch<decltype(t), decltype(rb)::value>(
        xp, hh, h_prev, w_hh, d_outs, d_gx, d_gh, d_h0, n_steps, B, H,
        static_cast<cudaStream_t>(stream), nullptr);
  });
}

// cudaOccupancyMaxActiveClusters for the launch of one shape: the forward
// (backward == 0) or the backward.  Returns the count, or minus the
// cudaError_t.
extern "C" int ha2g_gru_max_active_clusters(int B, int H, int dtype,
                                            int backward) {
  if (bad_shape(1, B, H)) return -(int)cudaErrorInvalidValue;
  int n = 0;
  const cudaError_t err = dispatch(dtype, B, [&](auto t, auto rb) {
    using T = decltype(t);
    constexpr int RB = decltype(rb)::value;
    return backward ? backward_launch<T, RB>(nullptr, nullptr, nullptr,
                                             nullptr, nullptr, nullptr,
                                             nullptr, nullptr, 1, B, H,
                                             nullptr, &n)
                    : forward<T, RB>(nullptr, nullptr, nullptr, nullptr,
                                     nullptr, 1, B, H, nullptr, &n);
  });
  return err == cudaSuccess ? n : -(int)err;
}

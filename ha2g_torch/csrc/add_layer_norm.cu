// The denoiser's residual add and the layer norm after it, in one pass.
//
// add_layer_norm_kernel computes, for each row r of h (rows x width) and
// the row of d that r reads (r mod d_rows: d is h's shape, or the (L,
// width) positional table broadcast over the rows),
//     s = round(float(h) + float(d))          (the add in the tensors' type)
//     y = round(weight * (rstd * (s - mean)) + bias)
// with mean, the variance and rstd = rsqrt(var + eps) in float32 over the
// rounded s, and writes s (unless its pointer is null) and y.
//
// It replaces no TPU kernel: DiffGesture's denoiser has no JAX
// counterpart.  It was added because the denoiser called a library layer
// norm and a separate bf16 add 17 times a pass: the add wrote s, the norm
// read it back.  The pass is bound by bytes: at the benchmark's shape
// (4,352 rows of 512 in bf16) it reads h and d and writes s and y, 17.8 MB,
// 5.3 us at 3.35 TB/s, against 2 x 8.9 MB for the two library kernels.
// What the design does about that:
//   * one warp a row, four rows a block: 4,352 rows are 1,088 blocks;
//   * 16-byte loads and stores (8 bf16 or 4 float32 a lane), each input
//     read once and each output written once; h and d are loaded before
//     any arithmetic, so a warp waits once for its row;
//   * the row stays in registers as the rounded sums, packed as stored
//     (width / 64 registers a lane in bf16), so the statistics take two
//     passes over registers and two warp reductions, never a second read
//     of memory;
//   * weight and bias (L2 hits) are loaded after the statistics, not
//     beside the row: a thread then needs 38 registers (bf16, width 512),
//     so all 1,088 blocks are resident at once; holding them beside the
//     row in float took 72 registers, 7 blocks a SM (924 at once), and a
//     launch 17% longer over operands that L2 cannot hold.
//
// Built by ha2g_torch/kernels.py (nvcc, plain C interface, ctypes); the
// wrapper and the plain PyTorch version are ha2g_torch/ops/add_norm.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 4;   // one warp a row

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// K: the 16-byte pieces each lane holds, ceil(width / (V * 32)) rounded up
// to 1, 2 or 4 (fewer instantiations: a shorter build).
template <typename T, int K>
__global__ void __launch_bounds__(kRowsPerBlock * kWarp)
add_layer_norm_kernel(const T* __restrict__ h, const T* __restrict__ d,
                      const T* __restrict__ weight,
                      const T* __restrict__ bias, T* __restrict__ sum,
                      T* __restrict__ y, int rows, int d_rows, int width,
                      float eps) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;
  const int pieces = width / V;
  const uint4* hp = reinterpret_cast<const uint4*>(h + (size_t)row * width);
  const uint4* dp =
      reinterpret_cast<const uint4*>(d + (size_t)(row % d_rows) * width);

  const uint4* wp = reinterpret_cast<const uint4*>(weight);
  const uint4* bp = reinterpret_cast<const uint4*>(bias);
  uint4 hv[K], dv[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = lane + k * kWarp;
    if (p < pieces) {
      hv[k] = hp[p];
      dv[k] = dp[p];
    } else {
      hv[k] = dv[k] = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // the rounded sums, packed as stored (zero in a lane's idle pieces)
  uint4 sv[K];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const T* a = reinterpret_cast<const T*>(&hv[k]);
    const T* b = reinterpret_cast<const T*>(&dv[k]);
    T* o = reinterpret_cast<T*>(&sv[k]);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      o[j] = Elem<T>::store(Elem<T>::load(a[j]) + Elem<T>::load(b[j]));
      s += Elem<T>::load(o[j]);
    }
    const int p = lane + k * kWarp;
    if (sum != nullptr && p < pieces)
      reinterpret_cast<uint4*>(sum + (size_t)row * width)[p] = sv[k];
  }
  const float mean = warp_sum(s) / width;

  float q = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (lane + k * kWarp < pieces) {
      const T* o = reinterpret_cast<const T*>(&sv[k]);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float c = Elem<T>::load(o[j]) - mean;
        q += c * c;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / width + eps);

  uint4* yp = reinterpret_cast<uint4*>(y + (size_t)row * width);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = lane + k * kWarp;
    if (p < pieces) {
      const uint4 wv = wp[p], bv = bp[p];
      const T* wt = reinterpret_cast<const T*>(&wv);
      const T* bt = reinterpret_cast<const T*>(&bv);
      const T* x = reinterpret_cast<const T*>(&sv[k]);
      uint4 out;
      T* o = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = Elem<T>::store(Elem<T>::load(wt[j]) *
                                  (rstd * (Elem<T>::load(x[j]) - mean)) +
                              Elem<T>::load(bt[j]));
      yp[p] = out;
    }
  }
}

template <typename T>
cudaError_t launch(const void* h, const void* d, const void* weight,
                   const void* bias, void* sum, void* y, int rows,
                   int d_rows, int width, float eps, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int per_lane = (width / V + kWarp - 1) / kWarp;
  const dim3 grid((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  const dim3 block(kRowsPerBlock * kWarp);
  const T* hh = static_cast<const T*>(h);
  const T* dd = static_cast<const T*>(d);
  const T* ww = static_cast<const T*>(weight);
  const T* bb = static_cast<const T*>(bias);
  T* ss = static_cast<T*>(sum);
  T* yy = static_cast<T*>(y);
  switch (per_lane) {
    case 1:
      add_layer_norm_kernel<T, 1><<<grid, block, 0, stream>>>(
          hh, dd, ww, bb, ss, yy, rows, d_rows, width, eps);
      break;
    case 2:
      add_layer_norm_kernel<T, 2><<<grid, block, 0, stream>>>(
          hh, dd, ww, bb, ss, yy, rows, d_rows, width, eps);
      break;
    case 3:
    case 4:
      add_layer_norm_kernel<T, 4><<<grid, block, 0, stream>>>(
          hh, dd, ww, bb, ss, yy, rows, d_rows, width, eps);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  Every pointer 16-byte aligned,
// width a multiple of 16 bytes, rows a multiple of d_rows; sum may be null.
// Returns the launch's CUDA error (0 on success).
int ha2g_add_layer_norm(int dtype, const void* h, const void* d,
                        const void* weight, const void* bias, void* sum,
                        void* y, int rows, int d_rows, int width, float eps,
                        void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(h, d, weight, bias, sum, y, rows, d_rows, width,
                           eps, s);
    case 1:
      return launch<__nv_bfloat16>(h, d, weight, bias, sum, y, rows, d_rows,
                                   width, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"

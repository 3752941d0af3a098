// The pose cotangent of a rigid transform applied to one point set that the
// whole batch shares, behind a plain C interface loaded with ctypes.
//
//   rays_adjoint  replaces no TPU kernel: the JAX package leaves this product
//                 to XLA. Detector.rays maps the detector's N pixel centres q
//                 (N, 3) by every pose of a batch, x[b] = q R[b]^T + t[b]
//                 (geometry/se3.py transform_shared), and the registrar's
//                 gradient runs back through it. Given the cotangent
//                 g (B, N, 3) of x, the pose's is
//                   dR[b] = sum_n g[b, n, :] (x) q[n, :],  dt[b] = sum_n g[b, n, :],
//                 twelve sums a pose over every ray. Autograd ran them as a
//                 batched GEMM [B, 3, N] x [B, N, 3]: cuBLAS gave each pose
//                 one 32x32 tile that walked the N-deep product alone.
//
// Bound on the H100: bytes, B N 3 + N 3 floats read once (3.4 MB at the fine
// stage's B = 4, 239^2, about 1 us). So the work is split over the points:
// a block owns CHUNK consecutive points of one pose (grid: blocks over N, B),
// each thread keeps the twelve sums of its PER_THREAD points, then the warp
// adds them by shuffles and the block its warps in warp order, into one
// partial per block. rays_adjoint_sum_kernel adds a pose's partials in block
// order and writes its (4, 4) cotangent, bottom row 0. Products and sums are
// in double: the rays' cotangents are signed and cancel across the detector.
// The split depends on N alone and no atomics are used, so two calls give
// identical bits, on any card.
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int CHUNK = THREADS * PER_THREAD;  // points per block
constexpr int NSUM = 12;                      // dR row-major (9), then dt (3)

template <typename T>
__global__ void __launch_bounds__(THREADS)
    rays_adjoint_kernel(const T* __restrict__ g, const T* __restrict__ q, int N,
                        double* __restrict__ part) {
  const int b = blockIdx.y, tid = threadIdx.x;
  const T* gb = g + (size_t)b * N * 3;
  double s[NSUM];
#pragma unroll
  for (int k = 0; k < NSUM; ++k) s[k] = 0.0;
#pragma unroll
  for (int p = 0; p < PER_THREAD; ++p) {
    const int n = blockIdx.x * CHUNK + p * THREADS + tid;
    if (n < N) {
      double gi[3], qj[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        gi[c] = (double)gb[(size_t)n * 3 + c];
        qj[c] = (double)q[(size_t)n * 3 + c];
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) s[3 * i + j] += gi[i] * qj[j];
        s[9 + i] += gi[i];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NSUM; ++k)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s[k] += __shfl_down_sync(0xffffffffu, s[k], off);
  __shared__ double red[THREADS / 32][NSUM];
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NSUM; ++k) red[warp][k] = s[k];
  }
  __syncthreads();
  if (tid < NSUM) {
    double t = 0.0;
    for (int w = 0; w < THREADS / 32; ++w) t += red[w][tid];
    part[((size_t)b * NSUM + tid) * gridDim.x + blockIdx.x] = t;
  }
}

// out (B, 4, 4): [dR | dt] over a zero bottom row, each entry the sum of
// its nblk partials in block order.
template <typename T>
__global__ void rays_adjoint_sum_kernel(const double* __restrict__ part, int nblk, int B,
                                        T* __restrict__ out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= B * 16) return;
  const int b = r / 16, i = (r % 16) / 4, j = r % 4;
  double s = 0.0;
  if (i < 3) {
    const double* p = part + ((size_t)b * NSUM + (j < 3 ? 3 * i + j : 9 + i)) * nblk;
    for (int t = 0; t < nblk; ++t) s += p[t];
  }
  out[r] = (T)s;
}

template <typename T>
int launch(const void* g, const void* q, void* part, void* out, int B, int N, cudaStream_t st) {
  const int nblk = (N + CHUNK - 1) / CHUNK;
  rays_adjoint_kernel<T><<<dim3(nblk, B), THREADS, 0, st>>>((const T*)g, (const T*)q, N,
                                                            (double*)part);
  int err = (int)cudaGetLastError();
  if (err) return err;
  rays_adjoint_sum_kernel<T><<<(B * 16 + 255) / 256, 256, 0, st>>>((const double*)part, nblk, B,
                                                                  (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks per pose, the partials' last extent: part is (B, 12, blocks) float64.
int rays_adjoint_blocks(int N) { return (N + CHUNK - 1) / CHUNK; }

// g (B, N, 3), q (N, 3) -> out (B, 4, 4), all float32 (f64 = 0) or float64.
int rays_adjoint(const void* g, const void* q, void* part, void* out, int B, int N, int f64,
                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return f64 ? launch<double>(g, q, part, out, B, N, st) : launch<float>(g, q, part, out, B, N, st);
}

}  // extern "C"

// Shear-warp DRR kernels for Hopper (sm_90a): the four kernels of the
// registration path, behind a plain C interface loaded with ctypes.
//
//   K1 sw_accumulate          replaces _acc_kernel    (xvr_tpu/render/shearwarp.py:222)
//   K2 sw_warp                replaces _warp_kernel   (xvr_tpu/render/shearwarp.py:368)
//   K3 sw_warp_grads          replaces _warp_grads_kernel (xvr_tpu/render/shearwarp.py:400)
//   K4 sw_accumulate_adjoint  replaces _adj_kernel    (xvr_tpu/render/shearwarp.py:955)
//
// The TPU kernels build dense hat matrices and feed them to the MXU. The hat
// profile hat_eps(x) = clip(((1 + eps)/2 - |x|)/eps, 0, 1) has support
// half-width (1 + eps)/2 <= 1, so for every slab a slope-grid row touches at
// most two voxels along the window axis and a column at most two along the
// lane axis: the dense products are almost all zeros. These kernels evaluate
// the band directly, one thread per output element, in f32 from the bf16
// volume (K4 keeps its sums in double). No tensor cores, TMA or wgmma yet:
// the first version is the simple one, and its times on the H100 are
// recorded in PERF.md.
//
// Every entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float hat_eps(float x, float eps) {
  float h = ((1.0f + eps) * 0.5f - fabsf(x)) / eps;
  return fminf(fmaxf(h, 0.0f), 1.0f);
}

// d hat/dx: -sign(x)/eps on the ramps (1 - eps)/2 < |x| < (1 + eps)/2.
__device__ __forceinline__ float hat_prime(float x, float eps) {
  float ax = fabsf(x);
  bool ramp = (ax > (1.0f - eps) * 0.5f) && (ax < (1.0f + eps) * 0.5f);
  float sg = (x > 0.0f) ? 1.0f : ((x < 0.0f) ? -1.0f : 0.0f);
  return ramp ? -sg / eps : 0.0f;
}

struct SlabParams {
  float s0, s1, s2, sgn, u0, du, v0, dv;
};

// Sample positions are rounded op by op (no fused multiply-add), as the plain
// PyTorch versions compute them: hat' is discontinuous, so a position one ulp
// off can flip a tap of the adjoint. The checks hold K4 to its plain version
// on that basis.
__device__ __forceinline__ float affine_rn(float a, float b, float x) {  // a + b * x
  return __fadd_rn(a, __fmul_rn(b, x));
}

__device__ __forceinline__ SlabParams load_params(const float* __restrict__ params, int b) {
  const float* p = params + 8 * b;
  return {p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7]};
}

// ---------------------------------------------------------------------------
// K1: I[b, i, j] = sum_k w_k sum_{w,l} hat(wpos - w) hat(lpos - l) S_k[w, l]
//     wpos = s1 + (k - s0) (u0 + du i),  lpos = s2 + (k - s0) (v0 + dv j)
//     w_k = clip(sgn (k - s0) + 0.5, 0, 1)
// Bound on the H100: bytes. The roofline time is that of reading the bf16
// volume once (33.5 MB at 256^3, ~10 us); the band's ~8 FLOP per sample are
// below it. This simple version runs far above that bound, most likely on
// the per-thread gather of 4 bf16 taps per slab, served from L2 (the volume
// fits in its 50 MB). The design keeps threadIdx.x on the lane-axis output
// j, so a warp's taps fall on one or two volume rows and coalesce, and it
// skips whole slabs behind the source (w_k == 0) uniformly per image.
// ---------------------------------------------------------------------------
__global__ void sw_accumulate_kernel(const __nv_bfloat16* __restrict__ vol, int Wd, int L,
                                     const float* __restrict__ params, float* __restrict__ out,
                                     int Iu, int Iv, float eps, int k0, int k1) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (i >= Iu || j >= Iv) return;
  const SlabParams p = load_params(params, b);
  const float u = affine_rn(p.u0, p.du, (float)i);
  const float v = affine_rn(p.v0, p.dv, (float)j);
  float acc = 0.0f;
  for (int k = k0; k < k1; ++k) {
    const float c = __fsub_rn((float)k, p.s0);
    const float wk = fminf(fmaxf(affine_rn(0.5f, p.sgn, c), 0.0f), 1.0f);
    if (wk == 0.0f) continue;
    const float wpos = affine_rn(p.s1, c, u);
    const float lpos = affine_rn(p.s2, c, v);
    const float wf = floorf(wpos), lf = floorf(lpos);
    if (wf < -1.0f || wf >= (float)Wd || lf < -1.0f || lf >= (float)L) continue;
    const int w0 = (int)wf, l0 = (int)lf;
    const float fw = wpos - wf, fl = lpos - lf;
    const float hw0 = hat_eps(fw, eps), hw1 = hat_eps(fw - 1.0f, eps);
    const float hl0 = hat_eps(fl, eps), hl1 = hat_eps(fl - 1.0f, eps);
    const __nv_bfloat16* slab = vol + (size_t)k * Wd * L;
    float s = 0.0f;
    if (w0 >= 0) {
      const __nv_bfloat16* row = slab + (size_t)w0 * L;
      float r = 0.0f;
      if (l0 >= 0) r += hl0 * __bfloat162float(row[l0]);
      if (l0 + 1 < L) r += hl1 * __bfloat162float(row[l0 + 1]);
      s += hw0 * r;
    }
    if (w0 + 1 < Wd) {
      const __nv_bfloat16* row = slab + (size_t)(w0 + 1) * L;
      float r = 0.0f;
      if (l0 >= 0) r += hl0 * __bfloat162float(row[l0]);
      if (l0 + 1 < L) r += hl1 * __bfloat162float(row[l0 + 1]);
      s += hw1 * r;
    }
    acc += wk * s;
  }
  out[((size_t)b * Iu + i) * Iv + j] = acc;
}

// ---------------------------------------------------------------------------
// K2/K3: bilinear sample of the slope image at (uc, vc). A sample is valid
// only when -1 < uc < Iu, 0 <= vc <= Iv - 1 and ws > 0. Rows z in
// {floor(uc), floor(uc) + 1} inside [0, Iu) carry the tent weight
// max(1 - |uc - z|, 0); the lane index is clipped to [0, Iv - 2] and its
// fraction to [0, 1], as in the TPU kernel.
// Bound on the H100: bytes. Each pixel reads 3 (K2) f32 fields and 4 image
// values and writes 1 (K3: 3) f32; one thread per pixel with consecutive
// pixels on consecutive threads keeps the field reads and the writes
// coalesced, and the image (<= 1 MB per pose) stays in L2.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void warp_sample(const float* __restrict__ Ib, int Iu, int Iv, float u,
                                            float v, float* val, float* dval_du,
                                            float* dval_dv) {
  int idx = (int)v;  // v >= 0 here, so truncation is floor
  const int idx_max = Iv > 1 ? Iv - 2 : 0;
  idx = min(max(idx, 0), idx_max);
  const int idx_hi = min(idx + 1, Iv - 1);
  const float fx = fminf(fmaxf(v - (float)idx, 0.0f), 1.0f);
  const float zf = floorf(u);
  const int z0 = (int)zf;
  float acc = 0.0f, dua = 0.0f, dva = 0.0f;
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const int z = z0 + d;
    if (z < 0 || z >= Iu) continue;
    const float diff = u - (float)z;
    const float wz = fmaxf(1.0f - fabsf(diff), 0.0f);
    const float dz = (fabsf(diff) < 1.0f) ? ((diff > 0.0f) ? -1.0f : ((diff < 0.0f) ? 1.0f : 0.0f)) : 0.0f;
    const float lo = Ib[(size_t)z * Iv + idx];
    const float hi = Ib[(size_t)z * Iv + idx_hi];
    const float val_z = lo + fx * (hi - lo);
    acc += wz * val_z;
    dua += dz * val_z;
    dva += wz * (hi - lo);
  }
  *val = acc;
  if (dval_du) *dval_du = dua;
  if (dval_dv) *dval_dv = dva;
}

__device__ __forceinline__ bool warp_valid(float u, float v, float w, int Iu, int Iv) {
  return (u > -1.0f) && (u < (float)Iu) && (v >= 0.0f) && (v <= (float)(Iv - 1)) && (w > 0.0f);
}

__global__ void sw_warp_kernel(const float* __restrict__ I, const float* __restrict__ uc,
                               const float* __restrict__ vc, const float* __restrict__ ws,
                               float* __restrict__ out, int Iu, int Iv, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (r >= R) return;
  const size_t o = (size_t)b * R + r;
  const float u = uc[o], v = vc[o], w = ws[o];
  float res = 0.0f;
  if (warp_valid(u, v, w, Iu, Iv)) {
    float val;
    warp_sample(I + (size_t)b * Iu * Iv, Iu, Iv, u, v, &val, nullptr, nullptr);
    res = val * w;
  }
  out[o] = res;
}

__global__ void sw_warp_grads_kernel(const float* __restrict__ I, const float* __restrict__ uc,
                                     const float* __restrict__ vc, const float* __restrict__ ws,
                                     float* __restrict__ out, float* __restrict__ dout_du,
                                     float* __restrict__ dout_dv, int Iu, int Iv, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (r >= R) return;
  const size_t o = (size_t)b * R + r;
  const float u = uc[o], v = vc[o], w = ws[o];
  float val = 0.0f, du = 0.0f, dv = 0.0f;
  if (warp_valid(u, v, w, Iu, Iv)) {
    warp_sample(I + (size_t)b * Iu * Iv, Iu, Iv, u, v, &val, &du, &dv);
  }
  out[o] = val;
  dout_du[o] = du;
  dout_dv[o] = dv;
}

// ---------------------------------------------------------------------------
// K4: adjoint of K1 with respect to the source position.
//   gw[b, i] = sum_k w_k sum_j Ibar[i, j] sum_{w,l} hat'(wpos - w) hat(lpos - l) S_k[w, l]
//   gl[b, j] = sum_k w_k sum_i Ibar[i, j] sum_{w,l} hat(wpos - w) hat'(lpos - l) S_k[w, l]
// One thread per (b, i, j) walks the same band as K1 and keeps both partial
// sums in registers; a block then reduces gw over its j range and gl over its
// i range in shared memory and writes one partial per block (no atomics, so
// the result does not depend on block order). A second small kernel sums the
// partials over the block axis. The terms are signed and cancel heavily, so
// every sum past the 4-tap slab sample runs in double (one add per slab per
// thread: cheap beside the gathers). Bound on the H100: operations (~16 f32
// FLOP per sample, just above the volume's read time); as for K1, the
// per-thread gather is the likely limit of this simple version.
// ---------------------------------------------------------------------------
constexpr int ADJ_BX = 32;
constexpr int ADJ_BY = 8;

__global__ void sw_adjoint_kernel(const __nv_bfloat16* __restrict__ vol, int Wd, int L,
                                  const float* __restrict__ params,
                                  const __nv_bfloat16* __restrict__ ibar, int Iu, int Iv,
                                  float eps, int k0, int k1, double* __restrict__ part_gw,
                                  double* __restrict__ part_gl) {
  __shared__ double sh_w[ADJ_BY][ADJ_BX + 1];
  __shared__ double sh_l[ADJ_BY][ADJ_BX + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * ADJ_BX + tx;
  const int i = blockIdx.y * ADJ_BY + ty;
  const int b = blockIdx.z;
  double gw = 0.0, gl = 0.0;
  if (i < Iu && j < Iv) {
    const float ib = __bfloat162float(ibar[((size_t)b * Iu + i) * Iv + j]);
    if (ib != 0.0f) {
      const SlabParams p = load_params(params, b);
      const float u = affine_rn(p.u0, p.du, (float)i);
      const float v = affine_rn(p.v0, p.dv, (float)j);
      for (int k = k0; k < k1; ++k) {
        const float c = __fsub_rn((float)k, p.s0);
        const float wk = fminf(fmaxf(affine_rn(0.5f, p.sgn, c), 0.0f), 1.0f);
        if (wk == 0.0f) continue;
        const float wpos = affine_rn(p.s1, c, u);
        const float lpos = affine_rn(p.s2, c, v);
        const float wf = floorf(wpos), lf = floorf(lpos);
        if (wf < -1.0f || wf >= (float)Wd || lf < -1.0f || lf >= (float)L) continue;
        const int w0 = (int)wf, l0 = (int)lf;
        const float fw = wpos - wf, fl = lpos - lf;
        const float hw[2] = {hat_eps(fw, eps), hat_eps(fw - 1.0f, eps)};
        const float hwp[2] = {hat_prime(fw, eps), hat_prime(fw - 1.0f, eps)};
        const float hl[2] = {hat_eps(fl, eps), hat_eps(fl - 1.0f, eps)};
        const float hlp[2] = {hat_prime(fl, eps), hat_prime(fl - 1.0f, eps)};
        const __nv_bfloat16* slab = vol + (size_t)k * Wd * L;
        float sa = 0.0f, sb = 0.0f;
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const int w = w0 + a;
          if (w < 0 || w >= Wd) continue;
          const __nv_bfloat16* row = slab + (size_t)w * L;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int l = l0 + e;
            if (l < 0 || l >= L) continue;
            const float s = __bfloat162float(row[l]);
            sa += hwp[a] * hl[e] * s;
            sb += hw[a] * hlp[e] * s;
          }
        }
        gw += (double)(wk * sa);
        gl += (double)(wk * sb);
      }
      gw *= (double)ib;
      gl *= (double)ib;
    }
  }
  sh_w[ty][tx] = gw;
  sh_l[ty][tx] = gl;
  __syncthreads();
  const int nbx = gridDim.x, nby = gridDim.y;
  if (tx == 0 && i < Iu) {
    double s = 0.0;
    for (int t = 0; t < ADJ_BX; ++t) s += sh_w[ty][t];
    part_gw[((size_t)b * Iu + i) * nbx + blockIdx.x] = s;
  }
  if (ty == 0 && j < Iv) {
    double s = 0.0;
    for (int t = 0; t < ADJ_BY; ++t) s += sh_l[t][tx];
    part_gl[((size_t)b * Iv + j) * nby + blockIdx.y] = s;
  }
}

// out[r] = sum_t part[r, t] for n rows of nt partials.
__global__ void sw_sum_partials_kernel(const double* __restrict__ part, float* __restrict__ out,
                                       int n, int nt) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  double s = 0.0;
  for (int t = 0; t < nt; ++t) s += part[(size_t)r * nt + t];
  out[r] = (float)s;
}

}  // namespace

extern "C" {

int sw_accumulate(const void* vol, int Wd, int L, const void* params, void* out, int B, int Iu,
                  int Iv, float eps, int k0, int k1, void* stream) {
  dim3 block(32, 8);
  dim3 grid((Iv + 31) / 32, (Iu + 7) / 8, B);
  sw_accumulate_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)vol, Wd, L, (const float*)params, (float*)out, Iu, Iv, eps, k0, k1);
  return (int)cudaGetLastError();
}

int sw_warp(const void* I, const void* uc, const void* vc, const void* ws, void* out, int B, int Iu,
            int Iv, int R, void* stream) {
  dim3 block(256);
  dim3 grid((R + 255) / 256, B);
  sw_warp_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)I, (const float*)uc, (const float*)vc, (const float*)ws, (float*)out, Iu, Iv,
      R);
  return (int)cudaGetLastError();
}

int sw_warp_grads(const void* I, const void* uc, const void* vc, const void* ws, void* out,
                  void* dout_du, void* dout_dv, int B, int Iu, int Iv, int R, void* stream) {
  dim3 block(256);
  dim3 grid((R + 255) / 256, B);
  sw_warp_grads_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)I, (const float*)uc, (const float*)vc, (const float*)ws, (float*)out,
      (float*)dout_du, (float*)dout_dv, Iu, Iv, R);
  return (int)cudaGetLastError();
}

// Partials scratch (float64): part_gw (B, Iu, ceil(Iv/32)), part_gl (B, Iv, ceil(Iu/8)).
int sw_adjoint_partials_shape(int Iu, int Iv, int* nbx, int* nby) {
  *nbx = (Iv + ADJ_BX - 1) / ADJ_BX;
  *nby = (Iu + ADJ_BY - 1) / ADJ_BY;
  return 0;
}

int sw_accumulate_adjoint(const void* vol, int Wd, int L, const void* params, const void* ibar,
                          void* part_gw, void* part_gl, void* gw, void* gl, int B, int Iu, int Iv,
                          float eps, int k0, int k1, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 block(ADJ_BX, ADJ_BY);
  dim3 grid((Iv + ADJ_BX - 1) / ADJ_BX, (Iu + ADJ_BY - 1) / ADJ_BY, B);
  sw_adjoint_kernel<<<grid, block, 0, st>>>((const __nv_bfloat16*)vol, Wd, L, (const float*)params,
                                            (const __nv_bfloat16*)ibar, Iu, Iv, eps, k0, k1,
                                            (double*)part_gw, (double*)part_gl);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int nw = B * Iu, nl = B * Iv;
  sw_sum_partials_kernel<<<(nw + 255) / 256, 256, 0, st>>>((const double*)part_gw, (float*)gw, nw,
                                                          (int)grid.x);
  err = (int)cudaGetLastError();
  if (err) return err;
  sw_sum_partials_kernel<<<(nl + 255) / 256, 256, 0, st>>>((const double*)part_gl, (float*)gl, nl,
                                                          (int)grid.y);
  return (int)cudaGetLastError();
}

}  // extern "C"

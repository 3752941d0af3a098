// Slab-march DRR kernels for Hopper (sm_90a): the four kernels of the
// slab renderer, behind a plain C interface loaded with ctypes.
//
//   K5 slab_forward   replaces _kernel          (xvr_tpu/render/pallas.py:92)
//   K6 slab_backward  replaces _kernel_bwd      (xvr_tpu/render/pallas.py:485)
//   K7 slab_channels  replaces _kernel_channels (xvr_tpu/render/pallas.py:324)
//   K8 slab_siddon    replaces _kernel_siddon   (xvr_tpu/render/pallas.py:200)
//
// A ray s + alpha d (alpha in [0, 1], voxel coordinates permuted to march,
// window, lane) is integrated at its crossings with the M march planes
// k = 0 .. M-1. At plane k the sample sits at (k, p1, p2) with
// alpha = (k - s0) / d0, so the interpolation is bilinear in the window (p1)
// and lane (p2) axes. The slab around each plane is trimmed to the ray's
// box entry/exit [a_in, a_out] by the midpoint rule, and the sum is scaled by
// the ray's ws = |ray| / |d0|.
//
// The TPU kernels tile the detector into 8 x 128 blocks, keep a bf16-pair
// packed volume in VMEM and gather a static window of volume rows per block.
// Here the volume is the plain (M, Wd, L) bf16 tensor that the shear-warp
// kernels read as well: it stays whole in device memory (33.5 MB at 256^3,
// inside the 50 MB L2), so there is no window, no pair packing and no
// streaming. Each kernel runs one thread per ray with a loop over the march
// planes; consecutive rays (detector columns, which the permutation puts
// along the lane axis) sit on consecutive threads, so a warp's taps fall on
// one or two volume rows. No shared memory, TMA or tensor cores yet: this
// first version is the simple one, and its times on the H100 are recorded in
// PERF.md.
//
// Bound on the H100: the least bytes are the bf16 volume read once (33.5 MB,
// ~10 us at 3.35 TB/s) plus the f32 fields and outputs; the operations are
// 37 (K5), 121 (K6), 40 (K7) and 48 (K8) per evaluated (ray, plane) pair.
// At the fine stage (4 x 239^2 rays, ~58M pairs) the operations bound all
// four (30-90 us at 67 TFLOP/s); at the coarse sweep (16 x 60^2 rays) the
// bytes bound K5, K7 and K8. This version re-reads the taps of every plane
// from L2 per thread.
//
// This file is compiled with -fmad=false: every multiply and add rounds on
// its own, as the plain PyTorch versions compute them. The backward's terms
// jump where a sample crosses a voxel row (the tent slope flips), so a
// position one ulp off can change a term; the checks hold K6 to a float32
// plain version with identical positions on that basis. The nearest-label
// (K7) and Siddon (K8) roundings are half to even (__float2int_rn), as
// jnp.round, and float-to-int casts of window/lane positions truncate, as
// astype(int32).
//
// Fields are one (7, B, R) f32 tensor: s0, s1, s2, d0, d1, d2, ws. Every
// entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG = 3e38f;
constexpr int THREADS = 256;
constexpr int MAX_CHANNELS = 16;

struct Ray {
  float s0, s1, s2, d0, d1, d2, ws;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ f, size_t n, size_t o) {
  return {f[o], f[n + o], f[2 * n + o], f[3 * n + o], f[4 * n + o], f[5 * n + o], f[6 * n + o]};
}

__device__ __forceinline__ float sign_of(float x) {
  return (x > 0.0f) ? 1.0f : ((x < 0.0f) ? -1.0f : 0.0f);
}

// Entry/exit of one axis's slab [-0.5, n - 0.5]; a ray parallel to it is
// inside for every alpha or for none.
__device__ __forceinline__ void axis_alphas(float s, float d, int n, float* lo, float* hi) {
  const bool parallel = fabsf(d) < 1e-9f;
  const float safe = parallel ? 1e-9f : d;
  const float t1 = (-0.5f - s) / safe;
  const float t2 = ((float)n - 0.5f - s) / safe;
  *lo = fminf(t1, t2);
  *hi = fmaxf(t1, t2);
  if (parallel) {
    const bool inside = (s > -0.5f) && (s < (float)n - 0.5f);
    *lo = inside ? -BIG : BIG;
    *hi = inside ? BIG : -BIG;
  }
}

__device__ __forceinline__ void ray_box(const Ray& r, int M, int Wd, int L, float* a_in,
                                        float* a_out) {
  float ain = 0.0f, aout = 1.0f, lo, hi;
  axis_alphas(r.s0, r.d0, M, &lo, &hi);
  ain = fmaxf(ain, lo);
  aout = fminf(aout, hi);
  axis_alphas(r.s1, r.d1, Wd, &lo, &hi);
  ain = fmaxf(ain, lo);
  aout = fminf(aout, hi);
  axis_alphas(r.s2, r.d2, L, &lo, &hi);
  ain = fmaxf(ain, lo);
  aout = fminf(aout, hi);
  *a_in = ain;
  *a_out = fmaxf(aout, ain);
}

// Lane-axis tap: index clipped to [0, L - 2], fraction to [0, 1].
struct LaneTap {
  int idx, idx_hi;
  float fx;
};

__device__ __forceinline__ LaneTap lane_tap(float p2, int L) {
  int idx = (int)p2;  // truncation, as astype(int32)
  idx = min(max(idx, 0), L > 1 ? L - 2 : 0);
  return {idx, min(idx + 1, L - 1), fminf(fmaxf(p2 - (float)idx, 0.0f), 1.0f)};
}

// The trilinear slab sample of one plane: the slab weight trimmed to the
// box, the window/lane validity of the sample, and the tap positions.
struct Sample {
  float alpha, p1, p2, w_alpha;
  bool valid;
};

__device__ __forceinline__ Sample slab_sample(const Ray& r, int k, float inv_d0, float half,
                                              float abs_d0, float a_in, float a_out, int Wd,
                                              int L) {
  Sample s;
  s.alpha = ((float)k - r.s0) * inv_d0;
  s.p1 = r.s1 + s.alpha * r.d1;
  s.p2 = r.s2 + s.alpha * r.d2;
  s.w_alpha = fmaxf(fminf(s.alpha + half, a_out) - fmaxf(s.alpha - half, a_in), 0.0f) * abs_d0;
  s.valid = (s.w_alpha > 0.0f) && (s.p1 > -1.0f) && (s.p1 < (float)Wd) && (s.p2 >= 0.0f) &&
            (s.p2 <= (float)(L - 1));
  return s;
}

// Sum over the (at most two) window rows of tent(p1 - z) * lerp_lane, in
// row order, starting from `acc`.
__device__ __forceinline__ float rows_sum(const __nv_bfloat16* __restrict__ slab, int Wd, int L,
                                          float p1, const LaneTap& t, float w_alpha, float acc) {
  const int z0 = (int)floorf(p1);
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    const int z = z0 + d;
    if (z < 0 || z >= Wd) continue;
    const float wz = fmaxf(1.0f - fabsf(p1 - (float)z), 0.0f);
    const float lo = __bfloat162float(slab[(size_t)z * L + t.idx]);
    const float hi = __bfloat162float(slab[(size_t)z * L + t.idx_hi]);
    const float v = lo + t.fx * (hi - lo);
    acc = acc + (wz * w_alpha) * v;
  }
  return acc;
}

// ---------------------------------------------------------------------------
// K5: out = ws * sum_k w_alpha(k) sum_rows tent(p1 - z) lerp_lane(V[k, z], p2)
// ---------------------------------------------------------------------------
__global__ void slab_forward_kernel(const __nv_bfloat16* __restrict__ vol, int M, int Wd, int L,
                                    const float* __restrict__ fields, float* __restrict__ out,
                                    int B, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (r >= R) return;
  const size_t n = (size_t)B * R, o = (size_t)b * R + r;
  const Ray ray = load_ray(fields, n, o);
  float acc = 0.0f;
  if (ray.ws > 0.0f) {
    const float safe_d0 = fabsf(ray.d0) < 1e-6f ? 1e-6f : ray.d0;
    const float inv_d0 = 1.0f / safe_d0;
    const float half = 0.5f * fabsf(inv_d0);
    const float abs_d0 = fabsf(safe_d0);
    float a_in, a_out;
    ray_box(ray, M, Wd, L, &a_in, &a_out);
    for (int k = 0; k < M; ++k) {
      const Sample s = slab_sample(ray, k, inv_d0, half, abs_d0, a_in, a_out, Wd, L);
      if (!s.valid) continue;
      acc = rows_sum(vol + (size_t)k * Wd * L, Wd, L, s.p1, lane_tap(s.p2, L), s.w_alpha, acc);
    }
  }
  out[o] = acc * ray.ws;
}

// ---------------------------------------------------------------------------
// K7: K5's samples split by the label of the nearest voxel (k, rint(p1),
// rint(p2)): channel 1 + j for chans[j] (every match, as the TPU kernel),
// channel 0 when no channel matches. Each slab's two-row sum is formed
// first and then added to its channel(s).
// ---------------------------------------------------------------------------
__global__ void slab_channels_kernel(const __nv_bfloat16* __restrict__ vol,
                                     const uint8_t* __restrict__ labels, int M, int Wd, int L,
                                     const int* __restrict__ chans, int n_chans,
                                     const float* __restrict__ fields, float* __restrict__ out,
                                     int B, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (r >= R) return;
  const int C = n_chans + 1;
  const size_t n = (size_t)B * R, o = (size_t)b * R + r;
  const Ray ray = load_ray(fields, n, o);
  float acc[MAX_CHANNELS];
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  if (ray.ws > 0.0f) {
    const float safe_d0 = fabsf(ray.d0) < 1e-6f ? 1e-6f : ray.d0;
    const float inv_d0 = 1.0f / safe_d0;
    const float half = 0.5f * fabsf(inv_d0);
    const float abs_d0 = fabsf(safe_d0);
    float a_in, a_out;
    ray_box(ray, M, Wd, L, &a_in, &a_out);
    for (int k = 0; k < M; ++k) {
      const Sample s = slab_sample(ray, k, inv_d0, half, abs_d0, a_in, a_out, Wd, L);
      if (!s.valid) continue;
      const float contrib =
          rows_sum(vol + (size_t)k * Wd * L, Wd, L, s.p1, lane_tap(s.p2, L), s.w_alpha, 0.0f);
      const int rn = min(max(__float2int_rn(s.p1), 0), Wd - 1);
      const int ln = min(max(__float2int_rn(s.p2), 0), L - 1);
      const int lab = (int)labels[((size_t)k * Wd + rn) * L + ln];
      bool fg = false;
      for (int j = 0; j < n_chans; ++j) {
        if (lab == chans[j]) {
          acc[j + 1] = acc[j + 1] + contrib;
          fg = true;
        }
      }
      if (!fg) acc[0] = acc[0] + contrib;
    }
  }
  for (int c = 0; c < C; ++c) out[((size_t)b * C + c) * R + r] = acc[c] * ray.ws;
}

// ---------------------------------------------------------------------------
// K6: the analytic per-ray VJP of K5 with respect to the 7 fields, with
// subgradients through the active box plane. One thread per ray re-marches
// the planes and keeps its 7 sums in float32, as the TPU kernel does: on the
// H100 at the path's shapes, double sums sat exactly as far from a float64
// reference as float32 sums (1.0e-2 of max, all of it from tent slopes that
// flip where a float32 position rounds across a row). The arithmetic of every
// term follows the TPU kernel operation by operation.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float dspan(bool open, bool u_int, bool v_int, float d_alpha,
                                       float d_h, float d_ain, float d_aout) {
  const float du = u_int ? d_alpha + d_h : d_aout;
  const float dv = v_int ? d_alpha - d_h : d_ain;
  return open ? du - dv : 0.0f;
}

__global__ void slab_backward_kernel(const __nv_bfloat16* __restrict__ vol, int M, int Wd, int L,
                                     const float* __restrict__ fields,
                                     const float* __restrict__ gin, float* __restrict__ gout,
                                     int B, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (r >= R) return;
  const size_t n = (size_t)B * R, o = (size_t)b * R + r;
  const Ray ray = load_ray(fields, n, o);
  const float g = gin[o];
  float acc = 0.0f, G[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (ray.ws > 0.0f) {
    const float safe_d0 = fabsf(ray.d0) < 1e-6f ? 1e-6f : ray.d0;
    const float inv_d0 = 1.0f / safe_d0;
    const float abs_d0 = fabsf(safe_d0);
    const float sgn_d0 = sign_of(safe_d0);
    const float half = 0.5f / abs_d0;
    const float dh_dd0 = -sgn_d0 * 2.0f * half * half;  // d(1/(2|d0|))/d d0

    // box entry/exit and their partials (order s0 s1 s2 d0 d1 d2); only the
    // active axis and side contributes
    float a_in = 0.0f, a_out = 1.0f;
    float dain[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float daout[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    const float ss[3] = {ray.s0, ray.s1, ray.s2};
    const float dd[3] = {ray.d0, ray.d1, ray.d2};
    const int nn[3] = {M, Wd, L};
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      const float s = ss[ax], d = dd[ax];
      const bool parallel = fabsf(d) < 1e-9f;
      const float safe = parallel ? 1e-9f : d;
      const float t1 = (-0.5f - s) / safe;
      const float t2 = ((float)nn[ax] - 0.5f - s) / safe;
      const bool use1_lo = t1 <= t2;
      float lo = use1_lo ? t1 : t2;
      float hi = use1_lo ? t2 : t1;
      const float inv = 1.0f / safe;
      float dls = -inv, dhs = -inv;
      float dld = -lo * inv, dhd = -hi * inv;
      if (parallel) {
        const bool inside = (s > -0.5f) && (s < (float)nn[ax] - 0.5f);
        lo = inside ? -BIG : BIG;
        hi = inside ? BIG : -BIG;
        dls = dld = dhs = dhd = 0.0f;
      }
      if (lo > a_in) {
#pragma unroll
        for (int j = 0; j < 6; ++j) dain[j] = 0.0f;
        dain[ax] = dls;
        dain[3 + ax] = dld;
      }
      a_in = fmaxf(a_in, lo);
      if (hi < a_out) {
#pragma unroll
        for (int j = 0; j < 6; ++j) daout[j] = 0.0f;
        daout[ax] = dhs;
        daout[3 + ax] = dhd;
      }
      a_out = fminf(a_out, hi);
    }
    if (a_out < a_in) {
#pragma unroll
      for (int j = 0; j < 6; ++j) daout[j] = dain[j];
    }
    a_out = fmaxf(a_out, a_in);

    const float gc = g * ray.ws;
    const float da_ds0 = -inv_d0;
    for (int k = 0; k < M; ++k) {
      const float alpha = ((float)k - ray.s0) * inv_d0;
      const float da_dd0 = -alpha * inv_d0;
      const float p1 = ray.s1 + alpha * ray.d1;
      const float p2 = ray.s2 + alpha * ray.d2;
      const float u_arg = alpha + half;
      const float v_arg = alpha - half;
      const float u = fminf(u_arg, a_out);
      const float v = fmaxf(v_arg, a_in);
      const float span = fmaxf(u - v, 0.0f);
      const float W = span * abs_d0;
      const bool open = span > 0.0f;
      const bool u_int = u_arg < a_out;
      const bool v_int = v_arg > a_in;
      const bool valid = open && (p1 > -1.0f) && (p1 < (float)Wd) && (p2 >= 0.0f) &&
                         (p2 <= (float)(L - 1));
      if (!valid) continue;  // every term of an invalid plane is zero

      const LaneTap t = lane_tap(p2, L);
      const __nv_bfloat16* slab = vol + (size_t)k * Wd * L;
      const int z0 = (int)floorf(p1);
      float Bs = 0.0f, dB1 = 0.0f, dB2 = 0.0f;
#pragma unroll
      for (int dz = 0; dz < 2; ++dz) {
        const int z = z0 + dz;
        if (z < 0 || z >= Wd) continue;
        const float diff = p1 - (float)z;
        if (!(fabsf(diff) < 1.0f)) continue;
        const float wz = fmaxf(1.0f - fabsf(diff), 0.0f);
        const float dtri = -sign_of(diff);
        const float lo = __bfloat162float(slab[(size_t)z * L + t.idx]);
        const float hi = __bfloat162float(slab[(size_t)z * L + t.idx_hi]);
        const float val = lo + t.fx * (hi - lo);
        Bs = Bs + wz * val;
        dB1 = dB1 + dtri * val;
        dB2 = dB2 + wz * (hi - lo);
      }

      float dW = abs_d0 * dspan(open, u_int, v_int, da_ds0, 0.0f, dain[0], daout[0]);
      G[0] = G[0] + gc * (dW * Bs + W * (dB1 * ray.d1 * da_ds0 + dB2 * ray.d2 * da_ds0));
      dW = abs_d0 * dspan(open, u_int, v_int, 0.0f, 0.0f, dain[1], daout[1]);
      G[1] = G[1] + gc * (dW * Bs + W * dB1);
      dW = abs_d0 * dspan(open, u_int, v_int, 0.0f, 0.0f, dain[2], daout[2]);
      G[2] = G[2] + gc * (dW * Bs + W * dB2);
      dW = abs_d0 * dspan(open, u_int, v_int, da_dd0, dh_dd0, dain[3], daout[3]) + span * sgn_d0;
      G[3] = G[3] + gc * (dW * Bs + W * (dB1 * ray.d1 * da_dd0 + dB2 * ray.d2 * da_dd0));
      dW = abs_d0 * dspan(open, u_int, v_int, 0.0f, 0.0f, dain[4], daout[4]);
      G[4] = G[4] + gc * (dW * Bs + W * dB1 * alpha);
      dW = abs_d0 * dspan(open, u_int, v_int, 0.0f, 0.0f, dain[5], daout[5]);
      G[5] = G[5] + gc * (dW * Bs + W * dB2 * alpha);
      acc = acc + W * Bs;
    }
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) gout[j * n + o] = G[j];
  gout[6 * n + o] = g * acc;
}

// ---------------------------------------------------------------------------
// K8: exact Siddon forward. Inside one slab a ray within 45 degrees of the
// march axis crosses at most one window plane and one lane plane, so the
// slab interval [aa, ab] splits into at most 3 segments over the voxels
// {ra, rb} x {ca, cb}; the exact crossing parameters give exact lengths.
// out = ws * |d0| * sum of voxel value x alpha length.
// ---------------------------------------------------------------------------
__global__ void slab_siddon_kernel(const __nv_bfloat16* __restrict__ vol, int M, int Wd, int L,
                                   const float* __restrict__ fields, float* __restrict__ out,
                                   int B, int R) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (r >= R) return;
  const size_t n = (size_t)B * R, o = (size_t)b * R + r;
  const Ray ray = load_ray(fields, n, o);
  const float safe_d0 = fabsf(ray.d0) < 1e-6f ? 1e-6f : ray.d0;
  const float abs_d0 = fabsf(safe_d0);
  float acc = 0.0f;
  if (ray.ws > 0.0f) {
    const float inv_d0 = 1.0f / safe_d0;
    const float half = 0.5f * fabsf(inv_d0);
    const float safe_d1 = fabsf(ray.d1) < 1e-9f ? 1e-9f : ray.d1;
    const float safe_d2 = fabsf(ray.d2) < 1e-9f ? 1e-9f : ray.d2;
    float a_in, a_out;
    ray_box(ray, M, Wd, L, &a_in, &a_out);
    for (int k = 0; k < M; ++k) {
      const float alpha = ((float)k - ray.s0) * inv_d0;
      const float aa = fmaxf(alpha - half, a_in);
      const float ab = fminf(alpha + half, a_out);
      const float seg = ab - aa;
      if (!(seg > 0.0f)) continue;
      const float eps = 1e-5f * fmaxf(seg, 0.0f);
      const float p1a = ray.s1 + (aa + eps) * ray.d1;
      const float p1b = ray.s1 + (ab - eps) * ray.d1;
      const float p2a = ray.s2 + (aa + eps) * ray.d2;
      const float p2b = ray.s2 + (ab - eps) * ray.d2;
      const int ra = min(max(__float2int_rn(p1a), 0), Wd - 1);
      const int rb = min(max(__float2int_rn(p1b), 0), Wd - 1);
      const int ca = min(max(__float2int_rn(p2a), 0), L - 1);
      const int cb = min(max(__float2int_rn(p2b), 0), L - 1);

      const float tw = (ra != rb) ? ((float)max(ra, rb) - 0.5f - ray.s1) / safe_d1 : BIG;
      const float tl = (ca != cb) ? ((float)max(ca, cb) - 0.5f - ray.s2) / safe_d2 : BIG;
      const bool first_is_w = tw <= tl;
      const float t1c = fminf(fmaxf(fminf(tw, tl), aa), ab);
      const float t2c = fminf(fmaxf(fmaxf(tw, tl), aa), ab);
      const float L1 = t1c - aa;
      const float L2 = t2c - t1c;
      const float L3 = ab - t2c;
      const float L_rb_ca = first_is_w ? L2 : 0.0f;
      const float L_ra_cb = first_is_w ? 0.0f : L2;

      const int cmin = min(max(min(ca, cb), 0), L - 1);
      const int chi = min(cmin + 1, L - 1);
      const __nv_bfloat16* slab = vol + (size_t)k * Wd * L;
      const float lo_a = __bfloat162float(slab[(size_t)ra * L + cmin]);
      const float hi_a = __bfloat162float(slab[(size_t)ra * L + chi]);
      const float lo_b = __bfloat162float(slab[(size_t)rb * L + cmin]);
      const float hi_b = __bfloat162float(slab[(size_t)rb * L + chi]);
      const float A = L1 * (ca == cmin ? lo_a : hi_a) + L_ra_cb * (cb == cmin ? lo_a : hi_a);
      const float Bv = L_rb_ca * (ca == cmin ? lo_b : hi_b) + L3 * (cb == cmin ? lo_b : hi_b);
      acc = acc + (A + Bv);
    }
  }
  out[o] = acc * ray.ws * abs_d0;
}

dim3 ray_grid(int B, int R) { return dim3((R + THREADS - 1) / THREADS, B); }

}  // namespace

extern "C" {

int slab_forward(const void* vol, int M, int Wd, int L, const void* fields, void* out, int B,
                 int R, void* stream) {
  slab_forward_kernel<<<ray_grid(B, R), THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)vol, M, Wd, L, (const float*)fields, (float*)out, B, R);
  return (int)cudaGetLastError();
}

int slab_backward(const void* vol, int M, int Wd, int L, const void* fields, const void* g,
                  void* gout, int B, int R, void* stream) {
  slab_backward_kernel<<<ray_grid(B, R), THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)vol, M, Wd, L, (const float*)fields, (const float*)g, (float*)gout,
      B, R);
  return (int)cudaGetLastError();
}

int slab_max_channels() { return MAX_CHANNELS; }

int slab_channels(const void* vol, const void* labels, int M, int Wd, int L, const void* chans,
                  int n_chans, const void* fields, void* out, int B, int R, void* stream) {
  if (n_chans < 0 || n_chans + 1 > MAX_CHANNELS) return (int)cudaErrorInvalidValue;
  slab_channels_kernel<<<ray_grid(B, R), THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)vol, (const uint8_t*)labels, M, Wd, L, (const int*)chans, n_chans,
      (const float*)fields, (float*)out, B, R);
  return (int)cudaGetLastError();
}

int slab_siddon(const void* vol, int M, int Wd, int L, const void* fields, void* out, int B,
                int R, void* stream) {
  slab_siddon_kernel<<<ray_grid(B, R), THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)vol, M, Wd, L, (const float*)fields, (float*)out, B, R);
  return (int)cudaGetLastError();
}

}  // extern "C"

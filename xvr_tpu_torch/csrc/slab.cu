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
// streaming. Consecutive rays (detector columns, which the permutation puts
// along the lane axis) sit on consecutive lanes of a warp, so a warp's taps
// at one plane fall on one or two volume rows.
//
// Bound on the H100: the least bytes are the bf16 volume read once (33.5 MB,
// ~10 us at 3.35 TB/s) plus the f32 fields and outputs; the operations are
// counted per evaluated (ray, plane) pair (chip_smoke.py's SLAB_OPS). At the
// fine stage (4 x 239^2 rays, ~58M pairs) the operations bound all four; at
// the coarse sweep (16 x 60^2 rays) the bytes bound K5, K7 and K8. A pair is a
// 2 x 2 bilinear tap of one ray: there is no product to tile, so tensor cores
// do not apply, and every kernel issues its taps from L2.
//
// K5 and K6 (the slab path's forward and backward, a few hundred launches
// per registration each). PR 2's versions ran one thread per ray over all M
// planes and were issue-bound: every plane paid the box weight, five range
// tests, four float/int conversions (a quarter-rate unit), clamps, row masks
// and 64-bit address arithmetic, and K6 also the six box-plane terms.
//  - Planes split across warps. A block of 256 threads holds 256 / P rays,
//    and P warps share the planes of the same 32 rays, so the coarse
//    sweep's 57,600 rays fill the card (one thread per ray gave ~14 warps
//    per SM there). plane_split() picks P from the ray count; each warp takes
//    a contiguous range of the ray's planes, and the P partial sums are added
//    through shared memory in warp order: no atomics, and two calls give
//    identical bits.
//  - A trimmed plane range. plane_range() bounds the planes whose slab can
//    meet [a_in, a_out], one plane wider on each side for rounding; the exact
//    validity test stays inside, so no plane with a nonzero weight is lost.
//  - Lean planes (see lean_part()). Nearly every plane of a ray has its slab
//    inside the box and its four taps inside the volume; on that interval,
//    checked exactly at its two ends, a plane costs positions, two exact
//    floors (floor_exact()), four loads at one 32-bit offset and the
//    bilinear sum, with no test, clamp or mask. The other planes take the
//    full path, where an invalid plane taps (0, 0) with zero weight.
//  - K6 on a lean plane: the box-plane terms of s0, s1, s2, d1 and d2 are
//    (a + 0) - (a - 0) = 0 exactly and only d0 keeps its half-width term; the
//    per-ray factors come out of the plane sums. Only a plane that holds a
//    box end (at most two at each end of a ray) adds the box-plane terms,
//    from partials kept as (axis, d/ds, d/dd) for a_in and for a_out.
//  - K5 fuses its positions, taps and sums (__fmaf_rn): it is held to a
//    float64 reference and sums positive terms, and a lean plane's weight is
//    exactly 1. K6 keeps every position rounded on its own (below).
// On the H100 this took K5 from 0.28 to 0.09 ms and K6 from 0.53 to 0.16 ms
// at the fine stage (scripts/chip_slab_times.py, PERF.md).
//
// K7 and K8 take the same plan: plane split, trimmed range, parts summed in
// warp order, and an interval of lean planes checked at its two ends.
//  - K7's nearest label (k, rint(p1), rint(p2)) jumps at half-integers, so
//    its positions are K6's: each product and sum rounded on its own, from
//    k, as the plain version rounds them (a fused p1 one ulp off moves a
//    whole sample to another channel). Only the contribution is fused. A
//    block first maps every label byte to a bit mask of its channels in
//    shared memory (the channel values come by value in the launch), so a
//    plane costs one byte gather, one shared load and, for the usual single
//    bit, one add. The channel sums live in registers for up to
//    K7_REG_CHANNELS channels, else in a per-thread column of shared memory
//    that doubles as the buffer for the part sums (registers were faster at
//    the path's C = 3 on the H100: scripts/chip_slab_times.py).
//  - K8 forms its crossings from the rounded sums of its rints and a
//    per-ray reciprocal (a division per plane was slower and no closer to
//    the float64 plain version).
//  - K8's lean plane has its slab inside the box (its ends are the plain
//    version's alpha -+ half) and its four rounded indices inside the volume
//    with a second lane to spare: no clamp and no seg > 0 test.
//  - rint, like floor, is one add on the FP32 pipe (rint_exact()), never the
//    conversion unit.
//
// This file is compiled with -fmad=false: every multiply and add rounds on
// its own, as the plain PyTorch versions compute them, except where a kernel
// asks for a fused one. The backward's terms jump where a sample crosses a voxel
// row (the tent slope flips), so a position one ulp off can change a term;
// the checks hold K6 to a float32 plain version with identical positions on
// that basis. The nearest-label (K7) and Siddon (K8) roundings are half to
// even (rint_exact()), as jnp.round, and float-to-int casts of window/lane
// positions truncate, as astype(int32).
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
// K5-K8: at most SPLIT_MAX warps share one ray's planes; the split doubles
// until the grid holds SPLIT_TARGET_WARPS warps (the CPU model in
// tests/test_torch_slab_plan.py copies both)
constexpr int SPLIT_MAX = 8;
constexpr int SPLIT_TARGET_WARPS = 8448;  // one wave of 132 SMs x 64 warps
// planes per unrolled step of each kernel's lean loop
constexpr int K5_UNROLL = 2;
constexpr int K6_UNROLL = 2;
constexpr int K7_UNROLL = 4;
constexpr int K8_UNROLL = 2;
// K7: channel counts up to this keep their sums in registers (0: always in
// shared memory)
constexpr int K7_REG_CHANNELS = 4;
// K6: blocks of THREADS that its register budget lets one SM hold
constexpr int K6_BLOCKS_PER_SM = 3;

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

// ---------------------------------------------------------------------------
// K5-K8 plan: P warps per 32 rays, each over a contiguous part of the ray's
// trimmed plane range
// ---------------------------------------------------------------------------

// Warps that share one ray's planes for B x R rays: doubled from 1 while the
// grid holds fewer than SPLIT_TARGET_WARPS warps, at most SPLIT_MAX.
int plane_split(int B, int R) {
  const long long warps = (long long)B * ((R + 31) / 32);
  int p = 1;
  while (p < SPLIT_MAX && warps * p < SPLIT_TARGET_WARPS) p *= 2;
  return p;
}

// The box [a_in, a_out] in plane units, k = s0 + alpha safe_d0, sorted.
__device__ __forceinline__ void box_planes(float s0, float safe_d0, float a_in, float a_out,
                                           float* k_lo, float* k_hi) {
  const float e1 = __fmaf_rn(a_in, safe_d0, s0), e2 = __fmaf_rn(a_out, safe_d0, s0);
  *k_lo = fminf(e1, e2);
  *k_hi = fmaxf(e1, e2);
}

// Planes [*lo, *hi] whose slab can meet the box (a_out > a_in; else empty,
// *lo > *hi). Plane k's slab is alpha_k +- half with alpha_k = (k - s0) /
// safe_d0, so it overlaps the box iff k lies in (k_lo - 1/2, k_hi + 1/2); the
// range is one plane wider on each side, so float rounding of either side
// drops nothing.
__device__ __forceinline__ void plane_range(bool box, float k_lo, float k_hi, int M, int* lo,
                                            int* hi) {
  if (!box) {
    *lo = 0;
    *hi = -1;
    return;
  }
  *lo = (int)fmaxf(floorf(k_lo - 0.5f), 0.0f);
  *hi = (int)fminf(ceilf(k_hi + 0.5f), (float)(M - 1));
}

// This thread's part [*kb, *ke) of the planes [lo, hi] split into `split`
// contiguous parts of ceil(n / split) planes.
__device__ __forceinline__ void plane_part(int lo, int hi, int split, int part, int* kb,
                                           int* ke) {
  const int n = max(hi - lo + 1, 0);
  const int chunk = (n + split - 1) / split;
  *kb = min(lo + part * chunk, hi + 1);
  *ke = min(*kb + chunk, hi + 1);
}

// Lean planes. Where a plane's slab lies inside the box and both rows and
// both lanes of its taps inside the volume, it needs no validity test, no
// clamp and no row mask (K6's full plane computes the same bits there; K5's
// lean weight is exactly 1 where the full plane rounds it). Every
// quantity the tests read (positions, slab ends) is a monotone function of k
// under float rounding, so the lean planes of a ray are an interval: the
// kernels estimate it, check both of its ends exactly, and march it without
// the tests (or, if a check fails, march every plane in full).

// Narrows [*ka, *kz] to the planes k with lo <= c + k m < hi, one plane to
// spare on each side (an estimate: a poor one costs time, never a plane).
__device__ __forceinline__ void narrow(float c, float m, float lo, float hi, float* ka,
                                       float* kz) {
  const float t1 = __fdividef(lo - c, m), t2 = __fdividef(hi - c, m);
  *ka = fmaxf(*ka, fminf(t1, t2) + 1.0f);  // fminf/fmaxf drop a NaN of m = 0
  *kz = fminf(*kz, fmaxf(t1, t2) - 1.0f);
}

// The whole planes of [ka, kz] in [kb, ke) as [*ia, *ib); empty as [ke, ke).
__device__ __forceinline__ void lean_part(float ka, float kz, int kb, int ke, int* ia, int* ib) {
  ka = fmaxf(ka, (float)kb);
  kz = fminf(kz, (float)(ke - 1));
  *ia = *ib = ke;
  if (ka <= kz && (int)ceilf(ka) <= (int)floorf(kz)) {
    *ia = (int)ceilf(ka);
    *ib = (int)floorf(kz) + 1;
  }
}

// The thread's place in a K5-K8 block: warp (group * split + part) holds the
// part-th plane range of the group's 32 rays.
struct Slot {
  int part, r;
};

__device__ __forceinline__ Slot slot_of(int split) {
  const int warp = threadIdx.x >> 5;
  return {warp % split, blockIdx.x * (THREADS / split) + (warp / split) * 32 + (threadIdx.x & 31)};
}

// For the part-0 thread: the sum of its rays' values in `part` (one per
// thread) over the split parts, in part order.
__device__ __forceinline__ float sum_parts(const float* part, int split) {
  float s = part[threadIdx.x];
  for (int q = 1; q < split; ++q) s = s + part[threadIdx.x + q * 32];
  return s;
}

__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }

// The voxel at row `row` of the plane and lane that `base` (plane offset +
// lane) points at: a 32-bit offset (the entry points refuse volumes of 2^31
// voxels or more), so that the address is one wide multiply-add.
__device__ __forceinline__ const __nv_bfloat16* tap(const __nv_bfloat16* vol, uint32_t base,
                                                    int row, int L) {
  return vol + (base + (uint32_t)(row * L));
}

// floor(x) as a float and as an int, for |x| < 2^22: one add rounded down
// into [2^23, 2^24), where the floats are the integers, so both are exact
// and run on the FP32 and integer pipes instead of the conversion unit
// (a quarter of their rate). The entry points refuse Wd or L >= 2^22.
constexpr float FLOOR_MAGIC = 12582912.0f;  // 1.5 * 2^23
constexpr int MAX_EXTENT = 1 << 22;
__device__ __forceinline__ float floor_exact(float x, int* i) {
  const float t = __fadd_rd(x, FLOOR_MAGIC);
  *i = __float_as_int(t) - __float_as_int(FLOOR_MAGIC);
  return t - FLOOR_MAGIC;
}

// rint(x) (half to even) as a float and as an int, for |x| < 2^22: the same
// add rounded to nearest. FLOOR_MAGIC is even, so a tie goes to the even
// integer, as __float2int_rn and jnp.round take it.
// rint_exact() in two steps: the rounded sum t (ordered as x's rint), and
// the integer in t's bits.
__device__ __forceinline__ float rint_sum(float x) { return __fadd_rn(x, FLOOR_MAGIC); }
__device__ __forceinline__ int rint_of(float t) {
  return __float_as_int(t) - __float_as_int(FLOOR_MAGIC);
}
__device__ __forceinline__ float rint_exact(float x, int* i) {
  const float t = rint_sum(x);
  *i = rint_of(t);
  return t - FLOOR_MAGIC;
}

// ---------------------------------------------------------------------------
// K5: out = ws * sum_k w_alpha(k) sum_rows tent(p1 - z) lerp_lane(V[k, z], p2)
// A lean plane's slab lies inside the box, so its weight is exactly 1 (the
// plain version's (alpha + half) - (alpha - half) rounds it); the full
// planes take the plain version's weight and positions, fused. STEP is the
// lane step of a tap pair (0 for a volume of one lane).
// ---------------------------------------------------------------------------
template <int STEP>
__global__ void __launch_bounds__(THREADS)
slab_forward_kernel(const __nv_bfloat16* __restrict__ vol, int M, int Wd, int L,
                    const float* __restrict__ fields, float* __restrict__ out, int B, int R,
                    int split) {
  __shared__ float part[THREADS];
  const Slot sl = slot_of(split);
  const int b = blockIdx.y;
  const bool live = sl.r < R;
  const size_t n = (size_t)B * R, o = (size_t)b * R + sl.r;
  float acc = 0.0f, ws = 0.0f;
  if (live) {
    const Ray ray = load_ray(fields, n, o);
    ws = ray.ws;
    if (ray.ws > 0.0f) {
      const float safe_d0 = fabsf(ray.d0) < 1e-6f ? 1e-6f : ray.d0;
      const float inv_d0 = 1.0f / safe_d0;
      const float half = 0.5f * fabsf(inv_d0);
      const float abs_d0 = fabsf(safe_d0);
      float a_in, a_out, k_lo, k_hi;
      ray_box(ray, M, Wd, L, &a_in, &a_out);
      box_planes(ray.s0, safe_d0, a_in, a_out, &k_lo, &k_hi);
      int lo, hi, kb, ke;
      plane_range(a_out > a_in, k_lo, k_hi, M, &lo, &hi);
      plane_part(lo, hi, split, sl.part, &kb, &ke);
      const float Wf = (float)Wd, Lm1 = (float)(L - 1);
      const int lane_max = L > 1 ? L - 2 : 0;
      const uint32_t plane = (uint32_t)Wd * L;

      auto full = [&](int k) {
        const float alpha = ((float)k - ray.s0) * inv_d0;
        const float p1 = __fmaf_rn(alpha, ray.d1, ray.s1);
        const float p2 = __fmaf_rn(alpha, ray.d2, ray.s2);
        const float w = fmaxf(fminf(alpha + half, a_out) - fmaxf(alpha - half, a_in), 0.0f) * abs_d0;
        const bool valid = (w > 0.0f) && (p1 > -1.0f) && (p1 < Wf) && (p2 >= 0.0f) && (p2 <= Lm1);
        // an invalid plane taps (0, 0) with zero weight
        const float q1 = valid ? p1 : 0.0f, q2 = valid ? p2 : 0.0f;
        int idx, z0;
        const float idx_f = floor_exact(q2, &idx);  // q2 >= 0: the truncation of astype(int32)
        const float fx = q2 - fminf(idx_f, (float)lane_max);
        idx = min(idx, lane_max);
        const float fy = q1 - floor_exact(q1, &z0);
        const uint32_t slab = (uint32_t)k * plane + idx;
        const __nv_bfloat16* t0 = tap(vol, slab, max(z0, 0), L);
        const __nv_bfloat16* t1 = tap(vol, slab, min(z0 + 1, Wd - 1), L);
        const float lo0 = ld(t0), hi0 = ld(t0 + STEP);
        const float lo1 = ld(t1), hi1 = ld(t1 + STEP);
        // rows z0 and z0 + 1 weigh 1 - fy and fy; a row outside the volume adds 0
        const float v0 = z0 >= 0 ? __fmaf_rn(fx, hi0 - lo0, lo0) : 0.0f;
        const float v1 = z0 + 1 < Wd ? __fmaf_rn(fx, hi1 - lo1, lo1) : 0.0f;
        acc = __fmaf_rn(valid ? w : 0.0f, __fmaf_rn(fy, v1 - v0, v0), acc);
      };
      // lean: the slab inside the box, 0 <= p1 < Wd - 1 and 0 <= p2 < L - 1
      auto is_lean = [&](int k) {
        const float alpha = ((float)k - ray.s0) * inv_d0;
        const float p1 = __fmaf_rn(alpha, ray.d1, ray.s1);
        const float p2 = __fmaf_rn(alpha, ray.d2, ray.s2);
        return (alpha + half <= a_out) && (alpha - half >= a_in) && (p1 >= 0.0f) &&
               (p1 < Wf - 1.0f) && (p2 >= 0.0f) && (p2 < Lm1);
      };
      const float m1 = ray.d1 * inv_d0, m2 = ray.d2 * inv_d0;
      float ka = k_lo + 1.5f, kz = k_hi - 1.5f;
      narrow(ray.s1 - ray.s0 * m1, m1, 0.0f, Wf - 1.0f, &ka, &kz);
      narrow(ray.s2 - ray.s0 * m2, m2, 0.0f, Lm1, &ka, &kz);
      int ia, ib;
      lean_part(ka, kz, kb, ke, &ia, &ib);
      if (ia < ib && !(is_lean(ia) && is_lean(ib - 1))) ia = ib = ke;

      for (int k = kb; k < ia; ++k) full(k);
      uint32_t slab = (uint32_t)ia * plane;
      float kf = (float)ia;
#pragma unroll (K5_UNROLL)
      for (int k = ia; k < ib; ++k, kf += 1.0f, slab += plane) {
        const float alpha = (kf - ray.s0) * inv_d0;
        const float p1 = __fmaf_rn(alpha, ray.d1, ray.s1);
        const float p2 = __fmaf_rn(alpha, ray.d2, ray.s2);
        int idx, z0;
        const float fx = p2 - floor_exact(p2, &idx);
        const float fy = p1 - floor_exact(p1, &z0);
        const __nv_bfloat16* t0 = tap(vol, slab + idx, z0, L);
        const float lo0 = ld(t0), hi0 = ld(t0 + 1);
        const float lo1 = ld(t0 + L), hi1 = ld(t0 + L + 1);
        const float v0 = __fmaf_rn(fx, hi0 - lo0, lo0);
        const float v1 = __fmaf_rn(fx, hi1 - lo1, lo1);
        acc = acc + __fmaf_rn(fy, v1 - v0, v0);
      }
      for (int k = ib; k < ke; ++k) full(k);
    }
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  if (sl.part == 0 && live) out[o] = sum_parts(part, split) * ws;
}

// ---------------------------------------------------------------------------
// K7: K5's samples split by the label of the nearest voxel (k, rint(p1),
// rint(p2)): channel 1 + j for chans[j] (every match, as the TPU kernel),
// channel 0 when no channel matches, in K5's plan. Positions are the plain
// version's, op by op (see the top of the file); each slab's two-row sum is
// formed first (fused) and then added to its channel(s). A lean plane's
// weight is exactly 1, as K5's, and its nearest voxel lies in the volume
// (0 <= p1 < Wd - 1, 0 <= p2 < L - 1), so it needs no clamp. NREG > 0 keeps
// the sums of up to NREG channels in registers; NREG = 0 keeps them in the
// thread's column of `acc`.
// ---------------------------------------------------------------------------

// The channel values, by value in the launch: v[j] for j < n.
struct Channels {
  int n;
  int v[MAX_CHANNELS - 1];
};

template <int STEP, int NREG>
__global__ void __launch_bounds__(THREADS)
slab_channels_kernel(const __nv_bfloat16* __restrict__ vol, const uint8_t* __restrict__ labels,
                     int M, int Wd, int L, Channels chans, const float* __restrict__ fields,
                     float* __restrict__ out, int B, int R, int split) {
  static_assert(THREADS == 256, "one label byte per thread builds the mask table");
  __shared__ float acc[MAX_CHANNELS * THREADS];  // channel c of thread t at c * THREADS + t
  __shared__ uint32_t mask_of[256];  // label byte -> bit 1 + j for each chans[j], else bit 0
  {
    const int t = threadIdx.x;
    uint32_t m = 0;
#pragma unroll
    for (int j = 0; j < MAX_CHANNELS - 1; ++j)
      if (j < chans.n && chans.v[j] == t) m |= 2u << j;
    mask_of[t] = m ? m : 1u;
  }
  const int C = chans.n + 1;
  float* col = acc + threadIdx.x;
  float reg[NREG > 0 ? NREG : 1];
  if constexpr (NREG > 0) {
#pragma unroll
    for (int c = 0; c < NREG; ++c) reg[c] = 0.0f;
  } else {
    for (int c = 0; c < C; ++c) col[c * THREADS] = 0.0f;
  }
  // add v to every channel of mask m, in plane order per channel
  auto add = [&](uint32_t m, float v) {
    if constexpr (NREG > 0) {
#pragma unroll
      for (int c = 0; c < NREG; ++c)
        if ((m >> c) & 1u) reg[c] = reg[c] + v;
    } else {
      do {
        float* a = col + (__ffs(m) - 1) * THREADS;
        *a = *a + v;
        m &= m - 1;
      } while (m);
    }
  };
  __syncthreads();  // mask_of

  const Slot sl = slot_of(split);
  const int b = blockIdx.y;
  const bool live = sl.r < R;
  const size_t n = (size_t)B * R, o = (size_t)b * R + sl.r;
  float ws = 0.0f;
  if (live) {
    const Ray ray = load_ray(fields, n, o);
    ws = ray.ws;
    if (ray.ws > 0.0f) {
      const float safe_d0 = fabsf(ray.d0) < 1e-6f ? 1e-6f : ray.d0;
      const float inv_d0 = 1.0f / safe_d0;
      const float half = 0.5f * fabsf(inv_d0);
      const float abs_d0 = fabsf(safe_d0);
      float a_in, a_out, k_lo, k_hi;
      ray_box(ray, M, Wd, L, &a_in, &a_out);
      box_planes(ray.s0, safe_d0, a_in, a_out, &k_lo, &k_hi);
      int lo, hi, kb, ke;
      plane_range(a_out > a_in, k_lo, k_hi, M, &lo, &hi);
      plane_part(lo, hi, split, sl.part, &kb, &ke);
      const float Wf = (float)Wd, Lm1 = (float)(L - 1);
      const int lane_max = L > 1 ? L - 2 : 0;
      const uint32_t plane = (uint32_t)Wd * L;

      auto full = [&](int k) {
        k = min(max(k, 0), M - 1);  // see K8's full plane
        const float alpha = ((float)k - ray.s0) * inv_d0;
        const float p1 = ray.s1 + alpha * ray.d1;
        const float p2 = ray.s2 + alpha * ray.d2;
        const float w = fmaxf(fminf(alpha + half, a_out) - fmaxf(alpha - half, a_in), 0.0f) * abs_d0;
        if (!((w > 0.0f) && (p1 > -1.0f) && (p1 < Wf) && (p2 >= 0.0f) && (p2 <= Lm1))) return;
        int idx, z0, rn, ln;
        const float idx_f = floor_exact(p2, &idx);  // p2 >= 0: the truncation of astype(int32)
        const float fx = p2 - fminf(idx_f, (float)lane_max);
        idx = min(idx, lane_max);
        const float fy = p1 - floor_exact(p1, &z0);
        const uint32_t slab = (uint32_t)k * plane;
        const __nv_bfloat16* t0 = tap(vol, slab + idx, max(z0, 0), L);
        const __nv_bfloat16* t1 = tap(vol, slab + idx, min(z0 + 1, Wd - 1), L);
        const float lo0 = ld(t0), hi0 = ld(t0 + STEP);
        const float lo1 = ld(t1), hi1 = ld(t1 + STEP);
        // rows z0 and z0 + 1 weigh 1 - fy and fy; a row outside the volume adds 0
        const float v0 = z0 >= 0 ? __fmaf_rn(fx, hi0 - lo0, lo0) : 0.0f;
        const float v1 = z0 + 1 < Wd ? __fmaf_rn(fx, hi1 - lo1, lo1) : 0.0f;
        rint_exact(p1, &rn);
        rint_exact(p2, &ln);
        rn = min(max(rn, 0), Wd - 1);
        ln = min(ln, L - 1);
        add(mask_of[labels[slab + (uint32_t)(rn * L + ln)]], w * __fmaf_rn(fy, v1 - v0, v0));
      };
      // lean: the slab inside the box (and open), 0 <= p1 < Wd - 1, 0 <= p2 < L - 1
      auto is_lean = [&](int k) {
        const float alpha = ((float)k - ray.s0) * inv_d0;
        const float p1 = ray.s1 + alpha * ray.d1;
        const float p2 = ray.s2 + alpha * ray.d2;
        const float u = alpha + half, v = alpha - half;
        return (u <= a_out) && (v >= a_in) && (u > v) && (p1 >= 0.0f) && (p1 < Wf - 1.0f) &&
               (p2 >= 0.0f) && (p2 < Lm1);
      };
      const float m1 = ray.d1 * inv_d0, m2 = ray.d2 * inv_d0;
      float ka = k_lo + 1.5f, kz = k_hi - 1.5f;
      narrow(ray.s1 - ray.s0 * m1, m1, 0.0f, Wf - 1.0f, &ka, &kz);
      narrow(ray.s2 - ray.s0 * m2, m2, 0.0f, Lm1, &ka, &kz);
      int ia, ib;
      lean_part(ka, kz, kb, ke, &ia, &ib);
      if (ia < ib && !(is_lean(ia) && is_lean(ib - 1))) ia = ib = ke;

      for (int k = kb; k < ia; ++k) full(k);
      uint32_t slab = (uint32_t)ia * plane;
      float kf = (float)ia;
#pragma unroll (K7_UNROLL)
      for (int k = ia; k < ib; ++k, kf += 1.0f, slab += plane) {
        const float alpha = (kf - ray.s0) * inv_d0;
        const float p1 = ray.s1 + alpha * ray.d1;
        const float p2 = ray.s2 + alpha * ray.d2;
        int idx, z0, rn, ln;
        const float fx = p2 - floor_exact(p2, &idx);
        const float fy = p1 - floor_exact(p1, &z0);
        const __nv_bfloat16* t0 = tap(vol, slab + idx, z0, L);
        const float lo0 = ld(t0), hi0 = ld(t0 + 1);
        const float lo1 = ld(t0 + L), hi1 = ld(t0 + L + 1);
        rint_exact(p1, &rn);
        rint_exact(p2, &ln);
        const uint32_t m = mask_of[__ldg(labels + (slab + (uint32_t)(rn * L + ln)))];
        const float v0 = __fmaf_rn(fx, hi0 - lo0, lo0);
        const float v1 = __fmaf_rn(fx, hi1 - lo1, lo1);
        add(m, __fmaf_rn(fy, v1 - v0, v0));
      }
      for (int k = ib; k < ke; ++k) full(k);
    }
  }
  if constexpr (NREG > 0) {
#pragma unroll
    for (int c = 0; c < NREG; ++c)
      if (c < C) col[c * THREADS] = reg[c];
  }
  __syncthreads();
  if (sl.part == 0 && live)
    for (int c = 0; c < C; ++c)
      out[((size_t)b * C + c) * R + sl.r] = sum_parts(acc + c * THREADS, split) * ws;
}

// ---------------------------------------------------------------------------
// K6: the analytic per-ray VJP of K5 with respect to the 7 fields, with
// subgradients through the active box plane, in K5's plan. Per plane the
// TPU kernel adds, for field j, gc (dW_j Bs + W rest_j) with gc = g ws,
// rest = (d1 dB1 + d2 dB2) da/ds0, dB1, dB2, (d1 dB1 + d2 dB2) da/dd0,
// alpha dB1, alpha dB2 for s0 s1 s2 d0 d1 d2, da/ds0 = -1/d0 and
// da/dd0 = -alpha/d0. The per-ray factors (gc, 1/d0, d1, d2) come out of the
// plane sum: a plane adds W dB1, W dB2, their alpha multiples, dW_3 Bs and
// W Bs to six sums, and a box-end plane adds dW_j Bs for the other five
// fields to five more; the fields are formed from the sums once per ray.
// Sums are float32, as the TPU kernel's: on the H100 at the path's shapes,
// double sums sat exactly as far from a float64 reference as float32 sums
// (1.0e-2 of max, all of it from tent slopes that flip where a float32
// position rounds across a row). Positions, box flags and tent taps are the
// plain version's operations, each rounded on its own, computed from k on
// every plane and never stepped.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float dspan(bool u_int, bool v_int, float d_alpha, float d_h,
                                       float d_ain, float d_aout) {
  const float du = u_int ? d_alpha + d_h : d_aout;
  const float dv = v_int ? d_alpha - d_h : d_ain;
  return du - dv;
}

// The partial of a box end (a_in or a_out) with respect to field j (order
// s0 s1 s2 d0 d1 d2): only its active axis `ax` has one (ax < 0: none).
struct BoxEnd {
  int ax;
  float ds, dd;
  __device__ __forceinline__ float partial(int j) const {
    return j == ax ? ds : (j == ax + 3 ? dd : 0.0f);
  }
};

template <int STEP>
__global__ void __launch_bounds__(THREADS, K6_BLOCKS_PER_SM)
slab_backward_kernel(const __nv_bfloat16* __restrict__ vol, int M, int Wd, int L,
                     const float* __restrict__ fields, const float* __restrict__ gin,
                     float* __restrict__ gout, int B, int R, int split) {
  __shared__ float part[7][THREADS];
  const Slot sl = slot_of(split);
  const int b = blockIdx.y;
  const bool live = sl.r < R;
  const size_t n = (size_t)B * R, o = (size_t)b * R + sl.r;
  float g = 0.0f, G[7] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // G[6]: the forward sum
  if (live) {
    const Ray ray = load_ray(fields, n, o);
    g = gin[o];
    if (ray.ws > 0.0f) {
      const float safe_d0 = fabsf(ray.d0) < 1e-6f ? 1e-6f : ray.d0;
      const float inv_d0 = 1.0f / safe_d0;
      const float abs_d0 = fabsf(safe_d0);
      const float sgn_d0 = sign_of(safe_d0);
      const float half = 0.5f / abs_d0;
      const float dh_dd0 = -sgn_d0 * 2.0f * half * half;  // d(1/(2|d0|))/d d0

      // box entry/exit and the partials of the active axis and side
      float a_in = 0.0f, a_out = 1.0f;
      BoxEnd ein = {-1, 0.0f, 0.0f}, eout = {-1, 0.0f, 0.0f};
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
        if (lo > a_in) ein = {ax, dls, dld};
        a_in = fmaxf(a_in, lo);
        if (hi < a_out) eout = {ax, dhs, dhd};
        a_out = fminf(a_out, hi);
      }
      if (a_out < a_in) eout = ein;
      a_out = fmaxf(a_out, a_in);

      float k_lo, k_hi;
      box_planes(ray.s0, safe_d0, a_in, a_out, &k_lo, &k_hi);
      int lo, hi, kb, ke;
      plane_range(a_out > a_in, k_lo, k_hi, M, &lo, &hi);
      plane_part(lo, hi, split, sl.part, &kb, &ke);
      const float Wf = (float)Wd, Lm1 = (float)(L - 1);
      const int lane_max = L > 1 ? L - 2 : 0;
      const uint32_t plane = (uint32_t)Wd * L;
      const float da_ds0 = -inv_d0;
      // sums over the planes: W dB1, W dB2, alpha W dB1, alpha W dB2, dW_3 Bs,
      // W Bs, and dW_j Bs of the box-end planes for s0, s1, s2, d1, d2
      float S1 = 0.0f, S2 = 0.0f, S1a = 0.0f, S2a = 0.0f, S3 = 0.0f, S6 = 0.0f;
      float E[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      auto add = [&](float W, float alpha, float Bs, float dB1, float dB2, float dW3) {
        const float WdB1 = W * dB1, WdB2 = W * dB2;
        S1 = S1 + WdB1;
        S2 = S2 + WdB2;
        S1a = __fmaf_rn(WdB1, alpha, S1a);
        S2a = __fmaf_rn(WdB2, alpha, S2a);
        S6 = __fmaf_rn(W, Bs, S6);
        S3 = __fmaf_rn(dW3, Bs, S3);
      };

      auto full = [&](int k) {
        const float kf = (float)k;
        const float alpha = (kf - ray.s0) * inv_d0;
        const float da_dd0 = -alpha * inv_d0;
        const float p1 = ray.s1 + alpha * ray.d1;
        const float p2 = ray.s2 + alpha * ray.d2;
        const float u_arg = alpha + half;
        const float v_arg = alpha - half;
        const float span = fmaxf(fminf(u_arg, a_out) - fmaxf(v_arg, a_in), 0.0f);
        const bool u_int = u_arg < a_out;
        const bool v_int = v_arg > a_in;
        const bool valid = (span > 0.0f) && (p1 > -1.0f) && (p1 < Wf) && (p2 >= 0.0f) &&
                           (p2 <= Lm1);
        const float W = valid ? span * abs_d0 : 0.0f;

        // an invalid plane taps (0, 0) with W = 0
        const float q1 = valid ? p1 : 0.0f, q2 = valid ? p2 : 0.0f;
        int idx, z0;
        const float idx_f = floor_exact(q2, &idx);  // q2 >= 0: the truncation of astype(int32)
        const float fx = q2 - fminf(idx_f, (float)lane_max);
        idx = min(idx, lane_max);
        const float z0_f = floor_exact(q1, &z0);
        // rows z0 and z0 + 1 at p1 - z = d0 in [0, 1] and d1 in [-1, 0): the
        // plain version's tent max(1 - |d|, 0) and slope -sign(d) of a row in
        // the volume with |d| < 1 are 1 - d0, -1 (-0 at d0 = 0) and 1 + d1, +1
        const float d0 = q1 - z0_f, d1 = q1 - (z0_f + 1.0f);
        const bool on0 = (z0 >= 0) && (d0 < 1.0f);
        const bool on1 = (z0 + 1 < Wd) && (d1 > -1.0f);
        const uint32_t slab = (uint32_t)k * plane + idx;
        const __nv_bfloat16* t0 = tap(vol, slab, max(z0, 0), L);
        const __nv_bfloat16* t1 = tap(vol, slab, min(z0 + 1, Wd - 1), L);
        const float lo0 = ld(t0), hi0 = ld(t0 + STEP);
        const float lo1 = ld(t1), hi1 = ld(t1 + STEP);
        const float val0 = __fmaf_rn(fx, hi0 - lo0, lo0), val1 = __fmaf_rn(fx, hi1 - lo1, lo1);
        const float wz0 = on0 ? 1.0f - d0 : 0.0f, wz1 = on1 ? 1.0f + d1 : 0.0f;
        const float Bs = __fmaf_rn(wz1, val1, wz0 * val0);
        const float dB1 = (on1 ? val1 : 0.0f) - (on0 && d0 > 0.0f ? val0 : 0.0f);
        const float dB2 = __fmaf_rn(wz1, hi1 - lo1, wz0 * (hi0 - lo0));

        // interior plane: the box-plane terms are 0 except d0's half-width one
        float dW3 = abs_d0 * ((da_dd0 + dh_dd0) - (da_dd0 - dh_dd0)) + span * sgn_d0;
        if (valid && !(u_int && v_int)) {
          // a box end inside this slab: the full box-plane terms
          dW3 = abs_d0 * dspan(u_int, v_int, da_dd0, dh_dd0, ein.partial(3), eout.partial(3)) +
                span * sgn_d0;
          const float d_alpha[5] = {da_ds0, 0.0f, 0.0f, 0.0f, 0.0f};
          const int field[5] = {0, 1, 2, 4, 5};
#pragma unroll
          for (int j = 0; j < 5; ++j) {
            const float dW = abs_d0 * dspan(u_int, v_int, d_alpha[j], 0.0f, ein.partial(field[j]),
                                            eout.partial(field[j]));
            E[j] = __fmaf_rn(dW, Bs, E[j]);
          }
        }
        add(W, alpha, Bs, dB1, dB2, valid ? dW3 : 0.0f);
      };
      // lean: u_int, v_int and an open slab, 0 <= p1 < Wd - 1 and 0 <= p2 < L - 1
      auto is_lean = [&](int k) {
        const float alpha = ((float)k - ray.s0) * inv_d0;
        const float p1 = ray.s1 + alpha * ray.d1;
        const float p2 = ray.s2 + alpha * ray.d2;
        const float u_arg = alpha + half;
        const float v_arg = alpha - half;
        return (u_arg < a_out) && (v_arg > a_in) && (u_arg > v_arg) && (p1 >= 0.0f) &&
               (p1 < Wf - 1.0f) && (p2 >= 0.0f) && (p2 < Lm1);
      };
      const float m1 = ray.d1 * inv_d0, m2 = ray.d2 * inv_d0;
      float ka = k_lo + 1.5f, kz = k_hi - 1.5f;
      narrow(ray.s1 - ray.s0 * m1, m1, 0.0f, Wf - 1.0f, &ka, &kz);
      narrow(ray.s2 - ray.s0 * m2, m2, 0.0f, Lm1, &ka, &kz);
      int ia, ib;
      lean_part(ka, kz, kb, ke, &ia, &ib);
      if (ia < ib && !(is_lean(ia) && is_lean(ib - 1))) ia = ib = ke;

      for (int k = kb; k < ia; ++k) full(k);
      uint32_t slab = (uint32_t)ia * plane;
      float kf = (float)ia;
#pragma unroll (K6_UNROLL)
      for (int k = ia; k < ib; ++k, kf += 1.0f, slab += plane) {
        const float alpha = (kf - ray.s0) * inv_d0;
        const float da_dd0 = -alpha * inv_d0;
        const float p1 = ray.s1 + alpha * ray.d1;
        const float p2 = ray.s2 + alpha * ray.d2;
        const float span = (alpha + half) - (alpha - half);
        int idx, z0;
        const float fx = p2 - floor_exact(p2, &idx);
        const float z0_f = floor_exact(p1, &z0);
        const float d0 = p1 - z0_f, d1 = p1 - (z0_f + 1.0f);
        const bool on1 = d1 > -1.0f;  // false where p1 is a whole row
        const __nv_bfloat16* t0 = tap(vol, slab + idx, z0, L);
        const float lo0 = ld(t0), hi0 = ld(t0 + 1);
        const float lo1 = ld(t0 + L), hi1 = ld(t0 + L + 1);
        const float val0 = __fmaf_rn(fx, hi0 - lo0, lo0), val1 = __fmaf_rn(fx, hi1 - lo1, lo1);
        const float wz0 = 1.0f - d0, wz1 = on1 ? 1.0f + d1 : 0.0f;
        const float Bs = __fmaf_rn(wz1, val1, wz0 * val0);
        const float dB1 = (on1 ? val1 : 0.0f) - (d0 > 0.0f ? val0 : 0.0f);
        const float dB2 = __fmaf_rn(wz1, hi1 - lo1, wz0 * (hi0 - lo0));
        add(span * abs_d0, alpha, Bs, dB1, dB2,
            abs_d0 * ((da_dd0 + dh_dd0) - (da_dd0 - dh_dd0)) + span * sgn_d0);
      }
      for (int k = ib; k < ke; ++k) full(k);
      const float gc = g * ray.ws;
      G[0] = gc * (E[0] + da_ds0 * (ray.d1 * S1 + ray.d2 * S2));
      G[1] = gc * (E[1] + S1);
      G[2] = gc * (E[2] + S2);
      G[3] = gc * (S3 - inv_d0 * (ray.d1 * S1a + ray.d2 * S2a));
      G[4] = gc * (E[3] + S1a);
      G[5] = gc * (E[4] + S2a);
      G[6] = S6;
    }
  }
#pragma unroll
  for (int j = 0; j < 7; ++j) part[j][threadIdx.x] = G[j];
  __syncthreads();
  if (sl.part == 0 && live) {
#pragma unroll
    for (int j = 0; j < 6; ++j) gout[j * n + o] = sum_parts(part[j], split);
    gout[6 * n + o] = g * sum_parts(part[6], split);
  }
}

// ---------------------------------------------------------------------------
// K8: exact Siddon forward. Inside one slab a ray within 45 degrees of the
// march axis crosses at most one window plane and one lane plane, so the
// slab interval [aa, ab] splits into at most 3 segments over the voxels
// {ra, rb} x {ca, cb}; the exact crossing parameters give exact lengths.
// out = ws * |d0| * sum of voxel value x alpha length, in K5's plan. A lean
// plane has its slab inside the box, so aa = alpha - half and ab = alpha +
// half, as the plain version's max/min round them, and 0 <= p1 <= Wd - 1,
// 0 <= p2 < L - 1.5 at both ends of the slab, so its four rounded indices
// need no clamp and the second lane cmin + 1 lies in the volume.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
slab_siddon_kernel(const __nv_bfloat16* __restrict__ vol, int M, int Wd, int L,
                   const float* __restrict__ fields, float* __restrict__ out, int B, int R,
                   int split) {
  __shared__ float part[THREADS];
  const Slot sl = slot_of(split);
  const int b = blockIdx.y;
  const bool live = sl.r < R;
  const size_t n = (size_t)B * R, o = (size_t)b * R + sl.r;
  float acc = 0.0f, ws = 0.0f, abs_d0 = 0.0f;
  if (live) {
    const Ray ray = load_ray(fields, n, o);
    ws = ray.ws;
    const float safe_d0 = fabsf(ray.d0) < 1e-6f ? 1e-6f : ray.d0;
    abs_d0 = fabsf(safe_d0);
    if (ray.ws > 0.0f) {
      const float inv_d0 = 1.0f / safe_d0;
      const float half = 0.5f * fabsf(inv_d0);
      const float safe_d1 = fabsf(ray.d1) < 1e-9f ? 1e-9f : ray.d1;
      const float safe_d2 = fabsf(ray.d2) < 1e-9f ? 1e-9f : ray.d2;
      // a crossing by a per-ray reciprocal: as fast as a division is slow, and
      // as close to the float64 plain version (scripts/chip_slab_times.py)
      const float inv_d1 = 1.0f / safe_d1, inv_d2 = 1.0f / safe_d2;
      const float c1 = -0.5f - ray.s1, c2 = -0.5f - ray.s2;
      float a_in, a_out, k_lo, k_hi;
      ray_box(ray, M, Wd, L, &a_in, &a_out);
      box_planes(ray.s0, safe_d0, a_in, a_out, &k_lo, &k_hi);
      int lo, hi, kb, ke;
      plane_range(a_out > a_in, k_lo, k_hi, M, &lo, &hi);
      plane_part(lo, hi, split, sl.part, &kb, &ke);
      const float Wm1 = (float)(Wd - 1), Lm15 = (float)L - 1.5f;
      const uint32_t plane = (uint32_t)Wd * L;

      // the crossing of the boundary below whole row/lane m (as a float), c =
      // -0.5 - s
      auto cross = [&](float m, float c, float inv_d) { return (m + c) * inv_d; };
      // the slab [aa, ab] over voxels {ra, rb} x {ca, cb} of plane `slab`,
      // with cmin = min(ca, cb) and chi its next lane (clamped)
      auto segments = [&](uint32_t slab, float aa, float ab, int ra, int rb, int ca, int cb,
                          float tw, float tl, int cmin, int chi) {
        const bool first_is_w = tw <= tl;
        const float t1c = fminf(fmaxf(fminf(tw, tl), aa), ab);
        const float t2c = fminf(fmaxf(fmaxf(tw, tl), aa), ab);
        const float L1 = t1c - aa;
        const float L2 = t2c - t1c;
        const float L3 = ab - t2c;
        const float L_rb_ca = first_is_w ? L2 : 0.0f;
        const float L_ra_cb = first_is_w ? 0.0f : L2;
        const __nv_bfloat16* row_a = tap(vol, slab + cmin, ra, L);
        const __nv_bfloat16* row_b = tap(vol, slab + cmin, rb, L);
        const float lo_a = ld(row_a), hi_a = ld(row_a + (chi - cmin));
        const float lo_b = ld(row_b), hi_b = ld(row_b + (chi - cmin));
        const float a_ca = ca == cmin ? lo_a : hi_a, a_cb = cb == cmin ? lo_a : hi_a;
        const float b_ca = ca == cmin ? lo_b : hi_b, b_cb = cb == cmin ? lo_b : hi_b;
        const float A = __fmaf_rn(L_ra_cb, a_cb, L1 * a_ca);
        const float Bv = __fmaf_rn(L3, b_cb, L_rb_ca * b_ca);
        return A + Bv;
      };
      auto full = [&](int k) {
        // The clamp changes no plane: on the H100 no call of full() took a k
        // outside [0, M) (recorded on the card), yet without it K8 read outside
        // the volume on box-clipped rays (an illegal address, on rays that a
        // CPU run of this code reads within it): the compiled loop issues a
        // plane's taps beyond the range it marches. K7's full plane keeps the
        // same guard.
        k = min(max(k, 0), M - 1);
        const float alpha = ((float)k - ray.s0) * inv_d0;
        const float aa = fmaxf(alpha - half, a_in);
        const float ab = fminf(alpha + half, a_out);
        const float seg = ab - aa;
        if (!(seg > 0.0f)) return;
        const float eps = 1e-5f * seg;
        int ra, rb, ca, cb;
        rint_exact(ray.s1 + (aa + eps) * ray.d1, &ra);
        rint_exact(ray.s1 + (ab - eps) * ray.d1, &rb);
        rint_exact(ray.s2 + (aa + eps) * ray.d2, &ca);
        rint_exact(ray.s2 + (ab - eps) * ray.d2, &cb);
        ra = min(max(ra, 0), Wd - 1);
        rb = min(max(rb, 0), Wd - 1);
        ca = min(max(ca, 0), L - 1);
        cb = min(max(cb, 0), L - 1);
        const float tw = ra != rb ? cross((float)max(ra, rb), c1, inv_d1) : BIG;
        const float tl = ca != cb ? cross((float)max(ca, cb), c2, inv_d2) : BIG;
        const int cmin = min(ca, cb);
        acc = acc + segments((uint32_t)k * plane, aa, ab, ra, rb, ca, cb, tw, tl, cmin,
                             min(cmin + 1, L - 1));
      };
      auto is_lean = [&](int k) {
        const float alpha = ((float)k - ray.s0) * inv_d0;
        const float u = alpha + half, v = alpha - half;
        const float eps = 1e-5f * (u - v);
        const float p1a = ray.s1 + (v + eps) * ray.d1, p1b = ray.s1 + (u - eps) * ray.d1;
        const float p2a = ray.s2 + (v + eps) * ray.d2, p2b = ray.s2 + (u - eps) * ray.d2;
        return (u <= a_out) && (v >= a_in) && (u > v) && (p1a >= 0.0f) && (p1a <= Wm1) &&
               (p1b >= 0.0f) && (p1b <= Wm1) && (p2a >= 0.0f) && (p2a < Lm15) && (p2b >= 0.0f) &&
               (p2b < Lm15);
      };
      // the slab's ends sit half a plane, |m| / 2 in position, from its centre
      const float m1 = ray.d1 * inv_d0, m2 = ray.d2 * inv_d0;
      const float h1 = 0.5f * fabsf(m1), h2 = 0.5f * fabsf(m2);
      float ka = k_lo + 1.5f, kz = k_hi - 1.5f;
      narrow(ray.s1 - ray.s0 * m1, m1, h1, Wm1 - h1, &ka, &kz);
      narrow(ray.s2 - ray.s0 * m2, m2, h2, Lm15 - h2, &ka, &kz);
      int ia, ib;
      lean_part(ka, kz, kb, ke, &ia, &ib);
      if (ia < ib && !(is_lean(ia) && is_lean(ib - 1))) ia = ib = ke;

      for (int k = kb; k < ia; ++k) full(k);
      uint32_t slab = (uint32_t)ia * plane;
      float kf = (float)ia;
#pragma unroll (K8_UNROLL)
      for (int k = ia; k < ib; ++k, kf += 1.0f, slab += plane) {
        const float alpha = (kf - ray.s0) * inv_d0;
        const float ab = alpha + half, aa = alpha - half;
        const float eps = 1e-5f * (ab - aa);
        const float xa = aa + eps, xb = ab - eps;
        // the rounded sums order as the indices: the larger one's index is
        // fmaxf(sums) - FLOOR_MAGIC, exactly
        const float ta = rint_sum(ray.s1 + xa * ray.d1), tb = rint_sum(ray.s1 + xb * ray.d1);
        const float tc = rint_sum(ray.s2 + xa * ray.d2), td = rint_sum(ray.s2 + xb * ray.d2);
        const float tw = ta != tb ? cross(fmaxf(ta, tb) - FLOOR_MAGIC, c1, inv_d1) : BIG;
        const float tl = tc != td ? cross(fmaxf(tc, td) - FLOOR_MAGIC, c2, inv_d2) : BIG;
        const int ca = rint_of(tc), cb = rint_of(td), cmin = min(ca, cb);
        acc = acc + segments(slab, aa, ab, rint_of(ta), rint_of(tb), ca, cb, tw, tl, cmin,
                             cmin + 1);
      }
      for (int k = ib; k < ke; ++k) full(k);
    }
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  if (sl.part == 0 && live) out[o] = sum_parts(part, split) * ws * abs_d0;
}

// K5-K8 take window and lane extents below 2^22 (floor_exact, rint_exact)
// and volumes below 2^31 voxels (tap).
bool slab_fits(int M, int Wd, int L) {
  return Wd < MAX_EXTENT && L < MAX_EXTENT && (long long)M * Wd * L < (1LL << 31);
}

dim3 split_grid(int B, int R, int split) {
  const int rays = THREADS / split;
  return dim3((R + rays - 1) / rays, B);
}

}  // namespace

extern "C" {

int slab_forward(const void* vol, int M, int Wd, int L, const void* fields, void* out, int B,
                 int R, void* stream) {
  if (!slab_fits(M, Wd, L)) return (int)cudaErrorInvalidValue;
  const int split = plane_split(B, R);
  const dim3 grid = split_grid(B, R, split);
  const auto v = (const __nv_bfloat16*)vol;
  const auto f = (const float*)fields;
  if (L > 1)
    slab_forward_kernel<1><<<grid, THREADS, 0, (cudaStream_t)stream>>>(v, M, Wd, L, f, (float*)out,
                                                                         B, R, split);
  else
    slab_forward_kernel<0><<<grid, THREADS, 0, (cudaStream_t)stream>>>(v, M, Wd, L, f, (float*)out,
                                                                         B, R, split);
  return (int)cudaGetLastError();
}

int slab_backward(const void* vol, int M, int Wd, int L, const void* fields, const void* g,
                  void* gout, int B, int R, void* stream) {
  if (!slab_fits(M, Wd, L)) return (int)cudaErrorInvalidValue;
  const int split = plane_split(B, R);
  const dim3 grid = split_grid(B, R, split);
  const auto v = (const __nv_bfloat16*)vol;
  const auto f = (const float*)fields;
  if (L > 1)
    slab_backward_kernel<1><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        v, M, Wd, L, f, (const float*)g, (float*)gout, B, R, split);
  else
    slab_backward_kernel<0><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        v, M, Wd, L, f, (const float*)g, (float*)gout, B, R, split);
  return (int)cudaGetLastError();
}

int slab_plane_split(int B, int R) { return plane_split(B, R); }

int slab_max_channels() { return MAX_CHANNELS; }

// `chan_values` is a host array of n_chans label values, passed to the
// kernel by value (no device copy per call).
int slab_channels(const void* vol, const void* labels, int M, int Wd, int L,
                  const int* chan_values, int n_chans, const void* fields, void* out, int B, int R,
                  void* stream) {
  if (!slab_fits(M, Wd, L) || n_chans < 0 || n_chans + 1 > MAX_CHANNELS)
    return (int)cudaErrorInvalidValue;
  Channels chans = {};
  chans.n = n_chans;
  for (int j = 0; j < n_chans; ++j) chans.v[j] = chan_values[j];
  const int split = plane_split(B, R);
  const dim3 grid = split_grid(B, R, split);
  const auto v = (const __nv_bfloat16*)vol;
  const auto lab = (const uint8_t*)labels;
  const auto f = (const float*)fields;
  const auto st = (cudaStream_t)stream;
  constexpr int NREG = K7_REG_CHANNELS > 0 ? K7_REG_CHANNELS : 1;
  const bool regs = n_chans + 1 <= K7_REG_CHANNELS;
  if (L > 1 && regs)
    slab_channels_kernel<1, NREG><<<grid, THREADS, 0, st>>>(v, lab, M, Wd, L, chans, f,
                                                             (float*)out, B, R, split);
  else if (L > 1)
    slab_channels_kernel<1, 0><<<grid, THREADS, 0, st>>>(v, lab, M, Wd, L, chans, f,
                                                          (float*)out, B, R, split);
  else if (regs)
    slab_channels_kernel<0, NREG><<<grid, THREADS, 0, st>>>(v, lab, M, Wd, L, chans, f,
                                                             (float*)out, B, R, split);
  else
    slab_channels_kernel<0, 0><<<grid, THREADS, 0, st>>>(v, lab, M, Wd, L, chans, f,
                                                          (float*)out, B, R, split);
  return (int)cudaGetLastError();
}

int slab_siddon(const void* vol, int M, int Wd, int L, const void* fields, void* out, int B,
                int R, void* stream) {
  if (!slab_fits(M, Wd, L)) return (int)cudaErrorInvalidValue;
  const int split = plane_split(B, R);
  slab_siddon_kernel<<<split_grid(B, R, split), THREADS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)vol, M, Wd, L, (const float*)fields, (float*)out, B, R, split);
  return (int)cudaGetLastError();
}

}  // extern "C"

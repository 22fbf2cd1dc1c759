// K8: the Annex D.3.19 picture checksum (hash_type 2) of F uint8 planes.
//
// Replaces fasthevc_tpu/codec/device_pipeline.py _device_checksum (:55):
// per plane, the sum of every sample XOR its position mask
// ((x & 0xff) ^ (y & 0xff) ^ (x >> 8) ^ (y >> 8)), wrapping mod 2^32.
// A grid reduction: each thread sums a strided run of samples in uint32,
// the CTA reduces in shared memory, and one uint32 atomicAdd per CTA adds
// into the frame's sum (wrapping adds commute, so the order is free).
//
// Bound on the H100: device-memory reads, one byte per sample.
//
// fhv_cast_checksum, the form the routes launch, replaces the tail of the
// reference's batch program (device_pipeline.py:122-126): the three
// astype(uint8) casts of the int32 recon, then _device_checksum of each
// plane, in one launch a batch.  A thread takes 4 samples at a time: one
// 16-byte load, one 4-byte store of their low bytes, and their masks from
// the row and column it tracks (one division when it starts, none per
// sample; 4 aligned samples share x >> 8).  The CTAs of all three planes
// and all frames form one grid (each CTA a run of 2048 vectors of one
// plane), so one 1080p picture gives 382 CTAs: every SM busy.  Warp
// shuffles, then one uint32 atomicAdd a CTA on the low word of the plane's
// int64 sum, which the entry zeroes first: the add wraps mod 2^32, as the
// reference's uint32 sum does, and the high word stays 0.  Without a sum
// pointer the same launch only casts.  Inputs may be column slices of
// wider planes (a row pitch and a frame stride each; both multiples of 4
// samples, 16-byte aligned), the outputs are contiguous.
//
// Bound on the H100: device-memory traffic, 4 bytes read and 1 written a
// sample.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;

__global__ void checksum_kernel(const unsigned char* __restrict__ planes,
                                unsigned* __restrict__ out, int H, int W) {
  __shared__ unsigned part[kThreads];
  const int f = blockIdx.y;
  const long long n = (long long)H * W;
  const unsigned char* p = planes + (size_t)f * n;
  unsigned acc = 0;
  const long long start =
      (long long)blockIdx.x * blockDim.x * kPerThread + threadIdx.x;
  for (int k = 0; k < kPerThread; ++k) {
    const long long i = start + (long long)k * blockDim.x;
    if (i >= n) break;
    const unsigned y = (unsigned)(i / W), x = (unsigned)(i % W);
    const unsigned mask = (x & 0xff) ^ (y & 0xff) ^ (x >> 8) ^ (y >> 8);
    acc += (unsigned)p[i] ^ mask;
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) part[threadIdx.x] += part[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) atomicAdd(out + f, part[0]);
}

constexpr int kCastThreads = 256;
constexpr int kCastVecs = 8;  // 4-sample vectors a thread
constexpr int kCastRun = kCastThreads * kCastVecs;

struct CastPlane {
  const int* in;
  unsigned char* out;
  long long in_fs;  // the input's frame stride (samples)
  int pitch;        // the input's row pitch (samples)
  int H, W;
  int ctas;  // CTAs a frame
};

struct CastArgs {
  CastPlane p[3];
  unsigned* sums;  // [F][3] int64 seen as uint32 pairs, or NULL
};

__device__ __forceinline__ unsigned byte_mask(unsigned x, unsigned ym) {
  return (x & 0xff) ^ ym;
}

__global__ void __launch_bounds__(kCastThreads)
    cast_checksum_kernel(const __grid_constant__ CastArgs a) {
  __shared__ unsigned part[kCastThreads / 32];
  const int f = blockIdx.y;
  int b = blockIdx.x, pl = 0;
  if (b >= a.p[0].ctas) {
    b -= a.p[0].ctas;
    pl = 1;
    if (b >= a.p[1].ctas) {
      b -= a.p[1].ctas;
      pl = 2;
    }
  }
  const CastPlane& P = a.p[pl];
  const int wv = P.W >> 2;  // vectors a row
  const long long nv = (long long)P.H * wv;
  long long i = (long long)b * kCastRun + threadIdx.x;
  int y = (int)(i / wv), xv = (int)(i - (long long)y * wv);
  const int dy = kCastThreads / wv, dx = kCastThreads - dy * wv;
  const int* in = P.in + (size_t)f * P.in_fs;
  unsigned* out = reinterpret_cast<unsigned*>(P.out + (size_t)f * P.H * P.W);
  int4 v[kCastVecs];
  int ys[kCastVecs], xs[kCastVecs];
#pragma unroll
  for (int k = 0; k < kCastVecs; ++k) {
    ys[k] = y;
    xs[k] = xv;
    v[k] = i < nv ? __ldg(reinterpret_cast<const int4*>(
                        in + (size_t)y * P.pitch + 4 * xv))
                  : make_int4(0, 0, 0, 0);
    i += kCastThreads;
    y += dy;
    xv += dx;
    if (xv >= wv) {
      xv -= wv;
      ++y;
    }
  }
  unsigned acc = 0;
  i = (long long)b * kCastRun + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kCastVecs; ++k, i += kCastThreads) {
    if (i >= nv) break;
    const unsigned b0 = v[k].x & 0xff, b1 = v[k].y & 0xff,
                   b2 = v[k].z & 0xff, b3 = v[k].w & 0xff;
    out[i] = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
    const unsigned x = 4u * xs[k], yy = (unsigned)ys[k];
    const unsigned ym = (yy & 0xff) ^ (yy >> 8) ^ (x >> 8);
    acc += (b0 ^ byte_mask(x, ym)) + (b1 ^ byte_mask(x + 1, ym)) +
           (b2 ^ byte_mask(x + 2, ym)) + (b3 ^ byte_mask(x + 3, ym));
  }
  if (a.sums == nullptr) return;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
    for (int w = 0; w < kCastThreads / 32; ++w) total += part[w];
    atomicAdd(a.sums + 2 * (3 * f + pl), total);
  }
}

}  // namespace

// out: F uint32 sums, zeroed by the caller
extern "C" int fhv_checksum(const unsigned char* planes, unsigned* out,
                            int F, int H, int W, cudaStream_t stream) {
  if (F <= 0) return 0;
  const long long n = (long long)H * W;
  const long long per_cta = (long long)kThreads * kPerThread;
  dim3 grid((unsigned)((n + per_cta - 1) / per_cta), F);
  checksum_kernel<<<grid, kThreads, 0, stream>>>(planes, out, H, W);
  return (int)cudaGetLastError();
}

// in y/cb/cr: int32 planes (column slices allowed: pitches and frame
// strides in samples, multiples of 4, 16-byte aligned); out y/cb/cr:
// contiguous uint8 [F, H, W], [F, H/2, W/2]; sums: int64 [F, 3] (zeroed
// here) or NULL to cast only.
extern "C" int fhv_cast_checksum(const int* in_y, const int* in_cb,
                                 const int* in_cr, unsigned char* out_y,
                                 unsigned char* out_cb, unsigned char* out_cr,
                                 long long* sums, int pitch_y, int pitch_cb,
                                 int pitch_cr, long long fs_y, long long fs_cb,
                                 long long fs_cr, int F, int H, int W,
                                 cudaStream_t stream) {
  if (F <= 0) return 0;
  CastArgs a;
  const int* ins[3] = {in_y, in_cb, in_cr};
  unsigned char* outs[3] = {out_y, out_cb, out_cr};
  const int pitches[3] = {pitch_y, pitch_cb, pitch_cr};
  const long long fss[3] = {fs_y, fs_cb, fs_cr};
  int ctas = 0;
  for (int p = 0; p < 3; ++p) {
    const int h = p ? H / 2 : H, w = p ? W / 2 : W;
    const long long nv = (long long)h * (w / 4);
    a.p[p] = CastPlane{ins[p], outs[p], fss[p], pitches[p], h, w,
                       (int)((nv + kCastRun - 1) / kCastRun)};
    ctas += a.p[p].ctas;
  }
  a.sums = reinterpret_cast<unsigned*>(sums);
  if (sums != nullptr) {
    const cudaError_t rc =
        cudaMemsetAsync(sums, 0, sizeof(long long) * 3 * F, stream);
    if (rc != cudaSuccess) return (int)rc;
  }
  if (ctas == 0) return 0;
  cast_checksum_kernel<<<dim3(ctas, F), kCastThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

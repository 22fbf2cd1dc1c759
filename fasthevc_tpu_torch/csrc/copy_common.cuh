// A block-stride copy into shared memory with several loads in flight a
// thread: each thread issues up to eight independent loads before their
// stores, where a plain loop would wait for every load's latency in turn.
// Shared by K9 (me_int.cu) and K11's merge form (mc.cu).
#pragma once

// For i = t, t + T, ... < n: store(i, load(i)).  T is the stride (the
// threads, or the lanes, that share the copy).
template <int T, typename Load, typename Store>
__device__ __forceinline__ void batched_copy(int n, int t, Load load,
                                             Store store) {
  constexpr int kBatch = 8;
  for (int i0 = t; i0 < n; i0 += kBatch * T) {
    int v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i0 + u * T < n) v[u] = load(i0 + u * T);
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (i0 + u * T < n) store(i0 + u * T, v[u]);
  }
}

// Counter-based Philox4x32-10 on the device: the dropout bits of the port's
// training kernels (train_attention.cu, ffn.cu).
//
// The TPU kernels draw theirs from the TPU's own generator, which cannot be
// reproduced off the TPU. Here a keep bit is a pure function of (seed,
// counter), so a forward kernel, a backward kernel and the plain PyTorch
// version (univl_tpu_torch/kernels/philox.py, which documents the counters
// of each kernel) drop the same elements whatever their block shapes.

#pragma once

#include <stdint.h>

namespace univl {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, unsigned long long seed) {
  uint32_t k0 = static_cast<uint32_t>(seed), k1 = static_cast<uint32_t>(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// Word t (0..3) of a Philox output.
__device__ __forceinline__ uint32_t philox_word(uint4 w, int t) {
  return t == 0 ? w.x : t == 1 ? w.y : t == 2 ? w.z : w.w;
}

struct Dropout {
  const unsigned long long* key;  // the Philox key, in device memory: a CUDA graph replays
                                  // the launch with this pointer, and each step's key is
                                  // written there before the replay
  uint32_t threshold;             // keep where the word is >= threshold
  float inv_keep;                 // 1 / (1 - rate)
  int on;                         // rate > 0
  int offset;                     // added to the head (#2) or row (#4, #5) counter word: the
                                  // first head or row of a rank's shard under tensor or
                                  // sequence parallelism, so its bits are the whole call's
  unsigned long long seed;        // *key, once load_key has read it
};

// Two ways to read the key, each where it measured cheapest (PERF.md, section 6):
// the training attention's kernels load it once at their start (load_key;
// read at each draw it cost the tensor-core kernels 1.6-2.6%), the FFN
// kernels at each draw through the read-only cache (key_of; loaded at the
// start and held in registers it cost the f32 FFN block 1.3%).
__device__ __forceinline__ void load_key(Dropout& drop) { drop.seed = drop.on ? *drop.key : 0ull; }

__device__ __forceinline__ unsigned long long key_of(const Dropout& drop) {
  return __ldg(drop.key);
}

// A launch's dropout from a C entry's arguments: `key` the device address of
// the 64-bit Philox key (null without dropout, where no kernel reads it).
inline Dropout dropout_of(const void* key, uint32_t threshold, float inv_keep, int on,
                          int offset = 0) {
  return Dropout{static_cast<const unsigned long long*>(key), threshold, inv_keep, on, offset,
                 0ull};
}

}  // namespace univl

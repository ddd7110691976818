// threefry2x32 keys as jax.random draws them (JAX 0.9, partitionable), in
// native uint32: the CUDA counterpart of ops/threefry.py, bit for bit.
//
// A key is two words (k0, k1) in JAX's order. fold_in(k, data) is the block
// of k on the counter (0, data); the 32-bit random bits of counter i are
// y0 ^ y1 of the block on (0, i); a uniform takes their top 23 bits as the
// mantissa of a float in [1, 2) and subtracts 1.
#pragma once

#include <cstdint>

namespace tf {

struct Key {
    uint32_t k0, k1;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, uint32_t r) { return __funnelshift_l(x, x, r); }

// Four rounds of the group with rotations (a, b, c, d).
#define TF_ROUNDS(a, b, c, d) \
    x0 += x1;                 \
    x1 = rotl(x1, a) ^ x0;    \
    x0 += x1;                 \
    x1 = rotl(x1, b) ^ x0;    \
    x0 += x1;                 \
    x1 = rotl(x1, c) ^ x0;    \
    x0 += x1;                 \
    x1 = rotl(x1, d) ^ x0;

// The 20-round block: five groups of four rounds, each followed by a key
// injection ks[(i+1)%3], ks[(i+2)%3] + i + 1.
__device__ __forceinline__ void block(Key k, uint32_t& x0, uint32_t& x1) {
    const uint32_t ks0 = k.k0, ks1 = k.k1, ks2 = k.k0 ^ k.k1 ^ 0x1BD11BDAu;
    x0 += ks0;
    x1 += ks1;
    TF_ROUNDS(13, 15, 26, 6)
    x0 += ks1;
    x1 += ks2 + 1u;
    TF_ROUNDS(17, 29, 16, 24)
    x0 += ks2;
    x1 += ks0 + 2u;
    TF_ROUNDS(13, 15, 26, 6)
    x0 += ks0;
    x1 += ks1 + 3u;
    TF_ROUNDS(17, 29, 16, 24)
    x0 += ks1;
    x1 += ks2 + 4u;
    TF_ROUNDS(13, 15, 26, 6)
    x0 += ks2;
    x1 += ks0 + 5u;
}
#undef TF_ROUNDS

__device__ __forceinline__ Key fold_in(Key k, uint32_t data) {
    uint32_t x0 = 0u, x1 = data;
    block(k, x0, x1);
    return {x0, x1};
}

__device__ __forceinline__ uint32_t random_bits(Key k, uint32_t counter) {
    uint32_t x0 = 0u, x1 = counter;
    block(k, x0, x1);
    return x0 ^ x1;
}

// U[0, 1) from counter `counter` of key k (jax.random.uniform, minval 0,
// maxval 1: u * 1 + 0 and the max with 0 change no bit).
__device__ __forceinline__ float uniform(Key k, uint32_t counter) {
    return __uint_as_float((random_bits(k, counter) >> 9) | 0x3F800000u) - 1.0f;
}

}  // namespace tf

// The counter hash and the minibatch keep bit, shared by every kernel that
// draws from them (gauss_sketch.cu, lstsq_grad_sampled.cu),
// so the selection and the sketch can never drift between kernels.
//
// counter_hash is the reference's lowbias32 finalizer over (seed, counter)
// (src/repro/kernels/ref.py :: counter_hash) in native uint32 arithmetic.
// keep_bit is the reference's rank-cut predicate (lstsq_grad_sampled.py ::
// _keep_bits): row i is in the minibatch iff
//     h_i < cut_h  or  (h_i == cut_h and i <= cut_i),   and i < n_t,
// with (seed, cut_h, cut_i, n_t) the event's scalar block.
#pragma once

#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t counter_hash(uint32_t seed, uint32_t ctr) {
  uint32_t x = (ctr * 0x9E3779B9u) ^ seed;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// The four uint32 of one event's scalar block, carried in kernel arguments.
struct ScalarBlock {
  uint32_t seed, cut_h, cut_i, n_t;
};

__device__ __forceinline__ bool keep_bit(const ScalarBlock& s, uint32_t row) {
  const uint32_t h = counter_hash(s.seed, row);
  return (h < s.cut_h || (h == s.cut_h && row <= s.cut_i)) && row < s.n_t;
}

}  // namespace

// Postfix predicate-program evaluation for one row, as a bit-stack.
//
// Every value on the reference's (max_stack, N) f32 stack is exactly 0 or 1:
// comparisons give 0/1, AND (a*b), OR (clip(a+b, 0, 1)) and NOT (1-a) keep
// it there, and the stack starts at zeros. So one uint32 register holds a
// row's whole 8-deep stack, bit k being slot k, and the machine below
// reproduces ref.eval_program bit for bit, clamp rules included:
//   - a and b are read at clamp(sp-1) and clamp(sp-2);
//   - the write position is clamped to [0, MAX_STACK-1];
//   - NOPs (op < 0) are skipped; an empty program gives 0.
// The stack pointer follows the opcodes alone, so it is the same in every
// thread of a block: the branches below never diverge inside a warp.
#pragma once

#include <cstdint>

namespace policy_scan {

constexpr int MAX_STACK = 8;
constexpr int N_AGG = 14;      // count, volume, spc_used, hist x10, any_match
constexpr int N_BUCKETS = 10;

enum : int { OP_EQ = 0, OP_NE, OP_GT, OP_GE, OP_LT, OP_LE, OP_AND, OP_OR,
             OP_NOT };

__device__ __forceinline__ int clamp_slot(int pos) {
  return min(max(pos, 0), MAX_STACK - 1);
}

// Evaluates program (ops, colidx, operands)[0:n_instr] on row `row` of the
// column-major table `cols` (column c of row i at cols[c * n + i]).
__device__ __forceinline__ uint32_t eval_row(
    const float* __restrict__ cols, long long n, int n_cols, long long row,
    const int* ops, const int* colidx, const float* operands, int n_instr) {
  uint32_t stack = 0u;
  int sp = 0;
  for (int i = 0; i < n_instr; ++i) {
    const int op = ops[i];
    if (op < 0) continue;                                  // NOP
    const uint32_t a = (stack >> clamp_slot(sp - 1)) & 1u;
    const uint32_t b = (stack >> clamp_slot(sp - 2)) & 1u;
    uint32_t v;
    int pos;
    if (op < 6) {
      const int c = min(max(colidx[i], 0), n_cols - 1);
      const float x = __ldg(cols + (long long)c * n + row);
      const float t = operands[i];
      switch (op) {
        case OP_EQ: v = x == t; break;
        case OP_NE: v = x != t; break;
        case OP_GT: v = x > t; break;
        case OP_GE: v = x >= t; break;
        case OP_LT: v = x < t; break;
        default:    v = x <= t; break;
      }
      pos = sp;
      sp += 1;
    } else if (op == OP_AND) {
      v = a & b; pos = sp - 2; sp -= 1;
    } else if (op == OP_OR) {
      v = a | b; pos = sp - 2; sp -= 1;
    } else if (op == OP_NOT) {
      v = a ^ 1u; pos = sp - 1;
    } else {                      // unknown opcode: the reference's else arm
      v = a ^ 1u; pos = sp - 2; sp -= 1;
    }
    pos = clamp_slot(pos);
    stack = (stack & ~(1u << pos)) | (v << pos);
  }
  return (stack >> clamp_slot(sp - 1)) & 1u;
}

// Size-profile bucket: clip(sum(size >= edge) - 1, 0, 9), edges in f32.
__device__ __forceinline__ int size_bucket(float size) {
  const float edges[N_BUCKETS] = {
      0.0f, 1.0f, 32.0f, 1024.0f, 32768.0f, 1048576.0f, 33554432.0f,
      1073741824.0f, 34359738368.0f, 1099511627776.0f};
  int b = -1;
#pragma unroll
  for (int k = 0; k < N_BUCKETS; ++k) b += size >= edges[k];
  return min(max(b, 0), N_BUCKETS - 1);
}

}  // namespace policy_scan
